"""The BDPT_DRAWPATH channel and the debug overlays of the PyTorch port
(utils/debugviz.py), mirroring tests/test_debugviz.py on the CPU.

Tolerances, with their reasons:
  * The rasteriser (draw_line, draw_path, paint_grid_box, paint_photons,
    path_overlay) is pixel-equal to JAX's when both are given the same
    points: the projection is the same float32 formula (tests/
    test_torch_paths.py holds world_to_raster to 1e-6), and no point of
    these scenes lands within that of a pixel edge (measured: equal).
  * bdpt_path_overlay's eye paths on cornell_with_blocks at 32x32 against
    JAX's generate_eye_path on the same selected pixels: `valid` equal and
    the vertices within test_torch_paths.py's walk bound (atol 1e-5), so
    the overlay is non-empty and matches JAX's drawn from the same paths.
  * debug_print_path prints JAX's string on the same buffers.
  * The driver composites the overlay for BIDIRECTIONAL, VCM and SPPM (the
    image differs from the overlay-free one only where the overlay is
    non-black), and not for UNIDIRECTIONAL.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import debugviz as jdebugviz
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.models import paths
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import debugviz, rng
from cudapathtracer_tpu_torch.utils.config import RenderConfig
from test_torch_common import _one_thread  # noqa: F401  (autouse)

CAM = ((0.0, 0.0, 1.0), 32, 32, 0.0, 0.0, 0.0, 60.0)


def test_draw_line_and_composite():
    cam, jcam = Camera.pinhole(*CAM), JCamera.pinhole(*CAM)
    ov = debugviz.make_overlay(32, 32)
    debugviz.draw_line(ov, cam, (-0.4, 0.0, 0.0), (0.4, 0.0, 0.0),
                       (1.0, 0.0, 0.0))
    assert (ov[..., 0] > 0).sum() > 5
    jov = jdebugviz.draw_line(jdebugviz.make_overlay(32, 32), jcam,
                              (-0.4, 0.0, 0.0), (0.4, 0.0, 0.0),
                              (1.0, 0.0, 0.0))
    np.testing.assert_array_equal(ov, jov)
    img = np.full((32, 32, 3), 0.5, np.float32)
    out = debugviz.composite_overlay(img, ov)
    mask = (ov != 0).any(-1)
    assert (out[mask][:, 0] == 1.0).all()
    assert (out[~mask] == 0.5).all()
    np.testing.assert_array_equal(out, jdebugviz.composite_overlay(img, ov))


def test_grid_box_and_photon_heatmap():
    cam, jcam = Camera.pinhole(*CAM), JCamera.pinhole(*CAM)
    ov = debugviz.paint_grid_box(debugviz.make_overlay(32, 32), cam,
                                 (-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
    assert (ov != 0).any()
    np.testing.assert_array_equal(ov, jdebugviz.paint_grid_box(
        jdebugviz.make_overlay(32, 32), jcam, (-0.3, -0.3, -0.3),
        (0.3, 0.3, 0.3)))
    pts = np.random.RandomState(0).uniform(-0.4, 0.4, (500, 3))
    valid = np.random.RandomState(1).uniform(size=500) < 0.8
    ov2 = debugviz.paint_photons(debugviz.make_overlay(32, 32), cam, pts,
                                 valid)
    assert ov2[..., 0].max() > 0.05  # density accumulates
    np.testing.assert_array_equal(ov2, jdebugviz.paint_photons(
        jdebugviz.make_overlay(32, 32), jcam, pts, valid))


@pytest.fixture(scope="module")
def overlay_case():
    """cornell_with_blocks at 32x32, eye depth 4, 8 paths: the port's
    overlay walk (plain, CPU) and JAX's walk of the same selected pixels
    (the call JAX's bdpt_path_overlay makes)."""
    js, _ = jbuild_scene(jbuiltin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    gy, gx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    px, py = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
    key = rng.sample_key(rng.base_key(), 0)
    sel, pts, valid, origins = debugviz.overlay_eye_paths(
        ts, Camera.pinhole(*CAM), key, torch.as_tensor(px),
        torch.as_tensor(py), eye_depth=4, max_paths=8)
    jpx, jpy = jnp.asarray(px[sel]), jnp.asarray(py[sel])
    jb, jv0, _, _ = jpaths.generate_eye_path(
        js, JCamera.pinhole(*CAM), jrng.sample_key(jrng.base_key(), 0), jpx,
        jpy, max_depth=4, ids=jrng.pixel_ids(jpx, jpy))
    return dict(js=js, ts=ts, px=px, py=py, key=key, sel=sel, pts=pts,
                valid=valid, origins=origins, jb=jb, jv0=jv0)


def test_bdpt_path_overlay_draws_paths(overlay_case):
    c = overlay_case
    cam, jcam = Camera.pinhole(*CAM), JCamera.pinhole(*CAM)
    sel, jb, jv0 = c["sel"], c["jb"], c["jv0"]
    np.testing.assert_array_equal(sel, np.arange(0, 1024, 128))
    jvalid = np.asarray(jb.valid)
    np.testing.assert_array_equal(c["valid"], jvalid)
    np.testing.assert_allclose(c["pts"][jvalid], np.asarray(jb.pt)[jvalid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(c["origins"], np.asarray(jv0["pt"]), rtol=0,
                               atol=1e-6)
    ov = debugviz.bdpt_path_overlay(c["ts"], cam, c["key"],
                                    torch.as_tensor(c["px"]),
                                    torch.as_tensor(c["py"]), eye_depth=4,
                                    max_paths=8)
    assert ov.shape == (32, 32, 3)
    assert (ov != 0).any(), "eye paths must rasterize into the overlay"
    # the rasteriser on JAX's own paths draws JAX's overlay
    jov = jdebugviz.bdpt_path_overlay(
        c["js"], jcam, jrng.sample_key(jrng.base_key(), 0),
        jnp.asarray(c["px"]), jnp.asarray(c["py"]), eye_depth=4, max_paths=8)
    np.testing.assert_array_equal(
        debugviz.path_overlay(cam, sel, np.asarray(jb.pt), jvalid,
                              np.asarray(jv0["pt"])), jov)
    np.testing.assert_array_equal(ov, jov)


@pytest.mark.parametrize("integrator", ["BIDIRECTIONAL", "VCM", "SPPM",
                                        "UNIDIRECTIONAL"])
def test_drawpath_channel_composites_in_driver(tmp_path, integrator):
    cfg = RenderConfig(width=24, height=24, sample_count=1,
                       integrator=integrator, bdpt_eye_depth=3,
                       bdpt_light_depth=2, max_depth=3, pinhole_camera=True,
                       cam_pos=(0.0, 0.0, 1.0), meshes=[],
                       output_dir=str(tmp_path), bdpt_draw_path=True)
    r = Renderer(cfg, mesh=builtin.cornell_with_blocks(), device="cpu")
    r.render(num_samples=1, progressive=False, verbose=False)
    fb_on = r.framebuffer()
    r.cfg = dataclasses.replace(r.cfg, bdpt_draw_path=False)
    fb_off = r.framebuffer()
    changed = (fb_on != fb_off).any(-1)
    if integrator == "UNIDIRECTIONAL":
        assert r._overlay is None and not changed.any()
        return
    assert changed.any(), "DRAWPATH overlay must change the image"
    assert not changed[~(r._overlay != 0).any(-1)].any()


def test_debug_print_path(overlay_case, capsys):
    """JAX's string on JAX's buffers (the overlay case's 8 eye paths); the
    port's own walk prints the same fields."""
    jb = overlay_case["jb"]
    want = jdebugviz.debug_print_path(jb, lane=5)
    out = debugviz.debug_print_path(paths.PathBuffers.from_numpy(jb), lane=5)
    assert out == want
    assert "pt=" in out and "beta=" in out
    sel = overlay_case["sel"]
    tb, _, _, _ = paths.generate_eye_path(
        overlay_case["ts"], Camera.pinhole(*CAM), overlay_case["key"],
        torch.as_tensor(overlay_case["px"][sel]),
        torch.as_tensor(overlay_case["py"][sel]), 4)
    assert "pt=" in debugviz.debug_print_path(tb, lane=5)
