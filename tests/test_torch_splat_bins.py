"""K11's first stage (classify and bin) and its second (one shadow ray a
thread in tile order) on the CPU, through their plain versions
(models/bdpt.py: splat_queue_plain, the twin of SplatPass.bin, and
_splat_vertex), in the BDPT form and VCM's, with every light path and
with n_live < N (a mega chunk's pads).

  * The queue holds exactly the light vertices that _splat_vertex traces:
    per row, the lanes it hands the shadow-ray call (captured), and so its
    length is the plain splat's ray count; entries are unique and grouped
    by the screen tile of their pixel, the offsets counting each tile.
  * Splatting the vertices in queue order gives light_trace_splat's /
    vcm_light_splat's frame buffer within 1e-6 relative (float sums taken
    in another order; every term is non-negative) with equal rays.
  * On the JAX package's own light buffers, the queue-order splat matches
    JAX light_trace_splat at tests/test_torch_bdpt.py's tolerance (atol
    1e-5 + rtol 1e-4 per element; XLA:CPU contracts dot products into
    FMAs).

Scenes: cornell_with_spheres (mirror and glass: delta vertices) and
cornell_with_blocks at 16x16 and 32x32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import bdpt as jbdpt
from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.models import bdpt, paths, vcm
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 32
LIGHT_DEPTH = 5
ETA_VCM = 5.1471854   # n_paths pi r^2 of a VCM sample
CFG = bdpt.BDPTConfig(eye_depth=6, light_depth=LIGHT_DEPTH)
VCFG = vcm.VCMConfig(eye_depth=6, light_depth=LIGHT_DEPTH - 1)


def _frame(w, h):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                            torch.arange(w, dtype=torch.int32),
                            indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


@pytest.fixture(scope="module")
def walks():
    """The spheres scene at 32x32: sample 0's BDPT light walk and the
    same walk with VCM's d_vm chain (eta_vcm)."""
    sc, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                        device="cpu")
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    px, py = _frame(W, H)
    key_l = bdpt.sample_keys(rng.base_key(), 0)[0]
    out = {}
    for form, eta in (("bdpt", None), ("vcm", ETA_VCM)):
        lbufs, lv0, _ = paths.generate_light_path(sc, key_l, px, py,
                                                  LIGHT_DEPTH, eta)
        out[form] = (lbufs, lv0 if eta is None else None, eta)
    return sc, cam, out


def _plain_splat(sc, cam, lbufs, lv0, eta, n_live, fb):
    """The plain splat of paths i < n_live, rows in order: the endpoint
    (BDPT form), then the stored vertices."""
    n = lbufs.pt.shape[1]
    active = torch.arange(n) < n_live
    cfg = CFG if eta is None else VCFG
    rays = 0
    if lv0 is not None:
        rays += bdpt._splat_vertex(sc, cam, bdpt._light_endpoint(lv0), True,
                                   cfg, fb, active=active)
    for j in range(lbufs.pt.shape[0]):
        rays += bdpt._splat_vertex(sc, cam, bdpt._vertex(lbufs, j), False,
                                   cfg, fb, eta_vcm=eta, active=active)
    return rays


def _queue_splat(sc, cam, lbufs, lv0, eta, queue, cfg, fb):
    """Stage 2's plain version on the queue: each entry's vertex gathered
    in queue order (the endpoints, then the stored vertices) and splatted
    through _splat_vertex. Returns the rays traced."""
    n = lbufs.pt.shape[1]
    row, lane = queue // n, queue % n
    first = int(lv0 is not None)
    rays = 0
    if first:
        sel = lane[row == 0]
        ep = {k: v[sel] for k, v in bdpt._light_endpoint(lv0).items()}
        rays += bdpt._splat_vertex(sc, cam, ep, True, cfg, fb)
    stored = row >= first
    j, i = row[stored] - first, lane[stored]
    one = paths.PathBuffers(*(f[j, i][None] for f in lbufs))
    rays += bdpt._splat_vertex(sc, cam, bdpt._vertex(one, 0), False, cfg, fb,
                               eta_vcm=eta)
    return rays


@pytest.mark.parametrize("form", ["bdpt", "vcm"])
@pytest.mark.parametrize("live", [W * H, W * H - 200])
def test_queue_holds_the_traced_vertices(walks, form, live, monkeypatch):
    sc, cam, out = walks
    lbufs, lv0, eta = out[form]
    n = lbufs.pt.shape[1]
    queue, offsets = bdpt.splat_queue_plain(cam, lbufs, lv0, n_live=live)
    traced = []
    orig = bdpt.traverse.shadow_factor

    def capture(scene, o, d, max_t, active=None, **kw):
        traced.append(active.clone())
        return orig(scene, o, d, max_t, active=active, **kw)
    monkeypatch.setattr(bdpt.traverse, "shadow_factor", capture)
    rays = _plain_splat(sc, cam, lbufs, lv0, eta, live,
                        torch.zeros((n, 3)))
    want = torch.cat([torch.nonzero(a).reshape(-1) + r * n
                      for r, a in enumerate(traced)])
    assert rays == queue.numel() == int(offsets[-1]) > 0
    assert torch.equal(torch.sort(queue).values, want)
    assert bool((queue % n < live).all())
    tile, tiles_x, tiles = bdpt.splat_tiling(cam.width, cam.height)
    assert (tile, tiles_x, tiles) == (16, 2, 4)
    tile_of = torch.repeat_interleave(torch.arange(tiles),
                                      offsets[1:] - offsets[:-1])
    # each entry's tile from its raster point, as stage 1 finds it
    r, i = queue // n, queue % n
    pts = torch.stack([lv0["pt"][i_] if lv0 is not None and r_ == 0
                       else lbufs.pt[r_ - (lv0 is not None), i_]
                       for r_, i_ in zip(r.tolist(), i.tolist())])
    rx, ry, on = cam.world_to_raster(pts)
    assert bool(on.all())
    ix = torch.clamp(rx.to(torch.int32), 0, W - 1)
    iy = torch.clamp(ry.to(torch.int32), 0, H - 1)
    assert torch.equal((iy // tile) * tiles_x + ix // tile, tile_of)
    assert len(set(offsets.tolist())) > 2   # more than one tile is used


@pytest.mark.parametrize("form", ["bdpt", "vcm"])
@pytest.mark.parametrize("live", [W * H, W * H - 200])
def test_queue_order_splat_matches_plain(walks, form, live):
    sc, cam, out = walks
    lbufs, lv0, eta = out[form]
    n = lbufs.pt.shape[1]
    fb = torch.zeros((n, 3))
    rays = _plain_splat(sc, cam, lbufs, lv0, eta, live, fb)
    if live == n:  # the plain entry points splat every path
        fb2 = torch.zeros((n, 3))
        if lv0 is not None:
            _, rays2 = bdpt.light_trace_splat(sc, cam, lbufs, lv0, CFG, fb2)
        else:
            _, rays2 = vcm.vcm_light_splat(sc, cam, lbufs, VCFG, eta, fb2)
        assert rays2 == rays
        assert torch.equal(fb2, fb)
    queue, _ = bdpt.splat_queue_plain(cam, lbufs, lv0, n_live=live)
    fbq = torch.zeros((n, 3))
    rays_q = _queue_splat(sc, cam, lbufs, lv0, eta, queue,
                          CFG if eta is None else VCFG, fbq)
    assert rays_q == rays
    assert (fb > 0).any(dim=1).float().mean() > 0.2
    np.testing.assert_allclose(fbq.numpy(), fb.numpy(), rtol=1e-6,
                               atol=1e-12)


def test_tiling_rule():
    assert bdpt.splat_tiling(1920, 1080) == (16, 120, 8160)
    assert bdpt.splat_tiling(3840, 2160) == (32, 120, 8160)
    assert bdpt.splat_tiling(16, 16) == (16, 1, 1)
    for w, h in ((7680, 4320), (17, 5000), (1, 1)):
        tile, tx, tiles = bdpt.splat_tiling(w, h)
        assert tiles <= bdpt.SPLAT_MAX_TILES and tx * tile >= w


def test_queue_order_splat_matches_jax():
    """The JAX light walk's buffers (cornell_with_blocks, 16x16, light depth
    4): stage 1 and the queue-order splat against JAX light_trace_splat."""
    w = h = 16
    cfg = dataclasses.replace(CFG, light_depth=4)
    js, _ = jbuild_scene(jbuiltin.cornell_with_blocks(),
                         jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    pid = jrng.pixel_ids(jnp.asarray(gx.ravel().astype(np.int32)),
                         jnp.asarray(gy.ravel().astype(np.int32)))
    key_l = jax.random.fold_in(jrng.sample_key(jrng.base_key(), 0), 1)
    jl = jpaths.generate_light_path(js, key_l, w * h, cfg.light_depth,
                                    ids=pid)
    jfb, jrays = jbdpt.light_trace_splat(
        js, jc, jl[0], jl[1], jbdpt.BDPTConfig(eye_depth=6, light_depth=4),
        jnp.zeros((w * h, 3), jnp.float32))
    lbufs = paths.PathBuffers.from_numpy(jl[0])
    lv0 = {k: torch.as_tensor(np.array(v)) for k, v in jl[1].items()}
    queue, _ = bdpt.splat_queue_plain(tc, lbufs, lv0)
    fb = torch.zeros((w * h, 3))
    rays = _queue_splat(ts, tc, lbufs, lv0, None, queue, cfg, fb)
    assert rays == queue.numel() == int(jrays) > 0
    np.testing.assert_allclose(fb.numpy(), np.asarray(jfb), rtol=1e-4,
                               atol=1e-5)
