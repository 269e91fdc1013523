"""Classic BDPT of the PyTorch port (models/bdpt.py: the plain versions of
kernels K11 and K13 and the whole sample) against the JAX package on the
CPU, on the golden setup: cornell_with_blocks, 16x16, pinhole at (0,0,1),
fov 60, base_key(), eye depth 6, light depth 4.

  * The splat and the connection stage are fed the JAX package's own
    buffers (PathBuffers.from_numpy of the JAX walks), so their parity
    does not rest on the walks'. Splat: against JAX light_trace_splat on
    the same buffers, atol 1e-5 + rtol 1e-4 per element (the same float32
    formulas; XLA:CPU contracts dot products into FMAs; measured below
    2e-6 relative) and equal ray counts. Connections: against the radiance
    that JAX render_sample returns beside its splat (splat_shape), which
    re-runs the walks under jit: rtol 1e-3 on at least 99% of the
    elements (a grazing shadow ray may flip on one ulp) and the image mean
    within 1e-3.
  * The sample: the port's render_sample against JAX render_sample on
    samples 0 and 1: ray counts within 0.1%, image mean within 1e-3,
    and 8 samples against tests/golden/cornell_bdpt_16x16_8spp.npy at
    rmse < 1e-3 (the golden's own bound; measured 3.4e-4).
  * Every strategy flag off in turn, paint_weight and sample_environment
    on, do_mis off: each renders finite, non-negative radiance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cudapathtracer_tpu.models import bdpt as jbdpt
from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, paths
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.image import rmse
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 16
N = W * H
CFG = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
JCFG = jbdpt.BDPTConfig(eye_depth=6, light_depth=4)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "cornell_bdpt_16x16_8spp.npy")


def _grid():
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    return gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid()
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    pid = jrng.pixel_ids(jpx, jpy)
    skey = jrng.sample_key(jrng.base_key(), 0)
    jkl, jke = jax.random.fold_in(skey, 1), jax.random.fold_in(skey, 2)
    jl = jpaths.generate_light_path(js, jkl, N, CFG.light_depth, ids=pid)
    je = jpaths.generate_eye_path(js, jc, jke, jpx, jpy, CFG.eye_depth,
                                  ids=pid)
    jfb, jrays_s = jbdpt.light_trace_splat(js, jc, jl[0], jl[1], JCFG,
                                           jnp.zeros((N, 3), jnp.float32))
    samples = [jbdpt.render_sample(js, jc, jrng.base_key(), s, jpx, jpy,
                                   cfg=JCFG, splat_shape=N) for s in (0, 1)]
    return dict(js=js, ts=ts, jc=jc, tc=tc, px=torch.as_tensor(px),
                py=torch.as_tensor(py), jl=jl, je=je,
                jfb=np.asarray(jfb), jrays_s=int(jrays_s),
                samples=[tuple(np.asarray(a) for a in s) for s in samples])


def _lv0(jv0):
    return {k: torch.as_tensor(np.array(v)) for k, v in jv0.items()}


def test_light_trace_splat_matches_jax(setup):
    lbufs = paths.PathBuffers.from_numpy(setup["jl"][0])
    fb = torch.zeros((N, 3))
    fb, rays = bdpt.light_trace_splat(setup["ts"], setup["tc"], lbufs,
                                      _lv0(setup["jl"][1]), CFG, fb)
    assert rays == setup["jrays_s"] > 0
    want = setup["jfb"]
    assert (want > 0).any(axis=1).mean() > 0.2
    np.testing.assert_allclose(fb.numpy(), want, rtol=1e-4, atol=1e-5)


def test_connections_match_jax(setup):
    """The connection stage on JAX's eye and light buffers against the
    radiance (without the splat) of JAX render_sample, sample 0."""
    je, jl = setup["je"], setup["jl"]
    ebufs = paths.PathBuffers.from_numpy(je[0])
    lbufs = paths.PathBuffers.from_numpy(jl[0])
    ev0 = _lv0(je[1])
    esc = paths.Escape(*(torch.as_tensor(np.array(a)) for a in je[2]))
    _, _, key_c = bdpt.sample_keys(rng.base_key(), 0)
    li, rays_c = bdpt.connect_plain(
        setup["ts"], setup["tc"], key_c, ebufs, ev0, esc, lbufs,
        _lv0(jl[1]), CFG, rng.pixel_ids(setup["px"], setup["py"]))
    jli, jsplat, jrays = setup["samples"][0]
    assert rays_c > 0
    assert rays_c + int(jl[2]) + int(je[3]) + setup["jrays_s"] == int(jrays)
    got = li.numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, jli, rtol=1e-3, atol=1e-6)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() / jli.mean() - 1.0) < 1e-3
    np.testing.assert_allclose(setup["jfb"], jsplat, rtol=1e-3, atol=1e-5)


def test_render_sample_matches_jax(setup):
    kernels.reset_launches()
    for s, (jli, jsplat, jrays) in enumerate(setup["samples"]):
        li, rays = bdpt.render_sample(setup["ts"], setup["tc"],
                                      rng.base_key(), s, setup["px"],
                                      setup["py"], cfg=CFG)
        want = jli + jsplat
        assert abs(rays - int(jrays)) <= 1e-3 * int(jrays)
        got = li.numpy()
        assert np.isfinite(got).all() and (got >= 0).all()
        assert abs(got.mean() / want.mean() - 1.0) < 1e-3
        assert np.isclose(got, want, rtol=1e-3, atol=1e-5).mean() >= 0.98
    assert sum(kernels.launches.values()) == 0


def test_golden_cpu(setup):
    acc = torch.zeros((N, 3))
    for s in range(8):
        li, rays = bdpt.render_sample(setup["ts"], setup["tc"],
                                      rng.base_key(), s, setup["px"],
                                      setup["py"], cfg=CFG)
        assert rays > N
        acc += li
    err = rmse((acc / 8).numpy(), np.load(GOLDEN))
    assert err < 1e-3, f"golden drift: rmse={err:.2e}"


FLAGS = chip_smoke.BDPT_FLAGS


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_strategy_flags(setup, name):
    """Each strategy switch renders finite, non-negative radiance; with a
    strategy off the image loses light and stays finite."""
    cfg = dataclasses.replace(CFG, **FLAGS[name])
    li, rays = bdpt.render_sample(setup["ts"], setup["tc"], rng.base_key(),
                                  1, setup["px"], setup["py"], cfg=cfg)
    img = li.numpy()
    assert img.shape == (N, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert rays > 0 and img.max() > 0
