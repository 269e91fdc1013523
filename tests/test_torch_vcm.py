"""VCM and SPPM of the PyTorch port (models/vcm.py: the plain versions of
the VCM splat and the eye pass, and the whole sample) against the JAX
package on the CPU, on the golden setup: cornell_with_blocks, 16x16,
pinhole at (0,0,1), fov 60, base_key(), eye depth 6, light depth 4.

  * The per-sample scalars (merge radius, eta_vcm, the merge
    normalisation) equal JAX's float32 values.
  * The splat is fed the JAX package's own VCM light buffers
    (PathBuffers.from_numpy): against JAX vcm_light_splat, atol 1e-5 +
    rtol 1e-4 per element (the same float32 formulas; XLA:CPU contracts
    dot products into FMAs) and equal ray counts.
  * The sample: the port's render_sample against JAX render_sample on
    samples 0 and 1: rays within 0.1%, image mean within 1e-3, >= 98% of
    the elements within rtol 1e-3 (a grazing shadow ray or a photon at the
    merge radius may flip on one ulp), as for BDPT.
  * 8 samples of VCM and of SPPM against tests/golden/
    cornell_{vcm,sppm}_16x16_8spp.npy at rmse < 1e-3 (the goldens' own
    bound).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import paths as jpaths
from cudapathtracer_tpu.models import vcm as jvcm
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu.utils.math import PI
from cudapathtracer_tpu.utils.math import merge_radius as jmerge_radius
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import paths, vcm
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.image import rmse
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 16
N = W * H
CFG = vcm.VCMConfig(eye_depth=6, light_depth=4)
JCFG = jvcm.VCMConfig(eye_depth=6, light_depth=4)
SPPM = dict(light_trace=False, nee=False, naive=False, connection=False,
            do_mis=False, do_sppm=True)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def setup():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(W), jnp.arange(H))
    jpx, jpy = jpx.ravel(), jpy.ravel()
    samples = [jvcm.render_sample(js, jc, jrng.base_key(), s, jpx, jpy,
                                  cfg=JCFG) for s in (0, 1)]
    return dict(js=js, ts=ts, jc=jc, tc=tc, jpx=jpx, jpy=jpy,
                px=torch.as_tensor(np.array(jpx), dtype=torch.int32),
                py=torch.as_tensor(np.array(jpy), dtype=torch.int32),
                samples=[tuple(np.asarray(a) for a in s) for s in samples])


def _jax_scalars(js, s):
    r0 = js.scene_radius * JCFG.r0_multiplier
    mr = jmerge_radius(r0, jnp.asarray(s, jnp.float32), JCFG.merge_alpha)
    return mr, N * PI * mr * mr, 1.0 / (PI * mr * mr * N)


@pytest.mark.parametrize("s", [0, 1, 7])
def test_sample_scalars_match_jax(setup, s):
    got = vcm.sample_scalars(setup["ts"], CFG, s, N)
    for a, b in zip(got, _jax_scalars(setup["js"], s)):
        assert np.float32(a) == np.float32(b), (a, float(b))


def test_vcm_light_splat_matches_jax(setup):
    """The VCM splat on the JAX VCM light walk's buffers (light_depth
    stored vertices, eta_vcm on)."""
    js, jc = setup["js"], setup["jc"]
    skey = jrng.sample_key(jrng.base_key(), 0)
    key_l = jax.random.fold_in(skey, 1)
    pid = jrng.pixel_ids(setup["jpx"], setup["jpy"])
    _, eta, _ = _jax_scalars(js, 0)
    start, _ = jpaths.start_light_walk(js, key_l, N, ids=pid)
    lb, _, _ = jpaths.random_walk(
        js, key_l, start, JCFG.light_depth + 1, 1, eta_vcm=eta,
        first_vm_seed=start.first_vc_scale / jnp.maximum(eta, 1e-30),
        ids=pid)
    jfb, jrays = jvcm.vcm_light_splat(js, jc, lb, JCFG, eta,
                                      jnp.zeros((N, 3), jnp.float32))
    lbufs = paths.PathBuffers.from_numpy(lb)
    assert lbufs.pt.shape[0] == CFG.light_depth
    assert bool((lbufs.d_vm != 0).any())
    fb, rays = vcm.vcm_light_splat(setup["ts"], setup["tc"], lbufs, CFG,
                                   float(eta), torch.zeros((N, 3)))
    assert rays == int(jrays) > 0
    want = np.asarray(jfb)
    assert (want > 0).any(axis=1).mean() > 0.1
    np.testing.assert_allclose(fb.numpy(), want, rtol=1e-4, atol=1e-5)


def test_render_sample_matches_jax(setup):
    kernels.reset_launches()
    for s, (want, jrays) in enumerate(setup["samples"]):
        li, rays, dropped = vcm.render_sample(
            setup["ts"], setup["tc"], rng.base_key(), s, setup["px"],
            setup["py"], cfg=CFG)
        assert abs(rays - int(jrays)) <= 1e-3 * int(jrays)
        assert dropped >= 0
        got = li.numpy()
        assert np.isfinite(got).all() and (got >= 0).all()
        assert abs(got.mean() / want.mean() - 1.0) < 1e-3
        assert np.isclose(got, want, rtol=1e-3, atol=1e-5).mean() >= 0.98
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("name", ["vcm", "sppm"])
def test_golden_cpu(setup, name):
    cfg = CFG if name == "vcm" else dataclasses.replace(CFG, **SPPM)
    acc = torch.zeros((N, 3))
    for s in range(8):
        li, rays, _ = vcm.render_sample(setup["ts"], setup["tc"],
                                        rng.base_key(), s, setup["px"],
                                        setup["py"], cfg=cfg)
        assert rays > N
        acc += li
    golden = np.load(os.path.join(GOLDEN, f"cornell_{name}_16x16_8spp.npy"))
    err = rmse((acc / 8).numpy(), golden)
    assert err < 1e-3, f"{name} golden drift: rmse={err:.2e}"
