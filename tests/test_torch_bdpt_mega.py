"""BIDIRECTIONAL with the default mega engine (models/bdpt_mega.py, its
plain versions on the CPU) against the JAX package's models/bdpt_mega on
the same inputs: cornell_with_blocks, 12x12, pinhole at (0,0,1), fov 60,
base_key(), eye depth 5, light depth 4, steps_per_iter=2, mini_splits=1
(the image does not depend on the lane schedule).

One sample at the defaults, in two chunks (chunk_pixels), with pad paths
(width), and with each of NEE, the connections and the light-trace splat
turned off, held as the VCM mega engine is (test_torch_vcm_mega.
assert_parity: >= 99% of the pixels within 2^-8 max_c + 1e-4 |x| + 1e-5,
the image mean within 1e-3, the rays within 0.1%). Measured: every pixel
within the bound, the rays equal and the mean ratio 1.0 on every case,
72-100% of the pixels bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import bdpt as jbdpt
from cudapathtracer_tpu.models import bdpt_mega as jbdpt_mega
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, bdpt_mega
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_vcm_mega import assert_parity
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 12
CASES = {
    "defaults": ({}, {}),
    "two_chunks": ({}, dict(chunk_pixels=72)),
    "pad": ({}, dict(width=100)),
    "no_nee": (dict(nee=False), {}),
    "no_connection": (dict(connection=False), {}),
    "no_light_trace": (dict(light_trace=False), {}),
}


@pytest.fixture(scope="module")
def setup():
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    jpx, jpy = jnp.meshgrid(jnp.arange(W), jnp.arange(H))
    return dict(js=js, ts=ts, jpx=jpx.ravel(), jpy=jpy.ravel(),
                jc=JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0,
                                   60.0),
                tc=Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0,
                                  60.0))


def test_machine_cfg():
    """BDPT's settings on the eye pass's config surface, merge off."""
    cfg = bdpt.BDPTConfig(eye_depth=7, light_depth=3, nee=False,
                          paint_weight=True)
    m = bdpt_mega.as_machine_cfg(cfg)
    want = jbdpt_mega._as_machine_cfg(jbdpt.BDPTConfig(
        eye_depth=7, light_depth=3, nee=False, paint_weight=True))
    for f in dataclasses.fields(m):
        assert getattr(m, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("case", list(CASES))
def test_sample_matches_jax(setup, case):
    over, part = CASES[case]
    jcfg = dataclasses.replace(jbdpt.BDPTConfig(eye_depth=5, light_depth=4),
                               **over)
    cfg = dataclasses.replace(bdpt.BDPTConfig(eye_depth=5, light_depth=4),
                              **over)
    jli, jrays = jbdpt_mega.render_sample(
        setup["js"], setup["jc"], jrng.base_key(), 1, setup["jpx"],
        setup["jpy"], cfg=jcfg, steps_per_iter=2, mini_splits=1, **part)
    kernels.reset_launches()
    li, rays = bdpt_mega.render_sample(
        setup["ts"], setup["tc"], rng.base_key(), 1,
        torch.as_tensor(np.array(setup["jpx"])),
        torch.as_tensor(np.array(setup["jpy"])), cfg=cfg, **part)
    assert sum(kernels.launches.values()) == 0
    assert_parity(li, np.asarray(jli), rays, int(jrays))
