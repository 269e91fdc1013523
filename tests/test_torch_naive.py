"""The naive unidirectional path tracer of the PyTorch port
(models/naive.py, its plain version on the CPU) against the JAX package's
models/naive.render_sample on the same inputs: samples 0 and 1 of a 12x12
frame, max depth 6, on three scenes (diffuse; mirror + glass; MAT_LEAF),
and with the environment sampled on the diffuse one.

Held as the mega engines are (test_torch_vcm_mega.assert_parity): >= 99%
of the pixels within 2^-8 max_c + 1e-4 |x| + 1e-5 per element, the image
mean within 1e-3 relative, the rays within 0.1%. Measured: every pixel
within the bound and the rays equal on every case; the diffuse scene
bit-equal without the environment, 76-100% of the pixels bit-equal
elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import naive as jnaive
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import naive
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_vcm_mega import assert_parity
from test_torch_common import _one_thread  # noqa: F401  (autouse)

W = H = 12
SCENES = {
    "blocks": builtin.cornell_with_blocks,
    "spheres": builtin.cornell_with_spheres,
    "leaf": lambda: builtin.cornell_with_bunny(subdivisions=2, bunny_mat=13),
}


@pytest.mark.parametrize("name,env", [("blocks", False), ("blocks", True),
                                      ("spheres", False), ("leaf", False)])
def test_sample_matches_jax(name, env):
    js, _ = jbuild_scene(SCENES[name](), jbuiltin_materials())
    ts, _ = build_scene(SCENES[name](), builtin_materials(), device="cpu")
    jc = JCamera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(W), jnp.arange(H))
    jpx, jpy = jpx.ravel(), jpy.ravel()
    px = torch.as_tensor(np.array(jpx), dtype=torch.int32)
    py = torch.as_tensor(np.array(jpy), dtype=torch.int32)
    kernels.reset_launches()
    for s in (0, 1):
        jli, jrays = jnaive.render_sample(js, jc, jrng.base_key(), s, jpx,
                                          jpy, max_depth=6,
                                          sample_environment=env)
        li, rays = naive.render_sample(ts, tc, rng.base_key(), s, px, py,
                                       max_depth=6, sample_environment=env)
        assert rays > W * H
        assert_parity(li, np.asarray(jli), rays, int(jrays))
    assert sum(kernels.launches.values()) == 0
