"""The classic unidirectional path tracer of the PyTorch port, on the CPU
with the kernels' plain versions.

  * The golden: the setup of tests/test_golden.py (cornell_with_blocks,
    16x16, pinhole at (0,0,1), fov 60, base_key(), max_depth 6, 8 spp)
    within rmse 1e-3 of cornell_uni_16x16_8spp.npy, the golden's own bound.
  * Samples 0 and 1 of an 8x8 frame against JAX
    models/unidirectional.render_sample on the same inputs, on four scenes
    (diffuse; mirror + glass; nested dielectrics with false hits;
    MAT_LEAF). The ray counts are equal: every discrete decision (hits,
    lobe choices, refraction, Russian roulette) agrees. Radiance: rtol
    1e-5, atol 1e-5 on every element of the diffuse scene (measured: at
    most 4.8e-6 absolute, for radiance up to 16); on the others on at least
    97% of the elements, the rest being GGX-peak and glass lanes where one
    ulp of an intermediate is amplified (test_torch_bsdf.py). Those are
    bounded per scene at a few times the measured worst relative error:
    rtol 1e-3 on the spheres and nested scenes (measured 5.3e-5 and
    2.2e-4), rtol 1e-1 on the leaf scene (measured 4.3e-2, one pixel of
    sample 1 whose path crossed a leaf at its GGX peak). The mean of every
    scene's image agrees within 2e-3 relative (measured 1.1e-3 on leaf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import unidirectional as juni
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import unidirectional as tuni
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.image import rmse
from test_torch_common import _one_thread  # noqa: F401  (autouse)

GOLDEN = "tests/golden/cornell_uni_16x16_8spp.npy"


def _grid(w, h):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                            torch.arange(w, dtype=torch.int32),
                            indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


@pytest.fixture(scope="module")
def scene():
    return build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                       device="cpu")[0]


def test_golden_cpu(scene):
    import os
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(16, 16)
    acc = torch.zeros((256, 3))
    kernels.reset_launches()
    for s in range(8):
        li, rays = tuni.render_sample(scene, cam, rng.base_key(), s, px, py,
                                      max_depth=6)
        assert rays > 256
        acc += li
    golden = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), GOLDEN))
    err = rmse((acc / 8).numpy(), golden)
    assert err < 1e-3, f"golden drift: rmse={err:.2e}"
    assert sum(kernels.launches.values()) == 0


SCENES = {
    "blocks": builtin.cornell_with_blocks,
    # mirror + glass spheres: delta lobes, refraction, medium stack
    "spheres": builtin.cornell_with_spheres,
    # a water core (priority 2) inside a glass shell (priority 1): rays
    # crossing the core's boundary inside the glass are false hits
    "nested": lambda: builtin.cornell_glass_core(glass_mat=5, core_mat=10),
    # MAT_LEAF mesh: leaf lobes and shadow-ray transmission
    "leaf": lambda: builtin.cornell_with_bunny(subdivisions=2, bunny_mat=13),
}


# every element, relative (module docstring)
BOUND = {"blocks": 1e-5, "spheres": 1e-3, "nested": 1e-3, "leaf": 1e-1}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_matches_jax(name):
    js, _ = jbuild_scene(SCENES[name](), jbuiltin_materials())
    ts, _ = build_scene(SCENES[name](), builtin_materials(), device="cpu")
    jcam = JCamera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(8, 8)
    got, want = [], []
    for s in (0, 1):
        jli, jrays = juni.render_sample(
            js, jcam, jrng.base_key(), s, jnp.asarray(px.numpy()),
            jnp.asarray(py.numpy()), max_depth=6)
        li, rays = tuni.render_sample(ts, cam, rng.base_key(), s, px, py,
                                      max_depth=6)
        assert rays == int(jrays)
        got.append(li.numpy())
        want.append(np.asarray(jli))
    got, want = np.stack(got), np.stack(want)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert close.mean() >= (1.0 if name == "blocks" else 0.97), close.mean()
    np.testing.assert_allclose(got, want, rtol=BOUND[name], atol=1e-5)
    assert abs(got.mean() / want.mean() - 1.0) < 2e-3
