"""The mega engine of the PyTorch port (the default `Engine: mega`), on the
CPU with its plain version (models/unidirectional.render_plain, mega draw
schedule).

  * The golden: the setup of tests/test_golden.py (cornell_with_blocks,
    16x16, pinhole at (0,0,1), fov 60, base_key(), max_depth 6, 8 spp)
    within rmse 1e-4 of cornell_mega_16x16_8spp.npy (the golden's own
    bound is 1e-3; measured 2.3e-5, printed, where the port sat at 5.8e-4
    before it retired each path through RGB9E5 as the JAX engine does).
  * Samples 0 and 1 of an 8x8 frame against JAX
    models/unidirectional_mega.render_sample at width 64 on the same
    inputs, on the four scenes of test_torch_unidirectional.py. At width
    64 every path of the frame rides the JAX machine's first wave, the
    only paths that start from the initial medium stack as the port's do
    (models/unidirectional_mega.py docstring). The ray counts are equal.
    Radiance: both engines retire each path through RGB9E5 (9-bit
    mantissas under a shared exponent, utils/packing.py), so each element
    is held to 1e-5 + rtol |jax|, with the rtol of the classic test for
    that scene (GGX-peak and glass lanes, test_torch_unidirectional.py).
    One pixel per scene may miss that bound by one RGB9E5 quantum (2^-8 of
    its largest channel, a rounding edge the float paths reach from either
    side) or by a grazing shadow ray, which can see or miss a surface
    depending on one ulp of its origin (XLA contracts the hit point
    o + d*t into an FMA where the port rounds twice). Measured: no pixel
    over the bound; 510 of 512 pixels bit-equal, the other two (leaf,
    sample 1) one quantum apart (3.9e-3, within that scene's rtol). Over
    all elements the max abs difference is held to 5e-2 and the image mean
    to 2e-3 relative (measured 1.8e-4).
  * The two schedules are not confused: the mega and classic renders of
    the golden setup are different noise realisations, each far (rmse
    > 1e-2) from the other's golden.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import unidirectional_mega as jmega
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import unidirectional as tuni
from cudapathtracer_tpu_torch.models import unidirectional_mega as tmega
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.image import rmse
from test_torch_common import _one_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _grid(w, h):
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                            torch.arange(w, dtype=torch.int32),
                            indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


@pytest.fixture(scope="module")
def golden_renders():
    """8 spp of the golden setup through both engines' plain versions."""
    scene = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")[0]
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(16, 16)
    kernels.reset_launches()
    out = {}
    for name, mod in (("mega", tmega), ("classic", tuni)):
        acc = torch.zeros((256, 3))
        for s in range(8):
            li, rays = mod.render_sample(scene, cam, rng.base_key(), s, px,
                                         py, max_depth=6)
            assert rays > 256
            acc += li
        out[name] = (acc / 8).numpy()
    assert sum(kernels.launches.values()) == 0   # the CPU launches nothing
    return out


def test_golden_cpu(golden_renders):
    golden = np.load(os.path.join(GOLDEN, "cornell_mega_16x16_8spp.npy"))
    err = rmse(golden_renders["mega"], golden)
    print(f"mega golden rmse {err:.3e}")
    assert err < 1e-4, f"golden drift: rmse={err:.2e}"


def test_schedules_not_confused(golden_renders):
    mega = np.load(os.path.join(GOLDEN, "cornell_mega_16x16_8spp.npy"))
    uni = np.load(os.path.join(GOLDEN, "cornell_uni_16x16_8spp.npy"))
    assert rmse(golden_renders["classic"], uni) < 1e-3
    assert rmse(golden_renders["mega"], uni) > 1e-2
    assert rmse(golden_renders["classic"], mega) > 1e-2
    assert not np.array_equal(golden_renders["mega"],
                              golden_renders["classic"])


SCENES = {
    "blocks": lambda b: b.cornell_with_blocks(),
    "spheres": lambda b: b.cornell_with_spheres(),
    "nested": lambda b: b.cornell_glass_core(glass_mat=5, core_mat=10),
    "leaf": lambda b: b.cornell_with_bunny(subdivisions=2, bunny_mat=13),
}
# relative part of the bound, per scene (module docstring)
RTOL = {"blocks": 1e-5, "spheres": 1e-3, "nested": 1e-3, "leaf": 1e-1}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_matches_jax(name):
    js, _ = jbuild_scene(SCENES[name](jbuiltin), jbuiltin_materials())
    ts, _ = build_scene(SCENES[name](builtin), builtin_materials(),
                        device="cpu")
    jcam = JCamera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(8, 8)
    got, want = [], []
    for s in (0, 1):
        jli, jrays = jmega.render_sample(
            js, jcam, jrng.base_key(), s, jnp.asarray(px.numpy()),
            jnp.asarray(py.numpy()), max_depth=6, width=64)
        li, rays = tmega.render_sample(ts, cam, rng.base_key(), s, px, py,
                                       max_depth=6)
        assert rays == int(jrays)
        got.append(li.numpy())
        want.append(np.asarray(jli))
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.isfinite(got).all()
    bound = 1e-5 + RTOL[name] * np.abs(want)
    err = np.abs(got - want)
    over = (err > bound).any(axis=1)
    assert over.sum() <= 1, (
        f"{int(over.sum())} pixels over the bound; worst err/bound "
        f"{np.max(err / bound):.3g}")
    assert err.max() <= 5e-2, err.max()
    assert abs(got.mean() / want.mean() - 1.0) < 2e-3
