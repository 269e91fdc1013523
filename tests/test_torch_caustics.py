"""The port's mirror of tests/test_caustics.py (the SDS acceptance tests:
the reference's signature capability), on the port's plain CPU paths
(models/vcm.render_plain and models/bdpt.render_plain through
render_sample on CPU tensors), with the same scene, size, samples and
bounds.

Scene: builtin.cornell_glass_core, a diffuse core enclosed in a glass
shell, so every path that lights the core is L -> S -> D -> S -> E. With
the naive (s=0) strategy off BDPT cannot light the core (NEE and the
light-trace splat are blocked by the shell, connections between core
vertices by the core itself); VCM's and SPPM's photon merging needs no
shadow ray, and reaches the core through K8's grid and K9's merge. The
core keeps a non-SDS floor from the shell's Fresnel reflection of the box,
which BDPT renders: hence the ratio bound (VCM > 2x BDPT), VCM's core
brighter than 0.1, and SPPM within 50% of VCM.
"""

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.models import bdpt, vcm
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng

W = 24
SPP = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain paths' many small operators on a 576-pixel frame run
    fastest on one thread (and do not oversubscribe the test workers'
    cores); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def glass_core():
    scene, _ = build_scene(builtin.cornell_glass_core(), builtin_materials(),
                           device="cpu")
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, W, 0.0, 0.0, 0.0, 60.0)
    py, px = torch.meshgrid(torch.arange(W), torch.arange(W), indexing="ij")
    return scene, cam, px.reshape(-1), py.reshape(-1)


def render(setup, fn, spp, **kw):
    scene, cam, px, py = setup
    acc = torch.zeros((W * W, 3))
    for s in range(spp):
        acc += fn(scene, cam, rng.base_key(), s, px, py, **kw)[0]
    return (acc / spp).reshape(W, W, 3).numpy()


def core_mean(img):
    """Mean over the pixels covering the enclosed core (the sphere at
    (0, -0.1, 0), r = 0.15, seen from the camera above)."""
    return float(img[10:16, 9:15].mean())


@pytest.fixture(scope="module")
def vcm_image(glass_core):
    cfg = vcm.VCMConfig(eye_depth=8, light_depth=6, r0_multiplier=0.03,
                        naive=False)
    return render(glass_core, vcm.render_sample, SPP, cfg=cfg)


def test_vcm_renders_sds_core_bdpt_cannot(glass_core, vcm_image):
    assert np.isfinite(vcm_image).all()
    bcfg = bdpt.BDPTConfig(eye_depth=8, light_depth=6, naive=False)
    img_bdpt = render(glass_core, bdpt.render_sample, SPP, cfg=bcfg)
    assert np.isfinite(img_bdpt).all()
    v, b = core_mean(vcm_image), core_mean(img_bdpt)
    assert v > 2.0 * b, f"VCM core {v:.4f} not >> BDPT core {b:.4f}"
    assert v > 0.1, f"VCM core region unexpectedly dark: {v:.4f}"


def test_sppm_agrees_with_vcm_on_sds_core(glass_core, vcm_image):
    """SPPM (merge only) and VCM mix different estimators of the same
    transport: their SDS core energy must agree."""
    scfg = vcm.VCMConfig(eye_depth=8, light_depth=6, r0_multiplier=0.03,
                         light_trace=False, nee=False, naive=False,
                         connection=False, do_mis=False, do_sppm=True)
    img_sppm = render(glass_core, vcm.render_sample, SPP, cfg=scfg)
    v, s = core_mean(vcm_image), core_mean(img_sppm)
    assert s > 0.1
    assert abs(v - s) / max(v, s) < 0.5, \
        f"VCM {v:.4f} vs SPPM {s:.4f} disagree on the SDS core"
