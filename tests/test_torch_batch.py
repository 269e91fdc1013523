"""Samples per dispatch in the PyTorch port (models/batch.py, the driver's
batched loop and resolve_samples_per_dispatch), mirroring
tests/test_batch.py on the CPU with the kernels' plain versions.

Tolerances, with their reasons:
  * A batch equals its k single samples summed in sample order from zeros,
    bit for bit, rays and dropped counts equal (the same code with the same
    draws): UNIDIRECTIONAL classic and mega and NAIVE_UNIDIRECTIONAL, and
    the multi-launch BDPT-mega and VCM-mega engines in one chunk, at 12x12,
    k = 3 from sample 2.
  * The port's batch against JAX's make_batched on the same step (classic
    and mega, cornell_with_blocks, max depth 4): rays equal, radiance
    within the bound of the integrators' own port tests on this scene
    (test_torch_unidirectional*.py: 1e-5 + 1e-5 |x|, at most one pixel
    over it, the mean within 2e-3).
  * The driver renders the same image at 1 and 2 samples per dispatch,
    with a remainder batch; the JAX rule of samples per dispatch; the CLI
    flag; and a counter total above 2^31 summed exactly in int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import unidirectional as juni
from cudapathtracer_tpu.models import unidirectional_mega as jmega
from cudapathtracer_tpu.models.batch import make_batched as jmake_batched
from cudapathtracer_tpu.scene import builtin as jbuiltin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch import cli, driver
from cudapathtracer_tpu_torch.driver import (Renderer,
                                             resolve_samples_per_dispatch)
from cudapathtracer_tpu_torch.models import (bdpt, bdpt_mega, naive,
                                             unidirectional,
                                             unidirectional_mega, vcm,
                                             vcm_mega)
from cudapathtracer_tpu_torch.models.batch import make_batched
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.config import MeshConfig, RenderConfig
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SIZE = 12
K, S0 = 3, 2


@pytest.fixture(scope="module")
def setup():
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                           device="cpu")
    cam = Camera.pinhole((0.0, 0.0, 1.0), SIZE, SIZE, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(SIZE, dtype=torch.int32),
                            torch.arange(SIZE, dtype=torch.int32),
                            indexing="ij")
    return scene, cam, gx.reshape(-1), gy.reshape(-1)


BDPT_CFG = bdpt.BDPTConfig(eye_depth=4, light_depth=3)
VCM_CFG = vcm.VCMConfig(eye_depth=4, light_depth=3)
INNERS = {
    "classic": lambda sc, c, kk, s, px, py: unidirectional.render_sample(
        sc, c, kk, s, px, py, max_depth=4),
    "mega": lambda sc, c, kk, s, px, py: unidirectional_mega.render_sample(
        sc, c, kk, s, px, py, max_depth=4),
    "naive": lambda sc, c, kk, s, px, py: naive.render_sample(
        sc, c, kk, s, px, py, max_depth=4),
    "bdpt_mega": lambda sc, c, kk, s, px, py: bdpt_mega.render_sample(
        sc, c, kk, s, px, py, cfg=BDPT_CFG),
    "vcm_mega": lambda sc, c, kk, s, px, py: vcm_mega.render_sample(
        sc, c, kk, s, px, py, cfg=VCM_CFG),
}


@pytest.fixture(scope="module")
def batch_of(setup):
    """The port's batch (k = 3 from sample 2) of an integrator, computed
    once for the tests that read it."""
    scene, cam, px, py = setup
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = make_batched(INNERS[name])(scene, cam, rng.base_key(),
                                                    S0, px, py, K)
        return memo[name]
    return get


@pytest.mark.parametrize("name", sorted(INNERS))
def test_batch_bit_identical_to_singles(setup, batch_of, name):
    scene, cam, px, py = setup
    inner = INNERS[name]
    key = rng.base_key()
    acc = torch.zeros((SIZE * SIZE, 3), dtype=torch.float32)
    totals = None
    for s in range(S0, S0 + K):
        out = inner(scene, cam, key, s, px, py)
        acc = acc + out[0]
        totals = list(out[1:]) if totals is None else [
            t + c for t, c in zip(totals, out[1:])]
    got = batch_of(name)
    assert len(got) == len(totals) + 1
    assert torch.equal(got[0], acc)
    for g, t in zip(got[1:], totals):
        assert g.dtype == torch.int64 and g.dim() == 0
        assert int(g) == t
    assert totals[0] > SIZE * SIZE * K
    if name == "vcm_mega":
        assert len(totals) == 2


@pytest.mark.parametrize("engine", ["classic", "mega"])
def test_batch_matches_jax(setup, batch_of, engine):
    js, _ = jbuild_scene(jbuiltin.cornell_with_blocks(), jbuiltin_materials())
    jcam = JCamera.pinhole((0.0, 0.0, 1.0), SIZE, SIZE, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(SIZE), jnp.arange(SIZE))
    if engine == "classic":
        jinner = lambda sc, c, kk, s, x, y: juni.render_sample(
            sc, c, kk, s, x, y, max_depth=4)
    else:
        jinner = lambda sc, c, kk, s, x, y: jmega.render_sample(
            sc, c, kk, s, x, y, max_depth=4, grid_w=SIZE)
    jli, jrays = jmake_batched(jinner)(js, jcam, jrng.base_key(), S0,
                                       jpx.ravel(), jpy.ravel(), K)
    li, rays = batch_of(engine)
    assert int(rays) == int(jrays)
    got, want = li.numpy(), np.asarray(jli)
    err = np.abs(got - want)
    over = (err > 1e-5 + 1e-5 * np.abs(want)).any(axis=1)
    assert over.sum() <= 1, int(over.sum())
    assert abs(got.mean() / want.mean() - 1.0) < 2e-3


def _cfg(tmp_path, spd, **over):
    return RenderConfig(
        width=SIZE, height=SIZE, integrator=over.pop("integrator",
                                                     "UNIDIRECTIONAL"),
        engine=over.pop("engine", "classic"), sample_count=5, max_depth=4,
        meshes=[MeshConfig(path="builtin:cornell_blocks")],
        samples_per_dispatch=spd, output_dir=str(tmp_path), **over)


@pytest.mark.parametrize("integrator", ["UNIDIRECTIONAL", "VCM"])
def test_driver_samples_per_dispatch_invariant(tmp_path, integrator):
    """The same accumulation dispatch by dispatch or in batches of 2 (5
    samples: two batches and a remainder), rays and dropped counts equal."""
    kw = dict(integrator=integrator, engine="classic")
    if integrator == "VCM":
        kw.update(engine="mega", bdpt_eye_depth=4, bdpt_light_depth=3)
    r1 = Renderer(_cfg(tmp_path, 1, **kw), device="cpu")
    img1 = r1.render(progressive=False, verbose=False)
    r2 = Renderer(_cfg(tmp_path, 2, **kw), device="cpu")
    img2 = r2.render(progressive=False, verbose=False)
    np.testing.assert_array_equal(img1.pixels, img2.pixels)
    assert r2.sample_count == 5
    assert r1.metrics.rays_traced == r2.metrics.rays_traced > 0
    assert r1.metrics.merge_dropped == r2.metrics.merge_dropped


def test_auto_samples_per_dispatch():
    """Auto (0): small frames on a card batch, the CPU and large frames stay
    per-sample; explicit values always win (the device type in place of
    the JAX backend)."""
    small = RenderConfig(width=256, height=256)
    large = RenderConfig(width=1920, height=1080)
    assert resolve_samples_per_dispatch(small, "cuda") == 8
    assert resolve_samples_per_dispatch(
        RenderConfig(width=512, height=512), "cuda") == 8
    assert resolve_samples_per_dispatch(
        RenderConfig(width=1024, height=512), "cuda") == 1
    assert resolve_samples_per_dispatch(
        RenderConfig(width=600, height=400), "cuda") == 8
    assert resolve_samples_per_dispatch(large, "cuda") == 1
    assert resolve_samples_per_dispatch(small, "cpu") == 1
    assert resolve_samples_per_dispatch(
        RenderConfig(width=256, height=256, samples_per_dispatch=3),
        torch.device("cpu")) == 3


def test_cli_samples_per_dispatch(tmp_path, monkeypatch):
    cfg = tmp_path / "tiny.rendertron"
    cfg.write_text(f"""Name: tiny
width: 16
height: 12
Integrator: UNIDIRECTIONAL
Sample Count: 3
Unidirectional Max Depth: 3
Output Dir: {tmp_path / 'renders'}
Meshes (path; multiplier * emission; materialID):
builtin:cornell_blocks; 1.0 * (0.0, 0.0, 0.0); 2
""")
    seen = []
    real = driver.resolve_samples_per_dispatch
    monkeypatch.setattr(driver, "resolve_samples_per_dispatch",
                        lambda c, d: seen.append(real(c, d)) or seen[-1])
    assert cli.main([str(cfg), "--device", "cpu", "--no-progressive",
                     "--samples-per-dispatch", "2"]) == 0
    assert seen == [2]
    assert (tmp_path / "renders" / "tiny0.bmp").exists()


def test_counter_total_above_2_31_exact():
    """Counters sum as int64: three samples of 2^31 - 1 rays and 2^32 + 5
    dropped photons each, as a Python int and as a 0-d int64 tensor."""
    big = 2 ** 31 - 1

    def inner(scene, camera, key, s, px, py):
        drop = (2 ** 32 + 5) if s % 2 else torch.tensor(2 ** 32 + 5)
        return torch.zeros((px.shape[0], 3)), big, drop
    px = torch.zeros(4, dtype=torch.int32)
    li, rays, dropped = make_batched(inner)(None, None, None, 0, px, px, 3)
    assert rays.dtype == dropped.dtype == torch.int64
    assert int(rays) == 3 * big
    assert int(dropped) == 3 * (2 ** 32 + 5)
