"""VCM and SPPM with the default mega engine (models/vcm_mega.py, its plain
versions on the CPU) against the JAX package's models/vcm_mega on the same
inputs: cornell_with_blocks, pinhole at (0,0,1), fov 60, base_key().

  * mega_chunks equals the JAX engine's partition arithmetic
    (vcm_mega.render_sample, the same in bdpt_mega) over a sweep of frame
    sizes, chunk_pixels and widths; the chunk scalars (eta_vcm, the merge
    normalisation) equal JAX's float32 values.
  * One sample against JAX render_sample (steps_per_iter=2, mini_splits=1:
    the image does not depend on the lane schedule, tests/test_vcm_mega.py)
    at 16x16 (eye 6, light 4) and at 12x12 (eye 5, light 4) in two chunks
    (chunk_pixels) and with pad paths (width), SPPM at 16x16 and with the
    fold's cap (max_per_cell 16): >= 99% of the pixels within
    2^-8 max_c + 1e-4 |x| + 1e-5 per element (one RGB9E5 quantum, and the
    float32 summation order), the image mean within 1e-3 relative, the rays
    within 0.1% and the merge cap's dropped photons equal. Measured: rays
    and dropped counts equal on every case; every pixel within the bound
    but one of the 144 of the two-chunk case (mean ratio 0.9999835); both
    SPPM cases bit-equal, 66-77% of the VCM pixels bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.models import vcm as jvcm
from cudapathtracer_tpu.models import vcm_mega as jvcm_mega
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera as JCamera
from cudapathtracer_tpu.scene.materials import \
    builtin_materials as jbuiltin_materials
from cudapathtracer_tpu.scene.scene import build_scene as jbuild_scene
from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu.utils.math import PI
from cudapathtracer_tpu.utils.math import merge_radius as jmerge_radius
from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import vcm, vcm_mega
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SPPM = dict(light_trace=False, nee=False, naive=False, connection=False,
            do_mis=False, do_sppm=True)


def assert_parity(li, want, rays, want_rays, share=0.99):
    """The mega engines' parity with JAX: >= share of the pixels within
    2^-8 max_c + 1e-4 |x| + 1e-5 on every channel, the image mean within
    1e-3 relative, the rays within 0.1%."""
    got = li.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all() and (got >= 0).all()
    maxc = np.maximum(got.max(axis=1), want.max(axis=1))[:, None]
    tol = 2.0 ** -8 * maxc + 1e-4 * np.abs(want) + 1e-5
    ok = (np.abs(got - want) <= tol).all(axis=1)
    assert ok.mean() >= share, (
        f"{(~ok).sum()} of {ok.size} pixels beyond the bound: "
        f"{got[~ok]} vs {want[~ok]}")
    assert abs(got.mean() / want.mean() - 1.0) < 1e-3
    assert abs(rays - want_rays) <= 1e-3 * want_rays


def _jax_partition(p_total, chunk_pixels, width):
    """The JAX engines' arithmetic (models/vcm_mega.py render_sample)."""
    c_pix0 = min(chunk_pixels or max(p_total // max(
        1, -(-p_total // (1 << 20))), 1), p_total)
    w = min(width or jvcm_mega.MEGA_WIDTH, c_pix0)
    gens = -(-c_pix0 // w)
    c_pix = gens * w
    return c_pix, -(-p_total // c_pix), w


@pytest.mark.parametrize("p_total", [1, 7, 144, 256, 262144, 1036800,
                                     2073600, (1 << 20) + 1, 3 << 20])
def test_mega_chunks_match_jax(p_total):
    assert vcm_mega.MEGA_WIDTH == jvcm_mega.MEGA_WIDTH
    for chunk_pixels in (0, 1, 72, 5000, 1 << 20):
        for width in (0, 1, 64, 100, 12960, 1 << 22):
            ch = vcm_mega.mega_chunks(p_total, chunk_pixels, width)
            assert tuple(ch) == _jax_partition(p_total, chunk_pixels, width)
            assert ch.n_chunks * ch.c_pix >= p_total
            assert (ch.n_chunks - 1) * ch.c_pix < p_total
    # the shapes the port renders at full size
    assert tuple(vcm_mega.mega_chunks(1920 * 1080)) == (1036800, 2, 12960)
    assert tuple(vcm_mega.mega_chunks(512 * 512)) == (272160, 1, 12960)


@pytest.mark.parametrize("s", [0, 3])
@pytest.mark.parametrize("cnt", [1, 100, 144, 1036800])
def test_chunk_scalars_match_jax(s, cnt):
    ts, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")
    js, _ = jbuild_scene(builtin.cornell_with_blocks(), jbuiltin_materials())
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4)
    r0 = js.scene_radius * cfg.r0_multiplier
    mr = jmerge_radius(r0, jnp.asarray(s, jnp.float32), cfg.merge_alpha)
    c = jnp.int32(cnt)
    want = (mr, c.astype(jnp.float32) * PI * mr * mr,
            1.0 / (PI * mr * mr * jnp.maximum(c.astype(jnp.float32), 1.0)))
    got = vcm_mega.chunk_scalars(ts, cfg, s, cnt)
    for a, b in zip(got, want):
        assert np.float32(a) == np.float32(b), (a, float(b))


@pytest.fixture(scope="module")
def scenes():
    return (jbuild_scene(builtin.cornell_with_blocks(),
                         jbuiltin_materials())[0],
            build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device="cpu")[0])


# name -> (frame side, eye depth, config overrides, partition, sample)
CASES = {
    "vcm16": (16, 6, {}, {}, 1),
    "vcm12_two_chunks": (12, 5, {}, dict(chunk_pixels=72), 1),
    "vcm12_pad": (12, 5, {}, dict(width=100), 0),
    "sppm16": (16, 6, SPPM, {}, 1),
    "sppm12_fold": (12, 5, dict(SPPM, max_per_cell=16,
                                r0_multiplier=0.05), {}, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_matches_jax(scenes, case):
    side, eye, over, part, s = CASES[case]
    js, ts = scenes
    jc = JCamera.pinhole((0.0, 0.0, 1.0), side, side, 0.0, 0.0, 0.0, 60.0)
    tc = Camera.pinhole((0.0, 0.0, 1.0), side, side, 0.0, 0.0, 0.0, 60.0)
    jpx, jpy = jnp.meshgrid(jnp.arange(side), jnp.arange(side))
    jpx, jpy = jpx.ravel(), jpy.ravel()
    jcfg = dataclasses.replace(jvcm.VCMConfig(eye_depth=eye, light_depth=4),
                               **over)
    cfg = dataclasses.replace(vcm.VCMConfig(eye_depth=eye, light_depth=4),
                              **over)
    jli, jrays, jdrop = jvcm_mega.render_sample(
        js, jc, jrng.base_key(), s, jpx, jpy, cfg=jcfg, steps_per_iter=2,
        mini_splits=1, count_merge_dropped=True, **part)
    kernels.reset_launches()
    li, rays, dropped = vcm_mega.render_sample(
        ts, tc, rng.base_key(), s, torch.as_tensor(np.array(jpx)),
        torch.as_tensor(np.array(jpy)), cfg=cfg, **part)
    assert sum(kernels.launches.values()) == 0
    assert_parity(li, np.asarray(jli), rays, int(jrays))
    assert dropped == int(jdrop)
    if case != "sppm12_fold":
        assert dropped > 0
    ch = vcm_mega.mega_chunks(side * side, **part)
    assert ch.n_chunks == (2 if "two_chunks" in case else 1)
    assert (ch.c_pix * ch.n_chunks > side * side) == ("pad" in case)
