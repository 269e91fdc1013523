"""The packed path-vertex codecs of the PyTorch port (kernel K10's plain
versions, cudapathtracer_tpu_torch/utils/packing.py) against the JAX
package's utils/packing.py. Bit-equal: no tolerance. Inputs from numpy
with a seed: random unit vectors plus the axes, the octahedron's edges and
folds, signed zeros; beta over twelve decades with float16 overflow,
underflow and subnormals; flag fields past their clamps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.utils import packing as jpacking
from cudapathtracer_tpu_torch.utils import packing
from test_torch_common import _one_thread  # noqa: F401  (autouse)

N = 20000


def _unit_vectors(seed=0):
    gen = np.random.default_rng(seed)
    v = gen.normal(size=(N, 3))
    special = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        [0.6, 0.0, -0.8], [0.0, -0.6, -0.8], [0.5, 0.5, -0.70710678],
        [-0.5, 0.5, 0.70710678], [1e-30, 0.0, -1.0], [-0.0, 0.0, 1.0],
        [0.70710678, -0.70710678, 0.0], [1e-8, 1e-8, -1.0]])
    v[:len(special)] = special
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    # directions with one component exactly zero (axis-aligned walls)
    v[100:200, 2] = 0.0
    v[100:200] /= np.linalg.norm(v[100:200], axis=1, keepdims=True)
    return v.astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype.itemsize \
        == 4 else np.asarray(a).view(np.uint16)


def test_pack_unpack_oct_bit_equal():
    v = _unit_vectors()
    ju = np.asarray(jpacking.pack_oct(jnp.asarray(v)))
    tu = packing.pack_oct(torch.as_tensor(v))
    np.testing.assert_array_equal(tu.numpy().view(np.uint32), ju)
    jd = np.asarray(jpacking.unpack_oct(jnp.asarray(ju)))
    td = packing.unpack_oct(tu).numpy()
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    # and on arbitrary words: every bit pattern is a valid code
    words = np.random.default_rng(1).integers(0, 2 ** 32, N,
                                              dtype=np.uint64)
    words = words.astype(np.uint32)
    jd2 = np.asarray(jpacking.unpack_oct(jnp.asarray(words)))
    td2 = packing.unpack_oct(torch.as_tensor(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(_bits(td2), _bits(jd2))
    # the codec's own accuracy (what the BDPT vertices carry)
    assert np.abs(td - v).max() < 1e-4


def test_half3_bit_equal():
    gen = np.random.default_rng(2)
    c = gen.lognormal(0.0, 6.0, size=(N, 3)).astype(np.float32)
    c[:6, 0] = [0.0, -0.0, 65504.0, 65520.0, 1e-8, 6.1e-5]
    c[6:12, 1] = [-1.5, np.inf, 1e9, 2.0 ** -24, 2.0 ** -25, 3e-5]
    jh = np.asarray(jpacking.to_half3(jnp.asarray(c)))
    th = packing.to_half3(torch.as_tensor(c))
    assert th.dtype == torch.float16
    np.testing.assert_array_equal(th.numpy().view(np.uint16),
                                  jh.view(np.uint16))
    jf = np.asarray(jpacking.from_half3(jnp.asarray(jh)))
    tf = packing.from_half3(th).numpy()
    np.testing.assert_array_equal(_bits(tf), _bits(jf))


def test_flags_bit_equal():
    gen = np.random.default_rng(3)
    is_delta = gen.uniform(size=N) < 0.3
    backface = gen.uniform(size=N) < 0.5
    light_ind = gen.integers(-3, 1 << 21, N).astype(np.int32)
    mat_id = gen.integers(-5, 1500, N).astype(np.int32)
    jw = np.asarray(jpacking.pack_flags(jnp.asarray(is_delta),
                                        jnp.asarray(backface),
                                        jnp.asarray(light_ind),
                                        jnp.asarray(mat_id)))
    tw = packing.pack_flags(torch.as_tensor(is_delta),
                            torch.as_tensor(backface),
                            torch.as_tensor(light_ind),
                            torch.as_tensor(mat_id))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    ju = jpacking.unpack_flags(jnp.asarray(jw))
    tu = packing.unpack_flags(tw)
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the round trip keeps what fits
    ok = (light_ind >= -1) & (light_ind < (1 << 20) - 1) & (mat_id >= 0) \
        & (mat_id < 1024)
    np.testing.assert_array_equal(tu[2].numpy()[ok], light_ind[ok])
    np.testing.assert_array_equal(tu[3].numpy()[ok], mat_id[ok])


@pytest.mark.parametrize("seed", [4, 5])
def test_oct_roundtrip_is_stable(seed):
    """Decoding then re-encoding a code gives the same code (the walk
    encodes decoded directions only through normalize, but a codec that
    drifts would move every connection)."""
    v = _unit_vectors(seed)
    u = packing.pack_oct(torch.as_tensor(v))
    u2 = packing.pack_oct(packing.unpack_oct(u))
    assert (u2 == u).float().mean().item() > 0.999


# --- RGB9E5: the mega engines' per-path retirement --------------------------

def _rgb9e5_colours(seed=6):
    """Zeros, negatives, tiny and subnormal values, values above the 9e5
    maximum (65408) and infinity, values within 8 ulps of every power of
    two the shared exponent meets, values on the mantissa's rounding edges
    ((m + 1/2) 2^(e-9)) and their float neighbours, then lognormal colours
    over the codec's whole range; the channels permuted against each other
    so each edge is met as the largest channel and below it."""
    gen = np.random.default_rng(seed)
    edge = [np.array([0.0, -0.0, -1.0, -1e30, 1e-45, 1e-38, 1e-30, 1e-10,
                      3e-5, 65408.0, 65409.0, 65535.0, 1e5, 1e30, np.inf],
                     np.float32)]
    for k in range(-26, 18):
        b = np.float32(2.0 ** k).view(np.int32)
        edge.append((b + np.arange(-8, 9)).astype(np.int32).view(np.float32))
    half = (np.arange(0, 512, 7, dtype=np.float64) + 0.5)
    for e in range(-15, 17):
        mid = (half * 2.0 ** (e - 9)).astype(np.float32)
        edge += [mid, np.nextafter(mid, np.float32(0)),
                 np.nextafter(mid, np.float32(np.inf))]
    edge = np.concatenate(edge).astype(np.float32)
    k = edge.size
    c = np.empty((N, 3), np.float32)
    c[:k, 0] = edge
    c[:k, 1] = gen.permutation(edge) * gen.uniform(0, 1, k).astype(np.float32)
    c[:k, 2] = gen.permutation(edge)
    c[k:] = gen.lognormal(-2.0, 4.0, (N - k, 3))
    return c


def test_rgb9e5_bit_equal():
    """pack_rgb9e5, pack_rgb9e5_cols and unpack_rgb9e5 bit-equal to JAX,
    edge values included; the round trip keeps each channel within 2^-8
    of the largest (half a mantissa step, 2^-9 of it, where log2 does not
    round the exponent up just below a power of two)."""
    c = _rgb9e5_colours()
    ju = np.asarray(jpacking.pack_rgb9e5(jnp.asarray(c)))
    tu = packing.pack_rgb9e5(torch.as_tensor(c))
    np.testing.assert_array_equal(tu.numpy().view(np.uint32), ju)
    tcols = packing.pack_rgb9e5_cols(torch.as_tensor(c.T.copy()))
    np.testing.assert_array_equal(tcols.numpy().view(np.uint32), ju)
    jd = np.asarray(jpacking.unpack_rgb9e5(jnp.asarray(ju)))
    td = packing.unpack_rgb9e5(tu).numpy()
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    rd = packing.round_rgb9e5(torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(_bits(rd), _bits(jd))
    # every exponent the codec has is met
    assert len(np.unique(ju >> 27)) == 32
    inside = np.isfinite(c).all(1) & (c >= 0).all(1) & (c.max(1) < 65408) \
        & (c.max(1) > 2.0 ** -14)
    err = np.abs(td - c)[inside].max(1) / c[inside].max(1)
    assert err.max() <= 2.0 ** -8


def test_rgb9e5_on_arbitrary_words():
    """unpack_rgb9e5 bit-equal to JAX on every kind of 32-bit word."""
    words = np.random.default_rng(7).integers(0, 2 ** 32, N,
                                              dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:32] = np.arange(32, dtype=np.uint32) << 27
    jd = np.asarray(jpacking.unpack_rgb9e5(jnp.asarray(words)))
    td = packing.unpack_rgb9e5(torch.as_tensor(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(_bits(td), _bits(jd))
