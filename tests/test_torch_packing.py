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
