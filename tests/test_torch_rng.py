"""Threefry streams of the PyTorch port against the JAX package.

Tolerance: none. Keys and draws must be bit-equal, because every
image-parity test of the port rests on the same random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.utils import rng as trng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SEEDS = (0, 1, 103033, 2 ** 31 - 1)
MAX_ID = (1079 << 14) + 1919   # 1080p's last pixel id


def _ids():
    gen = np.random.default_rng(5)
    ids = gen.integers(0, MAX_ID + 1, 4000).astype(np.int32)
    return np.concatenate([ids, np.array([0, 1, MAX_ID], np.int32)])


def _key_data(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_bit_equal(seed):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    assert _key_data(jk) == tk
    assert _key_data(jrng.base_key(seed, stream=3)) == trng.base_key(seed, 3)
    for s in (0, 1, 7, 1000):
        js, ts = jrng.sample_key(jk, s), trng.sample_key(tk, s)
        assert _key_data(js) == ts
        assert (_key_data(jax.random.fold_in(js, 2 ** 20))
                == trng.fold_in(ts, 2 ** 20))
        for b in (0, 3, 131):
            jb, tb = jrng.bounce_key(js, b), trng.bounce_key(ts, b)
            assert _key_data(jb) == tb
            assert (tuple(int(x) for x in jrng._draw_key(jb, 8))
                    == trng.draw_key(tb, 8))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_id_bit_equal(seed):
    ids = _ids()
    for s, b, draw in ((0, 0, 0), (3, 5, 4), (11, 40, 8)):
        jk = jrng.bounce_key(jrng.sample_key(jrng.base_key(seed), s), b)
        tk = trng.bounce_key(trng.sample_key(trng.base_key(seed), s), b)
        want = np.asarray(jrng.uniform_id(jk, draw, jnp.asarray(ids)))
        got = trng.uniform_id(tk, draw, torch.as_tensor(ids)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert got.min() >= 0.0 and got.max() < 1.0
        w0, w1 = jrng.uniform2_id(jk, draw + 1, jnp.asarray(ids))
        g0, g1 = trng.uniform2_id(tk, draw + 1, torch.as_tensor(ids))
        np.testing.assert_array_equal(g0.numpy().view(np.uint32),
                                      np.asarray(w0).view(np.uint32))
        np.testing.assert_array_equal(g1.numpy().view(np.uint32),
                                      np.asarray(w1).view(np.uint32))


def test_pixel_ids_and_uniform_any():
    px = np.array([0, 5, 1919], np.int32)
    py = np.array([0, 7, 1079], np.int32)
    want = np.asarray(jrng.pixel_ids(jnp.asarray(px), jnp.asarray(py)))
    got = trng.pixel_ids(torch.as_tensor(px), torch.as_tensor(py))
    np.testing.assert_array_equal(got.numpy(), want)
    key = trng.base_key()
    np.testing.assert_array_equal(
        trng.uniform_any(key, 2, 3, got).numpy(),
        trng.uniform_id(key, 2, got).numpy())
    with pytest.raises(NotImplementedError):
        trng.uniform_any(key, 2, 3)   # positional streams are not ported
