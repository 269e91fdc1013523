"""The port's plain key-table builders (the tables its kernels' prologues
fold on the card, kernels/csrc/keys.cuh) against the JAX package's fold_in
chains.

Tolerance: none. Every pair must be the bits of jax.random.fold_in's key
chain, because every draw of the hosts is keyed by these pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudapathtracer_tpu.utils import rng as jrng
from cudapathtracer_tpu_torch.models import bdpt, paths, unidirectional, vcm
from cudapathtracer_tpu_torch.utils import rng as trng
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SEEDS = (0, 103033, 2 ** 31 - 1)
SAMPLES = (0, 5)
LIT_ROWS = 132      # every event of a classic path (uni_mega.cu kLitCap)
NAIVE_DEPTH = 8
DEPTH = 8           # the walks' and the eye pass's depths


@jax.jit
def _fold_many(key, data):
    return jax.vmap(jax.random.fold_in, (None, 0))(key, data)


@jax.jit
def _pairs_many(keys, data):
    return jax.random.key_data(jax.vmap(_fold_many, (0, None))(keys, data))


def _fold_rows(key, data):
    """fold_in(key, d) for every d of data: [len(data)] keys."""
    return _fold_many(key, jnp.asarray(list(data), jnp.uint32))


def _draw_pairs(keys, draws):
    """[R] keys -> [R, len(draws), 2] uint32 pairs draw_key(key_r, d)."""
    return np.asarray(_pairs_many(
        keys, jnp.asarray(list(draws), jnp.uint32))).astype(np.uint32)


def _bits(t):
    return t.numpy().view(np.uint32)


def _keys(seed, sample):
    jk = jrng.sample_key(jrng.base_key(seed), sample)
    tk = trng.sample_key(trng.base_key(seed), sample)
    return jk, tk


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("schedule", ("classic", "naive", "mega"))
def test_uni_key_table(seed, sample, schedule):
    """K5's rows for two consecutive samples: classic and naive
    draw_key(bounce_key(skey, lit), d), lit 0..131 (classic) or 0..7
    (naive), d 0..8; mega draw_key(skey, d), one row."""
    rows = {"classic": LIT_ROWS, "naive": NAIVE_DEPTH, "mega": 0}[schedule]
    got = _bits(unidirectional.sample_key_table(trng.base_key(seed), sample,
                                                2, rows))
    want = []
    for s in (sample, sample + 1):
        skey = jrng.sample_key(jrng.base_key(seed), s)
        keys = _fold_rows(skey, range(rows)) if rows else skey[None]
        want.append(_draw_pairs(keys, range(9)))
    np.testing.assert_array_equal(got, np.stack(want).reshape(-1, 2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("walk", (1, 2))
def test_walk_table(seed, sample, walk):
    """K12's table under key_l (walk 1) or key_e (walk 2): draws 0-3 of
    bounce_key(key, b) for b < max_depth, then draws 100..104 of key."""
    jk, tk = _keys(seed, sample)
    jw, tw = jax.random.fold_in(jk, walk), trng.fold_in(tk, walk)
    got = _bits(paths.walk_key_table(tw, DEPTH))
    bounce = _draw_pairs(_fold_rows(jw, range(DEPTH)), range(4))
    end = _draw_pairs(jw[None], paths.LIGHT_DRAWS)
    np.testing.assert_array_equal(
        got, np.concatenate([bounce.reshape(-1, 2), end.reshape(-1, 2)]))
    # the keyed walk's host table is the same table
    ktab, ketab = (trng.draw_key_table(tw, range(DEPTH), range(4)),
                   trng.draw_key_table(tw, None, paths.LIGHT_DRAWS)[0])
    np.testing.assert_array_equal(
        got, np.concatenate([ktab.view(-1, 2).numpy().view(np.uint32),
                             ketab.view(-1, 2).numpy().view(np.uint32)]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
def test_eye_table(seed, sample):
    """The classic VCM eye walk's rows under key_e: per depth the BSDF
    pairs of bounce_key(key_e, depth), then NEE's of fold_in(bounce key,
    7)."""
    jk, tk = _keys(seed, sample)
    je, te = jax.random.fold_in(jk, 2), trng.fold_in(tk, 2)
    got = _bits(vcm.eye_key_table(te, DEPTH)).reshape(DEPTH, 7, 2)
    bkeys = _fold_rows(je, range(DEPTH))
    np.testing.assert_array_equal(got[:, :4], _draw_pairs(bkeys, range(4)))
    nkeys = jax.vmap(jax.random.fold_in, (0, None))(bkeys, 7)
    np.testing.assert_array_equal(got[:, 4:], _draw_pairs(nkeys, range(3)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
def test_nee_table(seed, sample):
    """K13's s=1 rows under key_c: draw_key(fold_in(key_c, t), 0..2) for
    t = 0..eye_depth."""
    jk, tk = _keys(seed, sample)
    jc, tc = jax.random.fold_in(jk, 3), trng.fold_in(tk, 3)
    got = _bits(bdpt.nee_key_table(tc, DEPTH))
    want = _draw_pairs(_fold_rows(jc, range(DEPTH + 1)), range(3))
    np.testing.assert_array_equal(got, want.reshape(-1, 2))


def test_fold_table_levels():
    """fold_table's levels and order on host ints: sample, row, mid,
    draw."""
    key = trng.base_key(7)
    t = _bits(trng.fold_table(key, 2, rows=3, samples=2, s0=4, mid=9,
                              draw0=50))
    assert t.shape == (12, 2)
    for s in range(2):
        for r in range(3):
            k = trng.fold_in(trng.fold_in(trng.fold_in(key, 4 + s), r), 9)
            for j in range(2):
                assert tuple(int(w) for w in t[(s * 3 + r) * 2 + j]) == \
                    trng.fold_in(k, 50 + j)
