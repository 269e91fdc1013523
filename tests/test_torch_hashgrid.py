"""The photon grid of the PyTorch port (ops/hashgrid.py: the plain
versions of K8, K9 and K10's photon row) against the JAX package on the
CPU, on seeded numpy inputs fed to both.

Tolerances: the half2 and photon-row codecs, the sorted rows and the
(start, end) table are integer or bit-copy results and must be bit-equal
(also with a table above 2^24 buckets, where the uint32 sort key wraps).
The merge query (fold_neighbors) in its four modes (one-brick at cap 8,
TPT_GRID_ONE_BRICK=0 at cap 8, cap 12, TPT_MERGE_REWEIGHT=0): each query's
sequence of in-range photons equal (an order-sensitive integer hash of
their ids and their count), the dropped counts equal, and a float fold
over every decoded field and the weight within 1e-6 relative (the same
float32 sums in the same order; XLA:CPU contracts the distance's sum of
squares into FMAs, so a photon at exactly r could in principle flip).
The port's mirrors of the JAX package's merge-estimator tests
(tests/test_vcm.py) hold the reweighted cap and the one-brick window
unbiased over salts, at their bounds (15%, 12%: ~3 standard errors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import hashgrid as jhashgrid
from cudapathtracer_tpu.utils import packing as jpacking
from cudapathtracer_tpu_torch.ops import hashgrid
from cudapathtracer_tpu_torch.utils import packing
from cudapathtracer_tpu_torch.utils.math import next_prime
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SMIN = (-1.0, -1.0, -1.0)


def _u32(a):
    return np.asarray(a).view(np.uint32)


def test_half2_bit_equal():
    gen = np.random.default_rng(21)
    a = gen.lognormal(0.0, 8.0, 5000).astype(np.float32)
    a *= gen.choice([-1.0, 1.0], 5000).astype(np.float32)
    b = gen.normal(size=5000).astype(np.float32)
    a[:4] = [0.0, -0.0, 65504.0, 1e-8]     # zero, -0, the f16 max, underflow
    want = _u32(jpacking.pack_half2(jnp.asarray(a), jnp.asarray(b)))
    got = packing.pack_half2(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    ja, jb = jpacking.unpack_half2(jnp.asarray(want))
    ta, tb = packing.unpack_half2(got)
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), _u32(ja))
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), _u32(jb))


def _photons(p, seed):
    gen = np.random.default_rng(seed)
    wi = gen.normal(size=(p, 3))
    return dict(
        pos=gen.uniform(-1, 1, (p, 3)).astype(np.float32),
        wi=(wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(
            np.float32),
        beta=gen.lognormal(0.0, 2.0, (p, 3)).astype(np.float32),
        d_vcm=gen.uniform(0, 9, p).astype(np.float32),
        d_vm=gen.uniform(0, 9, p).astype(np.float32))


def _rows(ph):
    keys = ("pos", "wi", "beta", "d_vcm", "d_vm")
    j = jhashgrid.pack_photons(*(jnp.asarray(ph[k]) for k in keys))
    t = hashgrid.pack_photons(*(torch.as_tensor(ph[k]) for k in keys))
    return j, t


def test_photon_rows_bit_equal():
    j, t = _rows(_photons(3000, 22))
    assert t.shape == (3000, hashgrid.PHOTON_ROW)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), _u32(j))
    for a, b in zip(hashgrid.photon_fields(t), jhashgrid.photon_fields(j)):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), _u32(b))


@pytest.mark.parametrize("salted,table", [
    (False, None), (True, None), (True, 3 * 2 ** 23 + 7)])
def test_build_grid_bit_equal(salted, table):
    """~4k photons, 80% valid, r = 0.07; the last case with a table above
    2^24 buckets, where the uint32 key wraps: buckets h and h + 2^24 then
    interleave in the sorted order."""
    p = 4001
    j, t = _rows(_photons(p, 23))
    valid = np.random.default_rng(24).uniform(size=p) < 0.8
    size = next_prime(table) if table else hashgrid.photon_table_size(p)
    salt = hashgrid.photon_salt(5) if salted else None
    r = float(np.float32(0.07))
    jg = jhashgrid.build_grid(j, jnp.asarray(valid), jnp.asarray(SMIN), r,
                              size, salt=None if salt is None
                              else jnp.uint32(salt))
    tg = hashgrid.build_grid(t, torch.as_tensor(valid), SMIN, r, size,
                             salt=salt)
    np.testing.assert_array_equal(tg.rows.numpy().view(np.uint32),
                                  _u32(jg.rows))
    np.testing.assert_array_equal(tg.cell_se.numpy(), np.asarray(jg.cell_se))
    assert tg.rows.shape[0] == p + (-p) % 8 + 8
    assert tg.cell_se[size, 1] - tg.cell_se[size, 0] == int((~valid).sum())
    if table:
        # the key wrapped: some photon's bucket sorts below its predecessor's
        h, key = hashgrid.grid_keys(t, torch.as_tensor(valid), SMIN, 2 * r,
                                    size, salt)
        order = torch.sort(key, stable=True).indices
        assert bool((torch.diff(h[order]) < 0).any())


MODES = {"one_brick": ({}, 8), "two_brick": ({"TPT_GRID_ONE_BRICK": "0"}, 8),
         "cap12": ({}, 12), "no_reweight": ({}, 8)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fold_neighbors_matches_jax(monkeypatch, mode):
    env, cap = MODES[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if mode == "no_reweight":
        monkeypatch.setattr(jhashgrid, "_REWEIGHT", False)
        monkeypatch.setattr(hashgrid, "REWEIGHT", False)
    assert hashgrid.one_brick_active(cap) == (mode == "one_brick")
    assert jhashgrid.one_brick_active(cap) == (mode == "one_brick")
    p = 3001
    ph = _photons(p, 25)
    ph["d_vcm"] = np.arange(p, dtype=np.float32)   # the photon's id
    j, t = _rows(ph)
    gen = np.random.default_rng(26)
    valid = gen.uniform(size=p) < 0.9
    r = float(np.float32(0.12))
    salt = hashgrid.photon_salt(3)
    jg = jhashgrid.build_grid(j, jnp.asarray(valid), jnp.asarray(SMIN), r,
                              hashgrid.photon_table_size(p),
                              salt=jnp.uint32(salt))
    tg = hashgrid.build_grid(t, torch.as_tensor(valid), SMIN, r,
                             hashgrid.photon_table_size(p), salt=salt)
    q = gen.uniform(-0.9, 0.9, (200, 3)).astype(np.float32)
    active = gen.uniform(size=200) < 0.9

    def jfold(c, row, in_range, w):
        acc, hsh, cnt = c
        _, wi, beta, d_vcm, d_vm = jhashgrid.photon_fields(row)
        add = (beta * (wi + d_vcm[:, None] + d_vm[:, None] + row[:, 0:3])
               * w[:, None])
        pid = d_vcm.astype(jnp.int32)
        return (acc + jnp.where(in_range[:, None], add, 0.0),
                jnp.where(in_range, hsh * 31 + pid + 1, hsh),
                cnt + in_range.astype(jnp.int32))

    def tfold(c, row, in_range, w):
        acc, hsh, cnt = c
        _, wi, beta, d_vcm, d_vm = hashgrid.photon_fields(row)
        add = (beta * (wi + d_vcm[:, None] + d_vm[:, None] + row[:, 0:3])
               * w[:, None])
        pid = d_vcm.to(torch.int64)
        return (acc + torch.where(in_range[:, None], add, 0.0),
                torch.where(in_range, (hsh * 31 + pid + 1) & 0xFFFFFFFF, hsh),
                cnt + in_range.to(torch.int64))

    n = q.shape[0]
    (jacc, jh, jc), jdrop = jhashgrid.fold_neighbors(
        jg, jnp.asarray(q), r, cap, jfold,
        (jnp.zeros((n, 3)), jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32)),
        active=jnp.asarray(active), count_dropped=True)
    (tacc, th, tc), tdrop = hashgrid.fold_neighbors(
        tg, torch.as_tensor(q), r, cap, tfold,
        (torch.zeros((n, 3)), torch.zeros(n, dtype=torch.int64),
         torch.zeros(n, dtype=torch.int64)),
        active=torch.as_tensor(active), count_dropped=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(th.numpy(),
                                  np.asarray(jh).view(np.uint32))
    assert tdrop == int(jdrop)
    assert tc.sum() > n
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6,
                               atol=1e-6)


def test_neighbor_completeness():
    """The port's query returns exactly the photons within r of each point
    when the cap holds every cell (the JAX package's
    test_hashgrid_neighbor_completeness, through fold_neighbors)."""
    gen = np.random.RandomState(3)
    p = 512
    pos = gen.uniform(-1, 1, (p, 3)).astype(np.float32)
    rows = hashgrid.pack_photons(torch.as_tensor(pos), torch.zeros((p, 3)),
                                 torch.ones((p, 3)), torch.zeros(p),
                                 torch.zeros(p))
    r = 0.15
    grid = hashgrid.build_grid(rows, torch.ones(p, dtype=torch.bool), SMIN,
                               r, hashgrid.photon_table_size(p))
    q = gen.uniform(-0.8, 0.8, (64, 3)).astype(np.float32)

    def count(c, row, in_range, w):
        return c + in_range.to(torch.int64)

    got, dropped = hashgrid.fold_neighbors(
        grid, torch.as_tensor(q), r, 64, count,
        torch.zeros(64, dtype=torch.int64), count_dropped=True)
    d2 = ((q[:, None, :] - pos[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), (d2 <= r * r).sum(1))
    assert dropped == 0


def _beta_fold(c, row, in_range, w):
    _, _, b, _, _ = hashgrid.photon_fields(row)
    return c + torch.where(in_range[:, None], b * w[:, None], 0.0)


def test_merge_cap_reweight_unbiased():
    """The port's mirror of the JAX package's
    test_merge_cap_reweight_unbiased: 64 photons in one cell; the capped
    fold (cap 8) reweighted by count/kept averages over 48 salts to the
    uncapped sum (15%: ~3 standard errors)."""
    gen = np.random.RandomState(7)
    p = 64
    beta = torch.as_tensor(gen.uniform(0.1, 2.0, (p, 3)), dtype=torch.float32)
    rows = hashgrid.pack_photons(torch.zeros((p, 3)), torch.zeros((p, 3)),
                                 beta, torch.zeros(p), torch.zeros(p))
    r, table = 0.1, hashgrid.photon_table_size(p)
    q = torch.zeros((4, 3))
    valid = torch.ones(p, dtype=torch.bool)
    full = hashgrid.fold_neighbors(
        hashgrid.build_grid(rows, valid, SMIN, r, table), q, r, p,
        _beta_fold, torch.zeros((4, 3)))
    want = beta.sum(0).numpy()
    np.testing.assert_allclose(full[0].numpy(), want, rtol=2e-3)
    acc = torch.zeros((4, 3))
    for s in range(48):
        g = hashgrid.build_grid(rows, valid, SMIN, r, table,
                                salt=(s * 2654435761 + 17) % 2 ** 32)
        acc += hashgrid.fold_neighbors(g, q, r, 8, _beta_fold,
                                       torch.zeros((4, 3)))
    mean = (acc / 48)[0].numpy()
    np.testing.assert_allclose(mean, want, rtol=0.15)
    assert mean.sum() > 0.6 * want.sum()


def test_merge_cap_drop_counter_fires():
    """The mirror of the JAX test of the same name: a 64-photon cluster at
    cap 8 folds 8 photons per query and drops 56; no drop when the cap
    holds the cell."""
    p = 64
    rows = hashgrid.pack_photons(torch.zeros((p, 3)), torch.zeros((p, 3)),
                                 torch.ones((p, 3)), torch.zeros(p),
                                 torch.zeros(p))
    r = 0.1
    grid = hashgrid.build_grid(rows, torch.ones(p, dtype=torch.bool), SMIN,
                               r, hashgrid.photon_table_size(p))
    q = torch.zeros((4, 3))
    def fold(c, row, in_range, w):
        return c + int(in_range.sum())

    for cap, folded_want, dropped_want in ((8, 4 * 8, 4 * (p - 8)),
                                           (p, 4 * p, 0)):
        folded, dropped = hashgrid.fold_neighbors(grid, q, r, cap, fold, 0,
                                                  count_dropped=True)
        assert (folded, dropped) == (folded_want, dropped_want)


def test_one_brick_window_unbiased(monkeypatch):
    """The mirror of the JAX package's
    test_one_brick_window_unbiased_and_consistent: with the one-brick
    window, (a) the mean over 64 salts converges to the unbounded sum
    (12%); (b) neighbor_slots' weighted candidate sum per query equals the
    fold's (rtol 1e-5, atol 1e-6), its dropped count the fold's; (c) its
    M is the 64 single-brick slots; (d) the window's truncation counts as
    dropped."""
    gen = np.random.RandomState(13)
    p = 640
    pos = np.repeat(gen.uniform(-1, 1, (p // 4, 3)).astype(np.float32), 4,
                    axis=0)               # clustered: cells hold 4+ photons
    beta = torch.as_tensor(gen.uniform(0.1, 2.0, (p, 3)), dtype=torch.float32)
    rows = hashgrid.pack_photons(torch.as_tensor(pos), torch.zeros((p, 3)),
                                 beta, torch.zeros(p), torch.zeros(p))
    r, table = 0.12, hashgrid.photon_table_size(p)
    q = torch.as_tensor(gen.uniform(-0.9, 0.9, (48, 3)).astype(np.float32))
    valid = torch.ones(p, dtype=torch.bool)
    full = hashgrid.fold_neighbors(
        hashgrid.build_grid(rows, valid, SMIN, r, table), q, r, p,
        _beta_fold, torch.zeros((48, 3))).numpy()
    monkeypatch.setenv("TPT_GRID_ONE_BRICK", "1")
    assert hashgrid.one_brick_active(8)
    acc = torch.zeros((48, 3))
    for s in range(64):
        g = hashgrid.build_grid(rows, valid, SMIN, r, table,
                                salt=(s * 2654435761 + 101) % 2 ** 32)
        out, dropped = hashgrid.fold_neighbors(g, q, r, 8, _beta_fold,
                                               torch.zeros((48, 3)),
                                               count_dropped=True)
        acc += out
        if s == 0:
            rows_s, ok_s, wgt_s, drop_s = hashgrid.neighbor_slots(g, q, r, 8)
            assert rows_s.shape[0] == 64                            # (c)
            _, _, b_s, _, _ = hashgrid.photon_fields(rows_s.reshape(-1, 8))
            add = torch.where(ok_s.reshape(-1)[:, None],
                              b_s * wgt_s.reshape(-1)[:, None], 0.0)
            slot_sum = add.reshape(rows_s.shape[0], 48, 3).sum(0)
            np.testing.assert_allclose(slot_sum.numpy(), out.numpy(),
                                       rtol=1e-5, atol=1e-6)        # (b)
            assert drop_s == dropped
            assert dropped > 0                                      # (d)
    mean = (acc / 64).numpy()
    nz = full.sum(1) > 1e-3
    np.testing.assert_allclose(mean[nz], full[nz], rtol=0.12, atol=0.02)


# --- K9's materialised forms -------------------------------------------------

def _slot_grids(seed=27):
    """A clustered seeded grid (cells hold up to ~12 photons, so caps 1-8
    truncate and the one-brick window cuts) in both packages, and 300
    queries, 90% active."""
    p = 2403
    ph = _photons(p, seed)
    ph["pos"] = np.repeat(ph["pos"][: p // 3], 3, axis=0)[:p]
    ph["pos"] += np.random.default_rng(seed).normal(
        0, 0.01, ph["pos"].shape).astype(np.float32)
    j, t = _rows(ph)
    gen = np.random.default_rng(seed + 1)
    valid = gen.uniform(size=p) < 0.9
    r = float(np.float32(0.09))
    salt = hashgrid.photon_salt(4)
    jg = jhashgrid.build_grid(j, jnp.asarray(valid), jnp.asarray(SMIN), r,
                              hashgrid.photon_table_size(p),
                              salt=jnp.uint32(salt))
    tg = hashgrid.build_grid(t, torch.as_tensor(valid), SMIN, r,
                             hashgrid.photon_table_size(p), salt=salt)
    q = gen.uniform(-0.9, 0.9, (300, 3)).astype(np.float32)
    q[:100] = ph["pos"][gen.integers(0, p, 100)]   # queries on photons
    active = gen.uniform(size=300) < 0.9
    return jg, tg, q, active, r


def _assert_slots_equal(got, want):
    rows, ok, wgt = got[:3]
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  _u32(want[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(wgt.numpy().view(np.uint32),
                                  _u32(want[2]))
    assert got[3] == int(want[3])


@pytest.mark.parametrize("one_brick", [True, False])
@pytest.mark.parametrize("cap", [1, 4, 8])
def test_neighbor_slots_bit_equal(monkeypatch, cap, one_brick):
    """neighbor_slots: rows, ok, wgt bit-equal and dropped equal to JAX in
    both modes (M = 64 slots one-brick, 8 x cap standard)."""
    monkeypatch.setenv("TPT_GRID_ONE_BRICK", "1" if one_brick else "0")
    assert hashgrid.one_brick_active(cap) == one_brick
    jg, tg, q, active, r = _slot_grids()
    want = jhashgrid.neighbor_slots(jg, jnp.asarray(q), r, cap,
                                    active=jnp.asarray(active))
    got = hashgrid.neighbor_slots(tg, torch.as_tensor(q), r, cap,
                                  active=torch.as_tensor(active))
    assert got[0].shape == (64 if one_brick else 8 * cap, 300, 8)
    _assert_slots_equal(got, want)
    assert got[1].sum() > 100 and got[3] > 0


@pytest.mark.parametrize("one_brick,cap,cap_q", [
    (True, 8, 5), (True, 8, 40), (False, 4, 3), (False, 8, 70)])
def test_neighbor_slots_compact_bit_equal(monkeypatch, one_brick, cap,
                                          cap_q):
    monkeypatch.setenv("TPT_GRID_ONE_BRICK", "1" if one_brick else "0")
    jg, tg, q, active, r = _slot_grids()
    want = jhashgrid.neighbor_slots_compact(jg, jnp.asarray(q), r, cap,
                                            cap_q, active=jnp.asarray(active))
    got = hashgrid.neighbor_slots_compact(tg, torch.as_tensor(q), r, cap,
                                          cap_q,
                                          active=torch.as_tensor(active))
    assert got[0].shape == (cap_q, 300, 8)
    _assert_slots_equal(got, want)
    assert got[1].sum() > 50


@pytest.mark.parametrize("cap", [4, 12])
def test_gather_neighbors_bit_equal(cap):
    jg, tg, q, active, r = _slot_grids()
    want = list(jhashgrid.gather_neighbors(jg, jnp.asarray(q), r, cap,
                                           active=jnp.asarray(active)))
    got = list(hashgrid.gather_neighbors(tg, torch.as_tensor(q), r, cap,
                                         active=torch.as_tensor(active)))
    assert len(got) == len(want) == 8 * cap
    for (trow, tok), (jrow, jok) in zip(got, want):
        np.testing.assert_array_equal(trow.numpy().view(np.uint32),
                                      _u32(jrow))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert sum(int(ok.sum()) for _, ok in got) > 100
