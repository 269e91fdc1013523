"""K8's sort of the PyTorch port (ops/hashgrid.radix_sort_plain, the plain
twin of kernels.photon_sort, radix_sort.cu) and its key, on the CPU, on
seeded numpy inputs.

The twin runs the kernel's passes (8-bit digits; each key to its digit's
start from the histograms taken before the first pass, plus the keys of
its digit in the tiles of hashgrid.RADIX_TILE keys before its own, plus
its rank in its tile) and must give exactly the order of
torch.sort(stable=True) on the same uint32 values, and gather[order]:
random keys, keys >= 2^31, all-equal keys, a sentinel-heavy mix (~47%
invalid photons in one bucket, as at 1080p), one key, and sizes on and
off a multiple of the tile. key_bits bounds the passes by the table size. The
grid built from the twins (photon_rows + grid_keys, the radix twin,
grid_table) is the JAX package's build_grid bit for bit, salted and
unsalted, also with a table above 2^24 buckets (the uint32 key wraps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import hashgrid as jhashgrid
from cudapathtracer_tpu_torch.ops import hashgrid
from cudapathtracer_tpu_torch.utils.math import next_prime
from test_torch_common import _one_thread  # noqa: F401  (autouse)

SMIN = (-1.0, -1.0, -1.0)
TILE = hashgrid.RADIX_TILE


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    if kind == "random":
        return gen.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "high":          # every key >= 2^31 (negative as int32)
        return gen.integers(2 ** 31, 2 ** 32, n,
                            dtype=np.uint64).astype(np.uint32)
    if kind == "equal":
        return np.full(n, 0x9E3779B9, dtype=np.uint32)
    # sentinel-heavy: 5,821,068 of 12,441,600 photons invalid at 1080p
    sentinel = 24_883_207
    k = gen.integers(0, sentinel, n).astype(np.uint32)
    return np.where(gen.uniform(size=n) < 5_821_068 / 12_441_600,
                    np.uint32(sentinel), k)


def _as_int32(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(k.view(np.int32).copy())


@pytest.mark.parametrize("kind", ["random", "high", "equal", "sentinel"])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 517])
def test_radix_twin_equals_stable_sort(kind, n):
    k = _keys(kind, n, 40 + n)
    key = _as_int32(k)
    gather = torch.arange(n, dtype=torch.int32).flip(0) * 3
    order, got = hashgrid.radix_sort_plain(key, 32, gather)
    want = torch.sort(torch.from_numpy(k.astype(np.int64)),
                      stable=True).indices
    assert torch.equal(order, want)
    assert torch.equal(got, gather[want])


@pytest.mark.parametrize("table,salted", [(7, False), (2 ** 24 - 3, False),
                                          (24_883_207, False), (7, True),
                                          (24_883_207, True)])
def test_key_bits_bound_the_keys(table, salted):
    """Every key of a table fits in key_bits; the passes above them are
    the identity and the twin's order is the stable sort's with them
    left out."""
    bits = hashgrid.key_bits(table, salted)
    top = ((table << 8) + 255) & 0xFFFFFFFF if salted else table
    assert top < 2 ** bits or bits == 32
    assert bits == (32 if salted and table >= 2 ** 24 else
                    ((table << 8) + 255 if salted else table).bit_length())
    gen = np.random.default_rng(table % 97)
    h = gen.integers(0, table + 1, 3 * TILE + 5).astype(np.int64)
    h[::7] = table                                   # the sentinel
    key = hashgrid.sort_keys(torch.from_numpy(h),
                             hashgrid.photon_salt(2) if salted else None)
    assert int(key.max()) < 2 ** bits
    order, _ = hashgrid.radix_sort_plain(key.to(torch.int32), bits)
    assert torch.equal(order, torch.sort(key, stable=True).indices)


@pytest.mark.parametrize("salted,table", [
    (False, None), (True, None), (True, 3 * 2 ** 23 + 7),
    (False, 3 * 2 ** 23 + 7)])
def test_twin_grid_equals_jax_build_grid(salted, table):
    """photon_pack's twin (grid_keys), the radix twin and photon_table's
    twin (grid_table) against the JAX build_grid: ~5k photons, 53% valid,
    r = 0.07, sorted rows and (start, end) table bit-equal."""
    p = 2 * TILE + 901
    gen = np.random.default_rng(31)
    rows = gen.uniform(-1, 1, (p, 8)).astype(np.float32)
    valid = gen.uniform(size=p) < 0.53
    size = next_prime(table) if table else hashgrid.photon_table_size(p)
    salt = hashgrid.photon_salt(7) if salted else None
    r = float(np.float32(0.07))
    jg = jhashgrid.build_grid(jnp.asarray(rows), jnp.asarray(valid),
                              jnp.asarray(SMIN), r, size,
                              salt=None if salt is None else jnp.uint32(salt))
    t = torch.from_numpy(rows)
    h, key = hashgrid.grid_keys(t, torch.from_numpy(valid), SMIN, 2 * r,
                                size, salt)
    bits = hashgrid.key_bits(size, salted and hashgrid.REWEIGHT)
    order, h_sorted = hashgrid.radix_sort_plain(key.to(torch.int32), bits, h)
    assert torch.equal(h_sorted, h[order])
    srows, cell_se = hashgrid.grid_table(t, h, order, size)
    np.testing.assert_array_equal(srows.numpy().view(np.uint32),
                                  np.asarray(jg.rows).view(np.uint32))
    np.testing.assert_array_equal(cell_se.numpy(), np.asarray(jg.cell_se))
