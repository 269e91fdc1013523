"""Photon hash grid: sort-based build (K8) and the bounded 8-cell merge
query (K9), with the 32-byte photon row (K10's photon part).

Counterpart of cudapathtracer_tpu/ops/hashgrid.py. Photons are hashed by
their cell of size 2r (the prime-XOR hash P1, P2, P3), sorted by a salted
key (the bucket times 256 plus an 8-bit multiplicative-hash tiebreak, so
each bucket's order is random per sample) and indexed by a fused
[T+1, 2] (start, end) table made with scatter-min/max. A query visits the
8 cells of size 2r around its point (the 2x2x2 block whose corner is
nearest), at most `max_per_cell` photons of each, tests the exact
distance, and weighs each kept photon by count/kept.

The functions here are the plain versions, on any device: the CPU path
and the oracle. On the card `build_grid_kernel` builds the same grid from
K12's packed light buffers with three kernels (kernels.photon_pack, the
stable radix sort kernels.photon_sort, whose plain twin is radix_sort_plain,
and kernels.photon_table), and the merge query is device code of the VCM
eye kernel (kernels/csrc/hashgrid.cuh). A tile-sharded VCM sample builds
its grid from the photon rows its tile axis gathered
(`build_grid_rows_kernel`: K8's rows mode, kernels.photon_bucket, in place
of photon_pack; plain version build_grid on the same rows). The
estimator is fixed here: count/kept reweighting and the one-brick window,
the program's defaults (the benchmark refuses to run where the program's
switches for them are set).

Integer parity: the cell hash wraps in int32 and the sort key in uint32;
here both are computed in int64 masked to 32 bits. The key wraps for
table sizes above 2^24 (buckets h and h + 2^24 then share their key's high
bits and interleave in the sort), as in the JAX package; the (start, end)
window of a bucket then holds the other bucket's photons too, and the
exact distance test drops them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.tpt.utils import packing
from reference.tpt.utils.math import dot, next_prime, true_div

P1, P2, P3 = 73856093, 19349663, 83492791
PHOTON_ROW = 8     # pos(0:3) f32, wi oct(3), beta half2 r|g (4), b|0 (5),
#                    d_vcm(6), d_vm(7): 32 bytes
_M32 = 0xFFFFFFFF
SALT_MUL = 0x9E3779B9        # the per-sample salt: s * SALT_MUL + 1
_KEY_MUL1, _KEY_MUL2 = 2654435761, 2246822519

def one_brick_active(max_per_cell: int) -> bool:
    """The one-brick window: keep only the photons of the 8-photon brick
    that holds the cell's start, kept = min(count, cap, 8 - start % 8).
    Always on in the reference where the cap is 1..8."""
    return 1 <= max_per_cell <= 8


def _window_weight(count, kept):
    """count/kept reweighting of the capped merge (an unbiased subsample
    of the cell)."""
    return (count.to(torch.float32)
            / torch.clamp(kept, min=1).to(torch.float32))


class PhotonGrid(NamedTuple):
    rows: torch.Tensor       # [P8, 8] f32 sorted photon rows, P8 = P padded
    #                          to a multiple of 8 plus 8 zero rows
    cell_se: torch.Tensor    # [T+1, 2] i32 (start, end); bucket T holds
    #                          the invalid photons
    scene_min: tuple         # 3 float32 values
    cell_size: float         # 2 * merge radius, float32
    table_size: int


def photon_table_size(max_photons: int) -> int:
    """next_prime(2 * max_photons)."""
    return next_prime(2 * max_photons)


def photon_salt(sample_idx: int) -> int:
    """The sample's salt of the sort key, a uint32."""
    return (int(sample_idx) * SALT_MUL + 1) & _M32


def pack_photons(pos, wi, beta, d_vcm, d_vm):
    """Packed photon rows [P, 8] f32 from [P, ...] components; words 3-5
    carry uint32 bits (the oct direction and two half2 words)."""
    f32 = lambda u: u.contiguous().view(torch.float32)
    wi_oct = f32(packing.pack_oct(wi))
    b_rg = f32(packing.pack_half2(beta[:, 0], beta[:, 1]))
    b_b = f32(packing.pack_half2(beta[:, 2], torch.zeros_like(beta[:, 2])))
    return torch.cat([pos, wi_oct[:, None], b_rg[:, None], b_b[:, None],
                      d_vcm[:, None], d_vm[:, None]], dim=1)


def photon_fields(row):
    """Rows [N, 8] -> (pos [N,3], wi [N,3], beta [N,3], d_vcm [N],
    d_vm [N])."""
    bits = lambda c: row[:, c].contiguous().view(torch.int32)
    wi = packing.unpack_oct(bits(3))
    br, bg = packing.unpack_half2(bits(4))
    bb, _ = packing.unpack_half2(bits(5))
    return row[:, 0:3], wi, torch.stack([br, bg, bb], dim=-1), row[:, 6], \
        row[:, 7]


def photon_rows(lbufs):
    """The photon rows of light buffers [L, N] (row-major over depth then
    lane) and their validity (valid and not delta), as the JAX VCM packs
    them: the direction is the DECODED wo packed again."""
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    rows = pack_photons(flat(lbufs.pt), flat(lbufs.wo), flat(lbufs.beta),
                        flat(lbufs.d_vcm), flat(lbufs.d_vm))
    return rows, flat(lbufs.valid & ~lbufs.is_delta)


def _cell_coord(pos, scene_min, cell_size):
    return true_div(pos - pos.new_tensor(scene_min), cell_size)


def _hash_cells(cell, table_size: int):
    """int32 cells [..., 3] -> buckets [...] int64: the int32-wrapping
    prime-XOR hash as uint32, mod table_size."""
    c = cell.to(torch.int64)
    h = (c[..., 0] * P1) ^ (c[..., 1] * P2) ^ (c[..., 2] * P3)
    return (h & _M32) % table_size


def _mul32(a, b: int):
    """(a * b) mod 2^32 for int64 tensors a in [0, 2^32) and b < 2^32,
    with no intermediate above 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sort_keys(h, salt):
    """The sort key of each photon (int64 holding uint32): the bucket with
    the salted tiebreak, or the bucket alone without a salt."""
    if salt is None:
        return h
    idx = torch.arange(h.shape[0], dtype=torch.int64, device=h.device)
    r = _mul32(_mul32(idx, _KEY_MUL1) ^ (int(salt) & _M32), _KEY_MUL2)
    return ((h << 8) + (r >> 24)) & _M32


def grid_keys(rows, valid, scene_min, cell_size: float, table_size: int,
              salt=None):
    """Plain version of photon_pack's bucket and key: each photon's bucket
    [P] int64 (table_size unless valid) and its sort key (sort_keys)."""
    cell = torch.floor(_cell_coord(rows[:, 0:3], scene_min, cell_size))
    h = _hash_cells(cell.to(torch.int32), table_size)
    h = torch.where(valid, h, table_size)
    return h, sort_keys(h, salt)


def grid_table(rows, h, order, table_size: int):
    """Plain version of photon_table: the rows in sorted order, padded by
    (-P) % 8 + 8 zero rows, and the (start, end) table [T+1, 2] int32 made
    by scatter-min/max of the sorted slots into their buckets."""
    p = rows.shape[0]
    h_sorted = h[order]
    pad = (-p) % 8 + 8
    rows_sorted = torch.cat([rows[order],
                             rows.new_zeros((pad, rows.shape[1]))])
    idx = torch.arange(p, dtype=torch.int32, device=rows.device)
    start = torch.full((table_size + 1,), p, dtype=torch.int32,
                       device=rows.device)
    end = torch.zeros((table_size + 1,), dtype=torch.int32,
                      device=rows.device)
    start.scatter_reduce_(0, h_sorted, idx, "amin")
    end.scatter_reduce_(0, h_sorted, idx + 1, "amax")
    return rows_sorted, torch.stack([start, end], dim=-1)


RADIX_BITS = 8      # kernels/csrc/radix_sort.cu kBits
RADIX_TILE = 3072   # its kTile: keys a block


def key_bits(table_size: int, salted: bool) -> int:
    """The low bits a sort key can have nonzero: the bucket is at most
    table_size (the sentinel), and a salted key is bucket * 256 plus an
    8-bit tiebreak, wrapping at 32 bits."""
    top = (table_size << 8) + 255 if salted else table_size
    return min(32, top.bit_length())


def radix_sort_plain(key, bits: int, gather=None):
    """Plain twin of kernels.photon_sort: the digit histograms of every
    pass from the input keys, then the same LSD passes of 8-bit digits
    over the low `bits` of key [P] (int32 or int64 holding uint32 values):
    a key goes to its digit's start (the histogram's exclusive prefix over
    the digits), plus the keys of its digit in the tiles of RADIX_TILE keys
    before its own (the prefix the kernel's look-back sums), plus its rank
    among its tile's keys of its digit in input order. -> (order [P]
    int64, gather[order] or None): the stable order, as
    torch.sort(stable=True) gives it."""
    p, dev = key.shape[0], key.device
    k = key.to(torch.int64) & _M32
    v = torch.arange(p, dtype=torch.int64, device=dev)
    tiles = -(-p // RADIX_TILE)
    tile = torch.arange(p, dtype=torch.int64, device=dev) // RADIX_TILE
    ndig = 1 << RADIX_BITS
    shifts = range(0, bits, RADIX_BITS)
    hist = [torch.bincount((k >> s) & (ndig - 1), minlength=ndig)
            for s in shifts]
    for shift, h in zip(shifts, hist):
        d = (k >> shift) & (ndig - 1)
        start = torch.cumsum(h, 0) - h                      # over digits
        counts = torch.bincount(tile * ndig + d,
                                minlength=tiles * ndig).view(tiles, ndig)
        before = torch.cumsum(counts, 0) - counts           # over tiles
        rank = torch.empty(p, dtype=torch.int64, device=dev)
        for t0 in range(0, p, RADIX_TILE):                  # in-tile ranks
            dt = d[t0:t0 + RADIX_TILE]
            seen = torch.cumsum(torch.nn.functional.one_hot(dt, ndig), 0)
            rank[t0:t0 + RADIX_TILE] = seen.gather(1, dt[:, None])[:, 0] - 1
        dest = start[d] + before[tile, d] + rank
        k = torch.empty_like(k).index_copy_(0, dest, k)
        v = torch.empty_like(v).index_copy_(0, dest, v)
    return v, (None if gather is None else gather[v])


def _finish_grid(rows, h, order, table_size, scene_min, cell_size):
    rows_sorted, cell_se = grid_table(rows, h, order, table_size)
    return PhotonGrid(rows=rows_sorted, cell_se=cell_se,
                      scene_min=tuple(scene_min), cell_size=cell_size,
                      table_size=table_size)


def build_grid(rows, valid, scene_min, merge_radius: float, table_size: int,
               salt=None) -> PhotonGrid:
    """Plain version of K8: hash, stable sort, padded sorted rows and the
    (start, end) table. rows [P, 8]; valid [P] bool (invalid photons go to
    the sentinel bucket table_size); merge_radius: a float32 value."""
    cell_size = 2.0 * merge_radius
    h, key = grid_keys(rows, valid, scene_min, cell_size, table_size, salt)
    order = torch.sort(key, stable=True).indices
    return _finish_grid(rows, h, order, table_size, scene_min, cell_size)


def photon_bucket_plain(rows, valid, scene_min, cell_size: float,
                        table_size: int):
    """Plain version of K8's rows mode (kernels.photon_bucket): each photon
    row's bucket (grid_keys) as int32 and the (start, end) table filled
    with (P, 0). -> (bucket [P] i32, cell_se [T+1, 2] i32)."""
    p = rows.shape[0]
    h, _ = grid_keys(rows, valid.bool(), scene_min, cell_size, table_size)
    cell_se = torch.zeros((table_size + 1, 2), dtype=torch.int32,
                          device=rows.device)
    cell_se[:, 0] = p
    return h.to(torch.int32), cell_se


def fold_neighbors(grid: PhotonGrid, query_pos, merge_radius: float,
                   max_per_cell: int, fold, init, active=None,
                   count_dropped: bool = False):
    """Plain version of K9: for the 8 corner cells in order (bit 0 x,
    bit 1 y, bit 2 z of the cell index select the step), the cell's photons
    start .. start + kept - 1 in ascending order, folded as
    fold(carry, photon row [N, 8], in_range [N], w [N]) -> carry, where
    in_range holds the exact d^2 <= r^2 test and w is count/kept (1 without
    reweighting). With count_dropped also returns the number of candidate
    photons the cap left out over the active queries (an int)."""
    n, dev = query_pos.shape[0], query_pos.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    r2 = float(np.float32(merge_radius) * np.float32(merge_radius))
    coord = _cell_coord(query_pos, grid.scene_min, grid.cell_size)
    base = torch.floor(coord).to(torch.int32)
    step = torch.where(coord - base.to(torch.float32) >= 0.5, 1,
                       -1).to(torch.int32)
    one_brick = one_brick_active(max_per_cell)
    carry, dropped = init, 0
    for c in range(8):
        sel = torch.tensor([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1],
                           dtype=torch.int32, device=dev)
        h = _hash_cells(base + step * sel, grid.table_size)
        se = grid.cell_se[h]
        start = se[:, 0]
        count = torch.clamp(se[:, 1] - start, min=0)
        kept = torch.clamp(count, max=max_per_cell)
        if one_brick:
            kept = torch.minimum(kept, 8 - (start & 7))
        w = _window_weight(count, kept)
        kept = torch.where(active, kept, 0)
        for k in range(int(kept.max()) if n else 0):
            ok = k < kept
            row = grid.rows[torch.where(ok, start + k, 0)]
            diff = query_pos - row[:, 0:3]
            d2 = dot(diff, diff)
            carry = fold(carry, row, ok & (d2 <= r2), w)
        if count_dropped:
            dropped += int(torch.where(active, count - kept, 0).sum())
    return (carry, dropped) if count_dropped else carry


# --- K9's materialised forms: every candidate slot of every query at once ---

# gather_neighbors' cell order: x step outermost (cell index bit 0 steps x)
GATHER_CELLS = tuple(dx | (dy << 1) | (dz << 2) for dx in (0, 1)
                     for dy in (0, 1) for dz in (0, 1))

def _query_cells(grid: PhotonGrid, query_pos):
    """The 8 corner cells of each query: (start [8,N] int64, count [8,N]
    int64), cell c stepping x by bit 0, y by bit 1, z by bit 2."""
    dev = query_pos.device
    coord = _cell_coord(query_pos, grid.scene_min, grid.cell_size)
    base = torch.floor(coord).to(torch.int32)
    step = torch.where(coord - base.to(torch.float32) >= 0.5, 1,
                       -1).to(torch.int32)
    c = torch.arange(8, device=dev)
    sel = torch.stack([c & 1, (c >> 1) & 1, (c >> 2) & 1],
                      dim=-1).to(torch.int32)                    # [8,3]
    h = _hash_cells(base[None] + step[None] * sel[:, None], grid.table_size)
    se = grid.cell_se[h].to(torch.int64)                         # [8,N,2]
    start = se[..., 0]
    return start, torch.clamp(se[..., 1] - start, min=0)


def _in_range(grid, query_pos, rows, ok, merge_radius: float):
    """ok & the exact d^2 <= r^2 of each slot's row [M,N,8]."""
    r2 = float(np.float32(merge_radius) * np.float32(merge_radius))
    diff = query_pos[None] - rows[..., 0:3]
    return ok & (dot(diff, diff) <= r2)


def _active(query_pos, active):
    if active is None:
        return torch.ones(query_pos.shape[0], dtype=torch.bool,
                          device=query_pos.device)
    return active


def neighbor_slots(grid: PhotonGrid, query_pos, merge_radius: float,
                   max_per_cell: int, active=None):
    """Every candidate slot of every query [N,3]: (rows [M,N,8], ok [M,N],
    wgt [M,N], dropped as a Python int), cell-major. Standard mode: M =
    8 x cap, slot (c, k) holds the cell's photon start + k (taken from the
    two 8-photon bricks from start's, the second clamped to the last), ok
    for k < min(count, cap), wgt count / kept. One-brick mode: M = 64,
    slot (c, k) holds photon k of the brick holding start, ok for
    rel = k - start % 8 in [0, kept), kept = min(count, cap, 8 - start % 8),
    wgt count / kept. ok includes the exact distance test; dropped counts
    count - kept over the active queries. Needs 1 <= cap <= 8."""
    if not 1 <= max_per_cell <= 8:
        raise ValueError("neighbor_slots needs 1 <= max_per_cell <= 8")
    n = query_pos.shape[0]
    active = _active(query_pos, active)
    start, count = _query_cells(grid, query_pos)
    max_brick = grid.rows.shape[0] // 8 - 1
    w0 = start >> 3
    a = start & 7
    if one_brick_active(max_per_cell):
        ks = torch.arange(8, device=start.device)
        p_idx = (torch.clamp(w0, max=max_brick) << 3)[:, None] \
            + ks[None, :, None]                                  # [8,8,N]
        rel = ks[None, :, None] - a[:, None]
        kept = torch.minimum(torch.clamp(count, max=max_per_cell), 8 - a)
        ok = active & (rel >= 0) & (rel < kept[:, None])
        w = _window_weight(count, kept)
    else:
        ks = torch.arange(max_per_cell, device=start.device)
        pos = a[:, None] + ks[None, :, None]                     # [8,cap,N]
        brick = torch.clamp(w0[:, None] + (pos >> 3), max=max_brick)
        p_idx = (brick << 3) + (pos & 7)
        kept = torch.clamp(count, max=max_per_cell)
        ok = active & (ks[None, :, None] < kept[:, None])
        w = _window_weight(count, kept)
    m = p_idx.shape[0] * p_idx.shape[1]
    rows = grid.rows[p_idx.reshape(m, n)]
    ok = _in_range(grid, query_pos, rows, ok.reshape(m, n), merge_radius)
    wgt = w[:, None].expand(p_idx.shape).reshape(m, n)
    dropped = int(torch.where(active, count - kept, 0).sum())
    return rows, ok, wgt, dropped


def neighbor_slots_compact(grid: PhotonGrid, query_pos, merge_radius: float,
                           max_per_cell: int, cap_q: int, active=None):
    """The candidate stream of neighbor_slots (each cell's kept photons,
    cells in order) per query, truncated to its first cap_q entries:
    (rows [cap_q,N,8], ok [cap_q,N], wgt [cap_q,N], dropped). Slot k of a
    query lies in the cell c whose kept run holds it (cum_kept[c-1] <= k <
    cum_kept[c]) and holds photon start_c + k - cum_kept[c-1]; past the
    stream's end the slot reads photon 0 with ok false and wgt 0 (1 without
    reweighting). dropped adds the stream's tail beyond cap_q to the
    cells' count - kept."""
    n, dev = query_pos.shape[0], query_pos.device
    active = _active(query_pos, active)
    start, count = _query_cells(grid, query_pos)
    kept = torch.clamp(count, max=max_per_cell)
    if one_brick_active(max_per_cell):
        kept = torch.minimum(kept, 8 - (start & 7))
    cum = torch.cumsum(kept, dim=0)                              # [8,N]
    total = cum[7]
    cum0 = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]])
    ks = torch.arange(cap_q, device=dev)
    c_idx = (cum[None] <= ks[:, None, None]).sum(dim=1)          # [cap_q,N]
    inside = c_idx < 8
    pick = lambda t: torch.where(
        inside, t.gather(0, torch.clamp(c_idx, max=7)), 0)
    p_idx = pick(start) + ks[:, None] - pick(cum0)
    ok = active & (ks[:, None] < torch.clamp(total, max=cap_q))
    rows = grid.rows[torch.where(ok, p_idx, 0)]
    ok = _in_range(grid, query_pos, rows, ok, merge_radius)
    wgt = _window_weight(pick(count), pick(kept))
    over = (count - kept).sum(dim=0) + torch.clamp(total - cap_q, min=0)
    return rows, ok, wgt, int(torch.where(active, over, 0).sum())


def gather_neighbors(grid: PhotonGrid, query_pos, merge_radius: float,
                     max_per_cell: int, active=None):
    """Yield (photon row [N,8], in_range [N]) for every slot (cell, k), k <
    max_per_cell: the cell's photon start + k where k < count (uncapped by
    the one-brick window), else photon 0 with in_range false. The cells
    come with the x step outermost and the z step innermost (GATHER_CELLS).
    in_range includes the exact distance test."""
    active = _active(query_pos, active)
    start, count = _query_cells(grid, query_pos)
    for c in GATHER_CELLS:
        for k in range(max_per_cell):
            ok = active & (k < count[c])
            row = grid.rows[torch.where(ok, start[c] + k, 0)]
            yield row, _in_range(grid, query_pos, row[None], ok[None],
                                 merge_radius)[0]
