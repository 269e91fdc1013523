"""BVH8: 8-wide BVH collapsed from the binary SAH tree (CBVH layout).

The port's own copy of cudapathtracer_tpu/scene/bvh8.py: it builds the
same table, bit for bit (tests/test_torch_scene.py), through the port's
own native library (scene/native.py). The design notes below were
written for the JAX package's TPU traversal; the port's kernel reads the
same rows (kernels/csrc/traverse8.cuh).

Why 8-wide: threaded binary traversal costs ONE row gather per visited node,
and on TPU the gather is the dominant per-step cost (~4.4 ns/lane/row on
v5e) while VPU math is nearly free. An 8-wide node tests all 8 child AABBs
from a single gathered row, pruning subtrees without visiting them — ~3-4x
fewer gathers per ray. The price is per-lane stack state, which is kept as
wide [N, D] arrays manipulated with one-hot masks (pure VPU, no narrow
slices).

Why sibling-contiguous ("compressed BVH") rows: all children of a node
occupy CONSECUTIVE table rows, so a node stores one `child_base` int
instead of 8 child pointers — the traversal's near-far ordering then sorts
a SINGLE packed int key per child slot (tmin bits | slot) and reconstructs
each child's row as `child_base + slot` by arithmetic. That removes two
thirds of the sort-network traffic, which profiling showed was the largest
non-gather cost of a traversal step (~27%). Zero space overhead: every row
is still some node's child, rows are simply emitted in sibling blocks
(BFS order, root = row 0).

HYBRID rows (round 3): every row carries BOTH a child stage and up to
`leaf_tris` INLINE triangles. The traversal step always runs both stages
in lockstep anyway (masked wide ops — the FLOPs are spent whether or not
any lane is at a leaf), so triangles inlined into their parent's row are
tested "for free" and the separate leaf-row visit disappears. At emission
each node row absorbs the subset of its small (<= leaf_tris tris) children
that maximizes saved surface area under the 4-triangle capacity (exact
knapsack over <= 8 children); absorbed children vanish from the child
slots, the rest keep sibling-contiguous rows. Measured on the 82k-tri
1080p scene: expected visited rows (SAH surrogate sum(area) over emitted
rows) drops 23%, leaf rows 26.5k -> ~21k, with identical per-step cost.
A pure leaf row is simply a row with no children (all slots empty).

Unified table layout (float32, [R, W], W = row_width(leaf_tris) = 96):

    [0:48]   child AABBs grouped by coordinate for wide slab tests:
             minx[8], miny[8], minz[8], maxx[8], maxy[8], maxz[8];
             empty/absorbed slots carry a degenerate box (min=max=+inf),
             never hit
    [48]     child_base (int32 bitcast): table row of the slot-0 child;
             slot i lives at child_base + i (0 when the row has no
             children — harmless, no slot ever hits)
    [49]     pad
    [50:50+9L]       inline triangles v0,e1,e2 (9 floats each)
    [50+9L:50+10L]   triangle ids (int32 bitcast; bit30 = leaf-material
                     flag; -1 pad)
    [50+10L:]        pad

There is no leaf bit anywhere: a traversal entry is a plain row index and
every row runs the same two stages.

Children keep the binary builder's in-order layout, so every collapsed
subtree's triangle range is contiguous in the permuted order. Two collapse
policies exist (both replace deviceCode's per-thread binary stack walk,
integratorUtilities.cuh:84-186):

  * "greedy": expand the child with the largest surface area first
    (area-weighted flattening — round-1 policy);
  * "sah" (default): exact dynamic program over the binary tree that
    minimizes the expected number of VISITED ROWS per ray (the engine's
    true cost unit: one gather + one lockstep step per row), i.e. it
    minimizes sum over emitted rows of area(row) — the wide-BVH analogue
    of the SAH used at binary build time. (The DP prices every small
    subtree as a leaf row; inline absorption then removes the highest-area
    ones at emission, a strict improvement on the DP's objective.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_TRIS = 4   # inline triangle capacity per row

# Empty child slots carry a degenerate AABB with min = max = +inf: for any
# direction-sign combination the slab test then yields tmin=+inf (fails
# tmin < t_best) or tmax=-inf (fails tmax > 0) — a plain inverted box would
# FALSELY HIT when negative direction components swap the min/max roles.
_EMPTY_BOUND = np.inf

TRI_OFF = 50    # inline triangles start at this row column


def row_width(leaf_tris: int) -> int:
    """Table row width for an inline capacity: 48 bounds + 2 meta +
    10 floats/tri. Gather cost on v5e is per ROW and near width-flat
    (~1.1x at 96 vs 64, ~1.6x at 128), so capacity 4 -> width 96."""
    need = TRI_OFF + 10 * leaf_tris
    for w in (64, 96, 128):
        if need <= w:
            return w
    raise ValueError(f"leaf_tris {leaf_tris} too large")


@dataclass
class BVH8:
    table: np.ndarray      # [R, W] f32 (sibling-contiguous, root = row 0)
    num_nodes: int
    num_leaves: int        # rows with no children (pure leaf rows)
    leaf_tris: int = LEAF_TRIS


def _subtree_range(bvh, node):
    """Contiguous [start, end) triangle range of a binary subtree (the
    builder emits leaves in-order)."""
    # walk to leftmost and rightmost leaves
    lo = node
    while bvh.leaf[lo, 1] == 0:
        lo = bvh.left[lo]
    hi = node
    while bvh.leaf[hi, 1] == 0:
        hi = bvh.right[hi]
    return int(bvh.leaf[lo, 0]), int(bvh.leaf[hi, 0] + bvh.leaf[hi, 1])


def _area(bounds):
    d = np.maximum(bounds[3:6] - bounds[0:3], 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def collapse(bvh, tri_pack: np.ndarray, tri_is_leaf_mat: np.ndarray,
             leaf_tris: int = LEAF_TRIS, use_native: bool = True,
             policy: str = "sah") -> BVH8:
    """Collapse the binary BVH into the sibling-contiguous BVH8 table.

    policy "sah" (default) runs the row-minimizing dynamic program;
    "greedy" keeps the round-1 largest-area expansion. Both dispatch to the
    C++ ports (csrc/bvh8_collapse.cpp, bit-identical — tested in
    tests/test_bvh.py) when available; the *_py functions below are the
    numpy oracles and fallbacks."""
    if use_native:
        from reference.tpt.scene import native
        res = native.native_bvh8_collapse(
            bvh, np.ascontiguousarray(tri_pack, np.float32),
            np.ascontiguousarray(tri_is_leaf_mat, np.uint8),
            leaf_tris, row_width(leaf_tris), policy=policy)
        if res is not None:
            table, nn, nl = res
            return BVH8(table=table, num_nodes=nn, num_leaves=nl,
                        leaf_tris=leaf_tris)
    if policy == "sah":
        return collapse_sah_py(bvh, tri_pack, tri_is_leaf_mat, leaf_tris)
    return collapse_py(bvh, tri_pack, tri_is_leaf_mat, leaf_tris)


def _knapsack_inline(leaves_idx, weights, areas, cap):
    """Exact subset choice: among the (<= 8) leaf children, pick the subset
    with total triangle count <= cap maximizing summed f32 area. Subsets
    are enumerated by increasing bitmask over the child-order list and a
    STRICT > comparison keeps the first-found best — the native port
    replicates this enumeration bit-for-bit."""
    best_a = np.float32(0.0)
    best_mask = 0
    nl = len(leaves_idx)
    for mask in range(1, 1 << nl):
        w = 0
        a = np.float32(0.0)
        for i in range(nl):
            if mask >> i & 1:
                w += weights[i]
                a = np.float32(a + areas[i])
        if w <= cap and a > best_a:
            best_a = a
            best_mask = mask
    return best_mask


def _emit_table(bvh, tri_pack, tri_is_leaf_mat, leaf_tris, expand) -> BVH8:
    """Shared DFS table emission with hybrid inline absorption: each
    processed node allocates one contiguous block of rows for its
    NON-ABSORBED children (from `expand(b)` — a list of binary subtree
    roots); absorbed leaf children's triangles go inline into the node's
    own row. Depth-first block order clusters each subtree's rows, which
    keeps a coherent wavefront's row working set compact in HBM."""
    LT = leaf_tris
    RW = row_width(leaf_tris)

    def write_tris(row, tri_list):
        ids = np.full(LT, -1, np.int32)
        for k, t in enumerate(tri_list):
            row[TRI_OFF + 9 * k: TRI_OFF + 9 * k + 9] = tri_pack[t]
            tid = np.int32(t)
            if tri_is_leaf_mat[t]:
                tid = np.int32(tid | np.int32(1 << 30))
            ids[k] = tid
        row[TRI_OFF + 9 * LT: TRI_OFF + 10 * LT] = ids.view(np.float32)

    def make_leaf_row(s, e):
        row = np.zeros(RW, np.float32)
        row[0:48] = _EMPTY_BOUND    # no children
        write_tris(row, range(s, e))
        return row

    rows: dict[int, np.ndarray] = {}
    cursor = 1                      # row 0 = root node row
    queue = [(0, 0)]                # (binary node, table row)
    num_nodes = num_leaves = 0
    while queue:
        b, my_row = queue.pop()
        children = expand(b)
        num_nodes += 1

        # hybrid absorption: exact knapsack over the small children
        sizes = [_subtree_range(bvh, c) for c in children]
        small = [i for i, (s, e) in enumerate(sizes) if e - s <= LT]
        absorb_mask = 0
        if small:
            weights = [sizes[i][1] - sizes[i][0] for i in small]
            areas = [np.float32(_area(bvh.bounds[children[i]]))
                     for i in small]
            km = _knapsack_inline(small, weights, areas, LT)
            for j, i in enumerate(small):
                if km >> j & 1:
                    absorb_mask |= 1 << i

        inline_tris: list[int] = []
        kept: list[int] = []
        for i, c in enumerate(children):
            if absorb_mask >> i & 1:
                s, e = sizes[i]
                inline_tris.extend(range(s, e))
            else:
                kept.append(i)

        base = cursor
        cursor += len(kept)

        row = np.zeros(RW, np.float32)
        row[0:48] = _EMPTY_BOUND    # empty slots: degenerate box, never hit
        for slot, i in enumerate(kept):
            c = children[i]
            bb = bvh.bounds[c]
            for ax in range(3):
                row[ax * 8 + slot] = bb[ax]
                row[(3 + ax) * 8 + slot] = bb[3 + ax]
            s, e = sizes[i]
            if e - s > LT:
                queue.append((c, base + slot))
            else:
                rows[base + slot] = make_leaf_row(s, e)
                num_leaves += 1
        row[48:50] = np.asarray([base, 0], np.int32).view(np.float32)
        write_tris(row, inline_tris)
        rows[my_row] = row

    table = np.stack([rows[r] for r in range(cursor)]).astype(np.float32)
    return BVH8(table=table, num_nodes=num_nodes, num_leaves=num_leaves,
                leaf_tris=LT)


def collapse_py(bvh, tri_pack: np.ndarray, tri_is_leaf_mat: np.ndarray,
                leaf_tris: int = LEAF_TRIS) -> BVH8:
    """Pure-numpy GREEDY collapse (oracle for the native port): expand the
    child with the largest surface area until 8 children."""
    LT = leaf_tris

    def expand(b):
        children = [b]
        while len(children) < 8:
            # pick the expandable child with the largest surface area
            best, best_a = -1, -1.0
            for i, c in enumerate(children):
                if bvh.leaf[c, 1] == 0:  # inner binary node
                    s, e = _subtree_range(bvh, c)
                    if e - s > LT:
                        a = _area(bvh.bounds[c])
                        if a > best_a:
                            best, best_a = i, a
            if best == -1:
                break
            c = children.pop(best)
            children.insert(best, bvh.right[c])
            children.insert(best, bvh.left[c])
        return children

    return _emit_table(bvh, tri_pack, tri_is_leaf_mat, LT, expand)


def collapse_sah_py(bvh, tri_pack: np.ndarray, tri_is_leaf_mat: np.ndarray,
                    leaf_tris: int = LEAF_TRIS) -> BVH8:
    """Pure-numpy SAH collapse (oracle for the native port).

    Bottom-up dynamic program over the binary tree (the wide-BVH collapse
    DP of Ylitie et al. 2017 adapted to this engine's cost model): every
    emitted table row — node or leaf — costs one gather + one lockstep
    step, so the objective is to minimize the expected number of VISITED
    rows per ray, whose SAH surrogate is sum(area(subtree root)) over
    emitted rows.

      dist[n, j] = min cost of representing subtree n as a forest of
                   <= j roots (j = 1..8)
      dist[n, 1] = area[n] (a leaf row) if tris(n) <= LT — always optimal
                   then, since an internal row costs area[n] + children;
                   else area[n] + min_k dist[l, k] + dist[r, 8-k] (an
                   internal row distributing n's subtree over 8 slots)
      dist[n, j] = min(dist[n, 1],
                       min_{k<j} dist[left, k] + dist[right, j-k])

    A node with tris(n) <= LT is emitted as ONE leaf row spanning its whole
    contiguous triangle range exactly like the greedy policy — unless the
    emission-time knapsack absorbs it into its parent's inline slots
    (_emit_table). Ties break to the single-root choice, then to the
    smallest k (the native port replicates this, bit-for-bit)."""
    LT = leaf_tris
    M = bvh.num_nodes
    left, right = bvh.left, bvh.right
    is_bleaf = bvh.leaf[:, 1] > 0

    # subtree triangle counts (reverse sweep: children follow parents)
    tris = np.where(is_bleaf, bvh.leaf[:, 1], 0).astype(np.int64)
    for i in range(M - 1, -1, -1):
        if not is_bleaf[i]:
            tris[i] = tris[left[i]] + tris[right[i]]
    ext = np.maximum(bvh.bounds[:, 3:6] - bvh.bounds[:, 0:3],
                     np.float32(0.0))
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                  + ext[:, 2] * ext[:, 0])
    area = area.astype(np.float32)

    INF = np.float32(np.inf)
    dist = np.full((M, 9), INF, np.float32)
    kbest = np.full((M, 9), -1, np.int8)   # -1 = single root at this j
    kint = np.full(M, -1, np.int8)         # 8-way split k of internal rows
    for i in range(M - 1, -1, -1):
        if tris[i] <= LT:           # leaf row: always optimal, forced
            dist[i, 1:] = area[i]
            continue
        li, ri = left[i], right[i]
        dl, dr = dist[li], dist[ri]
        best, bk = INF, -1
        for k in range(1, 8):
            c = dl[k] + dr[8 - k]
            if c < best:
                best, bk = c, k
        kint[i] = bk
        d1 = np.float32(area[i] + best)
        dist[i, 1] = d1
        for j in range(2, 9):
            bj, bkj = d1, -1
            for k in range(1, j):
                c = dl[k] + dr[j - k]
                if c < bj:
                    bj, bkj = c, k
            dist[i, j] = bj
            kbest[i, j] = bkj

    def forest(n, j):
        """In-order forest roots realizing dist[n, j]."""
        out, stack = [], [(n, j)]
        while stack:
            n, j = stack.pop()
            k = kbest[n, j] if j > 1 else -1
            if k < 0:
                out.append(n)
            else:
                stack.append((right[n], j - int(k)))
                stack.append((left[n], int(k)))
        return out

    def expand(b):
        if tris[b] <= LT:
            return [b]              # degenerate root: one leaf child
        k = int(kint[b])
        return forest(left[b], k) + forest(right[b], 8 - k)

    return _emit_table(bvh, tri_pack, tri_is_leaf_mat, LT, expand)
