"""SAH and SBVH builds of the binary BVH (host-side numpy + native C++).

The port's own copy of cudapathtracer_tpu/scene/bvh.py. It builds the same
trees, bit for bit, so the BVH8 tables the port traverses equal the JAX
package's (tests/test_torch_scene.py). Build semantics mirror the
reference's recursive CPU builder (main.cu:17-233): longest-axis split,
12-bucket binned SAH with cost 1 + (SA_L*n_L + SA_R*n_R)/SA_parent, median
(nth_element) fallback when no valid bucket split, mean-centroid backup
split, force-leaf fallback, and epsilon-padded per-triangle AABBs
(main.cu:20-47).

Nodes also carry per-octant threaded (hit, miss) links (`thread_links`,
the `links` field, build_bvh's `thread=` option): octant o of a ray's
direction signs visits the child on the ray's side of the split axis
first, so the threaded binary engine (traversal="threaded",
ops/traverse.py, kernel K15) walks the tree with one int cursor and no
stack. The BVH8 engine never reads them; `thread=False` and build_sbvh
leave a [1,8,2] sentinel (the threaded engine turns SBVH off). The
inherited faults (ROADMAP Queue 3: a reference that touches the split
plane is duplicated with a zero-extent box; `do_spatial` is dead) are
kept so the tables stay equal.

A C++ builder (scene/csrc/bvh_builder.cpp) accelerates large scenes; the
numpy implementation below is the reference oracle and fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from reference.tpt.scene.native import native_build_bvh

AABB_PAD = 1e-6  # main.cu:33-45


@dataclass
class BVH:
    """Flat BVH with per-octant threaded links (host numpy; Scene uploads).

    bounds:    [M, 6] f32 — (minx, miny, minz, maxx, maxy, maxz)
    leaf:      [M, 2] i32 — (first, count); count == 0 for inner nodes
    links:     [M, 8, 2] i32 — per-octant (hit_link, miss_link); -1 = done
    perm:      [T] i32 — triangle permutation; leaf `first/count` index the
               permuted order (reference: BVHindices indirection; we permute
               the triangle arrays instead so leaf reads are contiguous)
    left/right/axis: [M] i32 — tree structure (kept for stats/tests)
    """
    bounds: np.ndarray
    leaf: np.ndarray
    links: np.ndarray
    perm: np.ndarray
    left: np.ndarray
    right: np.ndarray
    axis: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]

    @property
    def max_leaf_count(self) -> int:
        return int(self.leaf[:, 1].max()) if self.num_nodes else 0


def triangle_bounds(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """Per-triangle centroid + padded AABB (computeInfoForBVH, main.cu:20-47)."""
    centroid = (p0 + p1 + p2) / 3.0
    amin = np.minimum(np.minimum(p0, p1), p2) - AABB_PAD
    amax = np.maximum(np.maximum(p0, p1), p2) + AABB_PAD
    return centroid.astype(np.float32), amin.astype(np.float32), amax.astype(np.float32)


def _surface_area(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _sah_split_pos(idx, centroids, amins, amaxs, axis, min_b, max_b):
    """12-bucket binned SAH over the node bounds (SAH(), main.cu:64-131).
    Returns splitPos (float) — or the median fallback position."""
    nb = 12
    extent = max_b[axis] - min_b[axis]
    if extent <= 0.0:
        extent = 1e-30
    c = centroids[idx, axis]
    b = np.clip((nb * (c - min_b[axis]) / extent).astype(np.int64), 0, nb - 1)

    counts = np.bincount(b, minlength=nb)
    bmin = np.full((nb, 3), np.finfo(np.float32).max, np.float32)
    bmax = np.full((nb, 3), -np.finfo(np.float32).max, np.float32)
    for k in range(3):
        np.minimum.at(bmin[:, k], b, amins[idx, k])
        np.maximum.at(bmax[:, k], b, amaxs[idx, k])

    # prefix/suffix scans for left/right bounds of each candidate split
    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    lcount = np.cumsum(counts)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    rcount = np.cumsum(counts[::-1])[::-1]

    sa_parent = _surface_area(min_b, max_b)
    best_cost, best_split = np.inf, -1
    for i in range(1, nb):
        nl, nr = lcount[i - 1], rcount[i]
        if nl == 0 or nr == 0:
            continue
        cost = 1.0 + (nl * _surface_area(lmin[i - 1], lmax[i - 1])
                      + nr * _surface_area(rmin[i], rmax[i])) / max(sa_parent, 1e-30)
        if cost < best_cost:
            best_cost, best_split = cost, i

    if best_split == -1:
        # median fallback (main.cu:118-125); ties broken by original triangle
        # index so the native C++ builder agrees bit-for-bit
        order = np.lexsort((idx, c))
        mid = len(idx) // 2
        return float(c[order[mid]])
    return float(min_b[axis] + extent * (best_split / nb))


def build_bvh(centroids: np.ndarray, amins: np.ndarray, amaxs: np.ndarray,
              max_leaf_size: int = 2, use_native: bool = True,
              thread: bool = True) -> BVH:
    """Top-down SAH build (buildBVH, main.cu:133-233), iterative.

    Node order matches the reference's recursion (pre-order, left subtree
    fully before right), so flat node indices agree with a recursive build.

    thread=False skips the per-octant threaded (hit, miss) links — a
    Python-loop cost only the binary "threaded" traversal engine consumes
    (the default BVH8 engine never reads them); `links` is then a [1,8,2]
    sentinel.
    """
    n = centroids.shape[0]
    if n == 0:
        raise ValueError("empty scene")

    def mk_links(left, right, axis, leaf):
        if thread:
            return thread_links(left, right, axis, leaf)
        return np.full((1, 8, 2), -1, np.int32)

    if use_native:
        native = native_build_bvh(centroids, amins, amaxs, max_leaf_size)
        if native is not None:
            left, right, axis, leaf, bounds, perm = native
            links = mk_links(left, right, axis, leaf)
            return BVH(bounds=bounds, leaf=leaf, links=links, perm=perm,
                       left=left, right=right, axis=axis)

    perm = np.arange(n, dtype=np.int32)
    bounds_l, leaf_l, left_l, right_l, axis_l = [], [], [], [], []

    def new_node():
        bounds_l.append(None)
        leaf_l.append((0, 0))
        left_l.append(-1)
        right_l.append(-1)
        axis_l.append(-1)
        return len(bounds_l) - 1

    # Explicit stack replicating recursion order: each frame builds one node
    # and (if inner) pushes children; the parent's child pointers are patched
    # post-hoc. To match the reference's pre-order node numbering we process
    # depth-first, left first.
    def build(start: int, end: int) -> int:
        ni = new_node()
        idx = perm[start:end]
        min_b = amins[idx].min(axis=0)
        max_b = amaxs[idx].max(axis=0)
        bounds_l[ni] = np.concatenate([min_b, max_b])

        count = end - start
        if count <= max_leaf_size:
            leaf_l[ni] = (start, count)
            return ni

        ext = max_b - min_b
        axis = int(np.argmax(ext))
        split = _sah_split_pos(idx, centroids, amins, amaxs, axis, min_b, max_b)

        c = centroids[idx, axis]
        num_left = int((c < split).sum())
        if not (0 < num_left < count - 1):  # reference: numLeft>0 && numLeft<(count-1)
            # mean-centroid backup split (main.cu:196-206)
            split = float(c.mean())
            num_left = int((c < split).sum())
            if not (0 < num_left < count - 1):
                # The reference force-leafs here (main.cu:215-222), which can
                # produce leaves larger than maxLeafSize. Our traversal inlines
                # leaf triangles in fixed-width packed node rows, so we
                # hard-split by index instead (identical-centroid clusters).
                mid = start + count // 2
                axis_l[ni] = axis
                l = build(start, mid)
                r = build(mid, end)
                left_l[ni], right_l[ni] = l, r
                return ni

        sel = c < split
        # stable partition (reference uses an order-mangling swap partition;
        # stable keeps determinism and identical leaf membership)
        perm[start:end] = np.concatenate([idx[sel], idx[~sel]])
        mid = start + int(sel.sum())

        axis_l[ni] = axis
        l = build(start, mid)
        r = build(mid, end)
        left_l[ni], right_l[ni] = l, r
        return ni

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    bounds = np.stack(bounds_l).astype(np.float32)
    leaf = np.asarray(leaf_l, np.int32)
    left = np.asarray(left_l, np.int32)
    right = np.asarray(right_l, np.int32)
    axis = np.asarray(axis_l, np.int32)
    links = mk_links(left, right, axis, leaf)
    return BVH(bounds=bounds, leaf=leaf, links=links, perm=perm,
               left=left, right=right, axis=axis)


def _sah_object_split(idx, centroids, amins, amaxs, axis, min_b, max_b):
    """12-bucket binned SAH like _sah_split_pos, but also returns the cost
    and the child bounds of the best split (needed by the SBVH builder to
    compare against spatial-split candidates and compute child overlap).
    Returns (cost, split_pos, lbounds, rbounds); cost = inf when every
    bucket split was invalid (caller falls back)."""
    nb = 12
    extent = max_b[axis] - min_b[axis]
    if extent <= 0.0:
        extent = 1e-30
    c = centroids[idx, axis]
    b = np.clip((nb * (c - min_b[axis]) / extent).astype(np.int64), 0, nb - 1)
    counts = np.bincount(b, minlength=nb)
    bmin = np.full((nb, 3), np.finfo(np.float32).max, np.float32)
    bmax = np.full((nb, 3), -np.finfo(np.float32).max, np.float32)
    for k in range(3):
        np.minimum.at(bmin[:, k], b, amins[idx, k])
        np.maximum.at(bmax[:, k], b, amaxs[idx, k])
    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    lcount = np.cumsum(counts)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    rcount = np.cumsum(counts[::-1])[::-1]
    sa_parent = _surface_area(min_b, max_b)
    best_cost, best_split = np.inf, -1
    for i in range(1, nb):
        nl, nr = lcount[i - 1], rcount[i]
        if nl == 0 or nr == 0:
            continue
        cost = 1.0 + (nl * _surface_area(lmin[i - 1], lmax[i - 1])
                      + nr * _surface_area(rmin[i], rmax[i])) \
            / max(sa_parent, 1e-30)
        if cost < best_cost:
            best_cost, best_split = cost, i
    if best_split == -1:
        return np.inf, 0.0, None, None
    i = best_split
    return (float(best_cost), float(min_b[axis] + extent * (i / nb)),
            (lmin[i - 1].copy(), lmax[i - 1].copy()),
            (rmin[i].copy(), rmax[i].copy()))


def _clip_tri_aabb(p0, p1, p2, axis, lo, hi):
    """Tight AABB of a triangle clipped to the slab lo <= x[axis] <= hi
    (Sutherland-Hodgman on the polygon, one triangle at a time — called
    only for the straddling references of a chosen spatial split)."""
    poly = [p0, p1, p2]
    for bound, keep_ge in ((lo, True), (hi, False)):
        out = []
        for i in range(len(poly)):
            a, b = poly[i], poly[(i + 1) % len(poly)]
            da, db = a[axis] - bound, b[axis] - bound
            ina = da >= 0.0 if keep_ge else da <= 0.0
            inb = db >= 0.0 if keep_ge else db <= 0.0
            if ina:
                out.append(a)
            if ina != inb:
                t = da / (da - db)
                out.append(a + t * (b - a))
        poly = out
        if not poly:
            return None
    q = np.asarray(poly, np.float64)
    return (q.min(axis=0).astype(np.float32),
            q.max(axis=0).astype(np.float32))


def build_sbvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
               max_leaf_size: int = 2, alpha: float = 1e-5,
               max_dup: float = 1.5,
               spatial_depth: int = 10**9,
               native_below: bool = False,
               no_split: np.ndarray | None = None) -> BVH:
    """SBVH: SAH build with SPATIAL splits (Stich et al. 2009, HPG).

    Extends the object-split build (buildBVH semantics, main.cu:133-233 —
    a capability the reference does NOT have) with per-node chopped-binned
    spatial split candidates: when the best object split's children
    overlap by more than `alpha` of the root surface area, a triangle
    REFERENCE may be split at a bin plane and sent to both children with
    clipped bounds. `perm` then becomes a reference list of length
    R >= T that may repeat triangle indices; leaf (first, count) index
    that list, and consumers gather triangle data per reference
    (scene.build_scene dedupes the light table so duplicated emissive
    refs don't bias light sampling).

    Total references are budgeted at max_dup * T; once exhausted the
    build degrades to pure object splits. Spatial-split child bounds of
    straddling references use exact triangle-polygon clipping; the
    binning pass uses box clipping (cheaper, slightly looser).

    CAVEAT (documented, enforced by the caller): any-hit shadow rays
    accumulate leaf-material transmission PER INTERSECTED REFERENCE
    (shadow_factor8), so a duplicated transmissive triangle would be
    counted twice. Scenes with transmissive (MAT_LEAF) materials must
    keep the reference single-reference builder.
    """
    n = p0.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    centroids, t_amins, t_amaxs = triangle_bounds(p0, p1, p2)
    budget = [int(max_dup * n) - n]  # extra references allowed

    bounds_l, leaf_l, left_l, right_l, axis_l = [], [], [], [], []
    out_refs: list[np.ndarray] = []
    out_count = [0]

    def new_node():
        bounds_l.append(None)
        leaf_l.append((0, 0))
        left_l.append(-1)
        right_l.append(-1)
        axis_l.append(-1)
        return len(bounds_l) - 1

    sa_root = None

    def splice_native(idx, rmin, rmax):
        """Build the subtree with the native object-split builder over the
        (possibly clipped) REFERENCE bounds and splice its preorder node
        block in place. Returns the subtree root id, or None when the
        native library is unavailable."""
        rc = 0.5 * (rmin + rmax)
        nat = native_build_bvh(rc.astype(np.float32),
                               rmin.astype(np.float32),
                               rmax.astype(np.float32), max_leaf_size)
        if nat is None:
            return None
        l_, r_, a_, lf_, bd_, pm_ = nat
        base = len(bounds_l)
        bounds_l.extend(bd_)
        left_l.extend(np.where(l_ >= 0, l_ + base, -1).tolist())
        right_l.extend(np.where(r_ >= 0, r_ + base, -1).tolist())
        axis_l.extend(a_.tolist())
        lf = lf_.copy()
        lf[:, 0] = np.where(lf_[:, 1] > 0, lf_[:, 0] + out_count[0], 0)
        leaf_l.extend(map(tuple, lf))
        out_refs.append(idx[pm_])
        out_count[0] += pm_.shape[0]
        return base

    def build(idx, rmin, rmax, depth=0):
        """idx: [k] triangle ids of this node's references; rmin/rmax:
        their (possibly clipped) reference bounds."""
        nonlocal sa_root
        if (native_below and depth >= spatial_depth
                and idx.shape[0] > max_leaf_size):
            root = splice_native(idx, rmin, rmax)
            if root is not None:
                return root
        ni = new_node()
        min_b = rmin.min(axis=0)
        max_b = rmax.max(axis=0)
        bounds_l[ni] = np.concatenate([min_b, max_b])
        if sa_root is None:
            sa_root = max(_surface_area(min_b, max_b), 1e-30)

        count = idx.shape[0]
        if count <= max_leaf_size:
            leaf_l[ni] = (out_count[0], count)
            out_refs.append(idx)
            out_count[0] += count
            return ni

        ext = max_b - min_b
        axis = int(np.argmax(ext))
        rc = 0.5 * (rmin + rmax)  # reference centroids (clipped refs)
        c_obj, split, lb, rb = _sah_object_split(
            np.arange(count), rc, rmin, rmax, axis, min_b, max_b)

        # ---- spatial-split candidate (chopped binning, same axis)
        do_spatial = False
        if np.isfinite(c_obj) and budget[0] > 0 and depth < spatial_depth:
            omin = np.maximum(lb[0], rb[0])
            omax = np.minimum(lb[1], rb[1])
            if np.all(omax > omin) and \
                    _surface_area(omin, omax) / sa_root > alpha:
                nb = 12
                extent = max(float(ext[axis]), 1e-30)
                lob = min_b[axis]
                bf = np.clip((nb * (rmin[:, axis] - lob) / extent)
                             .astype(np.int64), 0, nb - 1)
                bl = np.clip((nb * (rmax[:, axis] - lob) / extent)
                             .astype(np.int64), 0, nb - 1)
                entries = np.bincount(bf, minlength=nb)
                exits = np.bincount(bl, minlength=nb)
                binmin = np.full((nb, 3), np.finfo(np.float32).max,
                                 np.float32)
                binmax = np.full((nb, 3), -np.finfo(np.float32).max,
                                 np.float32)
                for b in range(nb):
                    m = (bf <= b) & (bl >= b)
                    if not m.any():
                        continue
                    slab_lo = lob + extent * (b / nb)
                    slab_hi = lob + extent * ((b + 1) / nb)
                    cmin = rmin[m].copy()
                    cmax = rmax[m].copy()
                    cmin[:, axis] = np.maximum(cmin[:, axis], slab_lo)
                    cmax[:, axis] = np.minimum(cmax[:, axis], slab_hi)
                    binmin[b] = np.minimum(binmin[b], cmin.min(axis=0))
                    binmax[b] = np.maximum(binmax[b], cmax.max(axis=0))
                smin = np.minimum.accumulate(binmin, axis=0)
                smax = np.maximum.accumulate(binmax, axis=0)
                lcnt = np.cumsum(entries)
                tmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
                tmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
                rcnt = np.cumsum(exits[::-1])[::-1]
                sa_p = max(_surface_area(min_b, max_b), 1e-30)
                c_sp, i_sp = np.inf, -1
                for i in range(1, nb):
                    nl, nr = lcnt[i - 1], rcnt[i]
                    if nl == 0 or nr == 0:
                        continue
                    cost = 1.0 + (nl * _surface_area(smin[i - 1],
                                                     smax[i - 1])
                                  + nr * _surface_area(tmin[i], tmax[i])) \
                        / sa_p
                    if cost < c_sp:
                        c_sp, i_sp = cost, i
                if i_sp > 0 and c_sp < c_obj:
                    plane = lob + extent * (i_sp / nb)
                    go_l = bl < i_sp       # wholly left of the plane
                    go_r = bf >= i_sp      # wholly right
                    straddle = ~(go_l | go_r)
                    n_str = int(straddle.sum())
                    if n_str <= budget[0]:
                        li = [idx[go_l]]
                        lmin = [rmin[go_l]]
                        lmax = [rmax[go_l]]
                        ri_ = [idx[go_r]]
                        rrmin = [rmin[go_r]]
                        rrmax = [rmax[go_r]]
                        sl_min, sl_max, sr_min, sr_max = [], [], [], []
                        sidx = np.nonzero(straddle)[0]
                        keep_s = []
                        for s in sidx:
                            t = idx[s]
                            if no_split is not None and no_split[t]:
                                # never duplicate these references (scene
                                # passes emissive triangles: light-table
                                # rows and shadow-ray light skips assume
                                # a unique row per light tri) — send the
                                # whole ref to its centroid side
                                if rc[s, axis] < plane:
                                    li.append(idx[s:s + 1])
                                    sl_min.append(rmin[s])
                                    sl_max.append(rmax[s])
                                else:
                                    ri_.append(idx[s:s + 1])
                                    sr_min.append(rmin[s])
                                    sr_max.append(rmax[s])
                                keep_s.append(False)
                                continue
                            cl = _clip_tri_aabb(p0[t], p1[t], p2[t],
                                                axis, -np.inf, plane)
                            cr = _clip_tri_aabb(p0[t], p1[t], p2[t],
                                                axis, plane, np.inf)
                            # clip against the reference bounds (the ref
                            # may itself be a clipped fragment)
                            if cl is not None:
                                a = np.maximum(cl[0] - AABB_PAD, rmin[s])
                                b2 = np.minimum(cl[1] + AABB_PAD, rmax[s])
                                cl = (a, b2) if np.all(b2 >= a) else None
                            if cr is not None:
                                a = np.maximum(cr[0] - AABB_PAD, rmin[s])
                                b2 = np.minimum(cr[1] + AABB_PAD, rmax[s])
                                cr = (a, b2) if np.all(b2 >= a) else None
                            if cl is None and cr is None:
                                # degenerate: keep the unclipped ref on
                                # the side of its centroid
                                if rc[s, axis] < plane:
                                    cl = (rmin[s], rmax[s])
                                else:
                                    cr = (rmin[s], rmax[s])
                            if cl is not None:
                                li.append(idx[s:s + 1])
                                sl_min.append(cl[0])
                                sl_max.append(cl[1])
                            if cr is not None:
                                ri_.append(idx[s:s + 1])
                                sr_min.append(cr[0])
                                sr_max.append(cr[1])
                            keep_s.append((cl is not None)
                                          and (cr is not None))
                        budget[0] -= int(np.sum(keep_s))
                        lidx = np.concatenate(li)
                        lmn = np.concatenate(
                            lmin + ([np.stack(sl_min)] if sl_min else []))
                        lmx = np.concatenate(
                            lmax + ([np.stack(sl_max)] if sl_max else []))
                        ridx = np.concatenate(ri_)
                        rmn = np.concatenate(
                            rrmin + ([np.stack(sr_min)] if sr_min else []))
                        rmx = np.concatenate(
                            rrmax + ([np.stack(sr_max)] if sr_max else []))
                        if 0 < lidx.size and 0 < ridx.size:
                            do_spatial = True
                            axis_l[ni] = axis
                            l = build(lidx, lmn, lmx, depth + 1)
                            r = build(ridx, rmn, rmx, depth + 1)
                            left_l[ni], right_l[ni] = l, r
                            return ni

        # ---- object split (reference fallback chain)
        c = rc[:, axis]
        if not np.isfinite(c_obj):
            order = np.lexsort((idx, c))
            split = float(c[order[count // 2]])
        sel = c < split
        num_left = int(sel.sum())
        if not (0 < num_left < count - 1):
            split = float(c.mean())
            sel = c < split
            num_left = int(sel.sum())
            if not (0 < num_left < count - 1):
                mid = count // 2
                sel = np.zeros(count, bool)
                sel[:mid] = True
        axis_l[ni] = axis
        l = build(idx[sel], rmin[sel], rmax[sel], depth + 1)
        r = build(idx[~sel], rmin[~sel], rmax[~sel], depth + 1)
        left_l[ni], right_l[ni] = l, r
        return ni

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 4 * n))
    try:
        build(np.arange(n, dtype=np.int32), t_amins.copy(), t_amaxs.copy())
    finally:
        sys.setrecursionlimit(old_limit)

    bounds = np.stack(bounds_l).astype(np.float32)
    leaf = np.asarray(leaf_l, np.int32)
    left = np.asarray(left_l, np.int32)
    right = np.asarray(right_l, np.int32)
    axis = np.asarray(axis_l, np.int32)
    perm = np.concatenate(out_refs).astype(np.int32) if out_refs \
        else np.zeros((0,), np.int32)
    # the threaded engine builds with build_bvh: an SBVH tree has no links
    return BVH(bounds=bounds, leaf=leaf,
               links=np.full((1, 8, 2), -1, np.int32), perm=perm,
               left=left, right=right, axis=axis)


def thread_links(left: np.ndarray, right: np.ndarray, axis: np.ndarray,
                 leaf: np.ndarray) -> np.ndarray:
    """Compute per-octant threaded (hit, miss) links.

    Octant o encodes ray direction signs: bit k set <=> dir[k] < 0. At a node
    split on axis a, the left child (smaller coordinates) is visited first
    when dir[a] >= 0, i.e. when bit a of o is clear.

    Returns links [M, 8, 2] i32 where links[n, o] = (hit, miss):
      hit  — next node if the AABB test passes (first child for inner nodes;
             for leaves, equal to miss: triangles are tested, then continue)
      miss — next node if the AABB test fails / after finishing this subtree.
    -1 terminates traversal.
    """
    m = left.shape[0]
    links = np.full((m, 8, 2), -1, np.int32)
    is_leaf = leaf[:, 1] > 0

    for o in range(8):
        neg = [(o >> k) & 1 for k in range(3)]
        # iterative DFS carrying the "next after subtree" continuation
        stack = [(0, -1)]
        while stack:
            node, cont = stack.pop()
            links[node, o, 1] = cont
            if is_leaf[node]:
                links[node, o, 0] = cont
                continue
            l, r = left[node], right[node]
            a = axis[node]
            first, second = (l, r) if not neg[a] else (r, l)
            links[node, o, 0] = first
            stack.append((first, second))
            stack.append((second, cont))
    return links


def bvh_stats(bvh: BVH) -> dict:
    """Node/leaf counts, depth stats, top leaf sizes — parity with
    printBVHSummary (objects.cuh:84-149)."""
    m = bvh.num_nodes
    depth = np.zeros(m, np.int32)
    stack = [(0, 0)]
    leaf_depths, leaf_sizes = [], []
    while stack:
        node, d = stack.pop()
        depth[node] = d
        if bvh.leaf[node, 1] > 0:
            leaf_depths.append(d)
            leaf_sizes.append(int(bvh.leaf[node, 1]))
        else:
            stack.append((bvh.left[node], d + 1))
            stack.append((bvh.right[node], d + 1))
    leaf_depths = np.asarray(leaf_depths)
    leaf_sizes = np.asarray(leaf_sizes)
    return dict(
        num_nodes=m,
        num_leaves=int(len(leaf_sizes)),
        depth_mean=float(leaf_depths.mean()),
        depth_median=float(np.median(leaf_depths)),
        depth_std=float(leaf_depths.std()),
        depth_max=int(leaf_depths.max()),
        top_leaf_sizes=sorted(leaf_sizes.tolist(), reverse=True)[:10],
        prims_in_leaves=int(leaf_sizes.sum()),
    )
