"""Traversal entry points, the threaded binary engine, the hit record and
the hit fetch.

Counterpart of cudapathtracer_tpu/ops/traverse.py. `closest_hit`,
`shadow_factor` and `trace_fused` dispatch on the scene's traversal, as the
JAX functions do: "bvh8" goes to the BVH8 engine (ops/traverse8.py, kernel
K1), "threaded" to the threaded binary engine below (kernel K15,
kernels/csrc/traverse_bin.cu, on CUDA tensors; its plain version on CPU
tensors).

The threaded engine walks Scene.bin_table, which `threaded_table` derives
from Scene.node_packed once a scene, with one int cursor per ray and no
stack: slab-test the node's box (tmin below t_best for closest rays, below
max_t for shadow rays); on a hit of an inner node take the ray octant's
hit link (the near child), else its miss link (the rest of the tree after
this subtree); a hit leaf tests its inline triangles in slot order
(strict t < t_best, tid != skip_tri) and then continues at its miss link.
Shadow rays multiply the transmission of each MAT_LEAF triangle they cross
in slot order and stop at the first opaque hit or once the product's max
falls below 0.01. The JAX version advances the whole wavefront in lockstep
with straggler compaction and a one-hot octant select, TPU mechanism; the
plain version here advances the rays still in flight one row a step,
indexing them.

bin_table (f32, ints as bits) is two tables, so that a visit is two
sectors of one 96-byte record and a leaf's triangles are 16-byte loads:
  head [M, 24]  per node: the box (min xyz, max xyz), two zero words, then
                for each octant o the pair (hit word, miss link) at 8 + 2o.
                The hit word is the octant's hit link for an inner node
                and -2 - s for a leaf whose triangles start at slot s (so a
                hit's next cursor < -1 marks a hit leaf);
  tris [S, 12]  one record a leaf triangle, the leaves' triangles in node
                order: v0, e1, e2, the id word (bit 30 MAT_LEAF), 1 on the
                leaf's last triangle (else 0), 0.
flat: head then tris, 24 M + 12 S floats.

`shade_data` is the plain version of the hit fetch (K2, device code in
kernels/csrc/shade.cuh): one gather of the hit triangle's record of
scene.shade_table and the barycentric interpolation, the material by id
from scene.mat_f32 and a light's emission and area from its light row;
`interpolate_hit` (the BDPT walks' fetch) returns the same record without
the material fields.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIN_HEAD, BIN_TRI = 24, 12   # BIN_HEAD, BIN_TRI
from reference.tpt.ops.intersect import (aabb_intersect,
                                                    moller_trumbore,
                                                    safe_inv_dir)
from reference.tpt.utils.math import dot, normalize

LEAF_MAT_FLAG = 1 << 30


class Hit(NamedTuple):
    """Closest-hit record, all [N]."""
    t: torch.Tensor     # distance; == max_t on a miss
    tri: torch.Tensor   # permuted triangle index, -1 on a miss
    u: torch.Tensor     # barycentric weight of vertex b
    v: torch.Tensor     # barycentric weight of vertex c

    @property
    def valid(self):
        return self.tri >= 0


def _octant(d):
    """Direction sign bits: bit k set where d[k] < 0."""
    neg = (d < 0.0).to(torch.int64)
    return neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)


def threaded_table(node_packed, leaf_k: int):
    """bin_table (layout in the module docstring) from node_packed [M, W]
    of leaves of at most leaf_k triangles, on node_packed's device."""
    m, dev = node_packed.shape[0], node_packed.device
    ir = node_packed.view(torch.int32)
    count = ir[:, 22].to(torch.int64)
    first = torch.cumsum(count, 0) - count
    hit = torch.where((count > 0)[:, None], (-2 - first)[:, None],
                      ir[:, 6:14].to(torch.int64)).to(torch.int32)
    head = torch.zeros((m, BIN_HEAD), dtype=torch.int32,
                       device=dev)
    head[:, 0:6] = ir[:, 0:6]
    head[:, 8::2] = hit
    head[:, 9::2] = ir[:, 14:22]
    node = torch.repeat_interleave(torch.arange(m, device=dev), count)
    k = torch.arange(node.shape[0], device=dev) - first[node]
    cols = 24 + 9 * k[:, None] + torch.arange(9, device=dev)
    tris = torch.zeros((node.shape[0], BIN_TRI), dtype=torch.int32,
                       device=dev)
    tris[:, 0:9] = ir[node[:, None], cols]
    tris[:, 9] = ir[node, 24 + 9 * leaf_k + k]
    tris[:, 10] = (k == count[node] - 1).to(torch.int32)
    return torch.cat([head.reshape(-1), tris.reshape(-1)]).view(
        torch.float32)


def bin_tables(table, num_nodes: int):
    """The two tables of a flat bin_table: (head [M, 24], tris [S, 12])."""
    head = BIN_HEAD * num_nodes
    return (table[:head].view(-1, BIN_HEAD),
            table[head:].view(-1, BIN_TRI))


def _traverse_bin_plain(table, num_nodes, tri_f32, o, d, max_t, skip_tri,
                        active, shadow, with_counts=False):
    """Plain version of K15, both modes, over bin_table. Per-ray state
    lives in full-width tensors; each step gathers the rays in flight,
    advances them one node record and scatters them back; a hit leaf's
    triangles are tested one slot a step over the rays still in their
    leaf. with_counts also returns, per ray, the node rows visited and the
    triangle tests K15 makes (a hit leaf's triangles, for a shadow ray up
    to the one that blocks it)."""
    from reference.tpt.ops.traverse8 import leaf_factor
    head, tris = bin_tables(table, num_nodes)
    ihead, itris = head.view(torch.int32), tris.view(torch.int32)
    n, dev = o.shape[0], o.device
    inv_d = safe_inv_dir(d)
    # the columns of each ray's octant's (hit word, miss link)
    pair = 8 + 2 * _octant(d)[:, None] + torch.arange(2, device=dev)
    cur = torch.zeros(n, dtype=torch.int32, device=dev)
    if active is not None:
        cur = torch.where(active, cur, -1)
    t_best = max_t.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    scale = torch.ones((n, 3), dtype=torch.float32, device=dev)
    with_leaf = tri_f32 is not None and tri_f32.shape[1] >= 94
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    tests = torch.zeros(n, dtype=torch.int32, device=dev)
    while True:
        live = torch.nonzero(cur >= 0)[:, 0]
        if live.numel() == 0:
            break
        if with_counts:
            rows[live] += 1
        at = cur[live].long()
        rec = head[at]
        links = ihead[at].gather(1, pair[live])
        t_cut = max_t[live] if shadow else t_best[live]
        tmin, _, hit = aabb_intersect(o[live], inv_d[live], rec[:, 0:3],
                                      rec[:, 3:6])
        hit = hit & (tmin < t_cut)
        miss = links[:, 1]
        nxt = torch.where(hit, links[:, 0], miss)
        pos = torch.nonzero(nxt < -1)[:, 0]       # the hit leaves
        slot = (-2 - nxt[pos]).long()
        after = miss.clone()          # a hit leaf's next cursor
        while pos.numel():            # one triangle slot a step
            lane = live[pos]
            tv, raw = tris[slot], itris[slot, 9]
            last = itris[slot, 10] != 0
            tid = torch.where(raw < 0, -1, raw & ~LEAF_MAT_FLAG)
            ld = d[lane]
            tt, uu, vv, ok = moller_trumbore(o[lane], ld, tv[:, 0:3],
                                             tv[:, 3:6], tv[:, 6:9])
            ok = ok & (tid >= 0) & (tid != skip_tri[lane])
            if with_counts:
                tests[lane] += 1
            if not shadow:
                ok = ok & (tt < t_best[lane])
                t_best[lane] = torch.where(ok, tt, t_best[lane])
                tri[lane] = torch.where(ok, tid, tri[lane])
                u[lane] = torch.where(ok, uu, u[lane])
                v[lane] = torch.where(ok, vv, v[lane])
                done = last
            else:
                ok = ok & (tt < max_t[lane])
                stop = ok
                if with_leaf:
                    lm = (raw & LEAF_MAT_FLAG) != 0
                    sc = torch.where((ok & lm)[:, None], scale[lane]
                                     * leaf_factor(tri_f32, ld, uu, vv, tid),
                                     scale[lane])
                    scale[lane] = sc
                    stop = ok & (~lm | (sc.amax(dim=1) < 0.01))
                scale[lane[stop]] = 0.0       # occlusion is final
                after[pos[stop]] = -1
                done = last | stop
            pos, slot = pos[~done], slot[~done] + 1
        nxt = torch.where(nxt < -1, after, nxt)
        cur[live] = nxt
    out = (scale,) if shadow else (t_best, tri, u, v)
    if with_counts:
        return out + (rows, tests)
    return out[0] if shadow else out


def closest_hit_bin_plain(table, num_nodes, o, d, max_t, skip_tri, active,
                          with_counts=False):
    """Plain version of K15 closest over bin_table -> (t, tri, u, v), and
    with with_counts the rows visited and triangle tests per ray [N] i32."""
    return _traverse_bin_plain(table, num_nodes, None, o, d, max_t,
                               skip_tri, active, shadow=False,
                               with_counts=with_counts)


def shadow_factor_bin_plain(table, num_nodes, tri_f32, o, d, max_t,
                            skip_tri, active, with_counts=False):
    """Plain version of K15 shadow -> scale [N,3], and with with_counts
    (scale, rows, tests) as closest_hit_bin_plain."""
    return _traverse_bin_plain(table, num_nodes, tri_f32, o, d, max_t,
                               skip_tri, active, shadow=True,
                               with_counts=with_counts)


def closest_hit(scene, o, d, max_t=None, skip_tri=None, active=None) -> Hit:
    """Closest hit of rays o, d [N,3] (d normalized) on the scene's engine.
    max_t: scalar or [N]; skip_tri: [N] triangle to ignore; active: [N]
    bool rays to trace. Misses keep t = max_t and tri = -1."""
    from reference.tpt.ops import traverse8
    if scene.traversal == "bvh8":
        return traverse8.closest_hit8(scene, o, d, max_t, skip_tri, active)
    o, d, max_t, skip_tri = traverse8.ray_inputs(o, d, max_t, skip_tri)
    fn = closest_hit_bin_plain
    return Hit(*fn(scene.bin_table, scene.node_packed.shape[0], o, d, max_t,
                   skip_tri, active))


def shadow_factor(scene, o, d, max_t, skip_tri=None, active=None):
    """Any-hit shadow with MAT_LEAF transmission on the scene's engine ->
    scale [N,3]: 1 clear, 0 occluded, else the transmission product. Rays
    not active keep 1."""
    from reference.tpt.ops import traverse8
    if scene.traversal == "bvh8":
        return traverse8.shadow_factor8(scene, o, d, max_t, skip_tri, active)
    o, d, max_t, skip_tri = traverse8.ray_inputs(o, d, max_t, skip_tri)
    fn = shadow_factor_bin_plain
    return fn(scene.bin_table, scene.node_packed.shape[0], scene.tri_f32, o,
              d, max_t, skip_tri, active)


def shadow_factor_rows(scene, o, d, max_t, active):
    """shadow_factor of R ray sets of one width N in one traversal: o, d
    [R, N, 3], max_t and active [R, N] -> scale [R, N, 3]. Each ray's scale
    is what its own call would give (the traversal is per ray); one call
    instead of R spares the plain version R - 1 loops over the rows."""
    r, n = active.shape
    scale = shadow_factor(scene, o.reshape(r * n, 3), d.reshape(r * n, 3),
                          max_t.reshape(r * n), active=active.reshape(r * n))
    return scale.reshape(r, n, 3)


def trace_fused(scene, o, d, t_lim, is_shadow, skip_tri=None, active=None):
    """Closest rays (is_shadow False: t_lim is the initial t_best) and
    shadow rays (t_lim is max_t) of one batch -> (Hit, scale [N,3]). On
    either engine, the two entries on their own lanes: the JAX BVH8
    engine's mixed loop is a lockstep schedule, and its threaded engine
    makes the same two calls."""
    act = torch.ones_like(is_shadow) if active is None else active
    hit = closest_hit(scene, o, d, max_t=t_lim, skip_tri=skip_tri,
                      active=act & ~is_shadow)
    scale = shadow_factor(scene, o, d, t_lim, skip_tri=skip_tri,
                          active=act & is_shadow)
    return hit, scale


def _i32(x):
    return x.contiguous().view(torch.int32)


def mat_rows(scene, mat_id):
    """The MaterialTable rows of mat_id [N] from scene.mat_f32 (its layout
    is the JAX shade row's columns 20:46, bit for bit)."""
    from reference.tpt.scene.materials import MaterialTable

    row = scene.mat_f32[mat_id]                               # [N,26]
    ints = _i32(row)
    return MaterialTable(
        type=ints[:, 0],
        albedo=row[:, 1:4],
        roughness=row[:, 4],
        eta=row[:, 5:8],
        k=row[:, 8:11],
        ior=row[:, 11],
        transmission=row[:, 12],
        is_specular=ints[:, 13] != 0,
        boundary=ints[:, 14] != 0,
        thin_walled=ints[:, 15] != 0,
        absorption=row[:, 16:19],
        priority=ints[:, 19],
        tex_start=ints[:, 20],
        tex_width=ints[:, 21],
        tex_height=ints[:, 22],
        trans_tex_start=ints[:, 23],
        trans_tex_width=ints[:, 24],
        trans_tex_height=ints[:, 25],
    )


def shade_data(scene, o, d, hit: Hit):
    """The hit fetch: one gather of the hit triangle's 64-byte record of
    scene.shade_table (layout: scene/scene.py shade_table) -> (info dict,
    per-hit MaterialTable rows). The material is mat_id's row of mat_f32;
    emission and area are the hit light's (light_f32 columns 12:15 and 15;
    zero off the lights, where no caller reads the area), normal_a the
    vertex-a normal, as the JAX shade row holds them."""
    rec = scene.shade_table[torch.clamp(hit.tri, min=0)]     # [N,16]
    w0 = 1.0 - hit.u - hit.v
    u, v = hit.u[:, None], hit.v[:, None]
    nrm = normalize(rec[:, 0:3] * w0[:, None] + rec[:, 3:6] * u
                    + rec[:, 6:9] * v)
    backface = dot(nrm, d) > 0.0
    nrm = torch.where(backface[:, None], -nrm, nrm)
    uv = rec[:, 9:11] * w0[:, None] + rec[:, 11:13] * u + rec[:, 13:15] * v
    word = _i32(rec[:, 15])
    mat_id = word & 1023
    light = word >> 10
    lit = light >= 0
    lrow = scene.light_f32[torch.clamp(light, min=0)]
    info = dict(
        point=o + d * hit.t[:, None],
        normal=nrm,
        uv=uv,
        emission=torch.where(lit[:, None], lrow[:, 12:15], 0.0),
        light_ind=light,
        mat_id=mat_id,
        backface=backface,
        valid=hit.valid,
        t=hit.t,
        tri=hit.tri,
        normal_a=rec[:, 0:3],   # vertex-a normal and area: the light's
        area=torch.where(lit, lrow[:, 15], 0.0),  # for the NEE counter-pdf
    )
    return info, mat_rows(scene, mat_id)


def interpolate_hit(scene, o, d, hit: Hit) -> dict:
    """Counterpart of the JAX package's interpolate_hit: the interpolated
    shading data at hit points (point, normal flipped toward the ray, uv,
    emission, mat_id, light_ind, backface, valid, t, tri). The JAX function
    gathers the per-triangle columns; the shading record holds the same
    normals, uvs and ids, interpolated in the same order, and a light's row
    the same emission, so this is shade_data's record."""
    info, _ = shade_data(scene, o, d, hit)
    keys = ("point", "normal", "uv", "emission", "mat_id", "light_ind",
            "backface", "valid", "t", "tri")
    return {k: info[k] for k in keys}
