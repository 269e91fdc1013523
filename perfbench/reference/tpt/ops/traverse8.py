"""BVH8 closest-hit and shadow traversal: kernel K1 and its plain version.

Counterpart of cudapathtracer_tpu/ops/traverse8.py:closest_hit8 and
shadow_factor8 over the same hybrid CBVH table (scene/bvh8.py, [R, 96]).
`closest_hit8` / `shadow_factor8` launch kernels/csrc/traverse8.cu for CUDA
tensors and run the plain PyTorch version below for CPU tensors.

The plain version is a vectorised transcription of the JAX traversal, one
row per ray per step: descend into the nearest child, push the others far
to near on a STACK_D-entry stack (a ring, so an overflow keeps the newest
entries), restart a ray whose stack overflowed once it drains (at most 3
times), ties between a row's triangles to the first slot, MAT_LEAF
transmission products for shadow rays with the 0.01 cut-off. Each step
works on the rays still in flight. It has the JAX version's arithmetic but
neither its lane-major layout nor its straggler compaction.
"""

from __future__ import annotations

import torch

from reference.tpt.ops.intersect import (BIG_T, DET_EPS,
                                                    safe_inv_dir)
from reference.tpt.ops.traverse import LEAF_MAT_FLAG, Hit

STACK_D = 16   # kernels.STACK_D, as the JAX traversal's default
MAX_RESTARTS = 3
ROW_W = 96        # scene/bvh8.py row_width(4)
TRI_OFF = 50      # scene/bvh8.py TRI_OFF
LEAF_TRIS = 4
KEY_INVALID = 0x7FFFFFFF


def ray_inputs(o, d, max_t, skip_tri):
    n = o.shape[0]
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    if max_t is None:
        max_t = BIG_T
    max_t = torch.as_tensor(max_t, dtype=torch.float32, device=o.device)
    max_t = max_t.expand(n).contiguous()
    if skip_tri is None:
        skip_tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    return o, d, max_t, skip_tri.to(torch.int32).contiguous()


def _pop(stack, sp, top, direct):
    want = (direct < 0) & (top > 0)
    popped = stack.gather(1, ((sp - 1) % STACK_D)[:, None])[:, 0]
    entry = torch.where(direct >= 0, direct,
                        torch.where(want, popped, -1))
    return entry, torch.where(want, sp - 1, sp), torch.where(want, top - 1,
                                                             top)


def _node_stage(rows, o, inv_d, t_cut, valid):
    """Slab-test the 8 child slots, sort the packed (tmin bits | slot) keys.
    Returns (nearest child row or -1, [M,7] deferred rows near-first,
    count of deferred)."""
    m = rows.shape[0]
    b = rows[:, 0:48].reshape(m, 6, 8)
    t1 = (b[:, 0:3] - o[:, :, None]) * inv_d[:, :, None]   # [M,3,8]
    t2 = (b[:, 3:6] - o[:, :, None]) * inv_d[:, :, None]
    tmin8 = torch.minimum(t1, t2).amax(dim=1)              # [M,8]
    tmax8 = torch.maximum(t1, t2).amin(dim=1)
    hit8 = (tmax8 >= tmin8) & (tmax8 > 0.0) & (tmin8 < t_cut[:, None])
    base = rows[:, 48].contiguous().view(torch.int32)
    # IEEE total order: negative patterns get their low 31 bits flipped
    tb = tmin8.contiguous().view(torch.int32)
    tb = torch.where(tb >= 0, tb, tb ^ 0x7FFFFFFF)
    slots = torch.arange(8, dtype=torch.int32, device=rows.device)
    key = torch.where(valid[:, None] & hit8, (tb & ~7) | slots, KEY_INVALID)
    ks = torch.sort(key, dim=1).values
    g = ks != KEY_INVALID
    metas = torch.where(g, base[:, None] + (ks & 7), -1)
    return metas[:, 0], metas[:, 1:], g[:, 1:].sum(dim=1)


def _push(stack, sp, top, deferred, count):
    """Push count[m] near-first deferred entries far to near, so the
    nearest pops first; a full ring overwrites its oldest entries."""
    stack = stack.clone()
    for j in range(deferred.shape[1] - 1, -1, -1):
        m = j < count
        pos = (sp % STACK_D)[:, None]
        old = stack.gather(1, pos)[:, 0]
        stack.scatter_(1, pos, torch.where(m, deferred[:, j], old)[:, None])
        sp = sp + m
    new_top = top + count
    return stack, sp, torch.clamp(new_top, max=STACK_D), new_top > STACK_D


def _leaf_tris(rows, o, d, t_cut, skip_tri, valid):
    """Möller-Trumbore on the row's 4 inline triangles ([M,4] each)."""
    m = rows.shape[0]
    tri = rows[:, TRI_OFF:TRI_OFF + 9 * LEAF_TRIS].reshape(m, LEAF_TRIS, 9)
    raw = rows[:, TRI_OFF + 9 * LEAF_TRIS:TRI_OFF + 10 * LEAF_TRIS]
    raw = raw.contiguous().view(torch.int32)
    tid = torch.where(raw < 0, -1, raw & ~LEAF_MAT_FLAG)
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = hx * e1x + hy * e1y + hz * e1z
    ok_det = torch.abs(a) >= DET_EPS
    f = 1.0 / torch.where(ok_det, a, torch.ones_like(a))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & valid[:, None] & (tid >= 0) & (t < t_cut[:, None])
          & (tid != skip_tri[:, None]))
    return t, u, v, ok, tid, raw


def _leaf_closest(tt, uu, vv, ok, tid, t_best, tri, u, v):
    """Fold the row's best hit in; the smallest (t bits & ~3) | slot wins,
    so near-ties go to the first slot."""
    sl = torch.arange(LEAF_TRIS, dtype=torch.int32, device=tt.device)
    tb = torch.clamp(tt, min=0.0).contiguous().view(torch.int32)
    keys = torch.where(ok, (tb & ~3) | sl, KEY_INVALID)
    kmin, win = keys.min(dim=1)
    hit = kmin != KEY_INVALID
    pick = lambda a: a.gather(1, win[:, None])[:, 0]
    return (torch.where(hit, pick(tt), t_best),
            torch.where(hit, pick(tid), tri),
            torch.where(hit, pick(uu), u), torch.where(hit, pick(vv), v))


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def leaf_factor(tri_f32, d, u, v, tid):
    """The transmission of MAT_LEAF triangles tid [M] crossed by rays d
    [M,3] at (u, v) [M]: albedo * (transmission * (1 - Schlick)) through
    the interpolated normal -> [M,3] (both engines' product)."""
    sr = tri_f32[torch.clamp(tid, min=0), 78:94]
    w0 = 1.0 - u - v
    nx = sr[:, 0] * w0 + sr[:, 3] * u + sr[:, 6] * v
    ny = sr[:, 1] * w0 + sr[:, 4] * u + sr[:, 7] * v
    nz = sr[:, 2] * w0 + sr[:, 5] * u + sr[:, 8] * v
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=1e-20))
    cos_t = torch.abs(d[:, 0] * nx + d[:, 1] * ny + d[:, 2] * nz) * inv_len
    ior = sr[:, 13]
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    fres = r0 + (1.0 - r0) * _pow5(1.0 - cos_t)
    tmul = sr[:, 12] * (1.0 - fres)
    return sr[:, 9:12] * tmul[:, None]


def _leaf_shadow(tri_f32, d, uu, vv, ok, tid, raw, scale):
    """Fold the row's occlusions into scale [M,3]; returns (scale,
    blocked). MAT_LEAF triangles transmit (leaf_factor); anything else
    blocks."""
    if tri_f32.shape[1] < 94:   # no MAT_LEAF material in the scene
        blocked = ok.any(dim=1)
    else:
        is_leaf_mat = (raw >= 0) & ((raw & LEAF_MAT_FLAG) != 0)
        factor = torch.ones_like(scale)
        opaque = torch.zeros_like(ok[:, 0])
        any_leaf = torch.zeros_like(ok[:, 0])
        for j in range(LEAF_TRIS):
            okj, lm = ok[:, j], is_leaf_mat[:, j]
            pass_leaf = okj & lm
            factor = factor * torch.where(
                pass_leaf[:, None],
                leaf_factor(tri_f32, d, uu[:, j], vv[:, j], tid[:, j]), 1.0)
            opaque = opaque | (okj & ~lm)
            any_leaf = any_leaf | pass_leaf
        scale = scale * factor
        dark = scale.amax(dim=1) < 0.01
        blocked = opaque | (any_leaf & dark)
    return torch.where(blocked[:, None], 0.0, scale), blocked


def _traverse_plain(table, tri_f32, o, d, max_t, skip_tri, active, shadow,
                    with_restarts=False):
    """Plain version of K1: both modes. Per-ray state lives in full-width
    tensors; each step gathers the rays in flight, advances them one row
    and scatters them back."""
    n, dev = o.shape[0], o.device
    inv_d = safe_inv_dir(d)
    direct = torch.zeros(n, dtype=torch.int32, device=dev)
    if active is not None:
        direct = torch.where(active, direct, -1)
    st = dict(direct=direct,
              top=torch.zeros(n, dtype=torch.int64, device=dev),
              sp=torch.zeros(n, dtype=torch.int64, device=dev),
              lostc=torch.zeros(n, dtype=torch.int32, device=dev),
              stack=torch.zeros((n, STACK_D), dtype=torch.int32, device=dev),
              t_cut=max_t.clone(),
              tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
              u=torch.zeros(n, dtype=torch.float32, device=dev),
              v=torch.zeros(n, dtype=torch.float32, device=dev),
              scale=torch.ones((n, 3), dtype=torch.float32, device=dev))
    while True:
        live = torch.nonzero((st["direct"] >= 0) | (st["top"] > 0))[:, 0]
        if live.numel() == 0:
            break
        s = {k: x[live] for k, x in st.items()}
        lo, ld, linv, lskip = o[live], d[live], inv_d[live], skip_tri[live]

        entry, s["sp"], s["top"] = _pop(s["stack"], s["sp"], s["top"],
                                        s["direct"])
        valid = entry >= 0
        rows = table[torch.clamp(entry, min=0)]
        new_direct, deferred, count = _node_stage(rows, lo, linv, s["t_cut"],
                                                  valid)
        s["stack"], s["sp"], s["top"], lost = _push(
            s["stack"], s["sp"], s["top"], deferred, count)
        lostc = torch.where(lost, s["lostc"] | 1, s["lostc"])

        tt, uu, vv, ok, tid, raw = _leaf_tris(rows, lo, ld, s["t_cut"],
                                              lskip, valid)
        direct = new_direct
        if shadow:
            s["scale"], blocked = _leaf_shadow(tri_f32, ld, uu, vv, ok, tid,
                                               raw, s["scale"])
            s["top"] = torch.where(blocked, 0, s["top"])
            direct = torch.where(blocked, -1, direct)
            lostc = torch.where(blocked, 0, lostc)
        else:
            s["t_cut"], s["tri"], s["u"], s["v"] = _leaf_closest(
                tt, uu, vv, ok, tid, s["t_cut"], s["tri"], s["u"], s["v"])

        # drained with a pending loss: restart from the root
        restarts = lostc >> 1
        redo = ((direct < 0) & (s["top"] <= 0) & ((lostc & 1) == 1)
                & (restarts < MAX_RESTARTS))
        s["direct"] = torch.where(redo, 0, direct)
        s["lostc"] = torch.where(redo, (restarts + 1) << 1, lostc)
        if shadow:
            s["scale"] = torch.where(redo[:, None], 1.0, s["scale"])
        for k, x in s.items():
            st[k][live] = x
    if shadow:
        return st["scale"]
    out = st["t_cut"], st["tri"], st["u"], st["v"]
    return (*out, st["lostc"] >> 1) if with_restarts else out


def closest_hit8_plain(table, o, d, max_t, skip_tri, active,
                       with_restarts=False):
    """Plain version of K1 closest -> (t, tri, u, v); with with_restarts,
    also each ray's number of restarts from the root."""
    return _traverse_plain(table, None, o, d, max_t, skip_tri, active,
                           shadow=False, with_restarts=with_restarts)


def shadow_factor8_plain(table, tri_f32, o, d, max_t, skip_tri, active):
    """Plain version of K1 shadow -> scale [N,3]."""
    return _traverse_plain(table, tri_f32, o, d, max_t, skip_tri, active,
                           shadow=True)


def closest_hit8(scene, o, d, max_t=None, skip_tri=None, active=None) -> Hit:
    """BVH8 closest hit. o, d: [N,3]; max_t: scalar or [N]; skip_tri: [N]
    triangle to ignore; active: [N] bool rays to trace. Misses keep
    t = max_t and tri = -1."""
    o, d, max_t, skip_tri = ray_inputs(o, d, max_t, skip_tri)
    out = closest_hit8_plain(scene.bvh8_table, o, d, max_t, skip_tri,
                             active)
    return Hit(*out)


def shadow_factor8(scene, o, d, max_t, skip_tri=None, active=None):
    """BVH8 any-hit shadow with MAT_LEAF transmission -> scale [N,3]:
    1 clear, 0 occluded, else the transmission product. Rays not active
    keep 1."""
    o, d, max_t, skip_tri = ray_inputs(o, d, max_t, skip_tri)
    return shadow_factor8_plain(scene.bvh8_table, scene.tri_f32, o, d,
                                max_t, skip_tri, active)
