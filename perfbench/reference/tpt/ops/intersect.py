"""Ray-triangle and ray-box tests over ray batches, plus the brute-force
closest-hit oracle. Counterpart of cudapathtracer_tpu/ops/intersect.py."""

from __future__ import annotations

import torch

from reference.tpt.utils.math import cross, dot

BIG_T = 999999.0  # default max_t
DET_EPS = 1e-12   # |det| cutoff


def moller_trumbore(o, d, v0, e1, e2):
    """Möller-Trumbore on packed triangles (vertex a, b-a, c-a), all
    broadcastable [..., 3]. Returns (t, u, v, ok); the hit point is
    v0*(1-u-v) + v1*u + v2*v."""
    h = cross(d, e2)
    a = dot(h, e1)
    ok_det = torch.abs(a) >= DET_EPS
    f = 1.0 / torch.where(ok_det, a, torch.ones_like(a))
    s = o - v0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, ok


def aabb_intersect(o, inv_d, bmin, bmax):
    """Branchless slab test. Returns (tmin, tmax, hit)."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return tmin, tmax, (tmax >= tmin) & (tmax > 0.0)


def safe_inv_dir(d):
    """1/d with sign-preserving huge values instead of inf."""
    s = torch.where(d >= 0.0, 1.0, -1.0).to(d.dtype)
    return s / torch.clamp(torch.abs(d), min=1e-30)


def brute_force_closest_hit(o, d, tri_v0, tri_e1, tri_e2, max_t=BIG_T,
                            skip_tri=None):
    """O(N*T) closest hit over all triangles: the traversal test oracle.
    Returns (t, tri, u, v); tri = -1 and t = max_t on a miss."""
    n, tcount = o.shape[0], tri_v0.shape[0]
    t, u, v, ok = moller_trumbore(o[:, None], d[:, None], tri_v0[None],
                                  tri_e1[None], tri_e2[None])
    if skip_tri is not None:
        ids = torch.arange(tcount, dtype=torch.int32, device=o.device)
        ok = ok & (ids[None, :] != skip_tri[:, None])
    max_t = torch.as_tensor(max_t, dtype=torch.float32,
                            device=o.device).expand(n)
    t = torch.where(ok & (t < max_t[:, None]), t,
                    torch.full_like(t, BIG_T * 2))
    best = torch.argmin(t, dim=1)
    lane = torch.arange(n, device=o.device)
    bt = t[lane, best]
    hit = bt < BIG_T * 2
    tri = torch.where(hit, best.to(torch.int32), -1)
    out_t = torch.where(hit, bt, max_t)
    return out_t, tri, u[lane, best], v[lane, best]
