"""Integrator helpers: sky, light sampling, NEE, power-2 MIS, medium stack.

Counterpart of cudapathtracer_tpu/models/common.py:80-325, in plain
PyTorch over [N] lanes. The JAX package's bounce-level straggler
compaction (`compacted_loop`) is not ported: the integrator drops dead
paths with index_select instead, which no image can see because every
draw is keyed by pixel id.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.tpt.ops import bsdf as bsdf_ops
from reference.tpt.utils import rng
from reference.tpt.utils.math import (EPSILON, build_frame, dot,
                                                 length_sq, normalize)

MEDIUM_STACK_SIZE = 16
_NO_MEDIUM = 2 ** 30   # packed entry that never wins a min


def sample_sky(d, enabled: bool = False):
    """Gradient sky; the reference ships it disabled (black)."""
    if not enabled:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    unit = normalize(d)
    t = 0.5 * (unit[..., 1] + 1.0)
    c_horizon = d.new_tensor([1.0, 0.4, 0.2])
    c_zenith = d.new_tensor([0.3, 0.4, 0.8])
    return (1.0 - t)[..., None] * c_horizon + t[..., None] * c_zenith


class LightSample(NamedTuple):
    point: torch.Tensor      # [N,3]
    normal: torch.Tensor     # [N,3]
    emission: torch.Tensor   # [N,3]
    area: torch.Tensor       # [N]
    tri: torch.Tensor        # [N] permuted triangle index of the light


def table_lookup(col, ids):
    return col[ids]


def sample_light_point(scene, key, draw_base, n, ids=None) -> LightSample:
    """Uniform light pick + area sample with the sqrt warp:
    p = (1-u) a + u (1-v) b + u v c, u = sqrt(rand)."""
    ul = rng.uniform_any(key, draw_base + 0, n, ids)
    u = torch.sqrt(rng.uniform_any(key, draw_base + 1, n, ids))
    v = rng.uniform_any(key, draw_base + 2, n, ids)
    num = max(scene.num_lights, 1)
    idx = torch.clamp((ul * num).to(torch.int32), max=num - 1)
    r = scene.light_f32[idx]
    a, b, c = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    p = ((1.0 - u)[:, None] * a + (u * (1.0 - v))[:, None] * b
         + (u * v)[:, None] * c)
    return LightSample(point=p, normal=r[:, 9:12], emission=r[:, 12:15],
                       area=r[:, 15],
                       tri=r[:, 16].contiguous().view(torch.int32))


def nee_pdf(scene, from_point, light_point, light_normal, light_area):
    """Solid-angle pdf of NEE picking this light point from `from_point`:
    d^2 / (cos_l * num_lights * A); negative when the light faces away."""
    stl = light_point - from_point
    wi = normalize(stl)
    d2 = length_sq(stl)
    cos_l = dot(light_normal, -wi)
    denom = cos_l * max(scene.num_lights, 1) * light_area
    sign = torch.where(denom >= 0, 1.0, -1.0)
    return d2 / (sign * torch.clamp(torch.abs(denom), min=1e-20))


class NEESample(NamedTuple):
    """An NEE connection with everything but the shadow trace resolved."""
    contrib: torch.Tensor    # [N,3] f*Le*cos/pdf, gated, unshadowed
    light_pdf: torch.Tensor  # [N]
    wo_local: torch.Tensor   # [N,3] light direction in shading space
    origin: torch.Tensor     # [N,3] shadow ray origin
    dir: torch.Tensor        # [N,3] shadow ray direction
    max_t: torch.Tensor      # [N]
    active: torch.Tensor     # [N] worth tracing


def _safe(x, eps=1e-20):
    sign = torch.where(x >= 0, 1.0, -1.0)
    return sign * torch.clamp(torch.abs(x), min=eps)


def nee_sample(scene, key, draw_base, point, normal, wi_local, mat, albedo,
               eta_i, active, ids=None, transmission=None) -> NEESample:
    """Light sample + unshadowed NEE contribution."""
    n = point.shape[0]
    if scene.num_lights == 0:
        z = torch.zeros((n, 3), dtype=torch.float32, device=point.device)
        return NEESample(z, torch.full((n,), -1.0, device=point.device), z,
                         point, z, torch.zeros(n, device=point.device),
                         torch.zeros(n, dtype=torch.bool,
                                     device=point.device))
    ls = sample_light_point(scene, key, draw_base, n, ids)
    stl = ls.point - point
    wi = normalize(stl)
    dist = torch.sqrt(torch.clamp(length_sq(stl), min=0.0))
    origin = point + wi * EPSILON
    # measured from the offset origin; the extra EPSILON keeps the light
    # itself outside the occlusion test
    max_t = (dist - EPSILON) * (1.0 - EPSILON)
    light_pdf = nee_pdf(scene, point, ls.point, ls.normal, ls.area)
    cos_surf = torch.abs(dot(normal, wi))
    t, b = build_frame(normal)
    wo_local = torch.stack([dot(wi, t), dot(wi, b), dot(wi, normal)], dim=-1)
    f_val = bsdf_ops.bsdf_f(mat, albedo, -wi_local, wo_local, eta_i,
                            transmission=transmission)
    contrib = f_val * ls.emission * (cos_surf / _safe(light_pdf))[:, None]
    gate = (light_pdf > EPSILON) & active
    contrib = torch.where(gate[:, None], contrib, 0.0)
    return NEESample(contrib, light_pdf, wo_local, origin, wi, max_t, gate)


def power2_weight(p, q):
    """Power-2 MIS heuristic p^2/(p^2+q^2) in the overflow-safe form
    1/(1+(q/p)^2)."""
    r = q / torch.clamp(p, min=1e-30)
    w = 1.0 / (1.0 + r * r)
    return torch.where(p > 0.0, w, 0.0)


# --- medium stack (nested dielectrics) --------------------------------------

class MediumStack(NamedTuple):
    """[N, S] stack of packed (priority << 10 | mat_id) entries + [N] top
    counter; slot 0 is always the ambient medium."""
    stack: torch.Tensor
    top: torch.Tensor

    @staticmethod
    def make(n: int, air_priority: int = 0, size: int = MEDIUM_STACK_SIZE,
             device="cpu") -> "MediumStack":
        stack = torch.zeros((n, size), dtype=torch.int32, device=device)
        stack[:, 0] = int(air_priority) << 10
        return MediumStack(stack, torch.ones(n, dtype=torch.int32,
                                             device=device))


def _pack_medium(mat_id, priority):
    return (priority.to(torch.int32) << 10) | mat_id


def stack_push(ms: MediumStack, mat_id, priority, mask) -> MediumStack:
    s = ms.stack.shape[1]
    slots = torch.arange(s, device=ms.stack.device)[None, :]
    can = mask & (ms.top < s)
    put = can[:, None] & (slots == ms.top[:, None])
    stack = torch.where(put, _pack_medium(mat_id, priority)[:, None],
                        ms.stack)
    return MediumStack(stack, ms.top + can.to(torch.int32))


def stack_remove(ms: MediumStack, mat_id, mask) -> MediumStack:
    """Remove the topmost occurrence of mat_id (never slot 0), shifting
    the entries above it down."""
    s = ms.stack.shape[1]
    slots = torch.arange(s, device=ms.stack.device)[None, :]
    live = (slots > 0) & (slots < ms.top[:, None])
    match = ((ms.stack & 1023) == mat_id[:, None]) & live
    i_found = torch.where(match, slots, -1).amax(dim=1)
    found = (i_found >= 0) & mask
    shift_from = slots >= i_found[:, None]
    shifted = torch.roll(ms.stack, -1, dims=1)
    stack = torch.where(found[:, None] & shift_from, shifted, ms.stack)
    return MediumStack(stack, ms.top - found.to(torch.int32))


def dominant_medium(ms: MediumStack):
    """The lowest-priority-value medium on the stack (one min over packed
    entries; equal priorities resolve to the lowest mat_id).
    Returns (mat_id [N], priority [N])."""
    s = ms.stack.shape[1]
    slots = torch.arange(s, device=ms.stack.device)[None, :]
    live = slots < ms.top[:, None]
    best = torch.where(live, ms.stack, _NO_MEDIUM).amin(dim=1)
    return best & 1023, best >> 10


def second_lowest_medium(ms: MediumStack, exclude_mat):
    """The dominant medium ignoring `exclude_mat`, for etaT on exit. Keeps
    the reference quirk of also skipping priority-0 entries; defaults to
    slot 0 (air)."""
    s = ms.stack.shape[1]
    slots = torch.arange(s, device=ms.stack.device)[None, :]
    live = slots < ms.top[:, None]
    consider = (live & ((ms.stack & 1023) != exclude_mat[:, None])
                & ((ms.stack >> 10) != 0))
    best = torch.where(consider, ms.stack, _NO_MEDIUM).amin(dim=1)
    return torch.where(best == _NO_MEDIUM, ms.stack[:, 0] & 1023,
                       best & 1023)
