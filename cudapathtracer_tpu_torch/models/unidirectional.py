"""Unidirectional path tracer with NEE + power-2 MIS, nested dielectrics,
Beer-Lambert absorption and Russian roulette (the classic engine).

Counterpart of cudapathtracer_tpu/models/unidirectional.py:render_sample
with the same draw ids, depth rules and ray count. Raygen (K7), the RNG
(K6) and both traversals (K1) are kernels on CUDA tensors; shading, BSDF
and NEE are plain PyTorch. Each bounce works on the paths still alive:
dead paths are dropped with index_select, which leaves the image unchanged
because every draw is keyed by pixel id, never by lane.
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch.models import common
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, RAY_EPSILON,
                                                 length_sq, luminance,
                                                 normalize, to_local,
                                                 to_world)

HARD_DEPTH_CAP = 100

# rng draw ids within a bounce
_D_NEE = 0    # ..2 (light pick + 2 warp uniforms)
_D_BSDF = 4   # ..7
_D_RR = 8

# per-path state carried between bounces (all indexed by live path)
_STATE = ("lane", "pid", "depth", "o", "d", "beta", "li", "prev_pdf",
          "hit_nonspec", "prev_point", "eta_i", "eta_t", "ms_stack",
          "ms_top")


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, use_mis: bool = True,
                  sample_environment: bool = False):
    """Trace one sample for pixels (px, py) [N] (int) -> (radiance [N,3]
    float32, rays traced as a Python int)."""
    n, dev = px.shape[0], px.device
    skey = rng.sample_key(base_key, sample_idx)
    pid = rng.pixel_ids(px, py)
    o, d = camera.generate_rays(rng.fold_in(skey, 2 ** 20),
                                px.to(torch.float32), py.to(torch.float32),
                                pid)
    mats = scene.materials
    air_priority = int(mats.priority[0])
    ms0 = common.MediumStack.make(n, air_priority, device=dev)
    li_out = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    s = dict(
        lane=torch.arange(n, device=dev), pid=pid,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        li=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        prev_pdf=torch.full((n,), EPSILON, dtype=torch.float32, device=dev),
        hit_nonspec=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_point=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        eta_i=torch.full((n,), EPSILON, dtype=torch.float32, device=dev),
        eta_t=torch.full((n,), EPSILON, dtype=torch.float32, device=dev),
        ms_stack=ms0.stack, ms_top=ms0.top)
    rays = 0
    it = 0
    while it < HARD_DEPTH_CAP + 32 and s["lane"].numel() > 0:
        rays += s["lane"].numel()
        alive, s, nee_rays = _bounce(scene, mats, skey, it, s, max_depth,
                                     use_mis, sample_environment)
        rays += nee_rays
        li_out[s["lane"]] = s["li"]
        keep = torch.nonzero(alive)[:, 0]
        if keep.numel() < alive.numel():
            s = {k: s[k][keep] for k in _STATE}
        it += 1
    return li_out, rays


def _bounce(scene, mats, skey, it, s, max_depth, use_mis,
            sample_environment):
    """One bounce of every live path. Returns (alive [M], new state,
    shadow rays traced)."""
    pid = s["pid"]
    bkey = rng.bounce_key(skey, it)
    ms = common.MediumStack(s["ms_stack"], s["ms_top"])
    nee_rays = 0

    hit = traverse.closest_hit(scene, s["o"], s["d"])
    info, mat = traverse.shade_data(scene, s["o"], s["d"], hit)
    miss = ~hit.valid
    li = s["li"] + torch.where(
        miss[:, None], s["beta"] * common.sample_sky(s["d"],
                                                     sample_environment),
        0.0)
    alive = hit.valid

    mat_id = info["mat_id"]
    backface = info["backface"]
    normal = info["normal"]
    wi_local = to_local(s["d"], normal)
    albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
    trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
    is_specular = mat.is_specular

    # dominant medium + Beer-Lambert absorption
    dom_id, dom_pri = common.dominant_medium(ms)
    absorb = common.table_lookup(mats.absorption, dom_id)
    att = torch.exp(-absorb * hit.t[:, None])
    beta = torch.where((alive & (hit.t > EPSILON))[:, None],
                       s["beta"] * att, s["beta"])

    # boundary / priority logic: a lower-priority boundary crossed inside a
    # dominant medium is a false hit
    is_boundary = mat.boundary
    true_hit = ~(is_boundary & (mat.priority > dom_pri)) | ~alive
    false_hit = alive & ~true_hit

    dom_ior = common.table_lookup(mats.ior, dom_id)
    second = common.second_lowest_medium(ms, mat_id)
    eta_t_exit = torch.where(ms.top == 1, 1.0,
                             common.table_lookup(mats.ior, second))
    is_dielectric_hit = (alive & true_hit & is_boundary
                         & (mat.type == 2))  # MAT_SMOOTHDIELECTRIC
    eta_i = torch.where(is_dielectric_hit, dom_ior, s["eta_i"])
    eta_t = torch.where(is_dielectric_hit,
                        torch.where(backface, eta_t_exit, mat.ior),
                        s["eta_t"])
    non_boundary = alive & ~is_boundary
    eta_i = torch.where(non_boundary, dom_ior, eta_i)

    # false hit: push (entering) / pop (exiting) the crossed boundary
    ms = common.stack_push(ms, mat_id, mat.priority, false_hit & ~backface)
    ms = common.stack_remove(ms, mat_id, false_hit & backface)

    # emission
    emissive = length_sq(info["emission"]) > EPSILON
    direct_view = (s["depth"] == 0) | ~s["hit_nonspec"]
    shade = alive & true_hit
    add_direct = shade & emissive & direct_view
    li = li + torch.where(add_direct[:, None], beta * info["emission"], 0.0)

    if use_mis:
        # a BSDF-sampled ray hit a light: weigh against the NEE pdf
        light_pdf_hit = common.nee_pdf(scene, s["prev_point"], info["point"],
                                       info["normal_a"], info["area"])
        w_bsdf = common.power2_weight(s["prev_pdf"], light_pdf_hit)
        add_mis = (shade & emissive & ~direct_view & ~is_specular
                   & (light_pdf_hit > EPSILON))
        li = li + torch.where(add_mis[:, None],
                              beta * info["emission"] * w_bsdf[:, None], 0.0)

        # NEE from non-emissive, non-specular surfaces
        do_nee = shade & ~emissive & ~is_specular
        nee_rays = int(do_nee.sum())
        nee_c, light_pdf, wo_nee = common.next_event_estimation(
            scene, bkey, _D_NEE, info["point"], normal, wi_local, mat,
            albedo, eta_i, do_nee, ids=pid, transmission=trans)
        bsdf_pdf_nee = bsdf_ops.bsdf_pdf(mat, -wi_local, wo_nee, eta_i,
                                         transmission=trans)
        w_nee = common.power2_weight(light_pdf, bsdf_pdf_nee)
        li = li + torch.where((do_nee & (light_pdf > EPSILON))[:, None],
                              beta * nee_c * w_nee[:, None], 0.0)

    # BSDF sampling
    wo_local, f_val, pdf = bsdf_ops.bsdf_sample(
        bkey, _D_BSDF, mat, albedo, -wi_local, backface, eta_i, ids=pid,
        transmission=trans)
    pdf = torch.clamp(pdf, min=0.01)

    # medium stack push/pop on refraction through a true-hit boundary
    refracted = wo_local[..., 2] < 0.0
    ms = common.stack_push(ms, mat_id, mat.priority,
                           shade & refracted & ~backface)
    ms = common.stack_remove(ms, mat_id, shade & refracted & backface)

    new_beta = beta * f_val * (torch.abs(wo_local[..., 2]) / pdf)[:, None]
    beta = torch.where(shade[:, None], new_beta, beta)

    wo_world = normalize(to_world(wo_local, normal))
    side = torch.where(wo_local[..., 2] > 0.0, 1.0, -1.0)
    o_true = info["point"] + normal * (side * EPSILON)[:, None]
    o_false = info["point"] + s["d"] * RAY_EPSILON  # pass straight through
    o = torch.where(shade[:, None], o_true,
                    torch.where(false_hit[:, None], o_false, s["o"]))
    d = torch.where(shade[:, None], wo_world, s["d"])

    prev_pdf = torch.where(shade, pdf, s["prev_pdf"])
    prev_point = torch.where(shade[:, None], info["point"], s["prev_point"])
    depth = s["depth"] + torch.where(false_hit, 0, 1).to(torch.int32)

    # Russian roulette past max_depth
    rr_zone = alive & (depth > max_depth + 1)
    p_surv = torch.clamp(luminance(beta), 0.05, 0.99)
    u_rr = rng.uniform_id(bkey, _D_RR, pid)
    killed = rr_zone & (u_rr > p_surv)
    beta = torch.where((rr_zone & ~killed)[:, None],
                       beta / p_surv[:, None], beta)
    alive = alive & ~killed & (depth < HARD_DEPTH_CAP)
    hit_nonspec = s["hit_nonspec"] | (alive & ~is_specular)

    new = dict(lane=s["lane"], pid=pid, depth=depth, o=o, d=d, beta=beta,
               li=li, prev_pdf=prev_pdf, hit_nonspec=hit_nonspec,
               prev_point=prev_point, eta_i=eta_i, eta_t=eta_t,
               ms_stack=ms.stack, ms_top=ms.top)
    return alive, new, nee_rays
