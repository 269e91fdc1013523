"""Unidirectional path tracer with NEE + power-2 MIS, nested dielectrics,
Beer-Lambert absorption and Russian roulette (the classic engine), and the
plain version both engines share.

Counterpart of cudapathtracer_tpu/models/unidirectional.py:render_sample
with the same draw ids, depth rules and ray count. On CUDA tensors a
sample is one launch of the per-path megakernel (K5,
kernels/csrc/uni_mega.cu) with the classic draw schedule. On CPU tensors
it is the plain version below: a per-bounce loop over the live paths that
reuses ops/bsdf.py, models/common.py, ops/traverse.shade_data and the plain
traversal of the scene's engine (ops/traverse: BVH8 or, on a
traversal="threaded" scene, the threaded engine; the mega schedule traces
BVH8 on every scene, as the JAX mega engine's fused step and K5 do). Each
bounce works on the paths still alive: dead paths are
dropped with index_select, which leaves the image unchanged because every
draw is keyed by the path, never by lane. On the card one sample is one
launch of K5 with k = 1, and a batch of k samples (models/batch.py) one
launch with k (render_batch).

The mega engine (models/unidirectional_mega.py) is the same estimator with
another draw schedule, so `render_plain` serves both:
  classic: draw d of bounce `it` keyed by draw_key(bounce_key(skey, it), d)
           with the pixel id; at most HARD_DEPTH_CAP + 32 bounces; rays
           count every NEE candidate; NEE adds beta * (contrib * shadow) * w;
  mega:    keyed by draw_key(skey, d) with the path's list index * 191 +
           it (its event counter `lit`); one more event (the JAX lane dies
           after the event with lit >= LIT_CAP); rays count traced NEE
           shadows; NEE adds ((beta * contrib) * w) * shadow, the JAX
           engine's pending weight scaled when its shadow drains; each
           path's radiance retires through RGB9E5 (utils/packing.py), as
           the JAX engine's retirement slots hold it.
"""

from __future__ import annotations

import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import common
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import traverse, traverse8
from cudapathtracer_tpu_torch.utils import packing, rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, RAY_EPSILON,
                                                 length_sq, luminance,
                                                 normalize, to_local,
                                                 to_world)
from cudapathtracer_tpu_torch.utils.metrics import span

HARD_DEPTH_CAP = 100
LIT_CAP = HARD_DEPTH_CAP + 32   # the mega engine's event cap
ID_STRIDE = 191                 # mega draw ids: index * ID_STRIDE + lit
# events a path may take, by schedule
MAX_EVENTS = {"classic": HARD_DEPTH_CAP + 32, "mega": LIT_CAP + 1}

# rng draw ids within a bounce
_D_NEE = 0    # ..2 (light pick + 2 warp uniforms)
_D_BSDF = 4   # ..7
_D_RR = 8

# per-path state carried between bounces (all indexed by live path)
_STATE = ("lane", "pid", "depth", "o", "d", "beta", "li", "prev_pdf",
          "hit_nonspec", "prev_point", "eta_i", "eta_t", "ms_stack",
          "ms_top")


# the model whose step a schedule of K5 runs: its stages' program spans
# (utils/metrics.py) are tpt.step.<model>.camera (plain version only) and
# tpt.step.<model>.paths
STEPS = {"classic": "unidirectional", "mega": "unidirectional_mega",
         "naive": "naive"}


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, use_mis: bool = True,
                  sample_environment: bool = False):
    """Trace one sample for pixels (px, py) [N] (int) -> (radiance [N,3]
    float32, rays traced: a Python int on the CPU, a 0-d int64 tensor on
    the card)."""
    if px.device.type == "cpu":
        return render_plain(scene, camera, base_key, sample_idx, px, py,
                            max_depth=max_depth, use_mis=use_mis,
                            sample_environment=sample_environment,
                            schedule="classic")
    return render_kernel(scene, camera, base_key, sample_idx, px, py,
                         max_depth=max_depth, use_mis=use_mis,
                         sample_environment=sample_environment,
                         schedule="classic")


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  max_depth: int, use_mis: bool, sample_environment: bool,
                  schedule: str):
    """One sample: one launch of K5 (uni_mega.cu) at k = 1 on CUDA tensors
    -> (radiance [N,3], rays as a 0-d int64 tensor on the card: no host
    sync)."""
    return render_batch_kernel(scene, camera, base_key, sample_idx, px, py,
                               1, max_depth=max_depth, use_mis=use_mis,
                               sample_environment=sample_environment,
                               schedule=schedule)


def render_batch(scene, camera, base_key, s0: int, px, py, k: int, *,
                 max_depth: int, use_mis: bool = True,
                 sample_environment: bool = False):
    """Samples s0 .. s0+k-1 in one launch of K5 in the classic schedule
    (CUDA tensors; models/batch.py)."""
    return render_batch_kernel(scene, camera, base_key, s0, px, py, k,
                               max_depth=max_depth, use_mis=use_mis,
                               sample_environment=sample_environment,
                               schedule="classic")


def render_batch_kernel(scene, camera, base_key, s0: int, px, py, k: int, *,
                        max_depth: int, use_mis: bool,
                        sample_environment: bool, schedule: str):
    """Samples s0 .. s0+k-1 in ONE launch of K5 on CUDA tensors
    (models/batch.py); the kernel derives the samples' keys from base_key.
    -> (radiance summed in sample order [N,3], rays as a 0-d int64
    tensor)."""
    with span(f"tpt.step.{STEPS[schedule]}.paths"):
        li, rays = kernels.render_unidirectional(
            scene, px.to(torch.int32).contiguous(),
            py.to(torch.int32).contiguous(), camera.kernel_params(),
            base_key, s0, k, max_depth=max_depth, use_mis=use_mis,
            sample_environment=sample_environment, schedule=schedule,
            air_priority=scene.air_priority)
        return li, rays.sum()


def sample_key_table(base_key, s0: int, k: int, rows: int) -> torch.Tensor:
    """Plain version of K5's draw-key table (the key kernel of
    kernels/csrc/uni_mega.cu, keys.cuh uni_key_tables): for samples s0 ..
    s0+k-1 and draws d = 0..8, with rows > 0 (the classic and naive
    schedules: kernels.uni_key_rows) the pairs
    draw_key(bounce_key(sample_key(base_key, s), lit), d) of events lit <
    rows, the keys render_plain's _bounce folds; with rows 0 (mega) the
    pairs draw_key(sample_key(base_key, s), d) -> int32 [k * max(rows, 1)
    * 9, 2]."""
    return rng.fold_table(base_key, 9, rows=rows, samples=k, s0=s0)


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 max_depth: int, use_mis: bool = True,
                 sample_environment: bool = False, schedule: str):
    """Plain version of K5 for either draw schedule ("classic" or "mega");
    any device. -> (radiance [N,3], rays as a Python int)."""
    n, dev = px.shape[0], px.device
    step = STEPS[schedule]
    skey = rng.sample_key(base_key, sample_idx)
    pid = rng.pixel_ids(px, py)
    with span(f"tpt.step.{step}.camera"):
        o, d = camera.generate_rays_plain(rng.fold_in(skey, 2 ** 20),
                                          px.to(torch.float32),
                                          py.to(torch.float32), pid)
    mats = scene.materials
    ms0 = common.MediumStack.make(n, scene.air_priority, device=dev)
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
    with span(f"tpt.step.{step}.paths"):
        while it < MAX_EVENTS[schedule] and s["lane"].numel() > 0:
            rays += s["lane"].numel()
            alive, s, nee_rays = _bounce(scene, mats, skey, it, s,
                                         max_depth, use_mis,
                                         sample_environment, schedule)
            rays += nee_rays
            li_out[s["lane"]] = s["li"]
            keep = torch.nonzero(alive)[:, 0]
            if keep.numel() < alive.numel():
                s = {k: s[k][keep] for k in _STATE}
            it += 1
        if schedule == "mega":   # the mega engine's RGB9E5 retirement
            li_out = packing.round_rgb9e5(li_out)
    return li_out, rays


def _bounce(scene, mats, skey, it, s, max_depth, use_mis,
            sample_environment, schedule):
    """One bounce of every live path. Returns (alive [M], new state,
    shadow rays counted)."""
    pid = s["pid"]
    if schedule == "classic":
        key, ids = rng.bounce_key(skey, it), pid
    else:
        key, ids = skey, (s["lane"] * ID_STRIDE + it).to(torch.int32)
    ms = common.MediumStack(s["ms_stack"], s["ms_top"])
    nee_rays = 0
    # the classic schedule follows the scene's engine, the mega one BVH8
    if schedule == "mega":
        closest, shadow_factor = (traverse8.closest_hit8,
                                  traverse8.shadow_factor8)
    else:
        closest, shadow_factor = traverse.closest_hit, traverse.shadow_factor

    hit = closest(scene, s["o"], s["d"])
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
        ns = common.nee_sample(scene, key, _D_NEE, info["point"], normal,
                               wi_local, mat, albedo, eta_i, do_nee, ids=ids,
                               transmission=trans)
        if schedule == "classic":
            nee_rays = int(do_nee.sum())
        else:
            nee_rays = int(ns.active.sum())
        if scene.num_lights > 0:
            shadow = shadow_factor(scene, ns.origin, ns.dir, ns.max_t,
                                   active=ns.active)
            bsdf_pdf_nee = bsdf_ops.bsdf_pdf(mat, -wi_local, ns.wo_local,
                                             eta_i, transmission=trans)
            w_nee = common.power2_weight(ns.light_pdf, bsdf_pdf_nee)[:, None]
            if schedule == "classic":
                clear = shadow.amax(dim=-1) > 0.0
                nee_c = torch.where(clear[:, None], ns.contrib * shadow, 0.0)
                add_nee = beta * nee_c * w_nee
            else:
                add_nee = beta * ns.contrib * w_nee * shadow
            li = li + torch.where(ns.active[:, None], add_nee, 0.0)

    # BSDF sampling
    wo_local, f_val, pdf = bsdf_ops.bsdf_sample(
        key, _D_BSDF, mat, albedo, -wi_local, backface, eta_i, ids=ids,
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
    u_rr = rng.uniform_id(key, _D_RR, ids)
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
