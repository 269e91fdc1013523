"""VCM and SPPM with the default engine ("Integrator: VCM" / "SPPM", no
Engine line or "Engine: mega"), and the mega eye pass BDPT's mega engine
shares (models/bdpt_mega.py).

Counterpart of cudapathtracer_tpu/models/vcm_mega.py. The JAX engine runs
the eye pass as a persistent lane machine (a refill queue, mini/full
transitions, RGB9E5 retirement slots, a compacted deferred merge) that
keeps TPU lanes busy; none of that is ported. Its image does not depend on
the lane schedule, because every eye draw is keyed by the path's index in
the pixel list g and its depth (id g * 64 + depth, keys draw_key(key_e,
d): the BSDF draws 0-3, NEE's 16-18) and the primary ray by the pixel id
(draw keys of fold_in(key_e, 2^20)). So the port runs K14 as three staged
kernels (kernels/csrc/eye_walk.cu, eye_connect.cu, eye_gather.cu: one
thread per path, per queued (eye depth, light row, path) pair, per path)
and, on CPU tensors, their plain twins below over [N] lanes.

What is ported is the estimator, with its chunking (`mega_chunks`): the
frame is cut into chunks of c_pix pixels (pad slots repeat the last pixel);
per chunk and sample:
  1. the VCM light walk (K12) of its c_pix paths, pad paths included (their
     rays count), then masked out of `valid`;
  2. eta_vcm = cnt pi r^2 and the merge normalisation 1 / (pi r^2 cnt)
     from the chunk's true pixel count cnt;
  3. the VCM splat of the chunk's light vertices (K11's VCM form);
  4. the photon grid of the chunk (K8, the sample's salt);
  5. the mega eye pass of its cnt pixels (K14), each path's radiance
     retired through RGB9E5 (K10);
then the splats are added, unrounded. SPPM is VCM restricted by its flags.
TPT_MEGA_LIGHT (read on every call under the JAX package's name) walks
step 1 with models/light_mega.py's keyed walk instead (K12's table mode on
the card), with eta_vcm, as the JAX engine does.

The mega eye pass differs from the classic one (models/vcm.py) in:
  * draws: as above (classic: bounce_key(key_e, depth), NEE fold_in(., 7));
  * NEE and the connections use the eye normal turned toward the previous
    vertex and its direction normalize(prev - pos) (NEE's f and pdfs
    included); NEE traces only where cos_light >= EPSILON, to dist -
    EPSILON, skipping the light's triangle;
  * the order of the sums per bounce: s=0 and the merge at shade time, then
    NEE, then the connections j = 0, 1, ...; each weighted contribution is
    scaled by its shadow ray's transmission AFTER the weight, then clamped
    (VCM) or not (BDPT);
  * the merge sums over neighbor_slots' slots (cap <= 8; fold_neighbors'
    candidates above) from zero, then adds the sum; its contribution is
    ((beta f) thr) (merge_norm w);
  * rays: one per closest ray, NEE or connection shadow ray traced.
The "bdpt" flavour (BDPT's weights: no eta_vcm, no d_vm, the linear NEE
ratio, the camera-trace pdf at depth 0 of s=0, the clamp only on deeper
s=0 hits, no merge) serves models/bdpt_mega.py.
Engines: the eye pass traces BVH8 (ops/traverse8) on every scene, as the
JAX eye machine's make_fused_step and K14 do; the light walk and the
splat follow the scene's traversal (ops/traverse), as there.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import common, light_mega, mis, paths
from cudapathtracer_tpu_torch.models.bdpt import (MAX_G_NEE, _cube, _vertex,
                                                  _weighted)
# eye_connect_queue_plain: the queue of K14's connection stage is the
# classic one's (the gate reads flags only; lanes 0..n-1 of lbufs [L, >= n])
from cudapathtracer_tpu_torch.models.vcm import (REC_ESCAPED, EyeRecords,
                                                 VCMConfig, _clamp_firefly,
                                                 conn_geometry, conn_terms,
                                                 eye_connect_queue_plain,
                                                 implicit_vcm, merge_terms,
                                                 record_flags, sample_keys,
                                                 vcm_light_splat)
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import hashgrid, traverse, traverse8
from cudapathtracer_tpu_torch.scene.materials import TRANSPORT_IMPORTANCE
from cudapathtracer_tpu_torch.utils import packing, rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, MAX_FIREFLY_LUM,
                                                 PI, RAY_EPSILON, dot,
                                                 length_sq, luminance,
                                                 merge_radius, normalize,
                                                 to_local, to_world,
                                                 true_div)
from cudapathtracer_tpu_torch.utils.metrics import span

# the JAX engine's lane count; it sets the chunk size, so it is read under
# the JAX package's name
MEGA_WIDTH = int(os.environ.get("TPT_MEGA_WIDTH", "12960"))
ID_STRIDE = 64       # eye draw ids: g * 64 + depth
D_BSDF = 0           # BSDF draws 0-3 of key_e
D_NEE = 16           # NEE draws 16-18 of key_e
FLAVORS = ("vcm", "bdpt")


class Chunks(NamedTuple):
    c_pix: int       # pixels (and light paths) per chunk, pad included
    n_chunks: int
    width: int       # the JAX lane count (it only sets c_pix)


def mega_chunks(p_total: int, chunk_pixels: int = 0,
                width: int = 0) -> Chunks:
    """The JAX mega engines' partition of p_total pixels: at most 2^20
    pixels per chunk unless chunk_pixels says otherwise, rounded up to a
    whole number of lane widths."""
    c_pix0 = min(chunk_pixels or max(p_total // max(
        1, -(-p_total // (1 << 20))), 1), p_total)
    w = min(width or MEGA_WIDTH, c_pix0)
    c_pix = -(-c_pix0 // w) * w
    return Chunks(c_pix, -(-p_total // c_pix), w)


def chunk_pixels_of(px, py, ci: int, c_pix: int):
    """The chunk's pixel coordinates [c_pix] (pad slots repeat the last
    pixel) and its true pixel count."""
    p_total = px.shape[0]
    g = torch.clamp(torch.arange(ci * c_pix, (ci + 1) * c_pix,
                                 device=px.device), max=p_total - 1)
    return px[g], py[g], min(p_total - ci * c_pix, c_pix)


def chunk_scalars(scene, cfg: VCMConfig, sample_idx: int, cnt: int):
    """(merge radius, eta_vcm, merge normalisation) of a chunk of cnt
    pixels as float32 values, in the JAX mega engine's order:
    eta_vcm = ((cnt pi) r) r and 1 / (((pi r) r) max(cnt, 1)), each step
    in float32."""
    f = np.float32
    r0 = f(scene.scene_radius) * f(cfg.r0_multiplier)
    mr = f(merge_radius(r0, sample_idx, cfg.merge_alpha))
    eta = f(cnt) * f(PI) * mr * mr
    norm = f(1.0) / (f(PI) * mr * mr * max(f(cnt), f(1.0)))
    return float(mr), float(eta), float(norm)


def eye_keys(key_e) -> list:
    """The 22 key words K14 takes: the camera's four draw keys (of
    fold_in(key_e, 2^20)), the BSDF draw keys 0-3 and NEE's 16-18 of
    key_e."""
    words = paths.walk_keys(key_e, "eye")[:8]
    for d in (0, 1, 2, 3, D_NEE, D_NEE + 1, D_NEE + 2):
        words += list(rng.draw_key(key_e, d))
    return words


# --- the mega eye pass (K14), plain -----------------------------------------

def _resolve(pending, shadow, flavor: str, cfg):
    """A weighted contribution scaled by its shadow ray: the firefly clamp
    after the scale under VCM, none under BDPT; PAINTWEIGHT only gates."""
    if cfg.paint_weight:
        return torch.where((shadow.amax(dim=-1) > 0.0)[:, None], pending,
                           0.0)
    if flavor == "bdpt":
        return pending * shadow
    return _clamp_firefly(pending * shadow)


def _implicit_bdpt(scene, camera, info, conn, prev_pt, prev_delta, thr,
                   d_vcm, d_vc, depth: int, cfg):
    """s = 0 under BDPT's weights: at depth 0 against the camera-trace
    pdf and unclamped, deeper through the recursion with the firefly clamp
    on the contribution."""
    num_lights = max(scene.num_lights, 1)
    is_light = conn & (info["light_ind"] >= 0) & ~info["backface"]
    lrow = scene.light_f32[torch.clamp(info["light_ind"], min=0)]
    le, area = lrow[:, 12:15], lrow[:, 15]
    npos = info["point"]
    to_prev_u = normalize(prev_pt - npos)
    cos_la = torch.abs(dot(info["normal"], to_prev_u))
    contrib = le * thr
    pdf_connect0 = true_div(float(np.float32(1.0 / num_lights)),
                            torch.clamp(area, min=1e-20))
    if depth == 0:
        fwd = npos.new_tensor(camera.forward).expand_as(npos)
        cos_cam = torch.abs(dot(fwd, -to_prev_u))
        d2n = torch.clamp(length_sq(npos - prev_pt), min=1e-20)
        pdf_trace_cam = cos_la / (d2n * camera.plane_area()
                                  * _cube(cos_cam))
        w_eye = pdf_connect0 / torch.clamp(pdf_trace_cam, min=1e-20)
    else:
        pdf_connect = torch.where(prev_delta, 0.0, pdf_connect0)
        w_eye = (pdf_connect * d_vcm
                 + pdf_connect * true_div(cos_la, PI) * d_vc)
        lum = luminance(contrib)
        contrib = contrib * torch.where(
            lum > MAX_FIREFLY_LUM,
            true_div(MAX_FIREFLY_LUM, torch.clamp(lum, min=1e-20)),
            1.0)[:, None]
    out = _weighted(contrib, 1.0 / (1.0 + w_eye), cfg)
    return torch.where(is_light[:, None], out, 0.0)


def _merge(grid, e, npos, conn, cfg, mr: float, eta_vcm: float,
           merge_norm: float):
    """The merge at eye vertices e [N]: (the sum over each lane's slots,
    from zero, in slot order; the dropped count)."""
    li_m = torch.zeros_like(npos)

    def add(li_m, idx, rows, w):
        base, weight = merge_terms(e, idx, rows, eta_vcm)
        out = _weighted(base * (merge_norm * w)[:, None], weight, cfg)
        return li_m.index_put((idx,), li_m[idx] + out)

    if 1 <= cfg.max_per_cell <= 8:
        rows, ok, wgt, dropped = hashgrid.neighbor_slots(
            grid, npos, mr, cfg.max_per_cell, active=conn)
        for m in range(rows.shape[0]):
            idx = torch.nonzero(ok[m])[:, 0]
            if idx.numel():
                li_m = add(li_m, idx, rows[m][idx], wgt[m][idx])
        return li_m, dropped

    def fold(li_m, row, in_range, w):
        idx = torch.nonzero(in_range)[:, 0]
        return add(li_m, idx, row[idx], w[idx]) if idx.numel() else li_m
    return hashgrid.fold_neighbors(grid, npos, mr, cfg.max_per_cell, fold,
                                   li_m, active=conn, count_dropped=True)


def _nee(scene, key_e, e, conn, ids, flavor: str, cfg, eta_vcm):
    """NEE (s = 1) at eye vertices e [N] with normal e["n"] (turned toward
    the previous vertex): (what each lane adds, shadow rays traced)."""
    n = e["pos"].shape[0]
    ones = torch.ones(n, dtype=torch.float32, device=e["pos"].device)
    _, tri, p, lnrm, le, area = paths.light_point(
        scene, key_e, (D_NEE, D_NEE + 1, D_NEE + 2), n, ids)
    nrm, mat, albedo, trans = e["n"], e["mat"], e["albedo"], e["trans"]
    stl = p - e["pos"]
    d2 = torch.clamp(length_sq(stl), min=RAY_EPSILON)
    dist = torch.sqrt(d2)
    stl_u = stl / dist[:, None]
    cos_light = dot(lnrm, -stl_u)
    cos_surf = torch.abs(dot(nrm, stl_u))
    g = torch.clamp(cos_light * cos_surf / d2, max=MAX_G_NEE)
    pdf_connect = true_div(float(np.float32(1.0 / max(scene.num_lights, 1))),
                           torch.clamp(area, min=1e-20))
    pdf_emit_sa = true_div(cos_light, PI)
    stl_local = to_local(stl_u, nrm)
    to_prev_loc = to_local(e["to_prev"], nrm)
    f_val = bsdf_ops.bsdf_f(mat, albedo, to_prev_loc, stl_local, ones,
                            transmission=trans)
    contrib = f_val * le * (g / pdf_connect)[:, None]
    pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat, to_prev_loc, stl_local, ones,
                                    transmission=trans)
    pdf_bsdf_area = pdf_bsdf_sa * torch.abs(cos_light) / d2
    ratio = pdf_bsdf_area / torch.clamp(pdf_connect, min=1e-20)
    w_light = ratio if flavor == "bdpt" else ratio * ratio
    pdf_curr_rev_area = pdf_emit_sa * torch.abs(stl_local[..., 2]) / d2
    pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat, stl_local, to_prev_loc, ones,
                                        transmission=trans)
    w_eye = pdf_curr_rev_area * (eta_vcm + e["d_vcm"]
                                 + pdf_prev_rev_sa * e["d_vc"])
    weight = 1.0 / (1.0 + w_light + w_eye)
    do = conn & (cos_light >= EPSILON)
    shadow = traverse8.shadow_factor8(scene, e["pos"] + nrm * RAY_EPSILON,
                                      stl_u, dist - EPSILON, skip_tri=tri,
                                      active=do)
    out = _resolve(_weighted(contrib * e["thr"], weight, cfg), shadow,
                   flavor, cfg)
    return torch.where(do[:, None], out, 0.0), int(do.sum())


def _toward_prev(n, to_prev):
    """The eye normal turned toward the previous vertex (NEE's and the
    connections' normal)."""
    return torch.where((dot(n, to_prev) < 0.0)[:, None], -n, n)


def eye_walk_plain(scene, camera, key_e, cfg: VCMConfig, px, py, gbase: int,
                   *, flavor: str = "vcm", eta_vcm: float = 0.0):
    """Plain version of K14's eye walk stage (eye_walk.cu's mega flavours,
    any device): the walk of the n pixels (px, py) [n] of a chunk starting
    at list index gbase, with s=0 and NEE per vertex. -> (EyeRecords
    [eye_depth, n], closest and NEE rays as a Python int)."""
    if flavor not in FLAVORS:
        raise ValueError(f"flavor {flavor!r}: one of {FLAVORS}")
    vcm = flavor == "vcm"
    n, dev = px.shape[0], px.device
    pid = rng.pixel_ids(px, py)
    g_ids = gbase + torch.arange(n, dtype=torch.int64, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    start, _ = paths.start_eye_walk(scene, camera, key_e, px, py, pid)
    o, d, thr = start.o, start.d, start.throughput
    prev_pdf_sa, prev_cos, prev_pt = (start.prev_pdf_sa, start.prev_cos,
                                      start.prev_pt)
    mstate = mis.MisState.zeros(n, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    rec = EyeRecords.empty(cfg.eye_depth, n, dev, fill=torch.zeros)
    do_nee = cfg.nee and scene.num_lights > 0
    rays = 0
    for depth in range(cfg.eye_depth):
        if not bool(alive.any()):
            break
        rays += int(alive.sum())
        hit = traverse8.closest_hit8(scene, o, d, active=alive)
        info, mat = traverse.shade_data(scene, o, d, hit)
        reached = alive & hit.valid
        missed = alive & ~hit.valid
        if cfg.sample_environment:
            sky = _weighted(thr * common.sample_sky(d, True), ones, cfg)
            rec.put(depth, missed, implicit=sky)
        normal, npos = info["normal"], info["point"]
        wo_local = to_local(d, normal)
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
        cur_delta = mat.is_specular
        d2p = torch.clamp(length_sq(npos - prev_pt), min=RAY_EPSILON)
        pdf_fwd_area = prev_pdf_sa * torch.abs(wo_local[..., 2]) / d2p
        g = prev_cos / d2p
        did = (g_ids * ID_STRIDE + depth).to(torch.int32)
        wi_local, f_val, pdf_sa = bsdf_ops.bsdf_sample(
            key_e, D_BSDF, mat, albedo, -wo_local, info["backface"], ones, 0,
            ids=did, transmission=trans)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, wi_local, -wo_local, ones,
                                       transmission=trans)
        valid = reached & (pdf_sa >= EPSILON)
        d_vcm, d_vc, d_vm, mstate2 = mis.advance(
            mstate, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
            1.0 / torch.clamp(pdf_fwd_area, min=1e-20), zeros, zeros,
            eta_vcm if vcm else None)
        conn = valid & ~cur_delta
        to_prev = normalize(prev_pt - npos)

        # s = 0 at shade time
        s0 = torch.zeros_like(npos)
        if cfg.naive:
            if vcm:
                s0 = implicit_vcm(scene, info, conn, to_prev, prev_delta, thr,
                                  d_vcm, d_vc, depth, cfg)
            else:
                s0 = _implicit_bdpt(scene, camera, info, conn, prev_pt,
                                    prev_delta, thr, d_vcm, d_vc, depth, cfg)
        # NEE, the eye normal toward prev_pt
        nee = torch.zeros_like(npos)
        if do_nee:
            eye = dict(pos=npos, n=_toward_prev(normal, to_prev), mat=mat,
                       albedo=albedo, trans=trans, thr=thr, d_vcm=d_vcm,
                       d_vc=d_vc, to_prev=to_prev)
            nee, r = _nee(scene, key_e, eye, conn, did, flavor, cfg, eta_vcm)
            rays += r

        # SPPM ends the path after its first non-delta hit
        keep = valid
        if cfg.do_sppm and cfg.do_merge:
            keep = keep & cur_delta
        rec.put(depth, reached, pos=npos, n=normal, to_prev=to_prev,
                thr=thr, albedo=albedo, trans=trans, mat_id=info["mat_id"],
                d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm, implicit=s0, nee=nee)
        rec.flags[depth] = record_flags(reached, missed, valid, cur_delta,
                                        ~keep, depth == cfg.eye_depth - 1)

        # the next bounce
        new_thr = thr * f_val * (torch.abs(wi_local[..., 2])
                                 / torch.clamp(pdf_sa, min=1e-20))[:, None]
        wi_world = normalize(to_world(wi_local, normal))
        side = torch.where(dot(wi_world, normal) < 0.0, -1.0, 1.0)
        upd = valid[:, None]
        o = torch.where(upd, npos + normal * (side * RAY_EPSILON)[:, None], o)
        d = torch.where(upd, wi_world, d)
        thr = torch.where(upd, new_thr, thr)
        prev_pdf_sa = torch.where(valid, pdf_sa, prev_pdf_sa)
        prev_cos = torch.where(valid, torch.abs(wi_local[..., 2]), prev_cos)
        prev_pt = torch.where(upd, npos, prev_pt)
        mstate = mis.MisState(*(torch.where(valid, a2, a1)
                                for a2, a1 in zip(mstate2, mstate)))
        prev_delta = torch.where(reached, cur_delta, prev_delta)
        alive = keep
    return rec, rays


def eye_connect_plain(scene, rec: EyeRecords, lbufs, cfg: VCMConfig, *,
                      flavor: str = "vcm", eta_vcm: float = 0.0):
    """Plain version of K14's connection stage (eye_connect.cu's mega
    flavours, any device): every (eye depth t, light row j, path) pair
    against the light buffers' lanes 0..n-1 (lbufs [L, >= n]), the eye
    normal turned toward the previous vertex, each weighted contribution
    resolved by its BVH8 shadow ray. -> (conn [D, L, n, 3], zero where
    the pair traces nothing; shadow rays as a Python int)."""
    depth, n = rec.flags.shape
    dev = rec.pos.device
    lanes = paths.PathBuffers(*(f[:, :n] for f in lbufs))
    lrows = lanes.pt.shape[0]
    conn = torch.zeros((depth, lrows, n, 3), dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    lverts = [_vertex(lanes, j) for j in range(lrows)]
    rays = 0
    for t in range(depth):
        live = rec.conn(t)
        if not bool(live.any()):
            continue
        eye = rec.eye(scene, t)
        eye["n"] = _toward_prev(eye["n"], eye["to_prev"])
        for j, lv in enumerate(lverts):
            conn[t, j], r = _connect_row(scene, eye, lv, live, ones, cfg,
                                         flavor, eta_vcm)
            rays += r
    return conn, rays


def _connect_row(scene, eye, lv, live, ones, cfg: VCMConfig, flavor: str,
                 eta_vcm: float):
    """The connections of eye vertices `eye` (the normal turned toward
    the previous vertex) to light vertices lv, lane by lane, on the lanes
    `live` -> (each lane's resolved contribution [N,3], zero where nothing
    is traced; the shadow rays traced)."""
    do, e2l_u, dist, cos_l, cos_e, d2 = conn_geometry(eye, lv, live)
    shadow = traverse8.shadow_factor8(
        scene, eye["pos"] + eye["n"] * RAY_EPSILON, e2l_u,
        dist - RAY_EPSILON, active=do)
    base, weight = conn_terms(scene, eye, lv, ones, e2l_u, cos_l, cos_e, d2,
                              eta_vcm)
    out = _resolve(_weighted(base, weight, cfg), shadow, flavor, cfg)
    return torch.where(do[:, None], out, 0.0), int(do.sum())


def eye_gather_plain(scene, rec: EyeRecords, conn, grid, cfg: VCMConfig, *,
                     flavor: str = "vcm", mr: float = 0.0,
                     eta_vcm: float = 0.0, merge_norm: float = 0.0):
    """Plain version of K14's gather stage (eye_gather.cu's mega flavours,
    any device): per depth the sky, s=0, the merge (VCM with a grid: the
    slots' sum from zero), NEE, the connections j = 0, 1, ..., added in
    that order from zero, then each path's radiance through RGB9E5.
    -> (radiance [n,3], merge-cap dropped photons as a Python int)."""
    depth, n = rec.flags.shape
    li = torch.zeros((n, 3), dtype=torch.float32, device=rec.pos.device)
    merge = flavor == "vcm" and cfg.do_merge
    dropped = 0
    for t in range(depth):
        f = rec.flags[t]
        if not bool((f != 0).any()):
            break
        if cfg.sample_environment:
            li = li + torch.where(((f & REC_ESCAPED) != 0)[:, None],
                                  rec.implicit[t], 0.0)
        live = rec.conn(t)
        m = live[:, None]
        li = li + torch.where(m, rec.implicit[t], 0.0)
        if merge:
            eye = rec.eye(scene, t)
            eye["prev_loc"] = to_local(eye["to_prev"], eye["n"])
            li_m, drop = _merge(grid, eye, eye["pos"], live, cfg, mr, eta_vcm,
                                merge_norm)
            li = li + li_m
            dropped += drop
        li = li + torch.where(m, rec.nee[t], 0.0)
        if conn is not None:
            for j in range(conn.shape[1]):
                li = li + torch.where(m, conn[t, j], 0.0)
    return packing.round_rgb9e5(li), dropped


def eye_pass_plain(scene, camera, key_e, lbufs, grid, cfg: VCMConfig, px,
                   py, gbase: int, *, flavor: str = "vcm", mr: float = 0.0,
                   eta_vcm: float = 0.0, merge_norm: float = 0.0):
    """Plain version of K14 (any device): the three stages in turn, walk
    records, pair contributions (with the connections on), the ordered
    gather with the merge, for the n live pixels (px, py) [n] of a chunk
    starting at list index gbase, paired with the light buffers' lanes
    0..n-1 (lbufs [L, >= n]; every row is a connection candidate). grid: a
    PhotonGrid, or None (no merge). -> (each path's radiance through
    RGB9E5 [n,3], rays as a Python int, merge-cap dropped photons as a
    Python int)."""
    rec, rays = eye_walk_plain(scene, camera, key_e, cfg, px, py, gbase,
                               flavor=flavor, eta_vcm=eta_vcm)
    conn = None
    if cfg.connection and lbufs.pt.shape[0] > 0:
        conn, r = eye_connect_plain(scene, rec, lbufs, cfg, flavor=flavor,
                                    eta_vcm=eta_vcm)
        rays += r
    li, dropped = eye_gather_plain(scene, rec, conn, grid, cfg,
                                   flavor=flavor, mr=mr, eta_vcm=eta_vcm,
                                   merge_norm=merge_norm)
    return li, rays, dropped


# --- one sample --------------------------------------------------------------

# a chunk's stages, each a program span when tracing (utils/metrics.py)
STAGES = {st: f"tpt.step.vcm_mega.{st}"
          for st in ("light_walk", "splat", "photon_grid", "eye_pass")}


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, width: int = 0, chunk_pixels: int = 0):
    """One VCM/SPPM sample of the mega engine over the whole frame (px, py
    [P] in raster order) -> (radiance [P,3] with the splat added, rays
    traced, photons the merge cap left out), the counts as Python ints on
    the CPU and as 0-d int64 tensors on the card.
    width and chunk_pixels set the chunks as in the JAX engine."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py, cfg=cfg,
              width=width, chunk_pixels=chunk_pixels)


def _grid_plain(scene, cfg, lbufs, mr, sample_idx):
    rows, valid = hashgrid.photon_rows(lbufs)
    return hashgrid.build_grid(rows, valid, scene.scene_min, mr,
                               hashgrid.photon_table_size(rows.shape[0]),
                               salt=hashgrid.photon_salt(sample_idx))


def mask_pads(lbufs, cnt: int):
    """Light buffers with the pad paths (lanes >= cnt) invalid."""
    if cnt == lbufs.valid.shape[1]:
        return lbufs
    valid = lbufs.valid.clone()
    valid[:, cnt:] = False
    return lbufs._replace(valid=valid)


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 cfg: VCMConfig, width: int = 0, chunk_pixels: int = 0):
    """Plain versions of K12, the VCM splat, K8 and K14 per chunk; any
    device."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    p_total, dev = px.shape[0], px.device
    ch = mega_chunks(p_total, chunk_pixels, width)
    out = torch.empty((p_total, 3), dtype=torch.float32, device=dev)
    fb = torch.zeros((p_total, 3), dtype=torch.float32, device=dev)
    rays = dropped = 0
    keyed = light_mega.enabled()
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        mr, eta, norm = chunk_scalars(scene, cfg, sample_idx, cnt)
        with span(STAGES["light_walk"]):
            if keyed:
                lbufs, r = light_mega.light_walk_mega(
                    scene, key_l, ch.c_pix, cfg.light_depth + 1,
                    TRANSPORT_IMPORTANCE, eta_vcm=eta, pxc=pxc, pyc=pyc)
            else:
                lbufs, _, r = paths.generate_light_path(
                    scene, key_l, pxc, pyc, cfg.light_depth + 1, eta_vcm=eta)
            lbufs = mask_pads(lbufs, cnt)
        rays += r
        if cfg.light_trace:
            with span(STAGES["splat"]):
                fb, r = vcm_light_splat(scene, camera, lbufs, cfg, eta, fb)
            rays += r
        grid = None
        if cfg.do_merge:
            with span(STAGES["photon_grid"]):
                grid = _grid_plain(scene, cfg, lbufs, mr, sample_idx)
        g0 = ci * ch.c_pix
        with span(STAGES["eye_pass"]):
            li, r, drop = eye_pass_plain(scene, camera, key_e, lbufs, grid,
                                         cfg, pxc[:cnt], pyc[:cnt], g0, mr=mr,
                                         eta_vcm=eta, merge_norm=norm)
        out[g0:g0 + cnt] = li
        rays, dropped = rays + r, dropped + drop
    return out + fb, rays, dropped


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, width: int = 0, chunk_pixels: int = 0):
    """Per chunk: K12 (light; its table mode under TPT_MEGA_LIGHT),
    vcm_splat, photon_pack + photon_sort + photon_table, K14 (mega_eye); one
    ray-count and one dropped-count accumulator per chunk, summed on the
    card into 0-d int64 tensors (no host sync)."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    p_total, dev = px.shape[0], px.device
    ch = mega_chunks(p_total, chunk_pixels, width)
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    out = torch.empty((p_total, 3), dtype=torch.float32, device=dev)
    fb = torch.zeros((p_total, 3), dtype=torch.float32, device=dev)
    lkeys, ekeys = paths.walk_keys(key_l, "light"), eye_keys(key_e)
    salt = hashgrid.photon_salt(sample_idx)
    switches = hashgrid.merge_switches(cfg.max_per_cell)
    ray_sums, drop_sums = [], []
    keyed = light_mega.enabled()
    for ci in range(ch.n_chunks):
        pxc, pyc, cnt = chunk_pixels_of(px, py, ci, ch.c_pix)
        mr, eta, norm = chunk_scalars(scene, cfg, sample_idx, cnt)
        rays = torch.zeros(ch.c_pix, dtype=torch.int32, device=dev)
        with span(STAGES["light_walk"]):
            if keyed:
                lbufs, lrays = light_mega.light_walk_mega(
                    scene, key_l, ch.c_pix, cfg.light_depth + 1,
                    TRANSPORT_IMPORTANCE, eta_vcm=eta, pxc=pxc, pyc=pyc)
                ray_sums.append(lrays)
            else:
                lbufs = kernels.bdpt_walk(
                    scene, pxc, pyc, lkeys, mode="light",
                    max_depth=cfg.light_depth + 1, rays=rays,
                    eta_vcm=eta)["bufs"]
            lbufs = mask_pads(lbufs, cnt)
        if cfg.light_trace:
            with span(STAGES["splat"]):
                kernels.vcm_splat(scene, camera, lbufs, fb, rays, cfg, eta)
        grid = None
        if cfg.do_merge:
            with span(STAGES["photon_grid"]):
                grid = hashgrid.build_grid_kernel(lbufs, scene.scene_min, mr,
                                                  salt)
        with span(STAGES["eye_pass"]):
            dropped, _ = kernels.mega_eye(
                scene, camera, ekeys, lbufs, grid, out, rays, cfg, px=pxc,
                py=pyc, cnt=cnt, gbase=ci * ch.c_pix, flavor="vcm",
                merge_radius=mr, eta_vcm=eta, merge_norm=norm, **switches)
        ray_sums.append(rays.sum())
        drop_sums.append(dropped.sum())
    return (out + fb, torch.stack(ray_sums).sum(),
            torch.stack(drop_sums).sum())
