"""Bidirectional path tracer with O(1) recursive MIS ("Integrator:
BIDIRECTIONAL" with "Engine: classic").

Counterpart of cudapathtracer_tpu/models/bdpt.py. One sample is a light
walk, the t=1 light-trace splat, an eye walk and the connection stage
(s=0: the eye walk hit a light; s=1: NEE; s>=2: connections to every
stored light vertex), all lane-wise: eye path i meets light path i, both
keyed by pixel i's id.

On CUDA tensors `render_sample` launches five kernels per sample: the walk
kernel K12 (bdpt_walk.cu, persistent threads that step one bounce of a
path a trip) for the light paths, the splat K11 (bdpt_splat.cu in two
stages: the light vertices that trace, binned by screen tile, then one
shadow ray a thread in tile order, atomicAdd into the frame buffer), K12
for the eye paths, and the connection stage K13 in two
launches: bdpt_pairs.cu (one thread per eye vertex, strategy and pixel,
one shadow ray each, its weighted term stored) and bdpt_gather.cu (one
thread per pixel adding the terms in the JAX summation order). On CPU
tensors it runs the plain versions below, the JAX functions operation for
operation over [N] lanes. Both read the
connection and splat inputs from the DECODED packed vertices
(models/paths.PathBuffers); the light endpoint (s=1) is not packed.

The splat's frame buffer is indexed by raster pixel (the pixel list must
be the whole frame in raster order, as driver.Renderer gives it); float
atomics make its per-pixel sums order-nondeterministic on the card. With
`splat_shape` (tile sharding, parallel/sharding.py) the pixel list is one
tile of the frame, the frame buffer covers the whole frame and is returned
beside the tile's radiance instead of added to it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import common, paths
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import traverse
from cudapathtracer_tpu_torch.scene.materials import MaterialTable
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, INV_PI,
                                                 MAX_FIREFLY_LUM, PI,
                                                 RAY_EPSILON, dot, length_sq,
                                                 luminance, normalize,
                                                 to_local, true_div)
from cudapathtracer_tpu_torch.utils.metrics import span

MAX_G_NEE = 15.0        # G clamp of the s=1 strategy
MAX_G_CONNECT = 2.0     # G clamp of the s>=2 connections


@dataclass(frozen=True)
class BDPTConfig:
    eye_depth: int = 16
    light_depth: int = 10
    light_trace: bool = True
    nee: bool = True
    naive: bool = True
    connection: bool = True
    do_mis: bool = True
    paint_weight: bool = False
    sample_environment: bool = False

    @staticmethod
    def from_config(cfg) -> "BDPTConfig":
        return BDPTConfig(
            eye_depth=max(cfg.bdpt_eye_depth, 2),
            light_depth=max(cfg.bdpt_light_depth, 1),
            light_trace=cfg.bdpt_light_trace, nee=cfg.bdpt_nee,
            naive=cfg.bdpt_naive, connection=cfg.bdpt_connection,
            do_mis=cfg.bdpt_do_mis, paint_weight=cfg.bdpt_paint_weight,
            sample_environment=cfg.sample_environment)


def _weighted(contrib, weight, cfg: BDPTConfig):
    if cfg.paint_weight:
        return weight[:, None].expand(contrib.shape)
    if cfg.do_mis:
        return contrib * weight[:, None]
    return contrib


def _gather_mat(scene, mat_id) -> MaterialTable:
    m = scene.materials
    return MaterialTable(**{f.name: getattr(m, f.name)[mat_id]
                            for f in dataclasses.fields(m)})


def _cube(x):
    """x**3 by the square-and-multiply order of XLA's integer_pow."""
    return x * (x * x)


def _fourth(x):
    x2 = x * x
    return x2 * x2


def _vertex(bufs: paths.PathBuffers, j: int) -> dict:
    """Decoded stored vertex row j (vertex j + 1 of the walk)."""
    row = paths.PathBuffers(*(f[j] for f in bufs))
    return dict(pt=row.pt, n=row.n, wo=row.wo, uv=row.uv, beta=row.beta,
                pdf_fwd=row.pdf_fwd, d_vcm=row.d_vcm, d_vc=row.d_vc,
                is_delta=row.is_delta, backface=row.backface,
                light_ind=row.light_ind, mat_id=row.mat_id, valid=row.valid)


def _light_endpoint(lv0: dict) -> dict:
    """Light vertex s=1 (the unpacked endpoint)."""
    n = lv0["pt"].shape[0]
    dev = lv0["pt"].device
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    return dict(pt=lv0["pt"], n=lv0["n"], beta=lv0["beta"],
                wo=torch.zeros_like(lv0["pt"]),
                uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
                d_vcm=zf, d_vc=zf,
                is_delta=torch.zeros(n, dtype=torch.bool, device=dev),
                mat_id=lv0["mat_id"], pdf_fwd=lv0["pdf_fwd"],
                valid=torch.ones(n, dtype=torch.bool, device=dev))


# --- t=1: the light-trace splat (K11) ---------------------------------------

def light_trace_splat(scene, camera, lbufs, lv0, cfg: BDPTConfig, fb,
                      active=None):
    """Plain version of K11 (any device): connect every light vertex to
    the lens and add it into fb [P,3] (raster-indexed) in place, s=1
    first, then the stored vertices in depth order, each a scatter-add
    over the lanes. active [N] bool masks whole light paths (the mega
    engine's chunk pads). Returns (fb, rays as a Python int)."""
    rays = _splat_vertex(scene, camera, _light_endpoint(lv0), True, cfg, fb,
                         active=active)
    for j in range(lbufs.pt.shape[0]):
        rays += _splat_vertex(scene, camera, _vertex(lbufs, j), False, cfg,
                              fb, active=active)
    return fb, rays


def _splat_vertex(scene, camera, v, first: bool, cfg, fb,
                  eta_vcm=None, active=None) -> int:
    """One light vertex per lane to the lens (K11's plain body); eta_vcm
    adds VCM's merge term to a stored vertex's w_light."""
    n, dev = v["pt"].shape[0], v["pt"].device
    w, h = camera.width, camera.height
    plane_area = camera.plane_area()
    rx, ry, on_screen = camera.world_to_raster(v["pt"])
    go = v["valid"] & on_screen & ~v["is_delta"]
    if active is not None:
        go = go & active

    to_cam = v["pt"].new_tensor(camera.origin) - v["pt"]
    dist = torch.sqrt(torch.clamp(length_sq(to_cam), min=1e-20))
    to_cam_u = to_cam / dist[:, None]
    origin = v["pt"] + v["n"] * RAY_EPSILON
    rays = int(go.sum())
    shadow = traverse.shadow_factor(scene, origin, to_cam_u,
                                    dist - RAY_EPSILON, active=go)
    clear = shadow.amax(dim=-1) > 0.0

    cos_light = dot(v["n"], to_cam_u)
    fwd = v["pt"].new_tensor(camera.forward).expand(n, 3)
    cos_cam = torch.abs(dot(fwd, -to_cam_u))
    go = go & clear & (cos_light > EPSILON)

    to_cam_local = to_local(to_cam_u, v["n"])
    d2 = torch.clamp(length_sq(to_cam), min=RAY_EPSILON)
    pdf_trace_cam = cos_light / (d2 * plane_area * _cube(cos_cam))
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    if first:
        light_f = torch.full((n, 3), INV_PI, dtype=torch.float32, device=dev)
        w_light = pdf_trace_cam / torch.clamp(v["pdf_fwd"], min=1e-20)
    else:
        to_prev_local = to_local(v["wo"], v["n"])
        mat = _gather_mat(scene, v["mat_id"])
        albedo = bsdf_ops.resolve_albedo(scene, mat, v["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, v["uv"])
        light_f = bsdf_ops.bsdf_f(mat, albedo, to_prev_local, to_cam_local,
                                  ones, transmission=trans)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, to_cam_local, to_prev_local,
                                       ones, transmission=trans)
        d_vcm = v["d_vcm"] if eta_vcm is None else eta_vcm + v["d_vcm"]
        w_light = pdf_trace_cam * (d_vcm + pdf_rev_sa * v["d_vc"])

    we = 1.0 / (plane_area * _fourth(cos_cam))
    g = cos_light * cos_cam / d2
    contrib = v["beta"] * light_f * (g * we)[:, None] * shadow
    weight = 1.0 / (1.0 + w_light)
    out = torch.where(go[:, None], _weighted(contrib, weight, cfg), 0.0)
    pix = (torch.clamp(ry.to(torch.int32), 0, h - 1) * w
           + torch.clamp(rx.to(torch.int32), 0, w - 1))
    fb.index_add_(0, pix.to(torch.int64), out)
    return rays


SPLAT_TILE = 16          # K11's screen tiles: 16 x 16 pixels at least
SPLAT_MAX_TILES = 8192   # bdpt_splat.cu kMaxTiles (its shared histogram)


def splat_tiling(width: int, height: int) -> tuple:
    """K11's screen tiles for a width x height frame: (tile, tiles_x,
    tiles), tile pixels a side from SPLAT_TILE, doubled until the frame
    has at most SPLAT_MAX_TILES (1920x1080: 16 px, 120 x 68 = 8160)."""
    tile = SPLAT_TILE
    while -(-width // tile) * -(-height // tile) > SPLAT_MAX_TILES:
        tile *= 2
    tiles_x = -(-width // tile)
    return tile, tiles_x, tiles_x * -(-height // tile)


def splat_queue_plain(camera, lbufs, lv0=None, n_live=None):
    """Plain twin of K11's first stage (kernels.SplatPass.bin; any device):
    the light vertices that trace a shadow ray to the lens (valid, not
    delta, on screen: _splat_vertex's test), of paths i < n_live, as
    entries r N + i (row r of path i: the endpoint lv0 then the stored
    rows in the BDPT form; the stored rows alone in VCM's, lv0 None), in
    the order of the screen tile of their pixel (splat_tiling), by entry
    inside a tile. -> (queue [count] int64, offsets [tiles + 1] int64:
    tile t's entries are queue[offsets[t]:offsets[t + 1]])."""
    n, dev = lbufs.pt.shape[1], lbufs.pt.device
    tile, tiles_x, tiles = splat_tiling(camera.width, camera.height)
    rows = [] if lv0 is None else [(lv0["pt"], None, None)]
    rows += [(lbufs.pt[j], lbufs.valid[j], lbufs.is_delta[j])
             for j in range(lbufs.pt.shape[0])]
    live = torch.arange(n, device=dev) < (n if n_live is None else n_live)
    entries, tile_of = [], []
    for r, (pt, valid, delta) in enumerate(rows):
        rx, ry, on_screen = camera.world_to_raster(pt)
        go = live & on_screen
        if valid is not None:
            go = go & valid & ~delta
        ix = torch.clamp(rx.to(torch.int32), 0, camera.width - 1)
        iy = torch.clamp(ry.to(torch.int32), 0, camera.height - 1)
        lane = torch.nonzero(go).reshape(-1)
        entries.append(r * n + lane)
        tile_of.append(((iy // tile) * tiles_x + ix // tile)[lane]
                       .to(torch.int64))
    entry, t = torch.cat(entries), torch.cat(tile_of)
    queue = entry[torch.argsort(t * (len(rows) * n) + entry)]
    counts = torch.bincount(t, minlength=tiles)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return queue, offsets


# --- the connection stage (K13) ----------------------------------------------

def _bdpt_nee(scene, key, tag, ev, mat_e, albedo_e, prev_to_curr_local,
              active, ids, trans_e):
    """s=1 (NEE): area-measure light pdf, interpolated light normal, the G
    clamp, a shadow ray that skips the light's triangle."""
    n = ev["pt"].shape[0]
    num = max(scene.num_lights, 1)
    kk = rng.fold_in(key, tag)
    li, tri, p, lnrm, le, area = paths.light_point(scene, kk, (0, 1, 2), n,
                                                   ids)
    stl = p - ev["pt"]
    d2 = torch.clamp(length_sq(stl), min=RAY_EPSILON)
    dist = torch.sqrt(d2)
    stl_u = stl / dist[:, None]

    origin = ev["pt"] + ev["n"] * RAY_EPSILON
    shadow = traverse.shadow_factor(scene, origin, stl_u, dist - EPSILON,
                                    skip_tri=tri, active=active)
    clear = shadow.amax(dim=-1) > 0.0

    cos_light = dot(lnrm, -stl_u)
    cos_surf = torch.abs(dot(ev["n"], stl_u))
    g = torch.clamp(cos_light * cos_surf / d2, max=MAX_G_NEE)
    pdf_connect = true_div(float(np.float32(1.0 / num)),
                           torch.clamp(area, min=1e-20))
    pdf_emit_sa = true_div(cos_light, PI)

    stl_local = to_local(stl_u, ev["n"])
    ones = torch.ones(n, dtype=torch.float32, device=p.device)
    f_val = bsdf_ops.bsdf_f(mat_e, albedo_e, -prev_to_curr_local, stl_local,
                            ones, transmission=trans_e)
    contrib = shadow * f_val * le * (g / pdf_connect)[:, None]
    ok = active & clear & (cos_light >= EPSILON)
    return dict(ok=ok, contrib=contrib, pdf_connect=pdf_connect,
                pdf_emit_sa=pdf_emit_sa, cos_light=cos_light, d2=d2,
                stl_local=stl_local)


def connect_plain(scene, camera, key_c, ebufs, ev0, esc, lbufs, lv0,
                  cfg: BDPTConfig, ids, fb=None):
    """Plain version of K13 (any device): its two stages in turn,
    connect_pairs_plain then connect_gather_plain (the environment term,
    then for t = 2..eye_depth the s=0, s=1 and s>=2 strategies in that
    order, then fb [N,3] if given). lv0 is not read: s=1 samples the
    light. Returns (li [N,3], rays as a Python int)."""
    terms, rays = connect_pairs_plain(scene, key_c, ebufs, lbufs, cfg, ids)
    return connect_gather_plain(scene, camera, ebufs, ev0, esc, terms, cfg,
                                fb), rays


def connect_pairs_plain(scene, key_c, ebufs, lbufs, cfg: BDPTConfig, ids):
    """Plain version of K13's first stage (kernels.bdpt_pairs): for each
    eye depth t = 2..eye_depth, slot 0 the s=1 (NEE) term and slot 1 + j
    the s=j+2 connection to stored light vertex j, each weighted, +0 where
    the eye vertex is invalid or delta, the strategy is off, nothing was
    traced or the ray was blocked. Returns (terms [eye_depth - 1,
    light_depth, N, 3], rays as a Python int)."""
    n, dev = ids.shape[0], ids.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    terms = torch.zeros((cfg.eye_depth - 1, cfg.light_depth, n, 3),
                        dtype=torch.float32, device=dev)
    rays = 0
    lverts = []
    if cfg.connection and cfg.light_depth >= 2:
        lverts = [_vertex(lbufs, j) for j in range(cfg.light_depth - 1)]

    for t in range(2, cfg.eye_depth + 1):
        ev = _vertex(ebufs, t - 2)
        mat_e = _gather_mat(scene, ev["mat_id"])
        albedo_e = bsdf_ops.resolve_albedo(scene, mat_e, ev["uv"])
        trans_e = bsdf_ops.resolve_transmission(scene, mat_e, ev["uv"])

        # s = 1: NEE
        if cfg.nee and scene.num_lights > 0:
            do = ev["valid"] & ~ev["is_delta"]
            prev_to_curr_local = to_local(-ev["wo"], ev["n"])
            rays += int(do.sum())
            ne = _bdpt_nee(scene, key_c, t, ev, mat_e, albedo_e,
                           prev_to_curr_local, do, ids, trans_e)
            pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat_e, -prev_to_curr_local,
                                            ne["stl_local"], ones,
                                            transmission=trans_e)
            pdf_bsdf_area = (pdf_bsdf_sa * torch.abs(ne["cos_light"])
                             / ne["d2"])
            w_light = pdf_bsdf_area / torch.clamp(ne["pdf_connect"],
                                                  min=1e-20)
            pdf_curr_rev_area = (ne["pdf_emit_sa"]
                                 * torch.abs(ne["stl_local"][..., 2])
                                 / ne["d2"])
            pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat_e, ne["stl_local"],
                                                -prev_to_curr_local, ones,
                                                transmission=trans_e)
            w_eye = pdf_curr_rev_area * (ev["d_vcm"]
                                         + pdf_prev_rev_sa * ev["d_vc"])
            weight = 1.0 / (1.0 + w_light + w_eye)
            out = _weighted(ne["contrib"] * ev["beta"], weight, cfg)
            terms[t - 2, 0] = torch.where((do & ne["ok"])[:, None], out, 0.0)

        # s >= 2: connections to the stored light vertices
        if lverts:
            terms[t - 2, 1:len(lverts) + 1], r = _connect_rows(
                scene, ev, mat_e, albedo_e, trans_e, lverts, ones, cfg)
            rays += r
    return terms, rays


def connect_gather_plain(scene, camera, ebufs, ev0, esc, terms,
                         cfg: BDPTConfig, fb=None):
    """Plain version of K13's second stage (kernels.bdpt_gather): from
    zero, the environment term, then for t = 2..eye_depth up to the first
    invalid eye vertex, skipping delta ones, the s=0 term (computed here:
    it traces no ray) and the terms of connect_pairs_plain in slot order,
    then fb [N,3] if given. Returns li [N,3]."""
    n, dev = ebufs.pt.shape[1], ebufs.pt.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    li = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if cfg.sample_environment:
        sky = common.sample_sky(esc.d, True)
        out = _weighted(esc.beta * sky, ones, cfg)
        li = li + torch.where(esc.valid[:, None], out, 0.0)
    plane_area = camera.plane_area()
    num_lights = max(scene.num_lights, 1)
    fwd = torch.tensor(camera.forward, dtype=torch.float32,
                       device=dev).expand(n, 3)
    reached = torch.ones(n, dtype=torch.bool, device=dev)
    for t in range(2, cfg.eye_depth + 1):
        ev = _vertex(ebufs, t - 2)
        # as the kernel: stop at the first invalid eye vertex, skip delta
        reached = reached & ev["valid"]
        live = (reached & ~ev["is_delta"])[:, None]
        # s = 0: the eye walk hit a light
        if cfg.naive:
            first_t = t == 2
            if first_t:
                ev_prev_pt = ev0["pt"]
                ev_prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
            else:
                prev = paths.PathBuffers(*(f[t - 3] for f in ebufs))
                ev_prev_pt, ev_prev_delta = prev.pt, prev.is_delta
            is_light = ((ev["light_ind"] >= 0) & ~ev["backface"]
                        & ev["valid"] & ~ev["is_delta"])
            lrow = scene.light_f32[torch.clamp(ev["light_ind"], min=0)]
            le, area = lrow[:, 12:15], lrow[:, 15]
            cos_l = torch.abs(dot(ev["n"], normalize(ev["wo"])))
            d2 = torch.clamp(length_sq(ev["pt"] - ev_prev_pt), min=1e-20)
            pdf_connect = true_div(float(np.float32(1.0 / num_lights)),
                                   torch.clamp(area, min=1e-20))
            if first_t:
                # weigh against the camera trace pdf (prev is the lens)
                cos_cam = torch.abs(dot(fwd, -normalize(ev["wo"])))
                pdf_trace_cam = cos_l / (d2 * plane_area * _cube(cos_cam))
                w_eye = pdf_connect / torch.clamp(pdf_trace_cam, min=1e-20)
            else:
                pdf_c = torch.where(ev_prev_delta, 0.0, pdf_connect)
                w_eye = (pdf_c * ev["d_vcm"]
                         + pdf_c * true_div(cos_l, PI) * ev["d_vc"])
            contrib = le * ev["beta"]
            if not first_t:
                lum = luminance(contrib)
                scale = torch.where(
                    lum > MAX_FIREFLY_LUM,
                    MAX_FIREFLY_LUM / torch.clamp(lum, min=1e-20), 1.0)
                contrib = contrib * scale[:, None]
            weight = 1.0 / (1.0 + w_eye)
            out = _weighted(contrib, weight, cfg)
            li = li + torch.where(is_light[:, None], out, 0.0)
        # s = 1, then s >= 2 in light-vertex order
        if cfg.nee and scene.num_lights > 0:
            li = li + torch.where(live, terms[t - 2, 0], 0.0)
        if cfg.connection:
            for s in range(1, cfg.light_depth):
                li = li + torch.where(live, terms[t - 2, s], 0.0)
    return li if fb is None else li + fb


def _connect_rows(scene, ev, mat_e, albedo_e, trans_e, lverts, ones, cfg):
    """One s>=2 connection per lane to each light row of lverts, their
    shadow rays traced in one call -> (the weighted terms [L, N, 3], +0
    where nothing was traced or the ray was blocked; rays as a Python
    int)."""
    geo = []
    for lv in lverts:
        do = ev["valid"] & lv["valid"] & ~ev["is_delta"] & ~lv["is_delta"]
        e2l = lv["pt"] - ev["pt"]
        d2 = torch.clamp(length_sq(e2l), min=RAY_EPSILON)
        dist = torch.sqrt(d2)
        e2l_u = e2l / dist[:, None]
        cos_l = torch.abs(dot(lv["n"], -e2l_u))
        cos_e = torch.abs(dot(ev["n"], e2l_u))
        do = do & (cos_l > EPSILON) & (cos_e > EPSILON)
        geo.append((do, e2l_u, dist, cos_l, cos_e, d2))
    do = torch.stack([g[0] for g in geo])
    origin = ev["pt"] + ev["n"] * RAY_EPSILON
    shadow = traverse.shadow_factor_rows(
        scene, origin.expand(len(geo), -1, -1),
        torch.stack([g[1] for g in geo]),
        torch.stack([g[2] - RAY_EPSILON for g in geo]), do)
    out = torch.empty((len(geo), ones.shape[0], 3), dtype=torch.float32,
                      device=ones.device)
    for j, (lv, (_, e2l_u, _, cos_l, cos_e, d2)) in enumerate(zip(lverts,
                                                                 geo)):
        term = _connect_term(scene, ev, mat_e, albedo_e, trans_e, lv, e2l_u,
                             cos_l, cos_e, d2, shadow[j], ones, cfg)
        ok = do[j] & (shadow[j].amax(dim=-1) > 0.0)
        out[j] = torch.where(ok[:, None], term, 0.0)
    return out, int(do.sum())


def _connect_term(scene, ev, mat_e, albedo_e, trans_e, lv, e2l_u, cos_l,
                  cos_e, d2, shadow, ones, cfg):
    """The weighted s>=2 term of each lane's connection to lv, shadowed."""
    mat_l = _gather_mat(scene, lv["mat_id"])
    albedo_l = bsdf_ops.resolve_albedo(scene, mat_l, lv["uv"])
    trans_l = bsdf_ops.resolve_transmission(scene, mat_l, lv["uv"])

    l2e_loc_l = to_local(-e2l_u, lv["n"])
    to_l_from_prev_loc = to_local(-lv["wo"], lv["n"])
    l2e_loc_e = to_local(-e2l_u, ev["n"])
    to_prev_loc_e = to_local(ev["wo"], ev["n"])

    # four reverse pdfs (pdf_eval(A, B) is bsdf_pdf(-A, B))
    pdf_eye_rev_sa = bsdf_ops.bsdf_pdf(mat_l, -to_l_from_prev_loc, l2e_loc_l,
                                       ones, transmission=trans_l)
    pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2
    pdf_bef_eye_rev_sa = bsdf_ops.bsdf_pdf(mat_e, -l2e_loc_e, to_prev_loc_e,
                                           ones, transmission=trans_e)
    pdf_light_rev_sa = bsdf_ops.bsdf_pdf(mat_e, to_prev_loc_e, -l2e_loc_e,
                                         ones, transmission=trans_e)
    pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2
    pdf_bef_light_rev_sa = bsdf_ops.bsdf_pdf(mat_l, l2e_loc_l,
                                             -to_l_from_prev_loc, ones,
                                             transmission=trans_l)
    w_eye = pdf_eye_rev_area * (ev["d_vcm"] + pdf_bef_eye_rev_sa * ev["d_vc"])
    w_light = pdf_light_rev_area * (lv["d_vcm"]
                                    + pdf_bef_light_rev_sa * lv["d_vc"])
    weight = 1.0 / (1.0 + w_eye + w_light)

    # f_eval(A, B) is bsdf_f(-A, B)
    f_eye = bsdf_ops.bsdf_f(mat_e, albedo_e, -l2e_loc_e, to_prev_loc_e, ones,
                            transmission=trans_e)
    f_light = bsdf_ops.bsdf_f(mat_l, albedo_l, l2e_loc_l, -to_l_from_prev_loc,
                              ones, transmission=trans_l)
    g = torch.clamp(cos_e * cos_l / d2, max=MAX_G_CONNECT)
    contrib = ev["beta"] * lv["beta"] * f_eye * f_light * g[:, None] * shadow
    return _weighted(contrib, weight, cfg)


# --- one sample --------------------------------------------------------------

def nee_key_table(key_c, eye_depth: int) -> torch.Tensor:
    """Plain version of K13's s=1 key table (bdpt_pairs.cu's prologue,
    kernels/csrc/keys.cuh nee_key_tables): for t = 0..eye_depth the pairs
    draw_key(fold_in(key_c, t), 0..2), the keys _bdpt_nee folds ->
    int32 [(eye_depth + 1) * 3, 2]."""
    return rng.fold_table(key_c, 3, rows=eye_depth + 1)


# the sample's stages, each a program span when tracing (utils/metrics.py)
STAGES = {st: f"tpt.step.bdpt.{st}"
          for st in ("light_walk", "splat", "eye_walk", "connect")}


def sample_keys(base_key, sample_idx):
    """(key_l, key_e, key_c) of a sample."""
    skey = rng.sample_key(base_key, sample_idx)
    return tuple(rng.fold_in(skey, s) for s in (1, 2, 3))


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: BDPTConfig, splat_shape: int | None = None):
    """One BDPT sample over the whole frame (px, py [P] in raster order)
    -> (radiance [P,3] with the light-trace splat added, rays traced: a
    Python int on the CPU, a 0-d int64 tensor on the card).

    splat_shape (tile sharding): px, py are one tile of the frame and
    splat_shape its pixel count (camera.width * camera.height); the splat
    goes into a frame buffer of that many raster pixels, returned beside
    the tile's radiance: (li [P,3] without the splat, fb [splat_shape,3],
    rays). Without it the result is the same as li + fb."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py, cfg=cfg,
              splat_shape=splat_shape)


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 cfg: BDPTConfig, splat_shape: int | None = None):
    """Plain versions of K12, K11, K12 and K13 in turn; any device."""
    key_l, key_e, key_c = sample_keys(base_key, sample_idx)
    n = px.shape[0]
    with span(STAGES["light_walk"]):
        lbufs, lv0, rays_l = paths.generate_light_path(
            scene, key_l, px, py, cfg.light_depth)
    fb = torch.zeros((splat_shape or n, 3), dtype=torch.float32,
                     device=px.device)
    rays_s = 0
    if cfg.light_trace:
        with span(STAGES["splat"]):
            fb, rays_s = light_trace_splat(scene, camera, lbufs, lv0, cfg,
                                           fb)
    with span(STAGES["eye_walk"]):
        ebufs, ev0, esc, rays_e = paths.generate_eye_path(
            scene, camera, key_e, px, py, cfg.eye_depth)
    with span(STAGES["connect"]):
        li, rays_c = connect_plain(scene, camera, key_c, ebufs, ev0, esc,
                                   lbufs, lv0, cfg, rng.pixel_ids(px, py),
                                   None if splat_shape else fb)
    rays = rays_l + rays_e + rays_s + rays_c
    return (li, fb, rays) if splat_shape else (li, rays)


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: BDPTConfig, splat_shape: int | None = None):
    """K12 (light), K11, K12 (eye), K13 (pairs, gather): five launches and
    one ray-count accumulator [P], summed on the card (a 0-d int64 tensor;
    no host sync). With splat_shape the gather adds no frame buffer."""
    key_l, key_e, key_c = sample_keys(base_key, sample_idx)
    n, dev = px.shape[0], px.device
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    with span(STAGES["light_walk"]):
        lw = kernels.bdpt_walk(scene, px, py,
                               paths.walk_keys(key_l, "light"), mode="light",
                               max_depth=cfg.light_depth, rays=rays)
    fb = torch.zeros((splat_shape or n, 3), dtype=torch.float32, device=dev)
    if cfg.light_trace:
        with span(STAGES["splat"]):
            kernels.bdpt_splat(scene, camera, lw["bufs"], lw["v0"], fb, rays,
                               cfg)
    with span(STAGES["eye_walk"]):
        ew = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_e, "eye"),
                               mode="eye", max_depth=cfg.eye_depth,
                               rays=rays, camera=camera)
    with span(STAGES["connect"]):
        out, _ = kernels.bdpt_connect(scene, camera, key_c, ew, lw,
                                      None if splat_shape else fb, rays, cfg,
                                      px=px, py=py)
    return (out, fb, rays.sum()) if splat_shape else (out, rays.sum())
