"""Vertex connection and merging, and SPPM as flag-restricted VCM
("Integrator: VCM" / "SPPM" with "Engine: classic").

Counterpart of cudapathtracer_tpu/models/vcm.py. One sample is:
  1. the light pass: the VCM light walk (models/paths.py with eta_vcm, the
     d_vm chain) of light_depth stored vertices per pixel id, and the t=1
     light-trace splat with VCM's eta_vcm term (the endpoint is not
     splatted);
  2. the photon grid over every stored light vertex that is valid and not
     delta (ops/hashgrid.py, salted per sample);
  3. the eye pass: an eye walk of eye_depth bounces, each bounce adding
     s=0 (a light hit), s=1 (NEE), s>=2 (a connection to every stored
     light vertex of the same pixel id) and the merge with the photons
     within the merge radius, in three stages: the walk with s=0 and NEE
     (per-vertex records), the connections (one per eye vertex, light
     vertex and pixel), the merge and the sum of the terms in the JAX
     order.
SPPM turns off the connections, NEE, the light hits, the splat and MIS,
and ends each eye path after its first non-delta surface.

On CUDA tensors `render_sample` launches K12 (bdpt_walk.cu, light mode
with eta_vcm), K11's VCM form (vcm_splat, bdpt_splat.cu), K8 (photon_pack,
photon_table: photon_grid.cu, around the stable radix sort photon_sort:
radix_sort.cu) and the eye pass (K13's VCM form with the K9 merge:
eye_walk.cu, eye_connect.cu, eye_gather.cu): eight launches per sample
(SPPM: no splat and no connection stage). On CPU tensors it runs `render_plain`, the plain
versions operation for operation over [N] lanes (each eye stage's twin:
eye_walk_plain, eye_connect_plain, eye_gather_plain). The merge radius,
eta_vcm and the merge normalisation are float32 values computed once per
sample on the host (`sample_scalars`) and given to both.

Kept quirks of the JAX estimator: no eta_vcm in the s=0 weight; depth 0
exempt from the firefly clamp at s=0; NEE's w_light is the squared ratio;
the firefly clamp on every s>=1 contribution; connections test
cos >= EPSILON; the eye side's direction to its previous vertex is
normalize(prev_pt - pos); the merge's w_eye/w_light divide d_vcm by
max(eta_vcm, 1e-30). The splat's frame buffer is indexed by raster pixel
(the pixel list must be the whole frame in raster order, as
driver.Renderer gives it).

Tile sharding (parallel/sharding.py): with `splat_shape` the pixel list is
one tile and the splat's frame buffer the whole frame, returned beside the
tile's radiance (as models/bdpt.py). With `photon_group`, the ranks of the
tile axis, each rank's photon rows and their validity are all-gathered in
the order one rank holding every tile would pack them (depth-major, the
tiles in rank order within a depth), the grid is built on their union (on
the card by K8's rows mode), so a capped cell keeps the photons the single
rank keeps, and the merge radius, eta_vcm and the merge normalisation count
every rank's paths; the connections keep the rank's own light paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import bdpt, common, mis, paths
from cudapathtracer_tpu_torch.models.bdpt import (MAX_G_CONNECT, _bdpt_nee,
                                                  _gather_mat, _vertex,
                                                  _weighted)
from cudapathtracer_tpu_torch.ops import bsdf as bsdf_ops
from cudapathtracer_tpu_torch.ops import hashgrid, traverse
from cudapathtracer_tpu_torch.scene.materials import MaterialTable
from cudapathtracer_tpu_torch.utils import rng
from cudapathtracer_tpu_torch.utils.math import (EPSILON, MAX_FIREFLY_LUM,
                                                 PI, RAY_EPSILON, dot,
                                                 length_sq, luminance,
                                                 merge_radius, normalize,
                                                 to_local, to_world,
                                                 true_div)
from cudapathtracer_tpu_torch.utils.metrics import span


@dataclass(frozen=True)
class VCMConfig:
    eye_depth: int = 16
    light_depth: int = 10
    light_trace: bool = True
    nee: bool = True
    naive: bool = True
    connection: bool = True
    do_mis: bool = True
    do_merge: bool = True
    do_sppm: bool = False
    paint_weight: bool = False
    merge_alpha: float = 0.7           # "VCM Merge Radius Power Factor"
    r0_multiplier: float = 0.01        # "VCM Initial Merge Radius Multiplier"
    max_per_cell: int = 8              # the merge's per-cell cap
    sample_environment: bool = False

    @staticmethod
    def from_config(cfg) -> "VCMConfig":
        return VCMConfig(
            eye_depth=max(cfg.bdpt_eye_depth, 1),
            light_depth=max(cfg.bdpt_light_depth, 1),
            light_trace=cfg.bdpt_light_trace, nee=cfg.bdpt_nee,
            naive=cfg.bdpt_naive, connection=cfg.bdpt_connection,
            do_mis=cfg.bdpt_do_mis, do_merge=cfg.vcm_do_merge,
            do_sppm=cfg.do_sppm, paint_weight=cfg.bdpt_paint_weight,
            merge_alpha=cfg.vcm_merge_const or 0.7,
            r0_multiplier=cfg.vcm_initial_merge_radius_multiplier or 0.01,
            max_per_cell=max(int(getattr(cfg, "vcm_max_per_cell", 8)), 1),
            sample_environment=cfg.sample_environment)


def sample_scalars(scene, cfg: VCMConfig, sample_idx: int, n_paths: int):
    """(merge radius, eta_vcm, merge normalisation) of a sample as float32
    values (Python floats), in the JAX package's operation order:
    r0 = scene_radius * r0_multiplier, mr = r0 sqrt((1/(s+1))^alpha),
    eta_vcm = (n pi) mr mr, merge_norm = 1 / (pi mr mr n)."""
    f = np.float32
    r0 = f(scene.scene_radius) * f(cfg.r0_multiplier)
    mr = f(merge_radius(r0, sample_idx, cfg.merge_alpha))
    eta = f(n_paths * PI) * mr * mr
    norm = f(1.0) / (f(PI) * mr * mr * f(n_paths))
    return float(mr), float(eta), float(norm)


def sample_keys(base_key, sample_idx):
    """(key_l, key_e) of a sample."""
    skey = rng.sample_key(base_key, sample_idx)
    return rng.fold_in(skey, 1), rng.fold_in(skey, 2)


def _clamp_firefly(c):
    lum = luminance(c)
    scale = torch.where(lum > MAX_FIREFLY_LUM,
                        true_div(MAX_FIREFLY_LUM, torch.clamp(lum, min=1e-20)),
                        1.0)
    return c * scale[:, None]


def _take(mat: MaterialTable, idx) -> MaterialTable:
    return MaterialTable(**{f.name: getattr(mat, f.name)[idx]
                            for f in dataclasses.fields(mat)})


# --- t=1: the VCM light-trace splat (K11's VCM form) -------------------------

def vcm_light_splat(scene, camera, lbufs, cfg: VCMConfig, eta_vcm: float,
                    fb):
    """Plain version of vcm_splat (any device): every stored light vertex
    (not the endpoint) to the lens, w_light with eta_vcm, added into the
    raster-indexed fb [P,3] in place in depth order. Returns (fb, rays as
    a Python int)."""
    rays = 0
    for j in range(lbufs.pt.shape[0]):
        rays += bdpt._splat_vertex(scene, camera, _vertex(lbufs, j), False,
                                   cfg, fb, eta_vcm=eta_vcm)
    return fb, rays


# --- the eye pass (K13's VCM form with the K9 merge), in three stages --------

# the record's flag bits (kernels/csrc/eye.cuh kRec*); a depth the walk did
# not reach is 0
REC_VALID = 1       # a hit whose BSDF sample has pdf >= EPSILON
REC_NON_DELTA = 2   # a hit on a non-delta surface
REC_ESCAPED = 4     # the closest ray missed: the implicit slot holds the sky
REC_END = 8         # the walk's last record
REC_CONN = REC_VALID | REC_NON_DELTA   # the strategies ran at the vertex


class EyeRecords(NamedTuple):
    """The eye walk stage's output, depth-major [D, N, ...] (eye.cuh
    EyeRecs): each vertex's record, which the connection and gather stages
    read, and the two terms the walk computed there. A hit holds every
    field; an escape its flags and the sky term in `implicit`; a depth the
    walk did not reach its flags (0). The plain stages write zeros where
    the kernel writes nothing."""
    pos: torch.Tensor       # [D,N,3] f32
    n: torch.Tensor         # [D,N,3] f32, the shade-time normal
    to_prev: torch.Tensor   # [D,N,3] f32, normalize(prev - pos)
    thr: torch.Tensor       # [D,N,3] f32, the throughput at the vertex
    albedo: torch.Tensor    # [D,N,3] f32
    trans: torch.Tensor     # [D,N] f32
    mat_id: torch.Tensor    # [D,N] i32 (scene.mat_f32's row)
    d_vcm: torch.Tensor     # [D,N] f32
    d_vc: torch.Tensor      # [D,N] f32
    d_vm: torch.Tensor      # [D,N] f32
    flags: torch.Tensor     # [D,N] i32, REC_*
    implicit: torch.Tensor  # [D,N,3] f32, s=0 (or the sky at an escape)
    nee: torch.Tensor       # [D,N,3] f32, s=1

    @classmethod
    def empty(cls, depth: int, n: int, device, fill=torch.empty):
        f = lambda *tail, dt=torch.float32: fill((depth, n) + tail,
                                                 dtype=dt, device=device)
        return cls(pos=f(3), n=f(3), to_prev=f(3), thr=f(3), albedo=f(3),
                   trans=f(), mat_id=f(dt=torch.int32), d_vcm=f(), d_vc=f(),
                   d_vm=f(), flags=f(dt=torch.int32), implicit=f(3),
                   nee=f(3))

    def put(self, t: int, where, **fields) -> None:
        """Write fields of depth t on the lanes `where` (others keep their
        values)."""
        for k, v in fields.items():
            dst = getattr(self, k)[t]
            m = where if dst.dim() == 1 else where[:, None]
            dst.copy_(torch.where(m, v, dst))

    def eye(self, scene, t: int) -> dict:
        """Depth t's vertices as the strategies take them (the material
        re-read from mat_f32's rows, which equal the shade rows'; row 0
        where the strategies did not run, whose fields the kernel leaves
        unwritten)."""
        mat_id = torch.where(self.conn(t), self.mat_id[t], 0)
        return dict(pos=self.pos[t], n=self.n[t], to_prev=self.to_prev[t],
                    thr=self.thr[t], albedo=self.albedo[t],
                    trans=self.trans[t], d_vcm=self.d_vcm[t],
                    d_vc=self.d_vc[t], d_vm=self.d_vm[t],
                    mat=_gather_mat(scene, mat_id))

    def conn(self, t: int):
        """[N] bool: the strategies ran at depth t."""
        return (self.flags[t] & REC_CONN) == REC_CONN


def record_flags(reached, missed, valid, cur_delta, stop, last: bool):
    """The flag word of one depth: hits VALID / NON_DELTA / END, escapes
    ESCAPED | END, the rest 0."""
    hit = (valid.int() * REC_VALID + (~cur_delta).int() * REC_NON_DELTA
           + (stop | last).int() * REC_END)
    return torch.where(reached, hit, torch.where(
        missed, REC_ESCAPED | REC_END, 0)).to(torch.int32)


def eye_key_table(key_e, eye_depth: int) -> torch.Tensor:
    """Plain version of the classic eye walk's key table (eye_walk.cu's
    prologue, kernels/csrc/keys.cuh eye_key_tables): per depth the BSDF
    pairs draw_key(bounce_key(key_e, depth), 0..3), then NEE's
    draw_key(fold_in(bounce_key(key_e, depth), 7), 0..2), the keys
    eye_walk_plain folds -> int32 [eye_depth * 7, 2]."""
    bsdf = rng.fold_table(key_e, 4, rows=eye_depth).view(eye_depth, 4, 2)
    nee = rng.fold_table(key_e, 3, rows=eye_depth, mid=7) \
        .view(eye_depth, 3, 2)
    return torch.cat([bsdf, nee], 1).reshape(-1, 2)


def eye_walk_plain(scene, camera, key_e, cfg: VCMConfig, px, py,
                   eta_vcm: float):
    """Plain version of the classic eye walk stage (eye_walk.cu, any
    device): every pixel's walk with s=0 and NEE per vertex, in the JAX
    order. -> (EyeRecords [eye_depth, N], closest and NEE rays as a Python
    int)."""
    n, dev = px.shape[0], px.device
    ids = rng.pixel_ids(px, py)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    start, _ = paths.start_eye_walk(scene, camera, key_e, px, py, ids)
    o, d, thr = start.o, start.d, start.throughput
    prev_pdf_sa, prev_cos, prev_pt = (start.prev_pdf_sa, start.prev_cos,
                                      start.prev_pt)
    mstate = mis.MisState.zeros(n, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    rec = EyeRecords.empty(cfg.eye_depth, n, dev, fill=torch.zeros)
    rays = 0
    for depth in range(cfg.eye_depth):
        if not bool(alive.any()):
            break
        bkey = rng.bounce_key(key_e, depth)
        rays += int(alive.sum())
        hit = traverse.closest_hit(scene, o, d, active=alive)
        info, mat = traverse.shade_data(scene, o, d, hit)
        reached = alive & hit.valid
        missed = alive & ~hit.valid
        if cfg.sample_environment:
            sky = _weighted(thr * common.sample_sky(d, True), ones, cfg)
            rec.put(depth, missed, implicit=sky)

        normal, pos = info["normal"], info["point"]
        wo_local = to_local(d, normal)
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
        cur_delta = mat.is_specular

        d2p = torch.clamp(length_sq(pos - prev_pt), min=RAY_EPSILON)
        pdf_fwd_area = prev_pdf_sa * torch.abs(wo_local[..., 2]) / d2p
        g = prev_cos / d2p
        wi_local, f_val, pdf_sa = bsdf_ops.bsdf_sample(
            bkey, 0, mat, albedo, -wo_local, info["backface"], ones, 0,
            ids=ids, transmission=trans)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, wi_local, -wo_local, ones,
                                       transmission=trans)
        valid = reached & (pdf_sa >= EPSILON)
        first_d_vcm = 1.0 / torch.clamp(pdf_fwd_area, min=1e-20)
        d_vcm, d_vc, d_vm, mstate2 = mis.advance(
            mstate, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
            first_d_vcm, zeros, zeros, eta_vcm)

        conn = valid & ~cur_delta
        ev = dict(pt=pos, n=normal, uv=info["uv"])
        prev_to_curr_local = to_local(pos - prev_pt, normal)
        to_prev = normalize(prev_pt - pos)

        # s = 0: the eye walk hit a light (no eta_vcm in this weight)
        s0 = torch.zeros_like(pos)
        if cfg.naive:
            s0 = implicit_vcm(scene, info, conn, to_prev, prev_delta, thr,
                              d_vcm, d_vc, depth, cfg)

        # s = 1: NEE, w_light the squared pdf ratio
        nee = torch.zeros_like(pos)
        if cfg.nee and scene.num_lights > 0:
            rays += int(conn.sum())
            ne = _bdpt_nee(scene, bkey, 7, ev, mat, albedo,
                           prev_to_curr_local, conn, ids, trans)
            pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat, -prev_to_curr_local,
                                            ne["stl_local"], ones,
                                            transmission=trans)
            pdf_bsdf_area = (pdf_bsdf_sa * torch.abs(ne["cos_light"])
                             / ne["d2"])
            ratio = pdf_bsdf_area / torch.clamp(ne["pdf_connect"], min=1e-20)
            w_light = ratio * ratio
            pdf_curr_rev_area = (ne["pdf_emit_sa"]
                                 * torch.abs(ne["stl_local"][..., 2])
                                 / ne["d2"])
            pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat, ne["stl_local"],
                                                -prev_to_curr_local, ones,
                                                transmission=trans)
            w_eye = pdf_curr_rev_area * (eta_vcm + d_vcm
                                         + pdf_prev_rev_sa * d_vc)
            weight = 1.0 / (1.0 + w_light + w_eye)
            out = _clamp_firefly(_weighted(ne["contrib"] * thr, weight, cfg))
            nee = torch.where((conn & ne["ok"])[:, None], out, 0.0)

        # SPPM ends the walk after its first non-delta surface
        keep = valid
        if cfg.do_sppm and cfg.do_merge:
            keep = keep & cur_delta
        rec.put(depth, reached, pos=pos, n=normal, to_prev=to_prev, thr=thr,
                albedo=albedo, trans=trans, mat_id=info["mat_id"],
                d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm, implicit=s0, nee=nee)
        rec.flags[depth] = record_flags(reached, missed, valid, cur_delta,
                                        ~keep, depth == cfg.eye_depth - 1)

        # continue the walk
        new_thr = thr * f_val * (torch.abs(wi_local[..., 2])
                                 / torch.clamp(pdf_sa, min=1e-20))[:, None]
        wi_world = normalize(to_world(wi_local, normal))
        side = torch.where(dot(wi_world, normal) < 0.0, -1.0, 1.0)
        new_o = pos + normal * (side * RAY_EPSILON)[:, None]
        upd = valid[:, None]
        o = torch.where(upd, new_o, o)
        d = torch.where(upd, wi_world, d)
        thr = torch.where(upd, new_thr, thr)
        prev_pdf_sa = torch.where(valid, pdf_sa, prev_pdf_sa)
        prev_cos = torch.where(valid, torch.abs(wi_local[..., 2]), prev_cos)
        prev_pt = torch.where(upd, pos, prev_pt)
        mstate = mis.MisState(*(torch.where(valid, a2, a1)
                                for a2, a1 in zip(mstate2, mstate)))
        alive = keep
        prev_delta = torch.where(reached, cur_delta, prev_delta)
    return rec, rays


def eye_connect_queue_plain(rec: EyeRecords, lbufs):
    """Plain version of the connection stage's queue (eye_connect.cu's
    eye_connect_kernel_queue, any device): the slots (t L + j) N + i of
    the pairs that pass the gate before the shadow ray, eye record t of
    path i ran its strategies and light vertex j of lane i (lbufs [L, >=
    N]) is valid and not delta, in (t, j, i) order -> [Q] int64. The
    kernel's queue holds the same slots in an order of its own."""
    n = rec.flags.shape[1]
    live = (rec.flags & REC_CONN) == REC_CONN
    lanes = lbufs.valid[:, :n] & ~lbufs.is_delta[:, :n]
    return torch.nonzero((live[:, None] & lanes[None]).reshape(-1))[:, 0]


def eye_connect_plain(scene, rec: EyeRecords, lbufs, cfg: VCMConfig,
                      eta_vcm: float):
    """Plain version of the classic connection stage (eye_connect.cu, any
    device): every (eye depth t, light row j, path) pair's clamped
    weighted connection, shadowed on the scene's engine. -> (conn [D, L,
    N, 3], zero where the pair traces nothing; shadow rays as a Python
    int)."""
    depth, n = rec.flags.shape
    lrows = lbufs.pt.shape[0]
    dev = rec.pos.device
    conn = torch.zeros((depth, lrows, n, 3), dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    lverts = [_vertex(lbufs, j) for j in range(lrows)]
    rays = 0
    for t in range(depth):
        live = rec.conn(t)
        if not lverts or not bool(live.any()):
            continue
        conn[t], r = _connect_rows(scene, rec.eye(scene, t), lverts, live,
                                   ones, cfg, eta_vcm)
        rays += r
    return conn, rays


def eye_gather_plain(scene, rec: EyeRecords, conn, grid, cfg: VCMConfig,
                     mr: float, eta_vcm: float, merge_norm: float):
    """Plain version of the classic gather stage (eye_gather.cu, any
    device): per depth the sky, s=0, NEE, the connections j = 0, 1, ...
    and the merge with the photons around the vertex (grid: a PhotonGrid,
    or None without the merge), added in that order from zero. conn: the
    connection stage's [D, L, N, 3], or None. -> (radiance [N,3] without
    the splat, merge-cap dropped photons as a Python int)."""
    depth, n = rec.flags.shape
    li = torch.zeros((n, 3), dtype=torch.float32, device=rec.pos.device)
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
        li = li + torch.where(m, rec.nee[t], 0.0)
        if conn is not None:
            for j in range(conn.shape[1]):
                li = li + torch.where(m, conn[t, j], 0.0)
        if grid is not None:
            e = rec.eye(scene, t)
            e["prev_loc"] = to_local(e["to_prev"], e["n"])
            li, drop = hashgrid.fold_neighbors(
                grid, e["pos"], mr, cfg.max_per_cell,
                _merge_fold(e, cfg, eta_vcm, merge_norm), li, active=live,
                count_dropped=True)
            dropped += drop
    return li, dropped


def eye_pass_plain(scene, camera, key_e, lbufs, grid, cfg: VCMConfig, px, py,
                   mr: float, eta_vcm: float, merge_norm: float):
    """Plain version of vcm_eye (any device): the three stages in turn,
    walk records, pair contributions (with the connections on), the
    ordered gather with the merge. lbufs: the light buffers [light_depth,
    N]; grid: a PhotonGrid or None (no merge). Returns (radiance [N,3]
    without the splat, rays as a Python int, merge-cap dropped photons as
    a Python int)."""
    rec, rays = eye_walk_plain(scene, camera, key_e, cfg, px, py, eta_vcm)
    conn = None
    if cfg.connection:
        conn, r = eye_connect_plain(scene, rec, lbufs, cfg, eta_vcm)
        rays += r
    li, dropped = eye_gather_plain(scene, rec, conn, grid, cfg, mr, eta_vcm,
                                   merge_norm)
    return li, rays, dropped


def implicit_vcm(scene, info, conn, to_prev, prev_delta, thr, d_vcm, d_vc,
                 depth: int, cfg):
    """s = 0 under VCM's weights: what each lane [N,3] adds where its eye
    vertex (shade_data's info, non-delta on conn lanes) is a light seen from
    the front; no eta_vcm in the weight, depth 0 exempt from the clamp."""
    num_lights = max(scene.num_lights, 1)
    is_light = conn & (info["light_ind"] >= 0) & ~info["backface"]
    lrow = scene.light_f32[torch.clamp(info["light_ind"], min=0)]
    le, area = lrow[:, 12:15], lrow[:, 15]
    cos_l = dot(info["normal"], to_prev)
    pdf_connect = torch.where(
        prev_delta, 0.0,
        true_div(float(np.float32(1.0 / num_lights)),
                 torch.clamp(area, min=1e-20)))
    w_eye = (pdf_connect * d_vcm
             + pdf_connect * true_div(cos_l, PI) * d_vc)
    out = _weighted(le * thr, 1.0 / (1.0 + w_eye), cfg)
    if depth > 0:   # directly seen emission is not clamped
        out = _clamp_firefly(out)
    return torch.where(is_light[:, None], out, 0.0)


def _connect_vcm(scene, e, lv, conn, ones, cfg, eta_vcm):
    """s >= 2 against one stored light vertex per lane: (what each lane
    adds, zero where nothing is traced or the ray is blocked; the shadow
    rays traced)."""
    out, rays = _connect_rows(scene, e, [lv], conn, ones, cfg, eta_vcm)
    return out[0], rays


def _connect_rows(scene, e, lverts, conn, ones, cfg, eta_vcm):
    """_connect_vcm against each light row of lverts, their shadow rays
    traced in one call -> ([L, N, 3], the shadow rays traced)."""
    geo = [conn_geometry(e, lv, conn) for lv in lverts]
    do = torch.stack([g[0] for g in geo])
    origin = e["pos"] + e["n"] * RAY_EPSILON
    shadow = traverse.shadow_factor_rows(
        scene, origin.expand(len(geo), -1, -1),
        torch.stack([g[1] for g in geo]),
        torch.stack([g[2] - RAY_EPSILON for g in geo]), do)
    out = torch.empty((len(geo), ones.shape[0], 3), dtype=torch.float32,
                      device=ones.device)
    for j, (lv, (_, e2l_u, _, cos_l, cos_e, d2)) in enumerate(zip(lverts,
                                                                 geo)):
        base, weight = conn_terms(scene, e, lv, ones, e2l_u, cos_l, cos_e,
                                  d2, eta_vcm)
        term = _clamp_firefly(_weighted(base * shadow[j], weight, cfg))
        ok = do[j] & (shadow[j].amax(dim=-1) > 0.0)
        out[j] = torch.where(ok[:, None], term, 0.0)
    return out, int(do.sum())


def conn_geometry(e, lv, conn):
    """The connection's gate and geometry: (do, e2l_u, dist, cos_l, cos_e,
    d2) for eye vertices e and light vertices lv [N]; do = conn, the light
    vertex valid and not delta, both cosines >= EPSILON."""
    do = conn & lv["valid"] & ~lv["is_delta"]
    e2l = lv["pt"] - e["pos"]
    d2 = torch.clamp(length_sq(e2l), min=RAY_EPSILON)
    dist = torch.sqrt(d2)
    e2l_u = e2l / dist[:, None]
    cos_l = torch.abs(dot(lv["n"], -e2l_u))
    cos_e = torch.abs(dot(e["n"], e2l_u))
    do = do & (cos_l >= EPSILON) & (cos_e >= EPSILON)
    return do, e2l_u, dist, cos_l, cos_e, d2


def conn_terms(scene, e, lv, ones, e2l_u, cos_l, cos_e, d2, eta_vcm):
    """The unshadowed connection (((thr beta_l) f_eye) f_light) G and its
    MIS weight with eta_vcm (0 for BDPT's weights)."""
    mat_l = _gather_mat(scene, lv["mat_id"])
    albedo_l = bsdf_ops.resolve_albedo(scene, mat_l, lv["uv"])
    trans_l = bsdf_ops.resolve_transmission(scene, mat_l, lv["uv"])
    mat, trans = e["mat"], e["trans"]
    l2e_loc_l = to_local(-e2l_u, lv["n"])
    to_l_from_prev_loc = to_local(-lv["wo"], lv["n"])
    l2e_loc_e = to_local(-e2l_u, e["n"])
    to_prev_loc_e = to_local(e["to_prev"], e["n"])

    pdf_eye_rev_sa = bsdf_ops.bsdf_pdf(mat_l, -to_l_from_prev_loc, l2e_loc_l,
                                       ones, transmission=trans_l)
    pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2
    pdf_bef_eye_rev_sa = bsdf_ops.bsdf_pdf(mat, -l2e_loc_e, to_prev_loc_e,
                                           ones, transmission=trans)
    pdf_light_rev_sa = bsdf_ops.bsdf_pdf(mat, to_prev_loc_e, -l2e_loc_e,
                                         ones, transmission=trans)
    pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2
    pdf_bef_light_rev_sa = bsdf_ops.bsdf_pdf(mat_l, l2e_loc_l,
                                             -to_l_from_prev_loc, ones,
                                             transmission=trans_l)
    w_eye = pdf_eye_rev_area * (eta_vcm + e["d_vcm"]
                                + pdf_bef_eye_rev_sa * e["d_vc"])
    w_light = pdf_light_rev_area * (eta_vcm + lv["d_vcm"]
                                    + pdf_bef_light_rev_sa * lv["d_vc"])
    weight = 1.0 / (1.0 + w_eye + w_light)

    f_eye = bsdf_ops.bsdf_f(mat, e["albedo"], -l2e_loc_e, to_prev_loc_e,
                            ones, transmission=trans)
    f_light = bsdf_ops.bsdf_f(mat_l, albedo_l, l2e_loc_l, -to_l_from_prev_loc,
                              ones, transmission=trans_l)
    gg = torch.clamp(cos_e * cos_l / d2, max=MAX_G_CONNECT)
    return e["thr"] * lv["beta"] * f_eye * f_light * gg[:, None], weight


def _merge_fold(e, cfg, eta_vcm: float, merge_norm: float):
    """The merge's fold for hashgrid.fold_neighbors: the photon's
    contribution at the eye vertex, evaluated on the in-range lanes only
    (every operation is per lane, so the values are those of the whole
    wavefront's)."""
    def fold(colorsum, row, in_range, w_cell):
        idx = torch.nonzero(in_range)[:, 0]
        if idx.numel() == 0:
            return colorsum
        base, weight = merge_terms(e, idx, row[idx], eta_vcm)
        contrib = base * merge_norm * w_cell[idx][:, None]
        out = _weighted(contrib, weight, cfg)
        return colorsum.index_put((idx,), colorsum[idx] + out)
    return fold


def merge_terms(e, idx, row, eta_vcm: float):
    """The merge of photon rows [K,8] at eye lanes idx [K]: ((beta_p f)
    thr) and the MIS weight. e: the eye vertex (pos, n, mat, albedo,
    trans, thr, d_vcm, d_vm, prev_loc = its direction to the previous
    vertex in its frame)."""
    eta = max(eta_vcm, 1e-30)
    _, wi, p_beta, p_d_vcm, p_d_vm = hashgrid.photon_fields(row)
    mat, nrm = _take(e["mat"], idx), e["n"][idx]
    albedo, trans = e["albedo"][idx], e["trans"][idx]
    prev_loc = e["prev_loc"][idx]
    ones = torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
    wi_loc = to_local(wi, nrm)
    # f and both pdfs in one evaluation, as the kernels' merge does
    f_val, pdf_eye_rev, pdf_light_rev = bsdf_ops.bsdf_eval(
        mat, albedo, wi_loc, prev_loc, ones, transmission=trans)
    w_eye = true_div(e["d_vcm"][idx], eta) + pdf_eye_rev * e["d_vm"][idx]
    w_light = true_div(p_d_vcm, eta) + pdf_light_rev * p_d_vm
    weight = 1.0 / (1.0 + w_eye + w_light)
    return p_beta * f_val * e["thr"][idx], weight


# --- one sample --------------------------------------------------------------

# the sample's stages, each a program span when tracing (utils/metrics.py)
STAGES = {st: f"tpt.step.vcm.{st}"
          for st in ("light_walk", "splat", "photon_grid", "eye_pass")}


def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, splat_shape: int | None = None,
                  photon_group=None):
    """One VCM/SPPM sample over the whole frame (px, py [P] in raster
    order) -> (radiance [P,3] with the splat added, rays traced, photons
    the merge cap left out), the counts as Python ints on the CPU and as
    0-d int64 tensors on the card.

    splat_shape (tile sharding): px, py are one tile, and the result is
    (li [P,3] without the splat, fb [splat_shape,3], rays, dropped), as
    models/bdpt.render_sample's. photon_group: the tile axis's group of
    ranks (parallel/sharding.Group), whose photons the grid gathers (the
    JAX package's photon_axis); None, the rank's own photons."""
    fn = render_plain if px.device.type == "cpu" else render_kernel
    return fn(scene, camera, base_key, sample_idx, px, py, cfg=cfg,
              splat_shape=splat_shape, photon_group=photon_group)


def _grid_inputs(scene, cfg, sample_idx, n, photon_group):
    n_paths = n * (photon_group.size if photon_group is not None else 1)
    mr, eta, norm = sample_scalars(scene, cfg, sample_idx, n_paths)
    return mr, eta, norm, hashgrid.photon_salt(sample_idx)


def _gather_photons(photon_group, rows, valid, n: int):
    """The union of every rank's photon rows [L n, 8] and validity [L n]
    u8 (n paths a rank), in the order of one rank holding every tile's
    paths: depth-major, the tiles in rank order within a depth. The
    capped merge then keeps the photons the single rank keeps."""
    depth = rows.shape[0] // n
    rows = photon_group.all_gather(rows.view(depth, n, 8), dim=1)
    valid = photon_group.all_gather(valid.view(depth, n), dim=1)
    return rows.reshape(-1, 8), valid.reshape(-1)


def render_plain(scene, camera, base_key, sample_idx, px, py, *,
                 cfg: VCMConfig, splat_shape: int | None = None,
                 photon_group=None):
    """Plain versions of K12, the VCM splat, K8 and the eye pass in turn;
    any device."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    n = px.shape[0]
    mr, eta, norm, salt = _grid_inputs(scene, cfg, sample_idx, n,
                                       photon_group)
    with span(STAGES["light_walk"]):
        lbufs, _, rays_l = paths.generate_light_path(
            scene, key_l, px, py, cfg.light_depth + 1, eta_vcm=eta)
    fb = torch.zeros((splat_shape or n, 3), dtype=torch.float32,
                     device=px.device)
    rays_s = 0
    if cfg.light_trace:
        with span(STAGES["splat"]):
            fb, rays_s = vcm_light_splat(scene, camera, lbufs, cfg, eta, fb)
    grid = None
    if cfg.do_merge:
        with span(STAGES["photon_grid"]):
            rows, valid = hashgrid.photon_rows(lbufs)
            if photon_group is not None:
                rows, valid = _gather_photons(photon_group, rows,
                                              valid.to(torch.uint8), n)
                valid = valid.bool()
            grid = hashgrid.build_grid(
                rows, valid, scene.scene_min, mr,
                hashgrid.photon_table_size(rows.shape[0]), salt=salt)
    with span(STAGES["eye_pass"]):
        li, rays_e, dropped = eye_pass_plain(scene, camera, key_e, lbufs,
                                             grid, cfg, px, py, mr, eta, norm)
    rays = rays_l + rays_s + rays_e
    if splat_shape:
        return li, fb, rays, dropped
    return li + fb, rays, dropped


def render_kernel(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, splat_shape: int | None = None,
                  photon_group=None):
    """K12 (light), vcm_splat, photon_pack + photon_sort + photon_table,
    vcm_eye:
    one ray-count and one dropped-count accumulator [P], each summed on the
    card into a 0-d int64 tensor (no host sync). With photon_group the grid
    is photon_pack's rows gathered, then photon_bucket + photon_sort +
    photon_table on the union."""
    key_l, key_e = sample_keys(base_key, sample_idx)
    n, dev = px.shape[0], px.device
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    mr, eta, norm, salt = _grid_inputs(scene, cfg, sample_idx, n,
                                       photon_group)
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    with span(STAGES["light_walk"]):
        lw = kernels.bdpt_walk(scene, px, py,
                               paths.walk_keys(key_l, "light"), mode="light",
                               max_depth=cfg.light_depth + 1, rays=rays,
                               eta_vcm=eta)
    fb = torch.zeros((splat_shape or n, 3), dtype=torch.float32, device=dev)
    if cfg.light_trace:
        with span(STAGES["splat"]):
            kernels.vcm_splat(scene, camera, lw["bufs"], fb, rays, cfg, eta)
    grid = None
    if cfg.do_merge:
        with span(STAGES["photon_grid"]):
            if photon_group is not None:
                rows, valid = _gather_photons(
                    photon_group, *kernels.photon_rows(lw["bufs"]), n)
                grid = hashgrid.build_grid_rows_kernel(
                    rows, valid, scene.scene_min, mr, salt)
            else:
                grid = hashgrid.build_grid_kernel(lw["bufs"],
                                                  scene.scene_min, mr, salt)
    with span(STAGES["eye_pass"]):
        out, dropped, _ = kernels.vcm_eye(
            scene, camera, paths.walk_keys(key_e, "eye"), lw["bufs"], grid,
            None if splat_shape else fb, rays, cfg, px=px, py=py,
            merge_radius=mr, eta_vcm=eta, merge_norm=norm,
            **hashgrid.merge_switches(cfg.max_per_cell))
    if splat_shape:
        return out, fb, rays.sum(), dropped.sum()
    return out, rays.sum(), dropped.sum()
