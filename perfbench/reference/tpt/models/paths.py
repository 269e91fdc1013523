"""Path-vertex buffers and the BDPT/VCM random walks (kernel K12).

Counterpart of cudapathtracer_tpu/models/paths.py. The walks write
DEPTH-MAJOR packed buffers [D, N] (vertex j of every path is one slice)
in the JAX package's layout: octahedral normals and directions, float16
uv and beta, one flag word (utils/packing.py, K10's codecs), float32 MIS
quantities. The walk itself carries unpacked registers; only the
connection and splat stages read the decoded (rounded) vertices.

`generate_eye_path` / `generate_light_path` are the plain versions of the
walk kernel (kernels/csrc/bdpt_walk.cu, which bdpt.render_kernel launches
through kernels.bdpt_walk with the key words of `walk_keys`): a per-depth
loop over all lanes (the JAX scan) through ops/traverse, ops/bsdf and
models/mis, on any device. The kernel steps one bounce of a path a loop
trip on persistent threads (a lane whose path ends takes the next) and
writes the same buffers plus the escape record and the ray count. Every
draw is keyed by the pixel id (py << 14) + px:
  eye raygen   draw_key(fold_in(key_e, 2**20), 0..3)
  light start  draw_key(key_l, 100..104): light pick, sqrt-warp u, v,
               cosine emission u1, u2
  bounce       draw_key(bounce_key(key, depth), 0..3), depth = 1..D
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.tpt.models import mis
from reference.tpt.ops import bsdf as bsdf_ops
from reference.tpt.ops import traverse, traverse8
from reference.tpt.scene.materials import (TRANSPORT_IMPORTANCE,
                                                      TRANSPORT_RADIANCE)
from reference.tpt.utils import packing, rng
from reference.tpt.utils.math import (EPSILON, PI, RAY_EPSILON,
                                                 dot, length_sq, normalize,
                                                 to_local, to_world, true_div)

CAMERA_DRAWS = 2 ** 20          # fold_in(key_e, 2**20): the raygen key
LIGHT_DRAWS = (100, 101, 102, 103, 104)


class PathBuffers(NamedTuple):
    """Depth-major packed path storage; every field [D, N, ...]."""
    pt: torch.Tensor        # [D,N,3] f32
    n_oct: torch.Tensor     # [D,N] int32 (uint32 bits) oct shading normal
    wo_oct: torch.Tensor    # [D,N] int32 (uint32 bits) unit vector to PREV
    uv_h: torch.Tensor      # [D,N,2] f16
    beta_h: torch.Tensor    # [D,N,3] f16 throughput at the vertex
    pdf_fwd: torch.Tensor   # [D,N] f32 area pdf of generating the vertex
    d_vcm: torch.Tensor     # [D,N] f32
    d_vc: torch.Tensor      # [D,N] f32
    d_vm: torch.Tensor      # [D,N] f32 (zero on BDPT walks)
    flags: torch.Tensor     # [D,N] int32 (isDelta|backface|lightInd+1|matID)
    valid: torch.Tensor     # [D,N] bool

    @classmethod
    def encode(cls, *, pt, n, wo, uv, beta, pdf_fwd, d_vcm, d_vc, d_vm,
               is_delta, backface, light_ind, mat_id, valid):
        return cls(pt=pt, n_oct=packing.pack_oct(n),
                   wo_oct=packing.pack_oct(wo), uv_h=uv.to(torch.float16),
                   beta_h=packing.to_half3(beta), pdf_fwd=pdf_fwd,
                   d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm,
                   flags=packing.pack_flags(is_delta, backface, light_ind,
                                            mat_id),
                   valid=valid)

    @classmethod
    def stack(cls, rows: list) -> "PathBuffers":
        """[D] per-depth buffers [N, ...] -> one [D, N, ...] buffer."""
        return cls(*(torch.stack(f) for f in zip(*rows)))

    @classmethod
    def empty(cls, depth: int, n: int, device) -> "PathBuffers":
        """Uninitialized buffers, as the walk kernel fills them."""
        f = lambda *s, dt=torch.float32: torch.empty(
            (depth, n) + s, dtype=dt, device=device)
        return cls(pt=f(3), n_oct=f(dt=torch.int32), wo_oct=f(dt=torch.int32),
                   uv_h=f(2, dt=torch.float16), beta_h=f(3, dt=torch.float16),
                   pdf_fwd=f(), d_vcm=f(), d_vc=f(), d_vm=f(),
                   flags=f(dt=torch.int32), valid=f(dt=torch.bool))

    @classmethod
    def from_numpy(cls, bufs, device="cpu") -> "PathBuffers":
        """The JAX package's PathBuffers (any object with its fields, as
        arrays numpy can read) as the port's; uint32 words keep their
        bits. A d_vm of None (the JAX docstring's BDPT case) is zeros."""
        def conv(name):
            a = getattr(bufs, name)
            if a is None:
                a = np.zeros(np.asarray(bufs.pdf_fwd).shape, np.float32)
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.as_tensor(a.copy()).to(device)
        return cls(*(conv(name) for name in cls._fields))

    @property
    def n(self):
        return packing.unpack_oct(self.n_oct)

    @property
    def wo(self):
        return packing.unpack_oct(self.wo_oct)

    @property
    def uv(self):
        return self.uv_h.to(torch.float32)

    @property
    def beta(self):
        return packing.from_half3(self.beta_h)

    @property
    def is_delta(self):
        return packing.unpack_flags(self.flags)[0]

    @property
    def backface(self):
        return packing.unpack_flags(self.flags)[1]

    @property
    def light_ind(self):
        return packing.unpack_flags(self.flags)[2]

    @property
    def mat_id(self):
        return packing.unpack_flags(self.flags)[3]


class Escape(NamedTuple):
    """The first scene miss of each walk [N...]: the direction and the
    throughput carried out of the scene (the environment light's input)."""
    valid: torch.Tensor    # [N] bool
    d: torch.Tensor        # [N,3]
    beta: torch.Tensor     # [N,3]


class WalkStart(NamedTuple):
    """Endpoint state feeding the walk, all [N...]."""
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor    # [N,3]
    prev_pdf_sa: torch.Tensor   # solid-angle pdf of the emitted direction
    prev_cos: torch.Tensor      # |cos| at the endpoint
    prev_pt: torch.Tensor       # endpoint position
    first_vc_scale: torch.Tensor  # 0 for eye; 1/pdf0 for light walks


def random_walk(scene, key, start: WalkStart, max_depth: int,
                transport_mode: int, eta_vcm=None, first_vm_seed=None,
                ids=None, key_table=None):
    """Plain version of K12's walk: vertices 1..max_depth-1. Returns
    (PathBuffers [max_depth-1, N], Escape, rays traced as a Python int);
    buffer row j holds vertex j + 1. key_table (uint32 [max_depth, 4, 2],
    rng.draw_key_table(key, range(max_depth), range(4))): bounce `depth`
    draws with the pairs of row `depth` through rng.uniform_keyed (K12's
    table mode) instead of folding bounce_key(key, depth); the draws are
    the same bits. The walk traces with the scene's engine (ops/traverse),
    the keyed one with BVH8 on every scene, as the JAX light_mega's fused
    step and K12's table mode do."""
    n, dev = start.o.shape[0], start.o.device
    o, d, thr = start.o, start.d, start.throughput
    prev_pdf_sa, prev_cos, prev_pt = (start.prev_pdf_sa, start.prev_cos,
                                      start.prev_pt)
    mstate = mis.MisState.zeros(n, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    esc = Escape(valid=torch.zeros(n, dtype=torch.bool, device=dev),
                 d=start.d, beta=start.throughput)
    eta_i = torch.ones(n, dtype=torch.float32, device=dev)
    rows, rays = [], 0
    closest = traverse.closest_hit if key_table is None \
        else traverse8.closest_hit8
    for depth in range(1, max_depth):
        bkey = rng.bounce_key(key, depth)
        rays += int(alive.sum())
        hit = closest(scene, o, d, active=alive)
        info, mat = traverse.shade_data(scene, o, d, hit)
        reached = alive & hit.valid
        missed = alive & ~hit.valid
        esc = Escape(valid=esc.valid | missed,
                     d=torch.where(missed[:, None], d, esc.d),
                     beta=torch.where(missed[:, None], thr, esc.beta))

        normal = info["normal"]
        wo_local = to_local(d, normal)           # incoming dir, z < 0
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
        cur_delta = mat.is_specular

        d2 = torch.clamp(length_sq(info["point"] - prev_pt), min=RAY_EPSILON)
        pdf_fwd_area = prev_pdf_sa * torch.abs(wo_local[..., 2]) / d2
        g = prev_cos / d2

        draws = None
        if key_table is not None:
            kt = key_table[depth]
            draws = tuple(_keyed(kt[j], n, ids) for j in range(4))
        wi_local, f_val, pdf_sa = bsdf_ops.bsdf_sample(
            bkey, 0, mat, albedo, -wo_local, info["backface"], eta_i,
            transport_mode, ids=ids, transmission=trans, draws=draws)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, wi_local, -wo_local, eta_i,
                                       transmission=trans)

        first_d_vcm = 1.0 / torch.clamp(pdf_fwd_area, min=1e-20)
        first_d_vc = start.first_vc_scale * g / torch.clamp(pdf_fwd_area,
                                                            min=1e-20)
        first_d_vm = None
        if first_vm_seed is not None:
            first_d_vm = first_vm_seed * g / torch.clamp(pdf_fwd_area,
                                                         min=1e-20)
        d_vcm, d_vc, d_vm, mstate2 = mis.advance(
            mstate, depth == 1, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
            first_d_vcm, first_d_vc, first_d_vm, eta_vcm)

        valid = reached & (pdf_sa >= EPSILON)
        rows.append(PathBuffers.encode(
            pt=info["point"], n=normal, wo=normalize(-d), uv=info["uv"],
            beta=thr, pdf_fwd=pdf_fwd_area, d_vcm=d_vcm, d_vc=d_vc,
            d_vm=d_vm, is_delta=cur_delta, backface=info["backface"],
            light_ind=info["light_ind"], mat_id=info["mat_id"],
            valid=valid))

        # continue the walk
        new_thr = thr * f_val * (torch.abs(wi_local[..., 2])
                                 / torch.clamp(pdf_sa, min=1e-20))[:, None]
        wi_world = normalize(to_world(wi_local, normal))
        side = torch.where(dot(wi_world, normal) < 0.0, -1.0, 1.0)
        new_o = info["point"] + normal * (side * RAY_EPSILON)[:, None]
        upd = valid[:, None]
        o = torch.where(upd, new_o, o)
        d = torch.where(upd, wi_world, d)
        thr = torch.where(upd, new_thr, thr)
        prev_pdf_sa = torch.where(valid, pdf_sa, prev_pdf_sa)
        prev_cos = torch.where(valid, torch.abs(wi_local[..., 2]), prev_cos)
        prev_pt = torch.where(upd, info["point"], prev_pt)
        mstate = mis.MisState(*(torch.where(valid, a2, a1)
                                for a2, a1 in zip(mstate2, mstate)))
        alive = valid
    bufs = (PathBuffers.stack(rows) if rows
            else PathBuffers.empty(0, n, dev))
    return bufs, esc, rays


def _light_rows(scene, li):
    """Light table rows -> (p0, p1, p2, emission, area, tri)."""
    r = scene.light_f32[li]
    return (r[:, 0:3], r[:, 3:6], r[:, 6:9], r[:, 12:15], r[:, 15],
            r[:, 16].contiguous().view(torch.int32))


def _keyed(pair, n, ids):
    """uniform_keyed with one key pair ([2] uint32) for all n lanes."""
    pair = pair.to(ids.device)
    return rng.uniform_keyed(pair[0].expand(n).contiguous(),
                             pair[1].expand(n).contiguous(), ids)


def light_point(scene, key, draw_base, n, ids, draw=None):
    """Uniform light pick + sqrt-warp area sample with the INTERPOLATED
    normal (draws draw_base + 0..2 of `key`, or the ids of LIGHT_DRAWS;
    `draw(j)`, if given, makes draw j instead). Returns (li, tri, point,
    normal, emission, area)."""
    if draw is None:
        draw = lambda j: rng.uniform_any(key, draw_base[j], n, ids)
    ul = draw(0)
    num = max(scene.num_lights, 1)
    li = torch.clamp((ul * num).to(torch.int32), max=num - 1)
    a, b, c, le, area, tri = _light_rows(scene, li)
    n3 = scene.tri_f32[tri, 9:18].reshape(-1, 3, 3)
    u = torch.sqrt(draw(1))
    v = draw(2)
    w0, w1, w2 = (1.0 - u), u * (1.0 - v), u * v
    pt = w0[:, None] * a + w1[:, None] * b + w2[:, None] * c
    nrm = normalize(w0[:, None] * n3[:, 0] + w1[:, None] * n3[:, 1]
                    + w2[:, None] * n3[:, 2])
    return li, tri, pt, nrm, le, area


def start_eye_walk(scene, camera, key, px, py, ids):
    """Camera endpoint -> (WalkStart, vertex 0 dict: pt, n)."""
    o, d = camera.generate_rays_plain(rng.fold_in(key, CAMERA_DRAWS),
                                      px.to(torch.float32),
                                      py.to(torch.float32), ids)
    n = o.shape[0]
    fwd = o.new_tensor(camera.forward).expand(n, 3)
    cos_cam = torch.abs(dot(fwd, d))
    pdf_sa = 1.0 / (camera.plane_area() * (cos_cam * (cos_cam * cos_cam)))
    v0 = dict(pt=o, n=fwd)
    return WalkStart(o=o, d=d, throughput=torch.ones_like(o),
                     prev_pdf_sa=pdf_sa, prev_cos=cos_cam, prev_pt=o,
                     first_vc_scale=torch.zeros_like(cos_cam)), v0


def start_light_walk(scene, key, n, ids, key_table=None):
    """Light endpoint: uniform light pick, area sample, cosine emission;
    beta0 = Le pi / pdf0. key_table (uint32 [5, 2], the pairs of draws
    LIGHT_DRAWS of `key`: rng.draw_key_table(key, None, LIGHT_DRAWS)[0])
    draws through rng.uniform_keyed instead, the same bits.
    -> (WalkStart, vertex 0 dict)."""
    if key_table is None:
        draw = lambda j: rng.uniform_any(key, LIGHT_DRAWS[j], n, ids)
    else:
        draw = lambda j: _keyed(key_table[j], n, ids)
    li, tri, pt, nrm, le, area = light_point(scene, key, LIGHT_DRAWS[:3], n,
                                             ids, draw)
    num = max(scene.num_lights, 1)
    pdf0 = true_div(float(np.float32(1.0 / num)),
                    torch.clamp(area, min=1e-20))
    beta0 = le * true_div(PI, pdf0)[:, None]
    u1 = draw(3)
    u2 = draw(4)
    out_local = bsdf_ops.cosine_sample(u1, u2)
    out_world = to_world(out_local, nrm)
    cos_emit = torch.abs(out_local[..., 2])
    mat_id = scene.tri_f32[tri, 76].contiguous().view(torch.int32)
    v0 = dict(pt=pt, n=nrm, beta=beta0, pdf_fwd=pdf0, light_ind=li,
              mat_id=mat_id, tri=tri)
    start = WalkStart(
        o=pt + nrm * RAY_EPSILON, d=out_world, throughput=beta0,
        prev_pdf_sa=true_div(cos_emit, PI), prev_cos=cos_emit, prev_pt=pt,
        first_vc_scale=1.0 / torch.clamp(pdf0, min=1e-20))
    return start, v0


def generate_eye_path(scene, camera, key, px, py, max_depth: int):
    """-> (bufs, v0, escape, rays as a Python int); any device."""
    ids = rng.pixel_ids(px, py)
    start, v0 = start_eye_walk(scene, camera, key, px, py, ids)
    bufs, esc, rays = random_walk(scene, key, start, max_depth,
                                  TRANSPORT_RADIANCE, ids=ids)
    return bufs, v0, esc, rays


def generate_light_path(scene, key, px, py, max_depth: int, eta_vcm=None):
    """-> (bufs, v0, rays as a Python int); any device. The light paths
    are keyed by the pixel ids of (px, py), one per pixel. eta_vcm seeds
    the VCM d_vm chain (first_vm_seed = first_vc_scale / eta_vcm)."""
    ids = rng.pixel_ids(px, py)
    start, v0 = start_light_walk(scene, key, px.shape[0], ids)
    first_vm_seed = None
    if eta_vcm is not None:
        first_vm_seed = true_div(start.first_vc_scale,
                                 max(float(eta_vcm), 1e-30))
    bufs, _esc, rays = random_walk(scene, key, start, max_depth,
                                   TRANSPORT_IMPORTANCE, eta_vcm,
                                   first_vm_seed, ids=ids)
    return bufs, v0, rays


def walk_key_table(key, max_depth: int) -> torch.Tensor:
    """Plain version of K12's key table (kernels/csrc/keys.cuh
    walk_key_tables, folded by the walk's prologue): the pairs of draws 0-3
    of bounce_key(key, b) for b < max_depth, then draws LIGHT_DRAWS of key
    -> int32 [max_depth * 4 + 5, 2] (the keyed walk's host table)."""
    return torch.cat([rng.fold_table(key, 4, rows=max_depth),
                      rng.fold_table(key, len(LIGHT_DRAWS),
                                     draw0=LIGHT_DRAWS[0])])


def walk_keys(key, mode: str) -> list:
    """The 12 key words K12 takes: 10 draw-key words (eye: the camera's
    four draw keys and two unused words; light: the five endpoint draw
    keys), then the walk key itself."""
    if mode == "eye":
        ck = rng.fold_in(key, CAMERA_DRAWS)
        words = [w for dr in range(4) for w in rng.draw_key(ck, dr)] + [0, 0]
    else:
        words = [w for dr in LIGHT_DRAWS for w in rng.draw_key(key, dr)]
    return words + list(key)

