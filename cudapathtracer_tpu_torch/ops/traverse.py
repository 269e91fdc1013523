"""Traversal entry points, the hit record and the hit fetch.

Counterpart of cudapathtracer_tpu/ops/traverse.py. `closest_hit` and
`shadow_factor` dispatch to the BVH8 engine (ops/traverse8.py, kernel K1);
the JAX package's threaded binary engine (traversal="threaded") is not
ported. `shade_data` is the plain version of the hit fetch (K2, device
code in kernels/csrc/shade.cuh): one gather of the packed shading row and
the barycentric interpolation; `interpolate_hit` (the BDPT walks' fetch)
returns the same record without the material fields.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cudapathtracer_tpu_torch.utils.math import dot, normalize


class Hit(NamedTuple):
    """Closest-hit record, all [N]."""
    t: torch.Tensor     # distance; == max_t on a miss
    tri: torch.Tensor   # permuted triangle index, -1 on a miss
    u: torch.Tensor     # barycentric weight of vertex b
    v: torch.Tensor     # barycentric weight of vertex c

    @property
    def valid(self):
        return self.tri >= 0


def _engine(scene):
    if scene.traversal != "bvh8":
        raise NotImplementedError(
            f"traversal={scene.traversal!r}: only the BVH8 engine is ported "
            "(the threaded binary engine is ROADMAP item K15)")
    from cudapathtracer_tpu_torch.ops import traverse8
    return traverse8


def closest_hit(scene, o, d, max_t=None, skip_tri=None, active=None) -> Hit:
    return _engine(scene).closest_hit8(scene, o, d, max_t, skip_tri, active)


def shadow_factor(scene, o, d, max_t, skip_tri=None, active=None):
    return _engine(scene).shadow_factor8(scene, o, d, max_t, skip_tri,
                                         active)


def _i32(x):
    return x.contiguous().view(torch.int32)


def shade_data(scene, o, d, hit: Hit):
    """One packed-row gather -> (info dict, per-hit MaterialTable rows).
    Layout of the row: scene/scene.py Scene.tri_shade_row."""
    from cudapathtracer_tpu_torch.scene.materials import MaterialTable

    row = scene.tri_shade_row[torch.clamp(hit.tri, min=0)]   # [N,48]
    w0 = 1.0 - hit.u - hit.v
    u, v = hit.u[:, None], hit.v[:, None]
    nrm = normalize(row[:, 0:3] * w0[:, None] + row[:, 3:6] * u
                    + row[:, 6:9] * v)
    backface = dot(nrm, d) > 0.0
    nrm = torch.where(backface[:, None], -nrm, nrm)
    uv = row[:, 9:11] * w0[:, None] + row[:, 11:13] * u + row[:, 13:15] * v
    ints = _i32(row[:, 18:21])
    info = dict(
        point=o + d * hit.t[:, None],
        normal=nrm,
        uv=uv,
        emission=row[:, 15:18],
        light_ind=ints[:, 0],
        mat_id=ints[:, 1],
        backface=backface,
        valid=hit.valid,
        t=hit.t,
        tri=hit.tri,
        normal_a=row[:, 0:3],   # vertex-a normal and area: the light's
        area=row[:, 46],        # normal and area for the NEE counter-pdf
    )
    flags = _i32(row[:, 33:36])
    texi = _i32(row[:, 39:46])
    mat = MaterialTable(
        type=ints[:, 2],
        albedo=row[:, 21:24],
        roughness=row[:, 24],
        eta=row[:, 25:28],
        k=row[:, 28:31],
        ior=row[:, 31],
        transmission=row[:, 32],
        is_specular=flags[:, 0] != 0,
        boundary=flags[:, 1] != 0,
        thin_walled=flags[:, 2] != 0,
        absorption=row[:, 36:39],
        priority=texi[:, 0],
        tex_start=texi[:, 1],
        tex_width=texi[:, 2],
        tex_height=texi[:, 3],
        trans_tex_start=texi[:, 4],
        trans_tex_width=texi[:, 5],
        trans_tex_height=texi[:, 6],
    )
    return info, mat


def interpolate_hit(scene, o, d, hit: Hit) -> dict:
    """Counterpart of the JAX package's interpolate_hit: the interpolated
    shading data at hit points (point, normal flipped toward the ray, uv,
    emission, mat_id, light_ind, backface, valid, t, tri). The JAX function
    gathers the per-triangle columns; the packed shading row holds the same
    normals, uvs, emission and ids, interpolated in the same order, so this
    is shade_data's record."""
    info, _ = shade_data(scene, o, d, hit)
    keys = ("point", "normal", "uv", "emission", "mat_id", "light_ind",
            "backface", "valid", "t", "tri")
    return {k: info[k] for k in keys}
