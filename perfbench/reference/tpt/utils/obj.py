"""Wavefront OBJ loader (host-side numpy).

The port's own copy of cudapathtracer_tpu/utils/obj.py, unchanged.

Behavior parity with the reference's readObjSimple (main.cu:936-1068):
v/vt/vn parsing, fan triangulation from the first polygon vertex, degenerate
skip (squared area < 1e-18), v-texcoord flip (v -> 1-v), bad-normal fallback
(0,1,0), per-mesh material id + emission, and a per-mesh position offset (the
reference's poor-man's animation hook, main.cu:478). Missing normals/uvs get
safe defaults (geometric normal / zero uv) instead of the reference's
out-of-bounds -1 indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MeshData:
    """Host-side triangle soup accumulated over one or more meshes.

    Equivalent of the reference's Vertices SoA + Triangle vector
    (objects.cuh:151-184), index-based so vertices are shared.
    """
    positions: np.ndarray = None    # [V,3] f32
    normals: np.ndarray = None      # [VN,3] f32
    uvs: np.ndarray = None          # [VT,2] f32
    # per-triangle index tuples
    pos_idx: np.ndarray = None      # [T,3] i32
    nrm_idx: np.ndarray = None      # [T,3] i32
    uv_idx: np.ndarray = None       # [T,3] i32
    mat_id: np.ndarray = None       # [T] i32
    emission: np.ndarray = None     # [T,3] f32
    light_ind: np.ndarray = None    # [T] i32; -1 = not a light (reference: -51)

    def __post_init__(self):
        if self.positions is None:
            self.positions = np.zeros((0, 3), np.float32)
            self.normals = np.zeros((0, 3), np.float32)
            self.uvs = np.zeros((0, 2), np.float32)
            self.pos_idx = np.zeros((0, 3), np.int32)
            self.nrm_idx = np.zeros((0, 3), np.int32)
            self.uv_idx = np.zeros((0, 3), np.int32)
            self.mat_id = np.zeros((0,), np.int32)
            self.emission = np.zeros((0, 3), np.float32)
            self.light_ind = np.zeros((0,), np.int32)

    @property
    def num_triangles(self) -> int:
        return self.pos_idx.shape[0]

    @property
    def num_lights(self) -> int:
        return int((self.light_ind >= 0).sum())

    def add(self, positions, pos_idx, mat_id, emission=(0.0, 0.0, 0.0),
            normals=None, nrm_idx=None, uvs=None, uv_idx=None,
            offset=(0.0, 0.0, 0.0)):
        """Append a triangle soup; fills missing normals with geometric
        normals and missing uvs with zeros. Emissive meshes become lights."""
        positions = np.asarray(positions, np.float32) + np.asarray(offset, np.float32)
        pos_idx = np.asarray(pos_idx, np.int32)
        T = pos_idx.shape[0]

        # drop degenerate triangles (areaSq < 1e-18, main.cu:1040)
        p0 = positions[pos_idx[:, 0]]
        e1 = positions[pos_idx[:, 1]] - p0
        e2 = positions[pos_idx[:, 2]] - p0
        cp = np.cross(e1, e2)
        keep = (cp * cp).sum(-1) >= 1e-18
        pos_idx = pos_idx[keep]
        if nrm_idx is not None:
            nrm_idx = np.asarray(nrm_idx, np.int32)[keep]
        if uv_idx is not None:
            uv_idx = np.asarray(uv_idx, np.int32)[keep]
        T = pos_idx.shape[0]

        if normals is None or nrm_idx is None:
            # geometric normals, one per kept triangle
            p0 = positions[pos_idx[:, 0]]
            cp = np.cross(positions[pos_idx[:, 1]] - p0, positions[pos_idx[:, 2]] - p0)
            ln = np.linalg.norm(cp, axis=-1, keepdims=True)
            normals = cp / np.maximum(ln, 1e-20)
            nrm_idx = np.repeat(np.arange(T, dtype=np.int32)[:, None], 3, axis=1)
        else:
            normals = np.asarray(normals, np.float32)
            # bad normals -> (0,1,0) (main.cu:979-989)
            bad = ~np.isfinite(normals).all(-1) | ((normals * normals).sum(-1) < 1e-12)
            normals = normals.copy()
            normals[bad] = (0.0, 1.0, 0.0)

        if uvs is None or uv_idx is None:
            uvs = np.zeros((1, 2), np.float32)
            uv_idx = np.zeros((T, 3), np.int32)
        else:
            uvs = np.asarray(uvs, np.float32)
            uv_idx = np.asarray(uv_idx, np.int32)

        emission = np.asarray(emission, np.float32)
        is_light = float((emission * emission).sum()) > 0.0
        if is_light:
            start = 0 if self.light_ind.size == 0 else int(self.light_ind.max()) + 1
            light_ind = start + np.arange(T, dtype=np.int32)
        else:
            light_ind = np.full((T,), -1, np.int32)

        vo, no, to = len(self.positions), len(self.normals), len(self.uvs)
        self.positions = np.concatenate([self.positions, positions])
        self.normals = np.concatenate([self.normals, normals])
        self.uvs = np.concatenate([self.uvs, uvs])
        self.pos_idx = np.concatenate([self.pos_idx, pos_idx + vo])
        self.nrm_idx = np.concatenate([self.nrm_idx, nrm_idx + no])
        self.uv_idx = np.concatenate([self.uv_idx, uv_idx + to])
        self.mat_id = np.concatenate([self.mat_id, np.full((T,), mat_id, np.int32)])
        self.emission = np.concatenate([self.emission, np.tile(emission, (T, 1))])
        self.light_ind = np.concatenate([self.light_ind, light_ind])
        return self


def load_obj(path: str, mesh: MeshData, mat_id: int,
             emission=(0.0, 0.0, 0.0), offset=(0.0, 0.0, 0.0)) -> MeshData:
    """Parse an OBJ file and append its (fan-triangulated) triangles to mesh."""
    positions, normals, uvs = [], [], []
    pos_idx, nrm_idx, uv_idx = [], [], []
    has_all_n, has_all_uv = True, True

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#s":
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                u, v = float(parts[1]), float(parts[2])
                uvs.append([u, 1.0 - v])  # v flip (main.cu:972)
            elif tag == "vn":
                try:
                    n = [float(parts[1]), float(parts[2]), float(parts[3])]
                except (ValueError, IndexError):
                    n = [0.0, 1.0, 0.0]
                normals.append(n)
            elif tag == "f":
                vi, ti, ni = [], [], []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        ti.append(int(comps[1]) - 1)
                    if len(comps) > 2 and comps[2]:
                        ni.append(int(comps[2]) - 1)
                has_uv = len(ti) == len(vi)
                has_n = len(ni) == len(vi)
                has_all_uv &= has_uv
                has_all_n &= has_n
                for i in range(1, len(vi) - 1):  # fan triangulation
                    pos_idx.append([vi[0], vi[i], vi[i + 1]])
                    uv_idx.append([ti[0], ti[i], ti[i + 1]] if has_uv else [0, 0, 0])
                    nrm_idx.append([ni[0], ni[i], ni[i + 1]] if has_n else [0, 0, 0])

    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    kw = {}
    if normals and has_all_n:
        kw["normals"] = np.asarray(normals, np.float32).reshape(-1, 3)
        kw["nrm_idx"] = np.asarray(nrm_idx, np.int32).reshape(-1, 3)
    if uvs and has_all_uv:
        kw["uvs"] = np.asarray(uvs, np.float32).reshape(-1, 2)
        kw["uv_idx"] = np.asarray(uv_idx, np.int32).reshape(-1, 3)
    return mesh.add(positions, np.asarray(pos_idx, np.int32).reshape(-1, 3),
                    mat_id, emission, offset=offset, **kw)
