"""Built-in procedural scenes and textures.

The port's own copy of cudapathtracer_tpu/scene/builtin.py, unchanged:
the same meshes, triangle order and textures, bit for bit.

The reference's scenedata/*.obj are git-LFS pointer stubs (not present) and
its textures/*.bmp are absent from the repo, so the framework ships its own
authored equivalents: a Cornell box matching the reference's camera setup
(configs/config.rendertron camera at (0,0,1), fov 60, box walls with
material ids 1/2/3), an area light, procedural test solids, and a ~70k-tri
procedurally displaced icosphere standing in for the Stanford bunny in the
BASELINE.md mesh benchmark.
"""

from __future__ import annotations

import numpy as np

from reference.tpt.utils.obj import MeshData


def quad(mesh: MeshData, p0, p1, p2, p3, mat_id, emission=(0.0, 0.0, 0.0)):
    """Two triangles (p0,p1,p2) + (p0,p2,p3); CCW normal."""
    pts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return mesh.add(pts, idx, mat_id, emission)


def box(mesh: MeshData, bmin, bmax, mat_id, emission=(0.0, 0.0, 0.0)):
    """Axis-aligned box with outward normals."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    quad(mesh, (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mat_id, emission)  # +z
    quad(mesh, (x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mat_id, emission)  # -z
    quad(mesh, (x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mat_id, emission)  # +x
    quad(mesh, (x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mat_id, emission)  # -x
    quad(mesh, (x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat_id, emission)  # +y
    quad(mesh, (x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), mat_id, emission)  # -y
    return mesh


def icosphere(subdivisions: int = 3, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron; 20 * 4^s triangles. Returns (verts, faces)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdivisions):
        # vectorized midpoint split: unique undirected edges -> one new
        # vertex each. Face ORDER is preserved (each parent face yields its
        # 4 children contiguously), so downstream triangle streams — and
        # therefore BVH builds and renders — are bit-identical to the old
        # per-face dict walk (vertex NUMBERING differs, but triangles are
        # denormalized before any device use).
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                                np.stack([c, a], 1)])
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mids = (verts[uniq[:, 0]] + verts[uniq[:, 1]]) / 2.0
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        f = faces.shape[0]
        mid_idx = len(verts) + inv
        ab, bc, ca = mid_idx[:f], mid_idx[f:2 * f], mid_idx[2 * f:]
        quads = np.stack([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)], axis=1)
        verts = np.concatenate([verts, mids])
        faces = quads.reshape(-1, 3).astype(np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces.astype(np.int32)


def bunny_stand_in(subdivisions: int = 5, radius: float = 0.25,
                   center=(0.0, -0.15, -0.2), seed: int = 7,
                   displacement: float = 0.18):
    """~70k-triangle organic blob (displaced icosphere with smooth vertex
    normals) — the BASELINE.md "Stanford bunny ~70k tris" stand-in (the
    actual bunny OBJ is an LFS stub in the reference). subdivisions=5 gives
    20*4^5 = 20480 tris; 6 gives 81920."""
    verts, faces = icosphere(subdivisions, 1.0, (0.0, 0.0, 0.0))
    # low-frequency pseudo-random displacement (deterministic)
    rs = np.random.RandomState(seed)
    freqs = rs.uniform(1.0, 4.0, size=(5, 3))
    phases = rs.uniform(0.0, 2 * np.pi, size=(5,))
    amps = rs.uniform(0.3, 1.0, size=(5,))
    amps /= amps.sum()
    disp = np.zeros(len(verts))
    for f, p, a in zip(freqs, phases, amps):
        disp += a * np.sin(verts @ f * np.pi + p)
    verts = verts * (1.0 + displacement * disp[:, None])
    # smooth vertex normals from face normals
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)
    verts = verts * radius + np.asarray(center, np.float32)
    return verts.astype(np.float32), faces, vn.astype(np.float32)


def cornell_box(light_scale: float = 1.0, left_mat: int = 6, right_mat: int = 3,
                back_mat: int = 2, floor_mat: int = 2, ceil_mat: int = 2,
                light_emission=(15.0, 15.0, 15.0)) -> MeshData:
    """Cornell box in [-0.5, 0.5]^3 viewed from +z (camera at (0,0,1),
    fov 60 — the reference's shipped camera). Red left wall / green right
    wall by default (material ids 6 and 3 from the builtin registry)."""
    m = MeshData()
    s = 0.5
    # floor (+y normal), ceiling (-y), back wall (+z), left (+x), right (-x)
    quad(m, (-s, -s, s), (s, -s, s), (s, -s, -s), (-s, -s, -s), floor_mat)
    quad(m, (-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s), ceil_mat)
    quad(m, (-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s), back_mat)
    quad(m, (-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s), left_mat)
    quad(m, (s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s), right_mat)
    # area light slightly below the ceiling, normal facing down (-y) so NEE
    # sees a front-lit emitter (cos_l > 0 in nee_pdf)
    l = 0.15 * light_scale
    e = tuple(light_emission)
    quad(m, (-l, s - 1e-3, l), (-l, s - 1e-3, -l), (l, s - 1e-3, -l),
         (l, s - 1e-3, l), 2, e)
    return m


def cornell_with_blocks() -> MeshData:
    """Cornell box + the classic two boxes (diffuse white)."""
    m = cornell_box()
    box(m, (-0.30, -0.5, -0.25), (-0.05, 0.1, 0.0), 2)
    box(m, (0.05, -0.5, 0.05), (0.30, -0.2, 0.30), 2)
    return m


def cornell_with_spheres(mirror_mat: int = 19, glass_mat: int = 5) -> MeshData:
    """Cornell box + mirror and glass spheres (BASELINE config 2)."""
    m = cornell_box()
    v, f = icosphere(4, 0.16, (-0.22, -0.34, -0.15))
    n = v - np.asarray([-0.22, -0.34, -0.15], np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    m.add(v, f, mirror_mat, normals=n, nrm_idx=f)
    v2, f2 = icosphere(4, 0.16, (0.2, -0.34, 0.12))
    n2 = v2 - np.asarray([0.2, -0.34, 0.12], np.float32)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    m.add(v2, f2, glass_mat, normals=n2, nrm_idx=f2)
    return m


def cornell_with_bunny(subdivisions: int = 6, bunny_mat: int = 2) -> MeshData:
    """Cornell box + ~82k-tri displaced-sphere mesh (BASELINE config 3)."""
    m = cornell_box()
    v, f, n = bunny_stand_in(subdivisions)
    m.add(v, f, bunny_mat, normals=n, nrm_idx=f)
    return m


def cornell_pool(water_mat: int = 10, water_y: float = -0.2) -> MeshData:
    """Cornell box with a horizontal water surface at y=water_y: the floor
    is visible AND lit only through the smooth-dielectric plane, so every
    floor-lighting path is Specular-Diffuse-Specular — the class BDPT's
    connection/NEE strategies cannot sample (every shadow ray crosses the
    water boundary) but VCM/SPPM photon merging handles (the reference's
    signature capability, README §Problems-with-BDPT).

    The quad extends past the box so camera rays entering through the open
    front face also refract before reaching the floor; its normal faces +y
    (up, toward the light)."""
    m = cornell_box()
    e = 2.0  # overhang past the open viewing face
    quad(m, (-e, water_y, e), (e, water_y, e), (e, water_y, -e),
         (-e, water_y, -e), water_mat)
    return m


def cornell_glass_core(glass_mat: int = 5, core_mat: int = 2,
                       center=(0.0, -0.1, 0.0), r_glass: float = 0.24,
                       r_core: float = 0.15) -> MeshData:
    """Cornell box + a diffuse sphere fully enclosed in a glass shell — the
    airtight Specular-Diffuse-Specular construction: every path lighting
    the core is L -> S -> D(core) -> S -> E. NEE and light-trace splats are
    blocked by the shell; s>=2 connections between two core vertices are
    occluded by the core itself (the chord of a convex body lies inside
    it); only the s=0 naive chain remains for BDPT, so with BDPT_NAIVE off
    the core is unreachable for BDPT while VCM/SPPM photon merging renders
    it (the reference's signature capability, README §Problems-with-BDPT)."""
    m = cornell_box()
    c = np.asarray(center, np.float32)
    for rad, mat in ((r_glass, glass_mat), (r_core, core_mat)):
        v, f = icosphere(3, rad, center)
        n = (v - c) / np.linalg.norm(v - c, axis=1, keepdims=True)
        m.add(v, f, mat, normals=n, nrm_idx=f)
    return m


def checker_texture(size: int = 64, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.6)):
    """Procedural checker — placeholder for the reference's missing BMP
    textures. Returns flat [size*size, 3] f32 atlas block."""
    y, x = np.mgrid[0:size, 0:size]
    check = ((x // 8 + y // 8) % 2).astype(np.float32)[..., None]
    img = check * np.asarray(c1, np.float32) + (1 - check) * np.asarray(c0, np.float32)
    return img.reshape(-1, 3)
