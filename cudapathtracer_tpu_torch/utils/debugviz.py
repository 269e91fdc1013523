"""Debug visualization: overlay lines, path drawing, photon heatmaps.

The port's copy of the host parts of cudapathtracer_tpu/utils/debugviz.py
(the reference's drawLine/drawPath/debugPrintPath and paintPhotons/
paintGridBox): an RGB overlay buffer composited over the render wherever
it is non-black. Host numpy, with the camera's projection run on CPU
tensors; these are diagnostics, not hot paths. The eye paths of the
BDPT_DRAWPATH channel come from one K12 eye-walk launch on CUDA tensors
and from the plain walk (models/paths.generate_eye_path) on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from cudapathtracer_tpu_torch import kernels
from cudapathtracer_tpu_torch.models import paths


def make_overlay(width: int, height: int) -> np.ndarray:
    return np.zeros((height, width, 3), np.float32)


def _raster(overlay: np.ndarray, camera, pts: np.ndarray):
    """Pixel coordinates of world points [N,3] and the on-screen mask."""
    px, py, ok = camera.world_to_raster(
        torch.as_tensor(np.asarray(pts, np.float32)))
    px = px.numpy().astype(int)
    py = py.numpy().astype(int)
    h, w = overlay.shape[:2]
    return px, py, ok.numpy() & (px >= 0) & (px < w) & (py >= 0) & (py < h)


def draw_line(overlay: np.ndarray, camera, p0, p1, color=(1.0, 0.0, 0.0),
              samples: int = 256) -> np.ndarray:
    """Project a 3D segment and rasterize it into the overlay (the
    reference's Bresenham drawLine)."""
    t = np.linspace(0.0, 1.0, samples, dtype=np.float32)[:, None]
    pts = np.asarray(p0, np.float32)[None] * (1 - t) \
        + np.asarray(p1, np.float32)[None] * t
    px, py, m = _raster(overlay, camera, pts)
    overlay[py[m], px[m]] = np.asarray(color, np.float32)
    return overlay


def draw_path(overlay: np.ndarray, camera, points: np.ndarray,
              color=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Rasterize a polyline of path vertices (drawPath)."""
    for a, b in zip(points[:-1], points[1:]):
        draw_line(overlay, camera, a, b, color)
    return overlay


def paint_photons(overlay: np.ndarray, camera, positions: np.ndarray,
                  valid=None, gain: float = 0.05) -> np.ndarray:
    """Photon-density heatmap splat (paintPhotons)."""
    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    if valid is not None:
        pos = pos[np.asarray(valid).reshape(-1)]
    if pos.size == 0:
        return overlay
    px, py, m = _raster(overlay, camera, pos)
    np.add.at(overlay, (py[m], px[m], np.zeros(m.sum(), int)), gain)
    np.add.at(overlay, (py[m], px[m], np.full(m.sum(), 1)), gain * 0.4)
    return overlay


def paint_grid_box(overlay: np.ndarray, camera, cell_min, cell_max,
                   color=(0.0, 0.4, 1.0)) -> np.ndarray:
    """Wireframe an AABB (paintGridBox)."""
    x0, y0, z0 = cell_min
    x1, y1, z1 = cell_max
    c = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        draw_line(overlay, camera, c[a], c[b], color, samples=64)
    return overlay


def overlay_eye_paths(scene, camera, key, px, py, eye_depth: int,
                      max_paths: int = 48):
    """The eye walks bdpt_path_overlay draws: a deterministic sparse subset
    of at most max_paths pixels of (px, py) [N] (every (N // max_paths)-th)
    walked under `key` to eye_depth, one K12 eye-mode launch on CUDA
    tensors, the plain walk on CPU tensors. -> (the selected list indices
    [S], bufs pt [D,S,3], valid [D,S], lens points [S,3]) as numpy."""
    n = int(px.shape[0])
    stride = max(n // max_paths, 1)
    sel = np.arange(0, n, stride, dtype=np.int64)[:max_paths]
    idx = torch.as_tensor(sel, device=px.device)
    pxs = px[idx].to(torch.int32).contiguous()
    pys = py[idx].to(torch.int32).contiguous()
    if px.device.type == "cpu":
        bufs, v0, _esc, _rays = paths.generate_eye_path(
            scene, camera, key, pxs, pys, eye_depth)
    else:
        rays = torch.zeros(sel.shape[0], dtype=torch.int32, device=px.device)
        ew = kernels.bdpt_walk(scene, pxs, pys, paths.walk_keys(key, "eye"),
                               mode="eye", max_depth=eye_depth, rays=rays,
                               camera=camera)
        bufs, v0 = ew["bufs"], ew["v0"]
    return (sel, bufs.pt.cpu().numpy(), bufs.valid.cpu().numpy(),
            v0["pt"].cpu().numpy())


def path_overlay(camera, sel, pts, valid, origins) -> np.ndarray:
    """Rasterize eye paths (overlay_eye_paths' arrays) camera endpoint ->
    deepest vertex, each in a colour hashed from its list index."""
    overlay = make_overlay(camera.width, camera.height)
    for i in range(pts.shape[1]):
        depth = int(valid[:, i].argmin()) if not valid[:, i].all() \
            else valid.shape[0]
        if valid[:, i].size and not valid[0, i]:
            depth = 0
        chain = np.concatenate([origins[i][None], pts[:depth, i]], axis=0)
        if chain.shape[0] < 2:
            continue
        # per-path color from a hash of the pixel id (the reference uses
        # three curand draws; any decorrelated color stream is equivalent)
        h = (int(sel[i]) * 2654435761) & 0xFFFFFFFF
        color = (0.25 + 0.75 * ((h >> 0) & 255) / 255.0,
                 0.25 + 0.75 * ((h >> 8) & 255) / 255.0,
                 0.25 + 0.75 * ((h >> 16) & 255) / 255.0)
        draw_path(overlay, camera, chain, color)
    return overlay


def bdpt_path_overlay(scene, camera, key, px, py, eye_depth: int,
                      max_paths: int = 48) -> np.ndarray:
    """BDPT_DRAWPATH channel: rasterize eye paths into an overlay. The
    reference draws a pixel's eye path whenever one of its connections
    fails, which marks nearly every pixel; the usable form of the same
    diagnostic is a deterministic sparse subset of pixels, drawn camera
    endpoint -> deepest vertex with a per-path pseudo-random colour."""
    return path_overlay(camera, *overlay_eye_paths(
        scene, camera, key, px, py, eye_depth, max_paths))


def composite_overlay(image: np.ndarray, overlay: np.ndarray) -> np.ndarray:
    """Overlay overrides the render where non-black."""
    mask = (overlay != 0).any(axis=-1, keepdims=True)
    return np.where(mask, overlay, image)


def debug_print_path(bufs, lane: int, limit: int = 16) -> str:
    """Dump one lane's path vertices (debugPrintPath). bufs:
    models.paths.PathBuffers. Returns the formatted string."""
    lines = []
    d = min(bufs.pt.shape[0], limit)
    beta, is_delta = bufs.beta, bufs.is_delta
    mat_id, light_ind = bufs.mat_id, bufs.light_ind
    for k in range(d):
        if not bool(bufs.valid[k][lane]):
            break
        pt = bufs.pt[k][lane].tolist()
        b = beta[k][lane].tolist()
        lines.append(
            f"v{k}: pt=({pt[0]:+.4f},{pt[1]:+.4f},{pt[2]:+.4f}) "
            f"beta=({b[0]:.3g},{b[1]:.3g},{b[2]:.3g}) "
            f"pdfFwd={float(bufs.pdf_fwd[k][lane]):.3g} "
            f"delta={bool(is_delta[k][lane])} "
            f"mat={int(mat_id[k][lane])} "
            f"light={int(light_ind[k][lane])}")
    out = "\n".join(lines) if lines else "(empty path)"
    print(out)
    return out
