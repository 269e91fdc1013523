#!/usr/bin/env python3
"""How busy K5's and K12's lanes are: events per path, and the lane use
of warps.

K5 (kernels/csrc/uni_mega.cu) steps a path one event (one closest ray and
its shading) at a time, and a path takes 1 to 133 events. If one thread
owned one pixel's path, a warp would run as long as its longest path, so
its lane use would be

    sum of events / (32 x sum over warps of the warp's most events),

with warps of 32 consecutive pixels (and the same with blocks of 128
threads, which hold their SM's slot as long). This tool counts each
path's events from K5's plain version (models/unidirectional.render_plain
for the classic and mega schedules, models/naive.render_plain for the
naive one: the kernel's keyed draws, so the kernel's own counts on the
classic and naive schedules; the mega schedule keys its draws by the
path's position in the pixel list, which is the full frame's only when
every row is given) over evenly spaced bands of full rows, and prints that
lane use. With --card it also launches K5 on the whole frame with its
lane counters (kernels.render_unidirectional(lanes=...)) and prints what
the card measured with path regeneration: the lane use, events stepped /
(32 x the warps' calls of the event code, the lanes that call it together
counting once), and the event balance, events stepped / (32 x the sum
over warps of the most events one lane stepped). Under regeneration every
lane draws pixels until they run out, so the event balance is near 1 by
design; the lane use also shows lanes that step their events apart.

With --walk light|eye it counts K12's walks instead (kernels/csrc/
bdpt_walk.cu, which steps one bounce of a path per loop trip): a walk of
max_depth (--depth; 6 for the light walk, 8 for the eye walk, the
config's) takes min(max_depth - 1, valid vertices + 1) bounces, each one
closest ray, counted from the plain walk (models/paths.py, sample 0's BDPT
keys); with --card K12 runs on the whole frame with its lane counters.

With --walk vcm-eye it counts the classic VCM eye walk (kernels/csrc/
eye_walk.cu, stage 1 of the eye pass) at the upstream's VCM deployment
(VCMConfig's defaults: eye depth 16 unless --depth, light depth 10): a
path takes one bounce a closest ray until it escapes, its BSDF sample
fails or it reaches the depth, counted at the plain walk's closest_hit
(models/vcm.eye_walk_plain, sample 0's VCM keys) and held equal to the
records it wrote; with --card the walk runs on the whole frame with its
lane counters (kernels.eye_walk(lanes=...)).

Run from the repository root (the plain version on the CPU is slow: a few
bands of a 1080p frame take minutes; --device cuda runs it on the card):

    python3 tools/k5_lanes.py [--schedule mega|classic|naive | --walk
        light|eye|vcm-eye] [--width 1920 --height 1080 --depth 8]
        [--bands 18 --band-rows 2] [--mesh builtin:cornell_bunny]
        [--device cpu|cuda] [--card]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("cornell_bunny", "cornell_blocks", "cornell_spheres")


def band_rows(height: int, bands: int, rows: int) -> list:
    """The first row of each of `bands` evenly spaced bands of `rows` rows
    (every row's band when they cover the frame)."""
    if bands * rows >= height:
        return list(range(0, height, rows))
    step = (height - rows) / max(bands - 1, 1)
    return sorted({int(round(b * step)) for b in range(bands)})


def band_pixels(width: int, height: int, bands: int, rows: int, device):
    """(px, py) [N] int32 of the bands' pixels in raster order."""
    import torch
    starts = band_rows(height, bands, rows)
    ys = sorted({y for s in starts for y in range(s, min(s + rows, height))})
    gy, gx = torch.meshgrid(torch.tensor(ys, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32),
                            indexing="ij")
    return gx.reshape(-1).to(device), gy.reshape(-1).to(device)


def path_events(scene, camera, schedule: str, px, py, *, max_depth: int,
                use_mis: bool = True, sample_idx: int = 0):
    """Each path's events [N] int64 (in the order of px, py) from K5's
    plain version, and the plain version's rays (a Python int)."""
    import torch
    from cudapathtracer_tpu_torch.models import naive, unidirectional
    from cudapathtracer_tpu_torch.ops import traverse
    from cudapathtracer_tpu_torch.utils import rng
    events = torch.zeros(px.shape[0], dtype=torch.int64, device=px.device)
    if schedule == "naive":
        # one closest ray per live lane and bounce, over all lanes
        mod, name = traverse, "closest_hit"

        def hook(orig):
            def closest_hit(scene, o, d, *a, active=None, **kw):
                events.add_(active.to(torch.int64))
                return orig(scene, o, d, *a, active=active, **kw)
            return closest_hit
    else:
        # one _bounce per event, over the live paths s["lane"]
        mod, name = unidirectional, "_bounce"

        def hook(orig):
            def bounce(scene, mats, skey, it, s, *a):
                events.index_add_(0, s["lane"], torch.ones_like(s["lane"]))
                return orig(scene, mats, skey, it, s, *a)
            return bounce
    orig = getattr(mod, name)
    setattr(mod, name, hook(orig))
    try:
        if schedule == "naive":
            _, rays = naive.render_plain(scene, camera, rng.base_key(),
                                         sample_idx, px, py,
                                         max_depth=max_depth)
        else:
            _, rays = unidirectional.render_plain(
                scene, camera, rng.base_key(), sample_idx, px, py,
                max_depth=max_depth, use_mis=use_mis,
                sample_environment=False, schedule=schedule)
    finally:
        setattr(mod, name, orig)
    return events, int(rays)


def walk_events(scene, camera, mode: str, px, py, *, max_depth: int,
                sample_idx: int = 0):
    """Each walk's bounces [N] int64, min(max_depth - 1, valid vertices +
    1), from K12's plain version (sample sample_idx's BDPT keys), and the
    plain walk's rays (a Python int)."""
    import torch
    from cudapathtracer_tpu_torch.models import bdpt, paths
    from cudapathtracer_tpu_torch.utils import rng
    key_l, key_e, _ = bdpt.sample_keys(rng.base_key(), sample_idx)
    if mode == "light":
        bufs, _, rays = paths.generate_light_path(scene, key_l, px, py,
                                                  max_depth)
    else:
        bufs, _, _, rays = paths.generate_eye_path(scene, camera, key_e, px,
                                                   py, max_depth)
    valid = bufs.valid.sum(dim=0).to(torch.int64)
    return torch.clamp(valid + 1, max=max_depth - 1), int(rays)


def vcm_eye_events(scene, camera, px, py, *, max_depth: int, n_paths: int,
                   sample_idx: int = 0):
    """Each classic VCM eye walk's bounces [N] int64, its closest rays
    counted at the plain walk's closest_hit (models/vcm.eye_walk_plain at
    VCMConfig's defaults with eye depth max_depth, sample sample_idx's
    keys, eta_vcm of n_paths light paths), the records [N] int64 it wrote
    (one a bounce: a hit or an escape), and the plain walk's closest and
    NEE rays (a Python int)."""
    import torch
    from cudapathtracer_tpu_torch.models import vcm
    from cudapathtracer_tpu_torch.ops import traverse
    from cudapathtracer_tpu_torch.utils import rng
    cfg = vcm.VCMConfig(eye_depth=max_depth)
    _, key_e = vcm.sample_keys(rng.base_key(), sample_idx)
    eta = vcm.sample_scalars(scene, cfg, sample_idx, n_paths)[1]
    events = torch.zeros(px.shape[0], dtype=torch.int64, device=px.device)
    orig = traverse.closest_hit

    def closest_hit(scene, o, d, *a, active=None, **kw):
        events.add_(active.to(torch.int64))
        return orig(scene, o, d, *a, active=active, **kw)
    traverse.closest_hit = closest_hit
    try:
        rec, rays = vcm.eye_walk_plain(scene, camera, key_e, cfg, px, py, eta)
    finally:
        traverse.closest_hit = orig
    return events, (rec.flags != 0).sum(dim=0).to(torch.int64), int(rays)


def lane_use(events, group: int) -> float:
    """sum(events) / (group x sum over groups of `group` consecutive paths
    of the group's most events); the last group is padded with idle
    lanes."""
    import torch
    pad = (-events.numel()) % group
    ev = torch.cat([events, events.new_zeros(pad)]).view(-1, group)
    return float(ev.sum()) / (group * float(ev.amax(dim=1).sum()))


def frame_pixels(camera, dev):
    """(px, py) [N] int32 of the camera's whole frame in raster order."""
    import torch
    gy, gx = torch.meshgrid(
        torch.arange(camera.height, dtype=torch.int32, device=dev),
        torch.arange(camera.width, dtype=torch.int32, device=dev),
        indexing="ij")
    return gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()


def card_lane_use(scene, camera, schedule: str, max_depth: int, dev) -> tuple:
    """K5 on the whole frame with its lane counters: (lane use, event
    balance, events, warp calls of the event code, blocks of the grid)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.utils import rng
    px, py = frame_pixels(camera, dev)
    lanes = torch.zeros(3, dtype=torch.int64, device=dev)
    kernels.render_unidirectional(
        scene, px, py, camera.kernel_params(), rng.base_key(), 0, 1,
        max_depth=max_depth,
        use_mis=schedule != "naive", sample_environment=False,
        schedule=schedule, air_priority=scene.air_priority, lanes=lanes)
    events, busiest, calls = lanes.tolist()
    return (events / (32 * calls), events / (32 * busiest), events, calls,
            kernels.render_unidirectional_grid(scene, px.shape[0], schedule))


def card_walk_lane_use(scene, camera, mode: str, max_depth: int,
                       dev) -> tuple:
    """K12 on the whole frame with its lane counters (sample 0's keys):
    (lane use, event balance, bounces, warp calls of the bounce code,
    blocks of the grid)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import bdpt, paths
    from cudapathtracer_tpu_torch.utils import rng
    px, py = frame_pixels(camera, dev)
    key_l, key_e, _ = bdpt.sample_keys(rng.base_key(), 0)
    lanes = torch.zeros(3, dtype=torch.int64, device=dev)
    kernels.bdpt_walk(scene, px, py,
                      paths.walk_keys(key_l if mode == "light" else key_e,
                                      mode),
                      mode=mode, max_depth=max_depth, camera=camera,
                      rays=torch.zeros_like(px), lanes=lanes)
    events, busiest, calls = lanes.tolist()
    return (events / (32 * calls), events / (32 * busiest), events, calls,
            kernels.bdpt_walk_grid(scene, px.shape[0]))


def card_vcm_eye_lane_use(scene, camera, max_depth: int, dev) -> tuple:
    """The classic VCM eye walk on the whole frame with its lane counters
    (sample 0's keys, VCMConfig's defaults at eye depth max_depth; the
    walk reads neither the connections nor the merge, which are off):
    (lane use, event balance, bounces, warp calls of the bounce code)."""
    import torch
    from cudapathtracer_tpu_torch import kernels
    from cudapathtracer_tpu_torch.models import paths, vcm
    from cudapathtracer_tpu_torch.ops import hashgrid
    from cudapathtracer_tpu_torch.utils import rng
    px, py = frame_pixels(camera, dev)
    n = px.shape[0]
    cfg = vcm.VCMConfig(eye_depth=max_depth, connection=False,
                        do_merge=False)
    key_l, key_e = vcm.sample_keys(rng.base_key(), 0)
    mr, eta, norm = vcm.sample_scalars(scene, cfg, 0, n)
    rays = torch.zeros(n, dtype=torch.int32, device=dev)
    lb = kernels.bdpt_walk(scene, px, py, paths.walk_keys(key_l, "light"),
                           mode="light", max_depth=cfg.light_depth + 1,
                           rays=rays, eta_vcm=eta)["bufs"]
    ep = kernels.vcm_eye_pass(scene, camera, paths.walk_keys(key_e, "eye"),
                              lb, None, None, rays, cfg, px=px, py=py,
                              merge_radius=mr, eta_vcm=eta, merge_norm=norm,
                              **hashgrid.merge_switches(cfg.max_per_cell))
    lanes = torch.zeros(3, dtype=torch.int64, device=dev)
    kernels.eye_walk(ep, lanes=lanes)
    events, busiest, calls = lanes.tolist()
    return events / (32 * calls), events / (32 * busiest), events, calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--schedule", default="mega",
                    choices=("mega", "classic", "naive"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--walk", default=None,
                    choices=("light", "eye", "vcm-eye"), help="count K12's "
                    "walk of this mode, or the classic VCM eye walk, "
                    "instead of K5")
    ap.add_argument("--depth", type=int, default=None, help="max depth "
                    "(default 8; the light walk 6, the VCM eye walk 16)")
    ap.add_argument("--bands", type=int, default=18)
    ap.add_argument("--band-rows", type=int, default=2)
    ap.add_argument("--mesh", default="builtin:cornell_bunny",
                    choices=tuple("builtin:" + m for m in MESHES))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--card", action="store_true", help="also launch K5 "
                    "on the whole frame on the card with its lane counter")
    args = ap.parse_args()
    if args.depth is None:
        args.depth = {"light": 6, "vcm-eye": 16}.get(args.walk, 8)
    sys.path.insert(0, ROOT)
    import torch
    from cudapathtracer_tpu_torch.scene import builtin
    from cudapathtracer_tpu_torch.scene.camera import Camera
    from cudapathtracer_tpu_torch.scene.materials import builtin_materials
    from cudapathtracer_tpu_torch.scene.scene import build_scene
    dev = torch.device(args.device)
    mesh = {"builtin:cornell_bunny": lambda: builtin.cornell_with_bunny(6),
            "builtin:cornell_blocks": builtin.cornell_with_blocks,
            "builtin:cornell_spheres": builtin.cornell_with_spheres,
            }[args.mesh]()
    scene, _ = build_scene(mesh, builtin_materials(), device=dev)
    cam = Camera.pinhole((0.0, 0.0, 1.0), args.width, args.height, 0.0, 0.0,
                         0.0, 60.0)
    px, py = band_pixels(args.width, args.height, args.bands, args.band_rows,
                         dev)
    if args.walk == "vcm-eye":
        ev, recs, rays = vcm_eye_events(scene, cam, px, py,
                                        max_depth=args.depth,
                                        n_paths=args.width * args.height)
        if not torch.equal(ev, recs):
            print("FAIL: the plain VCM eye walk's closest rays differ from "
                  "its records")
            return 1
    elif args.walk:
        ev, rays = walk_events(scene, cam, args.walk, px, py,
                               max_depth=args.depth)
    else:
        ev, rays = path_events(scene, cam, args.schedule, px, py,
                               max_depth=args.depth)
    evf = ev.double()
    what = f"{args.walk} walk" if args.walk else args.schedule
    print(f"[k5_lanes] {what}, {args.mesh} {args.width}x"
          f"{args.height} depth {args.depth}, {args.bands} bands of "
          f"{args.band_rows} rows: {ev.numel()} paths, {int(ev.sum())} "
          f"events ({rays} rays); events a path mean {evf.mean():.3f}, p99 "
          f"{torch.quantile(evf.cpu(), 0.99).item():.0f}, max "
          f"{int(ev.max())}; histogram of 1..max "
          f"{torch.bincount(ev.cpu())[1:].tolist()}")
    print(f"[k5_lanes] one path a thread: lane use {lane_use(ev, 32):.4f} "
          f"(warps of 32), {lane_use(ev, 128):.4f} (blocks of 128)")
    if args.card:
        if not torch.cuda.is_available():
            print("FAIL: --card needs an NVIDIA GPU")
            return 2
        cdev = torch.device("cuda", 0)
        csc = scene if dev.type == "cuda" else build_scene(
            mesh, builtin_materials(), device=cdev)[0]
        if args.walk == "vcm-eye":
            use, balance, events, calls = card_vcm_eye_lane_use(
                csc, cam, args.depth, cdev)
            blocks = "the resident grid's"
        elif args.walk:
            use, balance, events, calls, blocks = card_walk_lane_use(
                csc, cam, args.walk, args.depth, cdev)
        else:
            use, balance, events, calls, blocks = card_lane_use(
                csc, cam, args.schedule, args.depth, cdev)
        print(f"[k5_lanes] card ({torch.cuda.get_device_name(0)}), whole "
              f"frame, path regeneration on {blocks} blocks of 128: "
              f"{events} events in {calls} warp calls of the event code, "
              f"lane use {use:.4f}, event balance {balance:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
