"""tools/k5_lanes.py on a whole 32x32 frame on the CPU: each path's events
counted from K5's plain version, summed, equal the plain version's closest
rays (the naive schedule, and the classic and mega ones without NEE, whose
rays are then their closest rays); with NEE the events are fewer than the
rays; the lane use of warps of 32 and blocks of 128 lies in (0, 1], the
blocks' no higher than the warps'. The same for K12's light and eye walks
(--walk), whose bounces sum to the plain walk's closest rays, and of the
classic VCM eye walk (--walk vcm-eye) on 64 pixels."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import k5_lanes  # noqa: E402
from cudapathtracer_tpu_torch.scene import builtin  # noqa: E402
from cudapathtracer_tpu_torch.scene.camera import Camera  # noqa: E402
from cudapathtracer_tpu_torch.scene.materials import \
    builtin_materials  # noqa: E402
from cudapathtracer_tpu_torch.scene.scene import build_scene  # noqa: E402

W = H = 32


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    return build_scene(builtin.cornell_with_spheres(), builtin_materials(),
                       device="cpu")[0]


@pytest.mark.parametrize("schedule,use_mis", [
    ("naive", False), ("classic", False), ("mega", False), ("mega", True)])
def test_events_and_lane_use(scene, schedule, use_mis):
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    px, py = k5_lanes.band_pixels(W, H, H // 2, 2, "cpu")
    assert px.shape[0] == W * H
    ev, rays = k5_lanes.path_events(scene, cam, schedule, px, py,
                                    max_depth=8, use_mis=use_mis)
    assert ev.shape == px.shape and int(ev.min()) >= 1
    if use_mis:
        assert int(ev.sum()) < rays
    else:
        assert int(ev.sum()) == rays
    w32, b128 = k5_lanes.lane_use(ev, 32), k5_lanes.lane_use(ev, 128)
    assert 0.0 < b128 <= w32 <= 1.0


def test_band_rows_spread():
    assert k5_lanes.band_rows(1080, 18, 2) == sorted(
        set(k5_lanes.band_rows(1080, 18, 2)))
    rows = k5_lanes.band_rows(1080, 18, 2)
    assert len(rows) == 18 and rows[0] == 0 and rows[-1] == 1078
    assert k5_lanes.band_rows(32, 20, 2) == list(range(0, 32, 2))


@pytest.mark.parametrize("mode,max_depth", [("light", 6), ("eye", 8)])
def test_walk_events_and_lane_use(scene, mode, max_depth):
    """K12's walks (--walk): each walk's bounces, min(max_depth - 1,
    valid vertices + 1), sum to the plain walk's closest rays."""
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    px, py = k5_lanes.band_pixels(W, H, H // 2, 2, "cpu")
    ev, rays = k5_lanes.walk_events(scene, cam, mode, px, py,
                                    max_depth=max_depth)
    assert ev.shape == px.shape and int(ev.min()) >= 1
    assert int(ev.max()) <= max_depth - 1
    assert int(ev.sum()) == rays > 0
    w32, b128 = k5_lanes.lane_use(ev, 32), k5_lanes.lane_use(ev, 128)
    assert 0.0 < b128 <= w32 <= 1.0


def test_vcm_eye_events_and_lane_use(scene):
    """The classic VCM eye walk (--walk vcm-eye) at the deployment's depth
    16 on 64 pixels: each path's closest rays equal the records it wrote,
    between 1 and 16, and fewer than the plain walk's closest and NEE
    rays."""
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, H, 0.0, 0.0, 0.0, 60.0)
    px, py = k5_lanes.band_pixels(W, H, 1, 2, "cpu")
    assert px.shape[0] == 2 * W
    ev, recs, rays = k5_lanes.vcm_eye_events(scene, cam, px, py,
                                             max_depth=16, n_paths=W * H)
    assert torch.equal(ev, recs)
    assert int(ev.min()) >= 1 and int(ev.max()) <= 16
    assert 0 < int(ev.sum()) < rays
    w32, b128 = k5_lanes.lane_use(ev, 32), k5_lanes.lane_use(ev, 128)
    assert 0.0 < b128 <= w32 <= 1.0
