"""The frozen bound arithmetic and the trace reduction, on hand-worked
shapes."""

import pytest

from pb import roofline as rf
from pb import spec, trace


def test_peaks_and_draw_cost():
    assert rf.PEAK_BYTES_S == 3.35e12 and rf.PEAK_OPS_S == 67e12
    # 59 INT32 instructions at 64 x 132 x 1.98e9 a second, in float32 ops
    assert rf.OPS_PER_DRAW == pytest.approx(236.3, abs=0.05)
    assert rf.OPS_PER_CAMERA_RAY == pytest.approx(4 * 236.3 + 60, abs=0.2)


def test_bound_takes_the_slower_side():
    assert rf.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert rf.bound_s(1.0, 134e12) == (2.0, "operations")


def test_k5_work_by_hand():
    cfg = {"work": {"rows_per_ray": 6.0, "scene_bytes": 1000}}
    q = {"dispatches": 2, "pixel_samples": 10, "rays": 100}
    nbytes, ops = spec.counts("k5").work(q, cfg)
    assert nbytes == 2 * 1000 + 10 * 24
    assert ops == pytest.approx(100 * 6.0 * 490 + 10 * rf.OPS_PER_CAMERA_RAY)


def test_vcm_stage_work_by_hand():
    cfg = {"work": {"rows_per_eye_walk_ray": 5.0, "rows_per_connect_ray": 7.0,
                    "rows_per_light_ray": 6.0, "scene_bytes": 0}}
    q = {"dispatches": 1, "pixel_samples": 4, "eye_walk_rays": 10,
         "eye_records": 3, "connect_rays": 20, "light_rays": 8,
         "light_vertices": 5}
    _, ops = spec.counts("eye_walk").work(q, cfg)
    assert ops == pytest.approx(10 * 5.0 * 490 + 4 * rf.OPS_PER_CAMERA_RAY
                                + 3 * rf.OPS_PER_WALK_VERTEX)
    nbytes, ops = spec.counts("eye_connect").work(q, cfg)
    assert ops == 20 * (7.0 * 490 + 40)
    assert nbytes == 3 * 84 + 5 * 64 + 20 * 12
    _, ops = spec.counts("k12").work(q, cfg)
    assert ops == pytest.approx(8 * 6.0 * 490 + 5 * rf.OPS_PER_WALK_VERTEX
                                + 4 * 5 * rf.OPS_PER_DRAW)


def test_summarize_unions_busy_and_names_gaps():
    dev = [("k_a", 0, 10), ("k_b", 5, 20), ("k_a", 30, 40), ("k_c", 45, 50)]
    spans = [(0, 25, "render_batch"), (26, 60, "accumulate")]
    s = trace.summarize(dev, spans)
    assert s["busy_s"] == pytest.approx(35e-6)       # [0,20] + 10 + 5 us
    assert s["kernel_s"]["k_a"] == pytest.approx(20e-6)
    assert s["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert s["idle_gaps"] == [["render_batch", pytest.approx(10e-6)],
                              ["accumulate", pytest.approx(5e-6)]]
    assert trace.device_seconds(s["kernel_s"], ("k_a", "k_c")) == \
        pytest.approx(25e-6)


def test_roofline_reader_is_silent_without_its_kernels():
    ctx = {"trace": {"kernel_s": {"other_kernel": 1.0}}, "q": {},
           "config": {}}
    assert spec.metric("k5_roofline").read(ctx) is None
