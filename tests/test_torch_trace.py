"""The port's tracing (utils/metrics.py, Renderer(trace=True)).

On the CPU, at 16x12: the span tree of a dispatch (render_batch > step >
stages) for the unidirectional and classic VCM paths, whose self times add
up to the dispatch's span; nothing recorded and the same radiance and rays
with tracing off; spans of a mesh's rank threads carrying the rank; the
scene_build phase around the mesh's load; the counters' ratios; that no
span name holds a substring by which the benchmark finds a kernel's
device time (perfbench/counts/*.py KERNELS); and tools/trace_window.py's
reading of a profiler's events (span copies dropped, gaps named by the
innermost span).

On the card (marker cuda): each counter's totals equal the sums of the
per-ray outputs of the same launches (K5's rows and rays, the eye walk's
and the connections' rows and rays; the connections' pairs queued, the
queue's length and its twin's), the lane counters stay within 32 lanes a
call, the shares at or below 1, and the outputs are bit-equal with
tracing on and off.
"""

import ast
import glob
import os
import time

import pytest
import torch

from cudapathtracer_tpu_torch import driver, kernels
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.models import bdpt, bdpt_mega, paths, vcm
from cudapathtracer_tpu_torch.models import unidirectional as uni
from cudapathtracer_tpu_torch.models import vcm_mega
from cudapathtracer_tpu_torch.ops import hashgrid
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import metrics, rng
from cudapathtracer_tpu_torch.utils.config import parse_config
from cudapathtracer_tpu_torch.utils.metrics import RenderMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETTINGS = """Name: tiny
width: 16
height: 12
Integrator: {integrator}
Engine: {engine}
Sample Count: 2
Unidirectional Max Depth: 3
Bidirectional Eye Depth: 3
Bidirectional Light Depth: 2
BDPT_LIGHTTRACE: true
BDPT_NEE: true
BDPT_NAIVE: true
BDPT_CONNECTION: true
BDPT_DOMIS: true
Pinhole Camera: true
Camera Position: 0.0 0.0 1.0
Camera Rotation: 0.0 0.0 0.0
Camera FOV: 60.0
Meshes (path; multiplier * emission; materialID):
builtin:cornell_blocks; 1.0 * (0.0, 0.0, 0.0); 2
"""
PATHS = {"unidirectional": (("UNIDIRECTIONAL", "mega"), "unidirectional_mega",
                            ("camera", "paths")),
         "vcm": (("VCM", "classic"), "vcm",
                 ("light_walk", "splat", "photon_grid", "eye_pass"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _renderer(integrator, engine, trace, device="cpu"):
    text = SETTINGS.format(integrator=integrator, engine=engine)
    return Renderer(parse_config(text), device=device, trace=trace)


@pytest.mark.parametrize("path", list(PATHS))
def test_span_tree(path):
    (integrator, engine), step, stages = PATHS[path]
    r = _renderer(integrator, engine, True)
    r.render_batch(3, 1)
    spans = [s for s in r.metrics.spans if s.name.startswith("tpt.driver")
             or s.name.startswith("tpt.step")]
    by_sid = {s.sid: s for s in spans}
    root, = [s for s in spans if s.name == "tpt.driver.render_batch"]
    st, = [s for s in spans if s.name == f"tpt.step.{step}"]
    assert st.parent == root.sid and root.parent == -1
    kids = [s for s in spans if s.parent == st.sid]
    assert [s.name for s in sorted(kids, key=lambda s: s.start)] == [
        f"tpt.step.{step}.{x}" for x in stages]
    assert all(s.ident == 3 for s in spans)   # the dispatch's first sample
    assert all(s.rank is None for s in spans)
    # the self times of the tree add up to the dispatch's duration
    total = sum(s.self_s for s in spans)
    assert abs(total - (root.end - root.start)) < 1e-9
    for s in spans:
        inner = sum(c.end - c.start for c in spans if c.parent == s.sid)
        assert abs(s.self_s - (s.end - s.start - inner)) < 1e-9
        assert s.self_s >= 0.0 and (s.parent == -1 or s.parent in by_sid)
    layers = r.metrics.layer_ms()
    assert abs(layers["driver"] + layers["step"] + layers["kernels"]
               - (root.end - root.start) * 1e3) < 1e-6
    assert layers["kernels"] == 0.0    # the CPU runs no kernel entry
    text = r.metrics.summary()
    assert "tpt.driver.render_batch" in text and "self ms a dispatch" in text
    assert metrics._here.metrics is None


@pytest.mark.parametrize("path", list(PATHS))
def test_trace_off_records_nothing_and_changes_nothing(path):
    (integrator, engine), _, _ = PATHS[path]
    outs = {}
    for trace in (False, True):
        r = _renderer(integrator, engine, trace)
        outs[trace] = r.render_batch(0, 2)
        m = r.metrics
        if not trace:
            assert not m.spans and not m.span_totals and not m.counters
            assert set(m.phases) == {"scene_build", "bvh_build"}
            assert "spans" not in m.summary()
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


def test_render_loop_spans():
    """Renderer.render's loop body is tpt.driver.render_batch, inside
    tpt.render, one a dispatch, each identified by its first sample."""
    r = _renderer("UNIDIRECTIONAL", "classic", True)
    r.render(num_samples=3, progressive=False, verbose=False)
    names = [s.name for s in r.metrics.spans]
    render, = [s for s in r.metrics.spans if s.name == "tpt.render"]
    batches = [s for s in r.metrics.spans
               if s.name == "tpt.driver.render_batch"]
    assert [s.ident for s in batches] == [0, 1, 2]
    assert all(s.parent == render.sid for s in batches)
    assert names.count("tpt.step.unidirectional") == 3


def test_mesh_rank_spans():
    """A mesh's rank threads trace under the caller's span, each span
    carrying its rank."""
    from cudapathtracer_tpu_torch.parallel import sharding
    mesh = sharding.make_mesh(2, 1, devices=["cpu", "cpu"])
    m = RenderMetrics(trace=True)
    with m.span("tpt.driver.render_batch", 5):
        outer = metrics._here.stack[-1].sid

        def fn(r):
            with metrics.span("tpt.step.rank_work"):
                return r.rank
        assert mesh.run(fn) == [0, 1]
    work = [s for s in m.spans if s.name == "tpt.step.rank_work"]
    assert sorted(s.rank for s in work) == [0, 1]
    assert all(s.parent == outer and s.ident == 5 for s in work)
    # without tracing the ranks record nothing
    assert metrics._here.metrics is None


def test_scene_build_times_the_mesh_load(monkeypatch):
    def slow():
        time.sleep(0.05)
        return builtin.cornell_with_blocks()
    monkeypatch.setitem(driver.BUILTIN_SCENES, "builtin:cornell_blocks", slow)
    r = _renderer("UNIDIRECTIONAL", "mega", False)
    assert r.metrics.phases["scene_build"] >= 0.05


RATIO_CASES = {  # case -> (counter words, the ratios they give)
    "k5": ({"k5.tally": [60, 10], "k5.lanes": [48, 2, 2]},
           {"k5.rows_per_ray": 6.0, "k5.lane_use": 0.75}),
    "eye_connect": ({"eye_connect.tally": [70, 16, 1, 20, 160]},
                    {"eye_connect.rows_per_ray": 70 / 16,
                     "eye_connect.lane_use": 0.5,
                     "eye_connect.queue_share": 0.125,
                     "eye_connect.trace_share": 0.8}),
    "eye_walk": ({"eye_walk.tally": [90, 12], "eye_walk.lanes": [48, 2, 3]},
                 {"eye_walk.rows_per_ray": 7.5, "eye_walk.lane_use": 0.5,
                  "eye_walk.event_balance": 0.75}),
}


@pytest.mark.parametrize("case", list(RATIO_CASES))
def test_counter_ratios(case):
    counters, want = RATIO_CASES[case]
    m = RenderMetrics(trace=True)
    for name, words in counters.items():
        m.counter(name, "cpu").copy_(torch.tensor(words))
    got = metrics.ratios(m.counter_totals())
    assert got == want
    assert all(v <= 1.0 for k, v in got.items()
               if k.endswith(("lane_use", "_share", "_balance")))
    first = next(iter(want))
    assert f"{first}: {want[first]:.4f}" in m.summary()
    m.reset_trace()
    assert metrics.ratios(m.counter_totals()) == {}


def _program_span_names() -> set:
    """Every span name the program can open: the kernel entries', the
    models' stages and the driver's, and the phases'."""
    names = {"tpt.driver.render_batch"}
    names |= {f"tpt.{p}" for p in ("scene_build", "bvh_build", "render")}
    names |= {fn.span for fn in vars(kernels).values()
              if isinstance(getattr(fn, "span", None), str)}
    for mod in (vcm, bdpt, vcm_mega, bdpt_mega):
        names |= set(mod.STAGES.values())
    for step in uni.STEPS.values():
        names |= {f"tpt.step.{step}", f"tpt.step.{step}.camera",
                  f"tpt.step.{step}.paths"}
    names |= {f"tpt.step.{fn.__module__.rsplit('.', 1)[1]}"
              for fn in driver._RENDER.values()}
    return names


def test_span_names_miss_the_benchmarks_kernel_names():
    kernel_names = set()
    for path in glob.glob(os.path.join(REPO, "perfbench", "counts", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if (isinstance(node, ast.Assign)
                    and node.targets[0].id == "KERNELS"):
                kernel_names |= set(ast.literal_eval(node.value))
    names = _program_span_names()
    assert kernel_names and len(names) > 40
    assert all(n.startswith(metrics.SPAN_PREFIX) for n in names)
    assert not [(n, k) for n in names for k in kernel_names if k in n]
    # the entries that the models call all open a span
    assert {"tpt.kernel.render_unidirectional", "tpt.kernel.vcm_eye",
            "tpt.kernel.bdpt_walk", "tpt.kernel.photon_sort"} <= names


def test_trace_window_events():
    """tools/trace_window.py's split of a synthetic profiler event list,
    read by the benchmark's perfbench/pb/trace.py: the device-side copies
    of the program's spans are not device work, and an idle gap is named
    by the innermost span open when it began, the program's inside the
    benchmark's."""
    import importlib.util
    from types import SimpleNamespace as NS
    spec = importlib.util.spec_from_file_location(
        "trace_window", os.path.join(REPO, "tools", "trace_window.py"))
    tw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tw)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, t0, t1, dev):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=t0, end=t1))
    events = [ev("render_batch", 0, 101, cpu),          # the benchmark's
              ev("tpt.driver.render_batch", 1, 100, cpu),
              ev("tpt.step.vcm", 5, 95, cpu),
              ev("tpt.kernel.vcm_eye", 60, 70, cpu),
              ev("tpt.step.vcm", 10, 90, cuda),     # a span's device copy
              ev("eye_walk_kernel", 20, 40, cuda),
              ev("eye_connect_kernel", 50, 65, cuda),
              ev("eye_gather_kernel", 80, 85, cuda),
              ev("accumulate", 102, 110, cpu),
              ev("aten::add", 120, 130, cpu),
              ev("reduce_kernel", 140, 150, cuda),
              ev("reduce_kernel", 160, 170, cuda)]
    dev, spans, copies = tw.split_events(NS(events=lambda: events))
    assert copies == 1 and [d[0] for d in dev] == [
        "eye_walk_kernel", "eye_connect_kernel", "eye_gather_kernel",
        "reduce_kernel", "reduce_kernel"]
    assert [s[2] for s in spans] == [
        "render_batch", "tpt.driver.render_batch", "tpt.step.vcm",
        "tpt.kernel.vcm_eye", "accumulate"]
    summ = tw.tr.summarize(dev, spans)
    assert summ["busy_s"] == pytest.approx(60e-6)
    # 40-50 inside the step only, 65-80 inside the kernel entry, 85-140
    # from inside the step until after the dispatch, 150-160 outside any
    assert [g[0] for g in summ["idle_gaps"]] == [
        "tpt.step.vcm", "tpt.kernel.vcm_eye", "tpt.step.vcm", "host"]
    assert [g[1] for g in summ["idle_gaps"]] == pytest.approx(
        [55e-6, 15e-6, 10e-6, 10e-6])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA for sm_90a)")
    kernels.build()
    return torch.device("cuda")


def _scene(cuda, w=96, h=64):
    sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                        device=cuda)
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=cuda),
                            torch.arange(w, dtype=torch.int32, device=cuda),
                            indexing="ij")
    return sc, cam, gx.reshape(-1).contiguous(), gy.reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["mega", "classic", "naive"])
def test_k5_counters_on_card(cuda, schedule):
    sc, cam, px, py = _scene(cuda)

    def run():
        return kernels.render_unidirectional(
            sc, px, py, cam.kernel_params(), rng.base_key(), 1, 2,
            max_depth=5, use_mis=schedule != "naive",
            sample_environment=False, schedule=schedule,
            air_priority=sc.air_priority, with_rows=True)
    off = run()
    m = RenderMetrics(trace=True)
    with m.span("tpt.driver.render_batch", 1):
        on = run()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    t = m.counter_totals()
    li, rays, rows = on
    assert t["k5.tally"] == {"rows": int(rows.sum()), "rays": int(rays.sum())}
    ln = t["k5.lanes"]
    assert 0 < ln["events"] <= 32 * ln["calls"]
    assert ln["events"] <= 32 * ln["busiest"]
    assert m.span_totals["tpt.kernel.render_unidirectional"][0] == 1


@pytest.mark.cuda
def test_eye_and_light_walk_counters_on_card(cuda):
    """The classic VCM pass stage by stage: the walk's and the
    connections' tallies equal what each stage added to the per-path rows
    and rays; K12's light walk's and the eye walk's lane counters (a walk
    bounce a record); outputs as untraced."""
    sc, cam, px, py = _scene(cuda)
    cfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
    key_l, key_e = vcm.sample_keys(rng.base_key(), 2)
    n = px.shape[0]
    mr, eta, norm = vcm.sample_scalars(sc, cfg, 2, n)

    def run():
        rays = torch.zeros(n, dtype=torch.int32, device=cuda)
        lw = kernels.bdpt_walk(sc, px, py, paths.walk_keys(key_l, "light"),
                               mode="light", max_depth=cfg.light_depth + 1,
                               rays=rays, eta_vcm=eta)
        grid = hashgrid.build_grid_kernel(lw["bufs"], sc.scene_min, mr,
                                          hashgrid.photon_salt(2))
        ep = kernels.vcm_eye_pass(
            sc, cam, paths.walk_keys(key_e, "eye"), lw["bufs"], grid, None,
            rays, cfg, px=px, py=py, merge_radius=mr, eta_vcm=eta,
            merge_norm=norm, with_rows=True,
            **hashgrid.merge_switches(cfg.max_per_cell))
        seen = [(int(rays.sum()), 0)]
        for stage in (kernels.eye_walk, kernels.eye_connect,
                      kernels.eye_gather):
            stage(ep)
            seen.append((int(rays.sum()), int(ep.rows.sum())))
        return ep, seen, lw["bufs"]
    ep0, seen0, _ = run()
    m = RenderMetrics(trace=True)
    with m.span("tpt.driver.render_batch", 2):
        ep1, seen1, lb1 = run()
    assert seen0 == seen1
    for a, b in ((ep0.out, ep1.out), (ep0.dropped, ep1.dropped),
                 (ep0.rays, ep1.rays), (ep0.rows, ep1.rows)):
        assert torch.equal(a, b)
    t = m.counter_totals()
    (r0, _), (r1, w1), (r2, w2), (r3, w3) = seen1
    assert t["eye_walk.tally"] == {"rows": w1, "rays": r1 - r0}
    assert t["eye_connect.tally"]["rows"] == w2 - w1
    assert t["eye_connect.tally"]["rays"] == r2 - r1 > 0
    assert (r3, w3) == (r2, w2)    # the gather traces nothing
    c = t["eye_connect.tally"]
    assert c["rays"] <= 32 * c["calls"]
    assert c["slots"] == cfg.eye_depth * cfg.light_depth * n
    assert c["queued"] == int(ep1.queued[0]) == vcm.eye_connect_queue_plain(
        ep1.rec, lb1).numel()
    assert 0 < c["rays"] <= c["queued"] < c["slots"]
    ln = t["k12.lanes"]
    assert 0 < ln["events"] <= 32 * ln["calls"]
    # a walk bounce is one closest ray and writes one record
    ln = t["eye_walk.lanes"]
    assert ln["events"] == int((ep1.rec.flags != 0).sum())
    assert 0 < ln["events"] <= min(32 * ln["calls"], 32 * ln["busiest"],
                                   r1 - r0)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_renderer_trace_on_card(cuda, path):
    """Through the Renderer: the same radiance and counts traced as
    untraced, the kernel entries' spans under the stages, the counters'
    ratios. VCM's light-trace splat adds into the frame with float atomics
    in an order that varies from run to run, so its radiance is held to
    float rounding and its counts exactly; K5's radiance is bit-equal."""
    (integrator, engine), step, stages = PATHS[path]
    outs, rs = {}, {}
    for trace in (False, True):
        rs[trace] = r = _renderer(integrator, engine, trace, device="cuda")
        outs[trace] = [r.render_batch(s, 1) for s in range(2)]
    for a, b in zip(outs[False], outs[True]):
        if path == "vcm":
            assert torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-7)
        else:
            assert torch.equal(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)
    m = rs[True].metrics
    by_sid = {s.sid: s for s in m.spans}
    kern = [s for s in m.spans if s.name.startswith("tpt.kernel.")]
    assert kern and all(by_sid[s.parent].name.startswith(f"tpt.step.{step}.")
                        for s in kern)
    got = metrics.ratios(m.counter_totals())
    want = ({"k5.rows_per_ray", "k5.lane_use"} if path == "unidirectional"
            else {"k12.lane_use", "eye_walk.rows_per_ray",
                  "eye_walk.lane_use", "eye_walk.event_balance",
                  "eye_connect.rows_per_ray", "eye_connect.lane_use",
                  "eye_connect.queue_share", "eye_connect.trace_share"})
    assert set(got) == want
    assert all(0.0 < v for v in got.values())
    assert all(got[k] <= 1.0 for k in want
               if k.endswith(("lane_use", "_share", "_balance")))
    assert m.layer_ms()["kernels"] > 0.0
