"""BENCHMARK.json against its contract and the files it names; a new
configuration, traffic mix or metric is found from added files alone."""

import json
import os
import re
import shutil

import pytest

from pb import roofline, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_entries(bench):
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in cells
        cells.add(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s",
                                                        "msamples_per_s"}


@pytest.mark.parametrize("kind", ["configs", "traffic"])
def test_every_named_file_loads(bench, kind):
    for w in bench["workloads"]:
        cell, cfg, traffic = spec.cell(bench, w["name"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        if kind == "configs":
            assert set(cfg["limits"]) >= {"px_off", "rays_rel", "nonfinite"}
            for k in cfg["counted"]:
                c = spec.counts(k)
                assert c.KERNELS and callable(c.work)
        else:
            assert traffic["width"] * traffic["height"] > 0
            assert traffic["samples_per_dispatch"] >= 0


def test_metric_readers_match_their_entries(bench):
    for m in bench["per_layer"]:
        mod = spec.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert mod.MOVES in {e["name"] for e in bench["end_to_end"]}
        assert mod.read(_empty_ctx()) is None


def _empty_ctx():
    return dict(trace=None, enqueue_s=[], launches={}, samples=0,
                phases={}, window_s=0.0, q={}, config={})


def test_every_cell_reports_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        assert spec.metrics_of(bench, w["name"], trace=True)
        assert {m["name"] for m in spec.metrics_of(
            bench, w["name"], trace=False)} >= {"setup_s", "msamples_per_s"}


def test_added_files_are_found_without_edits(tmp_path, bench):
    """A later PR adds a configuration, a traffic mix, a metric and a
    kernel's counts as files and entries; the harness finds them by name."""
    bdir = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH, bdir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(bdir / "configs" / "cornell-bunny-uni.json"))
    cfg.update(name="cornell-bunny-uni-d4", counted=["k5", "k_new"])
    cfg["rendertron"]["Unidirectional Max Depth"] = "4"
    json.dump(cfg, open(bdir / "configs" / "cornell-bunny-uni-d4.json", "w"))
    json.dump({"name": "offline-640", "kind": "offline", "width": 640,
               "height": 360, "samples_per_dispatch": 0},
              open(bdir / "traffic" / "offline-640.json", "w"))
    (bdir / "counts" / "k_new.py").write_text(
        "KERNELS = ('new_kernel',)\n"
        "def work(q, cfg):\n    return q['pixel_samples'] * 8, 0\n")
    (bdir / "metrics" / "new.share.py").write_text(
        "LAYER = 'device'\nUNIT = '%'\nBETTER = 'higher'\n"
        "SOURCE = 'device_trace'\nMOVES = 'msamples_per_s'\n"
        "def read(ctx):\n    return 42.0\n")
    b = dict(bench)
    b["workloads"] = bench["workloads"] + [
        {"name": "uni-d4-640", "config": "cornell-bunny-uni-d4",
         "traffic": "offline-640", "chips": 1, "why": "added"}]
    b["per_layer"] = bench["per_layer"] + [
        {"name": "new.share", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "msamples_per_s", "workloads": ["uni-d4-640"]}]
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    old = {p: getattr(spec, p) for p in ("BENCH", "ROOT")}
    try:
        spec.BENCH, spec.ROOT = str(bdir), str(tmp_path)
        loaded = spec.load_benchmark(str(tmp_path))
        cell, c, t = spec.cell(loaded, "uni-d4-640")
        assert c["rendertron"]["Unidirectional Max Depth"] == "4"
        assert (t["width"], t["height"]) == (640, 360)
        names = [m["name"] for m in spec.metrics_of(loaded, "uni-d4-640",
                                                    trace=True)]
        assert names == ["new.share"]
        assert spec.metric("new.share", str(bdir)).read({}) == 42.0
        k = spec.counts("k_new", str(bdir))
        assert roofline.bound_s(*k.work({"pixel_samples": 335}, c)) == (
            335 * 8 / roofline.PEAK_BYTES_S, "bytes")
    finally:
        for p, v in old.items():
            setattr(spec, p, v)
