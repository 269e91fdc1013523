"""What the harness loads and where it refuses to report."""

import ast
import json
import os
import subprocess
import sys

import pytest

from pb import cell, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cudapathtracer_tpu"}

PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from pb import cell
res = cell.run("uni-bunny-1080p", 5, 0.01, device="cpu",
               traffic_override=dict(width=8, height=6))
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "top": top}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run on the CPU (set-up, window, reference) in a fresh
    process: no module whose top-level name, compared whole, is JAX's or
    the JAX package's. The port's own name begins with the JAX package's,
    and is loaded."""
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=spec.BENCH, root=spec.ROOT)],
        capture_output=True, text=True, timeout=600, cwd=spec.ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert not FORBIDDEN & set(res["top"])
    assert "cudapathtracer_tpu_torch" in res["top"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                names = _imports(os.path.join(d, f))
                assert not names & (FORBIDDEN | {"cudapathtracer_tpu_torch"}
                                    ), (f, names)


def test_only_program_module_imports_the_program():
    for d, _, files in os.walk(spec.BENCH):
        if os.sep + "tests" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                names = _imports(os.path.join(d, f))
                assert not names & FORBIDDEN, (f, names)


def test_no_card_no_result():
    """Asked to measure where torch sees no card, the harness exits
    non-zero and prints no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH, "run.py"), "--workload",
         "uni-bunny-1080p", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    harness exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "uni-bunny-1080p",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "correct" not in out.stdout


@pytest.mark.parametrize("name", cell.PROGRAM_SWITCHES)
def test_a_program_switch_set_is_refused(monkeypatch, name):
    """The program reads these from the environment; the reference holds
    their defaults fixed, so a run with one set is refused before set-up."""
    monkeypatch.setenv(name, "0")
    with pytest.raises(SystemExit, match=name):
        cell.run("vcm-upstream-800", 3, 0.01, device="cpu",
                 traffic_override=dict(width=8, height=6))


def test_reference_reads_no_environment():
    ref = os.path.join(spec.BENCH, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(d, f)).read()
                assert "os.environ" not in src and "getenv" not in src, f
