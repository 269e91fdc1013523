"""driver.Renderer over a mesh of ranks (`Mesh Shape`, parallel/sharding.py)
against the benchmark's plain reference, and its mesh's counters. This
module imports no JAX, so its card test runs on the card's machine.

On the CPU (four CPU ranks, one thread each):
  (a) a Renderer with `Mesh Shape: 2 2` renders the cell
      vcm-upstream-1080p-mesh2x2's settings at 32x24, eye 4, light 3,
      samples 0-1 in one dispatch, and perfbench/reference/'s single-rank
      dispatch of the same settings agrees with it under the
      configuration's limits (pb/check.py; rays and dropped exact);
  (b) its traced dispatch's mesh.bytes counter, summed over the
      collectives, equals perfbench/counts/mesh_exchange.py's bytes for
      the same settings, and its phases mesh_build and mesh_wait are
      recorded;
  (c) `Mesh Shape: 1 1` and no such line build no mesh, render as before
      (bit-equal to each other), and import nothing of parallel/;
  (d) a mega engine with a mesh is refused with the sharding's message.
On four cards (`cuda` marker, skips below four): (e) at 480x270 with the
cell's settings, the (2,2) Renderer's dispatch agrees with the one-card
Renderer's under the same limits, its mesh_build phase is recorded, and
its warm-up dispatch creates nothing of the exchange: no NCCL
communicator (NCCL's own log, NCCL_DEBUG INFO with subsystem INIT written
unbuffered to NCCL_DEBUG_FILE, holds no "Init COMPLETE" line, built or
after), and no copy stream beyond those the mesh made while the Renderer
was built (one a rank, on its tile peer's card).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from pb import check, inputs, program, spec  # noqa: E402
from reference.render import Reference  # noqa: E402

from cudapathtracer_tpu_torch.driver import Renderer  # noqa: E402
from cudapathtracer_tpu_torch.utils.config import parse_config  # noqa: E402

CONFIG = "cornell-bunny-vcm-mesh2x2"
SMALL = {"Bidirectional Eye Depth": "4", "Bidirectional Light Depth": "3"}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's workers would otherwise
    oversubscribe the cores with the plain versions' small operators."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(width, height, spd=2, **override):
    cfg = spec.config(CONFIG)
    cfg = dict(cfg, rendertron={**cfg["rendertron"], **override})
    text = inputs.settings_text(cfg, {"width": width, "height": height,
                                      "samples_per_dispatch": spd}, SEED)
    return cfg, text


@pytest.fixture(scope="module")
def cpu_mesh():
    """One traced dispatch (samples 0-1) of the (2,2) Renderer at 32x24 and
    the reference's dispatch of the same settings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, text = _settings(32, 24, **SMALL)
    mesh, mats, atlas = inputs.scene_inputs(cfg)
    r = program.renderer(text, mesh, mats, atlas, "cpu")
    r.metrics.trace = True
    out = r.render_batch(0, 2)
    got = dict(out=out, totals=r.metrics.counter_totals(),
               phases=dict(r.metrics.phases), mesh=r.device_mesh,
               cfg=cfg, ref=Reference(text, mesh, mats, atlas,
                                      "cpu").dispatch(0, 2))
    torch.set_num_threads(n)
    return got


def test_mesh_renderer_matches_reference(cpu_mesh):
    mesh = cpu_mesh["mesh"]
    assert mesh.shape == {"tile": 2, "spp": 2}
    assert [r.device.type for r in mesh.ranks] == ["cpu"] * 4
    li, rays, dropped = cpu_mesh["out"]
    ref_li, ref_rays, ref_dropped, _ = cpu_mesh["ref"]
    assert li.shape == (32 * 24, 3) and li.mean() > 0
    assert rays.dtype == dropped.dtype == torch.int64 and rays.dim() == 0
    assert int(rays) == ref_rays > 0 and int(dropped) == ref_dropped
    numbers = check.compare([(li, int(rays), int(dropped))],
                            [(ref_li, ref_rays, ref_dropped)])
    numbers["nonfinite"] = check.nonfinite(li)
    ok, table, failed = check.judge(numbers, cpu_mesh["cfg"]["limits"])
    assert ok, table


def test_mesh_bytes_match_counts(cpu_mesh):
    c = spec.counts("mesh_exchange")
    want, ops = c.work({"dispatches": 1, "pixels": 32 * 24, "k": 2},
                       cpu_mesh["cfg"])
    got = cpu_mesh["totals"]["mesh.bytes"]
    assert want > 0 and ops == 0 and sum(got.values()) == want
    # the photons and the splat over the tile axis; the spp axis is summed
    # on the first device, from the ranks' copies
    assert got["all_gather"] > 0 and got["all_reduce"] > 0
    assert got["to_first"] > 0
    phases = cpu_mesh["phases"]
    assert phases["mesh_build"] > 0 and phases["mesh_wait"] > 0


_ONE_CARD_PATH = """
import sys, torch
sys.path.insert(0, {repo!r})
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.utils.config import parse_config
outs = []
for line in ("", "Mesh Shape: 1 1\\n"):
    r = Renderer(parse_config({text!r} + line + {meshes!r}), device="cpu")
    assert r.device_mesh is None and r.cfg.mesh_shape == (1, 1)
    outs.append(r.render_batch(0, 2))
a, b = outs
assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]) > 0
print(sorted(m for m in sys.modules
             if m.startswith("cudapathtracer_tpu_torch.parallel")))
"""


def test_mesh_shape_one_is_the_one_card_path():
    text = ("Integrator: UNIDIRECTIONAL\nEngine: classic\n"
            "Unidirectional Max Depth: 3\nPinhole Camera: true\n"
            "Camera Position: 0.0 0.0 1.0\nwidth: 8\nheight: 6\n")
    assert parse_config(text).mesh_shape == (1, 1)
    assert parse_config(text + "Mesh Shape: 2 1\n").mesh_shape == (2, 1)
    with pytest.raises(ValueError, match="Mesh Shape"):
        parse_config(text + "Mesh Shape: 2 0\n")
    meshes = "Meshes:\nbuiltin:cornell; 0 * (0,0,0); 0\n"
    run = subprocess.run([sys.executable, "-c",
                          _ONE_CARD_PATH.format(repo=REPO, text=text,
                                                meshes=meshes)],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_mesh_refuses_mega_engine():
    _, text = _settings(8, 6, **SMALL, Engine="mega")
    with pytest.raises(NotImplementedError, match="splat_shape"):
        Renderer(parse_config(text), device="cpu")


# --- on four cards -------------------------------------------------------

_FOUR_CARDS = """
import json, os, sys, torch
sys.path[:0] = [{repo!r}, {bench!r}]
from pb import check, inputs, program, spec

def inits():
    if not os.path.exists({log!r}):
        return 0
    with open({log!r}) as f:
        return f.read().count("Init COMPLETE")

cfg = spec.config({config!r})
text = inputs.settings_text(cfg, dict(width=480, height=270,
                                      samples_per_dispatch=2), {seed})
mesh, mats, atlas = inputs.scene_inputs(cfg)
def pulls(r):
    return sum(len(k.tile.pulls) for k in r.device_mesh.ranks)

r = program.renderer(text, mesh, mats, atlas, "cuda")
built, pulls_built = inits(), pulls(r)
li, rays, dropped = r.render_batch(0, 2)
torch.cuda.synchronize()
after, pulls_after = inits(), pulls(r)
got = (li.cpu(), int(rays), int(dropped))
phases = dict(r.metrics.phases)
describe = r.device_mesh.describe()
del r, li
one = program.renderer(text.replace("Mesh Shape: 2 2", "Mesh Shape: 1 1"),
                       mesh, mats, atlas, "cuda")
assert one.device_mesh is None
w = one.render_batch(0, 2)
want = (w[0].cpu(), int(w[1]), int(w[2]))
numbers = check.compare([got], [want])
numbers["nonfinite"] = check.nonfinite(got[0])
ok, table, failed = check.judge(numbers, cfg["limits"])
print(json.dumps(dict(built=built, after=after, pulls=[pulls_built,
                                                      pulls_after],
                      ok=ok, table=table,
                      phases=phases, describe=describe,
                      rays=[got[1], want[1]], dropped=[got[2], want[2]])))
"""


@pytest.mark.cuda
def test_mesh_renderer_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (run on a four-card machine)")
    log = str(tmp_path / "nccl.log")
    env = dict(os.environ, NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT",
               NCCL_DEBUG_FILE=log)
    script = _FOUR_CARDS.format(repo=REPO, bench=BENCH, log=log,
                                config=CONFIG, seed=SEED)
    run = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["describe"].startswith("(2, 2) mesh on [cuda:0, cuda:1")
    assert got["phases"]["mesh_build"] > 0
    assert got["built"] == got["after"] == 0, got
    # each rank copies from its one tile peer's card
    assert got["pulls"] == [4, 4], got
    assert got["rays"][0] == got["rays"][1] > 0
    assert got["dropped"][0] == got["dropped"][1]
    assert got["ok"], got["table"]
