"""Driver and CLI of the PyTorch port, on the CPU (--device cpu).

No float tolerance here: these tests check the product surface — a real
BMP from the CLI (also from configs/cornell.rendertron as shipped, which
renders with the default mega engine), every integrator with its default
engine, exact checkpoint resume, refusal of an unknown engine, that neither
JAX nor the JAX package is imported, and that the CPU path launches no
kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch import cli, kernels
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.utils.config import parse_config
from cudapathtracer_tpu_torch.utils.image import load_bmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


BDPT_SETTINGS = """Bidirectional Eye Depth: 5
Bidirectional Light Depth: 3
BDPT_LIGHTTRACE: true
BDPT_NEE: true
BDPT_NAIVE: true
BDPT_CONNECTION: true
BDPT_DOMIS: true
"""


def _config_text(out_dir, engine="classic", integrator="UNIDIRECTIONAL"):
    return f"""Name: tiny
width: 32
height: 24
Integrator: {integrator}
Engine: {engine}
Sample Count: 2
Unidirectional Max Depth: 4
{BDPT_SETTINGS}Pinhole Camera: true
Camera Position: 0.0 0.0 1.0
Camera Rotation: 0.0 0.0 0.0
Camera FOV: 60.0
Output Dir: {out_dir}
Meshes (path; multiplier * emission; materialID):
builtin:cornell_blocks; 1.0 * (0.0, 0.0, 0.0); 2
"""


def test_cli_end_to_end(tmp_path):
    cfg = tmp_path / "tiny.rendertron"
    out = tmp_path / "renders"
    cfg.write_text(_config_text(out))
    kernels.reset_launches()
    assert cli.main([str(cfg), "--device", "cpu", "--no-progressive"]) == 0
    img = load_bmp(str(out / "tiny0.bmp"), decode_srgb=False)
    assert img.shape == (24, 32, 3)
    assert (img.max(axis=-1) > 0).mean() > 0.9
    assert (out / "tiny0.csv").exists()
    # the CPU path runs the plain versions only
    assert all(v == 0 for v in kernels.launches.values())


def test_cli_default_config(tmp_path, monkeypatch):
    """configs/cornell.rendertron as shipped (no Engine line: the mega
    engine) renders on the CPU into a real BMP."""
    monkeypatch.chdir(tmp_path)
    kernels.reset_launches()
    cfg = os.path.join(REPO, "configs", "cornell.rendertron")
    assert cli.main([cfg, "--device", "cpu", "--no-progressive",
                     "--samples", "2", "--width", "32",
                     "--height", "24"]) == 0
    img = load_bmp(str(tmp_path / "renders" / "cornell0.bmp"),
                   decode_srgb=False)
    assert img.shape == (24, 32, 3)
    assert (img.max(axis=-1) > 0).mean() > 0.9
    assert all(v == 0 for v in kernels.launches.values())


def test_checkpoint_resume_exact(tmp_path):
    cfg = parse_config(_config_text(tmp_path / "r"))
    ck = str(tmp_path / "ck.npz")
    a = Renderer(cfg, device="cpu")
    a.render(num_samples=1, progressive=False, verbose=False)
    a.save_checkpoint(ck)
    b = Renderer(cfg, device="cpu")
    b.render(num_samples=2, checkpoint_path=ck, progressive=False,
             verbose=False)
    assert b.sample_count == 2
    c = Renderer(cfg, device="cpu")
    c.render(num_samples=2, progressive=False, verbose=False)
    torch.testing.assert_close(b.accum, c.accum, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        a.save_checkpoint(str(tmp_path / "orbax_dir"))


@pytest.mark.parametrize("engine,integrator", [
    ("mega", "BIDIRECTIONAL"), ("classic", "NAIVE_UNIDIRECTIONAL"),
    ("mega", "VCM"), ("mega", "SPPM")])
def test_unported_raise(tmp_path, engine, integrator):
    """What raised NotImplementedError before the mega engines and naive
    were ported now renders through Renderer and the CLI on the CPU (a
    real image, rays, no kernel launched); an unknown engine still
    raises."""
    cfg = parse_config(_config_text(tmp_path / "r", engine, integrator))
    kernels.reset_launches()
    r = Renderer(cfg, device="cpu")
    img = r.render(num_samples=1, progressive=False, verbose=False)
    assert img.pixels.shape == (24, 32, 3)
    fb = r.framebuffer()
    assert np.isfinite(fb).all() and (fb >= 0).all()
    lit = (fb.max(axis=-1) > 0).mean()
    # SPPM sees only what its photons light and naive only paths that
    # reach the light by BSDF sampling: both are sparse at 1 spp
    assert lit > (0.02 if integrator in ("SPPM", "NAIVE_UNIDIRECTIONAL")
                  else 0.9)
    assert r.metrics.rays_traced > 24 * 32
    if integrator in ("VCM", "SPPM"):
        assert r.metrics.merge_dropped is not None
    assert all(v == 0 for v in kernels.launches.values())
    path = tmp_path / "cfg.rendertron"
    out = tmp_path / "renders"
    path.write_text(_config_text(out, engine, integrator))
    assert cli.main([str(path), "--device", "cpu", "--no-progressive",
                     "--samples", "1"]) == 0
    assert load_bmp(str(out / "tiny0.bmp"), decode_srgb=False).shape == \
        (24, 32, 3)
    bad = parse_config(_config_text(tmp_path, "wavefront", integrator))
    with pytest.raises(NotImplementedError, match="wavefront"):
        Renderer(bad, device="cpu")


def test_unknown_engine_raises(tmp_path):
    """An engine other than mega or classic raises, through Renderer and
    through the CLI."""
    cfg = parse_config(_config_text(tmp_path, "threaded"))
    with pytest.raises(NotImplementedError, match="'mega'.*'classic'"):
        Renderer(cfg, device="cpu")
    path = tmp_path / "cfg.rendertron"
    path.write_text(_config_text(tmp_path, "threaded"))
    with pytest.raises(NotImplementedError):
        cli.main([str(path), "--device", "cpu"])


def test_bdpt_classic_renderer(tmp_path):
    """BIDIRECTIONAL with Engine classic renders on the CPU through
    Renderer with the plain versions: a real image, the config's depths,
    no kernel launched."""
    cfg = parse_config(_config_text(tmp_path / "r", "classic",
                                    "BIDIRECTIONAL"))
    kernels.reset_launches()
    r = Renderer(cfg, device="cpu")
    img = r.render(num_samples=2, progressive=False, verbose=False)
    assert img.pixels.shape == (24, 32, 3)
    fb = r.framebuffer()
    assert np.isfinite(fb).all() and (fb >= 0).all()
    assert (fb.max(axis=-1) > 0).mean() > 0.9
    assert r.metrics.rays_traced > 2 * 24 * 32
    assert all(v == 0 for v in kernels.launches.values())


def test_bdpt_classic_cli(tmp_path):
    path = tmp_path / "bdpt.rendertron"
    out = tmp_path / "renders"
    path.write_text(_config_text(out, "classic", "BIDIRECTIONAL"))
    assert cli.main([str(path), "--device", "cpu", "--no-progressive",
                     "--samples", "1"]) == 0
    img = load_bmp(str(out / "tiny0.bmp"), decode_srgb=False)
    assert img.shape == (24, 32, 3)
    assert (img.max(axis=-1) > 0).mean() > 0.9


@pytest.mark.parametrize("integrator", ["VCM", "SPPM"])
def test_vcm_sppm_classic_renderer(tmp_path, integrator):
    """VCM and SPPM with Engine classic render on the CPU through Renderer
    with the plain versions: a real image, rays, the merge-cap counter, no
    kernel launched. SPPM sees only what its 2,304 photons light (its
    16x16 golden is 10.5% non-black)."""
    cfg = parse_config(_config_text(tmp_path / "r", "classic", integrator))
    kernels.reset_launches()
    r = Renderer(cfg, device="cpu")
    img = r.render(num_samples=2, progressive=False, verbose=False)
    assert img.pixels.shape == (24, 32, 3)
    fb = r.framebuffer()
    assert np.isfinite(fb).all() and (fb >= 0).all()
    lit = (fb.max(axis=-1) > 0).mean()
    assert lit > (0.9 if integrator == "VCM" else 0.05)
    assert r.metrics.rays_traced > 2 * 24 * 32
    assert r.metrics.merge_dropped is None or r.metrics.merge_dropped > 0
    assert all(v == 0 for v in kernels.launches.values())


@pytest.mark.parametrize("integrator", ["VCM", "SPPM"])
def test_vcm_sppm_classic_cli(tmp_path, integrator):
    path = tmp_path / "vcm.rendertron"
    out = tmp_path / "renders"
    path.write_text(_config_text(out, "classic", integrator))
    assert cli.main([str(path), "--device", "cpu", "--no-progressive",
                     "--samples", "1"]) == 0
    img = load_bmp(str(out / "tiny0.bmp"), decode_srgb=False)
    assert img.shape == (24, 32, 3)
    assert (img.max(axis=-1) > 0).mean() > (0.9 if integrator == "VCM"
                                            else 0.02)


def test_default_device_is_cuda(tmp_path):
    """Without a card the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = parse_config(_config_text(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(cfg)
    path = tmp_path / "cfg.rendertron"
    path.write_text(_config_text(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([str(path)])


def test_port_never_imports_jax(tmp_path):
    """The port parses a config with its own parser and renders every
    integrator with both engines without importing jax or any module of
    the JAX package; so do samples per dispatch (models/batch.py), the
    keyed light walk (models/light_mega.py), the checks (utils/checks.py),
    the BDPT_DRAWPATH overlay (utils/debugviz.py), one classic sample
    on a traversal="threaded" scene (the threaded engine) and tile x spp
    sharding over CPU ranks (parallel/sharding.py: BDPT's splat, VCM's
    photon exchange). The renders are 16x12 on one intra-op thread: what
    is tested is the import graph."""
    code = f"""
import dataclasses, os, sys
import torch
torch.set_num_threads(1)
import cudapathtracer_tpu_torch
import cudapathtracer_tpu_torch.cli, cudapathtracer_tpu_torch.driver
import cudapathtracer_tpu_torch.models.batch
import cudapathtracer_tpu_torch.models.light_mega
import cudapathtracer_tpu_torch.parallel.sharding
import cudapathtracer_tpu_torch.utils.checks
import cudapathtracer_tpu_torch.utils.debugviz
from cudapathtracer_tpu_torch.utils.config import parse_config
from cudapathtracer_tpu_torch.driver import Renderer
for engine, integ in (("mega", "UNIDIRECTIONAL"),
                      ("classic", "UNIDIRECTIONAL"),
                      ("classic", "BIDIRECTIONAL"), ("classic", "VCM"),
                      ("classic", "SPPM"), ("mega", "BIDIRECTIONAL"),
                      ("mega", "VCM"), ("mega", "SPPM"),
                      ("mega", "NAIVE_UNIDIRECTIONAL")):
    cfg = parse_config({_config_text(tmp_path / 'r')!r}.replace(
        "Engine: classic", "Engine: " + engine).replace(
        "Integrator: UNIDIRECTIONAL", "Integrator: " + integ).replace(
        "width: 32", "width: 16").replace("height: 24", "height: 12"))
    assert (cfg.engine, cfg.integrator) == (engine, integ)
    r = Renderer(cfg, device="cpu")
    img = r.render(num_samples=1, progressive=False, verbose=False)
    assert img.pixels.shape == (12, 16, 3)
    assert r.metrics.rays_traced > 12 * 16
os.environ["TPT_MEGA_LIGHT"] = "1"
cudapathtracer_tpu_torch.utils.checks.enable_checks(True)
cfg = dataclasses.replace(cfg, integrator="BIDIRECTIONAL", width=8,
                          height=8, samples_per_dispatch=2,
                          bdpt_draw_path=True, save_interval_seconds=0.0)
r = Renderer(cfg, device="cpu")
r.render(num_samples=2, progressive=True, verbose=False)
assert r.checks.reports and r._overlay is not None
assert cudapathtracer_tpu_torch.models.light_mega.calls["light_walk_mega"]
import torch
from cudapathtracer_tpu_torch.models import unidirectional
from cudapathtracer_tpu_torch.scene import builtin
from cudapathtracer_tpu_torch.scene.camera import Camera
from cudapathtracer_tpu_torch.scene.materials import builtin_materials
from cudapathtracer_tpu_torch.scene.scene import build_scene
from cudapathtracer_tpu_torch.utils import rng
sc, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials(),
                    traversal="threaded", device="cpu")
px = torch.arange(8, dtype=torch.int32).repeat(8)
py = torch.arange(8, dtype=torch.int32).repeat_interleave(8)
li, rays = unidirectional.render_sample(
    sc, Camera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0),
    rng.base_key(), 0, px, py, max_depth=4)
assert sc.traversal == "threaded" and rays > 64 and li.shape == (64, 3)
from cudapathtracer_tpu_torch.models import bdpt, vcm
from cudapathtracer_tpu_torch.parallel import sharding
mesh = sharding.make_mesh(2, 1, devices=["cpu"] * 2)
cam = Camera.pinhole((0.0, 0.0, 1.0), 8, 8, 0.0, 0.0, 0.0, 60.0)
for fn, kw in ((bdpt.render_sample, dict(cfg=bdpt.BDPTConfig(3, 2))),
               (vcm.render_sample, dict(cfg=vcm.VCMConfig(3, 2),
                                        photon_axis="tile"))):
    acc, done, rays = sharding.render_sharded(fn, mesh, sc, cam, 8, 8, 1,
                                              splat=True, **kw)
    assert done == 1 and rays > 64 and acc.shape == (64, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "cudapathtracer_tpu"
             or m.startswith("cudapathtracer_tpu."))
assert not bad, bad
print("no-jax-ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no-jax-ok" in res.stdout
