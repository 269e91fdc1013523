"""Driver and CLI of the PyTorch port, on the CPU (--device cpu).

No float tolerance here: these tests check the product surface — a real
BMP from the CLI, exact checkpoint resume, refusal of what is not ported,
no JAX import, and that the CPU path launches no kernel."""

import os
import subprocess
import sys

import pytest
import torch

from cudapathtracer_tpu.utils.config import parse_config
from cudapathtracer_tpu_torch import cli, kernels
from cudapathtracer_tpu_torch.driver import Renderer
from cudapathtracer_tpu_torch.utils.image import load_bmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_text(out_dir, engine="classic", integrator="UNIDIRECTIONAL"):
    return f"""Name: tiny
width: 32
height: 24
Integrator: {integrator}
Engine: {engine}
Sample Count: 2
Unidirectional Max Depth: 4
Pinhole Camera: true
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
    ("mega", "UNIDIRECTIONAL"), ("classic", "BIDIRECTIONAL"),
    ("classic", "NAIVE_UNIDIRECTIONAL"), ("classic", "VCM"),
    ("mega", "SPPM")])
def test_unported_raise(tmp_path, engine, integrator):
    cfg = parse_config(_config_text(tmp_path, engine, integrator))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(cfg, device="cpu")
    path = tmp_path / "cfg.rendertron"
    path.write_text(_config_text(tmp_path, engine, integrator))
    with pytest.raises(NotImplementedError):
        cli.main([str(path), "--device", "cpu"])


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
    code = f"""
import sys
import cudapathtracer_tpu_torch
import cudapathtracer_tpu_torch.cli, cudapathtracer_tpu_torch.driver
from cudapathtracer_tpu.utils.config import parse_config
from cudapathtracer_tpu_torch.driver import Renderer
cfg = parse_config({_config_text(tmp_path / 'r')!r})
r = Renderer(cfg, device="cpu")
img = r.render(num_samples=1, progressive=False, verbose=False)
assert img.pixels.shape == (24, 32, 3)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("no-jax-ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no-jax-ok" in res.stdout
