"""The numerical checks of the PyTorch port (utils/checks.py), mirroring
tests/test_checks.py, and their wiring: the switch read under the JAX
package's name, the progressive saves' scans and the CLI's summary line.
Counts are exact (no tolerance)."""

import importlib

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch import cli
from cudapathtracer_tpu_torch.utils import checks
from test_torch_common import _one_thread  # noqa: F401  (autouse)


def test_checks_disabled_by_default():
    log = checks.CheckLog()
    checks.enable_checks(False)
    assert log.check("s", np.array([np.nan])) is None
    assert "disabled" in log.summary()


def test_checks_detect_nan_inf():
    checks.enable_checks(True)
    try:
        log = checks.CheckLog()
        r = log.check("good", np.ones(4))
        assert r.ok
        r = log.check("bad", np.array([1.0, np.nan, np.inf]))
        assert not r.ok and r.nan == 1 and r.inf == 1
        r = log.check("tensor", torch.tensor([[-1.0, np.inf], [2.0, 3.0]]),
                      torch.tensor([4, -5]), allow_negative=False)
        assert (r.nan, r.inf, r.negative) == (0, 1, 1)
        assert "STAGE ERROR bad" in log.summary()
        with pytest.raises(FloatingPointError):
            log.check("worse", np.array([np.nan]), raise_on_error=True)
    finally:
        checks.enable_checks(False)


@pytest.mark.parametrize("value,on", [("1", True), ("0", False),
                                      ("", False)])
def test_switch_read_under_jax_name(monkeypatch, value, on):
    monkeypatch.setenv("CUDAPATHTRACER_TPU_CHECKS", value)
    try:
        assert importlib.reload(checks).checks_enabled() is on
    finally:
        monkeypatch.delenv("CUDAPATHTRACER_TPU_CHECKS")
        importlib.reload(checks)
    assert not checks.checks_enabled()


def test_cli_prints_checks_summary(tmp_path, capsys):
    cfg = tmp_path / "tiny.rendertron"
    cfg.write_text(f"""Name: tiny
width: 16
height: 12
Integrator: UNIDIRECTIONAL
Sample Count: 3
Unidirectional Max Depth: 3
Save Interval Seconds: 0
Output Dir: {tmp_path / 'renders'}
Meshes (path; multiplier * emission; materialID):
builtin:cornell_blocks; 1.0 * (0.0, 0.0, 0.0); 2
""")
    assert cli.main([str(cfg), "--device", "cpu"]) == 0
    assert "checks disabled (set CUDAPATHTRACER_TPU_CHECKS=1)" in \
        capsys.readouterr().out
    checks.enable_checks(True)
    try:
        assert cli.main([str(cfg), "--device", "cpu",
                         "--samples-per-dispatch", "2"]) == 0
    finally:
        checks.enable_checks(False)
    out = capsys.readouterr().out
    # a progressive save (and its check) after each of the two batches
    assert "render executed with no numerical errors (2 stages checked)" \
        in out
