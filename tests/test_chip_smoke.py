"""`chip_smoke.py` phases at tiny size on the host CPU, the four-device
paths on virtual CPU devices, and the refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda f: f.__name__)
def test_phase_passes_at_tiny_size(phase):
    ph = phase(chip_smoke.TINY)
    assert not ph.failures, ph.failures


@pytest.mark.parametrize("phase", chip_smoke.FOUR, ids=lambda f: f.__name__)
def test_four_device_phase_on_virtual_cpus(phase):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    ph = phase(chip_smoke.TINY, devices)
    assert not ph.failures, ph.failures


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu_backend(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_train_ops_parity_checks_every_gradient(capsys):
    """One card-vs-host check per gradient: conv (x, w, b), batch norm
    (x, scale, bias), ReLU, max pool and upsample (x)."""
    ph = chip_smoke.Phase("t")
    chip_smoke.train_ops_parity(ph, channels=4, side=8)
    out = capsys.readouterr().out
    assert out.count("rel_l2_vs_cpu") == 9, out
    assert not ph.failures, ph.failures


@pytest.mark.parametrize("scale, fails", [(1.0, False), (1.001, True)])
def test_parity_host_flags_a_difference(scale, fails):
    """The second call of `make` builds the host function: a relative
    difference of 1e-3 there must fail the check."""
    calls = []

    def make():
        calls.append(1)
        s = 1.0 if len(calls) == 1 else scale
        return lambda x, y: (x * s, {"y": y * s})

    ph = chip_smoke.Phase("t")
    chip_smoke.parity_host(ph, "k", make, jnp.ones(8), jnp.arange(4.0) + 1)
    assert len(ph.failures) == (2 if fails else 0), ph.failures


def test_script_alone_fails(tmp_path):
    """Without the rest of the repository the script exits non-zero and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
