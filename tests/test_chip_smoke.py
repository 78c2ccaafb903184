"""chip_smoke.py off the card: it refuses to run without a GPU (and
without the package beside it), and every phase runs end to end at tiny
sizes on the CPU — the kernels in interpret mode — so a wrong path,
argument or check shows here before the script reaches a card."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(_ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_without_the_package(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_phase_rejects_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device(1)


def test_check_raises_past_tolerance():
    chip_smoke.check("ok", 1e-6, 1e-5, "test")
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check("too big", 1e-3, 1e-5, "test")
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check("nan", float("nan"), 1e-5, "test")
    with pytest.raises(chip_smoke.PhaseError, match="decrease"):
        chip_smoke.require_decrease("flat", [[1.0, 1.0], [1.0, 1.0]])


def test_llama_phase_tiny():
    model, (x, y) = chip_smoke.phase_llama(chip_smoke.TINY["llama"])
    assert int(model._opt_state["t"]) == 3


def test_cells_phase_tiny():
    t = chip_smoke.TINY
    chip_smoke.phase_cells(t["cells"], t["cell_steps"], t["cell_epochs"])


def test_mnist_lstm_phase_tiny():
    t = chip_smoke.TINY
    chip_smoke.phase_mnist_lstm(t["mnist"], t["lstm"])


def test_kernels_phase_tiny():
    rows = chip_smoke.phase_kernels(chip_smoke.TINY,
                                    kernel_impl="pallas_interpret")
    shapes = [r["shape"] for r in rows]
    assert "llama" in shapes and "llama_train_step" in shapes
    assert "lstm_train_step" in shapes


def test_multichip_phase_on_four_cpu_devices():
    sizes = dict(llama=dict(vocab=64, dim=32, heads=8, depth=1, seq=16,
                            batch=8),
                 cp_seq=32, mlp_batch=32, moe_dim=16, pp_width=32, steps=2)
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multichip(4, sizes)
