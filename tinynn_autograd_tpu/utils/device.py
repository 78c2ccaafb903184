"""Which device a measurement ran on, for the scripts that measure.

Every timing the benchmarks and chip_smoke.py print carries the JAX
platform, device kind and count, plus the card's name and power limit as
``nvidia-smi`` reports them — a card set below its maximum power runs
slower under load, so a number without its limit cannot be compared.
"""

import subprocess

import jax


def card_line():
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, read
    in a child process (it does not import JAX, so it does not contend for
    the card). "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "not available"


def describe():
    """{"platform", "device_kind", "device_count", "card"} of this
    process's devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": card_line()}


def require_gpu():
    """The device description, or RuntimeError when JAX finds no GPU: a
    measurement never falls back to the CPU."""
    info = describe()
    if info["platform"] != "gpu":
        raise RuntimeError(
            "no GPU: JAX's first device is %r (%s); this script measures "
            "the accelerator and does not run on the host"
            % (info["platform"], info["device_kind"]))
    return info
