"""Which accelerator a measurement runs on.

A time measured on the CPU backend says nothing about the GPU, so every
measurement entry point asks for a GPU here and names it in its output.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX found no GPU (or fewer than asked for)."""


def nvidia_smi() -> str:
    """The first card's name and power limit as nvidia-smi reports them,
    e.g. "NVIDIA H100 80GB HBM3, 700.00 W". Runs as a child process, so it
    never touches JAX or the card's memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def require_gpu(min_count: int = 1) -> dict:
    """Identity of the GPU(s) JAX will run on; raises NoGPUError when the
    first device is not a GPU or fewer than `min_count` are visible.

    Returns {"platform", "device_kind", "count", "gpu_name",
    "power_limit"}."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise NoGPUError(f"JAX's first device is {d.platform} "
                         f"({d.device_kind}), not a GPU")
    if len(devs) < min_count:
        raise NoGPUError(f"{min_count} GPUs needed, JAX sees {len(devs)}")
    name, _, limit = nvidia_smi().partition(",")
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(devs), "gpu_name": name.strip(),
            "power_limit": limit.strip()}
