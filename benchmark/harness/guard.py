"""What a run must hold to: a card for each chip the cell asks for, and no
JAX in the process that prints the result."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "zinc_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, the whole name compared: ``zinc_tpu_torch`` is not
    ``zinc_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def cards(chips: int) -> str | None:
    """None when ``chips`` CUDA cards are there; else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}"
    return None


def card_info(device: str = "cuda") -> dict:
    """Name, power limit and maximum SM clock of the card (the last two from
    nvidia-smi, which lists every card of the host: chosen by the UUID)."""
    import torch

    uuid = torch.cuda.get_device_properties(torch.device(device)).uuid
    out = subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    power, clock = (float(x) for x in out.split(","))
    return {"name": torch.cuda.get_device_name(torch.device(device)), "power_limit_w": power,
            "max_sm_mhz": clock}
