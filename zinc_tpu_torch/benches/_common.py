"""What the bench mirrors share: their arguments, the line that names the
device they ran on, the per-call timer and the JSON metric lines.

Every mirror runs on the card unless it is passed ``cpu``; asked for the
card where torch sees none, it raises instead of falling back, so a number
from the CPU never stands under a device metric's name without the header
line that says ``cpu``.
"""

from __future__ import annotations

import json
import os
import platform
import time


def parse(argv: list[str], cuda_sizes: list[int], cpu_sizes: list[int]) -> tuple[list[int], str]:
    """``[log_n ...] [device]`` → (sizes, device): the device is ``cuda``
    unless another is named; with no sizes, ``cuda_sizes`` on the card and
    ``cpu_sizes`` elsewhere."""
    sizes = [int(a) for a in argv if a.isdigit()]
    named = [a for a in argv if not a.isdigit()]
    if len(named) > 1:
        raise SystemExit(f"expected [log_n ...] [device], got {argv}")
    device = named[0] if named else "cuda"
    return sizes or (cuda_sizes if is_cuda(device) else cpu_sizes), device


def parse_one(argv: list[str], cuda_size: int, cpu_size: int) -> tuple[int, str]:
    """``[log_n] [device]`` → (log_n, device), as :func:`parse` for a bench
    of one size; more than one size is refused."""
    sizes, device = parse(argv, [cuda_size], [cpu_size])
    if len(sizes) > 1:
        raise SystemExit(f"expected [log_n] [device], got {argv}")
    return sizes[0], device


def is_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def host_cpu() -> str:
    """The host's CPU model from ``/proc/cpuinfo``: its model name or, where
    the kernel hides it (``unknown``), its vendor, family and model numbers;
    then the count of CPUs the process sees."""
    info: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return platform.machine()
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', 'unknown vendor')} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return f"{name}, {os.cpu_count()} CPUs"


def device_line(device) -> str:
    """The line naming the device: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or ``cpu`` and the host's CPU model.  Raises SystemExit when the
    card is asked for and torch sees none."""
    import torch

    if not is_cuda(device):
        return f"device: cpu ({host_cpu()})"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass `cpu` as the device to run the plain versions")
    from .bench_kernels import smi_row

    return f"device: {smi_row(device, 'name,power.limit')}"


def sync(device) -> None:
    import torch

    if is_cuda(device):
        torch.cuda.synchronize(device)


def call_ms(fn, device, calls: int = 20) -> float:
    """Milliseconds a call of ``fn``: device-only on the card
    (``bench_kernels.device_ms``: the calls queued behind a sleeping kernel,
    CUDA events around them); on the CPU the host clock over ``calls``
    calls after a warm-up one."""
    if is_cuda(device):
        from .bench_kernels import device_ms

        return device_ms(fn, calls)
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def wall_s(fn, device):
    """(result, seconds) of one call of ``fn`` on the host clock, the
    device synced before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def emit(metric: str, value, unit: str, **extra) -> dict:
    """Print one JSON metric line, in the JAX benches' form, and return it."""
    record = {"metric": metric, "value": value, "unit": unit, **extra}
    print(json.dumps(record), flush=True)
    return record
