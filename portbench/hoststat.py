"""What the host did over the window, printed on an earlier line of every
run so that a run's speed can be set beside it: the CPU the process ran on
and its affinity, the machine's load, the share of the machine's CPU time
that its hypervisor stole, the process's own CPU time, the CPU's clock, the
time a fixed piece of pure Python takes on this host (taken after the
window, so that no metric pays for it), and the device memory segments the
caching allocator had to allocate.  Nothing
here is a metric.  Files that a machine lacks read as absent."""

from __future__ import annotations

import os
import time


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _machine_jiffies() -> list[int]:
    """user nice system idle iowait irq softirq steal, from /proc/stat."""
    for line in _read("/proc/stat").splitlines():
        if line.startswith("cpu "):
            return [int(x) for x in line.split()[1:9]]
    return []


def _cpu_now() -> int | None:
    fields = _read("/proc/self/stat").rsplit(")", 1)[-1].split()
    return int(fields[36]) if len(fields) > 36 else None


def _mhz(cpu: int | None) -> str:
    if cpu is None:
        return "?"
    n = -1
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("processor"):
            n = int(line.split(":")[1])
        elif line.startswith("cpu MHz") and n == cpu:
            return line.split(":")[1].strip()
    return "?"


def _device_allocs() -> int | None:
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(0).get("num_device_alloc")


def probe_ms() -> float:
    """The least of three timings of a fixed pure-Python loop: the host's
    speed for single-threaded work such as launching kernels."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(300_000):
            x += i * i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def sample() -> dict:
    t = os.times()
    return {"wall": time.perf_counter(), "proc": t.user + t.system,
            "jiffies": _machine_jiffies(), "allocs": _device_allocs()}


def line(a: dict, b: dict) -> str:
    """The host's line for the stretch from sample `a` to sample `b`."""
    cpu = _cpu_now()
    aff = sorted(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else []
    d = [y - x for x, y in zip(a["jiffies"], b["jiffies"])]
    total = sum(d)
    steal = d[7] / total if total and len(d) > 7 else float("nan")
    busy = 1 - (d[3] + d[4]) / total if total else float("nan")
    wall = b["wall"] - a["wall"]
    allocs = None if a["allocs"] is None else b["allocs"] - a["allocs"]
    return (f"host: probe {probe_ms()} ms; cpu {cpu} of {len(aff)} "
            f"allowed; loadavg "
            f"{_read('/proc/loadavg').split()[:3]}; machine busy {busy}, "
            f"steal {steal}; process CPU {(b['proc'] - a['proc']) / wall} "
            f"of the wall; cpu MHz {_mhz(cpu)}; device segments allocated "
            f"in the window {allocs}")
