"""Profiling: per-kernel device time and speed-of-light accounting.

Port of `bez_isaacgym_tpu/utils/profiling.py`: `torch.profiler` with the
CUDA activity in place of the JAX trace's xplane, CUDA events in place of
`block_until_ready` wall clocks.

    from bez_isaacgym_tpu_torch.utils.profiling import (measure_wall,
                                                        profile_fn, sol_report)
    ops = profile_fn(step_fn, args, iters=3)
    print(sol_report(measure_wall(step_fn, args), flops=..., bytes_moved=...,
                     top_ops=ops))
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile

# Peaks (f32 TFLOP/s outside the tensor cores, memory GB/s) by device
# name.  The H100 SXM's (reported as "NVIDIA H100 80GB HBM3") are NVIDIA's
# data-sheet figures: 67 TFLOPS FP32, 3.35 TB/s HBM3, at its 700 W limit.
CHIP_PEAKS = {
    "H100 80GB HBM3": (67.0, 3350.0),
    "cpu": (0.2, 50.0),
}


@dataclass
class OpTime:
    name: str
    total_ms: float
    count: int


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def profile_fn(fn, args, iters: int = 3) -> list[OpTime]:
    """Run fn(*args) `iters` times under torch.profiler after one warm-up
    call; returns each kernel's device ms and launches per iteration,
    largest first.  Without a card, each operator's CPU self time."""
    dev = _device_type()
    fn(*args)
    _sync(dev)
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn(*args)
        _sync(dev)
    ops = []
    for e in prof.key_averages():
        if dev == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        else:
            us = e.self_cpu_time_total
        if us > 0:
            ops.append(OpTime(e.key, us / 1e3 / iters, e.count // iters))
    return sorted(ops, key=lambda o: -o.total_ms)


def kernel_launches(fn, name: str):
    """fn() once under torch.profiler: (its result, the launches of the
    kernels whose name holds `name`).  On a card these are the device trace's
    kernels, so a CUDA graph's replays count; without one, the operators
    that ran on the CPU."""
    dev = _device_type()
    acts = [ProfilerActivity.CUDA if dev == "cuda" else ProfilerActivity.CPU]
    want = torch.autograd.DeviceType.CUDA if dev == "cuda" \
        else torch.autograd.DeviceType.CPU
    _sync(dev)
    with profile(activities=acts) as prof:
        out = fn()
        _sync(dev)
    # The raw events: a long call's millions of kernels would take minutes
    # and tens of GB as the profiler's parsed event tree.
    return out, sum(1 for e in prof.profiler.kineto_results.events()
                    if e.device_type() == want and name in e.name())


def measure_wall(fn, args, iters: int = 10) -> float:
    """Median seconds per call after a warm-up call: CUDA events around
    each call on a card, `time.perf_counter` on the CPU."""
    dev = _device_type()
    fn(*args)
    _sync(dev)
    times = []
    for _ in range(iters):
        if dev == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def chip_peaks() -> tuple[float, float]:
    """(f32 TFLOP/s, GB/s) of the current card by its name; the CPU entry
    without a card or for a card not in the table."""
    name = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return peaks
    return CHIP_PEAKS["cpu"]


def sol_report(wall_s: float, flops: float, bytes_moved: float,
               top_ops: list[OpTime] | None = None, top_n: int = 10) -> str:
    """Speed-of-light summary: achieved vs peak compute and bandwidth."""
    peak_tflops, peak_gbs = chip_peaks()
    achieved_tflops = flops / wall_s / 1e12
    achieved_gbs = bytes_moved / wall_s / 1e9
    lines = [
        f"wall: {wall_s * 1e3:.3f} ms",
        f"compute: {achieved_tflops:.3f} TFLOP/s "
        f"({100 * achieved_tflops / peak_tflops:.1f}% of {peak_tflops} peak)",
        f"bandwidth: {achieved_gbs:.1f} GB/s "
        f"({100 * achieved_gbs / peak_gbs:.1f}% of {peak_gbs} peak)",
    ]
    if top_ops:
        lines.append("top ops (device ms/iter):")
        for o in top_ops[:top_n]:
            lines.append(f"  {o.total_ms:8.3f} ms x{o.count:3d}  {o.name[:90]}")
    return "\n".join(lines)
