"""The profiler over a short steady slice of the traced run, read into
device time by kernel name, device busy time and the idle gaps.

The slice covers a few ticks (set by the traffic's `profile_ticks`), not the
window: a whole window would hold millions of events.  Nothing is written to
disk.  A gap in the device's timeline is labelled by the innermost
benchmark span (`portbench/spans.py`) open on the host when the device went
idle, or "driver" when none was.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


@dataclass
class Slice:
    ticks: int = 0                  # ticks the slice covered
    wall_s: float = 0.0             # their host time
    busy_s: float = 0.0             # union of the device's operations
    ops: dict = field(default_factory=dict)      # name -> (seconds, count)
    gaps: list = field(default_factory=list)     # (label, seconds)


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, ticks: int, wall_s: float) -> Slice:
    """Stop `prof` (the device synchronized first) and read it."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    events = prof.events()
    # The device's operations; the spans' `record_function` ranges also
    # show on the device's timeline, as annotations, and are left out.
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("span."))
    spans = [(e.time_range.start, e.time_range.end, e.name[len("span."):])
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("span.")]
    out = Slice(ticks=ticks, wall_s=wall_s)
    for t0, t1, name in dev:
        s, n = out.ops.get(name, (0.0, 0))
        out.ops[name] = (s + (t1 - t0) * 1e-6, n + 1)
    busy_us, end = 0.0, None
    for t0, t1, _ in dev:
        if end is not None and t0 > end:
            out.gaps.append((_label(spans, end), (t0 - end) * 1e-6))
        if end is None or t0 > end:
            busy_us += t1 - t0
            end = t1
        elif t1 > end:
            busy_us += t1 - end
            end = t1
    out.busy_s = busy_us * 1e-6
    return out


def _label(spans, t: float) -> str:
    """The innermost span open at time t (the latest started)."""
    open_ = [(t0, name) for t0, t1, name in spans if t0 <= t < t1]
    return max(open_)[1] if open_ else "driver"


def breakdown(sl: Slice) -> dict:
    """The result line's `breakdown`: the ten device operations that took
    most time and the ten longest idle gaps, in seconds."""
    ops = sorted(((n, s) for n, (s, _) in sl.ops.items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(sl.gaps, key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
