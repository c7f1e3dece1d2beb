"""What the per-layer metric readers (`portbench/metrics/<metric>.py`)
share: a span's mean, the substep kernel's share of its least time, the
device's idle share.  Each returns None where the run has nothing to read,
and the harness then leaves the metric out of the line."""

from __future__ import annotations

import statistics

from portbench import roofline
from portbench.peaks import peaks

# The substep kernel's name in the device trace (csrc/substep.cu).
SUBSTEP_KERNEL = "bez_substep_kernel"


def span_mean(run, name: str) -> float | None:
    """Mean ms of `name`'s calls over the window's unprofiled ticks."""
    ms = run.spans.ms(name)
    return statistics.fmean(ms) if ms else None


def substep_roofline(run) -> float | None:
    """The least time of the slice's substep work (the env-substeps its
    ticks ran, by the frozen byte and operation counts over the card's
    published peaks) over the profiled device time of the substep kernel,
    in %."""
    sl, pk = run.slice, peaks(run.device_name)
    if sl is None or pk is None:
        return None
    dev_s = sum(s for name, (s, _) in sl.ops.items()
                if SUBSTEP_KERNEL in name)
    if dev_s <= 0:
        return None
    from portbench.reference.models.bez import load_bez_model
    from portbench.reference.ops.engine import SceneConfig

    c = run.cell["config"]
    envs = run.driver.substep_envs_per_tick() * sl.ticks
    b = roofline.launch_bound(load_bez_model(c["robot"]),
                              SceneConfig(substeps=c["substeps"],
                                          has_ball=c["ball"]), envs, pk)
    return 100.0 * b.ms * 1e-3 / dev_s


def idle_share(run) -> float | None:
    """1 - the slice's device busy time per tick over the mean host time
    per tick of the run's unprofiled ticks, in %."""
    sl, ticks = run.slice, run.unprofiled_tick_s()
    if sl is None or not sl.ticks or not ticks:
        return None
    return 100.0 * (1.0 - (sl.busy_s / sl.ticks) / statistics.fmean(ticks))
