"""Time of one `BezTask.step_batch` (tasks/base.py, tasks/kick.py), inside
the rollout too: CUDA-event span, mean per call."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "step")
