"""Time of one `PpoPlayerContinuous.get_action` (rl/players.py): CUDA-event
span, mean per step."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "act")
