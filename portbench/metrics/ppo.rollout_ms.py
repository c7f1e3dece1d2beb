"""Time of one `PPO.rollout` (rl/ppo.py): CUDA-event span, mean per
iteration."""

from portbench.readings import span_mean


def read(run):
    return span_mean(run, "rollout")
