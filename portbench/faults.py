"""Faults planted in the timed path, for the checks that `correct` comes out
false: each takes `patch(obj, name, value)` (`setattr`, or pytest's
`monkeypatch.setattr`) and breaks one thing underneath a run.

`tests/test_portbench_faults.py` runs them on the CPU at a tiny size;
`calibrate.py --fault <name>` reads them on the card at a cell's own size.
"""

import torch

from bez_isaacgym_tpu_torch.rl import ppo as port_ppo
from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous
from bez_isaacgym_tpu_torch.solvers.mppi import MPPISolver
from bez_isaacgym_tpu_torch.tasks.base import BezTask


def step_unchanged(patch):
    """A step that returns its state unchanged."""
    step = BezTask.step_batch

    def fault(self, states, actions, gen):
        out = step(self, states, actions, gen)
        return out._replace(state=out.state._replace(
            physics=states.physics))

    patch(BezTask, "step_batch", fault)


def step_half_the_envs(patch):
    """Half of the batch left out: the second half of the envs not
    stepped."""
    step = BezTask.step_batch

    def fault(self, states, actions, gen):
        out = step(self, states, actions, gen)
        n = actions.shape[0] // 2
        ph = type(states.physics)(*[
            torch.cat([a[:n], b[n:]]) for a, b in
            zip(out.state.physics, states.physics)])
        return out._replace(state=out.state._replace(physics=ph))

    patch(BezTask, "step_batch", fault)


def step_one_env(patch):
    """A fault confined to one env: the last env of the batch not
    stepped."""
    step = BezTask.step_batch

    def fault(self, states, actions, gen):
        out = step(self, states, actions, gen)
        ph = type(states.physics)(*[
            torch.cat([a[:-1], b[-1:]]) for a, b in
            zip(out.state.physics, states.physics)])
        return out._replace(state=out.state._replace(physics=ph))

    patch(BezTask, "step_batch", fault)


def reward_altered(patch):
    """An answer altered where it is produced: the step's reward."""
    step = BezTask.step_batch

    def fault(self, states, actions, gen):
        out = step(self, states, actions, gen)
        return out._replace(reward=out.reward + 0.05)

    patch(BezTask, "step_batch", fault)


def mppi_half_the_samples(patch):
    """Half of the batch left out: the second half of each solve's samples
    out of the weighted mean."""
    scores = MPPISolver._rollout_scores

    def fault(self, env_states, seqs, absolute=None):
        total, stab = scores(self, env_states, seqs, absolute)
        K = self.cfg.num_samples
        t = total.reshape(-1, K).clone()
        t[:, K // 2:] = -torch.inf
        return t.reshape(-1), stab

    patch(MPPISolver, "_rollout_scores", fault)


def mppi_actions_altered(patch):
    """An answer altered where it is produced: the solve's actions."""
    solve = MPPISolver.solve

    def fault(self, *a, **k):
        actions, state, info = solve(self, *a, **k)
        return actions + 0.05, state, info

    patch(MPPISolver, "solve", fault)


def act_altered(patch):
    """An answer altered where it is produced: the served action."""
    act = PpoPlayerContinuous.get_action

    def fault(self, *a, **k):
        return act(self, *a, **k) + 0.05

    patch(PpoPlayerContinuous, "get_action", fault)


def update_unchanged(patch):
    """A training step that returns its state unchanged."""
    update = port_ppo.PPO.update

    def fault(self, ts, *a, **k):
        _, metrics = update(self, ts, *a, **k)
        return ts, metrics

    patch(port_ppo.PPO, "update", fault)


def update_unchanged_after_setup(patch):
    """A training step that returns its state unchanged once the set-up's 3
    iterations are done: a fault only the window's iterations show."""
    update = port_ppo.PPO.update
    calls = [0]

    def fault(self, ts, *a, **k):
        calls[0] += 1
        new, metrics = update(self, ts, *a, **k)
        return (ts if calls[0] > 3 else new), metrics

    patch(port_ppo.PPO, "update", fault)


def loss_half_the_batch(patch):
    """Half of the batch left out: each minibatch's loss the mean over its
    first half of rows."""
    loss = port_ppo.ppo_loss

    def fault(cfg, *cols):
        n = cols[0].shape[0] // 2
        return loss(cfg, *[c[:n] for c in cols])

    patch(port_ppo, "ppo_loss", fault)


FAULTS = {
    "kick_mppi.tick_s64": [step_unchanged, step_half_the_envs, step_one_env,
                           mppi_half_the_samples, mppi_actions_altered],
    "kick_mppi.tick_s256": [step_unchanged, step_one_env,
                            mppi_actions_altered],
    "kick_ppo.serve_64": [step_unchanged, step_half_the_envs, step_one_env,
                          act_altered, reward_altered],
    "kick_ppo.train_4096": [update_unchanged, update_unchanged_after_setup,
                            loss_half_the_batch, step_unchanged,
                            reward_altered],
}
