"""PPO training on the kick task: `PPO.train_iter` back to back, as
`Runner.train` calls it, over all envs from seed-made weights, with the
rollout's action noise and each mini-epoch's permutation drawn from the seed
per iteration and passed in, and the runner's one host read of the episode
count (and mean return) per iteration kept.

Set-up builds the one training object and drives it through its first
`warm_iterations` iterations; the window goes on with the same object.
Nothing wraps the program while it runs.  Around the set-up's iterations
and a sample of `check_iterations` of the window's (drawn from the seed) the
driver copies the training state, env state and observations before and
after, the generator state, the noise and the permutations.  Once the window
has closed, the program's own `PPO.rollout` replays each recorded iteration
from its copied start (its outputs must equal the window's) and gives the
rollout the reference follows: the set-up's iterations as one chain from the
seed-made weights, each sampled window iteration from the program's state.

Traffic keys: `envs`, `warm_iterations`, `check_iterations`, `check_steps`
(env steps per recorded iteration checked one by one), `profile_after`,
`profile_ticks`, `limits`.  Configuration keys: `substeps`, `horizon`,
`minibatch_size`, `mini_epochs`, `units` (the rest of the PPO spec is the
port's `PPOConfig` default, which the reference's copy shares).
"""

from __future__ import annotations

import math
import random
import statistics

import torch

from portbench import compare, inputs


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.N = traffic["envs"]
        self.work_per_tick = {"frames": self.N * config["horizon"]}

    def _ppo_config(self, cls):
        c = self.config
        return cls(horizon=c["horizon"], minibatch_size=c["minibatch_size"],
                   mini_epochs=c["mini_epochs"], units=tuple(c["units"]))

    def _weights(self, net) -> dict:
        """Seed-made initial weights, by the network's parameter names:
        LeCun-normal kernels in one draw, zero biases and log-std."""
        names = [k for k, v in net.named_parameters() if v.dim() == 2]
        shapes = [tuple(net.get_parameter(k).shape) for k in names]
        ws = inputs.lecun_mlp([(i, o) for o, i in shapes],
                              inputs.generator(self.seed, "weights",
                                               self.device), self.device)
        out = {k: torch.zeros_like(v) for k, v in net.named_parameters()}
        out.update(dict(zip(names, ws)))
        return out

    def setup(self) -> None:
        from bez_isaacgym_tpu_torch.rl.ppo import PPO, PPOConfig
        from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
        from bez_isaacgym_tpu_torch.tasks.kick import KickTask

        dev = self.device
        self.task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                             device=dev)
        self.ppo = PPO(self.task, self.N, self._ppo_config(PPOConfig))
        ts = self.ppo.init(inputs.generator(self.seed, "init", dev))
        self.ts = ts._replace(params=self._weights(self.ppo.net))
        self.gen = inputs.generator(self.seed, "reset", dev)
        self.noise_gen = inputs.generator(self.seed, "rollout_noise", dev)
        self.perm_gen = inputs.generator(self.seed, "perms", dev)
        env = self.task.reset(self.gen, self.N)
        zero = torch.zeros((self.N, self.task.num_actions), device=dev)
        self.obs, self.env = self.task.observe(env, zero)
        self.start = compare.snapshot((self.env, self.obs))
        self.done = 0
        self.warm = [None] * self.traffic["warm_iterations"]
        for k in range(len(self.warm)):
            self._iterate(*self._draws(), self.warm, k)
        self.sampler = inputs.Sampler(self.traffic["check_iterations"],
                                      self.seed)
        self.replays = None

    def _draws(self):
        H, A = self.config["horizon"], self.task.num_actions
        noise = torch.randn((H, self.N, A), generator=self.noise_gen,
                            device=self.device)
        perms = torch.stack([
            torch.randperm(H * self.N, generator=self.perm_gen,
                           device=self.device)
            for _ in range(self.config["mini_epochs"])])
        return noise, perms

    def _iterate(self, noise, perms, into=None, at=None) -> None:
        """One iteration; with `into`, its record goes to `into[at]`."""
        rec = None
        if into is not None:
            rec = {"index": self.done, **compare.snapshot({
                "pre": (self.ts, self.env, self.obs),
                "gen_state": self.gen.get_state(), "noise": noise,
                "perms": perms})}
        self.ts, self.env, self.obs, self.metrics = self.ppo.train_iter(
            self.ts, self.env, self.obs, self.gen, noise=noise, perms=perms)
        # The runner's host read per iteration (rl/runner.py::train).
        if float(self.metrics["ep_count"]) > 0:
            float(self.metrics["ep_reward_mean"])
        self.done += 1
        if rec is not None:
            rec.update(compare.snapshot({
                "post": (self.ts, self.env, self.obs),
                "loss": self.metrics["loss"]}))
            into[at] = rec

    def tick(self, i: int) -> None:
        slot = self.sampler.slot(i)
        self._iterate(*self._draws(),
                      None if slot is None else self.sampler.records, slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def instrument(self, spans) -> None:
        spans.wrap(self.ppo, "rollout", "rollout")
        spans.wrap(self.ppo, "update", "update")
        spans.wrap(self.task, "step_batch", "step")

    def substep_envs_per_tick(self) -> int:
        c = self.config
        return c["substeps"] * c["horizon"] * self.N

    def free(self) -> None:
        """Frees the training state; the replays still need the program's
        objects, and `check` frees those."""
        self.ts = self.env = self.obs = self.metrics = None

    # ------------------------------------------------------------ the check
    def _records(self) -> list[list[dict]]:
        """The recorded iterations in the segments the reference follows:
        the set-up's as one chain, then each sampled window iteration."""
        return [self.warm] + [[r] for r in self.sampler.kept()]

    def _replay(self, rec: dict, wanted: set) -> dict:
        """The program's rollout from the record's copied start, with the
        env steps at the indices in `wanted` recorded."""
        steps, seen = [], [0]
        step_batch = self.task.step_batch

        def rec_step(state, actions, gen):
            keep = seen[0] in wanted
            pre = compare.snapshot({"env": state, "actions": actions,
                                    "gen_state": gen.get_state()}) \
                if keep else None
            out = step_batch(state, actions, gen)
            if keep:
                steps.append({**pre, "out": compare.snapshot(out)})
            seen[0] += 1
            return out

        ts, env, obs = rec["pre"]
        self.task.step_batch = rec_step
        try:
            env_r, obs_r, traj = self.ppo.rollout(
                ts, env, obs, compare.generator_at(rec["gen_state"],
                                                   self.device),
                rec["noise"])
        finally:
            del self.task.step_batch
        _, env_w, obs_w = rec["post"]
        gap = max([compare.max_abs(obs_r, obs_w)] + [
            compare.max_abs(x, y) for x, y in zip(
                _leaves(env_r), _leaves(env_w))])
        return {"traj": compare.snapshot(traj), "last_obs": obs_r,
                "steps": steps, "replay_gap": gap}

    def _replays(self) -> list[list[dict]]:
        """Each record's replay (once), then the program's objects freed."""
        if self.replays is None:
            pick = random.Random(inputs.subseed(self.seed, "check_steps"))
            H, k = self.config["horizon"], self.traffic["check_steps"]
            self.replays = [[self._replay(r, set(pick.sample(range(H), k)))
                             for r in seg] for seg in self._records()]
            self.ppo = self.task = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return self.replays

    def _reference(self):
        from portbench.reference.rl.ppo import PPO, PPOConfig
        from portbench.reference.tasks.base import TaskConfig
        from portbench.reference.tasks.kick import KickTask

        task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                        device=self.device)
        return task, PPO(task, self.N, self._ppo_config(PPOConfig))

    @staticmethod
    def _ref_state(ts):
        """The program's TrainState as the reference's (fields by name)."""
        from portbench.reference.rl.networks import RunningMeanStd
        from portbench.reference.rl.ppo import AdamState, TrainState

        o = ts.opt_state
        return TrainState(**{
            **ts._asdict(), "params": dict(ts.params),
            "opt_state": AdamState(count=o.count, mu=dict(o.mu),
                                   nu=dict(o.nu)),
            "obs_rms": RunningMeanStd(**ts.obs_rms._asdict()),
            "value_rms": RunningMeanStd(**ts.value_rms._asdict())})

    def chain(self, ppo, seg: list[dict], reps: list[dict], tf32: bool,
              perturb: float = 0.0):
        """The reference's training through a segment of recorded
        iterations from the program's state at its start, each iteration on
        the program's replayed rollout (its observations, rewards and
        episode ends) with the record's noise and permutations: per
        iteration the rollout's actions and the loss, the state after the
        first and after the last.  `perturb` scales the noise by 1 plus that
        relative amount at random (a change of rounding size, for
        `calibrate.py --perturb`)."""
        from portbench.reference.rl.networks import gaussian_logp
        from portbench.reference.rl.ppo import Transition

        ts = self._ref_state(seg[0]["pre"][0])
        out = {"actions": [], "loss": []}
        with compare.precision(tf32):
            for k, (rec, rp) in enumerate(zip(seg, reps)):
                traj = Transition(**rp["traj"]._asdict())
                noise = rec["noise"]
                if perturb:
                    noise = noise * (1 + perturb * torch.randn(
                        noise.shape, device=noise.device,
                        generator=inputs.generator(self.seed, "perturb",
                                                   noise.device)))
                with torch.no_grad():
                    mu, log_std, value = ppo._apply(ts.params, ts.obs_rms,
                                                    traj.obs)
                    action = mu + torch.exp(log_std) * noise
                traj = traj._replace(action=action, mu=mu, log_std=log_std,
                                     value=value, logp=gaussian_logp(
                                         mu, log_std, action))
                ts = ppo._update_obs_rms(ts, traj)
                adv, ret = ppo.compute_gae(ts, traj, rp["last_obs"])
                flat = Transition(*[x.reshape((-1,) + x.shape[2:])
                                    for x in traj])
                ts, m = ppo.update(ts, flat, adv.reshape(-1),
                                   ret.reshape(-1), perms=rec["perms"])
                out["actions"].append(action)
                out["loss"].append(m["loss"])
                if k == 0:
                    out["first"] = ts
        out["last"] = ts
        return out

    @staticmethod
    def program(seg: list[dict], reps: list[dict]) -> dict:
        return {"actions": [rp["traj"].action for rp in reps],
                "loss": [rec["loss"] for rec in seg],
                "first": seg[0]["post"][0], "last": seg[-1]["post"][0]}

    def judge_chain(self, seg: list[dict], got: dict, ref: dict,
                    prefix: str = "") -> dict:
        """Gaps of a segment's training against the reference's: actions;
        each iteration's loss (relative); the change of Adam's first moment
        over the first iteration and the weights' change over the segment,
        each a leaf's gap of norms against the larger of the reference's
        norm of that leaf and of the median leaf, worst leaf; Adam's step
        count and the epoch, exact (before the segment against the
        iterations done, after it against the reference's).  The loss,
        moment and change gaps carry `prefix` in their names."""
        def norms(d):
            return {k: float(torch.linalg.norm(v.float()))
                    for k, v in d.items()}

        start = seg[0]["pre"][0]
        gaps = {"action_gap": max(compare.max_abs(a, b) for a, b in
                                  zip(got["actions"], ref["actions"])),
                prefix + "loss_gap": max(
                    abs(float(a) - float(b)) / abs(float(b))
                    if math.isfinite(float(a)) else math.inf
                    for a, b in zip(got["loss"], ref["loss"]))}
        mu0 = start.opt_state.mu
        g_got = norms({k: v - mu0[k]
                       for k, v in got["first"].opt_state.mu.items()})
        g_ref = norms({k: v - mu0[k]
                       for k, v in ref["first"].opt_state.mu.items()})
        g_med = statistics.median(g_ref.values())
        gaps[prefix + "grad_gap"] = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med)
                               for k in g_ref)
        # Leaves the reference barely moves by its gradient (under a
        # thousandth of the median leaf's) move under Adam by rounding
        # alone, and are left out of the change.
        kept = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
        p0 = start.params
        d_got = norms({k: got["last"].params[k] - p0[k] for k in kept})
        d_ref = norms({k: ref["last"].params[k] - p0[k] for k in kept})
        d_med = statistics.median(d_ref.values())
        gaps[prefix + "change_gap"] = max(
            abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in kept)
        gaps["left_out_leaves"] = float(len(g_ref) - len(kept))
        c = self.config
        per_iter = c["mini_epochs"] * max(
            1, c["horizon"] * self.N // c["minibatch_size"])
        n = seg[0]["index"]
        gaps["count_gap"] = float(max(
            abs(int(start.opt_state.count) - n * per_iter),
            abs(int(start.epoch) - n),
            abs(int(got["last"].opt_state.count)
                - int(ref["last"].opt_state.count)),
            abs(int(got["last"].epoch) - int(ref["last"].epoch))))
        return {k: (math.inf if v != v else v) for k, v in gaps.items()}

    def start_gap(self, ref) -> dict:
        task = ref[0]
        r = task.reset(inputs.generator(self.seed, "reset", self.device),
                       self.N)
        zero = torch.zeros((self.N, task.num_actions), device=self.device)
        r_obs, r = task.observe(r, zero)
        p, p_obs = compare.env_state(self.start[0]), self.start[1]
        return {"start_gap": max(
            [compare.max_abs(p_obs, r_obs)] + [
                compare.max_abs(x, y) for x, y in zip(
                    list(p.physics) + list(p.dyn),
                    list(r.physics) + list(r.dyn)) if x is not None])}

    def check(self, control: bool = False,
              perturb: float = 0.0) -> list[dict]:
        """Rows of gaps: the start's; per segment, its training's (the
        window's iterations under names that start `window_`) and its
        checked steps'.  With `perturb` the reference with its noise
        perturbed stands in the program's place (`chain`)."""
        replays = self._replays()
        task, ppo = ref = self._reference()
        rows = [self.start_gap(ref)]
        for n, (seg, reps) in enumerate(zip(self._records(), replays)):
            if not seg:
                continue
            reference = self.chain(ppo, seg, reps, tf32=False)
            if control or perturb:
                got = self.chain(ppo, seg, reps, tf32=control,
                                 perturb=perturb)
            else:
                got = self.program(seg, reps)
            rows.append({**self.judge_chain(seg, got, reference,
                                            "window_" if n else ""),
                         "replay_gap": 0.0 if control else
                         max(rp["replay_gap"] for rp in reps)})
            for rp in reps:
                for rec in rp["steps"]:
                    env = compare.env_state(rec["env"])
                    if control:
                        out, _ = compare.ref_step(task, env, rec["actions"],
                                                  rec["gen_state"], tf32=True)
                        rec = {**rec, "out": out}
                    ref_out, margins = compare.ref_step(
                        task, env, rec["actions"], rec["gen_state"],
                        tf32=False)
                    rows.append(compare.step_gaps(ref_out, margins,
                                                  rec["out"]))
        return rows


def _leaves(x) -> list:
    """The tensors of a (nested) NamedTuple, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    return [t for v in x for t in _leaves(v)]
