"""The trained kick policy served in closed loop: per tick one
`PpoPlayerContinuous.get_action(obs, deterministic=True)` over all envs,
then one `KickTask.step_batch` with its actions (episodes end and reset
inside the step), ending synchronized.  The policy is the repository's
`runs/Bez_Kick/Bez_Kick_best.ckpt`, which the reference reads itself.

Traffic keys: `envs`, `warm_ticks`, `check_ticks`, `profile_after`,
`profile_ticks`, `limits`.  Configuration keys: `substeps`, `units`,
`checkpoint` (relative to the checkout's root).
"""

from __future__ import annotations

import torch

from portbench import compare, inputs
from portbench.harness import ROOT


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.N = traffic["envs"]
        self.work_per_tick = {"frames": self.N}
        self.checkpoint = str(ROOT / config["checkpoint"])

    def setup(self) -> None:
        from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous
        from bez_isaacgym_tpu_torch.rl.ppo import PPOConfig
        from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
        from bez_isaacgym_tpu_torch.tasks.kick import KickTask

        dev = self.device
        self.task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                             device=dev)
        self.player = PpoPlayerContinuous(
            self.task, PPOConfig(units=tuple(self.config["units"])),
            checkpoint_path=self.checkpoint, device=dev)
        self.gen = inputs.generator(self.seed, "reset", dev)
        self.env = self.task.reset(self.gen, self.N)
        zero = torch.zeros((self.N, self.task.num_actions), device=dev)
        self.obs, self.env = self.task.observe(self.env, zero)
        self.start = compare.snapshot((self.env, self.obs))
        self.sampler = None
        for _ in range(self.traffic["warm_ticks"]):
            self._tick(None)
        self.sampler = inputs.Sampler(self.traffic["check_ticks"], self.seed)

    def _tick(self, slot) -> None:
        rec = None if slot is None else compare.snapshot({
            "env": self.env, "obs": self.obs,
            "gen_state": self.gen.get_state()})
        actions = self.player.get_action(self.obs, deterministic=True)
        out = self.task.step_batch(self.env, actions, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if rec is not None:
            self.sampler.records[slot] = {**rec, **compare.snapshot({
                "actions": actions, "out": out})}
        self.env, self.obs = out.state, out.obs

    def tick(self, i: int) -> None:
        self._tick(self.sampler.slot(i))

    def instrument(self, spans) -> None:
        spans.wrap(self.player, "get_action", "act")
        spans.wrap(self.task, "step_batch", "step")

    def substep_envs_per_tick(self) -> int:
        return self.config["substeps"] * self.N

    def free(self) -> None:
        self.env = self.obs = self.player = self.task = None

    # ------------------------------------------------------------ the check
    def _reference(self):
        from portbench.reference.checkpoint import actor_critic_state
        from portbench.reference.rl.networks import ActorCritic
        from portbench.reference.tasks.base import TaskConfig
        from portbench.reference.tasks.kick import KickTask

        task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                        device=self.device)
        sd, rms = actor_critic_state(self.checkpoint, self.device)
        net = ActorCritic(task.num_obs, task.num_actions,
                          tuple(self.config["units"])).to(self.device)
        net.load_state_dict(sd)
        return task, net, rms

    @staticmethod
    def _act(ref, obs, tf32: bool):
        from portbench.reference.rl.networks import ACTION_LIMIT

        _, net, rms = ref
        with torch.no_grad(), compare.precision(tf32):
            mu = net(rms.normalize(obs))[0]
        return ACTION_LIMIT * mu.clamp(-1.0, 1.0)

    def control(self, rec: dict, ref) -> dict:
        a = self._act(ref, rec["obs"], tf32=True)
        out, _ = compare.ref_step(ref[0], compare.env_state(rec["env"]), a,
                                  rec["gen_state"], tf32=True)
        return {**rec, "actions": a, "out": out}

    def judge(self, rec: dict, ref) -> dict:
        gaps = {"action_gap": compare.max_abs(
            rec["actions"], self._act(ref, rec["obs"], tf32=False))}
        ref_out, margins = compare.ref_step(
            ref[0], compare.env_state(rec["env"]), rec["actions"],
            rec["gen_state"], tf32=False)
        gaps.update(compare.step_gaps(ref_out, margins, rec["out"]))
        return gaps

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

    def check(self, control: bool = False) -> list[dict]:
        ref = self._reference()
        rows = [self.start_gap(ref)]
        for rec in self.sampler.kept():
            if control:
                rec = self.control(rec, ref)
            rows.append(self.judge(rec, ref))
        return rows
