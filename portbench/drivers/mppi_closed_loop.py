"""Closed-loop MPPI ticks on the kick task: per tick, fresh sampling noise
from the seed, one `MPPISolver.solve` over S envs (S x K rollouts of H
control steps through the substep kernel) and one `KickTask.step_batch`
with its actions, ending synchronized.

Traffic keys: `solves` (S), `warm_ticks`, `check_ticks` (ticks the
comparison samples from the window), `profile_after`, `profile_ticks`,
`limits`.  Configuration keys: `substeps`, `horizon`, `num_samples`,
`sigma`, `temperature`.
"""

from __future__ import annotations

import torch

from portbench import compare, inputs

F32 = torch.float32


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.S = traffic["solves"]
        self.work_per_tick = {"solves": self.S}

    def _mppi_config(self, cls):
        c = self.config
        return cls(horizon=c["horizon"], num_samples=c["num_samples"],
                   sigma=c["sigma"], temperature=c["temperature"])

    def setup(self) -> None:
        from bez_isaacgym_tpu_torch.solvers.mppi import MPPIConfig, MPPISolver
        from bez_isaacgym_tpu_torch.tasks.base import TaskConfig
        from bez_isaacgym_tpu_torch.tasks.kick import KickTask

        dev = self.device
        self.task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                             device=dev)
        self.solver = MPPISolver(self.task, self._mppi_config(MPPIConfig))
        self.gen = inputs.generator(self.seed, "reset", dev)
        self.noise_gen = inputs.generator(self.seed, "mppi_noise", dev)
        self.env = self.task.reset(self.gen, self.S)
        self.start = compare.snapshot(self.env)
        self.mppi = self.solver.init_state(self.S)
        self.noise_shape = (self.S, self.config["num_samples"],
                            self.config["horizon"], self.task.num_actions)
        self.sampler = None
        for _ in range(self.traffic["warm_ticks"]):
            self._tick(None)
        self.sampler = inputs.Sampler(self.traffic["check_ticks"], self.seed)

    def _tick(self, slot) -> None:
        noise = torch.randn(self.noise_shape, generator=self.noise_gen,
                            device=self.device)
        rec = None if slot is None else compare.snapshot({
            "env": self.env, "nominal": self.mppi.nominal, "noise": noise,
            "gen_state": self.gen.get_state()})
        actions, mppi, info = self.solver.solve(self.env, self.mppi,
                                                noise=noise)
        out = self.task.step_batch(self.env, actions, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if rec is not None:
            self.sampler.records[slot] = {**rec, **compare.snapshot({
                "actions": actions, "nominal_out": mppi.nominal,
                "best": info["best_score"], "mean": info["mean_score"],
                "out": out})}
        self.env, self.mppi = out.state, mppi

    def tick(self, i: int) -> None:
        self._tick(self.sampler.slot(i))

    def instrument(self, spans) -> None:
        spans.wrap(self.solver, "solve", "solve")
        spans.wrap(self.task, "step_batch", "step")

    def substep_envs_per_tick(self) -> int:
        """Env-substeps the kernel runs per tick: the rollouts' S K H
        control steps and the env step's S, each `substeps` times."""
        c = self.config
        return c["substeps"] * self.S * (c["num_samples"] * c["horizon"] + 1)

    def free(self) -> None:
        self.env = self.mppi = self.solver = self.task = None

    # ------------------------------------------------------------ the check
    def _reference(self):
        from portbench.reference.solvers.mppi import MPPIConfig, MPPISolver
        from portbench.reference.tasks.base import TaskConfig
        from portbench.reference.tasks.kick import KickTask

        task = KickTask(TaskConfig(substeps=self.config["substeps"]),
                        device=self.device)
        return task, MPPISolver(task, self._mppi_config(MPPIConfig))

    def _solve(self, solver, rec, tf32: bool):
        from portbench.reference.solvers.mppi import MPPIState

        with compare.precision(tf32):
            return solver.solve(compare.env_state(rec["env"]),
                                MPPIState(rec["nominal"]),
                                noise=rec["noise"])

    def control(self, rec: dict, ref) -> dict:
        """The record's outputs as the reference computes them in TF32."""
        task, solver = ref
        a, m, info = self._solve(solver, rec, tf32=True)
        out, _ = compare.ref_step(task, compare.env_state(rec["env"]), a,
                                  rec["gen_state"], tf32=True)
        return {**rec, "actions": a, "nominal_out": m.nominal,
                "best": info["best_score"], "mean": info["mean_score"],
                "out": out}

    def judge(self, rec: dict, ref) -> dict:
        """Gaps of a tick's outputs against the reference's from the same
        inputs: the solve (per solve: the actions, the new nominal, the best
        and mean rollout scores), then the env step from the produced
        actions."""
        task, solver = ref
        a, m, info = self._solve(solver, rec, tf32=False)
        score = torch.maximum(compare.per_env(rec["best"], info["best_score"]),
                              compare.per_env(rec["mean"], info["mean_score"]))
        gaps = {**compare.gaps_of("action_gap",
                                  compare.per_env(rec["actions"], a)),
                **compare.gaps_of("nominal_gap", compare.per_env(
                    rec["nominal_out"], m.nominal)),
                **compare.gaps_of("score_gap", score)}
        ref_out, margins = compare.ref_step(
            task, compare.env_state(rec["env"]), rec["actions"],
            rec["gen_state"], tf32=False)
        gaps.update(compare.step_gaps(ref_out, margins, rec["out"]))
        return gaps

    def start_gap(self, ref) -> dict:
        """The program's reset states against the reference's from the same
        generator seed (exact: the same draws and arithmetic)."""
        task, _ = ref
        r = task.reset(inputs.generator(self.seed, "reset", self.device),
                       self.S)
        p = compare.env_state(self.start)
        return {"start_gap": max(
            compare.max_abs(x, y) for x, y in zip(
                list(p.physics) + list(p.dyn),
                list(r.physics) + list(r.dyn)) if x is not None)}

    def check(self, control: bool = False) -> list[dict]:
        """One dict of gaps per sampled tick, and the start's."""
        ref = self._reference()
        rows = [self.start_gap(ref)]
        for rec in self.sampler.kept():
            if control:
                rec = self.control(rec, ref)
            rows.append(self.judge(rec, ref))
        return rows
