"""The hybrid cell `kick_hybrid.sqp_s16` through the harness on the CPU at a
tiny size, sound and with its SQP stage broken underneath
(`portbench/faults_hybrid.py`), at the cell's real limits; the driver's
count of the kernel's work; and, on the card, the TF32 control against the
program.

    python -m pytest portbench/tests -q                      # on the CPU
    python -m pytest --noconftest -m cuda portbench/tests -q # on the card
"""

import json

import pytest
import torch

from portbench import calibrate, compare, harness
from portbench.faults_hybrid import FAULTS

CELL = "kick_hybrid.sqp_s16"
# 16 envs, so that the 90th percentile over the envs misses a fault in one
# env and its count has to catch it; a horizon of 6 at the cell's 2
# substeps, so that the line search takes shorter steps than the full one
# in some solves (at 3 steps of 1 substep it takes the full step in all).
TINY = {"config": {"horizon": 6, "num_samples": 4, "substeps": 2},
        "traffic": {"solves": 16, "check_ticks": 2, "warm_ticks": 1}}
SEED = 3000000021


def tiny_cell() -> dict:
    cell = harness.load_cell(CELL)
    for part, keys in TINY.items():
        cell[part].update(keys)
    return cell


def run(capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.3", "--trace", "0"], device="cpu",
                      overrides={k: dict(v) for k, v in TINY.items()})
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


def test_sound_run_is_correct(capsys):
    r = run(capsys)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"solves_per_s", "tick_p95_ms", "setup_s"}


# Checks each fault has to fail, besides failing as a whole (the one-env
# fault fails this check alone).
CAUGHT_BY = {
    "sqp_half_skipped": {"missed_step_over"},
    "feedback_gains_zeroed": {"sqp_nominal_gap", "carried_gap"},
    "sqp_one_env_altered": {"action_gap_max"},
    "carried_mppi_own": {"carried_gap"},
    "carried_unchanged": {"carried_gap"},
}


@pytest.mark.parametrize("fault", FAULTS[CELL], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch.setattr)
    r = run(capsys)
    assert r["correct"] is False, r["checks"]
    over = {k for k, c in r["checks"].items()
            if not c["value"] <= c["limit"]}
    assert CAUGHT_BY.get(fault.__name__, set()) <= over, r["checks"]
    if fault.__name__ == "sqp_one_env_altered":
        assert over == {"action_gap_max"}, r["checks"]


def test_substep_envs_per_tick_counts_the_kernels_work():
    """The driver's count equals the batch x substeps of every call to the
    task's batched step (the kernel on the card) in one tick."""
    cell = tiny_cell()
    driver = harness.load_module(cell["driver_file"], "t_hybrid").Cell(
        cell["config"], cell["traffic"], SEED, "cpu")
    driver.setup()
    task, calls = driver.task, []
    step = task._step_physics_batch

    def counted(dyn, physics, targets):
        calls.append(targets.shape[0] * task.scene.substeps)
        return step(dyn, physics, targets)

    task._step_physics_batch = counted
    driver.tick(0)
    assert sum(calls) == driver.substep_envs_per_tick()
    c, S = cell["config"], cell["traffic"]["solves"]
    H, sub = c["horizon"], c["substeps"]
    n_a = len(c["sqp"]["line_search"])
    # MPPI's H steps of S K rows, the SQP's nominal rollout of S rows and
    # line search of S per step size, the env step.
    assert sorted(calls) == sorted(
        [S * c["num_samples"] * sub] * H + [S * sub] * H
        + [n_a * S * sub] * (H * c["sqp"]["iterations"]) + [S * sub])


def test_the_program_without_the_mppi_nominal_is_refused(monkeypatch):
    """A program whose hybrid solve does not hand back the MPPI stage's
    nominal fails in set-up, before any window."""
    from bez_isaacgym_tpu_torch.solvers.hybrid import HybridSolver

    solve = HybridSolver.solve

    def without(self, *a, **k):
        actions, state, info = solve(self, *a, **k)
        info.pop("mppi_nominal")
        return actions, state, info

    monkeypatch.setattr(HybridSolver, "solve", without)
    cell = tiny_cell()
    driver = harness.load_module(cell["driver_file"], "t_hybrid").Cell(
        cell["config"], cell["traffic"], SEED, "cpu")
    with pytest.raises(RuntimeError, match="mppi_nominal"):
        driver.setup()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(cuda):
    cell = harness.load_cell(CELL)
    cell["traffic"].update({"check_ticks": 2})
    limits = cell["traffic"]["limits"]
    for seed in (3000000101, 3000000102, 3000000103):
        program, control = calibrate.readings(cell, seed, 1.0, True, cuda)
        assert compare.passed(compare.judge(program, limits)), program
        assert not compare.passed(compare.judge(control, limits)), control


def test_a_first_action_the_reference_does_not_hold_is_not_judged(
        monkeypatch, capsys):
    """Where the reference's own first action moves past WELL_POSED when its
    handed nominal moves by rounding size, the program's first action there
    is not judged: the one-env fault passes the first-action check when
    that env is the ill-posed one, and is caught when it is not."""
    from portbench import faults_hybrid
    from portbench.drivers.hybrid_closed_loop import WELL_POSED
    from portbench.reference.solvers.hybrid import HybridSolver

    solve = HybridSolver.solve

    def shaky(self, *a, **k):
        actions, state, info = solve(self, *a, **k)
        if "best_score" not in info:  # the perturbed SQP stage
            actions = actions.clone()
            actions[-1] += 2 * WELL_POSED
        return actions, state, info

    faults_hybrid.sqp_one_env_altered(monkeypatch.setattr)
    monkeypatch.setattr(HybridSolver, "solve", shaky)
    r = run(capsys)
    c = r["checks"]["action_gap_max"]
    assert c["value"] <= c["limit"], r["checks"]
    assert r["correct"] is True, r["checks"]


def test_contact_margins_sees_a_point_at_its_activation():
    """An env whose lowest contact point is put 1e-8 m above the ground
    reads under CONTACT_MARGIN; the others read their own distances."""
    cell = tiny_cell()
    mod = harness.load_module(cell["driver_file"], "t_hybrid_margins")
    driver = mod.Cell(cell["config"], cell["traffic"], SEED, "cpu")
    driver.setup()
    task, _ = driver._reference()
    env = compare.env_state(driver.env)
    gen_state = driver.gen.get_state()
    actions = torch.zeros(driver.S, task.num_actions)
    far = mod.contact_margins(task, env, actions, gen_state)
    assert bool((far >= mod.CONTACT_MARGIN).all()), far
    # Lower env 0 so that its lowest contact point sits 1e-8 m above the
    # ground, where the step's first substep starts.
    d = mod._contact_distance(task.model, task.scene, env.physics)
    low = env.physics.base_pos.clone()
    low[0, 2] -= d[0] - 1e-8
    near = mod.contact_margins(
        task, env._replace(physics=env.physics._replace(base_pos=low)),
        actions, gen_state)
    assert float(near[0]) < mod.CONTACT_MARGIN, near
    assert torch.equal(near[1:], far[1:])


def test_an_env_near_a_contact_is_left_out_of_the_step_check():
    """The step's gaps leave out, and count, an env that `contact_margins`
    puts within CONTACT_MARGIN: a planted step error there is not judged,
    and is judged once the env is away from every contact."""
    cell = tiny_cell()
    mod = harness.load_module(cell["driver_file"], "t_hybrid_step")
    driver = mod.Cell(cell["config"], cell["traffic"], SEED, "cpu")
    driver.setup()
    for i in range(cell["traffic"]["check_ticks"]):
        driver.tick(i)
    driver.free()
    ref = driver._reference()
    rec = driver.sampler.kept()[0]
    q = rec["out"].state.physics.q.clone()
    q[0] += 0.1
    rec = {**rec, "out": rec["out"]._replace(state=rec["out"].state._replace(
        physics=rec["out"].state.physics._replace(q=q)))}
    assert driver.judge(rec, ref)["physics_gap_max"] >= 0.1
    margins = mod.contact_margins
    mod.contact_margins = lambda *a: margins(*a).index_fill(
        0, torch.tensor([0]), 0.0)
    try:
        gaps = driver.judge(rec, ref)
    finally:
        mod.contact_margins = margins
    assert gaps["physics_gap_max"] < 0.1, gaps
    assert gaps["borderline"] >= 1
