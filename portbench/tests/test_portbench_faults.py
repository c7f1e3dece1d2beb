"""Runs of the harness on the CPU at a tiny size (the look for a card
skipped, the rest of a run as it is), sound and with the timed path broken
underneath, through the cells' real limits: a sound run comes out correct,
and each fault a cell can have comes out not correct.

    python -m pytest portbench/tests -q
"""

import json

import pytest

from portbench import harness
from portbench.faults import FAULTS

TINY = {
    "kick_mppi.tick_s64": {
        "config": {"horizon": 3, "num_samples": 4, "substeps": 1},
        "traffic": {"solves": 3, "check_ticks": 2, "warm_ticks": 1}},
    "kick_mppi.tick_s256": {
        "config": {"horizon": 3, "num_samples": 4, "substeps": 1},
        "traffic": {"solves": 4, "check_ticks": 2, "warm_ticks": 1}},
    "kick_ppo.serve_64": {
        "config": {"substeps": 1},
        "traffic": {"envs": 4, "check_ticks": 3, "warm_ticks": 1}},
    "kick_ppo.train_4096": {
        "config": {"substeps": 1, "horizon": 4, "minibatch_size": 16,
                   "mini_epochs": 2, "units": [16, 8]},
        "traffic": {"envs": 8, "check_steps": 3}},
}


# A fault confined to one env runs on more envs, so that the 90th
# percentile over the envs misses it and the largest gap has to catch it.
WIDER = {
    "kick_mppi.tick_s64": {"traffic": {"solves": 16}},
    "kick_mppi.tick_s256": {"traffic": {"solves": 16}},
    "kick_ppo.serve_64": {"traffic": {"envs": 16}},
}


def run(cell, capsys, seed=3000000021, wider=False):
    overrides = {k: dict(v) for k, v in TINY[cell].items()}
    for part, keys in (WIDER[cell] if wider else {}).items():
        overrides[part].update(keys)
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.3", "--trace", "0"], device="cpu",
                      overrides=overrides)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_is_correct(cell, capsys):
    r = run(cell, capsys)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch.setattr)
    one_env = fault.__name__ == "step_one_env"
    r = run(cell, capsys, wider=one_env)
    assert r["correct"] is False, r["checks"]
    if one_env:
        over = {k for k, c in r["checks"].items()
                if not c["value"] <= c["limit"]}
        assert over <= {"physics_gap_max", "obs_gap_max",
                        "reward_gap_max"}, r["checks"]
