"""The control on the card: the reference in the program's place, computed
with TF32 matmuls (the precision next below the configurations' float32
with TF32 off), comes out not correct under each cell's limits, while the
program comes out correct, on three seeds, at sizes a test run holds.

    python -m pytest --noconftest -m cuda portbench/tests -q

It skips without a CUDA device.  `portbench/calibrate.py` takes the same
readings at the cells' own sizes.
"""

import pytest
import torch

from portbench import calibrate, compare, harness

pytestmark = pytest.mark.cuda

SMALL = {
    "kick_mppi.tick_s64": {"traffic": {"solves": 8, "check_ticks": 2}},
    "kick_mppi.tick_s256": {"traffic": {"solves": 16, "check_ticks": 1}},
    "kick_ppo.serve_64": {"traffic": {"envs": 16, "check_ticks": 4}},
    "kick_ppo.train_4096": {"config": {"minibatch_size": 4096},
                            "traffic": {"envs": 512, "check_steps": 4}},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_where_the_program_passes(cuda, cell):
    c = harness.load_cell(cell)
    for part, keys in SMALL[cell].items():
        c[part].update(keys)
    limits = c["traffic"]["limits"]
    for seed in (3000000101, 3000000102, 3000000103):
        program, control = calibrate.readings(c, seed, 1.0, True, cuda)
        assert compare.passed(compare.judge(program, limits)), program
        assert not compare.passed(compare.judge(control, limits)), control
