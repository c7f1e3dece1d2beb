"""The port's flax msgpack reader and restore layouts, against flax.

The port reads the JAX package's checkpoints without flax or msgpack
(`bez_isaacgym_tpu_torch/utils/checkpoint.py`).  Here flax and msgpack are
the reference: the same bytes must decode to the same tree, bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import msgpack  # noqa: E402
from flax import serialization  # noqa: E402

from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.base import TaskConfig  # noqa: E402
from bez_isaacgym_tpu_torch.tasks.kick import KickTask  # noqa: E402
from bez_isaacgym_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KICK = ROOT / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt"
KICK_DR = ROOT / "runs" / "Bez_Kick_DR" / "Bez_Kick_DR_best.ckpt"
GOALIE = ROOT / "runs" / "Bez_Goalie" / "Bez_Goalie_best.ckpt"
WALK = ROOT / "runs" / "Bez_Walk" / "Bez_Walk_best.ckpt"


def _assert_bit_equal(got, ref, path="/"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _assert_bit_equal(got[k], ref[k], f"{path}{k}/")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    assert got.tobytes() == ref.tobytes(), path


@pytest.mark.parametrize("path", [KICK, KICK_DR], ids=["kick", "kick_dr"])
def test_read_msgpack_matches_flax(path):
    ours = ckpt.read_msgpack(str(path))
    ref = serialization.msgpack_restore(path.read_bytes())
    _assert_bit_equal(ours, ref)
    # The layout the kick player restores: a full PPO TrainState.
    assert ours["params"]["params"]["Dense_0"]["kernel"].shape == (54, 400)
    assert ours["obs_rms"]["count"].shape == ()
    assert ours["obs_rms"]["count"].dtype == np.float32
    assert ours["key"].dtype == np.uint32


def test_every_format_family_decodes_as_msgpack_does():
    """Each msgpack format family, packed by the msgpack package."""
    obj = {
        "fixint": [0, 1, 127, -1, -32],
        "ints": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
                 -2**63],
        "float64": [0.1, -1e300],
        "nil_bool": [None, True, False],
        "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536,
                "Å"],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "arrays": [list(range(15)), list(range(16)), list(range(65536))],
        "maps": [{str(i): i for i in range(15)},
                 {str(i): i for i in range(16)},
                 {str(i): i for i in range(65536)}],
        "ext": [msgpack.ExtType(5, b"\x01" * n)
                for n in (1, 2, 4, 8, 16, 3, 255, 256, 65536)],
        "nested": {"a": {"b": [{"c": []}]}},
    }
    data = msgpack.packb(obj, use_bin_type=True)
    assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False)
    single = msgpack.packb([1.5, -2.25], use_single_float=True)
    assert ckpt.unpackb(single) == [1.5, -2.25]


def test_flax_extension_types():
    """Ext 1 (ndarray), 3 (numpy scalar) and 2 (complex), as flax writes
    them; tuples come back as dicts keyed "0", "1", ..."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "u32": np.array([1, 2**32 - 1], np.uint32),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 5), np.float32),
        "scalar": np.float32(2.5),
        "count": np.asarray(1e-4, np.float32),
        "complex": 1.5 - 2j,
        "tuple": (np.ones(2, np.float32), 3),
    }
    data = serialization.to_bytes(tree)
    ours = ckpt.unpackb(data)
    ref = serialization.msgpack_restore(data)
    assert ours["complex"] == ref["complex"] == 1.5 - 2j
    assert set(ours["tuple"]) == {"0", "1"}
    del ours["complex"], ref["complex"]
    _assert_bit_equal(ours, ref)


def test_chunked_arrays_are_refused():
    data = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        ckpt.unpackb(data)


def test_truncated_and_trailing_bytes_raise():
    data = serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(data + b"\x00")


def test_checkpoint_name_and_latest(tmp_path):
    from bez_isaacgym_tpu.utils import checkpoint as jckpt

    name = ckpt.checkpoint_name("Bez_Kick", 120, 3.14159)
    assert name == jckpt.checkpoint_name("Bez_Kick", 120, 3.14159)
    assert ckpt.latest(str(tmp_path / "missing")) is None
    assert ckpt.latest(str(tmp_path)) is None
    for epoch in (5, 120, 40):
        (tmp_path / ckpt.checkpoint_name("Bez_Kick", epoch, 1.0)).touch()
    assert ckpt.latest(str(tmp_path)) == jckpt.latest(str(tmp_path))
    assert ckpt.latest(str(tmp_path)).endswith("Bez_Kick_120_rew_1.00.ckpt")


@pytest.fixture(scope="module")
def task():
    return KickTask(TaskConfig(substeps=1), device="cpu")


def test_restore_raises_on_the_slim_layout_as_jax_does(task, tmp_path):
    """A checkpoint holding only the weights ({"params": {"Dense_*"}}, no
    TrainState fields) does not restore into the player, on either side."""
    from bez_isaacgym_tpu.rl.players import \
        PpoPlayerContinuous as JPlayer
    from bez_isaacgym_tpu.tasks.base import TaskConfig as JTaskConfig
    from bez_isaacgym_tpu.tasks.kick import KickTask as JKickTask

    full = serialization.msgpack_restore(GOALIE.read_bytes())
    slim = tmp_path / "slim.ckpt"
    slim.write_bytes(serialization.msgpack_serialize(
        {"params": full["params"]["params"]}))
    jplayer = JPlayer(JKickTask(JTaskConfig(substeps=1, use_pallas=False)))
    with pytest.raises(ValueError, match="field names"):
        jplayer.restore(str(slim))
    with pytest.raises(ValueError, match="layout"):
        PpoPlayerContinuous(task, device="cpu").restore(str(slim))
    # The full goalie TrainState restores on both sides.
    jplayer.restore(str(GOALIE))
    PpoPlayerContinuous(task, checkpoint_path=str(GOALIE), device="cpu")


def test_restore_refuses_weights_of_another_shape(task):
    """The walk policy (52 observations) does not load into a kick player
    (54): load_state_dict checks every shape."""
    with pytest.raises(RuntimeError, match="size mismatch"):
        PpoPlayerContinuous(task, checkpoint_path=str(WALK), device="cpu")
