"""The frozen reference against the port's plain path, on the CPU at a few
envs over 1-3 steps, and the reference's imports.

    python -m pytest portbench/tests -q

These tests import the port to compare with it; `portbench/reference/`
itself imports nothing of it.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bez_isaacgym_tpu_torch.ops import substep as port_ss
from bez_isaacgym_tpu_torch.rl import ppo as port_ppo
from bez_isaacgym_tpu_torch.rl.players import PpoPlayerContinuous
from bez_isaacgym_tpu_torch.solvers import mppi as port_mppi
from bez_isaacgym_tpu_torch.tasks import base as port_base
from bez_isaacgym_tpu_torch.tasks.kick import KickTask as PortKick
from portbench import compare, roofline
from portbench.reference.checkpoint import actor_critic_state
from portbench.reference.rl import ppo as ref_ppo
from portbench.reference.solvers import mppi as ref_mppi
from portbench.reference.tasks import base as ref_base
from portbench.reference.tasks.kick import KickTask as RefKick

ROOT = Path(__file__).resolve().parents[2]
CKPT = ROOT / "runs" / "Bez_Kick" / "Bez_Kick_best.ckpt"
FORBIDDEN = {"jax", "jaxlib", "flax", "bez_isaacgym_tpu",
             "bez_isaacgym_tpu_torch"}


def tasks(substeps):
    return (PortKick(port_base.TaskConfig(substeps=substeps), device="cpu"),
            RefKick(ref_base.TaskConfig(substeps=substeps), device="cpu"))


def equal_trees(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            equal_trees(x, y)
        elif x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("substeps", [1, 2])
def test_step_batch_equals_port(substeps):
    port, ref = tasks(substeps)
    gp = torch.Generator().manual_seed(5)
    gr = torch.Generator().manual_seed(5)
    sp, sr = port.reset(gp, 4), ref.reset(gr, 4)
    for t in range(3):
        a = 0.5 * torch.randn(4, 18, generator=torch.Generator()
                              .manual_seed(t))
        op, orf = port.step_batch(sp, a, gp), ref.step_batch(sr, a, gr)
        equal_trees(op, orf)
        sp, sr = op.state, orf.state


def test_ref_step_phases_equal_step_batch():
    """`compare.ref_step` (the reference's step phase by phase, from a
    generator state) gives the step_batch of the port's plain path."""
    port, ref = tasks(2)
    g = torch.Generator().manual_seed(9)
    s = port.reset(g, 4)
    a = 0.3 * torch.randn(4, 18, generator=torch.Generator().manual_seed(1))
    gs = g.get_state()
    out_p = port.step_batch(s, a, g)
    out_r, margins = compare.ref_step(ref, compare.env_state(s), a, gs,
                                      tf32=False)
    equal_trees(out_p, out_r)
    assert margins.shape == (4,) and bool((margins >= 0).all())


def test_mppi_solve_equals_port():
    port, ref = tasks(1)
    cfg = dict(horizon=3, num_samples=4)
    sp = port_mppi.MPPISolver(port, port_mppi.MPPIConfig(**cfg))
    sr = ref_mppi.MPPISolver(ref, ref_mppi.MPPIConfig(**cfg))
    env = port.reset(torch.Generator().manual_seed(2), 2)
    nominal = sp.init_state(2)
    noise = torch.randn(2, 4, 3, 18, generator=torch.Generator()
                        .manual_seed(3))
    for _ in range(2):
        ap, mp, ip = sp.solve(env, nominal, noise=noise)
        ar, mr, ir = sr.solve(compare.env_state(env),
                              ref_mppi.MPPIState(nominal.nominal),
                              noise=noise)
        assert torch.equal(ap, ar) and torch.equal(mp.nominal, mr.nominal)
        assert torch.equal(ip["best_score"], ir["best_score"])
        nominal = mp


def test_ppo_train_iter_equals_port():
    port, ref = tasks(1)
    cfg = dict(horizon=3, minibatch_size=8, mini_epochs=2, units=(16, 8))
    pp = port_ppo.PPO(port, 4, port_ppo.PPOConfig(**cfg))
    pr = ref_ppo.PPO(ref, 4, ref_ppo.PPOConfig(**cfg))
    tsp = pp.init(torch.Generator().manual_seed(0))
    tsr = pr.init(torch.Generator().manual_seed(0))
    equal_trees(tsp.params.values(), tsr.params.values())
    gp, gr = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    zero = torch.zeros(4, 18)
    op, ep = port.observe(port.reset(gp, 4), zero)
    orr, er = ref.observe(ref.reset(gr, 4), zero)
    for k in range(2):
        noise = torch.randn(3, 4, 18, generator=torch.Generator()
                            .manual_seed(10 + k))
        perms = torch.stack([torch.randperm(12) for _ in range(2)])
        tsp, ep, op, mp = pp.train_iter(tsp, ep, op, gp, noise=noise,
                                        perms=perms)
        tsr, er, orr, mr = pr.train_iter(tsr, er, orr, gr, noise=noise,
                                         perms=perms)
        assert torch.equal(mp["loss"], mr["loss"])
        for name in tsp.params:
            assert torch.equal(tsp.params[name], tsr.params[name])
            assert torch.equal(tsp.opt_state.mu[name],
                               tsr.opt_state.mu[name])


def test_checkpoint_reader_equals_port_player():
    port, _ = tasks(1)
    player = PpoPlayerContinuous(port, checkpoint_path=str(CKPT),
                                 device="cpu")
    sd, rms = actor_critic_state(str(CKPT))
    for k, v in player.net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert torch.equal(player.obs_rms.mean, rms.mean)
    assert torch.equal(player.obs_rms.var, rms.var)


@pytest.mark.parametrize("B", [64, 8192])
def test_frozen_bytes_equal_port(B):
    port, ref = tasks(2)
    pk = {"bytes_per_s": port_ss.PEAK_BYTES_PER_S,
          "fp32_flops_per_s": port_ss.PEAK_FP32_PER_S}
    assert roofline.bytes_per_env(ref.model, True) * B == \
        port_ss.bytes_per_env(port.model, True) * B
    b = roofline.launch_bound(ref.model, ref.scene, B, pk)
    assert b.by == "bytes" and b.bytes == port_ss.bytes_per_env(port.model) * B


def test_frozen_operation_count_equals_port():
    port, ref = tasks(2)
    s = port.reset(torch.Generator().manual_seed(1), 8)
    x = port_ss.pack_state(s.physics)
    tables = port_ss.KernelTables(port.model, port.scene)
    want = port_ss.flop_terms(tables, port_ss.contact_activity(tables, x))
    act = roofline.contact_activity(ref.model, ref.scene, x)
    assert roofline.flop_terms(ref.model, ref.scene, act) == want
    # Every contact active still leaves the launch bound by its bytes.
    full = roofline.all_active(ref.model, 8)
    assert sum(roofline.flop_terms(ref.model, ref.scene, full).values()) \
        < roofline.bytes_per_env(ref.model) * 8 * 67 / 3.35


def test_reference_imports_nothing_of_the_port_or_jax():
    code = (
        "import sys, json, pkgutil, importlib\n"
        "import portbench.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'portbench.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "import portbench.roofline, portbench.compare, portbench.peaks\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
