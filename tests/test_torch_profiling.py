"""The port's profiling helpers (`bez_isaacgym_tpu_torch/utils/profiling.py`)
on the CPU, against the JAX package's `utils/profiling.py`:

- `profile_fn` returns each operator's time and calls per iteration,
  largest first (on the CPU, torch.profiler's CPU self times);
- `measure_wall` is the median of the timed calls;
- `chip_peaks` picks a device's peaks by name, the CPU entry otherwise;
- `sol_report` prints the JAX version's text for the same numbers.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bez_isaacgym_tpu.utils import profiling as jprof  # noqa: E402
from bez_isaacgym_tpu_torch.utils import profiling  # noqa: E402


def test_profile_fn_returns_per_iteration_times_largest_first():
    a, b = torch.randn(256, 256), torch.randn(256, 256)

    def fn(x, y):
        return torch.relu(x @ y).sum()

    ops = profiling.profile_fn(fn, (a, b), iters=4)
    assert ops and all(isinstance(o, profiling.OpTime) for o in ops)
    assert [o.total_ms for o in ops] == sorted((o.total_ms for o in ops),
                                               reverse=True)
    names = {o.name: o for o in ops}
    assert "aten::mm" in names and names["aten::mm"].count == 1
    assert names["aten::relu"].count == 1


def test_measure_wall_is_the_median_of_the_calls():
    times = iter([0.0, 1.0, 1.0, 1.003, 2.0, 2.001, 3.0, 3.005])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.time, "perf_counter", lambda: next(times))
        wall = profiling.measure_wall(lambda: None, (), iters=3)
    assert wall == pytest.approx(0.003)
    assert profiling.measure_wall(torch.randn, (64, 64), iters=5) > 0


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67.0, 3350.0)),
    ("Some Other Card", (0.2, 50.0))])
def test_chip_peaks_by_name(name, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert profiling.chip_peaks() == want


def test_chip_peaks_without_a_card_is_the_cpu_entry(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.chip_peaks() == profiling.CHIP_PEAKS["cpu"] == \
        jprof.CHIP_PEAKS["cpu"]


def test_sol_report_is_the_jax_text():
    ops = [profiling.OpTime("bez_substep_kernel", 0.123456, 4),
           profiling.OpTime("aten::mm", 0.01, 12)]
    jops = [jprof.OpTime(o.name, o.total_ms, o.count) for o in ops]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprof, "chip_peaks", lambda: (0.2, 50.0))
        mp.setattr(profiling, "chip_peaks", lambda: (0.2, 50.0))
        want = jprof.sol_report(0.0125, 3.0e9, 2.0e8, jops, top_n=1)
        got = profiling.sol_report(0.0125, 3.0e9, 2.0e8, ops, top_n=1)
    assert got == want
    assert got.splitlines()[-1].endswith("bez_substep_kernel")
