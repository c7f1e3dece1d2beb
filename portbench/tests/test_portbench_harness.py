"""The harness on the CPU: files found by name, the contract's names and
units, a cell added as files only, imports, and the refusal without a card.

    python -m pytest portbench/tests -q
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "bez_isaacgym_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["driver_file"].exists()
    assert c["metric_files"] and all(p.exists()
                                     for p in c["metric_files"].values())
    assert c["traffic"]["limits"]
    for part in ("config", "traffic"):
        assert isinstance(c[part], dict)
    harness.load_module(c["driver_file"], "t_driver").Cell


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["workloads"]
             + BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        c = harness.load_cell(cell)
        reported = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert c["per_layer"], cell
        for m in c["per_layer"]:
            assert m["moves"] in e2e and m["moves"] in reported, (cell, m)


def test_new_cell_is_files_only(tmp_path):
    """A cell added to a copy of BENCHMARK.json, with a new traffic file,
    is found with no code edited."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((bench_dir / "traffic" /
                          "closed_loop_s64.json").read_text())
    traffic["solves"] = 16
    (bench_dir / "traffic" / "closed_loop_s16.json").write_text(
        json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "kick_mppi.tick_s16",
                               "config": "bez_kick_mppi",
                               "traffic": "closed_loop_s16", "chips": 1,
                               "why": "a smaller fleet"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kick_mppi.tick_s64" in m.get("workloads", []):
            m["workloads"].append("kick_mppi.tick_s16")
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    for c in bench["configs"]:
        src = ROOT / c["file"]
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    cell = harness.load_cell("kick_mppi.tick_s16", bench_file, bench_dir)
    assert cell["traffic"]["solves"] == 16
    assert cell["driver_file"] == bench_dir / "drivers" / \
        "mppi_closed_loop.py"
    assert set(cell["metric_files"]) == {
        "mppi.solve_ms", "kernel.substep_roofline.mppi",
        "device.idle_share.mppi"}


def test_a_run_imports_no_jax(tmp_path):
    """A whole run (tiny, on the CPU) leaves no JAX or JAX-package module
    loaded, compared by whole top-level names."""
    code = (
        "import sys, json\n"
        "from portbench import harness\n"
        "rc = harness.main(['--workload', 'kick_ppo.serve_64', '--seed', "
        "'3000000019', '--seconds', '0.3', '--trace', '0'], device='cpu', "
        "overrides={'config': {'substeps': 1}, 'traffic': {'envs': 2, "
        "'check_ticks': 1, 'warm_ticks': 1}})\n"
        "assert rc == 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bez_isaacgym_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "kick_mppi.tick_s64", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert "CUDA device" in p.stderr
    assert "correct" not in p.stdout


def test_run_fails_with_only_the_benchmark(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "kick_ppo.serve_64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_run_seconds_fits_the_check_budget():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
