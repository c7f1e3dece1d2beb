"""Runs one cell of the port's benchmark and prints its result line.

The cell is found by name in `BENCHMARK.json` at the root of the checkout:
its configuration file, its traffic file `portbench/traffic/<traffic>.json`
(which names the driver `portbench/drivers/<driver>.py` and holds its
parameters and limits), and the per-layer metric readers
`portbench/metrics/<metric>.py` of the metrics that list the cell.  Adding a
cell, a traffic mix or a metric adds files and edits none of these.

A run: the driver's set-up (build, weights, resets, warm-up; `setup_s` runs
from the process start to its end), a window of back-to-back ticks for
`--seconds` (each tick ends synchronized), then, with the window closed, the
peak memory read, the program's state freed and the reference's comparison.
With `--trace 1` spans wrap the calls into each layer and the profiler
covers a few ticks; the result then holds the per-layer metrics.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
# Top-level module names the run may not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "bez_isaacgym_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_file: Path | None = None,
              bench_dir: Path = BENCH_DIR) -> dict:
    """Everything the run needs to know about cell `name`, found by name."""
    bench_file = bench_file or ROOT / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; "
                       f"cells: {sorted(cells)}")
    wl = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((bench_file.parent / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{wl['traffic']}.json").read_text())

    def listed(m, reported=()):
        if "workloads" in m:
            return name in m["workloads"]
        return m.get("moves") in reported if reported else True

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    per_layer = [m for m in bench["per_layer"]
                 if listed(m, {x["name"] for x in e2e})]
    return {"name": name, "workload": wl, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer,
            "driver_file": bench_dir / "drivers" / f"{traffic['driver']}.py",
            "metric_files": {m["name"]: bench_dir / "metrics" /
                             f"{m['name']}.py" for m in per_layer}}


def card_line() -> str:
    """nvidia-smi's name, power limit and clocks, or why there are none."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return f"card: {q}: " + p.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi not read ({e})"


def percentile(xs: list[float], q: float) -> float:
    """Linear-interpolated percentile q (0-100) of xs."""
    s = sorted(xs)
    k = (len(s) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


class Run:
    """What the window measured, handed to the metric readers."""

    def __init__(self, cell, driver, spans, tick_s, profiled, sl, device):
        self.cell = cell
        self.driver = driver
        self.spans = spans
        self.tick_s = tick_s           # host seconds per tick
        self.profiled = profiled       # tick indices under the profiler
        self.slice = sl                # devtrace.Slice or None
        self.device_name = device

    def unprofiled_tick_s(self) -> list[float]:
        return [t for i, t in enumerate(self.tick_s)
                if i not in self.profiled]


def end_to_end(cell, driver, setup_s, tick_s, window_s) -> dict:
    out = {}
    for m in cell["end_to_end"]:
        n = m["name"]
        if n == "setup_s":
            v = setup_s
        elif n == "tick_p95_ms":
            v = percentile(tick_s, 95) * 1e3
        elif n.endswith("_per_s"):
            v = driver.work_per_tick[n[:-len("_per_s")]] * len(tick_s) \
                / window_s
        else:
            raise KeyError(f"no end-to-end metric {n!r} in the harness")
        out[n] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, t0: float | None = None, device: str | None = None,
         overrides: dict | None = None) -> int:
    """One run.  `device` and `overrides` ({"config": ..., "traffic": ...}
    keys to replace) are for the harness's own tests on the CPU at a tiny
    size; a real run passes neither and fails without a card."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    for part, keys in (overrides or {}).items():
        cell[part].update(keys)
    chips = cell["workload"]["chips"]

    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: cell {args.workload} needs {chips} CUDA "
                  f"device(s); this machine has {n}.  The benchmark does "
                  "not run on the CPU.", file=sys.stderr)
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    dev_name = torch.cuda.get_device_name(0) if on_card else "cpu"

    from portbench import devtrace, hoststat, spans as spans_mod

    driver_mod = load_module(cell["driver_file"],
                             f"portbench_driver_{cell['traffic']['driver']}")
    driver = driver_mod.Cell(cell["config"], cell["traffic"], args.seed,
                             device)
    driver.setup()
    spans = spans_mod.Spans() if args.trace else None
    if spans is not None:
        driver.instrument(spans)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    traffic = cell["traffic"]
    p_from = traffic.get("profile_after", 2)
    p_to = p_from + traffic.get("profile_ticks", 1)
    prof, sl, profiled = None, None, set()
    p_wall = paused = 0.0     # profiled ticks' time; profiler start/stop
    tick_s = []
    host0 = hoststat.sample()
    start = time.perf_counter()
    i = 0
    while True:
        if args.trace and on_card and i == p_from:
            a = time.perf_counter()
            prof = devtrace.start()
            paused += time.perf_counter() - a
        if spans is not None:
            spans.tick = i
            if prof is not None:
                spans.profiled.add(i)
        a = time.perf_counter()
        driver.tick(i)
        b = time.perf_counter()
        tick_s.append(b - a)
        if prof is not None:
            profiled.add(i)
            p_wall += b - a
        i += 1
        done = b - start - paused >= args.seconds
        if prof is not None and (i == p_to or done):
            sl = devtrace.stop(prof, len(profiled), p_wall)
            prof = None
            paused += time.perf_counter() - b
        if done:
            break
    window_s = b - start - paused
    host = hoststat.line(host0, hoststat.sample())

    peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    print(card_line())
    print(host)
    srt = sorted(tick_s)
    print(f"ticks (ms): first {tick_s[0] * 1e3}, median "
          f"{percentile(srt, 50) * 1e3}, mean {sum(srt) / len(srt) * 1e3}, "
          f"largest {srt[-1] * 1e3}")
    print(f"window: {len(tick_s)} ticks in {window_s} s; set-up {setup_s} s; "
          f"peak {peak} bytes on {dev_name}; {len(profiled)} ticks "
          f"profiled, the profiler's start and stop {paused} s")
    if spans is not None:
        run = Run(cell, driver, spans, tick_s, profiled, sl, dev_name)
        metrics = {}
        for name, path in cell["metric_files"].items():
            reader = load_module(path, "portbench_metric_" +
                                 name.replace(".", "_"))
            v = reader.read(run)
            if v is not None:
                unit = next(m["unit"] for m in cell["per_layer"]
                            if m["name"] == name)
                metrics[name] = {"value": v, "unit": unit}
        spans.unwrap()
    else:
        metrics = end_to_end(cell, driver, setup_s, tick_s, window_s)

    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    from portbench import compare

    rows = driver.check()
    gaps = compare.worst(rows)
    for k, v in gaps.items():
        print(f"reading {k} {v}")
    checks = compare.judge(gaps, traffic["limits"])
    correct = compare.passed(checks)
    failed = sum(not compare.passed(
        [(k, r[k], lim) for k, lim in traffic["limits"].items() if k in r])
        for r in rows)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark "
              "may load neither JAX nor the JAX package", file=sys.stderr)
        return 3

    result = {"correct": correct, "attempted": len(tick_s),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": dev_name, "count": chips,
                         "memory_peak_bytes": peak}}
    if spans is not None and sl is not None:
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.wall_s
        result["breakdown"] = devtrace.breakdown(sl)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    for k, v, lim in checks:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
