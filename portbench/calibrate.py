"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--seconds 3] [--out chiprun_out/x.jsonl]

For each seed in one process: the cell's set-up and a short window at its
own load (the benchmark's own `run.py` does the same at `--seconds`), then
the comparison's gaps of the program's outputs (the lower readings) and,
for the first `--control` seeds, of the control's: the reference computed
with TF32 matmuls in the program's place (the upper readings).  With
`--fault <name>` (`portbench/faults.py`) the program runs with that fault
planted; with `--perturb <x>` (training) the reference also runs against
itself with its noise changed by a relative x, a change of rounding size.
One JSON line per seed and side.  The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if not __package__:  # run as a script: import portbench from the root
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import compare  # noqa: E402
from portbench.harness import load_cell, load_module  # noqa: E402


def readings(cell: dict, seed: int, seconds: float, control: bool,
             device="cuda", perturb: float = 0.0) -> list[dict]:
    driver = load_module(cell["driver_file"], "portbench_driver").Cell(
        cell["config"], cell["traffic"], seed, device)
    t = time.perf_counter()
    driver.setup()
    setup = time.perf_counter() - t
    ticks, t = 0, time.perf_counter()
    while time.perf_counter() - t < seconds:
        driver.tick(ticks)
        ticks += 1
    driver.free()
    out = []
    sides = ["program"] + ["control"] * control + ["perturbed"] * (
        perturb > 0)
    for side in sides:
        t = time.perf_counter()
        rows = driver.check(perturb=perturb) if side == "perturbed" \
            else driver.check(control=side == "control")
        out.append({"seed": seed, "side": side, "ticks": ticks,
                    "setup_s": setup, "check_s": time.perf_counter() - t,
                    **compare.worst(rows)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="training only: also the reference against itself "
                    "with its noise perturbed by this relative amount")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.fault:
        from portbench import faults

        getattr(faults, args.fault)(setattr)
    sink = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, args.seconds, n < args.control,
                            perturb=args.perturb):
            line = json.dumps({"workload": args.workload,
                               "fault": args.fault, **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
