"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA card(s) the cell
asks for; it fails without them.  See `portbench/README.md`.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
# Every build and kernel cache inside the checkout, at fixed paths.  The
# port's substep kernel builds into `bez_isaacgym_tpu_torch/build/`, keyed
# by a hash of its sources.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)  # not portbench/: its module names stay private

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
