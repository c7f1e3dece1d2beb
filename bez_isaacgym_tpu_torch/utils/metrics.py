"""Training metrics: console + JSONL + optional TensorBoard.

Copy of `bez_isaacgym_tpu/utils/metrics.py` (reference parity:
RLGPUAlgoObserver, rlgames_utils.py:101-154): per-iteration scalars under
`iter`, `frame` and `wall_s`, one JSON object per line of
`<run_dir>/metrics.jsonl`.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(run_dir, "tb"))
        except Exception:
            pass
        self._t0 = time.time()

    def log(self, step: int, frame: int, scalars: dict) -> None:
        rec = {"iter": step, "frame": frame,
               "wall_s": round(time.time() - self._t0, 2)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            # Full reference granularity (rlgames_utils.py:139-154): every
            # scalar under {k}/iter, {k}/frame, and {k}/time.
            wall = rec["wall_s"]
            for k, v in scalars.items():
                self._tb.add_scalar(f"{k}/iter", float(v), step)
                self._tb.add_scalar(f"{k}/frame", float(v), frame)
                self._tb.add_scalar(f"{k}/time", float(v), int(wall))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
