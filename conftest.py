"""Every pytest session started in this repository gives each test a time
limit of its own (tests/time_limit.py)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

pytest_plugins = ["time_limit"]
