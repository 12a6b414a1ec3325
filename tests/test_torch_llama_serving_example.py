"""The example twin ``python -m horovod_tpu_torch.examples.llama_serving``.

It serves through the port's ``ContinuousBatcher`` and
``speculative_generate`` as a user would, on the CPU at the tiny size,
and prints the JAX example's two lines (tests/test_examples.py runs the
JAX one).
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_serving_example_twin_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.llama_serving",
         "--requests", "3", "--slots", "2", "--new-tokens", "4",
         "--draft-k", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.fullmatch(r"batcher: 3 requests through 2 slots, 12 tokens "
                        r"in \d+\.\d\ds", lines[0]), lines
    assert lines[1] == "speculative == plain greedy: True"
