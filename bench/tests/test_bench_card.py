"""On the card (skips without one): one short run of a cell through the
command the driver runs, whose last line has to parse and read correct."""
import json
import subprocess
import sys

import pytest

from bench_tiny import BENCH


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "smollm-360m.train.full", "--seed", str(2 ** 31 + 77), "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"train_tokens_per_s.full",
                                   "peak_device_gib", "setup_s"}
