#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``) names a configuration file and a traffic mix
(``bench/traffic/<mix>.json``); the mix names the driver
(``bench/benchkit/drivers/<driver>.py``) that sets the program up from the
seed, measures it for ``--seconds`` and compares what it produced with the
plain reference (``bench/reference/``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read by ``bench/metrics/<metric>.py``), ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``: each number compared with its limit,
which also end standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level module names no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"bench/run.py: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "power limit not read"


def layer_metrics(reg, workload: str, run) -> dict:
    out = {}
    for m in reg.per_layer(workload):
        value = reg.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def step_halves(spans):
    """The mean host seconds of the window's steps in its first and its
    second half: whether the noise between runs is within a window or
    between processes."""
    d = max((spans.durations.get(k, []) for k in ("train_step",
                                                  "decode_step")), key=len)
    h = len(d) // 2
    return [sum(d[:h]) / h, sum(d[h:]) / (len(d) - h)] if h else None


def build_result(reg, workload: str, run, trace: bool, kind: str,
                 chips: int) -> dict:
    """The result line of ``run``: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics and the trace's breakdown; ``checks``
    last."""
    if trace:
        metrics = layer_metrics(reg, workload, run)
    else:
        metrics = {}
        for m in reg.end_to_end(workload):
            if m["name"] not in run.e2e:
                fail(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(run.e2e[m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": run.peak_bytes}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        from benchkit.trace import breakdown
        if not run.trace:
            fail("the profiler's trace holds no device activity")
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in run.checks}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program (src/repro_torch) is not in {ROOT}")

    from benchkit.registry import Registry, driver
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    limits = reg.limits(args.workload)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card", 3)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['chips']} cards asked, {torch.cuda.device_count()} "
             "present", 3)
    device = torch.device("cuda", 0)
    card = power_limit()

    run = driver(mix["driver"]).run(cfg, mix, limits, args.seed,
                                    args.seconds, bool(args.trace), device,
                                    T_START)

    found = forbidden_modules()
    if found:
        fail(f"modules a run may not load were loaded: {found}", 4)
    result = build_result(reg, args.workload, run, bool(args.trace),
                          torch.cuda.get_device_name(0), cell["chips"])
    run.notes["step_s_halves"] = step_halves(run.spans)
    print(json.dumps({"card": card, "notes": run.notes,
                      "window_s": run.window_s,
                      "counters": {k: v for k, v in run.counters.items()
                                   if not isinstance(v, list)}}),
          file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
