#!/usr/bin/env python3
"""The readings that the limits of ``bench/limits/<workload>.json`` are set
from, on the card at the cell's own size (the benchmark's runs do not run
this):

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --controls 4,5,6 --seconds 5 --out readings.json

- ``--seeds``: sound runs of the program (the cell's driver with a window
  of ``--seconds``), each compared with the plain reference: the lower
  readings.
- ``--controls``: the control, the reference computed in float8 e4m3 (the
  precision below the configurations' bfloat16) in the program's place,
  and the planted faults the cell can have: for training, half of the
  batch left out (the mean over the rest), and a state left unchanged
  (which reads 1 on the change by the measure and needs no run); for
  serving, one served token of each sampled request altered where it is
  produced.  For serving, the control and the fault are read on a sound
  run's own sample.
"""
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(checks) -> dict:
    return {name: value for name, value, _ in checks}


def train(cfg, mix, limits, args, device):
    from benchkit import compare
    from benchkit.drivers import train as drv
    out = {"program": [], "control": [], "half_batch": []}
    for seed in args.seeds:
        _, prog = drv.program_readings(cfg, mix, seed, device,
                                       time.perf_counter(), args.seconds,
                                       False)
        ref = drv.reference_readings(cfg, mix, seed, device)
        out["program"].append(
            {"seed": seed, **readings(compare.train_checks(prog, ref,
                                                           limits)),
             "loss_gap": compare.loss_gap(prog, ref)})
        print(json.dumps(out["program"][-1]), flush=True)
    for seed in args.controls:
        ref = drv.reference_readings(cfg, mix, seed, device)
        for key, kw in (("control", {"prec": "fp8"}),
                        ("half_batch",
                         {"rows": list(range(mix["batch"] // 2))})):
            got = drv.reference_readings(cfg, mix, seed, device, **kw)
            out[key].append(
                {"seed": seed,
                 **readings(compare.train_checks(got, ref, limits)),
                 "loss_gap": compare.loss_gap(got, ref)})
            print(key, json.dumps(out[key][-1]), flush=True)
    return out


def serve(cfg, mix, limits, args, device):
    from benchkit.drivers import serve as drv
    out = {"program": [], "control": [], "altered_token": []}
    for i, seed in enumerate(args.seeds):
        run = drv.run(cfg, mix, limits, seed, args.seconds, False, device,
                      time.perf_counter())
        out["program"].append({"seed": seed, **readings(run.checks),
                               "sampled": run.notes["sampled"]})
        print(json.dumps(out["program"][-1]), flush=True)
        if seed not in args.controls:
            continue
        ctl = drv.reference_gap(cfg, run.sample, seed, device, prec="fp8")
        out["control"].append({"seed": seed, "served_logit_gap": ctl})
        altered = [dict(r, served=[t if j != len(r["served"]) // 2 else
                                   (t + 1) % cfg["vocab_size"]
                                   for j, t in enumerate(r["served"])])
                   for r in run.sample]
        alt = drv.reference_gap(cfg, altered, seed, device)
        out["altered_token"].append({"seed": seed, "served_logit_gap": alt})
        print("control", ctl, "altered", alt, flush=True)
    return out


def main():
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    args.seeds = [int(s) for s in args.seeds.split(",") if s]
    args.controls = [int(s) for s in args.controls.split(",") if s]
    from benchkit.registry import Registry
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(args.workload)
    device = torch.device("cuda", 0)
    fn = train if mix["driver"] == "train" else serve
    out = {"workload": args.workload, "seconds": args.seconds,
           "card": torch.cuda.get_device_name(0),
           **fn(cfg, mix, limits, args, device)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
