"""The harness finds every configuration, mix, limit and per-layer metric
by its name, picks up new ones from files alone, and prints the result
line the driver reads."""
import json
import shutil

import pytest

import run as bench_run
from bench_tiny import BENCH
from benchkit.core import Run
from benchkit.registry import Registry

ROOT = BENCH.parent


def test_every_entry_has_its_files():
    reg = Registry(ROOT)
    spec = reg.spec
    assert spec["paths"] == ["bench"]
    for c in spec["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"].startswith(
            c["source"])
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        reg.traffic(w["traffic"])
        assert json.loads((BENCH / "limits" / f"{w['name']}.json")
                          .read_text())
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in reg.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.per_layer(w["name"])
    for m in spec["per_layer"]:
        assert callable(reg.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_new_files_are_found_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration, mix, cell and per-layer metric, as files
    cfg = json.loads((bench / "configs" / "smollm-360m.json").read_text())
    cfg["name"] = "smollm-360m-b"
    (bench / "configs" / "smollm-360m-b.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train.full.json").read_text())
    mix["batch"] = 4
    (bench / "traffic" / "train.full_b4.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return run.counters.get('steps')\n")
    spec["configs"].append(dict(spec["configs"][0], name="smollm-360m-b",
                                file="bench/configs/smollm-360m-b.json"))
    spec["workloads"].append({"name": "smollm-360m-b.train.full_b4",
                              "config": "smollm-360m-b",
                              "traffic": "train.full_b4", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s.full":
            m["workloads"].append("smollm-360m-b.train.full_b4")
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train step",
                              "moves": "train_tokens_per_s.full",
                              "workloads": ["smollm-360m-b.train.full_b4",
                                            "smollm-360m.train.full"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(root)
    assert reg.config("smollm-360m-b")["name"] == "smollm-360m-b"
    assert reg.traffic("train.full_b4")["batch"] == 4
    names = [m["name"] for m in reg.per_layer("smollm-360m-b.train.full_b4")]
    # a metric goes to the cells it lists, the new one and the old ones
    assert "steps_seen" in names
    assert "steps_seen" in [m["name"] for m in
                            reg.per_layer("smollm-360m.train.full")]
    assert "steps_seen" not in [m["name"] for m in
                                reg.per_layer("smollm-360m.train.offload")]
    assert reg.reader("steps_seen")(Run(counters={"steps": 7})) == 7


def _run(trace):
    r = Run(e2e={"train_tokens_per_s.offload": 1.5, "peak_device_gib": 2.0,
                 "setup_s": 3.0}, window_s=40.0,
            counters={"steps": 6, "host_flops": 2e15, "host_s": 8.0,
                      "offload_bytes": 30, "traced_steps": 2},
            checks=[("grad_gap", 0.001, 0.005), ("change_gap", 0.01, 0.05)],
            attempted=3, peak_bytes=2 ** 31)
    if trace:
        r.trace = {"busy_s": 3.0, "window_s": 4.0,
                   "ops": {"Memcpy HtoD (Pinned -> Device)": 0.002, "k": 2.9},
                   "idle": {"train_step": 1.0}}
    return r


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    reg = Registry(ROOT)
    res = bench_run.build_result(reg, "smollm-360m.train.offload",
                                 _run(trace), trace, "NVIDIA H100", 1)
    res = json.loads(json.dumps(res))
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 2 ** 31
    if trace:
        assert dev["busy_s"] == 3.0 and dev["window_s"] == 4.0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        m = res["metrics"]
        # 1.5 s of device work a traced step, 2 s a step after the trace
        assert m["idle_share.train.offload"]["value"] == pytest.approx(25.0)
        assert m["memcpy_ms_per_step"]["value"] == pytest.approx(1.0)
        assert m["offload_bytes_per_step"]["value"] == 5
        assert m["mfu.train.offload"]["unit"] == "%"
        assert "planner_s" not in m           # nothing to read: left out
    else:
        assert set(res["metrics"]) == {"train_tokens_per_s.offload",
                                       "peak_device_gib", "setup_s"}
        assert "breakdown" not in res
    assert res["checks"]["grad_gap"] == {"value": 0.001, "limit": 0.005}


def test_a_failed_check_is_not_correct():
    r = _run(False)
    r.checks[1] = ("change_gap", 1.0, 0.05)
    assert not r.correct
    r.checks[1] = ("change_gap", float("nan"), 0.05)
    assert not r.correct

