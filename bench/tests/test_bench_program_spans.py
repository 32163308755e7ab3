"""The program's own spans (``repro_torch.telemetry``) appended to the
intervals ``trace.summarize`` names idle gaps by: the device's busy time,
its time by operation and every accepted per-layer metric read from the
summary stay as they are; the idle seconds move from the harness's span to
the program's spans inside it and still sum to the window less the busy
time."""
import pytest

from benchkit import trace
from benchkit.core import Run
from benchkit.registry import Registry

# microseconds: a window of two traced steps, each with a host gap in the
# forward, one in AdamW and one where a block's backward waits on a fetch
DEVICE = [(10, 40, "gemm"), (55, 90, "elementwise"), (95, 100, "Memcpy HtoD"),
          (120, 150, "paged_split_kernel"), (165, 190, "elementwise"),
          (192, 196, "paged_combine_kernel")]
HARNESS = [(0, 200, "window"), (0, 100, "traced_step"),
           (100, 200, "traced_step")]
PROGRAM = [(0, 45, "train.forward"), (45, 93, "train.backward"),
           (91, 93, "offload.fetch"), (93, 100, "train.adamw"),
           (100, 145, "train.forward"), (145, 180, "train.backward"),
           (180, 200, "train.adamw")]


def summaries():
    return (trace.summarize(DEVICE, 0, 200, HARNESS),
            trace.summarize(DEVICE, 0, 200, HARNESS + PROGRAM))


def test_busy_and_ops_unchanged_idle_moves_inside():
    before, after = summaries()
    for k in ("busy_s", "window_s", "ops"):
        assert after[k] == before[k]
    for s in (before, after):
        assert sum(s["idle"].values()) == pytest.approx(
            s["window_s"] - s["busy_s"], abs=1e-12)
    assert set(before["idle"]) == {"traced_step"}
    # each gap piece goes to the innermost span: the forward 0-10, 40-45,
    # 100-120; the backward 45-55, 90-91, 150-165; the fetch 91-93; AdamW
    # 93-95, 190-192, 196-200
    idle = {k: round(v * 1e6, 9) for k, v in after["idle"].items()}
    assert idle == {"train.forward": 35, "train.backward": 26,
                    "offload.fetch": 2, "train.adamw": 8}


def test_accepted_metrics_read_the_same():
    reg = Registry()
    counters = {"traced_steps": 2, "steps": 6, "host_s": 0.0012,
                "host_flops": 1e9, "offload_bytes": 4e6, "cold_bytes": 3e6,
                "counted_decode_steps": 2, "k1_bound_s_traced": 2e-5}
    read = {}
    for summary in summaries():
        run = Run(counters=dict(counters), trace=summary)
        read[id(summary)] = {m["name"]: reg.reader(m["name"])(run)
                             for m in reg.spec["per_layer"]
                             if m["source"] == "device_trace"}
    before, after = read.values()
    assert before == after
    assert all(v is not None for v in before.values())
