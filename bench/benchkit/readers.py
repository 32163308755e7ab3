"""The arithmetic that several per-layer metrics share; each metric's file
in ``bench/metrics/`` names the one it reads."""
from __future__ import annotations

from benchkit.flops import PEAK_BF16_FLOPS


def mfu(run):
    """The model FLOPs of the window's work (counted from shapes by
    ``benchkit.flops``) over the window's seconds (in a traced run, of the
    part after the trace, which the profiler slows), as a share of one
    H100's bf16 peak (989 TFLOP/s)."""
    f, s = run.counters.get("host_flops"), run.counters.get("host_s")
    if not f or not s:
        return None
    return 100.0 * f / (s * PEAK_BF16_FLOPS)


def idle_share_traced(run):
    """The share of the traced window in which no operation ran on the
    device: 1 - the union of device activity / the window."""
    t = run.trace
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def idle_share_per_step(run):
    """The share of an untraced step in which no operation ran on the
    device: 1 - the device's busy time per traced step / the host time per
    step after the trace.  For steps that all do the same work: the
    profiler slows the host's launches, not the device's operations."""
    t, c = run.trace, run.counters
    traced = c.get("traced_steps")
    after = c.get("steps", 0) - (traced or 0)
    if not t or not traced or after <= 0 or not c.get("host_s"):
        return None
    return 100.0 * (1.0 - (t["busy_s"] / traced) / (c["host_s"] / after))
