"""planner_s: host seconds of the cell's profile and plan calls
(``core/profiler``, ``runtime.plan`` on ``H100_COST``; for serving
``serve_trace_for`` too), from the harness's "plan" span."""


def read(run):
    d = run.spans.durations.get("plan") if run.spans else None
    return sum(d) if d else None
