"""decode_step_p50_ms: the median host time of the window's
``ContinuousBatcher.step`` calls that decoded, from the harness's
"decode_step" spans."""
from benchkit import stats


def read(run):
    d = run.spans.durations.get("decode_step") if run.spans else None
    return 1e3 * stats.median(d) if d else None
