"""memcpy_ms_per_step: device milliseconds of the host<->device copies in
the profiler's trace, per traced train step."""
from benchkit.trace import device_seconds


def read(run):
    steps = run.counters.get("traced_steps")
    if not run.trace or not steps:
        return None
    s = device_seconds(run.trace, "Memcpy HtoD", "Memcpy DtoH")
    return 1e3 * s / steps if s else None
