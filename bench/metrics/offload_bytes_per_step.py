"""offload_bytes_per_step: the bytes the offload layer's carries moved to
pinned host memory and back (``core.offload.traffic``, d2h + h2d) per
train step of the window."""


def read(run):
    steps = run.counters.get("steps")
    moved = run.counters.get("offload_bytes")
    if not steps or not moved:
        return None
    return moved / steps
