"""cold_bytes_per_step: the bytes of cold K/V pages mapped for the active
slots at each decode step of the window (every layer's), counted from the
page table, per decode step."""


def read(run):
    steps = run.counters.get("counted_decode_steps")
    if not steps:
        return None
    return run.counters["cold_bytes"] / steps
