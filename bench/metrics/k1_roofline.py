"""k1_roofline: the least time of the traced decode steps' paged decode
attention (kernel K1, ``kernels/csrc/paged_decode.cu``), counted from the
lengths and page table by ``flops.paged_decode_bound_s`` (hot KV at HBM's
peak, cold KV at PCIe Gen5 x16's, FLOPs at bf16's; the largest), as a share
of K1's device time in the trace (its split and combine kernels)."""
from benchkit.trace import device_seconds


def read(run):
    bound = run.counters.get("k1_bound_s_traced")
    if not run.trace or not bound:
        return None
    t = device_seconds(run.trace, "paged_split_kernel", "paged_combine_kernel")
    return 100.0 * bound / t if t else None
