"""mfu.train.offload: the offload cell's model FLOPs a second as a share of
the bf16 peak (``readers.mfu``)."""
from benchkit.readers import mfu as read  # noqa: F401
