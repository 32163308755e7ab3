"""idle_share.train.offload: the device's idle share of an untraced offload
step (``readers.idle_share_per_step``)."""
from benchkit.readers import idle_share_per_step as read  # noqa: F401
