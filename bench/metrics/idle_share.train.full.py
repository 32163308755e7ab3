"""idle_share.train.full: the device's idle share of an untraced full step
(``readers.idle_share_per_step``)."""
from benchkit.readers import idle_share_per_step as read  # noqa: F401
