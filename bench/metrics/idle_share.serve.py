"""idle_share.serve: the device's idle share of the traced serving
window (``readers.idle_share_traced``); the profiler slows the
device-paced decode step by under 3 %."""
from benchkit.readers import idle_share_traced as read  # noqa: F401
