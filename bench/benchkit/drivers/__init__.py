"""Cell drivers, one module a kind of cell, named by a traffic mix's
``driver`` key; each has ``run(cfg, mix, limits, seed, seconds, trace,
device, t_start) -> core.Run``."""
