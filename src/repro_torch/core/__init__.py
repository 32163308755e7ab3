"""Workload tracers (the profiler's data-object model for training,
hmsim's trace model for serving), hardware specs and the page allocator
model (port of ``repro/core``).  The system itself — tier/object model,
policy registry, planner — lives in ``repro_torch.runtime``."""
