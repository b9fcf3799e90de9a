"""Host-side utilities: metrics logging and device-memory estimates
(``fit()``), and the profiling hooks (``trace``, ``benchmark_fn``)."""

from .profiling import benchmark_fn, trace

__all__ = ["benchmark_fn", "trace"]
