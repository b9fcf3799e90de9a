"""Host-side utilities: metrics logging and device-memory estimates
(``fit()``), the profiling hooks (``trace``, ``benchmark_fn``) and the
kernel build cache (``enable_compilation_cache``)."""

from .compile_cache import enable_compilation_cache
from .memory import estimate_render_memory, estimate_train_memory
from .profiling import benchmark_fn, trace

__all__ = ["benchmark_fn", "enable_compilation_cache",
           "estimate_render_memory", "estimate_train_memory", "trace"]
