"""Utilities: benchmarking, compile cache, results/config writers,
profiling."""

from .benchmarking import time_op  # noqa: F401
from .compile_cache import enable_compile_cache  # noqa: F401
from .profiling import device_trace, stage_timer  # noqa: F401
from .results import append_results, dump_configuration, dump_model_summary  # noqa: F401
