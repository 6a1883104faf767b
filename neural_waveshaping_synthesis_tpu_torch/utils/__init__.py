"""Small utilities (counterpart of the JAX ``utils``): seeding, and the
profiling and debugging hooks of :mod:`.profiling`."""
from .profiling import StageTimer, debug_nans, differential_loop_ms, trace
from .utils import seed_all

__all__ = ["seed_all", "StageTimer", "debug_nans", "differential_loop_ms", "trace"]
