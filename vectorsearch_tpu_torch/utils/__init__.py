from .errors import fresh_exc
from .profiling import device_memory_stats, device_trace, timed

__all__ = ["device_memory_stats", "device_trace", "fresh_exc", "timed"]
