from .errors import fresh_exc
from .profiling import count, device_memory_stats, device_trace, snapshot, span

__all__ = ["count", "device_memory_stats", "device_trace", "fresh_exc", "snapshot", "span"]
