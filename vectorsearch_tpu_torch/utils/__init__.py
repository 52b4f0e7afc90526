from .profiling import device_memory_stats, device_trace, timed

__all__ = ["device_memory_stats", "device_trace", "timed"]
