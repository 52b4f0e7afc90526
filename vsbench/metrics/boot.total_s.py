"""Seconds the engine's boot of the served category took, as the engine
splits it (`Engine.stats()` category `boot`: SQL stream, pack, index build,
snapshot), summed."""


def read(r):
    boot = r.outcome.layer.get("boot") or {}
    parts = [v for k, v in boot.items() if k.endswith("_s")]
    return sum(parts) if parts else None
