"""Query rows a device dispatch of the engine's batcher served over the
window (engine/batcher.py, `Engine.stats()["batcher"]`'s difference):
how far concurrent single-query searches coalesce."""


def read(r):
    b = r.outcome.layer.get("batcher")
    if not b or not b.get("dispatches"):
        return None
    return b["rows_served"] / b["dispatches"]
