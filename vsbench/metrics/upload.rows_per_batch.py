"""Rows an index insert of the engine's upload batcher took over the
window (`Engine.stats()["upload_batcher"]`'s difference): how far
concurrent uploads coalesce into one insert."""


def read(r):
    b = r.outcome.layer.get("upload_batcher")
    if not b or not b.get("batches"):
        return None
    return b["rows"] / b["batches"]
