"""Small cross-cutting helpers with no heavy imports."""
from __future__ import annotations


def fresh_exc(err: BaseException) -> BaseException:
    """A per-raiser copy of `err` (same type/args, chained to the
    original) for multi-waiter re-raise: CPython mutates __traceback__ on
    every raise, so N threads raising ONE shared instance interleave and
    garble each other's logged stacks (the hazard engine.UploadError was
    introduced for). Falls back to the original instance when the type
    cannot be reconstructed from args."""
    try:
        copy = type(err)(*err.args)
    except Exception:  # noqa: BLE001 - exotic ctor: shared instance it is
        return err
    copy.__cause__ = err
    return copy
