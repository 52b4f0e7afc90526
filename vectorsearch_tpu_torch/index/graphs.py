"""CUDA graphs of `IVFIndex.search`'s device chain, one per call shape.

Between the queries' upload and the one read of the answers, a search on
the card is a fixed chain of ~130 launches (probe, group build, the scan
kernel, the exact epilogue, the refine, the id map) whose every buffer is
sized from the call's shape alone. The host issues them one by one, and
the card idles while it does. A graph records the chain once and replays
it with one launch.

The policy (`plan`) decides from what a call can observe: CUDA tensors, a
probed (not exhaustive) search, no out-of-memory memo for the nprobe, and
a shape whose eager run already succeeded on this index without a retry.
The first sighting of a shape runs eagerly; the second runs eagerly on the
capture stream (the warm-up: its answers are the call's) and records the
graph; later ones replay it. A capture costs a few eager calls of its
shape, so the graphs pay where shapes repeat: a fixed batch, or a
batcher's few padded classes.

`GraphCache` is an index instance's. Writes that change only the spill
tail hand it on (`IVFIndex._with_spill`); writes that change the buckets
return instances with a successor that holds no graphs but shares the
`Shared` part: the lock, the capture stream and the memory pool. All the
graphs of an index's instances draw on that one pool, and so does each
capture's warm-up, so their transients cost about one call's worth,
however many shapes and writes there are. A cache holds at most `GRAPHS`
graphs, least recently used out. A shape whose graph went out stays eager
on the instance: each shape is captured at most once, so more shapes than
the cache holds, taking turns, leave the rest eager instead of making
every call a capture. The lock is held from the copy into a graph's static
input until the answers are read back: replays of one index never
overlap, and a graph's outputs are read before any other graph of the
pool runs.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"

# graphs an index holds: the served batcher's four padded batch classes
# (engine/batcher.py) at two candidate classes or two nprobes
GRAPHS = 8
SEEN = 64  # shapes an index remembers having run eagerly


class Key(NamedTuple):
    """The shape of a search call on the device: everything that sizes a
    buffer or picks an op of the chain."""

    b: int  # query rows
    nprobe: int
    k: int
    refine: int
    epilogue: str  # as the call resolves it, after the out-of-memory memo
    b_max: int  # rows a dispatch, after the out-of-memory memo


def plan(key: Key, *, cuda: bool, exhaustive: bool, memoized: bool,
         seen, held, refused) -> str:
    """What a search call of shape `key` does: EAGER, CAPTURE or REPLAY.

    cuda: the queries are on a card. exhaustive: nprobe covers every
    cluster (the streamed scan, never graphed). memoized: an out-of-memory
    retry left a memo for this nprobe. seen: shapes whose eager run
    succeeded without a retry; held: shapes with a graph; refused: shapes
    that stay eager (their capture ran out of memory, or their graph was
    evicted)."""
    if not cuda or exhaustive or memoized or key in refused:
        return EAGER
    if key in held:
        return REPLAY
    if key in seen:
        return CAPTURE
    return EAGER


class Entry(NamedTuple):
    """A captured chain: replay `graph`, read `outputs`. `static_q` is its
    input, `scans` the scan kernel's launches the capture recorded."""

    graph: object  # torch.cuda.CUDAGraph
    static_q: object
    outputs: tuple
    scans: int


class Shared:
    """What an index's instances share along its writes. `anchor`, the
    newest graph, keeps the pool open: a capture into a pool that no live
    graph uses fails (the pinned-memory allocator has closed it), and the
    instances whose graphs used it may all be gone."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None  # the capture stream, made at the first capture
        self.anchor = None  # dropped before the pool (attributes go in order)
        self.pool = None  # a torch.cuda.MemPool, made at the first capture


class GraphCache:
    """One index instance's graphs (see the module's docstring)."""

    def __init__(self, shared: Shared | None = None):
        self.held: OrderedDict = OrderedDict()  # goes before the pool it uses
        self.seen: OrderedDict = OrderedDict()
        self.refused: set = set()
        self._seen_lock = threading.Lock()  # eager calls write `seen` unlocked
        self.shared = shared or Shared()
        self.lock = self.shared.lock

    def successor(self) -> "GraphCache":
        """The cache of an instance whose buckets a write changed: no
        graphs or shapes, the same lock, stream and pool."""
        return GraphCache(self.shared)

    def saw(self, key: Key) -> None:
        """Record that an eager run of `key` succeeded without a retry."""
        with self._seen_lock:
            self.seen[key] = None
            self.seen.move_to_end(key)
            while len(self.seen) > SEEN:
                self.seen.popitem(last=False)

    def get(self, key: Key):
        """The graph of `key` (most recently used now), or None."""
        entry = self.held.get(key)
        if entry is not None:
            self.held.move_to_end(key)
        return entry

    def put(self, key: Key, entry) -> None:
        """Hold `entry` for `key`. Past `GRAPHS`, the least recently used
        graphs go, and their shapes stay eager."""
        self.held[key] = entry
        self.held.move_to_end(key)
        while len(self.held) > GRAPHS:
            self.refused.add(self.held.popitem(last=False)[0])

    def refuse(self, key: Key) -> None:
        """`key`'s capture failed: it stays eager on this instance."""
        self.refused.add(key)

    def clear(self) -> None:
        """Drop every graph, and the pool once the graphs that use it are
        gone (the index frees its buffers)."""
        with self.lock, self._seen_lock:
            self.held.clear()
            self.seen.clear()
            self.shared.anchor = self.shared.pool = None
