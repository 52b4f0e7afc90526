"""Writes between batched searches: `IVFIndex.insert` beside
`IVFIndex.search`, one caller.

Set-up: the configuration's base rows, centroids, assignments and query
pool as the library cells make them (`library.make_inputs`); a stream of
`stream_pool` new rows of the same law, drawn on the card from the
seed's upload stream and packed, with their members; for each write the
read-your-writes queries (its first `rw_queries` rows plus query_noise
gaussian noise); the library cells' `IVFIndex` of the base rows; one
search of every batch; one write and one search of its result, which is
then dropped.

Window: the caller searches as the library driver does,
`IVFIndex.search(batch, k, nprobe, refine)` on the pool's batches in the
seed's order, and after every `calls_per_write` calls writes the stream's
next `write_rows` rows, `ivf = ivf.insert(rows, ids)`, keeping only the
new index. In the call after a write the batch's first `rw_queries`
queries are that write's read-your-writes queries; the batch's shape
stays. A window that uses up the stream searches on without writes and
says so on stderr. search_qps = queries answered / seconds, the writes'
time inside the seconds; attempted counts each query and each row
written. Traced, the window also returns `scan_work`, counted as the
library driver counts it, over the rows live at each call.

Answers: `write_missing`, the read-your-writes queries of every call
after a write whose own row is not at rank 1; and the answers of
`sample_calls` calls, drawn from the seed by a reservoir over the calls
that follow a write, each against the reference over the rows live at
that call (vsbench/reference/stream.py, reference/ivf.py, vsbench/checks).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from vsbench import checks, corpus, roofline
from vsbench.drivers import library
from vsbench.harness import Outcome
from vsbench.reference import ivf as ref_ivf
from vsbench.reference import stream as ref_stream


def stream_rows(gen: corpus.Corpus, size: int):
    """`size` new rows of gen's law, packed as host arrays, and their
    members int32 [size]: made on gen's device a slab at a time from the
    seed's upload stream."""
    r, dev = gen.recipe, gen.dev
    g = torch.Generator(device=dev).manual_seed(corpus.sub_seed(gen.seed, corpus.UPLOADS))
    out = (np.empty((size, r.dim), np.int8), np.empty(size, np.float32),
           np.empty(size, np.float32), np.empty(size, np.float32))
    members = np.empty(size, np.int32)
    for lo in range(0, size, corpus.SLAB):
        m = min(corpus.SLAB, size - lo)
        member = torch.multinomial(gen.weights, m, replacement=True, generator=g)
        v = torch.randn((m, r.dim), generator=g, device=dev)
        v += gen.centers[member] * r.center_scale
        for dst, src in zip(out, corpus.pack(v)):
            dst[lo : lo + m] = src.cpu().numpy()
        members[lo : lo + m] = member.cpu().numpy()
    return out, members


def rw_queries(gen: corpus.Corpus, stream, writes: int, rows_per_write: int, n_rw: int):
    """f32 [writes, n_rw, D]: each write's first n_rw rows as packed, plus
    query_noise gaussian noise drawn on gen's device from the seed."""
    r, dev = gen.recipe, gen.dev
    g = torch.Generator(device=dev).manual_seed(corpus.sub_seed(gen.seed, corpus.UPLOADS, 1))
    idx = (np.arange(writes)[:, None] * rows_per_write + np.arange(n_rw)).reshape(-1)
    codes, scale, offset = (torch.from_numpy(a[idx]).to(dev).double() for a in stream[:3])
    v = offset[:, None] + scale[:, None] * codes
    v += torch.randn(v.shape, generator=g, device=dev, dtype=torch.float64) * r.query_noise
    return v.float().cpu().numpy().reshape(writes, n_rw, r.dim)


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.index import IVFIndex
    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    tr = cell.traffic
    rows_w, n_rw = int(tr["write_rows"]), int(tr["rw_queries"])
    recipe, packed, members, centroids, pool = library.make_inputs(cell)
    gen = corpus.Corpus(recipe, cell.seed, cell.dev)  # the same directions and weights
    stream, stream_members = stream_rows(gen, int(tr["stream_pool"]))
    writes = len(stream_members) // rows_w
    rw = rw_queries(gen, stream, writes, rows_w, n_rw)
    del gen
    if cell.dev.type == "cuda":
        torch.cuda.synchronize(cell.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.dev)
    library.load_kernels(cell.dev)
    ivf = IVFIndex.build(PackedVectors(*packed), np.arange(recipe.n, dtype=np.int64), centroids,
                         assignments=members, device=cell.dev)
    b = int(tr["batch"])
    batches = pool.reshape(-1, b, recipe.dim)
    st = {"recipe": recipe, "packed": packed, "members": members, "centroids": centroids,
          "stream": stream, "stream_members": stream_members, "rows_w": rows_w,
          "writes_max": writes, "rw": rw,
          "batches": batches, "order": corpus.order(cell.seed, len(batches)), "ivf": ivf}
    for q in batches:  # every batch's shapes, once
        library.search(st, tr, q)
    # one write and a search of its result, with the stream's first rows:
    # the write path's shapes, then the result goes
    warm = {**st, "ivf": write(st, 0)}
    library.search(warm, tr, rw_batch(st, batches[0], 0))
    del warm
    gc.collect()
    return st


def write(st, w: int):
    """The index after write w: the stream's rows w * rows_w on, with
    the ids that follow the rows before them."""
    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    lo = w * st["rows_w"]
    rows = PackedVectors(*[a[lo : lo + st["rows_w"]] for a in st["stream"]])
    return st["ivf"].insert(rows, st["recipe"].n + np.arange(lo, lo + st["rows_w"]))


def rw_batch(st, q: np.ndarray, w: int) -> np.ndarray:
    """Batch q with its first queries replaced by write w's
    read-your-writes queries."""
    rw = st["rw"][w]
    q = q.copy()
    q[: len(rw)] = rw
    return q


def window(st, cell, win) -> Outcome:
    tr = cell.traffic
    order, batches = st["order"], st["batches"]
    every, rows_w = int(tr["calls_per_write"]), st["rows_w"]
    keep = int(tr["sample_calls"])
    rng = np.random.default_rng(corpus.sub_seed(cell.seed, 5))
    sample, seen, rw_top = [], 0, []
    calls = writes = failed_calls = failed_writes = 0
    after, first_error, told = None, None, False
    log = []  # each call's (batch, writes before it, its read-your-writes' write or -1)
    win.start()
    t_end = win.end(cell.seconds)
    while True:
        bi = int(order[calls % len(order)])
        q = batches[bi] if after is None else rw_batch(st, batches[bi], after)
        try:
            scores, ids = library.search(st, tr, q)
        except Exception as e:  # a failed call counts; the loop goes on
            failed_calls += 1
            first_error = first_error or repr(e)
            scores = ids = None
        calls += 1
        log.append((bi, writes, -1 if after is None else after))
        if after is not None:
            n_rw = len(st["rw"][after])
            rw_top.append((after, None if ids is None else ids[:n_rw, 0].copy()))
            if scores is not None:  # reservoir sampling of the calls after a write
                seen += 1
                entry = (q, writes, scores, ids)
                if len(sample) < keep:
                    sample.append(entry)
                else:
                    j = int(rng.integers(0, seen))
                    if j < keep:
                        sample[j] = entry
            after = None
        if time.perf_counter() >= t_end:
            break
        if calls % every:
            continue
        if writes < st["writes_max"]:
            try:
                st["ivf"] = write(st, writes)
                after, writes = writes, writes + 1
            except Exception as e:  # a failed write counts; its rows are tried again
                failed_writes += 1
                first_error = first_error or repr(e)
        elif not told:
            told = True
            print(f"stream: the stream's {writes} writes are used up after {calls} calls; "
                  "searching on without writes", file=sys.stderr)
        if time.perf_counter() >= t_end:
            break
    win.stop()
    if first_error:
        print(f"stream: {failed_calls} failed calls, {failed_writes} failed writes, "
              f"the first: {first_error}", file=sys.stderr)
    print(f"stream: {calls} calls, {writes} writes of {rows_w} rows in {win.seconds:.3f} s",
          file=sys.stderr)
    st["sample"], st["rw_top"] = sample, rw_top
    b = batches.shape[1]
    layer = {"calls": calls, "writes": writes}
    if win.trace_on:
        layer["scan_work"] = scan_work(st, tr, log)
    return Outcome(attempted=calls * b + (writes + failed_writes) * rows_w,
                   failed=failed_calls * b + failed_writes * rows_w,
                   e2e={"search_qps": (calls - failed_calls) * b / win.seconds},
                   layer=layer)


def scan_work(st, tr, log) -> tuple[float, float]:
    """(bytes, operations) of the window's scans, counted from the
    algorithm as `library.scan_work` counts them: each call's probe sets
    worked out plainly from the seed's centroids (the read-your-writes
    queries' own in the calls after a write), over the rows live at that
    call."""
    nprobe, dim, n_rw = int(tr["nprobe"]), st["recipe"].dim, st["rw"].shape[1]
    k_all = len(st["centroids"])
    probed = {int(bi): ref_ivf.probe(st["batches"][bi], st["centroids"], nprobe, "cpu")
              for bi in {bi for bi, _, _ in log}}
    written = sorted({w for _, _, w in log if w >= 0})
    rw_probed = dict(zip(written, ref_ivf.probe(
        st["rw"][written].reshape(-1, dim), st["centroids"], nprobe, "cpu"
    ).reshape(len(written), n_rw, nprobe))) if written else {}
    rows, at = np.bincount(st["members"], minlength=k_all), 0
    total_b = total_o = 0.0
    for bi, writes, w in log:  # in the window's order: the writes only add rows
        if writes > at:
            added = st["stream_members"][at * st["rows_w"] : writes * st["rows_w"]]
            rows, at = rows + np.bincount(added, minlength=k_all), writes
        p = probed[bi]
        if w >= 0:
            p = np.concatenate([rw_probed[w], p[n_rw:]])
        b, o = roofline.scan_work(p, rows, dim, int(tr["refine"]))
        total_b += b
        total_o += o
    return total_b, total_o


release = library.release


def write_missing(st, tops) -> int:
    """Read-your-writes queries whose own row is not the first answer:
    tops holds (write, the first answer's id of each, or None where the
    call failed)."""
    missing = 0
    for w, top in tops:
        # write w's first rows, whose ids follow the rows before them
        want = st["recipe"].n + w * st["rows_w"] + np.arange(len(st["rw"][w]))
        missing += len(want) if top is None else int((top != want).sum())
    return missing


def _judged(st, cell, precision: str) -> tuple[dict, list]:
    """The sampled calls judged against the reference over the rows live
    at each (with `precision`'s answers in the program's place unless it
    is f64): the readings, and each call's (write, first answers' ids)."""
    tr = cell.traffic
    out = {"sim_err": 0.0, "topk_gap": 0.0, "bad_answers": 0}
    tops = []
    for q, writes, scores, ids in st["sample"]:
        live = ref_stream.n_live(st["recipe"].n, st["rows_w"], writes)
        owed = ref_stream.members(st["members"], st["stream_members"], live)

        def ref(p):
            return ref_ivf.search(q, st["centroids"], owed,
                                  ref_stream.slabs(st["packed"], st["stream"], live, cell.dev),
                                  int(tr["nprobe"]), int(tr["k"]), cell.dev, p)

        ref_sims, _ = ref("f64")
        if precision != "f64":
            scores, ids = ref(precision)
        got = checks.judge_search(
            ids, scores, q, lambda idx: ref_stream.rows_f64(st["packed"], st["stream"], idx),
            ref_sims, live)
        out["sim_err"] = max(out["sim_err"], got["sim_err"])
        out["topk_gap"] = max(out["topk_gap"], got["topk_gap"])
        out["bad_answers"] += got["bad_answers"]
        tops.append((writes - 1, ids[: len(st["rw"][writes - 1]), 0]))
    return out, tops


def answers(st, cell) -> dict:
    """The program's answers: read-your-writes over every call after a
    write, and the sampled calls against the reference."""
    missing = write_missing(st, st["rw_top"])
    if not st["sample"]:
        return {"sim_err": float("inf"), "topk_gap": float("inf"), "bad_answers": 1,
                "write_missing": missing}
    out, _ = _judged(st, cell, "f64")
    return {**out, "write_missing": missing}


def control(st, cell) -> dict:
    """The control in the program's place: the reference's answers to the
    sampled calls' queries in TF32 over the same live rows, judged the same
    way (read-your-writes over those calls)."""
    out, tops = _judged(st, cell, "tf32")
    return {**out, "write_missing": write_missing(st, tops)}
