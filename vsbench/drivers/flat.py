"""Batched exact searches through the library's flat entry, `FlatIndex.search`.

Set-up: the configuration's rows made on the card from the seed and held
on the host, packed (codes, scale, offset, reciprocal norm) as a library
caller holds them (`library.make_inputs`); one `FlatIndex` holding them on
the card (`FlatIndex.from_packed`); a pool of queries; one search of every
batch.

Window: one caller calls `FlatIndex.search(batch, k, refine=refine)` back
to back, each call on the next host-resident f32 batch of the pool in an
order drawn from the seed, until the window's seconds have passed; the
call in progress then finishes and counts. Each call uploads its queries
and brings back its answers. search_qps = queries answered / seconds.

Answers: the answers of `sample_calls` calls, drawn from the seed by a
reservoir over all calls, against the reference's exact top k over every
row (vsbench/reference/flat.py, vsbench/checks).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from vsbench import checks, corpus
from vsbench.drivers import library
from vsbench.flat_work import flat_work
from vsbench.harness import Outcome
from vsbench.reference import flat as ref_flat


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.index import FlatIndex
    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    recipe, packed, _, _, pool = library.make_inputs(cell)
    if cell.dev.type == "cuda":
        torch.cuda.synchronize(cell.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.dev)
    flat = FlatIndex.from_packed(PackedVectors(*packed), np.arange(recipe.n, dtype=np.int64),
                                 device=cell.dev)
    batches = pool.reshape(-1, int(cell.traffic["batch"]), recipe.dim)
    st = {"recipe": recipe, "packed": packed, "batches": batches,
          "order": corpus.order(cell.seed, len(batches)), "flat": flat}
    for q in batches:  # every batch's shapes, once
        search(st, cell.traffic, q)
    return st


def search(st, tr, q):
    return st["flat"].search(q, k=int(tr["k"]), refine=int(tr["refine"]))


def window(st, cell, win) -> Outcome:
    tr = cell.traffic
    order, batches = st["order"], st["batches"]
    keep = int(tr["sample_calls"])
    rng = np.random.default_rng(corpus.sub_seed(cell.seed, 5))
    sample, calls, failed, first_error = [], 0, 0, None
    win.start()
    t_end = win.end(cell.seconds)
    while True:
        bi = int(order[calls % len(order)])
        try:
            scores, ids = search(st, tr, batches[bi])
        except Exception as e:  # a failed call counts; the loop goes on
            failed += 1
            first_error = first_error or repr(e)
            scores = ids = None
        calls += 1
        if scores is not None:  # reservoir sampling of the calls' answers
            if len(sample) < keep:
                sample.append((bi, scores, ids))
            else:
                j = int(rng.integers(0, calls))
                if j < keep:
                    sample[j] = (bi, scores, ids)
        if time.perf_counter() >= t_end:
            break
    win.stop()
    if first_error:
        print(f"flat: {failed} failed calls, the first: {first_error}", file=sys.stderr)
    st["sample"] = sample
    b = batches.shape[1]
    layer = {"calls": calls}
    if win.trace_on:
        layer["flat_work"] = flat_work(st["recipe"].n, st["recipe"].dim, b, int(tr["k"]), calls)
    return Outcome(attempted=calls * b, failed=failed * b,
                   e2e={"search_qps": (calls - failed) * b / win.seconds}, layer=layer)


def release(st) -> None:
    st.pop("flat", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(st, cell, precision):
    queries = np.concatenate([st["batches"][bi] for bi, _, _ in st["sample"]])
    sims, rows = ref_flat.search(queries, library.slabs(st["packed"], cell.dev), st["recipe"].n,
                                 int(cell.traffic["k"]), cell.dev, precision)
    return queries, sims, rows


def _judge(st, queries, served_sims, served_rows, ref_sims):
    return checks.judge_search(served_rows, served_sims, queries,
                               lambda idx: library.dequantize(st["packed"], idx), ref_sims,
                               st["recipe"].n)


def answers(st, cell) -> dict:
    """The program's sampled answers against the reference."""
    if not st["sample"]:
        return {"sim_err": float("inf"), "topk_gap": float("inf"), "bad_answers": 1}
    queries, ref_sims, _ = _reference(st, cell, "f64")
    served_sims = np.concatenate([s for _, s, _ in st["sample"]])
    served_rows = np.concatenate([i for _, _, i in st["sample"]])
    return _judge(st, queries, served_sims, served_rows, ref_sims)


def control(st, cell) -> dict:
    """The control in the program's place: the reference's answers to the
    same queries in TF32, judged the same way."""
    queries, ref_sims, _ = _reference(st, cell, "f64")
    _, c_sims, c_rows = _reference(st, cell, "tf32")
    return _judge(st, queries, c_sims, c_rows, ref_sims)
