"""Batched searches through the library's entry, `IVFIndex.search`.

Set-up: the configuration's rows made on the card from the seed and held
on the host, packed (codes, scale, offset, reciprocal norm) as a library
caller holds them; an `IVFIndex` built from them with the seed's
centroids and assignments; a pool of queries; one search of every batch.

Window: one caller calls `IVFIndex.search(batch, k, nprobe, refine)` back
to back, each call on the next host-resident f32 batch of the pool in an
order drawn from the seed, until the window's seconds have passed; the
call in progress then finishes and counts. Each call uploads its queries
and brings back its answers. search_qps = queries answered / seconds.

Answers: the answers of `sample_calls` calls, drawn from the seed by a
reservoir over all calls, against the reference's top k (vsbench/checks).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from vsbench import checks, corpus, roofline
from vsbench.harness import Outcome
from vsbench.reference import ivf as ref_ivf

REF_SLAB = 250_000  # rows a slab of the reference's float64 search


def load_kernels(dev) -> None:
    """Build (nvcc, a checkout's first run) or load the program's kernel
    library before anything is timed."""
    if dev.type == "cuda":
        from vectorsearch_tpu_torch.kernels import _build

        _build.load()


def dequantize(packed, idx: np.ndarray) -> np.ndarray:
    """Packed host rows idx as float64 vectors (offset + scale * code)."""
    codes, scale, offset = packed[0], packed[1], packed[2]
    return offset[idx, None].astype(np.float64) + scale[idx, None].astype(np.float64) * codes[idx]


def slabs(packed, dev, step: int = REF_SLAB):
    """(start, float64 rows on dev) of every packed host row."""
    codes, scale, offset = packed[0], packed[1], packed[2]
    for start in range(0, codes.shape[0], step):
        end = min(start + step, codes.shape[0])
        c = torch.from_numpy(codes[start:end]).to(dev).double()
        s = torch.from_numpy(scale[start:end]).to(dev).double()
        o = torch.from_numpy(offset[start:end]).to(dev).double()
        yield start, o[:, None] + s[:, None] * c


def make_inputs(cell):
    """(recipe, packed host rows, members, centroids, query pool)."""
    recipe = corpus.Recipe.of(cell.config)
    gen = corpus.Corpus(recipe, cell.seed, cell.dev)
    packed, members = corpus.packed_rows(gen)
    pool = corpus.query_pool(recipe, cell.seed, int(cell.traffic["query_pool"]),
                             lambda idx: dequantize(packed, idx))
    return recipe, packed, members, gen.centroids(), pool


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.index import IVFIndex
    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    tr = cell.traffic
    recipe, packed, members, centroids, pool = make_inputs(cell)
    if cell.dev.type == "cuda":
        torch.cuda.synchronize(cell.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.dev)
    load_kernels(cell.dev)
    ivf = IVFIndex.build(PackedVectors(*packed), np.arange(recipe.n, dtype=np.int64), centroids,
                         assignments=members, device=cell.dev)
    b = int(tr["batch"])
    batches = pool.reshape(-1, b, recipe.dim)
    st = {"recipe": recipe, "packed": packed, "members": members, "centroids": centroids,
          "batches": batches, "order": corpus.order(cell.seed, len(batches)), "ivf": ivf}
    for q in batches:  # every batch's shapes, once
        search(st, tr, q)
    return st


def search(st, tr, q):
    return st["ivf"].search(q, k=int(tr["k"]), nprobe=int(tr["nprobe"]), refine=int(tr["refine"]))


def window(st, cell, win) -> Outcome:
    tr = cell.traffic
    order, batches = st["order"], st["batches"]
    keep = int(tr["sample_calls"])
    rng = np.random.default_rng(corpus.sub_seed(cell.seed, 5))
    sample, calls, failed, first_error = [], 0, 0, None
    counts = np.zeros(len(batches), np.int64)
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
        counts[bi] += 1
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
        print(f"library: {failed} failed calls, the first: {first_error}", file=sys.stderr)
    st["sample"] = sample
    b = batches.shape[1]
    layer = {"calls": calls, "batch_calls": counts}
    if win.trace_on:
        layer["scan_work"] = scan_work(st, tr, counts)
    return Outcome(attempted=calls * b, failed=failed * b,
                   e2e={"search_qps": (calls - failed) * b / win.seconds}, layer=layer)


def scan_work(st, tr, counts) -> tuple[float, float]:
    """(bytes, operations) of the window's scans, counted from the
    algorithm: each batch's probe sets worked out plainly from the seed's
    centroids, times the calls made on that batch."""
    cluster_rows = np.bincount(st["members"], minlength=len(st["centroids"]))
    total_b = total_o = 0.0
    for bi, n_calls in enumerate(counts):
        if n_calls:
            probed = ref_ivf.probe(st["batches"][bi], st["centroids"], int(tr["nprobe"]), "cpu")
            b, o = roofline.scan_work(probed, cluster_rows, st["recipe"].dim, int(tr["refine"]))
            total_b += n_calls * b
            total_o += n_calls * o
    return total_b, total_o


def release(st) -> None:
    ivf = st.pop("ivf", None)
    if ivf is not None:
        ivf.release_device()
    del ivf
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(st, cell, precision):
    tr = cell.traffic
    queries = np.concatenate([st["batches"][bi] for bi, _, _ in st["sample"]])
    sims, rows = ref_ivf.search(queries, st["centroids"], st["members"],
                                slabs(st["packed"], cell.dev), int(tr["nprobe"]), int(tr["k"]),
                                cell.dev, precision)
    return queries, sims, rows


def _judge(st, queries, served_sims, served_rows, ref_sims):
    return checks.judge_search(served_rows, served_sims, queries,
                               lambda idx: dequantize(st["packed"], idx), ref_sims,
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
