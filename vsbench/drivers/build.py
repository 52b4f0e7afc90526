"""Back-to-back index builds through the library's `build_centroids`.

Set-up: the configuration's rows made on the card from the seed and held
on the host, packed, as the engine holds them before a rebuild; one build
(the shapes, the allocator, the kernel library).

Window: builds of the traffic file's arguments back to back, each from
the host rows (its upload included) to its centroids on the host, each
freed before the next starts, until the window's seconds have passed; the
build in progress then finishes and counts. build_s = seconds / builds.

Answers: one build drawn from the seed by a reservoir over the window's
builds, its last full Lloyd's pass against the reference's (vsbench/
checks.judge_pass). The pass's input centroids are read where the
program hands them to its pass (`kernels.kmeans.assign_accumulate`),
which the benchmark wraps for the run: the only way to hold an
assignment to the centroids that made it.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from vsbench import checks, corpus
from vsbench.drivers.library import load_kernels, slabs
from vsbench.harness import Outcome
from vsbench.reference import kmeans as ref_kmeans


class PassRecorder:
    """Wraps the program's Lloyd's pass entry: keeps the centroids of the
    last pass over all `n` rows, and (traced) each pass's (rows, K, D)."""

    def __init__(self, module, n: int):
        self.module, self.n = module, n
        self.orig = module.assign_accumulate
        self.last_centroids = None
        self.passes = []
        self.recording = False

    def __call__(self, rows, centroids, *args, **kwargs):
        if rows.codes.shape[0] == self.n:
            self.last_centroids = centroids
        if self.recording:
            self.passes.append((int(rows.codes.shape[0]), int(centroids.shape[0]),
                                int(rows.codes.shape[1])))
        return self.orig(rows, centroids, *args, **kwargs)

    def install(self):
        self.module.assign_accumulate = self

    def remove(self):
        self.module.assign_accumulate = self.orig


def setup(cell) -> dict:
    from vectorsearch_tpu_torch.kernels import kmeans as kmeans_kernels
    from vectorsearch_tpu_torch.quant.layout import PackedVectors

    recipe = corpus.Recipe.of(cell.config)
    packed, _ = corpus.packed_rows(corpus.Corpus(recipe, cell.seed, cell.dev))
    if cell.dev.type == "cuda":
        torch.cuda.synchronize(cell.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cell.dev)
    load_kernels(cell.dev)
    rec = PassRecorder(kmeans_kernels, recipe.n)
    rec.install()
    st = {"recipe": recipe, "packed": packed, "rows": PackedVectors(*packed), "rec": rec}
    build(st, cell)  # the shapes, once
    return st


def build(st, cell):
    """One build with the traffic file's arguments: (result on the host,
    the centroids its last full pass started from, as the program's tensor)."""
    from vectorsearch_tpu_torch.build import build_centroids

    a = cell.traffic["build"]
    n = st["recipe"].n
    k = int(a["k"])
    result = build_centroids(
        st["rows"], k=k, min_cluster_size=max(1, (n // k) // int(a["min_size_div"])),
        max_iters=int(a["max_iters"]), superset_iters=int(a["superset_iters"]),
        chunk=int(a["chunk"]), balance_rounds=int(a["balance_rounds"]), device=cell.dev)
    prev = st["rec"].last_centroids
    st["rec"].last_centroids = None
    return result, prev


def window(st, cell, win) -> Outcome:
    rng = np.random.default_rng(corpus.sub_seed(cell.seed, 6))
    kept, builds, failed, first_error = None, 0, 0, None
    st["rec"].recording = win.trace_on
    win.start()
    t_end = win.end(cell.seconds)
    while True:
        try:
            out = build(st, cell)
        except Exception as e:  # a failed build counts; the loop goes on
            failed += 1
            first_error = first_error or repr(e)
            out = None
        builds += 1
        if out is not None and (kept is None or int(rng.integers(0, builds)) == 0):
            kept = out  # a reservoir of one
        del out
        if time.perf_counter() >= t_end:
            break
    win.stop()
    st["rec"].recording = False
    if first_error:
        print(f"build: {failed} failed builds, the first: {first_error}", file=sys.stderr)
    st["kept"] = kept
    return Outcome(attempted=builds, failed=failed,
                   e2e={"build_s": win.seconds / max(1, builds - failed)},
                   layer={"builds": builds, "passes": list(st["rec"].passes)})


def release(st) -> None:
    st["rec"].remove()
    st.pop("rows", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _judge(st, cell, prev, centroids, assignments, counts) -> dict:
    return checks.judge_pass(lambda: slabs(st["packed"], cell.dev), prev, centroids,
                             assignments, counts, st["recipe"].n, cell.dev)


def answers(st, cell) -> dict:
    kept = st.get("kept")
    if kept is None or kept[1] is None:
        return {"assign_regret": float("inf"), "mean_err": float("inf"), "count_err": 1}
    result, prev = kept
    return _judge(st, cell, prev.cpu().numpy(), result.centroids, result.assignments,
                  result.counts)


def control(st, cell) -> dict:
    """The control in the program's place: the reference's pass from the
    same input centroids, one precision lower, judged the same way."""
    prev = st["kept"][1].cpu().numpy()
    cents, assign, counts = ref_kmeans.lloyd_pass(slabs(st["packed"], cell.dev), prev,
                                                  cell.dev, control=True)
    return _judge(st, cell, prev, cents, assign, counts)

