"""The comparison that decides `correct`, shown to fail: the control (the
reference one precision lower, in the program's place) and faults planted
in the timed path under the harness must come out not correct, while the
program passes. At a tiny size on the CPU; the chip's readings at the
cells' own sizes, from `python3 -m vsbench.control`, are in PERF.md."""
import numpy as np
import pytest
import torch

from vsbench import checks
from vsbench.tests import tiny

SEARCH_CELLS = ["d10m-lib-b512-np8", "d1m-http-c4", "d1m-http-mixed"]


@pytest.mark.parametrize("name", SEARCH_CELLS + ["d10m-build"])
def test_control_fails_program_passes(name):
    result, check, ctrl = tiny.run(tiny.cell(name, seed=3, seconds=1), with_control=True)
    assert result["correct"], check
    assert not checks.passed(ctrl), ctrl


def _break_search(monkeypatch, fault):
    from vectorsearch_tpu_torch.index import IVFIndex

    orig = IVFIndex.search

    def search(self, queries, *a, **kw):
        scores, ids = orig(self, queries, *a, **kw)
        scores, ids = scores.copy(), ids.copy()
        if fault == "half_left_out":  # the batch's second half never answered
            half = len(ids) // 2
            scores[half:], ids[half:] = -np.inf, -1
        else:  # one answer altered where it is produced
            ids[0, 0] = ids[0, -1] if ids[0, -1] != ids[0, 0] else ids[0, 0] + 1
        return scores, ids

    monkeypatch.setattr(IVFIndex, "search", search)


@pytest.mark.parametrize("name", SEARCH_CELLS)
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_search_faults_fail(monkeypatch, name, fault):
    _break_search(monkeypatch, fault)
    result, check, _ = tiny.run(tiny.cell(name, seed=4, seconds=1))
    assert not result["correct"], check


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_build_faults_fail(monkeypatch, fault):
    from vectorsearch_tpu_torch.kernels import kmeans

    orig = kmeans.assign_accumulate

    def broken(rows, centroids, *a, **kw):
        sums, counts, cid = orig(rows, centroids, *a, **kw)
        if fault == "state_unchanged":  # the pass hands back its input centroids
            sums = centroids.float() * counts[:, None]
        elif fault == "half_left_out":  # the sums of half the rows, the mean over them
            half = type(rows)(*[t[: rows.codes.shape[0] // 2] for t in rows])
            sums, counts, _ = orig(half, centroids, *a, **kw)
        else:  # one row's assignment altered where it is produced
            cid = cid.clone()
            cid[0] = (cid[0] + 1) % centroids.shape[0]
        return sums, counts, cid

    monkeypatch.setattr(kmeans, "assign_accumulate", broken)
    result, check, _ = tiny.run(tiny.cell("d10m-build", seed=4, seconds=1))
    assert not result["correct"], check


def test_tf32_rounding():
    from vsbench.reference.ivf import round_tf32

    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, -3.0])
    assert round_tf32(x).tolist() == [1.0 + 2**-10 * 0, 1.0 + 2**-10, -3.0]
