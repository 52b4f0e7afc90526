"""Grouped IVF bucket scan: probe, group build, the CUDA scan kernel and
the exact top-k epilogues.

Counterpart of vectorsearch_tpu/kernels/pallas_scan.py. The (query,
cluster) pairs of a batch are sorted by cluster and packed into groups of
QT query rows that share one cluster, so the rows of a group share one
read of that cluster's codes. The kernel (csrc/grouped_scan.cu) scores
every group against every slot of its bucket:

    scores[g, i, r] = a[c, r] * <qg[g, i], codes[c, r]> + qsum[g, i] * bv[c, r]
                      + bias[c, r]            (c = gcl[g])

and an epilogue reduces the [G, QT, cap] grid to each query's top-k:
`flat` (one exact top-k over nprobe * cap columns) or `blockexact` (a
block-max prefilter, then an exact top-k over the selected blocks), chosen
by `resolve_auto_epilogue`.

Not carried over from the TPU module: the epilogues the auto policy never
picks (pair, rowfirst, ileave, flatwide), VSTPU_BMAX_XLA,
VSTPU_APPROX_WIDE, debug_phase, and the lane-padded maxima and tile-major
output layout that served Mosaic's (8, 128) tiling, and the QT cap knob
(QT_MAX is the kernel's largest template). Every top-k is exact.
"""
from __future__ import annotations

import os

import torch

from ..device import check_exact_f32
from ..quant.layout import PackedVectors
from ..utils.profiling import count, span
from . import _build, cosine

# kernel launches since import (or since a caller reset it to 0): lets a
# run show that its main path went through the CUDA kernel
LAUNCHES = 0

EPILOGUES = ("auto", "flat", "blockexact")

# most query rows per group: the kernel's largest QT template (8, 16, 32)
QT_MAX = 32


def _default_epilogue() -> str:
    """Top-k epilogue: "auto" | "flat" | "blockexact" (VSTPU_EPILOGUE)."""
    epi = os.environ.get("VSTPU_EPILOGUE", "auto")
    if epi not in EPILOGUES:
        raise ValueError(f"VSTPU_EPILOGUE must be one of {EPILOGUES}, got {epi!r}")
    return epi


def resolve_auto_epilogue(
    nprobe: int, cap: int, approx: bool
) -> tuple[str, bool]:
    """The measured "auto" policy (see the call site's comment block for
    the A/B evidence): nprobe=1 keeps flat with the caller's approx
    choice; nprobe>1 forces an exact reduction and picks blockexact's
    block-max prefilter once the score-column count nprobe*cap clears
    32768 (flat's single monolithic top-k wins below). Factored out so
    the crossover is directly unit-testable."""
    if nprobe <= 1:
        return "flat", approx
    if nprobe * cap > 32768 and cap % 128 == 0:
        return "blockexact", False
    return "flat", False


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def group_qt(p: int, kk: int) -> int:
    """Rows per group: ~2x the mean pairs per cluster keeps most groups
    full (read amplification) without padding waste, within [8, QT_MAX]."""
    return max(8, min(QT_MAX, _next_pow2(-(-2 * p // kk))))


# ---------------------------------------------------------------- kernel


def grouped_scores_ref(
    qg, qsum, gcl, counts, codes, a, bv, bias, bs, want_bmax, gcount
):
    """Plain PyTorch version of the kernel, in full f32 (TF32 off): the
    codes and the bf16 query rows are widened to f32, whose products are
    exact. Chunked over groups: a gather of codes[gcl] at G~2000,
    cap=3072, D=768 would be 4.7 GB as int8.

    It scores every slot and needs `counts` for nothing; on CPU tensors it
    asserts the kernel's precondition on it (see grouped_scores). A group
    whose cluster id lies outside [0, K) scores -inf everywhere, as in the
    kernel. Groups at or past `gcount` (i32 [1]) are -inf here; the
    kernel leaves them unwritten, and nothing reads them."""
    g, qt, d = qg.shape
    kk, cap, _ = codes.shape
    if counts.device.type == "cpu":
        past = torch.arange(cap)[None, :] >= counts[:, None]
        assert bool(torch.isneginf(bias[past]).all()), (
            "grouped_scores: bias must be -inf at every slot at or past counts"
        )
    out = torch.empty((g, qt, cap), dtype=torch.float32, device=qg.device)
    step = max(1, (256 << 20) // max(1, cap * d * 4))
    check_exact_f32(qg)
    for g0 in range(0, g, step):
        gc = gcl[g0 : g0 + step].long()
        c = gc.clamp(0, kk - 1)
        dots = torch.bmm(
            qg[g0 : g0 + step].float(), codes[c].float().transpose(1, 2)
        )  # [gc, QT, cap]
        scores = (
            dots * a[c][:, None, :]
            + qsum[g0 : g0 + step][:, :, None] * bv[c][:, None, :]
            + bias[c][:, None, :]
        )
        rows = torch.arange(g0, g0 + gc.shape[0], device=gc.device)
        inside = (gc >= 0) & (gc < kk) & (rows < gcount.to(gc.device))
        out[g0 : g0 + step] = torch.where(inside[:, None, None], scores, cosine.NEG_INF)
    bmax = out.view(g, qt, cap // bs, bs).amax(dim=-1) if want_bmax else None
    return out, bmax


def grouped_scores(
    qg, qsum, gcl, counts, codes, a, bv, bias, bs: int, want_bmax: bool, gcount
):
    """Score every group's QT query rows against its cluster's bucket.

    qg bf16 [G, QT, D]; qsum f32 [G, QT]; gcl i32 [G]; counts i32 [K];
    codes i8 [K, cap, D]; a, bv, bias f32 [K, cap]. Returns (scores f32
    [G, QT, cap], bmax f32 [G, QT, cap // bs] or None). On CPU tensors this
    is grouped_scores_ref; on CUDA tensors it launches the kernel or raises.

    gcount: i32 [1] on the same device, the number of groups that count:
    G is a bound on it (build_groups'), the kernel's blocks of the groups
    at or past it return at once, and their rows of both outputs are left
    unwritten.

    Precondition: the sidecars are finite except that bias[c, r] is -inf at
    every slot r >= counts[c] (and at tombstones), which fold_sidecars
    guarantees. The kernel reads no code and no sidecar of a 128-column
    tile that starts at or past counts[c] and writes -inf there, which
    under the precondition is what the plain version computes. A group
    whose gcl lies outside [0, K) reads nothing and is -inf everywhere.
    """
    global LAUNCHES
    dev = _build.launch_device(
        "grouped_scores", (qg, qsum, gcl, gcount, counts, codes, a, bv, bias)
    )
    if dev is None:
        return grouped_scores_ref(
            qg, qsum, gcl, counts, codes, a, bv, bias, bs, want_bmax, gcount
        )
    g, qt, d = qg.shape
    kk, cap, dc = codes.shape
    _build.check_args("grouped_scores", {
        "qg": (qg, torch.bfloat16, (g, qt, d)),
        "qsum": (qsum, torch.float32, (g, qt)),
        "gcl": (gcl, torch.int32, (g,)),
        "gcount": (gcount, torch.int32, (1,)),
        "counts": (counts, torch.int32, (kk,)),
        "codes": (codes, torch.int8, (kk, cap, d)),
        "a": (a, torch.float32, (kk, cap)),
        "bv": (bv, torch.float32, (kk, cap)),
        "bias": (bias, torch.float32, (kk, cap)),
    })
    if qt not in (8, 16, 32):
        raise ValueError(f"grouped_scores: QT must be 8, 16 or 32, got {qt}")
    if d % 16 or cap % 64:
        raise ValueError(
            f"grouped_scores: needs D % 16 == 0 and cap % 64 == 0, got D={d} cap={cap}"
        )
    if bs not in (64, 128) or (want_bmax and cap % bs):
        raise ValueError(f"grouped_scores: block size {bs} does not tile cap={cap}")
    out = torch.empty((g, qt, cap), dtype=torch.float32, device=dev)
    bmax = (
        torch.empty((g, qt, cap // bs), dtype=torch.float32, device=dev)
        if want_bmax else None
    )
    if g == 0:
        return out, bmax
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vs_grouped_scores(
            qg.data_ptr(), qsum.data_ptr(), gcl.data_ptr(), gcount.data_ptr(),
            counts.data_ptr(),
            codes.data_ptr(), a.data_ptr(), bv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bmax.data_ptr() if bmax is not None else None,
            g, qt, d, kk, cap, bs, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_scores: kernel launch failed, cudaError {err}")
    LAUNCHES += 1
    return out, bmax


# ------------------------------------------------------------ group build


def host_waits():
    """The span `ivf.sync` around a point of a search where the host waits
    on the card (a device read, or a copy or op that synchronizes), and
    one more on the counter `ivf.syncs`."""
    count("ivf.syncs")
    return span("ivf.sync")


def group_bound(p: int, qt: int, n_ids: int) -> int:
    """Most groups that p pairs over n_ids distinct cluster ids can make:
    a cluster's m pairs fill ceil(m / QT) <= m // QT + 1 groups, so the sum
    is at most ceil(p / QT) plus the distinct clusters, and never more than
    one group a pair (pallas_scan.py's g_max, capped at p)."""
    return min(p, -(-p // qt) + min(n_ids, p))


def build_groups(probed: torch.Tensor, kk: int, masked: bool = False):
    """Pack (query, cluster) pairs into groups of at most QT rows that
    share one cluster (pallas_scan.py:385-443, with a stable sort). The
    outputs are sized by group_bound from the shape alone, as the JAX
    package's g_max, so nothing is read back to the host: the exact count
    stays on the device.

    probed: cluster ids in [0, K), or in [0, K] when `masked` (grouped_scan
    puts the pairs of probe_valid False under the id K).

    Returns (qt, grp_cluster i32 [G], qidx i64 [G, QT], pair_slot i64 [P],
    gcount i32 [1]) with G = group_bound(P, QT, K or K + 1). The first
    gcount groups are the real ones, in the order of their clusters; the
    padding groups after them carry the cluster id K and query 0. pair_slot
    maps flat pair b*nprobe+j to its row of the [G * QT, cap] score grid;
    it never selects a padding group, nor an unused row of the last group
    of a cluster (those point at query 0)."""
    b, nprobe = probed.shape
    p = b * nprobe
    dev = probed.device
    qt = group_qt(p, kk)
    g = group_bound(p, qt, kk + 1 if masked else kk)
    sc, order = torch.sort(probed.reshape(p).to(torch.int32), stable=True)
    sq = torch.div(order, nprobe, rounding_mode="floor")
    idx = torch.arange(p, device=dev)
    new_cluster = torch.ones(p, dtype=torch.bool, device=dev)
    new_cluster[1:] = sc[1:] != sc[:-1]
    seg_start = torch.cummax(torch.where(new_cluster, idx, 0), dim=0).values
    rank = idx - seg_start
    new_group = new_cluster | (rank % qt == 0)
    gid = torch.cumsum(new_group, dim=0) - 1
    pc = gid * qt + rank % qt  # strictly increasing over sorted pairs
    gcount = new_group.sum(dtype=torch.int32).reshape(1)
    # every pair of a group carries its cluster: the scatter's duplicate
    # writes agree
    grp_cluster = torch.full((g,), kk, dtype=torch.int32, device=dev)
    grp_cluster[gid] = sc
    qidx = torch.zeros(g * qt, dtype=torch.long, device=dev)
    qidx[pc] = sq
    pair_slot = torch.empty(p, dtype=torch.long, device=dev)
    pair_slot[order] = pc
    return qt, grp_cluster, qidx.view(g, qt), pair_slot, gcount


def fold_sidecars(buckets: PackedVectors, counts, bucket_mask):
    """Fold the affine sidecars and the padding/tombstone mask into the
    kernel's per-slot rows (pallas_scan.py:445-450): a = scale * inv_norm,
    bv = offset * inv_norm, bias = 0 live / -inf dead (a tombstone, or a
    slot at or past its cluster's count). 12 bytes a slot."""
    kk, cap = bucket_mask.shape
    col = torch.arange(cap, device=bucket_mask.device)
    valid = (col[None, :] < counts[:, None]) & bucket_mask
    a = buckets.scale * buckets.inv_norm
    bv = buckets.offset * buckets.inv_norm
    bias = torch.where(valid, 0.0, cosine.NEG_INF).float()
    return a.contiguous(), bv.contiguous(), bias.contiguous()


# ----------------------------------------------------------------- search


def probe(qn: torch.Tensor, centroids_n: torch.Tensor, nprobe: int):
    """Top-nprobe clusters by a bf16 centroid dot with f32 accumulation
    (pallas_scan.py:313-318)."""
    check_exact_f32(qn)
    sims = qn.bfloat16().float() @ centroids_n.bfloat16().float().T
    return torch.topk(sims, nprobe, dim=-1).indices.to(torch.int32)


def ivf_scan_grouped(
    queries, centroids_n, buckets: PackedVectors, counts, bucket_mask,
    nprobe: int, k: int, epilogue: str | None = None, folded=None,
):
    """Probe + grouped scan + exact epilogue. Returns (scores f32 [B, k],
    global_slot i64 [B, k]) with global_slot = cluster * cap + slot; -inf
    rows carry the slot of a masked candidate (callers null them by
    score). `folded` is fold_sidecars' result for this store where the
    caller keeps it (an index does, once per instance); without it the
    store is folded here. Counterpart of pallas_scan.ivf_scan_pallas."""
    epilogue = _default_epilogue() if epilogue is None else epilogue
    kk = buckets.codes.shape[0]
    nprobe = max(1, min(nprobe, kk))
    with span("scan.probe"):
        qn = cosine.l2_normalize(queries.float())
        probed = probe(qn, centroids_n, nprobe)
    return grouped_scan(
        qn, qn.sum(dim=-1), buckets, counts, bucket_mask, probed, k,
        epilogue=epilogue, folded=folded,
    )


def grouped_scan(
    qn, qsum, buckets: PackedVectors, counts, bucket_mask, probed, k: int,
    epilogue: str = "auto", folded=None, probe_valid=None,
):
    """Group build, kernel and epilogue over an explicit probe list
    (pallas_scan._grouped_scan). `folded`: see ivf_scan_grouped.

    probe_valid: bool [B, nprobe] or None. A pair whose probe is not valid
    scores -inf (the sharded path's probes of clusters another shard owns):
    it is grouped under the out-of-range cluster id K, for which the kernel
    reads no codes and writes -inf. The JAX kernel scans such pairs and
    masks them after (pallas_scan.py:588-592)."""
    b, nprobe = probed.shape
    kk, cap, _ = buckets.codes.shape
    if epilogue == "auto":
        epilogue, _ = resolve_auto_epilogue(nprobe, cap, False)
    elif epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")

    with span("scan.groups"):
        grouped = probed if probe_valid is None else torch.where(probe_valid, probed, kk)
        qt, gcl, qidx, pair_slot, gcount = build_groups(
            grouped, kk, masked=probe_valid is not None
        )
        qg = qn.bfloat16()[qidx]  # [G, QT, D]
        qsum_g = qsum[qidx]  # [G, QT]
        if folded is None:
            folded = fold_sidecars(buckets, counts, bucket_mask)
    a, bv, bias = folded

    # block size of the blockexact maxima: 128 in production (cap is a
    # multiple of constants.BUCKET_ROUND = 1024); 64 serves geometries
    # with cap % 128 != 0 (tests with BUCKET_ROUND=64)
    bs = 128 if cap % 128 == 0 else 64
    if epilogue == "blockexact" and cap % bs != 0:
        raise ValueError(
            f"bucket cap {cap} is not a multiple of the blockexact block "
            f"size {bs}; pad cap to BUCKET_ROUND"
        )
    nblk = cap // bs
    k_eff = min(k, nprobe * cap)
    # the prefilter is invalid (k_eff above the block count) or does not
    # pay (the candidate slab would not halve the reduction): flat
    bx_fallback = k_eff > nprobe * nblk or k_eff * bs * 2 > nprobe * cap
    use_blocks = epilogue == "blockexact" and not bx_fallback

    with span("scan.kernel"):
        out, bmax = grouped_scores(
            qg, qsum_g, gcl, counts.to(torch.int32), buckets.codes, a, bv, bias,
            bs, use_blocks, gcount,
        )
    with span("scan.epilogue"):
        if not use_blocks:
            return _flat_epilogue(out, pair_slot, probed, k, k_eff)
        return _blockexact_epilogue(out, bmax, pair_slot, probed, k, k_eff, bs)


def _flat_epilogue(out, pair_slot, probed, k, k_eff):
    """One exact top-k over each query's nprobe * cap scores
    (pallas_scan.py:604-629)."""
    b, nprobe = probed.shape
    cap = out.shape[-1]
    flat = out.view(-1, cap)[pair_slot].view(b, nprobe * cap)
    best, pos = torch.topk(flat, k_eff, dim=-1)
    cluster = torch.gather(probed.long(), 1, pos // cap)
    return _pad_k(best, cluster * cap + pos % cap, k, k_eff)


def _blockexact_epilogue(out, bmax, pair_slot, probed, k, k_eff, bs):
    """Exact top-k through a block-max prefilter (pallas_scan.py:662-791).
    Rank the bs-wide blocks by their max: a block holding the i-th global
    winner has a max >= that winner, and only a block holding one of the
    i-1 better winners can outrank it, so the top-k_eff blocks by max hold
    every top-k_eff element. Then one exact top-k over those blocks."""
    b, nprobe = probed.shape
    cap = out.shape[-1]
    nblk = cap // bs
    pbm = bmax.view(-1, nblk)[pair_slot]  # [P, nblk]
    _, bpos = torch.topk(pbm.view(b, nprobe * nblk), k_eff, dim=-1)
    probe_j = bpos // nblk  # [B, k_eff]
    blk_i = bpos % nblk
    rowsel = torch.gather(pair_slot.view(b, nprobe), 1, probe_j)
    # the grid viewed as [G * QT * nblk, bs] rows: one gather fetches the
    # selected blocks
    cand = out.view(-1, bs)[(rowsel * nblk + blk_i).view(-1)]
    best, pos2 = torch.topk(cand.view(b, k_eff * bs), k_eff, dim=-1)
    csel = pos2 // bs  # which selected block each winner came from
    probe_sel = torch.gather(probe_j, 1, csel)
    slot = torch.gather(blk_i, 1, csel) * bs + pos2 % bs
    cluster = torch.gather(probed.long(), 1, probe_sel)
    return _pad_k(best, cluster * cap + slot, k, k_eff)


def _pad_k(best, gslot, k, k_eff):
    if k_eff < k:
        best = torch.nn.functional.pad(best, (0, k - k_eff), value=cosine.NEG_INF)
        gslot = torch.nn.functional.pad(gslot, (0, k - k_eff))
    return best, gslot
