"""Lloyd's pass of the k-means build: the assign and accumulate CUDA
kernels and their plain PyTorch versions.

Counterpart of vectorsearch_tpu/kernels/pallas_kmeans.py. One pass over
packed rows (PackedVectors of tensors) against centroids [K, D]:

  assign      cid[n] = argmax_k (offset[n] * csum[k]
                                 + scale[n] * <bf16 cn[k], codes[n]>) * inv_norm[n]
              with cn the L2-normalized centroids and csum their f32 row sums
  accumulate  sums[k] = sum over cid[n] = k of (offset[n] + scale[n] * codes[n]),
              counts[k] = the number of such rows

The kernels live in csrc/kmeans.cu. On CPU tensors each wrapper runs its
plain version; on CUDA tensors it launches its kernel or raises. The
plain versions walk the rows in chunks of `chunk`, which bounds their
[chunk, K] intermediates; the kernels keep nothing of size N x K and take
no chunk.

Not carried over from the TPU module: the padding mask `kmask` (the port
pads no centroid set), the `valid` row mask (the port's rows are all
live), and the K <= 4096 bound ASSIGN_K_MAX, a limit of the TPU's VMEM:
the CUDA kernels take any K.
"""
from __future__ import annotations

import torch

from ..device import check_exact_f32
from ..quant.layout import PackedVectors
from . import _build, cosine

# kernel launches since import (or since a caller reset them to 0): let a
# run show that its build went through the CUDA kernels
ASSIGN_LAUNCHES = 0
ACCUMULATE_LAUNCHES = 0

DEFAULT_CHUNK = 16_384

# the chunked accumulate kernel: the widest row it takes (8 words of 4 dims
# for each of its 192 consumer threads), and the chunks it wants at least
# before it takes longer ones: one for each block a full H100 holds at
# D=768 (132 SMs, 3 blocks each)
CHUNKS_MAX_DIM = 6144
CHUNKS_MIN = 396
# (route, member rows a chunk, ring stages) forced on accumulate's launch;
# "" and 0 leave each to the rule. A test or a measurement sets it, the
# build never
ACCUMULATE_SCHEDULE = ("", 0, 0)


# ---------------------------------------------------------- plain versions


def assign_scores_ref(rows: PackedVectors, cn_bf16, csum):
    """f32 [n, K] sims of `rows` against the bf16 centroids, widened to
    f32 (exact products, f32 sums, TF32 off)."""
    check_exact_f32(csum)
    dots = rows.codes.float() @ cn_bf16.float().T
    return (rows.offset[:, None] * csum[None, :] + rows.scale[:, None] * dots) * (
        rows.inv_norm[:, None]
    )


def _chunk(rows: PackedVectors, lo: int, chunk: int) -> PackedVectors:
    return PackedVectors(*[a[lo : lo + chunk] for a in rows])


def assign_ref(rows: PackedVectors, cn_bf16, csum, chunk: int = DEFAULT_CHUNK):
    """Plain version of `assign`: i32 [N] argmax of assign_scores_ref."""
    cids = [
        torch.argmax(assign_scores_ref(_chunk(rows, lo, chunk), cn_bf16, csum), dim=-1)
        for lo in range(0, rows.n, chunk)
    ]
    if not cids:
        return torch.empty((0,), dtype=torch.int32, device=rows.codes.device)
    return torch.cat(cids).to(torch.int32)


def accumulate_ref(rows: PackedVectors, cid, kk: int, chunk: int = DEFAULT_CHUNK):
    """Plain version of `accumulate`: per-cluster sums f32 [K, D] of the
    dequantized rows as an f32 one-hot product (every product is 0 or v,
    exact), and counts f32 [K]."""
    dev = rows.codes.device
    sums = torch.zeros((kk, rows.codes.shape[1]), dtype=torch.float32, device=dev)
    counts = torch.zeros((kk,), dtype=torch.float32, device=dev)
    kcol = torch.arange(kk, device=dev)
    check_exact_f32(sums)
    for lo in range(0, rows.n, chunk):
        part = _chunk(rows, lo, chunk)
        v = part.offset[:, None] + part.scale[:, None] * part.codes.float()
        onehot = (cid[lo : lo + chunk, None] == kcol[None, :]).float()  # [chunk, K]
        sums += onehot.T @ v
        counts += onehot.sum(dim=0)
    return sums, counts


def segments_ref(sorted_cid, kk: int):
    """The chunked kernel's segment table in plain PyTorch, by the kernel's
    own rule: seg[k], k = 0 .. K, is the first position of the sorted ids
    that holds an id >= k. Position m writes every k in (cid[m - 1],
    cid[m]], with -1 before the first position, K after the last, and the
    ids clamped to [-1, K]."""
    c = sorted_cid.long().clamp(-1, kk)
    edge = c.new_tensor
    steps = torch.cat([c, edge([kk])]) - torch.cat([edge([-1]), c])
    return torch.repeat_interleave(torch.arange(c.numel() + 1, device=c.device), steps)


def accumulate_chunks_ref(rows: PackedVectors, cid, kk: int, chunk_rows: int):
    """The chunked kernels' two passes in plain PyTorch, run by run, for
    the tests of the design's bookkeeping (it is slow: a Python loop over
    chunks). Pass 1 walks each chunk of `chunk_rows` members of the sorted
    order and writes a run's sum to its cluster's row when the run is the
    whole cluster, else to the chunk's first (2c) or last (2c + 1) partial
    row; pass 2 zeroes the empty clusters and adds the partials of a
    cluster that spans chunks, in chunk order. Returns (sums, counts, the
    scratch rows that pass 1 wrote)."""
    d = rows.codes.shape[1]
    sorted_cid, order = torch.sort(cid, stable=True)
    seg = segments_ref(sorted_cid, kk).tolist()
    v = rows.offset[order, None] + rows.scale[order, None] * rows.codes[order].float()
    ids = sorted_cid.tolist()
    v0, v1 = seg[0], seg[kk]
    n_chunks = -(-(v1 - v0) // chunk_rows)
    sums = torch.full((kk, d), float("nan"))  # every row must be written once
    part = torch.full((2 * -(-rows.n // chunk_rows), d), float("nan"))
    written = []
    for c in range(n_chunks):
        lo, hi = v0 + c * chunk_rows, min(v0 + (c + 1) * chunk_rows, v1)
        before = ids[lo - 1] if lo > v0 else -1
        after = ids[hi] if hi < v1 else -1
        m, first = lo, True
        while m < hi:
            end = m
            while end < hi and ids[end] == ids[m]:
                end += 1
            partial = (first and ids[m] == before) or (end == hi and ids[m] == after)
            run = v[m:end].sum(0)
            if partial:
                slot = 2 * c + (0 if first else 1)
                part[slot] = run
                written.append(slot)
            else:
                assert torch.isnan(sums[ids[m]]).all()
                sums[ids[m]] = run
            m, first = end, False
    for k in range(kk):
        s, e = seg[k], seg[k + 1]
        if e == s:
            sums[k] = 0.0
            continue
        c0, c1 = (s - v0) // chunk_rows, (e - 1 - v0) // chunk_rows
        if c0 == c1:
            continue
        head = 1 if s > v0 + c0 * chunk_rows else 0
        slots = [2 * c + (head if c == c0 else 0) for c in range(c0, c1 + 1)]
        sums[k] = part[slots].double().sum(0).float()
    counts = torch.tensor([seg[k + 1] - seg[k] for k in range(kk)], dtype=torch.float32)
    return sums, counts, sorted(written)


def assign_accumulate_ref(rows: PackedVectors, centroids, chunk: int = DEFAULT_CHUNK):
    """One Lloyd's pass in plain PyTorch: (sums f32 [K, D], counts f32
    [K], cid i32 [N])."""
    cn, csum, cn_bf16 = _normalize(centroids)
    cid = assign_ref(rows, cn_bf16, csum, chunk)
    sums, counts = accumulate_ref(rows, cid, cn.shape[0], chunk)
    return sums, counts, cid


def _normalize(centroids):
    """The normalized centroids, their f32 row sums and their bf16 cast
    (pallas_kmeans.py:162-163, :184)."""
    cn = cosine.l2_normalize(centroids)
    return cn, cn.sum(dim=-1), cn.bfloat16()


# ---------------------------------------------------------------- wrappers


def _rows_spec(rows: PackedVectors) -> dict:
    n, d = rows.codes.shape
    return {
        "codes": (rows.codes, torch.int8, (n, d)),
        "scale": (rows.scale, torch.float32, (n,)),
        "offset": (rows.offset, torch.float32, (n,)),
        "inv_norm": (rows.inv_norm, torch.float32, (n,)),
    }


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def assign(rows: PackedVectors, cn_bf16, csum, chunk: int = DEFAULT_CHUNK):
    """Nearest centroid of every row: i32 [N].

    rows: codes i8 [N, D], scale, offset, inv_norm f32 [N]; cn_bf16 bf16
    [K, D], the normalized centroids; csum f32 [K], the f32 row sums of
    the normalized centroids. On CPU tensors this is assign_ref (`chunk`
    bounds its [chunk, K] sims); on CUDA tensors it launches the kernel
    or raises."""
    global ASSIGN_LAUNCHES
    dev = _build.launch_device("assign", [*rows, cn_bf16, csum])
    if dev is None:
        return assign_ref(rows, cn_bf16, csum, chunk)
    n, d = rows.codes.shape
    kk = cn_bf16.shape[0]
    _build.check_args("assign", {
        **_rows_spec(rows),
        "cn": (cn_bf16, torch.bfloat16, (kk, d)),
        "csum": (csum, torch.float32, (kk,)),
    })
    if kk == 0 or d == 0:
        raise ValueError(f"assign: needs K >= 1 and D >= 1, got K={kk} D={d}")
    cid = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return cid
    codes = rows.codes
    if d % 16:
        # TMA needs 16-byte row strides: zero columns add nothing to a dot
        codes = torch.nn.functional.pad(codes, (0, 16 - d % 16))
        cn_bf16 = torch.nn.functional.pad(cn_bf16, (0, 16 - d % 16))
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vs_kmeans_assign(
            codes.data_ptr(), rows.scale.data_ptr(), rows.offset.data_ptr(),
            rows.inv_norm.data_ptr(), cn_bf16.data_ptr(), csum.data_ptr(),
            cid.data_ptr(), n, codes.shape[1], kk, _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"assign: kernel launch failed, cudaError {err}")
    ASSIGN_LAUNCHES += 1
    return cid


def accumulate_plan(n: int, d: int) -> tuple[str, int, int]:
    """How `accumulate` runs N rows of D dims on the card: (route, member
    rows a chunk, rows of the partial-sum scratch).

    "chunks": D % 16 == 0 (a row is one bulk copy) and D <= CHUNKS_MAX_DIM.
    The sorted order is cut into chunks of a fixed number of members, 32 to
    a ring stage: 512, or fewer where that would leave blocks without a
    chunk (longer chunks cut fewer clusters, so fewer partial sums). A chunk leaves at most two partial sums (its first
    run if that cluster began earlier, its last if it goes on), so the
    scratch has two rows a chunk. "loads": any other D, one block a
    (cluster, 128 dims) with plain loads, no chunks."""
    route, chunk_rows, _ = ACCUMULATE_SCHEDULE
    if not route:
        route = "chunks" if d % 16 == 0 and d <= CHUNKS_MAX_DIM else "loads"
    if route == "loads":
        return route, 0, 0
    if not chunk_rows:
        chunk_rows = next((c for c in (512, 256, 128) if n >= c * CHUNKS_MIN), 64)
    return route, chunk_rows, 2 * -(-n // chunk_rows)


def accumulate_sort(rows: PackedVectors, cid, kk: int, route: str) -> tuple:
    """The torch side of `accumulate` on the card, ahead of the launch: the
    rows ordered by cluster, a stable sort of cid (the library's radix
    sort, as XLA sorts outside the TPU kernel). "chunks" takes the sorted
    ids and the int64 order as they come: the kernel finds the segments and
    reads the sidecars through the order itself. "loads" also wants each
    cluster's segment of the order and the sidecars gathered in it."""
    sorted_cid, order = torch.sort(cid, stable=True)
    if route == "chunks":
        return sorted_cid, order
    seg = torch.searchsorted(
        sorted_cid, torch.arange(kk + 1, dtype=torch.int32, device=cid.device)
    )
    return rows.scale[order], rows.offset[order], order, seg


def accumulate_launch(rows: PackedVectors, kk: int, plan: tuple, glue: tuple):
    """Allocate the sums, counts and scratch and launch the kernels of
    `plan` on `glue` (accumulate_sort's tensors): (sums, counts)."""
    global ACCUMULATE_LAUNCHES
    route, chunk_rows, part_rows = plan
    n, d = rows.codes.shape
    dev = rows.codes.device
    sums = torch.empty((kk, d), dtype=torch.float32, device=dev)
    counts = torch.empty((kk,), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        if route == "chunks":
            sorted_cid, order = glue
            seg = torch.empty((kk + 2,), dtype=torch.int32, device=dev)
            part = torch.empty((part_rows, d), dtype=torch.float32, device=dev)
            err = lib.vs_kmeans_accumulate(
                rows.codes.data_ptr(), rows.scale.data_ptr(), rows.offset.data_ptr(),
                order.data_ptr(), sorted_cid.data_ptr(), seg.data_ptr(),
                part.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, d, kk,
                chunk_rows, ACCUMULATE_SCHEDULE[2], _stream(dev),
            )
        else:
            scale_s, offset_s, order, seg = glue
            err = lib.vs_kmeans_accumulate_loads(
                rows.codes.data_ptr(), scale_s.data_ptr(), offset_s.data_ptr(),
                order.data_ptr(), seg.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                d, kk, _stream(dev),
            )
    if err != 0:
        raise RuntimeError(f"accumulate: kernel launch failed, cudaError {err}")
    ACCUMULATE_LAUNCHES += 1
    return sums, counts


def accumulate(rows: PackedVectors, cid, kk: int, chunk: int = DEFAULT_CHUNK):
    """Per-cluster sums f32 [K, D] of the dequantized rows
    offset + scale * codes, and member counts f32 [K]. Rows whose cid lies
    outside [0, K) count nowhere.

    On CPU tensors this is accumulate_ref; on CUDA tensors the rows are
    ordered by cluster (a stable sort of cid) and the kernels of
    accumulate_plan sum them, deterministically, or the call raises."""
    dev = _build.launch_device("accumulate", [*rows, cid])
    if dev is None:
        return accumulate_ref(rows, cid, kk, chunk)
    n, d = rows.codes.shape
    _build.check_args("accumulate", {
        **{k: v for k, v in _rows_spec(rows).items() if k != "inv_norm"},
        "cid": (cid, torch.int32, (n,)),
    })
    if kk < 1 or d == 0:
        raise ValueError(f"accumulate: needs K >= 1 and D >= 1, got K={kk} D={d}")
    plan = accumulate_plan(n, d)
    return accumulate_launch(rows, kk, plan, accumulate_sort(rows, cid, kk, plan[0]))


def assign_accumulate(rows: PackedVectors, centroids, chunk: int = DEFAULT_CHUNK):
    """One Lloyd's pass: (sums f32 [K, D], counts f32 [K], cid i32 [N]).
    The normalized centroids are cast to bf16 where the JAX package casts
    them; their row sums stay f32."""
    cn, csum, cn_bf16 = _normalize(centroids)
    cid = assign(rows, cn_bf16.contiguous(), csum.contiguous(), chunk)
    sums, counts = accumulate(rows, cid, cn.shape[0], chunk)
    return sums, counts, cid
