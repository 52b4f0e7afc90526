"""The grouped-scan CUDA kernel on the card: against its plain version, on
the index's search path, and the wrapper's refusals. Every test here
needs an NVIDIA GPU and nvcc and skips without one. This file imports no
jax (the machine with the card has none), so it runs there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerance kernel vs plain: atol 1e-4, since the products are exact in
f32 and only the order of the f32 sums differs; block maxima are exact.
"""
import numpy as np
import pytest
import torch

from vectorsearch_tpu.quant import layout
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.kernels import _build, grouped_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _inputs(device, g, qt, kk, cap, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(-127, 128, (kk, cap, d), generator=gen, device=device,
                          dtype=torch.int8)
    a, bv = (torch.rand((kk, cap), generator=gen, device=device) * 0.01
             for _ in range(2))
    bias = torch.where(torch.rand((kk, cap), generator=gen, device=device) > 0.1,
                       0.0, float("-inf")).float()
    qg = torch.randn((g, qt, d), generator=gen, device=device).bfloat16()
    qsum = torch.randn((g, qt), generator=gen, device=device)
    gcl = torch.randint(0, kk, (g,), generator=gen, device=device, dtype=torch.int32)
    return [qg, qsum, gcl, codes, a, bv, bias]


@pytest.mark.parametrize(
    "qt,want_bmax,cap,d",
    [(8, False, 256, 128), (16, True, 256, 128), (32, True, 256, 128),
     (16, True, 192, 80)],  # cap % 128 != 0: 64-column blocks
)
def test_kernel_matches_plain(cuda, qt, want_bmax, cap, d):
    g, kk = 19, 7
    bs = 128 if cap % 128 == 0 else 64
    args = _inputs(cuda, g, qt, kk, cap, d, seed=qt + d)
    before = grouped_scan.LAUNCHES
    out, bmax = grouped_scan.grouped_scores(*args, bs, want_bmax)
    ref, _ = grouped_scan.grouped_scores_ref(*args, bs, False)
    torch.cuda.synchronize()
    assert grouped_scan.LAUNCHES == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    if want_bmax:
        assert torch.equal(bmax, out.view(g, qt, cap // bs, bs).amax(-1))
    else:
        assert bmax is None


def test_group_without_cluster_scores_nothing(cuda):
    """A group whose cluster id lies outside [0, K) reads no codes and
    scores -inf everywhere."""
    args = _inputs(cuda, 3, 8, 4, 128, 64, seed=5)
    args[2][1] = -1
    out, bmax = grouped_scan.grouped_scores(*args, 128, True)
    torch.cuda.synchronize()
    assert torch.isneginf(out[1]).all() and torch.isneginf(bmax[1]).all()
    assert torch.isfinite(out[0]).any()


def test_ivf_search_on_card_matches_cpu(cuda):
    """The whole search path on the card (probe, group build, kernel,
    flat and blockexact epilogues, refine) against the same index on the
    CPU: refined scores atol 1e-5, and the same ids above the near-ties
    at each row's cut."""
    rng = np.random.default_rng(0)
    k, d = 48, 96
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    v = (centers[:, None] + rng.normal(size=(k, 100, d))).reshape(-1, d)
    packed = layout.pack_float(v.astype(np.float32))
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    q = v[::97] + 0.01
    gpu = IVFIndex.build(packed, ids, centers, device=cuda)
    cpu = IVFIndex.build(packed, ids, centers, device="cpu")
    before = grouped_scan.LAUNCHES
    for nprobe in (1, 4, 40):  # 40 * cap 1024 > 32768 columns: blockexact
        s_g, i_g = gpu.search(q, k=10, nprobe=nprobe, refine=32)
        s_c, i_c = cpu.search(q, k=10, nprobe=nprobe, refine=32)
        np.testing.assert_allclose(s_g, s_c, atol=1e-5)
        for sg, ig, sc, ic in zip(s_g, i_g, s_c, i_c):
            cut = sg.min() + 1e-5
            assert set(ig[sg > cut]) == set(ic[sc > cut])
    assert grouped_scan.LAUNCHES >= before + 3


def test_no_library_raises(cuda, monkeypatch):
    """No kernel library -> an error, never the plain version."""

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "library_path", no_library)
    before = grouped_scan.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        grouped_scan.grouped_scores(*_inputs(cuda, 2, 8, 3, 64, 16, 0), 64, False)
    assert grouped_scan.LAUNCHES == before


def test_rejects_bad_input(cuda):
    args = _inputs(cuda, 2, 8, 3, 64, 16, 0)
    bad = list(args)
    bad[3] = bad[3].float()  # codes must be int8
    with pytest.raises(ValueError, match="codes"):
        grouped_scan.grouped_scores(*bad, 64, False)
    bad = list(args)
    bad[0] = torch.zeros((2, 12, 16), dtype=torch.bfloat16, device=cuda)
    bad[1] = torch.zeros((2, 12), device=cuda)
    with pytest.raises(ValueError, match="QT"):
        grouped_scan.grouped_scores(*bad, 64, False)
    with pytest.raises(ValueError, match="CUDA device"):
        grouped_scan.grouped_scores(*args[:3], args[3].cpu(), *args[4:], 64, False)
