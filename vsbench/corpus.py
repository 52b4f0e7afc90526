"""The benchmark's inputs, made from `--seed` by one general generator.

A configuration's `corpus` block sets the recipe; the same seed on the
same device and PyTorch gives the same inputs, bit for bit:

- K generating directions c_j ~ N(0, I_D) and cluster weights
  w_j = exp(sigma * z_j), z_j ~ N(0, 1) (sigma 0 gives equal clusters);
- row i: member m_i ~ Categorical(w), v_i = center_scale * c_{m_i} + e_i,
  e_i ~ N(0, I_D), made on the device a slab at a time;
- the index's centroids are the directions c_j and each row's assignment
  is its member m_j: at these scales a row's cosine to its own direction
  (0.89 at scale 2, 0.96 at scale 3.33) stands far above any other's
  (about 0.04 a standard deviation), so m_i is also its nearest centroid;
- query i of the pool: a row drawn from the seed, as the wire format
  returns it, plus query_noise * N(0, I_D);
- uploaded document n (served cells): a new row of the same recipe, drawn
  from (seed, n).

Rows leave the device as wire rows (engine cells, `reference.codec`) or
as packed rows (codes, scale, offset, inv_norm: library cells), and live
on the host as a deployment holds them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import codec

SLAB = 500_000  # rows made on the device at a time


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run's inputs: `seed` may be any
    whole number (the driver's are above 2**31), tags name the stream."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *tags])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


ROWS, QUERIES, UPLOADS, ORDER = 1, 2, 3, 4


@dataclass
class Recipe:
    n: int
    dim: int
    clusters: int
    center_scale: float
    cluster_size_sigma: float
    query_noise: float

    @staticmethod
    def of(config: dict, n: int | None = None) -> "Recipe":
        c = config["corpus"]
        return Recipe(int(n if n is not None else config["rows"]), int(config["dim"]),
                      int(config["clusters"]), float(c["center_scale"]),
                      float(c["cluster_size_sigma"]), float(c["query_noise"]))


class Corpus:
    """The generating directions and weights of one run (host copies), and
    the row slabs on `dev`."""

    def __init__(self, recipe: Recipe, seed: int, dev: torch.device):
        self.recipe, self.seed, self.dev = recipe, seed, dev
        gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, ROWS))
        self._gen = gen
        self.centers = torch.randn((recipe.clusters, recipe.dim), generator=gen, device=dev)
        z = torch.randn((recipe.clusters,), generator=gen, device=dev)
        self.weights = torch.exp(recipe.cluster_size_sigma * z)
        self.centers_host = self.centers.cpu().numpy()
        w = self.weights.double().cpu().numpy()
        self.probs_host = w / w.sum()

    def slabs(self, slab: int = SLAB):
        """(start, members int64 [m], f32 rows [m, D]) on the device, in
        row order; call once."""
        r = self.recipe
        for start in range(0, r.n, slab):
            m = min(slab, r.n - start)
            member = torch.multinomial(self.weights, m, replacement=True, generator=self._gen)
            v = torch.randn((m, r.dim), generator=self._gen, device=self.dev)
            v += self.centers[member] * r.center_scale
            yield start, member, v

    def centroids(self) -> np.ndarray:
        """The index's centroids: the generating directions, f32 [K, D]."""
        return self.centers_host.astype(np.float32)


def wire_rows(corpus: Corpus):
    """Every row as host wire rows uint8 [n, 8 + D] and the members int32 [n]."""
    r = corpus.recipe
    wire = np.empty((r.n, codec.HEADER + r.dim), np.uint8)
    members = np.empty(r.n, np.int32)
    for start, member, v in corpus.slabs():
        wire[start : start + v.shape[0]] = codec.quantize_rows(v).cpu().numpy()
        members[start : start + v.shape[0]] = member.cpu().numpy()
    return wire, members


def pack(v: torch.Tensor):
    """f32 rows as packed rows (codes int8, scale, offset, inv_norm f32) on
    v's device: the wire format's codes, q - 128, with the affine sidecars
    and the f32 reciprocal norm of the dequantized row."""
    w = codec.quantize_rows(v)
    hdr = w[:, : codec.HEADER].contiguous().view(torch.float32)
    vmin, vmax = hdr[:, 0], hdr[:, 1]
    scale = (vmax - vmin) / 255.0
    offset = vmin + 128.0 * scale
    codes = (w[:, codec.HEADER :].to(torch.int16) - 128).to(torch.int8)
    norm = (offset[:, None] + scale[:, None] * codes.float()).norm(dim=-1)
    inv_norm = torch.where(norm == 0, torch.zeros_like(norm), 1.0 / torch.where(norm == 0, torch.ones_like(norm), norm))
    return codes, scale, offset, inv_norm


def packed_rows(corpus: Corpus):
    """Every row packed, as host arrays (codes [n, D], scale, offset,
    inv_norm [n]), and the members int32 [n]."""
    r = corpus.recipe
    out = (np.empty((r.n, r.dim), np.int8), np.empty(r.n, np.float32),
           np.empty(r.n, np.float32), np.empty(r.n, np.float32))
    members = np.empty(r.n, np.int32)
    for start, member, v in corpus.slabs():
        for dst, src in zip(out, pack(v)):
            dst[start : start + src.shape[0]] = src.cpu().numpy()
        members[start : start + v.shape[0]] = member.cpu().numpy()
    return out, members


def query_pool(recipe: Recipe, seed: int, size: int, rows_f64) -> np.ndarray:
    """`size` queries f32 [size, D]: rows drawn from (seed, QUERIES) as the
    wire format returns them (`rows_f64(idx)` gives them in float64), plus
    query_noise gaussian noise."""
    rng = np.random.default_rng(sub_seed(seed, QUERIES))
    idx = np.sort(rng.choice(recipe.n, size=size, replace=False))
    base = rows_f64(idx)
    noise = rng.standard_normal(base.shape) * recipe.query_noise
    return (base + noise).astype(np.float32)


def upload_vector(corpus: Corpus, n: int) -> np.ndarray:
    """Uploaded document n's vector, f32 [D]: a new row of the recipe,
    drawn from (seed, UPLOADS, n) on the host."""
    rng = np.random.default_rng(sub_seed(corpus.seed, UPLOADS, n))
    j = rng.choice(len(corpus.probs_host), p=corpus.probs_host)
    e = rng.standard_normal(corpus.recipe.dim)
    return (corpus.centers_host[j] * corpus.recipe.center_scale + e).astype(np.float32)


def order(seed: int, n: int) -> np.ndarray:
    """A permutation of range(n) drawn from the seed (the order in which a
    library cell takes its query batches)."""
    return np.random.default_rng(sub_seed(seed, ORDER)).permutation(n)
