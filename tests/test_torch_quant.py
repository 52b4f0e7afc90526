"""The port's wire codec and packed layout (vectorsearch_tpu_torch/quant)
give byte-identical results to the JAX package's, on random f32 vectors,
through the native C++ codec and through the numpy path
(VSTPU_NO_NATIVE=1). Exact equality: both sides run the same arithmetic,
and stores and snapshots written by either package load in the other."""
import contextlib
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from vectorsearch_tpu.quant import codec as jax_codec
from vectorsearch_tpu.quant import layout as jax_layout
from vectorsearch_tpu_torch.quant import codec, layout

# rows of random f32 values; ties, zeros and constant rows come up too
VECTORS = hnp.arrays(
    np.float32,
    st.tuples(st.integers(1, 6), st.integers(1, 48)),
    elements=st.floats(-1e4, 1e4, width=32, allow_subnormal=False),
)
PATHS = pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])


@contextlib.contextmanager
def codec_path(native):
    """The native codec, or the numpy path (VSTPU_NO_NATIVE=1, read per
    call by both packages)."""
    old = os.environ.pop("VSTPU_NO_NATIVE", None)
    if not native:
        os.environ["VSTPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("VSTPU_NO_NATIVE", None)
        if old is not None:
            os.environ["VSTPU_NO_NATIVE"] = old


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@PATHS
@settings(max_examples=60, deadline=None)
@given(v=VECTORS)
def test_quantize_matches_jax(native, v):
    with codec_path(native):
        assert same_bytes(codec.quantize(v), jax_codec.quantize(v))


@PATHS
@settings(max_examples=60, deadline=None)
@given(v=VECTORS)
def test_dequantize_matches_jax(native, v):
    with codec_path(native):
        wire = jax_codec.quantize(v)
        assert same_bytes(codec.dequantize(wire), jax_codec.dequantize(wire))


@PATHS
@settings(max_examples=60, deadline=None)
@given(v=VECTORS)
def test_pack_wire_matches_jax(native, v):
    with codec_path(native):
        wire = jax_codec.quantize(v)
        ours, theirs = layout.pack_wire(wire), jax_layout.pack_wire(wire)
        assert all(same_bytes(a, b) for a, b in zip(ours, theirs))


@PATHS
@settings(max_examples=60, deadline=None)
@given(v=VECTORS)
def test_pack_float_and_unpack_match_jax(native, v):
    with codec_path(native):
        ours, theirs = layout.pack_float(v), jax_layout.pack_float(v)
        assert all(same_bytes(a, b) for a, b in zip(ours, theirs))
        assert same_bytes(layout.unpack(ours), jax_layout.unpack(theirs))
