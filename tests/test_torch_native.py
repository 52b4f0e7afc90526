"""The port's native C++ codec (vectorsearch_tpu_torch/native): the 4
scenarios of tests/test_native.py, byte-exact against the port's own numpy
path (VSTPU_NO_NATIVE=1) and against the JAX package's native codec on the
same inputs."""
import numpy as np
import pytest

from vectorsearch_tpu import native as jax_native
from vectorsearch_tpu_torch import native
from vectorsearch_tpu_torch.quant import codec, layout


@pytest.fixture(scope="module")
def have_native():
    if native.lib() is None or jax_native.lib() is None:
        pytest.skip("native codec unavailable (no toolchain?)")
    return True


@pytest.fixture
def numpy_path(monkeypatch):
    """Run a codec call on the numpy path (the env is read per call)."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setenv("VSTPU_NO_NATIVE", "1")
            return fn(*args)

    return run


def test_quantize_parity(have_native, numpy_path):
    v = np.random.default_rng(0).normal(size=(200, 768)).astype(np.float32)
    got = native.quantize_f32(v)
    np.testing.assert_array_equal(got, numpy_path(codec.quantize, v))
    np.testing.assert_array_equal(got, jax_native.quantize_f32(v))


def test_quantize_edge_cases(have_native, numpy_path):
    cases = [
        np.zeros((3, 16), np.float32),
        np.full((2, 8), 5.0, np.float32),  # all-positive: min folds to 0
        np.full((2, 8), -5.0, np.float32),  # all-negative: max folds to 0
    ]
    for v in cases:
        got = native.quantize_f32(v)
        np.testing.assert_array_equal(got, numpy_path(codec.quantize, v))
        np.testing.assert_array_equal(got, jax_native.quantize_f32(v))


def test_dequantize_parity(have_native, numpy_path):
    wire = codec.quantize(np.random.default_rng(1).normal(size=(100, 256)).astype(np.float32))
    got = native.dequantize_f32(wire)
    # -O3 FMA contraction can differ by 1 ulp from the numpy path
    np.testing.assert_allclose(got, numpy_path(codec.dequantize, wire), rtol=1e-6, atol=5e-7)
    np.testing.assert_array_equal(got, jax_native.dequantize_f32(wire))


def test_pack_wire_parity(have_native, numpy_path):
    wire = codec.quantize(np.random.default_rng(2).normal(size=(100, 256)).astype(np.float32))
    got = native.pack_wire(wire)
    want = numpy_path(layout.pack_wire, wire)
    np.testing.assert_array_equal(got[0], np.asarray(want.codes))
    np.testing.assert_allclose(got[1], np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(got[2], np.asarray(want.offset), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[3], np.asarray(want.inv_norm), rtol=1e-5)
    for ours, theirs in zip(got, jax_native.pack_wire(wire)):
        np.testing.assert_array_equal(ours, theirs)
