"""The port's native C++ codec (vectorsearch_tpu_torch/native): the 4
scenarios of tests/test_native.py, byte-exact against the port's own numpy
path (VSTPU_NO_NATIVE=1) and against the JAX package's native codec on the
same inputs; and the serial build the loader falls back to where the
OpenMP one fails."""
import importlib.util
import os
import shutil

import numpy as np
import pytest

from vectorsearch_tpu import native as jax_native
from vectorsearch_tpu_torch import native
from vectorsearch_tpu_torch.quant import codec, layout
from torch_parity import have_toolchain, load_jax_native


@pytest.fixture(scope="module")
def have_native():
    if not have_toolchain():
        pytest.skip("native codec unavailable: no make or C++ compiler")
    assert native.lib() is not None, "the port's native codec did not build"
    assert load_jax_native(), "the JAX package's native codec did not load"
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


def test_serial_build_where_openmp_fails(have_native, numpy_path, tmp_path):
    """A copy of native/ whose OpenMP flag the compiler refuses: the loader
    installs the serial build, loads it, says so, and gives the OpenMP
    build's bytes and numpy's. The copy builds under its own Makefile's
    flock and never touches the library other workers load."""
    src = os.path.dirname(native.__file__)
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("__init__.py", "codec.cpp", "Makefile"):
        shutil.copy(os.path.join(src, name), copy / name)
    makefile = (copy / "Makefile").read_text()
    assert "OPENMP ?= -fopenmp\n" in makefile
    (copy / "Makefile").write_text(
        makefile.replace("OPENMP ?= -fopenmp\n", "OPENMP ?= -fopenmp-no-such-flag\n"))
    spec = importlib.util.spec_from_file_location("serial_codec", copy / "__init__.py")
    serial = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serial)

    assert serial.lib() is not None, "the serial build did not load"
    assert serial.build_kind() == "serial"
    # the shared library is the OpenMP build, or the serial one on a host
    # whose compiler has no OpenMP
    assert native.build_kind() in ("openmp", "serial")
    assert (copy / ".build_stamp").read_text().endswith(" serial")
    assert not list(copy.glob("*.tmp"))

    rng = np.random.default_rng(3)
    v = rng.normal(size=(300, 768)).astype(np.float32)
    v[0], v[1] = 0.0, np.abs(v[1])  # a zero row and an all-positive one
    wire = serial.quantize_f32(v)
    np.testing.assert_array_equal(wire, native.quantize_f32(v))
    np.testing.assert_array_equal(wire, numpy_path(codec.quantize, v))
    deq = serial.dequantize_f32(wire)
    np.testing.assert_array_equal(deq, native.dequantize_f32(wire))
    # -O3 FMA contraction can differ by 1 ulp from the numpy path
    np.testing.assert_allclose(deq, numpy_path(codec.dequantize, wire), rtol=1e-6, atol=5e-7)
    got = serial.pack_wire(wire)
    for ours, omp in zip(got, native.pack_wire(wire)):
        np.testing.assert_array_equal(ours, omp)
    want = numpy_path(layout.pack_wire, wire)
    np.testing.assert_array_equal(got[0], np.asarray(want.codes))
    np.testing.assert_allclose(got[1], np.asarray(want.scale), rtol=1e-6)
    np.testing.assert_allclose(got[2], np.asarray(want.offset), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[3], np.asarray(want.inv_norm), rtol=1e-5)
