"""The port's device rule (device.resolve): None takes VSTPU_DEVICE, else
the first CUDA card, and raises where there is neither. No entry point of
the port carries on on the CPU unless the CPU is asked for by name. The
card's absence is simulated (torch.cuda.is_available stubbed False), so
these tests mean the same on a machine with a card."""
import numpy as np
import pytest
import torch

from vectorsearch_tpu_torch import convert, device
from vectorsearch_tpu_torch.build import build_centroids, lloyd
from vectorsearch_tpu_torch.engine import Engine
from vectorsearch_tpu_torch.index import FlatIndex, IVFIndex, assign_clusters
from vectorsearch_tpu_torch.parallel import default_mesh
from vectorsearch_tpu_torch.parallel.distributed import global_mesh
from vectorsearch_tpu_torch.quant import layout


@pytest.fixture
def no_card_no_ask(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(device.DEVICE_ENV, raising=False)


def test_resolve_none_raises_without_a_card_or_an_ask(no_card_no_ask):
    with pytest.raises(device.NoDeviceError, match="VSTPU_DEVICE"):
        device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")  # asked by name


@pytest.mark.parametrize("ask", ["cpu", "cuda:1"])
def test_the_ask_in_the_environment_is_taken(no_card_no_ask, monkeypatch, ask):
    monkeypatch.setenv(device.DEVICE_ENV, ask)
    assert device.resolve(None) == torch.device(ask)


def test_a_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv(device.DEVICE_ENV, raising=False)
    assert device.resolve(None) == torch.device("cuda")


class Untouchable:
    """A store that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"the store was touched: {name}")


def test_engine_raises_before_it_touches_the_store(no_card_no_ask):
    with pytest.raises(device.NoDeviceError, match="VSTPU_DEVICE"):
        Engine(Untouchable(), ai=None)


def _packed(n=40, d=16):
    return layout.pack_float(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32))


ENTRY_POINTS = {
    "IVFIndex.build": lambda p: IVFIndex.build(p, np.arange(p.n), layout.unpack(p)[:2]),
    "FlatIndex.create": lambda p: FlatIndex.create(p.dim),
    "FlatIndex.from_packed": lambda p: FlatIndex.from_packed(p, np.arange(p.n)),
    "assign_clusters": lambda p: assign_clusters(p, layout.unpack(p)[:2]),
    "lloyd": lambda p: lloyd(p, layout.unpack(p)[:2], max_iters=1),
    "build_centroids": lambda p: build_centroids(p, k=2),
    "convert.flat_from_arrays": lambda p: convert.flat_from_arrays({}),
    "default_mesh": lambda p: default_mesh(),
    "global_mesh": lambda p: global_mesh(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_entry_point_falls_back_to_the_cpu(no_card_no_ask, name):
    with pytest.raises(device.NoDeviceError):
        ENTRY_POINTS[name](_packed())
