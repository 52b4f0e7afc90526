"""The port's client SDK (vectorsearch_tpu_torch.client) against a live
server: the 3 scenarios of tests/test_client.py, each run twice from the
same Client code, against the port's server over the port's Engine and
against the JAX aiohttp app over the JAX Engine (both served as
tests/test_torch_api.py serves them, with the word-hash embedder). The
scenarios' own assertions hold on both, and the two transcripts (every
JSON body the client decoded, the chat reply, the error's status and
message) must agree: equal ids and names, similarities within 1e-5.
"""
import pytest
import torch

from vectorsearch_tpu import constants
from vectorsearch_tpu_torch import constants as port_constants
from vectorsearch_tpu_torch.client import Client, ClientError

from test_engine import FRUIT_DOCS
from test_torch_api import assert_same, make_engine, serving


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)
    monkeypatch.setattr(port_constants, "BUCKET_ROUND", 64)
    torch.set_num_threads(2)


class RecordingClient(Client):
    """The port's Client, keeping every JSON body it decoded."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _post_json(self, path, payload):
        out = super()._post_json(path, payload)
        self.seen.append([path, out])
        return out


def sc_full_flow(url):
    c = RecordingClient(url)
    ids = c.upload("o", "c", FRUIT_DOCS)
    assert len(ids) == 3

    hits = c.search("o", "c", "banana tropical", count=2)
    assert hits[0]["name"] == "bananas"
    assert hits[0]["document_id"] == ids[1]

    assert c.category_names("o") == ["c"]

    reply = "".join(c.chat("what?", document_ids=[ids[0]]))
    assert reply == "chat reply"

    c.delete_document("o", "c", ids[0])
    hits = c.search("o", "c", "apple orchard", count=3, centroids=-1)
    assert all(h["document_id"] != ids[0] for h in hits)

    # the stats describe each engine and its device: checked, not compared
    assert "categories" in c.stats()

    c.delete_owner("o")
    assert c.category_names("o") == []
    return [*c.seen, reply]


def sc_zstd_roundtrip(url):
    c = RecordingClient(url, use_zstd=True)
    c.upload("z", "c", FRUIT_DOCS)
    hits = c.search("z", "c", "gearbox road", count=1)
    assert hits[0]["name"] == "cars"
    return c.seen


def sc_error_surface(url):
    c = RecordingClient(url)
    with pytest.raises(ClientError) as e:
        c.upload("o", "c", [])
    assert e.value.status == 400
    return [e.value.status, str(e.value)]


def against_both(scenario):
    """The scenario against the port's server and against the JAX app;
    the two transcripts must agree."""
    got = {}
    for kind in ("port", "jax"):
        with serving(kind, make_engine(kind)) as port:
            got[kind] = scenario(f"http://127.0.0.1:{port}")
    assert_same(got["port"], got["jax"])


def test_client_full_flow():
    against_both(sc_full_flow)


def test_client_zstd_roundtrip():
    against_both(sc_zstd_roundtrip)


def test_client_error_surface():
    against_both(sc_error_surface)
