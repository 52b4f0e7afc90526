"""The port's embedding providers and config (vectorsearch_tpu_torch/embed,
config.py): the 15 scenarios of tests/test_embed.py, each run on the
port's modules and on the JAX package's against the same local fake
ollama/openai server (test_embed's handler), with equal answers: the same
wire rows, replies, request bodies and parsed config."""
import threading
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import vectorsearch_tpu.config as jax_config
import vectorsearch_tpu.embed as jax_embed
import vectorsearch_tpu.quant.codec as jax_codec
import vectorsearch_tpu_torch.config as port_config
import vectorsearch_tpu_torch.embed as port_embed
import vectorsearch_tpu_torch.quant.codec as port_codec

from test_embed import _Fake

PORT = SimpleNamespace(embed=port_embed, config=port_config, codec=port_codec)
JAX = SimpleNamespace(embed=jax_embed, config=jax_config, codec=jax_codec)


def both(scenario, *args):
    port, jax = (scenario(P, *args) for P in (PORT, JAX))
    assert port == jax, (port, jax)
    return port


def rows(wires):
    return [np.asarray(w).tolist() for w in wires]


@pytest.fixture(scope="module")
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Fake)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def provider_cfg(P, url, compression=False):
    p = P.config.Provider(api_base=[url], model="m", num_ctx=1000,
                          request_compression=compression)
    return P.config.AIConfig(embed=p, generate=p, chat=p)


class TestNoop:
    def test_deterministic_and_wire_format(self):
        def scenario(P):
            ra = P.embed.NoopAI(seed=1).embed(["x", "y"])
            rb = P.embed.NoopAI(seed=1).embed(["x", "y"])
            for va, vb in zip(ra, rb):
                np.testing.assert_array_equal(va, vb)
            vmin, vmax = P.codec.parse_header(ra[0][None])
            return rows(ra), ra[0].shape, float(vmin[0]), float(vmax[0])

        _, shape, vmin, vmax = both(scenario)
        assert shape == (8 + 512,) and (vmin, vmax) == (-1.0, 1.0)

    def test_empty_input_raises(self):
        def scenario(P):
            with pytest.raises(P.embed.AIError) as e:
                P.embed.NoopAI(seed=0).embed([])
            return str(e.value)

        both(scenario)

    def test_chat_is_hex(self):
        def scenario(P):
            out = P.embed.NoopAI(seed=0).chat([{"role": "user", "content": "hi"}])
            int(out or "0", 16)  # parses as hex
            return out

        both(scenario)


class TestOllama:
    def test_embed_quantizes_at_boundary(self, server):
        def scenario(P):
            return rows(P.embed.OllamaAI(provider_cfg(P, server)).embed(["a", "b"]))

        got = both(scenario)
        assert len(got) == 2
        assert got[0] == port_codec.quantize(np.array([0.1, -0.2, 0.3], np.float32)).tolist()

    def test_num_ctx_injected(self, server):
        def scenario(P):
            _Fake.calls.clear()
            P.embed.OllamaAI(provider_cfg(P, server)).embed(["a"])
            return _Fake.calls[-1]

        path, req = both(scenario)
        assert req["options"]["num_ctx"] == 1000

    def test_chat_and_stream(self, server):
        def scenario(P):
            ai = P.embed.OllamaAI(provider_cfg(P, server))
            msgs = [{"role": "user", "content": "q"}]
            return ai.chat(msgs), "".join(ai.chat_stream(msgs))

        assert both(scenario) == ("hi", "hello")

    def test_zstd_request(self, server):
        def scenario(P):
            _Fake.calls.clear()
            P.embed.OllamaAI(provider_cfg(P, server, compression=True)).generate("p")
            # the server decompressed the body and recorded the call
            return _Fake.calls[-1]

        assert both(scenario)[0] == "/api/generate"


class TestOpenAI:
    def test_embed_sorts_by_index(self, server):
        def scenario(P):
            return rows(P.embed.OpenAIAI(provider_cfg(P, server)).embed(["a", "b"]))

        got = both(scenario)
        assert got[0] == port_codec.quantize(np.array([1.0, 0.0, 0.0], np.float32)).tolist()

    def test_chat_stream_sse(self, server):
        def scenario(P):
            ai = P.embed.OpenAIAI(provider_cfg(P, server))
            return "".join(ai.chat_stream([{"role": "user", "content": "q"}]))

        assert both(scenario) == "abc"

    def test_generate(self, server):
        assert both(lambda P: P.embed.OpenAIAI(provider_cfg(P, server)).generate("p")) == "done"


class TestFacade:
    def test_noop_fallback_when_unconfigured(self):
        def scenario(P):
            ai = P.embed.AI.from_config(P.config.Config(), noop_seed=0)
            return ai.embed_model(), rows(ai.embed(["x"]))

        model, got = both(scenario)
        assert model == "noai" and len(got) == 1

    def test_ollama_first(self, server):
        def scenario(P):
            cfg = P.config.Config(ollama=provider_cfg(P, server), openai=P.config.AIConfig())
            return P.embed.AI.from_config(cfg).chat([{"role": "user", "content": "q"}])

        assert both(scenario) == "hi"

    def test_openai_fallback(self, server):
        def scenario(P):
            cfg = P.config.Config(ollama=P.config.AIConfig(), openai=provider_cfg(P, server))
            ai = P.embed.AI.from_config(cfg)
            return ai.chat([{"role": "user", "content": "q"}]), ai.embed_ctx_num()

        assert both(scenario) == ("world", 1000)


def test_endpoint_pool_least_connections():
    def scenario(P):
        pool = P.embed.EndpointPool(["a", "b"])
        with pool.acquire() as first:
            with pool.acquire() as second:
                return {first, second}

    assert both(scenario) == {"a", "b"}


def test_config_sample_roundtrip(tmp_path):
    def scenario(P):
        path = str(tmp_path / f"{P.config.__name__}.json")
        P.config.create_sample(path)
        cfg = P.config.load(path)
        return (cfg.ollama.embed.model, cfg.server.http_address, cfg.database.sqlite,
                cfg.to_dict())

    model, http, sqlite, _ = both(scenario)
    assert (model, http, sqlite) == ("nomic-embed-text", ":7500", "./vectorstore.db")
