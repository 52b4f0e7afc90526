"""Ollama provider (reference: ai/ollama/{ollama,embed,chat,generate}.go).

Endpoints: POST /api/embed, /api/chat, /api/generate. num_ctx is injected
into options (reference: ai/ollama/embed.go:20-26). Streaming responses are
line-delimited JSON objects whose content deltas are yielded incrementally
(reference: ai/ollama/chat.go:96-160).
"""
from __future__ import annotations

import json
from typing import Iterator

from .base import AIError, AIProvider, quantize_embeddings
from .httpclient import ProviderClient, SessionManager


class OllamaAI(AIProvider):
    def __init__(self, cfg, sessions: SessionManager | None = None):
        """cfg: config.AIConfig with embed/generate/chat Provider blocks."""
        self.cfg = cfg
        sessions = sessions or SessionManager()
        self._embed = ProviderClient(cfg.embed, sessions) if cfg.embed and cfg.embed.api_base else None
        self._generate = (
            ProviderClient(cfg.generate, sessions)
            if cfg.generate and cfg.generate.api_base
            else None
        )
        self._chat = ProviderClient(cfg.chat, sessions) if cfg.chat and cfg.chat.api_base else None

    def can_embed(self):
        return self._embed is not None

    def can_generate(self):
        return self._generate is not None

    def can_chat(self):
        return self._chat is not None

    @staticmethod
    def _check(resp, body: bytes):
        if resp.status_code != 200:
            raise AIError(f"ollama ({resp.status_code}): {body[:200]!r}")

    def embed(self, inputs, model=None):
        payload = json.dumps(
            {
                "model": model or self.cfg.embed.model,
                "input": inputs,
                "options": {"num_ctx": self.cfg.embed.num_ctx},
            }
        ).encode()
        resp = self._embed.post_json("/api/embed", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        data = json.loads(body)
        embeddings = data.get("embeddings") or []
        if len(embeddings) != len(inputs):
            raise AIError("invalid response embeddings count")
        # provider-boundary quantization (ai/aicomms/embed.go:42-50)
        return quantize_embeddings(embeddings)

    def generate(self, prompt, model=None) -> str:
        payload = json.dumps(
            {
                "model": model or self.cfg.generate.model,
                "prompt": prompt,
                "stream": False,
                "options": {"num_ctx": self.cfg.generate.num_ctx},
            }
        ).encode()
        resp = self._generate.post_json("/api/generate", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        return json.loads(body).get("response", "")

    def generate_stream(self, prompt, model=None) -> Iterator[str]:
        payload = json.dumps(
            {
                "model": model or self.cfg.generate.model,
                "prompt": prompt,
                "stream": True,
                "options": {"num_ctx": self.cfg.generate.num_ctx},
            }
        ).encode()
        resp = self._generate.post_json("/api/generate", payload, stream=True)
        if resp.status_code != 200:
            resp.close()
            raise AIError(f"ollama ({resp.status_code})")
        try:
            for line in resp.iter_lines():
                if not line:
                    continue
                obj = json.loads(line)
                delta = obj.get("response", "")
                if delta:
                    yield delta
                if obj.get("done"):
                    return
        finally:
            resp.close()  # releases the least-connections slot

    def chat(self, messages, model=None) -> str:
        payload = json.dumps(
            {
                "model": model or self.cfg.chat.model,
                "messages": messages,
                "stream": False,
                "options": {"num_ctx": self.cfg.chat.num_ctx},
            }
        ).encode()
        resp = self._chat.post_json("/api/chat", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        return json.loads(body).get("message", {}).get("content", "")

    def chat_stream(self, messages, model=None) -> Iterator[str]:
        payload = json.dumps(
            {
                "model": model or self.cfg.chat.model,
                "messages": messages,
                "stream": True,
                "options": {"num_ctx": self.cfg.chat.num_ctx},
            }
        ).encode()
        resp = self._chat.post_json("/api/chat", payload, stream=True)
        if resp.status_code != 200:
            resp.close()
            raise AIError(f"ollama ({resp.status_code})")
        try:
            for line in resp.iter_lines():
                if not line:
                    continue
                obj = json.loads(line)
                delta = obj.get("message", {}).get("content", "")
                if delta:
                    yield delta
                if obj.get("done"):
                    return
        finally:
            resp.close()  # releases the least-connections slot

    def embed_ctx_num(self):
        return self.cfg.embed.num_ctx if self._embed else super().embed_ctx_num()

    def generate_ctx_num(self):
        return (
            self.cfg.generate.num_ctx if self._generate else super().generate_ctx_num()
        )

    def chat_ctx_num(self):
        return self.cfg.chat.num_ctx if self._chat else super().chat_ctx_num()

    def embed_model(self):
        return self.cfg.embed.model if self._embed else ""

    def generate_model(self):
        return self.cfg.generate.model if self._generate else ""

    def chat_model(self):
        return self.cfg.chat.model if self._chat else ""
