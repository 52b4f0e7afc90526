"""OpenAI-compatible provider (reference: ai/openai/*.go).

Endpoints: POST /v1/embeddings, /v1/chat/completions, /v1/completions.
Streaming parses SSE `data: {...}` chunks ordered by choice index and stops
on finish_reason/[DONE] (reference: ai/openai/chat.go:86-175).
"""
from __future__ import annotations

import json
from typing import Iterator

from .base import AIError, AIProvider, quantize_embeddings
from .httpclient import ProviderClient, SessionManager


class OpenAIAI(AIProvider):
    def __init__(self, cfg, sessions: SessionManager | None = None):
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
            raise AIError(f"openai ({resp.status_code}): {body[:200]!r}")

    def embed(self, inputs, model=None):
        payload = json.dumps(
            {"model": model or self.cfg.embed.model, "input": inputs}
        ).encode()
        resp = self._embed.post_json("/v1/embeddings", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        data = json.loads(body).get("data", [])
        data.sort(key=lambda d: d.get("index", 0))
        vectors = [d.get("embedding", []) for d in data]
        if len(vectors) != len(inputs):
            raise AIError("invalid response embeddings count")
        return quantize_embeddings(vectors)

    def generate(self, prompt, model=None) -> str:
        payload = json.dumps(
            {
                "model": model or self.cfg.generate.model,
                "prompt": prompt,
                "stream": False,
            }
        ).encode()
        resp = self._generate.post_json("/v1/completions", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        choices = json.loads(body).get("choices", [])
        return choices[0].get("text", "") if choices else ""

    def _iter_sse(self, resp) -> Iterator[dict]:
        for line in resp.iter_lines():
            if not line:
                continue
            if line.startswith(b"data:"):
                chunk = line[len(b"data:") :].strip()
                if chunk == b"[DONE]":
                    return
                yield json.loads(chunk)

    def generate_stream(self, prompt, model=None) -> Iterator[str]:
        payload = json.dumps(
            {
                "model": model or self.cfg.generate.model,
                "prompt": prompt,
                "stream": True,
            }
        ).encode()
        resp = self._generate.post_json("/v1/completions", payload, stream=True)
        if resp.status_code != 200:
            resp.close()
            raise AIError(f"openai ({resp.status_code})")
        try:
            for obj in self._iter_sse(resp):
                for choice in sorted(
                    obj.get("choices", []), key=lambda c: c.get("index", 0)
                ):
                    text = choice.get("text", "")
                    if text:
                        yield text
                    if choice.get("finish_reason"):
                        return
        finally:
            resp.close()  # releases the least-connections slot

    def chat(self, messages, model=None) -> str:
        payload = json.dumps(
            {
                "model": model or self.cfg.chat.model,
                "messages": messages,
                "stream": False,
            }
        ).encode()
        resp = self._chat.post_json("/v1/chat/completions", payload)
        body = ProviderClient.read_body(resp)
        self._check(resp, body)
        choices = json.loads(body).get("choices", [])
        if not choices:
            return ""
        return choices[0].get("message", {}).get("content", "")

    def chat_stream(self, messages, model=None) -> Iterator[str]:
        payload = json.dumps(
            {
                "model": model or self.cfg.chat.model,
                "messages": messages,
                "stream": True,
            }
        ).encode()
        resp = self._chat.post_json("/v1/chat/completions", payload, stream=True)
        if resp.status_code != 200:
            resp.close()
            raise AIError(f"openai ({resp.status_code})")
        try:
            for obj in self._iter_sse(resp):
                for choice in sorted(
                    obj.get("choices", []), key=lambda c: c.get("index", 0)
                ):
                    delta = choice.get("delta", {}).get("content", "")
                    if delta:
                        yield delta
                    if choice.get("finish_reason"):
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
