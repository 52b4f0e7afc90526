"""Provider facade: Ollama-first, OpenAI-fallback routing per call
(reference: ai/ai.go:17-30, ai/methods.go:14-67)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .base import NO_CTX, AIError, AIProvider
from .httpclient import SessionManager
from .noop import NoopAI
from .ollama import OllamaAI
from .openai_client import OpenAIAI


class AI(AIProvider):
    def __init__(self, providers: list[AIProvider]):
        self.providers = providers

    @staticmethod
    def from_config(cfg, use_noop: bool = False, noop_seed: int | None = None) -> "AI":
        """cfg: config.Config. With use_noop (or no endpoints configured at
        all) the deterministic fake backs everything, so the engine runs
        hermetically (reference wires noop for prefTest — main.go:246)."""
        providers: list[AIProvider] = []
        if not use_noop:
            sessions = SessionManager()
            ollama = OllamaAI(cfg.ollama, sessions)
            if ollama.can_embed() or ollama.can_generate() or ollama.can_chat():
                providers.append(ollama)
            openai = OpenAIAI(cfg.openai, sessions)
            if openai.can_embed() or openai.can_generate() or openai.can_chat():
                providers.append(openai)
        if not providers:
            providers.append(NoopAI(seed=noop_seed))
        return AI(providers)

    def _first(self, pred) -> AIProvider | None:
        for p in self.providers:
            if pred(p):
                return p
        return None

    # capabilities
    def can_embed(self):
        return self._first(lambda p: p.can_embed()) is not None

    def can_generate(self):
        return self._first(lambda p: p.can_generate()) is not None

    def can_chat(self):
        return self._first(lambda p: p.can_chat()) is not None

    # calls
    def embed(self, inputs, model=None) -> list[np.ndarray]:
        p = self._first(lambda p: p.can_embed())
        if p is None:
            raise AIError("no embed provider configured")
        return p.embed(inputs, model)

    def generate(self, prompt, model=None) -> str:
        p = self._first(lambda p: p.can_generate())
        if p is None:
            raise AIError("no generate provider configured")
        return p.generate(prompt, model)

    def generate_stream(self, prompt, model=None) -> Iterator[str]:
        p = self._first(lambda p: p.can_generate())
        if p is None:
            raise AIError("no generate provider configured")
        return p.generate_stream(prompt, model)

    def chat(self, messages, model=None) -> str:
        p = self._first(lambda p: p.can_chat())
        if p is None:
            raise AIError("no chat provider configured")
        return p.chat(messages, model)

    def chat_stream(self, messages, model=None) -> Iterator[str]:
        p = self._first(lambda p: p.can_chat())
        if p is None:
            raise AIError("no chat provider configured")
        return p.chat_stream(messages, model)

    # metadata
    def embed_ctx_num(self):
        p = self._first(lambda p: p.can_embed())
        return p.embed_ctx_num() if p else NO_CTX

    def generate_ctx_num(self):
        p = self._first(lambda p: p.can_generate())
        return p.generate_ctx_num() if p else NO_CTX

    def chat_ctx_num(self):
        p = self._first(lambda p: p.can_chat())
        return p.chat_ctx_num() if p else NO_CTX

    def embed_model(self):
        p = self._first(lambda p: p.can_embed())
        return p.embed_model() if p else ""

    def generate_model(self):
        p = self._first(lambda p: p.can_generate())
        return p.generate_model() if p else ""

    def chat_model(self):
        p = self._first(lambda p: p.can_chat())
        return p.chat_model() if p else ""
