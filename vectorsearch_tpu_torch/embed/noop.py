"""Deterministic fake provider (reference: noop/ai.go).

Byte-level parity with the reference's fake: 512-dim wire rows whose header
is f32(-1)/f32(1) with raw random payload bytes (noop/ai.go:47-64), and
hex-noise generate/chat (noop/ai.go:67-94). Unlike the reference (which
seeds from crypto/rand), the seed is an argument so tests are hermetic.
"""
from __future__ import annotations

import struct
import threading
from typing import Iterator

import numpy as np

from .base import NO_CTX, AIError, AIProvider

EMBED_DIM = 512
GENERATE_MAX_LEN = 512
_HEADER = np.frombuffer(struct.pack("<ff", -1.0, 1.0), dtype=np.uint8)


class NoopAI(AIProvider):
    def __init__(self, seed: int | None = None, dim: int = EMBED_DIM):
        self._rng = np.random.default_rng(seed)
        # concurrent HTTP requests call embed() from executor threads;
        # numpy Generators are not thread-safe (state corruption would
        # make the deterministic fake nondeterministic)
        self._rng_lock = threading.Lock()
        self._dim = dim

    # capabilities
    def can_embed(self) -> bool:
        return True

    def can_generate(self) -> bool:
        return True

    def can_chat(self) -> bool:
        return True

    # calls
    def embed(self, inputs, model=None):
        if not inputs:
            raise AIError("input is empty")
        out = []
        with self._rng_lock:
            for _ in inputs:
                row = np.empty(8 + self._dim, np.uint8)
                row[:8] = _HEADER
                row[8:] = self._rng.integers(
                    0, 256, size=self._dim, dtype=np.uint8
                )
                out.append(row)
        return out

    def _hex_noise(self) -> str:
        with self._rng_lock:
            n = int(self._rng.integers(0, GENERATE_MAX_LEN))
            return bytes(
                self._rng.integers(0, 256, size=n, dtype=np.uint8)
            ).hex()

    def generate(self, prompt, model=None) -> str:
        return self._hex_noise()

    def generate_stream(self, prompt, model=None) -> Iterator[str]:
        yield self._hex_noise()

    def chat(self, messages, model=None) -> str:
        return self._hex_noise()

    def chat_stream(self, messages, model=None) -> Iterator[str]:
        yield self._hex_noise()

    # metadata
    def embed_model(self) -> str:
        return "noai"

    def generate_model(self) -> str:
        return "noai"

    def chat_model(self) -> str:
        return "noai"

    def embed_ctx_num(self) -> int:
        return NO_CTX

    def generate_ctx_num(self) -> int:
        return NO_CTX

    def chat_ctx_num(self) -> int:
        return NO_CTX
