"""Provider interface (reference: ai/interface.go:12-45).

The load-bearing boundary rule is preserved: embeddings are quantized to
the 8-byte-header wire format AT THE PROVIDER BOUNDARY (the reference does
it inside Embedding.UnmarshalJSON — ai/aicomms/embed.go:42-50), so raw
floats never cross into the engine.
"""
from __future__ import annotations

import abc
from typing import Iterator

import numpy as np

from ..quant import codec

NO_CTX = -(2**62)  # reference uses -math.MaxInt (noop/ai.go:97-108)


def quantize_embeddings(vectors) -> list[np.ndarray]:
    """float lists -> wire rows (the provider-boundary quantization).

    Equal-length batches quantize as one (N, D) array so the native C++
    fast path (codec.quantize's 2-D branch) applies."""
    vectors = list(vectors)
    if not vectors:
        return []
    lengths = {len(v) for v in vectors}
    if len(lengths) == 1:
        wire = codec.quantize(np.asarray(vectors, np.float32))
        return list(wire)
    return [codec.quantize(np.asarray(v, np.float32)) for v in vectors]


class AIProvider(abc.ABC):
    """Embedding + generation + chat provider."""

    # --- capabilities ---
    def can_embed(self) -> bool:
        return False

    def can_generate(self) -> bool:
        return False

    def can_chat(self) -> bool:
        return False

    # --- calls ---
    @abc.abstractmethod
    def embed(self, inputs: list[str], model: str | None = None) -> list[np.ndarray]:
        """Returns one wire-format uint8 row per input string."""

    @abc.abstractmethod
    def generate(self, prompt: str, model: str | None = None) -> str:
        ...

    @abc.abstractmethod
    def generate_stream(
        self, prompt: str, model: str | None = None
    ) -> Iterator[str]:
        ...

    @abc.abstractmethod
    def chat(self, messages: list[dict], model: str | None = None) -> str:
        """messages: [{'role': 'user'|'assistant'|'system', 'content': str}]"""

    @abc.abstractmethod
    def chat_stream(
        self, messages: list[dict], model: str | None = None
    ) -> Iterator[str]:
        ...

    # --- metadata ---
    def embed_ctx_num(self) -> int:
        return NO_CTX

    def generate_ctx_num(self) -> int:
        return NO_CTX

    def chat_ctx_num(self) -> int:
        return NO_CTX

    def embed_model(self) -> str:
        return ""

    def generate_model(self) -> str:
        return ""

    def chat_model(self) -> str:
        return ""


class AIError(RuntimeError):
    pass
