from .base import NO_CTX, AIError, AIProvider, quantize_embeddings
from .facade import AI
from .httpclient import EndpointPool, ProviderClient, SessionManager
from .noop import NoopAI
from .ollama import OllamaAI
from .openai_client import OpenAIAI

__all__ = [
    "AI",
    "AIError",
    "AIProvider",
    "EndpointPool",
    "NO_CTX",
    "NoopAI",
    "OllamaAI",
    "OpenAIAI",
    "ProviderClient",
    "SessionManager",
    "quantize_embeddings",
]
