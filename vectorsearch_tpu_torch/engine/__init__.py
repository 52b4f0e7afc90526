from .cache import EngineCache, TTLCache
from .engine import CategoryState, Engine, SearchHit
from .textprep import document_prefix, flatten, split

__all__ = [
    "CategoryState",
    "Engine",
    "EngineCache",
    "SearchHit",
    "TTLCache",
    "document_prefix",
    "flatten",
    "split",
]
