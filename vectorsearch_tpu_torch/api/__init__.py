from .http import build_app
from .tls import TLSManager, generate_self_signed

__all__ = ["build_app", "TLSManager", "generate_self_signed"]
