from . import codec, layout
from .codec import dequantize, quantize
from .layout import PackedVectors, pack_float, pack_wire, unpack

__all__ = [
    "codec",
    "layout",
    "quantize",
    "dequantize",
    "PackedVectors",
    "pack_wire",
    "pack_float",
    "unpack",
]
