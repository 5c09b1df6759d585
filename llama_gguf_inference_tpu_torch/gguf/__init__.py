from .constants import GGMLType, GGUFValueType, Keys, QK_K, TokenType, type_block_info
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGMLType", "GGUFValueType", "Keys", "QK_K", "TokenType",
    "type_block_info", "GGUFReader", "TensorInfo", "GGUFWriter",
]
