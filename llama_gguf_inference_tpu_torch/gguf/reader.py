"""Memory-mapped GGUF v2/v3 reader.

Replaces the GGUF loading the reference delegates to llama.cpp's
``llama-server`` (reference ``start.sh:473-480`` passes ``-m <model.gguf>`` to
the binary; see SURVEY.md §2.9).  Tensor data stays mmap'd — zero-copy numpy
views over quantized blocks, which the engine repacks into the device
layouts at load time (SURVEY.md §5.4).
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    name: str
    shape: tuple[int, ...]        # logical numpy shape (row-major, slowest first)
    ggml_shape: tuple[int, ...]   # as stored: ne[0] fastest-varying first
    ggml_type: GGMLType
    offset: int                   # absolute byte offset of data in file
    nbytes: int

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class GGUFReader:
    """Parse a GGUF file; expose metadata dict and zero-copy tensor views."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = memoryview(self._mm)
        self._pos = 0
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    # -- low-level cursor reads ---------------------------------------------
    def _read(self, n: int) -> bytes:
        b = self._buf[self._pos:self._pos + n]
        if len(b) != n:
            raise EOFError(f"truncated GGUF file at offset {self._pos}")
        self._pos += n
        return bytes(b)

    def _scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._read(size))[0]

    def _string(self) -> str:
        n = self._scalar("<Q")
        if n > len(self._buf) - self._pos:
            raise ValueError(
                f"GGUF string length {n} at offset {self._pos} exceeds file size")
        return self._read(n).decode("utf-8", errors="replace")

    def _value(self, vtype: GGUFValueType):
        vtype = GGUFValueType(vtype)
        if vtype == GGUFValueType.STRING:
            return self._string()
        if vtype == GGUFValueType.ARRAY:
            item_type = GGUFValueType(self._scalar("<I"))
            count = self._scalar("<Q")
            if item_type in _SCALAR_FMT and item_type != GGUFValueType.BOOL:
                fmt = _SCALAR_FMT[item_type]
                itemsize = struct.calcsize(fmt)
                if count * itemsize > len(self._buf) - self._pos:
                    raise ValueError(
                        f"GGUF array of {count} items exceeds file size")
                raw = self._read(count * itemsize)
                return np.frombuffer(raw, dtype=np.dtype(fmt)).copy()
            return [self._value(item_type) for _ in range(count)]
        return self._scalar(_SCALAR_FMT[vtype])

    # -- structure ----------------------------------------------------------
    def _parse(self) -> None:
        magic = self._scalar("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = self._scalar("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._scalar("<Q")
        n_kv = self._scalar("<Q")
        for _ in range(n_kv):
            key = self._string()
            vtype = GGUFValueType(self._scalar("<I"))
            self.metadata[key] = self._value(vtype)

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        if self.alignment <= 0 or self.alignment & (self.alignment - 1):
            raise ValueError(f"invalid general.alignment {self.alignment} "
                             "(must be a positive power of two)")

        pending: list[tuple[str, tuple[int, ...], GGMLType, int]] = []
        for _ in range(n_tensors):
            name = self._string()
            n_dims = self._scalar("<I")
            if n_dims > 8:  # GGML_MAX_DIMS is 4; anything larger is garbage
                raise ValueError(f"tensor {name!r}: implausible n_dims {n_dims}")
            ggml_shape = tuple(self._scalar("<Q") for _ in range(n_dims))
            if any(d <= 0 for d in ggml_shape):
                raise ValueError(f"tensor {name!r}: non-positive dim in {ggml_shape}")
            ggml_type = GGMLType(self._scalar("<I"))
            rel_offset = self._scalar("<Q")
            pending.append((name, ggml_shape, ggml_type, rel_offset))

        data_start = (self._pos + self.alignment - 1) // self.alignment * self.alignment
        self.data_start = data_start
        for name, ggml_shape, ggml_type, rel in pending:
            shape = tuple(reversed(ggml_shape))  # numpy row-major view of the same data
            n_el = 1
            for d in ggml_shape:
                n_el *= d
            nbytes = tensor_nbytes(n_el, ggml_type)
            if data_start + rel + nbytes > len(self._buf):
                raise ValueError(
                    f"tensor {name!r}: data [{data_start + rel}, "
                    f"{data_start + rel + nbytes}) extends past end of file "
                    f"({len(self._buf)} bytes)")
            self.tensors[name] = TensorInfo(
                name=name, shape=shape, ggml_shape=ggml_shape,
                ggml_type=ggml_type, offset=data_start + rel, nbytes=nbytes,
            )

    # -- data access --------------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's raw (quantized) bytes."""
        info = self.tensors[name]
        return np.frombuffer(self._buf, dtype=np.uint8,
                             count=info.nbytes, offset=info.offset)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantize a tensor to float32 with the golden numpy codec."""
        from ..quant.numpy_ref import dequantize
        info = self.tensors[name]
        flat = dequantize(self.tensor_bytes(name), info.ggml_type, info.n_elements)
        return flat.reshape(info.shape)

    def close(self) -> None:
        self._buf.release()
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
