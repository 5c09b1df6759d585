"""GGUF v3 writer.

Used by tests and tooling to synthesize spec-compliant model files (the
environment ships no model weights, and the reference's own CI never loads a
real model either — its integration tier runs with ``MOCK_BACKEND=true``,
reference ``.github/workflows/ci.yml:185-228``).  Also the basis for a future
``convert``/``quantize`` CLI.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
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

_NUMPY_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(v, np.floating):
        return GGUFValueType.FLOAT64 if v.dtype == np.float64 else GGUFValueType.FLOAT32
    if isinstance(v, np.integer):
        return _NUMPY_TO_VTYPE[v.dtype]
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot map {type(v)} to a GGUF value type")


class GGUFWriter:
    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, GGUFValueType(vtype) if vtype is not None else _infer_vtype(value)))

    def add_dict(self, kv: Mapping[str, Any]) -> None:
        for k, v in kv.items():
            self.add(k, v)

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: GGMLType) -> None:
        """Quantize a float numpy array (row-major) into the file.

        ``data`` has numpy shape (slowest ... fastest); stored ggml dims are
        the reverse.  Quantization blocks run along the last (contiguous) axis.
        """
        # imported here, not at module top: quant.numpy_ref imports
        # gguf.constants, so a top-level import would be circular when the
        # quant package loads first (e.g. via runtime.layout_cache)
        from ..quant.numpy_ref import quantize

        ggml_type = GGMLType(ggml_type)
        data = np.ascontiguousarray(data, dtype=np.float32)
        raw = quantize(data, ggml_type)
        ggml_shape = tuple(reversed(data.shape))
        self._tensors.append((name, ggml_shape, ggml_type, raw))

    def add_raw_tensor(self, name: str, ggml_shape: Sequence[int],
                       ggml_type: GGMLType, raw: bytes) -> None:
        self._tensors.append((name, tuple(ggml_shape), GGMLType(ggml_type), raw))

    # -- serialization ------------------------------------------------------
    def _pack_string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _pack_value(self, v: Any, vtype: GGUFValueType) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._pack_string(str(v))
        if vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                item_t = _NUMPY_TO_VTYPE[v.dtype]
                body = np.ascontiguousarray(v).tobytes()
                return struct.pack("<IQ", int(item_t), v.size) + body
            items = list(v)
            if not items:
                return struct.pack("<IQ", int(GGUFValueType.UINT32), 0)
            item_t = _infer_vtype(items[0])
            out = struct.pack("<IQ", int(item_t), len(items))
            return out + b"".join(self._pack_value(it, item_t) for it in items)
        return struct.pack(_SCALAR_FMT[vtype], v)

    def write(self) -> Path:
        align = self.alignment
        header = struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                             len(self._tensors), len(self._kv))
        kv_bytes = b"".join(
            self._pack_string(k) + struct.pack("<I", int(t)) + self._pack_value(v, t)
            for k, v, t in self._kv
        )
        infos = []
        offset = 0
        for name, ggml_shape, ggml_type, raw in self._tensors:
            infos.append(
                self._pack_string(name)
                + struct.pack("<I", len(ggml_shape))
                + b"".join(struct.pack("<Q", d) for d in ggml_shape)
                + struct.pack("<IQ", int(ggml_type), offset)
            )
            offset += (len(raw) + align - 1) // align * align
        info_bytes = b"".join(infos)

        head_len = len(header) + len(kv_bytes) + len(info_bytes)
        pad = (head_len + align - 1) // align * align - head_len

        with open(self.path, "wb") as f:
            f.write(header)
            f.write(kv_bytes)
            f.write(info_bytes)
            f.write(b"\x00" * pad)
            for _, _, _, raw in self._tensors:
                f.write(raw)
                tail = (len(raw) + align - 1) // align * align - len(raw)
                f.write(b"\x00" * tail)
        return self.path
