"""Quantized KV caches: q8_0, q4_0 and q4_1 (llama-server's
``--cache-type-k/v``).

Each holds int8 or packed 4-bit codes plus ONE f32 scale per (token, head)
vector (and, for q4_1, one f32 minimum), as per-layer lists of tensors in
the flash kernels' (B, KVH, S, ...) layout, written in place like
:class:`models.llama.KVCache`. The codecs are the JAX package's
(``runtime/kv_cache.py``), operation for operation:

- q8_0: symmetric absmax over head_dim, ``s = amax / 127``, codes
  ``clip(round(x / s), -127, 127)``;
- q4_0: ``s = amax / 7``, codes ``clip(round(x / s), -8, 7) + 8`` packed two
  to a byte in planar order (byte j: element j low, element j + D/2 high);
  buffers start at 0x88 (code 8 = value 0);
- q4_1: ``s = (max - min) / 15``, unsigned codes
  ``clip(round((x - min) / s), 0, 15)``, the same packing; buffers start at 0.

``1 / s`` is ``where(s > 0, 1 / where(s == 0, 1, s), 0)`` and rounding is half
to even. The attention kernels read the codes directly; ``dequantize`` is
the codec's inverse, to bf16 unless asked otherwise; ``view`` gives a
layer's whole K and V, for the layers that attend without a kernel
(``models.llama.masked_attention``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.llama import _write_index, _write_kv, sink_zeros
from ..ops import flash_attention as fa


def _inv(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                       torch.zeros_like(s))


def _pack(c: torch.Tensor) -> torch.Tensor:
    """(..., D) codes in [0, 15] -> (..., D/2) uint8 planar nibbles."""
    c = c.to(torch.uint8)
    half = c.shape[-1] // 2
    return c[..., :half] | (c[..., half:] << 4)


class _QuantCache:
    """Shared behaviour: fields are L-lists of (B, KVH, S, ...) tensors; the
    K fields come first, then the V fields, in codec order."""

    K_FIELDS: tuple[str, ...] = ()
    V_FIELDS: tuple[str, ...] = ()

    @classmethod
    def _buffers(cls, cfg: ModelConfig, batch: int, max_seq: int,
                 device) -> dict[str, list]:
        raise NotImplementedError

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_seq: int,
              device: str | torch.device):
        return cls(**cls._buffers(cfg, batch, max_seq, device))

    @property
    def max_seq(self) -> int:
        return self.k_q[0].shape[2]

    def slot(self, b: int):
        """Views of sequence b's rows (writes land in this cache)."""
        return type(self)(**{f.name: [a[b:b + 1] for a in getattr(self, f.name)]
                             for f in dataclasses.fields(self)})

    def write_index(self, offsets: torch.Tensor, T: int):
        return _write_index(offsets, T, self.k_q[0])

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor, idx) -> None:
        """Quantize k/v (B, T, KVH, D) and write the rows of idx in place."""
        for names, x in ((self.K_FIELDS, k), (self.V_FIELDS, v)):
            for name, part in zip(names, self.quantize(x)):
                _write_kv(getattr(self, name)[layer], part, idx)

    def view(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s K and V dequantized to (B, KVH, S, D) bf16, for
        ``models.llama.masked_attention`` (the JAX package's ``k_full`` and
        ``v_full``)."""
        return tuple(self.dequantize(*(getattr(self, f)[layer] for f in names))
                     for names in (self.K_FIELDS, self.V_FIELDS))


def _lists(L: int, make) -> list:
    return [make() for _ in range(L)]


@dataclasses.dataclass
class QuantKV(_QuantCache):
    """q8_0: codes (B, KVH, S, D) int8, scales (B, KVH, S) f32 per layer."""

    k_q: list
    k_s: list
    v_q: list
    v_s: list

    K_FIELDS = ("k_q", "k_s")
    V_FIELDS = ("v_q", "v_s")

    @classmethod
    def _buffers(cls, cfg, batch, max_seq, device):
        L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        codes = lambda: sink_zeros((batch, H, max_seq, D), torch.int8, device)
        scale = lambda: sink_zeros((batch, H, max_seq), torch.float32, device)
        return dict(k_q=_lists(L, codes), k_s=_lists(L, scale),
                    v_q=_lists(L, codes), v_s=_lists(L, scale))

    @staticmethod
    def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (..., D) -> (codes int8, scale f32 per leading index)."""
        xf = x.float()
        s = xf.abs().amax(dim=-1) / 127.0
        q = torch.clamp(torch.round(xf * _inv(s)[..., None]), -127, 127)
        return q.to(torch.int8), s

    @staticmethod
    def dequantize(q, s, dtype=torch.bfloat16) -> torch.Tensor:
        return (q.float() * s[..., None]).to(dtype)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention_q8(q, self.k_q[layer], self.k_s[layer],
                                     self.v_q[layer], self.v_s[layer], offsets)


@dataclasses.dataclass
class QuantKV4(_QuantCache):
    """q4_0: codes (B, KVH, S, D/2) uint8 planar nibbles biased by 8,
    scales (B, KVH, S) f32 per layer."""

    k_q: list
    k_s: list
    v_q: list
    v_s: list

    K_FIELDS = ("k_q", "k_s")
    V_FIELDS = ("v_q", "v_s")

    @classmethod
    def _buffers(cls, cfg, batch, max_seq, device):
        L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        codes = lambda: sink_zeros((batch, H, max_seq, D // 2), torch.uint8, device,
                                   fill=0x88)
        scale = lambda: sink_zeros((batch, H, max_seq), torch.float32, device)
        return dict(k_q=_lists(L, codes), k_s=_lists(L, scale),
                    v_q=_lists(L, codes), v_s=_lists(L, scale))

    @staticmethod
    def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (..., D) -> (packed codes (..., D/2) uint8, scale f32)."""
        xf = x.float()
        s = xf.abs().amax(dim=-1) / 7.0
        c = torch.clamp(torch.round(xf * _inv(s)[..., None]), -8, 7) + 8
        return _pack(c), s

    @staticmethod
    def dequantize(q, s, dtype=torch.bfloat16) -> torch.Tensor:
        return ((fa.unpack_nibbles(q) - 8).float() * s[..., None]).to(dtype)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention_q4(q, self.k_q[layer], self.k_s[layer],
                                     self.v_q[layer], self.v_s[layer], offsets)


@dataclasses.dataclass
class QuantKV41(_QuantCache):
    """q4_1: unsigned planar nibbles (B, KVH, S, D/2) uint8, scales and
    minimums (B, KVH, S) f32 per layer; an element is ``c * s + m``."""

    k_q: list
    k_s: list
    k_m: list
    v_q: list
    v_s: list
    v_m: list

    K_FIELDS = ("k_q", "k_s", "k_m")
    V_FIELDS = ("v_q", "v_s", "v_m")

    @classmethod
    def _buffers(cls, cfg, batch, max_seq, device):
        L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        codes = lambda: sink_zeros((batch, H, max_seq, D // 2), torch.uint8, device)
        scale = lambda: sink_zeros((batch, H, max_seq), torch.float32, device)
        return dict(k_q=_lists(L, codes), k_s=_lists(L, scale), k_m=_lists(L, scale),
                    v_q=_lists(L, codes), v_s=_lists(L, scale), v_m=_lists(L, scale))

    @staticmethod
    def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (..., D) -> (packed codes (..., D/2) uint8, scale, min)."""
        xf = x.float()
        mn = xf.amin(dim=-1)
        s = (xf.amax(dim=-1) - mn) / 15.0
        c = torch.clamp(torch.round((xf - mn[..., None]) * _inv(s)[..., None]), 0, 15)
        return _pack(c), s, mn

    @staticmethod
    def dequantize(q, s, m, dtype=torch.bfloat16) -> torch.Tensor:
        return (fa.unpack_nibbles(q).float() * s[..., None] + m[..., None]).to(dtype)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention_q41(q, self.k_q[layer], self.k_s[layer],
                                      self.k_m[layer], self.v_q[layer],
                                      self.v_s[layer], self.v_m[layer], offsets)
