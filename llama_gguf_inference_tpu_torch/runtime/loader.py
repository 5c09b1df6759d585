"""GGUF -> device parameters for the llama architecture.

Two residency modes, as the JAX package's loader:

- ``quant`` (default): weight matrices stay quantized-resident as
  ``QuantLinear`` (repacked by ``quant.repack``), the token embedding stays
  quantized too (``QuantEmbedding``: rows are gathered and dequantized per
  token);
- ``dense``: every weight and the embedding dequantized to bf16
  (``DenseLinear``, a dense table), the correctness baseline; the
  dequantization runs on the device and gives the numpy codec's values.

Norms are f32; float tensors load as bf16 ``DenseLinear`` in either mode. A
GGUF LoRA adapter (``lora_path``, ``runtime.lora``) wraps its weights before
the fusion. Tensor names follow the llama.cpp GGUF export convention
(``blk.N.attn_q`` ...).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..models.config import ModelConfig
from ..ops.linear import DenseLinear, LinearWeight, QuantEmbedding, fuse_linears
from ..quant.repack import repack, to_quant_linear

_FLOAT_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


MODES = ("quant", "dense")


def _load_linear(reader: GGUFReader, name: str, device: torch.device,
                 mode: str = "quant") -> LinearWeight:
    info = reader.tensors[name]
    out_f, in_f = info.shape  # numpy order (out, in); blocks run along in
    if info.ggml_type in _FLOAT_TYPES:
        return DenseLinear.from_f32(reader.tensor_f32(name), device)
    if mode == "dense":
        return DenseLinear(w=_dense(reader, name, device), out_features=out_f, in_features=in_f)
    rp = repack(reader.tensor_bytes(name), info.ggml_type, out_f, in_f)
    return to_quant_linear(rp, device)


def _dense(reader: GGUFReader, name: str, device: torch.device) -> torch.Tensor:
    """A quantized tensor as bf16 on ``device``: repacked, moved there
    quantized, and dequantized there (the numpy codec's f32 values, bit for
    bit, then rounded to bf16)."""
    info = reader.tensors[name]
    out_f, in_f = info.shape
    rp = repack(reader.tensor_bytes(name), info.ggml_type, out_f, in_f)
    return to_quant_linear(rp, device).dequantize(torch.bfloat16)


def _load_array(reader: GGUFReader, name: str, device: torch.device,
                dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(reader.tensor_f32(name).copy()).to(
        device=device, dtype=dtype)


def load_model(path: str | Path, device: str | torch.device = "cuda",
               fuse: bool = True, mode: str = "quant", lora_path: str = "",
               lora_scale: float = 1.0):
    """Returns (config, params, reader).

    ``mode`` is ``quant`` or ``dense`` (the module's docstring).
    ``fuse=True`` row-concatenates QKV and gate+up projections into single
    linears (fewer kernel launches per layer; exact). ``lora_path`` applies
    a GGUF LoRA adapter (llama-server ``--lora``, ``runtime.lora``) scaled by
    ``lora_scale`` before the fusion, so adapted projections stay unfused.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    t = reader.tensors
    emb_name = "token_embd.weight"
    if t[emb_name].ggml_type in _FLOAT_TYPES:
        tok_embd = _load_array(reader, emb_name, dev, torch.bfloat16)
    elif mode == "dense":
        tok_embd = _dense(reader, emb_name, dev)
    else:
        tok_embd = QuantEmbedding(table=_load_linear(reader, emb_name, dev))
    params: dict[str, Any] = {
        "tok_embd": tok_embd,
        "output_norm": _load_array(reader, "output_norm.weight", dev),
    }
    if "output.weight" in t:
        params["output"] = _load_linear(reader, "output.weight", dev, mode)
    elif isinstance(tok_embd, QuantEmbedding):
        # tied head: the matmul runs straight off the shared quantized arrays
        params["output"] = tok_embd.table
    else:
        params["output"] = DenseLinear(w=tok_embd, out_features=tok_embd.shape[0],
                                       in_features=tok_embd.shape[1])
    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {}
        for n in ("attn_norm", "ffn_norm"):
            if p + n + ".weight" not in t:
                # a truncated GGUF must fail here, not run without the norm
                raise KeyError(f"{p}{n}.weight missing from GGUF")
            layer[n] = _load_array(reader, p + n + ".weight", dev)
        for n in ("attn_q", "attn_k", "attn_v", "attn_output",
                  "ffn_gate", "ffn_up", "ffn_down"):
            layer[n] = _load_linear(reader, p + n + ".weight", dev, mode)
        layers.append(layer)
    params["layers"] = layers
    if lora_path:
        from .lora import apply_lora
        apply_lora(params, lora_path, lora_scale, arch=cfg.arch, device=dev)
    if fuse:
        for layer in layers:
            _fuse_layer(layer)
    return cfg, params, reader


def _fuse_layer(layer: dict) -> None:
    """Row-concatenate QKV and gate+up projections in place (exact)."""
    qkv = fuse_linears([layer["attn_q"], layer["attn_k"], layer["attn_v"]])
    if qkv is not None:
        layer["attn_qkv"] = qkv
        del layer["attn_q"], layer["attn_k"], layer["attn_v"]
    gu = fuse_linears([layer["ffn_gate"], layer["ffn_up"]])
    if gu is not None:
        layer["ffn_gateup"] = gu
        del layer["ffn_gate"], layer["ffn_up"]
