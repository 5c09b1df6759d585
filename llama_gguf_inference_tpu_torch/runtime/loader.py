"""GGUF -> device parameters for the llama architecture.

Weight matrices stay quantized-resident as ``QuantLinear`` (repacked by
``quant.repack``), the token embedding stays quantized too
(``QuantEmbedding``: rows are gathered and dequantized per token), norms are
f32. Float tensors load as bf16 ``DenseLinear``. Tensor names follow the
llama.cpp GGUF export convention (``blk.N.attn_q`` ...).
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


def _load_linear(reader: GGUFReader, name: str,
                 device: torch.device) -> LinearWeight:
    info = reader.tensors[name]
    out_f, in_f = info.shape  # numpy order (out, in); blocks run along in
    if info.ggml_type in _FLOAT_TYPES:
        return DenseLinear.from_f32(reader.tensor_f32(name), device)
    rp = repack(reader.tensor_bytes(name), info.ggml_type, out_f, in_f)
    return to_quant_linear(rp, device)


def _load_array(reader: GGUFReader, name: str, device: torch.device,
                dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(reader.tensor_f32(name).copy()).to(
        device=device, dtype=dtype)


def load_model(path: str | Path, device: str | torch.device = "cuda",
               fuse: bool = True):
    """Returns (config, params, reader).

    ``fuse=True`` row-concatenates QKV and gate+up projections into single
    linears (fewer kernel launches per layer; exact).
    """
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    t = reader.tensors
    emb_name = "token_embd.weight"
    if t[emb_name].ggml_type in _FLOAT_TYPES:
        tok_embd = _load_array(reader, emb_name, dev, torch.bfloat16)
    else:
        tok_embd = QuantEmbedding(table=_load_linear(reader, emb_name, dev))
    params: dict[str, Any] = {
        "tok_embd": tok_embd,
        "output_norm": _load_array(reader, "output_norm.weight", dev),
    }
    if "output.weight" in t:
        params["output"] = _load_linear(reader, "output.weight", dev)
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
            layer[n] = _load_linear(reader, p + n + ".weight", dev)
        if fuse:
            _fuse_layer(layer)
        layers.append(layer)
    params["layers"] = layers
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
