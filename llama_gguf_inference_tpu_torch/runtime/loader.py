"""GGUF -> device parameters for the dense llama-family architectures of
``models.config`` (``load_model``) and the BERT-family encoders
(``load_encoder``).

Two residency modes, as the JAX package's loader:

- ``quant`` (default): weight matrices stay quantized-resident as
  ``QuantLinear`` (repacked by ``quant.repack``), the token embedding stays
  quantized too (``QuantEmbedding``: rows are gathered and dequantized per
  token);
- ``dense``: every weight and the embedding dequantized to bf16
  (``DenseLinear``, a dense table), the correctness baseline; the
  dequantization runs on the device and gives the numpy codec's values.

Norms, biases and rope factors are f32; float tensors load as bf16
``DenseLinear`` in either mode. Which per-layer tensors a layer holds
follows the file, as in the JAX package's loader: a pre-fused ``attn_qkv``
and a double-height ``ffn_up`` (phi3), biases, q/k norms and post-norms;
a file without ``output.weight`` ties the head to the embedding. A
GGUF LoRA adapter (``lora_path``, ``runtime.lora``) wraps its weights before
the fusion. Tensor names follow the llama.cpp GGUF export convention
(``blk.N.attn_q`` ...).

In ``quant`` mode the repacked arrays go through the layout cache
(``runtime.layout_cache``, the JAX package's on-disk format): a tensor
missing there is repacked (``native`` C++ for Q8_0, Q4_K and Q6_K, numpy
for the rest) and appended, and every cached tensor becomes a placeholder
(:class:`_Pending`) that one bulk upload (``runtime.device_upload``) ships at
the end of the load, before the LoRA adapter and the fusion.
``LGT_UPLOAD=tensor`` copies each tensor on its own instead. Every load
prints the split of its seconds (``[loader] load_stats {...}``);
``load_model`` also fills the ``stats`` dict a caller passes with it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..models.config import ModelConfig
from ..ops.linear import DenseLinear, LinearWeight, QuantEmbedding, fuse_linears
from ..quant.repack import repack, to_quant_linear

_FLOAT_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


MODES = ("quant", "dense")


class _Pending:
    """Placeholder for a cached quantized tensor, resolved by the bulk upload
    at the end of the load.

    ``kind``: "linear" -> QuantLinear; "embed" -> QuantEmbedding; and
    "tied_output" -> the embedding's table as the head (the same arrays).
    """

    __slots__ = ("name", "kind")

    def __init__(self, name: str, kind: str = "linear"):
        self.name = name
        self.kind = kind


def _repack(reader: GGUFReader, name: str, stats: dict):
    """``quant.repack.repack`` of tensor ``name``, its seconds booked to the
    native or the numpy path."""
    from .. import native

    info = reader.tensors[name]
    out_f, in_f = info.shape
    before = sum(native.REPACKS.values())
    t0 = time.perf_counter()
    rp = repack(reader.tensor_bytes(name), info.ggml_type, out_f, in_f)
    key = "native" if sum(native.REPACKS.values()) > before else "numpy"
    stats[f"repack_{key}_s"] += time.perf_counter() - t0
    stats[f"repacked_{key}"] += 1
    return rp


def _owned(rp):
    """``rp`` with its arrays read out of the cache's memory map."""
    return dataclasses.replace(rp, **{f: None if getattr(rp, f) is None
                                      else np.array(getattr(rp, f))
                                      for f in ("codes", "d", "sc", "dmin", "mn")})


def _load_linear(reader: GGUFReader, name: str, device: torch.device,
                 mode: str = "quant", cache=None,
                 stats: dict | None = None) -> LinearWeight | _Pending:
    info = reader.tensors[name]
    out_f, in_f = info.shape  # numpy order (out, in); blocks run along in
    if info.ggml_type in _FLOAT_TYPES:
        return DenseLinear.from_f32(reader.tensor_f32(name), device)
    if mode == "dense":
        return DenseLinear(w=_dense(reader, name, device), out_features=out_f, in_features=in_f)
    stats = stats if stats is not None else _new_stats()
    if cache is not None:
        rp = None
        if name not in cache.tensors:
            rp = _repack(reader, name, stats)
            t0 = time.perf_counter()
            cache.put(name, rp)            # a no-op if another process holds it
            stats["cache_write_s"] += time.perf_counter() - t0
        else:
            stats["cache_hits"] += 1
        if name in cache.tensors and _bulk_enabled():
            return _Pending(name)          # shipped in bulk at the end
        if rp is None:
            rp = cache.get(name)
            rp = None if rp is None else _owned(rp)
        if rp is not None:
            return to_quant_linear(rp, device)
    return to_quant_linear(_repack(reader, name, stats), device)


def _bulk_enabled() -> bool:
    from .device_upload import upload_enabled
    return upload_enabled()


def _new_stats() -> dict:
    """A load's split: seconds of repack (native C++ or numpy) and cache
    write, tensors repacked and read from the cache; the bulk upload adds
    its host staging, copy to the card and carve (device time)."""
    return {"repack_native_s": 0.0, "repack_numpy_s": 0.0, "repacked_native": 0,
            "repacked_numpy": 0, "cache_write_s": 0.0, "cache_hits": 0}


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
               lora_scale: float = 1.0, stats: dict | None = None):
    """Returns (config, params, reader).

    ``mode`` is ``quant`` or ``dense`` (the module's docstring).
    ``fuse=True`` row-concatenates QKV and gate+up projections into single
    linears (fewer kernel launches per layer; exact). ``lora_path`` applies
    a GGUF LoRA adapter (llama-server ``--lora``, ``runtime.lora``) scaled by
    ``lora_scale`` before the fusion, so adapted projections stay unfused.
    The layout cache serves ``quant`` mode only. ``stats``, when given,
    gets the load's split (:func:`_new_stats`, ``total_s``, the cache's
    directory).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata)
    cache = _open_cache(path, mode)
    st = _new_stats()
    params = _load_params(reader, cfg, dev, mode, cache, st)
    params = _ship_cached(params, cache, dev, st)
    if lora_path:
        from .lora import apply_lora
        apply_lora(params, lora_path, lora_scale, arch=cfg.arch, device=dev)
    if fuse:
        for layer in params["layers"]:
            _fuse_layer(layer, cfg)
    _report(st, cache, dev, t_start, stats)
    return cfg, params, reader


def _open_cache(path, mode: str):
    """The layout cache of ``path`` in ``quant`` mode, else None."""
    if mode != "quant":
        return None
    from .layout_cache import LayoutCache
    return LayoutCache.open(path)


def _ship_cached(params: dict, cache, dev: torch.device, stats: dict) -> dict:
    """Resolve the cached placeholders in one bulk upload, then finalize the
    cache (resolve first: a cold boot's blob is still its tmp file)."""
    if cache is None:
        return params
    params = _resolve_pending(params, cache, dev, stats)
    t0 = time.perf_counter()
    cache.finalize()
    stats["cache_write_s"] += time.perf_counter() - t0
    return params


def _report(st: dict, cache, dev: torch.device, t_start: float, stats: dict | None) -> None:
    """Print the load's split (``[loader] load_stats {...}``) and copy it
    into ``stats``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    st["total_s"] = time.perf_counter() - t_start
    st["layout_cache"] = None if cache is None else str(cache.dir)
    st = {k: round(v, 4) if isinstance(v, float) else v for k, v in st.items()}
    print(f"[loader] load_stats {json.dumps(st)}", flush=True)
    if stats is not None:
        stats.update(st)


def load_encoder(path: str | Path, device: str | torch.device = "cuda", mode: str = "quant"):
    """BERT-family encoder GGUF -> (EncoderConfig, params, reader).

    Tensor names follow llama.cpp's ``convert_hf_to_gguf.py::BertModel``:
    token_embd / token_types / position_embd + token_embd_norm, and per
    block attn_q/k/v(+bias), attn_output(+bias), attn_output_norm,
    ffn_up/ffn_down(+bias), layer_output_norm. Projections load as the
    decoder's do (``mode``, the layout cache and the bulk upload in
    ``quant`` mode); norms and biases stay f32, the three embedding tables
    bf16. The load's split is printed as :func:`load_model`'s.
    """
    from ..models.encoder import EncoderConfig

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    reader = GGUFReader(path)
    cfg = EncoderConfig.from_gguf_metadata(reader.metadata)
    t = reader.tensors
    cache = _open_cache(path, mode)
    st = _new_stats()
    params: dict[str, Any] = {
        "tok_embd": _load_array(reader, "token_embd.weight", dev, torch.bfloat16),
        "type_embd": _load_array(reader, "token_types.weight", dev, torch.bfloat16),
        "pos_embd": _load_array(reader, "position_embd.weight", dev, torch.bfloat16),
        "embd_norm": _load_array(reader, "token_embd_norm.weight", dev),
        "embd_norm_bias": _load_array(reader, "token_embd_norm.bias", dev),
    }
    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {}
        for n in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_up", "ffn_down"):
            layer[n] = _load_linear(reader, p + n + ".weight", dev, mode, cache, st)
            if p + n + ".bias" in t:
                layer[n + "_bias"] = _load_array(reader, p + n + ".bias", dev)
        for n in ("attn_output_norm", "layer_output_norm"):
            layer[n] = _load_array(reader, p + n + ".weight", dev)
            layer[n + "_bias"] = _load_array(reader, p + n + ".bias", dev)
        layers.append(layer)
    params["layers"] = layers
    params = _ship_cached(params, cache, dev, st)
    _report(st, cache, dev, t_start, None)
    return cfg, params, reader


def _load_params(reader: GGUFReader, cfg: ModelConfig, dev: torch.device, mode: str,
                 cache, stats: dict) -> dict[str, Any]:
    t = reader.tensors
    emb_name = "token_embd.weight"
    if t[emb_name].ggml_type in _FLOAT_TYPES:
        tok_embd = _load_array(reader, emb_name, dev, torch.bfloat16)
    elif mode == "dense":
        tok_embd = _dense(reader, emb_name, dev)
    else:
        table = _load_linear(reader, emb_name, dev, mode, cache, stats)
        tok_embd = _Pending(emb_name, "embed") if isinstance(table, _Pending) \
            else QuantEmbedding(table=table)
    params: dict[str, Any] = {
        "tok_embd": tok_embd,
        "output_norm": _load_array(reader, "output_norm.weight", dev),
    }
    # starcoder2's LayerNorm bias; phi3's longrope per-dim frequency factors
    for n in ("output_norm.bias", "rope_factors_long.weight", "rope_factors_short.weight"):
        if n in t:
            params[n.replace(".weight", "").replace(".", "_")] = _load_array(reader, n, dev)
    if "output.weight" in t:
        params["output"] = _load_linear(reader, "output.weight", dev, mode, cache, stats)
    elif isinstance(tok_embd, _Pending):
        params["output"] = _Pending(emb_name, "tied_output")
    elif isinstance(tok_embd, QuantEmbedding):
        # tied head: the matmul runs straight off the shared quantized arrays
        params["output"] = tok_embd.table
    else:
        params["output"] = DenseLinear(w=tok_embd, out_features=tok_embd.shape[0],
                                       in_features=tok_embd.shape[1])

    def linear(name: str):
        return _load_linear(reader, name, dev, mode, cache, stats)

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {}
        # pre-norms: olmo2 has post-norms only, command-r no ffn_norm (one
        # pre-norm feeds both parallel branches); every other architecture
        # needs both, so a truncated GGUF fails here instead of running
        # without a norm
        for n in ("attn_norm", "ffn_norm"):
            if p + n + ".weight" in t:
                layer[n] = _load_array(reader, p + n + ".weight", dev)
            elif not (cfg.arch == "olmo2" or (cfg.arch == "command-r" and n == "ffn_norm")):
                raise KeyError(f"{p}{n}.weight missing from GGUF "
                               f"(required for arch {cfg.arch!r})")
        if p + "attn_qkv.weight" in t:                 # phi3 ships QKV fused
            layer["attn_qkv"] = linear(p + "attn_qkv.weight")
        else:
            for n in ("attn_q", "attn_k", "attn_v"):
                layer[n] = linear(p + n + ".weight")
        layer["attn_output"] = linear(p + "attn_output.weight")
        # optional tensors: Q/K/V biases (qwen2), Q/K norms (qwen3, gemma3
        # per head; olmo2 flat), post-norms (gemma2/3, olmo2), LayerNorm and
        # projection biases (starcoder2); the graph reads what is present
        for n in _OPTIONAL:
            if p + n in t:
                layer[n.replace(".weight", "").replace(".", "_")] = \
                    _load_array(reader, p + n, dev)
        if not cfg.ffn_gated:                          # starcoder2: up -> act -> down
            names = ("ffn_up", "ffn_down")
        elif p + "ffn_gate.weight" not in t:           # phi3: gate+up as one ffn_up
            layer["ffn_gateup"] = linear(p + "ffn_up.weight")
            names = ("ffn_down",)
        else:
            names = ("ffn_gate", "ffn_up", "ffn_down")
        for n in names:
            layer[n] = linear(p + n + ".weight")
        layers.append(layer)
    params["layers"] = layers
    return params


_OPTIONAL = ("attn_q.bias", "attn_k.bias", "attn_v.bias", "attn_q_norm.weight",
             "attn_k_norm.weight", "attn_post_norm.weight", "ffn_post_norm.weight",
             "attn_output.bias", "attn_norm.bias", "ffn_norm.bias", "ffn_up.bias",
             "ffn_down.bias")


def _resolve_pending(params: dict, cache, dev: torch.device, stats: dict) -> dict:
    """Replace every :class:`_Pending` by its weight from ONE bulk upload
    (``runtime.device_upload``); the embedding and a tied head share the
    same arrays."""
    def walk(node, fn):
        if isinstance(node, dict):
            return {k: walk(v, fn) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, fn) for v in node]
        return fn(node)

    names: set[str] = set()
    walk(params, lambda x: names.add(x.name) if isinstance(x, _Pending) else None)
    if not names:
        return params
    from .device_upload import bulk_upload
    resolved = bulk_upload(cache, sorted(names), dev, stats)

    def sub(x):
        if not isinstance(x, _Pending):
            return x
        ql = resolved[x.name]
        return QuantEmbedding(table=ql) if x.kind == "embed" else ql

    return walk(params, sub)


def _fuse_layer(layer: dict, cfg: ModelConfig) -> None:
    """Row-concatenate QKV (and the qwen2 Q/K/V biases) and gate+up
    projections in place (exact). Skipped where the file fused them already
    (phi3) and for olmo2's flat q/k norms, which apply to q and k apart."""
    if "attn_q" not in layer:
        return
    if "attn_q_norm" in layer and layer["attn_q_norm"].shape[-1] != cfg.head_dim:
        return
    qkv = fuse_linears([layer["attn_q"], layer["attn_k"], layer["attn_v"]])
    if qkv is not None:
        layer["attn_qkv"] = qkv
        del layer["attn_q"], layer["attn_k"], layer["attn_v"]
        if "attn_q_bias" in layer:
            layer["attn_qkv_bias"] = torch.cat([layer.pop("attn_q_bias"),
                                                layer.pop("attn_k_bias"),
                                                layer.pop("attn_v_bias")])
    if "ffn_gate" in layer:
        gu = fuse_linears([layer["ffn_gate"], layer["ffn_up"]])
        if gu is not None:
            layer["ffn_gateup"] = gu
            del layer["ffn_gate"], layer["ffn_up"]
