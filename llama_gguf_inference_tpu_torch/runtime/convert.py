"""Carry a parameter tree given as numpy arrays over to this package.

``params_from_numpy(tree, device)`` builds the port's parameters from a tree
of plain numpy arrays and dicts, e.g. the JAX package's parameters after a
caller converted every array to numpy:

- a quantized linear is a dict with ``codes``, ``d``, ``sc``, ``dmin``,
  ``mn`` (None where absent) and its static fields ``fmt``, ``bits``,
  ``sub_size``, ``d_size``, ``code_bias``, ``min_size``, ``out_features``,
  ``in_features``;
- a dense linear is ``{"w": ...}``;
- a quantized embedding is ``{"table": <quantized linear dict>}``;
- norms, biases (the encoder's ``*_bias`` leaves) and dense embedding
  tables are plain arrays;
- lists (``layers``) and other dicts recurse, so the JAX encoder's tree
  (``runtime.loader.load_encoder``'s keys) carries over as the decoder's.

bf16 arrays (numpy's ``bfloat16`` extension dtype) keep their bits exactly.

``cache_from_numpy(fields, device)`` builds the port's KV cache from a
cache's fields given as numpy arrays (an L-list per per-layer field, one
array for ``page_table``), e.g. a JAX ``KVCache``, ``QuantKV``,
``QuantKV4``, ``QuantKV41``, ``PagedKV`` or ``PagedQuantKV`` after
``_asdict()`` and ``numpy.asarray`` of every array; each per-layer tensor
gets the sink rows the port's KV writes need (``models.llama.sink_zeros``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import KVCache, with_sink
from ..ops.linear import DenseLinear, QuantEmbedding, QuantLinear
from .kv_cache import QuantKV, QuantKV4, QuantKV41
from .paged_kv import PagedKV, PagedQuantKV

_STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "min_size",
           "out_features", "in_features")


def _tensor(a, device: torch.device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, list | tuple):
            return [conv(n) for n in node]
        if not isinstance(node, dict):
            return _tensor(node, dev)
        if "codes" in node:
            return QuantLinear(
                **{k: _tensor(node.get(k), dev)
                   for k in ("codes", "d", "sc", "dmin", "mn")},
                **{k: (str(node[k]) if k == "fmt" else int(node[k]))
                   for k in _STATIC if k in node})
        if "table" in node and len(node) == 1:
            return QuantEmbedding(table=conv(node["table"]))
        if "w" in node and len(node) == 1:
            w = _tensor(node["w"], dev)
            return DenseLinear(w=w, out_features=w.shape[0],
                               in_features=w.shape[1])
        return {k: conv(v) for k, v in node.items()}

    return conv(tree)


def cache_from_numpy(fields: dict, device: str | torch.device = "cuda"):
    """The cache kind follows the field names (and, for 4-bit against 8-bit
    codes, the code dtype)."""
    dev = resolve_device(device)
    names = set(fields)
    if "page_table" in names:
        cls = PagedQuantKV if "k_q" in names else PagedKV
    elif "k_m" in names:
        cls = QuantKV41
    elif "k_q" in names:
        cls = QuantKV if np.asarray(fields["k_q"][0]).dtype == np.int8 else QuantKV4
    else:
        cls = KVCache
    return cls(**{k: (_tensor(v, dev) if k == "page_table"
                      else [with_sink(_tensor(a, dev)) for a in v])
                  for k, v in fields.items()})
