"""GGUF LoRA adapters (llama-server ``--lora`` / ``--lora-scaled``).

llama.cpp applies an adapter as ``y = W x + scale * B (A x)`` with ``scale =
user_scale * alpha / rank``. This module parses the adapter GGUF (as
llama.cpp's ``convert_lora_to_gguf.py`` writes it: ``general.type =
"adapter"``, ``adapter.type = "lora"``, ``adapter.lora.alpha`` and per-tensor
``<base>.lora_a`` (r, in) / ``<base>.lora_b`` (out, r) pairs) and wraps the
matching loaded weights in :class:`ops.linear.LoraLinear`: the quantized base
stays resident and runs its kernels, the rank-r products run in PyTorch.

``runtime.loader.load_model`` applies it BEFORE the QKV and gate+up fusion,
which skips wrapped weights. The JAX package's ``runtime/lora.py``, ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import GGUFReader

log = logging.getLogger(__name__)

_A, _B = ".lora_a", ".lora_b"


def load_adapter(path: str, arch: str = ""
                 ) -> tuple[float, dict[str, tuple[np.ndarray, np.ndarray]]]:
    """Returns (alpha, {base_tensor_name: (A (r, in), B (out, r))}) as f32.

    ``arch``, when given, must match the adapter's ``general.architecture``:
    llama.cpp refuses a mismatched adapter, and applying one would silently
    corrupt any tensors of the same names."""
    r = GGUFReader(path)
    try:
        md = r.metadata
        if str(md.get("general.type", "")) != "adapter" \
                or str(md.get("adapter.type", "")) != "lora":
            raise ValueError(f"{path} is not a GGUF LoRA adapter "
                             "(expected general.type=adapter, adapter.type=lora)")
        ad_arch = str(md.get("general.architecture", ""))
        if arch and ad_arch and ad_arch != arch:
            raise ValueError(f"adapter {path} was trained for architecture "
                             f"'{ad_arch}', base model is '{arch}'")
        alpha = float(md.get("adapter.lora.alpha", 0.0))
        pairs: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for name in r.tensors:
            if not name.endswith(_A):
                continue
            base = name[: -len(_A)]
            if base + _B not in r.tensors:
                raise ValueError(f"adapter tensor {name} has no {base}{_B}")
            pairs[base] = (r.tensor_f32(name), r.tensor_f32(base + _B))
        return alpha, pairs
    finally:
        r.close()


def _resolve(params: dict, base_name: str):
    """GGUF tensor name -> (container, key) holding the linear weight, or
    (None, None)."""
    if not base_name.endswith(".weight"):
        return None, None
    stem = base_name[: -len(".weight")]
    if stem == "output":
        return params, "output"
    if stem.startswith("blk."):
        parts = stem.split(".", 2)          # ["blk", "<i>", "<key>"]
        if len(parts) == 3 and parts[1].isdigit():
            i = int(parts[1])
            if i < len(params["layers"]):
                layer = params["layers"][i]
                key = parts[2].replace(".", "_")
                if key in layer:
                    return layer, key
    return None, None


def apply_lora(params: dict, path: str, scale: float = 1.0, arch: str = "",
               device: str | torch.device = "cuda") -> int:
    """Wrap the matching weights of ``params`` in LoraLinear in place (A and
    B as bf16 on ``device``); returns how many were wrapped.

    Adapter tensors with no linear weight to ride (the token embedding,
    which is gathered, not multiplied) are skipped with a warning, as
    llama.cpp skips them."""
    from ..ops.linear import DenseLinear, LoraLinear, QuantLinear

    dev = resolve_device(device)
    alpha, pairs = load_adapter(path, arch=arch)
    applied = 0
    for base_name, (a, b) in sorted(pairs.items()):
        container, key = _resolve(params, base_name)
        tgt = container[key] if container is not None else None
        if not isinstance(tgt, (DenseLinear, QuantLinear)):
            log.warning("lora: skipping %s (no matching linear weight)", base_name)
            continue
        rank = int(a.shape[0])
        if (a.shape[1] != tgt.in_features or b.shape[0] != tgt.out_features
                or b.shape[1] != rank):
            raise ValueError(f"lora shape mismatch on {base_name}: A{tuple(a.shape)} "
                             f"B{tuple(b.shape)} vs weight ({tgt.out_features}, "
                             f"{tgt.in_features})")
        s = scale * (alpha / rank if alpha > 0 else 1.0)
        container[key] = LoraLinear(
            base=tgt, a=torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.bfloat16),
            b=torch.from_numpy(np.ascontiguousarray(b)).to(dev, torch.bfloat16),
            scale=float(s))
        applied += 1
    log.info("lora: applied %d/%d adapter tensors from %s (alpha=%g, scale=%g)",
             applied, len(pairs), path, alpha, scale)
    return applied
