"""Embedding-model engine: BERT-family encoder GGUFs behind the same
serving surface as the decoder engine.

llama-server runs embedding models (bge, nomic-embed-text and friends) with
``--embedding``: /v1/embeddings and /rerank work, text completion returns an
error. This engine does the same: ``embed()`` is the real path, ``submit()``
yields a single terminal ``finish_reason="error"`` event that the server
surfaces as it does an engine failure. Its ``stats()`` keys are the JAX
engine's.

One forward a request, over the input padded to the smallest bucket that
holds it (``encoder_forward`` pools and L2-normalizes in the same call).
"""

from __future__ import annotations

import queue
import threading

import torch

from ..device import resolve_device
from ..models.encoder import encoder_forward
from . import tokenizer as tokenizer_mod
from .engine import GenEvent
from .loader import load_encoder


class _Limits:
    """The slot and context limits a handler may read (``engine.ecfg``)."""

    def __init__(self, ctx: int):
        self.max_slots = 1
        self.ctx = ctx


class EncoderEngine:
    """submit/stream surface of InferenceEngine, embedding only."""

    def __init__(self, model_path: str, buckets: tuple[int, ...] = (64, 512),
                 mode: str = "quant", device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        cfg, params, reader = load_encoder(model_path, self.device, mode=mode)
        self.cfg = cfg
        self.params = params
        self.metadata = dict(reader.metadata)
        reader.close()
        self.model_name = str(self.metadata.get("general.name", "model"))
        self.tokenizer = tokenizer_mod.from_gguf_metadata(self.metadata)
        self.buckets = tuple(sorted(min(b, cfg.max_positions) for b in buckets))
        self.total_prompt_tokens = 0
        self.total_generated = 0
        self._lock = threading.Lock()
        self.ecfg = _Limits(cfg.max_positions)
        self._fwd = encoder_forward

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def n_active(self) -> int:
        return 0

    def queue_depth(self) -> int:
        return 0

    # ------------------------------------------------------------- requests
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def embed(self, prompt: str | list[int]) -> tuple[list[float], int]:
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        if len(ids) > self.buckets[-1]:
            # cut the content and keep the [CLS] ... [SEP] frame, as HF and
            # llama.cpp clip; chopping the trailing [SEP] off instead drifts
            # the embedding
            sep = self.tokenizer.special.eos_id
            ids = ids[: self.buckets[-1]]
            if sep >= 0:
                ids[-1] = sep
        T = self._bucket(len(ids))
        tok = torch.zeros((1, T), dtype=torch.int32)
        tok[0, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        with torch.inference_mode():
            vec = self._fwd(self.params, self.cfg, tok.to(self.device),
                            torch.tensor([len(ids)], dtype=torch.int32, device=self.device))
        with self._lock:
            self.total_prompt_tokens += len(ids)
        return vec[0].cpu().tolist(), len(ids)

    def submit(self, prompt, params, request_id=None):
        """Text generation on an encoder: one terminal error event, the
        shape of the decoder engine's failure event (llama-server
        ``--embedding`` answers the same way)."""
        rid = request_id or "encoder-req"
        out: "queue.Queue[GenEvent]" = queue.Queue()
        out.put(GenEvent(finished=True, finish_reason="error",
                         text=f"model {self.model_name!r} is an "
                              "embedding-only encoder (no text generation)"))
        return rid, out

    def cancel(self, request_id: str) -> bool:
        return False

    def stats(self) -> dict:
        return {
            "model": self.model_name,
            "mode": "embedding",
            "slots_total": 0,
            "slots_active": 0,
            "queue_depth": 0,
            "ctx": self.cfg.max_positions,
            "total_generated": 0,
            "total_prompt_tokens": self.total_prompt_tokens,
        }
