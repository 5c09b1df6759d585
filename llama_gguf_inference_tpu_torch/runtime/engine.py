"""The inference engine: slots, continuous batching, streaming.

- ``max_slots`` sequences share one decode batch; a dispatch advances every
  slot by ``multi_step`` forward+sample steps (free slots run on pad tokens
  parked past their kept prefix, and their outputs are dropped)
- sampling state lives on the card (``sampler.SampleState``): admission
  writes a slot's parameters, prompt counts and logit bias there, and the
  final prefill chunk's last row is sampled for the first token by the same
  batched ``sample`` the decode steps use
- grammar-constrained requests (GBNF, JSON schema, forced tool calls): a
  host-side matcher per slot (``grammar.GrammarMatcher``) steps with every
  emitted token, and the slot's bias row on the card is rewritten with
  ``-inf`` on every token the grammar forbids before the next dispatch; such
  a batch decodes one step a dispatch
- slot prompt caching (``prefix_cache``, on by default as llama-server's
  prompt cache): a freed slot keeps its KV, admission picks the free slot
  whose kept tokens share the longest prefix with the prompt and prefills
  only the rest; free rows of a decode batch park just past their slot's
  claim, so they never overwrite it (contiguous caches only)
- a decode dispatch keeps its tokens and offsets on the card between steps
  and brings its (N, B) tokens back once, through pinned memory and a CUDA
  event; the host keeps its own copy of the offsets. With ``multi_step`` > 1
  the next dispatch (a continuation) is issued from the previous one's
  on-card outputs before the host waits for them, so the card works while
  the host emits tokens (the JAX engine's pipelined dispatch). One stream
  only: the split flash kernel's arrival counters are shared per device
- prompt prefill runs per slot in bucketed chunks written straight into that
  slot's rows of the KV cache
- stop handling (EOG, ``max_tokens``, slot capacity, stop strings),
  detokenization and the first token's logprobs run on the host
- the engine is transport-agnostic: the server talks to it through
  ``submit()`` and per-request thread-safe event queues
- the KV cache is bf16, q8_0, q4_0 or q4_1 (``kv_dtype``), contiguous
  (each slot owns ``ctx`` tokens) or paged (``kv_layout="paged"``: slots
  share a pool of ``max_slots * ctx`` tokens; a request reserves the pages
  for its prompt and ``max_tokens`` at admission and waits at the head of
  the line while the pool is short); deepseek2's latent cache (one shared
  head, k and v of different widths) is contiguous bf16 only, as in the
  JAX engine
- context shift (``ctx_shift``, llama-server ``--ctx-shift``, contiguous
  caches): a slot that cannot hold the next dispatch keeps its first
  positions, drops half the rest and re-ropes the moved K
  (``models.llama.shift_cache_slot``) instead of finishing at its capacity;
  refused, as in the JAX engine, for MLA, sliding-window and longrope
  models
- slot save/restore/erase (``slot_op``, llama-server ``POST
  /slots/{id}?action=...``, contiguous caches): a free slot's kept prompt
  and its KV rows to an ``.npz`` file in the JAX engine's format and back,
  run on the scheduler thread with no dispatch in flight
- weights quantized-resident or dense (``mode``), with a GGUF LoRA adapter
  (``lora_path``, ``lora_scale``); the split of the load's seconds is
  ``load_stats`` (``runtime.loader.load_model``'s ``stats``)
- ``embed``: a mean-pooled embedding of a prompt (``/v1/embeddings``,
  ``/rerank``), one forward on a scratch cache of its own, outside the
  scheduler
- ``warmup_async``: builds the CUDA kernels, then pushes synthetic requests
  through the real path (the server runs it at start unless
  ``ENGINE_WARMUP=0``)

Not yet here (the JAX engine has them): speculation and a decode step
captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import traceback
import uuid
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import KVCache, forward, shift_cache_slot
from .kv_cache import QuantKV, QuantKV4, QuantKV41
from .loader import load_model
from .paged_kv import PageAllocator, PagedKV, PagedQuantKV
from .sampler import (Gates, SampleState, SamplingParams, bias_row, sample, to_device,
                      token_logprobs)
from .tokenizer import Tokenizer, from_gguf_metadata


# prefill chunk lengths: a prompt runs in chunks of at most the largest,
# each padded to the smallest bucket that holds it
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)
# the JAX engine's prefill buckets: the embedding forward pads a prompt to
# one of them (truncating at the largest), and the warm-up sends a prompt of
# each length
JAX_BUCKETS = (*PREFILL_BUCKETS, 1024)
CONTIG_CACHES = {"bf16": KVCache, "q8_0": QuantKV, "q4_0": QuantKV4, "q4_1": QuantKV41}


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 4
    ctx: int = 2048                    # per-slot KV capacity
    kv_dtype: str = "bf16"             # "bf16" | "q8_0" | "q4_0" | "q4_1"
    # "contig": each slot owns a fixed ctx-token region. "paged": slots
    # share a pool of max_slots * ctx tokens through per-slot page tables,
    # so one request can hold far more than ctx while others are idle
    # (llama.cpp's unified KV)
    kv_layout: str = "contig"
    kv_page_size: int = 1024           # paged: tokens per physical page
    multi_step: int = 1                # decode steps fused per dispatch (1 = off)
    # llama-server-style slot prompt caching: freed slots keep their KV;
    # admission picks the free slot with the longest common prompt prefix
    # and prefills only the suffix. Contiguous layout only: a paged slot
    # returns its pages to the pool
    prefix_cache: bool = True
    # weight residency: "quant" (quantized-resident, the kernels) or "dense"
    # (every weight dequantized to bf16, the correctness baseline)
    mode: str = "quant"
    # context shift (llama-server --ctx-shift): when a slot's KV region
    # fills mid-generation, keep its first positions (the prompt, at most
    # half the region), discard half the rest, roll the remainder left and
    # re-rope the cached K, and generate on instead of finishing "length".
    # Contiguous KV only; off by default, as in llama-server
    ctx_shift: bool = False
    # GGUF LoRA adapter (llama-server --lora / --lora-scaled; runtime.lora),
    # wrapped around the loaded weights (the quantized base stays resident)
    lora_path: str = ""
    lora_scale: float = 1.0


def make_kv_cache(cfg, ecfg: EngineConfig, device):
    """The KV cache ``ecfg`` asks for, and its page allocator (None unless
    paged). A paged pool holds ``max_slots * ctx`` tokens, contig's memory."""
    B, S = ecfg.max_slots, ecfg.ctx
    if ecfg.kv_layout != "paged":
        return CONTIG_CACHES[ecfg.kv_dtype].zeros(cfg, B, S, device), None
    pool_pages = max(1, (B * S) // ecfg.kv_page_size)
    cls = PagedQuantKV if ecfg.kv_dtype == "q8_0" else PagedKV
    return (cls.zeros(cfg, B, pool_pages, ecfg.kv_page_size, device),
            PageAllocator(pool_pages, B))


@dataclasses.dataclass
class GenEvent:
    """One streamed token (or terminal event) for a request."""

    token_id: int = -1
    text: str = ""
    finished: bool = False
    finish_reason: str | None = None   # "stop" | "length" | "error"
    n_prompt: int = 0
    n_generated: int = 0
    logprob: float | None = None
    top_logprobs: list[tuple[int, float]] | None = None


@dataclasses.dataclass
class _Slot:
    state: str = "free"                # free | active
    request_id: str = ""
    prompt_ids: list[int] = dataclasses.field(default_factory=list)
    generated: list[int] = dataclasses.field(default_factory=list)
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out: "queue.Queue[GenEvent]" = dataclasses.field(default_factory=queue.Queue)
    pending_text: str = ""             # held back: possible stop-string prefix
    utf8_buf: bytes = b""              # held back: incomplete UTF-8 sequence
    offset: int = 0                    # tokens currently in this slot's cache
    cached_ids: list[int] = dataclasses.field(default_factory=list)
    """Tokens whose KV sit at positions [0, len) of this slot's region,
    kept across release for prompt-prefix reuse."""
    matcher: object = None             # grammar.GrammarMatcher (constrained)
    static_bias: np.ndarray | None = None   # (V,) logit_bias row under a grammar
    mask_dirty: bool = False           # matcher advanced; the card's row is stale
    shift_keep: int | None = None      # positions every context shift kept


def _utf8_split(buf: bytes, flush: bool = False) -> tuple[str, bytes]:
    """Split ``buf`` into (decodable prefix, held-back incomplete suffix)."""
    if not buf:
        return "", b""
    if flush:
        return buf.decode("utf-8", errors="replace"), b""
    for cut in range(len(buf), max(len(buf) - 4, -1), -1):
        try:
            return buf[:cut].decode("utf-8"), buf[cut:]
        except UnicodeDecodeError:
            continue
    return buf.decode("utf-8", errors="replace"), b""


class InferenceEngine:
    """Owns model weights, the KV cache, the sampling state and the scheduler
    thread."""

    TOP_LOGPROBS_K = 8   # top-k logprobs computed per step (OpenAI `logprobs`)

    def __init__(self, model_path: str, engine_cfg: EngineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        if ecfg.kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r} "
                             "(expected 'contig' or 'paged')")
        if ecfg.kv_dtype not in CONTIG_CACHES:
            raise ValueError(f"unknown kv_dtype {ecfg.kv_dtype!r} "
                             f"(expected one of {sorted(CONTIG_CACHES)})")
        if ecfg.kv_layout == "paged" and ecfg.kv_dtype in ("q4_0", "q4_1"):
            raise ValueError("kv_layout='paged' supports bf16 and q8_0 "
                             "KV (4-bit paged pools are not built)")
        if ecfg.multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {ecfg.multi_step}")
        if ecfg.ctx_shift and ecfg.kv_layout != "contig":
            raise ValueError("ctx_shift requires the contiguous KV layout "
                             "(cached K is re-roped in place)")
        if ecfg.ctx_shift and ecfg.ctx < 4 * (ecfg.multi_step + 1):
            # a shift then keeps up to ctx // 2 positions and may discard a
            # whole margin of multi_step + 1 below them: the next tokens
            # would overwrite kept prompt rows
            raise ValueError(f"ctx_shift needs ctx >= 4 * (multi_step + 1) = "
                             f"{4 * (ecfg.multi_step + 1)}, got {ecfg.ctx}")
        self.load_stats: dict = {}
        cfg, params, reader = load_model(model_path, self.device, fuse=True, mode=ecfg.mode,
                                         lora_path=ecfg.lora_path,
                                         lora_scale=ecfg.lora_scale, stats=self.load_stats)
        if cfg.is_mla and (ecfg.kv_layout != "contig" or ecfg.kv_dtype != "bf16"):
            raise ValueError("deepseek2 (MLA) supports the contiguous bf16 "
                             "KV layout only (k/v head dims differ)")
        if ecfg.ctx_shift and (cfg.is_mla or cfg.sliding_window > 0
                               or cfg.rope_scaling_type == "longrope"):
            # the shift re-ropes every layer's whole K with the global base
            # and no frequency factors: wrong for sliding layers' own base,
            # for longrope's per-dim factors and for MLA's cache, whose K is
            # only the decoupled rope dims
            raise ValueError("ctx_shift supports full-attention rope models "
                             "only (no MLA / sliding-window / longrope)")
        self.model_path = str(model_path)
        self.cfg = cfg
        self.params = params
        self.metadata = dict(reader.metadata)
        self.tokenizer: Tokenizer = from_gguf_metadata(reader.metadata)
        self.model_name = str(self.metadata.get("general.name", "model"))
        reader.close()
        self.cache, self.alloc = make_kv_cache(cfg, ecfg, self.device)
        self.sample_state = SampleState.init(ecfg.max_slots, cfg.vocab_size, self.device)
        self.slots = [_Slot() for _ in range(ecfg.max_slots)]
        self._pending: dict | None = None  # the decode dispatch in flight
        self.dispatches = 0               # decode dispatches issued
        self.continuations = 0            # ... of them issued before the previous one was read
        self.total_generated = 0
        self.total_prompt_tokens = 0
        self.total_prefix_reused = 0      # prompt tokens skipped by slot reuse
        self.total_ctx_shifts = 0         # context shifts (ctx_shift)
        self._last_decode_s = 0.0         # EWMA of a decode step's wall time
        # slot save/restore/erase, run on the scheduler thread between
        # dispatches: (op, slot, path, reply queue)
        self._slot_ops: "queue.Queue[tuple[str, int, str, queue.Queue]]" = queue.Queue()
        self._token_trie = None           # grammar.TokenTrie, built on first use
        self._grammar_cache: dict = {}    # GBNF text -> parsed Grammar
        self._queue: "queue.Queue[tuple[str, list[int], SamplingParams, queue.Queue]]" = queue.Queue()
        self._waiting: list = []          # paged: the head of the line, short of pages
        self._cancelled: set[str] = set()
        self._stop_evt = threading.Event()
        self._wake = threading.Event()    # set by submit()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- requests
    def submit(self, prompt: str | list[int], params: SamplingParams,
               request_id: str | None = None) -> tuple[str, "queue.Queue[GenEvent]"]:
        """Enqueue a request; returns (request_id, event queue). A grammar
        that does not parse fails this request alone, with an ``error``
        event whose text says why."""
        rid = request_id or uuid.uuid4().hex[:16]
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        ids = ids[: self.cache.max_seq - 1]
        out: "queue.Queue[GenEvent]" = queue.Queue()
        self._queue.put((rid, ids, params, out))
        self._wake.set()
        return rid, out

    def generate(self, prompt: str | list[int], params: SamplingParams | None = None,
                 timeout: float = 1800.0) -> Iterator[GenEvent]:
        """Blocking iterator over one request's stream."""
        _, out = self.submit(prompt, params or SamplingParams())
        while True:
            ev = out.get(timeout=timeout)
            yield ev
            if ev.finished:
                return

    def generate_text(self, prompt: str | list[int],
                      params: SamplingParams | None = None) -> str:
        return "".join(ev.text for ev in self.generate(prompt, params))

    def cancel(self, request_id: str) -> bool:
        """Abort a request: frees its slot at the next scheduler boundary."""
        self._cancelled.add(request_id)
        return True

    @torch.inference_mode()
    def embed(self, prompt: str | list[int]) -> tuple[list[float], int]:
        """Mean-pooled final-hidden-state embedding; returns (vector,
        n_tokens).

        The prompt is cut at the JAX engine's largest prefill bucket (1024
        tokens) and padded to the smallest of :data:`JAX_BUCKETS` that holds
        it; one forward runs on a scratch bf16 cache of its own, outside the
        scheduler (no slot is touched), and the hidden states of the valid
        positions are averaged in f32."""
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        ids = ids[: JAX_BUCKETS[-1]]
        n = len(ids)
        T = next(t for t in JAX_BUCKETS if n <= t)
        tok = np.zeros((1, T), np.int32)
        tok[0, :n] = ids
        cache = KVCache.zeros(self.cfg, 1, T, self.device)
        meta = to_device(np.array([0, max(n - 1, 0)], np.int32), self.device)
        _, hidden = forward(self.params, self.cfg, to_device(tok, self.device), meta[:1],
                            cache, logits_at=meta[1:], return_hidden=True)
        mask = (torch.arange(T, device=self.device) < n)[None, :, None]
        pooled = torch.where(mask, hidden.float(), 0.0).sum(dim=1) / max(n, 1)
        return pooled[0].tolist(), n

    # ------------------------------------------------------------ scheduler
    def start(self) -> None:
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="engine-loop")
            self._thread.start()

    def warmup_async(self) -> threading.Thread:
        """Warm the serving path in a daemon thread: on the card, build every
        CUDA kernel first (``ops._build.build_all``); then push the JAX
        engine's synthetic requests through the real path: one prompt
        length per bucket of :data:`JAX_BUCKETS` (at most half a slot), one
        longer than the largest when a slot holds it (its first chunks run
        without the draw), and ``3 * multi_step + 2`` tokens on the last, so
        multi-step dispatches and their continuations run too. Readiness is
        not held back: real requests queue behind the warm-up's. A failure
        prints its traceback and ``[backend] warm-up failed``; success
        prints ``[backend] warm-up done in X s``."""
        def run():
            t0 = time.time()
            try:
                if self.device.type == "cuda":
                    from ..ops import _build
                    _build.build_all()
                big = JAX_BUCKETS[-1]
                cap = self._slot_cap_max()
                lengths = [max(2, min(T, cap // 2)) for T in JAX_BUCKETS]
                if cap > big + 64:
                    lengths.append(big + 16)
                uniq = list(dict.fromkeys(lengths))
                for i, n in enumerate(uniq):
                    prompt = [7 + i] + [3 + (j % 50) for j in range(n - 1)]
                    last = i == len(uniq) - 1
                    mt = max(2, 3 * self.ecfg.multi_step + 2) if last else 2
                    for ev in self.generate(prompt, SamplingParams(temperature=0.0,
                                                                   max_tokens=mt)):
                        if ev.finish_reason == "error":
                            raise RuntimeError(f"warm-up request of {n} tokens failed: "
                                               f"{ev.text or 'engine error'}")
            except Exception:  # noqa: BLE001 — printed, never swallowed
                traceback.print_exc()
                print("[backend] warm-up failed", flush=True)
                return
            print(f"[backend] warm-up done in {time.time() - t0:.3f} s", flush=True)

        t = threading.Thread(target=run, daemon=True, name="engine-warmup")
        t.start()
        return t

    def _slot_cap_max(self) -> int:
        """Largest per-slot token capacity any request could get."""
        if self.alloc is not None:
            return self.cache.max_seq
        return self.ecfg.ctx

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._pending = None
        while True:   # slot operations that will never run
            try:
                *_, reply = self._slot_ops.get_nowait()
            except queue.Empty:
                break
            reply.put(("error", "engine stopped before the slot operation ran"))

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                worked = self.step()
            except Exception:  # noqa: BLE001 — the engine must not die silently
                traceback.print_exc()
                self._fail_all()
                continue
            if not worked:   # idle: sleep until a submit (or a cancel poll)
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        # drain the dispatch in flight so its requests get their tokens
        if self._pending is not None:
            try:
                self._drain(self._pending)
            except Exception:  # noqa: BLE001 — best effort at shutdown
                traceback.print_exc()
            self._pending = None

    def _fail_all(self) -> None:
        """Terminate every active and queued request with an error event."""
        self._pending = None
        for b, slot in enumerate(self.slots):
            if slot.state != "free":
                slot.out.put(GenEvent(finished=True, finish_reason="error",
                                      n_prompt=len(slot.prompt_ids),
                                      n_generated=len(slot.generated)))
                self._release(b)
            slot.cached_ids = []   # the cache's state is unknown after an error
        for item in self._waiting:
            item[3].put(GenEvent(finished=True, finish_reason="error"))
        self._waiting = []
        while True:
            try:
                _, _, _, out = self._queue.get_nowait()
            except queue.Empty:
                break
            out.put(GenEvent(finished=True, finish_reason="error"))

    def n_active(self) -> int:
        return sum(s.state != "free" for s in self.slots)

    def queue_depth(self) -> int:
        return self._queue.qsize() + len(self._waiting)

    def slots_info(self) -> list[dict]:
        """Per-slot scheduler state (llama-server ``GET /slots``: ``state`` 0
        = idle, 1 = processing)."""
        return [{"id": i, "state": 0 if s.state == "free" else 1,
                 "n_ctx": self.ecfg.ctx, "n_past": s.offset,
                 "n_prompt": len(s.prompt_ids), "n_generated": len(s.generated),
                 "request_id": s.request_id if s.state != "free" else "",
                 "prefix_cached_tokens": len(s.cached_ids)}
                for i, s in enumerate(self.slots)]

    def stats(self) -> dict:
        """The JAX engine's keys where the port has the feature, and the
        dispatch counters."""
        return {
            "model": self.model_name, "slots_total": self.ecfg.max_slots,
            "slots_active": self.n_active(), "queue_depth": self.queue_depth(),
            "ctx": self.ecfg.ctx, "total_generated": self.total_generated,
            "total_prompt_tokens": self.total_prompt_tokens,
            "prefix_tokens_reused": self.total_prefix_reused,
            **({"ctx_shifts": self.total_ctx_shifts} if self.ecfg.ctx_shift else {}),
            "decode_step_ewma_ms": round(self._last_decode_s * 1000, 3),
            **({"kv_pages_free": self.alloc.free_pages,
                "kv_pages_total": self.alloc.table.shape[1],
                "kv_page_size": self.ecfg.kv_page_size}
               if self.alloc is not None else {}),
            "multi_step": self.ecfg.multi_step,
            "dispatches": self.dispatches, "continuations": self.continuations}

    def step(self) -> bool:
        """One scheduler iteration. Returns True if any work was done."""
        self._reap_cancelled()
        ops = self._run_slot_ops()
        admitted = self._admit()
        decoded = self._decode()
        return ops or admitted or decoded

    # -- slot save/restore (llama-server --slot-save-path) --------------------
    def slot_op(self, op: str, b: int, path: str = "") -> dict:
        """Save, restore or erase slot b's kept prompt (llama-server ``POST
        /slots/{id}?action=...``). Thread-safe: with the scheduler running
        the operation runs on its thread between dispatches. ValueError on
        a refused operation."""
        if not 0 <= b < self.ecfg.max_slots:
            raise ValueError(f"no such slot {b}")
        if op != "erase" and self.alloc is not None:
            raise ValueError("slot save/restore requires the contiguous KV layout "
                             "(paged slots have no private region)")
        if self._thread is None or not self._thread.is_alive():
            return self._exec_slot_op(op, b, path)
        reply: "queue.Queue" = queue.Queue()
        self._slot_ops.put((op, b, path, reply))
        self._wake.set()
        try:
            status, payload = reply.get(timeout=600)
        except queue.Empty:
            raise ValueError("engine stopped before the slot operation ran") from None
        if status == "error":
            raise ValueError(payload)
        return payload

    def _run_slot_ops(self) -> bool:
        ran = False
        while True:
            try:
                op, b, path, reply = self._slot_ops.get_nowait()
            except queue.Empty:
                return ran
            ran = True
            try:
                reply.put(("ok", self._exec_slot_op(op, b, path)))
            except FileNotFoundError:
                reply.put(("error", "no such slot file"))
            except Exception as e:  # noqa: BLE001 — the caller's 400
                reply.put(("error", str(e)))

    def _cache_fields(self) -> list[str]:
        return [f.name for f in dataclasses.fields(self.cache)]

    @torch.inference_mode()
    def _exec_slot_op(self, op: str, b: int, path: str) -> dict:
        """One slot operation, in the JAX engine's file format: an ``.npz``
        of ``ids`` (int32), ``kind`` (the cache class), ``model`` and one
        stacked (L, KVH, n, ...) array per cache field, bf16 stored as its
        uint16 bit pattern. A dispatch in flight is drained first, so no
        free row's parked write lands in the rows read or written."""
        if self._pending is not None:
            pend, self._pending = self._pending, None
            self._drain(pend)
        slot = self.slots[b]
        if slot.state != "free":
            raise ValueError(f"slot {b} is busy")
        if op == "erase":
            n = len(slot.cached_ids)
            slot.cached_ids = []
            return {"id_slot": b, "n_erased": n}
        if op == "save":
            return self._save_slot(b, path)
        if op == "restore":
            return self._restore_slot(b, path)
        raise ValueError(f"unknown slot action {op!r}")

    def _save_slot(self, b: int, path: str) -> dict:
        slot = self.slots[b]
        n = len(slot.cached_ids)
        if n == 0:
            raise ValueError(f"slot {b} has no cached prompt to save")
        t0 = time.monotonic()
        payload = {"ids": np.asarray(slot.cached_ids, np.int32),
                   "kind": type(self.cache).__name__, "model": self.model_name}
        for f in self._cache_fields():
            arr = torch.stack([t[b, :, :n] for t in getattr(self.cache, f)]).cpu()
            # numpy has no bf16: the raw bit pattern, as the JAX engine stores it
            payload[f] = (arr.view(torch.int16).numpy().view(np.uint16)
                          if arr.dtype == torch.bfloat16 else arr.numpy())
        # a file object keeps the exact name (np.savez on a str appends .npz)
        with open(path, "wb") as fh:
            np.savez(fh, **payload)
        return {"id_slot": b, "filename": os.path.basename(path), "n_saved": n,
                "t_save_ms": round((time.monotonic() - t0) * 1e3, 1)}

    def _restore_slot(self, b: int, path: str) -> dict:
        """Write a saved prompt's rows into slot b (in place: the cache
        tensors carry sink rows) and make it the slot's claim, capped as
        ``_release`` caps one, so the free row parked at the claim's end
        stays inside the slot."""
        t0 = time.monotonic()
        kind = type(self.cache).__name__
        with np.load(path) as data:
            if str(data["kind"]) != kind:
                raise ValueError(f"cache kind mismatch: file has {data['kind']}, "
                                 f"engine runs {kind}")
            if str(data["model"]) != self.model_name:
                raise ValueError(f"slot file was saved from a different model "
                                 f"({data['model']})")
            ids = [int(t) for t in data["ids"]]
            n = len(ids)
            if n > self._slot_cap(b):
                raise ValueError(f"saved prompt ({n} tokens) exceeds the slot "
                                 f"capacity {self._slot_cap(b)}")
            rows = {}
            for f in self._cache_fields():
                layers = getattr(self.cache, f)
                arr = data[f]
                if layers[0].dtype == torch.bfloat16 and arr.dtype == np.uint16:
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                want = (len(layers), *layers[0][b, :, :n].shape)
                if t.dtype != layers[0].dtype or tuple(t.shape) != want:
                    raise ValueError(f"slot file field {f}: {tuple(t.shape)} "
                                     f"{t.dtype}, expected {want} {layers[0].dtype}")
                rows[f] = t
        for f, t in rows.items():
            for layer, new in zip(getattr(self.cache, f), t):
                layer[b, :, :n].copy_(new)
        self.slots[b].cached_ids = ids[:self._claim_cap()]
        return {"id_slot": b, "filename": os.path.basename(path),
                "n_restored": len(self.slots[b].cached_ids),
                "t_restore_ms": round((time.monotonic() - t0) * 1e3, 1)}

    def _reap_cancelled(self) -> None:
        if not self._cancelled:
            return
        cancelled, self._cancelled = self._cancelled, set()
        for b, slot in enumerate(self.slots):
            if slot.state != "free" and slot.request_id in cancelled:
                slot.out.put(GenEvent(finished=True, finish_reason="stop",
                                      n_prompt=len(slot.prompt_ids),
                                      n_generated=len(slot.generated)))
                self._release(b)
        keep = []
        for item in self._waiting:
            if item[0] in cancelled:
                item[3].put(GenEvent(finished=True, finish_reason="stop"))
            else:
                keep.append(item)
        self._waiting = keep
        pending = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item[0] in cancelled:
                item[3].put(GenEvent(finished=True, finish_reason="stop"))
            else:
                pending.append(item)
        for item in pending:
            self._queue.put(item)

    # -- admission + prefill -------------------------------------------------
    def _slot_cap(self, b: int) -> int:
        """Tokens slot b may hold: its page reservation (paged) or the
        static per-slot region (contig)."""
        if self.alloc is not None:
            return len(self.alloc.owned[b]) * self.ecfg.kv_page_size
        return self.ecfg.ctx

    def _push_table(self) -> None:
        """Mirror the host allocator's page table to the device cache (in
        stream order: a dispatch in flight keeps the table it was issued
        with)."""
        self.cache.page_table.copy_(to_device(self.alloc.table, self.device))

    def _claim_cap(self) -> int:
        """The longest claim a free slot may keep: its parked decode row, at
        the claim's end, stays inside the slot."""
        return max(0, self.ecfg.ctx - self._max_advance() - 1)

    def _max_advance(self) -> int:
        """Worst-case per-dispatch offset advance: a slot's reservation keeps
        this much room past its last token, so multi-step dispatches stay
        viable up to ``max_tokens`` (1, the single-step margin, by default)."""
        return self.ecfg.multi_step

    def _next_request(self):
        if self._waiting:
            return self._waiting.pop(0)
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _reusable_prefix(self, b: int, ids: list[int]) -> int:
        """Prompt tokens already sitting in slot b's KV (llama-server slot
        prompt caching). Capped at len(ids) - 1: the last prompt position
        always runs, so its logits exist for the first token's draw."""
        if not self.ecfg.prefix_cache or self.alloc is not None:
            return 0
        cached = self.slots[b].cached_ids
        n = 0
        limit = min(len(cached), len(ids) - 1)
        while n < limit and cached[n] == ids[n]:
            n += 1
        return n

    def _pick_slot(self, free: list[int], ids: list[int]) -> int:
        """The free slot with the longest reusable prompt prefix; among equal
        matches the one whose kept claim is least worth keeping (the
        shortest), then the lowest index."""
        return max(free, key=lambda b: (self._reusable_prefix(b, ids),
                                        -len(self.slots[b].cached_ids), -b))

    @torch.inference_mode()
    def _admit(self) -> bool:
        """Two phases, as the JAX engine's admission: every request that
        finds a slot gets its sampling state written and its prefill (with
        the first token's draw) queued on the card; only then does the host
        wait for the first tokens."""
        pending_adm = []
        while True:
            free = [b for b, s in enumerate(self.slots) if s.state == "free"]
            if not free:
                break
            item = self._next_request()
            if item is None:
                break
            rid, ids, params, out = item
            # a grammar is parsed before any slot is touched, so a bad one
            # fails this request alone (the server refuses it earlier, with
            # a 400)
            matcher = None
            if params.grammar:
                try:
                    matcher = self._make_matcher(params.grammar)
                except Exception as e:  # noqa: BLE001 — bad grammar or schema
                    out.put(GenEvent(finished=True, finish_reason="error",
                                     text=f"invalid grammar: {e}"))
                    continue
            b = self._pick_slot(free, ids)
            slot = self.slots[b]
            if self.alloc is not None:
                # reserve the whole lifetime up front (prompt + max_tokens and
                # a dispatch's advance), so decode never allocates mid-flight
                need = -(-(len(ids) + params.max_tokens + self._max_advance())
                         // self.ecfg.kv_page_size)
                if not self.alloc.reserve(b, min(need, self.alloc.table.shape[1])):
                    # pool short: hold at the head of the line until a
                    # running request frees its pages
                    self._waiting.insert(0, item)
                    break
                self._push_table()
            slot.state = "active"
            self.total_prompt_tokens += len(ids)
            slot.request_id = rid
            slot.prompt_ids = ids
            slot.generated = []
            slot.params = params
            slot.out = out
            slot.pending_text = ""
            slot.utf8_buf = b""
            slot.matcher = matcher
            slot.static_bias = None
            slot.mask_dirty = False
            slot.shift_keep = None
            # the counts start from the prompt, so the repeat, frequency and
            # presence penalties see every token of the sequence so far; a
            # grammar's mask is in the bias row already, so the first token,
            # drawn at the end of the prefill, is constrained too
            brow = bias_row(params, self.cfg.vocab_size)
            if matcher is not None:
                if params.logit_bias:
                    slot.static_bias = brow.copy()
                brow = self._grammar_bias(slot, brow)
            self.sample_state.write_slot(b, params, ids, bias=brow)
            pending_adm.append((b, *self._prefill(b, ids)))
            slot.offset = len(ids)
            slot.cached_ids = list(ids)
        for b, tok, row in pending_adm:
            tok = int(tok)
            slot = self.slots[b]
            lp, top = self._host_token_stats(slot, row, tok) \
                if slot.params.n_probs > 0 else (None, None)
            self._emit_token(b, tok, lp, top)
        return bool(pending_adm)

    def _bucket(self, n: int) -> int:
        for t in PREFILL_BUCKETS:
            if n <= t:
                return t
        return PREFILL_BUCKETS[-1]

    def _prefill(self, b: int, ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill slot b in bucketed chunks from the first position its kept
        claim does not already hold; returns the first token (1,) sampled
        on the card from the last prompt position's logits, and those (V,)
        logits, neither read back."""
        view = self.cache.slot(b)
        pos = self._reusable_prefix(b, ids)
        self.total_prefix_reused += pos
        while True:
            chunk = min(len(ids) - pos, PREFILL_BUCKETS[-1])
            T = self._bucket(chunk)
            tok = np.zeros((1, T), np.int32)
            tok[0, :chunk] = ids[pos:pos + chunk]
            # the chunk's start and the row whose logits the head computes
            meta = to_device(np.array([pos, max(chunk - 1, 0)], np.int32), self.device)
            logits = forward(self.params, self.cfg, to_device(tok, self.device), meta[:1],
                             view, logits_at=meta[1:])
            pos += chunk
            if pos >= len(ids):
                break
        row = logits[:, 0]
        tok = sample(row, self.sample_state.row(b), Gates.of([self.slots[b].params]))
        return tok, row[0]

    def _host_token_stats(self, slot: _Slot, logits_row: torch.Tensor, tok: int):
        """The first token's logprob and top list, on the host (once per
        request that asked for logprobs), as the JAX engine computes them."""
        row = logits_row.float().cpu().numpy()
        m = float(row.max())
        lse = m + float(np.log(np.exp(row - m).sum()))
        k = min(slot.params.n_probs, self.TOP_LOGPROBS_K)
        idx = np.argpartition(-row, k)[:k]
        idx = idx[np.argsort(-row[idx])]
        return float(row[tok]) - lse, [(int(i), float(row[i]) - lse) for i in idx]

    @staticmethod
    def _top_list(slot: _Slot, idx_row, val_row):
        if slot.params.n_probs <= 0:
            return None
        n = min(slot.params.n_probs, len(idx_row))
        return [(int(idx_row[j]), float(val_row[j])) for j in range(n)]

    # -- grammar-constrained decoding -----------------------------------------
    def _make_matcher(self, gbnf: str):
        """A GrammarMatcher over this engine's tokenizer. The vocab trie is
        built on the first constrained request and parsed grammars are
        cached, so requests with one schema share a parse and its per-state
        masks."""
        from ..grammar import GrammarMatcher, TokenTrie, parse_gbnf
        if self._token_trie is None:
            self._token_trie = TokenTrie(self.tokenizer)
        g = self._grammar_cache.get(gbnf)
        if g is None:
            g = self._grammar_cache[gbnf] = parse_gbnf(gbnf)
        return GrammarMatcher(g, self._token_trie)

    def _grammar_bias(self, slot: _Slot, base: np.ndarray | None = None) -> np.ndarray:
        """(V,) f32 bias row: -inf on the tokens the slot's grammar forbids,
        ``base`` (the request's static logit_bias) elsewhere."""
        if base is None:
            base = slot.static_bias if slot.static_bias is not None \
                else np.zeros(self.cfg.vocab_size, np.float32)
        return np.where(slot.matcher.valid_mask(), base, -np.inf).astype(np.float32)

    def _flush_grammar_masks(self, active: list[int]) -> None:
        """Write the stale grammar masks to the card's bias rows before a
        decode dispatch: one pinned copy per slot whose matcher advanced,
        in stream order, with no wait for the card."""
        for b in active:
            slot = self.slots[b]
            if slot.matcher is not None and slot.mask_dirty:
                self.sample_state.set_bias_row(b, self._grammar_bias(slot))
                slot.mask_dirty = False

    # -- batched decode ------------------------------------------------------
    def _multi_steps_viable(self, active: list[int]) -> int:
        """How many decode steps can be fused into one dispatch right now."""
        n = self.ecfg.multi_step
        if n <= 1:
            return 1
        if any(self.slots[b].matcher is not None for b in active):
            return 1   # the mask must refresh between steps (host automaton)
        if not self._queue.empty() and self.n_active() < self.ecfg.max_slots:
            return 1   # stay responsive: admit waiting requests first
        # all-or-nothing: a slot finishing mid-batch just ignores the tail
        # (bounded waste, < n steps)
        for b in active:
            if self._slot_cap(b) - self.slots[b].offset - 1 < n:
                return 1
        return n

    def _decode_inputs(self, active: list[int]):
        """(B, 1) tokens, (B,) offsets and (B,) per-step advance (1 for an
        active slot, 0 for a free one), on the host. A free row still writes
        a KV row at its offset every step: it parks just past its slot's
        kept claim (which ``_release`` caps so that this row lies inside the
        slot), so it never overwrites a prefix kept for reuse, and with
        advance 0 a pipelined continuation never moves it."""
        B = self.ecfg.max_slots
        tokens = np.zeros((B, 1), np.int32)
        offsets = np.zeros(B, np.int32)
        advance = np.zeros(B, np.int32)
        for b, slot in enumerate(self.slots):
            if slot.state == "free":
                offsets[b] = len(slot.cached_ids)
        for b in active:
            tokens[b, 0] = self.slots[b].generated[-1]
            offsets[b] = self.slots[b].offset
            advance[b] = 1
        return tokens, offsets, advance

    # -- pipelined dispatch: keep one multi-step decode in flight, so the
    # host's wait for a dispatch's tokens and its emission of them overlap
    # the NEXT dispatch's device time. The continuation's inputs are the
    # in-flight dispatch's own on-card outputs, so issuing it needs no host
    # data. Slots that turn out to have finished inside the fetched batch
    # simply waste their speculative tail (bounded, as mid-batch EOG).
    def _pipeline_ok(self, pend) -> bool:
        active, n_steps = pend["active"], pend["n_steps"]
        if n_steps <= 1:
            return False
        if not self._queue.empty() and self.n_active() < self.ecfg.max_slots:
            return False   # stay responsive: drain + admit first
        now_active = [b for b, s in enumerate(self.slots) if s.state == "active"]
        if now_active != active:
            return False   # a newly admitted slot must join the batch
        for b in active:
            slot = self.slots[b]
            if slot.state != "active" or slot.request_id != pend["gen"][b]:
                return False
            # room for the in-flight steps AND the continuation
            if slot.offset + 2 * n_steps + 1 >= self._slot_cap(b):
                return False
            if len(slot.generated) + 2 * n_steps > slot.params.max_tokens:
                return False   # would overshoot max_tokens: don't speculate
        return True

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` that is complete once the dispatch's event
        has passed: pinned and not waited for on a card."""
        if t.device.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    @torch.inference_mode()
    def _issue(self, tokens: torch.Tensor, offsets: torch.Tensor, advance: torch.Tensor,
               n_steps: int, want_lp: bool, active: list[int],
               offsets_np: np.ndarray) -> dict:
        """Queue a decode dispatch on the card without waiting for it:
        ``n_steps`` forward+sample steps over the full slot batch from the
        on-card (B, 1) ``tokens`` and (B,) ``offsets``, each step's tokens fed
        to the next and its offsets advanced by ``advance``; then the copy of
        the (N, B) tokens (and with ``want_lp`` their logprobs and top-k) to
        pinned host memory and an event after it. Nothing here reads the
        card. ``offsets_np`` is the host's bookkeeping copy of ``offsets``."""
        gates = Gates.of(self.slots[b].params for b in active)
        tok, off, outs = tokens, offsets, []
        for _ in range(n_steps):
            logits = forward(self.params, self.cfg, tok, off, self.cache)[:, 0]
            nxt = sample(logits, self.sample_state, gates)
            # logprobs only where asked: the default path pays no (B, V)
            # log-softmax
            outs.append((nxt, *token_logprobs(logits, nxt, self.TOP_LOGPROBS_K))
                        if want_lp else (nxt,))
            tok, off = nxt.to(torch.int32)[:, None], off + advance
        host = [self._to_host(torch.stack(x)) for x in zip(*outs)]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self.dispatches += 1
        return {"host": host, "event": event, "next_tok": tok, "next_off": off,
                "advance": advance, "offsets": offsets_np, "n_steps": n_steps,
                "want_lp": want_lp, "active": active,
                "gen": {b: self.slots[b].request_id for b in active},
                "t0": time.monotonic()}

    def _drain(self, pend: dict) -> None:
        """Wait for a dispatch's tokens (its event: the one point where the
        host waits for the card) and emit them."""
        if pend["event"] is not None:
            pend["event"].synchronize()
        dt = (time.monotonic() - pend["t0"]) / pend["n_steps"]
        self._last_decode_s = 0.9 * self._last_decode_s + 0.1 * dt \
            if self._last_decode_s else dt
        host = [h.numpy() for h in pend["host"]]
        toks = host[0]
        lps, tv, ti = host[1:] if pend["want_lp"] else (None, None, None)
        for step in range(pend["n_steps"]):
            for b in pend["active"]:
                slot = self.slots[b]
                # the slot may have finished (EOG/stop) mid-batch: drop the rest
                if slot.state != "active" or slot.request_id != pend["gen"][b]:
                    continue
                slot.offset += 1
                top = None if ti is None else self._top_list(slot, ti[step, b], tv[step, b])
                lp = None if lps is None else float(lps[step, b])
                self._emit_token(b, int(toks[step, b]), lp, top)

    def _decode(self) -> bool:
        pend, self._pending = self._pending, None
        if pend is not None:
            nxt = None
            if self._pipeline_ok(pend):
                # both continuation inputs are the in-flight dispatch's own
                # on-card outputs: no host data, no wait
                nxt = self._issue(pend["next_tok"], pend["next_off"], pend["advance"],
                                  pend["n_steps"], pend["want_lp"], list(pend["active"]),
                                  offsets_np=pend["offsets"] + pend["n_steps"])
                self.continuations += 1
            self._drain(pend)           # the wait overlaps nxt's device time
            if nxt is not None:
                # continuation slots that finished during the drain waste
                # their speculative tail; _drain's request check drops it
                self._pending = nxt
            return True

        active = [b for b, s in enumerate(self.slots) if s.state == "active"]
        if not active:
            return False
        self._maybe_shift(active)
        n_steps = self._multi_steps_viable(active)
        want_lp = any(self.slots[b].params.n_probs > 0 for b in active)
        self._flush_grammar_masks(active)
        tokens, offsets, advance = self._decode_inputs(active)
        pend = self._issue(to_device(tokens, self.device), to_device(offsets, self.device),
                           to_device(advance, self.device), n_steps, want_lp, active,
                           offsets_np=offsets)
        if n_steps > 1:
            self._pending = pend        # drain on the next scheduler tick
        else:
            self._drain(pend)
        return True

    # -- context shift ---------------------------------------------------------
    @torch.inference_mode()
    def _maybe_shift(self, active: list[int]) -> None:
        """llama-server --ctx-shift: a slot whose region cannot hold the next
        dispatch keeps its first ``keep`` positions (the prompt, at most half
        the region), discards half the rest, and goes on. Runs only with no
        dispatch in flight: ``_pipeline_ok`` refuses a continuation that
        would pass a slot's capacity, so a shift never waits behind one (a
        row past the region would land in the sink rows, and its KV would be
        lost without an error)."""
        if not self.ecfg.ctx_shift or self._pending is not None:
            return
        margin = self.ecfg.multi_step + 1
        for b in active:
            slot = self.slots[b]
            cap = self._slot_cap(b)
            if slot.offset + margin < cap:
                continue
            keep = min(len(slot.prompt_ids), cap // 2)
            discard = max(margin, (slot.offset - keep) // 2)
            shift_cache_slot(self.cache, self.cfg, b, keep, discard)
            slot.offset -= discard
            slot.cached_ids = []   # positions no longer match the prompt
            slot.shift_keep = keep if slot.shift_keep is None else min(slot.shift_keep, keep)
            self.total_ctx_shifts += 1

    # -- emission / termination ---------------------------------------------
    def _emit_token(self, b: int, token_id: int, logprob: float | None = None,
                    top: list[tuple[int, float]] | None = None) -> None:
        slot = self.slots[b]
        slot.generated.append(token_id)
        self.total_generated += 1
        n_gen = len(slot.generated)

        finish: str | None = None
        if self.tokenizer.is_eog(token_id):
            finish = "stop"
        elif n_gen >= slot.params.max_tokens:
            finish = "length"
        elif slot.offset + 1 >= self._slot_cap(b) and not self.ecfg.ctx_shift:
            # under ctx_shift the scheduler shifts the slot's window before
            # the next dispatch instead
            finish = "length"

        if slot.matcher is not None and finish is None:
            if slot.matcher.accept_token(token_id):
                slot.mask_dirty = True
            else:
                # the mask makes this unreachable; a rejected token ends the
                # request rather than decoding on unconstrained
                finish = "stop"

        # UTF-8 boundary holdback: byte-fallback tokens can carry partial
        # multi-byte sequences; emit only complete sequences
        if finish == "stop" and self.tokenizer.is_eog(token_id):
            raw = b""
        elif hasattr(self.tokenizer, "piece_bytes"):
            raw = self.tokenizer.piece_bytes(token_id)
        else:
            raw = self.tokenizer.piece(token_id).encode("utf-8")
        slot.utf8_buf += raw
        text, slot.utf8_buf = _utf8_split(slot.utf8_buf, flush=finish is not None)
        if n_gen == 1 and getattr(self.tokenizer, "add_space_prefix", False):
            text = text.lstrip(" ")

        # stop-string scanning with holdback of possible prefixes
        if finish is not None:
            emit_text = slot.pending_text + text
            slot.pending_text = ""
        elif slot.params.stop:
            slot.pending_text += text
            hit = None
            for s_str in slot.params.stop:
                idx = slot.pending_text.find(s_str)
                if idx >= 0:
                    hit = idx
                    break
            if hit is not None:
                emit_text = slot.pending_text[:hit]
                slot.pending_text = ""
                finish = "stop"
            else:
                # hold back the longest suffix that could start a stop string
                keep = 0
                for s_str in slot.params.stop:
                    for plen in range(min(len(s_str) - 1, len(slot.pending_text)), 0, -1):
                        if slot.pending_text.endswith(s_str[:plen]):
                            keep = max(keep, plen)
                            break
                if keep:
                    emit_text = slot.pending_text[:-keep]
                    slot.pending_text = slot.pending_text[-keep:]
                else:
                    emit_text = slot.pending_text
                    slot.pending_text = ""
        else:
            emit_text = text

        slot.out.put(GenEvent(
            token_id=token_id, text=emit_text,
            finished=finish is not None, finish_reason=finish,
            n_prompt=len(slot.prompt_ids), n_generated=n_gen,
            logprob=logprob, top_logprobs=top))
        if finish is not None:
            self._release(b)

    def _release(self, b: int) -> None:
        slot = self.slots[b]
        slot.state = "free"
        slot.request_id = ""
        slot.offset = 0
        slot.matcher = None
        slot.static_bias = None
        slot.mask_dirty = False
        # keep the slot's KV claim for prompt-prefix reuse: the prompt and
        # every generated token that was fed back (the last one's KV is
        # never written; a dispatch's tail past a finish lies beyond the
        # claim). Capped so the free row's parked writes (_decode_inputs)
        # stay inside the slot; after a context shift only the positions
        # every shift kept still hold those tokens (the JAX engine keeps the
        # whole sequence as the claim there)
        claim = (slot.prompt_ids + slot.generated[:-1])[:self._claim_cap()]
        if slot.shift_keep is not None:
            claim = claim[:slot.shift_keep]
        slot.cached_ids = claim if self.ecfg.prefix_cache and self.alloc is None else []
        slot.shift_keep = None
        if self.alloc is not None:
            self.alloc.release(b)
            self._push_table()
