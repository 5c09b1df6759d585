"""The inference engine: slots, continuous batching, streaming.

- ``max_slots`` sequences share one decode batch; one step per iteration
  advances every slot (free slots run on pad tokens at offset 0 and their
  outputs are dropped)
- prompt prefill runs per slot in bucketed chunks written straight into that
  slot's rows of the KV cache; the final chunk's last row is sampled for the
  first token
- stop handling (EOG, ``max_tokens``, slot capacity, stop strings) and
  detokenization run on the host
- the engine is transport-agnostic: the server talks to it through
  ``submit()`` and per-request thread-safe event queues
- the KV cache is bf16, q8_0, q4_0 or q4_1 (``kv_dtype``), contiguous
  (each slot owns ``ctx`` tokens) or paged (``kv_layout="paged"``: slots
  share a pool of ``max_slots * ctx`` tokens; a request reserves the pages
  for its prompt and ``max_tokens`` at admission and waits at the head of
  the line while the pool is short)

Not yet here (the JAX engine has them): multi-step decode, pipelined
dispatch, the slot prefix cache, speculation, slot save/restore, context
shift, logprobs and grammars.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import traceback
import uuid
from typing import Iterator

import torch

from ..device import resolve_device
from ..models.llama import KVCache, forward
from .kv_cache import QuantKV, QuantKV4, QuantKV41
from .loader import load_model
from .paged_kv import PageAllocator, PagedKV, PagedQuantKV
from .sampler import SamplingParams, sample, unsupported
from .tokenizer import Tokenizer, from_gguf_metadata


# prefill chunk lengths: a prompt runs in chunks of at most the largest,
# each padded to the smallest bucket that holds it
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)
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
    generator: torch.Generator | None = None


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
    """Owns model weights, the KV cache and the scheduler thread."""

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
        cfg, params, reader = load_model(model_path, self.device, fuse=True)
        self.cfg = cfg
        self.params = params
        self.metadata = dict(reader.metadata)
        self.tokenizer: Tokenizer = from_gguf_metadata(reader.metadata)
        self.model_name = str(self.metadata.get("general.name", "model"))
        reader.close()
        self.cache, self.alloc = make_kv_cache(cfg, ecfg, self.device)
        self.slots = [_Slot() for _ in range(ecfg.max_slots)]
        self._queue: "queue.Queue[tuple[str, list[int], SamplingParams, queue.Queue]]" = queue.Queue()
        self._waiting: list = []          # paged: the head of the line, short of pages
        self._cancelled: set[str] = set()
        self._stop_evt = threading.Event()
        self._wake = threading.Event()    # set by submit()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- requests
    def submit(self, prompt: str | list[int], params: SamplingParams,
               request_id: str | None = None) -> tuple[str, "queue.Queue[GenEvent]"]:
        """Enqueue a request; returns (request_id, event queue). Raises
        ValueError for sampling settings this engine cannot honour."""
        bad = unsupported(params)
        if bad:
            raise ValueError(f"not supported yet: {', '.join(bad)}")
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

    # ------------------------------------------------------------ scheduler
    def start(self) -> None:
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="engine-loop")
            self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

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

    def _fail_all(self) -> None:
        """Terminate every active and queued request with an error event."""
        for b, slot in enumerate(self.slots):
            if slot.state != "free":
                slot.out.put(GenEvent(finished=True, finish_reason="error",
                                      n_prompt=len(slot.prompt_ids),
                                      n_generated=len(slot.generated)))
                self._release(b)
        for item in self._waiting:
            item[3].put(GenEvent(finished=True, finish_reason="error"))
        self._waiting = []
        while True:
            try:
                _, _, _, out = self._queue.get_nowait()
            except queue.Empty:
                break
            out.put(GenEvent(finished=True, finish_reason="error"))

    def step(self) -> bool:
        """One scheduler iteration. Returns True if any work was done."""
        self._reap_cancelled()
        admitted = self._admit()
        decoded = self._decode()
        return admitted or decoded

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
        """Mirror the host allocator's page table to the device cache."""
        self.cache.page_table.copy_(torch.from_numpy(self.alloc.table))

    def _next_request(self):
        if self._waiting:
            return self._waiting.pop(0)
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _admit(self) -> bool:
        did = False
        for b, slot in enumerate(self.slots):
            if slot.state != "free":
                continue
            item = self._next_request()
            if item is None:
                break
            rid, ids, params, out = item
            if self.alloc is not None:
                # reserve the whole lifetime up front (prompt + max_tokens),
                # so decode never allocates mid-flight
                need = -(-(len(ids) + params.max_tokens + 1) // self.ecfg.kv_page_size)
                if not self.alloc.reserve(b, min(need, self.alloc.table.shape[1])):
                    # pool short: hold at the head of the line until a
                    # running request frees its pages
                    self._waiting.insert(0, item)
                    break
                self._push_table()
            slot.state = "active"
            slot.request_id = rid
            slot.prompt_ids = ids
            slot.generated = []
            slot.params = params
            slot.out = out
            slot.pending_text = ""
            slot.utf8_buf = b""
            slot.generator = torch.Generator(device=self.device)
            slot.generator.manual_seed(params.seed)
            logits = self._prefill(b, ids)
            slot.offset = len(ids)
            tok = sample(logits, [params], [slot.generator])
            self._emit_token(b, int(tok[0]))
            did = True
        return did

    def _bucket(self, n: int) -> int:
        for t in PREFILL_BUCKETS:
            if n <= t:
                return t
        return PREFILL_BUCKETS[-1]

    @torch.inference_mode()
    def _prefill(self, b: int, ids: list[int]) -> torch.Tensor:
        """Prefill slot b in bucketed chunks; returns the (1, V) logits of
        the last prompt position."""
        view = self.cache.slot(b)
        pos = 0
        while True:
            chunk = min(len(ids) - pos, PREFILL_BUCKETS[-1])
            T = self._bucket(chunk)
            tok = torch.zeros((1, T), dtype=torch.int32)
            tok[0, :chunk] = torch.tensor(ids[pos:pos + chunk], dtype=torch.int32)
            logits = forward(
                self.params, self.cfg, tok.to(self.device),
                torch.tensor([pos], dtype=torch.int32, device=self.device),
                view, logits_at=torch.tensor([max(chunk - 1, 0)], device=self.device))
            pos += chunk
            if pos >= len(ids):
                return logits[:, 0]

    # -- batched decode ------------------------------------------------------
    @torch.inference_mode()
    def _decode(self) -> bool:
        active = [b for b, s in enumerate(self.slots) if s.state == "active"]
        if not active:
            return False
        B = self.ecfg.max_slots
        tokens = torch.zeros((B, 1), dtype=torch.int32)
        offsets = torch.zeros(B, dtype=torch.int32)
        params: list[SamplingParams | None] = [None] * B
        gens: list[torch.Generator | None] = [None] * B
        for b in active:
            slot = self.slots[b]
            tokens[b, 0] = slot.generated[-1]
            offsets[b] = slot.offset
            params[b] = slot.params
            gens[b] = slot.generator
        logits = forward(self.params, self.cfg, tokens.to(self.device),
                         offsets.to(self.device), self.cache)
        toks = sample(logits[:, 0], params, gens).tolist()
        for b in active:
            self.slots[b].offset += 1
            self._emit_token(b, toks[b])
        return True

    # -- emission / termination ---------------------------------------------
    def _emit_token(self, b: int, token_id: int) -> None:
        slot = self.slots[b]
        slot.generated.append(token_id)
        n_gen = len(slot.generated)

        finish: str | None = None
        if self.tokenizer.is_eog(token_id):
            finish = "stop"
        elif n_gen >= slot.params.max_tokens:
            finish = "length"
        elif slot.offset + 1 >= self._slot_cap(b):
            finish = "length"

        # UTF-8 boundary holdback: byte-fallback tokens can carry partial
        # multi-byte sequences; emit only complete sequences
        if finish == "stop":
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
            n_prompt=len(slot.prompt_ids), n_generated=n_gen))
        if finish is not None:
            self._release(b)

    def _release(self, b: int) -> None:
        slot = self.slots[b]
        slot.state = "free"
        slot.request_id = ""
        slot.offset = 0
        slot.generator = None
        if self.alloc is not None:
            self.alloc.release(b)
            self._push_table()
