"""Engine-less mock backend: ``MOCK_BACKEND=true``, or no ``MODEL_PATH``.

The JAX package's mock, copied: it implements the engine's submit/stream
surface and emits deterministic ``mock-token-N`` text, so the OpenAI API
surface runs with no weights and no card (the server boots on it without
``MODEL_PATH``). ``embed`` returns a fixed vector, ``stats`` the engine's
keys and ``"mock": True``.
"""

from __future__ import annotations

import queue
import threading
import time

from .engine import GenEvent
from .sampler import SamplingParams


class MockTokenizer:
    """Whitespace 'tokenizer' over a fake vocabulary."""

    vocab_size = 32

    def __init__(self):
        self.special = type("S", (), {"bos_id": 1, "eos_id": 2})()
        self.add_space_prefix = False

    def encode(self, text: str, add_bos=None, add_eos=None) -> list[int]:
        n = max(1, len(text.split()))
        return [1] + list(range(3, 3 + min(n, 29)))

    def decode(self, ids) -> str:
        return " ".join(f"tok{i}" for i in ids if i > 2)

    def piece(self, i: int) -> str:
        return f" tok{i}" if i > 2 else ""

    def is_eog(self, i: int) -> bool:
        return i == 2


class MockEngine:
    """Same submit/stream surface as InferenceEngine; emits `mock-token-N`."""

    def __init__(self, model_name: str = "mock-model", delay_s: float = 0.0,
                 embedding_dim: int = 8, fail_after: int = -1):
        self.model_name = model_name
        self.tokenizer = MockTokenizer()
        self.delay_s = delay_s
        # fail_after >= 0: emit that many tokens then a terminal
        # finish_reason="error" event (simulates InferenceEngine._fail_all)
        self.fail_after = fail_after
        self.embedding_dim = embedding_dim
        self.total_generated = 0
        self.total_prompt_tokens = 0
        self._active = 0
        self.cfg = type("C", (), {"dim": embedding_dim})()
        self.ecfg = type("E", (), {"max_slots": 4, "ctx": 4096})()

    def start(self) -> None:  # interface parity
        pass

    def stop(self) -> None:
        pass

    def n_active(self) -> int:
        return self._active

    def queue_depth(self) -> int:
        return 0

    def submit(self, prompt, params: SamplingParams, request_id=None):
        rid = request_id or "mockreq"
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        out: "queue.Queue[GenEvent]" = queue.Queue()
        t = threading.Thread(target=self._run, args=(ids, params, out), daemon=True)
        t.start()
        return rid, out

    def _run(self, ids, params: SamplingParams, out: "queue.Queue[GenEvent]"):
        self._active += 1
        self.total_prompt_tokens += len(ids)
        n = min(params.max_tokens, 16)
        try:
            if self.fail_after >= 0:
                for i in range(self.fail_after):
                    out.put(GenEvent(token_id=100 + i,
                                     text=("" if i == 0 else " ") + f"mock-token-{i}",
                                     n_prompt=len(ids), n_generated=i + 1))
                out.put(GenEvent(finished=True, finish_reason="error",
                                 n_prompt=len(ids),
                                 n_generated=self.fail_after))
                return
            for i in range(n):
                if self.delay_s:
                    time.sleep(self.delay_s)
                last = i == n - 1
                self.total_generated += 1
                out.put(GenEvent(
                    token_id=100 + i,
                    text=("" if i == 0 else " ") + f"mock-token-{i}",
                    finished=last,
                    finish_reason=("length" if n == params.max_tokens else "stop")
                    if last else None,
                    n_prompt=len(ids), n_generated=i + 1,
                ))
        finally:
            self._active -= 1

    def generate(self, prompt, params: SamplingParams | None = None):
        _, out = self.submit(prompt, params or SamplingParams())
        while True:
            ev = out.get(timeout=60)
            yield ev
            if ev.finished:
                return

    def generate_text(self, prompt, params=None) -> str:
        return "".join(ev.text for ev in self.generate(prompt, params))

    def embed(self, prompt) -> tuple[list[float], int]:
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        vec = [(i % 7 - 3) / 10.0 for i in range(self.embedding_dim)]
        return vec, len(ids)

    def stats(self) -> dict:
        return {
            "model": self.model_name,
            "slots_total": 4, "slots_active": self._active,
            "queue_depth": 0, "ctx": 4096,
            "total_generated": self.total_generated,
            "total_prompt_tokens": self.total_prompt_tokens,
            "decode_step_ewma_ms": 0.0,
            "mock": True,
        }
