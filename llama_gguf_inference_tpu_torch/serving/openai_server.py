"""The backend server: OpenAI-compatible HTTP API over the engine.

Endpoints:

- ``POST /v1/chat/completions`` — chat templating + generation, JSON or SSE
- ``POST /v1/completions``       — legacy completions, JSON or SSE
- ``GET  /v1/models``            — the single loaded model
- ``GET  /health``               — public liveness

``/v1/*`` requires the bearer key when one is configured. Request fields
the engine cannot honour yet (logprobs, penalties, typical-p, mirostat,
logit bias, grammars, tools, ``n > 1``) get a 400 naming the field; none is
ignored silently.

Run: ``MODEL_PATH=model.gguf python -m
llama_gguf_inference_tpu_torch.serving.openai_server`` (on the card).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import os
import time
import uuid
from typing import Any

from ..runtime.sampler import SamplingParams, unsupported
from .chat_template import normalize_messages, render_chat
from .http import HttpLimitError, read_request, send_error, send_response, sse_event


@dataclasses.dataclass
class BackendConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    api_key: str = ""               # empty = no backend auth

    @staticmethod
    def from_env() -> "BackendConfig":
        key = os.environ.get("BACKEND_API_KEY", "")
        key_file = os.environ.get("BACKEND_API_KEY_FILE", "")
        if not key and key_file and os.path.exists(key_file):
            with open(key_file) as f:
                key = f.read().strip()
        return BackendConfig(
            host=os.environ.get("BACKEND_HOST", "127.0.0.1"),
            port=int(os.environ.get("PORT_BACKEND") or
                     os.environ.get("BACKEND_PORT") or 8080),
            api_key=key,
        )


def ctx_per_slot(ctx_total: int, max_slots: int, override: int = 0) -> int:
    """Per-slot KV capacity from the TOTAL context budget (llama.cpp
    semantics: ``-c N --parallel P`` gives each slot N / P), with a
    256-token floor; ``override`` > 0 wins."""
    if override > 0:
        return override
    return max(256, ctx_total // max(1, max_slots))


def _now() -> int:
    return int(time.time())


# request fields with no engine support yet: key -> value that means "off"
_OFF_FIELDS = {"tools": None, "grammar": None, "json_schema": None}


def _params_from_request(body: dict, default_max: int = 256) -> SamplingParams:
    """SamplingParams from an OpenAI request body; ValueError (-> 400)
    names any field set that the engine cannot honour."""
    for key, off in _OFF_FIELDS.items():
        if body.get(key) not in (off, [], ""):
            raise ValueError(f"{key} is not supported yet")
    rf = body.get("response_format")
    if rf and not (isinstance(rf, dict) and rf.get("type", "text") == "text"):
        raise ValueError("response_format is not supported yet")
    n = body.get("n", 1)
    if n not in (None, 1):
        raise ValueError("n > 1 is not supported yet")
    stop = body.get("stop") or ()
    stop = (stop,) if isinstance(stop, str) else tuple(str(s) for s in stop)
    seed = body.get("seed")
    max_tokens = body.get("max_tokens") or body.get("max_completion_tokens") \
        or body.get("n_predict") or default_max
    p = SamplingParams(
        n_probs=1 if body.get("logprobs") else 0,
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        min_p=float(body.get("min_p", 0.0)),
        typical_p=float(body.get("typical_p", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        repeat_penalty=float(body.get("repeat_penalty", 1.0)),
        mirostat=int(body.get("mirostat", 0)),
        seed=int(seed) if seed is not None else int.from_bytes(os.urandom(4), "little"),
        max_tokens=int(max_tokens),
        stop=stop,
        logit_bias=body.get("logit_bias") or None,
    )
    bad = unsupported(p)
    if bad:
        names = {"n_probs": "logprobs"}
        raise ValueError(", ".join(names.get(f, f) for f in bad)
                         + " is not supported yet")
    return p


class OpenAIServer:
    def __init__(self, engine, config: BackendConfig | None = None):
        self.engine = engine
        self.cfg = config or BackendConfig.from_env()
        self._server: asyncio.AbstractServer | None = None

    def _authorized(self, headers: dict[str, str]) -> bool:
        if not self.cfg.api_key:
            return True
        auth = headers.get("authorization", "")
        if auth.lower().startswith("bearer "):
            auth = auth[7:]
        return hmac.compare_digest(auth.strip().encode(), self.cfg.api_key.encode())

    async def handle_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        try:
            try:
                req = await read_request(reader)
            except HttpLimitError as e:
                await send_error(writer, e.status, e.message,
                                 "invalid_request_error", e.code)
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if req is None:
                return
            path = req.path.split("?", 1)[0]
            if path == "/health":
                await send_response(writer, 200, json.dumps({"status": "ok"}).encode())
                return
            if not self._authorized(req.headers):
                await send_error(writer, 401, "Invalid API key",
                                 "invalid_request_error", "invalid_api_key")
                return
            if path == "/v1/models" and req.method == "GET":
                await self.handle_models(writer)
            elif path == "/v1/chat/completions" and req.method == "POST":
                await self.handle_generate(req, writer, chat=True)
            elif path == "/v1/completions" and req.method == "POST":
                await self.handle_generate(req, writer, chat=False)
            else:
                await send_error(writer, 404, f"Unknown endpoint {path}",
                                 "invalid_request_error", "not_found")
        except (ConnectionError, BrokenPipeError):
            pass
        finally:
            writer.close()

    async def handle_models(self, writer) -> None:
        await send_response(writer, 200, json.dumps({
            "object": "list",
            "data": [{"id": self.engine.model_name, "object": "model",
                      "created": _now(), "owned_by": "local"}],
        }).encode())

    def _render_prompt(self, messages: list) -> str:
        """Chat-template rendering (GGUF jinja template, chatml fallback)."""
        tok = self.engine.tokenizer
        bos = tok.tokens[tok.special.bos_id] if tok.special.bos_id >= 0 else "<s>"
        eos = tok.tokens[tok.special.eos_id] if tok.special.eos_id >= 0 else "</s>"
        return render_chat(normalize_messages(messages),
                           self.engine.metadata.get("tokenizer.chat_template"),
                           bos, eos)

    async def handle_generate(self, req, writer, chat: bool) -> None:
        try:
            body = json.loads(req.body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            body = None
        field = "messages" if chat else "prompt"
        if not isinstance(body, dict) or field not in body \
                or (chat and not isinstance(body["messages"], list)):
            await send_error(writer, 400, f"{field} is required",
                             "invalid_request_error", "bad_request")
            return
        try:
            params = _params_from_request(body)
            if chat:
                prompt = self._render_prompt(body["messages"])
            else:
                prompt = body["prompt"]
                if isinstance(prompt, list):
                    prompt = "".join(str(p) for p in prompt)
            pre = self.engine.submit(prompt, params)
        except ValueError as e:
            await send_error(writer, 400, str(e), "invalid_request_error",
                             "bad_request")
            return
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        obj = "chat.completion" if chat else "text_completion"
        if body.get("stream"):
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            await self._stream(writer, rid, obj + (".chunk" if chat else ""),
                               pre, chat, include_usage)
        else:
            await self._complete(writer, rid, obj, pre, chat)

    async def _collect(self, pre):
        """Drain a submitted request's event queue without blocking the
        event loop; cancels the request if the consumer goes away."""
        loop = asyncio.get_running_loop()
        rid, out = pre
        finished = False
        try:
            while not finished:
                ev = await loop.run_in_executor(None, out.get)
                finished = ev.finished
                yield ev
        finally:
            if not finished:
                self.engine.cancel(rid)

    async def _complete(self, writer, rid: str, obj: str, pre, chat: bool) -> None:
        text: list[str] = []
        finish, n_prompt, n_gen = "stop", 0, 0
        async for ev in self._collect(pre):
            text.append(ev.text)
            n_prompt, n_gen = ev.n_prompt, ev.n_generated
            if ev.finished:
                finish = ev.finish_reason or "stop"
        if finish == "error":
            await send_error(writer, 500, "inference engine failure",
                             "server_error", "engine_error")
            return
        content = "".join(text)
        if chat:
            choice = {"index": 0, "finish_reason": finish,
                      "message": {"role": "assistant", "content": content}}
        else:
            choice = {"index": 0, "text": content, "finish_reason": finish,
                      "logprobs": None}
        await send_response(writer, 200, json.dumps({
            "id": rid, "object": obj, "created": _now(),
            "model": self.engine.model_name, "choices": [choice],
            "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_gen,
                      "total_tokens": n_prompt + n_gen},
        }).encode())

    async def _stream(self, writer, rid: str, obj: str, pre, chat: bool,
                      include_usage: bool) -> None:
        def chunk(delta: dict | None, finish: str | None) -> dict:
            c: dict[str, Any] = {"index": 0, "finish_reason": finish}
            if chat:
                c["delta"] = delta if delta is not None else {}
            else:
                c["text"] = (delta or {}).get("content", "")
            return {"id": rid, "object": obj, "created": _now(),
                    "model": self.engine.model_name, "choices": [c]}

        head_sent = False
        finish, n_prompt, n_gen = "stop", 0, 0
        async for ev in self._collect(pre):
            n_prompt, n_gen = ev.n_prompt, ev.n_generated
            if ev.finished:
                finish = ev.finish_reason or "stop"
            if finish == "error":
                if not head_sent:   # nothing streamed yet: a real 5xx
                    await send_error(writer, 500, "inference engine failure",
                                     "server_error", "engine_error")
                else:               # mid-stream: an SSE error event, no [DONE]
                    writer.write(sse_event({"error": {
                        "message": "inference engine failure",
                        "type": "server_error", "code": "engine_error"}}))
                    await writer.drain()
                return
            if not head_sent:
                head_sent = True
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream"
                             b"\r\nCache-Control: no-cache\r\nConnection: close\r\n\r\n")
                if chat:
                    writer.write(sse_event(chunk({"role": "assistant"}, None)))
            if ev.text:
                writer.write(sse_event(chunk({"content": ev.text}, None)))
            await writer.drain()
        writer.write(sse_event(chunk(None, finish)))
        if include_usage:
            writer.write(sse_event({
                "id": rid, "object": obj, "created": _now(),
                "model": self.engine.model_name, "choices": [],
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_gen,
                          "total_tokens": n_prompt + n_gen}}))
        writer.write(sse_event("[DONE]"))
        await writer.drain()

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self.handle_client, self.cfg.host, self.cfg.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.cfg.port


def build_engine_from_env(device: str = "cuda"):
    """The engine the environment names: ``MODEL_PATH``, ``MAX_SLOTS``,
    ``CTX`` (total, split over slots) or ``CTX_PER_SLOT``, and the KV cache:
    ``KV_CACHE_TYPE`` (bf16, q8_0, q4_0, q4_1; q5_0/q5_1 run as q8_0),
    ``KV_LAYOUT`` (contig or paged) and ``KV_PAGE_SIZE`` (tokens per page)."""
    from ..runtime.engine import EngineConfig, InferenceEngine

    model_path = os.environ.get("MODEL_PATH", "")
    if not model_path:
        raise ValueError("MODEL_PATH is required")
    kv = os.environ.get("KV_CACHE_TYPE", "bf16").lower()
    if kv in ("q5_0", "q5_1"):
        # llama-server accepts 5-bit cache types; honour them at the next
        # precision up rather than failing the boot
        print(f"[backend] KV_CACHE_TYPE={kv} has no 5-bit layout; "
              "using q8_0 (use q4_1 for a smaller cache)", flush=True)
        kv = "q8_0"
    max_slots = int(os.environ.get("MAX_SLOTS", 4))
    ctx = ctx_per_slot(int(os.environ.get("CTX", 16384)), max_slots,
                       int(os.environ.get("CTX_PER_SLOT", 0)))
    return InferenceEngine(model_path, EngineConfig(
        max_slots=max_slots, ctx=ctx,
        kv_dtype=kv if kv in ("q8_0", "q4_0", "q4_1") else "bf16",
        kv_layout=os.environ.get("KV_LAYOUT", "contig").lower(),
        kv_page_size=int(os.environ.get("KV_PAGE_SIZE", 1024))), device=device)


def main() -> None:
    engine = build_engine_from_env()
    engine.start()
    srv = OpenAIServer(engine)
    print(f"[backend] {engine.model_name} on {srv.cfg.host}:{srv.cfg.port} "
          f"(auth={'on' if srv.cfg.api_key else 'off'})", flush=True)
    try:
        asyncio.run(srv.serve_forever())
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
