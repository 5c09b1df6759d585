"""The backend server: OpenAI-compatible HTTP API over the engine.

Endpoints:

- ``POST /v1/chat/completions`` — chat templating + generation, JSON or SSE
- ``POST /v1/completions``       — legacy completions, JSON or SSE (also
  ``POST /completion``)
- ``GET  /v1/models``            — the single loaded model
- ``POST /v1/embeddings``        — pooled embeddings (``engine.embed``: the
  decoder's mean pool, or a ``bert`` GGUF's encoder, whose engine answers
  text generation with an error, as llama-server ``--embedding`` does)
- ``POST /v1/rerank``            — documents ranked by the cosine of their
  embeddings with the query's (also ``/rerank`` and ``/v1/reranking``;
  ``top_n``; a 501 on an engine without ``embed``)
- ``GET  /health``               — public liveness
- llama-server's own paths, which the reference's clients reach through its
  passthrough: ``/props`` (the engine's stats), ``POST /tokenize``
  (``add_special``, ``with_pieces``), ``POST /detokenize``, ``POST
  /apply-template`` (the chat template, nothing generated), ``GET /slots``,
  ``POST /slots/{id}?action=save|restore|erase`` (files under
  ``SLOT_SAVE_PATH``, llama-server's ``--slot-save-path``; a 400 without
  it) and ``POST /infill`` (fill-in-the-middle in PSM order from the
  model's FIM tokens; a 501 without them)

Every path but ``/health`` requires the bearer key when one is configured.
Status codes, error codes and JSON keys are the JAX package's server's.
Request fields follow it too:

- sampling: temperature, top_p, top_k, min_p, typical_p, the
  presence/frequency/repeat penalties, mirostat with
  ``mirostat_tau``/``mirostat_eta``, seed, stop, ``logit_bias`` (an OpenAI
  object with string keys or llama.cpp ``[id, bias]`` pairs; ``false`` bans
  the token) and ``logprobs``/``top_logprobs`` (at most 8);
- constrained output: ``grammar`` (GBNF), ``json_schema`` and
  ``response_format`` (``json_object``, ``json_schema``), each turned into
  a GBNF grammar the engine's matcher enforces; a malformed one gets a 400
  before anything is submitted;
- ``tools`` and ``tool_choice`` on chat: the tool schemas go into the
  system message, a forced choice (``required`` or a named function)
  constrains the answer to a tool-call object, and an answer that parses
  as one comes back as ``tool_calls`` with ``finish_reason: "tool_calls"``;
- ``n`` in [1, 8]: every choice is submitted at once, so the choices decode
  together in the batch; choice i samples with seed + i.

Run: ``MODEL_PATH=model.gguf python -m
llama_gguf_inference_tpu_torch.serving.openai_server`` (on the card). It
warms the engine up in the background at start (``ENGINE_WARMUP=0`` skips
that). Without ``MODEL_PATH``, or with ``MOCK_BACKEND=true``, it serves the
mock engine (``runtime.mock``: no weights, no card; ``MODEL_NAME``,
``MOCK_DELAY_S``); handlers that need an engine feature the mock lacks
answer as the JAX server's do.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import math
import os
import signal
import time
import uuid
from typing import Any
from urllib.parse import parse_qs, urlparse

from ..grammar import JSON_GBNF, json_schema_to_gbnf, parse_gbnf
from ..runtime.sampler import SamplingParams
from .chat_template import normalize_messages, render_chat
from .http import HttpLimitError, read_request, send_error, send_response, sse_event
from .tool_calls import (ToolRequestError, parse_tool_calls, prepare_messages, tool_grammar,
                         validate_tools)


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


TOP_LOGPROBS_MAX = 8   # the engine's top-k a step (InferenceEngine.TOP_LOGPROBS_K)
N_MAX = 8              # OpenAI ``n``: choices a request may fan out to


def _resolve_grammar(body: dict) -> str:
    """GBNF text for the request's constraint fields, '' when none: the
    native ``grammar`` (GBNF) and ``json_schema`` fields, or OpenAI
    ``response_format`` (json_object, json_schema). ValueError (-> 400) on
    a malformed schema or grammar."""
    if body.get("grammar"):
        g = str(body["grammar"])
        parse_gbnf(g)                    # validate here -> 400, not mid-decode
        return g
    if body.get("json_schema") is not None:
        return json_schema_to_gbnf(body["json_schema"])
    rf = body.get("response_format")
    if not rf:
        return ""
    if not isinstance(rf, dict):
        raise ValueError("response_format must be an object")
    rtype = rf.get("type", "text")
    if rtype == "text":
        return ""
    if rtype == "json_object":
        schema = rf.get("schema")        # llama.cpp extension
        return json_schema_to_gbnf(schema) if schema else JSON_GBNF
    if rtype == "json_schema":
        js = rf.get("json_schema") or {}
        schema = js.get("schema") if isinstance(js, dict) else None
        if schema is None:
            raise ValueError("response_format.json_schema.schema is required")
        return json_schema_to_gbnf(schema)
    raise ValueError(f"unsupported response_format type {rtype!r}")


def _parse_logit_bias(body: dict) -> dict[int, float] | None:
    lb = body.get("logit_bias")
    if not lb:
        return None
    out: dict[int, float] = {}
    if isinstance(lb, dict):             # OpenAI: {"token_id": bias}
        items = lb.items()
    elif isinstance(lb, list):           # llama.cpp: [[id, bias], ...]
        items = ((p[0], p[1]) for p in lb
                 if isinstance(p, (list, tuple)) and len(p) == 2)
    else:
        raise ValueError("logit_bias must be an object or a list of pairs")
    for k, v in items:
        try:
            out[int(k)] = -1e9 if v is False else float(v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad logit_bias entry {k!r}: {v!r}") from e
    return out or None


def _params_from_request(body: dict, default_max: int = 256) -> SamplingParams:
    """SamplingParams from an OpenAI request body (the JAX package's
    parse); ValueError (-> 400) on a malformed field."""
    stop = body.get("stop") or ()
    stop = (stop,) if isinstance(stop, str) else tuple(str(s) for s in stop)
    seed = body.get("seed")
    max_tokens = body.get("max_tokens") or body.get("max_completion_tokens") \
        or body.get("n_predict") or default_max
    n_probs = 0
    if body.get("logprobs"):
        lp = body.get("logprobs")
        n_probs = int(body.get("top_logprobs") or
                      (lp if isinstance(lp, int) and not isinstance(lp, bool)
                       else 0))
        n_probs = max(n_probs, 1)
    return SamplingParams(
        n_probs=min(n_probs, TOP_LOGPROBS_MAX),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        min_p=float(body.get("min_p", 0.0)),
        typical_p=float(body.get("typical_p", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        repeat_penalty=float(body.get("repeat_penalty", 1.0)),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        seed=int(seed) if seed is not None else int.from_bytes(os.urandom(4), "little"),
        max_tokens=int(max_tokens),
        stop=stop,
        logit_bias=_parse_logit_bias(body),
        grammar=_resolve_grammar(body),
    )


def _parse_n(body: dict) -> int | None:
    """OpenAI ``n`` (choices per request), at most N_MAX; None when invalid
    (-> 400)."""
    n = body.get("n", 1)
    if n is None:
        return 1
    if isinstance(n, bool) or not isinstance(n, int) or not 1 <= n <= N_MAX:
        return None
    return n


def _fanout_params(params: SamplingParams, n: int) -> list[SamplingParams]:
    """Each choice's params: choice i samples with the request's seed + i, so
    choice 0 is the n = 1 answer and a seeded request stays reproducible."""
    return [params if i == 0 else
            dataclasses.replace(params, seed=(params.seed + i) & 0xFFFFFFFF)
            for i in range(n)]


class OpenAIServer:
    def __init__(self, engine, config: BackendConfig | None = None):
        self.engine = engine
        self.cfg = config or BackendConfig.from_env()
        self._server: asyncio.AbstractServer | None = None
        self.started = time.monotonic()

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
            if path == "/props":
                await self.handle_props(writer)
            elif path == "/v1/models" and req.method == "GET":
                await self.handle_models(writer)
            elif path == "/v1/chat/completions" and req.method == "POST":
                await self.handle_generate(req, writer, chat=True)
            elif path in ("/v1/completions", "/completion") and req.method == "POST":
                await self.handle_generate(req, writer, chat=False)
            elif path == "/v1/embeddings" and req.method == "POST":
                await self.handle_embeddings(req, writer)
            elif path == "/tokenize" and req.method == "POST":
                await self.handle_tokenize(req, writer)
            elif path == "/detokenize" and req.method == "POST":
                await self.handle_detokenize(req, writer)
            elif path == "/apply-template" and req.method == "POST":
                await self.handle_apply_template(req, writer)
            elif path == "/slots" and req.method == "GET":
                info = getattr(self.engine, "slots_info", None)
                await send_response(writer, 200, json.dumps(
                    info() if callable(info) else []).encode())
            elif path.startswith("/slots/") and req.method == "POST":
                await self.handle_slot_action(req, writer, path)
            elif path == "/infill" and req.method == "POST":
                await self.handle_infill(req, writer)
            elif path in ("/v1/rerank", "/rerank", "/v1/reranking") and req.method == "POST":
                await self.handle_rerank(req, writer)
            else:
                await send_error(writer, 404, f"Unknown endpoint {path}",
                                 "invalid_request_error", "not_found")
        except (ConnectionError, BrokenPipeError):
            pass
        finally:
            writer.close()

    async def handle_props(self, writer) -> None:
        await send_response(writer, 200, json.dumps({
            "model": self.engine.model_name,
            "uptime_seconds": round(time.monotonic() - self.started, 3),
            **self.engine.stats()}).encode())

    async def handle_models(self, writer) -> None:
        await send_response(writer, 200, json.dumps({
            "object": "list",
            "data": [{"id": self.engine.model_name, "object": "model",
                      "created": _now(), "owned_by": "local"}],
        }).encode())

    def _render_prompt(self, messages: list) -> str:
        """Chat-template rendering (GGUF jinja template, chatml fallback;
        the mock engine has neither metadata nor token texts)."""
        tok = self.engine.tokenizer
        tokens = getattr(tok, "tokens", None)
        bos = tokens[tok.special.bos_id] if tokens and tok.special.bos_id >= 0 else "<s>"
        eos = tokens[tok.special.eos_id] if tokens and tok.special.eos_id >= 0 else "</s>"
        md = getattr(self.engine, "metadata", None) or {}
        return render_chat(normalize_messages(messages), md.get("tokenizer.chat_template"),
                           bos, eos)

    @staticmethod
    def _parse_json(req) -> dict | None:
        try:
            body = json.loads(req.body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        return body if isinstance(body, dict) else None

    # -- llama-server's utility paths -----------------------------------------
    async def handle_tokenize(self, req, writer) -> None:
        body = self._parse_json(req)
        if body is None or "content" not in body:
            await send_error(writer, 400, "content is required",
                             "invalid_request_error", "bad_request")
            return
        tok = self.engine.tokenizer
        ids = tok.encode(str(body["content"]), add_bos=bool(body.get("add_special", False)))
        tokens = [{"id": i, "piece": tok.piece(i)} for i in ids] \
            if body.get("with_pieces") else ids
        await send_response(writer, 200, json.dumps({"tokens": tokens}).encode())

    async def handle_detokenize(self, req, writer) -> None:
        body = self._parse_json(req)
        if body is None or not isinstance(body.get("tokens"), list):
            await send_error(writer, 400, "tokens is required",
                             "invalid_request_error", "bad_request")
            return
        tok = self.engine.tokenizer
        try:
            ids = [int(t) for t in body["tokens"]]
        except (TypeError, ValueError):
            await send_error(writer, 400, "tokens must be integers",
                             "invalid_request_error", "bad_request")
            return
        vocab = getattr(tok, "vocab_size", None)
        if vocab is not None and any(not 0 <= t < vocab for t in ids):
            await send_error(writer, 400, "token id out of range",
                             "invalid_request_error", "bad_request")
            return
        await send_response(writer, 200, json.dumps({"content": tok.decode(ids)}).encode())

    async def handle_apply_template(self, req, writer) -> None:
        body = self._parse_json(req)
        if body is None or not isinstance(body.get("messages"), list):
            await send_error(writer, 400, "messages is required",
                             "invalid_request_error", "bad_request")
            return
        await send_response(writer, 200, json.dumps(
            {"prompt": self._render_prompt(body["messages"])}).encode())

    async def handle_slot_action(self, req, writer, path: str) -> None:
        """``POST /slots/{id}?action=save|restore|erase``: save and restore
        write and read ``SLOT_SAVE_PATH/<basename of filename>`` (without
        ``SLOT_SAVE_PATH`` they are refused); erase drops the slot's kept
        prompt."""
        sid = path[len("/slots/"):]
        if not sid.isdigit():
            await send_error(writer, 400, "slot id must be an integer",
                             "invalid_request_error", "bad_request")
            return
        action = (parse_qs(urlparse(req.path).query).get("action") or [""])[0]
        if action not in ("save", "restore", "erase"):
            await send_error(writer, 400, "action must be save, restore or erase",
                             "invalid_request_error", "bad_request")
            return
        op_fn = getattr(self.engine, "slot_op", None)
        if not callable(op_fn):
            await send_error(writer, 501, "slot persistence is not supported by this backend",
                             "server_error", "not_implemented")
            return
        full = ""
        if action != "erase":
            base = os.environ.get("SLOT_SAVE_PATH", "")
            if not base:
                await send_error(writer, 400, "slot save/restore requires "
                                 "SLOT_SAVE_PATH (llama-server --slot-save-path)",
                                 "invalid_request_error", "bad_request")
                return
            body = self._parse_json(req) or {}
            fname = os.path.basename(str(body.get("filename") or ""))
            if not fname:
                await send_error(writer, 400, "filename is required",
                                 "invalid_request_error", "bad_request")
                return
            full = os.path.join(base, fname)
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(
                None, lambda: op_fn(action, int(sid), full))
        except ValueError as e:
            await send_error(writer, 400, str(e), "invalid_request_error", "bad_request")
            return
        except FileNotFoundError:
            await send_error(writer, 400, "no such slot file",
                             "invalid_request_error", "bad_request")
            return
        await send_response(writer, 200, json.dumps(out).encode())

    async def handle_infill(self, req, writer) -> None:
        """Fill-in-the-middle (llama.cpp ``/infill``), PSM order: ``[BOS]
        <fim_pre> prefix <fim_suf> suffix <fim_mid>`` with the model's FIM
        token ids from its GGUF metadata."""
        body = self._parse_json(req)
        if body is None or "input_prefix" not in body:
            await send_error(writer, 400, "input_prefix is required",
                             "invalid_request_error", "bad_request")
            return
        tok = self.engine.tokenizer
        sp = tok.special
        if min(getattr(sp, "fim_pre_id", -1), getattr(sp, "fim_suf_id", -1),
               getattr(sp, "fim_mid_id", -1)) < 0:
            await send_error(writer, 501, "model has no fill-in-the-middle tokens",
                             "invalid_request_error", "not_supported")
            return
        ids = [sp.bos_id] if sp.bos_id >= 0 and sp.add_bos else []
        ids += [sp.fim_pre_id, *tok.encode(str(body.get("input_prefix", "")), add_bos=False),
                sp.fim_suf_id, *tok.encode(str(body.get("input_suffix", "")), add_bos=False),
                sp.fim_mid_id]
        try:
            params = _params_from_request(body)
        except ValueError as e:
            await send_error(writer, 400, str(e), "invalid_request_error", "bad_request")
            return
        pres = [self.engine.submit(ids, params)]
        rid = "infill-" + uuid.uuid4().hex[:24]
        if body.get("stream"):
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            await self._stream(writer, rid, "text_completion", pres, False,
                               include_usage, params)
        else:
            await self._complete(writer, rid, "text_completion", pres, False, params)

    async def handle_generate(self, req, writer, chat: bool) -> None:
        body = self._parse_json(req)
        field = "messages" if chat else "prompt"
        if body is None or field not in body \
                or (chat and not isinstance(body["messages"], list)):
            await send_error(writer, 400, f"{field} is required",
                             "invalid_request_error", "bad_request")
            return
        tools = None
        try:
            if chat:
                fns, forced, tools_on = validate_tools(body)
                messages = body["messages"]
                if tools_on or any(isinstance(m, dict) and (m.get("role") == "tool"
                                                            or m.get("tool_calls"))
                                   for m in messages):
                    messages = prepare_messages(messages, fns, tools_on)
                prompt = self._render_prompt(messages)
                params = _params_from_request(body)
                if tools_on and forced is not None:
                    if params.grammar:
                        raise ToolRequestError(
                            "grammar/response_format cannot be combined with a "
                            "forced tool_choice")
                    params = dataclasses.replace(params, grammar=tool_grammar(fns, forced))
                tools = fns if tools_on else None
            else:
                params = _params_from_request(body)
                prompt = body["prompt"]
                if isinstance(prompt, list):
                    prompt = "".join(str(p) for p in prompt)
        except ValueError as e:          # includes ToolRequestError
            await send_error(writer, 400, str(e), "invalid_request_error",
                             "bad_request")
            return
        n = _parse_n(body)
        if n is None:
            await send_error(writer, 400, f"n must be an integer in [1, {N_MAX}]",
                             "invalid_request_error", "bad_request")
            return
        if n > 1 and tools:
            await send_error(writer, 400, "n > 1 cannot be combined with tools",
                             "invalid_request_error", "bad_request")
            return
        # every choice is submitted up front, so the choices decode together
        pres = [self.engine.submit(prompt, p) for p in _fanout_params(params, n)]
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        obj = "chat.completion" if chat else "text_completion"
        if body.get("stream"):
            include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
            await self._stream(writer, rid, obj + (".chunk" if chat else ""),
                               pres, chat, include_usage, params, tools)
        else:
            await self._complete(writer, rid, obj, pres, chat, params, tools)

    def _cancel(self, pres: list) -> None:
        """Cancel submitted choices that will never be read (an early error
        return or a client gone), so their slots free at once."""
        if hasattr(self.engine, "cancel"):    # the mock engine has none
            for rid, _ in pres:
                self.engine.cancel(rid)

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
            if not finished and hasattr(self.engine, "cancel"):
                self.engine.cancel(rid)

    def _lp_entry(self, ev) -> dict:
        tok = self.engine.tokenizer
        return {
            "token": ev.text,
            "logprob": ev.logprob if ev.logprob is not None else 0.0,
            "bytes": list(ev.text.encode("utf-8")),
            "top_logprobs": [
                {"token": tok.piece(i), "logprob": lp,
                 "bytes": list(tok.piece(i).encode("utf-8"))}
                for i, lp in (ev.top_logprobs or [])
            ],
        }

    async def _complete(self, writer, rid: str, obj: str, pres: list, chat: bool,
                        params: SamplingParams, tools: list | None = None) -> None:
        choices = []
        usage_prompt = usage_gen = 0
        idx = 0
        try:
            for idx, pre in enumerate(pres):
                text: list[str] = []
                lp_content: list[dict] = []
                finish, n_prompt, n_gen = "stop", 0, 0
                async for ev in self._collect(pre):
                    text.append(ev.text)
                    n_prompt, n_gen = ev.n_prompt, ev.n_generated
                    if params.n_probs > 0:
                        lp_content.append(self._lp_entry(ev))
                    if ev.finished:
                        finish = ev.finish_reason or "stop"
                if finish == "error":
                    self._cancel(pres[idx + 1:])
                    await send_error(writer, 500, "inference engine failure",
                                     "server_error", "engine_error")
                    return
                usage_prompt = n_prompt
                usage_gen += n_gen
                content = "".join(text)
                if chat:
                    calls = parse_tool_calls(content, tools) if tools else None
                    if calls:
                        choice = {"index": idx,
                                  "message": {"role": "assistant", "content": None,
                                              "tool_calls": calls},
                                  "finish_reason": "tool_calls"}
                    else:
                        choice = {"index": idx,
                                  "message": {"role": "assistant", "content": content},
                                  "finish_reason": finish}
                    if params.n_probs > 0:
                        choice["logprobs"] = {"content": lp_content}
                else:
                    choice = {"index": idx, "text": content, "finish_reason": finish,
                              "logprobs": None}
                    if params.n_probs > 0:
                        choice["logprobs"] = {
                            "tokens": [e["token"] for e in lp_content],
                            "token_logprobs": [e["logprob"] for e in lp_content],
                            "top_logprobs": [{t["token"]: t["logprob"]
                                              for t in e["top_logprobs"]}
                                             for e in lp_content],
                        }
                choices.append(choice)
        except BaseException:
            self._cancel(pres[idx + 1:])
            raise
        await send_response(writer, 200, json.dumps({
            "id": rid, "object": obj, "created": _now(),
            "model": self.engine.model_name, "choices": choices,
            "usage": {"prompt_tokens": usage_prompt, "completion_tokens": usage_gen,
                      "total_tokens": usage_prompt + usage_gen},
        }).encode())

    async def _stream(self, writer, rid: str, obj: str, pres: list, chat: bool,
                      include_usage: bool, params: SamplingParams,
                      tools: list | None = None) -> None:
        """SSE for every choice, drained in index order (OpenAI clients route
        chunks by ``choices[].index``)."""
        head_sent = False

        def ensure_head():
            nonlocal head_sent
            if not head_sent:
                head_sent = True
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream"
                             b"\r\nCache-Control: no-cache\r\nConnection: close\r\n\r\n")

        def chunk(delta: dict | None, finish: str | None, idx: int) -> dict:
            c: dict[str, Any] = {"index": idx, "finish_reason": finish}
            if chat:
                c["delta"] = delta if delta is not None else {}
            else:
                c["text"] = (delta or {}).get("content", "")
            return {"id": rid, "object": obj, "created": _now(),
                    "model": self.engine.model_name, "choices": [c]}

        usage_prompt = usage_gen = 0

        async def stream_one(idx: int, pre) -> bool:
            nonlocal usage_prompt, usage_gen
            finish, n_prompt, n_gen = "stop", 0, 0
            first = True
            # with tools, text is held back while it may still be a tool-call
            # object; once its first character rules that out it streams
            buffering = bool(tools) and chat
            buf: list = []

            async def emit(ev) -> None:
                nonlocal first
                ensure_head()
                if first and chat:
                    first = False
                    writer.write(sse_event(chunk({"role": "assistant"}, None, idx)))
                if ev.text:
                    c = chunk({"content": ev.text}, None, idx)
                    if chat and params.n_probs > 0:   # as the JAX server: chat chunks only
                        c["choices"][0]["logprobs"] = {"content": [self._lp_entry(ev)]}
                    writer.write(sse_event(c))
                await writer.drain()

            async for ev in self._collect(pre):
                n_prompt, n_gen = ev.n_prompt, ev.n_generated
                if ev.finished:
                    finish = ev.finish_reason or "stop"
                if finish == "error" and not head_sent:
                    # nothing streamed yet: a real 5xx
                    await send_error(writer, 500, "inference engine failure",
                                     "server_error", "engine_error")
                    return False
                if buffering:
                    buf.append(ev)
                    lead = "".join(e.text for e in buf).lstrip()
                    if lead and lead[0] not in "{`":
                        buffering = False
                        for e in buf:
                            await emit(e)
                        buf.clear()
                    continue
                await emit(ev)
            if buf or (tools and chat and finish != "error"):
                content = "".join(e.text for e in buf)
                calls = parse_tool_calls(content, tools) if content else None
                if calls:
                    ensure_head()
                    writer.write(sse_event(chunk({"role": "assistant"}, None, idx)))
                    for i, call in enumerate(calls):
                        writer.write(sse_event(chunk({"tool_calls": [{
                            "index": i, "id": call["id"], "type": "function",
                            "function": {"name": call["function"]["name"],
                                         "arguments": ""}}]}, None, idx)))
                        writer.write(sse_event(chunk({"tool_calls": [{
                            "index": i, "function": {
                                "arguments": call["function"]["arguments"]}}]},
                            None, idx)))
                    await writer.drain()
                    finish = "tool_calls"
                elif content:
                    for e in buf:
                        await emit(e)
            ensure_head()
            if finish == "error":
                # mid-stream: an SSE error event, no [DONE]
                writer.write(sse_event({"error": {
                    "message": "inference engine failure",
                    "type": "server_error", "code": "engine_error"}}))
                await writer.drain()
                return False
            writer.write(sse_event(chunk(None, finish, idx)))
            usage_prompt = n_prompt
            usage_gen += n_gen
            return True

        idx = 0
        try:
            for idx, pre in enumerate(pres):
                if not await stream_one(idx, pre):
                    self._cancel(pres[idx + 1:])
                    return
        except BaseException:
            self._cancel(pres[idx + 1:])
            raise
        if include_usage:
            writer.write(sse_event({
                "id": rid, "object": obj, "created": _now(),
                "model": self.engine.model_name, "choices": [],
                "usage": {"prompt_tokens": usage_prompt, "completion_tokens": usage_gen,
                          "total_tokens": usage_prompt + usage_gen}}))
        writer.write(sse_event("[DONE]"))
        await writer.drain()

    # -- embeddings and rerank --------------------------------------------------
    async def handle_embeddings(self, req, writer) -> None:
        body = self._parse_json(req)
        if body is None or "input" not in body:
            await send_error(writer, 400, "input is required",
                             "invalid_request_error", "bad_request")
            return
        inputs = body["input"]
        if isinstance(inputs, str):
            inputs = [inputs]
        loop = asyncio.get_running_loop()
        data = []
        total = 0
        for i, text in enumerate(inputs):
            vec, n_tok = await loop.run_in_executor(None, self.engine.embed, str(text))
            total += n_tok
            data.append({"object": "embedding", "embedding": vec, "index": i})
        await send_response(writer, 200, json.dumps({
            "object": "list", "data": data, "model": self.engine.model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total}}).encode())

    async def handle_rerank(self, req, writer) -> None:
        """llama-server ``/v1/rerank``. With no cross-encoder rank head, a
        document's score is the cosine of its mean-pooled embedding with the
        query's (the JAX server's pooling path); an engine without
        ``embed`` answers 501."""
        body = self._parse_json(req)
        if body is None or "query" not in body:
            await send_error(writer, 400, "query is required",
                             "invalid_request_error", "bad_request")
            return
        docs = body.get("documents", body.get("texts"))
        if not isinstance(docs, list) or not docs:
            await send_error(writer, 400, "documents must be a non-empty array",
                             "invalid_request_error", "bad_request")
            return
        if not hasattr(self.engine, "embed"):
            await send_error(writer, 501, "this model cannot rerank (no embedding path)",
                             "server_error", "not_supported")
            return
        loop = asyncio.get_running_loop()
        qv, total = await loop.run_in_executor(None, self.engine.embed, str(body["query"]))
        qn = math.sqrt(sum(x * x for x in qv)) or 1.0
        results = []
        for i, doc in enumerate(docs):
            dv, n_tok = await loop.run_in_executor(None, self.engine.embed, str(doc))
            total += n_tok
            dn = math.sqrt(sum(x * x for x in dv)) or 1.0
            results.append({"index": i,
                            "relevance_score": sum(a * b for a, b in zip(qv, dv)) / (qn * dn)})
        results.sort(key=lambda r: -r["relevance_score"])
        top_n = body.get("top_n")
        if isinstance(top_n, int) and top_n > 0:
            results = results[:top_n]
        await send_response(writer, 200, json.dumps({
            "model": self.engine.model_name, "object": "list",
            "usage": {"prompt_tokens": total, "total_tokens": total},
            "results": results}).encode())

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


# GGUF architectures served by the encoder (embedding-only) engine:
# llama-server's --embedding mode
ENCODER_ARCHES = ("bert",)


def _gguf_arch(model_path: str) -> str:
    from ..gguf.reader import GGUFReader
    reader = GGUFReader(model_path)
    try:
        return str(reader.metadata.get("general.architecture", "llama"))
    finally:
        reader.close()


def build_engine_from_env(device: str = "cuda"):
    """The engine the environment names. Without ``MODEL_PATH``, or with
    ``MOCK_BACKEND`` (1, true or yes), the mock engine (``runtime.mock``;
    ``MODEL_NAME``, ``MOCK_DELAY_S`` its per-token delay), as the JAX
    server does. A GGUF of an :data:`ENCODER_ARCHES` architecture gets the
    embedding-only ``runtime.encoder_engine.EncoderEngine`` (buckets 64 and
    512). Otherwise the model at ``MODEL_PATH`` with ``MAX_SLOTS``,
    ``CTX`` (total, split over slots) or ``CTX_PER_SLOT``, and the KV cache:
    ``KV_CACHE_TYPE`` (bf16, q8_0, q4_0, q4_1; q5_0/q5_1 run as q8_0),
    ``KV_LAYOUT`` (contig or paged) and ``KV_PAGE_SIZE`` (tokens per page),
    ``MULTI_STEP``, the decode steps fused in one dispatch (1 = off),
    ``PREFIX_CACHE`` (slot prompt caching, on unless 0, false or no),
    ``CTX_SHIFT`` (llama-server ``--ctx-shift``: on for 1, true or yes),
    ``LORA_PATH`` and ``LORA_SCALE`` (a GGUF LoRA adapter, llama-server
    ``--lora`` / ``--lora-scaled``). The slot actions read
    ``SLOT_SAVE_PATH`` per request."""
    model_path = os.environ.get("MODEL_PATH", "")
    if _mock_requested() or not model_path:
        from ..runtime.mock import MockEngine
        return MockEngine(model_name=os.environ.get("MODEL_NAME", "mock-model"),
                          delay_s=float(os.environ.get("MOCK_DELAY_S", "0") or 0))
    if _gguf_arch(model_path) in ENCODER_ARCHES:
        from ..runtime.encoder_engine import EncoderEngine
        print("[backend] encoder architecture: embedding-only mode "
              "(llama-server --embedding equivalent)", flush=True)
        return EncoderEngine(model_path, device=device)
    from ..runtime.engine import EngineConfig, InferenceEngine

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
        kv_page_size=int(os.environ.get("KV_PAGE_SIZE", 1024)),
        multi_step=int(os.environ.get("MULTI_STEP", 1)),
        prefix_cache=os.environ.get("PREFIX_CACHE", "true").lower()
        not in ("0", "false", "no"),
        ctx_shift=os.environ.get("CTX_SHIFT", "").lower() in ("1", "true", "yes"),
        lora_path=os.environ.get("LORA_PATH", ""),
        lora_scale=float(os.environ.get("LORA_SCALE", 1.0))), device=device)


def _mock_requested() -> bool:
    return os.environ.get("MOCK_BACKEND", "").lower() in ("1", "true", "yes")


def main() -> None:
    engine = build_engine_from_env()
    engine.start()
    # warm the serving path in the background (the kernels' build first), so
    # the first real request pays neither; never on the mock
    if not _mock_requested() and hasattr(engine, "warmup_async") and \
            os.environ.get("ENGINE_WARMUP", "1").lower() not in ("0", "false", "no"):
        engine.warmup_async()
    srv = OpenAIServer(engine)
    try:
        asyncio.run(_serve_until_signal(srv, engine))
    finally:
        engine.stop()
    print("[backend] stopped", flush=True)


async def _serve_until_signal(srv: OpenAIServer, engine) -> None:
    """Serve until SIGTERM or SIGINT, then close the listener (the caller
    stops the engine and the process exits 0)."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await srv.start()
    print(f"[backend] {engine.model_name} on {srv.cfg.host}:{srv.port} "
          f"(auth={'on' if srv.cfg.api_key else 'off'})", flush=True)
    await stop.wait()
    await srv.close()


if __name__ == "__main__":
    main()
