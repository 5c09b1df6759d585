"""The port's decoder embeddings, on the CPU, against the JAX package.

``InferenceEngine.embed``: the mean over the valid positions of the final
normed hidden states, pooled in f32, on a scratch cache of its own, against
the JAX engine's ``embed`` on the same tiny Q4_K_M model at 1, 17 and 1100
tokens (cut at 1024, the JAX engine's largest bucket): the same count, and
the vectors within EMBED_TOL of their scale (both forwards' hidden states
are bf16: a bf16 rounding apart, with the plain path's f32 sums in another
order). The slots and their caches are untouched.

``/v1/embeddings`` and the three rerank paths through each server's
``handle_client`` (the routing too) over its own engine: the same statuses,
the same JSON keys and shapes, the vectors and scores within tolerance, the
same order and ``top_n``; the 400s the JAX server answers; and a 501 from
each server on an engine without ``embed``.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

EMBED_TOL = 0.03           # of max |x|: a bf16 rounding of the hidden states apart
SCORE_TOL = 0.01           # cosine scores: measured 0.002 apart


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = write_tiny_q4km(str(tmp_path_factory.mktemp("emb") / "q.gguf"))
    je = jengine.InferenceEngine(path, jengine.EngineConfig(max_slots=2, ctx=64))
    te = tengine.InferenceEngine(path, tengine.EngineConfig(max_slots=2, ctx=64),
                                 device="cpu")
    return je, te


@pytest.mark.parametrize("n", [1, 17, 1100])
def test_embed_matches_jax(engines, n):
    je, te = engines
    ids = np.random.default_rng(n).integers(3, 500, size=n).tolist()
    want, jn = je.embed(ids)
    before = [t.clone() for t in te.cache.k[:1]]
    got, tn = te.embed(ids)
    assert tn == jn == min(n, 1024)
    assert len(got) == len(want) == te.cfg.dim and all(isinstance(x, float) for x in got)
    got, want = np.array(got), np.array(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= EMBED_TOL * np.abs(want).max()
    assert all(torch.equal(a, b) for a, b in zip(before, te.cache.k[:1]))


def test_embed_truncates_and_takes_text(engines):
    _, te = engines
    ids = np.random.default_rng(5).integers(3, 500, size=1030).tolist()
    assert te.embed(ids) == te.embed(ids[:1024])
    vec, n = te.embed("hello world")
    ids = te.tokenizer.encode("hello world")
    assert ids and n == len(ids) and len(vec) == te.cfg.dim
    assert te.embed(ids) == (vec, n)


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def _http(srv, path, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
           f"Content-Length: {len(data)}\r\n\r\n").encode() + data

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(req)
        reader.feed_eof()
        w = _Writer()
        await srv.handle_client(reader, w)
        return w.data

    out = asyncio.run(go())
    head, _, payload = out.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), json.loads(payload)


@pytest.fixture(scope="module")
def servers(engines):
    je, te = engines
    return (jsrv.OpenAIServer(je, jsrv.BackendConfig()),
            tsrv.OpenAIServer(te, tsrv.BackendConfig()))


def _shape(obj):
    """The JSON's structure: keys and list lengths, numbers as types."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__ if isinstance(obj, (int, float)) else obj


EMBED_BODIES = [{"input": "hello world"}, {"input": ["hello", "the quick brown fox", ""]}]


@pytest.mark.parametrize("i", range(len(EMBED_BODIES)))
def test_embeddings_endpoint_matches_jax(servers, i):
    (ws, want), (gs, got) = [_http(s, "/v1/embeddings", EMBED_BODIES[i]) for s in servers]
    assert gs == ws == 200
    assert _shape({**got, "model": None}) == _shape({**want, "model": None})
    assert got["usage"] == want["usage"]
    for g, w in zip(got["data"], want["data"]):
        assert g["index"] == w["index"]
        g, w = np.array(g["embedding"]), np.array(w["embedding"])
        assert np.abs(g - w).max() <= EMBED_TOL * np.abs(w).max()


DOCS = ["the quick brown fox", "hello world", "a b c d e f", "over the lazy dog"]


@pytest.mark.parametrize("path", ["/v1/rerank", "/rerank", "/v1/reranking"])
@pytest.mark.parametrize("top_n", [None, 2])
def test_rerank_matches_jax(servers, path, top_n):
    body = {"query": "the quick brown fox", "documents": DOCS}
    if top_n:
        body["top_n"] = top_n
    (ws, want), (gs, got) = [_http(s, path, body) for s in servers]
    assert gs == ws == 200
    assert _shape({**got, "model": None}) == _shape({**want, "model": None})
    assert got["usage"] == want["usage"] and got["object"] == "list"
    assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
    assert len(got["results"]) == (top_n or len(DOCS))
    for g, w in zip(got["results"], want["results"]):
        assert abs(g["relevance_score"] - w["relevance_score"]) <= SCORE_TOL
    # the query itself ranks first; the order is not a tie within tolerance
    assert got["results"][0]["index"] == 0
    assert abs(got["results"][0]["relevance_score"] - 1.0) <= 1e-6
    scores = [r["relevance_score"] for r in want["results"]]
    assert min(a - b for a, b in zip(scores, scores[1:])) > 2 * SCORE_TOL


BAD = [("/v1/embeddings", {"inputs": "x"}, None), ("/v1/embeddings", None, b"not json"),
       ("/v1/rerank", {"documents": ["a"]}, None),
       ("/rerank", {"query": "q", "documents": []}, None),
       ("/v1/reranking", {"query": "q", "texts": "a"}, None),
       ("/v1/rerank", {"query": "q"}, None)]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_bad_requests_match_jax(servers, i):
    path, body, raw = BAD[i]
    want, got = [_http(s, path, body, raw) for s in servers]
    assert got == want and got[0] == 400


def test_rerank_takes_texts(servers):
    body = {"query": "hello world", "texts": ["hello world", "a b c d e f"]}
    want, got = [_http(s, "/rerank", body) for s in servers]
    assert got[0] == want[0] == 200
    assert [r["index"] for r in got[1]["results"]] == [r["index"] for r in want[1]["results"]]


class _NoEmbed:
    model_name = "no-embed"


def test_rerank_without_embed_is_501():
    body = {"query": "q", "documents": ["a"]}
    got = [_http(srv, "/v1/rerank", body) for srv in (
        jsrv.OpenAIServer(_NoEmbed(), jsrv.BackendConfig()),
        tsrv.OpenAIServer(_NoEmbed(), tsrv.BackendConfig()))]
    assert got[0] == got[1] and got[1][0] == 501
    assert got[1][1]["error"]["code"] == "not_supported"
