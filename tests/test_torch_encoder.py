"""The port's BERT encoder on the CPU, against the JAX package's.

- A tiny ``transformers.BertModel`` built here (as ``tests/test_encoder.py``
  builds it), converted with the JAX package's ``convert`` (f32): the port's
  ``load_encoder`` + ``encoder_forward`` against the JAX ones (within
  ENCODER_TOL on the unit vectors) and against transformers' mean-pooled,
  L2-normalized output (within HF_ATOL, the JAX test's tolerance).
- ``tools.synth.synth_bert``'s tiny shape (hidden 256, ffn 512, 2 layers)
  with Q8_0 and Q4_K projections and both poolings, through each package's
  quantized path (the JAX package in its CPU mode): the loaded trees equal
  (``params_from_numpy`` of the JAX tree), the pooled vectors within
  ENCODER_TOL; padding leaks nothing; ``pooling_type`` 0 is refused; an
  overlong input keeps its [SEP].
- ``EncoderEngine``: ``embed``, ``submit`` and ``stats`` against the JAX
  engine's; its buckets clipped to ``max_positions``.
- Served: ``build_engine_from_env`` picks the encoder for a ``bert`` GGUF;
  the same requests to both servers get the same status and JSON shape.
- The bge-large shape's metadata parses to its published widths.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from llama_gguf_inference_tpu.models import encoder as jenc
from llama_gguf_inference_tpu.runtime import encoder_engine as jee
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu.tools.convert_hf import convert
from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
from llama_gguf_inference_tpu_torch.models import encoder as tenc
from llama_gguf_inference_tpu_torch.runtime import encoder_engine as tee
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime.convert import params_from_numpy
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams as TParams
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv
from llama_gguf_inference_tpu_torch.tools.synth import BERT_SHAPES, synth_bert
from test_torch_embeddings import _shape, _Writer
from test_torch_model import _assert_same, to_numpy_tree

torch.set_num_threads(1)

ENCODER_TOL = 5e-3     # max |port - JAX| on unit vectors: the same bf16 steps (measured 0)
HF_ATOL = 2e-2         # against transformers' f32 model (tests/test_encoder.py's)


@pytest.fixture(scope="module")
def hf_bert(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert") / "tiny-bert"
    cfg = transformers.BertConfig(
        vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=64, layer_norm_eps=1e-12,
        type_vocab_size=2)
    torch.manual_seed(11)
    model = transformers.BertModel(cfg)
    model.eval()
    model.save_pretrained(d, safe_serialization=False)
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + ["hello", "world", "quick", "brown", "fox", "jumps", "the", "over", "lazy",
                "dog", ".", ",", "un", "##believ", "##able", "##s", "he", "##llo"]
             + [f"tok{i}" for i in range(177)])
    (d / "vocab.txt").write_text("\n".join(vocab[:200]) + "\n", encoding="utf-8")
    dst = d.parent / "bert.gguf"
    convert(str(d), str(dst), dtype="f32", verbose=False)
    return str(dst), model


def _padded(ids_list, T, pad=0):
    tok = np.full((len(ids_list), T), pad, np.int32)
    for b, ids in enumerate(ids_list):
        tok[b, :len(ids)] = ids
    return tok, np.array([len(ids) for ids in ids_list], np.int32)


def _both(jparams, jcfg, tparams, tcfg, tok, lengths):
    want = np.asarray(jenc.encoder_forward(jparams, jcfg, jnp.asarray(tok),
                                           jnp.asarray(lengths)))
    with torch.inference_mode():
        got = tenc.encoder_forward(tparams, tcfg, torch.from_numpy(tok),
                                   torch.from_numpy(lengths)).numpy()
    return got, want


def test_hf_bert_matches_jax_and_transformers(hf_bert):
    path, model = hf_bert
    jcfg, jparams, r = jloader.load_encoder(path, mode="dense")
    r.close()
    tcfg, tparams, r = tloader.load_encoder(path, "cpu", mode="dense")
    r.close()
    assert tcfg == tenc.EncoderConfig(**vars(jcfg))
    rng = np.random.default_rng(3)
    ids = [[2] + list(rng.integers(5, 199, size=10)) + [3], [2, 7, 8, 3]]
    tok, lengths = _padded(ids, 16)
    got, want = _both(jparams, jcfg, tparams, tcfg, tok, lengths)
    assert got.shape == (2, 64) and np.abs(got - want).max() <= ENCODER_TOL
    for b, seq in enumerate(ids):
        with torch.no_grad():
            h = model(torch.tensor([seq])).last_hidden_state[0].numpy()
        pooled = h.mean(axis=0)
        np.testing.assert_allclose(got[b], pooled / np.linalg.norm(pooled), atol=HF_ATOL)


@pytest.fixture(scope="module", params=[("q8_0", 1), ("q8_0", 2), ("q4_k", 1), ("q4_k", 2)],
                ids=lambda p: f"{p[0]}-{'mean' if p[1] == 1 else 'cls'}")
def synth(request, tmp_path_factory):
    quant, pooling = request.param
    path = str(tmp_path_factory.mktemp("synth") / f"bert-{quant}-{pooling}.gguf")
    synth_bert(path, seed=1, quant=quant, shape="tiny", pooling=pooling)
    jcfg, jparams, r = jloader.load_encoder(path, mode="quant")
    r.close()
    tcfg, tparams, r = tloader.load_encoder(path, "cpu", mode="quant")
    r.close()
    return path, jcfg, jparams, tcfg, tparams


def test_load_encoder_equals_converted_jax_params(synth):
    _, jcfg, jparams, tcfg, tparams = synth
    assert tcfg == tenc.EncoderConfig(**vars(jcfg))
    assert tparams["tok_embd"].dtype == torch.bfloat16
    assert tparams["layers"][0]["attn_q_bias"].dtype == torch.float32
    _assert_same(tparams, params_from_numpy(to_numpy_tree(jparams), "cpu"))


def test_dense_load_equals_converted_jax_params(synth):
    path = synth[0]
    _, jparams, r = jloader.load_encoder(path, mode="dense")
    r.close()
    _, tparams, r = tloader.load_encoder(path, "cpu", mode="dense")
    r.close()
    _assert_same(tparams, params_from_numpy(to_numpy_tree(jparams), "cpu"))


def test_forward_matches_jax(synth):
    path, jcfg, jparams, tcfg, tparams = synth
    assert tcfg.pooling == ("mean" if path.endswith("-1.gguf") else "cls")
    rng = np.random.default_rng(5)
    ids = [[101] + list(rng.integers(104, 250, size=n)) + [102] for n in (40, 3, 62)]
    tok, lengths = _padded(ids, 64)
    got, want = _both(jparams, jcfg, tparams, tcfg, tok, lengths)
    assert got.shape == (3, 256) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ENCODER_TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # padding leaks nothing: other pad ids, a longer bucket
    tok7, _ = _padded(ids, 64, pad=7)
    tok_long, _ = _padded(ids, 128)
    with torch.inference_mode():
        for t in (tok7, tok_long):
            other = tenc.encoder_forward(tparams, tcfg, torch.from_numpy(t),
                                         torch.from_numpy(lengths)).numpy()
            np.testing.assert_allclose(other, got, atol=1e-5)


def test_pooling_type_zero_refused():
    md = {"general.architecture": "bert", "bert.embedding_length": 64,
          "bert.attention.head_count": 4, "bert.block_count": 2,
          "bert.feed_forward_length": 128, "bert.context_length": 64,
          "bert.vocab_size": 200, "bert.pooling_type": 0}
    for cls in (tenc.EncoderConfig, jenc.EncoderConfig):
        with pytest.raises(ValueError, match="pooling_type 0"):
            cls.from_gguf_metadata(md)
    md["bert.pooling_type"] = 2
    assert tenc.EncoderConfig.from_gguf_metadata(md) == \
        tenc.EncoderConfig(**vars(jenc.EncoderConfig.from_gguf_metadata(md)))
    assert tenc.EncoderConfig.from_gguf_metadata(md).pooling == "cls"


def test_bge_large_shape(tmp_path):
    """One layer of the bge-large shape: its metadata gives the published
    widths (every layer is the same tensors)."""
    path = synth_bert(str(tmp_path / "bge.gguf"), n_layers=1)
    r = GGUFReader(path)
    cfg = tenc.EncoderConfig.from_gguf_metadata(r.metadata)
    names = set(r.tensors)
    qtype = r.tensors["blk.0.attn_q.weight"].ggml_type.name
    r.close()
    assert (cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_dim, cfg.max_positions,
            cfg.vocab_size, cfg.pooling, cfg.n_layers) == (1024, 16, 64, 4096, 512, 30522,
                                                           "cls", 1)
    assert BERT_SHAPES["bge-large"]["n_layers"] == 24 and qtype == "Q8_0"
    assert "blk.0.ffn_down.bias" in names and "token_types.weight" in names


def test_synth_names_match_the_converter(synth, hf_bert):
    """synth_bert writes the tensor names and metadata keys the JAX
    converter writes (llama.cpp's BertModel export)."""
    a, b = GGUFReader(synth[0]), GGUFReader(hf_bert[0])
    try:
        assert set(a.tensors) == set(b.tensors)
        assert set(b.metadata) - {"general.name"} <= set(a.metadata)
        assert a.metadata["tokenizer.ggml.model"] == "bert"
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eng") / "bert.gguf")
    synth_bert(path, seed=2, quant="q8_0", shape="tiny")
    return path, jee.EncoderEngine(path), tee.EncoderEngine(path, device="cpu")


@pytest.mark.parametrize("prompt", ["hello world, the quick brown fox", [101, 300, 301, 102],
                                    "a " * 100], ids=["text", "ids", "102-tokens"])
def test_engine_embed_matches_jax(engines, prompt):
    _, je, te = engines
    (want, wn), (got, gn) = je.embed(prompt), te.embed(prompt)
    assert gn == wn and len(got) == len(want) == 256
    assert all(isinstance(x, float) for x in got)
    assert np.abs(np.array(got) - np.array(want)).max() <= ENCODER_TOL


def test_engine_surface_matches_jax(engines):
    path, je, te = engines
    assert te.buckets == je.buckets == (64, 512)
    assert te.model_name == je.model_name and te.ecfg.ctx == je.ecfg.ctx == 512
    assert te.ecfg.max_slots == je.ecfg.max_slots == 1
    events = []
    for eng, params in ((je, JParams(max_tokens=4)), (te, TParams(max_tokens=4))):
        eng.start()
        rid, q = eng.submit("hello", params)
        ev = q.get(timeout=5)
        events.append((rid, ev.finished, ev.finish_reason, ev.text, q.empty(),
                       eng.cancel(rid), eng.n_active(), eng.queue_depth()))
        eng.stop()
    assert events[0] == events[1] and events[1][2] == "error"
    assert "embedding-only" in events[1][3]
    for eng in (je, te):
        eng.embed("the lazy dog")
    assert te.stats() == je.stats()
    clipped = [cls(path, buckets=(1024, 64), **kw).buckets
               for cls, kw in ((jee.EncoderEngine, {}), (tee.EncoderEngine, {"device": "cpu"}))]
    assert clipped[0] == clipped[1] == (64, 512)


def test_overlong_input_keeps_sep(engines):
    path = engines[0]
    eng = tee.EncoderEngine(path, buckets=(16,), device="cpu")
    seen = {}
    real = eng._fwd

    def spy(params, cfg, tok, lengths):
        seen["ids"] = tok[0, :int(lengths[0])].tolist()
        return real(params, cfg, tok, lengths)

    eng._fwd = spy
    _, n = eng.embed("hello world " * 40)
    assert n == 16 and len(seen["ids"]) == 16
    assert seen["ids"][0] == eng.tokenizer.special.bos_id == 101
    assert seen["ids"][-1] == eng.tokenizer.special.eos_id == 102


def _req(srv, method, path, body=None):
    data = b"" if body is None else json.dumps(body).encode()
    req = (f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
           f"Content-Length: {len(data)}\r\n\r\n").encode() + data

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(req)
        reader.feed_eof()
        w = _Writer()
        await srv.handle_client(reader, w)
        return w.data

    head, _, payload = asyncio.run(go()).partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


@pytest.fixture(scope="module")
def servers(engines, tmp_path_factory):
    path = engines[0]
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_PATH", path)
    mp.delenv("MOCK_BACKEND", raising=False)
    try:
        je = jsrv.build_engine_from_env()
        te = tsrv.build_engine_from_env(device="cpu")
    finally:
        mp.undo()
    assert type(je).__name__ == type(te).__name__ == "EncoderEngine"
    assert isinstance(te, tee.EncoderEngine) and tsrv._gguf_arch(path) == "bert"
    assert tsrv.ENCODER_ARCHES == jsrv.ENCODER_ARCHES == ("bert",)
    return jsrv.OpenAIServer(je, jsrv.BackendConfig()), tsrv.OpenAIServer(te, tsrv.BackendConfig())


CHAT = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}
SERVED = [("POST", "/v1/embeddings", {"input": "hello world"}),
          ("POST", "/v1/embeddings", {"input": ["hello", "the quick brown fox"]}),
          ("POST", "/v1/rerank", {"query": "hello world",
                                  "documents": ["hello world", "the lazy dog", "fox"]}),
          ("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 4}),
          ("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 4, "stream": True}),
          ("POST", "/v1/chat/completions", CHAT),
          ("GET", "/health", None), ("GET", "/props", None), ("GET", "/slots", None),
          ("GET", "/v1/models", None), ("POST", "/tokenize", {"content": "hello world"}),
          ("POST", "/tokenize", {"content": "hello world", "add_special": True,
                                 "with_pieces": True}),
          ("POST", "/detokenize", {"tokens": [101, 300, 102]})]


def _norm(obj):
    """A response's JSON with its per-call values (ids, times) blanked."""
    if isinstance(obj, dict):
        return {k: None if k in ("id", "created", "uptime_seconds") else _norm(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


@pytest.mark.parametrize("i", range(len(SERVED)), ids=[f"{m} {p}" for m, p, _ in SERVED])
def test_served_matches_jax(servers, i):
    method, path, body = SERVED[i]
    (ws, want), (gs, got) = [_req(s, method, path, body) for s in servers]
    assert gs == ws, (got, want)
    got, want = json.loads(got), json.loads(want)
    if path in ("/v1/embeddings", "/v1/rerank"):
        assert gs == 200 and _shape(got) == _shape(want)
        vals = [(d.get("embedding") or [d["relevance_score"]]) for d in
                got.get("data") or got["results"]]
        ref = [(d.get("embedding") or [d["relevance_score"]]) for d in
               want.get("data") or want["results"]]
        assert np.abs(np.array(vals) - np.array(ref)).max() <= ENCODER_TOL
        if path == "/v1/rerank":
            assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
            assert got["results"][0]["index"] == 0
    else:
        assert _norm(got) == _norm(want)
    if path.endswith("completions"):     # streamed or not: the engine's failure, as JAX's
        assert gs == 500 and got["error"]["code"] == "engine_error"

