"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi)
2. build    — compile the CUDA kernels from ``csrc/`` (one nvcc per source)
   plans    — the 8-bit, int8 and 2/4-bit decode kernels' launch plans at the 8B
              shapes (grid, block, shared bytes, registers, spills, resident
              warps; a spill fails the run); the 2/4-bit tensor-core (wgmma)
              kernel's plans at 32 and 512 rows, the int8 one's at
              INT8_TC_MIN_ROWS and 512 and the 8-bit one's at TC_MIN_ROWS
              and 512 (with the host's time to build a launch's tensor
              maps), and every instance of each and of the tensor-core
              flash kernel with its registers, spills and its SASS's count
              of HGMMA (bf16 wgmma) and, int8, IGMMA (s8 wgmma) (a spill,
              a missing GMMA or a wgmma ptxas serialized fails the run)
3. kernels  — each kernel against its plain PyTorch version at the 8B
              shapes: 4-bit matmul (flat Q4_K) at the four projection shapes
              for 1, 4 and 512 rows, and with Q3_K's geometry (sub-blocks of
              16, code bias 4) at o and down and Q4_K in the compact and
              mixed scale layouts at gate_up; 2-bit matmul (Q2_K) at the four
              projection shapes for 1, 4 and 512 rows in the flat and mixed
              layouts and for 4 rows in compact; 8-bit matmul at the Q6_K
              head for 1, 4 and 64 rows, and with its min term at the Q5_K
              projections (compact and flat, 1, 4 and 512 rows; compact
              gate_up and qkv also at 16, 64 and 300) and Q5_1's o; from
              TC_MIN_ROWS rows up through its tensor-core kernel, which also
              runs Q8_0's flat o at 16, 64, 300 and 512 rows; the decode and
              tensor-core 8-bit kernels side by side at the four Q5_K compact
              projections and at Q8_0's o for 8, 16, 32 and 64 rows (the
              crossover that sets TC_MIN_ROWS);
              the 4-bit base, xsum, split and int8 kernels at Q4_K gate_up and
              down (1, 4, 512 rows) and at Q4_0, Q4_1 and Q3_K's o; the base
              body's 2-bit kernel at Q2_K gate_up (flat, compact); the int8
              kernel also at Q4_K qkv and o (1 and 4 rows); the IQ2/IQ3
              value maps through fsplit and base at o; flash
              attention over each cache kind (bf16, q8_0, q4_0, q4_1, paged
              bf16, paged q8_0) at decode through the split kernel (T=1, B=4,
              offsets up to 1000, beside the unsplit kernel's time as
              PERF.md recorded it; B=1 at offset 1000 over 1024 slots and at 8191
              over 8192) and prefill (T=512, B=1, offsets 0 and 1024; bf16
              and q8_0 also at 7680 over 8192 slots, an 8K prompt's last
              chunk) through its tensor-core kernel beside the CUDA-core one, and
              at T=16, 32 and 64 (offset 1000: the crossover that sets
              FLASH_TC_MIN_ROWS); the paged ones through shuffled pages of
              256 with one idle slot whose table row is all -1; the 2- and
              4-bit tensor-core kernels at the four projections for 16, 64,
              300 and 512 rows (4-bit: Q4_K flat, compact and mixed, Q3_K at
              o and down, the IQ2/IQ3 maps at o; 2-bit: Q2_K flat, mixed and
              compact), each beside the decode kernel on the same inputs,
              and at 8, 24, 32 and 48 rows too in the served layouts (Q4_K
              flat, Q2_K mixed: the crossover that sets LOWBIT_TC_MIN_ROWS;
              at 16 and 512 rows with the host's time for one call);
              the int8 body's
              and the base rule's tensor-core kernels at the four Q4_K flat
              projections for 8, 16, 32, 64, 300 and 512 rows (int8 also 24
              and 48) and at Q4_0,
              Q4_1 and Q3_K's o for 16, 64, 300 and 512, the base_f32 rule
              at Q2_K flat and compact gate_up for 512, the xsum and split
              rules at the four Q4_K flat projections for 16, 64, 300 and
              512 rows and at gate_up for 8 and 32, each beside its
              decode kernel (the crossover that sets INT8_TC_MIN_ROWS; the
              base, xsum and split rules' against LOWBIT_TC_MIN_ROWS).
              Prints errors,
              the kernel's median time, the plain version's, one PyTorch
              library call's (a yardstick only: SDPA over the bf16, dequantized
              or gathered cache), and the least time the card could take
              (bytes over 3.35 TB/s or bf16 operations over 989 TFLOP/s,
              whichever is larger) and its share of the kernel's time
4. load     — synthesize the 8B Q4_K_M GGUF (``tools.synth.cached_model``:
              under the temp dir, reused when present; with its three FIM
              tokens, which leave every tensor as it was) and load it cold on
              the card into a fresh layout cache (``LGT_LAYOUT_CACHE_DIR``, a
              new directory each run, each model's cache removed once its
              phases end): the split of ``load_stats`` (native and numpy
              repack, cache write, staging, copy, carve) and the native
              repacks, which must equal the file's Q4_K and Q6_K tensors
   warm-load — the same file loaded again from its cache in this process:
              every resident tensor equal to the engine's bit for bit, layer
              0's projections, the embedding and the head equal to the
              per-tensor path's (``LGT_UPLOAD=tensor``), the bytes it asks
              of the allocator equal to its tensors'; then the same load in
              a fresh process: the bytes it adds to
              ``torch.cuda.memory_allocated()`` within 1% of its tensors'
              (in this process the allocator's rounding of blocks depends on
              what earlier phases left cached); ``load_s`` and GB/s
   cold-start — ``python -m llama_gguf_inference_tpu_torch.serving.
              openai_server`` as a fresh process over the warm cache, with
              ``ENGINE_WARMUP=1`` and then 0: seconds to listening, the
              warm-up's seconds from its log line (``warm-up failed`` fails
              the run), the first chat's time to its first token, an exit 0
              on SIGTERM; then the mock backend without ``MODEL_PATH``
              (``/v1/models`` and one completion)
   launch   — ``python -m llama_gguf_inference_tpu_torch serve``
              (``launch/start.py``: the port's backend, health sidecar and
              gateway) over the same GGUF, warm from its layout cache, with
              an API key file: the health port answers; through the gateway
              a request without the key gets 401, a streamed greedy chat of
              32 tokens with every EOG token banned arrives chunk by chunk,
              ``/metrics`` counts the requests and the ported benchmark
              client runs a few (its summary printed); the chat's text equal
              to the same chat served in this process (the backend's launch
              counts are its own process's); SIGTERM: the supervisor and its
              three children exit 0, the backend key file is shredded
   embeddings — ``/v1/embeddings`` for two inputs through the server, each
              within LOGITS_TOL of the same pooling over a forward on the
              plain versions; a rerank of three documents ranks the one
              equal to the query first
   encoder  — a bge-large-en-v1.5-shaped BERT (24 layers of 1024, Q8_0
              projections; ``tools.synth.cached_bert``) built by
              ``build_engine_from_env`` from ``MODEL_PATH`` and served:
              ``/v1/embeddings`` of a short input and one of 500 tokens (the
              64 and 512 buckets, each twice, timed), a rerank (the query's
              own text first), ``/v1/completions`` (the JAX server's 500,
              ``engine_error``: the engine is embedding-only); each vector within LOGITS_TOL of the plain versions';
              q, k, v, o and ffn_up (in 1024: 32 sub-blocks, short of the
              tensor-core kernel's step of 64) through the 8-bit decode
              kernel, ffn_down through the tensor-core one, both launched;
              layer 0's q and ffn_up at 512 rows through the decode kernel
              and its ffn_down at 64 and 512 through the tensor-core one,
              each held to the plain version and timed beside its bound and
              ``torch.matmul`` (the kernels line's tensor-core 8-bit row)
   forward  — run a prefill and 16 greedy decode steps through the kernels,
              then again through the plain versions on the card, fed the
              kernel run's tokens; compare the logits of every step; then one
              512-token prefill chunk (qkv, o and gate_up through the 4-bit
              tensor-core kernel, ffn_down through the dequantize path, the
              attention through the tensor-core flash kernel, the head's row
              through the 8-bit decode kernel; logits held against the plain
              versions) and the served time to the first token of a prompt
              of at most 512 tokens
5. kv-forward — the same prefill and 16 steps over each quantized or paged
              cache kind, through the kernels and then, fed the same tokens,
              with only that kind's attention wrapper swapped for its plain
              version; then three greedy requests through the engine's
              scheduler over four slots of that kind (one idle), each token
              checked against a replay on a one-sequence cache (their
              prefill, padded to the engine's bucket of 16 or 32 rows,
              through the kind's tensor-core flash kernel, from
              FLASH_TC_MIN_ROWS (16, the smallest bucket), their decode
              steps through its decode kernel)
6. serve    — the port's OpenAI server in-process on localhost (4 slots, 1024
              context each): a chat completion, a streamed one, four concurrent
              completions, and a request without the key (must get 401)
7. decode-dispatch — the same engine served at ``multi_step`` 1 and 4: four
              concurrent greedy requests of 64 tokens (the same tokens at
              both) and a streamed one; at 4 also a request banning every
              EOG token by ``logit_bias`` (runs to its max_tokens), a seeded
              request with temperature, top-k/p, min-p, typical-p, the
              penalties and ``top_logprobs``, and a seeded mirostat one, each
              twice (the same answer twice); at 4 every dispatch runs under
              ``torch.cuda.set_sync_debug_mode("error")`` and continuations
              (dispatches issued from the previous one's on-card outputs)
              must have been issued; batch-1 and 4-request rates at both
              printed for information beside the card's name and power limit
8. structured — the same engine, multi_step 4, through the server: on four
              cold slots a json_schema answer (an enum and a boolean) at
              temperature 0, every dispatch and grammar mask flush under the
              sync debug mode, and at 0.8 seeded, EOG banned (the mask forces
              it where the grammar can stop); a json_object answer cut at 16
              tokens that a fresh matcher still accepts; a forced tool call,
              non-streamed and streamed (the same calls, finish "tool_calls");
              n = 3 (choices 0-2, choice 0 the n = 1 answer); the constrained
              decode rate at B = 1 beside the unconstrained one. Then five
              slots with the prefix cache on: a prompt of about 700 tokens
              cold, another sharing its system prompt (both TTFTs, the tokens
              reused, its last logits against a cold run within LOGITS_TOL),
              the 4-request load while its slot sits free, and it again (the
              same tokens). The sampler's stages on masked rows on the card
              against its CPU draws; the vocab trie's build time, each new
              grammar state's mask time and the state count
9. variants — the same engine under each ``LGT_MM_VARIANT`` (base, xsum,
              split, int8): a prefill and 16 greedy steps held against the
              plain versions, then three greedy requests through the server;
              each run launches that variant's kernel and never fsplit's
              (decode or tensor-core); under each then one 512-token chunk
              through that body's tensor-core kernel (qkv, o and gate_up;
              ffn_down through the dequantize path, the head through the
              8-bit decode kernel), held against the plain versions (int8:
              to INT8_LOGITS_TOL, every call shadowed)
10. ctx-shift — the same engine with ``ctx_shift`` over 4 slots of 128
              positions at multi_step 4, a bf16 and a q8_0 cache: two greedy
              requests, EOG banned, of 144 tokens each, far past their slots,
              so the engine shifts (at least twice a run); the first shift
              held against the same shift of a copy of the slot's rows on
              the CPU, the matmul and flash calls of the two decode steps
              after it shadowed by their plain versions; the time of one
              shift of a full 1024-position slot; then bf16 over slots of
              1024 with one request of a 1000-token prompt and 32 tokens,
              shifted after 19 (the same checks, the decode kernels reading
              up to 1024 keys)
11. slots   — the same engine served with the prefix cache on and
              ``SLOT_SAVE_PATH`` in a temporary directory: a prompt of about
              100 tokens cold, again from its kept slot, that slot saved,
              erased and restored, the prompt once more through
              ``/completion`` (the second run's tokens from the restored
              rows; ``t_save_ms``, ``t_restore_ms``, the file's bytes), and
              ``/props``, ``/tokenize``, ``/detokenize``, ``/apply-template``,
              ``GET /slots`` and ``/infill`` (from the GGUF's FIM tokens)
              each answering with its checked shape
12. serve-paged — a second engine from the environment, sharing the first
              one's weights (``build_engine_from_env``: q8_0 paged KV, 4 pages
              of 1024; its ``load_s`` builds the engine, not the weights): a
              1,500-token prompt, longer than a slot's contiguous share, with
              three short ones; the pool cannot hold all four, so one waits;
              the prompts' chunks through the paged q8_0 tensor-core flash
              kernel (the long prompt's time to its first token printed)
13. q2k     — both engines freed, the 8B Q2_K GGUF (Q2_K embedding and
              projections, Q6_K head; ``cached_model(quant="q2_k")``) loaded
              under ``LGT_SCALE_LAYOUT=mixed``, its resident weight bytes
              printed; a prefill and 16 greedy steps through the kernels
              held against the plain versions fed the same tokens, then the
              port's OpenAI server over it as in the serve phase, and one
              512-token prefill chunk as in the forward phase, through the
              2-bit tensor-core kernel; then
              ``LGT_MM_VARIANT=base``: two steps on the mixed weights (the
              dequantize path, as in the JAX package), and the 17 steps with
              the weights relaid flat through the base body's 2-bit kernel,
              then one 512-token chunk through its tensor-core kernel
14. q5k     — that engine freed, the 8B Q5_K GGUF (Q5_K embedding and
              projections, Q6_K head; ``cached_model(quant="q5_k")``) under
              the default layout (compact), its resident bytes printed, the
              17 steps of a longer prompt against the plain versions (its
              prefill through the tensor-core kernel), then served; then one
              512-token prefill
              chunk whose launches show the dispatch (qkv, o and gate_up
              through the tensor-core kernel, ffn_down through the
              dequantize path, as the JAX package's gate sends it to
              ``matmul_xla``) and whose logits are held against the plain
              versions, and the served time to the first token of a prompt
              of at most 512 tokens
15. lora    — that engine freed, the 8b widths at 2 layers (Q4_K_M,
              ``cached_model(n_layers=2)``) loaded with a rank-16 adapter on
              all seven projections and the head (``tools.synth.synth_lora``;
              every projection unfused, its quantized base on its kernels)
              and loaded dense (``mode="dense"``, bf16; its 512-token chunk
              held against the quantized bases' without the adapter), then
              with the adapter merged in f32, the oracle: a
              512-token prefill chunk and 4 greedy decode steps at B = 4,
              every 2/4-bit and 8-bit call shadowed by its plain version, the
              logits within LOGITS_TOL of the oracle's; each projection's
              base and adapted call timed at 4 and 512 rows
16. gemma3  — that engine freed, the Gemma-3-12B shape at full width and
              depth (``cached_model("gemma3-12b")``: 48 layers of 3840, 16
              heads over 8 of 256, ffn 15360, vocab 262208, a window of 1024
              on five layers of six, Q4_K projections, the head tied to the
              Q6_K embedding) loaded cold, served from 4 slots of 4096: a
              prompt of about 2000 tokens prefilled in chunks of 512 and 32
              greedy steps, the split flash kernel launched on the 8 global
              layers only (the sliding ones through ``masked_attention``),
              the first and last chunk's and 4 steps' logits against the
              plain versions; a chat, EOG banned, through the server;
              gate+up at 4 and 512 rows, the head at 4, flash at head_dim
              256 (decode, and a 512-token chunk from offset 1024), each
              timed beside its plain version, its bound and the library
17. iq      — each grid-codebook format's 8B ffn_gate repacked from
              synthesized bytes (IQ2_XXS and IQ3_S also packed4), held
              against the plain versions at 4 and 512 rows and timed; then
              the 8b widths at 2 layers with IQ2_XXS projections
              (``cached_model(quant="iq2_xxs", n_layers=2)``), 17 greedy
              steps against the plain path, every 8-bit call shadowed
18. the ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line

Launch counters are set to 0 just before each path that drives the kernels
(the embeddings and encoder phases' served requests, the Q4_K_M 512-token chunk and long-prompt serve, each kv-forward kernel
run and engine run, the serve phase, the decode-dispatch phase's two served
runs, the structured phase's two served runs, each variant's
kernel run and serve, each ctx-shift run (its shadowed calls' plain
launches taken back out), the slots phase, the serve-paged phase, the q2k
phase's kernel run,
serve, 512-token chunk, flat base run and base chunk, the base, xsum, split
and int8 variants' chunks, the q5k phase's kernel run, serve, 512-token
chunk and long-prompt serve, the lora phase's chunk and decode steps, the
gemma3 phase's kernel run and chat, the iq phase's 17 steps) and read just
after; comparison runs fall outside those windows.

Every engine but the structured phase's second and the slots phase's is
built with the slot prefix cache off, so a phase that sends one prompt twice times and counts
two cold prefills, as it did before the port had the cache.

The breakdown of a decode step and a prefill chunk by kernel is
``python -m llama_gguf_inference_tpu_torch.tools.profile``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import http.client
import json
import os
import re
import secrets
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
INT8_OPS = 1979e12             # H100 SXM data sheet, dense int8
# a matmul kernel against its plain version, of the output's scale: the same
# bf16 weights (int8: exact int32 dots) summed in another f32 order; the
# 2/4-bit and int8 wgmma kernels also take the min term as products of split
# bf16 parts, and the int8 one rounds xs to 22 significant bits
MATMUL_TOL = 1e-4
FLASH_TOL = 2 * 2 ** -8        # two bf16 ulps of the output scale
LOGITS_TOL = 0.05              # 8B forward: kernel vs plain, of max |logit|
# LGT_MM_VARIANT=int8 forward, kernel vs plain. Its activations are quantized
# to int8 per sub-block while the min term takes their exact block sums, so a
# difference of one f32 rounding that flips one activation code moves the
# output by a step the min term does not cancel, and the two runs drift apart
# layer by layer (measured 2-12% of the logits' scale by 2 to 32 layers,
# against 0.4-1.8% for fsplit; one 17-step run reached 23%). The strict check
# is the shadow one: every call of the run, kernel against plain version on
# the same inputs, within MATMUL_TOL.
INT8_LOGITS_TOL = 0.5
SHAPES_4BIT = {"qkv": (6144, 4096), "o": (4096, 4096),
               "gate_up": (28672, 4096), "down": (4096, 14336)}
SHAPES_2BIT = SHAPES_4BIT      # the same projections, all Q2_K in the Q2_K model
HEAD = (128256, 4096)
PAGE_S = 256                   # kernels and kv-forward phases' paged caches
KV_KINDS = {                   # cache kind: (kv_dtype, kv_layout, its attention kernel)
    "q8_0": ("q8_0", "contig", "flash_attention_q8"),
    "q4_0": ("q4_0", "contig", "flash_attention_q4"),
    "q4_1": ("q4_1", "contig", "flash_attention_q41"),
    "paged": ("bf16", "paged", "flash_attention_paged"),
    "paged_q8_0": ("q8_0", "paged", "flash_attention_paged_q8")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


class Timer:
    """Median time of single launches, L2 flushed before each (decode finds
    its weights cold), measured with CUDA events. The flush writes 1 GiB
    (about 0.3 ms of the card's time), which also keeps the card busy while
    the host runs the wrapper's Python and enqueues the timed launch, so
    the start event does not wait on the host."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    emit({"phase": "device", "ok": True, "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def phase_build():
    from llama_gguf_inference_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build_all()
    regs = {name: [ln.split("info    : ")[-1] for ln in rep.splitlines()
                   if "registers" in ln] for name, rep in reports.items()}
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 3),
          "ptxas": regs})
    return reports


# the 8-bit decode kernel's launch at each 8B shape it serves, B=4: (label,
# projection, sub-block size, scale side, min side), the sides as the
# kernel's Side codes (0 none, 1 flat, 2 compact u8, 3 compact i8)
PLANS_8BIT = [(f"q5_k {lay} {name}", name, 32, side, side)
              for lay, side in (("compact", 2), ("flat", 1)) for name in SHAPES_4BIT]
PLANS_8BIT += [(f"q8_0 flat {name}", name, 32, 1, 0) for name in SHAPES_4BIT]
PLANS_8BIT += [("q6_k head", "head", 16, 3, 0), ("q6_k down", "down", 16, 3, 0)]


# the int8 decode kernel's launch at the 8B shapes of the int8 body, B=4:
# (label, projection, sub-block size, scale side, min side)
PLANS_INT8 = [(f"q4_k {lay} {name}", name, 32, side, side)
              for lay, side in (("flat", 1), ("compact", 2)) for name in SHAPES_4BIT]
PLANS_INT8 += [("q4_0 flat o", "o", 32, 1, 0), ("q3_k flat o", "o", 16, 1, 0)]


# the 2/4-bit decode kernel's launch (fsplit rule) at the 8B shapes of the
# served formats, B=4: (label, projection, bits, sub-block size, scale
# side, min side)
PLANS_LOWBIT = [(f"q4_k {lay} {name}", name, 4, 32, side, side)
                for lay, side in (("flat", 1), ("compact", 2)) for name in SHAPES_4BIT]
PLANS_LOWBIT += [(f"q2_k {lay} {name}", name, 2, 16, s_side, m_side)
                 for lay, s_side, m_side in (("flat", 1, 1), ("mixed", 1, 2), ("compact", 2, 2))
                 for name in SHAPES_2BIT]
PLANS_LOWBIT += [(f"q3_k flat {name}", name, 4, 16, 1, 0) for name in ("o", "down")]

# the 2/4-bit tensor-core kernel's launch at the 8B shapes of the served
# layouts (fsplit), at B = 32 and 512: (label, projection, bits, sub-block
# size, scale side, min side)
PLANS_LOWBIT_TC = [(f"q4_k flat {name}", name, 4, 32, 1, 1) for name in ("qkv", "o", "gate_up")]
PLANS_LOWBIT_TC += [(f"q2_k mixed {name}", name, 2, 16, 1, 2) for name in ("qkv", "o", "gate_up")]

# the int8 tensor-core kernel's launch at the 8B shapes of its 512-token
# chunk (Q4_K flat) and at Q3_K's o, at B = INT8_TC_MIN_ROWS and 512:
# (label, projection, sub-block size, scale side, min side)
PLANS_INT8_TC = [(f"q4_k flat {name}", name, 32, 1, 1) for name in ("qkv", "o", "gate_up")]
PLANS_INT8_TC += [("q3_k flat o", "o", 16, 1, 0)]

# the 8-bit tensor-core kernel's launch at the 8B shapes of the Q5_K chunk
# (compact) and at the Q6_K head, at B = TC_MIN_ROWS and 512: (label,
# projection, sub-block size, scale side, min side)
PLANS_8BIT_TC = [(f"q5_k compact {name}", name, 32, 2, 2) for name in ("qkv", "o", "gate_up")]
PLANS_8BIT_TC += [("q6_k head", "head", 16, 3, 0)]


def _ptxas(report: str, kernel: str) -> dict:
    """Template arguments -> registers and spill bytes of each instance of
    ``kernel``, from ptxas's -v report (the arguments as the mangled name
    gives them, bools as 0 and 1)."""
    out = {}
    for entry in report.split("Compiling entry function")[1:]:
        head = entry.split("'")[1] if "'" in entry else ""
        if kernel + "I" not in head:
            continue
        targs = tuple(int(v) for v in re.findall(r"L[ib](\d+)E", head.split(kernel + "I")[1]))

        def num(pattern):
            return int(re.search(pattern, entry).group(1))
        out[targs] = {"ptxas_registers": num(r"Used (\d+) registers"),
                      "spill_stores": num(r"(\d+) bytes spill stores"),
                      "spill_loads": num(r"(\d+) bytes spill loads")}
    return out


def _plan_line(plan_fn, B, in_f, out_f, nsub, s_side, m_side, n, label):
    """One launch plan as the kernel's plan entry point reports it into
    int[n] (the int8 one's eighth value is the instance; the 2/4-bit
    tensor-core one's eighth the activation rows a tile, its ninth the ns
    the host takes to build the launch's tensor maps)."""
    import ctypes

    from llama_gguf_inference_tpu_torch.ops import _build
    info = (ctypes.c_int * n)()
    _build.check(plan_fn(B, in_f, out_f, nsub, s_side, m_side, info), label)
    gx, gy, threads, smem, regs, local, per_sm = list(info)[:7]
    line = {"shape": f"{label} {out_f}x{in_f} B={B}", "grid": [gx, gy], "threads": threads,
            "smem_bytes": smem, "registers": regs, "local_bytes": local,
            "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32}
    if n > 7:
        line["instance"] = info[7]
    if n > 8:
        line["tensor_maps_host_us"] = info[8] / 1e3
    return line


def _sass_functions(path: str) -> dict[str, str]:
    """Mangled function name -> its SASS, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return {part.split()[0]: part for part in out.split("Function : ")[1:]}


def _tc_instances(report: str, source: str, kernel: str, gmma: tuple[str, ...]) -> list[dict]:
    """Every instance of the wgmma kernel ``kernel`` of ``csrc/<source>.cu``:
    its template arguments, ptxas's registers and spills, and how many
    instructions of each SASS mnemonic of ``gmma`` (``HGMMA``, bf16 wgmma;
    ``IGMMA``, s8 wgmma) its SASS holds, and whether ptxas reports its
    wgmmas serialized; ``report`` is empty where the
    library was already built, and the source is then compiled again for
    ptxas's report. No instance, an instance without ptxas's registers, a
    spill, an instance without one of ``gmma`` or one whose wgmmas ptxas
    serialized fails the run."""
    from llama_gguf_inference_tpu_torch.ops import _build
    report = report or _build.ptxas_report(source)
    ptxas = _ptxas(report, kernel)
    serialized = [ln for ln in report.splitlines() if "wgmma" in ln and "serialized" in ln]
    out = []
    for name, sass in _sass_functions(_build._lib_path(source)).items():
        if kernel + "I" not in name:
            continue
        targs = tuple(int(v) for v in re.findall(r"L[ib](\d+)E", name.split(kernel + "I")[1]))
        counts = {op.lower(): len(re.findall(rf"\b{op}\b", sass)) for op in gmma}
        out.append({"instance": list(targs), **counts, **ptxas.get(targs, {}),
                    "wgmma_serialized": any(name in ln for ln in serialized)})
    bad = [i for i in out if not all(i[op.lower()] for op in gmma) or i.get("spill_stores", 0)
           or i.get("spill_loads", 0) or "ptxas_registers" not in i or i["wgmma_serialized"]]
    if not out or bad:
        raise AssertionError(f"{source} instances without {gmma} or spilling: {bad}")
    return out


def phase_plans(torch, reports: dict) -> None:
    """One line: the 8-bit, int8 and 2/4-bit decode kernels' grid, block,
    registers, spills and resident blocks at each 8B shape (B=4; int8: and
    the instance, 0 for sub 32 on m16n8k32, 1 for m16n8k16; 2/4-bit: 0 for
    steps of 16 sub-blocks, 1 of 32, 2 the generic instance), from each
    kernel's own launch plan (cudaFuncGetAttributes, the occupancy
    calculator) and ptxas's report; the 2/4-bit tensor-core kernel's launch
    at the served layouts' 8B shapes for 32 and 512 rows (its instance the
    activation rows a tile; its registers those at entry, before
    setmaxnreg), and each of its instances' registers, spills and HGMMA
    (:func:`_tc_instances`). A spill, or a tensor-core instance without
    HGMMA, fails the run; the int8 tensor-core kernel's the same at
    INT8_TC_MIN_ROWS and 512 rows, its instances' registers, spills and
    IGMMA and HGMMA counts; the 8-bit tensor-core kernel's at TC_MIN_ROWS
    and 512 rows, its instances' registers, spills and HGMMA counts; the
    tensor-core flash kernel's 12 instances' the same. A serialized wgmma
    fails the run too."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    report = reports["quant_matmul"]
    lib = _build.library("quant_matmul")
    ptxas8 = _ptxas(report, "quant_matmul_8bit_kernel")
    ptxas_i8 = _ptxas(report, "quant_matmul_int8_kernel")
    ptxas_lb = {inst: _ptxas(report, kernel) for inst, kernel in
                ((0, "quant_matmul_lowbit_kernel"), (2, "quant_matmul_lowbit_generic"))}
    plans, plans_i8, plans_lb = [], [], []
    for label, name, sub, s_side, m_side in PLANS_8BIT:
        out_f, in_f = HEAD if name == "head" else SHAPES_4BIT[name]
        plans.append(_plan_line(lib.lgt_quant_matmul_8bit_plan, 4, in_f, out_f, in_f // sub,
                                s_side, m_side, 7, label))
        plans[-1].update(ptxas8.get((s_side, m_side), {}))
    for label, name, sub, s_side, m_side in PLANS_INT8:
        out_f, in_f = SHAPES_4BIT[name]
        line = _plan_line(lib.lgt_quant_matmul_int8_plan, 4, in_f, out_f, in_f // sub,
                          s_side, m_side, 8, label)
        # the instance's template arguments: sides, sub 32 on m16n8k32, sub-blocks a step
        inst = line["instance"]
        line.update(ptxas_i8.get((s_side, m_side, int(inst == 0), 4 if inst == 2 else 16), {}))
        plans_i8.append(line)
    for label, name, bits, sub, s_side, m_side in PLANS_LOWBIT:
        out_f, in_f = (SHAPES_4BIT if bits == 4 else SHAPES_2BIT)[name]

        def plan_fn(*args, bits=bits):
            return lib.lgt_quant_matmul_lowbit_plan(*args[:6], bits, qm.VAR_FSPLIT, 0, args[6])
        line = _plan_line(plan_fn, 4, in_f, out_f, in_f // sub, s_side, m_side, 8, label)
        # the instance's template arguments: bits, rule, code map, sides
        line.update(ptxas_lb[2 if line["instance"] == 2 else 0].get(
            (bits, qm.VAR_FSPLIT, 0, s_side, m_side), {}))
        plans_lb.append(line)
    tc_lib = _build.library("quant_matmul_lowbit_tc")
    plans_tc = []
    for label, name, bits, sub, s_side, m_side in PLANS_LOWBIT_TC:
        out_f, in_f = SHAPES_4BIT[name]
        for B in (32, 512):

            def plan_fn(*args, bits=bits):
                return tc_lib.lgt_quant_matmul_lowbit_tc_plan(*args[:6], bits, qm.VAR_FSPLIT, 0,
                                                              args[6])
            plans_tc.append(_plan_line(plan_fn, B, in_f, out_f, in_f // sub, s_side, m_side, 9,
                                       label))
    i8_lib = _build.library("quant_matmul_int8_tc")
    plans_i8tc = [_plan_line(i8_lib.lgt_quant_matmul_int8_tc_plan, B, SHAPES_4BIT[name][1],
                             SHAPES_4BIT[name][0], SHAPES_4BIT[name][1] // sub, s_side, m_side,
                             9, label)
                  for label, name, sub, s_side, m_side in PLANS_INT8_TC
                  for B in (qm.INT8_TC_MIN_ROWS, 512)]
    t8_lib = _build.library("quant_matmul_tc")
    plans_t8 = [_plan_line(t8_lib.lgt_quant_matmul_8bit_tc_plan, B, in_f, out_f, in_f // sub,
                           s_side, m_side, 9, label)
                for label, name, sub, s_side, m_side in PLANS_8BIT_TC
                for out_f, in_f in [HEAD if name == "head" else SHAPES_4BIT[name]]
                for B in (qm.TC_MIN_ROWS, 512)]
    for line in plans + plans_i8 + plans_lb + plans_tc + plans_i8tc + plans_t8:
        if line["local_bytes"] or line.get("spill_stores", 0):
            raise AssertionError(f"kernel spills: {line}")
    # the four libraries' instances: cuobjdump (and, where a library was
    # already built, ptxas) runs for each at once
    tc = {"quant_matmul_lowbit_tc": ("quant_matmul_lowbit_tc_kernel", ("HGMMA",)),
          "quant_matmul_int8_tc": ("quant_matmul_int8_tc_kernel", ("IGMMA", "HGMMA")),
          "quant_matmul_8bit_tc": ("quant_matmul_8bit_tc_kernel", ("HGMMA",)),
          "flash_attention_tc": ("flash_attention_tc_kernel", ("HGMMA",))}
    sources = {"quant_matmul_8bit_tc": "quant_matmul_tc"}
    with concurrent.futures.ThreadPoolExecutor(len(tc)) as pool:
        insts = {key: pool.submit(_tc_instances, reports[sources.get(key, key)],
                                  sources.get(key, key), kernel, gmma)
                 for key, (kernel, gmma) in tc.items()}
        insts = {key + "_instances": f.result() for key, f in insts.items()}
    emit({"phase": "plans", "quant_matmul_8bit": plans, "quant_matmul_4bit_int8": plans_i8,
          "quant_matmul_lowbit": plans_lb, "quant_matmul_lowbit_tc": plans_tc,
          "quant_matmul_int8_tc": plans_i8tc, "quant_matmul_8bit_tc": plans_t8, **insts})


def _err(got, want, tol):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item() + 1e-12
    if not d <= tol * scale:
        raise AssertionError(f"max abs err {d} > {tol} * {scale}")
    return d, d / scale


def phase_kernels(torch, timer):
    import torch.nn.functional as F

    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # 4-bit, flat Q4_K layout: codes (out, in/2) u8, d and m (out, in/32) f32
    for name, (out_f, in_f) in SHAPES_4BIT.items():
        nsub = in_f // 32
        codes = torch.randint(0, 256, (out_f, in_f // 2), generator=g,
                              device="cuda", dtype=torch.uint8)
        d = rand(out_f, nsub, scale=1e-2).abs()
        m = rand(out_f, nsub, scale=5e-2).abs()
        h = in_f // 2
        c = codes.to(torch.int32)
        sh, mh = d.repeat(1, h // nsub), m.repeat(1, h // nsub)
        w_lib = torch.cat([(c & 15).float() * sh - mh, (c >> 4).float() * sh - mh],
                          1).bfloat16()
        del c, sh, mh
        for B in (1, 4, 512):
            x = rand(B, in_f).bfloat16()
            xsum = qm._block_sums(x, 32)
            args = (x, xsum, codes, d, None, m, None, 0)
            got = qm.quant_matmul_4bit(*args)
            want = qm.quant_matmul_4bit_plain(*args)
            err, rel = _err(got, want, MATMUL_TOL)
            nbytes = codes.numel() + 8 * out_f * nsub + B * in_f * 2 \
                + B * nsub * 4 + B * out_f * 4
            b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
            rows.append({"kernel": _lowbit_name(qm, 4, B, in_f, nsub, nsub, nsub),
                         "shape": f"{name} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "ms": timer(lambda: qm.quant_matmul_4bit(*args)),
                         "plain_ms": timer(lambda: qm.quant_matmul_4bit_plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", **rows[-1]})
        del w_lib, codes

    # 8-bit, compact Q6_K head: codes (out, in) int8, d (out, in/256) f32,
    # sc (out, in/16) int8
    out_f, in_f = HEAD
    codes = torch.randint(-32, 32, (out_f, in_f), generator=g, device="cuda",
                          dtype=torch.int8)
    d = rand(out_f, in_f // 256, scale=1e-3).abs()
    sc = torch.randint(-128, 128, (out_f, in_f // 16), generator=g,
                       device="cuda", dtype=torch.int8)
    s_sub = d.repeat(1, 16) * sc.float()
    w_lib = (codes.float() * s_sub.repeat(1, 16)).bfloat16()
    del s_sub
    for B in (1, 4, 64):
        x = rand(B, in_f).bfloat16()
        args = (x, codes, d, sc, 16, 0)
        got = qm.quant_matmul_8bit(*args)
        want = qm.quant_matmul_8bit_plain(*args)
        err, rel = _err(got, want, MATMUL_TOL)
        nbytes = codes.numel() + sc.numel() + d.numel() * 4 + B * in_f * 2 + B * out_f * 4
        b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
        ms = timer(lambda: qm.quant_matmul_8bit(*args))
        rows.append({"kernel": _8bit_name(qm, B, in_f, 16, False),
                     "shape": f"head {out_f}x{in_f} B={B}",
                     "B": B, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": timer(lambda: qm.quant_matmul_8bit_plain(*args), 5),
                     "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                     "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
        emit({"phase": "kernels", **rows[-1]})
    del w_lib, codes, sc

    rows += _lowbit_rows(torch, qm, g, timer)
    rows += _lowbit_tc_rows(torch, qm, g, timer)
    rows += _variant_rows(torch, qm, g, timer)
    rows += _variant_tc_rows(torch, qm, g, timer)
    rows += _attention_rows(torch, F, fa, rand, g, timer)
    return rows


def _lowbit_name(qm, bits, B, in_f, nsub, nd, ndm):
    """The launch name of the 2/4-bit kernel the dispatching wrapper runs."""
    tc = B >= qm.LOWBIT_TC_MIN_ROWS and qm.lowbit_tc_takes(bits, in_f, nsub, nd, ndm)
    return [[qm.NAME_2BIT, qm.NAME_4BIT], [qm.NAME_2BIT_TC, qm.NAME_4BIT_TC]][tc][bits == 4]


def _8bit_name(qm, B, in_f, sub, has_min):
    """The launch name of the 8-bit kernel the dispatching wrapper runs."""
    tc = B >= qm.TC_MIN_ROWS and qm.tc_takes(in_f, sub)
    return [[qm.NAME_8BIT, qm.NAME_8BIT_MIN], [qm.NAME_8BIT_TC, qm.NAME_8BIT_MIN_TC]][tc][has_min]


# weight geometry of each format the kernel rows draw: (bits, sub-block size,
# code bias, has a min side, sub-block scale signed)
FORMATS = {"q2_k": (2, 16, 0, True, False), "q3_k": (4, 16, 4, False, True),
           "q4_k": (4, 32, 0, True, False), "q4_0": (4, 32, 8, False, False),
           "q4_1": (4, 32, 0, True, False), "iq2_xs": (4, 32, 0, False, False),
           "iq3_s": (4, 32, 0, False, False), "q5_k": (8, 32, 0, True, False),
           "q5_1": (8, 32, 0, True, False), "q8_0": (8, 32, 0, False, False)}


def _weight(torch, g, fmt, out_f, in_f, layout):
    """A random QuantLinear of ``fmt``'s geometry in one scale layout: flat
    (f32 per sub-block), compact (f32 per 256 times an 8-bit factor per
    sub-block) or mixed (the scale flat, the min side compact)."""
    from llama_gguf_inference_tpu_torch.ops.linear import QuantLinear
    bits, sub, bias, has_min, signed_sc = FORMATS[fmt]
    nsub, nd = in_f // sub, in_f // 256

    def f32(n, scale):
        return torch.rand(out_f, n, generator=g, device="cuda") * scale + scale / 10

    def u8(lo):
        t = torch.randint(lo, lo + 16, (out_f, nsub), generator=g, device="cuda",
                          dtype=torch.int32)
        return t.to(torch.int8 if lo < 0 else torch.uint8)

    if bits == 8:   # 5-bit codes widened to int8, as Q5_K and Q5_1 repack; Q8_0's int8
        lo, hi = (-128, 128) if fmt == "q8_0" else (0, 32)
        codes = torch.randint(lo, hi, (out_f, in_f), generator=g, device="cuda",
                              dtype=torch.int8)
    else:
        codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, device="cuda",
                              dtype=torch.uint8)
    d = f32(nsub, 1e-2) if layout != "compact" else f32(nd, 1e-3)
    sc = u8(-8 if signed_sc else 0) if layout == "compact" else None
    dmin = mn = None
    if has_min:
        dmin = f32(nsub, 5e-2) if layout == "flat" else f32(nd, 5e-3)
        mn = None if layout == "flat" else u8(0)
    return QuantLinear(codes=codes, d=d, sc=sc, dmin=dmin, mn=mn, fmt=fmt,
                       bits=bits, sub_size=sub, d_size=256 if layout == "compact" else sub,
                       code_bias=bias, out_features=out_f, in_features=in_f,
                       min_size=256 if layout == "mixed" else 0)


def _wbytes(w) -> int:
    return sum(a.numel() * a.element_size() for a in (w.codes, w.d, w.sc, w.dmin, w.mn)
               if a is not None)


def _lowbit_rows(torch, qm, g, timer):
    """The 2-bit kernel at the Q2_K projections (flat and mixed at 1, 4 and
    512 rows, compact at 4) and the 4-bit kernel at its new geometries (Q3_K
    at o and down, Q4_K compact and mixed at gate_up, 4 rows). The bound's
    bytes count the codes and each layout's scale and min arrays as stored;
    the library call multiplies by the same weights dequantized to bf16
    ahead of time."""
    cases = []
    for name, (out_f, in_f) in SHAPES_2BIT.items():
        for layout, bs in (("flat", (1, 4, 512)), ("mixed", (1, 4, 512)), ("compact", (4,))):
            cases.append(("q2_k", f"{layout} {name}", out_f, in_f, layout, bs))
    for name in ("o", "down"):
        out_f, in_f = SHAPES_4BIT[name]
        cases.append(("q3_k", f"q3_k {name}", out_f, in_f, "flat", (1, 4)))
    for layout in ("compact", "mixed"):
        out_f, in_f = SHAPES_4BIT["gate_up"]
        cases.append(("q4_k", f"q4_k {layout} gate_up", out_f, in_f, layout, (4,)))
    rows = []
    for fmt, label, out_f, in_f, layout, bs in cases:
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        bits, sub, bias = w.bits, w.sub_size, w.code_bias
        kernel, plain = ((qm.quant_matmul_2bit, qm.quant_matmul_2bit_plain) if bits == 2 else
                         (qm.quant_matmul_4bit, qm.quant_matmul_4bit_plain))
        w_lib = w.dequantize_bm()
        arrays = [w.codes, w.d, w.sc, w.dmin, w.mn]
        wbytes = _wbytes(w)
        nsub = in_f // sub
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            xsum = qm._block_sums(x, sub)
            if layout == "mixed":
                xsum = qm._mixed_xsum(xsum, w)
            args = (x, xsum, *arrays, bias)
            err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
            nbytes = wbytes + B * in_f * 2 + B * nsub * 4 + B * out_f * 4
            b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
            rows.append({"kernel": _lowbit_name(qm, bits, B, in_f, nsub, w.d.shape[1],
                                                (w.d if w.dmin is None else w.dmin).shape[1]),
                         "shape": f"{label} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "bits_per_weight": 8 * wbytes / (out_f * in_f),
                         "ms": timer(lambda: kernel(*args)),
                         "plain_ms": timer(lambda: plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", **rows[-1]})
        del w, w_lib, arrays
    return rows


def _host_us(torch, fn, n: int = 50) -> float:
    """Mean host microseconds of one call of ``fn`` (a wrapper that
    enqueues its kernel and returns), over ``n`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def _lowbit_tc_rows(torch, qm, g, timer):
    """The 2- and 4-bit tensor-core kernels through their own wrappers, each
    beside the decode kernel on the same inputs (``decode_ms``): Q4_K flat,
    compact and mixed and Q2_K flat, mixed and compact at the four
    projections, Q3_K at o and down, the IQ2/IQ3 maps at o, for 16, 64, 300
    and 512 rows; the served layouts (Q4_K flat, Q2_K mixed) also at 8, 24,
    32 and 48, where the two kernels cross, and at 16 and 512 rows with
    the host's time for one call of the wrapper (``host_us``). Bound and
    library call as in :func:`_lowbit_rows`."""
    cases = []
    for fmt, layouts in (("q4_k", ("flat", "compact", "mixed")),
                         ("q2_k", ("mixed", "flat", "compact"))):
        for layout in layouts:
            for name in SHAPES_4BIT:
                served = layout == ("flat" if fmt == "q4_k" else "mixed")
                cases.append((fmt, layout, name, (8, 16, 24, 32, 48, 64, 300, 512) if served
                              else (16, 64, 300, 512)))
    cases += [("q3_k", "flat", name, (16, 64, 300, 512)) for name in ("o", "down")]
    cases += [(fmt, "flat", "o", (16, 64, 300, 512)) for fmt in ("iq2_xs", "iq3_s")]
    rows = []
    for fmt, layout, name, bs in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        bits, sub = w.bits, w.sub_size
        kname = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
        kernel = getattr(qm, f"quant_matmul_{bits}bit_tc")
        decode = getattr(qm, f"quant_matmul_{bits}bit_decode")
        plain = getattr(qm, f"quant_matmul_{bits}bit_plain")
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        nsub = in_f // sub
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            xsum = qm._block_sums(x, sub)
            if layout == "mixed":
                xsum = qm._mixed_xsum(xsum, w)
            args = (x, xsum, w.codes, w.d, w.sc, w.dmin, w.mn, w.code_bias, w.fmt)
            err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
            b_ms, b_by = bound(wbytes + B * in_f * 2 + B * nsub * 4 + B * out_f * 4,
                               2.0 * B * in_f * out_f)
            ms = timer(lambda: kernel(*args))
            host = {"host_us": _host_us(torch, lambda: kernel(*args))} \
                if (fmt, layout) in (("q4_k", "flat"), ("q2_k", "mixed")) and B in (16, 512) \
                else {}
            rows.append({"kernel": kname, "shape": f"{fmt} {layout} tc {name} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                         "decode_ms": timer(lambda: decode(*args), 5 if B > 64 else 20),
                         "plain_ms": timer(lambda: plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms, **host})
            emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


VARIANTS = ("base", "xsum", "split", "int8")


def _variant_call(qm, w, variant, x):
    """(kernel name, kernel, its args, plain version, its args, activation
    bytes read, int8 operations) of one body on weight ``w`` and bf16
    activations ``x`` (B, in), the arguments built as the dispatcher builds
    them."""
    arrs = (w.codes, w.d, w.sc, w.dmin, w.mn)
    B, in_f = x.shape
    nsub = in_f // w.sub_size
    xsum = qm._block_sums(x, w.sub_size)
    x_bytes = B * in_f * 2 + B * nsub * 4
    if variant.startswith("8bit"):
        # 8bit: the dispatching wrapper; 8bit_decode, 8bit_tc: one kernel
        args = (x, w.codes, w.d, w.sc, w.sub_size, w.code_bias, w.dmin, w.mn)
        nrows = {"8bit": B, "8bit_decode": 0, "8bit_tc": qm.TC_MIN_ROWS}[variant]
        fn = {"8bit": qm.quant_matmul_8bit, "8bit_decode": qm.quant_matmul_8bit_decode,
              "8bit_tc": qm.quant_matmul_8bit_tc}[variant]
        return _8bit_name(qm, nrows, in_f, w.sub_size, w.dmin is not None), fn, args, \
            qm.quant_matmul_8bit_plain, args, B * in_f * 2, False
    nd = w.d.shape[1]
    # int8, base: the dispatching wrapper; int8_decode, base_decode: the
    # decode kernel; int8_tc, base_tc: the tensor-core kernel
    kind = variant.split("_")[1] if "_" in variant else ""
    if variant.startswith("int8"):
        xq, xs = qm.quantize_acts(x, w.sub_size)
        args = (xq, xs, xsum, *arrs, w.code_bias)
        tc = kind == "tc" or (not kind and B >= qm.INT8_TC_MIN_ROWS
                              and qm.int8_tc_takes(in_f, nsub, nd, w.sub_size))
        fn = getattr(qm, "quant_matmul_4bit_int8" + (f"_{kind}" if kind else ""))
        return qm.NAME_4BIT_INT8_TC if tc else qm.NAME_4BIT_INT8, fn, args, \
            qm.quant_matmul_4bit_int8_plain, args, B * in_f + 2 * B * nsub * 4, True
    tc = kind == "tc" or (not kind and B >= qm.LOWBIT_TC_MIN_ROWS
                          and qm.lowbit_tc_takes(w.bits, in_f, nsub, nd, nd))
    if variant.startswith("base") and w.bits == 4 and w.fmt not in qm.MAPPED_FMTS:
        args = (x, *arrs, w.code_bias)
        fn = getattr(qm, "quant_matmul_4bit_base" + (f"_{kind}" if kind else ""))
        return qm.NAME_4BIT_BASE_TC if tc else qm.NAME_4BIT_BASE, fn, args, \
            qm.quant_matmul_4bit_base_plain, args, B * in_f * 2, False
    if variant.startswith("base"):
        args = (x, *arrs, w.code_bias, w.bits, w.fmt)
        fn = getattr(qm, "quant_matmul_lowbit_base" + (f"_{kind}" if kind else ""))
        return qm.NAME_LOWBIT_BASE_TC if tc else qm.NAME_LOWBIT_BASE, fn, args, \
            qm.quant_matmul_lowbit_base_plain, args, B * in_f * 2, False
    # fsplit, xsum, split: the dispatching wrapper; xsum_decode, xsum_tc,
    # split_decode, split_tc: one kernel
    body = variant.split("_")[0]
    name = {"fsplit": (qm.NAME_4BIT, qm.NAME_4BIT_TC),
            "xsum": (qm.NAME_4BIT_XSUM, qm.NAME_4BIT_XSUM_TC),
            "split": (qm.NAME_4BIT_SPLIT, qm.NAME_4BIT_SPLIT_TC)}[body][tc]
    kernel = getattr(qm, "quant_matmul_4bit" + ("" if body == "fsplit" else f"_{body}")
                     + (f"_{kind}" if kind else ""))
    plain = getattr(qm, "quant_matmul_4bit" + ("" if body == "fsplit" else f"_{body}")
                    + "_plain")
    args = (x, xsum, *arrs, w.code_bias, w.fmt)
    return name, kernel, args, plain, args, x_bytes, False


def _variant_rows(torch, qm, g, timer):
    """The 8-bit kernel's min term and the LGT_MM_VARIANT bodies, each at
    the shapes of its path: the 8-bit kernel with its min term at the Q5_K
    projections (compact, the ``auto`` layout, and flat; B = 1, 4, 512, the
    512 rows through the tensor-core kernel; compact gate_up and qkv at 16,
    64 and 300 too), the decode and tensor-core kernels side by side at the
    compact projections and at Q8_0's flat o for B = 8, 16, 32, 64, Q8_0's flat o through the tensor-core kernel (B = 16, 64, 300,
    512) and Q5_1's flat min at o; the
    4-bit base, xsum, split and int8 kernels at Q4_K flat gate+up and down
    (B = 1, 4, 512) and at Q4_0 (bias 8), Q4_1 (flat min) and Q3_K (sub 16,
    bias 4) at o; the int8 kernel also at Q4_K flat qkv and o (B = 1, 4);
    the base body's f32 branch at Q2_K flat and compact gate+up; the IQ2/IQ3
    value maps through fsplit and base at o (codes drawn at random, no IQ
    repack). The int8 kernel's operations bound is taken at the int8 rate."""
    cases = [("q5_k", layout, name, (1, 4, 512), ("8bit",))
             for layout in ("compact", "flat") for name in SHAPES_4BIT]
    cases += [("q5_k", "compact", name, (16, 64, 300), ("8bit",)) for name in ("gate_up", "qkv")]
    cases += [("q5_k", "compact", name, (8, 16, 32, 64), ("8bit_decode", "8bit_tc"))
              for name in SHAPES_4BIT]
    cases.append(("q8_0", "flat", "o", (16, 64, 300, 512), ("8bit",)))
    cases.append(("q8_0", "flat", "o", (8, 16, 32, 64), ("8bit_decode", "8bit_tc")))
    cases.append(("q5_1", "flat", "o", (4,), ("8bit",)))
    cases += [("q4_k", "flat", name, (1, 4, 512), VARIANTS) for name in ("gate_up", "down")]
    cases += [("q4_k", "flat", name, (1, 4), ("int8",)) for name in ("qkv", "o")]
    cases += [(fmt, "flat", "o", (4,), VARIANTS) for fmt in ("q4_0", "q4_1", "q3_k")]
    cases += [("q2_k", layout, "gate_up", (4,), ("base",)) for layout in ("flat", "compact")]
    cases += [(fmt, "flat", "o", (4,), ("fsplit", "base")) for fmt in ("iq2_xs", "iq3_s")]
    rows = []
    for fmt, layout, name, bs, variants in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            for var in variants:
                kname, kernel, args, plain, pargs, x_bytes, int8 = _variant_call(qm, w, var, x)
                err, rel = _err(kernel(*args), plain(*pargs), MATMUL_TOL)
                b_ms, b_by = bound(wbytes + x_bytes + B * out_f * 4, 2.0 * B * in_f * out_f,
                                   INT8_OPS if int8 else BF16_FLOPS)
                ms = timer(lambda: kernel(*args))
                rows.append({"kernel": kname,
                             "shape": f"{fmt} {layout} {var} {name} {out_f}x{in_f} B={B}",
                             "B": B, "max_abs_err": err, "max_rel_err": rel,
                             "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                             "plain_ms": timer(lambda: plain(*pargs), 5),
                             "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                             "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
                emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


def _variant_tc_rows(torch, qm, g, timer):
    """The tensor-core kernels of the int8 body, of the base rules and of
    the xsum and split bodies through their own wrappers, each beside its
    decode kernel on the same inputs (``decode_ms``): Q4_K flat at the four
    projections for 8, 16, 32, 64, 300 and 512 rows (int8 also 24 and 48; 8 to 64
    rows are where the two kernels cross) and for 16, 64, 300 and 512 (xsum
    and split; at gate+up also 8 and 32, their crossover), Q4_0, Q4_1 and
    Q3_K at o for 16, 64, 300 and 512, and the base_f32 rule at Q2_K flat
    and compact gate+up for 512 rows. Bound as in :func:`_variant_rows`
    (the int8 kernel's operations at the int8 rate)."""
    cases = [("q4_k", "flat", name, (8, 16, 24, 32, 48, 64, 300, 512), ("int8",))
             for name in SHAPES_4BIT]
    cases += [("q4_k", "flat", name, (8, 16, 32, 64, 300, 512), ("base",))
              for name in SHAPES_4BIT]
    cases += [("q4_k", "flat", name, (8, 16, 32, 64, 300, 512) if name == "gate_up"
               else (16, 64, 300, 512), ("xsum", "split")) for name in SHAPES_4BIT]
    cases += [(fmt, "flat", "o", (16, 64, 300, 512), ("int8", "base"))
              for fmt in ("q4_0", "q4_1", "q3_k")]
    cases += [("q2_k", layout, "gate_up", (512,), ("base",)) for layout in ("flat", "compact")]
    rows = []
    for fmt, layout, name, bs, variants in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            for var in variants:
                kname, kernel, args, plain, _, x_bytes, int8 = _variant_call(qm, w, var + "_tc", x)
                decode = _variant_call(qm, w, var + "_decode", x)[1]
                err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
                b_ms, b_by = bound(wbytes + x_bytes + B * out_f * 4, 2.0 * B * in_f * out_f,
                                   INT8_OPS if int8 else BF16_FLOPS)
                ms = timer(lambda: kernel(*args))
                rows.append({"kernel": kname,
                             "shape": f"{fmt} {layout} {var} tc {name} {out_f}x{in_f} B={B}",
                             "B": B, "max_abs_err": err, "max_rel_err": rel,
                             "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                             "decode_ms": timer(lambda: decode(*args), 5 if B > 64 else 20),
                             "plain_ms": timer(lambda: plain(*args), 5),
                             "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                             "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
                emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


# the unsplit decode kernel at the B=4 decode row (PERF.md §6, measured on an
# NVIDIA H100 80GB HBM3 at 700.00 W before the kernel was split), shown
# beside the split kernel's time; that kernel is no longer in the tree
UNSPLIT_DECODE_MS = {"flash_attention": 0.1199, "flash_attention_q8": 0.0970,
                 "flash_attention_q4": 0.0714, "flash_attention_q41": 0.0759,
                 "flash_attention_paged": 0.1282, "flash_attention_paged_q8": 0.1058}


def _attention_rows(torch, F, fa, rand, g, timer):
    """Every flash kernel at decode (T=1: B=4, offsets up to 1000; B=1 at
    offset 1000 over 1024 slots and at 8191 over 8192), at prefill (T=512,
    B=1, offsets 0 and 1024; bf16 and q8_0 also at 7680 over 8192 slots, an
    8K prompt's last chunk) and at T=16, 32 and 64 (B=1, offset 1000: the
    crossover that sets FLASH_TC_MIN_ROWS): H 32 over KVH 8, D 128, 1024
    slots a sequence (more where its keys reach past 1024), contiguous or in
    pages of 256. Above T=1 every entry point runs its tensor-core kernel,
    each row beside the CUDA-core kernel on the same inputs
    (``cuda_core_ms``, its error ``cuda_core_max_abs_err``); the B=4 decode
    rows carry the unsplit kernel's time (``unsplit_ms``)."""
    from llama_gguf_inference_tpu_torch.runtime.kv_cache import QuantKV, QuantKV4, QuantKV41
    H, KVH, D = 32, 8, 128
    rows = []

    def measure(name, label, args, lib_k, lib_v, key_bytes, off, table=None):
        """One row: args[0] is q; lib_k/lib_v the (B, KVH, S, D) bf16 view
        SDPA reads; key_bytes what the kernel's function reads per live key
        and kv head (K and V codes, scales, minimums)."""
        q = args[0]
        B, T = q.shape[:2]
        tc = T > 1
        kernel = getattr(fa, name + "_tc" if tc else name)
        plain = getattr(fa, name + "_plain")
        want = plain(*args)
        err, rel = _err(kernel(*args), want, FLASH_TOL)
        offs = off.tolist()
        live = sum(o + T for o in offs)                       # keys read per kv head
        pairs = sum(o * T + T * (T + 1) // 2 for o in offs)    # (query, key) pairs
        nbytes = live * KVH * key_bytes + 2 * q.numel() * 2 + off.numel() * 4 \
            + (0 if table is None else table.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * H * D * pairs)
        Sl = lib_k.shape[2]
        pos = off.long()[:, None] + torch.arange(T, device="cuda")[None]
        mask = (torch.arange(Sl, device="cuda")[None, None] <= pos[:, :, None])[:, None]
        qt = q.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, lib_k, lib_v, attn_mask=mask,
                                                  enable_gqa=True)
        ms = timer(lambda: kernel(*args))
        row = {"kernel": name + "_tc" if tc else name,
               "shape": f"{label} B={B} T={T} H={H} KVH={KVH} D={D} S={Sl} offsets={offs}",
               "B": B, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
               "plain_ms": timer(lambda: plain(*args), 5), "library_ms": timer(lib),
               "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        if tc:
            dec = getattr(fa, name + "_decode")
            row["cuda_core_max_abs_err"] = _err(dec(*args), want, FLASH_TOL)[0]
            row["cuda_core_ms"] = timer(lambda: dec(*args))
        elif len(offs) >= 4:   # the B=4 decode row (paged: with its idle fifth)
            row["unsplit_ms"] = UNSPLIT_DECODE_MS[name]
        rows.append(row)
        emit({"phase": "kernels", **row})

    for label, B, T, offs in (("decode", 4, 1, [1000, 700, 300, 37]),
                              ("decode", 1, 1, [1000]), ("decode", 1, 1, [8191]),
                              ("prefill", 1, 512, [0]), ("prefill", 1, 512, [1024]),
                              ("prefill", 1, 512, [7680]),
                              ("crossover", 1, 16, [1000]), ("crossover", 1, 32, [1000]),
                              ("crossover", 1, 64, [1000])):
        S = max(1024, -(-(max(offs) + T) // 1024) * 1024)
        NP = S // PAGE_S
        q = rand(B, T, H, D).bfloat16()
        k = rand(B, KVH, S, D).bfloat16()
        v = rand(B, KVH, S, D).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        long_chunk = offs == [7680]   # bf16 and q8_0 only
        measure(fa.NAME, label, (q, k, v, off), k, v, 2 * D * 2, off)
        for name, codec, key_bytes in ((fa.NAME_Q8, QuantKV, 2 * (D + 4)),
                                       (fa.NAME_Q4, QuantKV4, 2 * (D // 2 + 4)),
                                       (fa.NAME_Q41, QuantKV41, 2 * (D // 2 + 8)))[
                                           :1 if long_chunk else 3]:
            kc, vc = codec.quantize(k), codec.quantize(v)
            measure(name, label, (q, *kc, *vc, off), codec.dequantize(*kc),
                    codec.dequantize(*vc), key_bytes, off)
        del k, v
        if long_chunk:
            continue

        # paged: the same sequences plus one idle slot (offset 0, table row
        # all -1), over shuffled pages; a slot maps only the pages it uses
        Bp, P = B + 1, (B + 1) * NP
        qp = rand(Bp, T, H, D).bfloat16()
        offp = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
        table = torch.randperm(P, generator=g, device="cuda").int().reshape(Bp, NP)
        for b, o in enumerate(offs):
            table[b, -(-(o + T) // PAGE_S):] = -1
        table[B] = -1
        kpool = rand(P, KVH, PAGE_S, D).bfloat16()
        vpool = rand(P, KVH, PAGE_S, D).bfloat16()
        measure(fa.NAME_PAGED, label, (qp, kpool, vpool, offp, table),
                fa.gather_pages(kpool, table), fa.gather_pages(vpool, table),
                2 * D * 2, offp, table)
        kc, vc = QuantKV.quantize(kpool), QuantKV.quantize(vpool)
        lib_k, lib_v = (QuantKV.dequantize(fa.gather_pages(c, table), fa.gather_pages(s, table))
                        for c, s in (kc, vc))
        measure(fa.NAME_PAGED_Q8, label, (qp, kc[0], kc[1], vc[0], vc[1], offp, table),
                lib_k, lib_v, 2 * (D + 4), offp, table)
        del kpool, vpool, kc, vc, lib_k, lib_v
    return rows


MATMUL_WRAPPERS = ("quant_matmul_2bit", "quant_matmul_4bit", "quant_matmul_4bit_xsum",
                   "quant_matmul_4bit_split", "quant_matmul_4bit_int8",
                   "quant_matmul_4bit_base", "quant_matmul_lowbit_base", "quant_matmul_8bit")


@contextlib.contextmanager
def plain_versions():
    """Route the model through the plain PyTorch versions (on the card)."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    saved = {n: getattr(qm, n) for n in MATMUL_WRAPPERS}
    saved_fa = fa.flash_attention
    for n in MATMUL_WRAPPERS:
        setattr(qm, n, getattr(qm, n + "_plain"))
    fa.flash_attention = fa.flash_attention_plain
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(qm, n, fn)
        fa.flash_attention = saved_fa


def _tensor_types(path) -> dict[str, int]:
    """The GGUF's tensors counted by their GGML type's name."""
    from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
    r = GGUFReader(path)
    try:
        out: dict[str, int] = {}
        for info in r.tensors.values():
            out[info.ggml_type.name] = out.get(info.ggml_type.name, 0) + 1
        return out
    finally:
        r.close()


def _drop_cache(engine) -> None:
    """Remove the layout cache a load wrote (each run measures cold loads)."""
    d = engine.load_stats.get("layout_cache")
    if d:
        shutil.rmtree(d, ignore_errors=True)


def phase_engine(torch):
    """The cold load: the 8B Q4_K_M GGUF repacked (Q4_K and Q6_K by the
    native library: every such tensor must have been), written to a fresh
    layout cache and shipped by the bulk upload."""
    from llama_gguf_inference_tpu_torch import native
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    t0 = time.time()
    # the FIM tokens rename three filler pieces and add three metadata keys
    # (the slots phase's /infill); every tensor is the same bytes
    path = cached_model("8b", seed=0, fim=True)
    t1 = time.time()
    native.reset_repacks()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024, prefix_cache=False),
                             device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t1
    types = _tensor_types(path)
    want = types.get("Q4_K", 0) + types.get("Q6_K", 0)
    got = sum(native.REPACKS.values())
    stats = engine.load_stats
    if got != want or stats["repacked_native"] != want or stats["cache_hits"]:
        raise AssertionError(f"cold load: {got} native repacks of {want} Q4_K/Q6_K tensors, "
                             f"load_stats {stats}")
    emit({"phase": "load", "ok": True, "synth_s": round(t1 - t0, 3),
          "load_s": round(load_s, 3), "gguf_gb": os.path.getsize(path) / 1e9,
          "device_gb": torch.cuda.memory_allocated() / 1e9,
          "native_repacks": dict(native.REPACKS), "q4k_q6k_tensors": want,
          "load_stats": stats, "layers": engine.cfg.n_layers, "dim": engine.cfg.dim,
          "vocab": engine.cfg.vocab_size})
    return engine


def _tensors_of(torch, node, out):
    """The tensors of a parameter tree in a fixed order."""
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, dict):
        for k in sorted(node):
            _tensors_of(torch, node[k], out)
    elif isinstance(node, list | tuple):
        for v in node:
            _tensors_of(torch, v, out)
    elif hasattr(node, "__dataclass_fields__"):
        for f in node.__dataclass_fields__:
            _tensors_of(torch, getattr(node, f), out)
    return out


def _same(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _fresh_load_memory(path: str) -> None:
    """Run in a fresh process: load ``path`` from its layout cache and print
    ``MEM {...}``: the bytes the load adds to ``memory_allocated()`` and to
    the allocator's requested bytes, and its tensors' bytes."""
    import torch
    from llama_gguf_inference_tpu_torch.runtime import loader
    torch.zeros(1, device="cuda")
    a0 = torch.cuda.memory_allocated()
    r0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    _, params, reader = loader.load_model(path, "cuda", fuse=True)
    reader.close()
    torch.cuda.synchronize()
    print("MEM " + json.dumps({
        "added": torch.cuda.memory_allocated() - a0,
        "requested": torch.cuda.memory_stats()["requested_bytes.all.current"] - r0,
        "resident": _resident_of(torch, params)}), flush=True)


def _resident_of(torch, params) -> int:
    """Bytes of a parameter tree's tensors, each storage once."""
    mine = _tensors_of(torch, params, [])
    return sum(t.numel() * t.element_size() for t in {t.data_ptr(): t for t in mine}.values())


def phase_warm_load(torch, engine):
    """The same file loaded again from its layout cache, in this process:
    every resident tensor equal to the engine's (the cold load's) bit for
    bit; layer 0's projections (fused as the engine fuses them), the
    embedding and the head equal to the per-tensor path's
    (``LGT_UPLOAD=tensor``); the bytes the load asks of the allocator equal
    to its tensors' (no carved view keeps a chunk alive). Then the same load
    in a fresh process, whose allocator starts empty: the bytes it adds to
    ``memory_allocated()`` within 1% of its tensors' (the rest is the
    allocator's rounding of blocks, which in this process depends on what
    earlier phases left in its cache)."""
    from llama_gguf_inference_tpu_torch.runtime import loader
    from llama_gguf_inference_tpu_torch.runtime.layout_cache import LayoutCache
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    t0 = time.time()
    stats: dict = {}
    _, params, reader = loader.load_model(engine.model_path, "cuda", fuse=True, stats=stats)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    added = torch.cuda.memory_allocated() - before
    # the bytes asked for, without the allocator's rounding of blocks
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - requested
    try:
        if not stats["cache_hits"] or stats["repacked_native"] + stats["repacked_numpy"]:
            raise AssertionError(f"warm load repacked: {stats}")
        mine = _tensors_of(torch, params, [])
        theirs = _tensors_of(torch, engine.params, [])
        if len(mine) != len(theirs) or not all(_same(torch, a, b)
                                               for a, b in zip(mine, theirs)):
            raise AssertionError("warm tensors differ from the cold load's")
        resident = _resident_of(torch, params)
        if abs(requested - resident) > 0.01 * resident:
            raise AssertionError(f"warm load asked for {requested} B for {resident} B "
                                 "of tensors")
        cache = LayoutCache.open(engine.model_path)
        os.environ["LGT_UPLOAD"] = "tensor"
        try:
            def per_tensor(name):
                return loader._load_linear(reader, name, torch.device("cuda"), "quant", cache)
            layer = {n: per_tensor(f"blk.0.{n}.weight")
                     for n in ("attn_q", "attn_k", "attn_v", "attn_output",
                               "ffn_gate", "ffn_up", "ffn_down")}
            loader._fuse_layer(layer, engine.cfg)
            pairs = [(layer[k], params["layers"][0][k]) for k in layer]
            pairs += [(per_tensor("token_embd.weight"), params["tok_embd"].table),
                      (per_tensor("output.weight"), params["output"])]
        finally:
            os.environ.pop("LGT_UPLOAD", None)
        for want, got in pairs:
            a, b = _tensors_of(torch, want, []), _tensors_of(torch, got, [])
            if len(a) != len(b) or not all(_same(torch, x, y) for x, y in zip(a, b)):
                raise AssertionError(f"bulk and per-tensor {got.fmt} weights differ")
        probe = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke._fresh_load_memory(sys.argv[1])", engine.model_path],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        line = [ln for ln in probe.stdout.splitlines() if ln.startswith("MEM ")]
        if probe.returncode != 0 or not line:
            raise AssertionError(f"fresh-process load: {probe.returncode}\n"
                                 f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")
        fresh = json.loads(line[0][4:])
        if abs(fresh["added"] - fresh["resident"]) > 0.01 * fresh["resident"] \
                or abs(fresh["requested"] - fresh["resident"]) > 0.001 * fresh["resident"]:
            raise AssertionError(f"fresh-process warm load: {fresh}")
        emit({"phase": "warm-load", "ok": True, "load_s": round(load_s, 3),
              "bulk_gb": stats["bulk_bytes"] / 1e9,
              "gb_per_s": round(stats["bulk_bytes"] / load_s / 1e9, 3),
              "upload_gb_per_s": round(stats["bulk_bytes"] / max(stats["upload_s"], 1e-9) / 1e9,
                                       3),
              "added_gb": added / 1e9, "requested_gb": requested / 1e9,
              "resident_gb": resident / 1e9, "fresh_process": fresh,
              "fresh_over": round(fresh["added"] / fresh["resident"] - 1, 6),
              "tensors_equal": len(mine), "per_tensor_equal": len(pairs),
              "load_stats": stats})
    finally:
        reader.close()
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """``python -m llama_gguf_inference_tpu_torch.serving.openai_server`` on a
    free port with a key of its own, or with ``stack`` the three-process
    ``python -m llama_gguf_inference_tpu_torch serve`` (``launch/start.py``:
    the backend, the health sidecar and the gateway; ports and keys from
    ``env``), as a fresh process with ``env``; its output lines stamped as
    they come."""

    def __init__(self, env: dict, stack: bool = False):
        self.port = self.key = None
        argv = ["llama_gguf_inference_tpu_torch", "serve"]
        if not stack:
            argv = ["llama_gguf_inference_tpu_torch.serving.openai_server"]
            self.port = _free_port()
            self.key = secrets.token_hex(16)
            env = {**env, "PORT_BACKEND": str(self.port), "BACKEND_API_KEY": self.key}
        self.lines: list[tuple[float, str]] = []
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.time(), line.rstrip()))

    def wait_for(self, pattern: str, timeout: float, fail: str | None = None):
        """(seconds since start, match) of the first line matching
        ``pattern``; raises on ``fail``, on exit or after ``timeout``."""
        end = time.time() + timeout
        while time.time() < end:
            for t, line in list(self.lines):
                if fail and fail in line:
                    raise AssertionError(f"server: {line}\n{self.tail()}")
                m = re.search(pattern, line)
                if m:
                    return t - self.t0, m
            if self.proc.poll() is not None:
                raise AssertionError(f"server exited {self.proc.returncode}\n{self.tail()}")
            time.sleep(0.05)
        raise AssertionError(f"server: no {pattern!r} in {timeout} s\n{self.tail()}")

    def tail(self, n: int = 40) -> str:
        return "\n".join(line for _, line in self.lines[-n:])

    def stop(self) -> int:
        """SIGTERM; the exit code (the process is killed after 60 s)."""
        if self.proc.poll() is None:
            self.proc.send_signal(15)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self.reader.join(10)
        return self.proc.returncode


def _first_chat(srv: _Server) -> float:
    """Seconds to the first content chunk of a streamed greedy chat."""
    msgs = [{"role": "user", "content": "hello world, the quick brown fox"}]
    t0 = time.time()
    t_first, _, usage, _ = _stream(srv.port, "/v1/chat/completions",
                                   {"messages": msgs, "max_tokens": 8, "temperature": 0},
                                   srv.key)
    if usage["completion_tokens"] < 1:
        raise AssertionError(f"first chat: {usage}")
    return t_first - t0


def phase_cold_start(torch, engine):
    """The server as a fresh process over the warm layout cache, with the
    warm-up and without it: seconds to listening, the warm-up's seconds from
    its log line, the first chat's time to its first token, a clean exit on
    SIGTERM; then the mock backend without MODEL_PATH."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("MODEL_PATH", "MOCK_BACKEND", "ENGINE_WARMUP")}
    model = {**base, "MODEL_PATH": engine.model_path, "MAX_SLOTS": "4", "CTX": "4096",
             "PREFIX_CACHE": "0"}
    out = {}
    for warm in ("1", "0"):
        srv = _Server({**model, "ENGINE_WARMUP": warm})
        try:
            listen_s, _ = srv.wait_for(r"\[backend\] .* on 127\.0\.0\.1:", 600)
            _, m = srv.wait_for(r"\[loader\] load_stats (\{.*\})", 1)
            stats = json.loads(m.group(1))
            if not stats["cache_hits"] or stats["repacked_native"] + stats["repacked_numpy"]:
                raise AssertionError(f"the server's load was not warm: {stats}")
            row = {"listen_s": round(listen_s, 3), "load_s": stats["total_s"]}
            if warm == "1":
                done_s, m = srv.wait_for(r"\[backend\] warm-up done in ([0-9.]+) s", 600,
                                         fail="warm-up failed")
                row["warmup_s"] = float(m.group(1))
                row["warmup_done_s"] = round(done_s, 3)
            row["first_ttft_s"] = round(_first_chat(srv), 4)
            row["second_ttft_s"] = round(_first_chat(srv), 4)
            if warm == "0" and any("warm-up" in line for _, line in srv.lines):
                raise AssertionError("ENGINE_WARMUP=0 ran a warm-up")
        finally:
            rc = srv.stop()
        if rc != 0 or not any("[backend] stopped" in line for _, line in srv.lines):
            raise AssertionError(f"SIGTERM: exit {rc}\n{srv.tail()}")
        row["sigterm_exit"] = rc
        out["warmup" if warm == "1" else "no_warmup"] = row
    srv = _Server(base)
    try:
        listen_s, _ = srv.wait_for(r"\[backend\] mock-model on 127\.0\.0\.1:", 120)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/v1/models", headers={"Authorization": f"Bearer {srv.key}"})
        r = conn.getresponse()
        models = json.loads(r.read())
        conn.close()
        if r.status != 200 or models["data"][0]["id"] != "mock-model":
            raise AssertionError(f"mock /v1/models: {r.status} {models}")
        body = _json_post(srv.port, "/v1/completions", {"prompt": "a b c", "max_tokens": 3},
                          srv.key)
        if body["choices"][0]["text"] != "mock-token-0 mock-token-1 mock-token-2":
            raise AssertionError(f"mock completion: {body}")
    finally:
        rc = srv.stop()
    if rc != 0:
        raise AssertionError(f"mock SIGTERM: exit {rc}\n{srv.tail()}")
    out["mock"] = {"listen_s": round(listen_s, 3), "sigterm_exit": rc}
    emit({"phase": "cold-start", "ok": True, **out})


def phase_embeddings(torch, engine):
    """``/v1/embeddings`` for two inputs through the server, each vector
    against the same pooling over a forward on the kernels' plain versions
    (within LOGITS_TOL of its scale); a rerank of three documents, one the
    query itself, which must rank first."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    texts = [PROMPT, " ".join([PROMPT] * 12)]
    launches: dict[str, int] = {}
    with serving(torch, engine, launches) as (port, key):
        t0 = time.time()
        emb = _json_post(port, "/v1/embeddings", {"input": texts}, key)
        embed_s = time.time() - t0
        docs = ["hello world, a story of two cities", PROMPT, "a lazy dog sleeps all day"]
        t0 = time.time()
        rr = _json_post(port, "/v1/rerank", {"query": PROMPT, "documents": docs}, key)
        rerank_s = time.time() - t0
    _check_launches("embeddings", launches, (qm.NAME_4BIT_TC, fa.NAME_TC))
    if [r["index"] for r in rr["results"]][0] != 1:
        raise AssertionError(f"rerank: the query's own text is not first: {rr['results']}")
    with plain_versions():
        refs = [engine.embed(t) for t in texts]
    errs = []
    for got, (want, n) in zip(emb["data"], refs):
        g = torch.tensor(got["embedding"], dtype=torch.float64)
        w = torch.tensor(want, dtype=torch.float64)
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"embedding {got['index']}: shape {tuple(g.shape)}")
        errs.append((g - w).abs().max().item() / w.abs().max().item())
    if max(errs) > LOGITS_TOL:
        raise AssertionError(f"embeddings against the plain versions: {errs}")
    emit({"phase": "embeddings", "ok": True, "dim": len(emb["data"][0]["embedding"]),
          "tokens": [n for _, n in refs], "usage": emb["usage"], "rel_err": errs,
          "embed_s": round(embed_s, 4), "rerank_s": round(rerank_s, 4),
          "rerank": rr["results"], "launches": launches})
    return launches


ENCODER_SHORT = "what is the capital of france"


def _encoder_long(tokenizer, n: int = 500) -> str:
    """Words of the synthesized WordPiece vocab, one token each, to ``n``
    tokens with [CLS] and [SEP]."""
    from llama_gguf_inference_tpu_torch.tools.synth import BERT_WORDS
    words = [BERT_WORDS[i % len(BERT_WORDS)] for i in range(n - 2)]
    text = " ".join(words)
    if len(tokenizer.encode(text)) != n:
        raise AssertionError(f"long input: {len(tokenizer.encode(text))} tokens, not {n}")
    return text


def _encoder_8bit_rows(torch, engine, timer) -> list[dict]:
    """Layer 0's projections at the shapes the encoder gives the 8-bit
    kernels: one 512-row q (in 1024, out 1024) and ffn_up (in 1024, out 4096)
    through the decode kernel, which takes them at every row count (nsub 32
    misses the tensor-core kernel's step of 64), and ffn_down (in 4096, out
    1024) at 64 and 512 rows (the two buckets) through the tensor-core
    kernel; each against the plain version (MATMUL_TOL of its scale), its
    bound and ``torch.matmul`` on a bf16 copy of the weight."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for name, B, kname, kernel in (
            ("attn_q", 512, qm.NAME_8BIT, qm.quant_matmul_8bit_decode),
            ("ffn_up", 512, qm.NAME_8BIT, qm.quant_matmul_8bit_decode),
            ("ffn_down", 64, qm.NAME_8BIT_TC, qm.quant_matmul_8bit_tc),
            ("ffn_down", 512, qm.NAME_8BIT_TC, qm.quant_matmul_8bit_tc)):
        w = engine.params["layers"][0][name]
        if qm.tc_takes(w.in_features, w.sub_size) != (kname == qm.NAME_8BIT_TC):
            raise AssertionError(f"{name}: tc_takes(in={w.in_features}) does not pick {kname}")
        x = torch.randn(B, w.in_features, generator=g, device="cuda").to(torch.bfloat16)
        args = (x, w.codes, w.d, w.sc, w.sub_size, w.code_bias, w.dmin, w.mn)
        err, rel = _err(kernel(*args), qm.quant_matmul_8bit_plain(*args), MATMUL_TOL)
        wb = w.dequantize_bm(torch.bfloat16)
        ms = timer(lambda: kernel(*args))
        plain_ms = timer(lambda: qm.quant_matmul_8bit_plain(*args))
        lib_ms = timer(lambda: torch.matmul(x, wb.t()))
        nbytes = x.numel() * 2 + _wbytes(w) + B * w.out_features * 4
        b_ms, by = bound(nbytes, 2.0 * B * w.in_features * w.out_features)
        rows.append({"kernel": kname, "shape": f"encoder Q8_0 {name} {w.out_features}x"
                     f"{w.in_features} B={B}", "max_abs_err": err, "max_rel_err": rel,
                     "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                     "bound_ms": round(b_ms, 4), "bound_by": by,
                     "bytes_bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 4),
                     "share": round(b_ms / ms, 4), "library_ms": round(lib_ms, 4)})
        del wb
    return rows


def phase_encoder(torch):
    """The bge-large-shaped Q8_0 encoder (``tools.synth.cached_bert``) built by
    ``build_engine_from_env`` from ``MODEL_PATH`` and served by
    ``OpenAIServer``: ``/v1/embeddings`` of a short input and one of 500
    tokens (the 64 and 512 buckets), a rerank of three documents (the query's
    own text must rank first) and ``/v1/completions`` (the JAX server's
    500 with ``engine_error``). One launch window; each vector held against the same engine
    under the plain versions to LOGITS_TOL of its scale; the 8-bit decode
    and tensor-core kernels each launched. Then layer 0's projections through
    both kernels at their encoder shapes (``_encoder_8bit_rows``), checked
    and timed. Returns the launch window's counts and those rows (the
    kernels line takes the tensor-core kernel's from them)."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.encoder_engine import EncoderEngine
    from llama_gguf_inference_tpu_torch.serving.openai_server import build_engine_from_env
    from llama_gguf_inference_tpu_torch.tools.synth import cached_bert
    t0 = time.time()
    path = cached_bert()
    synth_s = time.time() - t0
    saved = {k: os.environ.get(k) for k in ("MODEL_PATH", "MOCK_BACKEND")}
    os.environ["MODEL_PATH"] = path
    os.environ.pop("MOCK_BACKEND", None)
    try:
        t0 = time.time()
        engine = build_engine_from_env()
        torch.cuda.synchronize()
        load_s = time.time() - t0
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    if not isinstance(engine, EncoderEngine) or engine.cfg.dim != 1024 \
            or engine.cfg.n_layers != 24 or engine.cfg.pooling != "cls":
        raise AssertionError(f"encoder: {type(engine).__name__} {engine.cfg}")
    texts = [ENCODER_SHORT, _encoder_long(engine.tokenizer)]
    docs = ["a lazy dog sleeps all day", ENCODER_SHORT, "hello world, a story of two cities"]
    launches: dict[str, int] = {}
    with serving(torch, engine, launches) as (port, key):
        embed_s = {}
        out = []
        for text in texts:
            times = []
            for _ in range(2):
                t0 = time.time()
                emb = _json_post(port, "/v1/embeddings", {"input": text}, key)
                times.append(round(time.time() - t0, 4))
            out.append(emb)
            embed_s[str(engine._bucket(emb["usage"]["prompt_tokens"]))] = times
        rr = _json_post(port, "/v1/rerank", {"query": ENCODER_SHORT, "documents": docs}, key)
        conn, r = _post(port, "/v1/completions", {"prompt": "hello", "max_tokens": 4}, key)
        completion = (r.status, json.loads(r.read()))
        conn.close()
    _check_launches("encoder", launches, (qm.NAME_8BIT, qm.NAME_8BIT_TC))
    if completion[0] != 500 or completion[1]["error"]["code"] != "engine_error":
        raise AssertionError(f"encoder completion: {completion}")
    if [x["index"] for x in rr["results"]][0] != 1:
        raise AssertionError(f"rerank: the query's own text is not first: {rr['results']}")
    with plain_versions():
        refs = [engine.embed(t) for t in texts]
    errs = []
    for got, (want, n) in zip(out, refs):
        g = torch.tensor(got["data"][0]["embedding"], dtype=torch.float64)
        w = torch.tensor(want, dtype=torch.float64)
        if g.shape != (1024,) or not torch.isfinite(g).all() \
                or abs(g.norm().item() - 1) > 1e-3 or got["usage"]["prompt_tokens"] != n:
            raise AssertionError(f"embedding: shape {tuple(g.shape)}, norm {g.norm()}, "
                                 f"usage {got['usage']} against {n}")
        errs.append((g - w).abs().max().item() / w.abs().max().item())
    if max(errs) > LOGITS_TOL:
        raise AssertionError(f"encoder embeddings against the plain versions: {errs}")
    with torch.inference_mode():
        rows = _encoder_8bit_rows(torch, engine, Timer(torch))
    resident = _resident_bytes(torch, engine.params)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "encoder", "ok": True, "synth_s": round(synth_s, 3),
          "load_s": round(load_s, 3), "resident_gb": resident / 1e9,
          "tokens": [n for _, n in refs], "rel_err": errs, "embed_s": embed_s,
          "rerank": rr["results"], "completion_status": completion[0],
          "launches": launches, "kernel_rows": rows})
    return launches, rows
    return launches


def _get_status(port, path, key=None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path, headers={"Authorization": f"Bearer {key}"} if key else {})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def phase_launch(torch, engine):
    """The three-process stack of ``python -m llama_gguf_inference_tpu_torch
    serve`` over the 8B Q4_K_M GGUF, warm from its layout cache, with an API
    key file: the health port answers; through the gateway a request without
    the key gets 401, a streamed greedy chat of 32 tokens with every EOG
    token banned arrives chunk by chunk, ``/metrics`` counts the requests,
    and the ported benchmark client runs a few requests (its summary printed
    for information). The backend's launch counts live in its own process,
    which shows none: its tokens are held to the same chat served in this
    process over the same weights (on the card every wrapper launches its
    kernel or raises). SIGTERM to the supervisor: it and its three children
    exit 0 and the backend's key file is shredded."""
    from llama_gguf_inference_tpu_torch.serving import key_mgmt
    tmp = tempfile.mkdtemp(prefix="lgt-smoke-stack-")
    keys = os.path.join(tmp, "api_keys.txt")
    with contextlib.redirect_stdout(None):
        if key_mgmt.main(["--keys-file", keys, "generate", "--key-id", "smoke", "--quiet"]):
            raise AssertionError("key_mgmt generate failed")
    api_key = open(keys).read().strip().split(":")[1]
    gw, health, backend = _free_port(), _free_port(), _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("MODEL_PATH", "MOCK_BACKEND", "MODEL_NAME")}
    env = {**base, "MODEL_PATH": engine.model_path, "DATA_DIR": tmp, "BACKEND_KEY_DIR": tmp,
           "AUTH_KEYS_FILE": keys, "GATEWAY_HOST": "127.0.0.1", "GATEWAY_PORT": str(gw),
           "PORT_HEALTH": str(health), "PORT_BACKEND": str(backend), "MAX_SLOTS": "4",
           "CTX": "4096", "PREFIX_CACHE": "0", "ENGINE_WARMUP": "0"}
    eog = sorted(engine.tokenizer.eog_ids)
    chat = {"messages": [{"role": "user", "content": PROMPT}], "max_tokens": 32,
            "temperature": 0, "logit_bias": {str(t): False for t in eog}}
    stack = _Server(env, stack=True)
    out: dict = {}
    try:
        up_s, _ = stack.wait_for(r"\[gateway\] listening", 300, fail="FATAL")
        out["up_s"] = round(up_s, 3)
        _, m = stack.wait_for(r"\[loader\] load_stats (\{.*\})", 1)
        stats = json.loads(m.group(1))
        if not stats["cache_hits"] or stats["repacked_native"] + stats["repacked_numpy"]:
            raise AssertionError(f"the backend's load was not warm: {stats}")
        out["backend_load_s"] = stats["total_s"]
        end = time.time() + 30
        while True:
            try:
                if _get_status(health, "/")[0] == 200 and _get_status(health, "/any")[0] == 200:
                    break
            except OSError:
                if time.time() > end:
                    raise
            time.sleep(0.1)
        status, _ = _get_status(gw, "/v1/models")
        if status != 401:
            raise AssertionError(f"gateway without the key: {status}")
        t0 = time.time()
        chunks = _sse_chunks(gw, "/v1/chat/completions", chat, api_key)
        out["stream_s"] = round(time.time() - t0, 4)
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks if c["choices"])
        finish = [c["choices"][0]["finish_reason"] for c in chunks
                  if c["choices"] and c["choices"][0]["finish_reason"]]
        if len(chunks) < 8 or finish != ["length"]:
            raise AssertionError(f"gateway stream: {len(chunks)} chunks, finish {finish}")
        out["stream_chunks"] = len(chunks)
        status, body = _get_status(gw, "/metrics")
        metrics = json.loads(body)["gateway"]
        if status != 200 or metrics["requests_total"] < 2 \
                or metrics["requests_unauthorized"] < 1 or metrics["requests_success"] < 1:
            raise AssertionError(f"gateway /metrics: {status} {metrics}")
        out["metrics"] = metrics
        t0 = time.time()
        bench = subprocess.run(
            [sys.executable, "-m", "llama_gguf_inference_tpu_torch", "benchmark",
             "--url", f"http://127.0.0.1:{gw}", "--api-key", api_key, "--suite", "all",
             "--requests", "4", "--concurrency", "2", "--max-tokens", "16", "--json"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=base,
            capture_output=True, text=True, timeout=300)
        if bench.returncode != 0:
            raise AssertionError(f"benchmark client: {bench.returncode}\n{bench.stderr[-2000:]}")
        out["benchmark_s"] = round(time.time() - t0, 3)
        out["benchmark"] = json.loads(bench.stdout)
    finally:
        rc = stack.stop()
    exits = dict(re.findall(r"\[start\] (backend|health|gateway) exited (-?\d+)",
                            "\n".join(line for _, line in stack.lines)))
    left = os.listdir(os.path.join(tmp, "llama-keys"))
    shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0 or exits != {"backend": "0", "health": "0", "gateway": "0"} or left:
        raise AssertionError(f"SIGTERM: supervisor {rc}, children {exits}, key files {left}"
                             f"\n{stack.tail()}")
    launches: dict[str, int] = {}
    with serving(torch, engine, launches) as (port, key):
        local = _sse_chunks(port, "/v1/chat/completions", chat, key)
    local_text = "".join(c["choices"][0]["delta"].get("content") or ""
                         for c in local if c["choices"])
    if local_text != text:
        raise AssertionError(f"served through the gateway {text!r}, in process {local_text!r}")
    emit({"phase": "launch", "ok": True, **out, "sigterm_exit": rc, "children_exit": exits,
          "tokens_equal_in_process": True, "in_process_launches": launches})


def _greedy_run(torch, engine, ids, steps, cache=None, feed=None):
    """Prefill ``ids`` into a one-sequence cache, then ``steps`` decode
    steps, each fed the argmax of the logits before it or, when ``feed`` is
    given, its tokens (teacher forcing). Returns the steps + 1 logits and
    the tokens fed."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    dev = engine.device
    if cache is None:
        cache = KVCache.zeros(engine.cfg, 1, 1024, dev)
    toks = []
    with torch.inference_mode():
        lg = forward(engine.params, engine.cfg,
                     torch.tensor([ids], dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev), cache,
                     logits_at=torch.tensor([len(ids) - 1], device=dev))[0, 0]
        logits = [lg]
        for i in range(steps):
            toks.append(int(lg.argmax()) if feed is None else feed[i])
            lg = forward(engine.params, engine.cfg,
                         torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
                         torch.tensor([len(ids) + i], dtype=torch.int32, device=dev),
                         cache)[0, 0]
            logits.append(lg)
    torch.cuda.synchronize()
    return logits, toks


PROMPT = "the quick brown fox jumps over the lazy dog"


def _compare(k_logits, p_logits, tol=LOGITS_TOL):
    """The plain run was fed the kernel run's tokens, so the logits of every
    step compare: each within ``tol`` of its scale. Returns the errors
    (prefill first) and the steps whose argmax agree."""
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(k_logits, p_logits)]
    if not max(errs) <= tol:
        raise AssertionError(f"logits rel errs {errs} exceed {tol}")
    agree = sum(int(a.argmax()) == int(b.argmax()) for a, b in zip(k_logits, p_logits))
    return errs, agree


def phase_forward(torch, engine):
    ids = engine.tokenizer.encode(PROMPT)
    t0 = time.time()
    k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
    t1 = time.time()
    with plain_versions():
        p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
    t2 = time.time()
    _check_logits(torch, engine, k_logits)
    errs, agree = _compare(k_logits, p_logits)
    emit({"phase": "forward", "ok": True, "prompt_tokens": len(ids),
          "steps_compared": len(errs), "argmax_agree": agree,
          "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
          "kernel_path_s": round(t1 - t0, 3), "plain_path_s": round(t2 - t1, 3)})
    return k_logits[0]


def _check_logits(torch, engine, logits):
    for lg in logits:
        if lg.shape != (engine.cfg.vocab_size,) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite or misshapen logits")


def _kv_config(kind, max_slots):
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    kv_dtype, kv_layout, _ = KV_KINDS[kind]
    return EngineConfig(max_slots=max_slots, ctx=1024, kv_dtype=kv_dtype,
                        kv_layout=kv_layout, kv_page_size=PAGE_S, prefix_cache=False)


def _kv_cache(torch, kind, engine):
    """A one-sequence cache of 1024 positions: contiguous, or 4 shuffled
    pages of 256."""
    from llama_gguf_inference_tpu_torch.runtime.engine import make_kv_cache
    cache, _ = make_kv_cache(engine.cfg, _kv_config(kind, 1), engine.device)
    if hasattr(cache, "page_table"):
        cache.page_table.copy_(torch.tensor([[2, 0, 3, 1]], dtype=torch.int32))
    return cache


@contextlib.contextmanager
def kv_engine(torch, engine, ecfg):
    """The loaded engine, idle and its loop not started, over a fresh cache
    of ``ecfg``'s kind; its own cache is rebuilt on the way out. A fresh
    cache holds no slot's kept prompt, so every claim is dropped."""
    from llama_gguf_inference_tpu_torch.runtime.engine import make_kv_cache

    def swap(cfg):
        for slot in engine.slots:
            slot.cached_ids = []
        engine.slots = engine.slots[:cfg.max_slots] + [
            type(engine.slots[0])() for _ in range(cfg.max_slots - len(engine.slots))]
        engine.sample_state = type(engine.sample_state).init(
            cfg.max_slots, engine.cfg.vocab_size, engine.device)
        engine.cache = engine.alloc = None
        gc.collect()
        torch.cuda.empty_cache()
        engine.ecfg = cfg
        engine.cache, engine.alloc = make_kv_cache(engine.cfg, cfg, engine.device)

    saved = engine.ecfg
    swap(ecfg)
    try:
        yield engine
    finally:
        swap(saved)


# prompts of three lengths: two pad to the engine's bucket of 16 rows, the
# third to 32; every bucket reaches FLASH_TC_MIN_ROWS (16)
ENGINE_PROMPTS = (PROMPT, "hello world, the quick brown fox",
                  "request 2: " + PROMPT + ", and then " + PROMPT)


def _engine_run(torch, engine, kind, steps):
    """Three greedy requests through the engine's scheduler (``step()``),
    over four slots of ``kind``'s cache with one slot idle; launches counted
    over this run only. Each request is then replayed, fed the engine's
    tokens, through a one-sequence cache of the same kind: every token the
    engine chose must lie within LOGITS_TOL (of the logits' scale) of the
    replay's largest logit. The prompts' prefill, padded to the engine's
    buckets (all from FLASH_TC_MIN_ROWS), runs the kind's tensor-core flash
    kernel, their decode steps its decode kernel."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
    name = KV_KINDS[kind][2]
    want = (name, name + "_tc")
    with kv_engine(torch, engine, _kv_config(kind, 4)):
        _build.reset_launches()
        outs = [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=steps))[1]
                for p in ENGINE_PROMPTS]
        while engine.step():
            pass
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        alloc = engine.alloc
        pages = None if alloc is None else (alloc.free_pages, alloc.table.shape[1])
    _check_launches(f"{kind} engine", launches, want)
    if pages is not None and pages[0] != pages[1]:
        raise AssertionError(f"{kind} engine: {pages[0]} of {pages[1]} pages free")
    gaps, agree, n_tok = [], 0, []
    for prompt, out in zip(ENGINE_PROMPTS, outs):
        events = []
        while not out.empty():
            events.append(out.get_nowait())
        ids = engine.tokenizer.encode(prompt)
        toks = [ev.token_id for ev in events]
        last = events[-1] if events else None
        if last is None or not last.finished or last.finish_reason not in ("stop", "length") \
                or last.n_prompt != len(ids) or not 0 < len(toks) <= steps:
            raise AssertionError(f"{kind} engine: request ended with {last}")
        ref, _ = _greedy_run(torch, engine, ids, len(toks) - 1,
                             _kv_cache(torch, kind, engine), feed=toks)
        _check_logits(torch, engine, ref)
        for lg, tok in zip(ref, toks):
            gaps.append(((lg.max() - lg[tok]) / lg.abs().max()).item())
            agree += int(lg.argmax()) == tok
        n_tok.append(len(toks))
    if not max(gaps) <= LOGITS_TOL:
        raise AssertionError(f"{kind} engine: token below the replay's max by {max(gaps)}")
    return launches, {"engine_launches": launches[name], "engine_tokens": n_tok,
                      "engine_token_gap_max": max(gaps), "engine_argmax_agree": agree,
                      "engine_pages_free_after": None if pages is None else pages[0]}


def phase_kv_forward(torch, engine, bf16_prefill):
    """Each quantized or paged cache kind at full width: the forward with
    the kernels (launches counted), the same fed those tokens with only that
    kind's attention wrapper swapped for its plain version, then the
    engine's scheduler over four slots of that kind (launches counted)."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    ids = engine.tokenizer.encode(PROMPT)
    total: dict[str, int] = {}
    for kind, (_, _, name) in KV_KINDS.items():
        t0 = time.time()
        _build.reset_launches()
        k_logits, k_toks = _greedy_run(torch, engine, ids, 16, _kv_cache(torch, kind, engine))
        launches = dict(_build.LAUNCHES)
        t1 = time.time()
        if launches.get(name, 0) <= 0 or launches.get(name + ".plain", 0):
            raise AssertionError(f"{kind}: launches {launches}")
        saved = getattr(fa, name)
        setattr(fa, name, getattr(fa, name + "_plain"))
        try:
            p_logits, _ = _greedy_run(torch, engine, ids, 16,
                                      _kv_cache(torch, kind, engine), feed=k_toks)
        finally:
            setattr(fa, name, saved)
        _check_logits(torch, engine, k_logits)
        errs, agree = _compare(k_logits, p_logits)
        engine_launches, engine_out = _engine_run(torch, engine, kind, 16)
        for counts in (launches, engine_launches):
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        emit({"phase": "kv-forward", "ok": True, "kind": kind, "kernel": name,
              "launches": launches[name], "steps_compared": len(errs),
              "argmax_agree": agree, "logits_rel_err_prefill": errs[0],
              "logits_rel_err_max": max(errs),
              "prefill_rel_err_vs_bf16_cache": (
                  (k_logits[0] - bf16_prefill).abs().max()
                  / bf16_prefill.abs().max()).item(),
              "kernel_path_s": round(t1 - t0, 3), **engine_out})
    return total


def _post(port, path, body, key, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    conn.request("POST", path, json.dumps(body), headers)
    return conn, conn.getresponse()


@contextlib.contextmanager
def serving(torch, engine, launches: dict):
    """The engine's loop and its OpenAI server on localhost, yielding
    (port, key). Launch counters are reset once both run and read into
    ``launches`` after the last request; then both stop."""
    import asyncio

    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.serving.openai_server import (BackendConfig,
                                                                      OpenAIServer)
    key = secrets.token_hex(16)
    srv = OpenAIServer(engine, BackendConfig(host="127.0.0.1", port=0, api_key=key))
    loop = asyncio.new_event_loop()
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    _build.reset_launches()
    engine.start()
    th.start()
    try:
        if not ready.wait(60):
            raise RuntimeError("server did not start")
        yield srv.port, key
    finally:
        torch.cuda.synchronize()
        launches.update(_build.LAUNCHES)
        if ready.is_set():
            asyncio.run_coroutine_threadsafe(srv.close(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
        engine.stop()


def _stream(port, path, body, key):
    """POST a streamed request; returns (t_first, t_last, usage, n_events),
    stamped when the first and the finishing chunk arrive."""
    conn, r = _post(port, path, {**body, "stream": True,
                                 "stream_options": {"include_usage": True}}, key)
    if r.status != 200:
        raise AssertionError(f"stream: {r.status}")
    events, t_first, t_last, usage = [], None, None, None
    for raw in r:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        events.append(line[6:])
        if line[6:] == "[DONE]":
            continue
        ev = json.loads(line[6:])
        if ev["choices"] and t_first is None:
            t_first = time.time()
        if ev["choices"] and ev["choices"][0]["finish_reason"] is not None:
            t_last = time.time()
        usage = ev.get("usage") or usage
    conn.close()
    if events[-1] != "[DONE]" or t_last is None or usage is None:
        raise AssertionError("stream did not end with finish and usage chunks and [DONE]")
    return t_first, t_last, usage, len(events)


def _completions(port, key, bodies):
    """POST the completion bodies at once; (status, json) of each."""
    results = [None] * len(bodies)

    def one(i):
        c, rr = _post(port, "/v1/completions", bodies[i], key)
        results[i] = (rr.status, json.loads(rr.read()))
        c.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"completions: {results}")
    return results


def phase_serve(torch, engine, label="serve"):
    launches: dict[str, int] = {}
    out = {}
    with serving(torch, engine, launches) as (port, key):
        msgs = [{"role": "user", "content": "hello world, the quick brown fox"}]
        t0 = time.time()
        conn, r = _post(port, "/v1/chat/completions",
                        {"messages": msgs, "max_tokens": 32, "temperature": 0}, key)
        body = json.loads(r.read())
        conn.close()
        if r.status != 200 or body["choices"][0]["message"]["role"] != "assistant":
            raise AssertionError(f"chat: {r.status} {body}")
        out["chat_s"] = round(time.time() - t0, 4)
        out["chat_completion_tokens"] = body["usage"]["completion_tokens"]

        # The server sends the role chunk when the first token arrives and the
        # finish chunk with the last, so those two stamps bracket decode. A
        # token that ends inside a UTF-8 sequence or a possible stop string
        # sends no content chunk, so tokens are counted from the usage chunk.
        t0 = time.time()
        t_first, t_last, usage, n_events = _stream(
            port, "/v1/chat/completions",
            {"messages": msgs, "max_tokens": 64, "temperature": 0}, key)
        n_gen = usage["completion_tokens"]
        out["ttft_s"] = round(t_first - t0, 4)
        out["stream_chunks"] = n_events
        out["stream_completion_tokens"] = n_gen
        out["decode_tok_s_b1"] = round((n_gen - 1) / (t_last - t_first), 2)

        t0 = time.time()
        results = _completions(port, key, [
            {"prompt": f"request {i}: the lazy dog", "max_tokens": 64, "temperature": 0}
            for i in range(4)])
        wall = time.time() - t0
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in results)
        out["concurrent_completion_tokens"] = ntok
        out["aggregate_tok_s_b4"] = round(ntok / wall, 2)

        conn, r = _post(port, "/v1/chat/completions", {"messages": msgs}, "")
        r.read()
        conn.close()
        if r.status != 401:
            raise AssertionError(f"no key: {r.status}")
        out["no_key_status"] = r.status
    emit({"phase": label, "ok": True, **out, "launches": launches})
    return launches


@contextlib.contextmanager
def sync_checked(torch, engine, errors: list, names=("_issue",)):
    """Run the engine's methods ``names`` (its dispatch, ``_issue``, and for
    a constrained batch the grammar masks' flush before it) under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation in them that
    waits for the card raises, and is recorded in ``errors``. The drain's
    one wait, on the dispatch's event, lies outside. Yields the number of
    calls checked, by name."""
    saved = {n: getattr(engine, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def checked(name, fn):
        def run(*a, **k):
            calls[name] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            except RuntimeError as e:
                errors.append(str(e)[:300])
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    for n, fn in saved.items():
        setattr(engine, n, checked(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(engine, n, fn)


DISPATCH_PROMPTS = [f"request {i}: the lazy dog" for i in range(4)]


def phase_decode_dispatch(torch, engine, card):
    """The loaded Q4_K_M engine (4 slots of 1024, bf16 cache) at
    ``multi_step`` 1 and then 4, served over HTTP, each a launch window:
    four concurrent greedy requests of 64 tokens (the same tokens at both,
    their aggregate rate printed) and one streamed one (its decode rate); at
    4 also a request banning every EOG token by ``logit_bias`` (it must run
    to its ``max_tokens``), a seeded request with temperature, top-k, top-p,
    min-p, typical-p, the three penalties and ``top_logprobs``, and a seeded
    mirostat one, each twice (the same answer twice). At 4 every dispatch
    runs under the sync debug mode (no wait for the card inside it) and
    continuations must have been issued. The rates are for information,
    printed beside the card's name and power limit."""
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    paths, texts, out, rates, sync_errors = [], {}, {}, {}, []
    eog = sorted(engine.tokenizer.eog_ids)
    sampled = {"prompt": "the quick brown fox", "max_tokens": 32, "temperature": 0.8,
               "top_k": 40, "top_p": 0.95, "min_p": 0.02, "typical_p": 0.9,
               "presence_penalty": 0.4, "frequency_penalty": 0.2, "repeat_penalty": 1.1,
               "seed": 1234, "logprobs": True, "top_logprobs": 5}
    miro = {"prompt": "hello world, the quick brown fox", "max_tokens": 32,
            "temperature": 1.0, "mirostat": 2, "mirostat_tau": 4.0, "mirostat_eta": 0.2,
            "seed": 99}
    for n in (1, 4):
        launches: dict[str, int] = {}
        with kv_engine(torch, engine, EngineConfig(max_slots=4, ctx=1024, multi_step=n,
                                                   prefix_cache=False)):
            engine.dispatches = engine.continuations = 0
            try:
                with sync_checked(torch, engine, sync_errors, () if n == 1 else ("_issue",)), \
                        serving(torch, engine, launches) as (port, key):
                    t0 = time.time()
                    res = _completions(port, key, [
                        {"prompt": p, "max_tokens": 64, "temperature": 0}
                        for p in DISPATCH_PROMPTS])
                    wall = time.time() - t0
                    texts[n] = [r[1]["choices"][0]["text"] for r in res]
                    ntok = sum(r[1]["usage"]["completion_tokens"] for r in res)
                    t_first, t_last, usage, _ = _stream(
                        port, "/v1/completions",
                        {"prompt": PROMPT, "max_tokens": 64, "temperature": 0}, key)
                    rates[n] = {"decode_tok_s_b1": round(
                        (usage["completion_tokens"] - 1) / (t_last - t_first), 2),
                        "aggregate_tok_s_b4": round(ntok / wall, 2)}
                    if n == 4:
                        _, banned = _completions(port, key, [{
                            "prompt": PROMPT, "max_tokens": 64, "temperature": 0,
                            "logit_bias": {str(t): False for t in eog}}])[0]
                        fin = banned["choices"][0]["finish_reason"]
                        if fin != "length" or banned["usage"]["completion_tokens"] != 64:
                            raise AssertionError(f"EOG-banned request: {fin}, "
                                                 f"{banned['usage']}")
                        for label, body in (("sampled", sampled), ("mirostat", miro)):
                            a, b = (_completions(port, key, [body])[0][1] for _ in range(2))
                            ca, cb = a["choices"][0], b["choices"][0]
                            if ca["text"] != cb["text"] or ca["logprobs"] != cb["logprobs"]:
                                raise AssertionError(f"{label}: two seeded answers differ")
                            if label == "sampled" and (
                                    len(ca["logprobs"]["token_logprobs"])
                                    != a["usage"]["completion_tokens"]
                                    or not all(0 < len(t) <= 5
                                               for t in ca["logprobs"]["top_logprobs"])):
                                raise AssertionError(f"sampled: logprobs {ca['logprobs']}")
                            out[f"{label}_tokens"] = a["usage"]["completion_tokens"]
                    rates[n].update(dispatches=engine.dispatches,
                                    continuations=engine.continuations)
            except Exception as e:
                if sync_errors:
                    raise AssertionError(f"a dispatch waited for the card: {sync_errors}") from e
                raise
        _check_launches(f"decode-dispatch multi_step {n}", launches,
                        ("quant_matmul_4bit", "quant_matmul_8bit", "flash_attention"))
        paths.append(launches)
    if sync_errors:
        raise AssertionError(f"a dispatch waited for the card: {sync_errors}")
    if texts[1] != texts[4]:
        raise AssertionError(f"multi_step 4 tokens differ from multi_step 1: {texts}")
    if rates[4]["continuations"] <= 0 or rates[1]["continuations"] != 0:
        raise AssertionError(f"continuations: {rates}")
    emit({"phase": "decode-dispatch", "ok": True, "nvidia_smi": card,
          **{f"multi_step_{n}": r for n, r in rates.items()}, "eog_banned": eog, **out,
          "sync_checked_dispatches": rates[4]["dispatches"],
          "launches": {n: sum(p.values()) for n, p in zip((1, 4), paths)}})
    return paths


# the structured phase's schema: a finite language (an enum and a boolean)
STRUCT_SCHEMA = {"type": "object",
                 "properties": {"color": {"enum": ["red", "green", "blue"]},
                                "ok": {"type": "boolean"}},
                 "required": ["color", "ok"]}
STRUCT_TOOL = {"type": "function", "function": {
    "name": "set_light", "description": "Switch the light of a room",
    "parameters": {"type": "object",
                   "properties": {"room": {"enum": ["hall", "kitchen"]},
                                  "on": {"type": "boolean"}},
                   "required": ["room", "on"], "additionalProperties": False}}}
# a shared system prompt of about 700 tokens and two tails
SYSTEM_PROMPT = "Rules:" + " the quick brown fox jumps over the lazy dog." * 70
TAILS = (" Question: hello world?", " Question: over the lazy dog?")


def _json_post(port, path, body, key) -> dict:
    """POST a request that must succeed; its JSON answer."""
    conn, r = _post(port, path, body, key)
    out = json.loads(r.read())
    conn.close()
    if r.status != 200:
        raise AssertionError(f"{path}: {r.status} {out}")
    return out


def _sse_chunks(port, path, body, key):
    """A streamed request's chunks (JSON objects), without ``[DONE]``."""
    conn, r = _post(port, path, {**body, "stream": True}, key)
    if r.status != 200:
        raise AssertionError(f"stream: {r.status}")
    lines = [raw.decode().strip() for raw in r]
    conn.close()
    data = [ln[6:] for ln in lines if ln.startswith("data: ")]
    if data[-1] != "[DONE]":
        raise AssertionError("stream did not end with [DONE]")
    return [json.loads(d) for d in data[:-1]]


def _schema_value(text: str) -> dict:
    val = json.loads(text)
    if set(val) != {"color", "ok"} or val["color"] not in ("red", "green", "blue") \
            or not isinstance(val["ok"], bool):
        raise AssertionError(f"answer outside the schema: {text!r}")
    return val


def _tool_args(calls) -> list:
    out = []
    for c in calls:
        args = json.loads(c["arguments"])
        if c["name"] != "set_light" or set(args) != {"room", "on"} \
                or args["room"] not in ("hall", "kitchen") or not isinstance(args["on"], bool):
            raise AssertionError(f"tool call outside the schema: {c}")
        out.append((c["name"], args))
    return out


@contextlib.contextmanager
def _host_costs():
    """Time the vocab trie's build and each new grammar state's mask."""
    from llama_gguf_inference_tpu_torch.grammar import matcher as gm
    costs: dict[str, list] = {"trie_s": [], "mask_s": []}
    init, compute = gm.TokenTrie.__init__, gm.GrammarMatcher._compute_mask

    def timed_init(self, tokenizer):
        t = time.perf_counter()
        init(self, tokenizer)
        costs["trie_s"].append(time.perf_counter() - t)

    def timed_mask(self):
        t = time.perf_counter()
        mask = compute(self)
        costs["mask_s"].append(time.perf_counter() - t)
        return mask

    gm.TokenTrie.__init__, gm.GrammarMatcher._compute_mask = timed_init, timed_mask
    try:
        yield costs
    finally:
        gm.TokenTrie.__init__, gm.GrammarMatcher._compute_mask = init, compute


def _masked_sampler(torch, vocab: int, card: str = "cuda") -> dict:
    """Every sampler stage on rows a grammar's mask leaves 37 tokens finite
    (fewer than mirostat v1's fit reads, so its differences are NaN): the
    card's draws over 8 steps and its mirostat mu against the port's CPU
    draws on the same inputs."""
    from llama_gguf_inference_tpu_torch.runtime import sampler as ts
    g = torch.Generator().manual_seed(19)
    B, n_valid, steps = 7, 37, 8
    logits = torch.randn(B, vocab, generator=g) * 3
    bias = torch.full((B, vocab), float("-inf"))
    for b in range(B):
        bias[b, torch.randperm(vocab, generator=g)[:n_valid]] = 0.0
    params = [ts.SamplingParams(temperature=0.0),
              ts.SamplingParams(temperature=0.9, top_k=5, seed=1),
              ts.SamplingParams(temperature=0.9, top_p=0.9, seed=2),
              ts.SamplingParams(temperature=0.9, min_p=0.1, seed=3),
              ts.SamplingParams(temperature=0.9, typical_p=0.8, seed=4),
              ts.SamplingParams(temperature=1.0, mirostat=1, mirostat_tau=5.0, seed=5),
              ts.SamplingParams(temperature=1.0, mirostat=2, mirostat_tau=3.0, seed=6)]
    gates = ts.Gates.of(params)
    runs = []
    for dev in ("cpu", card):
        st = ts.SampleState.init(B, vocab, dev)
        for b, p in enumerate(params):
            st.write_slot(b, p, bias=bias[b].numpy())
        x = logits.to(dev)
        kept = ts._mirostat_mask(x + st.bias, st)
        toks = torch.stack([ts.sample(x, st, gates) for _ in range(steps)])
        runs.append((toks.cpu(), st.miro_mu.cpu(), torch.isneginf(kept).cpu()))
    (tc, mc, kc), (tg, mg, kg) = runs
    if not torch.equal(tc, tg) or not torch.equal(kc, kg):
        raise AssertionError(f"masked draws: card {tg.tolist()} against CPU {tc.tolist()}")
    if not bool((bias.gather(1, tg.T) == 0).all()):
        raise AssertionError("a masked token was drawn")
    mu_err = ((mg - mc).abs() / mc.abs().clamp(min=1e-6)).max().item()
    if not mu_err <= 1e-4:
        raise AssertionError(f"mirostat mu: card {mg.tolist()} against CPU {mc.tolist()}")
    return {"rows": B, "valid_tokens": n_valid, "steps": steps, "tokens_equal": True,
            "mu_max_rel_diff": mu_err, "mirostat_v1_kept": int((~kg[5]).sum())}


def _structured_requests(torch, engine, port, key, sync_errors) -> dict:
    """Phase items 1 to 4 and the decode rates, on a cold engine."""
    from llama_gguf_inference_tpu_torch.grammar import JSON_GBNF, GrammarMatcher, parse_gbnf
    from llama_gguf_inference_tpu_torch.serving.tool_calls import parse_tool_calls
    ban = {str(t): False for t in sorted(engine.tokenizer.eog_ids)}
    rf = {"type": "json_schema", "json_schema": {"name": "light", "schema": STRUCT_SCHEMA}}
    msgs = [{"role": "user", "content": "pick a light and say if it is on"}]
    out = {}
    # 1. json_schema at temperature 0, every dispatch and mask flush under the
    # sync debug mode, then at 0.8 with a seed; every EOG token banned, so
    # the grammar's mask forces one where it can stop
    d0 = engine.dispatches
    with sync_checked(torch, engine, sync_errors, ("_issue", "_flush_grammar_masks")) as calls:
        a = _json_post(port, "/v1/chat/completions", {
            "messages": msgs, "response_format": rf, "temperature": 0, "max_tokens": 96,
            "logit_bias": ban}, key)
    if a["choices"][0]["finish_reason"] != "stop":
        raise AssertionError(f"json_schema: {a}")
    out["schema_greedy"] = _schema_value(a["choices"][0]["message"]["content"])
    out["sync_checked"] = {"dispatches": engine.dispatches - d0, **calls}
    if calls["_flush_grammar_masks"] <= 0 or engine.dispatches - d0 <= 0:
        raise AssertionError(f"no constrained dispatch was checked: {calls}")
    sampled = {"messages": msgs, "response_format": rf, "temperature": 0.8, "seed": 4321,
               "max_tokens": 96, "logit_bias": ban}
    b = _json_post(port, "/v1/chat/completions", sampled, key)
    out["schema_sampled"] = _schema_value(b["choices"][0]["message"]["content"])
    n_schema = b["usage"]["completion_tokens"]
    # 2. json_object, cut at 16 tokens: a fresh matcher accepts the text as
    # a prefix of a JSON object
    c = _json_post(port, "/v1/chat/completions", {
        "messages": msgs, "response_format": {"type": "json_object"}, "temperature": 0,
        "max_tokens": 16}, key)
    text = c["choices"][0]["message"]["content"]
    m = GrammarMatcher(parse_gbnf(JSON_GBNF), engine._token_trie)
    if not text.startswith("{") or not m._accepts(m.state, text):
        raise AssertionError(f"json_object: {text!r}")
    out["json_object_text"] = text
    # 3. a forced tool call, non-streamed and streamed; a bias on "]" closes
    # the call list after its first call (its maxItems is 8)
    close = [i for i, t in enumerate(engine._token_trie.token_text) if t == "]"]
    tool = {"messages": [{"role": "user", "content": "turn the hall light on"}],
            "tools": [STRUCT_TOOL], "temperature": 0, "max_tokens": 128,
            "tool_choice": {"type": "function", "function": {"name": "set_light"}},
            "logit_bias": {str(i): 100.0 for i in close}}
    t = _json_post(port, "/v1/chat/completions", tool, key)
    choice = t["choices"][0]
    if choice["finish_reason"] != "tool_calls":
        raise AssertionError(f"tool call: {t}")
    calls_plain = _tool_args([c["function"] for c in choice["message"]["tool_calls"]])
    chunks = _sse_chunks(port, "/v1/chat/completions", tool, key)
    deltas = [d for ch in chunks for d in ch["choices"][0]["delta"].get("tool_calls", [])]
    streamed = _tool_args([{"name": h["function"]["name"], "arguments": a["function"]["arguments"]}
                           for h, a in zip(deltas[::2], deltas[1::2])])
    if streamed != calls_plain or chunks[-1]["choices"][0]["finish_reason"] != "tool_calls":
        raise AssertionError(f"streamed tool calls {streamed} != {calls_plain}")
    if parse_tool_calls(json.dumps({"tool_calls": [
            {"name": n, "arguments": a} for n, a in calls_plain]}), [STRUCT_TOOL["function"]]) is None:
        raise AssertionError("the calls do not parse back")
    out["tool_calls"] = [{"name": n, "arguments": a} for n, a in calls_plain]
    out["tool_prompt_tokens"] = t["usage"]["prompt_tokens"]
    # 4. n = 3, seeded: choices 0, 1 and 2; choice 0 is the n = 1 answer
    fan = {"prompt": "the quick brown fox", "temperature": 0.8, "seed": 2024, "max_tokens": 16}
    f3 = _json_post(port, "/v1/completions", {**fan, "n": 3}, key)
    f1 = _json_post(port, "/v1/completions", fan, key)
    idx = [c["index"] for c in f3["choices"]]
    if idx != [0, 1, 2] or f1["choices"][0]["text"] != f3["choices"][0]["text"]:
        raise AssertionError(f"n = 3: {idx}, {f3['choices']} against {f1['choices']}")
    out["n3_distinct_texts"] = len({c["text"] for c in f3["choices"]})
    # the decode rate at B = 1: the seeded schema request (its states seen
    # before) and an unconstrained one of as many tokens
    rates = {}
    for label, body in (("constrained", sampled),
                        ("unconstrained", {"messages": msgs, "temperature": 0,
                                           "max_tokens": n_schema, "logit_bias": ban})):
        t_first, t_last, usage, _ = _stream(port, "/v1/chat/completions", body, key)
        rates[label] = round((usage["completion_tokens"] - 1) / (t_last - t_first), 2)
    out["decode_tok_s_b1"] = rates
    out["decode_tokens_b1"] = n_schema
    return out


def _prefix_reuse(torch, engine, port, key) -> tuple[dict, dict]:
    """Phase item 5 on a fresh engine with the prefix cache on: tail A cold,
    tail B reusing the shared system prompt (its last position's logits
    kept for the cold check), the other slots seeded, the 4-request load at
    multi_step 4 while B's slot sits free, then B again."""
    from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
    prompts = [SYSTEM_PROMPT + t for t in TAILS]
    rows, emitted = [], []
    prefill, emit_token = engine._prefill, engine._emit_token

    def spy_prefill(b, ids):
        tok, row = prefill(b, ids)
        rows.append((list(ids), row.float().clone()))
        return tok, row

    def spy_emit(b, token_id, *a, **k):
        emitted.append(token_id)
        return emit_token(b, token_id, *a, **k)

    engine._prefill, engine._emit_token = spy_prefill, spy_emit
    out, toks = {}, {}
    try:
        for label, prompt in zip(("cold", "reuse"), prompts):
            emitted.clear()
            r0 = engine.total_prefix_reused
            t0 = time.time()
            t_first, _, usage, _ = _stream(port, "/v1/completions", {
                "prompt": prompt, "max_tokens": 16, "temperature": 0}, key)
            out[f"ttft_{label}_s"] = round(t_first - t0, 4)
            out[f"reused_{label}"] = engine.total_prefix_reused - r0
            toks[label] = list(emitted)
        ids_b = engine.tokenizer.encode(prompts[1])
        row_b = next(r for i, r in rows if i == ids_b)
        # seed the four other slots with the load's prompts while B's slot
        # is busy (submitted first, so it takes B's claim), so the load's
        # requests then each find their own slot
        greedy = SamplingParams(temperature=0.0, max_tokens=16)
        queues = [engine.submit(p, greedy)[1] for p in (prompts[1], *DISPATCH_PROMPTS)]
        seeded = []
        for q in queues:
            evs = [q.get(timeout=600)]
            while not evs[-1].finished:
                evs.append(q.get(timeout=600))
            seeded.append([e.token_id for e in evs])
        b_slot = next(b for b, s in enumerate(engine.slots)
                      if s.cached_ids[:len(ids_b)] == ids_b)
        claim = list(engine.slots[b_slot].cached_ids)
        c0 = engine.continuations
        t0 = time.time()
        res = _completions(port, key, [{"prompt": p, "max_tokens": 64, "temperature": 0}
                                       for p in DISPATCH_PROMPTS])
        wall = time.time() - t0
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in res)
        if engine.slots[b_slot].cached_ids != claim or engine.continuations - c0 <= 0:
            raise AssertionError("B's claim was taken, or the load never pipelined")
        emitted.clear()
        r0 = engine.total_prefix_reused
        _stream(port, "/v1/completions", {"prompt": prompts[1], "max_tokens": 16,
                                          "temperature": 0}, key)
        again = list(emitted)
        reused_again = engine.total_prefix_reused - r0
    finally:
        engine._prefill, engine._emit_token = prefill, emit_token
    if out["reused_cold"] != 0 or out["reused_reuse"] < len(engine.tokenizer.encode(SYSTEM_PROMPT)) - 1:
        raise AssertionError(f"prefix reuse: {out}")
    if again != toks["reuse"] or seeded[0] != toks["reuse"] or reused_again != len(ids_b) - 1:
        raise AssertionError(f"B after the load: {again} ({reused_again} reused) against "
                             f"{toks['reuse']}; seeded {seeded[0]}")
    out.update({"prompt_tokens": [len(engine.tokenizer.encode(p)) for p in prompts],
                "prefix_tokens_reused": out.pop("reused_reuse"),
                "load_tokens": ntok, "load_tok_s": round(ntok / wall, 2),
                "load_continuations": engine.continuations - c0,
                "b_after_load_equal": True, "b_after_load_reused": reused_again})
    return out, {"ids": ids_b, "row": row_b, "toks": toks["reuse"]}


def phase_structured(torch, engine, card):
    """Grammar-constrained decoding, tool calls, ``n > 1`` and the slot
    prefix cache through the port's server, on the loaded Q4_K_M engine
    with multi_step 4. First on four cold slots (the prefix cache off, so
    repeated prompts compare cold runs): json_schema answers at temperature
    0 (every dispatch and mask flush under the sync debug mode) and 0.8,
    EOG banned; a json_object answer cut at 16 tokens; a forced tool call
    non-streamed and streamed; n = 3 against n = 1; the constrained decode
    rate at B = 1 beside the unconstrained one. Then on five slots with the
    prefix cache on: a cold prompt of about 700 tokens, one sharing its
    system prompt (TTFT of both, the reused one's last logits against a cold
    run), the 4-request load while that slot sits free, and the prompt
    again. The masked sampler on the card against the CPU; the trie's build
    time, each new state's mask time and the state count. Two launch
    windows."""
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    paths, sync_errors = [], []
    with _host_costs() as costs:
        launches: dict[str, int] = {}
        with kv_engine(torch, engine, EngineConfig(max_slots=4, ctx=1024, multi_step=4,
                                                   prefix_cache=False)):
            engine.dispatches = engine.continuations = 0
            try:
                with serving(torch, engine, launches) as (port, key):
                    out = _structured_requests(torch, engine, port, key, sync_errors)
            except Exception as e:
                if sync_errors:
                    raise AssertionError(f"a dispatch waited for the card: {sync_errors}") from e
                raise
        paths.append(launches)
        trie = engine._token_trie
        states = sum(len(c[0]) for c in trie._mask_caches.values())
        reuse_launches: dict[str, int] = {}
        with kv_engine(torch, engine, EngineConfig(max_slots=5, ctx=1024, multi_step=4)):
            engine.dispatches = engine.continuations = 0
            with serving(torch, engine, reuse_launches) as (port, key):
                reuse, b = _prefix_reuse(torch, engine, port, key)
        paths.append(reuse_launches)
    if sync_errors:
        raise AssertionError(f"a dispatch waited for the card: {sync_errors}")
    for what, counts in (("structured", launches), ("structured prefix", reuse_launches)):
        _check_launches(what, counts, ("quant_matmul_4bit", "quant_matmul_8bit",
                                       "flash_attention", "quant_matmul_4bit_tc",
                                       "flash_attention_tc"))
    # the reused request against a cold run of the same prompt, fed its tokens
    ref, _ = _greedy_run(torch, engine, b["ids"], len(b["toks"]) - 1, feed=b["toks"])
    _check_logits(torch, engine, ref)
    errs, agree = _compare([b["row"]], [ref[0]])
    gaps = [((lg.max() - lg[t]) / lg.abs().max()).item() for lg, t in zip(ref, b["toks"])]
    if not max(gaps) <= LOGITS_TOL:
        raise AssertionError(f"reused request: a token below the cold run's max by {max(gaps)}")
    reuse.update({"reuse_logits_rel_err": errs[0], "logits_tol": LOGITS_TOL,
                  "reuse_greedy_agree": sum(int(lg.argmax()) == t
                                            for lg, t in zip(ref, b["toks"])),
                  "reuse_greedy_steps": len(b["toks"]), "reuse_token_gap_max": max(gaps)})
    mask_s = sorted(costs["mask_s"])
    emit({"phase": "structured", "ok": True, "nvidia_smi": card, **out, **reuse,
          "trie_build_s": [round(x, 4) for x in costs["trie_s"]],
          "grammar_states": states, "new_state_masks": len(mask_s),
          "mask_s_median": round(statistics.median(mask_s), 5) if mask_s else None,
          "mask_s_max": round(mask_s[-1], 5) if mask_s else None,
          "mask_s_total": round(sum(mask_s), 4),
          "masked_sampler": _masked_sampler(torch, engine.cfg.vocab_size),
          "launches": {"cold": sum(launches.values()), "prefix": sum(reuse_launches.values())}})
    return paths


def _check_launches(what, launches, want, absent=()):
    """Every kernel of ``want`` launched, none of ``absent``, no plain
    version."""
    bad = [n for n in want if launches.get(n, 0) <= 0] + \
        [n for n in absent if launches.get(n, 0)] + \
        [n for n in launches if n.endswith(".plain")]
    if bad:
        raise AssertionError(f"{what}: launches {launches}")


@contextlib.contextmanager
def mm_variant(name):
    os.environ["LGT_MM_VARIANT"] = name
    try:
        yield
    finally:
        os.environ.pop("LGT_MM_VARIANT", None)


@contextlib.contextmanager
def shadowed(torch, wrapper, errs):
    """Each call of the matmul wrapper ``wrapper`` also runs its plain
    version on the same arguments, and ``errs`` gets the error of the
    kernel's output relative to the plain output's scale
    (:func:`shadowed_live` with no limit)."""
    by_name: dict[str, list] = {}
    with shadowed_live(torch, (wrapper,), by_name, {"left": float("inf")}):
        yield
    errs.extend(by_name.get(wrapper, ()))


def _variant_forward(torch, engine, label, want, absent=(), shadow=None, tol=LOGITS_TOL,
                     prompt=PROMPT):
    """A prefill of ``prompt`` and 16 greedy steps through the kernels
    (launches counted) held against the plain versions fed the same tokens;
    with ``shadow`` (a matmul wrapper's name) the same 17 steps again, every
    call of that wrapper held to MATMUL_TOL of its plain version on the same
    inputs."""
    from llama_gguf_inference_tpu_torch.ops import _build
    ids = engine.tokenizer.encode(prompt)
    _build.reset_launches()
    t0 = time.time()
    k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
    t1 = time.time()
    launches = dict(_build.LAUNCHES)
    _check_launches(label, launches, want, absent)
    out = {}
    if shadow:
        errs: list[float] = []
        with shadowed(torch, shadow, errs):
            _greedy_run(torch, engine, ids, 16, feed=k_toks)
        if not errs or max(errs) > MATMUL_TOL:
            raise AssertionError(f"{label}: {shadow} against its plain version: {errs}")
        out = {"shadow_calls": len(errs), "shadow_rel_err_max": max(errs)}
    with plain_versions():
        p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
    _check_logits(torch, engine, k_logits)
    errs, agree = _compare(k_logits, p_logits, tol)
    return launches, {"steps_compared": len(errs), "argmax_agree": agree,
                      "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
                      "logits_tol": tol, **out, "kernel_path_s": round(t1 - t0, 3)}


def _prompt_of(engine, rows: int) -> str:
    """PROMPT repeated until it is at least ``rows`` tokens long."""
    prompt = PROMPT
    while len(engine.tokenizer.encode(prompt)) < rows:
        prompt += " " + PROMPT
    return prompt


def phase_variants(torch, engine):
    """The Q4_K_M engine under each LGT_MM_VARIANT: its Q4_K projections
    through that variant's decode kernel (never fsplit's, decode or
    tensor-core; the body's own tensor-core kernel only for a prompt of at
    least its threshold's rows: int8's prompt is PROMPT repeated to
    INT8_TC_MIN_ROWS tokens, so its prefill takes the tensor-core kernel),
    the Q6_K head through the 8-bit kernel, held against the plain versions
    over 17 steps; then three greedy requests through the server. Under
    each, then one 512-token chunk through that body's tensor-core kernel
    (int8: its logits held to INT8_LOGITS_TOL and every call shadowed by its
    plain version). Each run is one launch window."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    kernel = {"base": qm.NAME_4BIT_BASE, "xsum": qm.NAME_4BIT_XSUM,
              "split": qm.NAME_4BIT_SPLIT, "int8": qm.NAME_4BIT_INT8}
    chunk_kernel = {"base": qm.NAME_4BIT_BASE_TC, "int8": qm.NAME_4BIT_INT8_TC,
                    "xsum": qm.NAME_4BIT_XSUM_TC, "split": qm.NAME_4BIT_SPLIT_TC}
    tc_rows = {var: qm.INT8_TC_MIN_ROWS if var == "int8" else qm.LOWBIT_TC_MIN_ROWS
               for var in chunk_kernel}
    paths = []
    for var in VARIANTS:
        # the prompt's prefill takes the body's tensor-core kernel from its
        # threshold (the decode steps never do); the served prompts' prefill,
        # padded to the engine's 16-row bucket, may take it too (int8: must,
        # where that bucket reaches its threshold)
        prompt = _prompt_of(engine, qm.INT8_TC_MIN_ROWS) if var == "int8" else PROMPT
        n_prompt = len(engine.tokenizer.encode(prompt))
        tc = [chunk_kernel[var]] if var in chunk_kernel and n_prompt >= tc_rows[var] else []
        want = (kernel[var], qm.NAME_8BIT, *tc)
        served_want = want
        if var == "int8":
            served_rows = engine._bucket(len(engine.tokenizer.encode("request 0: the lazy dog")))
            served_want = (kernel[var], qm.NAME_8BIT,
                           *(tc if served_rows >= qm.INT8_TC_MIN_ROWS else ()))
        served_absent = (qm.NAME_4BIT, qm.NAME_4BIT_TC, qm.NAME_DEQUANT)
        absent = (*served_absent, *(k for k in chunk_kernel.values() if k not in tc))
        with mm_variant(var):
            launches, out = _variant_forward(
                torch, engine, f"variant {var}", want, absent, shadow=kernel[var],
                tol=INT8_LOGITS_TOL if var == "int8" else LOGITS_TOL, prompt=prompt)
            served: dict[str, int] = {}
            with serving(torch, engine, served) as (port, key):
                t0 = time.time()
                results = _completions(port, key, [
                    {"prompt": f"request {i}: the lazy dog", "max_tokens": 16,
                     "temperature": 0} for i in range(3)])
                wall = time.time() - t0
        _check_launches(f"variant {var} serve", served, served_want, served_absent)
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in results)
        emit({"phase": "variants", "ok": True, "variant": var, "kernel": kernel[var],
              "prompt_tokens": n_prompt, **out,
              "launches": launches, "served_tokens": ntok,
              "served_tok_s": round(ntok / wall, 2), "served_launches": served})
        paths += [launches, served]
        if var in chunk_kernel:
            with mm_variant(var):
                paths.append(_prefill_chunk(
                    torch, engine, f"variant {var} chunk", chunk_kernel[var],
                    tol=INT8_LOGITS_TOL if var == "int8" else LOGITS_TOL,
                    shadow=kernel[var] if var == "int8" else None))
    return paths


@contextlib.contextmanager
def shared_weights(loaded):
    """Engines built while this is open take the weights ``loaded`` (an
    engine) holds, rather than reading and repacking its file again, when
    they ask for that file in the same residency without an adapter; the
    file's metadata is still read."""
    from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
    from llama_gguf_inference_tpu_torch.runtime import engine as eng_mod
    real, path = eng_mod.load_model, loaded.model_path

    def load(model_path, device, fuse=True, mode="quant", lora_path="", lora_scale=1.0,
             stats=None):
        if model_path != path or mode != "quant" or lora_path or not fuse:
            return real(model_path, device, fuse=fuse, mode=mode, lora_path=lora_path,
                        lora_scale=lora_scale, stats=stats)
        return loaded.cfg, loaded.params, GGUFReader(model_path)

    with _patched(eng_mod, "load_model", load):
        yield


def phase_serve_paged(torch, loaded):
    """A q8_0 paged engine from the environment (``build_engine_from_env``,
    sharing the loaded engine's weights: ``shared_weights``): 4 slots over 4
    pages of 1024 (a contiguous slot's share is 1024). One streamed request
    of about 1,500 prompt tokens and three short ones at once need 5 pages,
    so one of them waits at the head of the line until pages come back. The
    prompts' chunks run the paged q8_0 tensor-core flash kernel, the decode
    steps its CUDA-core kernel. Its ``load_s`` is the engine's construction
    from the environment without a load of the weights."""
    from llama_gguf_inference_tpu_torch.serving.openai_server import build_engine_from_env
    os.environ.update({"MODEL_PATH": loaded.model_path, "MAX_SLOTS": "4", "CTX": "4096",
                       "KV_CACHE_TYPE": "q8_0", "KV_LAYOUT": "paged",
                       "KV_PAGE_SIZE": "1024"})
    t0 = time.time()
    with shared_weights(loaded):
        engine = build_engine_from_env()
    torch.cuda.synchronize()
    load_s = time.time() - t0
    alloc = engine.alloc
    if alloc is None or alloc.free_pages != 4 or engine.cache.max_seq != 4096:
        raise AssertionError("expected a paged cache of 4 pages of 1024")
    words = "the quick brown fox jumps over the lazy dog and".split()
    text = " ".join(words[i % len(words)] for i in range(1500))
    n_long = len(engine.tokenizer.encode(text))
    if not 1024 < n_long < 2000:
        raise AssertionError(f"long prompt has {n_long} tokens")
    launches: dict[str, int] = {}
    out = {"load_s": round(load_s, 3), "long_prompt_tokens": n_long}
    waiting_max = [0]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            waiting_max[0] = max(waiting_max[0], len(engine._waiting))
            time.sleep(0.002)

    try:
        with serving(torch, engine, launches) as (port, key):
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            long_res = {}

            def long_req():
                t = time.time()
                long_res["r"] = (t, *_stream(port, "/v1/completions",
                                             {"prompt": text, "max_tokens": 32,
                                              "temperature": 0}, key))

            t0 = time.time()
            th = threading.Thread(target=long_req)
            th.start()
            short = _completions(port, key, [
                {"prompt": f"request {i}: the lazy dog", "max_tokens": 32,
                 "temperature": 0} for i in range(3)])
            th.join(600)
            wall = time.time() - t0
            stop.set()
            watcher.join(5)
            if "r" not in long_res:
                raise AssertionError("the long request did not finish")
            t_sent, t_first, t_last, usage, _ = long_res["r"]
    finally:
        stop.set()
        engine.stop()
    if usage["prompt_tokens"] != n_long:
        raise AssertionError(f"long prompt: {usage['prompt_tokens']} != {n_long} tokens")
    if waiting_max[0] < 1:
        raise AssertionError("no request waited for pages")
    if alloc.free_pages != 4:
        raise AssertionError(f"{alloc.free_pages} of 4 pages free after the run")
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    name = KV_KINDS["paged_q8_0"][2]
    _check_launches("serve-paged", launches, (name, fa.NAME_PAGED_Q8_TC))
    n_gen = usage["completion_tokens"]
    ntok = n_gen + sum(r[1]["usage"]["completion_tokens"] for r in short)
    out.update({"long_prompt_usage_tokens": usage["prompt_tokens"],
                "long_ttft_s": round(t_first - t_sent, 4),
                "long_completion_tokens": n_gen,
                "long_decode_tok_s": round((n_gen - 1) / (t_last - t_first), 2),
                "max_waiting": waiting_max[0], "pages_free_after": alloc.free_pages,
                "aggregate_tok_s": round(ntok / wall, 2), "wall_s": round(wall, 3)})
    emit({"phase": "serve-paged", "ok": True, **out, "launches": launches})
    return launches


def _resident_bytes(torch, node) -> int:
    """Bytes of every tensor in a parameter tree (weights as stored), each
    tensor once (a tied head shares the embedding's)."""
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in _tensors_of(torch, node, [])}.values())


def phase_q2k(torch):
    """The 8B Q2_K model under the mixed scale layout: load, a prefill and
    16 greedy steps through the kernels against the plain versions fed the
    same tokens (launches counted over the kernel run), then served, then
    one 512-token prefill chunk through the 2-bit tensor-core kernel."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    os.environ["LGT_SCALE_LAYOUT"] = "mixed"
    t0 = time.time()
    path = cached_model("8b", seed=0, quant="q2_k")
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024, prefix_cache=False),
                             device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    try:
        p = engine.params
        w = p["layers"][0]["ffn_gateup"]
        if (w.fmt, w.bits, w.min_size) != ("q2_k", 2, 256):
            raise AssertionError(f"gate+up loaded as {w.fmt}, {w.bits} bits, "
                                 f"min_size {w.min_size}")
        blocks = _resident_bytes(torch, p["layers"])
        emit({"phase": "q2k-load", "ok": True, "synth_s": round(t1 - t0, 3),
              "load_s": round(t2 - t1, 3), "gguf_gb": os.path.getsize(path) / 1e9,
              "scale_layout": "mixed", "resident_weights_gb": _resident_bytes(torch, p) / 1e9,
              "resident_block_weights_gb": blocks / 1e9,
              "resident_head_gb": _resident_bytes(torch, p["output"]) / 1e9,
              "resident_embedding_gb": _resident_bytes(torch, p["tok_embd"]) / 1e9,
              "device_gb": torch.cuda.memory_allocated() / 1e9})
        ids = engine.tokenizer.encode(PROMPT)
        _build.reset_launches()
        t0 = time.time()
        k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
        t1 = time.time()
        launches = dict(_build.LAUNCHES)
        if launches.get(qm.NAME_2BIT, 0) <= 0 or any(n.endswith(".plain") for n in launches):
            raise AssertionError(f"q2k kernel run: launches {launches}")
        with plain_versions():
            p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
        _check_logits(torch, engine, k_logits)
        errs, agree = _compare(k_logits, p_logits)
        emit({"phase": "q2k-forward", "ok": True, "prompt_tokens": len(ids),
              "steps_compared": len(errs), "argmax_agree": agree,
              "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
              "kernel_path_s": round(t1 - t0, 3), "launches": launches})
        served = phase_serve(torch, engine, "q2k-serve")
        if served.get(qm.NAME_2BIT, 0) <= 0 or any(n.endswith(".plain") for n in served):
            raise AssertionError(f"q2k serve: launches {served}")
        chunk = _prefill_chunk(torch, engine, "q2k-chunk", qm.NAME_2BIT_TC)
        base = _q2k_base(torch, engine)
    finally:
        engine.stop()
        os.environ.pop("LGT_SCALE_LAYOUT", None)
    return [launches, served, chunk, *base]


def _as_flat(w):
    """A mixed-layout QuantLinear relaid flat on the card: the same codes and
    scale, the min side expanded per sub-block in the scale's order (the
    decode's own ``_min_sub_mixed``, the f32 products ``flatten_repacked``
    forms)."""
    import dataclasses
    return dataclasses.replace(w, dmin=w._min_sub_mixed().contiguous(), mn=None,
                               min_size=0)


def _q2k_base(torch, engine):
    """``LGT_MM_VARIANT=base`` on the Q2_K engine: the mixed layout takes the
    dequantize path there (as ``matmul_xla`` in the JAX package), so two
    greedy steps show that; then its 2-bit weights are relaid flat and the
    17-step forward runs through the base body's 2-bit decode kernel against
    the plain versions, and one 512-token chunk through its tensor-core
    kernel."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    with mm_variant("base"):
        ids = engine.tokenizer.encode(PROMPT)
        _build.reset_launches()
        _greedy_run(torch, engine, ids, 2)
        mixed = dict(_build.LAUNCHES)
        _check_launches("q2k base, mixed", mixed, (qm.NAME_DEQUANT, qm.NAME_8BIT),
                        (qm.NAME_2BIT, qm.NAME_2BIT_TC, qm.NAME_LOWBIT_BASE))
        for layer in engine.params["layers"]:
            for n, w in layer.items():
                if getattr(w, "min_size", 0):
                    layer[n] = _as_flat(w)
        launches, out = _variant_forward(torch, engine, "q2k base, flat",
                                         (qm.NAME_LOWBIT_BASE, qm.NAME_8BIT),
                                         (qm.NAME_2BIT, qm.NAME_2BIT_TC, qm.NAME_DEQUANT,
                                          qm.NAME_LOWBIT_BASE_TC),
                                         shadow=qm.NAME_LOWBIT_BASE)
        emit({"phase": "q2k-base", "ok": True, "mixed_launches": mixed, **out,
              "launches": launches})
        chunk = _prefill_chunk(torch, engine, "q2k-base-chunk", qm.NAME_LOWBIT_BASE_TC)
    return [launches, chunk]


def phase_q5k(torch):
    """The 8B Q5_K model under the default layout (compact: u8 sc and mn per
    32): load, resident bytes, a prefill and 16 greedy steps through the
    kernels (the 8-bit one with its min term) against the plain versions fed
    the same tokens, then served."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    t0 = time.time()
    path = cached_model("8b", seed=0, quant="q5_k")
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024, prefix_cache=False),
                             device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    try:
        p = engine.params
        w = p["layers"][0]["ffn_gateup"]
        if (w.fmt, w.bits, w.sc is None, w.dmin is None) != ("q5_k", 8, False, False):
            raise AssertionError(f"gate+up loaded as {w.fmt}, {w.bits} bits")
        emit({"phase": "q5k-load", "ok": True, "synth_s": round(t1 - t0, 3),
              "load_s": round(t2 - t1, 3), "gguf_gb": os.path.getsize(path) / 1e9,
              "scale_layout": "auto (compact)",
              "resident_weights_gb": _resident_bytes(torch, p) / 1e9,
              "resident_block_weights_gb": _resident_bytes(torch, p["layers"]) / 1e9,
              "resident_head_gb": _resident_bytes(torch, p["output"]) / 1e9,
              "resident_embedding_gb": _resident_bytes(torch, p["tok_embd"]) / 1e9,
              "device_gb": torch.cuda.memory_allocated() / 1e9})
        # a prompt of three times the others' length, so that its prefill rows
        # reach TC_MIN_ROWS and run the tensor-core kernel, and the decode
        # steps the decode kernel
        want = (qm.NAME_8BIT_MIN, qm.NAME_8BIT, qm.NAME_8BIT_MIN_TC)
        prompt = " ".join([PROMPT] * 3)
        if len(engine.tokenizer.encode(prompt)) < qm.TC_MIN_ROWS:
            raise AssertionError("the q5k prompt is shorter than TC_MIN_ROWS")
        launches, out = _variant_forward(torch, engine, "q5k", want, (qm.NAME_DEQUANT,),
                                         shadow=qm.NAME_8BIT, prompt=prompt)
        emit({"phase": "q5k-forward", "ok": True, **out, "launches": launches})
        served = phase_serve(torch, engine, "q5k-serve")
        _check_launches("q5k serve", served, want)
        chunk = _prefill_chunk(torch, engine, "q5k-chunk", qm.NAME_8BIT_MIN_TC)
        long_served = _long_prompt(torch, engine, "q5k-long-prompt",
                                   (qm.NAME_8BIT_MIN_TC, qm.NAME_DEQUANT, qm.NAME_8BIT_MIN),
                                   1152.69)
    finally:
        engine.stop()
    return [launches, served, chunk, long_served]


def _words(engine, n_max):
    """A prompt of the most repeated words whose encoding has at most
    ``n_max`` tokens, and that encoding."""
    words = "the quick brown fox jumps over the lazy dog and".split()
    lo, hi = 1, 4 * n_max
    while lo < hi:                      # the most words that fit
        mid = (lo + hi + 1) // 2
        text = " ".join(words[i % len(words)] for i in range(mid))
        if len(engine.tokenizer.encode(text)) <= n_max:
            lo = mid
        else:
            hi = mid - 1
    text = " ".join(words[i % len(words)] for i in range(lo))
    return text, engine.tokenizer.encode(text)


def _prefill_chunk(torch, engine, label, tc_name, tol=LOGITS_TOL, shadow=None):
    """One 512-token prefill chunk, launches counted over it: per layer, qkv,
    o and gate_up through the tensor-core kernel ``tc_name``, and ffn_down,
    whose 512 x 14336 activations pass the JAX package's gate
    (``LGT_MM_MAX_B``, ``LGT_MM_X_VMEM``), through the dequantize path, and
    the attention through the tensor-core flash kernel; the head's one row
    through the 8-bit decode kernel; no other matmul or flash body and no
    plain version. With ``shadow`` (a matmul wrapper's name) the chunk
    runs again, every call of that wrapper held to MATMUL_TOL of its plain
    version on the same inputs. Its logits are then held to ``tol`` of the
    plain versions' fed the same tokens."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    dev = engine.device
    _, ids = _words(engine, 600)
    ids = ids[:512]
    if len(ids) != 512:
        raise AssertionError(f"the chunk's prompt has {len(ids)} tokens")

    def chunk():
        with torch.inference_mode():
            lg = forward(engine.params, engine.cfg, torch.tensor([ids], dtype=torch.int32,
                                                                 device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         KVCache.zeros(engine.cfg, 1, 1024, dev),
                         logits_at=torch.tensor([511], device=dev))[0, 0]
        torch.cuda.synchronize()
        return lg

    _build.reset_launches()
    t0 = time.time()
    k_logits = chunk()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    layers = engine.cfg.n_layers
    matmuls = {n: c for n, c in launches.items() if n.startswith("quant_matmul")}
    flash = {n: c for n, c in launches.items() if n.startswith("flash")}
    want = {tc_name: 3 * layers, qm.NAME_DEQUANT: layers, qm.NAME_8BIT: 1}
    want_flash = {fa.NAME_TC: layers}
    if matmuls != want or flash != want_flash or any(n.endswith(".plain") for n in launches):
        raise AssertionError(f"{label} 512-token chunk: launches {launches}, want {want} "
                             f"and {want_flash}")
    out = {}
    if shadow:
        shadow_errs: list[float] = []
        with shadowed(torch, shadow, shadow_errs):
            chunk()
        if len(shadow_errs) != 3 * layers or max(shadow_errs) > MATMUL_TOL:
            raise AssertionError(f"{label}: {shadow} against its plain version: {shadow_errs}")
        out = {"shadow_calls": len(shadow_errs), "shadow_rel_err_max": max(shadow_errs)}
    with plain_versions():
        p_logits = chunk()
    _check_logits(torch, engine, [k_logits])
    errs, agree = _compare([k_logits], [p_logits], tol)
    emit({"phase": label, "ok": True, "rows": 512, "logits_rel_err": errs[0],
          "logits_tol": tol, "argmax_agree": agree, **out,
          "first_chunk_wall_s": round(wall, 4), "launches": launches})
    return launches


def _long_prompt(torch, engine, label, want, chunk_ms_before):
    """Three streamed completions of a prompt of at most 512 tokens (one
    prefill chunk) through the server, one after another: the time to the
    first token of each, beside ``chunk_ms_before``, what ``tools/profile.py``
    measured for one 512-token chunk of this model before its prefill ran a
    tensor-core kernel (PERF.md §5, NVIDIA H100 80GB HBM3, 700 W). Launches
    counted over the three; every kernel of ``want`` must run."""
    text, ids = _words(engine, 512)
    launches: dict[str, int] = {}
    ttft = []
    with serving(torch, engine, launches) as (port, key):
        for _ in range(3):
            t0 = time.time()
            t_first, _, usage, _ = _stream(port, "/v1/completions",
                                           {"prompt": text, "max_tokens": 4,
                                            "temperature": 0}, key)
            ttft.append(round(t_first - t0, 4))
            if usage["prompt_tokens"] != len(ids):
                raise AssertionError(f"long prompt: {usage['prompt_tokens']} != {len(ids)}")
    _check_launches(label, launches, want)
    emit({"phase": label, "ok": True, "prompt_tokens": len(ids), "ttft_s": ttft,
          "prefill_chunk_ms_before": chunk_ms_before, "launches": launches})
    return launches


def phase_q4k_prefill(torch, engine):
    """The Q4_K_M engine's 512-token chunk through the 4-bit tensor-core
    kernel, and the served time to the first token of a 512-token prompt
    (beside the 521.71 ms that ``tools/profile.py`` measured for one chunk
    of this model when its prefill ran the decode kernel, PERF.md §5)."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    chunk = _prefill_chunk(torch, engine, "q4k-chunk", qm.NAME_4BIT_TC)
    served = _long_prompt(torch, engine, "q4k-long-prompt",
                          (qm.NAME_4BIT_TC, qm.NAME_DEQUANT, qm.NAME_4BIT), 521.71)
    return [chunk, served]


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def shadowed_live(torch, names, errs, window):
    """Inside a launch window: while ``window["left"]`` > 0, each call of
    the wrappers ``names`` (matmul wrappers of ``ops.quant_matmul``, flash
    wrappers of ``ops.flash_attention``) also runs its plain version on the
    same arguments, ``errs[name]`` gets the kernel's error relative to the
    plain output's scale, and ``window["left"]`` counts down. The plain
    launches are taken back out of the counters, so the window shows the
    kernels' launches alone."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    saved = {}
    for name in names:
        mod = fa if name.startswith("flash") else qm
        real, plain = getattr(mod, name), getattr(mod, name + "_plain")

        def both(*args, _real=real, _plain=plain, _name=name):
            y = _real(*args)
            if window["left"] > 0:
                window["left"] -= 1
                n_plain = _build.LAUNCHES.get(_name + ".plain", 0)
                want = _plain(*args)
                if n_plain:
                    _build.LAUNCHES[_name + ".plain"] = n_plain
                else:
                    _build.LAUNCHES.pop(_name + ".plain", None)
                errs.setdefault(_name, []).append(
                    ((y.float() - want.float()).abs().max()
                     / (want.float().abs().max() + 1e-12)).item())
            return y
        saved[name] = (mod, real)
        setattr(mod, name, both)
    try:
        yield
    finally:
        for name, (mod, real) in saved.items():
            setattr(mod, name, real)


SHIFT_KINDS = {"bf16": "flash_attention", "q8_0": "flash_attention_q8"}
SHIFT_CTX = 128                # each slot's positions in the ctx-shift phase
SHIFT_TOKENS = 144             # tokens a request generates there
SHIFT_PROMPTS = (PROMPT, "request 2: " + PROMPT + ", and then " + PROMPT)
SHIFT_LONG = (1024, 1000, 32)  # the bf16 run at a full slot: ctx, prompt, tokens


def _slot_rows(cache, b):
    """Slot b's rows of every cache field, on the host."""
    import dataclasses
    return {f.name: [t[b].to("cpu", copy=True) for t in getattr(cache, f.name)]
            for f in dataclasses.fields(cache)}


def _shift_vs_cpu(torch, cache, cfg, b, keep, discard, before) -> dict:
    """Slot b's rows after the card's shift against the same shift of a
    one-slot copy of its rows taken before, run on the CPU: V, every row
    below ``keep`` and the other positions' K scales as the ctx-shift tests
    hold them; K values (bf16) or codes (q8_0) equal but for a few one
    apart where the f32 rotation rounds differently."""
    import dataclasses

    from llama_gguf_inference_tpu_torch.models.llama import shift_cache_slot, with_sink
    cpu = type(cache)(**{f: [with_sink(t[None]) for t in rows] for f, rows in before.items()})
    shift_cache_slot(cpu, cfg, 0, keep, discard)
    near = total = 0
    for f in (x.name for x in dataclasses.fields(cache)):
        for got_t, want_t, old in zip(getattr(cache, f), getattr(cpu, f), before[f]):
            got, want = got_t[b].cpu(), want_t[0]
            if not torch.equal(got[:, :keep], old[:, :keep]):
                raise AssertionError(f"ctx shift: {f} changed below keep")
            if f.startswith("v"):
                if not torch.equal(got, want):
                    raise AssertionError(f"ctx shift: {f} differs from the CPU's")
                continue
            if f == "k_s":
                if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
                    raise AssertionError("ctx shift: K scales differ from the CPU's")
                continue
            if got.dtype == torch.bfloat16:
                # one bf16 ulp of the value, or where the rotation cancels to
                # near 0, an f32 rounding of the row's scale (the card's FMAs)
                diff = (got.float() - want.float()).abs()
                bad = diff > 2 ** -7 * want.float().abs() + 2 ** -20 * want.float().abs().max()
            else:
                diff = (got.int() - want.int()).abs()
                bad = diff > 1
            if bool(bad.any()):
                raise AssertionError(f"ctx shift: {f} off by {diff.max().item()}")
            near += int((diff > 0).sum())
            total += diff.numel()
    if near > 0.01 * total:
        raise AssertionError(f"ctx shift: {near} of {total} K values one apart")
    return {"k_one_apart": near, "k_compared": total}


def _time_shift(torch, engine, timer, kind) -> float:
    """Median ms of one shift of a slot full to 1024 positions (4 slots of
    1024, the decode phases' cache), keep 512, discard 256."""
    from llama_gguf_inference_tpu_torch.models.llama import shift_cache_slot
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, make_kv_cache
    cache, _ = make_kv_cache(engine.cfg, EngineConfig(max_slots=4, ctx=1024, kv_dtype=kind),
                             engine.device)
    with torch.inference_mode():
        ms = timer(lambda: shift_cache_slot(cache, engine.cfg, 1, 512, 256), iters=5)
    del cache
    return ms


def _shift_run(torch, engine, kind, ctx, prompts, tokens, min_shifts) -> dict:
    """Greedy requests ``prompts`` (text or ids) on four slots of ``ctx``
    positions at multi_step 4 with a ``kind`` cache, every EOG token banned
    (``logit_bias``), each generating ``tokens``: the engine shifts instead
    of finishing, at least ``min_shifts`` times (``stats()``). The first
    shift is held against the same shift of a copy of the slot's rows on
    the CPU; the matmul and that kind's flash calls of the two decode steps
    after it are shadowed by their plain versions on the same inputs. One
    launch window."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime import engine as eng_mod
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
    fa_name = SHIFT_KINDS[kind]
    ban = {int(t): -1e9 for t in engine.tokenizer.eog_ids}
    layers = engine.cfg.n_layers
    ecfg = EngineConfig(max_slots=4, ctx=ctx, kv_dtype=kind, multi_step=4,
                        ctx_shift=True, prefix_cache=False)
    real_shift = eng_mod.shift_cache_slot
    first: dict = {}
    window = {"left": 0}
    errs: dict[str, list] = {}

    def shift(cache, cfg, b, keep, discard):
        if first:
            return real_shift(cache, cfg, b, keep, discard)
        before = _slot_rows(cache, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_shift(cache, cfg, b, keep, discard)
        torch.cuda.synchronize()
        first.update(first_shift_ms=round((time.perf_counter() - t0) * 1e3, 3), keep=keep,
                     discard=discard, **_shift_vs_cpu(torch, cache, cfg, b, keep,
                                                      discard, before))
        # the two decode steps after it: 4 matmuls a layer and the head,
        # one flash call a layer, each step
        window["left"] = 2 * (5 * layers + 1)
        return None

    t0 = time.time()
    with kv_engine(torch, engine, ecfg), _patched(eng_mod, "shift_cache_slot", shift), \
            shadowed_live(torch, (qm.NAME_4BIT, qm.NAME_8BIT, fa_name), errs, window):
        shifts0 = engine.total_ctx_shifts
        _build.reset_launches()
        outs = [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=tokens,
                                                logit_bias=ban))[1]
                for p in prompts]
        while engine.step():
            pass
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        shifts = engine.stats()["ctx_shifts"] - shifts0
    wall = time.time() - t0
    for out in outs:
        evs = []
        while not out.empty():
            evs.append(out.get_nowait())
        if len(evs) != tokens or evs[-1].finish_reason != "length":
            raise AssertionError(f"ctx-shift {kind} at {ctx}: {len(evs)} tokens, "
                                 f"ended {evs[-1] if evs else None}")
    if shifts < min_shifts or not first:
        raise AssertionError(f"ctx-shift {kind} at {ctx}: {shifts} shifts")
    bad = {n: max(e) for n, e in errs.items()
           if max(e) > (FLASH_TOL if n.startswith("flash") else MATMUL_TOL)}
    if set(errs) != {qm.NAME_4BIT, qm.NAME_8BIT, fa_name} or bad:
        raise AssertionError(f"ctx-shift {kind} at {ctx}: shadowed calls {errs}")
    _check_launches(f"ctx-shift {kind} at {ctx}", launches,
                    (qm.NAME_4BIT, qm.NAME_8BIT, fa_name, fa_name + "_tc"))
    return {"phase": "ctx-shift", "ok": True, "kind": kind, "ctx": ctx,
            "requests": len(prompts), "tokens_each": tokens, "ctx_shifts": shifts, **first,
            "shadow_calls": {n: len(e) for n, e in errs.items()},
            "shadow_rel_err_max": {n: max(e) for n, e in errs.items()},
            "wall_s": round(wall, 3), "launches": launches}


def phase_ctx_shift(torch, engine):
    """llama-server ``--ctx-shift`` on the loaded Q4_K_M engine
    (``_shift_run``): for a bf16 and a q8_0 cache, slots of SHIFT_CTX
    positions and two requests of SHIFT_TOKENS each, far past their slots
    (at least two shifts a run), each followed by the time of one shift of a
    full 1024-position slot; then bf16 at a full slot (SHIFT_LONG: a prompt
    near the slot's size, so a shift comes after a short generation and the
    shadowed decode kernels read up to 1024 keys)."""
    paths = []
    timer = Timer(torch)
    for kind in SHIFT_KINDS:
        line = _shift_run(torch, engine, kind, SHIFT_CTX, SHIFT_PROMPTS, SHIFT_TOKENS, 2)
        line["shift_ms_1024"] = round(_time_shift(torch, engine, timer, kind), 4)
        emit(line)
        paths.append(line["launches"])
    del timer
    ctx, rows, tokens = SHIFT_LONG
    ids = engine.tokenizer.encode(_prompt_of(engine, rows))[:rows]
    line = _shift_run(torch, engine, "bf16", ctx, [ids], tokens, 1)
    emit(line)
    paths.append(line["launches"])
    return paths


def _get(port, path, key):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("GET", path, headers={"Authorization": f"Bearer {key}"})
    r = conn.getresponse()
    out = json.loads(r.read())
    conn.close()
    if r.status != 200:
        raise AssertionError(f"{path}: {r.status} {out}")
    return out


def phase_slots(torch, engine):
    """llama-server's utility paths and slot files on the loaded Q4_K_M
    engine, served with the prefix cache on (4 slots of 1024) and
    ``SLOT_SAVE_PATH`` in a temporary directory: a prompt of about 100
    tokens cold, then again from its kept slot (the unsaved run); that slot
    saved, erased and restored; the prompt once more through
    ``/completion``, which must give the unsaved run's tokens from the
    restored rows. Each of the eight paths answers with its checked shape
    (``/infill`` from the model's FIM tokens). One launch window."""
    import tempfile

    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    text, ids = _words(engine, 100)
    tok = engine.tokenizer
    tmp = tempfile.mkdtemp(prefix="slots-")
    launches: dict[str, int] = {}
    out: dict = {"prompt_tokens": len(ids)}
    body = {"prompt": text, "max_tokens": 16, "temperature": 0}
    try:
        os.environ["SLOT_SAVE_PATH"] = tmp
        with kv_engine(torch, engine, EngineConfig(max_slots=4, ctx=1024, prefix_cache=True)), \
                serving(torch, engine, launches) as (port, key):
            cold = _json_post(port, "/v1/completions", body, key)["choices"][0]["text"]
            r0 = _get(port, "/props", key)["prefix_tokens_reused"]
            unsaved = _json_post(port, "/v1/completions", body, key)["choices"][0]["text"]
            props = _get(port, "/props", key)
            if props["prefix_tokens_reused"] - r0 != len(ids) - 1:
                raise AssertionError(f"slots: reuse {props['prefix_tokens_reused'] - r0}")
            slots = _get(port, "/slots", key)
            kept = [s for s in slots if s["prefix_cached_tokens"] > 0]
            if len(slots) != 4 or len(kept) != 1 or any(s["state"] for s in slots):
                raise AssertionError(f"slots: {slots}")
            b, n_kept = kept[0]["id"], kept[0]["prefix_cached_tokens"]
            saved = _json_post(port, f"/slots/{b}?action=save", {"filename": "slot.npz"}, key)
            erased = _json_post(port, f"/slots/{b}?action=erase", {}, key)
            if _get(port, "/slots", key)[b]["prefix_cached_tokens"] != 0:
                raise AssertionError("slots: erase left a claim")
            restored = _json_post(port, f"/slots/{b}?action=restore",
                                  {"filename": "slot.npz"}, key)
            if not saved["n_saved"] == erased["n_erased"] == restored["n_restored"] == n_kept:
                raise AssertionError(f"slots: {saved} {erased} {restored}")
            r1 = _get(port, "/props", key)["prefix_tokens_reused"]
            again = _json_post(port, "/completion", body, key)
            if again["choices"][0]["text"] != unsaved \
                    or _get(port, "/props", key)["prefix_tokens_reused"] - r1 != len(ids) - 1:
                raise AssertionError("slots: the restored slot did not give the unsaved run")
            plain_ids = tok.encode(text, add_bos=False)
            toks = _json_post(port, "/tokenize", {"content": text}, key)["tokens"]
            pieces = _json_post(port, "/tokenize", {"content": "hello world",
                                                    "with_pieces": True}, key)["tokens"]
            detok = _json_post(port, "/detokenize", {"tokens": ids}, key)["content"]
            tmpl = _json_post(port, "/apply-template", {"messages": [
                {"role": "user", "content": "hello world"}]}, key)["prompt"]
            sp = tok.special
            infill = _json_post(port, "/infill", {"input_prefix": "the quick", "input_suffix":
                                                  "lazy dog", "max_tokens": 8,
                                                  "temperature": 0}, key)
            n_infill = 4 + len(tok.encode("the quick", add_bos=False)) \
                + len(tok.encode("lazy dog", add_bos=False))
            if toks != plain_ids or detok != tok.decode(ids) or "hello world" not in tmpl \
                    or [p["id"] for p in pieces] != tok.encode("hello world", add_bos=False) \
                    or infill["object"] != "text_completion" \
                    or infill["usage"]["prompt_tokens"] != n_infill or min(
                        sp.fim_pre_id, sp.fim_suf_id, sp.fim_mid_id) < 0:
                raise AssertionError("slots: a utility path answered wrongly")
            props = _get(port, "/props", key)
            if props["model"] != engine.model_name or props["ctx"] != 1024:
                raise AssertionError(f"slots: /props {props}")
            out.update({"cold_equals_unsaved": cold == unsaved, "n_saved": saved["n_saved"],
                        "file_bytes": os.path.getsize(os.path.join(tmp, "slot.npz")),
                        "t_save_ms": saved["t_save_ms"],
                        "t_restore_ms": restored["t_restore_ms"],
                        "infill_prompt_tokens": n_infill,
                        "paths_checked": ["/props", "/completion", "/tokenize", "/detokenize",
                                          "/apply-template", "GET /slots",
                                          "POST /slots/{id}?action=save|erase|restore",
                                          "/infill"]})
    finally:
        os.environ.pop("SLOT_SAVE_PATH", None)
        shutil.rmtree(tmp, ignore_errors=True)
    _check_launches("slots", launches, (qm.NAME_4BIT, fa.NAME_TC))
    emit({"phase": "slots", "ok": True, **out, "launches": launches})
    return launches


LORA_SHAPE, LORA_LAYERS = "8b", 2   # the lora phase's widths, at this depth
LORA_RANK, LORA_ALPHA = 16, 32.0


def _lora_model():
    """The 8b shape's Q4_K_M file at LORA_LAYERS layers and a rank-16
    adapter on its seven projections of every layer and on the head."""
    import tempfile

    from llama_gguf_inference_tpu_torch.tools.synth import cached_model, synth_lora
    path = cached_model(LORA_SHAPE, seed=0, n_layers=LORA_LAYERS)
    adapter = os.path.join(tempfile.gettempdir(), f"llama_gguf_port_lora_{os.getpid()}.gguf")
    synth_lora(adapter, LORA_SHAPE, seed=1, rank=LORA_RANK, alpha=LORA_ALPHA,
               n_layers=LORA_LAYERS)
    return path, adapter


def _merged_dense(torch, dense, alpha, pairs):
    """The oracle: every adapted weight of the dense parameters replaced by
    W + alpha / r * B @ A in f32 (on the card), for the adapter's
    ``load_adapter`` pairs."""
    from llama_gguf_inference_tpu_torch.ops.linear import DenseLinear
    from llama_gguf_inference_tpu_torch.runtime.lora import _resolve
    for name, (a, b) in pairs.items():
        cont, key = _resolve(dense, name)
        w = cont[key]
        ba = torch.from_numpy(b).cuda() @ torch.from_numpy(a).cuda()
        cont[key] = DenseLinear(w=w.w.float() + alpha / a.shape[0] * ba,
                                out_features=w.out_features, in_features=w.in_features)
    return len(pairs)


def _lora_kernel_rows(torch, qm, params, timer) -> list[dict]:
    """Each adapted projection of layer 0 at 4 and 512 rows: its base's
    call (the body ``select_kernel`` picks) and the whole adapted call."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    layer = params["layers"][0]
    for name in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down"):
        lw = layer[name]
        for B in (4, 512):
            x = torch.randn(B, lw.in_features, generator=g, device="cuda").bfloat16()
            rows.append({"proj": name, "shape": f"{lw.out_features}x{lw.in_features}", "B": B,
                         "body": qm.select_kernel(lw.base, B),
                         "base_ms": round(timer(lambda: lw.base.matmul(x)), 4),
                         "lora_ms": round(timer(lambda: lw.matmul(x)), 4)})
    return rows


def phase_lora(torch):
    """GGUF LoRA and dense residency at the 8b widths, LORA_LAYERS layers:
    the Q4_K_M file loaded with a rank-16 adapter on all seven projections
    and the head (every projection unfused: LoraLinear over the
    quantized-resident base, which runs its kernels) and loaded dense
    (``mode="dense"``, bf16). The dense weights' 512-token chunk is held to
    LOGITS_TOL of the quantized bases' without the adapter; then their
    adapted weights are merged in f32, the oracle. A 512-token prefill chunk (qkv's three, o, gate and up
    through the 4-bit tensor-core kernel, ffn_down through the dequantize
    path, the head's row through the 8-bit kernel) and 4 greedy decode steps
    at B = 4 (the 4-bit and 8-bit decode kernels), each a launch window,
    every call of those wrappers then shadowed by its plain version, and the
    logits held to LOGITS_TOL of the oracle's fed the same tokens. Then the
    base and adapted calls of each projection timed at 4 and 512 rows."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.ops.linear import LoraLinear
    from llama_gguf_inference_tpu_torch.runtime.loader import load_model
    from llama_gguf_inference_tpu_torch.runtime.lora import load_adapter
    from llama_gguf_inference_tpu_torch.runtime.tokenizer import from_gguf_metadata
    path, adapter = _lora_model()
    try:
        t0 = time.time()
        cfg, params, reader = load_model(path, "cuda", lora_path=adapter)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        tok = from_gguf_metadata(reader.metadata)
        reader.close()
        t0 = time.time()
        _, dense, reader = load_model(path, "cuda", mode="dense", fuse=False)
        torch.cuda.synchronize()
        dense_load_s = time.time() - t0
        reader.close()
        alpha, pairs = load_adapter(adapter)
    finally:
        os.remove(adapter)
    wrapped = [params["output"]] + [lw for layer in params["layers"] for lw in layer.values()
                                    if isinstance(lw, LoraLinear)]
    if not len(wrapped) == len(pairs) == 7 * LORA_LAYERS + 1 \
            or any("attn_qkv" in layer or "ffn_gateup" in layer for layer in params["layers"]):
        raise AssertionError("lora: expected every projection and the head adapted, unfused")
    dev = torch.device("cuda")
    words = "the quick brown fox jumps over the lazy dog and".split()
    ids = tok.encode(" ".join(words[i % len(words)] for i in range(600)))[:512]
    L = cfg.n_layers

    def chunk(p):
        with torch.inference_mode():
            lg = forward(p, cfg, torch.tensor([ids], dtype=torch.int32, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         KVCache.zeros(cfg, 1, 1024, dev),
                         logits_at=torch.tensor([511], device=dev))[0, 0]
        torch.cuda.synchronize()
        return lg

    def decode(p, feed=None):
        """4 prompts of 16 tokens prefilled together, then 4 steps at B = 4
        (each fed the argmax or ``feed``); the steps' logits, tokens, ms."""
        cache = KVCache.zeros(cfg, 4, 1024, dev)
        prompts = torch.tensor([ids[16 * i:16 * i + 16] for i in range(4)], dtype=torch.int32,
                               device=dev)
        with torch.inference_mode():
            lg = forward(p, cfg, prompts, torch.zeros(4, dtype=torch.int32, device=dev), cache,
                         logits_at=torch.full((4,), 15, device=dev))[:, 0]
            torch.cuda.synchronize()
            logits, toks, ms = [], [], []
            _build.reset_launches()
            for s in range(4):
                nxt = lg.argmax(-1).int() if feed is None else feed[s]
                toks.append(nxt)
                t0 = time.perf_counter()
                lg = forward(p, cfg, nxt[:, None],
                             torch.full((4,), 16 + s, dtype=torch.int32, device=dev), cache)[:, 0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg)
        return logits, toks, ms, dict(_build.LAUNCHES)

    # dense residency on its own: the bf16 weights' chunk (DenseLinear's
    # bf16 product on the card) against the quantized bases' without the
    # adapter, before the dense weights are merged into the oracle
    bases = {**params, "output": params["output"].base,
             "layers": [{n: lw.base if isinstance(lw, LoraLinear) else lw
                         for n, lw in layer.items()} for layer in params["layers"]]}
    errs_dense, _ = _compare([chunk(dense)], [chunk(bases)])
    del bases
    n_adapted = _merged_dense(torch, dense, alpha, pairs)
    _build.reset_launches()
    t0 = time.time()
    k_chunk = chunk(params)
    chunk_s = time.time() - t0
    chunk_launches = dict(_build.LAUNCHES)
    want = {qm.NAME_4BIT_TC: 6 * L, qm.NAME_DEQUANT: L, qm.NAME_8BIT: 1}
    got = {n: c for n, c in chunk_launches.items() if n.startswith("quant_matmul")}
    if got != want or {n: c for n, c in chunk_launches.items() if n.startswith("flash")} \
            != {fa.NAME_TC: L}:
        raise AssertionError(f"lora chunk: launches {chunk_launches}, want {want}")
    k_logits, k_toks, step_ms, dec_launches = decode(params)
    _check_launches("lora decode", dec_launches, (qm.NAME_4BIT, qm.NAME_8BIT, fa.NAME))
    errs: dict[str, list] = {}
    window = {"left": float("inf")}
    with shadowed_live(torch, (qm.NAME_4BIT, qm.NAME_8BIT), errs, window):
        chunk(params)
        decode(params, feed=k_toks)
    if any(max(e) > MATMUL_TOL for e in errs.values()) \
            or len(errs.get(qm.NAME_4BIT, ())) != 6 * L + 7 * L * 5:
        raise AssertionError(f"lora: shadowed calls {({n: len(e) for n, e in errs.items()})}")
    o_chunk = chunk(dense)
    o_logits, *_ = decode(dense, feed=k_toks)
    k_rows = [k_chunk] + [r for lg in k_logits for r in lg]
    if any(r.shape != (cfg.vocab_size,) or not bool(torch.isfinite(r).all()) for r in k_rows):
        raise AssertionError("lora: non-finite or misshapen logits")
    errs_c, _ = _compare([k_chunk], [o_chunk])
    errs_d, agree = _compare(k_rows[1:], [r for lg in o_logits for r in lg])
    timer = Timer(torch)
    with torch.inference_mode():
        rows = _lora_kernel_rows(torch, qm, params, timer)
    del timer, params, dense
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lora", "ok": True, "layers": L, "rank": LORA_RANK, "alpha": LORA_ALPHA,
          "adapted": n_adapted, "load_s": round(load_s, 3),
          "dense_load_s": round(dense_load_s, 3), "chunk_wall_s": round(chunk_s, 4),
          "decode_step_ms": [round(m, 3) for m in step_ms],
          "dense_chunk_rel_err_vs_quant": errs_dense[0],
          "chunk_rel_err_vs_merged": errs_c[0], "decode_rel_err_vs_merged_max": max(errs_d),
          "decode_argmax_agree": agree, "logits_tol": LOGITS_TOL,
          "shadow_calls": {n: len(e) for n, e in errs.items()},
          "shadow_rel_err_max": {n: max(e) for n, e in errs.items()},
          "kernel_rows": rows, "chunk_launches": chunk_launches,
          "decode_launches": dec_launches})
    return [chunk_launches, dec_launches]


GEMMA_SHAPE = "gemma3-12b"
GEMMA_CTX = 4096               # each of the gemma3 engine's 4 slots
GEMMA_PROMPT = 2000            # tokens of its long prompt: past the 1024 window
GEMMA_STEPS = 32               # greedy decode steps after it
GEMMA_CHUNK = 512              # prefill rows a forward (the engine's largest bucket)


def _gemma_run(torch, engine, ids, steps, feed=None):
    """``ids`` prefilled into a one-sequence cache of GEMMA_CTX positions in
    chunks of GEMMA_CHUNK (each chunk's last row's logits kept), then
    ``steps`` decode steps, each fed the argmax of the logits before it or
    ``feed``'s tokens. Returns (chunk logits, step logits, tokens fed)."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    dev = engine.device
    cache = KVCache.zeros(engine.cfg, 1, GEMMA_CTX, dev)

    def step(tok, off, at):
        return forward(engine.params, engine.cfg,
                       torch.tensor([tok], dtype=torch.int32, device=dev),
                       torch.tensor([off], dtype=torch.int32, device=dev), cache,
                       logits_at=torch.tensor([at], device=dev))[0, 0]

    chunk_logits, step_logits, toks = [], [], []
    with torch.inference_mode():
        for s in range(0, len(ids), GEMMA_CHUNK):
            part = ids[s:s + GEMMA_CHUNK]
            chunk_logits.append(step(part, s, len(part) - 1))
        lg = chunk_logits[-1]
        for i in range(steps):
            toks.append(int(lg.argmax()) if feed is None else feed[i])
            lg = step([toks[-1]], len(ids) + i, 0)
            step_logits.append(lg)
    torch.cuda.synchronize()
    return chunk_logits, step_logits, toks


def _qm_row(torch, qm, timer, w, B, label, g):
    """One timed row of the QuantLinear ``w`` at ``B`` rows through the
    dispatcher (``ops.quant_matmul.quant_matmul``, the model's path): the
    kernel it launched, its error against the plain versions on the same
    inputs (MATMUL_TOL), its time, the plain path's, ``torch.matmul`` on the
    weights dequantized to bf16 ahead of time, and the bound (the stored
    weight arrays, the activations and the f32 output; 2 B in out bf16
    operations)."""
    from llama_gguf_inference_tpu_torch.ops import _build
    x = torch.randn(B, w.in_features, generator=g, device="cuda").bfloat16()
    before = dict(_build.LAUNCHES)
    got = qm.quant_matmul(w, x, torch.float32)
    ran = [n for n, c in _build.LAUNCHES.items() if c != before.get(n, 0)]
    with plain_versions():
        want = qm.quant_matmul(w, x, torch.float32)
    err, rel = _err(got, want, MATMUL_TOL)
    w_lib = w.dequantize_bm(torch.bfloat16)
    xp = w.permute_activations(x)
    nbytes = _wbytes(w) + B * w.in_features * 2 + B * w.out_features * 4
    b_ms, b_by = bound(nbytes, 2.0 * B * w.in_features * w.out_features)
    ms = timer(lambda: qm.quant_matmul(w, x, torch.float32))
    with plain_versions():
        plain_ms = timer(lambda: qm.quant_matmul(w, x, torch.float32), 5)
    row = {"kernel": ran[0] if len(ran) == 1 else ran,
           "shape": f"{label} {w.out_features}x{w.in_features} B={B}", "B": B,
           "max_abs_err": err, "max_rel_err": rel,
           "bits_per_weight": 8 * _wbytes(w) / (w.out_features * w.in_features),
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": timer(lambda: torch.matmul(xp, w_lib.t())),
           "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
    del w_lib
    emit({"phase": "kernels", **row})
    return row


def _gemma_rows(torch, engine, timer):
    """Gemma-3-12B's shapes timed: the Q4_K gate+up (30720 x 3840) at 4 and
    512 rows (in 3840 is 120 sub-blocks of 32, short of the tensor-core
    kernels' step of 64, so both run the 4-bit decode kernel); the tied Q6_K
    head (262208 x 3840) at 4 rows through the 8-bit decode kernel, beside
    the dequantize path the JAX package's gate sends it to (262208 rows
    divide no out-tile); flash at head_dim 256, decode (B=4) and a 512-token
    prefill chunk from offset 1024 over 4096 slots (the split kernel, in
    pieces), each beside its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    w = engine.params["layers"][0]["ffn_gateup"]
    for B in (4, 512):
        rows.append(_qm_row(torch, qm, timer, w, B, "gemma3 q4_k gate_up", g))
    head = engine.params["output"]
    x = torch.randn(4, head.in_features, generator=g, device="cuda").bfloat16()
    x2 = head.permute_activations(x).contiguous()
    args = (x2, head.codes, head.d, head.sc, head.sub_size, head.code_bias, head.dmin, head.mn)
    err, rel = _err(qm.quant_matmul_8bit(*args), qm.quant_matmul_8bit_plain(*args), MATMUL_TOL)
    nbytes = _wbytes(head) + x.numel() * 2 + 4 * head.out_features * 4
    b_ms, b_by = bound(nbytes, 2.0 * 4 * head.in_features * head.out_features)
    w_lib = head.dequantize_bm(torch.bfloat16)
    ms = timer(lambda: qm.quant_matmul_8bit(*args))
    rows.append({"kernel": _8bit_name(qm, 4, head.in_features, head.sub_size, False),
                 "shape": f"gemma3 head {head.out_features}x{head.in_features} B=4", "B": 4,
                 "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                 "plain_ms": timer(lambda: qm.quant_matmul_8bit_plain(*args), 5),
                 "library_ms": timer(lambda: torch.matmul(x2, w_lib.t())),
                 "dispatched": qm.select_kernel(head, 4),
                 "dispatched_ms": timer(lambda: qm.quant_matmul(head, x, torch.float32)),
                 "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
    emit({"phase": "kernels", **rows[-1]})
    del w_lib
    cfg = engine.cfg
    H, KVH, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, GEMMA_CTX
    for B, T, offs in ((4, 1, [2000, 1500, 1000, 37]), (1, GEMMA_CHUNK, [1024])):
        q = torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, KVH, S, D, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, KVH, S, D, generator=g, device="cuda").bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        args = (q, k, v, off)
        before = _build.LAUNCHES.get(fa.NAME, 0)
        got = fa.flash_attention(*args)
        launches = _build.LAUNCHES.get(fa.NAME, 0) - before
        err, rel = _err(got, fa.flash_attention_plain(*args), FLASH_TOL)
        live = sum(o + T for o in offs)
        pairs = sum(o * T + T * (T + 1) // 2 for o in offs)
        b_ms, b_by = bound(live * KVH * 2 * D * 2 + 2 * q.numel() * 2 + B * 4,
                           4.0 * H * D * pairs)
        pos = off.long()[:, None] + torch.arange(T, device="cuda")[None]
        mask = (torch.arange(S, device="cuda")[None, None] <= pos[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        ms = timer(lambda: fa.flash_attention(*args))
        rows.append({"kernel": fa.NAME,
                     "shape": f"gemma3 {'decode' if T == 1 else 'prefill'} B={B} T={T} "
                              f"H={H} KVH={KVH} D={D} S={S} offsets={offs}",
                     "B": B, "launches_a_call": launches,
                     "scratch_bytes": fa.split_scratch_bytes(
                         B, fa.split_rows(B, T, H // KVH, KVH, S, D), H // KVH, KVH, S, D),
                     "scratch_cap": fa.FLASH_SPLIT_SCRATCH,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": timer(lambda: fa.flash_attention_plain(*args), 5),
                     "library_ms": timer(lambda: F.scaled_dot_product_attention(
                         qt, k, v, attn_mask=mask, enable_gqa=True)),
                     "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
        emit({"phase": "kernels", **rows[-1]})
        del q, k, v
    return rows


def phase_gemma3(torch):
    """The Gemma-3-12B shape at full width and depth (``tools.synth``
    ``gemma3-12b``: Q4_K projections, a tied Q6_K embedding, 48 layers of
    3840, 8 of them global) loaded cold and served from 4 slots of
    GEMMA_CTX. A prompt of about GEMMA_PROMPT tokens, past the 1024-key
    window, prefilled in chunks of 512 and GEMMA_STEPS greedy steps through
    the kernels: the split flash kernel launches on the 8 global layers
    only (its pieces a chunk and one a step), the 40 sliding layers take
    ``masked_attention``; the first and last chunk's and 4 steps' logits
    held to LOGITS_TOL of the plain versions fed the same tokens. Then a
    chat served with every EOG token banned (TTFT, tokens a second), and
    Gemma's shapes timed (:func:`_gemma_rows`)."""
    from llama_gguf_inference_tpu_torch.models import llama as tllama
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import SHAPES, cached_model
    t0 = time.time()
    path = cached_model(GEMMA_SHAPE, seed=0)
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=GEMMA_CTX, prefix_cache=False),
                             device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t1
    try:
        cfg, p = engine.cfg, engine.params
        d = SHAPES[GEMMA_SHAPE]
        glob = [i for i in range(cfg.n_layers) if not cfg.is_sliding(i)]
        w, head = p["layers"][0]["ffn_gateup"], p["output"]
        if (cfg.arch, cfg.dim, cfg.n_layers, cfg.head_dim, cfg.vocab_size) != \
                ("gemma3", d["dim"], d["n_layers"], d["head_dim"], d["vocab"]) \
                or len(glob) != cfg.n_layers // 6 or (w.fmt, w.bits) != ("q4_k", 4) \
                or head is not p["tok_embd"].table or head.fmt != "q6_k":
            raise AssertionError(f"gemma3 loaded as {cfg}, gate+up {w.fmt}, head {head.fmt}")
        emit({"phase": "gemma3-load", "ok": True, "synth_s": round(t1 - t0, 3),
              "load_s": round(load_s, 3), "gguf_gb": os.path.getsize(path) / 1e9,
              "resident_weights_gb": _resident_bytes(torch, p) / 1e9,
              "resident_block_weights_gb": _resident_bytes(torch, p["layers"]) / 1e9,
              "resident_embedding_head_gb": _resident_bytes(torch, p["tok_embd"]) / 1e9,
              "device_gb": torch.cuda.memory_allocated() / 1e9,
              "load_stats": engine.load_stats, "global_layers": glob,
              "window": cfg.sliding_window, "rope": [cfg.rope_base, cfg.rope_scaling_type,
                                                     cfg.rope_scaling_factor,
                                                     cfg.rope_local_base]})
        _, ids = _words(engine, GEMMA_PROMPT)
        masked = {"calls": 0}
        real = tllama.masked_attention

        def counted(*a, **k):
            masked["calls"] += 1
            return real(*a, **k)

        _build.reset_launches()
        t0 = time.time()
        with _patched(tllama, "masked_attention", counted):
            k_chunks, k_steps, k_toks = _gemma_run(torch, engine, ids, GEMMA_STEPS)
        wall = time.time() - t0
        launches = dict(_build.LAUNCHES)
        group, KVH = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
        pieces = [-(-n // fa.split_rows(1, n, group, KVH, GEMMA_CTX, cfg.head_dim))
                  for n in [min(GEMMA_CHUNK, len(ids) - s)
                            for s in range(0, len(ids), GEMMA_CHUNK)]]
        forwards = len(pieces) + GEMMA_STEPS
        want_flash = len(glob) * (sum(pieces) + GEMMA_STEPS)
        flash = {n: c for n, c in launches.items() if n.startswith("flash")}
        if flash != {fa.NAME: want_flash} \
                or masked["calls"] != (cfg.n_layers - len(glob)) * forwards \
                or launches.get(qm.NAME_4BIT, 0) <= 0 \
                or any(n.endswith(".plain") for n in launches):
            raise AssertionError(f"gemma3 kernel run: launches {launches}, masked "
                                 f"{masked['calls']}, want flash {want_flash}")
        scratch = [{"rows": n, "whole_bytes": fa.split_scratch_bytes(
                        1, n, group, KVH, GEMMA_CTX, cfg.head_dim),
                    "piece_rows": fa.split_rows(1, n, group, KVH, GEMMA_CTX, cfg.head_dim),
                    "piece_bytes": fa.split_scratch_bytes(
                        1, fa.split_rows(1, n, group, KVH, GEMMA_CTX, cfg.head_dim), group,
                        KVH, GEMMA_CTX, cfg.head_dim)}
                   for n in sorted({min(GEMMA_CHUNK, len(ids) - s)
                                    for s in range(0, len(ids), GEMMA_CHUNK)} | {1})]
        if any(s["piece_bytes"] > fa.FLASH_SPLIT_SCRATCH for s in scratch):
            raise AssertionError(f"gemma3 split scratch over the cap: {scratch}")
        with plain_versions():
            p_chunks, p_steps, _ = _gemma_run(torch, engine, ids, 4, feed=k_toks[:4])
        k_rows = [k_chunks[0], k_chunks[-1], *k_steps[:4]]
        _check_logits(torch, engine, k_chunks + k_steps)
        errs, agree = _compare(k_rows, [p_chunks[0], p_chunks[-1], *p_steps])
        emit({"phase": "gemma3-forward", "ok": True, "prompt_tokens": len(ids),
              "chunks": len(pieces), "steps": GEMMA_STEPS, "kernel_path_s": round(wall, 3),
              "logits_rel_err": errs, "logits_tol": LOGITS_TOL, "argmax_agree": agree,
              "flash_launches": want_flash, "flash_pieces_a_chunk": pieces,
              "masked_attention_calls": masked["calls"], "split_scratch": scratch,
              "split_scratch_cap": fa.FLASH_SPLIT_SCRATCH, "launches": launches})

        served: dict[str, int] = {}
        with serving(torch, engine, served) as (port, key):
            ban = {str(t): False for t in sorted(engine.tokenizer.eog_ids)}
            msgs = [{"role": "user", "content": "hello world, the quick brown fox"}]
            t0 = time.time()
            t_first, t_last, usage, _ = _stream(
                port, "/v1/chat/completions",
                {"messages": msgs, "max_tokens": 64, "temperature": 0, "logit_bias": ban}, key)
        n_gen = usage["completion_tokens"]
        if n_gen != 64 or served.get(fa.NAME, 0) <= 0 \
                or any(n.endswith(".plain") for n in served):
            raise AssertionError(f"gemma3 serve: {n_gen} tokens, launches {served}")
        emit({"phase": "gemma3-serve", "ok": True, "ttft_s": round(t_first - t0, 4),
              "completion_tokens": n_gen,
              "decode_tok_s_b1": round((n_gen - 1) / (t_last - t_first), 2),
              "launches": served})
        timer = Timer(torch)
        with torch.inference_mode():
            rows = _gemma_rows(torch, engine, timer)
        del timer
    finally:
        engine.stop()
    return [launches, served], rows


IQ_FORMATS = ("iq1_s", "iq1_m", "iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s")
IQ_PACKED4 = ("iq2_xxs", "iq3_s")
IQ_SHAPE = (14336, 4096)       # the 8B ffn_gate
IQ_LAYERS = 2                  # the IQ2_XXS model's depth (numpy repack)


def phase_iq(torch):
    """The grid-codebook formats: each one's 8B ffn_gate (14336 x 4096)
    repacked from synthesized wire bytes (``tools.synth.tiled_weight``) in
    its default layout (IQ2/IQ3: int8 values with the compact d x sub-scale,
    the 8-bit kernels; IQ1: 2-bit trit codes, code bias 1, the 2-bit
    kernels), and IQ2_XXS and IQ3_S also as packed4 codes (the 4-bit kernels'
    value maps), held to MATMUL_TOL of the plain versions at 4 and 512 rows
    and timed. Then the 8b widths at IQ_LAYERS layers with IQ2_XXS
    projections (a Q4_K embedding, the Q6_K head): a prefill and 16 greedy
    steps through the kernels, every 8-bit call shadowed by its plain
    version, the logits held to LOGITS_TOL of the plain path's."""
    from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.quant.repack import repack, to_quant_linear
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model, tiled_weight
    out_f, in_f = IQ_SHAPE
    g = torch.Generator(device="cuda").manual_seed(4)
    timer = Timer(torch)
    rows = []
    try:
        for fmt, mode in [(f, "int8") for f in IQ_FORMATS] + [(f, "packed4") for f in IQ_PACKED4]:
            t = GGMLType[fmt.upper()]
            raw = tiled_weight(t, out_f, in_f)
            os.environ["LGT_IQ_CODES"] = mode
            t0 = time.time()
            rp = repack(raw, t, out_f, in_f)
            repack_s = time.time() - t0
            w = to_quant_linear(rp, "cuda")
            del rp
            with torch.inference_mode():
                for B in (4, 512):
                    row = _qm_row(torch, qm, timer, w, B,
                                 f"{fmt} {'packed4' if mode == 'packed4' else 'default'} gate", g)
                    row["repack_s"] = round(repack_s, 3)
                    rows.append(row)
            del w
    finally:
        os.environ.pop("LGT_IQ_CODES", None)
        del timer
        torch.cuda.empty_cache()
    t0 = time.time()
    path = cached_model("8b", seed=0, quant="iq2_xxs", n_layers=IQ_LAYERS)
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024, prefix_cache=False),
                             device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    try:
        w = engine.params["layers"][0]["ffn_gateup"]
        if (w.fmt, w.bits, w.sub_size) != ("iq2_xxs", 8, 32):
            raise AssertionError(f"iq2_xxs gate+up loaded as {w.fmt}, {w.bits} bits")
        launches, out = _variant_forward(torch, engine, "iq2_xxs", (qm.NAME_8BIT,),
                                         (qm.NAME_DEQUANT,), shadow=qm.NAME_8BIT)
        emit({"phase": "iq-forward", "ok": True, "layers": IQ_LAYERS,
              "synth_s": round(t1 - t0, 3), "load_s": round(t2 - t1, 3),
              "load_stats": engine.load_stats,
              "resident_block_weights_gb": _resident_bytes(torch, engine.params["layers"]) / 1e9,
              **out, "launches": launches})
    finally:
        engine.stop()
    return [launches], rows


_FA_CU = "llama_gguf_inference_tpu_torch/csrc/flash_attention.cu"
_FA_TC_CU = "llama_gguf_inference_tpu_torch/csrc/flash_attention_tc.cu"
_FA_JAX = "llama_gguf_inference_tpu/ops/flash_attention.py"
_QM_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu"
_QM_TC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_tc.cu"
_QM_LTC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_lowbit_tc.cu"
_QM_ITC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_int8_tc.cu"
_QM_JAX = "llama_gguf_inference_tpu/ops/pallas_matmul.py"
SOURCES = {
    # name: (source, TPU kernel it replaces); pallas_call sites are
    # pallas_matmul.py:641 (qsplit, fsplit, xsum, split), :247 (_make_kernel's
    # branches), :698 (int8) and flash_attention.py:176, :289 (q8/q4/q4_1),
    # :369 (paged) and :452 (paged q8_0)
    "quant_matmul_2bit": (_QM_CU, _QM_JAX + ":481"),
    "quant_matmul_4bit": (_QM_CU, _QM_JAX + ":421"),
    # the same two bodies at prefill rows, on tensor cores
    "quant_matmul_2bit_tc": (_QM_LTC_CU, _QM_JAX + ":481"),
    "quant_matmul_4bit_tc": (_QM_LTC_CU, _QM_JAX + ":421"),
    "quant_matmul_4bit_xsum": (_QM_CU, _QM_JAX + ":309"),
    "quant_matmul_4bit_split": (_QM_CU, _QM_JAX + ":362"),
    "quant_matmul_4bit_int8": (_QM_CU, _QM_JAX + ":536"),
    "quant_matmul_4bit_base": (_QM_CU, _QM_JAX + ":157"),      # _make_kernel, bf16-magic branch
    "quant_matmul_lowbit_base": (_QM_CU, _QM_JAX + ":172"),    # _make_kernel, f32 low-bit branch
    # the same five at prefill rows, on tensor cores (split through the xsum
    # rule's instances)
    "quant_matmul_4bit_xsum_tc": (_QM_LTC_CU, _QM_JAX + ":309"),
    "quant_matmul_4bit_split_tc": (_QM_LTC_CU, _QM_JAX + ":362"),
    "quant_matmul_4bit_int8_tc": (_QM_ITC_CU, _QM_JAX + ":536"),
    "quant_matmul_4bit_base_tc": (_QM_LTC_CU, _QM_JAX + ":157"),
    "quant_matmul_lowbit_base_tc": (_QM_LTC_CU, _QM_JAX + ":172"),
    "quant_matmul_8bit": (_QM_CU, _QM_JAX + ":123"),           # _make_kernel, 8-bit branch
    "quant_matmul_8bit_min": (_QM_CU, _QM_JAX + ":185"),       # the same, with its min term
    # the same two at prefill rows, tensor cores (without a min side: the
    # encoder's Q8_0 ffn_down; the decoders' Q6_K head never reaches it)
    "quant_matmul_8bit_tc": (_QM_TC_CU, _QM_JAX + ":123"),
    "quant_matmul_8bit_min_tc": (_QM_TC_CU, _QM_JAX + ":185"),
    "flash_attention": (_FA_CU, _FA_JAX + ":129"),
    "flash_attention_q8": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q4": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q41": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_paged": (_FA_CU, _FA_JAX + ":302"),
    "flash_attention_paged_q8": (_FA_CU, _FA_JAX + ":383"),
    # the same six at prefill, on tensor cores
    "flash_attention_tc": (_FA_TC_CU, _FA_JAX + ":129"),
    "flash_attention_q8_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_q4_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_q41_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_paged_tc": (_FA_TC_CU, _FA_JAX + ":302"),
    "flash_attention_paged_q8_tc": (_FA_TC_CU, _FA_JAX + ":383"),
}
# the kernels line reports each kernel at its decode shape (4 slots; the
# paged ones with their idle fifth, B=5; the 2-bit one in the layout the q2k
# phase serves), the tensor-core matmuls at a 512-row prefill chunk's
# gate_up (the 8-bit one without a min side at the encoder's ffn_down, its
# only main-path use), the tensor-core
# flash kernels at a 512-token chunk at offset 0
LINE_SHAPE = {"quant_matmul_2bit": "mixed gate_up 28672x4096 B=4",
              "quant_matmul_4bit": "gate_up 28672x4096 B=4",
              "quant_matmul_2bit_tc": "q2_k mixed tc gate_up 28672x4096 B=512",
              "quant_matmul_4bit_tc": "q4_k flat tc gate_up 28672x4096 B=512",
              **{f"quant_matmul_4bit_{v}": f"q4_k flat {v} gate_up 28672x4096 B=4"
                 for v in VARIANTS},
              "quant_matmul_lowbit_base": "q2_k flat base gate_up 28672x4096 B=4",
              **{f"quant_matmul_4bit_{v}_tc": f"q4_k flat {v} tc gate_up 28672x4096 B=512"
                 for v in ("xsum", "split")},
              "quant_matmul_4bit_int8_tc": "q4_k flat int8 tc gate_up 28672x4096 B=512",
              "quant_matmul_4bit_base_tc": "q4_k flat base tc gate_up 28672x4096 B=512",
              "quant_matmul_lowbit_base_tc": "q2_k flat base tc gate_up 28672x4096 B=512",
              "quant_matmul_8bit": "head 128256x4096 B=4",
              "quant_matmul_8bit_min": "q5_k compact 8bit gate_up 28672x4096 B=4",
              "quant_matmul_8bit_tc": "encoder Q8_0 ffn_down 1024x4096 B=512",
              "quant_matmul_8bit_min_tc": "q5_k compact 8bit gate_up 28672x4096 B=512",
              **{name: "prefill" if name.endswith("_tc") else
                 "decode B=5" if "paged" in name else "decode B=4"
                 for name in SOURCES if name.startswith("flash")}}


def kernels_line(rows, launches):
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        row = next(r for r in mine if r["shape"].startswith(LINE_SHAPE[name]))
        n = launches.get(name, 0)
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if launches.get(name + ".plain", 0):
            raise AssertionError(f"{name}: the plain version ran on the main path")
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": n, "plain_launches": launches.get(name + ".plain", 0),
                    "shape": row["shape"],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke needs an NVIDIA card",
              file=sys.stderr)
        return 3
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "llama_gguf_inference_tpu_torch")):
        print("run from a checkout: llama_gguf_inference_tpu_torch/ is missing",
              file=sys.stderr)
        return 4
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    engine = None
    launches: dict[str, int] = {}
    seconds: dict[str, float] = {}
    t_last = time.time()

    def enter(name):
        """Book the time since the last phase began to that phase."""
        nonlocal phase, t_last
        now = time.time()
        seconds[phase] = round(seconds.get(phase, 0.0) + now - t_last, 1)
        phase, t_last = name, now

    # a fresh layout cache per run, emptied once each model's phases end, so
    # every run measures the same cold and warm loads
    cache_root = tempfile.mkdtemp(prefix="lgt-smoke-lcache-")
    os.environ["LGT_LAYOUT_CACHE_DIR"] = cache_root

    def drop_caches():
        for d in os.listdir(cache_root):
            shutil.rmtree(os.path.join(cache_root, d), ignore_errors=True)

    try:
        card = phase_device(torch)
        enter("build")
        reports = phase_build()
        enter("plans")
        phase_plans(torch, reports)
        enter("kernels")
        with torch.inference_mode():
            rows = phase_kernels(torch, Timer(torch))
        torch.cuda.empty_cache()
        enter("load")
        engine = phase_engine(torch)
        enter("warm-load")
        phase_warm_load(torch, engine)
        enter("cold-start")
        phase_cold_start(torch, engine)
        enter("launch")
        phase_launch(torch, engine)
        drop_caches()
        enter("embeddings")
        paths = [phase_embeddings(torch, engine)]
        enter("encoder")
        enc_launches, enc_rows = phase_encoder(torch)
        paths.append(enc_launches)
        rows += enc_rows
        enter("forward")
        bf16_prefill = phase_forward(torch, engine)
        enter("q4k-prefill")
        paths += phase_q4k_prefill(torch, engine)
        torch.cuda.empty_cache()
        enter("kv-forward")
        paths.append(phase_kv_forward(torch, engine, bf16_prefill))
        torch.cuda.empty_cache()
        enter("serve")
        paths.append(phase_serve(torch, engine))
        enter("decode-dispatch")
        paths += phase_decode_dispatch(torch, engine, card)
        enter("structured")
        paths += phase_structured(torch, engine, card)
        enter("variants")
        paths += phase_variants(torch, engine)
        enter("ctx-shift")
        paths += phase_ctx_shift(torch, engine)
        torch.cuda.empty_cache()
        enter("slots")
        paths.append(phase_slots(torch, engine))
        enter("serve-paged")
        paths.append(phase_serve_paged(torch, engine))
        engine.stop()
        engine = None
        gc.collect()
        torch.cuda.empty_cache()
        enter("q2k")
        paths += phase_q2k(torch)
        drop_caches()
        gc.collect()
        torch.cuda.empty_cache()
        enter("q5k")
        paths += phase_q5k(torch)
        drop_caches()
        gc.collect()
        torch.cuda.empty_cache()
        enter("lora")
        paths += phase_lora(torch)
        drop_caches()
        gc.collect()
        torch.cuda.empty_cache()
        enter("gemma3")
        g_paths, g_rows = phase_gemma3(torch)
        paths += g_paths
        rows += g_rows
        drop_caches()
        gc.collect()
        torch.cuda.empty_cache()
        enter("iq")
        i_paths, i_rows = phase_iq(torch)
        paths += i_paths
        rows += i_rows
        drop_caches()
        emit({"phase": "memory", "max_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
        for counts in paths:
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        line = kernels_line(rows, launches)
        enter("end")
        emit({"phase": "seconds", **seconds, "total": round(sum(seconds.values()), 1)})
    except Exception:  # noqa: BLE001 — report the failing phase, exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False})
        return 1
    finally:
        if engine is not None:
            engine.stop()
        shutil.rmtree(cache_root, ignore_errors=True)
    emit(line)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
