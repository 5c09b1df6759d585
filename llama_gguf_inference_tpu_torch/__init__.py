"""llama_gguf_inference_tpu_torch — the GGUF inference engine in PyTorch and CUDA.

The same serving path as ``llama_gguf_inference_tpu`` (a Q4_K_M llama GGUF
behind an OpenAI-compatible server with continuous batching), for an NVIDIA
Hopper card. Sub-packages mirror the JAX package's:

- ``gguf``     — GGUF reader/writer (numpy)
- ``quant``    — block codecs and the repack into the device layout
- ``ops``      — weight containers and the CUDA kernels (``csrc/``): 4-bit and
  8-bit fused dequant+matmul, flash attention
- ``models``   — the llama forward
- ``runtime``  — loader, sampler, tokenizer, the continuous-batching engine
- ``serving``  — the OpenAI-compatible backend server
- ``tools``    — the synthetic-model writer

Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
