"""Unified CLI: ``python -m llama_gguf_inference_tpu_torch <command> [args]``.

Commands map to the tool/server modules (each also runnable directly):

    serve        boot the full 3-process stack (launch.start)
    backend      run only the OpenAI backend server
    gateway      run only the gateway
    health       run only the health sidecar
    keys         API key management (generate/list/remove/rotate)
    benchmark    gateway + inference latency/throughput suites
    profile      device time of a decode step and a prefill chunk by kernel
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "serve": ("llama_gguf_inference_tpu_torch.launch.start", "main"),
    "backend": ("llama_gguf_inference_tpu_torch.serving.openai_server", "main"),
    "gateway": ("llama_gguf_inference_tpu_torch.serving.gateway", "main"),
    "health": ("llama_gguf_inference_tpu_torch.serving.health_server", "main"),
    "keys": ("llama_gguf_inference_tpu_torch.serving.key_mgmt", "main"),
    "benchmark": ("llama_gguf_inference_tpu_torch.serving.benchmark", "main"),
    "profile": ("llama_gguf_inference_tpu_torch.tools.profile", "main"),
}
# commands whose main takes its arguments; the others parse sys.argv
_TAKES_ARGV = ("keys", "benchmark")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; one of: {', '.join(_COMMANDS)}",
              file=sys.stderr)
        return 2
    module, fn_name = _COMMANDS[cmd]
    import importlib

    fn = getattr(importlib.import_module(module), fn_name)
    if cmd in _TAKES_ARGV:
        rc = fn(argv[1:])
    else:
        sys.argv = [module, *argv[1:]]
        rc = fn()
    return int(rc or 0)


if __name__ == "__main__":
    sys.exit(main())
