"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

An AST scan of every file of ``llama_gguf_inference_tpu_torch`` and of
``chip_smoke.py`` finds no import of ``jax`` or ``llama_gguf_inference_tpu``;
a fresh interpreter that imports every port module holds neither in
``sys.modules``; entry points called without a device raise where there is
no card instead of falling back to the CPU.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import llama_gguf_inference_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(port.__file__))
FORBIDDEN = ("jax", "jaxlib", "llama_gguf_inference_tpu")

torch.set_num_threads(1)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    for d, dirs, files in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "_build"]    # build outputs, not sources
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _module_names():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_fresh_interpreter_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_module_names()!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
            f"for f in {FORBIDDEN!r})]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
    from llama_gguf_inference_tpu_torch.quant.numpy_ref import quantize
    from llama_gguf_inference_tpu_torch.quant.repack import repack, to_quant_linear
    from llama_gguf_inference_tpu_torch.runtime.convert import params_from_numpy
    from llama_gguf_inference_tpu_torch.runtime.engine import InferenceEngine
    from llama_gguf_inference_tpu_torch.runtime.loader import load_model
    from llama_gguf_inference_tpu_torch.serving import openai_server
    from llama_gguf_inference_tpu_torch.tools.synth import synth_model

    path = synth_model(str(tmp_path / "m.gguf"), "160m")
    rp = repack(quantize(np.zeros((4, 256), np.float32), GGMLType.Q8_0),
                GGMLType.Q8_0, 4, 256)
    monkeypatch.setenv("MODEL_PATH", path)
    for call in (lambda: load_model(path), lambda: InferenceEngine(path),
                 lambda: to_quant_linear(rp), lambda: params_from_numpy({"x": np.ones(2)}),
                 lambda: openai_server.build_engine_from_env()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # and the explicit CPU request works
    cfg, _, _ = load_model(path, device="cpu")
    assert cfg.dim == 512
