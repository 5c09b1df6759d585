"""Every CUDA launcher reads the card per device.

A launcher's shared-memory opt-in (``cudaFuncSetAttribute``) and the SM
count it sizes a grid by (``cudaDevAttrMultiProcessorCount``) come only
through ``CardCache`` in ``csrc/tc_common.cuh``, which reads them once per
device and instance under a lock. A launcher that kept either in a static
of its own would carry the first card's values to a second card, whose
first launch past 48 KB of shared memory would then be refused. Sources
are read as text, comments removed; no card or compiler is needed.
"""

import os
import re

import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "llama_gguf_inference_tpu_torch", "csrc")
SOURCES = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _code(name: str) -> str:
    """The source without its comments, and without the body of
    ``CardCache`` (the one place allowed to read the card)."""
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src)
    start = src.find("class CardCache")
    if start >= 0:
        end = src.index("\n};", start)
        src = src[:start] + src[end + 3:]
    return src


def test_card_cache_is_the_reader():
    """CardCache itself sets the opt-in and reads the SM count."""
    with open(os.path.join(CSRC, "tc_common.cuh")) as f:
        src = f.read()
    body = src[src.index("class CardCache"):]
    body = body[:body.index("\n};")]
    assert "cudaFuncSetAttribute" in body and "cudaDevAttrMultiProcessorCount" in body
    assert "std::lock_guard" in body and "cudaGetDevice" in body


@pytest.mark.parametrize("name", SOURCES)
def test_launchers_read_the_card_through_card_cache(name):
    """No source outside CardCache sets the shared-memory opt-in, reads the
    SM count, or keeps a card's value in a static variable (a static
    ``CardCache`` is the per-device cache itself; ``static constexpr``
    values are the kernel's own constants)."""
    code = _code(name)
    assert "cudaFuncSetAttribute" not in code
    assert "cudaDevAttrMultiProcessorCount" not in code
    stat = re.findall(r"\bstatic\s+(?!constexpr\b|CardCache\b|const\s+EncodeTiled\b)[^;(){}]*;", code)
    assert not stat, stat
