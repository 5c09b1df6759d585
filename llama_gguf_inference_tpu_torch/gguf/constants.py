"""GGUF / GGML format constants.

Implements the public GGUF v3 specification (little-endian) as consumed by the
reference's backend binary (llama.cpp ``llama-server``; see reference
``SURVEY.md`` §2.9 — the reference repo itself contains no format code, it
delegates to the base-image binary).  Everything here is written from the
public spec; nothing is copied from the reference repo.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" read as little-endian u32
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    """Metadata value types (GGUF spec)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (ggml type ids, stable public ABI)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2 / Q4_3 — removed from the format, ids never reused
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


QK_K = 256  # super-block size for K-quants

# (elements per block, bytes per block) for every type we can decode.
GGML_BLOCK_INFO: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),   # f16 d + 16B nibbles
    GGMLType.Q4_1: (32, 20),   # f16 d + f16 m + 16B nibbles
    GGMLType.Q5_0: (32, 22),   # f16 d + 4B high bits + 16B nibbles
    GGMLType.Q5_1: (32, 24),   # f16 d + f16 m + 4B high bits + 16B nibbles
    GGMLType.Q8_0: (32, 34),   # f16 d + 32 int8
    GGMLType.Q8_1: (32, 36),   # f16 d + f16 s + 32 int8
    GGMLType.Q2_K: (QK_K, 84),    # 16B scales + 64B 2-bit + f16 d + f16 dmin
    GGMLType.Q3_K: (QK_K, 110),   # 32B hmask + 64B 2-bit + 12B scales + f16 d
    GGMLType.Q4_K: (QK_K, 144),   # f16 d + f16 dmin + 12B scales + 128B nibbles
    GGMLType.Q5_K: (QK_K, 176),   # f16 d + f16 dmin + 12B scales + 32B qh + 128B nibbles
    GGMLType.Q6_K: (QK_K, 210),   # 128B ql + 64B qh + 16B scales + f16 d
    GGMLType.Q8_K: (QK_K, 292),   # f32 d + 256 int8 + 16 i16 bsums
    GGMLType.IQ4_NL: (32, 18),    # f16 d + 16B nibble indices into kvalues table
    GGMLType.IQ4_XS: (QK_K, 136),  # f16 d + u16 scales_h + 4B scales_l + 128B nibbles
    # importance-matrix codebook formats (quant.iq_grids)
    GGMLType.IQ2_XXS: (QK_K, 66),  # f16 d + 32 u16 (grid idx + 7b signs + 4b scale)
    GGMLType.IQ2_XS: (QK_K, 74),   # f16 d + 32 u16 (9b grid idx + 7b signs) + 8B scales
    GGMLType.IQ2_S: (QK_K, 82),    # f16 d + 32B idx-lo + 32B signs + 8B qh + 8B scales
    GGMLType.IQ3_XXS: (QK_K, 98),  # f16 d + 64B grid idx + 32B (signs+scale u32 per 32)
    GGMLType.IQ3_S: (QK_K, 110),   # f16 d + 64B idx-lo + 8B qh + 32B signs + 4B scales
    GGMLType.IQ1_S: (QK_K, 50),    # f16 d + 32B idx-lo + 16B (u16: idx-hi+scale+delta)
    GGMLType.IQ1_M: (QK_K, 56),    # 32B idx-lo + 16B qh nibbles + 8B scales (d hidden)
}


def type_block_info(t: GGMLType) -> tuple[int, int]:
    """Return (elements_per_block, bytes_per_block) for a tensor type."""
    try:
        return GGML_BLOCK_INFO[GGMLType(t)]
    except KeyError:
        raise NotImplementedError(f"unsupported ggml type {t!r}") from None


def tensor_nbytes(n_elements: int, t: GGMLType) -> int:
    blk, nbytes = type_block_info(t)
    if n_elements % blk != 0:
        raise ValueError(f"{n_elements} elements not divisible by block size {blk} for {t!r}")
    return n_elements // blk * nbytes


# Canonical metadata keys (subset we produce/consume).
class Keys:
    ARCHITECTURE = "general.architecture"
    NAME = "general.name"
    QUANT_VERSION = "general.quantization_version"
    FILE_TYPE = "general.file_type"
    ALIGNMENT = "general.alignment"

    # architecture-prefixed (format with arch name, e.g. "llama.context_length")
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    VOCAB_SIZE = "{arch}.vocab_size"

    TOKENIZER_MODEL = "tokenizer.ggml.model"
    TOKENIZER_PRE = "tokenizer.ggml.pre"
    TOKENIZER_TOKENS = "tokenizer.ggml.tokens"
    TOKENIZER_SCORES = "tokenizer.ggml.scores"
    TOKENIZER_TOKEN_TYPE = "tokenizer.ggml.token_type"
    TOKENIZER_MERGES = "tokenizer.ggml.merges"
    TOKENIZER_BOS = "tokenizer.ggml.bos_token_id"
    TOKENIZER_EOS = "tokenizer.ggml.eos_token_id"
    TOKENIZER_UNK = "tokenizer.ggml.unknown_token_id"
    TOKENIZER_PAD = "tokenizer.ggml.padding_token_id"
    TOKENIZER_ADD_BOS = "tokenizer.ggml.add_bos_token"
    TOKENIZER_ADD_EOS = "tokenizer.ggml.add_eos_token"
    # fill-in-the-middle special tokens (llama.cpp /infill endpoint);
    # modern exports use fim_*, pre-2024 exports prefix/suffix/middle
    TOKENIZER_FIM_PRE = "tokenizer.ggml.fim_pre_token_id"
    TOKENIZER_FIM_SUF = "tokenizer.ggml.fim_suf_token_id"
    TOKENIZER_FIM_MID = "tokenizer.ggml.fim_mid_token_id"
    TOKENIZER_PREFIX = "tokenizer.ggml.prefix_token_id"
    TOKENIZER_SUFFIX = "tokenizer.ggml.suffix_token_id"
    TOKENIZER_MIDDLE = "tokenizer.ggml.middle_token_id"
    CHAT_TEMPLATE = "tokenizer.chat_template"


class TokenType(enum.IntEnum):
    """tokenizer.ggml.token_type values (llama.cpp vocab ABI)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
