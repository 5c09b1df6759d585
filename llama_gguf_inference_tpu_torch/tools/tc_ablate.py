"""Where the tensor-core matmul and flash kernels' time goes, on one card.

    python -m llama_gguf_inference_tpu_torch.tools.tc_ablate [--seed 0] [--kinds q4_k,q4_k_int8]
        [--full-only] [--shapes gate_up,o] [--rows 16,512]
    python -m llama_gguf_inference_tpu_torch.tools.tc_ablate --kinds flash_bf16,flash_q8,flash_paged
        [--rows 512] [--offsets 0,1024,7680] [--parent-csrc OTHER_TREE/llama_gguf_inference_tpu_torch/csrc]

The flash kinds (``flash_bf16``, ``flash_q8``, ``flash_q4``, ``flash_q41``,
``flash_paged``, ``flash_paged_q8``) build ``csrc/flash_attention_tc.cu`` as
it is and cut: with only its loads (the consumers wait for each stage and
hand it back; the converters forward each code stage unconverted), without
its conversion (quantized kinds' codes), without its softmax (the
exponentials and O's rescale replaced by the raw scores), without Q.K^T and
without P.V (one integer op in place of each ``wgmma``); and, still
computing the attention, with 64-key tiles, without the consumers'
ping-pong and with FlashAttention-3's in-warpgroup pipelining. Each at H 32
over KVH 8, D 128, B 1 (paged: beside an idle slot, pages of 256), T 512
(``--rows``), offsets 0, 1024 and 7680 (``--offsets``), beside the split
CUDA-core kernel, SDPA on a bf16 copy and the bound, and beside another
tree's body (``--parent-csrc``: its ``flash_attention_tc.cu`` built with
its own headers), in the same call.

Builds each tensor-core source into the build directory as it is and cut:
``csrc/quant_matmul_tc.cu`` (8-bit codes, ``wgmma``) without its decode (the
code words passed to ``wgmma`` as they are: no conversion, no factors),
without its products (one integer op on the fragments in place of each
``wgmma``), with only its loads (each stage waited for and handed back,
nothing computed), without its code loads (no code tiles fetched), without
its factor stage (each chunk's stage handed to the consumers unformed),
and, to split the time further, without any loads (the decode and
products alone), with only its decode and with only its products (no
loads either); ``csrc/quant_matmul_lowbit_tc.cu``
(2- and 4-bit codes, ``wgmma``) without its decode (the code words passed
to ``wgmma`` as they are), without its products (one integer op on the
fragments in place of each ``wgmma``, the min term's too), without its min
term (no A or B tiles formed, no min ``wgmma``), with only its loads (each
stage waited for and handed back, nothing computed) and without its code
loads (no code tiles fetched); ``csrc/quant_matmul_int8_tc.cu`` (int8
activations, s8 ``wgmma``) without its decode (the weight fragments'
shared-memory reads and byte transposes: constant fragments), without its
products (one integer op for each s8 ``wgmma`` and for the min term's),
without its epilogue (one f32 add a sum in place of the conversion, the two
scales, and their shared-memory loads), without its min-term
group (no -m' parts formed, no bf16 ``wgmma``), with only its loads
(each stage, code tile and factor stage waited for and handed back) and
without its code loads (no code tiles fetched); to split the time further,
without its factor stage (each group's TMA loads handed to the consumers as
they land), without the epilogue's table reads ((xs', c) from registers)
and without its x loads (no x tiles fetched). Times each build, and the
decode kernel and ``torch.matmul`` on a bf16 weight of the same shape, at
the 8B's projections for 8, 16, 32, 64 and 512 activation rows (the int8
body, the 2/4-bit fsplit kinds and the 8-bit ones at Q5_K and Q8_0 also
24, 48 and 300, about where their decode kernels cross and a ragged 128-row
tile; the Q6_K head 8 to 64), in the layout each kernel serves: Q5_K
compact (8-bit, with its min; ``q5_k_flat`` its flat layout, ``q8_0`` Q8_0's
flat o without a min, ``q6_k`` the Q6_K head, i8 sc per 16), Q4_K flat
(4-bit fsplit, the base rule, and the int8 body, which is also timed at o
with Q3_K's, Q4_0's and Q4_1's geometry) and Q2_K mixed (2-bit) or flat
(the base_f32 rule); codes and scales drawn from ``--seed``. The int8
kernel's bound takes its operations at the int8 rate. CUDA events, the L2
flushed before each launch, the median of 20. Prints the card's name and
power limit first, then one JSON line per shape. The cut builds compute
wrong outputs and are only timed; the full build is held to the plain
version first.

The kinds ``q5_k_decode`` and ``q6_k_decode`` cut the 8-bit decode kernel
of ``csrc/quant_matmul.cu`` instead (Q5_K compact at the four projections,
the Q6_K head; 1 and 4 rows): without its dequantization (the code words
passed to ``mma.sync`` as they are, so no scales are formed either), without
its products (one integer op a fragment in place of ``mma.sync``), without
its activation loads (zero fragments), and with rings of 8 and of 16 code
cells a warp in place of 8 without a min side and 4 with one. The kinds
``q4_k_decode`` and ``q2_k_decode`` cut the 2/4-bit decode kernel of the same
source (Q4_K flat at the four projections and Q3_K flat at o, or Q2_K
mixed, through the fsplit rule; 1 and 4 rows): without its decode (the code
words passed to ``mma.sync`` as they are), without its products (one
integer op in place of ``mma.sync``), without its activation loads (no
staging, fragments made from the lane's indices), without its min term,
with only its loads (each step waited for and nothing computed), without
its code loads (the code copies zero-filled), and with a ring of 3 steps a
warp in place of 2. The kind
``q4_k_int8_decode`` cuts the int8 decode kernel of the same source (Q4_K
flat at the four projections, and Q3_K flat at o for its instance of
16-wide sub-blocks; 1 and 4 rows): without its decode (constant code
fragments: no shared-memory reads, no byte transposes), without its
products (one integer op in place of ``mma.sync``), without its activation
loads (no staging, fragments made from the lane's indices), without its
epilogue (each sum added as it is: no conversion, scales or min term, no
table reads); to split the time, with only its loads (each step waited for
and nothing computed) and without its code loads (the code copies
zero-filled, so no code bytes leave the card's memory). ``--full-only``
times each kind's build as it is and cuts nothing: run from a parent
tree's sources (this module copied in), it times the kernel a redesign
replaces at the same shapes and seed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from ..ops import _build
from ..ops import quant_matmul as qm

SHAPES = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
          "down": (4096, 14336)}
ROWS = (8, 16, 32, 64, 512)
CROSS_ROWS = (8, 16, 24, 32, 48, 64, 300, 512)
DECODE_ROWS = (1, 4)
KINDS = ("q5_k", "q5_k_flat", "q8_0", "q6_k", "q4_k", "q2_k", "q4_k_int8", "q4_k_base",
         "q2_k_base", "q5_k_decode", "q6_k_decode", "q4_k_int8_decode", "q4_k_decode",
         "q2_k_decode", "flash_bf16", "flash_q8", "flash_paged")
# the tensor-core flash kernel's cache kinds (paged: pages of 256 beside an
# idle slot, as chip_smoke.py's rows), at H 32 over KVH 8, D 128, B 1, T 512
FLASH_KINDS = ("flash_bf16", "flash_q8", "flash_q4", "flash_q41", "flash_paged", "flash_paged_q8")
FLASH_OFFSETS = (0, 1024, 7680)
# the 8-bit tensor-core kernel's kinds: Q5_K compact (the Q5_K model's layout)
# and flat at the four projections, Q8_0 flat at o, the Q6_K head
EIGHT_BIT_KINDS = ("q5_k", "q5_k_flat", "q8_0", "q6_k")
# the int8 tensor-core kernel's texts that more than one of its cuts replace
_I8_WGMMA = "          wgmma_s8(bank[q % 2], Ab, db, keep);"
_I8_NO_WGMMA = """          bank[q % 2][0] += (int)(Ab[0] ^ Ab[3] ^ (uint32_t)db);
          named_bar_sync(1 + wg, 128);"""
_I8_MIN = """            wgmma_rs(acc[hh], mh, dh);
            wgmma_rs(acc[hh], mh, dm);
            wgmma_rs(acc[hh], ml, dh);
            wgmma_rs(acc[hh], mh, dl);
            wgmma_rs(acc[hh], ml, dm);"""
_I8_NO_MIN = "            acc[hh][0] += __int_as_float((int)(mh[0] ^ ml[1] ^ (uint32_t)(dh ^ dm ^ dl)));"
_I8_MIN_CALL = "        min_term();\n"
# without wgmmas the banks start at zero, not undefined
_I8_BANK_INIT = ("    int bank[2][32];", "    int bank[2][32] = {};")
_I8_CODES = """                uint32_t wd[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  wd[j] = *reinterpret_cast<const uint32_t*>(ct + code_at(r0 + 8 * r, tr + j, c / 4));
                transpose4(wd, col[r]);"""
# the 8-bit tensor-core kernel's texts that more than one of its cuts
# replace (each described at its cut in CUTS)
_T8_LOADS_ONLY = ("""      mbar_wait(full + st, (it / L::kStages) & 1);
      const unsigned char* const ct = sm + L::kCs + st * kT8Code;""",
                  """      mbar_wait(full + st, (it / L::kStages) & 1);
      if (a.bias != 12345) {
        named_bar_sync(1 + wg, 128);   // every warp is past this stage's wait
        if ((tid & 127) == 0) {
          mbar_arrive(empty + st);
          if (fdue >= 0) mbar_arrive(fempty + fdue);
        }
        fdue = first ? ck % L::kFac : -1;
        ck += first;
        acc[0] += sm[st * L::kX + lane];
        ++it;
        return;
      }
      const unsigned char* const ct = sm + L::kCs + st * kT8Code;""")
_T8_NO_DECODE = ("""          decode4<kM>(__byte_perm(lo, hi, csel) ^ 0x80808080u, fs[r][kk], fm[r][kk], magic,
                      A[kk][r], A[kk][2 + r]);""", """          A[kk][r] = __byte_perm(lo, hi, csel);
          A[kk][2 + r] = lo ^ hi;""")
_T8_NO_PRODUCTS = ("      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, A[kk], dx + 2 * kk);",
                   """      for (int kk = 0; kk < 4; ++kk) acc[kk] += __int_as_float(A[kk][0] ^ A[kk][3] ^ (int)dx);
      named_bar_sync(1 + wg, 128);""")
_T8_NO_LOADS = [("            mbar_arrive_tx(full + st, L::kX + kT8Code);",
                 "            mbar_arrive(full + st);"),
                ("            tma_load_2d(sm + st * L::kX, &tmx, j0, n0, full + st);", ""),
                ("            tma_load_2d(sm + L::kCs + st * kT8Code, &tmc, j0, m0, full + st);", "")]
_T8_NO_CODE_LOADS = [("            mbar_arrive_tx(full + st, L::kX + kT8Code);",
                      "            mbar_arrive_tx(full + st, L::kX);"),
                     ("            tma_load_2d(sm + L::kCs + st * kT8Code, &tmc, j0, m0, full + st);",
                      "")]
# the flash kernel's texts that more than one of its cuts replace
_FA_NO_CONVERT = [("        convert_tile<D, KIND, KT>(cd, kd, ct);", ""),
                  ("        convert_tile<D, KIND, KT>(cd + KT * RB, kd + L::kKV, ct);", "")]
_FA_EXP = """          const float p = KIND == kFBF16 ? ex2_approx(fmaf(sacc[4 * jj + e], c1, -m_new[h]))
                                         : ex2_approx(sacc[4 * jj + e] - m_new[h]);"""
_FA_QK = "        wgmma_rs(sacc, qf[kk], dk + (kk / 4) * (KT * 128 >> 4) + 2 * (kk % 4), kk);"
# kind -> (library, its cut set)
SOURCE = {**{k: ("quant_matmul_tc",) * 2 for k in EIGHT_BIT_KINDS},
          "q4_k_int8": ("quant_matmul_int8_tc",) * 2,
          **{k: ("quant_matmul_lowbit_tc",) * 2
             for k in ("q4_k", "q2_k", "q4_k_base", "q2_k_base")},
          "q5_k_decode": ("quant_matmul", "quant_matmul_8bit"),
          "q6_k_decode": ("quant_matmul", "quant_matmul_8bit"),
          "q4_k_int8_decode": ("quant_matmul", "quant_matmul_int8"),
          **{k: ("quant_matmul", "quant_matmul_lowbit") for k in ("q4_k_decode", "q2_k_decode")},
          **{k: ("flash_attention_tc",) * 2 for k in FLASH_KINDS}}
# each cut set's builds: the text each replaces (or a list of such edits)
CUTS = {
    "quant_matmul_8bit": {
        "no_decode": ("      decode16<kM>(c4, s, m, magic, w);",
                      """#pragma unroll
      for (int h = 0; h < 8; ++h) w[h] = (&c4.x)[h / 2] ^ (h & 1);"""),
        "no_products": ("        mma_bf16(acc[q & 1], af, w[2 * q], w[2 * q + 1]);",
                        "        acc[q & 1][q] += __int_as_float(af[0] ^ w[2 * q] ^ w[2 * q + 1]);"),
        "no_x": ("      if (x_live && j < a.in_f) {", "      if (false) {"),
        "ring8": ("constexpr int k8Ring = kM == kNone ? 8 : 4;", "constexpr int k8Ring = 8;"),
        "ring16": ("constexpr int k8Ring = kM == kNone ? 8 : 4;",
                   "constexpr int k8Ring = 16;")},
    "quant_matmul_int8": {
        # each edit of the sub-32 path is followed by its k16 path's
        "no_decode": [
            ("""        const uint32_t w[4] = {(&cw[0].x)[q], (&cw[1].x)[q], (&cw[2].x)[q], (&cw[3].x)[q]};
        transpose4(w, col);""",
             """#pragma unroll
        for (int j = 0; j < 4; ++j) col[j] = 0x01020304u * (j + 1) ^ q;"""),
            ("""          const uint32_t w[4] = {cw[0][q], cw[1][q], cw[2][q], cw[3][q]};
          transpose4(w, col);""",
             """#pragma unroll
          for (int j = 0; j < 4; ++j) col[j] = 0x01020304u * (j + 1) ^ q ^ h;""")],
        "no_products": [
            ("          mma_s8_k32(pr, af, col[c] & 0x0F0F0F0Fu, (col[c] >> 4) & 0x0F0F0F0Fu, kI8Magic);",
             """#pragma unroll
          for (int e = 0; e < 4; ++e) pr[e] = kI8Magic + (int)(af[e] ^ col[c]);"""),
            ("""            mma_s8_k32(dk, af, (col[c] >> nib) & 0x0F0F0F0Fu, (col[c + 1] >> nib) & 0x0F0F0F0Fu,
                       c0);""",
             """#pragma unroll
            for (int e = 0; e < 4; ++e) dk[e] = c0 + (int)(af[e] ^ col[c] ^ (col[c + 1] >> nib));""")],
        "no_x": [("    for (int u = tid; u < ng * nbs * nw; u += nthr) {",
                  "    for (int u = tid; u < 0; u += nthr) {"),
                 ("          const uint2 xv = *reinterpret_cast<const uint2*>(xf + ((size_t)k * nbs + gx) * 8 + 2 * t);",
                  "          const uint2 xv = {(unsigned)lane, (unsigned)k};"),
                 ("            const uint32_t af[4] = {xk[(size_t)c * nbs * nw], 0u, 0u, xk[(size_t)(c + 1) * nbs * nw]};",
                  "            const uint32_t af[4] = {(unsigned)lane, 0u, 0u, (unsigned)(c + 4 * q + h)};")],
        "no_epilogue": ("""      const float2 sv = tab_s[sl * kI8Rows + 2 * t + e];
      acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(pf[e], xv.x), sv.x));
      acc[e] = fmaf(-xv.y, sv.y, acc[e]);""", "      acc[e] += pf[e];"),
        "loads_only": ("    const unsigned char* sb = ring + (i % kI8Ring) * p.slot + lane * kCB;",
                       """    const unsigned char* sb = ring + (i % kI8Ring) * p.slot + lane * kCB;
    if (a.bias != 12345) {
      acc[0] += sb[0];
      continue;
    }"""),
        "no_code_loads": ("        const bool ok = kK32 || cr < hsub;", "        const bool ok = false;")},
    "quant_matmul_lowbit": {
        "no_decode": ("              lb_decode<kVar, kM, kMap>(nib, fac, q, magic, w0, w1);",
                      """              w0 = nib;
              w1 = nib >> 1;"""),
        "no_products": ("              mma_bf16(acc[kVar == kSplit ? pl : h], af, w0, w1);",
                        "              acc[h][q] += __int_as_float(af[0] ^ w0 ^ w1);"),
        "no_x": [("    for (int u = tid; u < nbs * cpr; u += nthr) {",
                  "    for (int u = tid; u < 0; u += nthr) {"),
                 ("""            const uint4 xv = ok ? *reinterpret_cast<const uint4*>(xq + (pl * 2 + qq) * nbs * 64)
                                : uint4{0, 0, 0, 0};""",
                  """            const uint4 xv = {(unsigned)lane, (unsigned)pl, (unsigned)qq, (unsigned)i2};""")],
        "no_min": ("      if (min_live) {\n#pragma unroll\n        for (int b = 0;",
                   "      if (false) {\n#pragma unroll\n        for (int b = 0;"),
        "loads_only": ("    const unsigned char* sb = ring + (i % kLbRing) * p.slot;",
                       """    const unsigned char* sb = ring + (i % kLbRing) * p.slot;
    if (a.bias != 12345) {
      acc[0][0] += sb[lane];
      continue;
    }"""),
        "no_code_loads": ("        const bool ok = pc < np;\n        cp_async16(",
                          "        const bool ok = false;\n        cp_async16("),
        "ring3": ("constexpr int kLbRing = 2;", "constexpr int kLbRing = 3;")},
    "quant_matmul_tc": {
        # the code words passed to wgmma as they are: no conversion, no
        # scales or mins (and so no factor reads)
        "no_decode": _T8_NO_DECODE,
        # one integer op on the fragments in place of each wgmma; a
        # warpgroup barrier keeps its warps within a step of each other, as
        # the wgmma's own collective issue did
        "no_products": _T8_NO_PRODUCTS,
        # each stage (and factor stage) waited for and handed back, nothing
        # decoded or multiplied
        "loads_only": _T8_LOADS_ONLY,
        # no code tiles fetched: the consumers decode whatever the ring holds
        "no_code_loads": _T8_NO_CODE_LOADS,
        # no loads at all (each stage's barrier armed for no bytes): the
        # decode and products alone, on whatever the ring holds
        "no_loads": _T8_NO_LOADS,
        # the decode alone, and the products alone: no loads, and no
        # products or no decode
        "decode_only": [*_T8_NO_LOADS, _T8_NO_PRODUCTS],
        "products_only": [*_T8_NO_LOADS, _T8_NO_DECODE],
        # no factor stage formed: each chunk's stage handed to the consumers
        # at once, holding whatever it held
        "no_factor_stage": ("          mbar_wait(fempty + fb, ((ck / L::kFac) & 1) ^ 1);",
                            """          mbar_wait(fempty + fb, ((ck / L::kFac) & 1) ^ 1);
          if (a.bias != 12345) {
            __syncwarp();
            if (lane == 0) mbar_arrive(ffull + fb);
            continue;
          }""")},
    "quant_matmul_lowbit_tc": {
        "no_decode": ("""          decode4<kVar, kM, kMap>((creg[r][kk] >> (kBits * p)) & kMask, fa[r][kk], fb[r][kk],
                                  magic, A[kk][r], A[kk][2 + r]);""",
                      """        {
          A[kk][r] = creg[r][kk] >> p;
          A[kk][2 + r] = creg[r][kk] ^ p;
        }"""),
        "no_products": [
            # a warpgroup barrier keeps its warps within a step of each other,
            # as the wgmma's own collective issue did
            ("      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, A[kk], dx + 2 * kk);",
             """      for (int kk = 0; kk < 4; ++kk) acc[kk] += __int_as_float(A[kk][0] ^ A[kk][3] ^ (int)dx);
      named_bar_sync(1 + wg, 128);"""),
            ("""            wgmma_ss(acc, dh + 2 * kk, xh + 2 * kk);
            wgmma_ss(acc, dh + 2 * kk, xl + 2 * kk);
            wgmma_ss(acc, dl + 2 * kk, xh + 2 * kk);""",
             "            acc[kk] += __int_as_float((int)(dh ^ xl ^ dl));")],
        "no_min": ("  const bool min_live = kMinTerm<kVar> && (kM != kNone || a.bias != 0);",
                   "  const bool min_live = false;"),
        "loads_only": [
            ("  const bool min_live = kMinTerm<kVar> && (kM != kNone || a.bias != 0);",
             "  const bool min_live = false;"),
            ("      mbar_wait(full + st, (it / L::kStages) & 1);\n      if (p == 0) {",
             """      mbar_wait(full + st, (it / L::kStages) & 1);
      if (a.bias != 12345) {
        named_bar_sync(1 + wg, 128);   // every warp is past this stage's wait
        if ((tid & 127) == 0) {
          mbar_arrive(empty + st);
          if (aux_pend && n == 1) mbar_arrive(aux_empty);
        }
        aux_pend = aux_pend && n == 0;
        acc[0] += sm[st * L::kX + lane];
        ++it;
        return;
      }
      if (p == 0) {""")],
        "no_code_loads": [
            ("            mbar_arrive_tx(full + st, L::kX + (p == 0 ? kLtCode : 0));",
             "            mbar_arrive_tx(full + st, L::kX);"),
            ("            if (p == 0) tma_load_2d(sm + L::kCs + st * kLtCode, &tmc, j0, m0, full + st);",
             "            if (false) tma_load_2d(sm + L::kCs + st * kLtCode, &tmc, j0, m0, full + st);")]},
    "quant_matmul_int8_tc": {
        # constant code fragments: no code-tile reads, no byte transposes
        "no_decode": (_I8_CODES, """#pragma unroll
                for (int j = 0; j < 4; ++j) col[r][j] = 0x01020304u * (j + 1) ^ (uint32_t)(kg + c + r);"""),
        # one integer op in place of each s8 wgmma and of the min term's; a
        # warpgroup barrier keeps its warps within a unit of each other, as
        # the wgmma's collective issue did
        "no_products": [(_I8_WGMMA, _I8_NO_WGMMA), (_I8_MIN, _I8_NO_MIN), _I8_BANK_INIT],
        # each sum added as it is: no conversion, no scales, no table reads
        "no_epilogue": ("""#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // at most 2 float4 of (xs', c) loaded ahead of their use
            if (j % 2 == 0 && j > 0) asm volatile("" ::: "memory");
            const float4 xv = xt[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pf = __int_as_float(bank[q % 2][4 * j + e] + kMagic);
              const float tx = __fmaf_rn(pf, e & 1 ? xv.z : xv.x, e & 1 ? xv.w : xv.y);
              acc[h][4 * j + e] = __fmaf_rn(tx, e >> 1 ? sv.y : sv.x, acc[h][4 * j + e]);
            }
          }""", """#pragma unroll
          for (int i = 0; i < 32; ++i) acc[h][i] += __int_as_float(bank[q % 2][i]);"""),
        # no min-term group: no -m' parts formed, no bf16 wgmma
        "no_min": (_I8_MIN_CALL, ""),
        # each stage, code tile and factor stage waited for and handed back,
        # nothing read or computed
        "loads_only": [(_I8_MIN_CALL, ""), (_I8_WGMMA, _I8_NO_WGMMA), _I8_BANK_INIT,
                       (_I8_CODES, """#pragma unroll
                for (int j = 0; j < 4; ++j) col[r][j] = (uint32_t)(kg + c + r + j);"""),
                       ("          epilogue(qc);",
                        "          acc[h][0] += __int_as_float(bank[q % 2][0]);")],
        # no factor stage formed: each group's stage handed to the
        # consumers as its TMA loads land, no (xs', c) or xsum parts written
        "no_factor_stage": ("          unsigned char* const raw = ax + L::kAuxX;", """          if (a.bias != 12345) {
            __syncwarp();
            if (lane == 0) mbar_arrive(afull + as);
            continue;
          }
          unsigned char* const raw = ax + L::kAuxX;"""),
        # the epilogue's (xs', c) from registers, not the table: its
        # shared-memory reads alone cut
        "no_epilogue_loads": ("            const float4 xv = xt[4 * j];",
                              "            const float4 xv = {sv.x + j, sv.y, sv.x - j, sv.y * j};"),
        # no x tiles fetched (each stage's barrier armed for no bytes): the
        # products read whatever the ring holds
        "no_x_loads": ("""              mbar_arrive_tx(full + st, L::kX);
              tma_load_2d(sm + st * L::kX, &tmx, (grp * kSpg + s) * 128, n0, full + st);""",
                       "              mbar_arrive(full + st);"),
        # no code tiles fetched: the consumers read whatever the ring holds
        "no_code_loads": ("""            mbar_arrive_tx(cfull + (gc & 1), L::kCode);
            for (int tp = 0; tp < kSub / 2; ++tp)
              tma_load_2d(cd + tp * kI8M * kI8G, &tmc, tp * a.nsub + grp * kI8G, m0,
                          cfull + (gc & 1));""", "            mbar_arrive(cfull + (gc & 1));")},
    "flash_attention_tc": {
        # consumers wait for each stage and hand it back, computing nothing;
        # the converters forward each code stage unconverted
        "loads_only": [("    const int c_tiles = tiles_of(wg);",
                        "    const int c_tiles = a.scale == 12345.f ? tiles_of(wg) : 0;"),
                       *_FA_NO_CONVERT],
        "no_convert": _FA_NO_CONVERT,
        # the exponentials and O's rescale replaced by the raw scores (the max,
        # the sums and the packing stay)
        "no_softmax": [(_FA_EXP, "          const float p = sacc[4 * jj + e];"),
                       ("        alpha[h] = ex2_approx(m_i[h] - m_new[h]);", "        alpha[h] = 1.f;"),
                       ("        o[i] = KIND == kFQ41 ? fmaf(o[i], alpha[h], pm[h]) : o[i] * alpha[h];",
                        "        o[i] += pm[h];")],
        # one integer op on the descriptors in place of each S = Q.K^T wgmma
        "no_qk": (_FA_QK, "        sacc[kk] += __int_as_float((int)(qf[kk][0] ^ (uint32_t)dk) + kk);"),
        # one integer op on P's fragments in place of each P.V wgmma
        "no_pv": ("      for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs_tb(o, pa[kk], dv + kk * (16 * 128 >> 4));",
                  """      for (int kk = 0; kk < KT / 16; ++kk)
        o[kk] += __int_as_float((int)(pa[kk][0] ^ pa[kk][3] ^ (uint32_t)dv));"""),
        # tiles of 64 keys, and the consumers' products unordered: both still
        # compute the attention
        "keys_other": ("  static constexpr int kKT = 128;                         // keys a tile",
                       "  static constexpr int kKT = 64;"),
        "no_pingpong": ("    const int common = min(c_tiles > 0 ? c_tiles + 1 : 0, o_tiles > 0 ? o_tiles + 1 : 0);",
                        "    const int common = 0;"),
        # FlashAttention-3's in-warpgroup pipelining: tile j's softmax under
        # tile j-1's P.V (it still computes the attention)
        "pipelined": ("""      wgmma_wait<0>();   // S of tile j and tile j-1's P.V
      fence_regs(sacc);
      fence_regs(o);
      if ((tid & 127) == 0) mbar_arrive(vempty + (j - 1) % NS);
      softmax(j, alpha, pm);""", """      wgmma_wait<1>();
      fence_regs(sacc);
      softmax(j, alpha, pm);
      wgmma_wait<0>();
      fence_regs(o);
      fence_pa();
      if ((tid & 127) == 0) mbar_arrive(vempty + (j - 1) % NS);""")}}


def _builds(source: str, cuts: str, full_only: bool) -> dict[str, ctypes.CDLL]:
    with open(os.path.join(_build._CSRC, source + ".cu")) as f:
        src = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, edits in ({} if full_only else CUTS[cuts]).items():
        cut = src
        for old, new in edits if isinstance(edits, list) else [edits]:
            if cut.count(old) != 1:
                raise RuntimeError(f"{source} {name}: the source no longer holds {old!r} once")
            cut = cut.replace(old, new)
        cu = os.path.join(_build.BUILD_DIR, f"tc_ablate_{cuts}_{name}.cu")
        with open(cu, "w") as f:
            f.write(cut)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC,
                                        cu, "-o", cu[:-3] + ".so"], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {"full": _build.library(source)}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        path = os.path.join(_build.BUILD_DIR, f"tc_ablate_{cuts}_{name}.so")
        libs[name] = _build._bind(source, ctypes.CDLL(path))
    return libs


def _parent_build(csrc: str, source: str) -> ctypes.CDLL:
    """``source`` as another tree's ``csrc`` directory holds it (its own
    headers), built into the build directory and bound as this tree's."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"tc_ablate_parent_{source}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                           os.path.join(csrc, source + ".cu"), "-o", out],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {source}:\n{proc.stdout}")
    return _build._bind(source, ctypes.CDLL(out))


def _flash_case(kind: str, T: int, off: int, g: torch.Generator):
    """(tensor-core wrapper, plain version, args, SDPA's bf16 K and V, key
    bytes) of one flash call: B 1 (paged: beside an idle slot whose table
    row is all -1, shuffled pages of 256), H 32 over KVH 8, D 128, S the
    offset's keys rounded up to 1024."""
    from ..ops import flash_attention as fa
    from ..runtime.kv_cache import QuantKV, QuantKV4, QuantKV41
    H, KVH, D, page = 32, 8, 128, 256
    S = max(1024, -(-(off + T) // 1024) * 1024)
    paged = kind.startswith("flash_paged")
    B = 2 if paged else 1

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    q = rand(B, T, H, D).bfloat16()
    offs = torch.tensor([off] + [0] * (B - 1), dtype=torch.int32, device="cuda")
    if paged:
        NP = S // page
        table = torch.randperm(B * NP, generator=g, device="cuda").int().reshape(B, NP)
        table[0, -(-(off + T) // page):] = -1
        table[1] = -1
        k, v = rand(B * NP, KVH, page, D).bfloat16(), rand(B * NP, KVH, page, D).bfloat16()
        if kind == "flash_paged":
            return (fa.flash_attention_paged_tc, fa.flash_attention_paged_plain,
                    (q, k, v, offs, table), fa.gather_pages(k, table), fa.gather_pages(v, table),
                    2 * D * 2)
        kc, vc = QuantKV.quantize(k), QuantKV.quantize(v)
        lk, lv = (QuantKV.dequantize(fa.gather_pages(c, table), fa.gather_pages(sc, table))
                  for c, sc in (kc, vc))
        return (fa.flash_attention_paged_q8_tc, fa.flash_attention_paged_q8_plain,
                (q, kc[0], kc[1], vc[0], vc[1], offs, table), lk, lv, 2 * (D + 4))
    k, v = rand(B, KVH, S, D).bfloat16(), rand(B, KVH, S, D).bfloat16()
    if kind == "flash_bf16":
        return fa.flash_attention_tc, fa.flash_attention_plain, (q, k, v, offs), k, v, 2 * D * 2
    codec, name, kb = {"flash_q8": (QuantKV, "q8", 2 * (D + 4)),
                       "flash_q4": (QuantKV4, "q4", 2 * (D // 2 + 4)),
                       "flash_q41": (QuantKV41, "q41", 2 * (D // 2 + 8))}[kind]
    kc, vc = codec.quantize(k), codec.quantize(v)
    return (getattr(fa, f"flash_attention_{name}_tc"), getattr(fa, f"flash_attention_{name}_plain"),
            (q, *kc, *vc, offs), codec.dequantize(*kc), codec.dequantize(*vc), kb)


def _flash_rows(kind: str, libs: dict, flush: torch.Tensor, g: torch.Generator, rows,
                offsets) -> None:
    """One JSON line per (T, offset) of a flash kind: each build's ms (the
    builds that still compute the attention, and the parent's, also their
    error to the plain version), the CUDA-core split kernel's (the crossover
    that sets FLASH_TC_MIN_ROWS), SDPA's on a bf16 copy, and the bound."""
    import torch.nn.functional as F

    from ..ops import flash_attention as fa
    for T in rows:
        for off in offsets:
            tc, plain, args, lk, lv, key_bytes = _flash_case(kind, T, off, g)
            want = plain(*args).float()
            row = {"shape": f"{kind} T={T} offset={off} S={lk.shape[2]}", "T": T}
            for build, lib in libs.items():
                _build._LIBS["flash_attention_tc"] = lib
                if build in ("full", "keys_other", "no_pingpong", "pipelined", "parent"):
                    err = (tc(*args).float() - want).abs().max() / want.abs().max()
                    row[f"{build}_rel_err"] = err.item()
                row[f"{build}_ms"] = _timer(flush, lambda: tc(*args))
            _build._LIBS["flash_attention_tc"] = libs["full"]
            dec = getattr(fa, tc.__name__[:-3] + "_decode")   # the CUDA-core split kernel
            row["decode_kernel_ms"] = _timer(flush, lambda: dec(*args), 5 if off > 2048 else 20)
            pos = off + torch.arange(T, device="cuda")
            mask = (torch.arange(lk.shape[2], device="cuda")[None] <= pos[:, None])[None, None]
            qt = args[0][:1].transpose(1, 2)
            row["library_ms"] = _timer(flush, lambda: F.scaled_dot_product_attention(
                qt, lk[:1], lv[:1], attn_mask=mask, enable_gqa=True))
            H, D = args[0].shape[2], args[0].shape[3]
            KVH = lk.shape[1]
            offs = [off] + [0] * (args[0].shape[0] - 1)   # the paged kinds' idle slot too
            pairs = sum(o * T + T * (T + 1) // 2 for o in offs)
            nbytes = sum(o + T for o in offs) * KVH * key_bytes + 2 * args[0].numel() * 2
            row["bound_ms"] = max(4.0 * H * D * pairs / 989e12, nbytes / 3.35e12) * 1e3
            print(json.dumps(row), flush=True)
            del args, lk, lv, want


def _timer(flush: torch.Tensor, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _u8(out_f: int, n: int, g: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 16, (out_f, n), generator=g, device="cuda").to(torch.uint8)


def _f32(out_f: int, n: int, scale: float, g: torch.Generator) -> torch.Tensor:
    return torch.rand(out_f, n, generator=g, device="cuda") * scale + scale / 10


def _case(kind: str, out_f: int, in_f: int, B: int, g: torch.Generator, fmt: str = ""):
    """(source, tensor-core wrapper, decode wrapper, plain version, args) of
    one kernel's call on random arrays (the decode kinds: no tensor-core
    wrapper, the decode kernel in its place): Q5_K
    compact (5-bit codes, f32 d and dmin per 256, u8 sc and mn per 32), Q4_K
    flat (f32 d and dmin per 32; fsplit, ``q4_k_base`` the base rule,
    ``q4_k_int8`` the int8 body on quantize_acts' codes), Q2_K mixed (f32 d
    per 16, f32 dmin per 256 with u8 mn per 16) or ``q2_k_base`` flat (the
    base_f32 rule, f32 d and dmin per 16); ``q4_k_int8_decode`` Q4_K flat
    through the int8 decode kernel, or with ``q3_k`` Q3_K flat (f32 d per
    16, no min, codes biased by 4); ``fmt`` ``q3_k`` is that (sub-blocks of
    16 through the 2/4-bit and int8 decode kinds), and ``q3_k``, ``q4_0``
    (bias 8, no min) or ``q4_1`` (flat min) give ``q4_k_int8`` that
    format's geometry."""
    q3_k = fmt == "q3_k"
    x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
    if kind in ("q4_k_decode", "q2_k_decode"):
        bits, sub = (4, 16 if q3_k else 32) if kind == "q4_k_decode" else (2, 16)
        nsub = in_f // sub
        codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, device="cuda",
                              dtype=torch.uint8)
        xsum = qm._block_sums(x, sub)
        if bits == 4:
            arrs = (codes, _f32(out_f, nsub, 1e-2, g), None,
                    None if q3_k else _f32(out_f, nsub, 5e-2, g), None)
        else:
            arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, _f32(out_f, in_f // 256, 5e-3, g),
                    _u8(out_f, nsub, g))
            xsum = xsum.reshape(B, in_f // 256, 256 // sub).transpose(1, 2).reshape(B, nsub)
            xsum = xsum.contiguous()
        return ("quant_matmul", getattr(qm, f"quant_matmul_{bits}bit_decode"), None,
                getattr(qm, f"quant_matmul_{bits}bit_plain"),
                (x, xsum, *arrs, 4 if q3_k else 0))
    if kind == "q4_k_int8_decode":
        sub = 16 if q3_k else 32
        nsub = in_f // sub
        codes = torch.randint(0, 256, (out_f, in_f // 2), generator=g, device="cuda",
                              dtype=torch.uint8)
        xq, xs = qm.quantize_acts(x, sub)
        dmin = None if q3_k else _f32(out_f, nsub, 5e-2, g)
        return ("quant_matmul", qm.quant_matmul_4bit_int8_decode, None,
                qm.quant_matmul_4bit_int8_plain,
                (xq, xs, qm._block_sums(x, sub), codes, _f32(out_f, nsub, 1e-2, g), None,
                 dmin, None, 4 if q3_k else 0))
    if kind.endswith("_decode"):
        sub, signed, has_min = (32, False, True) if kind == "q5_k_decode" else (16, True, False)
        nsub, nd = in_f // sub, in_f // 256
        codes = torch.randint(-32 if signed else 0, 32, (out_f, in_f), generator=g,
                              device="cuda").to(torch.int8)
        sc = torch.randint(-32 if signed else 0, 32, (out_f, nsub), generator=g, device="cuda")
        arrs = (codes, _f32(out_f, nd, 1e-3, g), sc.to(torch.int8 if signed else torch.uint8),
                sub, 0, _f32(out_f, nd, 5e-3, g) if has_min else None,
                _u8(out_f, nsub, g) if has_min else None)
        return ("quant_matmul", qm.quant_matmul_8bit_decode, None, qm.quant_matmul_8bit_plain,
                (x, *arrs))
    if kind in EIGHT_BIT_KINDS:
        sub = 16 if kind == "q6_k" else 32
        nsub, nd = in_f // sub, in_f // 256
        lo, hi = {"q8_0": (-128, 128), "q6_k": (-32, 32)}.get(kind, (0, 32))
        codes = torch.randint(lo, hi, (out_f, in_f), generator=g, device="cuda").to(torch.int8)
        if kind == "q5_k":
            arrs = (codes, _f32(out_f, nd, 1e-3, g), _u8(out_f, nsub, g), sub, 0,
                    _f32(out_f, nd, 5e-3, g), _u8(out_f, nsub, g))
        elif kind == "q5_k_flat":
            arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, sub, 0, _f32(out_f, nsub, 5e-2, g),
                    None)
        elif kind == "q8_0":
            arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, sub, 0)
        else:
            sc = torch.randint(-32, 32, (out_f, nsub), generator=g, device="cuda").to(torch.int8)
            arrs = (codes, _f32(out_f, nd, 1e-3, g), sc, sub, 0)
        return ("quant_matmul_tc", qm.quant_matmul_8bit_tc, qm.quant_matmul_8bit_decode,
                qm.quant_matmul_8bit_plain, (x, *arrs))
    bits, sub = (4, 32) if kind.startswith("q4_k") else (2, 16)
    nsub = in_f // sub
    codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, device="cuda",
                          dtype=torch.uint8)
    xsum = qm._block_sums(x, sub)
    if kind in ("q4_k_base", "q2_k_base", "q4_k_int8"):
        arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, _f32(out_f, nsub, 5e-2, g), None)
        if kind == "q4_k_int8":
            sub = 16 if q3_k else 32
            nsub = in_f // sub
            arrs = (codes, _f32(out_f, nsub, 1e-2, g), None,
                    None if fmt in ("q3_k", "q4_0") else _f32(out_f, nsub, 5e-2, g), None)
            xq, xs = qm.quantize_acts(x, sub)
            return ("quant_matmul_int8_tc", qm.quant_matmul_4bit_int8_tc,
                    qm.quant_matmul_4bit_int8_decode, qm.quant_matmul_4bit_int8_plain,
                    (xq, xs, qm._block_sums(x, sub), *arrs,
                     {"q3_k": 4, "q4_0": 8}.get(fmt, 0)))
        if kind == "q4_k_base":
            return ("quant_matmul_lowbit_tc", qm.quant_matmul_4bit_base_tc,
                    qm.quant_matmul_4bit_base_decode, qm.quant_matmul_4bit_base_plain,
                    (x, *arrs, 0))
        return ("quant_matmul_lowbit_tc", qm.quant_matmul_lowbit_base_tc,
                qm.quant_matmul_lowbit_base_decode, qm.quant_matmul_lowbit_base_plain,
                (x, *arrs, 0, 2))
    if kind == "q4_k":
        arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, _f32(out_f, nsub, 5e-2, g), None)
    else:
        arrs = (codes, _f32(out_f, nsub, 1e-2, g), None, _f32(out_f, in_f // 256, 5e-3, g),
                _u8(out_f, nsub, g))
        xsum = xsum.reshape(B, in_f // 256, 256 // sub).transpose(1, 2).reshape(B, nsub)
        xsum = xsum.contiguous()
    return ("quant_matmul_lowbit_tc", getattr(qm, f"quant_matmul_{bits}bit_tc"),
            getattr(qm, f"quant_matmul_{bits}bit_decode"),
            getattr(qm, f"quant_matmul_{bits}bit_plain"), (x, xsum, *arrs, 0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated kernels and layouts to time (default: all)")
    ap.add_argument("--full-only", action="store_true",
                    help="time each source as it is, with no cut builds")
    ap.add_argument("--shapes", default="",
                    help="comma-separated projections to time (default: each kind's all)")
    ap.add_argument("--rows", default="",
                    help="comma-separated activation row counts (default: each kind's own; "
                         "flash kinds: query positions, default 512)")
    ap.add_argument("--offsets", default=",".join(map(str, FLASH_OFFSETS)),
                    help="flash kinds: comma-separated offsets (cached keys before the chunk)")
    ap.add_argument("--parent-csrc", default="",
                    help="flash kinds: another tree's csrc directory, whose "
                         "flash_attention_tc.cu is timed beside this tree's builds")
    a = ap.parse_args()
    kinds = a.kinds.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {src: _builds(*src, a.full_only) for src in {SOURCE[k] for k in kinds}}
    if a.parent_csrc and ("flash_attention_tc",) * 2 in libs:
        libs[("flash_attention_tc",) * 2]["parent"] = _parent_build(a.parent_csrc,
                                                                     "flash_attention_tc")
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    for kind in kinds:
        if kind in FLASH_KINDS:
            with torch.inference_mode():
                _flash_rows(kind, libs[SOURCE[kind]], flush, g,
                            tuple(int(r) for r in a.rows.split(",")) if a.rows else (512,),
                            tuple(int(o) for o in a.offsets.split(",")))
            continue
        decode_kind = kind.endswith("_decode")
        shapes = {"head": (128256, 4096)} if kind in ("q6_k_decode", "q6_k") else SHAPES
        if kind == "q8_0":
            shapes = {"o": SHAPES["o"]}
        if kind in ("q4_k_int8_decode", "q4_k_decode"):
            shapes = {**SHAPES, "q3_k_o": SHAPES["o"]}
        if kind == "q4_k_int8":
            shapes = {**SHAPES, **{f"{f}_o": SHAPES["o"] for f in ("q3_k", "q4_0", "q4_1")}}
        rows = DECODE_ROWS if decode_kind else CROSS_ROWS \
            if kind in ("q4_k_int8", "q4_k", "q2_k", "q5_k", "q5_k_flat", "q8_0") \
            else ROWS[:4] if kind == "q6_k" else ROWS
        if a.shapes:
            shapes = {k: v for k, v in shapes.items() if k in a.shapes.split(",")}
        if a.rows:
            rows = tuple(int(r) for r in a.rows.split(","))
        for name, (out_f, in_f) in shapes.items():
            w_lib = torch.randn(out_f, in_f, generator=g, device="cuda").bfloat16()
            for B in rows:
                fmt = name[:-2] if name.endswith("_o") else ""
                src, tc, decode, plain, args = _case(kind, out_f, in_f, B, g, fmt)
                row = {"shape": f"{kind} {name} {out_f}x{in_f}", "B": B}
                for build, lib in libs[SOURCE[kind]].items():
                    _build._LIBS[src] = lib
                    if build == "full":
                        want = plain(*args)
                        row["rel_err"] = ((tc(*args) - want).abs().max()
                                          / want.abs().max()).item()
                    row[f"{build}_ms"] = _timer(flush, lambda: tc(*args))
                _build._LIBS[src] = libs[SOURCE[kind]]["full"]
                if not decode_kind:
                    row["decode_kernel_ms"] = _timer(flush, lambda: decode(*args),
                                                     5 if B > 64 else 20)
                xb = args[0].bfloat16()   # the int8 body's codes, as bf16, for the yardstick
                row["torch_matmul_ms"] = _timer(flush, lambda: torch.matmul(xb, w_lib.t()))
                nbytes = sum(t.numel() * t.element_size() for t in args
                             if isinstance(t, torch.Tensor)) + B * out_f * 4
                rate = 1979e12 if kind.startswith("q4_k_int8") else 989e12
                row["bound_ms"] = max(2.0 * B * in_f * out_f / rate, nbytes / 3.35e12) * 1e3
                print(json.dumps(row), flush=True)
                del args
            del w_lib


if __name__ == "__main__":
    main()
