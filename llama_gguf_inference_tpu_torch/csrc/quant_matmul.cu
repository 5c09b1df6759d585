// Fused dequantize + matmul over repacked quantized weights, for Hopper.
//
// Replaces every Pallas TPU matmul body of
// llama_gguf_inference_tpu/ops/pallas_matmul.py:
//
//   lgt_quant_matmul_lowbit, 2- and 4-bit codes, one template whose Var
//   parameter follows the element rule of one TPU body:
//     var fsplit, 2 bits  <- _make_kernel_qsplit (kern="qsplit"): planar
//                            quarters (Q2_K; the IQ1 trit codes share it)
//     var fsplit, 4 bits  <- _make_kernel_fsplit (kern="fsplit"): planar
//                            nibbles (Q4_K, Q4_0, Q4_1, Q3_K's 3-bit codes
//                            with bias 4; with the IQ2/IQ3 code->value map)
//     var xsum            <- _make_kernel_xsum (LGT_MM_VARIANT=xsum)
//     var split           <- _make_kernel_split (LGT_MM_VARIANT=split)
//     var base            <- _make_kernel's bf16-magic 4-bit branch
//                            (LGT_MM_VARIANT=base, or (in/sub) % 8 != 0)
//     var base_f32        <- _make_kernel's f32 branch for 2-bit codes and
//                            value-mapped 4-bit codes
//   lgt_quant_matmul_int8   <- _make_kernel_int8 (via _quant_matmul_2d_int8,
//                            LGT_MM_VARIANT=int8): Q8_1-style int8 activations
//                            (_quantize_acts, done by the caller) and exact
//                            int32 dots per sub-block with the 4-bit codes
//   lgt_quant_matmul_8bit   <- _make_kernel's 8-bit branch (via
//                            _quant_matmul_2d): int8 codes with compact
//                            hierarchical scales (Q6_K, IQ4_XS: f32 d per 256,
//                            i8 sc per sub-block; Q5_K: u8 sc and mn) or flat
//                            ones (Q8_0, Q5_0, Q5_1, Q8_1, Q8_K, IQ4_NL), with
//                            the min term of the asymmetric ones (Q5_K, Q5_1)
//   lgt_quant_matmul_lowbit_moe, lgt_quant_matmul_8bit_moe: the 2/4-bit and
//                            8-bit decode kernels' expert-indexed launch, for
//                            the routed experts of an MoE decode step (the
//                            JAX package runs the same bodies once per
//                            routed expert under lax.cond, _moe_cond in
//                            models/llama.py): the activation rows are the
//                            step's routed (token, slot) pairs sorted by
//                            expert, eid[b] the expert of row b, and every
//                            weight array holds the E experts' (out, ...)
//                            arrays one after another, so one launch serves
//                            every routed pair of a layer's role (bound, as
//                            a decode launch, by the routed experts' bytes;
//                            grid y runs over the pairs and only the first
//                            row of each run of up to 8 of one expert's
//                            pairs works, so a block decodes its expert's
//                            rows once for the run: simple, not yet fast)
//
// All read the arrays the JAX kernels read, in the same block-minor element
// order (quant/repack.py block_minor_perm): stored position j of a row holds
// sub-block (j mod nsub), so a 16-byte code load meets a contiguous run of
// per-sub-block scales, and the activations arrive pre-permuted by the caller.
//
// 2- and 4-bit (P = 4 or 2 code planes, q = in/P stored codes per plane,
// v_i(c) = (c >> (8/P)*i) & (2^(8/P) - 1), mapped by code_value for IQ2/IQ3):
//   fsplit  y = sum_i sum_j x[i*q + j] * bf16(v_i * s[k]) - sum_k xsum[k] * m'[k]
//   xsum    as fsplit with bf16(v_i * bf16(s[k])), one sum over both planes
//   split   as xsum, the two planes summed apart and added at the end
//   base    w = bf16(bf16(v_i * bf16(s[k])) - bf16(m'[k])), no xsum term
//           (XLA on the CPU rounds after the multiply and again after the
//           subtract, like the TPU's bf16 arithmetic; checked by the tests)
//   base_f32  w = bf16((v_i - bias) * s[k] - m[k]) in f32, no xsum term
// with k = j mod nsub, the scale and min sides each read in one of the
// repack's layouts (_hier_scales in the JAX package), the side being a
// template parameter:
//   flat    s[k] = d[k]                           (d per sub-block)
//   hier    s[k] = d[k mod nd] * sc[k]            (d per super-block, sc u8/i8)
//   m'[k] = bias*s[k] + m[k], m[k] the min side read the same way (none,
//   flat, or hier with dmin per min super-block: nd for compact, in/min_size
//   for mixed, where the caller permuted xsum into the mn order and bias is 0;
//   the base variants take no mixed layout, as in the JAX dispatcher).
// int8:   p[k] = sum_t xq[t*nsub + k] * c[t*nsub + k] (exact int32, c the
//         unbiased 4-bit code), y = sum_k (p[k] * xs[k]) * s[k] - sum_k xsum[k] * m'[k]
// 8-bit:  y[b,o] = sum_j x[b,j] * bf16((c[o,j] - bias) * s_full[j] - m_full[j])
//         s_sub[k] = d[o, k mod nd] * sc[o,k] (k < nsub), s_full[j] = s_sub[j mod nsub]
//         (tiles, not repeat-interleave: that is what pltpu.repeat does), the
//         min side alike; the subtract follows the product in f32.
// Products are rounded to bf16 where the TPU kernel rounds them, sums run in
// f32, and the scale arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn so nvcc
// cannot fuse it into an FMA the reference does not do.
//
// What bounds them on the card: at decode (a handful of activation rows)
// they stream their weight bytes once, so device-memory bandwidth bounds
// them. Bytes per weight: Q2_K 0.75 flat (6.0 bits), 0.578 mixed (4.625),
// 0.406 compact (3.25); Q4_K 0.75 flat, 0.672 mixed, 0.594 compact; Q3_K
// 0.75 flat, 0.578 compact; Q6_K about 1.08 compact; Q5_K 1.09 compact,
// 1.25 flat. At prefill (512 rows) they are bound by operations.
// The 8-bit decode kernel here serves fewer than TC_MIN_ROWS rows
// (ops/quant_matmul.py), the 2/4-bit one fewer than LOWBIT_TC_MIN_ROWS, the
// int8 one fewer than INT8_TC_MIN_ROWS; from there up the wrappers take the
// tensor-core kernels of quant_matmul_tc.cu, quant_matmul_lowbit_tc.cu and
// quant_matmul_int8_tc.cu, which decode each weight once per 128 rows. The
// 2/4-bit element rules live in lowbit_rule.cuh, shared with the
// tensor-core 2/4-bit kernel.
//
// Design of the 2/4-bit decode kernel (quant_matmul_lowbit_kernel). Q4_K
// flat moves 0.75 bytes a weight, Q2_K mixed 0.58, so at the card's 3.35
// TB/s a weight may cost 4-7 lane instructions; it follows the int8 decode
// kernel below in everything but the arithmetic:
// - Persistent blocks walk tiles of row groups of 8 output rows, each row
//   group's steps split over up to 16 warps, so a block asks for its rows'
//   bytes together (the block-minor stride puts a sub-block's code rows
//   nsub bytes apart); each warp keeps a 2-step cp.async ring of code
//   pieces and raw scale sides, running on from one tile into the next (3
//   steps were slower: PERF.md §6).
// - Scales once a sub-block: a step holds 16 whole sub-blocks (32 where a
//   sub-block has at most 8 code rows: Q3_K, Q2_K, so a step still holds 16
//   16-byte pieces a row), each lane forms the factors of its 4 (8)
//   sub-blocks once (8-bit factors exact through byte_f32) into the warp's
//   table, in the form its rule's decode reads, and their min term against
//   the block sums in the same walk.
// - Activations shared across rows: bf16 mma.sync.m16n8k16 with the
//   activation rows as A (rows 8-15 zero) and 8 output rows as B. The K
//   order is free, so each code byte is one weight a plane at the lane's own
//   k slots; the block stages its activation rows and block sums once in
//   shared memory, each row's positions in the order the lanes read them (a
//   warp's fragment reads are contiguous), so the steps read no global
//   memory but their codes and sides. Activation tiles shrink from 8 rows
//   only where the staged rows would leave fewer than 8 warps' regions.
// - Lean elements, exact: fsplit takes fma(2^23 + v, s, -2^23*s), v*s
//   rounded once to f32 as the reference's product, and one cvt.rn.bf16x2 a
//   pair; xsum and split fma.rn.bf16x2(128 + v, bf16 s, -128*bf16 s), v*bf16
//   s rounded once to bf16, the codes placed by one byte_perm a pair; base
//   then sub.rn.bf16x2 of bf16 m' (the reference's f32 subtract is exact
//   for these operands, so one rounding agrees); base_f32 and the IQ2/IQ3
//   maps in f32. Split keeps its planes in separate accumulators; the base
//   rules take no min term.
// - Any geometry: nsub % 16 != 0, or more than 16 code rows a sub-block,
//   takes quant_matmul_lowbit_generic (each byte's factors where it is used,
//   the same products), which the 8B's weights never reach.
// What bounds it: the instructions, not the bytes. At 128 registers a
// thread and 16 warps an SM each mma costs a few dozen lane instructions
// (moves into the zero-padded A quad among them), and with the code loads
// cut it runs about as long as whole (PERF.md §6, tools/tc_ablate.py
// --kinds q4_k_decode,q2_k_decode). The weights as A (16 output rows a warp, no
// idle rows) halve the instructions an mma but double each warp's ring and
// table, so only 8 warps an SM fit: slower in a trial build.
//
// Design of the int8 decode kernel (quant_matmul_int8_kernel). Q4_K flat
// moves 0.75 bytes a weight, so at the card's 3.35 TB/s a weight may cost
// about 6.7 lane instructions; what stood in the way, and what this does:
// - Bytes in flight. Each warp keeps a 3-step ring of code bytes and raw
//   scale sides in shared memory through cp.async (L1 bypassed; about 4 KB
//   of codes in flight a warp at Q4_K). Blocks stay resident and walk tiles
//   of row groups, so the rings run on from one tile into the next.
// - DRAM pages. A sub-block's 16 code rows lie nsub bytes apart, so a step
//   of 16 sub-blocks takes a 16-byte piece of every line of its rows. A row
//   group's steps are split over as many warps as it has steps (up to 16),
//   so a block asks for its rows' bytes together and each page is opened
//   once; one warp walking the steps was 15% slower at gate+up.
// - Activations shared across rows. s8 mma.sync with the activation rows
//   as A (rows 8-15 zero) and 8 output rows as B: one activation fragment a
//   lane serves 8 output rows. A block stages its activation rows once, in
//   fragment order with coalesced loads and the same byte transposes as the
//   codes, beside each sub-block's xs and xsum; a warp then reads a
//   fragment with one 8-byte shared load.
// - Integer products on tensor cores. A step is 16 whole sub-blocks of 8
//   output rows: lane (g, t) copies code rows 4t..4t+3 of row g (16 bytes
//   each), and a 4 x 4 byte transpose makes one fragment word a sub-block,
//   whose low nibbles are k = 4t.. and high ones k = 16+4t.. of one
//   m16n8k32 (sub 32). Q3_K's 16-wide sub-blocks, and any other even size,
//   take 16-element steps (code rows 8h + 4(t%2).., low nibbles for t < 2),
//   two sub-blocks a m16n8k32: the second's activations in the rows 8-15
//   that the first leaves idle.
//   The exact int32 sum starts at the bits of 1.5*2^23, so one f32 subtract
//   converts it.
// - Scales once, no second pass. A step holds whole sub-blocks, so each
//   lane forms s and m' = bias*s + m of its 4 sub-blocks once (8-bit
//   factors exact through byte_f32) into the warp's table; the epilogue
//   takes (p*xs)*s and the min term per sub-block in the same walk, and a
//   tile's split partial sums meet in shared memory. nsub % 16 != 0 takes
//   a second instance of 4 sub-blocks a step with 4-byte copies.
// Measured: PERF.md §6 (tools/tc_ablate.py --kinds q4_k_int8_decode).

// Design of the 8-bit decode kernel (quant_matmul_8bit_kernel), where the
// bytes a weight and the instructions a weight both sit near the card's
// limits (about 1.1 bytes and 4.5 instructions a weight at B = 4):
// - A block owns 8 output rows and 8 activation rows. Its warps split the
//   row into cells of 64 stored positions; cells q and q + C meet the same
//   sub-blocks (64*C = lcm(64, nsub)), so a warp that walks one chunk (the
//   cells c, c + C, ...) finds the same 16 sub-blocks in every cell.
// - Scales once a chunk: each lane forms the 16 scales (and mins) of its
//   row and positions once, in registers, with 16-byte loads where nsub %
//   16 == 0 and nd % 4 == 0 (every 8B weight: nsub 128, 256, 448, 896) and
//   one at a time otherwise; the 8-bit factors are read as exact floats by
//   byte_perm and a subtract, no int-to-float conversion. The element loop
//   reads no d, sc, dmin or mn and steps no sub-block index. ffn_down (nsub
//   448, C = 7) takes the same path as the rest.
// - Activations shared across rows: mma.sync.m16n8k16 with the activation
//   rows as A (rows 8-15 zero) and the 8 output rows as B, so one 32-byte x
//   fragment a lane feeds 8 output rows: 2*B/8 bytes of x (L1 and L2) a code
//   byte, 1.0 at B = 4.
// - Bytes in flight: each warp keeps a ring of 8 cells (4 KB) of codes in
//   flight through cp.async (L1 bypassed), 4 with a min side, requested before
//   the item's scales are formed; 95 registers with a min side, 71 without,
//   no spills, 14-28 warps an SM.
// - Lean element: byte_perm puts c + 128 into 2^23's mantissa, one subtract
//   of 2^23 + 128 + bias gives c - bias exactly, then __fmul_rn, __fsub_rn
//   with a min, and one cvt.rn.bf16x2 for two weights.
// - Filling the card: a chunk's run of cells is split across warps of the
//   block only as far as needed for two warps a resident slot (plan8); the
//   block merges its warps' partial sums in shared memory and writes y, so
//   nothing outlives a launch.
// Measured (PERF.md §6, tools/tc_ablate.py --kinds q5_k_decode,q6_k_decode):
// at Q5_K gate+up, B = 4, removing the activation loads, the decode or the
// products each takes 15-25% off the time; none alone bounds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <numeric>

#include "lowbit_rule.cuh"
#include "tc_common.cuh"

namespace {

struct Args8 {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const int8_t* codes;     // (out, in)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nd, nsub, bias;
  const int* eid = nullptr;  // (B,) experts of an expert-indexed launch, or null
};

constexpr int k8Rows = 8;       // output rows a block: mma's n
constexpr int k8Acts = 8;       // activation rows a block (of mma's m = 16)
constexpr int k8Cell = 64;      // stored positions of a row a warp takes a step
constexpr int k8MaxWarps = 16;
// cp.async ring of code cells a warp (512 bytes a cell), which then holds
// the warp's partial sums: 8 cells without a min side, 4 with one (those
// instances keep 95 registers, so 20 warps an SM, and a deeper ring costs
// the activations' L1 more than it gains in flight: PERF.md §6)
template <int kM>
constexpr int k8Ring = kM == kNone ? 8 : 4;
template <int kM>
constexpr int k8WarpSmem = k8Ring<kM> * 32 * 16;

// How a block of 8 output rows splits its row. Cell q holds stored positions
// 64q..64q+63; cells q and q + C meet the same sub-blocks (64*C is the least
// multiple of 64 and of nsub), so chunk c is the cells c, c + C, c + 2C, ...
// A warp's item is one chunk and a run of up to `steps` of its cells; the
// block's warps take the items in turn, one each where items <= 16.
struct Plan8 {
  int cells, C, chunks, steps, items, warps;
};

// Items as long as the card allows: a chunk's run is split only until the
// grid holds two warps for each of the 16 an SM keeps resident (o and qkv
// split in 5 and 3, gate+up and the head not at all), at most 16 warps a
// block; more items than that are dealt evenly, two or more a warp.
inline Plan8 plan8(int B, int in_f, int out_f, int nsub, int sms) {
  Plan8 p;
  p.cells = (in_f + k8Cell - 1) / k8Cell;
  p.C = nsub / std::gcd(nsub, k8Cell);
  p.chunks = p.C < p.cells ? p.C : p.cells;
  const int run = (p.cells + p.C - 1) / p.C;   // cells of chunk 0
  const long blocks = (long)((out_f + k8Rows - 1) / k8Rows) * ((B + k8Acts - 1) / k8Acts);
  const long want = (32L * sms + blocks - 1) / blocks;   // items a block
  long split = (want + p.chunks - 1) / p.chunks;
  if (split > k8MaxWarps / p.chunks) split = k8MaxWarps / p.chunks;
  if (split > run) split = run;
  if (split < 1) split = 1;
  p.steps = (run + (int)split - 1) / (int)split;
  p.items = p.chunks * (int)split;
  const int per = (p.items + k8MaxWarps - 1) / k8MaxWarps;   // items a warp
  p.warps = (p.items + per - 1) / per;
  return p;
}

// An expert-indexed launch (eid set): the B activation rows are routed
// (token, slot) pairs sorted by expert, eid[b] the expert of row b, and the
// weights hold E experts' (out, ...) arrays one after another. Grid y runs
// over the rows: block y takes rows y .. y+n-1 where y starts a run of up
// to `acts` rows of one expert (each expert's rows cut into runs from its
// first), its weights those of expert e; any other y has no work (false).
__device__ __forceinline__ bool expert_run(const int* eid, int B, int by, int acts, int& b0,
                                           int& nb, int& e) {
  e = eid[by];
  int first = by;
  while (first > 0 && eid[first - 1] == e) --first;
  if ((by - first) % acts) return false;
  int end = by + 1;
  while (end < B && end - by < acts && eid[end] == e) ++end;
  b0 = by;
  nb = end - by;
  return true;
}

// Byte q of u, minus magic, as an exact f32: 0x4B0000zz is 2^23 + zz. With
// magic 2^23 an unsigned byte; with 2^23 + 128 (+ bias) a signed one whose
// sign bit was flipped first (minus the bias).
__device__ __forceinline__ float byte_f32(uint32_t u, int q, float magic) {
  return __fsub_rn(__int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7440u | q)), magic);
}

// One side's values at this lane's 16 sub-blocks k0, k0+1, ... (mod nsub),
// as side_at forms them: 16-byte loads where nsub % 16 == 0 and nd % 4 == 0
// (a run then neither wraps nsub nor splits a 4-aligned run of nd), else
// one element at a time.
template <int kSide>
__device__ __forceinline__ void lane_side(const float* base, const uint8_t* sub, int k0, int nsub,
                                          int nd, bool vec, float (&v)[16]) {
  if (vec) {
    float4 f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f[q] = __ldg(reinterpret_cast<const float4*>(base + (kSide == kFlat ? k0 + 4 * q
                                                                          : (k0 + 4 * q) % nd)));
    const float* fv = reinterpret_cast<const float*>(f);
    if constexpr (kSide == kFlat) {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = fv[e];
    } else {
      constexpr uint32_t kFlip = kSide == kHierI8 ? 0x80808080u : 0u;
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(sub + k0));
      const uint32_t bw[4] = {b.x ^ kFlip, b.y ^ kFlip, b.z ^ kFlip, b.w ^ kFlip};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = __fmul_rn(fv[e], byte_f32(bw[e / 4], e % 4, kFlip ? 8388736.f : 8388608.f));
    }
    return;
  }
  int k = k0, kd = k0 % nd;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    v[e] = side_at<kSide>(base, sub, k, kd);
    if (++k == nsub) {
      k = 0;
      kd = 0;
    } else if (++kd == nd) {
      kd = 0;
    }
  }
}

// 16 codes to 8 words of bf16 pairs: bf16((c - bias) * s - m), the lower
// position in the lower half; magic is 2^23 + 128 + bias.
template <int kM>
__device__ __forceinline__ void decode16(const uint4& c4, const float (&s)[16],
                                         const float (&m)[16], float magic, uint32_t (&w)[8]) {
  const uint32_t u[4] = {c4.x ^ 0x80808080u, c4.y ^ 0x80808080u, c4.z ^ 0x80808080u,
                         c4.w ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    float v0 = __fmul_rn(byte_f32(u[e / 4], e % 4, magic), s[e]);
    float v1 = __fmul_rn(byte_f32(u[e / 4], e % 4 + 1, magic), s[e + 1]);
    if constexpr (kM != kNone) {
      v0 = __fsub_rn(v0, m[e]);
      v1 = __fsub_rn(v1, m[e + 1]);
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    w[e / 2] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

// Block (blockIdx.x, blockIdx.y): output rows 8*bx..+7, activation rows
// 8*by..+7. Lane (g, t) = (lane / 4, lane % 4) of a warp decodes output row
// g at positions 16t..16t+15 of each of its cells and brings activation row
// g at the same positions; mma.m16n8k16 q (q < 4) of a cell takes the
// lane's positions 4q..4q+3 as its k slots 2t, 2t+1, 2t+8, 2t+9, with the
// activations as A (rows 8-15 zero) and the weights as B (n = output row).
template <int kS, int kM>
__global__ void __launch_bounds__(k8MaxWarps * 32, 1)
quant_matmul_8bit_kernel(const Args8 a, const Plan8 p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = p.warps;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * k8Rows;
  int b0 = blockIdx.y * k8Acts, nb = min(k8Acts, a.B - b0), e = 0;
  if (a.eid && !expert_run(a.eid, a.B, blockIdx.y, k8Acts, b0, nb, e)) return;
  // a row past out repeats the last row's loads; its sums are not stored;
  // expert e's rows follow the e experts before it
  const size_t o = (size_t)e * a.out_f + min(r0 + g, a.out_f - 1);
  const int8_t* crow = a.codes + o * a.in_f;
  const float* drow = a.d + o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + o * a.nsub;
  const float* dminrow = kM == kNone ? nullptr : a.dmin + o * a.nd;
  const uint8_t* mnrow = kM == kHierU8 ? a.mn + o * a.nsub : nullptr;
  const bool x_live = g < nb;
  const __nv_bfloat16* xrow = a.x + (size_t)(b0 + (x_live ? g : 0)) * a.in_f;
  const bool vec = a.nsub % 16 == 0 && a.nd % 4 == 0;
  const float magic = __fadd_rn(8388736.f, (float)a.bias);
  constexpr int kRing = k8Ring<kM>;
  unsigned char* const ring = smem + warp * k8WarpSmem<kM> + lane * 16;

  float acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;

  for (int item = warp; item < p.items; item += nwarps) {
    const int c = item % p.chunks, m0 = (item / p.chunks) * p.steps;
    const int n = min(p.steps, (p.cells - c + p.C - 1) / p.C - m0);   // cells of the item
    if (n <= 0) continue;
    // this lane's position in cell i of the item; past in only in a ragged
    // last cell, loaded as zeros
    auto pos = [&](int i) { return ((m0 + i) * p.C + c) * k8Cell + 16 * t; };
    auto load_codes = [&](int i) {
      const int j = pos(i);
      cp_async16(ring + (i % kRing) * 512, crow + (j < a.in_f ? j : 0), j < a.in_f);
    };
    auto load_x = [&](int i, uint4 (&xv)[2]) {
      const int j = pos(i);
      if (x_live && j < a.in_f) {
        xv[0] = __ldg(reinterpret_cast<const uint4*>(xrow + j));
        xv[1] = __ldg(reinterpret_cast<const uint4*>(xrow + j) + 1);
      } else {
        xv[0] = xv[1] = uint4{0, 0, 0, 0};
      }
    };
    // the item's first cells are in flight while its scales are formed
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      if (i < n) load_codes(i);
      cp_async_commit();
    }
    float s[16], m[16];
    const int k0 = (c * k8Cell + 16 * t) % a.nsub;
    lane_side<kS>(drow, scrow, k0, a.nsub, a.nd, vec, s);
    if constexpr (kM != kNone) lane_side<kM>(dminrow, mnrow, k0, a.nsub, a.nd, vec, m);
    uint4 xn[2];
    load_x(0, xn);
    for (int i = 0; i < n; ++i) {
      // the slot of cell i-1, read and used, takes cell i-1+kRing: group j
      // of the item holds cell j
      if (i > 0) {
        if (i - 1 + kRing < n) load_codes(i - 1 + kRing);
        cp_async_commit();
      }
      const uint4 xv[2] = {xn[0], xn[1]};
      if (i + 1 < n) load_x(i + 1, xn);
      cp_async_wait<kRing - 1>();
      __syncwarp();
      const uint4 c4 = *reinterpret_cast<const uint4*>(ring + (i % kRing) * 512);
      uint32_t w[8];
      decode16<kM>(c4, s, m, magic, w);
      const uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                              xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t af[4] = {xw[2 * q], 0u, xw[2 * q + 1], 0u};
        mma_bf16(acc[q & 1], af, w[2 * q], w[2 * q + 1]);
      }
    }
  }

  // partial sums through the warp's own ring (its copies have all landed):
  // accumulator e < 2 is activation row g, output row 2t + e
  cp_async_wait<0>();
  __syncwarp();
  float* part = reinterpret_cast<float*>(smem + warp * k8WarpSmem<kM>);
  part[g * 8 + 2 * t] = acc[0][0] + acc[1][0];
  part[g * 8 + 2 * t + 1] = acc[0][1] + acc[1][1];
  __syncthreads();
  for (int idx = threadIdx.x; idx < k8Acts * k8Rows; idx += nwarps * 32) {
    const int b = idx >> 3, r = idx & 7;
    float sum = 0.f;
    for (int v = 0; v < nwarps; ++v)
      sum += reinterpret_cast<const float*>(smem + v * k8WarpSmem<kM>)[idx];
    if (b < nb && r0 + r < a.out_f) a.y[(size_t)(b0 + b) * a.out_f + r0 + r] = sum;
  }
}

// The plan of a launch on the current device (its card read, and the
// instance's shared-memory limit set, on the instance's first use there).
template <int kS, int kM>
int prepare_8bit(int B, int in_f, int out_f, int nsub, Plan8& p) {
  static CardCache cards;
  Card c;
  const int rc = cards.get(quant_matmul_8bit_kernel<kS, kM>, k8MaxWarps * k8WarpSmem<kM>, c);
  if (rc != 0) return rc;
  p = plan8(B, in_f, out_f, nsub, c.sms);
  return 0;
}

template <int kS, int kM>
int launch_8bit(const Args8& a, cudaStream_t st) {
  Plan8 p;
  const int rc = prepare_8bit<kS, kM>(a.B, a.in_f, a.out_f, a.nsub, p);
  if (rc != 0) return rc;
  const dim3 grid((a.out_f + k8Rows - 1) / k8Rows, a.eid ? a.B : (a.B + k8Acts - 1) / k8Acts);
  const int smem = p.warps * k8WarpSmem<kM>;
  quant_matmul_8bit_kernel<kS, kM><<<grid, p.warps * 32, smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

// What a launch of one instance would be: grid x and y, threads, shared
// bytes, registers a thread, local bytes a thread (spills), blocks an SM.
template <int kS, int kM>
int plan_8bit(int B, int in_f, int out_f, int nsub, int* info) {
  Plan8 p;
  int rc = prepare_8bit<kS, kM>(B, in_f, out_f, nsub, p);
  cudaFuncAttributes fa;
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, quant_matmul_8bit_kernel<kS, kM>);
  int per_sm = 0;
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_matmul_8bit_kernel<kS, kM>, p.warps * 32, p.warps * k8WarpSmem<kM>);
  if (rc != 0) return rc;
  const int v[7] = {(out_f + k8Rows - 1) / k8Rows, (B + k8Acts - 1) / k8Acts, p.warps * 32,
                    p.warps * k8WarpSmem<kM>, fa.numRegs, (int)fa.localSizeBytes, per_sm};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

struct Int8Args {
  const int8_t* xq;        // (B, in) block-minor, Q8_1-style codes
  const float* xs;         // (B, nsub) activation scales
  const float* xsum;       // (B, nsub) exact block sums
  const uint8_t* codes;    // (out, in / 2) planar nibbles
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, nd), (out, nsub) when flat, or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, bias;
};

constexpr int kI8Rows = 8;        // output rows a warp: mma's n, the weights as B
constexpr int kI8Acts = 8;        // activation rows a block at most: rows 0-7 of mma's m = 16
constexpr int kI8MaxWarps = 16;
constexpr int kI8Ring = 3;        // steps of codes a warp keeps in its cp.async ring
constexpr int kI8Magic = 0x4B400000;  // the bits of 1.5 * 2^23
constexpr float kI8MagicF = 12582912.f;

// Four words w[j] (bytes: sub-blocks c = 0..3 of row j) to four words
// col[c] (bytes: rows j = 0..3 of sub-block c).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// The row groups a tile, of G row groups and Y activation tiles with
// `splits` warps a row group and fixed + warps * warp_smem shared bytes a
// block (at most max_warps warps), for the most warps resident an SM, by
// shared memory (an SM's, less each block's reserve), registers (the
// instance's a thread; 0 for no limit) and threads, times the share of the
// last round of tiles that is busy, the smaller tile on a tie; and the
// tiles and the grid (the resident blocks, at most one a tile).
inline void tile_groups(long G, long Y, int splits, int fixed_smem, int warp_smem, int max_warps,
                        const Card& c, int& groups, int& tiles, int& grid) {
  const int warps_sm = c.threads_sm / 32;
  const int reg_warps = c.regs > 0 ? c.regs_sm / ((c.regs * 32 + 255) / 256 * 256) : warps_sm;
  long rmax = max_warps / splits;
  if (rmax > G) rmax = G;
  groups = 1;
  double best = -1.0;
  for (int r = 1; r <= rmax; ++r) {
    const int w = r * splits, smem = fixed_smem + w * warp_smem;
    if (smem > c.smem_block) break;
    int per_sm = c.smem_sm / (smem + c.smem_reserve);
    if (per_sm > reg_warps / w) per_sm = reg_warps / w;
    if (per_sm > warps_sm / w) per_sm = warps_sm / w;
    const long nt = (G + r - 1) / r;
    long gr = (long)c.sms * per_sm / Y;
    if (gr < 1) gr = 1;
    if (gr > nt) gr = nt;
    const long rounds = (nt + gr - 1) / gr;
    const double score = (double)per_sm * w * nt / (gr * rounds);
    if (score > best) {
      best = score;
      groups = r;
      tiles = (int)nt;
      grid = (int)gr;
    }
  }
  if (best < 0) {
    tiles = (int)G;
    grid = (int)G;
  }
}

// A launch's shape. A block walks tiles of `groups` row groups of kI8Rows
// output rows (tiles bx, bx + grid, ...) for one tile of `acts` activation
// rows; each row group's `steps` steps (kV whole sub-blocks each, so a warp
// forms each scale once and never meets it again) are split over `splits`
// warps, runs of `per` steps, and the splits' partial sums meet in shared
// memory at the end of each tile. A warp's region is a ring of kI8Ring slots
// of `slot` bytes, its scale table and its partial sums (two tiles); the
// block stages its activations first (x_smem bytes: nw fragment words a
// sub-block and activation row, at a row stride of nbs).
struct PlanI8 {
  int steps, per, splits, groups, warps, tiles, grid, acts, nbs, nw, slot, warp_smem, x_smem;
};

// Blocks stay resident and walk their tiles, so the rings run on from one
// tile into the next and the activations are staged once a block. A row
// group's steps are split over as many warps as it has steps (at most 16),
// so a block requests its rows' bytes all at once and each DRAM page is
// opened once (one warp walking the steps re-opened them every step: 15%
// slower at gate+up, PERF.md §6), and only as far as one row group's warps
// and the staged activations fit a block's shared memory (227 KB on an
// H100); then the row groups a tile are chosen for the most warps resident
// an SM, by shared memory (an SM's, less each block's reserve), registers
// (the instance's a thread; 0 for no limit) and threads, times the share of
// the last round of tiles that is busy, the smaller tile on a tie.
// Activation tiles shrink from 8 rows only where the staging would take
// over half of a block's shared memory, or a row group would not fit.
inline PlanI8 plan_i8(int B, int out_f, int nsub, int steps, int slot, int tables, int nw,
                      const Card& c) {
  const int smem_max = c.smem_block;
  PlanI8 p;
  p.steps = steps;
  p.slot = slot;
  p.nw = nw;
  p.warp_smem = kI8Ring * slot + tables + 2 * kI8Acts * kI8Rows * 4;
  const long G = (out_f + kI8Rows - 1) / kI8Rows;
  long Y = 1;
  for (p.acts = kI8Acts;; p.acts /= 2) {
    p.nbs = B < p.acts ? B : p.acts;
    p.x_smem = nsub * p.nbs * (nw * 4 + 8);
    if (p.acts > 1 && p.x_smem > smem_max / 2) continue;
    Y = (B + p.acts - 1) / p.acts;
    long s = steps < kI8MaxWarps ? steps : kI8MaxWarps;
    for (;; --s) {
      p.per = (steps + (int)s - 1) / (int)s;
      p.splits = (steps + p.per - 1) / p.per;
      if (s == 1 || p.x_smem + p.splits * p.warp_smem <= smem_max) break;
    }
    if (p.acts == 1 || p.x_smem + p.splits * p.warp_smem <= smem_max) break;
  }
  tile_groups(G, Y, p.splits, p.x_smem, p.warp_smem, kI8MaxWarps, c, p.groups, p.tiles,
              p.grid);
  p.warps = p.groups * p.splits;
  return p;
}

// A sub-block side's chunks: this lane's kQ f32 values (flat, or the
// super-block values at k mod nd) and, for a hierarchical side, the word of
// 8-bit factors holding theirs.
template <int kSide, int kV>
__device__ __forceinline__ void copy_side(unsigned char* fdst, unsigned char* bdst,
                                          const float* base, const uint8_t* sub, int k0,
                                          int nd) {
  if constexpr (kV == 4) {
    cp_async4(fdst, base + (kSide == kFlat ? k0 : k0 % nd), true);
  } else if (kSide == kFlat || nd % 4 == 0) {
    cp_async16(fdst, base + (kSide == kFlat ? k0 : k0 % nd), true);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(fdst + 4 * e, base + (k0 + e) % nd, true);
  }
  if constexpr (kSide != kFlat) cp_async4(bdst, sub + (k0 & ~3), true);
}

// Value e of this lane's side chunk, as side_at forms it; byte q of the
// factor word is this value's factor.
template <int kSide>
__device__ __forceinline__ float side_value(const unsigned char* fsrc, const unsigned char* bsrc,
                                            int e, int q) {
  const float f = reinterpret_cast<const float*>(fsrc)[e];
  if constexpr (kSide == kFlat) {
    return f;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(bsrc);
    if constexpr (kSide == kHierI8) return __fmul_rn(f, byte_f32(w ^ 0x80808080u, q, 8388736.f));
    return __fmul_rn(f, byte_f32(w, q, 8388608.f));
  }
}

// Block (blockIdx.x, blockIdx.y): tiles bx, bx + grid, ... of `groups` row
// groups of kI8Rows output rows, activation rows acts*by..; warp w takes row
// group w / splits of each tile and steps (w % splits)*per.. of its row.
// - Staging: the block's threads turn its activation rows into fragment
//   words once, coalesced: word 2t + h of (sub-block, row) holds elements
//   4t + 16h..+3 for sub 32 (lane t's k = 4t.. and 16+4t.. of m16n8k32),
//   word 4h + t elements (t/2)*sub/2 + 8h + 4(t%2)..+3 otherwise (k16 step
//   h; past the sub-block, zeros); beside them (xs, xsum) per sub-block,
//   zeros past B (a staged row past B repeats row 0; its sums are not
//   stored).
// - Codes: lane (g, t) copies, for output row g, code rows 4t..4t+3 of the
//   step's 16 sub-blocks for sub 32 (a byte's low nibble is k = 4t.., its
//   high one k = 16+4t..), or rows 8h + 4(t%2)..+3 with the low nibble for
//   t < 2 and the high one for t >= 2 for k16 step h; a 4 x 4 byte
//   transpose turns four code rows of four sub-blocks into one fragment word
//   a sub-block. The lane also forms s and m' of row g at its kV/4
//   sub-blocks into the warp's scale table.
template <int kS, int kM, bool kK32, int kV>
__global__ void __launch_bounds__(kI8MaxWarps * 32, 1)
quant_matmul_int8_kernel(const Int8Args a, const PlanI8 p) {
  static_assert(!kK32 || kV == 16, "sub 32 fragments walk 16 sub-blocks a step");
  constexpr int kQ = kV / 4;                // sub-blocks of a lane's side chunk
  constexpr int kCB = kV == 4 ? 4 : 16;     // bytes a lane's chunk
  constexpr int kCS = 32 * kCB;             // bytes a chunk
  constexpr bool kHasSc = kS != kFlat;
  constexpr bool kHasMin = kM != kNone;
  constexpr bool kHasMn = kM == kHierU8 || kM == kHierI8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = p.warps * 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / p.splits, b0 = blockIdx.y * p.acts;
  const int nb = min(p.acts, a.B - b0), nbs = p.nbs, nw = p.nw;
  const int half = a.in_f / 2, hsub = a.in_f / a.nsub / 2;
  const int nh = kK32 ? 1 : (hsub + 7) / 8;   // k16 steps a sub-block
  // chunks of a slot: codes (k16 step h, code row j), then the sides
  const int ncode = nh * 4;
  const int ic_sc = ncode + 1, ic_dm = ic_sc + (kHasSc ? 1 : 0);
  const int ic_mn = ic_dm + (kHasMin ? 1 : 0);
  const uint32_t* const xf = reinterpret_cast<const uint32_t*>(smem);   // [nsub][nbs][nw]
  const float2* const xsx =
      reinterpret_cast<const float2*>(smem + (size_t)a.nsub * nbs * nw * 4);   // [nsub][nbs]
  unsigned char* const ring = smem + p.x_smem + warp * p.warp_smem;
  float2* const tab_s = reinterpret_cast<float2*>(ring + kI8Ring * p.slot);  // [kV][kI8Rows]
  // partial sums of two tiles, [tile parity][activation row][output row]
  float* const part = reinterpret_cast<float*>(tab_s + kV * kI8Rows);
  const int ndm = kM == kFlat ? a.nsub : a.nd;
  const int ks = warp % p.splits, st0 = ks * p.per, n = min(p.per, p.steps - st0);
  const int jobs = n * ((p.tiles - (int)blockIdx.x + p.grid - 1) / p.grid);
  auto tile_of = [&](int j) { return (int)blockIdx.x + j / n * p.grid; };

  // the code bytes and side chunks of this warp's job j (step st0 + j % n
  // of tile tile_of(j)) into slot j % kI8Ring; a code row past sub/2 (k16
  // steps of sub % 16 != 0) is zero-filled, a row past out repeats the last
  // row (its sums are not stored)
  auto load_step = [&](int j) {
    unsigned char* sb = ring + (j % kI8Ring) * p.slot + lane * kCB;
    const int s0 = (st0 + j % n) * kV, k0 = s0 + kQ * t;
    const size_t o = min((tile_of(j) * p.groups + rg) * kI8Rows + g, a.out_f - 1);
    const uint8_t* crow = a.codes + o * half;
    for (int h = 0; h < nh; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cr = kK32 ? 4 * t + j : 8 * h + 4 * (t & 1) + j;
        const bool ok = kK32 || cr < hsub;
        unsigned char* dst = sb + (h * 4 + j) * kCS;
        const uint8_t* src = crow + (ok ? (size_t)cr * a.nsub + s0 : 0);
        if constexpr (kV == 16) cp_async16(dst, src, ok);
        else cp_async4(dst, src, ok);
      }
    }
    copy_side<kS, kV>(sb + ncode * kCS, sb + ic_sc * kCS,
                      a.d + o * (kS == kFlat ? a.nsub : a.nd),
                      kHasSc ? a.sc + o * a.nsub : nullptr, k0, a.nd);
    if constexpr (kHasMin)
      copy_side<kM, kV>(sb + ic_dm * kCS, sb + ic_mn * kCS, a.dmin + o * ndm,
                        kHasMn ? a.mn + o * a.nsub : nullptr, k0, a.nd);
  };

  // the first jobs are in flight while the block stages its activations
#pragma unroll
  for (int j = 0; j < kI8Ring; ++j) {
    if (j < jobs) load_step(j);
    cp_async_commit();
  }
  {
    uint32_t* const xw = reinterpret_cast<uint32_t*>(smem);
    const int ng = a.nsub / kV;   // kV sub-blocks a load
    for (int u = tid; u < ng * nbs * nw; u += nthr) {
      const int w = u % nw, b = (u / nw) % nbs, sg = u / (nw * nbs);
      int t0, rows = 4;
      if constexpr (kK32) {
        t0 = 4 * (w >> 1) + 16 * (w & 1);
      } else {
        const int cr0 = 8 * (w >> 2) + 4 * (w & 1);
        t0 = ((w & 3) >> 1) * hsub + cr0;
        rows = min(4, hsub - cr0);
      }
      const int8_t* xr = a.xq + (size_t)(b0 + (b < nb ? b : 0)) * a.in_f + sg * kV;
      uint32_t v[4][kV / 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kV == 16) {
          const uint4 l = j < rows ? __ldg(reinterpret_cast<const uint4*>(xr + (size_t)(t0 + j) * a.nsub))
                                   : uint4{0, 0, 0, 0};
          v[j][0] = l.x; v[j][1] = l.y; v[j][2] = l.z; v[j][3] = l.w;
        } else {
          v[j][0] = j < rows ? __ldg(reinterpret_cast<const uint32_t*>(xr + (size_t)(t0 + j) * a.nsub))
                             : 0u;
        }
      }
#pragma unroll
      for (int q = 0; q < kV / 4; ++q) {
        const uint32_t w4[4] = {v[0][q], v[1][q], v[2][q], v[3][q]};
        uint32_t col[4];
        transpose4(w4, col);
#pragma unroll
        for (int c = 0; c < 4; ++c) xw[((size_t)(sg * kV + 4 * q + c) * nbs + b) * nw + w] = col[c];
      }
    }
    float2* const xt = reinterpret_cast<float2*>(smem + (size_t)a.nsub * nbs * nw * 4);
    for (int u = tid; u < a.nsub * nbs; u += nthr) {
      const int b = u % nbs, k = u / nbs;
      const size_t ix = (size_t)(b0 + b) * a.nsub + k;
      xt[u] = b < nb ? float2{__ldg(a.xs + ix), __ldg(a.xsum + ix)} : float2{0.f, 0.f};
    }
  }
  __syncthreads();

  // accumulator e < 2: activation row g, output row 2t + e (e >= 2 are
  // mma's idle rows 8-15). A lane's activation row past nbs reads row
  // nbs - 1; its sums are not stored.
  const int gx = min(g, nbs - 1);
  float acc[2] = {0.f, 0.f};
  // (p*xs)*s, then - xsum*m', into the accumulators, for sub-block sl of
  // the step (k in the row)
  auto epilogue = [&](int sl, int k, const float (&pf)[2]) {
    const float2 xv = xsx[k * nbs + gx];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 sv = tab_s[sl * kI8Rows + 2 * t + e];
      acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(pf[e], xv.x), sv.x));
      acc[e] = fmaf(-xv.y, sv.y, acc[e]);
    }
  };

  for (int i = 0; i < jobs; ++i) {
    // the slot of job i-1, read and used, takes job i-1+kI8Ring: group j
    // of the warp holds job j
    if (i > 0) {
      if (i - 1 + kI8Ring < jobs) load_step(i - 1 + kI8Ring);
      cp_async_commit();
    }
    const int s0 = (st0 + i % n) * kV;
    cp_async_wait<kI8Ring - 1>();
    const unsigned char* sb = ring + (i % kI8Ring) * p.slot + lane * kCB;
    // scales once a step: s and m' = bias*s + m of row g at this lane's
    // sub-blocks; every lane is done with the last step's table
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const int q = kV == 16 ? e : t;   // byte of the factor word
      const float s = side_value<kS>(sb + ncode * kCS, sb + ic_sc * kCS, e, q);
      float mp = 0.f;
      if constexpr (kHasMin) mp = side_value<kM>(sb + ic_dm * kCS, sb + ic_mn * kCS, e, q);
      if (a.bias != 0) {
        const float bs = __fmul_rn((float)a.bias, s);
        mp = kHasMin ? __fadd_rn(bs, mp) : bs;
      }
      tab_s[(kQ * t + e) * kI8Rows + g] = float2{s, mp};
    }
    __syncwarp();

    if constexpr (kK32) {
      uint4 cw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cw[j] = *reinterpret_cast<const uint4*>(sb + j * kCS);
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // sub-blocks 4q..4q+3 of the step
        uint32_t col[4];
        const uint32_t w[4] = {(&cw[0].x)[q], (&cw[1].x)[q], (&cw[2].x)[q], (&cw[3].x)[q]};
        transpose4(w, col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = s0 + 4 * q + c;
          const uint2 xv = *reinterpret_cast<const uint2*>(xf + ((size_t)k * nbs + gx) * 8 + 2 * t);
          const uint32_t af[4] = {xv.x, 0u, xv.y, 0u};
          int pr[4];
          mma_s8_k32(pr, af, col[c] & 0x0F0F0F0Fu, (col[c] >> 4) & 0x0F0F0F0Fu, kI8Magic);
          // |p| <= 127 * 15 * 32 < 2^22: the sum's bits are 1.5*2^23 + p's
          const float pf[2] = {__fsub_rn(__int_as_float(pr[0]), kI8MagicF),
                               __fsub_rn(__int_as_float(pr[1]), kI8MagicF)};
          epilogue(4 * q + c, k, pf);
        }
      }
    } else {
      // 16-element steps h of each sub-block; the sums start at the bits of
      // 1.5*2^23 and stay exact in int32 across the steps
      const int nib = (t >> 1) * 4;
      int pr[kQ][4][2];
      for (int h = 0; h < nh; ++h) {
        uint32_t cw[4][kQ];   // word q of code chunk (h, j)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* src = sb + (h * 4 + j) * kCS;
          if constexpr (kV == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            cw[j][0] = v.x;
            cw[j][1] = v.y;
            cw[j][2] = v.z;
            cw[j][3] = v.w;
          } else {
            cw[j][0] = *reinterpret_cast<const uint32_t*>(src);
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {   // sub-blocks 4q..4q+3 of the step
          uint32_t col[4];
          const uint32_t w[4] = {cw[0][q], cw[1][q], cw[2][q], cw[3][q]};
          transpose4(w, col);
          const uint32_t* xk = xf + ((size_t)(s0 + 4 * q) * nbs + gx) * nw + 4 * h + t;
          const int c0 = h == 0 ? kI8Magic : 0;
          // two sub-blocks a m16n8k32: the second's activations in rows
          // 8-15 against k 16-31, so its sums land in accumulators 2, 3
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const uint32_t af[4] = {xk[(size_t)c * nbs * nw], 0u, 0u, xk[(size_t)(c + 1) * nbs * nw]};
            int dk[4];
            mma_s8_k32(dk, af, (col[c] >> nib) & 0x0F0F0F0Fu, (col[c + 1] >> nib) & 0x0F0F0F0Fu,
                       c0);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pr[q][c][e] = h == 0 ? dk[e] : pr[q][c][e] + dk[e];
              pr[q][c + 1][e] = h == 0 ? dk[2 + e] : pr[q][c + 1][e] + dk[2 + e];
            }
          }
        }
      }
      // |p| <= 127 * 15 * sub < 2^22 up to sub 2048 (one subtract converts
      // it), < 2^24 beyond (the integer difference converts exactly)
      const bool small = hsub <= 1024;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float pf[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pf[e] = small ? __fsub_rn(__int_as_float(pr[q][c][e]), kI8MagicF)
                          : (float)(pr[q][c][e] - kI8Magic);
          epilogue(4 * q + c, s0 + 4 * q + c, pf);
        }
      }
    }

    // the tile's last step for this warp: its partial sums into the
    // buffer of the tile's parity; the block then sums each row group's
    // splits and writes y (the other buffer takes the next tile)
    if (i % n == n - 1) {
      const int tile = tile_of(i), buf = (i / n) & 1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        part[buf * kI8Acts * kI8Rows + g * kI8Rows + 2 * t + e] = acc[e];
        acc[e] = 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < p.groups * kI8Acts * kI8Rows; idx += nthr) {
        const int grp = idx / (kI8Acts * kI8Rows), b = idx / kI8Rows % kI8Acts;
        const int o = (tile * p.groups + grp) * kI8Rows + idx % kI8Rows;
        float sum = 0.f;
        for (int v = 0; v < p.splits; ++v)
          sum += reinterpret_cast<const float*>(smem + p.x_smem + (grp * p.splits + v) * p.warp_smem
                                                + kI8Ring * p.slot + kV * kI8Rows * 8)
              [buf * kI8Acts * kI8Rows + idx % (kI8Acts * kI8Rows)];
        if (b < nb && o < a.out_f) a.y[(size_t)(b0 + b) * a.out_f + o] = sum;
      }
    }
  }
  cp_async_wait<0>();
}

// The instance a geometry takes: sub 32 on m16n8k32 (0), other sub-block
// sizes on m16n8k16 (1), both walking 16 sub-blocks a step with 16-byte
// copies where nsub % 16 == 0; 4 sub-blocks a step with 4-byte copies
// otherwise (2).
inline int int8_instance(int in_f, int nsub) {
  if (nsub % 16) return 2;
  return in_f / nsub == 32 ? 0 : 1;
}

// The plan of a launch on the current device (ring slot, table and staged
// activations from the instance's chunks and fragment words; the card read,
// and the instance's shared-memory limit set, on its first use there).
template <int kS, int kM, bool kK32, int kV>
int prepare_int8(int B, int in_f, int out_f, int nsub, PlanI8& p) {
  static CardCache cards;
  Card c;
  const int rc = cards.get(quant_matmul_int8_kernel<kS, kM, kK32, kV>, 0, c);
  if (rc != 0) return rc;
  const int nh = kK32 ? 1 : (in_f / nsub / 2 + 7) / 8;
  const int sides = 1 + (kS != kFlat) + (kM != kNone) + (kM == kHierU8 || kM == kHierI8);
  const int slot = (nh * 4 + sides) * 32 * (kV == 4 ? 4 : 16);
  p = plan_i8(B, out_f, nsub, nsub / kV, slot, kV * kI8Rows * 8, kK32 ? 8 : 4 * nh, c);
  return p.x_smem + p.warps * p.warp_smem > c.smem_block ? (int)cudaErrorInvalidValue : 0;
}

template <int kS, int kM, bool kK32, int kV>
int launch_int8(const Int8Args& a, cudaStream_t st) {
  PlanI8 p;
  const int rc = prepare_int8<kS, kM, kK32, kV>(a.B, a.in_f, a.out_f, a.nsub, p);
  if (rc != 0) return rc;
  const dim3 grid(p.grid, (a.B + p.acts - 1) / p.acts);
  const int smem = p.x_smem + p.warps * p.warp_smem;
  quant_matmul_int8_kernel<kS, kM, kK32, kV><<<grid, p.warps * 32, smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

// What a launch of one instance would be, as plan_8bit reports it, and the
// instance in info[7].
template <int kS, int kM, bool kK32, int kV>
int plan_int8(int B, int in_f, int out_f, int nsub, int* info) {
  PlanI8 p;
  int rc = prepare_int8<kS, kM, kK32, kV>(B, in_f, out_f, nsub, p);
  cudaFuncAttributes fa;
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, quant_matmul_int8_kernel<kS, kM, kK32, kV>);
  int per_sm = 0;
  const int smem = p.x_smem + p.warps * p.warp_smem;
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_matmul_int8_kernel<kS, kM, kK32, kV>, p.warps * 32, smem);
  if (rc != 0) return rc;
  const int v[8] = {p.grid, (B + p.acts - 1) / p.acts, p.warps * 32, smem, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, int8_instance(in_f, nsub)};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

template <int kS, int kM>
int launch_int8_geometry(const Int8Args& a, cudaStream_t st) {
  switch (int8_instance(a.in_f, a.nsub)) {
    case 0: return launch_int8<kS, kM, true, 16>(a, st);
    case 1: return launch_int8<kS, kM, false, 16>(a, st);
  }
  return launch_int8<kS, kM, false, 4>(a, st);
}

template <int kS, int kM>
int plan_int8_geometry(int B, int in_f, int out_f, int nsub, int* info) {
  switch (int8_instance(in_f, nsub)) {
    case 0: return plan_int8<kS, kM, true, 16>(B, in_f, out_f, nsub, info);
    case 1: return plan_int8<kS, kM, false, 16>(B, in_f, out_f, nsub, info);
  }
  return plan_int8<kS, kM, false, 4>(B, in_f, out_f, nsub, info);
}

// ---------------------------------------------------------------------------
// The 2/4-bit decode kernel.

struct LowbitArgs {
  const __nv_bfloat16* x;  // (B, in) block-minor
  const float* xsum;       // (B, nsub), in the min side's sub-block order; null for base
  const uint8_t* codes;    // (out, in * kBits / 8)
  const float* d;          // (out, nd)
  const uint8_t* sc;       // (out, nsub) or null
  const float* dmin;       // (out, ndm) or null
  const uint8_t* mn;       // (out, nsub) or null
  float* y;                // (B, out)
  int B, in_f, out_f, nsub, nd, ndm, bias;
  const int* eid = nullptr;  // (B,) experts of an expert-indexed launch, or null
};

constexpr int kLbRows = 8;         // output rows a row group: mma's n, the weights as B
constexpr int kLbActs = 8;         // activation rows a block at most: rows 0-7 of mma's m = 16
constexpr int kLbMaxWarps = 16;
constexpr int kLbRing = 2;         // steps a warp keeps in its cp.async ring
constexpr int kLbPieces = 4;       // 16-byte code pieces a lane a step, at most
constexpr int kLbTab = kLbRows * 32 * 8;                // a warp's factor table, bytes
constexpr int kLbPart = 3 * kLbActs * kLbRows * 4;      // its partial sums (two tiles), min sums
constexpr int kLbGenWarps = 4;     // warps a block of the generic instance

// The instance a geometry takes (R = in*bits/8/nsub code rows a
// sub-block): steps of 16 sub-blocks (0) or of 32 (1, where R <= 8 and
// nsub % 32 == 0, so that a step still holds 16 code pieces a row); any
// other geometry (nsub % 16 != 0 or R > 16) the generic instance (2).
inline int lowbit_instance(int bits, int in_f, int nsub) {
  const int R = in_f * bits / 8 / nsub;
  if (nsub % 16 || R > 16) return 2;
  return R <= 8 && nsub % 32 == 0 ? 1 : 0;
}

// A launch's shape, as PlanI8's: a block walks tiles of `groups` row groups
// (tiles bx, bx + grid, ...) for one tile of `acts` activation rows; each
// row group's `steps` steps of 16*G whole sub-blocks are split over
// `splits` warps, runs of `per` steps. The block first stages its
// activation rows (nbs of them, x_smem bytes with their block sums at
// xs_off); then each warp's region: a ring of kLbRing slots of `slot`
// bytes (npl code chunks of 512 bytes, the scale side's f32 chunk at
// npl*512, its 8-bit factors at off_sc, the min side's at off_dm and
// off_mn), its factor table and its partial sums.
struct PlanLb {
  int G, npl, steps, per, splits, groups, warps, tiles, grid, acts, nbs, xs_off, x_smem, slot,
      off_sc, off_dm, off_mn, warp_smem;
};

// Activation tiles shrink from 8 rows only where the staged rows would
// leave fewer than 8 warps' regions of a block's shared memory; the rest as
// plan_i8.
inline PlanLb plan_lb(int B, int in_f, int out_f, int nsub, int bits, bool has_sc, bool has_min,
                      bool has_mn, const Card& c) {
  PlanLb p;
  const int R = in_f * bits / 8 / nsub;
  p.G = lowbit_instance(bits, in_f, nsub) == 1 ? 2 : 1;
  const int q = 4 * p.G;   // sub-blocks whose factors a lane forms a step
  p.npl = (R * p.G + 3) / 4;
  p.steps = nsub / (16 * p.G);
  p.off_sc = p.npl * 512 + 128 * q;
  p.off_dm = p.off_sc + (has_sc ? 32 * q : 0);
  p.off_mn = p.off_dm + (has_min ? 128 * q : 0);
  p.slot = p.off_mn + (has_mn ? 32 * q : 0);
  p.warp_smem = kLbRing * p.slot + kLbTab + kLbPart;
  for (p.acts = kLbActs;; p.acts /= 2) {
    p.nbs = B < p.acts ? B : p.acts;
    // the staged rows: 128 bytes a code piece, plane and row, every piece
    // of every step; then nsub block sums a row
    p.xs_off = p.steps * p.npl * (8 / bits) * 128 * p.nbs;
    p.x_smem = p.xs_off + nsub * 4 * p.nbs;
    if (p.acts == 1 || p.x_smem + 8 * p.warp_smem <= c.smem_block) break;
  }
  const long Y = (B + p.acts - 1) / p.acts;
  int s = p.steps < kLbMaxWarps ? p.steps : kLbMaxWarps;
  for (;; --s) {
    p.per = (p.steps + s - 1) / s;
    p.splits = (p.steps + p.per - 1) / p.per;
    if (s == 1 || p.x_smem + p.splits * p.warp_smem <= c.smem_block) break;
  }
  tile_groups((out_f + kLbRows - 1) / kLbRows, Y, p.splits, p.x_smem, p.warp_smem, kLbMaxWarps,
              c, p.groups, p.tiles, p.grid);
  p.warps = p.groups * p.splits;
  return p;
}

// This lane's kQ values of one side (flat, or the super-block values at k
// mod nd) and, for a hierarchical side, its kQ 8-bit factors.
template <int kSide>
__device__ __forceinline__ void lb_copy_side(unsigned char* fdst, unsigned char* bdst,
                                             const float* base, const uint8_t* sub, int k0,
                                             int kQ, int nd) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (4 * q < kQ) {
      const int k = k0 + 4 * q;
      if (kSide == kFlat || nd % 4 == 0) {
        cp_async16(fdst + 16 * q, base + (kSide == kFlat ? k : k % nd), true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(fdst + 16 * q + 4 * e, base + (k + e) % nd, true);
      }
      if constexpr (kSide != kFlat) cp_async4(bdst + 4 * q, sub + k, true);
    }
  }
}

// Value e of this lane's side chunk, as side_at forms it.
template <int kSide>
__device__ __forceinline__ float lb_side_value(const unsigned char* fsrc,
                                               const unsigned char* bsrc, int e) {
  const float f = reinterpret_cast<const float*>(fsrc)[e];
  if constexpr (kSide == kFlat) {
    return f;
  } else {
    const uint32_t w = reinterpret_cast<const uint32_t*>(bsrc)[e / 4];
    if constexpr (kSide == kHierI8) return __fmul_rn(f, byte_f32(w ^ 0x80808080u, e % 4, 8388736.f));
    return __fmul_rn(f, byte_f32(w, e % 4, 8388608.f));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The table entries of sub-blocks e, e+1 of a row from their scale and min
// side values, in the form the decode of kVar reads:
//   fsplit    {s, -2^23*s} each (f32 bits)
//   base_f32  {s, m} each
//   xsum, split  {(b_e, b_e+1), -128*(b_e, b_e+1)} then zeros, b = bf16(s)
//   base      the same, then {(bf16 m'_e, bf16 m'_e+1), 0}
template <int kVar, int kM>
__device__ __forceinline__ void lb_factors(const float (&sv)[2], const float (&mv)[2], int bias,
                                           uint2 (&ent)[2]) {
  if constexpr (kVar == kFsplit || kVar == kBaseF32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float second = kVar == kFsplit ? __fmul_rn(-8388608.f, sv[h]) : mv[h];
      ent[h] = uint2{__float_as_uint(sv[h]), __float_as_uint(second)};
    }
  } else {
    float s[2], m[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) rule_factors<kVar, kM>(sv[h], mv[h], bias, s[h], m[h]);
    ent[0] = uint2{bf16_pair(s[0], s[1]), bf16_pair(-128.f * s[0], -128.f * s[1])};
    ent[1] = uint2{kVar == kBase ? bf16_pair(m[0], m[1]) : 0u, 0u};
  }
}

// Four codes of one plane (byte e of nib, sub-blocks 4q+e of the piece's
// group) to two words of bf16 weights, the lower position in the lower half,
// exactly as element() forms them:
//   fsplit    fma(2^23 + v, s, -2^23*s) = v*s rounded once to f32 (v mapped
//             by code_value through 2^23 + 128 + v and a subtract)
//   xsum, split  fma.bf16x2(128 + v, b, -128*b) = v*b rounded once to bf16
//   base      then sub.bf16x2 of bf16 m'
//   base_f32  (2^23 + v) - (2^23 + bias), times s, minus m, in f32
// magic is 2^23 + bias (and + 128 for mapped codes).
template <int kVar, int kM, int kMap>
__device__ __forceinline__ void lb_decode(uint32_t nib, const uint2 (&f)[16], int q, float magic,
                                          uint32_t& w0, uint32_t& w1) {
  if constexpr (kVar == kXsum || kVar == kSplit || kVar == kBase) {
    w0 = fma_bf16x2(__byte_perm(nib, 0x43u, 0x4140u), f[4 * q].x, f[4 * q].y);
    w1 = fma_bf16x2(__byte_perm(nib, 0x43u, 0x4342u), f[4 * q + 2].x, f[4 * q + 2].y);
    if constexpr (kVar == kBase) {
      w0 = sub_bf16x2(w0, f[4 * q + 1].x);
      w1 = sub_bf16x2(w1, f[4 * q + 3].x);
    }
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = __uint_as_float(f[4 * q + e].x);
      float c;
      if constexpr (kMap == kIdentity) {
        c = __int_as_float((int)__byte_perm(nib, 0x4B000000u, 0x7440u | e));
      } else {
        c = __int_as_float(0x4B000000 | (code_value<kMap>((int)((nib >> (8 * e)) & 0xF)) + 128));
      }
      if constexpr (kVar == kFsplit && kMap == kIdentity) {
        v[e] = __fmaf_rn(c, s, __uint_as_float(f[4 * q + e].y));
      } else {
        v[e] = __fmul_rn(__fsub_rn(c, magic), s);
        if constexpr (kVar == kBaseF32 && kM != kNone)
          v[e] = __fsub_rn(v[e], __uint_as_float(f[4 * q + e].y));
      }
    }
    w0 = bf16_pair(v[0], v[1]);
    w1 = bf16_pair(v[2], v[3]);
  }
}

// A warp's partial sums of its tile into part ([activation row][output
// row]): lane (g, t)'s accumulators are activation row g, output rows 2t,
// 2t+1; its min sums macc[b] (row g, activation row b, over the lane's
// sub-blocks) meet their quad's through pmin ([output row][activation row]).
__device__ __forceinline__ void lb_warp_partials(float (&acc)[2][4], float (&macc)[kLbActs],
                                                 bool min_live, float* pmin, float* part, int g,
                                                 int t) {
  if (min_live) {
#pragma unroll
    for (int b = 0; b < kLbActs; ++b) {
      macc[b] += __shfl_xor_sync(0xffffffffu, macc[b], 1);
      macc[b] += __shfl_xor_sync(0xffffffffu, macc[b], 2);
      if (t == 0) pmin[g * kLbActs + b] = macc[b];
      macc[b] = 0.f;
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int o = 2 * t + e;
    part[g * kLbRows + o] = acc[0][e] + acc[1][e] - (min_live ? pmin[o * kLbActs + g] : 0.f);
    acc[0][e] = acc[1][e] = 0.f;
  }
}

// Block (blockIdx.x, blockIdx.y): tiles bx, bx + grid, ... of `groups` row
// groups of 8 output rows, activation rows acts*by..; warp w takes row
// group w / splits of each tile and steps (w % splits)*per.. of its row. A
// step is 16*G whole sub-blocks (s0..) of the row group's 8 rows: R*G code
// pieces a row (piece pc: code row pc / G, 16 sub-blocks from s0 +
// 16*(pc % G), 16 bytes), lane (g, t) copying pieces t, t+4, ... of row g
// (so all its pieces lie in group t % G) and the scale and min sides of its
// 4*G sub-blocks s0 + 4G*t... . Each lane forms those sub-blocks' factors
// once into the warp's table and their min term against the block sums in
// the same walk; then every byte e of word q of a piece gives one weight a
// plane, k slot (2t, 2t+1, 2t+8, 2t+9)[e] of one m16n8k16 whose A row g
// holds activation row g at the same four positions.
// - Staging: the block's threads copy its activation rows once, coalesced,
//   each 16-byte run of a row (8 positions of one piece's plane: words q =
//   2qq, 2qq+1) to the slot lane (g = row, t) reads it from, [step][piece
//   i][plane][qq][row][t], so a warp's fragment reads are 512 contiguous
//   bytes; and the block sums beside them, [row][sub-block]. Rows past B
//   are zeros.
template <int kBits, int kVar, int kMap, int kS, int kM>
__global__ void __launch_bounds__(kLbMaxWarps * 32, 1)
quant_matmul_lowbit_kernel(const LowbitArgs a, const PlanLb p) {
  constexpr int kPlanes = 8 / kBits;
  constexpr uint32_t kMask = kBits == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  constexpr bool kMinTerm = kVar != kBase && kVar != kBaseF32;
  constexpr bool kHasSc = kS != kFlat;
  constexpr bool kHasMin = kM != kNone;
  constexpr bool kHasMn = kM == kHierU8 || kM == kHierI8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthr = p.warps * 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / p.splits, nbs = p.nbs;
  int b0 = blockIdx.y * p.acts, nb = min(p.acts, a.B - b0), e = 0;
  if (a.eid && !expert_run(a.eid, a.B, blockIdx.y, p.acts, b0, nb, e)) return;
  const size_t ex = (size_t)e * a.out_f;   // expert e's first row
  const int qn = a.in_f / kPlanes, np = qn / a.nsub * p.G;
  const int kV = 16 * p.G, kQ = 4 * p.G, grp = t & (p.G - 1);
  const bool min_live = kMinTerm && (kHasMin || a.bias != 0);
  // fsplit's mapped codes take no bias (it is in m'), base_f32's do
  const float magic = kVar == kBaseF32
      ? __fadd_rn(kMap == kIdentity ? 8388608.f : 8388736.f, (float)a.bias) : 8388736.f;
  const int ks = warp % p.splits, st0 = ks * p.per, n = min(p.per, p.steps - st0);
  const int jobs = n * ((p.tiles - (int)blockIdx.x + p.grid - 1) / p.grid);
  auto tile_of = [&](int j) { return (int)blockIdx.x + j / n * p.grid; };
  const float* const xsum_s = reinterpret_cast<const float*>(smem + p.xs_off);   // [row][nsub]
  unsigned char* const ring = smem + p.x_smem + warp * p.warp_smem;
  uint2* const tab = reinterpret_cast<uint2*>(ring + kLbRing * p.slot);   // [row][32]
  // partial sums of two tiles [parity][activation row][output row], then pmin
  float* const part = reinterpret_cast<float*>(ring + kLbRing * p.slot + kLbTab);

  // the code pieces and side chunks of this warp's job j (step st0 + j % n
  // of tile tile_of(j)) into slot j % kLbRing; a piece past R*G is
  // zero-filled, a row past out repeats the last row (its sums are not
  // stored)
  auto load_step = [&](int j) {
    unsigned char* sb = ring + (j % kLbRing) * p.slot;
    const int s0 = (st0 + j % n) * kV, k0 = s0 + kQ * t;
    const size_t o = ex + min((tile_of(j) * p.groups + rg) * kLbRows + g, a.out_f - 1);
    const uint8_t* crow = a.codes + o * qn;
#pragma unroll
    for (int i = 0; i < kLbPieces; ++i) {
      if (i < p.npl) {
        const int pc = 4 * i + t;
        const bool ok = pc < np;
        cp_async16(sb + i * 512 + lane * 16,
                   crow + (ok ? (size_t)(p.G == 2 ? pc >> 1 : pc) * a.nsub + s0 + 16 * grp : 0), ok);
      }
    }
    lb_copy_side<kS>(sb + p.npl * 512 + lane * 4 * kQ, sb + p.off_sc + lane * kQ,
                     a.d + o * a.nd, kHasSc ? a.sc + o * a.nsub : nullptr, k0, kQ, a.nd);
    if constexpr (kHasMin)
      lb_copy_side<kM>(sb + p.off_dm + lane * 4 * kQ, sb + p.off_mn + lane * kQ,
                       a.dmin + o * a.ndm, kHasMn ? a.mn + o * a.nsub : nullptr, k0, kQ, a.ndm);
  };

  // the first jobs are in flight while the block stages its activations
#pragma unroll
  for (int j = 0; j < kLbRing; ++j) {
    if (j < jobs) load_step(j);
    cp_async_commit();
  }
  {
    const int cpr = a.in_f / 8;   // 16-byte runs a row
    uint4* const xs = reinterpret_cast<uint4*>(smem);
    for (int u = tid; u < nbs * cpr; u += nthr) {
      const int b = u / cpr, pos0 = u % cpr * 8;
      const int pl = pos0 / qn, j = pos0 % qn, k0 = j % a.nsub;
      const int pc = j / a.nsub * p.G + k0 % kV / 16;
      const int qq = k0 / 8 & 1;
      xs[((((k0 / kV * p.npl + pc / 4) * kPlanes + pl) * 2 + qq) * nbs + b) * 4 + pc % 4] =
          b < nb ? __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(b0 + b) * a.in_f + pos0))
                 : uint4{0, 0, 0, 0};
    }
    if (min_live) {
      float* const xm = reinterpret_cast<float*>(smem + p.xs_off);
      for (int u = tid; u < nbs * a.nsub; u += nthr)
        xm[u] = u / a.nsub < nb ? __ldg(a.xsum + (size_t)b0 * a.nsub + u) : 0.f;
    }
  }
  __syncthreads();

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float macc[kLbActs];
#pragma unroll
  for (int b = 0; b < kLbActs; ++b) macc[b] = 0.f;
  const bool x_live = g < nbs;

  for (int i = 0; i < jobs; ++i) {
    // the slot of job i-1, read and used, takes job i-1+kLbRing: group j
    // of the warp holds job j
    if (i > 0) {
      if (i - 1 + kLbRing < jobs) load_step(i - 1 + kLbRing);
      cp_async_commit();
    }
    const int st = st0 + i % n, s0 = st * kV, k0 = s0 + kQ * t;
    cp_async_wait<kLbRing - 1>();
    const unsigned char* sb = ring + (i % kLbRing) * p.slot;
    // factors once a step, and the min term m' = bias*s + m of the same
    // sub-blocks against the block sums; every lane is done with the last
    // step's table
    __syncwarp();
    {
      float mp[8];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        if (e < kQ) {
          float sv[2], mv[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sv[h] = lb_side_value<kS>(sb + p.npl * 512 + lane * 4 * kQ, sb + p.off_sc + lane * kQ,
                                      e + h);
            if constexpr (kHasMin)
              mv[h] = lb_side_value<kM>(sb + p.off_dm + lane * 4 * kQ, sb + p.off_mn + lane * kQ,
                                        e + h);
            mp[e + h] = mv[h];
            if (a.bias != 0) {
              const float bs = __fmul_rn((float)a.bias, sv[h]);
              mp[e + h] = kHasMin ? __fadd_rn(bs, mv[h]) : bs;
            }
          }
          uint2 ent[2];
          lb_factors<kVar, kM>(sv, mv, a.bias, ent);
          tab[g * 32 + kQ * t + e] = ent[0];
          tab[g * 32 + kQ * t + e + 1] = ent[1];
        }
      }
      if (min_live) {
#pragma unroll
        for (int b = 0; b < kLbActs; ++b) {
          if (b < nb) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (4 * q < kQ) {
                const float4 xs = *reinterpret_cast<const float4*>(xsum_s + b * a.nsub + k0 + 4 * q);
                macc[b] = fmaf(xs.x, mp[4 * q], macc[b]);
                macc[b] = fmaf(xs.y, mp[4 * q + 1], macc[b]);
                macc[b] = fmaf(xs.z, mp[4 * q + 2], macc[b]);
                macc[b] = fmaf(xs.w, mp[4 * q + 3], macc[b]);
              }
            }
          }
        }
      }
    }
    __syncwarp();

    uint2 fac[16];
    {
      const uint4* tq = reinterpret_cast<const uint4*>(tab + g * 32 + 16 * grp);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = tq[q];
        fac[2 * q] = uint2{v.x, v.y};
        fac[2 * q + 1] = uint2{v.z, v.w};
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < kLbPieces; ++i2) {
      if (i2 < p.npl) {
        const bool ok = x_live && 4 * i2 + t < np;
        const uint4 c4 = *reinterpret_cast<const uint4*>(sb + i2 * 512 + lane * 16);
        const unsigned char* xq = smem + (size_t)((st * p.npl + i2) * kPlanes * 2 * nbs + g) * 64
                                  + t * 16;
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const uint4 xv = ok ? *reinterpret_cast<const uint4*>(xq + (pl * 2 + qq) * nbs * 64)
                                : uint4{0, 0, 0, 0};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * qq + h;
              const uint32_t nib = ((&c4.x)[q] >> (kBits * pl)) & kMask;
              uint32_t w0, w1;
              lb_decode<kVar, kM, kMap>(nib, fac, q, magic, w0, w1);
              const uint32_t af[4] = {h ? xv.z : xv.x, 0u, h ? xv.w : xv.y, 0u};
              // split sums its two planes apart
              mma_bf16(acc[kVar == kSplit ? pl : h], af, w0, w1);
            }
          }
        }
      }
    }

    // the tile's last step for this warp: its partial sums into the buffer
    // of the tile's parity; the block then sums each row group's splits and
    // writes y (the other buffer takes the next tile)
    if (i % n == n - 1) {
      const int tile = tile_of(i), buf = (i / n) & 1;
      lb_warp_partials(acc, macc, min_live, part + 2 * kLbActs * kLbRows,
                       part + buf * kLbActs * kLbRows, g, t);
      __syncthreads();
      for (int idx = tid; idx < p.groups * kLbActs * kLbRows; idx += nthr) {
        const int gr = idx / (kLbActs * kLbRows), b = idx / kLbRows % kLbActs;
        const int o = (tile * p.groups + gr) * kLbRows + idx % kLbRows;
        float sum = 0.f;
        for (int v = 0; v < p.splits; ++v)
          sum += reinterpret_cast<const float*>(smem + p.x_smem + (gr * p.splits + v) * p.warp_smem
                                                + kLbRing * p.slot + kLbTab)
              [buf * kLbActs * kLbRows + idx % (kLbActs * kLbRows)];
        if (b < nb && o < a.out_f) a.y[(size_t)(b0 + b) * a.out_f + o] = sum;
      }
    }
  }
  cp_async_wait<0>();
}

// Every geometry the stepped instances do not take (nsub % 16 != 0, or more
// than 16 code rows a sub-block): a block of 4 warps owns 8 output rows and
// 8 activation rows, its warps walking the row's 4-byte words in turn, lane
// (g, t) word 4c + t of row g; each byte's factors formed where it is used
// (element(), sub_factors()), the weights on the same m16n8k16 products, the
// min term summed after the walk; the warps' partial sums meet in shared
// memory.
template <int kBits, int kVar, int kMap, int kS, int kM>
__global__ void __launch_bounds__(kLbGenWarps * 32)
quant_matmul_lowbit_generic(const LowbitArgs a) {
  constexpr int kPlanes = 8 / kBits;
  constexpr uint32_t kMask = kBits == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  constexpr bool kMinTerm = kVar != kBase && kVar != kBaseF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kLbRows;
  int b0 = blockIdx.y * kLbActs, nb = min(kLbActs, a.B - b0), e = 0;
  if (a.eid && !expert_run(a.eid, a.B, blockIdx.y, kLbActs, b0, nb, e)) return;
  const int qn = a.in_f / kPlanes, words = qn / 4;
  // a row past out repeats the last row's loads; its sums are not stored
  const size_t o = (size_t)e * a.out_f + min(r0 + g, a.out_f - 1);
  const uint8_t* crow = a.codes + o * qn;
  const float* drow = a.d + o * a.nd;
  const uint8_t* scrow = kS == kFlat ? nullptr : a.sc + o * a.nsub;
  const float* dminrow = kM == kNone ? nullptr : a.dmin + o * a.ndm;
  const uint8_t* mnrow = (kM == kHierU8 || kM == kHierI8) ? a.mn + o * a.nsub : nullptr;
  const bool x_live = g < nb;
  const __nv_bfloat16* const xrow = a.x + (size_t)(b0 + (x_live ? g : 0)) * a.in_f;
  const bool min_live = kMinTerm && (kM != kNone || a.bias != 0);

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float macc[kLbActs];
#pragma unroll
  for (int b = 0; b < kLbActs; ++b) macc[b] = 0.f;
  for (int c = warp; 4 * c < words; c += kLbGenWarps) {
    const int wd = 4 * c + t;
    const bool ok = wd < words;
    const uint32_t u = ok ? __ldg(reinterpret_cast<const uint32_t*>(crow) + wd) : 0u;
    float s[4], m[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = (4 * wd + e) % a.nsub;
      m[e] = 0.f;
      // the base rules read the min side at k mod nd too (no mixed layout)
      sub_factors<kVar, kS, kM>(drow, scrow, dminrow, mnrow, a.bias, k, k % a.nd, s[e], m[e]);
    }
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl) {
      const uint32_t nib = (u >> (kBits * pl)) & kMask;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = element<kVar, kM, kMap>((int)((nib >> (8 * e)) & 0xFF), s[e], m[e], a.bias);
      uint2 xv = {0u, 0u};
      if (x_live && ok) xv = __ldg(reinterpret_cast<const uint2*>(xrow + pl * qn + 4 * wd));
      const uint32_t af[4] = {xv.x, 0u, xv.y, 0u};
      mma_bf16(acc[pl & 1], af, bf16_pair(w[0], w[1]), bf16_pair(w[2], w[3]));
    }
  }
  if (min_live) {
    for (int k = warp * 4 + t; k < a.nsub; k += 4 * kLbGenWarps) {
      float mp = 0.f;
      if constexpr (kM != kNone) mp = side_at<kM>(dminrow, mnrow, k, kM == kFlat ? k : k % a.ndm);
      if (a.bias != 0) {
        const float bs = __fmul_rn((float)a.bias, side_at<kS>(drow, scrow, k, kS == kFlat ? k : k % a.nd));
        mp = kM == kNone ? bs : __fadd_rn(bs, mp);
      }
#pragma unroll
      for (int b = 0; b < kLbActs; ++b)
        if (b < nb) macc[b] = fmaf(__ldg(a.xsum + (size_t)(b0 + b) * a.nsub + k), mp, macc[b]);
    }
  }
  float* const wpart = reinterpret_cast<float*>(smem) + warp * 2 * kLbActs * kLbRows;
  lb_warp_partials(acc, macc, min_live, wpart + kLbActs * kLbRows, wpart, g, t);
  __syncthreads();
  for (int idx = tid; idx < kLbActs * kLbRows; idx += kLbGenWarps * 32) {
    const int b = idx / kLbRows, r = idx % kLbRows;
    float sum = 0.f;
    for (int v = 0; v < kLbGenWarps; ++v)
      sum += reinterpret_cast<const float*>(smem)[v * 2 * kLbActs * kLbRows + idx];
    if (b < nb && r0 + r < a.out_f) a.y[(size_t)(b0 + b) * a.out_f + r0 + r] = sum;
  }
}

// What a launch of `kernel` would be, into info[8]: grid x and y, threads,
// shared bytes, registers a thread, local bytes a thread (spills), blocks
// an SM, and the instance.
template <class K>
int lb_plan_info(K kernel, dim3 grid, int threads, int smem, int inst, int* info) {
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, kernel);
  int per_sm = 0;
  if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (rc != 0) return rc;
  const int v[8] = {(int)grid.x, (int)grid.y, threads, smem, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, inst};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

// One instance: its launch, or with info its plan (lb_plan_info). The card
// is read, and the stepped kernel's shared-memory limit set, on the
// instance's first use on a device; a row too long for one staged
// activation row and a warp's region takes the generic instance.
template <int kBits, int kVar, int kMap, int kS, int kM>
int launch_one(const LowbitArgs& a, cudaStream_t st, int* info) {
  const dim3 gen_grid((a.out_f + kLbRows - 1) / kLbRows,
                      a.eid ? a.B : (a.B + kLbActs - 1) / kLbActs);
  const int gen_smem = kLbGenWarps * 2 * kLbActs * kLbRows * 4;
  PlanLb p;
  int smem = 0;
  if (lowbit_instance(kBits, a.in_f, a.nsub) != 2) {
    static CardCache cards;
    Card c;
    const int rc = cards.get(quant_matmul_lowbit_kernel<kBits, kVar, kMap, kS, kM>, 0, c);
    if (rc != 0) return rc;
    p = plan_lb(a.B, a.in_f, a.out_f, a.nsub, kBits, kS != kFlat, kM != kNone,
                kM == kHierU8 || kM == kHierI8, c);
    smem = p.x_smem + p.warps * p.warp_smem;
    if (smem > c.smem_block) smem = 0;
  }
  if (smem == 0) {
    if (info)
      return lb_plan_info(quant_matmul_lowbit_generic<kBits, kVar, kMap, kS, kM>, gen_grid,
                          kLbGenWarps * 32, gen_smem, 2, info);
    quant_matmul_lowbit_generic<kBits, kVar, kMap, kS, kM><<<gen_grid, kLbGenWarps * 32, gen_smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid(p.grid, a.eid ? a.B : (a.B + p.acts - 1) / p.acts);
  if (info)
    return lb_plan_info(quant_matmul_lowbit_kernel<kBits, kVar, kMap, kS, kM>, grid,
                        p.warps * 32, smem, p.G - 1, info);
  quant_matmul_lowbit_kernel<kBits, kVar, kMap, kS, kM><<<grid, p.warps * 32, smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

// The min sides a scale side pairs with: none or flat beside a flat scale,
// none or hierarchical beside a hierarchical one, and the mixed layout (flat
// scale, hierarchical min) for the variants with an xsum term. Value-mapped
// codes come without a min.
template <int kBits, int kVar, int kMap, int kS>
int launch_m(const LowbitArgs& a, int m_side, cudaStream_t st, int* info) {
  constexpr bool kBaseVar = kVar == kBase || kVar == kBaseF32;
  if (m_side == kNone) return launch_one<kBits, kVar, kMap, kS, kNone>(a, st, info);
  if constexpr (kMap == kIdentity) {
    if constexpr (kS == kFlat) {
      if (m_side == kFlat) return launch_one<kBits, kVar, kMap, kS, kFlat>(a, st, info);
    }
    if constexpr (kS != kFlat || !kBaseVar) {
      if (m_side == kHierU8) return launch_one<kBits, kVar, kMap, kS, kHierU8>(a, st, info);
      if (m_side == kHierI8) return launch_one<kBits, kVar, kMap, kS, kHierI8>(a, st, info);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int kBits, int kVar, int kMap>
int launch_s(const LowbitArgs& a, int s_side, int m_side, cudaStream_t st, int* info) {
  if (s_side == kFlat) return launch_m<kBits, kVar, kMap, kFlat>(a, m_side, st, info);
  if (s_side == kHierU8) return launch_m<kBits, kVar, kMap, kHierU8>(a, m_side, st, info);
  if (s_side == kHierI8) return launch_m<kBits, kVar, kMap, kHierI8>(a, m_side, st, info);
  return (int)cudaErrorInvalidValue;
}

// Which maps an instance takes: the fsplit rule and the 4-bit f32 base rule
// take the IQ2/IQ3 alphabets, the 4-bit f32 base rule nothing else (plain
// 4-bit codes take the bf16-magic base rule).
template <int kBits, int kVar>
int launch_map(const LowbitArgs& a, int vmap, int s_side, int m_side, cudaStream_t st, int* info) {
  constexpr bool kMapped = kBits == 4 && (kVar == kFsplit || kVar == kBaseF32);
  if constexpr (!(kBits == 4 && kVar == kBaseF32)) {
    if (vmap == kIdentity) return launch_s<kBits, kVar, kIdentity>(a, s_side, m_side, st, info);
  }
  if constexpr (kMapped) {
    if (vmap == kIq2) return launch_s<kBits, kVar, kIq2>(a, s_side, m_side, st, info);
    if (vmap == kIq3) return launch_s<kBits, kVar, kIq3>(a, s_side, m_side, st, info);
  }
  return (int)cudaErrorInvalidValue;
}

// The instance of bits, var and vmap (launch_map), after the checks every
// launch and plan share.
inline int lowbit_dispatch(const LowbitArgs& a, int s_side, int m_side, int bits, int var,
                           int vmap, cudaStream_t st, int* info) {
  if ((bits != 2 && bits != 4) || a.nsub <= 0 || a.in_f % (128 / bits)
      || (a.in_f * bits / 8) % a.nsub)
    return (int)cudaErrorInvalidValue;
  if (bits == 4) {
    switch (var) {
      case kFsplit: return launch_map<4, kFsplit>(a, vmap, s_side, m_side, st, info);
      case kXsum: return launch_map<4, kXsum>(a, vmap, s_side, m_side, st, info);
      case kSplit: return launch_map<4, kSplit>(a, vmap, s_side, m_side, st, info);
      case kBase: return launch_map<4, kBase>(a, vmap, s_side, m_side, st, info);
      case kBaseF32: return launch_map<4, kBaseF32>(a, vmap, s_side, m_side, st, info);
    }
  } else {
    if (var == kFsplit) return launch_map<2, kFsplit>(a, vmap, s_side, m_side, st, info);
    if (var == kBaseF32) return launch_map<2, kBaseF32>(a, vmap, s_side, m_side, st, info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B, in) bf16 block-minor; xsum (B, nsub) f32 (null for the base
// variants); codes (out, in*bits/8) u8; d (out, nd) f32; sc (out, nsub)
// u8/i8 or null; dmin (out, ndm) f32 or null; mn (out, nsub) u8/i8 or null
// -> y (B, out) f32. s_side and m_side name each side's storage (Side),
// var the element rule (Var), vmap the code alphabet (Map). 4-bit: in % 32 ==
// 0; 2-bit: in % 64 == 0; both need (in * bits / 8) a multiple of nsub and
// 16-byte aligned rows.
int lgt_quant_matmul_lowbit(const void* x, const void* xsum, const void* codes,
                            const void* d, const void* sc, const void* dmin,
                            const void* mn, void* y, int B, int in_f, int out_f,
                            int nsub, int nd, int ndm, int bias, int s_side,
                            int m_side, int bits, int var, int vmap, void* stream) {
  if (B == 0 || out_f == 0) return 0;
  const LowbitArgs a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
                     (const float*)d, (const uint8_t*)sc, (const float*)dmin,
                     (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  return lowbit_dispatch(a, s_side, m_side, bits, var, vmap, (cudaStream_t)stream, nullptr);
}

// lgt_quant_matmul_lowbit's expert-indexed launch: x (B, in) the routed
// pairs' activation rows sorted by expert (xsum their block sums), eid (B,)
// int32 their experts, and codes, d, sc, dmin, mn each E experts' arrays of
// the shapes above one after another -> y (B, out), row b against expert
// eid[b].
int lgt_quant_matmul_lowbit_moe(const void* x, const void* xsum, const void* eid,
                                const void* codes, const void* d, const void* sc,
                                const void* dmin, const void* mn, void* y, int B, int in_f,
                                int out_f, int nsub, int nd, int ndm, int bias, int s_side,
                                int m_side, int bits, int var, int vmap, void* stream) {
  if (B == 0 || out_f == 0) return 0;
  LowbitArgs a{(const __nv_bfloat16*)x, (const float*)xsum, (const uint8_t*)codes,
               (const float*)d, (const uint8_t*)sc, (const float*)dmin,
               (const uint8_t*)mn, (float*)y, B, in_f, out_f, nsub, nd, ndm, bias};
  a.eid = (const int*)eid;
  return lowbit_dispatch(a, s_side, m_side, bits, var, vmap, (cudaStream_t)stream, nullptr);
}

// The launch lgt_quant_matmul_lowbit makes for these arguments, into
// info[8]: grid x, grid y, threads a block, dynamic shared bytes, registers
// a thread, local (spill) bytes a thread, resident blocks an SM, and the
// instance (0: steps of 16 sub-blocks, 1: of 32, 2: the generic instance).
int lgt_quant_matmul_lowbit_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                                 int bits, int var, int vmap, void* info) {
  LowbitArgs a{};
  a.B = B;
  a.in_f = in_f;
  a.out_f = out_f;
  a.nsub = nsub;
  return lowbit_dispatch(a, s_side, m_side, bits, var, vmap, nullptr, (int*)info);
}

// xq (B, in) int8 block-minor; xs, xsum (B, nsub) f32; codes (out, in/2) u8;
// d (out, nd) f32; sc (out, nsub) u8/i8 or null; dmin (out, nd) f32 or null
// ((out, nsub) when flat); mn (out, nsub) u8/i8 or null -> y (B, out) f32.
// nsub % 4 == 0, in/nsub even; 16-byte aligned arrays.
int lgt_quant_matmul_int8(const void* xq, const void* xs, const void* xsum,
                          const void* codes, const void* d, const void* sc,
                          const void* dmin, const void* mn, void* y, int B, int in_f,
                          int out_f, int nsub, int nd, int bias, int s_side, int m_side,
                          void* stream) {
  if (nsub <= 0 || nd <= 0 || nsub % 4 || in_f % nsub || (in_f / nsub) % 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const Int8Args a{(const int8_t*)xq, (const float*)xs, (const float*)xsum,
                   (const uint8_t*)codes, (const float*)d, (const uint8_t*)sc,
                   (const float*)dmin, (const uint8_t*)mn, (float*)y,
                   B, in_f, out_f, nsub, nd, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_int8_geometry<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8) LGT_CASE(kHierU8, kHierI8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8) LGT_CASE(kHierI8, kHierI8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch lgt_quant_matmul_int8 makes for these arguments, into info[8]:
// grid x, grid y, threads a block, dynamic shared bytes, registers a thread,
// local (spill) bytes a thread, resident blocks an SM, and the instance (0:
// sub 32 on m16n8k32, 1: m16n8k16, both 16 sub-blocks a step; 2: m16n8k16,
// 4 sub-blocks a step, for nsub % 16 != 0).
int lgt_quant_matmul_int8_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                               void* info) {
  if (nsub <= 0 || nsub % 4 || in_f % nsub || (in_f / nsub) % 2)
    return (int)cudaErrorInvalidValue;
  int* const v = (int*)info;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return plan_int8_geometry<S, M>(B, in_f, out_f, nsub, v);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8) LGT_CASE(kHierU8, kHierI8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8) LGT_CASE(kHierI8, kHierI8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// x (B, in) bf16 block-minor; codes (out, in) int8; d (out, nd) f32;
// sc (out, nsub) u8/i8 or null; dmin (out, nd) f32 or null; mn (out, nsub)
// u8 or null -> y (B, out) f32. in % 16 == 0, nsub % nd == 0; 16-byte
// aligned rows.
int lgt_quant_matmul_8bit(const void* x, const void* codes, const void* d,
                          const void* sc, const void* dmin, const void* mn, void* y,
                          int B, int in_f, int out_f, int nd, int nsub, int bias,
                          int s_side, int m_side, void* stream) {
  if (in_f % 16 || nsub <= 0 || nd <= 0 || in_f % nsub || nsub % nd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  const Args8 a{(const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
                (const uint8_t*)sc, (const float*)dmin, (const uint8_t*)mn, (float*)y,
                B, in_f, out_f, nd, nsub, bias};
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_8bit<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// lgt_quant_matmul_8bit's expert-indexed launch (as
// lgt_quant_matmul_lowbit_moe): x (B, in) sorted by expert, eid (B,) int32,
// the arrays E experts' one after another -> y (B, out).
int lgt_quant_matmul_8bit_moe(const void* x, const void* eid, const void* codes,
                              const void* d, const void* sc, const void* dmin, const void* mn,
                              void* y, int B, int in_f, int out_f, int nd, int nsub, int bias,
                              int s_side, int m_side, void* stream) {
  if (in_f % 16 || nsub <= 0 || nd <= 0 || in_f % nsub || nsub % nd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_f == 0) return 0;
  Args8 a{(const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)d,
          (const uint8_t*)sc, (const float*)dmin, (const uint8_t*)mn, (float*)y,
          B, in_f, out_f, nd, nsub, bias};
  a.eid = (const int*)eid;
  const cudaStream_t st = (cudaStream_t)stream;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return launch_8bit<S, M>(a, st);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch lgt_quant_matmul_8bit makes for these arguments, into info[7]:
// grid x, grid y, threads a block, dynamic shared bytes, registers a thread,
// local (spill) bytes a thread, resident blocks an SM.
int lgt_quant_matmul_8bit_plan(int B, int in_f, int out_f, int nsub, int s_side, int m_side,
                               void* info) {
  if (nsub <= 0) return (int)cudaErrorInvalidValue;
  int* const v = (int*)info;
#define LGT_CASE(S, M) \
  if (s_side == S && m_side == M) return plan_8bit<S, M>(B, in_f, out_f, nsub, v);
  LGT_CASE(kFlat, kNone) LGT_CASE(kFlat, kFlat)
  LGT_CASE(kHierU8, kNone) LGT_CASE(kHierU8, kHierU8)
  LGT_CASE(kHierI8, kNone) LGT_CASE(kHierI8, kHierU8)
#undef LGT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
