// Native GGUF block repacker: wire format -> block-minor device layout.
//
// A copy of the JAX package's native/repack.cpp (the same entry points and
// the same output bytes). Python memory-maps the GGUF and calls these entry
// points per tensor; each decodes the wire blocks and emits the block-minor
// arrays that ops.linear.QuantLinear and the CUDA kernels read, equal byte
// for byte to quant/repack.py's numpy path (tests/test_torch_native_repack.py)
// but multi-threaded, which cuts the cold load of a model.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread repack.cpp -o librepack.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal
            int e = -1;
            do { mant <<= 1; e++; } while (!(mant & 0x400));
            mant &= 0x3FF;
            bits = sign | ((127 - 15 - e) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000 | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

// Block-minor position for logical element i within a row:
//   i = sigma*dsz + s*sub + t  ->  j = t*(g*nd) + s*nd + sigma
struct BlockMinor {
    int64_t nd, g, sub;
    inline int64_t map(int64_t i) const {
        int64_t sigma = i / dsz(), r = i % dsz();
        int64_t s = r / sub, t = r % sub;
        return t * (g * nd) + s * nd + sigma;
    }
    inline int64_t dsz() const { return g * sub; }
};

// pack a block-minor 4-bit code row (I values < 16) into I/2 planar bytes
inline void pack4_row(const uint8_t* q, int64_t I, uint8_t* out) {
    int64_t h = I / 2;
    for (int64_t j = 0; j < h; ++j)
        out[j] = (uint8_t)(q[j] | (q[h + j] << 4));
}

void parallel_rows(int64_t O, int n_threads,
                   const std::function<void(int64_t, int64_t)>& fn) {
    if (n_threads <= 1) { fn(0, O); return; }
    std::vector<std::thread> ts;
    int64_t per = (O + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min<int64_t>(O, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& t : ts) t.join();
}

// Q4_K sub-block scale/min extraction (6-bit pairs in 12 bytes)
inline void k4_scale_min(const uint8_t* sc12, uint8_t* sc, uint8_t* mn) {
    for (int j = 0; j < 4; ++j) {
        sc[j] = sc12[j] & 63;
        mn[j] = sc12[j + 4] & 63;
    }
    for (int j = 4; j < 8; ++j) {
        sc[j] = (uint8_t)((sc12[j + 4] & 0x0F) | ((sc12[j - 4] >> 6) << 4));
        mn[j] = (uint8_t)((sc12[j + 4] >> 4) | ((sc12[j] >> 6) << 4));
    }
}

}  // namespace

extern "C" {

// ---- Q8_0: 34-byte blocks of 32 --------------------------------------------
void repack_q8_0(const uint8_t* raw, int64_t O, int64_t I,
                 int8_t* codes, float* d, int n_threads) {
    const int64_t bpr = I / 32;          // blocks per row
    BlockMinor bm{bpr, 1, 32};
    parallel_rows(O, n_threads, [&](int64_t lo, int64_t hi) {
        std::vector<uint8_t> tmp(I);
        for (int64_t o = lo; o < hi; ++o) {
            const uint8_t* row = raw + o * bpr * 34;
            int8_t* crow = codes + o * I;
            float* drow = d + o * bpr;
            for (int64_t b = 0; b < bpr; ++b) {
                const uint8_t* blk = row + b * 34;
                uint16_t h;
                std::memcpy(&h, blk, 2);
                drow[b] = f16_to_f32(h);
                const int8_t* q = (const int8_t*)(blk + 2);
                // block-minor with g=1: j = t*nd + b
                for (int64_t t = 0; t < 32; ++t)
                    crow[t * bpr + b] = q[t];
            }
        }
    });
}

// ---- Q4_K: 144-byte super-blocks of 256 ------------------------------------
//
// compact == 0 (flat layout): sub-block index is the NATURAL order sb*8 + s
// (matches numpy rw's flattened layout where dsz == sub).
// compact == 1 (hierarchical): sub-block index is the TRANSPOSED order
// s*nd + sb (quant.repack.block_minor_perm with dsz=256), so a tile
// expansion d[k mod nd] indexes the right super-block.
void repack_q4_k(const uint8_t* raw, int64_t O, int64_t I,
                 uint8_t* codes, float* d, uint8_t* sc,
                 float* dmin, uint8_t* mn, int n_threads, int compact) {
    const int64_t nd = I / 256;
    parallel_rows(O, n_threads, [&](int64_t lo, int64_t hi) {
        std::vector<uint8_t> qbm(I);      // block-minor codes before packing
        for (int64_t o = lo; o < hi; ++o) {
            const uint8_t* row = raw + o * nd * 144;
            float* drow = d + o * nd;
            float* mrow = dmin + o * nd;
            uint8_t* scrow = sc + o * nd * 8;
            uint8_t* mnrow = mn + o * nd * 8;
            for (int64_t sb = 0; sb < nd; ++sb) {
                const uint8_t* blk = row + sb * 144;
                uint16_t h;
                std::memcpy(&h, blk, 2);
                drow[sb] = f16_to_f32(h);
                std::memcpy(&h, blk + 2, 2);
                mrow[sb] = f16_to_f32(h);
                uint8_t s8[8], m8[8];
                k4_scale_min(blk + 4, s8, m8);
                for (int s = 0; s < 8; ++s) {
                    int64_t k = compact ? (int64_t)s * nd + sb : sb * 8 + s;
                    scrow[k] = s8[s];
                    mnrow[k] = m8[s];
                }
                const uint8_t* qs = blk + 16;
                // wire: chunk c of 32 bytes -> elems 64c..64c+31 lo, +32..63 hi
                for (int c = 0; c < 4; ++c) {
                    const uint8_t* src = qs + 32 * c;
                    for (int l = 0; l < 32; ++l) {
                        // logical indices
                        int64_t i1 = 64 * c + l;        // low nibble
                        int64_t i2 = 64 * c + 32 + l;   // high nibble
                        // block-minor: i = sb*256 + s*32 + t
                        int64_t s1 = i1 / 32, t1 = i1 % 32;
                        int64_t s2 = i2 / 32, t2 = i2 % 32;
                        // block-minor: j = t*nsub + sub_index
                        int64_t k1 = compact ? s1 * nd + sb : sb * 8 + s1;
                        int64_t k2 = compact ? s2 * nd + sb : sb * 8 + s2;
                        qbm[t1 * (8 * nd) + k1] = src[l] & 0x0F;
                        qbm[t2 * (8 * nd) + k2] = src[l] >> 4;
                    }
                }
            }
            pack4_row(qbm.data(), I, codes + o * (I / 2));
        }
    });
}

// ---- Q6_K: 210-byte super-blocks of 256 -> int8 codes ----------------------
void repack_q6_k(const uint8_t* raw, int64_t O, int64_t I,
                 int8_t* codes, float* d, int8_t* sc, int n_threads,
                 int compact) {
    const int64_t nd = I / 256;
    // sub = 16, g = 16; compact flag: see repack_q4_k
    parallel_rows(O, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t o = lo; o < hi; ++o) {
            const uint8_t* row = raw + o * nd * 210;
            int8_t* crow = codes + o * I;
            float* drow = d + o * nd;
            int8_t* scrow = sc + o * nd * 16;
            for (int64_t sb = 0; sb < nd; ++sb) {
                const uint8_t* blk = row + sb * 210;
                const uint8_t* ql = blk;
                const uint8_t* qh = blk + 128;
                const int8_t* scales = (const int8_t*)(blk + 192);
                uint16_t h;
                std::memcpy(&h, blk + 208, 2);
                drow[sb] = f16_to_f32(h);
                for (int s = 0; s < 16; ++s)
                    scrow[compact ? (int64_t)s * nd + sb : sb * 16 + s] = scales[s];
                for (int half = 0; half < 2; ++half) {
                    const uint8_t* l_ = ql + 64 * half;
                    const uint8_t* l32 = ql + 64 * half + 32;
                    const uint8_t* hh = qh + 32 * half;
                    int64_t base = 128 * half;
                    for (int l = 0; l < 32; ++l) {
                        int q1 = (int)((l_[l] & 0x0F) | (((hh[l] >> 0) & 3) << 4)) - 32;
                        int q2 = (int)((l32[l] & 0x0F) | (((hh[l] >> 2) & 3) << 4)) - 32;
                        int q3 = (int)((l_[l] >> 4) | (((hh[l] >> 4) & 3) << 4)) - 32;
                        int q4 = (int)((l32[l] >> 4) | (((hh[l] >> 6) & 3) << 4)) - 32;
                        int64_t li[4] = {base + l, base + 32 + l,
                                         base + 64 + l, base + 96 + l};
                        int vals[4] = {q1, q2, q3, q4};
                        for (int k = 0; k < 4; ++k) {
                            int64_t i = li[k];                // logical in super
                            int64_t s = i / 16, t = i % 16;   // sub=16
                            int64_t sk = compact ? s * nd + sb : sb * 16 + s;
                            crow[t * (16 * nd) + sk] = (int8_t)vals[k];
                        }
                    }
                }
            }
        }
    });
}

}  // extern "C"
