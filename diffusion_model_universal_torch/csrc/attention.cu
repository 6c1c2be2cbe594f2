// Fused multi-head attention forward for Hopper, any sequence length:
//   out = softmax(q k^T * D^-0.5) v   per (batch, head), f32 logits and
//   softmax, the result stored in q's dtype.
//
// Replaces the TPU kernel `_mha_kernel`
// (diffusion_model_universal_tpu/ops/attention.py:38, launched by
// `mha_pallas` at :54), which holds one (batch, head)'s whole S x S score
// matrix in VMEM. A block's 227 KB of shared memory cannot hold that past
// S of about 200, so this kernel tiles over the keys with an online softmax
// (running max and sum in f32, the accumulator rescaled when the max
// grows): shared memory is fixed, and every S and D runs.
//
// Layout: q, k, v are [B, N, S, D] given by element strides for the batch,
// head and sequence axes, with unit stride on D (the UNet passes head-split
// views of its [B, S, N*D] projections); out is written through its own
// strides ([B, S, N, D] memory), so no copy is made on either side.
//
// Work split (ops/attention.py::mha_launch_plan computes it and passes every
// number of the launch; dmu_mha_fwd only checks that the plan covers S and D
// and matches the unit walk below, and refuses a launch otherwise):
// - A block has 4 warps; each warp owns 16 query rows of one (batch, head).
//   For S <= 16 a block packs 4 (batch, head) pairs, one a warp (serving
//   has B*N = 64 heads: 16 blocks instead of 64 mostly idle ones); for
//   larger S a block takes 64 query rows of one (batch, head).
// - Keys and values stream through shared memory in stages of 64 rows
//   (64 keys of one head, or 16 keys of each of the 4 packed heads) x 64
//   columns of D (128 in bf16 with 4 heads a block and D > 64, so the
//   UNet's D = 128 at S = 1 takes one stage of k and one of v), two
//   stages, filled with cp.async
//   (16-byte copies, zero-filled past S and D) while the warps work on the
//   other stage. A key tile's logits take one stage per stage-width of D;
//   then its values take one stage per stage-width of the output chunk.
//   The ring stays when the launch is only one stage of k and one of v
//   (S <= 16 with D <= 64, or D <= 128 in bf16): filling both behind one
//   barrier was slower on the card, since q k^T then waits for v as well.
// - q k^T accumulates over all of D, then P v fills an output chunk of up
//   to 256 columns. D <= 256 is one output chunk; a larger D takes
//   the output 256 columns at a time, q k^T being recomputed for each
//   further chunk, so the accumulator stays within 128 registers for any
//   D. Columns past D read as zeros (D need not be a multiple of 16);
//   copies fall back to scalar loads when D or a stride is not a multiple
//   of 16 bytes.
//
// Numerics:
// - bf16: mma.sync m16n8k16 on the tensor cores with f32 accumulation for
//   both q k^T and P v. Products of bf16 values are exact in f32, so the
//   logits match the f32 reference up to summation order. P enters P v
//   rounded to bf16, as mha_plain and mha_xla round the probabilities to
//   v's dtype; the difference is that this kernel rounds the unnormalised
//   exp(s - m) and divides by the f32 row sum at the end (one bf16
//   rounding of each probability either way, relative 2^-9).
// - f32: the same tiling on the CUDA cores in full f32 (no TF32).
//
// Instances: for each (keys a stage, stage width, dtype), one with a single
// stage of v an output chunk (D up to the stage width: the UNet's D = 64,
// and D = 128 in bf16 at S <= 16) and one with the most its width allows
// (4 stages of 64 columns, 2 of 128); the plan's `outs` bounds the output
// loops of the second at run time. One instance of the most stages alone
// holds twice the accumulator registers, and on the card it was slower at
// every timed shape with one stage of v (the most at S = 1024).
//
// What bounds it on an H100: at S <= 64 (the UNet's 32x32 and 64x64
// configs: S = 1 .. 64), launch latency and the serial chain of a block
// (copy, q k^T, softmax, P v, store: a few microseconds); the bytes are
// 4*S*D*itemsize a head. At S >= 256 (128x128 images and up), operations:
// 4*S*S*D a head on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;               // rows of a stage (keys or values)
constexpr int kCols = 64;               // columns of an f32 stage
constexpr int kLdF32 = kCols + 4;       // 272-byte rows
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, n, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Strides qs, ks, vs, os;
  int BN, N, S, D;
  float scale_log2;  // D^-0.5 * log2(e): the softmax runs on exp2
  int chunks;        // ceil(D / stage width): stages of k a key tile
  int outs;          // stages of v an output chunk (at most the instance's)
  int key_tiles;     // ceil(S / keys a tile)
  int q_tiles;       // ceil(S / query rows a head a block)
  int units;         // stage fills a block
  int vec;           // 16-byte cp.async copies are possible
  int qpairs;        // q's rows hold whole, 4-byte aligned bf16 pairs
  int opairs;        // so do out's
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Fill one stage with unit `part` of key tile `kt`: rows [KT i, KT i + KT)
// hold keys kt*KT .. of the block's i-th head, columns [col0, col0 + CW)
// of K (or V); zeros past S, past D and past the last head.
template <typename T, int KT, int CW>
__device__ __forceinline__ void load_stage(const Args& a, const T* base,
                                           const Strides& st, int hg, int kt,
                                           int col0, T* stage, int ld) {
  constexpr int kPer = 16 / sizeof(T);   // elements a 16-byte copy
  constexpr int kPerRow = CW / kPer;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * kPer;
    const int bh = hg * (kRows / KT) + r / KT;
    const int j = kt * KT + r % KT;
    const bool row_ok = bh < a.BN && j < a.S;
    const T* src = base;
    if (row_ok)
      src = base + (long long)(bh / a.N) * st.b +
            (long long)(bh % a.N) * st.n + (long long)j * st.s + col0 + c;
    T* dst = stage + r * ld + c;
    if (a.vec) {
      const bool ok = row_ok && col0 + c < a.D;
      cp_async16(smem_u32(dst), ok ? src : base, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        dst[e] = (row_ok && col0 + c + e < a.D) ? src[e] : T(0.f);
    }
  }
}

// The unit sequence of a block: for each output chunk c (CW outs columns),
// for each key tile kt, `chunks` units of K (columns CW part) and then
// `outs` units of V (columns CW (outs c + part - chunks)).
struct Unit {
  int c, kt, part;
};
__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  const int per = a.chunks + a.outs;
  const int rest = u / per;
  return Unit{rest / a.key_tiles, rest % a.key_tiles, u % per};
}

template <typename T, int KT, int CW>
__device__ __forceinline__ void fill(const Args& a, int u, int hg, T* stage,
                                     int ld) {
  if (u >= a.units) return;   // an empty group keeps the waits uniform
  const Unit un = unit_of(a, u);
  if (un.part < a.chunks)
    load_stage<T, KT, CW>(a, static_cast<const T*>(a.k), a.ks, hg, un.kt,
                          CW * un.part, stage, ld);
  else
    load_stage<T, KT, CW>(a, static_cast<const T*>(a.v), a.vs, hg, un.kt,
                          CW * (a.outs * un.c + un.part - a.chunks), stage,
                          ld);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two consecutive bf16 of q's row `r` from (even) column `d` as one
// A-fragment register, zeros past S and D; one 32-bit load when q's rows
// hold whole, aligned pairs (`pairs`).
__device__ __forceinline__ uint32_t q_pair(const unsigned short* row, bool ok,
                                           int d, int D, bool pairs) {
  if (pairs)
    return (ok && d < D) ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
  const uint32_t lo = (ok && d < D) ? row[d] : 0u;
  const uint32_t hi = (ok && d + 1 < D) ? row[d + 1] : 0u;
  return lo | (hi << 16);
}

// The bf16 kernel: KT keys of each head a stage (64 with one head a
// block, 16 with four), stages CW columns wide (64, or 128 with four heads
// a block and D > 64), at most NO stages of v (CW NO output columns) a
// chunk; outs of them are used.
template <int KT, int NO, int CW>
__global__ void __launch_bounds__(kThreads)
mha_fwd_bf16_kernel(Args a) {
  constexpr int kHeads = kRows / KT;          // heads a block
  constexpr int kQRows = 16 * kWarps / kHeads;  // query rows a head a block
  constexpr int kNT = KT / 8;                 // n8 tiles of logits
  constexpr int kLd = CW + 8;                 // rows 16 bytes apart in
                                              // bank groups: ldmatrix
                                              // without conflicts
  constexpr int kKK = CW / 16;                // k16 steps a stage
  constexpr int kON = CW / 8 * NO;            // n8 tiles of the output
  __shared__ __align__(128) bf16 stages[2][kRows * kLd];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hg = blockIdx.x / a.q_tiles, qt = blockIdx.x % a.q_tiles;
  const int hw = kHeads == 1 ? 0 : warp;      // the warp's head in the block
  const int bh = hg * kHeads + hw;
  const int q0 = qt * kQRows + (kHeads == 1 ? 16 * warp : 0);
  const bool active = bh < a.BN && q0 < a.S;  // warp-uniform
  const int b = active ? bh / a.N : 0, h = active ? bh % a.N : 0;
  const unsigned short* qp = static_cast<const unsigned short*>(a.q) +
                             b * a.qs.b + h * a.qs.n;
  const unsigned short* qrow[2] = {qp + (long long)(q0 + g) * a.qs.s,
                                   qp + (long long)(q0 + g + 8) * a.qs.s};
  const bool qok[2] = {active && q0 + g < a.S, active && q0 + g + 8 < a.S};

  const int units = a.units;
  float o[kON][4], s[kNT][4], m[2], l[2];
  // q's A fragments of CW columns `part` in qf[part & 1]: the first two
  // are loaded before the first stage lands, a further one when it is
  // needed.
  uint32_t qf[2][kKK][4];
  int qf_part[2] = {0, 1};
  auto load_q = [&](uint32_t (&dst)[kKK][4], int part) {
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      const int d0 = CW * part + 16 * kk + 2 * tq;
      dst[kk][0] = q_pair(qrow[0], qok[0], d0, a.D, a.qpairs);
      dst[kk][1] = q_pair(qrow[1], qok[1], d0, a.D, a.qpairs);
      dst[kk][2] = q_pair(qrow[0], qok[0], d0 + 8, a.D, a.qpairs);
      dst[kk][3] = q_pair(qrow[1], qok[1], d0 + 8, a.D, a.qpairs);
    }
  };
  // s += q[:, CW part ..] k[kt tile, CW part ..]^T from stage st.
  auto logits = [&](const uint32_t (&q)[kKK][4], uint32_t st, int part) {
    const int mi = lane / 8;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      if (CW * part + 16 * kk >= a.D) break;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int row = hw * KT + (2 * np + mi / 2) * 8 + lane % 8;
        const int col = 16 * kk + (mi % 2) * 8;
        uint32_t r0, r1, r2, r3;
        ldmatrix_x4(st + 2 * (row * kLd + col), r0, r1, r2, r3);
        mma_16816(s[2 * np], q[kk], r0, r1);
        mma_16816(s[2 * np + 1], q[kk], r2, r3);
      }
    }
  };
  const int outs = NO == 1 ? 1 : a.outs;      // compile-time when NO is 1
  const int on = CW / 8 * outs;               // n8 output tiles in use
  fill<bf16, KT, CW>(a, 0, hg, stages[0], kLd);
  cp_async_commit();
  load_q(qf[0], 0);
  if (a.chunks > 1) load_q(qf[1], 1);
  for (int u = 0; u < units; ++u) {
    fill<bf16, KT, CW>(a, u + 1, hg, stages[(u + 1) & 1], kLd);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Unit un = unit_of(a, u);
    const uint32_t st = smem_u32(stages[u & 1]);
    const int mi = lane / 8;
    if (active) {
      if (un.kt == 0 && un.part == 0) {
#pragma unroll
        for (int i = 0; i < kON; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      }
      if (un.part == 0) {
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      }
      if (un.part < a.chunks) {
        const int slot = un.part & 1;
        if (qf_part[slot] != un.part) {
          if (slot) load_q(qf[1], un.part); else load_q(qf[0], un.part);
          qf_part[slot] = un.part;
        }
        if (slot) logits(qf[1], st, un.part); else logits(qf[0], st, un.part);
      } else {
        const int vp = un.part - a.chunks;    // the chunk's 64 columns vp
        if (vp == 0) {
          // Online softmax over this key tile.
          float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < kNT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = un.kt * KT + 8 * i + 2 * tq + (e & 1);
              s[i][e] = key < a.S ? s[i][e] * a.scale_log2 : -INFINITY;
              mt[e >> 1] = fmaxf(mt[e >> 1], s[i][e]);
            }
          float alpha[2], lt[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
            mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
            mt[r] = fmaxf(mt[r], m[r]);
            alpha[r] = exp2f(m[r] - mt[r]);
            m[r] = mt[r];
          }
#pragma unroll
          for (int i = 0; i < kNT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[i][e] = exp2f(s[i][e] - m[e >> 1]);
              lt[e >> 1] += s[i][e];
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 1);
            lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 2);
            l[r] = l[r] * alpha[r] + lt[r];
          }
#pragma unroll
          for (int i = 0; i < kON; ++i) {
            if (i >= on) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
          }
        }
        // o[CW vp ..] += P v[kt tile, CW (outs c + vp) ..].
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (j != vp) continue;
#pragma unroll
          for (int kc = 0; kc < KT / 16; ++kc) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
            for (int np = 0; np < CW / 16; ++np) {
              const int row = hw * KT + 16 * kc + (mi % 2) * 8 + lane % 8;
              const int col = (2 * np + mi / 2) * 8;
              uint32_t r0, r1, r2, r3;
              ldmatrix_x4_trans(st + 2 * (row * kLd + col), r0, r1, r2, r3);
              mma_16816(o[CW / 8 * j + 2 * np], pa, r0, r1);
              mma_16816(o[CW / 8 * j + 2 * np + 1], pa, r2, r3);
            }
          }
        }
        if (un.kt == a.key_tiles - 1 && vp == outs - 1) {
          bf16* op = static_cast<bf16*>(a.out) + b * a.os.b + h * a.os.n;
          const float inv[2] = {1.f / l[0], 1.f / l[1]};
          // Columns 2 tq and 2 tq + 1 of each n8 tile are this thread's:
          // one 32-bit store when the output's rows hold whole pairs.
#pragma unroll
          for (int i = 0; i < kON; ++i) {
            if (i >= on) break;
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int row = q0 + g + 8 * (e >> 1);
              const int col = CW * outs * un.c + 8 * i + 2 * tq;
              if (row >= a.S || col >= a.D) continue;
              bf16* dst = op + (long long)row * a.os.s + col;
              const float lo = o[i][e] * inv[e >> 1];
              const float hi = o[i][e + 1] * inv[e >> 1];
              if (a.opairs) {
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(lo, hi);
              } else {
                dst[0] = __float2bfloat16(lo);
                if (col + 1 < a.D) dst[1] = __float2bfloat16(hi);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// The f32 kernel: the same units and stages on the CUDA cores. Lane
// (r, hf) = (lane % 16, lane / 16) owns query row q0 + r, the keys
// 2 jj + hf of a tile and the output columns 64 j + 2 cc + hf of a chunk
// (j < outs <= NO).
template <int KT, int NO>
__global__ void __launch_bounds__(kThreads)
mha_fwd_f32_kernel(Args a) {
  constexpr int kHeads = kRows / KT;
  constexpr int kQRows = 16 * kWarps / kHeads;
  constexpr int kJ = KT / 2;
  __shared__ __align__(16) float stages[2][kRows * kLdF32];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane % 16, hf = lane / 16;
  const int hg = blockIdx.x / a.q_tiles, qt = blockIdx.x % a.q_tiles;
  const int hw = kHeads == 1 ? 0 : warp;
  const int bh = hg * kHeads + hw;
  const int q0 = qt * kQRows + (kHeads == 1 ? 16 * warp : 0);
  const bool active = bh < a.BN && q0 < a.S;
  const int b = active ? bh / a.N : 0, h = active ? bh % a.N : 0;
  const bool qok = q0 + r < a.S;
  const float* qrow = static_cast<const float*>(a.q) + b * a.qs.b +
                      h * a.qs.n + (long long)(q0 + r) * a.qs.s;

  const int units = a.units;
  const int outs = NO == 1 ? 1 : a.outs;
  float o[NO][32], s[kJ], m = -INFINITY, l = 0.f;

  fill<float, KT, kCols>(a, 0, hg, stages[0], kLdF32);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    fill<float, KT, kCols>(a, u + 1, hg, stages[(u + 1) & 1], kLdF32);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Unit un = unit_of(a, u);
    const float* st = stages[u & 1];
    if (active) {
      if (un.kt == 0 && un.part == 0) {
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int c = 0; c < 32; ++c) o[j][c] = 0.f;
        m = -INFINITY;
        l = 0.f;
      }
      if (un.part == 0) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) s[j] = 0.f;
      }
      if (un.part < a.chunks) {
        const int d0 = kCols * un.part;
        const int dn = min(kCols, a.D - d0);
        const float* krow = st + (hw * KT + hf) * kLdF32;
        for (int d = 0; d < dn; ++d) {
          const float qd = qok ? qrow[d0 + d] : 0.f;
#pragma unroll
          for (int j = 0; j < kJ; ++j) s[j] += qd * krow[2 * j * kLdF32 + d];
        }
      } else {
        const int vp = un.part - a.chunks;
        if (vp == 0) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int key = un.kt * KT + 2 * j + hf;
            s[j] = key < a.S ? s[j] * a.scale_log2 : -INFINITY;
            mt = fmaxf(mt, s[j]);
          }
          mt = fmaxf(fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16)), m);
          const float alpha = exp2f(m - mt);
          m = mt;
          float lt = 0.f;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            s[j] = exp2f(s[j] - m);
            lt += s[j];
          }
          lt += __shfl_xor_sync(0xffffffffu, lt, 16);
          l = l * alpha + lt;
#pragma unroll
          for (int jo = 0; jo < NO; ++jo) {
            if (jo >= outs) break;
#pragma unroll
            for (int c = 0; c < 32; ++c) o[jo][c] *= alpha;
          }
        }
        const float* vmine = st + (hw * KT + hf) * kLdF32 + hf;
        const float* voth = st + (hw * KT + 1 - hf) * kLdF32 + hf;
#pragma unroll
        for (int jo = 0; jo < NO; ++jo) {
          if (jo != vp) continue;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const float mine = s[j];
            const float other = __shfl_xor_sync(0xffffffffu, s[j], 16);
#pragma unroll
            for (int c = 0; c < 32; ++c)
              o[jo][c] += mine * vmine[2 * j * kLdF32 + 2 * c] +
                          other * voth[2 * j * kLdF32 + 2 * c];
          }
        }
        if (un.kt == a.key_tiles - 1 && vp == outs - 1 && qok) {
          float* op = static_cast<float*>(a.out) + b * a.os.b + h * a.os.n +
                      (long long)(q0 + r) * a.os.s;
          const float inv = 1.f / l;
#pragma unroll
          for (int jo = 0; jo < NO; ++jo) {
            if (jo >= outs) break;
#pragma unroll
            for (int c = 0; c < 32; ++c) {
              const int col = kCols * (outs * un.c + jo) + 2 * c + hf;
              if (col < a.D) op[col] = o[jo][c] * inv;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// The instance for this launch: one stage of v an output chunk, or the
// most (a.outs is at most that, checked by the caller).
int launch_kernel(const Args& a, int is_bf16, int heads, int cols, int grid,
                  cudaStream_t st) {
  const bool one = a.outs == 1;
  if (is_bf16 && cols == 128) {
    if (one) mha_fwd_bf16_kernel<16, 1, 128><<<grid, kThreads, 0, st>>>(a);
    else mha_fwd_bf16_kernel<16, 2, 128><<<grid, kThreads, 0, st>>>(a);
  } else if (is_bf16 && heads == 4) {
    mha_fwd_bf16_kernel<16, 1, 64><<<grid, kThreads, 0, st>>>(a);
  } else if (is_bf16) {
    if (one) mha_fwd_bf16_kernel<64, 1, 64><<<grid, kThreads, 0, st>>>(a);
    else mha_fwd_bf16_kernel<64, 4, 64><<<grid, kThreads, 0, st>>>(a);
  } else if (heads == 4) {
    if (one) mha_fwd_f32_kernel<16, 1><<<grid, kThreads, 0, st>>>(a);
    else mha_fwd_f32_kernel<16, 4><<<grid, kThreads, 0, st>>>(a);
  } else {
    if (one) mha_fwd_f32_kernel<64, 1><<<grid, kThreads, 0, st>>>(a);
    else mha_fwd_f32_kernel<64, 4><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out in turn.
// plan: heads a block, stage width, chunks, outs, key tiles, query tiles,
// units and blocks, as ops/attention.py::mha_launch_plan gives them. The
// plan is checked, not recomputed: it must cover S and D with no empty
// tile, fit an instance, and match the unit walk; else the launch is
// refused.
extern "C" int dmu_mha_fwd(const void* q, const void* k, const void* v,
                           void* out, const long long* strides, int B, int N,
                           int S, int D, float scale, int is_bf16,
                           const int* plan, void* stream) {
  const int heads = plan[0], cols = plan[1], chunks = plan[2],
            outs = plan[3], key_tiles = plan[4], q_tiles = plan[5],
            units = plan[6], blocks = plan[7];
  if (B <= 0 || N <= 0 || S <= 0 || D <= 0 || (long long)B * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int keys = kRows / (heads > 0 ? heads : 1);
  const int qrows = 16 * kWarps / (heads > 0 ? heads : 1);
  const int max_outs = !is_bf16 || (heads == 1 && cols == 64) ? 4
                       : cols == 128                          ? 2
                                                              : 1;
  const bool ok =
      (heads == 1 || heads == 4) &&
      (cols == kCols || (cols == 128 && is_bf16 && heads == 4)) &&
      (long long)(chunks - 1) * cols < D && (long long)chunks * cols >= D &&
      outs >= 1 && outs <= chunks && outs <= max_outs &&
      (long long)(key_tiles - 1) * keys < S &&
      (long long)key_tiles * keys >= S &&
      (long long)(q_tiles - 1) * qrows < S && (long long)q_tiles * qrows >= S &&
      (long long)units == (long long)((chunks + outs - 1) / outs) *
                              key_tiles * (chunks + outs) &&
      (long long)blocks == ((long long)B * N + heads - 1) / heads * q_tiles;
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.BN = B * N;
  a.N = N;
  a.S = S;
  a.D = D;
  a.scale_log2 = scale * kLog2e;
  a.chunks = chunks;
  a.outs = outs;
  a.key_tiles = key_tiles;
  a.q_tiles = q_tiles;
  a.units = units;
  const int per = is_bf16 ? 8 : 4;
  bool vec = D % per == 0 && aligned16(k) && aligned16(v);
  for (int i = 3; i < 9; ++i) vec = vec && strides[i] % per == 0;
  a.vec = vec ? 1 : 0;
  const bool even = D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 4 == 0;
  a.qpairs = even && strides[0] % 2 == 0 && strides[1] % 2 == 0 &&
             strides[2] % 2 == 0;
  a.opairs = even && strides[9] % 2 == 0 && strides[10] % 2 == 0 &&
             strides[11] % 2 == 0;
  return launch_kernel(a, is_bf16, heads, cols, blocks,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
