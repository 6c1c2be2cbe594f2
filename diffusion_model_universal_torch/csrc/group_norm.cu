// Fused GroupNorm(+per-sample time bias)(+SiLU) for Hopper: the forward
// (kernel K1) and its backward (kernel K2).
//
// K1 replaces the TPU kernel `_gn_fwd_kernel`
// (diffusion_model_universal_tpu/ops/group_norm.py:167, launched by
// `group_norm_silu_pallas` at :252/:271); K2 replaces `_gn_bwd_kernel`
// (:184, launched by `group_norm_silu_pallas_bwd` at :291/:306). The math
// is the reference's:
//   v    = x + tb                          (tb: optional [B, C] time bias)
//   mean = E_group[v], var = max(E_group[v^2] - mean^2, 0), in f32 (not
//          Welford: the reference takes the two sums)
//   K1:  a = rstd * gamma,  b = beta + (tb - mean) * a
//        out = x * a + b, then optional SiLU, applied in f32 and stored in
//        x's dtype.
//   K2:  xhat = (v - mean) * rstd (the statistics recomputed from x, as the
//        reference's custom_vjp does: x must be read anyway to form xhat)
//        with SiLU: z = gamma*xhat + beta, dz = dy*sig(z)*(1 + z*(1 - sig(z)))
//        without:   dz = dy
//        dgamma = sum_{b,s} dz*xhat, dbeta = sum_{b,s} dz   (f32 [C])
//        s1 = sum_group dz*gamma, s2 = sum_group dz*gamma*xhat
//        dx = rstd * (dz*gamma - (s1 + xhat*s2) / N), in x's dtype
//        dtb = sum_s dx                                    (f32 [B, C])
// exp and the divisions of SiLU and its derivative use the fast intrinsics
// (__expf, __fdividef: a few ulp in f32).
//
// Layout: x, out, dy, dx are channels-last [B, S = H*W, C], contiguous;
// gamma, beta are f32 [C]; tb is f32 [B, C] or null.
//
// What bounds them on an H100: memory. K1 must read x and write out,
// 2*n*itemsize bytes (n = B*S*C) at 3.35 TB/s; K2 must read x and dy and
// write dx, 3*n*itemsize bytes. Both do 10-40 flops and 2-4 special-
// function ops (exp, reciprocal) an element, under the card's rates.
//
// Design (both kernels; ops/group_norm.py::gn_launch_plan chooses every
// number below and the CPU tests emulate its partition and sum order):
// - Vectors along C. A sample's rows of C channels are contiguous, so a
//   block's share of a sample is one contiguous run of memory. Each thread
//   takes 16-byte vectors of it (8 channels in bf16, 4 in f32; a narrower
//   power of two where C or the pointers' alignment does not allow 16
//   bytes), consecutive threads on consecutive vectors: every sector a warp
//   touches is used whole. The block has T = R * C/V threads, so a thread
//   always meets the same V channels (column col = tid % (C/V)) on rows
//   trow, trow + R, ..., and keeps per-channel f32 partials of its sums in
//   registers, whatever the group size (3, 4, 12, 24, 256: groups may start
//   inside a vector). Partials are summed per channel across the R thread
//   rows in shared memory; then each thread folds the channels of its own
//   groups (four interleaved running sums in a fixed order, so all threads
//   agree bit for bit), as the reference's `_block_stats` and
//   `group_affine` fold per-channel sums.
// - One HBM read. Where a sample is large, a thread block cluster of up to
//   8 blocks splits its rows; each block publishes its per-channel partials
//   in shared memory, and after a cluster barrier every block sums all the
//   blocks' partials through distributed shared memory (map_shared_rank),
//   in rank order 0, 1, ..., so every block holds the same totals. Between
//   passes a block keeps its rows of x (and of dy in K2) on chip: in
//   registers where one round of loads holds them (small samples: no
//   shared-memory round trip and no copy engine on the critical path), else
//   in shared memory. With 16-byte vectors one thread starts the slab's
//   copy as up to 4 bulk asynchronous copies (TMA, cp.async.bulk) on
//   mbarriers, so all of it is in flight at once and the threads sum chunk
//   k while later chunks arrive. Where even an 8-block cluster cannot hold
//   the slab (K1 in f32 and K2 at S=4096, C=128), the same kernel reads x
//   (and dy) again from L2/HBM in each later pass instead. A last cluster
//   barrier keeps every block until no other block reads its shared memory.
// - Small samples. Where one round of loads can hold a whole sample, no
//   cluster is used: one block takes the sample, or (K1 only; the SPLIT
//   instantiation) C splits into blocks of whole groups, rows of at least
//   64 bytes, until the grid has about 128 blocks, so the groups are
//   independent and no block waits on another. Its thread rows cover the
//   sample's rows: no 240 of 256 threads idle behind a 16-element group.
//   Calls of at most 256 KB are latency-bound: there the plan takes the
//   narrowest vectors (4 bytes first) that still fit, so a thread has
//   fewer channels and a shorter chain of dependent work. A batch of more
//   than twice the SM count gives a block several samples in turn.
// - K2 in one launch. The per-channel sums of dz*xhat and dz of each sample
//   (its share of dgamma, dbeta) go to an f32 scratch from rank 0. The
//   samples form teams of `team` consecutive samples (about sqrt(B)): every
//   writer block fences and takes a ticket from its team's integer counter,
//   and the last one sums the team's rows in order into a team row; it then
//   takes a ticket from the global counter, and the last team's finisher
//   sums the team rows in order into dgamma, dbeta. Each sum is split into P
//   runs of consecutive rows read as 16-byte vectors, then the runs in
//   order; the finisher resets each counter to 0. Integer tickets are the
//   only atomics: two calls give bit-identical results.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // gn_launch_plan's MAX_THREADS
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxSmem = 232448;   // 227 KB a block can use
constexpr int kUnrollFwd = 4;      // vectors in flight per thread and pass
constexpr int kUnrollBwd = 2;      // (x and dy: twice as many in K2)
constexpr int kChunks = 4;         // bulk copies (and mbarriers) a slab
// How a block holds its rows between passes (GnArgs::keep).
constexpr int kReread = 0, kShared = 1, kRegisters = 2;

// One vector of VB bytes of channels, read and written as one access.
template <int VB> union Bits;
template <> union Bits<16> {
  uint4 u;
  unsigned short h[8];
  float f[4];
};
template <> union Bits<8> {
  uint2 u;
  unsigned short h[4];
  float f[2];
};
template <> union Bits<4> {
  unsigned int u;
  unsigned short h[2];
  float f[1];
};
template <> union Bits<2> {
  unsigned short u;
  unsigned short h[1];
};

template <bool BF, int VB>
struct Vec {
  static constexpr int V = VB / (BF ? 2 : 4);
  Bits<VB> b;
  __device__ __forceinline__ float get(int k) const {
    if constexpr (BF) return __uint_as_float((unsigned int)b.h[k] << 16);
    else return b.f[k];
  }
  // Rounds y to the element type (bf16: two at a time, to nearest even).
  __device__ __forceinline__ void set_all(const float (&y)[V]) {
    if constexpr (BF) {
      if constexpr (V == 1) {
        b.h[0] = __bfloat16_as_ushort(__float2bfloat16(y[0]));
      } else {
#pragma unroll
        for (int k = 0; k < V; k += 2) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(y[k], y[k + 1]);
          b.h[k] = __bfloat16_as_ushort(p.x);
          b.h[k + 1] = __bfloat16_as_ushort(p.y);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) b.f[k] = y[k];
    }
  }
  __device__ __forceinline__ void load(const void* p) {
    b.u = *reinterpret_cast<const decltype(b.u)*>(p);
  }
  __device__ __forceinline__ void store(void* p) const {
    *reinterpret_cast<decltype(b.u)*>(p) = b.u;
  }
};

struct GnArgs {
  const void* x;
  const float* tb;
  const float* gamma;
  const float* beta;
  const void* dy;          // K2
  void* out;               // K1: out; K2: dx
  float* dgamma;           // K2
  float* dbeta;            // K2
  float* dtb;              // K2, null without a time bias
  float* scratch;          // K2: f32 [2, B + teams, C]
  unsigned int* tickets;   // K2: [1 + teams], 0 between calls
  int B, S, C, G;
  float eps;
  int silu;
  int cluster;             // blocks per sample, along its rows
  int csplit;              // blocks per sample, along C (whole groups)
  int spb;                 // samples per block (per cluster)
  int rows;                // rows of a sample per block
  int keep;                // kReread, kShared or kRegisters
  int team;                // K2: samples a team (a multiple of spb)
};

// Shared memory: u64 bars[kChunks] | f32 red[2][R*C] | pub[npub][C] |
// tot[2][C] | misc[4], rounded up to 16 bytes, then the slab (x, then dy
// in K2). gn_launch_plan computes the same size.
__host__ __device__ inline int smem_floats(int T, int V, int C, int npub) {
  return 2 * kChunks + 2 * T * V + npub * C + 2 * C + 4;
}
__host__ __device__ inline int slab_offset(int T, int V, int C, int npub) {
  return (4 * smem_floats(T, V, C, npub) + 15) / 16 * 16;
}
constexpr int kPubFwd = 2;   // v, v^2
constexpr int kPubBwd = 6;   // v, v^2 | dz*xhat, dz | dx | gamma

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase `parity` has completed. A wait of more
// than 2^34 cycles (about 9 s) traps, so a lost copy fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = -1;
  do {
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The bulk-copy chunks of a block's nvec vectors: n chunks of len vectors
// (a multiple of T, so a thread's vectors split cleanly), the last shorter.
struct Chunks {
  int n, len;
};
__device__ __forceinline__ Chunks chunks_of(bool bulk, int nvec, int T) {
  if (!bulk) return {1, nvec};
  const int rounds = (nvec + T - 1) / T;
  const int n = min(kChunks, rounds);
  return {n, (rounds + n - 1) / n * T};
}

// Thread 0 starts the copy of chunk k of each source (src0 into dst0 and,
// when src1 is not null, src1 into dst1) on barrier bars[k].
__device__ __forceinline__ void bulk_start(uint64_t* bars, Chunks ch,
                                           int nvec, int VB,
                                           const unsigned char* src0,
                                           unsigned char* dst0,
                                           const unsigned char* src1,
                                           unsigned char* dst1) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int k = 0; k < ch.n; ++k) {
    const int lo = k * ch.len, hi = min(nvec, lo + ch.len);
    const uint32_t bytes = (uint32_t)(hi - lo) * VB;
    const uint32_t bar = smem_addr(bars + k);
    mbar_expect_tx(bar, src1 ? 2 * bytes : bytes);
    bulk_g2s(dst0 + (long long)lo * VB, src0 + (long long)lo * VB, bytes,
             bar);
    if (src1)
      bulk_g2s(dst1 + (long long)lo * VB, src1 + (long long)lo * VB, bytes,
               bar);
  }
}

// V consecutive f32 values at p, as 16-byte loads where p allows.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + k);
        out[k] = q.x;
        out[k + 1] = q.y;
        out[k + 2] = q.z;
        out[k + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = p[k];
}

// out_q[c] = sum over the block's thread rows r = 0, 1, ..., R-1 (in that
// order) of the partials p_q of the thread (r, c / V), q < nq. The caller
// puts a block or cluster barrier after it before out is read, and one
// before it if out was read since the last barrier.
template <int V>
__device__ __forceinline__ void block_channel_sum(
    const float (&p0)[V], const float (&p1)[V], int nq, float* red,
    float* out0, float* out1, int C, int R, int trow, int c0) {
  if (R == 1) {   // one thread a channel: its partials are the sums
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out0[c0 + k] = p0[k];
      if (nq > 1) out1[c0 + k] = p1[k];
    }
    return;
  }
  float* r0 = red + trow * C + c0;
  float* r1 = red + (R + trow) * C + c0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    r0[k] = p0[k];
    if (nq > 1) r1[k] = p1[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < R; ++r) {
      a += red[r * C + c];
      if (nq > 1) b += red[(R + r) * C + c];
    }
    out0[c] = a;
    if (nq > 1) out1[c] = b;
  }
  __syncthreads();   // red is free again
}

// tot_q[c] = sum over the cluster's ranks 0, 1, ..., n-1 (in that order) of
// their pub_q[c]. After a cluster barrier that follows every rank's writes.
__device__ __forceinline__ void cluster_channel_sum(
    cg::cluster_group& cluster, float* pub0, float* pub1, int nq,
    float* tot0, float* tot1, int C, int n) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < n; ++r) {
      a += cluster.map_shared_rank(pub0, r)[c];
      if (nq > 1) b += cluster.map_shared_rank(pub1, r)[c];
    }
    tot0[c] = a;
    if (nq > 1) tot1[c] = b;
  }
}

// Sums of u0[j]*w[j] and u1[j]*w[j] (w null: 1) over one group's channels
// [gs, gs + cg), as four interleaved running sums added in a fixed order.
__device__ __forceinline__ void group_sum(const float* u0, const float* u1,
                                          const float* w, int gs, int cg_,
                                          float& s0, float& s1) {
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= cg_; j += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float m = w ? w[gs + j + q] : 1.f;
      a[q] += m * u0[gs + j + q];
      b[q] += m * u1[gs + j + q];
    }
  }
  for (; j < cg_; ++j) {
    const float m = w ? w[gs + j] : 1.f;
    a[0] += m * u0[gs + j];
    b[0] += m * u1[gs + j];
  }
  s0 = (a[0] + a[1]) + (a[2] + a[3]);
  s1 = (b[0] + b[1]) + (b[2] + b[3]);
}

// For each of the thread's channels c0 + k: the mean and rstd of its group
// from per-channel totals of v and v^2.
template <int V>
__device__ __forceinline__ void group_stats(const float* t0, const float* t1,
                                            int c0, int cg_, float n,
                                            float eps, float (&mean)[V],
                                            float (&rstd)[V]) {
  int gend = -1;
  float m = 0.f, r = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (c0 + k >= gend) {   // the first channel, or one of a new group
      const int gs = (c0 + k) / cg_ * cg_;
      gend = gs + cg_;
      float a, b;
      group_sum(t0, t1, nullptr, gs, cg_, a, b);
      m = a / n;
      r = rsqrtf(fmaxf(b / n - m * m, 0.f) + eps);
    }
    mean[k] = m;
    rstd[k] = r;
  }
}

// K2's s1/N and s2/N of the group of each of the thread's channels, from
// the per-channel totals pg = sum dz*xhat and pb = sum dz.
template <int V>
__device__ __forceinline__ void group_dsums(const float* pg, const float* pb,
                                            const float* gamma, int c0,
                                            int cg_, float n, float (&q1)[V],
                                            float (&q2)[V]) {
  int gend = -1;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (c0 + k >= gend) {
      const int gs = (c0 + k) / cg_ * cg_;
      gend = gs + cg_;
      group_sum(pb, pg, gamma, gs, cg_, s1, s2);
      s1 /= n;
      s2 /= n;
    }
    q1[k] = s1;
    q2[k] = s2;
  }
}

__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

__device__ __forceinline__ float grad_z(bool use_silu, float xhat, float dy,
                                        float gam, float bet) {
  if (!use_silu) return dy;
  const float z = gam * xhat + bet;
  const float sig = __fdividef(1.f, 1.f + __expf(-z));
  return dy * (sig * (1.f + z * (1.f - sig)));
}

// dst_q[c] = sum of rows r0 <= r < r1 of src_q (row stride C), in order: P
// runs of consecutive rows, then the runs in order; a thread takes W
// channels of a run (4 with 16-byte loads where C allows). P*C is at most
// cap, the floats of each half of red. Reads through L2 (other blocks wrote
// the rows).
template <int W>
__device__ void rows_sum(const float* src0, const float* src1, int r0,
                         int r1, float* dst0, float* dst1, int C, int cap,
                         float* red) {
  const int T = blockDim.x, n = r1 - r0, NQ = C / W;
  const int P = max(1, min(min(T / NQ, n), cap / C));
  const int run = (n + P - 1) / P;
  for (int w = threadIdx.x; w < P * NQ; w += T) {
    const int q = w % NQ, p = w / NQ;
    const int i1 = r0 + min(n, (p + 1) * run);
    float a[W], b[W];
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] = b[k] = 0.f;
#pragma unroll 8
    for (int i = r0 + p * run; i < i1; ++i) {
      const long long o = (long long)i * C + q * W;
      if constexpr (W == 4) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(src0 + o));
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src1 + o));
        a[0] += u.x; a[1] += u.y; a[2] += u.z; a[3] += u.w;
        b[0] += v.x; b[1] += v.y; b[2] += v.z; b[3] += v.w;
      } else {
        a[0] += __ldcg(src0 + o);
        b[0] += __ldcg(src1 + o);
      }
    }
    float* d0 = P == 1 ? dst0 : red + p * C;
    float* d1 = P == 1 ? dst1 : red + (P + p) * C;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      d0[q * W + k] = a[k];
      d1[q * W + k] = b[k];
    }
  }
  if (P == 1) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += T) {
    float a = 0.f, b = 0.f;
    for (int p = 0; p < P; ++p) {
      a += red[p * C + c];
      b += red[(P + p) * C + c];
    }
    dst0[c] = a;
    dst1[c] = b;
  }
}

template <bool BF, int VB, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_kernel(const GnArgs a) {
  using Vt = Vec<BF, VB>;
  constexpr int V = Vt::V;
  constexpr int ISZ = BF ? 2 : 4;
  constexpr int U = kUnrollFwd;
  extern __shared__ float4 smem_f4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_f4);
  float* red = reinterpret_cast<float*>(bars + kChunks);
  // The block takes channels [cb0, cb0 + Cb) of rows [r0, r1) of samples
  // first, first + 1, ...; CV vectors a row. Without SPLIT it takes whole
  // rows, so its vector i lies i*VB bytes past its first.
  const int csplit = SPLIT ? a.csplit : 1;
  const int C = a.C, Cb = C / csplit, cg_ = C / a.G, ncl = a.cluster;
  const int CV = Cb / V, T = blockDim.x, R = T / CV;
  const int col = threadIdx.x % CV, trow = threadIdx.x / CV, c0 = col * V;
  const int cid = blockIdx.x / ncl;
  const int cb0 = (cid % csplit) * Cb;
  const int first = (cid / csplit) * a.spb;
  const long long rstride = (long long)C * ISZ;
  const long long cofs = (long long)cb0 * ISZ + (long long)col * VB;
  auto gofs = [&](int i, int row) -> long long {   // vector i, on row `row`
    if constexpr (SPLIT) return row * rstride + cofs;
    else return (long long)i * VB;
  };
  float* pub = red + 2 * R * Cb;      // [2][Cb], with a cluster
  float* tot = pub + kPubFwd * Cb;    // [2][Cb]
  unsigned char* slab = reinterpret_cast<unsigned char*>(smem_f4) +
                        slab_offset(T, V, Cb, kPubFwd);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = ncl > 1 ? (int)cluster.block_rank() : 0;
  const int r0 = rank * a.rows, r1 = min(a.S, r0 + a.rows);
  const int nvec = max(0, r1 - r0) * CV;   // the block's vectors
  const bool regs = a.keep == kRegisters;
  const bool bulk = VB == 16 && !SPLIT && a.keep == kShared && nvec > 0;
  const Chunks ch = chunks_of(bulk, nvec, T);
  const float n = (float)a.S * (float)cg_;
  const int count = min(a.spb, a.B - first);
  if (bulk && threadIdx.x == 0) {
    for (int k = 0; k < kChunks; ++k) mbar_init(smem_addr(bars + k));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float gam[V], bet[V];
  load_f32<V>(a.gamma + cb0 + c0, gam);
  load_f32<V>(a.beta + cb0 + c0, bet);
  if (bulk) __syncthreads();   // the barriers are initialised

  Vt v[U];   // the block's vectors, on the registers path
  for (int j = 0; j < count; ++j) {
    const int b = first + j;
    const long long base = ((long long)b * a.S + r0) * rstride;   // row r0
    const unsigned char* xs = static_cast<const unsigned char*>(a.x) + base;
    unsigned char* os = static_cast<unsigned char*>(a.out) + base;
    if (bulk && threadIdx.x == 0)
      bulk_start(bars, ch, nvec, VB, xs, slab, nullptr, nullptr);
    float tbv[V];
    if (a.tb) {
      load_f32<V>(a.tb + (long long)b * C + cb0 + c0, tbv);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) tbv[k] = 0.f;
    }

    // Pass 1: x once from HBM (into registers or shared memory), per-
    // channel sums of v and v^2, chunk by chunk.
    float s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
    for (int kc = 0; kc < ch.n; ++kc) {
      const int hi = min(nvec, (kc + 1) * ch.len);
      if (bulk) mbar_wait(smem_addr(bars + kc), j & 1);
      for (int i0 = kc * ch.len + threadIdx.x, rw = trow + kc * ch.len / CV;
           i0 < hi; i0 += T * U, rw += R * U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          if (i < hi)
            v[u].load(bulk ? slab + (long long)i * VB
                           : xs + gofs(i, rw + u * R));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          if (i < hi) {
            if (a.keep == kShared && !bulk)
              v[u].store(slab + (long long)i * VB);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float t = v[u].get(k) + tbv[k];
              s1[k] += t;
              s2[k] += t * t;
            }
          }
        }
      }
    }
    // (A cluster takes one sample, so pub is written once.)
    block_channel_sum<V>(s1, s2, 2, red, ncl > 1 ? pub : tot,
                         ncl > 1 ? pub + Cb : tot + Cb, Cb, R, trow, c0);
    if (ncl > 1) {
      cluster.sync();
      cluster_channel_sum(cluster, pub, pub + Cb, 2, tot, tot + Cb, Cb, ncl);
    }
    __syncthreads();
    float sa[V], sb[V];
    group_stats<V>(tot, tot + Cb, c0, cg_, n, a.eps, sa, sb);
#pragma unroll
    for (int k = 0; k < V; ++k) {   // (mean, rstd) -> (a, b)
      const float mean = sa[k];
      sa[k] = sb[k] * gam[k];
      sb[k] = bet[k] + (tbv[k] - mean) * sa[k];
    }

    // Pass 2: out = x*a + b (+SiLU), x from registers, shared memory, or
    // again from L2/HBM.
    for (int i0 = threadIdx.x, rw = trow; i0 < nvec;
         i0 += T * U, rw += R * U) {
      if (!regs) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          if (i < nvec)
            v[u].load(a.keep == kShared ? slab + (long long)i * VB
                                        : xs + gofs(i, rw + u * R));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * T;
        if (i < nvec) {
          float y[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            y[k] = v[u].get(k) * sa[k] + sb[k];
            if (a.silu) y[k] = silu(y[k]);
          }
          Vt o;
          o.set_all(y);
          o.store(os + gofs(i, rw + u * R));
        }
      }
    }
    if (j + 1 < count) __syncthreads();   // tot and the slab are reused
  }
  if (ncl > 1) cluster.sync();   // no block leaves while another reads it
}

template <bool BF, int VB, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_kernel(const GnArgs a) {
  using Vt = Vec<BF, VB>;
  constexpr int V = Vt::V;
  constexpr int ISZ = BF ? 2 : 4;
  constexpr int U = kUnrollBwd;
  extern __shared__ float4 smem_f4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_f4);
  float* red = reinterpret_cast<float*>(bars + kChunks);
  // The block takes channels [cb0, cb0 + Cb) of rows [r0, r1) of samples
  // first, first + 1, ...; CV vectors a row. Without SPLIT it takes whole
  // rows, so its vector i lies i*VB bytes past its first.
  const int csplit = SPLIT ? a.csplit : 1;
  const int C = a.C, Cb = C / csplit, cg_ = C / a.G, ncl = a.cluster;
  const int CV = Cb / V, T = blockDim.x, R = T / CV;
  const int col = threadIdx.x % CV, trow = threadIdx.x / CV, c0 = col * V;
  const int cid = blockIdx.x / ncl;
  const int cb0 = (cid % csplit) * Cb;
  const int first = (cid / csplit) * a.spb;
  const long long rstride = (long long)C * ISZ;
  const long long cofs = (long long)cb0 * ISZ + (long long)col * VB;
  auto gofs = [&](int i, int row) -> long long {   // vector i, on row `row`
    if constexpr (SPLIT) return row * rstride + cofs;
    else return (long long)i * VB;
  };
  float* pub = red + 2 * R * Cb;      // [5][Cb]: v, v^2 | dz*xhat, dz | dx
  float* gsm = pub + 5 * Cb;          // gamma [Cb]
  float* tot = gsm + Cb;              // [2][Cb]
  int* misc = reinterpret_cast<int*>(tot + 2 * Cb);
  unsigned char* slab = reinterpret_cast<unsigned char*>(smem_f4) +
                        slab_offset(T, V, Cb, kPubBwd);
  const long long plane = (long long)a.rows * Cb * ISZ;   // x, then dy
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = ncl > 1 ? (int)cluster.block_rank() : 0;
  const int r0 = rank * a.rows, r1 = min(a.S, r0 + a.rows);
  const int nvec = max(0, r1 - r0) * CV;   // the block's vectors
  const bool regs = a.keep == kRegisters;
  const bool bulk = VB == 16 && !SPLIT && a.keep == kShared && nvec > 0;
  const Chunks ch = chunks_of(bulk, nvec, T);
  const float n = (float)a.S * (float)cg_;
  const bool use_silu = a.silu != 0;
  const int teams = (a.B + a.team - 1) / a.team;
  float* part_g = a.scratch;                               // [B + teams][C]
  float* part_b = a.scratch + (long long)(a.B + teams) * C;
  const int count = min(a.spb, a.B - first);
  if (bulk && threadIdx.x == 0) {
    for (int k = 0; k < kChunks; ++k) mbar_init(smem_addr(bars + k));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float gam[V], bet[V];
  load_f32<V>(a.gamma + cb0 + c0, gam);
  load_f32<V>(a.beta + cb0 + c0, bet);
  for (int c = threadIdx.x; c < Cb; c += T) gsm[c] = a.gamma[cb0 + c];
  if (bulk) __syncthreads();   // the barriers are initialised; gsm is read
                               // after later barriers

  Vt v[U], d[U];   // the block's vectors, on the registers path
  for (int j = 0; j < count; ++j) {
    const int b = first + j;
    const long long base = ((long long)b * a.S + r0) * rstride;   // row r0
    const unsigned char* xs = static_cast<const unsigned char*>(a.x) + base;
    const unsigned char* dys = static_cast<const unsigned char*>(a.dy) + base;
    unsigned char* dxs = static_cast<unsigned char*>(a.out) + base;
    unsigned char* bx = slab;
    unsigned char* bdy = slab + plane;
    if (bulk && threadIdx.x == 0)
      bulk_start(bars, ch, nvec, VB, xs, bx, dys, bdy);
    float tbv[V];
    if (a.tb) {
      load_f32<V>(a.tb + (long long)b * C + cb0 + c0, tbv);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) tbv[k] = 0.f;
    }

    // Pass A: x and dy once from HBM (into registers or shared memory),
    // per-channel sums of v and v^2, chunk by chunk.
    float p0[V], p1[V];
#pragma unroll
    for (int k = 0; k < V; ++k) p0[k] = p1[k] = 0.f;
    for (int kc = 0; kc < ch.n; ++kc) {
      const int hi = min(nvec, (kc + 1) * ch.len);
      if (bulk) mbar_wait(smem_addr(bars + kc), j & 1);
      for (int i0 = kc * ch.len + threadIdx.x, rw = trow + kc * ch.len / CV;
           i0 < hi; i0 += T * U, rw += R * U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          const long long g = gofs(i, rw + u * R);
          if (i < hi) {
            v[u].load(bulk ? bx + (long long)i * VB : xs + g);
            if (!bulk && a.keep != kReread) d[u].load(dys + g);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          if (i < hi) {
            if (a.keep == kShared && !bulk) {
              v[u].store(bx + (long long)i * VB);
              d[u].store(bdy + (long long)i * VB);
            }
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float t = v[u].get(k) + tbv[k];
              p0[k] += t;
              p1[k] += t * t;
            }
          }
        }
      }
    }
    block_channel_sum<V>(p0, p1, 2, red, ncl > 1 ? pub : tot,
                         ncl > 1 ? pub + Cb : tot + Cb, Cb, R, trow, c0);
    if (ncl > 1) {
      cluster.sync();
      cluster_channel_sum(cluster, pub, pub + Cb, 2, tot, tot + Cb, Cb, ncl);
    }
    __syncthreads();
    float mu[V], rs[V];
    group_stats<V>(tot, tot + Cb, c0, cg_, n, a.eps, mu, rs);
#pragma unroll
    for (int k = 0; k < V; ++k) mu[k] -= tbv[k];   // xhat = (x - mu) * rs
    __syncthreads();   // tot is written again below

    // Pass B: per-channel sums of dz*xhat and dz.
    const unsigned char* sx = a.keep == kShared ? bx : xs;
    const unsigned char* sdy = a.keep == kShared ? bdy : dys;
#pragma unroll
    for (int k = 0; k < V; ++k) p0[k] = p1[k] = 0.f;
    for (int i0 = threadIdx.x, rw = trow; i0 < nvec;
         i0 += T * U, rw += R * U) {
      if (!regs) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          const long long o =
              a.keep == kShared ? (long long)i * VB : gofs(i, rw + u * R);
          if (i < nvec) {
            v[u].load(sx + o);
            d[u].load(sdy + o);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * T;
        if (i < nvec) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xh = (v[u].get(k) - mu[k]) * rs[k];
            const float dz = grad_z(use_silu, xh, d[u].get(k), gam[k],
                                    bet[k]);
            p0[k] += dz * xh;
            p1[k] += dz;
          }
        }
      }
    }
    block_channel_sum<V>(p0, p1, 2, red, ncl > 1 ? pub + 2 * Cb : tot,
                         ncl > 1 ? pub + 3 * Cb : tot + Cb, Cb, R, trow, c0);
    if (ncl > 1) {
      cluster.sync();
      cluster_channel_sum(cluster, pub + 2 * Cb, pub + 3 * Cb, 2, tot,
                          tot + Cb, Cb, ncl);
    }
    __syncthreads();
    if (rank == 0)
      for (int c = threadIdx.x; c < Cb; c += T) {
        part_g[(long long)b * C + cb0 + c] = tot[c];
        part_b[(long long)b * C + cb0 + c] = tot[Cb + c];
      }
    float q1[V], q2[V];
    group_dsums<V>(tot, tot + Cb, gsm, c0, cg_, n, q1, q2);

    // Pass C: dx, and per-channel sums of dx for dtb.
#pragma unroll
    for (int k = 0; k < V; ++k) p0[k] = 0.f;
    for (int i0 = threadIdx.x, rw = trow; i0 < nvec;
         i0 += T * U, rw += R * U) {
      if (!regs) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * T;
          const long long o =
              a.keep == kShared ? (long long)i * VB : gofs(i, rw + u * R);
          if (i < nvec) {
            v[u].load(sx + o);
            d[u].load(sdy + o);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * T;
        if (i < nvec) {
          float y[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xh = (v[u].get(k) - mu[k]) * rs[k];
            const float dz = grad_z(use_silu, xh, d[u].get(k), gam[k],
                                    bet[k]);
            y[k] = rs[k] * (dz * gam[k] - (q1[k] + xh * q2[k]));
            p0[k] += y[k];
          }
          Vt o;
          o.set_all(y);
          o.store(dxs + gofs(i, rw + u * R));
        }
      }
    }
    if (a.dtb) {
      float* dtb = a.dtb + (long long)b * C + cb0;
      if (ncl > 1) {
        block_channel_sum<V>(p0, p0, 1, red, pub + 4 * Cb, nullptr, Cb, R,
                             trow, c0);
        cluster.sync();
        if (rank == 0)
          cluster_channel_sum(cluster, pub + 4 * Cb, nullptr, 1, dtb,
                              nullptr, Cb, ncl);
      } else {
        block_channel_sum<V>(p0, p0, 1, red, dtb, nullptr, Cb, R, trow, c0);
      }
    }
    if (j + 1 < count) __syncthreads();   // tot and the slabs are reused
  }

  // dgamma, dbeta: the last writer of each team sums its rows; the last
  // team's finisher sums the team rows.
  if (rank == 0) {
    const int team = first / a.team;
    const int t0 = team * a.team, t1 = min(a.B, t0 + a.team);
    const unsigned int writers = (t1 - t0 + a.spb - 1) / a.spb * csplit;
    const bool quads = C % 4 == 0;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      misc[0] = atomicAdd(a.tickets + 1 + team, 1u) == writers - 1;
    __syncthreads();
    if (misc[0]) {
      __threadfence();
      float* tg = part_g + (long long)(a.B + team) * C;
      float* tbb = part_b + (long long)(a.B + team) * C;
      if (quads)
        rows_sum<4>(part_g, part_b, t0, t1, tg, tbb, C, R * Cb, red);
      else
        rows_sum<1>(part_g, part_b, t0, t1, tg, tbb, C, R * Cb, red);
      if (threadIdx.x == 0) a.tickets[1 + team] = 0u;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        misc[1] = atomicAdd(a.tickets, 1u) == (unsigned int)teams - 1;
      __syncthreads();
      if (misc[1]) {
        __threadfence();
        if (quads)
          rows_sum<4>(part_g, part_b, a.B, a.B + teams, a.dgamma, a.dbeta, C,
                      R * Cb, red);
        else
          rows_sum<1>(part_g, part_b, a.B, a.B + teams, a.dgamma, a.dbeta, C,
                      R * Cb, red);
        if (threadIdx.x == 0) a.tickets[0] = 0u;
      }
    }
  }
  if (ncl > 1) cluster.sync();   // no block leaves while another reads it
}

using KernelFn = void (*)(GnArgs);

// K1 splits C (SPLIT) only on the registers path; K2 never does.
template <bool BWD, bool BF, int VB>
KernelFn kernel_for(bool split) {
  if constexpr (BWD) return split ? nullptr : gn_bwd_kernel<BF, VB, false>;
  else
    return split ? gn_fwd_kernel<BF, VB, true> : gn_fwd_kernel<BF, VB, false>;
}

template <bool BWD>
KernelFn pick(int is_bf16, int vec_bytes, bool split) {
  if (is_bf16) {
    switch (vec_bytes) {
      case 16: return kernel_for<BWD, true, 16>(split);
      case 8: return kernel_for<BWD, true, 8>(split);
      case 4: return kernel_for<BWD, true, 4>(split);
      case 2: return kernel_for<BWD, true, 2>(split);
    }
  } else {
    switch (vec_bytes) {
      case 16: return kernel_for<BWD, false, 16>(split);
      case 8: return kernel_for<BWD, false, 8>(split);
      case 4: return kernel_for<BWD, false, 4>(split);
    }
  }
  return nullptr;
}

// Checks the plan against the shape (ops/group_norm.py::gn_launch_plan made
// it) and launches: grid = cluster * csplit * ceil(B / spb) blocks of
// `threads`.
template <bool BWD>
int launch(GnArgs& a, int is_bf16, int vec_bytes, int threads, int smem,
           void* stream) {
  const int isz = is_bf16 ? 2 : 4;
  const int V = vec_bytes / isz;
  const KernelFn kern = pick<BWD>(is_bf16, vec_bytes, a.csplit > 1);
  if (!kern || a.B <= 0 || a.S <= 0 || a.G <= 0 || a.C % a.G != 0 ||
      a.csplit < 1 || a.C % a.csplit != 0 ||
      (a.csplit > 1 && (a.keep != kRegisters || a.cluster != 1)) ||
      (a.cluster > 1 && a.spb != 1))
    return (int)cudaErrorInvalidValue;
  const int Cb = a.C / a.csplit;
  if (Cb % V != 0 || Cb % (a.C / a.G) != 0 || threads <= 0 ||
      threads > kMaxThreads || threads % (Cb / V) != 0 || a.cluster < 1 ||
      a.cluster > kMaxCluster ||
      a.spb < 1 || a.rows <= 0 || (long long)a.rows * a.cluster < a.S ||
      a.keep < kReread || a.keep > kRegisters || smem > kMaxSmem ||
      (BWD && (a.team < a.spb || a.team % a.spb != 0)))
    return (int)cudaErrorInvalidValue;
  const int U = BWD ? kUnrollBwd : kUnrollFwd;
  if (a.keep == kRegisters && a.rows * (Cb / V) > threads * U)
    return (int)cudaErrorInvalidValue;
  long long need = slab_offset(threads, V, Cb, BWD ? kPubBwd : kPubFwd);
  if (a.keep == kShared) need += (long long)a.rows * Cb * isz * (BWD ? 2 : 1);
  if (smem < need) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster * a.csplit * ((a.B + a.spb - 1) / a.spb));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---- K1's split form (spatial parallelism) -------------------------------
// Each image's rows are split over the ranks of a spatial group, so a
// rank's call holds S of its rows. Entry (a) sums, per (sample, channel),
// v = x + tb over those rows, with the time bias folded in at the rank's own
// row count as the plain twin (ops/group_norm.py::gn_partial_sums_plain)
// folds it:
//   sums[b][0][c] = Sx + S*tb,  sums[b][1][c] = Sxx + 2*tb*Sx + S*tb*tb
// (f32 [B, 2, C]); summed over the group, the folds give the whole image's.
// The group all-reduces the sums between the two launches. Entry (b) forms
// each group's statistics from the summed sums (n = whole rows * W * C/G),
// a = rstd*gamma, b = beta + (tb - mean)*a, and applies x*a + b (+SiLU) in
// f32, stored in x's dtype, as K1 does.
// Bound: memory. (a) reads x once and writes [B, 2, C]; (b) reads x and
// writes out once.
// Design: simple and deterministic. (a): a block takes 32 channels of one
// sample (a warp reads 32 consecutive channels of a row) with 16 thread
// rows walking the sample's rows; the 16 partials of a channel are summed
// in a fixed order. (b): a block forms a and b for all C channels of its
// sample in shared memory, then walks its run of rows element by element.

constexpr int kSumCols = 32;        // channels a block of (a)
constexpr int kSumRows = 16;        // thread rows of a block of (a)
constexpr int kApplyThreads = 256;  // threads a block of (b)
constexpr int kApplyElems = 2048;   // about this many elements a block of (b)

template <bool BF>
__device__ __forceinline__ float load_elem(const void* p, long long i) {
  if constexpr (BF)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

template <bool BF>
__device__ __forceinline__ void store_elem(void* p, long long i, float y) {
  if constexpr (BF)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(y);
  else
    reinterpret_cast<float*>(p)[i] = y;
}

template <bool BF>
__global__ void __launch_bounds__(kSumCols* kSumRows)
    gn_partial_sums_kernel(const void* x, const float* tb, float* sums, int S,
                           int C) {
  __shared__ float red[2][kSumRows][kSumCols];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + tx;
  const int b = blockIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const long long base = (long long)b * S * C + c;
    for (int s = ty; s < S; s += kSumRows) {
      const float v = load_elem<BF>(x, base + (long long)s * C);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  red[0][ty][tx] = s1;
  red[1][ty][tx] = s2;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  float t1 = 0.f, t2 = 0.f;
  for (int r = 0; r < kSumRows; ++r) {
    t1 += red[0][r][tx];
    t2 += red[1][r][tx];
  }
  if (tb) {
    const float t = tb[(long long)b * C + c], hw = (float)S;
    t2 = __fadd_rn(__fadd_rn(t2, __fmul_rn(__fmul_rn(2.f, t), t1)),
                   __fmul_rn(__fmul_rn(hw, t), t));
    t1 = __fadd_rn(t1, __fmul_rn(hw, t));
  }
  sums[(long long)b * 2 * C + c] = t1;
  sums[((long long)b * 2 + 1) * C + c] = t2;
}

template <bool BF>
__global__ void __launch_bounds__(kApplyThreads)
    gn_apply_sums_kernel(const void* x, const float* sums, const float* tb,
                         const float* gamma, const float* beta, void* out,
                         int S, int C, int G, float n, float eps, int use_silu,
                         int rows_per_block) {
  extern __shared__ float ab[];   // a[C] | b[C]
  const int b = blockIdx.y;
  const int cg = C / G;
  const float* sb = sums + (long long)b * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g0 = c / cg * cg;
    float gs = 0.f, gq = 0.f;
    for (int j = 0; j < cg; ++j) {
      gs += sb[g0 + j];
      gq += sb[C + g0 + j];
    }
    const float mean = __fdiv_rn(gs, n);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(gq, n), __fmul_rn(mean, mean)), 0.f);
    const float a = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), gamma[c]);
    float bb = __fsub_rn(beta[c], __fmul_rn(mean, a));
    if (tb) bb = __fadd_rn(bb, __fmul_rn(tb[(long long)b * C + c], a));
    ab[c] = a;
    ab[C + c] = bb;
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * rows_per_block * C;
  const long long end = (long long)(blockIdx.x + 1) * rows_per_block;
  const long long hi = (end < S ? end : (long long)S) * C;
  const long long base = (long long)b * S * C;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int c = (int)(i % C);
    float y = fmaf(load_elem<BF>(x, base + i), ab[c], ab[C + c]);
    if (use_silu) y = silu(y);
    store_elem<BF>(out, base + i, y);
  }
}

}  // namespace

// K1. The eight arguments before the stream are gn_launch_plan's: bytes per
// vector, threads per block, blocks per sample along its rows (a cluster)
// and along C, samples per block (per cluster), rows of a sample per block,
// where a block keeps its rows between passes (0: read again, 1: shared
// memory, 2: registers), and dynamic shared memory bytes.
extern "C" int dmu_group_norm_silu_fwd(const void* x, const float* tb,
                                       const float* gamma, const float* beta,
                                       void* out, int B, int S, int C, int G,
                                       float eps, int apply_silu, int is_bf16,
                                       int vec_bytes, int threads,
                                       int cluster, int channel_blocks,
                                       int samples_per_block,
                                       int rows_per_block, int keep,
                                       int smem_bytes, void* stream) {
  GnArgs a = {};
  a.x = x;
  a.tb = tb;
  a.gamma = gamma;
  a.beta = beta;
  a.out = out;
  a.B = B;
  a.S = S;
  a.C = C;
  a.G = G;
  a.eps = eps;
  a.silu = apply_silu;
  a.cluster = cluster;
  a.csplit = channel_blocks;
  a.spb = samples_per_block;
  a.rows = rows_per_block;
  a.keep = keep;
  a.team = samples_per_block;
  return launch<false>(a, is_bf16, vec_bytes, threads, smem_bytes, stream);
}

// K2: dx (x's dtype), dgamma and dbeta (f32 [C]) and, when dtb is not null,
// dtb (f32 [B, C]). With teams = ceil(B / team): scratch is f32
// [2, B + teams, C]; tickets is [1 + teams] unsigned ints, 0 before the
// call and again after it. Plan arguments as for K1, then the team size.
extern "C" int dmu_group_norm_silu_bwd(
    const void* x, const float* tb, const float* gamma, const float* beta,
    const void* dy, void* dx, float* dgamma, float* dbeta, float* dtb,
    float* scratch, unsigned int* tickets, int B, int S, int C, int G,
    float eps, int apply_silu, int is_bf16, int vec_bytes, int threads,
    int cluster, int channel_blocks, int samples_per_block,
    int rows_per_block, int keep, int smem_bytes, int team, void* stream) {
  GnArgs a = {};
  a.x = x;
  a.tb = tb;
  a.gamma = gamma;
  a.beta = beta;
  a.dy = dy;
  a.out = dx;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.dtb = dtb;
  a.scratch = scratch;
  a.tickets = tickets;
  a.B = B;
  a.S = S;
  a.C = C;
  a.G = G;
  a.eps = eps;
  a.silu = apply_silu;
  a.cluster = cluster;
  a.csplit = channel_blocks;
  a.spb = samples_per_block;
  a.rows = rows_per_block;
  a.keep = keep;
  a.team = team;
  return launch<true>(a, is_bf16, vec_bytes, threads, smem_bytes, stream);
}

// K1's split form, (a): sums (f32 [B, 2, C]) of x [B, S, C] (f32 or bf16)
// over its S rows, tb (f32 [B, C] or null) folded in at S.
extern "C" int dmu_group_norm_partial_sums(const void* x, const float* tb,
                                           float* sums, int B, int S, int C,
                                           int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kSumCols - 1) / kSumCols, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    gn_partial_sums_kernel<true><<<grid, kSumCols * kSumRows, 0, st>>>(
        x, tb, sums, S, C);
  else
    gn_partial_sums_kernel<false><<<grid, kSumCols * kSumRows, 0, st>>>(
        x, tb, sums, S, C);
  return (int)cudaGetLastError();
}

// K1's split form, (b): out = x*a + b (+SiLU) of x [B, S, C] with a and b
// from the group's summed sums (f32 [B, 2, C]) over n elements a group
// (whole rows * W * C/G), gamma and beta (f32 [C]) and tb (f32 [B, C] or
// null).
extern "C" int dmu_group_norm_apply_sums(const void* x, const float* sums,
                                         const float* tb, const float* gamma,
                                         const float* beta, void* out, int B,
                                         int S, int C, int G, float n,
                                         float eps, int apply_silu,
                                         int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || n <= 0.f ||
      2LL * C * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int rows = kApplyElems / C > 0 ? kApplyElems / C : 1;
  const dim3 grid((S + rows - 1) / rows, B);
  const size_t smem = 2 * (size_t)C * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    gn_apply_sums_kernel<true><<<grid, kApplyThreads, smem, st>>>(
        x, sums, tb, gamma, beta, out, S, C, G, n, eps, apply_silu, rows);
  else
    gn_apply_sums_kernel<false><<<grid, kApplyThreads, smem, st>>>(
        x, sums, tb, gamma, beta, out, S, C, G, n, eps, apply_silu, rows);
  return (int)cudaGetLastError();
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
