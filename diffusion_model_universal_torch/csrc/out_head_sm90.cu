// The UNet's output head for Hopper, kernel K6's sm90 route: GroupNorm
// statistics, scale/bias, SiLU and a 3x3 SAME conv C -> Cout in one kernel,
// bf16 NHWC x, the products on the tensor cores.
//
// Replaces the TPU kernel `_kernel_out_head` (scripts/exp_boundary_kernel.py
// :54, launched by `out_head_pallas` at :83) for bf16 x with C a multiple of
// 64 (up to 2048), Cout from 1 to 7, and a sample whose band of rows fits a
// block of a cluster of at most 8 (ops/boundary_conv.py::out_head_route
// picks this route; csrc/boundary_conv.cu's CUDA-core kernel keeps f32 and
// every other bf16 shape). The math is the reference's:
//   per (sample, group): mean = E[x], var = max(E[x^2] - mean^2, 0) in f32
//   (sums over H*W*C/G), rstd = rsqrt(var + eps)
//   a = rstd * scale, b = bias - mean * a              (f32, per channel)
//   y = silu(x * a + b), rounded once to bf16 (the Pallas body feeds bf16 y
//   to its MXU product)
//   out = conv3x3(y, w), y = 0 outside the image, accumulated in f32.
//
// What bounds it on an H100: bytes. It must read x once and write out once:
// 537 MB + 12.6 MB at the bench shape (B=2048, 32x32, C=128, Cout=3, bf16),
// 0.164 ms at 3.35 TB/s. The conv is 17 GFLOP there, about 0.02 ms of
// tensor time; SiLU is one special-function op an element (268 M elements,
// about 0.07 ms at 16 a clock an SM), the next floor. What keeps a kernel of
// this shape from its bound is latency: a sample's statistics must be
// complete before any of it can be activated, so a block that reads a band,
// waits for its cluster and then computes leaves HBM idle in between.
//
// Design (ops/boundary_conv.py::out_head_launch_plan chooses every number
// below and passes it whole; the C entry checks it and computes none of its
// own, except how many clusters the card holds at once, which it takes from
// cudaOccupancyMaxActiveClusters; tests/test_torch_out_head_plan.py
// emulates the partition in numpy):
// - Persistent clusters, one read of x, statistics on chip (K1's residency,
//   csrc/group_norm.cu). A thread block cluster of `cluster` blocks takes a
//   sample at a time, as many clusters as fit the card walking the batch;
//   rank r holds the sample's band of image rows [r*rows, (r+1)*rows) in
//   one band buffer of shared memory, copied by 16-byte cp.async in one
//   commit group. The copy of the cluster's next sample starts as soon as
//   the product has read the band, under the halo writes and the next
//   barrier; the other resident blocks of the SM keep HBM busy meanwhile.
//   Each thread copies the same 8 channels of every pixel it copies
//   (threads are a multiple of C/8) and sums exactly those in f32 once they
//   land, so no block barrier sits between copy and sum. Per-channel partials are summed over the block's
//   thread rows in shared memory and published; after the cluster barrier
//   every block sums all ranks' partials through distributed shared memory
//   in rank order (all ranks' loads in flight at once), so every block
//   holds the same totals and the same a, b.
// - One cluster barrier a sample. The 3x3 sum of a sample needs the rows of
//   P next to the band from the neighbouring ranks; rather than a second
//   barrier, it is deferred to just after the next sample's barrier (a
//   variant that summed the rows needing no halo between arriving at that
//   barrier and waiting on it was slower). A block writes the taps its
//   neighbours need of its first and last rows of P (3*Cout values a
//   pixel) into their halo rows through distributed shared memory (stores,
//   on which nothing waits), one halo for each of two samples, so the 3x3
//   sum reads only its own shared memory and its next product may
//   overwrite P; the published sums are kept for two samples for the same
//   reason. The last sample's sum follows a barrier of its own, after which
//   no block touches another's shared memory.
// - The conv on the tensor cores with the taps as columns. Cout = 3 is too
//   narrow for an MMA, 9 taps x Cout is not: P = y . Wt with Wt [C, 9*Cout]
//   padded to `columns` = 16, 32 or 64 (the wrapper packs its transpose,
//   K-major, pack_out_head_weight). mma.sync m16n8k16, bf16 in, f32
//   accumulators, over the band's pixels taken 16 at a time as rows of A
//   (32 where every warp still gets a group: `mtiles`), whatever the image
//   width (W = 28 fills no m16 tile evenly; P is per pixel, geometry comes
//   only in the 3x3 sum). A fragments come from the band by ldmatrix and
//   are activated in registers: unpack, h = x*a/2 + b/2, y = h + h*tanh(h)
//   (= silu(x*a + b)), round, repack; each element is activated once. B
//   fragments come from the weight copy in shared memory by ldmatrix. Both
//   tiles are stored with a 128-byte XOR swizzle of their 16-byte vectors,
//   so ldmatrix meets no bank conflict.
// - The 3x3 sum. out[r, c, k] = sum_{dy, dx} P[r+dy, c+dx, tap(dy,dx)*Cout
//   + k], P = 0 outside the image (the halo is 0 after SiLU, as in K4).
//   P is f32 in shared memory, column-major with a stride of 4 (mod 32)
//   pixels, so both the accumulators' stores and the sum's reads are free
//   of bank conflicts; its padded columns past 9*Cout are not kept.
//   Consecutive threads write consecutive outputs, contiguous in NHWC. No
//   atomics: the result is reproducible.
// - SiLU in one special-function op: sigmoid(z) = 0.5 * tanh.approx(0.5*z)
//   + 0.5. PTX states tanh.approx.f32's relative error as about 2^-11, so
//   the sigmoid is off by at most 2^-12 * |tanh| absolute and y by
//   |z| * 2^-12: for z >= 0 that is at most 1/8 of bf16's rounding of y (a
//   relative 2^-8), and it reaches bf16's rounding only near z = -2.7,
//   where y is -0.17; below that y tends to 0 and the error stays under
//   |z| * 2^-12. (The exact expf and divide would be two ops, 0.145 ms.)
// - Occupancy. What is left is the latency of each sample's chain
//   (statistics, barrier, product, 3x3 sum), which resident blocks hide for
//   one another, so the plan takes the cut that keeps the most blocks on an
//   SM. At the bench shape: a cluster of 8, 4 rows and 128 threads a block,
//   one 32 KB band buffer, 8 KB of weight, 14 KB of P, 8 KB of partials,
//   2 KB of published sums, 4.5 KB of halo rows and 2 KB of affine, scale
//   and bias: 72,192 bytes, three blocks an SM (a second band buffer would
//   leave two). A bf16 sample whose band no 8-block cluster holds
//   (64x64x256 and up) takes the CUDA-core kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;   // out_head_launch_plan's SM90_MAX_THREADS
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxSmem = 232448;   // 227 KB a block can use
constexpr int kMaxC = 2048;
constexpr int kMaxCout = 7;

struct OhArgs {
  const bf16* x;         // [B, H, W, C]
  const float* scale;    // [C]
  const float* bias;     // [C]
  const bf16* wt;        // [columns, C], row tap*Cout + k, rows past 9*Cout 0
  bf16* out;             // [B, H, W, Cout]
  int B, H, W, C, G, cout;
  float eps;
  int cluster;           // blocks a cluster, which takes a sample at a time
  int rows;              // image rows a block
  int pstride;           // pixels a column of P
};

// Byte offsets of the shared-memory regions (ops/boundary_conv.py::
// out_head_sm90_smem_bytes computes the same total): the band buffer of
// `band` bytes at 0, the packed weight, P (f32, column-major, its 9*Cout
// columns), the statistics' partials (two per channel of each thread row;
// then the cluster's total sums, 2*C f32), the published sums of two
// samples (2 x 2*C f32), the halo rows of P of two samples (2 x 2 rows x W
// x 3*Cout f32), then the affine (a/2, b/2) and the scale and bias halved,
// 2*C f32 each. Every offset is a multiple of 128: C is a multiple of 64.
struct Layout {
  int band, wt, p, red, pub, edge, ab, sb, total;
};
__host__ __device__ inline int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}
__host__ __device__ inline Layout layout_of(int rows, int W, int C,
                                            int columns, int pstride, int T,
                                            int cout) {
  Layout L;
  L.band = rows * W * C * 2;
  L.wt = L.band;
  L.p = L.wt + columns * C * 2;
  L.red = L.p + round128(9 * cout * pstride * 4);
  L.pub = L.red + 2 * T * 8 * 4;   // T * 8 >= C: the totals fit too
  L.edge = L.pub + 2 * 2 * C * 4;
  L.ab = L.edge + round128(2 * 2 * W * 3 * cout * 4);
  L.sb = L.ab + 2 * C * 4;
  L.total = L.sb + 2 * C * 4;
  return L;
}

// The 16-byte vector j of row i (a pixel of the band, or a column of the
// weight) of a tile whose rows hold C/8 vectors, as a byte offset: vector
// j sits at (j & ~7) | ((j ^ i) & 7), so 8 consecutive rows at the same j
// fall in 8 different bank groups.
__device__ __forceinline__ int swz(int i, int j, int C) {
  return i * C * 2 + (((j & ~7) | ((j ^ i) & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until none of this thread's commit groups is pending.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float tanh_approx(float v) {
#ifdef DMU_OUT_HEAD_NO_TANH
  return v;   // a probe's ablation: SiLU without its special-function op
#else
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#endif
}

// Builds for scripts/probe_out_head.py only (the port's build defines
// neither macro): DMU_OUT_HEAD_NO_TANH takes the tanh out of SiLU (wrong
// results, to time the special-function unit's share);
// DMU_OUT_HEAD_PROBE has thread 0 of each block add the clock64 cycles of
// each phase of its samples into g_probe[block * kProbePhases + phase]:
// 0 copy wait, 1 statistics, 2 cluster barrier, 3 cluster sums, 4 the 3x3
// sum, 5 the affine, 6 the product (warp 0's share), 7 the block barrier
// after it, the next copy's issue and the halo stores.
#ifdef DMU_OUT_HEAD_PROBE
constexpr int kProbePhases = 8;
__device__ long long* g_probe;
#define PROBE_INIT long long probe_t = clock64(), probe_acc[kProbePhases] = {}
#define PROBE(i)                          \
  do {                                    \
    if (tid == 0) {                       \
      const long long t_ = clock64();     \
      probe_acc[i] += t_ - probe_t;       \
      probe_t = t_;                       \
    }                                     \
  } while (0)
#define PROBE_STORE                                                    \
  do {                                                                 \
    if (tid == 0)                                                      \
      for (int i_ = 0; i_ < kProbePhases; ++i_)                        \
        g_probe[blockIdx.x * kProbePhases + i_] = probe_acc[i_];       \
  } while (0)
#else
#define PROBE_INIT do {} while (0)
#define PROBE(i) do {} while (0)
#define PROBE_STORE do {} while (0)
#endif

// Two bf16 channels (c, c+1) of x in one register -> silu(x*a + b) rounded
// to bf16, packed the same way; ab = (a_c, b_c, a_c+1, b_c+1) / 2. With
// h = z / 2, silu(z) = z * (1 + tanh(h)) / 2 = h + h * tanh(h): two FMAs
// and one special-function op an element.
__device__ __forceinline__ uint32_t activate(uint32_t v, float4 ab) {
  const float h0 = fmaf(__uint_as_float(v << 16), ab.x, ab.y);
  const float h1 = fmaf(__uint_as_float(v & 0xffff0000u), ab.z, ab.w);
  const float y0 = fmaf(h0, tanh_approx(h0), h0);
  const float y1 = fmaf(h1, tanh_approx(h1), h1);
  const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
  return *reinterpret_cast<const uint32_t*>(&y);
}

// i / d by the reciprocal inv = 1 / d rounded to f32: (i + 0.5) * inv
// truncates to the quotient for 0 <= i < 2^16 and 1 <= d <= 4096 (checked
// for every such pair), which covers every band's outputs and width.
__device__ __forceinline__ int quotient(int i, float inv) {
  return __float2int_rz(((float)i + 0.5f) * inv);
}

// Sums of u0[j] and u1[j] over one group's channels [gs, gs + cg), as four
// interleaved running sums added in a fixed order (K1's group_sum).
__device__ __forceinline__ void group_sum(const float* u0, const float* u1,
                                          int gs, int cg_, float& s0,
                                          float& s1) {
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= cg_; j += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] += u0[gs + j + q];
      b[q] += u1[gs + j + q];
    }
  }
  for (; j < cg_; ++j) {
    a[0] += u0[gs + j];
    b[0] += u1[gs + j];
  }
  s0 = (a[0] + a[1]) + (a[2] + a[3]);
  s1 = (b[0] + b[1]) + (b[2] + b[3]);
}

// NT n-tiles of 8 columns (2, 4 or 8); MT m16 tiles a warp at once.
template <int NT, int MT>
__global__ void __launch_bounds__(kMaxThreads)
out_head_sm90_kernel(const OhArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int C = a.C, W = a.W, H = a.H, CV = C / 8, R = T / CV;
  const int cout = a.cout, taps = 9 * cout, etaps = 3 * cout;
  const Layout L = layout_of(a.rows, W, C, 8 * NT, a.pstride, T, cout);
  float* P = reinterpret_cast<float*>(smem + L.p);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* pub = reinterpret_cast<float*>(smem + L.pub);   // [2][2][C]
  float* edge = reinterpret_cast<float*>(smem + L.edge); // [2][2][W][etaps]
  float* tot = a.cluster > 1 ? red : pub;                // [2][C]
  float4* ab = reinterpret_cast<float4*>(smem + L.ab);   // [C/2]
  float* sb = reinterpret_cast<float*>(smem + L.sb);     // scale | bias
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = a.cluster;
  const int rank = ncl > 1 ? (int)cluster.block_rank() : 0;
  const int first = blockIdx.x / ncl, step = gridDim.x / ncl;
  const int r0 = rank * a.rows, r1 = min(H, r0 + a.rows);
  const int nrows = max(0, r1 - r0), npix = nrows * W, nvec = npix * CV;
  const int rounds = (nvec + T - 1) / T;
  const int col = tid % CV, trow = tid / CV;
  const uint32_t smem0 = smem_u32(smem), wt_s = smem0 + L.wt;

  // The copy of sample s's band into the band buffer, one commit group:
  // thread t on vector t % CV of pixels t / CV + i*R.
  auto copy_band = [&](int s) {
    const unsigned char* xs = reinterpret_cast<const unsigned char*>(
        a.x + ((long long)s * H + r0) * W * C);
    for (int i = 0; i < rounds; ++i) {
      const int q = tid + i * T;
      if (q < nvec)
        cp_async16(smem0 + swz(trow + i * R, col, C), xs + (long long)q * 16);
    }
    cp_async_commit();
  };
  const unsigned char* ws = reinterpret_cast<const unsigned char*>(a.wt);
  for (int q = tid; q < 8 * NT * CV; q += T)   // with the first band
    cp_async16(wt_s + swz(q / CV, q % CV, C), ws + (long long)q * 16);
  if (first < a.B) copy_band(first);
  for (int c = tid; c < C; c += T) {
    sb[c] = 0.5f * a.scale[c];
    sb[C + c] = 0.5f * a.bias[c];
  }
  // Halo rows: for the sample of parity e, edge[e][0] holds the row of P
  // above the band at taps 0-2 (the rank above writes its last row there),
  // edge[e][1] the row below at taps 6-8 (written by the rank below). The
  // neighbours' halos this block writes into; null at the image's edge.
  const int esize = 2 * W * etaps;
  float* h_up = r0 > 0 ? cluster.map_shared_rank(edge, rank - 1) + W * etaps
                       : nullptr;   // the rank above's row below its band
  float* h_dn = r1 < H ? cluster.map_shared_rank(edge, rank + 1) : nullptr;

  const float inv_cout = 1.f / cout, inv_w = 1.f / W;
  const float inv_etaps = 1.f / etaps;
  // The 3x3 sum of sample s from P (this block's, still holding s) and the
  // halo rows of parity e; a thread on output o = p * Cout + k of the band,
  // consecutive threads on consecutive outputs (contiguous in NHWC).
  auto sum3x3 = [&](int s, int e) {
    bf16* ob = a.out + ((long long)s * H + r0) * W * cout;
    const float* eu = r0 > 0 ? edge + e * esize : nullptr;
    const float* ed = r1 < H ? edge + e * esize + W * etaps : nullptr;
    for (int o = tid; o < npix * cout; o += T) {
      const int p = quotient(o, inv_cout), k = o - p * cout;
      const int ly = quotient(p, inv_w), xx = p - ly * W;
      // The nine loads go out together: each from a clamped address, its
      // value kept where the tap lies in the image (outside it adds 0).
      const int xs3[3] = {max(xx - 1, 0), xx, min(xx + 1, W - 1)};
      const bool xin[3] = {xx > 0, true, xx < W - 1};
      float v[9];
      bool in[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int y2 = ly + dy - 1;
        const bool inside = y2 >= 0 && y2 < nrows;
        const float* halo = y2 < 0 ? eu : ed;
        // Row y2 of P (tap column 3*dy*Cout + k, stepping Cout columns a
        // dx), or a halo row (x-major, 3*Cout taps a pixel).
        const float* base = inside ? P + (3 * dy * cout + k) * a.pstride +
                                         y2 * W
                                   : halo ? halo + k : P;
        const int dstep = inside ? cout * a.pstride : halo ? cout : 0;
        const int xstep = inside ? 1 : halo ? etaps : 0;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          v[3 * dy + dx] = base[dx * dstep + xs3[dx] * xstep];
          in[3 * dy + dx] = (inside || halo) && xin[dx];
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) sum += in[t] ? v[t] : 0.f;
      ob[o] = __float2bfloat16(sum);
    }
  };

  const int cg_ = C / a.G;
  const float inv_n = 1.f / ((float)H * (float)W * (float)cg_);
  // Lane (g, tq) = (lane / 4, lane % 4). ldmatrix: lane l names A row
  // l % 16 (a pixel) at k half l / 16, and B row (l % 8) + 8 (l / 16) (a
  // column of an n-tile pair) at k half (l / 8) % 2.
  const int g = lane >> 2, tq = lane & 3;
  const int arow = lane & 15, ahalf = lane >> 4;
  const int brow = (lane & 7) + 8 * (lane >> 4), bhalf = (lane >> 3) & 1;
  const int ksteps = C / 16;
  const int groups = (npix + 16 * MT - 1) / (16 * MT);
  int s = first, it = 0;
  PROBE_INIT;
  for (; s < a.B; s += step, ++it) {
    cp_async_wait_all();
    PROBE(0);
    const unsigned char* band = smem;
    const uint32_t band_s = smem0;
    float* pb = pub + (it & 1) * 2 * C;

    // 1. Per-channel f32 sums of x and x^2 over this thread's vectors (a
    // thread reads only what it copied), then over the block's thread rows
    // 0, 1, ..., R-1 in that order, published for the cluster.
    float s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll 4
    for (int i = 0; i < rounds; ++i) {
      if (tid + i * T >= nvec) break;
      const uint4 u =
          *reinterpret_cast<const uint4*>(band + swz(trow + i * R, col, C));
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e0 = __uint_as_float(w4[k] << 16);
        const float e1 = __uint_as_float(w4[k] & 0xffff0000u);
        s1[2 * k] += e0;
        s2[2 * k] += e0 * e0;
        s1[2 * k + 1] += e1;
        s2[2 * k + 1] += e1 * e1;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[trow * C + 8 * col + k] = s1[k];
      red[(R + trow) * C + 8 * col + k] = s2[k];
    }
    __syncthreads();
    for (int c = tid; c < C; c += T) {
      float u = 0.f, v = 0.f;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        u += red[r * C + c];
        v += red[(R + r) * C + c];
      }
      pb[c] = u;
      pb[C + c] = v;
    }
    PROBE(1);
    // The sample's one cluster barrier: every rank's sums of this sample and
    // halo rows of the previous one are written. Then the sums over the
    // ranks 0, 1, ..., ncl-1 in that order (into red, whose partials are
    // dead), and the previous sample's 3x3 sum.
    if (ncl > 1) {
      cluster.sync();
      PROBE(2);
      for (int i = tid; i < 2 * C; i += T) {
        float v[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          v[r] = r < ncl ? cluster.map_shared_rank(pb, r)[i] : 0.f;
        float u = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < ncl) u += v[r];
        tot[i] = u;
      }
    } else {
      __syncthreads();
      PROBE(2);
      tot = pb;
    }
    PROBE(3);
    if (it > 0) sum3x3(s - step, (it - 1) & 1);
    __syncthreads();   // tot is complete, P is free
    PROBE(4);
    // a/2 and b/2 for y = h + h * tanh(h), h = x * a/2 + b/2 = z / 2.
    for (int c2 = tid; c2 < C / 2; c2 += T) {
      float av[2], bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * c2 + e;
        float t1, t2;
        group_sum(tot, tot + C, c / cg_ * cg_, cg_, t1, t2);
        const float mean = t1 * inv_n;
        const float rstd =
            rsqrtf(fmaxf(t2 * inv_n - mean * mean, 0.f) + a.eps);
        av[e] = rstd * sb[c];
        bv[e] = sb[C + c] - mean * av[e];
      }
      ab[c2] = make_float4(av[0], bv[0], av[1], bv[1]);
    }
    __syncthreads();   // ab is written; every copy has landed and is seen
    PROBE(5);

    // 2. P = y . Wt over groups of MT m16 tiles of the band's pixels, warp
    // w on groups w, w + nwarps, ...
    for (int grp = warp; grp < groups; grp += nwarps) {
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
      int apix[MT];   // this lane's A row, clamped into the band
#pragma unroll
      for (int m = 0; m < MT; ++m)
        apix[m] = min((grp * MT + m) * 16 + arow, npix - 1);
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        const float4 ablo = ab[8 * ks + tq];       // channels 16ks + 2tq, +1
        const float4 abhi = ab[8 * ks + 4 + tq];   // and 8 further
        uint32_t bfr[NT][2];
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
          uint32_t r[4];
          ldmatrix_x4(r, wt_s + swz(16 * pr + brow, 2 * ks + bhalf, C));
          bfr[2 * pr][0] = r[0];
          bfr[2 * pr][1] = r[1];
          bfr[2 * pr + 1][0] = r[2];
          bfr[2 * pr + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          ldmatrix_x4(af, band_s + swz(apix[m], 2 * ks + ahalf, C));
          af[0] = activate(af[0], ablo);   // pixel g,     channels 16ks+2tq
          af[1] = activate(af[1], ablo);   // pixel g + 8
          af[2] = activate(af[2], abhi);   // pixel g,     channels + 8
          af[3] = activate(af[3], abhi);   // pixel g + 8
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma_16816(acc[m][t], af, bfr[t][0], bfr[t][1]);
        }
      }
      // Accumulator e of tile (m, t): pixel 16(grp*MT + m) + g + 8(e / 2),
      // column 8t + 2tq + e % 2; the padded columns past 9*Cout are not
      // kept, rows past the band land in P's padding.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int p = (grp * MT + m) * 16 + g;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int c0 = 8 * t + 2 * tq;
          float* pc = P + c0 * a.pstride + p;
          if (c0 < taps) {
            pc[0] = acc[m][t][0];
            pc[8] = acc[m][t][2];
          }
          if (c0 + 1 < taps) {
            pc[a.pstride] = acc[m][t][1];
            pc[a.pstride + 8] = acc[m][t][3];
          }
        }
      }
    }
    PROBE(6);
    __syncthreads();   // P is complete; the band is read
    if (s + step < a.B) copy_band(s + step);
    // This sample's first and last rows of P, at the taps the neighbours
    // need, into their halo rows (remote stores: no block waits on them).
    const int off = (it & 1) * esize;
    for (int i = tid; i < W * etaps; i += T) {
      const int xx = quotient(i, inv_etaps), q = i - xx * etaps;
      if (h_up) h_up[off + i] = P[(6 * cout + q) * a.pstride + xx];
      if (h_dn) h_dn[off + i] = P[q * a.pstride + (nrows - 1) * W + xx];
    }
    PROBE(7);
  }
  // The last sample's 3x3 sum, after a barrier that publishes its halo
  // rows. Nothing reads another block's shared memory after it.
  if (ncl > 1) cluster.sync();
  PROBE(2);
  if (it > 0) sum3x3(s - step, (it - 1) & 1);
  PROBE(4);
  PROBE_STORE;
}

using KernelFn = void (*)(const OhArgs);

KernelFn pick(int nt, int mt) {
  if (nt == 2) return mt == 2 ? out_head_sm90_kernel<2, 2>
                              : out_head_sm90_kernel<2, 1>;
  if (nt == 4) return mt == 2 ? out_head_sm90_kernel<4, 2>
                              : out_head_sm90_kernel<4, 1>;
  if (nt == 8 && mt == 1) return out_head_sm90_kernel<8, 1>;
  return nullptr;
}

// The n-tiles of Cout's 9*Cout columns (ops/boundary_conv.py::
// out_head_columns / 8).
int ntiles_of(int cout) {
  return 9 * cout <= 16 ? 2 : 9 * cout <= 32 ? 4 : 8;
}

}  // namespace

// K6's sm90 route: x [B,H,W,C] and out [B,H,W,Cout] contiguous bf16, x
// 16-byte aligned; scale and bias f32 [C]; wt the packed weight [columns, C]
// bf16. The six arguments before the stream are out_head_launch_plan's:
// blocks a cluster (a sample at a time), image rows a block, threads a
// block, m16 tiles a warp at once, pixels a column of P, dynamic shared
// bytes. Returns cudaErrorInvalidValue for a plan that
// does not cover the shape or whose shared bytes differ from its layout's.
// Launches as many clusters as the card holds at once, at most B.
extern "C" int dmu_out_head_sm90(const void* x, const float* scale,
                                 const float* bias, const void* wt,
                                 void* out, int B, int H, int W, int C,
                                 int G, int Cout, float eps, int cluster,
                                 int rows, int threads, int mtiles, int pstride, int smem_bytes,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 64 != 0 || C > kMaxC ||
      G <= 0 || C % G != 0 || Cout < 1 || Cout > kMaxCout)
    return (int)cudaErrorInvalidValue;
  const int nt = ntiles_of(Cout);
  const KernelFn kern = pick(nt, mtiles);
  const int CV = C / 8, group = 16 * mtiles;
  const int mpad = (rows * W + group - 1) / group * group;
  if (!kern || cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      (long long)rows * cluster < H || (long long)(cluster - 1) * rows >= H ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      threads % CV != 0 || pstride < mpad || pstride % 32 != 4 ||
      smem_bytes !=
          layout_of(rows, W, C, 8 * nt, pstride, threads, Cout).total ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(resident < B ? resident : B) * cluster);
  OhArgs a;
  a.x = static_cast<const bf16*>(x);
  a.scale = scale;
  a.bias = bias;
  a.wt = static_cast<const bf16*>(wt);
  a.out = static_cast<bf16*>(out);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.G = G;
  a.cout = Cout;
  a.eps = eps;
  a.cluster = cluster;
  a.rows = rows;
  a.pstride = pstride;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef DMU_OUT_HEAD_PROBE
// The probe's buffer of cycles, [blocks launched][kProbePhases] int64.
extern "C" int dmu_out_head_probe_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf));
}
#endif

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
