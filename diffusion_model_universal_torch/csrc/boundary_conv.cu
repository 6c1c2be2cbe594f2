// The UNet's two boundary convolutions for Hopper: the output head (kernel
// K6: GroupNorm statistics, scale/bias, SiLU and a 3x3 conv C -> Cout in one
// kernel) and the input conv (kernel K7: a 3x3 conv 3 -> C). NHWC
// activations, HWIO weights, SAME padding, stride 1.
//
// K6 replaces the TPU kernel `_kernel_out_head`
// (scripts/exp_boundary_kernel.py:54, launched by `out_head_pallas` at :83),
// with the same math:
//   per (sample, group): mean = E[x], var = max(E[x^2] - mean^2, 0) in f32
//   (sums over H*W*C/G), rstd = rsqrt(var + eps)
//   a = rstd * scale, b = bias - mean * a              (f32, per channel)
//   y = silu(x * a + b) in f32, rounded once to x's dtype
//   out = conv3x3(y, w), y = 0 outside the image, accumulated in f32.
// K7 replaces `_kernel_in_conv` (:114, launched by `in_conv_pallas` at
// :131): out = im2col(x) [M, 27] @ w [27, Cout], accumulated in f32, with
// column (ky*3 + kx)*3 + ci.
//
// Which shapes take the K6 kernel of this file (out_head_kernel, the
// CUDA-core kernel; ops/boundary_conv.py::out_head_route): every f32 call
// (route "f32"), and the bf16 calls that csrc/out_head_sm90.cu (route
// "sm90": a cluster that reads x once, the conv on the tensor cores) does
// not take, route "simt": C not a multiple of 64 or over 2048, or a sample
// that no 8-block cluster holds in shared memory (64x64x256 and up). One
// launch takes up to 7 output channels and a chunk of up to 2048 input
// channels that starts and ends on group boundaries (GroupNorm statistics
// are per group, so a chunk normalises exactly); it walks each row in
// tiles of `tile_w` columns. The wrapper (out_head_simt_plan) runs wider
// heads in passes of at most 7 outputs, each output depending only on its
// own column of w, and splits C where the chunk's f32 weight does not fit
// 227 KB: the chunks' partial outputs are then summed in f32 in the
// output (`accumulate`, launches in order on one stream) and cast once.
// A chunk whose channels are not whole 16-byte vectors (C not a multiple
// of 8) is read element by element (`vec` = 0), its padding channels
// zero.

// What bounds them on an H100: bytes. K6 must read x once (537 MB at the
// bench shape B=2048, 32x32, C=128, bf16) and write 12.6 MB; K7 reads
// 12.6 MB and writes 537 MB: about 0.16 ms each at 3.35 TB/s. Their products
// have N = 3 or K = 27. This K6 runs N = 9*Cout as f32 FMAs on the CUDA
// cores: 7.2 G FMAs at the bench shape, about 0.22 ms at the card's 67
// TFLOP/s f32 rate, a floor of its own (the sm90 route takes the 9 taps x
// Cout as the columns of one tensor-core product instead). K7 in bf16 pads
// K to 32 and runs on the tensor cores, where its 7.2 G MACs take about
// 0.02 ms, far under its store bound.
//
// K6 design (CUDA cores). One sample's 32x32x128 bf16 slab is 256 KB, more
// than the 227 KB of shared memory a block can have (the Pallas block held
// whole samples in VMEM). So one block per sample makes two passes over x:
// 1. statistics: each thread reads 8 channels (16 bytes of bf16) of a pixel
//    and keeps their f32 sums of x and x^2; the per-channel sums are taken
//    over the threads in a fixed order in shared memory, then per group, as
//    K1's device code and `_block_stats` do;
// 2. apply and conv, one image row at a time: each pixel of the row is read
//    again, from HBM as a rule: 4-7 blocks share an SM, and their samples
//    (135-236 MB at the bench shape) are several times the 50 MB L2, so
//    this design moves twice the bytes of its bound. y is formed once per
//    element, and its 9*Cout partial products y[q] . w[tap][:, k] are
//    summed over the channels by groups of 8 lanes. They go into a ring of
//    3 rows in shared memory; output row r-1 is then the sum of 9 of them
//    from rows r-2..r. A neighbour outside the image contributes nothing:
//    the halo is 0 after SiLU, as in K4. No atomics: the result is
//    reproducible.
// K7 design, bf16 (`in_conv_mma_kernel`): the tensor cores, as the TPU
// body's bf16 dot_general with f32 accumulation. K is 27, padded to 32 =
// two k16 steps of mma.sync m16n8k16. The wrapper packs the weight to
// [32, Cout] bf16 with rows 27-31 zero; each warp keeps the B fragments of
// up to 128 output channels in registers for the whole kernel. Persistent
// blocks of 8 warps walk groups of 16 consecutive pixels; a lane gathers its
// 8 im2col columns for 2 pixels straight into A fragments (x is 12.6 MB at
// the bench shape and is read from L1/L2; a column outside the image or past
// 27 is 0). The kernel is bound by its output stores, so the epilogue goes
// f32 -> bf16 -> the warp's padded shared-memory tile -> 16-byte stores,
// each warp store writing 512 contiguous bytes; every warp stores while the
// others gather and multiply.
// K7 design, f32 (`in_conv_kernel`, CUDA cores in full f32): a block owns
// 256 consecutive pixels: it gathers their 27 inputs each (zeros outside
// the image) into shared memory, then each thread writes 8 consecutive
// output channels of a pixel, so a warp's stores cover whole contiguous
// rows of the output. The weight sits in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxOut = 7;       // K6's widest output a launch
constexpr int kMaxChunk = 2048;  // K6's widest chunk of input channels
constexpr int kLanes = 8;        // K6: lanes that share one pixel
constexpr int kInPixels = 256;   // K7: pixels per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive elements of p (16-byte aligned for bf16, 32 for f32) in f32.
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------------------
// K6.

// Shared memory of one K6 block, in floats (ops/boundary_conv.py::
// out_head_smem_bytes computes the same to plan and refuse): C padded to
// whole 8-channel vectors, the ring as wide as a tile and its 2 halo
// columns (the whole row when the tile takes it).
__host__ __device__ inline int out_head_ring_cols(int W, int tile_w) {
  return tile_w + 2 < W ? tile_w + 2 : W;
}
__host__ __device__ inline int out_head_smem_floats(int W, int C, int G,
                                                    int cout, int tile_w) {
  const int cp = (C + 7) / 8 * 8;
  const int stats = 2 * kThreads * 8;     // per-thread partial sums
  const int ring = 3 * out_head_ring_cols(W, tile_w) * 9 * cout;
  return 9 * cout * cp + 4 * cp + 2 * G + (stats > ring ? stats : ring);
}

// 8 consecutive channels c..c+7 of a pixel at p in f32: a 16-byte vector
// where `vec`, else element by element with channels past C as 0.
template <typename T>
__device__ __forceinline__ void load8_masked(const T* p, int c, int C,
                                             int vec, float v[8]) {
  if (vec) {
    load8(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = c + i < C ? to_f32(p[i]) : 0.f;
}

// KOUT output channels: 9 * KOUT partial products per input pixel. x points
// at the chunk's first channel of pixel 0 (pixel stride ldx), w is the
// chunk's [3,3,C,KOUT], out points at the pass's first output channel
// (pixel stride ldo); TO is T, or float where chunks accumulate.
template <typename T, typename TO, int KOUT>
__global__ void __launch_bounds__(kThreads)
out_head_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const T* __restrict__ w,
                TO* __restrict__ out, int H, int W, int C, int G, int ldx,
                int ldo, int tile_w, int vec, int accumulate, float eps) {
  constexpr int kOut = KOUT, kTapOut = 9 * KOUT;
  const int V = (C + 7) / 8;              // 8-channel vectors per pixel
  const int Cp = 8 * V;                   // C padded to whole vectors
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [Cp][9*Cout]: w[tap][c][k] at
                                          // c*9*Cout + tap*Cout + k
  float* a_s = w_s + kTapOut * Cp;        // [Cp]
  float* b_s = a_s + Cp;                  // [Cp]
  float* colsum = b_s + Cp;               // [Cp]
  float* colsq = colsum + Cp;             // [Cp]
  float* mean_g = colsq + Cp;             // [G]
  float* rstd_g = mean_g + G;             // [G]
  float* work = rstd_g + G;               // stats partials, then the ring

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int HW = H * W;
  const T* xb = x + (long long)b * HW * ldx;

  // Padding channels get a zero weight and a zero affine: their y is
  // silu(0) = 0 and adds nothing.
  for (int i = tid; i < kTapOut * Cp; i += kThreads) {
    const int c = i / kTapOut, j = i - c * kTapOut;   // j = tap*Cout + k
    const int tap = j / kOut, k = j - tap * kOut;
    w_s[i] = c < C ? to_f32(w[((long long)tap * C + c) * kOut + k]) : 0.f;
  }

  // Pass 1: per-channel f32 sums of x and x^2.
  const int rows = kThreads / V;          // pixels in flight
  const int v = tid % V, r0 = tid / V;
  float s1[8] = {}, s2[8] = {};
  if (r0 < rows)
    for (int p = r0; p < HW; p += rows) {
      float e[8];
      load8_masked(xb + (long long)p * ldx + 8 * v, 8 * v, C, vec, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[i] += e[i];
        s2[i] += e[i] * e[i];
      }
    }
  float* part1 = work;
  float* part2 = work + kThreads * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part1[tid * 8 + i] = s1[i];
    part2[tid * 8 + i] = s2[i];
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < rows; ++r) {     // fixed order
      t1 += part1[(r * V + c / 8) * 8 + c % 8];
      t2 += part2[(r * V + c / 8) * 8 + c % 8];
    }
    colsum[c] = t1;
    colsq[c] = t2;
  }
  __syncthreads();
  const int cg = C / G;
  const float n = (float)HW * (float)cg;
  for (int g = tid; g < G; g += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      t1 += colsum[g * cg + j];
      t2 += colsq[g * cg + j];
    }
    const float mean = t1 / n;
    mean_g[g] = mean;
    rstd_g[g] = rsqrtf(fmaxf(t2 / n - mean * mean, 0.f) + eps);
  }
  __syncthreads();
  for (int c = tid; c < Cp; c += kThreads) {
    const float a = c < C ? rstd_g[c / cg] * scale[c] : 0.f;
    a_s[c] = a;
    b_s[c] = c < C ? bias[c] - mean_g[c / cg] * a : 0.f;
  }
  __syncthreads();  // the partials are dead: work becomes the ring

  // Pass 2, a tile of columns [x0, x1) at a time: row r's partial products
  // of the tile and its halo columns [lo, hi) into ring slot r % 3, then
  // output row r - 1 of the tile from rows r-2..r.
  float* ring = work;                     // [3][ring columns][9*Cout]
  const int ring_cols = out_head_ring_cols(W, tile_w);
  const int slice = tid % kLanes;         // this lane's share of channels
  const int px = tid / kLanes;            // pixel within a pass over the row
  const int per_pass = kThreads / kLanes;
  for (int x0 = 0; x0 < W; x0 += tile_w) {
    const int x1 = x0 + tile_w < W ? x0 + tile_w : W;
    const int lo = x0 > 0 ? x0 - 1 : 0;
    const int hi = x1 < W ? x1 + 1 : W;
    for (int r = 0; r <= H; ++r) {
      if (r < H) {
        float* slot = ring + (r % 3) * ring_cols * kTapOut;
        for (int c0 = lo; c0 < hi; c0 += per_pass) {
          const int col = c0 + px;
          float acc[kTapOut] = {};
          if (col < hi) {
            const T* xp = xb + ((long long)r * W + col) * ldx;
            for (int vv = slice; vv < V; vv += kLanes) {
              float e[8];
              load8_masked(xp + 8 * vv, 8 * vv, C, vec, e);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int c = 8 * vv + i;
                const float z = e[i] * a_s[c] + b_s[c];
                const float s = z * (1.f / (1.f + expf(-z)));
                const float y = to_f32(from_f32<T>(s));  // rounded once
                const float* wc = w_s + c * kTapOut;
#pragma unroll
                for (int j = 0; j < kTapOut; ++j)
                  acc[j] = fmaf(y, wc[j], acc[j]);
              }
            }
          }
          // Sum over the kLanes lanes of this pixel (all lanes take part).
#pragma unroll
          for (int j = 0; j < kTapOut; ++j) {
#pragma unroll
            for (int off = kLanes / 2; off > 0; off >>= 1)
              acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
          }
          if (slice == 0 && col < hi)
#pragma unroll
            for (int j = 0; j < kTapOut; ++j)
              slot[(col - lo) * kTapOut + j] = acc[j];
        }
      }
      __syncthreads();
      if (r >= 1) {
        const int orow = r - 1;
        for (int i = tid; i < (x1 - x0) * kOut; i += kThreads) {
          const int col = x0 + i / kOut, k = i % kOut;
          float sum = 0.f;
          for (int dy = -1; dy <= 1; ++dy) {
            const int rr = orow + dy;
            if (rr < 0 || rr >= H) continue;
            const float* slot = ring + (rr % 3) * ring_cols * kTapOut;
            for (int dx = -1; dx <= 1; ++dx) {
              const int cc = col + dx;
              if (cc < 0 || cc >= W) continue;
              const int tap = (dy + 1) * 3 + (dx + 1);
              sum += slot[(cc - lo) * kTapOut + tap * kOut + k];
            }
          }
          const long long o = (((long long)b * H + orow) * W + col) * ldo + k;
          if (accumulate) sum += to_f32(out[o]);
          out[o] = from_f32<TO>(sum);
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// K7.

// Shared memory of one K7 block, in floats (as ops/boundary_conv.py).
__host__ __device__ inline int in_conv_smem_floats(int Cout) {
  return 27 * Cout + kInPixels * 27;
}

__global__ void __launch_bounds__(kThreads)
in_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, long long M, int H, int W, int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [27][Cout]
  float* patch = w_s + 27 * Cout;         // [kInPixels][27]
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kInPixels;

  for (int i = tid; i < 27 * Cout; i += kThreads) w_s[i] = w[i];
  const int HW = H * W;
  for (int i = tid; i < kInPixels * 27; i += kThreads) {
    const int p = i / 27, j = i - p * 27;
    const int tap = j / 3, ci = j - tap * 3;
    const long long m = m0 + p;
    float val = 0.f;
    if (m < M) {
      const int b = (int)(m / HW);
      const int rem = (int)(m - (long long)b * HW);
      const int yy = rem / W + tap / 3 - 1;
      const int xx = rem % W + tap % 3 - 1;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        val = x[(((long long)b * H + yy) * W + xx) * 3 + ci];
    }
    patch[i] = val;
  }
  __syncthreads();

  const int V = Cout / 8;
  for (int i = tid; i < kInPixels * V; i += kThreads) {
    const int p = i / V, v = i - p * V;
    const long long m = m0 + p;
    if (m >= M) break;  // i only grows, and so does p
    float acc[8] = {};
    const float* pp = patch + p * 27;
    for (int j = 0; j < 27; ++j) {
      const float pv = pp[j];
      const float* wj = w_s + j * Cout + 8 * v;
      const float4 w0 = *reinterpret_cast<const float4*>(wj);
      const float4 w1 = *reinterpret_cast<const float4*>(wj + 4);
      acc[0] = fmaf(pv, w0.x, acc[0]);
      acc[1] = fmaf(pv, w0.y, acc[1]);
      acc[2] = fmaf(pv, w0.z, acc[2]);
      acc[3] = fmaf(pv, w0.w, acc[3]);
      acc[4] = fmaf(pv, w1.x, acc[4]);
      acc[5] = fmaf(pv, w1.y, acc[5]);
      acc[6] = fmaf(pv, w1.z, acc[6]);
      acc[7] = fmaf(pv, w1.w, acc[7]);
    }
    store8(out + m * Cout + 8 * v, acc);
  }
}

// bf16 on the tensor cores.
constexpr int kMmaWarps = 8;
constexpr int kChunk = 128;          // output channels a warp holds at once
constexpr int kEpiLd = kChunk + 8;   // padded staging row, bf16

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x [B,H,W,3], wp [32, Cout] (rows 27-31 zero), out [B,H,W,Cout], bf16.
// Lane (g, tq) = (lane / 4, lane % 4) of a warp holds, for pixels g and g+8
// of its group of 16, the im2col columns 16s + 8r + 2tq + e (k step s, half
// r, element e), which is the m16n8k16 A fragment; column j is tap j / 3 =
// ky*3 + kx, channel j % 3, the reference's (ky*3 + kx)*3 + ci.
__global__ void __launch_bounds__(kMmaWarps * 32)
in_conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                   bf16* __restrict__ out, long long M, int H, int W,
                   int Cout) {
  __shared__ __align__(16) bf16 epi[kMmaWarps][16 * kEpiLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(wp);
  bf16* st = epi[warp];

  int col_dy[8], col_dx[8], col_ci[8];
  bool col_ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = 16 * (i / 4) + 8 * ((i / 2) % 2) + 2 * tq + i % 2;
    const int tap = j / 3;
    col_ok[i] = j < 27;
    col_dy[i] = tap / 3 - 1;
    col_dx[i] = tap % 3 - 1;
    col_ci[i] = j % 3;
  }

  const int HW = H * W;
  const long long groups = (M + 15) / 16;
  const long long first = (long long)blockIdx.x * kMmaWarps + warp;
  const long long step = (long long)gridDim.x * kMmaWarps;
  for (int n0 = 0; n0 < Cout; n0 += kChunk) {
    const int nt = (Cout - n0 < kChunk ? Cout - n0 : kChunk) / 8;
    // B fragment (s, j, h): rows k = 16s + 8h + 2tq (+1), column n0 + 8j + g.
    uint32_t bfr[2][kChunk / 8][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v = 0;
          if (j < nt) {
            const int k = 16 * s + 8 * h + 2 * tq;
            const int n = n0 + 8 * j + g;
            v = (uint32_t)ws[k * Cout + n] |
                ((uint32_t)ws[(k + 1) * Cout + n] << 16);
          }
          bfr[s][j][h] = v;
        }

    for (long long grp = first; grp < groups; grp += step) {
      const long long mbase = grp * 16;
      // vals[r][i]: pixel g + 8r, column i of this lane.
      uint32_t vals[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long m = mbase + g + 8 * r;
        int b = 0, y = -1000, xx = -1000;
        if (m < M) {
          b = (int)(m / HW);
          const int rem = (int)(m - (long long)b * HW);
          y = rem / W;
          xx = rem - y * W;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int yy = y + col_dy[i], xc = xx + col_dx[i];
          uint32_t v = 0;
          if (col_ok[i] && yy >= 0 && yy < H && xc >= 0 && xc < W)
            v = __ldg(xs + (((long long)b * H + yy) * W + xc) * 3 +
                      col_ci[i]);
          vals[r][i] = v;
        }
      }
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        a[s][0] = vals[0][4 * s] | (vals[0][4 * s + 1] << 16);
        a[s][1] = vals[1][4 * s] | (vals[1][4 * s + 1] << 16);
        a[s][2] = vals[0][4 * s + 2] | (vals[0][4 * s + 3] << 16);
        a[s][3] = vals[1][4 * s + 2] | (vals[1][4 * s + 3] << 16);
      }
      // Products and staging: accumulator e of n tile j sits at pixel
      // g + 8 (e / 2), channel 8j + 2tq + e % 2.
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        if (j < nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_16816(d, a[0], bfr[0][j][0], bfr[0][j][1]);
          mma_16816(d, a[1], bfr[1][j][0], bfr[1][j][1]);
          *reinterpret_cast<__nv_bfloat162*>(&st[g * kEpiLd + 8 * j + 2 * tq]) =
              __floats2bfloat162_rn(d[0], d[1]);
          *reinterpret_cast<__nv_bfloat162*>(
              &st[(g + 8) * kEpiLd + 8 * j + 2 * tq]) =
              __floats2bfloat162_rn(d[2], d[3]);
        }
      }
      __syncwarp();
      // 16 rows of nt 16-byte vectors; rows are consecutive pixels.
      for (int idx = lane; idx < 16 * nt; idx += 32) {
        const int row = idx / nt, c = idx - row * nt;
        const long long m = mbase + row;
        if (m < M)
          *reinterpret_cast<uint4*>(out + m * Cout + n0 + 8 * c) =
              *reinterpret_cast<const uint4*>(&st[row * kEpiLd + 8 * c]);
      }
      __syncwarp();
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, typename TO, int KOUT>
int launch_out_head(const void* x, const float* scale, const float* bias,
                    const void* w, void* out, int B, int H, int W, int C,
                    int G, int ldx, int ldo, int tile_w, int vec,
                    int accumulate, float eps, cudaStream_t st) {
  const size_t bytes =
      sizeof(float) * (size_t)out_head_smem_floats(W, C, G, KOUT, tile_w);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(out_head_kernel<T, TO, KOUT>, bytes);
  if (err != cudaSuccess) return (int)err;
  out_head_kernel<T, TO, KOUT><<<B, kThreads, bytes, st>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(w),
      static_cast<TO*>(out), H, W, C, G, ldx, ldo, tile_w, vec, accumulate,
      eps);
  return (int)cudaGetLastError();
}

int launch_in_conv(const void* x, const void* w, void* out, int B, int H,
                   int W, int Cout, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)in_conv_smem_floats(Cout);
  cudaError_t err = allow_smem(in_conv_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const unsigned blocks = (unsigned)((M + kInPixels - 1) / kInPixels);
  in_conv_kernel<<<blocks, kThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, H, W, Cout);
  return (int)cudaGetLastError();
}

// Persistent: as many blocks as fit on the card at once, at most one per
// 8 pixel groups.
int launch_in_conv_mma(const void* x, const void* wp, void* out, int B, int H,
                       int W, int Cout, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, in_conv_mma_kernel, kMmaWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const long long wanted = ((M + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(wanted < resident ? wanted : resident);
  in_conv_mma_kernel<<<blocks, kMmaWarps * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<bf16*>(out), M, H, W, Cout);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int launch_out_head_cout(const void* x, const float* scale, const float* bias,
                         const void* w, void* out, int B, int H, int W, int C,
                         int G, int Cout, int ldx, int ldo, int tile_w,
                         int vec, int accumulate, float eps,
                         cudaStream_t st) {
#define DMU_OUT_HEAD_ARGS \
  x, scale, bias, w, out, B, H, W, C, G, ldx, ldo, tile_w, vec, accumulate, \
      eps, st
  switch (Cout) {
    case 1: return launch_out_head<T, TO, 1>(DMU_OUT_HEAD_ARGS);
    case 2: return launch_out_head<T, TO, 2>(DMU_OUT_HEAD_ARGS);
    case 3: return launch_out_head<T, TO, 3>(DMU_OUT_HEAD_ARGS);
    case 4: return launch_out_head<T, TO, 4>(DMU_OUT_HEAD_ARGS);
    case 5: return launch_out_head<T, TO, 5>(DMU_OUT_HEAD_ARGS);
    case 6: return launch_out_head<T, TO, 6>(DMU_OUT_HEAD_ARGS);
    case 7: return launch_out_head<T, TO, 7>(DMU_OUT_HEAD_ARGS);
  }
#undef DMU_OUT_HEAD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K6 on the CUDA cores, one pass over one chunk: x [B,H,W,C] at pixel
// stride ldx (a chunk of a wider x), w [3,3,C,Cout] contiguous and out
// [B,H,W,Cout] at pixel stride ldo, in one dtype (bf16 when is_bf16, else
// f32), or out in f32 (out_f32) for a bf16 x whose chunks accumulate; scale
// and bias f32 [C]. C a multiple of G, at most 2048; Cout from 1 to 7;
// `vec` only where C, ldx and x's address allow 16-byte vectors;
// `accumulate` adds to out (f32 out only).
extern "C" int dmu_out_head(const void* x, const float* scale,
                            const float* bias, const void* w, void* out,
                            int B, int H, int W, int C, int G, int Cout,
                            float eps, int is_bf16, int ldx, int ldo,
                            int tile_w, int vec, int out_f32, int accumulate,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxChunk || G <= 0 ||
      C % G != 0 || Cout < 1 || Cout > kMaxOut || ldx < C || ldo < Cout ||
      tile_w < 1 || (accumulate && !out_f32 && is_bf16) ||
      (vec && (C % 8 != 0 || ldx % 8 != 0 ||
               reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && out_f32)
    return launch_out_head_cout<bf16, float>(
        x, scale, bias, w, out, B, H, W, C, G, Cout, ldx, ldo, tile_w, vec,
        accumulate, eps, st);
  if (is_bf16)
    return launch_out_head_cout<bf16, bf16>(
        x, scale, bias, w, out, B, H, W, C, G, Cout, ldx, ldo, tile_w, vec,
        0, eps, st);
  return launch_out_head_cout<float, float>(
      x, scale, bias, w, out, B, H, W, C, G, Cout, ldx, ldo, tile_w, vec,
      accumulate, eps, st);
}

// K7 in f32 on the CUDA cores: x [B,H,W,3], w [3,3,3,Cout] and out
// [B,H,W,Cout] contiguous f32; Cout a multiple of 8. bf16 takes
// dmu_in_conv_mma, so is_bf16 must be 0.
extern "C" int dmu_in_conv(const void* x, const void* w, void* out, int B,
                           int H, int W, int Cout, int is_bf16,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0 || is_bf16)
    return (int)cudaErrorInvalidValue;
  return launch_in_conv(x, w, out, B, H, W, Cout,
                        static_cast<cudaStream_t>(stream));
}

// K7 in bf16 on the tensor cores: x [B,H,W,3] and out [B,H,W,Cout]
// contiguous bf16; wp the packed weight [32, Cout] bf16, row
// (ky*3 + kx)*3 + ci = w[ky,kx,ci,:] and rows 27-31 zero; Cout a multiple
// of 8; all 16-byte aligned.
extern "C" int dmu_in_conv_mma(const void* x, const void* wp, void* out,
                               int B, int H, int W, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return launch_in_conv_mma(x, wp, out, B, H, W, Cout,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
