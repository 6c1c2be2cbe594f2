// The UNet's two boundary convolutions for Hopper: the output head (kernel
// K6: GroupNorm statistics, scale/bias, SiLU and a 3x3 conv C -> 3 in one
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
// What bounds them on an H100: bytes. K6 must read x once (537 MB at the
// bench shape B=2048, 32x32, C=128, bf16) and write 12.6 MB; K7 reads
// 12.6 MB and writes 537 MB: about 0.16 ms each at 3.35 TB/s. Their products
// have N = 3 or K = 27, too narrow for the tensor cores, so they run as f32
// FMAs on the CUDA cores: 7.2 G FMAs each at the bench shape, about 0.22 ms
// at the card's 67 TFLOP/s f32 rate, which is a floor of its own.
//
// K6 design. One sample's 32x32x128 bf16 slab is 256 KB, more than the 227 KB
// of shared memory a block can have (the Pallas block held whole samples in
// VMEM). So one block per sample makes two passes over x:
// 1. statistics: each thread reads 8 channels (16 bytes of bf16) of a pixel
//    and keeps their f32 sums of x and x^2; the per-channel sums are taken
//    over the threads in a fixed order in shared memory, then per group, as
//    K1's device code and `_block_stats` do;
// 2. apply and conv, one image row at a time: each pixel of the row is read
//    again (now mostly from the 50 MB L2), y is formed once per element, and
//    its 27 partial products y[q] . w[tap][:, k] (9 taps x 3 outputs) are
//    summed over the channels by groups of 8 lanes. They go into a ring of 3
//    rows in shared memory; output row r-1 is then the sum of 9 of them from
//    rows r-2..r. A neighbour outside the image contributes nothing: the halo
//    is 0 after SiLU, as in K4. No atomics: the result is reproducible.
// K7 design. A block owns 256 consecutive pixels: it gathers their 27 inputs
// each (zeros outside the image) into shared memory, then each thread writes
// 8 consecutive output channels of a pixel (16 bytes of bf16), so a warp's
// stores cover whole contiguous rows of the output. The weight sits in
// shared memory in f32.
// Not done yet: keeping K6's second pass out of HBM when the resident blocks'
// samples outgrow the L2, and bf16x2 or tensor-core arithmetic for K7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kOut = 3;          // K6's output channels
constexpr int kTapOut = 9 * kOut;  // partial products per input pixel
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
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------------------
// K6.

// Shared memory of one K6 block, in floats (ops/boundary_conv.py computes
// the same to refuse what does not fit).
__host__ __device__ inline int out_head_smem_floats(int W, int C, int G) {
  const int stats = 2 * kThreads * 8;     // per-thread partial sums
  const int ring = 3 * W * kTapOut;       // 3 rows of partial products
  return kTapOut * C + 4 * C + 2 * G + (stats > ring ? stats : ring);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_head_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const T* __restrict__ w,
                T* __restrict__ out, int H, int W, int C, int G, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [C][27]: w[tap][c][k] at c*27 + j
  float* a_s = w_s + kTapOut * C;         // [C]
  float* b_s = a_s + C;                   // [C]
  float* colsum = b_s + C;                // [C]
  float* colsq = colsum + C;              // [C]
  float* mean_g = colsq + C;              // [G]
  float* rstd_g = mean_g + G;             // [G]
  float* work = rstd_g + G;               // stats partials, then the ring

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int HW = H * W;
  const T* xb = x + (long long)b * HW * C;

  for (int i = tid; i < kTapOut * C; i += kThreads) {
    const int c = i / kTapOut, j = i - c * kTapOut;   // j = tap*3 + k
    const int tap = j / kOut, k = j - tap * kOut;
    w_s[i] = to_f32(w[((long long)tap * C + c) * kOut + k]);
  }

  // Pass 1: per-channel f32 sums of x and x^2.
  const int V = C / 8;                    // 8-channel vectors per pixel
  const int rows = kThreads / V;          // pixels in flight
  const int v = tid % V, r0 = tid / V;
  float s1[8] = {}, s2[8] = {};
  if (r0 < rows)
    for (int p = r0; p < HW; p += rows) {
      float e[8];
      load8(xb + (long long)p * C + 8 * v, e);
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
  for (int c = tid; c < C; c += kThreads) {
    const float a = rstd_g[c / cg] * scale[c];
    a_s[c] = a;
    b_s[c] = bias[c] - mean_g[c / cg] * a;
  }
  __syncthreads();  // the partials are dead: work becomes the ring

  // Pass 2: row r's partial products into ring slot r % 3, then output row
  // r - 1 from rows r-2..r.
  float* ring = work;                     // [3][W][27]
  const int slice = tid % kLanes;         // this lane's share of channels
  const int px = tid / kLanes;            // pixel within a pass over the row
  const int per_pass = kThreads / kLanes;
  for (int r = 0; r <= H; ++r) {
    if (r < H) {
      float* slot = ring + (r % 3) * W * kTapOut;
      for (int x0 = 0; x0 < W; x0 += per_pass) {
        const int col = x0 + px;
        float acc[kTapOut] = {};
        if (col < W) {
          const T* xp = xb + ((long long)r * W + col) * C;
          for (int vv = slice; vv < V; vv += kLanes) {
            float e[8];
            load8(xp + 8 * vv, e);
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
        if (slice == 0 && col < W)
#pragma unroll
          for (int j = 0; j < kTapOut; ++j) slot[col * kTapOut + j] = acc[j];
      }
    }
    __syncthreads();
    if (r >= 1) {
      const int orow = r - 1;
      for (int i = tid; i < W * kOut; i += kThreads) {
        const int col = i / kOut, k = i - col * kOut;
        float sum = 0.f;
        for (int dy = -1; dy <= 1; ++dy) {
          const int rr = orow + dy;
          if (rr < 0 || rr >= H) continue;
          const float* slot = ring + (rr % 3) * W * kTapOut;
          for (int dx = -1; dx <= 1; ++dx) {
            const int cc = col + dx;
            if (cc < 0 || cc >= W) continue;
            const int tap = (dy + 1) * 3 + (dx + 1);
            sum += slot[cc * kTapOut + tap * kOut + k];
          }
        }
        const long long o = (((long long)b * H + orow) * W + col) * kOut + k;
        out[o] = from_f32<T>(sum);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K7.

// Shared memory of one K7 block, in floats (as ops/boundary_conv.py).
__host__ __device__ inline int in_conv_smem_floats(int Cout) {
  return 27 * Cout + kInPixels * 27;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, long long M, int H, int W, int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [27][Cout]
  float* patch = w_s + 27 * Cout;         // [kInPixels][27]
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kInPixels;

  for (int i = tid; i < 27 * Cout; i += kThreads) w_s[i] = to_f32(w[i]);
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
        val = to_f32(x[(((long long)b * H + yy) * W + xx) * 3 + ci]);
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch_out_head(const void* x, const float* scale, const float* bias,
                    const void* w, void* out, int B, int H, int W, int C,
                    int G, float eps, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)out_head_smem_floats(W, C, G);
  cudaError_t err = allow_smem(out_head_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  out_head_kernel<T><<<B, kThreads, bytes, st>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(w),
      static_cast<T*>(out), H, W, C, G, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_in_conv(const void* x, const void* w, void* out, int B, int H,
                   int W, int Cout, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)in_conv_smem_floats(Cout);
  cudaError_t err = allow_smem(in_conv_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const unsigned blocks = (unsigned)((M + kInPixels - 1) / kInPixels);
  in_conv_kernel<T><<<blocks, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, H, W, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: x [B,H,W,C], w [3,3,C,3] and out [B,H,W,3] contiguous in one dtype
// (bf16 when is_bf16, else f32); scale and bias f32 [C]. C a multiple of 8
// and of G, at most 2048.
extern "C" int dmu_out_head(const void* x, const float* scale,
                            const float* bias, const void* w, void* out,
                            int B, int H, int W, int C, int G, float eps,
                            int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % 8 != 0 || C / 8 > kThreads ||
      G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_out_head<bf16>(x, scale, bias, w, out, B, H, W, C, G, eps,
                                 st);
  return launch_out_head<float>(x, scale, bias, w, out, B, H, W, C, G, eps,
                                st);
}

// K7: x [B,H,W,3], w [3,3,3,Cout] and out [B,H,W,Cout] contiguous in one
// dtype; Cout a multiple of 8.
extern "C" int dmu_in_conv(const void* x, const void* w, void* out, int B,
                           int H, int W, int Cout, int is_bf16,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_in_conv<bf16>(x, w, out, B, H, W, Cout, st);
  return launch_in_conv<float>(x, w, out, B, H, W, Cout, st);
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
