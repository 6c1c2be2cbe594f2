// Fused GroupNorm(+per-sample time bias)(+SiLU) forward for Hopper.
//
// Replaces the TPU kernel `_gn_fwd_kernel`
// (diffusion_model_universal_tpu/ops/group_norm.py:167, launched by
// `group_norm_silu_pallas` at :252), with the same math:
//   v    = x + tb                      (tb: optional [B, C] time bias)
//   mean = E_group[v], var = max(E_group[v^2] - mean^2, 0)  (f32)
//   a    = rstd * gamma,  b = beta + (tb - mean) * a
//   out  = x * a + b, then optional SiLU, stored in x's dtype.
// The Pallas kernel folds tb into per-channel sums
// (sum v^2 = sum x^2 + 2 tb sum x + S tb^2); here each thread adds tb to the
// element it reads, which is the same sum taken before the expansion.
//
// Layout: x and out are channels-last [B, S = H*W, C], contiguous; gamma and
// beta are f32 [C]; tb is f32 [B, C] or null.
//
// What bounds it on an H100: memory. Per call it must read x once and write
// out once, 2*B*S*C*itemsize bytes at 3.35 TB/s; it does ~10 flops per
// element, far below the card's compute rate.
//
// Design: one thread block per (group, batch row), so a UNet call at B=16,
// G=32 gives 512 independent blocks to spread over 132 SMs (a Pallas grid
// step instead owned whole [R, S, C] planes in megabytes of VMEM). The block
// reads its group's S x C/G slab once to take f32 sums (warp shuffles, then
// shared memory across warps), then reads it again, now mostly from the
// 50 MB L2, to apply x*a+b (+SiLU) in f32 and store in x's dtype. Consecutive
// threads walk consecutive channels of a row, then the next row.
// Not done yet: vectorised 16-byte loads and keeping the slab in shared
// memory between the two passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool HAS_TB, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ tb,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ out, int S,
              int C, int G, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = C / G;
  const long long n = (long long)S * cg;
  const long long base = (long long)b * S * C + (long long)g * cg;
  const float* tb_g = HAS_TB ? tb + (long long)b * C + g * cg : nullptr;

  float s1 = 0.f, s2 = 0.f;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int s = (int)(i / cg);
    const int j = (int)(i - (long long)s * cg);
    float v = to_f32(x[base + (long long)s * C + j]);
    if (HAS_TB) v += tb_g[j];
    s1 += v;
    s2 += v * v;
  }

  __shared__ float red1[kThreads / 32], red2[kThreads / 32];
  __shared__ float stats[2];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red1[warp] = s1;
    red2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kThreads / 32 ? red1[lane] : 0.f;
    s2 = lane < kThreads / 32 ? red2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / (float)n;
      const float var = fmaxf(s2 / (float)n - mean * mean, 0.f);
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int s = (int)(i / cg);
    const int j = (int)(i - (long long)s * cg);
    const int c = g * cg + j;
    const float a = rstd * gamma[c];
    const float shift = HAS_TB ? tb_g[j] - mean : -mean;
    const float bb = beta[c] + shift * a;
    const long long idx = base + (long long)s * C + j;
    float y = to_f32(x[idx]) * a + bb;
    if (SILU) y = y / (1.f + expf(-y));
    out[idx] = from_f32<T>(y);
  }
}

template <typename T>
void launch(const void* x, const float* tb, const float* gamma,
            const float* beta, void* out, int B, int S, int C, int G,
            float eps, int silu, cudaStream_t stream) {
  const dim3 grid(G, B);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (tb && silu)
    gn_fwd_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, ot, S, C, G, eps);
  else if (tb)
    gn_fwd_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, ot, S, C, G, eps);
  else if (silu)
    gn_fwd_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, ot, S, C, G, eps);
  else
    gn_fwd_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, ot, S, C, G, eps);
}

}  // namespace

extern "C" int dmu_group_norm_silu_fwd(const void* x, const float* tb,
                                       const float* gamma, const float* beta,
                                       void* out, int B, int S, int C, int G,
                                       float eps, int apply_silu, int is_bf16,
                                       void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, tb, gamma, beta, out, B, S, C, G, eps,
                          apply_silu, st);
  else
    launch<float>(x, tb, gamma, beta, out, B, S, C, G, eps, apply_silu, st);
  return (int)cudaGetLastError();
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
