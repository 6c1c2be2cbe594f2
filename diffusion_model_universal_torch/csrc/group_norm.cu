// Fused GroupNorm(+per-sample time bias)(+SiLU) for Hopper: the forward
// (kernel K1) here, the backward (kernel K2) further down.
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

// ---------------------------------------------------------------------------
// Backward (kernel K2).
//
// Replaces the TPU kernel `_gn_bwd_kernel`
// (diffusion_model_universal_tpu/ops/group_norm.py:184, launched by
// `group_norm_silu_pallas_bwd` at :291), with the same math:
//   v = x + tb; mean, rstd of v per (row, group) in f32, variance clamped
//   at 0; xhat = (v - mean) * rstd
//   with SiLU: z = gamma*xhat + beta, dz = dy*sig(z)*(1 + z*(1 - sig(z)));
//   without:   dz = dy
//   dgamma = sum_{b,s} dz*xhat, dbeta = sum_{b,s} dz
//   dxhat = dz*gamma; dx = rstd*(dxhat - (sum_g dxhat + xhat*sum_g dxhat*xhat)/N)
//   dtb = sum_s dx
// x and dy are read in their dtype and everything is computed in f32; dx is
// stored in x's dtype, dgamma, dbeta and dtb in f32.
//
// What bounds it on an H100: memory. It must read x and dy once and write dx
// once, 3*B*S*C*itemsize bytes at 3.35 TB/s; about 30 flops per element are
// far below the card's compute rate.
//
// Design: one block per (group, batch row), as in K1, in three passes over
// the block's S x C/G slab (stats; the group sums of dxhat and dxhat*xhat
// with the per-channel dgamma/dbeta partials; the dx store with dtb). The
// second and third reads mostly hit the 50 MB L2. Threads are laid out as
// rows x channels (kThreads / cg rows of cg channels), so each thread keeps
// one channel for the whole block, whatever cg is (12 and 24 at C=384/768,
// G=32 do not divide a warp): its per-channel partials are plain registers,
// summed across the rows in shared memory in a fixed order.
// The Pallas kernel carries dgamma/dbeta across sequential grid steps in
// VMEM; Hopper blocks run in no order, so each block writes its [C/G]
// partials to a [B, C] f32 scratch, and a second small kernel sums the
// scratch over B in a fixed order. No atomics: the result is bit-
// reproducible. Not done yet: keeping the slab in shared memory or taking
// mean/rstd from the forward.

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // an earlier call may still be reading red
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {  // fixed order: every thread agrees
    a += red[w];
    b += red[kWarps + w];
  }
}

template <bool SILU>
__device__ __forceinline__ float grad_z(float xhat, float dy, float gam,
                                        float bet) {
  if (!SILU) return dy;
  const float z = gam * xhat + bet;
  const float sig = 1.f / (1.f + expf(-z));
  return dy * (sig * (1.f + z * (1.f - sig)));
}

template <typename T, bool HAS_TB, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ tb,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ part_gamma,
              float* __restrict__ part_beta, float* __restrict__ dtb, int S,
              int C, int G, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = C / G;
  const int rows = kThreads / cg;        // rows of the slab in flight
  const int j = threadIdx.x % cg;        // this thread's channel in the group
  const int r0 = threadIdx.x / cg;
  const bool active = r0 < rows;
  const int c = g * cg + j;
  const long long base = (long long)b * S * C + c;
  const float tbj = HAS_TB ? tb[(long long)b * C + c] : 0.f;
  const float n = (float)S * (float)cg;

  __shared__ float red[2 * kWarps];
  __shared__ float part[3][kThreads];

  // Pass 1: group statistics of v = x + tb.
  float s1 = 0.f, s2 = 0.f;
  if (active)
    for (int s = r0; s < S; s += rows) {
      const float v = to_f32(x[base + (long long)s * C]) + tbj;
      s1 += v;
      s2 += v * v;
    }
  block_sum2(s1, s2, red);
  const float mean = s1 / n;
  const float rstd = rsqrtf(fmaxf(s2 / n - mean * mean, 0.f) + eps);
  const float gam = gamma[c], bet = beta[c];

  // Pass 2: dgamma/dbeta partials of this channel; group sums of dxhat and
  // dxhat * xhat.
  float pg = 0.f, pb = 0.f, a1 = 0.f, a2 = 0.f;
  if (active)
    for (int s = r0; s < S; s += rows) {
      const long long idx = base + (long long)s * C;
      const float xhat = (to_f32(x[idx]) + tbj - mean) * rstd;
      const float dz = grad_z<SILU>(xhat, to_f32(dy[idx]), gam, bet);
      pg += dz * xhat;
      pb += dz;
      const float dxh = dz * gam;
      a1 += dxh;
      a2 += dxh * xhat;
    }
  block_sum2(a1, a2, red);

  // Pass 3: dx, and this channel's share of dtb = sum_s dx.
  float pt = 0.f;
  if (active)
    for (int s = r0; s < S; s += rows) {
      const long long idx = base + (long long)s * C;
      const float xhat = (to_f32(x[idx]) + tbj - mean) * rstd;
      const float dxh = grad_z<SILU>(xhat, to_f32(dy[idx]), gam, bet) * gam;
      const float d = rstd * (dxh - (a1 + xhat * a2) / n);
      dx[idx] = from_f32<T>(d);
      pt += d;
    }

  // Per-channel sums over the block's rows, in row order.
  part[0][threadIdx.x] = pg;
  part[1][threadIdx.x] = pb;
  part[2][threadIdx.x] = pt;
  __syncthreads();
  if (threadIdx.x < cg) {
    float sg = 0.f, sb = 0.f, st = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int t = r * cg + threadIdx.x;
      sg += part[0][t];
      sb += part[1][t];
      st += part[2][t];
    }
    const long long o = (long long)b * C + c;
    part_gamma[o] = sg;
    part_beta[o] = sb;
    if (dtb) dtb[o] = st;
  }
}

// dgamma[c] = sum_b part_gamma[b, c] (and dbeta), b in increasing order.
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const float* __restrict__ part_gamma,
                     const float* __restrict__ part_beta,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int B, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b) {
    sg += part_gamma[(long long)b * C + c];
    sb += part_beta[(long long)b * C + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

template <typename T>
void launch_bwd(const void* x, const float* tb, const float* gamma,
                const float* beta, const void* dy, void* dx, float* dgamma,
                float* dbeta, float* dtb, float* scratch, int B, int S,
                int C, int G, float eps, int silu, cudaStream_t stream) {
  const dim3 grid(G, B);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* pg = scratch;
  float* pb = scratch + (long long)B * C;
  if (tb && silu)
    gn_bwd_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, dyt, dxt, pg, pb, dtb, S, C, G, eps);
  else if (tb)
    gn_bwd_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, dyt, dxt, pg, pb, dtb, S, C, G, eps);
  else if (silu)
    gn_bwd_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, dyt, dxt, pg, pb, dtb, S, C, G, eps);
  else
    gn_bwd_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
        xt, tb, gamma, beta, dyt, dxt, pg, pb, dtb, S, C, G, eps);
  gn_bwd_reduce_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(pg, pb, dgamma, dbeta, B, C);
}

}  // namespace

// K2: dx (x's dtype), dgamma and dbeta (f32 [C]) and, when dtb is not null,
// dtb (f32 [B, C]). scratch is f32 [2, B, C]. One group may hold at most
// 256 channels.
extern "C" int dmu_group_norm_silu_bwd(const void* x, const float* tb,
                                       const float* gamma, const float* beta,
                                       const void* dy, void* dx,
                                       float* dgamma, float* dbeta,
                                       float* dtb, float* scratch, int B,
                                       int S, int C, int G, float eps,
                                       int apply_silu, int is_bf16,
                                       void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || C % G != 0 || C / G > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(x, tb, gamma, beta, dy, dx, dgamma, dbeta, dtb,
                              scratch, B, S, C, G, eps, apply_silu, st);
  else
    launch_bwd<float>(x, tb, gamma, beta, dy, dx, dgamma, dbeta, dtb,
                      scratch, B, S, C, G, eps, apply_silu, st);
  return (int)cudaGetLastError();
}

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
