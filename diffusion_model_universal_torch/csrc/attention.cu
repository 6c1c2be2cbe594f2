// Fused multi-head attention forward for Hopper:
//   out = softmax(q k^T * scale) v   per (batch, head), f32 logits and softmax.
//
// Replaces the TPU kernel `_mha_kernel`
// (diffusion_model_universal_tpu/ops/attention.py:38, launched by
// `mha_pallas` at :54): one (batch*head) tile per program, the whole S x S
// score matrix on chip, the row max subtracted before exp, f32 throughout,
// the result stored in q's dtype.
//
// Layout: q, k, v and out are [B, N, S, D] given by element strides for the
// batch, head and sequence axes, with unit stride on D. The UNet passes
// head-split views of its [B, S, N*D] projections, so no transpose copy is
// made on either side.
//
// What bounds it on an H100: at the UNet's shapes (S <= 64 tokens after the
// downsamples, D = 64 or 128) it does 4*S*S*D flops per (batch, head) on
// 4*S*D*itemsize bytes, at most ~32 flops per byte, so it is memory- and
// launch-bound, not compute-bound; tensor cores would not move it.
//
// Design: one block per (batch, head). It loads Q, K and V into shared memory
// as f32 with a padded row stride (D+1) to spread banks, computes the S x S
// logits with one thread per (row, column), runs the softmax with one warp
// per row (shuffle max and sum), then computes P*V with one thread per
// (row, d). Shared memory is 4*(3*S*(D+1) + S*S) bytes: 115 KB at S=64,
// D=128, past the default 48 KB, so the launcher raises the block's limit
// when needed. A shape that does not fit 227 KB is refused by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

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

struct Strides {
  long long b, n, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, Strides qs,
               Strides ks, Strides vs, Strides os, int N, int S, int D,
               float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;
  float* k_s = q_s + S * ld;
  float* v_s = k_s + S * ld;
  float* p_s = v_s + S * ld;  // [S, S] logits, then probabilities

  const int b = blockIdx.x / N;
  const int h = blockIdx.x - b * N;
  const T* qp = q + b * qs.b + h * qs.n;
  const T* kp = k + b * ks.b + h * ks.n;
  const T* vp = v + b * vs.b + h * vs.n;
  T* op = out + b * os.b + h * os.n;

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int s = i / D, d = i - s * D;
    q_s[s * ld + d] = to_f32(qp[s * qs.s + d]);
    k_s[s * ld + d] = to_f32(kp[s * ks.s + d]);
    v_s[s * ld + d] = to_f32(vp[s * vs.s + d]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int r = i / S, c = i - r * S;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += q_s[r * ld + d] * k_s[c * ld + d];
    p_s[i] = acc * scale;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < S; r += kThreads / 32) {
    float* row = p_s + r * S;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < S; c += 32) row[c] = row[c] / sum;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float acc = 0.f;
    for (int c = 0; c < S; ++c) acc += p_s[r * S + c] * v_s[c * ld + d];
    op[r * os.s + d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int N, int S, int D, float scale,
           size_t smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  mha_fwd_kernel<T><<<B * N, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, N, S,
      D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out in turn.
extern "C" int dmu_mha_fwd(const void* q, const void* k, const void* v,
                           void* out, const long long* strides, int B, int N,
                           int S, int D, float scale, int is_bf16,
                           void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)3 * S * (D + 1) + (size_t)S * S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, strides, B, N, S, D, scale,
                                 smem, st);
  return launch<float>(q, k, v, out, strides, B, N, S, D, scale, smem, st);
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
