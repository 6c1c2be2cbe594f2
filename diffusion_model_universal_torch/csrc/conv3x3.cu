// 3x3 SAME convolution, stride 1, NHWC activations x HWIO weights -> NHWC,
// for Hopper: kernel K5 (`conv3x3`, in two K orders) and kernel K4
// (`gn_silu_conv3x3`, the same kernel with silu(x*a + b) applied to x as it
// is loaded).
//
// Replaces the TPU kernels of scripts/exp_conv_kernel.py:
//   K5 `_kernel` (:72, 9 shifted GEMMs of K = Cin, "tap9") and `_kernel_k3`
//      (:156, 3 row GEMMs of K = 3*Cin, "k3"), launched by `conv3x3_pallas`
//      (:179);
//   K4 `_kernel_fused` (:90), launched by `gn_silu_conv3x3_pallas` (:125).
// Same math: out[b,i,j,:] = sum_{ky,kx} y[b, i+ky-1, j+kx-1, :] . w[ky,kx],
// with y = x (K5) or y = silu(x*a[b] + b[b]) in x's dtype (K4), y taken as 0
// outside the image, products accumulated in f32 and stored in x's dtype.
// The HWIO weight is a row-major [K = 9*Cin, N = Cout] matrix whose row
// index is (ky*3 + kx)*Cin + ci, which is the order both Pallas bodies use.
//
// What bounds it on an H100: operations. An implicit GEMM of
// M = B*H*W output pixels, N = Cout, K = 9*Cin does 2*M*N*K flops; at the
// bench shape (B=2048, 32x32, 128->128, bf16) that is 0.62 TFLOP, 0.63 ms at
// 989 TFLOP/s, while reading x and writing out is 1.07 GB, 0.32 ms at
// 3.35 TB/s.
//
// Design (a first, simple kernel; wgmma, TMA and a deeper pipeline are later
// work):
// - bf16: tensor cores through WMMA (mma.sync, 16x16x16, f32 accumulators).
//   A block of 8 warps owns a 128 x 128 output tile (128 pixels, batch packed
//   into M, so H = 2 or 4 fills a tile as the Pallas reshape does); each warp
//   owns 32 x 64. K is walked in tiles of 32.
// - f32: CUDA cores in full f32 (never TF32): a block owns 64 x 64 outputs,
//   each thread 4 x 4, K in tiles of 16.
// - The A tile is gathered straight from x into shared memory: each 8-channel
//   (bf16) or 4-channel (f32) vector of a K tile lies within one tap, because
//   Cin is a multiple of 8, so it is one 16-byte load at a shifted pixel, or
//   zeros where the shifted pixel is outside the image. The padded input and
//   the im2col matrix never exist in device memory.
// - K4 applies silu(x*a + b) to each loaded vector, rounding after every
//   operation in x's dtype as the plain version (and XLA's unit) does, and
//   only to pixels inside the image: SAME pads y, not x, so a halo element is
//   0, not silu(b).
// - Tiles are double-buffered through registers: the next K tile is loaded
//   while the tensor cores work on the current one.
// - NCHUNK fixes the K loop's order, the one thing the two Pallas bodies
//   differ in: 9 chunks of Cin (tap9) or 3 chunks of 3*Cin (k3). A K tile
//   never straddles two chunks; a short last tile of a chunk is zero-masked.
// Not done yet: wgmma with TMA loads, a multi-stage shared-memory ring, and a
// persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;

struct Geom {
  long long M;  // B * H * W output pixels
  int H, W, Cin, Cout;
};

// The (b, y, x) of output pixel m, or b = -1 past the last pixel.
struct Pixel {
  int b, y, x;
};

__device__ __forceinline__ Pixel pixel_of(long long m, const Geom& g) {
  Pixel p{-1, 0, 0};
  if (m < g.M) {
    const int hw = g.H * g.W;
    p.b = (int)(m / hw);
    const int rem = (int)(m - (long long)p.b * hw);
    p.y = rem / g.W;
    p.x = rem - p.y * g.W;
  }
  return p;
}

// Offset in x of channel ci of the pixel that tap `tap` of output pixel p
// reads, or -1 where that pixel lies outside the image (or p is past M).
__device__ __forceinline__ long long tap_offset(const Pixel& p, int tap,
                                                int ci, const Geom& g) {
  if (p.b < 0) return -1;
  const int yy = p.y + tap / 3 - 1;
  const int xx = p.x + tap % 3 - 1;
  if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W) return -1;
  return (((long long)p.b * g.H + yy) * g.W + xx) * g.Cin + ci;
}

// K tile t of tiles TK deep, tiles_per_chunk of them in each chunk of
// chunk_len K indices: its first K index and the end of its chunk.
template <int TK>
__device__ __forceinline__ void k_tile(int t, int tiles_per_chunk,
                                       int chunk_len, int& k0, int& kend) {
  const int chunk = t / tiles_per_chunk;
  k0 = chunk * chunk_len + (t - chunk * tiles_per_chunk) * TK;
  kend = (chunk + 1) * chunk_len;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// silu(x*a + b) with a rounding to bf16 after each operation, as PyTorch's
// bf16 tensor ops (and the plain version) do.
__device__ __forceinline__ bf16 act_bf16(bf16 x, bf16 a, bf16 b) {
  float z = round_bf16(__bfloat162float(x) * __bfloat162float(a));
  z = round_bf16(z + __bfloat162float(b));
  const float s = round_bf16(1.f / (1.f + expf(-z)));
  return __float2bfloat16(z * s);
}

__device__ __forceinline__ float act_f32(float x, float a, float b) {
  const float z = x * a + b;
  return z * (1.f / (1.f + expf(-z)));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through WMMA.

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;   // bf16 elements per A row in shared memory
constexpr int LDB = BN + 8;   // bf16 elements per B row

template <int NCHUNK, bool FUSED>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                    const bf16* __restrict__ bsh,
                    const bf16* __restrict__ w, bf16* __restrict__ out,
                    Geom g) {
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) bf16 Bs[2][BK * LDB];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: 32 rows x 64 cols
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: vectors (row, kv) = (tid/4 + 64 i, tid%4), i = 0, 1.
  const int a_kv = tid % 4;
  Pixel a_pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) a_pix[i] = pixel_of(m0 + tid / 4 + 64 * i, g);
  // B loader: vectors (row, nv) = (tid/16 + 16 i, tid%16).
  const int b_nv = tid % 16;
  const bool b_col_ok = n0 + 8 * b_nv < g.Cout;

  const int chunk_len = 9 * g.Cin / NCHUNK;
  const int tiles_per_chunk = (chunk_len + BK - 1) / BK;
  const int ntiles = NCHUNK * tiles_per_chunk;

  uint4 ra[2], rb[2];
  auto load_tile = [&](int t) {
    int k0, kend;
    k_tile<BK>(t, tiles_per_chunk, chunk_len, k0, kend);
    const int k = k0 + 8 * a_kv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = make_uint4(0, 0, 0, 0);
      if (k < kend) {
        const int tap = k / g.Cin;
        const int ci = k - tap * g.Cin;
        const long long off = tap_offset(a_pix[i], tap, ci, g);
        if (off >= 0) {
          ra[i] = *reinterpret_cast<const uint4*>(x + off);
          if (FUSED) {
            const long long ab = (long long)a_pix[i].b * g.Cin + ci;
            const uint4 av = *reinterpret_cast<const uint4*>(a + ab);
            const uint4 bv = *reinterpret_cast<const uint4*>(bsh + ab);
            bf16* e = reinterpret_cast<bf16*>(&ra[i]);
            const bf16* ea = reinterpret_cast<const bf16*>(&av);
            const bf16* eb = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = act_bf16(e[j], ea[j], eb[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = k0 + tid / 16 + 16 * i;
      rb[i] = make_uint4(0, 0, 0, 0);
      if (kk < kend && b_col_ok)
        rb[i] = *reinterpret_cast<const uint4*>(
            w + (long long)kk * g.Cout + n0 + 8 * b_nv);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ar = tid / 4 + 64 * i, br = tid / 16 + 16 * i;
      *reinterpret_cast<uint4*>(&As[buf][ar * LDA + 8 * a_kv]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[buf][br * LDB + 8 * b_nv]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load_tile(t + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][(wm * 32 + i * 16) * LDA + kk],
                               LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][kk * LDB + wn * 64 + j * 16],
                               LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (t + 1 < ntiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: each 16x16 accumulator goes through the warp's scratch, then
  // each lane stores 8 consecutive channels of one pixel (16 bytes).
  float* scr = scratch[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c8;
      if (m < g.M && n < g.Cout) {
        uint4 v;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = __float2bfloat16(scr[r * 16 + c8 + q]);
        *reinterpret_cast<uint4*>(out + m * g.Cout + n) = v;
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32.

constexpr int FM = 64, FN = 64, FK = 16;

template <int NCHUNK, bool FUSED>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ bsh,
                   const float* __restrict__ w, float* __restrict__ out,
                   Geom g) {
  __shared__ __align__(16) float As[2][FK][FM + 4];  // k-major
  __shared__ __align__(16) float Bs[2][FK][FN + 4];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  // A loader: one 4-channel vector (row, kv) = (tid/4, tid%4).
  const int a_row = tid / 4, a_kv = tid % 4;
  const Pixel a_pix = pixel_of(m0 + a_row, g);
  // B loader: one vector (row, nv) = (tid/16, tid%16).
  const int b_row = tid / 16, b_nv = tid % 16;
  const bool b_col_ok = n0 + 4 * b_nv < g.Cout;

  const int chunk_len = 9 * g.Cin / NCHUNK;
  const int tiles_per_chunk = (chunk_len + FK - 1) / FK;
  const int ntiles = NCHUNK * tiles_per_chunk;

  float4 ra, rb;
  auto load_tile = [&](int t) {
    int k0, kend;
    k_tile<FK>(t, tiles_per_chunk, chunk_len, k0, kend);
    const int k = k0 + 4 * a_kv;
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < kend) {
      const int tap = k / g.Cin;
      const int ci = k - tap * g.Cin;
      const long long off = tap_offset(a_pix, tap, ci, g);
      if (off >= 0) {
        ra = *reinterpret_cast<const float4*>(x + off);
        if (FUSED) {
          const long long ab = (long long)a_pix.b * g.Cin + ci;
          const float4 av = *reinterpret_cast<const float4*>(a + ab);
          const float4 bv = *reinterpret_cast<const float4*>(bsh + ab);
          ra.x = act_f32(ra.x, av.x, bv.x);
          ra.y = act_f32(ra.y, av.y, bv.y);
          ra.z = act_f32(ra.z, av.z, bv.z);
          ra.w = act_f32(ra.w, av.w, bv.w);
        }
      }
    }
    const int kk = k0 + b_row;
    rb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kk < kend && b_col_ok)
      rb = *reinterpret_cast<const float4*>(w + (long long)kk * g.Cout + n0 +
                                            4 * b_nv);
  };
  auto store_tile = [&](int buf) {
    As[buf][4 * a_kv + 0][a_row] = ra.x;
    As[buf][4 * a_kv + 1][a_row] = ra.y;
    As[buf][4 * a_kv + 2][a_row] = ra.z;
    As[buf][4 * a_kv + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_row][4 * b_nv]) = rb;
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load_tile(t + 1);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    if (t + 1 < ntiles) store_tile(buf ^ 1);
    __syncthreads();
  }
  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m < g.M && n < g.Cout)
      *reinterpret_cast<float4*>(out + m * g.Cout + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int NCHUNK, bool FUSED>
int launch(const void* x, const void* a, const void* b, const void* w,
           void* out, int B, int H, int W, int Cin, int Cout, int is_bf16,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 != 0 ||
      Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Geom g{(long long)B * H * W, H, W, Cin, Cout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((unsigned)((g.M + BM - 1) / BM), (Cout + BN - 1) / BN);
    conv3x3_bf16_kernel<NCHUNK, FUSED><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(a),
        static_cast<const bf16*>(b), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), g);
  } else {
    const dim3 grid((unsigned)((g.M + FM - 1) / FM), (Cout + FN - 1) / FN);
    conv3x3_f32_kernel<NCHUNK, FUSED><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(w),
        static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K5, tap-major K order. x [B,H,W,Cin], w [3,3,Cin,Cout], out [B,H,W,Cout],
// all contiguous, of one dtype (bf16 when is_bf16, else f32); Cin and Cout
// multiples of 8.
extern "C" int dmu_conv3x3_tap9(const void* x, const void* w, void* out,
                                int B, int H, int W, int Cin, int Cout,
                                int is_bf16, void* stream) {
  return launch<9, false>(x, nullptr, nullptr, w, out, B, H, W, Cin, Cout,
                          is_bf16, stream);
}

// K5, row-major K order (3 chunks of 3*Cin); arguments as above.
extern "C" int dmu_conv3x3_k3(const void* x, const void* w, void* out, int B,
                              int H, int W, int Cin, int Cout, int is_bf16,
                              void* stream) {
  return launch<3, false>(x, nullptr, nullptr, w, out, B, H, W, Cin, Cout,
                          is_bf16, stream);
}

// K4: conv3x3(silu(x * a + b)) in the tap-major order; a and b are [B, Cin]
// in x's dtype.
extern "C" int dmu_gn_silu_conv3x3(const void* x, const void* a,
                                   const void* b, const void* w, void* out,
                                   int B, int H, int W, int Cin, int Cout,
                                   int is_bf16, void* stream) {
  return launch<9, true>(x, a, b, w, out, B, H, W, Cin, Cout, is_bf16,
                         stream);
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
