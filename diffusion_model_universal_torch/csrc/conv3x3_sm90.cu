// 3x3 SAME convolution, stride 1, bf16 NHWC activations x HWIO weights ->
// NHWC, for Hopper: kernel K5's route for the shapes it was sized for, an
// implicit GEMM fed by the Tensor Memory Accelerator (TMA) and multiplied
// by warpgroup MMAs (wgmma).
//
// Replaces the TPU kernels of scripts/exp_conv_kernel.py `_kernel` (:72,
// tap9) and `_kernel_k3` (:156, k3), launched by `conv3x3_pallas` (:179),
// for bf16 with Cin % 64 == 0, Cout % 128 == 0 and an image width that
// divides 256. ops/conv3x3.py::conv3x3_route picks this kernel; other bf16
// shapes keep the WMMA kernel of csrc/conv3x3.cu, and f32 keeps that file's
// CUDA-core kernel. K4, the fused affine+SiLU -> conv, has a route on the
// same pipeline further down (gn_silu_conv3x3_sm90_kernel).
//
// Same math: out[b,i,j,:] = sum_{ky,kx} x[b, i+ky-1, j+kx-1, :] . w[ky,kx],
// x taken as 0 outside the image, f32 accumulation, bf16 output. A GEMM of
// M = B*H*W output pixels, N = Cout, K = 9*Cin.
//
// What bounds it on an H100: operations. At the bench shape (B=2048,
// 32x32, 128->128) the GEMM is 0.62 TFLOP, 0.63 ms at 989 TFLOP/s; reading
// x and writing out is 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// Design:
// - A comes through TMA and the halo costs nothing. x is a 4-D tensor map
//   (innermost first: Cin, W, H, B), bf16, 128-byte swizzle. A 256-pixel
//   M tile is made of whole image rows: nb images of R rows of W pixels,
//   nb*R*W = 256 (nb = 1 when H*W >= 256). For tap (ky, kx) and channel
//   block c0 the producer loads the box [nb, R, W, 64] at (c0, kx-1,
//   y0+ky-1, b0). TMA fills the elements outside the tensor (negative
//   coordinates included) with zeros, so SAME padding needs no mask and no
//   padded copy, and the landed 256 x 64 tile is the K-major, 128B-swizzled
//   layout that wgmma's descriptor reads. Images past B are zeros too.
// - K is walked as (tap, c0): 9*Cin/64 steps of 64. That is the tap9 order;
//   for Cin % 64 == 0 the k3 order (3 rows of 3*Cin) visits the same K
//   indices in the same sequence, so both exported entry points launch
//   this one kernel and give identical results.
// - B is the weight as a K-major [Cout, 9*Cin] matrix (the wrapper makes
//   this 295 KB copy at 128->128), a 2-D tensor map with the same swizzle;
//   a stage holds its 128 x 64 box.
// - A ring of 4 stages of (A 32 KB + B 16 KB) with mbarrier full/empty
//   pairs. Warpgroup 0 is the producer: one thread issues
//   cp.async.bulk.tensor. Warpgroups 1 and 2 are the consumers: each owns
//   128 rows of the 256 x 128 tile and runs two wgmma m64n128k16 per k16,
//   keeping one group of wgmmas in flight and releasing a stage when its
//   group is done. setmaxnreg moves registers from the producer to the
//   consumers. Two m64 slices per consumer rather than one: each B tile
//   read from shared memory feeds twice the rows, and a tile's epilogue
//   is paid once per 256 rows.
// - Persistent: one block per SM walks the M x N tiles (N fastest, so
//   neighbouring blocks share A in L2); the producer fills the ring for the
//   next tile while the consumers store this one. The epilogue goes f32 ->
//   bf16 -> two 64 x 64 boxes per consumer in shared memory, 128B-swizzled
//   so the fragment writes hit 32 banks, -> TMA stores, which also clip the
//   rows past M; a consumer waits only for its previous store to have read
//   its boxes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128, BK = 64;
constexpr int kThreads = 384;               // producer WG + 2 consumer WGs
constexpr int kBBytes = BN * BK * 2;        // one B stage, 16 KB
constexpr int kEpiBox = 64 * 64 * 2;        // one 64 x 64 bf16 store box
constexpr int kEpiBytes = 2 * 2 * kEpiBox;  // 64 x 128 per consumer

// The M tile is 256 pixels: each consumer warpgroup owns kSlices slices of
// 64 rows.
constexpr int kSlices = 2;
constexpr int BM = 128 * kSlices;
constexpr int kStages = 4;
constexpr int kABytes = BM * BK * 2;            // one A stage, 32 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kEpiBytes + 2 * kStages * 8;

struct Params {
  long long M;      // B*H*W output pixels
  int HW, W;
  int cblocks;      // Cin / 64
  int k_steps;      // 9 * cblocks
  int n_tiles;      // Cout / BN
  int tiles;        // ceil(M / BM) * n_tiles
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`. A wait of more than
// 2^34 cycles (about 9 s) traps, so that a broken pipeline fails the launch
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Wait until the committed stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused by this layout),
// stride offset 1024 bytes (8 rows) >> 4, layout type 1 (SWIZZLE_128B).
// Stepping K by 16 bf16 (32 bytes) inside the swizzle atom adds 2.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, in the warpgroup's registers) += A (64 x 16) . B^T
// (128 x 16), both read from shared memory through their descriptors;
// scale_d = 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same product with A (64 x 16) from registers: each warp of the
// warpgroup holds rows 16 warp .. 16 warp + 15 in the mma.m16n8k16 A
// fragment layout (a0: row g, k 2tq..; a1: row g + 8; a2, a3: k + 8).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// Epilogue of consumer warpgroup c (thread ctid of 128) for M tile mt, N
// tile nt: one 64-row slice at a time, through two 64 x 64 boxes in the
// 128-byte swizzled layout the output's tensor map stores from.
// Accumulator 4j + 2h + e of a slice sits at row 16 warp + g + 8h and
// column 8j + 2tq + e: box j / 8, 16-byte chunk (j % 8) ^ g of that
// 128-byte row (row % 8 == g).
__device__ __forceinline__ void store_tile(float (&acc)[kSlices][64],
                                           const CUtensorMap* omap, int c,
                                           int ctid, uint32_t my_epi,
                                           uint8_t* my_epi_ptr, int mt,
                                           int nt) {
  const int warp = ctid / 32, lane = ctid % 32;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < kSlices; ++i) {
    if (ctid == 0) bulk_wait_read();   // the last store has read epi
    named_bar_sync(1 + c);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            my_epi_ptr + (j / 8) * kEpiBox + row * 128 +
            (((j % 8) ^ g) * 16) + tq * 4) =
            __floats2bfloat162_rn(acc[i][4 * j + 2 * h],
                                  acc[i][4 * j + 2 * h + 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_bar_sync(1 + c);
    if (ctid == 0) {
      const int row0 = (int)((long long)mt * BM) + 64 * (kSlices * c + i);
      tma_store_2d(omap, my_epi, nt * BN, row0);
      tma_store_2d(omap, my_epi + kEpiBox, nt * BN + 64, row0);
      bulk_commit();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap, Params p) {
  extern __shared__ uint8_t smem_raw[];
  // Swizzled TMA tiles need 1024-byte alignment.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // Stage s: A [BM x 64] at ring + s * kStageBytes, B [128 x 64] after it.
  const uint32_t ring = base;
  const int epi_off = kStages * kStageBytes;
  const uint32_t full0 = base + epi_off + kEpiBytes;   // full[kStages]
  const uint32_t empty0 = full0 + 8 * kStages;      // empty[kStages]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);     // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer. Only one thread issues; the roles never reconverge.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int mt = t / p.n_tiles, nt = t - mt * p.n_tiles;
        const long long m0 = (long long)mt * BM;
        const int b0 = (int)(m0 / p.HW);
        const int y0 = (int)(m0 - (long long)b0 * p.HW) / p.W;
        for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
          const int s = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          const uint32_t sa = ring + s * kStageBytes;
          mbar_wait(empty0 + 8 * s, phase ^ 1);
          mbar_expect_tx(full0 + 8 * s, kStageBytes);
          const int tap = ks / p.cblocks, cb = ks - tap * p.cblocks;
          tma_load_4d(sa, &xmap, full0 + 8 * s, cb * BK, tap % 3 - 1,
                      y0 + tap / 3 - 1, b0);
          tma_load_2d(sa + kABytes, &wmap, full0 + 8 * s, ks * BK,
                      nt * BN);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64 (kSlices c + i), i < kSlices, of
    // each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;
    const int ctid = tid - 128 * wg;
    const int lane = ctid % 32;
    const uint32_t my_epi = base + epi_off + c * 2 * kEpiBox;
    uint8_t* my_epi_ptr = gbase + epi_off + c * 2 * kEpiBox;
    float acc[kSlices][64];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
    uint32_t it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int mt = t / p.n_tiles, nt = t - mt * p.n_tiles;
      int prev = 0;
      for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t sa = ring + s * kStageBytes;
        const uint64_t db = desc_sw128(sa + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < kSlices; ++i)
            wgmma_m64n128k16(
                acc[i], desc_sw128(sa + (kSlices * c + i) * 64 * 128) + 2 * kk,
                db + 2 * kk, (ks > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();       // the previous step's group is done
        if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kSlices; ++i) fence_acc(acc[i]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      store_tile(acc, &omap, c, ctid, my_epi, my_epi_ptr, mt, nt);
    }
    if (ctid == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// K4 on this pipeline: out = conv3x3(silu(x * a + b)), a and b per (sample,
// channel), SAME padding applied to the activation (its halo is zero).
//
// Replaces the TPU kernel scripts/exp_conv_kernel.py `_kernel_fused` (:90,
// launched by `gn_silu_conv3x3_pallas` :125), whose point is that the
// activation never makes a round trip through HBM. The WMMA kernel of
// csrc/conv3x3.cu applies it on each of the 9 tap loads of every element;
// here each element of x is activated once per M tile and channel block.
//
// Design (ops/conv3x3.py::gn_silu_conv3x3_route picks it for K5's sm90
// shapes with one image a tile, W of at least 4, and the shared memory below
// within 227 KB: 32x32 and 16x16 images among them):
// - A unit is an M tile of R whole rows of one image (R W = 256) and a
//   64-channel block cb. One thread requests each unit's raw tile by TMA:
//   the box [R + 2, W, 64] of x from image row y0 - 1, unswizzled,
//   zero-filled past the image. Another fills a 3-stage ring with the 9
//   128 x 64 boxes of the K-major weight at column tap Cin + 64 cb, as K5.
// - The raw tile is activated once into an activated tile of (R + 2) rows x
//   (W + 2) pixels: silu(x a + b) in f32 from bf16, one bf16 rounding, zero
//   for the rows outside the image (x is zero there but silu(b) is not);
//   the first and last column are the zero halo, written once. Pixels are
//   144 bytes apart (64 channels + 16 bytes), so the 8 rows an ldmatrix
//   phase reads fall in 8 different bank groups. There are two activated
//   tiles: the next unit's is written while this unit's is read.
// - Two consumer warpgroups own 128 rows of the 256-pixel tile each and run
//   wgmma m64n128k16 with A from registers (the RS form): for tap (ky, kx)
//   each lane ldmatrix-es its A fragments at the pixel shifted by (ky, kx)
//   in the activated tile, so the 9 taps read one activated tile; B keeps
//   K5's descriptor path and mbarrier ring. f32 accumulation, K5's
//   epilogue (bf16 boxes, TMA stores).
// - The consumers activate the next unit themselves, a seventh of their
//   share after issuing each of taps 2 to 8 and before waiting for its
//   wgmmas, so the activation runs while the tensor cores work (a block's
//   first unit is activated before its first product). (Three
//   warps of their own activating alongside the consumers, tried first,
//   were the bottleneck: one warp a scheduler cannot hide the latency of
//   the exp and reciprocal chains.)
// Why RS rather than 3 kx-shifted swizzled copies of the tile for the SS
// form: one unswizzled copy is a third of the shared memory, which leaves
// room for two activated tiles (one being written, one being read).
//
// What bounds it on an H100: operations, as for K5 (the same GEMM), plus
// the one activation pass (about 10 operations an element of x, 2 of them
// on the special-function units), which runs beside the products.

constexpr int kGnStagesB = 3;
constexpr int kActPix = 144;   // bytes a pixel of the activated tile

__host__ __device__ constexpr long long gn_smem_bytes(int W, int R) {
  return 1024LL + (long long)kGnStagesB * kBBytes + kEpiBytes +
         (long long)(R + 2) * W * 128 + 2LL * (R + 2) * (W + 2) * kActPix +
         12 * 8;
}

struct GnParams {
  const bf16* a;      // [B, Cin]
  const bf16* b;      // [B, Cin]
  int H, W, R, Cin;
  int cblocks;        // Cin / 64
  int n_tiles;        // Cout / BN
  int tiles;          // (M / BM) * n_tiles
  int raw_bytes;      // (R + 2) * W * 128
  int act_bytes;      // (R + 2) * (W + 2) * kActPix
};

// Unit q of this block: its M tile (t), channel block and image rows.
struct GnUnit {
  int mt, nt, cb, b0, y0;
};
__device__ __forceinline__ GnUnit gn_unit(const GnParams& p, int q) {
  const int t = blockIdx.x + (q / p.cblocks) * gridDim.x;
  GnUnit u;
  u.mt = t / p.n_tiles;
  u.nt = t - u.mt * p.n_tiles;
  u.cb = q % p.cblocks;
  const int tiles_per_image = p.H / p.R;
  u.b0 = u.mt / tiles_per_image;
  u.y0 = (u.mt - u.b0 * tiles_per_image) * p.R;
  return u;
}

// Two bf16 of one 32-bit word as floats (exact), and back (rounded).
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float silu_f(float z) {
  return __fdividef(z, 1.f + __expf(-z));
}
// silu(x a + b) of the two bf16 in word u, with a and b the two bf16 of
// words a2 and b2 (one channel each): f32 math, one bf16 rounding.
__device__ __forceinline__ uint32_t act_pair(uint32_t u, uint32_t a2,
                                             uint32_t b2) {
  const float2 x = unpack_bf16(u), a = unpack_bf16(a2), b = unpack_bf16(b2);
  return pack_bf16(silu_f(fmaf(x.x, a.x, b.x)), silu_f(fmaf(x.y, a.y, b.y)));
}

// Activates the vector tasks k0 .. k1 - 1 of consumer thread gtid for a
// unit: task k is channels 8 (gtid % 8) .. + 7 of raw pixel gtid / 8 + 32 k
// (row rr = px / W, column j = px % W, image row y0 - 1 + rr), written to
// pixel (rr, j + 1) of the activated tile; zero for rows outside the image.
__device__ __forceinline__ void activate_tasks(
    const uint8_t* rawp, uint8_t* actp, int gtid, int k0, int k1, int npx,
    int W, int Wp, int y0, int H, const uint32_t (&ab)[8]) {
  const int v = gtid % 8;
  for (int k = k0; k < k1; ++k) {
    const int px = gtid / 8 + 32 * k;
    if (px >= npx) break;
    const int rr = px / W, j = px - rr * W;
    const int y = y0 - 1 + rr;
    uint4 outv = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < H) {
      const uint4 xv =
          *reinterpret_cast<const uint4*>(rawp + px * 128 + 16 * v);
      outv.x = act_pair(xv.x, ab[0], ab[4]);
      outv.y = act_pair(xv.y, ab[1], ab[5]);
      outv.z = act_pair(xv.z, ab[2], ab[6]);
      outv.w = act_pair(xv.w, ab[3], ab[7]);
    }
    *reinterpret_cast<uint4*>(actp + (rr * Wp + j + 1) * kActPix + 16 * v) =
        outv;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gn_silu_conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap omap,
                            GnParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw0);
  // B ring, epilogue boxes, raw tile, 2 activated tiles, barriers.
  const uint32_t ring = base;
  const int epi_off = kGnStagesB * kBBytes;
  const int raw_off = epi_off + kEpiBytes;
  const int act_off = raw_off + p.raw_bytes;
  const int bar_off = act_off + 2 * p.act_bytes;
  const uint32_t fullB = base + bar_off;            // [kGnStagesB]
  const uint32_t emptyB = fullB + 8 * kGnStagesB;   // [kGnStagesB]
  const uint32_t raw_full = emptyB + 8 * kGnStagesB;
  const uint32_t raw_empty = raw_full + 8;
  const uint32_t act_full = raw_empty + 8;          // [2]
  const uint32_t act_empty = act_full + 16;         // [2]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int my_tiles =
      blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * p.cblocks;
  const int Wp = p.W + 2;

  if (tid == 0) {
    for (int s = 0; s < kGnStagesB; ++s) {
      mbar_init(fullB + 8 * s, 1);
      mbar_init(emptyB + 8 * s, 8);
    }
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, 8);
    for (int s = 0; s < 2; ++s) {
      mbar_init(act_full + 8 * s, 8);
      mbar_init(act_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The halo columns of both activated tiles are zero for good.
  for (int i = tid; i < 2 * (p.R + 2) * 2 * 8; i += kThreads) {
    const int v = i % 8, side = (i / 8) % 2, row = (i / 16) % (p.R + 2),
              buf = i / (16 * (p.R + 2));
    *reinterpret_cast<uint4*>(gbase + act_off + buf * p.act_bytes +
                              (row * Wp + side * (p.W + 1)) * kActPix +
                              16 * v) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      // The 9 weight boxes of each unit, into the ring.
      uint32_t it = 0;
      for (int q = 0; q < units; ++q) {
        const GnUnit u = gn_unit(p, q);
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % kGnStagesB;
          mbar_wait(emptyB + 8 * s, ((it / kGnStagesB) & 1) ^ 1);
          mbar_expect_tx(fullB + 8 * s, kBBytes);
          tma_load_2d(ring + s * kBBytes, &wmap, fullB + 8 * s,
                      tap * p.Cin + u.cb * BK, u.nt * BN);
        }
      }
    } else if (tid == 32) {
      // The raw tile of each unit, once the consumers have activated the
      // previous one.
      for (int q = 0; q < units; ++q) {
        const GnUnit u = gn_unit(p, q);
        mbar_wait(raw_empty, (q & 1) ^ 1);
        mbar_expect_tx(raw_full, p.raw_bytes);
        tma_load_4d(base + raw_off, &xmap, raw_full, u.cb * BK, 0, u.y0 - 1,
                    u.b0);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64 (kSlices c + i), i < kSlices, of
    // each tile. Lane l of warp w loads A rows 16 w + l % 8 + 8 ((l / 8) % 2)
    // of each slice at k offset 8 (l / 16): pixel (r, j) = (row / W,
    // row % W) of the tile, read at (r + ky, j + kx) of the activated tile.
    // Between issuing a tap's wgmmas and waiting for them, each thread also
    // activates a share of the next unit's raw tile (taps 2 to 8), so the
    // activation runs while the tensor cores work.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;
    const int ctid = tid - 128 * wg;
    const int gtid = tid - 128;                 // 0 .. 255 over both groups
    const int warp = ctid / 32, lane = ctid % 32;
    const uint32_t my_epi = base + epi_off + c * 2 * kEpiBox;
    uint8_t* my_epi_ptr = gbase + epi_off + c * 2 * kEpiBox;
    const uint8_t* rawp = gbase + raw_off;
    const int npx = (p.R + 2) * p.W;
    const int tasks = (npx * 8 + 255) / 256;    // vector tasks a thread
    uint32_t pix[kSlices];
#pragma unroll
    for (int i = 0; i < kSlices; ++i) {
      const int row = 64 * (kSlices * c + i) + 16 * warp + lane % 8 +
                      8 * ((lane / 8) % 2);
      pix[i] = ((row / p.W) * Wp + row % p.W) * kActPix + 16 * (lane / 16);
    }
    // a and b of this thread's 8 channels for unit q, packed bf16 pairs.
    auto load_ab = [&](int q, uint32_t (&ab)[8]) {
      const GnUnit u = gn_unit(p, q);
      const long long ch = (long long)u.b0 * p.Cin + u.cb * BK + 8 * (gtid % 8);
      const uint4 av = *reinterpret_cast<const uint4*>(p.a + ch);
      const uint4 bv = *reinterpret_cast<const uint4*>(p.b + ch);
      ab[0] = av.x; ab[1] = av.y; ab[2] = av.z; ab[3] = av.w;
      ab[4] = bv.x; ab[5] = bv.y; ab[6] = bv.z; ab[7] = bv.w;
    };
    // Tell the raw producer and the readers of tile (q & 1) that this
    // warp's share of unit q is activated.
    auto activated = [&](int q) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(raw_empty);
        mbar_arrive(act_full + 8 * (q & 1));
      }
    };
    uint32_t ab[8];
    if (units > 0) {
      // Unit 0 before any product.
      load_ab(0, ab);
      mbar_wait(raw_full, 0);
      activate_tasks(rawp, gbase + act_off, gtid, 0, tasks, npx, p.W, Wp,
                     gn_unit(p, 0).y0, p.H, ab);
      activated(0);
    }
    float acc[kSlices][64];
#pragma unroll
    for (int i = 0; i < kSlices; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
    uint32_t it = 0;
    int q = 0;
    for (int k = 0; k < my_tiles; ++k) {
      int mt = 0, nt = 0;
      for (int cb = 0; cb < p.cblocks; ++cb, ++q) {
        const GnUnit u = gn_unit(p, q);
        mt = u.mt;
        nt = u.nt;
        const bool next = q + 1 < units;
        const int ny0 = next ? gn_unit(p, q + 1).y0 : 0;
        uint8_t* nact = gbase + act_off + ((q + 1) & 1) * p.act_bytes;
        mbar_wait(act_full + 8 * (q & 1), (q >> 1) & 1);
        const uint32_t act = base + act_off + (q & 1) * p.act_bytes;
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % kGnStagesB;
          const uint32_t shift = ((tap / 3) * Wp + tap % 3) * kActPix;
          uint32_t a[kSlices][4][4];
#pragma unroll
          for (int i = 0; i < kSlices; ++i)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              ldmatrix_x4(act + pix[i] + shift + 32 * kk, a[i][kk]);
          mbar_wait(fullB + 8 * s, (it / kGnStagesB) & 1);
          const uint64_t db = desc_sw128(ring + s * kBBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < kSlices; ++i)
              wgmma_m64n128k16_rs(acc[i], a[i][kk], db + 2 * kk,
                                  (cb > 0 || tap > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
          if (next) {
            if (tap == 0) load_ab(q + 1, ab);
            if (tap == 2) {
              mbar_wait(raw_full, (q + 1) & 1);
              // Tile (q + 1) & 1 was read by all warps for unit q - 1.
              mbar_wait(act_empty + 8 * ((q + 1) & 1), (((q + 1) >> 1) & 1) ^ 1);
            }
            if (tap >= 2)
              activate_tasks(rawp, nact, gtid, (tap - 2) * tasks / 7,
                             (tap - 1) * tasks / 7, npx, p.W, Wp, ny0, p.H,
                             ab);
            if (tap == 8) activated(q + 1);
          }
          wgmma_wait<0>();
          // The wgmmas read a and write acc asynchronously: keep both
          // live and unmoved up to here.
#pragma unroll
          for (int i = 0; i < kSlices; ++i) {
            fence_acc(acc[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                asm volatile("" : "+r"(a[i][kk][e])::"memory");
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(emptyB + 8 * s);
        }
        if (lane == 0) mbar_arrive(act_empty + 8 * (q & 1));
      }
      store_tile(acc, &omap, c, ctid, my_epi, my_epi_ptr, mt, nt);
    }
    if (ctid == 0) bulk_wait();
  }
}

// cuTensorMapEncodeTiled is a driver-API function; it is looked up in the
// driver library the CUDA runtime has already loaded, so the build needs no
// -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

bool encode_bf16(CUtensorMap* map, int rank, const void* ptr,
                 const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box,
                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "conv3x3_sm90: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "conv3x3_sm90: cuTensorMapEncodeTiled failed (%d)\n",
            (int)r);
    return false;
  }
  return true;
}

int launch(const void* x, const void* wk, void* out, int B, int H, int W,
           int Cin, int Cout, int R, int nb, void* stream) {
  // The tile must be whole rows of whole images: nb images of R rows.
  const bool tile_ok =
      nb >= 1 && R >= 1 && (long long)nb * R * W == BM &&
      ((nb == 1 && H % R == 0) || (nb > 1 && R == H));
  const long long M = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cin % BK != 0 || Cout % BN != 0 || !tile_ok || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;

  CUtensorMap xmap, wmap, omap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin * 2,
                                  (cuuint64_t)W * Cin * 2,
                                  (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)BK, (cuuint32_t)W, (cuuint32_t)R,
                              (cuuint32_t)nb};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * Cin, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * Cin * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint64_t odims[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t ostrides[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t obox[2] = {64, 64};
  if (!encode_bf16(&xmap, 4, x, xdims, xstrides, xbox) ||
      !encode_bf16(&wmap, 2, wk, wdims, wstrides, wbox) ||
      !encode_bf16(&omap, 2, out, odims, ostrides, obox))
    return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.M = M;
  p.HW = H * W;
  p.W = W;
  p.cblocks = Cin / BK;
  p.k_steps = 9 * p.cblocks;
  p.n_tiles = Cout / BN;
  const long long m_tiles = (M + BM - 1) / BM;
  if (m_tiles * p.n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)(m_tiles * p.n_tiles);
  const int grid = p.tiles < sms ? p.tiles : sms;
  conv3x3_sm90_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(xmap, wmap, omap,
                                                             p);
  return (int)cudaGetLastError();
}

int launch_gn(const void* x, const void* a, const void* b, const void* wk,
              void* out, int B, int H, int W, int Cin, int Cout, int R,
              int smem, void* stream) {
  // One image a tile: R whole rows of W pixels, R * W = 256, R | H.
  const long long M = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W < 4 || Cin <= 0 || Cout <= 0 ||
      Cin % BK != 0 || Cout % BN != 0 || R < 1 || (long long)R * W != BM ||
      H % R != 0 || M > 0x7fffffffLL || smem != gn_smem_bytes(W, R) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
       reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(wk) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;

  CUtensorMap xmap, wmap, omap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin * 2,
                                  (cuuint64_t)W * Cin * 2,
                                  (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)BK, (cuuint32_t)W,
                              (cuuint32_t)(R + 2), 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * Cin, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * Cin * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint64_t odims[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t ostrides[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t obox[2] = {64, 64};
  if (!encode_bf16(&xmap, 4, x, xdims, xstrides, xbox,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_bf16(&wmap, 2, wk, wdims, wstrides, wbox) ||
      !encode_bf16(&omap, 2, out, odims, ostrides, obox))
    return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_silu_conv3x3_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;

  GnParams p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.H = H;
  p.W = W;
  p.R = R;
  p.Cin = Cin;
  p.cblocks = Cin / BK;
  p.n_tiles = Cout / BN;
  const long long tiles = M / BM * p.n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.raw_bytes = (R + 2) * W * 128;
  p.act_bytes = (R + 2) * (W + 2) * kActPix;
  const int grid = p.tiles < sms ? p.tiles : sms;
  gn_silu_conv3x3_sm90_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, omap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// K4 on the TMA + wgmma route: out = conv3x3(silu(x * a + b)). x
// [B,H,W,Cin] and out [B,H,W,Cout] contiguous bf16; a, b [B, Cin] bf16;
// wk the K-major weight as for K5; the tile R rows x W pixels = 256 of one
// image, as ops/conv3x3.py::gn_silu_conv3x3_route gives it, and smem the
// shared bytes ops/conv3x3.py::gn_sm90_smem_bytes gives (refused unless it
// is this layout's).
extern "C" int dmu_gn_silu_conv3x3_sm90(const void* x, const void* a,
                                        const void* b, const void* wk,
                                        void* out, int B, int H, int W,
                                        int Cin, int Cout, int R, int smem,
                                        void* stream) {
  return launch_gn(x, a, b, wk, out, B, H, W, Cin, Cout, R, smem, stream);
}
// K5 on the TMA + wgmma route, tap-major K order. x [B,H,W,Cin] and out
// [B,H,W,Cout] contiguous bf16; wk the K-major weight [Cout, 9*Cin] bf16
// (row n holds w[ky,kx,ci,n] at column (ky*3 + kx)*Cin + ci); Cin % 64 == 0,
// Cout % 128 == 0; the tile nb images x R rows x W pixels = 256 pixels, as
// ops/conv3x3.py::conv3x3_route gives them.
extern "C" int dmu_conv3x3_sm90_tap9(const void* x, const void* wk, void* out,
                                     int B, int H, int W, int Cin, int Cout,
                                     int R, int nb, void* stream) {
  return launch(x, wk, out, B, H, W, Cin, Cout, R, nb, stream);
}

// K5 on the same route, row-major (k3) K order. With Cin % 64 == 0 its K
// sequence is the tap9 one, so it launches the same kernel.
extern "C" int dmu_conv3x3_sm90_k3(const void* x, const void* wk, void* out,
                                   int B, int H, int W, int Cin, int Cout,
                                   int R, int nb, void* stream) {
  return launch(x, wk, out, B, H, W, Cin, Cout, R, nb, stream);
}

extern "C" const char* dmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
