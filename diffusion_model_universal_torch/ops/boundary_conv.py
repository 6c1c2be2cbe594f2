"""The UNet's boundary convolutions: the output head (GroupNorm, SiLU and a
3×3 conv C→Cout in one kernel) and the input conv (3×3, 3→C). NHWC × HWIO.

Counterpart of the reference's ``scripts/exp_boundary_kernel.py``:

* :func:`out_head_plain` — plain PyTorch, the arithmetic of
  ``_kernel_out_head``: group statistics in f32 (:func:`group_affine` of
  ``ops/group_norm.py``), the apply and SiLU in f32, y rounded once to x's
  dtype, then :func:`conv3x3_plain`. The oracle of kernel K6, which runs
  on three routes that :func:`out_head_route` picks from the shapes and
  dtype: ``"sm90"`` (``csrc/out_head_sm90.cu``: a thread block cluster
  reads each sample once into shared memory and shares its statistics,
  and the conv is one tensor-core product of y by the packed weight of
  :func:`pack_out_head_weight`, the 9 taps × Cout as its columns, then a
  3×3 sum; bf16 with C a multiple of 64 whose sample fits an 8-block
  cluster), ``"simt"`` (``csrc/boundary_conv.cu``, the CUDA-core kernel:
  other bf16 shapes) and ``"f32"`` (the same kernel in f32). Each route
  has its own launch count. :func:`out_head_launch_plan` cuts a call for
  the sm90 route; the C entry checks the plan and computes none of its
  own.
* :func:`in_conv_plain` — the 27-column im2col matrix times w [27, Cout]
  in f32, the arithmetic of ``_kernel_in_conv``; the oracle of kernel K7
  (``csrc/boundary_conv.cu``), which runs bf16 on the tensor cores
  (``mma.sync``, K padded to 32 with the weight packed by
  :func:`pack_in_conv_weight`) and f32 on the CUDA cores in full f32, each
  path with its own launch count.
* :func:`out_head_conv2d` — the experiment CLI's out-head baseline, the
  port of ``out_head_xla``: ``group_norm_silu_plain`` (the port of
  ``group_norm_silu_xla``), then ``F.conv2d``. The in-conv baseline is
  :func:`conv3x3_conv2d`, as the reference's is ``conv3x3_xla``. No kernel
  path calls them.

:func:`out_head` and :func:`in_conv` route a CPU tensor to the plain
version and a CUDA tensor to the kernel; there is no fallback between
them. The out-head takes Cout from 1 to 7 on every route.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import Kernel
from .conv3x3 import conv3x3_conv2d, conv3x3_plain
from .group_norm import (MAX_CLUSTER, MAX_SMEM_BYTES, NUM_SMS, group_affine,
                         group_norm_silu_plain)

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

#: K6's routes: the cluster + tensor-core kernel, and the CUDA-core kernel
#: in bf16 and in f32.
OUT_HEAD_ROUTES = ("sm90", "simt", "f32")
_SIMT_ARGS = [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, scale, bias, w, out
    _INT, _INT, _INT, _INT, _INT, _INT,     # B, H, W, C, G, Cout
    ctypes.c_float, _INT, _VOID,            # eps, is_bf16, stream
]
_SM90_ARGS = [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, scale, bias, packed w, out
    _INT, _INT, _INT, _INT, _INT, _INT,     # B, H, W, C, G, Cout
    ctypes.c_float,                         # eps
    _INT, _INT, _INT, _INT, _INT, _INT,     # the plan: cluster, rows,
    _VOID,                                  # threads, m tiles, P stride,
]                                           # shared bytes; stream
#: Kernel K6 by route; ``OUT_HEAD_KERNELS[r].launches`` counts the
#: launches of route r. The simt and f32 routes are two dtypes of one C
#: symbol, counted apart.
OUT_HEAD_KERNELS = {
    "sm90": Kernel("out_head_sm90", "dmu_out_head_sm90", _SM90_ARGS),
    **{r: Kernel("boundary_conv", "dmu_out_head", _SIMT_ARGS,
                 name=f"dmu_out_head[{r}]") for r in ("simt", "f32")},
}
#: Kernel K7 in f32 (CUDA cores); ``IN_CONV_KERNEL.launches`` counts its
#: launches.
IN_CONV_KERNEL = Kernel("boundary_conv", "dmu_in_conv", [
    _VOID, _VOID, _VOID,                    # x, w, out
    _INT, _INT, _INT, _INT,                 # B, H, W, Cout
    _INT, _VOID,                            # is_bf16 (0), stream
])
#: Kernel K7 in bf16 (tensor cores); ``IN_CONV_MMA_KERNEL.launches``.
IN_CONV_MMA_KERNEL = Kernel("boundary_conv", "dmu_in_conv_mma", [
    _VOID, _VOID, _VOID,                    # x, packed w, out
    _INT, _INT, _INT, _INT,                 # B, H, W, Cout
    _VOID,                                  # stream
])
#: K7's bf16 K: the 27 im2col columns padded to two k16 steps.
IN_CONV_K = 32

#: The out-head's widest output: 9 taps × 7 fill the sm90 route's 64
#: columns.
MAX_COUT = 7
MAX_C = 2048
#: The sm90 route: the block sizes its plan weighs (about 128 and 256
#: threads) and the most it takes. Its kernel is bound by latency (each
#: sample's statistics, barrier, product and sum in turn), which resident
#: blocks hide for one another, so the plan takes the cut that keeps the
#: most blocks on an SM: 228 KB of shared memory an SM, 1 KB of it reserved
#: for each block, and 64K registers, of which a thread may take up to 128
#: (the kernel's ``__launch_bounds__`` of 512 threads).
SM90_THREADS = (128, 256)
SM90_MAX_THREADS = 512
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
SM_REGISTERS = 65536
SM90_REGISTERS = 128
#: Channels a 128-byte swizzle row of the sm90 route's shared tiles holds.
SM90_C_STEP = 64

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def out_head_smem_bytes(w: int, c: int, g: int, cout: int) -> int:
    """Shared memory of one block of the CUDA-core K6 (routes simt and
    f32): the weight in f32 [C, 9·Cout], four [C] and two [G] vectors,
    and the larger of the statistics' partial sums (2 × 256 × 8) and the
    ring of 3 rows of 9·Cout partial products."""
    taps = 9 * cout
    return 4 * (taps * c + 4 * c + 2 * g + max(2 * 256 * 8, 3 * w * taps))


def in_conv_smem_bytes(cout: int) -> int:
    """Shared memory of one K7 block: the weight in f32 [27, Cout] and the
    27 inputs of each of its 256 pixels."""
    return 4 * (27 * cout + 256 * 27)


def out_head_columns(cout: int) -> int:
    """The sm90 route's product width: the 9·Cout columns of the packed
    weight padded to 16, 32 or 64 (2, 4 or 8 n-tiles of 8)."""
    for n in (16, 32, 64):
        if 9 * cout <= n:
            return n
    raise ValueError(f"the out-head takes Cout up to {MAX_COUT}, got {cout}")


@dataclass(frozen=True)
class OutHeadPlan:
    """How K6's sm90 route cuts one call (see ``csrc/out_head_sm90.cu``):
    persistent clusters of ``cluster`` blocks, each cluster taking a sample
    at a time, rank r holding its image rows [r·rows, (r+1)·rows) in
    one band buffer of shared memory (the next sample's copy starts once
    the product has read it); ``threads`` a block (a multiple of
    C/8, so a thread always copies and sums the same 8 channels); the
    product has ``columns`` columns, ``mtiles`` m16 tiles a warp at once,
    and its f32 result P is stored column-major with ``p_stride`` pixels a
    column; ``smem_bytes`` of dynamic shared memory a block. The C entry
    launches as many clusters as the card holds at once, at most B."""
    cluster: int
    rows: int
    threads: int
    mtiles: int
    columns: int
    p_stride: int
    smem_bytes: int

    def launch_args(self) -> Tuple[int, ...]:
        return (self.cluster, self.rows, self.threads, self.mtiles,
                self.p_stride, self.smem_bytes)

    def describe(self) -> str:
        return (f"clusters of {self.cluster} blocks x {self.rows} rows, "
                f"{self.threads} threads, {self.columns} columns, {self.mtiles} m16 tile(s) a warp, "
                f"P stride {self.p_stride}, smem {self.smem_bytes} B")


def out_head_sm90_threads(c: int) -> Tuple[int, ...]:
    """The block sizes the sm90 plan weighs: whole warps and whole rows of
    C/8 16-byte vectors, near each of :data:`SM90_THREADS`, at most
    :data:`SM90_MAX_THREADS` (none where a row of vectors and a warp need
    more)."""
    cv = c // 8
    unit = cv * 32 // math.gcd(cv, 32)
    sizes = {unit * max(1, t // unit) for t in SM90_THREADS}
    return tuple(sorted(t for t in sizes if t <= SM90_MAX_THREADS))


def out_head_blocks_per_sm(smem_bytes: int, threads: int) -> int:
    """Blocks of the sm90 route an SM holds at once, by shared memory and
    by registers."""
    return min(SM_SMEM_BYTES // (smem_bytes + BLOCK_RESERVED_SMEM),
               SM_REGISTERS // (threads * SM90_REGISTERS))


def out_head_mtiles(npix: int, threads: int, columns: int) -> int:
    """m16 tiles a warp multiplies at once on the sm90 route: two (each B
    fragment read from shared memory then feeds 32 pixels) where their
    accumulators fit (≤ 32 columns) and every warp still gets a group of
    32 of the band's ``npix`` pixels; else one."""
    if columns <= 32 and -(-npix // 32) >= threads // 32:
        return 2
    return 1


def out_head_p_stride(npix: int, mtiles: int) -> int:
    """Pixels a column of P holds: the band's pixels rounded up to the
    warps' groups of m16 tiles, then to 4 more than a multiple of 32, so
    that the accumulators' stores and the 3×3 sum's reads meet no bank
    conflict."""
    group = 16 * mtiles
    m = -(-npix // group) * group
    return m + (4 - m) % 32


def _round128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def out_head_sm90_smem_bytes(rows: int, wd: int, c: int, columns: int,
                             p_stride: int, threads: int, cout: int) -> int:
    """Shared memory of one sm90 block, as ``csrc/out_head_sm90.cu``'s
    ``layout_of`` lays it out: the band buffer of x (bf16), the
    packed weight (bf16), P (f32, its 9·Cout columns), the statistics'
    partials (two per channel of each thread row, later the cluster's
    totals), the published sums of two samples, the halo rows of P of two
    samples (two rows of W pixels × 3·Cout taps), then the affine and the
    scale and bias, each 2·C f32. Each region starts at a multiple of 128
    bytes."""
    return (rows * wd * c * 2 + columns * c * 2
            + _round128(9 * cout * p_stride * 4) + 2 * threads * 8 * 4
            + 2 * 2 * c * 4 + _round128(2 * 2 * wd * 3 * cout * 4)
            + 2 * 2 * c * 4)


def out_head_launch_plan(b: int, h: int, wd: int, c: int, g: int,
                         cout: int) -> OutHeadPlan:
    """The sm90 route's launch for x [B, H, W, C] in bf16, G groups, Cout
    outputs. A cluster of 1, 2, 4 or 8 blocks takes a sample at a time,
    rows split evenly with none left empty. Of the clusters and block
    sizes (:func:`out_head_sm90_threads`) that fit 227 KB, the plan takes
    the one that keeps the most blocks on an SM
    (:func:`out_head_blocks_per_sm`), then more threads, then the smaller
    cluster; the cluster larger while the batch
    alone does not cover the SMs. Raises ``ValueError`` for what the route
    does not take: C not a multiple of 64 or over 2048, Cout outside 1–7,
    or a band that no 8-block cluster fits into 227 KB."""
    if min(b, h, wd) <= 0 or g <= 0 or c % g:
        raise ValueError(f"bad out-head shape B={b} H={h} W={wd} C={c} "
                         f"G={g}")
    if c % SM90_C_STEP or c > MAX_C:
        raise ValueError(f"the sm90 route takes C a multiple of "
                         f"{SM90_C_STEP} up to {MAX_C}, got C={c}")
    if not 1 <= cout <= MAX_COUT:
        raise ValueError(f"the out-head takes Cout from 1 to {MAX_COUT}, "
                         f"got {cout}")
    sizes = out_head_sm90_threads(c)
    if not sizes:
        raise ValueError(f"C={c}: a block of whole warps and whole rows "
                         f"of C/8 vectors exceeds {SM90_MAX_THREADS} "
                         f"threads")
    columns = out_head_columns(cout)
    best = {}   # the best plan of each cluster size
    for cl in (1, 2, 4, 8):
        rows = -(-h // cl)
        if cl > h or (cl - 1) * rows >= h:
            continue
        for threads in sizes:
            mt = out_head_mtiles(rows * wd, threads, columns)
            stride = out_head_p_stride(rows * wd, mt)
            smem = out_head_sm90_smem_bytes(rows, wd, c, columns, stride,
                                            threads, cout)
            if smem > MAX_SMEM_BYTES:
                continue
            plan = OutHeadPlan(cl, rows, threads, mt, columns, stride, smem)
            key = (out_head_blocks_per_sm(smem, threads), threads)
            if cl not in best or key > best[cl][0]:
                best[cl] = (key, plan)
    if not best:
        raise ValueError(f"the sm90 route cannot hold a band of H={h}, "
                         f"W={wd}, C={c} in {MAX_SMEM_BYTES} bytes with "
                         f"a cluster of at most {MAX_CLUSTER}")
    order = sorted(best)
    i = max(range(len(order)), key=lambda k: (best[order[k]][0], -k))
    while b * order[i] < NUM_SMS and i + 1 < len(order):
        i += 1
    return best[order[i]][1]


def out_head_route(x_shape, w_shape, num_groups: int,
                   dtype: torch.dtype) -> str:
    """Which kernel K6 runs for x [B, H, W, C] and w [3, 3, C, Cout] of
    ``dtype`` in ``num_groups`` groups: ``"sm90"`` for bf16 where
    :func:`out_head_launch_plan` takes the shape, else ``"simt"`` for
    bf16 and ``"f32"`` for float32, where the CUDA-core kernel's block
    fits (:func:`out_head_smem_bytes`). Raises ValueError for what no
    route takes: C not a multiple of 8 and of the groups or over 2048,
    Cout outside 1–7, another dtype, or a CUDA-core block over 227 KB."""
    if len(x_shape) != 4 or len(w_shape) != 4 or \
            tuple(w_shape[:3]) != (3, 3, x_shape[-1]):
        raise ValueError(f"x must be [B, H, W, C] and w [3, 3, C, Cout], "
                         f"got {tuple(x_shape)} and {tuple(w_shape)}")
    b, h, wd, c = (int(v) for v in x_shape)
    cout = int(w_shape[-1])
    if c % 8 or num_groups <= 0 or c % num_groups or c > MAX_C:
        raise ValueError(f"K6 takes C a multiple of 8 and of num_groups, "
                         f"at most {MAX_C}; got C={c}, "
                         f"num_groups={num_groups}")
    if not 1 <= cout <= MAX_COUT:
        raise ValueError(f"K6 takes Cout from 1 to {MAX_COUT}, got {cout}")
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16:
        try:
            out_head_launch_plan(b, h, wd, c, num_groups, cout)
            return "sm90"
        except ValueError:
            pass
    smem = out_head_smem_bytes(wd, c, num_groups, cout)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K6's CUDA-core kernel would need {smem} bytes of "
                         f"shared memory at W={wd}, C={c}, Cout={cout}")
    return "f32" if dtype == torch.float32 else "simt"


def pack_out_head_weight(w: torch.Tensor) -> torch.Tensor:
    """The sm90 route's B operand: w [3, 3, C, Cout] as the K-major matrix
    Wtᵀ [columns, C] bf16, row (ky·3 + kx)·Cout + k holding
    w[ky, kx, :, k] and the rows past 9·Cout zero (:func:`out_head_columns`)."""
    c, cout = w.shape[2], w.shape[3]
    packed = w.new_zeros((out_head_columns(cout), c), dtype=torch.bfloat16)
    packed[:9 * cout] = w.reshape(9, c, cout).permute(0, 2, 1).reshape(
        9 * cout, c)
    return packed


def out_head_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   w: torch.Tensor, num_groups: int = 32,
                   eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups) → SiLU → 3×3 conv C→Cout, as
    ``_kernel_out_head``: f32 statistics and apply, y rounded once to x's
    dtype, f32 accumulation."""
    a, b = group_affine(x, scale, bias, num_groups, eps=eps)
    z = x.to(a.dtype) * a[:, None, None, :] + b[:, None, None, :]
    y = (z * torch.sigmoid(z)).to(x.dtype)
    return conv3x3_plain(y, w, "tap9")


def out_head_conv2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    w: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """The unfused unit, the port of ``out_head_xla``."""
    return conv3x3_conv2d(group_norm_silu_plain(x, scale, bias, num_groups),
                          w)


def in_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv of [B, H, W, 3] by [3, 3, 3, Cout] as one matmul of
    the explicit im2col matrix [B·H·W, 27] (column (ky·3 + kx)·3 + ci) by
    w [27, Cout], in f32, stored in x's dtype."""
    b, h, wd, c = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + h, kx:kx + wd, :]
                      for ky in range(3) for kx in range(3)], dim=-1)
    out = cols.reshape(-1, 9 * c) @ w.to(acc).reshape(9 * c, -1)
    return out.reshape(b, h, wd, -1).to(x.dtype)


def pack_in_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """K7's bf16 B operand: w [3, 3, 3, Cout] as [32, Cout] bf16, row
    (ky·3 + kx)·3 + ci holding w[ky, kx, ci, :] and rows 27–31 zero."""
    cout = w.shape[-1]
    packed = w.new_zeros((IN_CONV_K, cout), dtype=torch.bfloat16)
    packed[:27] = w.reshape(27, cout)
    return packed


def _check_dtype_device(x, w, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w must match x: {w.dtype} on {w.device} vs "
                         f"{x.dtype} on {x.device}")


def check_in_conv_shapes(x, w) -> None:
    """Raise ValueError unless K7 takes these shapes: x [B, H, W, 3], w
    [3, 3, 3, Cout] with Cout a multiple of 8 that fits shared memory."""
    if x.dim() != 4 or x.shape[-1] != 3 or w.dim() != 4 or \
            tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"x must be [B, H, W, 3] and w [3, 3, 3, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cout = w.shape[-1]
    if cout % 8 or in_conv_smem_bytes(cout) > MAX_SMEM_BYTES:
        raise ValueError(f"K7 takes Cout a multiple of 8 up to "
                         f"{MAX_SMEM_BYTES // 4 // 27 - 256}, got {cout}")


def out_head_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  w: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
                  route: str = "") -> torch.Tensor:
    """Launch kernel K6 on the route :func:`out_head_route` picks; scale
    and bias [C] are cast to f32 here. ``route="simt"`` runs a bf16 shape
    of the sm90 route on the CUDA-core kernel instead (to time it beside
    the sm90 route); any other choice than the router's raises
    ValueError."""
    picked = out_head_route(x.shape, w.shape, num_groups, x.dtype)
    _check_dtype_device(x, w, "out_head_cuda")
    if route and route != picked and not (route, picked) == ("simt",
                                                             "sm90"):
        raise ValueError(f"route {route!r} does not take this call (the "
                         f"router picks {picked!r})")
    route = route or picked
    if route == "simt" and out_head_smem_bytes(
            x.shape[2], x.shape[3], num_groups, w.shape[3]) > MAX_SMEM_BYTES:
        raise ValueError("the CUDA-core kernel's block does not fit this "
                         "shape")
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    x = x.contiguous()
    if x.data_ptr() % 16:   # the sm90 route copies 16-byte vectors
        x = x.clone()
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be [{c}]")
    out = x.new_empty((b, h, wd, cout))
    if not out.numel():
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel = OUT_HEAD_KERNELS[route]
    if route == "sm90":
        plan = out_head_launch_plan(b, h, wd, c, num_groups, cout)
        wt = pack_out_head_weight(w)
        kernel(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               wt.data_ptr(), out.data_ptr(), b, h, wd, c, num_groups, cout,
               float(eps), *plan.launch_args(), stream)
    else:
        w = w.contiguous()
        kernel(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               w.data_ptr(), out.data_ptr(), b, h, wd, c, num_groups, cout,
               float(eps), int(x.dtype == torch.bfloat16), stream)
    return out


def in_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch kernel K7: bf16 on the tensor cores, f32 on the CUDA cores."""
    check_in_conv_shapes(x, w)
    _check_dtype_device(x, w, "in_conv_cuda")
    b, h, wd, _ = x.shape
    cout = w.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x = x.contiguous()
    out = x.new_empty((b, h, wd, cout))
    if not out.numel():
        return out
    if x.dtype == torch.bfloat16:
        wp = pack_in_conv_weight(w)
        IN_CONV_MMA_KERNEL(x.data_ptr(), wp.data_ptr(), out.data_ptr(), b, h,
                           wd, cout, stream)
    else:
        w = w.contiguous()
        IN_CONV_KERNEL(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd,
                       cout, 0, stream)
    return out


def out_head(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             w: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """The output head: plain version for a CPU tensor, K6 for CUDA. On
    either device it raises ValueError for what no route of K6 takes (a
    CPU tensor is checked as bf16 if it is bf16, else as float32)."""
    if x.device.type == "cpu":
        out_head_route(x.shape, w.shape, num_groups,
                       torch.bfloat16 if x.dtype == torch.bfloat16
                       else torch.float32)
        return out_head_plain(x, scale, bias, w, num_groups)
    return out_head_cuda(x, scale, bias, w, num_groups)


def in_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input conv: plain version for a CPU tensor, K7 for CUDA."""
    check_in_conv_shapes(x, w)
    if x.device.type == "cpu":
        return in_conv_plain(x, w)
    return in_conv_cuda(x, w)
