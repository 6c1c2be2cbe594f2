"""The UNet's boundary convolutions: the output head (GroupNorm, SiLU and a
3×3 conv C→3 in one kernel) and the input conv (3×3, 3→C). NHWC × HWIO.

Counterpart of the reference's ``scripts/exp_boundary_kernel.py``:

* :func:`out_head_plain` — plain PyTorch, the arithmetic of
  ``_kernel_out_head``: group statistics in f32 (:func:`group_affine` of
  ``ops/group_norm.py``), the apply and SiLU in f32, y rounded once to x's
  dtype, then :func:`conv3x3_plain`. The oracle of kernel K6
  (``csrc/boundary_conv.cu``).
* :func:`in_conv_plain` — the 27-column im2col matrix times w [27, Cout]
  in f32, the arithmetic of ``_kernel_in_conv``; the oracle of kernel K7
  (same source), which runs bf16 on the tensor cores (``mma.sync``, K
  padded to 32 with the weight packed by :func:`pack_in_conv_weight`) and
  f32 on the CUDA cores in full f32, each path with its own launch count.
* :func:`out_head_conv2d` — the experiment CLI's out-head baseline, the
  port of ``out_head_xla``: ``group_norm_silu_plain`` (the port of
  ``group_norm_silu_xla``), then ``F.conv2d``. The in-conv baseline is
  :func:`conv3x3_conv2d`, as the reference's is ``conv3x3_xla``. No kernel
  path calls them.

:func:`out_head` and :func:`in_conv` route a CPU tensor to the plain
version and a CUDA tensor to the kernel; there is no fallback between
them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel
from .attention import MAX_SMEM_BYTES
from .conv3x3 import conv3x3_conv2d, conv3x3_plain
from .group_norm import group_affine, group_norm_silu_plain

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

#: Kernel K6; ``OUT_HEAD_KERNEL.launches`` counts its launches.
OUT_HEAD_KERNEL = Kernel("boundary_conv", "dmu_out_head", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, scale, bias, w, out
    _INT, _INT, _INT, _INT, _INT,           # B, H, W, C, G
    ctypes.c_float, _INT, _VOID,            # eps, is_bf16, stream
])
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

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def out_head_smem_bytes(w: int, c: int, g: int) -> int:
    """Shared memory of one K6 block: the weight in f32 [C, 27], four [C]
    and two [G] vectors, and the larger of the statistics' partial sums
    (2 × 256 × 8) and the ring of 3 rows of 27 partial products."""
    return 4 * (27 * c + 4 * c + 2 * g + max(2 * 256 * 8, 3 * w * 27))


def in_conv_smem_bytes(cout: int) -> int:
    """Shared memory of one K7 block: the weight in f32 [27, Cout] and the
    27 inputs of each of its 256 pixels."""
    return 4 * (27 * cout + 256 * 27)


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


def check_out_head_shapes(x, w, num_groups: int) -> None:
    """Raise ValueError unless K6 takes these shapes: x [B, H, W, C] with C
    a multiple of 8 and of ``num_groups``, w [3, 3, C, 3], and a block's
    shared memory within the card's."""
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1], 3):
        raise ValueError(f"x must be [B, H, W, C] and w [3, 3, C, 3], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    c = x.shape[-1]
    if c % 8 or num_groups <= 0 or c % num_groups or c > 2048:
        raise ValueError(f"K6 takes C a multiple of 8 and of num_groups, at "
                         f"most 2048; got C={c}, num_groups={num_groups}")
    smem = out_head_smem_bytes(x.shape[2], c, num_groups)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K6 would need {smem} bytes of shared memory at "
                         f"W={x.shape[2]}, C={c}")


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
                  w: torch.Tensor, num_groups: int = 32,
                  eps: float = 1e-5) -> torch.Tensor:
    """Launch kernel K6; scale and bias [C] are cast to f32 here."""
    check_out_head_shapes(x, w, num_groups)
    _check_dtype_device(x, w, "out_head_cuda")
    b, h, wd, c = x.shape
    x, w = x.contiguous(), w.contiguous()
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be [{c}]")
    out = x.new_empty((b, h, wd, 3))
    if out.numel():
        OUT_HEAD_KERNEL(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        w.data_ptr(), out.data_ptr(), b, h, wd, c,
                        num_groups, float(eps),
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
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
    """The output head: plain version for a CPU tensor, K6 for CUDA."""
    check_out_head_shapes(x, w, num_groups)
    if x.device.type == "cpu":
        return out_head_plain(x, scale, bias, w, num_groups)
    return out_head_cuda(x, scale, bias, w, num_groups)


def in_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input conv: plain version for a CPU tensor, K7 for CUDA."""
    check_in_conv_shapes(x, w)
    if x.device.type == "cpu":
        return in_conv_plain(x, w)
    return in_conv_cuda(x, w)
