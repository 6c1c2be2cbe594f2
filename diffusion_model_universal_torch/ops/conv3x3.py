"""3×3 SAME convolution, stride 1, NHWC activations × HWIO weights.

Counterpart of the reference's ``scripts/exp_conv_kernel.py``:

* :func:`conv3x3_plain` — plain PyTorch, the arithmetic of the Pallas
  kernels: 9 shifted matmuls of (B·H·W, Cin) @ (Cin, Cout) (``"tap9"``) or
  3 of (B·H·W, 3·Cin) @ (3·Cin, Cout) (``"k3"``), summed in f32, stored in
  x's dtype. The CPU path and the numerics oracle of K5.
* kernel K5 (``csrc/conv3x3.cu``), a hand-written CUDA kernel for Hopper
  that replaces ``_kernel`` and ``_kernel_k3``: an implicit GEMM whose K
  loop runs in either order.
* :func:`gn_silu_conv3x3_plain` — ``silu(x·a + b)`` in x's dtype, then
  the tap9 conv; the oracle of kernel K4 (same source), which replaces
  ``_kernel_fused``.
* :func:`conv3x3_conv2d` and :func:`gn_silu_conv3x3_conv2d` — one
  ``F.conv2d`` on a channels-last view, ports of ``conv3x3_xla`` and
  ``gn_silu_conv3x3_xla``. They are the experiment CLI's baseline and the
  backward of :class:`Conv3x3Function`; no kernel path calls them.

:func:`conv3x3` and :func:`gn_silu_conv3x3` route a CPU tensor to the
plain version and a CUDA tensor to the kernel; there is no fallback
between them. The kernels take Cin and Cout that are multiples of 8, and
so do the dispatchers, on either device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

VARIANTS = ("tap9", "k3")

_CONV_ARGS = [
    _VOID, _VOID, _VOID,                    # x, w, out
    _INT, _INT, _INT, _INT, _INT,           # B, H, W, Cin, Cout
    _INT, _VOID,                            # is_bf16, stream
]
#: Kernel K5 by K order; ``CONV3X3_KERNELS[v].launches`` counts launches.
CONV3X3_KERNELS = {
    "tap9": Kernel("conv3x3", "dmu_conv3x3_tap9", _CONV_ARGS),
    "k3": Kernel("conv3x3", "dmu_conv3x3_k3", _CONV_ARGS),
}
#: Kernel K4; ``GN_SILU_CONV3X3_KERNEL.launches`` counts its launches.
GN_SILU_CONV3X3_KERNEL = Kernel("conv3x3", "dmu_gn_silu_conv3x3", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, a, b, w, out
    _INT, _INT, _INT, _INT, _INT,           # B, H, W, Cin, Cout
    _INT, _VOID,                            # is_bf16, stream
])

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  variant: str = "tap9") -> torch.Tensor:
    """3×3 SAME conv of NHWC ``x`` [B, H, W, Cin] with HWIO ``w``
    [3, 3, Cin, Cout] as the Pallas kernels compute it: shifted matmuls in
    f32 (f64 for f64 input), summed, stored in x's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))          # zero halo
    wf = w.to(acc)
    out = None
    for ky in range(3):
        taps = [xp[:, ky:ky + h, kx:kx + wd, :] for kx in range(3)]
        if variant == "tap9":
            parts = [t.reshape(-1, c) @ wf[ky, kx]
                     for kx, t in enumerate(taps)]
        else:
            parts = [torch.cat(taps, dim=-1).reshape(-1, 3 * c)
                     @ wf[ky].reshape(3 * c, cout)]
        for g in parts:
            out = g if out is None else out + g
    return out.reshape(b, h, wd, cout).to(x.dtype)


def _affine_silu(x: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """silu(x·a + b) in x's dtype (every op rounds to it); a, b [B, C]."""
    a = a.to(x.dtype)[:, None, None, :]
    b = b.to(x.dtype)[:, None, None, :]
    z = x * a + b
    return z * torch.sigmoid(z)


def gn_silu_conv3x3_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_plain(silu(x·a + b), w)``, with a, b [B, Cin] cast to x's
    dtype and the affine and SiLU in that dtype, as ``_kernel_fused``."""
    return conv3x3_plain(_affine_silu(x, a, b), w, "tap9")


def conv3x3_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv as one ``F.conv2d`` on a channels-last view (the port
    of ``conv3x3_xla``); returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def gn_silu_conv3x3_conv2d(x: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unfused unit, the port of ``gn_silu_conv3x3_xla``: the affine
    and SiLU, then ``F.conv2d`` (y makes a round trip through memory)."""
    return conv3x3_conv2d(_affine_silu(x, a, b).to(x.dtype), w)


def check_conv_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError unless x is [B, H, W, Cin] and w [3, 3, Cin, Cout]
    of x's dtype and device, with Cin and Cout multiples of 8."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                               x.shape[-1]):
        raise ValueError(f"x must be [B, H, W, Cin] and w [3, 3, Cin, Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if cin % 8 or cout % 8:
        raise ValueError(f"the conv kernels take Cin and Cout that are "
                         f"multiples of 8, got Cin={cin}, Cout={cout}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w must match x: {w.dtype} on {w.device} vs "
                         f"{x.dtype} on {x.device}")


def _kernel_args(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    return b, h, w, c, int(x.dtype == torch.bfloat16), \
        torch.cuda.current_stream(x.device).cuda_stream


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                 variant: str = "tap9") -> torch.Tensor:
    """Launch kernel K5 in the given K order. Anything it does not take
    raises ValueError."""
    check_conv_shapes(x, w)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, wd, c, is_bf16, stream = _kernel_args(x, "conv3x3_cuda")
    x, w = x.contiguous(), w.contiguous()
    out = x.new_empty((b, h, wd, w.shape[-1]))
    if out.numel():
        CONV3X3_KERNELS[variant](x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 b, h, wd, c, w.shape[-1], is_bf16, stream)
    return out


def gn_silu_conv3x3_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Launch kernel K4; a, b are [B, Cin], cast to x's dtype here."""
    check_conv_shapes(x, w)
    bsz, h, wd, c, is_bf16, stream = _kernel_args(x, "gn_silu_conv3x3_cuda")
    for name, t in (("a", a), ("b", b)):
        if tuple(t.shape) != (bsz, c) or t.device != x.device:
            raise ValueError(f"{name} must be [{bsz}, {c}] on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    x, w = x.contiguous(), w.contiguous()
    a = a.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    out = x.new_empty((bsz, h, wd, w.shape[-1]))
    if out.numel():
        GN_SILU_CONV3X3_KERNEL(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                               w.data_ptr(), out.data_ptr(), bsz, h, wd, c,
                               w.shape[-1], is_bf16, stream)
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            variant: str = "tap9") -> torch.Tensor:
    """The 3×3 conv: plain version for a CPU tensor, K5 for a CUDA one."""
    if x.device.type == "cpu":
        check_conv_shapes(x, w)
        return conv3x3_plain(x, w, variant)
    return conv3x3_cuda(x, w, variant)


def gn_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """conv3x3(silu(x·a + b)): plain version on the CPU, K4 on CUDA."""
    if x.device.type == "cpu":
        check_conv_shapes(x, w)
        return gn_silu_conv3x3_plain(x, a, b, w)
    return gn_silu_conv3x3_cuda(x, a, b, w)


class Conv3x3Function(torch.autograd.Function):
    """The differentiable conv, the port of ``conv3x3_pallas_vjp``: forward
    K5 (tap9) on CUDA, the plain version on the CPU; backward the gradient
    of :func:`conv3x3_conv2d`, as ``_vjp_bwd`` takes XLA's conv vjp. The
    reference has no backward kernel here, so the port has none."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3(x, w, "tap9")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w.detach().requires_grad_()
            y = conv3x3_conv2d(xd, wd)
        return torch.autograd.grad(y, (xd, wd), g)
