"""3×3 SAME convolution, stride 1, NHWC activations × HWIO weights.

Counterpart of the reference's ``scripts/exp_conv_kernel.py``:

* :func:`conv3x3_plain` — plain PyTorch, the arithmetic of the Pallas
  kernels: 9 shifted matmuls of (B·H·W, Cin) @ (Cin, Cout) (``"tap9"``) or
  3 of (B·H·W, 3·Cin) @ (3·Cin, Cout) (``"k3"``), summed in f32, stored in
  x's dtype. The CPU path and the numerics oracle of K5.
* kernel K5, hand-written CUDA for Hopper that replaces ``_kernel`` and
  ``_kernel_k3``, an implicit GEMM, on three routes that
  :func:`conv3x3_route` picks from the shapes and dtype:
  ``"sm90"`` (``csrc/conv3x3_sm90.cu``: TMA loads, an mbarrier ring and
  ``wgmma``; bf16 with Cin % 64 == 0, Cout % 128 == 0 and 256-pixel tiles
  of whole image rows), ``"wmma"`` (``csrc/conv3x3.cu``: WMMA
  ``mma.sync``; every other bf16 shape) and ``"f32"`` (same file, CUDA
  cores in full f32). Each route and K order has its own launch count.
* :func:`gn_silu_conv3x3_plain` — ``silu(x·a + b)`` in x's dtype, then
  the tap9 conv; the oracle of kernel K4 (same source), which replaces
  ``_kernel_fused``; K4 always takes the WMMA kernel.
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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

VARIANTS = ("tap9", "k3")

ROUTES = ("sm90", "wmma", "f32")

_CONV_ARGS = [
    _VOID, _VOID, _VOID,                    # x, w, out
    _INT, _INT, _INT, _INT, _INT,           # B, H, W, Cin, Cout
    _INT, _VOID,                            # is_bf16, stream
]
_SM90_ARGS = [
    _VOID, _VOID, _VOID,                    # x, K-major w, out
    _INT, _INT, _INT, _INT, _INT,           # B, H, W, Cin, Cout
    _INT, _INT, _VOID,                      # rows, images per tile, stream
]
#: Kernel K5 by (route, K order); ``CONV3X3_KERNELS[r, v].launches`` counts
#: the launches of that route and order. The WMMA and f32 routes are two
#: dtypes of one C symbol, counted apart.
CONV3X3_KERNELS = {
    **{("sm90", v): Kernel("conv3x3_sm90", f"dmu_conv3x3_sm90_{v}",
                           _SM90_ARGS) for v in VARIANTS},
    **{(r, v): Kernel("conv3x3", f"dmu_conv3x3_{v}", _CONV_ARGS,
                      name=f"dmu_conv3x3_{v}[{r}]")
       for r in ("wmma", "f32") for v in VARIANTS},
}
#: The sm90 route's M tile: 256 output pixels, whole rows of whole images.
SM90_TILE = 256
SM90_BK = 64
SM90_BN = 128
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


class Conv3x3Route(NamedTuple):
    """K5's route for one call. For ``"sm90"``, a 256-pixel M tile holds
    ``images`` images of ``rows`` rows of W pixels (images·rows·W = 256);
    the other routes leave both 0."""
    name: str
    images: int = 0
    rows: int = 0


def conv3x3_route(x_shape, w_shape, dtype: torch.dtype) -> Conv3x3Route:
    """Which kernel K5 runs for x [B, H, W, Cin] and w [3, 3, Cin, Cout] of
    ``dtype``: ``"f32"`` for float32; for bfloat16 ``"sm90"`` when Cin is a
    multiple of 64, Cout of 128, and a tile of 256 pixels is whole rows of
    whole images (W divides 256, and R = 256/W rows divide H, or H·W
    divides 256), else ``"wmma"``. Raises ValueError for Cin or Cout not a
    multiple of 8, or another dtype."""
    _, h, wd, cin = (int(v) for v in x_shape)
    cout = int(w_shape[-1])
    if cin % 8 or cout % 8:
        raise ValueError(f"the conv kernels take Cin and Cout that are "
                         f"multiples of 8, got Cin={cin}, Cout={cout}")
    if dtype == torch.float32:
        return Conv3x3Route("f32")
    if dtype != torch.bfloat16:
        raise ValueError(f"x must be float32 or bfloat16, got {dtype}")
    if (cin % SM90_BK == 0 and cout % SM90_BN == 0 and 0 < wd <= SM90_TILE
            and SM90_TILE % wd == 0 and h > 0):
        rows = SM90_TILE // wd
        if h * wd >= SM90_TILE and h % rows == 0:
            return Conv3x3Route("sm90", 1, rows)
        if h * wd < SM90_TILE and SM90_TILE % (h * wd) == 0:
            return Conv3x3Route("sm90", SM90_TILE // (h * wd), h)
    return Conv3x3Route("wmma")


def sm90_box(m0: int, k_step: int, h: int, wd: int, cin: int):
    """The coordinates (c0, x0, y0, b0) at which the sm90 route's producer
    loads x's box [images, rows, W, 64] for the M tile starting at pixel
    ``m0`` and K step ``k_step`` (tap ``k_step // (Cin/64)``, channel block
    ``k_step % (Cin/64)``): the tile's first pixel shifted by the tap.
    Elements outside x read as 0. ``csrc/conv3x3_sm90.cu`` computes the
    same; the CPU tests walk it."""
    cblocks = cin // SM90_BK
    tap, cb = divmod(k_step, cblocks)
    b0 = m0 // (h * wd)
    y0 = (m0 - b0 * h * wd) // wd
    return cb * SM90_BK, tap % 3 - 1, y0 + tap // 3 - 1, b0


def kmajor_weight(w: torch.Tensor) -> torch.Tensor:
    """The sm90 route's B operand: HWIO w [3, 3, Cin, Cout] as the K-major
    matrix [Cout, 9·Cin], row n holding w[ky, kx, ci, n] at column
    (ky·3 + kx)·Cin + ci."""
    return w.reshape(-1, w.shape[-1]).t().contiguous()


def _kernel_args(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    return b, h, w, c, int(x.dtype == torch.bfloat16), \
        torch.cuda.current_stream(x.device).cuda_stream


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, variant: str = "tap9",
                 route: str = "") -> torch.Tensor:
    """Launch kernel K5 in the given K order, on the route
    :func:`conv3x3_route` picks. ``route="wmma"`` runs a bf16 shape on the
    WMMA kernel instead (to time it beside the sm90 route); any other
    choice than the router's raises. Anything K5 does not take raises
    ValueError."""
    check_conv_shapes(x, w)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, wd, c, is_bf16, stream = _kernel_args(x, "conv3x3_cuda")
    picked = conv3x3_route(x.shape, w.shape, x.dtype)
    if route and route != picked.name and not (route == "wmma" and is_bf16):
        raise ValueError(f"route {route!r} does not take this call "
                         f"(the router picks {picked.name!r})")
    route = route or picked.name
    x, w = x.contiguous(), w.contiguous()
    cout = w.shape[-1]
    out = x.new_empty((b, h, wd, cout))
    if not out.numel():
        return out
    kernel = CONV3X3_KERNELS[route, variant]
    if route == "sm90":
        wk = kmajor_weight(w)
        kernel(x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, h, wd, c,
               cout, picked.rows, picked.images, stream)
    else:
        kernel(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, cout,
               is_bf16, stream)
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
    K5 (tap9, on its routed kernel) on CUDA, the plain version on the CPU; backward the gradient
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
