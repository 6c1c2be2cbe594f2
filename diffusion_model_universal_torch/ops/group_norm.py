"""Fused GroupNorm(+per-sample time bias)(+SiLU) forward, NHWC.

Counterpart of the reference's ``ops/group_norm.py``. Two versions of one
function:

* :func:`group_norm_silu_plain` — plain PyTorch, ported from
  ``group_norm_silu_xla``: per-channel f32 sums Σx and Σx², the time bias
  folded into those sums, group statistics from them, and the apply
  ``x·a + b`` (+SiLU) in the *input* dtype with a, b cast at the [B, C]
  stage. The CPU path and the numerics oracle of the kernel.
* kernel K1 (``csrc/group_norm.cu``), a hand-written CUDA kernel for
  Hopper that replaces the TPU kernel ``_gn_fwd_kernel``. It takes f32
  statistics and applies in f32, storing in x's dtype, as the TPU kernel
  does.

:func:`group_norm_silu` routes a CPU tensor to the plain version and a
CUDA tensor to the kernel. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

#: Kernel K1; ``GN_KERNEL.launches`` counts its launches.
GN_KERNEL = Kernel("group_norm", "dmu_group_norm_silu_fwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, tb, gamma, beta, out
    _INT, _INT, _INT, _INT,                 # B, S, C, G
    ctypes.c_float, _INT, _INT, _VOID,      # eps, apply_silu, is_bf16, stream
])

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def resolve_num_groups(num_channels: int, num_groups: int = 32) -> int:
    """Largest group count ≤ ``num_groups`` that divides ``num_channels``."""
    g = min(num_groups, num_channels)
    while num_channels % g != 0 and g > 1:
        g -= 1
    return g


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, num_groups: int,
                          time_bias: Optional[torch.Tensor] = None,
                          eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm → (optional +time_bias) → (optional SiLU) on NHWC ``x``.

    Args:
        x: [B, H, W, C] activations (stats in f32, apply in x's dtype).
        scale, bias: [C] affine parameters.
        num_groups: must divide C (see :func:`resolve_num_groups`).
        time_bias: optional [B, C] per-sample channel bias added to ``x``
            before normalizing.
    """
    b, h, w, c = x.shape
    g = num_groups
    cg = c // g
    n = float(h * w * cg)
    xf32 = x.float()
    colsum = xf32.sum(dim=(1, 2))                          # [B, C]
    colsumsq = xf32.square().sum(dim=(1, 2))               # [B, C]
    if time_bias is not None:
        tb = time_bias.float()
        hw = float(h * w)
        colsumsq = colsumsq + 2.0 * tb * colsum + hw * tb * tb
        colsum = colsum + hw * tb
    gsum = colsum.reshape(b, g, cg).sum(-1)                # [B, G]
    gsumsq = colsumsq.reshape(b, g, cg).sum(-1)
    mean = gsum / n
    var = torch.clamp(gsumsq / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)            # [B, C]
    rstd_c = rstd.repeat_interleave(cg, dim=-1)
    a = rstd_c * scale.float()
    b_ = bias.float() - mean_c * a
    if time_bias is not None:
        b_ = b_ + time_bias.float() * a
    out = (x * a[:, None, None, :].to(x.dtype)
           + b_[:, None, None, :].to(x.dtype))
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _check_param(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(t.shape)}")


def group_norm_silu_cuda(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         time_bias: Optional[torch.Tensor] = None,
                         eps: float = 1e-5,
                         apply_silu: bool = True) -> torch.Tensor:
    """Launch kernel K1 on a contiguous NHWC CUDA tensor.

    ``scale`` and ``bias`` are f32 [C]; ``time_bias`` is [B, C] in any
    float dtype (cast to f32 here, as the TPU kernel does). Anything the
    kernel does not take raises.
    """
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_cuda needs a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC [B, H, W, C] tensor")
    b, h, w, c = x.shape
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(f"num_groups={num_groups} must divide C={c}")
    _check_param("scale", scale, (c,), x.device)
    _check_param("bias", bias, (c,), x.device)
    tb = None
    if time_bias is not None:
        if time_bias.device != x.device or tuple(time_bias.shape) != (b, c):
            raise ValueError(f"time_bias must be [{b}, {c}] on {x.device}, "
                             f"got {tuple(time_bias.shape)} on "
                             f"{time_bias.device}")
        tb = time_bias.float().contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    GN_KERNEL(x.data_ptr(), tb.data_ptr() if tb is not None else None,
              scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
              b, h * w, c, num_groups, float(eps), int(apply_silu),
              int(x.dtype == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    return out


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, num_groups: int,
                    time_bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+time bias)(+SiLU) on NHWC ``x``: the plain version for
    a CPU tensor, kernel K1 for a CUDA tensor."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, num_groups, time_bias,
                                     eps, apply_silu)
    return group_norm_silu_cuda(x, scale, bias, num_groups, time_bias, eps,
                                apply_silu)
