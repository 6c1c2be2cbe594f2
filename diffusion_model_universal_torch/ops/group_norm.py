"""Fused GroupNorm(+per-sample time bias)(+SiLU), NHWC, with its backward.

Counterpart of the reference's ``ops/group_norm.py``. Two versions of each
direction:

* :func:`group_norm_silu_plain` — plain PyTorch, ported from
  ``group_norm_silu_xla``: per-channel sums Σx and Σx² (f32, or f64 for
  f64 input), the time bias folded into those sums, group statistics from
  them, and the apply ``x·a + b`` (+SiLU) in the *input* dtype with a, b
  cast at the [B, C] stage. The CPU path and the numerics oracle of K1.
* kernel K1 (``csrc/group_norm.cu``), a hand-written CUDA kernel for
  Hopper that replaces the TPU kernel ``_gn_fwd_kernel``. It takes f32
  statistics and applies in f32, storing in x's dtype, as the TPU kernel
  does.
* :func:`group_norm_silu_bwd_plain` — the backward formula of
  ``_gn_bwd_kernel`` in plain PyTorch: (dx, dγ, dβ, dtb) from (x, dy),
  computed in f32. The CPU path and the numerics oracle of K2.
* kernel K2 (same source), which replaces ``_gn_bwd_kernel``.

:func:`group_norm_silu` is the op the UNet calls. It always goes through
:class:`GroupNormSiLUFunction` (forward K1, backward K2 on CUDA; the plain
versions on the CPU), as the reference pairs its kernels with
``jax.custom_vjp``. A CPU tensor takes the plain version and a CUDA
tensor the kernel; there is no fallback between them.
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

#: Kernel K2 (its main kernel and the dγ/dβ reduction, one launch call);
#: ``GN_BWD_KERNEL.launches`` counts its launches.
GN_BWD_KERNEL = Kernel("group_norm", "dmu_group_norm_silu_bwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, tb, gamma, beta, dy
    _VOID, _VOID, _VOID, _VOID, _VOID,      # dx, dgamma, dbeta, dtb, scratch
    _INT, _INT, _INT, _INT,                 # B, S, C, G
    ctypes.c_float, _INT, _INT, _VOID,      # eps, apply_silu, is_bf16, stream
])

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: K2 keeps one channel per thread of a 256-thread block.
MAX_BWD_GROUP_SIZE = 256


def resolve_num_groups(num_channels: int, num_groups: int = 32) -> int:
    """Largest group count ≤ ``num_groups`` that divides ``num_channels``."""
    g = min(num_groups, num_channels)
    while num_channels % g != 0 and g > 1:
        g -= 1
    return g


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32/bf16 input (as the reference), f64 for f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


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
    acc = _acc_dtype(x)
    xf = x.to(acc)
    colsum = xf.sum(dim=(1, 2))                            # [B, C]
    colsumsq = xf.square().sum(dim=(1, 2))                 # [B, C]
    if time_bias is not None:
        tb = time_bias.to(acc)
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
    a = rstd_c * scale.to(acc)
    b_ = bias.to(acc) - mean_c * a
    if time_bias is not None:
        b_ = b_ + time_bias.to(acc) * a
    out = (x * a[:, None, None, :].to(x.dtype)
           + b_[:, None, None, :].to(x.dtype))
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def group_norm_silu_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor,
                              time_bias: Optional[torch.Tensor],
                              dy: torch.Tensor, num_groups: int,
                              eps: float = 1e-5, apply_silu: bool = True):
    """Backward of the GroupNorm op from (x, dy), as ``_gn_bwd_kernel``:
    the statistics are recomputed from x, everything is computed in f32
    (f64 for f64 input).

    Returns ``(dx, dscale, dbias, dtb)``: dx in x's dtype, dscale and
    dbias [C] summed over the batch, dtb = Σ_s dx as [B, C] (None when
    ``time_bias`` is None), all three in the accumulation dtype.
    """
    b, h, w, c = x.shape
    g = num_groups
    cg = c // g
    n = float(h * w * cg)
    acc = _acc_dtype(x)
    v = x.to(acc)
    if time_bias is not None:
        v = v + time_bias.to(acc)[:, None, None, :]
    vg = v.reshape(b, h * w, g, cg)
    mean = vg.sum(dim=(1, 3)) / n                          # [B, G]
    var = torch.clamp(vg.square().sum(dim=(1, 3)) / n - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)[:, None, :, None]        # [B, 1, G, 1]
    xhat = (vg - mean[:, None, :, None]) * rstd            # [B, S, G, cg]
    gamma = scale.to(acc).reshape(g, cg)
    dyg = dy.to(acc).reshape(b, h * w, g, cg)
    if apply_silu:
        z = xhat * gamma + bias.to(acc).reshape(g, cg)
        sig = torch.sigmoid(z)
        dz = dyg * (sig * (1.0 + z * (1.0 - sig)))
    else:
        dz = dyg
    dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbias = dz.sum(dim=(0, 1)).reshape(c)
    dxhat = dz * gamma
    s1 = dxhat.sum(dim=(1, 3), keepdim=True)               # [B, 1, G, 1]
    s2 = (dxhat * xhat).sum(dim=(1, 3), keepdim=True)
    dx = rstd * (dxhat - (s1 + xhat * s2) / n)
    dtb = dx.sum(dim=1).reshape(b, c) if time_bias is not None else None
    return dx.reshape(b, h, w, c).to(x.dtype), dscale, dbias, dtb


def _check_param(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(t.shape)}")


def _check_kernel_inputs(x, scale, bias, num_groups, time_bias, what):
    """Shared argument checks of the K1 and K2 wrappers; returns the
    time bias as a contiguous f32 [B, C] tensor, or None."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC [B, H, W, C] tensor")
    b, h, w, c = x.shape
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(f"num_groups={num_groups} must divide C={c}")
    _check_param("scale", scale, (c,), x.device)
    _check_param("bias", bias, (c,), x.device)
    if time_bias is None:
        return None
    if time_bias.device != x.device or tuple(time_bias.shape) != (b, c):
        raise ValueError(f"time_bias must be [{b}, {c}] on {x.device}, "
                         f"got {tuple(time_bias.shape)} on "
                         f"{time_bias.device}")
    return time_bias.float().contiguous()


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
    tb = _check_kernel_inputs(x, scale, bias, num_groups, time_bias,
                              "group_norm_silu_cuda")
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    GN_KERNEL(x.data_ptr(), tb.data_ptr() if tb is not None else None,
              scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
              b, h * w, c, num_groups, float(eps), int(apply_silu),
              int(x.dtype == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    return out


def group_norm_silu_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor,
                             time_bias: Optional[torch.Tensor],
                             dy: torch.Tensor, num_groups: int,
                             eps: float = 1e-5, apply_silu: bool = True):
    """Launch kernel K2: ``(dx, dscale, dbias, dtb)`` as
    :func:`group_norm_silu_bwd_plain` returns them (dtb None without a
    time bias). ``dy`` must match x's shape and dtype; a non-contiguous
    ``dy`` is copied to NHWC first."""
    tb = _check_kernel_inputs(x, scale, bias, num_groups, time_bias,
                              "group_norm_silu_bwd_cuda")
    b, h, w, c = x.shape
    if c // num_groups > MAX_BWD_GROUP_SIZE:
        raise ValueError(f"K2 takes at most {MAX_BWD_GROUP_SIZE} channels "
                         f"per group, got {c // num_groups}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} "
                         f"{dy.device} vs {tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dscale = torch.empty(c, **f32)
    dbias = torch.empty(c, **f32)
    dtb = torch.empty((b, c), **f32) if tb is not None else None
    if x.numel() == 0:
        return dx, dscale.zero_(), dbias.zero_(), dtb
    scratch = torch.empty((2, b, c), **f32)
    GN_BWD_KERNEL(x.data_ptr(), tb.data_ptr() if tb is not None else None,
                  scale.data_ptr(), bias.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                  dtb.data_ptr() if dtb is not None else None,
                  scratch.data_ptr(), b, h * w, c, num_groups, float(eps),
                  int(apply_silu), int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    return dx, dscale, dbias, dtb


def _gn_fwd(x, scale, bias, num_groups, time_bias, eps, apply_silu):
    """The forward for ``x``'s device: plain on the CPU, K1 on CUDA."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, num_groups, time_bias,
                                     eps, apply_silu)
    return group_norm_silu_cuda(x, scale, bias, num_groups, time_bias, eps,
                                apply_silu)


def _gn_bwd(x, scale, bias, time_bias, dy, num_groups, eps, apply_silu):
    """The backward for ``x``'s device: plain on the CPU, K2 on CUDA."""
    if x.device.type == "cpu":
        return group_norm_silu_bwd_plain(x, scale, bias, time_bias, dy,
                                         num_groups, eps, apply_silu)
    return group_norm_silu_bwd_cuda(x, scale, bias, time_bias, dy,
                                    num_groups, eps, apply_silu)


class GroupNormSiLUFunction(torch.autograd.Function):
    """The differentiable op: forward K1 and backward K2 on CUDA, the two
    plain versions on the CPU. Saves the inputs, not the statistics: the
    backward recomputes them from x, as the reference's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, scale, bias, time_bias, num_groups, eps,
                apply_silu):
        ctx.save_for_backward(x, scale, bias, time_bias)
        ctx.args = (num_groups, eps, apply_silu)
        return _gn_fwd(x, scale, bias, num_groups, time_bias, eps,
                       apply_silu)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, time_bias = ctx.saved_tensors
        num_groups, eps, apply_silu = ctx.args
        dx, dscale, dbias, dtb = _gn_bwd(x, scale, bias, time_bias, dy,
                                         num_groups, eps, apply_silu)
        if dtb is not None:
            dtb = dtb.to(time_bias.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), dtb,
                None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, num_groups: int,
                    time_bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+time bias)(+SiLU) on NHWC ``x``: the plain versions for
    a CPU tensor, kernels K1/K2 for a CUDA tensor. Differentiable."""
    return GroupNormSiLUFunction.apply(x, scale, bias, time_bias,
                                       num_groups, eps, apply_silu)
