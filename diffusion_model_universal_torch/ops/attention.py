"""Fused multi-head attention over [B, N, S, D].

Counterpart of the reference's ``ops/attention.py``:

* :func:`mha_plain` — plain PyTorch, ported from ``mha_xla``: f32 logits,
  f32 softmax, probabilities cast to v's dtype for the product with v.
  The CPU path and the numerics oracle of the kernel.
* kernel K3 (``csrc/attention.cu``), a hand-written CUDA kernel for
  Hopper that replaces the TPU kernel ``_mha_kernel``: one block per
  (batch, head), the whole S×S tile on chip, f32 throughout, stored in
  q's dtype.

:func:`multi_head_attention` routes a CPU tensor to the plain version and
a CUDA tensor to the kernel. There is no fallback between them. It goes
through :class:`MHAFunction`: forward K3,
backward by autograd through a recompute with :func:`mha_plain`, exactly
the reference's ``_mha_bwd`` (the vjp of ``mha_xla``); the JAX package has
no attention backward kernel, so neither has the port.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

#: Kernel K3; ``MHA_KERNEL.launches`` counts its launches.
MHA_KERNEL = Kernel("attention", "dmu_mha_fwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # q, k, v, out, strides
    _INT, _INT, _INT, _INT,                 # B, N, S, D
    ctypes.c_float, _INT, _VOID,            # scale, is_bf16, stream
])

#: Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024


def mha_smem_bytes(s: int, d: int) -> int:
    """Shared memory of one K3 block: f32 Q, K, V with rows padded to
    D+1, plus the S×S logits."""
    return 4 * (3 * s * (d + 1) + s * s)


def mha_plain(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ·d⁻⁰·⁵)V over [B, N, S, D] (batch, heads, seq, head_dim)."""
    scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)  # f64 stays f64
    logits = torch.einsum("bnsd,bntd->bnst", q.to(acc), k.to(acc)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnst,bntd->bnsd", probs.to(v.dtype).to(acc),
                       v.to(acc))
    return out.to(v.dtype)


def mha_cuda(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """Launch kernel K3 on [B, N, S, D] CUDA tensors.

    The inputs may be any strided views with unit stride on D (the UNet
    passes head-split views of its projections). The result is returned
    as a [B, N, S, D] view of a contiguous [B, S, N, D] buffer, so merging
    the heads back to [B, S, N·D] needs no copy.
    """
    if q.device.type != "cuda":
        raise ValueError(f"mha_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and "
                             f"device: {tuple(t.shape)} {t.dtype} "
                             f"{t.device} vs {tuple(q.shape)} {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, N, S, D] inputs, got {q.dim()}-D")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride on the head dim")
    b, n, s, d = q.shape
    if mha_smem_bytes(s, d) > MAX_SMEM_BYTES:
        raise ValueError(f"S={s}, D={d} needs {mha_smem_bytes(s, d)} bytes "
                         f"of shared memory; K3 holds at most "
                         f"{MAX_SMEM_BYTES}")
    out = torch.empty((b, s, n, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    MHA_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               ctypes.cast(strides, _VOID), b, n, s, d, float(d ** -0.5),
               int(q.dtype == torch.bfloat16),
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _mha_fwd(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """The forward for q's device: plain on the CPU, K3 on CUDA."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v)
    return mha_cuda(q, k, v)


class MHAFunction(torch.autograd.Function):
    """Forward through K3 (plain on the CPU); backward by autograd through
    :func:`mha_plain` recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _mha_fwd(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = mha_plain(q, k, v)
        return torch.autograd.grad(out, (q, k, v), grad)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Attention over [B, N, S, D]: the plain version for CPU tensors,
    kernel K3 for CUDA tensors. Differentiable."""
    return MHAFunction.apply(q, k, v)
