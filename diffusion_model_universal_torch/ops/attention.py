"""Fused multi-head attention over [B, N, S, D].

Counterpart of the reference's ``ops/attention.py``:

* :func:`mha_plain` — plain PyTorch, ported from ``mha_xla``: f32 logits,
  f32 softmax, probabilities cast to v's dtype for the product with v.
  The CPU path and the numerics oracle of the kernel.
* kernel K3 (``csrc/attention.cu``), a hand-written CUDA kernel for
  Hopper that replaces the TPU kernel ``_mha_kernel``: 16 query rows a
  warp, keys and values streamed through shared memory in tiles of 64
  with an online softmax, so every S and D runs; bf16 on the tensor cores
  (``mma.sync``), f32 on the CUDA cores; stored in q's dtype.
  :func:`mha_launch_plan` gives its launch, and every number of it is
  passed to the kernel, which checks the plan and computes none of its
  own.

:func:`multi_head_attention` routes a CPU tensor to the plain version and
a CUDA tensor to the kernel. There is no fallback between them. It goes
through :class:`MHAFunction`: forward K3,
backward by autograd through a recompute with :func:`mha_plain`, exactly
the reference's ``_mha_bwd`` (the vjp of ``mha_xla``); the JAX package has
no attention backward kernel, so neither has the port.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

#: Kernel K3; ``MHA_KERNEL.launches`` counts its launches.
MHA_KERNEL = Kernel("attention", "dmu_mha_fwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # q, k, v, out, strides
    _INT, _INT, _INT, _INT,                 # B, N, S, D
    ctypes.c_float, _INT, _VOID, _VOID,     # scale, is_bf16, plan, stream
])

#: Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024

#: K3's tiling (``csrc/attention.cu``): 4 warps of 16 query rows a block;
#: two stages of 64 key (or value) rows × 64 columns of D, or 128 columns
#: in bf16 with four heads a block and D > 64; an output chunk at most 256
#: columns.
MHA_WARPS = 4
MHA_STAGE_ROWS = 64
MHA_OUT_COLS = 256


class MHAPlan(NamedTuple):
    """K3's launch for [B, N, S, D]: ``heads`` (batch, head) pairs a block
    (4 for S ≤ 16, else 1), ``keys`` keys of each a stage, ``query_rows``
    rows of each a block, ``blocks`` in the grid. D is walked in
    ``chunks`` stages of ``cols`` columns for the logits, and the output in
    ``out_chunks`` chunks of ``outs`` stages of v (cols·outs ≤ 256
    columns; the logits are recomputed for each further chunk). ``units``
    stage fills a block, ``smem_bytes`` of static shared memory."""
    heads: int
    cols: int
    keys: int
    query_rows: int
    key_tiles: int
    q_tiles: int
    blocks: int
    chunks: int
    outs: int
    out_chunks: int
    units: int
    smem_bytes: int


def mha_launch_plan(b: int, n: int, s: int, d: int,
                    dtype: torch.dtype = torch.bfloat16) -> MHAPlan:
    """The launch ``csrc/attention.cu`` makes for these sizes; every S ≥ 1
    and D ≥ 1 has one (shared memory does not grow with either)."""
    if min(b, n, s, d) <= 0:
        raise ValueError(f"B, N, S and D must be positive, got "
                         f"{(b, n, s, d)}")
    heads = 4 if s <= 16 else 1
    bf16 = dtype == torch.bfloat16
    cols = 128 if bf16 and heads == 4 and d > 64 else 64
    keys = MHA_STAGE_ROWS // heads
    rows = 16 * MHA_WARPS // heads
    key_tiles, q_tiles = -(-s // keys), -(-s // rows)
    chunks = -(-d // cols)
    outs = min(chunks, MHA_OUT_COLS // cols)
    out_chunks = -(-chunks // outs)
    row_bytes = (cols + 8) * 2 if bf16 else (cols + 4) * 4
    return MHAPlan(heads, cols, keys, rows, key_tiles, q_tiles,
                   -(-(b * n) // heads) * q_tiles, chunks, outs, out_chunks,
                   out_chunks * key_tiles * (chunks + outs),
                   2 * MHA_STAGE_ROWS * row_bytes)


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
    out = torch.empty((b, s, n, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    plan = mha_launch_plan(b, n, s, d, q.dtype)
    if plan.blocks > 2 ** 31 - 1:
        raise ValueError(f"[B, N, S, D] = {(b, n, s, d)} needs "
                         f"{plan.blocks} blocks, more than a grid holds")
    launch = (ctypes.c_int * 8)(plan.heads, plan.cols, plan.chunks,
                                plan.outs, plan.key_tiles, plan.q_tiles,
                                plan.units, plan.blocks)
    MHA_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               ctypes.cast(strides, _VOID), b, n, s, d, float(d ** -0.5),
               int(q.dtype == torch.bfloat16), ctypes.cast(launch, _VOID),
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
    :func:`mha_plain` recomputed from the saved q, k, v, itself
    differentiable (grad-of-grad goes through the plain version)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _mha_fwd(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        # The saved tensors are not detached, and the gradient is taken
        # with a graph when the caller asked for one (create_graph), so a
        # second derivative flows through mha_plain, as the reference's
        # ``_mha_bwd`` (``jax.vjp`` of ``mha_xla``) is differentiated again.
        create_graph = torch.is_grad_enabled()
        saved = ctx.saved_tensors
        wanted = [t for t, need in zip(saved, ctx.needs_input_grad) if need]
        with torch.enable_grad():
            out = mha_plain(*saved)
        grads = iter(torch.autograd.grad(out, wanted, grad,
                                         create_graph=create_graph))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Attention over [B, N, S, D]: the plain version for CPU tensors,
    kernel K3 for CUDA tensors. Differentiable."""
    return MHAFunction.apply(q, k, v)
