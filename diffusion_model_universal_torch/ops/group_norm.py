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
* kernel K2 (same source), which replaces ``_gn_bwd_kernel`` in one
  launch.

:func:`gn_launch_plan` decides how both kernels cut a call into blocks:
vector width, threads, blocks per sample along its rows (a thread block
cluster that shares per-channel sums through distributed shared memory)
and, for K1, along C, samples per block, and where a block keeps its
rows of x (and dy) between passes. The wrappers pass its numbers to the
launchers; the CPU tests check and emulate it.

:func:`group_norm_silu` is the op the UNet calls. It always goes through
:class:`GroupNormSiLUFunction` (forward K1, backward K2 on CUDA; the plain
versions on the CPU), as the reference pairs its kernels with
``jax.custom_vjp``. A CPU tensor takes the plain version and a CUDA
tensor the kernel; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ._build import Kernel

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

_PLAN_ARGS = [_INT] * 8   # vec_bytes, threads, cluster, channel_blocks,
                          # samples_per_block, rows_per_block, keep,
                          # smem_bytes

#: Kernel K1; ``GN_KERNEL.launches`` counts its launches.
GN_KERNEL = Kernel("group_norm", "dmu_group_norm_silu_fwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, tb, gamma, beta, out
    _INT, _INT, _INT, _INT,                 # B, S, C, G
    ctypes.c_float, _INT, _INT,             # eps, apply_silu, is_bf16
    *_PLAN_ARGS, _VOID,                     # the plan, stream
])

#: Kernel K2 (one launch: dx, dtb and the dγ/dβ sum over the batch);
#: ``GN_BWD_KERNEL.launches`` counts its launches.
GN_BWD_KERNEL = Kernel("group_norm", "dmu_group_norm_silu_bwd", [
    _VOID, _VOID, _VOID, _VOID, _VOID,      # x, tb, gamma, beta, dy
    _VOID, _VOID, _VOID, _VOID, _VOID,      # dx, dgamma, dbeta, dtb, scratch
    _VOID,                                  # ticket
    _INT, _INT, _INT, _INT,                 # B, S, C, G
    ctypes.c_float, _INT, _INT,             # eps, apply_silu, is_bf16
    *_PLAN_ARGS, _INT, _VOID,               # the plan, its team, stream
])

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_ITEMSIZE = {"float32": 4, "bfloat16": 2}

# The H100 SXM, as the plan sees it.
NUM_SMS = 132
MAX_SMEM_BYTES = 232_448      # 227 KB of dynamic shared memory a block
MAX_CLUSTER = 8               # the portable thread block cluster size
MAX_THREADS = 512             # the kernels' __launch_bounds__
TARGET_THREADS = 256
#: Vectors a thread holds at once in K1 and K2 (x, and dy in K2).
UNROLL = {False: 4, True: 2}
#: A cluster is made just large enough that each block keeps at most this
#: much of a sample's slab: several blocks then share an SM, and one
#: block's stores overlap another's loads.
SLAB_TARGET_BYTES = 64 * 1024
#: A block splits no further (for more blocks) below this much input, nor
#: takes several small samples beyond it.
MIN_BLOCK_BYTES = 16 * 1024
#: Blocks that split C take at least this many bytes of a row (two 32-byte
#: sectors), and split it only until the grid has MIN_GRID blocks.
MIN_SEGMENT_BYTES = 64
MIN_GRID = 128
#: Up to this many bytes of x a call is latency-bound: its blocks take
#: vectors narrower than 16 bytes where that gives a thread fewer
#: channels, and so a shorter chain of work.
LATENCY_BYTES = 256 * 1024
#: Where a block keeps its rows between passes: the C side's kReread,
#: kShared, kRegisters.
SLAB_MODES = {"reread": 0, "shared": 1, "registers": 2}


@dataclass(frozen=True)
class GNPlan:
    """How K1 or K2 cuts one call (see ``csrc/group_norm.cu``): blocks
    of ``threads`` = ``thread_rows`` × (C / ``vec``) threads, each thread
    on one column of ``vec_bytes``-byte vectors of the block's C /
    ``channel_blocks`` channels (whole groups; ``channel_blocks`` blocks
    split C); ``cluster`` blocks share a sample's rows (rank r takes rows
    [r·rows_per_block, (r+1)·rows_per_block)), and each block (or
    cluster) takes ``samples_per_block`` consecutive samples in turn.
    ``slab`` says where a block keeps its rows of x (and dy) between
    passes: ``registers``, ``shared`` memory (with 16-byte vectors through
    bulk copies), or ``reread`` from L2/HBM. K2 sums dγ/dβ over the batch
    in teams of ``team`` consecutive samples, then over the ``teams``."""
    vec_bytes: int
    vec: int
    threads: int
    thread_rows: int
    cluster: int
    channel_blocks: int
    samples_per_block: int
    rows_per_block: int
    blocks: int
    smem_bytes: int
    slab: str
    team: int
    teams: int

    @property
    def keep(self) -> bool:
        """Whether the slab stays on chip (one HBM read)."""
        return self.slab != "reread"

    def launch_args(self) -> Tuple[int, ...]:
        return (self.vec_bytes, self.threads, self.cluster,
                self.channel_blocks, self.samples_per_block,
                self.rows_per_block, SLAB_MODES[self.slab], self.smem_bytes)

    def describe(self) -> str:
        where = {"registers": "kept in registers",
                 "shared": "kept in shared memory",
                 "reread": "read again from L2/HBM"}[self.slab]
        return (f"{self.blocks} blocks of {self.threads} threads "
                f"({self.thread_rows} rows x {self.vec_bytes}-byte "
                f"vectors), cluster {self.cluster}, {self.channel_blocks} "
                f"block(s) along C, "
                f"{self.samples_per_block} sample(s) a block, "
                f"{self.rows_per_block} rows a block, smem "
                f"{self.smem_bytes} B, slab {where}, teams of "
                f"{self.team}")


def _smem_fixed(threads: int, vec: int, c: int, backward: bool) -> int:
    """Bytes of the kernels' barriers and reduction buffers, before the
    slab (the C side's ``slab_offset``)."""
    npub = 6 if backward else 2
    floats = 8 + 2 * threads * vec + npub * c + 2 * c + 4
    return (4 * floats + 15) // 16 * 16


def _dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _ITEMSIZE:
        raise ValueError(f"K1/K2 take float32 or bfloat16, got {dtype}")
    return name


def _registers_split(B, S, C, G, isz, widest, backward):
    """(vector bytes, channel blocks, thread rows) of a launch without
    clusters whose blocks hold their rows in registers after one round of
    loads, or None. K1 splits C into blocks of whole groups until the grid
    has MIN_GRID blocks (K2 does not: its dγ/dβ teams would have a writer
    per block); in the latency-bound regime the narrowest vectors that
    allow it come first."""
    unroll = UNROLL[backward]
    widths = [widest]
    if B * S * C * isz <= LATENCY_BYTES:
        widths = [w for w in (4, 8, 16) if isz <= w <= widest]
    best = None
    for vb in widths:
        cv = C // (vb // isz)
        for d in ([1] if backward else range(1, cv + 1)):
            cb = C // d
            if (cv % d or cb % (C // G) or cv // d > MAX_THREADS
                    or (d > 1 and cb * isz < MIN_SEGMENT_BYTES)):
                continue
            trows = max(1, min(S, TARGET_THREADS // (cv // d)))
            if S > trows * unroll:
                continue
            if B * d >= MIN_GRID:
                return vb, d, trows
            if best is None or d > best[1]:
                best = (vb, d, trows)
    return best


def gn_launch_plan(B: int, S: int, C: int, G: int, dtype,
                   backward: bool, align: int = 16) -> GNPlan:
    """The launch of K1 (``backward=False``) or K2 for x [B, S, C] of
    ``dtype`` in G groups, with the data pointers aligned to ``align``
    bytes. Raises ``ValueError`` for what the kernels cannot take."""
    isz = _ITEMSIZE[_dtype_name(dtype)]
    if min(B, S, C, G) <= 0 or C % G != 0:
        raise ValueError(f"bad GroupNorm shape B={B} S={S} C={C} G={G}")
    vb = 16
    while vb > isz and (C % (vb // isz) or align % vb):
        vb //= 2
    if align % vb:
        raise ValueError(f"pointers aligned to {align} bytes, less than "
                         f"one element of {isz}")
    vec = vb // isz
    cv = C // vec
    if cv > MAX_THREADS:
        raise ValueError(f"a row of C={C} is {cv} vectors of {vb} bytes; "
                         f"the kernels take at most {MAX_THREADS}")
    row_bytes = C * isz * (2 if backward else 1)
    split = _registers_split(B, S, C, G, isz, vb, backward)
    if split is not None:
        vb, d, trows = split
        vec = vb // isz
        threads = trows * (C // vec // d)
        spb = 1
        if B * d > 2 * NUM_SMS:
            spb = max(1, min(MIN_BLOCK_BYTES // (S * row_bytes // d),
                             B * d // (2 * NUM_SMS)))
        team = spb * max(1, math.isqrt(-(-B // spb)))
        return GNPlan(vec_bytes=vb, vec=vec, threads=threads,
                      thread_rows=trows, cluster=1, channel_blocks=d,
                      samples_per_block=spb, rows_per_block=S,
                      blocks=d * -(-B // spb),
                      smem_bytes=_smem_fixed(threads, vec, C // d, backward),
                      slab="registers", team=team, teams=-(-B // team))

    def shape(cl):
        rows = -(-S // cl)
        trows = max(1, min(rows, TARGET_THREADS // cv))
        return rows, trows, _smem_fixed(trows * cv, vec, C, backward)

    if shape(1)[2] > MAX_SMEM_BYTES:
        raise ValueError(f"C={C}, G={G}: the reduction buffers alone "
                         f"exceed {MAX_SMEM_BYTES} bytes of shared memory")
    sizes = [cl for cl in (1, 2, 4, 8) if cl == 1 or cl <= S]
    fits = [cl for cl in sizes
            if shape(cl)[2] + shape(cl)[0] * row_bytes <= MAX_SMEM_BYTES]
    small = [cl for cl in fits
             if shape(cl)[0] * row_bytes <= SLAB_TARGET_BYTES]
    cl = small[0] if small else (fits[-1] if fits else sizes[-1])
    # More blocks where the batch alone does not cover the SMs.
    while (B * cl < NUM_SMS and 2 * cl in sizes
           and shape(2 * cl)[0] * row_bytes >= MIN_BLOCK_BYTES):
        cl *= 2
    rows, trows, fixed = shape(cl)
    threads = trows * cv
    slab_bytes = rows * row_bytes
    if not fits:
        slab = "reread"
    elif rows * cv <= threads * UNROLL[backward]:
        slab = "registers"
    else:
        slab = "shared"
    spb = 1
    if cl == 1 and B > 2 * NUM_SMS:
        spb = max(1, min(MIN_BLOCK_BYTES // (S * row_bytes),
                         B // (2 * NUM_SMS)))
    # K2's teams: about sqrt(B) samples each, a whole number of blocks.
    team = spb * max(1, math.isqrt(-(-B // spb)))
    return GNPlan(vec_bytes=vb, vec=vec, threads=threads, thread_rows=trows,
                  cluster=cl, channel_blocks=1, samples_per_block=spb,
                  rows_per_block=rows,
                  blocks=cl * -(-B // spb),
                  smem_bytes=fixed + (slab_bytes if slab == "shared" else 0),
                  slab=slab, team=team, teams=-(-B // team))


def _alignment(*tensors) -> int:
    """The largest power of two ≤ 16 that divides every data pointer."""
    align = 16
    for t in tensors:
        if t is not None:
            align = math.gcd(align, t.data_ptr())
    return align


def plan_for_call(x: torch.Tensor, num_groups: int, backward: bool,
                  *others: torch.Tensor) -> GNPlan:
    """The plan with which K1 (K2 for ``backward``) runs on NHWC ``x`` and
    the other data tensors of the call (outputs, dy)."""
    b, h, w, c = x.shape
    return gn_launch_plan(b, h * w, c, num_groups, x.dtype, backward,
                          _alignment(x, *others))


#: K2's ticket counters by (device, stream): int32, 0 between calls (the
#: kernel resets each one it used).
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=device)
    return t


def resolve_num_groups(num_channels: int, num_groups: int = 32) -> int:
    """Largest group count ≤ ``num_groups`` that divides ``num_channels``."""
    g = min(num_groups, num_channels)
    while num_channels % g != 0 and g > 1:
        g -= 1
    return g


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32/bf16 input (as the reference), f64 for f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def group_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, time_bias: Optional[torch.Tensor] = None,
                 eps: float = 1e-5):
    """The per-sample channel affine ``(a, b)``, [B, C] in f32 (f64 for
    f64 input), with which GroupNorm(+time bias) of NHWC ``x`` is
    ``x·a + b``: per-channel sums Σx and Σx² with the time bias folded in,
    group statistics from them (variance clamped at 0), as
    ``group_norm_silu_xla`` and ``_block_stats`` take them."""
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
    return a, b_


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
    a, b_ = group_affine(x, scale, bias, num_groups, time_bias, eps)
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
    plan = plan_for_call(x, num_groups, False, out)
    GN_KERNEL(x.data_ptr(), tb.data_ptr() if tb is not None else None,
              scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
              b, h * w, c, num_groups, float(eps), int(apply_silu),
              int(x.dtype == torch.bfloat16), *plan.launch_args(),
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
    plan = plan_for_call(x, num_groups, True, dy, dx)
    scratch = torch.empty((2, b + plan.teams, c), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets = _tickets(x.device, stream, 1 + plan.teams)
    GN_BWD_KERNEL(x.data_ptr(), tb.data_ptr() if tb is not None else None,
                  scale.data_ptr(), bias.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                  dtb.data_ptr() if dtb is not None else None,
                  scratch.data_ptr(), tickets.data_ptr(),
                  b, h * w, c, num_groups, float(eps), int(apply_silu),
                  int(x.dtype == torch.bfloat16), *plan.launch_args(),
                  plan.team, stream)
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
    backward recomputes them from x, as the reference's ``custom_vjp``.
    On the CPU the plain backward is itself differentiable; on CUDA a
    backward asked for a graph (``create_graph=True``) raises, because K2
    records none (the reference never differentiates its Pallas K2 twice
    either: ``EnergyNet`` calls the XLA version)."""

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
        if (x.device.type != "cpu" and torch.is_grad_enabled()
                and any(t is not None and t.requires_grad
                        for t in (x, scale, bias, time_bias, dy))):
            # K2 computes outside autograd: its gradients would carry no
            # graph, and a second derivative would be silently wrong.
            raise RuntimeError(
                "group_norm_silu on CUDA has no second derivative: its "
                "backward (kernel K2) records no graph. Differentiate "
                "group_norm_silu_plain instead where a graph of the "
                "backward is needed (create_graph=True)")
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
