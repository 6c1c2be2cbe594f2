"""K1's and K2's launch plan, on the CPU: what the GroupNorm kernels take
and how they cut a call, held against the plain versions.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
there). These tests cover the Python that chooses their launch and what
their arithmetic assumes:

* :func:`gn_launch_plan` at every K1 and K2 shape of the full-width UNet
  (``ddpm_config.yaml``: C=128, 32²) at the serving batch 16 and the
  training batch 128, in bf16 and f32: each plan fits a block's 227 KB of
  shared memory and a cluster of at most 8, its threads meet one column of
  vectors each, and its blocks cover every element of [B, S, C] once;
* a numpy emulation of the kernels' partition and sum order (per-channel
  partials per thread row and block, the cluster's ranks in order, the
  fold to groups, then the apply or dx, and K2's fixed-order sum of dγ/dβ
  over the batch) against ``group_norm_silu_plain`` and
  ``group_norm_silu_bwd_plain`` in f64, at group sizes 3 to 256 and S from
  1 to 4096, with and without the time bias and SiLU;
* the plan's vector widths and its refusals.

numpy and torch only; no JAX model is built. The file takes a few seconds.
"""

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import group_norm as gn_ops

EPS = 1e-5
#: The (S, C, G) of every GroupNorm call of one full-width UNet forward
#: and training step, as ``chip_smoke.py`` records them (the same set at
#: B=16 and B=128; each also with and without time bias and SiLU).
UNET_SHAPES = [(1, 512, 16), (1, 512, 32), (4, 256, 32), (4, 512, 32),
               (4, 768, 32), (16, 256, 16), (16, 256, 32), (64, 128, 32),
               (64, 256, 32), (64, 384, 32), (256, 128, 16), (256, 128, 32),
               (1024, 128, 32)]
DTYPES = ["bfloat16", "float32"]


def _blocks(plan, B, S):
    """(block, sample, rank, first row, end row, channel block) of each
    sample a block takes, as the kernels derive them from blockIdx and the
    cluster rank."""
    out = []
    for blk in range(plan.blocks):
        cid, rank = divmod(blk, plan.cluster)
        group, cs = divmod(cid, plan.channel_blocks)
        for j in range(plan.samples_per_block):
            b = group * plan.samples_per_block + j
            if b >= B:
                break
            r0 = rank * plan.rows_per_block
            out.append((blk, b, rank, r0,
                        max(r0, min(S, r0 + plan.rows_per_block)), cs))
    return out


def _check_plan(plan, B, S, C, G, dtype, backward):
    isz = 2 if dtype == "bfloat16" else 4
    cb = C // plan.channel_blocks   # a block's channels: whole groups
    assert cb * plan.channel_blocks == C and cb % (C // G) == 0
    assert plan.vec * isz == plan.vec_bytes and cb % plan.vec == 0
    assert plan.threads == plan.thread_rows * (cb // plan.vec)
    assert 0 < plan.threads <= gn_ops.MAX_THREADS
    assert 1 <= plan.cluster <= gn_ops.MAX_CLUSTER
    assert plan.samples_per_block == 1 or plan.cluster == 1
    # C splits only in K1, on the registers path without a cluster.
    assert plan.channel_blocks == 1 or (
        not backward and plan.slab == "registers" and plan.cluster == 1)
    assert plan.smem_bytes <= gn_ops.MAX_SMEM_BYTES
    planes = 2 if backward else 1
    slab = plan.rows_per_block * cb * isz * planes
    fixed = gn_ops._smem_fixed(plan.threads, plan.vec, cb, backward)
    assert plan.smem_bytes == fixed + (slab if plan.slab == "shared" else 0)
    if plan.slab == "registers":   # one round of loads holds the rows
        assert (plan.rows_per_block * (cb // plan.vec)
                <= plan.threads * gn_ops.UNROLL[backward])
    assert plan.team % plan.samples_per_block == 0
    assert plan.teams == -(-B // plan.team)
    # The blocks' (rows, channel blocks) tile [B, S, C] exactly once.
    seen = np.zeros((B, S, plan.channel_blocks), np.int32)
    for _, b, _, r0, r1, cs in _blocks(plan, B, S):
        seen[b, r0:r1, cs] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch", [16, 128])
@pytest.mark.parametrize("shape", UNET_SHAPES)
def test_unet_plans_fit_the_card_and_cover_every_element(shape, batch):
    S, C, G = shape
    for dtype in DTYPES:
        for backward in (False, True):
            plan = gn_ops.gn_launch_plan(batch, S, C, G, dtype, backward)
            _check_plan(plan, batch, S, C, G, dtype, backward)
            # Every width is whole 16-byte vectors; narrower ones only
            # where the call is small enough to be latency-bound.
            isz = 2 if dtype == "bfloat16" else 4
            assert (plan.vec_bytes == 16
                    or batch * S * C * isz <= gn_ops.LATENCY_BYTES)
            # The full-width UNet keeps every slab on chip, and at B=128
            # every shape fills the 132 SMs.
            assert plan.keep
            if batch == 128:
                assert plan.blocks >= 128


def test_large_samples_take_clusters_and_the_re_read_path():
    """S=1024, C=128 (256 KB a sample in bf16) does not fit one block: a
    cluster splits it. At the 64² config's S=4096 K1 in f32 and K2 in both
    dtypes cannot keep their slab even in an 8-block cluster, and read
    again."""
    for dtype in DTYPES:
        for backward in (False, True):
            plan = gn_ops.gn_launch_plan(128, 1024, 128, 32, dtype, backward)
            assert plan.cluster > 1 and plan.keep
    keep = {(dtype, backward): gn_ops.gn_launch_plan(
        2, 4096, 128, 32, dtype, backward).keep
        for dtype in DTYPES for backward in (False, True)}
    assert keep == {("bfloat16", False): True, ("float32", False): False,
                    ("bfloat16", True): False, ("float32", True): False}
    # One whole sample a block at small S, several at a large batch.
    assert gn_ops.gn_launch_plan(128, 4, 256, 32, "bfloat16",
                                 False).cluster == 1
    assert gn_ops.gn_launch_plan(600, 1, 512, 32, "bfloat16",
                                 True).samples_per_block == 2


@pytest.mark.parametrize("C,dtype,align,vec_bytes", [
    (128, "bfloat16", 16, 16), (12, "bfloat16", 16, 8),
    (6, "bfloat16", 16, 4), (3, "bfloat16", 16, 2), (12, "float32", 16, 16),
    (6, "float32", 16, 8), (3, "float32", 16, 4), (128, "bfloat16", 4, 4),
    (128, "float32", 8, 8)])
def test_vector_width_follows_the_row_and_the_alignment(C, dtype, align,
                                                        vec_bytes):
    """The widest vector the row and the pointers allow, at a call too
    large to be latency-bound."""
    plan = gn_ops.gn_launch_plan(64, 1024, C, 1, dtype, False, align)
    assert plan.vec_bytes == vec_bytes


def test_latency_bound_calls_take_narrow_vectors():
    """A tiny call gives each thread fewer channels: 4-byte vectors (two
    bf16 channels) at B=16, S=1, C=512, and C split into 8 blocks of
    whole groups for K1."""
    plan = gn_ops.gn_launch_plan(16, 1, 512, 32, "bfloat16", False)
    assert (plan.vec_bytes, plan.channel_blocks, plan.blocks) == (4, 8, 128)
    plan = gn_ops.gn_launch_plan(16, 1, 512, 32, "bfloat16", True)
    assert (plan.vec_bytes, plan.channel_blocks) == (4, 1)


@pytest.mark.parametrize("args,match", [
    ((2, 4, 32, 5, "float32"), "bad GroupNorm shape"),
    ((0, 4, 32, 8, "float32"), "bad GroupNorm shape"),
    ((2, 4, 32, 8, "float16"), "float32 or bfloat16"),
    ((1, 1, 16384, 32, "float32"), "at most 512"),
    ((1, 1, 8192, 32, "bfloat16"), "at most 512"),
    ((1, 1, 1025, 5, "float32"), "at most 512")])
def test_plan_refuses_what_the_kernels_cannot_take(args, match):
    for backward in (False, True):
        with pytest.raises(ValueError, match=match):
            gn_ops.gn_launch_plan(*args, backward)
    with pytest.raises(ValueError, match="less than one element"):
        gn_ops.gn_launch_plan(2, 4, 32, 8, "bfloat16", False, align=1)


# -- the numpy emulation -----------------------------------------------------

def _block_partials(v, r0, r1, R):
    """Per-channel sums of rows [r0, r1) of v [S, C] as a block takes
    them: thread row t sums rows r0+t, r0+t+R, ... ; then the thread rows
    in order."""
    part = np.zeros(v.shape[1])
    for t in range(R):
        part = part + v[r0 + t:r1:R].sum(axis=0)
    return part


def _cluster_sum(plan, mine, v):
    """The per-channel totals of one sample that its blocks hold: for each
    block of channels, each rank's block partials of v, summed in rank
    order 0, 1, ..."""
    cb = v.shape[1] // plan.channel_blocks
    tot = np.zeros(v.shape[1])
    for cs in range(plan.channel_blocks):
        cols = slice(cs * cb, (cs + 1) * cb)
        pub = {rank: _block_partials(v[:, cols], r0, r1, plan.thread_rows)
               for _, _, rank, r0, r1, c in mine if c == cs}
        assert sorted(pub) == list(range(plan.cluster))
        for rank in range(plan.cluster):
            tot[cols] = tot[cols] + pub[rank]
    return tot


def _group_fold(t1, t2, G, n):
    """Per-channel mean and rstd from per-channel totals of v and v²."""
    cg = t1.shape[0] // G
    mean = t1.reshape(G, cg).sum(1) / n
    var = np.maximum(t2.reshape(G, cg).sum(1) / n - mean * mean, 0.0)
    return (np.repeat(mean, cg), np.repeat(1.0 / np.sqrt(var + EPS), cg))


def emulate_fwd(plan, x, scale, bias, G, tb, silu):
    B, S, C = x.shape
    n = S * (C // G)
    blocks = _blocks(plan, B, S)
    out = np.zeros_like(x)
    writes = np.zeros((B, S), int)
    for b in range(B):
        mine = [blk for blk in blocks if blk[1] == b]
        tbb = tb[b] if tb is not None else np.zeros(C)
        v = x[b] + tbb
        mean, rstd = _group_fold(_cluster_sum(plan, mine, v),
                                 _cluster_sum(plan, mine, v * v), G, n)
        a = rstd * scale
        sh = bias + (tbb - mean) * a
        cb = C // plan.channel_blocks
        for _, _, _, r0, r1, cs in mine:
            cols = slice(cs * cb, (cs + 1) * cb)
            y = x[b, r0:r1, cols] * a[cols] + sh[cols]
            out[b, r0:r1, cols] = y / (1.0 + np.exp(-y)) if silu else y
            writes[b, r0:r1] += 1
    assert (writes == plan.channel_blocks).all()
    return out


def emulate_bwd(plan, x, scale, bias, G, tb, dy, silu):
    B, S, C = x.shape
    n = S * (C // G)
    cg = C // G
    blocks = _blocks(plan, B, S)
    dx = np.zeros_like(x)
    dtb = np.zeros((B, C))
    scratch = np.zeros((2, B, C))
    writes = np.zeros((B, S), int)
    for b in range(B):
        mine = [blk for blk in blocks if blk[1] == b]
        tbb = tb[b] if tb is not None else np.zeros(C)
        v = x[b] + tbb
        mean, rstd = _group_fold(_cluster_sum(plan, mine, v),
                                 _cluster_sum(plan, mine, v * v), G, n)
        xhat = (v - mean) * rstd
        if silu:
            z = scale * xhat + bias
            sig = 1.0 / (1.0 + np.exp(-z))
            dz = dy[b] * (sig * (1.0 + z * (1.0 - sig)))
        else:
            dz = dy[b]
        pg = _cluster_sum(plan, mine, dz * xhat)
        pb = _cluster_sum(plan, mine, dz)
        scratch[0, b], scratch[1, b] = pg, pb
        q1 = np.repeat((scale * pb).reshape(G, cg).sum(1) / n, cg)
        q2 = np.repeat((scale * pg).reshape(G, cg).sum(1) / n, cg)
        d = rstd * (dz * scale - (q1 + xhat * q2))
        cb = C // plan.channel_blocks
        for _, _, _, r0, r1, cs in mine:
            cols = slice(cs * cb, (cs + 1) * cb)
            dx[b, r0:r1, cols] = d[r0:r1, cols]
            writes[b, r0:r1] += 1
        dtb[b] = _cluster_sum(plan, mine, d)
    assert (writes == plan.channel_blocks).all()
    # The last writer of each team sums the team's samples, the last
    # team's finisher the team rows.
    teams = np.stack([_rows_sum(scratch[:, t:t + plan.team], plan)
                      for t in range(0, B, plan.team)], axis=1)
    assert teams.shape[1] == plan.teams
    dgb = _rows_sum(teams, plan)
    return dx, dgb[0], dgb[1], dtb


def _rows_sum(rows, plan):
    """Sum over axis 1 of rows [2, n, C] as K2's rows_sum takes it: P runs
    of consecutive rows, then the runs in order."""
    n, C = rows.shape[1:]
    quads = C // 4 if C % 4 == 0 else C
    red = plan.thread_rows * C // plan.channel_blocks   # floats a half
    P = max(1, min(plan.threads // quads, n, red // C))
    run = -(-n // P)
    out = np.zeros((2, C))
    for p in range(P):
        out = out + rows[:, p * run:(p + 1) * run].sum(axis=1)
    return out


#: (B, S, C, G, time bias, SiLU): group sizes 3, 4, 12, 16, 24 and 256;
#: S = 1, 4, 1024 and 4096 (clusters, and at 4096 the re-read path); a
#: batch of 600 single-pixel samples (two samples a block).
EMU_CASES = [(3, 4, 12, 4, True, True), (2, 1024, 128, 32, True, True),
             (3, 4, 384, 32, False, True), (5, 1, 256, 16, True, False),
             (2, 1024, 48, 2, False, False), (2, 4096, 256, 1, True, True),
             (2, 4096, 128, 32, False, True), (600, 1, 12, 4, True, True)]


def _emu_inputs(B, S, C, has_tb, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, C)) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, size=C)
    bias = rng.normal(size=C) * 0.1
    tb = rng.normal(size=(B, C)) * 0.5 if has_tb else None
    dy = rng.normal(size=(B, S, C))
    return x, scale, bias, tb, dy


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_k1_matches_the_plain_version(case, dtype):
    B, S, C, G, has_tb, silu = case
    x, scale, bias, tb, _ = _emu_inputs(B, S, C, has_tb, seed=S + C)
    plan = gn_ops.gn_launch_plan(B, S, C, G, dtype, False)
    got = emulate_fwd(plan, x, scale, bias, G, tb, silu)
    want = gn_ops.group_norm_silu_plain(
        torch.from_numpy(x).reshape(B, 1, S, C), _t(scale), _t(bias), G,
        _t(tb), EPS, silu).reshape(B, S, C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_k2_matches_the_plain_version(case, dtype):
    B, S, C, G, has_tb, silu = case
    x, scale, bias, tb, dy = _emu_inputs(B, S, C, has_tb, seed=S + C + 1)
    plan = gn_ops.gn_launch_plan(B, S, C, G, dtype, True)
    dx, dscale, dbias, dtb = emulate_bwd(plan, x, scale, bias, G, tb, dy,
                                         silu)
    want = gn_ops.group_norm_silu_bwd_plain(
        torch.from_numpy(x).reshape(B, 1, S, C), _t(scale), _t(bias),
        _t(tb), torch.from_numpy(dy).reshape(B, 1, S, C), G, EPS, silu)
    for got, w in zip((dx.reshape(B, 1, S, C), dscale, dbias), want):
        np.testing.assert_allclose(got, w.numpy(), rtol=1e-9, atol=1e-9)
    if has_tb:
        np.testing.assert_allclose(dtb, want[3].numpy(), rtol=1e-9,
                                   atol=1e-9)
    else:
        assert want[3] is None
