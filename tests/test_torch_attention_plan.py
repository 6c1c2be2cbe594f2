"""Kernel K3's design on the CPU: its launch plan and a numpy walk of its
tiles (no JAX, well under a second).

``csrc/attention.cu`` runs only on the card. What it does to the numbers
is emulated here in float64 exactly as the kernel walks its work: blocks
of 4 warps × 16 query rows (four (batch, head) pairs a block for S ≤ 16),
stages of 64 rows × 64 columns (128 in bf16 with four heads a block and
D > 64)
filled with zeros past S, D and the last head, the logits summed over D
stage by stage, an online softmax (running
max and sum, the accumulator rescaled), and the output up to 256 columns
at a time. Without rounding the walk equals ``mha_plain`` in f64 to 1e-12; with
the kernel's bf16 rounding of the unnormalised probabilities it stays
within one bf16 rounding of them, 2^-8 · max |v|.
"""

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import attention as attn_ops

torch.set_num_threads(2)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).float().to(torch.bfloat16).double().numpy()


def _stage(src, plan, hg, kt, col0):
    """One stage as the kernel fills it: row r holds key kt·KT + r % KT of
    the block's (r // KT)-th head, columns col0 .. col0 + cols − 1; zeros
    past S, D and the last head."""
    bn, s, d = src.shape
    r = np.arange(attn_ops.MHA_STAGE_ROWS)
    bh, j = hg * plan.heads + r // plan.keys, kt * plan.keys + r % plan.keys
    ok = (bh < bn) & (j < s)
    st = np.zeros((attn_ops.MHA_STAGE_ROWS, plan.cols))
    cols = src[np.minimum(bh, bn - 1), np.minimum(j, s - 1),
               col0:col0 + plan.cols]
    st[:, :cols.shape[1]] = np.where(ok[:, None], cols, 0.0)
    return st


def emulate_k3(q, k, v, round_p=False, dtype=torch.bfloat16):
    """K3's walk over [B, N, S, D] in float64, with the bf16 (or f32)
    kernel's plan; ``round_p`` rounds the unnormalised probabilities to
    bf16 before P·V, as the bf16 kernel."""
    b, n, s, d = q.shape
    plan = attn_ops.mha_launch_plan(b, n, s, d, dtype)
    bn, ch, kt_n = b * n, plan.cols, plan.key_tiles
    qf, kf, vf = (a.reshape(bn, s, d) for a in (q, k, v))
    out = np.full((bn, s, d), np.nan)
    covered = np.zeros((bn, s), int)
    scale = d ** -0.5
    for blk in range(plan.blocks):
        hg, qt = divmod(blk, plan.q_tiles)
        for warp in range(attn_ops.MHA_WARPS):
            hw = warp if plan.heads > 1 else 0
            bh = hg * plan.heads + hw
            q0 = qt * plan.query_rows + (16 * warp if plan.heads == 1 else 0)
            if bh >= bn or q0 >= s:
                continue
            rows = np.arange(q0, q0 + 16)
            ok = rows < s
            qr = np.zeros((16, plan.chunks * ch))
            qr[ok, :d] = qf[bh, rows[ok]]
            mine = slice(hw * plan.keys, (hw + 1) * plan.keys)
            wide = ch * plan.outs
            for c in range(plan.out_chunks):
                m, l = np.full(16, -np.inf), np.zeros(16)
                o = np.zeros((16, wide))
                for kt in range(kt_n):
                    sc = np.zeros((16, plan.keys))
                    for part in range(plan.chunks):
                        ks = _stage(kf, plan, hg, kt, ch * part)[mine]
                        sc += qr[:, ch * part:ch * (part + 1)] @ ks.T
                    keys = kt * plan.keys + np.arange(plan.keys)
                    sc = np.where(keys < s, sc * scale, -np.inf)
                    mt = np.maximum(m, sc.max(1))
                    alpha, p = np.exp(m - mt), np.exp(sc - mt[:, None])
                    l, m = l * alpha + p.sum(1), mt
                    o *= alpha[:, None]
                    for vp in range(plan.outs):
                        col = wide * c + ch * vp
                        vs = _stage(vf, plan, hg, kt, col)[mine]
                        o[:, ch * vp:ch * (vp + 1)] += \
                            (_bf16(p) if round_p else p) @ vs
                width = max(0, min(wide, d - wide * c))
                out[bh, rows[ok], wide * c:wide * c + width] = \
                    (o / l[:, None])[ok, :width]
            covered[bh, rows[ok]] += 1
    assert (covered == 1).all(), "the plan must cover every query row once"
    return out.reshape(b, n, s, d)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) * 1.5 for _ in range(3)]


@pytest.mark.parametrize("s", [1, 17, 65, 300])
@pytest.mark.parametrize("d", [24, 64, 128])
def test_tile_walk_matches_plain_f64(s, d):
    """The walk equals mha_plain in f64 (1e-12) at ragged S and D, B·N = 6
    (a partial group of four heads at S ≤ 16), with either dtype's stage
    width; with the bf16 rounding of the unnormalised P it stays within
    2^-8 · max |v|."""
    q, k, v = _qkv((2, 3, s, d), seed=s * 1000 + d)
    want = attn_ops.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    want = want.numpy()
    for dtype in (torch.bfloat16, torch.float32):
        np.testing.assert_allclose(emulate_k3(q, k, v, dtype=dtype), want,
                                   atol=1e-12, rtol=1e-12)
    got = emulate_k3(q, k, v, round_p=True)
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(v).max()


def test_tile_walk_handles_large_logits():
    """Logits of ±1e3 (the running max moves by hundreds between key
    tiles) stay finite and exact: the online rescaling never overflows."""
    q, k, v = _qkv((1, 2, 130, 16), seed=3)
    q = q * 40.0
    want = attn_ops.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(emulate_k3(q, k, v), want.numpy(), atol=1e-12)


@pytest.mark.parametrize("d", [300, 520])
def test_tile_walk_recomputes_logits_per_output_chunk(d):
    """D over 256 takes the output in chunks of 256 columns (the last one
    ragged), the logits recomputed for each: still mha_plain in f64."""
    q, k, v = _qkv((1, 2, 20, d), seed=d)
    assert attn_ops.mha_launch_plan(1, 2, 20, d).out_chunks == 2 + (d > 512)
    assert attn_ops.mha_launch_plan(1, 2, 8, d).out_chunks == 2 + (d > 512)
    want = attn_ops.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(emulate_k3(q, k, v), want.numpy(), atol=1e-12,
                               rtol=1e-12)


@pytest.mark.parametrize("d", [1, 24, 65, 128, 257, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_fits_and_covers_every_s(d, dtype):
    """For every S up to 4096: the static shared memory fits 227 KB (and
    the 48 KB a block gets without opting in), the D-chunks cover D with
    none empty, the key tiles cover S, the blocks cover every (batch,
    head, query row), the output chunk fits its kernel instance, and four
    heads share a block exactly when S ≤ 16."""
    b, n = 3, 5
    for s in range(1, 4097):
        p = attn_ops.mha_launch_plan(b, n, s, d, dtype)
        assert p.smem_bytes <= min(attn_ops.MAX_SMEM_BYTES, 48 * 1024)
        assert p.cols == (128 if dtype == torch.bfloat16 and s <= 16
                          and d > 64 else 64)
        assert (p.chunks - 1) * p.cols < d <= p.chunks * p.cols
        assert p.outs == min(p.chunks, 256 // p.cols)
        # Within the kernel instance's output chunk: 1 stage of v for
        # 64-column stages of four bf16 heads, 2 of 128 columns, else 4.
        widest = (1 if dtype == torch.bfloat16 and p.heads == 4
                  and p.cols == 64 else 2 if p.cols == 128 else 4)
        assert p.outs <= widest
        assert (p.out_chunks - 1) * p.cols * p.outs < d <= \
            p.out_chunks * p.cols * p.outs
        assert p.heads == (4 if s <= 16 else 1)
        assert p.keys * p.heads == attn_ops.MHA_STAGE_ROWS
        assert (p.key_tiles - 1) * p.keys < s <= p.key_tiles * p.keys
        assert p.query_rows * p.heads == 16 * attn_ops.MHA_WARPS
        assert (p.q_tiles - 1) * p.query_rows < s <= p.q_tiles * p.query_rows
        assert p.blocks == -(-(b * n) // p.heads) * p.q_tiles
        assert p.units == p.out_chunks * p.key_tiles * (p.chunks + p.outs)


def test_launch_plan_of_the_unet_shapes():
    """The UNet's shapes: 4 heads at 32² (S=16, D=64 and S=1, D=128: four
    heads a block, one key tile, one stage of k and one of v in bf16), and
    the 128² forward that the old kernel refused (S=256, D=64: four key
    tiles); non-positive sizes raise."""
    p = attn_ops.mha_launch_plan(16, 4, 16, 64)
    assert (p.heads, p.key_tiles, p.blocks, p.chunks, p.units) == \
        (4, 1, 16, 1, 2)
    p = attn_ops.mha_launch_plan(16, 4, 1, 128)
    assert (p.heads, p.cols, p.blocks, p.chunks, p.units) == \
        (4, 128, 16, 1, 2)
    p = attn_ops.mha_launch_plan(16, 4, 1, 128, torch.float32)
    assert (p.cols, p.chunks, p.out_chunks, p.units) == (64, 2, 1, 4)
    p = attn_ops.mha_launch_plan(1, 4, 256, 64)
    assert (p.heads, p.key_tiles, p.q_tiles, p.blocks) == (1, 4, 4, 16)
    with pytest.raises(ValueError, match="positive"):
        attn_ops.mha_launch_plan(1, 4, 0, 64)
