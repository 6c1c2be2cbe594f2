"""K6's routes and the sm90 route's launch plan, on the CPU, held against
the plain version.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 10 holds
them there). These tests cover what surrounds them in Python and what the
sm90 kernel's arithmetic assumes:

* :func:`out_head_route` sends every shape phase 10 holds to the route
  its dtype and size call for, and refuses what no route takes; phase
  10's holds launch every template instance of both K6 kernels;
* :func:`out_head_launch_plan` fits 227 KB and a cluster of at most 8,
  and its blocks cover each sample's rows exactly once;
* a numpy emulation of ``csrc/out_head_sm90.cu``'s partition: the bands
  of a cluster, each thread's 16-byte vectors, the per-channel sums over
  thread rows and then over ranks in rank order, the group fold,
  P = y · Wt over groups of m16 tiles with their clamped rows and
  zero-padded columns, stored column-major, the halo rows each rank
  writes into its neighbours (the taps they need of its first and last
  rows), and the 3×3 sum over its own P and halo rows, equals
  ``out_head_plain`` in f64;
* :func:`pack_out_head_weight`'s layout.

No JAX is imported; the file takes a few seconds.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import boundary_conv as bc

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "diffusion_model_universal_torch" / "csrc"

BF16, F32 = torch.bfloat16, torch.float32

#: (B, H, C, G, Cout, dtype, route): the K6 calls phase 10 of
#: chip_smoke.py holds (square images).
PHASE10_CALLS = [
    (2048, 32, 128, 32, 3, BF16, "sm90"),   # the CLI's bench shape
    (16, 32, 128, 32, 3, F32, "f32"),
    (4, 16, 128, 32, 3, F32, "f32"),        # the CLI's --check inputs
    (4, 16, 128, 32, 3, BF16, "sm90"),
    (256, 28, 64, 32, 1, BF16, "sm90"),     # MNIST's out-head
    (16, 28, 64, 32, 1, F32, "f32"),
    (16, 28, 64, 32, 2, BF16, "sm90"),
    (256, 64, 128, 32, 3, BF16, "sm90"),    # a sample of 1 MB
    (64, 8, 512, 32, 3, BF16, "sm90"),
    (4, 2, 2048, 32, 3, BF16, "sm90"),
    (64, 32, 128, 16, 3, BF16, "sm90"),
    (1, 32, 128, 32, 3, BF16, "sm90"),
    (8, 32, 128, 32, 6, BF16, "sm90"),
    (4, 16, 64, 32, 1, BF16, "sm90"),       # Cout 1, one m16 tile a warp
    (8, 16, 96, 32, 3, BF16, "simt"),       # C not a multiple of 64
    (4, 64, 256, 32, 3, BF16, "simt"),      # no 8-block cluster holds it
    *[(2, 8, 96, 32, cout, dtype, route) for cout in range(1, 8)
      for dtype, route in ((BF16, "simt"), (F32, "f32"))],
    (64, 32, 128, 32, 8, BF16, "sm90"),      # passes of at most 7
    (64, 32, 128, 32, 16, BF16, "sm90"),
    (16, 32, 128, 32, 12, F32, "f32"),
    (2, 8, 96, 32, 9, BF16, "simt"),
    (2, 4, 2048, 32, 3, F32, "f32"),        # chunks of C
    (2, 4, 1760, 32, 3, F32, "f32"),
    *[(2, 4, 2080, 32, cout, BF16, "simt") for cout in range(1, 8)],
    (1, 700, 64, 32, 3, F32, "f32"),        # column tiles
    (2, 8, 12, 4, 3, BF16, "simt"),         # element loads
    (2, 8, 12, 4, 5, F32, "f32"),
]


def _label(call):
    b, h, c, g, cout, dtype, _ = call
    return f"B{b}-{h}x{h}-C{c}-G{g}-{cout}-{str(dtype)[6:]}"


@pytest.mark.parametrize("call", PHASE10_CALLS, ids=_label)
def test_route_and_plan_of_each_phase10_call(call):
    b, h, c, g, cout, dtype, route = call
    assert bc.out_head_route((b, h, h, c), (3, 3, c, cout), g,
                             dtype) == route
    if route != "sm90":
        plan = bc.out_head_simt_plan(h, h, c, g, cout)
        assert plan.smem_bytes <= bc.MAX_SMEM_BYTES
        assert [k for p in plan.passes for k in range(*p)] == list(
            range(cout))
        assert [i for p in plan.chunks for i in range(*p)] == list(range(c))
        assert all((c1 - c0) % (c // g) == 0 and c1 - c0 <= bc.MAX_C
                   for c0, c1 in plan.chunks)
        assert all(k1 - k0 <= bc.MAX_COUT for k0, k1 in plan.passes)
        return
    plan = bc.out_head_launch_plan(b, h, h, c, g, cout)
    assert plan.cluster in (1, 2, 4, 8)
    bands = [range(r * plan.rows, min(h, (r + 1) * plan.rows))
             for r in range(plan.cluster)]
    assert sorted(y for band in bands for y in band) == list(range(h))
    assert all(len(band) > 0 for band in bands)
    assert plan.threads % 32 == 0 and plan.threads % (c // 8) == 0
    assert plan.threads <= bc.SM90_MAX_THREADS
    widest = max(k1 - k0 for k0, k1 in plan.passes)
    assert plan.passes == bc.out_head_passes(cout)
    assert plan.columns == bc.out_head_columns(widest) >= 9 * widest
    assert plan.mtiles in (1, 2) and (plan.mtiles == 1 or plan.columns <= 32)
    group = 16 * plan.mtiles
    assert plan.p_stride >= -(-plan.rows * h // group) * group
    assert plan.p_stride % 32 == 4
    assert plan.smem_bytes == bc.out_head_sm90_smem_bytes(
        plan.rows, h, c, plan.columns, plan.p_stride, plan.threads, widest)
    assert plan.smem_bytes <= bc.MAX_SMEM_BYTES
    assert bc.out_head_blocks_per_sm(plan.smem_bytes, plan.threads) >= 1


def test_plans_of_the_timed_shapes():
    """The plan keeps the most blocks on an SM: at the bench shape three
    blocks of 128 threads (a block's copy, barriers and product then
    overlap the others'); at MNIST's width four; a 1 MB sample fills an SM
    with one block of 256 threads."""
    plan = bc.out_head_launch_plan(2048, 32, 32, 128, 32, 3)
    assert (plan.cluster, plan.rows, plan.threads, plan.mtiles,
            plan.smem_bytes) == (8, 4, 128, 2, 72192)
    assert bc.out_head_blocks_per_sm(plan.smem_bytes, plan.threads) == 3
    plan = bc.out_head_launch_plan(2048, 28, 28, 64, 32, 1)
    assert (plan.cluster, plan.rows, plan.threads) == (4, 7, 128)
    assert bc.out_head_blocks_per_sm(plan.smem_bytes, plan.threads) == 4
    plan = bc.out_head_launch_plan(256, 64, 64, 128, 32, 3)
    assert (plan.cluster, plan.rows, plan.threads, plan.mtiles) == (8, 8,
                                                                   256, 2)
    assert bc.out_head_blocks_per_sm(plan.smem_bytes, plan.threads) == 1
    # Of cuts that keep as many blocks, the smaller cluster; a small batch
    # spreads over the largest cluster.
    plan = bc.out_head_launch_plan(2048, 16, 16, 128, 32, 3)
    assert (plan.cluster, plan.rows) == (4, 4)
    assert bc.out_head_launch_plan(1, 32, 32, 128, 32, 3).cluster == 8


def test_phase10_holds_every_kernel_instance():
    """chip_smoke.py's ``K6_HOLDS`` launch every template instance the two
    K6 sources build: the sm90 kernel's (n-tiles, m16 tiles a warp) pairs
    that ``pick`` returns, and the CUDA-core kernel's Cout cases in bf16
    (simt, one chunk of C), bf16 into an f32 output (simt, chunks of C)
    and f32."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sm90 = {tuple(map(int, m)) for m in re.findall(
        r"out_head_sm90_kernel<(\d+), (\d+)>",
        (CSRC / "out_head_sm90.cu").read_text())}
    simt = {int(m) for m in re.findall(
        r"case (\d+): return launch_out_head<T, TO, \1>",
        (CSRC / "boundary_conv.cu").read_text())}
    pairs = set(re.findall(r"launch_out_head_cout<(\w+), (\w+)>",
                           (CSRC / "boundary_conv.cu").read_text()))
    assert len(sm90) == 5 and simt == set(range(1, bc.MAX_COUT + 1))
    assert pairs == {("bf16", "float"), ("bf16", "bf16"), ("float", "float")}
    held = {"sm90": set(), "simt": set(), "simt_f32_out": set(),
            "f32": set()}
    for b, h, c, g, cout, dname, route in smoke.K6_HOLDS:
        assert bc.out_head_route((b, h, h, c), (3, 3, c, cout), g,
                                 getattr(torch, dname)) == route
        if route == "sm90":
            for k0, k1 in bc.out_head_passes(cout):
                plan = bc.out_head_launch_plan(b, h, h, c, g, k1 - k0)
                held[route].add((plan.columns // 8, plan.mtiles))
        else:
            plan = bc.out_head_simt_plan(h, h, c, g, cout)
            key = "simt_f32_out" if route == "simt" and len(
                plan.chunks) > 1 else route
            held[key] |= {k1 - k0 for k0, k1 in plan.passes}
    assert held == {"sm90": sm90, "simt": simt, "simt_f32_out": simt,
                    "f32": simt}


@pytest.mark.parametrize("x_shape,w_shape,g,dtype,match", [
    ((2, 8, 8, 12), (3, 3, 12, 3), 8, BF16, "multiple of num_groups"),
    ((2, 8, 8, 64), (3, 3, 64, 3), 24, BF16, "num_groups"),
    ((2, 8, 8, 4096), (3, 3, 4096, 3), 1, BF16, "at most 2048 channels"),
    ((2, 8, 8, 64), (3, 3, 64, 0), 32, BF16, "Cout ≥ 1"),
    ((2, 8, 8, 64), (3, 3, 64, 0), 32, F32, "Cout ≥ 1"),
    ((2, 8, 8, 64), (3, 3, 64, 3), 32, torch.float16, "float32 or bf"),
    ((2, 4, 4, 2048), (3, 3, 2048, 3), 0, F32, "num_groups"),
    ((1, 4, 4000, 64), (3, 3, 64, 3), 3, F32, "multiple of num_groups"),
    ((2, 8, 8, 64), (3, 3, 32, 3), 32, F32, "w \\[3, 3, C, Cout\\]"),
])
def test_route_refuses_what_no_kernel_takes(x_shape, w_shape, g, dtype,
                                            match):
    with pytest.raises(ValueError, match=match):
        bc.out_head_route(x_shape, w_shape, g, dtype)


@pytest.mark.parametrize("args,match", [
    ((2, 8, 8, 96, 32, 3), "multiple of 64"),
    ((2, 128, 128, 256, 32, 3), "cannot hold a band"),
    ((2, 8, 8, 64, 32, 0), "Cout ≥ 1"),
])
def test_plan_refuses_what_the_sm90_route_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        bc.out_head_launch_plan(*args)


def test_pack_out_head_weight_layout():
    w = torch.arange(3 * 3 * 64 * 2, dtype=F32).reshape(3, 3, 64, 2)
    packed = bc.pack_out_head_weight(w)
    assert packed.dtype == BF16 and packed.shape == (32, 64)
    for ky in range(3):
        for kx in range(3):
            for k in range(2):
                row = (ky * 3 + kx) * 2 + k
                assert torch.equal(packed[row], w[ky, kx, :, k].to(BF16))
    assert not packed[18:].any()
    assert bc.pack_out_head_weight(torch.ones(3, 3, 64, 7)).shape == (64, 64)


def _group_sum(u, gs, cg):
    """K6's (and K1's) fold of one group's channels: four interleaved
    running sums added in a fixed order."""
    acc = [0.0] * 4
    j = 0
    while j + 4 <= cg:
        for q in range(4):
            acc[q] += u[gs + j + q]
        j += 4
    for jj in range(j, cg):
        acc[0] += u[gs + jj]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _emulate_sm90(x, scale, bias, w, g, eps=1e-5):
    """The sm90 kernel's partition of one call, in f64 (numpy)."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    plan = bc.out_head_launch_plan(b, h, wd, c, g, cout)
    cl, rows, t = plan.cluster, plan.rows, plan.threads
    cv, nr = c // 8, plan.threads // (c // 8)
    wt = bc.pack_out_head_weight(torch.from_numpy(w)).double().numpy()
    group = 16 * plan.mtiles
    out = np.zeros((b, h, wd, cout))
    for s in range(b):
        pub, ps = [], []
        for rank in range(cl):
            r0, r1 = rank * rows, min(h, (rank + 1) * rows)
            band = x[s, r0:r1].reshape(-1, c)          # [npix, C]
            npix = band.shape[0]
            vecs = band.reshape(-1, 8)                 # vector q = p*CV + j
            part = np.zeros((2, nr, c))
            for tid in range(t):
                col, trow = tid % cv, tid // cv
                s1, s2 = np.zeros(8), np.zeros(8)
                for i in range(-(-len(vecs) // t)):
                    q = tid + i * t
                    if q >= len(vecs):
                        break
                    assert q // cv == trow + i * nr and q % cv == col
                    s1 += vecs[q]
                    s2 += vecs[q] ** 2
                part[0, trow, 8 * col:8 * col + 8] = s1
                part[1, trow, 8 * col:8 * col + 8] = s2
            acc = np.zeros((2, c))
            for trow in range(nr):                     # thread rows in order
                acc += part[:, trow]
            pub.append(acc)
            ps.append((r0, band, npix))
        tot = np.zeros((2, c))
        for acc in pub:                                # ranks in order
            tot += acc
        cg = c // g
        n = h * wd * cg
        a_c, b_c = np.zeros(c), np.zeros(c)
        for ch in range(c):
            gs = ch // cg * cg
            mean = _group_sum(tot[0], gs, cg) / n
            var = max(_group_sum(tot[1], gs, cg) / n - mean * mean, 0.0)
            a_c[ch] = scale[ch] / np.sqrt(var + eps)
            b_c[ch] = bias[ch] - mean * a_c[ch]
        pcols = []
        for r0, band, npix in ps:
            z = band * a_c + b_c
            y = z / (1.0 + np.exp(-z))
            p_cm = np.full((plan.columns, plan.p_stride), np.nan)
            for grp in range(-(-npix // group)):       # clamped A rows
                rows_ = np.arange(grp * group, (grp + 1) * group)
                a_rows = y[np.minimum(rows_, npix - 1)]
                assert rows_[-1] < plan.p_stride
                p_cm[:, rows_] = (a_rows @ wt.T).T     # zero-padded columns
            pcols.append(p_cm)
        # Each rank writes the taps its neighbours need of its first and
        # last rows of P into their halo rows: [W, 3·Cout], x-major.
        halo_up = [None] * cl    # the row above the band, taps 0-2
        halo_dn = [None] * cl    # the row below the band, taps 6-8
        for rank, (r0, band, npix) in enumerate(ps):
            nrows = npix // wd
            first = pcols[rank][6 * cout:9 * cout, :wd].T
            last = pcols[rank][:3 * cout, (nrows - 1) * wd:nrows * wd].T
            if rank > 0:
                halo_dn[rank - 1] = first
            if rank + 1 < cl:
                halo_up[rank + 1] = last
        for rank, (r0, band, npix) in enumerate(ps):
            nrows = npix // wd
            for o in range(npix * cout):
                p, k = divmod(o, cout)
                ly, xx = divmod(p, wd)
                total = 0.0
                for dy in (-1, 0, 1):
                    y2 = ly + dy
                    halo = halo_up[rank] if y2 < 0 else halo_dn[rank]
                    if not 0 <= y2 < nrows and halo is None:
                        continue                       # outside the image
                    for dx in (-1, 0, 1):
                        x2 = xx + dx
                        if not 0 <= x2 < wd:
                            continue
                        tap = (dy + 1) * 3 + dx + 1
                        if 0 <= y2 < nrows:
                            total += pcols[rank][tap * cout + k, y2 * wd + x2]
                        else:
                            total += halo[x2, (dx + 1) * cout + k]
                out[s, r0 + ly, xx, k] = total
    return out, plan


@pytest.mark.parametrize("b,h,wd,c,g,cout,cluster", [
    (2, 28, 28, 64, 32, 1, 4),     # MNIST's width: no whole m16 tiles
    (1, 6, 5, 128, 16, 3, 2),      # rows that do not split evenly
    (1, 3, 7, 64, 8, 7, 2),        # 64 columns, one m16 tile a warp
])
def test_emulated_partition_matches_plain(b, h, wd, c, g, cout, cluster):
    rng = np.random.default_rng(h * 100 + c)
    x = rng.normal(size=(b, h, wd, c)) * 0.5 + 0.3
    scale = rng.normal(size=c) * 0.2 + 1.0
    bias = rng.normal(size=c) * 0.1
    # Weights bf16 can hold, so the packed bf16 copy is exact.
    w = torch.from_numpy(rng.normal(size=(3, 3, c, cout)) * 0.05).to(
        BF16).double().numpy()
    got, plan = _emulate_sm90(x, scale, bias, w, g)
    assert plan.cluster == cluster
    want = bc.out_head_plain(*(torch.from_numpy(v) for v in
                               (x, scale, bias, w)), num_groups=g).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("cout", [1, 3, 8, 16])
def test_dispatcher_takes_narrow_heads_on_the_cpu(cout):
    rng = np.random.default_rng(cout)
    x = torch.from_numpy(rng.normal(size=(2, 5, 5, 64))).float()
    w = torch.from_numpy(rng.normal(size=(3, 3, 64, cout)) * 0.05).float()
    s, bias = torch.ones(64), torch.zeros(64)
    before = {r: k.launches for r, k in bc.OUT_HEAD_KERNELS.items()}
    got = bc.out_head(x, s, bias, w)
    assert got.shape == (2, 5, 5, cout)
    assert torch.equal(got, bc.out_head_plain(x, s, bias, w))
    assert {r: k.launches for r, k in bc.OUT_HEAD_KERNELS.items()} == before


# -- the CUDA-core kernel's passes, chunks and column tiles ----------------

def _emulate_simt(x, scale, bias, w, g):
    """``csrc/boundary_conv.cu``'s out_head_kernel in f64 over the launches
    of :func:`out_head_simt_plan`: each pass of output channels over each
    chunk of C (its own group statistics, channels padded to whole 8-vectors
    with a zero weight and affine), every row walked in tiles of
    ``tile_w`` columns with the ring of 3 rows × (tile + halo) columns of
    9·Cout partial products, chunks after the first adding to the
    output."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    plan = bc.out_head_simt_plan(h, wd, c, g, cout)
    gs = c // g
    out = np.zeros((b, h, wd, cout))
    silu = lambda z: z / (1.0 + np.exp(-z))   # noqa: E731
    for k0, k1 in plan.passes:
        kp = k1 - k0
        for i, (c0, c1) in enumerate(plan.chunks):
            cc = c1 - c0
            cp = -(-cc // 8) * 8
            xc = np.zeros((b, h, wd, cp))
            xc[..., :cc] = x[..., c0:c1]
            wc = np.zeros((cp, 9 * kp))
            wc[:cc] = w[:, :, c0:c1, k0:k1].reshape(9, cc, kp).transpose(
                1, 0, 2).reshape(cc, 9 * kp)
            assert bc.out_head_smem_bytes(wd, cc, cc // gs, kp,
                                          plan.tile_w) <= plan.smem_bytes
            ring_cols = min(wd, plan.tile_w + 2)
            for s in range(b):
                xs = xc[s].reshape(-1, cp)
                colsum, colsq = xs.sum(0)[:cc], (xs * xs).sum(0)[:cc]
                n = h * wd * gs
                mean = colsum.reshape(-1, gs).sum(1) / n
                var = np.maximum(colsq.reshape(-1, gs).sum(1) / n
                                 - mean ** 2, 0)
                rstd = 1 / np.sqrt(var + 1e-5)
                a = np.zeros(cp)
                bb = np.zeros(cp)
                a[:cc] = np.repeat(rstd, gs) * scale[c0:c1]
                bb[:cc] = bias[c0:c1] - np.repeat(mean, gs) * a[:cc]
                for x0 in range(0, wd, plan.tile_w):
                    x1 = min(x0 + plan.tile_w, wd)
                    lo, hi = max(x0 - 1, 0), min(x1 + 1, wd)
                    assert hi - lo <= ring_cols
                    ring = np.full((3, ring_cols, 9 * kp), np.nan)
                    for r in range(h + 1):
                        if r < h:
                            y = silu(xc[s, r, lo:hi] * a + bb)
                            ring[r % 3, :hi - lo] = y @ wc
                        if r == 0:
                            continue
                        orow = r - 1
                        for col in range(x0, x1):
                            for k in range(kp):
                                tot = 0.0
                                for dy in (-1, 0, 1):
                                    rr = orow + dy
                                    if not 0 <= rr < h:
                                        continue
                                    for dx in (-1, 0, 1):
                                        cx = col + dx
                                        if not 0 <= cx < wd:
                                            continue
                                        tap = (dy + 1) * 3 + dx + 1
                                        tot += ring[rr % 3, cx - lo,
                                                    tap * kp + k]
                                if i:
                                    tot += out[s, orow, col, k0 + k]
                                out[s, orow, col, k0 + k] = tot
    return out, plan


@pytest.mark.parametrize("b,h,wd,c,g,cout,n_passes,n_chunks,tiled", [
    (2, 5, 6, 64, 32, 12, 2, 1, False),     # Cout 12: passes of 6
    (1, 3, 4, 2048, 32, 3, 1, 2, False),    # the f32 C the block refused
    (1, 2, 3, 2080, 32, 9, 2, 2, False),    # passes and chunks
    (1, 3, 900, 16, 8, 3, 1, 1, True),      # a row wider than the ring
    (2, 4, 5, 12, 4, 2, 1, 1, False),       # C not whole 8-vectors
])
def test_emulated_simt_cut_matches_plain(b, h, wd, c, g, cout, n_passes,
                                         n_chunks, tiled):
    rng = np.random.default_rng(c + cout)
    x = rng.normal(size=(b, h, wd, c)) * 0.5 + 0.3
    scale = rng.normal(size=c) * 0.2 + 1.0
    bias = rng.normal(size=c) * 0.1
    w = rng.normal(size=(3, 3, c, cout)) * (1 / (9 * c)) ** 0.5
    got, plan = _emulate_simt(x, scale, bias, w, g)
    assert (len(plan.passes), len(plan.chunks)) == (n_passes, n_chunks)
    assert (plan.tile_w < wd) == tiled
    assert plan.smem_bytes <= bc.MAX_SMEM_BYTES
    assert plan.vec == (c % 8 == 0)
    want = bc.out_head_plain(*(torch.from_numpy(v) for v in
                               (x, scale, bias, w)), num_groups=g).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=1e-10)
