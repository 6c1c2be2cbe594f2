"""K5's and K7's Hopper routes, on the CPU: what the kernels take and how
they cut the work, held against the plain versions.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 10 holds
them there). These tests cover what surrounds them in Python and what their
arithmetic assumes:

* :func:`conv3x3_route` picks the TMA + wgmma kernel (``"sm90"``) for the
  six stride-1 shapes of ``bench.py`` with the tile the kernel is sized
  for, the WMMA kernel for the batch-packed edge shapes, the CUDA-core
  kernel for f32, and refuses channel counts that are not multiples of 8;
* a numpy emulation of the sm90 kernel's walk: for each 256-pixel tile
  and each K step, the box :func:`sm90_box` names, filled with zeros
  outside x as TMA fills it, times the K-major weight's slice, summed in
  f64, equals ``conv3x3_plain``;
* K7's packed weight: the im2col matrix padded to 32 columns times
  :func:`pack_in_conv_weight` equals ``in_conv_plain``;
* the K-major weight copy round-trips.

No JAX model is built; the file takes a few seconds.
"""

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import boundary_conv as bc
from diffusion_model_universal_torch.ops import conv3x3 as cv

#: bench.py's stride-1 shapes (H, Cin, Cout) and the (images, rows) of
#: their 256-pixel tiles.
BENCH_TILES = [((32, 128, 128), (1, 8)), ((16, 128, 128), (1, 16)),
               ((8, 256, 256), (4, 8)), ((16, 256, 128), (1, 16)),
               ((4, 256, 256), (16, 4)), ((2, 512, 512), (64, 2))]
#: The batch-packed edge shapes phase 10 holds.
EDGE_SHAPES = [(2, 32, 32), (4, 24, 16), (8, 16, 16)]


def _route(h, cin, cout, dtype=torch.bfloat16, batch=2048, wd=None):
    wd = h if wd is None else wd
    return cv.conv3x3_route((batch, h, wd, cin), (3, 3, cin, cout), dtype)


@pytest.mark.parametrize("shape,tile", BENCH_TILES)
def test_router_sends_bench_shapes_to_the_sm90_kernel(shape, tile):
    route = _route(*shape)
    assert route == cv.Conv3x3Route("sm90", *tile)
    images, rows = tile
    assert images * rows * shape[0] == cv.SM90_TILE


@pytest.mark.parametrize("shape", EDGE_SHAPES + [(32, 128, 64), (24, 64, 128),
                                                  (6, 64, 128)])
def test_router_sends_other_bf16_shapes_to_wmma(shape):
    assert _route(*shape) == cv.Conv3x3Route("wmma")


@pytest.mark.parametrize("shape", [(32, 128, 128), (2, 32, 32)])
def test_router_sends_f32_to_the_cuda_cores(shape):
    assert _route(*shape, dtype=torch.float32) == cv.Conv3x3Route("f32")


@pytest.mark.parametrize("cin,cout,dtype,match", [
    (12, 16, torch.bfloat16, "multiples of 8"),
    (64, 12, torch.bfloat16, "multiples of 8"),
    (12, 128, torch.float32, "multiples of 8"),
    (64, 128, torch.float16, "float32 or bfloat16")])
def test_router_refuses_what_no_kernel_takes(cin, cout, dtype, match):
    with pytest.raises(ValueError, match=match):
        _route(8, cin, cout, dtype=dtype)


def test_router_takes_non_square_images_of_whole_rows():
    assert _route(16, 64, 128, wd=16) == cv.Conv3x3Route("sm90", 1, 16)
    assert _route(4, 64, 128, wd=8) == cv.Conv3x3Route("sm90", 8, 4)
    assert _route(8, 64, 128, wd=24) == cv.Conv3x3Route("wmma")
    assert _route(6, 64, 128, wd=64) == cv.Conv3x3Route("wmma")


def _tma_box(x: np.ndarray, coords, images: int, rows: int) -> np.ndarray:
    """The box [images, rows, W, 64] of x [B, H, W, C] at (c0, x0, y0, b0),
    with zeros wherever an index falls outside x, as TMA loads it."""
    c0, x0, y0, b0 = coords
    idx = [b0 + np.arange(images), y0 + np.arange(rows),
           x0 + np.arange(x.shape[2]), c0 + np.arange(cv.SM90_BK)]
    ok = [(i >= 0) & (i < n) for i, n in zip(idx, x.shape)]
    box = np.zeros([len(i) for i in idx])
    box[np.ix_(*ok)] = x[np.ix_(*(i[k] for i, k in zip(idx, ok)))]
    return box


def _walk_sm90(x: np.ndarray, w: torch.Tensor) -> np.ndarray:
    """The sm90 kernel's GEMM in f64: 256 x 128 tiles over (M, Cout), each
    summing the K steps' boxes times the K-major weight's columns."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    route = cv.conv3x3_route(x.shape, w.shape, torch.bfloat16)
    assert route.name == "sm90"
    wk = cv.kmajor_weight(w).double().numpy()
    m = b * h * wd
    tiles = -(-m // cv.SM90_TILE)
    out = np.zeros((tiles * cv.SM90_TILE, cout))
    bk, bn = cv.SM90_BK, cv.SM90_BN
    for mt in range(tiles):
        m0 = mt * cv.SM90_TILE
        for n0 in range(0, cout, bn):
            acc = np.zeros((cv.SM90_TILE, bn))
            for ks in range(9 * cin // bk):
                box = _tma_box(x, cv.sm90_box(m0, ks, h, wd, cin),
                               route.images, route.rows)
                acc += box.reshape(cv.SM90_TILE, bk) @ \
                    wk[n0:n0 + bn, ks * bk:(ks + 1) * bk].T
            out[m0:m0 + cv.SM90_TILE, n0:n0 + bn] = acc
    return out[:m].reshape(b, h, wd, cout)   # rows past M are not stored


@pytest.mark.parametrize("b,h,cin,cout", [
    (4, 8, 64, 128),      # 4 images of 8 rows per tile
    (64, 2, 64, 128),     # 64 images of 2 rows
    (3, 4, 64, 256),      # 16 images a tile, 13 past the batch; 2 N tiles
    (2, 16, 128, 128)])   # 1 image, 16 rows, 2 channel blocks per tap
def test_box_walk_matches_the_plain_conv(b, h, cin, cout):
    rng = np.random.default_rng(b * 1000 + h)
    x = rng.normal(size=(b, h, h, cin))
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)))
    want = cv.conv3x3_plain(torch.from_numpy(x), w, "tap9").numpy()
    np.testing.assert_allclose(_walk_sm90(x, w), want, atol=1e-10,
                               rtol=1e-10)


def test_k3_order_walks_the_same_k_indices_as_tap9():
    """For Cin % 64 == 0 the k3 body's K index (ky·3·Cin + kx·Cin + ci)
    of each step equals the tap9 one, so one kernel serves both."""
    cin = 128
    tap9 = [tap * cin + ci for tap in range(9) for ci in range(cin)]
    k3 = [ky * 3 * cin + j for ky in range(3) for j in range(3 * cin)]
    assert tap9 == k3
    # Step ks loads the box of tap (y0 + 1)·3 + (x0 + 1) at channel c0, and
    # the weight's K-major columns from ks·64: the same K indices.
    for ks in range(9 * cin // cv.SM90_BK):
        c0, x0, y0, _ = cv.sm90_box(0, ks, 8, 8, cin)
        assert ((y0 + 1) * 3 + x0 + 1) * cin + c0 == ks * cv.SM90_BK


def test_kmajor_weight_round_trips():
    w = torch.randn(3, 3, 64, 128, generator=torch.Generator().manual_seed(0))
    wk = cv.kmajor_weight(w)
    assert wk.shape == (128, 9 * 64) and wk.is_contiguous()
    assert torch.equal(wk[5, (1 * 3 + 2) * 64 + 7], w[1, 2, 7, 5])
    assert torch.equal(wk.t().reshape(3, 3, 64, 128), w)


def _im2col(x: np.ndarray) -> np.ndarray:
    """[B·H·W, 27], column (ky·3 + kx)·3 + ci, zeros outside the image."""
    b, h, wd, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.zeros((b, h, wd, 9 * c))
    for ky in range(3):
        for kx in range(3):
            for ci in range(c):
                cols[..., (ky * 3 + kx) * c + ci] = \
                    xp[:, ky:ky + h, kx:kx + wd, ci]
    return cols.reshape(-1, 9 * c)


@pytest.mark.parametrize("h,cout", [(8, 128), (5, 24)])
def test_packed_in_conv_weight_gives_the_plain_in_conv(h, cout):
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.normal(size=(2, h, h, 3))).float().bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, cout))).float().bfloat16()
    packed = bc.pack_in_conv_weight(w)
    assert packed.shape == (bc.IN_CONV_K, cout)
    assert packed.dtype == torch.bfloat16
    assert not packed[27:].any()
    cols = np.pad(_im2col(x.double().numpy()), ((0, 0), (0, 5)))
    got = (cols @ packed.double().numpy()).reshape(2, h, h, cout)
    want = bc.in_conv_plain(x.float(), w.float()).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
