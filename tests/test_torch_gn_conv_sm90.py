"""K4's Hopper route (the fused affine+SiLU → 3×3 conv on K5's TMA +
wgmma pipeline), on the CPU: which calls take it, and a numpy walk of how
it activates x once into a haloed tile and feeds the 9 taps from it.

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 10 holds it
there). Here:

* :func:`gn_silu_conv3x3_route` sends the bench shapes (32², 16²) to the
  sm90 route, shapes with several images a tile or rows too wide for its
  shared memory to the WMMA kernel, f32 to the CUDA cores, and refuses
  what :func:`conv3x3_route` refuses;
* the walk: for each 256-pixel tile and 64-channel block, the raw box of
  R + 2 rows (zeros outside x, as TMA fills it), activated in f64 with
  zeros for the rows outside the image and a zero halo column on each
  side, read for tap (ky, kx) at :func:`gn_sm90_tap_pixel` and multiplied
  by the K-major weight's slice, equals ``gn_silu_conv3x3_plain`` in f64;
  the halo is zero *after* the activation, where silu(b) is not.

No JAX model is built; the file takes a few seconds.
"""

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import conv3x3 as cv


def _route(h, cin, cout, dtype=torch.bfloat16, batch=2048, wd=None):
    wd = h if wd is None else wd
    return cv.gn_silu_conv3x3_route((batch, h, wd, cin), (3, 3, cin, cout),
                                    dtype)


@pytest.mark.parametrize("shape,rows", [((32, 128, 128), 8),
                                        ((16, 128, 128), 16),
                                        ((16, 256, 128), 16),
                                        ((32, 64, 256), 8)])
def test_router_sends_bench_shapes_to_the_sm90_route(shape, rows):
    """The CLI's bench (32², 128→128) and --check (16²) shapes, and the
    other one-image tiles of K5's sm90 shapes, take the new route with
    K5's tile; its shared memory fits 227 KB."""
    route = _route(*shape)
    assert route == cv.Conv3x3Route("sm90", 1, rows)
    assert cv.gn_sm90_smem_bytes(shape[0], rows) <= cv.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape,wd", [
    ((8, 256, 256), None), ((4, 256, 256), None), ((2, 512, 512), None),
    ((64, 128, 128), None), ((2, 128, 128), 128), ((8, 32, 32), None),
    ((32, 128, 64), None), ((24, 64, 128), None)])
def test_router_keeps_edge_shapes_on_wmma(shape, wd):
    """Several images a tile (8², 4², 2²), rows of 64 or 128 pixels (the
    activated tiles would not fit 227 KB), and shapes K5's sm90 route does
    not take stay on the WMMA kernel."""
    assert _route(*shape, wd=wd) == cv.Conv3x3Route("wmma")
    if shape[0] == 64 or wd == 128:
        assert cv.conv3x3_route((2, shape[0], wd or shape[0], shape[1]),
                                (3, 3, shape[1], shape[2]),
                                torch.bfloat16).name == "sm90"


def test_router_sends_f32_to_the_cuda_cores_and_refuses():
    assert _route(32, 128, 128, dtype=torch.float32) == \
        cv.Conv3x3Route("f32")
    with pytest.raises(ValueError, match="multiples of 8"):
        _route(8, 12, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _route(8, 64, 128, dtype=torch.float16)


def test_narrow_rows_fit_down_to_four_pixels():
    """Rows of 4 to 32 pixels fit (W=4: 64 rows a tile, 230,880 bytes);
    rows of 2 do not."""
    assert _route(64, 64, 128, wd=4) == cv.Conv3x3Route("sm90", 1, 64)
    assert cv.gn_sm90_smem_bytes(4, 64) <= cv.MAX_SMEM_BYTES
    assert _route(128, 64, 128, wd=2) == cv.Conv3x3Route("wmma")


def _silu(z):
    return z / (1.0 + np.exp(-z))


def emulate_k4(x, a, b, w, rows):
    """K4's sm90 walk in f64: x [B, H, W, Cin], a, b [B, Cin], HWIO w."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    wk = cv.kmajor_weight(torch.from_numpy(w)).numpy()   # [Cout, 9·Cin]
    out = np.zeros((bsz * h * wd, cout))
    halos = []
    for mt in range(bsz * h * wd // cv.SM90_TILE):
        b0, y0 = divmod(mt * cv.SM90_TILE, h * wd)
        y0 //= wd
        for cb in range(cin // cv.SM90_BK):
            ch = slice(cb * cv.SM90_BK, (cb + 1) * cv.SM90_BK)
            # The raw box: rows y0 - 1 .. y0 + R, zeros outside x.
            raw = np.zeros((rows + 2, wd, cv.SM90_BK))
            for rr in range(rows + 2):
                if 0 <= y0 - 1 + rr < h:
                    raw[rr] = x[b0, y0 - 1 + rr, :, ch]
            act = np.zeros((rows + 2, wd + 2, cv.SM90_BK))
            inside = (y0 - 1 + np.arange(rows + 2) >= 0) & \
                (y0 - 1 + np.arange(rows + 2) < h)
            act[inside, 1:wd + 1] = _silu(raw[inside] * a[b0, ch]
                                          + b[b0, ch])
            halos.append(np.concatenate([act[~inside].ravel(),
                                         act[:, [0, wd + 1]].ravel()]))
            flat = act.reshape(-1, cv.SM90_BK)
            m = np.arange(cv.SM90_TILE)
            for tap in range(9):
                pix = [cv.gn_sm90_tap_pixel(i, tap, wd) for i in m]
                k0 = tap * cin + cb * cv.SM90_BK
                out[mt * cv.SM90_TILE + m] += \
                    flat[pix] @ wk[:, k0:k0 + cv.SM90_BK].T
    return out.reshape(bsz, h, wd, cout), np.concatenate(halos)


@pytest.mark.parametrize("b,h,wd,cin,cout", [(2, 16, 16, 64, 128),
                                             (1, 32, 32, 128, 128),
                                             (1, 64, 4, 64, 128)])
def test_activated_tile_walk_matches_the_plain_fused_conv(b, h, wd, cin,
                                                          cout):
    """The walk equals gn_silu_conv3x3_plain in f64 (1e-11), and every
    element of the halo (rows outside the image, the two side columns) is
    zero although silu(b) is not."""
    rng = np.random.default_rng(h * 100 + cin)
    x = rng.normal(size=(b, h, wd, cin))
    a = rng.normal(size=(b, cin)) * 0.3 + 1.0
    bb = rng.normal(size=(b, cin)) * 0.5 + 0.5
    w = rng.normal(size=(3, 3, cin, cout)) * (1.0 / (9 * cin)) ** 0.5
    route = _route(h, cin, cout, batch=b, wd=wd)
    assert route.name == "sm90"
    got, halo = emulate_k4(x, a, bb, w, route.rows)
    want = cv.gn_silu_conv3x3_plain(*(torch.from_numpy(t)
                                      for t in (x, a, bb, w))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-11, rtol=1e-11)
    assert halo.size > 0 and not halo.any()
    assert np.abs(_silu(bb)).min() > 0
