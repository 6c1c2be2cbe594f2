"""The port's conv-experiment ops against the JAX package's experiment
scripts, on the CPU.

The same inputs, made with numpy, go through the JAX Pallas kernel (in
interpret mode, once per kernel and K order), its XLA twin, and the
port's plain PyTorch version, which is the numerics oracle of the CUDA
kernel K4, K5, K6 or K7 on the card (``chip_smoke.py`` holds each kernel
against it there). f32 agrees to 1e-5 abs + 1e-5 rel (sums in another
order); bf16 to the reference check's bound, max |err| < 2e-2 · max |ref|.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.ops import boundary_conv as bc
from diffusion_model_universal_torch.ops import conv3x3 as cv
from diffusion_model_universal_torch.scripts import exp_boundary_kernel
from diffusion_model_universal_torch.scripts import exp_conv_kernel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import exp_boundary_kernel as jbk  # noqa: E402
import exp_conv_kernel as jck  # noqa: E402

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 2e-2


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _conv_inputs(b, h, cin, cout, seed=0, dtype="float32"):
    rng = _rng(seed)
    x = rng.normal(size=(b, h, h, cin)) * 0.5
    w = rng.normal(size=(3, 3, cin, cout)) * 0.1
    a = rng.normal(size=(b, cin)) * 0.3 + 1.0
    bb = rng.normal(size=(b, cin)) * 0.2
    return [_pair(v, dtype) for v in (x, w, a, bb)]


def _head_inputs(b, h, c, seed=1, dtype="float32", cout=3):
    rng = _rng(seed)
    x = _pair(rng.normal(size=(b, h, h, c)) * 0.5 + 0.3, dtype)
    w = _pair(rng.normal(size=(3, 3, c, cout)) * 0.05, dtype)
    scale = _pair(rng.normal(size=c) * 0.2 + 1.0)
    bias = _pair(rng.normal(size=c) * 0.1)
    return x, w, scale, bias


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


# -- each plain version against the Pallas kernel and its XLA twin --------

@pytest.mark.parametrize("variant", cv.VARIANTS)
def test_conv3x3_plain_matches_pallas_and_xla(variant):
    (jx, tx), (jw, tw), _, _ = _conv_inputs(2, 4, 16, 24)
    plain = _f32(cv.conv3x3_plain(tx, tw, variant))
    pallas = jck.conv3x3_pallas(jx, jw, block_b=2, variant=variant,
                                interpret=True)
    np.testing.assert_allclose(plain, _f32(pallas), **F32_TOL)
    np.testing.assert_allclose(plain, _f32(jck.conv3x3_xla(jx, jw)),
                               **F32_TOL)


def test_gn_silu_conv3x3_plain_matches_pallas_and_xla():
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = _conv_inputs(2, 4, 16, 16)
    plain = _f32(cv.gn_silu_conv3x3_plain(tx, ta, tb, tw))
    pallas = jck.gn_silu_conv3x3_pallas(jx, ja, jb, jw, block_b=2,
                                        interpret=True)
    np.testing.assert_allclose(plain, _f32(pallas), **F32_TOL)
    np.testing.assert_allclose(
        plain, _f32(jck.gn_silu_conv3x3_xla(jx, ja, jb, jw)), **F32_TOL)


@pytest.mark.parametrize("cout", [1, 3, 8, 12])
def test_out_head_plain_matches_pallas_and_xla(cout):
    """Cout = 1 is MNIST's head, 3 the RGB datasets', 8 and 12 wider than
    one K6 launch (which the card runs in passes); the dispatcher takes
    each on the CPU."""
    (jx, tx), (jw, tw), (js, ts), (jb, tb) = _head_inputs(2, 4, 64,
                                                          cout=cout)
    plain = _f32(bc.out_head_plain(tx, ts, tb, tw, num_groups=32))
    pallas = jbk.out_head_pallas(jx, js, jb, jw, num_groups=32, block_b=2,
                                 interpret=True)
    np.testing.assert_allclose(plain, _f32(pallas), **F32_TOL)
    np.testing.assert_allclose(_f32(bc.out_head(tx, ts, tb, tw)),
                               _f32(pallas), **F32_TOL)
    np.testing.assert_allclose(plain, _f32(jbk.out_head_xla(jx, js, jb, jw)),
                               **F32_TOL)


def test_in_conv_plain_matches_pallas_and_xla():
    rng = _rng(2)
    jx, tx = _pair(rng.normal(size=(2, 4, 4, 3)) * 0.5)
    jw, tw = _pair(rng.normal(size=(3, 3, 3, 32)) * 0.1)
    plain = _f32(bc.in_conv_plain(tx, tw))
    pallas = jbk.in_conv_pallas(jx, jw, block_b=2, interpret=True)
    np.testing.assert_allclose(plain, _f32(pallas), **F32_TOL)
    np.testing.assert_allclose(plain, _f32(jck.conv3x3_xla(jx, jw)),
                               **F32_TOL)


@pytest.mark.parametrize("variant", cv.VARIANTS)
@pytest.mark.parametrize("h,cin,cout", [(2, 32, 32), (4, 24, 16),
                                        (8, 16, 16)])
def test_conv3x3_plain_at_batch_packed_tiny_spatial(h, cin, cout, variant):
    """The edge shapes of ``tests/test_pallas_kernels.py`` (B=32, where
    the batch packs into the GEMM's rows) against the XLA conv."""
    (jx, tx), (jw, tw), _, _ = _conv_inputs(32, h, cin, cout, seed=h)
    np.testing.assert_allclose(_f32(cv.conv3x3_plain(tx, tw, variant)),
                               _f32(jck.conv3x3_xla(jx, jw)), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("unit", ["conv3x3_tap9", "conv3x3_k3",
                                  "gn_silu_conv3x3", "out_head", "in_conv"])
def test_plain_versions_match_xla_twins_in_bf16(unit):
    """In bf16, as the reference's ``check()``: max |err| < 2e-2·max|ref|.
    (The out-head applies in f32 and rounds once, the XLA unit applies in
    bf16; the rest round the same way.)"""
    if unit == "out_head":
        (jx, tx), (jw, tw), (js, ts), (jb, tb) = _head_inputs(
            2, 4, 64, dtype="bfloat16")
        got = bc.out_head_plain(tx, ts, tb, tw)
        want = jbk.out_head_xla(jx, js, jb, jw)
    elif unit == "in_conv":
        rng = _rng(3)
        jx, tx = _pair(rng.normal(size=(2, 4, 4, 3)), "bfloat16")
        jw, tw = _pair(rng.normal(size=(3, 3, 3, 32)) * 0.1, "bfloat16")
        got, want = bc.in_conv_plain(tx, tw), jck.conv3x3_xla(jx, jw)
    else:
        (jx, tx), (jw, tw), (ja, ta), (jb, tb) = _conv_inputs(
            2, 4, 16, 16, dtype="bfloat16")
        if unit == "gn_silu_conv3x3":
            got = cv.gn_silu_conv3x3_plain(tx, ta, tb, tw)
            want = jck.gn_silu_conv3x3_xla(jx, ja, jb, jw)
        else:
            got = cv.conv3x3_plain(tx, tw, unit.split("_")[1])
            want = jck.conv3x3_xla(jx, jw)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < BF16_REL


@pytest.mark.parametrize("unit", ["gn_silu_conv3x3", "out_head"])
def test_halo_is_zero_after_the_activation(unit):
    """SAME pads y = silu(...), not x: with a bias far from 0, a border
    taken as silu(bias) would move the edge outputs far from JAX's."""
    if unit == "gn_silu_conv3x3":
        (jx, tx), (jw, tw), (ja, ta), _ = _conv_inputs(2, 4, 16, 16)
        jb, tb = _pair(np.full((2, 16), 3.0))
        got = _f32(cv.gn_silu_conv3x3_plain(tx, ta, tb, tw))
        want = _f32(jck.gn_silu_conv3x3_xla(jx, ja, jb, jw))
        y = cv._affine_silu(tx, ta, tb)
        halo = tb[:, None, None, :] * torch.sigmoid(tb[:, None, None, :])
    else:
        (jx, tx), (jw, tw), (js, ts), _ = _head_inputs(2, 4, 64)
        jb, tb = _pair(np.full(64, 3.0))
        got = _f32(bc.out_head_plain(tx, ts, tb, tw))
        want = _f32(jbk.out_head_xla(jx, js, jb, jw))
        a, b = bc.group_affine(tx, ts, tb, 32)
        z = tx * a[:, None, None, :] + b[:, None, None, :]
        y = z * torch.sigmoid(z)
        halo = (tb * torch.sigmoid(tb))[None, None, None, :].expand(
            2, 1, 1, -1)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # The wrong padding, silu(bias) around the image, is far off.
    b, h, w, c = y.shape
    yp = halo.expand(b, h + 2, w + 2, c).clone()
    yp[:, 1:-1, 1:-1, :] = y
    wrong = sum(yp[:, ky:ky + h, kx:kx + w, :] @ tw[ky, kx]
                for ky in range(3) for kx in range(3))
    assert np.abs(_f32(wrong) - want).max() > 0.1


def test_conv3x3_function_matches_pallas_vjp():
    """Value and gradients of Conv3x3Function (the CPU half: plain forward,
    F.conv2d backward) against ``jax.value_and_grad`` of
    ``conv3x3_pallas_vjp`` (Pallas forward in interpret mode, XLA's conv
    vjp backward)."""
    rng = _rng(4)
    jx, tx = _pair(rng.normal(size=(16, 2, 2, 48)) * 0.3)
    jw, tw = _pair(rng.normal(size=(3, 3, 48, 32)) * 0.1)

    def f_pallas(x, w):
        return jnp.sum(jnp.tanh(jck.conv3x3_pallas_vjp(x, w, 8, True)))

    v_j, (dx_j, dw_j) = jax.value_and_grad(f_pallas, argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    v_t = torch.tanh(cv.Conv3x3Function.apply(tx, tw)).sum()
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(_f32(tx.grad), _f32(dx_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_f32(tw.grad), _f32(dw_j), atol=1e-5,
                               rtol=1e-5)


# -- dispatch and refusals ------------------------------------------------

def _launches():
    return (tuple(k.launches for k in cv.CONV3X3_KERNELS.values())
            + tuple(k.launches for k in cv.GN_SILU_CONV3X3_KERNELS.values())
            + tuple(k.launches for k in bc.OUT_HEAD_KERNELS.values())
            + (bc.IN_CONV_KERNEL.launches, bc.IN_CONV_MMA_KERNEL.launches))


def test_dispatchers_route_cpu_tensors_to_plain_versions():
    before = _launches()
    (_, x), (_, w), (_, a), (_, b) = _conv_inputs(2, 4, 16, 8)
    for variant in cv.VARIANTS:
        assert torch.equal(cv.conv3x3(x, w, variant),
                           cv.conv3x3_plain(x, w, variant))
    assert torch.equal(cv.gn_silu_conv3x3(x, a, b, w),
                       cv.gn_silu_conv3x3_plain(x, a, b, w))
    (_, hx), (_, hw), (_, s), (_, hb) = _head_inputs(2, 4, 64)
    assert torch.equal(bc.out_head(hx, s, hb, hw),
                       bc.out_head_plain(hx, s, hb, hw))
    x3 = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    w3 = torch.randn(3, 3, 3, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(bc.in_conv(x3, w3), bc.in_conv_plain(x3, w3))
    assert _launches() == before


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros(2, 4, 4, 16)
    w = torch.zeros(3, 3, 16, 16)
    a = torch.zeros(2, 16)
    x12, w12 = torch.zeros(2, 4, 4, 12), torch.zeros(3, 3, 12, 16)
    for call in (lambda: cv.conv3x3_cuda(x12, w12),
                 lambda: cv.conv3x3(x12, w12),
                 lambda: cv.gn_silu_conv3x3(x12, a, a, w12),
                 lambda: cv.conv3x3(x, torch.zeros(3, 3, 16, 3)),
                 lambda: cv.conv3x3(x, w.bfloat16())):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="multiples of 8"):
        cv.conv3x3_cuda(x12, w12)
    with pytest.raises(ValueError, match="variant"):
        cv.conv3x3_plain(x, w, "tap4")
    hx, hw = torch.zeros(2, 4, 4, 64), torch.zeros(3, 3, 64, 3)
    s = torch.ones(64)
    x3, w3 = torch.zeros(2, 4, 4, 3), torch.zeros(3, 3, 3, 16)
    for call in (lambda: cv.conv3x3_cuda(x, w),
                 lambda: cv.gn_silu_conv3x3_cuda(x, a, a, w),
                 lambda: bc.out_head_cuda(hx, s, s, hw),
                 lambda: bc.in_conv_cuda(x3, w3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for call in (lambda: bc.out_head(hx, s, s, torch.zeros(3, 3, 64, 0)),
                 lambda: bc.out_head(hx, s, s, hw, num_groups=24),
                 lambda: bc.out_head(hx, s, s, torch.zeros(3, 3, 32, 3)),
                 lambda: bc.in_conv(x3, torch.zeros(3, 3, 3, 12)),
                 lambda: bc.in_conv(x, w)):
        with pytest.raises(ValueError):
            call()
    # Cout 8 and a row wider than the CUDA-core block's ring now run (in
    # passes, in column tiles); on the CPU the plain version.
    for xx, ww in ((hx, torch.zeros(3, 3, 64, 8)),
                   (torch.zeros(1, 4, 4000, 64), hw)):
        assert torch.equal(bc.out_head(xx, s, s, ww),
                           bc.out_head_plain(xx, s, s, ww))
    assert bc.out_head_smem_bytes(32, 128, 32, 3) < 48 * 1024
    assert bc.in_conv_smem_bytes(128) < 48 * 1024


# -- the CLIs --------------------------------------------------------------

@pytest.mark.parametrize("cli,shape", [
    (exp_conv_kernel, (4, 16, 16)),
    (exp_boundary_kernel, (4, 32))])
def test_cli_check_runs_on_the_cpu(cli, shape, capsys, monkeypatch):
    """``--check --device cpu``, with the check's shape cut to a tiny one.
    On the CPU both sides are plain PyTorch (the dispatchers' plain
    versions against the F.conv2d units), so this exercises the CLI's
    wiring only; the kernels are held on the card."""
    monkeypatch.setattr(cli, "CHECK_SHAPE", shape)
    monkeypatch.setattr(cli, "CHECK_BATCH", 2)
    assert cli.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity OK" in out and "Kernel launches" not in out


@pytest.mark.parametrize("cli", [exp_conv_kernel, exp_boundary_kernel])
def test_cli_bench_refuses_the_cpu(cli):
    with pytest.raises(SystemExit) as e:
        cli.main(["--bench", "--device", "cpu"])
    assert e.value.code == 2
