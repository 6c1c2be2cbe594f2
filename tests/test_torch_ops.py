"""The port's fused ops against the JAX package, on the CPU.

Same inputs, made with numpy, go through the JAX function (the XLA
version, and the Pallas kernel in interpret mode) and the port's plain
PyTorch version. f32 agrees to 2e-5 (sums in another order); bf16 to
2e-2, because the plain versions apply in bf16 where the Pallas kernels
apply in f32 and round once.

The GroupNorm backward's plain version is held against the JAX package's
fused backward (Pallas, interpret mode) and the vjp of its XLA version at
the tolerances of ``tests/test_pallas_kernels.py``; the autograd Functions
that pair each kernel with its backward are checked with
``torch.autograd.gradcheck`` in float64 on their CPU halves.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there); here the tests check
that their wrappers refuse what they cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_universal_tpu.ops.attention import mha_pallas, mha_xla
from diffusion_model_universal_tpu.ops.group_norm import (
    group_norm_silu_pallas, group_norm_silu_pallas_bwd, group_norm_silu_xla)
from diffusion_model_universal_tpu.ops.group_norm import \
    resolve_num_groups as jax_resolve_num_groups
from diffusion_model_universal_torch.ops import _build
from diffusion_model_universal_torch.ops import attention as attn_ops
from diffusion_model_universal_torch.ops import group_norm as gn_ops

torch.set_num_threads(2)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round f32 to bf16 to nearest even)."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(_JNP[dtype]),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _gn_inputs(shape, seed=0, tb=False):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, size=c)
    bias = rng.normal(size=c) * 0.1
    time_bias = rng.normal(size=(shape[0], c)) * 0.5 if tb else None
    return x, scale.astype(np.float32), bias.astype(np.float32), time_bias


def _gn_all(x, scale, bias, groups, time_bias, dtype, apply_silu=True):
    """(plain, xla, pallas-interpret) outputs as f32 numpy."""
    jx, tx = _both(x, dtype)
    jtb = ttb = None
    if time_bias is not None:
        jtb, ttb = _both(time_bias, "float32")
    plain = gn_ops.group_norm_silu_plain(
        tx, torch.from_numpy(scale), torch.from_numpy(bias), groups,
        time_bias=ttb, apply_silu=apply_silu)
    assert plain.dtype == tx.dtype
    xla = group_norm_silu_xla(jx, jnp.asarray(scale), jnp.asarray(bias),
                              groups, time_bias=jtb, apply_silu=apply_silu)
    pallas = group_norm_silu_pallas(jx, jnp.asarray(scale),
                                    jnp.asarray(bias), groups,
                                    time_bias=jtb, apply_silu=apply_silu,
                                    interpret=True)
    return _f32(plain), _f32(xla), _f32(pallas)


@pytest.mark.parametrize("channels,groups", [
    (32, 32), (48, 32), (24, 32), (1024, 32), (768, 32), (384, 32), (7, 4)])
def test_resolve_num_groups_matches_jax(channels, groups):
    assert (gn_ops.resolve_num_groups(channels, groups)
            == jax_resolve_num_groups(channels, groups))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 32), 8),
    ((3, 4, 4, 48), 8),
    ((2, 4, 4, 24), 32),
])
def test_gn_plain_matches_xla_and_pallas(shape, groups, dtype, tol):
    g = gn_ops.resolve_num_groups(shape[-1], groups)
    x, scale, bias, _ = _gn_inputs(shape)
    plain, xla, pallas = _gn_all(x, scale, bias, g, None, dtype)
    np.testing.assert_allclose(plain, xla, atol=tol, rtol=tol)
    np.testing.assert_allclose(plain, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("with_tb", [True, False])
def test_gn_plain_silu_and_time_bias(silu, with_tb):
    x, scale, bias, tb = _gn_inputs((4, 4, 4, 32), seed=5, tb=with_tb)
    plain, xla, pallas = _gn_all(x, scale, bias, 8, tb, "float32", silu)
    np.testing.assert_allclose(plain, xla, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(plain, pallas, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("ch,skip_ch", [(64, 64), (32, 96)])
def test_gn_split_skip_halves_match_concat(ch, skip_ch):
    """The split-skip form (each half normalized with ch // gs groups)
    equals the JAX GroupNorm of the materialized concat, time bias
    included."""
    ctot = ch + skip_ch
    g = gn_ops.resolve_num_groups(ctot, 32)
    gs = ctot // g
    x, scale, bias, tb = _gn_inputs((2, 4, 4, ctot), seed=3, tb=True)
    ref = np.asarray(group_norm_silu_xla(
        jnp.asarray(x, jnp.float32), jnp.asarray(scale), jnp.asarray(bias),
        g, time_bias=jnp.asarray(tb, jnp.float32)))
    halves = []
    for lo, hi in ((0, ch), (ch, ctot)):
        halves.append(gn_ops.group_norm_silu_plain(
            torch.from_numpy(np.ascontiguousarray(x[..., lo:hi])).float(),
            torch.from_numpy(scale[lo:hi]), torch.from_numpy(bias[lo:hi]),
            (hi - lo) // gs,
            time_bias=torch.from_numpy(tb[:, lo:hi]).float()).numpy())
    np.testing.assert_allclose(np.concatenate(halves, -1), ref, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("mean,check", [(0.0, "not_f32_apply"),
                                        (50.0, "bounded")])
def test_gn_plain_bf16_apply_stays_bf16(mean, check):
    """The plain version applies in bf16 like the JAX XLA version: not
    bitwise the f32-apply-then-cast form, and its error at a shifted mean
    within the analytic bound 4·eps·|mean|·max|γ| of the JAX canary."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 8, 8, 32)) + mean).to(
        torch.bfloat16)
    scale = torch.from_numpy(rng.normal(size=32) * 0.2 + 1.0).float()
    bias = torch.from_numpy(rng.normal(size=32) * 0.1).float()
    got = gn_ops.group_norm_silu_plain(x, scale, bias, 8)
    assert got.dtype == torch.bfloat16
    ref = gn_ops.group_norm_silu_plain(x.float(), scale, bias, 8)
    err = (got.float() - ref).abs().max().item()
    if check == "not_f32_apply":
        assert err <= 0.03
        assert not torch.equal(got.float(), ref.to(torch.bfloat16).float())
    else:
        bound = 4.0 * 2.0 ** -8 * mean * scale.abs().max().item()
        assert 0.1 < err <= bound, (err, bound)


def _mha_all(shape, dtype, seed=1, q=None, k=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape) if a is None else a
            for a in (q, k, None)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrs)
    plain = attn_ops.mha_plain(tq, tk, tv)
    assert plain.dtype == tq.dtype
    return (_f32(plain), _f32(mha_xla(jq, jk, jv)),
            _f32(mha_pallas(jq, jk, jv, interpret=True)), arrs[2])


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 4, 16, 32), (1, 2, 64, 16),
                                   (2, 4, 1, 128), (2, 4, 4, 64)])
def test_mha_plain_matches_xla_and_pallas(shape, dtype, tol):
    plain, xla, pallas, _ = _mha_all(shape, dtype)
    np.testing.assert_allclose(plain, xla, atol=tol, rtol=tol)
    np.testing.assert_allclose(plain, pallas, atol=tol, rtol=tol)


def test_mha_plain_softmax_stability():
    """Large logits do not overflow: uniform attention gives mean(v)."""
    big = np.full((1, 1, 8, 16), 30.0)
    plain, xla, pallas, v = _mha_all((1, 1, 8, 16), "float32", seed=4,
                                     q=big, k=big)
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain[0, 0, 0], v[0, 0].mean(0), atol=1e-5)
    np.testing.assert_allclose(plain, xla, atol=1e-5)
    np.testing.assert_allclose(plain, pallas, atol=1e-5)


def test_dispatchers_route_cpu_tensors_to_plain_versions():
    """On CPU tensors the dispatchers run the plain versions and never
    touch a kernel or its launch counter."""
    before = (gn_ops.GN_KERNEL.launches, attn_ops.MHA_KERNEL.launches)
    x, scale, bias, tb = _gn_inputs((2, 4, 4, 32), tb=True)
    args = (torch.from_numpy(x).float(), torch.from_numpy(scale),
            torch.from_numpy(bias), 8, torch.from_numpy(tb).float())
    assert torch.equal(gn_ops.group_norm_silu(*args),
                       gn_ops.group_norm_silu_plain(*args))
    q = torch.randn(2, 4, 16, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(attn_ops.multi_head_attention(q, q, q),
                       attn_ops.mha_plain(q, q, q))
    assert (gn_ops.GN_KERNEL.launches,
            attn_ops.MHA_KERNEL.launches) == before


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros(2, 4, 4, 32)
    w = torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        gn_ops.group_norm_silu_cuda(x, w, w, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gn_ops.group_norm_silu_bwd_cuda(x, w, w, None, x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attn_ops.mha_cuda(x, x, x)
    assert attn_ops.mha_smem_bytes(64, 128) <= attn_ops.MAX_SMEM_BYTES
    assert attn_ops.mha_smem_bytes(128, 128) > attn_ops.MAX_SMEM_BYTES


def test_kernel_build_names_sources_and_raises_without_nvcc(monkeypatch,
                                                            tmp_path):
    """Each csrc/*.cu is one library, named by a hash of its source and
    flags, built for sm_90a; a build that cannot run raises."""
    assert _build.kernel_names() == ["attention", "boundary_conv", "conv3x3",
                                     "conv3x3_sm90", "group_norm"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build._target("attention") == _build._target("attention")
    assert _build._target("attention") != _build._target("group_norm")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# -- backward ------------------------------------------------------------

@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("with_tb", [True, False])
def test_gn_bwd_plain_matches_pallas_bwd_and_xla_vjp(silu, with_tb):
    """K2's plain version against the JAX fused backward (interpret) and
    the vjp of the XLA version, at test_pallas_kernels.py's tolerances
    (dx, dtb 2e-4; dscale, dbias 2e-3 abs + 2e-4 rel). Measured: ≤ 2e-6
    on dx and ≤ 4e-6 on dscale against either."""
    x, scale, bias, tb = _gn_inputs((3, 4, 4, 32), seed=7, tb=True)
    if not with_tb:
        tb = np.zeros_like(tb)
    dy = np.random.default_rng(8).normal(size=x.shape)
    jx, jtb, jdy = (jnp.asarray(a, jnp.float32) for a in (x, tb, dy))
    js, jb = jnp.asarray(scale), jnp.asarray(bias)

    def xla_fn(x, s, b, t):
        return group_norm_silu_xla(x, s, b, 8, time_bias=t, apply_silu=silu)

    _, vjp = jax.vjp(xla_fn, jx, js, jb, jtb)
    refs = {"xla": vjp(jdy), "pallas": group_norm_silu_pallas_bwd(
        jx, js, jb, jtb, jdy, 8, apply_silu=silu, interpret=True)}
    got = gn_ops.group_norm_silu_bwd_plain(
        torch.from_numpy(x).float(), torch.from_numpy(scale),
        torch.from_numpy(bias),
        torch.from_numpy(tb).float() if with_tb else None,
        torch.from_numpy(dy).float(), 8, apply_silu=silu)
    assert (got[3] is None) == (not with_tb)
    tols = [(2e-4, 2e-4), (2e-3, 2e-4), (2e-3, 2e-4), (2e-4, 2e-4)]
    for ref in refs.values():
        for g, r, (atol, rtol) in zip(got, ref, tols):
            if g is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=atol, rtol=rtol)


def _gn_f64_args(with_tb, seed=11):
    x, scale, bias, tb = _gn_inputs((2, 3, 3, 12), seed=seed, tb=True)
    return (torch.from_numpy(x).double().requires_grad_(),
            torch.from_numpy(scale).double().requires_grad_(),
            torch.from_numpy(bias).double().requires_grad_(),
            torch.from_numpy(tb).double().requires_grad_() if with_tb
            else None)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("with_tb", [True, False])
def test_gn_function_gradcheck_f64(silu, with_tb):
    """gradcheck of GroupNormSiLUFunction's CPU pair (plain forward, plain
    backward) in float64: the backward formula, and which input gets
    which gradient, against finite differences (3 groups of 4 channels,
    so groups do not divide a warp here either)."""
    x, scale, bias, tb = _gn_f64_args(with_tb)

    def f(x, scale, bias, tb):
        return gn_ops.GroupNormSiLUFunction.apply(x, scale, bias, tb, 3,
                                                  1e-5, silu)

    assert torch.autograd.gradcheck(f, (x, scale, bias, tb), eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def test_gn_dispatcher_is_differentiable_and_casts_dtb():
    """The dispatcher goes through the Function: when an input needs a
    gradient the output has a grad_fn, a bf16 time bias gets a bf16
    gradient, and without grad mode the same forward has none."""
    x, scale, bias, tb = _gn_f64_args(True)
    x32 = x.detach().float().requires_grad_()
    tb16 = tb.detach().to(torch.bfloat16).requires_grad_()
    out = gn_ops.group_norm_silu(x32, scale.detach().float(),
                                 bias.detach().float(), 3, time_bias=tb16)
    assert "GroupNormSiLUFunction" in type(out.grad_fn).__name__
    out.square().sum().backward()
    assert tb16.grad.dtype == torch.bfloat16 and x32.grad.dtype == x32.dtype
    with torch.no_grad():
        assert gn_ops.group_norm_silu(x32, scale.float(), bias.float(), 3,
                                      time_bias=tb16).grad_fn is None


def test_mha_function_gradcheck_f64():
    """gradcheck of MHAFunction (forward, then autograd through a
    recompute with mha_plain) in float64 on head-split views."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 5, 8))).view(
        2, 5, 2, 4).transpose(1, 2).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(attn_ops.MHAFunction.apply, (q, k, v),
                                    eps=1e-6, atol=1e-5, rtol=1e-4)
    out = attn_ops.multi_head_attention(q, k, v)
    assert "MHAFunction" in type(out.grad_fn).__name__


@pytest.mark.parametrize("ch,skip_ch", [(64, 64), (32, 96)])
def test_gn_split_skip_gradients_match_concat(ch, skip_ch):
    """The split-skip form's gradients (x, skip, γ, β, time bias) equal
    the JAX vjp of the GroupNorm of the materialized concat. Tolerance
    2e-5 (f32 sums in another order); measured ≤ 1e-6."""
    from diffusion_model_universal_torch.models.layers.resnet import \
        GroupNormSiLU
    ctot = ch + skip_ch
    g = gn_ops.resolve_num_groups(ctot, 32)
    x, scale, bias, tb = _gn_inputs((2, 4, 4, ctot), seed=3, tb=True)
    dy = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jfn(x, s, b, t):
        return group_norm_silu_xla(x, s, b, g, time_bias=t)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a, jnp.float32)
                            for a in (x, scale, bias, tb)))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    norm = GroupNormSiLU(ctot, 32)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).float()
    xh = nchw[:, :ch].contiguous(
        memory_format=torch.channels_last).requires_grad_()
    xs = nchw[:, ch:].contiguous(
        memory_format=torch.channels_last).requires_grad_()
    ttb = torch.from_numpy(tb).float().requires_grad_()
    yh, ys = norm(xh, time_bias=ttb, skip=xs)
    dyt = torch.from_numpy(dy).permute(0, 3, 1, 2)
    torch.autograd.backward((yh, ys), (dyt[:, :ch], dyt[:, ch:]))
    dx = torch.cat([xh.grad, xs.grad], 1).permute(0, 2, 3, 1).numpy()
    for got, want in ((dx, ref[0]), (norm.weight.grad.numpy(), ref[1]),
                      (norm.bias.grad.numpy(), ref[2]),
                      (ttb.grad.numpy(), ref[3])):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
