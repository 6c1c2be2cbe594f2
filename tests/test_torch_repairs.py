"""Repairs of the port against the reference, on the CPU.

* Second derivatives: ``MHAFunction``'s backward is itself
  differentiable (the reference's ``_mha_bwd`` is ``jax.vjp`` of
  ``mha_xla``, which JAX differentiates again), and
  ``GroupNormSiLUFunction``'s plain backward differentiates twice on the
  CPU. Both are held in float64 against autograd through the plain
  versions. On CUDA the GroupNorm backward (kernel K2) raises when a graph
  is asked of it; ``chip_smoke.py`` checks that on the card.
* The port ships its own copies of the four model YAMLs.
* ``generate``'s memory preflight (``utils/memory.py``) plans as the
  reference's planner does, and the CLI draws a request in the planned
  chunks.

No JAX model is compiled; the whole file takes a few seconds.
"""

import numpy as np
import pytest
import torch
import yaml

from diffusion_model_universal_tpu.utils import memory as jax_memory
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.ops import attention as attn_ops
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.utils import memory
from diffusion_model_universal_torch.utils.images import save_image

torch.set_num_threads(2)

GIB = 1024 ** 3


# -- second derivatives ----------------------------------------------------

def _grad_of_grad(fn, q, k, v):
    """d/d(q, k, v) of sum(∇_q L) for L = sum((fn(q, k, v) + q³)²), and
    ∇_q L itself."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    loss = (fn(q, k, v) + q ** 3).square().sum()
    (gq,) = torch.autograd.grad(loss, q, create_graph=True)
    return gq.detach(), torch.autograd.grad(gq.sum(), (q, k, v))


def test_mha_function_grad_of_grad_equals_plain_f64():
    """Through MHAFunction, the grad-of-grad of sum((MHA(q,k,v)+q³)²)
    equals the one through mha_plain (float64, ≤ 1e-10 abs + rel), and the
    first-order gradient is unchanged. Before the repair the first differed
    by 1.0e4 on values up to 1.1e7 (the backward detached its inputs)."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 6, 3 * 4))).view(
        2, 6, 3, 4).transpose(1, 2) for _ in range(3))
    g_fn, gg_fn = _grad_of_grad(attn_ops.multi_head_attention, q, k, v)
    g_pl, gg_pl = _grad_of_grad(attn_ops.mha_plain, q, k, v)
    torch.testing.assert_close(g_fn, g_pl, atol=1e-10, rtol=1e-10)
    for a, b in zip(gg_fn, gg_pl):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


def test_mha_function_gives_no_gradient_to_inputs_that_need_none():
    """Only the inputs that require a gradient get one (k here)."""
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 5, 4)))
               for _ in range(3))
    k.requires_grad_()
    attn_ops.multi_head_attention(q, k, v).sum().backward()
    kk = k.detach().requires_grad_()
    (want,) = torch.autograd.grad(attn_ops.mha_plain(q, kk, v).sum(), kk)
    torch.testing.assert_close(k.grad, want, atol=1e-12, rtol=1e-12)
    assert q.grad is None and v.grad is None


@pytest.mark.parametrize("has_tb,silu", [(True, True), (False, False)])
def test_gn_function_grad_of_grad_on_cpu_equals_plain_f64(has_tb, silu):
    """On the CPU GroupNormSiLUFunction differentiates twice (its plain
    backward records a graph) and agrees with autograd through
    group_norm_silu_plain to 1e-10 in float64, for x, γ, β and the time
    bias."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(2, 3, 3, 12)) * 2 + 0.5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=12))
    bias = torch.from_numpy(rng.normal(size=12) * 0.1)
    tb = torch.from_numpy(rng.normal(size=(2, 12))) if has_tb else None

    def run(fn):
        ins = [t.detach().requires_grad_() for t in (x, scale, bias)
               ] + ([tb.detach().requires_grad_()] if has_tb else [])
        y = fn(ins[0], ins[1], ins[2], 4,
               time_bias=ins[3] if has_tb else None, apply_silu=silu)
        loss = (y ** 3).sum() + (ins[0] ** 3).sum()
        (gx,) = torch.autograd.grad(loss, ins[0], create_graph=True)
        return [gx.detach(), *torch.autograd.grad(gx.square().sum(), ins)]

    for a, b in zip(run(gn_ops.group_norm_silu),
                    run(gn_ops.group_norm_silu_plain)):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


# -- packaged model configs --------------------------------------------------

@pytest.mark.parametrize("name", ["ddpm_config.yaml", "ddim_config.yaml",
                                  "score_based_config.yaml",
                                  "energy_based_config.yaml"])
def test_packaged_model_config_equals_jax_copy(name):
    """The port ships its own copy of each model YAML, byte-equal to the
    JAX package's."""
    from pathlib import Path

    import diffusion_model_universal_torch
    import diffusion_model_universal_tpu
    ours = Path(diffusion_model_universal_torch.__file__).parent / "configs"
    theirs = Path(diffusion_model_universal_tpu.__file__).parent / "configs"
    assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    assert "model_config" in yaml.safe_load((ours / name).read_text())


# -- the memory preflight ----------------------------------------------------

_PLAN_CASES = [
    # (num_samples, image_size, C, dtype bytes, params bytes, budget)
    (64, 64, 128, 2, 0, 8 * GIB),
    (1024, 64, 128, 2, 128 * 10 ** 6, 8 * GIB),
    (1000, 32, 128, 2, 127 * 10 ** 6, 2 * GIB),
    (37, 128, 256, 4, 0, 1 * GIB),
    (16, 32, 128, 2, 0, None),
    (8, 256, 512, 4, 0, 64 * 1024 ** 2),      # refused: one sample too big
]


@pytest.mark.parametrize("case", _PLAN_CASES)
def test_memory_planner_matches_jax(case):
    """estimate_sampler_bytes and plan_sampler_chunks agree with the
    reference's on the same request and budget, refusals included."""
    n, size, c, dbytes, pbytes, budget = case
    for batch in (1, 7, n):
        assert memory.estimate_sampler_bytes(
            batch, size, c, 3, dbytes, pbytes) == \
            jax_memory.estimate_sampler_bytes(batch, size, c, 3, dbytes,
                                              pbytes)
    kw = dict(image_size=size, model_channels=c, dtype_bytes=dbytes,
              params_bytes=pbytes)
    if budget is None:
        assert memory.plan_sampler_chunks(n, **kw) == (n, 1)
        return
    try:
        want = jax_memory.plan_sampler_chunks(n, budget_bytes=budget, **kw)
    except jax_memory.SamplerMemoryError as e:
        with pytest.raises(memory.SamplerMemoryError) as got:
            memory.plan_sampler_chunks(n, budget_bytes=budget, **kw)
        assert str(got.value) == str(e)
        return
    assert memory.plan_sampler_chunks(n, budget_bytes=budget, **kw) == want


def test_cpu_has_no_budget_unless_set(monkeypatch):
    monkeypatch.delenv("DMU_SAMPLER_HBM_BYTES", raising=False)
    assert memory.device_memory_budget("cpu") is None
    monkeypatch.setenv("DMU_SAMPLER_HBM_BYTES", "1e6")
    assert memory.device_memory_budget("cpu") == 500_000


TINY = {"num_timesteps": 3, "image_size": 32, "in_channels": 3,
        "model_channels": 8, "compute_dtype": "float32"}


def test_generate_cli_draws_a_request_in_planned_chunks(tmp_path,
                                                        monkeypatch, capsys):
    """With the budget forced small, ``generate`` on the CPU writes all
    ``--num_samples`` images in the planned chunks, and chunk i's images
    are those of a direct generate_samples call with chunk i's generator;
    with a budget too small for one sample it exits with the planner's
    message."""
    model = DDPM(TINY, device="cpu", seed=3)
    ckpt = str(tmp_path / "model.ckpt")
    model.save(ckpt)
    cfg = str(tmp_path / "cfg.yaml")
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump({"model_config": TINY}))
    pbytes = sum(p.numel() * p.element_size()
                 for p in model.net.parameters())
    one = memory.estimate_sampler_bytes(1, 32, 8, 3, 4, pbytes)
    hbm = 2 * (one + 2 * (one - pbytes))      # a budget of about 3 samples
    monkeypatch.setenv("DMU_SAMPLER_HBM_BYTES", str(hbm))
    chunk, n_chunks = memory.plan_sampler_chunks(
        7, 32, 8, 3, 4, pbytes, budget_bytes=hbm // 2)
    assert n_chunks > 1 and chunk * (n_chunks - 1) < 7 <= chunk * n_chunks
    out = tmp_path / "gen"
    assert gen_cli.main(["--config", cfg, "--model_type", "ddpm",
                         "--checkpoint", ckpt, "--num_samples", "7",
                         "--seed", "5", "--output_dir", str(out),
                         "--device", "cpu"]) == 0
    assert f"split into {n_chunks} chunks of {chunk}" in capsys.readouterr().out
    direct = []
    for ci in range(n_chunks):
        gen = torch.Generator().manual_seed(gen_cli.chunk_seed(5, ci))
        direct.append(model.generate_samples(min(chunk, 7 - ci * chunk),
                                             generator=gen))
    direct = torch.cat(direct).numpy()
    assert len(direct) == 7
    ref = tmp_path / "ref"
    for i in range(7):
        save_image(direct[i], str(ref / f"sample_{i:04d}.png"))
        assert (out / f"sample_{i:04d}.png").read_bytes() == \
            (ref / f"sample_{i:04d}.png").read_bytes()
    assert not (out / "sample_0007.png").exists()
    monkeypatch.setenv("DMU_SAMPLER_HBM_BYTES", str(one))
    with pytest.raises(SystemExit, match="--num_samples 7: sampler batch of "
                                         "even 1 sample"):
        gen_cli.main(["--config", cfg, "--model_type", "ddpm",
                      "--checkpoint", ckpt, "--num_samples", "7",
                      "--output_dir", str(out), "--device", "cpu"])
