"""The port's sample-quality harness (``utils/benchmarks.py``) and
``train --benchmark`` against the JAX package, on the CPU.

The pure metrics are held against JAX's on the same numpy inputs (FID to
1e-10 relative, IS to 1e-6, PSNR and SSIM to 1e-5); ``evaluate`` runs in
both packages on a stub model returning fixed samples, with the seeded
extractor's weights drawn with numpy and crossed through
``models/convert.py`` (the results to 1e-5). The reconstruction pairing
is held against a hand computation, the refusals against JAX's messages,
and the CLI runs the protocol end to end on a narrow UNet with an
InceptionV3 weights file written here.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from diffusion_model_universal_tpu.utils import benchmarks as jbench
from diffusion_model_universal_torch.models import ScoreBasedDiffusion
from diffusion_model_universal_torch.models.schedules import (
    make_noise_schedule)
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.utils import benchmarks as tbench
from diffusion_model_universal_torch.utils import inception as tinc
from tests.test_torch_extractors import crossed_extractors

torch.set_num_threads(4)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# -- pure metrics -----------------------------------------------------------

def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 64)).astype(np.float32)
    b = (1.3 * rng.standard_normal((256, 64)) + 0.2).astype(np.float32)
    got = tbench.frechet_distance(torch.from_numpy(a), b)
    assert _rel(got, jbench.frechet_distance(a, b)) <= 1e-10
    assert abs(tbench.frechet_distance(a, a)) <= 1e-6
    np.testing.assert_array_equal(tbench.covariance(a),
                                  jbench.covariance(a))


@pytest.mark.parametrize("n,splits", [(100, 10), (12, 20)])
def test_inception_score_matches_jax(n, splits):
    """The std is the population std (ddof 0), as ``jnp.std``'s; more
    splits than samples leave empty splits out."""
    logits = 3.0 * np.random.default_rng(1).standard_normal(
        (100, 10)).astype(np.float32)[:n]
    m, s = tbench.inception_score(torch.from_numpy(logits), splits)
    jm, js = jbench.inception_score(jnp.asarray(logits), splits)
    assert _rel(m, jm) <= 1e-6
    assert abs(s - js) <= 1e-6 * max(abs(js), 1.0)
    if splits == 3:
        assert s > 0.0


@pytest.mark.parametrize("window_type", ["gaussian", "uniform"])
def test_psnr_and_ssim_match_jax(window_type):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(
        np.float32)
    assert _rel(tbench.psnr(torch.from_numpy(x), torch.from_numpy(y)),
                jbench.psnr(x, y)) <= 1e-5
    assert _rel(tbench.ssim(x, y, window_type=window_type),
                jbench.ssim(x, y, window_type=window_type)) <= 1e-5
    with pytest.raises(ValueError, match="window_type"):
        tbench.ssim(x, y, window_type="box")


# -- the harness ---------------------------------------------------------------

_SAMPLES = np.random.default_rng(3).uniform(-1, 1, (5, 16, 16, 3)).astype(
    np.float32)
_REAL = [np.random.default_rng(4 + i).uniform(-1, 1, (2, 16, 16, 3))
         .astype(np.float32) for i in range(2)]


class _JaxStub:
    """Returns the next rows of _SAMPLES on each call."""

    def __init__(self):
        self.done = 0

    def generate_samples(self, params, key, bs):
        out = _SAMPLES[self.done:self.done + bs]
        self.done += bs
        return jnp.asarray(out)


class _TorchStub:
    device = torch.device("cpu")

    def __init__(self):
        self.done, self.generators = 0, []

    def generate_samples(self, bs, generator):
        self.generators.append(generator)
        out = _SAMPLES[self.done:self.done + bs]
        self.done += bs
        return torch.from_numpy(out)


def test_evaluate_matches_jax_with_a_ragged_tail(monkeypatch, tmp_path):
    """n_samples 5 in batches of 2 (2, 2, 1), unpaired SSIM/PSNR against
    real batches of 2 (i % 2, cut to the shorter), FID and IS on the
    crossed extractor: every key of the results within 1e-5."""
    jext, text = crossed_extractors(feature_dim=16, num_classes=10)
    monkeypatch.setattr(jbench, "make_extractor", lambda *a, **k: jext)
    want = jbench.DiffusionBenchmark(n_samples=5, batch_size=2).evaluate(
        _JaxStub(), None, [jnp.asarray(r) for r in _REAL])
    bench = tbench.DiffusionBenchmark(n_samples=5, batch_size=2,
                                      device="cpu")
    bench.extractor = text
    stub = _TorchStub()
    got = bench.evaluate(stub, [torch.from_numpy(r) for r in _REAL],
                         sample_dir=str(tmp_path / "grids"))
    assert set(got) == set(want) == {"fid", "is_mean", "is_std", "ssim",
                                     "psnr"}
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5 * max(
            abs(float(want[k])), 1.0), (k, got[k], want[k])
    assert stub.done == 5 and len(stub.generators) == 3
    assert sorted(p.name for p in (tmp_path / "grids").iterdir()) == [
        "batch_0000.png", "batch_0001.png", "batch_0002.png"]


class _EpsStub(_TorchStub):
    """An ε-model with a schedule and an analytic ε̂ = 0.3·x."""
    num_timesteps = 10

    def __init__(self):
        super().__init__()
        self.schedule = make_noise_schedule(1e-4, 2e-2, 10, "linear",
                                            device="cpu")

    def eps_fn(self):
        return lambda x, t: 0.3 * x


def test_reconstruction_pairing_by_hand():
    bench = tbench.DiffusionBenchmark(
        n_samples=2, batch_size=2, pairing="reconstruction", seed=4,
        recon_t_frac=0.35, device="cpu",
        metrics={"fid": False, "inception_score": False, "ssim": True,
                 "psnr": True})
    model = _EpsStub()
    got = bench.evaluate(model, [torch.from_numpy(r) for r in _REAL])
    ac = model.schedule.alphas_cumprod[3]          # max(int(10·0.35), 1)
    ssims, psnrs = [], []
    for j, r in enumerate(_REAL):
        x = torch.from_numpy(r)
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            5 * 1_000_003 + j))
        xt = torch.sqrt(ac) * x + torch.sqrt(1 - ac) * noise
        x0 = ((xt - torch.sqrt(1 - ac) * 0.3 * xt) / torch.sqrt(ac)).clamp(
            -1, 1)
        ssims.append(float(jbench.ssim(x0.numpy(), r)))
        psnrs.append(float(jbench.psnr(x0.numpy(), r)))
    assert set(got) == {"ssim", "psnr"}
    assert _rel(got["ssim"], np.mean(ssims)) <= 1e-5
    assert _rel(got["psnr"], np.mean(psnrs)) <= 1e-5


def test_refusals_match_jax(monkeypatch):
    """Reconstruction and a fast sampler on a score model are refused with
    the JAX package's messages, as are an unknown pairing or sampler."""
    score = ScoreBasedDiffusion({"image_size": 16, "in_channels": 3,
                                 "model_channels": 16, "num_scales": 2,
                                 "langevin_steps": 1,
                                 "compute_dtype": "float32"}, device="cpu")

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    class NoEps:
        pass

    jext, _ = crossed_extractors(feature_dim=16, num_classes=10)
    monkeypatch.setattr(jbench, "make_extractor", lambda *a, **k: jext)
    want = message(lambda: jbench.DiffusionBenchmark(
        pairing="reconstruction")._make_reconstruct(NoEps(), None))
    got = message(lambda: tbench.DiffusionBenchmark(
        pairing="reconstruction", device="cpu").evaluate(score, []))
    assert got == want and "reconstruction" in got
    want = message(lambda: jbench.DiffusionBenchmark(
        n_samples=2, sampler="dpm++").evaluate(NoEps(), None, []))
    got = message(lambda: tbench.DiffusionBenchmark(
        n_samples=2, sampler="dpm++", device="cpu").evaluate(score, []))
    assert got == want and "dpm++" in got
    for kw in ({"pairing": "paired"}, {"sampler": "ddim"}):
        assert message(lambda: tbench.DiffusionBenchmark(**kw)) == \
            message(lambda: jbench.DiffusionBenchmark(**kw))


def test_sampler_extractor_fid_seeds_each_chunk():
    _, text = crossed_extractors(feature_dim=16, num_classes=10)
    seeds = []

    def sample_fn(bs, generator):
        seeds.append(generator.initial_seed())
        return torch.randn((bs, 16, 16, 3), generator=generator) * 2.0

    real = tbench.extractor_features(_SAMPLES, text, batch=2)
    fid = tbench.sampler_extractor_fid(sample_fn, 5, real, text,
                                       key_seed=7, batch=2)
    assert np.isfinite(fid) and fid > 0.0
    assert seeds == [7 * 1_000_003 + i for i in (0, 2, 4)]


# -- the CLI ---------------------------------------------------------------------

def _config(tmp_path, bench=None):
    cfg = {
        "model_config": {"num_timesteps": 4, "image_size": 32,
                         "in_channels": 3, "model_channels": 16,
                         "compute_dtype": "float32"},
        "training": {"num_epochs": 1, "batch_size": 4,
                     "learning_rate": 1e-3, "sample_interval": 0,
                     "checkpoint_interval": 0, "val_interval": 0},
        "data": {"dataset": "synthetic", "image_size": 32,
                 "data_dir": "unused", "num_samples": 12},
        "output": {"output_dir": str(tmp_path / "run")},
    }
    if bench is not None:
        cfg["benchmark"] = bench
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_eval_only_benchmark_cli_with_inception_weights(tmp_path,
                                                        monkeypatch, capsys):
    """``train --eval_only --benchmark`` on the CPU: InceptionV3 from a
    weights file (no fallback), the strided sampler, finite metrics in the
    results file, one sample grid a batch."""
    net = tinc.init_inception_(tinc.InceptionV3(),
                               torch.Generator().manual_seed(0))
    npz = str(tmp_path / "inception.npz")
    tinc.save_inception_npz(net, npz)
    monkeypatch.setenv("DMU_INCEPTION_WEIGHTS", npz)
    cfg = _config(tmp_path, {"n_samples": 4, "batch_size": 2,
                             "sampler": "strided", "sampler_steps": 2,
                             "save_samples": True, "sample_dir": "grids"})
    assert train_cli.main(["--config", cfg, "--model_type", "ddpm",
                           "--device", "cpu", "--eval_only",
                           "--benchmark"]) == 0
    out = capsys.readouterr().out
    assert "Falling back" not in out and "Benchmark:" in out
    results = json.loads((tmp_path / "run" / "benchmark_results.json")
                         .read_text())
    for k in ("fid", "is_mean", "is_std", "ssim", "psnr"):
        assert np.isfinite(results[k]), (k, results)
    assert len(list((tmp_path / "run" / "grids").iterdir())) == 2


def test_benchmark_defaults_are_the_reference_protocol(tmp_path,
                                                       monkeypatch):
    """No ``benchmark`` section: 50,000 samples with --eval_only, 2,000
    after training, the training batch, InceptionV3 requested, the EMA
    weights in place while evaluating."""
    captured = []

    class FakeBenchmark:
        def __init__(self, n_samples, batch_size, use_inception, **kw):
            captured.append({"n_samples": n_samples,
                             "batch_size": batch_size,
                             "use_inception": use_inception})

        def evaluate(self, model, loader, sample_dir=None):
            captured[-1]["weights"] = [p.detach().clone()
                                       for p in model.net.parameters()]
            return {"fid": 1.0}

    monkeypatch.setattr(tbench, "DiffusionBenchmark", FakeBenchmark)
    cfg = _config(tmp_path)
    base = ["--config", cfg, "--model_type", "ddpm", "--device", "cpu",
            "--benchmark"]
    assert train_cli.main(base + ["--eval_only"]) == 0
    assert train_cli.main(base) == 0
    assert [(c["n_samples"], c["batch_size"], c["use_inception"])
            for c in captured] == [(50000, 4, True), (2000, 4, True)]
    from diffusion_model_universal_torch.utils.checkpoint import read_state
    ema = read_state(str(tmp_path / "run" / "checkpoints" / "final_model"))[
        "ema_params"]
    for got, want in zip(captured[1]["weights"], ema.values()):
        assert torch.equal(got, want)
    assert json.loads((tmp_path / "run" / "benchmark_results.json")
                      .read_text()) == {"fid": 1.0}
