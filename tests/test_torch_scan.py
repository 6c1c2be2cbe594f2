"""``training.scan_steps`` K > 1 on the CPU, at a small size (C=8, 32²,
T=8, B=2), with no JAX model.

On the CPU a chunk of K updates runs eagerly: it is the plain version of
the CUDA graph that replays the chunk on the card (``chip_smoke.py``
phase 17 holds the graph against eager updates there). Held here: the
chunks against single updates bit for bit, the loop's log, validation
and throughput events against the reference's rule, the refusals, Adam's
per-update scalars chosen on the device across a skipped update, and
each family's ``loss_draws`` against the draws of its own loss.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import MODEL_REGISTRY
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.trainers import optim as topt
from diffusion_model_universal_torch.trainers.scan import (
    SCAN_ACCUM_EXCLUSIVE, scan_refusal)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MODEL_CFG = {"num_timesteps": 8, "image_size": 32, "in_channels": 3,
             "model_channels": 8, "compute_dtype": "float32",
             "dropout": 0.0, "remat": False}


def _config(tmp_path, num_samples, model=None, logging=None, **training):
    return {
        "model_name": "DDPM", "model_config": dict(MODEL_CFG, **(model or {})),
        "training": {"num_epochs": 1, "batch_size": 2,
                     "learning_rate": 1e-3, "ema_decay": 0.99,
                     "scheduler": {"type": "cosine", "min_lr": 1e-5},
                     "val_interval": 0, "sample_interval": 0,
                     "checkpoint_interval": 0, **training},
        "data": {"dataset": "synthetic", "data_dir": "unused",
                 "num_samples": num_samples},
        "logging": {"log_interval": 1, **(logging or {})},
        "output": {"output_dir": str(tmp_path / "run")},
    }


def _trainer(cfg):
    model = MODEL_REGISTRY["ddpm"](cfg["model_config"], device="cpu",
                                   seed=3, trainable=True)
    return DDPMTrainer(model, *get_dataset(cfg, device="cpu"), cfg, seed=0)


def _records(trainer):
    return [json.loads(line) for line in
            (trainer.output_dir / "metrics.jsonl").read_text().splitlines()]


# -- the chunk against single updates ---------------------------------------

def test_scan_chunks_equal_single_steps(tmp_path):
    """The reference's scenario (``tests/test_trainer.py``'s
    ``test_scan_steps_matches_single_step_path``): 12 updates at K=5, two
    chunks and a ragged tail of two, against 12 single updates, with
    dropout 0.1 (each single update is held against JAX's step
    in ``tests/test_torch_train.py``), clip and the non-finite skip:
    parameters, EMA, μ, ν, Adam's counters, the epoch's mean loss and
    each chunk's logged loss bit for bit."""
    model = {"dropout": 0.1}
    extra = {"grad_clip": 1.0, "skip_nonfinite_updates": 3}
    trainers, hist = [], []
    for name, k in (("scan", 5), ("single", 1)):
        # One after the other: a trainer seeds the dropout RNG when built.
        trainers.append(_trainer(_config(tmp_path / name, 30, model,
                                         scan_steps=k, **extra)))
        hist.append(trainers[-1].train(1))
    scan, single = trainers
    assert scan.steps_per_epoch == 12 and scan.graphs is None
    assert scan.step_count == single.step_count == 12
    for a, b in zip(scan.params + scan.ema + scan.optimizer.mu
                    + scan.optimizer.nu,
                    single.params + single.ema + single.optimizer.mu
                    + single.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(scan.optimizer.counters, single.optimizer.counters)
    assert scan.optimizer.count == 12
    assert hist[0]["train_loss"] == hist[1]["train_loss"]
    losses = {r["step"]: r["train/loss"] for r in _records(single)
              if "train/loss" in r}
    # Each chunk logs its steps' mean at its end; the tail's updates log
    # as single steps (step 10 twice: the second chunk's end, the tail).
    logged = [(r["step"], r["train/loss"]) for r in _records(scan)
              if "train/loss" in r]
    chunk_means = [float(torch.tensor(
        [losses[s] for s in range(end - 5, end)]).mean()) for end in (5, 10)]
    assert logged == [(5, chunk_means[0]), (10, chunk_means[1]),
                      (10, losses[10]), (11, losses[11])]
    for tr in (scan, single):
        tr.cleanup()


def _jax_exclusivity_message() -> str:
    """The text of the reference's ``ValueError`` for ``scan_steps`` with
    ``grad_accum_steps``, read from its source."""
    path = REPO / "diffusion_model_universal_tpu" / "trainers" / "trainer.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.If) and "scan_steps" in ast.unparse(
                node.test) and "grad_accum" in ast.unparse(node.test):
            (raise_,) = [n for n in node.body if isinstance(n, ast.Raise)]
            return ast.literal_eval(raise_.exc.args[0])
    raise AssertionError("no scan_steps/grad_accum_steps check found")


def test_scan_and_accumulation_are_exclusive_as_in_jax(tmp_path):
    assert SCAN_ACCUM_EXCLUSIVE == _jax_exclusivity_message()
    cfg = _config(tmp_path, 10, scan_steps=4, grad_accum_steps=2)
    with pytest.raises(ValueError) as err:
        _trainer(cfg)
    assert str(err.value) == SCAN_ACCUM_EXCLUSIVE


# -- the loop's events -------------------------------------------------------

def jax_events(steps_per_epoch, epochs, k, log_interval, val_interval):
    """The reference's scan loop (``J/trainers/trainer.py`` ``train``, its
    ``scan_steps > 1`` branch) reduced to the steps at which it logs and
    validates: a chunk logs where ``step % log_interval < K`` and
    validates where ``step % val_interval < K`` after its K updates; a
    tail update logs at its step before the update and validates at the
    count after it."""
    logs, vals, step = [], [], 0
    for _ in range(epochs):
        for _ in range(steps_per_epoch // k):
            step += k
            if step % log_interval < k:
                logs.append(step)
            if val_interval and step % val_interval < k:
                vals.append(step)
        for _ in range(steps_per_epoch % k):
            if step % log_interval == 0:
                logs.append(step)
            step += 1
            if val_interval and step % val_interval == 0:
                vals.append(step)
    return logs, vals


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """Two epochs of 8 updates at K=3 (chunks end at 3 and 6, a tail of 2
    an epoch), logging every 2 steps with throughput, validating every 5:
    the metrics a ``train()`` run writes."""
    tmp = tmp_path_factory.mktemp("loop")
    cfg = _config(tmp, 20, scan_steps=3, val_interval=5, num_epochs=2,
                  logging={"log_interval": 2, "track_time_metrics": True})
    tr = _trainer(cfg)
    tr.train(2)
    recs = _records(tr)
    tr.cleanup()
    return tr.steps_per_epoch, recs


def test_scan_log_and_validation_steps_follow_jax(loop_run):
    steps_per_epoch, recs = loop_run
    assert steps_per_epoch == 8
    logs, vals = jax_events(8, 2, 3, 2, 5)
    assert [r["step"] for r in recs if "train/loss" in r] == logs
    assert [r["step"] for r in recs if "val/loss" in r] == vals
    assert vals == [6, 11, 15]
    assert all(np.isfinite(r["train/loss"]) for r in recs
               if "train/loss" in r)


def test_scan_logs_throughput_between_log_events(loop_run):
    """As the reference's ``test_scan_path_logs_throughput_metrics``: a
    rate at every chunk's log event but the first, carried across the
    epoch boundary (the first event of epoch 2 has one), finite and
    positive, with a batch time beside each."""
    _, recs = loop_run
    sps = [r for r in recs if "performance/samples_per_second" in r]
    assert [r["step"] for r in sps] == [6, 11, 14]
    epoch_end = min(r["step"] for r in recs if "epoch/time" in r)
    ep2_events = [r["step"] for r in recs
                  if "train/loss" in r and r["step"] > epoch_end]
    assert min(r["step"] for r in sps if r["step"] > epoch_end) == \
        min(ep2_events)
    assert all(np.isfinite(r["performance/samples_per_second"])
               and r["performance/samples_per_second"] > 0 for r in sps)
    assert all("performance/batch_time" in r for r in sps)


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("k,device,backend,model_parallel,refused", [
    (4, "cuda", "gloo", 1, "gloo"),
    (4, "cuda", "nccl", 2, "model_parallel"),
    (4, "cuda", "nccl", 1, None),
    (4, "cuda", None, 1, None),
    (4, "cpu", "gloo", 2, None),
    (1, "cuda", "gloo", 2, None)])
def test_scan_refusals(k, device, backend, model_parallel, refused):
    """On the card a chunk is captured: gloo's host collectives and the
    shards' gathers and frees cannot be; on the CPU the chunk is eager."""
    got = scan_refusal(k, device, backend, model_parallel)
    if refused is None:
        assert got is None
    else:
        assert refused in got and "scan_steps" in got


# -- Adam's device scalars ---------------------------------------------------

@pytest.mark.parametrize("skip", [0, 2])
def test_adam_table_rows_follow_the_device_count(skip):
    """Three updates from one table (the chunk's path: each update's row
    chosen on the device from the count since the table was made) equal
    three eager updates, also when the second has a NaN gradient and the
    skip leaves the count behind."""
    cfg = {"learning_rate": 1e-2, "beta1": 0.8, "beta2": 0.95,
           "scheduler": {"type": "cosine", "min_lr": 1e-4},
           "grad_clip": 0.5, "skip_nonfinite_updates": skip}
    rng = np.random.default_rng(4)
    start = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in start]
             for _ in range(3)]
    if skip:
        grads[1][1][2] = np.nan
    opts = []
    for chunked in (False, True):
        params = [torch.from_numpy(p.copy()) for p in start]
        opt, _ = topt.make_optimizer(params, cfg, 4, 2)
        opt.step([torch.ones_like(p) for p in params],
                 torch.tensor(1.0))   # count 1 before the three
        table, begin = opt.scalar_table(3), opt.counters[0].clone()
        for g in grads:
            tg = [torch.from_numpy(x.copy()) for x in g]
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(tg)))
            opt.step(tg, norm, opt.row(table, begin) if chunked else None)
        if chunked:
            opt.advance(3)
        opts.append((opt, params))
    (a, pa), (b, pb) = opts
    for x, y in zip(pa + a.mu + a.nu, pb + b.mu + b.nu):
        assert torch.equal(x, y)
    assert a.counters.tolist() == b.counters.tolist() == (
        [3, 0, 1] if skip else [4, 0, 0])


# -- each family's draws -----------------------------------------------------

FAMILIES = {
    "ddpm_conditional": ("ddpm", {"num_classes": 3, "cfg_drop_prob": 0.5}),
    "score_based": ("score_based", {"num_scales": 4}),
    "energy_cd_gp": ("energy_based", {"langevin_steps": 2,
                                      "model_channels": 16}),
    "energy_dsm": ("energy_based", {"langevin_steps": 2,
                                    "model_channels": 16,
                                    "training_objective": "dsm"})}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_draws_are_the_losses_own(family):
    """A scanned update injects ``loss_draws``, made from the step's
    generator; they must be the draws the loss makes from the same
    generator: t/ε and the label drop's uniform (DDPM), σ/ε (score), t/ε,
    the Langevin draws and α (energy CD + GP), t/ε (energy DSM)."""
    name, extra = FAMILIES[family]
    model = MODEL_REGISTRY[name](dict(MODEL_CFG, **extra), device="cpu",
                                 seed=1, trainable=True)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    y = torch.tensor([0, 2]) if name == "ddpm" else None
    gen = torch.Generator()
    drawn = model.loss_function(x, generator=gen.manual_seed(5), y=y)
    draws = model.loss_draws(x, generator=gen.manual_seed(5), y=y)
    want = {"ddpm": {"t", "noise", "cfg_u"}, "score_based": {"sigma",
                                                            "noise"},
            "energy_based": {"t", "noise", "langevin_noise", "alpha"}}[name]
    if family == "energy_dsm":
        want = {"t", "noise"}
    assert set(draws) == want
    injected = model.loss_function(x, generator=None, y=y, **draws)
    assert torch.equal(drawn, injected)
