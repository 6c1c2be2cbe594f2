"""Rank bodies of ``tests/test_torch_parallel.py``.

Each runs in a process that ``parallel/mesh.py::spawn`` starts, which
imports the function by name, so they live in a module that imports no
JAX. Each writes what it measured to ``out_dir/rank{r}.pt``.
"""

import os
import signal
from itertools import islice

import torch

from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.parallel import mesh
from diffusion_model_universal_torch.scripts.train import params_digest
from diffusion_model_universal_torch.trainers import DDPMTrainer


def _save(out_dir: str, **values) -> None:
    torch.save(values, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))


def state_of(tr) -> dict:
    """The replica's parameters, EMA and Adam moments, on the CPU."""
    return {k: [v.detach().cpu().clone() for v in vs] for k, vs in (
        ("params", tr.params), ("ema", tr.ema), ("mu", tr.optimizer.mu),
        ("nu", tr.optimizer.nu))}


def replica_digest(tr) -> str:
    return params_digest([*tr.params, *tr.ema, *tr.optimizer.mu,
                          *tr.optimizer.nu])


def injected_step(device, out_dir, cfg, net_state, x, t, noise) -> None:
    """One update on this rank's rows of the global batch ``x``, with the
    global batch's ``t`` and ``noise`` injected."""
    r, n, b = mesh.rank(), mesh.world_size(), x.shape[0]
    lo, hi = r * b // n, (r + 1) * b // n
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    model.net.load_state_dict(net_state)
    tr = DDPMTrainer(model, [None] * 5, None, None, cfg, seed=0)
    m = tr.step({"image": x[lo:hi], "rows": (lo, hi, b)}, t=t, noise=noise)
    tr.cleanup()
    _save(out_dir, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
          layer_grad_norms=[float(v) for v in m["layer_grad_norms"].values()],
          **state_of(tr))


def validate_only(device, out_dir, cfg) -> None:
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    loaders = get_dataset(cfg, device=device,
                          split=(mesh.rank(), mesh.world_size()))
    tr = DDPMTrainer(model, *loaders, cfg, seed=0)
    _save(out_dir, val=tr.validate())
    tr.cleanup()


def updates_then_preempt(device, out_dir, cfg, updates: int,
                         preempt_after: int) -> None:
    """``validate()``; ``updates`` updates from the split loader with the
    replica's digest after each; then ``train()``, with a SIGTERM sent to
    rank 1 alone after ``preempt_after`` of its updates."""
    r = mesh.rank()
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    loaders = get_dataset(cfg, device=device, split=(r, mesh.world_size()))
    tr = DDPMTrainer(model, *loaders, cfg, seed=0)
    val = tr.validate()
    metrics, digests = [], []
    for chunk in islice(tr._updates(loaders[0]), updates):
        m = tr.accum_step(chunk)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        digests.append(replica_digest(tr))
    after_updates = state_of(tr)

    if r == 1:
        step, seen = tr.accum_step, []

        def accum_step(chunk, draws=None):
            out = step(chunk, draws)
            seen.append(1)
            if len(seen) == preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        tr.accum_step = accum_step
    saves, save = [], tr.ckpt.save

    def counting_save(name, state):
        saves.append(name)
        return save(name, state)
    tr.ckpt.save = counting_save
    history = tr.train(1)
    tr.cleanup()
    _save(out_dir, val=val, metrics=metrics, digests=digests,
          after_updates=after_updates, history=history,
          preempted=tr.preempted, step=tr.step_count, saves=saves,
          digest_at_preemption=params_digest(tr.params))


def fail_on_rank1(device, out_dir) -> None:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails")
    mesh.barrier()
