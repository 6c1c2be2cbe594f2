"""Rank bodies of ``tests/test_torch_parallel.py``.

Each runs in a process that ``parallel/mesh.py::spawn`` starts, which
imports the function by name, so they live in a module that imports no
JAX. :func:`scenarios` runs several of them in one spawn (a spawn costs
seconds of process start) and writes what each measured to
``out_dir/rank{r}.pt``.
"""

import json
import os
import signal
import threading
import time
import urllib.request
from itertools import islice

import torch

from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.parallel import mesh
from diffusion_model_universal_torch.scripts import generate
from diffusion_model_universal_torch.scripts import serve
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.scripts.train import params_digest
from diffusion_model_universal_torch.trainers import DDPMTrainer


def _save(out_dir: str, **values) -> None:
    torch.save(values, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))


def scenarios(device, out_dir, plan) -> None:
    """Each ``(name, function, args)`` of ``plan`` in order on this rank,
    ``function(device, *args)`` a body of this module; their results
    saved under their names."""
    _save(out_dir, **{name: globals()[fn](device, *args)
                      for name, fn, args in plan})


def state_of(tr) -> dict:
    """The replica's parameters, EMA and Adam moments, on the CPU."""
    return {k: [v.detach().cpu().clone() for v in vs] for k, vs in (
        ("params", tr.params), ("ema", tr.ema), ("mu", tr.optimizer.mu),
        ("nu", tr.optimizer.nu))}


def replica_digest(tr) -> str:
    return params_digest([*tr.params, *tr.ema, *tr.optimizer.mu,
                          *tr.optimizer.nu])


def injected_step(device, cfg, net_state, x, t, noise) -> dict:
    """One update on this rank's rows of the global batch ``x``, with the
    global batch's ``t`` and ``noise`` injected."""
    r, n, b = mesh.rank(), mesh.world_size(), x.shape[0]
    lo, hi = r * b // n, (r + 1) * b // n
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    model.net.load_state_dict(net_state)
    tr = DDPMTrainer(model, [None] * 5, None, None, cfg, seed=0)
    m = tr.step({"image": x[lo:hi], "rows": (lo, hi, b)}, t=t, noise=noise)
    tr.cleanup()
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                layer_grad_norms=[float(v) for v in
                                  m["layer_grad_norms"].values()],
                **state_of(tr))


def validate_only(device, cfg) -> dict:
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    loaders = get_dataset(cfg, device=device,
                          split=(mesh.rank(), mesh.world_size()))
    tr = DDPMTrainer(model, *loaders, cfg, seed=0)
    val = tr.validate()
    tr.cleanup()
    return {"val": val}


def updates_then_preempt(device, cfg, updates: int,
                         preempt_after: int) -> dict:
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
    return dict(val=val, metrics=metrics, digests=digests,
                after_updates=after_updates, history=history,
                preempted=tr.preempted, step=tr.step_count, saves=saves,
                digest_at_preemption=params_digest(tr.params))


def fail_on_rank1(device, out_dir) -> None:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails")
    mesh.barrier()


# -- sampling over ranks ---------------------------------------------------

def generate_draws(device, cases) -> dict:
    """``generate.draw`` of each ``name: (argv, budget)`` (budget: the
    ``DMU_SAMPLER_HBM_BYTES`` the request plans with, or None); the
    images on rank 0, None elsewhere."""
    out = {}
    for name, (argv, budget) in cases.items():
        if budget is None:
            os.environ.pop("DMU_SAMPLER_HBM_BYTES", None)
        else:
            os.environ["DMU_SAMPLER_HBM_BYTES"] = str(budget)
        out[name] = generate.draw(generate.build_argparser().parse_args(
            argv), device)
    os.environ.pop("DMU_SAMPLER_HBM_BYTES", None)
    return out


def generate_cli(device, argv) -> dict:
    """The ``--num_devices`` launcher's target, as ``generate.main``
    spawns it: rank 0 writes the PNGs."""
    return {"code": generate.run_rank(device, generate.build_argparser()
                                      .parse_args(argv))}


def _post(base: str, body: dict):
    import io

    import numpy as np
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(dict(body, format="npy")).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return 200, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]


def serve_ranks(device, argv, bodies) -> dict:
    """``serve.run_rank`` (the ``--num_devices`` launcher's target) on
    every rank; rank 0 also posts ``bodies`` to its server from a thread,
    reads ``/healthz``, then sends itself the SIGTERM that stops every
    rank. Rank 0 returns the answers, the others nothing."""
    args = serve.build_argparser().parse_args(argv)
    answers = {}
    if mesh.rank() == 0:
        base = f"http://{args.host}:{args.port}"

        def client():
            try:
                while True:
                    try:
                        with urllib.request.urlopen(base + "/healthz",
                                                    timeout=5) as r:
                            json.loads(r.read())
                        break
                    except OSError:
                        time.sleep(0.05)
                answers["responses"] = [_post(base, b) for b in bodies]
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=30) as r:
                    answers["healthz"] = json.loads(r.read())
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=client, daemon=True).start()
    answers["code"] = serve.run_rank(device, args)
    return answers


def benchmark(device, cfg, ckpt, images) -> dict:
    """``train --benchmark``'s ``run_benchmark`` of the model-only
    checkpoint ``ckpt`` (a replica's EMA, which starts as its weights)
    against the real ``images``, sampled over every rank; the results on
    rank 0."""
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    model.load(ckpt)
    tr = DDPMTrainer(model, [None] * 5, None, None, cfg, seed=0)
    results = train_cli.run_benchmark(tr, cfg, [images], True,
                                      mesh.sampling_scope())
    tr.cleanup()
    return {"results": results}


# -- model parallelism -------------------------------------------------------

def model_parallel(device, cfg, updates: int) -> dict:
    """``distributed.model_parallel: 2`` on the ranks (D=1, M=2): each
    rank's resident shapes, ``updates`` updates from the split loader,
    the gathered state (rank 0) and the whole parameters' digest, a
    checkpoint ``mp``; ``train()`` raising on every rank after one more
    update (each rank writes its shards of the emergency checkpoint) and
    the gathered state's digest then; then a trainer of (D=2, M=1) and a
    new one of (D=1, M=2) restore ``mp``."""
    r, n = mesh.rank(), mesh.world_size()
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    loaders = get_dataset(cfg, device=device, split=(r, n))
    tr = DDPMTrainer(model, *loaders, cfg, seed=0)
    out = {"plan": tr.sharding.plan,
           "shapes": {k: [tuple(t.shape) for t in ts] for k, ts in (
               ("net", tr.params), ("params", tr.master), ("ema", tr.ema),
               ("mu", tr.optimizer.mu), ("nu", tr.optimizer.nu))},
           "metrics": []}
    for chunk in islice(tr._updates(loaders[0]), updates):
        m = tr.accum_step(chunk)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    state = tr.state(0)
    with tr.whole_params():
        out["digest"] = params_digest(tr.params)
    tr.save_checkpoint("mp", 0)
    step = tr.accum_step

    def accum_step(chunk, draws=None):
        step(chunk, draws)
        raise ValueError("the loss went wrong")
    tr.accum_step = accum_step
    try:
        tr.train(1)
    except ValueError:
        out["emergency"] = (tr.step_count // tr.steps_per_epoch,
                            state_digest(tr.state(0)))
    tr.cleanup()
    out["state"] = state if r == 0 else None
    flat = dict(cfg, distributed={"model_parallel": 1})
    dp = DDPMTrainer(DDPM(cfg["model_config"], device=device, seed=5,
                          trainable=True), *loaders, flat, seed=0)
    dp.load_checkpoint("mp")
    out["restored_dp"] = replica_digest(dp)
    dp.cleanup()
    mp = DDPMTrainer(DDPM(cfg["model_config"], device=device, seed=5,
                          trainable=True), *loaders, cfg, seed=0)
    mp.load_checkpoint("mp")
    out["restored_mp"] = state_digest(mp.state(0))
    mp.cleanup()
    return out


def state_digest(state) -> str:
    """The digest of a checkpoint state's parameters, EMA, μ and ν, in
    the order of :func:`replica_digest`."""
    return params_digest([*state["params"].values(),
                          *state["ema_params"].values(),
                          *state["opt_state"]["mu"],
                          *state["opt_state"]["nu"]])
