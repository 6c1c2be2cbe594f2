"""Rank bodies of ``tests/test_torch_spatial.py``.

``parallel/mesh.py::spawn`` starts the ranks and imports these functions
by name, so they live in a module that imports no JAX. :func:`phases`
runs every scenario in one spawn: for each phase the ranks leave their
process group, the first ``world`` of them join a new one (the others
wait for the next phase), and run the phase's scenarios; what each
measured is written to ``out_dir/rank{r}.pt``, and the traceback of a
rank that raised to ``out_dir/rank{r}.err``.
"""

import os
import time
import traceback
from itertools import islice

import torch

from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.parallel import mesh, spatial
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.utils.benchmarks import SAMPLERS


def phases(device, out_dir, plan) -> None:
    """``plan``: a list of ``(world, [(name, function, args), ...])``;
    each phase on ranks 0 … world−1 of a group joined for it through
    ``out_dir``."""
    rank = mesh.rank()
    results = {"seconds": {}}
    try:
        for i, (world, scenarios) in enumerate(plan):
            # Every rank of the group leaves it together: a rank that
            # leaves while a peer is still connecting to it (gloo
            # finishes each rank's connections on its own) fails the
            # peer's join.
            mesh.barrier()
            mesh.shutdown()
            if rank >= world:
                continue
            mesh.init_process_group(
                rank, world, device,
                f"file://{os.path.join(out_dir, f'store{i}')}")
            for name, fn, args in scenarios:
                t0 = time.perf_counter()
                results[name] = globals()[fn](device, *args)
                results["seconds"][name] = time.perf_counter() - t0
    except BaseException:
        # Kept beside the results, where a run cut before its report
        # still leaves it.
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _layout(cfg):
    s = int(cfg["distributed"]["spatial_parallel"])
    return mesh.rank() // s, mesh.world_size() // s


def unet_forward(device, cfg, state, x, t) -> dict:
    """The UNet's forward of the whole ``x`` with its rows split over this
    rank's spatial group; every rank returns its (whole) output."""
    model = DDPM(cfg["model_config"], device=device, seed=0)
    model.net.load_state_dict(state)
    s = int(cfg["distributed"]["spatial_parallel"])
    model.net.set_row_group(spatial.make_row_groups(
        s, mesh.rank(), mesh.world_size()))
    with torch.no_grad():
        return {"out": model.net(x, t)}


def _trainer(device, cfg, state=None):
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    if state is not None:
        model.net.load_state_dict(state)
    loaders = get_dataset(cfg, device=device, split=_layout(cfg))
    return DDPMTrainer(model, *loaders, cfg, seed=0)


def validate(device, cfg, state) -> dict:
    tr = _trainer(device, cfg, state)
    out = {"val": tr.validate(), "test": tr.test()}
    tr.cleanup()
    return out


def dpm_sample(device, cfg, state, batch: int, steps: int) -> dict:
    """DPM++-``steps`` samples of ``batch`` from a seeded generator: this
    rank's data group's rows (``mesh.Scope.rows``), the network's rows
    split over its spatial group."""
    tr = _trainer(device, cfg, state)
    scope = mesh.sampling_scope(spatial=tr.spatial_parallel)
    gen = torch.Generator().manual_seed(3)
    images = getattr(tr.model, SAMPLERS["dpm++"])(
        batch, num_steps=steps, generator=gen, rows=scope.rows(batch))
    tr.cleanup()
    return {"images": images, "rows": scope.rows(batch)}


def benchmark(device, cfg, state, images) -> dict:
    """``train --benchmark``'s ``run_benchmark`` against the real
    ``images``: the results on rank 0."""
    tr = _trainer(device, cfg, state)
    results = train_cli.run_benchmark(
        tr, cfg, [images], True,
        mesh.sampling_scope(spatial=tr.spatial_parallel))
    tr.cleanup()
    return {"results": results}


def grid(device, cfg, state) -> dict:
    """The trainer's sample grid, drawn by every rank of rank 0's spatial
    group; rank 0 writes it."""
    tr = _trainer(device, cfg, state)
    out = {"path": None}
    if tr._row_split[0] == 0:
        path = tr.generate_samples(0)
        if tr.is_main:
            with open(path, "rb") as f:
                out["png"] = f.read()
    tr.cleanup()
    return out


def refusals(device, cfg) -> dict:
    """What a training update under spatial parallelism raises."""
    tr = _trainer(device, cfg)
    batch = next(iter(tr.train_loader))
    said = {}
    for name, fn in (("step", lambda: tr.step(batch)),
                     ("train", lambda: tr.train(1))):
        try:
            fn()
            said[name] = None
        except NotImplementedError as e:
            said[name] = str(e)
    tr.cleanup()
    return said


def throughput(device, cfg, steps: int) -> dict:
    """``train()`` for ``steps`` updates under ``--num_devices``' split
    (no spatial groups), with the time metrics on: rank 0's logged
    samples/s times its batch time, one value an update."""
    model = DDPM(cfg["model_config"], device=device, seed=0, trainable=True)
    loaders = get_dataset(cfg, device=device,
                          split=(mesh.rank(), mesh.world_size()))
    tr = DDPMTrainer(model, *loaders, cfg, seed=0)
    counts = []
    log = tr.logger.log

    def capture(metrics, step):
        if "performance/samples_per_second" in metrics:
            counts.append(metrics["performance/samples_per_second"]
                          * metrics["performance/batch_time"])
        log(metrics, step)

    tr.logger.log = capture
    tr.train_loader = _Head(tr.train_loader, steps)
    tr.steps_per_epoch = steps
    tr.train(1)
    tr.cleanup()
    return {"counts": counts}


class _Head:
    """The first ``n`` batches of a loader, each epoch."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return islice(iter(self.loader), self.n)
