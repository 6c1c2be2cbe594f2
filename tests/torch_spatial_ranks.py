"""Rank bodies of ``tests/test_torch_spatial.py`` and
``tests/test_torch_spatial_train.py``.

``parallel/mesh.py::spawn`` starts the ranks and imports these functions
by name, so they live in a module that imports no JAX. :func:`phases`
runs every scenario in one spawn: for each phase the ranks leave their
process group, the first ``world`` of them join a new one (the others
wait for the next phase), and run the phase's scenarios; what each
measured is written to ``out_dir/rank{r}.pt``, and the traceback of a
rank that raised to ``out_dir/rank{r}.err``.
"""

import faulthandler
import os
import time
import traceback
from itertools import islice

import torch

from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import DDPM, MODEL_REGISTRY
from diffusion_model_universal_torch.parallel import mesh, spatial
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers import (TRAINER_REGISTRY,
                                                      DDPMTrainer)
from diffusion_model_universal_torch.utils.benchmarks import SAMPLERS


def phases(device, out_dir, plan, timeout=None) -> None:
    """``plan``: a list of ``(world, [(name, function, args), ...])``,
    or ``(world, scenarios, solo)``; each phase on ranks 0 … world−1 of a
    group joined for it through ``out_dir``, while each rank r ≥ world
    runs ``solo[r]`` (the same triples) alone, in no group: one process
    of the port. A rank still running after ``timeout`` seconds (a
    collective no peer joins) writes its threads' tracebacks to
    ``out_dir/rank{r}.hang`` and exits."""
    rank = mesh.rank()
    results = {"seconds": {}}
    if timeout is not None:
        hang = open(os.path.join(out_dir, f"rank{rank}.hang"), "w")
        faulthandler.dump_traceback_later(timeout, exit=True, file=hang)
    try:
        for i, (world, scenarios, *solo) in enumerate(plan):
            # Every rank of the group leaves it together: a rank that
            # leaves while a peer is still connecting to it (gloo
            # finishes each rank's connections on its own) fails the
            # peer's join.
            mesh.barrier()
            mesh.shutdown()
            if rank >= world:
                scenarios = solo[0].get(rank, []) if solo else []
            else:
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
    if timeout is not None:
        faulthandler.cancel_dump_traceback_later()


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


# -- training (``tests/test_torch_spatial_train.py``) -------------------------
# Each function below runs on the ranks of a spatial group and, with a
# config without a ``distributed`` section, in one process: the test holds
# the two against each other.

def _family_trainer(device, cfg, family, state, loaders=None):
    model = MODEL_REGISTRY[family](cfg["model_config"], device=device,
                                   seed=0, trainable=True)
    if state is not None:
        model.net.load_state_dict(state)
    return TRAINER_REGISTRY[family](model, *(loaders or ([None] * 5, None,
                                                         None)),
                                    cfg, seed=0)


def _rows_of(tr, x):
    """The trainer's data group's rows of the global batch ``x``, as the
    split loaders hand them over (one process: ``x``)."""
    i, n = tr._row_split
    if n == 1:
        return x
    b = x.shape[0]
    return {"image": x[i * b // n:(i + 1) * b // n],
            "rows": (i * b // n, (i + 1) * b // n, b)}


def _state(tr) -> dict:
    return {"params": [p.detach().clone() for p in tr.params],
            "ema": [e.clone() for e in tr.ema],
            "mu": [m.clone() for m in tr.optimizer.mu],
            "nu": [v.clone() for v in tr.optimizer.nu]}


def update(device, cfg, family, state, batches, mode: str,
           draws=None) -> dict:
    """One update of the ``family``'s trainer from the global ``batches``
    (``mode`` ``accum``: their micro-batches, ``draws`` injected when
    given; ``scan``: a chunk of one update a batch): its loss, gradient
    norms and the state after it."""
    tr = _family_trainer(device, cfg, family, state)
    mine = [_rows_of(tr, x) for x in batches]
    if mode == "scan":
        out = {"loss": tr.scan_chunk(mine)}
    else:
        m = tr.accum_step(mine, draws)
        out = {"loss": m["loss"], "grad_norm": m["grad_norm"],
               "layer_grad_norms": torch.stack(
                   list(m["layer_grad_norms"].values()))}
    out.update(_state(tr), names=list(tr.param_names))
    tr.cleanup()
    return out


def train_resume(device, cfg, argv) -> dict:
    """``train``'s rank body (``scripts/train.py::_run_rank``; in one
    process its ``run``): an epoch with its checkpoint, then a second
    epoch resumed from it (``--resume latest``). Rank 0 writes the
    checkpoints, which the test reads."""
    for epochs, extra in ((1, []), (2, ["--resume", "latest"])):
        args = train_cli.build_argparser().parse_args([*argv, *extra])
        run_cfg = dict(cfg, training=dict(cfg["training"],
                                          num_epochs=epochs))
        if mesh.is_initialized():
            rc = train_cli._run_rank(device, args, run_cfg)
        else:
            rc = train_cli.run(args, run_cfg, device)
        assert rc == 0
    return {}


def layer_grads(device, kind, state, x, cot) -> dict:
    """The gradients of Σ out·cot over this rank's rows of a split layer's
    output (``kind``: ``conv3x3``, ``down``, ``down_gathered`` or ``up``)
    for the whole NCHW input ``x``, its rows split over every rank: the
    gradient of ``x`` (zero outside the rank's rows) and the weights'
    (this rank's share), through ``slice``, ``halo`` and ``gather``."""
    from diffusion_model_universal_torch.models.layers.resnet import (
        Downsample, SplitConv, Upsample)
    mod = {"conv3x3": lambda: SplitConv(16, 24, 3, bias=True),
           "down": lambda: Downsample(16, conv_bias=True),
           "down_gathered": lambda: Downsample(16, conv_bias=True),
           "up": lambda: Upsample(16, conv_bias=True)}[kind]()
    mod.load_state_dict(state)
    group = spatial.make_row_groups(mesh.world_size(), mesh.rank(),
                                    mesh.world_size())
    x = x.clone().requires_grad_()
    with spatial.split(group):
        out = mod(group.slice(x))
    if kind == "down_gathered":      # returned whole: keep the rank's rows
        out = group.slice(out)
    loss = (out * group.slice(cot)).sum()
    grads = torch.autograd.grad(loss, [x, *mod.parameters()])
    return {"x": grads[0], "weights": dict(zip(
        [n for n, _ in mod.named_parameters()], grads[1:]))}


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
