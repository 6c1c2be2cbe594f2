"""Training CLI of the port (counterpart of the reference's
``scripts/train.py``).

    python -m diffusion_model_universal_torch.scripts.train \
        --config diffusion_model_universal_torch/configs/ddpm_config.yaml \
        --model_type ddpm|ddim|score_based|energy_based \
        [--resume latest|NAME] [--eval_only] [--benchmark] [--seed N] \
        [--profile [DIR]] [--profile_steps N] [--device cuda|cpu] \
        [--num_devices N | --multihost]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without
CUDA otherwise. Trains, then reports the test loss and saves
``final_model``; ``--eval_only`` reports the test loss only. A SIGTERM
saves a resumable checkpoint and exits with 143.

``--benchmark`` then runs the sample-quality protocol
(``utils/benchmarks.py``) on the EMA weights (``benchmark.use_ema:
false``: the raw ones) with the config's ``benchmark`` section:
``n_samples`` (default 50,000 with ``--eval_only``, 2,000 after
training), ``batch_size`` (default the training batch),
``use_inception`` (default true: InceptionV3 with the weights in
``$DMU_INCEPTION_WEIGHTS``, else the seeded extractor with a warning),
``metrics``, ``pairing``, ``sampler``/``sampler_steps``,
``save_samples``/``sample_dir`` and ``results_file`` (default
``benchmark_results.json``), the files under ``output.output_dir``. It
prints ``Benchmark: {json}``.

``--profile`` first traces ``--profile_steps`` real updates (after one
warm-up update) with ``torch.profiler`` into DIR (default
``output_dir/profile``) and prints ``Profiler trace written to DIR``;
training then goes on from there.

Data parallelism (``parallel/mesh.py``), in the reference's two modes:

* ``--num_devices N`` (``--num_gpus``): one launch over the first N
  devices (all of them when N exceeds the count; on the CPU, N
  processes). N > 1 spawns N ranks, rank r on device r, that split each
  batch of ``training.batch_size`` B, which must divide by N: rank r
  takes rows [r·B/N, (r+1)·B/N), so the data order is one device's.
* ``--multihost``: one process per card, launched by ``torchrun``, whose
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) it reads; without it, it exits. Each process loads its
  shard of the data at batch B, so the global batch is B × processes.
  ``logging.track_histograms`` is off, as in the reference.

Either way an update equals one process's on the global batch (up to the
order of f32 sums), rank 0 alone prints, logs and writes checkpoints, and
``--benchmark`` runs on rank 0 (on the whole test set with
``--num_devices``, on its shard with ``--multihost``). NCCL joins the
ranks on the card, gloo on the CPU. The config's ``distributed`` section
gives the layout: ``model_parallel`` and ``spatial_parallel`` > 1 are not
ported and exit (``backend`` and ``find_unused_parameters`` are
accepted and unused).

On the card the run ends by printing each kernel's launches in the run
(``Kernel launches``, ``Kernel launches (rank r of N)`` under data
parallelism), after those of the benchmark alone (``Benchmark kernel
launches``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
from pathlib import Path

from ..ops._build import launch_counts
from ..parallel import mesh
from .generate import MODEL_TYPES


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train diffusion models "
                                            "(PyTorch)")
    p.add_argument("--config", type=str, required=True,
                   help="Path to YAML config file")
    p.add_argument("--model_type", type=str, required=True,
                   choices=MODEL_TYPES)
    p.add_argument("--resume", type=str, default=None,
                   help="Checkpoint name (or 'latest') to resume from")
    p.add_argument("--eval_only", action="store_true",
                   help="Only run evaluation on the test set")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--num_devices", "--num_gpus", type=int, default=None,
                   dest="num_devices")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", nargs="?", const="__default__", default=None,
                   metavar="DIR")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def params_digest(tensors) -> str:
    """sha256 of ``tensors`` in order (a resumed run prints it for the
    parameters it restored, so a caller can check the restore bit for
    bit)."""
    h = hashlib.sha256()
    for p in tensors:
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_benchmark(trainer, config, test_loader, eval_only: bool) -> dict:
    """The ``--benchmark`` protocol on the trainer's model; writes and
    prints the results."""
    from ..utils import benchmarks
    bench_cfg = config.get("benchmark", {}) or {}
    model = trainer.model
    bench = benchmarks.DiffusionBenchmark(
        n_samples=bench_cfg.get("n_samples", 50000 if eval_only else 2000),
        batch_size=bench_cfg.get(
            "batch_size", config.get("training", {}).get("batch_size", 128)),
        use_inception=bench_cfg.get("use_inception", True),
        metrics=bench_cfg.get("metrics"),
        pairing=bench_cfg.get("pairing", "unpaired"),
        sampler=bench_cfg.get("sampler", "default"),
        sampler_steps=bench_cfg.get("sampler_steps"),
        device=model.device)
    out_dir = Path(config.get("output", {}).get("output_dir", "outputs"))
    out_dir.mkdir(parents=True, exist_ok=True)
    sample_dir = None
    if bench_cfg.get("save_samples", False):
        sample_dir = str(out_dir / bench_cfg.get("sample_dir",
                                                 "benchmark_samples"))
    before = launch_counts()
    with trainer.ema_weights() if bench_cfg.get("use_ema", True) \
            else contextlib.nullcontext():
        results = bench.evaluate(model, test_loader, sample_dir=sample_dir)
    with open(out_dir / bench_cfg.get("results_file",
                                      "benchmark_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("Benchmark:", json.dumps(results, indent=2))
    if model.device.type == "cuda":
        after = launch_counts()
        print(f"Benchmark kernel launches: "
              f"{json.dumps({k: after[k] - before.get(k, 0) for k in after})}",
              flush=True)
    return results


def check_layout(config, num_devices: int) -> None:
    """The config's ``distributed`` layout over ``num_devices`` devices
    (``parallel/mesh.py::make_layout``); exits on a refusal."""
    dist_cfg = config.get("distributed", {}) or {}
    try:
        mesh.make_layout(num_devices,
                         model_parallel=int(dist_cfg.get("model_parallel", 1)),
                         spatial_parallel=int(
                             dist_cfg.get("spatial_parallel", 1)))
    except ValueError as e:
        raise SystemExit(f"distributed: {e}") from None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..models.base import resolve_device
    from ..utils.config import load_config, resolve_interpolations

    config = resolve_interpolations(load_config(args.config))
    device = resolve_device(args.device)
    if args.multihost:
        # As in the reference: histograms only in a single-process run.
        config["logging"] = dict(config.get("logging") or {},
                                 track_histograms=False)
        device = mesh.init_from_env(device.type)
        try:
            check_layout(config, mesh.world_size())
            return run(args, config, device)
        finally:
            mesh.shutdown()
    n = len(mesh.local_devices(args.num_devices, device.type))
    check_layout(config, n)
    if n == 1:
        return run(args, config, device)
    batch = int(config.get("training", {}).get("batch_size", 128))
    if batch % n:
        raise SystemExit(f"training.batch_size {batch} is not a multiple of "
                         f"--num_devices {n}: each rank takes B/N rows")
    if device.type == "cuda":
        from ..ops._build import build_all
        build_all()
    out_dir = Path(config.get("output", {}).get("output_dir", "outputs"))
    out_dir.mkdir(parents=True, exist_ok=True)
    return mesh.spawn(_run_rank, n, args=(args, config),
                      device_type=device.type, rendezvous_dir=str(out_dir))


def _run_rank(device, args, config) -> int:
    return run(args, config, device, split=(mesh.rank(), mesh.world_size()))


def run(args, config, device, split=None) -> int:
    """Train (or evaluate) as ``main`` describes, on ``device``: in this
    process alone, or as a rank of the process group this process has
    joined, with ``split`` (rank, N) under ``--num_devices`` and the
    data's host shard under ``--multihost``."""
    from ..datasets import get_dataset
    from ..models import MODEL_REGISTRY
    from ..trainers import TRAINER_REGISTRY
    from ..utils.config import print_config

    main_rank = mesh.is_main_process()
    world = mesh.world_size()
    if main_rank:
        print_config("Main Configuration", config)
    model = MODEL_REGISTRY[args.model_type](
        config.get("model_config", {}), device=device, seed=args.seed,
        trainable=True)
    if split is not None:
        loaders = get_dataset(config, device=model.device, split=split)
    else:
        loaders = get_dataset(config, world, mesh.rank(), device=model.device)
    train_loader, val_loader, test_loader = loaders
    trainer = TRAINER_REGISTRY[args.model_type](
        model, train_loader, val_loader, test_loader, config,
        seed=args.seed)
    if trainer.data_parallel and main_rank:
        batch = int(config.get("training", {}).get("batch_size", 128))
        local = batch // world if split is not None else batch
        print(f"Data parallel: {world} ranks over {mesh.backend()}, global "
              f"batch {local * world} ({local} a rank)", flush=True)

    start_epoch = 0
    if args.resume:
        name = None if args.resume == "latest" else args.resume
        start_epoch = trainer.load_checkpoint(name)
        digests = mesh.gather(params_digest(trainer.params))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks restored different parameters: "
                               f"{digests}")
        if main_rank:
            print(f"Resumed from epoch {start_epoch} at step "
                  f"{trainer.step_count} (params sha256 {digests[0]})",
                  flush=True)
    try:
        if args.profile is not None and not args.eval_only:
            path = trainer.profile(
                steps=args.profile_steps,
                log_dir=(None if args.profile == "__default__"
                         else args.profile))
            if main_rank:
                print(f"Profiler trace written to {path}", flush=True)
        if args.eval_only:
            loss = trainer.test()
            if main_rank:
                print(f"Test loss: {loss:.6f}")
        else:
            num_epochs = int(config.get("training", {}).get("num_epochs", 1))
            trainer.train(num_epochs - start_epoch)
            if trainer.preempted:
                if main_rank:
                    print("Preempted: checkpoint saved, exiting")
                return 143
            loss = trainer.test()
            if main_rank:
                print(f"Final test loss: {loss:.6f}")
            trainer.save_checkpoint("final_model", num_epochs - 1)
        if args.benchmark and main_rank:
            if split is not None:   # the whole test set, as one device has
                test_loader = get_dataset(config, device=model.device)[2]
            run_benchmark(trainer, config, test_loader, args.eval_only)
    finally:
        trainer.cleanup()
    if model.device.type == "cuda":
        who = f" (rank {mesh.rank()} of {world})" if trainer.data_parallel \
            else ""
        print(f"Kernel launches{who}: {json.dumps(launch_counts())}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
