"""Training CLI of the port (counterpart of the reference's
``scripts/train.py``).

    python -m diffusion_model_universal_torch.scripts.train \
        --config diffusion_model_universal_torch/configs/ddpm_config.yaml \
        --model_type ddpm|ddim|score_based|energy_based \
        [--resume latest|NAME] [--eval_only] [--benchmark] [--seed N] \
        [--device cuda|cpu]

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

On the card the run ends by printing each kernel's launches in the run
(``Kernel launches``), after those of the benchmark alone
(``Benchmark kernel launches``). ``--profile``, ``--multihost`` and
``--num_devices > 1`` are not ported yet and exit.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
from pathlib import Path

from .. import NOT_PORTED
from ..ops._build import launch_counts
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


def check_ported(args) -> None:
    """Raise SystemExit for options this package does not run yet."""
    for flag, on in (("--multihost", args.multihost),
                     ("--profile", args.profile is not None),
                     ("--num_devices > 1",
                      args.num_devices is not None and args.num_devices > 1)):
        if on:
            raise SystemExit(f"{flag} is {NOT_PORTED}")


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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_ported(args)

    from ..datasets import get_dataset
    from ..models import MODEL_REGISTRY
    from ..trainers import TRAINER_REGISTRY
    from ..utils.config import (load_config, print_config,
                                resolve_interpolations)

    config = resolve_interpolations(load_config(args.config))
    print_config("Main Configuration", config)
    model = MODEL_REGISTRY[args.model_type](
        config.get("model_config", {}), device=args.device, seed=args.seed,
        trainable=True)
    train_loader, val_loader, test_loader = get_dataset(
        config, device=model.device)
    trainer = TRAINER_REGISTRY[args.model_type](
        model, train_loader, val_loader, test_loader, config,
        seed=args.seed)

    start_epoch = 0
    if args.resume:
        name = None if args.resume == "latest" else args.resume
        start_epoch = trainer.load_checkpoint(name)
        print(f"Resumed from epoch {start_epoch} at step "
              f"{trainer.step_count} (params sha256 "
              f"{params_digest(trainer.params)})", flush=True)
    try:
        if args.eval_only:
            print(f"Test loss: {trainer.test():.6f}")
        else:
            num_epochs = int(config.get("training", {}).get("num_epochs", 1))
            trainer.train(num_epochs - start_epoch)
            if trainer.preempted:
                print("Preempted: checkpoint saved, exiting")
                return 143
            print(f"Final test loss: {trainer.test():.6f}")
            trainer.save_checkpoint("final_model", num_epochs - 1)
        if args.benchmark:
            run_benchmark(trainer, config, test_loader, args.eval_only)
    finally:
        trainer.cleanup()
    if model.device.type == "cuda":
        print(f"Kernel launches: {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
