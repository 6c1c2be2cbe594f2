"""Training CLI of the port (counterpart of the reference's
``scripts/train.py``).

    python -m diffusion_model_universal_torch.scripts.train \
        --config diffusion_model_universal_torch/configs/ddpm_config.yaml \
        --model_type ddpm|ddim|score_based|energy_based \
        [--resume latest|NAME] [--eval_only] [--seed N] \
        [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without
CUDA otherwise. Trains, then reports the test loss and saves
``final_model``; ``--eval_only`` reports the test loss only. On the card
it ends by printing each kernel's launches in the run. A SIGTERM
saves a resumable checkpoint and exits with 143. ``--benchmark``,
``--profile``, ``--multihost`` and ``--num_devices > 1`` are not ported
yet and exit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

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
    for flag, on in (("--benchmark", args.benchmark),
                     ("--multihost", args.multihost),
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
    finally:
        trainer.cleanup()
    if model.device.type == "cuda":
        print(f"Kernel launches: {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
