"""Sample-generation CLI of the port (counterpart of the reference's
``scripts/generate.py``, the ancestral-sampler slice).

    python -m diffusion_model_universal_torch.scripts.generate \
        --config diffusion_model_universal_torch/configs/ddpm_config.yaml \
        --model_type ddpm --checkpoint path/to/model.ckpt \
        [--num_samples N] [--output_dir D] [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given. Reads the model-only
checkpoint that either package writes, or a trainer checkpoint directory
of the port (``--ema`` picks its EMA weights). A request whose estimated
footprint exceeds the card's budget is drawn in equal chunks, each from
its own generator, or refused (``utils/memory.py``); the CPU has no
budget unless ``DMU_SAMPLER_HBM_BYTES`` sets one.
"""

from __future__ import annotations

import argparse
import json
import math
import pickle
import sys
from pathlib import Path

from .. import NOT_PORTED

MODEL_TYPES = ("ddpm", "ddim", "score_based", "energy_based")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate samples (PyTorch)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_type", type=str, required=True,
                   choices=MODEL_TYPES)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Model-only .ckpt file, or a trainer checkpoint "
                        "directory of the torch package")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--output_dir", type=str, default="generated_samples")
    p.add_argument("--ema", action="store_true",
                   help="Sample from EMA params (trainer checkpoints only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--sampler", type=str, default="default",
                   choices=["default", "dpm++", "heun", "strided"])
    p.add_argument("--sampler_steps", type=int, default=20)
    p.add_argument("--class_id", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--grid_only", action="store_true",
                   help="Skip per-sample PNGs, save only the grid")
    p.add_argument("--inpaint_image", type=str, default=None)
    p.add_argument("--inpaint_mask", type=str, default=None)
    return p


def resolve_model_config(config: dict, checkpoint: str) -> dict:
    """YAML model_config with the checkpoint's embedded config overlaid,
    so architecture keys the YAML does not mention cannot mismatch the
    saved weights (a trainer checkpoint's ``config.json`` sits beside its
    directory). Shared by the generate CLI and the HTTP server."""
    model_cfg = dict(config.get("model_config", config.get("model", {})))
    p = Path(checkpoint)
    sidecar = p.parent / "config.json"
    if p.is_dir() and sidecar.is_file():
        with open(sidecar) as f:
            model_cfg.update(json.load(f).get("model_config") or {})
    if p.is_file():
        try:
            with open(p, "rb") as f:
                ckpt_cfg = pickle.load(f).get("config") or {}
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError):
            ckpt_cfg = {}
        model_cfg.update(ckpt_cfg)
    return model_cfg


def load_params(model, path: str, use_ema: bool) -> None:
    """Load weights into ``model``: a model-only checkpoint file, or a
    trainer checkpoint directory of the port (its EMA weights with
    ``use_ema``). A JAX Orbax directory raises."""
    if not Path(path).is_dir():
        model.load(path)
        return
    from ..utils.checkpoint import read_state
    state = read_state(path)
    weights = state["ema_params" if use_ema else "params"]
    model.net.load_state_dict(weights, strict=True)


def chunk_seed(seed: int, index: int) -> int:
    """Seed of chunk ``index``'s generator when a request is split into
    chunks: a fixed mix of ``seed`` and ``index`` (the counterpart of the
    reference's ``jax.random.fold_in(key, index)``)."""
    return (seed * 0x9E3779B97F4A7C15 + index + 1) % (1 << 63)


def plan_chunks(num_samples: int, model, model_cfg: dict):
    """``(chunk, n_chunks)`` for a request of ``num_samples`` on
    ``model``'s device, from the memory preflight
    (``utils/memory.py``); exits with the planner's message when even one
    sample does not fit."""
    from ..utils.memory import (SamplerMemoryError, device_memory_budget,
                                plan_sampler_chunks)
    try:
        return plan_sampler_chunks(
            num_samples,
            image_size=int(model_cfg.get("image_size", 32)),
            model_channels=int(model_cfg.get("model_channels", 64)),
            in_channels=int(model_cfg.get("in_channels", 3)),
            dtype_bytes=model.compute_dtype.itemsize,
            params_bytes=sum(p.numel() * p.element_size()
                             for p in model.net.parameters()),
            budget_bytes=device_memory_budget(model.device))
    except SamplerMemoryError as e:
        raise SystemExit(f"--num_samples {num_samples}: {e}")


def check_ported(args) -> None:
    """Raise SystemExit for options this package does not run yet."""
    if args.model_type != "ddpm":
        raise SystemExit(f"--model_type {args.model_type} is {NOT_PORTED}")
    if args.num_devices is not None and args.num_devices > 1:
        raise SystemExit(f"--num_devices > 1 is {NOT_PORTED}")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_ported(args)
    if args.sampler != "default":
        raise SystemExit(f"--sampler {args.sampler} is {NOT_PORTED}")
    if args.class_id is not None:
        raise SystemExit(f"--class_id (classifier-free guidance) is "
                         f"{NOT_PORTED}")
    if args.inpaint_image is not None:
        raise SystemExit(f"--inpaint_image is {NOT_PORTED}")

    import torch

    from ..models import MODEL_REGISTRY
    from ..utils.config import load_config, resolve_interpolations
    from ..utils.images import save_image

    config = resolve_interpolations(load_config(args.config))
    model_cfg = resolve_model_config(config, args.checkpoint)
    model = MODEL_REGISTRY[args.model_type](model_cfg, device=args.device)
    load_params(model, args.checkpoint, args.ema)

    chunk, n_chunks = plan_chunks(args.num_samples, model, model_cfg)
    if n_chunks == 1:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        samples = model.generate_samples(args.num_samples,
                                         generator=gen).cpu().numpy()
    else:
        print(f"Memory preflight: {args.num_samples} samples split into "
              f"{n_chunks} chunks of {chunk} (estimated footprint exceeds "
              f"the device budget; set DMU_SAMPLER_HBM_BYTES to override)",
              flush=True)
        parts = []
        for ci in range(n_chunks):
            n = min(chunk, args.num_samples - ci * chunk)
            gen = torch.Generator(device=model.device).manual_seed(
                chunk_seed(args.seed, ci))
            parts.append(model.generate_samples(n, generator=gen).cpu())
        samples = torch.cat(parts).numpy()
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not args.grid_only:
        for i in range(len(samples)):
            save_image(samples[i], str(out / f"sample_{i:04d}.png"))
    nrow = int(math.ceil(math.sqrt(args.num_samples)))
    grid_path = save_image(samples, str(out / "samples_grid.png"), nrow=nrow)
    print(f"Saved {len(samples)} samples to {out} (grid: {grid_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
