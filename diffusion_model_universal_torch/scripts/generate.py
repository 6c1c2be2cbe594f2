"""Sample-generation CLI of the port (counterpart of the reference's
``scripts/generate.py``).

    python -m diffusion_model_universal_torch.scripts.generate \
        --config diffusion_model_universal_torch/configs/ddim_config.yaml \
        --model_type ddpm|ddim|score_based|energy_based \
        --checkpoint path/to/model.ckpt \
        [--num_samples N] [--output_dir D] [--device cuda|cpu] \
        [--sampler default|dpm++|heun|strided --sampler_steps S] \
        [--class_id K --guidance_scale G] \
        [--inpaint_image IMG.npy --inpaint_mask MASK.npy] \
        [--num_devices N]

Runs on ``cuda`` unless ``--device cpu`` is given. ``--num_devices N``
samples over the first N devices (all of them when N exceeds the count;
on the CPU, N gloo processes): N ranks (``parallel/mesh.py::spawn``)
each draw every chunk's noise for the whole chunk and sample their rows
of it, and rank 0 gathers the images in order and writes them, so the
images are one process's. The score-based and
energy-based families sample with their own sampler only: ``--class_id``,
``--inpaint_image`` and the fast samplers (which need an ε-prediction
model) are refused for them, as the reference refuses them. Reads the model-only
checkpoint that either package writes, or a trainer checkpoint directory
of the port (``--ema`` picks its EMA weights). A request whose estimated
footprint exceeds the card's budget is drawn in equal chunks, each from
its own generator, or refused (``utils/memory.py``; a chunk a multiple
of N, each device holding its rows); the CPU has no budget unless
``DMU_SAMPLER_HBM_BYTES`` sets one.
"""

from __future__ import annotations

import argparse
import json
import math
import pickle
import sys
from pathlib import Path

from ..parallel import mesh

MODEL_TYPES = ("ddpm", "ddim", "score_based", "energy_based")
#: The fast samplers, by the name a request or ``--sampler`` gives, and
#: the model method that runs each.
FAST_SAMPLERS = {"dpm++": "generate_samples_dpm",
                 "heun": "generate_samples_heun",
                 "strided": "generate_samples_strided"}


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
                   choices=["default", *FAST_SAMPLERS],
                   help="'default' = the model family's own sampler; "
                        "'dpm++' = DPM-Solver++(2M) (one model eval a "
                        "step); 'heun' = Karras-spaced Heun (two evals an "
                        "update); 'strided' = respaced stochastic "
                        "ancestral (the fast path for learn_sigma models)")
    p.add_argument("--sampler_steps", type=int, default=20,
                   help="Grid size for --sampler dpm++/heun/strided")
    p.add_argument("--class_id", type=int, default=None,
                   help="Class label for conditional checkpoints "
                        "(model_config.num_classes > 0)")
    p.add_argument("--guidance_scale", type=float, default=3.0,
                   help="Classifier-free guidance scale for --class_id "
                        "(1.0 = plain conditional)")
    p.add_argument("--grid_only", action="store_true",
                   help="Skip per-sample PNGs, save only the grid")
    p.add_argument("--inpaint_image", type=str, default=None,
                   help=".npy conditioning image(s), [H,W,C] or [B,H,W,C] "
                        "in [-1, 1]; regenerates the region where "
                        "--inpaint_mask is 0 (ancestral sampler)")
    p.add_argument("--inpaint_mask", type=str, default=None,
                   help=".npy mask broadcastable to the image; 1 = keep, "
                        "0 = generate (required with --inpaint_image)")
    return p


def _check_inpaint_args(args) -> None:
    if args.inpaint_mask is None:
        raise SystemExit("--inpaint_image requires --inpaint_mask")
    if args.sampler != "default":
        raise SystemExit("--inpaint_image uses the ancestral sampler; "
                         "drop --sampler")


def check_args(args) -> None:
    """The refusals of ``--inpaint_image`` that need no model, in the
    order ``draw`` makes them (``main`` makes them before it starts any
    rank)."""
    if args.inpaint_image is not None:
        if args.model_type not in ("ddpm", "ddim"):
            raise SystemExit(f"--inpaint_image unsupported for "
                             f"{args.model_type} models (ddpm/ddim only)")
        _check_inpaint_args(args)


def _load_inpaint_inputs(args, model):
    """Load and check --inpaint_image/--inpaint_mask into [N,H,W,C] and a
    mask that broadcasts to it (numpy f32)."""
    import numpy as np
    _check_inpaint_args(args)
    image = np.load(args.inpaint_image).astype(np.float32)
    mask = np.load(args.inpaint_mask).astype(np.float32)
    if image.ndim == 3:
        image = image[None]
    want = model.sample_shape(1)[1:]
    if image.shape[1:] != tuple(want):
        raise SystemExit(f"--inpaint_image shape {image.shape[1:]} != "
                         f"model sample shape {tuple(want)}")
    if image.shape[0] == 1 and args.num_samples > 1:
        image = np.tile(image, (args.num_samples, 1, 1, 1))
    if image.shape[0] != args.num_samples:
        raise SystemExit(f"--inpaint_image batch {image.shape[0]} != "
                         f"--num_samples {args.num_samples}")
    if mask.ndim == 2:
        mask = mask[None, :, :, None]
    elif mask.ndim == 3:
        mask = mask[None]
    try:
        np.broadcast_shapes(mask.shape, image.shape)
    except ValueError:
        raise SystemExit(f"--inpaint_mask shape {mask.shape} does not "
                         f"broadcast to image shape {image.shape}")
    return image, mask


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


def plan_chunks(num_samples: int, model, model_cfg: dict,
                n_devices: int):
    """``(chunk, n_chunks)`` for a request of ``num_samples`` on
    ``model``'s device, split over ``n_devices`` ranks, from the memory
    preflight (``utils/memory.py``); exits with the planner's message when
    even one sample a device does not fit."""
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
            n_devices=n_devices,
            budget_bytes=device_memory_budget(model.device))
    except SamplerMemoryError as e:
        raise SystemExit(f"--num_samples {num_samples}: {e}")


def rank_samples(sample, rows, model):
    """``sample(rows)`` as host f32 numpy, for this rank's ``rows`` of a
    batch: an empty array when the rank has none (it still joins the
    gather)."""
    import numpy as np
    lo, hi, _ = rows
    if lo == hi:
        return np.zeros(model.sample_shape(0), np.float32)
    return sample(rows).float().cpu().numpy()


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..models.base import resolve_device

    device = resolve_device(args.device)
    n = len(mesh.local_devices(args.num_devices, device.type))
    if n == 1:
        return run(args, device)
    check_args(args)
    if device.type == "cuda":
        from ..ops._build import build_all
        build_all()
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    return mesh.spawn(run_rank, n, args=(args,), device_type=device.type,
                      rendezvous_dir=str(out))


def run_rank(device, args) -> int:
    """One rank of ``--num_devices N`` (``mesh.spawn``'s target)."""
    return run(args, device)


def run(args, device) -> int:
    """Sample as ``main`` describes on ``device``, alone or as a rank of
    the group this process has joined; rank 0 writes the images."""
    samples = draw(args, device)
    if samples is None:
        return 0
    from ..utils.images import save_image
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not args.grid_only:
        for i in range(len(samples)):
            save_image(samples[i], str(out / f"sample_{i:04d}.png"))
    nrow = int(math.ceil(math.sqrt(args.num_samples)))
    grid_path = save_image(samples, str(out / "samples_grid.png"), nrow=nrow)
    print(f"Saved {len(samples)} samples to {out} (grid: {grid_path})")
    return 0


def draw(args, device):
    """The request's samples, [num_samples, H, W, C] f32 numpy on rank 0
    (None on the other ranks): every chunk sampled with its own seed,
    each rank its rows of it (``mesh.sampling_scope``)."""
    import numpy as np
    import torch

    from ..models import MODEL_REGISTRY
    from ..utils.config import load_config, resolve_interpolations

    scope = mesh.sampling_scope()
    config = resolve_interpolations(load_config(args.config))
    model_cfg = resolve_model_config(config, args.checkpoint)
    model = MODEL_REGISTRY[args.model_type](model_cfg, device=device)
    load_params(model, args.checkpoint, args.ema)

    conditional = args.class_id is not None
    if conditional:
        if not hasattr(model, "make_class_labels"):
            raise SystemExit(f"--class_id unsupported for "
                             f"{args.model_type} models")
        try:
            model.make_class_labels(args.class_id, 1)
        except ValueError as e:
            raise SystemExit(f"--class_id: {e}")
    inpaint = None
    if args.inpaint_image is not None:
        if not hasattr(model, "generate_samples_inpaint"):
            raise SystemExit(f"--inpaint_image unsupported for "
                             f"{args.model_type} models (ddpm/ddim only)")
        inpaint = _load_inpaint_inputs(args, model)
    if args.sampler != "default" and not hasattr(
            model, FAST_SAMPLERS[args.sampler]):
        raise SystemExit(f"--sampler {args.sampler} needs an ε-prediction "
                         f"model (ddpm/ddim), got {args.model_type}")
    scale = args.guidance_scale if conditional else 1.0

    def sample_chunk(start: int, n: int, gen: torch.Generator, rows):
        """One sampler call for ``rows`` of samples [start, start + n),
        with this chunk's labels and inpainting inputs."""
        labels = (model.make_class_labels(args.class_id, n) if conditional
                  else None)
        if inpaint is not None:
            image, mask = inpaint
            mask = mask[start:start + n] if mask.shape[0] > 1 else mask
            return model.generate_samples_inpaint(
                torch.from_numpy(image[start:start + n]),
                torch.from_numpy(mask), labels=labels, guidance_scale=scale,
                generator=gen, rows=rows)
        if args.sampler != "default":
            try:
                return getattr(model, FAST_SAMPLERS[args.sampler])(
                    n, num_steps=args.sampler_steps, labels=labels,
                    guidance_scale=scale, generator=gen, rows=rows)
            except ValueError as e:  # --sampler_steps out of [2, T]
                raise SystemExit(f"--sampler {args.sampler}: {e}")
        if labels is not None:
            return model.generate_samples_cfg(
                n, labels, guidance_scale=args.guidance_scale, generator=gen,
                rows=rows)
        return model.generate_samples(n, generator=gen, rows=rows)

    chunk, n_chunks = plan_chunks(args.num_samples, model, model_cfg,
                                  scope.world)
    if n_chunks > 1 and scope.rank == 0:
        print(f"Memory preflight: {args.num_samples} samples split into "
              f"{n_chunks} chunks of {chunk} (estimated footprint exceeds "
              f"the device budget; set DMU_SAMPLER_HBM_BYTES to override)",
              flush=True)
    parts = []
    for ci in range(n_chunks):
        start = ci * chunk
        n = min(chunk, args.num_samples - start)
        gen = torch.Generator(device=model.device).manual_seed(
            args.seed if n_chunks == 1 else chunk_seed(args.seed, ci))
        mine = rank_samples(lambda rows: sample_chunk(start, n, gen, rows),
                            scope.rows(n), model)
        gathered = scope.gather(mine)
        if gathered is not None:
            parts.extend(gathered)
    return np.concatenate(parts) if scope.rank == 0 else None


if __name__ == "__main__":
    sys.exit(main())
