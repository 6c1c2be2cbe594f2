"""Metric logging (counterpart of the reference's
``utils/logging_utils.py::MetricLogger``).

Sinks: an always-on ``metrics.jsonl`` in the run directory, and wandb and
TensorBoard when ``logging.use_wandb`` / ``use_tensorboard`` ask for them
and the packages import (a missing package prints a line and is skipped,
as in the reference). Helpers turn gradient norms, the Adam state, the
noise schedule and step times into flat metric dicts.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return v


class MetricLogger:
    """Routes metric dicts to wandb / TensorBoard / JSONL."""

    def __init__(self, config: Dict[str, Any], model_name: str = "model",
                 output_dir: str = "outputs"):
        self.config = config or {}
        log_cfg = self.config.get("logging", {}) or {}
        self.log_cfg = log_cfg
        self.model_name = model_name
        self.output_dir = Path(output_dir)
        self._wandb = None
        self._tb = None
        self.output_dir.mkdir(parents=True, exist_ok=True)
        run_name = f"{model_name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        if log_cfg.get("use_wandb", False):
            try:
                import wandb
                self._wandb = wandb.init(
                    project=log_cfg.get("wandb_project", "diffusion-models"),
                    entity=log_cfg.get("wandb_entity"),
                    group=log_cfg.get("group"), tags=log_cfg.get("tags"),
                    notes=log_cfg.get("notes"), name=run_name,
                    config=self.config)
            except Exception as e:  # wandb missing or offline
                print(f"[logging] wandb unavailable ({e}); continuing without")
        if log_cfg.get("use_tensorboard", False):
            try:
                from torch.utils.tensorboard import SummaryWriter
                tb_dir = Path(log_cfg.get("tensorboard_dir", "logs")) / run_name
                self._tb = SummaryWriter(str(tb_dir))
            except Exception as e:
                print(f"[logging] tensorboard unavailable ({e})")
        self._jsonl = open(self.output_dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        """Write a flat metric dict to every sink; an array of more than
        one value goes in as a histogram (mean and std in the JSONL)."""
        scalars = {}
        for k, v in metrics.items():
            v = _to_host(v)
            if isinstance(v, np.ndarray) and v.size > 1:
                scalars[f"{k}/mean"] = float(v.mean())
                scalars[f"{k}/std"] = float(v.std())
                if self._tb is not None:
                    self._tb.add_histogram(k, v, step)
                if self._wandb is not None:
                    import wandb
                    self._wandb.log({k: wandb.Histogram(v)}, step=step)
            else:
                scalars[k] = float(v)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(image)}, step=step)
        if self._tb is not None:
            chw = image.transpose(2, 0, 1) if image.ndim == 3 else image
            self._tb.add_image(tag, chw, step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        if self._tb is None:
            return
        flat = {k: v for k, v in hparams.items()
                if isinstance(v, (int, float, str, bool))}
        try:
            self._tb.add_hparams(flat, {})
        except Exception:
            pass

    # -- derived metric helpers ------------------------------------------
    def gradient_metrics(self, layer_grad_norms: Optional[Dict[str, Any]],
                         global_grad_norm, global_param_norm
                         ) -> Dict[str, Any]:
        """Global grad/weight norms, and the per-layer grad norms when
        ``logging.track_per_layer_metrics`` is on."""
        out: Dict[str, Any] = {
            "gradients/global_norm": float(global_grad_norm),
            "weights/global_norm": float(global_param_norm),
        }
        if (self.log_cfg.get("track_per_layer_metrics", False)
                and layer_grad_norms is not None):
            for name, v in layer_grad_norms.items():
                out[f"gradients/{name.replace('.', '/')}_norm"] = float(v)
        return out

    def optimizer_metrics(self, optimizer, lr: float) -> Dict[str, Any]:
        """Adam moment means and the LR."""
        out: Dict[str, Any] = {"optimizer/learning_rate": float(lr)}
        for key, moments in (("exp_avg_mean", optimizer.mu),
                             ("exp_avg_sq_mean", optimizer.nu)):
            total = torch.stack([m.sum() for m in moments]).sum()
            count = sum(m.numel() for m in moments)
            out[f"optimizer/{key}"] = float(total) / max(count, 1)
        return out

    def diffusion_metrics(self, schedule) -> Dict[str, Any]:
        """β/α/ᾱ of the noise schedule (as histograms)."""
        return {"diffusion/beta": schedule.betas,
                "diffusion/alpha": schedule.alphas,
                "diffusion/alpha_cumprod": schedule.alphas_cumprod}

    def performance_metrics(self, batch_time: float, batch_size: int,
                            device: Optional[torch.device] = None
                            ) -> Dict[str, Any]:
        """Step time and throughput; the card's allocated and peak bytes
        when ``logging.track_gpu_stats`` is on."""
        out = {"performance/batch_time": batch_time,
               "performance/samples_per_second":
                   batch_size / max(batch_time, 1e-9),
               "performance/steps_per_second": 1.0 / max(batch_time, 1e-9)}
        if (self.log_cfg.get("track_gpu_stats", False) and device is not None
                and device.type == "cuda"):
            out["performance/device_bytes_in_use"] = \
                torch.cuda.memory_allocated(device)
            out["performance/device_peak_bytes"] = \
                torch.cuda.max_memory_allocated(device)
        return out

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
