"""The training engine of the port (counterpart of the reference's
``trainers/trainer.py``).

One training step is: the loss of a batch (its draws, such as t and ε,
from a generator seeded by (seed, step), so a resumed run draws what an
unbroken one would), its gradients by autograd (through the GroupNorm and attention
Functions, so kernels K1/K2/K3 on the card), the global and per-layer
gradient norms, one Adam update (``trainers/optim.py``), and the EMA
update with warmup, d = min(decay, (1+t)/(10+t)). The step stays on the
device; the host reads a metric only at the logging cadence and the
epoch's mean loss at its end.

Around it, as in the reference: the single-step ``train`` loop with
validation every ``val_interval`` steps and a best-model save, sample
grids every ``sample_interval`` epochs, checkpoints every
``checkpoint_interval`` epochs (pruned to ``keep_checkpoints``), an
emergency checkpoint on an exception, SIGTERM preemption (save, then
return), masked per-sample ``validate``/``test``, and full-state
``save_checkpoint``/``load_checkpoint`` (``utils/checkpoint.py``).

Not ported yet (they raise): ``scan_steps > 1``, ``grad_accum_steps > 1``,
``ema_dtype`` other than float32, ``logging.track_histograms``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import NOT_PORTED
from ..utils.checkpoint import CheckpointManager
from ..utils.images import frames_to_grid, save_image
from ..utils.logging_utils import MetricLogger
from .optim import make_optimizer

_SEED_STRIDE = 1_000_003


class DiffusionTrainer:
    """Engine shared by the model families.

    Args:
        model: a model built with ``trainable=True``.
        train_loader, val_loader, test_loader: loaders whose batches are
            NHWC tensors (or ``{"image", "label"}`` dicts) on the model's
            device.
        config: the full run config.
        seed: seeds the per-step draws, dropout and the sample grids.
    """

    def __init__(self, model, train_loader, val_loader, test_loader,
                 config: Dict[str, Any], seed: int = 0):
        if not getattr(model, "trainable", False):
            raise ValueError("the trainer needs a model built with "
                             "trainable=True (f32 master weights)")
        self.model = model
        self.device = model.device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.config = config or {}
        tcfg = self.training_cfg = self.config.get("training", {}) or {}
        log_cfg = self.config.get("logging", {}) or {}
        self.seed = seed
        for key in ("scan_steps", "grad_accum_steps"):
            if int(tcfg.get(key, 1)) > 1:
                raise ValueError(f"training.{key} > 1 is {NOT_PORTED}")
        if str(tcfg.get("ema_dtype", "float32")) != "float32":
            raise ValueError(f"training.ema_dtype other than float32 is "
                             f"{NOT_PORTED}")
        if log_cfg.get("track_histograms", False):
            raise ValueError(f"logging.track_histograms is {NOT_PORTED}")

        self.num_epochs = int(tcfg.get("num_epochs", 1))
        self.val_interval = int(tcfg.get("val_interval", 1000))
        self.sample_interval = int(tcfg.get("sample_interval", 5))
        self.checkpoint_interval = int(tcfg.get("checkpoint_interval", 10))
        self.keep_checkpoints = int(tcfg.get("keep_checkpoints", 0))
        self.ema_decay = float(tcfg.get("ema_decay", 0.9999))
        self.ema_warmup = bool(tcfg.get("ema_warmup", True))
        self.handle_preemption = bool(tcfg.get("handle_preemption", True))
        self.preempted = False
        self.log_interval = int(log_cfg.get("log_interval", 1))
        self.gradient_logging_freq = int(
            log_cfg.get("gradient_logging_freq", 100))
        self.track_time = bool(log_cfg.get("track_time_metrics", False))
        self.steps_per_epoch = max(len(train_loader), 1)

        torch.manual_seed(seed)  # dropout masks
        named = list(model.net.named_parameters())
        self.param_names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.optimizer, self.lr_schedule = make_optimizer(
            self.params, tcfg, self.steps_per_epoch, self.num_epochs)
        self.ema = [p.detach().clone().float() for p in self.params]
        self.step_count = 0
        self._gen = torch.Generator(device=self.device)

        output_cfg = self.config.get("output", {}) or {}
        self.output_dir = Path(output_cfg.get("output_dir",
                                              "outputs/run")).absolute()
        self.logger = MetricLogger(self.config,
                                   model_name=self.config.get("model_name",
                                                              "model"),
                                   output_dir=str(self.output_dir))
        self.ckpt = CheckpointManager(str(self.output_dir / "checkpoints"),
                                      config=self.config)
        self.best_val_loss = float("inf")
        self.start_epoch = 0
        self.logger.log_hparams({
            "learning_rate": tcfg.get("learning_rate", 0.0),
            "batch_size": tcfg.get("batch_size", 0),
            "num_epochs": self.num_epochs,
            "param_count": sum(p.numel() for p in self.params)})
        if hasattr(model, "schedule"):   # the score family has none
            self.logger.log(self.logger.diffusion_metrics(model.schedule),
                            0)

    # ------------------------------------------------------------------
    def _generator(self, step: int, salt: int = 0) -> torch.Generator:
        """The generator of the draws of one step (or one eval batch)."""
        return self._gen.manual_seed(
            ((self.seed + 17 * salt) * _SEED_STRIDE + step) & (2 ** 63 - 1))

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, dict):
            return batch["image"], batch.get("label")
        return batch, None

    @staticmethod
    def _batch_count(batch) -> int:
        return DiffusionTrainer._split_batch(batch)[0].shape[0]

    def step(self, batch, **draws) -> Dict[str, Any]:
        """One training step; the loss's draws may be injected as keywords
        of the family's ``loss_function`` (tests): ``t``/``noise``
        (DDPM, DDIM), ``sigma``/``noise`` (score), ``t``/``noise``/
        ``langevin_noise``/``alpha`` (energy). Returns device tensors:
        ``loss``, ``grad_norm`` and ``layer_grad_norms`` (name → norm),
        all of the raw gradients."""
        x, y = self._split_batch(batch)
        loss = self.model.loss_function(
            x, generator=self._generator(self.step_count), y=y, **draws)
        # A parameter the loss does not reach (the energy DSM objective
        # differentiates ∇ₓE, to which the last bias adds nothing) gets a
        # zero gradient, as the reference's does.
        grads = list(torch.autograd.grad(loss, self.params, allow_unused=True,
                                         materialize_grads=True))
        norms = torch._foreach_norm(grads)
        grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        self.optimizer.step(grads, grad_norm)
        self._update_ema()
        self.step_count += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "layer_grad_norms": dict(zip(self.param_names, norms))}

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        if self.ema_warmup:
            # t counts completed updates: the first uses d = 1/10.
            t = float(self.step_count)
            d = min(d, (1.0 + t) / (10.0 + t))
        torch._foreach_mul_(self.ema, d)
        torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)

    def param_norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([p.detach() for p in self.params])))

    # ------------------------------------------------------------------
    def _on_preempt_signal(self, signum, frame) -> None:
        self.preempted = True

    def _install_preemption_handler(self):
        if not self.handle_preemption:
            return None
        import signal
        try:
            return signal.signal(signal.SIGTERM, self._on_preempt_signal)
        except ValueError:  # not in the main thread
            return None

    def _log_step(self, step: int, epoch: int, metrics, batch,
                  t0: float) -> None:
        loss = float(metrics["loss"])
        log = {"train/loss": loss,
               "train/grad_norm": float(metrics["grad_norm"]),
               "train/learning_rate": float(self.lr_schedule(step)),
               "train/epoch": epoch + (step % self.steps_per_epoch)
               / self.steps_per_epoch}
        if self.track_time:
            log.update(self.logger.performance_metrics(
                time.perf_counter() - t0, self._batch_count(batch),
                self.device))
        if step % self.gradient_logging_freq == 0:
            log.update(self.logger.gradient_metrics(
                metrics["layer_grad_norms"], metrics["grad_norm"],
                self.param_norm()))
            log.update(self.logger.optimizer_metrics(
                self.optimizer, self.lr_schedule(step)))
        self.logger.log(log, step)

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        """Run the training loop for ``num_epochs`` epochs from
        ``start_epoch``; returns the last epoch's mean loss."""
        num_epochs = num_epochs if num_epochs is not None else self.num_epochs
        history: Dict[str, float] = {}
        self.preempted = False
        prev_handler = self._install_preemption_handler()
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch,
                               self.start_epoch + num_epochs):
                self.train_loader.set_epoch(epoch)
                epoch_losses = []
                t_epoch = time.perf_counter()
                for batch in self.train_loader:
                    t0 = time.perf_counter()
                    step = self.step_count
                    metrics = self.step(batch)
                    epoch_losses.append(metrics["loss"])
                    if step % self.log_interval == 0:
                        self._log_step(step, epoch, metrics, batch, t0)
                    if self.val_interval and \
                            self.step_count % self.val_interval == 0:
                        self._validate_and_save_best(self.step_count, epoch)
                    if self.preempted:
                        self.save_checkpoint(f"checkpoint_epoch_{epoch}",
                                             epoch)
                        if self.keep_checkpoints:
                            self.ckpt.prune_epoch_checkpoints(
                                self.keep_checkpoints)
                        history["preempted"] = 1.0
                        self.logger.log({"train/preempted": 1.0},
                                        self.step_count)
                        return history
                if epoch_losses:
                    mean_loss = float(torch.stack(epoch_losses).mean())
                    history["train_loss"] = mean_loss
                    self.logger.log({
                        "epoch/train_loss": mean_loss,
                        "epoch/time": time.perf_counter() - t_epoch,
                    }, self.step_count)
                if self.sample_interval and \
                        (epoch + 1) % self.sample_interval == 0:
                    self.generate_samples(epoch)
                if self.checkpoint_interval and \
                        (epoch + 1) % self.checkpoint_interval == 0:
                    self.save_checkpoint(f"checkpoint_epoch_{epoch}", epoch)
                    if self.keep_checkpoints:
                        self.ckpt.prune_epoch_checkpoints(
                            self.keep_checkpoints)
        except Exception:
            epoch = self.step_count // self.steps_per_epoch
            self.save_checkpoint(f"emergency_checkpoint_epoch_{epoch}",
                                 epoch)
            raise
        finally:
            if prev_handler is not None:
                import signal
                signal.signal(signal.SIGTERM, prev_handler)
        # Continue with fresh shuffles when train() is called again.
        self.start_epoch += num_epochs
        return history

    def _validate_and_save_best(self, step: int, epoch: int) -> None:
        val_loss = self.validate()
        self.logger.log({"val/loss": val_loss}, step)
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            self.save_checkpoint("best_model", epoch)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _run_eval(self, loader: Iterable, salt: int) -> float:
        """Mean loss over every sample of ``loader``, each sample's loss
        as the loss of a batch of one (as the reference's vmapped eval),
        with the network in training mode as the reference's
        ``loss_function`` has it. Batch k draws from a generator seeded by
        (seed, salt, offset of its first sample)."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count, offset = 0, 0
        for batch in loader:
            x, y = self._split_batch(batch)
            n = x.shape[0]
            if n == 0:
                continue
            losses = self.model.loss_function(
                x, generator=self._generator(offset, salt), y=y,
                per_sample=True)
            total += losses.double().sum()
            count += n
            offset += n
        return float(total) / count if count else float("inf")

    def validate(self) -> float:
        return self._run_eval(self.val_loader, salt=1)

    def test(self) -> float:
        return self._run_eval(self.test_loader, salt=2)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def ema_weights(self):
        """Run the model with the EMA weights, then put the weights back."""
        with torch.no_grad():
            saved = [p.detach().clone() for p in self.params]
            torch._foreach_copy_(self.params, self.ema)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(self.params, saved)

    def generate_samples(self, epoch: int, num_samples: int = 4,
                         use_ema: bool = False) -> str:
        """A grid of the sampler's intermediates, one row per sample,
        saved as ``samples/epoch_{epoch}.png``."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 99) * _SEED_STRIDE + epoch)
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            frames = self.model.generate_samples_with_intermediates(
                num_samples, gen)
        grid = frames_to_grid([f.cpu().numpy() for f in frames])
        path = self.output_dir / "samples" / f"epoch_{epoch}.png"
        out = save_image(grid.astype(np.float32) / 127.5 - 1.0, str(path))
        self.logger.log_image("samples", grid, self.step_count)
        return out

    # ------------------------------------------------------------------
    def state(self, epoch: int) -> Dict[str, Any]:
        """The full training state on the CPU, as a checkpoint holds it."""
        return {
            "params": {n: p.detach().cpu().clone()
                       for n, p in zip(self.param_names, self.params)},
            "ema_params": {n: e.detach().cpu().clone()
                           for n, e in zip(self.param_names, self.ema)},
            "opt_state": self.optimizer.state_dict(),
            "step": self.step_count,
            "epoch": int(epoch),
            "best_val_loss": float(self.best_val_loss),
        }

    def save_checkpoint(self, name: str, epoch: int) -> str:
        return self.ckpt.save(name, self.state(epoch))

    def load_checkpoint(self, name: Optional[str] = None) -> int:
        """Restore the full state; returns the epoch to resume from. With
        no name, the newest ``checkpoint_epoch_*``."""
        if name is None:
            name = self.ckpt.latest_epoch_checkpoint()
            if name is None:
                raise FileNotFoundError(
                    f"no checkpoint_epoch_* under {self.ckpt.directory}")
        state = self.ckpt.restore(name)
        self.model.net.load_state_dict(state["params"], strict=True)
        with torch.no_grad():
            for e, n in zip(self.ema, self.param_names):
                e.copy_(state["ema_params"][n])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step_count = int(state["step"])
        self.best_val_loss = float(state["best_val_loss"])
        self.start_epoch = int(state["epoch"]) + 1
        return self.start_epoch

    def cleanup(self) -> None:
        self.logger.close()
