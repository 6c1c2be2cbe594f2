"""The training engine of the port (counterpart of the reference's
``trainers/trainer.py``).

One training step is: the loss of a batch (its draws, such as t and ε,
from a generator seeded by (seed, step), so a resumed run draws what an
unbroken one would), its gradients by autograd (through the GroupNorm and attention
Functions, so kernels K1/K2/K3 on the card), the global and per-layer
gradient norms, one Adam update (``trainers/optim.py``), and the EMA
update with warmup, d = min(decay, (1+t)/(10+t)), computed in f32 and
stored in ``training.ema_dtype``. With ``training.grad_accum_steps`` A,
one update takes A micro-batches (micro-batch i draws from the generator
of (seed, step, i)) and the mean of their losses and gradients; an epoch
has ceil(batches / A) updates, the last one over the ragged tail, and
the LR schedule, logging, validation and preemption count updates. The
step stays on the device; the host reads a metric only at the logging
cadence and the epoch's mean loss at its end.

Around it, as in the reference: the single-step ``train`` loop with
validation every ``val_interval`` steps and a best-model save, sample
grids every ``sample_interval`` epochs, checkpoints every
``checkpoint_interval`` epochs (pruned to ``keep_checkpoints``), an
emergency checkpoint on an exception, SIGTERM preemption (save, then
return), masked per-sample ``validate``/``test``, and full-state
``save_checkpoint``/``load_checkpoint`` (``utils/checkpoint.py``).
``logging.track_histograms`` logs a histogram of every gradient and
weight, and β/α/ᾱ, at ``gradient_logging_freq``; :meth:`profile` traces
a few real updates with ``torch.profiler``.

Data parallelism: a trainer built in a process that has joined a
``torch.distributed`` group (``parallel/mesh.py``) is one replica. Its
batches are its rows of a global batch: the ``rows`` a split loader
gives (``train --num_devices``), else the rank's block of the ranks'
batches side by side (``--multihost``). Each loss draws the global
batch's draws and keeps its rows; the mean loss and gradients of an
update are summed over the ranks in one all-reduce, each rank weighted
by its share of the rows, before the norms, the clip, Adam and the EMA,
so every replica applies the same update. The parameters are broadcast
from rank 0 when the trainer is built and after a restore. At each step
boundary the ranks OR their preemption flags, so all of them save at the
same step. Evaluation sums (Σ loss, count) over the ranks, so it gives
the same loss for any number of ranks. Rank 0 alone writes checkpoints
(the others wait at a barrier), logs, and draws the sample grids; each
rank computes the histograms, whose gradients are reduced, and rank 0
logs them; :meth:`profile` traces on rank 0.

Not ported yet (it raises): ``scan_steps > 1``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import NOT_PORTED
from ..parallel import mesh
from ..utils.checkpoint import CheckpointManager
from ..utils.images import frames_to_grid, save_image
from ..utils.logging_utils import MetricLogger
from .optim import dtype_from_config, make_optimizer

_SEED_STRIDE = 1_000_003
#: Moves micro-batch i's generator seed away from any step's.
_MICRO_STRIDE = 0x9E3779B97F4A7C15


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
        if int(tcfg.get("scan_steps", 1)) > 1:
            raise ValueError(f"training.scan_steps > 1 is {NOT_PORTED}")
        self.grad_accum = int(tcfg.get("grad_accum_steps", 1))
        if self.grad_accum < 1:
            raise ValueError(f"training.grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum}")
        self.ema_dtype = dtype_from_config(tcfg, "ema_dtype")
        self.track_histograms = bool(log_cfg.get("track_histograms", False))

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
        self.steps_per_epoch = max(-(-len(train_loader) // self.grad_accum),
                                   1)

        self.data_parallel = mesh.is_initialized()
        self.rank = mesh.rank()
        self.world_size = mesh.world_size()
        self.is_main = self.rank == 0
        torch.manual_seed(seed + _SEED_STRIDE * self.rank)  # dropout masks
        named = list(model.net.named_parameters())
        self.param_names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        mesh.broadcast_(self.params)
        self._flag_group = mesh.new_flag_group()
        self.optimizer, self.lr_schedule = make_optimizer(
            self.params, tcfg, self.steps_per_epoch, self.num_epochs)
        self.ema = [p.detach().to(self.ema_dtype, copy=True)
                    for p in self.params]
        self.step_count = 0
        self._gen = torch.Generator(device=self.device)

        output_cfg = self.config.get("output", {}) or {}
        self.output_dir = Path(output_cfg.get("output_dir",
                                              "outputs/run")).absolute()
        self.logger = MetricLogger(self.config,
                                   model_name=self.config.get("model_name",
                                                              "model"),
                                   output_dir=str(self.output_dir),
                                   enabled=self.is_main)
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
    def _generator(self, step: int, salt: int = 0,
                   micro: int = 0) -> torch.Generator:
        """The generator of the draws of one step's micro-batch (or of one
        eval batch)."""
        return self._gen.manual_seed(
            ((self.seed + 17 * salt) * _SEED_STRIDE + step
             + micro * _MICRO_STRIDE) & (2 ** 63 - 1))

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, dict):
            return batch["image"], batch.get("label")
        return batch, None

    @staticmethod
    def _batch_count(batches) -> int:
        return sum(DiffusionTrainer._split_batch(b)[0].shape[0]
                   for b in batches)

    def _rows(self, batch, b: int):
        """The (lo, hi, n) rows of the global batch that ``batch`` (of
        ``b`` samples) holds; None outside data parallelism."""
        if isinstance(batch, dict) and "rows" in batch:
            return tuple(batch["rows"])
        if not self.data_parallel:
            return None
        return (self.rank * b, (self.rank + 1) * b, self.world_size * b)

    def _loss_and_grads(self, micro_batches: List[Any], step: int,
                        draws: Optional[List[Dict[str, Any]]] = None):
        """The mean loss and mean gradients of ``micro_batches`` (gradients
        summed in f32, then scaled by 1/A, as the reference's
        accumulation), micro-batch i drawing from ``_generator(step,
        micro=i)`` unless ``draws[i]`` gives its draws (the global
        batch's, under data parallelism). Under data parallelism, each
        micro-batch's are weighted by the rank's share of its rows and
        summed over the ranks."""
        loss_sum, grads_sum = None, None
        for i, batch in enumerate(micro_batches):
            x, y = self._split_batch(batch)
            rows = self._rows(batch, x.shape[0])
            loss = self.model.loss_function(
                x, generator=self._generator(step, micro=i), y=y, rows=rows,
                **(draws[i] if draws else {}))
            # A parameter the loss does not reach (the energy DSM
            # objective differentiates ∇ₓE, to which the last bias adds
            # nothing) gets a zero gradient, as the reference's does.
            grads = list(torch.autograd.grad(
                loss, self.params, allow_unused=True, materialize_grads=True))
            share = (rows[1] - rows[0]) / rows[2] if rows else 1.0
            if share != 1.0:
                loss = loss * share
                torch._foreach_mul_(grads, share)
            if grads_sum is None:
                loss_sum, grads_sum = loss.detach(), grads
            else:
                loss_sum = loss_sum + loss.detach()
                torch._foreach_add_(grads_sum, grads)
        if len(micro_batches) > 1:
            inv = 1.0 / len(micro_batches)
            loss_sum = loss_sum * inv
            torch._foreach_mul_(grads_sum, inv)
        if self.data_parallel:
            loss_sum = loss_sum.clone()
            mesh.all_reduce_sum_([loss_sum, *grads_sum])
        return loss_sum, grads_sum

    def step(self, batch, **draws) -> Dict[str, Any]:
        """One training step; the loss's draws may be injected as keywords
        of the family's ``loss_function`` (tests): ``t``/``noise``
        (DDPM, DDIM), ``sigma``/``noise`` (score), ``t``/``noise``/
        ``langevin_noise``/``alpha`` (energy), the global batch's under
        data parallelism. Returns device tensors:
        ``loss``, ``grad_norm`` and ``layer_grad_norms`` (name → norm),
        all of the raw gradients."""
        return self.accum_step([batch], [draws])

    def accum_step(self, micro_batches: List[Any],
                   draws: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
        """One update from ``len(micro_batches)`` micro-batches (gradient
        accumulation): the mean of their losses and gradients, each
        micro-batch with its own draws (``draws[i]``, keywords as in
        :meth:`step`, may inject them). Returns what :meth:`step`
        returns."""
        loss, grads = self._loss_and_grads(micro_batches, self.step_count,
                                           draws)
        norms = torch._foreach_norm(grads)
        grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        self.optimizer.step(grads, grad_norm)
        self._update_ema()
        self.step_count += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "layer_grad_norms": dict(zip(self.param_names, norms))}

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        if self.ema_warmup:
            # t counts completed updates: the first uses d = 1/10.
            t = float(self.step_count)
            d = min(d, (1.0 + t) / (10.0 + t))
        ema = (self.ema if self.ema_dtype == torch.float32
               else [e.float() for e in self.ema])
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, self.params, alpha=1.0 - d)
        if ema is not self.ema:
            torch._foreach_copy_(self.ema, ema)

    def param_norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([p.detach() for p in self.params])))

    # ------------------------------------------------------------------
    def profile(self, steps: int = 5, log_dir: Optional[str] = None) -> str:
        """Trace ``steps`` real updates (the state advances) with
        ``torch.profiler`` into ``log_dir`` (default
        ``output_dir/profile``), after one warm-up update outside the
        window; returns the directory. View with TensorBoard or as a
        Chrome trace."""
        from ..utils.profiling import trace
        log_dir = log_dir or str(self.output_dir / "profile")
        updates = self._updates(self.train_loader)

        def update():
            chunk = next(updates, None)
            if chunk is None:
                raise ValueError(f"profiling {steps} updates after a "
                                 f"warm-up needs {steps + 1}; an epoch has "
                                 f"{self.steps_per_epoch}")
            self.accum_step(chunk)

        try:
            update()
            with (trace(log_dir, device=self.device) if self.is_main
                  else contextlib.nullcontext()):
                for _ in range(steps):
                    update()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            updates.close()
        return log_dir

    def _on_preempt_signal(self, signum, frame) -> None:
        self.preempted = True

    def _preemption_agreed(self) -> bool:
        """The OR of every rank's preemption flag (a SIGTERM is
        process-local), taken at each step boundary by every rank, so
        that all of them take the save-and-return branch at the same
        step instead of some waiting in the next update's all-reduce."""
        if self.data_parallel:
            self.preempted = mesh.any_flag(self.preempted, self._flag_group)
        return self.preempted

    def _install_preemption_handler(self):
        if not self.handle_preemption:
            return None
        import signal
        try:
            return signal.signal(signal.SIGTERM, self._on_preempt_signal)
        except ValueError:  # not in the main thread
            return None

    def _updates(self, loader: Iterable) -> Iterator[List[Any]]:
        """The loader's batches in groups of ``grad_accum_steps``, the
        last group the ragged tail."""
        chunk: List[Any] = []
        for batch in loader:
            chunk.append(batch)
            if len(chunk) == self.grad_accum:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def _rng_state(self):
        return (torch.get_rng_state(),
                torch.cuda.get_rng_state(self.device)
                if self.device.type == "cuda" else None)

    def histogram_metrics(self, micro_batches: List[Any], step: int,
                          rng_state) -> Dict[str, Any]:
        """Histograms of every weight and of the gradients of update
        ``step``'s micro-batches and draws, taken again at the post-update
        weights (the reference's ``grads_for_logging``): the same
        generators, and the dropout RNG state ``rng_state`` that the
        update started from; and β/α/ᾱ."""
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.set_rng_state(rng_state[0])
            if rng_state[1] is not None:
                torch.cuda.set_rng_state(rng_state[1], self.device)
            _, grads = self._loss_and_grads(micro_batches, step)
        out = self.logger.model_histograms(
            dict(zip(self.param_names, grads)),
            dict(zip(self.param_names, self.params)))
        if hasattr(self.model, "schedule"):
            out.update(self.logger.diffusion_metrics(self.model.schedule))
        return out

    def _log_step(self, step: int, epoch: int, metrics, chunk,
                  t0: float, rng_state=None) -> None:
        # Every rank recomputes the histograms' gradients (their
        # all-reduce needs all of them); rank 0 alone logs.
        histograms = (self.histogram_metrics(chunk, step, rng_state)
                      if rng_state is not None else {})
        if not self.is_main:
            return
        loss = float(metrics["loss"])
        log = {"train/loss": loss,
               "train/grad_norm": float(metrics["grad_norm"]),
               "train/learning_rate": float(self.lr_schedule(step)),
               "train/epoch": epoch + (step % self.steps_per_epoch)
               / self.steps_per_epoch}
        if self.track_time:
            log.update(self.logger.performance_metrics(
                time.perf_counter() - t0, self._batch_count(chunk),
                self.device))
        if step % self.gradient_logging_freq == 0:
            log.update(self.logger.gradient_metrics(
                metrics["layer_grad_norms"], metrics["grad_norm"],
                self.param_norm()))
            log.update(self.logger.optimizer_metrics(
                self.optimizer, self.lr_schedule(step)))
            log.update(histograms)
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
                for chunk in self._updates(self.train_loader):
                    t0 = time.perf_counter()
                    step = self.step_count
                    logged = step % self.log_interval == 0
                    rng_state = (self._rng_state() if logged
                                 and self.track_histograms and step
                                 % self.gradient_logging_freq == 0 else None)
                    metrics = self.accum_step(chunk)
                    epoch_losses.append(metrics["loss"])
                    if logged:
                        self._log_step(step, epoch, metrics, chunk, t0,
                                       rng_state)
                    if self.val_interval and \
                            self.step_count % self.val_interval == 0:
                        self._validate_and_save_best(self.step_count, epoch)
                    if self._preemption_agreed():
                        self._save_epoch_checkpoint(epoch)
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
                if self.is_main and self.sample_interval and \
                        (epoch + 1) % self.sample_interval == 0:
                    self.generate_samples(epoch)
                if self.checkpoint_interval and \
                        (epoch + 1) % self.checkpoint_interval == 0:
                    self._save_epoch_checkpoint(epoch)
        except Exception:
            # No barrier: the other ranks may be gone.
            if self.is_main:
                epoch = self.step_count // self.steps_per_epoch
                self.ckpt.save(f"emergency_checkpoint_epoch_{epoch}",
                               self.state(epoch))
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
        (seed, salt, offset of its first sample in the global batches).
        Under data parallelism each rank holds its rows of every global
        batch (a ragged one split unevenly, no sample dropped or counted
        twice) and the (Σ loss, count) pair is summed over the ranks."""
        sums = torch.zeros(2, dtype=torch.float64, device=self.device)
        offset = 0
        for batch in loader:
            x, y = self._split_batch(batch)
            rows = self._rows(batch, x.shape[0])
            if x.shape[0]:
                losses = self.model.loss_function(
                    x, generator=self._generator(offset, salt), y=y,
                    per_sample=True, rows=rows)
                sums[0] += losses.double().sum()
                sums[1] += x.shape[0]
            offset += rows[2] if rows else x.shape[0]
        mesh.all_reduce_sum_([sums])
        total, count = sums.tolist()
        return total / count if count else float("inf")

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
        """Rank 0 writes the checkpoint; every rank waits until it is
        whole."""
        if self.is_main:
            self.ckpt.save(name, self.state(epoch))
        mesh.barrier()
        return str(self.ckpt.directory / name)

    def _save_epoch_checkpoint(self, epoch: int) -> None:
        """``checkpoint_epoch_{epoch}``, then the pruning to
        ``keep_checkpoints``, on rank 0."""
        if self.is_main:
            self.ckpt.save(f"checkpoint_epoch_{epoch}", self.state(epoch))
            if self.keep_checkpoints:
                self.ckpt.prune_epoch_checkpoints(self.keep_checkpoints)
        mesh.barrier()

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
        mesh.broadcast_([*self.params, *self.ema, *self.optimizer.mu,
                         *self.optimizer.nu])
        self.step_count = int(state["step"])
        self.best_val_loss = float(state["best_val_loss"])
        self.start_epoch = int(state["epoch"]) + 1
        return self.start_epoch

    def cleanup(self) -> None:
        self.logger.close()
