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

Model parallelism (``distributed.model_parallel`` M > 1): the reference
shards its parameter, EMA and Adam trees over the model axis
(``parallel/mesh.py::shard_plan``, the rule of its ``param_sharding``);
here each group of M consecutive ranks does: between updates a rank
holds only its shard of each sharded leaf's f32 parameter, EMA, μ and ν
(``master``, ``ema``, the optimizer's moments; whole for the small
leaves), and the network's copies of the sharded leaves hold no storage.
An update gathers the whole parameters into the network once
(:meth:`whole_params`, so remat's recompute and accumulation run on whole
weights), takes the loss and gradients as above (all-reduced whole, so
the norms, the clip and the non-finite skip are one process's), updates
its shards of the parameters, μ, ν and the EMA, and frees the whole
copies. Evaluation, the sample grids, :meth:`ema_weights`,
:meth:`param_norm` and the histograms gather what they read, and so do
:meth:`state` (every rank calls it; rank 0 writes the checkpoint one
process writes) and :meth:`load_checkpoint` (every rank reads the whole
file and keeps its shards), so a checkpoint moves between any layouts.
The emergency checkpoint on an exception needs no collective (the other
ranks may be gone): each rank that raises writes its own shards
(:meth:`shard_state`), and ``utils/checkpoint.py`` joins them into one
process's state when a full set of M is there. The batch's rows stay
split over all D·M ranks. With M = 1 none of this runs.

``training.scan_steps`` K > 1 (``trainers/scan.py``): the epoch runs in
chunks of K updates, each chunk one call of :meth:`scan_chunk`: on the
CPU K eager updates, on CUDA one replay of a CUDA graph that captured K
updates (the first chunk of a batch shape runs eagerly and the next is
captured). Each update's draws are made before the chunk from the
generator of its own step, so K scanned updates equal K calls of
:meth:`step`, as the reference's in-program ``fold_in(base_key, i)``
makes its scan equal its single steps. As in the reference: logging and
validation fire at the chunk that crosses their interval, the
throughput is taken between log events, the preemption agreement runs
once a chunk, the ragged tail of an epoch runs as single updates, the
chunk returns only its per-step losses, and K > 1 excludes
``grad_accum_steps`` > 1. On CUDA it is refused over gloo and with
``model_parallel`` > 1 (:func:`scan.scan_refusal`).

Spatial parallelism (``distributed.spatial_parallel`` S > 1), forward
only: the ranks form spatial groups of S consecutive ranks (the
reference mesh's order, rank = d·S + s); the S ranks of data group d
hold the same rows of every batch (the loaders split a batch over the D
groups), draw alike (the default generator is seeded by d, so dropout
masks match), and split each image's rows in the UNet
(``parallel/spatial.py``, ``UNet.set_row_group``). Evaluation, the
sample grids and the sampling harness run so, and (Σ loss, count) takes
each data group's samples once, from s = 0. A training update is
refused: its backward is the next slice.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..parallel import mesh, spatial
from ..utils.checkpoint import CheckpointManager
from ..utils.images import frames_to_grid, save_image
from ..utils.logging_utils import MetricLogger
from .optim import dtype_from_config, make_optimizer, to_device
from .scan import SCAN_ACCUM_EXCLUSIVE, StepGraphs, scan_refusal

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
        self.grad_accum = int(tcfg.get("grad_accum_steps", 1))
        if self.grad_accum < 1:
            raise ValueError(f"training.grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum}")
        self.scan_steps = int(tcfg.get("scan_steps", 1))
        if self.scan_steps > 1 and self.grad_accum > 1:
            raise ValueError(SCAN_ACCUM_EXCLUSIVE)
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
        dist_cfg = self.config.get("distributed") or {}
        model_parallel = int(dist_cfg.get("model_parallel", 1))
        self.spatial_parallel = int(dist_cfg.get("spatial_parallel", 1))
        self.row_group = None
        # (index, count) of the row blocks that split every batch: the
        # rank's among all ranks, or its data group's under spatial
        # parallelism.
        self._row_split = (self.rank, self.world_size)
        if self.spatial_parallel > 1:
            layout = mesh.make_layout(self.world_size,
                                      model_parallel=model_parallel,
                                      spatial_parallel=self.spatial_parallel)
            self.row_group = spatial.make_row_groups(
                self.spatial_parallel, self.rank, self.world_size)
            self._row_split = (mesh.data_index(self.rank, layout),
                               layout[mesh.DATA_AXIS])
            if hasattr(model.net, "set_row_group"):   # not the EnergyNet
                model.net.set_row_group(self.row_group)
        # Dropout masks: the S ranks of a spatial group draw alike.
        torch.manual_seed(seed + _SEED_STRIDE * self._row_split[0])
        named = list(model.net.named_parameters())
        self.param_names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        param_count = sum(p.numel() for p in self.params)
        mesh.broadcast_(self.params)
        refusal = scan_refusal(self.scan_steps, self.device.type,
                               mesh.backend(), model_parallel)
        if refusal:
            raise ValueError(refusal)
        self.sharding = None
        # The f32 weights Adam updates: this rank's shards of the sharded
        # leaves under model parallelism, else the network's parameters.
        self.master = self.params
        if model_parallel > 1:
            self.sharding = mesh.Sharding(
                self.params, mesh.shard_plan(model.net, model_parallel),
                model_parallel)
            self.master = [
                t if spec is None
                else t.detach().clone(memory_format=torch.contiguous_format)
                for t, spec in zip(self.sharding.shards(self.params),
                                   self.sharding.plan)]
        self.optimizer, self.lr_schedule = make_optimizer(
            self.master, tcfg, self.steps_per_epoch, self.num_epochs,
            self.sharding)
        self.ema = [p.detach().to(self.ema_dtype, copy=True)
                    for p in self.master]
        self._whole = self.sharding is None
        if self.sharding is not None:
            self.sharding.free_(self.params)
        self.step_count = 0
        self._gen = torch.Generator(device=self.device)
        self.graphs = (StepGraphs(self) if self.scan_steps > 1
                       and self.device.type == "cuda" else None)

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
            "param_count": param_count})
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
        """The samples of ``batches``: each global batch's n where a batch
        holds ``rows`` of one (``train --num_devices``), else its own rows
        (one process, and each process's batch under ``--multihost``)."""
        return sum(b["rows"][2] if isinstance(b, dict) and "rows" in b
                   else DiffusionTrainer._split_batch(b)[0].shape[0]
                   for b in batches)

    def _rows(self, batch, b: int):
        """The (lo, hi, n) rows of the global batch that ``batch`` (of
        ``b`` samples) holds; None outside data parallelism."""
        if isinstance(batch, dict) and "rows" in batch:
            return tuple(batch["rows"])
        if not self.data_parallel:
            return None
        i, n = self._row_split
        return (i * b, (i + 1) * b, n * b)

    def _refuse_spatial_training(self) -> None:
        if self.spatial_parallel > 1:
            raise NotImplementedError(
                f"a training update under distributed.spatial_parallel "
                f"{self.spatial_parallel}: {spatial.NEXT_SLICE}; run train "
                f"--eval_only (evaluation, sample grids, --benchmark)")

    def _loss_and_grads(self, micro_batches: List[Any], step: int,
                        draws: Optional[List[Dict[str, Any]]] = None,
                        drawn: bool = False):
        """The mean loss and mean gradients of ``micro_batches`` (gradients
        summed in f32, then scaled by 1/A, as the reference's
        accumulation), micro-batch i drawing from ``_generator(step,
        micro=i)`` what ``draws[i]`` does not give (the global batch's,
        under data parallelism; ``drawn``: all of it, and no generator is
        touched). Under data parallelism, each micro-batch's are weighted
        by the rank's share of its rows and summed over the ranks."""
        self._refuse_spatial_training()
        loss_sum, grads_sum = None, None
        for i, batch in enumerate(micro_batches):
            x, y = self._split_batch(batch)
            rows = self._rows(batch, x.shape[0])
            loss = self.model.loss_function(
                x, generator=None if drawn else self._generator(step,
                                                                micro=i),
                y=y, rows=rows, **(draws[i] if draws else {}))
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
        scalars = to_device(torch.cat([self.optimizer.scalar_table(1),
                                       self._ema_table(self.step_count, 1)],
                                      dim=1)[0], self.device)
        with self.whole_params():
            loss, grad_norm, norms = self._update(
                micro_batches, self.step_count, draws, scalars[:2],
                scalars[2:])
        self.optimizer.advance(1)
        self.step_count += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "layer_grad_norms": dict(zip(self.param_names, norms))}

    def _update(self, micro_batches, step, draws, adam, ema,
                drawn: bool = False):
        """One update's loss, gradients, norms, Adam and EMA, with the
        update's scalars on the device (``adam``: a row of
        ``optimizer.scalar_table``, ``ema``: of :meth:`_ema_table`): the
        body of an eager update and of each update of a captured chunk.
        Returns the loss, the global and the per-layer gradient norms."""
        loss, grads = self._loss_and_grads(micro_batches, step, draws,
                                           drawn)
        norms = torch._foreach_norm(grads)
        grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        self.optimizer.step(grads if self.sharding is None
                            else self.sharding.shards(grads), grad_norm,
                            adam)
        self._update_ema(ema)
        return loss, grad_norm, norms

    def _ema_table(self, step: int, n: int) -> torch.Tensor:
        """[n, 2] f32 on the host: the EMA decay d and 1 − d of updates
        ``step`` … ``step + n − 1``; with warmup d = min(decay,
        (1+t)/(10+t)), t counting completed updates (the first uses
        d = 1/10)."""
        rows = []
        for t in range(step, step + n):
            d = self.ema_decay
            if self.ema_warmup:
                d = min(d, (1.0 + t) / (10.0 + t))
            rows.append((d, 1.0 - d))
        return torch.tensor(rows, dtype=torch.float32)

    @torch.no_grad()
    def _update_ema(self, scalars: Optional[torch.Tensor] = None) -> None:
        """ema ← d·ema + (1−d)·θ in f32, with ``scalars`` (d, 1 − d) on the
        device (default: the row of the current step)."""
        if scalars is None:
            scalars = to_device(self._ema_table(self.step_count, 1),
                                self.device)[0]
        ema = (self.ema if self.ema_dtype == torch.float32
               else [e.float() for e in self.ema])
        torch._foreach_mul_(ema, scalars[0])
        torch._foreach_add_(ema, torch._foreach_mul(self.master, scalars[1]))
        if ema is not self.ema:
            torch._foreach_copy_(self.ema, ema)

    # ------------------------------------------------------------------
    def _step_draws(self, batch, step: int) -> Dict[str, Any]:
        """Every draw of update ``step``'s loss on ``batch``, made now from
        the step's generator as :meth:`step` would make them."""
        x, y = self._split_batch(batch)
        return self.model.loss_draws(x, generator=self._generator(step),
                                     y=y, rows=self._rows(batch, x.shape[0]))

    def scan_chunk(self, chunk: List[Any]) -> torch.Tensor:
        """``len(chunk)`` updates, one a batch, as one (the reference's
        ``_scan_chunk``): the draws and scalars made first on the host,
        then the chunk eagerly on the CPU, or through :attr:`graphs` on
        CUDA. Returns the per-step losses [K]; grad-norm metrics stay on
        the single-step path."""
        k, step0 = len(chunk), self.step_count
        draws = [self._step_draws(batch, step0 + i)
                 for i, batch in enumerate(chunk)]
        adam = self.optimizer.scalar_table(k)
        ema = self._ema_table(step0, k)
        if self.graphs is not None:
            losses = self.graphs.run(chunk, draws, adam, ema)
        else:
            losses = self._scan_body(chunk, draws,
                                     to_device(adam, self.device),
                                     to_device(ema, self.device))
        self.optimizer.advance(k)
        self.step_count += k
        return losses

    def _scan_body(self, batches, draws, adam: torch.Tensor,
                   ema: torch.Tensor) -> torch.Tensor:
        """K updates on the device with nothing read by the host: update
        i on ``batches[i]`` with ``draws[i]``, its Adam row chosen on the
        device by how far the count moved since the chunk began (a
        skipped update does not move it), its EMA row i. What a CUDA
        graph captures."""
        start = self.optimizer.counters[0].clone()
        losses = []
        with self.whole_params():
            for i, (batch, d) in enumerate(zip(batches, draws)):
                loss, _, _ = self._update(
                    [batch], 0, [d], self.optimizer.row(adam, start),
                    ema[i], drawn=True)
                losses.append(loss)
        return torch.stack(losses)

    def param_norm(self) -> torch.Tensor:
        """‖θ‖ over every parameter (under model parallelism a gather:
        every rank calls it)."""
        with self.whole_params():
            return torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([p.detach() for p in self.params])))

    @contextlib.contextmanager
    def whole_params(self):
        """The whole parameters in the network for the block: under model
        parallelism gathered from every shard (every rank of the group
        enters together) and freed after; nested blocks gather once.
        Nothing to do otherwise."""
        if self._whole:
            yield
            return
        self.sharding.gather_(self.params, self.master)
        self._whole = True
        try:
            yield
        finally:
            self.sharding.free_(self.params)
            self._whole = False

    # ------------------------------------------------------------------
    def profile(self, steps: int = 5, log_dir: Optional[str] = None) -> str:
        """Trace ``steps`` real updates (the state advances) with
        ``torch.profiler`` into ``log_dir`` (default
        ``output_dir/profile``), after one warm-up update outside the
        window; returns the directory. View with TensorBoard or as a
        Chrome trace."""
        from ..utils.profiling import trace
        log_dir = log_dir or str(self.output_dir / "profile")
        k = self.scan_steps
        if k > 1:
            # Whole chunks: on CUDA an eager one and the one captured
            # before the window, then ceil(steps / K) replays.
            size, run, updates = k, self.scan_chunk, self._grouped(
                self.train_loader, k)
            warmup = 2 if self.graphs is not None else 1
            count = -(-steps // k)
        else:
            size, run, updates = 1, self.accum_step, self._updates(
                self.train_loader)
            warmup, count = 1, steps

        def update():
            chunk = next(updates, None)
            if chunk is None or (k > 1 and len(chunk) < size):
                raise ValueError(
                    f"profiling {count * size} updates after {warmup * size}"
                    f" of warm-up needs {(count + warmup) * size}; an epoch "
                    f"has {self.steps_per_epoch}")
            run(chunk)

        try:
            for _ in range(warmup):
                update()
            with (trace(log_dir, device=self.device) if self.is_main
                  else contextlib.nullcontext()):
                for _ in range(count):
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
            self.preempted = mesh.any_flag(self.preempted)
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
        return self._grouped(loader, self.grad_accum)

    @staticmethod
    def _grouped(loader: Iterable, size: int) -> Iterator[List[Any]]:
        """The loader's batches in groups of ``size``, the last group the
        ragged tail."""
        chunk: List[Any] = []
        for batch in loader:
            chunk.append(batch)
            if len(chunk) == size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def _rng_state(self):
        """The dropout RNG state: the host's, the card's and the remat
        stages' (``UNet.remat_rng_state``)."""
        net = getattr(self.model.net, "remat_rng_state", None)
        return (torch.get_rng_state(),
                torch.cuda.get_rng_state(self.device)
                if self.device.type == "cuda" else None,
                net() if net else None)

    def _set_net_rng(self, state) -> None:
        set_state = getattr(self.model.net, "set_remat_rng_state", None)
        if set_state is not None:
            set_state(state)

    def histogram_metrics(self, micro_batches: List[Any], step: int,
                          rng_state) -> Dict[str, Any]:
        """Histograms of every weight and of the gradients of update
        ``step``'s micro-batches and draws, taken again at the post-update
        weights (the reference's ``grads_for_logging``): the same
        generators, and the dropout RNG state ``rng_state`` that the
        update started from; and β/α/ᾱ."""
        devices = [self.device] if self.device.type == "cuda" else []
        with self.whole_params():
            held = self._rng_state()[2]
            with torch.random.fork_rng(devices=devices):
                torch.set_rng_state(rng_state[0])
                if rng_state[1] is not None:
                    torch.cuda.set_rng_state(rng_state[1], self.device)
                self._set_net_rng(rng_state[2])
                try:
                    _, grads = self._loss_and_grads(micro_batches, step)
                finally:
                    self._set_net_rng(held)
            out = self.logger.model_histograms(
                dict(zip(self.param_names, grads)),
                dict(zip(self.param_names, self.params)))
        if hasattr(self.model, "schedule"):
            out.update(self.logger.diffusion_metrics(self.model.schedule))
        return out

    def _log_step(self, step: int, epoch: int, metrics, chunk,
                  t0: float, rng_state=None) -> None:
        # Every rank recomputes the histograms' gradients (their
        # all-reduce needs all of them) and takes the parameter norm (a
        # gather under model parallelism); rank 0 alone logs.
        grad_step = step % self.gradient_logging_freq == 0
        with self.whole_params() if grad_step else contextlib.nullcontext():
            histograms = (self.histogram_metrics(chunk, step, rng_state)
                          if rng_state is not None else {})
            param_norm = self.param_norm() if grad_step else None
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
        if grad_step:
            log.update(self.logger.gradient_metrics(
                metrics["layer_grad_norms"], metrics["grad_norm"],
                param_norm))
            log.update(self.logger.optimizer_metrics(
                self.optimizer, self.lr_schedule(step)))
            log.update(histograms)
        self.logger.log(log, step)

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        """Run the training loop for ``num_epochs`` epochs from
        ``start_epoch``; returns the last epoch's mean loss."""
        self._refuse_spatial_training()
        num_epochs = num_epochs if num_epochs is not None else self.num_epochs
        history: Dict[str, float] = {}
        self.preempted = False
        prev_handler = self._install_preemption_handler()
        epoch = self.start_epoch
        # The scan path's throughput is taken between log events, and
        # across epochs (an epoch with one log event still gets a rate).
        self._last_log = None
        try:
            for epoch in range(self.start_epoch,
                               self.start_epoch + num_epochs):
                self.train_loader.set_epoch(epoch)
                epoch_losses = []
                t_epoch = time.perf_counter()
                if self.scan_steps > 1 and self._scan_epoch(epoch,
                                                            epoch_losses):
                    history["preempted"] = 1.0
                    return history
                for chunk in (() if self.scan_steps > 1
                              else self._updates(self.train_loader)):
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
                    if self._preempt_save(epoch):
                        history["preempted"] = 1.0
                        return history
                if epoch_losses:
                    mean_loss = float(torch.cat(
                        [v.reshape(-1) for v in epoch_losses]).mean())
                    history["train_loss"] = mean_loss
                    self.logger.log({
                        "epoch/train_loss": mean_loss,
                        "epoch/time": time.perf_counter() - t_epoch,
                    }, self.step_count)
                if self.sample_interval and \
                        (epoch + 1) % self.sample_interval == 0:
                    with self.whole_params():
                        if self.is_main:
                            self.generate_samples(epoch)
                if self.checkpoint_interval and \
                        (epoch + 1) % self.checkpoint_interval == 0:
                    self._save_epoch_checkpoint(epoch)
        except Exception:
            # No barrier and no gather: the other ranks may be gone, so
            # under model parallelism each rank writes its own shards.
            epoch = self.step_count // self.steps_per_epoch
            name = f"emergency_checkpoint_epoch_{epoch}"
            if self.sharding is not None:
                self.ckpt.save_shard(name, self.sharding.index,
                                     self.sharding.model_parallel,
                                     self.shard_state(epoch))
            elif self.is_main:
                self.ckpt.save(name, self.state(epoch))
            raise
        finally:
            if prev_handler is not None:
                import signal
                signal.signal(signal.SIGTERM, prev_handler)
        # Continue with fresh shuffles when train() is called again.
        self.start_epoch += num_epochs
        return history

    def _scan_epoch(self, epoch: int, epoch_losses: List[torch.Tensor]
                    ) -> bool:
        """One epoch in chunks of ``scan_steps`` K (the reference's scan
        loop): a log at the chunk where ``step % log_interval < K``, with
        the loss of its steps and the throughput since the last log event;
        validation where ``step % val_interval < K``; the preemption
        agreement once a chunk; the ragged tail as single updates, each
        with the single step's rule. Appends the losses to
        ``epoch_losses``; returns True when preempted (the checkpoint
        saved)."""
        k = self.scan_steps
        for chunk in self._grouped(self.train_loader, k):
            if len(chunk) < k:   # the ragged tail
                for batch in chunk:
                    step = self.step_count
                    metrics = self.accum_step([batch])
                    epoch_losses.append(metrics["loss"])
                    if self.is_main and step % self.log_interval == 0:
                        self.logger.log({
                            "train/loss": float(metrics["loss"]),
                            "train/learning_rate":
                                float(self.lr_schedule(step))}, step)
                    if self.val_interval and \
                            self.step_count % self.val_interval == 0:
                        self._validate_and_save_best(self.step_count, epoch)
                    if self._preempt_save(epoch):
                        return True
                break
            losses = self.scan_chunk(chunk)
            epoch_losses.append(losses)
            step = self.step_count
            if self.is_main and step % self.log_interval < k:
                log = {"train/loss": float(losses.mean()),
                       "train/learning_rate": float(self.lr_schedule(step))}
                # float() above waited for the chunk, so the time between
                # log events over their steps is the amortized rate.
                now = time.perf_counter()
                if self.track_time and self._last_log is not None:
                    t_prev, step_prev = self._last_log
                    log.update(self.logger.performance_metrics(
                        max(now - t_prev, 1e-9) / (step - step_prev),
                        self._batch_count(chunk[-1:]), self.device))
                self._last_log = (now, step)
                self.logger.log(log, step)
            if self.val_interval and step % self.val_interval < k:
                self._validate_and_save_best(step, epoch)
            if self._preempt_save(epoch):
                return True
        return False

    def _preempt_save(self, epoch: int) -> bool:
        """At a step boundary: when any rank was preempted, save the
        epoch's checkpoint and log it; returns whether it did."""
        if not self._preemption_agreed():
            return False
        self._save_epoch_checkpoint(epoch)
        self.logger.log({"train/preempted": 1.0}, self.step_count)
        return True

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
        counts = self.row_group is None or self.row_group.index == 0
        offset = 0
        with self.whole_params():
            for batch in loader:
                x, y = self._split_batch(batch)
                rows = self._rows(batch, x.shape[0])
                if x.shape[0]:
                    losses = self.model.loss_function(
                        x, generator=self._generator(offset, salt), y=y,
                        per_sample=True, rows=rows)
                    if counts:
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
        """Run the model with the EMA weights, then put the weights back
        (under model parallelism the EMA is gathered: every rank of the
        group enters together)."""
        was_whole = self._whole
        # The parameters whose values the block overwrites.
        held = [p for i, p in enumerate(self.params) if was_whole
                or self.sharding.plan[i] is None]
        with torch.no_grad():
            saved = [p.detach().clone() for p in held]
            if self.sharding is None:
                torch._foreach_copy_(self.params, self.ema)
            else:
                self.sharding.gather_(self.params, self.ema)
        self._whole = True
        try:
            yield
        finally:
            with torch.no_grad():
                if not was_whole:
                    self.sharding.free_(self.params)
                torch._foreach_copy_(held, saved)
            self._whole = was_whole

    def generate_samples(self, epoch: int, num_samples: int = 4,
                         use_ema: bool = False) -> str:
        """A grid of the sampler's intermediates, one row per sample,
        saved as ``samples/epoch_{epoch}.png`` by rank 0 (under model
        parallelism, inside :meth:`whole_params`, or with ``use_ema`` on
        every rank; under spatial parallelism on every rank of rank 0's
        spatial group, which split each image's rows)."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 99) * _SEED_STRIDE + epoch)
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            frames = self.model.generate_samples_with_intermediates(
                num_samples, gen)
        grid = frames_to_grid([f.cpu().numpy() for f in frames])
        path = self.output_dir / "samples" / f"epoch_{epoch}.png"
        if not self.is_main:
            return str(path)
        out = save_image(grid.astype(np.float32) / 127.5 - 1.0, str(path))
        self.logger.log_image("samples", grid, self.step_count)
        return out

    # ------------------------------------------------------------------
    def state(self, epoch: int) -> Dict[str, Any]:
        """The full training state on the CPU, as a checkpoint holds it
        (whole tensors: under model parallelism gathered from the
        shards, and every rank calls this)."""
        params, ema = self.params, self.ema
        if self.sharding is not None:
            params = self.sharding.whole(self.master)
            ema = self.sharding.whole(self.ema)
        return {
            "params": {n: p.detach().cpu().clone()
                       for n, p in zip(self.param_names, params)},
            "ema_params": {n: e.detach().cpu().clone()
                           for n, e in zip(self.param_names, ema)},
            "opt_state": self.optimizer.state_dict(),
            "step": self.step_count,
            "epoch": int(epoch),
            "best_val_loss": float(self.best_val_loss),
        }

    def shard_state(self, epoch: int) -> Dict[str, Any]:
        """This rank's part of :meth:`state` under model parallelism,
        with no collective: its shards of the sharded leaves (and the
        whole small ones), and each leaf's shard axis (None: whole)."""
        return {
            "params": {n: p.detach().cpu().clone()
                       for n, p in zip(self.param_names, self.master)},
            "ema_params": {n: e.detach().cpu().clone()
                           for n, e in zip(self.param_names, self.ema)},
            "opt_state": self.optimizer.state_dict(gather=False),
            "axes": dict(zip(self.param_names, self.sharding.plan)),
            "step": self.step_count,
            "epoch": int(epoch),
            "best_val_loss": float(self.best_val_loss),
        }

    def save_checkpoint(self, name: str, epoch: int) -> str:
        """Rank 0 writes the checkpoint; every rank waits until it is
        whole."""
        state = self._checkpoint_state(epoch)
        if self.is_main:
            self.ckpt.save(name, state)
        mesh.barrier()
        return str(self.ckpt.directory / name)

    def _checkpoint_state(self, epoch: int) -> Optional[Dict[str, Any]]:
        """:meth:`state` on rank 0 (on every rank under model parallelism,
        whose gathers need them all); None elsewhere."""
        if self.is_main or self.sharding is not None:
            return self.state(epoch)
        return None

    def _save_epoch_checkpoint(self, epoch: int) -> None:
        """``checkpoint_epoch_{epoch}``, then the pruning to
        ``keep_checkpoints``, on rank 0."""
        state = self._checkpoint_state(epoch)
        if self.is_main:
            self.ckpt.save(f"checkpoint_epoch_{epoch}", state)
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
        ema = [state["ema_params"][n] for n in self.param_names]
        if self.sharding is None:
            self.model.net.load_state_dict(state["params"], strict=True)
        else:   # every rank reads the whole file and keeps its shards
            if set(state["params"]) != set(self.param_names):
                raise KeyError(f"checkpoint {name} holds other parameters "
                               f"than the network")
            whole = [state["params"][n] for n in self.param_names]
            with torch.no_grad():
                for dst, src in zip(self.master,
                                    self.sharding.shards(whole)):
                    dst.copy_(src)
            ema = self.sharding.shards(ema)
        with torch.no_grad():
            for e, src in zip(self.ema, ema):
                e.copy_(src)
        self.optimizer.load_state_dict(state["opt_state"])
        if self.sharding is None:
            mesh.broadcast_([*self.params, *self.ema, *self.optimizer.mu,
                             *self.optimizer.nu])
        self.step_count = int(state["step"])
        self.best_val_loss = float(state["best_val_loss"])
        self.start_epoch = int(state["epoch"]) + 1
        return self.start_epoch

    def cleanup(self) -> None:
        self.logger.close()
