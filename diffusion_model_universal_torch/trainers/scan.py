"""K optimizer steps as one captured CUDA graph (``training.scan_steps``;
the counterpart of the reference's ``train_step_scan``, ``_scan_chunk``
and ``_stack_chunk``, which fold K steps into one ``lax.scan``).

The trainer's chunk body (:meth:`DiffusionTrainer._scan_body`: K updates,
each its loss, autograd through K1/K2/K3, the norms, Adam and the EMA)
runs here in three ways, on the same inputs:

* on the CPU, eagerly: the plain version of the graph;
* on CUDA, the first chunk of a batch shape eagerly on the capture
  stream (these are the run's own updates: cuDNN picks its algorithms,
  cuBLAS and K2's ticket buffer get their workspaces on that stream);
* then, from the next chunk of that shape on, as one CUDA graph captured
  once into its private memory pool and replayed once a chunk.

What changes from one chunk to the next reaches the graph through static
buffers filled before each replay: the K batches (``[K, B, …]``, as the
reference's ``_stack_chunk``), each step's draws (t/ε, σ/ε, the Langevin
draws and α), made eagerly from the step's own generator as a single
step would make them, and the per-step scalars (Adam's
√(1−b2ᶜ) and −lr/(1−b1ᶜ), the EMA's decay). Dropout draws from the
default CUDA generator and the remat stages' generators, which the graph
advances at each replay as K eager steps would. A capture that fails
raises: nothing falls back to eager steps on the card.

The kernels' launch counters count their launchers' calls, so under
replay they count the capture's calls once; :attr:`StepGraphs.captured`
and :attr:`StepGraphs.replayed` hold what the captures recorded and what
the replays ran, by kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops._build import launch_counts

#: The reference's refusal of the two options together, word for word.
SCAN_ACCUM_EXCLUSIVE = (
    "training.scan_steps and training.grad_accum_steps are "
    "mutually exclusive: scan_steps amortizes dispatch over K "
    "optimizer steps, grad_accum_steps folds A micro-batches "
    "into one update — set one of them to 1")


def scan_refusal(scan_steps: int, device_type: str, backend: Optional[str],
                 model_parallel: int) -> Optional[str]:
    """Why ``scan_steps`` > 1 cannot run with this layout on this device,
    or None. On the card the chunk is captured, which gloo's collectives
    (host copies) and ``model_parallel``'s gathers and frees of the whole
    parameters around each update do not allow."""
    if scan_steps <= 1 or device_type != "cuda":
        return None
    if backend == "gloo":
        return ("training.scan_steps > 1 is not supported over a gloo "
                "process group on CUDA: gloo's collectives go through "
                "the host and cannot be captured in a CUDA graph (use "
                "NCCL, or scan_steps: 1)")
    if model_parallel > 1:
        return ("training.scan_steps > 1 is not supported with "
                "distributed.model_parallel > 1 on CUDA: each update "
                "gathers the whole parameters from their shards and frees "
                "them, which cannot be captured in a CUDA graph")
    return None


def _signature(chunk, draws) -> tuple:
    """What a captured graph is specific to: the batches' shapes, dtypes
    and rows, and the draws' shapes."""
    def sig(v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), v.dtype)
        if isinstance(v, (list, tuple)):
            return tuple(sig(e) for e in v)
        return v
    batches = tuple(tuple(sorted((k, sig(v)) for k, v in b.items()))
                    if isinstance(b, dict) else sig(b) for b in chunk)
    return (batches, tuple(tuple(sorted((k, sig(v)) for k, v in d.items()))
                           for d in draws))


class _Inputs:
    """A graph's static inputs: the K batches, their draws and scalars,
    each stacked along a leading K."""

    def __init__(self, chunk, draws, device):
        first, d0 = chunk[0], draws[0]
        self.is_dict = isinstance(first, dict)
        self.rows = [b.get("rows") if self.is_dict else None for b in chunk]
        image = first["image"] if self.is_dict else first
        label = first.get("label") if self.is_dict else None
        k = len(chunk)
        self.image = torch.empty((k, *image.shape), dtype=image.dtype,
                                 device=device)
        self.label = (None if label is None else torch.empty(
            (k, *label.shape), dtype=label.dtype, device=device))
        self.draws: Dict[str, torch.Tensor] = {}
        self.lists = set()
        for name, v in d0.items():
            if isinstance(v, (list, tuple)):
                self.lists.add(name)
                v = torch.stack(list(v))
            self.draws[name] = torch.empty((k, *v.shape), dtype=v.dtype,
                                           device=device)
        self.adam = torch.empty((k, 2), dtype=torch.float32, device=device)
        self.ema = torch.empty((k, 2), dtype=torch.float32, device=device)

    def fill(self, chunk, draws, adam, ema) -> None:
        torch.stack([b["image"] if self.is_dict else b for b in chunk],
                    out=self.image)
        if self.label is not None:
            torch.stack([b["label"] for b in chunk], out=self.label)
        for name, buf in self.draws.items():
            torch.stack([torch.stack(list(d[name])) if name in self.lists
                         else d[name] for d in draws], out=buf)
        self.adam.copy_(adam.pin_memory(), non_blocking=True)
        self.ema.copy_(ema.pin_memory(), non_blocking=True)

    def views(self):
        """(batches, draws) of the K steps as views of the buffers."""
        batches, draws = [], []
        for i in range(self.image.shape[0]):
            if self.is_dict:
                b = {"image": self.image[i]}
                if self.label is not None:
                    b["label"] = self.label[i]
                if self.rows[i] is not None:
                    b["rows"] = self.rows[i]
                batches.append(b)
            else:
                batches.append(self.image[i])
            draws.append({name: (list(buf[i].unbind(0)) if name in self.lists
                                 else buf[i])
                          for name, buf in self.draws.items()})
        return batches, draws


class StepGraphs:
    """The captured chunks of one trainer on CUDA, one graph a chunk
    signature (in practice one: every full chunk of a run has the same
    shapes)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.device = trainer.device
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: Dict[tuple, Any] = {}
        self._warm = set()
        self.captures = 0
        self.replays = 0
        #: Kernel launches recorded by the captures (not run by them) and
        #: run by the replays, by kernel name.
        self.captured: Dict[str, int] = {}
        self.replayed: Dict[str, int] = {}

    def run(self, chunk: List[Any], draws: List[Dict[str, Any]],
            adam: torch.Tensor, ema: torch.Tensor) -> torch.Tensor:
        """The chunk's K updates (``adam``, ``ema``: the host tables of
        their scalars); returns the per-step losses [K]."""
        from .optim import to_device
        key = _signature(chunk, draws)
        entry = self._graphs.get(key)
        if entry is None and key not in self._warm:
            self._warm.add(key)
            main = torch.cuda.current_stream(self.device)
            adam, ema = to_device(adam, self.device), to_device(ema,
                                                                self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                losses = self.trainer._scan_body(chunk, draws, adam, ema)
            main.wait_stream(self.stream)
            torch.cuda.synchronize(self.device)
            return losses
        if entry is None:
            entry = self._graphs[key] = self._capture(chunk, draws)
        graph, inputs, losses, launches = entry
        inputs.fill(chunk, draws, adam, ema)
        graph.replay()
        self.replays += 1
        for name, n in launches.items():
            self.replayed[name] = self.replayed.get(name, 0) + n
        return losses.clone()

    def _capture(self, chunk, draws):
        inputs = _Inputs(chunk, draws, self.device)
        batches, step_draws = inputs.views()
        graph = torch.cuda.CUDAGraph()
        remat = getattr(self.trainer.model.net, "remat_generators", None)
        for gen in (remat() if remat else []):
            graph.register_generator_state(gen)
        before = launch_counts()
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            losses = self.trainer._scan_body(batches, step_draws,
                                             inputs.adam, inputs.ema)
        after = launch_counts()
        launches = {name: n - before.get(name, 0)
                    for name, n in after.items() if n != before.get(name, 0)}
        for name, n in launches.items():
            self.captured[name] = self.captured.get(name, 0) + n
        self.captures += 1
        return graph, inputs, losses, launches

    def summary(self) -> Dict[str, Any]:
        return {"captures": self.captures, "replays": self.replays,
                "launches_per_replay": [e[3] for e in self._graphs.values()],
                "captured": dict(self.captured),
                "replayed": dict(self.replayed)}
