"""Data and model parallelism over ``torch.distributed`` (counterpart
of the reference's ``parallel/mesh.py``).

The reference lays its devices out as a (data, spatial, model) mesh; the
port runs one process per device, as the original PyTorch reference did
(``mp.spawn``, one process per GPU):

* :func:`make_layout` reads the config's ``distributed`` section with
  ``make_mesh``'s check (data × spatial × model must equal the device
  count), in the reference mesh's rank order: rank = d·S·M + s·M + m
  (:func:`data_index`, :func:`spatial_index`); ``spatial_parallel`` S > 1
  with ``model_parallel`` M > 1 is refused. The S ranks of a spatial
  group hold the same samples and split each image's rows
  (``parallel/spatial.py``).
* :func:`init_process_group` joins a group: NCCL on ``cuda`` (the rank's
  device made current), gloo on the CPU, with a timeout, so that a lost
  rank fails the run instead of hanging it, and a gloo group for host
  objects beside a NCCL one. :func:`init_from_env` joins from the
  environment ``torchrun`` sets (``--multihost``).
* :func:`spawn` is the ``--num_devices`` launcher: N ranks started with
  the ``spawn`` method, rank r on device r, joined through a ``file://``
  rendezvous in a fresh directory; when one rank fails it stops the
  others and raises.
* The collectives the trainer needs: a flat all-reduce sum of a list of
  tensors, an OR of a host flag, a broadcast from rank 0 and a barrier;
  and those the samplers need: a request object broadcast from rank 0
  and a gather of host arrays to it (:class:`Scope`).
* Sampling over ranks (:func:`sampling_scope`, :func:`split_rows`): each
  rank draws the global batch's noise and keeps its rows, so N ranks
  give one process's images. Under spatial parallelism a batch splits
  over the D data groups, not over all ranks.
* ``model_parallel`` M (:func:`shard_plan`, :class:`Sharding`): the
  reference's ``param_sharding`` rule shards every parameter of at least
  2¹⁶ elements along its largest dimension that M divides, over groups
  of M consecutive ranks (rank r holds shard r mod M of group r div M,
  the device order of the reference's mesh). The trainer keeps only its
  shards of the parameters, the EMA and Adam's moments between updates
  and gathers the whole parameters with broadcasts for an update; the
  batch's rows stay split over all ranks, so activations are divided as
  the reference's channel sharding divides them.

A process that has joined no group is rank 0 of 1, and every collective
is then a no-op. Every collective here is a broadcast or an all-reduce,
the two that gloo runs on CUDA tensors, so several gloo ranks may share
one card.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import tempfile
from multiprocessing.connection import wait
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import NOT_PORTED
from .spatial import NEXT_SLICE

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"

#: How long a collective waits for the other ranks before the run fails.
TIMEOUT = datetime.timedelta(minutes=30)
#: The gloo group for host objects and flags beside a NCCL default group
#: (None: the default group is gloo, or no group).
_HOST_GROUP = None
#: The variables ``torchrun`` sets for each process, which ``--multihost``
#: reads.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def make_layout(num_devices: int, data_parallel: Optional[int] = None,
                model_parallel: int = 1,
                spatial_parallel: int = 1) -> Dict[str, int]:
    """The (data, spatial, model) layout of ``num_devices`` devices:
    by default every device on the data axis. Raises as the reference's
    ``make_mesh`` does when the layout does not cover the devices, and
    for spatial parallelism together with model parallelism, which the
    port does not run yet."""
    if data_parallel is None:
        data_parallel = num_devices // (model_parallel * spatial_parallel)
    if data_parallel * model_parallel * spatial_parallel != num_devices:
        raise ValueError(
            f"mesh {data_parallel}x{spatial_parallel}x{model_parallel} "
            f"!= {num_devices} devices")
    if spatial_parallel > 1 and model_parallel > 1:
        raise ValueError(
            f"distributed.spatial_parallel {spatial_parallel} with "
            f"model_parallel {model_parallel} is {NOT_PORTED}: "
            f"{NEXT_SLICE}")
    return {DATA_AXIS: data_parallel, SPATIAL_AXIS: spatial_parallel,
            MODEL_AXIS: model_parallel}


def data_index(rank_: int, layout: Dict[str, int]) -> int:
    """The data group d of ``rank_`` (rank = d·S·M + s·M + m)."""
    return rank_ // (layout[SPATIAL_AXIS] * layout[MODEL_AXIS])


def spatial_index(rank_: int, layout: Dict[str, int]) -> int:
    """The index s of ``rank_`` in its spatial group."""
    return rank_ // layout[MODEL_AXIS] % layout[SPATIAL_AXIS]


def local_devices(limit: Optional[int] = None,
                  device_type: str = "cuda") -> List[torch.device]:
    """This host's devices, the first ``limit`` of them when given (all
    of them when ``limit`` exceeds the count): the ``--num_devices``
    contract. On the CPU every rank is a process of the host, so there
    are ``limit`` (default 1)."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (limit or 1)
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    return devices[:limit] if limit else devices


def init_process_group(rank: int, world_size: int, device: torch.device,
                       init_method: str = "env://",
                       backend: Optional[str] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size`` on
    ``device``: NCCL on ``cuda`` and gloo on the CPU unless ``backend``
    names another (gloo lets several ranks share one card); beside a NCCL
    group, a gloo one for host objects and flags."""
    global _HOST_GROUP
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=world_size,
        timeout=TIMEOUT)
    _HOST_GROUP = (None if dist.get_backend() == "gloo"
                   else dist.new_group(backend="gloo"))


def init_from_env(device_type: str) -> torch.device:
    """Join the group ``torchrun`` describes in the environment, on
    ``cuda:LOCAL_RANK`` (or the CPU); returns the rank's device."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise SystemExit(
            f"--multihost joins the process group from the environment "
            f"torchrun sets ({', '.join(TORCHRUN_ENV)}); missing "
            f"{', '.join(missing)}. Launch with torchrun --nproc_per_node "
            f"N -m diffusion_model_universal_torch.scripts.train "
            f"--multihost ...")
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
              if device_type == "cuda" else torch.device("cpu"))
    init_process_group(int(os.environ["RANK"]),
                       int(os.environ["WORLD_SIZE"]), device)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 (the reference gates logging and checkpoints on it)."""
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


@torch.no_grad()
def _flat_apply(tensors: Sequence[torch.Tensor], op) -> None:
    """``op`` on one flat buffer per dtype of ``tensors``, copied back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks in place, one all-reduce per dtype.
    Every rank gets the same bits."""
    if is_initialized():
        _flat_apply(tensors, dist.all_reduce)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place."""
    if is_initialized():
        _flat_apply(tensors, lambda flat: dist.broadcast(flat, src))


def any_flag(flag: bool) -> bool:
    """True when ``flag`` is true on any rank (through the host gloo
    group)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def gather(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order (picklable objects)."""
    if not is_initialized():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any = None) -> Any:
    """Rank 0's ``obj`` (a picklable request) on every rank, through the
    host group."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    global _HOST_GROUP
    if is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


# -- sampling over ranks ---------------------------------------------------

def split_rows(n: int, rank_: int, world: int):
    """``(lo, hi, n)``: rank ``rank_``'s rows of a batch of ``n`` split
    over ``world`` ranks, [r·n/N, (r+1)·n/N) rounded down (ragged when N
    does not divide n; a rank may get none, and still joins every
    collective)."""
    return (rank_ * n // world, (rank_ + 1) * n // world, n)


class Scope(NamedTuple):
    """The ranks that sample together: this rank's index among ``world``
    of them, and their gloo ``group`` (None: the host group). Rank 0 of
    the scope is rank 0 of the process group."""

    rank: int
    world: int
    group: Any = None
    #: Ranks of a spatial group (consecutive ranks), which hold the same
    #: samples: each group samples its data group's rows.
    spatial: int = 1

    def rows(self, n: int):
        """This rank's ``(lo, hi, n)`` of a batch of ``n``: its data
        group's rows."""
        return split_rows(n, self.rank // self.spatial,
                          self.world // self.spatial)

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every data group's ``obj`` (host arrays) once, from the first
        rank of each spatial group, in rank order, on rank 0; None on the
        others."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0,
                           group=(self.group if self.group is not None
                                  else _HOST_GROUP))
        return out[::self.spatial] if out is not None else None


def sampling_scope(local_world: Optional[int] = None,
                   spatial: int = 1) -> Optional[Scope]:
    """The ranks that split a sampling batch: every rank of the group, or,
    with ``local_world``, ranks 0 … ``local_world``−1 (rank 0's host under
    ``--multihost``, as the reference samples on its process-local mesh);
    None on a rank outside them. ``spatial``: the ranks form spatial
    groups of that many, each group sampling its data group's rows.
    Every rank must call this, in the same order (it may make a group)."""
    world = world_size()
    if local_world is None or local_world >= world:
        return Scope(rank(), world, spatial=spatial)
    group = dist.new_group(ranks=list(range(local_world)), backend="gloo")
    return Scope(rank(), local_world, group, spatial) \
        if rank() < local_world else None


# -- model parallelism -----------------------------------------------------

#: The reference's ``param_sharding`` shards leaves of at least this many
#: elements.
MIN_SIZE_TO_SHARD = 2 ** 16


def shard_plan(net: torch.nn.Module, model_parallel: int
               ) -> List[Optional[int]]:
    """The reference's ``param_sharding`` rule for ``net``'s parameters
    (in ``named_parameters`` order) over a model axis of
    ``model_parallel``: a leaf of at least ``MIN_SIZE_TO_SHARD`` elements
    is sharded along its largest flax dimension that the axis divides
    (ties to the first), mapped through ``models/convert.py``'s layouts
    to an axis of the port's tensor; others (and all at an axis of 1)
    stay whole (None). An axis that the layouts read in reverse (a
    transposed conv's spatial axes) would reverse the blocks too, and is
    refused: the port's transposed convs shard along a channel axis."""
    from ..models.convert import flax_layout
    plan: List[Optional[int]] = []
    for key, p in net.named_parameters():
        prefix, _, name = key.rpartition(".")
        _, perm, flips = flax_layout(net.get_submodule(prefix), key, name,
                                     p.ndim)
        dims = [p.shape[a] for a in perm]
        axis = None
        if model_parallel > 1 and p.numel() >= MIN_SIZE_TO_SHARD:
            for k in sorted(range(len(dims)), key=lambda i: -dims[i]):
                if dims[k] % model_parallel == 0:
                    axis = perm[k]
                    break
        if axis in flips:
            raise NotImplementedError(
                f"{key}: sharding along a flipped axis {axis}")
        plan.append(axis)
    return plan


def shard_block(whole: torch.Tensor, axis: int, model_parallel: int,
                index: int) -> torch.Tensor:
    """Block ``index`` of ``model_parallel`` of ``whole`` along ``axis``
    (a view): the elements the reference's device ``index`` of the model
    axis holds of the same leaf."""
    size = whole.shape[axis] // model_parallel
    return whole.narrow(axis, index * size, size)


class Sharding:
    """Parameters (and tensors shaped like them) sharded over this rank's
    group of ``model_parallel`` consecutive ranks by ``plan``: rank r
    holds block r mod M of each sharded leaf.

    :meth:`shards` cuts whole tensors to this rank's blocks (views);
    :meth:`gather_` rebuilds whole tensors from every owner's blocks, with
    one broadcast from each owner on one flat buffer per dtype (gloo runs
    broadcasts on CUDA tensors, so the ranks may share a card);
    :meth:`free_` drops the whole parameters' storage between updates.
    Every rank must build this at the same point (it makes the groups).
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 plan: Sequence[Optional[int]], model_parallel: int):
        world = world_size()
        m = model_parallel
        if m < 2 or world % m:
            raise ValueError(f"distributed.model_parallel {m} needs a "
                             f"multiple of {m} ranks, got {world}")
        self.plan = list(plan)
        self.model_parallel = m
        self.index = rank() % m
        first = rank() - self.index
        self.owners = list(range(first, first + m))
        self.group = None
        if world > m:   # one group of M ranks per data replica
            for g in range(world // m):
                grp = dist.new_group(ranks=list(range(g * m, (g + 1) * m)))
                if g * m == first:
                    self.group = grp
        self._layouts = [torch.empty_like(p, device="meta") for p in params]

    def _block(self, i: int, whole: torch.Tensor, owner: int
               ) -> torch.Tensor:
        return shard_block(whole, self.plan[i], self.model_parallel, owner)

    def shards(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's block of each of ``tensors`` (whole for the leaves
        that are not sharded)."""
        return [t if spec is None else self._block(i, t, self.index)
                for i, (t, spec) in enumerate(zip(tensors, self.plan))]

    @torch.no_grad()
    def gather_(self, wholes: Sequence[torch.Tensor],
                parts: Sequence[torch.Tensor]) -> None:
        """Fill ``wholes`` from every owner's ``parts`` (this rank's blocks
        or whole leaves, as :meth:`shards` gives them); a whole parameter
        whose storage was freed gets it back first."""
        sharded: Dict[torch.dtype, List[int]] = {}
        for i, (w, part) in enumerate(zip(wholes, parts)):
            if self.plan[i] is None:
                if w is not part:
                    w.copy_(part)
                continue
            if w.numel() == 0:
                w.data = torch.empty_like(self._layouts[i], device=part.device)
            sharded.setdefault(part.dtype, []).append(i)
        for dtype, idx in sharded.items():
            sizes = [parts[i].numel() for i in idx]
            for j, src in enumerate(self.owners):
                if j == self.index:
                    flat = torch.cat([parts[i].reshape(-1) for i in idx])
                else:
                    flat = torch.empty(sum(sizes), dtype=dtype,
                                       device=parts[idx[0]].device)
                dist.broadcast(flat, src, group=self.group)
                for i, piece in zip(idx, flat.split(sizes)):
                    block = self._block(i, wholes[i], j)
                    block.copy_(piece.view(block.shape))

    def whole(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """New whole tensors gathered from ``parts`` (whole leaves are
        returned as they are)."""
        wholes = [p if spec is None else
                  torch.empty_like(layout, dtype=p.dtype, device=p.device)
                  for p, spec, layout in zip(parts, self.plan,
                                             self._layouts)]
        self.gather_(wholes, parts)
        return wholes

    def free_(self, params: Sequence[torch.Tensor]) -> None:
        """Drop the storage of the sharded leaves of ``params``."""
        for p, spec in zip(params, self.plan):
            if spec is not None:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)


# -- the --num_devices launcher --------------------------------------------

def _run_rank(rank_: int, nprocs: int, device: torch.device,
              init_method: str, backend_: Optional[str], threads: int,
              fn: Callable[..., Optional[int]], args: Sequence[Any],
              codes) -> None:
    if device.type == "cpu":
        torch.set_num_threads(threads)
    init_process_group(rank_, nprocs, device, init_method, backend_)
    try:
        codes[rank_] = int(fn(device, *args) or 0)
    finally:
        shutdown()


def spawn(fn: Callable[..., Optional[int]], nprocs: int,
          args: Sequence[Any] = (), device_type: str = "cuda",
          backend: Optional[str] = None,
          rendezvous_dir: Optional[str] = None) -> int:
    """Run ``fn(device, *args)`` on ``nprocs`` ranks, each a process
    started with the ``spawn`` method in the group :func:`init_process_group`
    makes (``backend``: see there), rank r on ``cuda:(r mod cards)`` or
    the CPU. ``fn`` must be importable by name, and return the rank's
    exit code (None: 0). Returns the code the ranks agree on. A SIGTERM
    to this process is passed on to every rank. When a rank fails, the
    others are stopped and this raises. CPU ranks share this process's
    intra-op threads, and their BLAS and OpenMP pools are sized to their
    share (a pool of every core in each rank spins them against each
    other)."""
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("CUDA was asked for but no card is visible")
        if nprocs > cards and (backend or "nccl") == "nccl":
            raise ValueError(f"{nprocs} NCCL ranks need {nprocs} cards; "
                             f"{cards} visible")
        devices = [torch.device("cuda", r % cards) for r in range(nprocs)]
    else:
        devices = [torch.device("cpu")] * nprocs
    ctx = torch.multiprocessing.get_context("spawn")
    codes = ctx.Array("i", [-1] * nprocs)
    tmp = tempfile.mkdtemp(prefix="dmu_rendezvous_", dir=rendezvous_dir)
    init_method = f"file://{os.path.join(tmp, 'store')}"
    threads = max(1, torch.get_num_threads() // nprocs)
    procs = [ctx.Process(target=_run_rank, name=f"rank{r}",
                         args=(r, nprocs, devices[r], init_method, backend,
                               threads, fn, tuple(args), codes))
             for r in range(nprocs)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not in the main thread
        prev = None
    # A spawned rank reads these when it imports numpy and torch.
    pools = ({k: str(threads) for k in ("OMP_NUM_THREADS",
                                        "OPENBLAS_NUM_THREADS")}
             if device_type == "cpu" else {})
    saved = {k: os.environ.get(k) for k in pools}
    try:
        os.environ.update(pools)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        pending = list(procs)
        while pending:
            wait([p.sentinel for p in pending])
            for r, p in enumerate(procs):
                if p in pending and p.exitcode is not None:
                    pending.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(
                            f"rank {r} of {nprocs} exited with code "
                            f"{p.exitcode}; the other ranks were stopped")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(tmp, ignore_errors=True)
    found = set(codes[:])
    if len(found) != 1:
        raise RuntimeError(f"the ranks returned different codes: "
                           f"{list(codes[:])}")
    return found.pop()
