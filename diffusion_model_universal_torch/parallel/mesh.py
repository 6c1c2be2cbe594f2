"""Data parallelism over ``torch.distributed`` (counterpart of the
reference's ``parallel/mesh.py``).

The reference lays its devices out as a (data, spatial, model) mesh and
implements data parallelism on it; the port implements the same data
parallelism with one process per device, as the original PyTorch
reference did (``mp.spawn``, one process per GPU):

* :func:`make_layout` reads the config's ``distributed`` section with
  ``make_mesh``'s check (data × spatial × model must equal the device
  count); ``model_parallel`` or ``spatial_parallel`` > 1 (tensor, FSDP
  and spatial parallelism) is refused.
* :func:`init_process_group` joins a group: NCCL on ``cuda`` (the rank's
  device made current), gloo on the CPU, with a timeout, so that a lost
  rank fails the run instead of hanging it. :func:`init_from_env` joins
  from the environment ``torchrun`` sets (``--multihost``).
* :func:`spawn` is the ``--num_devices`` launcher: N ranks started with
  the ``spawn`` method, rank r on device r, joined through a ``file://``
  rendezvous in a fresh directory; when one rank fails it stops the
  others and raises.
* The collectives the trainer needs: a flat all-reduce sum of a list of
  tensors, an OR of a host flag, a broadcast from rank 0 and a barrier.

A process that has joined no group is rank 0 of 1, and every collective
is then a no-op.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import tempfile
from multiprocessing.connection import wait
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import NOT_PORTED

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"

#: How long a collective waits for the other ranks before the run fails.
TIMEOUT = datetime.timedelta(minutes=30)
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
    for the axes the port does not run yet."""
    if data_parallel is None:
        data_parallel = num_devices // (model_parallel * spatial_parallel)
    if data_parallel * model_parallel * spatial_parallel != num_devices:
        raise ValueError(
            f"mesh {data_parallel}x{spatial_parallel}x{model_parallel} "
            f"!= {num_devices} devices")
    for key, value in (("model_parallel", model_parallel),
                       ("spatial_parallel", spatial_parallel)):
        if value > 1:
            raise ValueError(f"distributed.{key} > 1 is {NOT_PORTED}")
    return {DATA_AXIS: data_parallel, SPATIAL_AXIS: spatial_parallel,
            MODEL_AXIS: model_parallel}


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
    names another (gloo lets several ranks share one card)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=world_size,
        timeout=TIMEOUT)


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


def new_flag_group():
    """A gloo group for host flags (None: the default group is gloo
    already). Every rank must call this, in the same order."""
    if not is_initialized() or backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def any_flag(flag: bool, group=None) -> bool:
    """True when ``flag`` is true on any rank (through ``group``, a group
    from :func:`new_flag_group`, on the host)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def gather(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order (picklable objects)."""
    if not is_initialized():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


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
    intra-op threads."""
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
    try:
        for p in procs:
            p.start()
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
