"""Full-state trainer checkpoints of the port (counterpart of the
reference's ``utils/checkpoint.py::CheckpointManager``).

A checkpoint is a directory ``<run>/checkpoints/<name>/`` holding
``state.pt``, a ``torch.save`` of

    {params, ema_params, opt_state, step, epoch, best_val_loss}

(``params`` and ``ema_params`` are the UNet's state_dict tensors on the
CPU, ``opt_state`` the Adam state), plus a sidecar ``config.json`` in the
checkpoints directory. The names and policies are the reference's:
``checkpoint_epoch_{N}``, ``best_model``, ``emergency_checkpoint_epoch_{N}``,
``final_model``, the newest ``checkpoint_epoch_*`` for ``--resume latest``,
and pruning of the periodic ones. The reference's checkpoints are Orbax
directories, which the port neither reads nor writes: given one, it raises.

Under ``distributed.model_parallel`` M the emergency checkpoint is written
by each rank alone, as ``shard_{i}_of_{M}.pt`` files that hold shard i of
each sharded leaf (of the parameters, the EMA and Adam's moments) and its
axis; reading the directory joins a full set into the state above.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
FORMAT = "dmu-torch-trainer-v1"


def _load(path: Path) -> Dict[str, Any]:
    state = torch.load(path, map_location="cpu", weights_only=False)
    if state.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{state.get('format')!r}")
    return state


def join_shards(path: Path) -> Dict[str, Any]:
    """The state of one process from the ``shard_{i}_of_{M}.pt`` files in
    ``path`` (every i of M must be there): each sharded leaf the
    concatenation of its M shards along its axis."""
    found = {}
    for f in path.glob("shard_*_of_*.pt"):
        m = re.match(r"shard_(\d+)_of_(\d+)\.pt$", f.name)
        if m:
            found[(int(m.group(2)), int(m.group(1)))] = f
    counts = {m for m, _ in found}
    if len(counts) != 1:
        raise ValueError(f"{path}: shards of model_parallel {sorted(counts)}")
    (m,) = counts
    missing = [i for i in range(m) if (m, i) not in found]
    if missing:
        raise FileNotFoundError(
            f"{path}: shards {missing} of {m} were not written (their "
            "ranks stopped before saving); resume from a checkpoint_epoch_*")
    parts = [_load(found[(m, i)]) for i in range(m)]
    first = parts[0]

    def join(name, pieces):
        axis = first["axes"][name]
        return pieces[0] if axis is None else torch.cat(pieces, axis)

    names = list(first["axes"])
    state = {k: first[k] for k in ("step", "epoch", "best_val_loss")}
    for key in ("params", "ema_params"):
        state[key] = {n: join(n, [s[key][n] for s in parts]) for n in names}
    opt = dict(first["opt_state"])
    for key in ("mu", "nu"):
        opt[key] = [join(n, [s["opt_state"][key][i] for s in parts])
                    for i, n in enumerate(names)]
    state["opt_state"] = opt
    return state


def read_state(path: str) -> Dict[str, Any]:
    """Read the state of the checkpoint directory ``path`` (joining its
    shards when it holds them instead)."""
    p = Path(path)
    state_file = p / STATE_FILE
    if not state_file.exists() and any(p.glob("shard_*_of_*.pt")):
        return join_shards(p)
    if not state_file.exists():
        if p.is_dir() and any(p.iterdir()):
            raise ValueError(
                f"{p} is not a checkpoint of the torch package (no "
                f"{STATE_FILE}); the JAX package's Orbax checkpoints are "
                "not read by the port. Export the weights with the JAX "
                "package to a model-only .ckpt instead")
        raise FileNotFoundError(f"checkpoint not found: {p}")
    return _load(state_file)


class CheckpointManager:
    """Save/restore named checkpoints under one run directory."""

    def __init__(self, directory: str, config: Optional[Dict] = None):
        self.directory = Path(directory).absolute()
        self.config = config or {}
        self.directory.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, state: Dict[str, Any],
             file: str = STATE_FILE) -> str:
        """Write ``<dir>/<name>/<file>`` (replacing an older one whole:
        written to a temporary file, then renamed) and ``config.json``."""
        path = self.directory / name
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f"{file}.{os.getpid()}.tmp"
        torch.save(dict(state, format=FORMAT), tmp)
        os.replace(tmp, path / file)
        with open(self.directory / "config.json", "w") as f:
            json.dump(self.config, f, indent=2, default=str)
        return str(path)

    def save_shard(self, name: str, index: int, model_parallel: int,
                   state: Dict[str, Any]) -> str:
        """Write shard ``index`` of ``model_parallel`` of checkpoint
        ``name`` (a trainer's ``shard_state``); the replicas of one
        shard write the same file."""
        return self.save(name, state,
                         file=f"shard_{index}_of_{model_parallel}.pt")

    def restore(self, name: str) -> Dict[str, Any]:
        return read_state(str(self.directory / name))

    def _epoch_checkpoints(self) -> List:
        out = []
        for p in self.directory.glob("checkpoint_epoch_*"):
            m = re.match(r"checkpoint_epoch_(\d+)$", p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def latest_epoch_checkpoint(self) -> Optional[str]:
        """Name of the newest ``checkpoint_epoch_{N}`` (for --resume)."""
        found = self._epoch_checkpoints()
        return found[-1][1].name if found else None

    def prune_epoch_checkpoints(self, keep: int) -> List[str]:
        """Delete all but the newest ``keep`` periodic checkpoints
        (``best_model``, emergency saves and ``final_model`` are exempt)."""
        if keep <= 0:
            return []
        removed = []
        for _, p in self._epoch_checkpoints()[:-keep]:
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
        return removed

    def exists(self, name: str) -> bool:
        return (self.directory / name / STATE_FILE).exists()

    def load_config(self) -> Dict[str, Any]:
        with open(self.directory / "config.json") as f:
            return json.load(f)
