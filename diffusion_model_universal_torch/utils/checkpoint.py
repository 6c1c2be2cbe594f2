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


def read_state(path: str) -> Dict[str, Any]:
    """Read the state of the checkpoint directory ``path``."""
    p = Path(path)
    state_file = p / STATE_FILE
    if not state_file.exists():
        if p.is_dir() and any(p.iterdir()):
            raise ValueError(
                f"{p} is not a checkpoint of the torch package (no "
                f"{STATE_FILE}); the JAX package's Orbax checkpoints are "
                "not read by the port. Export the weights with the JAX "
                "package to a model-only .ckpt instead")
        raise FileNotFoundError(f"checkpoint not found: {p}")
    state = torch.load(state_file, map_location="cpu", weights_only=False)
    if state.get("format") != FORMAT:
        raise ValueError(f"{state_file}: unknown checkpoint format "
                         f"{state.get('format')!r}")
    return state


class CheckpointManager:
    """Save/restore named checkpoints under one run directory."""

    def __init__(self, directory: str, config: Optional[Dict] = None):
        self.directory = Path(directory).absolute()
        self.config = config or {}
        self.directory.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, state: Dict[str, Any]) -> str:
        """Write ``<dir>/<name>/state.pt`` (replacing an older one whole:
        written to a temporary file, then renamed) and ``config.json``."""
        path = self.directory / name
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f"{STATE_FILE}.{os.getpid()}.tmp"
        torch.save(dict(state, format=FORMAT), tmp)
        os.replace(tmp, path / STATE_FILE)
        with open(self.directory / "config.json", "w") as f:
            json.dump(self.config, f, indent=2, default=str)
        return str(path)

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
