"""Config loading for the port.

A copy of the parts of the reference's ``utils/config.py`` the serving and
training paths need: the ``2e-4``-tolerant YAML loader, model-config key
canonicalization, ``${a.b}`` interpolation, the per-dataset block of the
shared data config and ``print_config``. Kept as a copy so the port never
imports the JAX package; the port ships its own copy of
``configs/data_config.yaml`` (a test holds it equal to the reference's).
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

# Canonical name <- accepted aliases (reference YAML spelling first).
_MODEL_KEY_ALIASES: Dict[str, tuple] = {
    "num_timesteps": ("time_steps", "timesteps"),
    "model_channels": ("hidden_channels",),
    "in_channels": ("image_channels",),
}


class _SciLoader(yaml.SafeLoader):
    """SafeLoader that parses ``2e-4``-style floats.

    YAML 1.1 (PyYAML) requires a mantissa dot (``2.0e-4``); the shipped
    configs write ``learning_rate: 2e-4``, which PyYAML would load as a
    string. Such scalars resolve as floats here.
    """


_SciLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict."""
    with open(config_path, "r") as f:
        return yaml.load(f, Loader=_SciLoader)


def canonicalize_model_config(model_config: Optional[Dict[str, Any]]
                              ) -> Dict[str, Any]:
    """Return a copy of ``model_config`` with alias keys resolved
    (``time_steps`` → ``num_timesteps``, ``hidden_channels`` →
    ``model_channels``, ``image_channels`` → ``in_channels``). Canonical
    keys win if both spellings are present."""
    cfg = copy.deepcopy(model_config) if model_config else {}
    for canonical, aliases in _MODEL_KEY_ALIASES.items():
        if canonical not in cfg:
            for alias in aliases:
                if alias in cfg:
                    cfg[canonical] = cfg[alias]
                    break
    return cfg


def resolve_interpolations(config: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``${a.b}``-style string interpolations against the root
    config. Unresolvable references are left as-is."""

    def lookup(path: str) -> Any:
        node: Any = config
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    def resolve(value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            out = value
            while "${" in out:
                start = out.index("${")
                end = out.index("}", start)
                ref = out[start + 2: end]
                repl = lookup(ref)
                if repl is None:
                    break
                out = out[:start] + str(repl) + out[end + 1:]
            return out
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value

    return {k: resolve(v) for k, v in config.items()}


def load_data_config(config_path: str, dataset_name: str) -> Dict[str, Any]:
    """The ``datasets[dataset_name]`` block of the shared data config."""
    with open(config_path, "r") as f:
        data_config = yaml.safe_load(f)
    datasets = data_config.get("datasets", {})
    if dataset_name not in datasets:
        raise KeyError(f"Dataset '{dataset_name}' not found in "
                       f"{config_path}; available: {sorted(datasets)}")
    return datasets[dataset_name]


def default_data_config_path() -> str:
    """Path of the port's packaged ``data_config.yaml``."""
    return str(Path(__file__).resolve().parent.parent / "configs"
               / "data_config.yaml")


def print_config(title: str, config: Dict[str, Any], indent: int = 0) -> None:
    """Pretty-print a nested config dict."""
    if indent == 0:
        bar = "=" * 60
        print(f"\n{bar}\n{title}\n{bar}")
    for key, value in config.items():
        pad = "  " * indent
        if isinstance(value, dict):
            print(f"{pad}{key}:")
            print_config(title, value, indent + 1)
        else:
            print(f"{pad}{key}: {value}")
    if indent == 0:
        print("=" * 60 + "\n")
