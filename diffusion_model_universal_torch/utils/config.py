"""Config loading for the port.

A copy of the parts of the reference's ``utils/config.py`` the serving
path needs: the ``2e-4``-tolerant YAML loader, model-config key
canonicalization, and ``${a.b}`` interpolation. Kept as a copy so the
port never imports the JAX package.
"""

from __future__ import annotations

import copy
import re
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
