"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/torch_kernels/`` at the repository root, then loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds.

The build happens at first use (or all at once, in parallel, through
:func:`build_all`). A library is named after a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused. A
failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}
#: Every :class:`Kernel`, by its name.
KERNELS: Dict[str, "Kernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (on PATH, under $CUDA_HOME or "
                       f"{DEFAULT_CUDA_HOME}): the port's CUDA kernels "
                       "cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(nvcc: str, name: str, target: Path) -> subprocess.Popen:
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Sequence[str] = ()) -> float:
    """Build every kernel not built yet, one ``nvcc`` per source, all
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [(n, _target(n)) for n in (names or kernel_names())]
        todo = [(n, t) for n, t in todo if not t.exists()]
        if not todo:
            return time.perf_counter() - t0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = [(n, t, _start(nvcc, n, t)) for n, t in todo]
        errors = []
        for n, t, p in procs:
            try:
                _finish(n, t, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


class Kernel:
    """One exported C launcher of a CUDA source, with its launch count.

    ``launches`` goes up by one each time the launcher is called and
    returns success; it is the evidence that a run went through the
    kernel. Calling raises if the launcher reports a CUDA error. ``name``
    (default: the symbol) keys :data:`KERNELS` and :func:`launch_counts`;
    a launcher whose routes are counted apart gets one Kernel per route,
    each with its own name.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 name: str = ""):
        self.source = source
        self.symbol = symbol
        self.name = name or symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[self.name] = self

    def __call__(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = fn(*args)
        if err != 0:
            describe = load(self.source).dmu_error_string
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.symbol} (csrc/{self.source}.cu) "
                               f"failed: CUDA error {err} "
                               f"({describe(err).decode()})")
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel so far in this process, by name."""
    return {name: k.launches for name, k in sorted(KERNELS.items())}
