"""Build and load the port's CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. The libraries go to
``paddle_tpu_torch/build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
at its next use and an unchanged one is loaded as it is.

:func:`build_all` compiles every source at once, one ``nvcc`` process per
file, all started together; :func:`load` builds one source on first use.
Nothing is built when this module is imported.

:func:`refuse_export` is called by every wrapper on its CUDA branch,
before it launches its kernel: under :func:`exporting` (which
``inference.export_program`` enters around ``torch.export``) it raises,
naming the kernel, since ``torch.export`` cannot trace a ``ctypes`` call
and the wrapper must not fall back to its plain version on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build_all",
           "load", "exporting", "refuse_export", "ExportRefused"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_exporting = [0]  # depth of nested exporting() blocks


class ExportRefused(RuntimeError):
    """An export met a hand-written kernel (its message names it)."""


@contextlib.contextmanager
def exporting():
    """While this block runs, a kernel wrapper's CUDA branch raises
    :class:`ExportRefused` instead of launching (:func:`refuse_export`)."""
    _exporting[0] += 1
    try:
        yield
    finally:
        _exporting[0] -= 1


def refuse_export(kernel: str) -> None:
    """Raise :class:`ExportRefused` naming ``kernel`` inside
    :func:`exporting`; nothing otherwise."""
    if _exporting[0]:
        raise ExportRefused(
            "export_program: the step reaches the hand-written CUDA kernel "
            "%s, a ctypes call torch.export cannot trace; it is not "
            "replaced by its plain version on the card. Export a program "
            "whose path on the card has no hand-written kernel, or export "
            "on the CPU" % kernel)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (src.stem, h.hexdigest()[:16]))


def _start(src: Path):
    """Start ``nvcc`` for ``src`` into a temporary file beside its target;
    returns ``(process, tmp, target)``, or None when the target exists."""
    target = _lib_path(src)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, target


def _finish(src: Path, job) -> None:
    proc, tmp, target = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d) building %s:\n%s%s"
                           % (proc.returncode, src.name, out, err))
    os.replace(tmp, target)  # atomic: a reader never sees a partial .so


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, float]:
    """Compile every ``csrc/*.cu`` that has no current library, all in
    parallel; returns the seconds each build took (0.0 when the library
    was already current). Raises ``RuntimeError`` with nvcc's output when
    a build fails."""
    t0 = time.perf_counter()
    jobs = {src: _start(src) for src in _sources()}
    secs = {}
    for src, job in jobs.items():
        if job is not None:
            _finish(src, job)
        secs[src.stem] = 0.0 if job is None else time.perf_counter() - t0
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        src = SRC_DIR / (name + ".cu")
        if not src.exists():
            raise FileNotFoundError("no kernel source %s" % src)
        job = _start(src)
        if job is not None:
            _finish(src, job)
        lib = ctypes.CDLL(str(_lib_path(src)))
        _loaded[name] = lib
    return lib
