# ported from paddle_tpu/native/__init__.py
"""Native (C++) host libraries, built with ``g++`` at first use and loaded
with ``ctypes``.

The reference keeps its data plane native (recordio/, buffered_reader.cc,
data_feed.cc); this package holds the port's own copies of those sources.
A library is built into ``paddle_tpu_torch/build/`` (git-ignored), never
beside its source, under a name that carries a hash of the source and the
flags, as ``ops/kernels/_build.py`` names the CUDA kernels: an edited
source is rebuilt at its next use, an unchanged one loaded as it is. A
build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["SRC_DIR", "BUILD_DIR", "CXX_FLAGS", "build_and_load"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS = {}


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (src.stem, h.hexdigest()[:16]))


def build_and_load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cc``, compiled first when no
    library of its current source exists."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = SRC_DIR / (name + ".cc")
        target = _lib_path(src)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
            os.close(fd)
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(src),
                   "-o", tmp]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError("native build failed (exit %d): %s\n%s%s"
                                   % (r.returncode, " ".join(cmd), r.stdout,
                                      r.stderr))
            os.replace(tmp, target)  # a reader never sees a partial .so
        lib = _LIBS[name] = ctypes.CDLL(str(target))
        return lib
