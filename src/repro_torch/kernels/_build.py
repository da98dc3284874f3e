"""Build the hand-written CUDA kernels with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use, from the sources in the checkout only, into
``<repo>/build/repro_torch_kernels/lib<name>-<hash>.so`` for ``sm_90a``.  The
hash covers the source, every ``csrc`` header it includes (``#include
"..."``, followed recursively) and the flags, so editing a shared header
rebuilds every library that includes it.  :func:`build` starts one ``nvcc``
per source at once.  Nothing is compiled or loaded when a module is
imported; the CPU tests never compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# Every kernel library of the port, ``csrc/<name>.cu`` each.
SOURCES = ("tsar_matmul", "tsar_sparse", "tsar_lut")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc log (``-Xptxas -v`` register and shared-memory report) of the
# sources this process compiled.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the repro_torch kernels")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, recursively."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> None:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in names:
            target = _target(name)
            if target.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            jobs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, target, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)      # atomic: concurrent builders never see half a file
            build_logs[name] = log
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib
