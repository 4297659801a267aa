"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``stan4bart_torch/csrc/<name>.cu`` exposes a plain C
launcher.  It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/stan4bart_torch/`` at the root of the
checkout on first use, and loaded with ``ctypes``.  The library
``<name>_f64`` is the same source's double-precision build (compiled with
``S4B_F64``: state in double, C symbols ending in ``_f64``), a library
and an nvcc process of its own.  The library's file name carries a hash
of the source, of every ``csrc`` header it includes and of the flags, so
an edited source or header is rebuilt.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stan4bart_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels round each operation as
    # their plain PyTorch versions do
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# the suffix of a kernel's double-precision build
F64 = "_f64"

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc is required to build the CUDA kernels")
    return nvcc


def source(name: str) -> Path:
    """The source of kernel library ``name`` (``<source>_f64``: the
    double-precision build of ``<source>.cu``)."""
    return CSRC / f"{name.removesuffix(F64)}.cu"


def flags(name: str) -> list[str]:
    """nvcc's flags for kernel library ``name``."""
    return NVCC_FLAGS + (["-DS4B_F64"] if name.endswith(F64) else [])


def sources(name: str) -> list[Path]:
    """The source of kernel library ``name`` and the ``csrc`` files it
    includes, directly or through another include, in the order first
    met."""
    out: list[Path] = []
    todo = [source(name)]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: list[str], verbose: bool = False) -> dict[str, float]:
    """Compile the kernels ``names`` that are not built already, one nvcc
    process each, all started together.  Returns each kernel's build
    seconds (0.0 for a library already present); raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds, failed = {}, {}, []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if verbose and log:
            print(log, flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
