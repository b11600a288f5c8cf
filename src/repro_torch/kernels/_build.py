"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/repro_torch/`` at the
root of the checkout (``.gitignore`` lists ``build/``), at first use.  The
file name carries a hash of the sources, so an edited kernel is rebuilt and a
built one is reused.  :func:`build` starts one ``nvcc`` per missing library,
all at once, so the build takes as long as the slowest source.

Nothing here runs at import: modules that wrap a kernel import this one on
machines without ``nvcc`` too, and only a launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan")
# -split-compile 0: each nvcc compiles its kernels on every core it finds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile", "0")

_loaded: Dict[str, Callable[..., int]] = {}    # name -> bound launcher


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries a
    hash of that source and of every shared header."""
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> Path:
    """The compiler's per-kernel register / shared-memory report."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, with one
    ``nvcc`` per source started together.  Returns the wall seconds taken;
    raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        ptxas_log(n).write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))    # atomic: never half a library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def launcher(name: str, argtypes: Sequence[type]) -> Callable[..., int]:
    """The C launcher ``repro_<name>`` of ``csrc/<name>.cu``, built, loaded
    and given its signature at first use; it returns the launch's
    ``cudaGetLastError()`` as an int."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), f"repro_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _loaded[name] = fn
    return fn
