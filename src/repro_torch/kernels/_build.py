"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source has a plain C interface and is compiled on its own by nvcc
for Hopper into a shared library, then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

No `--use_fast_math`: the selection kernel's masks must match the plain
version bitwise, which needs IEEE division. Libraries go to
`build/repro_torch_kernels/` under the repository root (git-ignored),
named by a hash of the source and flags, so an edited source rebuilds
and an unchanged one is reused; ptxas's report of each kernel's
registers, shared memory and spills (`-Xptxas -v`) is kept beside the
library (`ptxas_report`). Nothing is built at import time: the first
launch (or `build_all`) compiles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("rewafl_select", "fedavg", "flash_attention", "slstm", "stat_util")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one nvcc per
    source, all started together. Returns name → library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: lib_path(n) for n in names}
    procs = []
    for n in names:
        if out[n].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
        else:
            out[n].with_suffix(".log").write_text(log)
            os.replace(tmp, out[n])   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """What ptxas said when kernel `name` was built (registers, shared
    memory and spills of each function), after `build_all`."""
    return lib_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _loaded[name]
