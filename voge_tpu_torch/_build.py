"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/voge_tpu_torch/lib<name>.so`` beside
the package, compiled by ``nvcc`` for ``sm_90a`` with a plain C interface (no
PyTorch headers, so a build takes seconds).  A library is rebuilt when any
source in ``csrc/`` is newer than it.  There is no fallback: a missing
``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "voge_tpu_torch"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Kernels whose results must equal their plain PyTorch versions bit for bit
# keep every product rounded once (see the notes in the sources).
_EXTRA_FLAGS = {"emit": ["-fmad=false"], "fine_select": ["-fmad=false"]}

_lock = threading.Lock()          # guards the dicts below
_name_locks: dict = {}            # one per library: builds run in parallel
_libs: dict = {}
# name -> (seconds spent compiling, nvcc's stderr: ptxas register/spill report)
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "voge_tpu_torch: nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
        "cannot be built"
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            if name in _libs:
                return _libs[name]
        src = _CSRC / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}.so"
        newest = max(p.stat().st_mtime for p in _CSRC.iterdir())
        if not out.exists() or out.stat().st_mtime < newest:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, *_EXTRA_FLAGS.get(name, []),
                   "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"voge_tpu_torch: nvcc failed for {src.name}:\n"
                    f"{' '.join(cmd)}\n{res.stderr}"
                )
            os.replace(tmp, out)
            with _lock:
                build_info[name] = (time.perf_counter() - t0, res.stderr)
        lib = ctypes.CDLL(str(out))
        with _lock:
            _libs[name] = lib
        return lib


def load_all(names) -> list:
    """Load several libraries, running their ``nvcc`` builds side by side."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load, names))
