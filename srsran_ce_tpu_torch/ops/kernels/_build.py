"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` is compiled on its own (one nvcc process per source,
all started together) into a shared library with a plain C interface,
`_build/lib<name>_<hash>.so`, keyed by a hash of the source and the flags, at
first use. Only the sources in this package are compiled. Without nvcc the
build raises: there is no CPU path for a CUDA tensor.
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

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("front", "fill_rotate_serve", "rc_smooth", "fill_rotate")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, kept in build_logs
)

_lock = threading.Lock()
_libs: dict = {}
#: nvcc's output (ptxas resource usage included) of each source built by this process
build_logs: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


def _target(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every source of `names` that has no up-to-date library yet, all
    nvcc processes in parallel. Returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [(n, *_target(n)) for n in names]
        todo = [(n, src, so) for n, src, so in todo if not so.exists()]
        if not todo:
            return 0.0
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, src, so in todo:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append(
                (name, src, so, tmp,
                 subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            )
        failed = []
        for name, src, so, tmp, proc in procs:  # wait for every process before raising
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, compiling it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return lib
