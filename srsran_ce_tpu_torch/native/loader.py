"""ctypes binding of the port's native vector-I/O library (`vector_io.cpp`), the
counterpart of `srsran_ce_tpu/native/loader.py`.

The library is built with g++ at first use into the git-ignored
`srsran_ce_tpu_torch/_build/`, keyed by a hash of the source and the flags (as
the CUDA kernels are, `ops/kernels/_build.py`), never beside the source.
`available()` says whether it built and loaded; the callers (`serving`,
`utils/vectors`) take their numpy branch when it did not, with one warning.

`packs` and `merges` count the batches packed by `assemble_batch_ri` and
merged by `ri_to_complex`, so that a run can show the native branch ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from ..ops.kernels._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "vector_io.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_error = None

#: batches packed by `assemble_batch_ri` since the count was last set to 0
packs = 0
#: batches merged by `ri_to_complex` since the count was last set to 0
merges = 0


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libvector_io_{digest[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    out = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC} (exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _target()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.parse_entries.restype = None
        lib.parse_entries.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.entries_to_grid.restype = ctypes.c_int64
        lib.entries_to_grid.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        for name in ("complex_to_ri", "ri_to_complex"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
            ]
        lib.ri_to_complex_mt.restype = None
        lib.ri_to_complex_mt.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.assemble_batch_ri.restype = None
        lib.assemble_batch_ri.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built and loaded (building it on first call).
    A failed build is reported once, as a warning, and then returns False."""
    global _error
    if _lib is not None:
        return True
    if _error is not None:
        return False
    try:
        _get_lib()
        return True
    except (OSError, RuntimeError) as e:  # no g++, a failed build or load
        _error = e
        warnings.warn(f"native vector-I/O library unavailable, using numpy: {e}", RuntimeWarning,
                      stacklevel=2)
        return False


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


_AUTO_THREADS = min(8, os.cpu_count() or 1)


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else _AUTO_THREADS


def parse_entries(raw: bytes) -> np.ndarray:
    """Parse expected_entry_t records via the native library: a structured
    array with fields (sym, port, sc, value)."""
    lib = _get_lib()
    n = len(raw) // 12
    out = np.empty(
        n, dtype=[("sym", np.int32), ("port", np.int32), ("sc", np.int32), ("value", np.complex64)]
    )
    sym = np.empty(n, np.int32)
    port = np.empty(n, np.int32)
    sc = np.empty(n, np.int32)
    val = np.empty(n, np.complex64)
    lib.parse_entries(raw, n, _i32p(sym), _i32p(port), _i32p(sc), _f32p(val.view(np.float32)))
    out["sym"] = sym
    out["port"] = port
    out["sc"] = sc
    out["value"] = val
    return out


def entries_to_grid(raw: bytes, n_sc: int, n_sym: int, n_layers: int) -> np.ndarray:
    """Parse + scatter records straight into a dense (n_sc, n_sym, n_layers)
    complex64 grid; raises when a record falls outside it."""
    lib = _get_lib()
    n = len(raw) // 12
    grid = np.zeros((n_sc, n_sym, n_layers), dtype=np.complex64)
    oob = lib.entries_to_grid(raw, n, _f32p(grid.view(np.float32)), n_sc, n_sym, n_layers)
    if oob:
        raise ValueError(f"{oob} records outside the ({n_sc},{n_sym},{n_layers}) grid")
    return grid


def complex_to_ri(x: np.ndarray) -> np.ndarray:
    """(B, ...) complex64 -> (B, 2, ...) float32 planar."""
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.complex64)
    b = x.shape[0]
    n = x.size // b
    out = np.empty((b, 2) + x.shape[1:], np.float32)
    lib.complex_to_ri(_f32p(x.view(np.float32)), _f32p(out), b, n)
    return out


def ri_to_complex(x: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """(B, 2, ...) float32 planar -> (B, ...) complex64, split over problems on
    `n_threads` threads (0 = auto, min(8, cpu count))."""
    global merges
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.shape[0]
    n = x.size // (2 * b)
    out = np.empty((b,) + x.shape[2:], np.complex64)
    lib.ri_to_complex_mt(_f32p(x), _f32p(out.view(np.float32)), b, n, _threads(n_threads))
    merges += 1
    return out


def assemble_batch_ri(arrays, n_threads: int = 0, out: np.ndarray = None) -> np.ndarray:
    """Gather B independently allocated complex problems of one shape into one
    contiguous (B, 2, ...) float32 ri batch, on `n_threads` threads (0 = auto).

    The serving front-end's host-side packing step: problems arrive as
    separate buffers per (cell, UE, slot). `out`, a C-contiguous float32 array
    of the batch's shape (a pinned staging buffer), is filled in place and
    returned."""
    global packs
    lib = _get_lib()
    arrays = [np.ascontiguousarray(a, dtype=np.complex64) for a in arrays]
    b = len(arrays)
    if b == 0 or any(a.shape != arrays[0].shape for a in arrays):
        raise ValueError("assemble_batch_ri takes one or more problems of one shape")
    n = arrays[0].size
    shape = (b, 2) + arrays[0].shape
    if out is None:
        out = np.empty(shape, np.float32)
    elif out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 {shape} array")
    ptrs = (ctypes.POINTER(ctypes.c_float) * b)(*[_f32p(a.view(np.float32)) for a in arrays])
    lib.assemble_batch_ri(ptrs, _f32p(out), b, n, _threads(n_threads))
    packs += 1
    return out
