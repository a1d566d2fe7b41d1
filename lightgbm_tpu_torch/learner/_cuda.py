"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. All sources build in parallel (one nvcc process each) at first
use, into `lightgbm_tpu_torch/_build/` (listed in .gitignore), named by a
hash of the sources and flags so an edited source never loads a stale
library. Nothing here runs at import time: this module is imported on
hosts without nvcc or a card, where only the kernels' plain versions run.

Every C entry launches on the stream it is given and returns
cudaGetLastError(); `call` raises on anything but 0. `call` is the launch
path of every wrapper, so it does no more per call than convert the
arguments and look up the current stream: the wrappers do the checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["KERNELS", "SOURCES", "build_all", "c_args", "call"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# per-source flags, after NVCC_FLAGS: the split scan rounds every f32 op
# on its own, as torch's elementwise kernels do, so it picks the splits
# its plain version picks on the card
EXTRA_FLAGS: Dict[str, tuple] = {"find_best_splits": ("-fmad=false",),
                                  "linear_leaves": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# kernel name -> (C entry point, argtypes); the last argument of every
# entry is the CUDA stream. A kernel's source is csrc/<name>.cu unless
# SOURCES names another stem (one source may hold several entries)
KERNELS: Dict[str, tuple] = {
    "route_rows": ("lgbt_route_rows", [_P] * 10 + [_I] * 8 + [_P]),
    "partition_rows": ("lgbt_partition_rows", [_P] * 6 + [_I] * 4 + [_P]),
    "build_histograms_scatter": ("lgbt_build_histograms_scatter",
                                 [_P] * 10 + [_I] * 8 + [_F] + [_I] * 3 +
                                 [_P]),
    "node_values": ("lgbt_node_values", [_P] * 3 + [_I] * 2 + [_P]),
    "node_sums": ("lgbt_node_sums", [_P] * 6 + [_I] * 2 + [_P]),
    "find_best_splits": ("lgbt_find_best_splits",
                         [_P] * 6 + [_I] * 4 + [_F] * 7 + [_P]),
    "prune_best_first": ("lgbt_prune_best_first", [_P] * 8 + [_I] * 3 + [_P]),
    "predict_binned": ("lgbt_predict_binned", [_P] * 16 + [_I] * 11 + [_P]),
    "linear_gram": ("lgbt_linear_gram", [_P] * 10 + [_I] * 4 + [_L, _P]),
    "linear_values": ("lgbt_linear_values", [_P] * 8 + [_I] * 4 + [_P]),
}
SOURCES: Dict[str, str] = {"linear_gram": "linear_leaves",
                           "linear_values": "linear_leaves"}

_lock = threading.Lock()
_entries: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                       "from lightgbm_tpu_torch/csrc at first use and need "
                       "the CUDA toolkit (nvcc on PATH or in CUDA_HOME)")


def _flags(stem: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(stem, ())


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(stem)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no up-to-date library yet, all
    nvcc processes started together; returns source stem -> library
    path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {stem: _lib_path(stem)
            for stem in sorted({SOURCES.get(k, k) for k in KERNELS})}
    todo = {stem: p for stem, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(stem), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failures = []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{stem}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, todo[stem])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def _entry(stem: str):
    fn = _entries.get(stem)
    if fn is not None:
        return fn
    with _lock:
        if stem not in _entries:
            libs = build_all()
            for name, (sym, argtypes) in KERNELS.items():
                f = getattr(ctypes.CDLL(str(libs[SOURCES.get(name, name)])),
                            sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _entries[name] = f
    return _entries[stem]


def c_args(args) -> list:
    """The C arguments of a launch, in one pass: tensors as their data
    pointers, None as a null pointer, Python floats as C floats, anything
    else (ints, bools, numpy integers) as a C int."""
    return [a.data_ptr() if isinstance(a, torch.Tensor)
            else a if a is None or isinstance(a, float) else int(a)
            for a in args]


def call(stem: str, device: torch.device, *args) -> None:
    """Launch kernel `stem` on `device`'s current stream with `args`
    converted by c_args. The launch goes to the current device; a device
    that is not current is made current for this launch only. The stream
    is the raw handle torch.cuda.current_stream(device).cuda_stream holds,
    read without building a Stream object (4.2 against 0.2 us a call on
    the card's host, PERF.md)."""
    fn = _entries.get(stem) or _entry(stem)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        with torch.cuda.device(device):
            return call(stem, device, *args)
    err = fn(*c_args(args), torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {stem} failed to launch: "
                           f"cudaError {err}")
