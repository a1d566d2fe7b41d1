"""The native host runtime: C++ binning, text parsing and forest
prediction via ctypes.

The port's own copies of lightgbm_tpu/cext/binning.cpp and predict.cpp
(reference DatasetLoader's OpenMP FindBin and bin-construction loops,
dataset_loader.cpp; the predictor's OpenMP row loop, predictor.hpp:30).
Each source builds with `g++ -O3 -shared -fPIC -std=c++17 -fopenmp` at
first use into `lightgbm_tpu_torch/_build/` (listed in .gitignore), named
by a hash of the source and flags so an edited source never loads a stale
library; where the compiler refuses -fopenmp the source builds without it
(serial loops, the same bits) and `FLAGS_USED` says so. Importing this
module compiles nothing. A build that fails raises with the compiler's
message: the port never degrades to the numpy paths in its place. Those
stay in binning.py and tree.py as the plain versions, reached with
native=False.

Every routine is bit-exact with its numpy counterpart whatever the thread
count: the parallel loops write disjoint outputs (rows, or features) and
no loop reduces across threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["build_all", "greedy_find_bin", "sample_transpose",
           "find_numeric_bounds", "bin_matrix", "forest_predict",
           "forest_predict_leaf", "count_rows", "parse_delimited",
           "FLAGS_USED"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# tried in order: with OpenMP, then without where the compiler refuses it
_FLAG_SETS = (("-fopenmp",), ())
SOURCES = ("binning", "predict")
#: source stem -> the g++ flags its loaded library was built with
FLAGS_USED: Dict[str, Tuple[str, ...]] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)
_L = ctypes.POINTER(ctypes.c_long)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_ci, _cl, _vp = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
# source stem -> {C entry: (restype, argtypes)}: the argtypes of the JAX
# package's bridge (lightgbm_tpu/cext/__init__.py) for the entries the
# port calls
_ENTRIES = {
    "binning": {
        "lgbt_greedy_find_bin": (_ci, [_D, _I, _ci, _ci, _cl, _ci, _D]),
        "lgbt_bin_matrix": (None, [_vp, _ci, _cl, _ci, _I, _ci, _D, _L, _I,
                                   _I, _ci, _vp]),
        "lgbt_sample_transpose": (None, [_vp, _ci, _ci, _L, _cl, _D]),
        "lgbt_find_numeric_bounds": (_ci, [_D, _ci, _cl, _ci, _ci, _ci, _ci,
                                           _D, _I, _I, _D, _L]),
        "lgbt_parse_delimited": (_cl, [ctypes.c_char_p, ctypes.c_char, _ci,
                                       _D, _cl, _ci, _I]),
        "lgbt_count_rows": (_cl, [ctypes.c_char_p, ctypes.c_char, _I]),
    },
    "predict": {
        "lgbt_predict": (None, [_D, _cl, _ci, _ci, _I, _ci, _L, _L, _I, _D,
                                _U8, _I, _I, _D, _L, _L, _U32, _L, _U8, _D,
                                _L, _I, _D, _ci, _ci, _D]),
        "lgbt_predict_leaf": (None, [_D, _cl, _ci, _ci, _L, _L, _I, _D, _U8,
                                     _I, _I, _L, _L, _U32, _L, _ci, _ci, _I]),
    },
}


def _lib_path(stem: str, flags: Tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + flags).encode())
    h.update((_DIR / f"{stem}.cpp").read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _compile(stem: str, flags: Tuple[str, ...]) -> Tuple[Path, str]:
    """(library path, "" or the compiler's message on failure)."""
    path = _lib_path(stem, flags)
    if path.exists():
        return path, ""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, *flags, str(_DIR / f"{stem}.cpp"), "-o",
         str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        return path, (proc.stdout + proc.stderr).strip() or \
            f"g++ exited with {proc.returncode}"
    os.replace(tmp, path)
    return path, ""


def _build(stem: str) -> Tuple[Path, Tuple[str, ...]]:
    errors: List[str] = []
    for flags in _FLAG_SETS:
        try:
            path, err = _compile(stem, flags)
        except OSError as exc:          # no g++ on PATH
            err = f"{type(exc).__name__}: {exc}"
        if not err:
            return path, flags
        errors.append(f"g++ {' '.join(CXX_FLAGS + flags)} {stem}.cpp:\n"
                      f"{err}")
    raise RuntimeError("the native host runtime (lightgbm_tpu_torch/cext) "
                       "failed to build:\n" + "\n".join(errors))


def build_all() -> Dict[str, Path]:
    """Build (where no up-to-date library exists) and load both sources;
    returns stem -> library path. Raises if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {}
        for stem in SOURCES:
            path, flags = _build(stem)
            paths[stem] = path
            if stem not in _libs:
                lib = ctypes.CDLL(str(path))
                for sym, (res, args) in _ENTRIES[stem].items():
                    fn = getattr(lib, sym)
                    fn.restype = res
                    fn.argtypes = args
                _libs[stem] = lib
                FLAGS_USED[stem] = CXX_FLAGS + flags
        return paths


def _lib(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = _libs[stem]
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def count_rows(path: str, delim: str = ","):
    """(non-empty lines, columns of the first line) of a delimited text
    file, or None when it cannot be opened (lgbt_count_rows)."""
    cols = ctypes.c_int(0)
    rows = _lib("binning").lgbt_count_rows(
        str(path).encode(), delim.encode(), ctypes.byref(cols))
    return None if rows < 0 else (int(rows), int(cols.value))


def parse_delimited(path: str, delim: str = ",", skip_rows: int = 0):
    """A local delimited text file of numbers as a dense [rows, cols]
    float64 matrix (lgbt_parse_delimited: strtod a token, an unparsable
    token NaN, a short row padded with 0.0), after skip_rows header
    lines; None for an empty or unreadable file (the JAX package's
    cext.parse_delimited, which its CLI then reads with np.loadtxt)."""
    counted = count_rows(path, delim)
    if counted is None or counted[0] <= 0 or counted[1] <= 0:
        return None
    rows, cols = counted[0] - skip_rows, counted[1]
    if rows <= 0:
        return None
    out = np.zeros((rows, cols), np.float64)
    got_cols = ctypes.c_int(0)
    got = _lib("binning").lgbt_parse_delimited(
        str(path).encode(), delim.encode(), skip_rows,
        _ptr(out, ctypes.c_double), rows, cols, ctypes.byref(got_cols))
    if got < 0:
        return None
    return out[:got, :got_cols.value]


def greedy_find_bin(distinct: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> np.ndarray:
    """Native GreedyFindBin; returns bin upper bounds (last = +inf)."""
    distinct = np.ascontiguousarray(distinct, np.float64)
    counts = np.ascontiguousarray(counts, np.int32)
    out = np.empty(max_bin + 2, np.float64)
    n = _lib("binning").lgbt_greedy_find_bin(
        _ptr(distinct, ctypes.c_double), _ptr(counts, ctypes.c_int),
        len(distinct), max_bin, total_cnt, min_data_in_bin,
        _ptr(out, ctypes.c_double))
    return out[:n]


def sample_transpose(X: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """np.ascontiguousarray(X[idx].T, dtype=np.float64) in one native pass,
    bit for bit. X: C-contiguous [N, F] float32 or float64; idx: sorted
    row indices."""
    idx = np.ascontiguousarray(idx, np.int64)
    n_rows, f_total = X.shape
    out = np.empty((f_total, len(idx)), np.float64)
    _lib("binning").lgbt_sample_transpose(
        X.ctypes.data_as(ctypes.c_void_p), int(X.dtype == np.float32),
        f_total, _ptr(idx, ctypes.c_long), len(idx),
        _ptr(out, ctypes.c_double))
    return out


def find_numeric_bounds(sample_t: np.ndarray, max_bin: int,
                        min_data_in_bin: int, use_missing: bool,
                        zero_as_missing: bool):
    """Every numeric feature's bin bounds from a [F, S] contiguous f64 raw
    sample (the native FindBin loop over features). Returns (bounds per
    feature, missing_type [F], minmax [F, 2], zero/NaN counts [F, 2])."""
    sample_t = np.ascontiguousarray(sample_t, np.float64)
    n_feat, s = sample_t.shape
    stride = max_bin + 2
    bounds = np.empty(n_feat * stride, np.float64)
    nb = np.empty(n_feat, np.int32)
    mtype = np.empty(n_feat, np.int32)
    minmax = np.empty((n_feat, 2), np.float64)
    zero_na = np.empty((n_feat, 2), np.int64)
    _lib("binning").lgbt_find_numeric_bounds(
        _ptr(sample_t, ctypes.c_double), n_feat, s, max_bin,
        min_data_in_bin, int(use_missing), int(zero_as_missing),
        _ptr(bounds, ctypes.c_double), _ptr(nb, ctypes.c_int),
        _ptr(mtype, ctypes.c_int), _ptr(minmax, ctypes.c_double),
        _ptr(zero_na, ctypes.c_long))
    blist = [bounds[j * stride: j * stride + nb[j]].copy()
             for j in range(n_feat)]
    return blist, mtype, minmax, zero_na


def bin_matrix(X: np.ndarray, feat_idx: np.ndarray, bounds_flat: np.ndarray,
               bounds_off: np.ndarray, num_search: np.ndarray,
               nan_bin: np.ndarray, dtype) -> np.ndarray:
    """Quantize the listed numeric columns of row-major X in one pass
    (float32 is read as it is, without a float64 copy)."""
    if X.dtype == np.float32:
        X = np.ascontiguousarray(X)
    else:
        X = np.ascontiguousarray(X, np.float64)
    n, f_total = X.shape
    feat_idx = np.ascontiguousarray(feat_idx, np.int32)
    bounds_flat = np.ascontiguousarray(bounds_flat, np.float64)
    bounds_off = np.ascontiguousarray(bounds_off, np.int64)
    num_search = np.ascontiguousarray(num_search, np.int32)
    nan_bin = np.ascontiguousarray(nan_bin, np.int32)
    out = np.empty((n, len(feat_idx)), dtype)
    _lib("binning").lgbt_bin_matrix(
        X.ctypes.data_as(ctypes.c_void_p), int(X.dtype == np.float32), n,
        f_total, _ptr(feat_idx, ctypes.c_int), len(feat_idx),
        _ptr(bounds_flat, ctypes.c_double), _ptr(bounds_off, ctypes.c_long),
        _ptr(num_search, ctypes.c_int), _ptr(nan_bin, ctypes.c_int),
        out.dtype.itemsize, out.ctypes.data_as(ctypes.c_void_p))
    return out


def _tree_args(flat: dict) -> list:
    return [_ptr(flat["node_off"], ctypes.c_long),
            _ptr(flat["leaf_off"], ctypes.c_long),
            _ptr(flat["split_feature"], ctypes.c_int),
            _ptr(flat["threshold"], ctypes.c_double),
            _ptr(flat["decision_type"], ctypes.c_uint8),
            _ptr(flat["left"], ctypes.c_int),
            _ptr(flat["right"], ctypes.c_int)]


def _cat_args(flat: dict) -> list:
    return [_ptr(flat["catb_off"], ctypes.c_long),
            _ptr(flat["cat_boundaries"], ctypes.c_long),
            _ptr(flat["cat_threshold"], ctypes.c_uint32),
            _ptr(flat["catt_off"], ctypes.c_long)]


def forest_predict(flat: dict, X: np.ndarray, k: int, start_tree: int,
                   end_tree: int) -> np.ndarray:
    """[n, k] float64 raw scores of trees [start_tree, end_tree) of a
    forest flattened by tree.HostModel._flatten_native: each row adds its
    trees' leaf values in tree order, as the numpy walk does; a linear
    tree's leaf adds const + coeff x x feature after feature, or its
    leaf_value where a model feature is NaN."""
    X = np.ascontiguousarray(X, np.float64)
    n, nfeat = X.shape
    out = np.zeros((n, k), np.float64)

    # an empty array still needs a valid pointer; the arrays are held
    # here until the call returns
    lin = [_ptr(flat[key] if flat[key].size else np.zeros(1, dtype), ct)
           for key, dtype, ct in (
               ("is_linear", np.uint8, ctypes.c_uint8),
               ("leaf_const", np.float64, ctypes.c_double),
               ("lfeat_off", np.int64, ctypes.c_long),
               ("leaf_features", np.int32, ctypes.c_int),
               ("leaf_coeff", np.float64, ctypes.c_double))]
    _lib("predict").lgbt_predict(
        _ptr(X, ctypes.c_double), n, nfeat, flat["num_trees"],
        _ptr(flat["tree_class"], ctypes.c_int), k, *_tree_args(flat),
        _ptr(flat["leaf_value"], ctypes.c_double), *_cat_args(flat), *lin,
        start_tree, end_tree, _ptr(out, ctypes.c_double))
    return out


def forest_predict_leaf(flat: dict, X: np.ndarray, start_tree: int,
                        end_tree: int) -> np.ndarray:
    """[n, end_tree - start_tree] int32 leaf index of each row in each
    tree."""
    X = np.ascontiguousarray(X, np.float64)
    n, nfeat = X.shape
    out = np.zeros((n, end_tree - start_tree), np.int32)
    _lib("predict").lgbt_predict_leaf(
        _ptr(X, ctypes.c_double), n, nfeat, flat["num_trees"],
        *_tree_args(flat), *_cat_args(flat), start_tree, end_tree,
        _ptr(out, ctypes.c_int))
    return out
