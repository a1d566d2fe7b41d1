"""Atomic checkpoint bundles for kill-and-resume training.

Port of lightgbm_tpu/reliability/checkpoint.py, single host. A bundle is
a directory, not a file, because a resumable run needs more than the
model: the exact f32 score state and the RNG stream position have to come
back bit for bit for the resumed run to reproduce an uninterrupted one.
Layout (the JAX package's)::

    <dir>/ckpt_0000012/          # iteration 12 has been trained
        model.txt                # Booster.model_to_string()
        state.json               # iteration, world_size, eval history...
        arrays.npz               # train_score, rng_key, valid_score_i
    <dir>/LATEST                 # name of the newest complete bundle

The port's bagging is stateless (the mask is a function of the resample
iteration, ROADMAP C10), so arrays.npz holds no `bag_mask`; `rng_key` is
the port's int64 [2] key of GOSS's stream.

Atomicity is tmp+rename at both levels: the bundle is assembled under a
dot-prefixed temp name and `os.rename`d into place (POSIX rename is
atomic within a filesystem), and LATEST is rewritten via `os.replace`. A
crash mid-write leaves only a `.tmp-*` directory that the next save
sweeps; readers never observe a partial bundle. `_prune` keeps the
newest `keep_last` bundles and never removes the one named by PIN_FILE.

Not ported: the coordinated multihost commit (`_save_coordinated` and
its COMMIT marker) and `load_checkpoint_resharded` (ROADMAP A10); the
`checkpoint_io` fault hook and the flight recorder's record_checkpoint
(A9 part 2). The port refuses to load a bundle that declares
world_size > 1.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..utils.log import LightGBMError, Log
from .counters import counters

__all__ = ["CheckpointState", "save_checkpoint", "load_checkpoint",
           "latest_checkpoint", "FORMAT_VERSION",
           "PIN_FILE", "pinned_bundle"]

FORMAT_VERSION = 1

_BUNDLE_PREFIX = "ckpt_"
_LATEST = "LATEST"
#: top-level file naming a bundle that `_prune` never deletes (the JAX
#: package's serving registry writes it, pin_bundle)
PIN_FILE = "PINNED"


@dataclass
class CheckpointState:
    """One loaded bundle, ready for `Booster._restore_training_state`."""
    iteration: int
    model_str: str
    state: Dict = field(default_factory=dict)
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    path: str = ""


def _bundle_name(iteration: int) -> str:
    return f"{_BUNDLE_PREFIX}{iteration:07d}"


def _bundle_iter(name: str) -> Optional[int]:
    if not name.startswith(_BUNDLE_PREFIX):
        return None
    try:
        return int(name[len(_BUNDLE_PREFIX):])
    except ValueError:
        return None


def _listdir(path: str) -> List[str]:
    """os.listdir that treats a vanished directory as empty."""
    try:
        return os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return []


def _sweep_tmp(ckpt_dir: str) -> None:
    for name in _listdir(ckpt_dir):
        if name.startswith(".tmp-"):
            shutil.rmtree(os.path.join(ckpt_dir, name),
                          ignore_errors=True)


def _read_state(bundle: str) -> Optional[Dict]:
    try:
        with open(os.path.join(bundle, "state.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _is_complete(bundle: str) -> bool:
    """True when `bundle` holds a readable state.json: a single-writer
    bundle is complete by construction (it became visible by an atomic
    rename)."""
    return _read_state(bundle) is not None


def save_checkpoint(ckpt_dir: str, iteration: int, model_str: str,
                    state: Dict, arrays: Dict[str, np.ndarray],
                    keep_last: int = 0) -> str:
    """Write one atomic bundle; returns its path. `keep_last` > 0 prunes
    older bundles after the new one is visible, so the retention floor
    never drops below the newest snapshot."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_tmp(ckpt_dir)
    name = _bundle_name(iteration)
    final = os.path.join(ckpt_dir, name)
    tmp = os.path.join(ckpt_dir, f".tmp-{name}-{os.getpid()}")

    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "model.txt"), "w") as f:
        f.write(model_str)
    full_state = {"format_version": FORMAT_VERSION,
                  "iteration": int(iteration), "world_size": 1}
    full_state.update(state)
    with open(os.path.join(tmp, "state.json"), "w") as f:
        json.dump(full_state, f, indent=1, sort_keys=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})

    if os.path.isdir(final):          # re-checkpoint of the same iteration
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(name + "\n")
    os.replace(latest_tmp, os.path.join(ckpt_dir, _LATEST))

    if keep_last and keep_last > 0:
        _prune(ckpt_dir, keep_last)
    counters.inc("checkpoint_saves")
    Log.info(f"checkpoint: saved iteration {iteration} -> {final}")
    return final


def pinned_bundle(ckpt_dir: str) -> Optional[int]:
    """Iteration of the pinned bundle, or None (a vanished or garbled pin
    reads as unpinned)."""
    try:
        with open(os.path.join(ckpt_dir, PIN_FILE)) as f:
            return _bundle_iter(f.read().strip())
    except OSError:
        return None


def _prune(ckpt_dir: str, keep_last: int) -> None:
    """Keep the newest `keep_last` complete bundles. Incomplete bundles
    never count toward the quota, and one older than the newest complete
    bundle is a torn write of a killed run, removed. The pinned bundle is
    never removed."""
    pinned = pinned_bundle(ckpt_dir)
    complete: List[int] = []
    stale: List[int] = []
    for name in _listdir(ckpt_dir):
        it = _bundle_iter(name)
        if it is None:
            continue
        if _is_complete(os.path.join(ckpt_dir, name)):
            complete.append(it)
        else:
            stale.append(it)
    complete.sort()
    for it in complete[:-keep_last]:
        if it == pinned:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, _bundle_name(it)),
                      ignore_errors=True)
    if complete:
        newest = complete[-1]
        for it in stale:
            if it < newest and it != pinned:
                shutil.rmtree(os.path.join(ckpt_dir, _bundle_name(it)),
                              ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest complete bundle under `ckpt_dir`, or None. Trusts LATEST
    when it names a complete bundle, else scans (LATEST is advisory; the
    bundles are the durable record)."""
    if not os.path.isdir(ckpt_dir):
        return None
    latest = os.path.join(ckpt_dir, _LATEST)
    if os.path.isfile(latest):
        with open(latest) as f:
            name = f.read().strip()
        cand = os.path.join(ckpt_dir, name)
        if _is_complete(cand):
            return cand
    best: Optional[int] = None
    for name in _listdir(ckpt_dir):
        it = _bundle_iter(name)
        if it is None:
            continue
        if not _is_complete(os.path.join(ckpt_dir, name)):
            continue
        if best is None or it > best:
            best = it
    return os.path.join(ckpt_dir, _bundle_name(best)) if best is not None \
        else None


def load_checkpoint(path: str) -> CheckpointState:
    """Load a bundle. `path` may be a bundle directory or a checkpoint
    directory (the newest complete bundle is picked)."""
    bundle = path
    if not _is_complete(bundle):
        found = latest_checkpoint(path)
        if found is None:
            raise LightGBMError(
                f"no complete checkpoint bundle found under {path!r}")
        bundle = found
    state = _read_state(bundle)
    if state is None:
        raise LightGBMError(f"checkpoint {bundle!r} lost its state.json "
                            f"mid-load (concurrent prune?)")
    ver = state.get("format_version")
    if ver != FORMAT_VERSION:
        raise LightGBMError(
            f"checkpoint {bundle!r} has format_version={ver!r}; "
            f"this build reads version {FORMAT_VERSION}")
    ws = int(state.get("world_size", 1))
    if ws > 1:
        raise LightGBMError(
            f"checkpoint {bundle!r} was written by {ws} coordinated ranks; "
            "lightgbm_tpu_torch resumes single-host bundles only "
            "(ROADMAP.md port queue A10)")
    with open(os.path.join(bundle, "model.txt")) as f:
        model_str = f.read()
    arrays: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(bundle, "arrays.npz")
    if os.path.isfile(npz_path):
        with np.load(npz_path) as npz:
            arrays = {k: npz[k] for k in npz.files}
    return CheckpointState(iteration=int(state["iteration"]),
                           model_str=model_str, state=state,
                           arrays=arrays, path=bundle)
