"""train() entry point (reference python-package/lightgbm/engine.py).

Port of lightgbm_tpu/engine.py:34-420 without checkpoint resume
(`resume_from`, ROADMAP A9), `keep_training_booster` (A12), streaming
input and the pipelined executor (`pipeline` is accepted and ignored,
ROADMAP A3: it gives the models of block dispatch). Same callback protocol
as the reference: validation sets, custom objectives (fobj: objective
"none", gradients from the caller) and evaluation functions (feval),
continued training from an init_model (its host predictions seed the init
scores before binning; its trees stay in front of the new ones) and
early stopping through EarlyStopException.

As in the JAX package, iterations go fused_block_size at a time through
Booster.update_batch (the fused trainer, boosting/fused.py) when nothing
needs a per-iteration host boundary: no fobj or feval, no callback that
runs before an iteration or is not block_safe, no valid set that is the
training set, and a fused-eligible booster. Every inner iteration is still
evaluated, from the block's valid-score trajectory (one host copy a block
per valid set), and an early stop inside a block rolls the trees after
the best iteration back and pins the valid scores to the trajectory point:
the models, best_iteration and best_score of fused_block_size 1 (the
rollback's add-then-subtract can leave a last-bit residue on the training
scores, as in the JAX package). Otherwise each iteration is one
Booster.update(). The booster returned holds no fused trainer: its CUDA
graphs are freed when training ends, however it ends.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, _best_score_dict

__all__ = ["train"]

_NUM_ROUND_ALIASES = (
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "nrounds", "num_boost_round", "n_estimators",
    "max_iter")


def _seed_init_scores(base: Booster, datasets) -> None:
    """Continued training: each dataset's init scores are the base model's
    raw predictions on its raw rows (before binning)."""
    for ds in datasets:
        existing = ds.init_score
        if existing is None and ds._binned is not None:
            existing = ds._binned.metadata.init_score
        if existing is not None and not getattr(ds, "_seeded_init_score",
                                                False):
            # the base trees stay in front of the final model: a user
            # init_score would count twice
            raise ValueError("cannot combine init_model with a dataset that "
                             "already has init_score")
        if ds.data is None:
            raise ValueError(
                "init_model continuation needs raw data on the datasets; "
                "pass free_raw_data=False or un-constructed Datasets")
        init = base.predict(ds.data, raw_score=True)
        ds.init_score = init
        ds._seeded_init_score = True
        if ds._binned is not None:
            ds._binned.metadata.init_score = np.asarray(init, np.float32)


def _unseed_init_scores(datasets) -> None:
    """A plain train() after a continued one does not inherit the seed the
    previous call wrote into its datasets."""
    for ds in datasets:
        if getattr(ds, "_seeded_init_score", False):
            ds.init_score = None
            ds._seeded_init_score = False
            if ds._binned is not None:
                ds._binned.metadata.init_score = None


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          keep_training_booster: bool = False,
          callbacks: Optional[List] = None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster for num_boost_round iterations (a num_iterations
    alias in params takes precedence, as in the reference)."""
    if resume_from is not None:
        raise NotImplementedError(
            "train(resume_from=...) is not ported to lightgbm_tpu_torch "
            "yet (ROADMAP.md port queue A9)")
    if keep_training_booster:
        raise NotImplementedError(
            "train(keep_training_booster=True) is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP.md port queue A12)")
    params = copy.deepcopy(params or {})
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    if fobj is not None:
        params["objective"] = "none"
    first_metric_only = bool(params.get("first_metric_only", False))
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    valid_sets = list(valid_sets or [])
    others = [v for v in valid_sets
              if isinstance(v, Dataset) and v is not train_set]

    base_model = None
    if init_model is not None:
        base_model = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=init_model)
        _seed_init_scores(base_model, [train_set] + others)
    else:
        _unseed_init_scores([train_set] + others)

    booster = Booster(params=params, train_set=train_set)
    booster._base_model = base_model
    is_valid_contain_train = False
    reduced_valid_sets = []
    for i, valid_data in enumerate(valid_sets):
        if valid_data is train_set:
            is_valid_contain_train = True
            if valid_names is not None:
                booster.train_data_name = valid_names[i]
            continue
        if not isinstance(valid_data, Dataset):
            raise TypeError("Training only accepts Dataset object")
        reduced_valid_sets.append(valid_data)
        booster.add_valid(valid_data, valid_names[i]
                          if valid_names is not None else f"valid_{i}")

    cbs = set(callbacks or [])
    if int(params.get("early_stopping_round", 0) or 0) > 0:
        cbs.add(callback_mod.early_stopping(
            int(params["early_stopping_round"]), first_metric_only))
    callbacks_before = sorted(
        (cb for cb in cbs if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in cbs if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    booster.best_iteration = -1
    block = int(booster.config.fused_block_size or 1)
    # the JAX package's rule (lightgbm_tpu/engine.py:273-277): a callback
    # that may read model state forces one iteration a dispatch, since at
    # inner iteration j the booster already holds the whole block's trees
    use_blocks = (block > 1 and fobj is None and feval is None
                  and not callbacks_before
                  and all(getattr(cb, "block_safe", False)
                          for cb in callbacks_after)
                  and not is_valid_contain_train
                  and booster.gbdt._fused_eligible())

    def eval_at(i):
        results = []
        if valid_sets or feval is not None:
            if is_valid_contain_train:
                results.extend(booster.eval_train(feval))
            if reduced_valid_sets:
                results.extend(booster.eval_valid(feval))
        for cb in callbacks_after:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=results))
        return results

    gb = booster.gbdt
    results = []
    try:
        i = 0
        while i < num_boost_round:
            b = min(block, num_boost_round - i) if use_blocks else 1
            if b > 1:
                booster.update_batch(b)
                if gb.valid_sets:
                    for j in range(b):
                        gb.valid_traj_point(j)
                        try:
                            results = eval_at(i + j)
                        except callback_mod.EarlyStopException:
                            # the block's trees after the best iteration
                            # come off; the valid scores are pinned to the
                            # trajectory point, not left to the
                            # subtraction's rounding
                            gb.valid_traj_point(b - 1)
                            for _ in range(b - 1 - j):
                                booster.rollback_one_iter()
                            gb.valid_traj_point(j)
                            raise
                        except BaseException:
                            # trees hold the whole block: so must scores
                            gb.valid_traj_point(b - 1)
                            raise
                else:
                    for j in range(b):
                        results = eval_at(i + j)
                i += b
                continue
            for cb in callbacks_before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            booster.update(fobj=fobj)
            results = eval_at(i)
            i += 1
    except callback_mod.EarlyStopException as es:
        # with continued training, iterations count over the merged model
        base_iters = base_model.current_iteration() \
            if base_model is not None else 0
        booster.best_iteration = base_iters + es.best_iteration + 1
        results = es.best_score
    finally:
        # the trained booster keeps no CUDA graphs (update_batch on it
        # captures anew)
        gb.release_fused()
    if booster.best_iteration < 0:
        booster.best_iteration = booster.current_iteration()
    booster.best_score = _best_score_dict(results)
    return booster
