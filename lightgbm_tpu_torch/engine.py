"""train() and cv() entry points (reference python-package/lightgbm/engine.py).

Port of lightgbm_tpu/engine.py without streaming input (ROADMAP A11).
train(keep_training_booster=True) is accepted, as in the JAX package: the
booster returned goes on training with update(). Same callback protocol
as the reference: validation sets, custom objectives (fobj: objective "none",
gradients from the caller) and evaluation functions (feval), continued
training from an init_model (its host predictions seed the init scores
before binning; its trees stay in front of the new ones) and early
stopping through EarlyStopException. Kill-and-resume: checkpoint_period
with checkpoint_dir (and checkpoint_keep) attach callback.checkpoint, and
`resume_from` (a bundle or a checkpoint directory) puts the bundle's
model in front as the base model, restores the exact training state
(reliability/checkpoint.py) and trains from the bundle's iteration to
num_boost_round, to the model text of an uninterrupted run.

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
Booster.update(). With `pipeline` (default true) the block loop runs
through the pipelined executor (pipeline/executor.py): adaptive block
sizes (pipeline_adaptive_blocks, pipeline_target_block_ms,
pipeline_max_block), the previous block's trees appended while the next
block runs, and, with pipeline_device_eval, the valid metrics reduced on
the device: the same models, best_iteration and early stops as
pipeline=false, the metric values in f32. The booster returned holds no
fused trainer: its CUDA graphs are freed when training ends, however it
ends. An exception out of the loop (either path; not an early stop) is
recorded in the flight recorder, which flushes a post-mortem bundle
(reason ``exception``) before the exception propagates.

cv (the JAX package's engine.py:414-604) trains one Booster a fold, one
update() an iteration each, and aggregates each "<data> <metric>" into
-mean/-stdv lists, with early stopping on the aggregate. Folds come from
`folds` (an iterator of (train, test) indices, or a scikit-learn
splitter, which gets the rows' query ids as groups), else from the JAX
package's splits: stratified, a round-robin over the stable label order
that ignores shuffle and seed (ROADMAP C25, kept), or nfold contiguous
blocks of a RandomState(seed) permutation. On grouped data the blocks are
of query indices, so every fold holds whole queries (ROADMAP C23: the
JAX package splits rows and drops the query boundaries); ungrouped data
gets exactly the JAX package's folds.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, _best_score_dict
from .utils.log import Log

__all__ = ["train", "cv", "CVBooster"]

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
    alias in params takes precedence, as in the reference); with
    resume_from, num_boost_round stays the total. Every booster returned
    can go on training with update(), so keep_training_booster changes
    nothing."""
    resume_state = None
    if resume_from is not None:
        # restore the checkpointed f32 scores and key stream verbatim
        # (init_model re-seeds init scores through a host predict and
        # restarts the stream instead), so the finished model is the
        # uninterrupted run's
        if init_model is not None:
            raise ValueError("resume_from and init_model are exclusive: "
                             "a checkpoint bundle already carries its model")
        from .reliability.checkpoint import load_checkpoint
        resume_state = load_checkpoint(resume_from)
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
    if resume_state is not None:
        # the bundle's trees ride in front like continued training's, but
        # without init-score seeding: the restored scores already hold
        # them in the killed run's f32 bits
        base_model = Booster(model_str=resume_state.model_str)
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

    start_iter = 0
    if resume_state is not None:
        booster._restore_training_state(resume_state)
        start_iter = resume_state.iteration
        Log.info(f"resuming training from checkpoint "
                 f"{resume_state.path!r} at iteration {start_iter}")

    cbs = set(callbacks or [])
    es_rounds = int(params.get("early_stopping_round", 0) or 0)
    if es_rounds > 0:
        cbs.add(callback_mod.early_stopping(es_rounds, first_metric_only))
    cfg = booster.config
    if cfg.checkpoint_period > 0 and cfg.checkpoint_dir and \
            not any(getattr(cb, "is_checkpoint", False) for cb in cbs):
        cbs.add(callback_mod.checkpoint(
            cfg.checkpoint_period, cfg.checkpoint_dir, cfg.checkpoint_keep))
    if resume_state is not None:
        history = resume_state.state.get("eval_history")
        if history:
            for cb in cbs:
                if hasattr(cb, "_seed_history"):
                    cb._seed_history(history)
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
    # the pipelined executor: the same block dispatch with host work
    # overlapped and the metrics reduced on the device; pipeline=false
    # keeps the loop below as the parity oracle
    use_pipeline = use_blocks and bool(cfg.pipeline)

    def run_callbacks(i, results):
        for cb in callbacks_after:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=start_iter, end_iteration=num_boost_round,
                evaluation_result_list=results))

    def eval_at(i):
        results = []
        if valid_sets or feval is not None:
            if is_valid_contain_train:
                results.extend(booster.eval_train(feval))
            if reduced_valid_sets:
                results.extend(booster.eval_valid(feval))
        run_callbacks(i, results)
        return results

    gb = booster.gbdt
    results = []
    try:
        if use_pipeline and start_iter < num_boost_round:
            from .pipeline import run_pipelined
            results = run_pipelined(
                booster, start_iter=start_iter,
                num_boost_round=num_boost_round, base_block=block,
                run_callbacks=run_callbacks,
                has_valid=bool(reduced_valid_sets),
                stopping_rounds=es_rounds)
            i = num_boost_round   # fully trained; the loop below no-ops
        else:
            i = start_iter
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
                    begin_iteration=start_iter, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            booster.update(fobj=fobj)
            results = eval_at(i)
            i += 1
    except callback_mod.EarlyStopException as es:
        # with continued training, iterations count over the merged
        # model; a resumed run's loop index is already absolute
        base_iters = base_model.current_iteration() \
            if base_model is not None and resume_state is None else 0
        booster.best_iteration = base_iters + es.best_iteration + 1
        results = es.best_score
    except Exception as exc:
        # an unhandled training failure leaves a flight-recorder bundle
        # (where a bundle directory is configured) before it propagates
        from .observability.flightrec import recorder
        recorder.record_exception("engine.train", exc)
        recorder.flush("exception")
        raise
    finally:
        # the trained booster keeps no CUDA graphs (update_batch on it
        # captures anew)
        gb.release_fused()
    if booster.best_iteration < 0:
        booster.best_iteration = booster.current_iteration()
    booster.best_score = _best_score_dict(results)
    return booster


class CVBooster:
    """The boosters of cv's folds (reference engine.py:298): a method
    called on it runs on every fold's booster and returns their results
    in a list."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _query_folds(bounds: np.ndarray, nfold: int, seed: int,
                 shuffle: bool):
    """nfold (train, test) row splits of grouped data: the JAX package's
    unstratified split (a RandomState(seed) permutation when shuffle, then
    nfold contiguous blocks) over the query indices, each block's queries
    turned into their rows."""
    nq = len(bounds) - 1
    rng = np.random.RandomState(seed)
    order = rng.permutation(nq) if shuffle else np.arange(nq)
    qfold = np.empty(nq, np.int64)
    for k in range(nfold):
        qfold[order[k * nq // nfold:(k + 1) * nq // nfold]] = k
    row_fold = np.repeat(qfold, np.diff(bounds))
    return [(np.flatnonzero(row_fold != k), np.flatnonzero(row_fold == k))
            for k in range(nfold)]


def _make_n_folds(full_data: Dataset, folds, nfold: int, params,
                  seed: int, stratified: bool, shuffle: bool):
    """[(train subset, valid subset, train rows, valid rows)] a fold."""
    num_data = full_data.num_data()
    bounds = full_data.binned.metadata.query_boundaries
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            # the splitter sees each row's query id as its group
            if bounds is not None:
                flatted_group = np.repeat(np.arange(len(bounds) - 1),
                                          np.diff(bounds)).astype(np.int32)
            else:
                flatted_group = np.zeros(num_data, np.int32)
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(),
                                groups=flatted_group)
    elif bounds is not None:
        folds = _query_folds(bounds, nfold, seed, shuffle)
    else:
        rng = np.random.RandomState(seed)
        if stratified:
            # a round-robin over the stable label order: shuffle and seed
            # change nothing, as in the JAX package (ROADMAP C25)
            order = np.argsort(np.asarray(full_data.get_label()),
                               kind="stable")
            folds_assign = np.empty(num_data, np.int32)
            folds_assign[order] = np.arange(num_data) % nfold
            folds = [(np.where(folds_assign != k)[0],
                      np.where(folds_assign == k)[0]) for k in range(nfold)]
        else:
            idx = rng.permutation(num_data) if shuffle \
                else np.arange(num_data)
            folds = [(np.concatenate([idx[:k * num_data // nfold],
                                      idx[(k + 1) * num_data // nfold:]]),
                      idx[k * num_data // nfold:(k + 1) * num_data // nfold])
                     for k in range(nfold)]
    ret = []
    for train_idx, test_idx in folds:
        tr = np.sort(np.asarray(train_idx))
        te = np.sort(np.asarray(test_idx))
        ret.append((full_data.subset(tr, params),
                    full_data.subset(te, params), tr, te))
    return ret


def _agg_cv_result(raw_results):
    """Each fold's [(data, metric, value, higher better)] as
    [("cv_agg", "<data> <metric>", mean, higher better, std)], in the
    order the keys first appear."""
    by_key: Dict[str, Tuple[bool, List[float]]] = {}
    for fold in raw_results:
        for data_name, metric_name, value, higher_better, *_ in fold:
            slot = by_key.setdefault(f"{data_name} {metric_name}",
                                     (higher_better, []))
            slot[1].append(value)
    return [("cv_agg", key, float(np.mean(vals)), hb, float(np.std(vals)))
            for key, (hb, vals) in by_key.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       fpreproc=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """Cross-validation: {"<data> <metric>-mean" and "-stdv": a value an
    iteration} (cut at the best iteration by an early stop), with
    "cvbooster" when return_cvbooster. Each fold's booster trains on the
    device its params name, one update() an iteration."""
    params = copy.deepcopy(params or {})
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    init_full = None
    if init_model is not None:
        # every fold's init scores are the base model's raw predictions
        # (reference cv: train_set._set_predictor, engine.py:548-562)
        base_model = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=init_model)
        if train_set.data is None or isinstance(train_set.data, str):
            raise ValueError(
                "cv(init_model=...) needs in-memory raw data on the "
                "dataset; pass free_raw_data=False with an array or frame")
        existing = train_set.init_score
        if existing is None and train_set._binned is not None:
            existing = train_set._binned.metadata.init_score
        if existing is not None:
            raise ValueError("cannot combine init_model with a dataset that "
                             "already has init_score")
        init_full = np.asarray(
            base_model.predict(train_set.data, raw_score=True), np.float64)
    if fobj is not None:
        params["objective"] = "none"
    if metrics:
        params["metric"] = metrics
    if params.get("objective", "") in ("lambdarank", "rank_xendcg") or \
            train_set.group is not None:
        stratified = False

    results = collections.defaultdict(list)
    cvbooster = CVBooster()
    boosters = []
    for train_sub, valid_sub, tr_idx, te_idx in _make_n_folds(
            train_set, folds, nfold, params, seed, stratified, shuffle):
        if init_full is not None:
            for sub, idx in ((train_sub, tr_idx), (valid_sub, te_idx)):
                sub.init_score = init_full[idx]
                sub._binned.metadata.init_score = np.ascontiguousarray(
                    init_full[idx], np.float64)
        if fpreproc is not None:
            train_sub, valid_sub, params = fpreproc(
                train_sub, valid_sub, params.copy())
        bst = Booster(params=params, train_set=train_sub)
        bst.add_valid(valid_sub, "valid")
        boosters.append(bst)
        cvbooster._append(bst)

    cbs = set(callbacks or [])
    es_rounds = int(params.get("early_stopping_round", 0) or 0)
    if es_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            es_rounds, bool(params.get("first_metric_only", False))))
    callbacks_before = sorted(
        (cb for cb in cbs if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in cbs if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    try:
        for i in range(num_boost_round):
            raw_results = []
            for bst in boosters:
                for cb in callbacks_before:
                    cb(callback_mod.CallbackEnv(
                        model=bst, params=params, iteration=i,
                        begin_iteration=0, end_iteration=num_boost_round,
                        evaluation_result_list=None))
                bst.update(fobj=fobj)
                res = bst.eval_valid(feval)
                if eval_train_metric:
                    res = bst.eval_train(feval) + res
                raw_results.append(res)
            agg = _agg_cv_result(raw_results)
            for _, key, mean, _, std in agg:
                results[key + "-mean"].append(mean)
                results[key + "-stdv"].append(std)
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg))
    except callback_mod.EarlyStopException as es:
        cvbooster.best_iteration = es.best_iteration + 1
        for bst in boosters:
            bst.best_iteration = cvbooster.best_iteration
        for k in results:
            results[k] = results[k][:cvbooster.best_iteration]
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
