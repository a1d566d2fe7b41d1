"""Training callbacks (reference python-package/lightgbm/callback.py:73-356).

Copy of lightgbm_tpu/callback.py for the PyTorch/CUDA port. Same protocol
as the reference: callables taking a CallbackEnv namedtuple, with a
`before_iteration` attribute controlling ordering, EarlyStopException for
control flow, and `block_safe` marking the callbacks that read only
evaluation results, which engine.train's block dispatch may run from a
block's valid-score trajectory. `checkpoint` writes the training-state
bundles of reliability/checkpoint.py that train(resume_from=) resumes
from; it is not block_safe, so it keeps training one iteration a
dispatch.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

from .utils.log import Log

__all__ = ["EarlyStopException", "CallbackEnv", "print_evaluation",
           "log_evaluation", "record_evaluation", "reset_parameter",
           "early_stopping", "checkpoint"]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    # reads only evaluation results; safe under engine block dispatch
    _callback.block_safe = True
    return _callback


print_evaluation = log_evaluation  # deprecated alias (reference keeps both)


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    _callback.block_safe = True
    return _callback


def reset_parameter(**kwargs: Any) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        "'num_boost_round'")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting round "
                                 "index to new parameter value")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            if "learning_rate" in new_parameters:
                env.model.reset_parameter(
                    {"learning_rate": new_parameters["learning_rate"]})
            else:
                env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def checkpoint(period: int, directory: str, keep_last: int = 3) -> Callable:
    """Save an atomic training-state bundle every `period` iterations and
    at the last one (reliability/checkpoint.py). A bundle written at
    iteration k lets ``train(..., resume_from=directory)`` continue a
    killed run to a model byte-identical to an uninterrupted one.

    A failed save (a full disk) is a warning that counts
    `checkpoint_failures`, not a training failure: the run continues and
    the next period retries.

    Not ``block_safe``: under block dispatch the booster already holds
    the whole block's trees at inner iterations, so a mid-block snapshot
    would capture future state; checkpointing keeps the per-iteration
    cadence."""
    if period <= 0:
        raise ValueError("checkpoint period must be > 0")
    if not directory:
        raise ValueError("checkpoint directory must be non-empty")
    # eval history accumulated across iterations (and, on resume, seeded
    # from the bundle) so every snapshot carries the whole run's curves
    history: Dict[str, Dict[str, List[float]]] = {}

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list or []:
            data_name, eval_name, result = item[0], item[1], item[2]
            history.setdefault(data_name, collections.OrderedDict())
            history[data_name].setdefault(eval_name, [])
            history[data_name][eval_name].append(result)
        done = env.iteration + 1
        if done % period != 0 and done != env.end_iteration:
            return
        from .reliability.checkpoint import save_checkpoint
        from .reliability.counters import counters
        booster = env.model
        try:
            state, arrays = booster._training_state()
            state["eval_history"] = history
            save_checkpoint(directory, done, booster.model_to_string(),
                            state, arrays, keep_last=keep_last)
        except Exception as exc:
            counters.inc("checkpoint_failures")
            Log.warning(
                "checkpoint save failed at iteration %d (%s: %s); "
                "training continues", done, type(exc).__name__, exc)

    def _seed_history(h) -> None:
        history.clear()
        for data_name, metrics in (h or {}).items():
            history[data_name] = collections.OrderedDict(
                (k, list(v)) for k, v in metrics.items())

    _callback.order = 40          # after eval/early-stop bookkeeping
    _callback.is_checkpoint = True
    _callback._seed_history = _seed_history
    return _callback


class _BestTracker:
    """Best-so-far state for one (dataset, metric) pair.

    ``update`` applies the min_delta-thresholded improvement rule for the
    metric's direction and snapshots the full evaluation list at the best
    iteration (what EarlyStopException carries, per the reference
    callback protocol)."""

    __slots__ = ("sign", "delta", "best", "iteration", "snapshot")

    def __init__(self, higher_better: bool, delta: float):
        # compare in "higher is better" space: flip sign for loss metrics
        self.sign = 1.0 if higher_better else -1.0
        self.delta = float(delta)
        self.best = float("-inf")
        self.iteration = 0
        self.snapshot: Any = None

    def update(self, score: float, iteration: int, eval_list) -> None:
        oriented = self.sign * score
        if self.snapshot is None or oriented > self.best + self.delta:
            self.best = oriented
            self.iteration = iteration
            self.snapshot = eval_list


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Stop training when no tracked validation metric improved for
    ``stopping_rounds`` consecutive iterations (reference
    callback.py _EarlyStoppingCallback protocol: raises
    EarlyStopException carrying the best iteration + its eval list)."""
    state: Dict[str, Any] = {"trackers": None, "enabled": True,
                             "first_name": None}

    def _start(env: CallbackEnv) -> None:
        if any(env.params.get(k, "") == "dart"
               for k in ("boosting", "boosting_type", "boost")):
            state["enabled"] = False
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            Log.info("Training until validation scores don't improve for "
                     "%d rounds", stopping_rounds)
        n = len(env.evaluation_result_list)
        deltas = list(min_delta) if isinstance(min_delta, list) \
            else [min_delta] * n
        state["trackers"] = [
            _BestTracker(higher_better=entry[3], delta=d)
            for entry, d in zip(env.evaluation_result_list, deltas)]
        # "first metric" = the metric name of the first eval entry
        state["first_name"] = env.evaluation_result_list[0][1]

    def _stop(trk: _BestTracker, reason: str, metric_name: str) -> None:
        if verbose:
            summary = "\t".join(_format_eval_result(x)
                                for x in trk.snapshot)
            Log.info("%s Best iteration is:\n[%d]\t%s",
                     reason, trk.iteration + 1, summary)
            if first_metric_only:
                Log.info("Evaluated only: %s", metric_name.split(" ")[-1])
        raise EarlyStopException(trk.iteration, trk.snapshot)

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _start(env)
        if not state["enabled"]:
            return
        last_round = env.iteration == env.end_iteration - 1
        for trk, entry in zip(state["trackers"],
                              env.evaluation_result_list):
            data_name, metric_name, score = entry[0], entry[1], entry[2]
            trk.update(score, env.iteration, env.evaluation_result_list)
            if first_metric_only and metric_name != state["first_name"]:
                continue
            # training-set and cv-aggregate scores never trigger a stop
            # mid-run; they only terminate cleanly at the last round
            counts = data_name not in ("cv_agg", "training")
            if counts and env.iteration - trk.iteration >= stopping_rounds:
                _stop(trk, "Early stopping.", metric_name)
            if last_round:
                _stop(trk, "Did not meet early stopping.", metric_name)
    _callback.order = 30
    _callback.block_safe = True
    return _callback
