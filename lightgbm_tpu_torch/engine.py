"""train() entry point (reference python-package/lightgbm/engine.py).

Port of lightgbm_tpu/engine.py:34 without validation sets, callbacks,
custom objectives, continued training or checkpoint resume. As in the
JAX package, iterations go fused_block_size at a time through
Booster.update_batch (the fused trainer, boosting/fused.py) when the
booster is fused-eligible, else one Booster.update() each; the models are
the same either way. The booster returned holds no fused trainer: its
CUDA graphs are freed when training ends. `pipeline` (the JAX package's
pipelined executor, ROADMAP A3) is accepted and ignored.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Booster, Dataset

__all__ = ["train"]

_NUM_ROUND_ALIASES = (
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "nrounds", "num_boost_round", "n_estimators",
    "max_iter")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None, callbacks=None) -> Booster:
    """Train a booster for num_boost_round iterations (a num_iterations
    alias in params takes precedence, as in the reference)."""
    unported = {"valid_sets": valid_sets, "valid_names": valid_names,
                "fobj": fobj, "feval": feval, "init_model": init_model,
                "callbacks": callbacks}
    given = [k for k, v in unported.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"train({', '.join(given)}=...) is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP.md port queue P10)")
    params = copy.deepcopy(params or {})
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    booster = Booster(params=params, train_set=train_set)
    block = int(booster.config.fused_block_size or 1)
    use_blocks = block > 1 and booster.gbdt._fused_eligible()
    i = 0
    while i < num_boost_round:
        b = min(block, num_boost_round - i) if use_blocks else 1
        if b > 1:
            booster.update_batch(b)
        else:
            booster.update()
        i += b
    # the trained booster keeps no CUDA graphs (update_batch on it
    # captures anew)
    booster.gbdt.release_fused()
    booster.best_iteration = booster.current_iteration()
    return booster
