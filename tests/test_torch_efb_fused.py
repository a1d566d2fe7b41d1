"""The fused trainer under EFB: engine.train at a small fused_block_size
byte-equal to update() calls on bundled data, exact and quantized, the
segmented scan and the expansion, GOSS and multiclass (the data of
tests/test_torch_efb.py, device_type cpu), at efb_use_mxu=true: bundled
data takes the MXU grower, and so the fused trainer, only there."""

import re

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from tests.test_torch_efb import _BASE, _port_booster, _sparse_X
from tests.test_torch_one_thread import one_thread  # noqa: F401


def _strip(text):
    return re.sub(r"\[fused_block_size: .*\]\n", "", text)


_FUSED = {
    "exact": {},
    "quantized": {"use_quantized_grad": True},
    "expansion": {"efb_segmented_scan": False},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "multiclass": {"objective": "multiclass", "num_class": 3},
}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_train_equals_update_under_efb(name):
    X, logit = _sparse_X(7, n=1500, f=24, with_nan=True)
    # efb_use_mxu: bundled data on the MXU grower, so on the fused trainer
    params = dict(_BASE, device_type="cpu", fused_block_size=3,
                  efb_use_mxu=True, **_FUSED[name])
    if params["objective"] == "multiclass":
        y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])) \
            .astype(np.float32)
    else:
        y = (logit > np.median(logit)).astype(np.float32)
    trained = lgt.train(params, lgt.Dataset(X, label=y, params=params), 6)
    assert trained.gbdt._efb is not None
    assert trained.gbdt.fused_stats, "the fused trainer ran"
    stepped = _port_booster(X, y, params, 6)
    assert _strip(trained.model_to_string()) == \
        _strip(stepped.model_to_string())
