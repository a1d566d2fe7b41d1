"""Split-only CEGB (cegb_penalty_split) in the port against the JAX
package, on the CPU: the MXU grower against the JAX booster pinned to its
MXU grower in interpret mode, as test_torch_cegb.py's coupled case, whose
static CEGB settings differ (no coupled term), so the JAX compile is a
file's own. Identical structure, values within 1e-4, the same
feature-used flags after the last tree."""

from tests.test_torch_cegb import check_cegb_mxu_booster
from tests.test_torch_one_thread import one_thread  # noqa: F401


def test_cegb_split_mxu_booster_matches_pinned_jax():
    check_cegb_mxu_booster("split")
