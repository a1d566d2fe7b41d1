"""The card's design of fused_route_hist, composed from plain versions.

On the card, histogram_mxu.fused_route_hist routes the rows with their
tallies per slot and partition chunk (route_rows, emit_counts and
chunk_tallies), partitions them by their new slot from those tallies, with
no count pass of the partition's own (histogram_pallas.partition_rows), and
sums them with the slot-grouped scatter kernel (build_histograms_scatter).
Here the same composition runs on the kernels' plain versions, on the CPU,
and is held bit for bit to fused_route_hist_ref (every histogram sums
integers) and to the JAX package's fused_route_hist_mxu in Pallas
interpret mode within the K1 bars of tests/test_torch_kernels.py (integer
mode bit for bit): exact and integer channels, unpacked and 4-bit packed
bins, with and without a constant hessian, at one slot (the root pass: a
partition of several runs, whose partials the reduce adds) and at a
frontier of 40 slots with rows parked at slot -1 and at slots >= S, and
with a non-finite channel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from tests.test_torch_kernels import (BMAX, NUM_SLOTS, _assert_hist_close,
                                      _inputs, _jax_tables, _t,
                                      _torch_tables)
from tests.test_torch_packed import BMAX4, _inputs4, _jax_tables4
from tests.test_torch_quantized import _quantized_channels, _same_bits
from tests.test_torch_one_thread import one_thread  # noqa: F401

# rows a partition block holds here: at the tests' 3500 rows one slot
# takes 14 blocks, four runs of the scatter kernel
ROW_BLOCK = 256
PACKED_F = 7


def card_design(bins, grad, hess, cnt, row_node, tables, *, num_slots,
                bmax, const_hess=0.0, quantized=False, num_features=0,
                scale=None):
    """fused_route_hist's function as the card computes it, on the plain
    versions: route with chunk tallies, partition from the tallies,
    scatter."""
    node, slot, tallies = torch_k.route_rows_ref(
        bins, row_node, *tables, num_features=num_features,
        emit_counts=True, num_slots=num_slots, chunk_tallies=True)
    # the tallies the routing hands over are the ones the partition would
    # take itself: the same layout
    given = torch_p.partition_rows_ref(slot, num_slots=num_slots,
                                       row_block=ROW_BLOCK, tallies=tallies)
    own = torch_p.partition_rows_ref(slot, num_slots=num_slots,
                                     row_block=ROW_BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(given, own))
    hist = torch_p.build_histograms_scatter_ref(
        bins, grad, hess, cnt, slot, num_slots=num_slots, bmax=bmax,
        row_block=ROW_BLOCK, num_features=num_features,
        const_hess=const_hess, quantized=quantized, slot_tallies=tallies,
        scale=scale)
    return hist, node


def _case(packed, quantized, num_slots):
    """(numpy inputs, bins for the port and JAX, JAX tables, bmax,
    num_features, port channels, JAX channels). One slot: the tables send
    every row that had a slot below NUM_SLOTS to slot 0, the rest stay
    parked (-1 and >= 1), as at the root pass."""
    d = _inputs4(12, PACKED_F) if packed else _inputs(12)
    if num_slots == 1:
        s = d["slot_of_node"]
        d["slot_of_node"] = np.where((s >= 0) & (s < NUM_SLOTS), 0, s)
    if packed:
        bins = jax_k.pack_bins_4bit(d["bins"])
        jt, bmax, nf = _jax_tables4(d), BMAX4, PACKED_F
    else:
        bins, jt, bmax, nf = d["bins"], _jax_tables(d), BMAX, 0
    if quantized:
        g, h, tg, th, tc = _quantized_channels(d, 13)
    else:
        g, h = d["grad"], d["hess"]
        tg, th, tc = _t(g), _t(h), _t(d["cnt"])
    return d, bins, jt, bmax, nf, (tg, th, tc), (g, h, d["cnt"])


@pytest.mark.parametrize("num_slots", [1, NUM_SLOTS], ids=["root", "S40"])
@pytest.mark.parametrize("const_hess", [0.0, 1.0], ids=["hess", "const"])
@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int"])
def test_card_design_equals_fused_route_hist(quantized, packed, const_hess,
                                             num_slots):
    d, bins, jt, bmax, nf, chan_t, chan_j = _case(packed, quantized,
                                                  num_slots)
    tables = _torch_tables(d)
    kw = dict(num_slots=num_slots, bmax=bmax, const_hess=const_hess,
              quantized=quantized, num_features=nf)
    hist, node = card_design(_t(bins), *chan_t, _t(d["row_node"]), tables,
                             **kw)
    want, want_node = torch_k.fused_route_hist_ref(
        _t(bins), *chan_t, _t(d["row_node"]), *tables, **kw)
    assert torch.equal(node, want_node)
    _same_bits(hist, want.numpy())
    # rows parked at slot -1 and at slots >= S, and every slot fed; the
    # root pass's one slot spans several runs of the scatter kernel
    slot = torch_k.route_rows_ref(_t(bins), _t(d["row_node"]), *tables,
                                  num_features=nf)[1].numpy()
    assert (slot < 0).any() and (slot >= num_slots).any()
    assert (hist[..., 2].sum(dim=(1, 2)) > 0).all()
    if num_slots == 1:
        assert (slot == 0).sum() > ROW_BLOCK * torch_p.RUN_BLOCKS

    h_j, rn_j = jax_k.fused_route_hist_mxu(
        jnp.asarray(bins), *(jnp.asarray(a) for a in chan_j),
        jnp.asarray(d["row_node"]), *jt, has_cat=True, interpret=True, **kw)
    _same_bits(node, rn_j)
    if quantized:
        _same_bits(hist, h_j)
    else:
        _assert_hist_close(hist, h_j)


@pytest.mark.parametrize("bad", ["nan_grad", "inf_hess"])
def test_card_design_keeps_non_finite_channels(bad):
    # a non-finite value in a slotted row: that channel is NaN in every
    # cell, the others are untouched, as fused_route_hist_ref has them; the
    # JAX kernel spreads it over the row's slot, a subset of those cells
    d = _inputs(14)
    tables = _torch_tables(d)
    slot = torch_k.route_rows_ref(_t(d["bins"]), _t(d["row_node"]),
                                  *tables)[1].numpy()
    row = np.nonzero((slot >= 0) & (slot < NUM_SLOTS))[0][3]
    chan = 0 if bad == "nan_grad" else 1
    d["grad" if chan == 0 else "hess"][row] = np.nan if chan == 0 \
        else np.inf
    chan_t = tuple(_t(d[k]) for k in ("grad", "hess", "cnt"))
    kw = dict(num_slots=NUM_SLOTS, bmax=BMAX)
    hist, _ = card_design(_t(d["bins"]), *chan_t, _t(d["row_node"]),
                          tables, **kw)
    want, _ = torch_k.fused_route_hist_ref(_t(d["bins"]), *chan_t,
                                           _t(d["row_node"]), *tables, **kw)
    _same_bits(hist, want.numpy())
    h = hist.numpy()
    assert np.isnan(h[..., chan]).all()
    for c in {0, 1, 2} - {chan}:
        assert np.isfinite(h[..., c]).all()
    h_j, _ = jax_k.fused_route_hist_mxu(
        *(jnp.asarray(d[k]) for k in ("bins", "grad", "hess", "cnt",
                                      "row_node")),
        *_jax_tables(d), has_cat=True, interpret=True, **kw)
    h_j = np.asarray(h_j)
    assert (np.isfinite(h) <= np.isfinite(h_j)).all()
    assert not np.isfinite(h_j[..., chan]).all()
    np.testing.assert_array_equal(h[..., 2], h_j[..., 2])
