"""The partition kernel's hand-off from routing and its plan, on the CPU.

On the card, route_rows tallies the rows of each slot in each chunk of
histogram_mxu.CHUNK_ROWS rows while it routes (emit_counts with
chunk_tallies), and the partition kernel (csrc/partition_rows.cu) takes
those tallies in place of a count pass of its own: a warp per slot scans
its row of them into each chunk's first position within the slot and the
slot's total, and each chunk's CTA places its rows from the slots' first
blocks, eight warps of 256 rows, 32 rows a step, staged in shared memory
in slot order, and writes n at the positions no row takes. Held here:
the tallies' plain version (chunk_tallies_ref) — its row sums are
route_rows_ref's counts and the JAX package's
route_rows_mxu(emit_counts=True) in Pallas interpret mode, and the
partition built from it is partition_rows_ref's — and the kernel's index
arithmetic written out in numpy, element for element against
partition_rows_ref, every position written once. Cases: n = 0, 1, a
multiple of the chunk and not; 1, 40 and 511 slots; rows parked at -1
and at slots >= S.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from tests.test_torch_kernels import (M1, N, _inputs, _jax_tables, _t,
                                      _torch_tables)
from tests.test_torch_one_thread import one_thread  # noqa: F401

CHUNK = torch_k.CHUNK_ROWS
WARPS = 8                      # partition_rows.cu kWarps
WARP_ROWS = CHUNK // WARPS


def _slots(n, num_slots, seed):
    """Random row slots in [-1, num_slots + 3): some parked at -1 and at
    slots >= num_slots."""
    return np.random.RandomState(seed).randint(-1, num_slots + 3, n) \
        .astype(np.int32)


def _same_layout(got, want):
    assert all(torch.equal(_t(np.asarray(a)).to(b.dtype), b)
               for a, b in zip(got, want))


@pytest.mark.parametrize("num_slots", [1, 40, 511])
def test_chunk_tallies_sum_to_the_counts(num_slots):
    d = _inputs(51)
    # rows routed to -1 and past the last slot at every width
    sn = np.random.RandomState(52).randint(0, num_slots, M1)
    sn[::7] = -1
    sn[3::11] = num_slots + 2
    d["slot_of_node"] = sn.astype(np.int32)
    tables = _torch_tables(d)
    args = (_t(d["bins"]), _t(d["row_node"]), *tables)
    node, slot, tallies = torch_k.route_rows(
        *args, emit_counts=True, num_slots=num_slots, chunk_tallies=True)
    want_node, want_slot, counts = torch_k.route_rows_ref(
        *args, emit_counts=True, num_slots=num_slots)
    assert torch.equal(node, want_node) and torch.equal(slot, want_slot)
    assert tallies.dtype == torch.int32
    assert tuple(tallies.shape) == (num_slots + 1, -(-N // CHUNK))
    assert N % CHUNK and tallies.shape[1] > 1
    assert torch.equal(tallies, torch_k.chunk_tallies_ref(slot, num_slots))
    assert torch.equal(tallies[:num_slots].sum(1).to(torch.int32), counts)
    s = slot.numpy()
    parked = (s < 0) | (s >= num_slots)
    assert (s < 0).any() and (s >= num_slots).any()
    assert int(tallies[num_slots].sum()) == int(parked.sum())
    assert int(tallies.sum()) == N

    rn_j, rs_j, c_j = jax_k.route_rows_mxu(
        jnp.asarray(d["bins"]), jnp.asarray(d["row_node"]), *_jax_tables(d),
        emit_counts=True, num_slots=num_slots, interpret=True)
    np.testing.assert_array_equal(node.numpy(), np.asarray(rn_j))
    np.testing.assert_array_equal(s, np.asarray(rs_j))
    np.testing.assert_array_equal(tallies[:num_slots].sum(1).numpy(),
                                  np.asarray(c_j))

    # the partition from the tallies is the one that counts for itself
    for nb in (64, 1024):
        _same_layout(
            torch_p.partition_rows_ref(slot, num_slots=num_slots,
                                       row_block=nb, tallies=tallies),
            torch_p.partition_rows_ref(slot, num_slots=num_slots,
                                       row_block=nb))


@pytest.mark.parametrize("n", [0, 1, CHUNK, 2 * CHUNK + 1, 5000])
@pytest.mark.parametrize("num_slots", [1, 40, 511])
def test_chunk_tallies_per_chunk(n, num_slots):
    slot = _slots(n, num_slots, seed=n + num_slots)
    got = torch_k.chunk_tallies_ref(_t(slot), num_slots).numpy()
    c = max(1, -(-n // CHUNK))
    want = np.zeros((num_slots + 1, c), np.int64)
    for i, v in enumerate(slot):
        want[v if 0 <= v < num_slots else num_slots, i // CHUNK] += 1
    np.testing.assert_array_equal(got, want)
    _same_layout(
        torch_p.partition_rows_ref(_t(slot), num_slots=num_slots,
                                   row_block=256, tallies=_t(got)),
        torch_p.partition_rows_ref(_t(slot), num_slots=num_slots,
                                   row_block=256))


def _kernel_layout(slot, s, nb):
    """The partition kernel's index arithmetic in numpy: (block_slot [TB],
    src [TB * nb], bounds [s + 2]) and how often each position is
    written."""
    n = slot.shape[0]
    s1 = s + 1
    c = max(1, -(-n // CHUNK))
    key = np.where((slot < 0) | (slot >= s), s, slot)
    # the tallies: rows per slot and chunk (route_rows' or the count pass)
    tallies = np.zeros((s1, c), np.int64)
    np.add.at(tallies, (key, np.arange(n) // CHUNK), 1)
    # plan: a warp per slot, an exclusive scan of its row over the chunks
    base = np.cumsum(tallies, axis=1) - tallies
    totals = tallies.sum(1)
    # every scatter CTA: the slots' first blocks, the end of their blocks
    caps = np.maximum(1, -(-totals // nb))
    start = np.concatenate([[0], np.cumsum(caps)])
    end = int(start[s1])
    tb = -(-n // nb) + s + 1
    src = np.zeros(tb * nb, np.int64)
    writes = np.zeros(tb * nb, np.int64)
    for ch in range(-(-n // CHUNK)):
        rows = [np.arange(ch * CHUNK + w * WARP_ROWS,
                          min(ch * CHUNK + (w + 1) * WARP_ROWS, n))
                for w in range(WARPS)]
        wcnt = np.stack([np.bincount(key[r], minlength=s1) for r in rows])
        # the chunk staged in slot order; a slot's staged rows are one run
        # of the layout, shifted by its first position + the chunk's prefix
        cnt = wcnt.sum(0)
        loc = np.cumsum(cnt) - cnt
        shift = start[:s1] * nb + base[:, ch] - loc
        # each warp's first staged place per slot: after the earlier warps'
        nxt = loc + np.cumsum(wcnt, 0) - wcnt
        staged = np.zeros(CHUNK, np.int64)
        for w, r in enumerate(rows):
            for t in range(0, r.shape[0], 32):       # a step: 32 lanes
                step = r[t:t + 32]
                for k in np.unique(key[step]):
                    lanes = step[key[step] == k]      # in lane order
                    q = nxt[w, k] + np.arange(lanes.shape[0])
                    staged[q] += 1
                    src[q + shift[k]] = lanes
                    writes[q + shift[k]] += 1
                    nxt[w, k] += lanes.shape[0]
        n_rows = min(CHUNK, n - ch * CHUNK)
        assert (staged[:n_rows] == 1).all() and not staged[n_rows:].any()
    block_slot = np.full(tb, s, np.int64)
    for j in range(min(end, tb)):
        lo, hi = 0, s1                                # binary search
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if start[mid] <= j else (lo, mid)
        block_slot[j] = lo
    for k in range(s1):                               # slot tails
        pad = np.arange(start[k] * nb + totals[k], start[k + 1] * nb)
        src[pad] = n
        writes[pad] += 1
    src[end * nb:] = n                                # past the end
    writes[end * nb:] += 1
    return block_slot, src, start, writes


@pytest.mark.parametrize("n,num_slots,nb", [
    (0, 1, 1024), (1, 1, 1024), (1, 40, 16), (5000, 1, 1024),
    (5000, 40, 64), (2 * CHUNK, 40, 256), (9000, 511, 16),
    (6001, 511, 1024)],
    ids=["empty", "one_row", "one_row_s40", "root", "s40", "two_chunks",
         "s511", "s511_sparse"])
def test_kernel_plan_is_the_partition(n, num_slots, nb):
    slot = _slots(n, num_slots, seed=3 * n + num_slots)
    block_slot, src, bounds, writes = _kernel_layout(slot, num_slots, nb)
    assert (writes == 1).all()
    want_bs, want_src = torch_p.partition_rows_ref(
        _t(slot), num_slots=num_slots, row_block=nb)
    np.testing.assert_array_equal(block_slot, want_bs.numpy())
    np.testing.assert_array_equal(src, want_src.numpy())
    np.testing.assert_array_equal(
        bounds[:num_slots + 1], torch_p.slot_bounds(want_bs, num_slots))


def test_chunk_tallies_need_emit_counts():
    d = _inputs(6)
    with pytest.raises(ValueError, match="chunk_tallies needs emit_counts"):
        torch_k.route_rows(_t(d["bins"]), _t(d["row_node"]),
                           *_torch_tables(d), chunk_tallies=True)


def test_route_kernel_wrapper_checks_table_alignment():
    # the kernel reads a node's table row as two int4: a table that does
    # not start on a 16-byte boundary is refused before the launch
    d = _inputs(6)
    tbl, member, feat_tbl = _torch_tables(d)
    shifted = torch.zeros(tbl.numel() + 1, dtype=torch.int32)[1:] \
        .view(tbl.shape)
    shifted.copy_(tbl)
    with pytest.raises(ValueError, match="16-byte"):
        torch_k._check_route_args(_t(d["bins"]), _t(d["row_node"]), shifted,
                                  member, feat_tbl, 0)


def test_chunk_and_slot_constants_follow_the_kernels():
    # the tallies' chunk is the kernels' (route_hist.cuh), and the
    # partition takes the widest frontier of the growth plan (511 kernel
    # slots at num_leaves 255, overshoot 2) in one launch, its scatter
    # kernel's shared memory (counters, scans, the staged chunk) within
    # the 227 KB a CTA may have
    header = (_cuda.CSRC / "route_hist.cuh").read_text()
    assert int(re.search(r"kChunkRows = (\d+);", header).group(1)) == CHUNK
    cap = torch_p._PARTITION_MAX_SLOTS
    assert cap >= 511
    assert ((WARPS + 4) * (cap + 1) + 2 + WARPS + 2 * CHUNK) * 4 <= 232448
