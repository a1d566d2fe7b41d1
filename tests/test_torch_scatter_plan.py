"""The scatter histogram's run plan, the partition kernel's wrapper checks,
the kernels' launch arguments and node_values at a table wider than the
kernel's shared-memory stage, on the CPU.

`scatter_runs` is the rule by which the scatter kernel
(csrc/build_histograms_scatter.cu) cuts each slot's partition blocks into
runs, and which its plain version sums by; it must cover every slotted
block once, in slot order, and stay within its static bound, from the
root pass (one slot) to the widest frontier (511 slots). The JAX package
is the reference for the histograms and node_values (Pallas in interpret
mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner import histogram_mxu as jax_k
from lightgbm_tpu.learner import histogram_pallas as jax_p
from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.learner import histogram_mxu as torch_k
from lightgbm_tpu_torch.learner import histogram_pallas as torch_p
from tests.test_torch_kernels import BMAX, _assert_hist_close, _inputs, _t
from tests.test_torch_quantized import _quantized_channels, _same_bits


def _plan(n, num_slots, row_block, seed, parked=0.03):
    """A partition of n rows over num_slots slots (a share parked at -1)
    and its runs."""
    r = np.random.RandomState(seed)
    slot = r.randint(0, num_slots, n)
    slot[r.rand(n) < parked] = -1
    block_slot, _ = torch_p.partition_rows_ref(
        _t(slot.astype(np.int32)), num_slots=num_slots, row_block=row_block)
    bounds = torch_p.slot_bounds(block_slot, num_slots)
    runs = torch_p.scatter_runs(bounds, num_slots=num_slots)
    return block_slot.numpy(), bounds.numpy(), runs.numpy()


@pytest.mark.parametrize("n,num_slots,row_block", [
    (200_000, 1, 1024),          # the root pass: one slot, ~200 blocks
    (60_000, 511, 64),           # the widest frontier, slots of 1-3 blocks
    (60_000, 263, 16),           # slots of ~14 blocks: every slot splits
    (5_000, 40, 1024),           # fewer rows than slots' blocks
], ids=["root", "s511", "s263_split", "sparse"])
def test_runs_cover_every_slotted_block_once(n, num_slots, row_block):
    block_slot, bounds, runs = _plan(n, num_slots, row_block, seed=n)
    w = torch_p.RUN_BLOCKS
    tb = block_slot.shape[0]
    first, blocks, slot, part = runs.T
    assert (blocks >= 1).all() and (blocks <= w).all()
    # runs never cross a slot
    for f0, nb, k in zip(first, blocks, slot):
        assert (block_slot[f0:f0 + nb] == k).all()
    # every block of a slot < num_slots lies in exactly one run
    covered = np.zeros(tb, np.int64)
    for f0, nb in zip(first, blocks):
        covered[f0:f0 + nb] += 1
    slotted = block_slot < num_slots
    assert (covered[slotted] == 1).all() and (covered[~slotted] == 0).all()
    # slot by slot, each slot's runs in block order from its first block
    assert (np.diff(slot) >= 0).all()
    for k in range(num_slots):
        mine = first[slot == k]
        assert mine[0] == bounds[k]
        assert (np.diff(mine) == w).all()
    # the static bound
    assert runs.shape[0] <= -(-tb // w) + num_slots


@pytest.mark.parametrize("n,num_slots,row_block", [
    (200_000, 1, 1024), (60_000, 263, 16), (60_000, 511, 64)],
    ids=["root", "s263_split", "s511"])
def test_partials_are_distinct_and_in_run_order(n, num_slots, row_block):
    block_slot, bounds, runs = _plan(n, num_slots, row_block, seed=7)
    w = torch_p.RUN_BLOCKS
    first, blocks, slot, part = runs.T
    nblk = np.diff(bounds)
    split = nblk[slot] > w
    # a slot of at most W blocks is one run that writes the slot
    assert (part[~split] == -1).all()
    assert ((blocks == nblk[slot]) == ~split).all()
    # the runs of a split slot write distinct partials within the buffer
    used = part[split]
    assert len(set(used.tolist())) == used.shape[0]
    assert (used >= 0).all()
    assert (used < 2 * -(-block_slot.shape[0] // w)).all()
    # the kernel's rule: the slot's first run at 2 (first // W) + 1, every
    # later one at 2 (first // W)
    is_first = first == bounds[slot]
    want = 2 * (first // w) + is_first
    assert (part[split] == want[split]).all()


def test_slot_bounds_match_the_layout():
    slot = np.random.RandomState(2).randint(-1, 9, 3000).astype(np.int32)
    block_slot, _ = torch_p.partition_rows_ref(_t(slot), num_slots=9,
                                               row_block=128)
    bounds = torch_p.slot_bounds(block_slot, 9).numpy()
    bs = block_slot.numpy()
    for k in range(9):
        assert (bs[bounds[k]:bounds[k + 1]] == k).all()
        live = int((slot == k).sum())
        assert bounds[k + 1] - bounds[k] == max(1, -(-live // 128))


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["quantized", "exact"])
def test_split_slot_histograms_match_jax(quantized):
    # row_block 64 puts ~50 blocks in the slot, so its runs sum partials
    d = _inputs(21)
    n = d["bins"].shape[0]
    slot = np.where(np.random.RandomState(4).rand(n) < 0.05, -1, 0) \
        .astype(np.int32)
    if quantized:
        g, h, tg, th, tc = _quantized_channels(d, 22)
    else:
        g, h = d["grad"], d["hess"]
        tg, th, tc = _t(g), _t(h), _t(d["cnt"])
    kw = dict(num_slots=1, bmax=BMAX, row_block=64,
              quantized=quantized)
    want = jax_p.build_histograms_scatter(
        jnp.asarray(d["bins"]), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(d["cnt"]), jnp.asarray(slot), interpret=True, **kw)
    got = torch_p.build_histograms_scatter(_t(d["bins"]), tg, th, tc,
                                           _t(slot), **kw)
    if quantized:
        _same_bits(got, want)
    else:
        _assert_hist_close(got, want)
    runs = torch_p.scatter_runs(torch_p.slot_bounds(
        torch_p.partition_rows_ref(_t(slot), num_slots=1,
                                   row_block=64)[0], 1), num_slots=1)
    assert runs.shape[0] > 1 and (runs[:, 3] >= 0).all()


def test_partition_wrapper_on_cpu_is_its_plain_version():
    slot = _t(np.random.RandomState(5).randint(-1, 30, 4000)
              .astype(np.int32))
    got = torch_p.partition_rows(slot, num_slots=30, row_block=256)
    want = torch_p.partition_rows_ref(slot, num_slots=30, row_block=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad,match", [
    (dict(counts=torch.zeros(8, dtype=torch.int64)), "counts: dtype"),
    (dict(counts=torch.zeros(3, dtype=torch.int32)), "counts: shape"),
    (dict(num_slots=torch_p._PARTITION_MAX_SLOTS + 1), "num_slots"),
    (dict(row_slot=torch.zeros(16, dtype=torch.int64)), "row_slot: dtype"),
    (dict(impl="radix"), "partition impl"),
], ids=["counts_dtype", "counts_short", "too_many_slots", "slot_dtype",
        "impl"])
def test_partition_kernel_wrapper_checks_before_launch(bad, match):
    # the checks run before the launch, so a CPU tensor reaches them
    args = dict(row_slot=torch.zeros(16, dtype=torch.int32), num_slots=8,
                row_block=4, counts=None, impl="auto")
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        torch_p._partition(args["row_slot"], args["num_slots"],
                           args["row_block"], args["counts"], args["impl"])


def test_c_args_convert_in_one_pass():
    t = torch.arange(6, dtype=torch.float32)
    got = _cuda.c_args((t, None, 2.5, 7, True, np.int32(-3), t[2:]))
    assert got == [t.data_ptr(), None, 2.5, 7, 1, -3, t.data_ptr() + 8]
    assert isinstance(got[2], float)
    assert all(type(a) is int for a in (got[0], got[3], got[4], got[5]))


def test_kernel_argument_tables_name_every_source():
    assert set(_cuda.KERNELS) == {p.stem for p in _cuda.CSRC.glob("*.cu")}


@pytest.mark.parametrize("m1", [1025, 1500])
def test_node_values_past_the_shared_stage_match_jax(m1):
    # the kernel stages tables of up to 1024 entries in shared memory and
    # reads wider ones through the cache: the plain version is the same
    # function either way
    rng = np.random.RandomState(m1)
    values = rng.randn(m1).astype(np.float32)
    values[[0, 1024, m1 - 1]] = [np.inf, np.nan, -np.inf]
    node = rng.randint(-3, m1 + 3, 5000).astype(np.int32)
    node[:3] = [0, 1024, m1 - 1]
    want = np.asarray(jax_k.node_values_mxu(
        jnp.asarray(node), jnp.asarray(values), interpret=True))
    got = torch_k.node_values(_t(node), _t(values)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[:3] == 0).all()
