"""Multi-model forest packing: many models, one fused device dispatch.

The port's copy of lightgbm_tpu/serving/multimodel.py. A registry full
of per-tenant models serializes on the predict path when every
`DeviceForest` dispatches alone: N small models cost N kernel launches
per coalescing window even though each launch moves a few thousand rows.
The Booster accelerator (arXiv:2011.02022) shows forest traversal is
throughput-bound on node-fetch parallelism, and the GPU tree-boosting
line (arXiv:1706.08359) takes its inference wins from batching many
trees into one dense kernel; `ForestPack` applies both by padding
heterogeneous member forests into ONE slot-grouped device layout and
answering a mixed batch of (model, rows) pairs in one
`predict_packed_forest` launch (csrc/serve_forest.cu's packed mode on
the card).

Layout:

- every member's tree arrays are padded to common pow-2 node/bitset/
  feature extents and concatenated on the tree axis, member trees
  CONTIGUOUS in slot order, so the f32 accumulation order per member
  is identical to its solo `predict_binned_forest`, which is what makes
  the packed path bit-identical to the per-model device path (and,
  through the dyadic-booster trick, to host predict); `tree_off[s]` is
  the first tree of slot s, known when the pack is built, so the kernel
  walks a slot's range without scanning `tree_model`;
- `tree_model[t]` maps each packed tree to its member slot; each slot
  owns one `row_block`-row block of the batch at offset
  ``slot * row_block``, so per-row traversal cost is independent of
  how many members are resident;
- slots, trees, nodes and features are padded to powers of two and the
  per-dispatch `row_block` goes through the engine's pow-2 bucket
  ladder, keeping the first-seen shapes bounded at
  ``ceil(log2(max_bucket)) + 1`` per *pack*, not per model (the JAX
  package's compile bound; the port compiles nothing per shape, and
  counts them the same way: engine.py).

Pad trees add nothing at all (not an add of +0.0), so tree-axis padding
cannot perturb signed zeros; pad rows are masked inert by `row_valid`
exactly as in the single-model engine.

`dispatch_pack` is the fused dispatch boundary: a registered fault
site (``serving_pack_predict``) inside the replica retry bracket, so
the chaos harness can kill the fused path and watch the breaker /
failover / host-fallback ladder hold for every member at once.
`PackBatcher` extends the continuous-batching `MicroBatcher` with a
slot-grouped dispatch so one queue (one SLO admission model, one
scheduler) serves the whole pack.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..learner.grower import TreeArrays
from ..learner.predict import (_bins_int64, _tree_adds_ref, _tree_at,
                               launch_serve)
from ..learner.histogram_mxu import _on_cpu
from ..utils.log import LightGBMError
from ..utils.timer import global_timer
from .batcher import MicroBatcher, _Request
from .engine import next_bucket
from .forest import DeviceForest, _same_device, bin_dtype_for

__all__ = ["ForestPack", "PackEntry", "PackBatcher", "build_forest_pack",
           "predict_packed_forest", "predict_packed_forest_ref",
           "dispatch_pack"]


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class ForestPack:
    """Several DeviceForests padded into one slot-grouped device layout.

    Presents the same surface the replica fleet needs from a
    DeviceForest (`supported`, `place_on`, `nbytes_device`), so
    `ReplicaSet.build` replicates a pack exactly like a single model.
    """
    name: str
    stacked: object                # TreeArrays, fields [Tp, m1p, ...]
    tree_model: object             # [Tp] int32: packed tree -> slot
    tree_class: object             # [Tp] int32: output column
    num_bins: object               # [Mp, Fp] int32, per-slot tables
    missing_is_nan: object         # [Mp, Fp] bool
    tree_off: object               # [Mp + 1] int32: slot s's trees
    member_names: Tuple[str, ...]  # slot order
    forests: Dict[str, DeviceForest]
    num_slots: int                 # Mp (pow-2 padded member count)
    num_outputs: int               # Kp (pow-2 padded max member outputs)
    num_features: int              # Fp (pow-2 padded max member features)
    num_trees: int                 # real (unpadded) packed tree count
    bin_dtype: object = np.uint8   # the members' widest serving bins

    #: packs only ever contain device-servable members (build_forest_pack
    #: rejects unsupported forests), so the fleet always places them
    supported: bool = True

    def slot_of(self, name: str) -> int:
        return self.member_names.index(name)

    @property
    def device(self) -> torch.device:
        return self.tree_class.device

    def place_on(self, device) -> "ForestPack":
        """The same logical pack with its tensors on `device` (itself
        when they are there already; replica placement: the tensors are
        never written after the build, so replicas share nothing
        mutable)."""
        device = torch.device(device)
        if _same_device(self.device, device):
            return self
        return dataclasses.replace(
            self,
            stacked=TreeArrays(*[t.to(device) for t in self.stacked]),
            tree_model=self.tree_model.to(device),
            tree_class=self.tree_class.to(device),
            num_bins=self.num_bins.to(device),
            missing_is_nan=self.missing_is_nan.to(device),
            tree_off=self.tree_off.to(device))

    def nbytes_device(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.stacked)


def build_forest_pack(members: Sequence[Tuple[str, DeviceForest]],
                      name: str = "pack") -> ForestPack:
    """Pad + concatenate member forests into one ForestPack.

    Tree order inside the pack is member-major in slot order, each
    member's own tree order preserved — the accumulation-order
    invariant behind the bit-identity contract. Raises on empty or
    host-fallback (unsupported) members: those keep serving solo. The
    pack's tensors go on the first member's device.
    """
    if not members:
        raise LightGBMError("build_forest_pack needs at least one member")
    names = [nm for nm, _ in members]
    if len(set(names)) != len(names):
        raise LightGBMError(f"pack '{name}' has duplicate member names")
    for nm, forest in members:
        if not forest.supported:
            raise LightGBMError(
                f"pack member '{nm}' is not device-servable "
                f"({forest.unsupported_reason}); load it unpacked")

    m = len(members)
    mp = _pow2(m)
    hosts = []            # per member: dict of host numpy tree fields
    for nm, forest in members:
        hosts.append({f: getattr(forest.stacked, f).cpu().numpy()
                      for f in TreeArrays._fields})
    t_real = sum(h["leaf_value"].shape[0] for h in hosts)
    tp = _pow2(t_real)
    m1p = _pow2(max(h["leaf_value"].shape[1] for h in hosts))
    wp = _pow2(max(h["cat_bitset"].shape[2] for h in hosts))
    fp = _pow2(max(forest.num_features for _, forest in members))
    kp = _pow2(max(forest.num_outputs for _, forest in members))

    def field(fname: str, fill, dtype) -> np.ndarray:
        sample = hosts[0][fname]
        shape = (tp, m1p, wp) if sample.ndim == 3 else \
            ((tp, m1p) if sample.ndim == 2 else (tp,))
        out = np.full(shape, fill, dtype)
        t0 = 0
        for h in hosts:
            a = h[fname]
            t1 = t0 + a.shape[0]
            if a.ndim == 3:
                out[t0:t1, :a.shape[1], :a.shape[2]] = a
            elif a.ndim == 2:
                out[t0:t1, :a.shape[1]] = a
            else:
                out[t0:t1] = a
            t0 = t1
        return out

    # pad trees are single-leaf (split_feature -1 everywhere) AND
    # cond-skipped in the kernel; pad nodes of real trees are
    # unreachable (no child edge points at them)
    stacked = TreeArrays(
        split_feature=field("split_feature", -1, np.int32),
        threshold_bin=field("threshold_bin", 0, np.int32),
        default_left=field("default_left", False, bool),
        is_cat=field("is_cat", False, bool),
        cat_bitset=field("cat_bitset", 0, np.int64),
        left=field("left", -1, np.int32),
        right=field("right", -1, np.int32),
        parent=field("parent", -1, np.int32),
        leaf_value=field("leaf_value", 0.0, np.float32),
        sum_grad=field("sum_grad", 0.0, np.float32),
        sum_hess=field("sum_hess", 0.0, np.float32),
        count=field("count", 0.0, np.float32),
        gain=field("gain", 0.0, np.float32),
        depth=field("depth", 0, np.int32),
        is_leaf=field("is_leaf", True, bool),
        num_nodes=field("num_nodes", 0, np.int32),
        num_leaves=field("num_leaves", 0, np.int32))
    device = members[0][1].device

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    stacked = TreeArrays(*[dev(a) for a in stacked])

    tree_model = np.zeros(tp, np.int32)
    tree_class = np.zeros(tp, np.int32)
    tree_off = np.full(mp + 1, t_real, np.int32)
    t0 = 0
    for slot, (nm, forest) in enumerate(members):
        t1 = t0 + forest.num_trees
        tree_model[t0:t1] = slot
        tree_class[t0:t1] = forest.tree_class.cpu().numpy()
        tree_off[slot] = t0
        t0 = t1

    # per-slot binning tables; pad slots/features get num_bin 1 (bin 0
    # is their only value, never a NaN bin) and are unreferenced anyway
    num_bins = np.ones((mp, fp), np.int32)
    missing = np.zeros((mp, fp), bool)
    for slot, (nm, forest) in enumerate(members):
        f = forest.num_features
        num_bins[slot, :f] = forest.num_bins.cpu().numpy()
        missing[slot, :f] = forest.missing_is_nan.cpu().numpy()

    return ForestPack(
        name=name, stacked=stacked,
        tree_model=dev(tree_model),
        tree_class=dev(tree_class),
        num_bins=dev(num_bins),
        missing_is_nan=dev(missing),
        tree_off=dev(tree_off),
        member_names=tuple(names),
        forests={nm: forest for nm, forest in members},
        num_slots=mp, num_outputs=kp, num_features=fp,
        num_trees=t_real, bin_dtype=bin_dtype_for(int(num_bins.max())))


def predict_packed_forest_ref(stacked, tree_model, tree_class, t_real,
                              bins, num_bins, missing_is_nan,
                              num_outputs: int = 1, row_block: int = 16,
                              row_valid=None) -> torch.Tensor:
    """Plain version of predict_packed_forest: the JAX package's
    fori_loop over the packed trees, tree i < t_real walking its slot's
    row block against the slot's tables and adding into the block's
    column tree_class[i] from +0.0; trees from t_real on are skipped."""
    total = bins.shape[0]
    b = _bins_int64(bins)
    valid = torch.ones(total, dtype=torch.bool, device=bins.device) \
        if row_valid is None else row_valid.to(torch.bool)
    acc = torch.zeros((total, num_outputs), dtype=torch.float32,
                      device=bins.device)
    t_real = int(t_real)
    slots = tree_model[:t_real].tolist()
    classes = tree_class[:t_real].tolist()
    for i in range(t_real):
        s, c = int(slots[i]), int(classes[i])
        if not 0 <= c < num_outputs:
            continue
        off = s * row_block
        vals = _tree_adds_ref(_tree_at(stacked, i), b[off:off + row_block],
                              num_bins[s], missing_is_nan[s],
                              valid[off:off + row_block])
        acc[off:off + row_block, c] = acc[off:off + row_block, c] + vals
    return acc


def predict_packed_forest(stacked, tree_model, tree_class, t_real,
                          bins, num_bins, missing_is_nan,
                          num_outputs: int = 1, row_block: int = 16,
                          row_valid=None, tree_off=None) -> torch.Tensor:
    """Fused multi-model forest sum: one launch, every resident model.

    bins: [Mp * row_block, Fp] (uint8, uint16 or int32); slot s owns
    rows ``[s*row_block, (s+1)*row_block)``. Each packed tree walks its
    slot's row block against the SLOT's binning tables (exact
    missing/categorical semantics per member) and accumulates into the
    slot's block of the output: per-member accumulation order is the
    member's own tree order, so every real row is bit-identical to the
    member's solo forest sum. Pad trees (``i >= t_real``) add nothing
    at all, so padding cannot flip signed zeros; pad rows (row_valid
    false) come out 0.0. `tree_off` ([Mp + 1] int32, the pack's) gives
    each slot's tree range; the card needs it (ROADMAP C27), the plain
    version reads tree_model, as the JAX signature has it. Returns
    [Mp * row_block, num_outputs] raw f32 scores: one launch of
    csrc/serve_forest.cu's packed mode on the card, the plain version on
    CPU tensors.
    """
    if _on_cpu(bins, tree_model, tree_class, num_bins, missing_is_nan,
               stacked.split_feature):
        return predict_packed_forest_ref(
            stacked, tree_model, tree_class, t_real, bins, num_bins,
            missing_is_nan, num_outputs, row_block, row_valid)
    if tree_off is None:
        raise ValueError("tree_off: the packed kernel walks each slot's "
                         "trees as one range; pass the pack's tree_off")
    return launch_serve("serve_packed", stacked, tree_class, bins, num_bins,
                        missing_is_nan, num_outputs, row_valid,
                        bins.shape[0], tree_off=tree_off,
                        row_block=row_block)


def dispatch_pack(engine, pack: ForestPack,
                  requests: Sequence[Tuple[int, np.ndarray]],
                  metrics_by_slot: Optional[Dict[int, object]] = None,
                  pack_metrics=None) -> np.ndarray:
    """One fused device dispatch answering a mixed (slot, bins) batch.

    Rows are grouped per slot, chunked through the engine's pow-2
    bucket ladder (`row_block` = next_bucket of the largest slot's
    rows this round; a slot with more rows than `max_bucket` takes
    extra rounds), assembled into the slot-grouped layout and scored
    by ONE `predict_packed_forest` launch per round. Returns the raw
    [sum(rows), num_outputs] scores in request order. Compile
    accounting rides the engine's bucket cache keyed on the pack, so
    the ladder bound applies per pack, not per member.
    """
    from ..observability import registry as _obs
    from ..reliability import faults

    # registered fault site: the fused multi-model dispatch boundary
    # (replica retry/failover bracket lives in replicas.dispatch)
    faults.inject("serving_pack_predict")

    if not requests:
        return np.zeros((0, pack.num_outputs), np.float32)
    with global_timer.timeit("serve_pack_predict"):
        by_slot: Dict[int, List[np.ndarray]] = {}
        spans: List[Tuple[int, int, int]] = []   # (slot, start, rows)
        for slot, bins in requests:
            chunks = by_slot.setdefault(slot, [])
            start = sum(c.shape[0] for c in chunks)
            chunks.append(np.asarray(bins, pack.bin_dtype))
            spans.append((slot, start, bins.shape[0]))
        slot_bins = {s: (c[0] if len(c) == 1 else np.concatenate(c))
                     for s, c in by_slot.items()}
        done: Dict[int, List[np.ndarray]] = {s: [] for s in slot_bins}
        offs = {s: 0 for s in slot_bins}
        while True:
            this_round = {
                s: min(len(b) - offs[s], engine.max_bucket)
                for s, b in slot_bins.items() if offs[s] < len(b)}
            if not this_round:
                break
            block = next_bucket(max(this_round.values()),
                                engine.min_bucket, engine.max_bucket)
            packed = np.zeros((pack.num_slots * block,
                               pack.num_features), pack.bin_dtype)
            valid = np.zeros(pack.num_slots * block, bool)
            for s, r in this_round.items():
                chunk = slot_bins[s][offs[s]:offs[s] + r]
                packed[s * block:s * block + r, :chunk.shape[1]] = chunk
                valid[s * block:s * block + r] = True
            hit = engine._record(pack, block)
            if metrics_by_slot:
                for s in this_round:
                    m = metrics_by_slot.get(s)
                    if m is not None:
                        m.record_batch(bucket_hit=hit, compiled=not hit)
            _t0 = time.perf_counter()
            dev = pack.device
            raw = predict_packed_forest(
                pack.stacked, pack.tree_model, pack.tree_class,
                pack.num_trees, torch.from_numpy(packed).to(dev),
                pack.num_bins, pack.missing_is_nan,
                num_outputs=pack.num_outputs, row_block=block,
                row_valid=torch.from_numpy(valid).to(dev),
                tree_off=pack.tree_off)
            raw = raw.cpu().numpy()        # device -> host sync
            _dt = time.perf_counter() - _t0
            if _obs.enabled:
                # a pack bucket-cache miss is the first dispatch of this
                # block shape (the JAX package's compilation of the fused
                # predictor for it)
                _obs.compiles.record(f"serving_pack_b{block}", _dt,
                                     compiled=not hit)
                _obs.trace.add("serve_pack_predict", _t0, _dt,
                               block=block, slots=len(this_round),
                               rows=sum(this_round.values()))
            if pack_metrics is not None:
                pack_metrics.record_dispatch(
                    rows=sum(this_round.values()),
                    capacity=pack.num_slots * block,
                    slots=len(this_round), compiled=not hit)
            for s, r in this_round.items():
                done[s].append(raw[s * block:s * block + r])
                offs[s] += r
        slot_raw = {s: (c[0] if len(c) == 1 else np.concatenate(c))
                    for s, c in done.items()}
        return np.concatenate(
            [slot_raw[s][start:start + rows]
             for s, start, rows in spans], axis=0)


class PackBatcher(MicroBatcher):
    """One continuous-batching queue for a whole ForestPack.

    Requests carry their member's slot; each coalesced batch becomes
    ONE fused dispatch (`run_pack([(slot, bins), ...]) -> raw rows in
    request order`) instead of one launch per member. Inherits the
    scheduler, SLO admission (rows-aware service model — essential
    here, where members of very different sizes share the queue) and
    drain semantics unchanged.
    """

    def __init__(self, run_pack, **kwargs):
        self._run_pack = run_pack
        super().__init__(run_batch=None, **kwargs)

    def _dispatch(self, batch: List[_Request]) -> None:
        raw = self._run_pack([(r.slot, r.bins) for r in batch])
        lo = 0
        for req in batch:
            hi = lo + len(req.bins)
            req.future.set_result(raw[lo:hi])
            lo = hi


@dataclasses.dataclass
class PackEntry:
    """Shared serving machinery for one resident ForestPack: the fused
    device layout, its replica fleet, the slot-aware batcher and the
    pack-level metrics. Member `ModelEntry`s point here; a rebuild
    (member evict / hot-swap) publishes a NEW PackEntry and drains the
    old batcher through the host path — same semantics as a
    single-model hot swap."""
    name: str
    pack: ForestPack
    replicas: object               # ReplicaSet over the pack
    batcher: Optional[PackBatcher]
    metrics: object                # metrics.PackMetrics
    version: int = 1
    #: slot -> the member ModelEntry's ModelMetrics, filled by the
    #: registry as it publishes member entries (the fused dispatch
    #: records per-member batch/compile counts through it)
    slot_metrics: Dict[int, object] = dataclasses.field(
        default_factory=dict)

    def member_names(self) -> Tuple[str, ...]:
        return self.pack.member_names
