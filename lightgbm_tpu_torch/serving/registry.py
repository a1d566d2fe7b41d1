"""Model registry: load a Booster once, serve it many times.

The port's copy of lightgbm_tpu/serving/registry.py; its forests are
built on the registry's `device` (the server's). Each entry pins one
model's `DeviceForest` (stacked TreeArrays + host binners) in device
memory so the request hot path never re-stacks tree arrays or re-parses
a model file. Lifecycle is explicit:

- `load(name, ...)`   Booster / model file / model string -> resident
- `refresh(name, ...)` atomically swap in a new version (in-flight
  requests finish against the old tensors, which are never written
  after the build, so the swap is just a reference move)
- `evict(name)`       drop the entry; device memory frees with the
  last array reference

An entry owns everything a request needs — forest, replica set, micro
batcher — so the server fetches ONE reference and serves the request
against a consistent snapshot: a refresh can never pair the new forest
with the old queue (no torn model). The registry builds the entry
fully (replicas placed, batcher worker running) *before* publishing
it, then hands the previous entry back to the caller, which drains the
old batcher outside the lock.

Health is derived, not sticky: `entry.degraded` is computed from the
replica breakers (`serving/breaker.py`) and heals itself when a probe
dispatch closes a breaker (no sticky manual-refresh flag).

Capacity is bounded: loading past `max_models` evicts the least
recently *used* entry (use = a `get`), mirroring the bucket cache's
"bounded resources, predictable behavior" contract.

Multi-model packs (serving/multimodel.py): `load_pack` loads several
models into ONE fused device layout; each member still gets its own
`ModelEntry` (own metrics, own host fallback booster) but `pack` /
`pack_slot` point at the shared `PackEntry` that owns the ForestPack,
its replica fleet and the slot-aware batcher. Membership is sticky
through lifecycle events, each of which REBUILDS the pack off-lock and
publishes atomically with hot-swap drain semantics:

- LRU-evicting one member republishes the pack without it; the other
  members keep serving (briefly against the old pack) and queued
  futures on the old batcher — including the evicted member's —
  resolve `BatcherClosed` and re-answer through each member's host
  path, exactly once.
- Refreshing (hot-swapping) one member republishes the pack with the
  member's new forest in the same slot layout.
- Evicting the last member drops the whole PackEntry.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.log import Log, LightGBMError
from .forest import DeviceForest
from .metrics import ModelMetrics
from .replicas import ReplicaSet

__all__ = ["ModelRegistry", "ModelEntry"]


@dataclass
class ModelEntry:
    name: str
    forest: DeviceForest
    booster: object                     # the source Booster (host fallback)
    metrics: ModelMetrics
    loaded_at: float
    version: int = 1
    last_used: float = field(default=0.0)
    # device-side replica fleet (empty for unsupported forests); the
    # breakers inside it carry this entry's health
    replicas: Optional[ReplicaSet] = None
    # micro-batching queue bound to THIS entry's forest+replicas; the
    # server submits to entry.batcher so a refresh can never route old
    # queued bins to a new forest
    batcher: object = None
    # pack membership (serving/multimodel.py): the shared PackEntry
    # whose fused dispatch serves this model, and this model's slot in
    # it. Pack members have replicas=None/batcher=None — the pack owns
    # both.
    pack: object = None
    pack_slot: int = -1

    @property
    def degraded(self) -> bool:
        """Device path unavailable right now. Derived from breaker
        state — heals itself when a replica's half-open probe closes
        its breaker (unlike a sticky flag, cleared only by a manual
        refresh). Pack members derive health from the PACK's
        replica fleet."""
        if not self.forest.supported:
            return True
        replicas = self.pack.replicas if self.pack is not None \
            else self.replicas
        if replicas is None or len(replicas) == 0:
            return True
        return not replicas.any_available()


def _forest_from_source(booster=None, model_file: Optional[str] = None,
                        model_str: Optional[str] = None, device="cpu"):
    from ..basic import Booster
    if booster is None:
        if model_file is None and model_str is None:
            raise LightGBMError(
                "registry.load needs a booster, model_file or model_str")
        booster = Booster(model_file=model_file, model_str=model_str)
    forest = booster.device_forest(device)
    return booster, forest


class ModelRegistry:
    """Thread-safe name -> ModelEntry map with LRU capacity.

    `replica_factory(forest, name) -> ReplicaSet` and
    `batcher_factory(entry) -> MicroBatcher` are injected by the
    server so the registry stays free of routing policy; both may be
    None (registry-only tests get bare entries). `device` is where the
    forests are built (the server's device; the CPU by default).

    `host_fallback` False (the card's server, ROADMAP C29) refuses a
    forest the kernel cannot serve at load, and drains a replaced
    entry's queue through its OLD forest on the device instead of
    through host predict.
    """

    def __init__(self, max_models: int = 8,
                 replica_factory: Optional[Callable] = None,
                 batcher_factory: Optional[Callable] = None,
                 pack_batcher_factory: Optional[Callable] = None,
                 device="cpu", host_fallback: bool = True):
        if max_models < 1:
            raise ValueError("max_models must be >= 1")
        self.max_models = int(max_models)
        self.device = device
        self.host_fallback = bool(host_fallback)
        self._entries: Dict[str, ModelEntry] = {}
        self._lock = threading.RLock()
        self.replica_factory = replica_factory
        self.batcher_factory = batcher_factory
        # pack_batcher_factory(pack_entry) -> PackBatcher; the replica
        # factory is reused as-is (ReplicaSet.build is polymorphic
        # over DeviceForest / ForestPack)
        self.pack_batcher_factory = pack_batcher_factory
        self.swap_count = 0
        self.pack_rebuilds = 0

    # ------------------------------------------------------------------
    def load(self, name: str, booster=None,
             model_file: Optional[str] = None,
             model_str: Optional[str] = None) -> ModelEntry:
        """Build + pin the device forest for `name`. Idempotent per
        name: loading an existing name is a hot-swap (the previous
        entry's batcher is drained through the host path, see
        `Server.hot_swap`)."""
        entry, prev = self._load_prepared(name, booster, model_file,
                                          model_str)
        # a plain load of an existing name still must not strand the
        # old entry's queue; drain it here (hot_swap does its own
        # drain + accounting before calling _load_prepared)
        self._drain_replaced(prev)
        return entry

    def _load_prepared(self, name, booster=None, model_file=None,
                       model_str=None):
        """Build the full entry (forest, replicas, running batcher),
        publish it atomically, return (entry, previous_entry).

        When `name` is currently a PACK member and the new forest is
        device-servable, the whole pack is rebuilt with the member's
        new forest (same hot-swap semantics, pack-wide); an
        unsupported replacement leaves the pack and serves solo."""
        booster, forest = _forest_from_source(booster, model_file,
                                              model_str, self.device)
        self._check_servable(name, forest)
        with self._lock:
            prior = self._entries.get(name)
        if prior is not None and prior.pack is not None and \
                forest.supported:
            self._rebuild_pack(prior.pack,
                               replace={name: (booster, forest)})
            with self._lock:
                entry = self._entries[name]
                self.swap_count += 1
                evicted = self._evict_over_capacity_locked()
            self._handle_evicted(evicted)
            Log.info(f"serving: loaded model '{name}' v{entry.version} "
                     f"into pack '{entry.pack.name}' "
                     f"({forest.num_trees} trees)")
            return entry, prior
        if prior is not None and prior.pack is not None:
            # member turned host-only: drop it from the pack first so
            # the remaining members keep their fused path
            self._rebuild_pack(prior.pack, drop={name})
        replicas = (self.replica_factory(forest, name)
                    if self.replica_factory else None)
        with self._lock:
            prev = self._entries.get(name)
            prev = prior if prior is not None else prev
            entry = ModelEntry(
                name=name, forest=forest, booster=booster,
                metrics=prev.metrics if prev else ModelMetrics(),
                loaded_at=time.monotonic(),
                version=(prev.version + 1) if prev else 1,
                last_used=time.monotonic(),
                replicas=replicas)
            if self.batcher_factory is not None:
                entry.batcher = self.batcher_factory(entry)
            self._entries[name] = entry
            if prev is not None:
                self.swap_count += 1
            evicted = self._evict_over_capacity_locked()
        self._handle_evicted(evicted)
        if not forest.supported:
            Log.warning(
                f"serving model '{name}' on the host fallback path: "
                f"{forest.unsupported_reason}")
        Log.info(f"serving: loaded model '{name}' v{entry.version} "
                 f"({forest.num_trees} trees, "
                 f"{forest.num_features} features)")
        return entry, prev

    def _check_servable(self, name: str, forest) -> None:
        """Without the host rung (the card's server, ROADMAP C29) a
        forest the kernel cannot serve is refused at load."""
        if not self.host_fallback and not forest.supported:
            raise LightGBMError(
                f"model '{name}' cannot be served on {self.device}: "
                f"{forest.unsupported_reason}")

    def _drain_replaced(self, prev: Optional[ModelEntry]) -> int:
        """Close a replaced/evicted entry's batcher. With the host rung,
        queued requests resolve with `BatcherClosed` and the server
        re-answers each via the OLD entry's host path (its `_finish`
        closed over the entry); without it (ROADMAP C29) the old worker
        dispatches them through the OLD forest before it stops. Either
        way nothing is dropped or served by a torn model. For a replaced
        PACK member the drain target is the old PackEntry's batcher (the
        rebuild already republished the survivors)."""
        if prev is None:
            return 0
        if prev.pack is not None:
            return self._drain_pack(prev.pack)
        if prev.batcher is None:
            return 0
        drained = prev.batcher.close(drain_queued=not self.host_fallback)
        if drained:
            prev.metrics.record_swap_drain(drained)
        return drained

    def _drain_pack(self, old_pe) -> int:
        """Close a replaced/dropped PackEntry's batcher with hot-swap
        drain semantics. Idempotent: a second close of an already
        closed batcher drains nothing and records nothing twice."""
        if old_pe.batcher is None:
            return 0
        drained = old_pe.batcher.close(drain_queued=not self.host_fallback)
        old_pe.metrics.record_rebuild(drained)
        return drained

    # ------------------------------------------------------------------
    def load_pack(self, pack_name: str, members) -> List[ModelEntry]:
        """Load several models as ONE fused ForestPack.

        `members` is a sequence of ``(name, booster)`` pairs (or
        ``(name, {"model_file": ...})`` / ``{"model_str": ...}``
        dicts). Members whose forest cannot be served from the device
        load unpacked — a solo host-fallback entry with a warning — so
        one exotic model never blocks its pack-mates' fused path.
        Returns the member entries in input order."""
        from .metrics import PackMetrics
        from .multimodel import PackEntry, build_forest_pack
        built = []
        for nm, src in members:
            kw = dict(src) if isinstance(src, dict) else {"booster": src}
            booster, forest = _forest_from_source(**kw,
                                                  device=self.device)
            self._check_servable(nm, forest)
            built.append((nm, booster, forest))
        packable = [(nm, b, f) for nm, b, f in built if f.supported]
        unpackable = [(nm, b, f) for nm, b, f in built
                      if not f.supported]
        by_name: Dict[str, ModelEntry] = {}
        new_pe = None
        if packable:
            pack = build_forest_pack(
                [(nm, f) for nm, _b, f in packable], name=pack_name)
            replicas = (self.replica_factory(pack, pack_name)
                        if self.replica_factory else None)
            new_pe = PackEntry(name=pack_name, pack=pack,
                               replicas=replicas, batcher=None,
                               metrics=PackMetrics())
            if self.pack_batcher_factory is not None:
                new_pe.batcher = self.pack_batcher_factory(new_pe)
        prevs: List[Optional[ModelEntry]] = []
        now = time.monotonic()
        with self._lock:
            for slot, (nm, b, f) in enumerate(packable):
                prev = self._entries.get(nm)
                prevs.append(prev)
                entry = ModelEntry(
                    name=nm, forest=f, booster=b,
                    metrics=prev.metrics if prev else ModelMetrics(),
                    loaded_at=now,
                    version=(prev.version + 1) if prev else 1,
                    last_used=now, pack=new_pe, pack_slot=slot)
                new_pe.slot_metrics[slot] = entry.metrics
                self._entries[nm] = entry
                by_name[nm] = entry
                if prev is not None:
                    self.swap_count += 1
            evicted = self._evict_over_capacity_locked()
        # replaced entries drain off-lock; a member poached from
        # ANOTHER pack rebuilds that pack without it (grouped, once)
        self._handle_evicted(
            [p for p in prevs if p is not None] + evicted)
        for nm, b, f in unpackable:
            Log.warning(
                f"serving: pack member '{nm}' is not device-servable "
                f"({f.unsupported_reason}); loading unpacked on the "
                f"host path")
            by_name[nm] = self.load(nm, booster=b)
        if new_pe is not None:
            Log.info(f"serving: loaded pack '{pack_name}' with "
                     f"{len(packable)} members "
                     f"({new_pe.pack.num_trees} trees, "
                     f"{new_pe.pack.num_slots} slots)")
        return [by_name[nm] for nm, _b, _f in built]

    def _rebuild_pack(self, old_pe, drop=frozenset(), replace=None):
        """Republish `old_pe`'s pack without the `drop` members and/or
        with `replace`d forests ({name: (booster, forest)}), keeping
        the surviving slot ORDER. The device build runs OFF-lock; the
        member entries publish atomically; the OLD batcher keeps
        serving until the caller drains it (hot-swap semantics).
        Returns the new PackEntry, or None when no members remain
        (whole-pack drop)."""
        from .multimodel import PackEntry, build_forest_pack
        replace = replace or {}
        with self._lock:
            members = []
            for nm in old_pe.member_names():
                if nm in drop:
                    continue
                if nm in replace:
                    b, f = replace[nm]
                    members.append((nm, b, f))
                    continue
                e = self._entries.get(nm)
                if e is not None and e.pack is old_pe:
                    members.append((nm, e.booster, e.forest))
        if not members:
            return None
        pack = build_forest_pack(
            [(nm, f) for nm, _b, f in members], name=old_pe.name)
        replicas = (self.replica_factory(pack, old_pe.name)
                    if self.replica_factory else None)
        new_pe = PackEntry(name=old_pe.name, pack=pack,
                           replicas=replicas, batcher=None,
                           metrics=old_pe.metrics,
                           version=old_pe.version + 1)
        if self.pack_batcher_factory is not None:
            new_pe.batcher = self.pack_batcher_factory(new_pe)
        now = time.monotonic()
        with self._lock:
            for slot, (nm, b, f) in enumerate(members):
                prior = self._entries.get(nm)
                entry = ModelEntry(
                    name=nm, forest=f, booster=b,
                    metrics=prior.metrics if prior is not None
                    else ModelMetrics(),
                    loaded_at=now,
                    version=(prior.version + 1) if prior is not None
                    else 1,
                    last_used=prior.last_used if prior is not None
                    else now,
                    pack=new_pe, pack_slot=slot)
                new_pe.slot_metrics[slot] = entry.metrics
                self._entries[nm] = entry
            self.pack_rebuilds += 1
        Log.info(f"serving: rebuilt pack '{old_pe.name}' "
                 f"v{new_pe.version} ({len(members)} members)")
        return new_pe

    def _handle_evicted(self, stale: List[ModelEntry]) -> None:
        """Off-lock cleanup for replaced/LRU-victim entries. Solo
        entries drain their own batcher; a pack member's departure
        republishes its pack without it (whole-pack drop when it was
        the last member) and then drains the OLD pack batcher —
        queued futures, including the departed member's, resolve
        through each member's host path exactly once."""
        pack_groups: Dict[int, list] = {}
        for old in stale:
            if old.pack is None:
                self._drain_replaced(old)
            else:
                grp = pack_groups.setdefault(id(old.pack),
                                             [old.pack, set()])
                grp[1].add(old.name)
        for old_pe, names in pack_groups.values():
            # drop every departed name; members that were merely
            # REPLACED under a newer pack are excluded by the rebuild
            # itself (it only keeps entries still pointing at old_pe)
            self._rebuild_pack(old_pe, drop=names)
            self._drain_pack(old_pe)

    def packs(self) -> Dict[str, object]:
        """Live PackEntries keyed by pack name (no LRU touch)."""
        with self._lock:
            out: Dict[str, object] = {}
            for e in self._entries.values():
                if e.pack is not None:
                    out[e.pack.name] = e.pack
            return out

    # ------------------------------------------------------------------
    def refresh(self, name: str, booster=None,
                model_file: Optional[str] = None,
                model_str: Optional[str] = None) -> ModelEntry:
        """Atomic swap to a new model version under the same name."""
        with self._lock:
            if name not in self._entries:
                raise LightGBMError(f"model '{name}' is not loaded")
        return self.load(name, booster=booster, model_file=model_file,
                         model_str=model_str)

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise LightGBMError(f"model '{name}' is not loaded")
            entry.last_used = time.monotonic()
            return entry

    def evict(self, name: str) -> bool:
        """Drop `name`; returns False when it was not loaded. Queued
        requests drain through the host path, none dropped."""
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is not None:
            # pack members route through _handle_evicted so the pack
            # is republished without them (survivors keep the fused
            # path); solo entries just drain
            self._handle_evicted([entry])
            Log.info(f"serving: evicted model '{name}'")
        return entry is not None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------------
    def _evict_over_capacity_locked(self) -> List[ModelEntry]:
        # `_locked` suffix: caller holds the lock (docs/StaticAnalysis.md)
        evicted: List[ModelEntry] = []
        while len(self._entries) > self.max_models:
            lru = min(self._entries.values(), key=lambda e: e.last_used)
            del self._entries[lru.name]
            evicted.append(lru)
            Log.warning(f"serving: capacity {self.max_models} reached, "
                        f"evicted LRU model '{lru.name}'")
        return evicted
