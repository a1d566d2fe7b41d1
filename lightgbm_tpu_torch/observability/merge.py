"""Cross-rank trace merge: N per-rank Perfetto files -> one timeline.

Port of lightgbm_tpu/observability/merge.py (pure JSON work). Each
rank's Chrome/Perfetto trace (observability/trace.py `dump` with
the chrome format) carries a ``lightgbm_tpu_meta`` block: the rank, the
wall-clock instant of the trace epoch (``epoch_wall``), and the
clock-offset samples piggybacked on every guarded collective
(registry.record_clock_sample: each rank contributes its pre-collective
``wall`` stamp to the same allgather that moves the payload, so every
rank sees every rank's clock at every bracket — zero extra collectives;
the port's producer comes with the distributed learners).

`merge_traces` aligns the per-rank clocks against the lowest rank
present (median pairwise offset over all samples: robust to the
arrival skew any single collective carries), rebases every event onto
that common timeline with ``pid = rank``, and injects one instant
event per collective sample whose args carry the per-rank corrected
arrival times and the residual skew — so rank skew at each collective
is directly visible in ui.perfetto.dev.

CLI: ``python -m lightgbm_tpu_torch.observability merge <dir>``.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["load_rank_trace", "find_rank_traces", "merge_traces",
           "merge_summary", "merge_directory", "MERGED_DEFAULT"]

MERGED_DEFAULT = "merged_trace.json"
META_KEY = "lightgbm_tpu_meta"


def load_rank_trace(path: str) -> Optional[Dict]:
    """Parse `path` as a rank-tagged chrome trace; None when it is not
    one (wrong JSON shape / no meta block — merge directories hold
    other JSON artifacts like postmortem bundles)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return None
    meta = doc.get(META_KEY)
    if not isinstance(meta, dict) or "rank" not in meta:
        return None
    return doc


def find_rank_traces(trace_dir: str) -> List[str]:
    """Every rank-tagged trace file directly under `trace_dir`."""
    paths = []
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".json") or name == MERGED_DEFAULT:
            continue
        path = os.path.join(trace_dir, name)
        if load_rank_trace(path) is not None:
            paths.append(path)
    return paths


def _clock_offsets(docs: Sequence[Dict], base_rank: int
                   ) -> Dict[int, float]:
    """rank -> estimated clock offset relative to `base_rank` (seconds
    to SUBTRACT from that rank's wall clock to land on the base rank's
    timeline). Median over every collective sample from every file; a
    rank with no samples gets offset 0 (best effort)."""
    deltas: Dict[int, List[float]] = {}
    for doc in docs:
        for sample in doc[META_KEY].get("clock_samples", ()) or ():
            walls = sample.get("walls") or []
            if len(walls) <= base_rank:
                continue
            base = float(walls[base_rank])
            for r, w in enumerate(walls):
                deltas.setdefault(r, []).append(float(w) - base)
    return {r: statistics.median(ds) for r, ds in deltas.items() if ds}


def merge_traces(paths: Sequence[str]) -> Dict:
    """Merge rank-tagged trace files into one clock-aligned Perfetto
    document. Raises ValueError when no usable trace is given."""
    docs: List[Dict] = []
    for p in paths:
        doc = load_rank_trace(p)
        if doc is not None:
            docs.append(doc)
    if not docs:
        raise ValueError("no rank-tagged trace files to merge "
                         "(need chrome-format dumps with a "
                         f"'{META_KEY}' block)")
    docs.sort(key=lambda d: int(d[META_KEY]["rank"]))
    ranks = [int(d[META_KEY]["rank"]) for d in docs]
    base_rank = ranks[0]
    offsets = _clock_offsets(docs, base_rank)

    # common timeline origin: the earliest corrected epoch
    corrected_epochs = {}
    for doc in docs:
        m = doc[META_KEY]
        r = int(m["rank"])
        corrected_epochs[r] = float(m.get("epoch_wall", 0.0)) - \
            offsets.get(r, 0.0)
    t0 = min(corrected_epochs.values())

    events: List[Dict] = []
    for doc in docs:
        r = int(doc[META_KEY]["rank"])
        events.append({"name": "process_name", "ph": "M", "pid": r,
                       "tid": 0, "args": {"name": f"lightgbm_tpu rank {r}"}})
        shift_us = (corrected_epochs[r] - t0) * 1e6
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") == "M":
                continue            # per-rank metadata is re-emitted above
            out = dict(ev)
            out["pid"] = r
            out["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 3)
            events.append(out)

    # one instant event per collective sample: corrected arrivals + skew
    collectives: List[Dict] = []
    seen_keys = set()
    for doc in docs:
        for i, sample in enumerate(
                doc[META_KEY].get("clock_samples", ()) or ()):
            site = str(sample.get("site", "collective"))
            walls = [float(w) for w in (sample.get("walls") or ())]
            if not walls:
                continue
            arrivals = {r: w - offsets.get(r, 0.0)
                        for r, w in enumerate(walls)}
            key = (site, i, round(min(arrivals.values()), 4))
            if key in seen_keys:    # every rank carries the same sample
                continue
            seen_keys.add(key)
            skew_s = max(arrivals.values()) - min(arrivals.values())
            last_rank = max(arrivals, key=arrivals.get)
            rec = {"site": site,
                   "skew_ms": round(skew_s * 1e3, 3),
                   "last_rank": last_rank,
                   "arrivals_ms": {str(r): round((a - t0) * 1e3, 3)
                                   for r, a in arrivals.items()}}
            collectives.append(rec)
            events.append({
                "name": f"skew:{site}", "ph": "i", "s": "g",
                "pid": last_rank, "tid": 0,
                "ts": round((arrivals[last_rank] - t0) * 1e6, 3),
                "cat": "lightgbm_tpu_clock",
                "args": rec})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "lightgbm_tpu_merge": {
            "ranks": ranks,
            "base_rank": base_rank,
            "clock_offsets_s": {str(r): round(o, 6)
                                for r, o in offsets.items()},
            "collectives": collectives,
        },
    }


def merge_summary(merged: Dict) -> str:
    """Human tail for the CLI: per-site worst skew + offsets."""
    info = merged.get("lightgbm_tpu_merge", {})
    lines = [f"ranks merged: {info.get('ranks')}",
             f"clock offsets vs rank {info.get('base_rank', 0)} (s): "
             f"{info.get('clock_offsets_s')}"]
    worst: Dict[str, float] = {}
    for c in info.get("collectives", ()):
        worst[c["site"]] = max(worst.get(c["site"], 0.0), c["skew_ms"])
    for site, ms in sorted(worst.items()):
        lines.append(f"collective {site!r}: max rank skew {ms:.3f} ms")
    if not worst:
        lines.append("no collective clock samples found")
    return "\n".join(lines)


def merge_directory(trace_dir: str, out: Optional[str] = None
                    ) -> Tuple[str, Dict]:
    """Merge every rank trace under `trace_dir`; returns (path, doc)."""
    paths = find_rank_traces(trace_dir)
    merged = merge_traces(paths)
    out = out or os.path.join(trace_dir, MERGED_DEFAULT)
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(merged, fh)
        fh.write("\n")
    os.replace(tmp, out)
    return out, merged
