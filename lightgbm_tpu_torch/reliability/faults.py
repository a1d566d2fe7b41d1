"""Unified fault-injection registry: one lever for every robustness test.

Port of lightgbm_tpu/reliability/faults.py. An in-process registry of
named sites with deterministic schedules; an environment variable is only
a source of a site's initial schedule (never mutated). A schedule is
"skip S calls, then fail the next N": the "S:N" grammar of
``LGBM_TPU_INJECT_FUSED_FAULT`` (boosting/gbdt.py), so ``=2:1`` lets two
fused dispatches through, then fails one.

The sites are the JAX package's (`KNOWN_SITES`); tests may add their own.
The port raises from these:

==========================  ==================================================
site                        raised from
==========================  ==================================================
``fused_dispatch``          GBDT.train_many_dispatch, at the start of each
                            attempt of the fused trainer's block
``histogram_build``         GBDT._grow, at the start of each attempt of a
                            tree's growth (either grower)
``checkpoint_io``           reliability.checkpoint.save_checkpoint, before
                            the bundle's first write
``serving_device_predict``  serving BucketedPredictor.predict_raw
``serving_replica_predict`` serving ReplicaSet.dispatch, each attempt on a
                            replica, inside the retry bracket
``serving_pack_predict``    serving multimodel.dispatch_pack
``serving_hot_swap``        serving Server.hot_swap, before the registry swap
``serving_hot_swap_commit`` serving Server.hot_swap, after the atomic publish
==========================  ==================================================

The others are wired with the modules that own them: ``collective_psum``,
``distributed_hist_agg`` and ``elastic_resize`` with the distributed
learners (ROADMAP A10); ``streaming_ingest`` and ``loop_publish`` with
streaming and the continuous loop (A11 part 2).

Injection is host-side, at dispatch boundaries, before any device work of
the attempt: a raise inside a captured CUDA graph would never run, so the
hooks sit where Python still owns control flow.

Schedules fire in one of two modes. ``mode="raise"`` (default) raises
`InjectedFault`, exercising the in-process recovery ladders.
``mode="rank_death"`` ends the whole process with ``os._exit`` at the
site's nth hit, after the flight recorder's bundle is flushed: no
exception handler runs and peers get no goodbye, the failure a collective
watchdog has to survive.

One rule differs from the JAX package: `schedule_from_env` leaves a
site's schedule alone on the first sight of an unset variable. The JAX
package clears it then, so a schedule armed with `schedule` at
``fused_dispatch`` was dropped by the first fused dispatch when
``LGBM_TPU_INJECT_FUSED_FAULT`` was unset (ROADMAP C19). Once a variable
has been seen set, unsetting it clears the site, as in the JAX package.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "InjectedFault", "FaultRegistry", "faults", "KNOWN_SITES",
    "RANK_DEATH_EXIT_CODE", "parse_schedule",
]

#: exit status of a process ended by a ``rank_death`` schedule, apart
#: from a watchdog abort and from ordinary python failures (1)
RANK_DEATH_EXIT_CODE = 86

KNOWN_SITES = (
    "fused_dispatch",
    "histogram_build",
    "collective_psum",
    "serving_device_predict",
    "serving_replica_predict",
    "serving_pack_predict",
    "serving_hot_swap",
    "serving_hot_swap_commit",
    "checkpoint_io",
    "streaming_ingest",
    "distributed_hist_agg",
    "loop_publish",
    "elastic_resize",
)


class InjectedFault(RuntimeError):
    """Raised by `FaultRegistry.inject` when a schedule fires.

    A RuntimeError, so every recovery path (the fused dispatch's retries
    and fall-back, the growth retry) treats an injected fault exactly like
    a real device error."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site '{site}' (test hook)")
        self.site = site


class _Schedule:
    __slots__ = ("skip", "fail", "mode")

    def __init__(self, skip: int, fail: int, mode: str = "raise"):
        self.skip = int(skip)
        self.fail = int(fail)
        self.mode = mode


def parse_schedule(val: str) -> Tuple[int, int]:
    """Parse the "N" / "S:N" grammar into (skip, fail)."""
    skip, _, fail = str(val).partition(":")
    if not fail:
        skip, fail = "0", skip
    return int(skip), int(fail)


def _rank_death_exit(site: str) -> None:
    """End this process abruptly. ``os._exit`` (not ``sys.exit``) is the
    point: no exception propagates, no atexit hook runs, no distributed
    shutdown handshake is sent. The flight recorder's bundle is flushed
    first, so the death leaves a timeline, not just exit code 86. Tests
    stub this function to observe the firing without dying."""
    print(f"lightgbm_tpu_torch: injected rank_death at site '{site}' "
          f"(os._exit({RANK_DEATH_EXIT_CODE}))", file=sys.stderr,
          flush=True)
    from ..observability.flightrec import recorder
    recorder.flush("rank_death")
    os._exit(RANK_DEATH_EXIT_CODE)


class FaultRegistry:
    """Thread-safe registry of named injection sites.

    ``schedule(site, skip=S, fail=N)`` arms a site; every ``inject`` call
    then consumes one step: the first S calls pass, the next N raise
    `InjectedFault`, later calls pass. ``trips(site)`` counts the faults
    that fired, ``calls(site)`` the inject calls."""

    def __init__(self):
        self._lock = threading.RLock()
        self._schedules: Dict[str, _Schedule] = {}
        self._trips: Dict[str, int] = {}
        self._calls: Dict[str, int] = {}
        # the last env value seeded per (env name, site), so an unchanged
        # env var does not re-arm a consumed schedule
        self._env_seen: Dict[Tuple[str, str], str] = {}

    # -- arming ---------------------------------------------------------
    def schedule(self, site: str, fail: int = 1, skip: int = 0,
                 mode: str = "raise") -> None:
        if mode not in ("raise", "rank_death"):
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(expected 'raise' or 'rank_death')")
        with self._lock:
            if fail <= 0 and skip <= 0:
                self._schedules.pop(site, None)
            else:
                self._schedules[site] = _Schedule(skip, fail, mode)

    def schedule_from_env(self, site: str, env: str) -> None:
        """Seed `site`'s schedule from environment variable `env`.

        The env var is read-only: the countdown lives in the registry, and
        the site is re-seeded only when the raw value changes (a consumed
        schedule stays consumed). A ``:rank_death`` suffix
        ("S:N:rank_death") selects the process-ending mode."""
        val = os.environ.get(env, "")
        with self._lock:
            key = (env, site)
            # never seen reads as unset: the first sight of an unset
            # variable keeps a schedule armed in code (module docstring)
            if self._env_seen.get(key, "") == val:
                return
            self._env_seen[key] = val
            if not val:
                self._schedules.pop(site, None)
                return
            mode = "raise"
            sched_val = val
            if val.endswith(":rank_death"):
                mode = "rank_death"
                sched_val = val[:-len(":rank_death")]
            skip, fail = parse_schedule(sched_val)
            self._schedules[site] = _Schedule(skip, fail, mode)

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._schedules.clear()
                self._trips.clear()
                self._calls.clear()
                self._env_seen.clear()
            else:
                self._schedules.pop(site, None)
                self._trips.pop(site, None)
                self._calls.pop(site, None)
                for key in [k for k in self._env_seen if k[1] == site]:
                    del self._env_seen[key]

    # -- firing ---------------------------------------------------------
    def inject(self, site: str) -> None:
        """Consume one schedule step at `site`. When it fires, record the
        hit in the flight recorder, then raise `InjectedFault` (mode
        "raise") or end the process (mode "rank_death"), outside the
        lock."""
        mode = None
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            sched = self._schedules.get(site)
            if sched is None:
                return
            if sched.skip > 0:
                sched.skip -= 1
                return
            if sched.fail > 0:
                sched.fail -= 1
                if sched.fail == 0 and sched.skip == 0:
                    del self._schedules[site]
                self._trips[site] = self._trips.get(site, 0) + 1
                mode = sched.mode
            else:
                del self._schedules[site]
                return
        from ..observability.flightrec import recorder
        recorder.record_fault(site, mode or "raise")
        if mode == "rank_death":
            _rank_death_exit(site)
            return      # only reachable when _rank_death_exit is stubbed
        raise InjectedFault(site)

    # -- observation ----------------------------------------------------
    def remaining(self, site: str) -> Tuple[int, int]:
        """(skip, fail) still pending at `site`; (0, 0) when disarmed."""
        with self._lock:
            sched = self._schedules.get(site)
            return (sched.skip, sched.fail) if sched else (0, 0)

    def trips(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._trips.get(site, 0)
            return sum(self._trips.values())

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._trips)

    # -- test convenience -----------------------------------------------
    def injected(self, site: str, fail: int = 1, skip: int = 0):
        """Context manager arming `site` on entry, disarming on exit."""
        registry = self

        class _Ctx:
            def __enter__(self):
                registry.schedule(site, fail=fail, skip=skip)
                return registry

            def __exit__(self, *exc):
                registry.schedule(site, fail=0, skip=0)
                return False

        return _Ctx()


#: process-wide singleton; everything in the package injects through it
faults = FaultRegistry()
