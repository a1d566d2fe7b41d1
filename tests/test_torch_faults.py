"""The port's fault registry, retry_call and BackoffPolicy against the JAX
package's, call for call, on the CPU.

The same operation sequences go into lightgbm_tpu.reliability.faults'
FaultRegistry and the port's: after every call the trips, calls,
remaining schedule and snapshot must agree, and so must which calls
raised. parse_schedule and the env seeding (never writing os.environ)
are held the same way, with the one rule the port changes (ROADMAP C19:
the first sight of an unset variable keeps a schedule armed in code).
rank_death runs with os._exit stubbed: the flight recorder's bundle is
written first. retry_call gets a stub sleep and must ask for the JAX
package's delays and count its device_retries; BackoffPolicy gives the
JAX package's delays without jitter and with decorrelated jitter at
three seeds.
"""

import importlib
import json
import os

import pytest

from lightgbm_tpu.boosting import gbdt as jax_gbdt
from lightgbm_tpu.reliability.counters import counters as jax_counters
from lightgbm_tpu_torch.boosting import gbdt as port_gbdt
from lightgbm_tpu_torch.observability.flightrec import recorder
from lightgbm_tpu_torch.reliability.counters import counters
from tests.test_torch_one_thread import one_thread  # noqa: F401

# the modules (each package's reliability/__init__ exports the `faults`
# singleton under the module's name)
faults = importlib.import_module("lightgbm_tpu_torch.reliability.faults")
retry = importlib.import_module("lightgbm_tpu_torch.reliability.retry")
backoff = importlib.import_module("lightgbm_tpu_torch.reliability.backoff")
jax_faults = importlib.import_module("lightgbm_tpu.reliability.faults")
jax_retry = importlib.import_module("lightgbm_tpu.reliability.retry")
jax_backoff = importlib.import_module("lightgbm_tpu.reliability.backoff")

_ENV = "LGBM_TPU_TEST_FAULT_ENV"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(_ENV, raising=False)
    monkeypatch.delenv(port_gbdt._FAULT_ENV, raising=False)
    for reg in (faults.faults, jax_faults.faults):
        reg.clear()
    counters.reset()
    jax_counters.reset()
    recorder.reset()
    recorder.configure(enabled=True, out_dir="")
    yield
    for reg in (faults.faults, jax_faults.faults):
        reg.clear()
    counters.reset()
    jax_counters.reset()
    recorder.reset()
    recorder.configure(enabled=True, out_dir="")


def _state(reg, sites):
    return {"trips": reg.trips(), "snapshot": reg.snapshot(),
            "per_site": {s: (reg.trips(s), reg.calls(s), reg.remaining(s))
                         for s in sites}}


def _apply(reg, mod, op, *args, **kw):
    """Run one registry call; 'raised' when it raised its InjectedFault."""
    try:
        getattr(reg, op)(*args, **kw)
    except mod.InjectedFault as exc:
        return ("raised", exc.site)
    return "ok"


def _run_both(ops, sites, monkeypatch=None):
    regs = (faults.FaultRegistry(), jax_faults.FaultRegistry())
    mods = (faults, jax_faults)
    environ = dict(os.environ)
    for step, op in enumerate(ops):
        if op[0] == "env":
            if op[1] is None:
                monkeypatch.delenv(_ENV, raising=False)
            else:
                monkeypatch.setenv(_ENV, op[1])
            environ = dict(os.environ)
            continue
        name, args, kw = op[0], op[1:], {}
        if args and isinstance(args[-1], dict):
            args, kw = args[:-1], args[-1]
        got = [_apply(r, m, name, *args, **kw) for r, m in zip(regs, mods)]
        assert got[0] == got[1], (step, op, got)
        assert _state(regs[0], sites) == _state(regs[1], sites), (step, op)
        # the registries read the environment and never write it
        assert dict(os.environ) == environ, (step, op)
    return regs


_SEQUENCES = {
    "skip_then_fail": [
        ("schedule", "s", {"skip": 2, "fail": 2}),
        *[("inject", "s")] * 6,
        ("inject", "other")],
    "rearm_and_clear": [
        ("schedule", "a", {"fail": 1}),
        ("schedule", "b", {"skip": 1, "fail": 3}),
        ("inject", "b"), ("inject", "a"), ("inject", "b"),
        ("schedule", "a", {"fail": 0, "skip": 0}),
        ("inject", "a"), ("clear", "b"), ("inject", "b"),
        ("schedule", "a", {"skip": 1}), ("inject", "a"), ("inject", "a"),
        ("inject", "a"), ("clear",), ("inject", "a")],
    "env_seeding": [
        ("env", "2:1"),
        *[("schedule_from_env", "s", _ENV), ("inject", "s")] * 4,
        ("env", "1"),
        *[("schedule_from_env", "s", _ENV), ("inject", "s")] * 2,
        ("env", None),
        ("schedule_from_env", "s", _ENV), ("inject", "s"),
        ("env", "1"),
        ("schedule_from_env", "s", _ENV), ("inject", "s"),
        ("env", "0:2"), ("schedule", "s", {"fail": 5}),
        *[("schedule_from_env", "s", _ENV), ("inject", "s")] * 3],
    "env_rank_death_suffix_arms": [
        ("env", "1:1:rank_death"),
        ("schedule_from_env", "s", _ENV), ("remaining", "s"),
        ("clear", "s"), ("schedule_from_env", "s", _ENV),
        ("remaining", "s")],
    "known_sites": [
        *[("schedule", s, {"skip": i % 2, "fail": 1})
          for i, s in enumerate(faults.KNOWN_SITES)],
        *[("inject", s) for s in faults.KNOWN_SITES] * 2],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_registry_matches_jax_call_for_call(name, monkeypatch):
    ops = _SEQUENCES[name]
    sites = sorted({op[1] for op in ops
                    if len(op) > 1 and isinstance(op[1], str)
                    and op[0] != "env"} | {"other"})
    _run_both(ops, sites, monkeypatch)


def test_known_sites_and_exit_code_match():
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    assert faults.RANK_DEATH_EXIT_CODE == jax_faults.RANK_DEATH_EXIT_CODE
    assert issubclass(faults.InjectedFault, RuntimeError)
    assert faults.InjectedFault("x").site == "x"
    assert str(faults.InjectedFault("x")) == str(jax_faults.InjectedFault("x"))


@pytest.mark.parametrize("val", ["3", "0:2", "2:1", "5:0", " 1", "07:3"])
def test_parse_schedule_matches_jax(val):
    assert faults.parse_schedule(val) == jax_faults.parse_schedule(val)


def test_bad_mode_rejected_like_jax():
    for reg in (faults.FaultRegistry(), jax_faults.FaultRegistry()):
        with pytest.raises(ValueError, match="unknown fault mode"):
            reg.schedule("s", fail=1, mode="explode")


def test_injected_context_manager():
    reg = faults.FaultRegistry()
    with reg.injected("s", fail=1, skip=1) as r:
        assert r is reg and reg.remaining("s") == (1, 1)
        reg.inject("s")
        with pytest.raises(faults.InjectedFault):
            reg.inject("s")
    assert reg.remaining("s") == (0, 0) and reg.trips("s") == 1


def test_unset_env_keeps_a_schedule_armed_in_code(monkeypatch):
    """ROADMAP C19: the JAX package clears a code-armed schedule on the
    first sight of an unset variable; the port keeps it. Every later
    step agrees again."""
    port, jax = faults.FaultRegistry(), jax_faults.FaultRegistry()
    for reg in (port, jax):
        reg.schedule("s", fail=1)
        reg.schedule_from_env("s", _ENV)
    assert port.remaining("s") == (0, 1)
    assert jax.remaining("s") == (0, 0)
    monkeypatch.setenv(_ENV, "1")
    for reg in (port, jax):
        reg.schedule_from_env("s", _ENV)
        assert reg.remaining("s") == (0, 1)
    monkeypatch.delenv(_ENV)
    for reg in (port, jax):
        reg.schedule_from_env("s", _ENV)
        assert reg.remaining("s") == (0, 0)


def test_fused_env_shim_matches_jax(monkeypatch):
    """LGBM_TPU_INJECT_FUSED_FAULT seeds the fused_dispatch site of each
    package's singleton the same way, and stays as it was set."""
    assert port_gbdt._FAULT_ENV == jax_gbdt._FAULT_ENV
    monkeypatch.setenv(port_gbdt._FAULT_ENV, "1:2")
    outcomes = []
    for shim, mod in ((port_gbdt._maybe_inject_fused_fault, faults),
                      (jax_gbdt._maybe_inject_fused_fault, jax_faults)):
        got = []
        for _ in range(5):
            try:
                shim()
                got.append("ok")
            except mod.InjectedFault:
                got.append("raised")
        outcomes.append((got, mod.faults.trips("fused_dispatch"),
                         mod.faults.calls("fused_dispatch"),
                         mod.faults.remaining("fused_dispatch")))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ["ok", "raised", "raised", "ok", "ok"]
    assert os.environ[port_gbdt._FAULT_ENV] == "1:2"


def test_rank_death_flushes_then_exits(tmp_path, monkeypatch):
    """rank_death: the hit is recorded, the bundle flushed (reason
    rank_death, the fault its last event), then os._exit(86)."""
    recorder.configure(out_dir=str(tmp_path))
    exits = []
    monkeypatch.setattr(faults.os, "_exit", exits.append)
    reg = faults.FaultRegistry()
    reg.schedule("histogram_build", fail=1, mode="rank_death")
    reg.inject("histogram_build")     # returns: the exit is stubbed
    assert exits == [faults.RANK_DEATH_EXIT_CODE] == [86]
    with open(tmp_path / "postmortem_0.json") as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "rank_death"
    last = bundle["events"][-1]
    assert (last["kind"], last["name"], last["mode"]) == \
        ("fault", "histogram_build", "rank_death")
    assert reg.trips("histogram_build") == 1


def test_rank_death_stub_sees_the_site(monkeypatch):
    seen = []
    monkeypatch.setattr(faults, "_rank_death_exit", seen.append)
    reg = faults.FaultRegistry()
    reg.schedule("s", skip=1, fail=1, mode="rank_death")
    reg.inject("s")
    assert seen == []
    reg.inject("s")
    assert seen == ["s"] and reg.remaining("s") == (0, 0)
    assert recorder.events()[-1]["mode"] == "rank_death"


def _retry_run(mod, ctr, fails, attempts, **kw):
    sleeps, calls, retried = [], [], []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise RuntimeError(f"boom {len(calls)}")
        return x * 2

    before = ctr.get("device_retries")
    try:
        out = mod.retry_call(fn, 21, attempts=attempts, sleep=sleeps.append,
                             on_retry=lambda: retried.append(len(calls)),
                             **kw)
    except RuntimeError as exc:
        out = ("raised", str(exc))
    return (out, len(calls), sleeps, retried,
            ctr.get("device_retries") - before)


@pytest.mark.parametrize("fails,attempts,kw", [
    (0, 3, {}), (1, 3, {}), (2, 3, {}), (3, 3, {}), (5, 1, {}),
    (6, 7, {"backoff_ms": 300.0, "backoff_max_ms": 1000.0}),
    (2, 4, {"backoff_ms": 0.0}),
    (2, 0, {}),
])
def test_retry_call_matches_jax(fails, attempts, kw):
    got = _retry_run(retry, counters, fails, attempts, **kw)
    want = _retry_run(jax_retry, jax_counters, fails, attempts, **kw)
    assert got == want
    assert got[4] == counters.get("device_retries")


def test_retry_on_limits_what_is_retried():
    calls = []

    def fn():
        calls.append(1)
        raise KeyError("not retried")

    with pytest.raises(KeyError):
        retry.retry_call(fn, attempts=3, retry_on=(RuntimeError,),
                         sleep=lambda s: None)
    assert len(calls) == 1 and counters.get("device_retries") == 0


@pytest.mark.parametrize("jitter,seed", [("none", None), ("decorrelated", 0),
                                         ("decorrelated", 7),
                                         ("decorrelated", 12345)])
def test_backoff_policy_matches_jax(jitter, seed):
    out = []
    for mod in (backoff, jax_backoff):
        slept = []
        pol = mod.BackoffPolicy(base_ms=40.0, max_ms=900.0,
                                sleep=slept.append, jitter=jitter, seed=seed)
        delays = [pol.wait(a) for a in range(8)]
        pol.reset()
        delays += [pol.delay_ms(a) for a in (0, 3, 20)]
        out.append((delays, slept))
    assert out[0] == out[1]
    assert all(40.0 <= d <= 900.0 for d in out[0][0])


def test_backoff_policy_edges_match_jax():
    for mod in (backoff, jax_backoff):
        assert mod.BackoffPolicy(base_ms=0.0).wait(3) == 0.0
        with pytest.raises(ValueError, match="unknown jitter mode"):
            mod.BackoffPolicy(jitter="full")
