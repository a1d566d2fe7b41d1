"""The port's observability units (lightgbm_tpu_torch/observability/,
utils/timer.py) against the JAX package's, call for call, on the CPU.

The same call sequences go to both packages' classes and the results are
compared with the clock readings (times, thread ids, pids) left out:
span nesting across threads, ring eviction, the null span and the Chrome
and JSONL dumps; the MAC model over a grid; Prometheus text for the same
mapping; compile accounting and training telemetry snapshots; every
record_* hook of the registry and its snapshot's keys; the cross-rank
merge and its CLI's exit codes; the span profiler's budget, single live
capture and failure rule with the capture stubbed, and one real
torch.profiler capture on the CPU. The port's MetricsHTTPServer is
scraped over 127.0.0.1.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from lightgbm_tpu import observability as jax_observability
from lightgbm_tpu.observability import compiles as jax_compiles
from lightgbm_tpu.observability import export as jax_export
from lightgbm_tpu.observability import merge as jax_merge
from lightgbm_tpu.observability import mfu as jax_mfu
from lightgbm_tpu.observability import profile as jax_profile
from lightgbm_tpu.observability import telemetry as jax_telemetry
from lightgbm_tpu.observability import trace as jax_trace
from lightgbm_tpu.observability.__main__ import main as jax_main
from lightgbm_tpu.observability.registry import \
    ObservabilityRegistry as JaxRegistry
from lightgbm_tpu.utils import timer as jax_timer

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import observability
from lightgbm_tpu_torch.observability import compiles, export, merge, mfu
from lightgbm_tpu_torch.observability import profile, telemetry, trace
from lightgbm_tpu_torch.observability.__main__ import main as port_main
from lightgbm_tpu_torch.observability.registry import ObservabilityRegistry
from lightgbm_tpu_torch.utils import timer
from tests.test_torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules of one package, by role
JAX = SimpleNamespace(trace=jax_trace, mfu=jax_mfu, export=jax_export,
                      compiles=jax_compiles, telemetry=jax_telemetry,
                      merge=jax_merge, profile=jax_profile,
                      main=jax_main, timer=jax_timer)
PORT = SimpleNamespace(trace=trace, mfu=mfu, export=export,
                       compiles=compiles, telemetry=telemetry, merge=merge,
                       profile=profile, main=port_main, timer=timer)


def _untimed(spans):
    """Span records without their clock readings."""
    return [{k: v for k, v in s.items() if k not in ("ts", "dur", "tid")}
            for s in spans]


# ---------------------------------------------------------------- spans
def _nesting(tr):
    with tr.span("outer", x=1):
        with tr.span("mid"):
            with tr.span("inner", it=3):
                pass
        tr.add("manual", 0.0, 0.5, k="v")


def _threads(tr):
    def work(tag):
        for i in range(20):
            with tr.span(f"{tag}_outer", i=i):
                with tr.span(f"{tag}_inner"):
                    pass
    threads = [threading.Thread(target=work, args=(f"t{k}",))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _eviction(tr):
    for i in range(30):
        tr.add(f"s{i}", 0.0, 0.001, i=i)


SPAN_CASES = {"nesting": (_nesting, 4096), "threads": (_threads, 4096),
              "eviction": (_eviction, 16)}


def _spans_of(mod, case):
    fn, cap = SPAN_CASES[case]
    tr = mod.trace.Trace(capacity=cap)
    tr.enabled = True
    fn(tr)
    return tr


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_spans_equal_jax(case):
    want, got = _spans_of(JAX, case), _spans_of(PORT, case)
    if case == "threads":
        # threads interleave: per-thread order and parents, as a multiset
        key = lambda s: json.dumps(s, sort_keys=True)  # noqa: E731
        assert sorted(map(key, _untimed(got.spans()))) == \
            sorted(map(key, _untimed(want.spans())))
        for s in got.spans():
            if s["name"].endswith("_inner"):
                assert s["parent"] == s["name"].replace("_inner", "_outer")
                assert s["depth"] == 1
    else:
        assert _untimed(got.spans()) == _untimed(want.spans())
    assert (len(got), got.dropped) == (len(want), want.dropped)


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_disabled_trace_returns_the_shared_null_span(mod):
    m = JAX if mod == "jax" else PORT
    tr = m.trace.Trace()
    assert tr.span("a") is m.trace._NULL_SPAN
    assert tr.span("b", k=1) is tr.span("c")
    with tr.span("a"):
        pass
    tr.add("manual", 0.0, 1.0)
    assert len(tr) == 0 and tr.innermost_open() == ("", 0.0)


def test_innermost_open_names_the_newest_open_span():
    tr = trace.Trace()
    tr.enabled = True
    with tr.span("outer"):
        with tr.span("inner"):
            name, age = tr.innermost_open()
    assert name == "inner" and age >= 0.0
    assert tr.innermost_open() == ("", 0.0)


@pytest.mark.parametrize("fmt,rank", [("chrome", None), ("chrome", 2),
                                      ("jsonl", None)])
def test_dumps_equal_jax(tmp_path, fmt, rank):
    docs = []
    for m in (JAX, PORT):
        tr = _spans_of(m, "nesting")
        path = str(tmp_path / f"{m is PORT}.{fmt}")
        samples = [{"site": "g", "walls": [1.0, 1.5]}]
        assert tr.dump(path, fmt, rank=rank, clock_samples=samples) == fmt
        with open(path) as fh:
            if fmt == "jsonl":
                docs.append(_untimed([json.loads(ln) for ln in fh]))
                continue
            doc = json.load(fh)
        for ev in doc["traceEvents"]:
            ev.pop("pid")
            ev.pop("tid")
            ev.pop("ts", None)
            ev.pop("dur", None)
        meta = doc.get("lightgbm_tpu_meta")
        if meta is not None:
            assert meta.pop("epoch_wall") > 0
        docs.append(doc)
    assert docs[1] == docs[0]
    if fmt == "chrome":
        names = [ev["name"] for ev in docs[1]["traceEvents"]]
        assert names[-4:] == ["inner", "mid", "manual", "outer"]


# ------------------------------------------------------------------ mfu
MAC_GRID = [dict(num_leaves=nl, num_rows=n, num_features=f, bmax=b,
                 double_prec=dp, quantized=q, const_hess=ch,
                 hist_subtraction=sub, overshoot=ov)
            for nl, n, f, b in ((7, 1000, 10, 63), (255, 1_000_000, 28, 256),
                                (31, 4097, 3, 15))
            for dp, q, ch in ((True, False, False), (False, False, False),
                              (True, True, False), (True, True, True),
                              (True, False, True))
            for sub, ov in ((True, 2.0), (False, 0.0), (True, 1.5))]


@pytest.mark.parametrize("i", range(0, len(MAC_GRID), 5))
def test_mac_model_equals_jax(i):
    for kw in MAC_GRID[i:i + 5]:
        chan = {k: kw[k] for k in ("double_prec", "quantized", "const_hess")}
        assert mfu.hist_channels(**chan) == jax_mfu.hist_channels(**chan)
        assert mfu.tree_macs(**kw) == jax_mfu.tree_macs(**kw)
        hk = dict(num_slots=kw["num_leaves"], num_rows=kw["num_rows"],
                  num_features=kw["num_features"], bmax=kw["bmax"],
                  nchan=jax_mfu.hist_channels(**chan))
        assert mfu.histogram_macs(**hk) == jax_mfu.histogram_macs(**hk)


def test_mfu_arithmetic_and_peak(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_PEAK_TFLOPS", raising=False)
    # no card here: the peak is unknown, so MFU reads as unavailable
    assert mfu.device_peak_tflops() == 0.0
    assert mfu.device_peak_tflops("cpu") == 0.0
    assert mfu.mfu_fraction(45.0) is None
    assert mfu.achieved_tflops(0.5e12) == jax_mfu.achieved_tflops(0.5e12)
    assert mfu.mfu_fraction(45.0, 90.0) == 0.5
    monkeypatch.setenv("LGBM_TPU_PEAK_TFLOPS", "100")
    assert mfu.device_peak_tflops() == 100.0
    for m in (mfu, jax_mfu):
        du = m.DeviceUtilization()
        du.add(25e12, 1.0, trees=2)
        snap = du.snapshot()
        assert snap["achieved_tflops"] == pytest.approx(50.0)
        assert snap["mfu"] == pytest.approx(0.5)
    # the H100 entries (NVIDIA's datasheet, dense bf16)
    monkeypatch.delenv("LGBM_TPU_PEAK_TFLOPS")
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4),
                       ("NVIDIA H100 PCIe", 756.5), ("NVIDIA A100", 0.0)):
        monkeypatch.setattr("torch.cuda.get_device_name",
                            lambda device=None, n=name: n)
        assert mfu.device_peak_tflops() == peak


# ----------------------------------------------------------- prometheus
PROM_MAPPINGS = [
    ({"a": 1, "nested": {"b": 2.5, "skip": "str", "none": None},
      "flag": True, "nan": float("nan")}, "pre", None),
    ({"p50 ms": 1.5, "9lives": 2}, "m", {"model": 'a"b', "v": "x\\y"}),
    ({"deep": {"er": {"still": 3}}, "zero": 0.0}, "lightgbm_tpu_x", None),
]


@pytest.mark.parametrize("i", range(len(PROM_MAPPINGS)))
def test_prometheus_text_equals_jax(i):
    mapping, prefix, labels = PROM_MAPPINGS[i]
    assert export.prometheus_lines(mapping, prefix, labels) == \
        jax_export.prometheus_lines(mapping, prefix, labels)
    assert export.render_prometheus(PROM_MAPPINGS) == \
        jax_export.render_prometheus(PROM_MAPPINGS)


def test_metrics_http_server_is_scraped_on_localhost():
    reg = ObservabilityRegistry()
    reg.enable()
    reg.compiles.record("fused_train", 2.0, compiled=True)
    reg.compiles.record("fused_train", 0.0, compiled=False)
    with export.MetricsHTTPServer(reg.prometheus_text, reg.snapshot,
                                  port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        assert text == reg.prometheus_text()
        assert "lightgbm_tpu_observability_enabled 1" in text
        assert "lightgbm_tpu_compiles_entries_fused_train_hits 1" in text
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
            assert resp.read() == b"ok\n"
        with urllib.request.urlopen(base + "/snapshot", timeout=5) as resp:
            assert json.loads(resp.read())["compiles"]["hit_count"] == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert err.value.code == 404
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/healthz", timeout=2)


# ------------------------------------------- compiles, telemetry, timer
def _compile_calls(acc):
    acc.record("fused_train", 1.25)
    acc.record("fused_train", 0.0, compiled=False)
    acc.record("fused_train", 0.0, compiled=False)
    acc.record("nvcc_route_rows", 3.5)
    with acc.track("entry", compiled=False):
        pass
    return acc.snapshot(), acc.totals()


def _telemetry_calls(tel):
    tel.record_iteration(0, 0.5, phases={"boosting": 0.1, "tree_train": 0.3,
                                         "bagging": 0.0},
                         leaves=7, grad_norm=2.5, hess_norm=1.25,
                         counters={"guard_trips": 0, "fallbacks": 0})
    tel.record_iteration(1, 1.5, trees=9, iterations=9, fused=True,
                         bagging_fraction=0.8, macs=123,
                         counters={"guard_trips": 1, "fallbacks": 0})
    tel.record_iteration(10, 0.25, bagging_fraction=1.0,
                         counters={"guard_trips": 1, "fallbacks": 2})
    tel.set_capacity(17)
    return tel.records(), tel.last(), tel.snapshot()


def test_compile_accounting_equals_jax():
    assert _compile_calls(compiles.CompileAccounting()) == \
        _compile_calls(jax_compiles.CompileAccounting())


def test_training_telemetry_equals_jax():
    assert _telemetry_calls(telemetry.TrainingTelemetry()) == \
        _telemetry_calls(jax_telemetry.TrainingTelemetry())
    assert telemetry.PHASE_KEYS == jax_telemetry.PHASE_KEYS


def test_timer_equals_jax():
    outs = []
    for m in (timer, jax_timer):
        t = m.Timer()
        t.add("b", 2.0)
        t.add("a", 1.0)
        t.add("b", 0.5)
        with t.timeit("c"):
            pass
        totals = t.totals()
        assert totals.pop("c") >= 0.0
        outs.append((totals, t.report().splitlines()[:3]))
        t.reset()
        assert t.totals() == {}
    assert outs[0] == outs[1]
    assert lgt.utils.global_timer is timer.global_timer


# ------------------------------------------------------------- registry
def _gbdt(k=1, bagging=1.0):
    return SimpleNamespace(num_tree_per_iteration=k,
                           config=SimpleNamespace(bagging_fraction=bagging))


def _registry_calls(reg):
    """Every record_* hook once or twice, observe on."""
    reg.enable(ring=64)
    reg.record_hist_autotune("pallas", {"mxu": 1.5, "pallas": 0.75}, True)
    reg.record_collective_world(4)
    reg.record_collective_guard(0.25)
    reg.record_collective_guard(0.5)
    reg.record_collective_timeout()
    reg.record_collective_abort()
    reg.record_heartbeat_age(1.5)
    reg.record_heartbeat_age(0.5)
    reg.record_membership(1, 4)
    reg.record_membership_resize("shrink", 2, 3)
    reg.record_membership_resize("join", 3, 4, joined=1)
    reg.record_membership_reshard(0.125)
    reg.record_clock_sample("collective_psum", [10.0, 10.25, 9.5])
    reg.record_clock_sample("g", [3.0])
    reg.record_clock_sample("none", [])
    reg.record_freshness_publish(3, 1.5, slo_s=1.0)
    reg.record_freshness_publish(4, 0.5, slo_s=1.0)
    reg.record_freshness_recover(9)
    reg.record_freshness_torn_publish(5)
    reg.record_freshness_quarantine(6)
    reg.record_train_iteration(_gbdt(), 0, 100.0, 0.5,
                               phases={"boosting": 0.1})
    reg.record_fused_block(_gbdt(3, 0.8), 1, 9, 101.0, 2.0, True)
    reg.record_fused_block(_gbdt(3, 0.8), 10, 5, 103.0, 1.0, False)
    reg.record_pipeline_block(0, 10, 100.0, 2.5, 0.01, 0.004)
    reg.record_pipeline_block(10, 5, 102.5, 1.0, 0.02, 0.02)
    reg.record_level_pipeline(3, 104.0, 0.5, 6, 4, 1, True)
    reg.record_level_pipeline(4, 105.0, 0.25, 5, 2, 0, False)
    reg.record_streaming_chunk("sketch", 0, 106.0, 0.5, 100, 4000)
    reg.record_streaming_chunk("bin", 0, 107.0, 0.25, 100, 4000)
    reg.record_streaming_sketch(100, True)
    reg.record_distributed_setup(4, 7, 0.5)
    reg.record_distributed_sketch(250)
    reg.record_distributed_sketch(125)


#: the snapshot sections whose values are the registry's own (the shared
#: timer, counters, recorder and profiler are each package's singletons)
OWN_SECTIONS = ("enabled", "clock_skew", "collective", "distributed",
                "freshness", "membership", "hist_backend", "pipeline",
                "level_pipeline", "streaming", "training", "compiles",
                "device_utilization", "trace")


def _sections(reg):
    snap = reg.snapshot()
    return {k: snap[k] for k in OWN_SECTIONS}


@pytest.fixture
def zero_counters():
    """Both packages' reliability counters at zero: a record's counter
    deltas start from the process singleton's state."""
    from lightgbm_tpu.reliability.counters import counters as jax_counters
    from lightgbm_tpu_torch.reliability.counters import counters
    for c in (counters, jax_counters):
        c.reset()
    yield
    for c in (counters, jax_counters):
        c.reset()


def test_registry_records_equal_jax(zero_counters):
    port = ObservabilityRegistry()
    jax_reg = JaxRegistry()
    for reg in (port, jax_reg):
        _registry_calls(reg)
    assert set(port.snapshot()) == set(jax_reg.snapshot())
    for key, value in jax_reg.snapshot().items():
        # the timers and counters are each package's process singletons:
        # other tests in the process add keys to them
        if isinstance(value, dict) and key not in ("timers", "counters"):
            assert set(port.snapshot()[key]) == set(value), key
    # the counters' stable schema (the packages export the singletons
    # under the modules' names)
    schema = [importlib.import_module(m)._KEYS for m in (
        "lightgbm_tpu.reliability.counters",
        "lightgbm_tpu_torch.reliability.counters")]
    assert schema[0] == schema[1]
    assert _sections(port) == _sections(jax_reg)
    assert _untimed(port.trace.spans()) == _untimed(jax_reg.trace.spans())
    assert port.training.records() == jax_reg.training.records()
    assert port.clock_samples() == jax_reg.clock_samples()
    assert port.phase_deltas({}) == {} or set(port.phase_deltas({})) <= \
        set(telemetry.PHASE_KEYS)
    # the scrape's metric families: the JAX package's names
    fam = lambda text: sorted(  # noqa: E731
        ln.split()[2] for ln in text.splitlines() if ln.startswith("#")
        and "_timer_seconds_" not in ln and "_reliability_" not in ln)
    assert fam(port.prometheus_text()) == fam(jax_reg.prometheus_text())
    # reset clears what the registry owns
    port.reset()
    jax_reg.reset()
    assert _sections(port) == _sections(jax_reg)
    assert port.snapshot()["training"]["iterations"] == 0


def test_registry_off_records_nothing_but_the_forensic_hooks(
        zero_counters):
    port = ObservabilityRegistry()
    jax_reg = JaxRegistry()
    for reg in (port, jax_reg):
        _registry_calls(reg)
        reg.reset()
        reg.disable()
        # observe off: the training, pipeline, streaming and distributed
        # hooks return at once; hist_backend, collective, membership,
        # clock and freshness hooks record whatever the flag
        _registry_calls(reg)
        reg.disable()
    for reg in (port, jax_reg):
        reg.reset()
        reg.record_collective_guard(0.25)
        reg.record_train_iteration(_gbdt(), 0, 1.0, 0.5)
        reg.record_fused_block(_gbdt(), 1, 3, 1.0, 0.5, True)
        reg.record_pipeline_block(0, 3, 1.0, 0.5, 0.1, 0.2)
        with reg.trace.span("x"):
            pass
    assert _sections(port) == _sections(jax_reg)
    snap = port.snapshot()
    assert snap["training"]["iterations"] == 0 and \
        snap["compiles"]["entries"] == {} and \
        snap["trace"]["spans_buffered"] == 0 and \
        snap["collective"]["guarded"] == 1


def test_registry_shares_the_timer_and_counters():
    from lightgbm_tpu_torch.reliability import counters
    from lightgbm_tpu_torch.utils.timer import global_timer
    assert observability.registry.timer is global_timer
    assert observability.registry.counters is counters
    assert observability.registry.tree_macs_for(_gbdt()) == 0
    # the module-level conveniences are the singleton's
    assert observability.snapshot == observability.registry.snapshot
    assert observability.span == observability.registry.trace.span


def test_exports_cover_the_jax_package():
    assert set(jax_observability.__all__) <= set(observability.__all__)
    assert "observability" in lgt.__all__ and \
        lgt.observability is observability


def test_observability_imports_no_jax():
    code = ("import sys\n"
            "import lightgbm_tpu_torch.observability as o\n"
            "from lightgbm_tpu_torch.observability import __main__\n"
            "from lightgbm_tpu_torch.utils import timer\n"
            "o.prometheus_text(); o.snapshot()\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'lightgbm_tpu.'))\n"
            "            or m == 'lightgbm_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, check=True,
                         stdin=subprocess.DEVNULL)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------- merge
def _rank_trace(rank, epoch_wall, events, clock_samples):
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "lightgbm_tpu_meta": {"rank": rank, "epoch_wall": epoch_wall,
                                  "clock_samples": clock_samples}}


def _write_ranks(d, skew=5.0):
    samples = [{"site": "collective_psum", "walls": [1010.0, 1010.2 + skew]},
               {"site": "collective_psum", "walls": [1020.0, 1020.0 + skew]},
               {"site": "g", "walls": [1030.1, 1030.0 + skew]}]
    for rank, epoch in ((0, 1000.0), (1, 1000.0 + skew)):
        ev = [{"name": "process_name", "ph": "M", "pid": 7, "tid": 0,
               "args": {"name": "x"}},
              {"name": "train", "ph": "X", "ts": 10.0 * rank, "dur": 2e6,
               "pid": 7, "tid": 1, "cat": "lightgbm_tpu"}]
        with open(os.path.join(d, f"trace_r{rank}.json"), "w") as fh:
            json.dump(_rank_trace(rank, epoch, ev, samples), fh)
    with open(os.path.join(d, "postmortem_0.json"), "w") as fh:
        fh.write('{"reason": "x"}')
    with open(os.path.join(d, "broken.json"), "w") as fh:
        fh.write("{")


@pytest.mark.parametrize("skew", [0.0, 5.0])
def test_merge_equals_jax(tmp_path, skew):
    _write_ranks(str(tmp_path), skew)
    paths = merge.find_rank_traces(str(tmp_path))
    assert paths == jax_merge.find_rank_traces(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["trace_r0.json",
                                                   "trace_r1.json"]
    got, want = merge.merge_traces(paths), jax_merge.merge_traces(paths)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["lightgbm_tpu_merge"]["clock_offsets_s"]["1"] == \
        pytest.approx(skew, abs=1e-6)
    assert merge.merge_summary(got) == jax_merge.merge_summary(want)
    out, doc = merge.merge_directory(str(tmp_path),
                                     out=str(tmp_path / "m.json"))
    with open(out) as fh:
        assert json.load(fh) == doc
    with pytest.raises(ValueError):
        merge.merge_traces([str(tmp_path / "postmortem_0.json")])


def _argvs(d):
    empty = os.path.join(d, "empty")
    os.makedirs(empty, exist_ok=True)
    return [[], ["-h"], ["bogus"], ["merge"], ["merge", d, "x"],
            ["merge", d, "-o"], ["merge", empty], ["merge", d],
            ["merge", d, "-o", os.path.join(d, "out.json")]]


def test_merge_cli_exit_codes_equal_jax(tmp_path, capsys):
    d = str(tmp_path)
    _write_ranks(d)
    for argv in _argvs(d):
        want = jax_main(list(argv))
        capsys.readouterr()
        got = port_main(list(argv))
        out = capsys.readouterr()
        assert got == want, argv
        if argv[:1] == ["merge"] and got == 0:
            assert out.out.startswith("wrote ")
    assert os.path.exists(os.path.join(d, merge.MERGED_DEFAULT))
    assert os.path.exists(os.path.join(d, "out.json"))
    run = subprocess.run([sys.executable, "-m",
                          "lightgbm_tpu_torch.observability", "merge", d],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True,
                         stdin=subprocess.DEVNULL)
    assert run.returncode == 0 and "ranks merged: [0, 1]" in run.stdout


def test_registry_dump_is_a_rank_tagged_trace(tmp_path):
    reg = ObservabilityRegistry()
    reg.enable()
    with reg.trace.span("unit_work"):
        pass
    reg.record_clock_sample("g", [1.0, 1.25])
    path = str(tmp_path / "trace_r0.json")
    assert reg.dump_trace(path) == "chrome"
    doc = merge.load_rank_trace(path)
    assert doc is not None and jax_merge.load_rank_trace(path) == doc
    meta = doc["lightgbm_tpu_meta"]
    assert meta["rank"] == 0 and meta["epoch_wall"] > 0
    assert meta["clock_samples"] == [{"site": "g", "walls": [1.0, 1.25]}]
    assert any(ev["name"] == "unit_work"
               for ev in merge.merge_traces([path])["traceEvents"])


# ------------------------------------------------------------- profiler
def _profiler_calls(mod, monkeypatch, d):
    """The same capture sequence on a fresh SpanProfiler of `mod` with
    the capture stubbed: returns what it saw."""
    seen = []
    monkeypatch.setattr(mod, "_start_trace",
                        lambda log_dir: seen.append(("start", log_dir)))
    monkeypatch.setattr(mod, "_stop_trace", lambda: seen.append("stop"))
    p = mod.SpanProfiler()
    p.configure(spans="grow_*, pipeline_block", out_dir=d, max_captures=3)
    with p.capture("unrelated") as live:
        seen.append(live)
    with p.capture("pipeline_block") as live:
        seen.append(live)
        # one live capture: a nested match does not start another
        with p.capture("grow_tree") as inner:
            seen.append(inner)
    for _ in range(3):
        with p.capture("grow_tree") as live:
            seen.append(live)
    seen.append(p.snapshot())

    def boom(log_dir):
        raise RuntimeError("no profiler backend")
    monkeypatch.setattr(mod, "_start_trace", boom)
    p.reset()
    p.configure(spans="pipeline_block", out_dir=d, max_captures=4)
    with p.capture("pipeline_block") as live:
        seen.append(live)
    seen.append(p.snapshot())
    # once failed, a new configure keeps it disarmed for the process
    p.configure(spans="pipeline_block", out_dir=d)
    seen.append(p.snapshot())
    monkeypatch.setattr(mod, "_start_trace", lambda log_dir: None)

    def stop_boom():
        raise RuntimeError("stop failed")
    monkeypatch.setattr(mod, "_stop_trace", stop_boom)
    p.reset()
    p.configure(spans="x", out_dir=d, max_captures=2)
    with p.capture("x") as live:
        seen.append(live)
    seen.append(p.snapshot())
    return seen


def test_span_profiler_equals_jax(tmp_path, monkeypatch):
    d = str(tmp_path)
    want = _profiler_calls(jax_profile, monkeypatch, d)
    got = _profiler_calls(profile, monkeypatch, d)
    assert got == want
    assert got[:5] == [False, ("start", os.path.join(d, "pipeline_block_001")),
                       True, False, "stop"]
    snaps = [s for s in got if isinstance(s, dict)]
    assert snaps[0] == {"armed": 0, "captures": 3, "max_captures": 3,
                        "failed": 0}
    assert all(s["failed"] == 1 and s["armed"] == 0 for s in snaps[1:])


def test_span_profiler_default_directory(monkeypatch, tmp_path):
    dirs = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(profile, "_start_trace", dirs.append)
    monkeypatch.setattr(profile, "_stop_trace", lambda: None)
    p = profile.SpanProfiler()
    p.configure(spans="a*", max_captures=1)
    with p.capture("a b") as live:
        assert live
    assert dirs == [os.path.join("torch_profile", "a_b_001")]


def test_span_profiler_real_capture_on_the_cpu(tmp_path):
    """One torch.profiler capture (CPU activities: no card here) through a
    profiled span: the directory holds a Chrome trace of the region."""
    import torch
    p = profile.profiler
    reg = ObservabilityRegistry()
    reg.enable()
    p.reset()
    try:
        p.configure(spans="work", out_dir=str(tmp_path), max_captures=1)
        with reg.trace.span("work") as sp:
            torch.ones(64).add_(1.0).sum()
        assert sp.name == "work"
        snap = p.snapshot()
    finally:
        p.reset()
    assert snap == {"armed": 0, "captures": 1, "max_captures": 1,
                    "failed": 0}
    path = tmp_path / "work_001" / profile.TRACE_FILE
    with open(path) as fh:
        doc = json.load(fh)
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert "aten::add_" in names
    assert [s["name"] for s in reg.trace.spans()] == ["work"]
    assert profile._live is None
