"""Launch counting and kernel binding across threads (serving's batcher
workers launch kernels beside the main thread).

- histogram_mxu.count_launch from many threads loses no count, and a
  thread recording a CUDA graph's launches (recording_launches) tallies
  only its own: the other threads' launches still count as launched;
- _cuda._entry builds and binds the kernels once when several threads
  ask at the same time (nvcc and the libraries stubbed: the CPU has
  neither), and every thread gets the bound entry;
- the plain-version wrappers run from several threads at once give each
  thread the single-threaded answer and count no launch.
"""

import sys
import threading

import numpy as np
import torch

from lightgbm_tpu_torch.learner import _cuda
from lightgbm_tpu_torch.learner import histogram_mxu as hm
from lightgbm_tpu_torch.learner.predict import predict_binned_forest
from lightgbm_tpu_torch.serving.forest import build_device_forest
from tests.test_torch_one_thread import one_thread  # noqa: F401

THREADS = 8


def _run(target, n=THREADS):
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait()
            target(i)
        except Exception as exc:     # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


def test_count_launch_is_exact_across_threads():
    """More threads than cores, a switch interval of a microsecond: a
    read-modify-write of the counts without the lock loses updates."""
    hm.reset_launch_counts()
    per, n = 20_000, 2 * THREADS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run(lambda i: [hm.count_launch("predict_binned_forest")
                        for _ in range(per)], n=n)
    finally:
        sys.setswitchinterval(interval)
    assert hm.launch_counts()["predict_binned_forest"] == n * per
    hm.reset_launch_counts()


def test_recording_is_per_thread():
    """A capture's tally holds its own thread's launches only."""
    hm.reset_launch_counts()
    inside = threading.Event()
    done = threading.Event()
    tallies = {}

    def capture():
        with hm.recording_launches() as tally:
            hm.count_launch("predict_packed_forest")
            inside.set()
            done.wait(timeout=30)
            hm.count_launch("predict_packed_forest")
        tallies["t"] = dict(tally)

    t = threading.Thread(target=capture)
    t.start()
    inside.wait(timeout=30)
    _run(lambda i: [hm.count_launch("predict_binned_forest")
                    for _ in range(100)], n=4)
    done.set()
    t.join(timeout=30)
    assert tallies["t"] == {"predict_packed_forest": 2}
    counts = hm.launch_counts()
    assert counts["predict_binned_forest"] == 400
    assert counts["predict_packed_forest"] == 0
    hm.add_launches(tallies["t"])
    assert hm.launch_counts()["predict_packed_forest"] == 2
    hm.reset_launch_counts()


def test_entry_binds_once_across_threads(monkeypatch, tmp_path):
    builds = []

    def fake_build_all():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)        # hold the lock a while
        return {stem: tmp_path / f"{stem}.so"
                for stem in {_cuda.SOURCES.get(k, k) for k in _cuda.KERNELS}}

    class FakeFn:
        def __init__(self, sym):
            self.sym = sym

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, sym):
            return FakeFn(sym)

    monkeypatch.setattr(_cuda, "_entries", {})
    monkeypatch.setattr(_cuda, "build_all", fake_build_all)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", FakeLib)
    got = {}

    def ask(i):
        name = ("serve_forest", "serve_packed", "predict_binned")[i % 3]
        got[i] = (name, _cuda._entry(name))

    _run(ask)
    assert len(builds) == 1
    for name, fn in got.values():
        assert fn.sym == _cuda.KERNELS[name][0]
        assert fn.argtypes == _cuda.KERNELS[name][1]
    assert got[0][1] is _cuda._entries["serve_forest"]


def test_plain_wrappers_from_threads_match_one_thread():
    import lightgbm_tpu_torch as lgt
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5)
    y = X[:, 0] - X[:, 1] + 0.1 * rng.randn(300)
    bst = lgt.train({"objective": "regression", "num_leaves": 7,
                     "verbosity": -1, "device_type": "cpu"},
                    lgt.Dataset(X, label=y), 4)
    f = build_device_forest(bst._host_model())
    bins = torch.from_numpy(f.bin_rows(X))
    want = predict_binned_forest(f.stacked, f.tree_class, bins, f.num_bins,
                                 f.missing_is_nan, 1)
    hm.reset_launch_counts()
    out = {}
    _run(lambda i: out.__setitem__(i, predict_binned_forest(
        f.stacked, f.tree_class, bins, f.num_bins, f.missing_is_nan, 1,
        rows=300 - i)))
    for i, got in out.items():
        assert torch.equal(got[:300 - i].view(torch.int32),
                           want[:300 - i].view(torch.int32))
        assert bool((got[300 - i:] == 0).all())
    assert sum(hm.launch_counts().values()) == 0
