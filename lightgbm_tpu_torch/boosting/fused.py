"""Fused multi-tree training: K boosting iterations per dispatch.

Port of lightgbm_tpu/boosting/fused.py:77-177 (build_fused_train). The
JAX package runs K iterations as one lax.scan on the device: objective
gradients, quantization, feature masks, every growth pass, the prune, the
exact refit, shrinkage and the score update, the host seeing one dispatch
per K trees. Here each tree is a fixed sequence of programs over buffers
that live across trees (learner/grower_mxu.Grower):

  prologue   gradients from the score, the row sample (bagging's mask
             from the device iteration index, GOSS under the key of the
             tree's row in a buffer the host fills before each block),
             the tree's feature mask and key (from the device iteration
             index), Grower.start
  pass<p>    each doubling pass, then "bridge" (the gate and the bridge
             pass): a pass on a finished tree changes nothing
  fixup      one fix-up pass (its number read from a device buffer)
  epilogue   Grower.finish, shrinkage with the JAX package's ok-zeroing
             (a tree that made no split becomes the booster's constant
             tree and moves no score), the score add through node_values,
             the tree written into the block's stack

On the card each program is captured once per trainer as a CUDA graph
(torch.cuda.graph, one memory pool for all of them) and replayed: the
graphs read and write only the buffers, which are allocated before any
capture, and keep the kernel launches they recorded, which each replay
adds to histogram_mxu's launch counts. The first tree the trainer grows
runs the programs eagerly, the fix-up once even if the tree is done: that
sizes every scratch buffer and library workspace the graphs use, and is
that tree's growth. The trainer holds the scratch buffers its graphs use
(histogram_mxu.scratch_buffers), so a booster that grows them later does
not free memory the graphs write. Only the fix-up loop
(Grower.fixup_loop) reads the device, `done` once before each fix-up
pass, as the JAX package's while_loop does; the pass number it gives is
written into the buffer the fix-up graph reads. A capture or replay that
fails raises; nothing falls back to another path. On the CPU the same
programs run eagerly, in the same order.

With k trees an iteration (num_class > 1, the JAX package's fused.py:
140-160) one set of programs grows every class's tree: a "gradients"
program computes the iteration's class-major [k, N] gradients and row
sample once, into buffers; the prologue copies the current class's row
of them (a device class index) into the grower's inputs, and the
epilogue adds the tree into that class's score row, writes it into the
stack at [iteration, class] and advances the class (and, after the last
class, the iteration). The graphs are captured once, as for one class,
so the pool and the capture do not grow with k.

Forced splits ride along, as in the JAX package's fused scan: the spec's
tensors are the Grower's, made before any capture, and the forced node
state (node_force, forced_ok, was_forced) is part of the grower state
that the prologue resets every tree. CEGB and the guard rails keep a
booster off this trainer (GBDT._fused_eligible).

The JAX package's stacked_score_traj (:54-79) is
learner/predict.stacked_score_traj here: GBDT.train_many scores each
block's stacked trees over the validation sets with it after the block,
one kernel launch a set, outside any graph.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from ..learner.grower import TreeArrays
from ..learner.grower_mxu import Grower, _select
from ..learner.histogram_mxu import (add_launches, node_values,
                                     recording_launches, scratch_buffers)
from ..objectives import gradients_at

__all__ = ["FusedTrainer", "build_fused_train"]


def _clone(x):
    """A fresh copy of a state (nested tuples of tensors, None kept)."""
    if isinstance(x, tuple):
        return type(x)(*[_clone(v) for v in x])
    return None if x is None else x.clone()


def _write(dst, src) -> None:
    """Copy a state into the buffers of one of the same layout."""
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    elif dst is not None:
        dst.copy_(src)


def _nbytes(x) -> int:
    if isinstance(x, tuple):
        return sum(_nbytes(v) for v in x)
    return 0 if x is None else x.numel() * x.element_size()


# one side stream per device for every trainer's warm-up and captures:
# PyTorch keeps a cuBLAS workspace for each stream a matmul ran on, for
# the life of the process, so a stream of each trainer's own would leave
# one behind per trainer
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


class FusedTrainer:
    """run(score, it0, k) -> (score', stacked TreeArrays [k, ...], or [k,
    num_class, ...] with num_class trees an iteration): k boosting
    iterations from iteration it0, bit for bit what k calls of the
    per-iteration path (GBDT.train_one_iter) give. Built by
    build_fused_train."""

    def __init__(self, *, objective, grower: Grower,
                 cnt_weight: torch.Tensor,
                 feature_mask_fn: Callable, key_fn: Optional[Callable],
                 shrinkage: float, const_tree: TreeArrays, block: int,
                 sample_fn: Optional[Callable] = None,
                 sample_keys: bool = False, num_class: int = 1):
        self.objective = objective
        self.num_class = max(1, int(num_class))
        self.grower = grower
        self.cnt = cnt_weight
        self.sample_fn = sample_fn
        self.sample_keys = sample_keys
        self.feature_mask_fn = feature_mask_fn
        self.key_fn = key_fn
        self.shrinkage = shrinkage
        self.const_tree = const_tree
        self.block = max(1, int(block))
        self.dev = cnt_weight.device
        self.use_graphs = self.dev.type == "cuda"
        dev = self.dev
        # buffers that live across trees
        self.score: Optional[torch.Tensor] = None
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.fix_no = torch.zeros((), dtype=torch.int32, device=dev)
        # the class whose tree grows (num_class > 1), and the iteration's
        # gradients, hessians and count, which its prologue reads
        self.cls = torch.zeros(1, dtype=torch.int64, device=dev)
        self.gh = None
        self._classes_done = 0
        # the sampler's keys, a row a tree of the chunk
        self.keys = torch.zeros((self.block, 2), dtype=torch.int64,
                                device=dev) if sample_keys else None
        self.inputs = None
        self.state = None
        self.stacked = TreeArrays(*[
            torch.empty((self.block * self.num_class,) + tuple(t.shape),
                        dtype=t.dtype, device=dev) for t in const_tree])
        # the programs by name, in order: the scheduled passes run
        # through _step, the others are methods _<name> (names, not bound
        # methods, so the trainer holds no reference to itself and goes,
        # graphs and all, when its owner drops it)
        self._passes = dict(grower.scheduled())
        self.programs = ["prologue", *self._passes, "fixup", "epilogue"]
        if self.num_class > 1:
            self.programs.insert(0, "gradients")
        self.graphs: Dict[str, tuple] = {}
        self._held = []     # the scratch buffers the graphs use
        self._stream = _capture_stream(dev) if self.use_graphs else None
        #: programs and graphs captured; capture seconds, graph pool
        #: bytes, buffer bytes; per tree the fix-up passes and host reads
        #: of `done`; fix-up passes run on a done tree (the first tree's,
        #: to size the buffers)
        self.stats = {"programs": len(self.programs), "graphs": 0,
                      "capture_s": 0.0, "graph_pool_bytes": 0,
                      "buffer_bytes": 0, "trees": 0, "fixup_passes": [],
                      "fixup_reads": [], "noop_fixups": 0}

    # ---- the programs: each reads and writes only the buffers
    def _sampled_gradients(self):
        """The iteration's (grad, hess, cnt): the objective's gradients at
        the score, row-sampled."""
        grad, hess = gradients_at(self.objective, self.score, self.it)
        cnt = self.cnt
        if self.sample_fn is not None:
            skey = None if self.keys is None else \
                self.keys.index_select(0, self.pos).reshape(2)
            grad, hess, cnt = self.sample_fn(grad, hess, self.it, skey)
        return grad, hess, cnt

    def _gradients(self) -> None:
        gh = self._sampled_gradients()
        if self.gh is None:   # the first iteration allocates the buffers
            self.gh = tuple(t.clone() for t in gh)
        else:
            _write(self.gh, gh)

    def _prologue(self) -> None:
        if self.num_class == 1:
            grad, hess, cnt = self._sampled_gradients()
        else:
            # the current class's row of the iteration's gradients
            grad, hess = (t.index_select(0, self.cls).reshape(-1)
                          for t in self.gh[:2])
            cnt = self.gh[2]
        key = None if self.key_fn is None else self.key_fn(self.it)
        # the sampled count lands in self.inputs.cnt, which the passes read
        inputs, state = self.grower.start(grad, hess, cnt,
                                          self.feature_mask_fn(self.it), key)
        if self.state is None:   # the first tree allocates the buffers
            self.inputs, self.state = _clone(inputs), _clone(state)
        else:
            _write(self.inputs, inputs)
            _write(self.state, state)

    def _step(self, fn) -> None:
        _write(self.state, fn(self.inputs, self.state))

    def _fixup(self) -> None:
        _write(self.state, self.grower.fixup(self.inputs, self.state,
                                             self.fix_no))

    def _epilogue(self) -> None:
        tree, row_node = self.grower.finish(self.inputs, self.state)
        ok = tree.num_leaves > 1
        tree = tree._replace(leaf_value=tree.leaf_value * self.shrinkage)
        if self.num_class == 1:
            score = self.score + node_values(row_node, tree.leaf_value)
            self.score.copy_(torch.where(ok, score, self.score))
            tree = _select(ok, tree, self.const_tree)
            for buf, t in zip(self.stacked, tree):
                buf.index_copy_(0, self.pos, t.unsqueeze(0))
            self.it += 1
            self.pos += 1
            return
        row = self.score.index_select(0, self.cls).reshape(-1)
        score = row + node_values(row_node, tree.leaf_value)
        self.score.index_copy_(0, self.cls,
                               torch.where(ok, score, row).unsqueeze(0))
        tree = _select(ok, tree, self.const_tree)
        slot = self.pos * self.num_class + self.cls
        for buf, t in zip(self.stacked, tree):
            buf.index_copy_(0, slot, t.unsqueeze(0))
        # the next class; after the last, class 0 of the next iteration
        self.cls += 1
        wrap = self.cls == self.num_class
        self.it += wrap.to(torch.int32).reshape(())
        self.pos += wrap.to(torch.int64)
        self.cls.masked_fill_(wrap, 0)

    # ---- running them
    def _program(self, name: str) -> None:
        fn = self._passes.get(name)
        if fn is not None:
            self._step(fn)
        else:
            getattr(self, "_" + name)()

    def _run(self, name: str) -> None:
        graph = self.graphs.get(name)
        if graph is None:
            self._program(name)
        else:
            graph[0].replay()
            add_launches(graph[1])

    def _capture(self) -> None:
        """Capture every program in one memory pool, after the first tree
        ran them eagerly, and hold the scratch buffers they use; raises if
        a capture fails. Garbage collection waits until the captures are
        done: an unreachable graph it frees releases its pool with
        cudaFree, which a capture in progress forbids."""
        torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            torch.cuda.empty_cache()   # as each capture does: pool alone
            before = torch.cuda.memory_reserved(self.dev)
            pool = torch.cuda.graph_pool_handle()
            for name in self.programs:
                g = torch.cuda.CUDAGraph()
                with recording_launches() as tally:
                    with torch.cuda.graph(g, pool=pool, stream=self._stream):
                        self._program(name)
                self.graphs[name] = (g, tally)
        finally:
            if collecting:
                gc.enable()
        self._held = scratch_buffers(self.dev)
        torch.cuda.synchronize(self.dev)
        self.stats.update(
            graphs=len(self.graphs), capture_s=time.perf_counter() - t0,
            graph_pool_bytes=torch.cuda.memory_reserved(self.dev) - before,
            buffer_bytes=_nbytes((self.score, self.inputs, self.state,
                                  self.stacked, self.gh)))

    def _tree(self, warm: bool) -> None:
        """One tree: the scheduled programs, the fix-up loop, the
        epilogue. warm: the fix-up runs once even on a done tree."""
        for name in self.programs:
            if name in ("gradients", "fixup", "epilogue"):
                continue
            self._run(name)

        def run(pass_idx):
            self.fix_no.fill_(pass_idx)
            self._run("fixup")

        passes, reads, noop = self.grower.fixup_loop(
            lambda: bool(self.state.done), run, warm)
        self._run("epilogue")
        self.stats["fixup_passes"].append(passes)
        self.stats["fixup_reads"].append(reads)
        self.stats["noop_fixups"] += noop
        self.stats["trees"] += 1

    def _class_tree(self, warm: bool) -> None:
        """The next class's tree; the iteration's gradients first when it
        is class 0's (the host counts the trees: _classes_done)."""
        if self.num_class > 1:
            if self._classes_done % self.num_class == 0:
                self._run("gradients")
            self._classes_done += 1
        self._tree(warm)

    def __call__(self, score: torch.Tensor, it0: int, k: int,
                 keys: Optional[torch.Tensor] = None):
        """keys: [k, 2] the sampler's key of each iteration (sample_keys)."""
        if self.sample_keys and (keys is None or keys.shape != (k, 2)):
            raise ValueError(f"this trainer's sampler takes [{k}, 2] keys")
        if self.score is None:
            self.score = torch.empty_like(score)
        self.score.copy_(score)
        self.it.fill_(int(it0))
        self.cls.zero_()
        self._classes_done = 0
        nc = self.num_class
        chunks = []
        for c0 in range(0, k, self.block):
            c = min(self.block, k - c0)
            self.pos.zero_()
            if self.keys is not None:
                self.keys[:c].copy_(keys[c0:c0 + c])
            for _ in range(c * nc):
                if self.use_graphs and not self.graphs:
                    side, cur = self._stream, torch.cuda.current_stream(
                        self.dev)
                    side.wait_stream(cur)
                    with torch.cuda.stream(side):
                        self._class_tree(warm=True)
                    cur.wait_stream(side)
                    self._capture()
                else:
                    self._class_tree(warm=False)
            chunks.append([
                t[:c].clone() if nc == 1 else
                t[:c * nc].reshape((c, nc) + tuple(t.shape[1:])).clone()
                for t in self.stacked])
        stacked = TreeArrays(*[torch.cat(ts) if len(ts) > 1 else ts[0]
                               for ts in zip(*chunks)])
        return self.score.clone(), stacked


def build_fused_train(**settings) -> FusedTrainer:
    """The counterpart of the JAX package's build_fused_train: a trainer
    run(score, it0, k) -> (score', stacked TreeArrays). Settings, all by
    keyword: objective; grower, the booster's Grower (its settings are
    GBDT._mxu_grow_kwargs, shared with the per-iteration path);
    cnt_weight; feature_mask_fn(it) and key_fn(it) (None: growth draws
    nothing), which take the iteration as a device int32 scalar;
    shrinkage; const_tree, the tree a stalled iteration keeps
    (GBDT._constant_tree); block, the trees a stack holds
    (fused_block_size); sample_fn(grad, hess, it, key) -> (grad, hess,
    cnt), the row sampler in place of cnt_weight (GBDT._sample_fn: None,
    bagging, GOSS), and sample_keys, whether it takes the [k, 2] keys the
    run is then given; num_class, the trees an iteration (the score and
    gradients class-major [num_class, N] when above 1)."""
    return FusedTrainer(**settings)
