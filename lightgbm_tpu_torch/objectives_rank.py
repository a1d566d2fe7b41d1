"""Ranking objectives: LambdaRank-NDCG and XE-NDCG as batched pairwise ops.

Port of lightgbm_tpu/objectives_rank.py (reference
src/objective/rank_objective.hpp: LambdarankNDCG :95-281, RankXENDCG
:283-365). Queries are padded into a dense [num_queries, max_len] layout
(pad_queries); each batch of queries computes its gradients from full
pairwise [Qb, L, L] tensors on the device, the batch sized so that Qb x L^2
stays within 32M elements (128 MB of f32), as in the JAX package, and the
batches run in turn. Nothing reads back to the host, so the fused
trainer's prologue can hold it in a CUDA graph.

Documents are ranked within a query by a stable sort of their scores in
descending order, in the order the JAX package's jnp.argsort sorts
floats in (-0.0 ties 0.0, every NaN last): the scores are sorted as
order-preserving int32 keys. DCG pieces follow src/metric/dcg_calculator:
label_gain[i] = 2^i - 1, discount[rank] = 1/log2(rank + 2).

RankXENDCG draws one uniform a padded document an iteration under
fold_in(PRNGKey(seed), iteration) (the JAX package's per-iteration path,
whose counter of get_gradients calls is the iteration); the iteration is
an int or the fused trainer's device scalar.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import rng
from .config import Config
from .objectives import ObjectiveFunction, _f32
from .utils.log import Log

__all__ = ["LambdarankNDCG", "RankXENDCG", "pad_queries",
           "default_label_gain"]

_K_MIN_SCORE = -1e30
# Qb x L^2 elements of a query batch's pairwise tensors
_PAIR_BUDGET = 32 * 1024 * 1024


def default_label_gain(max_label: int = 31) -> np.ndarray:
    return (2.0 ** np.arange(max_label + 1)) - 1.0


def pad_queries(query_boundaries: np.ndarray,
                max_len: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Dense doc-index layout [Q, L] (pad = num_data), its valid mask and
    L."""
    qb = np.asarray(query_boundaries, np.int64)
    sizes = np.diff(qb)
    n = int(qb[-1])
    lmax = int(sizes.max()) if max_len <= 0 else max_len
    pos = np.arange(lmax)[None, :]
    idx = np.where(pos < sizes[:, None], qb[:-1, None] + pos, n) \
        .astype(np.int32)
    return idx, idx < n, lmax


def _descending_order(sc: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(-sc, stable=True) along the last axis: -sc as
    order-preserving int32 keys, sorted stably. As jnp.argsort orders
    floats, -0.0 and 0.0 tie (the sum with +0.0 makes both +0.0) and
    every NaN, of either sign, goes last."""
    x = -sc + 0.0
    bits = x.view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    keys = torch.where(torch.isnan(x), torch.iinfo(torch.int32).max, keys)
    return torch.sort(keys, dim=-1, stable=True).indices


class _RankingBase(ObjectiveFunction):
    """Query-padded ranking base (RankingObjective, rank_objective.hpp:25)."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("Ranking tasks require query information")
        self.query_boundaries = metadata.query_boundaries
        doc_idx, doc_valid, self.max_len = pad_queries(self.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        l2 = max(self.max_len * self.max_len, 1)
        self.query_batch = max(1, min(self.num_queries, _PAIR_BUDGET // l2))
        qb = self.query_batch
        self.num_batches = (self.num_queries + qb - 1) // qb
        pad_q = self.num_batches * qb - self.num_queries
        doc_idx = np.pad(doc_idx, ((0, pad_q), (0, 0)),
                         constant_values=num_data)
        doc_valid = np.pad(doc_valid, ((0, pad_q), (0, 0)))
        self.doc_idx_d = torch.as_tensor(doc_idx.astype(np.int64),
                                         device=device)
        self.doc_valid_d = torch.as_tensor(doc_valid, device=device)
        self.label_pad = torch.cat([self.label, self.label.new_zeros(1)])

    def _batch_grads(self, labels, scores, valid, extra, it):
        raise NotImplementedError

    def _extras(self, it):
        """Per-query (or per-document) inputs of every padded query."""
        return None

    def get_gradients(self, score, it=0):
        n = self.num_data
        score_pad = torch.cat([score, score.new_zeros(1)])
        g_acc = score.new_zeros(n + 1)
        h_acc = score.new_zeros(n + 1)
        extras = self._extras(it)
        qb = self.query_batch
        for b in range(self.num_batches):
            rows = slice(b * qb, (b + 1) * qb)
            bidx = self.doc_idx_d[rows]
            bval = self.doc_valid_d[rows]
            g, h = self._batch_grads(
                self.label_pad[bidx], score_pad[bidx], bval,
                None if extras is None else extras[rows], it)
            flat = bidx.reshape(-1)
            # each document is one query's, so its slot takes one add; the
            # pads all land on slot n, which is dropped
            g_acc.index_add_(0, flat, torch.where(bval, g, 0.0).reshape(-1))
            h_acc.index_add_(0, flat, torch.where(bval, h, 0.0).reshape(-1))
        return self._weighted(g_acc[:n], h_acc[:n])

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0


class LambdarankNDCG(_RankingBase):
    name = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        if config.label_gain:
            self.label_gain_np = np.asarray(config.label_gain, np.float64)
        else:
            self.label_gain_np = default_label_gain()

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lbl = self._label_np
        if lbl.min() < 0 or not np.allclose(lbl, np.round(lbl)):
            Log.fatal("Label should be int >= 0 in lambdarank")
        if int(lbl.max()) >= len(self.label_gain_np):
            Log.fatal("Label %d exceeds label_gain size %d",
                      int(lbl.max()), len(self.label_gain_np))
        self.label_gain_d = torch.as_tensor(
            self.label_gain_np.astype(np.float32), device=device)
        # inverse max DCG at the truncation level, a query
        # (rank_objective.hpp:124-135)
        qb = np.asarray(self.query_boundaries, np.int64)
        disc = 1.0 / np.log2(np.arange(self.truncation_level) + 2.0)
        inv = np.zeros(self.num_batches * self.query_batch, np.float32)
        for qi in range(self.num_queries):
            gains = np.sort(self.label_gain_np[
                lbl[qb[qi]:qb[qi + 1]].astype(np.int64)])[::-1][
                    :self.truncation_level]
            mdcg = float((gains * disc[:len(gains)]).sum())
            inv[qi] = 1.0 / mdcg if mdcg > 0 else 0.0
        self.inverse_max_dcgs = inv[:self.num_queries]
        self.inv_max_dcg_d = torch.as_tensor(inv, device=device)
        lpos = torch.arange(self.max_len, device=device)
        self._ranks = lpos
        self._discount = 1.0 / torch.log2(lpos.to(torch.float32) + 2.0)

    def _extras(self, it):
        return self.inv_max_dcg_d

    def _batch_grads(self, labels, scores, valid, inv_max_dcg, it):
        """Pairwise lambdas of a batch of padded queries [Qb, L]
        (rank_objective.hpp:140-226)."""
        sig = self.sigmoid
        sc = torch.where(valid, scores, _f32(_K_MIN_SCORE))
        order = _descending_order(sc)
        s_lbl = torch.gather(labels, 1, order).to(torch.int64)
        s_sc = torch.gather(sc, 1, order)
        s_valid = torch.gather(valid, 1, order)
        n_valid = s_valid.sum(dim=1)
        gains = self.label_gain_d[s_lbl.clamp(0, len(self.label_gain_np)
                                              - 1)]
        ranks = self._ranks
        discount = self._discount
        best = s_sc[:, 0]
        worst = torch.gather(s_sc, 1, (n_valid - 1).clamp(min=0)[:, None]
                             )[:, 0]

        # pairwise [Qb, L, L] over sorted positions (i row, j column)
        pair_ok = ((ranks[:, None] < ranks[None, :]) &
                   (ranks[:, None] < self.truncation_level))[None] & \
            s_valid[:, :, None] & s_valid[:, None, :] & \
            (s_lbl[:, :, None] != s_lbl[:, None, :])
        hi_is_i = s_lbl[:, :, None] > s_lbl[:, None, :]
        sc_i, sc_j = s_sc[:, :, None], s_sc[:, None, :]
        delta_score = torch.where(hi_is_i, sc_i, sc_j) - \
            torch.where(hi_is_i, sc_j, sc_i)
        dcg_gap = torch.abs(gains[:, :, None] - gains[:, None, :])
        paired_disc = torch.abs(discount[:, None] - discount[None, :])
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg[:, None, None]
        if self.norm:
            delta_ndcg = torch.where(
                (best != worst)[:, None, None],
                delta_ndcg / (0.01 + torch.abs(delta_score)), delta_ndcg)
        ds = torch.clamp(delta_score * _f32(sig), -100.0, 100.0)
        p = 1.0 / (1.0 + torch.exp(ds))
        p_lambda = torch.where(pair_ok, _f32(-sig) * delta_ndcg * p, 0.0)
        p_hess = torch.where(
            pair_ok, p * (1.0 - p) * _f32(sig) * _f32(sig) * delta_ndcg,
            0.0)
        # high doc += p_lambda, low doc -= p_lambda, at sorted positions
        lam_i = torch.where(hi_is_i, p_lambda, -p_lambda).sum(dim=2)
        lam_j = torch.where(hi_is_i, -p_lambda, p_lambda).sum(dim=1)
        lam_sorted = lam_i + lam_j
        hes_sorted = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        if self.norm:
            sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas) /
                torch.clamp(sum_lambdas, min=_f32(1e-30)),
                torch.ones_like(sum_lambdas))
            lam_sorted = lam_sorted * factor[:, None]
            hes_sorted = hes_sorted * factor[:, None]
        # back from sorted positions to the documents' own
        lam = torch.zeros_like(lam_sorted).scatter_(1, order, lam_sorted)
        hes = torch.zeros_like(hes_sorted).scatter_(1, order, hes_sorted)
        return lam, hes


class RankXENDCG(_RankingBase):
    name = "rank_xendcg"
    draws_per_iteration = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.seed = int(config.seed)

    def _extras(self, it):
        # a fresh draw an iteration (the reference keeps a per-query PRNG
        # stream, rank_objective.hpp:296-299)
        key = rng.fold_in(rng.PRNGKey(self.seed, self.device), it)
        u = rng.uniform(key, (self.num_batches * self.query_batch,
                              self.max_len))
        # jax.random.uniform's minval 1e-7, maxval 1: u x (max - min) +
        # min, which XLA fuses into one rounding (the product of two f32s
        # is exact in f64)
        lo = _f32(1e-7)
        scaled = u.double() * _f32(np.float32(1.0) - np.float32(lo)) + lo
        return torch.clamp(scaled.float(), min=lo)

    def _batch_grads(self, labels, scores, valid, uniform, it):
        """XE-NDCG (rank_objective.hpp:301-355) of a batch of padded
        queries [Qb, L]."""
        sc = torch.where(valid, scores, -torch.inf)
        rho = torch.softmax(sc, dim=1)
        rho = torch.where(valid, rho, 0.0)
        phi = torch.where(valid, torch.pow(2.0, labels) - uniform, 0.0)
        inv_denom = 1.0 / torch.clamp(phi.sum(dim=1, keepdim=True),
                                      min=_f32(1e-15))
        eps = _f32(1e-15)
        term1 = -phi * inv_denom + rho
        params = torch.where(valid, term1 / (1.0 - rho + eps), 0.0)
        term2 = rho * (params.sum(dim=1, keepdim=True) - params)
        params2 = torch.where(valid, term2 / (1.0 - rho + eps), 0.0)
        lam = term1 + term2 + rho * (params2.sum(dim=1, keepdim=True) -
                                     params2)
        hes = rho * (1.0 - rho)
        cnt = valid.sum(dim=1, keepdim=True)
        drop = (cnt <= 1) | ~valid
        return torch.where(drop, 0.0, lam), torch.where(drop, 0.0, hes)
