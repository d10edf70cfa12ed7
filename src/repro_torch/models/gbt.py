"""Gradient-boosted regression trees, the paper's XGBoost baseline (the
counterpart of ``repro.models.gbt``).

Second-order boosting on squared error (grad = residual, hess = 1) with
depth-limited binary trees, candidate thresholds at feature quantiles,
lambda L2 leaf regularization and shrinkage.  :meth:`fit` is host numpy
in the JAX package too; it is copied verbatim, so the trees come out
bitwise the same.  Trees are dense arrays (feature id and threshold per
internal node, value per leaf), and :meth:`predict` walks every row down
each tree in turn on the caller's device, adding ``lr * leaf`` in the
order of the JAX ``lax.scan``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GBTParams:
    feats: torch.Tensor    # (T, NInternal) int32
    thresh: torch.Tensor   # (T, NInternal) float32
    leaves: torch.Tensor   # (T, NLeaves) float32
    base: float
    lr: float
    depth: int

    @classmethod
    def from_arrays(cls, feats, thresh, leaves, base: float, lr: float,
                    depth: int) -> "GBTParams":
        """The trees from arrays (numpy, or anything ``np.asarray``
        takes, such as a JAX ``GBTParams``' fields), as CPU tensors."""
        return cls(torch.from_numpy(np.array(feats, np.int32)),
                   torch.from_numpy(np.array(thresh, np.float32)),
                   torch.from_numpy(np.array(leaves, np.float32)),
                   float(base), float(lr), int(depth))


class GradientBoostedTrees:
    def __init__(
        self,
        history_len: int = 12,
        hidden: int = 0,  # unused; uniform ctor signature
        num_trees: int = 50,
        depth: int = 4,
        lr: float = 0.1,
        reg_lambda: float = 1.0,
        num_thresholds: int = 16,
    ):
        self.history_len = history_len
        self.num_trees = num_trees
        self.depth = depth
        self.lr = lr
        self.reg_lambda = reg_lambda
        self.num_thresholds = num_thresholds

    # -- fitting (host-side, vectorized gain search) ----------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> GBTParams:
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        n, d = x.shape
        base = float(y.mean())
        pred = np.full(n, base, np.float32)

        # candidate thresholds: per-feature quantiles
        qs = np.linspace(0.05, 0.95, self.num_thresholds)
        cand = np.quantile(x, qs, axis=0)  # (Q, d)

        n_internal = 2**self.depth - 1
        n_leaves = 2**self.depth
        feats = np.zeros((self.num_trees, n_internal), np.int32)
        thresh = np.zeros((self.num_trees, n_internal), np.float32)
        leaves = np.zeros((self.num_trees, n_leaves), np.float32)

        for t in range(self.num_trees):
            grad = pred - y  # d/dpred 0.5*(pred-y)^2
            node_of = np.zeros(n, np.int32)  # current node id per sample
            for level in range(self.depth):
                start = 2**level - 1
                for node in range(start, 2 ** (level + 1) - 1):
                    mask = node_of == node
                    if mask.sum() < 4:
                        feats[t, node] = 0
                        thresh[t, node] = -np.inf  # all go right
                        continue
                    xg, gg = x[mask], grad[mask]
                    gsum = gg.sum()
                    csum = mask.sum()
                    # gain for every (feature, threshold): vectorized
                    left = xg[:, None, :] <= cand[None, :, :]  # (m, Q, d)
                    gl = np.einsum("m,mqd->qd", gg, left)
                    cl = left.sum(axis=0)
                    gr = gsum - gl
                    cr = csum - cl
                    lam = self.reg_lambda
                    gain = gl**2 / (cl + lam) + gr**2 / (cr + lam) - gsum**2 / (csum + lam)
                    gain[(cl < 2) | (cr < 2)] = -np.inf
                    q_best, f_best = np.unravel_index(np.argmax(gain), gain.shape)
                    feats[t, node] = f_best
                    thresh[t, node] = cand[q_best, f_best]
                # descend all samples one level
                f = feats[t, node_of]
                th = thresh[t, node_of]
                go_left = x[np.arange(n), f] <= th
                node_of = 2 * node_of + np.where(go_left, 1, 2)
            leaf_ids = node_of - n_internal
            for leaf in range(n_leaves):
                mask = leaf_ids == leaf
                g = grad[mask]
                leaves[t, leaf] = (
                    0.0 if mask.sum() == 0 else -g.sum() / (mask.sum() + self.reg_lambda)
                )
            pred = pred + self.lr * leaves[t, leaf_ids]

        return GBTParams.from_arrays(feats, thresh, leaves, base, self.lr, self.depth)

    # -- prediction (torch, on the caller's device) -------------------------
    def predict(self, params: GBTParams, x: torch.Tensor) -> torch.Tensor:
        """x (n, d) -> (n,): ``base`` plus ``lr * leaf`` of each tree in
        turn, every row walked down ``depth`` levels (left where
        ``x[f] <= threshold``)."""
        dev = x.device
        feats = params.feats.to(dev, torch.int64)
        thresh = params.thresh.to(dev)
        leaves = params.leaves.to(dev)
        n = x.shape[0]
        n_internal = feats.shape[1]
        rows = torch.arange(n, device=dev)
        pred = torch.full((n,), params.base, dtype=x.dtype, device=dev)
        for t in range(feats.shape[0]):
            node = torch.zeros(n, dtype=torch.int64, device=dev)
            for _ in range(params.depth):
                go_left = x[rows, feats[t, node]] <= thresh[t, node]
                node = 2 * node + torch.where(go_left, 1, 2)
            pred = pred + params.lr * leaves[t, node - n_internal]
        return pred
