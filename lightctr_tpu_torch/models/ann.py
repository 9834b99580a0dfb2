"""Approximate nearest-neighbour retrieval.

The port's counterpart of ``lightctr_tpu/models/ann.py``: capability parity
with ``ANNIndex`` (predict/ann_index.h), an Annoy-style forest of
random-projection trees whose split hyperplane comes from 2-means of
sampled points (ann_index.h:225-268), queried by priority-queue beam search
across trees (ann_index.h:198-223).

  - :func:`brute_force_topk`: one [Q, D] x [D, N] matrix product and
    ``torch.topk`` on the device: exact, and the default for corpora that
    fit in device memory.
  - :class:`ANNIndex`: the RP-tree forest; tree construction and traversal
    are host numpy (pointer chasing), and the candidate re-rank is
    :func:`brute_force_topk` on the index's device.

``torch.topk`` and ``lax.top_k`` may order equal scores differently; where
the k-th and (k+1)-th scores differ, both give the same set.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.ops.pq import _pairwise_sq_dist


def brute_force_topk(
    queries: np.ndarray, corpus: np.ndarray, k: int, metric: str = "dot",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k by one matrix product on ``device``; metric 'dot' or
    'l2' (the negated squared distance).  Returns host (indices, scores),
    each [Q, k], best first."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    c = torch.as_tensor(np.asarray(corpus, np.float32)).to(dev)
    if metric == "dot":
        s = q @ c.T
    elif metric == "l2":
        s = -_pairwise_sq_dist(q, c)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    vals, idx = torch.topk(s, k, dim=-1)
    return idx.cpu().numpy(), vals.cpu().numpy()


@dataclasses.dataclass
class _Node:
    # internal: hyperplane (w, b); leaf: item indices
    w: np.ndarray | None = None
    b: float = 0.0
    left: int = -1
    right: int = -1
    items: np.ndarray | None = None


class ANNIndex:
    """Forest of RP trees (ann_index.h).  ``build`` then ``query``; the
    re-rank runs on ``device``."""

    def __init__(self, n_trees: int = 8, leaf_size: int = 32, seed: int = 0,
                 device="cuda"):
        self.n_trees = n_trees
        self.leaf_size = leaf_size
        self.seed = seed
        self.device = resolve_device(device)
        self.trees: List[List[_Node]] = []
        self.corpus: np.ndarray | None = None

    def build(self, corpus: np.ndarray) -> "ANNIndex":
        self.corpus = np.asarray(corpus, np.float32)
        rng = np.random.default_rng(self.seed)
        self.trees = [self._build_tree(rng) for _ in range(self.n_trees)]
        return self

    def _split_plane(self, items: np.ndarray, rng) -> Tuple[np.ndarray, float]:
        """Hyperplane from 2-means of sampled points (ann_index.h:225-268)."""
        sample = self.corpus[rng.choice(items, size=min(32, len(items)),
                                        replace=False)]
        c1, c2 = sample[0].copy(), sample[-1].copy()
        for _ in range(5):  # tiny 2-means
            d1 = np.linalg.norm(sample - c1, axis=1)
            d2 = np.linalg.norm(sample - c2, axis=1)
            m1 = d1 <= d2
            if m1.any():
                c1 = sample[m1].mean(axis=0)
            if (~m1).any():
                c2 = sample[~m1].mean(axis=0)
        w = c1 - c2
        norm = np.linalg.norm(w)
        if norm < 1e-12:
            w = rng.standard_normal(self.corpus.shape[1]).astype(np.float32)
            norm = np.linalg.norm(w)
        w = w / norm
        b = -float(w @ (0.5 * (c1 + c2)))
        return w.astype(np.float32), b

    def _build_tree(self, rng) -> List[_Node]:
        nodes: List[_Node] = []

        def rec(items: np.ndarray) -> int:
            nid = len(nodes)
            nodes.append(_Node())
            if len(items) <= self.leaf_size:
                nodes[nid].items = items
                return nid
            w, b = self._split_plane(items, rng)
            proj = self.corpus[items] @ w + b
            left_items = items[proj >= 0]
            right_items = items[proj < 0]
            if len(left_items) == 0 or len(right_items) == 0:
                nodes[nid].items = items  # degenerate split -> leaf
                return nid
            nodes[nid].w, nodes[nid].b = w, b
            nodes[nid].left = rec(left_items)
            nodes[nid].right = rec(right_items)
            return nid

        rec(np.arange(len(self.corpus)))
        return nodes

    def query(self, q: np.ndarray, k: int, search_budget: int = 256
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam search across trees by |margin| priority
        (ann_index.h:198-223), then the exact re-rank of the candidate set
        on the device."""
        assert self.corpus is not None, "build() first"
        q = np.asarray(q, np.float32)
        heap: List[Tuple[float, int, int]] = []  # (-priority, tree, node)
        for t in range(self.n_trees):
            heapq.heappush(heap, (0.0, t, 0))
        candidates: List[np.ndarray] = []
        seen = 0
        while heap and seen < search_budget:
            prio, t, nid = heapq.heappop(heap)
            node = self.trees[t][nid]
            if node.items is not None:
                candidates.append(node.items)
                seen += len(node.items)
                continue
            margin = float(node.w @ q + node.b)
            near, far = ((node.left, node.right) if margin >= 0
                         else (node.right, node.left))
            heapq.heappush(heap, (prio, t, near))              # same priority
            heapq.heappush(heap, (prio + abs(margin), t, far))  # penalized
        cand = (np.unique(np.concatenate(candidates)) if candidates
                else np.arange(len(self.corpus)))
        idx, vals = brute_force_topk(q[None, :], self.corpus[cand],
                                     min(k, len(cand)), device=self.device)
        return cand[idx[0]], vals[0]
