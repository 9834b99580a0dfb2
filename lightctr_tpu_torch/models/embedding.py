"""word2vec-CBOW embedding training (negative sampling + hierarchical
softmax), on tensors.

The port's counterpart of ``lightctr_tpu/models/embedding.py`` (capability
parity with ``Train_Embed_Algo``): CBOW (the context window's mean
predicts the center word), negative sampling from the unigram^0.75 table,
hierarchical softmax over a Huffman tree, frequent-word subsampling, the
L2-normalized export, PQ quantization and GMM clustering of the
embeddings.  The host preparation (vocabulary, subsampling, CBOW pairs,
the Huffman tree, the sampling logits) is the JAX module's numpy code, so
its outputs are equal.

Each step is one batch of (center, context) pairs on the device.  The
gathers of the two trained tables go through ``embed.table.lookup``: the
gradient of each sums every row's slots in slot order (``merge_rows`` at
d = dim on the card), as XLA sums the gradient of ``jnp.take``, so a step
repeats bit for bit on the card (``index_select``'s own backward adds with
atomics in no fixed order).  The gathers of the constant Huffman tables
are plain indexing.  Negatives are drawn by ``torch.multinomial`` (with
replacement) from a generator over the unigram^0.75 weights, where the
JAX trainer calls ``jax.random.categorical``.
"""

from __future__ import annotations

import heapq
import logging
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models.dl_trainer import grad_step
from lightctr_tpu_torch.optim import updaters as optim_lib

_LOG = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Vocab / corpus prep (host), the JAX module's numpy code
# ---------------------------------------------------------------------------

def load_vocab(path: str) -> Tuple[List[str], np.ndarray]:
    """Parse the reference's ``vocab.txt`` lines ``id word count``."""
    words, counts = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            words.append(parts[1])
            counts.append(int(parts[2]))
    return words, np.asarray(counts, np.int64)


def subsample_mask(counts: np.ndarray, word_ids: np.ndarray, t: float = 1e-3,
                   seed: int = 0) -> np.ndarray:
    """Frequent-word subsampling (train_embed_algo.cpp:111-118): discard a
    word occurrence with probability 1 - sqrt(t/f)."""
    freq = counts / counts.sum()
    keep_p = np.minimum(1.0, np.sqrt(t / np.maximum(freq[word_ids], 1e-12)))
    return np.random.default_rng(seed).random(len(word_ids)) < keep_p


def cbow_pairs(docs: List[np.ndarray], window: int,
               counts: Optional[np.ndarray] = None, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centers [M], contexts [M, 2w], ctx_mask [M, 2w]) from documents."""
    centers, contexts, masks = [], [], []
    for d, doc in enumerate(docs):
        if counts is not None:
            doc = doc[subsample_mask(counts, doc, seed=seed + d)]
        n = len(doc)
        for i in range(n):
            lo, hi = max(0, i - window), min(n, i + window + 1)
            ctx = np.concatenate([doc[lo:i], doc[i + 1: hi]])
            if len(ctx) == 0:
                continue
            pad = np.zeros(2 * window, np.int32)
            m = np.zeros(2 * window, np.float32)
            pad[: len(ctx)] = ctx
            m[: len(ctx)] = 1.0
            centers.append(doc[i])
            contexts.append(pad)
            masks.append(m)
    return (np.asarray(centers, np.int32),
            np.stack(contexts).astype(np.int32),
            np.stack(masks).astype(np.float32))


def build_huffman(counts: np.ndarray, max_code_len: int = 40):
    """Huffman tree over word frequencies (train_embed_algo.cpp:15-72).
    Returns (paths [V, L] inner-node ids, signs [V, L] +-1, mask [V, L])."""
    v = len(counts)
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    side = {}
    next_id = v
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1], side[n1] = next_id, 1.0   # left = code 1 -> sigmoid(+x)
        parent[n2], side[n2] = next_id, -1.0
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1]
    paths = np.zeros((v, max_code_len), np.int32)
    signs = np.zeros((v, max_code_len), np.float32)
    mask = np.zeros((v, max_code_len), np.float32)
    for w in range(v):
        node, p = w, []
        while node != root:
            p.append((parent[node] - v, side[node]))  # inner nodes 0..v-2
            node = parent[node]
        p = p[::-1][:max_code_len]
        for j, (nid, s) in enumerate(p):
            paths[w, j] = nid
            signs[w, j] = s
            mask[w, j] = 1.0
    return paths, signs, mask


def negative_table_logits(counts: np.ndarray) -> np.ndarray:
    """log(unigram^0.75) sampling logits (train_embed_algo.h:175-200)."""
    p = counts.astype(np.float64) ** 0.75
    return np.log(p / p.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Word2VecParams(NamedTuple):
    emb: torch.Tensor   # [V, D] input (context) embeddings
    out: torch.Tensor   # [V, D] output embeddings (negative sampling) or
                        # inner nodes (hierarchical, V-1 used)


def init(generator: torch.Generator, vocab: int, dim: int,
         device="cpu") -> Word2VecParams:
    """emb ~ (U(0, 1) - 0.5) / dim (the word2vec init), out zeros."""
    emb = (torch.rand((vocab, dim), generator=generator, dtype=torch.float32,
                      device=generator.device) - 0.5) / dim
    return Word2VecParams(emb=emb.to(device),
                          out=torch.zeros((vocab, dim), dtype=torch.float32,
                                          device=device))


def _context_mean(emb, contexts, ctx_mask):
    vecs = lookup(emb, contexts)                              # [B, 2w, D]
    s = torch.sum(vecs * ctx_mask[..., None], dim=1)
    return s / torch.clamp(torch.sum(ctx_mask, dim=1, keepdim=True), min=1.0)


def neg_sampling_loss(params: Word2VecParams, centers: torch.Tensor,
                      contexts: torch.Tensor, ctx_mask: torch.Tensor,
                      negatives: torch.Tensor) -> torch.Tensor:
    """Three table gathers: the context rows of ``emb``, the centers' and
    the negatives' rows of ``out``."""
    h = _context_mean(params.emb, contexts, ctx_mask)         # [B, D]
    u_pos = lookup(params.out, centers)                       # [B, D]
    u_neg = lookup(params.out, negatives)                     # [B, K, D]
    pos = torch.sum(h * u_pos, dim=-1)
    neg = torch.einsum("bd,bkd->bk", h, u_neg)
    return torch.mean(F.softplus(-pos) + torch.sum(F.softplus(neg), dim=-1))


def hierarchical_loss(params: Word2VecParams, centers: torch.Tensor,
                      contexts: torch.Tensor, ctx_mask: torch.Tensor,
                      paths: torch.Tensor, signs: torch.Tensor,
                      pmask: torch.Tensor) -> torch.Tensor:
    """Two table gathers: the context rows of ``emb`` and the path nodes'
    rows of ``out``; the Huffman tables are indexed plainly."""
    h = _context_mean(params.emb, contexts, ctx_mask)          # [B, D]
    c = centers.to(torch.int64)
    node_ids = paths[c]                                        # [B, L]
    u = lookup(params.out, node_ids)                           # [B, L, D]
    logits = torch.einsum("bd,bld->bl", h, u) * signs[c]
    return torch.mean(torch.sum(F.softplus(-logits) * pmask[c], dim=-1))


#: table gathers (``lookup`` calls, so ``merge_rows`` launches) a step
GATHERS = {"negative": 3, "hierarchical": 2}


class Word2VecTrainer:
    """CBOW trainer (dense Adagrad over both tables) on ``device``
    (``cuda`` by default; it raises without CUDA)."""

    def __init__(self, vocab_cnt: int, dim: int, cfg: TrainConfig,
                 counts: np.ndarray, mode: str = "negative",
                 n_negative: int = 5, device="cuda"):
        if mode not in ("negative", "hierarchical"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.n_negative = n_negative
        self.params = init(torch.Generator(device=self.device).manual_seed(
            cfg.seed), vocab_cnt, dim, device=self.device)
        self.tx = optim_lib.adagrad(cfg.learning_rate)
        self.opt_state = self.tx.init(self.params)
        # unigram^0.75 weights: softmax of the JAX trainer's logits
        self._neg_probs = torch.softmax(torch.from_numpy(
            negative_table_logits(counts)).to(self.device), dim=0)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        if mode == "hierarchical":
            self._paths, self._signs, self._pmask = (
                torch.from_numpy(a).to(self.device)
                for a in build_huffman(counts))

    def _negatives(self, rows: int) -> torch.Tensor:
        """[rows, n_negative] word ids drawn from the generator."""
        return torch.multinomial(self._neg_probs, rows * self.n_negative,
                                 replacement=True,
                                 generator=self.generator).reshape(
            rows, self.n_negative)

    def _loss(self, params, centers, contexts, ctx_mask):
        if self.mode == "negative":
            return neg_sampling_loss(params, centers, contexts, ctx_mask,
                                     self._negatives(centers.shape[0]))
        return hierarchical_loss(params, centers, contexts, ctx_mask,
                                 self._paths, self._signs, self._pmask)

    def step(self, centers: torch.Tensor, contexts: torch.Tensor,
             ctx_mask: torch.Tensor) -> torch.Tensor:
        """One update on a batch already on the device; returns the loss
        (a device scalar)."""
        self.params, self.opt_state, loss = grad_step(
            self._loss, self.tx, self.params, self.opt_state, centers,
            contexts, ctx_mask)
        return loss

    def fit(self, centers: np.ndarray, contexts: np.ndarray,
            ctx_mask: np.ndarray, epochs: int = 5, batch_size: int = 256,
            verbose: bool = False) -> List[float]:
        n = len(centers)
        if n == 0:
            raise ValueError("no CBOW pairs to train on")
        batch_size = min(batch_size, n)
        dev = self.device
        c_all, x_all, m_all = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                               for a in (centers, contexts, ctx_mask))
        history = []
        for epoch in range(epochs):
            order = np.random.default_rng(self.cfg.seed + epoch).permutation(n)
            loss = None
            for s in range(0, n - batch_size + 1, batch_size):
                sel = torch.from_numpy(order[s: s + batch_size]).to(dev)
                loss = self.step(c_all[sel], x_all[sel], m_all[sel])
            history.append(float(loss))
            obs.emit_event("epoch", epoch=epoch, loss=float(loss))
            if verbose:
                obs.ensure_console_logging()
                _LOG.info("epoch %d: loss=%.5f", epoch, float(loss))
        return history

    def normalized_embeddings(self) -> np.ndarray:
        """L2-normalized rows (train_embed_algo.cpp:208-230 export)."""
        e = self.params.emb.cpu().numpy()
        return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)

    def quantize(self, part_cnt: Optional[int] = None, cluster_cnt: int = 64):
        """PQ codes of the embeddings (``Quantization()``, main.cpp:240-243)
        on the trainer's device; ``part_cnt`` defaults to the largest
        divisor of the dim that is <= 10."""
        from lightctr_tpu_torch.ops import pq

        emb = torch.from_numpy(self.normalized_embeddings()).to(self.device)
        dim = emb.shape[1]
        if part_cnt is None:
            part_cnt = next(p for p in range(min(10, dim), 0, -1)
                            if dim % p == 0)
        gen = torch.Generator(device=self.device).manual_seed(0)
        cb = pq.train(gen, emb, part_cnt=part_cnt, cluster_cnt=cluster_cnt)
        return cb, pq.encode(cb, emb).cpu().numpy()

    def cluster(self, n_clusters: int = 20, epochs: int = 30):
        """GMM clustering of the embeddings (``EmbeddingCluster()``,
        main.cpp:244-248) on the trainer's device."""
        from lightctr_tpu_torch.models import gmm

        emb = self.normalized_embeddings()
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = gmm.init_from_data(gen, n_clusters, emb, device=self.device)
        params, _ = gmm.fit(params, emb, epochs=epochs, device=self.device)
        return gmm.predict(params, emb)
