"""PLSA topic model (EM over a doc-term count matrix), on tensors.

The port's counterpart of ``lightctr_tpu/models/plsa.py`` (capability
parity with ``Train_TM_Algo``'s PLSA path).  Each E+M pair is three
products in the multiplicative form (never the [D, W, T] latent):

  S          = P(t|d) @ P(w|t)                      # [D, W] mixture mass
  P(w|t)'   ∝ P(w|t) * (P(t|d)^T @ (N / S))         # M-step word dists
  P(t|d)'   ∝ P(t|d) * ((N / S) @ P(w|t)^T)         # M-step doc mixtures

``topic_keywords`` mirrors the reference's topic-word dump
(train_tm_algo.cpp:175-213).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device

EPS = 1e-12


class PLSAParams(NamedTuple):
    p_word_topic: torch.Tensor  # [T, W] P(w|t)
    p_topic_doc: torch.Tensor   # [D, T] P(t|d)


def init(generator: torch.Generator, n_docs: int, n_topics: int,
         n_words: int, device="cuda") -> PLSAParams:
    """Rows ~ U(0.1, 1), normalised, drawn from ``generator``; on
    ``device`` (``cuda`` by default; it raises without CUDA)."""
    dev = resolve_device(device)

    def draw(shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * 0.9 + 0.1
        return (u / torch.sum(u, dim=1, keepdim=True)).to(dev)

    pwt = draw((n_topics, n_words))
    return PLSAParams(p_word_topic=pwt, p_topic_doc=draw((n_docs, n_topics)))


def em_step(params: PLSAParams, counts: torch.Tensor
            ) -> Tuple[PLSAParams, torch.Tensor]:
    """One fused E+M step on the [D, W] count matrix; returns the
    log-likelihood."""
    with torch.no_grad():
        pwt, ptd = params.p_word_topic, params.p_topic_doc
        s = ptd @ pwt + EPS                                  # [D, W]
        ratio = counts / s
        pwt_new = pwt * (ptd.T @ ratio)                      # [T, W]
        pwt_new = pwt_new / (torch.sum(pwt_new, dim=1, keepdim=True) + EPS)
        ptd_new = ptd * (ratio @ pwt.T)                      # [D, T]
        ptd_new = ptd_new / (torch.sum(ptd_new, dim=1, keepdim=True) + EPS)
        loglik = torch.sum(counts * torch.log(s))
        return PLSAParams(p_word_topic=pwt_new, p_topic_doc=ptd_new), loglik


def fit(params: PLSAParams, counts: np.ndarray, epochs: int = 200,
        tol: float = 1e-4, verbose: bool = False,
        device="cuda") -> Tuple[PLSAParams, list]:
    """EM until the log-likelihood converges (models/em.py), on ``device``
    (``cuda`` by default; it raises without CUDA)."""
    from lightctr_tpu_torch.models.em import fit_em

    dev = resolve_device(device)
    params = PLSAParams(*(t.to(dev) for t in params))
    return fit_em(params, em_step,
                  torch.as_tensor(np.asarray(counts, np.float32)).to(dev),
                  epochs, tol, verbose, name="PLSA")


def topic_keywords(params: PLSAParams, vocab: List[str],
                   top_k: int = 10) -> List[List[str]]:
    """Top words per topic (train_tm_algo.cpp:175-213)."""
    pwt = params.p_word_topic.cpu().numpy()
    return [[vocab[i] for i in np.argsort(-pwt[t])[:top_k]]
            for t in range(pwt.shape[0])]
