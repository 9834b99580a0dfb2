"""Product quantizer for embedding compression, on tensors.

The port's counterpart of ``lightctr_tpu/ops/pq.py`` (a redesign of
``util/product_quantizer.h``): split D dims into ``part_cnt`` sub-vectors,
k-means each part to ``cluster_cnt`` centroids (E/M steps with
empty-cluster re-seeding from the biggest cluster,
product_quantizer.h:166-185), emit narrow integer codes
(product_quantizer.h:63-111 train/kmeans).

All parts train together as one batch of matrix products (the JAX
package's ``vmap``): the distances are ``x @ c.T``, and the M step sums
each cluster's members with a one-hot product, as the JAX package does —
never ``index_add_``, whose atomics on a card sum in an order that varies
from run to run.  Ties in ``argmin``/``argmax`` go to the first index in
both packages.  The initial centroids are a draw of rows from a
``torch.Generator`` (the JAX package draws with ``jax.random.choice``;
the two give different rows from one seed), and the k-means loop from
given centroids is :func:`_kmeans`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PQCodebook(NamedTuple):
    centroids: torch.Tensor  # [parts, clusters, sub_dim]


def _pairwise_sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[..., N, d] x [..., K, d] -> [..., N, K] squared L2 (one matmul +
    norms)."""
    return (torch.sum(x * x, dim=-1)[..., :, None]
            - 2.0 * x @ c.transpose(-1, -2)
            + torch.sum(c * c, dim=-1)[..., None, :])


def _kmeans_step(x: torch.Tensor, centroids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One E+M step, batched over leading dims ([..., N, d] points,
    [..., K, d] centroids); returns (new_centroids, assignments)."""
    k = centroids.shape[-2]
    assign = torch.argmin(_pairwise_sq_dist(x, centroids), dim=-1)  # [.., N]
    # the one-hot in x's dtype directly (one_hot's int64 would be twice
    # the size: 8 GB at 2^20 rows, 4 parts and 256 clusters)
    onehot = torch.zeros(assign.shape + (k,), dtype=x.dtype,
                         device=x.device)
    onehot.scatter_(-1, assign[..., None], 1.0)                   # [.., N, K]
    counts = torch.sum(onehot, dim=-2)                            # [..., K]
    sums = onehot.transpose(-1, -2) @ x                           # [.., K, d]
    new = sums / torch.clamp(counts, min=1.0)[..., None]
    # empty-cluster re-seeding (product_quantizer.h:166-185): adopt the
    # biggest cluster's centroid + deterministic perturbation
    biggest = torch.argmax(counts, dim=-1)                        # [...]
    top = torch.take_along_dim(new, biggest[..., None, None], dim=-2)
    ramp = 1e-3 * torch.arange(k, dtype=x.dtype, device=x.device)[:, None]
    reseed = top + ramp
    new = torch.where((counts > 0)[..., None], new, reseed)
    return new, assign


def _parts(embeddings: torch.Tensor, part_cnt: int) -> torch.Tensor:
    """[N, D] -> [parts, N, D / parts]."""
    n, d = embeddings.shape
    return embeddings.reshape(n, part_cnt, d // part_cnt).permute(1, 0, 2)


def _kmeans(parts: torch.Tensor, centroids: torch.Tensor,
            iters: int) -> torch.Tensor:
    """``iters`` k-means steps of every part from ``centroids``
    ([P, N, sub] points, [P, K, sub] centroids): the loop of ``train``."""
    for _ in range(iters):
        centroids, _ = _kmeans_step(parts, centroids)
    return centroids


def train(generator: torch.Generator, embeddings: torch.Tensor,
          part_cnt: int = 8, cluster_cnt: int = 256,
          iters: int = 20) -> PQCodebook:
    """A codebook for ``embeddings`` [N, D], on their device: initial
    centroids are ``cluster_cnt`` rows drawn from ``generator`` (distinct
    unless N < cluster_cnt), then ``iters`` k-means steps per part."""
    n, d = embeddings.shape
    if d % part_cnt != 0:
        raise ValueError(f"dim {d} not divisible by part_cnt {part_cnt}")
    parts = _parts(embeddings, part_cnt)
    if n >= cluster_cnt:
        init_idx = torch.randperm(n, generator=generator,
                                  device=generator.device)[:cluster_cnt]
    else:
        init_idx = torch.randint(n, (cluster_cnt,), generator=generator,
                                 device=generator.device)
    centroids = parts[:, init_idx.to(embeddings.device), :]
    return PQCodebook(centroids=_kmeans(parts, centroids, iters))


def encode(codebook: PQCodebook, embeddings: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, parts] integer codes (uint8 up to 256 clusters)."""
    p, k, _ = codebook.centroids.shape
    parts = _parts(embeddings, p)
    assign = torch.argmin(_pairwise_sq_dist(parts, codebook.centroids),
                          dim=-1)                                  # [P, N]
    dtype = torch.uint8 if k <= 256 else torch.int32
    return assign.T.to(dtype)


def decode(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """[N, parts] codes -> [N, D] reconstruction (a gather per part)."""
    c = codebook.centroids
    p = c.shape[0]
    idx = codes.to(torch.int64).T                                  # [P, N]
    recon = c[torch.arange(p, device=c.device)[:, None], idx]      # [P, N, s]
    return recon.permute(1, 0, 2).reshape(codes.shape[0], -1)


def quantization_error(codebook: PQCodebook,
                       embeddings: torch.Tensor) -> float:
    rec = decode(codebook, encode(codebook, embeddings))
    return float(torch.mean(torch.sum((embeddings - rec) ** 2, dim=1)))
