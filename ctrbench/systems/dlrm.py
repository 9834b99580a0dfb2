"""The system under test for DLRM configurations: ``lightctr_tpu_torch``'s
``SparseTableCTRTrainer`` over ``models.dlrm.make_logits`` (the pooled
bags of one table, ``sparse_tables={"embed": ["bag_ids"]}``; the bottom
MLP, the low-rank crosses and the top MLP on cuBLAS).

``prepare`` makes the pool's rows into the model's batch, as a user's
data preparation does: each feature's multi-hot bag from its one-hot id
(the configuration's ``assumed.multi_hot``) and log1p of the numeric
values.  The rows as made stay in the pool for the reference; the trainer
is handed the model's fields alone.  ``work`` counts the GEMMs of the
bottom MLP, the crosses and the top MLP, forward and backward, as
``gemm_flops``, the rest as ``common.work`` does."""

import numpy as np

from ctrbench import generate, roofline
from ctrbench.systems import common

#: the fields the model reads; the rows' ``fids``, ``vals`` and ``mask``
#: are the reference's
FIELDS = ("bag_ids", "dense", "labels")
#: the bag hash: ``((r * HASH_ROW + j * HASH_SLOT) mod M * LEHMER) mod M``,
#: then mod the feature's rows
M = 2 ** 31 - 1
HASH_ROW, HASH_SLOT, LEHMER = 2_654_435_761, 40_503, 48_271
#: pool rows expanded at a time (bounds the int64 temporaries)
CHUNK = 1 << 16


parameters = common.parameters
accumulators = common.accumulators


def _net(cfg):
    layout, net = cfg["layout"], cfg["dlrm"]
    d = int(cfg["factor_dim"])
    n_cat = int(layout["categorical"])
    return {"d": d, "n_cat": n_cat, "n_num": int(layout["fields"]) - n_cat,
            "bags": [int(s) for s in layout["multi_hot_sizes"]],
            "bottom": [int(w) for w in net["bottom_hidden"]],
            "top": [int(w) for w in net["top_hidden"]],
            "cross": int(net["cross_layers"]), "rank": int(net["cross_rank"]),
            "n": (n_cat + 1) * d}


def build(params, cfg, traffic, device):
    from lightctr_tpu_torch.models import dlrm

    tr = common.build_trainer(params, cfg, traffic, device,
                              dlrm.make_logits(_net(cfg)["bags"]))
    put = tr._put
    tr._put = lambda batch, **kw: put({k: batch[k] for k in FIELDS}, **kw)
    return tr


def prepare(pool, cfg):
    """``bag_ids`` [rows, sum of the bag sizes] int32 and ``dense``
    [rows, 13] float32 beside the rows as made.  Slot 0 of a feature's
    bag is its one-hot id; slot j the hash of (the id's row in its
    feature, j) into the feature's rows."""
    net = _net(cfg)
    counts = [int(c) for c in cfg["layout"]["num_embeddings_per_feature"]]
    rows = np.asarray(generate.field_rows(counts,
                                          int(cfg["vocab"]) - net["n_num"]),
                      np.int64)
    base = np.concatenate([[0], np.cumsum(rows)[:-1]])
    fids = pool["fids"]
    cat = fids[:, :net["n_cat"]].astype(np.int64)
    if (cat < base).any() or (cat >= base + rows).any():
        raise ValueError("a categorical id lies outside its feature's rows: "
                         "the traffic's cardinalities are not the "
                         "configuration's")
    # each slot's feature and its place in the bag
    sizes = np.asarray(net["bags"], np.int64)
    feature = np.repeat(np.arange(len(sizes)), sizes)
    place = np.arange(sizes.sum()) - np.repeat(np.cumsum(sizes) - sizes,
                                               sizes)
    bag_ids = np.empty((len(fids), sizes.sum()), np.int32)
    for lo in range(0, len(fids), CHUNK):
        first = cat[lo:lo + CHUNK][:, feature]
        r = first - base[feature]
        h = (r * HASH_ROW + place * HASH_SLOT) % M
        h = (h * LEHMER) % M
        bag_ids[lo:lo + CHUNK] = np.where(place == 0, first,
                                          base[feature] + h % rows[feature])
    numeric = (pool["vals"][:, net["n_cat"]:]
               * pool["mask"][:, net["n_cat"]:])
    return {**pool, "bag_ids": bag_ids,
            "dense": np.log1p(numeric).astype(np.float32)}


def gemm_flops(rows, cfg):
    """The step's matrix products, forward and backward: each layer's
    forward, its weight's gradient and, but for the bottom MLP's first
    layer (whose input, the numeric values, does not train), its input's
    gradient; each cross layer's two products likewise."""
    net = _net(cfg)
    total = 0
    widths = [net["n_num"], *net["bottom"], net["d"]]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        total += (2 if i == 0 else 3) * roofline.gemm_flops(rows, a, b)
    total += net["cross"] * 2 * 3 * roofline.gemm_flops(rows, net["n"],
                                                        net["rank"])
    widths = [net["n"], *net["top"], 1]
    for a, b in zip(widths, widths[1:]):
        total += 3 * roofline.gemm_flops(rows, a, b)
    return total


def dense_parameters(cfg):
    """The dense leaves' elements: the MLPs' weights and biases, the
    crosses' V, W and b."""
    net = _net(cfg)
    widths = ([net["n_num"], *net["bottom"], net["d"]],
              [net["n"], *net["top"], 1])
    mlp = sum(a * b + b for w in widths for a, b in zip(w, w[1:]))
    return mlp + net["cross"] * (2 * net["n"] * net["rank"] + net["n"])


def work(cfg, batch):
    """A step's least work: the products; the pool's sums, the crosses'
    three elementwise passes and each layer's bias and ReLU, forward and
    twice over backward; Adagrad over the dense leaves; and the rest as
    ``common.work`` counts it (the batch read once, the touched rows and
    their accumulators, the sparse path's own)."""
    net = _net(cfg)
    rows, slots = batch["bag_ids"].shape
    gemm = gemm_flops(rows, cfg)
    acts = (sum(net["bottom"]) + net["d"] + sum(net["top"]) + 1) * 2
    elementwise = 3 * rows * (slots * net["d"] + net["cross"] * 3 * net["n"]
                              + acts)
    w = common.work(cfg, {k: batch[k] for k in FIELDS}, gemm + elementwise)
    n_dense = dense_parameters(cfg)
    w["flops"] += roofline.adagrad_flops(n_dense)
    w["bytes"] += roofline.adagrad_bytes(n_dense)
    w["gemm_flops"] = gemm
    return w
