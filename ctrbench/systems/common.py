"""What the system adapters share: the port's ``SparseTableCTRTrainer``
built from the configuration, and its state read back under the
reference's flat leaf names (``fc1/w``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ctrbench import roofline


def nest(flat: Dict) -> Dict:
    """``{"fc1/w": t}`` -> ``{"fc1": {"w": t}}``."""
    out: Dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten(tree, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def build_trainer(params: Dict, cfg: Dict, traffic: Dict, device,
                  logits, fused_fn=None):
    """The trainer as a user builds it: the configuration's tables listed
    as sparse, Adagrad at its rate and L2, its epsilon.  The health
    monitor is detached (``trainer.health = None``, the documented
    opt-out) unless the traffic mix keeps the trainer as constructed."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    opt = cfg["optimizer"]
    tr = SparseTableCTRTrainer(
        nest(params), logits,
        TrainConfig(learning_rate=float(opt["learning_rate"]),
                    lambda_l2=float(opt["lambda_l2"])),
        sparse_tables={k: list(t["ids"]) for k, t in cfg["tables"].items()},
        fused_fn=fused_fn, eps=float(opt["eps"]), device=device)
    if not traffic["health_feed"]:
        tr.health = None
    return tr


def parameters(trainer) -> Dict:
    return flatten(trainer.params)


def accumulators(trainer) -> Dict:
    """Adagrad's accumulators: the tables' rows, then the dense leaves'."""
    st = trainer.opt_state
    out = flatten(st["accum"])
    out.update(flatten(st["dense"].accum))
    return out


def streams(cfg: Dict, batch: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Each id stream of a batch (the tables listing one field tuple
    share it): its ids, how many distinct, and the widths it keys."""
    out: Dict[str, Dict] = {}
    for t in cfg["tables"].values():
        key = ",".join(t["ids"])
        if key not in out:
            ids = np.concatenate([batch[f].reshape(-1) for f in t["ids"]])
            out[key] = {"ids": int(ids.size),
                        "unique": int(np.unique(ids).size), "dims": []}
        out[key]["dims"].append(int(t["dim"]))
    return out


def work(cfg: Dict, batch: Dict[str, np.ndarray], flops: int) -> Dict:
    """A step's least work: ``flops`` of the model, the batch read once,
    the touched rows and accumulators, the dense leaves and theirs; and the
    sparse path's own."""
    st = streams(cfg, batch)
    dense = sum(n_in * n_out + n_out for n_in, n_out in cfg["dense_layers"])
    touched = sum(s["unique"] * d for s in st.values() for d in s["dims"])
    return {
        "flops": flops + roofline.adagrad_flops(touched + dense),
        "bytes": (roofline.batch_bytes((v.size, v.itemsize)
                                       for v in batch.values())
                  + roofline.adagrad_bytes(touched + dense)),
        "sparse_flops": roofline.sparse_path_flops(st),
        "sparse_bytes": roofline.sparse_path_bytes(st),
    }
