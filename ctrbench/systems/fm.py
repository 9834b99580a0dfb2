"""The system under test for FM configurations: ``lightctr_tpu_torch``'s
``SparseTableCTRTrainer`` over ``models.fm.logits`` and
``fm.logits_with_l2`` (the forward and the touched rows' L2 from one set
of gathers)."""

from ctrbench import roofline
from ctrbench.systems import common

parameters = common.parameters
accumulators = common.accumulators


def build(params, cfg, traffic, device):
    from lightctr_tpu_torch.models import fm

    return common.build_trainer(params, cfg, traffic, device, fm.logits,
                                fused_fn=fm.logits_with_l2)


def prepare(pool, cfg):
    """FM reads the rows as made: ``fids``, ``vals``, ``mask``, ``labels``."""
    return pool


def work(cfg, batch):
    rows, slots = batch["fids"].shape
    return common.work(cfg, batch,
                       roofline.fm_flops(rows, slots, int(cfg["factor_dim"])))
