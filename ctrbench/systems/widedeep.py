"""The system under test for Wide&Deep configurations:
``lightctr_tpu_torch``'s ``SparseTableCTRTrainer`` over
``models.widedeep.logits`` (the wide table over ``fids``, the embedding
over each field's representative ``rep_fids``, ``nn.dense`` on cuBLAS)."""

import numpy as np

from ctrbench import roofline
from ctrbench.systems import common

parameters = common.parameters
accumulators = common.accumulators


def build(params, cfg, traffic, device):
    from lightctr_tpu_torch.models import widedeep

    return common.build_trainer(params, cfg, traffic, device,
                                widedeep.logits)


def prepare(pool, cfg):
    """The rows with each field's representative id and its presence
    (``widedeep.field_representatives``, the user's data preparation; at
    this layout slot j belongs to field j)."""
    from lightctr_tpu_torch.models.widedeep import field_representatives

    n, slots = pool["fids"].shape
    n_fields = int(cfg["layout"]["fields"])
    fields = np.broadcast_to(
        (np.arange(slots) % n_fields).astype(np.int32), (n, slots))
    rep, rep_mask = field_representatives(pool["fids"], fields,
                                          pool["mask"], n_fields)
    return {**pool, "rep_fids": rep, "rep_mask": rep_mask}


def work(cfg, batch):
    rows, slots = batch["fids"].shape
    flops = roofline.widedeep_flops(rows, slots,
                                    int(cfg["layout"]["fields"]),
                                    int(cfg["factor_dim"]),
                                    cfg["dense_layers"])
    return common.work(cfg, batch, flops)
