"""Precision policy, with torch dtypes.

The port's counterpart of ``lightctr_tpu/core/precision.py``.  The
reference compresses every wire value to software fp16
(``common/float16.h:98-154``) and computes in fp32; the policy is:

  params   fp32   (master copies)
  compute  bf16 or fp32 (matmul inputs; tensor cores accumulate fp32)
  wire     bf16   (collectives — stands in for the fp16 wire codec)

``Policy.cast_compute`` is applied at module boundaries; optimizers always
run in fp32 on the param dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from lightctr_tpu_torch.optim.updaters import tree_map


def _cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if torch.is_floating_point(x)
                    else x, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    wire_dtype: torch.dtype = torch.bfloat16

    def cast_compute(self, tree):
        return _cast(tree, self.compute_dtype)

    def cast_wire(self, tree):
        return _cast(tree, self.wire_dtype)

    def cast_param(self, tree):
        return _cast(tree, self.param_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)


def policy_for(compute_dtype: str) -> Policy:
    return BF16_POLICY if compute_dtype == "bfloat16" else DEFAULT_POLICY
