"""The roofline arithmetic: the FLOP and byte counts of each cell's
shapes, and which bound binds."""

import numpy as np
import pytest

from ctrbench import roofline
from ctrbench.systems import common as sys_common

B, P, K, H = 65536, 39, 32, 1024
#: fm-criteo's latent dimension
KF = 10


def test_peaks_are_the_data_sheets():
    assert roofline.PEAKS == {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12,
                              "bf16_flops_per_s": 989e12}


def test_widedeep_counts_its_three_gemms():
    layers = [[P * K, H], [H, 1]]
    got = roofline.widedeep_flops(B, P, P, K, layers)
    gemm = 3 * 2 * B * (P * K) * H          # forward, dX, dW of fc1
    assert gemm == 502_511_173_632
    assert gemm < got < 1.01 * gemm          # the rest is elementwise


def test_fm_flops_at_the_cells_shape():
    per_row = 3 * P + 4 * P * KF + 2 * KF + 3 * P * (KF + 1)
    assert roofline.fm_flops(B, P, KF) == 3 * B * per_row
    assert roofline.fm_flops(B, P, KF) == 586_678_272


def test_sparse_path_bytes_by_hand():
    streams = {"fids": {"ids": 10, "unique": 4, "dims": [1, 32]}}
    want = 4 * 10 + (4 * 10 * 1 + 16 * 4 * 1) + (4 * 10 * 32 + 16 * 4 * 32)
    assert roofline.sparse_path_bytes(streams) == want


def test_least_time_names_its_bound():
    t = roofline.least_time(67e12, 3.35e12 / 2)
    assert t["seconds"] == pytest.approx(1.0) and t["bound"] == "operations"
    t = roofline.least_time(1.0, 3.35e12)
    assert t["seconds"] == pytest.approx(1.0) and t["bound"] == "bytes"


@pytest.mark.parametrize("model,tables,dense", [
    ("fm", {"w": {"dim": 1, "ids": ["fids"]},
            "v": {"dim": K, "ids": ["fids"]}}, []),
    ("widedeep", {"w": {"dim": 1, "ids": ["fids"]},
                  "embed": {"dim": K, "ids": ["rep_fids"]}},
     [[P * K, H], [H, 1]]),
])
def test_step_work_counts_each_stream_once(model, tables, dense):
    rng = np.random.default_rng(0)
    fids = rng.integers(0, 1000, (64, P)).astype(np.int32)
    batch = {"fids": fids, "vals": np.ones((64, P), np.float32),
             "mask": np.ones((64, P), np.float32),
             "labels": np.zeros(64, np.float32)}
    if model == "widedeep":
        batch["rep_fids"] = fids.copy()
        batch["rep_mask"] = np.ones((64, P), np.float32)
    cfg = {"tables": tables, "dense_layers": dense}
    st = sys_common.streams(cfg, batch)
    u = np.unique(fids).size
    assert all(s["unique"] == u and s["ids"] == 64 * P for s in st.values())
    assert len(st) == (1 if model == "fm" else 2)
    w = sys_common.work(cfg, batch, flops=0)
    n_dense = sum(a * b + b for a, b in dense)
    batch_bytes = sum(v.nbytes for v in batch.values())
    assert w["bytes"] == batch_bytes + 16 * (u * (1 + K) + n_dense)
    assert w["sparse_bytes"] == roofline.sparse_path_bytes(st)
