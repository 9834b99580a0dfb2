"""Dense CSV loader (MNIST-style ``label,pix,pix,...``), copied from
``lightctr_tpu/data/dense.py``.

Reference: ``dl_algo_abst.h:179-228`` loadDenseDataRow — label first, 784
features, values scaled into [0, 1] by /255 when >1 (the reference divides by
255 for image data).  The reference caps loading at 500 rows
(dl_algo_abst.h:186); we load everything unless asked otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DenseDataset:
    features: np.ndarray  # f32 [N, D]
    labels: np.ndarray    # int32 [N]

    @property
    def n_rows(self) -> int:
        return self.features.shape[0]

    def take(self, idx) -> "DenseDataset":
        return DenseDataset(self.features[idx], self.labels[idx])


def load_dense_csv(path: str, max_rows: int | None = None, scale255: bool = True) -> DenseDataset:
    raw = np.loadtxt(path, delimiter=",", dtype=np.float32, max_rows=max_rows)
    if raw.ndim == 1:
        raw = raw[None, :]
    labels = raw[:, 0].astype(np.int32)
    feats = raw[:, 1:]
    if scale255 and feats.max() > 1.0:
        feats = feats / 255.0
    return DenseDataset(features=feats.astype(np.float32), labels=labels)
