"""Synthetic libffm data — a learnable stand-in for the reference datasets.

Copied from ``lightctr_tpu/data/synth.py``.  Tools and benches must run in
any checkout: this writes a linearly-separable-with-noise libffm file
(``label field:fid:val ...``, the format of the reference's
``train_sparse.csv``) whose labels follow a ground-truth sparse logistic
model, so trainers can demonstrably converge on it (AUC >> 0.5), plus a
Criteo-shaped file and a dense CSV.

The resolvers pick an explicit path, then ``$LIGHTCTR_DATA`` /
``$LIGHTCTR_DENSE_DATA``, then a synthetic file; point the variables at
the reference datasets where they are mounted.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def resolve_libffm(path: str | None = None, workdir: str | None = None) -> str:
    """Pick the libffm input for a tool/bench: explicit ``path`` >
    ``$LIGHTCTR_DATA`` > a synthetic learnable file written to ``workdir``
    (or a tempdir)."""
    if path:
        return path
    env = os.environ.get("LIGHTCTR_DATA")
    if env:
        return env
    workdir = workdir or tempfile.mkdtemp(prefix="lightctr_synth_")
    return write_synthetic_libffm(
        os.path.join(workdir, "synthetic_train.libffm")
    )


def resolve_dense_csv(path: str | None = None,
                      workdir: str | None = None) -> str:
    """Dense (MNIST-style) counterpart of :func:`resolve_libffm`:
    explicit > ``$LIGHTCTR_DENSE_DATA`` > synthetic."""
    if path:
        return path
    env = os.environ.get("LIGHTCTR_DENSE_DATA")
    if env:
        return env
    workdir = workdir or tempfile.mkdtemp(prefix="lightctr_synth_")
    return write_synthetic_dense_csv(
        os.path.join(workdir, "synthetic_train_dense.csv")
    )


def write_criteo_proxy(
    path: str,
    rows: int,
    seed: int = 0,
    n_fields: int = 39,
    n_cat: int = 26,
    vocab: int = 1 << 20,
) -> str:
    """Write a Criteo-shaped libFFM file: 39 one-feature-per-field slots
    (26 categorical + 13 numeric — the Criteo-Kaggle layout).  Categorical
    fields draw skewed ids (popularity ~ u^4 — a frequent head, a huge
    tail, like real Criteo); numeric fields use one fixed id per field with
    the measurement as the value (the bucketless form).  Labels follow a
    logistic in two numeric fields plus a head-id effect, so one training
    pass can provably recover signal through both the wide and the
    embedding path."""
    rng = np.random.default_rng(seed)
    chunk = 20_000
    numeric_ids = np.arange(n_cat, n_fields, dtype=np.int64)
    with open(path, "w") as f:
        done = 0
        while done < rows:
            n = min(chunk, rows - done)
            u = rng.random(size=(n, n_fields))
            fids = (u ** 4 * vocab).astype(np.int64)
            fids[:, n_cat:] = numeric_ids[None, :]
            vals = np.ones((n, n_fields), np.float32)
            vals[:, n_cat:] = rng.exponential(
                1.0, size=(n, n_fields - n_cat)
            ).astype(np.float32).round(3)
            z = (
                (vals[:, n_cat] - 1.0)
                + (vals[:, n_cat + 1] - 1.0)
                + (fids[:, 0] % 2).astype(np.float32)
                - 0.5
            )
            p = 1.0 / (1.0 + np.exp(-2.0 * z))
            labels = (rng.random(n) < p).astype(np.int32)
            lines = []
            for i in range(n):
                feats = " ".join(
                    f"{j}:{fids[i, j]}:{vals[i, j]:g}"
                    for j in range(n_fields)
                )
                lines.append(f"{labels[i]} {feats}\n")
            f.writelines(lines)
            done += n
    return path


def write_synthetic_dense_csv(
    path: str,
    n_rows: int = 500,
    n_features: int = 784,
    n_classes: int = 10,
    seed: int = 0,
    noise: float = 0.15,
) -> str:
    """Write a learnable ``label,pix,...`` CSV (the reference's image
    format, dl_algo_abst.h:179-228): each class is a fixed random template
    in [0, 1] plus noise, so classifiers separate them quickly."""
    rng = np.random.default_rng(seed)
    templates = rng.random((n_classes, n_features)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_rows)
    feats = np.clip(
        templates[labels] + noise * rng.standard_normal(
            (n_rows, n_features)
        ).astype(np.float32),
        0.0, 1.0,
    )
    with open(path, "w") as f:
        for i in range(n_rows):
            f.write(str(int(labels[i])) + ","
                    + ",".join(f"{x:.4f}" for x in feats[i]) + "\n")
    return path


def write_synthetic_libffm(
    path: str,
    n_rows: int = 2000,
    n_fields: int = 10,
    vocab: int = 8192,
    seed: int = 0,
    noise: float = 0.25,
) -> str:
    """Write a learnable libffm file and return ``path``.

    Each row has one active feature per field (the CTR shape); labels are
    Bernoulli(sigmoid(sum of ground-truth feature weights + noise)).
    """
    rng = np.random.default_rng(seed)
    truth = rng.standard_normal(vocab).astype(np.float32)
    fids = rng.integers(0, vocab, size=(n_rows, n_fields))
    logits = truth[fids].sum(axis=1) * (3.0 / np.sqrt(n_fields))
    logits += noise * rng.standard_normal(n_rows)
    labels = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(int)
    with open(path, "w") as f:
        for i in range(n_rows):
            feats = " ".join(
                f"{fld}:{int(fid)}:1" for fld, fid in enumerate(fids[i])
            )
            f.write(f"{labels[i]} {feats}\n")
    return path
