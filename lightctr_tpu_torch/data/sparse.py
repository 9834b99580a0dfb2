"""libFFM-format sparse dataset loader, copied from
``lightctr_tpu/data/sparse.py``; the fast path parses through the port's
own copy of the native parser (``lightctr_tpu_torch/native``).

Parses the reference's input format ``label field:fid:val ...``
(``fm_algo_abst.h:70-107`` loadDataRow) into fixed-shape padded arrays — the
TPU-friendly layout: XLA needs static shapes, so rows are padded to the
dataset's max nnz (or a caller-supplied cap) with an explicit validity mask
instead of C++ ragged vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def parse_libffm_line(line: str, path: str = "<str>", lineno: int = 0):
    """One ``label field:fid:val ...`` row -> (label, [(field, fid, val)]),
    or None for blank lines.  THE row parser: the eager Python fallback and
    the streaming reader both use it, so format semantics cannot drift
    (the native C++ parser is oracle-tested against it)."""
    parts = line.split()
    if not parts:
        return None
    label = float(parts[0])
    row = []
    for tok in parts[1:]:
        pieces = tok.split(":")
        if len(pieces) != 3:
            raise ValueError(
                f"{path}:{lineno}: bad libFFM token {tok!r} "
                "(expected field:fid:val)"
            )
        row.append((int(pieces[0]), int(pieces[1]), float(pieces[2])))
    return label, row


@dataclasses.dataclass
class SparseDataset:
    """Padded CSR-like batch layout.

    fids   int32 [N, P]  feature ids (0 where padded)
    fields int32 [N, P]  field ids   (0 where padded)
    vals   f32   [N, P]  feature values (0 where padded — padding therefore
                         contributes nothing to any weighted sum)
    mask   f32   [N, P]  1.0 on real entries
    labels f32   [N]
    """

    fids: np.ndarray
    fields: np.ndarray
    vals: np.ndarray
    mask: np.ndarray
    labels: np.ndarray
    feature_cnt: int
    field_cnt: int

    @property
    def n_rows(self) -> int:
        return self.fids.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.fids.shape[1]

    def batch_dict(self):
        return {
            "fids": self.fids,
            "fields": self.fields,
            "vals": self.vals,
            "mask": self.mask,
            "labels": self.labels,
        }

    def take(self, idx) -> "SparseDataset":
        return SparseDataset(
            fids=self.fids[idx],
            fields=self.fields[idx],
            vals=self.vals[idx],
            mask=self.mask[idx],
            labels=self.labels[idx],
            feature_cnt=self.feature_cnt,
            field_cnt=self.field_cnt,
        )

    def compact(self) -> tuple:
        """Remap feature ids to a dense [0, n_unique) vocabulary.

        The reference's sparse updaters never pay for untouched rows
        (``g == 0`` skip, gradientUpdater.h:143); dense JAX tables do — so
        compaction (table rows = features actually present) is the parity
        move for single-dataset training.  Returns (dataset, mapping) where
        ``mapping[new_id] = original_fid`` for translating back."""
        if self.fids.size == 0:
            return self, np.zeros((0,), np.int32)
        uniq = np.unique(self.fids[self.mask > 0])
        remap = np.zeros(max(self.feature_cnt, int(self.fids.max()) + 1), np.int32)
        remap[uniq] = np.arange(len(uniq), dtype=np.int32)
        return (
            SparseDataset(
                fids=remap[self.fids],
                fields=self.fields,
                vals=self.vals,
                mask=self.mask,
                labels=self.labels,
                feature_cnt=len(uniq),
                field_cnt=self.field_cnt,
            ),
            uniq,
        )

    def pad_rows(self, multiple: int) -> "SparseDataset":
        """Pad row count to a multiple (for even device sharding); padded rows
        have zero mask and label 0 and must be excluded from metrics."""
        n = self.n_rows
        target = ((n + multiple - 1) // multiple) * multiple
        if target == n:
            return self
        extra = target - n
        pad = lambda a: np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])  # noqa: E731
        return SparseDataset(
            fids=pad(self.fids),
            fields=pad(self.fields),
            vals=pad(self.vals),
            mask=pad(self.mask),
            labels=pad(self.labels),
            feature_cnt=self.feature_cnt,
            field_cnt=self.field_cnt,
        )


def load_libffm(
    path: str,
    max_nnz: int | None = None,
    feature_cnt: int | None = None,
    field_cnt: int | None = None,
) -> SparseDataset:
    """Parse ``label field:fid:val`` lines (fm_algo_abst.h:70-107).

    Like the reference, feature/field counts are discovered from the data
    (max id + 1) unless given explicitly.  When ``feature_cnt``/``field_cnt``
    ARE given (e.g. loading a test set against a train vocabulary), ids are
    folded into range with the standard hashing trick ``id % cnt`` — the
    reference has no answer here (an unseen test fid indexes out of bounds in
    its train-sized ``W`` array; jnp.take would fill NaN), so we define one.
    """
    # fast path: the native C++ parser (lightctr_tpu_torch/native/libffm_parser.cpp),
    # ~10x faster and byte-identical to the Python fallback below
    try:
        from lightctr_tpu_torch import native

        if native.available():
            fields, fids, vals, mask, labels_arr = native.parse_libffm_native(path)
            if max_nnz is not None and fields.shape[1] > max_nnz:
                fields, fids = fields[:, :max_nnz], fids[:, :max_nnz]
                vals, mask = vals[:, :max_nnz], mask[:, :max_nnz]
            if feature_cnt is not None:
                fids = (fids % feature_cnt).astype(np.int32)
            if field_cnt is not None:
                fields = (fields % field_cnt).astype(np.int32)
            return SparseDataset(
                fids=fids,
                fields=fields,
                vals=vals,
                mask=mask,
                labels=labels_arr,
                feature_cnt=feature_cnt
                if feature_cnt is not None
                else (int(fids.max()) + 1 if fids.size else 0),
                field_cnt=field_cnt
                if field_cnt is not None
                else (int(fields.max()) + 1 if fields.size else 0),
            )
    except (RuntimeError, ImportError):
        pass  # fall back to the pure-Python parser

    rows = []
    labels = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parsed = parse_libffm_line(line, path, lineno)
            if parsed is None:
                continue
            label, row = parsed
            labels.append(label)
            rows.append(row)

    n = len(rows)
    nnz = max((len(r) for r in rows), default=0)
    if max_nnz is not None:
        nnz = min(nnz, max_nnz)

    fids = np.zeros((n, nnz), np.int32)
    fields = np.zeros((n, nnz), np.int32)
    vals = np.zeros((n, nnz), np.float32)
    mask = np.zeros((n, nnz), np.float32)
    for i, row in enumerate(rows):
        row = row[:nnz]
        for j, (field, fid, val) in enumerate(row):
            fields[i, j] = field
            fids[i, j] = fid
            vals[i, j] = val
            mask[i, j] = 1.0

    if feature_cnt is not None:
        fids = (fids % feature_cnt).astype(np.int32)
    if field_cnt is not None:
        fields = (fields % field_cnt).astype(np.int32)
    return SparseDataset(
        fids=fids,
        fields=fields,
        vals=vals,
        mask=mask,
        labels=np.asarray(labels, np.float32),
        feature_cnt=feature_cnt if feature_cnt is not None else (int(fids.max()) + 1 if fids.size else 0),
        field_cnt=field_cnt if field_cnt is not None else (int(fields.max()) + 1 if fields.size else 0),
    )
