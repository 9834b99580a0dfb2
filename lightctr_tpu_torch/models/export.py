"""Model export/import: the reference's text formats and the compressed
serving artifacts.

The port's counterpart of ``lightctr_tpu/models/export.py``.  The text
writers and readers keep the reference's interchange layout: FM's
``model_epoch_N.txt`` with a sparse ``fid:w`` line then per-fid factor
lines (fm_algo_abst.h:109-135), and word embeddings as ``word vec...``
lines (train_embed_algo.cpp:208-230), and the GMM's per-cluster
``weight | mu... | sigma...`` lines (train_gmm_algo.cpp:153-174).

The compressed artifact is the JAX package's format, byte layout and
``__meta__`` JSON included, so an artifact written by either package loads
in the other: one npz holding every parameter leaf coded with the repo's
own codecs — int8 quantile codes (``ops/quantize.py``, the reference's
quantile_compress.h weight codec) or product-quantizer codes
(``ops/pq.py``, product_quantizer.h) for 2-D embedding-like tables — plus
a JSON meta record naming the model kind and per-leaf codec.
:func:`load_compressed_npz` decodes on the device it is given (decode is a
gather); ``serve.load_model`` builds a serving model from it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device


def save_fm_text(path: str, params: Dict) -> None:
    """FM/NFM params {'w': [F], 'v': [F, k]} -> the reference's text layout:
    line 1: sparse ``fid:w`` pairs (non-zero only, fm_algo_abst.h:118-123);
    then per-fid ``fid:v0 v1 ...`` factor lines (fm_algo_abst.h:125-133)."""
    w = _numpy(params["w"])
    v = _numpy(params["v"])
    if v.ndim != 2:
        raise ValueError("save_fm_text expects v of shape [F, k] (FM layout)")
    with open(path, "w") as f:
        f.write(" ".join(f"{fid}:{w[fid]:.6g}" for fid in np.nonzero(w)[0]))
        f.write("\n")
        for fid in range(v.shape[0]):
            f.write(f"{fid}:" + " ".join(f"{x:.6g}" for x in v[fid]) + "\n")


def load_fm_text(path: str) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`save_fm_text` (CPU tensors).  An all-zero ``w``
    leaves the first line EMPTY and trailing blank lines are padding;
    neither may produce a zero-row ``v`` or misparse a factor line as the
    weight line."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty FM text file (no weight line)")
    v_rows = []
    for lineno, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        fid_part, vec = line.split(":", 1)
        vec_vals = [float(x) for x in vec.split()]
        if int(fid_part) != len(v_rows):
            raise ValueError(
                f"{path}:{lineno}: factor line for fid {fid_part!r} out of "
                f"order (expected {len(v_rows)})"
            )
        v_rows.append(vec_vals)
    if not v_rows:
        raise ValueError(f"{path}: no factor lines (zero-row v)")
    if len({len(r) for r in v_rows}) != 1:
        raise ValueError(f"{path}: ragged factor lines")
    v = np.asarray(v_rows, np.float32)
    w = np.zeros((v.shape[0],), np.float32)
    for tok in lines[0].split():
        fid, val = tok.split(":")
        w[int(fid)] = float(val)
    return {"w": torch.from_numpy(w), "v": torch.from_numpy(v)}


def save_embeddings_text(path: str, words: List[str], emb) -> None:
    """``word v0 v1 ...`` lines (train_embed_algo.cpp:208-230)."""
    emb = _numpy(emb)
    with open(path, "w") as f:
        for word, vec in zip(words, emb):
            f.write(word + " " + " ".join(f"{x:.6g}" for x in vec) + "\n")


def load_embeddings_text(path: str) -> Tuple[List[str], np.ndarray]:
    """Reads the format above (loadPretrainFile, train_embed_algo.h:76-98)."""
    words, rows = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    return words, np.asarray(rows, np.float32)


def save_gmm_text(path: str, params) -> None:
    """Per-cluster ``weight | mu... | sigma...`` lines
    (train_gmm_algo.cpp:153-174)."""
    mu = _numpy(params.mu)
    sigma = _numpy(params.sigma)
    weight = _numpy(params.weight)
    with open(path, "w") as f:
        for k in range(mu.shape[0]):
            f.write(f"{weight[k]:.6g} | "
                    + " ".join(f"{x:.6g}" for x in mu[k]) + " | "
                    + " ".join(f"{x:.6g}" for x in sigma[k]) + "\n")


def load_gmm_text(path: str):
    """Inverse of :func:`save_gmm_text`: a ``models.gmm.GMMParams`` of CPU
    tensors."""
    from lightctr_tpu_torch.models.gmm import GMMParams

    ws, mus, sigmas = [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            w_part, mu_part, sg_part = line.split("|")
            ws.append(float(w_part))
            mus.append([float(x) for x in mu_part.split()])
            sigmas.append([float(x) for x in sg_part.split()])
    return GMMParams(mu=torch.tensor(mus, dtype=torch.float32),
                     sigma=torch.tensor(sigmas, dtype=torch.float32),
                     weight=torch.tensor(ws, dtype=torch.float32))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# compressed model export (serving artifacts, lightctr_tpu_torch/serve)

COMPRESSED_FORMAT = "lightctr-compressed"
COMPRESSED_VERSION = 1


def _flatten_params(tree, prefix="") -> Dict[str, np.ndarray]:
    """Nested dict-of-arrays -> {"a/b": array} (the npz key space)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, prefix=name + "/"))
        else:
            out[name] = _numpy(v)
    return out


def _unflatten_params(flat: Dict) -> Dict:
    out: Dict = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_compressed_npz(
    path: str,
    params: Dict,
    model: str,
    codec: str = "int8",
    bits: int = 8,
    mode: str = "uniform",
    pq_leaves: Tuple[str, ...] = (),
    pq_parts: int = 4,
    pq_clusters: int = 256,
    pq_iters: int = 10,
    fp32_leaves: Tuple[str, ...] = (),
    seed: int = 0,
    device="cuda",
) -> Dict:
    """Write a compressed serving artifact; returns the meta dict.

    ``codec``: the default leaf codec — ``"int8"`` (quantile codes through
    a per-leaf symmetric uniform/log table built from the leaf's max |x|),
    ``"fp32"`` (raw).  Leaves named in ``pq_leaves`` (flattened ``a/b``
    names) are PQ-coded instead (must be 2-D with dim divisible by
    ``pq_parts``), their codebooks trained on ``device`` from a generator
    seeded with ``seed``; leaves in ``fp32_leaves`` stay exact regardless
    of the default.  Scalar/empty leaves always fall back to fp32 (a
    quantile table over one value is noise for no byte win).  The int8
    tables and codes are built on the host, as the JAX package builds
    them eagerly, so both packages write the same codes."""
    from lightctr_tpu_torch.ops import pq as pq_mod
    from lightctr_tpu_torch.ops import quantize

    dev = resolve_device(device)
    if codec not in ("int8", "fp32"):
        raise ValueError(f"unknown default codec {codec!r}")
    flat = _flatten_params(params)
    for name in tuple(pq_leaves) + tuple(fp32_leaves):
        if name not in flat:
            raise ValueError(f"codec override names unknown leaf {name!r}")
    meta: Dict = {
        "format": COMPRESSED_FORMAT, "version": COMPRESSED_VERSION,
        "model": str(model), "leaves": {},
    }
    payload: Dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        # a writable float32 copy: torch refuses to wrap read-only arrays
        arr = np.array(arr, np.float32)
        leaf_meta: Dict = {"shape": list(arr.shape)}
        if name in pq_leaves:
            if arr.ndim != 2 or arr.shape[1] % pq_parts:
                raise ValueError(
                    f"PQ leaf {name!r} must be [N, D] with D % "
                    f"{pq_parts} == 0, got {arr.shape}"
                )
            x = torch.from_numpy(arr).to(dev)
            book = pq_mod.train(
                torch.Generator(device=dev).manual_seed(seed), x,
                part_cnt=pq_parts, cluster_cnt=pq_clusters, iters=pq_iters)
            payload[name + "__codes"] = pq_mod.encode(book, x).cpu().numpy()
            payload[name + "__centroids"] = book.centroids.to(
                torch.float32).cpu().numpy()
            leaf_meta.update(codec="pq", parts=pq_parts,
                             clusters=pq_clusters)
        elif (codec == "int8" and name not in fp32_leaves
                and arr.size > 1):
            rng = float(np.max(np.abs(arr)))
            rng = max(rng, 1e-12)
            table = quantize.build_table(-rng, rng, bits=bits, mode=mode)
            payload[name + "__codes"] = quantize.compress(
                table, torch.from_numpy(arr)).numpy()
            payload[name + "__values"] = table.values.numpy()
            leaf_meta.update(codec="int8", bits=bits, mode=mode,
                             range=rng)
        else:
            payload[name + "__raw"] = arr
            leaf_meta["codec"] = "fp32"
        meta["leaves"][name] = leaf_meta
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)
    return meta


def load_compressed_npz(path: str, device="cuda"):
    """Read a :func:`save_compressed_npz` artifact (either package's) ->
    ``(params, meta)`` with every leaf DECODED on ``device``: int8 leaves
    through the table lookup (one gather), PQ leaves through
    ``pq.decode`` (per-part gathers).  The decoded tree has the exact
    structure the model kind's ``logits`` expects."""
    from lightctr_tpu_torch.ops import pq as pq_mod

    dev = resolve_device(device)
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    if "__meta__" not in raw:
        raise ValueError(f"{path}: not a {COMPRESSED_FORMAT} artifact "
                         "(missing __meta__)")
    meta = json.loads(bytes(raw["__meta__"].tobytes()).decode())
    if meta.get("format") != COMPRESSED_FORMAT:
        raise ValueError(f"{path}: format {meta.get('format')!r} is not "
                         f"{COMPRESSED_FORMAT!r}")

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    flat: Dict = {}
    for name, leaf in meta["leaves"].items():
        shape = tuple(leaf["shape"])
        if leaf["codec"] == "fp32":
            flat[name] = put(raw[name + "__raw"])
        elif leaf["codec"] == "int8":
            codes = put(raw[name + "__codes"])
            values = put(raw[name + "__values"])
            flat[name] = values[codes.to(torch.int64)].reshape(shape)
        elif leaf["codec"] == "pq":
            book = pq_mod.PQCodebook(centroids=put(raw[name + "__centroids"]))
            flat[name] = pq_mod.decode(
                book, put(raw[name + "__codes"])).reshape(shape)
        else:
            raise ValueError(
                f"{path}: leaf {name!r} has unknown codec "
                f"{leaf['codec']!r}"
            )
    return _unflatten_params(flat), meta
