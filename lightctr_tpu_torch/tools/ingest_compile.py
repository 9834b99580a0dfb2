"""Compile a libFFM text file into the binary shard cache.

The port's copy of ``tools/ingest_compile.py``: the file goes once through
the native chunk parser into checksum-framed shard files (varint-delta
ids, fp16 values where lossless), so every later epoch, and every worker
of a fleet, replays pre-tokenized rows with no parse work
(``iter_shard_batches``, or a trainer's ``fit(<cache dir>)``).
Idempotent: a cache whose manifest matches the source and parameters is a
cache hit; ``--force`` rebuilds.  The cache is the JAX package's format:
either package reads what the other wrote.

Run:  python -m lightctr_tpu_torch.tools.ingest_compile train.ffm --max-nnz 40
      python -m lightctr_tpu_torch.tools.ingest_compile train.ffm \\
          --max-nnz 40 --feature-cnt 100000 --spec spec.json --verify
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from lightctr_tpu_torch.data import ingest


def _log(msg: str) -> None:
    print(f"[ingest_compile] {msg}", file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data", help="libFFM-format source file")
    ap.add_argument("--max-nnz", type=int, required=True,
                    help="tokens kept per row (the padded batch width "
                         "before any crosses)")
    ap.add_argument("--cache-dir", default=None,
                    help="shard directory (default: <data>.lcshards)")
    ap.add_argument("--feature-cnt", type=int, default=None,
                    help="fold feature ids modulo this (hashing trick)")
    ap.add_argument("--field-cnt", type=int, default=None,
                    help="fold field ids modulo this")
    ap.add_argument("--spec", default=None,
                    help="FeatureSpec JSON file (fold/remap/crosses)")
    ap.add_argument("--block-rows", type=int, default=4096)
    ap.add_argument("--shard-rows", type=int, default=1 << 16)
    ap.add_argument("--force", action="store_true",
                    help="rebuild even when the manifest matches")
    ap.add_argument("--verify", action="store_true",
                    help="re-read every block (checksums included) after "
                         "the compile and fail on any torn frame")
    args = ap.parse_args(argv)

    spec = None
    if args.spec:
        with open(args.spec) as f:
            spec = ingest.FeatureSpec.from_dict(json.load(f))
    t0 = time.perf_counter()
    cache = ingest.compile_shards(
        args.data, args.max_nnz, cache_dir=args.cache_dir,
        feature_cnt=args.feature_cnt, field_cnt=args.field_cnt,
        spec=spec, block_rows=args.block_rows, shard_rows=args.shard_rows,
        force=args.force)
    dt = time.perf_counter() - t0
    out = {
        "cache_dir": cache.dir,
        "rows": cache.rows,
        "width": cache.width,
        "shards": cache.n_shards,
        "bytes": sum(s["bytes"] for s in cache.manifest["shards"]),
        "compile_seconds": round(dt, 3),
    }
    if args.verify:
        t0 = time.perf_counter()
        try:
            rows = cache.verify()
        except ingest.ShardCorruption as e:
            _log(f"VERIFY FAILED: {e}")
            return 1
        out["verified_rows"] = rows
        out["verify_seconds"] = round(time.perf_counter() - t0, 3)
    _log(f"{cache.rows} rows -> {cache.n_shards} shard(s) in {dt:.3f}s")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
