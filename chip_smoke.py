#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lightctr_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``lightctr_tpu_torch/csrc``,
holds each against its plain PyTorch version, serves FM at Criteo width
through the PS-backed ``PredictionServer`` and checks the scores, trains FM
at Criteo width with ``SparseTableCTRTrainer`` and
``CTRTrainer(fused_adagrad=True)``, then trains it data-parallel over two
ranks on the one card (the allgather exchange) and over eight (the
reduce-scatter exchange), and over two hosts of two ranks each through the
two-level exchange's reduce shards, and checks the training; runs the
elastic master over tiered PS shards on the card through a shard's
SIGKILL; trains it from a libFFM
file through the streaming reader and the prefetch stage, and under the
ftrl and adam optimizers; serves the Wide&Deep family (Wide&Deep, DeepFM,
DCN) at Criteo width from compressed artifacts through the same PS-backed
server, and trains DeepFM and DCN on the card, then over two ranks with
both trainers; runs the port's CLI (the CTR half, ``deepfm --dp`` under
``torch.distributed.run``, then the DL zoo, GBM and its stack, GMM, PLSA
and word2vec); runs the zoo's last four modules (top-k and the ANN index,
PCA, ensembling, the DAG builder); runs the long-context attention path
(flash attention on one card, ring attention over two ranks) and the
port's two kernel benches.  The ingest phase also compiles its file into
the shard cache and trains from the replay, with and without the quality
sketch armed, and the serve phase checks the server's drift hook.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  build    nvcc of every kernel source, nine (all started together),
           beside the g++ build of the native host codecs; seconds and
           ptxas summary.
  kernels  every kernel against its plain version on the card:
           gather_rows bit-exact (``torch.equal``) over d in {1, 33, 128}
           x n in {1, 1000, 16384} and the serve path's own shape,
           R = 65536, int64 ids at d 33, and the hot-row shape (R = 2^20,
           d 32, n = 159,744), with negative and >= R indices that
           exercise the clip, and at the tiered store's pair (R = 2^16,
           d 33, n = 8 ... 2^17 in pow2 steps of 4); dedup_ids bit-exact (uids, inv, count) at K in {1, 1000,
           159744} on Criteo id streams, negative ids and int32's limits,
           all-equal and all-zero streams, ids that differ only in the
           lowest digit or only in the sign bit, and with size < count, and
           on int64 streams across int64's range and ids that differ only
           above bit 40; merge_apply within 2 ulp
           (table, accum) and rtol 1e-5 (sumsq) at V = 2^20, d in {1, 32},
           S = 159744, uids of a real dedup with and without id 0, denom in
           {1, 4}, and in merge mode on 159,744 gathered rows, raw and as
           the dp path gathers them with the coded runs' non-zero padding
           rows (one launch of its fused ``merge`` design, none of
           merge_rows); merge_rows bit-exact at 159,744 rows, d in {1,
           32}, with heavy duplicates and out-of-range segments, with
           segments whose rows are all +-0, and at nseg = 2^24 + 77 (all
           four radix digits move); quantize_pack bit-exact on the
           [79872, 32] payload at 1, 4, 8 (uniform, normal, fixed and
           measured range) and 16 bits with +-inf and NaN, one float past
           16 bytes (n = 3 mod 4) at 8 and 16 bits, and at 16 bits on
           every boundary and one ulp either side, each launch through the
           design its width names (``tree`` up to 8 bits, ``split``
           above); quantize_pack_ef_update
           bit-exact (codes, dec, residual) on a real dedup's uids with id 0
           at 8 and 16 bits, through the design its width names;
           fused_adagrad within 2 ulp at N in {1, 1001,
           2^20, 2^25} and at a misaligned start; quantize_pack_ef
           bit-exact (codes, delta) on the [79872, 32] payload at 8 and 16
           bits with +-inf and NaN, masked and unmasked rows, a [P, 1], a
           [P, d] and a scalar mask, through the design its width names;
           flash_attention at the bench's causal bf16 shapes
           (4, 1024, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 64), at bf16
           heads of 128, 256 and 320 causal and not, and at B*H = 65,600
           (max abs error <= 2e-2, mean <= 2e-3), at (2, 256, 4, 32) and the
           graft entry's (2, 32, 2, 8) in fp32, causal and not (rtol 2e-4,
           atol 2e-5); each case through the design ``flash_route`` names;
           and the dp_rs path's kernels at its shapes: dedup_ids on owner
           0's 25,960 bucket ids cut at 8,193, merge_rows of those rows
           into 8,193 segments (zero and coded padding), quantize_pack on
           the [8, 3245, 32] buckets, quantize_pack_ef_update of one
           rank's [19,968, 32] rows into a [65,536, 32] carry (all
           bit-exact), merge_apply's apply mode on the 65,544 gathered
           shard slots with their non-zero id-0 pads (2 ulp); and
           merge_rows at the zoo's shapes, bit-exact: GBM's root
           histogram (10,000 x 784 slots at d 1 into 784 x 33 segments)
           and word2vec's context gather backward (256 x 12 slots at d
           100 into 5,000 rows); and at the quality sketch's shape (4,096
           stacked [1, label, p, logloss] rows, d 4, into 512 buckets),
           bit-exact, ``obs.quality.quality_sketch`` equal to it.
  serve    FM, 39 fields (26 categorical + 13 numeric), vocabulary 2^20,
           factor dim 32: a port ``AsyncParamServer`` (rows ``[w | v]`` of
           width 33) behind ``ParamServerService``, a ``PredictionServer``
           on the card with its default 65536-row cache, 8 requests of 256
           rows sent twice through ``PredictClient``.  Every reply must be
           OK, scores within 2e-3 of a float64 numpy FM forward (the wire
           carries rows, values and scores in fp16), the cache block a
           CUDA tensor, hits > 0 on the second pass, and ``gather_rows``
           launched at least once per scored micro-batch.  Then, its launch
           counts read: a second FM server over the same PS with
           ``drift=DriftMonitor(...)`` (16 score bins, 64 coverage
           buckets, 2,048-row windows): the first pass freezes the
           reference, the second (the same traffic) scores below
           ``DriftDetector``'s degraded band, and two passes whose
           categorical ids collapse onto 4 trip it: ``/healthz`` (an
           ``OpsServer`` on localhost) answers 503 naming the server.

  train    FM at Criteo width on synthetic Criteo batches made in memory
           (data/synth.py's recipe: u^4 head/tail ids, exponential numeric
           values, a planted logistic label), batch 4096, lr 0.05,
           lambda_l2 0.001, ``fm.logits_with_l2``.  (a) 50 steps of
           ``SparseTableCTRTrainer`` (204,800 rows): dedup_ids launched
           once a step, merge_rows (the backward of the gathers,
           ``embed.table.lookup``) and merge_apply twice, the last 5
           losses below the first 5, held-out AUC > 0.55 on 20,480 rows;
           (b) 10 steps of ``CTRTrainer(fused_adagrad=True)``:
           fused_adagrad and merge_rows (into the whole 2^20-row tables)
           launched twice a step, the loss falling; (c) the first 3
           sparse and 2 fused
           steps re-run on the CPU with the plain versions (losses rtol
           1e-4, touched rows rtol 1e-4 / atol 1e-5), and the two trainers
           on the card agreeing after 10 steps from one init.  Launch
           counts are reset just before (a) and (b) and read just after.
           Steady-state examples/s (after 3 warm-up steps, synchronised)
           and a profiler window of the sparse step's device time.  (d)
           (a) and (b) again with ``resources=True,
           device_telemetry=True``: losses and tables bit for bit the
           unarmed runs', the same launches, the armed-minus-unarmed step
           ms; the compile tracker one signature and no
           ``recompile_storm``; the catalog's ``trainer_step`` FLOPs,
           bytes, memory and utilization against ``peak_spec`` of the
           card (FP32 peak); the census' ``trainer_state`` bytes exactly
           the params' and optimizer state's; on (a)'s trainer a census
           budget below ``trainer_state`` trips ``hbm_pressure`` on
           ``/healthz`` (503) and one above recovers it; ``POST
           /profilez`` refused (409) while another torch.profiler session
           runs, then ``?steps=3`` lands a trace holding the port's
           kernels; ``verify_donation`` on B5's in-place apply clean, a
           copying control tripping ``donation_miss``.
  dp       the same model, data and global batch trained by
           ``SparseTableCTRTrainer(mesh=...)`` over 2 ranks, spawned
           processes sharing the card over gloo (2048 rows, 79,872 ids a
           rank), through the hybrid sparse exchange: (a) exact, 50 steps,
           held-out AUC > 0.55; (b) 8 bits with a measured range, 10 steps;
           (c) 8 bits with its defaults (range 1.0, error feedback), 10
           steps.  Per rank and step: dedup_ids, merge_rows (the gathers'
           backward) and merge_apply launched twice each (every
           merge_apply launch its fused merge mode), quantize_pack twice
           in (b) (each its
           ``tree`` design), quantize_pack_ef_update twice in (c) (each
           its ``tree`` design; counts reset in each rank just before its
           steps).  Both ranks end bit-identical; the loss
           falls in every run; (b) ends within 0.05 of (a) at the same
           step.  The same runs on the CPU with the plain versions (the
           first 2 steps of (a), all of (b) and (c)): losses within rtol
           1e-4 ((a)) or 1e-3 ((b), (c)), the rows the first 2 batches
           touched within rtol 1e-4 / atol 1e-5 (a code flip may move a
           few of them in (b) and (c)).  One step of (c) at W = 1 over
           NCCL.  Steady-state examples/s of (a) with the health feed off,
           set by gloo's host staging, and rank 0's device time over 5
           more steps (torch.profiler) for the card's idle share.
  dp_rs    the same model at vocabulary 2^16 (docs/SPARSE_EXCHANGE.md's
           middle band), global batch 4096, over 8 gloo ranks on the card
           (512 rows, 19,968 ids a rank), where the pick sends v over the
           reduce-scatter exchange (bucket 3,245, shard 8,193) and w over
           the dense one: (a) exact, 20 steps; (b) 8 bits, measured
           range, 10; (c) 8 bits with its defaults (range 1.0, EF), 10;
           (d) 3 steps of a batch whose ids are all multiples of 8, which
           the host check refuses, so each runs the allgather fallback.
           Per rank and run the launches equal the plan's
           (``rs_expected_launches``: merge_rows for the gathers' backward
           and the owner merge, merge_apply's apply mode, its merge mode
           in (d), quantize_pack and quantize_pack_ef_update through
           ``tree``); every rank ends bit-identical; the overflow slot is
           0 and ``trainer_sparse_rs_bytes_total`` is sparse_rs_bytes
           times the steps in (a)-(c), ``trainer_rs_fallback_total`` 3 in
           (d); the loss falls in (a) and (b); the first 2 steps of (a)
           and all of (c) re-run at W = 8 on the CPU with the plain
           versions within the dp phase's bounds, and all of (b) beside
           them, reported: its measured ranges follow the last ulp of
           gradients that the card's forward reduces in another order
           than the CPU's (``b_first_step_card_vs_cpu`` counts the
           logits, loss and gradient values of (b)'s first step that part,
           rank 0's rows), and its shard encode meets boundaries; the
           line prints (b)'s gap beside the JAX package's own gap under a
           reorder of FM's sums (``JAX_REORDER_GAP``, a CPU test's
           measurement): the same order, so it is the coded exchange's
           conditioning, not a fault of the port.  (b)'s
           gate is one of its steps run twice from the same state on the
           card: every rank's tables and accumulators bit-identical across
           the two runs (the gathers' backward sums in slot order).
           (b)'s and (c)'s exchanges on equal
           inputs at the path's shapes (``sparse_reduce_scatter``, 8-bit
           measured range; fixed range with the stage-1 carry): rank 0's
           outputs on the card equal the CPU world's bit for bit.
           ``sparse_reduce_scatter`` at the JAX
           bench's rs-grid cells (vocab 2048, dim 16, densities 0.25 and
           0.5): exact against a float64 oracle, and with both EF carries
           conserving the mass, overflow 0.  Step times, examples/s of
           (a), the capacity check's host time, rank 0's device time and
           idle share over 5 profiled steps.

  ingest   FM at Criteo width trained from a libFFM file that
           ``data.synth.write_criteo_proxy`` writes (204,800 rows, and a
           20,480-row held-out file of another seed), read by
           ``data.streaming.iter_libffm_batches`` with the native parser:
           (a) ``SparseTableCTRTrainer.fit_stream(..., prefetch=2)``, 50
           steps, then the same file without prefetch: the two loss lists
           and tables bit-identical, each run's launches the plan's
           (dedup_ids once a step, merge_rows and merge_apply twice), the
           loss falling, held-out AUC > 0.55; examples/s of both, the
           ``ingest_overlap_ratio`` gauge and the host parse time a
           batch; (b) ``CTRTrainer`` under ``optim.get("ftrl")`` and
           ``("adam")``, 10 steps each on the file's first batches:
           merge_rows launched twice a step and nothing else, the loss
           falling, the first 2 steps re-run on the CPU (losses rtol 1e-4,
           the whole tables rtol 1e-4 / atol 1e-5); (c) the dp_rs phase's
           repeated step, bit-identical; (d) the file compiled once by
           ``data.ingest.compile_shards`` (seconds, shard bytes against
           the file's; a second compile a cache hit), then replayed
           through ``fit_stream(iter_shard_batches(cache, 4096),
           prefetch=2)`` from (a)'s init: losses and tables bit for bit
           (a)'s live-parse run, launches the plan's; ``fit(<cache dir>,
           epochs=1, batch_size=4096)`` bit for bit ``fit(<its rows as
           arrays>)``; the replay's decode ms a batch beside the parse's,
           examples/s with and without the cache; (e) (d)'s replay with
           ``quality_bins=512``, twice: losses and tables (d)'s, one more
           merge_rows launch a step (the sketch), the tracker's totals,
           window AUC, calibration ratio and logloss, the two runs'
           sketches bit-identical, armed against unarmed step ms and the
           device's idle share over 5 profiled armed steps.
  online   online learning on the card against a live PS (the
           reference's never-stopping PS worker: pull, grad, push): FM at
           the serve phase's width, the 2^20 x 33 table preloaded into a
           ``ParamServerService`` (its write log sized for 16 steps'
           ids); ``online.OnlineTrainer`` on the card over
           ``iter_libffm_batches(loop=True)`` of the ingest phase's file
           with ``prefetch=2``, 20 steps of 4,096 rows (10 while a
           ``PredictionServer`` with its 65,536-row hot cache on the card
           and a ``FreshnessSubscriber`` answer the serve phase's 8 x 256
           rows from the same live rows, 7 after a hold, 3 profiled).
           Held: the served scores equal a float64 forward of rows pulled
           straight off the PS within 2e-3 (check 1), the freshness age
           (SLO 2 s) trips ``freshness_slo`` on ``/healthz`` and resumed
           training recovers it (check 2).  Then ``OnlineTrainer``
           Wide&Deep at serve_deep's width (hidden 50), 10 steps, fp32
           exports every 5: the shadow gate (``ModelSwapper``) swaps the
           faithful artifact in and refuses a corrupted one (check 3).
           Counts reset just before the path: merge_rows twice a step
           (the lookups' backward), gather_rows at least once a scored
           micro-batch, nothing else; every delta per key (no full cache
           drop); the first 3 FM steps re-run on the CPU port against a
           second PS preloaded with the same rows (losses rtol 1e-4).  ms
           a step split into pull, step and push, and the device's idle
           share over the 3 profiled steps.
  tiered   the tiered embedding store on the card (hot pair [2^16, 33]
           on the card, warm the native shm segment, cold the mmap log
           under a temp dir; the serve table preloaded, 1/16 residency):
           (a) 20 pull/push cycles of 159,744 bounded-zipf (s 1.1) ids
           toward a seeded target against a ``device_hot=False`` twin,
           pulled blocks and the final state within rtol 1e-5 / atol
           1e-7 (elements differing and the largest ulp reported), bit
           for bit on a 5-cycle leg at 1,024 ids; faults from both tiers,
           demotions, peak hot rows within the budget; pull and push ms,
           the hot hit rate, the fault-overlap ratio; (b1) FM on
           ``models.sparse_trainer.TieredDeviceEmbedding`` all-hot (a
           2^16-key working set in 2^17 hot rows), 10 steps of 4,096
           rows, the gradient taken on the per-position rows: bit for bit
           B5 on a dense [2^20, 33] table given the same uids, rows and
           inv; the first 2 steps through the plain version on the card
           (MAX_ULP) and on the CPU port (CPU_APPLY_ULP, ulps of the
           apply's largest operand); (b2) FM at 1/16 residency over the
           full zipf stream with ``prefetch_next``, a stale ticket
           refused; ms a step for gather, compute and apply, the device's
           idle share; (c) the online phase's FM run against a
           ``ParamServerService`` over a tiered store on the card, its
           server's cache warmed from the store's ledger: served scores
           within 2e-3 of a float64 forward of the shard's rows, the
           subscriber in ``subscribe`` mode, the push echo staging rows,
           the first 3 losses the online phase's (rtol 1e-4); pull, step
           and push ms beside the online phase's.  Counts reset before
           each part, held to ``tiered_expected_launches``.
  cluster  multi-host training.  (a) FM at Criteo width (the train
           phase's init, lr 0.05) on one 4,096-row batch split between 2
           hosts, each host a world of 2 gloo ranks on the card spawned
           in a thread of this process, through 2 ``SparseReduceShard``s
           this process serves (``hier_exchange=``, the fp32 wire), 10
           steps: every rank of both hosts bit-identical, the losses and
           tables within rtol 1e-4 / atol 1e-6 and 1e-5 of the one-device
           trainer on the whole batch, the policy ``hier`` for w and v,
           the launches ``hier_expected_launches`` on every rank, only
           local rank 0 of a host on the wire; both links probed
           (``measure_ici_bw``, ``probe_bw``, ``link_bandwidth``'s source
           ``probe``); ms a step as local merge / wire / apply, and rank
           0's device idle share over 2 profiled steps.  (a3) from (a)'s
           state, 5 steps on the q8_ef wire within atol 2e-3 of 5 more on
           the fp32 wire, under 0.4 of its socket bytes a step, every
           rank alike; (a4) 3 steps with host 1 0.5 s late in the last,
           a ``MasterService`` scraping that run's reduce shards:
           ``/stragglerz`` on an ``OpsServer`` ranks host "1" first; (a2)
           one rank a host, 3 steps: the socket bytes a step within 10 %
           of (a)'s.  (b) an elastic ``MasterService`` over 3 PS-shard
           processes (spawn; started before (a)), each a tiered store on
           the card (hot pair 2^16 rows, adagrad, lr 0.5) holding its ring
           share of a 2^20 x 33 table, beating to the master and writing
           state snapshots every 2 s; 2 worker threads run the chaos
           harness's teaching loop (pull their data shards, push ``w -
           target``) for 6 passes, pause after 3 until every shard has
           snapshotted since, then shard 1 is SIGKILLed: the master
           declares it dead, migrates every row and accumulator of its
           last snapshot to the ring successors (checksums verified, no
           row lost), ``/metrics`` labels every shard's member series and
           marks the dead one down, a full-vocabulary pull succeeds, and
           the final MSE is within 5e-3 (relative) of an unperturbed run
           of the same schedule beside it; every surviving shard reports
           its gather_rows launches over its pipe.
  serve_deep  the Wide&Deep family at the serve phase's width (39
           fields, vocabulary 2^20, factor dim 32, hidden 50; DCN's fc1
           [50, 1248], crosses [3, 1248], out [1, 1298]), parameters from
           the seed: one int8 artifact per kind written by
           ``models.export.save_compressed_npz`` (size-1 biases in fp32)
           and loaded by ``serve.load_model(..., row_leaves=...,
           device="cuda")``; the three decoded tables are equal, so one
           PS preload of the decoded ``[w | embed]`` rows (width 33)
           serves all three (DCN reads embed as its columns 1..33).  Per
           kind a ``PredictionServer`` with its hot cache on the card and
           the serve phase's 8 requests of 256 rows, with their
           ``rep_fids``/``rep_mask`` pair, sent twice: scores within 2e-3
           of a float64 numpy forward of the decoded parameters, more
           hits on the second pass, ``gather_rows`` launched at least once
           per scored micro-batch (counts reset just before each kind);
           rows/s, p50 and p99.  The MLP's products are ``torch.matmul``
           with TF32 off (checked).  Then PQ on the card: ``pq.train`` (4
           parts, 256 clusters, 10 iterations) and ``encode`` of the
           DeepFM artifact's embed (times, ``quantization_error``), the
           same codebook written by ``save_compressed_npz``, that
           artifact loaded and the requests scored locally within 1e-4
           of its decoded parameters' float64 forward.
  train_deep  DeepFM and DCN at the train phase's width (batch 4096,
           lambda 0.001, the health feed off, ``rep_fids`` = the Criteo
           layout's fids), each kind's ``logits_with_l2`` from the JAX
           package's init drawn from the seed (biases N(0, 0.01^2)): (a) DeepFM, 20 steps of
           ``SparseTableCTRTrainer`` (tables w over fids, embed over
           rep_fids), lr 0.05; (b) DCN, 10 steps of it (embed only), lr
           0.005 (at 0.05 its crosses diverge in the JAX package too:
           ``DCN_LR``); (c) DeepFM, 5 steps of ``CTRTrainer(
           fused_adagrad=True)``, lr 0.05.  Counts reset before each run,
           and its launches equal ``deep_expected_launches`` (per table
           dedup_ids, merge_rows for the lookup's backward and merge_apply;
           or merge_rows per table and fused_adagrad per leaf); the loss
           falls (the mean of the last third below the first third's);
           the first 2 steps re-run on the CPU with the plain versions
           (losses rtol 1e-4; touched table rows and every dense leaf
           rtol 1e-4 / atol 1e-5); one step from the init run twice on
           the card bit-identical (params and optimizer state); step ms,
           examples/s and the device's idle share over 3 profiled
           steps.
  dp_deep  DeepFM and DCN at train_deep's width and batches, data-parallel
           over 2 gloo ranks spawned on the card (2048 rows a rank):
           (a) ``SparseTableCTRTrainer(mesh=...)`` exact, 10 steps a model
           (w over fids and embed over rep_fids, two id streams on the
           hybrid exchange; the dense leaves on the mean); (b) the same
           with 8 bits and a measured range, 5 steps a model (the dense
           leaves on the coded ring); (c) ``CTRTrainer(mesh=...)`` exact,
           5 steps of DeepFM (the CLI's --dp).  DCN at ``DCN_LR``.  Per
           rank and run the launches equal ``dp_deep_expected_launches``
           (from ``dp_deep_plan``, the exchange ``pick_exchange_algo``
           gives each table: dedup_ids of the local and the gathered
           stream, merge_rows for the lookup's backward, merge_apply's
           merge mode, quantize_pack for the coded rows and the ring's
           hops); every rank's params and optimizer state bit-identical;
           the loss falls in (a) and (c); their first 2 steps re-run in a
           2-rank CPU world with the plain versions (losses rtol 1e-4,
           touched rows and dense leaves rtol 1e-4 / atol 2e-5, the
           family's tolerance); one step of (b) run twice from one state
           bit-identical on every rank, EF residuals included.  Step ms;
           rank 0's device time and idle share over 3 profiled steps of
           (a).
  cli      ``python -m lightctr_tpu_torch.cli`` on the card: a 65,536-row
           Criteo-layout libFFM file and a 16,384-row held-out file
           (``data.synth.write_criteo_proxy``), and sequence files of as
           many rows (item vocabulary 2^20, lengths 10-50, a positive row
           holding three of 63 intent items).  ``cli.main`` in this
           process for fm, nfm, widedeep, deepfm and dcn at --factor 32,
           ffm at its default 8 (v is 2^20 x 39 x 8), dcn at ``DCN_LR``
           and seqctr at its defaults, each with --batch-size 4096
           --epochs 2 --eval-data --ckpt-dir --dump-scores and counts reset
           just before: the report parses, the final loss is finite and
           below the first epoch's (the ``epoch`` events), held-out AUC >
           0.55 (DCN, which reads no feature value: its train AUC),
           merge_rows launched once a table gather a step and nothing
           else, and the checkpoint restored (``ckpt.restore``) gives
           params whose scores on the card equal the dumped file within
           1e-6.  Then ``deepfm --dp`` and ``deepfm --dp --compress-bits
           8`` under ``python -m torch.distributed.run --standalone
           --nproc-per-node 2`` (gloo, one card, its own process group,
           killed after 420 s): one report, rank 0's, finite, and its
           checkpoint restored to its dumped scores.  Each rank runs
           through this script's rank probe (``--cli-rank``, which wraps
           ``CTRTrainer._put``): the rows a rank was handed, mapped back to
           the global batch by their content, must be its own — the
           ranks' rows disjoint, together the batch the CLI trims to a
           multiple of the world.
  zoo      the CLI's other eight subcommands in this process on the
           card, on a 10,000-row ``data.synth.write_synthetic_dense_csv``
           file (28 x 28 pixels, 10 classes, MNIST's 60,000 rows cut to
           a sixth) and a 4,000-line text of 8 topics (Zipf words over a
           5,000-word vocabulary): cnn (at --lr 0.01: the default rmsprop
           0.1 stays at chance here, in the JAX package too), rnn and vae
           at their defaults for 1 epoch (batch 10); gbm binary and
           with --n-classes 10 (10 trees of depth 6), stack, gmm
           --clusters 10 (on the same file), plsa --topics 8, embed
           --mode negative --quantize --cluster 20 and embed --mode
           hierarchical, each with counts reset just before: the report
           parses and is finite; the loss or log-likelihood moves the
           right way (per epoch, or against the CLI's init evaluated
           here); cnn and rnn train accuracy > 0.5, gbm and stack train
           AUC > 0.9; merge_rows launched once a planned scatter (14 a
           tree: GBM's grad and hess histograms at 6 levels and 2 leaf
           sums; one a step of the stack's LR gather; 3 or 2 a word2vec
           step) and nothing else.  Beside the runs: the CLI's inits and
           first 3 steps re-run on the CPU (cnn, rnn, vae fed the card's
           noise: losses rtol 1e-4 / atol 2e-5, params rtol 1e-2 / atol
           5e-4); GBM's root histograms bit for bit and the first trees
           (binary, and class 0 of 10) equal on the card and the CPU;
           two whole binary fits on the card tree for tree bit-identical;
           the stack's LR steps over the card's trees (rtol 1e-4 / atol
           1e-5); the first EM step of gmm and plsa (log-likelihood rtol
           1e-5, params rtol 1e-4 / atol 1e-5); one word2vec epoch from
           one state run twice on the card bit-identical (tables and
           accumulators), and 3 steps of either mode on the card and the
           CPU within 1e-4.  Seconds a run and a step; the device's time
           over 5 cnn and rnn steps.
  algos    the zoo's last four modules (no kernel of the port; the
           counts, reset just before, stay 0), each on the card and on the
           CPU: ``models.ann.brute_force_topk`` of 256 queries over the
           serve table's v (2^20 x 32), dot and l2, held to a float64
           top-10 where the 10th and 11th scores are apart by more than
           1e-4 (relative); ``ANNIndex`` (8 trees, leaf 32, budget 2,048)
           on 2^16 of those rows, 128 queries, its re-rank on the card
           and the CPU equal up to such ties, recall@10 and the build's
           host seconds; ``ops.pca`` on the zoo's 10,000 x 784 file:
           ``fit_svd`` (16 rows; rows with a singular-value gap over 1e-2
           equal up to sign) and ``fit_gha`` (100 epochs, lr 0.01: its defaults) whose
           top row is aligned with SVD's (|cos| > 0.95, test_algos.py's
           criterion); ``ops.ensembling``'s votes over 5 models x 10,000
           rows x 10 classes equal, and 10 AdaBoost rounds within 2e-6
           (alphas) and rtol 1e-5 (weights) of a float64 run on either
           device; the DAG builder's demo, 100 SGD steps at batch 4,096,
           losses within rtol 1e-5.
  attention  the long-context path, counts reset just before it:
           ``flash_attention`` at (2, 4096, 8, 64) bf16 causal on the card,
           then ``ring_self_attention`` over a ``seq`` ring of 2 ranks
           spawned on the same card (gloo, host-staged) on the same inputs.
           Both ranks return the same tensor, within the bf16 tolerance
           above of the flash output; flash_attention launched, through its
           wgmma design, and refusing bf16 inputs that require grad (it
           has no backward).  The ring's backward on every rank: the
           gradients of sum(out ** 2) at (2, 64, 2, 16) float32 causal
           within rtol 1e-3 / atol 1e-4 of full attention's autograd.
           Ring step time and a profile of two more calls on rank 0.
  bench    counts reset, then ``lightctr_tpu_torch.tools.
           sparse_kernel_bench.run`` and ``tools.kernel_bench.run`` (no
           file written): every cell's kernel launched (merge_rows,
           quantize_pack_ef and flash_attention included; merge_apply in its
           fused merge mode, quantize_pack and quantize_pack_ef through
           their ``tree`` design); their cells are printed.

Every phase's line carries its seconds (``phase_s``).  Then a
``gather_floor`` line: an empty kernel at gather_rows' launch
shape, timed as the kernel is, at the serve and hot-row shapes (the
least a launch of that shape takes).  Then a ``{"kernels": [...]}``
line: each kernel at its main path's shape,
its launches on that path, its device time (``ms``, CUDA graph of
back-to-back calls), the plain version's, one PyTorch library call's where
one computes the same function (the yardstick; the port never calls it;
each plain version of a shape timed in one eager call),
the eager per-call time with the host (``call_ms``) and the bound: bytes at
3.35 TB/s, or for flash_attention the larger of that and its FLOPs at 989
TFLOP/s (its ``per_shape`` adds the path shape non-causal and (2, 4096, 8,
128) causal, each beside SDPA; merge_rows' ``per_shape`` and merge_apply's
``merge_mode`` give d = 32 and d = 1, the merge mode each with the exact
exchange's zero padding rows and the coded ones' non-zero rows;
merge_apply's apply mode and quantize_pack_ef_update add ``cold_ms``, each
call after a read that empties the L2, at d = 1 and d = 32, the latter at
8 and 16 bits, as do quantize_pack at 8 and 16 bits and quantize_pack_ef;
gather_rows adds ``cold_ms`` and its ``per_shape`` gives the serve and
hot-row shapes, warm and cold, each beside ``torch.index_select``; each
row's ``launches_dp_rs`` counts rank 0's launches in dp_rs and
``launches_ingest`` the ingest phase's; ``launches_serve_deep`` and
``launches_train_deep``, ``launches_dp_deep`` (rank 0) and
``launches_cli`` count the Wide&Deep family's paths and the CLI's,
``launches_online`` the online phase's (B3 and B4),
``launches_tiered`` the tiered phase's (B3, B4 and B5), and
``launches_cluster`` the cluster phase's (B2, B4 and B5 on rank 0 of host
0 in (a), B3 in (b)'s surviving shards), and are added into ``launches``; merge_rows' ``launches`` are the train
phase's (and those), and its ``per_shape_train`` times it as the gathers'
backward (159,744 slots into the 2^20-row table and into the sparse
trainer's 159,744 rows, d = 32 and 1, and into the table at FFM's d =
312) beside ``index_add_``, and its ``per_shape_zoo`` the zoo's two
shapes likewise, its ``per_shape_quality`` the quality sketch's;
``launches_zoo`` counts the zoo phase's; dedup_ids,
merge_rows and merge_apply add their ``dp_rs`` timing at that path's
shapes). Then the
``nvidia-smi`` name and power limit, and the last line ``{"ok": true,
"device": {...}}``. Any failed phase raises and exits non-zero; without
CUDA, or without the ``lightctr_tpu_torch`` package beside this file, it
exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_FIELDS = 39
N_CAT = 26
VOCAB = 1 << 20
DIM = 32
ROW_DIM = 1 + DIM
#: the row of FFM's v at the Criteo layout and the CLI's factor 8: one
#: vector of 8 per field, 39 fields (a lookup row of 312 floats)
FFM_ROW = N_FIELDS * 8
#: graph replays (and timed eager runs of the plain version) a
#: ``lookup_timing`` shape takes its median of
LOOKUP_REPEATS = 7
N_REQUESTS = 8
REQUEST_ROWS = 256
PRELOAD_CHUNK = 1 << 18
CACHE_ROWS = 65536          # PredictionServer's default cache_capacity
SCORE_ATOL = 2e-3           # fp16 wire (tests/test_serve.py uses the same)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet

#: kernel shapes held against the plain version (plus the serve path's n)
KERNEL_DS = (1, 33, 128)
KERNEL_NS = (1, 1000, 16384)

# -- the train phase: tools/criteo_scale.py's constants --
TRAIN_BATCH = 4096
TRAIN_K = TRAIN_BATCH * N_FIELDS   # ids deduped per step: 159,744
SPARSE_STEPS = 50                  # 204,800 rows, criteo_scale's pass
#: gather_rows' hot-row shape: a train batch's slots read out of a
#: device-resident [2^20, 32] table (the JAX package's hot tier and the
#: trainer's hot-resident path read their rows through the same kernel)
HOT_ROWS = 1 << 20
HOT_N = TRAIN_K
FUSED_STEPS = 10
EVAL_ROWS = 20480
LR = 0.05
LAMBDA_L2 = 0.001
EPS = 1e-7
WARMUP_STEPS = 3
CPU_SPARSE_STEPS = 3               # re-run on the CPU with plain versions
CPU_FUSED_STEPS = 2
PARITY_STEPS = 10                  # sparse vs fused trainer on the card
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
MIN_AUC = 0.55                     # tools/criteo_scale.py's gate
MAX_ULP = 2                        # the Adagrad apply's bound (ROADMAP B.5)
DEDUP_KS = (1, 1000, TRAIN_K)
ADAGRAD_NS = (1, 1001, 1 << 20, 1 << 25)

# -- attention: the JAX bench's causal bf16 shapes [B, T, H, D] --
FLASH_BENCH_SHAPES = ((4, 1024, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 64))
FLASH_PATH_SHAPE = (2, 4096, 8, 64)     # the attention phase's
FLASH_F32_SHAPES = ((2, 256, 4, 32), (2, 32, 2, 8))  # the last: graft entry
# wide heads (bf16, causal and not) and B*H past gridDim.y's 65,535
FLASH_WIDE_SHAPES = ((2, 1024, 8, 128), (2, 1024, 4, 256), (1, 1024, 4, 320))
FLASH_MANY_HEADS_SHAPE = (32800, 16, 2, 64)
# timed beside the path shape: (shape, causal)
FLASH_EXTRA_TIMED = (((2, 4096, 8, 64), False), ((2, 4096, 8, 128), True))
FLASH_16_MAX, FLASH_16_MEAN = 2e-2, 2e-3  # a few bf16 ulps at |o| < 2
FLASH_F32_RTOL, FLASH_F32_ATOL = 2e-4, 2e-5  # the JAX flash test's
RING_WORLD = 2
# the ring's backward against full attention's autograd, float32 causal
# (tests/test_ring_attention.py::test_ring_grad_flows' tolerance)
RING_GRAD_SHAPE = (2, 64, 2, 16)
RING_GRAD_RTOL, RING_GRAD_ATOL = 1e-3, 1e-4
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA's data sheet

# -- the dp phase: the same model and global batch over DP_WORLD ranks --
DP_WORLD = 2
DP_LOCAL_ROWS = TRAIN_BATCH // DP_WORLD
DP_LOCAL_K = DP_LOCAL_ROWS * N_FIELDS  # ids one rank dedups a step: 79,872


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# -- phase: build -------------------------------------------------------------


def phase_build(sk, bindings) -> dict:
    t0 = time.perf_counter()
    native = {}

    def build_native():
        native["ok"] = bindings.available()

    th = threading.Thread(target=build_native)
    th.start()
    paths = sk.build_all()
    th.join()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log in sk.BUILD_LOGS.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "kernels": {n: os.path.relpath(p, REPO) for n, p in paths.items()},
            "native_host_codecs": bool(native.get("ok")), "ptxas": ptxas}


# -- phase: kernels -----------------------------------------------------------


def gather_inputs(torch, rows, d, n, gen, idx_dtype=None):
    """A [rows, d] fp32 block and n indices, a third of them outside
    [0, rows) and the first ones at the clip's edges."""
    idx_dtype = idx_dtype or torch.int32
    block = torch.randn((rows, d), generator=gen, device="cuda")
    idx = torch.randint(-rows // 4, rows + rows // 4, (n,), generator=gen,
                        device="cuda", dtype=torch.int64)
    edges = [-1, rows, -(1 << 31), (1 << 31) - 1, rows - 1, 0]
    if idx_dtype == torch.int64:
        edges += [(1 << 32) + 5, -(1 << 33)]   # wrap in the int32 cast
    m = min(n, len(edges))
    idx[:m] = torch.tensor(edges[:m], dtype=torch.int64)
    return block, idx.to(idx_dtype)


def phase_kernels(torch, sk, serve_ns) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [(CACHE_ROWS, d, n, torch.int32) for d in KERNEL_DS
             for n in sorted(set(KERNEL_NS) | set(serve_ns))]
    cases += [(CACHE_ROWS, ROW_DIM, 1000, torch.int64),
              (HOT_ROWS, DIM, HOT_N, torch.int32)]
    max_err = 0.0
    checked = []
    for rows, d, n, idt in cases:
        block, idx = gather_inputs(torch, rows, d, n, gen, idt)
        got = sk.gather_rows(block, idx)
        torch.cuda.synchronize()
        want = sk.gather_rows_plain(block, idx)
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows kernel != plain at R={rows} "
                                 f"d={d} n={n} idx={idt}")
        max_err = max(max_err, float((got - want).abs().max()))
        checked.append([rows, d, n, str(idt).replace("torch.", "")])
    return {"phase": "kernels", "gather_rows": {
        "bit_exact": True, "max_abs_err": max_err, "cases": checked}}


def check_gather_tiered(torch, sk) -> dict:
    """B3 at the tiered store's pinned pair, [2^16, 33], at pow2 index
    lengths as the store pads them, held to ``gather_rows_plain``."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    block = torch.randn((TIERED_HOT_ROWS, ROW_DIM), generator=gen,
                        device="cuda")
    lengths = [1 << k for k in range(3, 18, 2)]
    for n in lengths:
        idx = torch.randint(0, TIERED_HOT_ROWS, (n,), generator=gen,
                            device="cuda", dtype=torch.int32)
        got = sk.gather_rows(block, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, sk.gather_rows_plain(block, idx)):
            raise AssertionError(f"gather_rows kernel != plain at the "
                                 f"tiered pair, n={n}")
    return {"bit_exact": True, "max_abs_err": 0.0,
            "shape": [TIERED_HOT_ROWS, ROW_DIM], "lengths": lengths}


def ulp_diff(torch, a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors (0 where they are bit-identical)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(1 << 31) - i, i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def criteo_fids(np, rng, rows, vocab=VOCAB):
    """[rows, 39] int32 ids of the Criteo layout (data/synth.py): ids
    ~ u^4 * vocab in the 26 categorical fields, one fixed id per numeric
    field."""
    fids = (rng.random((rows, N_FIELDS)) ** 4 * vocab).astype(np.int32)
    fids[:, N_CAT:] = np.arange(N_CAT, N_FIELDS, dtype=np.int32)
    return fids


def dedup_streams(np, rng) -> dict:
    """name -> int32 id stream: Criteo ids, random ids with negatives and
    int32's limits, all-equal and all-zero, ids that differ only in the
    lowest 8-bit digit or only in the sign bit, at each K in DEDUP_KS."""
    out = {}
    for k in DEDUP_KS:
        rows = -(-k // N_FIELDS)
        out[f"criteo_k{k}"] = criteo_fids(np, rng, rows).reshape(-1)[:k]
        edge = rng.integers(-(1 << 31), 1 << 31, size=k, dtype=np.int64)
        lim = [-(1 << 31), (1 << 31) - 1, -1, 0, -(1 << 31), (1 << 31) - 1]
        edge[:min(k, len(lim))] = lim[:k]
        out[f"edges_k{k}"] = edge.astype(np.int32)
        out[f"all_equal_k{k}"] = np.full(k, -7, np.int32)
        out[f"all_zero_k{k}"] = np.zeros(k, np.int32)
        out[f"low_digit_k{k}"] = (rng.integers(0, 256, size=k)
                                  + 0x3C3C3C00).astype(np.int32)
        out[f"sign_bit_k{k}"] = np.where(rng.random(k) < 0.5, -(1 << 31),
                                         0).astype(np.int32)
    return out


def check_dedup(np, torch, sk, rng) -> dict:
    """dedup_ids kernel == plain version (torch.unique) bit for bit, at
    size = K and at a size below the distinct count."""
    cases = []
    for name, ids in dedup_streams(np, rng).items():
        t = torch.from_numpy(ids).cuda()
        count = int(sk.dedup_ids_plain(t, ids.size)[2])
        for size in sorted({ids.size, max(1, count // 2)}):
            got = sk.dedup_ids(t, size)
            torch.cuda.synchronize()
            want = sk.dedup_ids_plain(t, size)
            for a, b, what in zip(got, want, ("uids", "inv", "count")):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(
                        f"dedup_ids kernel != plain ({what}) on {name} "
                        f"size={size}")
            cases.append([name, size, count])
    return {"bit_exact": True, "max_abs_err": 0, "cases": cases}


def check_merge_apply(np, torch, sk, rng) -> dict:
    """merge_apply kernel vs plain version at the train path's shapes:
    V = 2^20, d in {1, 32} and 33 (one float a lane, a row across the
    warp), S = 159744 uids of a real dedup (Criteo ids hold id 0 about 3 %
    of the time; the other stream has none)."""
    fids = criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)
    streams = {"with_id0": fids, "without_id0": np.where(fids == 0, 1, fids)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    max_ulp = {"table": 0, "accum": 0}
    max_abs = 0.0
    max_ssq_rel = 0.0
    cases = []
    for sname, ids in streams.items():
        uids, _, count = sk.dedup_ids(torch.from_numpy(ids).cuda())
        has0 = bool(uids[0] == 0)
        for d in (1, DIM, DIM + 1):
            shape = (VOCAB,) if d == 1 else (VOCAB, d)
            table = torch.randn(shape, generator=gen, device="cuda")
            accum = torch.rand(shape, generator=gen, device="cuda")
            rows = torch.randn((uids.numel(),) + shape[1:], generator=gen,
                               device="cuda")
            for denom in (1.0, 4.0):
                t1, a1 = table.clone(), accum.clone()
                _, _, s1 = sk.merge_apply(t1, a1, uids, rows, lr=LR, eps=EPS,
                                          denom=denom)
                torch.cuda.synchronize()
                t2, a2 = table.clone(), accum.clone()
                _, _, s2 = sk.merge_apply_plain(t2, a2, uids, rows, None, LR,
                                                EPS, denom)
                ut, ua = ulp_diff(torch, t1, t2), ulp_diff(torch, a1, a2)
                rel = abs(float(s1) - float(s2)) / abs(float(s2))
                if ut > MAX_ULP or ua > MAX_ULP or rel > 1e-5:
                    raise AssertionError(
                        f"merge_apply kernel vs plain: {ut} / {ua} ulp, "
                        f"sumsq rel {rel} ({sname}, d={d}, denom={denom})")
                max_ulp["table"] = max(max_ulp["table"], ut)
                max_ulp["accum"] = max(max_ulp["accum"], ua)
                max_abs = max(max_abs, float((t1 - t2).abs().max()),
                              float((a1 - a2).abs().max()))
                max_ssq_rel = max(max_ssq_rel, rel)
                cases.append([sname, d, denom, int(count), has0])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs,
            "max_sumsq_rel_err": max_ssq_rel, "cases": cases}


def check_fused_adagrad(torch, fa) -> dict:
    """fused_adagrad kernel vs plain version: N in ADAGRAD_NS (1001 is not
    a multiple of 4: the scalar path) and 2^20 starting one float into
    its buffers (misaligned: the scalar path)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    max_ulp, max_abs, cases = 0, 0.0, []
    for n, off in [(n, 0) for n in ADAGRAD_NS] + [(1 << 20, 1)]:
        w, a, g = (torch.randn(n + off, generator=gen, device="cuda")[off:]
                   for _ in range(3))
        a = a.abs()
        w1, a1 = w.clone(), a.clone()
        if off:
            w1 = torch.empty(n + off, device="cuda")[off:].copy_(w)
            a1 = torch.empty(n + off, device="cuda")[off:].copy_(a)
        fa.fused_adagrad_update(w1, a1, g, LR, EPS)
        torch.cuda.synchronize()
        w2, a2 = fa.fused_adagrad_plain(w.clone(), a.clone(), g, LR, EPS)
        u = max(ulp_diff(torch, w1, w2), ulp_diff(torch, a1, a2))
        if u > MAX_ULP:
            raise AssertionError(f"fused_adagrad kernel vs plain: {u} ulp "
                                 f"at N={n} offset={off}")
        max_ulp = max(max_ulp, u)
        max_abs = max(max_abs, float((w1 - w2).abs().max()),
                      float((a1 - a2).abs().max()))
        cases.append([n, off])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs, "cases": cases}


def check_dedup64(np, torch, sk, rng) -> dict:
    """dedup_ids on int64 id streams == plain version (torch.unique) bit
    for bit: Criteo ids shifted past int32, ids across int64's range with
    its limits, an all-equal stream, and ids that differ only above bit 40
    (the radix sort's high digits, its low five skipped), at K in
    DEDUP_KS."""
    cases = []
    i64 = np.iinfo(np.int64)
    for k in DEDUP_KS:
        rows = -(-k // N_FIELDS)
        streams = {
            "criteo_shifted": criteo_fids(np, rng, rows).reshape(-1)[:k]
            .astype(np.int64) * (1 << 33) - (1 << 40),
            "edges": rng.integers(i64.min, i64.max, size=k, dtype=np.int64),
            "all_equal": np.full(k, -(1 << 35), np.int64),
            "high_digits": (rng.integers(0, 1 << 12, size=k)
                            .astype(np.int64) << 41) - (1 << 62),
        }
        lim = [i64.min, i64.max, -1, 0, i64.min, i64.max]
        streams["edges"][:min(k, len(lim))] = lim[:k]
        for name, ids in streams.items():
            t = torch.from_numpy(ids).cuda()
            count = int(sk.dedup_ids_plain(t, k)[2])
            for size in sorted({k, max(1, count // 2)}):
                got = sk.dedup_ids(t, size)
                torch.cuda.synchronize()
                want = sk.dedup_ids_plain(t, size)
                for a, b, what in zip(got, want, ("uids", "inv", "count")):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(
                            f"dedup_ids int64 kernel != plain ({what}) on "
                            f"{name} k={k} size={size}")
                cases.append([f"{name}_k{k}", size, count])
    return {"bit_exact": True, "max_abs_err": 0, "cases": cases}


#: a padding row's value after the coded exchange: the codes' tables hold
#: no exact 0, so the padding's zero rows decode to small values, which the
#: merge adds (one run of about half the gathered rows)
CODED_PAD = 1e-3


def gathered_stream(np, torch, sk, rng):
    """The dp path's merge input: the two ranks' dedup streams of one
    global batch (K = 79,872 ids each, id 0 padding each past its count),
    gathered, and their union.  Returns (ids, uniq, inv, count, pad, per
    rank), ``pad`` [M, 1] float32, 1 at each padding slot."""
    fids = criteo_fids(np, rng, DP_WORLD * DP_LOCAL_ROWS).reshape(-1)
    per_rank = [sk.dedup_ids(torch.from_numpy(
        fids[r * DP_LOCAL_K:(r + 1) * DP_LOCAL_K]).cuda())
        for r in range(DP_WORLD)]
    ids = torch.cat([u for u, _, _ in per_rank])
    uniq, inv, count = sk.dedup_ids(ids)
    slot = torch.arange(ids.numel(), device="cuda") % per_rank[0][0].numel()
    pad = ((ids == 0) & (slot > 0)).to(torch.float32).reshape(-1, 1)
    return ids, uniq, inv, int(count), pad, per_rank


def merge_inputs(np, torch, rng, m, d, nseg):
    """[m, d] rows and an inv over [-3, nseg + 3): the two ranks' gathered
    Criteo streams' heavy duplicates (a numeric field's id in every row)
    plus out-of-range segments of both signs."""
    fids = criteo_fids(np, rng, -(-m // N_FIELDS)).reshape(-1)[:m]
    _, inv = np.unique(fids, return_inverse=True)
    inv = inv.astype(np.int64) % nseg
    bad = rng.random(m) < 0.01
    inv[bad] = rng.choice([-3, -1, nseg, nseg + 2], size=int(bad.sum()))
    gen = torch.Generator(device="cuda").manual_seed(int(m + d))
    rows = torch.randn((m, d), generator=gen, device="cuda")
    return rows, torch.from_numpy(inv.astype(np.int32)).cuda()


def check_merge_rows(np, torch, sk, rng) -> dict:
    """merge_rows kernel == plain version (slot-order rounds) bit for bit
    at the allgather merge's shape: W*K = 159,744 gathered rows, d in
    {1, 32}, nseg = W*K; the same rows with every seventh segment's rows
    all +-0 (left at +0); nseg = 2^24 + 77, so the radix sort moves all
    four digits; and as FFM's lookup backward in the cli phase: one
    batch's 159,744 Criteo ids as segments of the 2^20-row table, rows of
    d = 312 (float4 lanes over 78 vectors a row)."""
    m = DP_WORLD * DP_LOCAL_K
    cases = []
    for d, nseg, zeros in ((1, m, False), (DIM, m, False), (DIM, m, True),
                           (1, (1 << 24) + 77, False),
                           (FFM_ROW, VOCAB, False)):
        rows, inv = merge_inputs(np, torch, rng, m, d, m)
        if nseg == VOCAB:
            inv = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH)
                                   .reshape(-1).astype(np.int32)).cuda()
        elif nseg != m:
            inv = torch.from_numpy(rng.integers(
                -2, nseg + 2, size=m).astype(np.int32)).cuda()
        if zeros:
            hit = (inv % 7) == 0
            rows[hit] = torch.where(torch.rand_like(rows[hit]) < 0.5, 0.0,
                                    -0.0)
        got = sk.merge_rows(rows, inv, nseg)
        torch.cuda.synchronize()
        want = sk.merge_rows_plain(rows, inv, nseg)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"merge_rows kernel != plain at d={d}, "
                                 f"nseg={nseg}, zero segments {zeros}: "
                                 f"max {float((got - want).abs().max())}")
        cases.append({"m": m, "d": d, "nseg": nseg, "zero_segments": zeros,
                      "dropped": int((inv < 0).sum() + (inv >= nseg).sum())})
        del rows, got, want
        torch.cuda.empty_cache()
    return {"bit_exact": True, "max_abs_err": 0.0, "cases": cases}


def check_merge_apply_merge_mode(np, torch, sk, rng) -> dict:
    """merge_apply in merge mode (one fused launch: the merge's sort and
    runs, applied straight to the table) vs the plain version: W*K =
    159,744 gathered rows merged onto the union of two ranks' dedup
    streams, V = 2^20, d in {1, 32}, denom W; each call one launch of
    merge_apply's ``merge`` design and none of merge_rows.  Then the dp
    path's own stream, the two ranks' dedup streams gathered, with the
    padding rows at CODED_PAD as the coded runs send them: one run of
    about half the rows, which the whole walker block sums."""
    fids = criteo_fids(np, rng, DP_WORLD * DP_LOCAL_ROWS).reshape(-1)
    raw_ids = torch.from_numpy(fids).cuda()
    raw = sk.dedup_ids(raw_ids)
    coded = gathered_stream(np, torch, sk, rng)
    gen = torch.Generator(device="cuda").manual_seed(17)
    max_ulp = {"table": 0, "accum": 0}
    max_abs, max_rel, cases = 0.0, 0.0, []
    for d, stream in ((1, "raw"), (DIM, "raw"), (1, "coded_pads"),
                      (DIM, "coded_pads")):
        if stream == "raw":
            ids, (uids, inv, count) = raw_ids, raw
        else:
            ids, uids, inv, count, pad, _ = coded
        shape = (VOCAB,) if d == 1 else (VOCAB, d)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        rows = torch.randn((ids.numel(),) + shape[1:], generator=gen,
                           device="cuda")
        if stream == "coded_pads":
            p = pad if d > 1 else pad.reshape(-1)
            rows = rows * 0.05 * (1 - p) + CODED_PAD * p
        t1, a1 = table.clone(), accum.clone()
        sk.reset_launches()
        _, _, s1 = sk.merge_apply(t1, a1, uids, rows, inv, lr=LR, eps=EPS,
                                  denom=float(DP_WORLD))
        torch.cuda.synchronize()
        ran = (sk.launches("merge_rows"), sk.launches("merge_apply"),
               sk.variant_launches("merge_apply"))
        if ran != (0, 1, {"merge": 1}):
            raise AssertionError(f"merge_apply merge mode launched "
                                 f"(merge_rows, merge_apply, designs) {ran}")
        t2, a2 = table.clone(), accum.clone()
        _, _, s2 = sk.merge_apply_plain(t2, a2, uids, rows, inv, LR, EPS,
                                        float(DP_WORLD))
        ut, ua = ulp_diff(torch, t1, t2), ulp_diff(torch, a1, a2)
        rel = abs(float(s1) - float(s2)) / abs(float(s2))
        if ut > MAX_ULP or ua > MAX_ULP or rel > 1e-5:
            raise AssertionError(f"merge_apply merge mode vs plain: {ut} / "
                                 f"{ua} ulp, sumsq rel {rel} (d={d}, "
                                 f"{stream})")
        max_ulp["table"] = max(max_ulp["table"], ut)
        max_ulp["accum"] = max(max_ulp["accum"], ua)
        max_abs = max(max_abs, float((t1 - t2).abs().max()),
                      float((a1 - a2).abs().max()))
        max_rel = max(max_rel, rel)
        cases.append([stream, ids.numel(), d, int(count)])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs,
            "max_sumsq_rel_err": max_rel, "cases": cases}


def qp_payload(torch, gen, shape, scale=0.05):
    """A gradient-like payload with +-inf, NaN and values on and past the
    table's edges."""
    x = torch.randn(shape, generator=gen, device="cuda") * scale
    flat = x.view(-1)
    flat[:6] = torch.tensor([float("inf"), float("-inf"), float("nan"), 2.0,
                             -2.0, 0.0], device="cuda")
    return x


def check_design(sk, name, bits, call):
    """``call()`` launches kernel ``name`` once, through the search design
    a ``bits``-wide table names; returns what ``call`` returns."""
    before = sk.variant_launches(name)
    out = call()
    after = sk.variant_launches(name)
    ran = {k: v - before.get(k, 0) for k, v in after.items()
           if v != before.get(k, 0)}
    if ran != {sk.search_design(bits): 1}:
        raise AssertionError(f"{name} at {bits} bits ran {ran}, not its "
                             f"{sk.search_design(bits)} design")
    return out


def check_quantize_pack(np, torch, sk, qz) -> dict:
    """quantize_pack kernel == plain version (quantize.compress) bit for
    bit on the exchange's [79,872, 32] payload: 8-bit uniform and normal
    tables (fixed range 1.0 and a measured range), 16-bit uniform, 4-bit
    with its nibble-packed wire form and 1-bit; at 8 and 16 bits also the
    payload one float past 16 bytes and one value short (a scalar head and
    tail around the float4 body), and at 16 bits every boundary and one
    ulp either side (both edges of every segment of the two-stage
    search).  Each launch through its width's design."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = qp_payload(torch, gen, (DP_LOCAL_K, DIM))
    # a flat copy one float past 16 bytes, one value short
    x_mis = torch.empty(x.numel() + 1, device="cuda")[1:-1].copy_(
        x.reshape(-1)[:-1])
    rng_dyn = 1.05 * x[x.isfinite()].abs().max()
    cases = []
    for bits, mode, lim in ((8, "uniform", 1.0), (8, "normal", 1.0),
                            (8, "normal", rng_dyn), (16, "uniform", 1.0),
                            (4, "normal", rng_dyn), (1, "uniform", 1.0)):
        table = qz.build_table(-lim, lim, bits=bits, mode=mode,
                               device="cuda")
        inputs = [("aligned", x)]
        if bits in (8, 16):
            inputs.append(("misaligned", x_mis))
        if bits == 16:
            b = table.boundaries
            inf = torch.tensor(float("inf"), device="cuda")
            edges = torch.cat([b, torch.nextafter(b, inf),
                               torch.nextafter(b, -inf)])
            inputs.append(("boundaries", edges[torch.randperm(
                edges.numel(), generator=gen, device="cuda")]))
        for what, xi in inputs:
            got = check_design(sk, "quantize_pack", bits,
                               lambda: sk.quantize_pack(table, xi))
            torch.cuda.synchronize()
            want = sk.quantize_pack_plain(table, xi)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"quantize_pack kernel != plain at "
                                     f"{bits} bits, {mode}, {what}")
            cases.append([bits, mode, "dynamic" if torch.is_tensor(lim)
                          else lim, what, xi.numel()])
        if bits <= 4 and not torch.equal(
                sk.quantize_pack_packed(table, x),
                qz.pack_nibbles(sk.quantize_pack_plain(table, x))):
            raise AssertionError("quantize_pack_packed != pack_nibbles")
    nan_code = int(sk.quantize_pack(qz.build_table(-1.0, 1.0, bits=8,
                                                   device="cuda"), x)[0, 2])
    return {"bit_exact": True, "max_abs_err": 0, "payload": [DP_LOCAL_K, DIM],
            "nan_code": nan_code, "cases": cases}


def check_quantize_pack_ef_update(np, torch, sk, qz, rng) -> dict:
    """quantize_pack_ef_update kernel == plain version bit for bit (codes,
    dec, residual): the uids of a real dedup of one rank's 2048-row
    Criteo batch (id 0 included, pads masked), rows 3x the range so the
    clip feeds the carry, a carry from a previous step, d in {1, 32, 33},
    8 and 16 bits, each launch through its width's design."""
    fids = criteo_fids(np, rng, DP_LOCAL_ROWS).reshape(-1)
    fids[0] = 0
    uids, _, count = sk.dedup_ids(torch.from_numpy(fids).cuda())
    k = uids.numel()
    gen = torch.Generator(device="cuda").manual_seed(29)
    cases = []
    for d in (1, DIM, DIM + 1):
        for bits, mode in ((8, "normal"), (16, "uniform")):
            table = qz.build_table(-1.0, 1.0, bits=bits, mode=mode,
                                   device="cuda")
            shape = (VOCAB,) if d == 1 else (VOCAB, d)
            residual = torch.randn(shape, generator=gen, device="cuda") * 0.1
            rows = torch.randn((k,) + shape[1:], generator=gen,
                               device="cuda") * 3.0
            mask = (~((uids == 0) & (torch.arange(k, device="cuda") > 0))) \
                .to(torch.float32).reshape((-1,) + (1,) * (rows.ndim - 1))
            rows = rows * mask
            r1, r2 = residual.clone(), residual.clone()
            c1, _, d1 = check_design(
                sk, "quantize_pack_ef_update", bits,
                lambda: sk.quantize_pack_ef_update(table, rows, uids, r1,
                                                   mask))
            torch.cuda.synchronize()
            c2, _, d2 = sk.quantize_pack_ef_update_plain(table, rows, uids,
                                                         r2, mask)
            for a, b, what in ((c1, c2, "codes"), (d1, d2, "dec"),
                               (r1, r2, "residual")):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(
                        f"quantize_pack_ef_update kernel != plain ({what}) at "
                        f"d={d}, {bits} bits")
            cases.append([k, int(count), d, bits, mode])
    return {"bit_exact": True, "max_abs_err": 0.0, "has_id0": True,
            "cases": cases}


def check_quantize_pack_ef(np, torch, sk, qz) -> dict:
    """quantize_pack_ef kernel == plain version bit for bit (codes, delta)
    on the [79,872, 32] payload: rows with +-inf and NaN, a carry with inf
    and NaN, masked and unmasked rows ([P, 1]) and values ([P, d]) and a
    scalar mask, 8 bits normal and 16 bits uniform, each launch through
    its width's design."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = qp_payload(torch, gen, (DP_LOCAL_K, DIM), scale=0.5)
    carried = torch.randn((DP_LOCAL_K, DIM), generator=gen,
                          device="cuda") * 0.05
    carried.view(-1)[40:42] = torch.tensor([float("inf"), float("nan")],
                                           device="cuda")
    cases = []
    for bits, mode in ((8, "normal"), (16, "uniform")):
        table = qz.build_table(-1.0, 1.0, bits=bits, mode=mode,
                               device="cuda")
        for shape in ((DP_LOCAL_K, 1), (DP_LOCAL_K, DIM), ()):
            mask = (torch.rand(shape, generator=gen, device="cuda")
                    > 0.3).to(torch.float32)
            if shape:
                mask[0] = 1.0   # the inf/NaN values of the first row unmasked
                mask[1] = 0.0
            else:
                mask.fill_(1.0)
            c1, d1 = check_design(sk, "quantize_pack_ef", bits,
                                  lambda: sk.quantize_pack_ef(
                                      table, rows, carried, mask))
            torch.cuda.synchronize()
            c2, d2 = sk.quantize_pack_ef_plain(table, rows, carried, mask)
            if c1.dtype != c2.dtype or not torch.equal(c1, c2):
                raise AssertionError(f"quantize_pack_ef kernel != plain "
                                     f"(codes) at {bits} bits, mask {shape}")
            if not torch.equal(d1.view(torch.int32), d2.view(torch.int32)):
                raise AssertionError(f"quantize_pack_ef kernel != plain "
                                     f"(delta) at {bits} bits, mask {shape}")
            cases.append([bits, mode, list(shape),
                          int((mask == 0).sum())])
    return {"bit_exact": True, "max_abs_err": 0.0,
            "payload": [DP_LOCAL_K, DIM], "nan_code": int(c1[0, 2]),
            "cases": cases}


def flash_inputs(torch, shape, dtype, seed):
    """Unit-normal q, k, v of ``shape`` from a CPU generator (the same in
    every process), on the card in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).cuda()
            for _ in range(3)]


def flash_error(torch, got, want, dtype):
    """(max abs, mean abs) error of the kernel's output; raises past the
    dtype's tolerance."""
    err = (got.float() - want.float()).abs()
    emax, emean = float(err.max()), float(err.mean())
    if dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=FLASH_F32_RTOL,
                            atol=FLASH_F32_ATOL)
    else:
        ok = emax <= FLASH_16_MAX and emean <= FLASH_16_MEAN
    if not ok or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"flash_attention kernel vs plain: max {emax}, "
                             f"mean {emean} ({dtype})")
    return emax, emean


def check_flash(torch, sk, fl) -> dict:
    """flash_attention kernel vs plain version (float32 full_attention):
    the bench's causal bf16 shapes, bf16 heads of 128, 256 and 320 causal
    and not, B*H = 65,600, and fp32 at (2, 256, 4, 32) and the graft
    entry's (2, 32, 2, 8), causal and not.  Each case records the design
    that ran (``flash_route``)."""
    cases, max_err = [], {"bfloat16": 0.0, "float32": 0.0}
    runs = [(shape, torch.bfloat16, True) for shape in FLASH_BENCH_SHAPES]
    runs += [(shape, torch.bfloat16, causal) for shape in FLASH_WIDE_SHAPES
             for causal in (False, True)]
    runs.append((FLASH_MANY_HEADS_SHAPE, torch.bfloat16, True))
    runs += [(shape, torch.float32, causal) for shape in FLASH_F32_SHAPES
             for causal in (False, True)]
    for i, (shape, dt, causal) in enumerate(runs):
        q, k, v = flash_inputs(torch, shape, dt, 100 + i)
        sk.reset_launches()
        got = fl.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route = sk.variant_launches("flash_attention")
        if route != {fl.flash_route(q, k, v): 1}:
            raise AssertionError(f"flash_attention {shape}: ran {route}")
        want = fl.flash_attention_plain(q, k, v, causal)
        emax, emean = flash_error(torch, got, want, dt)
        key = str(dt).replace("torch.", "")
        max_err[key] = max(max_err[key], emax)
        cases.append([list(shape), key, causal, next(iter(route)), emax,
                      emean])
        del q, k, v, got, want
    return {"max_abs_err": max(max_err.values()), "max_abs_err_by_dtype":
            max_err, "tolerance": {"16-bit": [FLASH_16_MAX, FLASH_16_MEAN],
                                   "float32": [FLASH_F32_RTOL,
                                               FLASH_F32_ATOL]},
            "cases": cases}


# -- phase: serve -------------------------------------------------------------


def make_params(np, seed):
    """FM params {"w": [F], "v": [F, k]} from a seed.  W is small random
    (not the zero init) so the linear term counts; V is N(0, 0.3^2 / k),
    a logit spread of about 0.5 like a trained CTR model's (at the
    N(0, 1/k) init four in ten scores saturate)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.01, VOCAB).astype(np.float32)
    v = (rng.standard_normal((VOCAB, DIM), dtype=np.float32)
         * np.float32(0.3 / np.sqrt(DIM)))
    return {"w": w, "v": v}


def make_requests(np, seed):
    """Criteo-layout requests (data/synth.py write_criteo_proxy): the 26
    categorical fields draw ids ~ u^4 * vocab (a frequent head, a long
    tail), the 13 numeric fields one fixed id each with an exponential
    value."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(N_REQUESTS):
        u = rng.random((REQUEST_ROWS, N_FIELDS))
        fids = (u ** 4 * VOCAB).astype(np.int32)
        fids[:, N_CAT:] = np.arange(N_CAT, N_FIELDS, dtype=np.int32)
        vals = np.ones((REQUEST_ROWS, N_FIELDS), np.float32)
        vals[:, N_CAT:] = rng.exponential(
            1.0, (REQUEST_ROWS, N_FIELDS - N_CAT)).astype(np.float32)
        out.append({"fids": fids, "vals": vals})
    return out


def fm_forward64(np, params, req):
    x = req["vals"].astype(np.float64)
    w = params["w"][req["fids"]].astype(np.float64)
    vx = params["v"][req["fids"]].astype(np.float64) * x[..., None]
    z = (w * x).sum(-1) + 0.5 * ((vx.sum(1) ** 2).sum(-1)
                                 - (vx ** 2).sum((1, 2)))
    return 1.0 / (1.0 + np.exp(-z))


def serve_gather_ns(np, sk, requests) -> list:
    """The gather's n on the serve path: each micro-batch's distinct
    ids, padded to the kernel layer's power-of-two ladder."""
    return sorted({sk.next_pow2(len(np.unique(r["fids"])))
                   for r in requests})


def serve_passes(np, cli, srv, requests, refs, what):
    """Send ``requests`` twice through ``cli``; every reply's scores within
    SCORE_ATOL of ``refs``.  Returns each pass's rows/s, p50/p99 and the
    cache's hits after it, and the largest score error."""
    passes = []
    max_err = 0.0
    for p in range(2):
        lat = []
        t_pass = time.perf_counter()
        for req, ref in zip(requests, refs):
            t = time.perf_counter()
            scores = cli.predict(req)   # raises on any non-OK reply
            lat.append(time.perf_counter() - t)
            if scores.shape != ref.shape or \
                    not np.all(np.isfinite(scores)):
                raise AssertionError(f"{what}: bad scores {scores.shape}")
            err = float(np.abs(scores - ref).max())
            max_err = max(max_err, err)
            if err > SCORE_ATOL:
                raise AssertionError(
                    f"{what} pass {p}: score error {err} > {SCORE_ATOL}")
        wall = time.perf_counter() - t_pass
        lat_sorted = sorted(lat)
        passes.append({
            "rows_per_s": len(requests) * REQUEST_ROWS / wall,
            "p50_ms": 1e3 * statistics.median(lat),
            "p99_ms": 1e3 * lat_sorted[min(len(lat) - 1,
                                           int(0.99 * len(lat)))],
            "hits": srv.cache.stats()["hits"],
        })
    return passes, max_err


def check_served(srv, passes, launches, what):
    """The serve path's gates after two passes: the cache rows a CUDA
    tensor, more hits on the second pass, and ``gather_rows`` launched at
    least once per scored micro-batch.  Returns the cache's stats and the
    micro-batches scored."""
    st = srv.stats()
    cache = st["cache"]
    batches = st["batches_scored"]
    if not (cache["device_rows"] and srv.cache._block.is_cuda):
        raise AssertionError(f"{what}: cache rows are not a CUDA tensor")
    if passes[1]["hits"] <= passes[0]["hits"]:
        raise AssertionError(f"{what}: no cache hits on the second pass")
    if launches["gather_rows"] < batches or batches < 2 * N_REQUESTS:
        raise AssertionError(
            f"{what}: gather_rows launched {launches['gather_rows']} times "
            f"for {batches} scored micro-batches")
    return cache, batches


#: the drift check's monitor: 16 score bins, 64 coverage buckets, the
#: first pass (8 x 256 rows) frozen as the reference, 2,048-row windows
DRIFT_SCORE_BINS = 16
DRIFT_BUCKETS = 64
DRIFT_WINDOW = N_REQUESTS * REQUEST_ROWS
#: the shifted request set: its categorical ids collapse onto this many
#: (test_quality.py's collapsed vocabulary)
DRIFT_SHIFT_IDS = 4


def shifted_requests(np, requests, seed) -> list:
    """The requests with every categorical id redrawn from the first
    DRIFT_SHIFT_IDS ids: a vocabulary shift."""
    rng = np.random.default_rng(seed + 7)
    out = []
    for r in requests:
        fids = r["fids"].copy()
        fids[:, :N_CAT] = rng.integers(0, DRIFT_SHIFT_IDS,
                                       (REQUEST_ROWS, N_CAT))
        out.append({"fids": fids.astype(np.int32), "vals": r["vals"]})
    return out


def drift_settled(dm, windows, timeout_s=10.0) -> None:
    """Wait until ``dm`` has scored ``windows`` windows and holds no live
    rows: the scorer thread feeds the monitor after it answers a batch."""
    deadline = time.monotonic() + timeout_s
    while True:
        snap = dm.snapshot()
        if snap["windows"] == windows and snap["live_examples"] == 0:
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"serve drift: {snap['windows']} windows "
                                 f"and {snap['live_examples']} live rows, "
                                 f"not {windows} and 0")
        time.sleep(0.01)


def serve_drift(np, serve, svc, requests, refs, seed) -> dict:
    """The FM server with ``drift=DriftMonitor(...)`` over the same PS: the
    first pass freezes the reference, the same traffic again scores below
    ``DriftDetector``'s degraded band, and two windows of shifted requests
    (the server's monitor trips after two) trip it, which ``/healthz``
    shows as a 503 naming the server."""
    import urllib.error
    import urllib.request

    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.dist.ps_server import PSClient
    from lightctr_tpu_torch.obs import exporter, health, quality

    dm = quality.DriftMonitor(
        component="serve_drift", score_bins=DRIFT_SCORE_BINS,
        coverage_buckets=DRIFT_BUCKETS, reference_examples=DRIFT_WINDOW,
        window_examples=DRIFT_WINDOW, registry=obs.MetricsRegistry())
    model = serve.ServingModel(
        "fm", {}, row_leaves=serve.fm_ps_row_leaves(DIM), row_dim=ROW_DIM,
        device="cuda")
    ops = exporter.OpsServer(port=0)
    srv = serve.PredictionServer(model, ps=PSClient(svc.address, ROW_DIM),
                                 max_batch=256, drift=dm, device="cuda")
    cli = serve.PredictClient(srv.address)
    try:
        if dm.monitor is not srv.health:
            raise AssertionError("serve drift: the monitor is not bound to "
                                 "the server's health monitor")
        t = time.perf_counter()
        serve_passes(np, cli, srv, requests, refs, "fm drift")
        same_s = time.perf_counter() - t
        drift_settled(dm, 1)
        same = dict(dm.last_scores)
        degraded = quality.DriftDetector().degraded
        if max(same.values()) >= degraded or \
                srv.health.verdict()["detectors"]["drift"]["status"] != \
                health.OK:
            raise AssertionError(f"serve drift: the same traffic scored "
                                 f"{same} (degraded at {degraded})")
        shifted = shifted_requests(np, requests, seed)
        for _ in range(2):
            for r in shifted:
                scores = cli.predict(r)
                if not np.all(np.isfinite(scores)):
                    raise AssertionError("serve drift: non-finite scores")
        drift_settled(dm, 3)
        verdict = srv.health.verdict()["detectors"]["drift"]
        if verdict["status"] == health.OK:
            raise AssertionError(f"serve drift: the shift did not trip the "
                                 f"detector: {verdict} {dm.last_scores}")
        url = f"http://{ops.address[0]}:{ops.address[1]}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                code, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        comp = body.get("components", {}).get(srv._flight_name, {})
        if code != 503 or comp.get("status") == health.OK:
            raise AssertionError(f"serve drift: /healthz {code} {comp}")
        return {"reference_frozen": True, "windows": dm.windows,
                "same_traffic_scores": same, "degraded_at": degraded,
                "shifted_scores": dict(dm.last_scores),
                "detector": verdict, "healthz_code": code,
                "healthz_status": comp.get("status"),
                "same_traffic_pass_s": same_s}
    finally:
        cli.close()
        srv.close()
        ops.close()


def phase_serve(np, torch, sk, seed, requests) -> dict:
    from lightctr_tpu_torch import serve
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

    t0 = time.perf_counter()
    params = make_params(np, seed)
    refs = [fm_forward64(np, params, r) for r in requests]
    keys, rows = serve.fused_fm_rows(params)
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=seed)
    svc = ParamServerService(store)
    admin = srv = cli = None
    try:
        admin = PSClient(svc.address, ROW_DIM)
        for lo in range(0, VOCAB, PRELOAD_CHUNK):
            admin.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                                 rows[lo:lo + PRELOAD_CHUNK])
        setup_s = time.perf_counter() - t0
        model = serve.ServingModel(
            "fm", {}, row_leaves=serve.fm_ps_row_leaves(DIM),
            row_dim=ROW_DIM, device="cuda")
        srv = serve.PredictionServer(
            model, ps=PSClient(svc.address, ROW_DIM), max_batch=256,
            device="cuda")
        cli = serve.PredictClient(srv.address)
        sk.reset_launches()
        passes, max_err = serve_passes(np, cli, srv, requests, refs, "fm")
        launches = sk.launches()
        cache, batches = check_served(srv, passes, launches, "fm")
        drift = serve_drift(np, serve, svc, requests, refs, seed)
    finally:
        for c in (cli, admin):
            if c is not None:
                c.close()
        if srv is not None:
            srv.close()
        svc.close()
    return {"phase": "serve", "model": "fm", "fields": N_FIELDS,
            "vocab": VOCAB, "factor_dim": DIM, "row_dim": ROW_DIM,
            "requests": N_REQUESTS, "request_rows": REQUEST_ROWS,
            "setup_s": setup_s, "passes": passes,
            "max_abs_score_err": max_err, "score_atol": SCORE_ATOL,
            "batches_scored": batches, "launches": launches,
            "cache": {k: cache[k] for k in ("entries", "capacity", "hits",
                                            "misses", "device_rows")},
            "drift": drift}


# -- phase: train -------------------------------------------------------------


def criteo_rows(np, rng, n, vocab=VOCAB) -> dict:
    """n synthetic Criteo rows in memory, data/synth.py's recipe: u^4
    head/tail ids, exponential numeric values (rounded to 3 digits), and a
    label planted as a logistic in two numeric fields plus a head-id
    effect."""
    fids = criteo_fids(np, rng, n, vocab)
    vals = np.ones((n, N_FIELDS), np.float32)
    vals[:, N_CAT:] = rng.exponential(
        1.0, (n, N_FIELDS - N_CAT)).astype(np.float32).round(3)
    z = ((vals[:, N_CAT] - 1.0) + (vals[:, N_CAT + 1] - 1.0)
         + (fids[:, 0] % 2).astype(np.float32) - 0.5)
    p = 1.0 / (1.0 + np.exp(-2.0 * z))
    labels = (rng.random(n) < p).astype(np.float32)
    return {"fids": fids, "vals": vals,
            "mask": np.ones((n, N_FIELDS), np.float32), "labels": labels}


def train_params(np, seed, vocab=VOCAB):
    """FM's init at Criteo width from a seed (fm_algo_abst.h:53-67): W
    zero, V ~ N(0, 1/k)."""
    rng = np.random.default_rng(seed + 3)
    v = rng.standard_normal((vocab, DIM), dtype=np.float32)
    return {"w": np.zeros(vocab, np.float32),
            "v": v * np.float32(1.0 / np.sqrt(DIM))}


def flat_leaves(tree, prefix="") -> dict:
    """{"a/b": leaf} of a nested dict (the export's flattened names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def run_steps(torch, tr, batches, snapshots=()):
    """Step ``tr`` over ``batches``; returns the loss tensors, device
    clones of every parameter leaf (flattened names: FM's w and v) after
    each step count in ``snapshots``, the synchronised wall time of the
    steps after the warm-up, and the median host time to launch one such
    step."""
    losses, snaps, host = [], {}, []
    t0 = None
    for i, b in enumerate(batches):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        th = time.perf_counter()
        losses.append(tr.train_step(b))
        if i >= WARMUP_STEPS:
            host.append(time.perf_counter() - th)
        if i + 1 in snapshots:
            snaps[i + 1] = {k: v.clone()
                            for k, v in flat_leaves(tr.params).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return losses, snaps, wall, statistics.median(host)


def cpu_rerun(np, torch, trainer_cls, params, batches, **kw):
    """The same steps on the CPU at full width, with the plain versions."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm

    tr = trainer_cls(fm.params_from_numpy(params, "cpu"), fm.logits,
                     TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
                     fused_fn=fm.logits_with_l2, device="cpu", **kw)
    tr.health = None
    losses = [float(tr.train_step(b)) for b in batches]
    return losses, tr.params


def compare_rows(np, torch, got, want, ids, what) -> float:
    """Rows ``ids`` of (w, v) within TRAIN_RTOL / TRAIN_ATOL; returns the
    max abs error."""
    idx = torch.from_numpy(np.unique(ids).astype(np.int64))
    err = 0.0
    for k in ("w", "v"):
        a = got[k].cpu().index_select(0, idx)
        b = want[k].cpu().index_select(0, idx)
        if not torch.allclose(a, b, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"{what}: {k} rows differ, max abs "
                                 f"{float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    return err


def profile_sparse_steps(torch, tr, batches) -> dict:
    """Device time by kernel over a few sparse steps."""
    return profile_calls(torch, [lambda b=b: tr.train_step(b)
                                 for b in batches])


class NoDeviceTime(AssertionError):
    """A torch.profiler session recorded no device time."""


def profile_calls(torch, calls) -> dict:
    """Device time by kernel over ``calls``, each a step (torch.profiler).
    The device's idle share rests on it, so a profile that shows no
    device time fails the phase (NoDeviceTime)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies), not the CPU ops that
        # launched them nor the annotations' device ranges, each of which
        # would count the same kernels again
        if (str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and "/" not in e.key):
            dev_us = getattr(e, "self_device_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
    if not rows:
        raise NoDeviceTime("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"steps": len(calls), "profiled_wall_ms": wall_ms,
            "device_ms_per_step": busy_ms / len(calls),
            "device_ops_per_step": sum(r[2] for r in rows) / len(calls),
            "top": [{"name": k[:60], "ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:14]]}


def launch_profile(torch, fn, calls: int = 20):
    """Device time by kernel over ``calls`` calls of ``fn``: a kernel row's
    per-launch breakdown, which gates nothing.  ``None`` when the session
    recorded no device time.  On the card torch.profiler loses the first
    device records of such a session (its ``calls`` per kernel fall short
    of the launches), and once lost all of them; the cause is not known,
    so the per-launch times are averages over the records kept."""
    try:
        return profile_calls(torch, [fn] * calls)
    except NoDeviceTime:
        return None


def sparse_expected_launches(sk, steps) -> dict:
    """Launches of ``steps`` one-card steps of the sparse trainer on FM:
    the id stream deduped, and per table (w, v) the gather's backward
    (merge_rows, ``embed.table.lookup``) and the touched-row apply
    (merge_apply's apply mode)."""
    want = dict.fromkeys(sk.KERNELS, 0)
    want.update(dedup_ids=steps, merge_rows=2 * steps,
                merge_apply=2 * steps)
    return want


def dense_expected_launches(sk, steps, fused=False) -> dict:
    """Launches of ``steps`` steps of CTRTrainer on FM: per table the
    gather's backward over the whole table (merge_rows at S = 2^20), and
    with ``fused`` the fused Adagrad apply a leaf."""
    want = dict.fromkeys(sk.KERNELS, 0)
    want.update(merge_rows=2 * steps,
                fused_adagrad=2 * steps if fused else 0)
    return want


def phase_train(np, torch, sk, seed) -> dict:
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    t_setup = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    data = criteo_rows(np, rng, SPARSE_STEPS * TRAIN_BATCH)
    held_out = criteo_rows(np, rng, EVAL_ROWS)
    batches = [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                for k, v in data.items()} for i in range(SPARSE_STEPS)]
    params = train_params(np, seed)
    cfg = TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2)
    tables = {"w": ["fids"], "v": ["fids"]}
    setup_s = time.perf_counter() - t_setup

    # (a) the O(touched) sparse trainer
    sparse = SparseTableCTRTrainer(
        fm.params_from_numpy(params, "cuda"), fm.logits, cfg,
        sparse_tables=tables, fused_fn=fm.logits_with_l2, device="cuda")
    sk.reset_launches()
    s_losses, s_snaps, s_wall, s_host = run_steps(
        torch, sparse, batches,
        snapshots=(CPU_SPARSE_STEPS, PARITY_STEPS, SPARSE_STEPS))
    s_launch = sk.launches()
    s_losses = [float(x) for x in s_losses]
    # per step: one dedup, and per table the gather's backward (merge_rows)
    # and the touched-row apply (merge_apply)
    if s_launch != sparse_expected_launches(sk, SPARSE_STEPS):
        raise AssertionError(f"sparse trainer launches {s_launch} over "
                             f"{SPARSE_STEPS} steps")
    if not all(np.isfinite(s_losses)) or \
            np.mean(s_losses[-5:]) >= np.mean(s_losses[:5]):
        raise AssertionError(f"sparse trainer loss did not fall: {s_losses}")
    ev = sparse.evaluate(held_out, batch_size=TRAIN_BATCH)
    if not ev["auc"] > MIN_AUC:
        raise AssertionError(f"held-out AUC {ev['auc']} <= {MIN_AUC}")
    # untouched rows never move (the step is O(touched))
    seen = np.unique(data["fids"])
    untouched = np.setdiff1d(np.arange(VOCAB), seen)[:100000]
    ut = torch.from_numpy(untouched).cuda()
    if not torch.equal(sparse.params["v"].index_select(0, ut),
                       torch.from_numpy(params["v"]).cuda().index_select(
                           0, ut)):
        raise AssertionError("sparse trainer moved untouched rows")
    # the health feed's host share of the default step above: its touched-
    # id count (np.unique per id stream) alone, on the same batches
    t_sig = time.perf_counter()
    for b in batches[:5]:
        sparse._health_signals(b)
    signals_ms = 1e3 * (time.perf_counter() - t_sig) / 5
    # more steps with the health feed off
    sparse.health = None
    _, _, s_wall_nohealth, s_host_nohealth = run_steps(
        torch, sparse, batches[:20])
    prof = profile_sparse_steps(torch, sparse, batches[20:25])
    # the profiler's own start-up inflates its window: the idle share is
    # taken against the step time measured without it
    prof["idle_share_health_off"] = 1.0 - prof["device_ms_per_step"] / (
        1e3 * s_wall_nohealth / (20 - WARMUP_STEPS))

    # (b) the dense trainer with the fused Adagrad kernel
    fused = CTRTrainer(fm.params_from_numpy(params, "cuda"), fm.logits, cfg,
                       fused_fn=fm.logits_with_l2, fused_adagrad=True,
                       device="cuda")
    sk.reset_launches()
    f_losses, f_snaps, f_wall, f_host = run_steps(
        torch, fused, batches[:FUSED_STEPS],
        snapshots=(CPU_FUSED_STEPS, PARITY_STEPS))
    f_launch = sk.launches()
    f_losses = [float(x) for x in f_losses]
    if f_launch != dense_expected_launches(sk, FUSED_STEPS, fused=True):
        raise AssertionError(f"fused trainer launches {f_launch} over "
                             f"{FUSED_STEPS} steps")
    if not all(np.isfinite(f_losses)) or \
            np.mean(f_losses[-3:]) >= np.mean(f_losses[:3]):
        raise AssertionError(f"fused trainer loss did not fall: {f_losses}")

    # (c) cross-checks: the CPU's plain versions, and the two trainers
    t_cpu = time.perf_counter()
    c_losses, c_params = cpu_rerun(np, torch, SparseTableCTRTrainer, params,
                                   batches[:CPU_SPARSE_STEPS],
                                   sparse_tables=tables)
    cf_losses, cf_params = cpu_rerun(np, torch, CTRTrainer, params,
                                     batches[:CPU_FUSED_STEPS],
                                     fused_adagrad=True)
    cpu_s = time.perf_counter() - t_cpu
    for got, want, what in ((s_losses[:CPU_SPARSE_STEPS], c_losses,
                             "sparse"),
                            (f_losses[:CPU_FUSED_STEPS], cf_losses,
                             "fused")):
        if not np.allclose(got, want, rtol=TRAIN_RTOL, atol=0):
            raise AssertionError(f"{what} losses card {got} vs cpu {want}")
    err_sparse_cpu = compare_rows(
        np, torch, s_snaps[CPU_SPARSE_STEPS], c_params,
        data["fids"][:CPU_SPARSE_STEPS * TRAIN_BATCH], "sparse card vs cpu")
    err_fused_cpu = compare_rows(
        np, torch, f_snaps[CPU_FUSED_STEPS], cf_params,
        data["fids"][:CPU_FUSED_STEPS * TRAIN_BATCH], "fused card vs cpu")
    err_sparse_fused = compare_rows(
        np, torch, s_snaps[PARITY_STEPS], f_snaps[PARITY_STEPS],
        data["fids"][:PARITY_STEPS * TRAIN_BATCH],
        "sparse vs fused trainer on the card")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(s_losses[:CPU_SPARSE_STEPS] + f_losses[
                       :CPU_FUSED_STEPS], c_losses + cf_losses))
    steady = SPARSE_STEPS - WARMUP_STEPS

    # (d) both runs again with the resources and device planes armed
    del sparse, fused
    torch.cuda.empty_cache()
    armed = train_armed(np, torch, sk, params, batches, cfg, tables, {
        "sparse": (s_losses, s_snaps[SPARSE_STEPS], s_wall, SPARSE_STEPS),
        "fused": (f_losses, f_snaps[PARITY_STEPS], f_wall, FUSED_STEPS)})
    return {
        "phase": "train", "model": "fm", "fields": N_FIELDS, "vocab": VOCAB,
        "factor_dim": DIM, "batch": TRAIN_BATCH, "lr": LR,
        "lambda_l2": LAMBDA_L2, "setup_s": setup_s,
        "sparse": {
            "steps": SPARSE_STEPS, "launches": s_launch,
            "loss_first5": s_losses[:5], "loss_last5": s_losses[-5:],
            "heldout": ev, "heldout_rows": EVAL_ROWS,
            "examples_per_s": steady * TRAIN_BATCH / s_wall,
            "step_ms": 1e3 * s_wall / steady,
            "host_launch_ms": 1e3 * s_host,
            "health_signals_ms": signals_ms,
            "examples_per_s_health_off":
                (20 - WARMUP_STEPS) * TRAIN_BATCH / s_wall_nohealth,
            "step_ms_health_off":
                1e3 * s_wall_nohealth / (20 - WARMUP_STEPS),
            "host_launch_ms_health_off": 1e3 * s_host_nohealth,
            "distinct_ids_first_batch": int(np.unique(
                batches[0]["fids"]).size),
            "profile": prof,
        },
        "fused": {
            "steps": FUSED_STEPS, "launches": f_launch,
            "losses": f_losses,
            "examples_per_s":
                (FUSED_STEPS - WARMUP_STEPS) * TRAIN_BATCH / f_wall,
            "step_ms": 1e3 * f_wall / (FUSED_STEPS - WARMUP_STEPS),
            "host_launch_ms": 1e3 * f_host,
        },
        "cross_checks": {
            "cpu_steps": {"sparse": CPU_SPARSE_STEPS,
                          "fused": CPU_FUSED_STEPS},
            "cpu_seconds": cpu_s,
            "max_loss_rel_err_vs_cpu": loss_rel,
            "max_abs_err_sparse_vs_cpu": err_sparse_cpu,
            "max_abs_err_fused_vs_cpu": err_fused_cpu,
            "max_abs_err_sparse_vs_fused_10_steps": err_sparse_fused,
            "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
        },
        "armed": armed,
        "train_launches": {"dedup_ids": s_launch["dedup_ids"],
                           "merge_apply": s_launch["merge_apply"],
                           "merge_rows": s_launch["merge_rows"]
                           + f_launch["merge_rows"],
                           "fused_adagrad": f_launch["fused_adagrad"]},
    }


#: the port's kernels' symbol names as a profiler trace shows them
#: (csrc/*.cu and the headers they share)
KERNEL_SYMBOLS = ("make_keys", "rank_scatter", "radix_onesweep",
                  "seg_keys", "walk_runs", "walk_long", "apply_rows",
                  "sum_partials", "gather_rows_kernel", "adagrad_vec4",
                  "adagrad_scalar", "ef_pack", "ef_update", "flash_")
PROFILEZ_STEPS = 3


def http_json(url, method="GET"):
    """(status, JSON body) of one request to the ops server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def detector_status(body, component, detector):
    comp = (body.get("components") or {}).get(component) or {}
    return ((comp.get("detectors") or {}).get(detector) or {}).get("status")


def trace_kernels(path) -> list:
    """The kernel names of a Chrome trace that are the port's kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"][:80] for e in events
                   if e.get("cat") == "kernel"
                   and any(k in e.get("name", "") for k in KERNEL_SYMBOLS)})


def armed_trainer(params, cfg, name, tables):
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    kw = dict(fused_fn=fm.logits_with_l2, device="cuda", resources=True,
              device_telemetry=True)
    if name == "sparse":
        return SparseTableCTRTrainer(fm.params_from_numpy(params, "cuda"),
                                     fm.logits, cfg, sparse_tables=tables,
                                     **kw)
    return CTRTrainer(fm.params_from_numpy(params, "cuda"), fm.logits, cfg,
                      fused_adagrad=True, **kw)


def armed_checks(np, torch, sk, tr, batches, ops, state) -> dict:
    """On the armed sparse trainer: a census budget below trainer_state
    trips hbm_pressure on /healthz (and one above it recovers);
    ``POST /profilez`` is refused while another torch.profiler session
    runs, then captures the next steps into a trace holding the port's
    kernels; ``verify_donation`` on B5's in-place apply is clean and a
    copying control trips donation_miss."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.obs import device as obs_device
    from lightctr_tpu_torch.obs import health

    base = f"http://{ops.address[0]}:{ops.address[1]}"
    comp = tr.health.component
    out = {}
    cen = tr.device_census
    _, body = http_json(base + "/healthz")
    before = detector_status(body, comp, "hbm_pressure")
    cen.set_budget("trainer_state", state / 2)
    cen.sample()
    code, body = http_json(base + "/healthz")
    tripped = detector_status(body, comp, "hbm_pressure")
    cen.set_budget("trainer_state", state * 4)
    cen.sample()
    _, body = http_json(base + "/healthz")
    after = detector_status(body, comp, "hbm_pressure")
    if before == health.UNHEALTHY or code != 503 or \
            tripped != health.UNHEALTHY or after != health.OK:
        raise AssertionError(f"hbm_pressure: {before} -> {code} "
                             f"{tripped} -> {after}")
    out["hbm_pressure"] = {"budget_bytes": state / 2, "healthz": code,
                           "tripped": tripped, "recovered": after}

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        busy, bbody = http_json(base + f"/profilez?steps={PROFILEZ_STEPS}",
                                "POST")
    code, body = http_json(base + f"/profilez?steps={PROFILEZ_STEPS}",
                           "POST")
    if busy != 409 or bbody.get("refused") != "busy" or code != 200:
        raise AssertionError(f"/profilez: {busy} {bbody} then {code} "
                             f"{body}")
    for b in batches[:PROFILEZ_STEPS + 1]:  # the start boundary + N steps
        tr.train_step(b)
    caps = obs_device.profile_trigger().payload()["captures"]
    if len(caps) != 1 or not caps[0]["trace"]:
        raise AssertionError(f"/profilez: captures {caps}")
    kernels = trace_kernels(caps[0]["trace"])
    if not kernels:
        raise AssertionError("/profilez: the trace holds none of the "
                             "port's kernels")
    out["profilez"] = {"refused_while_busy": busy, "armed": code,
                       "steps": PROFILEZ_STEPS, "files": caps[0]["files"],
                       "port_kernels_in_trace": kernels}

    hm = health.HealthMonitor(component="chip_smoke_donation",
                              registry=obs.MetricsRegistry(),
                              flight_min_interval_s=0.0)
    watch = obs_device.DonationWatch(registry=hm.registry, monitor=hm,
                                     register=False)

    def apply(table, accum, uids, g):
        return sk.merge_apply(table, accum, uids, g, lr=LR, eps=EPS)

    def copy(table, accum, uids, g):
        return apply(table.clone(), accum.clone(), uids, g)

    ok = obs_device.verify_donation("merge_apply", apply,
                                    donate_argnums=(0, 1), watch=watch,
                                    sample_every=1)
    bad = obs_device.verify_donation("merge_apply_copy", copy,
                                     donate_argnums=(0, 1), watch=watch,
                                     sample_every=1)
    ids = torch.from_numpy(batches[0]["fids"].reshape(-1)).cuda()
    uids, _, _ = sk.dedup_ids(ids)
    g = torch.randn((uids.numel(), DIM), device="cuda") * 0.01
    for f in (ok, bad):
        with obs.override(True):
            f(tr.params["v"].clone(), tr.opt_state["accum"]["v"].clone(),
              uids, g)
    progs = watch.snapshot()["programs"]
    det = hm.verdict()["detectors"]["donation_miss"]
    hm.close()
    if progs != {"merge_apply": {"checks": 1, "misses": 0},
                 "merge_apply_copy": {"checks": 1, "misses": 1}} or \
            det["status"] != health.DEGRADED or \
            det["detail"]["worst_program"] != "merge_apply_copy":
        raise AssertionError(f"verify_donation: {progs}, {det}")
    out["donation"] = {"programs": progs, "detector": det["status"]}
    return out


def train_armed(np, torch, sk, params, batches, cfg, tables, unarmed):
    """The train phase's sparse (50 steps) and fused (10) runs again with
    ``resources=True, device_telemetry=True``: losses and tables bit for
    bit the unarmed runs', the same launches; the tracker one signature
    and no recompile_storm; the catalog's trainer_step FLOPs, bytes and
    utilization against the card's peak (``peak_spec``); the census'
    trainer_state bytes exactly the params' and optimizer state's; then
    ``armed_checks`` on the sparse trainer."""
    from lightctr_tpu_torch.obs import device as obs_device
    from lightctr_tpu_torch.obs import exporter, health

    root = tempfile.mkdtemp(prefix="chip_smoke_armed_")
    obs_device.reset_profile_trigger()
    obs_device.profile_trigger(base_dir=root, min_interval_s=0.0)
    ops = exporter.OpsServer(port=0)
    out = {}
    try:
        for name in ("sparse", "fused"):
            want_l, want_snap, want_wall, steps = unarmed[name]
            tr = armed_trainer(params, cfg, name, tables)
            sk.reset_launches()
            losses, snaps, wall, host = run_steps(
                torch, tr, batches[:steps], snapshots=(steps,))
            launches = sk.launches()
            losses = [float(x) for x in losses]
            plan = (sparse_expected_launches(sk, steps) if name == "sparse"
                    else dense_expected_launches(sk, steps, fused=True))
            if losses != want_l or launches != plan or not all(
                    torch.equal(snaps[steps][k], want_snap[k])
                    for k in ("w", "v")):
                raise AssertionError(f"armed {name}: not the unarmed run "
                                     f"(launches {launches})")
            tr.resources.poll()
            fns = tr.resources.snapshot()["fns"]
            storm = tr.health.verdict()["detectors"].get(
                "recompile_storm", {}).get("status")
            if fns["trainer_step"]["cache_entries"] != 1 or \
                    storm not in (None, health.OK):
                raise AssertionError(f"armed {name}: signatures {fns}, "
                                     f"recompile_storm {storm}")
            ana = tr.device_catalog.analyze()["trainer_step"]
            prog = tr.device_catalog.snapshot()["programs"]["trainer_step"]
            kind = torch.cuda.get_device_name(0)
            peak = obs_device.peak_spec(kind)
            steady = steps - WARMUP_STEPS
            step_s = wall / steady
            state = sum(t.numel() * t.element_size()
                        for t in obs_device.tensor_leaves(
                            (tr.params, tr.opt_state)))
            cen = tr.device_census.sample()
            if cen["tags"]["trainer_state"]["bytes"] != state or \
                    not ana.get("available") or not ana["flops"] > 0:
                raise AssertionError(f"armed {name}: census {cen['tags']} "
                                     f"for {state} state bytes; {ana}")
            out[name] = {
                "steps": steps, "losses_bit_identical": True,
                "tables_bit_identical": True, "launches": launches,
                "step_ms": 1e3 * step_s,
                "unarmed_step_ms": 1e3 * want_wall / steady,
                "armed_minus_unarmed_step_ms":
                    1e3 * (wall - want_wall) / steady,
                "signatures": fns, "recompile_storm": storm or health.OK,
                "trainer_step": {
                    "flops": ana["flops"],
                    "bytes_accessed": ana["bytes_accessed"],
                    "intensity": ana.get("intensity"),
                    "library": ana["library"], "kernels": ana["kernels"],
                    "memory": ana["memory"],
                    "device_kind": kind, "peak": peak,
                    "peak_precision": obs_device.PEAK_PRECISION,
                    "utilization_at_step_ms":
                        None if peak is None
                        else ana["flops"] / step_s / peak[0],
                    "bandwidth_utilization_at_step_ms":
                        None if peak is None
                        else ana["bytes_accessed"] / step_s / peak[1],
                    "catalog_ewma_s": prog["ewma_seconds"],
                    "catalog_utilization": prog["utilization"]},
                "census": {"trainer_state_bytes":
                           cen["tags"]["trainer_state"]["bytes"],
                           "params_plus_state_bytes": state,
                           "untagged_bytes": cen["untagged_bytes"],
                           "total_bytes": cen["total_bytes"]},
            }
            if name == "sparse":
                out["checks"] = armed_checks(np, torch, sk, tr, batches, ops,
                                             state)
            for c in (tr.resources, tr.device_catalog, tr.device_census):
                c.close()
            del tr
            torch.cuda.empty_cache()
    finally:
        ops.close()
        obs_device.reset_profile_trigger()
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- phase: dp ----------------------------------------------------------------

#: (name, trainer kwargs, steps) of the dp phase's runs
DP_RUNS = (
    ("exact", {}, SPARSE_STEPS),
    ("coded_dynamic", {"compress_bits": 8, "compress_range": "dynamic"}, 10),
    ("coded_ef", {"compress_bits": 8}, 10),
)
DP_CPU_STEPS = 2            # exact steps re-run at W = 2 on the CPU
DP_LOSS_GAP = 0.05          # tests/test_sparse_exchange.py's coded bound
#: the coded runs re-run whole on the CPU: their losses on the card within
#: this relative distance of the plain versions' at every step
DP_CODED_RTOL = 1e-3
#: share of the touched values of a coded run that may differ between the
#: card and the CPU past TRAIN_RTOL / TRAIN_ATOL: one code bucket can
#: separate them where the two devices' gradients differ in the last ulp
#: next to a boundary
DP_CODE_FLIP_SHARE = 1e-3
DP_DEADLINE_S = 600.0


def dp_data(np, seed):
    """The train phase's batches and held-out rows (the same seed)."""
    rng = np.random.default_rng(seed + 2)
    data = criteo_rows(np, rng, SPARSE_STEPS * TRAIN_BATCH)
    held_out = criteo_rows(np, rng, EVAL_ROWS)
    return [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
             for k, v in data.items()} for i in range(SPARSE_STEPS)], held_out


def dp_runs(phase) -> tuple:
    """(name, kind, trainer, kwargs, steps, lr) of a data-parallel phase's
    runs: ``dp``'s FM through the hybrid exchange (DP_RUNS), or
    DP_DEEP_RUNS."""
    if phase == "dp":
        return tuple((name, "fm", "sparse", kw, steps, LR)
                     for name, kw, steps in DP_RUNS)
    return DP_DEEP_RUNS


def dp_rank(rank, world, out_dir, seed, device, run_steps, phase="dp"):
    """One rank of the ``dp`` phase (FM) or of ``dp_deep`` (DeepFM, DCN):
    each run of ``dp_runs(phase)`` named in ``run_steps`` ({name: steps})
    trains at Criteo width from the seed's init on the phase's global
    batches (this rank takes its rows), launches counted from just before
    its first step to just after its last; writes losses, launches, the
    replicated state's digests, a snapshot of the rows the first CPU steps
    touched (rank 0), and on the card rank 0's profile of the phase's
    profiled run; ``dp``: rank 0's held-out evaluation of the whole exact
    run; ``dp_deep``: each coded run's step repeated from one state."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.ops import sparse_kernels as sk
    from lightctr_tpu_torch.optim.updaters import tree_map

    mesh = make_mesh(MeshSpec(data=world), device=device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(mesh.device)

    def sync():
        if on_card:
            torch.cuda.synchronize(mesh.device)

    if phase == "dp":
        batches, held_out = dp_data(np, seed)
        cpu_steps, profiled, profile_steps = DP_CPU_STEPS, "exact", 5
    else:
        # train_deep's batches: the first steps of its runs on one card
        batches = deep_batches(np, seed, max(r[3] for r in DEEP_TRAIN_RUNS))
        held_out = None
        cpu_steps, profiled, profile_steps = (
            DP_DEEP_CPU_STEPS, "deepfm_sparse_exact", DP_DEEP_PROFILE_STEPS)
    base = train_params(np, seed)
    snap_ids = torch.from_numpy(np.unique(np.concatenate(
        [b["fids"].reshape(-1) for b in batches[:cpu_steps]])).astype(
            np.int64)).to(mesh.device)
    out = {}
    for name, kind, mode, kw, full, lr in dp_runs(phase):
        if name not in run_steps:
            continue
        steps = run_steps[name]
        params = base if kind == "fm" else deep_params(
            np, seed, kind, base["w"], base["v"])
        tr = deep_trainer(kind, mode, params, device, lr, mesh=mesh,
                          **dict(kw))
        del params
        sync()
        dist.barrier()
        sk.reset_launches()
        losses, t0 = [], None
        for i, b in enumerate(batches[:steps]):
            if i == WARMUP_STEPS:
                sync()
                t0 = time.perf_counter()
            losses.append(tr.train_step(b))
            if i + 1 == cpu_steps and rank == 0:
                torch.save(deep_snapshot(tr, snap_ids, KIND_TABLES[kind]),
                           os.path.join(out_dir, f"snap_{name}.pt"))
        sync()
        wall = time.perf_counter() - t0 if t0 is not None else None
        rec = {"steps": steps, "losses": [float(x) for x in losses],
               "launches": sk.launches(),
               "merge_apply_variants": sk.variant_launches("merge_apply"),
               "quantize_pack_variants":
                   sk.variant_launches("quantize_pack"),
               "ef_update_variants":
                   sk.variant_launches("quantize_pack_ef_update"),
               "device": str(mesh.device), "backend": mesh.backend}
        if mode == "sparse":
            rec["policy"] = dict(tr.exchange_policy)
            rec["bytes_per_step"] = dict(tr.exchange_bytes_per_step)
        if wall is not None:
            rec["steady_steps"] = steps - WARMUP_STEPS
            rec["steady_wall_s"] = wall
        if held_out is not None and name == "exact" and steps == full \
                and rank == 0:
            rec["heldout"] = tr.evaluate(held_out, batch_size=TRAIN_BATCH)
        if on_card and name == profiled and steps == full:
            # rank 0's steps under the profiler, the other rank alongside
            # for the collectives
            if rank == 0:
                rec["profile"] = profile_sparse_steps(
                    torch, tr, batches[:profile_steps])
            else:
                for b in batches[:profile_steps]:
                    tr.train_step(b)
                sync()
        # the replicated state (each rank's EF residuals are its own)
        rec["digest"] = state_digest(tr)
        if on_card and phase == "dp_deep" and kw:
            # one step from one state, twice: every leaf bit-identical,
            # each rank's EF residuals included
            saved = tree_map(torch.clone, (tr.params, tr.opt_state))
            digests = []
            for _ in range(2):
                tr.params, tr.opt_state = tree_map(torch.clone, saved)
                tr.train_step(batches[0])
                digests.append(state_digest(tr, replicated=False))
            rec["repeat_step_bit_identical"] = digests[0] == digests[1]
            del saved
        out[name] = rec
        del tr
        if on_card:
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_expected_launches(name, steps) -> dict:
    """Launches one rank makes in ``steps`` steps of run ``name``: two
    id streams deduped (local and gathered), each table's gather
    differentiated (merge_rows, the backward of ``embed.table.lookup``),
    two tables merged and applied (merge_apply's fused merge mode), and
    each table's payload coded once in the coded runs."""
    return {"dedup_ids": 2 * steps, "merge_rows": 2 * steps,
            "merge_apply": 2 * steps,
            "quantize_pack": 2 * steps if name == "coded_dynamic" else 0,
            "quantize_pack_ef_update": 2 * steps if name == "coded_ef" else 0,
            "gather_rows": 0, "fused_adagrad": 0}


def phase_dp(np, torch, sk, seed) -> dict:
    """FM at Criteo width trained data-parallel by SparseTableCTRTrainer
    over DP_WORLD gloo ranks on the one card, its first steps re-run on
    the CPU, and one step at W = 1 over NCCL."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world

    names = tuple(name for name, _, _ in DP_RUNS)
    card_steps = {name: steps for name, _, steps in DP_RUNS}
    cpu_steps = dict(card_steps, exact=DP_CPU_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dirs = {k: os.path.join(root, k) for k in ("card", "cpu", "nccl")}
        for d in dirs.values():
            os.makedirs(d)
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["card"], seed, "cuda", card_steps))
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["cpu"], seed, "cpu", cpu_steps))
        cpu_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rank, 1, "nccl", deadline_s=DP_DEADLINE_S,
                    args=(dirs["nccl"], seed, "cuda", {"coded_ef": 1}))
        nccl_s = time.perf_counter() - t
        load = lambda d, r: json.load(open(os.path.join(d, f"rank{r}.json")))
        card = [load(dirs["card"], r) for r in range(DP_WORLD)]
        cpu = load(dirs["cpu"], 0)
        nccl = load(dirs["nccl"], 0)["coded_ef"]
        batches, _ = dp_data(np, seed)
        snap_ids = np.unique(np.concatenate(
            [b["fids"].reshape(-1) for b in batches[:DP_CPU_STEPS]]))
        runs = {}
        for name in names:
            recs = [c[name] for c in card]
            steps = recs[0]["steps"]
            want = dp_expected_launches(name, steps)
            for r, rec in enumerate(recs):
                got = {k: rec["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"dp {name} rank {r}: launches "
                                         f"{got}, expected {want}")
                if rec["merge_apply_variants"] != {
                        "merge": want["merge_apply"]}:
                    raise AssertionError(
                        f"dp {name} rank {r}: merge_apply ran "
                        f"{rec['merge_apply_variants']}, not only its "
                        "fused merge mode")
                want_qp = ({"tree": want["quantize_pack"]}
                           if want["quantize_pack"] else {})
                if rec["quantize_pack_variants"] != want_qp:
                    raise AssertionError(
                        f"dp {name} rank {r}: quantize_pack ran "
                        f"{rec['quantize_pack_variants']}, not {want_qp}")
                want_ef = ({"tree": want["quantize_pack_ef_update"]}
                           if want["quantize_pack_ef_update"] else {})
                if rec["ef_update_variants"] != want_ef:
                    raise AssertionError(
                        f"dp {name} rank {r}: quantize_pack_ef_update ran "
                        f"{rec['ef_update_variants']}, not {want_ef}")
                if rec["policy"] != {"w": "sparse", "v": "sparse"}:
                    raise AssertionError(f"dp {name}: policy "
                                         f"{rec['policy']}")
                if rec["digest"] != recs[0]["digest"]:
                    raise AssertionError(f"dp {name}: rank {r}'s state is "
                                         "not bit-identical to rank 0's")
            losses = recs[0]["losses"]
            head = 5 if steps >= 20 else 3
            if not all(np.isfinite(losses)) or \
                    np.mean(losses[-head:]) >= np.mean(losses[:head]):
                raise AssertionError(f"dp {name}: loss did not fall "
                                     f"{losses}")
            cpu_losses = cpu[name]["losses"]
            rtol = TRAIN_RTOL if name == "exact" else DP_CODED_RTOL
            if not np.allclose(losses[:len(cpu_losses)], cpu_losses,
                               rtol=rtol, atol=0):
                raise AssertionError(f"dp {name}: losses card "
                                     f"{losses[:len(cpu_losses)]} vs cpu "
                                     f"{cpu_losses}")
            got_snap = torch.load(os.path.join(dirs["card"],
                                               f"snap_{name}.pt"))
            want_snap = torch.load(os.path.join(dirs["cpu"],
                                                f"snap_{name}.pt"))
            max_abs, off = 0.0, 0
            for k in ("w", "v"):
                a, b = got_snap[k], want_snap[k]
                max_abs = max(max_abs, float((a - b).abs().max()))
                off += int((~torch.isclose(a, b, rtol=TRAIN_RTOL,
                                           atol=TRAIN_ATOL)).sum())
            total = sum(got_snap[k].numel() for k in ("w", "v"))
            if name == "exact" and off:
                raise AssertionError(f"dp exact: {off} touched values differ "
                                     f"card vs cpu, max abs {max_abs}")
            if off > DP_CODE_FLIP_SHARE * total:
                raise AssertionError(f"dp {name}: {off} of {total} touched "
                                     f"values differ card vs cpu")
            runs[name] = {
                "steps": steps, "launches_per_rank": want,
                "loss_first": losses[:head], "loss_last": losses[-head:],
                "cpu_steps": len(cpu_losses),
                "loss_rel_err_vs_cpu": max(
                    abs(a - b) / abs(b) for a, b in
                    zip(losses, cpu_losses)),
                "touched_values": total, "touched_off_tolerance": off,
                "max_abs_err_vs_cpu": max_abs,
                "bytes_per_step": recs[0]["bytes_per_step"],
                "ranks_bit_identical": True}
            if "steady_wall_s" in recs[0]:
                steady = recs[0]["steady_steps"]
                runs[name]["step_ms"] = 1e3 * recs[0]["steady_wall_s"] / steady
                runs[name]["examples_per_s_gloo_host_staged"] = (
                    steady * TRAIN_BATCH / recs[0]["steady_wall_s"])
            if "profile" in recs[0]:
                prof = recs[0]["profile"]
                prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / \
                    runs[name]["step_ms"]
                runs[name]["profile_rank0"] = prof
        ev = card[0]["exact"]["heldout"]
        if not ev["auc"] > MIN_AUC:
            raise AssertionError(f"dp exact: held-out AUC {ev['auc']} <= "
                                 f"{MIN_AUC}")
        # the coded runs' final loss against the exact run's at the same
        # step.  The dynamic range stays within DP_LOSS_GAP; the fixed range
        # 1.0 with error feedback does not at this width, in the JAX package
        # as in the port (tools/torch_dp_loss_gap.py, PERF.md): its gap is
        # reported and the run is held to the CPU's plain versions above
        exact = card[0]["exact"]["losses"]
        for name in ("coded_dynamic", "coded_ef"):
            coded = card[0][name]["losses"]
            gap = abs(coded[-1] - exact[len(coded) - 1])
            runs[name]["final_loss_gap_vs_exact"] = gap
            runs[name]["final_loss_gap_vs_exact_cpu"] = abs(
                cpu[name]["losses"][-1] - card[0]["exact"]["losses"][
                    len(coded) - 1])
            if name == "coded_dynamic" and not gap < DP_LOSS_GAP:
                raise AssertionError(f"dp {name}: final loss {coded[-1]} vs "
                                     f"exact {exact[len(coded) - 1]}")
        want = dp_expected_launches("coded_ef", 1)
        got = {k: nccl["launches"].get(k, 0) for k in want}
        if got != want or nccl["merge_apply_variants"] != {
                "merge": want["merge_apply"]} or not np.isfinite(nccl["losses"][0]) or \
                nccl["backend"] != "nccl" or not nccl["device"].startswith(
                    "cuda"):
            raise AssertionError(f"dp nccl W=1: {nccl}")
        launches = {k: sum(card[0][n]["launches"].get(k, 0) for n in names)
                    for k in sk.KERNELS}
        merge_variants = {"merge": sum(
            card[0][n]["merge_apply_variants"].get("merge", 0)
            for n in names)}
        qp_variants = {"tree": sum(
            card[0][n]["quantize_pack_variants"].get("tree", 0)
            for n in names)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "dp", "model": "fm", "world": DP_WORLD,
            "backend": "gloo (host-staged), all ranks on cuda:0",
            "batch": TRAIN_BATCH, "local_rows": DP_LOCAL_ROWS,
            "local_k": DP_LOCAL_K, "vocab": VOCAB, "factor_dim": DIM,
            "runs": runs, "heldout": ev, "heldout_rows": EVAL_ROWS,
            "nccl_w1": {"loss": nccl["losses"][0],
                        "launches": nccl["launches"], "device": nccl["device"]},
            "seconds": {"card_world": card_s, "cpu_world": cpu_s,
                        "nccl_world": nccl_s},
            "dp_launches_rank0": launches,
            "dp_merge_apply_variants_rank0": merge_variants,
            "dp_quantize_pack_variants_rank0": qp_variants}


# -- phase: dp_rs -------------------------------------------------------------

#: what (b)'s card-versus-CPU gap is held beside: the JAX package parting
#: from ITSELF when only the order of FM's sums over fields changes (the
#: fields' columns permuted), measured on the CPU by
#: tests/test_torch_dp_trainer.py::test_jax_coded_dynamic_range_parts_under_a_field_reorder
#: (4 ranks, vocab 16,384, 39 fields, dim 32, 1,024 rows, 6 steps): the
#: largest relative loss gap of the exact and of the 8-bit measured-range
#: exchange, and the coded run's largest table gap
JAX_REORDER_GAP = {
    "test": "tests/test_torch_dp_trainer.py::"
            "test_jax_coded_dynamic_range_parts_under_a_field_reorder",
    "exact_loss_rel": 3.175e-7, "coded_loss_rel": 3.286e-4,
    "coded_table_max_abs": 0.0646}
RS_VOCAB = 1 << 16          # docs/SPARSE_EXCHANGE.md's middle band
RS_WORLD = 8
RS_LOCAL_ROWS = TRAIN_BATCH // RS_WORLD
RS_LOCAL_K = RS_LOCAL_ROWS * N_FIELDS   # ids one rank dedups a step: 19,968
#: (name, trainer kwargs, steps) of the dp_rs phase's runs; ``fallback``
#: steps a batch whose ids all lie on one owner
RS_RUNS = (
    ("exact", {}, 20),
    ("coded_dynamic", {"compress_bits": 8, "compress_range": "dynamic"}, 10),
    ("coded_ef", {"compress_bits": 8}, 10),
    ("fallback", {}, 3),
)
RS_CPU_STEPS = 2            # exact steps re-run at W = 8 on the CPU
RS_PROFILE_STEPS = 5
RS_DEADLINE_S = 900.0
#: tools/sparse_ring_bench.py's rs-grid cells whose pick at 8 ranks is the
#: reduce-scatter: vocabulary, dim, densities
RS_GRID = (2048, 16, (0.25, 0.5))
RS_GRID_RTOL, RS_GRID_ATOL = 1e-5, 1e-6   # the JAX bench's oracle bound
#: the coded exchanges ``sparse_reduce_scatter`` makes on the path's
#: shapes in both worlds, on the same inputs: (b)'s dynamic 8-bit codes
#: and (c)'s fixed-range codes with the stage-1 carry
RS_EXCHANGES = {
    "coded_dynamic": {"compress_bits": 8, "compress_range": "dynamic",
                      "compress_mode": "normal"},
    "coded_ef": {"compress_bits": 8, "compress_range": 1.0,
                 "compress_mode": "normal", "residual": True},
}


def rs_data(np, seed):
    """The dp_rs phase's global batches at vocabulary RS_VOCAB, and the
    skewed batch: the first batch's ids moved onto multiples of the world,
    so every id lies on owner 0 and the reduce-scatter would overflow."""
    rng = np.random.default_rng(seed + 7)
    steps = max(s for _, _, s in RS_RUNS)
    data = criteo_rows(np, rng, steps * TRAIN_BATCH, RS_VOCAB)
    batches = [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                for k, v in data.items()} for i in range(steps)]
    skewed = dict(batches[0])
    skewed["fids"] = (np.maximum(skewed["fids"] // RS_WORLD, 1)
                      * RS_WORLD).astype(np.int32)
    return batches, skewed


def rs_grid_inputs(np, seed, density):
    """(uids [W, k], rows [W, k, dim]) of one rs-grid cell, the JAX
    bench's recipe: each rank's sorted unique ids of k draws from [1,
    vocab), padded with id 0 and zero rows."""
    vocab, dim, _ = RS_GRID
    rng = np.random.default_rng(seed + 8 + int(100 * density))
    k = max(1, int(vocab * density))
    uids = np.zeros((RS_WORLD, k), np.int32)
    rows = np.zeros((RS_WORLD, k, dim), np.float32)
    for m in range(RS_WORLD):
        u = np.unique(rng.integers(1, vocab, size=k))
        uids[m, :u.size] = u
        rows[m, :u.size] = rng.normal(size=(u.size, dim))
    return uids, rows


def rs_exchange_inputs(np, seed):
    """(uids [W, K], rows [W, K, 32]) at the dp_rs path's shapes: each
    rank's deduped ids of the first batch (id-0 padded, as the trainer
    dedups them) and gradient-sized rows, zero at the pads."""
    batches, _ = rs_data(np, seed)
    fids = batches[0]["fids"].reshape(-1)
    rng = np.random.default_rng(seed + 10)
    uids = np.zeros((RS_WORLD, RS_LOCAL_K), np.int32)
    rows = np.zeros((RS_WORLD, RS_LOCAL_K, DIM), np.float32)
    for m in range(RS_WORLD):
        u = np.unique(fids[m * RS_LOCAL_K:(m + 1) * RS_LOCAL_K])
        uids[m, :u.size] = u
        rows[m, :u.size] = 0.05 * rng.standard_normal((u.size, DIM))
    return uids, rows


def record_overflow(tr, slots):
    """Wrap ``tr``'s step so the third slot of each step's health vector
    (the reduce-scatter's overflow, summed over the ranks) lands in
    ``slots``, with the health feed off."""
    step = tr._step

    def recording(params, state, batch):
        out = step(params, state, batch)
        slots.append(out[3][2])
        return out

    tr._step = recording


def rs_expected_launches(sk, name, steps) -> dict:
    """Launches one rank makes in ``steps`` steps of dp_rs run ``name``,
    v on the reduce-scatter and w on the dense pick: the local id stream
    and the owner's bucket ids deduped, v's owner merge (merge_rows) and
    its apply on the gathered shards (merge_apply's apply mode); in the
    coded runs v's bucket encode (quantize_pack, or in the EF run
    quantize_pack_ef_update) and its shard encode, and w's coded dense
    ring, one encode a ring step (W a step).  The fallback dedups its
    gathered stream and merges in merge_apply's merge mode.  Every run
    differentiates each table's gather (merge_rows, the backward of
    ``embed.table.lookup``) once a step."""
    want = dict.fromkeys(sk.KERNELS, 0)
    want["dedup_ids"] = 2 * steps
    want["merge_apply"] = steps
    want["merge_rows"] = 2 * steps
    if name != "fallback":
        want["merge_rows"] += steps
    if name == "coded_dynamic":
        want["quantize_pack"] = (2 + RS_WORLD) * steps
    if name == "coded_ef":
        want["quantize_pack"] = (1 + RS_WORLD) * steps
        want["quantize_pack_ef_update"] = steps
    return want


def rs_path_inputs(np, torch, sk, rng):
    """One global batch's ids down the reduce-scatter's id path on one
    process: each rank's dedup (K = 19,968) and owner partition, owner 0's
    W received buckets (ring slot order), its id merge cut at the shard
    capacity, and every owner's shard end to end (``out_ids``)."""
    from lightctr_tpu_torch.dist import collectives as coll

    fids = criteo_fids(np, rng, TRAIN_BATCH, RS_VOCAB).reshape(-1)
    bucket, shard = coll.rs_default_caps(RS_WORLD, RS_LOCAL_K, RS_VOCAB)
    plans = []
    for m in range(RS_WORLD):
        u, _, _ = sk.dedup_ids(torch.from_numpy(
            fids[m * RS_LOCAL_K:(m + 1) * RS_LOCAL_K]).cuda())
        plans.append((u,) + coll.rs_owner_partition(u, RS_WORLD, bucket))
    shards, owner0 = [], None
    for r in range(RS_WORLD):
        all_ids = torch.stack([plans[(r - i) % RS_WORLD][3][r]
                               for i in range(RS_WORLD)])
        uniq, inv, _ = coll._rs_merge_ids(all_ids, shard)
        shards.append(uniq)
        if r == 0:
            owner0 = (all_ids.reshape(-1), uniq, inv)
    return {"bucket": bucket, "shard": shard, "local": plans[0],
            "owner0": owner0, "out_ids": torch.cat(shards)}


def check_rs_path(np, torch, sk, qz, rng) -> dict:
    """Each kernel of the dp_rs path against its plain version at that
    path's shapes: dedup_ids on owner 0's 25,960 bucket ids cut at the
    shard capacity 8,193 (bit-exact); merge_rows of the [25,960, 32]
    bucket rows into 8,193 segments, with zero and with coded padding
    rows (bit-exact); merge_apply's apply mode on the 65,544 gathered
    shard slots into a [65,536, 32] table, the foreign shards' leading
    id-0 pads holding non-zero rows it must skip (2 ulp); quantize_pack
    on the [8, 3,245, 32] buckets (bit-exact); quantize_pack_ef_update of
    one rank's [19,968, 32] rows into a [65,536, 32] carry (bit-exact)."""
    from lightctr_tpu_torch.dist import collectives as coll

    inp = rs_path_inputs(np, torch, sk, rng)
    all_ids, _, _ = inp["owner0"]
    shard = inp["shard"]
    got = sk.dedup_ids(all_ids, shard)
    torch.cuda.synchronize()
    want = sk.dedup_ids_plain(all_ids, shard)
    for a, b, what in zip(got, want, ("uids", "inv", "count")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"dp_rs dedup_ids kernel != plain ({what})")
    inv = got[1]
    m = all_ids.numel()
    gen = torch.Generator(device="cuda").manual_seed(43)
    pad = (all_ids == 0).to(torch.float32).reshape(-1, 1)
    rows = torch.randn((m, DIM), generator=gen, device="cuda") * 0.05
    for what, r in (("zero pads", rows * (1 - pad)),
                    ("coded pads", rows * (1 - pad) + CODED_PAD * pad)):
        a = sk.merge_rows(r, inv, shard)
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32),
                           sk.merge_rows_plain(r, inv, shard)
                           .view(torch.int32)):
            raise AssertionError(f"dp_rs merge_rows kernel != plain "
                                 f"({what})")
    out_ids = inp["out_ids"]
    s = out_ids.numel()
    table = torch.randn((RS_VOCAB, DIM), generator=gen, device="cuda")
    accum = torch.rand((RS_VOCAB, DIM), generator=gen, device="cuda")
    grads = torch.randn((s, DIM), generator=gen, device="cuda") * 0.05
    t1, a1, t2, a2 = table.clone(), accum.clone(), table.clone(), \
        accum.clone()
    _, _, s1 = sk.merge_apply(t1, a1, out_ids, grads, lr=LR, eps=EPS)
    torch.cuda.synchronize()
    _, _, s2 = sk.merge_apply_plain(t2, a2, out_ids, grads, None, LR, EPS,
                                    1.0)
    ut, ua = ulp_diff(torch, t1, t2), ulp_diff(torch, a1, a2)
    rel = abs(float(s1) - float(s2)) / abs(float(s2))
    if ut > MAX_ULP or ua > MAX_ULP or rel > 1e-5:
        raise AssertionError(f"dp_rs merge_apply kernel vs plain: {ut} / "
                             f"{ua} ulp, sumsq rel {rel}")
    u, dest, order, _, _ = inp["local"]
    k = u.numel()
    payload = torch.randn((k, DIM), generator=gen, device="cuda") * 0.05
    buckets = coll.rs_scatter_rows(payload, dest, order, RS_WORLD,
                                   inp["bucket"])
    lim = 1.05 * buckets.abs().max()
    table_q = qz.build_table(-lim, lim, bits=8, mode="normal")
    c = check_design(sk, "quantize_pack", 8,
                     lambda: sk.quantize_pack(table_q, buckets))
    torch.cuda.synchronize()
    if not torch.equal(c, sk.quantize_pack_plain(table_q, buckets)):
        raise AssertionError("dp_rs quantize_pack kernel != plain")
    table_q = qz.build_table(-1.0, 1.0, bits=8, mode="normal",
                             device="cuda")
    mask = coll._ef_valid_mask(u, payload)
    res = torch.randn((RS_VOCAB, DIM), generator=gen, device="cuda") * 0.01
    r1, r2 = res.clone(), res.clone()
    c1, _, d1 = check_design(sk, "quantize_pack_ef_update", 8,
                             lambda: sk.quantize_pack_ef_update(
                                 table_q, payload * 30, u, r1, mask))
    torch.cuda.synchronize()
    c2, _, d2 = sk.quantize_pack_ef_update_plain(table_q, payload * 30, u,
                                                 r2, mask)
    for a, b, what in ((c1, c2, "codes"), (d1, d2, "dec"),
                       (r1, r2, "residual")):
        if not torch.equal(a, b):
            raise AssertionError(f"dp_rs quantize_pack_ef_update kernel != "
                                 f"plain ({what})")
    return {"bit_exact": ["dedup_ids", "merge_rows", "quantize_pack",
                          "quantize_pack_ef_update"],
            "merge_apply_max_ulp": {"table": ut, "accum": ua},
            "merge_apply_sumsq_rel_err": rel,
            "max_abs_err": max(float((t1 - t2).abs().max()),
                               float((a1 - a2).abs().max())),
            "shapes": {"bucket_ids": m, "shard_cap": shard,
                       "distinct": int(want[2]), "buckets": list(
                           buckets.shape), "out_ids": s, "local_k": k,
                       "foreign_pads": int(((out_ids == 0) & (torch.arange(
                           s, device="cuda") > 0)).sum())}}


def dp_rs_rank(rank, world, out_dir, seed, device, run_steps, grid):
    """One rank of the dp_rs phase: each run of ``run_steps`` ({name:
    steps}) trains FM at Criteo width and vocabulary RS_VOCAB through
    ``SparseTableCTRTrainer``'s hybrid exchange on the global batches
    (this rank takes its rows), counting launches from just before the
    first step to just after the last; with ``grid``,
    ``sparse_reduce_scatter`` at the rs-grid cells, exact and with both EF
    carries.  Writes losses, launches, the overflow slots, the counters,
    the capacity check's host time, digests of the trained state and
    (rank 0) the rows the first RS_CPU_STEPS batches touched."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.dist import collectives as coll
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer
    from lightctr_tpu_torch.ops import sparse_kernels as sk

    mesh = make_mesh(MeshSpec(data=world), device=device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(mesh.device)

    def sync():
        if on_card:
            torch.cuda.synchronize(mesh.device)

    batches, skewed = rs_data(np, seed)
    params = train_params(np, seed, RS_VOCAB)
    snap_ids = torch.from_numpy(np.unique(np.concatenate(
        [b["fids"].reshape(-1) for b in batches[:RS_CPU_STEPS]])).astype(
            np.int64)).to(mesh.device)
    out = {}
    for name, kw, _ in RS_RUNS:
        if name not in run_steps:
            continue
        steps = run_steps[name]
        tr = SparseTableCTRTrainer(
            fm.params_from_numpy(params, mesh.device), fm.logits,
            TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
            sparse_tables={"w": ["fids"], "v": ["fids"]},
            fused_fn=fm.logits_with_l2, mesh=mesh, **kw)
        tr.health = None  # the steady state with the health feed off
        tr.telemetry = obs.MetricsRegistry()
        run = [skewed] * steps if name == "fallback" else batches[:steps]
        plan = tr._exchange_plan(run[0])
        t = time.perf_counter()
        fits = [tr._rs_batch_fits(b, plan) for b in run]
        fits_ms = 1e3 * (time.perf_counter() - t) / len(run)
        slots = []
        record_overflow(tr, slots)
        warm = max(0, min(WARMUP_STEPS, steps - 2))
        sync()
        dist.barrier()
        sk.reset_launches()
        losses, t0 = [], None
        for i, b in enumerate(run):
            if i == warm:
                sync()
                t0 = time.perf_counter()
            losses.append(tr.train_step(b))
            if i + 1 == RS_CPU_STEPS and rank == 0 and name != "fallback":
                torch.save({k: tr.params[k].index_select(0, snap_ids).cpu()
                            for k in ("w", "v")},
                           os.path.join(out_dir, f"snap_{name}.pt"))
        sync()
        wall = time.perf_counter() - t0
        rec = {"steps": steps, "losses": [float(x) for x in losses],
               "launches": sk.launches(),
               "merge_apply_variants": sk.variant_launches("merge_apply"),
               "quantize_pack_variants":
                   sk.variant_launches("quantize_pack"),
               "ef_update_variants":
                   sk.variant_launches("quantize_pack_ef_update"),
               "plan": {k: [v[1], v[2]] for k, v in plan.items()},
               "fits": fits, "fits_host_ms": fits_ms,
               "overflow_slots": [float(x) for x in slots],
               "policy": dict(tr.exchange_policy),
               "fallback_policy": dict(tr._fallback_policy),
               "last_fallback": tr._last_step_fallback,
               "bytes_per_step": dict(tr.exchange_bytes_per_step),
               "counters": tr.telemetry.snapshot()["counters"],
               "timed_steps": steps - warm, "timed_wall_s": wall,
               "device": str(mesh.device), "backend": mesh.backend}
        if name == "exact" and on_card:
            # RS_PROFILE_STEPS more steps, rank 0's under the profiler
            # (the other ranks step alongside for the collectives)
            more = batches[:RS_PROFILE_STEPS]
            if rank == 0:
                rec["profile"] = profile_sparse_steps(torch, tr, more)
            else:
                for b in more:
                    tr.train_step(b)
                sync()
        rec["digest"] = state_digest(tr)
        out[name] = rec
        del tr
        if on_card:
            torch.cuda.empty_cache()
    if on_card:
        out["repeat"] = rs_repeat_step(torch, mesh, params, batches)
    uids, rows = rs_exchange_inputs(np, seed)
    bucket, shard = coll.rs_default_caps(world, RS_LOCAL_K, RS_VOCAB)
    u = torch.from_numpy(uids[rank]).to(mesh.device)
    r = torch.from_numpy(rows[rank]).to(mesh.device)
    for name, kw in RS_EXCHANGES.items():
        kw = dict(kw)
        if kw.pop("residual", False):
            kw["residual"] = coll.sparse_ef_residual_init(mesh,
                                                          (RS_VOCAB, DIM))
        got = coll.sparse_reduce_scatter(mesh, u, r, bucket_cap=bucket,
                                         shard_cap=shard, **kw)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"exchange_{name}.npz"),
                     *[t.cpu().numpy() for t in got])
    if grid:
        vocab, dim, densities = RS_GRID
        out["grid"] = {}
        for density in densities:
            uids, rows = rs_grid_inputs(np, seed, density)
            k = uids.shape[1]
            u = torch.from_numpy(uids[rank]).to(mesh.device)
            r = torch.from_numpy(rows[rank]).to(mesh.device)
            bucket, shard = coll.rs_default_caps(world, k, vocab)
            gu, m, over = coll.sparse_reduce_scatter(
                mesh, u, r, bucket_cap=bucket, shard_cap=shard)
            res = coll.sparse_ef_residual_init(mesh, (vocab, dim))
            ores = coll.sparse_ef_residual_init(mesh, (vocab, dim))
            egu, em, eover, res, ores = coll.sparse_reduce_scatter(
                mesh, u, r, average=False, bucket_cap=bucket,
                shard_cap=shard, compress_bits=8, compress_range=1.0,
                residual=res, owner_residual=ores)
            tag = f"grid{int(100 * density)}_rank{rank}.npz"
            np.savez(os.path.join(out_dir, tag),
                     **{key: t.cpu().numpy() for key, t in (
                         ("gu", gu), ("m", m), ("egu", egu), ("em", em),
                         ("res", res), ("ores", ores))})
            out["grid"][str(density)] = {
                "k": k, "bucket_cap": bucket, "shard_cap": shard,
                "pick": coll.pick_exchange_algo(world, k, vocab, dim)[0],
                "overflow": int(over), "overflow_ef": int(eover)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def rs_repeat_step(torch, mesh, params, batches) -> dict:
    """One coded step of dp_rs (b) run twice from the same state: a fresh
    trainer steps the first batch, its state is copied, it steps the
    second batch, the copy is restored and it steps the second batch
    again.  The tables' digests after the two runs must agree: a step
    whose gradient sums in a fixed order is reproducible bit for bit."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer
    from lightctr_tpu_torch.optim.updaters import tree_map

    kw = {name: k for name, k, _ in RS_RUNS}["coded_dynamic"]
    tr = SparseTableCTRTrainer(
        fm.params_from_numpy(params, mesh.device), fm.logits,
        TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
        sparse_tables={"w": ["fids"], "v": ["fids"]},
        fused_fn=fm.logits_with_l2, mesh=mesh, **kw)
    tr.health = None
    tr.train_step(batches[0])
    saved = tree_map(torch.clone, (tr.params, tr.opt_state))
    digests, losses = [], []
    for _ in range(2):
        tr.params, tr.opt_state = tree_map(torch.clone, saved)
        losses.append(float(tr.train_step(batches[1])))
        digests.append(state_digest(tr))
    return {"digests": digests, "losses": losses}


def rs_grad_parity(np, torch, seed) -> dict:
    """Where the card and the CPU part on dp_rs (b)'s first step: rank 0's
    rows of the first batch through FM's loss (CTRTrainer's loss function,
    the tables gathered whole) on the card and on the CPU from the same
    init.  For the logits, the loss and the touched rows of the two
    tables' gradients: how many values are not bit-identical, and the
    largest distance in ulp; and whether the gradient's largest magnitude,
    which a measured range follows, is the same."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.ctr_trainer import (
        CTRTrainer, grads_of, leaves_requiring_grad)

    batches, _ = rs_data(np, seed)
    local = {k: v[:RS_LOCAL_ROWS] for k, v in batches[0].items()}
    params = train_params(np, seed, RS_VOCAB)
    got = {}
    for dev in ("cuda", "cpu"):
        tr = CTRTrainer(fm.params_from_numpy(params, dev), fm.logits,
                        TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
                        fused_fn=fm.logits_with_l2, device=dev)
        tr.health = None
        batch = tr._put(local)
        leaves = leaves_requiring_grad(tr.params)
        loss = tr._make_loss_fn()(leaves, batch)
        loss.backward()
        grads = grads_of(leaves)
        with torch.no_grad():
            z = fm.logits(tr.params, batch)
        got[dev] = {"logits": z.cpu(), "loss": loss.detach().cpu()[None],
                    "grad_w": grads["w"].cpu(), "grad_v": grads["v"].cpu()}
    ids = torch.from_numpy(np.unique(local["fids"]).astype(np.int64))
    out = {}
    for k in ("logits", "loss", "grad_w", "grad_v"):
        a, b = got["cuda"][k], got["cpu"][k]
        if k.startswith("grad"):
            a, b = a.index_select(0, ids), b.index_select(0, ids)
        out[k] = {"values": a.numel(),
                  "differ": int((a.view(torch.int32)
                                 != b.view(torch.int32)).sum()),
                  "max_ulp": ulp_diff(torch, a, b)}
    out["max_abs_grad_v_same"] = bool(
        got["cuda"]["grad_v"].abs().max() == got["cpu"]["grad_v"].abs().max())
    return out


def dense64(np, vocab, dim, uids, rows):
    """The [vocab, dim] float64 array a (uids, rows) pair denotes under
    ``.add`` scatter semantics."""
    out = np.zeros((vocab, dim))
    np.add.at(out, np.asarray(uids).reshape(-1),
              np.asarray(rows, np.float64).reshape(-1, dim))
    return out


def check_rs_grid(np, seed, root, ranks) -> dict:
    """The rs-grid calls against a float64 numpy oracle: the exact mean
    within the JAX bench's bound and overflow 0 on every rank, every
    output bit-identical across ranks; the coded sum with both EF carries
    conserves the mass: what it delivered plus every rank's two carries
    is the exact sum within 1e-5 (row 0 left out: the empty bucket slots'
    zero code decodes to a half-bucket there, as in the JAX package)."""
    vocab, dim, densities = RS_GRID
    cells = {}
    for density in densities:
        uids, rows = rs_grid_inputs(np, seed, density)
        exact = sum(dense64(np, vocab, dim, uids[m], rows[m])
                    for m in range(RS_WORLD))
        got = [np.load(os.path.join(root, f"grid{int(100 * density)}"
                                          f"_rank{r}.npz"))
               for r in range(RS_WORLD)]
        infos = [rk["grid"][str(density)] for rk in ranks]
        err = 0.0
        for r, (g, info) in enumerate(zip(got, infos)):
            if info["overflow"] or info["overflow_ef"]:
                raise AssertionError(f"dp_rs grid {density}: rank {r} "
                                     f"overflowed {info}")
            mean = dense64(np, vocab, dim, g["gu"], g["m"])
            if not np.allclose(mean, exact / RS_WORLD, rtol=RS_GRID_RTOL,
                               atol=RS_GRID_ATOL):
                raise AssertionError(f"dp_rs grid {density}: rank {r}'s "
                                     "mean is not the oracle's")
            err = max(err, float(np.abs(mean - exact / RS_WORLD).max()))
            for key in ("gu", "m", "egu", "em"):
                if not np.array_equal(g[key], got[0][key]):
                    raise AssertionError(f"dp_rs grid {density}: rank {r}'s "
                                         f"{key} is not rank 0's")
        delivered = dense64(np, vocab, dim, got[0]["egu"], got[0]["em"])
        carried = sum(g["res"].astype(np.float64) + g["ores"] for g in got)
        cons = float(np.abs(delivered + carried - exact)[1:].max())
        if cons > 1e-5:
            raise AssertionError(f"dp_rs grid {density}: delivered + "
                                 f"carried is {cons} off the exact sum")
        info = infos[0]
        if info["pick"] != "sparse_rs":
            raise AssertionError(f"dp_rs grid {density}: pick {info}")
        cells[str(density)] = dict(
            info, max_abs_err_mean=err, ef_conservation_max_abs_err=cons,
            ef_carried_max=float(np.abs(carried[1:]).max()))
    return cells


def check_rs_exchanges(np, dirs) -> dict:
    """The coded reduce-scatter exchanges of RS_EXCHANGES on the path's
    shapes, rank 0's outputs on the card against the CPU world's plain
    versions on the same inputs: bit for bit (equal inputs measure equal
    ranges, the tables are built on the host, and every kernel of the
    exchange is bit-exact to its plain version)."""
    out = {}
    for name in RS_EXCHANGES:
        a, b = (np.load(os.path.join(dirs[w], f"exchange_{name}.npz"))
                for w in ("card", "cpu"))
        keys = sorted(a.files)
        for key in keys:
            if a[key].dtype != b[key].dtype or \
                    not np.array_equal(a[key], b[key]):
                raise AssertionError(
                    f"dp_rs exchange {name}: output {key} differs card vs "
                    f"cpu, max abs {float(np.abs(a[key] - b[key]).max())}")
        out[name] = {"bit_identical": True, "overflow": int(a[keys[2]]),
                     "gathered": list(a[keys[1]].shape)}
        if out[name]["overflow"]:
            raise AssertionError(f"dp_rs exchange {name} overflowed")
    return out


def phase_dp_rs(np, torch, sk, seed) -> dict:
    """FM at Criteo width and vocabulary RS_VOCAB trained data-parallel
    by SparseTableCTRTrainer over RS_WORLD gloo ranks on the one card,
    v on the reduce-scatter exchange (four runs, the last a fallback),
    the first steps re-run on the CPU, and sparse_reduce_scatter at the
    rs-grid cells."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world
    from lightctr_tpu_torch.dist import collectives as coll

    names = tuple(name for name, _, _ in RS_RUNS)
    card_steps = {name: steps for name, _, steps in RS_RUNS}
    cpu_steps = {"exact": RS_CPU_STEPS, "coded_dynamic":
                 card_steps["coded_dynamic"],
                 "coded_ef": card_steps["coded_ef"]}
    bucket, shard = coll.rs_default_caps(RS_WORLD, RS_LOCAL_K, RS_VOCAB)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_rs_")
    try:
        dirs = {k: os.path.join(root, k) for k in ("card", "cpu")}
        for d in dirs.values():
            os.makedirs(d)
        t = time.perf_counter()
        spawn_world(dp_rs_rank, RS_WORLD, "gloo", deadline_s=RS_DEADLINE_S,
                    args=(dirs["card"], seed, "cuda", card_steps, True))
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rs_rank, RS_WORLD, "gloo", deadline_s=RS_DEADLINE_S,
                    args=(dirs["cpu"], seed, "cpu", cpu_steps, False))
        cpu_s = time.perf_counter() - t
        load = lambda d, r: json.load(open(os.path.join(d, f"rank{r}.json")))
        card = [load(dirs["card"], r) for r in range(RS_WORLD)]
        cpu = load(dirs["cpu"], 0)
        runs = {}
        for name in names:
            recs = [c[name] for c in card]
            steps = recs[0]["steps"]
            want = rs_expected_launches(sk, name, steps)
            coded = name.startswith("coded")
            want_rs_bytes = coll.sparse_rs_bytes(
                RS_WORLD, bucket, shard, DIM,
                8 if coded else None) * steps
            for r, rec in enumerate(recs):
                got = {k: rec["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"dp_rs {name} rank {r}: launches "
                                         f"{got}, expected {want}")
                mode = "merge" if name == "fallback" else "apply"
                if rec["merge_apply_variants"] != {mode: steps}:
                    raise AssertionError(
                        f"dp_rs {name} rank {r}: merge_apply ran "
                        f"{rec['merge_apply_variants']}, not its {mode} mode")
                for key, kname in (("quantize_pack_variants",
                                    "quantize_pack"),
                                   ("ef_update_variants",
                                    "quantize_pack_ef_update")):
                    want_v = {"tree": want[kname]} if want[kname] else {}
                    if rec[key] != want_v:
                        raise AssertionError(
                            f"dp_rs {name} rank {r}: {kname} ran "
                            f"{rec[key]}, not {want_v}")
                if rec["plan"] != {"w": ["dense", None],
                                   "v": ["sparse_rs", [bucket, shard]]}:
                    raise AssertionError(f"dp_rs {name}: plan {rec['plan']}")
                if rec["digest"] != recs[0]["digest"]:
                    raise AssertionError(f"dp_rs {name}: rank {r}'s state is "
                                         "not bit-identical to rank 0's")
                counters = rec["counters"]
                if name == "fallback":
                    if any(rec["fits"]) or not rec["last_fallback"] or \
                            rec["fallback_policy"] != {"w": "dense",
                                                       "v": "sparse"} or \
                            counters.get("trainer_rs_fallback_total") != \
                            steps or "trainer_sparse_rs_bytes_total" in \
                            counters:
                        raise AssertionError(f"dp_rs fallback rank {r}: "
                                             f"{rec}")
                    continue
                if not all(rec["fits"]) or rec["last_fallback"] or \
                        rec["policy"] != {"w": "dense", "v": "sparse_rs"} \
                        or any(rec["overflow_slots"]) or \
                        len(rec["overflow_slots"]) != steps or \
                        "trainer_rs_fallback_total" in counters or \
                        counters.get("trainer_sparse_rs_bytes_total") != \
                        want_rs_bytes:
                    raise AssertionError(f"dp_rs {name} rank {r}: policy "
                                         f"{rec['policy']}, overflow "
                                         f"{rec['overflow_slots']}, fits "
                                         f"{rec['fits']}, counters "
                                         f"{counters}")
            losses = recs[0]["losses"]
            if not all(np.isfinite(losses)):
                raise AssertionError(f"dp_rs {name}: losses {losses}")
            run = {"steps": steps, "launches_per_rank": want,
                   "policy": recs[0]["policy"] or recs[0]["fallback_policy"],
                   "bytes_per_step": recs[0]["bytes_per_step"],
                   "counters_rank0": recs[0]["counters"],
                   "rs_batch_fits_host_ms": recs[0]["fits_host_ms"],
                   "step_ms": 1e3 * recs[0]["timed_wall_s"]
                   / recs[0]["timed_steps"],
                   "timed_steps": recs[0]["timed_steps"],
                   "losses": losses, "ranks_bit_identical": True}
            if name in ("exact", "coded_dynamic"):
                head = 5 if name == "exact" else 3
                if np.mean(losses[-head:]) >= np.mean(losses[:head]):
                    raise AssertionError(f"dp_rs {name}: loss did not fall "
                                         f"{losses}")
            if name == "exact":
                run["examples_per_s_gloo_host_staged"] = (
                    TRAIN_BATCH * 1e3 / run["step_ms"])
                prof = recs[0]["profile"]
                prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / \
                    run["step_ms"]
                run["profile_rank0"] = prof
            if name in cpu:
                # (b)'s trajectory against the CPU is reported, not held:
                # its measured ranges follow the last ulp of the gradients,
                # which the card's forward reduces in another order than
                # the CPU's (rs_grad_parity), and its shard encode re-codes
                # sums of decoded values that sit on boundaries, so a range
                # one ulp apart flips codes by the hundred.  Its gate is
                # the repeated step below (bit-identical on the card) and
                # its exchange on equal inputs (check_rs_exchanges)
                gate = name != "coded_dynamic"
                cpu_losses = cpu[name]["losses"]
                rtol = TRAIN_RTOL if name == "exact" else DP_CODED_RTOL
                if gate and not np.allclose(losses[:len(cpu_losses)],
                                            cpu_losses, rtol=rtol, atol=0):
                    raise AssertionError(
                        f"dp_rs {name}: losses card "
                        f"{losses[:len(cpu_losses)]} vs cpu {cpu_losses}")
                a_snap = torch.load(os.path.join(dirs["card"],
                                                 f"snap_{name}.pt"))
                b_snap = torch.load(os.path.join(dirs["cpu"],
                                                 f"snap_{name}.pt"))
                max_abs, off = 0.0, 0
                for k in ("w", "v"):
                    a, b = a_snap[k], b_snap[k]
                    max_abs = max(max_abs, float((a - b).abs().max()))
                    off += int((~torch.isclose(a, b, rtol=TRAIN_RTOL,
                                               atol=TRAIN_ATOL)).sum())
                total = sum(a_snap[k].numel() for k in ("w", "v"))
                if gate and ((name == "exact" and off)
                             or off > DP_CODE_FLIP_SHARE * total):
                    raise AssertionError(f"dp_rs {name}: {off} of {total} "
                                         "touched values differ card vs cpu, "
                                         f"max abs {max_abs}")
                run.update(cpu_steps=len(cpu_losses), cpu_gated=gate,
                           loss_rel_err_vs_cpu=max(
                               abs(a - b) / abs(b) for a, b in
                               zip(losses, cpu_losses)),
                           touched_values=total, touched_off_tolerance=off,
                           max_abs_err_vs_cpu=max_abs)
            runs[name] = run
        repeat = [c["repeat"] for c in card]
        for r, rep in enumerate(repeat):
            if rep["digests"][0] != rep["digests"][1] or \
                    rep["digests"][0] != repeat[0]["digests"][0]:
                raise AssertionError(
                    f"dp_rs (b) repeated step, rank {r}: the two runs' "
                    f"tables differ ({rep['digests']}, rank 0 "
                    f"{repeat[0]['digests'][0]})")
        repeat_info = {"run": "coded_dynamic", "ranks": RS_WORLD,
                       "losses": repeat[0]["losses"],
                       "tables_bit_identical": True}
        grad_parity = rs_grad_parity(np, torch, seed)
        grid = check_rs_grid(np, seed, dirs["card"], card)
        exchanges = check_rs_exchanges(np, dirs)
        launches = {k: sum(card[0][n]["launches"].get(k, 0) for n in names)
                    for k in sk.KERNELS}
        variants = {key: {} for key in ("merge_apply_variants",
                                        "quantize_pack_variants",
                                        "ef_update_variants")}
        for n in names:
            for key, acc in variants.items():
                for v, c in card[0][n][key].items():
                    acc[v] = acc.get(v, 0) + c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "dp_rs", "model": "fm", "world": RS_WORLD,
            "backend": "gloo (host-staged), all ranks on cuda:0",
            "batch": TRAIN_BATCH, "local_rows": RS_LOCAL_ROWS,
            "local_k": RS_LOCAL_K, "vocab": RS_VOCAB, "factor_dim": DIM,
            "caps": {"bucket": bucket, "shard": shard}, "runs": runs,
            "grid": grid, "exchanges_vs_cpu": exchanges,
            "repeat_coded_step": repeat_info,
            "b_first_step_card_vs_cpu": grad_parity,
            "b_vs_cpu_beside_jax_reorder_gap": {
                "card_vs_cpu_loss_rel_err":
                    runs["coded_dynamic"].get("loss_rel_err_vs_cpu"),
                "jax_self_gap_under_a_field_reorder": JAX_REORDER_GAP},
            "seconds": {"card_world": card_s, "cpu_world": cpu_s},
            "launches_rank0": launches, "variants_rank0": variants}


# -- phase: ingest ------------------------------------------------------------

INGEST_ROWS = SPARSE_STEPS * TRAIN_BATCH    # 204,800 rows, 50 batches
INGEST_PREFETCH = 2
#: the optimizers (b) trains with, each from the JAX registry's names;
#: ftrl's L1 and L2 are cut from the reference's 1.0, at which every
#: weight of this model stays 0 for the first steps
INGEST_OPTIMIZERS = (("ftrl", {"lambda1": 1e-3, "lambda2": 1e-3}),
                     ("adam", {"learning_rate": 1e-2}))
OPT_STEPS = 10
OPT_CPU_STEPS = 2
#: probability bins of the armed replay (e): the sketch's merge_rows
#: launch is [TRAIN_BATCH, 4] rows into QUALITY_BINS segments
QUALITY_BINS = 512
QUALITY_PROFILE_STEPS = 5


def ingest_files(seed, root) -> tuple:
    """The training file (INGEST_ROWS Criteo-proxy rows) and the held-out
    file (EVAL_ROWS rows of the same recipe, another seed), written by
    ``data.synth.write_criteo_proxy``; the seconds the two writes took."""
    from lightctr_tpu_torch.data import synth

    t = time.perf_counter()
    train = synth.write_criteo_proxy(os.path.join(root, "train.ffm"),
                                     INGEST_ROWS, seed=seed + 11,
                                     n_fields=N_FIELDS, n_cat=N_CAT,
                                     vocab=VOCAB)
    held = synth.write_criteo_proxy(os.path.join(root, "heldout.ffm"),
                                    EVAL_ROWS, seed=seed + 12,
                                    n_fields=N_FIELDS, n_cat=N_CAT,
                                    vocab=VOCAB)
    return train, held, time.perf_counter() - t


def ingest_stream(path):
    """The file's batches through the native chunk parser."""
    from lightctr_tpu_torch.data import streaming

    return streaming.iter_libffm_batches(path, TRAIN_BATCH, N_FIELDS,
                                         feature_cnt=VOCAB, native=True)


def ingest_trainer(params, quality_bins=None):
    """SparseTableCTRTrainer FM at Criteo width on the card, the health
    feed off (an armed trainer drains its sketches all the same)."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    tr = SparseTableCTRTrainer(
        fm.params_from_numpy(params, "cuda"), fm.logits,
        TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
        sparse_tables={"w": ["fids"], "v": ["fids"]},
        fused_fn=fm.logits_with_l2, quality_bins=quality_bins,
        device="cuda")
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    return tr


def ingest_fit(np, torch, sk, params, path, prefetch, max_steps=None,
               stream=None, quality_bins=None):
    """``ingest_trainer`` through ``fit_stream`` over the file (or over
    ``stream``); launches counted from just before the stream to just
    after it."""
    tr = ingest_trainer(params, quality_bins)
    torch.cuda.synchronize()
    sk.reset_launches()
    t = time.perf_counter()
    losses = tr.fit_stream(ingest_stream(path) if stream is None else stream,
                           max_steps=max_steps, prefetch=prefetch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return tr, losses, wall, sk.launches(), tr.telemetry.snapshot()


def check_same_run(torch, what, got, want) -> None:
    """Two runs' (losses, w, v) equal bit for bit."""
    if got[0] != want[0]:
        raise AssertionError(f"{what}: losses {got[0][:5]}... are not "
                             f"{want[0][:5]}...")
    for k, a, b in (("w", got[1], want[1]), ("v", got[2], want[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {k} differs")


def ingest_cache(np, torch, sk, params, path, root, want_run) -> dict:
    """(d) the file compiled once into the shard cache and replayed: the
    replay under ``fit_stream(prefetch=2)`` and ``fit(<cache dir>)``
    against ``want_run`` (the live parse's (losses, w, v)) and
    ``fit(<the same rows as arrays>)``, bit for bit; (e) the replay again
    with the quality sketch armed, twice."""
    import itertools

    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.data import ingest

    reg = obs.MetricsRegistry()
    kw = dict(cache_dir=os.path.join(root, "train.lcshards"),
              feature_cnt=VOCAB, registry=reg)
    t = time.perf_counter()
    cache = ingest.compile_shards(path, N_FIELDS, **kw)
    compile_s = time.perf_counter() - t
    t = time.perf_counter()
    again = ingest.compile_shards(path, N_FIELDS, **kw)
    hit_s = time.perf_counter() - t
    counters = reg.snapshot()["counters"]
    if counters.get("ingest_shard_compiles_total") != 1 or \
            counters.get("ingest_shard_cache_hits_total") != 1 or \
            again.manifest != cache.manifest:
        raise AssertionError(f"ingest (d): the second compile is no cache "
                             f"hit: {counters}")
    t = time.perf_counter()
    n_batches = sum(1 for _ in ingest.iter_shard_batches(cache, TRAIN_BATCH))
    replay_ms = 1e3 * (time.perf_counter() - t) / n_batches
    if n_batches != SPARSE_STEPS or cache.rows != INGEST_ROWS:
        raise AssertionError(f"ingest (d): {cache.rows} rows, {n_batches} "
                             "batches in the cache")
    want_launches = sparse_expected_launches(sk, SPARSE_STEPS)

    def replay(quality_bins=None):
        return ingest_fit(np, torch, sk, params, None, INGEST_PREFETCH,
                          stream=ingest.iter_shard_batches(cache,
                                                           TRAIN_BATCH),
                          quality_bins=quality_bins)

    tr, losses, wall, launches, snap = replay()
    if launches != want_launches:
        raise AssertionError(f"ingest (d) replay: launches {launches}")
    check_same_run(torch, "ingest (d) replay against the live parse",
                   (losses, tr.params["w"], tr.params["v"]), want_run)
    del tr
    fits = []
    for src in (cache.dir, ingest.as_arrays(cache)):
        ft = ingest_trainer(params)
        torch.cuda.synchronize()
        sk.reset_launches()
        t = time.perf_counter()
        hist = ft.fit(src, epochs=1, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        fits.append({"run": (hist["loss"], ft.params["w"], ft.params["v"]),
                     "wall_s": time.perf_counter() - t,
                     "launches": sk.launches()})
        del ft
    check_same_run(torch, "ingest (d) fit(<cache dir>) against fit(arrays)",
                   fits[0]["run"], fits[1]["run"])
    for f in fits:
        if f["launches"] != sparse_expected_launches(sk, SPARSE_STEPS):
            raise AssertionError(f"ingest (d) fit: launches {f['launches']}")
    # (e) armed: one more merge_rows launch a step, at the sketch's shape
    want_armed = dict(want_launches,
                      merge_rows=want_launches["merge_rows"] + SPARSE_STEPS)
    armed = []
    for rep in range(2):
        ta, la, wall_a, launch_a, _ = replay(QUALITY_BINS)
        if launch_a != want_armed:
            raise AssertionError(f"ingest (e) run {rep}: launches "
                                 f"{launch_a}, planned {want_armed}")
        check_same_run(torch, f"ingest (e) run {rep} against the unarmed "
                       "replay", (la, ta.params["w"], ta.params["v"]),
                       want_run)
        q = ta.quality
        if q.total.count != INGEST_ROWS or q.total.updates != SPARSE_STEPS:
            raise AssertionError(f"ingest (e): the tracker saw "
                                 f"{q.total.count} examples in "
                                 f"{q.total.updates} sketches")
        rec = {"rows": q.total.rows.copy(), "wall_s": wall_a,
               "launches": launch_a, "last_window": q.last_window,
               "windows": q.windows,
               "total": {"auc": q.total.auc(), "logloss": q.total.logloss(),
                         "calibration_ratio": q.total.calibration_ratio()}}
        if rep == 1:
            batches = list(itertools.islice(
                ingest.iter_shard_batches(cache, TRAIN_BATCH),
                QUALITY_PROFILE_STEPS))
            prof = profile_sparse_steps(torch, ta, batches)
            prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / (
                1e3 * wall_a / SPARSE_STEPS)
            rec["profile"] = prof
        q.close()
        armed.append(rec)
        del ta
    if not np.array_equal(armed[0]["rows"], armed[1]["rows"]):
        raise AssertionError("ingest (e): the two armed runs' sketches "
                             "differ")
    launches_all = {k: launches[k] + sum(f["launches"][k] for f in fits)
                    + sum(a["launches"][k] for a in armed)
                    for k in sk.KERNELS}
    file_bytes = os.path.getsize(path)
    shard_bytes = sum(x["bytes"] for x in cache.manifest["shards"])
    return {
        "launches": launches_all,
        "compile": {"seconds": compile_s, "cache_hit_s": hit_s,
                    "shards": cache.n_shards, "shard_bytes": shard_bytes,
                    "file_bytes": file_bytes,
                    "shard_to_file": shard_bytes / file_bytes},
        "replay": {
            "prefetch": INGEST_PREFETCH, "steps": SPARSE_STEPS,
            "launches": launches, "equals_live_parse": True,
            "decode_ms_per_batch": replay_ms,
            "examples_per_s": INGEST_ROWS / wall,
            "step_ms": 1e3 * wall / SPARSE_STEPS,
            "overlap_ratio": snap["gauges"].get("ingest_overlap_ratio")},
        "fit_cache_dir": {"equals_fit_arrays": True,
                          "wall_s_cache_dir": fits[0]["wall_s"],
                          "wall_s_arrays": fits[1]["wall_s"],
                          "launches": fits[0]["launches"]},
        "quality": {
            "bins": QUALITY_BINS, "equals_unarmed": True,
            "sketches_bit_identical_run_to_run": True,
            "launches": armed[0]["launches"],
            "step_ms_armed": [1e3 * a["wall_s"] / SPARSE_STEPS
                              for a in armed],
            "step_ms_unarmed": 1e3 * wall / SPARSE_STEPS,
            "windows": armed[0]["windows"],
            "last_window": armed[0]["last_window"],
            "total": armed[0]["total"],
            "profile": armed[1]["profile"]},
    }


def phase_ingest(np, torch, sk, seed, repair, keep_dir=None) -> dict:
    """FM at Criteo width trained from a libFFM file: (a) the sparse
    trainer through ``fit_stream(..., prefetch=2)`` and again without
    prefetch, bit-identical; (b) CTRTrainer under ftrl and adam, held to
    the CPU; (c) the dp_rs phase's repeated coded step (``repair``); (d)
    the file compiled into the shard cache and replayed, bit for bit the
    live parse's run; (e) that replay with the quality sketch armed."""
    import itertools
    import shutil
    import tempfile

    from lightctr_tpu_torch import optim
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.data.sparse import load_libffm
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer

    root = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        path, held_path, write_s = ingest_files(seed, root)
        t = time.perf_counter()
        n_batches = sum(1 for _ in ingest_stream(path))
        parse_ms = 1e3 * (time.perf_counter() - t) / n_batches
        if n_batches != SPARSE_STEPS:
            raise AssertionError(f"ingest: {n_batches} batches in the file")
        params = train_params(np, seed)

        # (a) the file path, a few warm-up steps first so neither timed run
        # pays the allocator's growth
        ingest_fit(np, torch, sk, params, path, None, max_steps=3)
        tr_p, l_pre, wall_pre, launch_pre, snap = ingest_fit(
            np, torch, sk, params, path, INGEST_PREFETCH)
        tr_s, l_sync, wall_sync, launch_sync, _ = ingest_fit(
            np, torch, sk, params, path, None)
        want = sparse_expected_launches(sk, SPARSE_STEPS)
        for what, got in (("prefetch", launch_pre), ("sync", launch_sync)):
            if got != want:
                raise AssertionError(f"ingest (a) {what}: launches {got}, "
                                     f"expected {want}")
        if l_pre != l_sync:
            raise AssertionError(f"ingest (a): prefetch losses {l_pre} are "
                                 f"not the synchronous run's {l_sync}")
        for k in ("w", "v"):
            if not torch.equal(tr_p.params[k], tr_s.params[k]):
                raise AssertionError(f"ingest (a): {k} after the prefetch "
                                     "run differs from the synchronous run")
        if not all(np.isfinite(l_pre)) or \
                np.mean(l_pre[-5:]) >= np.mean(l_pre[:5]):
            raise AssertionError(f"ingest (a): loss did not fall {l_pre}")
        held = load_libffm(held_path, max_nnz=N_FIELDS,
                           feature_cnt=VOCAB).batch_dict()
        ev = tr_p.evaluate(held, batch_size=TRAIN_BATCH)
        if not ev["auc"] > MIN_AUC:
            raise AssertionError(f"ingest (a): held-out AUC {ev['auc']} <= "
                                 f"{MIN_AUC}")
        overlap = snap["gauges"].get("ingest_overlap_ratio")
        if snap["counters"].get("ingest_prefetch_batches_total") != \
                SPARSE_STEPS or overlap is None:
            raise AssertionError(f"ingest (a): prefetch telemetry {snap}")
        cached = ingest_cache(np, torch, sk, params, path, root,
                              (l_pre, tr_p.params["w"], tr_p.params["v"]))
        del tr_p, tr_s

        # (b) the optimizers, on the file's first batches
        batches = list(itertools.islice(ingest_stream(path), OPT_STEPS))
        opt_runs = {}
        for name, kw in INGEST_OPTIMIZERS:
            tr = CTRTrainer(fm.params_from_numpy(params, "cuda"), fm.logits,
                            TrainConfig(learning_rate=LR,
                                        lambda_l2=LAMBDA_L2),
                            fused_fn=fm.logits_with_l2,
                            optimizer=optim.get(name, **kw), device="cuda")
            tr.health = None
            sk.reset_launches()
            losses, snaps, wall, host = run_steps(
                torch, tr, batches, snapshots=(OPT_CPU_STEPS,))
            launches = sk.launches()
            losses = [float(x) for x in losses]
            if launches != dense_expected_launches(sk, OPT_STEPS):
                raise AssertionError(f"ingest (b) {name}: launches "
                                     f"{launches}")
            if not all(np.isfinite(losses)) or \
                    np.mean(losses[-3:]) >= np.mean(losses[:3]):
                raise AssertionError(f"ingest (b) {name}: loss did not "
                                     f"fall {losses}")
            c_losses, c_params = cpu_rerun(
                np, torch, CTRTrainer, params, batches[:OPT_CPU_STEPS],
                optimizer=optim.get(name, **kw))
            if not np.allclose(losses[:OPT_CPU_STEPS], c_losses,
                               rtol=TRAIN_RTOL, atol=0):
                raise AssertionError(f"ingest (b) {name}: losses card "
                                     f"{losses[:OPT_CPU_STEPS]} vs cpu "
                                     f"{c_losses}")
            err = 0.0
            for k in ("w", "v"):
                a, b = snaps[OPT_CPU_STEPS][k].cpu(), c_params[k]
                if not torch.allclose(a, b, rtol=TRAIN_RTOL,
                                      atol=TRAIN_ATOL):
                    raise AssertionError(
                        f"ingest (b) {name}: {k} after {OPT_CPU_STEPS} steps "
                        f"differs card vs cpu, max abs "
                        f"{float((a - b).abs().max())}")
                err = max(err, float((a - b).abs().max()))
            opt_runs[name] = {
                "kwargs": kw, "steps": OPT_STEPS, "launches": launches,
                "losses": losses, "cpu_steps": OPT_CPU_STEPS,
                "loss_rel_err_vs_cpu": max(abs(a - b) / abs(b) for a, b in
                                           zip(losses, c_losses)),
                "max_abs_err_vs_cpu": err,
                "step_ms": 1e3 * wall / (OPT_STEPS - WARMUP_STEPS),
                "host_launch_ms": 1e3 * host}
            del tr, snaps, c_params
            torch.cuda.empty_cache()
        if keep_dir is not None:
            # the online phase streams the same file
            os.replace(path, os.path.join(keep_dir, "train.ffm"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not repair.get("tables_bit_identical"):
        raise AssertionError(f"ingest (c): {repair}")
    return {
        "phase": "ingest", "model": "fm", "fields": N_FIELDS,
        "vocab": VOCAB, "factor_dim": DIM, "batch": TRAIN_BATCH,
        "rows": INGEST_ROWS, "heldout_rows": EVAL_ROWS,
        "file": {"write_s": write_s, "batches": n_batches,
                 "parse_ms_per_batch": parse_ms, "native": True},
        "stream": {
            "prefetch": INGEST_PREFETCH, "steps": SPARSE_STEPS,
            "launches": launch_pre, "launches_sync": launch_sync,
            "losses_bit_identical": True, "tables_bit_identical": True,
            "loss_first5": l_pre[:5], "loss_last5": l_pre[-5:],
            "heldout": ev,
            "examples_per_s_prefetch": SPARSE_STEPS * TRAIN_BATCH / wall_pre,
            "examples_per_s_sync": SPARSE_STEPS * TRAIN_BATCH / wall_sync,
            "step_ms_prefetch": 1e3 * wall_pre / SPARSE_STEPS,
            "step_ms_sync": 1e3 * wall_sync / SPARSE_STEPS,
            "ingest_overlap_ratio": overlap,
            "prefetch_ready": snap["counters"].get(
                "ingest_prefetch_ready_total", 0),
            "timing_note": "fit_stream reads each step's loss (a sync a "
                           "step), health feed off, whole runs"},
        "optimizers": opt_runs,
        "repair": repair,
        "shard_cache": {k: v for k, v in cached.items() if k != "launches"},
        "launches": {k: launch_pre[k] + launch_sync[k] + sum(
            r["launches"][k] for r in opt_runs.values())
            + cached["launches"][k] for k in sk.KERNELS},
    }


# -- phase: online ------------------------------------------------------------

ONLINE_LEG1 = 10            # FM steps while the server answers requests
ONLINE_LEG2 = 7             # FM steps after the hold (freshness recovers)
ONLINE_PROFILE_STEPS = 3    # FM steps under torch.profiler (idle share)
ONLINE_STEPS = ONLINE_LEG1 + ONLINE_LEG2 + ONLINE_PROFILE_STEPS   # 20
ONLINE_SLO_S = 2.0          # the freshness SLO the subscriber feeds
ONLINE_CPU_STEPS = 3        # first steps re-run on the CPU port
ONLINE_RTOL = 1e-4
ONLINE_WD_STEPS = 10
ONLINE_WD_EXPORT_EVERY = 5
ONLINE_SWAP_TOL = 1e-4      # fp32 exports: a faithful one scores equal
ONLINE_DEADLINE_S = 30.0
ONLINE_LOG_UIDS = 1 << 21   # the PS write log's bound, about 16 steps


def online_stream(path):
    """The ingest phase's file as the online trainer's endless stream."""
    from lightctr_tpu_torch.data import streaming

    return streaming.iter_libffm_batches(path, TRAIN_BATCH, N_FIELDS,
                                         feature_cnt=VOCAB, native=True,
                                         loop=True)


def online_expected_launches(sk, fm_steps, wd_steps) -> dict:
    """Launches of the online path: the lookups' backward (merge_rows)
    twice a step, FM's w and v and Wide&Deep's w and embed; the server's
    cache gathers (gather_rows, at least one a scored micro-batch, counted
    from the server) are checked apart; nothing else."""
    want = dict.fromkeys(sk.KERNELS, 0)
    want["merge_rows"] = 2 * (fm_steps + wd_steps)
    return want


def wait_for(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return time.monotonic() - (deadline - timeout_s)
        time.sleep(0.05)
    raise AssertionError(f"online: timed out waiting for {what}")


def online_cpu_rerun(np, rows0, batches) -> list:
    """The first online steps on the CPU port, against a second PS
    preloaded with the same rows (the ones those batches touch)."""
    from lightctr_tpu_torch import obs, online
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

    keys = np.unique(np.concatenate([b["fids"].reshape(-1)
                                     for b in batches]).astype(np.int64))
    svc = ParamServerService(AsyncParamServer(
        dim=ROW_DIM, n_workers=1, seed=0, learning_rate=LR,
        staleness_threshold=1 << 30))
    cli = PSClient(svc.address, ROW_DIM)
    try:
        cli.preload_arrays(keys, rows0[keys])
        tr = online.OnlineTrainer(cli, "fm", DIM,
                                  registry=obs.MetricsRegistry(),
                                  device="cpu")
        return [tr.step(b) for b in batches]
    finally:
        cli.close()
        svc.close()


def online_swap(np, serve, online, admin, tr, export_dir, requests):
    """Check 3: the Wide&Deep trainer's faithful export swaps in behind
    the shadow gate, a corrupted one is refused."""
    model = serve.ServingModel(
        "widedeep", {k: tr.dense[k] for k in ("fc1", "fc2")},
        row_leaves={"w": (0, 1, True), "embed": (1, ROW_DIM, False)},
        row_dim=ROW_DIM, device="cuda")
    replay = [{k: r[k] for k in ("fids", "vals", "rep_fids", "rep_mask")}
              for r in deep_requests(np, requests[:2])]
    sw = online.ModelSwapper(
        model, replay, tolerance=ONLINE_SWAP_TOL,
        pull_rows=lambda uids: admin.pull_arrays(
            uids, worker_epoch=0, worker_id=None, create=False)[1])
    faithful = os.path.join(export_dir,
                            f"model_{ONLINE_WD_STEPS:010d}.npz")
    corrupt = {k: dict(v) for k, v in tr.dense.items()}
    corrupt["fc1"]["w"] = corrupt["fc1"]["w"] + np.float32(3.0)
    bad = online.publish_export(export_dir, corrupt, model="widedeep",
                                step=ONLINE_WD_STEPS + 1, codec="fp32",
                                device="cuda")
    refused = sw.offer(bad)
    accepted = sw.offer(faithful)
    st = sw.stats()
    if refused or not accepted or st["refusals"] != {"parity": 1} or \
            model.version != 1:
        raise AssertionError(f"online swap: refused {refused}, accepted "
                             f"{accepted}, {st}")
    return {"corrupted_refused": True, "faithful_accepted": True,
            "refusals": st["refusals"], "last_shadow_diff": st["last_diff"],
            "tolerance": ONLINE_SWAP_TOL, "model_version": model.version}


def phase_online(np, torch, sk, seed, path, requests) -> dict:
    """Online learning on the card against a live PS (the reference's
    never-stopping PS worker): FM at the serve cell's width, the 2^20 x 33
    table preloaded into a ``ParamServerService``; ``OnlineTrainer`` on
    the card over ``iter_libffm_batches(loop=True)`` of the ingest
    phase's file with ``prefetch=2`` while a ``PredictionServer`` (its
    65,536-row hot cache on the card, B3) and a ``FreshnessSubscriber``
    serve the serve phase's 8 x 256 rows from the same live rows.  Held:
    the served scores equal a float64 forward of rows pulled straight off
    the PS within SCORE_ATOL (check 1), and the freshness age trips
    /healthz; resumed, it recovers (check 2).  Then Wide&Deep at
    serve_deep's width exports every 5 steps, and the shadow gate swaps a
    faithful artifact in and refuses a corrupted one (check 3).  Counts
    reset just before the path, held to ``online_expected_launches``;
    the first 3 FM steps re-run on the CPU port within ONLINE_RTOL."""
    import itertools

    from lightctr_tpu_torch import online, serve
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
    from lightctr_tpu_torch.obs import exporter, health

    t0 = time.perf_counter()
    params = make_params(np, seed + 30)
    keys, rows0 = serve.fused_fm_rows(params)
    store = AsyncParamServer(dim=ROW_DIM, n_workers=2, seed=seed,
                             learning_rate=LR, staleness_threshold=1 << 30)
    # the write log sized for this traffic: a step at Criteo width pushes
    # ~10^5 distinct ids, past the default 4,096-uid bound, which would
    # turn every delta into a full cache drop
    store.WRITE_LOG_MAX_UIDS = ONLINE_LOG_UIDS
    svc = ParamServerService(store)
    root = tempfile.mkdtemp(prefix="chip_smoke_online_")
    admin = srv = sub = cli = ops = None
    try:
        admin = PSClient(svc.address, ROW_DIM)
        for lo in range(0, VOCAB, PRELOAD_CHUNK):
            admin.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                                 rows0[lo:lo + PRELOAD_CHUNK])
        setup_s = time.perf_counter() - t0
        srv = serve.PredictionServer(
            serve.ServingModel("fm", {}, row_leaves=serve.fm_ps_row_leaves(
                DIM), row_dim=ROW_DIM, device="cuda"),
            ps=PSClient(svc.address, ROW_DIM), max_batch=256,
            device="cuda")
        sub = online.FreshnessSubscriber(
            srv, [svc.address], ROW_DIM, slo_s=ONLINE_SLO_S, poll_ms=400
        ).start()
        ops = exporter.OpsServer(port=0)
        cli = serve.PredictClient(srv.address)
        tr = online.OnlineTrainer(admin, "fm", DIM, worker_id=0,
                                  device="cuda")
        losses = []
        step = tr.step
        tr.step = lambda mb, stop=None: losses.append(step(mb, stop)) or \
            losses[-1]
        wait_for(lambda: sub.stats()["versions"][0] >= 0, 10,
                 "the subscriber's arm")

        torch.cuda.synchronize()
        sk.reset_launches()
        # leg 1: the trainer on a thread, the server answering meanwhile
        errs = []

        def leg(n, stream):
            try:
                tr.run(stream, max_steps=tr.steps + n, prefetch=2)
            except BaseException as e:  # surfaced after the join
                errs.append(e)

        t_leg = time.perf_counter()
        th = threading.Thread(target=leg, args=(ONLINE_LEG1,
                                                online_stream(path)))
        th.start()
        served = 0
        while th.is_alive() or served < N_REQUESTS:
            scores = cli.predict(requests[served % N_REQUESTS])
            if scores.shape != (REQUEST_ROWS,) or \
                    not np.all(np.isfinite(scores)):
                raise AssertionError(f"online: bad scores {scores.shape}")
            served += 1
        th.join()
        if errs:
            raise errs[0]
        leg1_s = time.perf_counter() - t_leg

        # held: check 1 (served == a float64 forward of the live rows)
        uids = np.unique(np.concatenate(
            [r["fids"].reshape(-1) for r in requests]).astype(np.int64))
        _, live = admin.pull_arrays(uids, worker_epoch=0, worker_id=None,
                                    create=False)
        trained = {"w": np.zeros(VOCAB, np.float32),
                   "v": np.zeros((VOCAB, DIM), np.float32)}
        trained["w"][uids] = live[:, 0]
        trained["v"][uids] = live[:, 1:]
        refs = [fm_forward64(np, trained, r) for r in requests]
        moved = float(np.abs(live - rows0[uids]).max())
        state = {"err": None}

        def served_fresh():
            state["err"] = max(float(np.abs(cli.predict(r) - ref).max())
                               for r, ref in zip(requests, refs))
            return state["err"] < SCORE_ATOL

        fresh_s = wait_for(served_fresh, ONLINE_DEADLINE_S,
                           "served scores to pick up the trained rows")
        if not moved > 1e-3:
            raise AssertionError(f"online: the PS rows did not move "
                                 f"({moved})")
        base = f"http://{ops.address[0]}:{ops.address[1]}"
        comp = srv.health.component

        def fresh_status():
            return detector_status(http_json(base + "/healthz")[1], comp,
                                   "freshness_slo")

        degrade_s = wait_for(
            lambda: fresh_status() in (health.DEGRADED, health.UNHEALTHY),
            ONLINE_SLO_S * 4 + 15, "/healthz to degrade on freshness")
        # resumed: check 2's recovery, polled while the trainer runs
        t_leg = time.perf_counter()
        th = threading.Thread(target=leg, args=(ONLINE_LEG2,
                                                online_stream(path)))
        th.start()
        recover_s = wait_for(lambda: fresh_status() == health.OK,
                             ONLINE_DEADLINE_S,
                             "/healthz to recover once training resumes")
        th.join()
        if errs:
            raise errs[0]
        leg2_s = time.perf_counter() - t_leg
        stream = online_stream(path)
        prof = profile_calls(torch, [lambda: tr.step(next(stream))
                                     for _ in range(ONLINE_PROFILE_STEPS)])
        stream.close()
        prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / (
            prof["profiled_wall_ms"] / ONLINE_PROFILE_STEPS)
        fm_stats = tr.stats()
        if tr.steps != ONLINE_STEPS or fm_stats["push_failures"] or \
                not all(np.isfinite(losses)):
            raise AssertionError(f"online FM: {fm_stats}")

        # Wide&Deep at serve_deep's width, exporting every 5 steps
        wd_p = deep_params(np, seed, "widedeep", params["w"], params["v"])
        wd = online.OnlineTrainer(
            admin, "widedeep", DIM, field_cnt=N_FIELDS,
            dense_params={k: wd_p[k] for k in ("fc1", "fc2")},
            dense_lr=0.01, worker_id=1, export_dir=os.path.join(
                root, "exports"), export_every=ONLINE_WD_EXPORT_EVERY,
            export_codec="fp32", device="cuda")
        t_wd = time.perf_counter()
        wd.run(online_stream(path), max_steps=ONLINE_WD_STEPS, prefetch=2)
        wd_s = time.perf_counter() - t_wd
        torch.cuda.synchronize()
        launches = sk.launches()
        batches_scored = srv.stats()["batches_scored"]
        plan = online_expected_launches(sk, ONLINE_STEPS, ONLINE_WD_STEPS)
        got = dict(launches, gather_rows=0)
        if got != plan or launches["gather_rows"] < batches_scored or \
                batches_scored < N_REQUESTS:
            raise AssertionError(f"online launches {launches}, planned "
                                 f"{plan}, gather_rows >= {batches_scored}")
        if wd.exports != ONLINE_WD_STEPS // ONLINE_WD_EXPORT_EVERY or \
                wd.push_failures:
            raise AssertionError(f"online widedeep: {wd.stats()}")
        swap = online_swap(np, serve, online, admin, wd,
                           os.path.join(root, "exports"), requests)

        # the first steps on the CPU port
        first = list(itertools.islice(online_stream(path),
                                      ONLINE_CPU_STEPS))
        cpu = online_cpu_rerun(np, rows0, first)
        if not np.allclose(losses[:ONLINE_CPU_STEPS], cpu, rtol=ONLINE_RTOL,
                           atol=0):
            raise AssertionError(f"online: card losses "
                                 f"{losses[:ONLINE_CPU_STEPS]} vs cpu {cpu}")
        sub_stats = sub.stats()
        if sub_stats["applied_entries"] < ONLINE_LEG1 or \
                sub_stats["full_refreshes"] or \
                sub_stats["modes"] != ["subscribe"]:
            raise AssertionError(f"online subscriber: {sub_stats}")
        ph = fm_stats["phase_seconds"]
        n_timed = ONLINE_STEPS
        return {
            "phase": "online", "model": "fm", "fields": N_FIELDS,
            "vocab": VOCAB, "factor_dim": DIM, "batch": TRAIN_BATCH,
            "setup_s": setup_s, "steps": ONLINE_STEPS,
            "loss_first3": losses[:3], "loss_last3": losses[-3:],
            "cpu_first3": cpu, "cpu_rtol": ONLINE_RTOL,
            "ms_per_step": {k: 1e3 * v / n_timed for k, v in ph.items()},
            "leg_s": {"leg1": leg1_s, "leg2": leg2_s, "widedeep": wd_s},
            "examples_per_s_leg1": ONLINE_LEG1 * TRAIN_BATCH / leg1_s,
            "profile": prof,
            "requests_served_during_run": served,
            "check1_served_equal_ps_rows": {
                "max_abs_err": state["err"], "atol": SCORE_ATOL,
                "seconds_to_fresh": fresh_s, "rows_moved_max": moved},
            "check2_freshness": {"slo_s": ONLINE_SLO_S,
                                 "seconds_to_degrade": degrade_s,
                                 "seconds_to_recover": recover_s},
            "check3_swap": swap,
            "widedeep": {"steps": ONLINE_WD_STEPS, "exports": wd.exports,
                         "hidden": HIDDEN, "loss_last": wd.last_loss,
                         "ms_per_step": {
                             k: 1e3 * v / ONLINE_WD_STEPS
                             for k, v in wd.stats()["phase_seconds"].items()
                         }},
            "subscriber": {k: sub_stats[k] for k in (
                "applied_entries", "dropped_rows", "full_refreshes",
                "modes")},
            "batches_scored": batches_scored, "launches": launches,
        }
    finally:
        for c in (cli, admin):
            if c is not None:
                c.close()
        if sub is not None:
            sub.stop()
        if srv is not None:
            srv.close()
        if ops is not None:
            ops.close()
        svc.close()
        shutil.rmtree(root, ignore_errors=True)


# -- phase: tiered ------------------------------------------------------------

TIERED_HOT_ROWS = 1 << 16   # 1/16 residency, tools/tiered_bench.py's gate
TIERED_SKEW = 1.1           # the bench's bounded-zipf exponent
TIERED_CYCLES = 20          # (a) pull/push cycles at TRAIN_K ids a batch
TIERED_SMALL_CYCLES = 5     # (a)'s bit-for-bit leg ...
TIERED_SMALL_IDS = 1024     # ... at 1,024 ids a batch (< 4,096 slots)
TIERED_SMALL_HOT = 1 << 10
TIERED_RTOL, TIERED_ATOL = 1e-5, 1e-7
TIERED_FAST_HOT = 1 << 17   # (b1): the hot tier holds the working set ...
TIERED_WORKING_SET = 1 << 16  # ... of 2^16 keys, promoted by one gather
TIERED_FAST_STEPS = 10
TIERED_CPU_STEPS = 2        # (b1)'s first steps re-run on the CPU port
#: the CPU re-run's bound on (b1)'s apply, in ulps of its largest operand:
#: the card's rsqrtf (within 2 ulp of 1/sqrt) and the CPU's rsqrt (within
#: 1) differ by up to 3 ulp, and the update's product rounds once more;
#: the card's plain version (the same rsqrtf) is held to MAX_ULP
CPU_APPLY_ULP = MAX_ULP + 2
TIERED_MIXED_STEPS = 10
TIERED_PROFILE_STEPS = 3
TIERED_ONLINE_STEPS = 10


def zipf_ids(np, rng, perm, cdf, n):
    """``n`` ids of the bounded zipf over the vocabulary's seeded
    permutation (tools/tiered_bench.py's stream: hot ids scattered through
    the keyspace)."""
    rank = np.minimum(np.searchsorted(cdf, rng.random(n), side="right"),
                      len(perm) - 1)
    return perm[rank]


def zipf_table(np, seed):
    """(permutation, cdf) of the bounded zipf at TIERED_SKEW over VOCAB."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(VOCAB).astype(np.int64)
    p = 1.0 / np.arange(1, VOCAB + 1, dtype=np.float64) ** TIERED_SKEW
    return perm, np.cumsum(p / p.sum())


def tiered_expected_launches(sk, part, steps) -> dict:
    """(exact, at_least) launches of one part of the tiered path.  (a):
    the store's B3 reads the pair (a pull's hot rows, a push's two
    gathers, each demotion's two) and nothing else launches; (b): one B3
    gather and at most one B5 (merge mode) a step, B5 on every all-hot
    step; (c): the online steps' lookups' backward (B4, twice a step),
    the store's and the server cache's B3 gathers."""
    exact = dict.fromkeys(sk.KERNELS, 0)
    least = {}
    if part == "a":
        del exact["gather_rows"]
        least["gather_rows"] = 3 * steps
    elif part in ("b1", "b2"):
        del exact["gather_rows"]
        least["gather_rows"] = steps
        if part == "b1":
            exact["merge_apply"] = steps
        else:
            del exact["merge_apply"]
            least["merge_apply"] = 1
    else:
        del exact["gather_rows"]
        least["gather_rows"] = steps
        exact["merge_rows"] = 2 * steps
    return {"exact": exact, "at_least": least}


def hold_launches(sk, part, steps, launches) -> None:
    plan = tiered_expected_launches(sk, part, steps)
    bad = {k: v for k, v in plan["exact"].items() if launches[k] != v}
    bad |= {k: v for k, v in plan["at_least"].items() if launches[k] < v}
    if bad:
        raise AssertionError(f"tiered ({part}) launches {launches}, "
                             f"planned {plan}")


def tiered_store(root, name, device_hot, device="cuda", **kw):
    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

    return TieredEmbeddingStore(
        dim=ROW_DIM, hot_rows=kw.pop("hot_rows", TIERED_HOT_ROWS),
        path=os.path.join(root, name, "store"), device_hot=device_hot,
        device=device, **kw)


def preload_table(store, keys, rows):
    for lo in range(0, len(keys), PRELOAD_CHUNK):
        store.preload_batch(keys[lo:lo + PRELOAD_CHUNK],
                            rows[lo:lo + PRELOAD_CHUNK])


def ulp_count(np, a, b) -> tuple:
    """(elements that differ, largest ulp distance) of two float32
    arrays."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(1 << 31) - i, i)
    d = np.abs(ordered(a) - ordered(b))
    return int((d > 0).sum()), int(d.max()) if d.size else 0


def apply_ulp(np, got, want, before) -> float:
    """Largest distance between two results of Adagrad applies to the same
    rows, in ulps of the apply's largest operand (the row before, after,
    or the update between them): the scale in which a subtraction's
    rounding is bounded.  Where the update cancels the row (a first
    Adagrad step moves a weight by about lr), the result's own ulp is
    many orders finer than either operand's, and a one-ulp difference in
    the update reads as thousands of the result's ulps."""
    g, w, b = (np.asarray(x, np.float64) for x in (got, want, before))
    scale = np.maximum(np.maximum(np.abs(w), np.abs(b)), np.abs(b - w))
    unit = np.spacing(scale.astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(g - w) / unit)) if g.size else 0.0


def host_rounding(np, torch, bindings, seed) -> dict:
    """What the twin's numpy mode rests on, on this host's CPU: how often
    ``torch.sqrt`` of a CPU float32 tensor (and of its float64) parts
    from ``np.sqrt``, and ``tiered.sqrt_rn`` (0 expected); and how many
    weights and accumulators the native ``rows_adagrad`` (the numpy
    mode's path past 4,096 slots) changes from numpy's expression at
    8,192 x 33."""
    from lightctr_tpu_torch.embed.tiered import sqrt_rn

    rng = np.random.default_rng(seed + 73)
    x = (rng.random(270336) * 4).astype(np.float32)
    xt = torch.from_numpy(x)
    want = np.sqrt(x)
    n, d, lr, eps = 8192, ROW_DIM, np.float32(LR), np.float32(EPS)
    w = rng.standard_normal((n, d), dtype=np.float32)
    acc = rng.random((n, d), dtype=np.float32)
    g = rng.standard_normal((n, d), dtype=np.float32)
    slots = np.arange(n, dtype=np.int64)
    wn, an = w.copy(), acc.copy()
    bindings.rows_adagrad_native(wn, an, slots, g, float(lr), float(eps))
    a2 = acc + g * g
    w2 = w - lr * g / np.sqrt(a2 + eps)
    return {"values": int(x.size),
            "torch_sqrt_f32_vs_np": int((torch.sqrt(xt).numpy()
                                         != want).sum()),
            "torch_sqrt_f64_vs_np_f64": int(
                (torch.sqrt(xt.double()).numpy()
                 != np.sqrt(x.astype(np.float64))).sum()),
            "sqrt_rn_vs_np": int((sqrt_rn(xt).numpy() != want).sum()),
            "native_adagrad_slots": n,
            "native_adagrad_weights_differ": int((wn != w2).sum()),
            "native_adagrad_accums_differ": int((an != a2).sum())}


def tiered_cycle(np, torch, store, ids, nxt, step, target, times):
    """One pull/push cycle of the teaching task (tests/test_tiered.py's
    recipe: gradient 0.1 * (row - target)), the next batch dispatched to
    the store's prefetch between them, as tools/tiered_bench.py drives
    it."""
    hits = store.registry.snapshot()["counters"].get(
        "tiered_hot_hits_total", 0)
    t0 = time.perf_counter()
    rows = store.pull_batch(ids, worker_epoch=step, worker_id=0)
    t1 = time.perf_counter()
    hits = store.registry.snapshot()["counters"].get(
        "tiered_hot_hits_total", 0) - hits
    if nxt is not None:
        store.dispatch_prefetch(nxt)
    uniq, first = np.unique(ids, return_index=True)
    g = (np.float32(0.1) * (rows[first] - target[uniq])).astype(np.float32)
    t2 = time.perf_counter()
    store.push_batch(0, uniq, g, worker_epoch=step)
    if store.device_hot:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    times["pull"].append(t1 - t0)
    times["push"].append(t3 - t2)
    return rows, len(uniq), hits


def tiered_store_leg(np, torch, sk, seed, root, keys, rows0, perm,
                     cdf) -> tuple:
    """(a): the store on the card against its numpy-mode twin."""
    from lightctr_tpu_torch.embed.tiered import sqrt_rn

    t0 = time.perf_counter()
    dev = tiered_store(root, "dev", True, learning_rate=LR,
                       seed=seed)
    twin = tiered_store(root, "twin", False, learning_rate=LR,
                        seed=seed)
    for s in (dev, twin):
        if type(s._warm_store).__name__ != "ShmKV":
            raise AssertionError(f"tiered: warm tier is "
                                 f"{type(s._warm_store).__name__}, not "
                                 f"the native ShmKV")
        preload_table(s, keys, rows0)
    preload_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 71)
    target = (0.5 * rng.standard_normal((VOCAB, ROW_DIM),
                                        dtype=np.float32))
    stream = [zipf_ids(np, rng, perm, cdf, TRAIN_K)
              for _ in range(TIERED_CYCLES + 1)]
    times = {"dev": {"pull": [], "push": []},
             "twin": {"pull": [], "push": []}}
    n_diff = max_ulp = 0
    max_err = 0.0
    uniq_total = 0
    hot_hits = 0
    torch.cuda.synchronize()
    sk.reset_launches()
    for i in range(TIERED_CYCLES):
        rd, nu, hits = tiered_cycle(np, torch, dev, stream[i],
                                    stream[i + 1], i, target, times["dev"])
        rt, _, _ = tiered_cycle(np, torch, twin, stream[i], stream[i + 1],
                                i, target, times["twin"])
        uniq_total += nu
        hot_hits += hits
        if not np.allclose(rd, rt, rtol=TIERED_RTOL, atol=TIERED_ATOL):
            raise AssertionError(f"tiered (a): cycle {i} pulled rows part "
                                 f"from the twin by "
                                 f"{float(np.abs(rd - rt).max())}")
        d, u = ulp_count(np, rd, rt)
        n_diff, max_ulp = n_diff + d, max(max_ulp, u)
        max_err = max(max_err, float(np.abs(rd - rt).max()))
    torch.cuda.synchronize()
    launches = sk.launches()
    hold_launches(sk, "a", TIERED_CYCLES, launches)
    # held after the counted run: the state snapshots and the tiers
    ka, ra, aa = dev.snapshot_state_arrays()
    kb, rb, ab = twin.snapshot_state_arrays()
    if not np.array_equal(ka, kb):
        raise AssertionError("tiered (a): snapshot keys differ")
    snap = {}
    for what, x, y in (("rows", ra, rb), ("accums", aa, ab)):
        if not np.allclose(x, y, rtol=TIERED_RTOL, atol=TIERED_ATOL):
            raise AssertionError(f"tiered (a): snapshot {what} part by "
                                 f"{float(np.abs(x - y).max())}")
        d, u = ulp_count(np, x, y)
        snap[what] = {"elements_differing": d, "max_ulp": u,
                      "max_abs_err": float(np.abs(x - y).max())}
    c = dev.registry.snapshot()["counters"]
    faults = {"warm": c.get("tiered_warm_faults_total", 0),
              "cold": c.get("tiered_cold_faults_total", 0)}
    demoted = sum(v for k, v in c.items()
                  if k.startswith("tiered_demotions_total"))
    st = dev.stats()["store"]
    if not (faults["warm"] > 0 and faults["cold"] > 0 and demoted > 0
            and dev.peak_hot_rows <= TIERED_HOT_ROWS):
        raise AssertionError(f"tiered (a): faults {faults}, demotions "
                             f"{demoted}, peak {dev.peak_hot_rows}")
    # the square root: the port's sqrt_rn against torch.sqrt on the card,
    # on the hot accumulators' own acc + eps
    _, acc = dev.device_tables()
    xe = acc + torch.tensor(dev.eps, dtype=torch.float32, device="cuda")
    sqrt_diff = int((torch.sqrt(xe) != sqrt_rn(xe)).sum())
    sqrt_ref = int((torch.sqrt(xe).cpu().numpy()
                    != np.sqrt(xe.cpu().numpy())).sum())
    twin.close()

    # the bit-for-bit leg: fresh stores, below 4,096 slots a push
    small = [tiered_store(root, f"small_{m}", m == "dev",
                          hot_rows=TIERED_SMALL_HOT, learning_rate=LR,
                          seed=seed) for m in ("dev", "twin")]
    srng = np.random.default_rng(seed + 72)
    sstream = [zipf_ids(np, srng, perm, cdf, TIERED_SMALL_IDS)
               for _ in range(TIERED_SMALL_CYCLES + 1)]
    scratch = {"pull": [], "push": []}
    for i in range(TIERED_SMALL_CYCLES):
        got = [tiered_cycle(np, torch, s, sstream[i], sstream[i + 1], i,
                            target, scratch)[0] for s in small]
        if not np.array_equal(got[0], got[1]):
            raise AssertionError(f"tiered (a) small leg: cycle {i} not "
                                 f"bit for bit")
    for x, y in zip(small[0].snapshot_state_arrays(),
                    small[1].snapshot_state_arrays()):
        if not np.array_equal(x, y):
            raise AssertionError("tiered (a) small leg: snapshot not bit "
                                 "for bit")
    for s in small:
        s.close()
    from lightctr_tpu_torch.native import bindings

    host = host_rounding(np, torch, bindings, seed)
    if host["sqrt_rn_vs_np"]:
        raise AssertionError(f"tiered (a): sqrt_rn parts from np.sqrt: "
                             f"{host}")
    fp = st["fault_pipeline"]
    med = {k: {op: 1e3 * statistics.median(v[op]) for op in v}
           for k, v in times.items()}
    return dev, {
        "hot_rows": TIERED_HOT_ROWS, "vocab": VOCAB, "dim": ROW_DIM,
        "ids_per_cycle": TRAIN_K, "cycles": TIERED_CYCLES,
        "skew": TIERED_SKEW, "preload_s": preload_s,
        "host_bytes_row_accum": 2 * VOCAB * ROW_DIM * 4,
        "pull_ms": med["dev"]["pull"], "push_ms": med["dev"]["push"],
        "twin_pull_ms": med["twin"]["pull"],
        "twin_push_ms": med["twin"]["push"],
        "hot_hit_rate_pull": hot_hits / uniq_total,
        "faults": faults, "demotions": demoted,
        "peak_hot_rows": dev.peak_hot_rows,
        "fault_overlap_ratio": fp["overlap_ratio"],
        "tiers": st["tiers"],
        "pulled_vs_twin": {"rtol": TIERED_RTOL, "atol": TIERED_ATOL,
                           "elements_differing": n_diff,
                           "max_ulp": max_ulp, "max_abs_err": max_err},
        "snapshot_vs_twin": snap,
        "small_leg_bit_for_bit": {"cycles": TIERED_SMALL_CYCLES,
                                  "ids": TIERED_SMALL_IDS,
                                  "hot_rows": TIERED_SMALL_HOT},
        "host_rounding": host,
        "sqrt": {"route": "sqrt_rn (float64 root, one-ulp fix-up) on "
                          "every device",
                 "values": int(xe.numel()),
                 "cuda_torch_sqrt_vs_sqrt_rn_differ": sqrt_diff,
                 "cuda_torch_sqrt_vs_np_sqrt_differ": sqrt_ref},
        "launches": launches,
    }


def fm_step_grads(torch, rows_u, inv, batch):
    """FM's logloss on the gathered rows: the gradient with respect to
    the per-position rows ``rows_u[inv]``, made a leaf (no index
    backward enters the step), split ``[w ‖ v]`` as
    ``serve.fm_ps_row_leaves(DIM)`` reads the row."""
    import torch.nn.functional as tnf

    pos = rows_u.index_select(0, inv).detach().requires_grad_(True)
    rows = pos.reshape(TRAIN_BATCH, N_FIELDS, ROW_DIM)
    vals = batch["vals"]
    w, v = rows[..., 0], rows[..., 1:]
    vx = v * vals[..., None]
    sumvx = vx.sum(1)
    z = (w * vals).sum(-1) + 0.5 * ((sumvx * sumvx).sum(-1)
                                    - (vx * vx).sum((1, 2)))
    loss = tnf.binary_cross_entropy_with_logits(z, batch["labels"])
    loss.backward()
    return loss.detach(), pos.grad


def fm_batch(np, torch, rng, fids):
    """A 4,096-row FM batch on the card: ``fids`` as its ids, values and
    labels from ``criteo_rows``."""
    b = criteo_rows(np, rng, TRAIN_BATCH)
    return {"fids": fids.reshape(TRAIN_BATCH, N_FIELDS),
            "vals": torch.from_numpy(b["vals"]).cuda(),
            "labels": torch.from_numpy(b["labels"]).cuda()}


def fast_path_steps(np, torch, emb, batches, times, record=None,
                    prefetch=None):
    """FM steps on ``TieredDeviceEmbedding``: gather (B3), forward and
    backward, apply (B5 in place); per-part wall times."""
    losses = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        rows_u, inv, tk = emb.gather(b["fids"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, g = fm_step_grads(torch, rows_u, inv, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if prefetch is not None and i + 1 < len(prefetch):
            emb.prefetch_next(prefetch[i + 1])
        emb.apply(tk, g)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        times["gather"].append(t1 - t0)
        times["compute"].append(t2 - t1)
        times["apply"].append(t3 - t2)
        losses.append(float(loss))
        if record is not None:
            record.append((tk["uniq"], tk["inv"], g.detach().clone()))
    return losses


def tiered_fast_path(np, torch, sk, seed, root, rows0, dev_store, perm,
                     cdf) -> dict:
    """(b): FM on ``TieredDeviceEmbedding``, all-hot (b1) and mixed (b2)."""
    from lightctr_tpu_torch.models.sparse_trainer import TieredDeviceEmbedding

    rng = np.random.default_rng(seed + 81)
    ws = np.sort(rng.choice(VOCAB, TIERED_WORKING_SET, replace=False)
                 ).astype(np.int64)
    store = tiered_store(root, "fast", True,
                         hot_rows=TIERED_FAST_HOT, learning_rate=LR,
                         seed=seed, prefetch=False)
    preload_table(store, ws, rows0[ws])
    emb = TieredDeviceEmbedding(store)
    emb.gather(ws)                      # promotes the working set whole
    if int((store.hot_slots(ws) >= 0).sum()) != TIERED_WORKING_SET or \
            not (store.hot_slots(ws) == 0).any():
        raise AssertionError("tiered (b1): the working set is not hot")
    batches = [fm_batch(np, torch, rng, ws[rng.integers(
        0, TIERED_WORKING_SET, TRAIN_K)])
        for _ in range(TIERED_FAST_STEPS + TIERED_PROFILE_STEPS)]
    slots0 = store.hot_slots(ws)
    record = []
    times = {"gather": [], "compute": [], "apply": []}
    torch.cuda.synchronize()
    sk.reset_launches()
    losses = fast_path_steps(np, torch, emb, batches[:TIERED_FAST_STEPS],
                             times, record)
    torch.cuda.synchronize()
    launches_b1 = sk.launches()
    hold_launches(sk, "b1", TIERED_FAST_STEPS, launches_b1)
    if emb.fast_steps != TIERED_FAST_STEPS or emb.mixed_steps or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"tiered (b1): fast {emb.fast_steps}, mixed "
                             f"{emb.mixed_steps}, losses {losses}")
    prof = profile_calls(torch, [
        lambda b=b: fast_path_steps(np, torch, emb, [b],
                                    {"gather": [], "compute": [],
                                     "apply": []}, record)
        for b in batches[TIERED_FAST_STEPS:]])
    prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / (
        prof["profiled_wall_ms"] / TIERED_PROFILE_STEPS)
    # against the unprofiled steps' wall time (the profiler's own cost
    # is in its wall time)
    prof["idle_share_timed_steps"] = 1.0 - prof["device_ms_per_step"] / (
        1e3 * sum(statistics.median(v) for v in times.values()))
    # the oracle: B5 on a dense [VOCAB, 33] table and accumulator, given
    # the same uids, rows and inv, bit for bit
    W = torch.from_numpy(rows0).cuda()
    A = torch.zeros_like(W)
    for uq, inv, g in record:
        uids = np.zeros(sk.next_pow2(len(uq)), np.int32)
        uids[:len(uq)] = uq
        sk.merge_apply(W, A, torch.from_numpy(uids).cuda(), g,
                       torch.from_numpy(inv.astype(np.int32)).cuda(),
                       lr=store.lr, eps=store.eps, denom=1.0)
    w, a = store.device_tables()
    s_t = torch.from_numpy(slots0).cuda()
    k_t = torch.from_numpy(ws).cuda()
    if not (torch.equal(w.index_select(0, s_t), W.index_select(0, k_t))
            and torch.equal(a.index_select(0, s_t),
                            A.index_select(0, k_t))):
        raise AssertionError("tiered (b1): the fast path is not B5 on a "
                             "dense table bit for bit")
    # the first steps on the CPU port (plain B3 and B5), each from the
    # card's state before it and the card's gradients (the apply's
    # inputs), within CPU_APPLY_ULP of the card's state after it; the
    # plain version on the card within MAX_ULP
    cpu = tiered_store(root, "fast_cpu", True, device="cpu",
                       hot_rows=TIERED_FAST_HOT, learning_rate=LR,
                       seed=seed, prefetch=False)
    preload_table(cpu, ws, rows0[ws])
    cemb = TieredDeviceEmbedding(cpu)
    cemb.gather(ws)
    if not np.array_equal(cpu.hot_slots(ws), slots0):
        raise AssertionError("tiered (b1): the CPU store's slots differ")
    s_c = torch.from_numpy(slots0)
    dense = [torch.from_numpy(rows0).cuda(), None]
    dense[1] = torch.zeros_like(dense[0])
    ulps = {"rows": [], "accums": []}
    plain_ulps = {"rows": [], "accums": []}
    for (uq, inv, g), b in zip(record[:TIERED_CPU_STEPS], batches):
        before = [t.index_select(0, k_t).cpu() for t in dense]
        plain = [t.clone() for t in dense]
        w, a = cpu.device_tables()
        w[s_c], a[s_c] = before
        cpu.adopt_device_tables(w, a)
        _, _, tk = cemb.gather(b["fids"])
        cemb.apply(tk, g.cpu())
        uids = np.zeros(sk.next_pow2(len(uq)), np.int32)
        uids[:len(uq)] = uq
        uids_t = torch.from_numpy(uids).cuda()
        inv_t = torch.from_numpy(inv.astype(np.int32)).cuda()
        sk.merge_apply(dense[0], dense[1], uids_t, g, inv_t, lr=store.lr,
                       eps=store.eps, denom=1.0)
        sk.merge_apply_plain(plain[0], plain[1], uids_t, g, inv_t, store.lr,
                             store.eps, 1.0)
        for what, x, y in (("rows", plain[0], dense[0]),
                           ("accums", plain[1], dense[1])):
            u = ulp_diff(torch, x.index_select(0, k_t),
                         y.index_select(0, k_t))
            plain_ulps[what].append(u)
            if u > MAX_ULP:
                raise AssertionError(f"tiered (b1): B5 vs its plain version "
                                     f"on the card, {what} {u} ulp")
        w, a = cpu.device_tables()
        for what, x, y, x0 in (
                ("rows", w.index_select(0, s_c), dense[0], before[0]),
                ("accums", a.index_select(0, s_c), dense[1], before[1])):
            y = y.index_select(0, k_t).cpu()
            u = apply_ulp(np, x.numpy(), y.numpy(), x0.numpy())
            ulps[what].append(u)
            if u > CPU_APPLY_ULP:
                raise AssertionError(
                    f"tiered (b1): CPU port's {what} {u} ulp from the "
                    f"card's (result ulp {ulp_diff(torch, x, y)}, abs "
                    f"{float((x - y).abs().max())})")
    cpu.close()
    store.close()

    # (b2): mixed residency on (a)'s store, the full zipf stream
    emb2 = TieredDeviceEmbedding(dev_store)
    ids2 = [zipf_ids(np, rng, perm, cdf, TRAIN_K)
            for _ in range(TIERED_MIXED_STEPS)]
    batches2 = [fm_batch(np, torch, rng, i) for i in ids2]
    times2 = {"gather": [], "compute": [], "apply": []}
    torch.cuda.synchronize()
    sk.reset_launches()
    losses2 = fast_path_steps(np, torch, emb2, batches2, times2,
                              prefetch=ids2)
    torch.cuda.synchronize()
    launches_b2 = sk.launches()
    hold_launches(sk, "b2", TIERED_MIXED_STEPS, launches_b2)
    touched = np.unique(np.concatenate(ids2))
    rows, _, known = dev_store.pull_state_batch(touched)
    if not (emb2.mixed_steps > 0 and known.all()
            and np.isfinite(rows).all() and all(np.isfinite(losses2))):
        raise AssertionError(f"tiered (b2): mixed {emb2.mixed_steps}, "
                             f"known {known.all()}")
    # a hot key evicted under a live ticket: the apply takes the store
    # surface, and a direct stale adopt refuses
    rows_u, inv, tk = emb2.gather(batches2[0]["fids"])
    dev_store.evict_batch(tk["uniq"][tk["hot"]][:1])
    before = emb2.stale_tickets
    emb2.apply(tk, torch.zeros((TRAIN_K, ROW_DIM), device="cuda"))
    w, a = dev_store.device_tables()
    try:
        dev_store.adopt_device_tables(w, a, expect_res_epoch=-1)
        raise AssertionError("tiered (b2): a stale adopt was accepted")
    except ValueError:
        pass
    if emb2.stale_tickets != before + 1:
        raise AssertionError("tiered (b2): the stale ticket went unseen")

    def ms(t):
        return {k: 1e3 * statistics.median(v) for k, v in t.items()}

    return {
        "b1": {"hot_rows": TIERED_FAST_HOT,
               "working_set": TIERED_WORKING_SET,
               "steps": TIERED_FAST_STEPS, "fast_steps": emb.fast_steps,
               "loss_first3": losses[:3], "loss_last3": losses[-3:],
               "ms_per_step": ms(times),
               "dense_b5_oracle": "bit for bit",
               "cpu_rerun": {"steps": TIERED_CPU_STEPS,
                             "operand_ulp_per_step": ulps,
                             "bound_ulp": CPU_APPLY_ULP,
                             "card_plain_ulp_per_step": plain_ulps,
                             "card_plain_bound_ulp": MAX_ULP,
                             "note": "each step from the card's state "
                                     "before it, the card's gradients"},
               "profile": prof, "launches": launches_b1},
        "b2": {"hot_rows": TIERED_HOT_ROWS, "steps": TIERED_MIXED_STEPS,
               "fast_steps": emb2.fast_steps,
               "mixed_steps": emb2.mixed_steps,
               "stale_tickets": emb2.stale_tickets,
               "loss_first3": losses2[:3], "loss_last3": losses2[-3:],
               "ms_per_step": ms(times2), "launches": launches_b2},
    }


TIERED_WARM_STEPS = 2       # (c): steps before the cache warms off the ledger


def tiered_online(np, torch, sk, seed, root, path, requests,
                  flat) -> dict:
    """(c): the online phase's FM run with its PS backed by a tiered store
    on the card; a server whose cache warms off the store's ledger and a
    freshness subscriber alongside."""
    from lightctr_tpu_torch import online, serve
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.ledger import FrequencyLedger

    t0 = time.perf_counter()
    params = make_params(np, seed + 30)
    keys, rows0 = serve.fused_fm_rows(params)
    store = tiered_store(root, "online", True, n_workers=2,
                         seed=seed, learning_rate=LR,
                         staleness_threshold=1 << 30,
                         ledger=FrequencyLedger())
    store.WRITE_LOG_MAX_UIDS = ONLINE_LOG_UIDS
    svc = ParamServerService(store)
    admin = srv = sub = cli = None
    try:
        admin = PSClient(svc.address, ROW_DIM)
        for lo in range(0, VOCAB, PRELOAD_CHUNK):
            admin.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                                 rows0[lo:lo + PRELOAD_CHUNK])
        setup_s = time.perf_counter() - t0
        srv = serve.PredictionServer(
            serve.ServingModel("fm", {}, row_leaves=serve.fm_ps_row_leaves(
                DIM), row_dim=ROW_DIM, device="cuda"),
            ps=PSClient(svc.address, ROW_DIM), max_batch=256,
            device="cuda")
        sub = online.FreshnessSubscriber(
            srv, [svc.address], ROW_DIM, slo_s=ONLINE_SLO_S, poll_ms=400
        ).start()
        cli = serve.PredictClient(srv.address)
        tr = online.OnlineTrainer(admin, "fm", DIM, worker_id=0,
                                  device="cuda")
        losses = []
        step = tr.step
        tr.step = lambda mb, stop=None: losses.append(step(mb, stop)) or \
            losses[-1]
        wait_for(lambda: sub.stats()["versions"][0] >= 0, 10,
                 "the subscriber's arm")
        torch.cuda.synchronize()
        sk.reset_launches()
        stream = online_stream(path)
        for _ in range(TIERED_WARM_STEPS):
            tr.step(next(stream))
        warmed = srv.warm_from_ledger(store.ledger)
        if not warmed > 0:
            raise AssertionError("tiered (c): the ledger warmed no rows")
        errs = []

        def leg():
            try:
                tr.run(stream, max_steps=TIERED_ONLINE_STEPS, prefetch=2)
            except BaseException as e:  # surfaced after the join
                errs.append(e)

        t_leg = time.perf_counter()
        th = threading.Thread(target=leg)
        th.start()
        served = 0
        while th.is_alive() or served < N_REQUESTS:
            scores = cli.predict(requests[served % N_REQUESTS])
            if scores.shape != (REQUEST_ROWS,) or \
                    not np.all(np.isfinite(scores)):
                raise AssertionError(f"tiered (c): bad scores "
                                     f"{scores.shape}")
            served += 1
        th.join()
        if errs:
            raise errs[0]
        leg_s = time.perf_counter() - t_leg
        uids = np.unique(np.concatenate(
            [r["fids"].reshape(-1) for r in requests]).astype(np.int64))
        _, live = admin.pull_arrays(uids, worker_epoch=0, worker_id=None,
                                    create=False)
        trained = {"w": np.zeros(VOCAB, np.float32),
                   "v": np.zeros((VOCAB, DIM), np.float32)}
        trained["w"][uids] = live[:, 0]
        trained["v"][uids] = live[:, 1:]
        refs = [fm_forward64(np, trained, r) for r in requests]
        state = {"err": None}

        def served_fresh():
            state["err"] = max(float(np.abs(cli.predict(r) - ref).max())
                               for r, ref in zip(requests, refs))
            return state["err"] < SCORE_ATOL

        fresh_s = wait_for(served_fresh, ONLINE_DEADLINE_S,
                           "served scores to pick up the tiered rows")
        torch.cuda.synchronize()
        launches = sk.launches()
        batches_scored = srv.stats()["batches_scored"]
        hold_launches(sk, "c", TIERED_ONLINE_STEPS, launches)
        if launches["gather_rows"] < batches_scored:
            raise AssertionError(f"tiered (c): gather_rows "
                                 f"{launches['gather_rows']} < "
                                 f"{batches_scored} scored batches")
        fm_stats = tr.stats()
        if tr.steps != TIERED_ONLINE_STEPS or fm_stats["push_failures"] \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"tiered (c): {fm_stats}")
        if not np.allclose(losses[:3], flat["loss_first3"],
                           rtol=ONLINE_RTOL, atol=0):
            raise AssertionError(f"tiered (c): losses {losses[:3]} vs the "
                                 f"flat PS's {flat['loss_first3']}")
        sub_stats = sub.stats()
        if sub_stats["modes"] != ["subscribe"] or \
                sub_stats["full_refreshes"]:
            raise AssertionError(f"tiered (c) subscriber: {sub_stats}")
        st = store.stats()["store"]
        if not st["fault_pipeline"]["overlap_rows"] > 0:
            raise AssertionError(f"tiered (c): the push echo staged "
                                 f"nothing: {st['fault_pipeline']}")
        ph = fm_stats["phase_seconds"]
        hist = store.registry.snapshot()["histograms"]
        in_store = {op: 1e3 * hist[f"ps_store_{op}_seconds"]["sum"]
                    / max(1, hist[f"ps_store_{op}_seconds"]["count"])
                    for op in ("pull", "push")
                    if f"ps_store_{op}_seconds" in hist}
        return {
            "setup_s": setup_s, "steps": TIERED_ONLINE_STEPS,
            "store_ms_per_call": in_store,
            "store_calls": {op: hist[f"ps_store_{op}_seconds"]["count"]
                            for op in ("pull", "push")
                            if f"ps_store_{op}_seconds" in hist},
            "warmed_rows": warmed, "loss_first3": losses[:3],
            "flat_loss_first3": flat["loss_first3"],
            "ms_per_step": {k: 1e3 * v / TIERED_ONLINE_STEPS
                            for k, v in ph.items()},
            "flat_ms_per_step": flat["ms_per_step"],
            "leg_s": leg_s, "requests_served_during_run": served,
            "served_vs_shard": {"max_abs_err": state["err"],
                                "atol": SCORE_ATOL,
                                "seconds_to_fresh": fresh_s},
            "subscriber": {k: sub_stats[k] for k in (
                "applied_entries", "full_refreshes", "modes")},
            "fault_pipeline": st["fault_pipeline"],
            "tiers": st["tiers"], "batches_scored": batches_scored,
            "launches": launches,
        }
    finally:
        for c in (cli, admin):
            if c is not None:
                c.close()
        if sub is not None:
            sub.stop()
        if srv is not None:
            srv.close()
        svc.close()
        store.close()


def tiered_kernel_ms(np, torch, sk, seed) -> dict:
    """B3 and B5 at the tiered path's shapes: B3 off the [2^16, 33] pair at
    the pow2 lengths the store pads to, and B5 (merge mode) at the fast
    path's (b1) shapes; each beside its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 91)
    pair = torch.randn((TIERED_HOT_ROWS, ROW_DIM), generator=gen,
                       device="cuda")
    out = {"gather_rows": {}, "merge_apply": {}}
    for n in (1 << 10, 1 << 14, 1 << 17):
        idx = torch.randint(0, TIERED_HOT_ROWS, (n,), generator=gen,
                            device="cuda", dtype=torch.int32)
        read = int(torch.unique(idx).numel())
        out["gather_rows"][str(n)] = {
            "ms": graph_ms(torch, lambda: sk.gather_rows(pair, idx)),
            "plain_ms": graph_ms(torch,
                                 lambda: sk.gather_rows_plain(pair, idx)),
            "bound_ms": bound_ms(read * ROW_DIM * 4 + n * 4
                                 + n * ROW_DIM * 4)}
    rng = np.random.default_rng(seed + 92)
    ids = rng.integers(0, TIERED_WORKING_SET, TRAIN_K)
    uq, inv = np.unique(ids, return_inverse=True)
    sp, mp = sk.next_pow2(len(uq)), sk.next_pow2(TRAIN_K)
    uids = torch.zeros(sp, dtype=torch.int32, device="cuda")
    uids[:len(uq)] = torch.from_numpy(uq.astype(np.int32)).cuda()
    inv_p = torch.full((mp,), sp - 1, dtype=torch.int32, device="cuda")
    inv_p[:TRAIN_K] = torch.from_numpy(inv.astype(np.int32)).cuda()
    rows = torch.zeros((mp, ROW_DIM), device="cuda")
    rows[:TRAIN_K] = torch.randn((TRAIN_K, ROW_DIM), generator=gen,
                                 device="cuda")
    w = torch.randn((TIERED_FAST_HOT, ROW_DIM), generator=gen,
                    device="cuda")
    a = torch.zeros_like(w)

    def fused():
        sk.merge_apply(w, a, uids, rows, inv_p, lr=1e-9, eps=EPS)

    def plain():
        sk.merge_apply_plain(w, a, uids, rows, inv_p, 1e-9, EPS, 1.0)

    nbytes, _ = sk.kernel_cost("merge_apply", w, a, uids, rows, inv_p,
                               1e-9, EPS, 1.0)
    out["merge_apply"] = {
        "sp": sp, "mp": mp, "touched": int(len(uq)),
        "ms": graph_ms(torch, fused), "plain_ms": call_ms(torch, plain,
                                                          reps=20),
        "bound_ms": bound_ms(nbytes)}
    return out


def phase_tiered(np, torch, sk, seed, path, requests, flat) -> dict:
    """The tiered embedding store on the card (its hot pair read by B3 and
    written in place), the trainer's fast path on it (B3, then B5 in
    place), and a tiered PS shard behind online training and serving.
    (a) the store at 1/16 residency over 20 bounded-zipf cycles of
    159,744 ids against its numpy-mode twin (rtol 1e-5 / atol 1e-7; bit
    for bit on a 5-cycle leg at 1,024 ids); (b1) FM all-hot on
    ``TieredDeviceEmbedding``, bit for bit B5 on a dense table, its
    first steps on the CPU port within MAX_ULP; (b2) FM over the mixed
    stream with ``prefetch_next``, a stale ticket refused; (c) the
    online FM run against a tiered shard (served scores within
    SCORE_ATOL of the shard's rows, the subscriber in subscribe mode, the
    push echo staging rows, the first losses within ONLINE_RTOL of the
    flat PS's).  Counts reset before each part and held to
    ``tiered_expected_launches``."""
    root = tempfile.mkdtemp(prefix="chip_smoke_tiered_")
    from lightctr_tpu_torch import serve

    params = make_params(np, seed + 30)
    keys, rows0 = serve.fused_fm_rows(params)
    perm, cdf = zipf_table(np, seed + 70)
    dev = None
    try:
        t = time.perf_counter()
        dev, store_info = tiered_store_leg(np, torch, sk, seed, root, keys,
                                           rows0, perm, cdf)
        store_info["part_s"] = time.perf_counter() - t
        t = time.perf_counter()
        fast = tiered_fast_path(np, torch, sk, seed, root, rows0, dev, perm,
                                cdf)
        fast["part_s"] = time.perf_counter() - t
        dev.close()
        dev = None
        t = time.perf_counter()
        shard = tiered_online(np, torch, sk, seed, root, path, requests,
                              flat)
        shard["part_s"] = time.perf_counter() - t
        kms = tiered_kernel_ms(np, torch, sk, seed)
        launches = {k: store_info["launches"][k]
                    + fast["b1"]["launches"][k] + fast["b2"]["launches"][k]
                    + shard["launches"][k] for k in sk.KERNELS}
        for name in ("gather_rows", "merge_apply"):
            if launches[name] == 0:
                raise AssertionError(f"tiered: {name} never launched")
        return {"phase": "tiered", "store": store_info, "fast_path": fast,
                "online_shard": shard, "kernel_ms": kms,
                "launches": launches}
    finally:
        if dev is not None:
            dev.close()
        shutil.rmtree(root, ignore_errors=True)


# -- phase: cluster -----------------------------------------------------------

CLUSTER_HOSTS = 2
CLUSTER_LOCAL = 2           # gloo ranks a host, every one on the one card
CLUSTER_STEPS = 10          # (a), fp32 wire
CLUSTER_FLAT_STEPS = 3      # (a2), one rank a host
CLUSTER_CODED_STEPS = 5     # (a3), q8_ef wire, and (a) continued
CLUSTER_STRAGGLE_STEPS = 3  # (a4), host 1 late in the last
CLUSTER_STRAGGLE_S = 0.5
CLUSTER_PROFILE_STEPS = 2
CLUSTER_DEADLINE_S = 300.0
#: tests/test_hier_exchange.py's bounds against the one-device trainer
HIER_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
HIER_TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
HIER_CODED_ATOL = 2e-3      # q8_ef's losses against the fp32 wire's,
                            # both from (a)'s state
HIER_CODED_BYTES = 0.4      # q8_ef's socket bytes against the fp32 wire's
HIER_FLAT_BAND = 0.1        # (a2)'s socket bytes a step against (a)'s

#: (b): three PS-shard processes, each a tiered store on the card holding
#: its share of the serve cell's 2^20 x 33 table, hot pair 2^16 rows
ELASTIC_SHARDS = 3
ELASTIC_WORKERS = 2
ELASTIC_VOCAB = VOCAB
ELASTIC_HOT_ROWS = 1 << 16
ELASTIC_PASSES = 6
ELASTIC_KILL_AFTER = 3      # SIGKILL shard 1 after this many passes
ELASTIC_VICTIM = 1
ELASTIC_LR = 0.5            # tools/chaos_harness.py's shard learning rate
#: liveness at the reference's 1:2:4 ratio (master.h:202), slower than
#: the harness's demo speed: a shard busy with a 10^5-row push must not
#: miss its beats into a false death
ELASTIC_BEAT_S = 0.25
ELASTIC_STALE_S = 2.0
ELASTIC_DEAD_S = 4.0
#: the snapshot cadence: a full state snapshot of a shard's ~350,000 rows
#: (every tier, rows and accumulators) takes about a second
ELASTIC_CKPT_S = 2.0
#: tools/chaos_harness.py's parity tolerance, held relative to the
#: unperturbed run's MSE
ELASTIC_PARITY = 5e-3
ELASTIC_DEADLINE_S = 60.0
#: (b)'s two runs, side by side: (name, SIGKILL shard ELASTIC_VICTIM)
ELASTIC_RUNS = (("unperturbed", False), ("killed", True))


def hier_expected_launches(sk, steps) -> dict:
    """Launches one rank makes in ``steps`` steps of the two-level
    exchange on FM: the rank's id stream deduped, and the host's union of
    the gathered streams (the local allgather's, or the reduce-scatter
    owner's cut); per table (w, v) the gather's backward and the local
    merge (merge_rows) and the apply of the pre-merged global mean
    (merge_apply's apply mode)."""
    want = dict.fromkeys(sk.KERNELS, 0)
    want.update(dedup_ids=2 * steps, merge_rows=4 * steps,
                merge_apply=2 * steps)
    return want


def same_launches(got, want) -> bool:
    """A spawned rank's launch counts equal ``want``: its registry holds
    the kernels its process imported, so a kernel missing from either side
    counts zero."""
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def cluster_batch(np, seed) -> dict:
    """The criteo_rows batch the two hosts split (host h its h-th half)."""
    return criteo_rows(np, np.random.default_rng(seed + 71), TRAIN_BATCH)


def host_half(batch, host_id) -> dict:
    n = len(batch["labels"]) // CLUSTER_HOSTS
    return {k: v[host_id * n:(host_id + 1) * n] for k, v in batch.items()}


def hier_run(np, torch, sk, tr, batch, steps, device, sleep_last=0.0):
    """``steps`` steps of a hierarchical trainer on this rank, each timed
    as local merge (A) / wire hop (B) / apply (C) on the host clock
    between device synchronisations; launches counted from just before
    the first step to just after the last."""
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    wire = tr._hier_wire
    marks = {}

    def timed_wire(*a):
        sync()
        marks["b0"] = time.perf_counter()
        out = wire(*a)
        sync()
        marks["b1"] = time.perf_counter()
        return out

    tr._hier_wire = timed_wire
    sync()
    sk.reset_launches()
    losses, split = [], []
    try:
        for i in range(steps):
            if sleep_last and i == steps - 1:
                time.sleep(sleep_last)
            sync()
            t0 = time.perf_counter()
            losses.append(float(tr.train_step(batch)))
            sync()
            t1 = time.perf_counter()
            split.append((1e3 * (marks["b0"] - t0),
                          1e3 * (marks["b1"] - marks["b0"]),
                          1e3 * (t1 - marks["b1"])))
    finally:
        tr._hier_wire = wire
    return losses, split, sk.launches()


def cluster_rank(rank, world, host_id, out_dir, seed, device, addrs):
    """One rank of host ``host_id`` (a world of CLUSTER_LOCAL gloo ranks):
    the link probes, then (a) the fp32 wire, (a3) q8_ef, (a4) the
    straggler rounds and (a2) one rank a host, each run a fresh trainer
    from the seed's init on this host's half of the batch, against the
    reduce shards ``addrs[run]``; writes ``host<h>_rank<r>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.dist import collectives
    from lightctr_tpu_torch.dist.hier import HierExchangeClient
    from lightctr_tpu_torch.ops import sparse_kernels as sk
    from lightctr_tpu_torch.optim.updaters import tree_map

    mesh = make_mesh(MeshSpec(data=world), device=device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(mesh.device)
    params = train_params(np, seed)
    batch = host_half(cluster_batch(np, seed), host_id)

    def client(run):
        return HierExchangeClient([tuple(a) for a in addrs[run]],
                                  host_id=host_id, n_hosts=CLUSTER_HOSTS,
                                  codec="q8_ef" if run == "coded" else "f32",
                                  pull_timeout_s=60.0)

    def trainer(c, m=mesh):
        return deep_trainer("fm", "sparse", params, device, LR, mesh=m,
                            hier_exchange=c)

    out = {"device": str(mesh.device), "backend": mesh.backend}
    # the two links: the host group's all-gather (every rank), the wire's
    # round trip through a reduce shard (local rank 0); a probe that
    # fails fails the phase
    ici = collectives.measure_ici_bw(mesh)
    out["ici_bps"] = ici
    if rank == 0:
        c = client("probe")
        try:
            dcn = c.probe_bw()
        finally:
            c.close()
        bw = collectives.link_bandwidth(probe_ici=lambda: ici,
                                        probe_dcn=lambda: dcn, refresh=True)
        k = TRAIN_BATCH // CLUSTER_HOSTS // world * N_FIELDS
        out["link"] = {"ici_bps": bw.ici_bps, "dcn_bps": bw.dcn_bps,
                       "source": bw.source, "dcn_probe_bps": dcn,
                       "pick": {str(d): collectives.pick_exchange_algo(
                           world * CLUSTER_HOSTS, k, VOCAB, d,
                           local_n=world, bw=bw)[0] for d in (1, DIM)}}

    # (a) the fp32 wire
    c = client("exact")
    tr = trainer(c)
    losses, split, launches = hier_run(np, torch, sk, tr, batch,
                                       CLUSTER_STEPS, device)
    rec = {"losses": losses, "split_ms": split, "launches": launches,
           "policy": dict(tr.exchange_policy),
           "local_policy": dict(tr.hier_local_policy),
           "bytes_per_step": dict(tr.exchange_bytes_per_step),
           "socket_bytes": c.bytes_sent + c.bytes_received,
           "connected": c.connected, "digest": state_digest(tr)}
    if rank == 0 and host_id == 0:
        for k in ("w", "v"):
            np.save(os.path.join(out_dir, f"table_{k}.npy"),
                    tr.params[k].detach().cpu().numpy())
    # the device's idle share over a few more steps, rank 0 of host 0
    # under the profiler, every other rank stepping alongside
    if on_card and rank == 0 and host_id == 0:
        rec["profile"] = profile_calls(
            torch, [lambda: tr.train_step(batch)] * CLUSTER_PROFILE_STEPS)
    else:
        for _ in range(CLUSTER_PROFILE_STEPS):
            tr.train_step(batch)
    # (a3) from the state reached here (Adagrad's accumulators warm): a
    # few more steps on the fp32 wire, then as many on the q8_ef wire
    # from the same state.  From a fresh init the first Adagrad step moves
    # every touched weight by lr * sign(g), so codes that round a small g
    # to zero part the runs by far more than the EF bound (ROADMAP §C)
    saved = tree_map(torch.clone, (tr.params, tr.opt_state))
    rec["continued_losses"], _, _ = hier_run(np, torch, sk, tr, batch,
                                             CLUSTER_CODED_STEPS, device)
    c.close()
    del tr
    out["exact"] = rec
    c = client("coded")
    tr = trainer(c)
    tr.params, tr.opt_state = saved
    del saved
    losses, split, launches = hier_run(np, torch, sk, tr, batch,
                                       CLUSTER_CODED_STEPS, device)
    out["coded"] = {"losses": losses, "split_ms": split,
                    "launches": launches,
                    "policy": dict(tr.exchange_policy),
                    "socket_bytes": c.bytes_sent + c.bytes_received,
                    "carry_mass": c.carry_mass(),
                    "digest": state_digest(tr)}
    c.close()
    del tr

    # (a4) host 1 pushes CLUSTER_STRAGGLE_S late in the last round
    c = client("straggle")
    tr = trainer(c)
    losses, split, launches = hier_run(
        np, torch, sk, tr, batch, CLUSTER_STRAGGLE_STEPS, device,
        sleep_last=CLUSTER_STRAGGLE_S if host_id == 1 else 0.0)
    out["straggle"] = {"losses": losses, "split_ms": split}
    c.close()
    del tr

    # (a2) one rank a host: the same batch on local rank 0 alone
    group = dist.new_group([0])
    if rank == 0:
        solo = make_mesh(MeshSpec(data=1), device=device, group=group)
        c = client("flat")
        tr = trainer(c, solo)
        losses, split, launches = hier_run(np, torch, sk, tr, batch,
                                           CLUSTER_FLAT_STEPS, device)
        out["flat"] = {"losses": losses, "split_ms": split,
                       "launches": launches,
                       "socket_bytes": c.bytes_sent + c.bytes_received,
                       "policy": dict(tr.exchange_policy)}
        c.close()
        del tr
    dist.barrier()
    with open(os.path.join(out_dir, f"host{host_id}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)


def hier_oracle(np, torch, seed, steps) -> tuple:
    """The one-device SparseTableCTRTrainer on the hosts' whole batch:
    losses and the tables after ``steps`` steps."""
    tr = deep_trainer("fm", "sparse", train_params(np, seed), "cuda", LR)
    batch = cluster_batch(np, seed)
    losses = [float(tr.train_step(batch)) for _ in range(steps)]
    return losses, {k: tr.params[k].detach().cpu().numpy()
                    for k in ("w", "v")}


def cluster_hier(np, torch, sk, seed, root) -> dict:
    """(a)-(a4): two hosts of CLUSTER_LOCAL gloo ranks on the card, each
    world spawned in a thread of this process, against reduce shards this
    process serves; a master scraping the straggler run's shards."""
    from lightctr_tpu_torch.core.mesh import spawn_world
    from lightctr_tpu_torch.dist.hier import SparseReduceShard
    from lightctr_tpu_torch.dist.master import MasterService
    from lightctr_tpu_torch.dist.ps_server import ParamServerService
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
    from lightctr_tpu_torch.obs import exporter

    runs = ("probe", "exact", "coded", "straggle", "flat")
    shards = {r: [SparseReduceShard(n_hosts=CLUSTER_HOSTS)
                  for _ in range(2)] for r in runs}
    addrs = {r: [list(s.address) for s in ss] for r, ss in shards.items()}
    # the master of (a4): one PS shard as its member, the straggler run's
    # reduce shards as scrape targets
    ps = ParamServerService(AsyncParamServer(dim=2, n_workers=1))
    master = MasterService(
        [ps.address], period_s=1.0, scrape_period_s=30.0,
        scrape_targets=[(f"rendezvous_{i}", s.address)
                        for i, s in enumerate(shards["straggle"])])
    ops = exporter.OpsServer(port=0)
    errors = []

    def host(h):
        try:
            spawn_world(cluster_rank, CLUSTER_LOCAL, "gloo",
                        deadline_s=CLUSTER_DEADLINE_S,
                        args=(h, root, seed, "cuda", addrs))
        except BaseException as e:  # raised below, after the join
            errors.append((h, repr(e)))

    try:
        t = time.perf_counter()
        threads = [threading.Thread(target=host, args=(h,))
                   for h in range(CLUSTER_HOSTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        worlds_s = time.perf_counter() - t
        if errors:
            raise AssertionError(f"cluster: a host world failed: {errors}")
        master.scrape_once()
        status, verdict = http_json(
            f"http://127.0.0.1:{ops.address[1]}/stragglerz")
        shard_stats = {r: [s.stats() for s in ss] for r, ss in shards.items()}
    finally:
        ops.close()
        master.close()
        ps.close()
        for ss in shards.values():
            for s in ss:
                s.close()
    ranks = {(h, r): json.load(open(os.path.join(
        root, f"host{h}_rank{r}.json")))
        for h in range(CLUSTER_HOSTS) for r in range(CLUSTER_LOCAL)}
    lead = ranks[(0, 0)]

    link = lead["link"]
    if link["source"] != "probe" or not all(
            link[k] > 0 for k in ("ici_bps", "dcn_probe_bps")):
        raise AssertionError(f"cluster: the link probes did not measure "
                             f"both links: {link}")
    # (a): every rank of both hosts bit-identical, the oracle's
    # trajectory and tables, the policy, the launches on every rank
    digests = {k: v["exact"]["digest"] for k, v in ranks.items()}
    if len({json.dumps(d, sort_keys=True) for d in digests.values()}) != 1:
        raise AssertionError("cluster (a): the ranks' states differ")
    o_losses, o_tables = hier_oracle(np, torch, seed, CLUSTER_STEPS)
    got = lead["exact"]["losses"]
    if not np.allclose(got, o_losses, **HIER_LOSS_TOL):
        raise AssertionError(f"cluster (a): losses {got} against the "
                             f"one-device trainer's {o_losses}")
    table_err = {}
    for k in ("w", "v"):
        t = np.load(os.path.join(root, f"table_{k}.npy"))
        if not np.allclose(t, o_tables[k], **HIER_TABLE_TOL):
            raise AssertionError(f"cluster (a): table {k} differs from the "
                                 f"one-device trainer's, max abs "
                                 f"{float(np.abs(t - o_tables[k]).max())}")
        table_err[k] = float(np.abs(t - o_tables[k]).max())
    want = hier_expected_launches(sk, CLUSTER_STEPS)
    for key, rec in ranks.items():
        if set(rec["exact"]["policy"].values()) != {"hier"}:
            raise AssertionError(f"cluster (a): rank {key} policy "
                                 f"{rec['exact']['policy']}")
        if not same_launches(rec["exact"]["launches"], want):
            raise AssertionError(f"cluster (a): rank {key} launches "
                                 f"{rec['exact']['launches']} != {want}")
        if rec["exact"]["connected"] != (key[1] == 0):
            raise AssertionError(f"cluster (a): rank {key} wire sockets "
                                 f"{rec['exact']['connected']}")
    exact_b = [ranks[(h, 0)]["exact"]["socket_bytes"] / CLUSTER_STEPS
               for h in range(CLUSTER_HOSTS)]
    # (a2) one rank a host: the same wire bytes a step
    flat_b = [ranks[(h, 0)]["flat"]["socket_bytes"] / CLUSTER_FLAT_STEPS
              for h in range(CLUSTER_HOSTS)]
    for h in range(CLUSTER_HOSTS):
        if abs(flat_b[h] - exact_b[h]) > HIER_FLAT_BAND * exact_b[h]:
            raise AssertionError(f"cluster (a2): host {h} moved "
                                 f"{flat_b[h]} wire bytes a step at one "
                                 f"rank against {exact_b[h]} at "
                                 f"{CLUSTER_LOCAL}")
        if not same_launches(ranks[(h, 0)]["flat"]["launches"],
                             hier_expected_launches(sk, CLUSTER_FLAT_STEPS)):
            raise AssertionError(f"cluster (a2): host {h} launches "
                                 f"{ranks[(h, 0)]['flat']['launches']}")
    # (a3) q8_ef: the ranks alike, within the EF bound of the fp32 wire,
    # under 0.4 of its socket bytes
    if len({json.dumps(v["coded"]["digest"], sort_keys=True)
            for v in ranks.values()}) != 1:
        raise AssertionError("cluster (a3): the ranks' states differ")
    coded = lead["coded"]["losses"]
    cont = lead["exact"]["continued_losses"]
    if not np.allclose(coded, cont, rtol=0, atol=HIER_CODED_ATOL):
        raise AssertionError(f"cluster (a3): q8_ef losses {coded} against "
                             f"the fp32 wire's {cont} from one state")
    coded_b = [ranks[(h, 0)]["coded"]["socket_bytes"] / CLUSTER_CODED_STEPS
               for h in range(CLUSTER_HOSTS)]
    for h in range(CLUSTER_HOSTS):
        if coded_b[h] >= HIER_CODED_BYTES * exact_b[h]:
            raise AssertionError(f"cluster (a3): host {h} q8_ef moved "
                                 f"{coded_b[h]} bytes a step against the "
                                 f"fp32 wire's {exact_b[h]}")
    # (a4) /stragglerz names host 1 first
    if status != 200 or verdict["verdict"]["slowest_host"] != "1" \
            or verdict["hosts"][0]["host"] != "1":
        raise AssertionError(f"cluster (a4): /stragglerz {status} "
                             f"{verdict}")
    split = np.asarray(lead["exact"]["split_ms"][WARMUP_STEPS:])
    prof = lead["exact"].get("profile")
    step_ms = float(split.sum(axis=1).mean())
    return {
        "hosts": CLUSTER_HOSTS, "local_ranks": CLUSTER_LOCAL,
        "steps": CLUSTER_STEPS, "worlds_s": worlds_s,
        "backend": lead["backend"], "link": link,
        "losses": got, "oracle_losses": o_losses,
        "max_loss_err": float(np.abs(np.asarray(got)
                                     - np.asarray(o_losses)).max()),
        "max_table_err": table_err, "ranks_bit_identical": True,
        "local_policy": lead["exact"]["local_policy"],
        "wire_model_bytes_per_step": lead["exact"]["bytes_per_step"],
        "ms_per_step": {"local": float(split[:, 0].mean()),
                        "wire": float(split[:, 1].mean()),
                        "apply": float(split[:, 2].mean()),
                        "total": step_ms},
        "profile_rank0": prof,
        # against the timed steps (the profiler's own wall is inflated)
        "device_idle_share": (None if prof is None else
                              1.0 - prof["device_ms_per_step"] / step_ms),
        "socket_bytes_per_step": {"exact": exact_b, "flat": flat_b,
                                  "coded": coded_b},
        "coded_losses": coded, "continued_losses": cont,
        "coded_carry_mass": lead["coded"]["carry_mass"],
        "flat_losses": lead["flat"]["losses"],
        "stragglerz": {"slowest_host": verdict["verdict"]["slowest_host"],
                       "hosts": verdict["hosts"]},
        "straggle_split_ms": {f"host{h}": ranks[(h, 0)]["straggle"]
                              ["split_ms"] for h in range(CLUSTER_HOSTS)},
        "shard_coded_rounds": sum(s["coded_rounds"]
                                  for s in shard_stats["coded"]),
        "launches": lead["exact"]["launches"],
        "launches_expected": want}


# -- (b) the elastic master over tiered PS shards on the card ------------------


def elastic_target(np, seed):
    """The teaching target every process derives alike (the chaos
    harness's ``target_rows``)."""
    return np.random.default_rng(seed + 81).normal(
        size=(ELASTIC_VOCAB, ROW_DIM)).astype(np.float32)


def elastic_shard_main(conn, shard_id, root, seed):
    """One PS-shard process (tools/chaos_harness.py's ``_shard_main``):
    a tiered store on the card behind ``ParamServerService``, beating to
    the master and writing state snapshots (rows and accumulators of
    every tier) on a cadence.  On "stop" it answers its kernel launches
    and exits.  A process that cannot take the card raises."""
    import torch

    sys.path.insert(0, REPO)
    from lightctr_tpu_torch.ckpt import checkpoint as ckpt_mod
    from lightctr_tpu_torch.dist.master import SHARD_ID_BASE
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.ops import sparse_kernels as sk

    if not torch.cuda.is_available():
        raise RuntimeError(f"elastic shard {shard_id}: no CUDA device")
    store = tiered_store(root, f"tier_{shard_id}", True,
                         hot_rows=ELASTIC_HOT_ROWS, updater="adagrad",
                         learning_rate=ELASTIC_LR,
                         n_workers=ELASTIC_WORKERS,
                         staleness_threshold=1 << 20, seed=100 + shard_id)
    svc = ParamServerService(store)
    conn.send(list(svc.address))
    master_addr = tuple(conn.recv())
    state = {"stop": False, "snapshots": 0}

    def beat_loop():
        client = None
        while not state["stop"]:
            try:
                if client is None:
                    client = PSClient(master_addr, 1, timeout=2.0)
                client.beat(SHARD_ID_BASE + shard_id)
            except (ConnectionError, OSError, RuntimeError):
                client = None
            time.sleep(ELASTIC_BEAT_S)

    def ckpt_loop():
        d = os.path.join(root, "ckpt", f"shard_{shard_id}")
        step = 0
        while not state["stop"]:
            time.sleep(ELASTIC_CKPT_S)
            step += 1
            k, r, a = store.snapshot_state_arrays()
            ckpt_mod.save_arrays(d, step, k, r, accums=a)
            ckpt_mod.gc_array_snapshots(d, keep=2)
            state["snapshots"] += 1

    threading.Thread(target=beat_loop, daemon=True).start()
    threading.Thread(target=ckpt_loop, daemon=True).start()
    try:
        conn.recv()
    except EOFError:
        pass
    state["stop"] = True
    svc.close()
    conn.send({"launches": sk.launches(), "snapshots": state["snapshots"],
               "device_hot": store.device_hot,
               "device": str(store.device)})
    store.close()


def elastic_worker(np, wid, master_addr, addresses, target, passes,
                   gates, progress, errors):
    """The chaos harness's teaching loop (``_worker_loop``): each pass
    re-derives this worker's data shards from the routing table, pulls
    their rows and pushes ``w - target``; a pull that fails (a dead shard
    mid-rebalance) retries after refreshing the route.  The worker joins
    and beats from a thread of its own (a pass over a data shard of 2^18
    rows outlasts the beat period), then waits on ``gates[0]`` (every
    worker in the table, so every pass deals each data shard to one
    worker) and, after ELASTIC_KILL_AFTER passes, on ``gates[1]``."""
    from lightctr_tpu_torch.dist.elastic import shards_of_worker
    from lightctr_tpu_torch.dist.ps_server import PSClient, ShardedPSClient

    n_data = 2 * ELASTIC_WORKERS
    master = PSClient(tuple(master_addr), 1, timeout=5.0)
    client = ShardedPSClient(addresses, ROW_DIM, partition="ring")
    client.attach_route_source(master.route)
    beating = threading.Event()

    def beat_loop():
        beater = PSClient(tuple(master_addr), 1, timeout=5.0)
        try:
            while not beating.wait(ELASTIC_BEAT_S):
                beater.beat(wid)
        finally:
            beater.close()

    def hold(gate):
        gate.wait()
        client.refresh_route()

    master.beat(wid)
    beat_thread = threading.Thread(target=beat_loop, daemon=True)
    beat_thread.start()
    try:
        hold(gates[0])
        done = 0
        while done < passes:
            if done == ELASTIC_KILL_AFTER:
                progress[wid] = done
                hold(gates[1])
            table = client.routing
            if wid not in table.workers:
                client.refresh_route()
                time.sleep(ELASTIC_BEAT_S)
                continue
            for s in shards_of_worker(wid, table.workers, n_data,
                                      table.epoch):
                keys = np.arange(ELASTIC_VOCAB, dtype=np.int64)[s::n_data]
                out = None
                deadline = time.monotonic() + ELASTIC_DEADLINE_S
                while out is None:
                    out = client.pull_arrays(keys, worker_epoch=done,
                                             worker_id=wid)
                    if out is None:
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"worker {wid}: data shard "
                                               f"{s} never served")
                        client.refresh_route()
                        time.sleep(0.1)
                if not client.push_arrays(wid, keys, out[1] - target[keys],
                                          worker_epoch=done):
                    raise AssertionError(f"worker {wid}: a push of data "
                                         f"shard {s} was lost")
            done += 1
            progress[wid] = done
    except BaseException as e:  # raised by elastic_run
        errors.append((wid, repr(e)))
    finally:
        beating.set()
        beat_thread.join(timeout=10)
        try:
            master.farewell(wid)
        except (ConnectionError, OSError, RuntimeError):
            pass
        master.close()
        client.close()


def elastic_spawn(root, seed) -> list:
    """Start one run's ELASTIC_SHARDS shard processes, [(process, pipe)]
    (spawn: this process holds a CUDA context).  Each takes the card and
    builds its store while the caller goes on, then waits for its
    master's address."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    os.makedirs(os.path.join(root, "ckpt"), exist_ok=True)
    procs = []
    for i in range(ELASTIC_SHARDS):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=elastic_shard_main,
                        args=(child, i, root, seed), daemon=True)
        p.start()
        procs.append((p, parent))
    return procs


def elastic_run(np, seed, root, kill, procs) -> dict:
    """One run of the drill over ``procs`` (:func:`elastic_spawn`): an
    elastic master, ELASTIC_WORKERS worker threads over ELASTIC_PASSES
    passes; after ELASTIC_KILL_AFTER passes the workers wait for a
    snapshot of every shard taken since, and with ``kill`` shard
    ELASTIC_VICTIM is SIGKILLed, its rows migrate and the master's scrape
    (``/metrics``, the one scrape-armed master of the process) marks it
    down before they go on.  The unperturbed run (``kill=False``) takes
    the same pause."""
    import signal
    import urllib.request

    from lightctr_tpu_torch.ckpt import checkpoint as ckpt_mod
    from lightctr_tpu_torch.dist.master import MasterService
    from lightctr_tpu_torch.dist.ps_server import PSClient, ShardedPSClient
    from lightctr_tpu_torch.obs import exporter
    from lightctr_tpu_torch.obs.registry import labeled

    master = ops = None
    info = {"kill": kill}
    t_run = time.perf_counter()
    try:
        addrs = [tuple(pipe.recv()) for _, pipe in procs]
        info["spawn_s"] = time.perf_counter() - t_run
        master = MasterService(
            addrs, stale_after_s=ELASTIC_STALE_S,
            dead_after_s=ELASTIC_DEAD_S, period_s=ELASTIC_BEAT_S / 2,
            shard_rpc_timeout_s=30.0, elastic=True, partition="ring",
            dim=ROW_DIM, ckpt_dir=os.path.join(root, "ckpt"),
            grace_factor=3.0, scrape_period_s=30.0 if kill else None)
        if kill:
            ops = exporter.OpsServer(port=0)
        for _, pipe in procs:
            pipe.send(list(master.address))
        keys = np.arange(ELASTIC_VOCAB, dtype=np.int64)
        t = time.perf_counter()
        c = ShardedPSClient(list(addrs), ROW_DIM, partition="ring")
        for lo in range(0, ELASTIC_VOCAB, PRELOAD_CHUNK):
            c.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                             np.zeros((min(PRELOAD_CHUNK,
                                           ELASTIC_VOCAB - lo), ROW_DIM),
                                      np.float32))
        c.close()
        info["preload_s"] = time.perf_counter() - t
        target = elastic_target(np, seed)
        gates, progress, errors = (threading.Event(), threading.Event()), \
            {}, []
        workers = [threading.Thread(
            target=elastic_worker,
            args=(np, wid, master.address, list(addrs), target,
                  ELASTIC_PASSES, gates, progress, errors))
            for wid in range(ELASTIC_WORKERS)]
        t = time.perf_counter()
        for w in workers:
            w.start()
        wait_for(lambda: errors or sorted(master.routing.workers)
                 == list(range(ELASTIC_WORKERS)), 60.0,
                 "elastic: the workers' joins")
        gates[0].set()
        wait_for(lambda: errors or all(
            progress.get(w, 0) >= ELASTIC_KILL_AFTER
            for w in range(ELASTIC_WORKERS)), 120.0, "elastic: first passes")
        if errors:
            raise AssertionError(f"elastic: a worker failed: {errors}")
        info["first_passes_s"] = time.perf_counter() - t
        # the second snapshot of a shard written after the pause began
        # was taken after it: it holds every update of the first passes
        def last_step(i):
            d = os.path.join(root, "ckpt", f"shard_{i}")
            steps = [int(n[5:-4]) for n in (os.listdir(d) if os.path.isdir(d)
                                           else ())
                     if n.startswith("rows_") and n.endswith(".npz")]
            return max(steps, default=0)

        at_pause = [last_step(i) for i in range(ELASTIC_SHARDS)]
        wait_for(lambda: all(last_step(i) >= at_pause[i] + 2
                             for i in range(ELASTIC_SHARDS)),
                 60.0, "elastic: snapshots after the pause")
        info["pause_s"] = time.perf_counter() - t - info["first_passes_s"]
        if kill:
            victim, _ = procs[ELASTIC_VICTIM]
            t = time.perf_counter()
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(timeout=10)
            drop = [m for m in range(ELASTIC_SHARDS) if m != ELASTIC_VICTIM]
            wait_for(lambda: sorted(master.routing.members) == drop
                     and not master.routing.rebalancing, 120.0,
                     "elastic: the master's drop rebalance")
            info["rebalance_s"] = time.perf_counter() - t
            src = ckpt_mod.load_latest_state(
                os.path.join(root, "ckpt", f"shard_{ELASTIC_VICTIM}"))
            recs = [m for m in master.migrations
                    if m["reason"] == "shard_death"]
            info["migrations"] = [{k: v for k, v in m.items()
                                   if k != "src_fnv"} for m in recs]
            info["dead_shard_ckpt_rows"] = len(src[1])
            info["migrated_rows"] = int(sum(m["n"] for m in recs))
            if not recs or not all(m["verified"] for m in recs):
                raise AssertionError(f"elastic: migrations not verified: "
                                     f"{info['migrations']}")
            if not all(m.get("accums") for m in recs):
                raise AssertionError("elastic: accumulators did not ride "
                                     "the migration")
            if info["migrated_rows"] != len(src[1]):
                raise AssertionError(
                    f"elastic: {info['migrated_rows']} rows migrated of the "
                    f"dead shard's {len(src[1])}")
            # the scrape marks the dead shard down, every shard keeps its
            # member label on /metrics
            master.scrape_once()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ops.address[1]}/metrics",
                    timeout=10) as r:
                metrics = r.read().decode()
            for i in range(ELASTIC_SHARDS):
                up = 0 if i == ELASTIC_VICTIM else 1
                line = (f"lightctr_{labeled('cluster_member_up', member=f'shard_{i}')}"
                        f" {up}")
                if line not in metrics:
                    raise AssertionError(f"elastic: /metrics lacks {line!r}")
            if not master.rollup.members()[
                    f"shard_{ELASTIC_VICTIM}"]["scrape_down"]:
                raise AssertionError("elastic: the dead shard is not "
                                     "scrape_down")
            info["metrics_member_lines"] = ELASTIC_SHARDS
        gates[1].set()
        for w in workers:
            w.join(timeout=240)
        if errors or any(w.is_alive() for w in workers):
            raise AssertionError(f"elastic: workers failed: {errors}")
        info["passes_s"] = time.perf_counter() - t
        # a full-vocabulary pull through a fresh routed client
        t = time.perf_counter()
        admin = PSClient(tuple(master.address), 1, timeout=5.0)
        c = ShardedPSClient(list(addrs), ROW_DIM, partition="ring")
        c.attach_route_source(admin.route)
        c.refresh_route()
        out = None
        deadline = time.monotonic() + ELASTIC_DEADLINE_S
        while out is None and time.monotonic() < deadline:
            out = c.pull_arrays(keys, worker_epoch=ELASTIC_PASSES)
            if out is None:
                c.refresh_route()
                time.sleep(0.1)
        admin.close()
        c.close()
        if out is None:
            raise AssertionError("elastic: a full-vocabulary pull failed")
        info["mse"] = float(np.mean((out[1] - target) ** 2))
        info["eval_s"] = time.perf_counter() - t
        info["final_members"] = list(master.routing.members)
        info["final_epoch"] = master.routing.epoch
        # the master goes first, so no stopping shard reads as a death;
        # then each surviving shard answers its launches
        if ops is not None:
            ops.close()
        master.close()
        ops = master = None
        t = time.perf_counter()
        shards = {}
        for i, (p, pipe) in enumerate(procs):
            if p.is_alive():
                pipe.send("stop")
        for i, (p, pipe) in enumerate(procs):
            if p.is_alive():
                shards[i] = pipe.recv()
        info["stop_s"] = time.perf_counter() - t
        info["shards"] = shards
        for i, rep in shards.items():
            if rep["launches"]["gather_rows"] == 0 or not rep["device_hot"]:
                raise AssertionError(f"elastic: shard {i} launched no "
                                     f"gather_rows on the card: {rep}")
        return info
    finally:
        if ops is not None:
            ops.close()
        if master is not None:
            master.close()
        elastic_stop(procs)


def elastic_stop(procs) -> None:
    """End every shard process of a run: a few seconds to exit after its
    reply (a snapshot in flight holds the store's close), then SIGKILL."""
    for p, _ in procs:
        p.join(timeout=3)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def cluster_elastic(np, seed, root, procs) -> dict:
    """(b): the drill with the SIGKILL and the unperturbed run of the same
    schedule, side by side (each its own shards ``procs[run]``, master
    and workers); the final MSEs within ELASTIC_PARITY of each other
    (relative)."""
    runs, errors = {}, []

    def run(name, kill):
        t = time.perf_counter()
        try:
            runs[name] = elastic_run(np, seed, os.path.join(root, name),
                                     kill, procs[name])
            runs[name]["run_s"] = time.perf_counter() - t
        except BaseException as e:  # raised below, after the join
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=run, args=a) for a in ELASTIC_RUNS]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise AssertionError(f"elastic: {errors}")
    m, b = runs["killed"]["mse"], runs["unperturbed"]["mse"]
    if not abs(m - b) <= ELASTIC_PARITY * b:
        raise AssertionError(f"elastic: final MSE {m} against the "
                             f"unperturbed run's {b}")
    b3 = sum(r["launches"]["gather_rows"]
             for r in runs["killed"]["shards"].values())
    return {"shards": ELASTIC_SHARDS, "workers": ELASTIC_WORKERS,
            "vocab": ELASTIC_VOCAB, "hot_rows": ELASTIC_HOT_ROWS,
            "passes": ELASTIC_PASSES, "runs": runs,
            "mse_gap_relative": abs(m - b) / b,
            "launches": {"gather_rows": b3}}


def phase_cluster(np, torch, sk, seed) -> dict:
    """Multi-host training on the card: (a) the two-level exchange, FM at
    Criteo width over 2 hosts x 2 gloo ranks against the one-device
    trainer (and (a2) one rank a host, (a3) the q8_ef wire, (a4) a
    straggler named by ``/stragglerz``); (b) the elastic master over
    tiered PS shards on the card through a SIGKILL."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    procs = {}
    try:
        # (b)'s shard processes start first: they take the card and build
        # their stores while (a) runs
        for name, _ in ELASTIC_RUNS:
            procs[name] = elastic_spawn(os.path.join(root, "elastic", name),
                                        seed)
        t = time.perf_counter()
        os.makedirs(os.path.join(root, "hier"))
        hier = cluster_hier(np, torch, sk, seed, os.path.join(root, "hier"))
        hier["part_s"] = time.perf_counter() - t
        t = time.perf_counter()
        elastic = cluster_elastic(np, seed, os.path.join(root, "elastic"),
                                  procs)
        elastic["part_s"] = time.perf_counter() - t
        launches = dict(hier["launches"])
        launches["gather_rows"] = elastic["launches"]["gather_rows"]
        return {"phase": "cluster", "hier": hier, "elastic": elastic,
                "launches": launches}
    finally:
        for ps in procs.values():
            elastic_stop(ps)
        shutil.rmtree(root, ignore_errors=True)


# -- phase: serve_deep --------------------------------------------------------

DEEP_KINDS = ("widedeep", "deepfm", "dcn")
HIDDEN = 50                 # distributed_algo_abst.h:116-118
N_CROSS = 3                 # deepfm.dcn_init's default
DEEP_D = N_FIELDS * DIM     # the MLP's input: 1,248
PQ_PARTS, PQ_CLUSTERS, PQ_ITERS = 4, 256, 10
PQ_SCORE_ATOL = 1e-4        # local fp32 scoring against a float64 forward


def deep_layer(np, rng, n_in, n_out):
    """One dense layer: weight [n_out, n_in] ~ U(-0.5, 0.5) (``dense.init``,
    fullyconnLayer.h:43-54), bias N(0, 0.01^2) so the biases count."""
    return {"w": rng.random((n_out, n_in), dtype=np.float32)
            - np.float32(0.5),
            "b": rng.normal(0.0, 0.01, n_out).astype(np.float32)}


def deep_params(np, seed, kind, w, embed):
    """``kind``'s parameter tree at Criteo width: the table ``embed``
    [2^20, 32] (and, but for DCN, the wide ``w``) as given, and its dense
    leaves from a seed as the JAX package initialises them, biases
    N(0, 0.01^2): fc1 [50, 1248] and fc2 [1, 50], or DCN's crosses
    [3, 1248] (weights N(0, 1/1248)), fc1 and out [1, 1298]."""
    rng = np.random.default_rng(seed + 20 + DEEP_KINDS.index(kind))
    p = {"embed": embed}
    if kind == "dcn":
        p["cross_w"] = (rng.standard_normal((N_CROSS, DEEP_D),
                                            dtype=np.float32)
                        / np.float32(np.sqrt(DEEP_D)))
        p["cross_b"] = rng.normal(0.0, 0.01, (N_CROSS, DEEP_D)).astype(
            np.float32)
        p["fc1"] = deep_layer(np, rng, DEEP_D, HIDDEN)
        p["out"] = deep_layer(np, rng, DEEP_D + HIDDEN, 1)
    else:
        p["w"] = w
        p["fc1"] = deep_layer(np, rng, DEEP_D, HIDDEN)
        p["fc2"] = deep_layer(np, rng, HIDDEN, 1)
    return p


def sigmoid64(np, z):
    return 1.0 / (1.0 + np.exp(-np.clip(z, -16.0, 16.0)))


def deep_forward64(np, kind, p, req):
    """``kind``'s scores in float64 numpy (widedeep.logits, deepfm.logits,
    deepfm.dcn_logits, then the sigmoid)."""
    def dense(layer, x):
        return x @ layer["w"].astype(np.float64).T + layer["b"]

    emb = (p["embed"][req["rep_fids"]].astype(np.float64)
           * req["rep_mask"][..., None])
    x0 = emb.reshape(emb.shape[0], -1)
    h = np.tanh(dense(p["fc1"], x0))
    if kind == "dcn":
        x = x0
        for w, b in zip(p["cross_w"].astype(np.float64),
                        p["cross_b"].astype(np.float64)):
            x = x0 * (x @ w)[:, None] + b[None, :] + x
        return sigmoid64(np, dense(p["out"], np.concatenate([x, h], 1))[:, 0])
    vals = req["vals"].astype(np.float64)
    z = (p["w"][req["fids"]].astype(np.float64) * vals).sum(-1) \
        + sigmoid64(np, dense(p["fc2"], h)[:, 0])
    if kind == "deepfm":
        s = emb.sum(1)
        z = z + 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    return sigmoid64(np, z)


def deep_requests(np, requests):
    """The serve phase's requests with their field-representative pair
    (``widedeep.field_representatives``; at the Criteo layout slot j is
    field j)."""
    from lightctr_tpu_torch.models.widedeep import field_representatives

    out = []
    for r in requests:
        n = r["fids"].shape[0]
        fields = np.broadcast_to(np.arange(N_FIELDS, dtype=np.int32),
                                 (n, N_FIELDS))
        rep, rep_mask = field_representatives(
            r["fids"], fields, np.ones((n, N_FIELDS), np.float32), N_FIELDS)
        out.append({**r, "rep_fids": rep, "rep_mask": rep_mask})
    return out


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def row_leaves_of(serve, kind):
    """The PS row layout ``[w | embed]`` (33 wide) as each kind reads it:
    DCN has no wide table and reads embed as columns 1..33."""
    if kind == "dcn":
        return {"embed": (1, ROW_DIM, False)}
    return serve.fm_ps_row_leaves(DIM, table_leaf="embed")


def serve_deep_pq(np, torch, serve, export, pq, seed, root, decoded, reqs):
    """PQ at full width on the card: train (4 parts, 256 clusters, 10
    iterations) and encode the DeepFM artifact's decoded embed, then the
    same codebook through ``save_compressed_npz`` (the same seed on the
    card), that artifact loaded and the requests scored locally within
    PQ_SCORE_ATOL of the float64 forward of its decoded parameters."""
    emb = torch.from_numpy(decoded["embed"]).cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    book = pq.train(torch.Generator(device="cuda").manual_seed(seed), emb,
                    part_cnt=PQ_PARTS, cluster_cnt=PQ_CLUSTERS,
                    iters=PQ_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    codes = pq.encode(book, emb)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    qerr = pq.quantization_error(book, emb)
    mean_sq = float(torch.mean(torch.sum(emb * emb, dim=1)))
    path = os.path.join(root, "deepfm_pq.npz")
    export.save_compressed_npz(path, decoded, model="deepfm",
                               pq_leaves=("embed",), pq_parts=PQ_PARTS,
                               pq_clusters=PQ_CLUSTERS, pq_iters=PQ_ITERS,
                               seed=seed, device="cuda")
    with np.load(path) as z:
        same_codes = bool(np.array_equal(z["embed__codes"],
                                         codes.cpu().numpy()))
    if not same_codes:
        raise AssertionError("serve_deep pq: the artifact's codes are not "
                             "the codebook's trained from the same seed")
    params, _ = export.load_compressed_npz(path, device="cuda")
    pq_params = numpy_tree(params)
    model = serve.load_model(path, device="cuda")
    max_err = 0.0
    for r in reqs:
        got = model.score(r)
        ref = deep_forward64(np, "deepfm", pq_params, r)
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"serve_deep pq: bad scores {got.shape}")
        max_err = max(max_err, float(np.abs(got - ref).max()))
    if max_err > PQ_SCORE_ATOL:
        raise AssertionError(f"serve_deep pq: score error {max_err} > "
                             f"{PQ_SCORE_ATOL}")
    del emb, book, codes, model, params
    torch.cuda.empty_cache()
    return {"parts": PQ_PARTS, "clusters": PQ_CLUSTERS, "iters": PQ_ITERS,
            "rows": int(decoded["embed"].shape[0]),
            "train_s": train_s, "encode_s": encode_s,
            "quantization_error": qerr, "mean_sq_norm": mean_sq,
            "artifact_codes_equal": same_codes,
            "max_abs_score_err": max_err, "score_atol": PQ_SCORE_ATOL}


def phase_serve_deep(np, torch, sk, seed, requests) -> dict:
    """The Wide&Deep family served at Criteo width: one int8 artifact per
    kind written by ``save_compressed_npz``, loaded by ``serve.load_model``
    with PS-row-backed tables behind one PS preload of the decoded
    ``[w | embed]`` rows, and the serve phase's requests sent twice to
    each kind's server; then PQ on the DeepFM table."""
    import shutil
    import tempfile

    from lightctr_tpu_torch import serve
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
    from lightctr_tpu_torch.models import export
    from lightctr_tpu_torch.ops import pq

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("serve_deep: TF32 matmuls are on; the MLP's "
                             "products must stay float32")
    t0 = time.perf_counter()
    base = make_params(np, seed)
    reqs = deep_requests(np, requests)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_deep_")
    svc = None
    try:
        paths, decoded, codecs, artifact_bytes = {}, {}, {}, {}
        t_write = time.perf_counter()
        for kind in DEEP_KINDS:
            paths[kind] = os.path.join(root, f"{kind}.npz")
            export.save_compressed_npz(
                paths[kind], deep_params(np, seed, kind, base["w"],
                                         base["v"]),
                model=kind, device="cuda")
            artifact_bytes[kind] = os.path.getsize(paths[kind])
        write_s = time.perf_counter() - t_write
        for kind in DEEP_KINDS:
            params, meta = export.load_compressed_npz(paths[kind],
                                                      device="cuda")
            decoded[kind] = numpy_tree(params)
            codecs[kind] = {name: leaf["codec"]
                            for name, leaf in meta["leaves"].items()}
            del params
        # one array's int8 codes are one array: the three decoded tables
        # (and the two wide ones) are equal, so one preload serves all
        table = decoded["widedeep"]
        for kind in ("deepfm", "dcn"):
            for leaf in ("w", "embed"):
                if leaf in decoded[kind] and not np.array_equal(
                        decoded[kind][leaf], table[leaf]):
                    raise AssertionError(f"serve_deep: {kind}'s decoded "
                                         f"{leaf} is not widedeep's")
        keys, rows = serve.fused_fm_rows(table, table_leaf="embed")
        store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=seed)
        svc = ParamServerService(store)
        admin = PSClient(svc.address, ROW_DIM)
        try:
            for lo in range(0, VOCAB, PRELOAD_CHUNK):
                admin.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                                     rows[lo:lo + PRELOAD_CHUNK])
        finally:
            admin.close()
        del keys, rows
        setup_s = time.perf_counter() - t0
        kinds = {}
        for kind in DEEP_KINDS:
            refs = [deep_forward64(np, kind, decoded[kind], r) for r in reqs]
            model = serve.load_model(paths[kind],
                                     row_leaves=row_leaves_of(serve, kind),
                                     row_dim=ROW_DIM, device="cuda")
            srv = cli = None
            try:
                srv = serve.PredictionServer(
                    model, ps=PSClient(svc.address, ROW_DIM), max_batch=256,
                    device="cuda")
                cli = serve.PredictClient(srv.address)
                sk.reset_launches()
                passes, max_err = serve_passes(np, cli, srv, reqs, refs,
                                               kind)
                launches = sk.launches()
                cache, batches = check_served(srv, passes, launches, kind)
            finally:
                if cli is not None:
                    cli.close()
                if srv is not None:
                    srv.close()
            kinds[kind] = {
                "passes": passes, "max_abs_score_err": max_err,
                "batches_scored": batches, "launches": launches,
                "codecs": codecs[kind],
                "artifact_bytes": artifact_bytes[kind],
                "cache": {k: cache[k] for k in ("entries", "capacity",
                                                "hits", "misses",
                                                "device_rows")}}
            del model
        pq_info = serve_deep_pq(np, torch, serve, export, pq, seed, root,
                                decoded["deepfm"], reqs)
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: sum(kinds[kind]["launches"].get(k, 0)
                       for kind in DEEP_KINDS) for k in sk.KERNELS}
    return {"phase": "serve_deep", "kinds": list(DEEP_KINDS),
            "fields": N_FIELDS, "vocab": VOCAB, "factor_dim": DIM,
            "hidden": HIDDEN, "n_cross": N_CROSS, "row_dim": ROW_DIM,
            "requests": N_REQUESTS, "request_rows": REQUEST_ROWS,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "artifact_write_s": write_s, "setup_s": setup_s,
            "score_atol": SCORE_ATOL, "runs": kinds, "pq": pq_info,
            "launches": launches}


# -- phase: train_deep --------------------------------------------------------

#: DCN's learning rate: at lr 0.05 its crosses diverge at this width in
#: the JAX package as in the port (Adagrad's first step moves each of the
#: 3 x 1,248 cross weights by about lr), held by
#: tests/test_torch_deep_trainer.py::test_dcn_at_lr_0_05_diverges_at_criteo_width_in_both_packages
DCN_LR = 0.005
#: (name, kind, trainer, steps, lr) of the train_deep phase's runs
DEEP_TRAIN_RUNS = (("deepfm_sparse", "deepfm", "sparse", 20, LR),
                   ("dcn_sparse", "dcn", "sparse", 10, DCN_LR),
                   ("deepfm_fused", "deepfm", "fused", 5, LR))
DEEP_CPU_STEPS = 2
DEEP_PROFILE_STEPS = 3
#: kind -> the sparse trainer's tables (deepfm.py's module docstring;
#: FM's two tables read the one id stream)
KIND_TABLES = {"fm": {"w": ["fids"], "v": ["fids"]},
               "deepfm": {"w": ["fids"], "embed": ["rep_fids"]},
               "dcn": {"embed": ["rep_fids"]}}


def deep_expected_launches(sk, kind, mode, steps, leaves) -> dict:
    """Launches of ``steps`` steps of the family on one card.  Sparse:
    per table (its own id stream) one dedup, the lookup's backward
    (merge_rows) and the touched-row apply (merge_apply's apply mode).
    Fused dense: per table the lookup's backward over the whole table, and
    the fused Adagrad apply a leaf (``leaves``, the MLP's included)."""
    tables = len(KIND_TABLES[kind])
    want = dict.fromkeys(sk.KERNELS, 0)
    if mode == "sparse":
        want.update(dedup_ids=tables * steps, merge_rows=tables * steps,
                    merge_apply=tables * steps)
    else:
        want.update(merge_rows=tables * steps, fused_adagrad=leaves * steps)
    return want


def deep_batches(np, seed, steps):
    """The train phase's Criteo rows with the field-representative pair
    (slot j is field j)."""
    rng = np.random.default_rng(seed + 40)
    data = criteo_rows(np, rng, steps * TRAIN_BATCH)
    data["rep_fids"] = data["fids"].copy()
    data["rep_mask"] = np.ones_like(data["vals"])
    return [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
             for k, v in data.items()} for i in range(steps)]


def deep_trainer(kind, mode, params, device, lr, mesh=None, **kw):
    """The trainer of ``kind`` (FM or one of the family) and ``mode``
    (``sparse``; ``fused``: CTRTrainer with the fused Adagrad; ``dense``:
    CTRTrainer with the optimizer transform) on ``device``, or on ``mesh``
    with its device, from numpy ``params``: each kind's
    ``logits_with_l2``, the health feed off; ``kw`` are the trainer's
    exchange options."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import _common, deepfm, fm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    logits, fused_fn = {
        "fm": (fm.logits, fm.logits_with_l2),
        "deepfm": (deepfm.logits, deepfm.logits_with_l2),
        "dcn": (deepfm.dcn_logits, deepfm.dcn_logits_with_l2)}[kind]
    cfg = TrainConfig(learning_rate=lr, lambda_l2=LAMBDA_L2)
    if mesh is not None:
        kw["mesh"] = mesh
        device = mesh.device
    else:
        kw["device"] = device
    p = _common.params_from_numpy(params, device)
    if mode == "sparse":
        tr = SparseTableCTRTrainer(p, logits, cfg,
                                   sparse_tables=KIND_TABLES[kind],
                                   fused_fn=fused_fn, **kw)
    else:
        tr = CTRTrainer(p, logits, cfg, fused_fn=fused_fn,
                        fused_adagrad=mode == "fused", **kw)
    tr.health = None
    return tr


def deep_state(tr) -> dict:
    """Every leaf of the trainer's params and optimizer state, flattened,
    as device tensors."""
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    out = {"param/" + k: v for k, v in flat_leaves(tr.params).items()}
    for i, t in enumerate(tree_leaves(tr.opt_state)):
        out[f"state/{i}"] = t
    return out


def deep_compare(np, torch, got, want, touched, what) -> float:
    """Every leaf of ``got`` (card snapshots) against ``want`` (the CPU
    trainer's params) within TRAIN_RTOL / TRAIN_ATOL, a table at the rows
    ``touched[name]`` its batches touched; returns the max abs error."""
    err = 0.0
    want = flat_leaves(want)
    for k, a in got.items():
        a, b = a.cpu(), want[k].cpu()
        if k in touched:
            idx = torch.from_numpy(np.unique(touched[k]).astype(np.int64))
            a, b = a.index_select(0, idx), b.index_select(0, idx)
        if not torch.allclose(a, b, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"{what}: {k} differs card vs cpu, max abs "
                                 f"{float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_train_deep(np, torch, sk, seed) -> dict:
    """DeepFM (sparse, then fused dense) and DCN (sparse) at the train
    phase's width, the health feed off: launches against the plan, the
    loss falling, the first steps on the CPU, a repeated step
    bit-identical, step times and the device's idle share."""
    batches = deep_batches(np, seed, max(r[3] for r in DEEP_TRAIN_RUNS))
    base = train_params(np, seed)
    runs = {}
    for name, kind, mode, steps, lr in DEEP_TRAIN_RUNS:
        params = deep_params(np, seed, kind, base["w"], base["v"])
        leaves = len(flat_leaves(params))
        tr = deep_trainer(kind, mode, params, "cuda", lr)
        sk.reset_launches()
        losses, snaps, wall, host = run_steps(
            torch, tr, batches[:steps], snapshots=(DEEP_CPU_STEPS,))
        launches = sk.launches()
        losses = [float(x) for x in losses]
        want = deep_expected_launches(sk, kind, mode, steps, leaves)
        if launches != want:
            raise AssertionError(f"train_deep {name}: launches {launches}, "
                                 f"planned {want}")
        third = max(1, steps // 3)
        if not all(np.isfinite(losses)) or \
                np.mean(losses[-third:]) >= np.mean(losses[:third]):
            raise AssertionError(f"train_deep {name}: loss did not fall "
                                 f"{losses}")
        profile = profile_calls(torch, [
            lambda b=b: tr.train_step(b)
            for b in batches[steps - DEEP_PROFILE_STEPS:steps]])
        del tr
        # the first steps on the CPU with the plain versions
        cpu = deep_trainer(kind, mode, params, "cpu", lr)
        c_losses = [float(cpu.train_step(b))
                    for b in batches[:DEEP_CPU_STEPS]]
        if not np.allclose(losses[:DEEP_CPU_STEPS], c_losses,
                           rtol=TRAIN_RTOL, atol=0):
            raise AssertionError(f"train_deep {name}: losses card "
                                 f"{losses[:DEEP_CPU_STEPS]} vs cpu "
                                 f"{c_losses}")
        seen = batches[0]["fids"]
        for b in batches[1:DEEP_CPU_STEPS]:
            seen = np.concatenate([seen, b["fids"]])
        touched = {"w": seen, "embed": seen}
        err = deep_compare(np, torch, snaps[DEEP_CPU_STEPS], cpu.params,
                           touched, f"train_deep {name}")
        del cpu, snaps
        # one step from one state, twice on the card: bit-identical
        states = []
        for _ in range(2):
            tr = deep_trainer(kind, mode, params, "cuda", lr)
            tr.train_step(batches[0])
            states.append({k: v.cpu() for k, v in deep_state(tr).items()})
            del tr
        off = [k for k, v in states[0].items()
               if not torch.equal(v, states[1][k])]
        if off:
            raise AssertionError(f"train_deep {name}: a step run twice "
                                 f"differs in {off}")
        del states
        torch.cuda.empty_cache()
        steady = steps - WARMUP_STEPS
        step_ms = 1e3 * wall / steady
        run = {"kind": kind, "trainer": mode, "steps": steps, "lr": lr,
               "launches": launches, "planned_launches": want,
               "losses": losses, "cpu_steps": DEEP_CPU_STEPS,
               "loss_rel_err_vs_cpu": max(abs(a - b) / abs(b) for a, b in
                                          zip(losses, c_losses)),
               "max_abs_err_vs_cpu": err,
               "repeat_step_bit_identical": True,
               "step_ms": step_ms,
               "examples_per_s": steady * TRAIN_BATCH / wall,
               "host_launch_ms": 1e3 * host}
        profile["idle_share"] = 1.0 - profile["device_ms_per_step"] / step_ms
        run["profile"] = profile
        runs[name] = run
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in sk.KERNELS}
    return {"phase": "train_deep", "fields": N_FIELDS, "vocab": VOCAB,
            "factor_dim": DIM, "hidden": HIDDEN, "n_cross": N_CROSS,
            "batch": TRAIN_BATCH, "lambda_l2": LAMBDA_L2,
            "health_feed": False,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL, "runs": runs,
            "launches": launches}


# -- phase: dp_deep -----------------------------------------------------------

#: the 8-bit exchange with a measured range (dp_deep (b))
DP_DEEP_CODED = {"compress_bits": 8, "compress_range": "dynamic"}
#: (name, kind, trainer, kwargs, steps, lr) of the dp_deep phase's runs:
#: (a) the hybrid exchange exact, (b) the same 8-bit with a measured range,
#: (c) CTRTrainer(mesh=...) exact, the CLI's --dp
DP_DEEP_RUNS = (
    ("deepfm_sparse_exact", "deepfm", "sparse", {}, 10, LR),
    ("dcn_sparse_exact", "dcn", "sparse", {}, 10, DCN_LR),
    ("deepfm_sparse_coded", "deepfm", "sparse", DP_DEEP_CODED, 5, LR),
    ("dcn_sparse_coded", "dcn", "sparse", DP_DEEP_CODED, 5, DCN_LR),
    ("deepfm_dense_exact", "deepfm", "dense", {}, 5, LR),
)
DP_DEEP_CPU_STEPS = 2       # exact steps re-run at W = 2 on the CPU
DP_DEEP_PROFILE_STEPS = 3
#: the family's tolerance card vs CPU (ROADMAP §C: the tanh of fc1)
DP_DEEP_RTOL, DP_DEEP_ATOL = 1e-4, 2e-5


def dp_deep_plan(kind, coded) -> dict:
    """{table: exchange} the hybrid step picks at this phase's shapes: the
    port's ``pick_exchange_algo`` on each table's local ids (DP_LOCAL_K a
    rank), vocabulary and row width."""
    from lightctr_tpu_torch.dist import collectives

    bits = 8 if coded else None
    return {t: collectives.pick_exchange_algo(
        DP_WORLD, DP_LOCAL_K, VOCAB, 1 if t == "w" else DIM,
        sparse_bits=bits, dense_bits=bits)[0] for t in KIND_TABLES[kind]}


def dp_deep_expected_launches(sk, kind, mode, coded, steps) -> dict:
    """Launches one rank makes in ``steps`` steps.  The hybrid exchange
    (each table its own id stream): per table the local stream deduped
    and the lookup's backward (merge_rows); a table on the sparse
    allgather also dedups the gathered stream and applies in merge_apply's
    merge mode, and coded sends its rows through quantize_pack; coded,
    the dense ring's DP_WORLD hops (the reduce-scatter's W - 1 and the
    owned segment's one) run quantize_pack, as does each table on the
    dense exchange's ring.  CTRTrainer: the lookup's backward per table,
    and coded the ring's hops."""
    plan = dp_deep_plan(kind, coded)
    if "sparse_rs" in plan.values():
        raise AssertionError(f"dp_deep: no reduce-scatter at W = {DP_WORLD} "
                             f"expected, the pick says {plan}")
    tables = len(plan)
    sparse = sum(1 for a in plan.values() if a == "sparse")
    want = dict.fromkeys(sk.KERNELS, 0)
    ring = DP_WORLD if coded else 0
    if mode == "sparse":
        want.update(dedup_ids=(tables + sparse) * steps,
                    merge_rows=tables * steps, merge_apply=sparse * steps,
                    quantize_pack=(sparse + ring * (1 + tables - sparse))
                    * steps if coded else 0)
    else:
        want.update(merge_rows=tables * steps, quantize_pack=ring * steps)
    return want


def state_digest(tr, replicated: bool = True) -> dict:
    """sha256 of every parameter leaf and optimizer-state leaf of a
    trainer (FM's or the family's); ``replicated`` leaves out each rank's
    own EF residuals."""
    import hashlib

    from lightctr_tpu_torch.optim.updaters import tree_leaves

    leaves = {"param/" + k: v for k, v in flat_leaves(tr.params).items()}
    st = tr.opt_state
    if isinstance(st, dict):
        parts = {k: st[k] for k in st
                 if not replicated or k in ("dense", "accum")}
    else:
        parts = {"state": st.inner if replicated and hasattr(st, "inner")
                 else st}
    for name, sub in parts.items():
        for i, t in enumerate(tree_leaves(sub)):
            leaves[f"{name}/{i}"] = t
    return {k: hashlib.sha256(t.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, t in leaves.items()}


def deep_snapshot(tr, ids, tables) -> dict:
    """CPU copies of a trainer's dense leaves and the rows ``ids`` of its
    ``tables``."""
    return {k: (v.index_select(0, ids) if k in tables else v)
            .detach().cpu().clone() for k, v in flat_leaves(tr.params).items()}


def phase_dp_deep(np, torch, sk, seed) -> dict:
    """DeepFM and DCN at Criteo width data-parallel over DP_WORLD gloo
    ranks on the one card: both trainers with ``mesh=``, launches against
    the plan, every rank identical, the exact runs' first steps re-run on
    the CPU, the coded runs' repeated step bit-identical."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world

    card_steps = {r[0]: r[4] for r in DP_DEEP_RUNS}
    cpu_steps = {r[0]: DP_DEEP_CPU_STEPS for r in DP_DEEP_RUNS if not r[3]}
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_deep_")
    try:
        dirs = {k: os.path.join(root, k) for k in ("card", "cpu")}
        for d in dirs.values():
            os.makedirs(d)
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["card"], seed, "cuda", card_steps,
                          "dp_deep"))
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["cpu"], seed, "cpu", cpu_steps, "dp_deep"))
        cpu_s = time.perf_counter() - t

        def load(d, r):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                return json.load(f)

        card = [load(dirs["card"], r) for r in range(DP_WORLD)]
        cpu = load(dirs["cpu"], 0)
        runs = {}
        for name, kind, mode, kw, steps, lr in DP_DEEP_RUNS:
            recs = [c[name] for c in card]
            coded = bool(kw)
            want = dp_deep_expected_launches(sk, kind, mode, coded, steps)
            for r, rec in enumerate(recs):
                # a spawned rank registers only the kernels its modules
                # import: the ones it lacks launched nothing there
                got = {k: rec["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"dp_deep {name} rank {r}: launches "
                                         f"{got}, planned {want}")
                want_ma = ({"merge": want["merge_apply"]}
                           if want["merge_apply"] else {})
                want_qp = ({"tree": want["quantize_pack"]}
                           if want["quantize_pack"] else {})
                if rec["merge_apply_variants"] != want_ma or \
                        rec["quantize_pack_variants"] != want_qp:
                    raise AssertionError(
                        f"dp_deep {name} rank {r}: designs "
                        f"{rec['merge_apply_variants']} "
                        f"{rec['quantize_pack_variants']}, planned "
                        f"{want_ma} {want_qp}")
                if mode == "sparse" and \
                        rec["policy"] != dp_deep_plan(kind, coded):
                    raise AssertionError(f"dp_deep {name}: policy "
                                         f"{rec['policy']}, planned "
                                         f"{dp_deep_plan(kind, coded)}")
                if rec["digest"] != recs[0]["digest"]:
                    raise AssertionError(f"dp_deep {name}: rank {r}'s state "
                                         "is not bit-identical to rank 0's")
                if coded and not rec["repeat_step_bit_identical"]:
                    raise AssertionError(f"dp_deep {name} rank {r}: a step "
                                         "run twice from one state differs")
            losses = recs[0]["losses"]
            if not all(np.isfinite(losses)):
                raise AssertionError(f"dp_deep {name}: losses {losses}")
            third = max(1, steps // 3)
            if not coded and \
                    np.mean(losses[-third:]) >= np.mean(losses[:third]):
                raise AssertionError(f"dp_deep {name}: loss did not fall "
                                     f"{losses}")
            run = {"kind": kind, "trainer": mode, "kwargs": kw,
                   "steps": steps, "lr": lr, "launches_per_rank": want,
                   "losses": losses, "ranks_bit_identical": True}
            if mode == "sparse":
                run["policy"] = recs[0]["policy"]
                run["bytes_per_step"] = recs[0]["bytes_per_step"]
            if coded:
                run["repeat_step_bit_identical"] = True
            if name in cpu:
                c_losses = cpu[name]["losses"]
                if not np.allclose(losses[:len(c_losses)], c_losses,
                                   rtol=DP_DEEP_RTOL, atol=0):
                    raise AssertionError(f"dp_deep {name}: losses card "
                                         f"{losses[:len(c_losses)]} vs cpu "
                                         f"{c_losses}")
                got = torch.load(os.path.join(dirs["card"],
                                              f"snap_{name}.pt"))
                want_snap = torch.load(os.path.join(dirs["cpu"],
                                                    f"snap_{name}.pt"))
                err = 0.0
                for k, a in got.items():
                    b = want_snap[k]
                    if not torch.allclose(a, b, rtol=DP_DEEP_RTOL,
                                          atol=DP_DEEP_ATOL):
                        raise AssertionError(
                            f"dp_deep {name}: {k} differs card vs cpu after "
                            f"{DP_DEEP_CPU_STEPS} steps, max abs "
                            f"{float((a - b).abs().max())}")
                    err = max(err, float((a - b).abs().max()))
                run.update(cpu_steps=len(c_losses),
                           loss_rel_err_vs_cpu=max(
                               abs(a - b) / abs(b)
                               for a, b in zip(losses, c_losses)),
                           max_abs_err_vs_cpu=err)
            if "steady_wall_s" in recs[0]:
                steady = recs[0]["steady_steps"]
                run["step_ms"] = 1e3 * recs[0]["steady_wall_s"] / steady
                run["examples_per_s_gloo_host_staged"] = (
                    steady * TRAIN_BATCH / recs[0]["steady_wall_s"])
            if "profile" in recs[0]:
                prof = recs[0]["profile"]
                prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / \
                    run["step_ms"]
                run["profile_rank0"] = prof
            runs[name] = run
        launches = {k: sum(card[0][r[0]]["launches"].get(k, 0)
                           for r in DP_DEEP_RUNS) for k in sk.KERNELS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "dp_deep", "world": DP_WORLD,
            "backend": "gloo (host-staged), all ranks on cuda:0",
            "fields": N_FIELDS, "vocab": VOCAB, "factor_dim": DIM,
            "hidden": HIDDEN, "batch": TRAIN_BATCH,
            "local_rows": DP_LOCAL_ROWS, "lambda_l2": LAMBDA_L2,
            "rtol": DP_DEEP_RTOL, "atol": DP_DEEP_ATOL, "runs": runs,
            "seconds": {"card_world": card_s, "cpu_world": cpu_s},
            "launches_rank0": launches}


# -- phase: cli ---------------------------------------------------------------

CLI_ROWS = 65536
CLI_EVAL_ROWS = 16384
CLI_EPOCHS = 2
#: (subcommand, its flags beyond the common ones) of the in-process runs:
#: factor 32 but for ffm (the CLI's default 8: its v is 2^20 x 39 x 8),
#: DCN at DCN_LR, seqctr at its defaults (dim 32, 4 heads, 2 layers)
CLI_RUNS = (("fm", ("--factor", "32")), ("ffm", ()),
            ("nfm", ("--factor", "32")), ("widedeep", ("--factor", "32")),
            ("deepfm", ("--factor", "32")),
            ("dcn", ("--factor", "32", "--lr", str(DCN_LR))),
            ("seqctr", ()))
#: table gathers a step of each subcommand (each one merge_rows launch in
#: the backward of ``embed.table.lookup``)
CLI_LOOKUPS = {"fm": 2, "ffm": 2, "nfm": 2, "widedeep": 2, "deepfm": 2,
               "dcn": 1, "seqctr": 1}
#: subcommands whose model reads no feature value: DCN's only inputs are
#: the per-field embeddings of ``rep_fids`` (the JAX model's too), and the
#: proxy's label is a logistic in two numeric fields' values plus the
#: parity of field 0's id, which an embedding learns id by id.  Its
#: held-out AUC is reported (0.504 in this phase on an NVIDIA H100 80GB
#: HBM3 at 700 W, PERF.md section 5) and its train AUC held to MIN_AUC
#: instead.
CLI_VALUE_BLIND = ("dcn",)
#: the sequence file: item vocabulary, lengths, and the "intent" items
#: (ids 1..63) a positive row holds three of
SEQ_VOCAB = 1 << 20
SEQ_LENGTHS = (10, 50)
SEQ_INTENT = 64
CLI_SCORE_ATOL = 1e-6
CLI_LAUNCHER_TIMEOUT_S = 420
#: ``deepfm --dp`` trains full-batch, one step an epoch: at the CLI's
#: default lr 0.1 those steps overshoot and the loss climbs past the
#: init's, so the --dp runs take lr 0.01 and four epochs, over which the
#: exact run's loss falls step by step
CLI_DP_LR = 0.01
CLI_DP_EPOCHS = 4
#: the exact two-rank launcher run against the one-rank in-process run
#: (the same mean gradient, summed in another order): final loss and
#: train AUC within this relative distance, the family's rtol
CLI_DP_RTOL = 1e-4


def write_seq_file(np, path, rows, seed) -> str:
    """``label id id ...`` rows: lengths uniform in SEQ_LENGTHS, items
    skewed over the vocabulary (u^4 head/tail) above the intent ids; a
    positive row (half of them) carries three intent ids at random
    places, so the label depends on the items."""
    rng = np.random.default_rng(seed)
    lo, hi = SEQ_LENGTHS
    with open(path, "w") as f:
        for start in range(0, rows, 8192):
            n = min(8192, rows - start)
            lens = rng.integers(lo, hi + 1, n)
            y = rng.random(n) < 0.5
            ids = SEQ_INTENT + (rng.random((n, hi)) ** 4 * (
                SEQ_VOCAB - SEQ_INTENT)).astype(np.int64)
            lines = []
            for i in range(n):
                row = ids[i, :lens[i]]
                if y[i]:
                    row[rng.integers(0, lens[i], 3)] = rng.integers(
                        1, SEQ_INTENT, 3)
                lines.append(f"{int(y[i])} " + " ".join(map(str, row))
                             + "\n")
            f.writelines(lines)
    return path


def cli_files(np, seed, root) -> dict:
    """The phase's files: a Criteo-layout libFFM file and its held-out
    file (``data.synth.write_criteo_proxy``), and two sequence files."""
    from lightctr_tpu_torch.data import synth

    kw = dict(n_fields=N_FIELDS, n_cat=N_CAT, vocab=VOCAB)
    t = time.perf_counter()
    files = {
        "train": synth.write_criteo_proxy(os.path.join(root, "train.ffm"),
                                          CLI_ROWS, seed=seed + 31, **kw),
        "eval": synth.write_criteo_proxy(os.path.join(root, "eval.ffm"),
                                         CLI_EVAL_ROWS, seed=seed + 32, **kw),
        "seq": write_seq_file(np, os.path.join(root, "seq.txt"), CLI_ROWS,
                              seed + 33),
        "seq_eval": write_seq_file(np, os.path.join(root, "seq_eval.txt"),
                                   CLI_EVAL_ROWS, seed + 34)}
    files["write_s"] = time.perf_counter() - t
    return files


def cli_score_batch(np, model, path, params):
    """The batch a run's ``--dump-scores`` scored: the held-out libFFM file
    read against the trained vocabulary (the family with its
    field-representative pair), or seqctr's training file."""
    from lightctr_tpu_torch.cli.__main__ import parse_seq_file
    from lightctr_tpu_torch.data import load_libffm
    from lightctr_tpu_torch.models import widedeep

    if model == "seqctr":
        return parse_seq_file(path, 128)[0]
    table = params["w"] if "w" in params else params["embed"]
    ev = load_libffm(path, feature_cnt=int(table.shape[0]),
                     field_cnt=N_FIELDS)
    if model in ("widedeep", "deepfm", "dcn"):
        return widedeep.make_batch(ev, *widedeep.field_representatives(
            ev.fids, ev.fields, ev.mask, N_FIELDS))
    return ev.batch_dict()


def cli_restored_scores(np, torch, model, ck_dir, path) -> tuple:
    """The latest checkpoint under ``ck_dir`` restored, and the scores its
    params give the run's scored batch on the card."""
    from lightctr_tpu_torch import ckpt
    from lightctr_tpu_torch.models import (attention_ctr, deepfm, ffm, fm,
                                           nfm, widedeep)
    from lightctr_tpu_torch.ops.activations import sigmoid

    step = ckpt.latest_step(ck_dir)
    state = ckpt.restore(ck_dir)
    params = state["params"]
    logits = {"fm": fm.logits, "ffm": ffm.logits, "nfm": nfm.logits,
              "widedeep": widedeep.logits, "deepfm": deepfm.logits,
              "dcn": deepfm.dcn_logits,
              "seqctr": attention_ctr.make_logits(4)}[model]
    batch = cli_score_batch(np, model, path, params)
    with torch.no_grad():
        probs = sigmoid(logits(params, {k: torch.from_numpy(v).cuda()
                                        for k, v in batch.items()}))
    devices = sorted({str(t.device) for t in flat_leaves(params).values()
                      if hasattr(t, "device")})
    return step, probs.cpu().numpy(), devices, type(state["opt_state"])


def cli_run(torch, sk, argv) -> tuple:
    """``cli.main(argv)`` in this process: the report it printed, the
    per-epoch losses of its ``epoch`` events, its launches (counts reset
    just before) and its seconds."""
    import contextlib
    import io

    from lightctr_tpu_torch.cli import __main__ as cli
    from lightctr_tpu_torch.obs import events, gate

    log = events.configure()
    out = io.StringIO()
    torch.cuda.synchronize()
    sk.reset_launches()
    t = time.perf_counter()
    with gate.override(True), contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = sk.launches()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: exit {rc}")
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    epochs = [r["loss"] for r in log.records() if r["kind"] == "epoch"]
    events.configure()
    return report, epochs, launches, secs


def cli_dp_argv(files) -> list:
    """The --dp runs' arguments after the subcommand's name."""
    return ["--data", files["train"], "--eval-data", files["eval"],
            "--epochs", str(CLI_DP_EPOCHS), "--lr", str(CLI_DP_LR),
            "--factor", str(DIM), "--dp", "--device", "cuda"]


def cli_dp_reference(np, torch, sk, files) -> dict:
    """``deepfm --dp`` in this process without a launcher: a one-rank
    group over the card, the whole batch a step.  Its loss must fall at
    every step; the launcher runs are held to it."""
    argv = ["deepfm", *cli_dp_argv(files)]
    rep, epochs, launches, secs = cli_run(torch, sk, argv)
    want = dict.fromkeys(sk.KERNELS, 0)
    want["merge_rows"] = CLI_LOOKUPS["deepfm"] * CLI_DP_EPOCHS
    if launches != want:
        raise AssertionError(f"cli deepfm --dp, one rank: launches "
                             f"{launches}, planned {want}")
    if rep.get("parallel") != {"devices": 1, "compress_bits": None} or \
            len(epochs) != CLI_DP_EPOCHS or not all(np.isfinite(epochs)) or \
            rep["final_loss"] != epochs[-1] or \
            not all(b < a for a, b in zip(epochs, epochs[1:])):
        raise AssertionError(f"cli deepfm --dp, one rank: epochs {epochs}, "
                             f"report {rep}")
    return {"argv": argv[:1] + argv[3:], "seconds": secs, "report": rep,
            "epoch_losses": epochs, "launches": launches}


def row_keys(np, batch) -> list:
    """One bytes key per row of a host batch (its fids, vals and label):
    the identity the ``--dp`` rank probe maps trained rows back by."""
    fids = np.ascontiguousarray(np.asarray(batch["fids"]))
    vals = np.ascontiguousarray(np.asarray(batch["vals"], np.float32))
    labels = np.asarray(batch["labels"], np.float32)
    return [fids[i].tobytes() + vals[i].tobytes() + labels[i].tobytes()
            for i in range(len(labels))]


def cli_rank_main(argv) -> int:
    """``chip_smoke.py --cli-rank OUT_DIR <cli argv>``: one rank of the
    ``--dp`` launcher runs.  ``cli.main`` with ``CTRTrainer._put`` wrapped:
    its first call (the full batch ``fit`` puts on the card) records which
    rows of the global batch this rank was handed — each row of the device
    batch mapped back to its index by its fids, vals and label — into
    ``OUT_DIR/rank<r>.json`` with the row count and a digest of the
    indices, and prints the count and digest to stderr."""
    import hashlib

    import numpy as np

    sys.path.insert(0, REPO)
    from lightctr_tpu_torch.cli import __main__ as cli
    from lightctr_tpu_torch.models import ctr_trainer

    out_dir, cli_argv = argv[0], argv[1:]
    orig = ctr_trainer.CTRTrainer._put
    seen = {}

    def probe(self, batch, non_blocking=False):
        dev = orig(self, batch, non_blocking=non_blocking)
        if not seen and self.mesh is not None:
            index = {k: i for i, k in enumerate(row_keys(np, batch))}
            mine = row_keys(np, {k: dev[k].cpu().numpy()
                                 for k in ("fids", "vals", "labels")})
            rows = [index.get(k, -1) for k in mine]
            digest = hashlib.sha256(
                np.asarray(rows, np.int64).tobytes()).hexdigest()[:16]
            seen.update(rank=self.mesh.rank, world=self.mesh.size,
                        global_rows=len(index), rows=len(rows),
                        digest=digest, indices=rows)
            with open(os.path.join(out_dir, f"rank{self.mesh.rank}.json"),
                      "w") as f:
                json.dump(seen, f)
            print(f"cli-rank {self.mesh.rank}: first batch {len(rows)} "
                  f"rows, row digest {digest}", file=sys.stderr, flush=True)
        return dev

    ctr_trainer.CTRTrainer._put = probe
    return cli.main(cli_argv)


def check_rank_rows(np, rows_dir, world, n_rows) -> dict:
    """The ``--dp`` ranks' probes: each rank trained its own rows, the
    ranks' rows are disjoint, and together they are the global batch the
    CLI trims to a multiple of the world (``cli/__main__.py``), each
    record's digest that of its indices."""
    import hashlib

    recs = []
    for r in range(world):
        with open(os.path.join(rows_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    want_rows = (n_rows // world) * world
    seen = set()
    for rec in recs:
        idx = rec["indices"]
        digest = hashlib.sha256(
            np.asarray(idx, np.int64).tobytes()).hexdigest()[:16]
        if digest != rec["digest"] or rec["rows"] != len(idx):
            raise AssertionError(f"cli --dp rank {rec['rank']}: its record "
                                 "does not match its digest")
        if rec["global_rows"] != want_rows or min(idx, default=-1) < 0:
            raise AssertionError(
                f"cli --dp rank {rec['rank']}: global batch "
                f"{rec['global_rows']} rows (want {want_rows}) or rows "
                "outside it")
        if seen & set(idx) or len(set(idx)) != len(idx):
            raise AssertionError(f"cli --dp rank {rec['rank']} trained rows "
                                 "another rank trained (or one twice)")
        seen |= set(idx)
    if seen != set(range(want_rows)):
        raise AssertionError(f"cli --dp: the ranks trained {len(seen)} of "
                             f"the global batch's {want_rows} rows")
    return {"global_rows": want_rows,
            "rank_rows": [rec["rows"] for rec in recs],
            "rank_digests": [rec["digest"] for rec in recs],
            "disjoint_and_whole": True}


def cli_launcher(np, torch, files, root, compress, ref) -> dict:
    """``deepfm --dp`` (``compress``: with ``--compress-bits 8``) under
    ``python -m torch.distributed.run --nproc-per-node 2``: two ranks
    sharing the card over gloo, full batch a step; the report, and the
    checkpoint restored to the dumped held-out scores.  Each rank runs
    through this script's rank probe (``cli_rank_main``): the ranks' rows
    must be disjoint and together the trimmed global batch
    (``check_rank_rows``).  Against ``ref`` (``cli_dp_reference``): the
    exact run's final loss and train AUC within CLI_DP_RTOL, and either
    run's final loss below the init's (the reference's first, the same
    init and batch)."""
    import signal

    tag = "dp8" if compress else "dp"
    ck, scores = os.path.join(root, f"ck_{tag}"), os.path.join(
        root, f"scores_{tag}.txt")
    rows_dir = os.path.join(root, f"rows_{tag}")
    os.makedirs(rows_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DP_WORLD),
           os.path.join(REPO, "chip_smoke.py"), "--cli-rank", rows_dir,
           "deepfm", *cli_dp_argv(files),
           "--ckpt-dir", ck, "--dump-scores", scores]
    if compress:
        cmd += ["--compress-bits", "8"]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=CLI_LAUNCHER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"cli {tag}: the launcher ran past "
                             f"{CLI_LAUNCHER_TIMEOUT_S} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    secs = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli {tag}: exit {proc.returncode}: "
                             f"{stderr[-3000:]}")
    reports = [json.loads(line) for line in stdout.splitlines()
               if line.startswith("{")]
    if len(reports) != 1:
        raise AssertionError(f"cli {tag}: {len(reports)} reports, not rank "
                             f"0's one: {stdout[-2000:]}")
    rep = reports[0]
    if rep["parallel"] != {"devices": DP_WORLD,
                           "compress_bits": 8 if compress else None} or \
            not np.isfinite(rep["final_loss"]) or \
            not np.isfinite(rep["eval"]["auc"]):
        raise AssertionError(f"cli {tag}: report {rep}")
    want = ref["report"]
    gaps = {k: abs(got - w) / abs(w) for k, got, w in (
        ("final_loss", rep["final_loss"], want["final_loss"]),
        ("train_auc", rep["train"]["auc"], want["train"]["auc"]))}
    if not compress and max(gaps.values()) > CLI_DP_RTOL:
        raise AssertionError(f"cli {tag}: {rep} against the one-rank run's "
                             f"{want}: relative gaps {gaps}")
    if not rep["final_loss"] < ref["epoch_losses"][0]:
        raise AssertionError(f"cli {tag}: final loss {rep['final_loss']} "
                             f"not below the init's "
                             f"{ref['epoch_losses'][0]}")
    step, probs, devices, _ = cli_restored_scores(np, torch, "deepfm", ck,
                                                  files["eval"])
    dumped = np.loadtxt(scores)
    err = float(np.abs(probs - dumped).max())
    if step != CLI_DP_EPOCHS or err > CLI_SCORE_ATOL:
        raise AssertionError(f"cli {tag}: checkpoint step {step}, restored "
                             f"scores {err} from the dump")
    ranks = check_rank_rows(np, rows_dir, DP_WORLD, CLI_ROWS)
    return {"argv": cmd[3:], "seconds": secs, "report": rep,
            "rank_rows": ranks,
            "rel_gap_vs_one_rank": gaps,
            "held_to_one_rank": not compress,
            "restored_step": step, "restored_devices": devices,
            "restored_scores_max_abs_err": err}


def phase_cli(np, torch, sk, seed) -> dict:
    """Each ported subcommand of ``python -m lightctr_tpu_torch.cli`` run
    in this process on the card, then ``deepfm --dp`` on one rank in this
    process and on two under the launcher, held to the one-rank run:
    reports, the loss falling, held-out AUC, launches against the plan,
    and every checkpoint restored to its dumped scores."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        files = cli_files(np, seed, root)
        runs = {}
        launches = dict.fromkeys(sk.KERNELS, 0)
        for model, extra in CLI_RUNS:
            seq = model == "seqctr"
            ck = os.path.join(root, f"ck_{model}")
            scores = os.path.join(root, f"scores_{model}.txt")
            argv = [model, "--data", files["seq" if seq else "train"],
                    "--eval-data", files["seq_eval" if seq else "eval"],
                    "--epochs", str(CLI_EPOCHS),
                    "--batch-size", str(TRAIN_BATCH), "--ckpt-dir", ck,
                    "--dump-scores", scores, "--device", "cuda", *extra]
            rep, epochs, got, secs = cli_run(torch, sk, argv)
            steps = CLI_EPOCHS * (CLI_ROWS // TRAIN_BATCH)
            want = dict.fromkeys(sk.KERNELS, 0)
            want["merge_rows"] = CLI_LOOKUPS[model] * steps
            if got != want:
                raise AssertionError(f"cli {model}: launches {got}, planned "
                                     f"{want}")
            for k in ("train", "final_loss", "eval", "checkpoint",
                      "scores"):
                if k not in rep:
                    raise AssertionError(f"cli {model}: no {k!r} in {rep}")
            if len(epochs) != CLI_EPOCHS or \
                    not np.isfinite(rep["final_loss"]) or \
                    rep["final_loss"] != epochs[-1] or \
                    not rep["final_loss"] < epochs[0]:
                raise AssertionError(f"cli {model}: final loss "
                                     f"{rep['final_loss']}, epochs {epochs}")
            gated = "train" if model in CLI_VALUE_BLIND else "eval"
            if not rep[gated]["auc"] > MIN_AUC:
                raise AssertionError(f"cli {model}: {gated} AUC "
                                     f"{rep[gated]['auc']} <= {MIN_AUC}")
            step, probs, devices, state_type = cli_restored_scores(
                np, torch, model, ck,
                files["seq"] if seq else files["eval"])
            dumped = np.loadtxt(scores)
            err = float(np.abs(probs - dumped).max())
            if step != CLI_EPOCHS or probs.shape != dumped.shape or \
                    err > CLI_SCORE_ATOL:
                raise AssertionError(f"cli {model}: checkpoint step {step}, "
                                     f"restored scores {err} from the dump")
            for k in launches:
                launches[k] += got[k]
            runs[model] = {"argv": argv[:1] + list(extra), "seconds": secs,
                           "auc_gated": gated,
                           "steps": steps, "launches": got,
                           "epoch_losses": epochs, "report": rep,
                           "restored_step": step,
                           "restored_devices": devices,
                           "restored_opt_state": state_type.__name__,
                           "restored_scores_max_abs_err": err}
            torch.cuda.empty_cache()
        ref = cli_dp_reference(np, torch, sk, files)
        for k in launches:
            launches[k] += ref["launches"][k]
        launcher = {"dp_one_rank": ref,
                    "dp": cli_launcher(np, torch, files, root, False, ref),
                    "dp_compress8": cli_launcher(np, torch, files, root,
                                                 True, ref)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "cli", "rows": CLI_ROWS, "eval_rows": CLI_EVAL_ROWS,
            "epochs": CLI_EPOCHS, "batch": TRAIN_BATCH,
            "files_write_s": files["write_s"], "runs": runs,
            "launcher": launcher, "launches": launches}


# -- phase: zoo ---------------------------------------------------------------

#: the image file: the reference's width (28 x 28) and 10 classes, 10,000
#: rows (MNIST's 60,000 training rows cut to a sixth)
ZOO_ROWS = 10000
ZOO_FEATURES = 784
ZOO_CLASSES = 10
#: the text file of plsa and embed: lines of one topic each, words drawn
#: from a Zipf law over a 5,000-word vocabulary in that topic's own order
ZOO_LINES = 4000
ZOO_LINE_WORDS = (20, 40)
ZOO_VOCAB = 5000
ZOO_TOPICS = 8
ZOO_ZIPF = 1.1
#: the DL runs' epochs (1,000 steps each at the CLI's batch of 10; cut
#: from 2 to keep the script inside its time limit); cnn under its CLI
#: optimizer (rmsprop) at lr 0.01: the default 0.1 overshoots on this data
#: and the net stays at chance, in the JAX package too
#: (tests/test_dl_models.py trains the CNN at 0.01)
ZOO_DL_EPOCHS = 1
ZOO_CNN_LR = 0.01
ZOO_GBM_TREES, ZOO_GBM_DEPTH = 10, 6       # the CLI's defaults
ZOO_LR_STEPS = 200                         # stack's --lr-steps default
ZOO_W2V_EPOCHS, ZOO_W2V_BATCH, ZOO_W2V_WINDOW = 10, 256, 6   # embed's
ZOO_RUNS = (
    ("cnn", ("cnn", "--data", "{dense}", "--epochs", str(ZOO_DL_EPOCHS),
             "--lr", str(ZOO_CNN_LR))),
    ("rnn", ("rnn", "--data", "{dense}", "--epochs", str(ZOO_DL_EPOCHS))),
    ("vae", ("vae", "--data", "{dense}", "--epochs", str(ZOO_DL_EPOCHS))),
    ("gbm", ("gbm", "--data", "{dense}", "--n-trees", str(ZOO_GBM_TREES),
             "--max-depth", str(ZOO_GBM_DEPTH))),
    ("gbm10", ("gbm", "--data", "{dense}", "--n-trees", str(ZOO_GBM_TREES),
               "--max-depth", str(ZOO_GBM_DEPTH), "--n-classes",
               str(ZOO_CLASSES))),
    ("stack", ("stack", "--data", "{dense}")),
    ("gmm", ("gmm", "--data", "{dense}", "--clusters", "10")),
    ("plsa", ("plsa", "--data", "{text}", "--topics", str(ZOO_TOPICS))),
    ("embed", ("embed", "--data", "{text}", "--mode", "negative",
               "--quantize", "--cluster", "20")),
    ("embed_hs", ("embed", "--data", "{text}", "--mode", "hierarchical")),
)
#: "well above chance" (0.1) for cnn and rnn; train AUC of gbm and stack
ZOO_MIN_ACCURACY = 0.5
ZOO_MIN_AUC = 0.9
#: card against CPU: steps re-run, and the CPU tests' tolerances
ZOO_CPU_STEPS = 3
ZOO_TRAJ = dict(rtol=1e-4, atol=2e-5)      # tanh paths' trajectories
ZOO_PARAM = dict(rtol=1e-2, atol=5e-4)     # their params after the steps
ZOO_STEP = dict(rtol=1e-5, atol=1e-6)      # an EM step's log-likelihood
ZOO_FIT = dict(rtol=1e-4, atol=1e-5)       # EM params, the stack's LR
ZOO_W2V = dict(rtol=1e-4, atol=1e-4)       # word2vec tables
ZOO_PROFILE_STEPS = 5
#: (role, device) of the card-against-CPU checks
ZOO_ROLES = (("card", "cuda"), ("cpu", "cpu"))


def zoo_words() -> list:
    """ZOO_VOCAB distinct three-letter words (the tokenizer keeps
    letters only)."""
    return ["".join(chr(97 + (i // 26 ** k) % 26) for k in (2, 1, 0))
            for i in range(ZOO_VOCAB)]


def write_topic_text(np, path, seed) -> str:
    rng = np.random.default_rng(seed)
    words = zoo_words()
    p = np.arange(1, ZOO_VOCAB + 1, dtype=np.float64) ** -ZOO_ZIPF
    p /= p.sum()
    order = [rng.permutation(ZOO_VOCAB) for _ in range(ZOO_TOPICS)]
    with open(path, "w") as f:
        for _ in range(ZOO_LINES):
            topic = order[rng.integers(ZOO_TOPICS)]
            ids = topic[rng.choice(ZOO_VOCAB, rng.integers(*ZOO_LINE_WORDS),
                                   p=p)]
            f.write(" ".join(words[i] for i in ids) + "\n")
    return path


def zoo_corpus(np, path, seed) -> tuple:
    """embed's host preparation of ``path`` (the CLI's): (vocabulary size,
    counts, centers, contexts, mask)."""
    from lightctr_tpu_torch.data import text
    from lightctr_tpu_torch.models import embedding

    with open(path) as f:
        docs = [text.tokenize(line) for line in f if line.strip()]
    words, counts, w2i = text.build_vocab(docs, max_size=ZOO_VOCAB)
    pairs = embedding.cbow_pairs(text.docs_to_ids(docs, w2i), ZOO_W2V_WINDOW,
                                 counts=counts, seed=seed)
    return (len(words), counts) + pairs


def zoo_expected_launches(sk, name, rep) -> dict:
    """The plan of one run: merge_rows once a histogram or leaf-sum merge
    of every tree (gbm, gbm10, stack) plus once a step of the stack's LR
    gather, once a table gather a word2vec step, nothing else anywhere."""
    from lightctr_tpu_torch.models import embedding, gbm

    want = dict.fromkeys(sk.KERNELS, 0)
    if name in ("gbm", "gbm10", "stack"):
        trees = ZOO_GBM_TREES * (ZOO_CLASSES if name == "gbm10" else 1)
        want["merge_rows"] = trees * gbm.histogram_merges(ZOO_GBM_DEPTH) + (
            ZOO_LR_STEPS if name == "stack" else 0)
    elif name.startswith("embed"):
        mode = "hierarchical" if name == "embed_hs" else "negative"
        steps = rep["n_pairs"] // min(ZOO_W2V_BATCH, rep["n_pairs"])
        want["merge_rows"] = embedding.GATHERS[mode] * steps * ZOO_W2V_EPOCHS
    return want


def zoo_steps(name, rep) -> int:
    """Steps (trees for GBM, EM iterations left out) of one run."""
    if name in ("cnn", "rnn", "vae"):
        return ZOO_DL_EPOCHS * (ZOO_ROWS // 10)
    if name in ("gbm", "gbm10"):
        return ZOO_GBM_TREES * (ZOO_CLASSES if name == "gbm10" else 1)
    if name == "stack":
        return ZOO_GBM_TREES + ZOO_LR_STEPS
    if name.startswith("embed"):
        return ZOO_W2V_EPOCHS * (rep["n_pairs"] // ZOO_W2V_BATCH)
    return 0


def close_err(np, got, want, what, rtol, atol) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or \
            not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"zoo {what}: card and CPU differ, max abs "
                             f"{float(np.abs(got - want).max())}")
    return float(np.abs(got - want).max()) if got.size else 0.0


def tree_numpy(tree) -> dict:
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def zoo_classifier(np, torch, name, ds, seed) -> dict:
    """cnn / rnn: the CLI's init (its generator on the card) and optimizer;
    its loss over the whole file (the bar the trained net must go
    under); ZOO_CPU_STEPS steps of the first minibatches on the card and,
    from a copy of the init, on the CPU; a profile of more steps."""
    from lightctr_tpu_torch import optim
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import cnn, rnn
    from lightctr_tpu_torch.models.dl_trainer import ClassifierTrainer
    from lightctr_tpu_torch.optim.updaters import tree_map

    model = cnn if name == "cnn" else rnn
    hidden = 200 if name == "cnn" else 50
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, hidden=hidden, n_classes=ZOO_CLASSES,
                        device="cuda")
    opt = (lambda: optim.rmsprop(ZOO_CNN_LR)) if name == "cnn" else \
        (lambda: optim.adagrad(0.03))
    perm = np.arange(ZOO_ROWS)
    np.random.default_rng(seed).shuffle(perm)
    idx = perm[:ZOO_CPU_STEPS * 10].reshape(ZOO_CPU_STEPS, 10)
    out, losses, trainers = {}, {}, {}
    for role, dev in ZOO_ROLES:
        tr = ClassifierTrainer(tree_map(lambda t: t.to(dev), params),
                               model.logits, TrainConfig(seed=seed),
                               n_classes=ZOO_CLASSES, optimizer=opt(),
                               device=dev)
        if role == "card":
            out["init_train"] = tr.evaluate(ds.features, ds.labels)
        losses[role] = tr.fit_steps_loop(ds.features, ds.labels,
                                         ZOO_CPU_STEPS, 10, idx=idx)
        trainers[role] = tr
    card, cpu = trainers["card"], trainers["cpu"]
    out["loss_max_abs_err"] = close_err(np, losses["card"], losses["cpu"],
                                        f"{name} losses", **ZOO_TRAJ)
    out["param_max_abs_err"] = max(
        close_err(np, a, b, f"{name} params", **ZOO_PARAM)
        for a, b in zip(tree_numpy(card.params), tree_numpy(cpu.params)))
    x = torch.from_numpy(ds.features[idx[0]]).cuda()
    y = torch.from_numpy(ds.labels[idx[0]]).cuda()
    try:
        out["profile"] = profile_calls(torch, [
            lambda: card._step(x, y) for _ in range(ZOO_PROFILE_STEPS)])
    except NoDeviceTime as e:
        out["profile"] = {"error": str(e)}
    return out


def zoo_vae(np, torch, ds, seed) -> dict:
    """vae: the CLI's init; its loss over the whole file with fresh
    noise; ZOO_CPU_STEPS steps on the card and on the CPU fed the same
    noise, drawn on the card."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import vae
    from lightctr_tpu_torch.models.dl_trainer import grad_step
    from lightctr_tpu_torch.optim.updaters import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = vae.init(gen, ZOO_FEATURES, device="cuda")
    x_all = torch.from_numpy(ds.features).cuda()
    with torch.no_grad():
        eps = torch.randn((ZOO_ROWS, 20), generator=gen, device="cuda")
        init_loss = float(vae.loss_fn(params, x_all, eps, 1.0))
    perm = np.arange(ZOO_ROWS)
    np.random.default_rng(seed).shuffle(perm)
    batches = [(torch.from_numpy(ds.features[perm[i * 10:(i + 1) * 10]]),
                torch.randn((10, 20), generator=gen, device="cuda").cpu())
               for i in range(ZOO_CPU_STEPS)]
    runs = {}
    for role, dev in ZOO_ROLES:
        tr = vae.VAETrainer(tree_map(lambda t: t.to(dev), params),
                            TrainConfig(seed=seed), device=dev)
        losses = []
        for xb, e in batches:
            tr.params, tr.opt_state, loss = grad_step(
                tr._loss, tr.tx, tr.params, tr.opt_state, xb.to(dev),
                e.to(dev))
            losses.append(float(loss))
        runs[role] = (losses, tree_numpy(tr.params))
    return {"init_loss": init_loss,
            "loss_max_abs_err": close_err(np, runs["card"][0], runs["cpu"][0],
                                          "vae losses", **ZOO_TRAJ),
            "param_max_abs_err": max(
                close_err(np, a, b, "vae params", **ZOO_PARAM)
                for a, b in zip(runs["card"][1], runs["cpu"][1]))}


def zoo_gbm(np, torch, ds, seed) -> dict:
    """GBM on the card against the CPU: the binary task's root histograms
    (the first round's gradients and row mask) bit for bit, its first tree
    and the 10-class task's first tree of class 0 equal; two whole binary
    fits at the CLI's configuration bit-identical, tree by tree; the
    stack's LR steps over the card's trees on both."""
    from lightctr_tpu_torch.models import gbm
    from lightctr_tpu_torch.models.stacking import GBMLRStack

    y = (ds.labels > 0).astype(np.float32)
    bins_np, _ = gbm.quantile_bins(ds.features, 32)
    rng = np.random.default_rng(seed)
    row_mask = (rng.random(ZOO_ROWS) < 0.7).astype(np.float32)
    feat_mask = (rng.random(ZOO_FEATURES) < 0.7).astype(np.float32)
    onehot0 = (ds.labels == 0).astype(np.float32)
    p10 = np.float32(0.1)
    cases = {"binary": (0.5 - y, np.full(ZOO_ROWS, 0.25, np.float32)),
             "class0_of_10": (p10 - onehot0,
                              np.full(ZOO_ROWS, 2.0 * p10 * (1 - p10),
                                      np.float32))}
    out = {}
    for what, (g, h) in cases.items():
        trees, hists = [], []
        for _, dev in ZOO_ROLES:
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (bins_np, g, h, row_mask, feat_mask)]
            hists.append(gbm.root_histograms(*args[:4], 32))
            trees.append(gbm.build_tree(*args, ZOO_GBM_DEPTH, 32, 1e-5, 1.0))
        for a, b in zip(*hists):
            if not torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32)):
                raise AssertionError(f"zoo gbm {what}: root histograms "
                                     "differ between the card and the CPU")
        for a, b in zip(*trees):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"zoo gbm {what}: first tree differs "
                                     "between the card and the CPU")
        out[what] = {"root_histograms_bit_exact": True,
                     "first_tree_equal": True,
                     "splits": int((trees[0].feature >= 0).sum())}
    cfg = gbm.GBMConfig(n_trees=ZOO_GBM_TREES, max_depth=ZOO_GBM_DEPTH,
                        seed=seed)
    fits, secs = [], []
    for _ in range(2):
        t = time.perf_counter()
        m = gbm.GBMModel(cfg, device="cuda")
        m.fit(ds.features, y)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        fits.append(m)
    for i, (a, b) in enumerate(zip(*(f.trees for f in fits))):
        for u, v in zip(a, b):
            if not torch.equal(u, v):
                raise AssertionError(f"zoo gbm: tree {i} differs between "
                                     "two fits on the card")
    out["repeat_fit"] = {"trees": len(fits[0].trees), "bit_identical": True,
                         "seconds": secs}
    lr = {}
    for role, dev in ZOO_ROLES:
        st = GBMLRStack(gbm.GBMConfig(max_depth=ZOO_GBM_DEPTH),
                        lr_steps=ZOO_CPU_STEPS, device=dev)
        st.gbm.edges = fits[0].edges
        st.gbm.trees = [type(t)(*(a.to(dev) for a in t))
                        for t in fits[0].trees]
        lr[role] = (st.fit_lr(ds.features, y), st.w.cpu().numpy())
    out["stack_lr_loss_max_abs_err"] = close_err(
        np, lr["card"][0], lr["cpu"][0], "stack LR losses", **ZOO_FIT)
    out["stack_w_max_abs_err"] = close_err(
        np, lr["card"][1], lr["cpu"][1], "stack LR weights", **ZOO_FIT)
    return out


def zoo_em(np, torch, dense_path, text_path, seed) -> dict:
    """gmm and plsa: the CLI's inits on the card; the init's
    log-likelihood (the bar the fit must pass) and the first EM step on
    the card and on the CPU from a copy."""
    from lightctr_tpu_torch.data import text
    from lightctr_tpu_torch.models import gmm, plsa

    raw = np.loadtxt(dense_path, delimiter=",", dtype=np.float32)
    with open(text_path) as f:
        docs = [text.tokenize(line) for line in f if line.strip()]
    words, _, w2i = text.build_vocab(docs, max_size=ZOO_VOCAB)
    counts = text.doc_term_matrix(docs, w2i)
    gen = torch.Generator(device="cuda")
    inits = {"gmm": (gmm.init_from_data(gen.manual_seed(seed), 10, raw,
                                        device="cuda"), raw, gmm.em_step),
             "plsa": (plsa.init(gen.manual_seed(seed), counts.shape[0],
                                ZOO_TOPICS, counts.shape[1], device="cuda"),
                      counts, plsa.em_step)}
    out = {}
    for name, (p0, data, step) in inits.items():
        res = {}
        for role, dev in ZOO_ROLES:
            p = type(p0)(*(t.to(dev) for t in p0))
            res[role] = step(p, torch.from_numpy(data).to(dev))
        ll = [float(res[r][1]) for r in ("card", "cpu")]
        out[name] = {
            "init_loglik": ll[0],
            "loglik_max_abs_err": close_err(np, ll[0], ll[1],
                                            f"{name} loglik", **ZOO_STEP),
            "param_max_abs_err": max(
                close_err(np, a.cpu().numpy(), b.numpy(), f"{name} params",
                          **ZOO_FIT)
                for a, b in zip(res["card"][0], res["cpu"][0]))}
    return out


def zoo_word2vec(np, torch, corpus, seed) -> dict:
    """word2vec at embed's width (dim 100, the file's vocabulary): one
    epoch of negative sampling from one state run twice on the card
    (tables and accumulators bit-identical, the negatives' generator
    restored), and ZOO_CPU_STEPS steps of either mode on the card and on
    the CPU from one state (the CPU fed the card's negatives)."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import embedding

    vocab, counts, centers, contexts, mask = corpus
    cfg = TrainConfig(learning_rate=0.3, seed=seed)
    tr = embedding.Word2VecTrainer(vocab, 100, cfg, counts, device="cuda")
    start = (tuple(t.clone() for t in tr.params),
             tuple(t.clone() for t in tr.opt_state.accum),
             tr.generator.get_state())
    runs, secs = [], []
    for _ in range(2):
        tr.params = type(tr.params)(*(t.clone() for t in start[0]))
        tr.opt_state = type(tr.opt_state)(
            accum=type(tr.params)(*(t.clone() for t in start[1])))
        tr.generator.set_state(start[2])
        t = time.perf_counter()
        tr.fit(centers, contexts, mask, epochs=1, batch_size=ZOO_W2V_BATCH)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        runs.append(list(tr.params) + list(tr.opt_state.accum))
    for a, b in zip(*runs):
        if not torch.equal(a, b):
            raise AssertionError("zoo word2vec: one epoch from one state "
                                 "differs between two runs on the card")
    out = {"repeat_epoch": {"bit_identical": True, "seconds": secs,
                            "steps": len(centers) // ZOO_W2V_BATCH}}
    b = ZOO_W2V_BATCH
    for mode in ("negative", "hierarchical"):
        card = embedding.Word2VecTrainer(vocab, 100, cfg, counts, mode=mode,
                                         device="cuda")
        cpu = embedding.Word2VecTrainer(vocab, 100, cfg, counts, mode=mode,
                                        device="cpu")
        cpu.params = type(cpu.params)(*(t.cpu() for t in card.params))
        cpu.opt_state = cpu.tx.init(cpu.params)
        drawn = []
        if mode == "negative":
            real = card._negatives
            card._negatives = lambda rows: drawn.append(real(rows)) or \
                drawn[-1]
            cpu._negatives = lambda rows: drawn.pop(0).cpu()
        for i in range(ZOO_CPU_STEPS):
            sel = slice(i * b, (i + 1) * b)
            lc = card.step(*(torch.from_numpy(a[sel]).cuda()
                             for a in (centers, contexts, mask)))
            lp = cpu.step(*(torch.from_numpy(a[sel])
                            for a in (centers, contexts, mask)))
            close_err(np, float(lc), float(lp), f"word2vec {mode} loss",
                      **ZOO_W2V)
        out[mode] = {"table_max_abs_err": max(
            close_err(np, a.cpu().numpy(), c.numpy(),
                      f"word2vec {mode} tables", **ZOO_W2V)
            for a, c in zip(card.params, cpu.params))}
    return out


def phase_zoo(np, torch, sk, seed) -> dict:
    """The CLI's other eight subcommands in this process on the card (the
    DL zoo, GBM and its stack, the EM models, word2vec with its PQ and GMM
    hooks), each with counts reset just before: reports, the loss or
    log-likelihood moving the right way, train accuracy or AUC, launches
    against the plan; GBM's trees and word2vec's tables repeating bit for
    bit; each model's first steps re-run on the CPU."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.data import load_dense_csv, synth

    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        t = time.perf_counter()
        files = {"dense": synth.write_synthetic_dense_csv(
            os.path.join(root, "digits.csv"), ZOO_ROWS, ZOO_FEATURES,
            ZOO_CLASSES, seed=seed + 41),
            "text": write_topic_text(np, os.path.join(root, "topics.txt"),
                                     seed + 42)}
        write_s = time.perf_counter() - t
        ds = load_dense_csv(files["dense"])
        t = time.perf_counter()
        checks = {"cnn": zoo_classifier(np, torch, "cnn", ds, seed),
                  "rnn": zoo_classifier(np, torch, "rnn", ds, seed),
                  "vae": zoo_vae(np, torch, ds, seed),
                  "gbm": zoo_gbm(np, torch, ds, seed),
                  "em": zoo_em(np, torch, files["dense"], files["text"],
                               seed)}
        corpus = zoo_corpus(np, files["text"], seed)
        checks["word2vec"] = zoo_word2vec(np, torch, corpus, seed)
        checks_s = time.perf_counter() - t
        runs = {}
        launches = dict.fromkeys(sk.KERNELS, 0)
        for name, argv in ZOO_RUNS:
            argv = [files[a[1:-1]] if a.startswith("{") else a
                    for a in argv] + ["--seed", str(seed), "--device", "cuda"]
            rep, epochs, got, secs = cli_run(torch, sk, argv)
            want = zoo_expected_launches(sk, name, rep)
            if got != want:
                raise AssertionError(f"zoo {name}: launches {got}, planned "
                                     f"{want}")
            zoo_check_report(np, name, rep, epochs, checks)
            for k in launches:
                launches[k] += got[k]
            steps = zoo_steps(name, rep)
            runs[name] = {"argv": argv[:1] + argv[3:-4], "seconds": secs,
                          "steps": steps,
                          "ms_per_step": 1e3 * secs / steps if steps
                          else None,
                          "launches": got, "epoch_losses": epochs,
                          "report": rep}
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "zoo", "rows": ZOO_ROWS, "features": ZOO_FEATURES,
            "classes": ZOO_CLASSES, "text_lines": ZOO_LINES,
            "vocab": corpus[0], "cbow_pairs": int(len(corpus[2])),
            "files_write_s": write_s, "checks_s": checks_s,
            "checks": checks, "runs": runs, "launches": launches}


def zoo_check_report(np, name, rep, epochs, checks) -> None:
    """A run's report: finite, the loss (per epoch, or against the
    init's) moving the right way, and its quality bar."""
    def fail(msg):
        raise AssertionError(f"zoo {name}: {msg}: report {rep}, epochs "
                             f"{epochs}")

    final = rep.get("final_loss", rep.get("final_loglik"))
    if final is None or not np.isfinite(final):
        fail("no finite final loss")
    if name in ("cnn", "rnn"):
        if len(epochs) != ZOO_DL_EPOCHS or \
                not rep["train"]["loss"] < checks[name]["init_train"]["loss"]:
            fail("train loss not below the init's")
        if not rep["train"]["accuracy"] > ZOO_MIN_ACCURACY:
            fail("train accuracy at chance")
    elif name == "vae":
        if len(epochs) != ZOO_DL_EPOCHS or \
                not max(epochs) < checks["vae"]["init_loss"]:
            fail("epoch losses not below the init's")
    elif name in ("gbm", "gbm10", "stack"):
        if len(epochs) != ZOO_GBM_TREES or not epochs[-1] < epochs[0]:
            fail("boosting loss not falling")
        if name != "gbm10" and not rep["train"]["auc"] > ZOO_MIN_AUC:
            fail("train AUC too low")
        if name == "stack" and not rep["train"]["nonzero_weights"] > 0:
            fail("no LR weight")
    elif name in ("gmm", "plsa"):
        if not final > checks["em"][name]["init_loglik"]:
            fail("log-likelihood not above the init's")
        if name == "gmm" and sum(rep["cluster_sizes"]) != ZOO_ROWS:
            fail("cluster sizes")
        if name == "plsa" and len(rep["topics"]) != ZOO_TOPICS:
            fail("topics")
    elif name.startswith("embed"):
        if len(epochs) != ZOO_W2V_EPOCHS or not epochs[-1] < epochs[0]:
            fail("loss not falling")
        if name == "embed" and (rep["pq_codes_shape"][1] != 10 or
                                sum(rep["cluster_sizes"]) !=
                                rep["pq_codes_shape"][0]):
            fail("PQ codes or clusters")


# -- phase: algos -------------------------------------------------------------

ALGO_QUERIES = 256
ALGO_K = 10
#: float64 top-k rows are held where the k-th and (k+1)-th scores are
#: apart by more than this, relative to max(1, |score|): a float32 score
#: on the card or the CPU may swap two nearer neighbours
ALGO_TIE_GAP = 1e-4
ANN_ROWS = 1 << 16          # cut from 2^17: the host build's seconds
ANN_TREES, ANN_LEAF, ANN_BUDGET = 8, 32, 2048
ANN_QUERIES = 128
PCA_COMPONENTS = 16
PCA_GHA_EPOCHS = 100        # fit_gha's defaults
PCA_GHA_LR = 0.01
PCA_ALIGN = 0.95            # test_algos.py's criterion for the top row
ENS_MODELS, ENS_ROWS, ENS_CLASSES, ADA_ROUNDS = 5, 10000, 10, 10
ADA_ALPHA_ATOL = 2e-6
DAG_STEPS, DAG_BATCH, DAG_LR = 100, 4096, 0.5
ALGO_RTOL = 1e-5


def topk64(np, queries, corpus, k, metric):
    """float64 top-(k+1) scores and the top-k ids of every query, in
    chunks of 32 queries."""
    c64 = corpus.astype(np.float64)
    cn = (c64 * c64).sum(1)
    ids, vals = [], []
    for lo in range(0, len(queries), 32):
        q = queries[lo:lo + 32].astype(np.float64)
        s = q @ c64.T
        if metric == "l2":
            s = 2 * s - (q * q).sum(1)[:, None] - cn[None, :]
        part = np.argpartition(-s, k + 1, axis=1)[:, :k + 1]
        ps = np.take_along_axis(s, part, axis=1)
        order = np.argsort(-ps, axis=1)
        ids.append(np.take_along_axis(part, order, axis=1)[:, :k])
        vals.append(np.take_along_axis(ps, order, axis=1))
    return np.concatenate(ids), np.concatenate(vals)


def topk_agrees(np, got, ids64, vals64) -> int:
    """How many rows hold (the k-th and (k+1)-th float64 scores apart):
    each such row's ids must be the float64 top-k's set."""
    k = got.shape[1]
    held = 0
    for r in range(got.shape[0]):
        gap = vals64[r, k - 1] - vals64[r, k]
        if gap <= ALGO_TIE_GAP * max(1.0, abs(vals64[r, k - 1])):
            continue
        held += 1
        if set(got[r].tolist()) != set(ids64[r].tolist()):
            raise AssertionError(f"algos: top-{k} of query {r} is not the "
                                 "float64 top-k")
    if held < got.shape[0] // 2:
        raise AssertionError(f"algos: only {held} rows apart from ties")
    return held


def algos_topk(np, torch, ann, corpus, queries) -> dict:
    """brute_force_topk on the card and the CPU, dot and l2, held to the
    float64 top-k and to each other."""
    out = {}
    for metric in ("dot", "l2"):
        ids64, vals64 = topk64(np, queries, corpus, ALGO_K, metric)
        t = time.perf_counter()
        gi, gv = ann.brute_force_topk(queries, corpus, ALGO_K,
                                      metric=metric, device="cuda")
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        ci, cv = ann.brute_force_topk(queries, corpus, ALGO_K,
                                      metric=metric, device="cpu")
        cpu_s = time.perf_counter() - t
        held = topk_agrees(np, gi, ids64, vals64)
        topk_agrees(np, ci, ids64, vals64)
        err = float(np.abs(gv - vals64[:, :ALGO_K]).max())
        if not np.allclose(gv, cv, rtol=ALGO_RTOL, atol=1e-4):
            raise AssertionError(f"algos {metric}: card and CPU scores "
                                 "differ")
        out[metric] = {"rows_held": held, "max_abs_err_vs_f64": err,
                       "call_s_card": card_s, "call_s_cpu": cpu_s}
    return out


def algos_ann(np, torch, ann, corpus, queries) -> dict:
    """The RP forest on ANN_ROWS rows: built once (host), queried with its
    re-rank on the card and on the CPU; their top-10 equal up to ties of
    the float64 scores; recall@10 against the exact top-10."""
    rows = corpus[:ANN_ROWS]
    t = time.perf_counter()
    index = ann.ANNIndex(n_trees=ANN_TREES, leaf_size=ANN_LEAF, seed=0,
                         device="cuda").build(rows)
    build_s = time.perf_counter() - t
    exact, _ = topk64(np, queries, rows, ALGO_K, "dot")
    r64 = rows.astype(np.float64)
    recalls, differ = [], 0
    secs = {"cuda": 0.0, "cpu": 0.0}
    for qi, q in enumerate(queries):
        got = {}
        for dev in ("cuda", "cpu"):
            index.device = torch.device(dev)
            t = time.perf_counter()
            got[dev] = index.query(q, ALGO_K, search_budget=ANN_BUDGET)[0]
            secs[dev] += time.perf_counter() - t
        a, b = set(got["cuda"].tolist()), set(got["cpu"].tolist())
        if a != b:
            s = r64 @ q.astype(np.float64)
            kth = min(s[list(a)].min(), s[list(b)].min())
            for i in a ^ b:
                if abs(s[i] - kth) > ALGO_TIE_GAP * max(1.0, abs(kth)):
                    raise AssertionError(f"algos ann: query {qi} card "
                                         f"{sorted(a)} cpu {sorted(b)}")
            differ += 1
        recalls.append(len(a & set(exact[qi].tolist())) / ALGO_K)
    index.device = torch.device("cuda")
    return {"rows": ANN_ROWS, "trees": ANN_TREES, "leaf": ANN_LEAF,
            "budget": ANN_BUDGET, "queries": len(queries),
            "build_host_s": build_s,
            "recall_at_10": float(np.mean(recalls)),
            "queries_differing_by_ties": differ,
            "query_ms_card": 1e3 * secs["cuda"] / len(queries),
            "query_ms_cpu": 1e3 * secs["cpu"] / len(queries)}


def algos_pca(np, torch, pca, x) -> dict:
    """fit_svd and fit_gha (PCA_COMPONENTS rows) on the card and the CPU:
    the SVD rows whose singular values stand apart (relative gap > 1e-2)
    equal up to sign; GHA's top row aligned with SVD's (|cos| >
    PCA_ALIGN) on both, from one init."""
    xc = (x - x.mean(axis=0, keepdims=True)).astype(np.float64)
    sv = np.linalg.svd(xc, compute_uv=False)[:PCA_COMPONENTS + 1]
    out = {}
    t = time.perf_counter()
    card = pca.fit_svd(x, PCA_COMPONENTS, device="cuda").cpu().numpy()
    out["svd_card_s"] = time.perf_counter() - t
    cpu = pca.fit_svd(x, PCA_COMPONENTS, device="cpu").numpy()
    apart = [i for i in range(PCA_COMPONENTS)
             if (sv[i] - sv[i + 1]) / sv[i] > 1e-2
             and (i == 0 or (sv[i - 1] - sv[i]) / sv[i - 1] > 1e-2)]
    cos = [abs(float(card[i] @ cpu[i])) for i in apart]
    if not apart or min(cos) < 1 - 1e-4:
        raise AssertionError(f"algos pca: SVD rows card vs CPU {cos}")
    out.update(svd_rows_held=len(apart), svd_min_cos=min(cos))
    gha = {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(0)
        t = time.perf_counter()
        w = pca.fit_gha(gen, x, PCA_COMPONENTS, epochs=PCA_GHA_EPOCHS,
                        lr=PCA_GHA_LR, device=dev).cpu().numpy()
        gha[dev] = (w, time.perf_counter() - t)
        align = abs(float(w[0] @ cpu[0]))
        if align <= PCA_ALIGN:
            raise AssertionError(f"algos pca: GHA on {dev} aligned {align}")
        out[f"gha_align_{dev}"] = align
        out[f"gha_s_{dev}"] = gha[dev][1]
    out["gha_card_vs_cpu_top_cos"] = abs(float(gha["cuda"][0][0]
                                               @ gha["cpu"][0][0]))
    out["singular_values"] = sv[:PCA_COMPONENTS].tolist()
    return out


def adaboost64(np, preds, true, rounds):
    """ADA_ROUNDS AdaBoost rounds in float64 numpy: (alphas, weights)."""
    w = np.full(len(true), 1.0 / len(true))
    alphas, ws = [], []
    for r in range(rounds):
        wrong = (preds[r % len(preds)] != true).astype(np.float64)
        err = np.clip((w * wrong).sum() / w.sum(), 1e-7, 1 - 1e-7)
        a = 0.5 * np.log((1 - err) / err)
        w = w * np.where(wrong == 1, np.exp(a), np.exp(-a))
        w /= w.sum()
        alphas.append(a)
        ws.append(w.copy())
    return np.asarray(alphas), ws


def algos_ensembling(np, torch, ens, seed) -> dict:
    """vote_hard and vote_soft over ENS_MODELS models' predictions, and
    ADA_ROUNDS AdaBoost rounds, on the card and the CPU: votes equal;
    each device's alphas within ADA_ALPHA_ATOL and sample weights within
    rtol 1e-5 of a float64 run (an alpha near 0, where a model's weighted
    error nears 0.5, has no relative bound: float32 sums of 10,000
    weights part in the 7th digit)."""
    rng = np.random.default_rng(seed + 81)
    true = rng.integers(0, ENS_CLASSES, ENS_ROWS)
    probs = rng.random((ENS_MODELS, ENS_ROWS, ENS_CLASSES)).astype(
        np.float32)
    probs[:, np.arange(ENS_ROWS), true] += 0.5
    preds = probs.argmax(-1)
    weights = rng.random(ENS_MODELS).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        pr = torch.from_numpy(preds).to(dev)
        pb = torch.from_numpy(probs).to(dev)
        tl = torch.from_numpy(true).to(dev)
        w = torch.full((ENS_ROWS,), 1.0 / ENS_ROWS, device=dev)
        alphas, ws = [], []
        for r in range(ADA_ROUNDS):
            w, a = ens.adaboost_step(w, pr[r % ENS_MODELS], tl)
            alphas.append(float(a))
            ws.append(w.cpu().numpy())
        res[dev] = {"hard": ens.vote_hard(pr, ENS_CLASSES).cpu().numpy(),
                    "soft": ens.vote_soft(pb).cpu().numpy(),
                    "soft_w": ens.vote_soft(
                        pb, torch.from_numpy(weights).to(dev)).cpu().numpy(),
                    "alphas": alphas, "w": ws}
    for k in ("hard", "soft", "soft_w"):
        if not np.array_equal(res["cuda"][k], res["cpu"][k]):
            raise AssertionError(f"algos ensembling: {k} votes differ")
    a64, w64 = adaboost64(np, preds, true, ADA_ROUNDS)
    errs = {}
    for dev, r in res.items():
        ea = float(np.abs(np.asarray(r["alphas"]) - a64).max())
        ew = max(float((np.abs(w - v) / v).max()) for w, v in zip(r["w"],
                                                                 w64))
        if ea > ADA_ALPHA_ATOL or ew > ALGO_RTOL:
            raise AssertionError(f"algos ensembling: AdaBoost on {dev} "
                                 f"alpha err {ea}, weight rel err {ew}")
        errs[dev] = {"alpha_abs_err_vs_f64": ea, "weight_rel_err_vs_f64": ew}
    return {"models": ENS_MODELS, "rows": ENS_ROWS,
            "classes": ENS_CLASSES, "rounds": ADA_ROUNDS,
            "hard_accuracy": float((res["cuda"]["hard"] == true).mean()),
            "soft_accuracy": float((res["cuda"]["soft"] == true).mean()),
            "alphas": res["cuda"]["alphas"], "adaboost_vs_f64": errs}


def algos_dag(np, torch, graph, optim, seed) -> dict:
    """The DAG builder's demo (sigma(w.x + b), logistic loss, SGD) for
    DAG_STEPS steps at DAG_BATCH on the card and the CPU: the loss falls,
    the two within rtol 1e-5."""
    rng = np.random.default_rng(seed + 82)
    x = rng.normal(size=(DAG_BATCH, 4)).astype(np.float32)
    w_true = rng.normal(size=4)
    y = (rng.random(DAG_BATCH) < 1 / (1 + np.exp(-x @ w_true))).astype(
        np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        g = graph.Graph(device=dev)
        xi = g.add_node(graph.source("x"))
        w = g.add_node(graph.trainable("w", torch.zeros(4)))
        b = g.add_node(graph.trainable("b", torch.zeros(())))
        z = g.add_node(graph.add(g.add_node(graph.matmul(xi, w)), b))
        p = g.add_node(graph.activation(z, "sigmoid"))
        loss = g.add_node(graph.logistic_loss_node(p, label_name="y"))
        step, st = g.compile_train_step(loss, optim.sgd(DAG_LR))
        params = g.init_params()
        feeds = {"x": torch.from_numpy(x).to(dev),
                 "y": torch.from_numpy(y).to(dev)}
        t = time.perf_counter()
        losses = []
        for _ in range(DAG_STEPS):
            params, st, lv = step(params, st, feeds)
            losses.append(lv)
        losses = [float(v) for v in losses]
        runs[dev] = (losses, time.perf_counter() - t)
    lc, lp = runs["cuda"][0], runs["cpu"][0]
    if not lc[-1] < lc[0] or not np.allclose(lc, lp, rtol=ALGO_RTOL):
        raise AssertionError(f"algos dag: card {lc[-3:]} cpu {lp[-3:]}")
    return {"steps": DAG_STEPS, "batch": DAG_BATCH, "loss_first": lc[0],
            "loss_last": lc[-1],
            "max_rel_err_vs_cpu": max(abs(a - b) / abs(b)
                                      for a, b in zip(lc, lp)),
            "step_ms_card": 1e3 * runs["cuda"][1] / DAG_STEPS,
            "step_ms_cpu": 1e3 * runs["cpu"][1] / DAG_STEPS}


def phase_algos(np, torch, sk, seed) -> dict:
    """The zoo's last four modules on the card, each held to the same call
    on the CPU: ``brute_force_topk`` at the serve table's 2^20 x 32 and
    ``ANNIndex`` on 2^16 of its rows, PCA on the zoo's 10,000 x 784 file,
    voting and AdaBoost, and the DAG builder's demo.  None of them runs a
    kernel of the port: the launch counts stay 0."""
    import shutil
    import tempfile

    from lightctr_tpu_torch import graph, optim
    from lightctr_tpu_torch.data import load_dense_csv, synth
    from lightctr_tpu_torch.models import ann
    from lightctr_tpu_torch.ops import ensembling, pca

    corpus = make_params(np, seed)["v"]
    queries = np.random.default_rng(seed + 80).normal(
        size=(ALGO_QUERIES, DIM)).astype(np.float32)
    root = tempfile.mkdtemp(prefix="chip_smoke_algos_")
    try:
        x = load_dense_csv(synth.write_synthetic_dense_csv(
            os.path.join(root, "digits.csv"), ZOO_ROWS, ZOO_FEATURES,
            ZOO_CLASSES, seed=seed + 41)).features
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sk.reset_launches()
    out = {"phase": "algos", "corpus": list(corpus.shape),
           "queries": ALGO_QUERIES, "k": ALGO_K,
           "brute_force_topk": algos_topk(np, torch, ann, corpus, queries),
           "ann": algos_ann(np, torch, ann, corpus,
                            queries[:ANN_QUERIES]),
           "pca": dict(algos_pca(np, torch, pca, x), rows=x.shape[0],
                       features=x.shape[1], components=PCA_COMPONENTS),
           "ensembling": algos_ensembling(np, torch, ensembling, seed),
           "dag": algos_dag(np, torch, graph, optim, seed)}
    out["launches"] = sk.launches()
    if any(out["launches"].values()):
        raise AssertionError(f"algos: kernels launched {out['launches']}")
    return out


# -- phase: attention ---------------------------------------------------------


def ring_rank(rank, world, out_dir, seed):
    """One rank of the attention phase: ``ring_self_attention`` over a
    ``seq`` mesh of the world on this rank's card, on the phase's inputs;
    writes its output, its step time and (rank 0) a profile of two more
    calls to ``out_dir``."""
    import torch

    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.nn.ring_attention import ring_self_attention

    mesh = make_mesh(MeshSpec(seq=world), device="cuda")
    torch.cuda.set_device(mesh.device)
    q, k, v = flash_inputs(torch, FLASH_PATH_SHAPE, torch.bfloat16, seed)
    out = ring_self_attention(mesh, q, k, v, causal=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        ring_self_attention(mesh, q, k, v, causal=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_ms = 1e3 * statistics.median(times)
    calls = [lambda: ring_self_attention(mesh, q, k, v, causal=True)] * 2
    prof = None
    if rank == 0:
        prof = profile_calls(torch, calls)
        prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / step_ms
    else:
        for call in calls:
            call()
        torch.cuda.synchronize()
    # the backward: the gradients of sum(out ** 2) in q, k and v
    leaves = [x.requires_grad_(True) for x in flash_inputs(
        torch, RING_GRAD_SHAPE, torch.float32, seed + 1)]
    (ring_self_attention(mesh, *leaves, causal=True) ** 2).sum().backward()
    torch.cuda.synchronize()
    torch.save({"out": out.cpu(), "axis": mesh.axis, "device":
                str(mesh.device), "backend": mesh.backend,
                "step_ms": step_ms, "profile": prof,
                "grads": [x.grad.cpu() for x in leaves]},
               os.path.join(out_dir, f"ring{rank}.pt"))


def phase_attention(torch, sk, fl, seed) -> dict:
    """The long-context path: flash attention on the card, then ring
    attention over RING_WORLD ranks sharing it (gloo), on one input."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world

    q, k, v = flash_inputs(torch, FLASH_PATH_SHAPE, torch.bfloat16, seed)
    sk.reset_launches()
    flash = fl.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = sk.launches()
    route = sk.variant_launches("flash_attention")
    if launches["flash_attention"] < 1:
        raise AssertionError(f"attention: flash_attention launched "
                             f"{launches['flash_attention']} times")
    if route != {"wgmma": launches["flash_attention"]}:
        raise AssertionError(f"attention: the path's bf16 call ran {route}, "
                             "not the wgmma design")
    # the kernel has no backward: inputs that require grad are refused
    try:
        fl.flash_attention(q.clone().requires_grad_(True), k, v, causal=True)
        raise AssertionError("attention: flash_attention took bf16 inputs "
                             "that require grad")
    except RuntimeError as e:
        if "full_attention" not in str(e):
            raise
        grad_refusal = str(e)
    root = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    try:
        t = time.perf_counter()
        spawn_world(ring_rank, RING_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(root, seed))
        ring_s = time.perf_counter() - t
        recs = [torch.load(os.path.join(root, f"ring{r}.pt"))
                for r in range(RING_WORLD)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r, rec in enumerate(recs):
        if not torch.equal(rec["out"], recs[0]["out"]):
            raise AssertionError(f"attention: ring rank {r}'s output differs "
                                 "from rank 0's")
        if rec["axis"] != "seq" or not rec["device"].startswith("cuda"):
            raise AssertionError(f"attention: ring rank {r}: {rec}")
    ring = recs[0]["out"].cuda()
    if ring.dtype != flash.dtype or ring.shape != flash.shape:
        raise AssertionError(f"attention: ring {ring.dtype} "
                             f"{tuple(ring.shape)} vs flash {flash.dtype} "
                             f"{tuple(flash.shape)}")
    err = (ring.float() - flash.float()).abs()
    emax, emean = float(err.max()), float(err.mean())
    if emax > FLASH_16_MAX or emean > FLASH_16_MEAN:
        raise AssertionError(f"attention: ring vs flash max {emax}, mean "
                             f"{emean}")
    # the ring's gradients on every rank against full attention's autograd
    from lightctr_tpu_torch.nn.ring_attention import full_attention
    leaves = [x.requires_grad_(True) for x in flash_inputs(
        torch, RING_GRAD_SHAPE, torch.float32, seed + 1)]
    (full_attention(*leaves, causal=True) ** 2).sum().backward()
    grad_err = 0.0
    for r, rec in enumerate(recs):
        for name, got, want in zip("qkv", rec["grads"], leaves):
            want = want.grad.cpu()
            if not torch.allclose(got, want, rtol=RING_GRAD_RTOL,
                                  atol=RING_GRAD_ATOL):
                raise AssertionError(
                    f"attention: ring rank {r}'s d{name} vs full attention: "
                    f"max {float((got - want).abs().max())}")
            grad_err = max(grad_err, float((got - want).abs().max()))
    return {"phase": "attention", "shape": list(FLASH_PATH_SHAPE),
            "dtype": "bfloat16", "causal": True, "launches": launches,
            "flash_route": route,
            "ring": {"world": RING_WORLD, "backend": recs[0]["backend"],
                     "devices": [rec["device"] for rec in recs],
                     "step_ms_rank0": recs[0]["step_ms"],
                     "profile_rank0": recs[0]["profile"],
                     "world_seconds": ring_s},
            "ring_vs_flash": {"max_abs_err": emax, "mean_abs_err": emean,
                              "tolerance": [FLASH_16_MAX, FLASH_16_MEAN]},
            "ring_grads_vs_full_attention": {
                "shape": list(RING_GRAD_SHAPE), "dtype": "float32",
                "causal": True, "max_abs_err": grad_err,
                "tolerance": [RING_GRAD_RTOL, RING_GRAD_ATOL]},
            "flash_grad_refusal": grad_refusal,
            "ranks_equal": True}


# -- phase: bench -------------------------------------------------------------


def phase_bench(torch, sk) -> dict:
    """The port's two kernel benches, on the card, writing no file: every
    cell's kernel launched, as its launch count says."""
    from lightctr_tpu_torch.tools import kernel_bench, sparse_kernel_bench

    sk.reset_launches()
    sparse = sparse_kernel_bench.run(device="cuda", out=None)
    kern = kernel_bench.run(device="cuda", out=None)
    launches = sk.launches()
    cells = sparse["cells"] + kern["adagrad"] + kern["flash"]
    for c in cells:
        name = c["kernel"]
        if c.get("impl_kernel", c.get("impl")) != "cuda" or \
                launches[name] < 1:
            raise AssertionError(f"bench: {name} did not launch ({c})")
    merge_variants = sk.variant_launches("merge_apply")
    if merge_variants.get("merge", 0) < 1:
        raise AssertionError(f"bench: merge_apply's cell ran {merge_variants}"
                             ", not its fused merge mode")
    # both pack cells code at 8 bits: every launch the tree design
    pack_variants = {n: sk.variant_launches(n)
                     for n in ("quantize_pack", "quantize_pack_ef")}
    for n, ran in pack_variants.items():
        if ran != {"tree": launches[n]}:
            raise AssertionError(f"bench: {n} ran {ran}, not its tree "
                                 "design")
    return {"phase": "bench", "launches": launches,
            "merge_apply_variants": merge_variants,
            "pack_variants": pack_variants,
            "sparse_kernel_bench": sparse, "kernel_bench": kern}


# -- phase: timing ------------------------------------------------------------


def graph_ms(torch, fn, reps: int = 100, repeats: int = 7) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph (so host launch overhead does not hide the device time),
    replayed ``repeats`` times between CUDA events; median per call."""
    return statistics.median(graph_times(torch, fn, reps, repeats))


def graph_times(torch, fn, reps: int = 100, repeats: int = 7) -> list:
    """``graph_ms``'s per-call time of each of the ``repeats`` replays."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return per


#: bytes a cold timing reads between two calls: four times the H100's
#: 50 MB L2, so none of the last call's lines are left in it
L2_FLUSH_BYTES = 4 * 50 * (1 << 20)


def cold_ms(torch, fn, reps: int = 20, repeats: int = 7) -> float:
    """Device time of one ``fn()`` call on a cold L2.  ``graph_ms`` replays
    a call on the lines its last call left in the 50 MB L2, which holds a
    working set of up to that size; here each call follows a read of
    ``L2_FLUSH_BYTES``.  One CUDA graph holds ``reps`` (read, call) pairs,
    another the ``reps`` reads alone; both are replayed in turn
    ``repeats`` times between CUDA events, and the median difference per
    call is the call's time."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            flush.sum()
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graphs = []
    for with_call in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.sum()
                if with_call:
                    fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()

    def replay_ms(g):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    per = [(replay_ms(graphs[0]) - replay_ms(graphs[1])) / reps
           for _ in range(repeats)]
    return statistics.median(per)


def call_ms(torch, fn, reps: int = 200, warmup: int = 10) -> float:
    """Time of one eager call, host included: ``reps`` calls back to
    back between CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def plain_once_ms(torch, fn) -> float:
    """One eager call of a plain version between CUDA events, host
    included, without a warm-up: ``plain_ms`` is reported beside the
    kernel's time and held against nothing, so one call does (the
    slowest plain versions take seconds a call)."""
    return call_ms(torch, fn, reps=1, warmup=0)


def kernel_row(sk, name, **fields) -> dict:
    kd = sk.KERNELS[name]
    return {"name": name, "route": "cuda",
            "source": os.path.join("lightctr_tpu_torch", "csrc", kd.source),
            "replaces": kd.replaces, **fields}


def bound_ms(nbytes) -> float:
    return 1e3 * nbytes / HBM_BYTES_PER_S


def bound_ms_ops(nbytes, flops):
    """(bound in ms, what bounds it): the larger of the bytes at 3.35 TB/s
    and the bf16 FLOPs at 989 TFLOP/s."""
    by_bytes, by_ops = bound_ms(nbytes), 1e3 * flops / BF16_FLOPS_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                               "bytes")


def gather_shape(torch, rows, d, n, seed):
    """A [rows, d] block and n uniform int32 indices into it, and the
    bytes one gather of them needs: the distinct rows it reads, the
    indices, the rows it writes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    block = torch.randn((rows, d), generator=gen, device="cuda")
    idx = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    n_read = int(torch.unique(idx).numel())
    return block, idx, n_read * d * 4 + n * 4 + n * d * 4


def gather_floor_ms(torch, sk, block, idx) -> float:
    """The gather's floor: an empty kernel at its launch shape, timed as
    ``graph_ms`` times the kernel (no launch counted)."""
    out = torch.empty((idx.numel(),) + tuple(block.shape[1:]), device="cuda")
    return graph_ms(torch, lambda: sk.gather_rows_floor(block, idx, out))


def gather_timing(torch, sk, serve_ns, launches, max_abs_err):
    """gather_rows at the serve shape (the cache's 65,536 rows of 33, n
    its largest padded micro-batch) and the hot-row shape, warm and cold,
    beside the plain version and ``torch.index_select``; returns the
    kernels row and the empty kernel's floor at both shapes."""
    per_shape, floor = [], {}
    for what, rows, d, n, seed in (("serve", CACHE_ROWS, ROW_DIM,
                                    max(serve_ns), 99),
                                   ("hot_row", HOT_ROWS, DIM, HOT_N, 98)):
        block, idx, nbytes = gather_shape(torch, rows, d, n, seed)
        if not torch.equal(sk.gather_rows(block, idx),
                           sk.gather_rows_plain(block, idx)):
            raise AssertionError(f"gather_rows kernel != plain at the "
                                 f"{what} shape")
        floor[what] = gather_floor_ms(torch, sk, block, idx)
        per_shape.append({
            "shape": what, "rows": rows, "d": d, "n": n,
            "ms": graph_ms(torch, lambda: sk.gather_rows(block, idx)),
            "cold_ms": cold_ms(torch, lambda: sk.gather_rows(block, idx)),
            "plain_ms": graph_ms(torch,
                                 lambda: sk.gather_rows_plain(block, idx)),
            "library_ms": graph_ms(torch,
                                   lambda: block.index_select(0, idx)),
            "library_cold_ms": cold_ms(torch,
                                       lambda: block.index_select(0, idx)),
            "call_ms": call_ms(torch, lambda: sk.gather_rows(block, idx)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes,
            "floor_ms": floor[what]})
        del block, idx
    serve = per_shape[0]
    row = kernel_row(
        sk, "gather_rows", launches=launches["gather_rows"],
        max_abs_err=max_abs_err,
        shape={"rows": CACHE_ROWS, "d": ROW_DIM, "n": serve["n"]},
        ms=serve["ms"], kernel_ms=serve["ms"], cold_ms=serve["cold_ms"],
        plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
        bound_by="bytes", library_ms=serve["library_ms"],
        library_call="torch.index_select", call_ms=serve["call_ms"],
        bytes=serve["bytes"], per_shape=per_shape)
    return row, {"phase": "gather_floor",
                 "empty_kernel_ms_at_launch_shape": floor}


def train_timing(np, torch, sk, fa, seed, launches, kern) -> list:
    """dedup_ids, merge_apply and fused_adagrad at the train path's shapes:
    one batch's K = 159,744 ids, its uids against the 2^20-row tables, and
    the flat w (2^20) and v (2^25) leaves."""
    rng = np.random.default_rng(seed + 5)
    ids = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)) \
        .cuda()
    k = ids.numel()
    uids, _, count = sk.dedup_ids(ids)
    real = int(count)  # non-pad slots: the distinct ids, id 0 included
    gen = torch.Generator(device="cuda").manual_seed(5)

    def unique_call():
        return torch.unique(ids, sorted=True, return_inverse=True)

    dedup_ms = graph_ms(torch, lambda: sk.dedup_ids(ids))
    rows = [kernel_row(
        sk, "dedup_ids", launches=launches["dedup_ids"],
        max_abs_err=kern["dedup_ids"]["max_abs_err"],
        shape={"k": k, "size": k, "distinct": int(count)},
        ms=dedup_ms, kernel_ms=dedup_ms,
        plain_ms=call_ms(torch, lambda: sk.dedup_ids_plain(ids, k), reps=50),
        plain_timing="eager between events: torch.unique syncs to size its "
                     "output, so it cannot be graph-captured",
        bound_ms=bound_ms(12 * k), bound_by="bytes",
        bound_note="12*K bytes (ids read, inv and uids written): a lower "
                   "bound that no sort reaches",
        library_ms=call_ms(torch, unique_call, reps=50),
        library_call="torch.unique(sorted=True, return_inverse=True), "
                     "eager between events (it syncs)",
        call_ms=call_ms(torch, lambda: sk.dedup_ids(ids)),
        bytes=12 * k)]

    per_shape = []
    for d in (1, DIM):
        shape = (VOCAB,) if d == 1 else (VOCAB, d)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        grads = torch.randn((k,) + shape[1:], generator=gen, device="cuda")
        # touched rows' w and a read and written, their gradient rows and
        # all S uids read; a pad slot (uid 0 past slot 0) reads its uid and
        # skips its gradient row
        nbytes = real * d * 4 * 4 + real * d * 4 + k * 4
        per_shape.append({
            "d": d, "vocab": VOCAB, "s": k, "s_real": real,
            "ms": graph_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "cold_ms": cold_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "plain_ms": call_ms(torch, lambda: sk.merge_apply_plain(
                table, accum, uids, grads, None, LR, EPS, 1.0), reps=50),
            "call_ms": call_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    big = per_shape[-1]
    rows.append(kernel_row(
        sk, "merge_apply", launches=launches["merge_apply"],
        max_abs_err=kern["merge_apply"]["max_abs_err"],
        max_ulp=kern["merge_apply"]["max_ulp"],
        shape={"vocab": VOCAB, "d": DIM, "s": k, "s_real": real},
        ms=big["ms"], kernel_ms=big["ms"], cold_ms=big["cold_ms"],
        plain_ms=big["plain_ms"],
        plain_timing="eager between events: its dedup_grads runs "
                     "torch.unique, which syncs",
        bound_ms=big["bound_ms"], bound_by="bytes", library_ms=None,
        library_note="no single PyTorch call computes a touched-row "
                     "scatter Adagrad apply",
        call_ms=big["call_ms"], bytes=big["bytes"], per_shape=per_shape))

    per_shape = []
    for n in (VOCAB, VOCAB * DIM):
        w = torch.randn(n, generator=gen, device="cuda")
        a = torch.rand(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda")
        per_shape.append({
            "n": n,
            "ms": graph_ms(torch, lambda: fa.fused_adagrad_update(
                w, a, g, LR, EPS)),
            "plain_ms": graph_ms(torch, lambda: fa.fused_adagrad_plain(
                w, a, g, LR, EPS)),
            "call_ms": call_ms(torch, lambda: fa.fused_adagrad_update(
                w, a, g, LR, EPS)),
            "bound_ms": bound_ms(5 * n * 4), "bytes": 5 * n * 4})
    big = per_shape[-1]
    rows.append(kernel_row(
        sk, "fused_adagrad", launches=launches["fused_adagrad"],
        max_abs_err=kern["fused_adagrad"]["max_abs_err"],
        max_ulp=kern["fused_adagrad"]["max_ulp"],
        shape={"n": VOCAB * DIM},
        ms=big["ms"], kernel_ms=big["ms"], plain_ms=big["plain_ms"],
        bound_ms=big["bound_ms"], bound_by="bytes", library_ms=None,
        library_note="no single PyTorch call computes Adagrad with eps "
                     "inside the sqrt (torch.optim.Adagrad adds it outside)",
        call_ms=big["call_ms"], bytes=big["bytes"], per_shape=per_shape))
    return rows


def dp_timing(np, torch, sk, qz, seed, launches, kern):
    """merge_rows, merge_apply's merge mode, quantize_pack and
    quantize_pack_ef_update at the dp path's shapes (one rank's K = 79,872
    ids and [K, 32] payload, the W*K = 159,744 gathered rows, V = 2^20
    tables), and dedup_ids on the int64 form of one train batch's ids.
    Returns the new kernels' rows and the extra fields of the dedup_ids and
    merge_apply rows."""
    rng = np.random.default_rng(seed + 6)
    all_ids, uniq, inv, real, pad, per_rank = gathered_stream(
        np, torch, sk, rng)
    uids_l, _, count_l = per_rank[0]
    m, k = all_ids.numel(), uids_l.numel()
    gen = torch.Generator(device="cuda").manual_seed(31)
    # each rank's dedup padding (id 0 past its slot 0) carries zero rows in
    # the exact exchange, CODED_PAD in the coded ones
    rows = torch.randn((m, DIM), generator=gen, device="cuda") * 0.05 \
        * (1 - pad)
    rows_coded = rows + CODED_PAD * pad
    out = []

    # merge_rows and merge_apply's merge mode: the gathered rows merged
    # onto the union's slots, at d = 32 (the v table) and d = 1 (w); the
    # dp path launches each width once a step
    per_d, merge_mode = [], []
    for d in (DIM, 1):
        rows_d = rows if d == DIM else rows[:, 0].contiguous()
        flat = rows_d.reshape(m, d)
        nbytes = m * d * 4 + m * 4 + m * d * 4
        per_d.append({
            "d": d, "m": m, "nseg": m, "distinct": real,
            "ms": graph_ms(torch, lambda: sk.merge_rows(flat, inv, m)),
            "plain_ms": call_ms(torch, lambda: sk.merge_rows_plain(
                flat, inv, m), reps=3),
            "library_ms": graph_ms(torch, lambda: torch.zeros(
                (m, d), device="cuda").index_add_(0, inv, flat)),
            "call_ms": call_ms(torch, lambda: sk.merge_rows(flat, inv, m)),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "bytes": nbytes, "launches": launches["merge_rows"],
            "profile": launch_profile(
                torch, lambda: sk.merge_rows(flat, inv, m))})
        shape = (VOCAB, d) if d > 1 else (VOCAB,)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        nbytes = (m * d * 4 + m * 4 + m * 4
                  + real * d * 4 * 4)
        # the exact exchange's zero padding rows, dropped by the key pass,
        # and the coded exchanges' CODED_PAD ones, one long run
        for pads, src in (("zero", rows), ("coded", rows_coded)):
            rows_d = src if d == DIM else src[:, 0].contiguous()
            merge_mode.append({
                "d": d, "pads": pads, "m": m, "s": m, "s_real": real,
                "ms": graph_ms(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "plain_ms": plain_once_ms(torch, lambda:
                                          sk.merge_apply_plain(
                                              table, accum, uniq, rows_d,
                                              inv, LR, EPS,
                                              float(DP_WORLD))),
                "call_ms": call_ms(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                "bytes": nbytes, "library_ms": None,
                "library_note": "no single PyTorch call merges and applies "
                                "a touched-row Adagrad",
                "profile": launch_profile(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "max_ulp": kern["merge_apply_merge_mode"]["max_ulp"],
                "max_abs_err":
                    kern["merge_apply_merge_mode"]["max_abs_err"]})
        del table, accum
    head = per_d[0]
    out.append(kernel_row(
        sk, "merge_rows", launches=launches["merge_rows"],
        launches_note="dp phase, rank 0 over its three runs (the "
                      "gather's backward, w and v a step)",
        max_abs_err=kern["merge_rows"]["max_abs_err"],
        shape={"m": m, "d": DIM, "nseg": m, "distinct": real},
        ms=head["ms"], plain_ms=head["plain_ms"],
        plain_timing="eager between events: its rounds sync to count them",
        library_ms=head["library_ms"],
        library_call="torch.zeros(...).index_add_ (atomics: a sum order "
                     "that is not the slot order)",
        bound_ms=head["bound_ms"], bound_by="bytes", bytes=head["bytes"],
        call_ms=head["call_ms"], per_shape=per_d))
    # quantize_pack: one rank's [K, 32] payload, 8 bits normal (the
    # default table), a measured range; 16 bits uniform beside it
    x = torch.randn((k, DIM), generator=gen, device="cuda") * 0.05
    per_shape = []
    for bits, mode in ((8, "normal"), (16, "uniform")):
        lim = 1.05 * x.abs().max()
        table_q = qz.build_table(-lim, lim, bits=bits, mode=mode)
        nbytes = x.numel() * (4 + (1 if bits <= 8 else 2))
        per_shape.append({
            "bits": bits, "mode": mode, "n": x.numel(),
            "design": sk.search_design(bits),
            "ms": graph_ms(torch, lambda: sk.quantize_pack(table_q, x)),
            "cold_ms": cold_ms(torch, lambda: sk.quantize_pack(table_q, x)),
            "plain_ms": graph_ms(torch,
                                 lambda: sk.quantize_pack_plain(table_q, x)),
            "library_ms": graph_ms(torch, lambda: torch.searchsorted(
                table_q.boundaries, x)),
            "call_ms": call_ms(torch, lambda: sk.quantize_pack(table_q, x)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    head = per_shape[0]
    out.append(kernel_row(
        sk, "quantize_pack", launches=launches["quantize_pack"],
        max_abs_err=kern["quantize_pack"]["max_abs_err"],
        shape={"n": x.numel(), "bits": 8, "mode": "normal"},
        design=head["design"], ms=head["ms"], cold_ms=head["cold_ms"],
        plain_ms=head["plain_ms"],
        library_ms=head["library_ms"],
        library_call="torch.searchsorted (int64 indices, no cast)",
        bound_ms=head["bound_ms"], bound_by="bytes", bytes=head["bytes"],
        call_ms=head["call_ms"], per_shape=per_shape))

    # quantize_pack_ef_update: one rank's deduped uids into a [V, 32]
    # carry (the v table's) and a [V] one (w's), fixed range 1.0: 8 bits
    # normal (the dp path's), then 16 bits uniform (no path runs it)
    mask = (~((uids_l == 0) & (torch.arange(k, device="cuda") > 0))) \
        .to(torch.float32).reshape(-1, 1)
    real_l = int(count_l)
    per_shape = []
    for bits, mode in ((8, "normal"), (16, "uniform")):
        table_q = qz.build_table(-1.0, 1.0, bits=bits, mode=mode,
                                 device="cuda")
        for d in (1, DIM):
            shape = (VOCAB,) if d == 1 else (VOCAB, d)
            residual = torch.zeros(shape, device="cuda")
            mask_d = mask.reshape(-1) if d == 1 else mask
            g = torch.randn((k,) + shape[1:], generator=gen,
                            device="cuda") * mask_d
            # rows and uid/mask read, the real slots' carries read and
            # written, codes and dec written
            nbytes = (k * d * 4 + real_l * d * 4 + k * 8
                      + k * d * (bits // 8 + 4) + real_l * d * 4)
            per_shape.append({
                "d": d, "s": k, "s_real": real_l, "vocab": VOCAB,
                "bits": bits, "design": sk.search_design(bits),
                "ms": graph_ms(torch, lambda: sk.quantize_pack_ef_update(
                    table_q, g, uids_l, residual, mask_d)),
                "cold_ms": cold_ms(
                    torch, lambda: sk.quantize_pack_ef_update(
                        table_q, g, uids_l, residual, mask_d)),
                "plain_ms": call_ms(
                    torch, lambda: sk.quantize_pack_ef_update_plain(
                        table_q, g, uids_l, residual, mask_d), reps=20),
                "call_ms": call_ms(
                    torch, lambda: sk.quantize_pack_ef_update(
                        table_q, g, uids_l, residual, mask_d)),
                "bound_ms": bound_ms(nbytes), "bytes": nbytes})
            del residual, g
    big = per_shape[1]
    out.append(kernel_row(
        sk, "quantize_pack_ef_update",
        launches=launches["quantize_pack_ef_update"],
        max_abs_err=kern["quantize_pack_ef_update"]["max_abs_err"],
        shape={"s": k, "s_real": real_l, "d": DIM, "vocab": VOCAB,
               "bits": 8},
        ms=big["ms"], cold_ms=big["cold_ms"], plain_ms=big["plain_ms"],
        plain_timing="eager between events: its scatter selects the "
                     "in-table slots, which syncs",
        library_ms=None,
        library_note="no single PyTorch call computes an EF-compensated "
                     "quantile encode with the carry scattered back",
        bound_ms=big["bound_ms"], bound_by="bytes", bytes=big["bytes"],
        call_ms=big["call_ms"], per_shape=per_shape))

    # dedup_ids on int64 ids: one train batch's Criteo ids, widened
    ids64 = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)
                             .astype(np.int64)).cuda()
    dedup64 = {"k": ids64.numel(),
               "ms": graph_ms(torch, lambda: sk.dedup_ids(ids64)),
               "library_ms": call_ms(torch, lambda: torch.unique(
                   ids64, sorted=True, return_inverse=True), reps=50),
               "bound_ms": bound_ms(20 * ids64.numel())}
    return out, {"int64": dedup64}, {"merge_mode": merge_mode}


def lookup_timing(np, torch, sk, seed) -> list:
    """merge_rows as the backward of ``embed.table.lookup`` on the training
    paths, beside ``index_add_`` into zeros (``index_select``'s own
    backward): one batch's 159,744 slot gradients summed into the whole
    2^20-row table (CTRTrainer) and into the sparse trainer's 159,744
    deduped rows, at d = 32 (v) and d = 1 (w); and into the whole table at
    d = 312 (FFM's v in the cli phase, 1.3 GB out: fewer calls a graph).
    Each shape's kernel is first held bit for bit to its plain version.
    ``ms`` and ``library_ms`` are medians of LOOKUP_REPEATS graph replays
    (the ``*_min_max`` keys give each one's spread), ``plain_ms`` one
    timed eager run."""
    rng = np.random.default_rng(seed + 13)
    ids = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)) \
        .cuda()
    _, inv, _ = sk.dedup_ids(ids)
    m = ids.numel()
    gen = torch.Generator(device="cuda").manual_seed(53)
    out = []
    for trainer, seg, nseg, ds in (
            ("CTRTrainer", ids.to(torch.int32), VOCAB, (DIM, 1, FFM_ROW)),
            ("SparseTableCTRTrainer", inv, m, (DIM, 1))):
        seg64 = seg.to(torch.int64)
        for d in ds:
            grad = torch.randn((m, d), generator=gen, device="cuda")
            got = sk.merge_rows(grad, seg, nseg)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), sk.merge_rows_plain(
                    grad, seg, nseg).view(torch.int32)):
                raise AssertionError(f"merge_rows kernel != plain at "
                                     f"{trainer}'s d={d}, nseg={nseg}")
            del got
            nbytes = m * d * 4 + m * 4 + nseg * d * 4
            big = d == FFM_ROW
            reps = 5 if big else 100
            ms = graph_times(torch, lambda: sk.merge_rows(grad, seg, nseg),
                             reps=reps, repeats=LOOKUP_REPEATS)
            plain = plain_once_ms(torch, lambda: sk.merge_rows_plain(
                grad, seg, nseg))
            lib = graph_times(torch, lambda: torch.zeros(
                (nseg, d), device="cuda").index_add_(0, seg64, grad),
                reps=reps, repeats=LOOKUP_REPEATS)
            out.append({
                "trainer": trainer, "m": m, "nseg": nseg, "d": d,
                "workspace_bytes": sk.load("merge_rows")
                .merge_rows_workspace_bytes(m, nseg, d),
                "bit_exact_vs_plain": True,
                "ms": statistics.median(ms),
                "ms_min_max": [min(ms), max(ms)],
                "plain_ms": plain,
                "library_ms": statistics.median(lib),
                "library_ms_min_max": [min(lib), max(lib)],
                "library_call": "torch.zeros(...).index_add_, the backward "
                                "of index_select",
                "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                "bytes": nbytes})
            del grad
            torch.cuda.empty_cache()
    return out


def zoo_merge_inputs(np, torch, seed) -> list:
    """merge_rows at the zoo phase's shapes: GBM's root histogram (10,000 x
    784 slots at d 1 into 784 x 33 segments, a row's gradient in each of
    its 784 slots, 3 rows in 10 masked to 0) and word2vec's context gather
    backward (256 x 12 slots at d 100 into the 5,000-row table, Zipf
    ids): (name, rows, seg, nseg) each."""
    rng = np.random.default_rng(seed + 61)
    n, f, slots = ZOO_ROWS, ZOO_FEATURES, 33
    seg = (np.arange(f)[None, :] * slots + rng.integers(0, slots, (n, f))
           ).reshape(-1).astype(np.int32)
    stat = (rng.normal(size=n) * (rng.random(n) < 0.7)).astype(np.float32)
    rows = torch.from_numpy(stat).cuda()[:, None].expand(n, f).reshape(
        -1, 1).contiguous()
    m = ZOO_W2V_BATCH * 2 * ZOO_W2V_WINDOW
    ids = np.minimum(rng.zipf(1.2, m) - 1, ZOO_VOCAB - 1).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(seed + 62)
    ctx = torch.randn((m, 100), generator=gen, device="cuda")
    return [("gbm_root_histogram", rows, torch.from_numpy(seg).cuda(),
             f * slots),
            ("word2vec_context", ctx, torch.from_numpy(ids).cuda(),
             ZOO_VOCAB)]


def check_merge_rows_zoo(np, torch, sk, seed) -> dict:
    """merge_rows kernel == plain version bit for bit at the zoo's two
    shapes (``zoo_merge_inputs``)."""
    cases = []
    for what, rows, seg, nseg in zoo_merge_inputs(np, torch, seed):
        got = sk.merge_rows(rows, seg, nseg)
        torch.cuda.synchronize()
        want = sk.merge_rows_plain(rows, seg, nseg)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"merge_rows kernel != plain at {what}: "
                                 f"max {float((got - want).abs().max())}")
        cases.append({"shape": what, "m": rows.shape[0], "d": rows.shape[1],
                      "nseg": nseg})
    return {"bit_exact": True, "max_abs_err": 0.0, "cases": cases}


def zoo_merge_timing(np, torch, sk, seed) -> list:
    """merge_rows at the zoo's shapes beside ``index_add_`` into zeros:
    ``ms`` and ``library_ms`` medians of LOOKUP_REPEATS graph replays,
    ``plain_ms`` one eager run; the bound is the bytes (rows and ids read
    once, the output written once)."""
    out = []
    for what, rows, seg, nseg in zoo_merge_inputs(np, torch, seed):
        m, d = rows.shape
        seg64 = seg.to(torch.int64)
        reps = 10 if m > (1 << 20) else 100
        ms = graph_times(torch, lambda: sk.merge_rows(rows, seg, nseg),
                         reps=reps, repeats=LOOKUP_REPEATS)
        plain = plain_once_ms(torch, lambda: sk.merge_rows_plain(rows, seg,
                                                                 nseg))
        lib = graph_times(torch, lambda: torch.zeros(
            (nseg, d), device="cuda").index_add_(0, seg64, rows),
            reps=reps, repeats=LOOKUP_REPEATS)
        nbytes = m * d * 4 + m * 4 + nseg * d * 4
        out.append({
            "shape": what, "m": m, "nseg": nseg, "d": d,
            "workspace_bytes": sk.load("merge_rows")
            .merge_rows_workspace_bytes(m, nseg, d),
            "ms": statistics.median(ms), "ms_min_max": [min(ms), max(ms)],
            "plain_ms": plain,
            "library_ms": statistics.median(lib),
            "library_ms_min_max": [min(lib), max(lib)],
            "library_call": "torch.zeros(...).index_add_",
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "bytes": nbytes})
        del rows, seg, seg64
        torch.cuda.empty_cache()
    return out


def quality_merge_inputs(np, torch, seed):
    """merge_rows at the quality sketch's shape: one step's TRAIN_BATCH
    stacked [1, label, p, logloss] rows (d 4) into QUALITY_BINS segments
    by the bucket of p, ``obs.quality.quality_sketch``'s layout."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 63)
    p = torch.sigmoid(torch.randn(TRAIN_BATCH, generator=gen,
                                  device="cuda"))
    y = (torch.rand(TRAIN_BATCH, generator=gen, device="cuda") < p).float()
    idx = torch.clamp((p * QUALITY_BINS).to(torch.int32), 0,
                      QUALITY_BINS - 1)
    pc = torch.clamp(p, 1e-7, 1 - 1e-7)
    ll = -(y * torch.log(pc) + (1 - y) * torch.log1p(-pc))
    return torch.stack([torch.ones_like(p), y, p, ll], dim=1), idx


def check_merge_rows_quality(np, torch, sk, seed) -> dict:
    """merge_rows kernel == plain version bit for bit at the quality
    sketch's shape, and ``quality_sketch`` on the card equal to its rows
    merged by the plain version."""
    from lightctr_tpu_torch.obs import quality

    rows, idx = quality_merge_inputs(np, torch, seed)
    got = sk.merge_rows(rows, idx, QUALITY_BINS)
    torch.cuda.synchronize()
    want = sk.merge_rows_plain(rows, idx, QUALITY_BINS)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("merge_rows kernel != plain at the quality "
                             f"sketch: max {float((got - want).abs().max())}")
    sketch = quality.quality_sketch(rows[:, 2], rows[:, 1], QUALITY_BINS)
    if not torch.equal(sketch.view(torch.int32),
                       want.t().reshape(-1).view(torch.int32)):
        raise AssertionError("quality_sketch != its plain merge")
    return {"bit_exact": True, "max_abs_err": 0.0, "m": TRAIN_BATCH,
            "d": 4, "nseg": QUALITY_BINS}


def quality_merge_timing(np, torch, sk, seed) -> list:
    """merge_rows at the quality sketch's shape beside ``index_add_`` into
    zeros (``zoo_merge_timing``'s fields)."""
    rows, idx = quality_merge_inputs(np, torch, seed)
    m, d = rows.shape
    idx64 = idx.to(torch.int64)
    ms = graph_times(torch, lambda: sk.merge_rows(rows, idx, QUALITY_BINS),
                     repeats=LOOKUP_REPEATS)
    plain = plain_once_ms(torch, lambda: sk.merge_rows_plain(
        rows, idx, QUALITY_BINS))
    lib = graph_times(torch, lambda: torch.zeros(
        (QUALITY_BINS, d), device="cuda").index_add_(0, idx64, rows),
        repeats=LOOKUP_REPEATS)
    nbytes = m * d * 4 + m * 4 + QUALITY_BINS * d * 4
    return [{
        "shape": "quality_sketch", "m": m, "nseg": QUALITY_BINS, "d": d,
        "workspace_bytes": sk.load("merge_rows")
        .merge_rows_workspace_bytes(m, QUALITY_BINS, d),
        "ms": statistics.median(ms), "ms_min_max": [min(ms), max(ms)],
        "plain_ms": plain,
        "library_ms": statistics.median(lib),
        "library_ms_min_max": [min(lib), max(lib)],
        "library_call": "torch.zeros(...).index_add_",
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "bytes": nbytes}]


def rs_timing(np, torch, sk, seed) -> dict:
    """dedup_ids, merge_rows and merge_apply's apply mode at the dp_rs
    path's shapes (owner 0's 25,960 bucket ids cut at 8,193; its [25,960,
    32] bucket rows into 8,193 segments; the 65,544 gathered shard slots
    into a [65,536, 32] table): {kernel: its ``dp_rs`` timing}."""
    inp = rs_path_inputs(np, torch, sk, np.random.default_rng(seed + 9))
    all_ids, uniq, inv = inp["owner0"]
    shard, m = inp["shard"], all_ids.numel()
    gen = torch.Generator(device="cuda").manual_seed(47)
    rows = torch.randn((m, DIM), generator=gen, device="cuda") * 0.05 \
        * (all_ids != 0).to(torch.float32).reshape(-1, 1)
    out = {}
    nbytes = m * 4 + m * 4 + shard * 4
    out["dedup_ids"] = {
        "k": m, "size": shard,
        "ms": graph_ms(torch, lambda: sk.dedup_ids(all_ids, shard)),
        "library_ms": call_ms(torch, lambda: torch.unique(
            all_ids, sorted=True, return_inverse=True), reps=50),
        "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    nbytes = m * DIM * 4 + m * 4 + shard * DIM * 4
    out["merge_rows"] = {
        "m": m, "d": DIM, "nseg": shard,
        "ms": graph_ms(torch, lambda: sk.merge_rows(rows, inv, shard)),
        "plain_ms": call_ms(torch, lambda: sk.merge_rows_plain(
            rows, inv, shard), reps=3),
        "library_ms": graph_ms(torch, lambda: torch.zeros(
            (shard, DIM), device="cuda").index_add_(0, inv, rows)),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes}
    out_ids = inp["out_ids"]
    s = out_ids.numel()
    real = int(((out_ids != 0) | (torch.arange(s, device="cuda") == 0))
               .sum())
    table = torch.randn((RS_VOCAB, DIM), generator=gen, device="cuda")
    accum = torch.rand((RS_VOCAB, DIM), generator=gen, device="cuda")
    grads = torch.randn((s, DIM), generator=gen, device="cuda") * 0.05
    nbytes = real * DIM * 4 * 4 + real * DIM * 4 + s * 4
    out["merge_apply"] = {
        "mode": "apply", "s": s, "s_real": real, "vocab": RS_VOCAB,
        "d": DIM,
        "ms": graph_ms(torch, lambda: sk.merge_apply(
            table, accum, out_ids, grads, lr=LR, eps=EPS)),
        "plain_ms": call_ms(torch, lambda: sk.merge_apply_plain(
            table, accum, out_ids, grads, None, LR, EPS, 1.0), reps=20),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes}
    return out


def new_timing(torch, sk, fl, qz, seed, launches, kern, route) -> list:
    """quantize_pack_ef on the [79,872, 32] payload (8 bits, a [P, 1]
    mask: one dp rank's layout) and flash_attention at the attention
    path's shape, with the bench's other shapes beside it."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn((DP_LOCAL_K, DIM), generator=gen, device="cuda") * 0.05
    car = torch.randn((DP_LOCAL_K, DIM), generator=gen, device="cuda") * 0.01
    mask = torch.ones((DP_LOCAL_K, 1), device="cuda")
    table = qz.build_table(-1.0, 1.0, bits=8, mode="normal", device="cuda")
    n = x.numel()
    nbytes = n * (4 + 4 + 1 + 4) + DP_LOCAL_K * 4
    rows = [kernel_row(
        sk, "quantize_pack_ef", launches=launches["quantize_pack_ef"],
        launches_on="bench phase (its only caller, as in the JAX package)",
        max_abs_err=kern["quantize_pack_ef"]["max_abs_err"],
        shape={"p": DP_LOCAL_K, "d": DIM, "bits": 8, "mask": [DP_LOCAL_K, 1]},
        design=sk.search_design(table.bits),
        ms=graph_ms(torch, lambda: sk.quantize_pack_ef(table, x, car, mask)),
        cold_ms=cold_ms(torch, lambda: sk.quantize_pack_ef(table, x, car,
                                                           mask)),
        plain_ms=graph_ms(torch, lambda: sk.quantize_pack_ef_plain(
            table, x, car, mask)),
        library_ms=None,
        library_note="no single PyTorch call computes an EF-compensated "
                     "quantile encode with its fresh error",
        bound_ms=bound_ms(nbytes), bound_by="bytes", bytes=nbytes,
        call_ms=call_ms(torch, lambda: sk.quantize_pack_ef(table, x, car,
                                                           mask)))]

    per_shape = []
    timed = [(shape, True) for shape in FLASH_BENCH_SHAPES]
    timed += list(FLASH_EXTRA_TIMED)
    for i, (shape, causal) in enumerate(timed):
        b, t, h, d = shape
        q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed + 200 + i)
        qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
        # causal: the lower triangle's products (T^2/2 of them)
        flops = 4 * b * h * t * t * d / (2 if causal else 1)
        nbytes = 4 * q.numel() * 2
        bound, by = bound_ms_ops(nbytes, flops)
        kms = graph_ms(torch, lambda: fl.flash_attention(q, k, v,
                                                         causal=causal),
                       reps=20)
        per_shape.append({
            "shape": list(shape), "causal": causal,
            "design": fl.flash_route(q, k, v), "ms": kms,
            "plain_ms": call_ms(torch, lambda: fl.flash_attention_plain(
                q, k, v, causal), reps=5),
            "library_ms": graph_ms(
                torch, lambda: torch.nn.functional
                .scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                reps=20),
            "call_ms": call_ms(torch, lambda: fl.flash_attention(
                q, k, v, causal=causal), reps=20),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "tflops": flops / (kms / 1e3) / 1e12})
        del q, k, v, qt, kt, vt
    main = per_shape[[(tuple(p["shape"]), p["causal"]) for p in per_shape]
                     .index((FLASH_PATH_SHAPE, True))]
    rows.append(kernel_row(
        sk, "flash_attention", launches=launches["flash_attention"],
        launches_on="attention phase",
        max_abs_err=kern["flash_attention"]["max_abs_err"],
        shape={"bthd": list(FLASH_PATH_SHAPE), "dtype": "bfloat16",
               "causal": True},
        design=main["design"], design_launches=route,
        ms=main["ms"], plain_ms=main["plain_ms"],
        plain_timing="eager between events (float32 full_attention)",
        library_ms=main["library_ms"],
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True) on [B, H, T, D] copies",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        flops=main["flops"], bytes=main["bytes"], tflops=main["tflops"],
        call_ms=main["call_ms"], per_shape=per_shape))
    return rows


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "lightctr_tpu_torch")):
        print("chip_smoke: lightctr_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from lightctr_tpu_torch.native import bindings
    from lightctr_tpu_torch.nn import flash_attention as fl
    from lightctr_tpu_torch.ops import sparse_kernels as sk
    from lightctr_tpu_torch.optim import fused_adagrad as fa

    from lightctr_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    def timed(fn, *a):
        """``fn(*a)``'s line with the phase's seconds."""
        t = time.perf_counter()
        info = fn(*a)
        return info | {"phase_s": time.perf_counter() - t}

    emit(timed(phase_build, sk, bindings) | {"nvidia_smi": smi})
    requests = make_requests(np, args.seed)
    serve_ns = serve_gather_ns(np, sk, requests)
    krng = np.random.default_rng(args.seed + 4)
    t_kern = time.perf_counter()
    kern = phase_kernels(torch, sk, serve_ns)
    kern["dedup_ids"] = check_dedup(np, torch, sk, krng)
    kern["dedup_ids_int64"] = check_dedup64(np, torch, sk, krng)
    kern["merge_apply"] = check_merge_apply(np, torch, sk, krng)
    kern["merge_apply_merge_mode"] = check_merge_apply_merge_mode(
        np, torch, sk, krng)
    kern["merge_rows"] = check_merge_rows(np, torch, sk, krng)
    kern["quantize_pack"] = check_quantize_pack(np, torch, sk, qz)
    kern["quantize_pack_ef_update"] = check_quantize_pack_ef_update(
        np, torch, sk, qz, krng)
    kern["fused_adagrad"] = check_fused_adagrad(torch, fa)
    kern["quantize_pack_ef"] = check_quantize_pack_ef(np, torch, sk, qz)
    kern["flash_attention"] = check_flash(torch, sk, fl)
    kern["dp_rs_path"] = check_rs_path(np, torch, sk, qz, krng)
    kern["merge_rows_zoo"] = check_merge_rows_zoo(np, torch, sk, args.seed)
    kern["merge_rows_quality"] = check_merge_rows_quality(np, torch, sk,
                                                          args.seed)
    kern["gather_rows_tiered"] = check_gather_tiered(torch, sk)
    emit(kern | {"phase_s": time.perf_counter() - t_kern})
    serve_info = timed(phase_serve, np, torch, sk, args.seed, requests)
    emit(serve_info | {"serve_gather_ns": serve_ns, "nvidia_smi": smi})
    train_info = timed(phase_train, np, torch, sk, args.seed)
    emit(train_info | {"nvidia_smi": smi})
    dp_info = timed(phase_dp, np, torch, sk, args.seed)
    emit(dp_info | {"nvidia_smi": smi})
    rs_info = timed(phase_dp_rs, np, torch, sk, args.seed)
    emit(rs_info | {"nvidia_smi": smi})
    online_root = tempfile.mkdtemp(prefix="chip_smoke_online_file_")
    try:
        ingest_info = timed(phase_ingest, np, torch, sk, args.seed,
                            rs_info["repeat_coded_step"], online_root)
        emit(ingest_info | {"nvidia_smi": smi})
        online_info = timed(phase_online, np, torch, sk, args.seed,
                            os.path.join(online_root, "train.ffm"),
                            requests)
        emit(online_info | {"nvidia_smi": smi})
        tiered_info = timed(phase_tiered, np, torch, sk, args.seed,
                            os.path.join(online_root, "train.ffm"),
                            requests, online_info)
        emit(tiered_info | {"nvidia_smi": smi})
    finally:
        shutil.rmtree(online_root, ignore_errors=True)
    cluster_info = timed(phase_cluster, np, torch, sk, args.seed)
    emit(cluster_info | {"nvidia_smi": smi})
    serve_deep_info = timed(phase_serve_deep, np, torch, sk, args.seed,
                            requests)
    emit(serve_deep_info | {"nvidia_smi": smi})
    train_deep_info = timed(phase_train_deep, np, torch, sk, args.seed)
    emit(train_deep_info | {"nvidia_smi": smi})
    dp_deep_info = timed(phase_dp_deep, np, torch, sk, args.seed)
    emit(dp_deep_info | {"nvidia_smi": smi})
    cli_info = timed(phase_cli, np, torch, sk, args.seed)
    emit(cli_info | {"nvidia_smi": smi})
    zoo_info = timed(phase_zoo, np, torch, sk, args.seed)
    emit(zoo_info | {"nvidia_smi": smi})
    algos_info = timed(phase_algos, np, torch, sk, args.seed)
    emit(algos_info | {"nvidia_smi": smi})
    attn_info = timed(phase_attention, torch, sk, fl, args.seed)
    emit(attn_info | {"nvidia_smi": smi})
    bench_info = timed(phase_bench, torch, sk)
    emit(bench_info | {"nvidia_smi": smi})
    t_timing = time.perf_counter()
    gather_row, gather_floor = gather_timing(
        torch, sk, serve_ns, serve_info["launches"],
        kern["gather_rows"]["max_abs_err"])
    emit(gather_floor | {"nvidia_smi": smi})
    rows = [gather_row]
    rows += train_timing(np, torch, sk, fa, args.seed,
                         train_info["train_launches"], kern)
    new_rows, dedup_extra, merge_extra = dp_timing(
        np, torch, sk, qz, args.seed, dp_info["dp_launches_rank0"], kern)
    for row in rows:
        if row["name"] == "dedup_ids":
            row.update(dedup_extra,
                       launches_dp=dp_info["dp_launches_rank0"]["dedup_ids"])
        if row["name"] == "merge_apply":
            # the dp phase checks that every one ran the merge design
            row.update(merge_extra,
                       launches_dp=dp_info["dp_launches_rank0"]["merge_apply"],
                       launches_dp_note="merge mode, both widths together "
                                        "(each table merged once a step)")
    rows += new_rows
    rows += new_timing(torch, sk, fl, qz, args.seed, {
        "quantize_pack_ef": bench_info["launches"]["quantize_pack_ef"],
        "flash_attention": attn_info["launches"]["flash_attention"]}, kern,
        attn_info["flash_route"])
    rs_extra = rs_timing(np, torch, sk, args.seed)
    train_merge = lookup_timing(np, torch, sk, args.seed)
    zoo_merge = zoo_merge_timing(np, torch, sk, args.seed)
    quality_merge = quality_merge_timing(np, torch, sk, args.seed)
    for row in rows:
        name = row["name"]
        row["launches_bench"] = bench_info["launches"].get(name, 0)
        row["launches_dp_rs"] = rs_info["launches_rank0"].get(name, 0)
        row["launches_ingest"] = ingest_info["launches"].get(name, 0)
        if name in rs_extra:
            row["dp_rs"] = rs_extra[name]
        if name == "merge_rows":
            # its main path since it became the gather's backward: every
            # training path, two launches a step (w and v)
            row.update(launches_dp=row["launches"],
                       launches=train_info["train_launches"]["merge_rows"],
                       launches_note="train phase (50 sparse and 10 fused "
                                     "steps, w and v a step: the backward "
                                     "of embed.table.lookup); launches_dp "
                                     "and launches_dp_rs count rank 0's "
                                     "there, launches_ingest the ingest "
                                     "phase's (its shard-cache replays "
                                     "and fits too, and one launch a step "
                                     "at the quality sketch's shape in "
                                     "the two armed replays)",
                       per_shape_train=train_merge,
                       per_shape_zoo=zoo_merge,
                       per_shape_quality=quality_merge)
        # the Wide&Deep family's paths: B3 in serve_deep, B1, B2, B4 and
        # B5 in train_deep, B2, B4, B5 and B6 in dp_deep (rank 0), and B4
        # in the CLI's in-process runs (the CTR half in cli, GBM's merges
        # and the LR and word2vec gathers' backward in zoo), and B3 and B4
        # in the online phase (the server's cache, the online steps'
        # lookups' backward), and B3, B4 and B5 in the tiered phase (the
        # store's pair, the fast path's apply, the online shard's steps),
        # and B2, B4 and B5 (rank 0 of host 0 of the two-level exchange)
        # and B3 (the surviving tiered PS shards) in the cluster phase,
        # counted into each row's launches
        deep = {"launches_serve_deep":
                serve_deep_info["launches"].get(name, 0),
                "launches_train_deep":
                train_deep_info["launches"].get(name, 0),
                "launches_dp_deep":
                dp_deep_info["launches_rank0"].get(name, 0),
                "launches_cli": cli_info["launches"].get(name, 0),
                "launches_zoo": zoo_info["launches"].get(name, 0),
                "launches_online": online_info["launches"].get(name, 0),
                "launches_tiered": tiered_info["launches"].get(name, 0),
                "launches_cluster": cluster_info["launches"].get(name, 0)}
        row.update(deep, launches=row["launches"] + sum(deep.values()))
    emit({"timing_s": time.perf_counter() - t_timing})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank_main(sys.argv[2:]))
    sys.exit(main())
