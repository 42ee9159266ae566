#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddlebox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (exit code != 0):

  1. the card: nvidia-smi name and power limit, torch device properties;
  2. build all four CUDA kernels from paddlebox_tpu_torch/csrc with nvcc
     (sm_90a), one nvcc per source, in parallel, and meanwhile the native
     host library (the slot parser, the host store and the route index,
     paddlebox_tpu_torch/native/*.cc) with g++; the synthetic files are
     written in a process of their own meanwhile and through phases 3 and
     10, which need none of them and run next;
  3. a small-input check: two train_passes of a narrow DeepFM on the card
     and the same on the CPU (plain versions) agree;
  4. each kernel against its plain PyTorch version on the card, at the
     shapes of its paths, all bit-equal: the fused push_adagrad (merge,
     update and row write in one kernel) over a real flagship batch's
     dedup (131,072 key slots, 77,128 uniques) on a 2^20 x 17 slab whose
     touched rows mix embedx creation, update and inactive rows, in both
     write modes (in place, and rows out for the blocked path),
     blocked_write on the same slab shape from that batch's sorted uids
     and its n_uniq rows (copy_probe.blocked_case), scale_copy over f32
     [131072, 128] and [524288, 128] and on its edge cases (x 0-12 bytes
     into its buffer, n from 1 to a second wave of blocks; one launch
     a call; both round x * 0.999 + 0.001 once), gather_rows at the
     rate probe's shape (131,072 sorted unique ids from a 2^20 x 128 slab),
     at the pull's (a real batch's 131,072 ids into a 2^20 x 17 slab), at
     the cadence's delta promote (the second pass's 557,074 source rows in
     the first pass's slab, 504,026 of them resident) and at the touched-row
     write-back (557,083 rows), and both copy kernels on their edge cases
     (paddlebox_tpu_torch/edge_cases.py: gather_rows at K around its tile
     for W 1, 17, 32, 33 and 128 from aligned and unaligned sources,
     blocked_write with permuted sources, sentinel slots, a full slot, B
     100 to 4096, NB 1, an unaligned row map, in either slot order) and
     over many tiles (2^20 ids; 6,000 slots of 512 lanes; 410,407 rows of
     a 2^20 x 17 slab in 1024 slots, a step of 8 flagship batches'
     density, one run of sources a tile and permuted); the push kernels'
     kernel, plain, library and bound times (the fused push timed rows
     out, so that repeated launches do not compound the update;
     blocked_write against index_copy_ of the same rows in BLOCKED_ROUNDS
     rounds of A, B, B, A, medians), and gather_rows' at the promote and
     write-back shapes;
  5. the main path at full width: two BoxTrainer.train_pass calls of the
     flagship configuration (paddlebox_tpu_torch/train/flagship.py: DeepFM
     hidden 512-256-128, 32 slots, batch 1024, max_len 4, embedx 8, 2^20-row
     pass slab, push_write='scatter', the incremental pass lifecycle) over
     16 batches of synthetic data, through the chunk driver (two chunks of
     8 a pass: the staging pool, the staged-ahead producer, pinned copies
     on a copy stream), on the native host tier (the columnar
     dataset, the C++ store, the route index: each checked); loss and AUC
     printed to 10 digits and equal to the digits the port has given since
     its first slice (FLAGSHIP_DIGITS), examples/s; the second pass a
     delta promote of every row (the table's counters); push_adagrad
     launched once a step and gather_rows exactly once a step (the pull)
     plus once a delta promote and once a touched-row write-back, by the
     table's counters: 35. Then the same two passes on the plain host
     tier (the record-path dataset and the Python store): losses, AUC and
     the sorted host store bit-equal to the native run; both tiers' pass
     phases beside the card line;
  6. the incremental cadence at full width: three passes over sliding
     windows of the flagship's files (train/flagship.py write_cadence) in
     each of cadence_probe.MODES: (a) run_preloaded_passes with both pass
     switches on, (b) sequential passes without the preload, (c)
     sequential full rebuilds, (d) run_preloaded_passes without the
     prefetcher; equal losses and AUC, bit-identical host stores, the
     table's counters equal to the key sets' overlaps (and to the
     flagship's numbers), and the launches, all on the native host tier;
     per pass and mode the phase seconds and examples/s;
  7. the day at full width (train/checkpoint.py), on the main path's
     trainer after its two passes: a test pass
     (BoxTrainer.predict_batches) over the cadence's third window, 16,384
     instances: the host store bit-identical before and after, gather_rows
     launched 1 + 16 times (the promote of the resident slab and the
     pulls), no push, and its AUC held to TEST_PASS_DIGITS; then run_day
     over the cadence's three windows with a delta save after each pass
     (three deltas, the base, end_day(age=False)), whose first pass builds
     in full (the test pass left nothing resident); load_base into a fresh
     trainer: store and dense state bit-equal to the base's snapshot; the
     xbox base and deltas read back (view files and XboxModelReader)
     bit-equal to the snapshot rows each covers; resume equals continue:
     one more pass from the loaded trainer (after the day boundary's stat
     rewrite and shrink, replayed) and from the trainer that saved give
     bit-identical losses, AUC and stores; the seconds of save_base (the
     caller's part and the writer), save_delta, load_base and end_day, the
     rows the shrink deleted, the base's bytes and the touched-row
     journal's bytes and rows at the base save (the journal is on, the
     default), beside the card line;
  8. the blocked mode: one pass of 4 batches with push_write='blocked' and
     one with 'scatter' from the same seed give bit-identical rows, and
     push_adagrad and blocked_write each launched once a step;
  9. the chunk driver: the main path's two passes one step at a time (A)
     and in chunks of 8 (B) in the order A, B, B, A (CHUNK_RUNS: the B runs
     with two chunks a pinned copy, h2d_stack_chunks=2, and with two
     chunks staged ahead, chunk_prefetch_depth=2), each bit-identical to
     phase 5's run (losses, AUC, launches, sorted stores), with each run's
     pass phases; one sparse_chunk_sync pass (chunks of 8: push_adagrad
     and gather_rows once a chunk, and one write-back), its digits held to
     SYNC_DIGITS; the host-to-device copies of a chunked pass (a third
     pass of the run staging two chunks ahead) by kind, 7 pinned a chunk
     (profile_pass.py); gather_rows and the fused push_adagrad at the
     chunk's shape (the first 8 batches' 1,048,576 ids flat, and their
     merged dedup) bit-equal to their plain versions, with kernel, plain,
     index_select and bound times;
 11. recovery at full width (train/recovery.py): RecoverableRunner over
     the cadence's three windows, saving every pass in mode 'auto', in
     the runs RECOVERY_RUNS (the journal on, A, and off, B, in the order
     A, B, B, A, each settled): in A pass-0 is a full base and the
     journal's anchor, pass-1 and pass-2 journal-mode snapshots whose
     base links are the anchor's parts; the write-back ROWS records of
     passes 1 and 2, read from pass-2's segments, hold the pass keys and
     the rows gather_rows returned, bit for bit; load_base of each pass
     into a fresh trainer gives the store its save snapshotted; every
     run launches push_adagrad once a step and gather_rows once a step
     and once a write-back, and gives run 0's losses, AUC and store bit
     for bit (the journal changes no result); a run over two windows,
     then a fresh trainer and runner over all three, which resumes at
     pass 2 with run 0's pass-2 loss and AUC and its store; per pass the
     table's begin_pass/end_pass seconds, the save's seconds (the
     caller's part and the writer's), the bytes written (a hard link
     counted once), each run's wall, beside the card line;
 12. the bf16 slab diet at full width (slab_embed_dtype="bfloat16",
     train/flagship.py FLAGSHIP_BF16: a 2^20 x 25 int16 slab, 50 B a row
     against 68 B): the three kernels' 2-byte forms against their plain
     versions, all bit-equal, at the main path's shapes (the fused push
     decoding and encoding rows in both write modes on phase 4's batch,
     with a hot key and at every embedx width; the placement of its rows;
     the pull raw and decoding; the delta promote and the write-back) and
     on their 2-byte edge cases (edge_cases.py: row widths 19, 25, 26 and
     81, odd row starts, B odd and even, the placement's permuted and
     consecutive sources and its tensors one element into their
     buffers), with kernel, plain, library and bound times (the placement
     and index_copy_ in BLOCKED16_ROUNDS rounds of A, B, B, A, their
     ratio a round), the pull's decode timed both fused in the gather and
     as a separate op; then FLAGSHIP_BF16's two passes (scatter, incremental,
     chunks of 8): digits held to BF16_DIGITS, push_adagrad's bf16 form
     launched once a step, gather_rows' decoding form once a step and its
     raw 2-byte form at the promote and the two write-backs (35), no f32
     form; the slab's bytes and the write-backs' D2H bytes beside the f32
     ones, |dAUC| against phase 5's passes within BF16_AUC_GATE, the pass
     phases beside phase 5's; a 4-batch blocked pass bit-identical to
     scatter on the 2-byte blocked write; one dense bf16 pass
     (compute_dtype and matmul_dtype bfloat16), its digits held to
     DENSE_BF16_DIGITS;
 13. the trainer's host planes (ObsFlags: the StatRegistry counters, the
     span tracer, the StepReporter, the tagged quality plane and the drift
     monitor, all on by default as in the reference, so phases 3-12 run
     with them): the main path's two passes with every plane on and every
     plane off, in the order on, off, off, on (PLANE_RUNS), each
     run settled, each bit-identical to phase 5's run (losses, AUC, launches,
     sorted store); each on run's pass_end records (one a pass; the stats
     deltas of a pass's records equal to the table's counters of the
     pass; the quality 'all' AUC within the quality table's resolution of
     the trainer's AUC; the drift window present) and its chrome trace
     with the spans PLANE_SPANS; an off run writes no record and no span;
     each run's pass phases, walls and examples/s, the on and off means
     and the planes' own host work over one pass timed alone, beside the
     card line;
 14. the other in-table rules and the expand block (flagship.py
     RULE_FLAGSHIPS): the fused push's forms of adam, adam_shared, naive,
     adagrad with a 64-wide expand block and naive with one on the f32
     slab, and of adam and adagrad + expand on the bf16 slab (RULE_FORMS),
     each bit-equal to its plain version in both write modes at the
     flagship batch (phase 4's dedup on a 2^20-row slab of the form's
     width), with kernel, in-place, plain and bound times, the expand
     forms also with a 1,000-occurrence hot key (more occurrences than a
     tile stages); every other instantiation of those rules on a small
     batch with a hot key; the
     pull's gather_rows at 37 and 82 f32 columns against index_select,
     bit-equal, with kernel, plain, index_select and bound times; then two
     full-width passes of FLAGSHIP_ADAM, FLAGSHIP_ADAM_SHARED,
     FLAGSHIP_NAIVE and FLAGSHIP_EXPAND (CtrDnnExpand over an adagrad
     table with expand_embed_dim 64), each launching its push form once a
     step and gather_rows once a step and at the promote and the two
     write-backs (35), its digits held to RULE_DIGITS, its slab bytes
     logged; FLAGSHIP_EXPAND's test pass after its two (predict_batches
     over the cadence's third window, held to EXPAND_TEST_PASS_DIGITS); a
     4-batch FLAGSHIP_ADAM pass blocked and scatter, bit-identical; and a
     4-batch pass of each form no configuration runs (naive + expand, the
     two bf16 forms), each launching its form once a step;
 15. the model zoo's dense and multi-task heads (flagship.py
     ZOO_FLAGSHIPS: CtrDnn with data_norm, Wide&Deep, DLRM, MMoE, ESMM at
     the JAX package's default widths) over one hybrid file set (13 dense
     columns and a conversion label, written by the spawned writer after
     the cadence's files, as write_cadence lays them out: the passes
     train on its first window): each configuration's two full-width passes
     (FLAGSHIP's table and run settings), each launching push_adagrad once
     a step and gather_rows once a step and at the promote and the two
     write-backs (35), its loss and AUC (and ESMM's ctcvr_auc) held to
     ZOO_DIGITS; CtrDnn's summaries f32 buffers whose dense tail equals a
     host replay of the decay rule over the passes' batches in order
     (batch_size bit for bit, batch_sum and batch_square_sum within
     DN_SUM_RTOL) and whose slot blocks each move as one; the staging
     ring's 9 leaves for MMoE (the dense and labels_cvr leaves beside the
     main path's 7, f32 and int32), and the second of two MMoE passes
     profiled in the writer's spawned process, its first profiler session
     (profile_pass.py: 9 pinned copies a chunk, the idle share); a
     4-batch MMoE pass blocked and scatter, bit-identical; one
     sparse_chunk_sync pass of ESMM (one pull and one push a chunk); a test
     pass of ESMM (predict_batches over held-out files, the third window
     of the zoo's cadence-style file set, held to ZOO_TEST_PASS_DIGITS);
     one compute_dtype="bfloat16" pass of
     FLAGSHIP_CTR_DNN whose summaries stay f32; each pass's wall and
     examples/s beside the DeepFM main path's, with the card line;
 16. the join phase's record-path feeds (flagship.py FLAGSHIP_JOIN_PV,
     FLAGSHIP_AUX), each pass flagship.load_pass (the feed, then the
     records' fields) and train_pass(preloaded=True): a narrow JoinPvDnn
     on the card against the CPU (as phase 3); two full-width passes of
     JoinPvDnn (rank_param [3168, 64], MLP 416-512-256-128-1) over the
     main path's files with the pv rank-offset feed (assign_pv), 32
     push_adagrad and 35 gather_rows launches, its digits held to
     JOIN_DIGITS, rank_param moved, the ring's 8 leaves (rank_offset int32
     [C, 1024, 7]), a cmatch-rank AUC (JOIN_GROUP) whose instance count
     equals a count of the records' (cmatch, rank) pairs (JOIN_PAIRS),
     the quality plane's cmatch:222 and cmatch:223 streams, each pass's
     rows split by their pv fields into not joined, joined alone and
     joined with a peer in the batch; two
     full-width passes of CtrDnnAux (512-256-128, aux rows 8 wide, 4096 of
     them) over ins_id files through flagship.input_table (the same
     launches, digits held to AUX_DIGITS, aux_rows bit-equal to the
     table's to_device(4096), its misses equal to a host count, the ring's
     aux_offset leaf); a 4-batch pass through flagship.replica_cache by
     cache_idx; each pass's wall and examples/s beside the DeepFM main
     path's, with the card line;
 17. the behavior-sequence model, the seqpool variants and the dense
     optimizers sgd and adagrad: a narrow BstSeqCtr through SeqCtrTrainer
     on the card against the CPU (as phase 3); two full-width passes of
     flagship.FLAGSHIP_BST (BstSeqCtr at the JAX defaults, heads 4, d_head
     8, d_seq 16, MLP 368-64-32-1, over FLAGSHIP's table and batch, slot 0
     the history with up to 20 keys: files of their own, written by the
     spawned writer), each step launching gather_rows twice (the pooled
     pull, the sequence pull) and push_adagrad once over the pooled and
     sequence rows, plus the promote and the two write-backs (32 and 67),
     its digits held to BST_DIGITS, pos_emb and wq moved, the store's show
     column after pass 1 equal to the pooled key occurrences counted from
     the files' text; gather_rows at the sequence pull ([1024, 20] ids)
     and push_adagrad over the concatenated push rows (143,360 + 20,480)
     bit-equal to their plain versions with kernel, plain, index_select
     and bound times; each seqpool variant at a flagship batch on the card
     against the CPU within VARIANT_RTOL; two passes each of FLAGSHIP_SGD
     and FLAGSHIP_DENSE_ADAGRAD (the main path under the dense optimizers
     sgd and adagrad: 32 push_adagrad and 35 gather_rows, digits held to
     SGD_DIGITS and DENSE_ADAGRAD_DIGITS) and the adagrad resume (a
     RecoverableRunner resumed after pass 1 equals one run through: pass 2's
     loss and AUC, dense parameters, accumulators and store bit-equal);
     each pass's wall and examples/s beside the DeepFM main path's, with
     the card line;
 18. the push write modes and the wires: two full-width passes of
     FLAGSHIP through the chunk driver under each of WIRE_RUNS (the full
     wire by scatter, then by rebuild; the uid wire by scatter, rebuild
     and blocked; the delta wire; the ids-only wire; push_write='auto'),
     each held to the first run bit for bit (losses, AUC, the slab's
     sha256 after each pass, the sorted store) and to FLAGSHIP_DIGITS,
     its launches counted (rebuild: one more gather_rows a step; blocked:
     one blocked_write a step) and its host-to-device bytes by leaf
     (profile_pass.count_h2d_bytes); the nan_inf and continue metrics on
     the first run (nan_inf_rate 0, the continue kind's sums equal to the
     AUC kind's within METRIC_RTOL); a sparse_chunk_sync pass on the uid
     wire held to one on the full wire (SYNC_DIGITS, slab, launches);
     gather_rows at the rebuild shape (a batch's new rows spread over the
     2^20-row slab) bit-equal to its plain version with kernel, plain,
     index_select and bound times; the three writes timed against each
     other at the flagship batch and at a chunk of 8 batches
     (push_probe.balanced_write_times), the rule for 'auto' logged and
     held to flags.AUTO_REBUILD_MAX_RATIO;
 19. the SSD tier and the async dense table: FLAGSHIP_SSD (FLAGSHIP's
     table with a 16 MiB host budget in a temporary ssd_dir) through the
     cadence's three passes sequentially (b) and preloaded with the
     prefetcher (a), each against the untiered full rebuild (c) run in the
     same call, in the order c, b, a, a, b, c: losses and AUC equal
     (bit-equality printed), the store after every pass (resident and
     tier rows at their effective values, sorted by key) bit-identical,
     sparse_keys_spilled above 0 every pass, sparse_keys_faulted_in from
     pass 2, sparse_keys_prefetch_faulted in (a), block files on disk, the
     launches of push_adagrad (one a step) and gather_rows (one a step
     and a write-back a pass: every spill drops the residency); the spill
     seconds of each end_pass, the fault-in seconds, each pass's wall
     beside the untiered one's; a test pass over the third window with
     predictions bit-equal to the untiered trainer's; end_day(age=True)
     and load_ssd_to_mem against the untiered day (every row it keeps bit
     for bit; the rows it deleted by their score, which the tier's sweep
     does not read, are the only others); a journaled full save, two
     passes that spill and fault in, a touched save and its load_base by
     journal replay bit-identical to the live store. Then FLAGSHIP_ASYNC
     (sync_mode="async") for two passes: 32 push_adagrad and 35
     gather_rows, the table's steps_applied in [8, 32], the module equal
     to the table's pull after the drain, its AUC within ASYNC_AUC_BAND of
     the main path's; two runs whose pushes wait for the drain, bit-
     identical losses, slab sha256 and table; the async passes' steps
     seconds beside FLAGSHIP's at scan_chunk=1 (the same per-step loop);
 20. the streaming runner and the single-process obs tiers at full width
     (train/streaming_runner.py, data/streaming.py, obs/device.py,
     obs/flight.py, obs/watchdog.py, obs/exporter.py): the cadence's 8
     files of 4,096 lines and a poisoned window (the first two files with
     slot 2's ids all replaced by one id) in a watched directory, in the
     order clean, clean, poisoned, clean, clean, tailed by a
     StreamingRunner with streaming_micro_pass_instances=8192 (five
     windows of 8 batches, one chunk each), push_write 'auto' (scatter on
     the card), a CheckpointManager with the journal on and
     save_base(mode='auto') at the first and the fourth admitted pass.
     Run A has every plane on (the device plane, the watermark, a flight
     recorder, a watchdog at STREAM_WATCHDOG_S, an exporter on an
     ephemeral port scraped after the second boundary): the admit/refuse
     sequence and drift scores (the poisoned one >= 0.8, the others
     below), the refused window's boundary seeing the store and slab
     sha256 of the boundary before it, 32 push_adagrad and 38 gather_rows
     (a pull a step, a write-back a pass, a promote where rows stayed
     resident), each pass's H2D staging bytes in the transfer ledger equal
     to profile_pass.count_h2d_bytes, the ledger's slab owner 71,303,168
     bytes, the scrape's streaming and device series, a watermark record
     a published window (the last born_max the newest file's mtime), the
     last micro-checkpoint's load_base (journal replay) bit-identical to
     the live store, then one injected stall on which the watchdog fires
     once and seals the flight recorder. Run B trains the same four
     windows one PassPreloader + train_pass(preloaded=True) at a time with
     the same micro-checkpoints; run C streams with ObsFlags.off(): losses,
     AUC, stores and slabs bit-identical to A at every boundary. Printed:
     each pass's record, the micro-pass walls, ingest_wait_secs, the
     publish lag, examples/s and the planes' cost (A against C);
 21. the single-process host modules at full width: PBTPU_PUSH_WRITE=
     blocked set while PushFlags is made reaches the trainer (one
     blocked_write a step over files[0], rows bit-equal to scatter, the
     environment restored); FLAGSHIP passes, each a fresh trainer's first
     and held to FLAGSHIP_DIGITS' first pass with 16 push_adagrad and 17
     gather_rows: the text files on the record path, the same pass fed
     from load_into_disk's archive shards and through pipe_command='cat'
     (equal slab sha256), an undumped and a dumped pass (the dump's
     16,384 lines, its extra seconds), train_pass at scan_chunk=1 and
     train_pass_profiled (bit-identical; the stage ms on the card);
     PassTable.pull and push at the flagship batch against their plain
     versions on the same device inputs; the AUC runner on slots 0-3 over
     the text pass's records; lockwatch on and off (on, off, off, on: no
     inversion, the walls); then one pass inside utils/profiler.trace in a
     child process of its own (profile_pass.traced_pass: its first
     torch.profiler session), its kernel events and spans;
 22. the sharded trainer (parallel/sharded_trainer.py) in a child process
     of the spawn context, so that NCCL and the process group never touch
     phases 1-21: world 1 on cuda:0 over NCCL, its rendezvous a TCPStore
     of the child's own on an ephemeral port; flagship.
     build_sharded_trainer at FLAGSHIP's full width (the shard slab 2^20
     rows, KB = 262,144) over the main path's files, two passes through
     the chunk driver in chunks of 8, its seed_fn replaying the main
     path's trainer's seeds: both passes' digits equal to
     FLAGSHIP_DIGITS, the written-back store's sha256 equal to phase 5's,
     SHARDED_LAUNCHES (32 push_adagrad, 35 gather_rows) and 32 each of the
     pull's values a2a, the push rows' a2a and the dense all_reduce, a host
     exchange a step; each pass's wall beside phase 5's; gather_rows over a
     staged batch's 262,144 incoming ids and the fused push_adagrad over
     its 262,144 received push rows, bit-equal to their plain versions,
     with kernel, plain, library and bound times; the three collectives'
     device ms at the step's shapes (time_chain); then FLAGSHIP_BF16 the
     same way on the same mesh (the bf16 slab): its digits equal to
     BF16_DIGITS (phase 12's) and SHARDED_BF16_LAUNCHES (32
     push_adagrad_bf16, 32 gather_rows_decode, 3 gather_rows_2byte);
 23. the sharded trainer's remaining modes, in phase 22's child on the
     same world-1 NCCL mesh after its runs, each a fresh trainer at
     FLAGSHIP's width with the main path's seeds (PHASE23_EXACT): the
     blocked and rebuild writes, the uid, delta and ids-only wires, a 1 x
     1 device_mesh_2d and sync_one_ring one pass each, bit-identical to
     phase 22's first pass (FLAGSHIP_DIGITS, its store sha256), and
     k_step (K = 4) two passes bit-identical to phase 22's run, each with
     its launches (phase23_launches) and collectives; ZeRO-1 and the bf16
     a2a within ZERO1_GATE and BF16_A2A_GATE of FLAGSHIP_DIGITS' first
     pass, the a2as' bytes a step; FLAGSHIP_EXPAND sharded = the
     single-GPU FLAGSHIP_EXPAND pass bit for bit (push_adagrad_expand
     launches); device-collect AUC against the host mode at
     COLLECT_GATES, its two metric reads a pass; a two-pass run_day over
     the sharded trainer (its store_view) = the single-GPU run_day (the
     base's rows and the store, sha256); blocked_write at the shard slab,
     the rebuild gather at the shard's position map, the expand push over
     [262144, 76] and gather_rows at width 82 over 262,144 ids, each
     bit-equal to its plain version (and blocked_write to index_copy_),
     with kernel, plain, library and bound times (blocked_write against
     index_copy_ balanced, as in phase 4) ("sharded23" lines);
 24. the other sharding policies, the hot tier and the shuffled feed, in
     phase 22's child after phase 23, each policy on a world-1 NCCL fleet
     of its own (an exchange serves one policy): table-wise
     (PHASE24_TABLES) one pass bit-identical to phase 22's first, 16
     push_adagrad and 17 gather_rows, every batch through
     rt_bucketize_sharded; the 2-D grid with its hot tier (PHASE24_HOT)
     on the uid wire, two passes bit-identical to phase 22's run, each
     pass's frozen hot keys within PHASE24_HOT_RANGE and the hot ids kept
     off the wire and added back a step; ReplicatedHotTier's lookup =
     store.lookup bit for bit; the shuffled feed (two TcpShufflers on
     threads, the block codec): each rank's records its hash partition
     of the files, the load's seconds and frame bytes beside an
     unshuffled load, rank 0's half trained one pass twice, bit-identical;
     the world-1 trainers' aggregator None; gather_rows over the
     table-wise run's staged incoming ids and the fused push_adagrad over
     the hot run's widened uid vector (untouched hot rows unchanged),
     bit-equal to their plain versions with kernel, plain, library and
     bound times ("sharded24" lines);
 25. the sharded SSD tier, the CPU PS behind the sharded table, the
     Downpour worker and the sequence trainer over an sp group, in phase
     22's child after phase 24, each on a world-1 NCCL fleet of its own at
     full width: (a) FLAGSHIP_SSD through ShardedBoxTrainer over phase
     19's three windows, each pass's digits, store sha256 (resident and
     tier rows) and rows spilled and faulted in equal to phase 19's
     sequential run, its launches equal, then load_ssd_to_mem moving the
     tier back; (b) create_trainer("PSGPUTrainer") over a PsLocalClient
     and over a TcpPSClient to a PSServer on the child's threads, two
     passes each: FLAGSHIP_DIGITS, the server's rows of the pass keys
     hashing to phase 22's store sha256 (the first differing key and
     column printed where not), the two runs bit-identical, store_view
     refused; (c) DownpourTrainer at FLAGSHIP's table, batch and model
     with sync_comm over a PsLocalClient, two passes, run twice: the runs
     bit-identical (digits and a sha256 of the server's sparse rows and
     dense vector), the loss falling, a gather_rows a step and no push
     launch; (d) FLAGSHIP_BST through SeqCtrTrainer over the world-1 sp
     group with ring attention, equal to BST_DIGITS (phase 17's), and
     with Ulysses, equal to the one-shard Ulysses run (no group) bit for
     bit (Ulysses' softmax rounds otherwise than the ring's block update,
     so it is not held to the ring's digits); (e) gather_rows at
     Downpour's per-batch slab [n_uniq + 1, 17] over a batch's 131,072
     ids, bit-equal to its plain version and index_select, with kernel,
     plain, library and bound times ("sharded25" lines);
 26. the stream over the sharded trainer, the model-parallel towers and
     heter offload, in phase 22's child after phase 25 on a world-1 NCCL
     fleet of its own: (a) phase 20's stream (its files, poisoned window,
     window size, base cadence and journal) through StreamingRunner over
     ShardedBoxTrainer with the main path's seeds, equal to phase 20's
     stream over BoxTrainer bit for bit (the windows admitted and refused,
     every micro-pass's digits, the store's and slab's sha256 at every
     boundary, the launches); (b) create_trainer("MeshTowerTrainer") over
     an mp group of one at FLAGSHIP's table, feed and batch, TpDeepFM
     (d_wide 4096, d_mid 128) and EpMMoE (8 experts, d_hidden 64, d_out
     32), two passes twice: the runs bit-identical (digits and the store's
     sha256 after each pass), the loss falling, a pull and a push a step
     (and the promote and write-backs by the table's counters), the first
     pass within TOWER_LOSS_RTOL and TOWER_AUC_ATOL of the same trainer on
     the CPU with show and click equal; TpDeepFM's blocked and rebuild
     passes equal to its scatter pass bit for bit; (c) a HeterDenseService
     on the card (loopback TCP, an ephemeral port) driven by a
     HeterTrainer over a PsLocalClient at FLAGSHIP's table, feed, batch
     and DeepFM, two passes twice: bit-identical (digits, the server's
     rows and the service's dense parameters by sha256), the loss falling,
     the first pass within HETER_LOSS_RTOL of the same run with its
     service on the CPU;
     (d) gather_rows and push_adagrad at a tower batch bit-equal to their
     plain versions (the main path's shapes: no new row);
 27. pipeline parallelism at one stage, in phase 22's child after phase
     26 on a world-1 NCCL fleet of its own (NCCL refuses two ranks on one
     device, so every group has one rank): (a)
     create_trainer("CtrPipelineTrainer") at flagship.FLAGSHIP_PIPE
     (FLAGSHIP's table, feed and batch; 8 micro-batches a step, d_model
     512, 3 layers a stage), two passes twice: the runs bit-identical
     (digits and the store's sha256 after each pass), the loss falling, a
     gather_rows pull and one push_adagrad a step (and the promote and
     write-backs by the table's counters), the first pass within
     PIPE_LOSS_RTOL and PIPE_AUC_ATOL of the same runner on the CPU with
     show and click equal; (b) the same through make_mesh(MeshConfig(
     data=1, pipeline=1)), the (dp, stage) form, equal to (a) bit for bit;
     (c) one pass on FLAGSHIP_EXPAND's expand-64 table twice, bit for bit,
     push_adagrad_expand launched a step; (d)
     create_trainer("PipelineTrainer") at FLAGSHIP_PIPE's widths: forward
     = sequential_forward bit for bit, GPIPE_STEPS steps lowering the
     loss; (e) gather_rows and push_adagrad at the pipeline step's shape
     (the first group's 1,048,576 ids and its push rows), and gather_rows
     and push_adagrad_expand at the expand table's (the same ids from the
     2^20 x 82 slab, push rows of width 76), bit-equal to their plain
     versions, with kernel, plain, library and bound times ("pipe27"
     lines; the kernels line's pipeline_step and pipeline_expand shapes);
     then phase 28, the pipeline over the sharded table, after them on a
     world-1 NCCL fleet of its own (P = S = dp = 1: NCCL refuses two ranks
     on one device; the world group still carries both all-to-alls): (a)
     create_trainer("ShardedCtrPipelineTrainer") through
     flagship.build_sharded_pipeline at FLAGSHIP_PIPE, two passes twice
     with phase 27's seeds: the runs bit-identical, the loss falling, both
     passes equal to phase 27 (a)'s digits and store sha256 (the shard is
     the whole table: the bucket merge and the owner's dedup keep the
     replicated runner's numbers), a pull and a push a step by the
     launch counts (and the promote and write-backs), the pull's and the
     push's all-to-alls and one host exchange a step by collective_counts;
     (b) a pass each under push_write blocked (blocked_write a step) and
     rebuild (one more gather_rows a step), each = (a)'s first pass; (c)
     one pass on the expand-64 table = phase 27 (c), push_adagrad_expand a
     step; (d) create_trainer("SectionPSTrainer") over a PsLocalClient,
     two passes = (a), the server's rows of the pass keys hashing to (a)'s
     store sha256; (e) gather_rows over a staged step's 2,097,152 served
     ids, the push over its 2,097,152 received rows, blocked_write of its
     new rows and the rebuild write's gather of them at the step's
     [2^20] position map, and on the expand-64 table's step gather_rows
     at width 82 over its served ids and push_adagrad_expand over its
     received rows of width 76, each bit-equal to its plain version, with
     kernel, plain, library and bound times (blocked_write against
     index_copy_ balanced, as in phase 4) ("pipe28" lines; the kernels
     line's pipeline_shard_step, pipeline_shard_rebuild and
     pipeline_shard_expand shapes);
 29. train to serve (paddlebox_tpu_torch/serving/: no kernel and no
     device of its own; its kernels are the trainer's), in the parent after
     phase 28's child: (a) a fresh interpreter imports the serving plane
     and loads no torch, no JAX, no paddlebox_tpu and not the port's
     trainer (its seconds printed); (b) phase 7's day (the base and three
     deltas of day0): build_stack answers every key of its views and
     SERVE_ABSENT absent keys bit-equal to XboxModelReader (the absent ones
     zero rows), and a ServingServer through a ServingClient at
     SERVE_BATCH keys a pull gives the same bits; (c) a fresh FLAGSHIP
     trainer trains the main path's two passes while a ServingServer with
     its refresh watcher (serving_refresh_secs SERVE_REFRESH_S) serves the
     xbox root its CheckpointManager writes, a base of day0 before the
     first pass and a delta of day1 after each: within SERVE_DEADLINE_S of
     a delta's DONE the server answers its rows bit for bit one generation
     up, and the pass's keys as XboxModelReader composes them (the seconds
     from DONE to the first pull that saw it printed); the digits equal the
     main path's and the store too but for the delta scores the saves
     clear (trained_sha); push_adagrad once a step, gather_rows once a step
     and at each promote and write-back (the save's stat rewrite drops the
     residency, so the second pass builds in full where the main path
     promotes: 34 launches, not 35); (d) a synthetic base of SERVE_KEYS x
     SERVE_DIM (numpy, SERVE_SEED; tools/serving_load_probe.py's default)
     served by MultiBoxFleet(boxes=2, replicas=2) under key-mod with
     SERVE_HOT replicated keys: no replica maps libtorch; FleetClient pulls
     of hits, hot keys and misses bit-equal to one MmapViewStack; keys/s
     and the window's p50 and p99 of serving_lookup_us over SERVE_LOAD_S
     of pulls (host measurements, printed with the card line); a delta of
     day1 landing under pullers: no box's response mixes two generations,
     no fleet row is of neither; one replica of box 0 killed, every pull
     still answers bit-equal; an ObsExporter's /health carries the fleet's
     serving_fleet section until close; (e) a two-window stream at phase
     20's shape, its live journal tailed by a JournalDeltaSource: the
     overlay equals the stream's store projected by xbox_embed_cols for
     every touched key, its watermark the newest file's mtime, stamped
     into a ServingServer's pull (phase 20's own journal directory holds
     no rows by then: its journal-mode micro-checkpoint moved them into the
     snapshot); each leg's seconds;
 30. the user entry points (paddlebox_tpu_torch/examples/), in the parent
     after phase 29, on the card with no CPU fallback: (a) train_ctr's demo
     leg for DEMO_PASSES passes at its defaults and at --push-write
     rebuild, each held to the same demo's CPU run (in the spawned writer
     process meanwhile) under phase 3's limits (loss rtol 1e-4, AUC 1e-4
     absolute), auto resolved to scatter on the card, push_adagrad once a
     step and gather_rows once a step (twice under rebuild) and at each
     write-back; (b) pull_sparse_differentiable at the flagship pull's
     shape (a 2^20 x 17 slab, PULL_IDS ids drawn from [0, PULL_ID_RANGE)):
     its forward bit-equal to slab[ids]'s pull view, one gather_rows
     launch, its backward bit-equal to pull_view_grad on the CPU; then at
     negative ids (a third of them moved into [-C, 0), a seventh below -C,
     one the int32 minimum) its forward and slab gradient bit-equal to the
     CPU's and gather_rows on the raw ids bit-equal to its plain version
     (the kernel's lower clamp), two launches; (c) the
     reader pool on the main path's files: read_threads=4 loads the
     read_threads=1 load byte for byte (block, add_keys_fn calls), both
     loads' seconds in cadence_probe.BALANCED's order of the two (no
     claim); (d) the other seven demos once at world 1: train_aux_input,
     train_downpour, serve_xbox and stream_train_serve in process,
     train_sharded, train_pipeline and train_mesh_tower each through
     fleet/launch.py --nproc 1 over NCCL (started at the phase's start,
     DEMO_WALL_S each), every demo's printed lines checked;
 31. the no-CVM main path (train/flagship.py FLAGSHIP_NO_CVM: CtrDnn
     512-256-128 on the flagship's table, batch and files, BoxTrainer
     use_cvm=False, no data_norm), in the parent after phase 30: its two
     passes NO_CVM_RUNS times on the card, bit-identical run to run (loss,
     AUC, launches, the sorted store's sha256), each run's launches
     push_adagrad once a step and gather_rows once a step and at each
     promote and write-back (32 and 35) and no other kernel; the first
     run's loss within NO_CVM_LOSS_RTOL and AUC within NO_CVM_AUC_ATOL of
     the same two passes on the CPU (in the spawned writer meanwhile); at
     one step of the last run's trainer on a seeded 2^20 x 17 slab, its
     pooled tensor [1024, 32, 9] bit-equal to columns 2: of the CVM pool of
     the same pulled rows;
 10. (run after phase 3) the rate probe
     (paddlebox_tpu_torch/rate_probe.py): its cases on the
     kernels, their plain versions and the PyTorch ops, each line with ms,
     GB/s and the share of 3.35 TB/s; scale_copy and gather_rows launched
     in it. Its 64 MiB scale (with the 256 MiB one under at_shapes) and
     its pull-shape gather are those two kernels' times in the kernels
     line.

Every time is device time from rate_probe.time_chain (CUDA events around
a chain of launches queued behind a spin of the card, inputs rotated over
copies so that L2 does not hold them). Then one JSON line with every
kernel's numbers, the card's name and power limit, and the last line
{"ok": true, "device": {...}}.
"""

import collections
import dataclasses
import json
import multiprocessing
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor


class PhaseClock:
    """Host-clock seconds of the script's phases, in order."""

    def __init__(self):
        self.laps = {}
        self._t0 = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self._t0
        self._t0 = now


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def log(*parts):
    print(*parts, flush=True)


def run_pass(torch, trainer, ds, load=False):
    """One train_pass, timed to the card's end; with ``load`` (phase 16's
    record-path feeds) the pass is flagship.load_pass (the feed, then the
    records' pv fields or cache indices) and train_pass(preloaded=True),
    timed together."""
    t0 = time.perf_counter()
    if not load:
        res = trainer.train_pass(ds)
    else:
        from paddlebox_tpu_torch.train import flagship
        flagship.load_pass(trainer, ds)
        res = trainer.train_pass(ds, preloaded=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    auc = trainer.metrics.get_metric_msg("auc")["auc"]
    return res, auc, secs


def push_check(torch, slab, g, u, p, o, n_uniq, created, layout, conf,
               seed):
    """The fused push kernel against its plain version in both write
    modes, from the same slab (f32, or the bf16 slab's int16 under a bf16
    ``layout``); the rows of ``created`` uids must get embedx. Returns the
    largest difference of the (decoded) rows."""
    from paddlebox_tpu_torch.copy_probe import bit_equal
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding import push_kernels as pk

    D = layout.embedx_dim

    def dec(t):
        return acc.decode_slab_rows(t, layout)

    err = 0.0
    at = torch.searchsorted(u[:n_uniq], created)
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        got = pk.push_adagrad(s_k, g, p, o, u, n_uniq, seed, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        want = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, seed,
                                           layout, conf, rows_out)
        check(bit_equal(s_k, s_p), "push_adagrad (rows_out=%s, %s) slab "
              "differs from the plain version"
              % (rows_out, layout.embed_dtype))
        err = max(err, float((dec(s_k) - dec(s_p)).abs().max()))
        if rows_out:
            check(bit_equal(s_k, slab), "push_adagrad rows_out wrote the "
                  "slab")
            check(bit_equal(got, want), "push_adagrad rows out differ from "
                  "the plain version")
            err = max(err, float((dec(got) - dec(want)).abs().max()))
            made = dec(got[at])[:, acc.MF_SIZE]
        else:
            made = dec(s_k[created.long()])[:, acc.MF_SIZE]
        check(bool((made == D).all()), "push_adagrad did not create "
              "embedx on every created row")
        del s_k, s_p, got, want
    return err


def push_width_cases(torch, dev, layouts):
    """push_check of each of ``layouts`` (the adagrad table at every embedx
    width the kernel is built for, or the other rules' instantiations) on
    a small batch with a hot key and a padding tail (rows with mf_size 0
    create embedx); returns the largest difference."""
    import numpy as np

    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding.accessor import PushLayout
    from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                          segment_offsets)
    from paddlebox_tpu_torch.push_probe import SEED
    from paddlebox_tpu_torch.train import flagship

    conf = flagship.FLAGSHIP.table().optimizer
    err = 0.0
    for lay in layouts:
        # rows uniform in [0, 1): every rule's state is in its range (adam
        # powers below 1, second moments positive)
        d, rs = lay.embedx_dim, np.random.RandomState(lay.embedx_dim
                                                      + lay.expand_dim)
        push = PushLayout.of(lay)
        cap, k = 4096, 3000
        w_ids = rs.randint(0, 1500, k).astype(np.int32)
        w_ids[:400] = 7
        w_ids[k - 300:] = cap - 1
        w_uids, w_perm, w_inv, w_n = dedup_ids(w_ids, cap)
        w_slab = rs.rand(cap, lay.width).astype(np.float32)
        w_slab[:, acc.MF_SIZE] = np.where(rs.rand(cap) < 0.5, d, 0)
        w_grads = (rs.randn(k, push.width) * 0.2).astype(np.float32)
        w_grads[:, push.SHOW] = rs.randint(0, 2, k)
        w_grads[:, push.CLICK] = rs.randint(0, 2, k)
        w_grads[k - 300:] = 0.0
        made = np.unique(w_ids[(w_grads[:, push.SHOW] > 0)
                               & (w_slab[w_ids, acc.MF_SIZE] == 0)])
        err = max(err, push_check(
            torch, device_slab(torch, w_slab, lay, dev),
            *(torch.from_numpy(x).to(dev) for x in (
                w_grads, w_uids, w_perm, segment_offsets(w_inv, k - 300))),
            w_n, torch.from_numpy(made.astype(np.int32)).to(dev), lay, conf,
            SEED))
    return err


def device_slab(torch, rows, layout, dev):
    """Host f32 rows as ``layout``'s slab on ``dev``."""
    from paddlebox_tpu_torch.embedding.accessor import slab_rows_np
    return torch.from_numpy(slab_rows_np(rows, layout)).to(dev)


BLOCKED_ROUNDS = 5   # rounds of the f32 blocked_write against index_copy_


def blocked_balanced(kernel_args, library_args, nbytes):
    """The f32 blocked_write (A) against index_copy_ of the same rows at
    their uids (B), BLOCKED_ROUNDS rounds of A, B, B, A
    (rate_probe.balanced_rounds, its lines kept out of the log): (the
    kernel's median ms, index_copy_'s, the per-round ratios A / B)."""
    import contextlib
    import io

    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.rate_probe import balanced_rounds, quartiles

    with contextlib.redirect_stdout(io.StringIO()):
        got = balanced_rounds({"blocked_write": (
            ("blocked_write", pk.blocked_write, kernel_args, nbytes),
            ("index_copy_", lambda s, i, r: s.index_copy_(0, i, r),
             library_args, nbytes))}, BLOCKED_ROUNDS,
            "case")["blocked_write"]
    return (quartiles(got["A"])["median"], quartiles(got["B"])["median"],
            got["ratios"])


def kernel_phase(torch, cfg, feed, files, dev):
    """Phase 4, the push kernels against their plain versions at the main
    path's shapes; returns their records (launches filled later)."""
    import numpy as np

    from paddlebox_tpu_torch.copy_probe import blocked_case
    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                          segment_offsets)
    from paddlebox_tpu_torch.push_probe import (SEED, fused_push_bytes,
                                                push_inputs)
    from paddlebox_tpu_torch.rate_probe import time_chain

    D = cfg.embedx
    layout, push = ValueLayout(D), PushLayout(D)
    conf = cfg.table().optimizer
    W, G = layout.width, push.width
    C = cfg.capacity

    def bit_equal(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    # --- push_adagrad, fused: a real flagship batch's dedup on a 2^20-row
    # slab; its keys' rows a third each to create (mf_size 0), to update and
    # inactive (all their push rows zero, as the padding's are)
    inp = push_inputs(cfg, files, feed)
    ids, live, kind = inp["ids"], inp["live"], inp["kind"]
    K, n_uniq, n_valid = ids.shape[0], inp["n_uniq"], inp["n_valid"]
    slab, g, p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["slab"], inp["grads"], inp["perm"],
        segment_offsets(inp["inv"], n_valid), inp["uids"]))
    del inp
    seed = SEED

    created = torch.from_numpy(
        np.unique(ids[live & (kind[ids] == 0)]).astype(np.int32)).to(dev)
    push_err = push_check(torch, slab, g, u, p, o, n_uniq, created, layout,
                          conf, seed)
    # a hot key: one key in the batch's first 1,000 slots, a run longer
    # than a tile's staged occurrences, summed from global memory
    hot = ids.copy()
    check(bool((hot[:1000] != C - 1).all()), "flagship batch padding first")
    hot[:1000] = hot[0]
    h_uids, h_perm, h_inv, h_n = dedup_ids(hot, C)
    h_off = segment_offsets(h_inv, n_valid)
    check(int(np.diff(h_off).max()) >= 1000, "no hot run")
    push_err = max(push_err, push_check(
        torch, slab, g, *(torch.from_numpy(x).to(dev)
                          for x in (h_uids, h_perm, h_off)), h_n,
        created[:0], layout, conf, seed))
    push_err = max(push_err, push_width_cases(
        torch, dev, [ValueLayout(d) for d in pk.KERNEL_EMBEDX_DIMS]))
    log("push_adagrad fused: bit-equal to the plain version in both write "
        "modes at the flagship batch, with a %d-occurrence hot key, and at "
        "embedx widths %s" % (int(np.diff(h_off).max()),
                              list(pk.KERNEL_EMBEDX_DIMS)))
    push_bytes = fused_push_bytes(n_valid, n_uniq, W, G)
    push_ops = n_valid * G + int(np.unique(ids[live]).size) * (20 + 6 * D)
    push_bound = 1e3 * max(push_bytes / HBM_BYTES_PER_S,
                           push_ops / F32_FLOPS)
    args = (slab, g, p, o, u)
    push_ms = time_chain(
        lambda *a: pk.push_adagrad(*a, n_uniq, seed, layout, conf,
                                   rows_out=True), args, push_bytes)
    push_plain_ms = time_chain(
        lambda *a: pk.push_adagrad_fused_plain(*a, n_uniq, seed, layout, conf,
                                               rows_out=True), args,
        push_bytes)
    # in place the rows compound from launch to launch (created rows are
    # updated by the next launch): the same bytes, other arithmetic
    push_inplace_ms = time_chain(
        lambda *a: pk.push_adagrad(*a, n_uniq, seed, layout, conf), args,
        push_bytes)
    log("push_adagrad fused, K=%d n_valid=%d n_uniq=%d: rows out %.4f ms "
        "(in place %.4f ms), plain %.4f ms, bound %.4f ms (%d B)"
        % (K, n_valid, n_uniq, push_ms, push_inplace_ms, push_plain_ms,
           push_bound, push_bytes))
    del slab, g, p, o, args

    # --- blocked_write: the same batch's sorted uids on a 2^20-row slab,
    # its n_uniq rows as the fused push returns them; blocked_case holds
    # the kernel bit-equal to index_copy_ of the same rows
    blk = blocked_case(ids, C, W, dev)
    slab0, new_rows, row_map, blk_idx = blk["args"]
    s_k, s_p = slab0.clone(), slab0.clone()
    pk.blocked_write(s_k, new_rows, row_map, blk_idx)
    torch.cuda.synchronize()
    pk.blocked_write_plain(s_p, new_rows, row_map, blk_idx)
    check(bit_equal(s_k, s_p), "blocked_write differs from the plain version")
    blk_err = max(float((s_k - s_p).abs().max()),
                  blocked_edge_phase(torch, dev))
    blk_bytes = blk["bytes"]
    blk_args = (s_k, new_rows, row_map, blk_idx)
    blk_ms, blk_lib_ms, blk_ratios = blocked_balanced(
        blk_args, blk["library_args"], blk_bytes)
    blk_plain_ms = time_chain(pk.blocked_write_plain, blk_args, blk_bytes)
    blk_bound = 1e3 * blk_bytes / HBM_BYTES_PER_S
    log("blocked_write NB=%(NB)d B=%(B)d placed=%(placed)d: " % blk["info"]
        + "kernel %.5f ms, index_copy_ %.5f ms (medians of %d rounds A, B, "
        "B, A; kernel / index_copy_ a round: %s), plain %.4f ms, bound "
        "%.5f ms (%d B)" % (blk_ms, blk_lib_ms, BLOCKED_ROUNDS,
                            ", ".join("%.4f" % r for r in blk_ratios),
                            blk_plain_ms, blk_bound, blk_bytes))
    return [
        {"name": "push_adagrad", "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/push_adagrad.cu",
         "replaces": "paddlebox_tpu/embedding/pallas_push.py:41",
         "launches": None, "max_abs_err": push_err, "ms": push_ms,
         "plain_ms": push_plain_ms, "bound_ms": push_bound,
         "bound_by": ("bytes" if push_bytes / HBM_BYTES_PER_S
                      >= push_ops / F32_FLOPS else "operations"),
         "library_ms": None},
        {"name": "blocked_write", "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/blocked_write.cu",
         "replaces": "paddlebox_tpu/embedding/pallas_push.py:111",
         "launches": None, "max_abs_err": blk_err, "ms": blk_ms,
         "plain_ms": blk_plain_ms, "bound_ms": blk_bound,
         "bound_by": "bytes", "library_ms": blk_lib_ms,
         "library_ratios": blk_ratios},
    ]


def on_card(torch, a, offset, dev):
    """numpy ``a`` on the card, ``offset`` elements into a larger buffer
    (offset 1: not 16-byte aligned)."""
    t = torch.from_numpy(a.copy())
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def blocked_edge_phase(torch, dev):
    """Phase 4, blocked_write on its edge cases (edge_cases.
    blocked_edge_cases), in the cases' slot order and reversed (sentinel
    slots after the real write of their block), over many sparse tiles
    and at a step of 8 flagship batches' density: bit-equal to the plain
    version. Returns the largest difference."""
    from paddlebox_tpu_torch.edge_cases import blocked_edge_cases
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import blocked_layout

    err = 0.0
    cases = blocked_edge_cases()
    for label, (slab, new_rows, row_map, blk_idx, off) in cases.items():
        s0, nr = (torch.from_numpy(x).to(dev) for x in (slab, new_rows))
        for order in ("as given", "reversed"):
            flip = slice(None, None, -1 if order == "reversed" else 1)
            rm = on_card(torch, row_map[flip], off, dev)
            bi = torch.from_numpy(blk_idx[flip].copy()).to(dev)
            s_k, s_p = s0.clone(), s0.clone()
            pk.blocked_write(s_k, nr, rm, bi)
            torch.cuda.synchronize()
            pk.blocked_write_plain(s_p, nr, rm, bi)
            check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
                  "blocked_write differs from the plain version on %s "
                  "(slots %s)" % (label, order))
            err = max(err, float((s_k - s_p).abs().max()))
    # many tiles a persistent block (3,072,000 lanes, about 3,000 tiles),
    # sparse slots and sentinel slots among them
    gen = torch.Generator(device=dev).manual_seed(10)
    NB, B = 6000, 512
    mask = torch.rand((NB, B), generator=gen, device=dev) < 0.02
    mask[::7] = False
    row_map = torch.full((NB, B), -1, dtype=torch.int32, device=dev)
    n = int(mask.sum())
    row_map[mask] = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32)
    blk_idx = torch.randperm(NB + 100, generator=gen, device=dev)[:NB].to(
        torch.int32)
    s_k = torch.rand((NB + 100) * B, 17, generator=gen, device=dev)
    s_p = s_k.clone()
    nr = torch.rand(n, 17, generator=gen, device=dev)
    pk.blocked_write(s_k, nr, row_map, blk_idx)
    torch.cuda.synchronize()
    pk.blocked_write_plain(s_p, nr, row_map, blk_idx)
    check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
          "blocked_write differs from the plain version over many tiles")
    # a step of 8 flagship batches' density: 410,407 sorted rows of a 2^20
    # x 17 slab in 1024 slots (blocked_layout: one run of sources a tile,
    # the padding tail left out), and the same lanes' sources permuted
    C = 1 << 20
    uids = torch.sort(torch.randperm(C - 1, generator=gen, device=dev)[
        :410407]).values.to(torch.int32)
    uids = torch.cat([uids, torch.arange(C, C + 64, dtype=torch.int32,
                                         device=dev)])
    row_map, blk_idx = blocked_layout(uids, C, 1024)
    placed = row_map >= 0
    permuted = row_map.clone()
    permuted[placed] = row_map[placed][torch.randperm(
        int(placed.sum()), generator=gen, device=dev)]
    slab = torch.rand((C, 17), generator=gen, device=dev)
    nr = torch.rand((uids.shape[0], 17), generator=gen, device=dev)
    for label, rm in (("one run a tile", row_map), ("permuted", permuted)):
        s_k, s_p = slab.clone(), slab.clone()
        pk.blocked_write(s_k, nr, rm, blk_idx)
        torch.cuda.synchronize()
        pk.blocked_write_plain(s_p, nr, rm, blk_idx)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
              "blocked_write differs from the plain version at 410,407 "
              "rows (%s)" % label)
    log("blocked_write: bit-equal to the plain version on %d edge cases "
        "%s, slots as given and reversed, over %d slots of %d lanes, and at "
        "410,407 rows of 2^20 in 1024 slots, one run of sources a tile and "
        "permuted" % (len(cases), sorted(cases), NB, B))
    return err


def gather_edge_phase(torch, dev):
    """Phase 4, gather_rows on its edge cases (edge_cases.
    gather_edge_cases): bit-equal to the plain version."""
    from paddlebox_tpu_torch.edge_cases import (gather_edge_cases,
                                                gather_source)
    from paddlebox_tpu_torch.ops import row_kernels as rk

    cases = gather_edge_cases()
    for label, (flat, off, C, W, ids) in cases.items():
        src = gather_source(torch.from_numpy(flat).to(dev), off, C, W)
        i = torch.from_numpy(ids).to(dev)
        got = rk.gather_rows(src, i)
        torch.cuda.synchronize()
        want = rk.gather_rows_plain(src, i)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              "gather_rows differs from the plain version on %s" % label)
    # many tiles a persistent block: 2^20 ids, about 16,000 tiles
    gen = torch.Generator(device=dev).manual_seed(11)
    for W in (17, 32):
        src = torch.rand((3000, W), generator=gen, device=dev)
        i = torch.randint(0, 3040, (1 << 20,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = rk.gather_rows(src, i)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32),
                          rk.gather_rows_plain(src, i).view(torch.int32)),
              "gather_rows differs from the plain version over many tiles "
              "(W %d)" % W)
    log("gather_rows: bit-equal to the plain version on %d edge cases "
        "(K, W, source offset): %s, and on 2^20 ids at W 17 and 32"
        % (len(cases), sorted(cases)))


def scale_once(torch, rk, x):
    """scale_copy(x), synchronized; checks that it launched once."""
    before = rk.scale_copy.launches
    got = rk.scale_copy(x)
    torch.cuda.synchronize()
    check(rk.scale_copy.launches == before + 1,
          "scale_copy launched %d times in one call"
          % (rk.scale_copy.launches - before))
    return got


def scale_edge_phase(torch, dev):
    """Phase 4, scale_copy on its edge cases (edge_cases.scale_edge_cases:
    x 0, 4, 8 and 12 bytes into its buffer, n around the kernel's block
    and into a second wave of blocks): one launch each, bit-equal to the
    plain version."""
    from paddlebox_tpu_torch.edge_cases import gather_source, scale_edge_cases
    from paddlebox_tpu_torch.ops import row_kernels as rk

    cases = scale_edge_cases()
    for label, (flat, off, rows, W) in cases.items():
        x = gather_source(torch.from_numpy(flat).to(dev), off, rows, W)
        got = scale_once(torch, rk, x)
        check(torch.equal(got.view(torch.int32),
                          rk.scale_copy_plain(x).view(torch.int32)),
              "scale_copy differs from the plain version on %s" % label)
    log("scale_copy: one launch each, bit-equal to the plain version on %d "
        "edge cases (n, byte offset): %s" % (len(cases), sorted(cases)))


def row_kernel_phase(torch, cfg, feed, files, keys, dev):
    """Phase 4, the rate probe's kernels against their plain versions:
    scale_copy at the probe's 64 and 256 MiB shapes and on its edge cases
    (one launch a call), gather_rows at the probe's
    shape, at the pull's (a real batch's ids, the trash row included) and
    at the delta promote's and the touched-row write-back's (from the
    cadence's key sets ``keys``); all bit-equal. Returns each kernel's
    max_abs_err, and gather_rows' times at the promote and write-back
    shapes; the other times come from the rate probe's phase."""
    import numpy as np

    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import sorted_member
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain
    from paddlebox_tpu_torch.train import flagship

    gen = torch.Generator(device=dev).manual_seed(6)

    def bit_equal(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    # --- scale_copy over f32 [131072, 128] and [524288, 128] (64 and 256
    # MiB), then on its edge cases
    errs = {"scale_copy": 0.0}
    gen_256 = torch.Generator(device=dev).manual_seed(13)
    for rows, g in ((1 << 17, gen), (1 << 19, gen_256)):
        x = torch.rand((rows, 128), generator=g, device=dev)
        got = scale_once(torch, rk, x)
        want = rk.scale_copy_plain(x)
        check(bit_equal(got, want), "scale_copy %s differs from the plain "
              "version" % list(x.shape))
        errs["scale_copy"] = max(errs["scale_copy"],
                                 float((got - want).abs().max()))
        log("scale_copy %s: one launch, bit-equal to the plain version"
            % list(x.shape))
        del x, got, want
    scale_edge_phase(torch, dev)

    # --- gather_rows at the probe's shape and at the pull's
    C, K = cfg.capacity, 131072
    pull_ids = flagship.first_batch_ids(files, feed, cfg)
    shapes = {
        "probe": (torch.rand((C, 128), generator=gen, device=dev),
                  torch.randperm(C - 1, generator=gen, device=dev)[:K]
                  .sort().values.to(torch.int32)),
        "pull": (torch.rand((C, ValueLayout(cfg.embedx).width),
                            generator=gen, device=dev),
                 torch.from_numpy(pull_ids).to(dev)),
    }
    for label, (src, ids) in shapes.items():
        got = rk.gather_rows(src, ids)
        torch.cuda.synchronize()
        want = rk.gather_rows_plain(src, ids)
        lib = src.index_select(0, ids)
        check(bit_equal(got, want) and bit_equal(got, lib),
              "gather_rows at the %s shape differs from the plain version"
              % label)
        if label == "pull":
            errs["gather_rows"] = float((got - want).abs().max())
        log("gather_rows %s shape src %s, %d ids (%d distinct): bit-equal "
            "to the plain version and index_select"
            % (label, list(src.shape), ids.shape[0],
               int(ids.unique().numel())))
        del got, want, lib
    del shapes, src, ids

    # --- gather_rows at the cadence's second pass's delta promote (its
    # keys' rows in the first pass's slab; a miss reads row 0, as
    # pass_table.delta_promote gives it) and at the first pass's touched-row
    # write-back (every pass row is touched)
    W = ValueLayout(cfg.embedx).width
    slab = torch.rand((C, W), generator=gen, device=dev)
    pos, hit = sorted_member(keys[0], keys[1])
    at_shapes = {}
    for label, ids_np in (
            ("promote", np.where(hit, pos, 0).astype(np.int32)),
            ("writeback", np.arange(keys[0].size, dtype=np.int32))):
        ids = torch.from_numpy(ids_np).to(dev)
        got = rk.gather_rows(slab, ids)
        torch.cuda.synchronize()
        want = rk.gather_rows_plain(slab, ids)
        check(bit_equal(got, want), "gather_rows at the %s shape differs "
              "from the plain version" % label)
        errs["gather_rows"] = max(errs["gather_rows"],
                                  float((got - want).abs().max()))
        del got, want
        nbytes = gather_bytes(ids_np, C, W)
        args = (slab, ids)
        rec = {"ids": int(ids_np.size),
               "distinct": int(np.unique(ids_np).size), "bytes": nbytes,
               "ms": time_chain(rk.gather_rows, args, nbytes),
               "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
               "library_ms": time_chain(lambda a, b: a.index_select(0, b),
                                        args, nbytes),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        at_shapes[label] = rec
        log("gather_rows %s shape src %s: bit-equal to the plain version; "
            "%s" % (label, list(slab.shape), json.dumps(rec)))
    gather_edge_phase(torch, dev)
    return errs, at_shapes


def row_kernel_records(probe, errs, at_shapes, cfg):
    """The rate probe's kernels' records, from the probe's cases at the
    shapes of their paths: scale_copy at 64 MiB (library: the one-call
    torch_scale), with its times at 256 MiB under ``at_shapes``,
    gather_rows at the pull's (library: index_select), with its times at
    the promote and write-back shapes under ``at_shapes``."""
    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout

    by_op = {r["op"]: r for r in probe}
    W = ValueLayout(cfg.embedx).width
    out = []
    for name, src, line, kcase, tcase in (
            ("scale_copy", "scale_copy.cu", 54, "kernel_scale_64MB",
             "torch_scale_64MB"),
            ("gather_rows", "gather_rows.cu", 70, "kernel_gather_pull_W%d" % W,
             "torch_gather_pull_W%d" % W)):
        k, t = by_op[kcase], by_op[tcase]
        out.append({"name": name, "route": "cuda",
                    "source": "paddlebox_tpu_torch/csrc/" + src,
                    "replaces": "tools/pallas_rate_probe.py:%d" % line,
                    "launches": None, "max_abs_err": errs[name],
                    "ms": k["ms_per_call"], "plain_ms": k["plain_ms"],
                    "bound_ms": 1e3 * k["bytes"] / HBM_BYTES_PER_S,
                    "bound_by": "bytes", "library_ms": t["ms_per_call"]})
    k, t = by_op["kernel_scale_256MB"], by_op["torch_scale_256MB"]
    out[0]["at_shapes"] = {"256MB": {
        "shape": k["shape"][0], "bytes": k["bytes"], "ms": k["ms_per_call"],
        "plain_ms": k["plain_ms"], "library_ms": t["ms_per_call"],
        "bound_ms": 1e3 * k["bytes"] / HBM_BYTES_PER_S}}
    out[-1]["at_shapes"] = at_shapes
    return out


def small_parity_phase(torch, tmp):
    """Phase 3: the port on the card against the port on the CPU (plain
    versions) at a narrow size; loss rtol 1e-4, AUC 1e-4 absolute, host
    rows rtol 1e-4 (float32 sums in another order on the two devices)."""
    import numpy as np

    from paddlebox_tpu_torch.train import flagship
    small = dataclasses.replace(
        flagship.FLAGSHIP, num_slots=4, batch=32, max_len=3, hidden=(16, 8),
        capacity=1024, num_files=2, lines_per_file=96, vocab_per_slot=60,
        data_seed=7)
    files, feed = flagship.write_files(os.path.join(tmp, "small"), small)
    out = {}
    for device in ("cuda", "cpu"):
        t, ds = flagship.build_trainer(files, feed, small, "scatter", device)
        res = [run_pass(torch, t, ds)[:2] for _ in range(2)]
        out[device] = (res, t.table.store.lookup(t.table.pass_keys))
    for (rc, ac), (rp, ap) in zip(out["cuda"][0], out["cpu"][0]):
        check(np.isfinite(rc["loss"]) and abs(rc["loss"] - rp["loss"])
              <= 1e-4 * abs(rp["loss"]), "small-input loss cuda %r vs cpu "
              "%r" % (rc["loss"], rp["loss"]))
        check(abs(ac - ap) <= 1e-4, "small-input AUC cuda %r vs cpu %r"
              % (ac, ap))
    check(np.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6),
          "small-input host rows differ between cuda and cpu")
    log("small-input parity cuda vs cpu: losses %s / %s"
        % ([r["loss"] for r, _ in out["cuda"][0]],
           [r["loss"] for r, _ in out["cpu"][0]]))


# the main path's losses and AUC (two passes, "%.10f"), unchanged since the
# port's first slice
FLAGSHIP_DIGITS = {"loss": ("0.6866484880", "0.5655780435"),
                   "auc": ("0.4971680564", "0.7351465576")}

# the test pass's AUC (the day phase: the main path's two passes, then
# predict_batches over the cadence's third window), "%.10f"
TEST_PASS_DIGITS = "0.5307661885"

# the flagship cadence's data at seed 0 (train/flagship.py write_cadence):
# each pass's key count, and for passes 1 and 2 the keys resident from the
# pass before, the new rows, and of those the rows the host store holds
FLAGSHIP_CADENCE = {"n": (557083, 557074, 557451), "hit": (504026, 504467),
                    "new": (53048, 52984), "prefetchable": (0, 33957)}


NATIVE_TIER = {"dataset": "columnar", "store": "NativeHostEmbeddingStore"}


def sorted_store(table):
    """The table's host store as (keys, rows), sorted by key."""
    import numpy as np
    k, v = table.store.state_items()
    order = np.argsort(k)
    return k[order], v[order]


def main_passes(torch, trainer, ds, after_pass=None, load=False):
    """The main path's two train_passes (run_pass, ``load`` as there): each
    pass's record with the table's counters of the pass;
    ``after_pass(record)``, when given, runs after each pass and may add
    to its record."""
    import numpy as np
    passes = []
    for p in range(2):
        before = dict(trainer.table.counters)
        res, auc, secs = run_pass(torch, trainer, ds, load)
        check(np.isfinite(res["loss"]) and np.isfinite(auc)
              and 0.0 < auc <= 1.0,
              "pass %d loss %r auc %r" % (p, res["loss"], auc))
        passes.append({"pass": p, "loss": res["loss"], "auc": auc,
                       "batches": res["batches"],
                       "instances": res["instances"], "pass_s": secs,
                       "examples_per_s": res["instances"] / secs,
                       "phase_s": trainer.pass_times,
                       "counters": counter_delta(before, trainer.table)})
        if after_pass is not None:
            after_pass(passes[-1])
    return passes


def plain_tier_phase(torch, cfg, feed, files, native, native_store):
    """Phase 5, the plain host tier: the main path's two passes with the
    record-path dataset and the Python store (the route index stays),
    held bit-equal to the native run's ``native`` passes and sorted store
    ``native_store``. Logs both tiers' pass phases beside the card
    line."""
    import numpy as np

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
    from paddlebox_tpu_torch.train import flagship

    trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter", "cuda",
                                         plain_host=True)
    check(not ds.columnar and type(trainer.table.store) is
          HostEmbeddingStore, "the plain tier ran native")
    plain = main_passes(torch, trainer, ds)
    for p, q in zip(plain, native):
        check(p["loss"] == q["loss"] and p["auc"] == q["auc"],
              "plain host tier pass %d loss %r auc %r, native %r %r"
              % (p["pass"], p["loss"], p["auc"], q["loss"], q["auc"]))
    k, v = sorted_store(trainer.table)
    check(np.array_equal(k, native_store[0])
          and bits_equal(v, native_store[1]),
          "plain host tier store differs from the native run's")
    for tier, passes in (("native", native), ("plain", plain)):
        for p in passes:
            log("host tier %s pass %d: phase_s %s pass_s %.4f examples/s "
                "%.1f" % (tier, p["pass"], json.dumps(p["phase_s"]),
                          p["pass_s"], p["examples_per_s"]))
    log("plain host tier: losses, AUC and %d store rows bit-equal to the "
        "native run; %s" % (k.size, card_line()))
    trainer.close()
    del trainer, ds
    return plain


def blocked_phase(torch, cfg, feed, files):
    """One pass over ``files[0]`` (4 batches) with push_write='scatter' and
    one with 'blocked' from the same seed: bit-identical host rows; the
    push and the placement each launched once a step in the forms of
    ``cfg``'s slab, no other form. Returns the blocked pass's push kernel
    launch counts."""
    import numpy as np

    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.train import flagship

    two = cfg.slab_embed_dtype == "bfloat16"
    push = pk.push_form(cfg.layout())
    place = "blocked_write_2byte" if two else "blocked_write"
    tag = ("bf16 " if two else "") + (
        "" if push in ("push_adagrad", "push_adagrad_bf16") else push + " ")
    rows, blocked = {}, None
    for mode in ("scatter", "blocked"):
        t, d = flagship.build_trainer(files[:1], feed, cfg, mode, "cuda")
        pk.reset_launch_counts()
        res, auc, _ = run_pass(torch, t, d)
        c = pk.launch_counts()
        if mode == "blocked":
            blocked = c
            check(c[place] == res["batches"] and c[push] == res["batches"]
                  and sum(c.values()) == 2 * res["batches"],
                  "%sblocked path launches %s over %d steps"
                  % (tag, c, res["batches"]))
        rows[mode] = t.table.store.lookup(t.table.pass_keys)
        log("%s%s pass over %d batches: loss %r auc %r launches %s"
            % (tag, mode, res["batches"], res["loss"], auc, c))
        del t, d
    check(np.array_equal(rows["blocked"].view(np.uint32),
                         rows["scatter"].view(np.uint32)),
          "%sblocked-mode rows differ from scatter-mode rows" % tag)
    log("%sblocked vs scatter rows bit-identical over %d rows"
        % (tag, rows["blocked"].shape[0]))
    return blocked


def reset_counts():
    """Sets every kernel wrapper's launch count to 0."""
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    pk.reset_launch_counts()
    rk.reset_launch_counts()


def counts():
    """Every kernel wrapper's launch count since the last reset_counts."""
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    return {**pk.launch_counts(), **rk.launch_counts()}


def f32_launches(**launches):
    """The launch counts of a run: those given, and 0 for every other
    kernel form (the 2-byte forms, and the push forms of the other rules
    and of the expand block)."""
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    return {**{k: 0 for k in (*pk.launch_counts(), *rk.launch_counts())},
            **launches}


def counter_delta(before, table):
    """The table's row counters since ``before`` (a copy of them)."""
    return {k: v - before[k] for k, v in table.counters.items()}


def gather_launches_of(rows):
    """gather_rows launches of a pass besides the pull, by the table's
    counters: one delta promote where a row stayed resident, one
    touched-row write-back where rows were written back."""
    return (int(rows["pass_rows_promote_hit"] > 0)
            + int(rows["pass_rows_written_back"] > 0))


def expected_counters(keys):
    """Each cadence pass's row counters in the incremental modes, from the
    passes' key sets alone: resident hits, new rows, of those the rows a
    store that saw the earlier passes holds (prefetched in (a) only), every
    pass row written back."""
    import numpy as np
    out = [{"pass_rows_promote_hit": 0, "pass_rows_promote_new": 0,
            "pass_rows_promote_prefetched": 0,
            "pass_rows_written_back": int(keys[0].size),
            "pass_rows_writeback_skipped": 0}]
    for p in range(1, len(keys)):
        resident = np.isin(keys[p], keys[p - 1])
        new = keys[p][~resident]
        seen = np.unique(np.concatenate(keys[:p - 1] or [new[:0]]))
        out.append({"pass_rows_promote_hit": int(resident.sum()),
                    "pass_rows_promote_new": int(new.size),
                    "pass_rows_promote_prefetched": int(
                        np.isin(new, seen).sum()),
                    "pass_rows_written_back": int(keys[p].size),
                    "pass_rows_writeback_skipped": 0})
    return out


def cadence_phase(torch, cfg, feed, windows, keys, reset_counts, counts):
    """Phase 6: the three cadence passes (``windows``, their key sets
    ``keys``) in each of cadence_probe.MODES. Checks equal losses and AUC
    against (c), the full rebuild (rtol 1e-6; whether they are bit-equal
    is printed), bit-identical host stores, the counters against
    ``expected_counters`` (rows prefetched only in (a)) and the launches.
    Returns each mode's run record."""
    import numpy as np

    from paddlebox_tpu_torch import cadence_probe
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    expect = expected_counters(keys)
    if cfg == flagship.FLAGSHIP:
        got = {"n": tuple(int(k.size) for k in keys),
               "hit": tuple(e["pass_rows_promote_hit"] for e in expect[1:]),
               "new": tuple(e["pass_rows_promote_new"] for e in expect[1:]),
               "prefetchable": tuple(e["pass_rows_promote_prefetched"]
                                     for e in expect[1:])}
        check(got == FLAGSHIP_CADENCE, "cadence key sets %s, expected %s"
              % (got, FLAGSHIP_CADENCE))
    zero = dict.fromkeys(expect[0], 0)
    out, stores = {}, {}
    for mode in cadence_probe.MODES:
        reset_counts()
        trainer, run = cadence_probe.run_cadence(mode, windows, feed, cfg,
                                                 "cuda")
        run["launches"] = mode_counts = counts()
        check(run["host_tier"] == NATIVE_TIER, "cadence (%s) ran on the "
              "host tier %s" % (mode, run["host_tier"]))
        passes = run["passes"]
        for p in passes:
            log("cadence (%s) pass %d: %s" % (mode, p["pass"],
                                              json.dumps(p)))
        steps = sum(p["batches"] for p in passes)
        check(len(passes) == len(windows), "cadence (%s) ran %d passes"
              % (mode, len(passes)))
        for i, p in enumerate(passes):
            want = zero if mode == "c" else dict(
                expect[i], pass_rows_promote_prefetched=(
                    expect[i]["pass_rows_promote_prefetched"]
                    if mode == "a" else 0))
            check(p["counters"] == want, "cadence (%s) pass %d counters "
                  "%s, expected %s" % (mode, i, p["counters"], want))
            check(np.isfinite(p["loss"]) and 0.0 < p["auc"] <= 1.0,
                  "cadence (%s) pass %d loss %r auc %r"
                  % (mode, i, p["loss"], p["auc"]))
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        check(mode_counts["push_adagrad"] == steps
              and mode_counts["gather_rows"] == steps + extra
              and mode_counts["blocked_write"] == 0
              and mode_counts["scale_copy"] == 0,
              "cadence (%s) launches %s over %d steps, %d promotes and "
              "write-backs" % (mode, mode_counts, steps, extra))
        stores[mode] = sorted_store(trainer.table)
        out[mode] = run
        log("cadence (%s) %s: %d passes in %.4f s, launches %s"
            % (mode, run["label"], len(passes), run["wall_s"], mode_counts))
        del trainer
    ref_k, ref_v = stores["c"]
    others = [m for m in cadence_probe.MODES if m != "c"]
    for mode in others:
        k, v = stores[mode]
        check(np.array_equal(k, ref_k)
              and np.array_equal(v.view(np.uint32), ref_v.view(np.uint32)),
              "cadence (%s) host store differs from the full rebuild's"
              % mode)
        for p, q in zip(out[mode]["passes"], out["c"]["passes"]):
            check(abs(p["loss"] - q["loss"]) <= 1e-6 * abs(q["loss"])
                  and abs(p["auc"] - q["auc"]) <= 1e-6,
                  "cadence (%s) pass %d loss %r auc %r, full rebuild %r %r"
                  % (mode, p["pass"], p["loss"], p["auc"], q["loss"],
                     q["auc"]))
    bit_equal = all(p["loss"] == q["loss"] and p["auc"] == q["auc"]
                    for m in others
                    for p, q in zip(out[m]["passes"], out["c"]["passes"]))
    log("cadence: host stores bit-identical over %d keys in every mode; "
        "losses and AUC bit-equal: %s" % (ref_k.size, bit_equal))
    log(card_line())
    return out


def dir_bytes(path):
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def xbox_cols(values, layout):
    """The [embed_w, embedx] columns of store rows: an xbox view's rows."""
    import numpy as np
    from paddlebox_tpu_torch.embedding import accessor as acc
    D = layout.embedx_dim
    return np.concatenate([values[:, acc.EMBED_W:acc.EMBED_W + 1],
                           values[:, layout.embedx_w:layout.embedx_w + D]],
                          axis=1)


def bits_equal(a, b):
    import numpy as np
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint32),
        np.ascontiguousarray(b).view(np.uint32))


def eval_phase(torch, trainer, files, feed, reset_counts, counts,
               digits=TEST_PASS_DIGITS, tag="test pass"):
    """Phase 7, the test pass over ``files`` after the trainer's train
    passes: store unchanged, 1 + batches gather_rows launches, no push,
    its AUC held to ``digits``. Returns its record."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.metrics.auc import MetricRegistry

    ds = BoxDataset(feed)
    ds.set_filelist(files)
    ds.load_into_memory()
    n_batches = len(ds.split_batches(1)[0])
    keys = np.unique(ds.all_keys())
    resident = trainer.table.pass_keys
    before = sorted_store(trainer.table)
    c0 = dict(trainer.table.counters)
    reset_counts()
    t0 = time.perf_counter()
    preds, labels = trainer.predict_batches(ds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()
    rows = counter_delta(c0, trainer.table)
    after = sorted_store(trainer.table)
    check(np.array_equal(after[0], before[0])
          and bits_equal(after[1], before[1]),
          "the test pass changed the host store")
    check(launches == f32_launches(push_adagrad=0, blocked_write=0,
                                   scale_copy=0,
                                   gather_rows=1 + n_batches),
          "test pass launches %s over %d batches" % (launches, n_batches))
    hit = int(np.isin(keys, resident).sum())
    check(rows["pass_rows_promote_hit"] == hit
          and rows["pass_rows_promote_new"] == keys.size - hit
          and rows["pass_rows_written_back"] == 0,
          "test pass counters %s, %d keys, %d resident"
          % (rows, keys.size, hit))
    check(preds.shape == labels.shape == (len(ds),)
          and bool(np.isfinite(preds).all()),
          "test pass preds %s labels %s" % (preds.shape, labels.shape))
    m = MetricRegistry()
    m.init_metric("auc", "label", "pred", table_size=1 << 20)
    m.add_batch({"label": labels, "pred": preds})
    auc = m.get_metric_msg("auc")["auc"]
    rec = {"instances": len(ds), "batches": n_batches, "keys": int(keys.size),
           "resident": hit, "auc": auc, "seconds": secs,
           "examples_per_s": len(ds) / secs, "launches": launches,
           "counters": rows}
    log("%s: auc %.10f %s" % (tag, auc, json.dumps(rec)))
    check(0.0 < auc <= 1.0, "%s AUC %r" % (tag, auc))
    if digits is not None:
        check("%.10f" % auc == digits, "%s AUC %.10f, expected %s"
              % (tag, auc, digits))
    return rec


def day_phase(torch, trainer, cfg, feed, windows, tmp, reset_counts,
              counts):
    """Phase 7, the day, on ``trainer``, the main path's trainer after its
    two passes: the test pass, run_day, load_base, the xbox read-back and
    resume equals continue. Returns its record."""
    import numpy as np

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import CkptFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding import ckpt_store as cks
    from paddlebox_tpu_torch.embedding.native_store import \
        NativeHostEmbeddingStore
    from paddlebox_tpu_torch.serving.store import read_xbox_view
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      XboxModelReader,
                                                      run_day)

    test = eval_phase(torch, trainer, windows[2], feed, reset_counts,
                      counts)

    # --- the day, each save's store snapshot kept to hold the files to
    table = trainer.table
    tcfg = table.config
    root = os.path.join(tmp, "day")
    ckpt = CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                            xbox_model_dir=os.path.join(root, "xbox"),
                            save_delta_every_passes=1, async_save=True)
    cm = CheckpointManager(ckpt, table)
    snaps = {"deltas": [], "counters": []}
    real_delta, real_base = cm.save_delta, cm.save_base
    c_prev = [dict(table.counters)]

    def save_delta(day, delta_id):
        snaps["counters"].append(counter_delta(c_prev[0], table))
        c_prev[0] = dict(table.counters)
        snaps["deltas"].append((delta_id, sorted_store(table)))
        return real_delta(day, delta_id)

    def save_base(params, opt_state, day, **kw):
        snaps["base"] = sorted_store(table)
        snaps["dense"] = (params, opt_state)
        # the journal's epoch so far: the day's three passes and deltas
        snaps["journal"] = {"bytes": dir_bytes(cm.journal.dir),
                            "rows": cm.journal.dirty_rows}
        return real_base(params, opt_state, day, **kw)

    real_end_day = table.end_day
    end_day_rec = {}

    def end_day(age=True):
        t0 = time.perf_counter()
        deleted = real_end_day(age)
        end_day_rec.update(s=time.perf_counter() - t0, deleted=deleted)
        return deleted

    cm.save_delta, cm.save_base = save_delta, save_base
    table.end_day = end_day
    datasets = []
    for files in windows:
        datasets.append(BoxDataset(feed))
        datasets[-1].set_filelist(files)
    reset_counts()
    t0 = time.perf_counter()
    stats, dirs = run_day(trainer, datasets, cm, "day0")
    day_s = time.perf_counter() - t0
    day_launches = counts()
    steps = sum(s["batches"] for s in stats)
    check(len(stats) == 3 and len(snaps["deltas"]) == 3,
          "run_day ran %d passes, %d delta saves"
          % (len(stats), len(snaps["deltas"])))
    # every pass builds in full: the test pass left nothing resident, and
    # each delta save's stat rewrite drops the residency
    for i, rows in enumerate(snaps["counters"]):
        check(rows["pass_rows_promote_hit"] == 0
              and rows["pass_rows_promote_new"] == 0
              and rows["pass_rows_written_back"] > 0,
              "run_day pass %d counters %s: not a full build" % (i, rows))
    check(day_launches["push_adagrad"] == steps
          and day_launches["gather_rows"] == steps + len(stats)
          and day_launches["blocked_write"] == 0
          and day_launches["scale_copy"] == 0,
          "run_day launches %s over %d steps" % (day_launches, steps))
    base_k, base_v = snaps["base"]
    deleted = end_day_rec["deleted"]
    check(deleted == int(base_k.size) - len(table.store),
          "end_day deleted %d rows, the store lost %d"
          % (deleted, int(base_k.size) - len(table.store)))

    # --- load_base into a fresh trainer
    fresh, _ = flagship.build_trainer(windows[0], feed, cfg, "scatter",
                                      "cuda", seed=1)
    # without a journal of its own: a second journal over the saver's
    # directory would sweep the segments the saver still writes
    cm2 = CheckpointManager(ckpt, fresh.table, CkptFlags(ckpt_journal=False))
    params, opt_state, _ = cm2.load_base("day0")
    fresh.restore_dense(params, opt_state)
    k, v = sorted_store(fresh.table)
    check(np.array_equal(k, base_k) and bits_equal(v, base_v),
          "load_base: the store differs from the base's snapshot")
    # load_base's parts again, each timed: dense.pkl, the sparse tier's
    # read, the C++ store's install
    split = {}
    t0 = time.perf_counter()
    with open(os.path.join(dirs[0], "dense.pkl"), "rb") as f:
        cks.safe_load(f)
    split["dense_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = cks.load_sparse_any(os.path.join(dirs[0], "sparse.xman"))
    split["sparse_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    NativeHostEmbeddingStore(table.layout, tcfg).load_blob(blob)
    split["store_install"] = time.perf_counter() - t0
    del blob
    want_p, want_o = snaps["dense"]
    got_p, got_o = fresh.params, fresh.opt_state
    check(all(bits_equal(got_p[n], want_p[n]) for n in want_p)
          and got_o["count"] == want_o["count"]
          and all(bits_equal(got_o[m][n], want_o[m][n])
                  for m in ("mu", "nu") for n in want_o[m]),
          "load_base: the dense state differs from the saved one")

    # --- the xbox views against the snapshot rows each covers
    layout = table.layout
    xbox_day = os.path.join(ckpt.xbox_model_dir, "day0")
    covered = {}
    for delta_id, (dk, dv) in snaps["deltas"]:
        keep = dv[:, acc.DELTA_SCORE] >= tcfg.delta_threshold
        vk, vrows = read_xbox_view(os.path.join(xbox_day,
                                                "delta-%d" % delta_id))
        check(np.array_equal(vk, dk[keep])
              and bits_equal(vrows, xbox_cols(dv[keep], layout)),
              "xbox delta-%d differs from its snapshot" % delta_id)
        covered["delta-%d" % delta_id] = int(keep.sum())
    vk, vrows = read_xbox_view(xbox_day)
    want_rows = xbox_cols(base_v, layout)
    check(np.array_equal(vk, base_k) and bits_equal(vrows, want_rows),
          "xbox base differs from the base's snapshot")
    reader = XboxModelReader(ckpt.xbox_model_dir, "day0")
    check(reader.deltas_applied == 3 and len(reader) == base_k.size
          and bits_equal(reader.lookup(base_k), want_rows),
          "XboxModelReader's composed view differs from the base")
    covered["base"] = int(base_k.size)

    # --- resume equals continue: the loaded trainer replays the day's
    # boundary (the stat rewrite after the base save, then the shrink),
    # both restart their random streams and metrics, and train one pass
    with fresh.table.store_lock:
        fresh.table.store.update_stat_after_save(tcfg, 1)
        fresh.table.store.update_stat_after_save(tcfg, 3)
    fresh.table.end_day(age=False)
    k, v = sorted_store(fresh.table)
    live = sorted_store(table)
    check(np.array_equal(k, live[0]) and bits_equal(v, live[1]),
          "the replayed day boundary differs from the saver's store")
    resumed = []
    for t in (trainer, fresh):
        t.reseed(7)
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
        d = BoxDataset(feed)
        d.set_filelist(windows[0])
        res, auc, _ = run_pass(torch, t, d)
        resumed.append((res["loss"], auc, sorted_store(t.table)))
    (la, aa, (ka, va)), (lb, ab, (kb, vb)) = resumed
    check(la == lb and aa == ab and np.array_equal(ka, kb)
          and bits_equal(va, vb),
          "resume %r %r differs from continue %r %r" % (lb, ab, la, aa))

    rec = {"test_pass": test, "day_passes": [
               {"loss": s["loss"], "batches": s["batches"],
                "instances": s["instances"]} for s in stats],
           "day_s": day_s, "launches": day_launches,
           "save_base_s": cm.seconds["save_base"],
           "save_base_writer_s": cm.seconds["save_base_writer"],
           "save_delta_s": cm.seconds["save_delta"],
           "save_delta_writer_s": cm.seconds["save_delta_writer"],
           "journal_bytes": snaps["journal"]["bytes"],
           "journal_rows": snaps["journal"]["rows"],
           "load_base_s": cm2.seconds["load_base"],
           "load_base_again_s": split, "end_day_s": end_day_rec["s"],
           "rows_deleted": deleted, "rows_saved": int(base_k.size),
           "view_rows": covered,
           "base_bytes": dir_bytes(dirs[0]),
           "xbox_base_bytes": os.path.getsize(
               os.path.join(xbox_day, "view.xcol")),
           "resume": {"loss": la, "auc": aa, "rows": int(ka.size)}}
    log("day: %s" % json.dumps(rec))
    log("day: %d delta views and the base bit-equal to their snapshots, "
        "the loaded base bit-equal, resume equals continue (loss %r auc "
        "%r); %s" % (len(snaps["deltas"]), la, aa, card_line()))
    return rec


# the chunk-synchronous pass's loss and AUC (phase 9: one pass of the
# flagship with sparse_chunk_sync, chunks of 8), "%.10f"
SYNC_DIGITS = ("0.6911818385", "0.4983831116")

# phase 9's runs of the main path's two passes, in this order: one step at
# a time (A) and in chunks of 8 (B), as (scan_chunk, StageFlags fields
# stack_threads, chunk_prefetch_depth, h2d_stack_chunks); the B runs group
# two chunks a copy and stage two chunks ahead. Each is held bit-equal to
# phase 5's run (chunks of 8, the default StageFlags(4, 1, 1)).
CHUNK_RUNS = ((1, (4, 1, 1)), (8, (4, 1, 2)), (8, (4, 2, 1)), (1, (4, 1, 1)))
# the run whose trainer makes the profiled third pass
PROFILED_RUN = 2


def chunk_kernel_phase(torch, cfg, feed, files, dev):
    """Phase 9, the path's two kernels at a chunk-synchronous chunk's shape
    (the first 8 flagship batches' 1,048,576 ids, flat): gather_rows
    into the 2^20 x 17 slab and the fused push_adagrad over the chunk's
    dedup, each bit-equal to its plain version; kernel, plain, library
    (index_select for the gather) and bound times. Returns {kernel:
    record}."""
    import numpy as np

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import segment_offsets
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import (SEED, fused_push_bytes,
                                                push_inputs)
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain
    from paddlebox_tpu_torch.train import flagship

    D = cfg.embedx
    layout = ValueLayout(D)
    conf = cfg.table().optimizer
    W, G = layout.width, PushLayout(D).width
    ids = flagship.first_chunk_ids(files, feed, cfg, 8)
    inp = push_inputs(cfg, files, feed, ids=ids)
    K, n_uniq, n_valid = ids.shape[0], inp["n_uniq"], inp["n_valid"]
    slab, g, p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["slab"], inp["grads"], inp["perm"],
        segment_offsets(inp["inv"], n_valid), inp["uids"]))
    check(int(o[-1]) == n_valid and K == 8 * 131072,
          "chunk push inputs: %d ids, offsets end %d, n_valid %d"
          % (K, int(o[-1]), n_valid))
    out = {}

    # --- gather_rows, the chunk's pull
    i = torch.from_numpy(ids).to(dev)
    got = rk.gather_rows(slab, i)
    torch.cuda.synchronize()
    want = rk.gather_rows_plain(slab, i)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(got, slab.index_select(0, i)),
          "gather_rows at the chunk shape differs from the plain version")
    nbytes = gather_bytes(ids, cfg.capacity, W)
    args = (slab, i)
    out["gather_rows"] = {
        "ids": K, "distinct": int(np.unique(ids).size), "bytes": nbytes,
        "max_abs_err": float((got - want).abs().max()),
        "ms": time_chain(rk.gather_rows, args, nbytes),
        "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
        "library_ms": time_chain(lambda a, b: a.index_select(0, b), args,
                                 nbytes),
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
    del got, want, i, args

    # --- push_adagrad over the chunk's merged dedup, both write modes
    err = 0.0
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                          layout, conf, rows_out)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
              "push_adagrad (rows_out=%s) at the chunk shape differs from "
              "the plain version" % rows_out)
        if rows_out:
            check(torch.equal(r_k.view(torch.int32), r_p.view(torch.int32)),
                  "push_adagrad rows out at the chunk shape differ")
            err = max(err, float((r_k - r_p).abs().max()))
        err = max(err, float((s_k - s_p).abs().max()))
        del s_k, s_p, r_k, r_p
    live = inp["live"]
    nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
    ops = n_valid * G + int(np.unique(ids[live]).size) * (20 + 6 * D)
    args = (slab, g, p, o, u)
    out["push_adagrad"] = {
        "occurrences": n_valid, "n_uniq": n_uniq, "bytes": nbytes,
        "max_abs_err": err,
        "ms": time_chain(lambda *a: pk.push_adagrad(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "library_ms": None,
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
                     else "operations")}
    for name, rec in out.items():
        log("%s at the chunk shape: bit-equal to the plain version; %s"
            % (name, json.dumps(rec)))
    return out


def chunk_phase(torch, cfg, feed, files, ref, reset_counts, counts):
    """Phase 9, the chunk driver: the main path's two passes in CHUNK_RUNS,
    each run's losses, AUC, launches and sorted store bit-identical to
    phase 5's run ``ref`` (its passes, launches and sorted store); one
    sparse_chunk_sync pass (one pull and one push a chunk, a write-back;
    its digits held to SYNC_DIGITS); the host-to-device copies of a
    chunked pass by kind (profile_pass.py). Returns its record."""
    import numpy as np

    from paddlebox_tpu_torch import profile_pass
    from paddlebox_tpu_torch.config.flags import StageFlags
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    runs, profiled = [], None
    for i, (chunk, stage) in enumerate(CHUNK_RUNS):
        trainer, ds = flagship.build_trainer(
            files, feed, cfg, "scatter", "cuda",
            stage_flags=StageFlags(*stage), scan_chunk=chunk)
        reset_counts()
        passes = main_passes(torch, trainer, ds)
        launches = counts()
        store = sorted_store(trainer.table)
        if i == PROFILED_RUN:
            profiled = (trainer, ds)
        else:
            trainer.close()
        del trainer, ds
        check([(p["loss"], p["auc"]) for p in passes]
              == [(p["loss"], p["auc"]) for p in ref["passes"]]
              and launches == ref["launches"]
              and np.array_equal(store[0], ref["store"][0])
              and bits_equal(store[1], ref["store"][1]),
              "scan_chunk=%d StageFlags%s differs from the main path's run: "
              "launches %s against %s" % (chunk, stage, launches,
                                          ref["launches"]))
        runs.append({"scan_chunk": chunk, "stage_flags": stage,
                     "launches": launches,
                     "phase_s": [p["phase_s"] for p in passes],
                     "pass_s": [p["pass_s"] for p in passes],
                     "examples_per_s": [p["examples_per_s"]
                                        for p in passes]})
        log("chunk driver scan_chunk=%d StageFlags%s: %s"
            % (chunk, stage, json.dumps(runs[-1])))
    log("chunk driver: per step, chunks of 8 with grouped copies and two "
        "chunks staged ahead bit-identical to the main path's run (losses, "
        "AUC, launches, stores) over %d runs; %s" % (len(runs), card_line()))

    # --- one chunk-synchronous pass
    trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter", "cuda",
                                         sparse_chunk_sync=True)
    reset_counts()
    res, auc, secs = run_pass(torch, trainer, ds)
    sync_launches = counts()
    n_chunks = res["batches"] // trainer.cfg.scan_chunk
    tail = res["batches"] - n_chunks * trainer.cfg.scan_chunk
    check(sync_launches == f32_launches(push_adagrad=n_chunks + tail,
                                        gather_rows=n_chunks + tail + 1,
                                        blocked_write=0, scale_copy=0),
          "sparse_chunk_sync launches %s over %d chunks and %d tail steps"
          % (sync_launches, n_chunks, tail))
    sync = {"loss": res["loss"], "auc": auc, "batches": res["batches"],
            "chunks": n_chunks, "pass_s": secs,
            "phase_s": trainer.pass_times, "launches": sync_launches,
            "digits": ("%.10f" % res["loss"], "%.10f" % auc)}
    log("sparse_chunk_sync pass: loss %.10f auc %.10f %s"
        % (res["loss"], auc, json.dumps(sync)))
    check(sync["digits"] == SYNC_DIGITS, "sparse_chunk_sync digits %s, "
          "expected %s" % (sync["digits"], SYNC_DIGITS))
    trainer.close()
    del trainer, ds

    # --- the host-to-device copies of a chunked pass, by kind: a third
    # pass of the profiled run, a delta promote and a write-back of every
    # row as the main path's second pass is
    trainer, ds = profiled
    del profiled
    prof_rec, _ = profile_pass.profile_pass(trainer, ds, warmup=False)
    h2d = prof_rec["h2d_copies"]
    n_chunks = prof_rec["batches"] // trainer.cfg.scan_chunk
    check(h2d["pinned"]["copies"] == 7 * n_chunks,
          "a chunked pass made %s host-to-device copies, expected 7 pinned "
          "a chunk" % h2d)
    trainer.close()
    del trainer, ds
    prof_rec["stage_flags"] = CHUNK_RUNS[PROFILED_RUN][1]
    log("profile_pass, chunked pass: %s" % json.dumps(prof_rec))
    return {"runs": runs, "sync": sync, "profile": prof_rec}


# phase 11's runs of RecoverableRunner over the cadence's three windows, in
# this order: the journal on (A: every save after the first a journal-mode
# snapshot) and off (B: every save full), each from a settled process; the
# first is the one whose files are checked
RECOVERY_RUNS = ("A", "B", "B", "A")


def new_bytes(paths, seen):
    """Bytes of the files under ``paths`` whose inode is not in ``seen``,
    which then holds them: what a save wrote, a hard link counted once."""
    total = 0
    for path in paths:
        for d, _, names in os.walk(path):
            for name in names:
                st = os.stat(os.path.join(d, name))
                if st.st_ino not in seen:
                    seen.add(st.st_ino)
                    total += st.st_size
    return total


def recovery_run(torch, cfg, feed, windows, root, journal, keep=False):
    """One RecoverableRunner run (keep_last 3) over ``windows`` at ``root``
    with the journal on or off, from a settled process, on a flagship
    trainer built from seed 0 (which resumes where ``root`` holds completed
    passes). Returns (the run's record: a record a pass trained, its
    wall, the sorted store at its end; with ``keep``, also each save's
    store snapshot and each write-back's gather_rows rows; the manager's
    config)."""
    from paddlebox_tpu_torch import cadence_probe
    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import CkptFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.embedding import ckpt_store as cks
    from paddlebox_tpu_torch.embedding import pass_table as pt_mod
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.recovery import RecoverableRunner

    cadence_probe.settle()
    trainer, _ = flagship.build_trainer(windows[0], feed, cfg, "scatter",
                                        "cuda")
    table = trainer.table
    ckpt = CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                            xbox_model_dir=os.path.join(root, "xbox"),
                            async_save=True)
    cm = CheckpointManager(ckpt, table, CkptFlags(ckpt_journal=journal))
    runner = RecoverableRunner(trainer, cm, "day", keep_last=3)
    rec = {"resumed_at": runner.completed_passes(), "passes": [],
           "snaps": {}, "gathers": []}
    real_pass, real_save = trainer.train_pass, cm.save_base
    real_gather = pt_mod.gather_rows
    seen = set()
    new_bytes([root], seen)   # what an earlier run left here is not ours

    def gather_rows(slab, ids, out=None):
        rows = real_gather(slab, ids, out=out)
        if out is None and keep:     # the touched-row write-back
            rec["gathers"].append(rows.cpu().numpy())
        return rows

    def train_pass(ds):
        trainer.metrics.init_metric("auc", "label", "pred",
                                    table_size=1 << 20)
        s0 = dict(table.seconds)
        t0 = time.perf_counter()
        res = real_pass(ds)
        torch.cuda.synchronize()
        rec["passes"].append({
            "loss": res["loss"], "batches": res["batches"],
            "auc": trainer.metrics.get_metric_msg("auc")["auc"],
            "pass_s": time.perf_counter() - t0,
            "begin_pass_s": table.seconds["begin_pass"] - s0["begin_pass"],
            "end_pass_s": table.seconds["end_pass"] - s0["end_pass"]})
        return res

    def save_base(params, opt_state, day, **kw):
        if keep:
            rec["snaps"][day] = sorted_store(table)
        c0 = dict(cm.seconds)
        t0 = time.perf_counter()
        dirs = real_save(params, opt_state, day, **kw)
        cm.wait()
        p = rec["passes"][-1]
        p["save_s"] = time.perf_counter() - t0
        p["save_caller_s"] = cm.seconds["save_base"] - c0["save_base"]
        p["save_writer_s"] = (cm.seconds["save_base_writer"]
                              - c0["save_base_writer"])
        p["mode"] = cks.read_manifest(os.path.join(
            dirs[0], "sparse.xman"))["mode"]
        p["bytes_written"] = new_bytes([d for d in dirs if d], seen)
        return dirs

    datasets = []
    for files in windows:
        datasets.append(BoxDataset(feed))
        datasets[-1].set_filelist(files)
    trainer.train_pass, cm.save_base = train_pass, save_base
    pt_mod.gather_rows = gather_rows
    try:
        t0 = time.perf_counter()
        runner.run(datasets)
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        pt_mod.gather_rows = real_gather
        if cm.journal is not None:
            cm.journal.close()
    rec["store"] = sorted_store(table)
    trainer.close()
    return rec, ckpt


def check_recovery_files(torch, cfg, feed, windows, keys, ckpt, rec):
    """Run 0's files: pass-0 a full base and the anchor; pass-1 and pass-2
    journal-mode snapshots whose base links are the anchor's parts (same
    inodes); the build and write-back ROWS records of passes 1 and 2, read
    from pass-2's segments, hold the pass keys, the write-back's rows
    bit-equal to what gather_rows returned; load_base of each pass into a
    fresh trainer gives the store its save snapshotted. Returns each
    load's seconds."""
    import numpy as np

    from paddlebox_tpu_torch.config.flags import CkptFlags
    from paddlebox_tpu_torch.embedding import ckpt_store as cks
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.utils import journal_format as jf

    day = os.path.join(ckpt.batch_model_dir, "day")
    dirs = [os.path.join(day, "pass-%d" % i) for i in range(3)]
    mans = [cks.read_manifest(os.path.join(d, "sparse.xman")) for d in dirs]
    check([m["mode"] for m in mans] == ["full", "journal", "journal"],
          "recovery save modes %s" % [m["mode"] for m in mans])
    anchor = [os.stat(p).st_ino for p in cks.manifest_part_paths(
        os.path.join(dirs[0], "sparse.xman"))]
    for d, m in zip(dirs[1:], mans[1:]):
        check([os.stat(os.path.join(d, n)).st_ino for n in m["base"]]
              == anchor, "%s: base links are not the anchor's parts" % d)
    rows = [jf.decode_rows_payload(p) for n in mans[2]["segments"]
            for k, p in jf.iter_segment(os.path.join(dirs[2], n))
            if k == jf.KIND_ROWS]
    # every save drops the residency: each pass builds in full, and writes
    # back every pass row it touched (all of them)
    check(len(rows) == 4 and len(rec["gathers"]) == 3,
          "pass-2's segments hold %d ROWS records, %d write-backs seen"
          % (len(rows), len(rec["gathers"])))
    for j, p in enumerate((1, 2)):
        (bk, _), (wk, wv) = rows[2 * j], rows[2 * j + 1]
        check(np.array_equal(bk, keys[p]) and np.array_equal(wk, keys[p])
              and bits_equal(wv, rec["gathers"][p]),
              "pass %d's journal ROWS differ from its pass keys or from "
              "gather_rows' rows" % p)
    fresh, _ = flagship.build_trainer(windows[0], feed, cfg, "scatter",
                                      "cuda", seed=1)
    cm = CheckpointManager(ckpt, fresh.table, CkptFlags(ckpt_journal=False))
    load_s = []
    for i in range(3):
        t0 = cm.seconds["load_base"]
        cm.load_base("day/pass-%d" % i)
        load_s.append(cm.seconds["load_base"] - t0)
        k, v = sorted_store(fresh.table)
        want = rec["snaps"]["day/pass-%d" % i]
        check(np.array_equal(k, want[0]) and bits_equal(v, want[1]),
              "load_base of pass-%d differs from its save's snapshot" % i)
    fresh.close()
    return load_s


def recovery_phase(torch, cfg, feed, windows, keys, tmp, reset_counts,
                   counts):
    """Phase 11: RecoverableRunner over the cadence's three windows at full
    width, saving every pass in mode 'auto', in the runs of RECOVERY_RUNS:
    run 0's files checked (check_recovery_files), each run's launches, and
    every run's losses, AUC and store bit-identical to run 0's (the
    journal changes no training result); then interrupted after two
    windows and resumed by a fresh trainer and runner, whose pass 2 and
    store are bit-identical to run 0's. Logs per pass begin_pass/end_pass
    seconds, the save's seconds (the caller's part and the writer's),
    bytes written (a link counted once) and each run's wall beside the
    card line. Returns its record."""
    import shutil

    import numpy as np

    from paddlebox_tpu_torch.device import card_line

    out = {"runs": []}
    ref = None
    for i, tag in enumerate(RECOVERY_RUNS):
        root = os.path.join(tmp, "recovery-%d" % i)
        reset_counts()
        rec, ckpt = recovery_run(torch, cfg, feed, windows, root, tag == "A",
                                 keep=i == 0)
        launches = counts()
        passes = rec["passes"]
        steps = sum(p["batches"] for p in passes)
        modes = [p["mode"] for p in passes]
        check(modes == (["full", "journal", "journal"] if tag == "A"
                        else ["full"] * 3),
              "recovery run %d (%s) save modes %s" % (i, tag, modes))
        check(launches == f32_launches(push_adagrad=steps, blocked_write=0,
                                       scale_copy=0, gather_rows=steps + 3),
              "recovery run %d launches %s over %d steps and 3 "
              "write-backs" % (i, launches, steps))
        summary = {"run": i, "journal": tag == "A", "wall_s": rec["wall_s"],
                   "launches": launches, "passes": passes}
        if ref is None:
            summary["load_base_s"] = check_recovery_files(
                torch, cfg, feed, windows, keys, ckpt, rec)
            ref = rec
        for p, q in zip(passes, ref["passes"]):
            check((p["loss"], p["auc"]) == (q["loss"], q["auc"]),
                  "recovery run %d (%s) loss %r auc %r, run 0 %r %r"
                  % (i, tag, p["loss"], p["auc"], q["loss"], q["auc"]))
        k, v = rec["store"]
        check(np.array_equal(k, ref["store"][0])
              and bits_equal(v, ref["store"][1]),
              "recovery run %d (%s) store differs from run 0's" % (i, tag))
        out["runs"].append(summary)
        log("recovery run %d (%s): %s" % (i, tag, json.dumps(summary)))
        shutil.rmtree(root, ignore_errors=True)

    # --- interrupted after two windows, resumed by a fresh trainer
    root = os.path.join(tmp, "recovery-resume")
    first, _ = recovery_run(torch, cfg, feed, windows[:2], root, True)
    second, _ = recovery_run(torch, cfg, feed, windows, root, True)
    p2, q2 = second["passes"], ref["passes"][2]
    k, v = second["store"]
    check(second["resumed_at"] == 2 and len(p2) == 1
          and (p2[0]["loss"], p2[0]["auc"]) == (q2["loss"], q2["auc"])
          and np.array_equal(k, ref["store"][0])
          and bits_equal(v, ref["store"][1]),
          "resumed at pass %r over %d passes (%s), uninterrupted pass 2 "
          "loss %r auc %r" % (second["resumed_at"], len(p2), p2,
                              q2["loss"], q2["auc"]))
    out["resume"] = {"resumed_at": second["resumed_at"],
                     "interrupted_wall_s": first["wall_s"],
                     "resumed_wall_s": second["wall_s"], "pass": p2[0]}
    log("recovery resume: %s" % json.dumps(out["resume"]))
    shutil.rmtree(root, ignore_errors=True)
    log("recovery: snapshots load bit-equal, resume equals the "
        "uninterrupted run, the journal off changes no result; %s"
        % card_line())
    return out


# the bf16 main path's losses and AUC (phase 12: two passes of
# FLAGSHIP_BF16), "%.10f"
BF16_DIGITS = {"loss": ("0.6866459250", "0.5646136999"),
               "auc": ("0.4971533802", "0.7344624652")}
# phase 12's dense bf16 pass (compute_dtype and matmul_dtype bfloat16 on
# the bf16 slab, one pass), "%.10f"
DENSE_BF16_DIGITS = ("0.6866628528", "0.4972733763")
# the main path's AUC gap the reference allows between the f32 and the
# bf16 slab (tests/test_push_blocked.py:491, its parity gate)
BF16_AUC_GATE = 0.01
# rounds of the 2-byte placement against index_copy_ at the flagship shape
BLOCKED16_ROUNDS = 2


def gather16_edge_phase(torch, dev):
    """Phase 12, the 2-byte gather, raw and decoding, on its edge cases
    (edge_cases.gather_edge_cases_2byte; the decoding form at the widths
    of a bf16 layout) and over many tiles: bit-equal to the plain
    versions."""
    from paddlebox_tpu_torch.copy_probe import bit_equal
    from paddlebox_tpu_torch.edge_cases import (gather_edge_cases_2byte,
                                                gather_source)
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.embedding.push_kernels import KERNEL_EMBEDX_DIMS
    from paddlebox_tpu_torch.ops import row_kernels as rk

    def both(src, i, label):
        got = rk.gather_rows(src, i)
        torch.cuda.synchronize()
        check(torch.equal(got, rk.gather_rows_plain(src, i)), "gather_rows "
              "(2-byte) differs from the plain version on %s" % label)
        d = src.shape[1] - 17
        if d not in KERNEL_EMBEDX_DIMS:
            return 0
        lay = ValueLayout(d, embed_dtype="bfloat16")
        got = rk.gather_rows_decode(src, i, lay)
        torch.cuda.synchronize()
        check(bit_equal(got, rk.gather_rows_decode_plain(src, i, lay)),
              "gather_rows_decode differs from the plain version on %s"
              % label)
        return 1

    cases = gather_edge_cases_2byte()
    decoded = 0
    for label, (flat, off, C, W, ids) in cases.items():
        src = gather_source(torch.from_numpy(flat.view("int16")).to(dev),
                            off, C, W)
        decoded += both(src, torch.from_numpy(ids).to(dev), label)
    # many tiles a persistent block: 2^20 ids, about 16,000 tiles
    gen = torch.Generator(device=dev).manual_seed(14)
    src = torch.randint(-1 << 15, 1 << 15, (3000, 25), generator=gen,
                        device=dev, dtype=torch.int16)
    both(src, torch.randint(0, 3040, (1 << 20,), generator=gen, device=dev,
                            dtype=torch.int32), "2^20 ids")
    log("gather_rows (2-byte): bit-equal to the plain version on %d edge "
        "cases (K, W, source offset; %d of them decoded too): %s, and on "
        "2^20 ids at W 25, raw and decoded" % (len(cases), decoded,
                                               sorted(cases)))


def blocked16_edge_phase(torch, dev):
    """Phase 12, the 2-byte blocked write on its edge cases
    (edge_cases.blocked_edge_cases_2byte: W 19, 25, 26 and 81, B odd and
    even, permuted and consecutive sources, the slab and new_rows at the
    cases' data offsets), in the cases' slot order and reversed, and over
    many tiles, with permuted sources and with the consecutive run that
    blocked_layout builds: bit-equal to the plain version."""
    from paddlebox_tpu_torch.edge_cases import blocked_edge_cases_2byte
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import blocked_layout

    def both(s_k, nr, rm, bi, label):
        s_p = s_k.clone()
        pk.blocked_write(s_k, nr, rm, bi)
        torch.cuda.synchronize()
        pk.blocked_write_plain(s_p, nr, rm, bi)
        check(torch.equal(s_k, s_p), "blocked_write (2-byte) differs from "
              "the plain version on %s" % label)

    cases = blocked_edge_cases_2byte()
    for label, (slab, new_rows, row_map, blk_idx, off,
                (so, ro)) in cases.items():
        nr = on_card(torch, new_rows.view("int16"), ro, dev)
        for order in ("as given", "reversed"):
            flip = slice(None, None, -1 if order == "reversed" else 1)
            both(on_card(torch, slab.view("int16"), so, dev), nr,
                 on_card(torch, row_map[flip], off, dev),
                 torch.from_numpy(blk_idx[flip].copy()).to(dev),
                 "%s (slots %s)" % (label, order))
    gen = torch.Generator(device=dev).manual_seed(15)
    NB, B = 6000, 511
    mask = torch.rand((NB, B), generator=gen, device=dev) < 0.02
    mask[::7] = False
    row_map = torch.full((NB, B), -1, dtype=torch.int32, device=dev)
    n = int(mask.sum())
    row_map[mask] = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32)
    blk_idx = torch.randperm(NB + 100, generator=gen, device=dev)[:NB].to(
        torch.int32)
    slab = torch.randint(-1 << 15, 1 << 15, ((NB + 100) * B, 25),
                         generator=gen, device=dev, dtype=torch.int16)
    nr = torch.randint(-1 << 15, 1 << 15, (n, 25), generator=gen,
                       device=dev, dtype=torch.int16)
    both(slab, nr, row_map, blk_idx, "many tiles")
    # the consecutive run over many tiles: sorted uids over the same slab,
    # bucketized as the blocked path does
    uids = torch.sort(torch.randperm(slab.shape[0], generator=gen,
                                     device=dev)[:n]).values
    row_map, blk_idx = blocked_layout(uids, slab.shape[0], B)
    both(slab, nr, row_map, blk_idx, "many tiles, consecutive sources")
    log("blocked_write (2-byte): bit-equal to the plain version on %d edge "
        "cases %s, slots as given and reversed, and over %d slots of %d "
        "lanes, permuted and consecutive sources"
        % (len(cases), sorted(cases), NB, B))


def bf16_kernel_phase(torch, cfg, feed, files, keys, dev):
    """Phase 12, the three kernels' 2-byte forms at the bf16 main path's
    shapes (the fused push on a flagship batch's dedup over a 2^20 x 25
    int16 slab, the placement of its rows, the pull raw and decoding, the
    delta promote and the write-back) and on their 2-byte edge cases, each
    bit-equal to its plain version; with kernel, plain, library and bound
    times, and at the pull the decode as a separate op beside the decoding
    gather. Returns the kernel records (launches filled later)."""
    import numpy as np

    from paddlebox_tpu_torch.copy_probe import bit_equal, blocked_case
    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import (PushLayout,
                                                        ValueLayout,
                                                        decode_slab_rows)
    from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                          segment_offsets,
                                                          sorted_member)
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import (SEED, fused_push_bytes,
                                                push_inputs)
    from paddlebox_tpu_torch.rate_probe import (balanced_rounds,
                                                gather_bytes,
                                                pull_inputs_bf16, quartiles,
                                                time_chain)

    D, C = cfg.embedx, cfg.capacity
    layout = ValueLayout(D, embed_dtype="bfloat16")
    W, DW, G = layout.width, layout.device_width, PushLayout(D).width
    conf = cfg.table().optimizer

    # --- push_adagrad, bf16: phase 4's flagship batch on the slab encoded
    inp = push_inputs(cfg, files, feed)
    ids, live, kind = inp["ids"], inp["live"], inp["kind"]
    K, n_uniq, n_valid = ids.shape[0], inp["n_uniq"], inp["n_valid"]
    slab = device_slab(torch, inp["slab"], layout, dev)
    g, p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["grads"], inp["perm"], segment_offsets(inp["inv"], n_valid),
        inp["uids"]))
    del inp
    created = torch.from_numpy(
        np.unique(ids[live & (kind[ids] == 0)]).astype(np.int32)).to(dev)
    push_err = push_check(torch, slab, g, u, p, o, n_uniq, created, layout,
                          conf, SEED)
    hot = ids.copy()
    hot[:1000] = hot[0]
    h_uids, h_perm, h_inv, h_n = dedup_ids(hot, C)
    push_err = max(push_err, push_check(
        torch, slab, g, *(torch.from_numpy(x).to(dev) for x in (
            h_uids, h_perm, segment_offsets(h_inv, n_valid))), h_n,
        created[:0], layout, conf, SEED))
    push_err = max(push_err, push_width_cases(
        torch, dev, [ValueLayout(d, embed_dtype="bfloat16")
                     for d in pk.KERNEL_EMBEDX_DIMS]))
    log("push_adagrad (bf16): bit-equal to the plain version in both write "
        "modes at the flagship batch on a [%d, %d] int16 slab, with a hot "
        "key, and at embedx widths %s" % (C, DW,
                                          list(pk.KERNEL_EMBEDX_DIMS)))
    push_bytes = fused_push_bytes(n_valid, n_uniq, DW, G, 2)
    push_ops = (n_valid * G + int(np.unique(ids[live]).size) * (20 + 6 * D)
                + n_uniq * 4 * W)
    push_bound = 1e3 * max(push_bytes / HBM_BYTES_PER_S,
                           push_ops / F32_FLOPS)
    args = (slab, g, p, o, u)
    push_ms = time_chain(
        lambda *a: pk.push_adagrad(*a, n_uniq, SEED, layout, conf,
                                   rows_out=True), args, push_bytes)
    push_plain_ms = time_chain(
        lambda *a: pk.push_adagrad_fused_plain(*a, n_uniq, SEED, layout,
                                               conf, rows_out=True), args,
        push_bytes)
    push_inplace_ms = time_chain(
        lambda *a: pk.push_adagrad(*a, n_uniq, SEED, layout, conf), args,
        push_bytes)
    log("push_adagrad (bf16), K=%d n_valid=%d n_uniq=%d: rows out %.4f ms "
        "(in place %.4f ms), plain %.4f ms, bound %.4f ms (%d B)"
        % (K, n_valid, n_uniq, push_ms, push_inplace_ms, push_plain_ms,
           push_bound, push_bytes))
    del slab, g, p, o, u, args

    # --- blocked_write, 2-byte: the same batch's rows placed
    blk = blocked_case(ids, C, DW, dev, two_byte=True)
    slab0, new_rows, row_map, blk_idx = blk["args"]
    s_k, s_p = slab0.clone(), slab0.clone()
    pk.blocked_write(s_k, new_rows, row_map, blk_idx)
    torch.cuda.synchronize()
    pk.blocked_write_plain(s_p, new_rows, row_map, blk_idx)
    check(torch.equal(s_k, s_p), "blocked_write (2-byte) differs from the "
          "plain version")
    blocked16_edge_phase(torch, dev)
    blk_bytes = blk["bytes"]
    blk_args = (s_k, new_rows, row_map, blk_idx)
    # the kernel (A) and index_copy_ (B) in turns, A, B, B, A a round
    blk_turns = balanced_rounds({"blocked_write_2byte": (
        ("blocked_write_2byte", pk.blocked_write, blk_args, blk_bytes),
        ("index_copy_", blk["library"], blk["library_args"], blk_bytes))},
        BLOCKED16_ROUNDS, "case")["blocked_write_2byte"]
    blk_ms = quartiles(blk_turns["A"])["median"]
    blk_lib_ms = quartiles(blk_turns["B"])["median"]
    blk_plain_ms = time_chain(pk.blocked_write_plain, blk_args, blk_bytes)
    blk_bound = 1e3 * blk_bytes / HBM_BYTES_PER_S
    log("blocked_write (2-byte) NB=%(NB)d B=%(B)d placed=%(placed)d W=%(W)d"
        ": " % blk["info"] + "kernel %.5f ms, index_copy_ %.5f ms (medians "
        "of %d rounds A, B, B, A; kernel / index_copy_ a round: %s), plain "
        "%.4f ms, bound %.5f ms (%d B)"
        % (blk_ms, blk_lib_ms, BLOCKED16_ROUNDS,
           ", ".join("%.4f" % r for r in blk_turns["ratios"]), blk_plain_ms,
           blk_bound, blk_bytes))
    del blk, blk_args, slab0, new_rows, s_k, s_p

    # --- gather_rows, 2-byte: the pull, raw and decoded (fused, and the
    # raw gather followed by the codec's decode in PyTorch ops)
    s_np, pull_ids = pull_inputs_bf16(dataclasses.replace(
        cfg, slab_embed_dtype="bfloat16"))
    src = torch.from_numpy(s_np.view("int16")).to(dev)
    i = torch.from_numpy(pull_ids).to(dev)
    raw = rk.gather_rows(src, i)
    dec = rk.gather_rows_decode(src, i, layout)
    torch.cuda.synchronize()
    check(torch.equal(raw, rk.gather_rows_plain(src, i))
          and torch.equal(raw, src.index_select(0, i)),
          "gather_rows (2-byte) at the pull differs from the plain version")
    dec_plain = rk.gather_rows_decode_plain(src, i, layout)
    check(bit_equal(dec, dec_plain), "gather_rows_decode at the pull "
          "differs from the plain version")
    dec_err = float((dec - dec_plain).abs().max())
    distinct = int(np.unique(pull_ids).size)
    raw_bytes = gather_bytes(pull_ids, C, DW, 2)
    dec_bytes = K * 4 + distinct * DW * 2 + K * W * 4

    def separate(s, ids_):
        return decode_slab_rows(rk.gather_rows(s, ids_), layout)

    check(bit_equal(separate(src, i), dec), "the separate decode differs "
          "from the decoding gather")
    pull = {"ids": K, "distinct": distinct,
            "raw": {"bytes": raw_bytes,
                    "ms": time_chain(rk.gather_rows, (src, i), raw_bytes),
                    "plain_ms": time_chain(rk.gather_rows_plain, (src, i),
                                           raw_bytes),
                    "library_ms": time_chain(
                        lambda a, b: a.index_select(0, b), (src, i),
                        raw_bytes),
                    "bound_ms": 1e3 * raw_bytes / HBM_BYTES_PER_S},
            "decode": {"bytes": dec_bytes,
                       "fused_ms": time_chain(
                           lambda a, b: rk.gather_rows_decode(a, b, layout),
                           (src, i), dec_bytes),
                       "separate_ms": time_chain(separate, (src, i),
                                                 dec_bytes),
                       "plain_ms": time_chain(
                           lambda a, b: rk.gather_rows_decode_plain(
                               a, b, layout), (src, i), dec_bytes),
                       "bound_ms": 1e3 * dec_bytes / HBM_BYTES_PER_S}}
    log("gather_rows (2-byte) at the pull, src %s, %d ids (%d distinct): "
        "%s" % (list(src.shape), K, distinct, json.dumps(pull)))
    del src, i, raw, dec, dec_plain

    # --- the delta promote and the write-back (raw), as phase 4's
    gen = torch.Generator(device=dev).manual_seed(16)
    slab = torch.randint(-1 << 15, 1 << 15, (C, DW), generator=gen,
                         device=dev, dtype=torch.int16)
    pos, hit = sorted_member(keys[0], keys[1])
    at_shapes = {}
    for label, ids_np in (
            ("promote", np.where(hit, pos, 0).astype(np.int32)),
            ("writeback", np.arange(keys[0].size, dtype=np.int32))):
        ii = torch.from_numpy(ids_np).to(dev)
        got = rk.gather_rows(slab, ii)
        torch.cuda.synchronize()
        check(torch.equal(got, rk.gather_rows_plain(slab, ii)),
              "gather_rows (2-byte) at the %s shape differs from the plain "
              "version" % label)
        del got
        nbytes = gather_bytes(ids_np, C, DW, 2)
        args = (slab, ii)
        at_shapes[label] = {
            "ids": int(ids_np.size),
            "distinct": int(np.unique(ids_np).size), "bytes": nbytes,
            "ms": time_chain(rk.gather_rows, args, nbytes),
            "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
            "library_ms": time_chain(lambda a, b: a.index_select(0, b),
                                     args, nbytes),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        log("gather_rows (2-byte) %s shape src %s: bit-equal to the plain "
            "version; %s" % (label, list(slab.shape),
                             json.dumps(at_shapes[label])))
    del slab
    gather16_edge_phase(torch, dev)

    def rec(name, src_file, line, ms, plain_ms, bound_ms, bound_by, lib_ms,
            err, **extra):
        return {"name": name, "route": "cuda",
                "source": "paddlebox_tpu_torch/csrc/" + src_file,
                "replaces": line, "launches": None, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms, **extra}

    push_line = "paddlebox_tpu/embedding/pallas_push.py:"
    return [
        rec("push_adagrad_bf16", "push_adagrad.cu", push_line + "41",
            push_ms, push_plain_ms, push_bound,
            "bytes" if push_bytes / HBM_BYTES_PER_S >= push_ops / F32_FLOPS
            else "operations", None, push_err,
            in_place_ms=push_inplace_ms),
        rec("blocked_write_2byte", "blocked_write.cu", push_line + "111",
            blk_ms, blk_plain_ms, blk_bound, "bytes", blk_lib_ms, 0.0,
            library_ratios=blk_turns["ratios"]),
        rec("gather_rows_2byte", "gather_rows.cu",
            "tools/pallas_rate_probe.py:70", pull["raw"]["ms"],
            pull["raw"]["plain_ms"], pull["raw"]["bound_ms"], "bytes",
            pull["raw"]["library_ms"], 0.0, at_shapes=at_shapes),
        rec("gather_rows_decode", "gather_rows.cu",
            "tools/pallas_rate_probe.py:70", pull["decode"]["fused_ms"],
            pull["decode"]["plain_ms"], pull["decode"]["bound_ms"], "bytes",
            None, dec_err, separate_decode_ms=pull["decode"]["separate_ms"]),
    ]


def bf16_phase(torch, feed, files, f32_passes, reset_counts, counts):
    """Phase 12, the bf16 main path at full width: FLAGSHIP_BF16's two
    passes (its digits, launches, slab and write-back bytes, |dAUC|
    against phase 5's f32 passes), a 4-batch blocked pass bit-identical to
    scatter, and one dense bf16 pass (compute_dtype and matmul_dtype
    bfloat16). Returns its records."""
    import numpy as np

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP_BF16
    trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter", "cuda")
    layout = trainer.table.layout
    check(layout.bf16 and layout.device_width == 17 + cfg.embedx,
          "FLAGSHIP_BF16 built layout %s" % (layout,))
    reset_counts()
    passes = main_passes(torch, trainer, ds)
    launches = counts()
    slab = trainer.table.slab
    check(slab.dtype == torch.int16
          and tuple(slab.shape) == (cfg.capacity, layout.device_width),
          "bf16 slab %s %s" % (slab.dtype, tuple(slab.shape)))
    for p in passes:
        log("bf16 main path pass %d: loss %.10f auc %.10f %s"
            % (p["pass"], p["loss"], p["auc"], json.dumps(p)))
    digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
              "auc": tuple("%.10f" % p["auc"] for p in passes)}
    check(digits == BF16_DIGITS, "bf16 main path digits %s, expected %s"
          % (digits, BF16_DIGITS))
    steps = sum(p["batches"] for p in passes)
    extra = sum(gather_launches_of(p["counters"]) for p in passes)
    check(launches["push_adagrad_bf16"] == steps
          and launches["gather_rows_decode"] == steps
          and extra == 3 and launches["gather_rows_2byte"] == extra,
          "bf16 main path launches %s over %d steps and %d promotes and "
          "write-backs" % (launches, steps, extra))
    check(all(launches[k] == 0 for k in ("push_adagrad", "gather_rows",
                                         "blocked_write",
                                         "blocked_write_2byte",
                                         "scale_copy")),
          "an f32 form or another kernel launched on the bf16 main path: %s"
          % launches)
    d_auc = [abs(p["auc"] - q["auc"]) for p, q in zip(passes, f32_passes)]
    check(max(d_auc) <= BF16_AUC_GATE, "bf16 |dAUC| %s against f32 over "
          "the gate %s" % (d_auc, BF16_AUC_GATE))
    written = [p["counters"]["pass_rows_written_back"] for p in passes]
    sizes = {"slab_bytes": slab.numel() * slab.element_size(),
             "f32_slab_bytes": cfg.capacity * layout.width * 4,
             "writeback_d2h_bytes": [n * layout.device_bytes_per_row
                                     for n in written],
             "f32_writeback_d2h_bytes": [n * layout.width * 4
                                         for n in written]}
    k, v = sorted_store(trainer.table)
    check(np.isfinite(v).all() and k.size > 0, "bf16 host store not finite")
    log("bf16 main path launches %s over %d steps; |dAUC| against f32 %s "
        "(gate %s); %s; pass phases bf16 %s, f32 %s; %s"
        % (launches, steps, d_auc, BF16_AUC_GATE, json.dumps(sizes),
           [p["phase_s"] for p in passes],
           [p["phase_s"] for p in f32_passes], card_line()))
    del trainer, ds, slab

    blocked = blocked_phase(torch, cfg, feed, files)

    # dense bf16: one pass with bf16 compute and bf16 matmul operands
    dense_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                    matmul_dtype="bfloat16")
    t, d = flagship.build_trainer(files, feed, dense_cfg, "scatter", "cuda")
    check(t.cfg.compute_dtype == "bfloat16"
          and t.model.matmul_dtype == "bfloat16", "dense bf16 not set")
    before = dict(t.table.counters)
    reset_counts()
    res, auc, secs = run_pass(torch, t, d)
    dense_launches = counts()
    dense_extra = gather_launches_of(counter_delta(before, t.table))
    dense = {"loss": res["loss"], "auc": auc, "pass_s": secs,
             "phase_s": t.pass_times, "launches": dense_launches}
    dense_digits = ("%.10f" % res["loss"], "%.10f" % auc)
    log("dense bf16 pass: loss %.10f auc %.10f %s"
        % (res["loss"], auc, json.dumps(dense)))
    check(dense_digits == DENSE_BF16_DIGITS, "dense bf16 digits %s, "
          "expected %s" % (dense_digits, DENSE_BF16_DIGITS))
    check(dense_launches == f32_launches(
              push_adagrad=0, gather_rows=0, blocked_write=0,
              blocked_write_2byte=0, scale_copy=0,
              push_adagrad_bf16=res["batches"],
              gather_rows_decode=res["batches"],
              gather_rows_2byte=dense_extra) and dense_extra == 1,
          "dense bf16 launches %s over %d steps and %d promotes and "
          "write-backs" % (dense_launches, res["batches"], dense_extra))
    del t, d
    return {"passes": passes, "launches": launches, "blocked": blocked,
            "sizes": sizes, "d_auc": d_auc, "dense": dense}


# phase 13's runs of the main path's two passes: the trainer's host planes
# all on (ObsFlags(), the default) and all off (ObsFlags.off()), in this
# order, each from a settled process
PLANE_RUNS = ("on", "off", "off", "on")
# the spans a planes-on run of the main path records (the chunk driver's,
# the table's, the ingest's)
PLANE_SPANS = ("host_stage", "scan_dispatch", "chunk_drain", "pass_begin",
               "pass_end", "ingest_parse", "ingest_merge", "ingest_shuffle",
               "ingest_quality")


def quality_auc_slack(q):
    """How far the quality plane's 'all' AUC may sit from the trainer's
    metric AUC over the same predictions: the share of positive-negative
    pairs that share a quality bucket (counted 1/2 there, 0 or 1 in the
    metric's finer table), plus the report's rounding to 6 digits. No
    BLAS call: a threaded one leaves its threads spinning on the host
    cores the next pass runs on."""
    neg, pos = q._tables["all"]
    return 0.5 * float((neg * pos).sum()) / (neg.sum() * pos.sum()) + 1e-6


def planes_cost(trainer, ds):
    """Host seconds of the planes' own work over one pass of ``ds``
    (loaded, 16 batches), timed on the host alone: a fresh quality plane
    and drift monitor fed the pass's batches with random predictions (the
    consumer's add_batch, add_slot_batch and observe_preds), the merged
    block's observe_block, and the pass end (the quality report, the roll
    and one forced report)."""
    import numpy as np

    from paddlebox_tpu_torch.metrics import drift, quality
    from paddlebox_tpu_torch.obs.report import ListSink, StepReporter

    q = quality.TaggedQuality(trainer.obs_flags.quality_table_size)
    m = drift.SlotDriftMonitor(drift_warn=trainer.obs_flags.data_quality_warn)
    batches = ds.split_batches(1)[0]
    rng = np.random.RandomState(0)
    preds = [rng.rand(b.labels.size).astype(np.float32) for b in batches]
    t0 = time.perf_counter()
    for p, b in zip(preds, batches):
        q.add_batch({"label": b.labels, "mask": b.ins_valid, "pred": p})
        q.add_slot_batch(p, b.labels, b.slots, b.segments, b.valid,
                         trainer.num_slots)
        m.observe_preds(p, mask=b.ins_valid)
    t1 = time.perf_counter()
    m.observe_block(ds._block)
    t2 = time.perf_counter()
    extra = quality.attach_pass_extras({"event": "pass_end"}, q,
                                       monitor=m)
    StepReporter(every=20, sink=ListSink()).maybe_report(16, extra, True)
    t3 = time.perf_counter()
    return {"feed_s": t1 - t0, "observe_block_s": t2 - t1,
            "pass_end_s": t3 - t2, "total_s": t3 - t0}


def planes_phase(torch, cfg, feed, files, ref, reset_counts, counts, tmp):
    """Phase 13: the main path's two passes with the host planes on and
    off (PLANE_RUNS), each run settled, the garbage collector's pauses
    timed a pass; every run bit-identical to phase 5's ``ref`` (losses,
    AUC, launches, sorted store). In each on run: the
    pass_end records (one a pass, the stats deltas of every record of a
    pass equal to the table's counters of the pass, the quality 'all' AUC
    within quality_auc_slack of the trainer's, the drift window present),
    the chrome trace with PLANE_SPANS; in each off run: no record, no
    span, no quality plane. Logs each run's pass phases, walls,
    examples/s and gc seconds (and an on run's span seconds by name), the
    on/off means and the planes' own host seconds a pass. Returns its
    records."""
    import gc

    import numpy as np

    from paddlebox_tpu_torch import cadence_probe
    from paddlebox_tpu_torch.config.flags import ObsFlags
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding.pass_table import COUNTERS
    from paddlebox_tpu_torch.metrics import drift
    from paddlebox_tpu_torch.obs import ListSink, export_chrome_trace
    from paddlebox_tpu_torch.obs import tracer
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils.stats import stat_reset

    runs = []
    for i, mode in enumerate(PLANE_RUNS):
        cadence_probe.settle()
        stat_reset()
        tracer.get_tracer().clear()
        trainer, ds = flagship.build_trainer(
            files, feed, cfg, "scatter", "cuda",
            obs_flags=ObsFlags() if mode == "on" else ObsFlags.off())
        trainer.reporter.sink = sink = ListSink()
        reset_counts()
        t0 = time.perf_counter()
        passes = []
        for p in range(2):
            before = dict(trainer.table.counters)
            n0 = len(sink.records)
            gc_clock = cadence_probe.GcClock()
            gc.callbacks.append(gc_clock)
            t_pass = time.perf_counter()
            try:
                res, auc, secs = run_pass(torch, trainer, ds)
            finally:
                gc.callbacks.remove(gc_clock)
            spans_s = {}
            for s in tracer.get_tracer().all_spans():
                if s[3] >= t_pass:
                    spans_s[s[0]] = spans_s.get(s[0], 0.0) + s[4] - s[3]
            passes.append({"pass": p, "loss": res["loss"], "auc": auc,
                           "pass_s": secs,
                           "examples_per_s": res["instances"] / secs,
                           "gc_s": gc_clock.seconds, "spans_s": spans_s,
                           "phase_s": trainer.pass_times,
                           "counters": counter_delta(before, trainer.table),
                           "records": sink.records[n0:],
                           "slack": (quality_auc_slack(trainer.quality)
                                     if trainer.quality is not None
                                     else None)})
        wall = time.perf_counter() - t0
        launches = counts()
        for p, q in zip(passes, ref["passes"]):
            check(p["loss"] == q["loss"] and p["auc"] == q["auc"],
                  "planes %s run %d pass %d loss %r auc %r, phase 5 %r %r"
                  % (mode, i, p["pass"], p["loss"], p["auc"], q["loss"],
                     q["auc"]))
        check(launches == ref["launches"], "planes %s run %d launches %s, "
              "phase 5 %s" % (mode, i, launches, ref["launches"]))
        k, v = sorted_store(trainer.table)
        check(np.array_equal(k, ref["store"][0])
              and bits_equal(v, ref["store"][1]),
              "planes %s run %d store differs from phase 5's" % (mode, i))
        spans = {s[0] for s in tracer.get_tracer().all_spans()}
        if mode == "off":
            check(trainer.quality is None and drift.active() is None
                  and not sink.records and not spans,
                  "planes off run %d: quality %r, %d records, spans %s"
                  % (i, trainer.quality, len(sink.records), sorted(spans)))
        else:
            for p in passes:
                ends = [r for r in p["records"]
                        if r.get("event") == "pass_end"]
                check(len(ends) == 1, "planes on run %d pass %d: %d "
                      "pass_end records" % (i, p["pass"], len(ends)))
                end = ends[0]
                stats = {c: sum(r["stats"].get(c, 0) for r in p["records"])
                         for c in COUNTERS}
                check(stats == p["counters"], "planes on run %d pass %d "
                      "stats %s, table counters %s"
                      % (i, p["pass"], stats, p["counters"]))
                qa = end["quality"]["tags"]["all"]["auc"]
                slack = p["slack"]
                check(abs(qa - p["auc"]) <= slack, "planes on run %d pass "
                      "%d quality AUC %r, trainer %r, slack %r"
                      % (i, p["pass"], qa, p["auc"], slack))
                dq = end.get("data_quality") or {}
                check(dq.get("window") == p["pass"] + 1
                      and dq.get("n_slots") == cfg.num_slots
                      and dq.get("n_recs") == min(
                          drift.SAMPLE_RECS,
                          cfg.num_files * cfg.lines_per_file),
                      "planes on run %d pass %d drift bundle %s"
                      % (i, p["pass"], dq))
                p["pass_end"] = {"quality_all": end["quality"]["tags"][
                    "all"], "quality_auc_slack": slack,
                    "data_quality": dq, "stats": end["stats"],
                    "timers": end["timers"], "gauges": end["gauges"]}
            path = os.path.join(tmp, "planes_trace_%d.json" % i)
            doc = export_chrome_trace(path)
            names = {e["name"] for e in doc["traceEvents"]
                     if e["ph"] == "X"}
            check(set(PLANE_SPANS) <= names, "planes on run %d trace "
                  "lacks spans %s" % (i, sorted(set(PLANE_SPANS) - names)))
        for p in passes:
            p.pop("records")
            p.pop("slack")
            log("planes %s run %d pass %d: pass_s %.4f examples/s %.1f "
                "gc_s %.4f phase_s %s spans_s %s"
                % (mode, i, p["pass"], p["pass_s"], p["examples_per_s"],
                   p["gc_s"], json.dumps(p["phase_s"]),
                   json.dumps(p["spans_s"])))
            if "pass_end" in p:
                log("planes %s run %d pass %d pass_end: %s"
                    % (mode, i, p["pass"], json.dumps(p["pass_end"])))
        log("planes %s run %d: two passes in %.4f s, %d spans, launches %s"
            % (mode, i, wall, len(spans), launches))
        runs.append({"mode": mode, "wall_s": wall, "passes": passes,
                     "launches": launches})
        if i == len(PLANE_RUNS) - 1:
            cost = planes_cost(trainer, ds)
        trainer.close()
        del trainer, ds
    summary = {}
    for mode in ("on", "off"):
        mine = [r for r in runs if r["mode"] == mode]
        summary[mode] = [{
            **{k: float(np.mean([r["passes"][p][k] for r in mine]))
               for k in ("pass_s", "gc_s")},
            **{k: float(np.mean([r["passes"][p]["phase_s"][k]
                                 for r in mine]))
               for k in mine[0]["passes"][p]["phase_s"]}}
            for p in range(2)]
    delta = [summary["on"][p]["pass_s"] - summary["off"][p]["pass_s"]
             for p in range(2)]
    log("planes on vs off, means of %d runs each (host clock, s): %s; "
        "on - off a pass %s; the planes' own host work on one pass "
        "timed alone %s; %s"
        % (len(PLANE_RUNS) // 2, json.dumps(summary), delta,
           json.dumps(cost), card_line()))
    return {"runs": runs, "summary": summary, "delta_s": delta,
            "cost": cost}


# phase 14's push forms held against their plain versions at the flagship
# batch: (rule, expand width, slab dtype), embedx 8
RULE_FORMS = (("adam", 0, "float32"), ("adam_shared", 0, "float32"),
              ("naive", 0, "float32"), ("adagrad", 64, "float32"),
              ("naive", 64, "float32"), ("adam", 0, "bfloat16"),
              ("adagrad", 64, "bfloat16"))
# the pull's row widths phase 14 adds (adam's 37 f32 columns, adagrad with
# the 64-wide expand block's 82)
RULE_PULL_WIDTHS = (37, 82)


def rules_kernel_phase(torch, cfg, feed, files, dev):
    """Phase 14, the fused push's forms of the other in-table rules and
    of the expand block (RULE_FORMS) against their plain versions at the
    flagship batch in both write modes, all bit-equal, and every other
    instantiation on a small batch; the pull's gather_rows at the new row
    widths (RULE_PULL_WIDTHS) against index_select, bit-equal. Returns
    (the push records, launches filled later; the pull's at_shapes)."""
    import numpy as np

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                          segment_offsets)
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import (SEED, fused_push_bytes,
                                                push_inputs, rule_push_ops,
                                                rule_rows)
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain

    D, C = cfg.embedx, cfg.capacity
    conf = cfg.table().optimizer
    inp = push_inputs(cfg, files, feed)
    ids, live, kind = inp["ids"], inp["live"], inp["kind"]
    K, n_uniq, n_valid = ids.shape[0], inp["n_uniq"], inp["n_valid"]
    n_active = int(np.unique(ids[live]).size)
    p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["perm"], segment_offsets(inp["inv"], n_valid), inp["uids"]))
    created = torch.from_numpy(
        np.unique(ids[live & (kind[ids] == 0)]).astype(np.int32)).to(dev)
    hot_ids = ids.copy()
    hot_ids[:1000] = hot_ids[0]
    h_uids, h_perm, h_inv, h_n = dedup_ids(hot_ids, C)
    hot = tuple(torch.from_numpy(x).to(dev) for x in (
        h_uids, h_perm, segment_offsets(h_inv, n_valid))) + (h_n,)
    rng = np.random.RandomState(14)
    records = []
    for rule, e, dt in RULE_FORMS:
        layout = ValueLayout(D, rule, e, dt)
        push = PushLayout.of(layout)
        grads = np.zeros((K, push.width), np.float32)
        grads[:, :4 + D] = inp["grads"]
        grads[:, push.expand_g:] = rng.randn(K, e) * 0.2 * live[:, None]
        g = torch.from_numpy(grads).to(dev)
        slab = device_slab(torch, rule_rows(layout, inp["slab"], conf),
                           layout, dev)
        err = push_check(torch, slab, g, u, p, o, n_uniq, created, layout,
                         conf, SEED)
        if e:
            # a hot key: phase 4's 1,000-occurrence run, more than a tile
            # of the lane-group design stages
            err = max(err, push_check(torch, slab, g, *hot, created[:0],
                                      layout, conf, SEED))
        nbytes = fused_push_bytes(n_valid, n_uniq, layout.device_width,
                                  push.width, 2 if layout.bf16 else 4)
        ops = rule_push_ops(layout, n_valid, n_active)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
        args = (slab, g, p, o, u)
        ms = time_chain(lambda *a: pk.push_adagrad(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes)
        plain_ms = time_chain(lambda *a: pk.push_adagrad_fused_plain(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes)
        inplace_ms = time_chain(lambda *a: pk.push_adagrad(
            *a, n_uniq, SEED, layout, conf), args, nbytes)
        name = pk.push_form(layout)
        log("%s (W=%d, device row %d x %d B, G=%d): bit-equal to the plain "
            "version in both write modes at the flagship batch (K=%d "
            "n_valid=%d n_uniq=%d); rows out %.5f ms (in place %.5f ms), "
            "plain %.4f ms, bound %.5f ms (%d B, %d ops)"
            % (name, layout.width, layout.device_width,
               2 if layout.bf16 else 4, push.width, K, n_valid, n_uniq, ms,
               inplace_ms, plain_ms, bound, nbytes, ops))
        records.append({
            "name": name, "route": "cuda",
            "source": "paddlebox_tpu_torch/csrc/push_adagrad.cu",
            "replaces": "paddlebox_tpu/embedding/pallas_push.py:41",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS else "operations"),
            "library_ms": None, "in_place_ms": inplace_ms,
            "bytes": nbytes})
        del slab, g, args
    forms = ([(r, d, 0) for r in ("adam", "adam_shared", "naive")
              for d in pk.KERNEL_RULE_DIMS]
             + [(r, d, e) for r in ("adagrad", "naive")
                for d, e in pk.KERNEL_EXPAND_DIMS])
    err = push_width_cases(torch, dev, [
        ValueLayout(d, r, e, dt) for r, d, e in forms
        for dt in ("float32", "bfloat16")])
    log("push forms of the other rules and the expand block: bit-equal to "
        "their plain versions in both write modes on a small batch with a "
        "hot key, at (rule, embedx, expand) %s, f32 and bf16 slab"
        % (forms,))
    for r in records:
        r["max_abs_err"] = max(r["max_abs_err"], err)
    del p, o, u, created, hot

    # the pull at the new row widths: gather_rows against index_select
    pull = {}
    i = torch.from_numpy(ids).to(dev)
    gen = torch.Generator(device=dev).manual_seed(37)
    for W in RULE_PULL_WIDTHS:
        src = torch.rand((C, W), generator=gen, device=dev)
        got = rk.gather_rows(src, i)
        torch.cuda.synchronize()
        check(torch.equal(got, src.index_select(0, i))
              and torch.equal(got, rk.gather_rows_plain(src, i)),
              "gather_rows at the pull, W=%d, differs from index_select"
              % W)
        nbytes = gather_bytes(ids, C, W)
        pull["pull_w%d" % W] = {
            "ids": K, "distinct": int(np.unique(ids).size), "bytes": nbytes,
            "ms": time_chain(rk.gather_rows, (src, i), nbytes),
            "plain_ms": time_chain(rk.gather_rows_plain, (src, i), nbytes),
            "library_ms": time_chain(lambda a, b: a.index_select(0, b),
                                     (src, i), nbytes),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        log("gather_rows at the pull, src [%d, %d] f32: bit-equal to "
            "index_select; %s" % (C, W, json.dumps(pull["pull_w%d" % W])))
        del src, got
    return records, pull


def rules_phase(torch, feed, files, windows, reset_counts, counts):
    """Phase 14, the other in-table rules and the expand block at full
    width: two passes of each of flagship.RULE_FLAGSHIPS (launches of its
    push form and gather_rows as the main path's, its digits held to
    RULE_DIGITS), a test pass of FLAGSHIP_EXPAND after its two (held to
    EXPAND_TEST_PASS_DIGITS), a 4-batch FLAGSHIP_ADAM pass blocked and
    scatter bit-identical, and a 4-batch pass of each bf16 form of
    RULE_FORMS. Returns its records."""
    import numpy as np

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.train import flagship

    out = {"passes": {}, "launches": {}}
    for name, cfg in flagship.RULE_FLAGSHIPS.items():
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        layout = trainer.table.layout
        check(layout == cfg.layout(), "%s built layout %s" % (name, layout))
        form = pk.push_form(layout)
        reset_counts()
        passes = main_passes(torch, trainer, ds)
        launches = counts()
        steps = sum(p["batches"] for p in passes)
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        check(extra == 3 and launches == f32_launches(
                  **{form: steps}, gather_rows=steps + extra),
              "%s launches %s over %d steps and %d promotes and write-backs"
              % (name, launches, steps, extra))
        slab = trainer.table.slab
        check(tuple(slab.shape) == (cfg.capacity, layout.width),
              "%s slab %s" % (name, tuple(slab.shape)))
        k, v = sorted_store(trainer.table)
        check(np.isfinite(v).all() and v.shape[1] == layout.width,
              "%s host store not finite or of width %d" % (name, v.shape[1]))
        for p in passes:
            log("%s pass %d: loss %.10f auc %.10f %s"
                % (name, p["pass"], p["loss"], p["auc"], json.dumps(p)))
        digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
                  "auc": tuple("%.10f" % p["auc"] for p in passes)}
        want = flagship.RULE_DIGITS[name]
        log("%s digits %s; launches %s; slab %d B (W=%d); %s"
            % (name, json.dumps(digits), launches,
               slab.numel() * slab.element_size(), layout.width,
               card_line()))
        if want is not None:
            check(digits == want, "%s digits %s, expected %s"
                  % (name, digits, want))
        out["passes"][name] = passes
        out["launches"][name] = launches
        del slab
        if name == "expand":
            out["test_pass"] = eval_phase(
                torch, trainer, windows[2], feed, reset_counts, counts,
                digits=flagship.EXPAND_TEST_PASS_DIGITS,
                tag="expand test pass")
        trainer.close()
        del trainer, ds
    out["blocked"] = blocked_phase(torch, flagship.FLAGSHIP_ADAM, feed,
                                   files)
    out["forms"] = {pk.push_form(flagship.RULE_FLAGSHIPS[n].layout()):
                    c[pk.push_form(flagship.RULE_FLAGSHIPS[n].layout())]
                    for n, c in out["launches"].items()}
    # the forms of RULE_FORMS no configuration above runs, on the trainer's
    # path: 4 batches each
    for cfg in (dataclasses.replace(flagship.FLAGSHIP_EXPAND,
                                    optimizer="naive"),
                dataclasses.replace(flagship.FLAGSHIP_ADAM,
                                    slab_embed_dtype="bfloat16"),
                dataclasses.replace(flagship.FLAGSHIP_EXPAND,
                                    slab_embed_dtype="bfloat16")):
        t, d = flagship.build_trainer(files[:1], feed, cfg, "scatter",
                                      "cuda")
        form = pk.push_form(t.table.layout)
        two = cfg.slab_embed_dtype == "bfloat16"
        before = dict(t.table.counters)
        reset_counts()
        res, auc, _ = run_pass(torch, t, d)
        c = counts()
        # the pull once a step; the write-back on gather_rows (its raw
        # 2-byte form on the bf16 slab)
        extra = gather_launches_of(counter_delta(before, t.table))
        n = res["batches"]
        check(c == f32_launches(**{form: n}, **(
                  {"gather_rows_decode": n, "gather_rows_2byte": extra}
                  if two else {"gather_rows": n + extra}))
              and np.isfinite(res["loss"]) and 0.0 < auc <= 1.0,
              "%s pass launches %s over %d steps and %d write-backs, loss "
              "%r auc %r" % (form, c, n, extra, res["loss"], auc))
        log("%s pass over %d batches: loss %.10f auc %.10f launches %s"
            % (form, res["batches"], res["loss"], auc, c))
        out["launches"][form] = c
        out["forms"][form] = c[form]
        t.close()
        del t, d
    return out


# phase 15's ESMM test pass (predict_batches over the zoo's third window
# after FLAGSHIP_ESMM's two passes on its first), its AUC, "%.10f"
ZOO_TEST_PASS_DIGITS = "0.5307489483"


# the relative gap allowed between the card's data_norm sums of the dense
# tail and their host replay (both f32 sums of the same rows over two
# passes, reduced in different orders)
DN_SUM_RTOL = 1e-5


def dn_replay(batches, cols, decay, state=None):
    """The data_norm summaries (batch_size, batch_sum, batch_square_sum)
    of the dense columns ``cols``, one show-skip block whose show is the
    first of them, after ``batches`` (in step order) from ``state`` (the
    init: 1e4, 0, 1e4), replayed on the host as the device applies the rule
    (ops/data_norm.py data_norm_summary_update): each decays, then adds the
    block's live rows (show at least 1e-7 in magnitude): their count,
    their sum and their squared distances from the summaries' mean. The
    count in f32 as the device keeps it; the sums in f64."""
    import numpy as np
    n = len(cols)
    if state is None:
        state = (np.full(n, 1e4, np.float32), np.zeros(n),
                 np.full(n, 1e4))
    size, total, square = state
    d = np.float32(decay)
    for b in batches:
        x = b.dense[:, cols].astype(np.float64)
        live = np.abs(b.dense[:, cols[0]]) >= np.float32(1e-7)
        mean = total / size.astype(np.float64)
        size = np.float32(size * d) + np.float32(live.sum())
        total = total * float(d) + x[live].sum(axis=0)
        square = square * float(d) + ((x[live] - mean) ** 2).sum(axis=0)
    return size, total, square


def zoo_passes(torch, trainer, ds):
    """main_passes for a zoo configuration: ESMM's ctcvr_auc in each
    pass's record and, for a data_norm model, the dense tail's summaries
    checked against dn_replay after each pass: batch_size bit for bit,
    batch_sum and batch_square_sum within DN_SUM_RTOL."""
    import numpy as np

    from paddlebox_tpu_torch.train.trainer import uses_data_norm
    replay = {}
    metrics = trainer.metrics
    m = trainer.model

    def after_pass(rec):
        if "ctcvr_auc" in metrics.metric_names():
            rec["ctcvr_auc"] = metrics.get_metric_msg("ctcvr_auc")["auc"]
        if not uses_data_norm(m):
            return
        check(all(b.dtype == torch.float32 for b in m.buffers()),
              "ctr_dnn summaries not f32")
        size, total, square = (t.cpu().numpy() for t in m.dn_state())
        # this pass's batches in step order (the pass's shuffle)
        order = ds.split_batches(1)[0]
        S, W = m.spec.num_slots, m.dn_slot_dim
        gaps = {}
        for start in range(S * W, size.size, W):
            col = start - S * W
            cols = list(range(col, min(col + W, size.size - S * W)))
            at = slice(start, start + len(cols))
            replay[col] = dn_replay(order, cols, m.dn_decay,
                                    replay.get(col))
            r_size, r_total, r_square = replay[col]
            gaps[col] = [float(np.max(np.abs(dev - rep) / np.abs(rep)))
                         for dev, rep in ((total[at], r_total),
                                          (square[at], r_square))]
            check(np.array_equal(size[at], r_size)
                  and max(gaps[col]) <= DN_SUM_RTOL,
                  "ctr_dnn pass %d summaries of columns %d..%d: batch_size "
                  "%s, replay %s; sum and square-sum gaps %s (rtol %g)"
                  % (rec["pass"], at.start, at.stop, size[at], r_size,
                     gaps[col], DN_SUM_RTOL))
        blocks = size[:S * W].reshape(S, W)
        check((blocks == blocks[:, :1]).all()
              and (blocks > 1e4 * m.dn_decay ** (2 * 16)).all(),
              "ctr_dnn slot blocks' batch_size %s" % blocks[:, 0])
        rec["dn_summary"] = {
            "dense_tail_batch_size": {str(k): float(v[0][0])
                                      for k, v in replay.items()},
            "dense_tail_rel_gaps": {str(k): v for k, v in gaps.items()},
            "slot_blocks_batch_size": blocks[:, 0].tolist()}

    return main_passes(torch, trainer, ds, after_pass)


def zoo_phase(torch, windows, feed, main, reset_counts, counts, spawned):
    """Phase 15, the model zoo at full width over the hybrid files
    (``windows``, flagship.write_cadence's: the passes train on the first,
    ESMM's test pass reads the third, files none of them trained on): two
    passes of each of flagship.ZOO_FLAGSHIPS (launches as the main path's,
    digits held to ZOO_DIGITS, CtrDnn's summaries replayed), MMoE's
    second pass profiled in the ``spawned`` process (a
    ProcessPoolExecutor of one spawned worker that has not yet used the
    card), a 4-batch MMoE pass blocked and scatter, one
    sparse_chunk_sync pass and a test pass of ESMM, one bf16 pass of
    FLAGSHIP_CTR_DNN; walls beside the DeepFM main path's ``main`` passes.
    Returns its records."""
    import numpy as np

    from paddlebox_tpu_torch import profile_pass
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    files = windows[0]
    out = {"passes": {}, "launches": {}}
    check(feed.task_label_slots == (("cvr", "label_cvr"),)
          and sum(s.dim for s in feed.used_dense_slots()) == 13,
          "zoo feed %s" % (feed,))
    for name, cfg in flagship.ZOO_FLAGSHIPS.items():
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        reset_counts()
        passes = zoo_passes(torch, trainer, ds)
        launches = counts()
        steps = sum(p["batches"] for p in passes)
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        check(extra == 3 and launches == f32_launches(
                  push_adagrad=steps, gather_rows=steps + extra),
              "%s launches %s over %d steps and %d promotes and write-backs"
              % (name, launches, steps, extra))
        digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
                  "auc": tuple("%.10f" % p["auc"] for p in passes)}
        if name == "esmm":
            digits["ctcvr_auc"] = tuple("%.10f" % p["ctcvr_auc"]
                                        for p in passes)
        for p in passes:
            log("zoo %s pass %d: loss %.10f auc %.10f %s"
                % (name, p["pass"], p["loss"], p["auc"], json.dumps(p)))
        log("zoo %s digits %s; launches %s; %s"
            % (name, json.dumps(digits), launches, card_line()))
        want = flagship.ZOO_DIGITS[name]
        if want is not None:
            check(digits == want, "zoo %s digits %s, expected %s"
                  % (name, digits, want))
        out["passes"][name] = passes
        out["launches"][name] = launches
        if name == "mmoe":
            # the pinned ring's leaves: the dense and labels_cvr leaves
            # beside the main path's 7, in their own dtypes
            spec = trainer._ring._spec
            C, B = trainer.cfg.scan_chunk, cfg.batch
            check(len(spec) == 9
                  and spec["dense"] == ((C, B, 13), np.dtype(np.float32))
                  and spec["labels_cvr"] == ((C, B), np.dtype(np.int32)),
                  "MMoE staging ring spec %s" % spec)
            # the second of two passes, profiled in the spawned process
            # (its first torch.profiler session: a second one in a process
            # has come back short of device events) while this one waits:
            # 9 pinned copies a chunk
            prof = spawned.submit(profile_pass.profile_config, cfg, files,
                                  feed).result()
            n_chunks = prof["batches"] // C
            check(prof["h2d_copies"]["pinned"]["copies"] == 9 * n_chunks,
                  "an MMoE chunked pass made %s host-to-device copies, "
                  "expected 9 pinned a chunk" % prof["h2d_copies"])
            log("profile_pass, MMoE chunked pass (ring leaves %s): %s"
                % (sorted(spec), json.dumps(prof)))
            out["profile"] = prof
        if name == "esmm":
            out["test_pass"] = eval_phase(
                torch, trainer, windows[2], feed, reset_counts, counts,
                digits=ZOO_TEST_PASS_DIGITS, tag="esmm test pass")
        trainer.close()
        del trainer, ds
    out["mmoe_blocked"] = blocked_phase(torch, flagship.FLAGSHIP_MMOE, feed,
                                        files)

    # --- one chunk-synchronous ESMM pass: one pull and one push a chunk
    trainer, ds = flagship.build_trainer(files, feed, flagship.FLAGSHIP_ESMM,
                                         "scatter", "cuda",
                                         sparse_chunk_sync=True)
    reset_counts()
    res, auc, secs = run_pass(torch, trainer, ds)
    c = counts()
    n_chunks = res["batches"] // trainer.cfg.scan_chunk
    check(c == f32_launches(push_adagrad=n_chunks, gather_rows=n_chunks + 1)
          and np.isfinite(res["loss"]) and 0.0 < auc <= 1.0,
          "esmm sparse_chunk_sync launches %s over %d chunks, loss %r auc "
          "%r" % (c, n_chunks, res["loss"], auc))
    out["esmm_sync"] = {"loss": res["loss"], "auc": auc,
                        "ctcvr_auc": trainer.metrics.get_metric_msg(
                            "ctcvr_auc")["auc"],
                        "pass_s": secs, "launches": c}
    log("zoo esmm sparse_chunk_sync pass: %s" % json.dumps(out["esmm_sync"]))
    trainer.close()
    del trainer, ds

    # --- one bf16 CtrDnn pass: the summaries stay f32 and move
    cfg = dataclasses.replace(flagship.FLAGSHIP_CTR_DNN,
                              compute_dtype="bfloat16")
    trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter", "cuda")
    before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    reset_counts()
    res, auc, secs = run_pass(torch, trainer, ds)
    c = counts()
    bufs = dict(trainer.model.named_buffers())
    check(all(b.dtype == torch.float32 and not torch.equal(b, before[k])
              for k, b in bufs.items())
          and np.isfinite(res["loss"]) and 0.0 < auc <= 1.0
          and c == f32_launches(push_adagrad=res["batches"],
                                gather_rows=res["batches"] + 1),
          "bf16 ctr_dnn pass: buffers %s, loss %r auc %r launches %s"
          % ({k: str(b.dtype) for k, b in bufs.items()}, res["loss"], auc,
             c))
    out["ctr_dnn_bf16"] = {"loss": res["loss"], "auc": auc, "pass_s": secs,
                           "launches": c,
                           "summary_dtypes": sorted(
                               {str(b.dtype) for b in bufs.values()})}
    log("zoo ctr_dnn bf16 pass: %s" % json.dumps(out["ctr_dnn_bf16"]))
    trainer.close()
    del trainer, ds

    walls = {"deepfm_main_path": [(p["pass_s"], p["examples_per_s"])
                                  for p in main]}
    walls.update({n: [(p["pass_s"], p["examples_per_s"]) for p in ps]
                  for n, ps in out["passes"].items()})
    log("zoo pass walls (s, examples/s): %s; %s"
        % (json.dumps(walls), card_line()))
    out["walls"] = walls
    return out


# phase 16's cmatch-rank metric: the join channels' first ranks, as
# (cmatch, rank) pairs and as the metric's group string
JOIN_PAIRS = {(222, 1), (222, 2), (222, 3), (223, 1)}
JOIN_GROUP = ",".join("%d_%d" % p for p in sorted(JOIN_PAIRS))


def join_small_parity(torch, tmp):
    """Phase 16's small-input check: two passes of a narrow JoinPvDnn
    over the rank-offset feed on the card and on the CPU (plain
    versions); loss rtol 1e-4, AUC 1e-4 absolute, host rows rtol 1e-4, as
    phase 3 holds DeepFM."""
    import numpy as np

    from paddlebox_tpu_torch.train import flagship
    small = dataclasses.replace(
        flagship.FLAGSHIP_JOIN_PV, num_slots=4, batch=32, max_len=3,
        hidden=(16, 8), capacity=1024, num_files=2, lines_per_file=96,
        vocab_per_slot=60, data_seed=7)
    files, feed = flagship.write_files(os.path.join(tmp, "join_small"),
                                       small)
    out = {}
    for device in ("cuda", "cpu"):
        t, ds = flagship.build_trainer(files, feed, small, "scatter", device)
        res = []
        for _ in range(2):
            r, auc, _ = run_pass(torch, t, ds, load=True)
            res.append((r["loss"], auc))
        out[device] = (res, t.table.store.lookup(t.table.pass_keys),
                       t.params["rank_param"])
        t.close()
    for (lc, ac), (lp, ap) in zip(out["cuda"][0], out["cpu"][0]):
        check(np.isfinite(lc) and abs(lc - lp) <= 1e-4 * abs(lp)
              and abs(ac - ap) <= 1e-4,
              "join small-input cuda (%r, %r) vs cpu (%r, %r)"
              % (lc, ac, lp, ap))
    check(np.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6)
          and np.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                          atol=1e-6),
          "join small-input host rows or rank_param differ between cuda "
          "and cpu")
    log("join small-input parity cuda vs cpu: %s / %s"
        % (out["cuda"][0], out["cpu"][0]))


def pv_split(records, batch, max_rank=3):
    """A pass's rows by their pv fields alone, ``records`` in step order
    (train_pass shuffles them in place and packs ``batch`` at a time): not
    in the join (a channel other than 222 and 223, or a rank outside
    1..max_rank), in it with no other joined ad of its pv in its batch,
    and with at least one."""
    split = [0, 0, 0]
    for s in range(0, len(records), batch):
        chunk = records[s:s + batch]
        joined = [r for r in chunk
                  if r.cmatch in (222, 223) and 0 < r.rank <= max_rank]
        per_pv = collections.Counter(r.search_id for r in joined)
        split[0] += len(chunk) - len(joined)
        for r in joined:
            split[1 if per_pv[r.search_id] == 1 else 2] += 1
    return split


def check_launches(name, passes, launches):
    """A configuration's two passes launched push_adagrad once a step and
    gather_rows once a step, once a promote and once a write-back (35)."""
    steps = sum(p["batches"] for p in passes)
    extra = sum(gather_launches_of(p["counters"]) for p in passes)
    check(steps == 32 and extra == 3 and launches == f32_launches(
              push_adagrad=steps, gather_rows=steps + extra),
          "%s launches %s over %d steps and %d promotes and write-backs"
          % (name, launches, steps, extra))


def held_digits(name, passes, want):
    digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
              "auc": tuple("%.10f" % p["auc"] for p in passes)}
    log("%s digits %s" % (name, json.dumps(digits)))
    if want is not None:
        check(digits == want, "%s digits %s, expected %s"
              % (name, digits, want))
    return digits


def join_phase(torch, files, feed, aux_files, aux_feed, main, reset_counts,
               counts, tmp):
    """Phase 16, the join phase's record-path feeds at full width:
    FLAGSHIP_JOIN_PV's two passes over the main path's files with the pv
    rank-offset feed (flagship.assign_pv's pvs), FLAGSHIP_AUX's two over
    ``aux_files`` (ins_id lines) through an InputTable and a 4-batch pass
    through a ReplicaCache, a narrow JoinPvDnn on the card against the
    CPU; walls beside the DeepFM main path's ``main`` passes. Returns its
    records."""
    import numpy as np

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    out = {}
    join_small_parity(torch, tmp)

    # --- JoinPvDnn over the pv rank-offset feed
    cfg = flagship.FLAGSHIP_JOIN_PV
    jfeed = flagship.feed_for(cfg, feed)
    trainer, ds = flagship.build_trainer(files, jfeed, cfg, "scatter",
                                         "cuda")
    check(jfeed.rank_offset and not ds.columnar,
          "the rank-offset feed ran columnar")
    trainer.metrics.init_cmatch_rank_metric(
        "cmatch_auc", "label", "pred", JOIN_GROUP, table_size=1 << 20)
    param0 = trainer.model.rank_param.detach().clone()
    host = {"cmatch_n": 0}

    def after_join(rec):
        # counted from the records' pv fields, past the packer and the
        # metric
        host["cmatch_n"] += sum((r.cmatch, r.rank) in JOIN_PAIRS
                                for r in ds.records)
        rec["pv_split"] = pv_split(ds.records, cfg.batch)
        rec["cmatch_auc"] = trainer.metrics.get_metric_msg(
            "cmatch_auc")["auc"]
        rec["cmatch_counts"] = {str(k): v for k, v in sorted(
            collections.Counter(r.cmatch for r in ds.records).items())}

    reset_counts()
    passes = main_passes(torch, trainer, ds, after_join, load=True)
    launches = counts()
    check_launches("join_pv", passes, launches)
    for p in passes:
        log("join_pv pass %d: loss %.10f auc %.10f cmatch_auc %.10f %s"
            % (p["pass"], p["loss"], p["auc"], p["cmatch_auc"],
               json.dumps(p)))
    digits = held_digits("join_pv", passes, flagship.JOIN_DIGITS)
    size = trainer.metrics.get_metric_msg("cmatch_auc")["size"]
    check(size == host["cmatch_n"] > 0,
          "cmatch_rank metric counted %r instances, the host %d"
          % (size, host["cmatch_n"]))
    moved = float((trainer.model.rank_param.detach() - param0).abs().max())
    check(moved > 0, "rank_param did not move")
    spec = trainer._ring._spec
    C, B = trainer.cfg.scan_chunk, cfg.batch
    check(len(spec) == 8
          and spec["rank_offset"] == ((C, B, 7), np.dtype(np.int32)),
          "JoinPvDnn staging ring spec %s" % spec)
    tags = trainer.quality.report()["tags"]
    check({"cmatch:222", "cmatch:223"} <= set(tags),
          "quality plane tags %s" % sorted(tags))
    split = [p["pv_split"] for p in passes]
    check(all(sum(s) == p["instances"] and min(s) > 0
              for s, p in zip(split, passes)),
          "pv split %s" % split)
    out["join_pv"] = {"passes": passes, "launches": launches,
                      "digits": digits, "cmatch_instances": size,
                      "rank_param_max_move": moved,
                      "ring_leaves": sorted(spec),
                      "quality_cmatch": {t: tags[t] for t in tags
                                         if t.startswith("cmatch:")}}
    log("join_pv: cmatch_auc %.10f over %d instances (host %d), rank_param "
        "moved by up to %.6g, ring leaves %s, pv split (no join, self only, "
        "with a peer) %s, quality %s; launches %s; %s"
        % (passes[-1]["cmatch_auc"], size, host["cmatch_n"], moved,
           sorted(spec), split, json.dumps(out["join_pv"]["quality_cmatch"]),
           launches, card_line()))
    trainer.close()
    del trainer, ds

    # --- CtrDnnAux through an InputTable
    cfg = flagship.FLAGSHIP_AUX
    table = flagship.input_table(cfg)
    trainer, ds = flagship.build_trainer(aux_files, aux_feed, cfg,
                                         "scatter", "cuda",
                                         aux_source=table)
    check(not ds.columnar and ds.packer.input_table is table,
          "the aux feed ran columnar or without its table")
    host_miss = [0]

    def after_aux(rec):
        host_miss[0] += sum(r.ins_id not in table for r in ds.records)

    reset_counts()
    passes = main_passes(torch, trainer, ds, after_aux, load=True)
    launches = counts()
    check_launches("aux", passes, launches)
    for p in passes:
        log("aux pass %d: loss %.10f auc %.10f %s"
            % (p["pass"], p["loss"], p["auc"], json.dumps(p)))
    digits = held_digits("aux", passes, flagship.AUX_DIGITS)
    cap = trainer.model.aux_capacity
    check(cap == 4096
          and torch.equal(trainer.model.aux_rows,
                          table.to_device(cap, "cuda"))
          and trainer.model.aux_rows.dtype == torch.float32,
          "aux_rows differ from the table's to_device(%d)" % cap)
    check(table.miss == host_miss[0] > 0, "InputTable missed %d, the host "
          "counts %d" % (table.miss, host_miss[0]))
    spec = trainer._ring._spec
    C, B = trainer.cfg.scan_chunk, cfg.batch
    check(len(spec) == 8
          and spec["aux_offset"] == ((C, B), np.dtype(np.int32)),
          "CtrDnnAux staging ring spec %s" % spec)
    out["aux"] = {"passes": passes, "launches": launches, "digits": digits,
                  "miss": table.miss, "table_rows": table.size(),
                  "ring_leaves": sorted(spec)}
    log("aux: %d table rows, %d misses over %d lookups (host %d), aux_rows "
        "bit-equal to the table, ring leaves %s; launches %s; %s"
        % (table.size(), table.miss, sum(p["instances"] for p in passes),
           host_miss[0], sorted(spec), launches, card_line()))
    trainer.close()
    del trainer, ds

    # --- a 4-batch CtrDnnAux pass through a ReplicaCache by cache_idx
    cache = flagship.replica_cache(cfg)
    trainer, ds = flagship.build_trainer(aux_files[:1], aux_feed, cfg,
                                         "scatter", "cuda",
                                         aux_source=cache)
    check(ds.packer.use_cache_idx, "the replica pass has no cache_idx")
    reset_counts()
    res, auc, secs = run_pass(torch, trainer, ds, load=True)
    c = counts()
    check(res["batches"] == 4 and np.isfinite(res["loss"])
          and 0.0 < auc <= 1.0
          and c == f32_launches(push_adagrad=4, gather_rows=5)
          and torch.equal(trainer.model.aux_rows,
                          cache.to_device(cap, "cuda")),
          "replica-cache pass: loss %r auc %r launches %s"
          % (res["loss"], auc, c))
    out["aux_replica"] = {"loss": res["loss"], "auc": auc, "pass_s": secs,
                          "launches": c, "cache_rows": len(cache)}
    log("aux replica-cache pass: %s" % json.dumps(out["aux_replica"]))
    trainer.close()
    del trainer, ds

    walls = {"deepfm_main_path": [(p["pass_s"], p["examples_per_s"])
                                  for p in main]}
    walls.update({n: [(p["pass_s"], p["examples_per_s"])
                      for p in out[n]["passes"]] for n in ("join_pv", "aux")})
    log("join pass walls (s, examples/s): %s; %s"
        % (json.dumps(walls), card_line()))
    out["walls"] = walls
    return out


# phase 17's two full-width passes of FLAGSHIP_BST (SeqCtrTrainer, seed
# 0, the main path's incremental lifecycle, one step a batch) and of the
# DeepFM main path under the dense optimizers sgd and adagrad (scatter,
# chunks of 8): loss and AUC a pass, "%.10f"; the values later slices hold
BST_DIGITS = {"loss": ("0.6859792247", "0.5731987171"),
              "auc": ("0.4945789856", "0.7145192494")}
SGD_DIGITS = {"loss": ("0.7063000202", "0.7277045250"),
              "auc": ("0.4997957130", "0.4812856946")}
DENSE_ADAGRAD_DIGITS = {"loss": ("0.7057331800", "0.7203068137"),
                        "auc": ("0.4995931987", "0.4982919981")}
# the seqpool variants on the card against the CPU at a flagship batch
# (sorted segment sums of the same f32 values, reduced in another order)
VARIANT_RTOL = 1e-5


def file_key_occurrences(files, feed):
    """The sparse key occurrences of ``files`` counted from the text
    itself (MultiSlot lines: the click, then each slot's count and keys),
    each slot's run cut at its max_len: what the pooled path packs, past
    the parser and the packer."""
    lens = [s.max_len for s in feed.used_sparse_slots()]
    total = 0
    for path in files:
        with open(path) as f:
            for line in f:
                tok = line.split()
                at = 2
                for cap in lens:
                    n = int(tok[at])
                    total += min(n, cap)
                    at += 1 + n
    return total


def seq_small_parity(torch, tmp):
    """Phase 17's small-input check: two passes of a narrow BstSeqCtr (4
    slots, history slot 0 of up to 8 keys, T 8) through SeqCtrTrainer on
    the card and on the CPU (plain versions); loss rtol 1e-4, AUC 1e-4
    absolute, host rows and pos_emb rtol 1e-4, as phase 3 holds DeepFM."""
    import numpy as np

    from paddlebox_tpu_torch.train import flagship
    small = dataclasses.replace(
        flagship.FLAGSHIP_BST, num_slots=4, batch=32, max_len=3,
        hidden=(16, 8), capacity=1024, num_files=2, lines_per_file=96,
        vocab_per_slot=60, data_seed=7, seq_len=8)
    files, feed = flagship.write_files(os.path.join(tmp, "seq_small"),
                                       small)
    out = {}
    for device in ("cuda", "cpu"):
        t, ds = flagship.build_seq_trainer(files, feed, small, device)
        res = [run_pass(torch, t, ds)[:2] for _ in range(2)]
        out[device] = ([(r["loss"], a) for r, a in res],
                       t.table.store.lookup(t.table.pass_keys),
                       t.params["pos_emb"])
    for (lc, ac), (lp, ap) in zip(out["cuda"][0], out["cpu"][0]):
        check(np.isfinite(lc) and abs(lc - lp) <= 1e-4 * abs(lp)
              and abs(ac - ap) <= 1e-4,
              "seq small-input cuda (%r, %r) vs cpu (%r, %r)"
              % (lc, ac, lp, ap))
    check(np.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6)
          and np.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                          atol=1e-6),
          "seq small-input host rows or pos_emb differ between cuda and "
          "cpu")
    log("seq small-input parity cuda vs cpu: %s / %s"
        % (out["cuda"][0], out["cpu"][0]))


def seq_kernel_phase(torch, files, feed, dev):
    """Phase 17, the path's two kernels at BST's shapes: gather_rows at
    the sequence pull (the first BST batch's [1024, 20] history ids from a
    2^20 x 17 slab) and the fused push_adagrad over the concatenated push
    rows (the batch's pooled key slots, then its 20,480 sequence
    positions, the sequence rows' show and click 0), each bit-equal to its
    plain version; kernel, plain, library (index_select for the gather)
    and bound times. Returns {kernel: record}."""
    import numpy as np

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import segment_offsets
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import (SEED, fused_push_bytes,
                                                push_inputs)
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP_BST
    D = cfg.embedx
    layout = ValueLayout(D)
    conf = cfg.table().optimizer
    push = PushLayout(D)
    W, G = layout.width, push.width
    pool_ids, seq = flagship.first_seq_batch_ids(files, feed, cfg)
    seq_ids = seq.reshape(-1)
    ids = np.concatenate([pool_ids, seq_ids])
    inp = push_inputs(cfg, files, feed, ids=ids)
    # the sequence rows carry gradient only
    inp["grads"][pool_ids.size:, push.SHOW:push.CLICK + 1] = 0.0
    K, n_uniq, n_valid = ids.shape[0], inp["n_uniq"], inp["n_valid"]
    slab, g, p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["slab"], inp["grads"], inp["perm"],
        segment_offsets(inp["inv"], n_valid), inp["uids"]))
    check(K == pool_ids.size + cfg.batch * cfg.seq_len
          and int(o[-1]) == n_valid,
          "BST push inputs: %d ids, offsets end %d, n_valid %d"
          % (K, int(o[-1]), n_valid))
    out = {}

    # --- gather_rows, the sequence pull
    i = torch.from_numpy(seq_ids).to(dev)
    got = rk.gather_rows(slab, i)
    torch.cuda.synchronize()
    want = rk.gather_rows_plain(slab, i)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(got, slab.index_select(0, i)),
          "gather_rows at the sequence pull differs from the plain version")
    nbytes = gather_bytes(seq_ids, cfg.capacity, W)
    args = (slab, i)
    out["gather_rows"] = {
        "ids": int(seq_ids.size),
        "valid": int((seq_ids != cfg.capacity - 1).sum()),
        "distinct": int(np.unique(seq_ids).size), "bytes": nbytes,
        "max_abs_err": float((got - want).abs().max()),
        "ms": time_chain(rk.gather_rows, args, nbytes),
        "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
        "library_ms": time_chain(lambda a, b: a.index_select(0, b), args,
                                 nbytes),
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
    del got, want, i, args

    # --- push_adagrad over the concatenated push rows, both write modes
    err = 0.0
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                          layout, conf, rows_out)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
              "push_adagrad (rows_out=%s) at BST's push differs from the "
              "plain version" % rows_out)
        if rows_out:
            check(torch.equal(r_k.view(torch.int32), r_p.view(torch.int32)),
                  "push_adagrad rows out at BST's push differ")
            err = max(err, float((r_k - r_p).abs().max()))
        err = max(err, float((s_k - s_p).abs().max()))
        del s_k, s_p, r_k, r_p
    live = inp["live"]
    nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
    ops = n_valid * G + int(np.unique(ids[live]).size) * (20 + 6 * D)
    args = (slab, g, p, o, u)
    out["push_adagrad"] = {
        "push_rows": K, "occurrences": n_valid, "n_uniq": n_uniq,
        "bytes": nbytes, "max_abs_err": err,
        "ms": time_chain(lambda *a: pk.push_adagrad(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "library_ms": None,
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
                     else "operations")}
    for name, rec in out.items():
        log("%s at BST's shape: bit-equal to the plain version; %s"
            % (name, json.dumps(rec)))
    return out


def variants_phase(torch, files, feed, dev):
    """Phase 17, the seqpool variants at a flagship batch's shape (the
    first batch's 131,072 key slots and segments, seeded counter and
    embedding columns) on the card against the CPU, each flag set once
    beside the defaults, within VARIANT_RTOL (relative, and absolute
    near 0, where a log difference cancels). Returns the largest absolute
    gap by variant."""
    import numpy as np

    from paddlebox_tpu_torch.ops import seqpool as sp
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP
    ds, _ = flagship._load(files[:1], feed)
    b = ds.split_batches(1)[0][0]
    B, S, E = cfg.batch, cfg.num_slots, cfg.embedx
    rng = np.random.RandomState(17)
    K = b.keys.shape[0]

    def emb(width):
        e = (rng.rand(K, width) * 3).astype(np.float32)
        e[~b.valid] = 0.0
        return e

    thres = rng.rand(S).astype(np.float32) + 0.8
    # (name, variant, emb, its positional arguments after num_slots, the
    # flags set beside the defaults); the diff_thres variant takes each
    # key's slot after ``valid``
    cases = [
        ("with_conv", sp.fused_seqpool_cvm_with_conv, emb(3 + E), (),
         dict(need_filter=True, show_filter=True)),
        ("with_credit", sp.fused_seqpool_cvm_with_credit, emb(4 + E), (),
         dict(show_filter=True)),
        ("tradew", sp.fused_seqpool_cvm_tradew, emb(2 + 3 + E), (3,),
         dict(trade_id=1)),
        ("with_diff_thres", sp.fused_seqpool_cvm_with_diff_thres,
         emb(2 + E), (thres,), dict(xbox_diff_thres_filter=False)),
        ("with_pcoc", sp.fused_seqpool_cvm_with_pcoc, emb(4 + 3 + E), (3,),
         dict(use_cvm=False))]
    gaps = {}
    for name, fn, e, extra, flags in cases:
        gap = 0.0
        for kw in ({}, flags):
            outs = []
            for d in (dev, torch.device("cpu")):
                head = [torch.from_numpy(x).to(d)
                        for x in (e, b.segments, b.valid)]
                if name == "with_diff_thres":
                    head.append(torch.from_numpy(b.slots).to(d))
                outs.append(fn(*head, B, S, *extra, **kw).cpu())
            got, want = outs
            check(got.shape == want.shape and torch.isfinite(got).all()
                  and torch.allclose(got, want, rtol=VARIANT_RTOL,
                                     atol=VARIANT_RTOL),
                  "seqpool %s %s on the card differs from the CPU"
                  % (name, kw))
            gap = max(gap, float((got - want).abs().max()))
        gaps[name] = gap
    log("seqpool variants at a flagship batch (K=%d, [%d, %d, w]): card = "
        "cpu within rtol %g; largest absolute gaps %s"
        % (K, B, S, VARIANT_RTOL, json.dumps(gaps)))
    return gaps


def dense_adagrad_resume(torch, files, feed, root):
    """Phase 17, resume = continue under the dense adagrad:
    RecoverableRunner over two passes of FLAGSHIP_DENSE_ADAGRAD (a save
    after each) against a runner that saves after pass 1 and a fresh
    trainer and runner that resume there and train pass 2; the second
    pass's loss and AUC, the dense parameters, the accumulators and the
    sorted store bit-equal."""
    import numpy as np

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.recovery import RecoverableRunner

    cfg = flagship.FLAGSHIP_DENSE_ADAGRAD

    def run(sub, n):
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        cm = CheckpointManager(
            CheckpointConfig(batch_model_dir=os.path.join(root, sub, "b"),
                             xbox_model_dir=os.path.join(root, sub, "x")),
            trainer.table)
        runner = RecoverableRunner(trainer, cm, "day")
        at = runner.completed_passes()
        real = trainer.train_pass

        def train_pass(d):
            trainer.metrics.init_metric("auc", "label", "pred",
                                        table_size=1 << 20)
            res = real(d)
            return dict(res, auc=trainer.metrics.get_metric_msg("auc")[
                "auc"])

        trainer.train_pass = train_pass
        stats = runner.run([ds] * n)
        torch.cuda.synchronize()
        out = {"resumed_at": at, "stats": stats, "params": trainer.params,
               "acc": trainer.opt_state["sum_of_squares"],
               "store": sorted_store(trainer.table)}
        trainer.close()
        return out

    t0 = time.perf_counter()
    cont = run("continue", 2)
    run("resume", 1)
    res = run("resume", 2)
    check(cont["resumed_at"] == 0 and res["resumed_at"] == 1
          and len(res["stats"]) == 1
          and (res["stats"][0]["loss"], res["stats"][0]["auc"])
          == (cont["stats"][1]["loss"], cont["stats"][1]["auc"]),
          "dense adagrad resume: resumed at %d, %s against %s"
          % (res["resumed_at"], res["stats"], cont["stats"]))
    for k, v in cont["params"].items():
        check(np.array_equal(res["params"][k], v), "resumed param %s" % k)
    for k, v in cont["acc"].items():
        check(np.array_equal(res["acc"][k], v),
              "resumed adagrad accumulator %s" % k)
    (rk, rv), (ck, cv) = res["store"], cont["store"]
    check(np.array_equal(rk, ck)
          and np.array_equal(rv.view(np.uint32), cv.view(np.uint32)),
          "resumed store differs from the continued run's")
    log("dense adagrad resume = continue: pass 2 loss %.10f auc %.10f, "
        "params, accumulators and store bit-equal (%.2f s)"
        % (res["stats"][0]["loss"], res["stats"][0]["auc"],
           time.perf_counter() - t0))
    return {"loss": res["stats"][0]["loss"], "auc": res["stats"][0]["auc"]}


def seq_phase(torch, files, feed, bst_files, bst_feed, main, reset_counts,
              counts, tmp):
    """Phase 17: FLAGSHIP_BST's two full-width passes through
    SeqCtrTrainer over ``bst_files`` (slot 0 the history, up to 20 keys),
    a narrow BST on the card against the CPU, the two kernels at BST's
    shapes, the seqpool variants at a flagship batch, FLAGSHIP_SGD's and
    FLAGSHIP_DENSE_ADAGRAD's two passes over the main path's files with
    the adagrad resume; walls beside the DeepFM main path's ``main``
    passes. Returns its records."""
    import numpy as np

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.train import flagship

    out = {}
    dev = torch.device("cuda")
    seq_small_parity(torch, tmp)

    # --- BST through SeqCtrTrainer at full width
    cfg = flagship.FLAGSHIP_BST
    check([s.max_len for s in bst_feed.used_sparse_slots()][:2]
          == [cfg.seq_len, cfg.max_len]
          and bst_feed.key_capacity() == cfg.batch * (
              min(cfg.seq_len, 16) + (cfg.num_slots - 1) * cfg.max_len),
          "BST feed slots %s"
          % [s.max_len for s in bst_feed.used_sparse_slots()])
    trainer, ds = flagship.build_seq_trainer(bst_files, bst_feed, cfg,
                                             "cuda")
    moved0 = {n: getattr(trainer.model, n).detach().clone()
              for n in ("pos_emb", "wq")}
    host = {}

    def after_bst(rec):
        if rec["pass"] == 0:
            _, vals = trainer.table.store.state_items()
            host["show"] = float(vals[:, acc.SHOW].astype(np.float64).sum())

    reset_counts()
    passes = main_passes(torch, trainer, ds, after_bst)
    launches = counts()
    steps = sum(p["batches"] for p in passes)
    extra = sum(gather_launches_of(p["counters"]) for p in passes)
    check(steps == 32 and extra == 3 and launches == f32_launches(
              push_adagrad=steps, gather_rows=2 * steps + extra),
          "bst launches %s over %d steps and %d promotes and write-backs"
          % (launches, steps, extra))
    for p in passes:
        log("bst pass %d: loss %.10f auc %.10f %s"
            % (p["pass"], p["loss"], p["auc"], json.dumps(p)))
    digits = held_digits("bst", passes, BST_DIGITS)
    occ = file_key_occurrences(bst_files, bst_feed)
    check(host["show"] == occ,
          "after pass 1 the store's shows sum to %r, the files hold %d "
          "pooled key occurrences" % (host["show"], occ))
    moved = {n: float((getattr(trainer.model, n).detach() - v).abs().max())
             for n, v in moved0.items()}
    check(all(m > 0 for m in moved.values()), "BST params moved %s" % moved)
    out["bst"] = {"passes": passes, "launches": launches, "digits": digits,
                  "show_sum": host["show"], "file_occurrences": occ,
                  "moved": moved}
    log("bst: shows after pass 1 %.0f = the files' pooled key occurrences "
        "%d; pos_emb / wq moved by up to %s; launches %s; %s"
        % (host["show"], occ, json.dumps(moved), launches, card_line()))
    del trainer, ds

    out["kernels"] = seq_kernel_phase(torch, bst_files, bst_feed, dev)
    out["variants"] = variants_phase(torch, files, feed, dev)

    # --- the dense optimizers on the main path
    for name, cfg, want in (("sgd", flagship.FLAGSHIP_SGD, SGD_DIGITS),
                            ("dense_adagrad", flagship.FLAGSHIP_DENSE_ADAGRAD,
                             DENSE_ADAGRAD_DIGITS)):
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        check(trainer.cfg.dense_optimizer == cfg.dense_optimizer,
              "%s trainer runs %s" % (name, trainer.cfg.dense_optimizer))
        reset_counts()
        passes = main_passes(torch, trainer, ds)
        launches = counts()
        check_launches(name, passes, launches)
        for p in passes:
            log("%s pass %d: loss %.10f auc %.10f %s"
                % (name, p["pass"], p["loss"], p["auc"], json.dumps(p)))
        out[name] = {"passes": passes, "launches": launches,
                     "digits": held_digits(name, passes, want)}
        trainer.close()
        del trainer, ds
    out["dense_adagrad"]["resume"] = dense_adagrad_resume(
        torch, files, feed, os.path.join(tmp, "dense_adagrad_resume"))

    walls = {"deepfm_main_path": [(p["pass_s"], p["examples_per_s"])
                                  for p in main]}
    walls.update({n: [(p["pass_s"], p["examples_per_s"])
                      for p in out[n]["passes"]]
                  for n in ("bst", "sgd", "dense_adagrad")})
    log("seq and dense-optimizer pass walls (s, examples/s): %s; %s"
        % (json.dumps(walls), card_line()))
    out["walls"] = walls
    return out


# phase 18's runs of FLAGSHIP's two passes through the chunk driver, as
# (label, push_write, StageFlags wire fields); the first, the full wire's
# scatter run, is the one the others are held to, bit for bit
WIRE_RUNS = (
    ("full scatter", "scatter", {}),
    ("full rebuild", "rebuild", {}),
    ("uid scatter", "scatter", {"h2d_lean": True}),
    ("uid rebuild", "rebuild", {"h2d_lean": True}),
    ("uid blocked", "blocked", {"h2d_lean": True}),
    ("delta scatter", "scatter", {"h2d_lean": True, "wire_delta_ids": True}),
    ("ids_only", "scatter", {"h2d_lean": True, "h2d_uid_wire": False}),
    ("auto", "auto", {}),
)
# the continue kind's sums against the AUC kind's (the same f64 sums over
# the same predictions, divided by the same count)
METRIC_RTOL = 1e-12


def slab_sha(trainer):
    """sha256 of the table's slab (resident after end_pass)."""
    import hashlib
    return hashlib.sha256(
        trainer.table.resident_slab.cpu().numpy().tobytes()).hexdigest()


def write_launches(write, steps, extra):
    """A two-pass run's launches under ``write``: one push a step, the
    pulls, promote and write-backs on gather_rows, and one more
    gather_rows a step under 'rebuild' (the new rows spread over the slab)
    or one blocked_write a step under 'blocked'."""
    return f32_launches(
        push_adagrad=steps,
        gather_rows=steps + extra + (steps if write == "rebuild" else 0),
        blocked_write=steps if write == "blocked" else 0)


def rebuild_gather_phase(torch, cfg, files, feed, dev):
    """Phase 18, gather_rows at the rebuild write's shape: the new rows of
    the first flagship batch's push ([n_uniq, 17], push_adagrad rows out)
    spread by its clamped [2^20] position map, bit-equal to
    gather_rows_plain; kernel, plain, index_select and bound times."""
    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import (pos_for_rebuild,
                                                          segment_offsets)
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import SEED, push_inputs
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain

    layout = ValueLayout(cfg.embedx)
    inp = push_inputs(cfg, files, feed)
    n_uniq = inp["n_uniq"]
    slab, g, p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["slab"], inp["grads"], inp["perm"],
        segment_offsets(inp["inv"], inp["n_valid"]), inp["uids"]))
    rows = pk.push_adagrad(slab, g, p, o, u, n_uniq, SEED, layout,
                           cfg.table().optimizer, rows_out=True)
    pos = pos_for_rebuild(inp["uids"], cfg.capacity)
    ids_np = pos.clip(0, n_uniq - 1)
    ids = torch.from_numpy(ids_np).to(dev)
    got = rk.gather_rows(rows, ids)
    torch.cuda.synchronize()
    want = rk.gather_rows_plain(rows, ids)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "gather_rows at the rebuild shape differs from the plain version")
    nbytes = gather_bytes(ids_np, n_uniq, layout.width)
    args = (rows, ids)
    rec = {"src": [n_uniq, layout.width], "ids": int(ids_np.size),
           "placed": int((pos >= 0).sum()), "bytes": nbytes,
           "max_abs_err": float((got - want).abs().max()),
           "ms": time_chain(rk.gather_rows, args, nbytes),
           "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
           "library_ms": time_chain(lambda a, b: a.index_select(0, b), args,
                                    nbytes),
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
    log("gather_rows at the rebuild shape: bit-equal to the plain version; "
        "%s" % json.dumps(rec))
    return rec


def auto_phase(torch, cfg, files, feed, dev):
    """Phase 18, push_write='auto''s measurement: the fused push under
    'scatter', 'rebuild' and 'blocked' (push_probe.balanced_write_times,
    each ordered pair of writes once) at the first flagship batch (131,072
    key slots) and at the first chunk of 8 batches (1,048,576), both on
    the 2^20-row slab; the three writes leave the same slab bits. Logs the
    medians and the rule they give, and checks that flags'
    AUTO_REBUILD_MAX_RATIO picks the faster of scatter and rebuild at each
    shape wherever one beats the other by more than 20%."""
    import statistics

    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.push_probe import (balanced_write_times,
                                                push_inputs)
    from paddlebox_tpu_torch.train import flagship

    layout = ValueLayout(cfg.embedx)
    conf = cfg.table().optimizer
    out = {}
    for shape, ids in (("batch", None),
                       ("chunk", flagship.first_chunk_ids(files, feed, cfg,
                                                          8))):
        inp = push_inputs(cfg, files, feed, ids=ids)
        K = int(inp["ids"].shape[0])
        times, digests = balanced_write_times(inp, dev, layout, conf)
        check(len(set(digests.values())) == 1,
              "the writes left different slabs at the %s shape: %s"
              % (shape, digests))
        med = {w: statistics.median(v) for w, v in times.items()}
        ratio = cfg.capacity / K
        faster = "rebuild" if med["rebuild"] < med["scatter"] else "scatter"
        margin = max(med["rebuild"], med["scatter"]) / min(
            med["rebuild"], med["scatter"])
        chosen = flags.PushFlags("auto").resolve_push_write(
            cfg.capacity, K, "cuda")
        out[shape] = {"K": K, "n_uniq": inp["n_uniq"],
                      "capacity_over_keys": ratio, "times_ms": times,
                      "median_ms": med, "faster": faster, "margin": margin,
                      "auto": chosen}
        log("auto at the %s shape (capacity/keys %.3f): %s" % (
            shape, ratio, json.dumps(out[shape])))
        check(chosen == faster or margin <= 1.2,
              "push_write='auto' picks %r at capacity/keys %.3f, but %r "
              "was faster by %.3fx" % (chosen, ratio, faster, margin))
    wins = [o["capacity_over_keys"] for o in out.values()
            if o["faster"] == "rebuild"]
    rule = ("rebuild where capacity <= %g * batch keys" % max(wins)
            if wins else "scatter at every measured ratio")
    log("auto rule: %s (flags.AUTO_REBUILD_MAX_RATIO = %r); %s"
        % (rule, flags.AUTO_REBUILD_MAX_RATIO, card_line()))
    out["rule"] = rule
    return out


def wires_phase(torch, files, feed, reset_counts, counts):
    """Phase 18: FLAGSHIP's two passes under each of WIRE_RUNS, each held
    to the first (the full wire's scatter) and to FLAGSHIP_DIGITS: losses,
    AUC, the slab's digest after each pass and the sorted store, and its
    launches (write_launches); the bytes each run copied host to device by
    leaf (profile_pass.count_h2d_bytes); the nan_inf and continue metrics
    beside the AUC one on the first run; a sparse_chunk_sync pass on the
    uid wire held to one on the full wire; gather_rows at the rebuild
    shape; the auto measurement. Returns its records."""
    import numpy as np

    from paddlebox_tpu_torch.config.flags import StageFlags
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.profile_pass import count_h2d_bytes
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP
    dev = torch.device("cuda")
    out = {"runs": {}}
    ref = None
    for label, write, fields in WIRE_RUNS:
        stage = StageFlags(**fields)
        trainer, ds = flagship.build_trainer(files, feed, cfg, write, "cuda",
                                             stage_flags=stage)
        if ref is None:
            for kind in ("nan_inf", "continue"):
                trainer.metrics.init_metric(kind, "label", "pred",
                                            table_size=1 << 20, kind=kind)
        digests = []
        reset_counts()
        with count_h2d_bytes(trainer) as h2d:
            passes = main_passes(
                torch, trainer, ds,
                lambda rec: digests.append(slab_sha(trainer)))
        launches = counts()
        steps = sum(p["batches"] for p in passes)
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        want = write_launches(trainer.push_write, steps, extra)
        check(steps == 32 and extra == 3 and launches == want,
              "wires %s launches %s, expected %s" % (label, launches, want))
        digits = held_digits("wires " + label, passes, FLAGSHIP_DIGITS)
        store = sorted_store(trainer.table)
        run = {"wire": stage.wire, "push_write": trainer.push_write,
               "launches": launches, "slab_sha256": digests,
               "h2d_bytes": h2d.bytes,
               "h2d_bytes_a_pass": sum(h2d.bytes.values()) // 2,
               "pass_s": [p["pass_s"] for p in passes],
               "phase_s": [p["phase_s"] for p in passes]}
        if ref is None:
            ref = {"passes": passes, "digests": digests, "store": store}
            msg = {k: trainer.metrics.get_metric_msg(k)
                   for k in ("auc", "nan_inf", "continue")}
            a, c = msg["auc"], msg["continue"]
            pairs = {"mae": (c["mae"], a["mae"]),
                     "rmse": (c["rmse"], a["rmse"]),
                     "size": (c["size"], a["size"]),
                     "predicted": (c["predicted_value"],
                                   a["predicted_ctr"])}
            check(msg["nan_inf"]["nan_inf_rate"] == 0.0
                  and a["size"] > 0 and all(
                      abs(x - y) <= METRIC_RTOL * abs(y)
                      for x, y in pairs.values()),
                  "wires metrics: nan_inf %s, continue %s against auc %s"
                  % (msg["nan_inf"], c, a))
            out["metrics"] = msg
            log("wires metrics: nan_inf_rate 0; the continue kind's mae, "
                "rmse, size and predicted_value equal the AUC kind's "
                "within %g: %s" % (METRIC_RTOL, json.dumps(msg)))
        else:
            check([(p["loss"], p["auc"]) for p in passes]
                  == [(p["loss"], p["auc"]) for p in ref["passes"]]
                  and digests == ref["digests"]
                  and np.array_equal(store[0], ref["store"][0])
                  and bits_equal(store[1], ref["store"][1]),
                  "wires %s differs from the full wire's scatter run "
                  "(slabs %s against %s)" % (label, digests, ref["digests"]))
        out["runs"][label] = run
        log("wires %s pass: %s; %s" % (label, json.dumps(run), json.dumps(
            [{k: p[k] for k in ("loss", "auc", "batches", "pass_s",
                                "examples_per_s")} for p in passes])))
        trainer.close()
        del trainer, ds
    log("wires: %d runs bit-identical to the full wire's scatter run (losses, "
        "AUC, slab after each pass, store), auto resolved to %r; H2D bytes a "
        "pass by wire %s; %s"
        % (len(WIRE_RUNS), out["runs"]["auto"]["push_write"],
           json.dumps({k: r["h2d_bytes_a_pass"]
                       for k, r in out["runs"].items()}), card_line()))

    # --- the chunk shape: one sparse_chunk_sync pass on each wire
    sync = {}
    for wire, fields in (("full", {}), ("uid", {"h2d_lean": True})):
        trainer, ds = flagship.build_trainer(
            files, feed, cfg, "scatter", "cuda",
            stage_flags=StageFlags(**fields), sparse_chunk_sync=True)
        reset_counts()
        with count_h2d_bytes(trainer) as h2d:
            res, auc, secs = run_pass(torch, trainer, ds)
        launches = counts()
        sync[wire] = {"digits": ("%.10f" % res["loss"], "%.10f" % auc),
                      "slab_sha256": slab_sha(trainer),
                      "launches": launches, "pass_s": secs,
                      "h2d_bytes": h2d.bytes}
        log("wires sparse_chunk_sync pass, %s wire: %s"
            % (wire, json.dumps(sync[wire])))
        trainer.close()
        del trainer, ds
    check(sync["full"]["digits"] == SYNC_DIGITS
          and all(sync["uid"][k] == sync["full"][k]
                  for k in ("digits", "slab_sha256", "launches")),
          "the uid wire's sparse_chunk_sync pass differs from the full "
          "wire's: %s" % json.dumps(sync))
    out["sync"] = sync

    out["gather_rebuild"] = rebuild_gather_phase(torch, cfg, files, feed,
                                                 dev)
    out["gather_rebuild"]["launches"] = (
        out["runs"]["full rebuild"]["launches"]["gather_rows"]
        - out["runs"]["full scatter"]["launches"]["gather_rows"])
    out["auto"] = auto_phase(torch, cfg, files, feed, dev)
    return out


# phase 19: the async run's second-pass AUC against the main path's
# (FLAGSHIP_DIGITS), stated in PERF.md before the first run on the card
ASYNC_AUC_BAND = 0.01
# the order of phase 19's cadence runs: every run of a mode follows each
# other mode once (the first run of each mode is the one held bit for bit)
TIER_ORDER = "cbaabc"
TIER_STATS = ("sparse_keys_spilled", "sparse_keys_faulted_in",
              "sparse_keys_prefetch_faulted")


def union_of(store):
    """(keys, rows) of a host store's resident and SSD-tier rows (the
    tier's at their effective values), sorted by key."""
    import numpy as np
    k, v = store.state_items()
    sk, sv = store.spilled_snapshot()
    k, v = np.concatenate([k, sk]), np.vstack([v, sv])
    order = np.argsort(k)
    return k[order], v[order]


def unions_equal(a, b):
    import numpy as np
    return (np.array_equal(a[0], b[0])
            and np.array_equal(a[1].view(np.uint32), b[1].view(np.uint32)))


class FaultInClock:
    """While entered, times every SSD-tier read that moves rows in
    (SpillTier.read with pop=True, on any thread: the pass table's
    store_lock serializes them): seconds and rows since the last
    ``take``."""

    def __init__(self):
        self.s, self.rows = 0.0, 0

    def __enter__(self):
        from paddlebox_tpu_torch.embedding.ssd_tier import SpillTier
        self._read = read = SpillTier.read
        clock = self

        def timed(tier, keys, pop):
            t0 = time.perf_counter()
            out = read(tier, keys, pop)
            if pop:
                clock.s += time.perf_counter() - t0
                clock.rows += int(len(keys))
            return out

        SpillTier.read = timed
        return self

    def __exit__(self, *exc):
        from paddlebox_tpu_torch.embedding.ssd_tier import SpillTier
        SpillTier.read = self._read

    def take(self):
        out = (self.s, self.rows)
        self.s, self.rows = 0.0, 0
        return out


def tier_run(torch, mode, windows, feed, cfg, keep, reset_counts, counts):
    """One cadence run of phase 19 in ``mode``: per pass its loss, AUC,
    wall (the phases' sum), spill and fault-in seconds and the tier's stat
    deltas; with ``keep`` the store after each pass. Returns (trainer,
    record with the run's launches)."""
    from paddlebox_tpu_torch import cadence_probe
    from paddlebox_tpu_torch.utils.stats import stat_get

    last = {n: stat_get(n) for n in TIER_STATS}

    def on_pass(trainer, rec):
        rec["stats"] = {n: stat_get(n) - last[n] for n in TIER_STATS}
        last.update({n: stat_get(n) for n in TIER_STATS})
        rec["fault_in_s"], rec["fault_in_rows"] = clock.take()
        rec["spill_s"] = rec["table_s"]["spill"]
        rec["wall_s"] = sum(rec["phase_s"].values())
        if keep:
            rec["store"] = union_of(trainer.table.store)
            # phase 25 holds the sharded SSD run to it
            rec["union_sha"] = sha_of(*rec["store"])

    reset_counts()
    with FaultInClock() as clock:
        trainer, run = cadence_probe.run_cadence(mode, windows, feed, cfg,
                                                 "cuda", on_pass=on_pass)
    run["launches"] = counts()
    return trainer, run


def tier_phase(torch, windows, feed, tmp, reset_counts, counts):
    """Phase 19, the SSD tier at full width (see the module docstring).
    Returns the runs' records, the launches by run and the seconds."""
    import numpy as np

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import CkptFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding import ckpt_store as cks
    from paddlebox_tpu_torch.embedding.pass_table import PassTable
    from paddlebox_tpu_torch.train import checkpoint as ckpt
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils.stats import stat_get

    untiered = flagship.FLAGSHIP
    budget = dataclasses.replace(flagship.FLAGSHIP_SSD, ssd_dir="x").table() \
        .ssd_max_resident_rows(untiered.layout().width)
    check(budget == 246723, "FLAGSHIP_SSD's budget is %r rows" % budget)
    runs, kept, trainers = [], {}, {}
    for i, mode in enumerate(TIER_ORDER):
        keep = mode not in kept
        cfg = (untiered if mode == "c" else dataclasses.replace(
            flagship.FLAGSHIP_SSD,
            ssd_dir=os.path.join(tmp, "ssd_%s_%d" % (mode, i))))
        trainer, run = tier_run(torch, mode, windows, feed, cfg, keep,
                                reset_counts, counts)
        run["tiered"] = mode != "c"
        runs.append(run)
        passes = run["passes"]
        steps = sum(p["batches"] for p in passes)
        writebacks = sum(int(p["counters"]["pass_rows_written_back"] > 0)
                         for p in passes)
        promotes = sum(int(p["counters"]["pass_rows_promote_hit"] > 0)
                       for p in passes)
        want = f32_launches(push_adagrad=steps,
                            gather_rows=steps + writebacks + promotes)
        check(run["launches"] == want, "tier run (%s) launches %s, expected "
              "%s" % (mode, run["launches"], want))
        if run["tiered"]:
            check(promotes == 0, "a tiered pass promoted resident rows "
                  "after a spill")
            for j, p in enumerate(passes):
                st = p["stats"]
                check(st["sparse_keys_spilled"] > 0
                      and (st["sparse_keys_faulted_in"] > 0) == (j > 0),
                      "tier run (%s) pass %d stats %s" % (mode, j, st))
            pre = sum(p["stats"]["sparse_keys_prefetch_faulted"]
                      for p in passes)
            check((pre > 0) == (mode == "a"), "tier run (%s) prefetched %d "
                  "rows from the tier" % (mode, pre))
            check(any(n.endswith(".part") for n in os.listdir(cfg.ssd_dir)),
                  "no block file in %s" % cfg.ssd_dir)
            check(len(trainer.table.store) <= budget, "the store holds %d "
                  "rows over its budget" % len(trainer.table.store))
        else:
            check(not any(v for p in passes for v in p["stats"].values()),
                  "the untiered run moved rows to a tier")
        for p in passes:
            log("tier run %d (%s) pass %d: loss %.10f auc %.10f wall_s %.4f "
                "spill_s %.4f fault_in_s %.4f fault_in_rows %d stats %s "
                "phase_s %s counters %s"
                % (i, mode, p["pass"], p["loss"], p["auc"], p["wall_s"],
                   p["spill_s"], p["fault_in_s"], p["fault_in_rows"],
                   json.dumps(p["stats"]), json.dumps(p["phase_s"]),
                   json.dumps(p["counters"])))
        log("tier run %d (%s): launches %s, wall %.4f s"
            % (i, mode, run["launches"], run["wall_s"]))
        if keep:
            kept[mode] = run
            trainers[mode] = trainer
        else:
            trainer.close()
        del trainer
    for mode in "ba":
        bit_equal = True
        for p, q in zip(kept[mode]["passes"], kept["c"]["passes"]):
            check(abs(p["loss"] - q["loss"]) <= 1e-6 * abs(q["loss"])
                  and abs(p["auc"] - q["auc"]) <= 1e-6,
                  "tier run (%s) pass %d loss %r auc %r, untiered %r %r"
                  % (mode, p["pass"], p["loss"], p["auc"], q["loss"],
                     q["auc"]))
            bit_equal &= p["loss"] == q["loss"] and p["auc"] == q["auc"]
            check(unions_equal(p["store"], q["store"]), "tier run (%s) "
                  "store after pass %d differs from the untiered run's"
                  % (mode, p["pass"]))
        log("tier (%s): the store after each of %d passes bit-identical to "
            "the untiered full rebuild's (%d keys after the last); losses "
            "and AUC bit-equal: %s" % (mode, len(kept[mode]["passes"]),
                                       kept["c"]["passes"][-1]["store"][0]
                                       .size, bit_equal))
    walls = {m: [[p["wall_s"] for p in r["passes"]] for r in runs
                 if r["mode"] == m] for m in "cba"}
    log("tier pass walls (order %s) %s; %s"
        % (TIER_ORDER, json.dumps(walls), card_line()))
    for r in runs:
        for p in r["passes"]:
            p.pop("store", None)

    # the test pass over the third window, on the tiered (b) and the
    # untiered trainer
    t_tier, t_full = trainers.pop("b"), trainers.pop("c")
    trainers.pop("a").close()
    preds = []
    for t in (t_tier, t_full):
        ds = BoxDataset(feed)
        ds.set_filelist(windows[2])
        ds.load_into_memory()
        reset_counts()
        preds.append(t.predict_batches(ds))
        c = counts()
        check(c == f32_launches(gather_rows=16), "tier test pass launches "
              "%s" % c)
    check(bits_equal(preds[0][0], preds[1][0])
          and np.array_equal(preds[0][1], preds[1][1]),
          "the tiered test pass's predictions differ from the untiered")
    spilled = t_tier.table.store.spilled_count()
    log("tier test pass: %d predictions bit-equal to the untiered "
        "trainer's, %d rows peeked from the tier" % (preds[0][0].size,
                                                     spilled))
    # the day tick, then LoadSSD2Mem
    t0 = time.perf_counter()
    for t in (t_tier, t_full):
        t.table.end_day(age=True)
    day_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = t_tier.table.load_ssd_to_mem()
    load_s = time.perf_counter() - t0
    check(loaded == spilled and t_tier.table.store.spilled_count() == 0,
          "load_ssd_to_mem moved %d of %d rows" % (loaded, spilled))
    (tk, tv), (fk, fv) = union_of(t_tier.table.store), union_of(
        t_full.table.store)
    pos = np.minimum(np.searchsorted(tk, fk), max(tk.size - 1, 0))
    check(tk.size >= fk.size and np.array_equal(tk[pos], fk)
          and bits_equal(tv[pos], fv), "after the day tick the tiered "
          "store differs on the untiered store's rows")
    extra = np.ones(tk.size, bool)
    extra[pos] = False
    table = untiered.table()
    score = untiered.layout().show_click_score(
        tv[extra, acc.SHOW], tv[extra, acc.CLICK], table.optimizer)
    check(bool((score < table.delete_threshold).all())
          and int(extra.sum()) <= spilled,
          "the tiered day kept %d rows the untiered one did not, not all "
          "below the delete threshold" % int(extra.sum()))
    log("tier day: end_day(age=True) %.4f s (both tables), "
        "load_ssd_to_mem %.4f s for %d rows; %d rows bit-equal to the "
        "untiered day's, %d more: tier rows the untiered shrink deleted by "
        "their score (the tier's sweep reads unseen days only)"
        % (day_s, load_s, loaded, fk.size, int(extra.sum())))
    t_full.close()
    del t_full

    # a journaled full save, two passes that spill, a touched save and its
    # load by journal replay
    cfg = CheckpointConfig(batch_model_dir=os.path.join(tmp, "tier_ck", "b"),
                           xbox_model_dir=os.path.join(tmp, "tier_ck", "x"),
                           async_save=False)
    cm = ckpt.CheckpointManager(cfg, t_tier.table, CkptFlags())
    t0 = time.perf_counter()
    cm.save_base(t_tier.params, t_tier.opt_state, "d0")
    full_s = time.perf_counter() - t0
    last = {n: stat_get(n) for n in TIER_STATS}
    for w in windows[:2]:
        ds = BoxDataset(feed)
        ds.set_filelist(w)
        t_tier.train_pass(ds)
    moved = {n: stat_get(n) - last[n] for n in TIER_STATS}
    check(moved["sparse_keys_spilled"] > 0
          and moved["sparse_keys_faulted_in"] > 0,
          "the journaled passes moved %s" % moved)
    live = union_of(t_tier.table.store)
    t0 = time.perf_counter()
    bdir, _ = cm.save_base(t_tier.params, t_tier.opt_state, "d1",
                           mode="touched")
    touched_s = time.perf_counter() - t0
    check(cks.read_manifest(os.path.join(bdir, ckpt.SPARSE_MANIFEST))
          .get("mode") == "journal", "the touched save fell back to full")
    t2 = PassTable(untiered.table(), device="cuda")
    t0 = time.perf_counter()
    ckpt.CheckpointManager(cfg, t2, CkptFlags(ckpt_journal=False)) \
        .load_base("d1")
    replay_s = time.perf_counter() - t0
    check(unions_equal(union_of(t2.store), live), "the journal replay's "
          "store differs from the live tiered store")
    log("tier journal: full save %.4f s, two passes moving %s, touched "
        "save %.4f s, load_base by replay %.4f s: %d rows bit-identical to "
        "the live store (resident and tier)"
        % (full_s, json.dumps(moved), touched_s, replay_s, live[0].size))
    t_tier.close()
    del t_tier, t2
    return {"runs": runs,
            "launches": {"%s_%d" % (r["mode"], i): r["launches"]
                         for i, r in enumerate(runs)},
            "seconds": {"day": day_s, "load_ssd_to_mem": load_s,
                        "full_save": full_s, "touched_save": touched_s,
                        "replay_load": replay_s}}


def async_runs(torch, files, feed, reset_counts, counts):
    """Phase 19, the async dense table at full width (see the module
    docstring): the free run, FLAGSHIP at scan_chunk=1, two drained runs.
    Returns the runs' records."""
    import hashlib

    from paddlebox_tpu_torch.convert import flatten_params
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    out = {}
    for name in ("async", "scan_chunk_1", "drained_0", "drained_1"):
        cfg = (flagship.FLAGSHIP if name == "scan_chunk_1"
               else flagship.FLAGSHIP_ASYNC)
        kw = {"scan_chunk": 1} if name == "scan_chunk_1" else {}
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda", **kw)
        table = trainer.async_table
        check((table is not None) == (name != "scan_chunk_1"),
              "%s: async table %r" % (name, table))
        if name.startswith("drained"):
            push = table.push

            def push_and_drain(g, push=push, table=table):
                push(g)
                table.wait_drained()

            table.push = push_and_drain
        reset_counts()
        passes, shas = [], []
        for p in range(2):
            res, auc, secs = run_pass(torch, trainer, ds)
            passes.append({"pass": p, "loss": res["loss"], "auc": auc,
                           "pass_s": secs,
                           "steps_s": trainer.pass_times["steps"],
                           "phase_s": trainer.pass_times})
            shas.append(slab_sha(trainer))
        c = counts()
        check(c == f32_launches(push_adagrad=32, gather_rows=35),
              "%s launches %s" % (name, c))
        rec = {"passes": passes, "launches": c, "slab_sha256": shas}
        if table is not None:
            applied = table.steps_applied
            check(8 <= applied <= 32, "%s: %d applies of 32 pushes"
                  % (name, applied))
            check(bits_equal(flatten_params(trainer.model), table.pull()),
                  "%s: the module differs from the table after the drain"
                  % name)
            rec["applies"] = applied
            rec["table_sha256"] = hashlib.sha256(
                table.pull().tobytes()).hexdigest()
        for p in passes:
            log("%s pass %d: loss %.10f auc %.10f pass_s %.4f steps_s %.4f "
                "phase_s %s" % (name, p["pass"], p["loss"], p["auc"],
                                p["pass_s"], p["steps_s"],
                                json.dumps(p["phase_s"])))
        log("%s: launches %s, applies %s" % (name, c, rec.get("applies")))
        trainer.close()
        del trainer, ds
        out[name] = rec
    a, b = out["drained_0"], out["drained_1"]
    check([p["loss"] for p in a["passes"]] == [p["loss"] for p in b["passes"]]
          and a["slab_sha256"] == b["slab_sha256"]
          and a["table_sha256"] == b["table_sha256"]
          and a["applies"] == b["applies"] == 32,
          "the drained async runs differ: %s / %s" % (
              [(p["loss"], p["auc"]) for p in a["passes"]],
              [(p["loss"], p["auc"]) for p in b["passes"]]))
    log("async drained runs: losses, AUC, slab sha256 and table bit-identical "
        "over two runs, 32 applies of one grad each")
    out["auc_vs_main"] = out["async"]["passes"][1]["auc"] - float(
        FLAGSHIP_DIGITS["auc"][1])
    check(abs(out["auc_vs_main"]) <= ASYNC_AUC_BAND,
          "async AUC %.10f, main path %s: outside the band %g"
          % (out["async"]["passes"][1]["auc"], FLAGSHIP_DIGITS["auc"][1],
             ASYNC_AUC_BAND))
    log("async: second-pass AUC %.10f, main path %s (difference %+.6f, band "
        "%g); steps seconds by pass, async %s, drained %s and %s, FLAGSHIP "
        "at scan_chunk=1 %s; %s"
        % (out["async"]["passes"][1]["auc"], FLAGSHIP_DIGITS["auc"][1],
           out["auc_vs_main"], ASYNC_AUC_BAND,
           [round(p["steps_s"], 4) for p in out["async"]["passes"]],
           [round(p["steps_s"], 4) for p in a["passes"]],
           [round(p["steps_s"], 4) for p in b["passes"]],
           [round(p["steps_s"], 4) for p in out["scan_chunk_1"]["passes"]],
           card_line()))
    return out


STREAM_WINDOW = 8192          # streaming_micro_pass_instances: 8 batches
STREAM_POISON_SLOT = 2        # the slot whose ids the poisoned window loses
STREAM_POISON_ID = 999999999  # the one id it carries there instead
STREAM_BASE_EVERY = 4         # micro-checkpoints at admitted 1 and 4
STREAM_WATCHDOG_S = 4.0       # the run's stall threshold
STREAM_STALL_S = 6.0          # the injected stall
# the watched directory in its order: two clean windows, the poisoned one,
# two clean windows (the names sort in this order, the mtimes too)
STREAM_NAMES = ("drop-0000.txt", "drop-0001.txt", "drop-0002.txt",
                "drop-0003.txt", "drop-0004-poison.txt", "drop-0005.txt",
                "drop-0006.txt", "drop-0007.txt", "drop-0008.txt")
# the micro-checkpoints' days: the first admitted window and the fourth
STREAM_DAYS = ("stream-000000", "stream-000004")
# /metrics series the scrape during the run carries
STREAM_SERIES = ("pbtpu_streaming_micro_passes",
                 "pbtpu_streaming_ingest_lag_secs",
                 "pbtpu_streaming_publish_lag_secs",
                 "pbtpu_streaming_window_instances",
                 "pbtpu_streaming_admission_score",
                 "pbtpu_device_transfer_bytes_h2d",
                 "pbtpu_device_transfer_bytes_d2h",
                 "pbtpu_device_live_bytes_slab",
                 'pbtpu_device_h2d_bytes_bucket{le="+Inf"}')


def poison_line(line, feed, slot):
    """``line`` with every id of used sparse slot ``slot`` replaced by
    STREAM_POISON_ID (the slot's cardinality collapses to one)."""
    tok = line.split()
    pos = used = 0
    for s in feed.slots:
        n = int(tok[pos])
        if s.type == "uint64" and s.is_used:
            if used == slot:
                tok[pos + 1:pos + 1 + n] = [str(STREAM_POISON_ID)] * n
            used += 1
        pos += 1 + n
    return " ".join(tok)


def write_stream(files, feed, watch):
    """The watched directory: the 8 ``files`` by write-temp-then-rename
    and the poisoned window (the first two files' lines, slot
    STREAM_POISON_SLOT's ids replaced) between the fourth and the fifth,
    their mtimes a millisecond apart in STREAM_NAMES' order, the last one
    now (the drop lands at once)."""
    import shutil
    os.makedirs(watch)
    srcs = list(files[:4]) + [None] + list(files[4:8])
    t0 = time.time() - 1e-3 * len(STREAM_NAMES)
    for i, (name, src) in enumerate(zip(STREAM_NAMES, srcs)):
        dst = os.path.join(watch, name)
        if src is None:
            with open(dst + ".tmp", "w") as fh:
                for f in files[:2]:
                    for line in open(f):
                        fh.write(poison_line(line, feed, STREAM_POISON_SLOT)
                                 + "\n")
        else:
            shutil.copy(src, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        os.utime(dst, (t0 + 1e-3 * i, t0 + 1e-3 * i))


def store_sha(table):
    import hashlib
    k, v = sorted_store(table)
    return hashlib.sha256(k.tobytes() + v.tobytes()).hexdigest()


def slab_sha_or_none(table):
    import hashlib
    slab = table.resident_slab
    return (None if slab is None
            else hashlib.sha256(slab.cpu().numpy().tobytes()).hexdigest())


def stream_cm(trainer, root):
    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    return CheckpointManager(CheckpointConfig(
        batch_model_dir=os.path.join(root, "batch"),
        xbox_model_dir=os.path.join(root, "xbox"), async_save=False),
        trainer.table)


def stream_run(torch, cfg, feed, watch, root, flags, device, on_built=None,
               spy=None):
    """One StreamingRunner over ``watch`` (its ledger and micro-checkpoints
    under ``root``), its trainer built from ``cfg`` with push_write 'auto'
    and ObsFlags ``flags``; ``on_built(trainer)`` runs before the run. Each
    boundary records the store's and the slab's sha256 before the
    boundary's save, then calls ``spy(window, trainer)``; each admitted
    pass records its loss, AUC, counters, phases, the H2D bytes
    count_h2d_bytes tallied and the transfer ledger's staging bytes.
    Returns (trainer, cm, the run's result, boundaries, passes)."""
    from paddlebox_tpu_torch.config.flags import StreamFlags
    from paddlebox_tpu_torch.data.streaming import StreamingDataset
    from paddlebox_tpu_torch.obs import device as device_obs
    from paddlebox_tpu_torch.profile_pass import count_h2d_bytes
    from paddlebox_tpu_torch.train import StreamingRunner, flagship

    trainer, _ = flagship.build_trainer([], feed, cfg, "auto", device,
                                        obs_flags=flags)
    check(device != "cuda" or trainer.push_write == "scatter",
          "push_write 'auto' resolved to %r on the card" % trainer.push_write)
    cm = stream_cm(trainer, root)
    sf = StreamFlags(streaming_poll_secs=0.02)
    stream = StreamingDataset(feed, watch, ledger_dir=root,
                              micro_pass_instances=STREAM_WINDOW, flags=sf)
    runner = StreamingRunner(trainer, stream, cm=cm,
                             base_every=STREAM_BASE_EVERY, flags=sf)
    bounds, passes = [], []
    inner_pass, inner_boundary = trainer.train_pass, runner._boundary

    def train_pass(ds, preloaded=False):
        before = dict(trainer.table.counters)
        staged0 = device_obs.transfer_kinds()["h2d"].get("staging", 0)
        t0 = time.perf_counter()
        with count_h2d_bytes(trainer) as counted:
            res = inner_pass(ds, preloaded=preloaded)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        passes.append({
            "loss": res["loss"],
            "auc": trainer.metrics.get_metric_msg("auc")["auc"],
            "batches": res["batches"], "pass_s": secs,
            "counters": counter_delta(before, trainer.table),
            "phase_s": trainer.pass_times,
            "h2d_counted": sum(counted.bytes.values()),
            "h2d_ledger_staging": device_obs.transfer_kinds()["h2d"].get(
                "staging", 0) - staged0})
        return res

    def boundary(win, admitted):
        bounds.append({"window": win.index, "admitted": admitted,
                       "store": store_sha(trainer.table),
                       "slab": slab_sha_or_none(trainer.table)})
        inner_boundary(win, admitted)
        if spy is not None:
            spy(win.index, trainer)

    trainer.train_pass, runner._boundary = train_pass, boundary
    if on_built is not None:
        on_built(trainer)
    res = runner.run(idle_timeout=0.5)
    del trainer.train_pass
    return trainer, cm, res, bounds, passes


def stream_sequential(torch, cfg, feed, files, root, device):
    """The stream's four clean windows through PassPreloader and
    train_pass(preloaded=True) one at a time, with the stream's
    micro-checkpoints (save_base(mode='auto') after the first and the
    fourth pass, in a directory of their own). Returns (trainer, passes)."""
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.preload import PassPreloader

    trainer, _ = flagship.build_trainer([], feed, cfg, "auto", device)
    cm = stream_cm(trainer, root)
    pre = PassPreloader(trainer.table)
    passes = []
    for i in range(4):
        ds = BoxDataset(feed)
        ds.set_filelist(files[2 * i:2 * i + 2])
        pre.preload(ds)
        pre.wait(ds)
        res = trainer.train_pass(ds, preloaded=True)
        passes.append({"loss": res["loss"],
                       "auc": trainer.metrics.get_metric_msg("auc")["auc"],
                       "store": store_sha(trainer.table),
                       "slab": slab_sha_or_none(trainer.table)})
        if i + 1 in (1, STREAM_BASE_EVERY):
            cm.save_base(trainer.params, trainer.opt_state,
                         day="seq-%d" % i, mode="auto")
        ds.release_memory()
    return trainer, passes


def stream_phase(torch, files, feed, tmp, reset_counts, counts, cfg=None,
                 device="cuda", stall_s=STREAM_STALL_S,
                 watchdog_s=STREAM_WATCHDOG_S):
    """Phase 20, the streaming runner and the single-process obs tiers at
    full width (see the module docstring). Returns its record."""
    import urllib.request

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import CkptFlags, ObsFlags
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding.pass_table import PassTable
    from paddlebox_tpu_torch.obs import device as device_obs
    from paddlebox_tpu_torch.obs import exporter, flight, watchdog
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train import journal as jr
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.utils import journal_format as jf
    from paddlebox_tpu_torch.utils import stats

    cfg = cfg or flagship.FLAGSHIP
    root = os.path.join(tmp, "stream")
    watch = os.path.join(root, "watch")
    write_stream(files, feed, watch)
    width = cfg.layout().device_width
    steps = 4 * STREAM_WINDOW // cfg.batch

    # A: every plane on (the device plane, the watermark, a flight
    # recorder, the watchdog, and an exporter on an ephemeral port, bound
    # to the run's reporter and scraped after the second boundary)
    on = ObsFlags(obs_flight_dir=os.path.join(root, "flight"),
                  obs_watchdog_secs=watchdog_s)
    scraped = {}

    def serve(trainer):
        exporter.set_active(exporter.ObsExporter(0).bind(trainer.reporter))

    def scrape(window, trainer):
        if window == 1:
            url = "http://127.0.0.1:%d/metrics" % exporter.active().port
            with urllib.request.urlopen(url, timeout=10) as r:
                scraped["ctype"] = r.headers.get("Content-Type")
                scraped["text"] = r.read().decode()
            # the HBM ledger while the slab is resident (no save here)
            scraped["ledger"] = device_obs.sample_ledger()

    stats.stat_reset()
    device_obs.monitor().reset()
    reset_counts()
    ta, cm_a, run_a, bounds_a, passes_a = stream_run(
        torch, cfg, feed, watch, os.path.join(root, "a"), on, device,
        on_built=serve, spy=scrape)
    launches = counts()
    watchdog.beat("stream_checks")
    dog = watchdog.active()
    check(dog is not None and dog.fires == 0,
          "the watchdog fired %s times in the run"
          % (dog.fires if dog else None))
    publish_lag = stats.gauge_get("streaming_publish_lag_secs")
    # the sequence: admitted, admitted, refused, admitted, admitted
    seq = [(p["window"], p["admitted"], p["instances"])
           for p in run_a["passes"]]
    check(seq == [(0, True, STREAM_WINDOW), (1, True, STREAM_WINDOW),
                  (2, False, STREAM_WINDOW), (3, True, STREAM_WINDOW),
                  (4, True, STREAM_WINDOW)],
          "stream windows %s" % seq)
    scores = [p["drift_score"] for p in run_a["passes"]]
    check(scores[2] >= 0.8 and max(scores[:2] + scores[3:]) < 0.8,
          "admission scores %s" % scores)
    check(stats.stat_get("streaming_windows_refused") == 1
          and stats.stat_get("streaming_micro_passes") == 5,
          "streaming stats %s" % {k: stats.stat_get(k) for k in (
              "streaming_windows_refused", "streaming_micro_passes")})
    # the refused window changed nothing: its boundary sees the store and
    # the slab of the boundary before it (no save between them)
    check(bounds_a[2]["store"] == bounds_a[1]["store"]
          and bounds_a[2]["slab"] == bounds_a[1]["slab"] is not None,
          "the refused window changed the store or the slab")
    # launches: one push a step; a pull a step, a write-back a pass and a
    # promote where a row stayed resident (the micro-checkpoint after the
    # first pass drops the residency)
    extra = sum(gather_launches_of(p["counters"]) for p in passes_a)
    check(launches == f32_launches(push_adagrad=steps,
                                   gather_rows=steps + extra)
          and extra == 6,
          "stream launches %s, %d promotes and write-backs" % (launches,
                                                               extra))
    # the transfer ledger: each pass's staging bytes are count_h2d_bytes'
    for i, p in enumerate(passes_a):
        check(p["h2d_ledger_staging"] == p["h2d_counted"] > 0,
              "pass %d: ledger staging %d B, count_h2d_bytes %d B"
              % (i, p["h2d_ledger_staging"], p["h2d_counted"]))
    kinds = device_obs.transfer_kinds()
    check(stats.stat_get("device_transfer_bytes_h2d")
          == sum(kinds["h2d"].values())
          and stats.stat_get("device_transfer_bytes_d2h")
          == sum(kinds["d2h"].values()),
          "transfer counters and sites disagree: %s" % kinds)
    ledger = scraped["ledger"]
    slab_bytes = cfg.capacity * width * 4
    check(ledger["owners"]["slab"] == slab_bytes,
          "the slab owner reads %d B, expected %d" % (
              ledger["owners"]["slab"], slab_bytes))
    snap = device_obs.snapshot()
    check(snap["recompiles"] == 0 and snap["donation_miss"] == 0
          and snap["entries"]["scan_steps"]["donation"]["checks"] == 4
          and snap["entries"]["scan_steps"]["signatures"] == 1,
          "device plane %s" % json.dumps(snap["entries"]))
    # the scrape during the run
    check(scraped.get("ctype") == exporter.PROM_CONTENT_TYPE
          and all(("\n" + s) in scraped["text"] for s in STREAM_SERIES),
          "/metrics during the run lacks %s" % [
              s for s in STREAM_SERIES
              if ("\n" + s) not in scraped.get("text", "")])
    # the injected stall: the watchdog fires once, naming the beat, and
    # seals the flight recorder with its dump
    watchdog.beat("stream_stall_probe")
    time.sleep(stall_s)
    check(dog.fires == 1, "the watchdog fired %d times on one stall"
          % dog.fires)
    sealed = json.load(open(os.path.join(root, "flight", "SEALED_r0.json")))
    check(sealed["reason"] == "watchdog_stall:stream_stall_probe"
          and sealed["device"]["type"] == "device_plane",
          "flight seal %s" % sealed["reason"])
    watchdog.set_active(None).stop()
    flight.set_active(None).close()
    exporter.close_active()
    # the last micro-checkpoint's segments are the windows published since
    # the first: a watermark each, the newest born_max the last window's
    # newest file's mtime
    day_dir = os.path.join(root, "a", "batch", STREAM_DAYS[1])
    marks = [jf.unpack_watermark(pl)
             for f in sorted(os.listdir(day_dir)) if f.endswith(".jrnl")
             for k, pl in jf.iter_segment(os.path.join(day_dir, f))
             if k == jf.KIND_WATERMARK]
    newest = os.path.getmtime(os.path.join(watch, STREAM_NAMES[-1]))
    check(len(marks) == 3 and marks[-1][1] == newest,
          "watermarks %s, newest file %r" % (marks, newest))
    # the published journal replays to the live store
    t0 = time.perf_counter()
    table = PassTable(cfg.table(), device=device)
    CheckpointManager(CheckpointConfig(
        batch_model_dir=os.path.join(root, "a", "batch"),
        xbox_model_dir=os.path.join(root, "a", "xbox"), async_save=False),
        table, CkptFlags(ckpt_journal=False)).load_base(STREAM_DAYS[1])
    for param in (1, 3):
        jr.apply_stat_after_save(table.store, table.config, param)
    replay_s = time.perf_counter() - t0
    check(store_sha(table) == store_sha(ta.table),
          "the replayed journal differs from the live store")
    man = json.load(open(os.path.join(day_dir, "sparse.xman")))
    check(man["mode"] == "journal", "the last micro-checkpoint is %s"
          % man["mode"])
    check(sorted(d for d in os.listdir(os.path.join(root, "a", "batch"))
                 if d.startswith("stream-")) == list(STREAM_DAYS),
          "micro-checkpoints %s" % os.listdir(os.path.join(root, "a",
                                                           "batch")))
    store_a = store_sha(ta.table)
    ta.close()
    del ta, table

    # B: the same four windows one train_pass(preloaded=True) at a time
    tb, passes_b = stream_sequential(torch, cfg, feed, [
        os.path.join(watch, n) for n in STREAM_NAMES
        if "poison" not in n], os.path.join(root, "b"), device)
    store_b = store_sha(tb.table)
    tb.close()
    del tb
    got = [(p["loss"], p["auc"]) for p in passes_a]
    check(got == [(p["loss"], p["auc"]) for p in passes_b]
          and [b["store"] for b in bounds_a if b["admitted"]]
          == [p["store"] for p in passes_b]
          and [b["slab"] for b in bounds_a if b["admitted"]]
          == [p["slab"] for p in passes_b] and store_a == store_b,
          "the stream differs from the sequential passes: %s / %s"
          % (got, [(p["loss"], p["auc"]) for p in passes_b]))

    # C: every plane off
    reset_counts()
    tc, _, run_c, bounds_c, passes_c = stream_run(
        torch, cfg, feed, watch, os.path.join(root, "c"), ObsFlags.off(),
        device)
    check(counts() == launches, "planes-off launches %s" % counts())
    check([(p["loss"], p["auc"]) for p in passes_c] == got
          and [(b["store"], b["slab"]) for b in bounds_c]
          == [(b["store"], b["slab"]) for b in bounds_a]
          and store_sha(tc.table) == store_a,
          "planes on and off differ")
    check(all(p["h2d_ledger_staging"] == 0 for p in passes_c),
          "the transfer ledger counted with the planes off")
    tc.close()
    del tc
    device_obs.configure(ObsFlags())

    def walls(passes):
        return [round(p["pass_s"], 4) for p in passes]

    rec = {"sequence": seq, "drift_scores": scores,
           "publish_lag_s": publish_lag,
           "passes": [{k: p[k] for k in ("loss", "auc", "batches",
                                         "pass_s", "h2d_counted")}
                      for p in passes_a],
           "launches": launches, "ledger": ledger, "replay_s": replay_s,
           # phase 26 holds the stream over the sharded trainer to these
           "bounds": [{k: b[k] for k in ("window", "admitted", "store",
                                         "slab")} for b in bounds_a],
           "transfers": kinds, "run_on": {k: v for k, v in run_a.items()
                                          if k != "passes"},
           "run_off": {k: v for k, v in run_c.items() if k != "passes"},
           "ingest_wait_s": [p["ingest_wait_secs"]
                             for p in run_a["passes"]],
           "train_s_on": [p.get("train_secs") for p in run_a["passes"]],
           "train_s_off": [p.get("train_secs") for p in run_c["passes"]]}
    for i, p in enumerate(passes_a):
        log("stream pass %d: loss %.10f auc %.10f pass_s %.4f phase_s %s "
            "h2d staging %d B (count_h2d_bytes %d B) counters %s"
            % (i, p["loss"], p["auc"], p["pass_s"], json.dumps(p["phase_s"]),
               p["h2d_ledger_staging"], p["h2d_counted"],
               json.dumps(p["counters"])))
    log("stream windows %s, drift scores %s; launches %s; examples/s on %.1f "
        "off %.1f; ingest_wait_secs %s; max ingest wait on %.4f off %.4f"
        % (seq, scores, launches, run_a["examples_per_sec"],
           run_c["examples_per_sec"],
           [round(x, 4) for x in rec["ingest_wait_s"]],
           run_a["max_ingest_wait_secs"], run_c["max_ingest_wait_secs"]))
    train_on = [x for x in rec["train_s_on"] if x]
    train_off = [x for x in rec["train_s_off"] if x]
    rec["train_examples_per_s"] = {
        "on": 4 * STREAM_WINDOW / sum(train_on),
        "off": 4 * STREAM_WINDOW / sum(train_off)}
    log("stream planes on vs off: pass walls %s / %s, train_secs %s / %s "
        "(examples/s over them %.1f / %.1f), run walls %.4f / %.4f s; the "
        "stream = the sequential passes and the planes-off run bit for bit "
        "(losses, AUC, stores, slabs)"
        % (walls(passes_a), walls(passes_c),
           [round(x, 4) for x in train_on], [round(x, 4) for x in train_off],
           rec["train_examples_per_s"]["on"],
           rec["train_examples_per_s"]["off"], run_a["wall_secs"],
           run_c["wall_secs"]))
    log("stream obs: transfers %s; ledger owners %s (slab %d B), total %d "
        "B, peak %s B; publish lag %.4f s; %d watermarks; journal replay of "
        "%s %.3f s = the live store; /metrics scraped on port 0 during the "
        "run (%d B); watchdog fired once on a %.1f s stall; %s"
        % (json.dumps(kinds), json.dumps(ledger["owners"]),
           ledger["owners"]["slab"], ledger["total_bytes"],
           ledger.get("peak_bytes"), publish_lag, len(marks),
           STREAM_DAYS[1], replay_s, len(scraped["text"]), stall_s,
           card_line()))
    return rec


# phase 21: the single-process host modules at full width
LOCK_RUNS = ("on", "off", "off", "on")
AUC_RUNNER_SLOTS = (0, 1, 2, 3)
SPILL_SHARD_BYTES = 8 << 20   # the archive spill's rotation in phase 21
PUSH_CHECK_SEED = 2021        # the standalone push's creation seed


def flagship_pass0(tag, rec):
    """Check a fresh FLAGSHIP trainer's first pass against FLAGSHIP_DIGITS'
    first pass."""
    got = ("%.10f" % rec["loss"], "%.10f" % rec["auc"])
    want = (FLAGSHIP_DIGITS["loss"][0], FLAGSHIP_DIGITS["auc"][0])
    check(got == want, "%s digits %s, expected %s" % (tag, got, want))


def slice21_pass(torch, trainer, ds, tag, reset_counts, counts,
                 profiled=False):
    """One pass (train_pass, or train_pass_profiled) of a fresh trainer:
    its record (loss, AUC, wall, slab sha256, launches), held to
    FLAGSHIP_DIGITS' first pass, with the push once a step and
    gather_rows once a step and once at the write-back."""
    reset_counts()
    t0 = time.perf_counter()
    res = (trainer.train_pass_profiled(ds) if profiled
           else trainer.train_pass(ds))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    rec = {"loss": res["loss"],
           "auc": trainer.metrics.get_metric_msg("auc")["auc"],
           "batches": res["batches"], "instances": res["instances"],
           "pass_s": secs, "slab_sha256": slab_sha(trainer),
           "launches": {k: v for k, v in c.items() if v}}
    flagship_pass0(tag, rec)
    steps = res["batches"]
    check(c["push_adagrad"] == steps and c["gather_rows"] == steps + 1,
          "%s launches %s over %d steps" % (tag, rec["launches"], steps))
    log("slice21 %s: %s" % (tag, json.dumps(rec)))
    return rec


def same_pass(tag, rec, ref):
    check(rec["loss"] == ref["loss"] and rec["auc"] == ref["auc"]
          and rec["slab_sha256"] == ref["slab_sha256"],
          "%s differs from the text pass: %s vs %s" % (tag, rec, ref))


def env_blocked_check(torch, cfg, feed, files, reset_counts, counts):
    """PBTPU_PUSH_WRITE=blocked set while PushFlags is made reaches the
    trainer (restored after): one pass over files[0], a blocked_write a
    step, rows bit-equal to a scatter pass's."""
    import numpy as np

    from paddlebox_tpu_torch.config.flags import PushFlags
    from paddlebox_tpu_torch.train import flagship

    old = os.environ.get("PBTPU_PUSH_WRITE")
    os.environ["PBTPU_PUSH_WRITE"] = "blocked"
    try:
        flags = PushFlags()
    finally:
        if old is None:
            del os.environ["PBTPU_PUSH_WRITE"]
        else:
            os.environ["PBTPU_PUSH_WRITE"] = old
    check(flags.push_write == "blocked" and PushFlags().push_write == (
        old or "auto"), "PBTPU_PUSH_WRITE did not reach PushFlags")
    rows = {}
    for mode in ("env", "scatter"):
        t, d = flagship.build_trainer(
            files[:1], feed, cfg, "scatter", "cuda",
            push_flags=flags if mode == "env" else None)
        check(t.push_write == ("blocked" if mode == "env" else "scatter"),
              "trainer write %r" % t.push_write)
        reset_counts()
        res, auc, _ = run_pass(torch, t, d)
        c = counts()
        if mode == "env":
            check(c["blocked_write"] == res["batches"]
                  and c["push_adagrad"] == res["batches"],
                  "env-set blocked pass launches %s over %d steps"
                  % (c, res["batches"]))
            launches = {k: v for k, v in c.items() if v}
        rows[mode] = t.table.store.lookup(t.table.pass_keys)
        t.close()
        del t, d
    check(np.array_equal(rows["env"].view(np.uint32),
                         rows["scatter"].view(np.uint32)),
          "the env-set blocked pass's rows differ from scatter's")
    log("slice21 env PBTPU_PUSH_WRITE=blocked -> trainer write 'blocked': "
        "launches %s over %d steps, %d rows bit-equal to scatter"
        % (launches, res["batches"], rows["env"].shape[0]))
    return launches


def table_pull_push_check(torch, trainer, ds, reset_counts, counts):
    """PassTable.pull and push at the flagship batch inside a pass of
    ``trainer``'s table (its second), each held bit-equal to its plain
    version on the same device inputs; each launches its kernel once."""
    from paddlebox_tpu_torch.embedding.optimizers import device_push_maps
    from paddlebox_tpu_torch.embedding.push_kernels import \
        push_adagrad_fused_plain
    from paddlebox_tpu_torch.ops.row_kernels import gather_rows_plain
    from paddlebox_tpu_torch.ops.sparse import pull_view_from_rows

    tab = trainer.table
    tab.begin_feed_pass()
    tab.add_keys(ds.all_keys())
    tab.end_feed_pass()
    tab.begin_pass()
    b = ds.split_batches(1)[0][0]
    ids = torch.from_numpy(tab.lookup_ids(b.keys, b.valid)).to(tab.device)
    K, D = ids.shape[0], tab.layout.embedx_dim
    slab = tab.slab
    reset_counts()
    view = tab.pull(ids)
    c_pull = counts()
    plain = pull_view_from_rows(gather_rows_plain(slab, ids), tab.layout)
    check(c_pull["gather_rows"] == 1 and torch.equal(view, plain),
          "PassTable.pull differs from its plain version (launches %s)"
          % c_pull)
    gen = torch.Generator(device=tab.device).manual_seed(PUSH_CHECK_SEED)
    valid = (ids != tab.padding_id).to(torch.float32)[:, None]
    g = torch.cat([torch.randint(0, 32, (K, 1), generator=gen,
                                 device=tab.device).float(),
                   torch.ones(K, 1, device=tab.device),
                   torch.randint(0, 2, (K, 1), generator=gen,
                                 device=tab.device).float(),
                   0.1 * torch.randn(K, 1 + D, generator=gen,
                                     device=tab.device)], 1) * valid
    want = slab.clone()
    tab.seed_fn = lambda: PUSH_CHECK_SEED
    reset_counts()
    tab.push(ids, g)
    torch.cuda.synchronize()
    c_push = counts()
    n_valid = int(valid.sum())
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    n_uniq = int(uniq.shape[0])
    uids = torch.cat([uniq.to(torch.int32),
                      want.shape[0] + torch.arange(K - n_uniq,
                                                   dtype=torch.int32,
                                                   device=tab.device)])
    perm, offsets = device_push_maps(inv.to(torch.int32), n_valid)
    push_adagrad_fused_plain(want, g, perm, offsets, uids, n_uniq,
                             PUSH_CHECK_SEED, tab.layout,
                             tab.config.optimizer)
    check(c_push["push_adagrad"] == 1 and c_push["gather_rows"] == 0
          and torch.equal(slab.view(torch.int32), want.view(torch.int32)),
          "PassTable.push differs from its plain version (launches %s)"
          % c_push)
    tab.end_pass()
    rec = {"ids": K, "uniques": n_uniq, "pull_launches": c_pull,
           "push_launches": {k: v for k, v in c_push.items() if v}}
    log("slice21 PassTable.pull and push at the flagship batch (%d ids, %d "
        "uniques): bit-equal to their plain versions, one gather_rows and "
        "one push_adagrad" % (K, n_uniq))
    return rec


def lockwatch_runs(torch, cfg, feed, files, reset_counts, counts):
    """Fresh FLAGSHIP passes with lockwatch's switch on and off in the
    order LOCK_RUNS, each held to FLAGSHIP_DIGITS' first pass; the on runs
    record no inversion and no cycle. Walls a run and the means."""
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils import lockwatch

    runs = []
    for mode in LOCK_RUNS:
        prev = lockwatch.set_enabled(mode == "on")
        lockwatch.reset()
        try:
            t, d = flagship.build_trainer(files, feed, cfg, "scatter",
                                          "cuda")
        finally:
            lockwatch.set_enabled(prev)
        watched = type(t.table.store_lock).__name__ == "_WatchedLock"
        check(watched == (mode == "on"), "lockwatch %s: store_lock %r"
              % (mode, t.table.store_lock))
        rec = slice21_pass(torch, t, d, "lockwatch %s pass" % mode,
                           reset_counts, counts)
        t.close()
        del t, d
        rec["mode"] = mode
        if mode == "on":
            check(lockwatch.inversions() == [],
                  "lockwatch recorded inversions %s" % lockwatch.inversions())
            lockwatch.assert_consistent()
            rec["edges"] = len(lockwatch.edges())
        runs.append(rec)
    lockwatch.reset()
    walls = {m: [r["pass_s"] for r in runs if r["mode"] == m]
             for m in ("on", "off")}
    means = {m: sum(w) / len(w) for m, w in walls.items()}
    log("slice21 lockwatch on vs off (order %s): pass walls %s, means on "
        "%.4f off %.4f s; no inversion, %s nesting edges"
        % (", ".join(LOCK_RUNS), json.dumps(walls), means["on"],
           means["off"], [r.get("edges") for r in runs]))
    return {"runs": runs, "means": means}


def slice21_phase(torch, cfg, feed, files, tmp, reset_counts, counts):
    """Phase 21 at FLAGSHIP's full width: the environment's push write
    reaching the trainer; a record-path pass over the text files, the same
    pass fed from load_into_disk's archive shards and through
    pipe_command='cat' (equal losses, AUC, slab sha256); a dumped pass
    against an undumped one; train_pass_profiled against train_pass at
    scan_chunk=1; PassTable.pull and push against their plain versions;
    the AUC runner on AUC_RUNNER_SLOTS; lockwatch on and off; then one pass
    inside utils/profiler.trace in a child process of its own (its first
    torch.profiler session)."""
    import glob

    from paddlebox_tpu_torch import profile_pass
    from paddlebox_tpu_torch.data.archive import is_archive
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.auc_runner import AucRunner

    out = {"env_blocked": env_blocked_check(torch, cfg, feed, files,
                                            reset_counts, counts)}

    def fresh(feed_=feed, **fields):
        return flagship.build_trainer(files, feed_, cfg, "scatter", "cuda",
                                      **fields)

    # the text files on the record path: what the archive and pipe
    # passes equal; its trainer and records then feed the AUC runner
    text_t, _ = fresh()
    text_ds = BoxDataset(feed, columnar=False)
    text_ds.set_filelist(files)
    text = out["text"] = slice21_pass(torch, text_t, text_ds,
                                      "text record-path pass", reset_counts,
                                      counts)
    spill = BoxDataset(feed)
    spill.set_filelist(files)
    t0 = time.perf_counter()
    spill.load_into_disk(os.path.join(tmp, "slice21_spill", "pass0"),
                         SPILL_SHARD_BYTES)
    spill_s = time.perf_counter() - t0
    shards = spill.disk_files
    check(len(shards) > 1 and all(is_archive(f) for f in shards),
          "load_into_disk wrote %s" % shards)
    t, _ = fresh()
    ads = BoxDataset(feed)
    ads.set_filelist(shards)
    out["archive"] = slice21_pass(torch, t, ads, "archive pass",
                                  reset_counts, counts)
    check(not ads._load_columnar, "the archive load ran columnar")
    same_pass("archive pass", out["archive"], text)
    t.close()
    t, pds = fresh(dataclasses.replace(feed, pipe_command="cat"))
    out["pipe"] = slice21_pass(torch, t, pds, "pipe_command=cat pass",
                               reset_counts, counts)
    check(pds.columnar and not pds._load_columnar,
          "the piped load did not take the record path")
    same_pass("pipe pass", out["pipe"], text)
    t.close()
    log("slice21 archive spill: %d shards, %d bytes, load_into_disk %.4f s;"
        " archive and pipe passes = the text record-path pass (loss, AUC, "
        "slab sha256)" % (len(shards), sum(os.path.getsize(f)
                                           for f in shards), spill_s))

    # the dump: the undumped (columnar) pass, then a dumped one
    t, d = fresh()
    undumped = out["undumped"] = slice21_pass(torch, t, d, "undumped pass",
                                              reset_counts, counts)
    same_pass("undumped columnar pass", undumped, text)
    t.close()
    dump_dir = os.path.join(tmp, "slice21_dump")
    t, d = fresh(dump_fields=("label", "pred"), dump_fields_path=dump_dir,
                 dump_thread_num=2)
    dumped = out["dumped"] = slice21_pass(torch, t, d, "dumped pass",
                                          reset_counts, counts)
    same_pass("dumped pass", dumped, undumped)
    t.close()
    lines = 0
    for path in glob.glob(os.path.join(dump_dir, "dump-*.txt")):
        with open(path) as fh:
            lines += sum(1 for _ in fh)
    check(lines == dumped["instances"], "the dump holds %d lines for %d "
          "instances" % (lines, dumped["instances"]))
    out["dump"] = {"lines": lines,
                   "extra_s": dumped["pass_s"] - undumped["pass_s"]}
    log("slice21 dump: %d lines for %d instances, pass %.4f s against %.4f "
        "s undumped (%+.4f s)" % (lines, dumped["instances"],
                                  dumped["pass_s"], undumped["pass_s"],
                                  out["dump"]["extra_s"]))

    # the profiled pass against train_pass at scan_chunk=1
    t1, d1 = fresh(scan_chunk=1)
    per_step = out["scan_chunk_1"] = slice21_pass(
        torch, t1, d1, "scan_chunk=1 pass", reset_counts, counts)
    tp, dp = fresh(scan_chunk=1)
    prof = out["profiled"] = slice21_pass(torch, tp, dp, "profiled pass",
                                          reset_counts, counts,
                                          profiled=True)
    same_pass("profiled pass", prof, per_step)
    prof["stage_ms"] = {k: v.elapsed_ms() for k, v in tp.stage_timers.items()}
    check(all(v.count == prof["batches"] for v in tp.stage_timers.values()),
          "profiled stage timers %s" % tp.stage_timers)
    tp.close()
    log("slice21 profiled pass = train_pass at scan_chunk=1 bit for bit; "
        "stage ms %s over %d steps (pass %.4f s, scan_chunk=1 %.4f s); "
        "launches %s; %s"
        % (json.dumps(prof["stage_ms"]), prof["batches"], prof["pass_s"],
           per_step["pass_s"], prof["launches"], card_line()))

    # the standalone table surface, in a second pass of t1's table
    out["table"] = table_pull_push_check(torch, t1, d1, reset_counts,
                                         counts)
    t1.close()

    # the AUC runner over the text pass's records
    reset_counts()
    t0 = time.perf_counter()
    auc = AucRunner(text_t, seed=0).run(text_ds, slots=AUC_RUNNER_SLOTS)
    auc_s = time.perf_counter() - t0
    c = counts()
    check(0.0 < auc["base_auc"] <= 1.0
          and all(abs(v) < 1.0 for v in auc.values())
          and c["push_adagrad"] == 0
          and c["gather_rows"] >= (len(AUC_RUNNER_SLOTS) + 1)
          * text["batches"],
          "AUC runner %s launches %s" % (auc, c))
    out["auc_runner"] = dict(auc, secs=auc_s,
                             launches={k: v for k, v in c.items() if v})
    log("slice21 AUC runner on slots %s: %s in %.4f s, launches %s"
        % (list(AUC_RUNNER_SLOTS), json.dumps(auc), auc_s,
           out["auc_runner"]["launches"]))
    text_t.close()
    del text_t, text_ds

    out["lockwatch"] = lockwatch_runs(torch, cfg, feed, files, reset_counts,
                                      counts)

    # utils/profiler.trace last, in a process of its own
    logdir = os.path.join(tmp, "slice21_trace")
    spawn = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=spawn) as child:
        tr = child.submit(profile_pass.traced_pass, cfg, files, feed,
                          logdir).result()
    tr["secs"] = time.perf_counter() - t0
    flagship_pass0("traced pass", tr)
    k = tr["kernel_calls"]
    check(k["push_adagrad"] >= tr["batches"]
          and k["gather_rows"] >= tr["batches"]
          and set(profile_pass.TRACE_SPANS) <= set(tr["spans"]),
          "utils/profiler.trace's chrome trace: %s" % tr)
    out["trace"] = tr
    log("slice21 utils/profiler.trace in a child process: %s"
        % json.dumps(tr))
    return out


# phase 22: the sharded trainer at world 1 over NCCL, in a spawned child
# the launches the two passes must make: a pull a step (16 a pass), a
# promote (the second pass) and a touched-row write-back a pass on
# gather_rows; one fused push a step
SHARDED_LAUNCHES = {"push_adagrad": 32, "gather_rows": 35,
                    "blocked_write": 0, "scale_copy": 0}
# its bf16 leg's (FLAGSHIP_BF16): the 2-byte forms, as phase 12's
SHARDED_BF16_LAUNCHES = {"push_adagrad_bf16": 32, "gather_rows_decode": 32,
                         "gather_rows_2byte": 3}
SHARDED_CHILD_S = 720.0       # the child's wall limit (phases 22-28)
SHARDED_GROUP_S = 120.0       # its process groups' timeout
SHARDED_SEED = 0              # the main path's trainer seed


def sharded_kernels(torch, trainer, ds, cfg):
    """Phase 22's kernels at the world-1 shard shapes, bit-equal to their
    plain versions: gather_rows over the staged first batch's incoming ids
    (P * KB = 262,144, padding on the trash row) from the shard's
    2^20 x 17 slab, and the fused push_adagrad over that batch's received
    push rows [262,144, 12] (its pull, forward, backward, bucket merge and
    push a2a, nothing applied) with the host-staged dedup; kernel, plain,
    library (index_select for the gather) and bound times. Then the
    step's three collectives timed on their inputs (device ms, CUDA
    events): the pull's values a2a, the push rows' a2a and the dense
    all_reduce (grads and the loss)."""
    import numpy as np
    import torch.distributed as dist

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import PushLayout
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.ops.sparse import build_push_grads
    from paddlebox_tpu_torch.push_probe import SEED, fused_push_bytes
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain
    from paddlebox_tpu_torch.train.trainer import task_label

    layout = trainer.layout
    conf = cfg.table().optimizer
    D = cfg.embedx
    W, G = layout.width, PushLayout(D).width
    b = ds.split_batches(1)[0][0]
    st = trainer._to_device(trainer.stage_host(b))
    trainer._wait_ready(st)
    slab = trainer.table.resident_slab
    ids = st["req"]
    ids_np = ids.cpu().numpy()
    out = {}
    # --- gather_rows, the shard's pull
    got = rk.gather_rows(slab, ids)
    torch.cuda.synchronize()
    want = rk.gather_rows_plain(slab, ids)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(got, slab.index_select(0, ids)),
          "gather_rows at the shard shape differs from the plain version")
    nbytes = gather_bytes(ids_np, slab.shape[0], W)
    args = (slab, ids)
    out["gather_rows"] = {
        "ids": int(ids_np.size), "distinct": int(np.unique(ids_np).size),
        "slab": list(slab.shape), "bytes": nbytes,
        "max_abs_err": float((got - want).abs().max()),
        "ms": time_chain(rk.gather_rows, args, nbytes),
        "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
        "library_ms": time_chain(lambda a, i: a.index_select(0, i), args,
                                 nbytes),
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
    from paddlebox_tpu_torch.ops.sparse import (gather_slab_rows,
                                                pull_view_from_rows)
    # the pull's values before their a2a, and the restored embeddings
    pview = pull_view_from_rows(gather_slab_rows(slab, ids, layout), layout)
    del got, want
    # --- the step's push rows, nothing applied
    emb = trainer._pull(st)[0].detach().requires_grad_(True)
    _, loss, _ = trainer._forward(emb, None, st)
    loss.backward()
    S = trainer.num_slots
    seg, valid = st["segments"], st["valid"]
    clicks = task_label(st, trainer.task_names[0]).index_select(0, seg // S)
    pg = build_push_grads(emb.grad, seg % S, clicks, valid)
    bucket = pk.merge_push_grads(pg, st["bperm"], st["boffsets"])
    g = torch.empty_like(bucket)
    dist.all_to_all_single(g, bucket, group=trainer.mesh.group)
    trainer.dense_opt.zero_grad(set_to_none=True)
    u, p, o, n_uniq = st["uids"], st["perm"], st["offsets"], st["n_uniq"]
    n_valid = int(o[-1])
    check(g.shape == (ids_np.size, G) and n_valid == int(
        (ids_np != slab.shape[0] - 1).sum()),
        "push inputs at the shard shape: rows %s, %d real of %d"
        % (tuple(g.shape), n_valid, ids_np.size))
    err = 0.0
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                          layout, conf, rows_out)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)),
              "push_adagrad (rows_out=%s) at the shard shape differs from "
              "the plain version" % rows_out)
        if rows_out:
            check(torch.equal(r_k.view(torch.int32), r_p.view(torch.int32)),
                  "push_adagrad rows out at the shard shape differ")
            err = max(err, float((r_k - r_p).abs().max()))
        err = max(err, float((s_k - s_p).abs().max()))
        del s_k, s_p, r_k, r_p
    nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
    # the update's work: the real uniques, the trash row left out
    n_real = int((u[:n_uniq] < slab.shape[0] - 1).sum())
    ops = n_valid * G + n_real * (20 + 6 * D)
    args = (slab, g, p, o, u)
    out["push_adagrad"] = {
        "rows": int(g.shape[0]), "occurrences": n_valid, "n_uniq": n_uniq,
        "bytes": nbytes, "max_abs_err": err,
        "ms": time_chain(lambda *a: pk.push_adagrad(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
            *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
        "library_ms": None,
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
                     else "operations")}
    # --- the step's three collectives on their inputs
    group = trainer.mesh.group

    def a2a(x):
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y

    def all_reduce(x):
        dist.all_reduce(x, group=group)
        return x

    flat = torch.cat([q.detach().reshape(-1)
                      for q in trainer.model.parameters()]
                     + [loss.detach().reshape(1)])
    colls = {}
    for name, fn, x in (("a2a_pull", a2a, pview.contiguous()),
                        ("a2a_push", a2a, bucket),
                        ("all_reduce", all_reduce, flat)):
        colls[name] = {"shape": list(x.shape), "bytes": x.nbytes,
                       "ms": time_chain(fn, (x,), x.nbytes)}
    return out, colls


def sha_of(keys, rows):
    import hashlib
    return hashlib.sha256(keys.tobytes() + rows.tobytes()).hexdigest()


def shard_store_rows(trainer):
    """The sharded trainer's owned store: its keys and rows, by key."""
    k, v = trainer.table.shard.store.state_items()
    order = k.argsort()
    return k[order], v[order]


def shard_store_sha(trainer):
    """sha256 of the sharded trainer's owned store, sorted by key."""
    return sha_of(*shard_store_rows(trainer))


def sharded_run(torch, files, feed, out_path, windows, bst_files, bst_feed):
    """Phase 22's body in the child: world 1 on cuda:0 over NCCL (a port-0
    TCPStore of the child's own), the sharded trainer at FLAGSHIP's full
    width, two passes through the chunk driver, then the kernels and the
    collectives at the shard shapes; then phase 23 on the same mesh (its
    files beside ``out_path``); then phases 24-27 on fleets of their own
    (25 over phase 19's ``windows`` and phase 17's BST files)."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
    from paddlebox_tpu_torch.native.build import build_kernels
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils.stats import stat_peek

    build_kernels()
    cfg = flagship.FLAGSHIP
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False)
    fl = Fleet().init(RoleMaker(0, 1), store=dist.PrefixStore("phase22",
                                                              store))
    mesh = fl.init_distributed(SHARDED_GROUP_S, device="cuda")
    check(mesh.backend == "nccl" and mesh.device.type == "cuda"
          and mesh.world == 1, "phase 22's mesh: %s on %s, world %d"
          % (mesh.backend, mesh.device, mesh.world))
    trainer, ds = flagship.build_sharded_trainer(files, feed, cfg, fleet=fl,
                                                 seed=SHARDED_SEED)
    try:
        check(trainer.bucket_cap == 2 * feed.key_capacity()
              and trainer.table.shard_cap == cfg.capacity,
              "phase 22's shapes: KB %d, shard_cap %d"
              % (trainer.bucket_cap, trainer.table.shard_cap))
        # the single-GPU trainer's seed sequence (BoxTrainer._draw_seed)
        gen = torch.Generator().manual_seed(SHARDED_SEED)
        trainer.seed_fn = lambda: int(torch.randint(0, 2**31 - 1, (),
                                                    generator=gen))
        stats0 = {k: stat_peek(k) for k in (
            "hostplane_exchange_bytes", "hostplane_exchange_us",
            "hostplane_exchange_steps")}
        reset_counts()
        passes = []
        for i in range(2):
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            auc = trainer.metrics.get_metric_msg(
                "auc", allreduce=fl.metric_allreduce())["auc"]
            passes.append({"pass": i, "loss": res["loss"], "auc": auc,
                           "batches": res["batches"],
                           "instances": res["instances"], "pass_s": secs,
                           "examples_per_s": res["instances"] / secs,
                           "phase_s": trainer.pass_times,
                           "stream_high_water": trainer.stream_high_water})
            if i == 0:
                # phase 23's one-pass runs are held to this store
                sha0 = shard_store_sha(trainer)
        launches = counts()
        stats = {k: stat_peek(k) - v for k, v in stats0.items()}
        # phase 25's PS-backed runs are held to these rows
        want_rows = shard_store_rows(trainer)
        sha = sha_of(*want_rows)
        out = {"passes": passes, "launches": launches, "store_sha0": sha0,
               "collectives": dict(trainer.collective_counts),
               "exchange": dict(stats, **trainer.host_mesh.stats()),
               "store_sha": sha, "backend": mesh.backend,
               "device": str(mesh.device),
               "bucket_cap": trainer.bucket_cap,
               "shard_cap": trainer.table.shard_cap}
        out["kernels"], out["collective_ms"] = sharded_kernels(
            torch, trainer, ds, cfg)
        out["bf16"] = sharded_bf16_run(torch, files, feed, fl)
        # 23. the remaining modes on the same mesh
        out["phase23"] = phase23_child(torch, files, feed, fl,
                                       os.path.dirname(out_path))
    finally:
        trainer.close()
        fl.stop()
    # 24. the other policies, the hot tier and the shuffled feed, each
    # policy on a fleet of its own
    out["phase24"] = phase24_child(torch, files, feed, store)
    # 25. the sharded SSD tier, the PS-backed table, Downpour and the
    # sequence trainer over an sp group
    out["phase25"] = phase25_child(torch, files, feed, windows, bst_files,
                                   bst_feed, store,
                                   os.path.dirname(out_path), want_rows)
    # 26. the stream over the shard, the model-parallel towers and heter
    out["phase26"] = phase26_child(torch, files, feed, windows, store,
                                   os.path.dirname(out_path))
    # 27. pipeline parallelism at one stage
    out["phase27"] = phase27_child(torch, files, feed, store)
    # 28. the pipeline over the sharded table at world 1
    out["phase28"] = phase28_child(torch, files, feed, store)
    return out


def sharded_bf16_run(torch, files, feed, fl):
    """Phase 22's bf16 leg: FLAGSHIP_BF16 through the sharded trainer on
    the same world-1 mesh, two passes with the main path's seeds: its
    digits (BF16_DIGITS, phase 12's) and its launches (the kernels' 2-byte
    forms: the fused push and the decoding pull once a step, the raw
    2-byte gather at the promote and the two write-backs)."""
    from paddlebox_tpu_torch.train import flagship

    trainer, ds = flagship.build_sharded_trainer(
        files, feed, flagship.FLAGSHIP_BF16, fleet=fl, seed=SHARDED_SEED)
    check(trainer.table.resident_slab is None and trainer.layout.bf16,
          "phase 22's bf16 trainer: layout %s" % trainer.layout)
    gen = torch.Generator().manual_seed(SHARDED_SEED)
    trainer.seed_fn = lambda: int(torch.randint(0, 2**31 - 1, (),
                                                generator=gen))
    try:
        reset_counts()
        passes = []
        for i in range(2):
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            auc = trainer.metrics.get_metric_msg(
                "auc", allreduce=fl.metric_allreduce())["auc"]
            passes.append({"pass": i, "loss": res["loss"], "auc": auc,
                           "pass_s": time.perf_counter() - t0,
                           "slab_dtype": str(
                               trainer.table.resident_slab.dtype)})
        return {"passes": passes,
                "launches": counts()}
    finally:
        trainer.close()


# phase 23: the sharded trainer's remaining modes at world 1 over NCCL, in
# phase 22's child after its runs, each a fresh trainer at FLAGSHIP's full
# width with the main path's seeds. The runs held bit for bit to phase
# 22's scatter run: (label, build keywords, passes); one pass where the
# first shows the mode, two for k_step (its syncs cross the pass end)
PHASE23_EXACT = (
    ("blocked", dict(push="blocked"), 1),
    ("rebuild", dict(push="rebuild"), 1),
    ("uid wire", dict(stage=dict(h2d_lean=True)), 1),
    ("delta wire", dict(stage=dict(h2d_lean=True, wire_delta_ids=True)), 1),
    ("ids-only wire", dict(stage=dict(h2d_lean=True, h2d_uid_wire=False)),
     1),
    ("k_step", dict(fields=dict(sync_mode="k_step", sync_weight_step=4)), 2),
    ("mesh 1x1", dict(mesh2d=True), 1),
    ("sync_one_ring", dict(mesh2d=True, fields=dict(sync_one_ring=True)), 1),
)
# the gates stated in PERF.md before the first run on the card, against
# FLAGSHIP_DIGITS' first pass: ZeRO-1's hand-written Adam (loss rtol,
# |dAUC|), the bf16 a2a's (loss rtol, |dAUC|)
ZERO1_GATE = (1e-4, 1e-3)
BF16_A2A_GATE = (3e-2, 0.01)
# device-collect AUC against the host mode: the reference's own gates
# (tests/test_sharded.py:429-471), (rtol, atol) a key
COLLECT_GATES = {"auc": (2e-3, 0.0), "mae": (1e-4, 0.0), "rmse": (1e-4, 0.0),
                 "actual_ctr": (1e-4, 0.0), "predicted_ctr": (1e-4, 0.0),
                 "bucket_error": (0.0, 5e-3)}
MSG_KEYS = ("auc", "bucket_error", "mae", "rmse", "actual_ctr",
            "predicted_ctr", "size")


def main_path_seeds(torch):
    """The single-GPU trainer's seed sequence (BoxTrainer._draw_seed)."""
    gen = torch.Generator().manual_seed(SHARDED_SEED)
    return lambda: int(torch.randint(0, 2**31 - 1, (), generator=gen))


def phase23_run(torch, files, feed, fl, label, cfg=None, push="scatter",
                stage=None, fields=None, mesh2d=False, metric=None,
                passes=1, keep=False):
    """One phase 23 run: flagship.build_sharded_trainer on the fleet's
    world-1 mesh (a 1 x 1 device_mesh_2d with ``mesh2d``) with the write
    ``push``, the StageFlags fields ``stage``, the TrainerConfig fields
    ``fields`` and the metric's keywords ``metric``; ``passes`` passes
    with the main path's seeds. A record: each pass's loss, AUC, metric
    message and wall, the launches, the collectives, the a2as' bytes,
    the metric reads, the store's sha256. With ``keep`` also (trainer,
    dataset), left open."""
    from paddlebox_tpu_torch.config.flags import PushFlags, StageFlags
    from paddlebox_tpu_torch.parallel.mesh import device_mesh_2d
    from paddlebox_tpu_torch.train import flagship

    mesh = (device_mesh_2d(fl.mesh, 1, 1, timeout=SHARDED_GROUP_S)
            if mesh2d else None)
    trainer, ds = flagship.build_sharded_trainer(
        files, feed, cfg or flagship.FLAGSHIP, fleet=fl, seed=SHARDED_SEED,
        mesh=mesh, push_flags=PushFlags(push, flagship.BLOCK_ROWS),
        stage_flags=StageFlags(**(stage or {})), metric=metric,
        **(fields or {}))
    trainer.seed_fn = main_path_seeds(torch)
    reset_counts()
    out = []
    for i in range(passes):
        t0 = time.perf_counter()
        res = trainer.train_pass(ds)
        torch.cuda.synchronize()
        msg = trainer.metrics.get_metric_msg(
            "auc", allreduce=fl.metric_allreduce())
        out.append({"pass": i, "loss": res["loss"], "auc": msg["auc"],
                    "batches": res["batches"],
                    "pass_s": time.perf_counter() - t0,
                    "msg": {k: float(msg[k]) for k in MSG_KEYS if k in msg}})
    rec = {"label": label, "passes": out,
           "launches": counts(),
           "collectives": dict(trainer.collective_counts),
           "a2a_bytes": dict(trainer.a2a_bytes),
           "d2h_reads": trainer.d2h_reads, "store_sha": shard_store_sha(trainer),
           "push_write": trainer.push_write,
           "wire": trainer.stage_flags.wire}
    if keep:
        return rec, trainer, ds
    trainer.close()
    return rec


def shard_step_rows(torch, trainer, ds):
    """The first batch of ``ds`` staged on the trainer and its step's
    received push rows (the pull, forward, backward, bucket merge and push
    a2a; nothing applied): (staged, rows)."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                                build_push_grads_extended)
    from paddlebox_tpu_torch.train.trainer import task_label

    b = ds.split_batches(1)[0][0]
    st = trainer._to_device(trainer.stage_host(b))
    trainer._wait_ready(st)
    emb, exp, _ = trainer._pull(st)
    emb = emb.detach().requires_grad_(True)
    if exp is not None:
        exp = exp.detach().requires_grad_(True)
    _, loss, _ = trainer._forward(emb, exp, st)
    loss.backward()
    S = trainer.num_slots
    seg, valid = st["segments"], st["valid"]
    clicks = task_label(st, trainer.task_names[0]).index_select(0, seg // S)
    if exp is not None:
        pg = build_push_grads_extended(emb.grad, exp.grad, seg % S, clicks,
                                       valid)
    else:
        pg = build_push_grads(emb.grad, seg % S, clicks, valid)
    bucket = pk.merge_push_grads(pg, st["bperm"], st["boffsets"])
    g = torch.empty_like(bucket)
    dist.all_to_all_single(g, bucket, group=trainer.mesh.group)
    trainer.dense_opt.zero_grad(set_to_none=True)
    return st, g


def bits_of(torch, t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def gather_record(torch, src, ids, what):
    """gather_rows of ``ids`` from ``src`` bit-equal to its plain version
    and to index_select; kernel, plain, library and bound times."""
    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain

    got = rk.gather_rows(src, ids)
    torch.cuda.synchronize()
    want = rk.gather_rows_plain(src, ids)
    check(torch.equal(bits_of(torch, got), bits_of(torch, want))
          and torch.equal(got, src.index_select(0, ids.long())),
          "gather_rows %s differs from the plain version" % what)
    ids_np = ids.cpu().numpy()
    nbytes = gather_bytes(ids_np, src.shape[0], src.shape[1])
    args = (src, ids)
    return {"src": list(src.shape), "ids": int(ids_np.size),
            "distinct": int(len(set(ids_np.tolist()))), "bytes": nbytes,
            "max_abs_err": float((got - want).abs().max()),
            "ms": time_chain(rk.gather_rows, args, nbytes),
            "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
            "library_ms": time_chain(lambda a, i: a.index_select(0, i),
                                     args, nbytes),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}


def phase23_write_kernels(torch, trainer, ds):
    """The blocked placement and the rebuild gather at the shard shapes,
    from the blocked run's trainer: its first batch's push rows
    (push_adagrad rows out over the shard's 2^20 x 17 slab) placed by
    blocked_write in BLOCK_ROWS blocks (against its plain version and
    index_copy_ of the same rows), and spread by gather_rows over the
    clamped [2^20] position map (against its plain version and
    index_select); kernel, plain, library and bound times."""
    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import (blocked_layout,
                                                          rebuild_pos)
    from paddlebox_tpu_torch.push_probe import SEED
    from paddlebox_tpu_torch.rate_probe import time_chain
    from paddlebox_tpu_torch.train import flagship

    layout, conf = trainer.layout, trainer.table.config.optimizer
    st, g = shard_step_rows(torch, trainer, ds)
    slab = trainer.table.resident_slab
    cap, W = slab.shape
    u, p, o, n_uniq = st["uids"], st["perm"], st["offsets"], st["n_uniq"]
    rows = pk.push_adagrad(slab.clone(), g, p, o, u, n_uniq, SEED, layout,
                           conf, rows_out=True)
    row_map, blk_idx = blocked_layout(u, cap, flagship.BLOCK_ROWS)
    s_k, s_p, s_l = slab.clone(), slab.clone(), slab.clone()
    pk.blocked_write(s_k, rows, row_map, blk_idx)
    torch.cuda.synchronize()
    pk.blocked_write_plain(s_p, rows, row_map, blk_idx)
    idx = u[:n_uniq].long()
    s_l.index_copy_(0, idx, rows)
    check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
          and torch.equal(s_k.view(torch.int32), s_l.view(torch.int32)),
          "blocked_write at the shard shape differs from its plain version "
          "or index_copy_")
    NB, B = row_map.shape
    placed = int((row_map >= 0).sum())
    nbytes = NB * B * 4 + NB * 4 + placed * W * 4 * 2
    args = (s_k, rows, row_map, blk_idx)
    ms, lib_ms, ratios = blocked_balanced(args, (s_l, idx, rows), nbytes)
    blocked = {"slab": [cap, W], "rows": [n_uniq, W], "NB": NB, "B": B,
               "placed": placed, "bytes": nbytes,
               "max_abs_err": float((s_k - s_p).abs().max()),
               "ms": ms,
               "plain_ms": time_chain(pk.blocked_write_plain, args, nbytes),
               "library_ms": lib_ms, "library_ratios": ratios,
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "bound_by": "bytes"}
    del s_k, s_p, s_l
    pos = rebuild_pos(u, n_uniq, cap).clamp(0, n_uniq - 1)
    gather = gather_record(torch, rows, pos, "at the shard's rebuild map")
    return {"blocked_write": blocked, "rebuild_gather": gather}


def phase23_expand_kernels(torch, trainer, ds):
    """The expand block's kernels at the shard shapes, from the sharded
    FLAGSHIP_EXPAND trainer: gather_rows of the first batch's 262,144
    incoming ids from the 2^20 x 82 slab (the extended pull), and the
    fused push's expand form over its 262,144 received push rows of
    width 76 (scatter and rows out), each bit-equal to its plain
    version; kernel, plain, library (index_select for the gather) and
    bound times."""
    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.push_probe import SEED, fused_push_bytes
    from paddlebox_tpu_torch.rate_probe import time_chain

    layout, conf = trainer.layout, trainer.table.config.optimizer
    st, g = shard_step_rows(torch, trainer, ds)
    slab = trainer.table.resident_slab
    cap, W = slab.shape
    pull = gather_record(torch, slab, st["req"], "at width %d" % W)
    u, p, o, n_uniq = st["uids"], st["perm"], st["offsets"], st["n_uniq"]
    n_valid = int(o[-1])
    G = g.shape[1]
    err = 0.0
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                          layout, conf, rows_out)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
              and (not rows_out or torch.equal(r_k.view(torch.int32),
                                               r_p.view(torch.int32))),
              "push_adagrad_expand (rows_out=%s) at the shard shape differs "
              "from the plain version" % rows_out)
        err = max(err, float((s_k - s_p).abs().max()))
        del s_k, s_p, r_k, r_p
    nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
    n_real = int((u[:n_uniq] < cap - 1).sum())
    ops = n_valid * G + n_real * (20 + 6 * (layout.embedx_dim
                                            + layout.expand_dim))
    args = (slab, g, p, o, u)
    push = {"slab": [cap, W], "rows": [int(g.shape[0]), G],
            "occurrences": n_valid, "n_uniq": n_uniq, "bytes": nbytes,
            "max_abs_err": err,
            "ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
            "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
            "library_ms": None,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS else "operations")}
    return {"expand_pull": pull, "expand_push": push}


def phase23_day(torch, files, feed, fl, tmp):
    """A two-pass run_day (a delta save after each pass, the base at the
    day's end) over the sharded trainer, its CheckpointManager driving
    the table's store_view, and over the single-GPU trainer,
    each into a temp dir of its own: the base's sparse rows (sorted)
    sha256, the store's sha256, the passes' digits and walls."""
    import hashlib

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import checkpoint as ck
    from paddlebox_tpu_torch.train import flagship

    out = {}
    for name in ("sharded", "single"):
        if name == "sharded":
            trainer, _ = flagship.build_sharded_trainer(
                files, feed, flagship.FLAGSHIP, fleet=fl, seed=SHARDED_SEED)
            trainer.seed_fn = main_path_seeds(torch)
            store = lambda: trainer.table.shard.store  # noqa: E731
        else:
            trainer, _ = flagship.build_trainer(
                files, feed, flagship.FLAGSHIP, "scatter", "cuda",
                seed=SHARDED_SEED)
            store = lambda: trainer.table.store  # noqa: E731
        root = os.path.join(tmp, "phase23_day_" + name)
        cm = ck.CheckpointManager(
            CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                             xbox_model_dir=os.path.join(root, "xbox")),
            trainer.table)
        days = []
        for _ in range(2):
            d = BoxDataset(feed)
            d.set_filelist(files)
            days.append(d)
        t0 = time.perf_counter()
        stats, dirs = ck.run_day(trainer, days, cm, "d23")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        blob = ck.read_batch_sparse(dirs[0])
        order = blob["keys"].argsort()
        k, v = store().state_items()
        o2 = k.argsort()
        out[name] = {
            "losses": [s["loss"] for s in stats], "day_s": wall,
            "base_rows": int(order.size),
            "base_sha": hashlib.sha256(
                blob["keys"][order].tobytes()
                + blob["values"][order].tobytes()).hexdigest(),
            "store_sha": hashlib.sha256(k[o2].tobytes()
                                        + v[o2].tobytes()).hexdigest(),
            "view_is_store": cm.store is store()}
        trainer.close()
    return out


def phase23_child(torch, files, feed, fl, tmp):
    """Phase 23 in the child: the exact runs, ZeRO-1, the bf16 a2a, the
    expand block (sharded and single-GPU), device-collect AUC and its
    host-mode run, the kernels at the shard shapes, the day. A record of
    each, and the phase's host seconds."""
    from paddlebox_tpu_torch.train import flagship

    t0 = time.perf_counter()
    out = {"exact": {}, "kernels": {}}
    for label, kw, passes in PHASE23_EXACT:
        if label == "blocked":
            rec, trainer, ds = phase23_run(torch, files, feed, fl, label,
                                           passes=passes, keep=True, **kw)
            out["kernels"].update(phase23_write_kernels(torch, trainer, ds))
            trainer.close()
            del trainer, ds
        else:
            rec = phase23_run(torch, files, feed, fl, label, passes=passes,
                              **kw)
        out["exact"][label] = rec
    out["zero1"] = phase23_run(torch, files, feed, fl, "zero1",
                               fields=dict(sync_mode="sharding"))
    out["bf16_a2a"] = phase23_run(torch, files, feed, fl, "bf16 a2a",
                                  fields=dict(a2a_dtype="bfloat16"))
    rec, trainer, ds = phase23_run(torch, files, feed, fl, "expand",
                                   cfg=flagship.FLAGSHIP_EXPAND, keep=True)
    out["kernels"].update(phase23_expand_kernels(torch, trainer, ds))
    trainer.close()
    del trainer, ds
    out["expand"] = rec
    single, sds = flagship.build_trainer(files, feed, flagship.FLAGSHIP_EXPAND,
                                         "scatter", "cuda", seed=SHARDED_SEED)
    reset_counts()
    res = single.train_pass(sds)
    torch.cuda.synchronize()
    out["expand_single"] = {
        "loss": res["loss"],
        "auc": single.metrics.get_metric_msg("auc")["auc"],
        "launches": counts(),
        "store_sha": store_sha(single.table)}
    single.close()
    del single, sds
    out["collect_host"] = phase23_run(torch, files, feed, fl, "collect host",
                                      metric=dict(mask_var="mask"))
    out["collect_device"] = phase23_run(
        torch, files, feed, fl, "collect device",
        metric=dict(mask_var="mask", mode_collect_in_device=True))
    out["day"] = phase23_day(torch, files, feed, fl, tmp)
    out["child_s"] = time.perf_counter() - t0
    return out


def phase23_launches(label, steps, passes):
    """The launches a phase 23 run must make over ``steps`` steps of
    ``passes`` passes: a pull and a push a step, a write-back a pass, a
    promote each pass after the first; the blocked write's placement a
    step, the rebuild write's gather a step."""
    out = {"push_adagrad": steps,
           "gather_rows": steps + passes + (passes - 1)
           + (steps if label == "rebuild" else 0),
           "blocked_write": steps if label == "blocked" else 0}
    return out


def phase23_report(res, p22):
    """Phase 23's checks and lines in the parent, against phase 22's run
    ``p22`` (FLAGSHIP_DIGITS, its stores' sha256 after each pass)."""
    steps = lambda r: sum(p["batches"] for p in r["passes"])  # noqa: E731
    for label, r in res["exact"].items():
        n = len(r["passes"])
        digits = {"loss": tuple("%.10f" % p["loss"] for p in r["passes"]),
                  "auc": tuple("%.10f" % p["auc"] for p in r["passes"])}
        want = {k: v[:n] for k, v in FLAGSHIP_DIGITS.items()}
        sha = p22["store_sha0"] if n == 1 else p22["store_sha"]
        launches = {k: r["launches"][k] for k in ("push_adagrad",
                                                  "gather_rows",
                                                  "blocked_write")}
        check(digits == want and r["store_sha"] == sha
              and launches == phase23_launches(label, steps(r), n),
              "phase 23 %s: digits %s (want %s), store %s (want %s), "
              "launches %s (want %s)"
              % (label, digits, want, r["store_sha"], sha, launches,
                 phase23_launches(label, steps(r), n)))
        log("sharded23 %s: %d pass(es) bit-identical to phase 22's scatter "
            "run (digits %s, store sha256 %s); write %s, wire %s; launches "
            "%s; collectives %s; walls %s"
            % (label, n, json.dumps(digits), sha, r["push_write"], r["wire"],
               json.dumps(r["launches"]), json.dumps(r["collectives"]),
               [p["pass_s"] for p in r["passes"]]))
    ref_loss = float(FLAGSHIP_DIGITS["loss"][0])
    ref_auc = float(FLAGSHIP_DIGITS["auc"][0])
    for key, gate in (("zero1", ZERO1_GATE), ("bf16_a2a", BF16_A2A_GATE)):
        r = res[key]
        p = r["passes"][0]
        dl = abs(p["loss"] - ref_loss) / ref_loss
        da = abs(p["auc"] - ref_auc)
        check(dl <= gate[0] and da <= gate[1],
              "phase 23 %s: loss %.10f auc %.10f against %.10f %.10f "
              "(rel %.3g, |dAUC| %.3g; gate %s)"
              % (key, p["loss"], p["auc"], ref_loss, ref_auc, dl, da, gate))
        log("sharded23 %s pass: loss %.10f auc %.10f; rel dloss %.3g, |dAUC| "
            "%.3g against FLAGSHIP_DIGITS' first pass (gate %s); launches "
            "%s; collectives %s; a2a bytes %s; wall %.3f s"
            % (key, p["loss"], p["auc"], dl, da, gate,
               json.dumps(r["launches"]), json.dumps(r["collectives"]),
               json.dumps(r["a2a_bytes"]), p["pass_s"]))
    st = steps(res["bf16_a2a"])
    b16 = res["bf16_a2a"]["a2a_bytes"]
    b32 = res["exact"]["rebuild"]["a2a_bytes"]
    per_step = {"pull_f32": b32["a2a_pull"] / st,
                "pull_bf16": b16["a2a_pull"] / st,
                "push_f32": b32["a2a_push"] / st,
                "push_bf16": (b16["a2a_push"] + b16["a2a_push_meta"]) / st}
    # the push row: slot, show and click (f32 on their own a2a), then the
    # gradient columns as bf16
    from paddlebox_tpu_torch.train import flagship
    G = 4 + flagship.FLAGSHIP.embedx
    check(2 * b16["a2a_pull"] == b32["a2a_pull"]
          and G * b16["a2a_push_meta"] == 3 * b32["a2a_push"]
          and 2 * G * b16["a2a_push"] == (G - 3) * b32["a2a_push"],
          "phase 23 bf16 a2a bytes %s against f32's %s" % (b16, b32))
    log("sharded23 bf16 a2a bytes a step: %s" % json.dumps(per_step))
    e, s = res["expand"], res["expand_single"]
    p = e["passes"][0]
    check(p["loss"] == s["loss"] and p["auc"] == s["auc"]
          and e["store_sha"] == s["store_sha"]
          and e["launches"]["push_adagrad_expand"]
          == s["launches"]["push_adagrad_expand"] == steps(e),
          "phase 23 expand: sharded %s, single %s" % (e, s))
    log("sharded23 expand (FLAGSHIP_EXPAND, world 1) = the single-GPU run "
        "bit for bit: loss %.10f auc %.10f, store sha256 %s, launches %s "
        "(single %s); wall %.3f s"
        % (p["loss"], p["auc"], s["store_sha"], json.dumps(e["launches"]),
           json.dumps(s["launches"]), p["pass_s"]))
    h, d = res["collect_host"], res["collect_device"]
    mh, md = h["passes"][0]["msg"], d["passes"][0]["msg"]
    ok = h["passes"][0]["loss"] == d["passes"][0]["loss"] \
        and d["d2h_reads"] == 2 and mh["size"] == md["size"]
    diffs = {}
    for k, (rtol, atol) in COLLECT_GATES.items():
        diffs[k] = abs(md[k] - mh[k])
        ok = ok and diffs[k] <= atol + rtol * abs(mh[k])
    check(ok, "phase 23 device-collect AUC %s against the host mode %s "
          "(reads %d)" % (md, mh, d["d2h_reads"]))
    log("sharded23 device-collect AUC: device %s, host %s, |diff| %s "
        "(gates %s); metric reads to the host: device %d a pass, host %d"
        % (json.dumps(md), json.dumps(mh), json.dumps(diffs),
           json.dumps(COLLECT_GATES), d["d2h_reads"], h["d2h_reads"]))
    day = res["day"]
    check(day["sharded"]["base_sha"] == day["single"]["base_sha"]
          and day["sharded"]["store_sha"] == day["single"]["store_sha"]
          and day["sharded"]["losses"] == day["single"]["losses"]
          and day["sharded"]["view_is_store"],
          "phase 23 day: %s" % day)
    log("sharded23 day (run_day, two passes, world 1) = the single-GPU day: "
        "%s" % json.dumps(day))
    for name, rec in res["kernels"].items():
        log("sharded23 %s at the shard shape: bit-equal to the plain "
            "version; %s" % (name, json.dumps(rec)))
    log("sharded23 phase seconds in the child: %.3f" % res["child_s"])


# phase 24: the table-wise and 2-D grid policies, the grid's replicated hot
# tier and the cross-host shuffled feed, in phase 22's child after phase 23,
# at FLAGSHIP's full width with the main path's seeds. A fleet's exchange
# serves one sharding policy, so each policy runs on a world-1 NCCL fleet
# of its own (phase 22's is stopped first), on the child's TCPStore under a
# prefix of its own.
PHASE24_TABLES = dict(sharding_num_tables=53, sharding_table_shift=0)
# the hot tier over the main path's four files: a FreqSketch of 2^16
# entries fed each file's keys in load order halves past its cap, so after
# the first pass 2,539 keys have a count of 2 or more and 39 of 3 or more,
# after the second 2,890 and 58 (the port's FreqSketch over the files on
# the CPU, the same code the trainer runs). A threshold of 2 with a cap of
# 4096 keeps both passes' frozen sets between 256 keys and the cap.
PHASE24_HOT = dict(sharding_hot_threshold=2, sharding_hot_cap=4096)
PHASE24_HOT_RANGE = (256, 4096)
# the shuffled feed: two TcpShufflers (ranks 0 and 1) on threads of the
# child, the block codec
PHASE24_SHUFFLE_WORLD = 2


def phase24_fleet(store, name):
    """A world-1 NCCL fleet on cuda:0 over the child's TCPStore, its keys
    under the prefix phase24-<name>."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
    fl = Fleet().init(RoleMaker(0, 1),
                      store=dist.PrefixStore("phase24-" + name, store))
    fl.init_distributed(SHARDED_GROUP_S, device="cuda")
    return fl


def phase24_run(torch, files, feed, fl, label, shard, stage=None, passes=1):
    """One phase 24 run on ``fl``: flagship.build_sharded_trainer under the
    ShardFlags fields ``shard`` and the StageFlags fields ``stage``,
    ``passes`` passes with the main path's seeds. (record, trainer,
    dataset), the trainer open: each pass's digits, wall, frozen hot keys
    and the hot ids kept off the wire and added back in it; the launches,
    the router's calls by entry, the store's sha256, the policy's
    identity."""
    from paddlebox_tpu_torch.config.flags import ShardFlags, StageFlags
    from paddlebox_tpu_torch.train import flagship

    trainer, ds = flagship.build_sharded_trainer(
        files, feed, flagship.FLAGSHIP, fleet=fl, seed=SHARDED_SEED,
        stage_flags=StageFlags(**(stage or {})),
        shard_flags=ShardFlags(**shard))
    trainer.seed_fn = main_path_seeds(torch)
    reset_counts()
    out = []
    for i in range(passes):
        before = dict(trainer.hot_counts)
        t0 = time.perf_counter()
        res = trainer.train_pass(ds)
        torch.cuda.synchronize()
        auc = trainer.metrics.get_metric_msg(
            "auc", allreduce=fl.metric_allreduce())["auc"]
        out.append({
            "pass": i, "loss": res["loss"], "auc": auc,
            "batches": res["batches"], "pass_s": time.perf_counter() - t0,
            "phase_s": dict(trainer.pass_times),
            "hot_frozen": trainer.table.hot_frozen,
            "hot_dropped": trainer.hot_counts.get("dropped", 0)
            - before.get("dropped", 0),
            "hot_readded": trainer.hot_counts.get("readded", 0)
            - before.get("readded", 0)})
    rec = {"label": label, "passes": out,
           "launches": counts(),
           "route_counts": dict(trainer.table.route_counts),
           "store_sha": shard_store_sha(trainer),
           "policy": trainer.policy.describe(),
           "aggregator": trainer.aggregator is None,
           "wire": trainer.stage_flags.wire}
    return rec, trainer, ds


def phase24_hot_tier(torch, trainer):
    """ReplicatedHotTier over the hot run's owned store: refresh, then its
    lookup of the frozen keys against store.lookup of the same keys, bit
    for bit; the mirror's rows and seconds."""
    import numpy as np

    from paddlebox_tpu_torch.parallel.sharding import ReplicatedHotTier
    tier = ReplicatedHotTier(trainer.policy)
    hot = trainer.policy.hot_keys_frozen()
    t0 = time.perf_counter()
    with trainer.table.store_lock:
        n = tier.refresh(trainer.table.stores)
        want = trainer.table.shard.store.lookup(hot)
    refresh_s = time.perf_counter() - t0
    rows, found = tier.lookup(hot)
    check(n == hot.size and bool(found.all())
          and np.array_equal(rows.view(np.uint32),
                             np.asarray(want, np.float32).view(np.uint32)),
          "phase 24 ReplicatedHotTier: %d rows of %d hot keys, lookup "
          "differs from the store" % (n, hot.size))
    return {"rows": n, "width": int(rows.shape[1]),
            "refresh_s": refresh_s}


def phase24_hot_push(torch, trainer, ds):
    """The fused push over the hot run's widened uid vector: the first
    batch staged on the uid wire (the owner's uids hold its whole hot set,
    hot ids the batch did not touch among them), its received push rows,
    the device maps from the a2a'd ids (push_sparse_uidwire's); push_adagrad
    against its plain version bit for bit, scatter and rows out, the rows
    of the untouched hot ids unchanged; kernel, plain and bound times."""
    import numpy as np

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import device_push_maps
    from paddlebox_tpu_torch.push_probe import SEED, fused_push_bytes
    from paddlebox_tpu_torch.rate_probe import time_chain

    layout, conf = trainer.layout, trainer.table.config.optimizer
    st, g = shard_step_rows(torch, trainer, ds)
    req = trainer._req(st)
    slab = trainer.table.resident_slab
    cap, W = slab.shape
    u, n_uniq, n_valid = st["uids"], st["n_uniq"], st["push_n_valid"]
    inv = torch.searchsorted(u, req, out_int32=True)
    p, o = device_push_maps(inv, n_valid)
    u_np = u[:n_uniq].cpu().numpy()
    touched = np.unique(req.cpu().numpy())
    hot = trainer.policy.hot_local_ids(trainer.rank)
    idle = np.setdiff1d(hot, touched).astype(np.int64)
    check(np.isin(hot, u_np).all() and idle.size > 0,
          "phase 24 hot push: the uid vector holds %d of the %d hot ids, "
          "%d untouched" % (int(np.isin(hot, u_np).sum()), hot.size,
                            idle.size))
    err = 0.0
    idle_t = torch.from_numpy(idle).to(slab.device)
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout, conf,
                              rows_out)
        torch.cuda.synchronize()
        r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                          layout, conf, rows_out)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
              and (not rows_out or torch.equal(r_k.view(torch.int32),
                                               r_p.view(torch.int32))),
              "push_adagrad (rows_out=%s) over the hot uid vector differs "
              "from the plain version" % rows_out)
        check(torch.equal(s_k.index_select(0, idle_t).view(torch.int32),
                          slab.index_select(0, idle_t).view(torch.int32)),
              "the push changed rows of hot ids the batch did not touch")
        err = max(err, float((s_k - s_p).abs().max()))
        del s_k, s_p, r_k, r_p
    G = g.shape[1]
    nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
    n_real = int((u_np < cap - 1).sum())
    ops = n_valid * G + n_real * (20 + 6 * layout.embedx_dim)
    args = (slab, g, p, o, u)
    return {"slab": [cap, W], "rows": [int(g.shape[0]), G],
            "occurrences": n_valid, "n_uniq": n_uniq,
            "hot_ids": int(hot.size), "hot_untouched": int(idle.size),
            "bytes": nbytes, "max_abs_err": err,
            "ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
            "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args, nbytes),
            "library_ms": None,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS else "operations")}


def block_records(block):
    """The sorted per-record signatures (label, slots and keys as bytes) of
    a ColumnarBlock: its records as a multiset."""
    import numpy as np
    off = block.rec_offsets
    keys = block.keys.view(np.uint8).reshape(-1, 8)
    slots = block.key_slot.view(np.uint8).reshape(-1, 4)
    return sorted((int(block.labels[r]),
                   slots[off[r]:off[r + 1]].tobytes(),
                   keys[off[r]:off[r + 1]].tobytes())
                  for r in range(block.n_recs))


def phase24_shuffled_load(feed, files, add_keys_fn=None):
    """The shuffled feed: two TcpShufflers on localhost (ranks 0 and 1, the
    block codec), each rank's BoxDataset loading my_shard_files(rank, 2)
    on a thread of its own (the flush waits for the peer), ``add_keys_fn``
    on rank 0's. (datasets, the load's wall, each rank's frame bytes sent
    and received)."""
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.data.shuffle import TcpShuffler

    world = PHASE24_SHUFFLE_WORLD
    shs = [TcpShuffler(r, world, [("127.0.0.1", 0)] * world)
           for r in range(world)]
    eps = [("127.0.0.1", sh.port) for sh in shs]
    errs = []
    try:
        for sh in shs:
            sh.endpoints = eps
        dss = []
        for r in range(world):
            ds = BoxDataset(feed, shuffler=shs[r])
            ds.set_filelist(files)
            ds.set_filelist(ds.my_shard_files(r, world))
            dss.append(ds)

        def load(r):
            try:
                dss[r].load_into_memory(add_keys_fn if r == 0 else None)
            except BaseException as e:   # checked below
                errs.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=load, args=(r,))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t0
        check(not errs and not any(t.is_alive() for t in threads),
              "phase 24's shuffled load failed: %s" % errs)
        return dss, wall, [(sh.bytes_sent, sh.bytes_received) for sh in shs]
    finally:
        for sh in shs:
            sh.close()


def phase24_shuffle(torch, files, feed, fl):
    """The shuffled feed's checks: each rank's merged records, as a
    multiset, the hash partition (block_shuffle_dests) of all the files;
    the load's wall and frame bytes beside an unshuffled load of rank 0's
    files; then rank 0's half trained one pass on a world-1 sharded
    trainer, twice (a fresh load and trainer each time): bit-identical
    digits and store sha256, with its launches."""
    import numpy as np

    from paddlebox_tpu_torch.data import block_shuffle as bs
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import flagship

    world = PHASE24_SHUFFLE_WORLD
    dss, wall, frames = phase24_shuffled_load(feed, files)
    whole = BoxDataset(feed)
    whole.set_filelist(files)
    whole.load_into_memory()
    dests = bs.block_shuffle_dests(whole.block, world)
    for r in range(world):
        want = block_records(whole.block.select(np.flatnonzero(dests == r)))
        check(block_records(dss[r].block) == want,
              "phase 24: rank %d's shuffled records are not its hash "
              "partition of the files" % r)
    plain = BoxDataset(feed)
    plain.set_filelist(files)
    plain.set_filelist(plain.my_shard_files(0, world))
    t0 = time.perf_counter()
    plain.load_into_memory()
    plain_wall = time.perf_counter() - t0
    out = {"load_s": wall, "unshuffled_load_s": plain_wall,
           "frame_bytes": frames,
           "records": [len(d) for d in dss], "unshuffled_records": len(plain),
           "runs": []}
    for i in range(2):
        trainer, _ = flagship.build_sharded_trainer(
            files, feed, flagship.FLAGSHIP, fleet=fl, seed=SHARDED_SEED)
        trainer.seed_fn = main_path_seeds(torch)
        reset_counts()
        trainer.table.begin_feed_pass()
        dss, _, _ = phase24_shuffled_load(feed, files,
                                          add_keys_fn=trainer.table.add_keys)
        trainer.table.end_feed_pass(allgather=fl.all_gather)
        t0 = time.perf_counter()
        res = trainer.train_pass(dss[0], preloaded=True)
        torch.cuda.synchronize()
        auc = trainer.metrics.get_metric_msg(
            "auc", allreduce=fl.metric_allreduce())["auc"]
        out["runs"].append({
            "loss": res["loss"], "auc": auc, "batches": res["batches"],
            "instances": res["instances"],
            "pass_s": time.perf_counter() - t0,
            "launches": counts(),
            "store_sha": shard_store_sha(trainer)})
        trainer.close()
    return out


def phase24_child(torch, files, feed, store):
    """Phase 24 in the child (phase 22's fleet stopped): the table-wise
    run with the pull's kernel at its shape, the 2-D grid's hot run with
    the replicated tier and the fused push over its uid vector, the
    shuffled feed. A record of each and the phase's host seconds."""
    t0 = time.perf_counter()
    out = {"kernels": {}}
    fl = phase24_fleet(store, "table-wise")
    try:
        rec, trainer, ds = phase24_run(
            torch, files, feed, fl, "table-wise",
            dict(PHASE24_TABLES, sharding_policy="table-wise"))
        st = trainer._to_device(trainer.stage_host(
            ds.split_batches(1)[0][0]))
        trainer._wait_ready(st)
        out["kernels"]["gather_rows"] = gather_record(
            torch, trainer.table.resident_slab, st["req"],
            "at the table-wise shard's pull")
        trainer.close()
        out["table_wise"] = rec
    finally:
        fl.stop()
    fl = phase24_fleet(store, "2d-grid")
    try:
        rec, trainer, ds = phase24_run(
            torch, files, feed, fl, "2d-grid hot",
            dict(PHASE24_TABLES, sharding_policy="2d-grid", **PHASE24_HOT),
            stage=dict(h2d_lean=True), passes=2)
        rec["hot_tier"] = phase24_hot_tier(torch, trainer)
        out["kernels"]["push_adagrad"] = phase24_hot_push(torch, trainer, ds)
        trainer.close()
        out["grid_hot"] = rec
    finally:
        fl.stop()
    fl = phase24_fleet(store, "shuffle")
    try:
        out["shuffle"] = phase24_shuffle(torch, files, feed, fl)
    finally:
        fl.stop()
    out["child_s"] = time.perf_counter() - t0
    return out


def phase24_report(res, p22):
    """Phase 24's checks and lines in the parent, against phase 22's run
    ``p22`` (FLAGSHIP_DIGITS, its store sha256 after each pass)."""
    def digits(r, n):
        return {"loss": tuple("%.10f" % p["loss"] for p in r["passes"]),
                "auc": tuple("%.10f" % p["auc"] for p in r["passes"])}, {
                    k: v[:n] for k, v in FLAGSHIP_DIGITS.items()}

    tw = res["table_wise"]
    got, want = digits(tw, 1)
    steps = tw["passes"][0]["batches"]
    launches = {k: tw["launches"][k] for k in ("push_adagrad",
                                               "gather_rows")}
    check(got == want and tw["store_sha"] == p22["store_sha0"]
          and launches == {"push_adagrad": steps, "gather_rows": steps + 1}
          and tw["route_counts"] == {"rt_bucketize_sharded": steps}
          and tw["aggregator"],
          "phase 24 table-wise: digits %s (want %s), store %s (want %s), "
          "launches %s, router %s" % (got, want, tw["store_sha"],
                                      p22["store_sha0"], launches,
                                      tw["route_counts"]))
    log("sharded24 table-wise (%s, world 1): one pass bit-identical to "
        "phase 22's first (digits %s, store sha256 %s); launches %s; "
        "router %s (every batch through rt_bucketize_sharded); aggregator "
        "None; wall %.3f s"
        % (tw["policy"], json.dumps(got), tw["store_sha"],
           json.dumps(tw["launches"]), json.dumps(tw["route_counts"]),
           tw["passes"][0]["pass_s"]))
    gh = res["grid_hot"]
    got, want = digits(gh, 2)
    steps = sum(p["batches"] for p in gh["passes"])
    launches = {k: gh["launches"][k] for k in ("push_adagrad",
                                               "gather_rows")}
    lo, hi = PHASE24_HOT_RANGE
    check(got == want and gh["store_sha"] == p22["store_sha"]
          and launches == {"push_adagrad": steps, "gather_rows": steps + 3}
          and gh["route_counts"] == {"rt_bucketize_sharded": steps}
          and all(lo <= p["hot_frozen"] <= hi and p["hot_readded"]
                  == p["hot_frozen"] * p["batches"] for p in gh["passes"])
          and gh["aggregator"],
          "phase 24 2d-grid hot: digits %s (want %s), store %s (want %s), "
          "launches %s, passes %s" % (got, want, gh["store_sha"],
                                      p22["store_sha"], launches,
                                      gh["passes"]))
    for p in gh["passes"]:
        b = p["batches"]
        log("sharded24 2d-grid hot pass %d (%s, uid wire, world 1): "
            "hot_threshold %d froze %d keys; a step kept %.1f hot ids off "
            "the wire and added %d back (%.1f of them untouched by the "
            "step); loss %.10f auc %.10f; wall %.3f s"
            % (p["pass"], gh["policy"],
               PHASE24_HOT["sharding_hot_threshold"], p["hot_frozen"],
               p["hot_dropped"] / b, p["hot_readded"] // b,
               (p["hot_readded"] - p["hot_dropped"]) / b, p["loss"],
               p["auc"], p["pass_s"]))
    log("sharded24 feed seconds (the load, the sketch's observe on the "
        "reader, end_feed_pass with the sketches' merge and the freeze): "
        "hot tier on %s against off (table-wise) %s"
        % ([p["phase_s"]["feed"] for p in gh["passes"]],
           [p["phase_s"]["feed"] for p in tw["passes"]]))
    log("sharded24 2d-grid hot: two passes bit-identical to phase 22's "
        "(digits %s, store sha256 %s); launches %s; ReplicatedHotTier %s, "
        "lookup = store.lookup bit for bit"
        % (json.dumps(got), gh["store_sha"], json.dumps(gh["launches"]),
           json.dumps(gh["hot_tier"])))
    sh = res["shuffle"]
    a, b = sh["runs"]
    check({k: a[k] for k in ("loss", "auc", "store_sha")}
          == {k: b[k] for k in ("loss", "auc", "store_sha")}
          and a["launches"]["push_adagrad"] == a["batches"]
          and a["launches"]["gather_rows"] == a["batches"] + 1
          and a["launches"] == b["launches"],
          "phase 24 shuffled passes differ: %s" % sh["runs"])
    log("sharded24 shuffled feed (2 TcpShufflers on localhost, block "
        "codec): each rank's records = its hash partition of the 4 files "
        "(%s records); load %.3f s against %.3f s unshuffled (rank 0's %d "
        "records); frame bytes (sent, received) by rank %s"
        % (sh["records"], sh["load_s"], sh["unshuffled_load_s"],
           sh["unshuffled_records"], sh["frame_bytes"]))
    log("sharded24 shuffled pass (rank 0's half, world 1), twice: loss "
        "%.10f auc %.10f, store sha256 %s, bit-identical; %d steps, %d "
        "instances; launches %s; walls %s"
        % (a["loss"], a["auc"], a["store_sha"], a["batches"],
           a["instances"], json.dumps(a["launches"]),
           [a["pass_s"], b["pass_s"]]))
    for name, rec in res["kernels"].items():
        log("sharded24 %s at the shard shape: bit-equal to the plain "
            "version; %s" % (name, json.dumps(rec)))
    log("sharded24 phase seconds in the child: %.3f" % res["child_s"])


# phase 25: the sharded SSD tier, the CPU PS behind the sharded table
# (PSGPUTrainer), the Downpour worker and the sequence trainer over an sp
# group, at world 1 over NCCL in phase 22's child after phase 24, each at
# full width on a fleet of its own
PHASE25_TABLE_ID = 0       # the PS's sparse table of the PS-backed runs
PHASE25_SHARD_NUM = 8      # the PS table's shards (the reference's default)
# Ulysses at one shard against BST_DIGITS (the ring's): its attention is
# softmax-then-matmul and the ring's a block update that divides after the
# matmul, so the floats differ by rounding (3.3e-9 relative on the card);
# the relative limit on each pass's loss and AUC
ULYSSES_RTOL = 1e-7


def phase25_ssd(torch, windows, feed, fl, tmp):
    """(a) FLAGSHIP_SSD through ShardedBoxTrainer over phase 19's three
    windows in sequence, the main path's seeds: each pass's digits, tier
    stats and the store's sha256 (resident and tier rows, sorted), then
    load_ssd_to_mem."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils.stats import stat_get

    cfg = dataclasses.replace(flagship.FLAGSHIP_SSD,
                              ssd_dir=os.path.join(tmp, "ssd_phase25"))
    trainer, _ = flagship.build_sharded_trainer(windows[0], feed, cfg,
                                                fleet=fl, seed=SHARDED_SEED)
    trainer.seed_fn = main_path_seeds(torch)
    store = trainer.table.shard.store
    passes = []
    try:
        reset_counts()
        last = {n: stat_get(n) for n in TIER_STATS}
        for i, files in enumerate(windows):
            ds = BoxDataset(feed)
            ds.set_filelist(files)
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            auc = trainer.metrics.get_metric_msg(
                "auc", allreduce=fl.metric_allreduce())["auc"]
            now = {n: stat_get(n) for n in TIER_STATS}
            passes.append({"pass": i, "loss": res["loss"], "auc": auc,
                           "batches": res["batches"], "pass_s": secs,
                           "stats": {n: now[n] - last[n] for n in TIER_STATS},
                           "union_sha": sha_of(*union_of(store)),
                           "spilled": trainer.table.spilled_count(),
                           "resident": len(store)})
            last = now
        launches = counts()
        spilled = trainer.table.spilled_count()
        k, _ = trainer.table.spilled_snapshot()
        t0 = time.perf_counter()
        loaded = trainer.table.load_ssd_to_mem()
        load_s = time.perf_counter() - t0
        return {"passes": passes, "launches": launches,
                "budget": cfg.table().ssd_max_resident_rows(
                    trainer.layout.width),
                "host_ranks": trainer.table.shard.budget_split,
                "spilled_before_load": spilled,
                "snapshot_keys": int(np.unique(k).size), "loaded": loaded,
                "spilled_after_load": trainer.table.spilled_count(),
                "resident_after_load": len(store), "load_s": load_s}
    finally:
        trainer.close()


def phase25_ps_run(torch, files, feed, fl, client, label, want_rows):
    """(b) One PSGPUTrainer run over ``client``: create_trainer through
    flagship.build_sharded_trainer, two passes with the main path's seeds;
    then the server's rows of the pass keys against phase 22's store
    (``want_rows``: its sorted keys and rows), the first difference kept."""
    import numpy as np

    from paddlebox_tpu_torch.embedding.ps_store import PSBackedStore
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils.stats import stat_get

    client.create_sparse_table(PHASE25_TABLE_ID, flagship.FLAGSHIP.table(),
                               shard_num=PHASE25_SHARD_NUM, seed=0)
    trainer, ds = flagship.build_sharded_trainer(
        files, feed, flagship.FLAGSHIP, fleet=fl, seed=SHARDED_SEED,
        ps_client=client, ps_table_id=PHASE25_TABLE_ID)
    trainer.seed_fn = main_path_seeds(torch)
    store = trainer.table.shard.store
    check(isinstance(store, PSBackedStore) and store.primary,
          "phase 25 %s: the shard's store %r" % (label, store))
    stats = ("ps_build_keys_pulled", "ps_build_keys_dumped")
    try:
        reset_counts()
        base = {n: stat_get(n) for n in stats}
        passes = []
        for i in range(2):
            before = dict(trainer.table.counters)
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            auc = trainer.metrics.get_metric_msg(
                "auc", allreduce=fl.metric_allreduce())["auc"]
            passes.append({"pass": i, "loss": res["loss"], "auc": auc,
                           "batches": res["batches"],
                           "pass_s": time.perf_counter() - t0,
                           "counters": counter_delta(before, trainer.table)})
        launches = counts()
        keys = np.sort(trainer.table.shard_keys(0))
        t0 = time.perf_counter()
        rows = client.pull_sparse(PHASE25_TABLE_ID, keys, create=False)
        fetch_s = time.perf_counter() - t0
        rec = {"label": label, "passes": passes, "launches": launches,
               "server_sha": sha_of(keys, rows), "keys": int(keys.size),
               "server_rows": int(client.sparse_size(PHASE25_TABLE_ID)),
               "fetch_s": fetch_s,
               "stats": {n: stat_get(n) - base[n] for n in stats},
               "prefetch": trainer.table.promote_prefetch_ctx() is None}
        wk, wv = want_rows
        if keys.size != wk.size or not np.array_equal(keys, wk):
            rec["first_diff"] = "the key sets differ: %d against %d keys" % (
                keys.size, wk.size)
        else:
            diff = np.argwhere(rows.view(np.uint32) != wv.view(np.uint32))
            if diff.size:
                i, c = diff[0]
                rec["first_diff"] = ("key %d column %d: %r against %r"
                                     % (keys[i], c, rows[i, c], wv[i, c]))
        return rec, trainer
    except BaseException:
        trainer.close()
        raise


def phase25_downpour_run(torch, files, feed, kernel=False):
    """(c) DownpourTrainer at FLAGSHIP's table, batch and model, sync_comm,
    two passes over a PsLocalClient: each pass's digits and wall, the
    launches, and a sha256 of the server's sparse rows (every key of the
    files) and dense vector; with ``kernel`` (e) gather_rows at its
    per-batch slab's shape, held to its plain version and timed."""
    import hashlib

    import numpy as np

    from paddlebox_tpu_torch.config.configs import TrainerConfig
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.ps import PsLocalClient
    from paddlebox_tpu_torch.ps.worker import DownpourTrainer
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP
    client = PsLocalClient()
    trainer = DownpourTrainer(
        flagship.build_model(cfg, SHARDED_SEED), cfg.table(), feed, client,
        TrainerConfig(dense_lr=flagship.DENSE_LR), seed=SHARDED_SEED,
        sync_comm=True, device="cuda")
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    try:
        reset_counts()
        passes = []
        for i in range(2):
            ds = BoxDataset(feed)
            ds.set_filelist(files)
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            passes.append({"pass": i, "loss": res["loss"],
                           "auc": trainer.metrics.get_metric_msg("auc")[
                               "auc"],
                           "batches": res["batches"],
                           "pass_s": time.perf_counter() - t0})
        launches = counts()
        keys = np.unique(ds.all_keys())
        rows = client.pull_sparse(trainer.SPARSE_TABLE, keys, create=False)
        dense = client.pull_dense(trainer.DENSE_TABLE)
        rec = {"passes": passes, "launches": launches,
               "sha": hashlib.sha256(keys.tobytes() + rows.tobytes()
                                     + dense.tobytes()).hexdigest(),
               "keys": int(keys.size), "dense": int(dense.size)}
        if kernel:
            b = ds.split_batches(1)[0][0]
            slab, batch = trainer._prepare_batch(b)
            rec["kernel"] = gather_record(torch, slab, batch["ids"],
                                          "at Downpour's per-batch slab")
        return rec
    finally:
        trainer.close()


def phase25_seq_run(torch, bst_files, bst_feed, attn, group):
    """(d) FLAGSHIP_BST through SeqCtrTrainer with ``attn``, over the sp
    process group ``group`` (None: one shard, no group): two passes."""
    from paddlebox_tpu_torch.train import flagship

    trainer, ds = flagship.build_seq_trainer(
        bst_files, bst_feed, flagship.FLAGSHIP_BST, "cuda", group=group,
        attn=attn)
    reset_counts()
    passes = main_passes(torch, trainer, ds)
    return {"attn": attn, "group": group is not None, "P": trainer.P,
            "passes": passes, "launches": counts()}


def phase25_child(torch, files, feed, windows, bst_files, bst_feed, store,
                  tmp, want_rows):
    """Phase 25 in the child, each part on a world-1 NCCL fleet of its own
    over the child's TCPStore: the sharded SSD tier, the PS-backed runs
    (local client, then TCP to a PSServer on this process's threads), the
    Downpour runs and the sequence runs. Its records and host seconds."""
    from paddlebox_tpu_torch.ps import PSServer, PsLocalClient, TcpPSClient

    t0 = time.perf_counter()
    out = {}
    fl = phase24_fleet(store, "phase25-ssd")
    try:
        out["ssd"] = phase25_ssd(torch, windows, feed, fl, tmp)
    finally:
        fl.stop()
    out["ps"] = []
    for label in ("local", "tcp"):
        fl = phase24_fleet(store, "phase25-ps-" + label)
        server = client = trainer = None
        try:
            if label == "local":
                client = PsLocalClient()
            else:
                server = PSServer()
                client = TcpPSClient("127.0.0.1", server.port)
            rec, trainer = phase25_ps_run(torch, files, feed, fl, client,
                                          label, want_rows)
            if label == "local":
                try:
                    trainer.table.store_view()
                except TypeError as e:
                    rec["store_view"] = str(e)
            out["ps"].append(rec)
        finally:
            if trainer is not None:
                trainer.close()
            if server is not None:
                client.close()
                server.stop()
            fl.stop()
    out["downpour"] = [phase25_downpour_run(torch, files, feed, kernel=i == 0)
                       for i in range(2)]
    fl = phase24_fleet(store, "phase25-seq")
    try:
        out["seq"] = [phase25_seq_run(torch, bst_files, bst_feed, attn,
                                      fl.mesh.group)
                      for attn in ("ring", "ulysses")]
        out["seq"].append(phase25_seq_run(torch, bst_files, bst_feed,
                                          "ulysses", None))
    finally:
        fl.stop()
    out["child_s"] = time.perf_counter() - t0
    return out


def phase25_report(res, p22, tier):
    """Phase 25's checks and lines in the parent, against phase 22's run
    ``p22`` (FLAGSHIP_DIGITS and its store sha256), phase 19's FLAGSHIP_SSD
    sequential run in ``tier`` and phase 17's BST_DIGITS."""
    def digits(passes):
        return {"loss": tuple("%.10f" % p["loss"] for p in passes),
                "auc": tuple("%.10f" % p["auc"] for p in passes)}

    def launched(counts):
        return json.dumps({k: v for k, v in counts.items() if v})

    # (a) the sharded SSD tier = phase 19's single-GPU FLAGSHIP_SSD run
    ssd = res["ssd"]
    ref = next(r for r in tier["runs"] if r["mode"] == "b")
    for p, q in zip(ssd["passes"], ref["passes"]):
        moved = {n: p["stats"][n] for n in ("sparse_keys_spilled",
                                            "sparse_keys_faulted_in")}
        want = {n: q["stats"][n] for n in moved}
        check((p["loss"], p["auc"]) == (q["loss"], q["auc"])
              and p["union_sha"] == q["union_sha"] and moved == want,
              "phase 25 sharded SSD pass %d: %s against phase 19's %s"
              % (p["pass"], json.dumps(p), json.dumps(
                  {k: q[k] for k in ("loss", "auc", "union_sha", "stats")})))
        log("sharded25 ssd pass %d (FLAGSHIP_SSD, world 1): loss %.10f auc "
            "%.10f = phase 19's; store (resident and tier) sha256 %s = phase "
            "19's; spilled %d, faulted in %d = phase 19's; the tier holds %d "
            "rows, %d resident; wall %.3f s (phase 19's %.3f)"
            % (p["pass"], p["loss"], p["auc"], p["union_sha"],
               moved["sparse_keys_spilled"], moved["sparse_keys_faulted_in"],
               p["spilled"], p["resident"], p["pass_s"], q["wall_s"]))
    steps = sum(p["batches"] for p in ssd["passes"])
    check(ssd["launches"]["push_adagrad"] == steps
          and ssd["launches"] == ref["launches"]
          and ssd["host_ranks"] == 1
          and ssd["loaded"] == ssd["spilled_before_load"]
          == ssd["snapshot_keys"] > 0 and ssd["spilled_after_load"] == 0,
          "phase 25 sharded SSD: launches %s (phase 19's %s), load %s"
          % (ssd["launches"], ref["launches"],
             {k: ssd[k] for k in ("loaded", "spilled_before_load",
                                  "spilled_after_load")}))
    log("sharded25 ssd: launches %s = phase 19's; budget %d rows over %d "
        "rank on the host; load_ssd_to_mem moved %d rows back in %.3f s "
        "(the tier then empty, %d resident)"
        % (launched(ssd["launches"]), ssd["budget"], ssd["host_ranks"],
           ssd["loaded"], ssd["load_s"], ssd["resident_after_load"]))

    # (b) the PS-backed runs = phase 22's run and each other
    local, tcp = res["ps"]
    for r in res["ps"]:
        got = digits(r["passes"])
        steps = sum(p["batches"] for p in r["passes"])
        check(got == FLAGSHIP_DIGITS and r["launches"]["push_adagrad"] == steps
              and r["launches"]["gather_rows"] >= steps + 2
              and r["prefetch"],
              "phase 25 PS-backed (%s): digits %s (want %s), launches %s"
              % (r["label"], got, FLAGSHIP_DIGITS, r["launches"]))
        check(r["server_sha"] == p22["store_sha"] and "first_diff" not in r,
              "phase 25 PS-backed (%s): the server's rows sha256 %s, phase "
              "22's store %s; first difference: %s"
              % (r["label"], r["server_sha"], p22["store_sha"],
                 r.get("first_diff")))
        log("sharded25 ps %s (PSGPUTrainer, world 1): digits %s = phase "
            "22's; the server's rows of the %d pass keys sha256 %s = phase "
            "22's store; launches %s (%d steps: a pull a step, the promote "
            "and write-backs by the counters %s); PS keys pulled and "
            "dumped %s; server rows %d; pass walls %s; the rows' fetch "
            "%.3f s"
            % (r["label"], json.dumps(got), r["keys"], r["server_sha"],
               launched(r["launches"]), steps,
               [p["counters"] for p in r["passes"]], json.dumps(r["stats"]),
               r["server_rows"], [p["pass_s"] for p in r["passes"]],
               r["fetch_s"]))
    check([(p["loss"], p["auc"]) for p in local["passes"]]
          == [(p["loss"], p["auc"]) for p in tcp["passes"]]
          and local["server_sha"] == tcp["server_sha"]
          and local["launches"] == tcp["launches"],
          "phase 25: the local and TCP PS runs differ")
    check("PS-backed shards checkpoint server-side" in local.get(
        "store_view", ""), "phase 25: store_view over a PS-backed shard "
          "gave %r" % local.get("store_view"))
    log("sharded25 ps: the local and TCP runs bit-identical; store_view "
        "refused: %s" % local["store_view"])

    # (c) Downpour: deterministic twice, and learning
    a, b = res["downpour"]
    check([(p["loss"], p["auc"]) for p in a["passes"]]
          == [(p["loss"], p["auc"]) for p in b["passes"]]
          and a["sha"] == b["sha"] and a["launches"] == b["launches"]
          and a["passes"][1]["loss"] < a["passes"][0]["loss"]
          and a["launches"]["gather_rows"] == sum(
              p["batches"] for p in a["passes"])
          and a["launches"]["push_adagrad"] == 0,
          "phase 25 Downpour runs: %s" % json.dumps(
              [{k: r[k] for k in ("passes", "launches", "sha")}
               for r in (a, b)]))
    for r in (a, b):
        log("sharded25 downpour run (FLAGSHIP table, batch and model, "
            "sync_comm, PsLocalClient): digits %s; server sha256 %s (%d "
            "keys, %d dense values); launches %s; pass walls %s"
            % (json.dumps(digits(r["passes"])), r["sha"], r["keys"],
               r["dense"], launched(r["launches"]),
               [p["pass_s"] for p in r["passes"]]))
    log("sharded25 downpour: the two runs bit-identical; the loss fell "
        "%.10f -> %.10f" % (a["passes"][0]["loss"], a["passes"][1]["loss"]))
    log("sharded25 gather_rows at Downpour's per-batch slab: bit-equal to "
        "the plain version and index_select; %s" % json.dumps(a["kernel"]))

    # (d) the sequence trainer over an sp group of one
    ring, uly, uly_alone = res["seq"]
    for r in res["seq"]:
        steps = sum(p["batches"] for p in r["passes"])
        extra = sum(gather_launches_of(p["counters"]) for p in r["passes"])
        check(r["P"] == 1 and r["launches"] == f32_launches(
            push_adagrad=steps, gather_rows=2 * steps + extra),
              "phase 25 seq (%s, group %s): P %d, launches %s"
              % (r["attn"], r["group"], r["P"], r["launches"]))
    got = digits(ring["passes"])
    check(got == BST_DIGITS, "phase 25 seq ring over the sp group: digits "
          "%s, phase 17's %s" % (got, BST_DIGITS))
    want = [float(x) for n in ("loss", "auc") for x in BST_DIGITS[n]]
    gaps = [abs(g / w - 1.0) for g, w in zip(
        [p[n] for n in ("loss", "auc") for p in uly["passes"]], want)]
    check(max(gaps) <= ULYSSES_RTOL,
          "phase 25 seq ulysses: digits %s, BST_DIGITS %s: relative gaps "
          "%s over %g" % (digits(uly["passes"]), BST_DIGITS, gaps,
                          ULYSSES_RTOL))
    check(digits(uly["passes"]) == digits(uly_alone["passes"]),
          "phase 25 seq ulysses: over the sp group %s, alone %s"
          % (digits(uly["passes"]), digits(uly_alone["passes"])))
    log("sharded25 seq ring (FLAGSHIP_BST, an sp group of one over NCCL): "
        "digits %s = phase 17's BST_DIGITS; launches %s; pass walls %s"
        % (json.dumps(got), launched(ring["launches"]),
           [p["pass_s"] for p in ring["passes"]]))
    log("sharded25 seq ulysses over the sp group: digits %s = the one-shard "
        "Ulysses run's (no group) bit for bit; against BST_DIGITS' loss and "
        "AUC relative gaps %s (limit %g); launches %s; pass walls %s"
        % (json.dumps(digits(uly["passes"])), gaps, ULYSSES_RTOL,
           launched(uly["launches"]),
           [p["pass_s"] for p in uly["passes"]]))
    log("sharded25 phase seconds in the child: %.3f" % res["child_s"])


# phase 26: the stream over the sharded trainer, the model-parallel towers
# (MeshTowerTrainer over TpDeepFM and EpMMoE) and heter offload, at world 1
# over NCCL in phase 22's child after phase 25, on a fleet of its own
# the towers at the JAX package's default widths (models/wide_tower.py)
TOWER_WIDTHS = {"tp_deepfm": dict(d_wide=4096, d_mid=128),
                "ep_mmoe": dict(n_experts=8, d_hidden=64, d_out=32)}
# the card's first tower pass against the same trainer's on the CPU (the
# plain versions): relative on the loss, absolute on the AUC
TOWER_LOSS_RTOL = 1e-4
TOWER_AUC_ATOL = 1e-3
# heter with its service on the card against its service on the CPU: the
# first pass's loss, relative (as the towers' first pass). The second pass
# is printed, not held: the CPU's float32 matmuls round otherwise than the
# card's, and heter's loop carries that into its later steps (2.3e-3 apart
# after two passes on an H100, PERF.md section 6)
HETER_LOSS_RTOL = 1e-4


def phase26_stream(torch, files, feed, fl, tmp):
    """(a) Phase 20's stream (its eight files and poisoned window, its
    window, base cadence and journal) through StreamingRunner over
    ShardedBoxTrainer on the world-1 fleet, the main path's seeds: the
    windows' sequence, each admitted micro-pass's digits and wall, the
    store's and slab's sha256 at every boundary (before its save), the
    launches."""
    from paddlebox_tpu_torch.config.flags import StreamFlags
    from paddlebox_tpu_torch.data.streaming import StreamingDataset
    from paddlebox_tpu_torch.train import StreamingRunner, flagship

    root = os.path.join(tmp, "stream26")
    watch = os.path.join(root, "watch")
    write_stream(files, feed, watch)
    trainer, _ = flagship.build_sharded_trainer([], feed, flagship.FLAGSHIP,
                                                fleet=fl, seed=SHARDED_SEED)
    trainer.seed_fn = main_path_seeds(torch)
    sf = StreamFlags(streaming_poll_secs=0.02)
    runner = StreamingRunner(
        trainer, StreamingDataset(feed, watch, ledger_dir=root,
                                  micro_pass_instances=STREAM_WINDOW,
                                  flags=sf),
        cm=stream_cm(trainer, root), base_every=STREAM_BASE_EVERY, flags=sf)
    bounds, passes = [], []
    inner_pass, inner_boundary = trainer.train_pass, runner._boundary

    def train_pass(ds, preloaded=False):
        t0 = time.perf_counter()
        res = inner_pass(ds, preloaded=preloaded)
        torch.cuda.synchronize()
        passes.append({"loss": res["loss"],
                       "auc": trainer.metrics.get_metric_msg("auc")["auc"],
                       "batches": res["batches"],
                       "pass_s": time.perf_counter() - t0})
        return res

    def boundary(win, admitted):
        bounds.append({"window": win.index, "admitted": admitted,
                       "store": shard_store_sha(trainer),
                       "slab": slab_sha_or_none(trainer.table)})
        inner_boundary(win, admitted)

    trainer.train_pass, runner._boundary = train_pass, boundary
    try:
        reset_counts()
        run = runner.run(idle_timeout=0.5)
        launches = counts()
    finally:
        del trainer.train_pass
        trainer.close()
    return {"sequence": [(p["window"], p["admitted"], p["instances"])
                         for p in run["passes"]],
            "passes": passes, "bounds": bounds, "launches": launches,
            "wall_s": run["wall_secs"]}


def phase26_tower(torch, files, feed, name, group, device="cuda", passes=2,
                  push="scatter"):
    """(b) create_trainer("MeshTowerTrainer") with the zoo's ``name`` at
    TOWER_WIDTHS over the mp group ``group`` (None: one process alone), at
    FLAGSHIP's table, feed and batch, on ``device`` with the write
    ``push``: ``passes`` passes over the main path's files, each pass's
    digits, wall, phases, table counters and the store's sha256 (and of
    its keys with the show and click columns). Returns (the record, the
    trainer)."""
    import hashlib

    import numpy as np

    from paddlebox_tpu_torch.config.configs import TrainerConfig
    from paddlebox_tpu_torch.config.flags import PushFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.models import MODEL_ZOO
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.factory import create_trainer

    cfg = flagship.FLAGSHIP
    model = MODEL_ZOO[name](ModelSpec(cfg.num_slots, 3 + cfg.embedx),
                            n_shards=1, **TOWER_WIDTHS[name])
    trainer = create_trainer(
        "MeshTowerTrainer", model, cfg.table(), feed,
        TrainerConfig(dense_lr=flagship.DENSE_LR), group=group,
        seed=SHARDED_SEED, device=device,
        push_flags=PushFlags(push, flagship.BLOCK_ROWS))
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 20)
    check(trainer.push_write == push and trainer.P == 1
          and str(trainer.device).startswith(device),
          "phase 26 tower %s: write %s, P %d, device %s"
          % (name, trainer.push_write, trainer.P, trainer.device))
    reset_counts()
    out = []
    for i in range(passes):
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        before = dict(trainer.table.counters)
        t0 = time.perf_counter()
        res = trainer.train_pass(ds)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k, v = sorted_store(trainer.table)
        out.append({"pass": i, "loss": res["loss"],
                    "auc": trainer.metrics.get_metric_msg("auc")["auc"],
                    "batches": res["batches"], "pass_s": secs,
                    "phase_s": trainer.pass_times,
                    "counters": counter_delta(before, trainer.table),
                    "store_sha": sha_of(k, v),
                    "show_click_sha": hashlib.sha256(
                        k.tobytes() + np.ascontiguousarray(
                            v[:, [acc.SHOW, acc.CLICK]]).tobytes()
                    ).hexdigest()})
    return ({"name": name, "device": device, "push": push, "passes": out,
             "launches": counts()}, trainer)


def phase26_tower_kernels(torch, trainer, files, feed):
    """(d) gather_rows and the fused push_adagrad at a tower batch (the
    first of a fresh pass of ``trainer``'s table over ``files``): the pull
    of its ids and the push of its step's rows (the tower's forward and
    backward, nothing applied), each bit-equal to its plain version (both
    push writes); the shapes."""
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.ops.sparse import build_push_grads
    from paddlebox_tpu_torch.push_probe import SEED
    from paddlebox_tpu_torch.train.trainer import masked_bce

    table = trainer.table
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=table.add_keys)
    table.end_feed_pass()
    table.begin_pass()
    try:
        batch = trainer.device_batch(ds.split_batches(1)[0][0])
        slab, ids = table.slab, batch["ids"]
        got = rk.gather_rows(slab, ids)
        torch.cuda.synchronize()
        want = rk.gather_rows_plain(slab, ids)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32))
              and torch.equal(got, slab.index_select(0, ids.long())),
              "gather_rows at the tower batch differs from the plain "
              "version")
        err = float((got - want).abs().max())
        del got, want
        emb, pooled = trainer._pooled(slab, batch, True)
        loss, _ = masked_bce(trainer.model.apply_local(
            trainer.tensors, pooled, trainer.group), batch["labels"],
            batch["ins_valid"])
        loss.backward()
        trainer.dense_opt.zero_grad(set_to_none=True)
        S = trainer.num_slots
        seg = batch["segments"]
        g = build_push_grads(emb.grad, seg % S,
                             batch["labels"].index_select(0, seg // S),
                             ids != table.padding_id)
        u, p, o, n_uniq = (batch["uids"], batch["perm"], batch["offsets"],
                           batch["n_uniq"])
        conf, layout = table.config.optimizer, trainer.layout
        for rows_out in (False, True):
            s_k, s_p = slab.clone(), slab.clone()
            r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout,
                                  conf, rows_out)
            torch.cuda.synchronize()
            r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                              layout, conf, rows_out)
            check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                  and (not rows_out or torch.equal(r_k.view(torch.int32),
                                                   r_p.view(torch.int32))),
                  "push_adagrad (rows_out=%s) at the tower batch differs "
                  "from the plain version" % rows_out)
            err = max(err, float((s_k - s_p).abs().max()))
            del s_k, s_p, r_k, r_p
        return {"slab": list(slab.shape), "ids": int(ids.numel()),
                "push_rows": list(g.shape), "n_uniq": int(n_uniq),
                "occurrences": int(batch["n_valid"]), "max_abs_err": err}
    finally:
        table.end_pass()


def phase26_heter(torch, files, feed, device):
    """(c) A HeterDenseService on ``device`` (its FramedServer's threads in
    this process, loopback TCP on an ephemeral port) with FLAGSHIP's
    DeepFM, driven by a HeterTrainer over a PsLocalClient at FLAGSHIP's
    table, feed and batch with sync_comm, two passes: each pass's digits
    and wall, the launches, a sha256 of the server's rows of every key of
    the files and of the service's dense parameters."""
    import hashlib

    import numpy as np

    from paddlebox_tpu_torch.convert import flatten_params
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.fleet.heter import (HeterDenseClient,
                                                 HeterDenseService,
                                                 HeterTrainer)
    from paddlebox_tpu_torch.ps import PsLocalClient
    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP
    service = HeterDenseService(flagship.build_model(cfg, SHARDED_SEED), feed,
                                dense_lr=flagship.DENSE_LR, device=device)
    heter = worker = None
    try:
        heter = HeterDenseClient("127.0.0.1", service.port)
        client = PsLocalClient()
        worker = HeterTrainer(client, heter, cfg.table(), feed,
                              seed=SHARDED_SEED, sync_comm=True)
        worker.metrics.init_metric("auc", "label", "pred",
                                   table_size=1 << 20)
        reset_counts()
        passes = []
        for i in range(2):
            ds = BoxDataset(feed)
            ds.set_filelist(files)
            t0 = time.perf_counter()
            res = worker.train_pass(ds)
            passes.append({"pass": i, "loss": res["loss"],
                           "auc": worker.metrics.get_metric_msg("auc")[
                               "auc"],
                           "batches": res["batches"],
                           "pass_s": time.perf_counter() - t0})
        launches = counts()
        keys = np.unique(ds.all_keys())
        rows = client.pull_sparse(worker.SPARSE_TABLE, keys, create=False)
        return {"device": device, "passes": passes, "launches": launches,
                "keys": int(keys.size),
                "rows_sha": hashlib.sha256(keys.tobytes()
                                           + rows.tobytes()).hexdigest(),
                "dense_sha": hashlib.sha256(
                    flatten_params(service.model).tobytes()).hexdigest()}
    finally:
        if worker is not None:
            worker.close()
        if heter is not None:
            heter.close()
        service.stop()


def phase26_child(torch, files, feed, windows, store, tmp):
    """Phase 26 in the child, on a world-1 NCCL fleet of its own over the
    child's TCPStore: the stream over the shard, each tower twice on the
    card (the first run's trainer then holds the kernels at a tower batch)
    and its first pass on the CPU, TpDeepFM's blocked and rebuild passes;
    then heter twice with its service on the card and once on the CPU. Its
    records and host seconds."""
    t0 = time.perf_counter()
    out = {"towers": {}, "writes": {}}
    fl = phase24_fleet(store, "phase26")
    try:
        out["stream"] = phase26_stream(torch, windows[0] + windows[2], feed,
                                       fl, tmp)
        group = fl.mesh.group
        for name in TOWER_WIDTHS:
            runs = []
            for i in range(2):
                rec, trainer = phase26_tower(torch, files, feed, name, group)
                if name == "tp_deepfm" and i == 0:
                    out["kernels"] = phase26_tower_kernels(torch, trainer,
                                                           files, feed)
                del trainer
                runs.append(rec)
            cpu, _ = phase26_tower(torch, files, feed, name, None,
                                   device="cpu", passes=1)
            out["towers"][name] = {"runs": runs, "cpu": cpu}
        for push in ("blocked", "rebuild"):
            out["writes"][push], _ = phase26_tower(
                torch, files, feed, "tp_deepfm", group, passes=1, push=push)
    finally:
        fl.stop()
    out["heter"] = [phase26_heter(torch, files, feed, "cuda")
                    for _ in range(2)]
    out["heter"].append(phase26_heter(torch, files, feed, "cpu"))
    out["child_s"] = time.perf_counter() - t0
    return out


def phase26_report(res, main, p20):
    """Phase 26's checks and lines in the parent, against phase 20's stream
    ``p20`` and phase 5's passes ``main``."""
    def launched(c):
        return json.dumps({k: v for k, v in c.items() if v})

    def digits(passes):
        return [(p["loss"], p["auc"]) for p in passes]

    # (a) the stream over the shard = phase 20's stream over BoxTrainer
    st = res["stream"]
    check(st["sequence"] == [tuple(s) for s in p20["sequence"]]
          and digits(st["passes"]) == digits(p20["passes"])
          and st["bounds"] == p20["bounds"]
          and st["launches"] == p20["launches"],
          "phase 26 stream over the shard: windows %s, digits %s, "
          "boundaries %s, launches %s; phase 20's %s, %s, %s, %s"
          % (st["sequence"], digits(st["passes"]), st["bounds"],
             st["launches"], p20["sequence"], digits(p20["passes"]),
             p20["bounds"], p20["launches"]))
    for p, q, b in zip(st["passes"], p20["passes"],
                       [b for b in st["bounds"] if b["admitted"]]):
        log("sharded26 stream micro-pass (ShardedBoxTrainer, world 1): loss "
            "%.10f auc %.10f = phase 20's; store sha256 %s = phase 20's; "
            "wall %.4f s (phase 20's %.4f)"
            % (p["loss"], p["auc"], b["store"], p["pass_s"], q["pass_s"]))
    log("sharded26 stream: windows %s = phase 20's (the poisoned one "
        "refused, its boundary's store and slab those before it); "
        "launches %s = phase 20's; run wall %.3f s"
        % (st["sequence"], launched(st["launches"]), st["wall_s"]))

    # (b) the towers
    for name, t in res["towers"].items():
        a, b = t["runs"]
        check(digits(a["passes"]) == digits(b["passes"])
              and [p["store_sha"] for p in a["passes"]]
              == [p["store_sha"] for p in b["passes"]]
              and a["launches"] == b["launches"],
              "phase 26 tower %s: two runs differ: %s / %s" % (
                  name, digits(a["passes"]), digits(b["passes"])))
        check(a["passes"][1]["loss"] < a["passes"][0]["loss"],
              "phase 26 tower %s did not learn: %s" % (name,
                                                       digits(a["passes"])))
        steps = sum(p["batches"] for p in a["passes"])
        extra = sum(gather_launches_of(p["counters"]) for p in a["passes"])
        check(a["launches"] == f32_launches(push_adagrad=steps,
                                            gather_rows=steps + extra),
              "phase 26 tower %s launches %s over %d steps, %d promotes and "
              "write-backs" % (name, a["launches"], steps, extra))
        c, g = t["cpu"]["passes"][0], a["passes"][0]
        rel = abs(g["loss"] / c["loss"] - 1.0)
        dauc = abs(g["auc"] - c["auc"])
        check(rel <= TOWER_LOSS_RTOL and dauc <= TOWER_AUC_ATOL
              and g["show_click_sha"] == c["show_click_sha"],
              "phase 26 tower %s against its CPU run: loss %r / %r (rel "
              "%g), AUC %r / %r; show and click %s" % (
                  name, g["loss"], c["loss"], rel, g["auc"], c["auc"],
                  g["show_click_sha"] == c["show_click_sha"]))
        for p in a["passes"]:
            log("tower26 %s pass %d (MeshTowerTrainer, an mp group of one "
                "over NCCL): loss %.10f auc %.10f, store sha256 %s, twice; "
                "wall %.4f s (phase 5's %.4f) phases %s"
                % (name, p["pass"], p["loss"], p["auc"], p["store_sha"],
                   p["pass_s"], main[p["pass"]]["pass_s"],
                   json.dumps(p["phase_s"])))
        log("tower26 %s: launches %s over %d steps: a pull (gather_rows) "
            "and a fused push a step, and %d gather_rows at the delta "
            "promote and the write-backs by the table's counters; the "
            "card's first pass against the CPU's: loss rel %g (limit %g), "
            "|dAUC| %g (limit %g), show and click equal; the CPU pass "
            "%.3f s" % (name, launched(a["launches"]), steps, extra, rel,
                        TOWER_LOSS_RTOL, dauc, TOWER_AUC_ATOL,
                        c["pass_s"]))
    scatter = res["towers"]["tp_deepfm"]["runs"][0]["passes"][0]
    for push, w in res["writes"].items():
        p = w["passes"][0]
        steps = p["batches"]
        extra = gather_launches_of(p["counters"])
        want = (f32_launches(push_adagrad=steps, blocked_write=steps,
                             gather_rows=steps + extra) if push == "blocked"
                else f32_launches(push_adagrad=steps,
                                  gather_rows=2 * steps + extra))
        check((p["loss"], p["auc"], p["store_sha"])
              == (scatter["loss"], scatter["auc"], scatter["store_sha"])
              and w["launches"] == want,
              "phase 26 tp_deepfm %s pass: %s, launches %s; scatter's %s, "
              "launches wanted %s" % (push, json.dumps(p),
                                      w["launches"], json.dumps(scatter),
                                      want))
        log("tower26 tp_deepfm push_write=%s: loss %.10f auc %.10f and "
            "store sha256 %s = the scatter pass's; launches %s; wall %.4f s "
            "(scatter's %.4f)" % (push, p["loss"], p["auc"], p["store_sha"],
                                  launched(w["launches"]), p["pass_s"],
                                  scatter["pass_s"]))

    # (c) heter
    a, b, cpu = res["heter"]
    check(digits(a["passes"]) == digits(b["passes"])
          and (a["rows_sha"], a["dense_sha"]) == (b["rows_sha"],
                                                  b["dense_sha"]),
          "phase 26 heter: two runs differ: %s / %s" % (
              json.dumps(a), json.dumps(b)))
    check(a["passes"][1]["loss"] < a["passes"][0]["loss"],
          "phase 26 heter did not learn: %s" % digits(a["passes"]))
    rels = [abs(p["loss"] / q["loss"] - 1.0)
            for p, q in zip(a["passes"], cpu["passes"])]
    check(rels[0] <= HETER_LOSS_RTOL,
          "phase 26 heter against its CPU service: losses %s / %s" % (
              digits(a["passes"]), digits(cpu["passes"])))
    for r in res["heter"]:
        log("heter26 service on %s (HeterDenseService on loopback TCP, a "
            "HeterTrainer over a PsLocalClient, FLAGSHIP's DeepFM): digits "
            "%s; server rows sha256 %s (%d keys); dense sha256 %s; "
            "launches %s; pass walls %s" % (
                r["device"], json.dumps(digits(r["passes"])), r["rows_sha"],
                r["keys"], r["dense_sha"], launched(r["launches"]),
                [p["pass_s"] for p in r["passes"]]))
    log("heter26: the two card runs bit-identical, the loss fell %.10f -> "
        "%.10f, the CPU service's losses %s relative apart (the first "
        "pass's limit %g); "
        "no kernel launches: the PS rule is numpy and the view is built "
        "on the host" % (a["passes"][0]["loss"], a["passes"][1]["loss"],
                         rels, HETER_LOSS_RTOL))

    # (d) the kernels at the tower batch
    k = res["kernels"]
    same = k["slab"] == [1 << 20, 17] and k["ids"] == 131072
    check(k["max_abs_err"] == 0.0 and same,
          "phase 26 kernels at the tower batch: %s" % json.dumps(k))
    log("tower26 kernels: gather_rows and push_adagrad (both writes) at a "
        "tower batch bit-equal to their plain versions, %s: slab %s, %d "
        "ids: the main path's shapes, so no new row"
        % (json.dumps(k), k["slab"], k["ids"]))
    log("sharded26 phase seconds in the child: %.3f" % res["child_s"])


# phase 27: pipeline parallelism over a stage process group at one stage
# (CtrPipelineRunner at FLAGSHIP_PIPE through create_trainer, its (dp,
# stage) form through make_mesh, the expand-64 table, GPipeRunner), on a
# world-1 NCCL fleet of its own in phase 22's child after phase 26
# the card's first CtrPipelineRunner pass against the same runner's on the
# CPU (the plain versions): relative on the loss, absolute on the AUC
PIPE_LOSS_RTOL = 1e-4
PIPE_AUC_ATOL = 1e-3
GPIPE_STEPS = 50             # GPipeRunner's steps, which lower its loss


def phase27_ctr(torch, files, feed, cfg, device="cuda", mesh=None,
                passes=2):
    """(a)-(c) create_trainer("CtrPipelineTrainer") at the pipeline
    configuration ``cfg`` (flagship.build_pipeline_trainer) on ``device``,
    its stages the world's (one stage: LOCAL) or ``mesh``'s: ``passes``
    passes over the main path's files, each pass's digits, steps, wall,
    table counters and the store's sha256 (and of its keys with the show
    and click columns). Returns (the record, the runner)."""
    import hashlib

    import numpy as np

    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.train import flagship

    runner, _ = flagship.build_pipeline_trainer(
        files, feed, cfg, device=None if mesh is not None else device,
        seed=SHARDED_SEED, mesh=mesh)
    check(runner.stage.size == 1 and runner.dp == 1
          and runner.device.type == device
          and runner.batches_per_step == cfg.n_micro,
          "phase 27 pipeline: %d stages, dp %d, device %s"
          % (runner.stage.size, runner.dp, runner.device))
    reset_counts()
    out = []
    for i in range(passes):
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        before = dict(runner.table.counters)
        t0 = time.perf_counter()
        res = runner.train_pass(ds)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k, v = sorted_store(runner.table)
        out.append({"pass": i, "loss": res["loss"],
                    "auc": runner.metrics.get_metric_msg("auc")["auc"],
                    "steps": res["steps"],
                    "dropped": res["dropped_batches"], "pass_s": secs,
                    "counters": counter_delta(before, runner.table),
                    "store_sha": sha_of(k, v),
                    "show_click_sha": hashlib.sha256(
                        k.tobytes() + np.ascontiguousarray(
                            v[:, [acc.SHOW, acc.CLICK]]).tobytes()
                    ).hexdigest()})
    return ({"device": device, "passes": out, "launches": counts(),
             "axes": None if mesh is None else list(mesh.names)}, runner)


def phase27_kernels(torch, runner, files, feed, cfg):
    """(e) gather_rows and the fused push at the pipeline step's shape
    (the first group of a fresh pass of ``runner``'s table: its M x K ids
    and the step's push rows, from forward_backward, nothing applied),
    each bit-equal to its plain version (the push in both writes);
    kernel, plain, library and bound times, the push under its form's
    name (push_adagrad, or push_adagrad_expand on an expand table, whose
    slab and push rows are wider); whether the ids are the chunk batch of
    flagship.first_chunk_ids (PR 8's shape)."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.push_probe import SEED, fused_push_bytes
    from paddlebox_tpu_torch.rate_probe import gather_bytes, time_chain
    from paddlebox_tpu_torch.train import flagship

    table = runner.table
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=table.add_keys)
    table.end_feed_pass()
    table.begin_pass()
    try:
        group = ds.split_batches(1)[0][:runner.batches_per_step]
        batch = runner.device_batch(group)
        slab, ids = table.slab, batch["ids"].reshape(-1)
        ids_np = ids.cpu().numpy()
        chunk = flagship.first_chunk_ids(files, feed, cfg.base,
                                         cfg.n_micro)
        got = rk.gather_rows(slab, ids)
        torch.cuda.synchronize()
        want = rk.gather_rows_plain(slab, ids)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32))
              and torch.equal(got, slab.index_select(0, ids.long())),
              "gather_rows at the pipeline step differs from the plain "
              "version")
        err_g = float((got - want).abs().max())
        del got, want
        W = table.layout.width
        nbytes = gather_bytes(ids_np, table.capacity, W)
        args = (slab, ids)
        out = {"gather_rows": {
            "slab": list(slab.shape), "ids": int(ids.numel()),
            "distinct": int(np.unique(ids_np).size),
            "bytes": nbytes, "max_abs_err": err_g,
            "ms": time_chain(rk.gather_rows, args, nbytes),
            "plain_ms": time_chain(rk.gather_rows_plain, args, nbytes),
            "library_ms": time_chain(lambda a, b: a.index_select(0, b),
                                     args, nbytes),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"}}
        r = runner.forward_backward(batch)
        runner.dense_opt.zero_grad(set_to_none=True)
        g = runner.push_grads(batch, r["demb"], r["dexp"])
        u, p, o, n_uniq = (batch["uids"], batch["perm"], batch["offsets"],
                           batch["n_uniq"])
        conf, layout = table.config.optimizer, runner.layout
        form = pk.push_form(layout)
        err = 0.0
        for rows_out in (False, True):
            s_k, s_p = slab.clone(), slab.clone()
            r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout,
                                  conf, rows_out)
            torch.cuda.synchronize()
            r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                              layout, conf, rows_out)
            check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                  and (not rows_out or torch.equal(r_k.view(torch.int32),
                                                   r_p.view(torch.int32))),
                  "%s (rows_out=%s) at the pipeline step differs from the "
                  "plain version" % (form, rows_out))
            err = max(err, float((s_k - s_p).abs().max()))
            del s_k, s_p, r_k, r_p
        n_valid = int(o[-1])
        live = ids_np != table.padding_id
        G, D = int(g.shape[1]), layout.embedx_dim + layout.expand_dim
        nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
        ops = n_valid * G + int(np.unique(ids_np[live]).size) * (20 + 6 * D)
        args = (slab, g, p, o, u)
        out[form] = {
            "slab": list(slab.shape), "push_rows": list(g.shape),
            "occurrences": n_valid,
            "n_uniq": int(n_uniq), "bytes": nbytes, "max_abs_err": err,
            "embed_grad_rows": int((g[:, 3:].abs().sum(1) > 0).sum()),
            "ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args,
                nbytes),
            "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args,
                nbytes),
            "library_ms": None,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops / F32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS else "operations")}
        out["chunk_batch"] = bool(np.array_equal(ids_np, chunk))
        return out
    finally:
        table.end_pass()


def phase27_gpipe(torch):
    """(d) create_trainer("PipelineTrainer") at FLAGSHIP_PIPE's widths (one
    stage, 8 micro-batches of 1024 rows, d_model 512, 3 layers) on the
    card: forward against sequential_forward bit for bit, then
    GPIPE_STEPS steps toward tanh(x @ w): the losses and the step ms."""
    import numpy as np

    from paddlebox_tpu_torch.parallel.pipeline import PipelineConfig
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.factory import create_trainer

    c = flagship.FLAGSHIP_PIPE
    runner = create_trainer(
        "PipelineTrainer", PipelineConfig(
            n_stages=1, n_micro=c.n_micro, d_model=c.d_model,
            layers_per_stage=c.layers_per_stage, lr=c.lr),
        seed=SHARDED_SEED, device="cuda")
    rng = np.random.RandomState(2)
    x = rng.randn(c.n_micro * c.base.batch, c.d_model).astype(np.float32)
    w = (rng.randn(c.d_model, c.d_model) / np.sqrt(c.d_model)).astype(
        np.float32)
    y = np.tanh(x @ w).astype(np.float32)
    fwd = runner.forward(x)
    seq = runner.sequential_forward(x)
    same = torch.equal(fwd.view(torch.int32), seq.view(torch.int32))
    t0 = time.perf_counter()
    losses = [runner.train_step(x, y) for _ in range(GPIPE_STEPS)]
    torch.cuda.synchronize()
    return {"forward_equals_sequential": bool(same),
            "shape": list(fwd.shape), "losses": losses,
            "step_ms": 1e3 * (time.perf_counter() - t0) / GPIPE_STEPS}


def phase27_child(torch, files, feed, store):
    """Phase 27 in the child, on a world-1 NCCL fleet of its own over the
    child's TCPStore: (a) the CTR pipeline twice on the card (the first
    run's runner then holds (e) the kernels at the step's shape) and its
    first pass on the CPU, (b) through make_mesh's (data, pipeline) mesh,
    (c) the expand-64 table's pass twice (the first run's runner then
    holds (e) at the expand step's shape), (d) the GPipe runner. Its
    records and host seconds."""
    import dataclasses

    from paddlebox_tpu_torch.config.configs import MeshConfig
    from paddlebox_tpu_torch.parallel.mesh import make_mesh
    from paddlebox_tpu_torch.train import flagship

    t0 = time.perf_counter()
    cfg = flagship.FLAGSHIP_PIPE
    out = {"ctr": []}
    fl = phase24_fleet(store, "phase27")
    try:
        for i in range(2):
            rec, runner = phase27_ctr(torch, files, feed, cfg)
            if i == 0:
                out["kernels"] = phase27_kernels(torch, runner, files, feed,
                                                 cfg)
            runner.close()
            out["ctr"].append(rec)
        out["cpu"], runner = phase27_ctr(torch, files, feed, cfg,
                                         device="cpu", passes=1)
        runner.close()
        mesh = make_mesh(MeshConfig(data=1, pipeline=1,
                                    axis_names=("data", "pipeline")),
                         fl.mesh)
        out["mesh"], runner = phase27_ctr(torch, files, feed, cfg, mesh=mesh)
        runner.close()
        exp = dataclasses.replace(cfg, base=flagship.FLAGSHIP_EXPAND)
        out["expand"] = []
        for i in range(2):
            rec, runner = phase27_ctr(torch, files, feed, exp, passes=1)
            if i == 0:
                out["kernels_expand"] = phase27_kernels(torch, runner, files,
                                                        feed, exp)
            runner.close()
            out["expand"].append(rec)
        out["gpipe"] = phase27_gpipe(torch)
    finally:
        fl.stop()
    out["child_s"] = time.perf_counter() - t0
    return out


def phase27_report(res, main):
    """Phase 27's checks and lines in the parent, beside phase 5's passes
    ``main``."""
    def launched(c):
        return json.dumps({k: v for k, v in c.items() if v})

    def digits(passes):
        return [(p["loss"], p["auc"]) for p in passes]

    def same_run(a, b):
        return (digits(a["passes"]) == digits(b["passes"])
                and [p["store_sha"] for p in a["passes"]]
                == [p["store_sha"] for p in b["passes"]]
                and a["launches"] == b["launches"])

    def want_launches(run, push="push_adagrad"):
        steps = sum(p["steps"] for p in run["passes"])
        extra = sum(gather_launches_of(p["counters"])
                    for p in run["passes"])
        return steps, extra, f32_launches(**{push: steps,
                                             "gather_rows": steps + extra})

    # (a) the CTR pipeline: twice bit for bit, learning, a pull and a push
    # a step, the CPU's first pass
    a, b = res["ctr"]
    check(same_run(a, b), "phase 27 pipeline: two runs differ: %s / %s"
          % (json.dumps(a), json.dumps(b)))
    check(a["passes"][1]["loss"] < a["passes"][0]["loss"],
          "phase 27 pipeline did not learn: %s" % digits(a["passes"]))
    steps, extra, want = want_launches(a)
    check(a["launches"] == want and steps == 4
          and all(p["dropped"] == 0 for p in a["passes"]),
          "phase 27 pipeline launches %s over %d steps, %d promotes and "
          "write-backs; wanted %s" % (a["launches"], steps, extra, want))
    c, g = res["cpu"]["passes"][0], a["passes"][0]
    rel = abs(g["loss"] / c["loss"] - 1.0)
    dauc = abs(g["auc"] - c["auc"])
    check(rel <= PIPE_LOSS_RTOL and dauc <= PIPE_AUC_ATOL
          and g["show_click_sha"] == c["show_click_sha"],
          "phase 27 pipeline against its CPU run: loss %r / %r (rel %g), "
          "AUC %r / %r; show and click %s" % (
              g["loss"], c["loss"], rel, g["auc"], c["auc"],
              g["show_click_sha"] == c["show_click_sha"]))
    for p in a["passes"]:
        log("pipe27 pass %d (CtrPipelineRunner at FLAGSHIP_PIPE, one stage "
            "over NCCL): loss %.10f auc %.10f, %d steps of 8 micro-batches, "
            "store sha256 %s, twice; wall %.4f s (phase 5's %.4f) counters "
            "%s" % (p["pass"], p["loss"], p["auc"], p["steps"],
                    p["store_sha"], p["pass_s"], main[p["pass"]]["pass_s"],
                    json.dumps(p["counters"])))
    log("pipe27: launches %s over %d steps: a pull (gather_rows) and one "
        "fused push a step, and %d gather_rows at the delta promote and the "
        "write-backs by the table's counters; the card's first pass against "
        "the CPU's: loss rel %g (limit %g), |dAUC| %g (limit %g), show and "
        "click equal; the CPU pass %.3f s"
        % (launched(a["launches"]), steps, extra, rel, PIPE_LOSS_RTOL, dauc,
           PIPE_AUC_ATOL, c["pass_s"]))

    # (b) the (dp, stage) form through make_mesh = (a)
    m = res["mesh"]
    check(m["axes"] == ["data", "pipeline"] and same_run(m, a),
          "phase 27 make_mesh run %s differs from (a) %s"
          % (json.dumps(m), json.dumps(a)))
    log("pipe27 make_mesh(data=1, pipeline=1): the (dp, stage) form = (a) "
        "bit for bit (digits, store sha256 after each pass, launches %s); "
        "walls %s" % (launched(m["launches"]),
                      [p["pass_s"] for p in m["passes"]]))

    # (c) the expand-64 table
    e1, e2 = res["expand"]
    steps, extra, want = want_launches(e1, "push_adagrad_expand")
    check(same_run(e1, e2) and e1["launches"] == want,
          "phase 27 expand: runs %s / %s, launches wanted %s"
          % (json.dumps(e1), json.dumps(e2), want))
    log("pipe27 expand-64 pass: loss %.10f auc %.10f, store sha256 %s, "
        "twice; launches %s; wall %.4f s"
        % (e1["passes"][0]["loss"], e1["passes"][0]["auc"],
           e1["passes"][0]["store_sha"], launched(e1["launches"]),
           e1["passes"][0]["pass_s"]))

    # (d) GPipe
    gp = res["gpipe"]
    check(gp["forward_equals_sequential"]
          and gp["losses"][-1] < gp["losses"][0],
          "phase 27 GPipe: forward = sequential %s, losses %s"
          % (gp["forward_equals_sequential"], gp["losses"]))
    log("pipe27 GPipeRunner (one stage, 8 x 1024 rows, d_model 512, 3 "
        "layers): forward = sequential_forward bit for bit %s; loss "
        "%.10f -> %.10f over %d steps, %.3f ms a step"
        % (gp["shape"], gp["losses"][0], gp["losses"][-1],
           len(gp["losses"]), gp["step_ms"]))

    # (e) the kernels at the step's shape, of the plain and expand tables
    for key, push, what in (("kernels", "push_adagrad", "FLAGSHIP_PIPE"),
                            ("kernels_expand", "push_adagrad_expand",
                             "FLAGSHIP_PIPE over FLAGSHIP_EXPAND's table")):
        k = res[key]
        check(k["gather_rows"]["max_abs_err"] == 0.0
              and k[push]["max_abs_err"] == 0.0
              and k["gather_rows"]["ids"] == 8 * 131072
              and k[push]["embed_grad_rows"] > 0,
              "phase 27 kernels at the pipeline step (%s): %s"
              % (what, json.dumps(k)))
        for name in ("gather_rows", push):
            log("%s at the pipeline step (%s, 8 micro-batches): bit-equal "
                "to the plain version; %s; the ids %s PR 8's chunk batch"
                % (name, what, json.dumps(k[name]),
                   "are" if k["chunk_batch"] else "are not"))
    log("pipe27 phase seconds in the child: %.3f" % res["child_s"])


# phase 28: the pipeline over the sharded table at world 1
# (ShardedCtrPipelineRunner at FLAGSHIP_PIPE through create_trainer, its
# writes, the expand-64 table and SectionPSTrainer over a PsLocalClient),
# on a world-1 NCCL fleet of its own in phase 22's child after phase 27
PHASE28_TABLE_ID = 28      # the PS's sparse table of SectionPSTrainer's run


def phase28_seeds(torch):
    """Phase 27's push seeds (CtrPipelineRunner._draw_seed at
    SHARDED_SEED)."""
    gen = torch.Generator().manual_seed(SHARDED_SEED + 31)
    return lambda: int(torch.randint(0, 2**31 - 1, (), generator=gen))


def phase28_run(torch, files, feed, fl, cfg, push="scatter", passes=2,
                client=None):
    """One run of the pipeline over the sharded table on ``fl``
    (flagship.build_sharded_pipeline: create_trainer's
    "ShardedCtrPipelineTrainer", or with ``client`` its "SectionPSTrainer"
    over that client's table PHASE28_TABLE_ID) at the pipeline
    configuration ``cfg`` with the write ``push`` and phase 27's seeds:
    ``passes`` passes over the main path's files, each pass's digits,
    steps, wall, table counters and the store's sha256 (over the PS: the
    server's rows of the pass keys). Returns (the record, the runner)."""
    import numpy as np

    from paddlebox_tpu_torch.config.flags import PushFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import flagship

    runner = flagship.build_sharded_pipeline(
        fl, feed, cfg, seed=SHARDED_SEED,
        push_flags=PushFlags(push, flagship.BLOCK_ROWS), ps_client=client,
        ps_table_id=PHASE28_TABLE_ID)
    try:
        check(runner.P == 1 and runner.stage.size == 1 and runner.dp == 1
              and runner.device.type == "cuda"
              and runner.batches_per_step == cfg.n_micro
              and runner.bucket_cap == 2 * cfg.n_micro * feed.key_capacity()
              and runner.push_write == push
              and (client is None or runner.table.shard.store.primary),
              "phase 28 runner: P %d, %d stages, dp %d, %s, KB %d, write %s"
              % (runner.P, runner.stage.size, runner.dp, runner.device,
                 runner.bucket_cap, runner.push_write))
        runner.seed_fn = phase28_seeds(torch)
        ex0 = runner.host_mesh.exchanges
        reset_counts()
        out = []
        for i in range(passes):
            ds = BoxDataset(feed)
            ds.set_filelist(files)
            before = dict(runner.table.counters)
            t0 = time.perf_counter()
            res = runner.train_pass(ds)
            torch.cuda.synchronize()
            rec = {"pass": i, "loss": res["loss"],
                   "auc": runner.metrics.get_metric_msg(
                       "auc", allreduce=fl.metric_allreduce())["auc"],
                   "steps": res["steps"], "dropped": res["dropped_batches"],
                   "pass_s": time.perf_counter() - t0,
                   "counters": counter_delta(before, runner.table)}
            if client is None:
                rec["store_sha"] = shard_store_sha(runner)
            else:
                keys = np.sort(runner.table.shard_keys(0))
                rec["store_sha"] = sha_of(keys, client.pull_sparse(
                    PHASE28_TABLE_ID, keys, create=False))
                rec["server_rows"] = int(client.sparse_size(
                    PHASE28_TABLE_ID))
            out.append(rec)
        return ({"push_write": push, "passes": out, "launches": counts(),
                 "collectives": dict(runner.collective_counts),
                 "a2a_bytes": dict(runner.a2a_bytes),
                 "exchanges": runner.host_mesh.exchanges - ex0,
                 "bucket_cap": runner.bucket_cap,
                 "shard_cap": runner.table.shard_cap}, runner)
    except BaseException:
        runner.close()
        raise


def phase28_kernels(torch, runner, files, feed):
    """(e) the kernels at the sharded pipeline step's shape, from a run's
    runner: a fresh pass's first group staged (its P x KB = 2,097,152
    served ids), its block pulled, the step's forward and backward, the
    push rows merged into the buckets and through their a2a, nothing
    applied: gather_rows of the served ids from the shard slab (width 17,
    or 82 under expand: the extended pull), the fused push's form
    (push_adagrad, or push_adagrad_expand) over the 2,097,152 received
    rows (scatter and rows out), and on the base table blocked_write of
    the step's new rows in BLOCK_ROWS blocks and the rebuild write's
    gather of them at the step's [shard_cap] position map
    (pass_table.pos_for_rebuild, as the rebuild staging makes it), each
    bit-equal to its plain version (and to index_select, index_copy_);
    kernel, plain, library and bound times."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import blocked_layout
    from paddlebox_tpu_torch.embedding.pass_table import pos_for_rebuild
    from paddlebox_tpu_torch.push_probe import SEED, fused_push_bytes
    from paddlebox_tpu_torch.rate_probe import time_chain
    from paddlebox_tpu_torch.train import flagship

    table = runner.table
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=table.add_keys)
    table.end_feed_pass(allgather=runner.fleet.all_gather)
    table.build_owned_slabs()
    try:
        group = ds.split_batches(1)[0][:runner.batches_per_step]
        st = runner.device_batch(group)
        slab = table.slab
        cap, W = slab.shape
        layout, conf = runner.layout, table.shard.config.optimizer
        form = pk.push_form(layout)
        out = {"form": form, "gather_rows": gather_record(
            torch, slab, st["req"], "at the sharded pipeline step (width "
            "%d)" % W)}
        r = runner.forward_backward(st)
        runner.dense_opt.zero_grad(set_to_none=True)
        pg = runner.push_grads(st, r["demb"], r["dexp"])
        g = runner._a2a(pk.merge_push_grads(pg, st["bperm"],
                                            st["boffsets"]), "a2a_push")
        u, p, o, n_uniq = st["uids"], st["perm"], st["offsets"], st["n_uniq"]
        err = 0.0
        for rows_out in (False, True):
            s_k, s_p = slab.clone(), slab.clone()
            r_k = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout,
                                  conf, rows_out)
            torch.cuda.synchronize()
            r_p = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                              layout, conf, rows_out)
            check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
                  and (not rows_out or torch.equal(r_k.view(torch.int32),
                                                   r_p.view(torch.int32))),
                  "%s (rows_out=%s) at the sharded pipeline step differs "
                  "from the plain version" % (form, rows_out))
            err = max(err, float((s_k - s_p).abs().max()))
            del s_k, s_p, r_k, r_p
        n_valid = int(o[-1])
        G, D = int(g.shape[1]), layout.embedx_dim + layout.expand_dim
        nbytes = fused_push_bytes(n_valid, n_uniq, W, G)
        n_real = int((u[:n_uniq] < cap - 1).sum())
        ops = n_valid * G + n_real * (20 + 6 * D)
        args = (slab, g, p, o, u)
        out[form] = {
            "slab": [cap, W], "push_rows": [int(g.shape[0]), G],
            "occurrences": n_valid, "n_uniq": int(n_uniq), "bytes": nbytes,
            "max_abs_err": err,
            "embed_grad_rows": int((pg[:, 3:].abs().sum(1) > 0).sum()),
            "ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args,
                nbytes),
            "plain_ms": time_chain(lambda *a: pk.push_adagrad_fused_plain(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args,
                nbytes),
            "library_ms": None,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops / F32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS else "operations")}
        out["distinct_ids"] = int(np.unique(
            st["req"].cpu().numpy()).size)
        if layout.expand_dim:
            return out
        rows = pk.push_adagrad(slab.clone(), g, p, o, u, n_uniq, SEED,
                               layout, conf, rows_out=True)
        row_map, blk_idx = blocked_layout(u, cap, flagship.BLOCK_ROWS)
        s_k, s_p, s_l = slab.clone(), slab.clone(), slab.clone()
        pk.blocked_write(s_k, rows, row_map, blk_idx)
        torch.cuda.synchronize()
        pk.blocked_write_plain(s_p, rows, row_map, blk_idx)
        idx = u[:n_uniq].long()
        s_l.index_copy_(0, idx, rows)
        check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
              and torch.equal(s_k.view(torch.int32), s_l.view(torch.int32)),
              "blocked_write at the sharded pipeline step differs from its "
              "plain version or index_copy_")
        NB, B = row_map.shape
        placed = int((row_map >= 0).sum())
        nbytes = NB * B * 4 + NB * 4 + placed * W * 4 * 2
        args = (s_k, rows, row_map, blk_idx)
        ms, lib_ms, ratios = blocked_balanced(args, (s_l, idx, rows), nbytes)
        out["blocked_write"] = {
            "slab": [cap, W], "rows": [int(n_uniq), W], "NB": NB, "B": B,
            "placed": placed, "bytes": nbytes,
            "max_abs_err": float((s_k - s_p).abs().max()),
            "ms": ms,
            "plain_ms": time_chain(pk.blocked_write_plain, args, nbytes),
            "library_ms": lib_ms, "library_ratios": ratios,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
        del s_k, s_p, s_l
        pos = torch.from_numpy(pos_for_rebuild(
            u.cpu().numpy(), cap)).to(slab.device)
        check(int((pos >= 0).sum()) == n_uniq,
              "the sharded pipeline step's rebuild map names %d rows, the "
              "push's n_uniq is %d" % (int((pos >= 0).sum()), n_uniq))
        out["rebuild_gather"] = gather_record(
            torch, rows, pos.clamp(0, n_uniq - 1),
            "at the sharded pipeline step's rebuild map")
        return out
    finally:
        table.end_pass()


def phase28_child(torch, files, feed, store):
    """Phase 28 in the child, on a world-1 NCCL fleet of its own over the
    child's TCPStore: (a) the pipeline over the sharded table at
    FLAGSHIP_PIPE twice (the first run's runner then holds (e) the
    kernels at the step's shape), (b) a pass under the blocked and the
    rebuild writes, (c) the expand-64 table's pass (its runner then holds
    (e) the expand form's kernels), (d) SectionPSTrainer over a
    PsLocalClient. Its records and host seconds."""
    import dataclasses

    from paddlebox_tpu_torch.ps import PsLocalClient
    from paddlebox_tpu_torch.train import flagship

    t0 = time.perf_counter()
    cfg = flagship.FLAGSHIP_PIPE
    out = {"runs": [], "writes": {}}
    fl = phase24_fleet(store, "phase28")
    try:
        for i in range(2):
            rec, runner = phase28_run(torch, files, feed, fl, cfg)
            try:
                if i == 0:
                    out["kernels"] = phase28_kernels(torch, runner, files,
                                                     feed)
            finally:
                runner.close()
            out["runs"].append(rec)
        for write in ("blocked", "rebuild"):
            rec, runner = phase28_run(torch, files, feed, fl, cfg, write,
                                      passes=1)
            runner.close()
            out["writes"][write] = rec
        exp = dataclasses.replace(cfg, base=flagship.FLAGSHIP_EXPAND)
        out["expand"], runner = phase28_run(torch, files, feed, fl, exp,
                                            passes=1)
        try:
            out["kernels_expand"] = phase28_kernels(torch, runner, files,
                                                    feed)
        finally:
            runner.close()
        client = PsLocalClient()
        client.create_sparse_table(PHASE28_TABLE_ID, cfg.base.table(),
                                   shard_num=PHASE25_SHARD_NUM, seed=0)
        out["ps"], runner = phase28_run(torch, files, feed, fl, cfg,
                                        client=client)
        runner.close()
    finally:
        fl.stop()
    out["child_s"] = time.perf_counter() - t0
    return out


def phase28_report(res, p27):
    """Phase 28's checks and lines in the parent, against phase 27's runs
    ``p27``."""
    def launched(c):
        return json.dumps({k: v for k, v in c.items() if v})

    def digits(passes):
        return [(p["loss"], p["auc"]) for p in passes]

    def shas(passes):
        return [p["store_sha"] for p in passes]

    def want_launches(run, push="push_adagrad"):
        steps = sum(p["steps"] for p in run["passes"])
        extra = sum(gather_launches_of(p["counters"])
                    for p in run["passes"])
        write = run["push_write"]
        return steps, extra, f32_launches(**{
            push: steps,
            "gather_rows": steps + extra + (steps if write == "rebuild"
                                            else 0),
            "blocked_write": steps if write == "blocked" else 0})

    def check_run(run, what, push="push_adagrad"):
        steps, extra, want = want_launches(run, push)
        c = run["collectives"]
        check(run["launches"] == want
              and all(p["dropped"] == 0 for p in run["passes"])
              and c == {"a2a_pull": steps, "a2a_push": steps}
              and run["exchanges"] == steps,
              "phase 28 %s: launches %s over %d steps and %d promotes and "
              "write-backs (wanted %s), collectives %s, exchanges %d"
              % (what, run["launches"], steps, extra, want, c,
                 run["exchanges"]))
        return steps, extra

    # (a) twice bit for bit, learning, = phase 27 (a) at P = 1
    a, b = res["runs"]
    p27a = p27["ctr"][0]
    check(digits(a["passes"]) == digits(b["passes"])
          and shas(a["passes"]) == shas(b["passes"])
          and a["launches"] == b["launches"],
          "phase 28 (a): two runs differ: %s / %s"
          % (json.dumps(a), json.dumps(b)))
    check(a["passes"][1]["loss"] < a["passes"][0]["loss"],
          "phase 28 (a) did not learn: %s" % digits(a["passes"]))
    check(a["bucket_cap"] == 2097152 and a["shard_cap"] == 1 << 20,
          "phase 28 (a) shapes: KB %d, shard_cap %d"
          % (a["bucket_cap"], a["shard_cap"]))
    steps, extra = check_run(a, "(a)")
    check(digits(a["passes"]) == digits(p27a["passes"])
          and shas(a["passes"]) == shas(p27a["passes"]),
          "phase 28 (a) differs from phase 27 (a): %s / %s, sha256 %s / %s"
          % (digits(a["passes"]), digits(p27a["passes"]),
             shas(a["passes"]), shas(p27a["passes"])))
    for p in a["passes"]:
        log("pipe28 pass %d (ShardedCtrPipelineRunner at FLAGSHIP_PIPE, "
            "world 1 over NCCL): loss %.10f auc %.10f = phase 27 (a), %d "
            "steps, store sha256 %s, twice; wall %.4f s (phase 27's %.4f) "
            "counters %s" % (p["pass"], p["loss"], p["auc"], p["steps"],
                             p["store_sha"], p["pass_s"],
                             p27a["passes"][p["pass"]]["pass_s"],
                             json.dumps(p["counters"])))
    log("pipe28: launches %s over %d steps (a pull and a push a step, %d "
        "gather_rows at the promote and write-backs); collectives %s, %d "
        "host exchanges, a2a bytes %s; KB %d"
        % (launched(a["launches"]), steps, extra,
           json.dumps(a["collectives"]), a["exchanges"],
           json.dumps(a["a2a_bytes"]), a["bucket_cap"]))

    # (b) the writes, each = (a)'s first pass
    for write, run in res["writes"].items():
        check(digits(run["passes"]) == digits(a["passes"][:1])
              and shas(run["passes"]) == shas(a["passes"][:1]),
              "phase 28 %s pass differs from (a)'s first: %s / %s"
              % (write, json.dumps(run["passes"]),
                 json.dumps(a["passes"][:1])))
        check_run(run, "(b) " + write)
        log("pipe28 %s pass: = (a)'s first bit for bit (digits, store "
            "sha256); launches %s; wall %.4f s"
            % (write, launched(run["launches"]),
               run["passes"][0]["pass_s"]))

    # (c) the expand-64 pass = phase 27 (c)
    e, p27e = res["expand"], p27["expand"][0]
    check(digits(e["passes"]) == digits(p27e["passes"])
          and shas(e["passes"]) == shas(p27e["passes"]),
          "phase 28 expand pass %s differs from phase 27 (c) %s"
          % (json.dumps(e["passes"]), json.dumps(p27e["passes"])))
    check_run(e, "(c) expand", "push_adagrad_expand")
    log("pipe28 expand-64 pass: loss %.10f auc %.10f, store sha256 %s = "
        "phase 27 (c); launches %s; wall %.4f s"
        % (e["passes"][0]["loss"], e["passes"][0]["auc"],
           e["passes"][0]["store_sha"], launched(e["launches"]),
           e["passes"][0]["pass_s"]))

    # (d) SectionPSTrainer = (a)
    ps = res["ps"]
    check(digits(ps["passes"]) == digits(a["passes"])
          and shas(ps["passes"]) == shas(a["passes"]),
          "phase 28 SectionPSTrainer %s differs from (a) %s"
          % (json.dumps(ps["passes"]), json.dumps(a["passes"])))
    check_run(ps, "(d) SectionPSTrainer")
    log("pipe28 SectionPSTrainer (PsLocalClient): digits = (a), the "
        "server's rows of the pass keys hash to (a)'s store sha256 after "
        "each pass (%d rows on the server); launches %s; walls %s"
        % (ps["passes"][-1]["server_rows"], launched(ps["launches"]),
           [p["pass_s"] for p in ps["passes"]]))

    # (e) the kernels at the step's shape: the base table's and the
    # expand-64 table's
    k, ke = res["kernels"], res["kernels_expand"]
    check(all(r["max_abs_err"] == 0.0 for r in (
              k["gather_rows"], k["push_adagrad"], k["blocked_write"],
              k["rebuild_gather"], ke["gather_rows"],
              ke["push_adagrad_expand"]))
          and k["gather_rows"]["ids"] == ke["gather_rows"]["ids"] == 2097152
          and k["gather_rows"]["src"] == [1 << 20, 17]
          and ke["gather_rows"]["src"] == [1 << 20, 82]
          and k["push_adagrad"]["push_rows"][0] == 2097152
          and ke["push_adagrad_expand"]["push_rows"] == [
              2097152, k["push_adagrad"]["push_rows"][1] + 64]
          and k["push_adagrad"]["embed_grad_rows"] > 0
          and ke["push_adagrad_expand"]["embed_grad_rows"] > 0
          and k["blocked_write"]["placed"] > 0
          and k["rebuild_gather"]["ids"] == 1 << 20
          and k["rebuild_gather"]["src"] == [
              k["push_adagrad"]["n_uniq"], 17],
          "phase 28 kernels at the sharded pipeline step: %s / %s"
          % (json.dumps(k), json.dumps(ke)))
    for name in ("gather_rows", "push_adagrad", "blocked_write",
                 "rebuild_gather"):
        log("%s at the sharded pipeline step (world 1, KB 2,097,152, %d "
            "distinct served ids): bit-equal to the plain version; %s"
            % (name, k["distinct_ids"], json.dumps(k[name])))
    for name in ("gather_rows", "push_adagrad_expand"):
        log("%s at the sharded pipeline's expand-64 step (world 1, KB "
            "2,097,152, %d distinct served ids): bit-equal to the plain "
            "version; %s" % (name, ke["distinct_ids"], json.dumps(ke[name])))
    log("pipe28 phase seconds in the child: %.3f" % res["child_s"])


def sharded_child(files, feed, out_path, windows, bst_files, bst_feed):
    """Phase 22's spawned process: its NCCL and process-group state never
    touch phases 1-21. Writes its result (pickle) or its traceback."""
    import pickle
    import traceback

    import torch
    try:
        res = sharded_run(torch, files, feed, out_path, windows, bst_files,
                          bst_feed)
        with open(out_path, "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(out_path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def sharded_phase(torch, files, feed, main, main_sha, tmp, spawn, windows,
                  bst_files, bst_feed, tier, stream):
    """Phase 22: ShardedBoxTrainer at world 1 over NCCL in a child, held to
    the main path's run (phase 5): the digits of both passes
    (FLAGSHIP_DIGITS), the written-back store's sha256, the launches
    (SHARDED_LAUNCHES) and three collectives a step; its pass walls beside
    the main path's; its bf16 leg held to phase 12's digits and the 2-byte
    forms' launches; then phases 23-27 from the same child (phase 25 held
    to phase 19's ``tier`` run and phase 17's digits, phase 26's stream to
    phase 20's ``stream``). Returns the child's record."""
    import pickle

    out_path = os.path.join(tmp, "phase22.pkl")
    t0 = time.perf_counter()
    child = spawn.Process(target=sharded_child,
                          args=(files, feed, out_path, windows, bst_files,
                                bst_feed), name="phase22")
    child.start()
    child.join(SHARDED_CHILD_S)
    if child.is_alive():
        child.kill()
        child.join()
        check(False, "phase 22's child passed its %.0f s wall limit"
              % SHARDED_CHILD_S)
    err = (open(out_path + ".err").read()
           if os.path.exists(out_path + ".err") else "")
    check(child.exitcode == 0 and not err and os.path.exists(out_path),
          "phase 22's child failed (exit %s):\n%s" % (child.exitcode, err))
    with open(out_path, "rb") as fh:
        res = pickle.load(fh)
    res["child_s"] = time.perf_counter() - t0
    passes = res["passes"]
    for p in passes:
        log("sharded pass %d (world 1, %s on %s): loss %.10f auc %.10f %s"
            % (p["pass"], res["backend"], res["device"], p["loss"], p["auc"],
               json.dumps(p)))
    digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
              "auc": tuple("%.10f" % p["auc"] for p in passes)}
    check(digits == FLAGSHIP_DIGITS, "sharded digits %s, expected the main "
          "path's %s" % (digits, FLAGSHIP_DIGITS))
    check(res["store_sha"] == main_sha, "the sharded run's store sha256 %s "
          "differs from the main path's %s" % (res["store_sha"], main_sha))
    launches = {k: res["launches"][k] for k in SHARDED_LAUNCHES}
    check(launches == SHARDED_LAUNCHES, "sharded launches %s, expected %s"
          % (res["launches"], SHARDED_LAUNCHES))
    steps = sum(p["batches"] for p in passes)
    c = res["collectives"]
    check((c.get("a2a_pull"), c.get("a2a_push"), c.get("all_reduce"))
          == (steps, steps, steps) and res["exchange"]["exchanges"]
          >= steps, "sharded collectives %s and exchanges %s over %d "
          "steps" % (c, res["exchange"], steps))
    log("sharded launches %s over %d steps (a pull a step, 1 promote, 2 "
        "write-backs; a push a step), collectives %s, host exchange %s; "
        "the store's sha256 equals the main path's: %s"
        % (res["launches"], steps, c, res["exchange"], main_sha))
    log("sharded vs main path pass walls: %s"
        % json.dumps({"sharded_s": [p["pass_s"] for p in passes],
                      "main_s": [p["pass_s"] for p in main],
                      "ratio": [s["pass_s"] / m["pass_s"]
                                for s, m in zip(passes, main)],
                      "child_s": res["child_s"]}))
    bf = res["bf16"]
    digits = {"loss": tuple("%.10f" % p["loss"] for p in bf["passes"]),
              "auc": tuple("%.10f" % p["auc"] for p in bf["passes"])}
    want = dict(SHARDED_BF16_LAUNCHES, push_adagrad=0, gather_rows=0)
    check(digits == BF16_DIGITS and {k: bf["launches"][k] for k in want}
          == want and bf["passes"][0]["slab_dtype"] == "torch.int16",
          "sharded bf16 passes %s, launches %s; expected %s and %s"
          % (bf["passes"], bf["launches"], BF16_DIGITS, want))
    log("sharded bf16 passes (FLAGSHIP_BF16, world 1): digits %s = "
        "BF16_DIGITS, launches %s, %s"
        % (json.dumps(digits), json.dumps(want), json.dumps(bf["passes"])))
    log("sharded collectives' device ms a call at the step's shapes: %s"
        % json.dumps(res["collective_ms"]))
    for name, rec in res["kernels"].items():
        log("%s at the shard shape (world 1): bit-equal to the plain "
            "version; %s" % (name, json.dumps(rec)))
    # 23. the remaining modes, run in the same child
    phase23_report(res["phase23"], res)
    # 24. the other policies, the hot tier and the shuffled feed
    phase24_report(res["phase24"], res)
    # 25. the sharded SSD tier, the PS, Downpour, the sp group
    phase25_report(res["phase25"], res, tier)
    # 26. the stream over the shard (held to phase 20's), the towers, heter
    phase26_report(res["phase26"], main, stream)
    # 27. the pipeline runners at one stage
    phase27_report(res["phase27"], main)
    # 28. the pipeline over the sharded table, held to phase 27's runs
    phase28_report(res["phase28"], res["phase27"])
    return res


# phase 29: train to serve. The serving plane (paddlebox_tpu_torch/serving/)
# runs on the host and holds no tensor; the kernels it serves the work of
# are the trainer's, launched in its live leg.
SERVE_BATCH = 4096            # a pull's keys in the server legs
SERVE_ABSENT = 1000           # absent keys beside phase 7's store
SERVE_DEADLINE_S = 10.0       # from a delta's DONE to its rows served
SERVE_REFRESH_S = 0.1         # serving_refresh_secs of the live legs
SERVE_KEYS = 4_000_000        # tools/serving_load_probe.py's base: keys
SERVE_DIM = 9                 # and dim
SERVE_HOT = 1 << 16           # its HOT_SET: the fleet's replicated keys
SERVE_SEED = 29               # the synthetic base's numpy seed
SERVE_DELTA_KEYS = 20000      # the fleet leg's delta
SERVE_LOAD_S = 3.0            # the fleet leg's timed pulls
SERVE_LOAD_THREADS = 4
SERVE_FORBIDDEN = ("torch", "jax", "paddlebox_tpu",
                   "paddlebox_tpu_torch.train")


def trained_sha(table):
    """sha256 of the sorted store with its delta-score column zeroed: a
    delta save clears the covered rows' delta scores (the stat rewrite
    SaveDelta makes), which trains nothing."""
    import hashlib

    from paddlebox_tpu_torch.embedding import accessor as acc
    k, v = sorted_store(table)
    v = v.copy()
    v[:, acc.DELTA_SCORE] = 0.0
    return hashlib.sha256(k.tobytes() + v.tobytes()).hexdigest()


def serve_import_leg():
    """(a) A fresh interpreter imports the serving plane and loads no torch,
    no JAX, no module of the JAX package and not the port's trainer.
    Returns its seconds."""
    import subprocess
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "import paddlebox_tpu_torch.serving\n"
            "print(json.dumps([time.perf_counter() - t0, "
            "sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, "the serving import failed: %s" % out.stderr)
    secs, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if any(m == f or m.startswith(f + ".")
                                    for f in SERVE_FORBIDDEN)]
    check(not bad, "the serving import loaded %s" % bad[:8])
    return secs


def serve_pull_all(client, keys):
    """``keys`` pulled SERVE_BATCH at a time: their rows, in order."""
    import numpy as np
    return np.concatenate([client.pull(keys[i:i + SERVE_BATCH])
                           for i in range(0, keys.size, SERVE_BATCH)])


def absent_keys(rng, keys, n):
    """``n`` uint64 keys that sorted ``keys`` lacks."""
    import numpy as np
    out = np.empty(0, np.uint64)
    while out.size < n:
        cand = rng.randint(1, 1 << 62, 2 * n, dtype=np.int64).astype(
            np.uint64)
        pos = np.minimum(np.searchsorted(keys, cand), keys.size - 1)
        out = np.unique(np.concatenate([out, cand[keys[pos] != cand]]))
    return rng.permutation(out)[:n]


def serve_day_leg(tmp):
    """(b) Phase 7's day (the base and three deltas of day0 under
    <tmp>/day/xbox): build_stack over it answers every key of its views and
    SERVE_ABSENT absent ones bit-equal to XboxModelReader's composed view
    (the absent keys zero rows), and a ServingServer through a
    ServingClient at SERVE_BATCH a pull answers them with the same bits."""
    import numpy as np

    from paddlebox_tpu_torch.serving import (ServingClient, ServingServer,
                                             build_stack)
    from paddlebox_tpu_torch.serving.store import read_xbox_view
    from paddlebox_tpu_torch.train.checkpoint import XboxModelReader

    root = os.path.join(tmp, "day", "xbox")
    t0 = time.perf_counter()
    stack, sources = build_stack(root, ["day0"])
    check([(s.is_base, s.delta_id) for s in sources]
          == [(0, 1), (0, 2), (0, 3), (1, 0)],
          "phase 7's sources %s" % [s.path for s in sources])
    keys = np.unique(np.concatenate([read_xbox_view(s.path)[0]
                                     for s in sources]))
    absent = absent_keys(np.random.RandomState(SERVE_SEED), keys,
                         SERVE_ABSENT)
    probe = np.concatenate([keys, absent])
    want = XboxModelReader(root, "day0").lookup(probe)
    got = stack.lookup(probe)
    check(bits_equal(got, want) and not got[keys.size:].any(),
          "the stack over phase 7's day differs from XboxModelReader")
    stack_s = time.perf_counter() - t0
    server = ServingServer(root, days=["day0"], watch=False)
    client = ServingClient([("127.0.0.1", server.port)])
    try:
        t0 = time.perf_counter()
        got = serve_pull_all(client, probe)
        rpc_s = time.perf_counter() - t0
        check(bits_equal(got, want) and client.last_gen == 0,
              "the served day differs from XboxModelReader")
    finally:
        client.close()
        check(server.drain(timeout=10.0), "the day's server drained late")
    return {"keys": int(keys.size), "absent": SERVE_ABSENT,
            "stack_s": stack_s, "rpc_s": rpc_s,
            "pulls": -(-probe.size // SERVE_BATCH)}


def serve_live_leg(torch, cfg, feed, files, tmp, main, main_trained,
                   reset_counts, counts, device="cuda"):
    """(c) A fresh trainer of ``cfg`` on ``device`` trains the main path's
    two passes while a ServingServer with its refresh watcher serves the
    xbox root its CheckpointManager writes: a base of day0 before the
    first pass (the watcher starts on it), a delta of day1 after each
    pass. After a delta's DONE the server serves its rows bit for bit
    within SERVE_DEADLINE_S, one generation up, and the pass's keys as
    XboxModelReader composes them. The passes give ``main``'s digits and
    its store but for the delta scores the saves clear (``main_trained``,
    trained_sha); a pass launches push_adagrad once a step and gather_rows
    once a step and once a promote and a write-back (the table's
    counters): the save's stat rewrite drops the residency, so the second
    pass builds in full where the main path promotes."""
    import numpy as np

    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import ServingFlags
    from paddlebox_tpu_torch.serving import ServingClient, ServingServer
    from paddlebox_tpu_torch.serving.store import read_xbox_view
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      XboxModelReader)

    root = os.path.join(tmp, "serve_live")
    xbox = os.path.join(root, "xbox")
    trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter", device)
    cm = CheckpointManager(CheckpointConfig(
        batch_model_dir=os.path.join(root, "batch"), xbox_model_dir=xbox,
        async_save=True), trainer.table)
    cm.save_base(trainer.params, trainer.opt_state, "day0")
    cm.wait()
    server = ServingServer(xbox, flags=ServingFlags(
        serving_refresh_secs=SERVE_REFRESH_S))
    client = ServingClient([("127.0.0.1", server.port)])
    deltas = []

    def after_pass(rec):
        rec["launches"] = counts()
        reset_counts()
        gen = client.ping()["gen"]
        view = cm.save_delta("day1", rec["pass"] + 1)
        cm.wait()
        t_done = time.perf_counter()
        vk, vrows = read_xbox_view(view)
        check(vk.size > 0, "delta-%d is empty" % (rec["pass"] + 1))
        while True:
            client.pull(vk[:1])
            if client.last_gen != gen:
                break
            check(time.perf_counter() - t_done < SERVE_DEADLINE_S,
                  "delta-%d not served within %.0f s"
                  % (rec["pass"] + 1, SERVE_DEADLINE_S))
            time.sleep(0.005)
        seen_s = time.perf_counter() - t_done
        check(client.last_gen == gen + 1,
              "delta-%d moved the generation %d -> %d"
              % (rec["pass"] + 1, gen, client.last_gen))
        got = client.pull(vk)
        served = serve_pull_all(client, pass_keys)
        reader = XboxModelReader(xbox, "day0", "day1")
        check(bits_equal(got, vrows)
              and bits_equal(served, reader.lookup(pass_keys))
              and client.last_gen == gen + 1,
              "delta-%d served rows differ from its view"
              % (rec["pass"] + 1))
        deltas.append({"delta": rec["pass"] + 1, "rows": int(vk.size),
                       "gen": client.last_gen, "done_to_served_s": seen_s,
                       "pass_keys": int(pass_keys.size)})

    pass_keys = flagship.sorted_pass_keys(files, feed)
    try:
        reset_counts()
        passes = main_passes(torch, trainer, ds, after_pass=after_pass)
    finally:
        client.close()
        server.drain(timeout=10.0)
    digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
              "auc": tuple("%.10f" % p["auc"] for p in passes)}
    want = {"loss": tuple("%.10f" % p["loss"] for p in main),
            "auc": tuple("%.10f" % p["auc"] for p in main)}
    check(digits == want, "train-to-serve digits %s, the main path's %s"
          % (digits, want))
    check(trained_sha(trainer.table) == main_trained,
          "train-to-serve store differs from the main path's")
    for p, m in zip(passes, main):
        n = p["batches"]
        check(p["launches"]["push_adagrad"] == n == m["batches"]
              and p["launches"]["gather_rows"]
              == n + gather_launches_of(p["counters"])
              and p["launches"]["blocked_write"] == 0
              and p["launches"]["scale_copy"] == 0,
              "train-to-serve pass %d launches %s, counters %s"
              % (p["pass"], p["launches"], p["counters"]))
    check(passes[0]["counters"] == main[0]["counters"]
          and passes[1]["counters"]["pass_rows_promote_hit"] == 0
          and passes[1]["counters"]["pass_rows_written_back"]
          == main[1]["counters"]["pass_rows_written_back"],
          "train-to-serve counters %s, the main path's %s"
          % ([p["counters"] for p in passes], [m["counters"] for m in main]))
    launches = {}
    for p in passes:
        for k, v in p["launches"].items():
            launches[k] = launches.get(k, 0) + v
    trainer.close()
    return {"passes": [{k: p[k] for k in ("loss", "auc", "batches",
                                          "pass_s", "counters",
                                          "launches")} for p in passes],
            "deltas": deltas, "launches": launches}


def serve_hist_counts(fleet):
    """The fleet's serving_lookup_us counts, summed over its live
    replicas (each replica's stats RPC)."""
    total = None
    for box in fleet.boxes:
        c = box.client(timeout=10.0)
        try:
            for i in range(len(box.endpoints)):
                try:
                    h = c.stats(i)["lookup_us_counts"]
                except (OSError, RuntimeError):
                    continue
                total = h if total is None else [a + b for a, b in
                                                 zip(total, h)]
        finally:
            c.close()
    return total


def maps_libtorch(pid):
    with open("/proc/%d/maps" % pid) as f:
        return "libtorch" in f.read()


def serve_fleet_leg(tmp, n_keys=SERVE_KEYS, n_hot=SERVE_HOT, card=""):
    """(d) MultiBoxFleet(boxes=2, replicas=2) under key-mod over a synthetic
    base of ``n_keys`` x SERVE_DIM (numpy, SERVE_SEED) with ``n_hot``
    replicated keys: its replicas map no libtorch; FleetClient pulls of
    hits, hot keys and misses equal the single-box MmapViewStack bit for
    bit; SERVE_LOAD_S of pulls on SERVE_LOAD_THREADS threads give keys/s
    and the window's p50 and p99 of serving_lookup_us; a delta of day1
    landing under puller threads never gives one box's response rows of
    two generations, nor any row that is neither; with one replica of
    box 0 killed every pull still answers, bit-equal; an ObsExporter on
    port 0 shows the serving_fleet section in /health while the fleet is
    up and not after close."""
    import urllib.request

    import numpy as np

    from paddlebox_tpu_torch.obs.exporter import ObsExporter
    from paddlebox_tpu_torch.serving import (MmapViewStack, MultiBoxFleet,
                                             ServingClient, write_hot_keys,
                                             write_xbox_columnar)
    from paddlebox_tpu_torch.utils.stats import hist_percentile

    def health(port):
        with urllib.request.urlopen("http://127.0.0.1:%d/health" % port,
                                    timeout=10) as r:
            return json.loads(r.read())

    rng = np.random.RandomState(SERVE_SEED)
    t0 = time.perf_counter()
    root = os.path.join(tmp, "serve_fleet", "xbox")
    day0 = os.path.join(root, "day0")
    os.makedirs(day0)
    draw = np.unique(rng.randint(1, 1 << 62, n_keys + n_keys // 32 + 16,
                                 dtype=np.int64).astype(np.uint64))
    keys = np.sort(draw[rng.permutation(draw.size)[:n_keys]])
    check(keys.size == n_keys, "the synthetic base has %d keys" % keys.size)
    rows = rng.standard_normal((n_keys, SERVE_DIM)).astype(np.float32)
    base = write_xbox_columnar(os.path.join(day0, "view.xcol"), keys, rows)
    with open(os.path.join(day0, "DONE"), "w") as f:
        f.write(repr(time.time()))
    hot_path = write_hot_keys(os.path.join(tmp, "serve_fleet", "hot.keys"),
                              rng.choice(keys, n_hot, replace=False))
    misses = absent_keys(rng, keys, SERVE_BATCH)
    write_s = time.perf_counter() - t0
    oracle = MmapViewStack.from_files([base])
    exp = ObsExporter(0)
    t0 = time.perf_counter()
    fleet = MultiBoxFleet(root, boxes=2, replicas=2, policy_name="key-mod",
                          hot_keys_path=hot_path, flag_overrides={
                              "serving_refresh_secs": SERVE_REFRESH_S},
                          start_timeout=120.0)
    up_s = time.perf_counter() - t0
    rec = {"keys": n_keys, "dim": SERVE_DIM, "hot": n_hot,
           "write_s": write_s, "bring_up_s": up_s}
    fc = None
    try:
        pids = [p for b in fleet.boxes for p in b.pids]
        check(len(pids) == 4 and not any(maps_libtorch(p) for p in pids),
              "a serving replica maps libtorch")
        hot = fleet.hot_keys

        def probe(r):
            return r.permutation(np.concatenate([
                r.choice(keys, SERVE_BATCH - 512),
                r.choice(hot, 256), r.choice(misses, 256)]))

        fc = fleet.client(timeout=30.0)
        for _ in range(4):
            p = probe(rng)
            check(bits_equal(fc.pull(p), oracle.lookup(p)),
                  "the fleet's pull differs from the single-box stack")
        # the timed window: SERVE_LOAD_THREADS callers, batch SERVE_BATCH
        probes = [probe(rng) for _ in range(32)]
        before = serve_hist_counts(fleet)
        done = []
        stop_at = time.perf_counter() + SERVE_LOAD_S

        def load(i):
            n = 0
            while time.perf_counter() < stop_at:
                n += fc.pull(probes[(i + n) % len(probes)]).shape[0]
            done.append(n)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=load, args=(i,))
                   for i in range(SERVE_LOAD_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        load_s = time.perf_counter() - t0
        after = serve_hist_counts(fleet)
        window = [a - b for a, b in zip(after, before)]
        check(sum(window) > 0, "the timed window served no pull")
        rec["load"] = {"threads": SERVE_LOAD_THREADS, "batch": SERVE_BATCH,
                       "secs": load_s, "keys": int(sum(done)),
                       "keys_per_s": sum(done) / load_s,
                       "lookups": int(sum(window)),
                       "p50_us": hist_percentile(window, 0.50),
                       "p99_us": hist_percentile(window, 0.99)}
        log("serve fleet: %(keys_per_s).1f keys/s over %(secs).3f s "
            "(%(threads)d threads, batch %(batch)d), serving_lookup_us "
            "p50 %(p50_us).1f p99 %(p99_us).1f over %(lookups)d lookups"
            % rec["load"] + "; host measurements on the machine with "
            "the card (%s)" % card)
        sec = health(exp.port).get("serving_fleet")
        check(sec is not None and sec["type"] == "serving_fleet"
              and sec["boxes"] == 2 and len(sec["replicas"]) == 4
              and sec["hot_rows"] == n_hot,
              "/health's serving_fleet section %s" % sec)
        rec["health"] = {k: sec[k] for k in ("boxes", "requests", "qps",
                                             "p50_us", "p99_us", "policy")}

        # a delta of day1 lands under pullers
        dk = np.unique(rng.choice(keys, SERVE_DELTA_KEYS, replace=False))
        old = oracle.lookup(dk)
        new = old + np.float32(1.0)
        box_of = dk % np.uint64(2)
        torn, counts = [], {"old": 0, "new": 0, "fleet": 0}
        counts_lock = threading.Lock()
        stop = threading.Event()

        def seen(kind):
            with counts_lock:
                counts[kind] += 1

        def box_puller(b):
            c = ServingClient(fleet.boxes[b].endpoints, timeout=30.0)
            mine = box_of == b
            try:
                while not stop.is_set():
                    got = c.pull(dk[mine])
                    if bits_equal(got, old[mine]):
                        seen("old")
                    elif bits_equal(got, new[mine]):
                        seen("new")
                    else:
                        torn.append("box %d mixed generations" % b)
            except Exception as e:  # noqa: BLE001 (checked below)
                torn.append(repr(e))
            finally:
                c.close()

        def fleet_puller():
            try:
                while not stop.is_set():
                    got = fc.pull(dk).view(np.uint32)
                    ok = ((got == old.view(np.uint32)).all(1)
                          | (got == new.view(np.uint32)).all(1))
                    seen("fleet")
                    if not ok.all():
                        torn.append("a fleet row of neither generation")
            except Exception as e:  # noqa: BLE001 (checked below)
                torn.append(repr(e))

        pullers = [threading.Thread(target=box_puller, args=(b,))
                   for b in range(2)] + [threading.Thread(
                       target=fleet_puller)]
        for t in pullers:
            t.start()
        d1 = os.path.join(root, "day1", "delta-1")
        os.makedirs(d1)
        delta = write_xbox_columnar(os.path.join(d1, "view.xcol"), dk, new)
        with open(os.path.join(d1, "DONE"), "w") as f:
            f.write(repr(time.time()))
        t_done = time.perf_counter()
        oracle2 = MmapViewStack.from_files([base, delta])
        try:
            # every replica of both boxes on the new generation
            while True:
                gens = [st["gen"] for st in fleet.health()["replicas"]]
                if gens == [1, 1, 1, 1]:
                    break
                check(time.perf_counter() - t_done < SERVE_DEADLINE_S,
                      "the fleet's delta not served within %.0f s (gens %s)"
                      % (SERVE_DEADLINE_S, gens))
                time.sleep(0.01)
            rec["delta_s"] = time.perf_counter() - t_done
            time.sleep(0.2)
        finally:
            stop.set()
            for t in pullers:
                t.join(timeout=30.0)
        check(not torn, "delta under pullers: %s" % torn[:3])
        check(counts["new"] > 0 and counts["fleet"] > 0,
              "the pullers saw %s" % counts)
        rec["delta"] = dict(counts, keys=int(dk.size))
        for _ in range(4):
            p = np.concatenate([probe(rng), rng.choice(dk, 512)])
            check(bits_equal(fc.pull(p), oracle2.lookup(p)),
                  "after the delta the fleet differs from the stack")
        # one replica of box 0 dies: every pull still answers
        fleet.boxes[0]._procs[0].kill()
        fleet.boxes[0]._procs[0].join(timeout=10.0)
        for _ in range(16):
            p = probe(rng)
            check(bits_equal(fc.pull(p), oracle2.lookup(p)),
                  "with a replica killed the fleet differs")
        rec["after_kill_pulls"] = 16
    finally:
        if fc is not None:
            fc.close()
        fleet.close()
        after_close = health(exp.port)
        exp.close()
    check("serving_fleet" not in after_close,
          "/health keeps serving_fleet after close")
    return rec


def serve_journal_leg(torch, cfg, feed, files, tmp, reset_counts, counts,
                      device="cuda"):
    """(e) Journal-fed freshness: a StreamingRunner at phase 20's shape
    (its window, base cadence and journal) over the first two of phase
    20's clean windows (four files), then a JournalDeltaSource over its
    live journal directory: the overlay's every row is the stream's final
    store's row projected by xbox_embed_cols, its applied watermark is
    the newest file's mtime, and a ServingServer over the run's xbox root
    with that journal stamps it into a pull's response, whose rows are the
    overlay's. Phase 20's own directory holds no rows by then: its
    journal-mode micro-checkpoint moved the epoch's segments into the
    snapshot (journal.py rebase)."""
    import shutil

    import numpy as np

    from paddlebox_tpu_torch.config.flags import ObsFlags, ServingFlags
    from paddlebox_tpu_torch.serving import (JournalDeltaSource,
                                             ServingClient, ServingServer)
    from paddlebox_tpu_torch.serving.store import read_xbox_columnar

    root = os.path.join(tmp, "serve_journal")
    watch = os.path.join(root, "watch")
    os.makedirs(watch)
    t0 = time.time() - 1e-3 * 4
    for i, src in enumerate(files[:4]):
        dst = os.path.join(watch, STREAM_NAMES[i])
        shutil.copy(src, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        os.utime(dst, (t0 + 1e-3 * i, t0 + 1e-3 * i))
    newest = os.path.getmtime(os.path.join(watch, STREAM_NAMES[3]))
    reset_counts()
    trainer, _cm, res, _bounds, passes = stream_run(
        torch, cfg, feed, watch, os.path.join(root, "run"), ObsFlags(),
        device)
    launches = counts()
    steps = sum(p["batches"] for p in passes)
    extra = sum(gather_launches_of(p["counters"]) for p in passes)
    check(device != "cuda" or launches == f32_launches(
              push_adagrad=steps, gather_rows=steps + extra),
          "the two-window stream's launches %s over %d steps"
          % (launches, steps))
    check([(p["window"], p["admitted"]) for p in res["passes"]]
          == [(0, True), (1, True)],
          "the two-window stream: %s" % res["passes"])
    sk, sv = sorted_store(trainer.table)
    layout = trainer.table.layout
    jdir = os.path.join(root, "run", "batch", "_journal", "rank0")
    src = JournalDeltaSource([jdir])
    try:
        t1 = time.perf_counter()
        check(src.poll(), "the journal gave the overlay nothing")
        path = src.compile_overlay()
        poll_s = time.perf_counter() - t1
        ok, orows = (np.asarray(a) for a in read_xbox_columnar(path))
        pos = np.minimum(np.searchsorted(sk, ok), sk.size - 1)
        check(ok.size > 0 and np.array_equal(sk[pos], ok)
              and bits_equal(orows, xbox_cols(sv[pos], layout)),
              "the journal's overlay differs from the stream's store")
        wm = src.applied_watermark()
        check(wm == newest, "the journal's watermark %r, the newest file's "
              "mtime %r" % (wm, newest))
    finally:
        src.close()
    server = ServingServer(os.path.join(root, "run", "xbox"),
                           flags=ServingFlags(
                               serving_journal_dir=jdir,
                               serving_refresh_secs=SERVE_REFRESH_S))
    client = ServingClient([("127.0.0.1", server.port)])
    try:
        t1 = time.perf_counter()
        probe = ok[:SERVE_BATCH]
        # the watcher polls the journal (the watermark) before it swaps
        # the overlay in: wait for both
        while True:
            got = client.pull(probe)
            if client.last_watermark > 0.0 and client.last_gen >= 1:
                break
            check(time.perf_counter() - t1 < SERVE_DEADLINE_S,
                  "no pull carried the overlay and the watermark within "
                  "%.0f s" % SERVE_DEADLINE_S)
            time.sleep(0.01)
        served_s = time.perf_counter() - t1
        check(client.last_watermark == wm
              and bits_equal(got, orows[:SERVE_BATCH]),
              "the served overlay: watermark %r (want %r) or rows differ"
              % (client.last_watermark, wm))
    finally:
        client.close()
        server.drain(timeout=10.0)
    trainer.close()
    return {"windows": len(passes), "overlay_rows": int(ok.size),
            "store_rows": int(sk.size), "watermark": wm,
            "poll_compile_s": poll_s, "served_s": served_s,
            "losses": [p["loss"] for p in passes], "launches": launches}


def serve_phase(torch, cfg, feed, files, tmp, main, main_trained,
                reset_counts, counts, card):
    """Phase 29: train to serve (see the module docstring). Returns its
    record; every leg raises on a failed check."""
    legs = {}
    t0 = time.perf_counter()
    rec = {"import_s": serve_import_leg()}
    legs["import"] = time.perf_counter() - t0
    log("serve: import paddlebox_tpu_torch.serving in %.3f s in a fresh "
        "interpreter, no torch, jax, paddlebox_tpu or paddlebox_tpu_torch."
        "train module loaded" % rec["import_s"])
    t0 = time.perf_counter()
    rec["day"] = serve_day_leg(tmp)
    legs["day"] = time.perf_counter() - t0
    log("serve day: %s" % json.dumps(rec["day"]))
    t0 = time.perf_counter()
    rec["live"] = serve_live_leg(torch, cfg, feed, files, tmp, main,
                                 main_trained, reset_counts, counts)
    legs["live"] = time.perf_counter() - t0
    for d in rec["live"]["deltas"]:
        log("serve live: delta-%(delta)d (%(rows)d rows) served %(gen)d "
            "generations up %(done_to_served_s).4f s after its DONE; the "
            "pass's %(pass_keys)d keys served as XboxModelReader composes "
            "them" % d)
    log("serve live: %s" % json.dumps(rec["live"]))
    t0 = time.perf_counter()
    rec["fleet"] = serve_fleet_leg(tmp, card=card)
    legs["fleet"] = time.perf_counter() - t0
    log("serve fleet: %s" % json.dumps(rec["fleet"]))
    t0 = time.perf_counter()
    rec["journal"] = serve_journal_leg(torch, cfg, feed, files, tmp,
                                       reset_counts, counts)
    legs["journal"] = time.perf_counter() - t0
    log("serve journal: %s" % json.dumps(rec["journal"]))
    rec["legs_s"] = legs
    log("serve legs (s): %s; %s" % (json.dumps(legs), card))
    return rec


# phase 30: the user entry points, the demos of paddlebox_tpu_torch/
# examples/ on the card as their users run them
DEMO_PASSES = 2              # train_ctr's passes in (a)
DEMO_WALL_S = 300.0          # a launched demo's wall limit
DEMO_GROUP_S = 120.0         # its process groups' timeout
PULL_IDS = 131072            # (b): the flagship pull's ids, drawn from
PULL_ID_RANGE = 100000       # [0, 100000) (about 73,000 distinct)
PULL_SEED = 30
# (c): read_threads 1 (a) and 4 (b) in cadence_probe.BALANCED's order
READ_ORDER = "baabba"
LAUNCHED_DEMOS = (
    ("train_sharded", ["--passes", "2"],
     ("devices: 1 × cuda (nccl)", "pass 1: loss=", "streaming AUC:")),
    ("train_pipeline", ["--passes", "2"],
     ("pipeline: 1 stages × cuda", "pass 1: loss=", "features trained:")),
    ("train_mesh_tower", ["--kind", "tp", "--passes", "2"],
     ("TP DeepFM: 1024-wide layer split over 1 ranks", "pass 1: loss=",
      "features trained:")),
)


def demo_quiet(fn, argv, **kw):
    """(fn(argv, **kw), what it printed): a demo's main in process."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(argv, **kw)
    return res, buf.getvalue()


def demo_lines(name, printed, want):
    for ln in printed.splitlines():
        log("demo %s: %s" % (name, ln))
    missing = [w for w in want if w not in printed]
    check(not missing, "demo %s printed no %s" % (name, missing))


def demo_ctr_cpu(workdir):
    """Phase 30 (a)'s CPU run of train_ctr (in the spawned writer)."""
    from paddlebox_tpu_torch.examples import train_ctr
    res, printed = demo_quiet(train_ctr.main, [
        "--passes", str(DEMO_PASSES), "--device", "cpu", "--workdir",
        workdir])
    return {"losses": [float(p["loss"]) for p in res["passes"]],
            "auc": float(res["auc"]["auc"]), "push_write": res["push_write"],
            "printed": printed}


def launch_demo(name, args, out_dir):
    """Start fleet/launch.py --nproc 1 over examples/<name>.py on the card;
    (the process, its log's path)."""
    import subprocess
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "paddlebox_tpu_torch", "examples", name + ".py")
    path = os.path.join(out_dir, name + ".log")
    env = dict(os.environ, TMPDIR=out_dir)
    with open(path, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddlebox_tpu_torch.fleet.launch",
             "--nproc", "1", script, *args, "--timeout", str(DEMO_GROUP_S)],
            stdout=fh, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, path


def wait_demo(name, proc, path, t0):
    """The launched demo's output, once it exited 0 within DEMO_WALL_S of
    ``t0`` (killed past it)."""
    import subprocess
    try:
        proc.wait(max(1.0, DEMO_WALL_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(path) as fh:
        out = fh.read()
    check(proc.returncode == 0, "launched demo %s exited %s:\n%s"
          % (name, proc.returncode, out[-3000:]))
    return out


def demo_ctr_card(torch, workdir, push_write, reset_counts, counts):
    """(a) on the card: train_ctr's demo leg at ``push_write``; its
    losses, AUC and launches, checked against its steps."""
    from paddlebox_tpu_torch.examples import train_ctr
    argv = ["--passes", str(DEMO_PASSES), "--workdir", workdir]
    if push_write != "auto":
        argv += ["--push-write", push_write]
    reset_counts()
    res, printed = demo_quiet(train_ctr.main, argv)
    launches = counts()
    label = "train_ctr" + ("" if push_write == "auto" else "_" + push_write)
    demo_lines(label, printed, ("push write: %s -> %s on cuda" % (
        push_write, "scatter" if push_write == "auto" else push_write),
        "pass 1: loss=", "streaming AUC:", "checkpoints under"))
    steps = sum(int(p["batches"]) for p in res["passes"])
    pulls = steps * (2 if push_write == "rebuild" else 1)
    check(launches["push_adagrad"] == steps
          and DEMO_PASSES <= launches["gather_rows"] - pulls
          <= 2 * DEMO_PASSES
          and launches["blocked_write"] == 0,
          "demo %s launches %s over %d steps" % (label, launches, steps))
    return {"label": label, "losses": [float(p["loss"])
                                       for p in res["passes"]],
            "auc": float(res["auc"]["auc"]), "steps": steps,
            "launches": launches, "push_write": res["push_write"]}


def demo_ctr_against_cpu(rec, cpu):
    """(a)'s card run ``rec`` against the CPU run under phase 3's
    limits."""
    for got, want in zip(rec["losses"], cpu["losses"], strict=True):
        check(abs(got - want) <= 1e-4 * abs(want), "demo %s loss %r on the "
              "card, %r on the CPU" % (rec["label"], got, want))
    check(abs(rec["auc"] - cpu["auc"]) <= 1e-4, "demo %s AUC %r on the "
          "card, %r on the CPU" % (rec["label"], rec["auc"], cpu["auc"]))
    rec.update(cpu_losses=cpu["losses"], cpu_auc=cpu["auc"])
    log("demo %s on the card: %s" % (rec["label"], json.dumps(rec)))


def demo_pull_check(torch, dev):
    """(b) pull_sparse_differentiable at the flagship pull's shape."""
    import numpy as np

    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.ops.row_kernels import (gather_rows,
                                                     gather_rows_plain)
    from paddlebox_tpu_torch.ops.sparse import (pull_sparse,
                                                pull_sparse_differentiable,
                                                pull_view_from_rows,
                                                pull_view_grad)
    layout = ValueLayout(8)
    rng = np.random.RandomState(PULL_SEED)
    slab = torch.from_numpy(rng.rand(1 << 20, layout.width).astype(
        np.float32)).to(dev).requires_grad_(True)
    ids_np = rng.randint(0, PULL_ID_RANGE, PULL_IDS).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    d_out = torch.from_numpy(rng.randn(PULL_IDS, 3 + 8).astype(
        np.float32)).to(dev)
    reset_counts()
    out = pull_sparse_differentiable(slab, ids, layout)
    out.backward(d_out)
    torch.cuda.synchronize()
    launches = counts()
    plain = pull_view_from_rows(slab.detach().index_select(
        0, ids.to(torch.int64)), layout)
    want = pull_view_grad(ids.cpu(), d_out.cpu(), tuple(slab.shape), layout)
    check(bits_equal(out.detach().cpu().numpy(), plain.cpu().numpy())
          and bits_equal(slab.grad.cpu().numpy(), want.numpy())
          and launches["gather_rows"] == 1,
          "pull_sparse_differentiable on the card: forward or backward "
          "differs from its plain version, or launches %s" % launches)
    idx = ids.to(torch.int64)
    lib = torch.zeros_like(slab)
    lib[:, acc.EMBED_W].index_add_(0, idx, d_out[:, 2])
    lib[:, layout.embedx_w:layout.embedx_w + 8].index_add_(0, idx,
                                                           d_out[:, 3:])
    rec = {"ids": PULL_IDS, "distinct": int(np.unique(ids_np).size),
           "slab": list(slab.shape), "launches": launches,
           "index_add_max_abs_err": float((lib - slab.grad).abs().max())}
    # negative ids (ROADMAP C3): every third id moved into [-C, 0) (row C
    # + id, as JAX's indexing reads it), every seventh from the second on
    # below -C, one at the int32 minimum; the forward and the slab
    # gradient equal the CPU's, and the kernel on the raw ids (no wrap:
    # its lower clamp) equals its plain version
    C = slab.shape[0]
    neg_np = ids_np.copy()
    neg_np[::3] -= C
    below = neg_np[1::7].size
    neg_np[1::7] = -C - 1 - rng.randint(0, C, below)
    neg_np[2] = np.iinfo(np.int32).min
    neg = torch.from_numpy(neg_np).to(dev)
    slab.grad = None
    reset_counts()
    out = pull_sparse_differentiable(slab, neg, layout)
    out.backward(d_out)
    raw = gather_rows(slab.detach(), neg)
    torch.cuda.synchronize()
    neg_launches = counts()
    host = slab.detach().cpu()
    check(bits_equal(out.detach().cpu().numpy(),
                     pull_sparse(host, neg.cpu(), layout).numpy())
          and bits_equal(slab.grad.cpu().numpy(), pull_view_grad(
              neg.cpu(), d_out.cpu(), tuple(slab.shape), layout).numpy())
          and bits_equal(raw.cpu().numpy(),
                         gather_rows_plain(slab.detach(), neg).cpu().numpy())
          and neg_launches["gather_rows"] == 2,
          "pull_sparse_differentiable at negative ids on the card: forward, "
          "backward or the raw gather differs from the CPU's, or launches "
          "%s" % neg_launches)
    rec["negative_ids"] = {"wrapped": int(((neg_np < 0)
                                           & (neg_np >= -C)).sum()),
                           "below": int((neg_np < -C).sum()),
                           "launches": neg_launches}
    log("demo pull_sparse_differentiable: forward and backward bit-equal "
        "to their plain versions, at negative ids to the CPU's; %s"
        % json.dumps(rec))
    return rec


def demo_reader_check(feed, files, smi):
    """(c) the reader pool on the main path's files."""
    import hashlib

    from paddlebox_tpu_torch import cadence_probe
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    digests, secs = {}, {1: [], 4: []}
    for c in READ_ORDER:
        n = 1 if c == "a" else 4
        cadence_probe.settle()
        calls = []
        ds = BoxDataset(feed, read_threads=n)
        ds.set_filelist(files)
        t0 = time.perf_counter()
        ds.load_into_memory(add_keys_fn=calls.append)
        secs[n].append(time.perf_counter() - t0)
        b = ds.block
        h = hashlib.sha256()
        for a in [b.keys, b.key_slot, b.labels, b.rec_offsets] + calls:
            h.update(a.tobytes())
        digests.setdefault(n, set()).add(h.hexdigest())
        ds.release_memory()
    check(len(digests[1] | digests[4]) == 1, "read_threads=4 loads "
          "differ from read_threads=1: %s" % digests)
    rec = {"files": len(files), "order": READ_ORDER,
           "load_s": {str(k): v for k, v in secs.items()},
           "sha256": sorted(digests[1])[0]}
    log("demo reader pool on the main path's files: read_threads 4 = 1 "
        "byte for byte; one call, no claim: %s; card %s"
        % (json.dumps(rec), smi))
    return rec


def demos_phase(torch, feed, files, tmp, writer, smi):
    """Phase 30 (module docstring). Returns the launches and records."""
    root = os.path.join(tmp, "demos")
    os.makedirs(root)
    t0 = time.perf_counter()
    launched = [(name, want) + launch_demo(name, args, root)
                for name, args, want in LAUNCHED_DEMOS]
    cpu_ctr = writer.submit(demo_ctr_cpu, os.path.join(root, "ctr_cpu"))
    old_tmp = tempfile.tempdir
    tempfile.tempdir = root
    try:
        from paddlebox_tpu_torch.examples import (serve_xbox,
                                                  stream_train_serve,
                                                  train_aux_input,
                                                  train_downpour)
        out = {"train_ctr": {}}
        for write in ("auto", "rebuild"):
            out["train_ctr"][write] = demo_ctr_card(
                torch, os.path.join(root, "ctr_" + write), write,
                reset_counts, counts)
        cpu = cpu_ctr.result()
        check(cpu["push_write"] == "scatter", "the CPU demo's write %s"
              % cpu["push_write"])
        for rec in out["train_ctr"].values():
            demo_ctr_against_cpu(rec, cpu)
        out["pull_sparse_differentiable"] = demo_pull_check(
            torch, torch.device("cuda"))
        out["reader"] = demo_reader_check(feed, files, smi)
        launches = {}
        for name, fn, argv, want in (
                ("train_aux_input", train_aux_input.main, ["--passes", "2"],
                 ("pass 1: loss=", "aux rows served: 17 items, dim 8")),
                ("train_downpour", train_downpour.main, ["--passes", "2"],
                 ("pass 1: loss=", "eval AUC:")),
                ("serve_xbox", serve_xbox.main, ["--passes", "2"],
                 ("serving view:", "feasign", "oracle parity OK",
                  "delta refresh: day1 SaveDelta visible")),
                ("stream_train_serve", stream_train_serve.main, [],
                 ("seed micro-pass", "micro-pass",
                  "ingest-to-serve freshness"))):
            reset_counts()
            _, printed = demo_quiet(fn, argv)
            launches[name] = counts()
            demo_lines(name, printed, want)
            check(launches[name]["gather_rows"] > 0, "demo %s launched no "
                  "gather_rows: %s" % (name, launches[name]))
        for name, want, proc, path in launched:
            demo_lines(name, wait_demo(name, proc, path, t0), want)
    finally:
        tempfile.tempdir = old_tmp
        for _, _, proc, _ in launched:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["launches"] = launches
    log("demos phase: %s" % json.dumps({"launches": launches,
                                        "seconds": time.perf_counter()
                                        - t0}))
    return out


# phase 31: the no-CVM main path (train/flagship.py FLAGSHIP_NO_CVM)
NO_CVM_RUNS = 2              # its runs on the card, held bit-identical
NO_CVM_LOSS_RTOL = 1e-4      # card against CPU, phase 3's limits
NO_CVM_AUC_ATOL = 1e-4


def no_cvm_cpu(files, feed):
    """Phase 31's two passes on the CPU (in the spawned writer)."""
    from paddlebox_tpu_torch.train import flagship
    t0 = time.perf_counter()
    trainer, ds = flagship.build_trainer(files, feed,
                                         flagship.FLAGSHIP_NO_CVM,
                                         "scatter", "cpu")
    out = []
    for _ in range(2):
        res = trainer.train_pass(ds)
        out.append({"loss": float(res["loss"]), "auc": float(
            trainer.metrics.get_metric_msg("auc")["auc"])})
    return {"passes": out, "seconds": time.perf_counter() - t0}


def no_cvm_pool_check(torch, trainer, files, feed):
    """At one step of the no-CVM trainer on a seeded flagship slab: the
    step's pooled tensor (its pull and forward stages) equals columns 2:
    of the CVM pool of the same pulled rows, bit for bit."""
    import numpy as np

    from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm
    from paddlebox_tpu_torch.train import flagship
    cfg = flagship.FLAGSHIP_NO_CVM
    b, ids = flagship.first_batch(files, feed, cfg)
    layout = trainer.table.layout
    rows = np.random.RandomState(31).rand(cfg.capacity, layout.width)
    slab = device_slab(torch, rows.astype(np.float32), layout,
                       trainer.device)
    batch = trainer.device_batch(b, ids)
    pull, fwd_bwd = trainer.step_stages[:2]
    st = pull(slab, batch)
    fwd_bwd(st, batch)
    with torch.no_grad():
        cvm = fused_seqpool_cvm(st["emb"], batch["segments"], st["valid"],
                                cfg.batch, cfg.num_slots, True,
                                sorted_segments=True,
                                n_valid=batch["n_valid"])
    torch.cuda.synchronize()
    pooled = st["pooled"].detach()
    check(tuple(pooled.shape) == (cfg.batch, cfg.num_slots, 1 + cfg.embedx)
          and bits_equal(pooled.cpu().numpy(), cvm[..., 2:].cpu().numpy()),
          "no-CVM pool %s differs from the CVM pool's columns 2:"
          % (tuple(pooled.shape),))
    return {"pooled": list(pooled.shape), "cvm_pooled": list(cvm.shape),
            "n_valid": batch["n_valid"]}


def no_cvm_phase(torch, feed, files, writer, smi):
    """Phase 31 (module docstring). Returns its runs, launches and the
    CPU's passes."""
    from paddlebox_tpu_torch.train import flagship
    cfg = flagship.FLAGSHIP_NO_CVM
    t0 = time.perf_counter()
    cpu_run = writer.submit(no_cvm_cpu, files, feed)
    runs = []
    for r in range(NO_CVM_RUNS):
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        check(trainer.use_cvm is False
              and trainer.model.spec.slot_dim == 1 + cfg.embedx
              and not trainer.model.use_data_norm,
              "the no-CVM trainer pools with CVM or runs data_norm")
        reset_counts()
        passes = main_passes(torch, trainer, ds)
        launches = counts()
        steps = sum(p["batches"] for p in passes)
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        check(launches == f32_launches(push_adagrad=steps,
                                       gather_rows=steps + extra),
              "no-CVM run %d launches %s over %d steps, %d promotes and "
              "write-backs" % (r, launches, steps, extra))
        for p in passes:
            log("no-CVM run %d pass %d: loss %.10f auc %.10f %s"
                % (r, p["pass"], p["loss"], p["auc"], json.dumps(p)))
        runs.append({"passes": passes, "launches": launches,
                     "store": store_sha(trainer.table)})
        if r == NO_CVM_RUNS - 1:
            pool = no_cvm_pool_check(torch, trainer, files, feed)
        del trainer, ds
    first = runs[0]
    for r, run in enumerate(runs[1:], start=1):
        check([(p["loss"], p["auc"]) for p in run["passes"]]
              == [(p["loss"], p["auc"]) for p in first["passes"]]
              and run["store"] == first["store"]
              and run["launches"] == first["launches"],
              "no-CVM run %d differs from run 0" % r)
    cpu = cpu_run.result()
    for p, c in zip(first["passes"], cpu["passes"], strict=True):
        check(abs(p["loss"] - c["loss"]) <= NO_CVM_LOSS_RTOL * abs(c["loss"])
              and abs(p["auc"] - c["auc"]) <= NO_CVM_AUC_ATOL,
              "no-CVM pass %d on the card loss %r auc %r, on the CPU %r %r"
              % (p["pass"], p["loss"], p["auc"], c["loss"], c["auc"]))
    rec = {"launches": first["launches"], "store_sha256": first["store"],
           "card": [{"loss": p["loss"], "auc": p["auc"],
                     "pass_s": p["pass_s"]} for p in first["passes"]],
           "cpu": cpu["passes"], "cpu_s": cpu["seconds"], "pool": pool,
           "seconds": time.perf_counter() - t0}
    log("no-CVM main path: %d runs bit-identical, within loss rtol %g and "
        "AUC %g of the CPU; %s; card %s" % (NO_CVM_RUNS, NO_CVM_LOSS_RTOL,
                                             NO_CVM_AUC_ATOL,
                                             json.dumps(rec), smi))
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2

    from paddlebox_tpu_torch import rate_probe
    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding.native_store import \
        NativeHostEmbeddingStore
    from paddlebox_tpu_torch.native import host_lib
    from paddlebox_tpu_torch.native.build import build_kernels
    from paddlebox_tpu_torch.train import flagship

    # 1. the card
    smi = card_line()
    props = torch.cuda.get_device_properties(0)
    log("card:", smi)
    log("torch %s cuda %s device %s sm_%d%d, %d SMs, %.1f GiB"
        % (torch.__version__, torch.version.cuda, props.name, props.major,
           props.minor, props.multi_processor_count,
           props.total_memory / 2**30))

    # 2. build: the kernels (one nvcc a source, in parallel) while a thread
    # builds the host library (g++) and a process of its own writes the
    # synthetic files (the generator is bound to the interpreter); phases 3
    # and 10 need none of them and run before they are waited for
    clock = PhaseClock()
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            ProcessPoolExecutor(1, mp_context=spawn) as writer:
        cfg = flagship.FLAGSHIP
        # the cadence's files, written once; the main path's are the first
        # pass's
        t_data = time.perf_counter()
        written = writer.submit(flagship.write_cadence,
                                os.path.join(tmp, "full"), cfg)
        # the zoo's hybrid files (phase 15: it trains on the first window
        # and tests on the third), after the cadence's
        zoo_written = writer.submit(flagship.write_cadence,
                                    os.path.join(tmp, "zoo"),
                                    flagship.FLAGSHIP_CTR_DNN)
        # the aux configuration's ins_id files (phase 16)
        aux_written = writer.submit(flagship.write_files,
                                    os.path.join(tmp, "aux"),
                                    flagship.FLAGSHIP_AUX)
        # the behavior-sequence configuration's files (phase 17)
        bst_written = writer.submit(flagship.write_files,
                                    os.path.join(tmp, "bst"),
                                    flagship.FLAGSHIP_BST)
        host = {}

        def build_host():
            try:
                t0 = time.perf_counter()
                host["path"] = host_lib.build_host_lib()
                host_lib.host_lib()
                host["s"] = time.perf_counter() - t0
            except BaseException as e:   # raised on the main thread
                host["error"] = e

        host_build = threading.Thread(target=build_host, name="smoke-g++")
        host_build.start()
        t0 = time.perf_counter()
        paths = build_kernels(verbose=True)
        log("built %s in %.2f s" % (sorted(paths), time.perf_counter() - t0))
        host_build.join()
        if "error" in host:
            raise host["error"]
        log("built the host library %s in %.2f s" % (host["path"], host["s"]))
        clock.lap("build")

        # 3. small-input parity, on small files of its own
        small_parity_phase(torch, tmp)
        clock.lap("small_parity")

        # 10. the rate probe, which needs none of the flagship's files
        reset_counts()
        probe = rate_probe.run("cuda")
        probe_counts = counts()
        check(probe_counts["scale_copy"] > 0
              and probe_counts["gather_rows"] > 0
              and probe_counts["push_adagrad"] == 0
              and probe_counts["blocked_write"] == 0,
              "rate probe launches %s" % probe_counts)
        log("rate probe launches %s over %d cases"
            % (probe_counts, len(probe)))
        clock.lap("rate_probe")

        t0 = time.perf_counter()
        windows, feed = written.result()
        waited = time.perf_counter() - t0
        files = windows[0]
        keys = [flagship.sorted_pass_keys(w, feed) for w in windows]
        log("synthetic data: %d files x %d lines, three passes of %d files "
            "(%s keys), %.2f s after they were started, %.2f s of it waited "
            "for after phase 10" % (2 * cfg.num_files, cfg.lines_per_file,
                                    cfg.num_files, [k.size for k in keys],
                                    time.perf_counter() - t_data, waited))
        clock.lap("data")

        # 4. kernels against their plain versions
        dev = torch.device("cuda")
        kernels = kernel_phase(torch, cfg, feed, files, dev)
        row_errs, gather_shapes = row_kernel_phase(torch, cfg, feed, files,
                                                   keys, dev)
        clock.lap("kernels")

        # 5. the main path at full width
        trainer, ds = flagship.build_trainer(files, feed, cfg, "scatter",
                                             "cuda")
        reset_counts()
        passes = main_passes(torch, trainer, ds)
        main_counts = counts()
        for p in passes:
            log("main path pass %d: loss %.10f auc %.10f %s"
                % (p["pass"], p["loss"], p["auc"], json.dumps(p)))
        check(ds.columnar and isinstance(trainer.table.store,
                                         NativeHostEmbeddingStore)
              and trainer.table.route_index is not None,
              "the main path did not run on the native host tier")
        digits = {"loss": tuple("%.10f" % p["loss"] for p in passes),
                  "auc": tuple("%.10f" % p["auc"] for p in passes)}
        check(digits == FLAGSHIP_DIGITS, "main path digits %s, expected %s"
              % (digits, FLAGSHIP_DIGITS))
        steps = sum(p["batches"] for p in passes)
        # the first pass builds the slab in full, the second promotes every
        # row on the device; both write back every row
        n = int(keys[0].size)
        want = expected_counters([keys[0], keys[0]])
        for p, w in zip(passes, want):
            check(p["counters"] == w, "main path pass %d counters %s, "
                  "expected %s" % (p["pass"], p["counters"], w))
        extra = sum(gather_launches_of(p["counters"]) for p in passes)
        check(main_counts["push_adagrad"] == steps,
              "push_adagrad launched %d times over %d steps"
              % (main_counts["push_adagrad"], steps))
        check(extra == 3 and main_counts["gather_rows"] == steps + extra,
              "gather_rows launched %d times over %d steps, %d promotes and "
              "write-backs" % (main_counts["gather_rows"], steps, extra))
        check(main_counts["blocked_write"] == 0
              and main_counts["scale_copy"] == 0,
              "blocked_write or scale_copy launched on the scatter path")
        log("main path launches %s over %d steps, 1 delta promote of %d "
            "rows and 2 touched-row write-backs, on the native host tier "
            "(columnar dataset, %s, route index)"
            % (main_counts, steps, n, type(trainer.table.store).__name__))
        # phase 9 holds its runs to this one; the day phase goes on from
        # this trainer
        main_run = {"passes": passes, "launches": main_counts,
                    "store": sorted_store(trainer.table)}
        # phase 22 holds its world-1 sharded run to this store
        main_sha = store_sha(trainer.table)
        # phase 29 holds its train-to-serve run to this one, delta scores
        # aside
        main_trained = trained_sha(trainer.table)
        main_trainer = trainer
        del trainer, ds
        plain_passes = plain_tier_phase(torch, cfg, feed, files, passes,
                                        main_run["store"])

        clock.lap("main_path")
        # 6. the incremental cadence at full width, in every mode
        cadence = cadence_phase(torch, cfg, feed, windows, keys,
                                reset_counts, counts)
        clock.lap("cadence")

        # 7. the day: test pass, run_day, load_base, xbox, resume
        day = day_phase(torch, main_trainer, cfg, feed, windows, tmp,
                        reset_counts, counts)
        del main_trainer
        clock.lap("day")

        # 8. blocked mode vs scatter, same seed, bit-identical rows
        blocked_counts = blocked_phase(torch, cfg, feed, files)
        clock.lap("blocked")
        # 9. the chunk driver: per step against chunked, chunk sync, the
        # kernels at the chunk shape, the pass's copies by kind
        chunks = chunk_phase(torch, cfg, feed, files, main_run, reset_counts,
                             counts)
        chunk_shapes = chunk_kernel_phase(torch, cfg, feed, files, dev)
        clock.lap("chunk_driver")

        # 11. recovery: RecoverableRunner with the journal on and off,
        # interrupted and resumed
        recovery = recovery_phase(torch, cfg, feed, windows, keys, tmp,
                                  reset_counts, counts)
        clock.lap("recovery")

        # 12. the bf16 slab diet: the 2-byte kernel forms, the bf16 main
        # path, its blocked pass and dense bf16
        kernels16 = bf16_kernel_phase(torch, cfg, feed, files, keys, dev)
        bf16 = bf16_phase(torch, feed, files, passes, reset_counts, counts)
        clock.lap("bf16")

        # 13. the host planes on and off, the main path bit-identical
        planes = planes_phase(torch, cfg, feed, files, main_run,
                              reset_counts, counts, tmp)
        del main_run
        clock.lap("planes")

        # 14. the other in-table rules and the expand block: their push
        # forms and the pull at their widths, their passes at full width
        rule_kernels, rule_pull = rules_kernel_phase(torch, cfg, feed,
                                                     files, dev)
        rules = rules_phase(torch, feed, files, windows, reset_counts,
                            counts)
        clock.lap("rules")

        # 15. the model zoo's dense and multi-task heads at full width
        zoo_windows, zoo_feed = zoo_written.result()
        zoo = zoo_phase(torch, zoo_windows, zoo_feed, passes, reset_counts,
                        counts, writer)
        clock.lap("zoo")

        # 16. the join phase's record-path feeds at full width
        aux_files, aux_feed = aux_written.result()
        join = join_phase(torch, files, feed, aux_files, aux_feed, passes,
                          reset_counts, counts, tmp)
        clock.lap("join")

        # 17. the behavior-sequence model, the seqpool variants and the
        # dense optimizers sgd and adagrad at full width
        bst_files, bst_feed = bst_written.result()
        seq = seq_phase(torch, files, feed, bst_files, bst_feed, passes,
                        reset_counts, counts, tmp)
        clock.lap("seq")

        # 18. the push write modes rebuild and auto, the uid, delta and
        # ids-only wires, the metric kinds nan_inf and continue
        wires = wires_phase(torch, files, feed, reset_counts, counts)
        clock.lap("wires")

        # 19. the SSD tier (FLAGSHIP_SSD over the cadence, against the
        # untiered full rebuild) and the async dense table (FLAGSHIP_ASYNC)
        tier = tier_phase(torch, windows, feed, tmp, reset_counts, counts)
        async_dense = async_runs(torch, files, feed, reset_counts, counts)
        clock.lap("tier_async")

        # 20. the streaming runner over the cadence's 8 files and a
        # poisoned window, the single-process obs tiers
        stream = stream_phase(torch, windows[0] + windows[2], feed, tmp,
                              reset_counts, counts)
        clock.lap("stream")

        # 21. the single-process host modules: the env flags, the archive
        # spill, the pipe, the dump, the profiled pass, the table's pull
        # and push, the AUC runner, lockwatch, and a trace in a child
        slice21 = slice21_phase(torch, cfg, feed, files, tmp, reset_counts,
                                counts)
        clock.lap("slice21")

        # 22. the sharded trainer at world 1 over NCCL in a child process,
        # held to the main path's run
        sharded = sharded_phase(torch, files, feed, passes, main_sha, tmp,
                                spawn, windows, bst_files, bst_feed, tier,
                                stream)
        clock.lap("sharded")

        # 29. train to serve: the serving plane over phase 7's day, over a
        # live trainer's deltas, as a 2 x 2 fleet and fed by phase 20's
        # journal
        serve = serve_phase(torch, cfg, feed, files, tmp, passes,
                            main_trained, reset_counts, counts, smi)
        clock.lap("serve")

        # 30. the user entry points: the eight demos on the card
        demos = demos_phase(torch, feed, files, tmp, writer, smi)
        clock.lap("demos")

        # 31. the no-CVM main path: FLAGSHIP_NO_CVM's two passes, twice on
        # the card and once on the CPU, and its pool against CVM's
        no_cvm = no_cvm_phase(torch, feed, files, writer, smi)
        clock.lap("no_cvm")

    kernels += row_kernel_records(probe, row_errs, gather_shapes,
                                  cfg)

    launches = {"push_adagrad": main_counts["push_adagrad"],
                "blocked_write": blocked_counts["blocked_write"],
                "scale_copy": probe_counts["scale_copy"],
                "gather_rows": main_counts["gather_rows"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in chunk_shapes:
            k.setdefault("at_shapes", {})["chunk"] = chunk_shapes[k["name"]]
    # the 2-byte forms: the bf16 main path's launches (the placement's from
    # its blocked pass)
    for k in kernels16:
        k["launches"] = (bf16["blocked"] if k["name"] == "blocked_write_2byte"
                         else bf16["launches"])[k["name"]]
    kernels += kernels16
    # the forms of the other rules and the expand block: their passes'
    # launches (phase 14); the pull's new widths beside gather_rows' shapes
    for k in rule_kernels:
        k["launches"] = rules["forms"][k["name"]]
    kernels += rule_kernels
    for k in kernels:
        if k["name"] == "gather_rows":
            k.setdefault("at_shapes", {}).update(rule_pull)
    # BST's shapes (phase 17): the sequence pull and the concatenated push,
    # with the BST passes' launches
    for k in kernels:
        if k["name"] in seq["kernels"]:
            k.setdefault("at_shapes", {})["bst"] = dict(
                seq["kernels"][k["name"]],
                launches=seq["bst"]["launches"][k["name"]])
    # the rebuild write's gather (phase 18), with its runs' launches
    for k in kernels:
        if k["name"] == "gather_rows":
            k["at_shapes"]["rebuild"] = wires["gather_rebuild"]
    # the world-1 shard shapes (phase 22), with its passes' launches
    for k in kernels:
        if k["name"] in sharded["kernels"]:
            k.setdefault("at_shapes", {})["shard_world1"] = dict(
                sharded["kernels"][k["name"]],
                launches=sharded["launches"][k["name"]])
    # phase 23's shard shapes, with its runs' launches
    p23 = sharded["phase23"]
    k23 = p23["kernels"]
    at23 = {"blocked_write": [("shard_blocked", k23["blocked_write"],
                               p23["exact"]["blocked"])],
            "gather_rows": [("shard_rebuild_gather", k23["rebuild_gather"],
                             p23["exact"]["rebuild"]),
                            ("shard_pull_w82", k23["expand_pull"],
                             p23["expand"])],
            "push_adagrad_expand": [("shard_expand", k23["expand_push"],
                                     p23["expand"])]}
    for k in kernels:
        for shape, rec, run in at23.get(k["name"], ()):
            k.setdefault("at_shapes", {})[shape] = dict(
                rec, launches=run["launches"][k["name"]])
    # phase 24's shard shapes, with its runs' launches
    p24 = sharded["phase24"]
    at24 = {"gather_rows": ("shard_tablewise_pull", p24["table_wise"]),
            "push_adagrad": ("shard_hot_push", p24["grid_hot"])}
    for k in kernels:
        if k["name"] in at24:
            shape, run = at24[k["name"]]
            k.setdefault("at_shapes", {})[shape] = dict(
                p24["kernels"][k["name"]],
                launches=run["launches"][k["name"]])
    # phase 25's new shape: Downpour's per-batch slab, with its run's
    # launches
    p25 = sharded["phase25"]
    for k in kernels:
        if k["name"] == "gather_rows":
            k["at_shapes"]["downpour_slab"] = dict(
                p25["downpour"][0]["kernel"],
                launches=p25["downpour"][0]["launches"]["gather_rows"])
    # phase 27's step shape: the pipeline's group, with its runs' launches
    p27 = sharded["phase27"]
    for k in kernels:
        if k["name"] in ("gather_rows", "push_adagrad"):
            k.setdefault("at_shapes", {})["pipeline_step"] = dict(
                p27["kernels"][k["name"]],
                launches=p27["ctr"][0]["launches"][k["name"]])
        if k["name"] in ("gather_rows", "push_adagrad_expand"):
            k.setdefault("at_shapes", {})["pipeline_expand"] = dict(
                p27["kernels_expand"][k["name"]],
                launches=p27["expand"][0]["launches"][k["name"]])
    # phase 28's step shapes: the sharded pipeline's served ids and
    # received rows, the rebuild map, the expand-64 step, with their runs'
    # launches ((a), the blocked and rebuild passes', (c)'s)
    p28 = sharded["phase28"]
    k28, w28 = p28["kernels"], p28["writes"]
    at28 = {"gather_rows": [
                ("pipeline_shard_step", k28["gather_rows"], p28["runs"][0]),
                ("pipeline_shard_rebuild", k28["rebuild_gather"],
                 w28["rebuild"]),
                ("pipeline_shard_expand", p28["kernels_expand"]["gather_rows"],
                 p28["expand"])],
            "push_adagrad": [("pipeline_shard_step", k28["push_adagrad"],
                              p28["runs"][0])],
            "blocked_write": [("pipeline_shard_step", k28["blocked_write"],
                               w28["blocked"])],
            "push_adagrad_expand": [
                ("pipeline_shard_expand",
                 p28["kernels_expand"]["push_adagrad_expand"],
                 p28["expand"])]}
    for k in kernels:
        for shape, rec, run in at28.get(k["name"], ()):
            k.setdefault("at_shapes", {})[shape] = dict(
                rec, launches=run["launches"][k["name"]])
    # phase 29's live trainer: the main path's shapes, its passes' launches;
    # phase 30's train_ctr demo at its defaults and at rebuild; phase 31's
    # no-CVM main path
    for k in kernels:
        if k["name"] in ("gather_rows", "push_adagrad"):
            k["path_launches"] = {
                "train_to_serve": serve["live"]["launches"][k["name"]],
                "train_to_serve_stream":
                    serve["journal"]["launches"][k["name"]],
                **{"demo_train_ctr_" + w: r["launches"][k["name"]]
                   for w, r in demos["train_ctr"].items()},
                "no_cvm": no_cvm["launches"][k["name"]]}
    log(json.dumps({"paths": {"scatter": main_counts,
                              "blocked": blocked_counts,
                              "rate_probe": probe_counts,
                              **{"cadence_" + m: c["launches"]
                                 for m, c in cadence.items()},
                              "test_pass": day["test_pass"]["launches"],
                              "day": day["launches"],
                              "chunk_sync": chunks["sync"]["launches"],
                              **{"recovery_%d" % r["run"]: r["launches"]
                                 for r in recovery["runs"]},
                              "bf16": bf16["launches"],
                              "bf16_blocked": bf16["blocked"],
                              "dense_bf16": bf16["dense"]["launches"],
                              **{"planes_%s_%d" % (r["mode"], i):
                                 r["launches"]
                                 for i, r in enumerate(planes["runs"])},
                              **{"rules_" + n: c
                                 for n, c in rules["launches"].items()},
                              "rules_blocked": rules["blocked"],
                              "expand_test_pass":
                                  rules["test_pass"]["launches"],
                              **{"zoo_" + n: c
                                 for n, c in zoo["launches"].items()},
                              "zoo_mmoe_blocked": zoo["mmoe_blocked"],
                              "zoo_esmm_sync": zoo["esmm_sync"]["launches"],
                              "zoo_esmm_test_pass":
                                  zoo["test_pass"]["launches"],
                              "zoo_ctr_dnn_bf16":
                                  zoo["ctr_dnn_bf16"]["launches"],
                              **{"join_" + n: join[n]["launches"]
                                 for n in ("join_pv", "aux",
                                           "aux_replica")},
                              **{"seq_" + n: seq[n]["launches"]
                                 for n in ("bst", "sgd", "dense_adagrad")},
                              **{"wires_" + n.replace(" ", "_"):
                                 r["launches"]
                                 for n, r in wires["runs"].items()},
                              **{"wires_sync_" + n: r["launches"]
                                 for n, r in wires["sync"].items()},
                              **{"tier_" + n: c
                                 for n, c in tier["launches"].items()},
                              **{"async_" + n: async_dense[n]["launches"]
                                 for n in ("async", "scan_chunk_1",
                                           "drained_0", "drained_1")},
                              "stream": stream["launches"],
                              **{"slice21_" + n: slice21[n]["launches"]
                                 for n in ("text", "archive", "pipe",
                                           "dumped", "profiled")},
                              "slice21_env_blocked":
                                  slice21["env_blocked"],
                              "sharded_world1": sharded["launches"],
                              **{"sharded23_" + n.replace(" ", "_"):
                                 r["launches"]
                                 for n, r in p23["exact"].items()},
                              **{"sharded23_" + n: p23[n]["launches"]
                                 for n in ("zero1", "bf16_a2a", "expand",
                                           "collect_host",
                                           "collect_device")},
                              **{"sharded24_" + n: p24[n]["launches"]
                                 for n in ("table_wise", "grid_hot")},
                              "sharded24_shuffled":
                                  p24["shuffle"]["runs"][0]["launches"],
                              "sharded25_ssd": p25["ssd"]["launches"],
                              **{"sharded25_ps_" + r["label"]: r["launches"]
                                 for r in p25["ps"]},
                              "sharded25_downpour":
                                  p25["downpour"][0]["launches"],
                              **{"sharded25_seq_%s%s" % (
                                  r["attn"], "_sp" if r["group"] else ""):
                                 r["launches"] for r in p25["seq"]},
                              "sharded26_stream":
                                  sharded["phase26"]["stream"]["launches"],
                              **{"tower26_" + n: t["runs"][0]["launches"]
                                 for n, t in
                                 sharded["phase26"]["towers"].items()},
                              **{"tower26_tp_deepfm_" + w: r["launches"]
                                 for w, r in
                                 sharded["phase26"]["writes"].items()},
                              "heter26":
                                  sharded["phase26"]["heter"][0]["launches"],
                              "pipe27_ctr": p27["ctr"][0]["launches"],
                              "pipe27_mesh": p27["mesh"]["launches"],
                              "pipe27_expand":
                                  p27["expand"][0]["launches"],
                              "pipe28_sharded": p28["runs"][0]["launches"],
                              **{"pipe28_" + w: r["launches"]
                                 for w, r in p28["writes"].items()},
                              "pipe28_expand": p28["expand"]["launches"],
                              "pipe28_section_ps": p28["ps"]["launches"],
                              "serve29_live": serve["live"]["launches"],
                              "serve29_stream":
                                  serve["journal"]["launches"],
                              **{"demo30_train_ctr_" + w: r["launches"]
                                 for w, r in demos["train_ctr"].items()},
                              **{"demo30_" + n: c for n, c in
                                 demos["launches"].items()},
                              "demo30_pull_sparse_differentiable":
                                  demos["pull_sparse_differentiable"][
                                      "launches"],
                              "demo30_pull_negative_ids":
                                  demos["pull_sparse_differentiable"][
                                      "negative_ids"]["launches"],
                              "no_cvm31": no_cvm["launches"]},
                    "h2d_copies_chunked_pass": chunks["profile"][
                        "h2d_copies"],
                    "passes": passes, "plain_host_passes": plain_passes}))
    log("phase seconds: %s" % json.dumps(clock.laps))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
