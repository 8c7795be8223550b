#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Drives `agnes_tpu_torch` (never the JAX package) on the card:

  1. prints the card and its power limit; builds every CUDA kernel from
     `agnes_tpu_torch/csrc/` with nvcc (one process per source, started
     together, beside them the chain kernels of
     `agnes_tpu_torch/scripts/verify_probe.cu` for a latency floor) and
     prints the build time and `ptxas` registers/spills (each kernel's
     line of the JSON output carries its `registers`, `stack_bytes` and
     `spill_bytes`);
  2. holds the Ed25519 verify kernel (window 5) against its plain
     PyTorch version on the card, lane for lane: the adversarial grid and
     the torsioned case (both also against the RFC 8032 oracle
     `ed25519_ref.verify`) plus 4,096 random honest and forged lanes;
  2b. holds the other kernels against their plain versions on the card:
     the pow kernel limb for limb on 4,096 random weak lanes plus edge
     values at e = (p-5)/8 and p-2 (its two addition chains) and 65,537
     (its fixed windows); the Straus
     kernel on 4,197 lanes (the edge scalars s = 0, 1, L-1, 2^260-1
     against k = 0, 1, 2^260-1, A with an order-4 component, warps that
     mix k = 0 and k != 0, a warp of all k = 0, then random scalars
     below L and A from the fixture's keys), by group equality with the plain
     version (`point_equal`) and X Y = Z T, and on a sample by the RFC
     8032 oracle's encoding of [s]B - [k]A (the kernel's projective
     representative differs from the plain version's by design); and the
     window-4 verify kernel on the grid plus 4,096 random lanes (the grid
     also against the oracle); `verify_batch(window=4)`, the window-4
     kernel's public entry, is driven once with its launch count;
  2c. holds the BLS12-381 field kernels (multiply, reduce) against their
     plain versions on the card, limb for limb, at every group size, on
     the boundary values 0, 1, p-1, p, 4p-1 and random rows, the reduce
     at 1 and 2 carry passes, and times both (`bls_fp_probe.device_ms`)
     at a G2 add's stack at rung 1,024 (18,432 rows) and at 1,048,576
     rows; after
     phase 6 also at every row count the lane launched them with
     (`BlsFp`).  With `--parent-csrc DIR` (the `csrc/` of an earlier
     checkout) each shape also times that checkout's kernels where its
     `bls_fp.cu` differs from this tree's (the limbs-first design of
     `bls_fp_probe.ParentKernels`), which must give the same limbs.  An
     earlier checkout's pow and Straus kernels are timed by running that
     checkout's own `chip_smoke.py` in the same chip call;
  2d. runs the layout microbenchmark's own path
     (`agnes_tpu_torch.scripts.microbench_layout.main`: its six rows at
     T = 16,384 lanes, N_CHAIN 64 and 128, the fe13_chain kernel timed
     by CUDA events) with the kernel's launches counted, then holds the
     kernel against its plain version element for element on each row's
     inputs and on two cases whose columns wrap int32 (limbs near 2^15,
     and the whole int32 range), and times the plain version per row
     beside the kernel and its bound (`chain_phase`);
  3. one signed consensus height at full width — I = 1,024 instances x
     V = 1,000 validators, an entry phase plus a prevote and a precommit
     class, 2,048,000 signed lanes with validator 7 forged in both
     classes — through VoteBatcher.add_arrays -> build_phases_device ->
     DeviceDriver.step_seq_signed; every instance must decide value 7 in
     round 0 with exactly 2 x I rejected lanes, and the verify kernel's
     launch count over this run must be above zero.  The fixture's
     columns are built before the timed window.  The step's device
     workspace a lane ((peak - allocated before the step) / lanes) is
     measured and must stay within the planner's constant
     (`utils/budget.py::VERIFY_WORKSPACE_LANE_BYTES`).  The step is then
     repeated on a fresh driver (same decisions) to time it warm; with
     `verify_chunk="auto"` under a budget forced small enough for 4
     chunks (4 verify launches, the same decisions and rejected lanes as
     unchunked); and as two back-to-back signed `step_async` dispatches
     under `torch.cuda.set_sync_debug_mode("error")`, which collected
     must equal two `step_seq_signed` calls stat for stat and leaf for
     leaf (`signed_variants`).  The prologue is timed alone, and the
     kernel and its plain version are timed on this run's 2,048,000
     lanes and compared on all of them;
  3n. the signed height at the north-star shape, I = 10,000 x V = 1,000
     (20,000,000 lanes, validator 7 forged in both classes), built as
     phase 3 builds it, stepped by `DeviceDriver(..., verify_chunk=
     "auto")`: every instance must decide 7 in round 0 with 2 x I
     rejected lanes and advance to height 1; the verify kernel must be
     launched exactly `plan.n_chunks` times, the plan being
     `utils.budget.plan_lane_verify` on the card's memory, and the
     step's peak device memory must stay within `plan.peak_bytes`.  It
     logs the plan, the wall, `add_arrays`, `build_phases_device` and
     the step, votes/s, the step's peak, the host's peak RSS and the
     card.  The step is repeated under half the card's memory
     (`hbm_budget_bytes`), where the plan has more than one chunk: one
     launch a chunk, the peak within that plan, the same decisions.
     Then the prologue and the kernel chunk by chunk at the plan's tile
     (the step's own launch shape) by CUDA events; the verdicts of those
     launches, and of the first chunk at half the card's tile, are held
     against the plain version on the lanes of a 131,072-lane sample,
     256 forged lanes among them (`north_star_phase`);
  4. four unsigned honest heights at I = 10,000 x V = 1,000
     (run_heights_fused): every instance must decide four heights;
  5. the MSM batch-verify path at full validator width: I = 64 x
     V = 1,000, both classes honest (128,000 signed lanes), through
     VoteBatcher(verify_mode="msm").add_arrays -> build_phases_device
     (host-verified: one MSM pass) -> DeviceDriver.step_seq; every
     instance must decide 7 in round 0 with 0 rejected, the pow kernel
     launched twice, the Straus kernel once and the verify kernel never.
     The verify is then split into its parts by CUDA events.  A forged
     case follows at I = 2 x V = 1,000 with validator 7 forged in both
     classes: exactly 2 x I rejected, value 7 decided, and the verify
     kernel reached through bisection.  Last, each kernel is timed next
     to its plain version and its bound at the lane counts of this phase
     (pow also at 2,048,000 lanes;
     Straus at B = 1 on the path's own [c]B inputs, with its latency
     floor (the comb's dependent chain of multiplies times one radix-2^32
     multiply's dependent latency, `verify_probe.chain_latency_ns`), and
     at 128,000 random lanes, a shape no caller has yet).  A bound counts the least work of the
     kernel's function on the timed inputs; the kernel's own operation
     count is printed beside it;
  6. the BLS aggregate lane at full validator width: I = 4 x V = 1,000
     with 24-bit stake, 8 classes and 8,000 shares through
     BlsLane.table.fold -> poll -> clear_classes (the MSMs and two
     device pairing dispatches) -> VoteBatcher.add_class_votes ->
     build_phases -> DeviceDriver.step_seq, then a class with one forged
     share (`bls_lane_phase`); the field kernels' launches by row count
     per bls_aggregate and per bls_pairing_product call, and each
     call's kernel ms estimated as the sum of launches x ms over them;
  7. checkpoint, resume and signed evidence at full validator width:
     I = 1,024 x V = 1,000 as phase 3 builds it (validator 7 forged in
     both classes) with validator 9 also signing value 8 in the prevote
     class of every instance (a second tick through the same device
     path).  After the prevote phase `utils.checkpoint.save_driver` +
     `save_batcher`, both loaded into fresh objects on the card; the
     original and the restored copies finish the height and must decide
     alike (value 7, round 0, every instance; equal rejected lanes, state
     and tally); `signed_evidence(i, 9)` on the restored batcher must
     return the double-sign, both votes verifying under the RFC 8032
     oracle, and `signed_evidence(i, 7)` None; the verify kernel must be
     launched exactly 4 + 5 x (sampled instances) times in the phase (the
     four ticks, and per instance two re-verified candidates of each
     `signed_evidence(i, 9)` and one of `(i, 7)`).  Then the evidence
     join, `bridge.evidence.collect_device_evidence`, over every flag of
     the restored driver's equivocation plane plus the forger's column:
     one record per (instance, 9), equal to `signed_evidence` on the
     sampled instances, each passing `verify_evidence`, none for the
     forger, with one verify launch per logged device-verify batch; its
     time is logged.  The stages run in
     `utils.tracing.span`s of a `Tracer` whose chrome trace must parse
     and hold every stage (`checkpoint_phase`);
  8. the serve plane (`serve/`), three parts.  (a) Three signed heights
     at I = 1,024 x V = 1,000 (validator 7 forged in both classes)
     served by `VoteService(driver, batcher, pubkeys, target_votes=
     2 x I x V, max_delay_s=0, window_predictor=<round 0, height h>)`
     on the ladder `ShapeLadder.plan(I, V)` at the card's memory:
     `warmup(n_phases=(2, 3))` armed first (the retrace tripwire on the
     driver), then per height `submit` and `pump` under
     `torch.cuda.set_sync_debug_mode("error")`, then `drain()`.  Every
     instance must decide at every height with 2 x I rejected lanes a
     height; the state, tally and decisions must equal the same three
     heights through `build_phases_device` + `step_seq_signed` on a
     second driver, leaf for leaf; the verify kernel must be launched
     once per warmed signed shape and once per signed dispatch, and its
     verdicts at the last served height's own launch shape (2 x I x V
     lanes, none of them padding) must equal plain's on a sample of the
     lanes, every forged one among them.  It logs the served votes/s,
     per tick the host densify and the step's device time (CUDA events),
     the share of the steps' device time spent while the host densified
     the next height, the warmup wall with each warmed shape's host
     launch and device time, the device peak against the top rung's
     plan, and the host RSS.  Then a fresh service serves heights 0 and
     1 again, and the tick that dispatches height 0 and densifies height
     1 runs under `torch.profiler`: its chrome trace (written to
     `chiprun_out/serve_tick_trace.json`) gives the card's busy share
     over the step and over the tick, the gaps between the step's
     kernels, and the host's CUDA runtime calls while it launched the
     step; where the profiler records no device activity these read
     "not measured" (`serve_signed_phase`, `trace_tick`).  (b) The dedup cache at I = 64 x
     V = 1,000: two honest heights, each submitted again after its first
     copy settles, beside a service without the cache; the copies must
     be cache hits that ride the unsigned sequence with no verify launch
     and leave decisions, state and tally as without the cache, and a
     batch with a forged lane must cache nothing (`serve_dedup_phase`).
     (c) Phase 6's lane, registry and wire through a BLS-only
     `VoteService(..., bls_lane=...)` with `submit_bls`, warmup armed,
     the forged 4-signer class beside the 8 honest ones: the decisions
     must equal phase 6's and the forged share be dropped; the field
     kernels' launches are counted (`serve_bls_phase`);
  9. the host plane and the six benchmark configs
     (`agnes_tpu_torch.harness.configs`) at their full shapes: configs
     1, 3, 4, 5 and 6 through `configs.run`, each config's JSON dict on a
     line of its own; config 2 with its verify launches counted alone
     (exactly one window-5 launch of 2 x V = 200 lanes), its verdicts
     held against `verify_plain` at that shape and against the RFC 8032
     oracle on the host, a batch of the same shape with one forged lane
     rejected on that lane only, and the kernel and plain timed at that
     shape; then one node of a config-1 network crashed after height 1,
     restored through `utils.checkpoint.save_executor` /
     `load_executor_into`, and deciding its live height with its peers
     (`host_plane_phase`).
  10. the C++ ingest loop (`bridge.NativeIngestLoop` over the port's own
     `core/native/ingest.cpp`, built with g++ at first use), four parts
     at I = 1,024 x V = 1,000 with phase 3's traffic (validator 7 forged
     in both classes), three heights each (height 0 warms, heights 1-2
     are timed).  (a) The Python bridge (`add_arrays` ->
     `build_phases_device` -> `step_seq_signed`) with its stages timed
     from this script (`StageClock` wraps the eligibility gate,
     `_intern_slots`, `_emit`, `_pack_verify_inputs_np`,
     `_sha_blocks_np` and the uploads `_to_device`, which it
     synchronizes; the prologue and the kernel by CUDA events).  (b) The
     same wire through the loop: `push` of both classes, `build_phases`
     (C++ stage and fill, the upload, one window-5 verify launch of
     2,048,000 lanes, C++ verdict filter and emit, the phase upload),
     then `DeviceDriver.step_seq`, each stage timed; every height must
     make exactly one verify launch, reject 2 x I lanes and leave state,
     tally and decisions equal to (a)'s, leaf for leaf; height 1's
     phases must equal `VoteBatcher.build_phases(pubkeys)`'s on the same
     wire (round, class, count, slots, mask, height); that launch's
     verdicts must reject exactly validator 7's lanes, and the kernel
     must equal plain on 16,384 sampled lanes, every forged lane among
     them.  (c) The overlapped variant: the entry step queued by
     `step_async` while `push_async` hands both classes to the loop's
     worker thread, the window read (which waits for the card), then
     `build_phases` and the step queued (`defer_collect=True`, one
     `block_until_ready` at the end), with `async_depth` read at each
     build and the same exactness.  (d) One north-star height through
     the loop (I = 10,000, 20,000,000 lanes, phase 3n's traffic): one
     verify launch, 2 x I rejected lanes, decisions equal to phase 3n's,
     the stages, the wall and the host's peak RSS sampled while it runs
     (`RssPeak`).  Votes/s of (a), (b), (c) and (d) are logged beside
     phase 3's (`native_ingest_phase`).
  11. native admission and the threaded host (`serve/native_admission.py`
     over the port's C++ admission queue, `serve/threaded.py`): phase 8's
     three signed heights at I = 1,024 x V = 1,000 (validator 7 forged in
     both classes) served four ways, no warmup: (a) a VoteService with
     Python admission, as phase 8 serves them, whose dispatch stream is
     the reference; (b) `VoteService(native_admission=True)`, whose C++
     drain densifies each height straight into the signed step's phase
     and lane arrays (pinned host memory, one upload), adopted by the
     pipeline; (c) the same with `native_shards=4`; (d)
     `threaded_service(...)` with native admission, four producer threads
     submitting each height in blobs of 16,384 records.  The window
     predictor says height k for the k-th build.  Every run must end
     with phase 8's served driver's state, tally, decisions and rejected
     lanes, leaf for leaf, poll each decision once, make one verify
     launch a height and dispatch every vote once (submitted = admitted
     + rejected); (b)-(d) must adopt every height (`native_phase_builds`
     == 3) and dispatch (a)'s stream leaf for leaf; the verify kernel
     must equal plain on 16,384 sampled lanes of (b)'s last adopted
     build, every forged lane among them.  It logs each run's served
     votes/s, per tick the submit, drain, stage, host launch and step ms,
     the `serve_native_drain_wall_s` histogram, the overlap share (the
     steps' device time spent while the host drained or staged), the
     device peak against the top rung's plan, (d)'s busy shares of its
     submit and dispatch threads, and the phase's wall
     (`native_serve_phase`).
  12. the dense signed step and the mesh (`dense_mesh_phase`): (a) phase
     3's traffic at I = 1,024 x V = 1,000 through
     `VoteBatcher.build_phases_device_dense` ->
     `DeviceDriver.step_seq_signed_dense` (2,048,000 dense cells, one
     verify launch), held leaf for leaf against phase 3's packed-lane
     height (state, tally, decisions, 2 x 1,024 rejected), the kernel
     against plain on every dense cell of 16 sampled instance rows
     (their forged cells among them), the step's peak against
     `plan_dense_verify(...).peak_bytes`, then the same height through
     `step_async` under sync debug mode "error"; (b) the dense height at
     the north-star shape, 10,000 x 1,000 (20,000,000 cells), with
     `verify_chunk="auto"` at the card's memory and under half of it:
     launches == the plan's chunks, the peak at or under the plan,
     decisions == phase 3n's, the host's peak RSS; (c) the sharded dense
     step on NCCL, a world of one rank (`file://` rendezvous) on a 1 x 1
     mesh at (a)'s shape, gathered and held leaf for leaf against (a),
     its collective census printed, and where the machine has two or
     more cards a 1 x 2 (val) mesh over two spawned ranks at the same
     shape (`_mesh_rank`); (d) phase 8's three heights served by a
     VoteService whose driver sits on (c)'s mesh (the dense ladder and
     dense mode, warmup armed), the pump loop under sync debug mode
     "error": phase 8's served driver leaf for leaf, one verify launch a
     height, the served votes/s and the peak against the dense plan.
  13. the static pod (`agnes_tpu_torch.distributed`, `pod_phase`): phase
     8's three signed heights (I = 1,024 x V = 1,000, validator 7 forged
     in both classes) served by pods of processes spawned through
     `distributed.smoke.spawn_pod` (`file://` rendezvous, a deadline that
     kills a wedged pod), after the parent has released its cached
     device memory.  First the same heights through the one-process
     dense path (`build_phases_device_dense` -> `step_seq_signed_dense`),
     held against phase 8's served driver, and the verify kernel timed
     alone at the pod's launch shape (one host's 1,024,000 cells).  (a) 2
     hosts x (1 x 1): each host a `DistributedDriver` + `HostShard` on
     its own card, or both on card 0 of a one-card machine (their times
     then include each other's work), given the whole global wire,
     batches closed by size, the warmup between barriers and armed, a
     decision gather after each height.  Required on every process: the
     other host's records screened (`foreign_rejects`), one verify
     launch of 1,024,000 cells a height rejecting 2 x 512 lanes, no
     retrace, no off-ladder build, one warmed shape; the gathered
     decision rows identical on both processes and covering all 1,024
     instances; the host blocks, concatenated host-major, equal to the
     one-process dense path in state, tally and decisions, leaf for
     leaf; the kernel equal to plain on every cell of 16 sampled
     instance rows of each process's last launch (its 32 forged cells
     rejected); a heartbeat trail a process stamped with its host,
     ranked by `render_pod_postmortem`.  (b) (a) with
     `native_admission=True`, the same checks and (a)'s blocks.  (c) one
     host of several ranks, 1 x 2 (val), where the machine has two
     cards (2 hosts x (1 x 2) with four), held against (a); "not run: N
     card(s)" otherwise.  It logs per process the pod-wide served
     votes/s and per tick the densify, host launch, step and kernel
     device times, the agree and decision-gather walls, the device peak
     against the dense plan and the host RSS, and the phase's wall.
     (d) the elastic drill (`_elastic_drill`): 2 hosts x (1 x 1) through
     `spawn_pod(elastic=True)` at the same width, heights 0-4 (the one-
     process dense path carried on to height 4 is its reference), each
     host given only its own block's traffic, host 0 splitting each
     height's classes over two ticks while host 1 submits both at once,
     host 1 leaving at height 2's boundary and rejoining at height 3's,
     its held height replayed from host 0's re-route.  Required: the
     host blocks == the reference leaf for leaf; the gathered decision
     rows identical on both processes and covering every instance; 512 x
     5 decisions a host, 2 x 512 x 5 rejected lanes, two boundaries,
     epoch 2, one readmission, one departure; host 0 held, sent and host
     1 received 2 x 512,000 records, none dropped or pending; padded
     slots, no retrace, no foreign record; the verify launches a height
     equal to the tick schedule's (`elastic_launches`), the padding and
     dispatch calls under sync debug mode "error"; the kernel run again
     at each process's last launch shape and equal to plain on 16
     sampled instance rows; the merged post-mortem's `elastic
     membership:` trail at epoch 2.  It logs per process the per-tick
     negotiation wall, the densify, host launch, step and kernel times,
     the launches a height against the schedule's, the pod-wide served
     votes/s, the device peak against the dense plan and the host RSS.
  14. the model checkers' corpora (`checker_phase`): (a) every consensus
     corpus entry (`tests/corpus/*.json`, read as data) replayed through
     the device plane by `analysis.modelcheck.device_replay_entry(...,
     device="cuda")`: per (node, height) the device decisions equal the
     signed host replay's, which equals the entry's stamp, and device
     evidence is a subset of host evidence; (b) every admission corpus
     entry (`tests/corpus/admission/`) through a real `VoteService` on
     the card (`analysis.admission_mc.admission_service`, the real step):
     twice with bit-identical dispatch streams, with native admission
     equal to Python's (stream, queue counters and canonical form, cache
     counters), and on the CPU in the same process equal to the card's
     (stream, rejected counts, decisions); the verify kernel's launches
     over the card runs equal to the verifies they recorded (signed
     dispatches and host-fallback batches), then the kernel held against
     plain on every recorded verify's lanes, as recorded and with one bit
     of S flipped (rejected); (c) `python -m
     agnes_tpu_torch.analysis.modelcheck --scope tiny --json` under
     `timeout 120`: exit 0, ok, no violation, the deadline discovered
     from /proc.  It logs entries, nodes and heights of (a), dispatches,
     verified dispatches, fallback batches and lanes, launches and each
     run's seconds of (b), and the states and seconds a config of (c).
  15. the analyzers against what the card ran (`analysis_phase`), each
     CLI in this process through its `main(argv)`: (a) retrace: for each
     audited serve of phases 8 and 12 (the signed serve on the ladder
     planned at the card's memory, the BLS serve, the dense serve on the
     mesh) `coverage_findings(ladder, n_phases=(2, 3), dedup=True)` (and
     `dense=True` for the dense serve) is empty, and every signed shape
     its `RetraceSentinel` observed on the card (`observed_shapes`) lies
     in `dispatchable_shapes(ladder, dense=)`, at least one shape
     each on the signed and the dense serve; (b) `lint_cli.main(["--pass",
     "all", "--json"])` over this checkout: exit 0, ok, three passes;
     (c) `schedcheck.main(["--scope", "tiny", "--max-schedules", "200",
     "--json"])`: exit 0, no violation, 200 schedules, and
     `torch.cuda.is_initialized()` unchanged by the call; (d)
     `metrics_cli.main(["--check", *trails])` over the heartbeat trails
     of phase 13 (a)'s pod processes (kept until here): exit 0, and the
     pod render of the same trails ranks the hosts in the order
     `_pod_checks` read from `render_pod_postmortem`.  It logs the rungs
     and the shapes observed, each pass's seconds, the schedule count and
     the phase's wall.
  16. the public surface on the card (`surface_phase`): (a) the MSM
     height's shape, I = 64 x V = 1,000 with validator 7 forged, as
     128,000 `WireVote`s plus two with 10- and 65-byte signatures, fed
     one vote at a time through `VoteBatcher.extend` (the twin's per-vote
     wire entry), built with `build_phases_device` and stepped by
     `DeviceDriver.step_seq_signed`; the same votes through `add_arrays`
     beside it.  Phases, lanes, state and tally leaves, decisions and
     rejected counts must be equal, `rejected_malformed` 2 (0 through
     `add_arrays`), one verify launch a height, and the kernel equal to
     plain on 16,384 sampled lanes (the forged ones among them); it logs
     the per-vote wall beside `add_arrays`'.  (b) `apply_scalar` on one
     instance on the card for every (step, event tag, round relation)
     under two guard states, each against its row of one `apply_batch`
     call.  (c) `scripts/surface.check()`: every name of the JAX package
     the parity test checks (read as source with `ast`, never imported)
     resolves in the port by import and `hasattr`, or stands in
     `NOT_PORTED`; nothing is called.
  17. the run configuration on the card (`config_phase`), at phase 3's
     shape, seeds, keys and signatures (1,024 x 1,000, 2,048,000 lanes,
     validator 7 forged): (a) `RunConfig(n_instances=1024,
     n_validators=1000).validate().make_batcher()` -> `add_arrays` ->
     `build_phases_device` -> `DeviceDriver.step_seq_signed`, beside a
     `VoteBatcher` given the same arguments positionally in the twin's
     order: phases, lanes, state and tally leaves and decisions equal,
     and equal to phase 3's, 2 x I rejected, one verify launch a build,
     the kernel equal to plain on 16,384 sampled lanes (forged ones among
     them); (b) `make_native_loop(pubkeys, powers)` -> `push` ->
     `build_phases` -> `step_seq`: one launch, its verdict-filtered
     phases equal to the config batcher's `build_phases(pubkeys)` on the
     same columns (the device-verify phases of (a) still carry the forged
     lanes, which the step drops), its state, tally and decisions equal
     to (a)'s; (c) `make_native_loop` refuses `verify_mode="msm"`,
     `RunConfig.from_args` gives the flags back, and `surface.check()`
     reports 0 missing names, 0 parameter problems and 0 stale entries.
     It logs each part's seconds.

Prints a JSON line of kernel numbers (rows 4-5 with every timed shape;
rows 1, 4 and 5 with `launches_serve_phase`, phase 8's launches; row
1 with `launches_configs_phase`, config 2's launch, and its times at
that launch's 200 lanes, and with `launches_native_phase`, the C++
loop's launches in phase 10, and that phase's stage tables, and with
`launches_native_serve_phase`, phase 11's launches, and its runs'
numbers under `native_serve`, and with `launches_dense_phase`, phase
12's launches on its paths, and its numbers under `dense`, and with
`launches_pod_phase`, the pod processes' launches in phase 13 (a)-(c),
and with `launches_elastic_phase`, the elastic drill's, and its numbers
under `pod`, and with `launches_mc_phase`, phase 14's card runs', and its
numbers under `mc`, and phase 15's wall, observed shapes and pass times
under `analysis_*`, and with `launches_surface_phase`, phase 16's two
heights' launches, and its walls under `surface`, and with
`launches_config_phase`, phase 17's launches through the bridges
`RunConfig` built, and its seconds under `config`),
the `nvidia-smi` name/power line,
and last `{"ok": true, "device": {...}}`.  Any failed check raises:
the exit code is non-zero and no result line is printed.  Exits 1
without a CUDA device, 2 outside the repository.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

DEVICE = "cuda"
SEED = 20261016
I_SIGNED, V_SIGNED = 1024, 1000
I_NORTH = 10_000                   # phase 3n: the north-star instances
N_NORTH_SAMPLE = 131_072           # phase 3n: lanes held against plain
I_UNSIGNED, V_UNSIGNED, HEIGHTS = 10_000, 1_000, 4
I_MSM, I_MSM_FORGED = 64, 2
I_BLS, V_BLS = 4, 1000             # BLS lane: instances x validators
BLS_REAL_ROWS = 3 * 6 * 1024       # a G2 add's fv_mul_pairs stack at rung 1,024
BLS_BIG_ROWS = 1 << 20
BLS_PLAIN_CHUNK = 1 << 17          # the plain versions' rows per pass (memory)
FORGED = 7
VALUE = 7
N_RANDOM = 4096
EQUIVOCATOR = 9                    # phase 7: signs value 8 as well
SERVE_HEIGHTS = 3                  # phase 8: signed heights served
I_DEDUP = 64                       # phase 8: the dedup serve's instances
N_SERVE_SAMPLE = 16_384            # phase 8: served lanes held against plain
NATIVE_HEIGHTS = 3                 # phase 10: one warm height, then two timed
N_NATIVE_SAMPLE = 16_384           # phase 10: the loop's lanes held against plain
NATIVE_SERVE_SHARDS = 4            # phase 11: the sharded run's shards
NATIVE_SERVE_PRODUCERS = 4         # phase 11: threads feeding the threaded host
NATIVE_SERVE_CHUNK = 16_384        # phase 11: records a submitted blob
DENSE_SAMPLE_ROWS = 16             # phase 12: instance rows held against plain
MESH_JOIN_S = 600                  # phase 12: the spawned ranks' deadline
POD_HOSTS = 2                      # phase 13: the pod's hosts
POD_JOIN_S = 600                   # phase 13: a pod run's deadline
ELASTIC_HEIGHTS = 4                # phase 13(d): heights after height 0
ELASTIC_LEAVE, ELASTIC_REJOIN = 2, 3   # 13(d): host 1 away for height 2
CHAIN_ITERS = 60                   # phase 2d: the JAX script's iters
#: what phase 15 reads from the earlier phases: the audited serves'
#: (tag, ladder, dense, sentinel), none with a dedup cache, and phase
#: 13 (a)'s kept heartbeat trails with the host order `_pod_checks` read
ANALYSIS = {"serves": [], "trails": None, "pod_rank": None}
KERNEL_REPS = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
P = 2**255 - 19


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` runs, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_lanes(rng, pubkeys, msgs, sigs, n):
    """n lanes drawn from the signed fixture: honest, or forged by a
    flipped R bit, a flipped S bit, another message or another key."""
    V = len(pubkeys)
    pubs, ms, ss = [], [], []
    for k in range(n):
        v, c, kind = rng.randint(V), rng.randint(2), rng.randint(5)
        pub, msg = bytes(pubkeys[v]), bytes(msgs[c])
        sig = bytearray(sigs[c][v].tobytes())
        if kind == 1:
            sig[rng.randint(32)] ^= 1 << rng.randint(8)
        elif kind == 2:
            sig[32 + rng.randint(31)] ^= 1 << rng.randint(8)
        elif kind == 3:
            msg = bytes(msgs[1 - c])
        elif kind == 4:
            pub = bytes(pubkeys[(v + 1 + rng.randint(V - 1)) % V])
        pubs.append(pub)
        ms.append(msg)
        ss.append(bytes(sig))
    return pubs, ms, ss


def compare(got, want) -> tuple:
    """(lanes that differ, max |difference|) of two int tensors whose
    last axes are one lane's output."""
    diff = (got.long() - want.long()).abs()
    lane_axes = tuple(range(1, diff.ndim)) if diff.ndim > 1 else ()
    bad = diff.amax(dim=lane_axes) if lane_axes else diff
    return int((bad > 0).sum()), int(diff.max()) if diff.numel() else 0


def straus_check(E, F, got, want) -> tuple:
    """(lane checks failed, max |byte difference| of the encodings): got
    must equal want as a group element (`point_equal`, the projective
    representatives differ by design) and satisfy X Y = Z T."""
    eq = E.point_equal(got, want)
    xy = F.eq_mod_p(F.mul(got.x, got.y), F.mul(got.z, got.t))
    m, err = compare(E.compress(got), E.compress(want))
    return int((~eq).sum()) + int((~xy).sum()) + m, err


def straus_oracle(ref, s: int, k: int, a) -> bytes:
    """The RFC 8032 oracle's encoding of [s]B - [k]A (k not reduced: A
    may carry torsion)."""
    ka = ref._mul(k, a)
    neg = (-ka[0] % ref.P, ka[1], ka[2], -ka[3] % ref.P)
    return ref._compress(ref._add(ref._mul(s, ref.BASE), neg))


class Bound:
    """The least time the card could take for a kernel's work: the
    larger of its int32 operations over the int32 rate (SMs x 64 lanes
    x max SM clock) and its bytes over the memory rate."""

    def __init__(self, n_sms: int, sm_clock_mhz: float):
        self.n_sms = n_sms
        self.rate = n_sms * 64 * sm_clock_mhz * 1e6
        self.desc = f"{n_sms} SMs x 64 x {sm_clock_mhz:.0f} MHz"

    def __call__(self, ops: float, nbytes: float):
        ops_ms = ops / self.rate * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")


class BlsFp:
    """Phase 2c: the BLS12-381 field kernels (csrc/bls_fp.cu) on the
    card.  `check` holds both against their plain versions, limb for
    limb, at every group size G: the boundary values 0, 1, p-1, p, 4p-1
    of tests/test_pallas_field.py and random rows, the reduce at each
    pass count the lane uses (1: fv_reduce, fv_strict; 2: fv_mul_small
    by 12).  `time_at` times each through its wrapper (the G the wrapper
    picks) at a row count by `bls_fp_probe.device_ms` (launches queued
    while the card sleeps, so the time is the card's and not the Python
    launch path's), beside its plain version (0
    mismatching limbs on every timed row), its bound and, given the
    `csrc/` of an earlier checkout (`--parent-csrc`), that checkout's
    kernel as its wrapper ran it (equal outputs too)."""

    def __init__(self, rng, bound):
        import numpy as np
        import torch

        from agnes_tpu_torch.crypto import bls_field as BF
        from agnes_tpu_torch.crypto.bls_ref import P as PB
        from agnes_tpu_torch.scripts import bls_fp_probe

        self.BF, self.bound, self.rng = BF, bound, rng
        self.probe = bls_fp_probe
        self.dev = torch.device(DEVICE)
        self.edges = [BF.to_limbs(v) for v in (0, 1, PB - 1, PB, 4 * PB - 1)]
        self.PB, self.np, self.torch = PB, np, torch
        self.parent = None
        self.base = bls_fp_probe.operand_rows(rng, 4096, self.dev)
        self.shapes = {"bls_fp_mul": {}, "bls_fp_reduce": {}}
        self.err = {"bls_fp_mul": 0, "bls_fp_reduce": 0}
        self.mism = {"bls_fp_mul": 0, "bls_fp_reduce": 0}

    def below(self, bound_v):
        return int.from_bytes(self.rng.bytes(56), "little") % bound_v

    def sums3(self, n):
        """[n, 33]: the edges, then sums of 3 values < 4p/3 (limbs <= 3 x
        4095, value < 4p): fv_reduce's columns, one pass."""
        out = self.edges + [sum(self.BF.to_limbs(self.below(4 * self.PB // 3))
                                for _ in range(3))
                            for _ in range(n - len(self.edges))]
        return self.torch.from_numpy(
            self.np.stack(out).astype(self.np.int32)).to(self.dev)

    def check(self) -> None:
        BF = self.BF
        xa = self.probe.operand_rows(self.rng, N_RANDOM, self.dev)
        ya = xa.flip(0).contiguous()
        cases = [("bls_fp_mul", lambda: BF.mul_rows(xa, ya),
                  BF.mul_plain(xa, ya))]
        for cols, passes in ((self.sums3(N_RANDOM), 1), (xa * 12, 2)):
            cases.append(("bls_fp_reduce",
                          lambda c=cols, k=passes: BF.reduce_rows(c, k),
                          BF.reduce_plain(cols, passes)))
        tables = (BF.MUL_GROUPS, BF.REDUCE_GROUPS)
        try:
            for g in BF.GROUP_SIZES:
                BF.MUL_GROUPS = BF.REDUCE_GROUPS = ((0, g),)
                for name, kern, want in cases:
                    m, e = compare(kern(), want)
                    self.mism[name] += m
                    self.err[name] = max(self.err[name], e)
        finally:
            BF.MUL_GROUPS, BF.REDUCE_GROUPS = tables
        if any(self.mism.values()):
            raise AssertionError(f"bls_fp kernels != plain: {self.mism}")
        # one launch a wrapper call: no PyTorch op inside it but views and
        # the output's allocation (no copy, no transpose), one count each
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(str(func))
                return func(*args, **(kwargs or {}))

        cols, const = self.sums3(64), ya[0]      # a broadcast constant
        n0 = (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES)
        with Log():
            BF.mul_rows(xa, const)
            BF.reduce_rows(cols, 1)
        if (BF.MUL_LAUNCHES - n0[0], BF.REDUCE_LAUNCHES - n0[1]) != (1, 1) \
                or not all(o.startswith(("aten.empty.", "aten.expand.",
                                         "aten.view.")) for o in ops):
            raise AssertionError(f"bls_fp wrappers launched more: {ops}")
        log(f"[bls_fp] mul kernel == plain on {N_RANDOM} rows; reduce kernel "
            f"== plain on {N_RANDOM} rows at 1 and at 2 carry passes (the "
            f"edges 0, 1, p-1, p, 4p-1 in each); at G = "
            f"{', '.join(map(str, BF.GROUP_SIZES))}; a wrapper call is one "
            f"launch and no other op ({', '.join(sorted(set(ops)))})")

    def time_at(self, n: int) -> None:
        """Both kernels at n rows (skipped where already timed)."""
        BF = self.BF
        x = self.base.repeat(-(-n // 4096), 1)[:n].contiguous()
        y = x.flip(0).contiguous()
        for name in ("bls_fp_mul", "bls_fp_reduce"):
            if n in self.shapes[name]:
                continue
            if name == "bls_fp_mul":
                def kern():
                    return BF.mul_rows(x, y)

                def plain():
                    return chunked(BF.mul_plain, x, y)
                par = self.parent and (lambda: self.parent.mul(x, y))
                ops, nbytes = BF.MUL_INT32_OPS, 3 * BF.NLIMBS * 4
            else:
                def kern():
                    return BF.reduce_rows(x, 1)

                def plain():
                    return chunked(lambda c: BF.reduce_plain(c, 1), x)
                par = self.parent and (lambda: self.parent.reduce(x, 1))
                ops, nbytes = BF.REDUCE_INT32_OPS, 2 * BF.NLIMBS * 4
            reps = max(KERNEL_REPS, min(200, (1 << 22) // n))
            kern()                                        # warm
            k_ms = self.probe.device_ms(kern, reps)
            got = {}
            p_ms = cuda_ms(lambda: got.setdefault("y", plain()), 1)
            want = got.pop("y")
            m, e = compare(kern(), want)
            table = (BF.MUL_GROUPS if name == "bls_fp_mul"
                     else BF.REDUCE_GROUPS)
            rec = {"rows": n, "group": BF.group_size(n, table), "ms": k_ms,
                   "plain_ms": p_ms, "parent_ms": None}
            if par:
                par()
                rec["parent_ms"] = self.probe.device_ms(par, reps)
                m += compare(par(), want)[0]
            if m:
                raise AssertionError(f"{name} != plain (or parent) on {m} of "
                                     f"{n} rows")
            self.err[name] = max(self.err[name], e)
            rec["bound_ms"], rec["bound_by"] = self.bound(ops * n,
                                                          nbytes * n)
            self.shapes[name][n] = rec
            log(f"[{name}] R={n} (G={rec['group']}): kernel {k_ms:.4f} ms"
                + (f", parent {rec['parent_ms']:.4f} ms" if par else "")
                + f", plain {p_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; {ops} int32 ops/element at "
                f"{self.bound.desc}), kernel at "
                f"{100 * rec['bound_ms'] / k_ms:.3g}% of the bound")
        del x, y
        self.torch.cuda.empty_cache()


def chunked(fn, *xs):
    import torch

    return torch.cat([fn(*(x[i:i + BLS_PLAIN_CHUNK] for x in xs))
                      for i in range(0, xs[0].shape[0], BLS_PLAIN_CHUNK)])


def bls_stake(V: int):
    """Voting powers across the 24-bit W_BITS width, heavy-tailed (the
    exponent 24 u^2 for uniform u: most validators small, a few near
    2^24), from the seed; their total stays under the device tally's
    int32 quorum bound (3 * total < 2^31)."""
    import numpy as np

    r = np.random.RandomState(SEED + 6)
    pw = np.floor(np.exp2(24 * r.random_sample(V) ** 2)).astype(np.int64)
    pw = np.minimum(pw, (1 << 24) - 1)
    if not (pw.max() >= 1 << 23 and 3 * int(pw.sum()) < 2**31):
        raise AssertionError(f"stake draw off its width or bound: max "
                             f"{pw.max()}, total {pw.sum()}")
    return pw


def bls_lane_phase() -> dict:
    """Phase 6: the BLS aggregate lane at full validator width.

    I = 4 instances x V = 1,000 validators (sk_v = v + 1; pubkeys and
    shares by cumulative point adds, the registry from those points with
    the PoPs marked trusted; all built before the timed window), 24-bit stake (6 MSM windows), a prevote
    and a precommit class per instance signed by every validator: 8
    classes, 8,000 shares, through BlsLane.table.fold -> poll ->
    clear_classes (8 bls_aggregate calls at rung 1,024, two
    bls_pairing_product calls at class rung 4) -> add_class_votes ->
    build_phases -> DeviceDriver.step_seq.  Every class must clear on the
    device, every instance decide 7 in round 0, one class's aggregates
    equal the oracle's, and both kernels be launched by both calls.  A
    forged case follows: a class of 4 signers with one forged share —
    its device pairing fails, the host fallback rejects exactly that
    share, and the other 3 rows still come back.  Returns the kernel
    launches of the main run, in total and per call, and the fixture
    phase 8 serves again (registry, stake, both wires, the decisions)."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.crypto import bls as BLS
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.crypto import bls_pairing as BP
    from agnes_tpu_torch.crypto import bls_ref as bref
    from agnes_tpu_torch.crypto.encoding import vote_signing_bytes
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve.batcher import ShapeLadder
    from agnes_tpu_torch.serve.bls_lane import (BlsKeyRegistry, BlsLane,
                                                pack_bls_wire)
    from agnes_tpu_torch.types import VoteType

    I, Vn = I_BLS, V_BLS
    dev = torch.device(DEVICE)
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))

    # -- host fixtures (outside the timed window) --
    t0 = time.perf_counter()
    pts, acc = [], None
    for _ in range(Vn):
        acc = bref.point_add(acc, bref.G1)
        pts.append(acc)
    powers = bls_stake(Vn)
    # the registry from the fixture's own points: BlsKeyRegistry(pubkeys)
    # would decompress (and subgroup-check) each key, ~0.2 s apiece
    reg = BlsKeyRegistry.from_state(
        [bref.g1_compress(p) for p in pts], pts, BLS.pack_g1_rows(pts),
        powers, np.zeros(Vn, bool), np.zeros(Vn, np.int64),
        np.zeros(Vn, bool), 0)
    reg.mark_trusted(np.arange(Vn))
    msgs = {t: bref.hash_to_g2(vote_signing_bytes(0, 0, t, VALUE))
            for t in classes}
    wire = []
    for t in classes:
        shares, acc = [], None
        for _ in range(Vn):
            acc = bref.point_add(acc, msgs[t])
            shares.append(np.frombuffer(bref.g2_to_bytes(acc), np.uint8))
        shares = np.stack(shares)
        for i in range(I):
            wire.append(pack_bls_wire([i] * Vn, range(Vn), [0] * Vn,
                                      [0] * Vn, [t] * Vn, [VALUE] * Vn,
                                      shares))
    wire = b"".join(wire)
    f_msg = bref.hash_to_g2(vote_signing_bytes(0, 1, classes[0], VALUE))
    f_sh = [bref.point_mul(v + 1, f_msg) for v in range(4)]
    f_sh[2] = bref.point_mul(77, f_msg)                  # the forged share
    f_wire = pack_bls_wire([0] * 4, range(4), [0] * 4, [1] * 4,
                           [classes[0]] * 4, [VALUE] * 4,
                           np.stack([np.frombuffer(bref.g2_to_bytes(x),
                                                   np.uint8) for x in f_sh]))
    log(f"[bls fixture] {Vn} keys, {2 * Vn} shares, stake total "
        f"{int(powers.sum())} (max {int(powers.max())}, "
        f"{reg.n_windows} MSM windows): {time.perf_counter() - t0:.1f} s")
    if reg.n_windows != 6:
        raise AssertionError(f"stake needs {reg.n_windows} windows, not 6")

    # each device call of the lane timed by CUDA events (read after the
    # run, so nothing here waits for the card), with its launches
    calls = []

    def traced(entry, fn):
        def run(*a, **k):
            n0 = (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES)
            h0 = (BF.MUL_ROWS.copy(), BF.REDUCE_ROWS.copy())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            calls.append({"entry": entry, "ev": ev,
                          "bls_fp_mul": BF.MUL_LAUNCHES - n0[0],
                          "bls_fp_reduce": BF.REDUCE_LAUNCHES - n0[1],
                          "rows": {"bls_fp_mul": BF.MUL_ROWS - h0[0],
                                   "bls_fp_reduce": BF.REDUCE_ROWS - h0[1]},
                          "out": out if len(calls) == 0 else None})
            return out
        return run

    lane = BlsLane(reg, I, target_signers=Vn, max_delay_s=1e9, device=dev)
    lane.bind(None, ladder=ShapeLadder().with_bls(Vn))
    orig = (BLS.bls_aggregate, BP.bls_pairing_product)
    BLS.bls_aggregate = traced("bls_aggregate", orig[0])
    BP.bls_pairing_product = traced("bls_pairing_product", orig[1])
    try:
        torch.cuda.synchronize()
        BF.MUL_LAUNCHES = BF.REDUCE_LAUNCHES = 0
        BF.MUL_ROWS.clear()
        BF.REDUCE_ROWS.clear()
        t0 = time.perf_counter()
        folded = lane.table.fold(wire)
        closed = lane.poll()
        t_fold = time.perf_counter() - t0
        rows = lane.clear_classes(closed)
        torch.cuda.synchronize()
        t_clear = time.perf_counter() - t0 - t_fold
        bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
        bat.set_validators(powers)
        bat.add_class_votes(*(rows[k] for k in ("instance", "validator",
                                                "height", "round_", "typ",
                                                "value")))
        phases = bat.build_phases()
        drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
        drv.set_validators(powers)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        launches = {"bls_fp_mul": BF.MUL_LAUNCHES,
                    "bls_fp_reduce": BF.REDUCE_LAUNCHES}
        main_calls = list(calls)
        snap = lane.snapshot()
        # the forged class: device pairing False -> host fallback
        rej0 = lane.counters["rejected_share_signature"]
        f_fold = lane.table.fold(f_wire)
        f_rows = lane.clear_classes(lane.flush())
        f_rej = lane.counters["rejected_share_signature"] - rej0
        f_calls = calls[len(main_calls):]
        torch.cuda.synchronize()
    finally:
        BLS.bls_aggregate, BP.bls_pairing_product = orig
    for c in calls:
        c["ms"] = c["ev"][0].elapsed_time(c["ev"][1])

    values = {bat.decode_slot(i, int(s))
              for i, s in enumerate(drv.stats.decision_value)}
    s_w = sum(int(powers[v]) * (v + 1) for v in range(Vn)) % bref.R
    agg_pk, agg_sig = main_calls[0]["out"]
    aggs = [c for c in main_calls if c["entry"] == "bls_aggregate"]
    pairs = [c for c in main_calls if c["entry"] == "bls_pairing_product"]
    per = {n: {e: [c[n] for c in main_calls if c["entry"] == e]
               for e in ("bls_aggregate", "bls_pairing_product")}
           for n in launches}
    checks = {
        "8,000 shares folded": folded["folded"] == 2 * I * Vn,
        "8 classes cleared on the device": snap["agg_classes"] == 2 * I
        and snap["fallback_classes"] == 0 and len(aggs) == 2 * I,
        "one pairing dispatch per 4 classes": len(pairs) == -(-2 * I // 4)
        == snap["bls_device_pairing_dispatches"],
        "rows": rows is not None and len(rows["validator"]) == 2 * I * Vn,
        "all decided": bool(drv.stats.decided.all()),
        "round 0": bool((drv.stats.decision_round == 0).all()),
        f"value {VALUE}": values == {VALUE},
        "aggregates == oracle": (
            BLS.g1_from_device(agg_pk) == bref.point_mul(s_w, bref.G1)
            and BLS.g2_from_device(agg_sig) == bref.point_mul(
                s_w, msgs[classes[0]])),
        "kernels launched by both calls": all(
            min(v) > 0 for n in per for v in per[n].values()),
        "forged: one share rejected": f_fold["folded"] == 4 and f_rej == 1,
        "forged: 3 rows dispatch": f_rows is not None and sorted(
            f_rows["validator"].tolist()) == [0, 1, 3],
        "forged: device pairing said False": len(
            [c for c in f_calls if c["entry"] == "bls_pairing_product"]) == 1
        and lane.counters["fallback_classes"] == 1,
    }
    if not all(checks.values()):
        raise AssertionError(f"BLS lane failed: {checks}")
    n_votes = 2 * I * Vn
    log(f"[bls] I={I} V={Vn} classes={2 * I} votes={n_votes} wall="
        f"{wall:.3f} s (fold + poll {t_fold:.3f} s, clear_classes "
        f"{t_clear:.3f} s, step {t_step:.3f} s) BLS votes verified/s="
        f"{n_votes / wall:.0f}")
    log("[bls] bls_aggregate ms per class (CUDA events): " + ", ".join(
        f"{c['ms']:.1f}" for c in aggs))
    log("[bls] bls_pairing_product ms per dispatch (4 classes each): "
        + ", ".join(f"{c['ms']:.1f}" for c in pairs))
    for n in launches:
        log(f"[bls] {n} launches: {launches[n]} in the run; per "
            f"bls_aggregate {per[n]['bls_aggregate']}, per "
            f"bls_pairing_product {per[n]['bls_pairing_product']}")
    # launches by row count, per call (the first of each entry; the
    # others are checked alike)
    hists = {n: {} for n in launches}
    for n in launches:
        for e in ("bls_aggregate", "bls_pairing_product"):
            hs = [c["rows"][n] for c in main_calls if c["entry"] == e]
            hists[n][e] = dict(sorted(hs[0].items()))
            log(f"[bls] {n} launches by rows per {e} (R: launches; all "
                f"{len(hs)} calls alike: {all(h == hs[0] for h in hs)}): "
                + ", ".join(f"{r}: {k}" for r, k in hists[n][e].items()))
    log(f"[bls forged] 4 signers, 1 forged: rejected {f_rej}, rows "
        f"{f_rows['validator'].tolist()}, calls " + ", ".join(
            f"{c['entry']} {c['ms']:.1f} ms" for c in f_calls))
    fix = {"reg": reg, "powers": powers, "wire": wire, "f_wire": f_wire,
           "stats": {f: getattr(drv.stats, f).copy()
                     for f in ("decided", "decision_value",
                               "decision_round")}}
    return {n: {"total": launches[n],
                "bls_aggregate": per[n]["bls_aggregate"][0],
                "bls_pairing_product": per[n]["bls_pairing_product"][0],
                "rows": hists[n]}
            for n in launches}, fix


def chain_phase(bound) -> dict:
    """Phase 2d: the layout microbenchmark's path and its kernel
    (csrc/fe13_chain.cu) against its plain version on the card.  Returns
    the kernel's line for the JSON output, with every row's numbers."""
    import numpy as np
    import torch

    from agnes_tpu_torch.scripts import microbench_layout as MB

    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    MB.LAUNCHES = 0
    rows = MB.main(["--iters", str(CHAIN_ITERS), "--seed", str(SEED)])
    launches = MB.LAUNCHES
    if launches != len(rows) * (CHAIN_ITERS + 1):
        raise AssertionError(f"microbench launched fe13_chain {launches} "
                             f"times for {len(rows)} rows")

    def per_lane(t):
        return t.reshape(MB.NLIMBS, -1).t()

    def check(x, y, n, block):
        got = MB.chain(x, y, n, block)
        plain = {}
        p_ms = cuda_ms(lambda: plain.setdefault(
            "y", MB.chain_plain(x, y, n)), 1)
        return compare(per_lane(got), per_lane(plain["y"])) + (p_ms,)

    mism = err = 0
    for r in rows:
        label, n = r["label"], r["n_chain"]
        x, y = (torch.from_numpy(a).to(dev)
                for a in MB.row_inputs(r["shape"], SEED))
        m, e, p_ms = check(x, y, n, r["block_lanes"])
        mism, err = mism + m, max(err, e)
        b_ms, b_by = bound(MB.least_products(r["lanes"], n),
                           MB.least_bytes(r["lanes"]))
        # the row's CTAs reach at most that many SMs: its layout's bound
        ctas = -(-r["lanes"] // r["block_lanes"])
        b_ctas = b_ms * bound.n_sms / min(ctas, bound.n_sms)
        r.update(plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, mismatches=m,
                 ctas=ctas, bound_ms_at_ctas=b_ctas)
        log(f"[chain] {label}: kernel {r['ms']:.4f} ms, plain {p_ms:.3f} ms,"
            f" bound {b_ms:.4f} ms ({b_by}; {MB.PRODUCTS_PER_FE_MUL} IMADs "
            f"a multiply, the kernel's own count the same, at "
            f"{bound.desc}), kernel at {100 * b_ms / r['ms']:.3g}% of the "
            f"bound; on the {min(ctas, bound.n_sms)} SMs its {ctas} CTAs "
            f"reach {b_ctas:.4f} ms, kernel at "
            f"{100 * b_ctas / r['ms']:.3g}% of that; {m} of {r['lanes']} "
            f"lanes differ from plain")
    rng = np.random.RandomState(SEED + 2)
    wraps = [MB.wrap_inputs((MB.NLIMBS, MB.T_LANES), SEED + 1),
             tuple(rng.randint(-2**31, 2**31, (MB.NLIMBS, MB.T_LANES),
                               np.int64).astype(np.int32) for _ in range(2))]
    for name, (xw, yw) in zip(("limbs near 2^15", "whole int32 range"),
                              wraps):
        x, y = torch.from_numpy(xw).to(dev), torch.from_numpy(yw).to(dev)
        m, e, _ = check(x, y, MB.N_CHAIN, 512)
        mism, err = mism + m, max(err, e)
        log(f"[chain] wrap case ({name}), N_CHAIN {MB.N_CHAIN}: {m} of "
            f"{MB.T_LANES} lanes differ from plain")
    if mism:
        raise AssertionError(f"fe13_chain kernel != plain on {mism} lanes")
    log(f"[chain] fe13_chain launches on the microbench path: {launches} "
        f"({len(rows)} rows x {CHAIN_ITERS} timed + 1 warm)")
    head = rows[0]
    return {
        "route": "cuda", "source": "agnes_tpu_torch/csrc/fe13_chain.cu",
        "replaces": "scripts/microbench_layout.py:65",
        "launches": launches, "max_abs_err": err, "mismatches": mism,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "lanes": head["lanes"],
        "n_chain": head["n_chain"],
        "products_per_fe_mul": MB.PRODUCTS_PER_FE_MUL,
        "bound_ms_at_ctas": head["bound_ms_at_ctas"],
        "rows": [{k: r[k] for k in ("label", "block_lanes", "n_chain", "ms",
                                    "plain_ms", "bound_ms", "ctas",
                                    "bound_ms_at_ctas")}
                 for r in rows]}


def signed_variants(I, Vn, phases, lanes, ref) -> None:
    """Phase 3's height again on fresh drivers: under a forced budget
    the "auto" planner must chunk the verify (>= 3 launches) and decide
    as the unchunked run `ref` did; two back-to-back signed `step_async`
    dispatches must run under `torch.cuda.set_sync_debug_mode("error")`
    (no read-back on the dispatch path) and, collected, equal two
    `step_seq_signed` calls stat for stat and leaf for leaf."""
    import numpy as np
    import torch

    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.utils import budget

    dev = lanes.pub.device
    n = int(lanes.pub.shape[0])
    ps = [p for p, _ in phases]
    # room for 1.5 tiles of workspace, a tile the largest power of two
    # <= n / 3: 4 chunks of 524,288 lanes at 2,048,000
    tile = 1 << ((n // 3).bit_length() - 1)
    hbm = int((n * 512 + 1.5 * tile * budget.VERIFY_WORKSPACE_LANE_BYTES)
              / 0.9) + 1
    plan = budget.plan_lane_verify(n, hbm_bytes=hbm)
    auto = DeviceDriver(I, Vn, advance_height=True, device=dev,
                        verify_chunk="auto", hbm_budget_bytes=hbm)
    V.LAUNCHES = 0
    auto.step_seq_signed([auto.empty_phase()] + ps, lanes)
    launches = V.LAUNCHES

    def stats(d):
        return ((d.stats.votes_ingested, d.stats.steps,
                 d.stats.decisions_total, d.rejected_signature_device),
                [getattr(d.stats, f).tolist() for f in
                 ("decided", "decision_value", "decision_round")])

    def leaves(d):
        return [t.cpu().numpy() for t in tuple(d.state) + tuple(d.tally)]

    twice = DeviceDriver(I, Vn, advance_height=True, device=dev)
    for _ in range(2):
        twice.step_seq_signed([twice.empty_phase()] + ps, lanes)
    asy = DeviceDriver(I, Vn, advance_height=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            asy.step_async([asy.empty_phase()] + ps, lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_dispatch = time.perf_counter() - t0
    queued = (asy.stats.votes_ingested, asy.stats.decisions_total)
    asy.collect()
    t_collect = time.perf_counter() - t0
    checks = {
        f"auto: {plan.n_chunks} chunks, one launch each":
            plan.n_chunks >= 3 and launches == plan.n_chunks,
        "auto decides as unchunked": stats(auto) == stats(ref),
        "step_async: nothing read back before collect": queued == (0, 0),
        "step_async x2 == step_seq_signed x2": stats(asy) == stats(twice)
        and all(np.array_equal(a, b)
                for a, b in zip(leaves(asy), leaves(twice))),
    }
    if not all(checks.values()):
        raise AssertionError(f"signed height variants failed: {checks}")
    log(f"[signed] auto under a forced budget of {hbm} B: {plan.describe()};"
        f" {launches} verify launches, decisions and "
        f"{ref.rejected_signature_device} rejected lanes as unchunked")
    log(f"[signed] two signed step_async under sync debug mode 'error': "
        f"dispatch returned in {t_dispatch:.3f} s, collect done at "
        f"{t_collect:.3f} s; stats equal two step_seq_signed calls "
        f"({stats(asy)[0]})")


def north_star_phase(seeds, pubkeys, sigs, bound):
    """Phase 3n: one signed height at I = 10,000 x V = 1,000 (20,000,000
    lanes) with the verify planner ("auto"); see the module docstring.
    Returns its numbers for the verify kernel's line, and its decisions
    (phase 10 holds the C++ loop's against them)."""
    import resource

    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.types import VoteType
    from agnes_tpu_torch.utils import budget

    I, Vn = I_NORTH, V_SIGNED
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    cols = [fx.full_mesh_cols(I, Vn, seeds, 0, int(typ), VALUE, sigs=sigs[c])
            for c, typ in enumerate((VoteType.PREVOTE, VoteType.PRECOMMIT))]
    t_cols = time.perf_counter() - t0
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    for c in cols:
        bat.add_arrays(*c)
    t_add = time.perf_counter() - t0
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    if lanes is None or len(phases) != 2:
        raise AssertionError("north-star height left the device path")
    t_build = time.perf_counter() - t0
    n = int(lanes.pub.shape[0])
    drv = DeviceDriver(I, Vn, advance_height=True, device=dev,
                       verify_chunk="auto")
    plan = budget.plan_lane_verify(n, hbm_bytes=budget.device_hbm_bytes(dev))
    seq = [drv.empty_phase()] + [p for p, _ in phases]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    drv.step_seq_signed(seq, lanes)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = V.LAUNCHES
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    values = {bat.decode_slot(0, int(s))
              for s in np.unique(drv.stats.decision_value)}
    decisions = _decisions(drv, bat.decode_slot)
    checks = {
        "all decided": bool(drv.stats.decided.all()),
        "round 0": bool((drv.stats.decision_round == 0).all()),
        f"value {VALUE}": values == {VALUE},
        "rejected == 2I": drv.rejected_signature_device == 2 * I,
        "heights advanced": bool((drv.state.height == 1).all()),
        "launches == plan.n_chunks": launches == plan.n_chunks,
        "step peak <= plan.peak_bytes": peak <= plan.peak_bytes,
    }
    if not all(checks.values()):
        raise AssertionError(f"north-star height failed: {checks}; "
                             f"{plan.describe()}; peak {peak} B, "
                             f"launches {launches}")
    log(f"[north-star] I={I} V={Vn} lanes={n} {plan.describe()}")
    log(f"[north-star] rejected={drv.rejected_signature_device} verify "
        f"launches={launches} wall={wall:.3f} s (add_arrays {t_add:.3f} s, "
        f"build_phases_device {t_build - t_add:.3f} s, step {t_step:.3f} s;"
        f" fixture columns {t_cols:.3f} s before the window) verified "
        f"votes/s={n / wall:.0f} (step only {n / t_step:.0f})")
    log(f"[north-star] step peak {peak / 2**30:.3f} GiB (allocated before "
        f"the step {before / 2**30:.3f} GiB) against the plan's "
        f"{plan.peak_bytes / 2**30:.3f} GiB; host peak RSS {rss_gib:.2f} "
        f"GiB; card {smi('name,power.limit')}")

    # the same height under half the card's memory, where the planner
    # must chunk: one launch a chunk, the peak within the plan, the same
    # decisions
    half = budget.device_hbm_bytes(dev) // 2
    plan2 = budget.plan_lane_verify(n, hbm_bytes=half)
    d2 = DeviceDriver(I, Vn, advance_height=True, device=dev,
                      verify_chunk="auto", hbm_budget_bytes=half)
    seq2 = [d2.empty_phase()] + [p for p, _ in phases]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    V.LAUNCHES = 0
    t1 = time.perf_counter()
    d2.step_seq_signed(seq2, lanes)
    torch.cuda.synchronize()
    t_half = time.perf_counter() - t1
    peak2, launches2 = torch.cuda.max_memory_allocated(), V.LAUNCHES
    checks = {
        "half budget: launches == plan.n_chunks > 1":
            plan2.n_chunks > 1 and launches2 == plan2.n_chunks,
        "half budget: step peak <= plan.peak_bytes":
            peak2 <= plan2.peak_bytes,
        "half budget: same decisions and rejects": all(
            np.array_equal(getattr(d2.stats, f), getattr(drv.stats, f))
            for f in ("decided", "decision_value", "decision_round"))
        and d2.rejected_signature_device == drv.rejected_signature_device,
    }
    if not all(checks.values()):
        raise AssertionError(f"north-star height under half the card "
                             f"failed: {checks}; {plan2.describe()}; peak "
                             f"{peak2} B, launches {launches2}")
    log(f"[north-star] under half the card ({half} B): {plan2.describe()};"
        f" {launches2} verify launches, step {t_half:.3f} s, peak "
        f"{peak2 / 2**30:.3f} GiB, decisions and rejects as above")
    del d2, seq2

    # the prologue and the kernel chunk by chunk at the plan's tile, the
    # step's own launch shape, by CUDA events; the verdicts of those
    # launches, and of the first chunk at half the card's tile, are held
    # against plain on a sample of the lanes, the forged ones among them
    rng = np.random.RandomState(SEED + 3)
    val = lanes.val.cpu().numpy()
    forged = np.nonzero(val == FORGED)[0]
    n_forged = min(256, len(forged))
    pick = rng.choice(n, N_NORTH_SAMPLE, replace=False)
    pick = pick[val[pick] != FORGED][:N_NORTH_SAMPLE - n_forged]
    idx = np.sort(np.concatenate([pick, rng.choice(forged, n_forged,
                                                   replace=False)]))

    def chunks(tile, stop):
        """Prologue and kernel over lanes [0, stop) in chunks of `tile`:
        (prologue ms, kernel ms, the sampled lanes' kernel verdicts,
        their kernel inputs, their S < L flags, the sampled lanes)."""
        pro = ker = 0.0
        got, ins, oks = [], [], []
        for i in range(0, stop, tile):
            held = {}
            pro += cuda_ms(lambda: held.setdefault("a", V.prologue(
                lanes.pub[i:i + tile], lanes.sig[i:i + tile],
                lanes.blocks[i:i + tile])), 1)
            args, ok_s = held.pop("a")
            ker += cuda_ms(lambda: held.setdefault(
                "o", V.verify_signed5(*args)), 1)
            sel = idx[(idx >= i) & (idx < min(i + tile, stop))] - i
            sel = torch.from_numpy(sel).to(dev)
            got.append(held.pop("o")[sel])
            oks.append(ok_s[sel])
            ins.append([a[..., sel] for a in args])
            del args, ok_s
        return (pro, ker, torch.cat(got),
                [torch.cat(p, dim=-1).contiguous() for p in zip(*ins)],
                torch.cat(oks), idx[idx < stop])

    def hold(what, got, args, ok_s, at):
        plain = {}
        ms = cuda_ms(lambda: plain.setdefault("ok", V.verify_plain(*args)),
                     1)
        mism, err = compare(got, plain["ok"])
        ok = ((got > 0) & ok_s).cpu().numpy()
        is_forged = val[at] == FORGED
        if mism or ok[is_forged].any() or not ok[~is_forged].all():
            raise AssertionError(
                f"north-star sample ({what}): kernel != plain on {mism} of "
                f"{len(at)} lanes, or a forged lane passed / an honest "
                f"lane failed")
        log(f"[north-star] {what}: kernel == plain on a sample of "
            f"{len(at)} lanes ({int(is_forged.sum())} forged, all "
            f"rejected); plain {ms:.3f} ms")
        return mism, err

    pro_ms, ker_ms, got, args, ok_s, at = chunks(plan.tile, n)
    bound_ms, bound_by = bound(V.INT32_OPS_PER_LANE * n, V.BYTES_PER_LANE * n)
    log(f"[north-star] over {plan.n_chunks} chunks of {plan.tile} lanes: "
        f"prologue {pro_ms:.3f} ms, verify kernel {ker_ms:.3f} ms (bound "
        f"{bound_ms:.3f} ms, {bound_by}), rest of the step "
        f"{t_step * 1e3 - pro_ms - ker_ms:.3f} ms")
    mism, max_err = hold(f"{plan.n_chunks} launches of {plan.tile} lanes",
                         got, args, ok_s, at)
    del got, args, ok_s
    _, ker2_ms, got, args, ok_s, at = chunks(plan2.tile, plan2.tile)
    mism2, err2 = hold(f"the first of {plan2.n_chunks} chunks of "
                       f"{plan2.tile} lanes (kernel {ker2_ms:.3f} ms)",
                       got, args, ok_s, at)
    return {"launches_north_star": launches,
            "north_star_lanes": n, "north_star_chunks": plan.n_chunks,
            "north_star_wall_s": wall, "north_star_votes_per_s": n / wall,
            "north_star_tile": plan.tile,
            "launches_north_star_half_budget": launches2,
            "north_star_kernel_ms": ker_ms,
            "north_star_prologue_ms": pro_ms,
            "north_star_bound_ms": bound_ms,
            "north_star_sample_mismatches": mism + mism2,
            "north_star_sample_max_abs_err": max(max_err, err2)}, decisions


def checkpoint_phase(seeds, pubkeys, sigs) -> int:
    """Phase 7: checkpoint, resume and signed evidence at full validator
    width through the device-verify path (see the module docstring).
    Returns the verify kernel's launches in the phase."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.evidence import (collect_device_evidence,
                                                 verify_evidence)
    from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
    from agnes_tpu_torch.crypto import ed25519_ref as ref
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.types import VoteType
    from agnes_tpu_torch.utils import (Tracer, load_batcher, load_driver,
                                       save_batcher, save_driver, span)

    I, Vn = I_SIGNED, V_SIGNED
    dev = torch.device(DEVICE)
    pv, pc = int(VoteType.PREVOTE), int(VoteType.PRECOMMIT)
    msg8 = vote_messages_np(*(np.full(1, x, np.int64)
                              for x in (0, 0, pv, 8)))[0].tobytes()
    sig8 = np.frombuffer(ref.sign(seeds[EQUIVOCATOR], msg8), np.uint8)
    double = (np.arange(I), np.full(I, EQUIVOCATOR), np.zeros(I, np.int64),
              np.zeros(I, np.int64), np.full(I, pv, np.int64),
              np.full(I, 8, np.int64), np.tile(sig8, (I, 1)))
    tr = Tracer()
    stages = ("prevote", "double_sign", "save", "load", "finish",
              "evidence", "evidence_join")

    def signed_tick(bat, drv, cols, entry=False):
        bat.add_arrays(*cols)
        phases, lanes = bat.build_phases_device(pubkeys,
                                                phase_offset=int(entry))
        if lanes is None:
            raise AssertionError("phase 7 tick left the device-verify path")
        drv.step_seq_signed(([drv.empty_phase()] if entry else [])
                            + [p for p, _ in phases], lanes)

    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
        drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
        with span("prevote", tr):
            signed_tick(bat, drv, fx.full_mesh_cols(I, Vn, seeds, 0, pv,
                                                    VALUE, sigs=sigs[0]),
                        entry=True)
        with span("double_sign", tr):
            signed_tick(bat, drv, double)
            torch.cuda.synchronize()
        dpath, bpath = (os.path.join(tmp, n) for n in ("d.npz", "b.npz"))
        with span("save", tr):
            t1 = time.perf_counter()
            save_driver(drv, dpath)
            save_batcher(bat, bpath)
            t_save = time.perf_counter() - t1
        sizes = [os.path.getsize(p) for p in (dpath, bpath)]
        with span("load", tr):
            t1 = time.perf_counter()
            drv2 = load_driver(dpath, device=dev)
            bat2 = load_batcher(bpath, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t1
        rejects = []
        with span("finish", tr):
            cols = fx.full_mesh_cols(I, Vn, seeds, 0, pc, VALUE, sigs=sigs[1])
            for d, b in ((drv, bat), (drv2, bat2)):
                r0 = d.rejected_signature_device
                signed_tick(b, d, cols)
                rejects.append(d.rejected_signature_device - r0)
            torch.cuda.synchronize()
        sample = sorted({0, 1, I // 2, I - 1}
                        | set(np.random.RandomState(SEED + 7)
                              .randint(I, size=4).tolist()))
        evidence = {}
        with span("evidence", tr):
            for i in sample:
                evidence[i] = (bat2.signed_evidence(i, EQUIVOCATOR),
                               bat.signed_evidence(i, EQUIVOCATOR),
                               bat2.signed_evidence(i, FORGED))
        launches = V.LAUNCHES
        # the join over every flag of the restored copy, the forger's
        # column flagged too (it must yield nothing)
        with span("evidence_join", tr):
            flags = drv2.tally.equiv.clone()
            flags[:, FORGED] = True
            t1 = time.perf_counter()
            records = collect_device_evidence(flags, bat2)
            t_join = time.perf_counter() - t1
            join_launches = V.LAUNCHES - launches
        wall = time.perf_counter() - t0
        tpath = os.path.join(tmp, "trace.json")
        tr.write(tpath)
        with open(tpath) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"]

    def oracle_ok(w):
        msg = vote_messages_np(*(np.full(1, x, np.int64) for x in (
            w.height, w.round, int(w.typ), w.value)))[0].tobytes()
        return ref.verify(bytes(pubkeys[w.validator]), msg, w.signature)

    def leaves(d):
        return [t.cpu().numpy() for t in tuple(d.state) + tuple(d.tally)]

    ev_ok = all(
        ev is not None and again is not None
        and [(w.value, w.signature) for w in ev]
        == [(w.value, w.signature) for w in again]
        and sorted(w.value for w in ev) == [VALUE, 8]
        and all(w.instance == i and w.validator == EQUIVOCATOR
                and int(w.typ) == pv and oracle_ok(w) for w in ev)
        for i, (ev, again, _) in evidence.items())
    t1 = time.perf_counter()
    records_ok = all(verify_evidence(r, bytes(pubkeys[r.validator]))
                     for r in records)
    t_check = time.perf_counter() - t1

    def fields(pair):
        return [(w.instance, w.validator, w.height, w.round, int(w.typ),
                 w.value, w.signature) for w in pair]

    by_cell = {(r.instance, r.validator): r for r in records}
    decided = [{b.decode_slot(i, int(s))
                for i, s in enumerate(d.stats.decision_value)}
               for d, b in ((drv, bat), (drv2, bat2))]
    checks = {
        "both decided": bool(drv.stats.decided.all())
        and bool(drv2.stats.decided.all()),
        f"value {VALUE}": decided == [{VALUE}, {VALUE}],
        "round 0": bool((drv.stats.decision_round == 0).all())
        and bool((drv2.stats.decision_round == 0).all()),
        "same decisions": all(np.array_equal(getattr(drv.stats, f),
                                             getattr(drv2.stats, f))
                              for f in ("decided", "decision_value",
                                        "decision_round")),
        "same counters": (drv.stats.decisions_total, drv.stats.steps,
                          drv.stats.votes_ingested)
        == (drv2.stats.decisions_total, drv2.stats.steps,
            drv2.stats.votes_ingested),
        "same state and tally": all(np.array_equal(a, b) for a, b in zip(
            leaves(drv), leaves(drv2))),
        "rejected I in the finish, 2I in all": rejects == [I, I]
        and drv.rejected_signature_device == 2 * I,
        "double-sign evidence verified": ev_ok,
        "forger: no evidence": all(f is None
                                   for _, _, f in evidence.values()),
        "verify launches: 4 ticks + 5 re-verifies an instance": launches
        == 4 + 5 * len(sample),
        "join: one record per (instance, 9), none for the forger": [
            (r.instance, r.validator) for r in records]
        == [(i, EQUIVOCATOR) for i in range(I)],
        "join == signed_evidence on the sample": all(
            fields((by_cell[i, EQUIVOCATOR].first,
                    by_cell[i, EQUIVOCATOR].second)) == fields(ev)
            for i, (ev, _, _) in evidence.items()),
        "join records pass verify_evidence": records_ok,
        "join: one re-verify per logged device-verify batch":
            join_launches == sum(pk is not None for pk in bat2._log_pk),
        "trace holds every stage": {e["name"] for e in spans}
        == set(stages),
    }
    if not all(checks.values()):
        raise AssertionError(f"checkpoint phase failed: {checks}")
    span_ms = {n: tr.total_us(n) / 1e3 for n in stages}
    log(f"[checkpoint] I={I} V={Vn} validator {EQUIVOCATOR} double-signs "
        f"(values {VALUE} and 8) in every instance: snapshot after the "
        f"prevote phase, driver {sizes[0]} bytes, batcher {sizes[1]} bytes "
        f"({sum(len(b) for b in bat._log)} logged votes), save {t_save:.3f} "
        f"s, load {t_load:.3f} s; both copies decide {VALUE} in round 0, "
        f"rejected {rejects} in the finish; evidence on instances {sample}; "
        f"verify launches {launches}; phase {wall:.3f} s")
    log(f"[checkpoint] evidence join over {int(flags.sum())} flags "
        f"({I} of validator {EQUIVOCATOR}, {I} of the forger {FORGED}): "
        f"{len(records)} records in {t_join:.3f} s with {join_launches} "
        f"verify launches; verify_evidence on all of them {t_check:.3f} s")
    log("[checkpoint] spans (ms): " + ", ".join(
        f"{n} {v:.1f}" for n, v in span_ms.items()))
    return launches


def _host_rss_gib() -> float:
    """The resident set of this process now, in GiB (/proc/self/status;
    the process's lifetime peak is phase 3n's, so a phase reads its own
    use as the change of this)."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 2**20
    return -1.0


def _union(ivs) -> list:
    """Merge [(start, end)] intervals (sorted by start) into disjoint
    ones."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by disjoint `merged` intervals."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def trace_tick(path: str) -> dict:
    """Read one profiled serve tick's chrome trace (torch.profiler):
    the ranges `serve.tick`, `serve.dispatch` (the step's host launch)
    and `serve.densify`, the host's CUDA runtime calls inside the
    dispatch, and the card's activity (kernels, copies, sets): the
    step's operations are those the dispatch's runtime calls launched
    (their correlation ids), the tick's all of them.  Times in ms.  With
    no device activity in the trace the device numbers are None (not
    measured)."""
    import statistics

    with open(path) as f:
        evs = json.load(f)
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    evs = [e for e in evs if e.get("ph") == "X"]
    rng = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and e.get("name") in (
                "serve.tick", "serve.dispatch", "serve.densify"):
            rng.setdefault(e["name"], (e["ts"], e["ts"] + e["dur"]))
    missing = {"serve.tick", "serve.dispatch", "serve.densify"} - set(rng)
    if missing:
        raise AssertionError(f"profiled tick lacks the ranges {missing}")
    d0, d1 = rng["serve.dispatch"]
    s0, s1 = rng["serve.densify"]
    t0, t1 = rng["serve.tick"]
    runtime, corr = {}, set()
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and d0 <= e["ts"] <= d1:
            n, tot, mx = runtime.get(e["name"], (0, 0.0, 0.0))
            runtime[e["name"]] = (n + 1, tot + e["dur"], max(mx, e["dur"]))
            if "correlation" in e.get("args", {}):
                corr.add(e["args"]["correlation"])
    dev = [e for e in evs
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    step = [(e["ts"], e["ts"] + e["dur"]) for e in dev
            if e.get("args", {}).get("correlation") in corr]
    out = {"dispatch_ms": (d1 - d0) / 1e3, "densify_ms": (s1 - s0) / 1e3,
           "tick_ms": (t1 - t0) / 1e3, "device_ops": len(dev),
           "step_ops": len(step),
           "runtime": {k: {"calls": n, "ms": tot / 1e3, "max_ms": mx / 1e3}
                       for k, (n, tot, mx) in sorted(
                           runtime.items(), key=lambda kv: -kv[1][1])[:6]}}
    if not step:
        return dict(out, step_span_ms=None, step_busy_share=None,
                    gaps=None, tick_busy_share=None,
                    busy_in_densify_ms=None, busy_in_dispatch_ms=None,
                    step_end_after_dispatch_ms=None,
                    first_op_after_dispatch_start_ms=None)
    merged = _union(step)
    lo, hi = merged[0][0], merged[-1][1]
    gaps = [b[0] - a[1] for a, b in zip(merged, merged[1:])]
    every = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    end = max(t1, hi)
    return dict(
        out, step_span_ms=(hi - lo) / 1e3,
        step_busy_share=_covered(merged, lo, hi) / (hi - lo),
        gaps=({"n": len(gaps), "median_us": statistics.median(gaps),
               "max_us": max(gaps), "sum_ms": sum(gaps) / 1e3,
               "over_100us": sum(1 for g in gaps if g > 100)}
              if gaps else None),
        tick_busy_share=_covered(every, t0, end) / (end - t0),
        busy_in_densify_ms=_covered(every, s0, s1) / 1e3,
        busy_in_dispatch_ms=_covered(every, d0, d1) / 1e3,
        step_end_after_dispatch_ms=(hi - d1) / 1e3,
        first_op_after_dispatch_start_ms=(lo - d0) / 1e3)


def serve_signed_phase(seeds, pubkeys, classes) -> dict:
    """Phase 8, part 1: three signed heights served through VoteService
    at I = 1,024 x V = 1,000 (validator 7 forged in both classes), warmup
    armed, the pump loop under sync debug mode "error", held against the
    offline path on a second driver; see the module docstring.  Returns
    the verify kernel's numbers for its JSON line, and the three heights'
    forged and honest signatures."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.crypto import ed25519_ref as ref
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import ShapeLadder, VoteService
    from agnes_tpu_torch.utils import budget
    from agnes_tpu_torch.utils.flightrec import FlightRecorder
    from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED

    I, Vn = I_SIGNED, V_SIGNED
    dev = torch.device(DEVICE)

    # -- fixture (outside the timed window): both classes of three
    # heights, forged and honest signatures, and their wire --
    t0 = time.perf_counter()
    sigs, honest = {}, {}
    for h in range(SERVE_HEIGHTS):
        for typ in classes:
            s = fx.sign_class(seeds, h, typ, VALUE, forge_validator=FORGED)
            msg = vote_messages_np(*[np.full(1, x, np.int64)
                                     for x in (h, 0, typ, VALUE)])[0]
            good = s.copy()
            good[FORGED] = np.frombuffer(ref.sign(seeds[FORGED],
                                                  msg.tobytes()), np.uint8)
            sigs[h, typ], honest[h, typ] = s, good
    cols = {(h, typ): fx.full_mesh_cols(I, Vn, seeds, h, typ, VALUE,
                                        sigs=sigs[h, typ])
            for h in range(SERVE_HEIGHTS) for typ in classes}
    wire = [b"".join(pack_wire_votes(*cols[h, typ]) for typ in classes)
            for h in range(SERVE_HEIGHTS)]
    log(f"[serve fixture] {SERVE_HEIGHTS} heights x 2 classes, "
        f"{len(wire[0]) * SERVE_HEIGHTS / 2**30:.2f} GiB of wire: "
        f"{time.perf_counter() - t0:.1f} s")

    box = {"h": 0}
    drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                       audit=True, device=dev)
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    flight = FlightRecorder()
    svc = VoteService(
        drv, bat, pubkeys, target_votes=2 * I * Vn, max_delay_s=0.0,
        window_predictor=lambda: (np.zeros(I, np.int64),
                                  np.full(I, box["h"], np.int64)),
        flightrec=flight)
    ladder = svc.ladder
    plan = budget.plan_lane_verify(ladder.max_rung,
                                   hbm_bytes=budget.device_hbm_bytes(dev))
    # each warmed signed shape's host launch (host clock) and device
    # time (CUDA events): the launch at the smallest rung is the host's
    # own cost of queueing the step's operations
    warm_iv = []
    signed = drv._signed

    def timed_signed(phases_st, *a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        out = signed(phases_st, *a, **k)
        ev[1].record()
        warm_iv.append((int(phases_st.mask.shape[0]),
                        int(a[1].pub.shape[0]), time.perf_counter() - t, ev))
        return out

    drv._signed = timed_signed
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    warmed = svc.pipeline.warmup(n_phases=(2, 3))
    t_warm = time.perf_counter() - t0
    warm_launches = V.LAUNCHES
    del drv._signed
    warm_ms = {(P, r): (host * 1e3, ev[0].elapsed_time(ev[1]))
               for P, r, host, ev in warm_iv}
    n_signed_shapes = sum(1 for k in svc.pipeline.warmed_keys
                          if k[0] == "signed")

    # per tick: host densify (perf_counter around stage), the host's
    # launch of the step (perf_counter around step_async) and the step's
    # device interval (CUDA events around it); one event anchors device
    # times to the host clock
    stage, dispatch = svc.pipeline.stage, drv.step_async
    dens, steps, launch = [], [], []
    kept = {}

    def timed_stage(*a, **k):
        t = time.perf_counter()
        out = stage(*a, **k)
        dens.append((t, time.perf_counter()))
        return out

    def timed_dispatch(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        out = dispatch(*a, **k)
        ev[1].record()
        launch.append((t, time.perf_counter()))
        steps.append(ev)
        if len(steps) == SERVE_HEIGHTS:
            # the last height's lanes, at the served launch shape (kept
            # from the last dispatch only: no extra height stays resident)
            kept["lanes"] = a[1]
        return out

    svc.pipeline.stage, drv.step_async = timed_stage, timed_dispatch
    torch.cuda.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    torch.cuda.synchronize()
    t_anchor = time.perf_counter()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss0 = _host_rss_gib()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for h in range(SERVE_HEIGHTS):
            box["h"] = h
            res = svc.submit(wire[h])
            if res.accepted != 2 * I * Vn:
                raise AssertionError(f"height {h} not admitted whole: {res}")
            svc.pump()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t_pumped = time.perf_counter()
    rep = svc.drain()
    wall = time.perf_counter() - t0
    serve_launches = V.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    rss1 = _host_rss_gib()
    svc.pipeline.stage, drv.step_async = stage, dispatch
    step_iv = [(t_anchor + anchor.elapsed_time(a) / 1e3,
                t_anchor + anchor.elapsed_time(b) / 1e3) for a, b in steps]
    step_ms = [a.elapsed_time(b) for a, b in steps]
    dens_ms = [(b - a) * 1e3 for a, b in dens]
    # the overlap: device time of step k spent while the host densified
    # the next height (densify k+1 runs right after dispatch k)
    # (the last height's step runs in drain, with no height behind it)
    paired = list(zip(step_iv[:SERVE_HEIGHTS - 1], dens[1:SERVE_HEIGHTS]))
    overlap = sum(max(0.0, min(s1, d1) - max(s0, d0))
                  for (s0, s1), (d0, d1) in paired)
    overlap_share = overlap / max(1e-9, sum(s1 - s0
                                            for (s0, s1), _ in paired))
    # ... and spent while the host was still launching that step
    in_launch = sum(max(0.0, min(s1, l1) - max(s0, l0))
                    for (s0, s1), (l0, l1) in zip(step_iv, launch))
    launch_share = in_launch / max(1e-9, sum(s1 - s0 for s0, s1 in step_iv))
    launch_ms = [(b - a) * 1e3 for a, b in launch]

    # -- the offline path on a second driver, the same three heights --
    off = DeviceDriver(I, Vn, advance_height=True, device=dev)
    obat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    t1 = time.perf_counter()
    for h in range(SERVE_HEIGHTS):
        obat.sync_device(np.zeros(I, np.int64), np.full(I, h, np.int64))
        for typ in classes:
            obat.add_arrays(*cols[h, typ])
        phases, lanes = obat.build_phases_device(pubkeys, phase_offset=1)
        off.step_seq_signed([off.empty_phase()] + [p for p, _ in phases],
                            lanes)
        del phases, lanes
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t1
    same = all(torch.equal(a, b) for a, b in zip(drv.state, off.state)) \
        and all(torch.equal(a, b) for a, b in zip(drv.tally, off.tally))
    n_votes = SERVE_HEIGHTS * 2 * I * Vn
    sig_dispatches = sum(1 for e in flight.tail(kind="dispatch")
                         if e.get("lanes") is not None)
    checks = {
        "every instance decided at every height":
            rep["decisions_total"] == SERVE_HEIGHTS * I
            and bool((drv.state.height == SERVE_HEIGHTS).all()),
        "2,048 rejected lanes a height":
            rep["rejected_signature_device"] == SERVE_HEIGHTS * 2 * I,
        "state and tally == offline, leaf for leaf": same,
        "decisions == offline": all(
            np.array_equal(getattr(drv.stats, f), getattr(off.stats, f))
            for f in ("decided", "decision_value", "decision_round"))
        and off.stats.decisions_total == rep["decisions_total"]
        and off.rejected_signature_device
        == rep["rejected_signature_device"],
        f"decided value {VALUE}": {x.value_id for x in
                                   rep["final_decisions"]} == {VALUE},
        "verify launches == warmed signed shapes + signed dispatches":
            warm_launches == n_signed_shapes
            and serve_launches == sig_dispatches == SERVE_HEIGHTS,
        "no off-ladder build, no retrace":
            rep["offladder_builds"] == 0
            and drv.sentinel.metrics.counters.get(RETRACE_UNEXPECTED, 0)
            == 0,
        "one dispatch a height": rep["dispatched_batches"] == SERVE_HEIGHTS,
    }
    if not all(checks.values()):
        raise AssertionError(f"signed serve failed: {checks}; report "
                             f"{ {k: rep[k] for k in ('decisions_total', 'rejected_signature_device', 'dispatched_batches', 'offladder_builds')} }; "
                             f"launches warm {warm_launches} / "
                             f"{n_signed_shapes}, serve {serve_launches} / "
                             f"{sig_dispatches}")
    # the verify kernel at the served launch shape against plain: the
    # last height's lanes (exact count, none padding) through the
    # prologue and the kernel, a sample of them through plain
    lanes = kept.pop("lanes")
    n_served = int(lanes.pub.shape[0])
    val = lanes.val.cpu().numpy()
    exact = n_served == 2 * I * Vn and bool(lanes.real.all())
    args, ok_s = V.prologue(lanes.pub, lanes.sig, lanes.blocks)
    got = V.verify_signed5(*args)
    rng = np.random.RandomState(SEED + 8)
    forged = np.nonzero(val == FORGED)[0]
    pick = rng.choice(np.nonzero(val != FORGED)[0],
                      N_SERVE_SAMPLE - len(forged), replace=False)
    idx = torch.from_numpy(np.sort(np.concatenate([pick, forged]))).to(dev)
    sub = [a[..., idx].contiguous() for a in args]
    plain = V.verify_plain(*sub)
    mism, max_err = compare(got[idx], plain)
    ok = ((got[idx] > 0) & ok_s[idx]).cpu().numpy()
    is_forged = val[idx.cpu().numpy()] == FORGED
    if not exact or mism or ok[is_forged].any() or not ok[~is_forged].all():
        raise AssertionError(
            f"served launch shape: {n_served} lanes (exact, no padding: "
            f"{exact}); kernel != plain on {mism} of {len(idx)} sampled "
            f"lanes, or a forged lane passed / an honest lane failed")
    del lanes, args, ok_s, got, sub, plain
    log(f"[serve] verify kernel at the served launch shape ({n_served} "
        f"lanes, none padding) == plain on a sample of {len(idx)} lanes "
        f"({int(is_forged.sum())} forged, all rejected)")

    lane_bytes = (budget.SIG_LANE_BYTES + budget.PUB_LANE_BYTES
                  + budget.BLOCK_LANE_BYTES)
    log(f"[serve] I={I} V={Vn} {ladder.describe()}; warmup {warmed} shapes "
        f"({n_signed_shapes} signed, {warm_launches} verify launches) "
        f"{t_warm:.3f} s")
    log("[serve] warmed signed shapes, host launch ms / device ms: " +
        ", ".join(f"P={P} {r}: {h:.1f} / {d:.1f}"
                  for (P, r), (h, d) in sorted(warm_ms.items())))
    log(f"[serve] {SERVE_HEIGHTS} heights, {n_votes} votes: wall "
        f"{wall:.3f} s (submit + pump loop {t_pumped - t0:.3f} s, drain "
        f"{t0 + wall - t_pumped:.3f} s) served votes/s={n_votes / wall:.0f};"
        f" offline path on the same heights {t_off:.3f} s "
        f"({n_votes / t_off:.0f}/s); verify launches {serve_launches}, "
        f"rejected {rep['rejected_signature_device']}")
    log(f"[serve] per tick: densify ms " + ", ".join(f"{x:.1f}"
                                                      for x in dens_ms)
        + "; step ms (CUDA events) " + ", ".join(f"{x:.1f}"
                                                 for x in step_ms)
        + "; the host's launch of each step ms " + ", ".join(
            f"{x:.1f}" for x in launch_ms)
        + f"; device time of the first {SERVE_HEIGHTS - 1} steps spent "
        f"while the host densified the next height {overlap * 1e3:.1f} ms "
        f"(overlap share {overlap_share:.3f}); share of all steps' device "
        f"time spent while the host was still launching them "
        f"{launch_share:.3f}")
    log(f"[serve] device peak {peak / 2**30:.3f} GiB (allocated before "
        f"{before / 2**30:.3f} GiB; peak - before {(peak - before) / 2**30:.3f}"
        f" GiB) against the top rung's plan {plan.peak_bytes / 2**30:.3f} "
        f"GiB ({plan.describe()}; one more height's resident lanes "
        f"{ladder.max_rung * lane_bytes / 2**30:.3f} GiB); host RSS "
        f"{rss0:.2f} GiB before the loop, {rss1:.2f} GiB after drain "
        f"(the three heights' wire and columns already resident); card "
        f"{smi('name,power.limit')}")
    log(f"[serve] no sync point between the first submit and drain "
        f"(sync debug mode \"error\"); flight events {flight.counts()}")
    tick = profiled_tick(wire, pubkeys)
    ANALYSIS["serves"].append(("phase 8 signed", ladder, False,
                               drv.sentinel))
    # phase 11 serves the same heights and is held against this driver
    ref = {"leaves": _leaves(drv),
           "stats": {f: getattr(drv.stats, f).copy()
                     for f in ("decided", "decision_value",
                               "decision_round")},
           "rejected": rep["rejected_signature_device"]}
    return {"_ref": ref,
            "launches_serve_phase": warm_launches + serve_launches,
            "launches_serve_warmup": warm_launches,
            "launches_serve_dispatch": serve_launches,
            "serve_votes_per_s": n_votes / wall,
            "serve_overlap_share": overlap_share,
            "serve_step_in_launch_share": launch_share,
            "serve_peak_bytes": peak - before,
            "serve_plan_peak_bytes": plan.peak_bytes,
            "serve_lanes": n_served,
            "serve_sample_mismatches": mism,
            "serve_sample_max_abs_err": max_err,
            "serve_tick_step_busy_share": tick["step_busy_share"],
            "serve_tick_busy_share": tick["tick_busy_share"],
            "serve_tick_launch_ms": tick["dispatch_ms"],
            "serve_tick_launch_call_ms": tick["runtime"].get(
                "cudaLaunchKernel", {}).get("ms")}, sigs, honest


def profiled_tick(wire, pubkeys) -> dict:
    """Phase 8, part 1's trace: a fresh service at I = 1,024 x V = 1,000
    stages height 0, then the tick that dispatches height 0's step and
    densifies height 1 runs under torch.profiler (CPU and CUDA
    activity); drain must then decide both heights.  The trace goes to
    `chiprun_out/serve_tick_trace.json` and is read by `trace_tick`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import VoteService

    I, Vn = I_SIGNED, V_SIGNED
    box = {"h": 0}
    drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                       device=DEVICE)
    svc = VoteService(
        drv, VoteBatcher(I, Vn, n_slots=4, device=DEVICE), pubkeys,
        target_votes=2 * I * Vn, max_delay_s=0.0,
        window_predictor=lambda: (np.zeros(I, np.int64),
                                  np.full(I, box["h"], np.int64)))
    stage, dispatch = svc.pipeline.stage, drv.step_async

    def ranged(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    svc.pipeline.stage = ranged("serve.densify", stage)
    drv.step_async = ranged("serve.dispatch", dispatch)
    svc.submit(wire[0])
    svc.pump()                                   # stages height 0
    box["h"] = 1
    svc.submit(wire[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serve.tick"):
            svc.pump()               # dispatch height 0, densify height 1
        torch.cuda.synchronize()
    rep = svc.drain()
    if rep["decisions_total"] != 2 * I or rep["dispatched_batches"] != 2:
        raise AssertionError(f"profiled service: {rep['decisions_total']} "
                             f"decisions, {rep['dispatched_batches']} "
                             f"dispatches")
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "serve_tick_trace.json")
    prof.export_chrome_trace(path)
    t = trace_tick(path)
    del svc, drv, prof
    rt = ", ".join(f"{k} {v['calls']} calls {v['ms']:.1f} ms (max "
                   f"{v['max_ms']:.3f})" for k, v in t["runtime"].items())
    head = (f"[serve trace] one tick (torch.profiler, {path}): tick "
            f"{t['tick_ms']:.1f} ms, the step's host launch "
            f"{t['dispatch_ms']:.1f} ms, densify {t['densify_ms']:.1f} ms; "
            f"{t['device_ops']} device operations, {t['step_ops']} of them "
            f"the step's")
    if t["step_busy_share"] is None:
        log(head + "; the profiler recorded no device activity: busy "
            "shares and gaps not measured; runtime calls in the launch: "
            + rt)
        return t
    g = t["gaps"] or {}
    log(head + f"; the step's device span {t['step_span_ms']:.1f} ms "
        f"(its first operation began {t['first_op_after_dispatch_start_ms']:.1f}"
        f" ms after the launch began, its last ended "
        f"{t['step_end_after_dispatch_ms']:+.1f} ms from the launch's "
        f"return), busy {t['step_busy_share']:.4f} of it; "
        f"gaps between its operations: {g.get('n')} (median "
        f"{g.get('median_us', 0):.1f} us, max {g.get('max_us', 0):.1f} us, "
        f"{g.get('over_100us')} over 100 us, {g.get('sum_ms', 0):.1f} ms in "
        f"all); card busy {t['tick_busy_share']:.4f} of the tick, "
        f"{t['busy_in_dispatch_ms']:.1f} ms during the launch and "
        f"{t['busy_in_densify_ms']:.1f} ms during the densify; runtime "
        f"calls in the launch: " + rt + f"; card {smi('name,power.limit')}")
    return t


def serve_dedup_phase(seeds, pubkeys, classes, sigs, honest) -> int:
    """Phase 8, part 2: the dedup cache at I = 64 x V = 1,000.  Each honest
    height is served, and its wire submitted again after its first copy
    settles; a service without the cache gets the same submits.  The
    copies must ride the pre-verified stream with no verify launch and
    leave the decisions as they are without the cache; a batch with a
    forged lane must cache nothing.  Returns the verify launches of the
    cached run."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import VoteService
    from agnes_tpu_torch.serve.queue import _record_digests

    I, Vn = I_DEDUP, V_SIGNED
    dev = torch.device(DEVICE)
    heights = SERVE_HEIGHTS - 1
    wire = [b"".join(pack_wire_votes(*fx.full_mesh_cols(
        I, Vn, seeds, h, typ, VALUE, sigs=honest[h, typ]))
        for typ in classes) for h in range(heights)]
    runs = {}
    for cached in (True, False):
        box = {"h": 0}
        drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                           device=dev)
        svc = VoteService(
            drv, VoteBatcher(I, Vn, n_slots=4, device=dev), pubkeys,
            target_votes=2 * I * Vn, max_delay_s=0.0,
            dedup_cache=cached or None,
            window_predictor=lambda: (np.zeros(I, np.int64),
                                      np.full(I, box["h"], np.int64)))
        torch.cuda.synchronize()
        V.LAUNCHES = 0
        t0 = time.perf_counter()
        hits = 0
        for h in range(heights):
            box["h"] = h
            for _copy in range(2):
                hits += svc.submit(wire[h]).pre_verified
                svc.pump()
                svc.pump()
                svc.poll_decisions()
        torch.cuda.synchronize()
        runs[cached] = dict(svc=svc, drv=drv, hits=hits,
                            launches=V.LAUNCHES,
                            wall=time.perf_counter() - t0)
    c, p = runs[True], runs[False]
    svc, drv = c["svc"], c["drv"]
    copies = heights * 2 * I * Vn
    same = all(torch.equal(a, b) for a, b in zip(drv.state, p["drv"].state)) \
        and all(torch.equal(a, b) for a, b in zip(drv.tally, p["drv"].tally))
    # a batch with a forged lane: it settles, and caches nothing
    box = {"h": heights}
    svc.pipeline.window_predictor = lambda: (
        np.zeros(I, np.int64), np.full(I, box["h"], np.int64))
    forged = pack_wire_votes(*fx.full_mesh_cols(
        I, Vn, seeds, heights, classes[0], VALUE,
        sigs=sigs[heights, classes[0]]))
    n_entries = len(svc.cache)
    svc.submit(forged)
    svc.pump()
    svc.pump()
    svc.poll_decisions()
    dig = _record_digests(forged, np.arange(len(forged) // 96))
    checks = {
        "copies admitted as cache hits": c["hits"] == copies,
        "copies rode the pre-verified stream":
            svc.pipeline.preverified_votes == copies,
        "copies added no verify launch": c["launches"] == heights
        and p["launches"] == 2 * heights,
        "decisions == without the cache": all(
            np.array_equal(getattr(drv.stats, f), getattr(p["drv"].stats, f))
            for f in ("decided", "decision_value", "decision_round"))
        and drv.stats.decisions_total == p["drv"].stats.decisions_total
        == heights * I,
        "state and tally == without the cache": same,
        "a forged batch caches nothing":
            svc.cache.counters["insert_skipped_rejected"] == 1
            and drv.rejected_signature_device == I
            and len(svc.cache) <= n_entries
            and not svc.cache.lookup(dig).any(),
    }
    if not all(checks.values()):
        raise AssertionError(f"dedup serve failed: {checks}; hits "
                             f"{c['hits']}, preverified "
                             f"{svc.pipeline.preverified_votes}, launches "
                             f"{c['launches']} / {p['launches']}")
    log(f"[serve dedup] I={I} V={Vn} {heights} heights, each sent twice: "
        f"{copies} copies were cache hits and rode the unsigned stream; "
        f"verify launches {c['launches']} with the cache, {p['launches']} "
        f"without; wall {c['wall']:.3f} s with, {p['wall']:.3f} s without; "
        f"cache {svc.cache.snapshot()}")
    return c["launches"]


def serve_bls_phase(fix) -> dict:
    """Phase 8, part 3: the BLS lane through a BLS-only VoteService at
    phase 6's configuration (its registry, stake and wire), warmup armed,
    the forged 4-signer class submitted beside the 8 honest ones.
    Decisions must equal phase 6's, the forged share be counted as
    dropped, and the field kernels' launches are returned."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.crypto import bls_field as BF
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import BlsLane, ShapeLadder, VoteService
    from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED

    I, Vn = I_BLS, V_BLS
    dev = torch.device(DEVICE)
    drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                       audit=True, device=dev)
    drv.set_validators(fix["powers"])
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    bat.set_validators(fix["powers"])
    lane = BlsLane(fix["reg"], I, target_signers=Vn, max_delay_s=1e9,
                   device=dev)
    svc = VoteService(drv, bat, None, bls_lane=lane,
                      ladder=ShapeLadder.plan(I, Vn).with_bls(Vn))
    torch.cuda.synchronize()
    BF.MUL_LAUNCHES = BF.REDUCE_LAUNCHES = 0
    t0 = time.perf_counter()
    warmed = svc.pipeline.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm = (BF.MUL_LAUNCHES, BF.REDUCE_LAUNCHES)
    t0 = time.perf_counter()
    res = svc.submit_bls(fix["wire"] + fix["f_wire"])
    svc.pump()
    svc.pump()
    dec = svc.poll_decisions()
    rep = svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bls_fp_mul": BF.MUL_LAUNCHES,
                "bls_fp_reduce": BF.REDUCE_LAUNCHES}
    snap = rep["bls"]
    checks = {
        "every share admitted": res.accepted == 2 * I * Vn + 4,
        "decisions == phase 6": all(
            np.array_equal(getattr(drv.stats, f), fix["stats"][f])
            for f in ("decided", "decision_value", "decision_round"))
        and len(dec) == I and {x.value_id for x in dec} == {VALUE},
        "the forged share dropped": snap["rejected_share_signature"] == 1
        and snap["fallback_classes"] == 1 and snap["fallback_votes"] == 3,
        "every class cleared on the device": snap["agg_classes"] == 2 * I
        and snap["bls_device_pairing_dispatches"] >= -(-2 * I // 4),
        "no retrace": drv.sentinel.metrics.counters.get(
            RETRACE_UNEXPECTED, 0) == 0,
        "field kernels launched": min(launches.values()) > 0
        and min(warm) > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"BLS serve failed: {checks}; {snap}")
    ANALYSIS["serves"].append(("phase 8 bls", svc.ladder, False,
                               drv.sentinel))
    log(f"[serve bls] I={I} V={Vn} {svc.ladder.describe()}; warmup "
        f"{warmed} shapes {t_warm:.3f} s (field kernel launches mul "
        f"{warm[0]}, reduce {warm[1]}); {2 * I * Vn + 4} shares served in "
        f"{wall:.3f} s, {2 * I} classes cleared on the device, the forged "
        f"share dropped; field kernel launches mul {launches['bls_fp_mul']}"
        f", reduce {launches['bls_fp_reduce']} (warmup included)")
    return launches


def host_plane_phase(bound) -> dict:
    """Phase 9: the host plane and the six benchmark configs on the
    card.  Configs 1, 3, 4, 5 and 6 at their full shapes through
    `harness.configs.run` (each config's JSON dict on a line of its
    own), then config 2, whose verify launches are counted alone: exactly
    one, of 2 x V = 200 lanes.  That launch's verdicts are held against
    `verify_plain` on the same inputs and against `ed25519_ref.verify`
    on the host; a batch of the same shape with one forged lane must be
    rejected on that lane only, by the kernel, plain and the oracle
    alike; the kernel and plain are timed at that shape.  Last, one node
    of a config-1 network is crashed after it decided height 1,
    restored from `save_executor` into a fresh executor with
    `load_executor_into`, and must decide its live height with its
    peers.  Returns row 1's additions."""
    import torch

    from agnes_tpu_torch.core.executor import ConsensusExecutor
    from agnes_tpu_torch.crypto import ed25519_ref as ref
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.crypto.ed25519 import (pack_verify_inputs,
                                                verify_batch)
    from agnes_tpu_torch.harness import configs
    from agnes_tpu_torch.harness.simulator import Network
    from agnes_tpu_torch.utils.checkpoint import (load_executor_into,
                                                  save_executor)

    t0 = time.perf_counter()
    secs = {}
    for n in (1, 3, 4, 5, 6):
        t = time.perf_counter()
        log(json.dumps(configs.run(n, device=DEVICE)))
        secs[n] = time.perf_counter() - t
        torch.cuda.empty_cache()

    # config 2: its launches alone
    torch.cuda.synchronize()
    V.LAUNCHES = V.LAUNCHES_W4 = 0
    t = time.perf_counter()
    r2, lanes, ok = configs.config2_verify_lanes(device=DEVICE)
    secs[2] = time.perf_counter() - t
    launches = (V.LAUNCHES, V.LAUNCHES_W4)
    log(json.dumps(r2))
    n_lanes = int(ok.shape[0])
    if launches != (1, 0) or n_lanes != 200 or r2["validators"] != 100:
        raise AssertionError(f"config 2: verify launches (W5, W4) "
                             f"{launches} of {n_lanes} lanes, expected one "
                             f"W5 launch of 200")
    args, ok_s = V.prologue(*lanes)
    plain = (V.verify_plain(*args) > 0) & ok_s
    mism, max_err = compare(ok.int(), plain.int())
    pks, msgs, sigs, _ = configs.config2_votes(r2["validators"])
    host = [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    if mism or ok.cpu().tolist() != host:
        raise AssertionError(f"config 2's launch: {mism} lanes != plain, "
                             f"or != the host oracle")
    # the same shape with one forged lane (S + 1): rejected there only
    forged = list(sigs)
    k = n_lanes // 3
    s_int = int.from_bytes(sigs[k][32:], "little")
    forged[k] = sigs[k][:32] + ((s_int + 1) % ref.L).to_bytes(32, "little")
    lanes_f = pack_verify_inputs(pks, msgs, forged, device=DEVICE)
    got_f = verify_batch(*lanes_f)
    args_f, ok_sf = V.prologue(*lanes_f)
    plain_f = (V.verify_plain(*args_f) > 0) & ok_sf
    want_f = [i != k for i in range(n_lanes)]
    host_f = [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, forged)]
    mism_f, err_f = compare(got_f.int(), plain_f.int())
    if mism_f or got_f.cpu().tolist() != want_f or host_f != want_f:
        raise AssertionError(f"forged lane {k}: kernel {mism_f} lanes != "
                             f"plain, or the verdicts are not {want_f}")
    # the kernel and plain at config 2's launch shape
    V.verify_signed5(*args)                      # warm
    ms = cuda_ms(lambda: V.verify_signed5(*args), 20)
    plain_ms = cuda_ms(lambda: V.verify_plain(*args), 1)
    bound_ms, bound_by = bound(V.INT32_OPS_PER_LANE * n_lanes,
                               V.BYTES_PER_LANE * n_lanes)

    # crash and restore one node of a config-1 network
    t = time.perf_counter()
    net = Network(n=4)
    net.start()
    net.run_until(lambda: net.decided(1))
    victim = 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "node.json")
        save_executor(net.nodes[victim], path)
        fresh = ConsensusExecutor(net.vset, index=victim,
                                  seed=net.seeds[victim],
                                  get_value=net.get_value)
        h, decided = load_executor_into(fresh, path)
    if decided != net.nodes[victim].decided or h < 2:
        raise AssertionError(f"restored executor at height {h}, decided "
                             f"{decided}")
    net.nodes[victim] = fresh
    net._delivered[victim] = 0
    net.run_until(lambda: net.decided(h))
    dec = {(nd.decided[h].round, nd.decided[h].value) for nd in net.nodes}
    if len(dec) != 1 or next(iter(dec))[1] != 100 + h:
        raise AssertionError(f"height {h} after the restore: {dec}")
    secs["restore"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    per = ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
    log(f"[configs] seconds per config {per}; config 2: 1 verify launch of {n_lanes} lanes == plain and the "
        f"host oracle, forged lane {k} rejected; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) at "
        f"{n_lanes} lanes; restored node {victim} decided height {h} "
        f"{next(iter(dec))} with its peers; phase 9 {wall:.3f} s")
    return {"launches_configs_phase": launches[0],
            "configs_lanes": n_lanes, "configs_mismatches": mism + mism_f,
            "configs_max_abs_err": max(max_err, err_f),
            f"ms_{n_lanes}": ms, f"plain_ms_{n_lanes}": plain_ms,
            f"bound_ms_{n_lanes}": bound_ms, "configs_phase_s": wall}


class StageClock:
    """Stage times of one run, from the smoke: `wrap` replaces a function
    or method for the run with one that times it on the host clock,
    exclusive of the wrapped functions it calls (inclusive beside), and,
    for a stage that copies to the card (`sync=True`), synchronizes the
    card on entry and exit so its time holds its copies; `events` times
    a function's device work by CUDA events (the host clock on the CPU).
    `restore` puts every original back.  Nothing in the package changes:
    the wrappers live in this script."""

    def __init__(self, dev):
        from collections import defaultdict

        self.dev = dev
        self.excl = defaultdict(float)
        self.incl = defaultdict(float)
        self.calls = defaultdict(int)
        self.ev = defaultdict(list)
        self.keep = set()            # `events` keys whose last output to keep
        self.last = {}
        self._stack = []
        self._undo = []

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def wrap(self, owner, attr, key, sync=False):
        orig = getattr(owner, attr)

        def timed(*a, **k):
            name = key(self._stack) if callable(key) else key
            if sync:
                self.sync()
            self._stack.append([name, 0.0])
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                if sync:
                    self.sync()
                dt = time.perf_counter() - t
                child = self._stack.pop()[1]
                self.incl[name] += dt
                self.excl[name] += dt - child
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1][1] += dt

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def events(self, owner, attr, key):
        import torch

        orig = getattr(owner, attr)

        def timed(*a, **k):
            if self.dev.type != "cuda":
                t = time.perf_counter()
                out = orig(*a, **k)
                self.ev[key].append(time.perf_counter() - t)
            else:
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = orig(*a, **k)
                e.record()
                self.ev[key].append((s, e))
            if key in self.keep:
                self.last[key] = out
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def under(self, parent, inside, outside):
        """A key that depends on whether the call runs inside `parent`."""
        return lambda stack: inside if any(n == parent for n, _ in stack) \
            else outside

    def device_ms(self, key) -> float:
        """Total device ms of an `events` stage (synchronizes)."""
        self.sync()
        return sum(x * 1e3 if isinstance(x, float)
                   else x[0].elapsed_time(x[1]) for x in self.ev[key])

    def reset(self) -> None:
        for d in (self.excl, self.incl, self.calls, self.ev):
            d.clear()

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []


class RssPeak:
    """The peak of this process's resident set while a block runs,
    sampled every 20 ms from /proc/self/status by a thread (the
    process's lifetime peak is phase 3n's, so it cannot be read
    afterwards)."""

    def __enter__(self):
        import threading

        self.start = self.peak = _host_rss_gib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, _host_rss_gib())

        self._t = threading.Thread(target=sample, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, _host_rss_gib())


def _leaves(drv) -> list:
    """Copies of a driver's state and tally leaves."""
    return [x.clone() for part in (drv.state, drv.tally) for x in part]


def _same_leaves(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _decisions(drv, decode) -> tuple:
    """(decided, decoded value, round) of every instance."""
    import numpy as np

    st = drv.stats
    vals = np.array([decode(i, int(s)) if d else -1 for i, (d, s) in
                     enumerate(zip(st.decided, st.decision_value))])
    return (st.decided.copy(), vals, st.decision_round.copy())


def _same_decisions(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))




def native_ingest_phase(seeds, pubkeys, sigs, python_rate, north_rate,
                        north_decisions) -> dict:
    """Phase 10: the C++ ingest loop (`bridge.NativeIngestLoop`); see the
    module docstring.  Returns its numbers for the verify kernel's
    line."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge import ingest as ING
    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.bridge.native_ingest import (NativeIngestLoop,
                                                      pack_wire_votes)
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.types import VoteType

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    I, Vn, H = I_SIGNED, V_SIGNED, NATIVE_HEIGHTS
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    clock = StageClock(dev)
    n = 2 * I * Vn
    t0 = time.perf_counter()
    hsigs = [sigs] + [[fx.sign_class(seeds, h, typ, VALUE,
                                     forge_validator=FORGED)
                       for typ in classes] for h in range(1, H)]
    cols = [[fx.full_mesh_cols(I, Vn, seeds, h, typ, VALUE, sigs=hsigs[h][c])
             for c, typ in enumerate(classes)] for h in range(H)]
    wires = [[pack_wire_votes(*c) for c in hc] for hc in cols]
    log(f"[native] fixture: {2 * Vn * (H - 1)} C++ signatures for heights "
        f"1-{H - 1}, columns and wire of {H} heights "
        f"({2 * len(wires[0][0]) / 2**20:.0f} MiB of wire a height): "
        f"{time.perf_counter() - t0:.1f} s")

    def window(drv):
        return (drv.tally.base_round.cpu().numpy(),
                drv.state.height.cpu().numpy())

    def height_checks(who, drv, bridge, h, decs, rejected):
        d, v, r = _decisions(drv, bridge.decode_slot)
        if not (d.all() and (v == VALUE).all() and (r == 0).all()
                and drv.stats.decisions_total == I * (h + 1)
                and rejected == 2 * I):
            raise AssertionError(
                f"{who}, height {h}: decided {int(d.sum())} of {I}, "
                f"values {set(v.tolist())}, total "
                f"{drv.stats.decisions_total}, rejected {rejected}")
        decs.append((d, v, r))

    # -- 1. the Python bridge, stage by stage -------------------------------
    py_keys = ("add_arrays", "_device_verify_eligible", "_intern_slots",
               "_emit", "phase uploads", "_pack_verify_inputs_np",
               "_sha_blocks_np", "lane uploads", "build_phases_device",
               "step")
    py_walls, py_decs, py_leaves = [], [], []
    try:
        clock.wrap(VoteBatcher, "add_arrays", "add_arrays")
        for m in ("build_phases_device", "_device_verify_eligible",
                  "_intern_slots", "_emit", "_pack_verify_inputs_np"):
            clock.wrap(VoteBatcher, m, m)
        clock.wrap(ING, "_sha_blocks_np", "_sha_blocks_np")
        clock.wrap(VoteBatcher, "_to_device",
                   clock.under("_emit", "phase uploads", "lane uploads"),
                   sync=True)
        clock.events(V, "prologue", "prologue")
        clock.events(V, "verify_signed5", "kernel")
        drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
        bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
        V.LAUNCHES = 0
        for h in range(H):
            if h == 1:
                clock.reset()                   # height 0 warms
            bat.sync_device(*window(drv))
            rej0 = drv.rejected_signature_device
            clock.sync()
            t = time.perf_counter()
            for c in cols[h]:
                bat.add_arrays(*c)
            phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
            if lanes is None:
                raise AssertionError("the Python bridge left the device path")
            ts = time.perf_counter()
            drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases],
                                lanes)
            clock.sync()
            clock.excl["step"] += time.perf_counter() - ts
            clock.calls["step"] += 1
            py_walls.append(time.perf_counter() - t)
            height_checks("Python bridge", drv, bat, h, py_decs,
                          drv.rejected_signature_device - rej0)
            py_leaves.append(_leaves(drv))
        py_launches = V.LAUNCHES
        py_ms = {k: clock.excl[k] * 1e3 / (H - 1) for k in py_keys}
        py_ms.update({k: clock.device_ms(k) / (H - 1)
                      for k in ("prologue", "kernel")})
    finally:
        clock.restore()
    del drv, bat, phases, lanes
    py_wall = sum(py_walls[1:]) / (H - 1)
    if py_launches != H:
        raise AssertionError(f"Python bridge: {py_launches} verify launches "
                             f"over {H} heights")
    log("[native] Python bridge, ms a height over heights 1-"
        f"{H - 1} (host clock, exclusive of the nested stages; "
        "`build_phases_device` is its own rest; uploads synchronized; "
        "prologue and kernel by CUDA events inside the step): "
        + ", ".join(f"{k} {v:.1f}" for k, v in py_ms.items())
        + f"; wall {py_wall * 1e3:.1f} ms a height, {n / py_wall:.0f} "
        f"verified votes/s (height 0 {py_walls[0] * 1e3:.1f} ms; phase 3, "
        f"one height on fresh objects: {python_rate:.0f}/s)")

    # -- 2-3. the C++ loop, synchronous then overlapped ------------------------
    nat_keys = ("push", "stage + fill", "upload", "verify",
                "apply + emit", "phase upload", "step")
    runs = {}
    try:
        clock.wrap(NativeIngestLoop, "push", "push")
        clock.wrap(NativeIngestLoop, "push_async", "push")
        clock.wrap(NativeIngestLoop, "_stage", "stage + fill")
        clock.wrap(NativeIngestLoop, "_verify", "verify")
        clock.wrap(NativeIngestLoop, "_to_device", "upload", sync=True)
        clock.wrap(NativeIngestLoop, "_apply_and_emit", "apply + emit")
        clock.wrap(NativeIngestLoop, "_phases", "phase upload", sync=True)
        clock.events(V, "prologue", "prologue")
        clock.events(V, "verify_signed5", "kernel")
        for overlapped in (False, True):
            loop = NativeIngestLoop(I, Vn, n_slots=4, pubkeys=pubkeys,
                                    device=dev)
            drv = DeviceDriver(I, Vn, advance_height=True, device=dev,
                               defer_collect=overlapped)
            r = {"walls": [], "decs": [], "launches": [], "depth": [],
                 "leaves": []}
            for h in range(H):
                if h == 1:
                    clock.reset()
                    t1 = time.perf_counter()
                if h == 1 and not overlapped:
                    clock.keep = {"prologue", "kernel"}
                rej0 = loop.counters["rejected_signature"]
                V.LAUNCHES = 0
                if not overlapped:
                    clock.sync()
                t = time.perf_counter()
                if overlapped:
                    # the worker parses both classes while the card runs
                    # the last height's step and this entry step; reading
                    # the window waits for them; nothing else blocks
                    drv.step_async([drv.empty_phase()])
                    for w in wires[h]:
                        loop.push_async(w)
                    loop.sync_device(*window(drv))
                    r["depth"].append(loop.async_depth)
                    phases = loop.build_phases()
                    ts = time.perf_counter()
                    drv.step_async([p for p, _ in phases])
                else:
                    win = window(drv)
                    loop.sync_device(*win)
                    for w in wires[h]:
                        loop.push(w)
                    phases = loop.build_phases()
                    ts = time.perf_counter()
                    drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
                    clock.sync()
                clock.excl["step"] += time.perf_counter() - ts
                clock.calls["step"] += 1
                r["walls"].append(time.perf_counter() - t)
                r["launches"].append(V.LAUNCHES)
                clock.keep = set()
                rejected = loop.counters["rejected_signature"] - rej0
                if overlapped:
                    if rejected != 2 * I:
                        raise AssertionError(f"C++ loop overlapped, height "
                                             f"{h}: rejected {rejected}")
                else:
                    height_checks("C++ loop", drv, loop, h, r["decs"],
                                  rejected)
                r["leaves"].append(_leaves(drv))
                if h == 1 and not overlapped:
                    r["phases"], r["window"] = phases, win
            if overlapped:
                drv.block_until_ready()
                r["wall"] = (time.perf_counter() - t1) / (H - 1)
                height_checks("C++ loop overlapped", drv, loop, H - 1,
                              r["decs"], 2 * I)
                r["decs"] = [r["decs"][0]] * H
            else:
                r["wall"] = sum(r["walls"][1:]) / (H - 1)
            r["ms"] = {k: clock.excl[k] * 1e3 / (H - 1) for k in nat_keys}
            r["ms"].update({k: clock.device_ms(k) / (H - 1)
                            for k in ("prologue", "kernel")})
            runs[overlapped] = r
            del loop, drv
    finally:
        clock.restore()
    for overlapped, r in runs.items():
        name = "overlapped" if overlapped else "synchronous"
        if r["launches"] != [1] * H:
            raise AssertionError(f"C++ loop ({name}): verify launches a "
                                 f"height {r['launches']}, not 1")
        for h in range(H):
            if not (_same_leaves(r["leaves"][h], py_leaves[h])
                    and _same_decisions(r["decs"][h], py_decs[h])):
                raise AssertionError(f"C++ loop ({name}), height {h}: state,"
                                     f" tally or decisions differ from the "
                                     f"Python bridge's")
    sync_run = runs[False]
    nat_wall, ovl_wall = sync_run["wall"], runs[True]["wall"]
    del py_leaves
    for r in runs.values():
        del r["leaves"]

    # the loop's phases at height 1 == VoteBatcher.build_phases(pubkeys)'s
    # (host-verified) on the same wire; one more verify launch, not the
    # loop's
    ref = VoteBatcher(I, Vn, n_slots=4, device=dev)
    ref.sync_device(*sync_run["window"])
    for c in cols[1]:
        ref.add_arrays(*c)
    want = ref.build_phases(pubkeys)
    got = sync_run.pop("phases")
    same = len(got) == len(want) and all(
        na == nb and all(torch.equal(x, y) for x, y in zip(pa, pb))
        for (pa, na), (pb, nb) in zip(got, want))
    if not same:
        raise AssertionError("C++ loop phases != VoteBatcher.build_phases "
                             "on the same wire")
    del got, want, ref

    # the loop's one launch at height 1 against plain: its verdicts on
    # every lane (forged exactly where validator 7 signed), and kernel ==
    # plain on a sample holding every forged lane
    (args, ok_s), out = clock.last.pop("prologue"), clock.last.pop("kernel")
    verdict = ((out > 0) & ok_s).cpu().numpy()
    val = np.tile(np.arange(Vn), 2 * I)
    if not np.array_equal(verdict, val != FORGED):
        raise AssertionError("C++ loop's verify launch: verdicts are not "
                             "'every lane but validator 7's'")
    rng = np.random.RandomState(SEED + 10)
    forged = np.nonzero(val == FORGED)[0]
    honest = np.nonzero(val != FORGED)[0]
    idx = np.sort(np.concatenate([forged, rng.choice(
        honest, N_NATIVE_SAMPLE - len(forged), replace=False)]))
    sel = torch.from_numpy(idx).to(dev)
    plain = V.verify_plain(*[a[..., sel] for a in args])
    mism, max_err = compare(out[sel], plain)
    if mism:
        raise AssertionError(f"C++ loop's verify launch: kernel != plain on "
                             f"{mism} of {len(idx)} sampled lanes")
    del args, ok_s, out, plain, sel
    log(f"[native] kernel == plain on {len(idx)} sampled lanes of the "
        f"loop's {n}-lane launch ({len(forged)} forged, all rejected); "
        f"verdicts reject exactly validator {FORGED}'s {2 * I} lanes; the "
        f"loop's phases == VoteBatcher.build_phases(pubkeys)'s on the same "
        f"wire")
    for overlapped, r in runs.items():
        wall = ovl_wall if overlapped else nat_wall
        log(f"[native] C++ loop{' overlapped' if overlapped else ''}, ms a "
            f"height over heights 1-{H - 1} (host clock, exclusive; "
            f"`verify` holds the prologue and kernel launches and the "
            f"verdicts' read-back, their device times beside; uploads "
            f"synchronized): "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["ms"].items())
            + f"; wall {wall * 1e3:.1f} ms a height, {n / wall:.0f} verified "
            f"votes/s (height 0 {r['walls'][0] * 1e3:.1f} ms); 1 verify "
            f"launch a "
            f"height; state and tally == the Python bridge's at every "
            f"height, decisions {'at the end' if overlapped else 'too'}; "
            f"{2 * I} rejected a height"
            + (f"; async_depth at build_phases {r['depth']}"
               if overlapped else ""))
    del cols, wires
    torch.cuda.empty_cache()

    # -- 4. one north-star height through the loop ----------------------------
    In = I_NORTH
    t0 = time.perf_counter()
    wn = []
    for c, typ in enumerate(classes):
        col = fx.full_mesh_cols(In, Vn, seeds, 0, typ, VALUE, sigs=sigs[c])
        wn.append(pack_wire_votes(*col))
        del col
    t_wire = time.perf_counter() - t0
    nn = 2 * In * Vn
    loop = NativeIngestLoop(In, Vn, n_slots=4, pubkeys=pubkeys, device=dev)
    drv = DeviceDriver(In, Vn, advance_height=True, device=dev)
    try:
        clock.wrap(NativeIngestLoop, "push", "push")
        clock.wrap(NativeIngestLoop, "_stage", "stage + fill")
        clock.wrap(NativeIngestLoop, "_verify", "verify")
        clock.wrap(NativeIngestLoop, "_to_device", "upload", sync=True)
        clock.wrap(NativeIngestLoop, "_apply_and_emit", "apply + emit")
        clock.wrap(NativeIngestLoop, "_phases", "phase upload", sync=True)
        clock.events(V, "prologue", "prologue")
        clock.events(V, "verify_signed5", "kernel")
        clock.reset()
        V.LAUNCHES = 0
        clock.sync()
        with RssPeak() as rss:
            t = time.perf_counter()
            loop.sync_device(np.zeros(In, np.int64), np.zeros(In, np.int64))
            for w in wn:
                loop.push(w)
            phases = loop.build_phases()
            ts = time.perf_counter()
            drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
            clock.sync()
            t_step = time.perf_counter() - ts
            wall = time.perf_counter() - t
        ns_launches = V.LAUNCHES
        ns_ms = {k: clock.excl[k] * 1e3 for k in nat_keys[:-1]}
        ns_ms["step"] = t_step * 1e3
        ns_ms.update({k: clock.device_ms(k) for k in ("prologue", "kernel")})
    finally:
        clock.restore()
    decs = _decisions(drv, loop.decode_slot)
    checks = {
        "one verify launch": ns_launches == 1,
        "rejected == 2I": loop.counters["rejected_signature"] == 2 * In,
        "decisions == phase 3n's": _same_decisions(decs, north_decisions),
        "all decided 7 in round 0": bool(decs[0].all()
                                         and (decs[1] == VALUE).all()
                                         and (decs[2] == 0).all()),
        "heights advanced": bool((drv.state.height == 1).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"north-star height through the C++ loop: "
                             f"{checks}")
    log(f"[native] north-star height through the C++ loop, I={In} V={Vn}, "
        f"{nn} lanes: wall {wall:.3f} s, {nn / wall:.0f} verified votes/s "
        f"(phase 3n's Python bridge in this run: {north_rate:.0f}/s; "
        f">= 1M/s needs < {nn / 1e6:.0f} s); ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ns_ms.items())
        + f"; {ns_launches} verify launch; host RSS peak {rss.peak:.2f} GiB "
        f"(sampled; {rss.start:.2f} as it started); wire packed "
        f"before the window in {t_wire:.1f} s; decisions == phase 3n's; "
        f"card {smi('name,power.limit')}")
    del loop, drv, phases, wn
    torch.cuda.empty_cache()
    t_all = time.perf_counter() - t_phase
    log(f"[native] phase 10 {t_all:.1f} s")
    return {"launches_native_phase": sum(runs[False]["launches"])
            + sum(runs[True]["launches"]) + ns_launches,
            "native_sample_lanes": int(len(idx)),
            "native_sample_mismatches": mism,
            "native_sample_max_abs_err": max_err,
            "native_votes_per_s": n / nat_wall,
            "native_overlapped_votes_per_s": n / ovl_wall,
            "native_async_depth": runs[True]["depth"],
            "python_bridge_votes_per_s": n / py_wall,
            "python_bridge_phase3_votes_per_s": python_rate,
            "python_bridge_stage_ms": py_ms,
            "native_stage_ms": runs[False]["ms"],
            "native_overlapped_stage_ms": runs[True]["ms"],
            "native_north_star_wall_s": wall,
            "native_north_star_votes_per_s": nn / wall,
            "native_north_star_stage_ms": ns_ms,
            "native_north_star_rss_peak_gib": rss.peak,
            "native_north_star_rss_start_gib": rss.start,
            "native_phase_s": t_all}


def _sample_vs_plain(lanes, seed: int):
    """The verify kernel against plain on N_SERVE_SAMPLE lanes of one
    dispatched build, every forged lane among them: (lanes, sampled,
    mismatches, max_abs_err, forged sampled, verdicts right)."""
    import numpy as np
    import torch

    from agnes_tpu_torch.crypto import ed25519_verify as V

    val = lanes.val.cpu().numpy()
    args, ok_s = V.prologue(lanes.pub, lanes.sig, lanes.blocks)
    got = V.verify_signed5(*args)
    rng = np.random.RandomState(seed)
    forged = np.nonzero(val == FORGED)[0]
    pick = rng.choice(np.nonzero(val != FORGED)[0],
                      N_SERVE_SAMPLE - len(forged), replace=False)
    idx = torch.from_numpy(np.sort(np.concatenate([pick, forged]))).to(
        lanes.val.device)
    plain = V.verify_plain(*[a[..., idx].contiguous() for a in args])
    mism, max_err = compare(got[idx], plain)
    ok = ((got[idx] > 0) & ok_s[idx]).cpu().numpy()
    is_forged = val[idx.cpu().numpy()] == FORGED
    right = not ok[is_forged].any() and bool(ok[~is_forged].all())
    return (int(val.shape[0]), len(idx), mism, max_err,
            int(is_forged.sum()), right)


def _lane_order(lanes, I, V):
    """The permutation that sorts a SignedLanes' lanes by (phase,
    instance, validator), on the card."""
    import torch

    pub, sig, blocks, phase_idx, inst, val, real = lanes
    key = (phase_idx.long() * I + inst.long()) * V + val.long()
    return torch.argsort(key, stable=True)


def native_serve_phase(seeds, pubkeys, sigs, ref) -> dict:
    """Phase 11: native admission and the threaded host, phase 8's three
    signed heights served four ways; see the module docstring.  `sigs`
    are phase 8's signatures by (height, class), `ref` its served
    driver's leaves, decisions and rejected lanes.  Returns the numbers
    for the verify kernel's line."""
    import threading

    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import VoteService, threaded_service
    from agnes_tpu_torch.types import VoteType
    from agnes_tpu_torch.utils import budget
    from agnes_tpu_torch.utils.metrics import (SERVE_DISPATCH_BUSY_FRAC,
                                               SERVE_NATIVE_DRAIN_WALL_S,
                                               SERVE_SUBMIT_BUSY_FRAC)

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    I, Vn, H = I_SIGNED, V_SIGNED, SERVE_HEIGHTS
    n = 2 * I * Vn
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    t0 = time.perf_counter()
    wire = [b"".join(pack_wire_votes(*fx.full_mesh_cols(
        I, Vn, seeds, h, typ, VALUE, sigs=sigs[h, typ])) for typ in classes)
        for h in range(H)]
    step = NATIVE_SERVE_CHUNK * 96
    chunks = [[w[k:k + step] for k in range(0, len(w), step)] for w in wire]
    log(f"[native serve] fixture: phase 8's {H} heights of wire, "
        f"{len(chunks[0])} chunks of {NATIVE_SERVE_CHUNK} records a height "
        f"for the threaded run: {time.perf_counter() - t0:.1f} s")
    plan = None
    stream_ref = []          # the Python-admission run's dispatch stream
    out = {}

    def serve(name, native, shards=1, threaded=False):
        nonlocal plan
        drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                           device=dev)
        bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
        kw = dict(target_votes=n, native_admission=native,
                  native_shards=shards)
        if threaded:
            # size closes only (one batch a height); room for every
            # height, which the producers may queue before the drains
            tsvc = threaded_service(
                drv, bat, pubkeys, inbox_capacity=H * len(chunks[0]),
                max_delay_s=1e9, capacity=H * n, **kw)
            svc = tsvc.service
        else:
            svc = VoteService(drv, bat, pubkeys, max_delay_s=0.0, **kw)
        if plan is None:
            plan = budget.plan_lane_verify(
                svc.ladder.max_rung, hbm_bytes=budget.device_hbm_bytes(dev))
        # batch k is height k: the predictor reads the pipeline's build
        # count, which is k from the drain of batch k to its stage
        pipe = svc.pipeline
        pipe.window_predictor = lambda: (np.zeros(I, np.int64),
                                         np.full(I, pipe.tick_seq,
                                                 np.int64))
        ivs = {"drain": [], "stage": [], "launch": [], "submit": []}
        steps, kept, shape_bad = [], {}, []
        mism = torch.zeros((), dtype=torch.int64, device=dev)

        def timed(key, fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    ivs[key].append((t, time.perf_counter()))
            return run

        step_async = drv.step_async

        def dispatch(phases, lanes=None, exts=None, tick=None):
            # the stream against the Python-admission run's, on the card
            # (counted into `mism`, read after the run: no sync here)
            k = len(steps)
            leaves = [x for p in phases for x in p] + list(lanes or ())
            if name == "python":
                stream_ref.append([x.clone() for x in leaves])
            elif k >= len(stream_ref) or len(leaves) != len(stream_ref[k]) \
                    or any(a.shape != b.shape or a.dtype != b.dtype
                           for a, b in zip(leaves, stream_ref[k])):
                shape_bad.append(k)
            else:
                ref_leaves = stream_ref[k]
                nl = len(lanes) if threaded and lanes is not None else 0
                for a, b in zip(leaves[:len(leaves) - nl],
                                ref_leaves[:len(leaves) - nl]):
                    mism.add_((a != b).sum())
                if nl:
                    # four producers interleave a height's blobs, so the
                    # lanes arrive in another order: compare them sorted
                    # by (phase, instance, validator), a key unique to a
                    # lane, one field at a time
                    oa = _lane_order(leaves[-nl:], I, Vn)
                    ob = _lane_order(ref_leaves[-nl:], I, Vn)
                    for a, b in zip(leaves[-nl:], ref_leaves[-nl:]):
                        mism.add_((a[oa] != b[ob]).sum())
            if k == H - 1 and name == "native":
                kept["lanes"] = lanes
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t = time.perf_counter()
            ev[0].record()
            res = step_async(phases, lanes, exts, tick=tick)
            ev[1].record()
            ivs["launch"].append((t, time.perf_counter()))
            steps.append(ev)
            return res

        drv.step_async = dispatch
        pipe.stage = timed("stage", pipe.stage)
        svc.queue.drain = timed("drain", svc.queue.drain)
        # the micro-batcher's polls that closed nothing (the threaded
        # dispatch loop's idle polls: queue depth, the deadline's
        # oldest_ts)
        idle = {"n": 0, "s": 0.0}
        poll = svc.micro.poll

        def counted_poll(*a, **k):
            t = time.perf_counter()
            b = poll(*a, **k)
            if b is None:
                idle["n"] += 1
                idle["s"] += time.perf_counter() - t
            return b

        svc.micro.poll = counted_poll
        torch.cuda.synchronize()
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        torch.cuda.synchronize()
        t_anchor = time.perf_counter()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        V.LAUNCHES = 0
        polled = []
        busy = None
        t0 = time.perf_counter()
        if threaded:
            for h in range(H):
                def producer(p, h=h):
                    for c in chunks[h][p::NATIVE_SERVE_PRODUCERS]:
                        if not tsvc.submit(c):
                            raise AssertionError("the inbox refused a "
                                                 "chunk")

                ts = [threading.Thread(target=producer, args=(p,),
                                       daemon=True)
                      for p in range(NATIVE_SERVE_PRODUCERS)]
                t1 = time.perf_counter()
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=300)
                if any(t.is_alive() for t in ts):
                    raise AssertionError("a producer thread hung")
                ivs["submit"].append((t1, time.perf_counter()))
                polled += tsvc.poll_decisions()
            # every height dispatched by the loops before the drain
            t_end = time.perf_counter() + 600
            while pipe.dispatched_votes < H * n:
                if time.perf_counter() > t_end or tsvc.failure is not None:
                    raise AssertionError(
                        f"threaded: {pipe.dispatched_votes} of {H * n} "
                        f"votes dispatched ({tsvc.failure!r})")
                time.sleep(0.005)
            rep = tsvc.drain(timeout_s=300)
            wall = time.perf_counter() - t0
            busy = {k: s / wall for k, s in tsvc.busy_seconds().items()}
        else:
            for h in range(H):
                t1 = time.perf_counter()
                res = svc.submit(wire[h])
                ivs["submit"].append((t1, time.perf_counter()))
                if res.accepted != n:
                    raise AssertionError(f"{name}: height {h} not admitted "
                                         f"whole: {res}")
                svc.pump()
                polled += svc.poll_decisions()
            rep = svc.drain()
            wall = time.perf_counter() - t0
        launches = V.LAUNCHES
        peak = torch.cuda.max_memory_allocated() - before
        polled += rep["final_decisions"]
        step_iv = [(t_anchor + anchor.elapsed_time(a) / 1e3,
                    t_anchor + anchor.elapsed_time(b) / 1e3)
                   for a, b in steps]
        # device time of the steps spent while the host drained or
        # staged (the densify of a later height)
        host = _union(ivs["drain"] + ivs["stage"])
        overlap_share = (sum(_covered(host, a, b) for a, b in step_iv)
                         / max(1e-9, sum(b - a for a, b in step_iv)))
        q, st = rep["queue"], drv.stats
        checks = {
            "every instance decided at every height":
                rep["decisions_total"] == H * I
                and bool((drv.state.height == H).all()),
            "2,048 rejected lanes a height, as phase 8":
                rep["rejected_signature_device"] == H * 2 * I
                == ref["rejected"],
            "state and tally == phase 8's served driver, leaf for leaf":
                _same_leaves(_leaves(drv), ref["leaves"]),
            "decisions == phase 8's":
                all(np.array_equal(getattr(st, f), ref["stats"][f])
                    for f in ("decided", "decision_value",
                              "decision_round")),
            "each decision polled once, value 7 in round 0":
                sorted(x.instance for x in polled) == list(range(I))
                and {(x.value_id, x.round) for x in polled}
                == {(VALUE, 0)},
            "one verify launch a height":
                launches == H and len(steps) == H,
            "native_phase_builds == heights served":
                rep["native_phase_builds"] == (H if native else 0),
            "submitted == admitted + rejected, every vote dispatched once":
                q["submitted"] == q["admitted"] + q["rejected_overflow"]
                + q["rejected_fairness"] + q["rejected_malformed"]
                and q["admitted"] == q["drained"] == H * n
                and rep["dispatched_votes"] == H * n,
        }
        if name != "python":
            checks["dispatch stream == the Python-admission serve's, "
                   "leaf for leaf" + (" (lanes in key order)" if threaded
                                      else "")] = \
                not shape_bad and int(mism) == 0
        if threaded:
            checks["no inbox drop, no thread failure"] = (
                rep["inbox"]["dropped"] == 0
                and rep["thread_failure"] is None)
        if not all(checks.values()):
            raise AssertionError(
                f"native serve, {name}: {checks}; launches {launches}, "
                f"report {({k: rep[k] for k in ('decisions_total', 'rejected_signature_device', 'dispatched_batches', 'native_phase_builds', 'queue')})}, "
                f"stream shapes off at {shape_bad}, mismatches {int(mism)}")
        ms = {k: [(b - a) * 1e3 for a, b in v] for k, v in ivs.items()}
        # the drains that popped something (a poll on an idle queue
        # returns before the call)
        drains = [x for x, (a, b) in zip(ms["drain"], ivs["drain"])
                  if x > 0.05]
        step_ms = [a.elapsed_time(b) for a, b in steps]
        hist = (svc.metrics.hists[SERVE_NATIVE_DRAIN_WALL_S].snapshot()
                if native else None)
        log(f"[native serve] {name}: {H} heights, {H * n} votes, wall "
            f"{wall:.3f} s, served votes/s={H * n / wall:.0f}; verify "
            f"launches {launches}, native_phase_builds "
            f"{rep['native_phase_builds']}, rejected "
            f"{rep['rejected_signature_device']}")
        log(f"[native serve] {name} per tick ms: submit "
            + ", ".join(f"{x:.1f}" for x in ms["submit"])
            + "; drain " + ", ".join(f"{x:.1f}" for x in drains)
            + "; stage " + ", ".join(f"{x:.1f}" for x in ms["stage"])
            + "; dispatch (host launch) " + ", ".join(
                f"{x:.1f}" for x in ms["launch"])
            + "; step (CUDA events) " + ", ".join(f"{x:.1f}"
                                                  for x in step_ms)
            + (f"; {SERVE_NATIVE_DRAIN_WALL_S} over {hist['count']} "
               f"records: mean {hist['mean'] * 1e3:.1f} ms a drain, max "
               f"{hist['max'] * 1e3:.1f} ms" if hist else "")
            + f"; overlap share {overlap_share:.3f}")
        if busy is not None:
            log(f"[native serve] {name}: {SERVE_SUBMIT_BUSY_FRAC} "
                f"{busy['submit']:.3f}, {SERVE_DISPATCH_BUSY_FRAC} "
                f"{busy['dispatch']:.3f} over the run (the loops' busy "
                f"seconds over its wall; the dispatch loop's drains run "
                f"in its batch close, outside its busy span); idle polls "
                f"of the dispatch loop {idle['n']}, {idle['s']:.3f} s")
        log(f"[native serve] {name}: device peak {peak / 2**30:.3f} GiB "
            f"above the {before / 2**30:.3f} GiB allocated before (the "
            f"reference stream: in 'before' after the Python run, in the "
            f"peak of that run; the stream comparison's temporaries in "
            f"the peak), against the top rung's plan "
            f"{plan.peak_bytes / 2**30:.3f} GiB; card "
            f"{smi('name,power.limit')}")
        out[name] = {"votes_per_s": H * n / wall, "wall_s": wall,
                     "launches": launches,
                     "native_phase_builds": rep["native_phase_builds"],
                     "submit_ms": ms["submit"], "drain_ms": drains,
                     "stage_ms": ms["stage"], "launch_ms": ms["launch"],
                     "step_ms": step_ms, "overlap_share": overlap_share,
                     "peak_bytes": peak, "busy_share": busy,
                     "idle_polls": idle["n"], "idle_poll_s": idle["s"]}
        return kept.pop("lanes", None)

    serve("python", native=False)
    torch.cuda.empty_cache()
    lanes = serve("native", native=True)
    torch.cuda.empty_cache()
    n_l, n_s, mism, max_err, n_forged, right = _sample_vs_plain(
        lanes, SEED + 11)
    del lanes
    if mism or not right or n_l != n:
        raise AssertionError(
            f"adopted build: {n_l} lanes; kernel != plain on {mism} of "
            f"{n_s} sampled lanes, or a forged lane passed / an honest "
            f"lane failed")
    log(f"[native serve] verify kernel on the last adopted build ({n_l} "
        f"lanes, none padding) == plain on a sample of {n_s} lanes "
        f"({n_forged} forged, all rejected)")
    serve(f"native_shards{NATIVE_SERVE_SHARDS}", native=True,
          shards=NATIVE_SERVE_SHARDS)
    torch.cuda.empty_cache()
    serve("threaded", native=True, threaded=True)
    stream_ref.clear()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[native serve] served votes/s: " + ", ".join(
        f"{k} {v['votes_per_s']:.0f}" for k, v in out.items())
        + f"; phase wall {wall:.1f} s; card {smi('name,power.limit')}")
    return {"launches_native_serve_phase":
            sum(v["launches"] for v in out.values()),
            "native_serve_sample_mismatches": mism,
            "native_serve_sample_max_abs_err": max_err,
            "native_serve_phase_s": wall,
            "native_serve": out}


def _dense_plain_sample(dense, rng):
    """The verify kernel against plain on every dense cell of
    DENSE_SAMPLE_ROWS sampled instance rows (both classes, so their
    forged cells too): (cells, mismatches, max_abs_err, forged cells,
    verdicts right)."""
    import torch

    from agnes_tpu_torch.crypto import ed25519_verify as V

    Ps, I, Vn = dense.sig.shape[:3]
    rows = torch.from_numpy(rng.choice(I, DENSE_SAMPLE_ROWS,
                                       replace=False)).to(dense.sig.device)
    sig = dense.sig[:, rows].reshape(-1, 64)
    blocks = dense.blocks[:, rows].reshape((-1,) + dense.blocks.shape[3:])
    pub = dense.pub[None, None].expand(Ps, DENSE_SAMPLE_ROWS, Vn, 32) \
        .reshape(-1, 32)
    args, ok_s = V.prologue(pub, sig, blocks)
    got = V.verify_signed5(*args)
    plain = V.verify_plain(*args)
    mism, max_err = compare(got, plain)
    ok = ((got > 0) & ok_s).reshape(Ps, DENSE_SAMPLE_ROWS, Vn).cpu()
    is_forged = torch.zeros((Ps, DENSE_SAMPLE_ROWS, Vn), dtype=torch.bool)
    is_forged[:, :, FORGED] = True
    right = not bool(ok[is_forged].any()) and bool(ok[~is_forged].all())
    return int(sig.shape[0]), mism, max_err, int(is_forged.sum()), right


def _dense_build(I, seeds, pubkeys, sigs, classes):
    """build_phases_device_dense of phase 3's traffic at I instances:
    (phases, dense, seconds of the host build ending in a sync, the
    batcher)."""
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness import fixtures as fx

    cols = [fx.full_mesh_cols(I, V_SIGNED, seeds, 0, typ, VALUE,
                              sigs=sigs[c]) for c, typ in enumerate(classes)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat = VoteBatcher(I, V_SIGNED, n_slots=4, device=DEVICE)
    for c in cols:
        bat.add_arrays(*c)
    phases, dense = bat.build_phases_device_dense(pubkeys)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if dense is None or len(phases) != 2:
        raise AssertionError(f"the dense build at I={I} left the device "
                             f"path")
    return [p for p, _ in phases], dense, t_build, bat


def _mesh_rank(rank: int, world: int, init_file: str, in_path: str,
               out_path: str) -> None:
    """One spawned rank of phase 12(c)'s 1 x `world` (val) NCCL mesh:
    rebuilds (a)'s dense height from the fixture's signatures, steps it
    sharded, and rank 0 writes whether the gathered result equals (a)'s,
    with the census."""
    import torch
    import torch.distributed as dist

    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        data = torch.load(in_path)
        seeds = fx.deterministic_seeds(V_SIGNED)
        sigs = [s.numpy() for s in data["sigs"]]
        phases, dense, _, _ = _dense_build(I_SIGNED, seeds,
                                        fx.validator_pubkeys(seeds), sigs,
                                        data["classes"])
        mesh = make_mesh(1, world)
        d = DeviceDriver(I_SIGNED, V_SIGNED, advance_height=True, mesh=mesh,
                         device=DEVICE)
        V.LAUNCHES = 0
        d.step_seq_signed_dense([d.empty_phase()] + phases, dense)
        d.collect()
        launches = V.LAUNCHES
        census = [dict(fn.last_census) for fn in d._sharded.values()]
        state, tally = d.state_copies()
        got = [x.cpu() for x in list(state) + list(tally)]
        same = (len(got) == len(data["leaves"])
                and all(torch.equal(a, b)
                        for a, b in zip(got, data["leaves"]))
                and d.rejected_signature_device == data["rejected"]
                and bool(torch.equal(torch.from_numpy(d.stats.decision_value),
                                     data["decision_value"])))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"same": same, "launches_rank0": launches,
                           "census": census,
                           "rejected": d.rejected_signature_device}, f)
    finally:
        dist.destroy_process_group()


def _spawn_mesh(world: int, classes, sigs, ref) -> dict:
    """Phase 12(c)'s two-card run: `world` spawned ranks, each join
    bounded by MESH_JOIN_S; a rank that fails or overruns fails the
    phase (its processes are killed)."""
    import torch
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="agnes-mesh-")
    try:
        torch.save({"sigs": [torch.from_numpy(s) for s in sigs],
                    "classes": list(classes), "leaves": ref["leaves"],
                    "rejected": ref["rejected"],
                    "decision_value": torch.from_numpy(
                        ref["stats"]["decision_value"])},
                   os.path.join(tmp, "in.pt"))
        ctx = mp.start_processes(
            _mesh_rank, args=(world, os.path.join(tmp, "rendezvous"),
                              os.path.join(tmp, "in.pt"),
                              os.path.join(tmp, "out.json")),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            while not ctx.join(timeout=max(1.0, deadline
                                           - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the {world}-rank mesh did not "
                                         f"finish in {MESH_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        with open(os.path.join(tmp, "out.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dense_mesh_phase(seeds, pubkeys, sigs, lane_ref, north_decisions,
                     serve_sigs, serve_ref, bound) -> dict:
    """Phase 12: the dense signed step and the mesh; see the module
    docstring.  `lane_ref` is phase 3's packed-lane height (leaves on
    the host, stats, rejected), `north_decisions` phase 3n's decisions,
    `serve_sigs` / `serve_ref` phase 8's signatures and served driver.
    Returns the numbers for the verify kernel's line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.parallel import make_mesh
    from agnes_tpu_torch.types import VoteType
    from agnes_tpu_torch.utils import budget

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    card = smi("name,power.limit")
    hbm = budget.device_hbm_bytes(dev)
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    I, Vn = I_SIGNED, V_SIGNED
    rng = np.random.RandomState(SEED + 12)
    out = {}
    clock = StageClock(dev)

    def step_timed(run):
        """run() under CUDA events, the verify prologue and kernel timed
        inside it: (step ms, prologue ms, kernel ms, launches, peak B,
        allocated before B)."""
        clock.reset()
        clock.events(V, "prologue", "prologue")
        clock.events(V, "verify_signed5", "kernel")
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            V.LAUNCHES = 0
            ev[0].record()
            run()
            ev[1].record()
            torch.cuda.synchronize()
            launches = V.LAUNCHES
            return (ev[0].elapsed_time(ev[1]), clock.device_ms("prologue"),
                    clock.device_ms("kernel"), launches,
                    torch.cuda.max_memory_allocated(), before)
        finally:
            clock.restore()

    # -- (a) the dense signed height at 1,024 x 1,000 ----------------------
    phases, dense, t_build, _ = _dense_build(I, seeds, pubkeys, sigs,
                                             classes)
    n_cells = int(dense.sig.shape[0]) * I * Vn
    plan_a = budget.plan_dense_verify(2, I, Vn, hbm_bytes=hbm)
    da = DeviceDriver(I, Vn, advance_height=True, device=dev)
    seq = [da.empty_phase()] + phases
    ms_a, pro_a, ker_a, launches_a, peak_a, before_a = step_timed(
        lambda: da.step_seq_signed_dense(seq, dense))
    a_leaves = [x.cpu() for x in _leaves(da)]
    checks = {
        "one verify launch of every cell": launches_a == 1,
        "state and tally == phase 3's lane height, leaf for leaf":
            _same_leaves(a_leaves, lane_ref["leaves"]),
        "decisions == phase 3's": all(
            np.array_equal(getattr(da.stats, f), lane_ref["stats"][f])
            for f in ("decided", "decision_value", "decision_round")),
        "rejected == 2I == phase 3's":
            da.rejected_signature_device == 2 * I == lane_ref["rejected"],
        "step peak <= plan.peak_bytes": peak_a <= plan_a.peak_bytes,
    }
    if not all(checks.values()):
        raise AssertionError(f"dense height failed: {checks}; "
                             f"{plan_a.describe()}; peak {peak_a} B, "
                             f"launches {launches_a}")
    n_s, mism_a, err_a, n_forged, right = _dense_plain_sample(dense, rng)
    if mism_a or not right:
        raise AssertionError(f"dense cells: kernel != plain on {mism_a} of "
                             f"{n_s}, or a forged cell passed / an honest "
                             f"one failed")
    # the same height through step_async: nothing read back, no sync
    asy = DeviceDriver(I, Vn, advance_height=True, device=dev)
    seq2 = [asy.empty_phase()] + phases
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        asy.step_async(seq2, dense)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    asy.collect()
    if not (_same_leaves(_leaves(asy), _leaves(da))
            and asy.rejected_signature_device == da.rejected_signature_device
            and np.array_equal(asy.stats.decision_value,
                               da.stats.decision_value)):
        raise AssertionError("dense step_async != step_seq_signed_dense")
    bound_a, by_a = bound(V.INT32_OPS_PER_LANE * n_cells,
                          V.BYTES_PER_LANE * n_cells)
    rate_a = n_cells / (t_build + ms_a / 1e3)
    log(f"[dense] I={I} V={Vn} cells={n_cells}: host build "
        f"(build_phases_device_dense) {t_build:.3f} s, step {ms_a:.3f} ms "
        f"(CUDA events; prologue {pro_a:.3f} ms, verify kernel "
        f"{ker_a:.3f} ms in {launches_a} launch, bound {bound_a:.3f} ms "
        f"{by_a}), verified votes/s={rate_a:.0f} (step only "
        f"{n_cells / ms_a * 1e3:.0f}); rejected "
        f"{da.rejected_signature_device}; state, tally and decisions == "
        f"phase 3's lane height; card {card}")
    log(f"[dense] step peak {peak_a / 2**30:.3f} GiB (allocated before "
        f"{before_a / 2**30:.3f} GiB) against {plan_a.describe()}; kernel "
        f"== plain on {n_s} cells of {DENSE_SAMPLE_ROWS} rows ({n_forged} "
        f"forged, all rejected); step_async under sync debug mode "
        f"\"error\" == step_seq_signed_dense; card {card}")
    out.update({"dense_cells": n_cells, "dense_launches": launches_a,
                "dense_build_s": t_build, "dense_step_ms": ms_a,
                "dense_prologue_ms": pro_a, "dense_kernel_ms": ker_a,
                "dense_bound_ms": bound_a, "dense_votes_per_s": rate_a,
                "dense_peak_bytes": peak_a,
                "dense_plan_peak_bytes": plan_a.peak_bytes,
                "dense_sample_cells": n_s,
                "dense_sample_mismatches": mism_a,
                "dense_sample_max_abs_err": err_a})
    del asy, seq2

    # -- (c) the sharded dense step on NCCL: one rank, (a)'s inputs --------
    n_cards = torch.cuda.device_count()
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="agnes-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        # the communicator is set up at its first collective: do that
        # outside the timed step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=dev),
                        group=mesh.get_group("val"))
        torch.cuda.synchronize()
        t_comm = time.perf_counter() - t0
        dm = DeviceDriver(I, Vn, advance_height=True, mesh=mesh, device=dev)
        ms_c, _, ker_c, launches_c, _, _ = step_timed(
            lambda: dm.step_seq_signed_dense([dm.empty_phase()] + phases,
                                             dense))
        dm.collect()
        census = {k[0]: dict(fn.last_census)
                  for k, fn in dm._sharded.items()}
        state, tally = dm.state_copies()
        same_c = (_same_leaves([x.cpu() for x in list(state) + list(tally)],
                               a_leaves)
                  and dm.rejected_signature_device
                  == da.rejected_signature_device
                  and np.array_equal(dm.stats.decision_value,
                                     da.stats.decision_value))
        seq_census = census.get("make_sharded_step_seq_signed", {})
        if not (same_c and launches_c == 1
                and seq_census.get("val") == 2 * 3 + 1
                and not any(seq_census.get(k) for k in ("data", "other"))):
            raise AssertionError(f"NCCL one-rank mesh: == (a) {same_c}, "
                                 f"launches {launches_c}, census {census}")
        log(f"[mesh] NCCL world of 1 rank, 1 x 1 mesh, I={I} V={Vn} "
            f"(communicator set up in {t_comm * 1e3:.1f} ms): step "
            f"{ms_c:.3f} ms (kernel {ker_c:.3f} ms, {launches_c} launch); "
            f"gathered state, tally, decisions and rejects == (a); "
            f"collectives of the dense dispatch {census}; cards on this "
            f"machine: {n_cards}; card {card}")
        del dm, state, tally
        del phases, dense, seq, da
        torch.cuda.empty_cache()

        # -- (d) phase 8's heights served by a VoteService on the mesh ----
        out.update(_dense_serve(mesh, seeds, pubkeys, serve_sigs, serve_ref,
                                classes, hbm, card))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out.update({"mesh_nccl_ranks": 1, "mesh_step_ms": ms_c,
                "mesh_comm_setup_s": t_comm,
                "mesh_launches": launches_c, "mesh_census": census,
                "cards": n_cards})
    if n_cards >= 2:
        two = _spawn_mesh(2, classes, sigs, lane_ref)
        if not (two["same"] and two["launches_rank0"] == 1):
            raise AssertionError(f"the 1 x 2 NCCL mesh failed: {two}")
        log(f"[mesh] NCCL world of 2 spawned ranks, 1 x 2 (val) mesh at "
            f"I={I} V={Vn}: gathered result == (a); rank 0 verify launches "
            f"{two['launches_rank0']}; census {two['census']}; card {card}")
        out["mesh_two_rank"] = two
    else:
        log(f"[mesh] cards on this machine: {n_cards}; the 1 x 2 mesh "
            f"over two ranks is not run; card {card}")
    torch.cuda.empty_cache()

    # -- (b) the dense height at the north-star shape ----------------------
    In = I_NORTH
    with RssPeak() as rss:
        phases, dense, t_build_n, bat = _dense_build(In, seeds, pubkeys,
                                                     sigs, classes)
        n_north = int(dense.sig.shape[0]) * In * Vn
        runs = {}
        for name, budget_b in (("card", hbm), ("half", hbm // 2)):
            plan = budget.plan_dense_verify(2, In, Vn, hbm_bytes=budget_b)
            d = DeviceDriver(In, Vn, advance_height=True, device=dev,
                             verify_chunk="auto", hbm_budget_bytes=budget_b)
            sq = [d.empty_phase()] + phases
            ms, pro, ker, launches, peak, before = step_timed(
                lambda: d.step_seq_signed_dense(sq, dense))
            decs = _decisions(d, bat.decode_slot)
            runs[name] = (plan, ms, pro, ker, launches, peak, before)
            checks = {
                "launches == plan.n_chunks": launches == plan.n_chunks,
                "step peak <= plan.peak_bytes": peak <= plan.peak_bytes,
                "rejected == 2I": d.rejected_signature_device == 2 * In,
                "decisions == phase 3n's": _same_decisions(
                    decs, north_decisions),
            }
            if name == "half":
                checks["chunked"] = plan.n_chunks > 1
            if not all(checks.values()):
                raise AssertionError(
                    f"north-star dense height ({name}) failed: {checks}; "
                    f"{plan.describe()}; peak {peak} B, launches {launches}")
            del d, sq
            torch.cuda.empty_cache()
    del phases, dense, bat
    torch.cuda.empty_cache()
    (plan_n, ms_n, pro_n, ker_n, l_n, peak_n, bef_n) = runs["card"]
    (plan_h, ms_h, pro_h, ker_h, l_h, peak_h, bef_h) = runs["half"]
    bound_n, by_n = bound(V.INT32_OPS_PER_LANE * n_north,
                          V.BYTES_PER_LANE * n_north)
    log(f"[dense north-star] I={In} V={Vn} cells={n_north}: host build "
        f"{t_build_n:.3f} s; at the card's memory {plan_n.describe()}: step "
        f"{ms_n:.3f} ms (prologue {pro_n:.3f}, kernel {ker_n:.3f} ms in "
        f"{l_n} launch(es), bound {bound_n:.3f} ms {by_n}), peak "
        f"{peak_n / 2**30:.3f} GiB (allocated before {bef_n / 2**30:.3f}), "
        f"verified votes/s={n_north / (t_build_n + ms_n / 1e3):.0f} (step "
        f"only {n_north / ms_n * 1e3:.0f}); card {card}")
    log(f"[dense north-star] under half the card ({hbm // 2} B): "
        f"{plan_h.describe()}: {l_h} verify launches, step {ms_h:.3f} ms "
        f"(kernel {ker_h:.3f} ms), peak {peak_h / 2**30:.3f} GiB; "
        f"decisions == phase 3n's at both budgets; host peak RSS "
        f"{rss.peak:.2f} GiB ({rss.start:.2f} as the build started); "
        f"card {card}")
    out.update({"dense_north_cells": n_north, "dense_north_build_s":
                t_build_n, "dense_north_step_ms": ms_n,
                "dense_north_prologue_ms": pro_n,
                "dense_north_kernel_ms": ker_n,
                "dense_north_launches": l_n,
                "dense_north_chunks": plan_n.n_chunks,
                "dense_north_bound_ms": bound_n,
                "dense_north_peak_bytes": peak_n,
                "dense_north_plan_peak_bytes": plan_n.peak_bytes,
                "dense_north_half_launches": l_h,
                "dense_north_half_chunks": plan_h.n_chunks,
                "dense_north_half_tile": plan_h.tile,
                "dense_north_half_step_ms": ms_h,
                "dense_north_half_kernel_ms": ker_h,
                "dense_north_half_peak_bytes": peak_h,
                "dense_north_half_plan_peak_bytes": plan_h.peak_bytes,
                "dense_north_rss_gib": rss.peak,
                "dense_north_votes_per_s":
                    n_north / (t_build_n + ms_n / 1e3)})
    launches = (launches_a + launches_c + l_n + l_h
                + out["dense_serve_launches"])
    wall = time.perf_counter() - t_phase
    log(f"[dense] phase 12 {wall:.1f} s; verify launches on its paths "
        f"{launches} ((a) {launches_a}, (c) {launches_c}, (b) {l_n} + "
        f"{l_h}, (d) {out['dense_serve_launches']} served + "
        f"{out['dense_serve_warm_launches']} in warmup); card {card}")
    return {"launches_dense_phase": launches, "dense": out}


def _dense_serve(mesh, seeds, pubkeys, sigs, ref, classes, hbm,
                 card) -> dict:
    """Phase 12(d): phase 8's three heights served by a VoteService whose
    driver sits on `mesh`, held against phase 8's served driver `ref`."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.serve import ShapeLadder, VoteService
    from agnes_tpu_torch.utils import budget
    from agnes_tpu_torch.utils.flightrec import FlightRecorder
    from agnes_tpu_torch.utils.metrics import RETRACE_UNEXPECTED

    dev = torch.device(DEVICE)
    I, Vn, H = I_SIGNED, V_SIGNED, SERVE_HEIGHTS
    wire = [b"".join(pack_wire_votes(*fx.full_mesh_cols(
        I, Vn, seeds, h, typ, VALUE, sigs=sigs[h, typ])) for typ in classes)
        for h in range(H)]
    box = {"h": 0}
    drv = DeviceDriver(I, Vn, advance_height=True, defer_collect=True,
                       audit=True, mesh=mesh, device=dev,
                       hbm_budget_bytes=hbm)
    flight = FlightRecorder()
    svc = VoteService(drv, VoteBatcher(I, Vn, n_slots=4, device=dev),
                      pubkeys, target_votes=2 * I * Vn, max_delay_s=0.0,
                      window_predictor=lambda: (
                          np.zeros(I, np.int64),
                          np.full(I, box["h"], np.int64)),
                      flightrec=flight)
    plan = budget.plan_dense_verify(2, I, Vn, hbm_bytes=hbm)
    if not (svc.pipeline.dense and svc.ladder == ShapeLadder.plan_dense(
            I, Vn, local_shape=(I, Vn), hbm_bytes=hbm)):
        raise AssertionError("the mesh service did not take the dense "
                             "ladder and mode")
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    warmed = svc.pipeline.warmup(n_phases=(2, 3))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_launches = V.LAUNCHES
    steps = []
    dispatch = drv.step_async

    def timed_dispatch(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = dispatch(*a, **k)
        ev[1].record()
        steps.append(ev)
        return res

    drv.step_async = timed_dispatch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for h in range(H):
            box["h"] = h
            res = svc.submit(wire[h])
            if res.accepted != 2 * I * Vn:
                raise AssertionError(f"height {h} not admitted whole: {res}")
            svc.pump()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rep = svc.drain()
    wall = time.perf_counter() - t0
    serve_launches = V.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    del drv.step_async
    state, tally = drv.state_copies()
    step_ms = [a.elapsed_time(b) for a, b in steps]
    checks = {
        "state and tally == phase 8's served driver, leaf for leaf":
            _same_leaves(list(state) + list(tally), ref["leaves"]),
        "decisions == phase 8's": all(
            np.array_equal(getattr(drv.stats, f), ref["stats"][f])
            for f in ("decided", "decision_value", "decision_round")),
        "rejected == phase 8's":
            rep["rejected_signature_device"] == ref["rejected"],
        "one verify launch a height": serve_launches == H
        and rep["dispatched_batches"] == H,
        "warmup: one dense shape a phase count": warm_launches == warmed == 2
        and svc.pipeline.warmed_keys == {("dense_signed", 2),
                                         ("dense_signed", 3)},
        "no retrace": drv.sentinel.metrics.counters.get(
            RETRACE_UNEXPECTED, 0) == 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"dense serve failed: {checks}; launches "
                             f"{serve_launches}, warm {warm_launches}")
    ANALYSIS["serves"].append(("phase 12 dense", svc.ladder, True,
                               drv.sentinel))
    n_votes = H * 2 * I * Vn
    log(f"[dense serve] VoteService on the NCCL 1 x 1 mesh, "
        f"{svc.ladder.describe()}, dense mode; warmup {warmed} shapes "
        f"({warm_launches} verify launches) {t_warm:.3f} s; {H} heights, "
        f"{n_votes} votes: wall {wall:.3f} s, served votes/s="
        f"{n_votes / wall:.0f}; step ms (CUDA events) "
        + ", ".join(f"{x:.1f}" for x in step_ms)
        + f"; verify launches {serve_launches}; device peak "
        f"{peak / 2**30:.3f} GiB (allocated before {before / 2**30:.3f}) "
        f"against the dense plan's {plan.peak_bytes / 2**30:.3f} GiB "
        f"({plan.describe()}); state, tally and decisions == phase 8's "
        f"served lane stream; no sync point in the pump loop; card {card}")
    return {"dense_serve_votes_per_s": n_votes / wall,
            "dense_serve_launches": serve_launches,
            "dense_serve_warm_launches": warm_launches,
            "dense_serve_step_ms": step_ms,
            "dense_serve_peak_bytes": peak,
            "dense_serve_plan_peak_bytes": plan.peak_bytes}


def _pod_run(tag: str, n_processes: int, per_host: int, n_val: int,
             native: bool, tmp: str) -> dict:
    """One pod of phase 13 through `spawn_pod` on the card: phase 8's
    traffic (I_SIGNED x V_SIGNED, SERVE_HEIGHTS heights, validator
    FORGED forged in both classes), heartbeats and state dumps on.
    Any worker's error or a deadline kill fails the phase."""
    from agnes_tpu_torch.distributed.smoke import spawn_pod

    res = spawn_pod(n_processes // per_host, devices_per_host=per_host,
                    n_val=n_val,
                    instances=I_SIGNED, validators=V_SIGNED,
                    heights=SERVE_HEIGHTS - 1, forge=FORGED,
                    device=DEVICE, out_dir=os.path.join(tmp, tag),
                    timeout_s=POD_JOIN_S, heartbeat=True, dump_state=True,
                    native_admission=native)
    bad = [r for r in res["pod"] if "error" in r]
    if res["killed"] or bad:
        logs = {t: open(p["log"]).read()[-3000:]
                for t, p in res["paths"].items()}
        raise AssertionError(f"pod {tag} failed (killed {res['killed']}): "
                             f"{bad}; logs {logs}")
    return res


def _pod_blocks(res, per_host: int, n_hosts: int) -> dict:
    """A pod's host blocks concatenated host-major ({name: numpy}); every
    rank of a host must hold its host's block leaf for leaf."""
    import numpy as np

    blocks = []
    for h in range(n_hosts):
        ranks = [dict(np.load(res["paths"][f"pod{h * per_host + k}"]["npz"]))
                 for k in range(per_host)]
        for other in ranks[1:]:
            if not all(np.array_equal(other[key], ranks[0][key])
                       for key in ranks[0]):
                raise AssertionError(f"host {h}'s ranks hold different "
                                     f"blocks")
        blocks.append(ranks[0])
    return {key: np.concatenate([b[key] for b in blocks], axis=0)
            for key in blocks[0]}


def _pod_checks(res, per_host: int, n_hosts: int, ref: dict,
                keep: dict = None):
    """Phase 13's per-pod checks (module docstring): ({check: held?},
    the pod's host blocks).  With `keep`, the heartbeat trails and the
    host order the post-mortem ranked them in go there."""
    import numpy as np

    from agnes_tpu_torch.distributed.smoke import SAMPLE_ROWS
    from agnes_tpu_torch.distributed.smoke import VALUE as POD_VALUE
    from agnes_tpu_torch.utils.flightrec import (
        read_heartbeat,
        render_pod_postmortem,
    )

    I, Vn, H = I_SIGNED, V_SIGNED, SERVE_HEIGHTS
    local = I // n_hosts
    recs = res["pod"]
    cells = 2 * local * Vn
    rows = [r["pod_decision_rows"] for r in recs]
    blocks = _pod_blocks(res, per_host, n_hosts)
    hbs = [res["paths"][f"pod{k}"]["heartbeat"] for k in range(len(recs))]
    stamped = all(
        (lambda lines: bool(lines) and all(
            ln.get("host_id") == k // per_host for ln in lines))(
            read_heartbeat(p)[0]) for k, p in enumerate(hbs))
    head = render_pod_postmortem(hbs).split("\n\n")[0].splitlines()[1:]
    if keep is not None:
        keep["trails"] = hbs
        keep["rank"] = [ln.split(":")[0].strip() for ln in head]
    return {
        "foreign records screened on every host": all(
            r["foreign_rejects"] == H * 2 * (I - local) * Vn for r in recs),
        "one verify launch of 2 x local x V cells a height": all(
            r["launches_by_height"] == [1] * H and r["launches"] == H
            and r["cells_by_dispatch"] == [cells] * H
            and len(r["kernel_ms"]) == H for r in recs),
        "2 x local rejected lanes a height": all(
            r["rejected_by_height"] == [2 * local] * H for r in recs),
        "no retrace, no off-ladder build, no host fallback": all(
            r["retrace_unexpected"] == 0 and r["offladder_builds"] == 0
            and r["host_fallback_builds"] == 0 for r in recs),
        "one warmed shape, one warmup launch": all(
            r["warmed_shapes"] == 1 and r["warm_launches"] == 1
            for r in recs),
        "gathered rows identical and cover every instance":
            all(x == rows[0] for x in rows)
            and [x[0] for x in rows[0]] == list(range(I))
            and all(x[2:] == [0, 0, POD_VALUE] for x in rows[0]),
        "host blocks == the one-process dense path, leaf for leaf":
            set(blocks) == set(ref) and all(
                np.array_equal(blocks[k], ref[k]) for k in ref),
        "kernel == plain on the sampled rows, forged cells rejected": all(
            r["sample"]["mismatches"] == 0 and r["sample"]["verdicts_right"]
            and r["sample"]["forged_cells"] == 2 * SAMPLE_ROWS
            for r in recs),
        "a host-stamped heartbeat a process, ranked by the post-mortem":
            stamped and sorted(ln.split(":")[0].strip() for ln in head)
            == sorted(f"host {k // per_host}" for k in range(len(recs))),
    }, blocks


def _pod_log(tag: str, res, card: str, shared: bool) -> None:
    """Phase 13's per-process lines: votes/s, per tick densify, host
    launch, step and kernel (CUDA events), agree and gather walls, the
    device peak against the dense plan, host RSS."""
    def fmt(xs):
        return ("not measured" if xs is None
                else "/".join(f"{x:.1f}" for x in xs))

    share = (" (both processes on card 0: each time includes the other's "
             "work)" if shared else "")
    for r in res["pod"]:
        ag = sorted(r["agree_ms"])
        log(f"[pod {tag}] process {r['process']} host {r['host']}: pod-wide "
            f"served votes/s={r['votes_per_sec']:.0f} (heights 1-"
            f"{r['heights']}; all {r['heights'] + 1} in {r['wall_s']:.3f} "
            f"s); per tick densify ms {fmt(r['densify_ms'])}, host launch "
            f"ms {fmt(r['launch_ms'])}, step ms {fmt(r['step_ms'])}, "
            f"kernel ms {fmt(r['kernel_ms'])} ({r['launches']} launches of "
            f"{r['cells_by_dispatch'][0]} cells), decision gather ms "
            f"{fmt(r['gather_ms'])}, agree ms median {ag[len(ag) // 2]:.2f} "
            f"max {ag[-1]:.2f} over {len(ag)}; device peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB against the dense plan's "
            f"{r['plan_peak_bytes'] / 2**30:.3f}; host RSS after the drain "
            f"{r['rss_gib']:.2f} GiB{share}; card {card}")


def pod_phase(seeds, pubkeys, sigs, serve_ref, bound) -> dict:
    """Phase 13: the static pod on the card; see the module docstring.
    `sigs` are phase 8's signatures, `serve_ref` its served driver.
    Returns the numbers for the verify kernel's line."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.distributed.smoke import state_arrays
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.types import VoteType

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    card = smi("name,power.limit")
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    I, Vn, H = I_SIGNED, V_SIGNED, SERVE_HEIGHTS
    n_cards = torch.cuda.device_count()

    # -- the one-process dense path of the same heights (the reference),
    #    carried on to the elastic drill's last height (its reference) ----
    sigs = dict(sigs)
    for h in range(H, ELASTIC_HEIGHTS + 1):
        for typ in classes:
            sigs[h, typ] = fx.sign_class(seeds, h, typ, VALUE,
                                         forge_validator=FORGED)
    d = DeviceDriver(I, Vn, advance_height=True, device=dev)
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    for h in range(max(H, ELASTIC_HEIGHTS + 1)):
        bat.sync_device(np.zeros(I, np.int64), np.full(I, h, np.int64))
        for typ in classes:
            bat.add_arrays(*fx.full_mesh_cols(I, Vn, seeds, h, typ, VALUE,
                                              sigs=sigs[h, typ]))
        phases, dense = bat.build_phases_device_dense(pubkeys)
        d.step_seq_signed_dense([d.empty_phase()] + [p for p, _ in phases],
                                dense)
        if h == H - 1:
            d.collect()
            ref = state_arrays(d)
    d.collect()
    ref_elastic = state_arrays(d)
    leaves = ([ref[f"state_{f}"] for f in type(d.state)._fields]
              + [ref[f"tally_{f}"] for f in type(d.tally)._fields])
    if not (all(np.array_equal(a, b.cpu().numpy())
                for a, b in zip(leaves, serve_ref["leaves"]))
            and all(np.array_equal(ref[f], serve_ref["stats"][f])
                    for f in ("decided", "decision_value",
                              "decision_round"))):
        raise AssertionError("the one-process dense path != phase 8's "
                             "served driver")
    # the pod's launch shape, one host's block (the fixture's lanes do not
    # depend on the instance): the kernel timed alone at it
    half = dense._replace(sig=dense.sig[:, :I // POD_HOSTS].contiguous(),
                          blocks=dense.blocks[:, :I // POD_HOSTS]
                          .contiguous())
    n_cells = int(half.sig.shape[0]) * (I // POD_HOSTS) * Vn
    pub = half.pub[None, None].expand(2, I // POD_HOSTS, Vn, 32) \
        .reshape(-1, 32)
    args, _ = V.prologue(pub, half.sig.reshape(-1, 64),
                         half.blocks.reshape((-1,) + half.blocks.shape[3:]))
    alone_ms = cuda_ms(lambda: V.verify_signed5(*args), KERNEL_REPS)
    bound_ms, bound_by = bound(V.INT32_OPS_PER_LANE * n_cells,
                               V.BYTES_PER_LANE * n_cells)
    del d, bat, phases, dense, half, pub, args
    torch.cuda.empty_cache()     # phase 12(b) leaves ~36 GiB reserved
    log(f"[pod] the one-process dense path of phase 8's {H} heights == "
        f"phase 8's served driver; the verify kernel alone at the pod's "
        f"launch shape ({n_cells} cells): {alone_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}, {bound_ms / alone_ms:.1%}); cards "
        f"on this machine: {n_cards}; card {card}")

    out = {"pod_cells": n_cells, "pod_kernel_alone_ms": alone_ms,
           "pod_bound_ms": bound_ms, "pod_cards": n_cards}
    tmp = tempfile.mkdtemp(prefix="agnes-pod-")
    launches = 0
    try:
        runs = {}
        for tag, native in (("a", False), ("b", True)):
            t0 = time.perf_counter()
            res = _pod_run(tag, POD_HOSTS, 1, 1, native, tmp)
            wall = time.perf_counter() - t0
            keep = {}
            checks, blocks = _pod_checks(res, 1, POD_HOSTS, ref, keep)
            if tag == "b":
                checks["== (a), leaf for leaf"] = all(
                    np.array_equal(blocks[k], runs["a"][1][k])
                    for k in blocks)
                checks["native admission on every host"] = all(
                    r["native_admission"] for r in res["pod"])
            if not all(checks.values()):
                raise AssertionError(f"pod ({tag}) failed: {checks}; "
                                     f"records {res['pod']}")
            runs[tag] = (res, blocks)
            if tag == "a":
                # phase 15 reads these trails after tmp is gone
                kept = tempfile.mkdtemp(prefix="agnes-trails-")
                ANALYSIS["trails"] = [shutil.copy(p, kept)
                                      for p in keep["trails"]]
                ANALYSIS["pod_rank"] = keep["rank"]
            _pod_log(tag, res, card, shared=n_cards < POD_HOSTS)
            recs = res["pod"]
            launches += sum(r["launches"] for r in recs)
            log(f"[pod {tag}] {POD_HOSTS} hosts x (1 x 1)"
                + (", native admission" if native else "")
                + f": {len(recs)} processes, wall {wall:.1f} s (spawn to "
                f"join); every check held: {sorted(checks)}; card {card}")
            out[f"pod_{tag}"] = {
                "votes_per_s": [r["votes_per_sec"] for r in recs],
                "step_ms": [r["step_ms"] for r in recs],
                "kernel_ms": [r["kernel_ms"] for r in recs],
                "densify_ms": [r["densify_ms"] for r in recs],
                "launch_ms": [r["launch_ms"] for r in recs],
                "agree_ms": [r["agree_ms"] for r in recs],
                "gather_ms": [r["gather_ms"] for r in recs],
                "peak_bytes": [r["peak_bytes"] for r in recs],
                "plan_peak_bytes": recs[0]["plan_peak_bytes"],
                "rss_gib": [r["rss_gib"] for r in recs],
                "launches": [r["launches"] for r in recs],
                "wall_s": wall, "shared_card": n_cards < POD_HOSTS}

        # -- (c) one host of several ranks: dense serving over a mesh ------
        if n_cards >= 2:
            n_proc, hosts = (4, 2) if n_cards >= 4 else (2, 1)
            res = _pod_run("c", n_proc, 2, 2, False, tmp)
            blocks = _pod_blocks(res, 2, hosts)
            same = all(np.array_equal(blocks[k], runs["a"][1][k])
                       for k in blocks)
            if not same:
                raise AssertionError("pod (c) != (a)")
            launches += sum(r["launches"] for r in res["pod"])
            _pod_log("c", res, card, shared=False)
            log(f"[pod c] {hosts} host(s) x (1 x 2) over {n_proc} cards: "
                f"host blocks == (a), leaf for leaf; card {card}")
            out["pod_c"] = {"processes": n_proc, "hosts": hosts}
        else:
            log(f"[pod c] one host of several ranks: not run: {n_cards} "
                f"card(s); card {card}")

        # -- (d) the elastic drill -----------------------------------------
        out["pod_d"] = _elastic_drill(ref_elastic, tmp, card,
                                      shared=n_cards < POD_HOSTS)
        launches_d = sum(out["pod_d"]["launches"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"[pod] phase 13 {wall:.1f} s; verify launches on its paths "
        f"{launches} in (a)-(c) (one a height a process), {launches_d} in "
        f"(d) (one a dispatched slot a process); warmup and sample "
        f"launches counted apart; card {card}")
    out["pod_phase_s"] = wall
    return {"launches_pod_phase": launches,
            "launches_elastic_phase": launches_d, "pod": out}


def _elastic_drill(ref: dict, tmp: str, card: str, shared: bool) -> dict:
    """Phase 13(d): the elastic pod's leave-and-rejoin drill on the card;
    see the module docstring.  `ref` is the one-process dense path at
    ELASTIC_HEIGHTS.  Returns the numbers for the verify kernel's line."""
    import numpy as np

    from agnes_tpu_torch.distributed.smoke import VALUE as POD_VALUE
    from agnes_tpu_torch.distributed.smoke import spawn_pod
    from agnes_tpu_torch.utils.flightrec import render_pod_postmortem

    I, Vn, EH = I_SIGNED, V_SIGNED, ELASTIC_HEIGHTS
    local = I // POD_HOSTS
    t0 = time.perf_counter()
    res = spawn_pod(POD_HOSTS, devices_per_host=1, n_val=1, instances=I,
                    validators=Vn, heights=EH, forge=FORGED, device=DEVICE,
                    out_dir=os.path.join(tmp, "d"), timeout_s=POD_JOIN_S,
                    heartbeat=True, dump_state=True, elastic=True,
                    leave_height=ELASTIC_LEAVE,
                    rejoin_height=ELASTIC_REJOIN)
    wall = time.perf_counter() - t0
    recs = res["pod"]
    bad = [r for r in recs if "error" in r]
    if res["killed"] or bad:
        logs = {t: open(p["log"]).read()[-3000:]
                for t, p in res["paths"].items()}
        raise AssertionError(f"elastic drill failed (killed "
                             f"{res['killed']}): {bad}; logs {logs}")
    blocks = _pod_blocks(res, 1, POD_HOSTS)
    rows = [r["pod_decision_rows"] for r in recs]
    held = 2 * local * Vn * (ELASTIC_REJOIN - ELASTIC_LEAVE)
    surv, sleeper = recs
    post = render_pod_postmortem(
        [res["paths"][f"pod{k}"]["heartbeat"] for k in range(POD_HOSTS)])
    checks = {
        "host blocks == the one-process dense path, leaf for leaf":
            set(blocks) == set(ref) and all(
                np.array_equal(blocks[k], ref[k]) for k in ref),
        "gathered rows identical and cover every instance":
            all(x == rows[0] for x in rows)
            and [x[0] for x in rows[0]] == list(range(I))
            and all(x[2:] == [0, 0, POD_VALUE] for x in rows[0]),
        "512 x 5 decisions and 2 x 512 x 5 rejected lanes a host": all(
            r["decisions_total"] == local * (EH + 1)
            and r["rejected_signature_device"] == 2 * local * (EH + 1)
            for r in recs),
        "two boundaries, epoch 2, one readmission, one departure": all(
            (r["boundaries"], r["membership_epoch"], r["readmissions"],
             r["departures"], r["alive"]) == (2, 2, 1, 1, [0, 1])
            for r in recs),
        "held == sent == received == 2 x 512,000, none dropped":
            surv["adopted_held"] == surv["reroute_sent"]
            == sleeper["reroute_received"] == held
            and all(r["held_dropped"] == r["held_pending"] == 0
                    for r in recs),
        "padded slots, no retrace, no foreign record, no off-ladder build":
            all(r["padded_slots"] > 0 and r["retrace_unexpected"] == 0
                and r["foreign_rejects"] == 0 and r["offladder_builds"] == 0
                and r["host_fallback_builds"] == 0 for r in recs),
        "one all_gather, one pack and an unpack a host row a tick": all(
            len(r["negotiate_ms"]) == len(r["pack_ms"])
            == len(r["negotiation_ms"])
            and len(r["unpack_ms"]) == POD_HOSTS * len(r["pack_ms"])
            for r in recs),
        "launches a height == the tick schedule's, one time each": all(
            r["launches_by_height"] == r["launches_implied"]
            and r["launches"] == sum(r["launches_implied"])
            == len(r["cells_by_dispatch"]) == len(r["kernel_ms"])
            for r in recs),
        "padding and dispatch under sync debug mode 'error'": all(
            r["sync_checked_calls"] >= r["dispatched_batches"] > 0
            for r in recs),
        "kernel at the launch shape == plain on the sampled rows": all(
            r["sample"]["mismatches"] == 0 and r["sample"]["verdicts_right"]
            and r["sample"]["launch_cells"] == r["cells_by_dispatch"][-1]
            and r["sample"]["forged_cells"] * Vn == r["sample"]["cells"]
            for r in recs),
        "post-mortem: elastic membership trail at epoch 2":
            "elastic membership:" in post and "epoch 2" in post
            and "HELD GOSSIP DROPPED" not in post,
    }
    if not all(checks.values()):
        raise AssertionError(f"elastic drill failed: {checks}; records "
                             f"{recs}")

    def fmt(xs):
        return ("not measured" if xs is None
                else "/".join(f"{x:.1f}" for x in xs))

    share = (" (both processes on card 0: each time includes the other's "
             "work)" if shared else "")
    for r in recs:
        log(f"[pod d] process {r['process']} host {r['host']}: pod-wide "
            f"served votes/s={r['votes_per_sec']:.0f} (heights 0-{EH} in "
            f"{r['wall_s']:.3f} s, the leave / rejoin cycle included); "
            f"negotiation wall ms a tick {fmt(r['negotiation_ms'])} (frame "
            f"{r['frame_bytes']} B a process), of which the gloo "
            f"all_gather (negotiate) ms {fmt(r['negotiate_ms'])}, the "
            f"frame's pack ms {fmt(r['pack_ms'])} and unpack ms (one a "
            f"host row) {fmt(r['unpack_ms'])}; densify ms "
            f"{fmt(r['densify_ms'])}; host launch ms {fmt(r['launch_ms'])}; "
            f"step ms {fmt(r['step_ms'])}; kernel ms {fmt(r['kernel_ms'])} "
            f"(cells {r['cells_by_dispatch']}); launches a height "
            f"{r['launches_by_height']} against the schedule's "
            f"{r['launches_implied']}; padded slots {r['padded_slots']}, "
            f"pad builds {r['pad_builds']}, padded phases "
            f"{r['padded_phases']}; device peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB against the dense plan's "
            f"{r['plan_peak_bytes'] / 2**30:.3f}; host RSS after the drain "
            f"{r['rss_gib']:.2f} GiB{share}; card {card}")
    log(f"[pod d] 2 hosts x (1 x 1), heights 0-{EH}, host 1 away for "
        f"heights {ELASTIC_LEAVE}-{ELASTIC_REJOIN - 1}: wall {wall:.1f} s "
        f"(spawn to join); {held} records held and re-routed; every check "
        f"held: {sorted(checks)}; card {card}")
    keys = ("votes_per_sec", "negotiation_ms", "negotiate_ms", "pack_ms",
            "unpack_ms", "densify_ms", "launch_ms",
            "step_ms", "kernel_ms", "cells_by_dispatch", "launches",
            "launches_by_height", "launches_implied", "padded_slots",
            "peak_bytes", "rss_gib", "wall_s", "frame_bytes")
    out = {k: [r[k] for r in recs] for k in keys}
    out.update(plan_peak_bytes=recs[0]["plan_peak_bytes"], held=held,
               wall_s_spawn_to_join=wall, shared_card=shared)
    return out


def _mc_run(am, entry, device, native_admission=False):
    """One admission corpus schedule through a real VoteService on
    `device` (`analysis/admission_mc.admission_service`): the recorded
    dispatch stream, the service, the decisions polled (the last poll
    after the schedule included), the run's seconds and the inputs of
    every verify the run asked for (signed dispatches and host-fallback
    batches, `admission_service`'s `verifies`)."""
    from agnes_tpu_torch.utils import budget

    t = time.perf_counter()
    cfg = am.AdmissionMCConfig.from_json(entry["config"])
    svc, window, disp, verifies = am.admission_service(
        cfg, device=device, native_admission=native_admission,
        hbm_bytes=budget.device_hbm_bytes())
    dec = am.drive_admission_service(svc, window, cfg, entry["actions"])
    dec += svc.poll_decisions()
    return (disp, svc, [tuple(d) for d in dec], time.perf_counter() - t,
            verifies)


def _mc_kernel_vs_plain(V, verifies) -> dict:
    """Hold the verify kernel against its plain version on every
    recorded verify's inputs, as recorded and again with bit 0 of S
    flipped in every real lane (S stays below L, so the lane reaches
    the kernel's check, and plain must reject it).  The recorded lanes
    must hold some that plain accepts, so a kernel that accepts, or
    rejects, everything disagrees with plain.  The kernel runs at each
    recorded verify's own launch shape; plain runs once over all of
    their lanes (each lane's verdict is independent integer math, and
    plain on the card is launch-bound: seconds a call, whatever the
    lanes)."""
    import torch

    cases = []
    counts = {"dispatch": 0, "fallback": 0}
    for kind, pub, sig, blocks, real in verifies:
        if pub.shape[0] == 0:
            continue
        counts[kind] += 1
        flipped = sig.clone()
        flipped[:, 32] ^= real.to(flipped.dtype)
        cases += [(kind, pub, sig, blocks, real, False),
                  (kind, pub, flipped, blocks, real, True)]
    got = []
    for _k, pub, sig, blocks, _r, _f in cases:
        args, ok_s = V.prologue(pub, sig, blocks)
        got.append((V.verify_signed5(*args) > 0) & ok_s)
    args, ok_s = V.prologue(*(torch.cat([c[i] for c in cases])
                              for i in (1, 2, 3)))
    sizes = [c[1].shape[0] for c in cases]
    want = ((V.verify_plain(*args) > 0) & ok_s).split(sizes)
    ok_s = ok_s.split(sizes)
    mism = max_err = n_lanes = accepted = 0
    for (kind, _p, _s, _b, real, is_flipped), g, w, ok in zip(
            cases, got, want, ok_s):
        m, e = compare(g.int(), w.int())
        mism, max_err = mism + m, max(max_err, e)
        if not is_flipped:
            accepted += int(w[real].sum())
            n_lanes += int(real.sum())
        elif not bool(ok[real].all()) or bool(w[real].any()):
            raise AssertionError(f"{kind} verify: a flipped signature "
                                 f"left S >= L or was accepted")
    if not accepted:
        raise AssertionError("no recorded lane verifies: the kernel is "
                             "not held on an accepted signature")
    return {"mismatches": mism, "max_abs_err": max_err,
            "real_lanes": n_lanes, "accepted": accepted, **counts}


def checker_phase() -> dict:
    """Phase 14: the model checkers' corpora on the card.  (a) Every
    consensus corpus entry (`tests/corpus/*.json`, read as data) through
    `analysis.modelcheck.device_replay_entry(entry, device="cuda")`: the
    signed host network runs the schedule under trace taps and each
    node's stream is replayed through the batcher and the fused device
    step; per (node, height) the device decisions must equal the signed
    host replay's, the host replay must match the entry's stamped
    decisions, and device evidence must be a subset of host evidence.
    (b) Every admission corpus entry (`tests/corpus/admission/`) through
    a real `VoteService` on the card (`admission_mc.admission_service`:
    the real `step_async`, a 1-round batcher window, the model's window
    predictor; BLS actions have no serve counterpart and are skipped):
    twice, the dispatch streams bit-identical; with native admission,
    the stream, queue counters, queue canonical form and cache counters
    equal to the Python admission's; and on the CPU in this process
    (the plain verify), the stream, rejected counts and decisions equal
    to the card's; the conservation and P in {2, 3} checks of the
    model's serve replay hold, and `adm_dedup_roundtrip` dispatches
    signed and unsigned.  The verify kernel's launches over the card
    runs must number one a verify the runs recorded (signed dispatches
    and host-fallback batches, `admission_service`'s `verifies`); then
    the kernel is held against its plain version on every recorded
    verify's inputs, as recorded and with one bit of S flipped in every
    lane, which plain must reject.  (c) The checker's CLI on the tiny
    scope as a subprocess under `timeout 120`: exit 0, ok, no violation,
    the deadline discovered from /proc, states for the consensus,
    admission and membership configs.  Returns row 1's additions."""
    import torch

    from agnes_tpu_torch.analysis import admission_mc as am
    from agnes_tpu_torch.analysis import modelcheck as mc
    from agnes_tpu_torch.crypto import ed25519_verify as V

    root = Path(__file__).resolve().parent
    corpus = root / "tests" / "corpus"
    t0 = time.perf_counter()

    # (a) the consensus corpus through the device plane
    entries = mc.load_corpus(str(corpus))
    if len(entries) < 17:
        raise AssertionError(f"consensus corpus: {len(entries)} entries")
    nodes = heights = steps = 0
    for entry in entries:
        net, results = mc.device_replay_entry(entry, device=DEVICE)
        exp = entry["expect"]["decided"]
        exp_heights = entry["expect"].get("decided_heights")
        for j, host_decs, rep in results:
            ctx = f"{entry['name']} node {j}"
            if 0 in host_decs:
                if [host_decs[0].round, host_decs[0].value] != exp[str(j)]:
                    raise AssertionError(f"{ctx}: the signed host replay "
                                         f"diverged from the stamp")
            elif str(j) in exp:
                raise AssertionError(f"{ctx}: stamped height-0 decision "
                                     f"not reached by the host replay")
            host_hr = {h: [d.round, d.value]
                       for h, d in sorted(host_decs.items())}
            if exp_heights is not None and host_hr != {
                    int(h): rv for h, rv in
                    exp_heights.get(str(j), {}).items()}:
                raise AssertionError(f"{ctx}: per-height decisions "
                                     f"diverged from the stamp")
            dev_hr = {h: [r, v] for h, (r, v) in rep.decisions.items()}
            if dev_hr != host_hr:
                raise AssertionError(f"{ctx}: device {dev_hr} != host "
                                     f"{host_hr}")
            host_ev = {e.validator for e in net.nodes[j].all_equivocations()}
            if not rep.equivocators <= host_ev:
                raise AssertionError(f"{ctx}: device evidence "
                                     f"{rep.equivocators - host_ev} "
                                     f"without host evidence")
            nodes += 1
            heights += len(host_hr)
            steps += rep.steps
    t_a = time.perf_counter() - t0
    log(f"[mc] (a) {len(entries)} consensus entries, {nodes} nodes, "
        f"{heights} (node, height) decisions, {steps} device steps: "
        f"device == host; {t_a:.3f} s")

    # (b) the admission corpus through the real VoteService
    adm = mc.load_corpus(str(corpus / "admission"))
    if len(adm) < 8:
        raise AssertionError(f"admission corpus: {len(adm)} entries")
    secs = {"card": 0.0, "card_again": 0.0, "native": 0.0, "cpu": 0.0}
    runs = {}
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    for entry in adm:
        a = _mc_run(am, entry, DEVICE)
        b = _mc_run(am, entry, DEVICE)
        n = _mc_run(am, entry, DEVICE, native_admission=True)
        runs[entry["name"]] = (a, b, n)
        for k, r in zip(("card", "card_again", "native"), (a, b, n)):
            secs[k] += r[3]
    torch.cuda.synchronize()
    launches = V.LAUNCHES
    # the driver's verify is unchunked: one launch a recorded verify
    # with a lane, signed dispatch or host-fallback batch alike
    expected = sum(1 for abn in runs.values() for r in abn
                   for v in r[4] if v[1].shape[0] > 0)
    n_disp = n_signed = 0
    verifies = []
    for entry in adm:
        name = entry["name"]
        (disp, svc, dec, _, ver), (disp2, _s2, dec2, _, _v2), \
            (ndisp, nsvc, _nd, _, _nv) = runs[name]
        verifies += ver
        if disp != disp2 or dec != dec2:
            raise AssertionError(f"{name}: two card runs differ")
        if ndisp != disp or nsvc.queue.counters != svc.queue.counters \
                or nsvc.queue.mc_canonical()[0] != \
                svc.queue.mc_canonical()[0] \
                or (svc.cache is not None
                    and nsvc.cache.counters != svc.cache.counters):
            raise AssertionError(f"{name}: native admission != Python")
        c = _mc_run(am, entry, "cpu")
        secs["cpu"] += c[3]
        rejected = [(s.driver.rejected_signature_device,
                     s.batcher.rejected_signature) for s in (svc, c[1])]
        if c[0] != disp or rejected[0] != rejected[1] or c[2] != dec:
            raise AssertionError(f"{name}: the CPU run != the card's")
        if svc.pipeline.host_fallback_builds == 0 and \
                any(p not in (2, 3) for p, _u, _b in disp):
            raise AssertionError(f"{name}: a dispatch outside P in {{2, 3}}")
        q = svc.queue.counters
        accounted = (svc.pipeline.dispatched_votes + svc.queue.depth
                     + svc.batcher.pending_votes + svc.batcher.held_votes)
        exact = not svc.batcher._host_tally and \
            svc.batcher.rejected_signature == 0
        if (q["admitted"] != accounted) if exact \
                else (q["admitted"] < accounted):
            raise AssertionError(f"{name}: admitted {q['admitted']}, "
                                 f"accounted {accounted}")
        if name == "adm_dedup_roundtrip" and \
                {u for _p, u, _b in disp} != {True, False}:
            raise AssertionError(f"{name}: not signed and unsigned")
        n_disp += len(disp)
        n_signed += sum(1 for _p, u, _b in disp if not u)
    held = _mc_kernel_vs_plain(V, verifies)
    if launches != expected or held["dispatch"] == 0 or held["mismatches"]:
        raise AssertionError(
            f"admission corpus: {launches} verify launches against "
            f"{expected} recorded verifies over the three card runs; "
            f"{held['dispatch']} signed dispatches and {held['fallback']} "
            f"fallback batches a run held, {held['mismatches']} lanes "
            f"!= plain")
    per = ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
    log(f"[mc] (b) {len(adm)} admission entries: {n_disp} dispatches a "
        f"run ({n_signed} signed); a card run verifies {held['dispatch']} "
        f"signed dispatches and {held['fallback']} host-fallback batches, "
        f"{held['real_lanes']} lanes ({held['accepted']} accepted); "
        f"{launches} verify launches over the three card runs, one a "
        f"recorded verify; twice on the card identical, native == "
        f"Python, CPU == card; kernel == plain on every recorded verify, "
        f"as recorded and with S's bit 0 flipped in every lane (all "
        f"rejected; max err {held['max_abs_err']}); seconds {per}")

    # (c) the CLI on the tiny scope under an enclosing timeout
    t = time.perf_counter()
    out = subprocess.run(
        ["timeout", "120", sys.executable, "-m",
         "agnes_tpu_torch.analysis.modelcheck", "--scope", "tiny", "--json"],
        cwd=root, capture_output=True, text=True, timeout=180)
    t_c = time.perf_counter() - t
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"modelcheck CLI: rc {out.returncode}\n"
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    rep = json.loads(lines[-1])
    if not (rep["ok"] and rep["complete"] and rep["violations"] == 0) \
            or rep["deadline"]["source"] != "proc:timeout" \
            or min(rep["consensus_states"], rep["admission_states"],
                   rep["membership_states"]) <= 0:
        raise AssertionError(f"modelcheck CLI report: {lines[-1][:2000]}")
    states = ", ".join(f"{k} {r['states']} ({r['seconds']} s)"
                       for k, r in sorted(rep["configs"].items()))
    log(f"[mc] (c) modelcheck --scope tiny: {rep['states_explored']} states "
        f"(consensus {rep['consensus_states']}, admission "
        f"{rep['admission_states']}, membership "
        f"{rep['membership_states']}), 0 violations, deadline "
        f"{rep['deadline']}; per config {states}; CLI {rep['seconds']} s, "
        f"subprocess {t_c:.3f} s")
    wall = time.perf_counter() - t0
    log(f"[mc] phase 14 {wall:.3f} s")
    return {"launches_mc_phase": launches,
            "mc": {"consensus_entries": len(entries), "nodes": nodes,
                   "node_heights": heights, "device_steps": steps,
                   "consensus_s": t_a, "admission_entries": len(adm),
                   "dispatches": n_disp, "signed_dispatches": n_signed,
                   "verified_dispatches": held["dispatch"],
                   "fallback_verifies": held["fallback"],
                   "verified_lanes": held["real_lanes"],
                   "mismatches": held["mismatches"],
                   "max_abs_err": held["max_abs_err"], "admission_s": secs,
                   "cli_states": rep["states_explored"], "cli_s": t_c,
                   "phase_s": wall}}


def analysis_phase() -> dict:
    """Phase 15: the analyzers against what the card ran; see the module
    docstring.  Returns the phase's numbers for the verify kernel's
    line."""
    import contextlib
    import io

    import torch

    from agnes_tpu_torch.analysis import lint_cli, retrace, schedcheck
    from agnes_tpu_torch.utils import metrics_cli

    t_phase = time.perf_counter()

    def cli(main_fn, argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
        return rc, out.getvalue(), time.perf_counter() - t0

    checks = {}
    # -- (a) retrace: the static proof against what the sentinels saw ----
    shapes = {}
    for tag, ladder, dense, sentinel in ANALYSIS["serves"]:
        seen = retrace.observed_shapes(sentinel)
        signed = {x for x in seen if x[0] != "unsigned"}
        checks[f"(a) {tag}: the warmup plan covers its ladder"] = \
            retrace.coverage_findings(ladder, n_phases=(2, 3), dense=dense,
                                      dedup=True) == []
        checks[f"(a) {tag}: every signed shape observed is dispatchable"] \
            = signed <= retrace.dispatchable_shapes(ladder, dense=dense)
        shapes[tag] = sorted(seen, key=repr)
        log(f"[analysis] (a) {tag}: rungs {list(ladder.rungs)}"
            f"{' (dense)' if dense else ''}; {len(seen)} shapes observed "
            f"on the card ({len(signed)} signed): {shapes[tag]}")
    checks["(a) the signed and the dense serve observed signed shapes"] = \
        all(any(x[0] != "unsigned" for x in shapes.get(t, ()))
            for t in ("phase 8 signed", "phase 12 dense"))
    # -- (b) the lint CLI over this checkout -------------------------------
    rc, out, t_lint = cli(lint_cli.main, ["--pass", "all", "--json"])
    lint_rep = json.loads(out.splitlines()[-1])
    checks["(b) lint: exit 0, ok, three passes"] = (
        rc == 0 and lint_rep["ok"]
        and set(lint_rep["passes"]) == {"retrace", "locks", "lint"})
    # -- (c) the schedule checker: no device work ---------------------------
    cuda_before = torch.cuda.is_initialized()
    rc_s, out, t_sched = cli(schedcheck.main, [
        "--scope", "tiny", "--max-schedules", "200", "--json"])
    sched_rep = json.loads(out.splitlines()[-1])
    checks["(c) schedcheck: exit 0, no violation, 200 schedules, CUDA "
           "state unchanged"] = (
        rc_s == 0 and sched_rep["violations"] == 0
        and sched_rep["schedules_explored"] == 200
        and torch.cuda.is_initialized() == cuda_before)
    # -- (d) the metrics CLI over phase 13 (a)'s heartbeat trails ----------
    trails = ANALYSIS["trails"] or []
    rc_m, _, t_check = cli(metrics_cli.main, ["--check", *trails])
    _, render, _ = cli(metrics_cli.main, trails)
    rank = [ln.split(":")[0].strip() for ln in
            render.split("\n\n")[0].splitlines()[1:]]
    checks["(d) metrics CLI: --check exit 0 on the pod's trails"] = \
        bool(trails) and rc_m == 0
    checks["(d) metrics CLI: the pod render ranks as _pod_checks did"] = \
        bool(rank) and rank == ANALYSIS["pod_rank"]
    if trails:
        shutil.rmtree(os.path.dirname(trails[0]), ignore_errors=True)
    wall = time.perf_counter() - t_phase
    if not all(checks.values()):
        raise AssertionError(f"analysis phase failed: {checks}; lint "
                             f"{lint_rep['findings']}; schedcheck "
                             f"{sched_rep['violations']}")
    log(f"[analysis] (b) lint CLI {t_lint:.2f} s, passes " + ", ".join(
        f"{k} {v['seconds']} s ({v['findings']} findings)"
        for k, v in sorted(lint_rep["passes"].items())))
    log(f"[analysis] (c) schedcheck tiny: {sched_rep['schedules_explored']} "
        f"schedules, {sched_rep['violations']} violations, "
        f"{t_sched:.2f} s; CUDA initialized before and after: "
        f"{cuda_before}")
    log(f"[analysis] (d) metrics CLI --check on {len(trails)} pod trails: "
        f"exit {rc_m} ({t_check:.3f} s); pod render host order {rank} == "
        f"_pod_checks' {ANALYSIS['pod_rank']}")
    log(f"[analysis] phase 15 {wall:.1f} s; every check held: "
        f"{len(checks)}")
    return {"analysis_phase_s": wall, "analysis_shapes": {
        t: [list(x) for x in v] for t, v in shapes.items()},
        "analysis_lint_s": t_lint, "analysis_schedcheck_s": t_sched,
        "analysis_schedules": sched_rep["schedules_explored"]}


def surface_phase(seeds, pubkeys, sigs) -> dict:
    """Phase 16: the public surface on the card; see the module
    docstring.  Returns the phase's numbers for the verify kernel's
    line."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge import VoteBatcher, WireVote
    from agnes_tpu_torch.core.state_machine import EventTag, Step
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.device import (DeviceEvent, DeviceState,
                                        apply_batch, apply_scalar)
    from agnes_tpu_torch.harness import DeviceDriver
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.scripts import surface
    from agnes_tpu_torch.types import VoteType

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    I, Vn = I_MSM, V_SIGNED
    checks = {}
    # -- (a) a signed height fed one vote at a time ------------------------
    cols = [fx.full_mesh_cols(I, Vn, seeds, 0, typ, VALUE, sigs=sigs[c])
            for c, typ in enumerate((int(VoteType.PREVOTE),
                                     int(VoteType.PRECOMMIT)))]
    t0 = time.perf_counter()
    wires = [WireVote(i, v, h, r, VoteType(t), x, g.tobytes())
             for c in cols
             for i, v, h, r, t, x, g in zip(*(a.tolist() for a in c[:6]),
                                            c[6])]
    wires += [WireVote(0, 0, 0, 0, VoteType.PREVOTE, VALUE, b"\x01" * n)
              for n in (10, 65)]
    t_wires = time.perf_counter() - t0

    def height(feed):
        """One height through `feed(batcher)`, build_phases_device and
        step_seq_signed, with the verify launches of this run alone."""
        torch.cuda.synchronize()
        V.LAUNCHES = 0
        t0 = time.perf_counter()
        bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
        feed(bat)
        t_add = time.perf_counter() - t0
        phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
        t_build = time.perf_counter() - t0 - t_add
        drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases],
                            lanes)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t1
        return dict(bat=bat, phases=phases, lanes=lanes, drv=drv,
                    launches=V.LAUNCHES, add=t_add, build=t_build,
                    step=t_step, wall=time.perf_counter() - t0)

    def bulk(bat):
        for c in cols:
            bat.add_arrays(*c)

    per = height(lambda bat: bat.extend(wires))
    ref = height(bulk)
    n_lanes = 2 * I * Vn
    checks["(a) both builds took the device-verify path"] = (
        per["lanes"] is not None and ref["lanes"] is not None
        and len(per["phases"]) == len(ref["phases"]) == 2)
    checks["(a) phases equal leaf for leaf"] = all(
        pn == rn and all(torch.equal(x, y) for x, y in zip(pp, rp))
        for (pp, pn), (rp, rn) in zip(per["phases"], ref["phases"]))
    checks["(a) lanes equal leaf for leaf"] = checks[
        "(a) both builds took the device-verify path"] and all(
        torch.equal(x, y) for x, y in zip(per["lanes"], ref["lanes"]))
    checks["(a) state and tally equal leaf for leaf"] = _same_leaves(
        _leaves(per["drv"]), _leaves(ref["drv"]))
    decs = [_decisions(h["drv"], h["bat"].decode_slot) for h in (per, ref)]
    checks["(a) decisions equal, every instance decided value 7 in "
           "round 0"] = (_same_decisions(*decs) and bool(decs[0][0].all())
                         and set(decs[0][1].tolist()) == {VALUE}
                         and not decs[0][2].any())
    checks["(a) rejected == 2I on both"] = (
        per["drv"].rejected_signature_device
        == ref["drv"].rejected_signature_device == 2 * I)
    checks["(a) rejected_malformed 2 per vote, 0 through add_arrays"] = (
        per["bat"].rejected_malformed == 2
        and ref["bat"].rejected_malformed == 0)
    checks["(a) one verify launch a height"] = \
        per["launches"] == ref["launches"] == 1
    # the kernel against its plain version on a sample of the lanes
    lanes = per["lanes"]
    idx = torch.from_numpy(np.random.RandomState(SEED).choice(
        n_lanes, N_SERVE_SAMPLE, replace=False)).to(dev)
    idx[:2] = torch.tensor([FORGED, Vn + FORGED], device=dev)
    args, _ = V.prologue(lanes.pub[idx], lanes.sig[idx], lanes.blocks[idx])
    mism, max_err = compare(V.verify_signed5(*args), V.verify_plain(*args))
    checks["(a) kernel == plain on the sampled lanes"] = mism == 0
    # -- (b) apply_scalar against apply_batch's rows ---------------------
    t0 = time.perf_counter()
    cases = []
    for step, tag, rel, locked in itertools.product(
            Step, EventTag, (-1, 0, 1), (False, True)):
        lr, lv = (1, 9) if locked else (-1, -1)
        pol = 1 if tag == EventTag.PROPOSAL else -1
        cases.append(((2, int(step), lr, lv, lr, lv, 3),
                      (int(tag), 2 + rel, 7, pol)))
    st_b, ev_b = (torch.tensor(list(zip(*col)), dtype=torch.int32,
                               device=dev) for col in zip(*cases))
    bs, bm = apply_batch(DeviceState(*st_b), DeviceEvent(*ev_b))
    want = torch.stack([*bs, *bm], dim=1)
    got = torch.stack([torch.stack([*s1, *m1]) for s1, m1 in (
        apply_scalar(DeviceState(*st_b[:, k]), DeviceEvent(*ev_b[:, k]))
        for k in range(len(cases)))])
    n_bad = int((got != want).any(dim=1).sum())
    t_scalar = time.perf_counter() - t0
    checks[f"(b) apply_scalar == apply_batch on {len(cases)} (step, tag, "
           f"round relation, guard) cases"] = n_bad == 0 and \
        got.device.type == "cuda"
    # -- (c) every name the parity test checks resolves here --------------
    t0 = time.perf_counter()
    rep = surface.check()
    t_names = time.perf_counter() - t0
    checks["(c) every twin name resolves or stands in NOT_PORTED"] = (
        rep["missing"] == [] and rep["stale"] == {})
    wall = time.perf_counter() - t_phase
    if not all(checks.values()):
        raise AssertionError(f"surface phase failed: {checks}; "
                             f"missing {rep['missing']}, stale "
                             f"{rep['stale']}, apply_scalar {n_bad} bad")
    n_wire = len(wires)
    log(f"[surface] (a) I={I} V={Vn}: {n_wire} WireVotes made in "
        f"{t_wires:.3f} s; one at a time: extend {per['add']:.3f} s "
        f"({per['add'] / n_wire * 1e6:.2f} us a vote), build_phases_device "
        f"{per['build']:.3f} s, step {per['step']:.3f} s, wall "
        f"{per['wall']:.3f} s; add_arrays: {ref['add']:.3f} s, "
        f"build_phases_device {ref['build']:.3f} s, step {ref['step']:.3f} "
        f"s, wall {ref['wall']:.3f} s; rejected "
        f"{per['drv'].rejected_signature_device}, malformed "
        f"{per['bat'].rejected_malformed}; launches {per['launches']} + "
        f"{ref['launches']}; kernel == plain on {N_SERVE_SAMPLE} lanes")
    log(f"[surface] (b) apply_scalar == apply_batch on {len(cases)} cases "
        f"on the card, {t_scalar:.3f} s")
    log(f"[surface] (c) {rep['modules']} twin modules, {rep['names']} "
        f"names: {rep['names'] - rep['excluded']} resolve in the port, "
        f"{rep['excluded']} stand in NOT_PORTED ({len(surface.NOT_PORTED)}"
        f" entries), 0 missing; {t_names:.2f} s")
    log(f"[surface] phase 16 {wall:.1f} s; every check held: {len(checks)}")
    return {"launches_surface_phase": per["launches"] + ref["launches"],
            "surface": {
                "wire_votes": n_wire, "wires_s": t_wires,
                "per_vote_extend_s": per["add"],
                "per_vote_build_s": per["build"],
                "per_vote_step_s": per["step"],
                "per_vote_wall_s": per["wall"],
                "add_arrays_s": ref["add"], "add_arrays_build_s":
                ref["build"], "add_arrays_step_s": ref["step"],
                "add_arrays_wall_s": ref["wall"],
                "sample_lanes": N_SERVE_SAMPLE, "sample_max_abs_err": max_err,
                "apply_scalar_cases": len(cases), "apply_scalar_s": t_scalar,
                "twin_names": rep["names"], "not_ported": rep["excluded"],
                "names_s": t_names, "phase_s": wall}}


def config_phase(seeds, pubkeys, sigs, classes, lane_ref) -> dict:
    """Phase 17: the run configuration on the card; see the module
    docstring.  Returns the phase's numbers for the verify kernel's
    line."""
    import numpy as np
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
    from agnes_tpu_torch.crypto import ed25519_verify as V
    from agnes_tpu_torch.harness import fixtures as fx
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.scripts import surface
    from agnes_tpu_torch.utils import RunConfig

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    I, Vn = I_SIGNED, V_SIGNED
    cols = [fx.full_mesh_cols(I, Vn, seeds, 0, typ, VALUE, sigs=sigs[c])
            for c, typ in enumerate(classes)]
    cfg = RunConfig(n_instances=I, n_validators=Vn).validate()
    checks = {}

    def device_height(make):
        """One height through `make()`'s batcher: add_arrays ->
        build_phases_device -> step_seq_signed, with the verify launches
        of this run alone."""
        torch.cuda.synchronize()
        V.LAUNCHES = 0
        t0 = time.perf_counter()
        bat = make()
        for c in cols:
            bat.add_arrays(*c)
        phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
        t_build = time.perf_counter() - t0
        drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
        drv.step_seq_signed([drv.empty_phase()] + [p for p, _ in phases],
                            lanes)
        torch.cuda.synchronize()
        return dict(bat=bat, phases=phases, lanes=lanes, drv=drv,
                    launches=V.LAUNCHES, build=t_build,
                    wall=time.perf_counter() - t0)

    def same_phases(a, b) -> bool:
        return len(a) == len(b) and all(
            na == nb and all(torch.equal(x, y) for x, y in zip(pa, pb))
            for (pa, na), (pb, nb) in zip(a, b))

    # -- (a) RunConfig.make_batcher against the twin's positional order --
    t0 = time.perf_counter()
    got = device_height(cfg.make_batcher)
    # (n_instances, n_validators, n_slots, heights, n_rounds, powers,
    #  held_cap, verify_mode, msm_leaf): the twin's order, device default
    direct = device_height(lambda: VoteBatcher(I, Vn, 4, None, 4, None,
                                               None, "lanes", 64))
    t_a = time.perf_counter() - t0
    walls = [(h["build"], h["wall"]) for h in (got, direct)]
    checks["(a) the config's batcher is the direct one's shape and "
           "policy, on the card"] = all(
        getattr(got["bat"], k) == getattr(direct["bat"], k)
        for k in ("I", "V", "W", "held_cap", "verify_mode", "msm_leaf")) \
        and got["bat"].device.type == "cuda"
    checks["(a) both builds took the device-verify path"] = (
        got["lanes"] is not None and direct["lanes"] is not None
        and len(got["phases"]) == len(direct["phases"]) == 2)
    checks["(a) phases equal leaf for leaf"] = same_phases(
        got["phases"], direct["phases"])
    checks["(a) lanes equal leaf for leaf"] = checks[
        "(a) both builds took the device-verify path"] and all(
        torch.equal(x, y) for x, y in zip(got["lanes"], direct["lanes"]))
    leaves = _leaves(got["drv"])
    checks["(a) state and tally equal leaf for leaf, and to phase 3's"] = (
        _same_leaves(leaves, _leaves(direct["drv"]))
        and _same_leaves([x.cpu() for x in leaves], lane_ref["leaves"]))
    dec = _decisions(got["drv"], got["bat"].decode_slot)
    ref3 = lane_ref["stats"]
    checks["(a) decisions equal the direct build's and phase 3's: every "
           "instance decided value 7 in round 0"] = (
        _same_decisions(dec, _decisions(direct["drv"],
                                        direct["bat"].decode_slot))
        and np.array_equal(dec[0], ref3["decided"])
        and np.array_equal(got["drv"].stats.decision_value,
                           ref3["decision_value"])
        and np.array_equal(dec[2], ref3["decision_round"])
        and bool(dec[0].all()) and set(dec[1].tolist()) == {VALUE}
        and not dec[2].any())
    checks["(a) rejected == 2I on both, as in phase 3"] = (
        got["drv"].rejected_signature_device
        == direct["drv"].rejected_signature_device
        == lane_ref["rejected"] == 2 * I)
    checks["(a) one verify launch a build"] = \
        got["launches"] == direct["launches"] == 1
    # the kernel against its plain version on a sample of the lanes
    n_lanes = 2 * I * Vn
    lanes = got["lanes"]
    idx = torch.from_numpy(np.random.RandomState(SEED + 17).choice(
        n_lanes, N_SERVE_SAMPLE, replace=False)).to(dev)
    idx[:2] = torch.tensor([FORGED, I * Vn + FORGED], device=dev)
    args, _ = V.prologue(lanes.pub[idx], lanes.sig[idx], lanes.blocks[idx])
    mism, max_err = compare(V.verify_signed5(*args), V.verify_plain(*args))
    checks["(a) kernel == plain on the sampled lanes"] = mism == 0
    del args, lanes, direct
    got.pop("lanes")
    # -- (b) RunConfig.make_native_loop: push -> build_phases ------------
    wires = [pack_wire_votes(*c) for c in cols]
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    loop = cfg.make_native_loop(pubkeys, np.ones(Vn, np.int64))
    drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
    loop.sync_device(drv.tally.base_round.cpu().numpy(),
                     drv.state.height.cpu().numpy())
    for w in wires:
        loop.push(w)
    phases = loop.build_phases()
    t_loop_build = time.perf_counter() - t0
    drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    loop_launches = V.LAUNCHES
    # the verdict-filtered phases of the same wire through the config's
    # batcher (`build_phases(pubkeys)`; its verify launch counted apart)
    t0 = time.perf_counter()
    ref = cfg.make_batcher()
    for c in cols:
        ref.add_arrays(*c)
    want = ref.build_phases(pubkeys)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    checks["(b) the loop's phases == the config batcher's verdict-filtered "
           "build, leaf for leaf"] = same_phases(phases, want)
    checks["(b) state and tally == (a)'s leaf for leaf, decisions equal"] = (
        _same_leaves(_leaves(drv), leaves)
        and _same_decisions(_decisions(drv, loop.decode_slot), dec))
    checks["(b) one verify launch, 2I rejected"] = (
        loop_launches == 1
        and loop.counters["rejected_signature"] == 2 * I)
    del phases, want, ref, loop, drv, leaves, got
    # -- (c) the refusals, the flags and the surface -------------------
    t0 = time.perf_counter()
    try:
        RunConfig(n_instances=I, n_validators=Vn,
                  verify_mode="msm").validate().make_native_loop(pubkeys)
        refused = False
    except ValueError:
        refused = True
    checks["(c) make_native_loop refuses verify_mode='msm'"] = refused
    argv = ["--validators", str(Vn), "--instances", str(I), "--rounds", "3",
            "--slots", "2", "--mesh", "4x2", "--float-dtype", "float32",
            "--verify-mode", "msm", "--held-cap", "65536",
            "--checkpoint-dir", "ckpt", "--checkpoint-every", "5"]
    checks["(c) from_args gives the flags' values back"] = \
        RunConfig.from_args(argv) == RunConfig(
            n_validators=Vn, n_instances=I, n_rounds=3, n_slots=2,
            mesh=(4, 2), float_dtype="float32", verify_mode="msm",
            held_cap=65536, checkpoint_dir="ckpt", checkpoint_every_steps=5)
    rep = surface.check()
    checks["(c) surface: 0 missing names, 0 parameter problems, 0 stale "
           "entries"] = (rep["missing"] == [] and rep["stale"] == {}
                         and rep["param_problems"] == []
                         and rep["stale_departs"] == {})
    t_c = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    if not all(checks.values()):
        raise AssertionError(f"config phase failed: {checks}; parameter "
                             f"problems {rep['param_problems']}, stale "
                             f"{rep['stale_departs']}")
    log(f"[config] (a) RunConfig(n_instances={I}, n_validators={Vn})"
        f".make_batcher(): build {walls[0][0]:.3f} s, with the step "
        f"{walls[0][1]:.3f} s; VoteBatcher(I, V, 4, None, 4, None, None, "
        f"'lanes', 64): build {walls[1][0]:.3f} s, with the step "
        f"{walls[1][1]:.3f} s; {n_lanes} lanes and one launch each; phases, "
        f"lanes, leaves and decisions equal (and to phase 3's), rejected "
        f"{2 * I}; kernel == plain on {N_SERVE_SAMPLE} sampled lanes; "
        f"{t_a:.3f} s")
    log(f"[config] (b) make_native_loop(pubkeys, powers): push + "
        f"build_phases {t_loop_build:.3f} s, with the step {t_b:.3f} s, "
        f"{loop_launches} launch; phases == the config batcher's "
        f"build_phases(pubkeys) ({t_ref:.3f} s, its launch apart), "
        f"leaves == (a)'s")
    log(f"[config] (c) msm refused, from_args round trip, surface: "
        f"{rep['callables']} callables, {rep['departed']} parameters in "
        f"DEPARTS ({len(surface.DEPARTS)} entries), 0 problems; "
        f"{t_c:.2f} s")
    log(f"[config] phase 17 {wall:.1f} s; every check held: {len(checks)}")
    return {"launches_config_phase": 1 + loop_launches,
            "config": {"a_s": t_a, "a_build_s": walls[0][0],
                       "a_wall_s": walls[0][1], "a_direct_build_s":
                       walls[1][0], "a_direct_wall_s": walls[1][1],
                       "b_s": t_b, "b_build_s": t_loop_build,
                       "b_reference_s": t_ref,
                       "c_s": t_c, "phase_s": wall,
                       "sample_lanes": N_SERVE_SAMPLE,
                       "sample_max_abs_err": max_err,
                       "callables": rep["callables"],
                       "departed": rep["departed"]}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", default=None,
                    help="csrc/ of an earlier checkout: phase 2c also "
                         "runs its bls_fp kernels beside this one's")
    parent_csrc = ap.parse_args(argv).parent_csrc
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from agnes_tpu_torch import cuda_build
        from agnes_tpu_torch.bridge import ingest
        from agnes_tpu_torch.bridge.ingest import VoteBatcher, vote_messages_np
        from agnes_tpu_torch.crypto import ed25519
        from agnes_tpu_torch.crypto import ed25519_point as E
        from agnes_tpu_torch.crypto import ed25519_ref as ref
        from agnes_tpu_torch.crypto import field as F
        from agnes_tpu_torch.crypto import bls_field as BF
        from agnes_tpu_torch.crypto import msm as M
        from agnes_tpu_torch.crypto import ed25519_verify as V
        from agnes_tpu_torch.harness import fixtures as fx
        from agnes_tpu_torch.harness.device_driver import DeviceDriver
        from agnes_tpu_torch.scripts import bls_fp_probe
        from agnes_tpu_torch.scripts import microbench_layout as MB
        from agnes_tpu_torch.scripts import verify_probe
        from agnes_tpu_torch.types import VoteType
        from agnes_tpu_torch.utils import budget
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    dev = torch.device(DEVICE)
    card = smi("name,power.limit")
    log(f"[card] {card}")
    props = torch.cuda.get_device_properties(0)
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    bound = Bound(props.multi_processor_count, sm_clock_mhz)
    rows = {}                # kernel name -> its line in the JSON output

    # -- phase 1: build ---------------------------------------------------
    kernels = [V.KERNEL, F.POW_KERNEL, E.STRAUS_KERNEL, BF.FP_KERNEL,
               MB.KERNEL]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(3)
    probe_job = pool.submit(verify_probe.build_chains)
    if parent_csrc is not None:
        def build_parent():
            par = (Path(parent_csrc) / "bls_fp.cu").read_bytes()
            if par == (cuda_build.CSRC / "bls_fp.cu").read_bytes():
                log("[build] parent bls_fp.cu is this tree's: phase 2c "
                    "times it once")
                return None
            d = cuda_build.BUILD / "parent"
            d.mkdir(parents=True, exist_ok=True)
            src = d / "bls_fp.cu"
            src.write_bytes(par)
            usage, secs = bls_fp_probe.nvcc(src, src.with_suffix(".so"))
            log(f"[build] parent bls_fp: nvcc {secs:.1f} s; {usage}")
            return bls_fp_probe.ParentKernels(src.with_suffix(".so"))
        parent_job = pool.submit(build_parent)
    cuda_build.build_all(kernels)
    probe_so = probe_job.result()
    if parent_csrc is not None:
        parent_job.result()
    pool.shutdown()
    log(f"[build] {len(kernels)} sources in parallel, with the chain probe"
        + (" (and the parent's bls_fp)" if parent_csrc else "") + f": {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        log(f"[build] {name}: nvcc {cuda_build.build_seconds[name]:.1f} s")
        for line in cuda_build.ptxas_report(name):
            log(f"[build] {name}: {line}")

    # -- fixture: one signature per validator per class -------------------
    t0 = time.perf_counter()
    seeds = fx.deterministic_seeds(V_SIGNED)
    pubkeys = fx.validator_pubkeys(seeds)
    classes = (int(VoteType.PREVOTE), int(VoteType.PRECOMMIT))
    sigs = [fx.sign_class(seeds, 0, typ, VALUE, forge_validator=FORGED)
            for typ in classes]
    msgs = [vote_messages_np(*[np.full(1, x, np.int64)
                               for x in (0, 0, typ, VALUE)])[0].tobytes()
            for typ in classes]
    honest = [s.copy() for s in sigs]
    for c in range(2):
        honest[c][FORGED] = np.frombuffer(ref.sign(seeds[FORGED], msgs[c]),
                                          np.uint8)
    log(f"[fixture] {V_SIGNED} keys, {2 * V_SIGNED + 2} signatures: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: verify kernel vs plain on the card ----------------------
    grid = fx.adversarial_grid()
    sk, pk = ref.keypair(bytes([1]) * 32)
    tmsg = b"\x05" * 45
    good = ref.sign(sk, tmsg)
    tors = fx.torsioned_sig(bytes([7]) * 32, tmsg)
    pubs = grid[0] + [pk, tors[0], pk]
    mss = grid[1] + [tmsg, tmsg, tmsg]
    sgs = grid[2] + [good, tors[2], bytes([good[0] ^ 1]) + good[1:]]
    want = np.array([ref.verify(p, m, s) for p, m, s in zip(pubs, mss, sgs)])
    if not (want[:4].all() and want[17] and not want[4:17].any()
            and want.tolist()[-3:] == [True, True, False]):
        raise AssertionError(f"oracle grid changed: {want.tolist()}")
    rng = np.random.RandomState(SEED)
    rp, rm, rs = random_lanes(rng, pubkeys, msgs, sigs, N_RANDOM)
    n_grid = len(pubs)
    pub, sig, blocks = ed25519.pack_verify_inputs(pubs + rp, mss + rm,
                                                  sgs + rs, device=dev)
    args, ok_s = V.prologue(pub, sig, blocks)
    got_k = V.verify_signed5(*args)
    got_p = V.verify_plain(*args)
    torch.cuda.synchronize()
    mism_small = int((got_k != got_p).sum())
    full_k = ((got_k > 0) & ok_s).cpu().numpy()
    if mism_small or not (full_k[:n_grid] == want).all():
        raise AssertionError(
            f"verify kernel disagrees: {mism_small} lanes vs plain; grid "
            f"kernel {full_k[:n_grid].astype(int).tolist()} oracle "
            f"{want.astype(int).tolist()}")
    batch_ok = ed25519.verify_batch(pub[:n_grid], sig[:n_grid],
                                    blocks[:n_grid]).cpu().numpy()
    if not (batch_ok == want).all():
        raise AssertionError("verify_batch disagrees with the oracle")
    log(f"[verify] kernel == plain on {n_grid + N_RANDOM} lanes "
        f"({int(full_k[n_grid:].sum())} of {N_RANDOM} random lanes valid); "
        f"grid == ed25519_ref on {n_grid} lanes")

    # -- phase 2b: the other kernels vs plain on the card -----------------
    # window-4 verify: its public entry once (the launch count of its
    # path), then kernel vs plain lane for lane
    V.LAUNCHES_W4 = 0
    w4_full = ed25519.verify_batch(pub, sig, blocks, window=4).cpu().numpy()
    w4_launches = V.LAUNCHES_W4
    if not ((w4_full == full_k).all() and w4_launches == 1):
        raise AssertionError(f"verify_batch(window=4) differs from window 5 "
                             f"({int((w4_full != full_k).sum())} lanes) or "
                             f"launched {w4_launches} times")
    args4, _ = V.prologue(pub, sig, blocks, window=4)
    mism_w4, err_w4 = compare(V.verify_w4(*args4),
                              V.verify_plain(*args4, window=4))
    if mism_w4:
        raise AssertionError(f"window-4 kernel != plain on {mism_w4} lanes")
    log(f"[verify w4] kernel == plain on {n_grid + N_RANDOM} lanes; "
        f"verify_batch(window=4) == window 5 == ed25519_ref on the grid "
        f"(launches {w4_launches})")

    # pow: random weak limbs and the edges, at both exponents of the path
    xs = rng.randint(-8800, 8801, (N_RANDOM, 20)).astype(np.int32)
    edges = [0, 1, P - 1, P, P + 1, 2**255 - 1, 2**260 - 1]
    xs[:len(edges)] = [[(v >> (13 * i)) & 0x1FFF for i in range(20)]
                       for v in edges]
    xs[len(edges)] = -8800
    x_pow = torch.from_numpy(xs).to(dev)
    mism_pow = err_pow = 0
    for e in ((P - 5) // 8, P - 2, 65537):
        want_pow = F.freeze(F.pow_plain(x_pow, e))
        m, er = compare(F.pow_p(x_pow, e), want_pow)
        mism_pow, err_pow = mism_pow + m, max(err_pow, er)
    if mism_pow:
        raise AssertionError(f"pow kernel != plain on {mism_pow} lanes")
    log(f"[pow] kernel == plain (frozen) on {N_RANDOM} lanes at e = (p-5)/8 "
        f"and p-2 (chains) and 65537 (windows), edges included")

    # Straus: the edge lanes, then random scalars < L with A decompressed
    # from the fixture's keys; 4,197 lanes, not a multiple of 32
    def limbs13(vals):
        return torch.tensor([[(v >> (13 * i)) & 0x1FFF for i in range(20)]
                             for v in vals], dtype=torch.int32, device=dev)

    def scalars(n):
        return limbs13([int.from_bytes(rng.bytes(32), "little") % ref.L
                        for _ in range(n)])

    n_st = 96 + N_RANDOM + 5
    sv = [int.from_bytes(rng.bytes(32), "little") % ref.L
          for _ in range(n_st)]
    kv = [int.from_bytes(rng.bytes(32), "little") % ref.L
          for _ in range(n_st)]
    for i, (a, b) in enumerate([(a, b) for a in (0, 1, ref.L - 1,
                                                 2**260 - 1)
                                for b in (0, 1, 2**260 - 1)]):
        sv[i], kv[i] = a, b                   # lanes 0-11: the edges
    tors = list(range(12, 16))                # A with an order-4 part
    for i in list(range(16, 32, 2)) + list(range(64, 96, 3)):
        kv[i] = 0                             # warps 0, 2: k = 0 mixed in
    for i in range(32, 64):
        kv[i] = 0                             # warp 1: all k = 0
    key_idx = rng.randint(V_SIGNED, size=n_st)
    a_ref = [ref._decompress(bytes(pubkeys[j])) for j in key_idx]
    tau = ref._decompress(bytes(32))          # y = 0: order 4
    for i in tors:
        a_ref[i] = ref._add(a_ref[i], tau)
    a_st, _ = E.decompress(torch.from_numpy(
        pubkeys[key_idx].astype(np.int32)).to(dev))
    ti = torch.tensor(tors, device=dev)
    a_st = E.Point(*(c.index_put((ti,), limbs13([a_ref[i][j] % P
                                                 for i in tors]))
                     for j, c in enumerate(a_st)))
    s_st, k_st = limbs13(sv), limbs13(kv)
    q_p = E.straus_plain(s_st, k_st, a_st)
    q_k = E.straus_sub(s_st, k_st, a_st)
    mism_st, err_st = straus_check(E, F, q_k, q_p)
    enc = E.compress(q_k).cpu().numpy()
    sample = list(range(96)) + list(range(96, n_st, 97))
    oracle_bad = [i for i in sample if bytes(enc[i].astype(np.uint8))
                  != straus_oracle(ref, sv[i], kv[i], a_ref[i])]
    if mism_st or oracle_bad:
        raise AssertionError(f"straus kernel != plain on {mism_st} lane "
                             f"checks; != the oracle on lanes {oracle_bad}")
    log(f"[straus] kernel == plain as group elements, X Y = Z T, on {n_st} "
        f"lanes (edge scalars, torsioned A, mixed and all-zero k warps); "
        f"== the RFC 8032 oracle's encoding on {len(sample)} lanes")
    del q_p, q_k, a_st, s_st, k_st

    # -- phase 2c: the BLS12-381 field kernels vs plain on the card -------
    bls_fp = BlsFp(rng, bound)
    if parent_csrc is not None:
        bls_fp.parent = parent_job.result()
    bls_fp.check()
    for n in (BLS_REAL_ROWS, BLS_BIG_ROWS):
        bls_fp.time_at(n)

    # -- phase 2d: the layout microbenchmark and its chain kernel ---------
    rows["fe13_chain"] = chain_phase(bound)

    # -- phase 3: one signed height at full width (the main path) ---------
    I, Vn = I_SIGNED, V_SIGNED
    cols = [fx.full_mesh_cols(I, Vn, seeds, 0, typ, VALUE, sigs=sigs[c])
            for c, typ in enumerate(classes)]
    torch.cuda.synchronize()
    V.LAUNCHES = 0
    t0 = time.perf_counter()
    bat = VoteBatcher(I, Vn, n_slots=4, device=dev)
    for c in cols:
        bat.add_arrays(*c)
    t_add = time.perf_counter() - t0
    phases, lanes = bat.build_phases_device(pubkeys, phase_offset=1)
    if lanes is None or len(phases) != 2:
        raise AssertionError("signed height did not take the device path")
    t_build = time.perf_counter() - t0
    drv = DeviceDriver(I, Vn, advance_height=True, device=dev)
    seq = [drv.empty_phase()] + [p for p, _ in phases]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    drv.step_seq_signed(seq, lanes)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    launches = V.LAUNCHES
    n_lanes = int(lanes.pub.shape[0])
    ws_lane = (torch.cuda.max_memory_allocated() - before) / n_lanes
    values = {bat.decode_slot(i, int(s))
              for i, s in enumerate(drv.stats.decision_value)}
    checks = {
        "all decided": bool(drv.stats.decided.all()),
        "round 0": bool((drv.stats.decision_round == 0).all()),
        f"value {VALUE}": values == {VALUE},
        "rejected == 2I": drv.rejected_signature_device == 2 * I,
        "heights advanced": bool((drv.state.height == 1).all()),
        "kernel launched": launches > 0,
        "workspace within the planner's constant":
            ws_lane <= budget.VERIFY_WORKSPACE_LANE_BYTES,
    }
    if not all(checks.values()):
        raise AssertionError(f"signed height failed: {checks}")
    log(f"[signed] I={I} V={Vn} lanes={n_lanes} rejected="
        f"{drv.rejected_signature_device} launches={launches} wall="
        f"{wall:.3f} s (add_arrays {t_add:.3f} s, build_phases_device "
        f"{t_build - t_add:.3f} s, step {t_step:.3f} s) "
        f"verified votes/s={n_lanes / wall:.0f} (step only "
        f"{n_lanes / t_step:.0f})")
    log(f"[signed] step workspace (peak - allocated before the step) / "
        f"lanes = {ws_lane:.1f} B a lane (planner constant "
        f"{budget.VERIFY_WORKSPACE_LANE_BYTES} B); allocated before the "
        f"step {before / 2**30:.3f} GiB, step peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # the same step again on a fresh driver: steady state, without the
    # first launch of each operator (its decisions must not change)
    warm = DeviceDriver(I, Vn, advance_height=True, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    warm.step_seq_signed([warm.empty_phase()] + [p for p, _ in phases], lanes)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t1
    if not ((warm.stats.decision_value == drv.stats.decision_value).all()
            and warm.rejected_signature_device == 2 * I):
        raise AssertionError("repeated signed height diverged")
    log(f"[signed] repeat step (warm) {t_warm:.3f} s, verified votes/s="
        f"{n_lanes / t_warm:.0f}")
    signed_variants(I, Vn, phases, lanes, drv)

    # where the step's time goes, then kernel vs plain at this lane count
    prologue_ms = cuda_ms(lambda: V.prologue(lanes.pub, lanes.sig,
                                             lanes.blocks), 1)
    args, _ = V.prologue(lanes.pub, lanes.sig, lanes.blocks)
    V.verify_signed5(*args)                      # warm
    ms = cuda_ms(lambda: V.verify_signed5(*args), KERNEL_REPS)
    out_k = V.verify_signed5(*args)
    plain = {}
    plain_ms = cuda_ms(lambda: plain.setdefault("ok", V.verify_plain(*args)),
                       1)
    mism, max_err = compare(out_k, plain["ok"])
    del plain
    if mism:
        raise AssertionError(f"kernel != plain on {mism} of {n_lanes} lanes")
    bound_ms, bound_by = bound(V.INT32_OPS_PER_LANE * n_lanes,
                               V.BYTES_PER_LANE * n_lanes)
    log(f"[verify] B={n_lanes}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
        f" bound {bound_ms:.3f} ms ({V.INT32_OPS_PER_LANE} int32 ops/lane "
        f"at {bound.desc}), kernel-only verifies/s="
        f"{n_lanes / ms * 1e3:.0f}; prologue {prologue_ms:.3f} ms, rest of "
        f"the warm step {t_warm * 1e3 - prologue_ms - ms:.3f} ms")
    phase3_rate = n_lanes / wall
    # phase 12 holds its dense height against this one
    lane_ref = {"leaves": [x.cpu() for x in _leaves(drv)],
                "stats": {f: getattr(drv.stats, f).copy()
                          for f in ("decided", "decision_value",
                                    "decision_round")},
                "rejected": drv.rejected_signature_device}
    rows["ed25519_verify_signed5"] = {
        "route": "cuda", "source": "agnes_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "agnes_tpu/crypto/pallas_verify.py:409",
        "launches": launches, "max_abs_err": max_err,
        "mismatches": mism + mism_small, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "lanes": n_lanes}
    del args, out_k, lanes, phases, seq, bat, drv, warm, cols
    torch.cuda.empty_cache()

    # -- phase 3n: the signed height at the north-star shape ---------------
    ns_row, north_decisions = north_star_phase(seeds, pubkeys, sigs, bound)
    rows["ed25519_verify_signed5"].update(ns_row)

    # -- phase 4: unsigned heights at the north-star state size -----------
    t0 = time.perf_counter()
    d4 = DeviceDriver(I_UNSIGNED, V_UNSIGNED, advance_height=True,
                      device=dev)
    d4.run_heights_fused(HEIGHTS)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    if not (bool((d4.state.height == HEIGHTS).all())
            and d4.stats.decisions_total == HEIGHTS * I_UNSIGNED):
        raise AssertionError("unsigned heights did not all decide")
    votes = 2 * HEIGHTS * I_UNSIGNED * V_UNSIGNED
    log(f"[unsigned] I={I_UNSIGNED} V={V_UNSIGNED} heights={HEIGHTS} "
        f"wall={wall4:.3f} s votes/s={votes / wall4:.0f} peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del d4
    torch.cuda.empty_cache()

    # -- phase 5: the MSM batch-verify path --------------------------------
    def msm_height(n_inst, class_sigs):
        """One height through the MSM-mode bridge and step_seq, with the
        launch counts of this run alone."""
        cols = [fx.full_mesh_cols(n_inst, Vn, seeds, 0, typ, VALUE,
                                  sigs=class_sigs[c])
                for c, typ in enumerate(classes)]
        torch.cuda.synchronize()
        V.LAUNCHES = F.POW_LAUNCHES = E.STRAUS_LAUNCHES = 0
        t0 = time.perf_counter()
        bat = VoteBatcher(n_inst, Vn, n_slots=4, device=dev,
                          verify_mode="msm", msm_leaf=64)
        for c in cols:
            bat.add_arrays(*c)
        t_add = time.perf_counter() - t0
        phases, lanes = bat.build_phases_device(pubkeys)
        t_build = time.perf_counter() - t0 - t_add
        drv = DeviceDriver(n_inst, Vn, advance_height=True, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        drv.step_seq([drv.empty_phase()] + [p for p, _ in phases])
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        counts = {"verify": V.LAUNCHES, "pow": F.POW_LAUNCHES,
                  "straus": E.STRAUS_LAUNCHES}
        values = {bat.decode_slot(i, int(s))
                  for i, s in enumerate(drv.stats.decision_value)}
        ok = (lanes is None and bool(drv.stats.decided.all())
              and bool((drv.stats.decision_round == 0).all())
              and values == {VALUE})
        return (bat, cols, ok, counts,
                dict(wall=wall, add=t_add, build=t_build, step=t_step))

    bat5, cols5, ok5, n5, t5 = msm_height(I_MSM, honest)
    n_msm = 2 * I_MSM * Vn
    if not (ok5 and bat5.rejected_signature == 0 and n5["pow"] == 2
            and n5["straus"] == 1 and n5["verify"] == 0):
        raise AssertionError(f"MSM height failed: decided {ok5}, rejected "
                             f"{bat5.rejected_signature}, launches {n5}")
    log(f"[msm] I={I_MSM} V={Vn} lanes={n_msm} rejected=0 launches={n5} "
        f"wall={t5['wall']:.3f} s (add_arrays {t5['add']:.3f} s, "
        f"build_phases_device incl. the MSM verify {t5['build']:.3f} s, "
        f"step {t5['step']:.3f} s) verified votes/s={n_msm / t5['wall']:.0f}")

    # the verify's parts on the same lanes, by CUDA events
    cat = ingest._Batch(*[np.concatenate(x) for x in zip(*cols5)])
    pub5, sig5, blk5 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in bat5._pack_verify_inputs_np(cat, pubkeys))
    parts = {}
    parts["decompress (2 pow launches)"] = cuda_ms(
        lambda: (E.decompress(pub5), E.decompress(sig5[:, :32])), 1)
    (a_pt, ok_a), (r_pt, ok_r) = E.decompress(pub5), E.decompress(sig5[:, :32])
    z = M.make_z(n_msm, device=dev)

    def scalar_part():
        from agnes_tpu_torch.crypto import scalar as S
        from agnes_tpu_torch.crypto import sha512
        k = S.barrett_reduce(S.digest_to_limbs(sha512.sha512_blocks(blk5)))
        s = S.scalar_from_bytes32(sig5[:, 32:])
        zk, zs = M.mul_mod_L(z, k), M.mul_mod_L(z, s)
        return zk, M.sum_mod_L(zs)

    parts["scalars (SHA-512, mod L)"] = cuda_ms(scalar_part, 1)
    zk, c5 = scalar_part()

    parts["two MSMs (bucket scans, aggregates, doubling chain)"] = cuda_ms(
        lambda: M.msm_sum([(E.point_neg(a_pt), zk, M.NW_FULL),
                           (E.point_neg(r_pt), z, M.NW_Z)]), 1)
    parts["[c]B (1 straus launch)"] = cuda_ms(lambda: M.scalar_mul_base(c5), 1)
    log("[msm] verify parts: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in parts.items()))
    del a_pt, r_pt, zk, z

    bat_f, _, ok_f, n_f, t_f = msm_height(I_MSM_FORGED, sigs)
    if not (ok_f and bat_f.rejected_signature == 2 * I_MSM_FORGED
            and n_f["verify"] > 0):
        raise AssertionError(f"forged MSM height failed: decided {ok_f}, "
                             f"rejected {bat_f.rejected_signature}, "
                             f"launches {n_f}")
    log(f"[msm forged] I={I_MSM_FORGED} V={Vn} lanes="
        f"{2 * I_MSM_FORGED * Vn} rejected={bat_f.rejected_signature} "
        f"launches={n_f} (MSM passes {n_f['pow'] // 2}) wall="
        f"{t_f['wall']:.3f} s (build_phases_device {t_f['build']:.3f} s, "
        f"step {t_f['step']:.3f} s)")

    # each kernel next to its plain version and its bound.  A bound counts
    # the least work of the kernel's function on this run's inputs (the
    # shortest known chain for pow; for Straus, per lane the less of a
    # joint double-and-add and the kernel's comb and windows on these
    # scalars); the kernel's own count stands beside it.
    e58 = (P - 5) // 8
    dms = bls_fp_probe.device_ms

    def time_pow(lanes_n):
        """The kernel by device time, limb for limb against the frozen
        plain power."""
        x = torch.from_numpy(rng.randint(0, 8192, (lanes_n, 20))
                             .astype(np.int32)).to(dev)
        plain = {}
        p_ms = cuda_ms(lambda: plain.setdefault(
            "y", F.freeze(F.pow_plain(x, e58))), 1)
        r = {"plain_ms": p_ms}
        F.pow_p(x, e58)                                # warm
        r["ms"] = dms(lambda: F.pow_p(x, e58), KERNEL_REPS)
        m, er = compare(F.pow_p(x, e58), plain["y"])
        r["bound_ms"], r["bound_by"] = bound(
            F.pow_least_int32_ops(e58) * lanes_n,
            160 * lanes_n + 4 * e58.bit_length())
        r["mismatches"], r["max_abs_err"] = m, er
        return r

    n_big = 2 * I_SIGNED * V_SIGNED
    pow_n = time_pow(n_msm)               # each decompress: every lane
    pow_big = time_pow(n_big)
    if pow_n["mismatches"] or pow_big["mismatches"]:
        raise AssertionError("pow kernel != plain at the timing shapes")
    for n, r in ((n_msm, pow_n), (n_big, pow_big)):
        log(f"[pow] B={n} e=(p-5)/8: kernel {r['ms']:.4f} ms"
            f", plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {F.pow_least_int32_ops(e58)} int32 ops/lane, "
            f"the kernel's chain {F.pow_int32_ops(e58)}, at {bound.desc}), "
            f"kernel at {100 * r['bound_ms'] / r['ms']:.3g}% of the bound")
    rows["fe25519_pow"] = {
        "route": "cuda", "source": "agnes_tpu_torch/csrc/ed25519_pow.cu",
        "replaces": "agnes_tpu/crypto/pallas_ed25519.py:169",
        "launches": n5["pow"],
        "max_abs_err": max(err_pow, pow_n["max_abs_err"],
                           pow_big["max_abs_err"]),
        "mismatches": mism_pow + pow_n["mismatches"] + pow_big["mismatches"],
        "ms": pow_n["ms"], "plain_ms": pow_n["plain_ms"],
        "bound_ms": pow_n["bound_ms"], "bound_by": pow_n["bound_by"],
        "library_ms": None, "lanes": n_msm,
        "least_int32_ops_per_lane": F.pow_least_int32_ops(e58),
        "kernel_int32_ops_per_lane": F.pow_int32_ops(e58),
        f"ms_{n_big}": pow_big["ms"], f"plain_ms_{n_big}": pow_big["plain_ms"],
        f"bound_ms_{n_big}": pow_big["bound_ms"]}

    def time_straus(s, k, a, reps):
        """The kernel by device time, against the plain version as a group
        element."""
        lanes_n = s.shape[0]
        plain = {}
        p_ms = cuda_ms(lambda: plain.setdefault(
            "q", E.straus_plain(s, k, a)), 1)
        r = {"plain_ms": p_ms}
        E.straus_sub(s, k, a)                          # warm
        r["ms"] = dms(lambda: E.straus_sub(s, k, a), reps)
        m, er = straus_check(E, F, E.straus_sub(s, k, a), plain["q"])
        least = E.straus_least_int32_ops(s, k)
        r["bound_ms"], r["bound_by"] = bound(
            least, E.STRAUS_BYTES_PER_LANE * lanes_n)
        r["least_per_lane"] = least / lanes_n
        r["mismatches"], r["max_abs_err"] = m, er
        return r

    # [c]B as the MSM path runs it (scalar_mul_base: B = 1, k = 0, A the
    # identity), with its latency floor, then a standalone shape no caller
    # has yet: 128,000 lanes of random s, k < L and A from the fixture's
    # keys
    c1 = c5.reshape(1, -1)
    z1 = torch.zeros_like(c1)
    st_1 = time_straus(c1, z1, E.identity((1,), dev), 50)
    mul_ns = verify_probe.chain_latency_ns(probe_so, "r32_mul")
    chain = E.straus_chain_muls(c1, z1)
    st_1["latency_floor_ms"] = chain * mul_ns * 1e-6
    s_n, k_n = scalars(n_msm), scalars(n_msm)
    a_n, _ = E.decompress(torch.from_numpy(
        pubkeys[rng.randint(V_SIGNED, size=n_msm)].astype(np.int32)).to(dev))
    st_n = time_straus(s_n, k_n, a_n, KERNEL_REPS)
    del s_n, k_n, a_n
    if st_1["mismatches"] or st_n["mismatches"]:
        raise AssertionError("straus kernel != plain at the timing shapes")
    for n, r in ((1, st_1), (n_msm, st_n)):
        log(f"[straus] B={n}: kernel {r['ms']:.4f} ms"
            f", plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}; least {r['least_per_lane']:.0f} int32 "
            f"ops/lane on these scalars, the kernel's "
            f"{E.STRAUS_INT32_OPS_PER_LANE} walking -[k]A, "
            f"{E.STRAUS_COMB_INT32_OPS_PER_LANE} where its warp's k are 0, "
            f"at {bound.desc}), kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.3g}% of the bound"
            + (f"; latency floor {r['latency_floor_ms']:.4f} ms ({chain} "
               f"dependent multiplies x {mul_ns:.2f} ns, one radix-2^32 "
               f"multiply's dependent latency on one warp), kernel at "
               f"{r['ms'] / r['latency_floor_ms']:.3g}x the floor"
               if n == 1 else ""))
    rows["ed25519_straus"] = {
        "route": "cuda", "source": "agnes_tpu_torch/csrc/ed25519_straus.cu",
        "replaces": "agnes_tpu/crypto/pallas_ed25519.py:146",
        "launches": n5["straus"],
        "max_abs_err": max(err_st, st_1["max_abs_err"], st_n["max_abs_err"]),
        "mismatches": mism_st + st_1["mismatches"] + st_n["mismatches"],
        "ms": st_1["ms"], "plain_ms": st_1["plain_ms"],
        "bound_ms": st_1["bound_ms"], "bound_by": st_1["bound_by"],
        "library_ms": None, "lanes": 1,
        "latency_floor_ms": st_1["latency_floor_ms"],
        "chain_multiplies": chain, "mul_latency_ns": mul_ns,
        "least_int32_ops_per_lane": st_1["least_per_lane"],
        "kernel_int32_ops_per_lane": E.STRAUS_INT32_OPS_PER_LANE,
        "kernel_int32_ops_per_lane_k0_warp": E.STRAUS_COMB_INT32_OPS_PER_LANE,
        f"ms_{n_msm}": st_n["ms"], f"plain_ms_{n_msm}": st_n["plain_ms"],
        f"bound_ms_{n_msm}": st_n["bound_ms"]}

    args4, _ = V.prologue(pub5, sig5, blk5, window=4)
    V.verify_w4(*args4)                                # warm
    w4_ms = cuda_ms(lambda: V.verify_w4(*args4), KERNEL_REPS)
    plain = {}
    w4_plain_ms = cuda_ms(lambda: plain.setdefault(
        "ok", V.verify_plain(*args4, window=4)), 1)
    m, er = compare(V.verify_w4(*args4), plain["ok"])
    if m or not bool((plain["ok"] > 0).all()):
        raise AssertionError(f"window-4 kernel != plain on {m} lanes, or an "
                             f"honest lane failed")
    w4_bound, w4_by = bound(V.INT32_OPS_PER_LANE_W4 * n_msm,
                            V.BYTES_PER_LANE_W4 * n_msm)
    log(f"[verify w4] B={n_msm}: kernel {w4_ms:.3f} ms, plain "
        f"{w4_plain_ms:.3f} ms, bound {w4_bound:.3f} ms "
        f"({V.INT32_OPS_PER_LANE_W4} int32 ops/lane at {bound.desc})")
    rows["ed25519_verify_w4"] = {
        "route": "cuda", "source": "agnes_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "agnes_tpu/crypto/pallas_verify.py:409 (signed5=False)",
        "launches": w4_launches, "max_abs_err": max(err_w4, er),
        "mismatches": mism_w4 + m, "ms": w4_ms, "plain_ms": w4_plain_ms,
        "bound_ms": w4_bound, "bound_by": w4_by, "library_ms": None,
        "lanes": n_msm}
    # -- phase 6: the BLS aggregate lane at full validator width ----------
    bls_n, bls_fix = bls_lane_phase()
    # phase 2c at the lane's row counts, then kernel ms per call:
    # sum over its row counts of launches x ms
    for n in sorted({r for k in bls_n.values() for h in k["rows"].values()
                     for r in h}):
        bls_fp.time_at(n)
    for name in ("bls_fp_mul", "bls_fp_reduce"):
        sh = bls_fp.shapes[name]
        est = {e: sum(k * sh[r]["ms"] for r, k in h.items())
               for e, h in bls_n[name]["rows"].items()}
        est_parent = ({e: sum(k * sh[r]["parent_ms"] for r, k in h.items())
                       for e, h in bls_n[name]["rows"].items()}
                      if bls_fp.parent else None)
        top = {e: sorted(h, key=lambda r: -h[r])[:2]
               for e, h in bls_n[name]["rows"].items()}
        log(f"[bls] {name} kernel ms per call (sum of launches x ms over its "
            f"row counts): " + ", ".join(f"{e} {v:.3f}"
                                         for e, v in est.items())
            + (" (parent " + ", ".join(f"{e} {v:.3f}" for e, v in
                                        est_parent.items()) + ")"
               if est_parent else "")
            + "; most-launched rows " + ", ".join(
                f"{e} {top[e]}" for e in top))
        keep = {BLS_REAL_ROWS, BLS_BIG_ROWS} | {r for t in top.values()
                                                 for r in t}
        real, big = sh[BLS_REAL_ROWS], sh[BLS_BIG_ROWS]
        rows[name] = {
            "route": "cuda", "source": "agnes_tpu_torch/csrc/bls_fp.cu",
            "replaces": ("agnes_tpu/crypto/pallas_field.py:162"
                         if name == "bls_fp_mul"
                         else "agnes_tpu/crypto/pallas_field.py:177"),
            "launches": bls_n[name]["total"],
            "max_abs_err": bls_fp.err[name],
            "mismatches": bls_fp.mism[name], "ms": real["ms"],
            "plain_ms": real["plain_ms"], "bound_ms": real["bound_ms"],
            "bound_by": real["bound_by"], "library_ms": None,
            "parent_ms": real["parent_ms"], "lanes": BLS_REAL_ROWS,
            "launches_per_bls_aggregate": bls_n[name]["bls_aggregate"],
            "launches_per_bls_pairing_product":
                bls_n[name]["bls_pairing_product"],
            f"ms_{BLS_BIG_ROWS}": big["ms"],
            f"plain_ms_{BLS_BIG_ROWS}": big["plain_ms"],
            f"bound_ms_{BLS_BIG_ROWS}": big["bound_ms"],
            f"parent_ms_{BLS_BIG_ROWS}": big["parent_ms"],
            "shapes": [sh[r] for r in sorted(keep)],
            "launches_by_rows": {e: {str(r): k for r, k in h.items()}
                                 for e, h in bls_n[name]["rows"].items()},
            "kernel_ms_per_call": est,
            "parent_kernel_ms_per_call": est_parent}
    # -- phase 7: checkpoint, resume and signed evidence ------------------
    rows["ed25519_verify_signed5"]["launches_checkpoint_phase"] = \
        checkpoint_phase(seeds, pubkeys, sigs)
    torch.cuda.empty_cache()

    # -- phase 8: the serve plane -------------------------------------------
    served, s_sigs, s_honest = serve_signed_phase(seeds, pubkeys, classes)
    serve_ref = served.pop("_ref")
    torch.cuda.empty_cache()
    dedup_launches = serve_dedup_phase(seeds, pubkeys, classes, s_sigs,
                                       s_honest)
    del s_honest
    torch.cuda.empty_cache()
    served["launches_serve_dedup"] = dedup_launches
    served["launches_serve_phase"] += dedup_launches
    rows["ed25519_verify_signed5"].update(served)
    for name, n in serve_bls_phase(bls_fix).items():
        rows[name]["launches_serve_phase"] = n
    del bls_fix
    torch.cuda.empty_cache()

    # -- phase 9: the host plane and the benchmark configs ----------------
    rows["ed25519_verify_signed5"].update(host_plane_phase(bound))
    torch.cuda.empty_cache()

    # -- phase 10: the C++ ingest loop -------------------------------------
    rows["ed25519_verify_signed5"].update(native_ingest_phase(
        seeds, pubkeys, sigs, phase3_rate, ns_row["north_star_votes_per_s"],
        north_decisions))
    torch.cuda.empty_cache()

    # -- phase 11: native admission and the threaded host ----------------
    rows["ed25519_verify_signed5"].update(native_serve_phase(
        seeds, pubkeys, s_sigs, serve_ref))
    torch.cuda.empty_cache()

    # -- phase 12: the dense signed step and the mesh --------------------
    rows["ed25519_verify_signed5"].update(dense_mesh_phase(
        seeds, pubkeys, sigs, lane_ref, north_decisions, s_sigs, serve_ref,
        bound))
    torch.cuda.empty_cache()

    # -- phase 13: the static pod and the elastic drill ------------------
    rows["ed25519_verify_signed5"].update(pod_phase(
        seeds, pubkeys, s_sigs, serve_ref, bound))
    del s_sigs, serve_ref
    torch.cuda.empty_cache()

    # -- phase 14: the model checkers' corpora ---------------------------
    rows["ed25519_verify_signed5"].update(checker_phase())

    # -- phase 15: the analyzers against what the card ran -----------------
    rows["ed25519_verify_signed5"].update(analysis_phase())

    # -- phase 16: the public surface on the card ------------------------
    rows["ed25519_verify_signed5"].update(surface_phase(seeds, pubkeys,
                                                        sigs))
    torch.cuda.empty_cache()

    # -- phase 17: the run configuration on the card ---------------------
    rows["ed25519_verify_signed5"].update(config_phase(
        seeds, pubkeys, sigs, classes, lane_ref))
    del lane_ref
    torch.cuda.empty_cache()
    log(f"[total] {time.perf_counter() - t_all:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    order = ("ed25519_verify_signed5", "ed25519_verify_w4", "fe25519_pow",
             "ed25519_straus", "bls_fp_mul", "bls_fp_reduce", "fe13_chain")
    for n, (src, fn) in {
            "ed25519_verify_signed5": (V.KERNEL, "ed25519_verify_kernelILi5E"),
            "ed25519_verify_w4": (V.KERNEL, "ed25519_verify_kernelILi4E"),
            "fe25519_pow": (F.POW_KERNEL, "fe_pow_kernel"),
            "ed25519_straus": (E.STRAUS_KERNEL, "ed25519_straus_kernel"),
            "bls_fp_mul": (BF.FP_KERNEL, "bls_fp_mul_kernel"),
            "bls_fp_reduce": (BF.FP_KERNEL, "bls_fp_reduce_kernel"),
            "fe13_chain": (MB.KERNEL, "fe13_chain_kernel")}.items():
        usage = {f: u for f, u in cuda_build.ptxas_usage(src).items()
                 if fn in f}
        if not usage or any(len(u) != 3 for u in usage.values()):
            raise AssertionError(f"no ptxas report for {fn} in {src}: {usage}")
        # several instances (the BLS kernels' group sizes): the largest
        # of each, and each instance's own
        rows[n].update({k: max(u[k] for u in usage.values())
                        for k in ("registers", "stack_bytes", "spill_bytes")})
        if len(usage) > 1:
            rows[n]["ptxas_by_function"] = usage
    print(json.dumps({"kernels": [dict(name=n, **rows[n]) for n in order]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
