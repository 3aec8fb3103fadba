"""Drive the PyTorch port's bulk Check and lookups on one NVIDIA card and
hold every CUDA kernel against its plain PyTorch version.

Run from the repository root:
python3 chip_smoke.py [--scale3 S] [--edges4 N] [--edges5 N] [--scale19 S]
                     [--scale20 S] [--scale22 S] [--phase22-only PARTS]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi);
2. build every kernel from csrc/ (one nvcc per source, in parallel);
3. each fused-probe mode (gate/until2/any/block) on packed and int32
   tables with expiry lanes, and ``runs`` on packed and int32 rev-style
   tables with one heavy bucket (cap >= 1024), absent and negative keys;
   then ``runs`` at its edges (runs_edge_tables): buckets of exactly 0,
   1, 7, 8 and 9 rows, a 5,000-row key, keys equal to a bucket's first
   and last row, between its rows, absent and negative, column 0 of 16
   and of 22 bits when packed, bucket pairs under two offset anchors,
   rows shuffled within buckets, each under its own cap, under cap = 4
   (three steps: the 7-row buckets resolve, the 8- and 9-row ones
   truncate) and cap = 2, logging the keys whose bisect truncated;
   kernel == plain version bit for bit;
3b. each fused_probe_aligned mode on bucket-aligned ladders of >= 3
   levels (cover (0.5, 0.9)): int32 and packed, one-key and two-key, an
   expiry lane with 0, expired and live rows, absent and negative keys,
   hits past level 0; kernel == plain version bit for bit;
3c. mode block of both kernels at the edges of its tile (the cooperative
   tile of csrc/probe_common.cuh): int32 and packed tables, one and two
   keys, W in {1, 3, 5, 16}, caps 1, 3, 8, 64 and one whose single lane
   passes the tile's shared-memory budget, B in {1, 255, 65,537}, bucket
   starts clamped at rows - cap, negative and absent keys; for the
   aligned kernel ladders (cap, 3, 1), (past the budget, 1), an 8-level
   ladder and phase 3b's build_aligned ladders; mode gate of both kernels
   (the same slot tile, one thread a slot): fused_probe's over
   off+interleave tables with W in {1, 3, 5, 16}, caps 1, 3, 8, 64 and
   2 * GATE_SLOTS + 3, bucket starts clamped at rows - cap and keys
   planted in the lanes' windows, the aligned kernel's over ladders (c,
   3, 1) for c in 1, 3, 8, 64, one lane longer than a tile, an 8-level
   ladder and phase 3b's ladders, keys planted past level 0, levels of
   one row and levels 2 bytes off alignment; B in {1, 255, 65,537}, one
   and two keys, negative and absent keys, an expiry column (the key, a
   delta, a dictionary, a range with zeros) and none; then one int32
   table of 2^29 rows x 5 columns (2.7e9 elements, filled on the card)
   per kernel, with lanes whose rows lie past element 2^31 (fused_probe
   under block, gate, until2 and any, the aligned one under block, gate,
   any and until2); kernel == plain version bit for bit; then mode gate of both kernels
   with the caveat-id and context planes (phase_gate_cav_edges): caveat
   and context columns under the codecs a build emits (ranges with a -1
   sentinel), a dictionary and a delta, int32 and packed, caveat 0 and
   not, context -1 and not, misses (0 and -1), with and without an
   expiry lane and the context plane, B in {1, 255, 65,537},
   off+interleave tables (build_hash's, and caps 1, 3, 8, 64 and 2 *
   GATE_SLOTS + 3 with clamped starts) and aligned ladders of 3, 8 and
   (one lane past a tile, 1) levels and build_aligned's; kernel == plain
   version bit for bit on every plane; then the reduced modes any and
   until2 of both kernels (the warp path up to 32 slots a lane, the
   shared-flag tile beyond; phase_until2_edges and
   phase_reduced_edges_aligned): columns 2 and 3 as ranges,
   dictionaries, deltas of column 0 and of column 1, and a delta of a
   delta, W 4 and 16, caps 1, 3, 4, 8, 31, 32, 33, 64 and 2 * GATE_SLOTS
   + 3 over off+interleave tables with clamped bucket starts, and ladders
   of one level of each of those caps, (c, 3, 1) for c in 1, 3, 8, 64,
   (28, 3, 1), (30, 3), (4, 0, 2) (a level of cap 0), an 8-level ladder,
   a lane past one tile and phase 3b's build_aligned ladders, keys
   planted past level 0; B in {1, 255, 65,537} (ragged last warps),
   int32 and packed, one and two keys, negative and absent keys, ``now``
   equal to a row value and one below it, lanes whose only hits fail
   both compares; kernel == plain version bit for bit, with tallies that
   fail the phase when an edge never occurs;
4. BASELINE config 2 (RBAC: 10k repos x 1k users x 100 teams x 10 orgs,
   seed 11) — a 100,000-check batch, kernels vs plain on all three
   planes, 2,000 sampled rows vs the host oracle; then the same with
   ``EngineConfig(flat_aligned=True)`` (4b), whose planes must also equal
   the off+interleave snapshot's;
5. BASELINE config 3 (nested-groups docs: 1M docs, 10M edges, seed 23)
   — the same checks (``--scale3`` cuts its size; 1.0 is full size),
   then lookups on the same prepared snapshot (benchmarks/
   bench8_lookup.py's subjects): LookupResources document#view for 48
   random users (seed 11) and for up to 6 bulk group#member subjects,
   LookupSubjects document:dX#view -> user for 16 random docs (seed 13).
   Candidate blocks of a kernels=False engine equal the kernel path's
   block for block (the fused K-hop program's, one CUDA-graph replay a
   lookup, where it serves; the looped path's where it overflows); full
   answers equal the host walker's (same exact filter) for every user,
   every doc and the heaviest bulk subject; then (phase_spmm) each of
   those lookups through the fused program and through the looped path
   on the same snapshot, timed, answers equal, the graph replay equal
   to the eager run of the same K rounds, replay and capture ms, the
   fallback share and its causes, the kernel launches a replay makes
   (the ``spmm:`` line), failing unless a multi-hop lookup of each
   direction was served by the fused program;
5b. config 3 again with ``flat_aligned=True`` on the same snapshot, at
   full size: prepare s, device MiB, the aligned tables and their caps
   and the point tables that stayed off+interleave; planes kernels vs
   plain and vs phase 5's planes; sampled rows vs the oracle; checks/s;
   the same lookups, candidate blocks kernels vs plain, answers equal to
   phase 5's (which equal the walker's), and phase_spmm on this layout
   (the subjects' arrow hop through fused_probe_aligned's block);
6. a closure-overflow world (closure_source_cap=4), every row vs the
   oracle, once off+interleave and once aligned (the aligned ``any`` and
   ``until2`` sites' traffic);
7. the client path on ``cuda``: write_schema, write, check_one/all/any
   under full and at_least consistency, lookup_resources /
   lookup_subjects and a cursor-paged walk, vs the oracle; then a
   caveated client world: a schema whose caveat no relationship uses,
   then string, int, timestamp and host-only caveats written through
   ``write``, ``check`` with and without ``caveat_context`` (a stored
   context that wins over the query's), the lookups, every answer vs the
   oracle; each once with the default configuration and once with
   ``with_engine_config(EngineConfig(flat_aligned=True))``.
8. (run between 5b and 6) BASELINE config 4 (multi-tenant SaaS with
   caveats, benchmarks/bench4_caveats.py's generator: the
   ``same_tenant`` caveat on every holder edge, 4,096 shared stored
   contexts, seed 31) at ``--edges4`` edges (10M by default; published
   100M, logged as ``reduced``): prepare s, device MiB and the caveat
   plan; 100,000 ``access`` checks (seed 3) with per-query request
   contexts through ``check_columns(q_ctx=, qctx_rows=)``, kernels vs
   plain on all three planes, no conditional row, 2,000 sampled rows vs
   the oracle with their contexts, checks/s; the same 100,000 queries on
   the ``holder`` relation (the direct-edge gate with its caveat
   planes); then all of it with ``flat_aligned=True`` on the same
   snapshot, planes equal to the off+interleave ones;

9. BASELINE config 5 (Watch-driven incremental re-index,
   benchmarks/bench5_watch.py's deployment: the repo/team schema, seed
   17, 100,000 users, 1,000 teams of 50 members, repos = edges / 20 with
   one team maintainer each) at ``--edges5`` edges (2.5M by default, to
   leave phases 19-22 room in the smoke's time; bench5's own default is 10M;
   one card's share of the published 1B on 16 chips is 62.5M,
   logged as ``reduced``), under both layouts on one snapshot chain: 20
   warm-up and 10 measured revisions of 1,000 fresh-user ``reader`` adds
   on repos r0-r999 (rng seed 5), each through ``apply_delta`` and
   ``prepare(snap, prev=...)``, and a freshness probe that must be
   definite at the new revision; mean materialize / overlay / probe ms,
   updates/s, incremental revisions, the fold's state, the ``dl_*`` MiB;
   then a 100,000-check batch on the chain's last snapshot (kernel
   launches per mode, kernels vs plain planes, 2,000 sampled rows vs the
   oracle, checks/s, the aligned planes equal to the off+interleave ones)
   and the same batch on a full prepare of that revision (its planes
   equal the chain's);
10. a mixed Watch chain under each layout: the feature world of
   tests/test_flat_engine.py scaled up (nested groups, a folder tree,
   caveated, expiring and wildcard readers, bans) through 28 revisions
   of direct adds and deletes of base rows, membership adds that advance
   the closure, userset grants and their tombstones (T-dirty voids),
   caveated adds, retargeted and fresh doc -> folder arrows, with small
   overlay floors so the chain crosses shape bands and reaches the
   compaction bail; at every revision the kernel planes equal the plain
   planes and a full prepare's, and definite rows agree with the oracle;
   then config 4's schema at 200,000 edges with 40 stored contexts and
   caveated adds of fresh contexts, re-encoded into the ``ectx_*``
   headroom until the bucket is outgrown (a full prepare), each revision
   checked with request contexts as in phase 8;
11. (run inside phase 5) config 3's write -> first check through the
   Client: the snapshot phase 5 prepared is the client's store head, and
   three writes (a doc viewer and a group member each) are each followed
   by 256 checks at ``at_least(revision)``; each must take the delta
   path (else the phase fails naming the radix and size), its answers
   agree with the oracle, and its latency prints beside the full
   prepare it replaces; then the first legacy batch on the last of
   those revisions (two permissions, ``flat_max_slots=1``), which builds
   its raw columns from that revision's snapshot: its ms, a second
   batch's, and the device MiB the revision's legacy cache holds;
   phase 14 follows, on the same client;
12. the legacy two-phase program (engine/legacy.py; plain PyTorch, it
   reaches no kernel), after phase 9: (a) config 2 and (b) config 3 on
   ``EngineConfig(use_flat=False)`` engines over the host snapshots of
   phases 4 and 5 (their prepares ship only the raw columns, seconds
   printed), the same 100,000-check batches: checks/s (median of 4
   calls), the overflow share, the definite plane equal to the flat
   path's on every row neither program flags, 2,000 sampled rows
   against the oracle, and no probe-kernel launch; every config 3 row
   overflows there (ROADMAP queue 3 item 8), so (b) also runs config 3
   with the nested-group edges its chains imply added until the
   membership columns fill their power-of-two length: the same answers,
   and at least 90% of the rows must be settled on the card at the deep
   caps and equal the flat path's; (c) config 2's batch
   on a flat engine with ``flat_max_slots=1`` (the batch asks for 2
   permissions) spills to the legacy program, planes equal to (a)'s;
   (d) a ``cuda`` Client on the feature world at phase 10's size: 3,000
   checks over all ten of FEATURE_SCHEMA's names against the oracle,
   ``delete_atomic`` of readers and bans and a write, the same batch at
   ``at_least(revision)`` on the delta-prepared snapshot, an
   ``updates_since_revision`` stream equal to the store's log,
   ``read_relationships`` under three filters against
   ``export_relationships``, and an export -> import round trip into a
   fresh client whose checks agree;
13. the latency path (engine/latency.py: the flat program replayed as a
   CUDA graph pinned per permission set, batch tier and context shape),
   after phase 12, on the snapshots phases 4, 5 and 8 prepared, tiers
   256/1,024/4,096: (a) at B = 1, 200, 256, 900, 1,100, 4,096 the replayed
   planes equal check_columns' kernel planes and the plain planes (config
   4's ``holder`` batch with request contexts too), B = 5,000 returns None
   and check_columns_latency answers it; (b) 500 warm dispatches a tier
   of jittered sizes on configs 2 and 3 under both layouts: no capture,
   p50/p99 ms of the total and of each stage beside the eager
   check_columns of every 5th batch; (c) the overflow world's expiring
   edges through one pin at three clocks, equal to the eager program's,
   the answers falling; (d) phase 10's chain, each revision's batch
   through its latency path (each revision's first dispatch timed, then
   a warm one; the revisions of one shape band share a pin, so a first
   dispatch captures only on a new band and otherwise copies the
   revision's tensors into the pin: the captures per revision are
   printed); (i) three writes on config 3 through the delta prepare,
   each then 256 checks through the new revision's latency path (cold:
   its first dispatch, a capture or a rebind; a revision that kept its
   band must capture nothing), again (warm), and eagerly;
   (f) 4 threads x 200 dispatches on one path;
   (g) a ``with_latency_mode()`` cuda client, 1,000 checks vs the oracle;
   (h) config 4's 100,000-check batch through check_columns_pipelined
   in sub-batches of 32,768, beside one check_columns call;
   block, gate (both layouts) and gate.cav must have launched inside a
   capture.  It prints one ``latency: {...}`` line before the kernel table.
14. (run inside phase 5, after phase 11, on the client that holds config
   3 at full size) the serving front end (serve/: ``with_serving``) under
   the reference bench's traffic (benchmarks/bench9_serve.py): (a) the
   closed-loop rate of pre-formed 4,096-check batches through
   check_columns_latency, and the quiet-window p50/p99 of 300 latency
   dispatches of one 1,024-check batch; then, the tiers pre-pinned and
   the handle warmed by a burst and a paced trickle, ONE submitter with
   Poisson arrivals, each submission 64 ``view`` checks sliced from a
   pool of 2^18 (docs uniform, users zipf 1.2) under one of 32 client
   ids, ``ServeConfig(hold_max_s=0.001)``, the garbage collector off in
   each step: (b) ``full()``, cache and dedup off, at 0.03, 0.1 and 0.2
   of (a) for 2 s each (the knee), then at 0.5, 0.8 and 0.9 for 4 s each:
   goodput, shed share, p50/p99 submit -> resolve ms, formed batches per
   submission, mean occupancy per tier; the step at 0.5 samples the
   serving threads' stacks (where their host time goes), 300 checks of
   the batches served at 0.9 are held against the host oracle at the
   revision each was served at; the headline is the goodput at the
   highest load whose p99 stays within 3x the quiet p99; (b') 32 client
   threads, each on its own clock, at 0.1 (not the reference bench's
   model); (b'') one submitter at 0.5 for 2 s with the interpreter's
   switch interval at 0.5 ms instead of 5; (c) ``min_latency()`` with the verdict cache and dedup at
   0.9: hit rate, dedup fraction, p99, and 50 sampled submissions
   (cache-served answers included) against the host oracle; (e) no
   capture across (b) and (c); (d) three writes (a viewer and a group
   member) under (b)'s handle at 0.5, and three more at 0.1, each then
   an ``at_least`` handle answering True on the viewer it granted; every
   batch is logged with its revision, and 300 served checks of each
   revision are held against the oracle at that revision: captures per
   write (0 for a revision that kept its band, else the phase fails),
   the first batch served at each new revision and the other batches'
   p50 ms; last, the engine's pins, bands, private MiB and graph pool
   MiB, and again once the client is gone.  It prints one
   ``serving: {...}`` line after the ``latency:`` line.
15. decision provenance (the armed flat program, ``witness=True``, and
   engine/explain.py), in two parts: after phase 14, on its client and
   on config 3's full prepare, and after phase 12, on the worlds phase
   13 reuses.  (a) The 100,000-check batch of config 3 (its full
   prepare, the client's head revision, and aligned), of config 2 under
   both layouts and config 4's ``holder`` batch with request contexts
   under both: ``witness_codes_columns`` with the kernels equal to the
   plain twins bit for bit, the armed planes equal to the disarmed
   program's, a code exactly on the rows the card settles as allowed,
   the code histogram, the armed program's own launches per mode (equal
   to the disarmed program's), and armed against disarmed batch ms
   (median of 4, alternating); (b) 256 sampled config 3 rows, half of
   them rows the card allows, through ``Client.explain`` at the head: each
   tree's verdict equals the check's and holds the card's witness
   (``witness_consistent``), explain p50/p99 ms; (c) ``arm_witness`` on
   the head's latency path at tier 1,024: ``last_witness`` equals the
   eager codes (kernels and plain) on 20 batches, one capture for the
   armed key and no disarmed pin evicted, then 1,000 armed and 1,000
   disarmed dispatches alternating with no recapture (replay and total
   p50 of each), then a write that keeps the band: its first armed
   dispatch rebinds and captures nothing, and disarming replays the old
   pins with no capture; (d) ``ServingHandle.check(explain=True)`` of 64
   rows on phase 14's client: verdicts equal a plain handle check's,
   trees agree and hold their witness; (e) a host-only client
   (``with_host_only_evaluation``) with config 2's relationships and a
   ``cuda`` client over its store (``with_store``): 2,000 checks, a
   LookupResources, a LookupSubjects and a paged walk equal, no launch
   counted on the host-only client; (f) ``explain.witness_errors`` is
   0.  It prints one ``witness: {...}`` line after the ``serving:``
   line; the phase's launches are its own (zeroed before, the main
   path's restored after).
16. the operations layer (utils/trace.py's flight recorder, utils/slo.py,
   utils/telemetry.py, utils/perf.py's report and roofline meter,
   ``with_profiling``, store/group.py), after phase 15's client part, on
   the store of the client phases 11, 14 and 15 hold at config 3 full
   size: a client built with ``with_store``, ``with_telemetry(port=0,
   incident_dir=...)``, ``with_profiling``, ``with_group_commit(
   GroupCommitConfig(max_group=256, hold_max_s=0.002))``, a breaker
   threshold of 2 and a 1% decision log, handed the prepared head (no
   second prepare); its profile directory is set for (c) only, and its
   latency mode toggled per step.  (a) 20 batches of 4,096 checks, half
   eager and half on the latency path, answers equal the plain client's;
   then every endpoint over HTTP: ``/metrics`` in both formats (the
   ``checks.dispatch`` count grew by the batches sent), ``/perf?bench=1``
   (``measure_bandwidth`` on the card, printed beside 3.35 TB/s; the
   phase fails past 105% of it), ``/perf?compile=1`` (every cost entry
   realized as unavailable), the bytes model and the kernels' per-check
   bytes, ``/slo``, ``/healthz`` (ok), ``/traces`` and ``/decisions``;
   (b) faults on ``latency.dispatch`` until the breaker trips: one bundle
   in the incident dir naming ``breaker.trip``, holding the failing
   dispatches' traces, the admission and perf context and the decision
   tail, served identically at ``/debug/incidents/<id>``; after
   ``faults.reset()`` and the cooldown a latency probe closes the breaker;
   (c) two profiled batches of the 100,000 checks: one torch.profiler
   trace each, from which the device busy share of the dispatch window
   (the union of kernel, memcpy and memset intervals over the
   ``gochugaru:`` range), the 10 device operations with the most time and
   the probe kernels' launches (equal to the wrappers' counts, ``block``
   among them); ``checks.device_time_s`` counted 2; (d) 64 threads x 4
   transactions (a viewer or a member touch, seeded) through the
   committer: 256 unique tokens, dense within each group (one log entry a
   group), fewer groups than a quarter of the writes; then 256 checks at
   ``at_least`` the last token on the delta-prepared revision (else the
   phase fails naming the radix and size) equal to the oracle;
   transactions/s, group sizes and write -> first check ms beside phase
   11's direct writes; (e) phase 12 (d)'s feature world through a
   ``cuda`` client with group commit and ``lsm_compact_min=256``: rounds
   of 64 grouped writes, each followed by a check, until
   ``ChainCompactor.poll_once()`` merges the chain
   (``store.bg_compactions`` >= 1), then a write and its 3,000 checks
   against the oracle, and whether that revision's prepare was a delta;
   (f) the 100,000-check batch (``check``, once a side: its host lowering
   takes seconds) and 1,000 tier-1,024 latency dispatches (a serving
   handle's ``check_columns`` with no hold-back, 500 a client in 2
   rounds) through this client (tracer, recorder and SLO engine
   installed) and phase 15's plain client (tracer and recorder removed),
   alternating, their answers equal: medians (no claim).  It prints one ``telemetry: {...}`` line
   after the ``witness:`` line; its launches are its own.
17. (after phase 13) the tuner (tune/) on BASELINE config 2, rebuilt by
   the same generator into the store of a ``cuda`` client with latency
   mode and the verdict cache: (1) the tuner's mixed load
   (benchmarks/bench11_tune.py's profile: interactive submissions of 9
   checks on a Poisson clock, users zipf 1.2; bulk CheckMany of 300; a
   duplicate-heavy round) through a serving handle under the defaults,
   200 of each profile's answers vs the host oracle; (2)
   ``collect_snapshot`` with the engine, serve and cache configs, the
   cost model, the prepared snapshot and the packed/unpacked byte models
   of a dual prepare, its placement budget between the tables' bytes and
   the card's memory; (3) ``propose`` (printed as a ``tune diff:`` JSON
   line), ``apply_diff``, the tuned client on the same store and the same
   schedules, the measured pad waste of both arms beside the predicted
   one; (4) the ladder (192, 576, 1344) on both layouts whatever the
   tuner proposed: 300 jittered dispatches a tier, one capture per
   (permissions, tier), no recapture, replayed planes == check_columns'
   kernel planes == the plain planes (each key's first dispatch and
   every 5th), >= 2,000 sampled rows vs the oracle, ``block`` and
   ``gate`` (``aligned.`` on the aligned layout) inside the captures;
   (5) diffs setting ``kernels`` False then True: equal planes, launches
   only under True; (6) an ``OnlineController`` on a live handle behind
   ``TelemetryServer(controller=...)``: 6 ticks under load, every move
   within its bounds, ``/tune`` enabled, ``revert()`` restores the
   preset.  Prints one ``tune: {...}`` line.
18. (after phase 17) the fleet (fleet/) on config 2 written into a
   ``FleetRouter``'s store: (1) one, then two in-process ``Replica``s
   with ``cuda`` clients (verdict cache, latency mode) bootstrapped over
   the wire (seconds), 4 router callers for 2 s with each (checks/s,
   per-call p50/p99 ms on the host clock, no claim; every answer vs the
   oracle); (2) 2,000 checks under ``full``, ``at_least`` a zookie and
   ``min_latency`` after a quiesce, equal to the oracle at the head; (3)
   40 single-edge toggles written through the router while the 4 callers
   check, each read back through its zookie (stale answers: 0), full and
   delta prepares and captures per replica; (4) ``replica.kill`` armed
   mid-traffic: every in-window call answered once and right, the dead
   replica evicted, a fresh one bootstrapped and rejoined; (5) a
   group-committed write applied as one entry by each replica.  Fails on
   any capture failure, breaker trip or latency reroute.  Prints one
   ``fleet: {...}`` line.  Phases 17 and 18 each run with the counts set
   to 0 just before and read just after (added back afterwards).

19. the scattered layout (``EngineConfig(flat_blockslice=False)``: bucket
   offsets, a row permutation and full-width int32 columns, probed by
   plain gathers; no fold, no reverse index, no packing, no delta level):
   (a) after phase 4b, config 2 on the snapshot that phase prepared, and
   (b) after phase 5b, config 3 at ``--scale19`` (0.1 by default: 100,000
   docs, 1M edges, to leave phase 20 room in the smoke's time; its own
   snapshot, first checked off+interleave as phase 5 does): prepare s,
   device MiB, kernels vs plain planes (equal bit for bit), 2,000 sampled rows
   vs the oracle, checks/s beside the blockslice layout's, the overflow
   share, every row both layouts settle equal to the blockslice planes
   (and how many only one settles), each with the launch counts set to 0
   just before and read just after: none may launch, as the program has
   no probe-kernel site; (c) after phase 18, a ``with_latency_mode()``
   client with the layout, config 2 imported into its store: ``check``
   of 2,000 rows and ``check_all`` against the oracle, lookups on the
   walker against the oracle, ``explain`` trees holding the card's
   witness codes, pins at tiers 256 and 1,024 with 500 warm dispatches
   each and no recapture (p50/p99), then a write and a check that reads
   it through a full prepare.  Prints one ``scattered: {...}`` line
   after the ``fleet:`` line.

20. the model-sharded mesh (``parallel/``: ``ShardedEngine`` over
   ``make_mesh(data, model, devices=[cuda:0] * n)``, every shard on the
   one card, ``kernels=True``): (a) config 3 on 1 × 4 at ``--scale20``
   (0.1 by default, after phase 19 on its world: 100,000 docs, 1M edges,
   to leave phase 22 room in the smoke's time; 1.0 runs it, and phase 21
   (a), after phase 5's lookups on phase 5's snapshot), and (b) after
   phase 19, config 2 on
   2 × 2 and on 1 × 3 (a model size of 3: the sharded legacy program),
   each with the launch counts set to 0 just before its batch and read
   just after (the sharded probes are plain gathers: none may launch):
   the 100,000-check batch through ``check_columns``, its planes equal
   to the blockslice planes bit for bit (the legacy program: every row
   both settle equal), host rows settled by the oracle and 2,000 sampled
   verdicts against it; prepare s split into the partition-first build
   and the placement, MiB a shard (sharded, replicated) and on the card,
   checks/s beside the blockslice engine's, the collectives of a batch
   and their host ms; (c) a ``with_mesh`` client on 2 × 2 with config 2
   in its store: 2,000 checks against the oracle, a write and a check
   that reads it through the sharded delta prepare (the base tables
   kept, its planes equal to a full prepare of the tip), lookups over
   the sharded hops equal to an unsharded engine's looped answers, no
   probe kernel launched.  Prints one ``mesh: {...}`` line after the
   ``scattered:`` line.

21. the partitioned serve and the multi-process mesh (``ShardedEngine.
   prepare_snapshot_partitioned``: engine/partition.py ``partition_feed``
   with serve="routed", the primary / fold point / T tables split along
   the model axis and the rest whole on every position; every shard on
   ``cuda:0``, ``kernels=True``), each part with the launch counts set to
   0 just before it and read just after (the partitioned probes are
   plain gathers: none may launch): (a) right after phase 20 (a), config
   3 on 1 × 4 on phase 20 (a)'s world (``--scale20``): the 100,000-check
   batch, its planes equal to the world's blockslice planes bit for bit, the path that
   served it (routed, or the psum fallback where a slot is not
   routable), 2,000 sampled verdicts against the oracle, prepare s (the
   feed, then the placement), MiB a position (the split tables against
   the whole ones) and on the card, checks/s beside the blockslice
   engine's and phase 20's, ``dispatch.route_s``; (b) after phase 20 (c), config 2's batch
   of folded ``read``/``admin`` rows on 1 × 4 (routed), on 1 × 4 with
   ``flat_fold=False`` (the permissions walked: not routable, so it falls
   back to the psum path) and on 2 × 2 (the psum path: two data rows
   never route), planes equal to phase 4's each time; (c) a
   ``with_mesh(partitioned=True)`` client on 1 × 4 with config 2: 2,000
   checks against the oracle, a write and a check that reads it through
   the delta prepare (the fold stays armed, planes equal to a full
   partitioned prepare of the tip), lookups on the host walker against
   the oracle, 256 checks through ``with_serving()``; (d) two processes
   on the card (parallel/multihost.py ``dryrun_multihost``, gloo, both on
   ``cuda:0``): the 2 × 2 dryrun, then a 1 × 4 mesh whose model row spans
   both processes, built from ``partition_feed(owned=
   owned_model_shards(mesh))``, a psum batch with ``fetch=False`` held
   row by row to the oracle in each process, with its cross-process
   collectives and their host ms (and the legacy program's batch, whose
   all-gathers cross the processes); then the same spanning 1 × 4 mesh
   under load: two processes of this script (``--part-worker``) each
   build config 2 at full size, prepare only their owned shards through
   ``partition_feed(owned=owned_model_shards(mesh))`` and run the
   100,000-check batch with ``fetch=False``, planes equal to phase 4's
   bit for bit, with the collectives of a batch: calls, host ms, bytes,
   and the cross-process all-reduces' bytes and ms.  Prints one
   ``part: {...}`` line after the ``mesh:`` line.

22. the operator entry points (``gochugaru_tpu_torch/scripts/``) as
   processes on the card, after phase 21, each child started by
   ``scripts/procs.py`` (output to a file, every wait timed, killed on
   the way out): (a) BASELINE config 2 in a ``FleetRouter``'s store in
   this process, served by ``fleetd replica --device cuda --latency-mode
   --join`` processes: one, then three (the other two started together):
   spawn -> bootstrapped and -> joined seconds a process, the bootstrap's
   export stream / import / materialize seconds, phase 18's callers and
   query mix for 2 s with one and with three (checks/s, per-call p50/p99,
   every answer once and equal to the host oracle), beside phase 18's
   in-process numbers; 40 toggles under load read back by zookie (0
   stale); a seeded SIGKILL of one process mid-load (every answer in the
   window right, the ring evicts it, ``fleet.kill_detections`` bumps,
   the window's p99); the card's free memory before the spawn, with
   three up and after the kill (it must come back); a restarted process
   that bootstraps, rejoins and answers; SIGINT to the survivors, each
   printing ``REPLICA-EXIT`` with device ``cuda`` and probe launches
   (``block`` and ``gate`` among them); (b) ``fleetd router
   --demo-world`` and one ``fleetd replica --join`` process, every (doc,
   user) pair through the router's wire ``check`` op against a host
   oracle; (c) config 3 at ``--scale22`` (0.1 by default) in a router's
   store, bootstrapped over the wire by one replica process: export
   stream, import, materialize and first prepare seconds, the process's
   peak RSS (VmRSS sampled every 50 ms), a 4,096-check sample against
   the host oracle; (d)
   ``telemetryd --device cuda --checks 32``: /healthz, the checks counter
   and dispatch p99 in /metrics, /traces, /slo, /debug/incidents, and
   /perf?bench=1 naming the card; (e) ``tune --json --online 6`` at config
   2's repos and users: a diff with evidence on every knob, its JSON round
   trip, the fixed point, >= 1 controller move and the revert; (f)
   ``profile_prepare --edges 1000000``: stage timers and top frames;
   (b), (d), (e) and (f) run side by side, after (a) and (c).
   This process launches no kernel in the phase (its counts set to 0
   before and restored after).  ``--phase22-only PARTS`` builds the
   kernels and runs only those parts.  Prints one ``procs: {...}`` line
   after the ``part:`` line.

Phases 4-8 are the main path: launch counts are zeroed before phase 4
and read after phase 7, and every mode of both kernels, and the gate
with its caveat planes (``gate.cav``) of both, must have launched.
Phases 9-11 are the delta chain's own paths (10, then 9, after the
main path): each runs with the counts
set to 0 just before it and read just after (phase 11's are added back
to the main path's), and each kernel of its layout must have launched.
Phase 12 runs each of its parts with the counts set to 0 just before it
and read just after, and (a)-(c) must launch no kernel; phases 13 and 14
run with the counts set to 0 just before each and read just after (a
kernel inside a CUDA graph counts at capture, never per replay; phase
14's counts are not added to the main path's, and its calls are not
candidates for the kernel table's shapes).  Then
each mode is timed at the largest shape the main path gave it, ``runs``
also at its largest-cap call (the row's ``deep_bucket``) and each
aligned mode also at its call with the most levels (the row's
``deep_levels``); the two ``block`` rows also under each tile budget of
TILE_SWEEP (the row's ``tile_budgets``: budget bytes -> ms, each output
equal to the plain version's), beside one ``fill_`` of their output's
size (``fill_ms``: the card's write rate), the ``gate`` rows of both
kernels under each of GATE_SWEEP's slots a CTA, and each reduced row
that runs the shared-flag tile under each of REDUCE_SWEEP's (the rows'
``tile_slots``); each reduced row of at most 32 slots a lane is also
timed on both paths (``paths``: the warp path and the shared-flag tile).
Each row names the kernel it ran (``path``: ``warp``, ``tile`` or
``lane``) and carries ``lanes_total`` (the lanes its main-path launches
processed).
The second to last lines are the kernel table as JSON and the card line;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime as dt
import gc
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

EPOCH = 1_700_000_000_000_000
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12  # non-tensor 32-bit rate, H100 SXM data sheet
REPLACES = "gochugaru_tpu/engine/pallas.py:246"
#: the runs mode's own tail in the TPU kernel (pallas.py:364-400)
REPLACES_RUNS = "gochugaru_tpu/engine/pallas.py:364"
REPLACES_ALIGNED = "gochugaru_tpu/engine/pallas.py:444"
#: the gate's caveat and context lanes in each TPU kernel
REPLACES_CAV = "gochugaru_tpu/engine/pallas.py:355"
REPLACES_ALIGNED_CAV = "gochugaru_tpu/engine/pallas.py:551"
SOURCE = "gochugaru_tpu_torch/csrc/fused_probe.cu"
SOURCE_ALIGNED = "gochugaru_tpu_torch/csrc/fused_probe_aligned.cu"
ALIGNED = {"flat_aligned": True}
#: the device every phase runs on (a CPU rehearsal of phases 4-7 may set
#: it to "cpu": the engine then takes the plain PyTorch path)
DEV = "cuda"


#: the smoke's start, for the seconds each log line carries
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel capture: the largest call of each mode on the main path
# ---------------------------------------------------------------------------


def _lanes(q_cols) -> int:
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    return int(np.prod(shape)) if len(shape) else 1


class Capture:
    """Wraps kernels.fused_probe and kernels.fused_probe_aligned to keep,
    per mode, the arguments of the largest kernel call by lanes (for
    timing at main-path shapes; aligned modes under ``aligned.<mode>``),
    for ``runs`` also those of its largest-cap call (``runs.deep``: the
    deepest bisect), and for each aligned mode those of its call with the
    most levels (``aligned.<mode>.deep``: the longest per-level loop)."""

    def __init__(self, K):
        self.K = K
        self.orig = K.fused_probe
        self.orig_aligned = K.fused_probe_aligned
        self.best = {}

    def _keep(self, ranks, args):
        for key, rank in ranks.items():
            if rank > self.best.get(key, ((0,),))[0]:
                self.best[key] = (rank,) + args

    def __enter__(self):
        def wrapped(q_cols, off, tbl, **kw):
            if not kw.get("plain") and tbl.is_cuda:
                n = _lanes(q_cols)
                mode = _count_key(kw)
                ranks = {mode: (n,)}
                if mode == "runs":
                    ranks["runs.deep"] = (kw["cap"], n)
                self._keep(ranks, (q_cols, off, tbl, dict(kw)))
            return self.orig(q_cols, off, tbl, **kw)

        def wrapped_aligned(q_cols, tbls, caps, sw, **kw):
            if not kw.get("plain") and tbls[0].is_cuda:
                mode = _count_key(kw)
                n = _lanes(q_cols)
                self._keep({f"aligned.{mode}": (n,),
                            f"aligned.{mode}.deep": (len(tbls), n)},
                           (q_cols, tbls, caps, sw, dict(kw)))
            return self.orig_aligned(q_cols, tbls, caps, sw, **kw)

        self.wrapped, self.wrapped_aligned = wrapped, wrapped_aligned
        self.K.fused_probe = wrapped
        self.K.fused_probe_aligned = wrapped_aligned
        return self

    def __exit__(self, *exc):
        self.K.fused_probe = self.orig
        self.K.fused_probe_aligned = self.orig_aligned
        return False


def _count_key(kw) -> str:
    """The launch-count key of a probe call: its mode, or ``gate.cav``
    for a gate that returns the caveat planes."""
    if kw.get("cav_lane") is not None:
        return "gate.cav"
    return kw.get("mode", "block")


def _gate_out_bytes(kw) -> int:
    """Output bytes a gate slot writes: the hit and live bytes, and 4
    for each int32 caveat plane."""
    return 2 + 4 * ((kw.get("cav_lane") is not None) + (kw.get("ctx_lane") is not None))


def W_of(spec, width) -> int:
    """Logical columns of a probe's rows: the spec's, else the table's."""
    return int(spec[0]) if spec is not None else int(width)


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


def time_call(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls (CUDA
    events).  A device-side sleep queued first keeps the card busy while
    the host enqueues every call, so the events time the calls' device
    work back to back, not the host's Python between launches."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def probe_bound(q_cols, off, tbl, kw):
    """(bound_ms, bound_by) for one probe call: the bytes this call's
    data needs (distinct table rows and offsets touched, queries read
    once, outputs written once) over HBM bandwidth, against its integer
    operations over the 32-bit rate."""
    from gochugaru_tpu_torch.engine.hash import bucket_of

    cap, mode = kw["cap"], kw.get("mode", "block")
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    qs = [c.expand(shape).reshape(-1) for c in q_cols]
    B = qs[0].shape[0]
    h = bucket_of(qs, int(off.shape[0]) - 1)
    if kw.get("off_a") is not None:
        start = kw["off_a"][h >> kw["ashift"]].long() + (off[h].long() & 0xFFFF)
        n_anchor = int(torch.unique(h >> kw["ashift"]).numel())
    else:
        start = off[h].long()
        n_anchor = 0
    s = start.clamp(0, int(tbl.shape[0]) - cap)
    rows = torch.unique((s.unsqueeze(-1) + torch.arange(cap, device=s.device)).reshape(-1))
    row_bytes = int(tbl.shape[1]) * tbl.element_size()
    W = W_of(kw.get("spec"), tbl.shape[1])
    out_bytes = {"block": B * cap * W * 4, "any": B, "until2": 2 * B,
                 "gate": _gate_out_bytes(kw) * B * cap}[mode]
    nbytes = (int(rows.numel()) * row_bytes
              + int(torch.unique(h).numel()) * off.element_size()
              + n_anchor * 4 + B * len(qs) * 4 + out_bytes)
    # per lane: ~12 hash ops, 4 offset ops, per row ~6 decode ops a column
    # plus 4 compare/fold ops
    ops = B * (16 + cap * (6 * W + 4))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def runs_bound(q_cols, off, tbl, kw):
    """(bound_ms, bound_by) for one runs call: the distinct 32-byte
    sectors this call's data needs, each counted once — the offset (and,
    when packed, anchor) sectors of every live key's bucket ends, and the
    column-0 bytes of every row its two bisects read (traced by the plain
    twin on the same inputs) — plus keys read and (lo, ln) written once,
    over HBM bandwidth; against ~20 integer operations per live key and
    ~8 per bisect step over the 32-bit rate."""
    from gochugaru_tpu_torch.engine.hash import bucket_of
    from gochugaru_tpu_torch.engine.kernels.plain import field0_spec, runs_plain

    keys = q_cols[0].reshape(-1).to(torch.int32)
    B = int(keys.numel())
    spec, off_a = kw.get("spec"), kw.get("off_a")
    rows_read = []
    runs_plain(keys, off, tbl, cap=kw["cap"], spec=spec, off_a=off_a,
               ashift=kw.get("ashift"), rows_read=rows_read)
    rows = torch.cat(rows_read).long()
    wide = spec is not None and field0_spec(spec)[0] > 16
    col0_bytes = tbl.element_size() * (2 if wide else 1)
    at = rows * (int(tbl.shape[1]) * tbl.element_size())
    sectors = int(torch.unique(torch.cat([at >> 5, (at + col0_bytes - 1) >> 5])).numel())
    live = keys >= 0
    h = bucket_of([keys[live]], int(off.shape[0]) - 1).long()
    ends = torch.cat([h, h + 1])
    sectors += int(torch.unique((ends * off.element_size()) >> 5).numel())
    if off_a is not None:
        sectors += int(torch.unique(((ends >> kw["ashift"]) * off_a.element_size()) >> 5).numel())
    nbytes = sectors * 32 + B * 4 + B * 8
    ops = int(live.sum()) * 20 + int(rows.numel()) * 8
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def aligned_bound(q_cols, tbls, caps, sw, kw):
    """(bound_ms, bound_by) for one aligned probe call: the distinct
    (level, bucket) rows this call's data reads, each row's bytes once,
    queries read once, outputs written once, over HBM bandwidth; against
    its integer operations over the 32-bit rate."""
    from gochugaru_tpu_torch.engine.hash import _level_salt, bucket_of

    mode = kw.get("mode", "block")
    shape = torch.broadcast_shapes(*[tuple(c.shape) for c in q_cols])
    qs = [c.expand(shape).reshape(-1) for c in q_cols]
    B = qs[0].shape[0]
    capT = int(sum(caps))
    W = W_of(kw.get("spec"), sw)
    nbytes = B * len(qs) * 4 + {"block": B * capT * W * 4, "any": B,
                                "until2": 2 * B,
                                "gate": _gate_out_bytes(kw) * B * capT}[mode]
    for lvl, t in enumerate(tbls):
        salted = [qs[0] ^ int(_level_salt(lvl))] + qs[1:]
        h = bucket_of(salted, int(t.shape[0]))
        nbytes += int(torch.unique(h).numel()) * int(t.shape[1]) * t.element_size()
    # per lane and level ~12 hash ops, per slot ~6 decode ops a column
    # plus 4 compare/fold ops
    ops = B * (12 * len(tbls) + capT * (6 * W + 4))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# worlds (port imports only)
# ---------------------------------------------------------------------------

RBAC_SCHEMA = """
definition user {}
definition team { relation member: user }
definition org {
    relation admin: user
    relation member: user | team#member
}
definition repo {
    relation org: org
    relation maintainer: user | team#member
    relation reader: user
    permission admin = org->admin + maintainer
    permission read = reader + admin + org->member
}
"""


def build_rbac(n_repos=10_000, n_users=1_000, n_teams=100, n_orgs=10, seed=11,
               store=None):
    """BASELINE config 2, the generator of bench.py:57-126.  With ``store``
    the relationships go into that store (its interner, one pre-interned
    columnar import a (relation, subject relation) pair) and the snapshot
    is the store's head."""
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns

    cs = compile_schema(parse_schema(RBAC_SCHEMA))
    if store is not None:
        store.write_schema(RBAC_SCHEMA)
        interner = store.interner
    else:
        interner = Interner()
    rng = np.random.default_rng(seed)
    users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
    teams = np.array([interner.node("team", f"t{i}") for i in range(n_teams)], np.int64)
    orgs = np.array([interner.node("org", f"o{i}") for i in range(n_orgs)], np.int64)
    repos = np.array([interner.node("repo", f"r{i}") for i in range(n_repos)], np.int64)
    slot = cs.slot_of_name
    member, admin, org_rel = slot["member"], slot["admin"], slot["org"]
    maintainer, reader = slot["maintainer"], slot["reader"]
    res, rel_s, subj, srel = [], [], [], []

    def add(r, rl, s, sr):
        res.append(r); rel_s.append(rl); subj.append(s); srel.append(sr)

    per_team = max(2, n_users // 10)
    for t in teams:
        for u in rng.choice(users, per_team, replace=False):
            add(t, member, u, -1)
    for o in orgs:
        add(o, admin, rng.choice(users), -1)
        for t in rng.choice(teams, 2, replace=False):
            add(o, member, t, member)
        for u in rng.choice(users, 5, replace=False):
            add(o, member, u, -1)
    repo_orgs = rng.choice(orgs, n_repos)
    repo_teams = rng.choice(teams, n_repos)
    res.extend(repos); rel_s.extend([org_rel] * n_repos)
    subj.extend(repo_orgs); srel.extend([-1] * n_repos)
    res.extend(repos); rel_s.extend([maintainer] * n_repos)
    subj.extend(repo_teams); srel.extend([member] * n_repos)
    for _ in range(2):
        res.extend(repos); rel_s.extend([reader] * n_repos)
        subj.extend(rng.choice(users, n_repos)); srel.extend([-1] * n_repos)
    if store is not None:
        from gochugaru_tpu_torch import consistency

        name = {v: k for k, v in slot.items()}
        cols = np.stack([np.asarray(c, np.int64) for c in (res, rel_s, subj, srel)])
        for rl, sr in sorted({(int(a), int(b)) for a, b in zip(cols[1], cols[3])}):
            pick = (cols[1] == rl) & (cols[3] == sr)
            store.import_interned_columns(
                resource_ids=cols[0][pick], resource_relation=name[rl],
                subject_ids=cols[2][pick],
                subject_relation=name[sr] if sr >= 0 else "",
                touch=True,  # the generator draws repeated pairs
            )
        snap = store.snapshot_for(consistency.full())
        cs = snap.compiled
        slot = cs.slot_of_name
    else:
        snap = build_snapshot_from_columns(
            1, cs, interner,
            res=np.asarray(res, np.int64), rel=np.asarray(rel_s, np.int64),
            subj=np.asarray(subj, np.int64), srel=np.asarray(srel, np.int64),
            epoch_us=EPOCH,
        )
    # the batch: bench.py's seed-5 draw
    qrng = np.random.default_rng(5)
    B = 100_000
    ri = qrng.integers(0, n_repos, B)
    perm = qrng.choice(np.array(["read", "admin"]), B)
    ui = qrng.integers(0, n_users, B)
    q = (repos[ri].astype(np.int32),
         np.array([slot[p] for p in perm], np.int32),
         users[ui].astype(np.int32))
    names = [("repo", f"r{a}", p, "user", f"u{b}") for a, p, b in zip(ri, perm, ui)]
    return cs, snap, q, names


DOCS_SCHEMA = """
definition user {}
definition group { relation member: user | group#member }
definition folder {
    relation parent: folder
    relation viewer: user | group#member
    permission view = viewer + parent->view
}
definition document {
    relation folder: folder
    relation viewer: user | group#member
    permission view = viewer + folder->view
}
"""


def docs_sizes(scale):
    """(users, groups, folders, docs) of config 3 at ``scale``."""
    return (max(int(100_000 * scale), 100), max(int(10_000 * scale), 20),
            max(int(50_000 * scale), 50), max(int(1_000_000 * scale), 1_000))


def build_docs(scale=1.0, seed=23, client=None, fill_nested=False):
    """BASELINE config 3, the generator of benchmarks/bench3_docs.py:51-137.
    With ``client`` the relationships go into that client's store (its
    interner, one pre-interned columnar import a relation) and the
    snapshot is the store's head.  With ``fill_nested`` the world also
    holds nested-group edges its chains already imply (``g[i] <-
    g[j]#member``, ``i + 2 <= j`` in one chain of five), as many as fill
    the membership columns to their power-of-two length: the answers are
    config 3's, and the legacy closure hop no longer flags every row
    (the padding fault, ROADMAP queue 3 item 8)."""
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns

    n_users, n_groups, n_folders, n_docs = docs_sizes(scale)
    cs = compile_schema(parse_schema(DOCS_SCHEMA))
    if client is not None:
        from gochugaru_tpu_torch.utils.context import background

        client.write_schema(background(), DOCS_SCHEMA)
        interner = client.store.interner
    else:
        interner = Interner()
    rng = np.random.default_rng(seed)

    def nodes(t, prefix, n):
        ids = [f"{prefix}{i}" for i in range(n)]
        if hasattr(interner, "node_batch"):
            return interner.node_batch(t, ids).astype(np.int64)
        return np.array([interner.node(t, i) for i in ids], np.int64)

    users = nodes("user", "u", n_users)
    groups = nodes("group", "g", n_groups)
    folders = nodes("folder", "f", n_folders)
    docs = nodes("document", "d", n_docs)
    slot = cs.slot_of_name
    member, parent, viewer, folder_rel = (
        slot["member"], slot["parent"], slot["viewer"], slot["folder"])
    res, rel, subj, srel = [], [], [], []

    def bulk(r, rl, s, sr):
        res.append(np.asarray(r, np.int64))
        rel.append(np.full(len(r), rl, np.int64))
        subj.append(np.asarray(s, np.int64))
        srel.append(np.full(len(r), sr, np.int64))

    chain = np.arange(n_groups - 1)
    deep = chain[(chain % 5) != 4]
    bulk(groups[deep], member, groups[deep + 1], member)
    gm_res = np.repeat(groups, 6)
    bulk(gm_res, member, rng.choice(users, gm_res.shape[0]), -1)
    f_idx = np.arange(1, n_folders)
    bulk(folders[f_idx], parent, folders[(f_idx - 1) // 16], -1)
    fv = rng.random(n_folders) < 0.5
    bulk(folders[fv], viewer, rng.choice(groups, int(fv.sum())), member)
    bulk(folders[~fv], viewer, rng.choice(users, int((~fv).sum())), -1)
    bulk(docs, folder_rel, rng.choice(folders, n_docs), -1)
    extra = rng.random(n_docs) < 0.2
    bulk(docs[extra], viewer, rng.choice(users, int(extra.sum())), -1)
    cur = sum(a.shape[0] for a in res)
    want = int(10_000_000 * scale)
    if cur < want:
        k = want - cur
        per_doc = k // n_docs
        dd = np.repeat(docs, per_doc)
        bulk(dd, viewer, rng.choice(groups, dd.shape[0]), member)
        rem = k - dd.shape[0]
        if rem:
            bulk(docs[:rem], viewer, rng.choice(users, rem), -1)
    if fill_nested:
        a, lo, hi = np.arange(n_groups), [], []
        for j in (2, 3, 4):
            i = a[(a % 5 + j <= 4) & (a + j < n_groups)]
            lo.append(i)
            hi.append(i + j)
        lo, hi = np.concatenate(lo), np.concatenate(hi)
        n_deep = int(deep.shape[0])
        need = max(8, 1 << (n_deep - 1).bit_length()) - n_deep
        if need > lo.shape[0]:
            raise AssertionError(f"fill_nested: {need} edges needed, {lo.shape[0]} implied")
        bulk(groups[lo[:need]], member, groups[hi[:need]], member)
    if client is not None:
        from gochugaru_tpu_torch import consistency

        name = {v: k for k, v in slot.items()}
        groups_of = {}
        for r, rl, s, sr in zip(res, rel, subj, srel):
            key = (int(rl[0]) if rl.size else -1, int(sr[0]) if sr.size else -1)
            groups_of.setdefault(key, []).append((r, s))
        for (rl, sr), parts in groups_of.items():
            if rl < 0:
                continue
            client.store.import_interned_columns(
                resource_ids=np.concatenate([p[0] for p in parts]),
                resource_relation=name[rl],
                subject_ids=np.concatenate([p[1] for p in parts]),
                subject_relation=name[sr] if sr >= 0 else "",
                touch=True,  # the generator draws repeated pairs
            )
        snap = client.store.snapshot_for(consistency.full())
        cs = snap.compiled
    else:
        snap = build_snapshot_from_columns(
            1, cs, interner,
            res=np.concatenate(res), rel=np.concatenate(rel),
            subj=np.concatenate(subj), srel=np.concatenate(srel), epoch_us=EPOCH,
        )
    # the batch: bench3_docs.py's seed-7 draw, by index
    qrng = np.random.default_rng(7)
    B = 100_000
    di = qrng.integers(0, n_docs, B)
    ui = qrng.integers(0, n_users, B)
    q = (docs[di].astype(np.int32), np.full(B, slot["view"], np.int32),
         users[ui].astype(np.int32))
    names = [("document", f"d{a}", "view", "user", f"u{b}") for a, b in zip(di, ui)]
    return cs, snap, q, names


CONFIG4_SCHEMA = """
caveat same_tenant(tenant string, edge_tenant string, tier int) {
    tenant == edge_tenant && tier >= 1
}
definition user {}
definition org { relation admin: user }
definition item {
    relation org: org
    relation holder: user with same_tenant
    permission access = holder + org->admin
}
"""
#: BASELINE config 4's published edge count (benchmarks/bench4_caveats.py)
CONFIG4_EDGES = 100_000_000


def build_config4(n_edges=10_000_000, n_tenants=4096, seed=31):
    """BASELINE config 4, the generator of benchmarks/bench4_caveats.py:
    49-111 (200,000 users, 2,000 orgs, items = edges / 10, every holder
    edge caveated with ``same_tenant`` and one of ``n_tenants`` shared
    stored contexts), and its batch of 100,000 ``access`` checks (seed
    3): half on real holder edges with the edge's tenant half the time,
    half random; each query's request context ``{"tenant", "tier": 2}``
    as ``(q_ctx, qctx_rows)``."""
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns

    cs = compile_schema(parse_schema(CONFIG4_SCHEMA))
    interner = Interner()
    rng = np.random.default_rng(seed)
    n_users, n_orgs = 200_000, 2_000
    n_items = max(n_edges // 10, 1000)
    users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
    orgs = np.array([interner.node("org", f"o{i}") for i in range(n_orgs)], np.int64)
    items = np.array([interner.node("item", f"i{i}") for i in range(n_items)], np.int64)
    slot = cs.slot_of_name
    contexts = [{"edge_tenant": f"t{t}", "tier": 2} for t in range(n_tenants)]
    n_holder = n_edges - n_items - n_orgs
    res = np.concatenate([rng.choice(items, n_holder), items, orgs])
    rel = np.concatenate([np.full(n_holder, slot["holder"], np.int64),
                          np.full(n_items, slot["org"], np.int64),
                          np.full(n_orgs, slot["admin"], np.int64)])
    subj = np.concatenate([rng.choice(users, n_holder), rng.choice(orgs, n_items),
                           rng.choice(users, n_orgs)])
    caveat = np.concatenate([np.full(n_holder, cs.caveat_ids["same_tenant"], np.int32),
                             np.zeros(n_items + n_orgs, np.int32)])
    ctx = np.concatenate([rng.integers(0, n_tenants, n_holder).astype(np.int32),
                          np.full(n_items + n_orgs, -1, np.int32)])
    snap = build_snapshot_from_columns(
        1, cs, interner, res=res, rel=rel, subj=subj,
        srel=np.full(res.shape[0], -1, np.int64), caveat=caveat, ctx=ctx,
        contexts=contexts, epoch_us=EPOCH)
    qrng = np.random.default_rng(3)
    B = 100_000
    holder_rows = np.nonzero(snap.e_rel == slot["holder"])[0]
    hit_rows = qrng.choice(holder_rows, B // 2)
    q_res = np.concatenate([snap.e_res[hit_rows],
                            qrng.choice(items, B - B // 2)]).astype(np.int32)
    q_subj = np.concatenate([snap.e_subj[hit_rows],
                             qrng.choice(users, B - B // 2)]).astype(np.int32)
    q_perm = np.full(B, slot["access"], np.int32)
    qctx_rows = [{"tenant": f"t{t}", "tier": 2} for t in range(n_tenants)]
    edge_tenant = snap.e_ctx[hit_rows].astype(np.int64)
    match = qrng.random(B // 2) < 0.5
    q_ctx = np.concatenate([np.where(match, edge_tenant, (edge_tenant + 1) % n_tenants),
                            qrng.integers(0, n_tenants, B - B // 2)]).astype(np.int32)
    keys = interner.keys_batch(np.concatenate([q_res, q_subj]))
    names = [(rt, rid, "access", st, sid)
             for (rt, rid), (st, sid) in zip(keys[:B], keys[B:])]
    return cs, snap, (q_res, q_perm, q_subj), names, (q_ctx, qctx_rows)


OVF_SCHEMA = """
definition user {}
definition team {
    relation member: user | team#member | user:*
    permission everyone = member
}
definition doc {
    relation reader: user | user:* | team#member | team#everyone
    relation writer: user | team#member
    permission edit = writer
    permission view = reader + edit
}
"""


def ovf_rels(seed: int, n_edges: int):
    """tests/test_pallas.py's random world without its caveats: direct,
    wildcard and userset subjects, expirations, team chains deep enough
    to overflow a small closure cap."""
    from gochugaru_tpu_torch import rel

    rng = random.Random(seed)
    n_docs = max(n_edges // 8, 8)
    n_users = max(n_edges // 16, 8)
    n_teams = 32
    rels = []
    for t in range(1, n_teams):
        parent = t - 1 if t % 7 else rng.randrange(t)
        rels.append(rel.Relationship(
            resource_type="team", resource_id=f"t{parent}",
            resource_relation="member", subject_type="team",
            subject_id=f"t{t}", subject_relation="member"))
    for t in range(n_teams):
        rels.append(rel.Relationship(
            resource_type="team", resource_id=f"t{t}",
            resource_relation="member", subject_type="user",
            subject_id=f"u{rng.randrange(n_users)}"))
    rels.append(rel.Relationship(
        resource_type="team", resource_id="t3", resource_relation="member",
        subject_type="user", subject_id="*"))
    for _ in range(n_edges):
        kind = rng.random()
        kw = dict(resource_type="doc", resource_id=f"d{rng.randrange(n_docs)}",
                  resource_relation="reader" if rng.random() < 0.8 else "writer",
                  subject_type="user", subject_id=f"u{rng.randrange(n_users)}")
        if kind < 0.08:
            kw.update(subject_type="team", subject_id=f"t{rng.randrange(n_teams)}",
                      subject_relation="member")
        elif kind < 0.11:
            kw.update(subject_type="team", subject_id=f"t{rng.randrange(n_teams)}",
                      subject_relation="everyone")
            kw["resource_relation"] = "reader"
        elif kind < 0.13:
            kw.update(subject_id="*")
            kw["resource_relation"] = "reader"
        if rng.random() < 0.07:
            kw["expiration"] = dt.datetime.fromtimestamp(
                (EPOCH + rng.randrange(-10**9, 10**12)) / 1e6, tz=dt.timezone.utc)
        rels.append(rel.Relationship(**kw))
    return rels, n_docs, n_users


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernel_vs_plain(K):
    """Each mode on packed and int32 tables with expiry lanes, bitwise."""
    from gochugaru_tpu_torch.engine import hash as H
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    dev = torch.device(DEV)
    rng = np.random.default_rng(2024)
    n, B = 200_000, 65_536
    k1 = rng.integers(0, 50_000, n).astype(np.int32)
    k2 = rng.integers(0, 3_000, n).astype(np.int32)
    u_d = rng.integers(0, 10_000, n).astype(np.int32)
    u_p = (u_d // 2).astype(np.int32)
    exp = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 10_000, n)).astype(np.int32)
    hi = H.build_hash([k1, k2], target_cap=4)
    raw = H.interleave_buckets(hi, [k1, k2, u_d, u_p, exp])
    spec = PK.make_spec([PK.col_range(-1, 50_000), PK.col_range(-1, 3_000)]
                        + [PK.col_range(-1, 10_000)] * 3)
    res, anchor = PK.pack_off(hi.off)
    qi = rng.integers(0, n, B)
    q1 = np.where(rng.random(B) < 0.05, -1, k1[qi]).astype(np.int32)
    q2 = np.where(rng.random(B) < 0.3, rng.integers(0, 3_000, B), k2[qi]).astype(np.int32)
    qs = (torch.from_numpy(q1).to(dev), torch.from_numpy(q2).to(dev))
    now = 5_000
    cases = {
        "int32": dict(off=to_device_tensor(hi.off, dev), tbl=to_device_tensor(raw, dev),
                      spec=None, off_a=None, ashift=None),
        "packed": dict(off=to_device_tensor(res, dev),
                       tbl=to_device_tensor(PK.pack_rows(raw, spec), dev),
                       spec=spec, off_a=to_device_tensor(anchor, dev),
                       ashift=PK.OFF_ANCHOR_SHIFT),
    }
    for layout, c in cases.items():
        for mode in (m for m in K.MODES if m != "runs"):
            kw = dict(cap=hi.cap, spec=c["spec"], off_a=c["off_a"],
                      ashift=c["ashift"], mode=mode, now=now,
                      exp_lane=4 if mode == "gate" else None)
            got = _outs(K.fused_probe(qs, c["off"], c["tbl"], **kw))
            want = _outs(K.fused_probe(qs, c["off"], c["tbl"], plain=True, **kw))
            for a, b in zip(got, want):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"kernel != plain: {mode} on {layout}")
            hits = int(got[0].sum()) if mode != "block" else -1
            log(f"kernel-vs-plain {layout:6s} {mode:6s} bitwise OK (hits={hits})")


def runs_tables(dev):
    """Rev-style tables (engine/rev.py: rows bucketed by mix32 of column
    0, sorted within each bucket) with one 5,000-row key, so the bisect
    cap is 8,192; int32 and packed forms, and 65,536 keys mixing present,
    absent and negative keys."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine import rev as R
    from gochugaru_tpu_torch.engine.device import to_device_tensor
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    rng = np.random.default_rng(2025)
    k0 = np.concatenate([np.full(5_000, 4_242, np.int32),
                         rng.integers(0, 300_000, 1_000_000).astype(np.int32)])
    k1 = rng.integers(0, 1 << 24, k0.shape[0]).astype(np.int32)
    exp = np.where(rng.random(k0.shape[0]) < 0.9, 0,
                   rng.integers(1, 10_000, k0.shape[0])).astype(np.int32)
    h = _hash_cols([k0])
    geom = R.rev_geom(h, 1)
    off, tbl = R.build_rev_full(h, [k0, k1, exp], geom, 3)
    cap = R.rev_meta_kw(geom, geom, None)["rv_cap"]
    if cap < 1024:
        raise AssertionError(f"runs table has no heavy bucket (cap {cap})")
    spec = PK.make_spec([PK.col_range(-1, 300_000), PK.col_range(-1, 1 << 24),
                         PK.col_range(-1, 10_000)])
    res, anchor = PK.pack_off(off)
    B = 65_536
    keys = np.where(rng.random(B) < 0.6, rng.choice(k0, B),
                    rng.integers(-5, 400_000, B)).astype(np.int32)
    keys[:4] = (4_242, -1, 300_001, 4_242)
    q = torch.from_numpy(keys).to(dev)
    return q, cap, {
        "int32": dict(off=to_device_tensor(off, dev),
                      tbl=to_device_tensor(tbl, dev), spec=None, off_a=None,
                      ashift=None),
        "packed": dict(off=to_device_tensor(res, dev),
                       tbl=to_device_tensor(PK.pack_rows(tbl, spec), dev),
                       spec=spec, off_a=to_device_tensor(anchor, dev),
                       ashift=PK.OFF_ANCHOR_SHIFT),
    }


def phase_runs_vs_plain(K):
    """The runs mode on rev-style tables, kernel == plain bit for bit."""
    q, cap, cases = runs_tables(torch.device(DEV))
    for layout, c in cases.items():
        kw = dict(cap=cap, spec=c["spec"], off_a=c["off_a"], ashift=c["ashift"],
                  mode="runs")
        got = K.fused_probe((q,), c["off"], c["tbl"], **kw)
        want = K.fused_probe((q,), c["off"], c["tbl"], plain=True, **kw)
        for a, b in zip(got, want):
            if a.dtype != torch.int32 or not torch.equal(a, b):
                raise AssertionError(f"kernel != plain: runs on {layout}")
        ln = got[1]
        if int(ln[0]) < 5_000 or int(ln[1]) != 0 or int(ln[2]) != 0:
            raise AssertionError(f"runs on {layout}: wrong heavy/negative/absent runs")
        log(f"kernel-vs-plain {layout:6s} runs   bitwise OK (cap={cap},"
            f" keys={q.numel()}, rows found={int(ln.long().sum())},"
            f" heavy run={int(ln[0])})")


#: rows of the planted buckets of phase 3's runs edge tables
RUNS_EDGE_SIZES = (0, 1, 7, 8, 9)


def runs_truncated(keys, off, cap) -> int:
    """How many of ``keys`` (numpy) fall in a bucket of at least
    2^steps rows, ``steps = max(bit_length(cap), 1)``: their bisects stop
    before the range is empty (``off`` the full int32 offsets)."""
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    keys = np.asarray(keys)
    h = (_hash_cols([keys]) & np.uint32(off.shape[0] - 2)).astype(np.int64)
    n = off[h + 1].astype(np.int64) - off[h]
    return int(((keys >= 0) & (n >= 1 << max(int(cap).bit_length(), 1))).sum())


def runs_edge_tables(dev, sizes=RUNS_EDGE_SIZES):
    """Rev-style tables built by engine/rev.py whose buckets hold exactly
    ``sizes`` rows each (of up to three
    distinct keys each; one of each, while there are free ones, at a
    bucket h whose h + 1 lies under the next offset anchor), beside a 5,000-row key and random rows; and
    keys equal to a bucket's first and last row, between its rows, below
    and above them in the same bucket, absent and negative.  Two key
    ranges: ``narrow`` (column 0 of 16 bits when packed: lane 0 alone)
    and ``wide`` (22 bits: lanes 0 and 1).  Returns {name: (keys, cap,
    counts, layouts)} with each name's int32, packed and ``unsorted``
    (int32, rows shuffled within every bucket) layouts, and the bucket
    sizes its planted keys probe."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine import rev as RV
    from gochugaru_tpu_torch.engine.device import to_device_tensor
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    rng = np.random.default_rng(2029)
    counts = tuple(sizes)
    out = {}
    for name, kmax, n_base in (("narrow", 65_534, 1_500), ("wide", 3_000_000, 40_000)):
        heavy = 5_000
        n_rows = n_base + heavy + 2 * sum(counts)
        size = 1 << max(n_rows - 1, 7).bit_length()
        cand = np.arange(kmax, dtype=np.int32)
        ch = (_hash_cols([cand]) & np.uint32(size - 1)).astype(np.int64)
        base = rng.integers(0, kmax, n_base).astype(np.int32)
        k0 = [np.full(heavy, 4_242, np.int32), base]
        used = set((_hash_cols([k0[1]]) & np.uint32(size - 1)).tolist())
        used.add(int(_hash_cols([np.array([4_242], np.int32)])[0] & np.uint32(size - 1)))
        order = np.argsort(ch, kind="stable")
        starts = np.searchsorted(ch[order], np.arange(size + 1))
        free = [b for b in range(size) if b not in used and starts[b + 1] - starts[b] >= 7]
        anchor_free = [b for b in free if (b + 1) % (1 << PK.OFF_ANCHOR_SHIFT) == 0]
        queries, planted = [], []
        for c in counts:
            b_anchor = anchor_free.pop(0) if anchor_free else free[0]
            free.remove(b_anchor)
            b_mid = free.pop(len(free) // 2)
            if b_mid in anchor_free:
                anchor_free.remove(b_mid)
            for b in (b_anchor, b_mid):
                ks = np.sort(cand[order[starts[b]:starts[b + 1]]])[:7]
                # rows of keys ks[1], ks[3], ks[5]; ks[0, 2, 4, 6] absent
                per = [c - 2 * (c // 3), c // 3, c // 3] if c > 1 else [c, 0, 0]
                for k, m in zip(ks[1::2], per):
                    k0.append(np.full(m, k, np.int32))
                queries.append(ks)
                planted.append(c)
        k0 = np.concatenate(k0)
        k1 = rng.integers(0, 1 << 24, k0.shape[0]).astype(np.int32)
        exp = np.where(rng.random(k0.shape[0]) < 0.9, 0,
                       rng.integers(1, 10_000, k0.shape[0])).astype(np.int32)
        h = _hash_cols([k0])
        geom = RV.rev_geom(h, 1)
        if geom.size != size:
            raise AssertionError(f"runs edges {name}: {geom.size} buckets, planned {size}")
        off, tbl = RV.build_rev_full(h, [k0, k1, exp], geom, 3)
        cap = RV.rev_meta_kw(geom, geom, None)["rv_cap"]
        spec = PK.make_spec([PK.col_range(-1, kmax), PK.col_range(-1, 1 << 24),
                             PK.col_range(-1, 10_000)])
        if (spec[2][0][0] > 16) != (name == "wide"):
            raise AssertionError(f"runs edges {name}: field 0 has {spec[2][0][0]} bits")
        res, anchor = PK.pack_off(off)
        # the same rows shuffled within every bucket (no longer sorted)
        shuf = tbl.copy()
        for b in np.flatnonzero(np.diff(off) > 1):
            lo, hi = int(off[b]), int(off[b + 1])
            shuf[lo:hi] = shuf[lo:hi][rng.permutation(hi - lo)]
        B = 4_096
        keys = np.concatenate([
            np.concatenate(queries),
            np.array([4_242, -1, -7, kmax + 1], np.int32),
            rng.choice(k0, B // 2),
            rng.integers(-5, kmax + 100, B // 2),
        ]).astype(np.int32)
        layouts = {
            "int32": dict(off=off, tbl=tbl, spec=None, off_a=None, ashift=None),
            "packed": dict(off=res, tbl=PK.pack_rows(tbl, spec), spec=spec,
                           off_a=anchor, ashift=PK.OFF_ANCHOR_SHIFT),
            "unsorted": dict(off=off, tbl=shuf, spec=None, off_a=None, ashift=None),
        }
        for lay in layouts.values():
            lay["off_full"] = off
            for k in ("off", "tbl", "off_a"):
                if lay[k] is not None:
                    lay[k] = to_device_tensor(lay[k], dev)
        out[name] = (keys, cap, sorted(set(planted)), layouts)
    return out


def phase_runs_edges(K):
    """Phase 3's runs edges: every table of runs_edge_tables under its own
    cap and under caps 4 and 2 (below the heavy bucket and some planted
    ones: the bisect must truncate as the reference's does), kernel ==
    plain bit for bit; logs the keys whose bisect truncated."""
    dev = torch.device(DEV)
    n_cases = truncated = 0
    for name, (keys, cap, sizes, layouts) in runs_edge_tables(dev).items():
        if sizes != sorted(RUNS_EDGE_SIZES):
            raise AssertionError(f"runs edges {name}: planted buckets of {sizes} rows")
        q = torch.from_numpy(keys).to(dev)
        for layout, c in layouts.items():
            for cp in (cap, 4, 2):
                kw = dict(cap=cp, spec=c["spec"], off_a=c["off_a"], ashift=c["ashift"],
                          mode="runs")
                got = K.fused_probe((q,), c["off"], c["tbl"], **kw)
                want = K.fused_probe((q,), c["off"], c["tbl"], plain=True, **kw)
                for a, b in zip(got, want):
                    if a.dtype != torch.int32 or not torch.equal(a, b):
                        raise AssertionError(f"kernel != plain: runs edges {name}"
                                             f" {layout} cap={cp}")
                cut = runs_truncated(keys, c["off_full"], cp)
                truncated += cut
                n_cases += 1
                log(f"runs edges {name:6s} {layout:8s} cap={cp:5d} bitwise OK"
                    f" (keys={keys.size}, truncated bisects={cut},"
                    f" rows found={int(got[1].long().sum())})")
    if not truncated:
        raise AssertionError("runs edges: no bisect truncated")
    log(f"runs edges: {n_cases} cases bitwise OK, {truncated} truncated bisects")


def aligned_ladders(dev):
    """Bucket-aligned ladders of >= 3 levels (cover (0.5, 0.9); a full key
    repeated past level 0's cap) over 200,000 entries: a two-key table
    (k1, k2, two until columns, expiry) and a one-key table (k0, one
    until column, an expiry-like column, expiry), each int32 and packed;
    65,536 queries mixing present, absent and negative keys."""
    from gochugaru_tpu_torch.engine import hash as H
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    rng = np.random.default_rng(2026)
    n, B = 200_000, 65_536
    k1 = rng.integers(0, 50_000, n).astype(np.int32)
    k2 = rng.integers(0, 3_000, n).astype(np.int32)
    k0 = rng.integers(0, 2_000_000, n).astype(np.int32)
    # one full key past level 0's cap, short of what the fit-all last
    # level refuses (16 a bucket)
    k1[:14], k2[:14], k0[:12] = 4_242, 17, 4_242
    u_d = rng.integers(0, 10_000, n).astype(np.int32)
    u_p = (u_d // 2).astype(np.int32)
    # expiry: 0 (never), expired (< now = 5,000) or live (> now)
    exp = np.where(rng.random(n) < 0.4, 0, rng.integers(1, 10_000, n)).astype(np.int32)
    R = PK.col_range
    tables = {
        "2key": ([k1, k2], [k1, k2, u_d, u_p, exp],
                 [R(-1, 50_000), R(-1, 3_000)] + [R(-1, 10_000)] * 3, 4),
        "1key": ([k0], [k0, u_d, u_p, exp],
                 [R(-1, 2_000_000)] + [R(-1, 10_000)] * 3, 3),
    }
    qi = rng.integers(0, n, B)
    out = {}
    for name, (keys, cols, descs, exp_lane) in tables.items():
        ai = H.build_aligned(keys, cols, cover=(0.5, 0.9))
        if ai is None or len(ai.levels) < 3:
            raise AssertionError(f"aligned ladder {name}: fewer than 3 levels"
                                 f" ({None if ai is None else ai.caps})")
        q = [np.where(rng.random(B) < 0.05, -1, c[qi]).astype(np.int32) for c in keys]
        q[-1] = np.where(rng.random(B) < 0.3, rng.integers(0, 3_000_000, B), q[-1]).astype(np.int32)
        q[0][:3] = (keys[0][0], -1, 2_100_000)
        if len(keys) > 1:
            q[1][:3] = (keys[1][0], keys[1][0], 1)
        qs = tuple(torch.from_numpy(c).to(dev) for c in q)
        spec = PK.make_spec(descs)
        levels = [t for t, _ in ai.levels]
        packed = [PK.pack_rows(t.reshape(-1, ai.w), spec).reshape(t.shape[0], -1)
                  for t in levels]
        out[f"{name} int32"] = (qs, [to_device_tensor(t, dev) for t in levels],
                                ai.caps, ai.w, None, exp_lane)
        out[f"{name} packed"] = (qs, [to_device_tensor(t, dev) for t in packed],
                                 ai.caps, spec[1], spec, exp_lane)
    return out


def phase_aligned_vs_plain(K):
    """Each fused_probe_aligned mode on >= 3-level ladders, bitwise."""
    now = 5_000
    for layout, (qs, tbls, caps, sw, spec, exp_lane) in aligned_ladders(
            torch.device(DEV)).items():
        for mode in K.ALIGNED_MODES:
            kw = dict(spec=spec, mode=mode, now=now,
                      exp_lane=exp_lane if mode == "gate" else None)
            got = _outs(K.fused_probe_aligned(qs, tbls, caps, sw, **kw))
            want = _outs(K.fused_probe_aligned(qs, tbls, caps, sw, plain=True, **kw))
            for a, b in zip(got, want):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"aligned kernel != plain: {mode} on {layout}")
            if mode == "gate":
                hit, live = got
                deep = int(hit[:, caps[0]:].sum())
                if not deep or not bool((hit & ~live).any()):
                    raise AssertionError(f"aligned {layout}: no hit past level 0"
                                         " or no expired hit")
        log(f"aligned kernel-vs-plain {layout:12s} all modes bitwise OK"
            f" (levels={len(tbls)} caps={tuple(caps)} hits={int(hit.sum())}"
            f" past level 0={deep})")


EDGE_W = (1, 3, 5, 16)
EDGE_B = (1, 255, 65_537)
#: 2^29 rows x 5 int32 columns: 2.7e9 elements, past int32 addressing
HUGE_ROWS = 1 << 29


def edge_spec(W, rng, n):
    """A pack spec of ``W`` columns mixing every field kind the decode
    reads (a 16-bit range, a delta of column 0, a dictionary, a 21-bit
    range that crosses a lane, a constant), and ``n`` int32 rows in it."""
    from gochugaru_tpu_torch.engine import packed as PK

    dict_vals = (-1, 3, 8, 2**31 - 1)
    raw = np.empty((n, W), np.int32)
    raw[:, 0] = rng.integers(-1, 50_001, n)
    descs = [PK.col_range(-1, 50_000)]
    for c in range(1, W):
        kind = c % 4
        if kind == 1:
            descs.append(PK.col_delta(-100, 100, 0))
            raw[:, c] = raw[:, 0] + rng.integers(-100, 101, n)
        elif kind == 2:
            descs.append(PK.col_dict(dict_vals))
            raw[:, c] = rng.choice(dict_vals, n)
        elif kind == 3:
            descs.append(PK.col_range(-1, (1 << 20) - 1))
            raw[:, c] = rng.integers(-1, 1 << 20, n)
        else:
            descs.append(PK.col_const(7))
            raw[:, c] = 7
    return PK.make_spec(descs), raw


def edge_caps(K, W):
    """Phase 3c's caps: 1, 3, 8, 64 and one whose single lane's block
    passes the tile budget (so the tile walks it in chunks)."""
    big = K.TILE_BYTES // (4 * W) * 2 + 3
    if K.block_tile(big, W, 1)[0] >= big:
        raise AssertionError(f"cap {big} x W {W} fits one tile")
    return (1, 3, 8, 64, big)


def edge_offsets(rng, rows, cap, size=1_024):
    """Sorted int32 bucket offsets [size + 1] over ``rows`` rows whose last
    quarter of starts lies within ``cap`` of the end (those lanes clamp to
    rows - cap)."""
    starts = np.concatenate([rng.integers(0, rows + 1, size + 1 - size // 4),
                             rng.integers(rows - cap + 1, rows + 1, size // 4)])
    return np.sort(starts).astype(np.int32)


def off_layouts(off, raw, spec, dev):
    """An off+interleave table as fused_probe takes it: int32 rows with
    int32 offsets, and packed rows with anchored offsets."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    res, anchor = PK.pack_off(off)
    return {
        "int32": dict(off=to_device_tensor(off, dev), tbl=to_device_tensor(raw, dev),
                      spec=None, off_a=None, ashift=None),
        "packed": dict(off=to_device_tensor(res, dev),
                       tbl=to_device_tensor(PK.pack_rows(raw, spec), dev),
                       spec=spec, off_a=to_device_tensor(anchor, dev),
                       ashift=PK.OFF_ANCHOR_SHIFT),
    }


def clamped_window(qs, off, rows, cap):
    """(first row of each lane's window, lane's bucket start passes rows -
    cap) for numpy key columns ``qs`` over int32 offsets ``off``."""
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    size = off.shape[0] - 1
    h = (_hash_cols(list(qs)) & np.uint32(size - 1)).astype(np.int64)
    start = off[h].astype(np.int64)
    return np.clip(start, 0, rows - cap), start > rows - cap


def plant_rows(raw, off, cap, qs, rng, spec, exp_col=None, absent=None):
    """Write the keys of every other live lane (not in the mask ``absent``)
    into a random row of its (clamped) window of the off+interleave int32
    rows ``raw`` (offsets ``off``), so the probe sees hits, clamped lanes
    included; the row's columns that ``spec`` stores as deltas of a key
    column (or of such a delta) move with the key, so the rows still pack.
    When ``exp_col`` is given, a third of them get expiry 0."""
    live = np.ones(qs[0].shape[0], bool) if absent is None else ~absent
    for q in qs:
        live &= q >= 0
    lanes = np.flatnonzero(live)[::2]
    s, _ = clamped_window([q[lanes] for q in qs], off, raw.shape[0], cap)
    r = s + rng.integers(0, cap, lanes.shape[0])
    shift = []
    for c, f in enumerate(spec[2]):
        if c < len(qs):
            shift.append(qs[c][lanes].astype(np.int64) - raw[r, c])
        else:
            shift.append(shift[f[2]] if f[2] >= 0 else 0)
    new = [(raw[r, c].astype(np.int64) + d).astype(np.int32) for c, d in enumerate(shift)]
    for c, v in enumerate(new):
        raw[r, c] = v
    if exp_col is not None:
        zero = rng.random(lanes.shape[0]) < 1 / 3
        raw[r[zero], exp_col] = 0


def _edge_queries(rng, B, nq, dev):
    """``nq`` key columns of ``B`` lanes: random keys (absent from the
    tables' key columns more often than not), 5% negative."""
    cols = [np.where(rng.random(B) < 0.05, -rng.integers(1, 9, B),
                     rng.integers(0, 60_000, B)).astype(np.int32) for _ in range(nq)]
    return tuple(torch.from_numpy(c).to(dev) for c in cols)


def _same(K, name, got, want):
    if got.dtype != torch.int32 or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"block tile != plain: {name}")


def phase_block_edges(K, huge_rows=HUGE_ROWS):
    """Phase 3c: mode block of both kernels at the tile's edges, kernel ==
    plain bit for bit (see the module docstring)."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor
    from gochugaru_tpu_torch.engine.hash import bucket_of

    dev = torch.device(DEV)
    rng = np.random.default_rng(2027)
    n_cases = n_clamped = 0
    # fused_probe: off+interleave tables whose last quarter of bucket
    # starts lies within cap of the end (clamped to rows - cap)
    for W in EDGE_W:
        for cap in edge_caps(K, W):
            rows, size = max(4 * cap, 4_096), 1_024
            spec, raw = edge_spec(W, rng, rows)
            off = edge_offsets(rng, rows, cap, size)
            layouts = off_layouts(off, raw, spec, dev)
            off_t = torch.from_numpy(off).to(dev)
            for layout, c in layouts.items():
                for nq in (1, 2)[:W]:
                    for B in EDGE_B:
                        qs = _edge_queries(rng, B, nq, dev)
                        kw = dict(cap=cap, spec=c["spec"], off_a=c["off_a"],
                                  ashift=c["ashift"], mode="block")
                        _same(K, f"fused_probe {layout} nq={nq} W={W} cap={cap} B={B}",
                              K.fused_probe(qs, c["off"], c["tbl"], **kw),
                              K.fused_probe(qs, c["off"], c["tbl"], plain=True, **kw))
                        n_cases += 1
                        n_clamped += int((off_t[bucket_of(qs, size)] > rows - cap).sum())
    if not n_clamped:
        raise AssertionError("phase 3c: no lane's bucket start was clamped")
    log(f"block edges fused_probe: {n_cases} cases (W {EDGE_W}, caps 1/3/8/64/"
        f"past the tile budget, B {EDGE_B}, int32 and packed, one and two keys"
        " where W >= 2)"
        f" bitwise OK; {n_clamped} clamped lanes")

    # fused_probe_aligned: synthetic ladders (pow2 level rows, random slots)
    n_al = 0
    for W in EDGE_W:
        ladders = [(c, 3, 1) for c in edge_caps(K, W)[:4]]
        ladders += [(edge_caps(K, W)[4], 1), (5, 4, 3, 2, 2, 1, 1, 1)]
        for caps in ladders:
            sizes = [max(1_024 >> (2 * l), 8) for l in range(len(caps))]
            spec, _ = edge_spec(W, rng, 1)
            raws = [edge_spec(W, rng, s * c)[1] for s, c in zip(sizes, caps)]
            layouts = {
                "int32": ([to_device_tensor(r.reshape(s, c * W), dev)
                           for r, s, c in zip(raws, sizes, caps)], W, None),
                "packed": ([to_device_tensor(PK.pack_rows(r, spec).reshape(s, -1), dev)
                            for r, s in zip(raws, sizes)], spec[1], spec),
            }
            for layout, (tbls, sw, sp) in layouts.items():
                for nq in (1, 2)[:W]:
                    for B in EDGE_B:
                        qs = _edge_queries(rng, B, nq, dev)
                        _same(K, f"aligned {layout} nq={nq} W={W} caps={caps} B={B}",
                              K.fused_probe_aligned(qs, tbls, caps, sw, spec=sp),
                              K.fused_probe_aligned(qs, tbls, caps, sw, spec=sp,
                                                    plain=True))
                        n_al += 1
    # phase 3b's >= 3-level ladders from build_aligned
    for layout, (qs, tbls, caps, sw, spec, _e) in aligned_ladders(dev).items():
        for B in EDGE_B:
            qb = tuple(torch.cat([q, q])[:B] for q in qs)
            _same(K, f"aligned ladder {layout} B={B}",
                  K.fused_probe_aligned(qb, tbls, caps, sw, spec=spec),
                  K.fused_probe_aligned(qb, tbls, caps, sw, spec=spec, plain=True))
            n_al += 1
    log(f"block edges fused_probe_aligned: {n_al} cases (W {EDGE_W}, ladders"
        " (c,3,1) for c in 1/3/8/64, (past the budget,1), 8 levels, and the"
        " build_aligned 3-level ladders; B"
        f" {EDGE_B}, int32 and packed, one and two keys where W >= 2) bitwise OK")
    phase_gate_edges(K)
    phase_block_huge(K, huge_rows)


#: phase 3c's gate: per W, (expiry column, now) — the key column, a delta
#: of column 0 (decoded along its chain), a dictionary, a 21-bit range
#: with planted zeros
GATE_EXP = {1: (0, 25_000), 3: (1, 25_000), 5: (2, 5), 16: (7, 1 << 19)}


def _gate_queries(rng, B, nq):
    """``nq`` key columns of ``B`` lanes inside edge_spec's ranges (column
    1 a delta of column 0 within 100), 5% negative."""
    q0 = rng.integers(0, 50_001, B)
    cols = [q0, np.clip(q0 + rng.integers(-100, 101, B), -1, None)][:nq]
    return [np.where(rng.random(B) < 0.05, -rng.integers(1, 9, B), c).astype(np.int32)
            for c in cols]


def plant_hits(raws, caps, qs, rng, spec, exp_col=None):
    """Write the keys of every other lane into a random slot of the row
    its (salted) hash picks at a random level, so the gate sees hits past
    level 0; when ``exp_col`` is given, a third of them get expiry 0.
    ``raws[l]`` is level l's int32 [rows * cap_l, W] slot array; the
    slot's other columns that ``spec`` stores as deltas of column 0 are
    moved with it, so the rows still pack."""
    from gochugaru_tpu_torch.engine.hash import _level_salt
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    for i in range(0, qs[0].shape[0], 2):
        if qs[0][i] < 0 or (len(qs) > 1 and qs[1][i] < 0):
            continue
        lvl = int(rng.integers(0, len(caps)))
        rows = raws[lvl].shape[0] // caps[lvl]
        salted = [np.array([qs[0][i] ^ np.int32(_level_salt(lvl))], np.int32)]
        salted += [q[i:i + 1] for q in qs[1:]]
        r = int(_hash_cols(salted)[0] & np.uint32(rows - 1))
        slot = r * caps[lvl] + int(rng.integers(0, caps[lvl]))
        for c, f in enumerate(spec[2]):
            if c >= len(qs) and f[2] == 0:
                raws[lvl][slot, c] += qs[0][i] - raws[lvl][slot, 0]
        for c, q in enumerate(qs):
            raws[lvl][slot, c] = q[i]
        if exp_col is not None and rng.random() < 1 / 3:
            raws[lvl][slot, exp_col] = 0


def _gate_same(K, name, got, want):
    for a, b in zip(got, want):
        if a.dtype != torch.bool or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"gate != plain: {name}")


def _gate_tally(got, clamped, tally):
    """Tally a gate's hits, expired hits and hits on clamped lanes."""
    hit, live = got[0], got[1]
    tally["hits"] += int(hit.sum())
    tally["expired"] += int((hit & ~live).sum())
    tally["clamped hits"] += int(hit[torch.from_numpy(clamped).to(hit.device)].sum())


def phase_gate_edges_off(K):
    """Phase 3c's off+interleave gate: fused_probe mode gate on the slot
    tile at its edges, kernel == plain bit for bit (see the module
    docstring)."""
    dev = torch.device(DEV)
    rng = np.random.default_rng(2032)
    long_lane = 2 * K.GATE_SLOTS + 3
    n_cases = 0
    tally = dict.fromkeys(("hits", "expired", "clamped hits"), 0)
    for W in EDGE_W:
        exp_col, now = GATE_EXP[W]
        for cap in (1, 3, 8, 64, long_lane):
            rows = max(4 * cap, 4_096)
            spec, raw0 = edge_spec(W, rng, rows)
            off = edge_offsets(rng, rows, cap)
            for nq in (1, 2)[:W]:
                qs_np = _gate_queries(rng, max(EDGE_B), nq)
                raw = raw0.copy()
                plant_rows(raw, off, cap, qs_np, rng, spec, exp_col if W == 16 else None)
                _, clamped = clamped_window(qs_np, off, rows, cap)
                for layout, c in off_layouts(off, raw, spec, dev).items():
                    # the lane past one tile: at most 4,097 lanes, as the
                    # aligned gate's
                    for B in EDGE_B if cap < long_lane else (1, 255, 4_097):
                        qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)
                        for e in (exp_col, None):
                            kw = dict(cap=cap, spec=c["spec"], off_a=c["off_a"],
                                      ashift=c["ashift"], mode="gate", now=now,
                                      exp_lane=e)
                            got = K.fused_probe(qs, c["off"], c["tbl"], **kw)
                            _gate_same(K, f"fused_probe {layout} nq={nq} W={W} cap={cap}"
                                       f" B={B} exp_lane={e}", got,
                                       K.fused_probe(qs, c["off"], c["tbl"], plain=True,
                                                     **kw))
                            n_cases += 1
                            if e is not None:
                                _gate_tally(got, clamped[:B], tally)
    if not all(tally.values()):
        raise AssertionError(f"phase 3c off+interleave gate: an edge never occurred"
                             f" ({tally})")
    log(f"gate edges fused_probe: {n_cases} cases (W {EDGE_W}, caps 1/3/8/64/"
        f"{long_lane} (past one tile of {K.GATE_SLOTS} slots, B up to 4,097), B"
        f" {EDGE_B}, bucket starts clamped at rows - cap, int32 and packed, one"
        f" and two keys where W >= 2, negative and absent keys, expiry lane and"
        f" none) bitwise OK; {tally}")


def phase_gate_edges(K):
    """Phase 3c's gate: the slot tile's mode gate at its edges, kernel ==
    plain bit for bit, off+interleave (phase_gate_edges_off) and aligned
    (see the module docstring)."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    phase_gate_edges_off(K)
    dev = torch.device(DEV)
    rng = np.random.default_rng(2030)
    long_lane = 2 * K.GATE_SLOTS + 3
    n_cases = hits = expired = zero_live = 0
    for W in EDGE_W:
        exp_col, now = GATE_EXP[W]
        ladders = [(c, 3, 1) for c in (1, 3, 8, 64)]
        ladders += [(long_lane, 1), (5, 4, 3, 2, 2, 1, 1, 1)]
        for caps in ladders:
            sizes = [max(1_024 >> (2 * l), 8) for l in range(len(caps))]
            spec, _ = edge_spec(W, rng, 1)
            for nq in (1, 2)[:W]:
                qs_np = _gate_queries(rng, max(EDGE_B), nq)
                raws = [edge_spec(W, rng, s * c)[1] for s, c in zip(sizes, caps)]
                plant_hits(raws, caps, qs_np, rng, spec, exp_col if W == 16 else None)
                layouts = {
                    "int32": ([to_device_tensor(r.reshape(s, c * W), dev)
                               for r, s, c in zip(raws, sizes, caps)], W, None),
                    "packed": ([to_device_tensor(PK.pack_rows(r, spec).reshape(s, -1), dev)
                                for r, s in zip(raws, sizes)], spec[1], spec),
                }
                for layout, (tbls, sw, sp) in layouts.items():
                    # the lane past one tile: at most 4,097 lanes (the
                    # plain twin's block of 65,537 such lanes is ~4 GB)
                    for B in EDGE_B if caps[0] < long_lane else (1, 255, 4_097):
                        qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)
                        for e in (exp_col, None):
                            kw = dict(spec=sp, mode="gate", now=now, exp_lane=e)
                            got = K.fused_probe_aligned(qs, tbls, caps, sw, **kw)
                            _gate_same(K, f"aligned {layout} nq={nq} W={W} caps={caps} B={B}"
                                       f" exp_lane={e}", got,
                                       K.fused_probe_aligned(qs, tbls, caps, sw,
                                                             plain=True, **kw))
                            n_cases += 1
                            if e is not None:
                                hit, live = got
                                hits += int(hit.sum())
                                expired += int((hit & ~live).sum())
                                if W == 16:
                                    blk = K.fused_probe_aligned(
                                        qs, tbls, caps, sw, spec=sp, plain=True)
                                    zero_live += int((live & (blk[..., e] == 0)).sum())
    # levels of one row (an odd element count when cap * lanes is odd),
    # and levels that start 2 bytes past an aligned address (a view one
    # element into a larger tensor)
    for W in EDGE_W:
        exp_col, now = GATE_EXP[W]
        caps = (3, 1)
        spec, _ = edge_spec(W, rng, 1)
        qs_np = _gate_queries(rng, max(EDGE_B), min(2, W))
        raws = [edge_spec(W, rng, c)[1] for c in caps]
        plant_hits(raws, caps, qs_np, rng, spec, exp_col if W == 16 else None)
        packed = [PK.pack_rows(r, spec).reshape(1, -1) for r in raws]
        shifted = []
        for p in packed:
            flat = torch.zeros(p.size + 1, dtype=torch.int16, device=dev)
            flat[1:] = to_device_tensor(p, dev).reshape(-1)
            shifted.append(flat[1:].view(p.shape))
        for name, tbls in (("one odd row", [to_device_tensor(p, dev) for p in packed]),
                           ("2-byte offset", shifted)):
            for B in EDGE_B:
                qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)
                for e in (exp_col, None):
                    kw = dict(spec=spec, mode="gate", now=now, exp_lane=e)
                    _gate_same(K, f"aligned {name} W={W} B={B} exp_lane={e}",
                               K.fused_probe_aligned(qs, tbls, caps, spec[1], **kw),
                               K.fused_probe_aligned(qs, tbls, caps, spec[1],
                                                     plain=True, **kw))
                    n_cases += 1
    # phase 3b's >= 3-level ladders from build_aligned
    for layout, (qs, tbls, caps, sw, spec, e) in aligned_ladders(dev).items():
        for B in EDGE_B:
            qb = tuple(torch.cat([q, q])[:B] for q in qs)
            for lane in (e, None):
                kw = dict(spec=spec, mode="gate", now=5_000, exp_lane=lane)
                _gate_same(K, f"aligned ladder {layout} B={B} exp_lane={lane}",
                           K.fused_probe_aligned(qb, tbls, caps, sw, **kw),
                           K.fused_probe_aligned(qb, tbls, caps, sw, plain=True, **kw))
                n_cases += 1
    if not (hits and expired and zero_live):
        raise AssertionError(f"phase 3c gate: hits={hits} expired={expired}"
                             f" live with expiry 0={zero_live}: an edge never"
                             " occurred")
    log(f"gate edges fused_probe_aligned: {n_cases} cases (W {EDGE_W}, ladders"
        f" (c,3,1) for c in 1/3/8/64, ({long_lane},1) past one tile of"
        f" {K.GATE_SLOTS} slots (B up to 4,097), 8 levels, (3,1) of one row a level"
        f" and of levels 2 bytes off alignment, and the build_aligned 3-level"
        f" ladders; B {EDGE_B}, int32 and packed, one and two keys where"
        f" W >= 2, expiry lane and none) bitwise OK; {hits} hits, {expired}"
        f" of them expired, {zero_live} live with expiry 0 (W 16)")


#: the caveat planes' codecs: the table build's (ranges with a -1 sentinel), a
#: dictionary of caveat ids, and a context stored as a delta of the caveat
CAV_CODECS = ("range", "dict", "delta")
#: the caveat rows' (caveat, context, expiry) columns and the expiry's now
CAV_LANES = {"cav_lane": 2, "ctx_lane": 3}
CAV_EXP, CAV_NOW = 4, 1 << 19


def cav_rows(rng, n, codec):
    """``n`` int32 rows (k1, k2, caveat, context, expiry) and their pack
    spec under ``codec``: caveat 0 on 40% of rows, context -1 on 30%,
    expiry 0 on a third."""
    from gochugaru_tpu_torch.engine import packed as PK

    raw = np.empty((n, 5), np.int32)
    raw[:, 0] = rng.integers(0, 50_001, n)
    raw[:, 1] = rng.integers(0, 50_101, n)
    raw[:, 2] = np.where(rng.random(n) < 0.4, 0, rng.choice([1, 2, 3, 7], n))
    raw[:, 3] = np.where(rng.random(n) < 0.3, -1, rng.integers(0, 4_096, n))
    raw[:, 4] = np.where(rng.random(n) < 1 / 3, 0, rng.integers(1, 1 << 20, n))
    cav = (PK.col_dict((-1, 0, 1, 2, 3, 7)) if codec == "dict"
           else PK.col_range(-1, 7))
    ctx = (PK.col_delta(-8, 4_096, 2) if codec == "delta"
           else PK.col_range(-1, 4_095))
    spec = PK.make_spec([PK.col_range(-1, 50_000), PK.col_range(-1, 50_100), cav,
                         ctx, PK.col_range(-1, (1 << 20) - 1)])
    return spec, raw


def _cav_same(name, got, want, counts):
    """Every plane of a caveat gate bitwise equal to the plain version's;
    misses give caveat 0 and context -1; tallies hits, caveated hits,
    hits without a stored context and misses."""
    if len(got) != len(want):
        raise AssertionError(f"caveat gate: {name}: {len(got)} planes, want {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        dtype = torch.bool if k < 2 else torch.int32
        if a.dtype != dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"caveat gate != plain: {name} plane {k}")
    hit = got[0]
    if bool((got[2][~hit] != 0).any()) or (
            len(got) > 3 and bool((got[3][~hit] != -1).any())):
        raise AssertionError(f"caveat gate: {name}: a miss kept its lanes")
    counts["hits"] += int(hit.sum())
    counts["caveated"] += int((hit & (got[2] != 0)).sum())
    counts["misses"] += int((~hit).sum())
    if len(got) > 3:
        counts["no_ctx"] += int((hit & (got[3] == -1)).sum())
        counts["ctx"] += int((hit & (got[3] >= 0)).sum())


def _cav_calls(K, name, call, counts):
    """``call(plain, **lanes)`` with and without the expiry lane and the
    context lane, each kernel == plain."""
    n = 0
    for exp_lane in (CAV_EXP, None):
        for needctx in (True, False):
            kw = dict(mode="gate", now=CAV_NOW, exp_lane=exp_lane,
                      cav_lane=CAV_LANES["cav_lane"],
                      ctx_lane=CAV_LANES["ctx_lane"] if needctx else None)
            _cav_same(f"{name} exp_lane={exp_lane} ctx={needctx}",
                      call(False, **kw), call(True, **kw), counts)
            n += 1
    return n


def phase_gate_cav_edges(K):
    """Phase 3c's caveat planes: mode gate of both kernels with the
    caveat-id and context planes, kernel == plain bit for bit on every
    plane (see the module docstring)."""
    from gochugaru_tpu_torch.engine import hash as H
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    dev = torch.device(DEV)
    rng = np.random.default_rng(2031)
    counts = dict.fromkeys(("hits", "caveated", "misses", "no_ctx", "ctx"), 0)
    n_fp = n_al = deep = 0

    def queries(keys, B, nq=2):
        """Half the lanes on stored keys, the rest random; 5% negative."""
        pick = rng.integers(0, keys.shape[0], B)
        q = [np.where(rng.random(B) < 0.5, keys[pick, c], rng.integers(0, 50_001, B))
             for c in range(nq)]
        q[0] = np.where(rng.random(B) < 0.05, -rng.integers(1, 9, B), q[0])
        return tuple(torch.from_numpy(c.astype(np.int32)).to(dev) for c in q)

    # fused_probe: off+interleave tables
    for codec in CAV_CODECS:
        spec, raw = cav_rows(rng, 40_000, codec)
        hi = H.build_hash([raw[:, 0], raw[:, 1]], target_cap=4)
        rows = H.interleave_buckets(hi, [raw[:, c] for c in range(5)])
        res, anchor = PK.pack_off(hi.off)
        layouts = {
            "int32": (to_device_tensor(hi.off, dev), to_device_tensor(rows, dev),
                      None, None, None),
            "packed": (to_device_tensor(res, dev),
                       to_device_tensor(PK.pack_rows(rows, spec), dev), spec,
                       to_device_tensor(anchor, dev), PK.OFF_ANCHOR_SHIFT),
        }
        for layout, (off, tbl, sp, off_a, ashift) in layouts.items():
            for B in EDGE_B:
                qs = queries(raw, B)

                def call(plain, **kw):
                    return K.fused_probe(qs, off, tbl, cap=hi.cap, spec=sp,
                                         off_a=off_a, ashift=ashift, plain=plain,
                                         **kw)
                n_fp += _cav_calls(K, f"fused_probe {codec} {layout} B={B}",
                                   call, counts)
    # fused_probe at the slot tile's edges: caps 1 to past one tile, bucket
    # starts clamped at rows - cap, keys planted in the lanes' windows
    long_lane = 2 * K.GATE_SLOTS + 3
    clamped_hits = 0
    for codec in CAV_CODECS:
        for cap in (1, 3, 8, 64, long_lane):
            rows = max(4 * cap, 4_096)
            spec, raw = cav_rows(rng, rows, codec)
            off = edge_offsets(rng, rows, cap)
            qs_np = _gate_queries(rng, max(EDGE_B), 2)
            plant_rows(raw, off, cap, qs_np, rng, spec)
            _, clamped = clamped_window(qs_np, off, rows, cap)
            for layout, c in off_layouts(off, raw, spec, dev).items():
                for B in EDGE_B if cap < long_lane else (1, 255, 4_097):
                    qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)

                    def call(plain, **kw):
                        return K.fused_probe(qs, c["off"], c["tbl"], cap=cap,
                                             spec=c["spec"], off_a=c["off_a"],
                                             ashift=c["ashift"], plain=plain, **kw)
                    n_fp += _cav_calls(K, f"fused_probe {codec} {layout} cap={cap}"
                                       f" B={B}", call, counts)
                    hit = call(False, mode="gate", **CAV_LANES)[0]
                    clamped_hits += int(hit[torch.from_numpy(clamped[:B]).to(dev)].sum())
    # fused_probe_aligned: synthetic ladders with planted keys, and a
    # build_aligned ladder of >= 3 levels
    for codec in CAV_CODECS:
        for caps in ((8, 3, 1), (5, 4, 3, 2, 2, 1, 1, 1), (long_lane, 1)):
            sizes = [max(1_024 >> (2 * l), 8) for l in range(len(caps))]
            spec, _ = cav_rows(rng, 1, codec)
            raws = [cav_rows(rng, s * c, codec)[1] for s, c in zip(sizes, caps)]
            qs_np = _gate_queries(rng, max(EDGE_B), 2)
            plant_hits(raws, caps, qs_np, rng, spec)
            layouts = {
                "int32": ([to_device_tensor(r.reshape(s, c * 5), dev)
                           for r, s, c in zip(raws, sizes, caps)], 5, None),
                "packed": ([to_device_tensor(PK.pack_rows(r, spec).reshape(s, -1), dev)
                            for r, s in zip(raws, sizes)], spec[1], spec),
            }
            for layout, (tbls, sw, sp) in layouts.items():
                for B in EDGE_B if caps[0] < long_lane else (1, 255, 4_097):
                    qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)

                    def call(plain, **kw):
                        return K.fused_probe_aligned(qs, tbls, caps, sw, spec=sp,
                                                     plain=plain, **kw)
                    n_al += _cav_calls(K, f"aligned {codec} {layout} caps={caps}"
                                       f" B={B}", call, counts)
                    deep += int(call(False, mode="gate", **CAV_LANES)[0][:, caps[0]:].sum())
        spec, raw = cav_rows(rng, 60_000, codec)
        raw[:14, :2] = (4_242, 17)  # one key past level 0's cap
        ai = H.build_aligned([raw[:, 0], raw[:, 1]], [raw[:, c] for c in range(5)],
                             cover=(0.5, 0.9))
        if ai is None or len(ai.levels) < 3:
            raise AssertionError(f"caveat gate: {codec} ladder has fewer than 3 levels")
        levels = [t for t, _ in ai.levels]
        layouts = {
            "int32": ([to_device_tensor(t, dev) for t in levels], ai.w, None),
            "packed": ([to_device_tensor(PK.pack_rows(t.reshape(-1, ai.w), spec)
                                         .reshape(t.shape[0], -1), dev)
                        for t in levels], spec[1], spec),
        }
        for layout, (tbls, sw, sp) in layouts.items():
            for B in EDGE_B:
                qs = queries(raw, B)

                def call(plain, **kw):
                    return K.fused_probe_aligned(qs, tbls, ai.caps, sw, spec=sp,
                                                 plain=plain, **kw)
                n_al += _cav_calls(K, f"aligned {codec} {layout} build_aligned"
                                   f" caps={tuple(ai.caps)} B={B}", call, counts)
    if not all(counts.values()) or not deep or not clamped_hits:
        raise AssertionError(f"caveat gate edges: an edge never occurred ({counts},"
                             f" hits past level 0={deep}, clamped hits={clamped_hits})")
    log(f"gate caveat planes: fused_probe {n_fp} cases, fused_probe_aligned {n_al}"
        f" cases (codecs {CAV_CODECS}, int32 and packed, expiry lane and none,"
        f" context plane on and off, B {EDGE_B}; off+interleave build_hash"
        f" tables and caps 1/3/8/64/{long_lane} with clamped starts; ladders"
        f" (8,3,1), 8 levels, ({long_lane},1) and build_aligned >= 3 levels)"
        f" bitwise OK on every plane; {counts} ({deep} aligned hits past level 0,"
        f" {clamped_hits} hits on clamped lanes)")


#: until2's threshold: the edges run ``now`` = UNTIL_NOW, a value the rows
#: hold (so ``> now`` fails on equality), and one below it
UNTIL_NOW = 1_000
#: the until columns' codecs: ranges, dictionaries, deltas of column 0
#: (column 2) and of column 1 (column 3), and column 2 a delta of column 1
#: with column 3 a delta of column 2
UNTIL_CODECS = ("range", "dict", "delta", "chain")


def until_rows(rng, n, codec, W=4):
    """``n`` int32 rows (k1, k2, until_a, until_b, then constant columns up
    to ``W``) and their pack spec under ``codec``; keys and until values
    lie around UNTIL_NOW, so compares with it and one below it go both
    ways."""
    from gochugaru_tpu_torch.engine import packed as PK

    v = UNTIL_NOW
    raw = np.full((n, W), 7, np.int32)
    raw[:, 0] = rng.integers(v - 60, v + 61, n)
    raw[:, 1] = rng.integers(v - 8, v + 9, n)
    descs = [PK.col_range(v - 64, v + 64), PK.col_range(v - 8, v + 8)]
    if codec == "range":
        raw[:, 2] = rng.integers(v - 2, v + 3, n)
        raw[:, 3] = rng.integers(v - 3, v + 4, n)
        descs += [PK.col_range(v - 2, v + 2), PK.col_range(v - 3, v + 3)]
    elif codec == "dict":
        vals = (0, v - 1, v, v + 1, 2**31 - 1)
        raw[:, 2] = rng.choice(vals, n)
        raw[:, 3] = rng.choice(vals[:4], n)
        descs += [PK.col_dict(vals), PK.col_dict(vals[:4])]
    elif codec == "delta":
        raw[:, 2] = raw[:, 0] + rng.integers(-2, 3, n)
        raw[:, 3] = raw[:, 1] + rng.integers(-2, 3, n)
        descs += [PK.col_delta(-2, 2, 0), PK.col_delta(-2, 2, 1)]
    else:
        raw[:, 2] = raw[:, 1] + rng.integers(-2, 3, n)
        raw[:, 3] = raw[:, 2] + rng.integers(-1, 2, n)
        descs += [PK.col_delta(-2, 2, 1), PK.col_delta(-1, 1, 2)]
    descs += [PK.col_const(7)] * (W - 4)
    return PK.make_spec(descs), raw


def _until_queries(rng, B, nq):
    """(``nq`` key columns of ``B`` lanes inside until_rows' key ranges,
    5% negative and 5% absent (first key outside its range); the absent
    mask)."""
    v = UNTIL_NOW
    cols = [rng.integers(v - 60, v + 61, B), rng.integers(v - 8, v + 9, B)][:nq]
    absent = rng.random(B) < 0.05
    cols[0] = np.where(absent, v + 500, cols[0])
    return [np.where(rng.random(B) < 0.05, -rng.integers(1, 9, B), c).astype(np.int32)
            for c in cols], absent


#: the reduced modes' lane lengths at their edges: one slot, idle threads
#: in a warp (3, 31), whole warps of lanes (4, 8), the full-warp ballot
#: mask (32), the first shared-flag tile lane (33), and 64
REDUCED_CAPS = (1, 3, 4, 8, 31, 32, 33, 64)


def _reduced_tally(K, tally, capT, B, any_hit, got, clamped=None):
    """Tally one reduced-mode case: hits, flags, hits failing both
    compares, the path its lanes took, ragged last warps and (given the
    mask) clamped lanes with a hit."""
    a, b = got
    n_hit = int(any_hit.sum())
    tally["lanes with a hit"] += n_hit
    tally["flag a"] += int(a.sum())
    tally["flag b"] += int(b.sum())
    tally["hits failing both"] += int((any_hit & ~a & ~b).sum())
    warp = K.reduce_path(capT) == "warp"
    tally["warp-path lanes with a hit" if warp else "tile lanes with a hit"] += n_hit
    if capT == 32:
        tally["full-warp lanes with a hit"] += n_hit
    if warp and B % K.warp_tile(capT)[1]:
        tally["ragged last warps"] += 1
    if clamped is not None:
        cl = torch.from_numpy(clamped[:B]).to(any_hit.device)
        tally["clamped lanes with a hit"] += int(any_hit[cl].sum())


def _reduced_same(K, name, call, now):
    """Mode any and mode until2 at ``now`` and ``now - 1`` of one case,
    kernel == plain bit for bit; returns (the plain any, [until2 at each
    now])."""
    got = call(False, mode="any")
    want = call(True, mode="any")
    if got.dtype != torch.bool or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"any != plain: {name}")
    until = []
    for t in (now, now - 1):
        g = call(False, mode="until2", now=t)
        _gate_same(K, f"until2 {name} now={t}", g, call(True, mode="until2", now=t))
        until.append(g)
    return want, until


def phase_until2_edges(K):
    """Phase 3c's reduced modes over off+interleave tables: fused_probe
    mode any and mode until2 (the warp path for caps up to 32, the
    shared-flag tile beyond) at their edges, kernel == plain bit for bit
    (see the module docstring)."""
    dev = torch.device(DEV)
    rng = np.random.default_rng(2033)
    long_lane = 2 * K.GATE_SLOTS + 3  # past REDUCE_SLOTS: one CTA a lane
    n_cases = 0
    tally = dict.fromkeys(("lanes with a hit", "flag a", "flag b", "hits failing both",
                           "clamped lanes with a hit", "warp-path lanes with a hit",
                           "tile lanes with a hit", "full-warp lanes with a hit",
                           "ragged last warps"), 0)
    cases = [(codec, 4) for codec in UNTIL_CODECS] + [("range", 16)]
    for codec, W in cases:
        for cap in REDUCED_CAPS + (long_lane,):
            rows = max(4 * cap, 4_096)
            spec, raw = until_rows(rng, rows, codec, W)
            off = edge_offsets(rng, rows, cap)
            for nq in (1, 2):
                qs_np, absent = _until_queries(rng, max(EDGE_B), nq)
                tbl = raw.copy()
                plant_rows(tbl, off, cap, qs_np, rng, spec, absent=absent)
                _, clamped = clamped_window(qs_np, off, rows, cap)
                for layout, c in off_layouts(off, tbl, spec, dev).items():
                    for B in EDGE_B if cap < long_lane else (1, 255, 4_097):
                        qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)

                        def call(plain, c=c, qs=qs, cap=cap, **kw):
                            return K.fused_probe(qs, c["off"], c["tbl"], cap=cap,
                                                 spec=c["spec"], off_a=c["off_a"],
                                                 ashift=c["ashift"], plain=plain, **kw)

                        any_hit, until = _reduced_same(
                            K, f"{codec} W={W} {layout} nq={nq} cap={cap} B={B}", call,
                            UNTIL_NOW)
                        n_cases += 1
                        for got in until:
                            _reduced_tally(K, tally, cap, B, any_hit, got, clamped)
    if not all(tally.values()):
        raise AssertionError(f"phase 3c any/until2: an edge never occurred ({tally})")
    log(f"any/until2 edges fused_probe: {n_cases} cases, each mode any and mode"
        f" until2 at two nows (columns 2 and 3 as {UNTIL_CODECS} (W 4; range also"
        f" W 16), caps {REDUCED_CAPS} and {long_lane} (one CTA a lane, B up to"
        f" 4,097), B {EDGE_B}, bucket starts clamped at rows - cap, int32 and"
        f" packed, one and two keys, negative and absent keys, now {UNTIL_NOW} (a"
        f" row value) and {UNTIL_NOW - 1}) bitwise OK; {tally}")


def plant_levels(raws, caps, qs, rng, spec, absent):
    """Write the keys of every other live lane (not in the mask ``absent``)
    into a random slot of the row its salted hash picks at a random level
    of nonzero cap, so the reduced modes see hits past level 0; the slot's
    columns that ``spec`` stores as deltas of a key column (or of such a
    delta) move with the key, so the rows still pack.  ``raws[l]`` is
    level l's int32 [rows * cap_l, W] slot array."""
    from gochugaru_tpu_torch.engine.hash import _level_salt
    from gochugaru_tpu_torch.engine.partition import _hash_cols

    live = ~absent
    for q in qs:
        live &= q >= 0
    lanes = np.flatnonzero(live)[::2]
    full = [l for l, c in enumerate(caps) if c]
    lvl = np.array(full)[rng.integers(0, len(full), lanes.shape[0])]
    for l in full:
        pick = lanes[lvl == l]
        rows = raws[l].shape[0] // caps[l]
        salted = [qs[0][pick] ^ np.int32(_level_salt(l))] + [q[pick] for q in qs[1:]]
        r = (_hash_cols(salted) & np.uint32(rows - 1)).astype(np.int64)
        slot = r * caps[l] + rng.integers(0, caps[l], pick.shape[0])
        shift = []
        for c, f in enumerate(spec[2]):
            if c < len(qs):
                shift.append(qs[c][pick].astype(np.int64) - raws[l][slot, c])
            else:
                shift.append(shift[f[2]] if f[2] >= 0 else 0)
        new = [(raws[l][slot, c].astype(np.int64) + d).astype(np.int32)
               for c, d in enumerate(shift)]
        for c, v in enumerate(new):
            raws[l][slot, c] = v


def phase_reduced_edges_aligned(K):
    """Phase 3c's reduced modes over aligned ladders: fused_probe_aligned
    mode any and mode until2 at their edges, kernel == plain bit for bit
    (see the module docstring)."""
    from gochugaru_tpu_torch.engine import packed as PK
    from gochugaru_tpu_torch.engine.device import to_device_tensor

    dev = torch.device(DEV)
    rng = np.random.default_rng(2034)
    long_lane = 2 * K.GATE_SLOTS + 3
    ladders = [(c,) for c in REDUCED_CAPS] + [(c, 3, 1) for c in (1, 3, 8, 64)]
    ladders += [(28, 3, 1), (30, 3), (4, 0, 2), (5, 4, 3, 2, 2, 1, 1, 1),
                (long_lane, 1)]
    n_cases = 0
    tally = dict.fromkeys(("lanes with a hit", "flag a", "flag b", "hits failing both",
                           "warp-path lanes with a hit", "tile lanes with a hit",
                           "full-warp lanes with a hit", "ragged last warps",
                           "lanes with a hit past level 0"), 0)
    cases = [(codec, 4) for codec in UNTIL_CODECS] + [("range", 16)]
    for codec, W in cases:
        spec = until_rows(rng, 1, codec, W)[0]
        for caps in ladders:
            capT = sum(caps)
            sizes = [max(1_024 >> (2 * l), 8) for l in range(len(caps))]
            for nq in (1, 2):
                qs_np, absent = _until_queries(rng, max(EDGE_B), nq)
                raws = [until_rows(rng, s * c, codec, W)[1] for s, c in zip(sizes, caps)]
                plant_levels(raws, caps, qs_np, rng, spec, absent)
                layouts = {
                    "int32": ([to_device_tensor(r.reshape(s, c * W), dev)
                               for r, s, c in zip(raws, sizes, caps)], W, None),
                    "packed": ([to_device_tensor(PK.pack_rows(r, spec).reshape(s, -1), dev)
                                for r, s in zip(raws, sizes)], spec[1], spec),
                }
                for layout, (tbls, sw, sp) in layouts.items():
                    for B in EDGE_B if capT < long_lane else (1, 255, 4_097):
                        qs = tuple(torch.from_numpy(q[:B]).to(dev) for q in qs_np)

                        def call(plain, tbls=tbls, sw=sw, sp=sp, qs=qs, caps=caps, **kw):
                            return K.fused_probe_aligned(qs, tbls, caps, sw, spec=sp,
                                                         plain=plain, **kw)

                        any_hit, until = _reduced_same(
                            K, f"aligned {codec} W={W} {layout} nq={nq} caps={caps}"
                            f" B={B}", call, UNTIL_NOW)
                        n_cases += 1
                        for got in until:
                            _reduced_tally(K, tally, capT, B, any_hit, got)
                        if len(caps) > 1:
                            hit = call(True, mode="gate", now=0)[0]
                            tally["lanes with a hit past level 0"] += int(
                                hit[:, caps[0]:].any(-1).sum())
    # phase 3b's >= 3-level ladders from build_aligned
    for layout, (qs, tbls, caps, sw, spec, _e) in aligned_ladders(dev).items():
        for B in EDGE_B:
            qb = tuple(torch.cat([q, q])[:B] for q in qs)

            def call(plain, tbls=tbls, sw=sw, spec=spec, qb=qb, caps=caps, **kw):
                return K.fused_probe_aligned(qb, tbls, caps, sw, spec=spec,
                                             plain=plain, **kw)

            any_hit, until = _reduced_same(K, f"aligned ladder {layout} B={B}", call,
                                           5_000)
            n_cases += 1
            for got in until:
                _reduced_tally(K, tally, sum(caps), B, any_hit, got)
    if not all(tally.values()):
        raise AssertionError(f"phase 3c aligned any/until2: an edge never occurred"
                             f" ({tally})")
    log(f"any/until2 edges fused_probe_aligned: {n_cases} cases, each mode any and"
        f" mode until2 at two nows (columns 2 and 3 as {UNTIL_CODECS} (W 4; range"
        f" also W 16), ladders {ladders} (B up to 4,097 past one tile) and the"
        f" build_aligned 3-level ladders, B {EDGE_B}, int32 and packed, one and two"
        f" keys, negative and absent keys, keys planted past level 0) bitwise OK;"
        f" {tally}")


def _fill_huge(rows, w, dev):
    """int32[rows, w] filled on the device with a hash of each element's
    index (chunked: no int64 temporary of the whole table)."""
    t = torch.empty((rows, w), dtype=torch.int32, device=dev)
    flat = t.view(-1)
    step = 1 << 27
    for a in range(0, flat.numel(), step):
        idx = torch.arange(a, min(a + step, flat.numel()), dtype=torch.int64, device=dev)
        flat[a:a + idx.numel()] = ((idx * 2654435761) >> 3).to(torch.int32)
    return t


def phase_block_huge(K, rows):
    """Block mode on one int32 table of ``rows`` x 5 elements for each
    kernel (2^29 rows: 2.7e9 elements, past int32 addressing), lanes
    whose rows lie past element 2^31, kernel == plain."""
    from gochugaru_tpu_torch.engine.hash import bucket_of

    dev = torch.device(DEV)
    rng = np.random.default_rng(2028)
    B, cap, W = 65_537, 8, 5
    qs = _edge_queries(rng, B, 2, dev)
    t0 = time.perf_counter()
    tbl = _fill_huge(rows, W, dev)
    size = 4_096
    off = np.sort(rng.integers(0, rows + 1, size + 1)).astype(np.int32)
    off_t = torch.from_numpy(off).to(dev)
    kw = dict(cap=cap, mode="block")
    _same(K, f"fused_probe on {rows} x {W}",
          K.fused_probe(qs, off_t, tbl, **kw), K.fused_probe(qs, off_t, tbl, plain=True, **kw))
    start = off_t[bucket_of(qs, size)].long().clamp(0, rows - cap)
    past = int((start * W >= 2**31).sum())
    # gate and until2 on the same table, every other live lane's keys
    # planted in row (lane mod cap) of its window; expiry column 4
    live_q = torch.nonzero((qs[0] >= 0) & (qs[1] >= 0)).flatten()[::2]
    at = (start[live_q] + live_q % cap) * W
    flat = tbl.view(-1)
    flat[at], flat[at + 1] = qs[0][live_q], qs[1][live_q]
    reduced, outs = {}, {}
    for mode, mkw in (("gate", dict(exp_lane=4)), ("until2", {}), ("any", {})):
        kw = dict(cap=cap, mode=mode, now=0, **mkw)
        got = _outs(K.fused_probe(qs, off_t, tbl, **kw))
        _gate_same(K, f"fused_probe {mode} on {rows} x {W}", got,
                   _outs(K.fused_probe(qs, off_t, tbl, plain=True, **kw)))
        reduced[mode] = [int(g.sum()) for g in got]
        outs[mode] = got
    if not (reduced["gate"][0] > reduced["gate"][1] > 0 and all(reduced["until2"])
            and all(reduced["any"])):
        raise AssertionError(f"phase 3c: the huge gate / until2 / any calls saw no"
                             f" hit, no expired hit or no set flag ({reduced})")
    far = start * W >= 2**31
    hit_past = int((outs["until2"][0] | outs["until2"][1])[far].sum())
    any_past = int(outs["any"][0][far].sum())
    del tbl, flat
    # aligned: level 0 of rows / 8 rows x 8 slots x 5 columns, level 1 small
    lv0 = _fill_huge(rows // 8, 8 * W, dev)
    lv1 = _fill_huge(1_024, 3 * W, dev)
    got = K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W)
    _same(K, f"aligned on {rows // 8} x {8 * W}", got,
          K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W, plain=True))
    past_al = int((bucket_of(qs, rows // 8) * (8 * W) >= 2**31).sum())
    # aligned gate on the same levels, every other lane's keys planted in
    # slot (lane mod 8) of its level-0 row, expiry column 4
    live_q = torch.nonzero((qs[0] >= 0) & (qs[1] >= 0)).flatten()[::2]
    at = (bucket_of([q[live_q] for q in qs], rows // 8) * 8 + live_q % 8) * W
    flat = lv0.view(-1)
    flat[at], flat[at + 1] = qs[0][live_q], qs[1][live_q]
    kw = dict(mode="gate", now=0, exp_lane=4)
    got = K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W, **kw)
    _gate_same(K, f"aligned gate on {rows // 8} x {8 * W}", got,
               K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W, plain=True, **kw))
    gate_hits = int(got[0].sum())
    if not gate_hits or not bool((got[0] & ~got[1]).any()):
        raise AssertionError("phase 3c: the huge gate call saw no hit or no"
                             " expired hit")
    # aligned any and until2 on the same levels (capT 11: the warp path)
    far_al = bucket_of(qs, rows // 8) * (8 * W) >= 2**31
    al = {}
    for mode in ("any", "until2"):
        kw = dict(mode=mode, now=0)
        got = _outs(K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W, **kw))
        _gate_same(K, f"aligned {mode} on {rows // 8} x {8 * W}", got,
                   _outs(K.fused_probe_aligned(qs, [lv0, lv1], (8, 3), W, plain=True,
                                               **kw)))
        al[mode] = [int(g.sum()) for g in got] + [int(got[0][far_al].sum())]
    if not (al["any"][0] and all(al["until2"][:2])):
        raise AssertionError(f"phase 3c: the huge aligned any / until2 calls saw no"
                             f" hit or no set flag ({al})")
    del lv0, lv1
    if rows * W > 2**31 and not (past and past_al and hit_past and any_past
                                 and al["any"][-1]):
        raise AssertionError("phase 3c: no lane read past element 2^31")
    log(f"block edges past 2^31 elements: {rows} x {W} int32 ({rows * W} elements),"
        f" {B} lanes, {past} (fused_probe block, gate, until2 and any) and {past_al}"
        f" (aligned block, gate, any and until2) of them past element 2^31, bitwise"
        f" OK; fused_probe gate (hit, live) {reduced['gate']}, until2"
        f" {reduced['until2']} ({hit_past} until2 lanes past 2^31 with a flag), any"
        f" {reduced['any']} ({any_past} past 2^31); aligned gate {gate_hits} hits,"
        f" any (hits, past 2^31) {al['any']}, until2 (a, b, a past 2^31)"
        f" {al['until2']} ({time.perf_counter() - t0:.1f} s)")


def phase_config4(K, edges):
    """Phase 8: BASELINE config 4 at ``edges`` edges, both layouts on one
    snapshot (see the module docstring)."""
    t0 = time.perf_counter()
    cs, snap, q, names, ctx = build_config4(edges)
    log(f"config4: world built in {time.perf_counter() - t0:.2f}s;"
        f" stored contexts={len(snap.contexts)}"
        + (f"; reduced: edges {CONFIG4_EDGES} -> {edges} (--edges4)"
           if edges < CONFIG4_EDGES else ""))
    # the batch as published checks `access`, which the permission fold
    # serves (its pfx block probe, the tri VM on the block's caveat
    # columns); the same checks of the `holder` relation take the
    # direct-edge gate with its caveat planes
    hq = (q[0], np.full_like(q[1], cs.slot_of_name["holder"]), q[2])
    h_names = [(rt, rid, "holder", st, sid) for rt, rid, _p, st, sid in names]
    planes = {}
    for label, cfg in (("config4", {}), ("config4 aligned", ALIGNED)):
        ek, ep, ds, dk = check_world(label, cs, snap, q, names, K, ctx=ctx, **cfg)
        dh = check_batch_phase(label + " holder", cs, snap, ek, ep, ds, hq,
                               h_names, ctx)
        if cfg:
            same_planes(label, dk, planes["access"])
            same_planes(label + " holder", dh, planes["holder"])
        planes = {"access": dk, "holder": dh}
        LATENCY_WORLDS[label] = dict(ek=ek, ep=ep, ds=ds, q=q, hq=hq, ctx=ctx)
        del ek, ep, ds


#: full-prepare seconds of each check_world call, by name
PREPARE_S = {}
#: device MiB of each world's prepared snapshot, and the checks/s of its
#: batch ({"kernels": ..., "plain": ...}), by world name
DEVICE_MIB = {}
RATES = {}
#: the prepared snapshots phase 13 reuses, by world name: engines (kernels
#: and plain), the DeviceSnapshot, the batch, and config 4's contexts
LATENCY_WORLDS = {}


def check_world(name, cs, snap, q, names, K, ctx=None, **cfg):
    """Prepare once (``cfg`` overrides EngineConfig fields), then
    ``check_batch_phase`` on the batch.  Returns the engines, the
    snapshot and the kernel path's planes."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig

    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None, **cfg), device=DEV)
    ep = DeviceEngine(cs, EngineConfig(kernels=False, **cfg), device=DEV)
    t0 = time.perf_counter()
    ds = ek.prepare(snap)
    if DEV == "cuda":
        torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    PREPARE_S[name] = prepare_s
    DEVICE_MIB[name] = sum(v.nbytes for v in ds.arrays.values()) / 2**20
    meta = ds.flat_meta
    log(f"{name}: edges={snap.num_edges} nodes={snap.num_nodes}"
        f" prepare_s={prepare_s:.3f}"
        f" device_MiB={DEVICE_MIB[name]:.1f}"
        f" fold={bool(meta.fold_pairs)} tindex={meta.has_tindex}"
        f" rc={meta.rc_slots} ovf={meta.has_ovf}")
    if cfg.get("flat_aligned"):
        point = ["ehx", "usgx", "argx", "clx", "pusx", "ovfx", "tx", "pfx"]
        point += [f"rc{ts}gx" for ts, _c, _f in meta.rc_slots]
        kept = [k for k in point if k in ds.arrays]
        al_mib = sum(v.nbytes for k, v in ds.arrays.items()
                     if "_al" in k) / 2**20
        log(f"{name}: aligned tables (table, w, caps)={list(meta.aligned)}"
            f" aligned MiB={al_mib:.1f}; point tables kept off+interleave={kept}")
        if not meta.aligned:
            raise AssertionError(f"{name}: no table went aligned")
    if ek.caveat_plan is not None:
        plan = ek.caveat_plan
        log(f"{name}: caveat plan host_only="
            f"{ {n: bool(plan.host_only[c]) for n, c in cs.caveat_ids.items()} }"
            f" params={plan.num_params} stored contexts={len(snap.contexts)}"
            f" ectx rows={int(ds.arrays['ectx_vi'].shape[0])}"
            f" e_hascav={meta.e_hascav} pf_hascav={meta.pf_hascav}"
            f" packed ehx={dict(meta.packed).get('ehx')}")
    return ek, ep, ds, check_batch_phase(name, cs, snap, ek, ep, ds, q, names, ctx)


def check_batch_phase(name, cs, snap, ek, ep, ds, q, names, ctx=None):
    """One batch on a prepared snapshot: kernels=True vs kernels=False
    planes bitwise; 2,000 sampled rows vs the port's host oracle;
    checks/s of both paths.  ``ctx`` = (q_ctx, qctx_rows): each query's
    request context, through ``check_columns(q_ctx=, qctx_rows=)`` and to
    the oracle; then no row may be conditional (every caveat of such a
    world is device-eligible).  Returns the kernel path's planes."""
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

    q_res, q_perm, q_subj = q
    q_ctx, qctx_rows = ctx if ctx is not None else (None, None)
    kw = dict(q_ctx=q_ctx, qctx_rows=qctx_rows, now_us=EPOCH)
    dk = ek.check_columns(ds, q_res, q_perm, q_subj, **kw)
    dp = ep.check_columns(ds, q_res, q_perm, q_subj, **kw)
    for nm, a, b in zip("dpo", dk, dp):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: plane {nm} differs, kernels vs plain")
    d, p, ovf = dk
    needs_host = (p & ~d) | ovf
    log(f"{name}: B={len(q_res)} planes bitwise equal (kernels vs plain);"
        f" definite={int(d.sum())} host-settled={int(needs_host.sum())}"
        f" conditional={int((p & ~d).sum())} overflow={int(ovf.sum())}")
    if ctx is not None and (p & ~d).any():
        raise AssertionError(f"{name}: {int((p & ~d).sum())} conditional rows")
    programs = {n: compile_cel(n, c.params, c.expression)
                for n, c in cs.schema.caveats.items()}
    oracle = SnapshotOracle(snap, programs, now_us=EPOCH)
    rng = np.random.default_rng(99)
    sample = rng.choice(len(q_res), min(2000, len(q_res)), replace=False)
    bad = 0
    for i in sample:
        rt, rid, perm, st, sid = names[i]
        qc = qctx_rows[q_ctx[i]] if ctx is not None and q_ctx[i] >= 0 else None
        want = oracle.check(rt, rid, perm, st, sid, "", context=qc,
                            now_us=EPOCH) == T
        got = bool(d[i]) if not needs_host[i] else want
        bad += got != want
    if bad:
        raise AssertionError(f"{name}: {bad} of {len(sample)} sampled rows disagree with the oracle")
    log(f"{name}: {len(sample)} sampled rows agree with the host oracle")
    # the bulk Check end to end (lowering, dispatch, device->host fetch;
    # check_columns returns host arrays, so each call has synchronised),
    # plain and kernel paths in turns: plain, kernel, kernel, plain, x2
    times = {"kernels": [], "plain": []}
    for order in (("plain", "kernels", "kernels", "plain"),) * 2:
        for which in order:
            eng = ek if which == "kernels" else ep
            ts = time.perf_counter()
            eng.check_columns(ds, q_res, q_perm, q_subj, **kw)
            times[which].append(time.perf_counter() - ts)
    med = {k: float(np.median(v)) for k, v in times.items()}
    RATES[name] = {k: len(q_res) / v for k, v in med.items()}
    log(f"{name}: checks_per_s"
        f" kernels={len(q_res) / med['kernels']:.1f}"
        f" plain={len(q_res) / med['plain']:.1f}"
        f" batch_s kernels={[round(t, 5) for t in times['kernels']]}"
        f" plain={[round(t, 5) for t in times['plain']]}")
    return dk


def same_planes(name, a, b):
    """The aligned snapshot's planes equal the off+interleave one's."""
    for nm, x, y in zip("dpo", a, b):
        if not np.array_equal(x, y):
            raise AssertionError(f"{name}: plane {nm} differs from the"
                                 " off+interleave snapshot's")
    log(f"{name}: planes equal the off+interleave snapshot's")


def _blocks(it):
    return [np.asarray(b) for b in it]


def _same_blocks(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def phase_lookups(cs, snap, ek, ep, ds, scale, card, name="config3", want=None):
    """Config 3's lookups on the snapshot phase 5 prepared (subjects of
    benchmarks/bench8_lookup.py:91-117): kernels vs plain candidate
    blocks, the lookup metrics, and full answers vs the host walker — or,
    when ``want`` holds an earlier snapshot's answers (which equalled
    the walker's), vs those.  Returns this snapshot's answers."""
    from gochugaru_tpu_torch.engine import lookup as lm
    from gochugaru_tpu_torch.engine import spmv
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle

    if not spmv.frontier_ok(ek, ds):
        raise AssertionError(f"{name}: the device frontier must serve lookups")
    meta = ds.flat_meta
    log(f"{name} lookups: rv_cap={meta.rv_cap} ra_cap={meta.ra_cap}"
        f" fw_cap={meta.fw_cap} rev MiB="
        f"{sum(ds.arrays[k].nbytes for k in ds.arrays if k[:2] in ('rv', 'ra', 'fw')) / 2**20:.1f}")
    interner = snap.interner
    oracle = SnapshotOracle(snap, now_us=EPOCH)
    fac = lambda: oracle  # noqa: E731
    n_users = max(int(100_000 * scale), 100)
    n_docs = max(int(1_000_000 * scale), 1_000)
    users = np.array([interner.lookup("user", f"u{i}") for i in range(n_users)], np.int64)
    rng = np.random.default_rng(11)
    sample = [int(u) for u in rng.choice(users, 48, replace=False)]
    doc_ids = [f"d{i}" for i in np.random.default_rng(13).choice(n_docs, 16, replace=False)]
    rtid = interner.type_lookup("document")
    gtid = interner.type_lookup("group")
    member, viewer = cs.slot_of_name["member"], cs.slot_of_name["viewer"]
    bulk = []
    for i in range(64):
        f = interner.lookup("folder", f"f{i}")
        m = (snap.e_res == f) & (snap.e_rel == viewer) & (snap.e_srel1 > 0)
        for g in snap.e_subj[m]:
            if snap.node_type[int(g)] == gtid and int(g) not in bulk:
                bulk.append(int(g))
    bulk = bulk[:6]
    if not bulk:
        raise AssertionError(f"{name}: no group views a near-root folder")
    sid = lambda n: interner.key_of(n)[1]  # noqa: E731

    # kernels vs plain: candidate blocks, block for block
    stk, stp = spmv.FrontierState(ek, ds), spmv.FrontierState(ep, ds)
    n_blocks = n_cand = 0
    queries = [("res", u, -1) for u in sample] + [("res", g, member) for g in bulk]
    queries += [("subj", d, -1) for d in doc_ids]
    bulk_of = {}
    for kind, s, srel in queries:
        if kind == "res":
            gen = lambda st: st.resource_candidates(rtid, s, srel, -1, EPOCH)  # noqa: E731
        else:
            res_node, _p, srel_s, stid, wc = lm._resolve_subjects(
                ds, "document", s, "view", "user", "")
            gen = lambda st: st.subject_candidates(res_node, stid, srel_s, wc, EPOCH)  # noqa: E731
        bk, bp = _blocks(gen(stk)), _blocks(gen(stp))
        if not _same_blocks(bk, bp):
            raise AssertionError(f"{name} lookup {kind} {s}: kernel and plain candidate blocks differ")
        n_blocks += len(bk)
        n_cand += sum(b.shape[0] for b in bk)
        if srel == member:
            bulk_of[s] = sum(b.shape[0] for b in bk)
    heavy = max(bulk, key=lambda g: bulk_of[g])
    log(f"{name} lookups: {len(queries)} queries, {n_blocks} candidate blocks,"
        f" {n_cand} candidates, kernels == plain block for block;"
        f" bulk subjects {len(bulk)} (heaviest {bulk_of[heavy]} candidates)")

    # metrics (kernel path, host clock; each call ends on host arrays)
    mixed_s, mixed_ans = [], {}
    for u in sample:
        t0 = time.perf_counter()
        mixed_ans[u] = lm.lookup_resources_device(
            ek, ds, "document", "view", "user", sid(u), "", now_us=EPOCH,
            oracle_factory=fac)
        mixed_s.append(time.perf_counter() - t0)
    subj_s, subj_ans = [], {}
    for d in doc_ids:
        t0 = time.perf_counter()
        subj_ans[d] = lm.lookup_subjects_device(
            ek, ds, "document", d, "view", "user", "", now_us=EPOCH,
            oracle_factory=fac)
        subj_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    total = 0
    for g in bulk:
        for b in stk.resource_candidates(rtid, g, member, -1, EPOCH):
            total += b.shape[0]
    bulk_dt = time.perf_counter() - t0
    ds.__dict__.pop("_lookup_streams", None)
    t0 = time.perf_counter()
    page, _cur = lm.lookup_resources_page(
        ek, ds, "document", "view", "group", sid(heavy), "member",
        page_size=1_000, now_us=EPOCH, oracle_factory=fac)
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    heavy_ans = lm.lookup_resources_device(
        ek, ds, "document", "view", "group", sid(heavy), "member",
        now_us=EPOCH, oracle_factory=fac)
    full_s = time.perf_counter() - t0
    if len(page) != min(1_000, len(heavy_ans)):
        raise AssertionError(f"{name}: first page is short")
    log(f"{name} lookups [{card}]: p50 s per mixed-user LookupResources"
        f" {float(np.median(mixed_s))} (48 users, {sum(map(len, mixed_ans.values()))}"
        f" results); p50 s per LookupSubjects {float(np.median(subj_s))}"
        f" (16 docs, {sum(map(len, subj_ans.values()))} results)")
    log(f"{name} lookups [{card}]: bulk candidates/s {total / bulk_dt}"
        f" ({total} candidates, {len(bulk)} group#member subjects, {bulk_dt} s);"
        f" first page (1,000 results) ms {first_ms};"
        f" heaviest full answer s {full_s} ({len(heavy_ans)} resources)")

    answers = (mixed_ans, subj_ans, heavy_ans)
    SPMM[name] = phase_spmm(name, ek, ds, rtid, sample, doc_ids, sid, fac,
                            mixed_ans, subj_ans, card)
    if want is not None:
        if answers != want:
            raise AssertionError(f"{name}: lookup answers differ from the"
                                 " off+interleave snapshot's")
        log(f"{name} lookups: {len(sample) + 1} LookupResources and"
            f" {len(doc_ids)} LookupSubjects answers equal the off+interleave"
            " snapshot's")
        return answers

    # full answers vs the host walker + the same exact filter
    t0 = time.perf_counter()
    walked = [("user", sid(u), "", mixed_ans[u]) for u in sample]
    walked.append(("group", sid(heavy), "member", heavy_ans))
    for stype, s_id, srel, got in walked:
        names = ("document", "view", stype, s_id, srel)
        resolved = lm._resolve_resources(ds, *names)
        _rt, _p, srel_slot, subj_node, wc_node = resolved
        seen = lm._walk_resource_candidates(snap, subj_node, srel_slot, wc_node)
        filt, id_of = lm._res_filter(ek, ds, resolved, names, EPOCH, fac)
        want = sorted(id_of(int(g)) for g in filt(seen[snap.node_type[seen] == rtid]))
        if got != want:
            raise AssertionError(f"{name}: lookup for {stype}:{s_id} differs from the walker")
    for d in doc_ids:
        names = ("document", d, "view", "user", "")
        resolved = lm._resolve_subjects(ds, *names)
        res_node, _p, srel_slot, stid, wc_node = resolved
        cand = lm._walk_subject_candidates(snap, res_node, stid, srel_slot, wc_node)
        filt, id_of = lm._subj_filter(ek, ds, resolved, names, EPOCH, fac)
        if subj_ans[d] != sorted(id_of(int(g)) for g in filt(cand)):
            raise AssertionError(f"{name}: lookup_subjects for {d} differs from the walker")
    log(f"{name} lookups: {len(walked)} LookupResources and {len(doc_ids)}"
        f" LookupSubjects answers equal the host walker's"
        f" ({time.perf_counter() - t0:.1f} s incl. the transposed-index build)")
    return answers


#: the spmm: line's entries, one per layout phase_lookups ran
SPMM = {}
#: lookups a direction whose fused graph replay is held to the eager run
SPMM_EAGER = 8


def _p50_p99_ms(xs):
    return (float(np.percentile(xs, 50)) * 1e3,
            float(np.percentile(xs, 99)) * 1e3)


def phase_spmm(name, ek, ds, rtid, sample, doc_ids, sid, fac, mixed_ans,
               subj_ans, card):
    """The fused K-hop lookup program (engine/spmm.py) on phase 5's
    snapshot, against the looped per-hop path on the same snapshot (a
    second FrontierState whose fused server is None): each of
    phase_lookups' 48 LookupResources and 16 LookupSubjects through both
    paths, timed (host clock, warm: each graph was captured by
    phase_lookups' first lookups), answers fused == looped == the ones
    phase_lookups held to the walker; counters per lookup show which the
    fused program served (one spmm dispatch, no looped dispatch) and
    which took more than one hop on the looped path.  Then the graph
    replay == the eager run of the same K rounds on ``SPMM_EAGER``
    lookups a direction (launches uncounted), the cause of each
    fallback (the round budget, when the same program with 4K rounds
    serves; else a capacity), replay device ms (CUDA events around the
    replay alone) and the capture ms of each direction.  Fails unless at
    least one multi-hop lookup of each direction was served by the fused
    program."""
    from gochugaru_tpu_torch.engine import kernels as K
    from gochugaru_tpu_torch.engine import lookup as lm
    from gochugaru_tpu_torch.engine import spmv
    from gochugaru_tpu_torch.utils.metrics import default as mt

    fused = spmv.state_for(ek, ds)
    fl = fused._spmm
    if fl is None:
        raise AssertionError(f"{name}: the fused lookup program must serve")
    looped = spmv.FrontierState(ek, ds)
    looped._spmm = None
    keys = ("spmm.dispatches", "spmm.fallbacks", "lookup.dispatches",
            "lookup.hops", "lookups.fused")
    c_phase = {k: mt.counter(k) for k in keys}

    def one(st, kind, arg):
        ds.__dict__["_frontier_state"] = st
        ds.__dict__.pop("_lookup_streams", None)
        c0 = {k: mt.counter(k) for k in keys}
        t0 = time.perf_counter()
        if kind == "res":
            got = lm.lookup_resources_device(
                ek, ds, "document", "view", "user", sid(arg), "",
                now_us=EPOCH, oracle_factory=fac)
        else:
            got = lm.lookup_subjects_device(
                ek, ds, "document", arg, "view", "user", "", now_us=EPOCH,
                oracle_factory=fac)
        dt = time.perf_counter() - t0
        return got, dt, {k: mt.counter(k) - c0[k] for k in keys}

    out = {"layout": name, "card": card, "F": fl.kern.F, "E": fl.kern.E,
           "Ea": fl.kern.Ea, "C": fl.kern.C, "K": fl.kern.K}
    try:
        for kind, args, want in (("res", sample, mixed_ans),
                                 ("subj", doc_ids, subj_ans)):
            ts = {"fused": [], "looped": []}
            served = served_multi = 0
            for a in args:
                got_f, dt_f, cf = one(fused, kind, a)
                got_l, dt_l, cl = one(looped, kind, a)
                if not got_f == got_l == want[a]:
                    raise AssertionError(f"{name} {kind} {a}: fused, looped and"
                                         " walker-held answers differ")
                ts["fused"].append(dt_f)
                ts["looped"].append(dt_l)
                ok = (cf["spmm.dispatches"] == 1 and cf["spmm.fallbacks"] == 0
                      and cf["lookup.dispatches"] == 0)
                served += ok
                served_multi += ok and cl["lookup.hops"] >= 2
            fp50, fp99 = _p50_p99_ms(ts["fused"])
            lp50, lp99 = _p50_p99_ms(ts["looped"])
            out[kind] = {
                "lookups": len(args), "fused_p50_ms": fp50, "fused_p99_ms": fp99,
                "looped_p50_ms": lp50, "looped_p99_ms": lp99,
                "served": served, "served_multihop": served_multi,
                "fallback_share": (len(args) - served) / len(args),
            }
            if not served_multi:
                raise AssertionError(f"{name}: no multi-hop {kind} lookup was"
                                     " served by the fused program")
    finally:
        ds.__dict__["_frontier_state"] = fused
    out["counters"] = {k: mt.counter(k) - c_phase[k] for k in keys}

    # graph replay == the eager run of the same K rounds, bit for bit
    n_eq = {"res": 0, "subj": 0}
    with uncounted(K):
        for u in sample[:SPMM_EAGER]:
            g = fl.resources(rtid, u, -1, -1, EPOCH)
            e = fl.resources(rtid, u, -1, -1, EPOCH, run="rounds")
            if not _same_fused(g, e):
                raise AssertionError(f"{name}: fused resources replay != eager for {u}")
            n_eq["res"] += 1
        for d in doc_ids[:SPMM_EAGER]:
            res_node, _p, srel_s, stid, wc = lm._resolve_subjects(
                ds, "document", d, "view", "user", "")
            g = fl.subjects(res_node, stid, srel_s, wc, EPOCH)
            e = fl.subjects(res_node, stid, srel_s, wc, EPOCH, run="rounds")
            if not _same_fused(g, e):
                raise AssertionError(f"{name}: fused subjects replay != eager for {d}")
            n_eq["subj"] += 1
    out["replay_eq_eager"] = n_eq

    # why the fallbacks overflowed: the same program, eager, with four
    # times the round budget — served then means K was too short, else a
    # capacity (frontier, emission, candidates) overflowed
    import copy

    deep = copy.copy(fl.kern)
    deep.K = 4 * fl.kern.K
    causes = {}
    with uncounted(K), torch.no_grad():
        for kind, args in (("res", sample), ("subj", doc_ids)):
            c = {"rounds": 0, "capacity": 0}
            for a in args:
                if kind == "res":
                    inp = fl.resources_inputs(rtid, a, -1, -1, EPOCH)
                    flag = 1
                else:
                    res_node, _p, srel_s, stid, wc = lm._resolve_subjects(
                        ds, "document", a, "view", "user", "")
                    inp = fl.subjects_inputs(res_node, stid, srel_s, wc, EPOCH)
                    flag = 3
                dev_inp = torch.from_numpy(inp).to(ds.arrays["rvx"].device)
                if not int(fl.kern.run(kind, fused.kern, fl.tables, fused,
                                       dev_inp, False)[flag]):
                    continue
                ovf = int(deep.run(kind, fused.kern, fl.tables, fused, dev_inp,
                                   False)[flag])
                c["capacity" if ovf else "rounds"] += 1
            causes[kind] = c
    out["overflow_causes"] = causes

    # replay device ms (the graph alone) and capture ms, per direction
    replay = {}
    for kind, make in () if DEV != "cuda" else (("res", lambda u: fl.resources_inputs(rtid, u, -1, -1, EPOCH)),
                       ("subj", lambda d: fl.subjects_inputs(
                           *[lm._resolve_subjects(ds, "document", d, "view", "user", "")[i]
                             for i in (0, 3, 2, 4)], EPOCH))):
        g = fl.graphs[kind]
        ms = []
        for a in (sample if kind == "res" else doc_ids):
            g.inp.copy_(torch.from_numpy(make(a)))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.graph.replay()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        replay[kind] = {"p50_ms": float(np.median(ms)), "max_ms": float(max(ms)),
                        "launches": dict(g.modes)}
    out["replay"] = replay
    out["capture_ms"] = {k: v * 1e3 for k, v in fl.capture_s.items()}
    out["captures"] = dict(fl.captures)
    log(f"{name} spmm [{card}]: {json.dumps(out)}")
    return out


def _same_fused(a, b):
    if a is None or b is None:
        return a is None and b is None
    return _same_blocks(a, b)


def phase_overflow(K, **cfg):
    """The closure-overflow world (``cfg`` overrides EngineConfig
    fields): kernels vs plain planes, device-definite rows vs the
    oracle."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.oracle import Oracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot
    from gochugaru_tpu_torch import rel

    rels, n_docs, n_users = ovf_rels(5, 20_000)
    cs = compile_schema(parse_schema(OVF_SCHEMA))
    snap = build_snapshot(1, cs, Interner(), rels, epoch_us=EPOCH)
    rng = random.Random(6)
    checks = []
    for _ in range(4096):
        subj = (f"team:t{rng.randrange(32)}#member" if rng.random() < 0.15
                else f"user:u{rng.randrange(n_users)}")
        checks.append(rel.must_from_triple(
            f"doc:d{rng.randrange(n_docs)}",
            rng.choice(["view", "edit", "reader"]), subj))
    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None,
                                       closure_source_cap=4, **cfg), device=DEV)
    ep = DeviceEngine(cs, EngineConfig(kernels=False, closure_source_cap=4, **cfg),
                      device=DEV)
    ds = ek.prepare(snap)
    if not ds.flat_meta.has_ovf:
        raise AssertionError("closure-overflow world did not overflow")
    al = [k for k, _w, _c in ds.flat_meta.aligned]
    if cfg.get("flat_aligned") and not {"ovfx", "clx"} <= set(al):
        raise AssertionError(f"closure-overflow world: ovfx/clx not aligned ({al})")
    dk = ek.check_batch(ds, checks, now_us=EPOCH)
    dp = ep.check_batch(ds, checks, now_us=EPOCH)
    for nm, a, b in zip("dpo", dk, dp):
        if not np.array_equal(a, b):
            raise AssertionError(f"overflow world: plane {nm} differs")
    d, p, ovf = dk
    oracle = Oracle(cs, rels, now_us=EPOCH)
    needs = (p & ~d) | ovf
    bad = sum(
        (oracle.check_relationship(r, now_us=EPOCH) == T) != bool(d[i])
        for i, r in enumerate(checks) if not needs[i]
    )
    if bad:
        raise AssertionError(f"overflow world: {bad} device-definite rows disagree with the oracle")
    log(f"closure-overflow world{' (aligned: ' + ','.join(al) + ')' if al else ''}:"
        f" {len(checks)} checks, planes bitwise equal,"
        f" overflow rows={int(ovf.sum())}, definite rows agree with the oracle")


def client_triples(rng):
    """The client phases' RBAC world: 8 teams of 60 users, 4 orgs, 50
    repos."""
    triples = []
    for t in range(8):
        for u in rng.sample(range(60), 8):
            triples.append((f"team:t{t}", "member", f"user:u{u}"))
    for o in range(4):
        triples.append((f"org:o{o}", "admin", f"user:u{rng.randrange(60)}"))
        triples.append((f"org:o{o}", "member", f"team:t{rng.randrange(8)}#member"))
    for r in range(50):
        triples.append((f"repo:r{r}", "org", f"org:o{rng.randrange(4)}"))
        triples.append((f"repo:r{r}", "maintainer", f"team:t{rng.randrange(8)}#member"))
        triples.append((f"repo:r{r}", "reader", f"user:u{rng.randrange(60)}"))
    return triples


def phase_client(**cfg):
    """The client path (``cfg`` overrides EngineConfig fields through
    ``with_engine_config``) vs the oracle."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
    from gochugaru_tpu_torch.engine.oracle import Oracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    opts = (with_engine_config(EngineConfig(**cfg)),) if cfg else ()
    c = new_evaluator(*opts) if DEV == "cuda" else new_evaluator(*opts, device=DEV)
    if c.device.type != DEV:
        raise AssertionError(f"client is not on {DEV}")
    c.write_schema(ctx, RBAC_SCHEMA)
    rng = random.Random(17)
    rels = [rel.must_from_triple(*t) for t in client_triples(rng)]
    txn = rel.Txn()
    for r in rels:
        txn.create(r)
    rev = c.write(ctx, txn)
    oracle = Oracle(compile_schema(parse_schema(RBAC_SCHEMA)), rels)
    checks = [rel.must_from_triple(f"repo:r{rng.randrange(50)}",
                                   rng.choice(["read", "admin"]),
                                   f"user:u{rng.randrange(60)}") for _ in range(64)]
    want = [oracle.check_relationship(r) == T for r in checks]
    for cs in (consistency.full(), consistency.at_least(rev)):
        got = c.check(ctx, cs, *checks)
        if got != want:
            raise AssertionError("client verdicts disagree with the oracle")
        if c.check_one(ctx, cs, checks[0]) != want[0]:
            raise AssertionError("check_one disagrees")
        if c.check_all(ctx, cs, *checks[:5]) != all(want[:5]):
            raise AssertionError("check_all disagrees")
        if c.check_any(ctx, cs, *checks[5:10]) != any(want[5:10]):
            raise AssertionError("check_any disagrees")
    if cfg.get("flat_aligned"):
        ds = c._dsnap_cache[max(c._dsnap_cache)]
        if not ds.flat_meta.aligned:
            raise AssertionError("client snapshot has no aligned table")
    log(f"client path on {DEV} {cfg or ''}: {len(checks)} checks x 2 strategies"
        f" agree with the oracle ({sum(want)} allowed)")
    n_res = 0
    for u in range(0, 60, 7):
        got = list(c.lookup_resources(ctx, consistency.full(), "repo#read", f"user:u{u}"))
        if got != sorted(oracle.lookup_resources("repo", "read", "user", f"u{u}", "")):
            raise AssertionError(f"client lookup_resources for u{u} disagrees with the oracle")
        n_res += len(got)
    for r in range(0, 50, 9):
        got = list(c.lookup_subjects(ctx, consistency.full(), f"repo:r{r}", "admin", "user"))
        if got != sorted(oracle.lookup_subjects("repo", f"r{r}", "admin", "user", "")):
            raise AssertionError(f"client lookup_subjects for r{r} disagrees with the oracle")
    ids, cursor, pages = [], None, 0
    while True:
        page = c.lookup_resources_page(ctx, consistency.at_least(rev), "repo#read",
                                       "team:t1#member", page_size=3, cursor=cursor)
        ids += page.ids
        pages += 1
        cursor = page.cursor
        if cursor is None:
            break
    want_ids = sorted(oracle.lookup_resources("repo", "read", "team", "t1", "member"))
    if len(ids) != len(set(ids)) or sorted(ids) != want_ids or pages < 2:
        raise AssertionError("client paged lookup disagrees with the oracle")
    log(f"client path on {DEV} {cfg or ''}: lookup_resources ({n_res} results), lookup_subjects"
        f" and a {pages}-page cursor walk ({len(ids)} results) agree with the oracle")


#: a schema that declares a caveat no relationship uses
FAULT1_SCHEMA = """
caveat ip_ok(x int) { x > 3 }
definition user {}
definition doc {
    relation reader: user | user with ip_ok
    permission view = reader
}
"""

CLIENT_CAVEAT_SCHEMA = """
caveat same_tenant(tenant string, edge_tenant string, tier int) {
    tenant == edge_tenant && tier >= 1
}
caveat quota(used int, limit int) { used * 2 < limit }
caveat before(at timestamp, until timestamp) { at < until }
caveat owner_is(m map<string>) { m.owner == 'alice' }
definition user {}
definition team { relation member: user | user with quota }
definition doc {
    relation team: team
    relation reader: user | user with same_tenant | user with quota | user with before | user with owner_is | team#member
    permission view = reader + team->member
}
"""


def _caveat_client_rels(rel, rng):
    """Relationships of the caveated client world: every caveat kind with
    a full, a partial or an empty stored context, caveated membership,
    plain grants."""
    stored = {
        "same_tenant": lambda: {"edge_tenant": rng.choice(["acme", "beta"]),
                                **({"tier": rng.choice([0, 2])} if rng.random() < 0.3 else {})},
        "quota": lambda: {"limit": rng.choice([5, 10, 40])} if rng.random() < 0.7 else {},
        "before": lambda: {"until": rng.choice(["2024-01-01T00:00:00Z",
                                                "2030-01-01T00:00:00Z"])},
        "owner_is": lambda: {"m": {"owner": rng.choice(["alice", "bob"])}},
    }
    rels = []
    for t in range(5):
        for u in rng.sample(range(20), 4):
            r = rel.must_from_triple(f"team:t{t}", "member", f"user:u{u}")
            rels.append(r.with_caveat("quota", stored["quota"]()) if rng.random() < 0.4 else r)
    for d in range(40):
        rels.append(rel.must_from_triple(f"doc:d{d}", "team", f"team:t{rng.randrange(5)}"))
        for u in rng.sample(range(20), 3):
            r = rel.must_from_triple(f"doc:d{d}", "reader", f"user:u{u}")
            if rng.random() < 0.75:
                name = rng.choice(sorted(stored))
                r = r.with_caveat(name, stored[name]())
            rels.append(r)
    return rels


def phase_client_caveats(**cfg):
    """Phase 7's caveated client world (``cfg`` overrides EngineConfig
    fields): the declared-but-unused caveat, then string, int, timestamp
    and host-only caveats written through ``write``, ``check`` with and
    without ``caveat_context`` and the lookups, every answer vs the
    oracle."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.client import new_evaluator, with_engine_config
    from gochugaru_tpu_torch.engine.oracle import Oracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    full = consistency.full()

    def client(schema, rels):
        opts = (with_engine_config(EngineConfig(**cfg)),) if cfg else ()
        c = new_evaluator(*opts) if DEV == "cuda" else new_evaluator(*opts, device=DEV)
        c.write_schema(ctx, schema)
        txn = rel.Txn()
        for r in rels:
            txn.create(r)
        c.write(ctx, txn)
        cs = compile_schema(parse_schema(schema))
        progs = {n: compile_cel(n, d.params, d.expression)
                 for n, d in cs.schema.caveats.items()}
        return c, Oracle(cs, rels, progs)

    # a declared caveat that no relationship uses
    c, oracle = client(FAULT1_SCHEMA, [rel.must_from_triple("doc:d1", "reader", "user:u1")])
    checks = [rel.must_from_triple(f"doc:d{d}", "view", f"user:u{u}")
              for d in (1, 2) for u in (1, 2)]
    if c.check(ctx, full, *checks) != [True, False, False, False]:
        raise AssertionError("declared-caveat world: check disagrees with the oracle")
    if (list(c.lookup_resources(ctx, full, "doc#view", "user:u1")) != ["d1"]
            or list(c.lookup_subjects(ctx, full, "doc:d1", "view", "user")) != ["u1"]):
        raise AssertionError("declared-caveat world: lookups disagree with the oracle")

    rng = random.Random(19)
    rels = _caveat_client_rels(rel, rng)
    c, oracle = client(CLIENT_CAVEAT_SCHEMA, rels)
    contexts = [None, {"tenant": "acme", "tier": 2}, {"tenant": "beta", "tier": 1},
                {"used": 3}, {"used": 30, "limit": 100},
                {"at": "2023-06-01T00:00:00Z"}, {"at": "2026-06-01T00:00:00Z"},
                {"tenant": "acme", "tier": 2, "used": 1, "at": "2025-01-01T00:00:00Z"}]
    checks = []
    for _ in range(400):
        q = rel.must_from_triple(f"doc:d{rng.randrange(42)}", "view",
                                 f"user:u{rng.randrange(21)}")
        qc = rng.choice(contexts)
        checks.append(q.with_caveat("", qc) if qc else q)
    want = [oracle.check_relationship(r) == T for r in checks]
    before = metrics.default.counter("checks.fallback_conditional")
    got = c.check(ctx, full, *checks)
    fallbacks = metrics.default.counter("checks.fallback_conditional") - before
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"caveated client: {bad} verdicts disagree with the oracle")
    engine = c._engine
    host_only = {n: bool(engine.caveat_plan.host_only[i])
                 for n, i in engine.compiled.caveat_ids.items()}
    if host_only != {n: n == "owner_is" for n in host_only}:
        raise AssertionError(f"caveated client: host-only caveats {host_only}")
    n_res = 0
    for u in range(21):
        got_r = list(c.lookup_resources(ctx, full, "doc#view", f"user:u{u}"))
        if got_r != sorted(oracle.lookup_resources("doc", "view", "user", f"u{u}", "")):
            raise AssertionError(f"caveated client: lookup_resources for u{u} disagrees")
        n_res += len(got_r)
    for d in range(0, 42, 3):
        got_s = list(c.lookup_subjects(ctx, full, f"doc:d{d}", "view", "user"))
        if got_s != sorted(oracle.lookup_subjects("doc", f"d{d}", "view", "user", "")):
            raise AssertionError(f"caveated client: lookup_subjects for d{d} disagrees")
    log(f"caveated client on {DEV} {cfg or ''}: declared-but-unused caveat world"
        f" agrees; {len(rels)} relationships, {len(checks)} checks agree with the"
        f" oracle ({sum(want)} allowed, {fallbacks} settled on the host, host-only"
        f" {[n for n, h in host_only.items() if h]}), lookup_resources"
        f" ({n_res} results) and lookup_subjects agree")


class uncounted:
    """Launches inside the block leave K.LAUNCHES and K.LANES as they
    were (comparison and timing launches are not main-path launches)."""

    def __init__(self, K):
        self.K = K

    def __enter__(self):
        self.saved = dict(self.K.LAUNCHES), dict(self.K.LANES)

    def __exit__(self, *exc):
        self.K.LAUNCHES.update(self.saved[0])
        self.K.LANES.update(self.saved[1])
        return False


def _kernel_vs_plain(K, call):
    """(max_abs_err, ms, plain_ms) of ``call(plain)`` on one captured
    main-path input: outputs compared, both sides timed; the launches are
    not counted."""
    with uncounted(K):
        got, want = _outs(call(False)), _outs(call(True))
        err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                  for a, b in zip(got, want))
        ms = time_call(lambda: call(False), 20)
        plain_ms = time_call(lambda: call(True), 3)
    return err, ms, plain_ms


#: mode block's tile budgets (kernels.TILE_BYTES) each block row is also
#: timed under
TILE_SWEEP = (8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024)
#: the gate's slots a CTA (kernels.GATE_SLOTS) the gate rows are also
#: timed under
GATE_SWEEP = (1024, 2048, 4096)
#: the shared-flag tile's most slots a CTA (kernels.REDUCE_SLOTS) each
#: reduced row that runs that tile is also timed under
REDUCE_SWEEP = (256, 512, 1024, 2048)


def fill_ms(shape) -> float:
    """ms of one ``fill_`` of an int32 tensor of ``shape``: the card's
    write rate over block's output, a floor under any kernel writing it."""
    t = torch.empty(tuple(shape), dtype=torch.int32, device=DEV)
    return time_call(lambda: t.fill_(7), 20)


def sweep(K, knob, values, call):
    """{value: ms} of ``call(False)`` with module constant ``K.<knob>``
    set to each of ``values``, each output held to the plain version's;
    the launches are not counted."""
    want = _outs(call(True))
    saved = getattr(K, knob)
    out = {}
    try:
        with uncounted(K):
            for v in values:
                setattr(K, knob, v)
                if not all(torch.equal(a, b) for a, b in zip(_outs(call(False)), want)):
                    raise AssertionError(f"kernel differs from plain at {knob} = {v}")
                out[str(v)] = time_call(lambda: call(False), 20)
    finally:
        setattr(K, knob, saved)
    return out


def _path(K, mode, capT) -> str:
    """The kernel a mode's call runs: ``warp`` / ``tile`` for the reduced
    modes (kernels.reduce_path), ``tile`` for block and gate (the slot
    tile), ``lane`` for runs (one thread a key)."""
    if mode in K.REDUCED:
        return K.reduce_path(capT)
    return "lane" if mode == "runs" else "tile"


def time_reduced(K, mode, row, capT, call, card, name):
    """A reduced row's path, its time on both paths (the warp path forced
    off by ``WARP_REDUCE_CAP`` 0; none when its lanes pass 32 slots) and,
    when it runs the shared-flag tile, its time under each of REDUCE_SWEEP's
    slots a CTA (the row's ``tile_slots``)."""
    row["path"] = _path(K, mode, capT)
    if capT <= 32:
        by = sweep(K, "WARP_REDUCE_CAP", (32, 0), call)
        row["paths"] = {"warp": by["32"], "tile": by["0"]}
    if row["path"] == "tile":
        row["tile_slots"] = sweep(K, "REDUCE_SLOTS", REDUCE_SWEEP, call)
    log(f"time {name}.{mode} [{card}] path={row['path']} by path:"
        f" {row.get('paths')}, by REDUCE_SLOTS: {row.get('tile_slots')}")


def time_mode(K, mode, q_cols, off, tbl, kw, card):
    """One fused_probe mode at one captured main-path call: kernel vs
    plain on its inputs, both timed, and its bound; a kernel-table row
    without ``launches``."""
    kw = dict(kw)
    kw.pop("plain", None)
    n = _lanes(q_cols)
    err, ms, plain_ms = _kernel_vs_plain(
        K, lambda plain: K.fused_probe(q_cols, off, tbl, plain=plain, **kw))
    bound_ms, bound_by = (runs_bound if mode == "runs" else probe_bound)(
        q_cols, off, tbl, kw)
    log(f"time fused_probe.{mode} [{card}]: lanes={n} cap={kw['cap']}"
        f" packed={kw.get('spec') is not None} ms={ms:.5f}"
        f" plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})"
        f" max_abs_err={err}")
    if err:
        raise AssertionError(f"{mode}: kernel differs from plain at main-path shape")
    row = {
        "name": f"fused_probe.{mode}", "route": "cuda", "source": SOURCE,
        "replaces": {"runs": REPLACES_RUNS, "gate.cav": REPLACES_CAV}.get(
            mode, REPLACES),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "lanes": n, "cap": kw["cap"],
    }
    if mode == "block":
        row["tile_budgets"] = sweep(
            K, "TILE_BYTES", TILE_SWEEP,
            lambda plain: K.fused_probe(q_cols, off, tbl, plain=plain, **kw))
        row["fill_ms"] = fill_ms((n, kw["cap"], W_of(kw.get("spec"), tbl.shape[1])))
        log(f"time fused_probe.block [{card}] by tile budget: {row['tile_budgets']};"
            f" fill_ms of its output {row['fill_ms']:.5f}")
    call = lambda plain: K.fused_probe(q_cols, off, tbl, plain=plain, **kw)  # noqa: E731
    row["path"] = _path(K, mode, kw["cap"])
    if mode in ("gate", "gate.cav"):
        row["tile_slots"] = sweep(K, "GATE_SLOTS", GATE_SWEEP, call)
        log(f"time fused_probe.{mode} [{card}] by GATE_SLOTS: {row['tile_slots']}")
    if mode in K.REDUCED:
        time_reduced(K, mode, row, kw["cap"], call, card, "fused_probe")
    return row


def time_aligned(K, mode, q_cols, tbls, caps, sw, kw, card):
    """One fused_probe_aligned mode at one captured main-path call, as
    ``time_mode``."""
    kw = dict(kw)
    kw.pop("plain", None)
    n = _lanes(q_cols)
    err, ms, plain_ms = _kernel_vs_plain(
        K, lambda plain: K.fused_probe_aligned(q_cols, tbls, caps, sw,
                                               plain=plain, **kw))
    bound_ms, bound_by = aligned_bound(q_cols, tbls, caps, sw, kw)
    capT = int(sum(caps))
    log(f"time fused_probe_aligned.{mode} [{card}]: lanes={n} capT={capT}"
        f" levels={len(tbls)} caps={tuple(caps)}"
        f" packed={kw.get('spec') is not None} ms={ms:.5f}"
        f" plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by})"
        f" max_abs_err={err}")
    if err:
        raise AssertionError(f"aligned {mode}: kernel differs from plain at"
                             " main-path shape")
    row = {
        "name": f"fused_probe_aligned.{mode}", "route": "cuda",
        "source": SOURCE_ALIGNED,
        "replaces": REPLACES_ALIGNED_CAV if mode == "gate.cav" else REPLACES_ALIGNED,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "lanes": n, "capT": capT, "levels": len(tbls),
    }
    call = lambda plain: K.fused_probe_aligned(q_cols, tbls, caps, sw,  # noqa: E731
                                               plain=plain, **kw)
    row["path"] = _path(K, mode, capT)
    if mode == "gate":
        row["tile_slots"] = sweep(K, "GATE_SLOTS", GATE_SWEEP, call)
        log(f"time fused_probe_aligned.gate [{card}] by slots a CTA:"
            f" {row['tile_slots']}")
    if mode in K.REDUCED:
        time_reduced(K, mode, row, capT, call, card, "fused_probe_aligned")
    if mode == "block":
        row["tile_budgets"] = sweep(
            K, "TILE_BYTES", TILE_SWEEP,
            lambda plain: K.fused_probe_aligned(q_cols, tbls, caps, sw,
                                                plain=plain, **kw))
        row["fill_ms"] = fill_ms((n, capT, W_of(kw.get("spec"), sw)))
        log(f"time fused_probe_aligned.block [{card}] by tile budget:"
            f" {row['tile_budgets']}; fill_ms of its output {row['fill_ms']:.5f}")
    return row


# ---------------------------------------------------------------------------
# the Watch-driven delta chain (phases 9-11)
# ---------------------------------------------------------------------------

CONFIG5_SCHEMA = """
definition user {}
definition team { relation member: user }
definition repo {
    relation maintainer: user | team#member
    relation reader: user
    permission read = reader + maintainer
}
"""
#: BASELINE config 5's published deployment: 1B edges on 16 chips, so
#: one card's share is 62.5M edges; bench5_watch.py's own default is 10M
CONFIG5_EDGES_PER_CHIP = 1_000_000_000 // 16


def kernel_of(key: str) -> str:
    return "fused_probe_aligned" if key.startswith("aligned.") else "fused_probe"


def own_launches(K, label, fn, need=("fused_probe",)):
    """Drive ``fn`` with every launch count set to 0 just before it and
    read just after; fail unless each kernel in ``need`` launched.  The
    counts from before are added back, so a path driven inside the main
    path leaves the main path's totals as they would have been."""
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    try:
        out = fn()
        got = {k: v for k, v in K.LAUNCHES.items() if v}
    finally:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] += saved[0][k]
            K.LANES[k] += saved[1][k]
    log(f"{label}: kernel launches {json.dumps(got)}")
    missing = [n for n in need if not any(kernel_of(k) == n for k in got)]
    if missing and DEV == "cuda":  # a CPU rehearsal launches no kernel
        raise AssertionError(f"{label}: {missing} never launched")
    return out, got


def need_for(cfg):
    return ("fused_probe_aligned",) if cfg.get("flat_aligned") else ("fused_probe",)


def build_config5(n_edges):
    """BASELINE config 5, the generator of benchmarks/bench5_watch.py:
    47-91: seed 17, 100,000 users, 1,000 teams of 50 members, repos =
    edges / 20 with one team maintainer each, the rest reader edges."""
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot_from_columns

    cs = compile_schema(parse_schema(CONFIG5_SCHEMA))
    interner = Interner()
    rng = np.random.default_rng(17)
    n_users, n_teams = 100_000, 1000
    n_repos = max(n_edges // 20, 1000)
    users = np.array([interner.node("user", f"u{i}") for i in range(n_users)], np.int64)
    teams = np.array([interner.node("team", f"t{i}") for i in range(n_teams)], np.int64)
    repos = np.array([interner.node("repo", f"r{i}") for i in range(n_repos)], np.int64)
    slot = cs.slot_of_name
    n_member = n_teams * 50
    n_maint = n_repos
    n_reader = n_edges - n_member - n_maint
    res = np.concatenate([np.repeat(teams, 50), repos, rng.choice(repos, n_reader)])
    rel = np.concatenate([np.full(n_member, slot["member"], np.int64),
                          np.full(n_maint, slot["maintainer"], np.int64),
                          np.full(n_reader, slot["reader"], np.int64)])
    subj = np.concatenate([rng.choice(users, n_member), rng.choice(teams, n_maint),
                           rng.choice(users, n_reader)])
    srel = np.concatenate([np.full(n_member, -1, np.int64),
                           np.full(n_maint, slot["member"], np.int64),
                           np.full(n_reader, -1, np.int64)])
    snap = build_snapshot_from_columns(1, cs, interner, res=res, rel=rel,
                                       subj=subj, srel=srel, epoch_us=EPOCH)
    return cs, snap, interner, users, repos


def dl_mib(ds) -> float:
    return sum(v.nbytes for k, v in ds.arrays.items() if k.startswith("dl_")) / 2**20


def phase_config5(K, edges, warmup=20, rounds=10, delta=1000):
    """Phase 9: BASELINE config 5 (see the module docstring)."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.store.delta import apply_delta

    t0 = time.perf_counter()
    cs, snap, interner, users, repos = build_config5(edges)
    log(f"config5: world built in {time.perf_counter() - t0:.2f}s; edges={snap.num_edges}"
        f" nodes={snap.num_nodes}; reduced: edges {CONFIG5_EDGES_PER_CHIP} a card"
        f" (1B on 16 chips) -> {edges}")
    layouts = {"config5": {}, "config5 aligned": ALIGNED}
    eng = {}
    for label, cfg in layouts.items():
        ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None, **cfg), device=DEV)
        ep = DeviceEngine(cs, EngineConfig(kernels=False, **cfg), device=DEV)
        t0 = time.perf_counter()
        ds = ek.prepare(snap)
        if DEV == "cuda":
            torch.cuda.synchronize()
        log(f"{label}: base prepare_s={time.perf_counter() - t0:.3f}"
            f" device_MiB={sum(v.nbytes for v in ds.arrays.values()) / 2**20:.1f}"
            f" fold={bool(ds.flat_meta.fold_pairs)} N={ds.flat_meta.N}"
            f" aligned={[t for t, _w, _c in ds.flat_meta.aligned]}")
        eng[label] = [ek, ep, ds, 0, []]

    def chain():
        nonlocal snap
        rng = np.random.default_rng(5)
        for rnd in range(warmup + rounds):
            adds = [rel.must_from_triple(f"repo:r{rng.integers(0, 1000)}", "reader",
                                         f"user:fresh_{rnd}_{i}") for i in range(delta)]
            probe = rel.must_from_triple(f"repo:{adds[0].resource_id}", "read",
                                         f"user:{adds[0].subject_id}")
            t0 = time.perf_counter()
            snap = apply_delta(snap, snap.revision + 1, adds, [], interner=interner)
            mat = time.perf_counter() - t0
            for label, st in eng.items():
                ek = st[0]
                t1 = time.perf_counter()
                st[2] = ek.prepare(snap, prev=st[2])
                if DEV == "cuda":
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                d, _p, _o = ek.check_batch(st[2], [probe], now_us=EPOCH)
                t3 = time.perf_counter()
                if not d[0]:
                    raise AssertionError(f"{label} rev {snap.revision}: freshness probe not definite")
                st[3] += st[2].flat_meta.delta is not None
                if rnd >= warmup:
                    st[4].append((mat * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))

    own_launches(K, "config5 chain", chain,
                 need=("fused_probe", "fused_probe_aligned"))
    for label, (ek, ep, ds, inc, lat) in eng.items():
        m = np.asarray(lat)
        mat, ovl, prb = (float(x) for x in m.mean(axis=0))
        dm = ds.flat_meta.delta
        log(f"{label}: {warmup} warm-up + {rounds} measured revisions of {delta}"
            f" adds; incremental={inc}/{warmup + rounds}; every freshness probe definite;"
            f" mean materialize_ms={mat:.3f} overlay_ms={ovl:.3f} probe_ms={prb:.3f}"
            f" updates_per_s={delta / ((mat + ovl + prb) / 1e3):.1f}"
            f" per-revision (materialize, overlay, probe) ms={[tuple(round(x, 3) for x in r) for r in lat]}")
        log(f"{label}: fold armed={bool(ds.flat_meta.fold_pairs) and not (dm and dm.pf_off)}"
            f" pf_off={bool(dm and dm.pf_off)} pf_dirty={bool(dm and dm.pf_dirty)}"
            f" pf_ovl_e={bool(dm and dm.pf_ovl_e)} dl_MiB={dl_mib(ds):.3f}"
            f" dl tables={sorted(k for k in ds.arrays if k.startswith('dl_'))}")
    # the batch on the chain's last snapshot (bench5_watch.py's draw)
    qrng = np.random.default_rng(5)
    B = 100_000
    ri = qrng.integers(0, repos.shape[0], B)
    ui = qrng.integers(0, users.shape[0], B)
    q = (repos[ri].astype(np.int32), np.full(B, cs.slot_of_name["read"], np.int32),
         users[ui].astype(np.int32))
    names = [("repo", f"r{a}", "read", "user", f"u{b}") for a, b in zip(ri, ui)]
    planes = None
    for label, (ek, ep, ds, _inc, _lat) in eng.items():
        own_launches(K, f"{label} batch on the chain's last snapshot",
                     lambda: ek.check_columns(ds, *q, now_us=EPOCH),
                     need=need_for(layouts[label]))
        dk = check_batch_phase(f"{label} chain tip", cs, snap, ek, ep, ds, q, names)
        if planes is not None:
            same_planes(f"{label} chain tip", dk, planes)
        planes = dk
    ek, ep = eng["config5"][0], eng["config5"][1]
    del eng
    t0 = time.perf_counter()
    full = ek.prepare(snap)
    if DEV == "cuda":
        torch.cuda.synchronize()
    log(f"config5: full prepare of the chain's last revision {snap.revision}:"
        f" prepare_s={time.perf_counter() - t0:.3f}")
    same_planes("config5 full prepare", check_batch_phase(
        "config5 full prepare", cs, snap, ek, ep, full, q, names), planes)


FEATURE_SCHEMA = """
caveat tier(t int, min int) { t >= min }
definition user {}
definition group {
    relation member: user | user:* | group#member
    relation admin: user
}
definition folder {
    relation parent: folder
    relation owner: user | group#member
    permission view = owner + parent->view
}
definition doc {
    relation folder: folder
    relation reader: user | user:* | group#member | user with tier
    relation banned: user
    permission read = (reader - banned) + folder->view
    permission audit = reader & banned
}
"""


def feature_rels(rng, n_users, n_groups, n_folders, n_docs):
    """The generator of tests/test_flat_engine.py's feature world (its
    build_feature_world) at a given size: nested groups with a wildcard
    member, expiring memberships, a folder tree, doc readers that are
    users, caveated, expiring, wildcard or group#member, and bans."""
    from gochugaru_tpu_torch import rel

    def expiring(r, secs):
        return r.with_expiration(
            dt.datetime.fromtimestamp(EPOCH / 1e6 + secs, tz=dt.timezone.utc))

    rels = []
    for g in range(n_groups):
        for u in rng.sample(range(n_users), 3):
            r = rel.must_from_tuple(f"group:g{g}#member", f"user:u{u}")
            if rng.random() < 0.2:
                r = expiring(r, rng.choice([-100, 500]))
            rels.append(r)
    rels.append(rel.must_from_tuple("group:g0#member", "user:*"))
    for g in range(1, n_groups):
        if rng.random() < 0.6:
            rels.append(rel.must_from_tuple(f"group:g{g}#member",
                                            f"group:g{rng.randrange(g)}#member"))
    for f in range(1, n_folders):
        rels.append(rel.must_from_tuple(f"folder:f{f}#parent",
                                        f"folder:f{rng.randrange(f)}"))
    for f in range(n_folders):
        if rng.random() < 0.7:
            rels.append(rel.must_from_tuple(f"folder:f{f}#owner",
                                            f"group:g{rng.randrange(n_groups)}#member"))
        else:
            rels.append(rel.must_from_tuple(f"folder:f{f}#owner",
                                            f"user:u{rng.randrange(n_users)}"))
    for d in range(n_docs):
        rels.append(rel.must_from_tuple(f"doc:d{d}#folder",
                                        f"folder:f{rng.randrange(n_folders)}"))
        for u in rng.sample(range(n_users), 2):
            r = rel.must_from_tuple(f"doc:d{d}#reader", f"user:u{u}")
            if rng.random() < 0.3:
                r = r.with_caveat("tier", {"min": rng.randint(1, 9)})
            elif rng.random() < 0.2:
                r = expiring(r, rng.choice([-50, 1000]))
            rels.append(r)
        if rng.random() < 0.3:
            rels.append(rel.must_from_tuple(f"doc:d{d}#reader", "user:*"))
        if rng.random() < 0.4:
            rels.append(rel.must_from_tuple(f"doc:d{d}#banned",
                                            f"user:u{rng.randrange(n_users)}"))
        if rng.random() < 0.2:
            rels.append(rel.must_from_tuple(f"doc:d{d}#reader",
                                            f"group:g{rng.randrange(n_groups)}#member"))
    return rels


def feature_checks(rng, n_users, n_groups, n_docs, n):
    from gochugaru_tpu_torch import rel

    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            q = rel.must_from_tuple(f"doc:d{rng.randrange(n_docs)}#read",
                                    f"group:g{rng.randrange(n_groups)}#member")
        else:
            q = rel.must_from_triple(
                f"doc:d{rng.randrange(n_docs)}",
                rng.choice(["read", "audit", "reader", "banned"]),
                f"user:u{rng.randrange(n_users + 2)}")
            if rng.random() < 0.5:
                q = q.with_caveat("", {"t": rng.randint(0, 10)})
        out.append(q)
    return out


def chain_step_planes(name, ek, ep, ds, snap, checks, programs, full=None,
                      lat=None):
    """One revision of a mixed chain: kernel planes == plain planes (and
    == a full prepare's, when given); definite rows vs the oracle.  With
    ``lat`` (phase 13) the same batch also goes through the revision's
    latency path twice (its first dispatch captures), whose planes must
    equal the kernel planes; ``lat`` counts revisions and captures, keeps
    the paths, and the seconds of each revision's first (cold) and second
    (warm) latency-mode check_batch."""
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

    dk = ek.check_batch(ds, checks, now_us=EPOCH)
    dp = ep.check_batch(ds, checks, now_us=EPOCH)
    for nm, a, b in zip("dpo", dk, dp):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: plane {nm} differs, kernels vs plain")
    if lat is not None:
        lp = ek.latency_path(ds)
        n, c0 = lp.dispatch_count, lp.compile_count
        for which in ("cold", "warm"):
            t0 = time.perf_counter()
            dl = ek.check_batch(ds, checks, now_us=EPOCH, latency=True)
            lat[f"{which}_s"].append(time.perf_counter() - t0)
            for nm, a, b in zip("dpo", dl, dk):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: latency plane {nm} differs from eager")
        if lp.dispatch_count != n + 2:
            raise AssertionError(f"{name}: the latency path did not serve the batch")
        lat["revisions"] += 1
        lat["captures"] += lp.compile_count - c0
        lat["per_revision"].append(lp.compile_count - c0)
        lat["paths"].append(lp)
    if full is not None:
        df = ek.check_batch(full, checks, now_us=EPOCH)
        for nm, a, b in zip("dpo", dk, df):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: plane {nm} differs from a full prepare's")
    d, p, ovf = dk
    oracle = SnapshotOracle(snap, programs, now_us=EPOCH)
    for i in np.nonzero(d & ~ovf)[0][:400]:
        c = checks[i]
        if oracle.check(c.resource_type, c.resource_id, c.resource_relation,
                        c.subject_type, c.subject_id, c.subject_relation,
                        context=c.caveat_context or None, now_us=EPOCH) != T:
            raise AssertionError(f"{name}: definite row {c} disagrees with the oracle")
    return dk


def phase_delta_chain(K, lat=None, **cfg):
    """Phase 10: a mixed Watch chain on the feature world, then caveated
    adds with fresh stored contexts on config 4's schema (see the module
    docstring).  With ``lat`` (phase 13 (d)) the chain alone, each
    revision's batch also through its latency path."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.delta import apply_delta
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot

    tag = ("delta chain" + (" aligned" if cfg.get("flat_aligned") else "")
           + (" latency" if lat is not None else ""))
    n_users, n_groups, n_folders, n_docs = 400, 60, 150, 1500
    rng = random.Random(29)
    rels = feature_rels(rng, n_users, n_groups, n_folders, n_docs)
    cs = compile_schema(parse_schema(FEATURE_SCHEMA))
    interner = Interner()
    snap = build_snapshot(1, cs, interner, rels, epoch_us=EPOCH)
    programs = {n: compile_cel(n, c.params, c.expression)
                for n, c in cs.schema.caveats.items()}
    # small floors: the overlay steps through its shape bands and reaches
    # the compaction bound (max(this, E/8) rows) within the chain
    knobs = dict(flat_delta_floor=64, flat_delta_min_compact=256, **cfg)
    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None, **knobs), device=DEV)
    ep = DeviceEngine(cs, EngineConfig(kernels=False, **knobs), device=DEV)
    ds = ek.prepare(snap)
    meta = ds.flat_meta
    log(f"{tag}: edges={snap.num_edges} fold={bool(meta.fold_pairs)}"
        f" tindex={meta.has_tindex} packed={[k for k, _ in meta.packed]}"
        f" aligned={[t for t, _w, _c in meta.aligned]}")
    used = sorted({r.subject_id for r in rels
                   if r.subject_type == "group" and r.subject_relation == "member"})
    us_rows = [r for r in rels if r.resource_type == "doc" and r.subject_relation == "member"]
    base_direct = [r for r in rels if r.resource_type == "doc"
                   and r.resource_relation in ("reader", "banned")
                   and r.subject_type == "user" and r.subject_id != "*"]
    base_arrows = [r for r in rels if r.resource_relation == "folder"]
    py = random.Random(31)
    log_rows = []

    def chain():
        nonlocal snap, ds
        bands, flags = set(), set()
        for revision in range(2, 30):
            adds, deletes = [], []
            for i in range(40):
                kind = py.randrange(6)
                if kind == 0:
                    adds.append(rel.must_from_triple(
                        f"doc:d{py.randrange(n_docs)}", "reader", f"user:u{py.randrange(n_users)}"))
                elif kind == 1:  # membership: advances the closure
                    adds.append(rel.must_from_tuple(
                        f"group:{py.choice(used)}#member", f"user:u{py.randrange(n_users)}"))
                elif kind == 2:
                    adds.append(rel.must_from_tuple(
                        f"doc:d{py.randrange(n_docs)}#reader", f"group:{py.choice(used)}#member"))
                elif kind == 3:
                    adds.append(rel.must_from_triple(
                        f"doc:d{py.randrange(n_docs)}", "reader", f"user:u{py.randrange(n_users)}"
                    ).with_caveat("tier", {"min": py.randint(1, 9)}))
                elif kind == 4:
                    adds.append(rel.must_from_tuple(
                        f"doc:fresh{revision}_{i}#folder", f"folder:f{py.randrange(n_folders)}"))
                else:
                    adds.append(rel.must_from_triple(
                        f"doc:d{py.randrange(n_docs)}", "banned", f"user:u{py.randrange(n_users)}"))
            for _ in range(4):  # retarget base doc -> folder arrows
                if base_arrows:
                    old = base_arrows.pop(py.randrange(len(base_arrows)))
                    deletes.append(old)
                    adds.append(rel.must_from_tuple(
                        f"doc:{old.resource_id}#folder", f"folder:f{py.randrange(n_folders)}"))
            keys = {a.key() for a in adds}
            for pool in (base_direct, us_rows):  # base-row and userset tombstones
                for _ in range(4):
                    if pool:
                        r = pool.pop(py.randrange(len(pool)))
                        if r.key() not in keys:
                            deletes.append(r)
            snap = apply_delta(snap, revision, adds, deletes, interner=interner)
            t0 = time.perf_counter()
            ds = ek.prepare(snap, prev=ds)
            ms = (time.perf_counter() - t0) * 1e3
            dm = ds.flat_meta.delta
            inc = ds.delta_acc is not None
            if dm is not None:
                bands.add(tuple(ds.arrays["dl_ehx"].shape) if "dl_ehx" in ds.arrays else None)
                flags |= {f for f in ("has_tombs", "has_us", "has_ustomb", "has_ar",
                                      "has_artomb", "t_dirty", "pf_dirty", "pf_ovl_e", "pf_ovl_u",
                                      "pf_off", "t_off") if getattr(dm, f)}
            checks = feature_checks(py, n_users, n_groups, n_docs, 2048) + [
                rel.must_from_triple(f"doc:{a.resource_id}", "read", f"user:{a.subject_id}")
                for a in adds if a.resource_type == "doc" and a.subject_type == "user"]
            checks += [  # docs whose folder arrow this revision moved or added
                rel.must_from_triple(f"doc:{a.resource_id}", "read",
                                     f"user:u{py.randrange(n_users)}")
                for a in adds + deletes if a.resource_relation == "folder"
                for _ in range(8)]
            chain_step_planes(f"{tag} rev {revision}", ek, ep, ds, snap, checks,
                              programs, full=ek.prepare(snap), lat=lat)
            log_rows.append((revision, inc, round(ms, 3), len(adds), len(deletes)))
            if not inc:
                log(f"{tag}: rev {revision} bailed to a full prepare"
                    f" (accumulated rows past max(flat_delta_min_compact, E/8)"
                    f" = {max(256, snap.num_edges // 8)}, or the node radix)")
        return bands, flags

    (bands, flags), _ = own_launches(K, tag, chain, need=need_for(cfg))
    log(f"{tag}: (revision, incremental, prepare ms, adds, deletes)={log_rows}")
    log(f"{tag}: planes kernels == plain == full prepare at every revision;"
        f" dl_ehx shape bands={sorted(b for b in bands if b)} delta flags seen={sorted(flags)}")
    if len(bands - {None}) < 2:
        raise AssertionError(f"{tag}: the overlay never crossed a shape band")
    if all(inc for _r, inc, *_ in log_rows):
        raise AssertionError(f"{tag}: the chain never reached the compaction bail")
    want = {"has_tombs", "has_us", "has_ustomb", "has_ar", "has_artomb", "t_dirty"}
    if not want <= flags:
        raise AssertionError(f"{tag}: delta sites never exercised: {sorted(want - flags)}")
    if lat is None:
        phase_delta_contexts(K, **cfg)


def phase_delta_contexts(K, **cfg):
    """Caveated adds with fresh stored contexts on config 4's schema:
    the ectx_* tables re-encode in their 2x headroom while it holds, then
    the chain bails to a full prepare as the reference's does."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.store.delta import apply_delta

    tag = "delta contexts" + (" aligned" if cfg.get("flat_aligned") else "")
    # 40 shared contexts: the ectx tables hold 128 rows, so appends
    # re-encode in place up to 64 contexts, then the bucket is outgrown
    n_tenants = 40
    cs, snap, (q_res, q_perm, q_subj), names, (q_ctx, qctx_rows) = build_config4(
        200_000, n_tenants=n_tenants)
    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None, **cfg), device=DEV)
    ep = DeviceEngine(cs, EngineConfig(kernels=False, **cfg), device=DEV)
    ds = ek.prepare(snap)
    rows0 = int(ds.arrays["ectx_vi"].shape[0])
    B0 = 16_384
    fresh_q, fresh_names, fresh_ctx = [], [], []
    qctx_rows = list(qctx_rows)
    results = []

    def chain():
        nonlocal snap, ds
        for revision in range(2, 8):
            adds = []
            for i in range(16):
                t = f"fresh{revision}_{i}"
                adds.append(rel.must_from_triple(
                    f"item:i{(revision * 16 + i) % 1000}", "holder", f"user:u{i}"
                ).with_caveat("same_tenant", {"edge_tenant": t, "tier": 2}))
            snap = apply_delta(snap, revision, adds, [], interner=snap.interner)
            ds = ek.prepare(snap, prev=ds)
            for a in adds:
                res = snap.interner.lookup("item", a.resource_id)
                sub = snap.interner.lookup("user", a.subject_id)
                for want in (a.caveat_context["edge_tenant"], "t0"):
                    qctx_rows.append({"tenant": want, "tier": 2})
                    fresh_q.append((res, sub))
                    fresh_ctx.append(len(qctx_rows) - 1)
                    fresh_names.append(("item", a.resource_id, "access", "user", a.subject_id))
            qr = np.concatenate([q_res[:B0], np.asarray([r for r, _ in fresh_q], np.int32)])
            qs = np.concatenate([q_subj[:B0], np.asarray([s for _, s in fresh_q], np.int32)])
            qp = np.full(qr.shape[0], q_perm[0], np.int32)
            qc = np.concatenate([q_ctx[:B0], np.asarray(fresh_ctx, np.int32)])
            dk = check_batch_phase(f"{tag} rev {revision}", cs, snap, ek, ep, ds,
                                   (qr, qp, qs), names[:B0] + fresh_names,
                                   (qc, qctx_rows))
            d = dk[0][B0:]
            if list(d) != [True, False] * (len(d) // 2):
                raise AssertionError(f"{tag} rev {revision}: fresh-context rows wrong")
            results.append((revision, ds.delta_acc is not None, len(snap.contexts),
                            int(ds.arrays["ectx_vi"].shape[0])))

    own_launches(K, tag, chain, need=need_for(cfg))
    log(f"{tag}: (revision, incremental, stored contexts, ectx rows)={results};"
        f" base ectx rows={rows0}")
    if not results[0][1] or all(r[1] for r in results):
        raise AssertionError(f"{tag}: expected incremental appends, then a bail"
                             " when the context bucket is outgrown")


def phase_write_check(K, client, ek, ds, snap, prepare_s, n_docs, n_users, n_groups):
    """Phase 11: config 3's write -> first check through the client on
    the snapshot phase 5 prepared (see the module docstring)."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    client._engine, client._engine_schema = ek, snap.compiled
    client._dsnap_cache[snap.revision] = ds
    rng = random.Random(37)
    out, revs = [], []

    def writes():
        for w in range(3):
            txn = rel.Txn()
            touched = [
                rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "viewer",
                                     f"user:u{rng.randrange(n_users)}"),
                rel.must_from_tuple(f"group:g{rng.randrange(n_groups)}#member",
                                    f"user:u{rng.randrange(n_users)}"),
            ]
            for r in touched:
                txn.touch(r)
            checks = [rel.must_from_triple(f"document:{touched[0].resource_id}", "view",
                                           f"user:{touched[0].subject_id}")]
            checks += [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "view",
                                            f"user:{touched[1].subject_id}") for _ in range(63)]
            checks += [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "view",
                                            f"user:u{rng.randrange(n_users)}") for _ in range(192)]
            t0 = time.perf_counter()
            rev = client.write(ctx, txn)
            t1 = time.perf_counter()
            got = client.check(ctx, consistency.at_least(rev), *checks)
            t2 = time.perf_counter()
            revs.append(parse_revision(rev))
            nds = client._dsnap_cache[revs[-1]]
            if nds.flat_meta.delta is None or nds.delta_acc is None:
                raise AssertionError(
                    f"config3 write {w}: the first check took a full prepare"
                    f" (node radix {nds.flat_meta.N} vs nodes {nds.snapshot.num_nodes},"
                    f" edges {nds.snapshot.num_edges})")
            oracle = SnapshotOracle(nds.snapshot, {}, now_us=None)
            want = [oracle.check_relationship(c) == T for c in checks]
            if got != want or not got[0]:
                raise AssertionError(f"config3 write {w}: answers disagree with the oracle")
            dm = nds.flat_meta.delta
            out.append((w, round((t1 - t0) * 1e3, 3), round((t2 - t1) * 1e3, 3),
                        {f for f in ("has_adds", "has_tombs", "t_dirty", "pf_dirty",
                                     "pf_ovl_e", "pf_ovl_u", "pf_off", "t_off")
                         if getattr(dm, f)}))

    own_launches(K, "config3 write -> check", writes)
    # the delta prepares started the transposed lookup index's background
    # build (the host walker serves lookups on a delta chain); let it end
    # so it does not share the host with the lookups timed next
    t0 = time.perf_counter()
    while ek._prewarm_inflight:
        time.sleep(0.05)
    log(f"config3: the background lookup-index build ended"
        f" {time.perf_counter() - t0:.3f}s after the last write's check")
    for w, write_ms, check_ms, flags in out:
        log(f"config3 write -> first check {w}: write_ms={write_ms}"
            f" first_check_ms={check_ms} (delta path: materialize + overlay prepare"
            f" + 256 checks; delta flags {sorted(flags)}) vs the full prepare it"
            f" replaces: prepare_s={prepare_s:.3f}; answers agree with the oracle")
    phase_write_legacy(client._dsnap_cache[revs[-1]], snap.compiled,
                       n_docs, n_users, n_groups)
    return out


def phase_write_legacy(nds, cs, n_docs, n_users, n_groups):
    """Phase 11, last part: the first legacy batch on config 3's last
    delta-prepared revision ``nds``.  A batch of two permissions on an
    engine with ``flat_max_slots=1`` spills to the legacy program, whose
    raw columns that first batch builds on the host from the revision's
    own snapshot and ships (O(E)); they stay cached on the revision for
    as long as the client keeps it.  Times the first and a second batch
    and the device MiB the cache adds; unflagged rows vs the oracle."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.utils import metrics

    if nds.delta_acc is None or nds.legacy_cache is not None:
        raise AssertionError("config3 write -> legacy: not a fresh delta-prepared revision")
    eng = DeviceEngine(cs, EngineConfig.for_schema(cs, flat_max_slots=1), device=DEV)
    rng = random.Random(43)
    checks = [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "view",
                                   f"user:u{rng.randrange(n_users)}") for _ in range(128)]
    checks += [rel.must_from_triple(f"group:g{rng.randrange(n_groups)}", "member",
                                    f"user:u{rng.randrange(n_users)}") for _ in range(128)]
    before = metrics.default.counter("checks.legacy")
    times, planes = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        planes.append(eng.check_batch(nds, checks))
        times.append(time.perf_counter() - t0)
    if metrics.default.counter("checks.legacy") != before + 2:
        raise AssertionError("config3 write -> legacy: the batches did not run on the legacy program")
    for nm, a, b in zip("dpo", *planes):
        if not np.array_equal(a, b):
            raise AssertionError(f"config3 write -> legacy: plane {nm} differs between two calls")
    added = [v for k, v in nds.legacy_cache.items() if nds.arrays.get(k) is not v]
    mib = sum(v.nbytes for v in added) / 2**20
    d, p, ovf = planes[0]
    flags = ovf | (p & ~d)
    oracle = SnapshotOracle(nds.snapshot, {}, now_us=None)
    bad = sum(bool(d[i]) != (oracle.check_relationship(c) == T)
              for i, c in enumerate(checks) if not flags[i])
    if bad:
        raise AssertionError(f"config3 write -> legacy: {bad} unflagged rows disagree with the oracle")
    log(f"config3 write -> first legacy batch (revision {nds.revision}, {len(checks)} checks,"
        f" 2 permissions, flat_max_slots=1): first_ms={times[0] * 1e3:.3f}"
        f" (raw columns built from the revision's snapshot and shipped)"
        f" second_ms={times[1] * 1e3:.3f} legacy_cache_MiB={mib:.1f};"
        f" {int(flags.sum())} rows flagged for the host, the rest agree with the oracle")


def _flags(planes):
    d, p, ovf = planes
    return ovf | (p & ~d)


def phase_legacy_world(K, name, cs, snap, q, names, flat_planes, settled_min=0.0):
    """Phase 12 (a)/(b): an ``EngineConfig(use_flat=False)`` engine on
    the world's host snapshot (its prepare ships only the raw columns),
    the same 100,000-check batch as the flat path's: checks/s (median of
    4 calls), the overflow share, the definite plane against the flat
    path's on every row neither program flags (at least ``settled_min``
    of the batch), 2,000 sampled rows against the host oracle, and no
    probe-kernel launch."""
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.utils import metrics

    tag = f"{name} legacy"
    eng = DeviceEngine(cs, EngineConfig.for_schema(cs, use_flat=False), device=DEV)
    t0 = time.perf_counter()
    ds = eng.prepare(snap)
    if DEV == "cuda":
        torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    PREPARE_S[tag] = prepare_s
    extra = sorted(set(ds.arrays) - set(DeviceEngine.ARRAY_COLUMN_KEYS)
                   - {"ectx_vi", "ectx_vf", "ectx_pr", "ectx_host"})
    if ds.flat_meta is not None or extra:
        raise AssertionError(f"{tag}: the prepare shipped flat tables: {extra}")
    cfg = eng.config
    log(f"{tag}: prepare_s={prepare_s:.3f} (raw columns only,"
        f" {sum(v.nbytes for v in ds.arrays.values()) / 2**20:.1f} MiB)"
        f" caps closure={cfg.closure_size} hops={cfg.closure_hops}"
        f" subgraph={cfg.subgraph_nodes} eval_iters={cfg.eval_iters}")
    q_res, q_perm, q_subj = q
    before = metrics.default.counter("checks.legacy")

    def run():
        return eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)

    planes, got = own_launches(K, tag, run, need=())
    if got:
        raise AssertionError(f"{tag}: probe kernels launched: {got}")
    if metrics.default.counter("checks.legacy") != before + 1:
        raise AssertionError(f"{tag}: the batch did not run on the legacy program")
    times = []
    for _ in range(4):
        ts = time.perf_counter()
        again = eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)
        times.append(time.perf_counter() - ts)
    for nm, a, b in zip("dpo", planes, again):
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag}: plane {nm} differs between two calls")
    d, p, ovf = planes
    both = ~_flags(planes) & ~_flags(flat_planes)
    diff = int((d[both] != flat_planes[0][both]).sum())
    log(f"{tag}: B={len(q_res)} checks_per_s={len(q_res) / float(np.median(times)):.1f}"
        f" batch_s={[round(t, 5) for t in times]}"
        f" overflow_share={float(ovf.mean())!r} conditional={int((p & ~d).sum())}"
        f" definite={int(d.sum())}; rows neither program flags={int(both.sum())},"
        f" definite plane differs from the flat path's on {diff}")
    if diff:
        raise AssertionError(f"{tag}: {diff} unflagged rows differ from the flat path's")
    if both.mean() < settled_min:
        raise AssertionError(f"{tag}: {int(both.sum())} rows settled on the card,"
                             f" fewer than {settled_min:.0%}")
    programs = {n: compile_cel(n, c.params, c.expression)
                for n, c in cs.schema.caveats.items()}
    oracle = SnapshotOracle(snap, programs, now_us=EPOCH)
    rng = np.random.default_rng(99)
    sample = rng.choice(len(q_res), min(2000, len(q_res)), replace=False)
    flags = _flags(planes)
    bad = sum(
        bool(d[i]) != (oracle.check(*names[i][:4], names[i][4], "",
                                    now_us=EPOCH) == T)
        for i in sample if not flags[i])
    if bad:
        raise AssertionError(f"{tag}: {bad} sampled unflagged rows disagree with the oracle")
    log(f"{tag}: {len(sample)} sampled rows agree with the host oracle"
        f" ({int(flags[sample].sum())} of them flagged, settled there)")
    return planes


def phase_legacy_spill(K, cs, snap, q, want):
    """Phase 12 (c): config 2's batch on a default (flat) engine whose
    ``flat_max_slots`` is below the batch's distinct permissions (the
    batch asks for read and admin, so 1): the batch spills to the legacy
    program, and its planes equal ``want``, (a)'s."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.utils import metrics

    eng = DeviceEngine(cs, EngineConfig.for_schema(cs, flat_max_slots=1), device=DEV)
    ds = eng.prepare(snap)
    if ds.flat_meta is None:
        raise AssertionError("config2 spill: no flat tables")
    before = metrics.default.counter("checks.legacy")
    planes, got = own_launches(
        K, "config2 spill", lambda: eng.check_columns(ds, *q, now_us=EPOCH), need=())
    if got or metrics.default.counter("checks.legacy") != before + 1:
        raise AssertionError(f"config2 spill: did not run on the legacy program ({got})")
    for nm, a, b in zip("dpo", planes, want):
        if not np.array_equal(a, b):
            raise AssertionError(f"config2 spill: plane {nm} differs from the legacy engine's")
    log(f"config2 spill (flat_max_slots=1, {len(np.unique(q[1]))} permissions):"
        " legacy program, planes equal the use_flat=False engine's")


FEATURE_NAMES = ("member", "admin", "parent", "owner", "view", "folder",
                 "reader", "banned", "read", "audit")


def feature_all_name_checks(rng, n_users, n_groups, n_folders, n_docs, n):
    """Checks over all ten names of FEATURE_SCHEMA."""
    from gochugaru_tpu_torch import rel

    on = {"member": "group", "admin": "group", "parent": "folder",
          "owner": "folder", "view": "folder"}
    size = {"group": (n_groups, "g"), "folder": (n_folders, "f"), "doc": (n_docs, "d")}
    out = []
    for i in range(n):
        name = FEATURE_NAMES[i % len(FEATURE_NAMES)]
        t = on.get(name, "doc")
        res = f"{t}:{size[t][1]}{rng.randrange(size[t][0])}"
        subj = (f"folder:f{rng.randrange(n_folders)}" if name in ("parent", "folder")
                else f"user:u{rng.randrange(n_users + 2)}")
        r = rel.must_from_triple(res, name, subj)
        if name in ("reader", "read") and rng.random() < 0.5:
            r = r.with_caveat("", {"t": rng.randint(0, 10)})
        out.append(r)
    return out


def phase_legacy_client(n_users=400, n_groups=60, n_folders=150, n_docs=1500):
    """Phase 12 (d): the client surface on the feature world at phase
    10's size: a check over all ten names (the legacy program) against
    the oracle, deletes and a write, the same batch on the
    delta-prepared snapshot, the Watch stream, reads and an export ->
    import round trip."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.client import new_evaluator
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    mk = (lambda: new_evaluator()) if DEV == "cuda" else (lambda: new_evaluator(device=DEV))
    c = mk()
    c.write_schema(ctx, FEATURE_SCHEMA)
    rng = random.Random(41)
    rels = feature_rels(rng, n_users, n_groups, n_folders, n_docs)
    c.import_relationships(ctx, rels)
    checks = feature_all_name_checks(rng, n_users, n_groups, n_folders, n_docs, 3000)

    def oracle_at(cs):
        snap = c.store.snapshot_for(cs)
        programs = {n: compile_cel(n, d.params, d.expression)
                    for n, d in snap.compiled.schema.caveats.items()}
        return SnapshotOracle(snap, programs)

    def check_all_vs_oracle(label, cs):
        before = metrics.default.counter("checks.legacy")
        t0 = time.perf_counter()
        got = c.check(ctx, cs, *checks)
        secs = time.perf_counter() - t0
        oracle = oracle_at(cs)
        want = [oracle.check_relationship(r) == T for r in checks]
        if got != want:
            bad = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"client legacy {label}: {bad} answers disagree with the oracle")
        n_legacy = metrics.default.counter("checks.legacy") - before
        if n_legacy < 1:
            raise AssertionError(f"client legacy {label}: no legacy dispatch")
        log(f"client legacy {label}: {len(checks)} checks over all 10 names in"
            f" {secs:.3f}s ({n_legacy:.0f} legacy dispatch), every answer equals"
            f" the oracle's ({sum(want)} allowed)")

    check_all_vs_oracle("full", consistency.full())
    rev0 = c.store.head_revision
    readers = [r for r in rels if r.resource_relation == "reader"
               and r.subject_type == "user" and r.subject_id != "*"][:40:4]
    for r in readers:
        c.delete_atomic(ctx, rel.new_filter("doc", r.resource_id, "reader")
                        .with_subject_filter("user", r.subject_id))
    c.delete_atomic(ctx, rel.new_filter("doc", "", "banned")
                    .with_subject_filter("user", "u3"))
    txn = rel.Txn()
    for i in range(20):
        txn.touch(rel.must_from_triple(f"doc:d{i}", "reader", f"user:u{i + 7}"))
        txn.touch(rel.must_from_triple(f"doc:d{i + 20}", "banned", f"user:u{i}"))
    rev = c.write(ctx, txn)
    check_all_vs_oracle(f"at_least({rev})", consistency.at_least(rev))
    ds = c._dsnap_cache[parse_revision(rev)]
    if ds.flat_meta is None or ds.flat_meta.delta is None:
        raise AssertionError("client legacy: the post-write snapshot is not delta-prepared")
    log(f"client legacy: revision {parse_revision(rev)} was delta-prepared"
        f" (dl tables {sorted(k for k in ds.arrays if k.startswith('dl_'))[:4]}...)"
        f" and its legacy columns were built from its own snapshot")
    # the Watch stream across those writes vs the store's log
    want = [(int(u.update_type), str(u.relationship))
            for _r, u in _store_updates(c.store, rev0, parse_revision(rev))]
    got = []
    wctx = ctx.with_timeout(30)
    for u in c.updates_since_revision(wctx, rel.UpdateFilter(), f"gtz1.{rev0}"):
        got.append((int(u.update_type), str(u.relationship)))
        if len(got) >= len(want):
            break
    wctx.cancel()
    if got != want or not want:
        raise AssertionError(f"client watch: {len(got)} updates, the store has {len(want)}")
    log(f"client watch: updates_since_revision delivered the store's {len(want)} updates in order")
    # reads under three filters vs the export at head
    exported = list(c.export_relationships(ctx, rev))
    for f in (rel.new_filter("doc", "d7", ""),
              rel.new_filter("doc", "", "banned"),
              rel.new_filter("group", "", "member").with_subject_filter("group", "", "member")):
        got = sorted(str(r) for r in c.read_relationships(ctx, consistency.full(), f))
        want = sorted(str(r) for r in exported if f.matches(r))
        if got != want or not got:
            raise AssertionError(f"client read {f}: {len(got)} rows, the export has {len(want)}")
    log(f"client read_relationships under 3 filters equals the export's {len(exported)} rows, filtered")
    fresh = mk()
    fresh.write_schema(ctx, FEATURE_SCHEMA)
    fresh.import_relationships(ctx, exported)
    a = fresh.check(ctx, consistency.full(), *checks)
    b = c.check(ctx, consistency.at_least(rev), *checks)
    if a != b:
        raise AssertionError("client export -> import: the restored client's checks differ")
    log(f"client export -> import round trip: {len(exported)} relationships,"
        f" {len(checks)} checks agree")


def _store_updates(store, since, until):
    """The store's (revision, update) log entries after ``since`` up to
    ``until`` (whole entries: ``until`` is a revision already written)."""
    out = []
    for rev, ups in store.entries_since(since):
        out += [(rev, u) for u in ups]
        if rev >= until:
            return out
    return out


# ---------------------------------------------------------------------------
# phase 13: the latency path (engine/latency.py) on pinned CUDA graphs
# ---------------------------------------------------------------------------

#: the batch tiers phase 13 runs (the EngineConfig default)
LAT_TIERS = (256, 1024, 4096)
#: (a)'s batch sizes: each tier's edges, and one past the top tier
LAT_PARITY_B = (1, 200, 256, 900, 1100, 4096)
#: (b)'s warm dispatches per tier, and every how many of them the eager
#: check_columns of the same batch is timed beside it
LAT_WARM = 500
LAT_EAGER_EVERY = 5
LAT_STAGES = ("total_s", "host_lower_s", "h2d_s", "kernel_s", "d2h_s")


def _ms_p(xs):
    """[p50, p99] in ms."""
    return [float(np.percentile(xs, 50) * 1e3), float(np.percentile(xs, 99) * 1e3)]


def _ms_p50_max(xs):
    """[p50, max] in ms."""
    return [float(np.percentile(xs, 50) * 1e3), float(np.max(xs) * 1e3)]


def _lat_same(name, got, *wants):
    for want in wants:
        for nm, a, b in zip("dpo", got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: latency plane {nm} differs")


def _lat_modes(paths):
    """Kernel launches per mode inside the captures of ``paths``' pins
    (a pin shared by several revisions' paths counts once)."""
    out = {}
    pins = {id(pin): pin for lp in paths for pin in lp.pins().values()}
    for pin in pins.values():
        for k, n in pin.modes.items():
            out[k] = out.get(k, 0) + n
    return out


def lat_parity(name, w, ctx=None, q=None):
    """(a): replayed planes == check_columns' kernel planes == the plain
    planes at each of LAT_PARITY_B; a batch past the top tier returns None
    and check_columns_latency answers it.  Returns the path."""
    ek, ep, ds = w["ek"], w["ep"], w["ds"]
    q = q if q is not None else w["q"]
    lp = ek.latency_path(ds)
    for B in LAT_PARITY_B + (5000,):
        sl = slice(0, B)
        kw = dict(now_us=EPOCH)
        if ctx is not None:
            kw.update(q_ctx=ctx[0][sl], qctx_rows=ctx[1])
        cols = (q[0][sl], q[1][sl], q[2][sl])
        want = ek.check_columns(ds, *cols, **kw)
        got = lp.dispatch_columns(*cols, **kw)
        if B > max(LAT_TIERS):
            if got is not None:
                raise AssertionError(f"{name}: B={B} past the top tier was served")
            got = ek.check_columns_latency(ds, *cols, **kw)
        _lat_same(f"{name} B={B}", got, want, ep.check_columns(ds, *cols, **kw))
    log(f"{name}: latency planes == kernel planes == plain planes at"
        f" B={list(LAT_PARITY_B)}; B=5000 -> None, check_columns_latency equal;"
        f" captures {lp.compile_count}, modes in captures {_lat_modes([lp])}")
    return lp


def lat_warm(name, w, rng, tiers=LAT_TIERS):
    """(b): LAT_WARM warm dispatches per tier of jittered sizes within it:
    no capture, dispatch_count + LAT_WARM; p50/p99 ms of each stage, and of
    the eager check_columns of every LAT_EAGER_EVERY-th batch."""
    ek, ds, q = w["ek"], w["ds"], w["q"]
    lp = ek.latency_path(ds)
    out = {}
    lo = 0
    n_q = q[0].shape[0]
    for tier in tiers:
        batches = []
        for _ in range(LAT_WARM):
            B = int(rng.integers(lo + 1, tier + 1))
            at = int(rng.integers(0, n_q - B))
            batches.append((q[0][at:at + B], q[1][at:at + B], q[2][at:at + B]))
        # a pin per (slots, tier): capture each permission set the warm
        # batches ask for first (a capture is not a warm sample)
        seen = {}
        for cols in batches:
            seen.setdefault(tuple(np.unique(cols[1])), cols)
        for cols in seen.values():
            lp.dispatch_columns(*cols, now_us=EPOCH)
        c0, n0 = lp.compile_count, lp.dispatch_count
        stages = {k: [] for k in LAT_STAGES}
        eager = []
        for i, cols in enumerate(batches):
            lp.dispatch_columns(*cols, now_us=EPOCH)
            b = lp.last_budget
            if b.tier != tier or b.compiled:
                raise AssertionError(f"{name}: B={B} left tier {tier} or captured")
            for k in LAT_STAGES:
                stages[k].append(getattr(b, k))
            if i % LAT_EAGER_EVERY == 0:
                t0 = time.perf_counter()
                ek.check_columns(ds, *cols, now_us=EPOCH)
                eager.append(time.perf_counter() - t0)
        if lp.compile_count != c0 or lp.dispatch_count != n0 + LAT_WARM:
            raise AssertionError(
                f"{name}: tier {tier}: captures {c0} -> {lp.compile_count},"
                f" dispatches {n0} -> {lp.dispatch_count} over {LAT_WARM} warm")
        row = {k.replace("_s", ""): _ms_p(v) for k, v in stages.items()}
        row["eager"] = _ms_p(eager)
        row["n"], row["n_eager"], row["pins"] = LAT_WARM, len(eager), len(seen)
        out[str(tier)] = row
        log(f"{name}: tier {tier}: {LAT_WARM} warm dispatches, no capture;"
            f" p50/p99 ms {json.dumps(row)}")
        lo = tier
    return out


def lat_now_live(K):
    """(c): the closure-overflow world of phase 6, queried on its expiring
    edges, through one pin at three clocks: the answers change exactly as
    the eager program's, with no recapture."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.interner import Interner
    from gochugaru_tpu_torch.store.snapshot import build_snapshot

    rels, _n_docs, _n_users = ovf_rels(5, 20_000)
    cs = compile_schema(parse_schema(OVF_SCHEMA))
    snap = build_snapshot(1, cs, Interner(), rels, epoch_us=EPOCH)
    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None,
                                       closure_source_cap=4), device=DEV)
    ds = ek.prepare(snap)
    exp = [r for r in rels if r.expiration is not None and r.subject_relation == ""
           and r.subject_id != "*"][:1000]
    it = snap.interner
    q = (np.array([it.lookup(r.resource_type, r.resource_id) for r in exp], np.int32),
         np.array([cs.slot_of_name[r.resource_relation] for r in exp], np.int32),
         np.array([it.lookup(r.subject_type, r.subject_id) for r in exp], np.int32))
    lp = ek.latency_path(ds)
    nows = (EPOCH, EPOCH + 3 * 10**11, EPOCH + 2 * 10**12)
    granted, caps = [], []
    for now_us in nows:
        got = lp.dispatch_columns(*q, now_us=now_us)
        _lat_same(f"now-live at {now_us}", got, ek.check_columns(ds, *q, now_us=now_us))
        granted.append(int(got[0].sum()))
        caps.append(lp.compile_count)
    if caps != [1, 1, 1] or not granted[0] > granted[1] > granted[2]:
        raise AssertionError(f"now-live: captures {caps}, granted {granted}")
    log(f"now-live: {len(exp)} expiring edges checked at {len(nows)} clocks through"
        f" one pin: granted {granted} (== eager at each), captures {caps}")
    return dict(edges=len(exp), granted=granted, captures=lp.compile_count), lp


def lat_write(w, n_writes=3, B=256):
    """(i): config 3's write -> first latency-mode check, as a Watch-fed
    service sees it: each write (a viewer and a group member) is applied
    to the previous revision (``apply_ms``) and prepared incrementally
    (``prepare_ms``), the background lookup-index build that a delta
    prepare starts is let end (untimed), then B checks go through the new
    revision's latency path (cold: its first dispatch, which captures a
    pin of a new band or copies the revision's tensors into the pin an
    earlier revision of the band captured), again (warm), and through the
    eager check_columns; all three equal.  A revision that kept the
    previous one's band must capture nothing."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.store.delta import apply_delta

    ek, ds, q = w["ek"], w["ds"], w["q"]
    snap = ds.snapshot
    rng = random.Random(43)
    n_users, n_groups, _n_folders, n_docs = docs_sizes(w["scale"])
    rows, paths = [], []
    cols = (q[0][:B], q[1][:B], q[2][:B])
    prev_key = ek.latency_path(ds)._share_key()
    for i in range(n_writes):
        adds = [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "viewer",
                                     f"user:u{rng.randrange(n_users)}"),
                rel.must_from_tuple(f"group:g{rng.randrange(n_groups)}#member",
                                    f"user:u{rng.randrange(n_users)}")]
        t0 = time.perf_counter()
        snap = apply_delta(snap, snap.revision + 1, adds, [], interner=snap.interner)
        ta = time.perf_counter()
        ds = ek.prepare(snap, prev=ds)
        tp = time.perf_counter()
        while ek._prewarm_inflight:
            time.sleep(0.05)
        t1 = time.perf_counter()
        if ds.flat_meta.delta is None:
            raise AssertionError(f"config3 latency write {i}: a full prepare")
        lp = ek.latency_path(ds)
        cold = lp.dispatch_columns(*cols, now_us=EPOCH)
        t2 = time.perf_counter()
        rebind = lp.last_budget.rebind_bytes
        warm = lp.dispatch_columns(*cols, now_us=EPOCH)
        t3 = time.perf_counter()
        eager = ek.check_columns(ds, *cols, now_us=EPOCH)
        t4 = time.perf_counter()
        _lat_same(f"config3 latency write {i}", cold, warm, eager)
        key = lp._share_key()
        kept = key[:4] == prev_key[:4]
        prev_key = key
        if kept and lp.compile_count:
            raise AssertionError(f"config3 latency write {i}: {lp.compile_count} captures"
                                 " on a revision that kept its band")
        rows.append(dict(apply_ms=(ta - t0) * 1e3, prepare_ms=(tp - ta) * 1e3,
                         cold_ms=(t2 - t1) * 1e3,
                         warm_ms=(t3 - t2) * 1e3, eager_ms=(t4 - t3) * 1e3,
                         captures=lp.compile_count, band_kept=kept,
                         rebind_bytes=rebind))
        paths.append(lp)
    log(f"config3 write -> first latency check ({B} checks; cold = the revision's"
        f" first dispatch, a capture or a rebind): {json.dumps(rows)}")
    return rows, paths


def lat_threads(name, w, n_threads=4, n_dispatch=200, n_batches=20):
    """(f): ``n_threads`` threads x ``n_dispatch`` dispatches on one path,
    each answer equal to the eager planes of its own batch."""
    import threading

    ek, ds, q = w["ek"], w["ds"], w["q"]
    lp = ek.latency_path(ds)
    rng = np.random.default_rng(41)
    batches = []
    for _ in range(n_threads * n_batches):
        B = int(rng.integers(1, 1025))
        at = int(rng.integers(0, q[0].shape[0] - B))
        cols = (q[0][at:at + B], q[1][at:at + B], q[2][at:at + B])
        batches.append((cols, ek.check_columns(ds, *cols, now_us=EPOCH)))
    errors = []

    def worker(t):
        try:
            for i in range(n_dispatch):
                cols, want = batches[t * n_batches + i % n_batches]
                _lat_same(f"{name} thread {t}", lp.dispatch_columns(*cols, now_us=EPOCH), want)
        except Exception as e:  # surfaced below
            errors.append(e)

    n0 = lp.dispatch_count
    th = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    t0 = time.perf_counter()
    for x in th:
        x.start()
    for x in th:
        x.join()
    if errors:
        raise errors[0]
    if lp.dispatch_count != n0 + n_threads * n_dispatch:
        raise AssertionError(f"{name}: threads: {lp.dispatch_count - n0} dispatches")
    s = time.perf_counter() - t0
    log(f"{name}: {n_threads} threads x {n_dispatch} dispatches, each equal to its"
        f" batch's eager planes, in {s:.3f}s")
    return dict(threads=n_threads, dispatches=n_threads * n_dispatch, s=s)


def lat_client(**cfg):
    """(g): a ``cuda`` client with ``with_latency_mode()`` on phase 7's
    client world: 1,000 checks of 1-64 relationships against the oracle;
    ``latency.dispatches`` must move."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_engine_config, with_latency_mode)
    from gochugaru_tpu_torch.engine.oracle import Oracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    c = new_evaluator(with_latency_mode(), with_engine_config(EngineConfig(**cfg)),
                      device=DEV)
    c.write_schema(ctx, RBAC_SCHEMA)
    rng = random.Random(17)
    rels = [rel.must_from_triple(*t) for t in client_triples(rng)]
    txn = rel.Txn()
    for r in rels:
        txn.create(r)
    c.write(ctx, txn)
    oracle = Oracle(compile_schema(parse_schema(RBAC_SCHEMA)), rels)
    before = metrics.default.counter("latency.dispatches")
    n_rels, t0 = 0, time.perf_counter()
    for _ in range(1000):
        checks = [rel.must_from_triple(f"repo:r{rng.randrange(50)}",
                                       rng.choice(["read", "admin", "reader"]),
                                       f"user:u{rng.randrange(60)}")
                  for _ in range(rng.randint(1, 64))]
        if c.check(ctx, consistency.full(), *checks) != [
                oracle.check_relationship(r) == T for r in checks]:
            raise AssertionError("latency client verdicts disagree with the oracle")
        n_rels += len(checks)
    s = time.perf_counter() - t0
    moved = metrics.default.counter("latency.dispatches") - before
    if moved <= 0:
        raise AssertionError("latency client: the latency path never ran")
    ds = c._dsnap_cache[max(c._dsnap_cache)]
    log(f"latency client {cfg or ''}: 1000 checks ({n_rels} relationships) agree with"
        f" the oracle; latency.dispatches +{int(moved)}; {s:.3f}s")
    return dict(checks=1000, relationships=n_rels, dispatches=int(moved), s=s), ds.latency_path


#: (h)'s sub-batch: the reference's accelerator default
LAT_SUB_BATCH = 32_768


def lat_pipelined(w):
    """(h): config 4's 100,000-check batch through check_columns_pipelined
    in sub-batches of LAT_SUB_BATCH equals check_columns; ms to the first
    sub-batch and in total, beside one check_columns call."""
    ek, ds, q, ctx = w["ek"], w["ds"], w["q"], w["ctx"]
    kw = dict(q_ctx=ctx[0], qctx_rows=ctx[1], now_us=EPOCH)
    want = ek.check_columns(ds, *q, **kw)
    if DEV == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, parts = None, []
    for lo, hi, d, p, o in ek.check_columns_pipelined(
            ds, *q, sub_batch=LAT_SUB_BATCH, **kw):
        if first is None:
            first = time.perf_counter() - t0
        parts.append((lo, hi, d, p, o))
    total = time.perf_counter() - t0
    t1 = time.perf_counter()
    ek.check_columns(ds, *q, **kw)
    whole = time.perf_counter() - t1
    got = [np.concatenate([x[k] for x in parts]) for k in (2, 3, 4)]
    _lat_same("pipelined", got, want)
    out = dict(batch=int(q[0].shape[0]), sub_batch=LAT_SUB_BATCH,
               sub_batches=len(parts), first_ms=first * 1e3, total_ms=total * 1e3,
               check_columns_ms=whole * 1e3)
    log(f"pipelined config4: planes == check_columns; {json.dumps(out)}")
    return out


def phase_latency(K, card):
    """Phase 13 (see the module docstring).  Returns the ``latency:`` line's
    object."""
    t13 = time.perf_counter()
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    W = LATENCY_WORLDS
    paths, cells = [], {}
    rng = np.random.default_rng(13)
    for name in ("config2", "config2 aligned", "config3", "config3 aligned"):
        paths.append(lat_parity(name, W[name]))
        cells[name] = lat_warm(name, W[name], rng)
    for name in ("config4", "config4 aligned"):
        w = W[name]
        paths.append(lat_parity(name + " holder", w, ctx=w["ctx"], q=w["hq"]))
    now_live, lp = lat_now_live(K)
    paths.append(lp)
    lat = {"revisions": 0, "captures": 0, "per_revision": [], "paths": [],
           "cold_s": [], "warm_s": []}
    phase_delta_chain(K, lat=lat)
    paths += lat["paths"]
    caught = [s for s, c in zip(lat["cold_s"], lat["per_revision"]) if c]
    rebound = [s for s, c in zip(lat["cold_s"], lat["per_revision"]) if not c]
    chain = dict(revisions=lat["revisions"], captures=lat["captures"],
                 captures_per_revision=lat["per_revision"],
                 cold_ms=_ms_p50_max(lat["cold_s"]),
                 capturing_ms=_ms_p50_max(caught) if caught else None,
                 rebinding_ms=_ms_p50_max(rebound) if rebound else None,
                 warm_ms=_ms_p50_max(lat["warm_s"]))
    log(f"delta chain latency: {lat['revisions']} revisions, each equal to its eager"
        f" planes; the chain paid {lat['captures']} captures, per revision"
        f" {lat['per_revision']}; check_batch ms [p50, max] first dispatch of a"
        f" revision {chain['cold_ms']} (capturing {chain['capturing_ms']}, rebinding"
        f" {chain['rebinding_ms']}), warm {chain['warm_ms']}")
    write, lps = lat_write(W["config3"])
    paths += lps
    threads = lat_threads("config2", W["config2"])
    client = {}
    for label, cfg in (("off", {}), ("aligned", ALIGNED)):
        client[label], lp = lat_client(**cfg)
        paths.append(lp)
    pipelined = lat_pipelined(W["config4"])
    modes = _lat_modes(paths)
    need = ("block", "gate", "aligned.block", "aligned.gate", "gate.cav")
    missing = [m for m in need if not modes.get(m)]
    if missing and DEV == "cuda":  # a CPU rehearsal captures nothing
        raise AssertionError(f"phase 13: never launched inside a capture: {missing}")
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] += saved[0][k]
        K.LANES[k] += saved[1][k]
    seconds = time.perf_counter() - t13
    log(f"phase 13: {seconds:.1f}s; eager and capture launches {json.dumps(got)};"
        f" launches inside captures {json.dumps(modes)}")
    LATENCY_WORLDS.clear()
    return dict(card=card, tiers=list(LAT_TIERS), cells=cells, now_live=now_live,
                delta_chain=chain, write_then_check=write,
                threads=threads, client=client, pipelined=pipelined,
                captures=sum(lp.compile_count for lp in paths),
                modes_in_captures=modes, launches=got, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 14: the serving front end (serve/) on config 3's client
# ---------------------------------------------------------------------------

#: the reference bench's traffic (benchmarks/bench9_serve.py:103-127,
#: 205-207, 272-343): ONE submitter on a Poisson clock, each submission a
#: CheckMany of SERVE_SUBMIT ``view`` checks sliced from a pool of (doc,
#: user) pairs (users zipf SERVE_ZIPF), a fairness client id drawn from
#: SERVE_CLIENTS ids, ``ServeConfig(hold_max_s=SERVE_HOLD_S)`` (dedup off
#: on the cache-off sweep), the garbage collector off inside a step;
#: offered loads as fractions of the closed-loop rate, seconds a step
SERVE_CLIENTS = 32
SERVE_SUBMIT = 64
SERVE_ZIPF = 1.2
SERVE_HOLD_S = 0.001
SERVE_LOADS = (0.5, 0.8, 0.9)
SERVE_STEP_S = 4.0
#: lower loads, 2 s each, run first: where the knee of goodput lies (not
#: in the reference bench)
SERVE_KNEE = (0.03, 0.1, 0.2)
SERVE_KNEE_S = 2.0
#: the headline (bench9's): goodput at the highest load whose p99
#: submit -> resolve stays within SERVE_P99_X times the quiet-window p99
#: of one SERVE_QUIET_B-check latency dispatch
SERVE_P99_X = 3.0
SERVE_QUIET_B = 1024
SERVE_QUIET_REPS = 300
SERVE_TIER = 4096
SERVE_POOL = 1 << 18
#: (c)'s submissions re-checked on the host oracle
SERVE_SAMPLES = 50
#: checks of the formed batches held against the host oracle at the
#: revision each was served at: of (b)'s top step, and of each revision
#: under (d)'s writes
SERVE_BATCH_CHECKS = 300
#: (a)'s closed-loop dispatches, and (d)'s writes under serving
SERVE_CLOSED_REPS = 200
SERVE_WRITES = 3
#: an extra step, not the reference bench's arrival model: this many
#: client threads, each on its own Poisson clock, at SERVE_THREADS_LOAD
SERVE_THREADS = 32
SERVE_THREADS_LOAD = 0.1
#: seconds between two samples of the serving threads' stacks (b's step
#: at SERVE_PROFILE_LOAD)
SERVE_PROFILE_S = 0.002
SERVE_PROFILE_LOAD = 0.5
#: the interpreter's switch interval of an extra step at
#: SERVE_PROFILE_LOAD (the default is 0.005 s)
SERVE_SWITCH_S = 0.0005


def serve_pool(snap, n_docs, n_users, rng):
    """SERVE_POOL ``view`` checks of config 3 as interned columns: docs
    uniform, users zipf(SERVE_ZIPF) over the config's users."""
    it = snap.interner
    docs = it.node_batch("document", [f"d{i}" for i in rng.integers(0, n_docs, SERVE_POOL)])
    users = (rng.zipf(SERVE_ZIPF, SERVE_POOL) - 1) % n_users
    subj = it.node_batch("user", [f"u{i}" for i in users])
    view = snap.compiled.slot_of_name["view"]
    return (np.asarray(docs, np.int32), np.full(SERVE_POOL, view, np.int32),
            np.asarray(subj, np.int32))


def serve_closed_loop(ek, nds, pool):
    """(a): checks/s of pre-formed SERVE_TIER batches through
    check_columns_latency, one after another, in this process."""
    q = tuple(c[:SERVE_TIER] for c in pool)
    for _ in range(5):
        ek.check_columns_latency(nds, *q)
    t0 = time.perf_counter()
    for i in range(SERVE_CLOSED_REPS):
        at = (i * 977) % (SERVE_POOL - SERVE_TIER)
        ek.check_columns_latency(nds, *(c[at:at + SERVE_TIER] for c in pool))
    return SERVE_CLOSED_REPS * SERVE_TIER / (time.perf_counter() - t0)


def serve_quiet(lp, pool):
    """bench9's quiet window: SERVE_QUIET_REPS latency dispatches of one
    SERVE_QUIET_B-check batch, its subjects rotated each time; (p50, p99)
    ms."""
    q = tuple(c[:SERVE_QUIET_B] for c in pool)
    for _ in range(10):
        lp.dispatch_columns(*q)
    lat = []
    for i in range(SERVE_QUIET_REPS):
        t0 = time.perf_counter()
        lp.dispatch_columns(q[0], q[1], np.roll(q[2], i))
        lat.append(time.perf_counter() - t0)
    return float(np.percentile(lat, 50) * 1e3), float(np.percentile(lat, 99) * 1e3)


def serve_warm(h, pool, rng):
    """bench9's warm-up: a burst of 400 submissions (full top-tier
    batches), then 48 paced 3 ms apart (the small tiers), retried on a
    shed, all drained."""
    from gochugaru_tpu_torch.utils.context import background
    from gochugaru_tpu_torch.utils.errors import ShedError

    ctx = background()
    futs = []
    for n, pace in ((400, 0.0), (48, 0.003)):
        for k in range(n):
            s = int(rng.integers(0, SERVE_POOL - SERVE_SUBMIT))
            while True:
                try:
                    futs.append(h.submit_columns(
                        ctx, *(c[s:s + SERVE_SUBMIT] for c in pool),
                        client_id=k % SERVE_CLIENTS))
                    break
                except ShedError:
                    time.sleep(0.005)
            if pace:
                time.sleep(pace)
    for f in futs:
        f.result(timeout=60.0)


def _hist_delta(m, before, name):
    """(count, sum) of histogram ``name`` since ``before``
    (hist_snapshot)."""
    now = m.hist_snapshot().get(name)
    if now is None:
        return 0, 0.0
    old = before.get(name)
    return now[2] - (old[2] if old else 0), now[3] - (old[3] if old else 0.0)


class StackSampler:
    """Samples the Python stacks of the serving threads (the batcher's
    former and dispatcher, and the thread that submits) every
    SERVE_PROFILE_S from a thread of its own.  Per thread: each sample
    counts once to every function of the port (or of this script) on the
    stack (``inclusive``, as ``file:function``) and to the innermost such
    frame's line (``self``, as ``file:function:line``); time in a library
    call, or waiting for the interpreter lock, counts to the line that
    made the call; a thread parked in a ``threading`` wait counts as
    ``waiting``."""

    def __init__(self, submitter):
        import threading

        self._threading = threading
        self._names = {"former": "gochugaru-serve-former",
                       "dispatcher": "gochugaru-serve-dispatcher"}
        self._submitter = submitter.ident
        self.samples = {}
        self.inclusive = {}
        self.self_lines = {}
        self._stop = threading.Event()

    def _count(self, role, frame):
        self.samples[role] = self.samples.get(role, 0) + 1
        inner = self.self_lines.setdefault(role, {})
        incl = self.inclusive.setdefault(role, {})
        waiting = frame.f_code.co_filename.endswith("threading.py")
        seen = set()
        first = True
        while frame is not None:
            f = frame.f_code.co_filename
            if "gochugaru_tpu_torch" in f or f.endswith("chip_smoke.py"):
                fn = f"{os.path.basename(f)}:{frame.f_code.co_name}"
                if first:
                    w = "waiting" if waiting else f"{fn}:{frame.f_lineno}"
                    inner[w] = inner.get(w, 0) + 1
                    first = False
                if fn not in seen:
                    seen.add(fn)
                    incl[fn] = incl.get(fn, 0) + 1
            frame = frame.f_back

    def _run(self):
        idents = {}
        for t in self._threading.enumerate():
            for role, name in self._names.items():
                if t.name == name:
                    idents[t.ident] = role
        idents[self._submitter] = "submitter"
        while not self._stop.is_set():
            frames = sys._current_frames()
            for ident, role in idents.items():
                fr = frames.get(ident)
                if fr is not None:
                    self._count(role, fr)
            del frames, fr
            time.sleep(SERVE_PROFILE_S)

    def __enter__(self):
        self._t = self._threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        return False

    def result(self, top=10, top_inclusive=16):
        out = {}
        for role, n in self.samples.items():
            def ranked(c, k):
                return [[f, v / n] for f, v in sorted(c.items(), key=lambda kv: -kv[1])[:k]]
            inner = self.self_lines.get(role, {})
            out[role] = dict(samples=n, waiting=inner.get("waiting", 0) / n,
                             inclusive=ranked(self.inclusive.get(role, {}), top_inclusive),
                             self=ranked(inner, top))
        return out


class ServedBatches:
    """Records each batch a serving handle's dispatcher evaluates: when it
    started, its seconds, the revision it was served at, its columns and
    its verdicts.  Installed on one handle (and the client's evaluate
    layer, for the revision) for the ``with`` block."""

    def __init__(self, client, h):
        import threading

        self.client, self.h = client, h
        self.rows = []
        self.snaps = {}
        self._tl = threading.local()

    def __enter__(self):
        orig = self.h.batcher._dispatch_cols
        orig_eval = self.client._evaluate_columns
        tl = self._tl

        def timed(q_res, q_perm, q_subj, *a):
            tl.rev = None
            t0 = time.perf_counter()
            out = orig(q_res, q_perm, q_subj, *a)
            self.rows.append((t0, time.perf_counter() - t0, tl.rev, q_res.copy(),
                              q_subj.copy(), np.asarray(out, bool).copy()))
            return out

        def evaluate(snap, *a, **kw):
            if hasattr(tl, "rev"):  # this handle's dispatcher thread
                tl.rev = snap.revision
                self.snaps.setdefault(snap.revision, snap)
            return orig_eval(snap, *a, **kw)

        self._orig = orig
        self.h.batcher._dispatch_cols = timed
        self.client._evaluate_columns = evaluate
        return self

    def __exit__(self, *exc):
        self.h.batcher._dispatch_cols = self._orig
        del self.client._evaluate_columns
        return False

    def times(self):
        """p50 and p99 ms of a batch in the dispatcher (evaluate layer to
        verdicts)."""
        if not self.rows:
            return dict(batch_ms_p50=None, batch_ms_p99=None)
        ms = [r[1] * 1e3 for r in self.rows]
        return dict(batch_ms_p50=float(np.percentile(ms, 50)),
                    batch_ms_p99=float(np.percentile(ms, 99)))

    def check(self, rng, revision=None, n=SERVE_BATCH_CHECKS):
        """``n`` rows sampled from the batches served at ``revision``
        (every revision: None) against the host oracle at the revision
        each was served at; returns the rows compared."""
        from gochugaru_tpu_torch import rel
        from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

        rows = [r for r in self.rows if revision is None or r[2] == revision]
        if not rows:
            return 0
        flat = [(i, j) for i, r in enumerate(rows) for j in range(r[3].shape[0])]
        pick = rng.choice(len(flat), min(n, len(flat)), replace=False)
        oracles = {}
        for k in pick:
            i, j = flat[int(k)]
            rev, q_res, q_subj, got = rows[i][2:6]
            snap = self.snaps[rev]
            if rev not in oracles:
                oracles[rev] = SnapshotOracle(snap, {}, now_us=None)
            key = snap.interner.key_of
            want = oracles[rev].check_relationship(rel.must_from_triple(
                f"document:{key(int(q_res[j]))[1]}", "view",
                f"user:{key(int(q_subj[j]))[1]}")) == T
            if bool(got[j]) != want:
                raise AssertionError(
                    f"serving: a served verdict at revision {rev} disagrees with"
                    f" the oracle (document {key(int(q_res[j]))[1]}, user"
                    f" {key(int(q_subj[j]))[1]})")
        return int(len(pick))


def serve_step(h, pool, offered, rng, seconds=None, stop=None, threads=0,
               profile=False):
    """One open-loop step at ``offered`` checks/s.  bench9's arrival
    model (``threads`` 0): this thread submits SERVE_SUBMIT-check slices
    of ``pool`` on one Poisson clock, each under a client id drawn from
    SERVE_CLIENTS; with ``threads`` N, N threads each submit on a clock of
    their own at 1/N of the load, under their own id.  Submissions run
    for ``seconds`` of arrivals (or until ``stop`` is set); an arrival
    not issued within twice that wall time is counted as ``unissued``;
    sheds are counted, not retried; every future is drained; the garbage
    collector is off from the first arrival to the drain.  ``profile``
    samples the serving threads' stacks.  Returns the row and the
    (future, slice start) pairs."""
    import threading

    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background
    from gochugaru_tpu_torch.utils.errors import ShedError

    m = metrics.default
    ctx = background()
    seconds = SERVE_STEP_S if seconds is None else seconds
    n_src = max(threads, 1)
    per = offered / SERVE_SUBMIT / n_src
    horizon = seconds if stop is None else 120.0
    n_each = max(int(per * horizon), 1)
    plans = [(np.cumsum(rng.exponential(1.0 / per, n_each)),
              rng.integers(0, SERVE_POOL - SERVE_SUBMIT, n_each),
              rng.integers(0, SERVE_CLIENTS, n_each) if not threads
              else np.full(n_each, t))
             for t in range(n_src)]
    futs = [[] for _ in range(n_src)]
    sheds = [0] * n_src
    unissued = [0] * n_src
    last = [0.0] * n_src
    cpu_sub = [0.0] * n_src
    errors = []

    def submit(t):
        arr, starts, cids = plans[t]
        c0 = time.thread_time()
        try:
            for k in range(n_each):
                if stop is not None and stop.is_set():
                    break
                if stop is None and arr[k] > seconds:
                    break
                if stop is None and time.perf_counter() - t_start > 2 * seconds:
                    unissued[t] = int((arr[k:] <= seconds).sum())
                    break
                slack = t_start + arr[k] - time.perf_counter()
                if slack > 0.0015:
                    # bench9's coarse pacing: sleep off the bulk, let
                    # sub-ms arrivals micro-burst
                    time.sleep(slack - 0.001)
                s = int(starts[k])
                try:
                    futs[t].append((h.submit_columns(
                        ctx, pool[0][s:s + SERVE_SUBMIT], pool[1][s:s + SERVE_SUBMIT],
                        pool[2][s:s + SERVE_SUBMIT], client_id=int(cids[k])), s))
                except ShedError:  # open loop: a shed is counted, not retried
                    sheds[t] += 1
                last[t] = time.perf_counter()
        except Exception as e:  # raised below
            errors.append(e)
        cpu_sub[t] = time.thread_time() - c0

    sampler = StackSampler(threading.current_thread()) if profile else None
    base, hbase = m.snapshot(), m.hist_snapshot()
    clocks = {role: time.pthread_getcpuclockid(t.ident) for role, t in
              (("former", h.batcher._former_t), ("dispatcher", h.batcher._disp_t))}
    cpu0 = {role: time.clock_gettime(c) for role, c in clocks.items()}
    proc0 = time.process_time()
    gc.collect()
    gc.disable()
    try:
        if sampler is not None:
            sampler.__enter__()
        t_start = time.perf_counter() + 0.01
        if threads:
            th = [threading.Thread(target=submit, args=(t,)) for t in range(threads)]
            for x in th:
                x.start()
            for x in th:
                x.join()
        else:
            submit(0)
        if errors:
            raise errors[0]
        t_sub = max(last) - t_start
        pairs = [fs for f in futs for fs in f]
        for f, _s in pairs:
            f.result(timeout=60.0)
        elapsed = time.perf_counter() - t_start
        cpu = {role: (time.clock_gettime(c) - cpu0[role]) / elapsed
               for role, c in clocks.items()}
        cpu["submitters"] = sum(cpu_sub) / elapsed
        cpu["process"] = (time.process_time() - proc0) / elapsed
    finally:
        if sampler is not None:
            sampler.__exit__()
        gc.enable()
    snap = m.snapshot()

    def delta(k):
        return snap.get(k, 0) - base.get(k, 0)

    lat = np.array([(f.t_done - f.t_submit) for f, _s in pairs])
    n_sub, n_shed = len(pairs), sum(sheds)
    occ = {}
    for tier in LAT_TIERS:
        n, total = _hist_delta(m, hbase, f"serve.occupancy.t{tier}")
        if n:
            occ[str(tier)] = dict(batches=int(n), mean_occupancy=total / n / tier)
    done = delta("serve.checks")
    row = dict(
        offered=offered, achieved_offered=(n_sub + n_shed) * SERVE_SUBMIT / max(t_sub, 1e-9),
        threads=threads or 1, submissions=n_sub, sheds=n_shed,
        shed_share=n_shed / max(n_sub + n_shed, 1), unissued=sum(unissued),
        goodput=done / elapsed, checks=int(done), seconds=elapsed,
        p50_ms=float(np.percentile(lat, 50) * 1e3) if lat.size else None,
        p99_ms=float(np.percentile(lat, 99) * 1e3) if lat.size else None,
        batches=int(delta("serve.batches")),
        batches_per_submission=delta("serve.batches") / max(n_sub, 1),
        occupancy=occ, device_dispatches=int(delta("latency.dispatches")),
        captures=int(delta("latency.compiles")), cpu_cores=cpu,
        dispatcher_cpu_ms_per_batch=cpu["dispatcher"] * elapsed * 1e3
        / max(delta("serve.batches"), 1),
    )
    hits, misses = delta("cache.hits"), delta("cache.misses")
    if hits + misses:
        row.update(cache_hit_rate=hits / (hits + misses),
                   dedup_fraction=(delta("serve.dedup_parked") + delta("dedup.batch_dups"))
                   / max(done, 1))
    if sampler is not None:
        row["host_profile"] = sampler.result()
    return row, pairs


def serve_oracle(snap, pool, pairs, rng, n=SERVE_SAMPLES):
    """``n`` sampled submissions' answers against the host oracle on
    ``snap`` (the revision they were served at); returns the checks
    compared."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

    oracle = SnapshotOracle(snap, {}, now_us=None)
    key = snap.interner.key_of
    n_checks = 0
    for i in rng.choice(len(pairs), min(n, len(pairs)), replace=False):
        f, s = pairs[int(i)]
        got = np.asarray(f.result()).tolist()
        want = [oracle.check_relationship(rel.must_from_triple(
                    f"document:{key(int(pool[0][j]))[1]}", "view",
                    f"user:{key(int(pool[2][j]))[1]}")) == T
                for j in range(s, s + SERVE_SUBMIT)]
        if got != want:
            raise AssertionError(f"serving: a served answer disagrees with the oracle (slice {s})")
        n_checks += len(want)
    return n_checks


def serve_config(**kw):
    from gochugaru_tpu_torch.serve import ServeConfig

    return ServeConfig(hold_max_s=SERVE_HOLD_S, **kw)


def serve_writes(client, n_docs, n_users, n_groups, pool, rng, offered, head_key):
    """(d): SERVE_WRITES writes in phase 11's pattern (a doc viewer and a
    group member) while the sweep's handle (``full()``, dedup and cache
    off) serves at ``offered`` checks/s.  After each write an
    ``at_least(revision)`` handle must answer True on the viewer the
    write granted.  Every batch is logged with the revision it was served
    at, and SERVE_BATCH_CHECKS of each revision's served checks are held
    against the host oracle at that revision.  Per write: ms until the
    ``at_least`` answer, the captures from the write until the next one
    (0 when the revision kept the band: the phase fails otherwise), the
    first batch served at the new revision (ms); and the other batches'
    p50 ms.  ``head_key`` is the serving revision's band key before the
    writes."""
    import threading

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    m = metrics.default
    ctx = background()
    ek = client._engine
    h = client.with_serving(cs=consistency.full(), config=serve_config(dedup=False),
                            cache=False)
    wr = random.Random(47)
    writes, errors = [], []
    stop = threading.Event()

    def writer():
        try:
            time.sleep(1.0)
            for w in range(SERVE_WRITES):
                granted = rel.must_from_triple(f"document:d{wr.randrange(n_docs)}", "viewer",
                                               f"user:u{wr.randrange(n_users)}")
                txn = rel.Txn()
                txn.touch(granted)
                txn.touch(rel.must_from_tuple(f"group:g{wr.randrange(n_groups)}#member",
                                              f"user:u{wr.randrange(n_users)}"))
                c0 = m.counter("latency.compiles")
                t0 = time.perf_counter()
                tok = client.write(ctx, txn)
                with client.with_serving(cs=consistency.at_least(tok), cache=False) as hw:
                    got = hw.check(ctx, rel.must_from_triple(
                        f"document:{granted.resource_id}", "view",
                        f"user:{granted.subject_id}"))
                t1 = time.perf_counter()
                if got != [True]:
                    raise AssertionError(f"serving write {w}: at_least did not see the write")
                revision = parse_revision(tok)
                nds = client._dsnap_cache[revision]
                time.sleep(1.0)  # serve the new revision
                writes.append(dict(
                    revision=revision, visible_ms=(t1 - t0) * 1e3,
                    delta=nds.flat_meta.delta is not None,
                    key=ek.latency_path(nds)._share_key(),
                    captures=int(m.counter("latency.compiles") - c0)))
        except Exception as e:  # raised below
            errors.append(e)
        finally:
            stop.set()

    wt = threading.Thread(target=writer)
    try:
        with ServedBatches(client, h) as served:
            wt.start()
            try:
                row, _pairs = serve_step(h, pool, offered, rng, stop=stop)
            finally:
                stop.set()
                wt.join()
    finally:
        h.close()
    if errors:
        raise errors[0]
    first = set()
    prev_key = head_key
    for w in writes:
        at = [b for b in served.rows if b[2] == w["revision"]]
        w["batches"] = len(at)
        w["first_batch_ms"] = at[0][1] * 1e3 if at else None
        if at:
            first.add(id(at[0]))
        w["oracle_checks"] = served.check(rng, w["revision"])
        key = w.pop("key")
        w["band_kept"] = key[:4] == prev_key[:4]
        prev_key = key
        if w["band_kept"] and w["captures"]:
            raise AssertionError(
                f"serving write -> revision {w['revision']}: {w['captures']} captures"
                " on a revision that kept its band")
    warm = [b[1] for b in served.rows if id(b) not in first]
    row["revisions_served"] = sorted({b[2] for b in served.rows})
    row["writes"] = writes
    row["warm_batch_p50_ms"] = float(np.percentile(warm, 50) * 1e3) if warm else None
    return row


def pin_report(ek):
    """The engine's latency pins, bands, the bands' private MiB and the
    MiB of the pins' graph pool on the card."""
    pool_mib = 0.0
    pools = {tuple(p.graph.pool()) for p in list(ek._latency_pins.values())
             if p.graph is not None}
    if pools:
        pool_mib = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                       if tuple(s.get("segment_pool_id", ())) in pools) / 2**20
    private = sum(t.numel() * t.element_size() for b in list(ek._latency_bands.values())
                  for t in b.private.values())
    return dict(pins=len(ek._latency_pins), bands=len(ek._latency_bands),
                private_mib=private / 2**20, pool_mib=pool_mib)


def phase_serving(K, cap, client, n_docs, n_users, n_groups, card):
    """Phase 14 (see the module docstring): the serving front end on the
    config 3 client phase 11 wrote to.  Returns the ``serving:`` line's
    object."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.utils import metrics

    t14 = time.perf_counter()
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    K.fused_probe, K.fused_probe_aligned = cap.orig, cap.orig_aligned
    m = metrics.default
    try:
        ek = client._engine
        nds = client._dsnap_cache[max(client._dsnap_cache)]
        rng = np.random.default_rng(53)
        pool = serve_pool(nds.snapshot, n_docs, n_users, rng)
        rate = serve_closed_loop(ek, nds, pool)
        lp = ek.latency_path(nds)
        quiet = serve_quiet(lp, pool)
        limit = SERVE_P99_X * quiet[1]
        log(f"serving (a): closed-loop tier-{SERVE_TIER} rate {rate:,.1f} checks/s"
            f" (check_columns_latency, revision {nds.revision}); quiet tier-{SERVE_QUIET_B}"
            f" dispatch p50/p99 {quiet[0]:.3f}/{quiet[1]:.3f} ms, p99 limit {limit:.3f} ms")
        for tier in LAT_TIERS:  # pre-pin every tier of the one permission set
            for _ in range(2):
                lp.dispatch_columns(*(c[:tier] for c in pool))
        steps = []
        with client.with_serving(cs=consistency.full(), config=serve_config(dedup=False),
                                 cache=False) as h:
            serve_warm(h, pool, rng)
            c0 = m.counter("latency.compiles")
            for frac, secs in ([(f, SERVE_KNEE_S) for f in SERVE_KNEE]
                               + [(f, SERVE_STEP_S) for f in SERVE_LOADS]):
                with ServedBatches(client, h) as served:
                    row, _pairs = serve_step(h, pool, frac * rate, rng, seconds=secs,
                                             profile=frac == SERVE_PROFILE_LOAD)
                row.update(served.times())
                if frac == SERVE_LOADS[-1]:
                    row["oracle_checks"] = served.check(rng)
                    row["revisions_served"] = sorted(served.snaps)
                row["load"] = frac
                steps.append(row)
                log(f"serving (b) load {frac}: {json.dumps(row)}")
            row, _pairs = serve_step(h, pool, SERVE_THREADS_LOAD * rate, rng,
                                     seconds=SERVE_KNEE_S, threads=SERVE_THREADS)
            row["load"] = SERVE_THREADS_LOAD
            threaded = row
            log(f"serving (b') {SERVE_THREADS} client threads, load {SERVE_THREADS_LOAD}:"
                f" {json.dumps(row)}")
            old = sys.getswitchinterval()
            sys.setswitchinterval(SERVE_SWITCH_S)
            try:
                with ServedBatches(client, h) as served:
                    row, _pairs = serve_step(h, pool, SERVE_PROFILE_LOAD * rate, rng,
                                             seconds=SERVE_KNEE_S)
            finally:
                sys.setswitchinterval(old)
            row.update(served.times())
            row.update(load=SERVE_PROFILE_LOAD, switch_interval_s=SERVE_SWITCH_S)
            switched = row
            log(f"serving (b'') load {SERVE_PROFILE_LOAD} at a switch interval of"
                f" {SERVE_SWITCH_S} s: {json.dumps(row)}")
        within = [s for s in steps if s["p99_ms"] is not None and s["p99_ms"] <= limit]
        best = max(within, key=lambda s: s["load"]) if within else None
        headline = dict(p99_limit_ms=limit, quiet_p50_ms=quiet[0], quiet_p99_ms=quiet[1],
                        load=best["load"] if best else None,
                        goodput=best["goodput"] if best else 0.0)
        log(f"serving headline: goodput at p99 <= {SERVE_P99_X} x quiet p99:"
            f" {json.dumps(headline)}")
        with client.with_serving(cs=consistency.min_latency(), config=serve_config(),
                                 cache=True) as h:
            cached, pairs = serve_step(h, pool, SERVE_LOADS[-1] * rate, rng)
            cached["load"] = SERVE_LOADS[-1]
            cached["oracle_checks"] = serve_oracle(nds.snapshot, pool, pairs, rng)
        log(f"serving (c) cache on, load {SERVE_LOADS[-1]}: {json.dumps(cached)}")
        captures = int(m.counter("latency.compiles") - c0)
        if captures:
            raise AssertionError(f"serving: {captures} captures across (b) and (c)")
        log("serving (e): no capture across (b) and (c) after the warm-up")
        writes = {}
        for frac in (SERVE_LOADS[0], SERVE_KNEE[1]):
            head = client._dsnap_cache[max(client._dsnap_cache)]
            writes[str(frac)] = serve_writes(client, n_docs, n_users, n_groups, pool, rng,
                                             frac * rate, ek.latency_path(head)._share_key())
            log(f"serving (d) writes under load {frac}: {json.dumps(writes[str(frac)])}")
        paths = [ds.latency_path for ds in client._dsnap_cache.values()
                 if ds.latency_path is not None]
        modes = _lat_modes(paths)
        while ek._prewarm_inflight:  # the delta prepares' background index builds
            time.sleep(0.05)
        if DEV == "cuda" and not modes.get("block"):
            raise AssertionError("serving: block never launched inside a capture")
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        pins = pin_report(ek)
        log(f"serving: the engine's latency pins after phase 14: {json.dumps(pins)}")
    finally:
        K.fused_probe, K.fused_probe_aligned = cap.wrapped, cap.wrapped_aligned
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = saved[0][k]
            K.LANES[k] = saved[1][k]
    seconds = time.perf_counter() - t14
    log(f"phase 14: {seconds:.1f}s; eager and capture launches {json.dumps(got)};"
        f" launches inside its captures {json.dumps(modes)}")
    return dict(card=card, closed_loop_rate=rate, headline=headline,
                submitters=1, clients=SERVE_CLIENTS, hold_max_s=SERVE_HOLD_S,
                submit=SERVE_SUBMIT, zipf=SERVE_ZIPF, step_s=SERVE_STEP_S, steps=steps,
                threads_step=threaded, switch_step=switched, cache=cached, captures_b_c=captures,
                writes=writes, pins=pins, modes_in_captures=modes, launches=got,
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 15: decision provenance (the witness plane of the flat program)
# ---------------------------------------------------------------------------

#: phase 15's latency tier, its parity batches and its timed dispatches
WIT_TIER = 1_024
WIT_BATCHES = 20
WIT_DISPATCHES = 1_000
#: config 3 rows explained one by one, and through a serving handle
WIT_EXPLAIN = 256
WIT_SERVE = 64
#: config 2 rows a host-only client answers beside the card
WIT_HOST_ROWS = 2_000


class ApartLaunches:
    """Launch counts from zero for a phase that is not part of the main
    path: the Capture wrappers are off inside (its calls are no candidates
    for the kernel table's shapes), ``take()`` reads and zeroes the counts,
    and on exit the counts from before are restored exactly."""

    def __init__(self, K, cap=None):
        self.K, self.cap = K, cap

    def __enter__(self):
        K = self.K
        self.saved = dict(K.LAUNCHES), dict(K.LANES)
        K.reset_launches()
        if self.cap is not None:
            K.fused_probe, K.fused_probe_aligned = self.cap.orig, self.cap.orig_aligned
        return self

    def take(self):
        got = {k: v for k, v in self.K.LAUNCHES.items() if v}
        self.K.reset_launches()
        return got

    def __exit__(self, *exc):
        K = self.K
        if self.cap is not None:
            K.fused_probe, K.fused_probe_aligned = self.cap.wrapped, self.cap.wrapped_aligned
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = self.saved[0][k]
            K.LANES[k] = self.saved[1][k]
        return False


def wit_histogram(codes):
    """Witness codes of a batch by branch name (0: no witness)."""
    from gochugaru_tpu_torch.engine.explain import witness_name

    vals, counts = np.unique(codes, return_counts=True)
    return {f"{witness_name(int(v)) or 'none'}/{int(v)}": int(n)
            for v, n in zip(vals, counts)}


def wit_world(K, apart, name, ek, ep, ds, q, ctx=None):
    """Phase 15 (a) on one prepared world: the batch's witness codes
    through the armed program with the kernels and with the plain twins,
    bit for bit; the armed planes equal the disarmed program's; a code
    exactly on the rows the card settles as allowed; the code histogram;
    the armed program's launches per mode, equal to the disarmed
    program's; armed against disarmed batch ms (median of 4,
    alternating).  Returns the row and the codes."""
    q_ctx, qctx_rows = ctx if ctx is not None else (None, None)
    kw = dict(q_ctx=q_ctx, qctx_rows=qctx_rows, now_us=EPOCH)
    apart.take()
    codes, planes = ek.witness_codes_columns(ds, *q, planes=True, **kw)
    launches = apart.take()
    pcodes, pplanes = ep.witness_codes_columns(ds, *q, planes=True, **kw)
    if codes.dtype != np.int32 or not np.array_equal(codes, pcodes):
        raise AssertionError(f"witness {name}: codes differ, kernels vs plain"
                             f" ({int((codes != pcodes).sum())} rows)")
    for nm, a, b in zip("dpo", planes, pplanes):
        if not np.array_equal(a, b):
            raise AssertionError(f"witness {name}: armed plane {nm} differs, kernels vs plain")
    disarmed = ek.check_columns(ds, *q, **kw)
    disarmed_launches = apart.take()
    if launches != disarmed_launches:
        raise AssertionError(f"witness {name}: the armed program launched {launches},"
                             f" the disarmed one {disarmed_launches}")
    for nm, a, b in zip("dpo", planes, disarmed):
        if not np.array_equal(a, b):
            raise AssertionError(f"witness {name}: armed plane {nm} differs from the"
                                 " disarmed program's")
    d, _p, ovf = planes
    if not np.array_equal(codes != 0, d & ~ovf):
        raise AssertionError(f"witness {name}: codes not exactly on the rows the card"
                             " settles as allowed")
    if DEV == "cuda" and not launches:
        raise AssertionError(f"witness {name}: the armed program launched no kernel")
    times = {"armed": [], "disarmed": []}
    for order in (("disarmed", "armed", "armed", "disarmed"),) * 2:
        for which in order:
            ts = time.perf_counter()
            if which == "armed":
                ek.witness_codes_columns(ds, *q, **kw)
            else:
                ek.check_columns(ds, *q, **kw)
            times[which].append(time.perf_counter() - ts)
    apart.take()
    row = dict(batch=int(q[0].shape[0]), histogram=wit_histogram(codes),
               own_launches=launches,
               armed_ms=float(np.median(times["armed"])) * 1e3,
               disarmed_ms=float(np.median(times["disarmed"])) * 1e3)
    log(f"witness {name}: codes bit-equal kernels vs plain, armed planes and launches"
        f" equal the disarmed ones; {json.dumps(row)}")
    return row, codes


def wit_rels(names, idx):
    from gochugaru_tpu_torch import rel

    return [rel.must_from_triple(f"{names[i][0]}:{names[i][1]}", names[i][2],
                                 f"{names[i][3]}:{names[i][4]}") for i in idx]


def wit_explain(client, ek, rels):
    """Phase 15 (b): ``Client.explain`` of each row at the head; verdicts
    equal the check's, each tree holds its witness (witness_consistent)
    where the card settled the row; per-explain ms."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.engine.explain import witness_consistent, witness_name
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    cs = consistency.full()
    verdicts = client.check(ctx, cs, *rels)
    snap = client.store.snapshot_for(cs)
    head = client._dsnap_for(ek, snap)
    codes = ek.witness_codes(head, rels)
    ms, seeded, unseeded = [], 0, 0
    for i, r in enumerate(rels):
        t0 = time.perf_counter()
        tree = client.explain(ctx, cs, r)
        ms.append((time.perf_counter() - t0) * 1e3)
        if (tree["result"] == "allowed") != verdicts[i]:
            raise AssertionError(f"witness (b): row {i} explains {tree['result']},"
                                 f" the check said {verdicts[i]}")
        wc = int(codes[i])
        if wc or not verdicts[i]:
            if not witness_consistent(tree, wc):
                raise AssertionError(f"witness (b): row {i}'s tree does not hold its"
                                     f" witness {witness_name(wc)}")
            if wc and tree.get("witness") != witness_name(wc):
                raise AssertionError(f"witness (b): row {i}'s walk was not seeded")
            seeded += wc != 0
        else:
            unseeded += 1  # allowed, settled on the host: no witness
    row = dict(rows=len(rels), revision=snap.revision, allowed=int(sum(verdicts)),
               seeded=seeded, host_settled_allowed=unseeded,
               histogram=wit_histogram(codes),
               explain_p50_ms=float(np.percentile(ms, 50)),
               explain_p99_ms=float(np.percentile(ms, 99)))
    log(f"witness (b) Client.explain: {json.dumps(row)}")
    return row


def wit_latency(client, ek, ep, q, rng, n_docs, n_users):
    """Phase 15 (c): ``arm_witness`` on the head's latency path at tier
    WIT_TIER (see the module docstring)."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    m = metrics.default
    ctx = background()
    head = client._dsnap_cache[max(client._dsnap_cache)]
    lp = ek.latency_path(head)

    def batch(B=None):
        B = int(rng.integers(WIT_TIER // 2 + 1, WIT_TIER + 1)) if B is None else B
        at = int(rng.integers(0, q[0].shape[0] - B))
        return tuple(c[at:at + B] for c in q)

    def held(path, dsnap, qb, label):
        got = path.dispatch_columns(*qb, now_us=EPOCH)
        d, p, ovf = got
        want = ek.witness_codes_columns(dsnap, *qb, now_us=EPOCH)
        plain = ep.witness_codes_columns(dsnap, *qb, now_us=EPOCH)
        wit = path.last_witness.copy()
        wit[(p & ~d) | ovf] = 0
        if not (np.array_equal(wit, want) and np.array_equal(want, plain)):
            raise AssertionError(f"witness (c) {label}: last_witness differs from the"
                                 " eager codes")
        for nm, a, b in zip("dpo", got, ek.check_columns(dsnap, *qb, now_us=EPOCH)):
            if not np.array_equal(a, b):
                raise AssertionError(f"witness (c) {label}: plane {nm} differs from"
                                     " the eager program's")

    disarmed = set(lp.pins())
    lp.dispatch_columns(*batch(WIT_TIER), now_us=EPOCH)
    c0 = m.counter("latency.compiles")
    lp.arm_witness()
    for i in range(WIT_BATCHES):
        held(lp, head, batch(), f"batch {i}")
    armed_keys = [k for k in lp.pins() if k[-1] == "wit"]
    captures = int(m.counter("latency.compiles") - c0)
    if captures != 1 or len(armed_keys) != 1:
        raise AssertionError(f"witness (c): {captures} captures, armed pins {armed_keys}")
    if not disarmed <= set(lp.pins()):
        raise AssertionError("witness (c): arming evicted a disarmed pin")
    # armed against disarmed replays of one batch, alternating
    qb = batch(WIT_TIER)
    stage = {"armed": [], "disarmed": []}
    total = {"armed": [], "disarmed": []}
    c1 = m.counter("latency.compiles")
    for i in range(2 * WIT_DISPATCHES):
        which = "armed" if i % 2 == 0 else "disarmed"
        lp.arm_witness(which == "armed")
        lp.dispatch_columns(qb[0], qb[1], np.roll(qb[2], i), now_us=EPOCH)
        stage[which].append(lp.last_budget.kernel_s * 1e3)
        total[which].append(lp.last_budget.total_s * 1e3)
    recaptures = int(m.counter("latency.compiles") - c1)
    if recaptures:
        raise AssertionError(f"witness (c): {recaptures} recaptures over"
                             f" {2 * WIT_DISPATCHES} dispatches")
    # a write that keeps the band: a rebind, no capture, armed and disarmed
    wr = random.Random(61)
    key = lp._share_key()
    for attempt in range(3):
        granted = rel.must_from_triple(f"document:d{wr.randrange(n_docs)}", "viewer",
                                       f"user:u{wr.randrange(n_users)}")
        txn = rel.Txn()
        txn.touch(granted)
        tok = client.write(ctx, txn)
        got = client.check(ctx, consistency.at_least(tok), rel.must_from_triple(
            f"document:{granted.resource_id}", "view", f"user:{granted.subject_id}"))
        if got != [True]:
            raise AssertionError("witness (c): at_least did not see the write")
        nds = client._dsnap_cache[parse_revision(tok)]
        lp2 = ek.latency_path(nds)
        if nds.flat_meta.delta is not None and lp2._share_key() == key:
            break
    else:
        raise AssertionError("witness (c): no write of three kept the band")
    c2 = m.counter("latency.compiles")
    lp2.arm_witness()
    held(lp2, nds, qb, "after the write")
    rebind = lp2.last_budget.rebind_bytes
    lp2.arm_witness(False)
    lp2.dispatch_columns(*qb, now_us=EPOCH)
    lp.arm_witness(False)
    lp.dispatch_columns(*qb, now_us=EPOCH)
    write_captures = int(m.counter("latency.compiles") - c2)
    if write_captures or not rebind or lp2.last_witness is not None:
        raise AssertionError(f"witness (c): after the write {write_captures} captures,"
                             f" {rebind} bytes rebound")
    row = dict(tier=WIT_TIER, batches=WIT_BATCHES, captures_armed=captures,
               dispatches=2 * WIT_DISPATCHES, recaptures=recaptures,
               replay_p50_ms={k: float(np.percentile(v, 50)) for k, v in stage.items()},
               total_p50_ms={k: float(np.percentile(v, 50)) for k, v in total.items()},
               total_p99_ms={k: float(np.percentile(v, 99)) for k, v in total.items()},
               write=dict(revision=nds.revision, attempts=attempt + 1,
                          rebind_bytes=int(rebind), captures=write_captures),
               pins=len(lp.pins()))
    log(f"witness (c) arm_witness: {json.dumps(row)}")
    return row


def wit_serving(client, ek, rels):
    """Phase 15 (d): ``ServingHandle.check(explain=True)`` on the client
    phase 14 served: its verdicts equal a plain handle check's, each tree
    agrees with its verdict and holds the card's witness."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.engine.explain import witness_consistent
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    cs = consistency.full()
    with client.with_serving(cs=cs, cache=False) as h:
        got = h.check(ctx, *rels, explain=True)
        plain = h.check(ctx, *rels)
    if [e.allowed for e in got] != plain:
        raise AssertionError("witness (d): explained verdicts differ from the handle's")
    head = client._dsnap_for(ek, client.store.snapshot_for(cs))
    codes = ek.witness_codes(head, rels)
    for i, e in enumerate(got):
        t, wc = e.explanation, int(codes[i])
        if t.get("verdict_skew") or (t["result"] == "allowed") != e.allowed:
            raise AssertionError(f"witness (d): row {i}'s tree disagrees with its verdict")
        if (wc or not e.allowed) and not witness_consistent(t, wc):
            raise AssertionError(f"witness (d): row {i}'s tree does not hold its witness")
    row = dict(rows=len(rels), allowed=int(sum(plain)),
               seeded=sum("witness" in e.explanation for e in got))
    log(f"witness (d) ServingHandle.check(explain=True): {json.dumps(row)}")
    return row


def wit_host_only(K, apart, snap, names):
    """Phase 15 (e): a host-only client on config 2 (the relationships of
    the snapshot phase 4 built, imported) answers checks, lookups and a
    paged walk as a card client over the same store (``with_store``)
    does, and moves no launch counter."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_host_only_evaluation, with_store,
    )
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    cs = consistency.full()
    t0 = time.perf_counter()
    host = new_evaluator(with_host_only_evaluation())
    host.write_schema(ctx, RBAC_SCHEMA)
    host.import_relationships(ctx, snap.iter_relationships())
    card_c = new_evaluator(with_store(host.store), device=DEV)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(73)
    rels = wit_rels(names, rng.choice(len(names), WIT_HOST_ROWS, replace=False))
    user = f"user:u{int(rng.integers(0, 1000))}"
    repo = f"repo:r{int(rng.integers(0, 10_000))}"

    def answers(c):
        pages, cur = [], None
        while True:
            page = c.lookup_resources_page(ctx, cs, "repo#admin", user, page_size=64,
                                           cursor=cur)
            pages.extend(page.ids)
            cur = page.cursor
            if cur is None:
                break
        return (c.check(ctx, cs, *rels),
                sorted(c.lookup_resources(ctx, cs, "repo#read", user)),
                sorted(c.lookup_subjects(ctx, cs, repo, "read", "user")),
                sorted(pages))

    apart.take()
    t0 = time.perf_counter()
    got_host = answers(host)
    host_s = time.perf_counter() - t0
    host_launches = apart.take()
    t0 = time.perf_counter()
    got_card = answers(card_c)
    card_s = time.perf_counter() - t0
    card_launches = apart.take()
    if host._engine is not None or host.device is not None:
        raise AssertionError("witness (e): the host-only client built an engine")
    if host_launches:
        raise AssertionError(f"witness (e): the host-only client launched {host_launches}")
    if DEV == "cuda" and not card_launches:
        raise AssertionError("witness (e): the card client launched no kernel")
    if got_host != got_card:
        raise AssertionError("witness (e): the host-only client answers differ from the card's")
    row = dict(rows=len(rels), allowed=int(sum(got_host[0])),
               lookup_resources=len(got_host[1]), lookup_subjects=len(got_host[2]),
               paged=len(got_host[3]), import_s=load_s, host_s=host_s, card_s=card_s,
               card_launches=card_launches)
    log(f"witness (e) host-only client on config2: {json.dumps(row)}")
    return row


def phase_witness_client(K, cap, client, ek, ep, ds, q, names, n_docs, n_users):
    """Phase 15, its client part (see the module docstring): (a) on config
    3 off+interleave, at its full prepare and at the client's head, and
    (b)-(d) on the client phase 14 served."""
    t15 = time.perf_counter()
    out = {}
    with ApartLaunches(K, cap) as apart:
        out["config3"] = wit_world(K, apart, "config3", ek, ep, ds, q)[0]
        head = client._dsnap_cache[max(client._dsnap_cache)]
        out["config3 head"], codes = wit_world(
            K, apart, f"config3 head (revision {head.revision})", ek, ep, head, q)
        del head
        # half the sample from the rows the card allows (about 0.2% of the
        # batch), so the walks the witness seeds are explained too
        rng = np.random.default_rng(71)
        allowed = np.flatnonzero(codes)
        pick = rng.choice(allowed, min(WIT_EXPLAIN // 2, allowed.size), replace=False)
        rest = np.setdiff1d(np.arange(len(names)), pick)
        pick = np.concatenate([pick, rng.choice(rest, WIT_EXPLAIN - pick.size,
                                                replace=False)])
        rels = wit_rels(names, rng.permutation(pick))
        out["explain"] = wit_explain(client, ek, rels)
        out["latency"] = wit_latency(client, ek, ep, q, rng, n_docs, n_users)
        out["serving"] = wit_serving(client, ek, rels[:WIT_SERVE])
        out["launches_b_d"] = apart.take()
    out["seconds"] = time.perf_counter() - t15
    log(f"phase 15, client part: {out['seconds']:.1f}s; launches in (b)-(d)"
        f" {json.dumps(out['launches_b_d'])}")
    return out


def phase_witness_worlds(K, rbac, card, part):
    """Phase 15, the rest (see the module docstring): (a) on config 3
    aligned, config 2 under both layouts and config 4's ``holder`` batch
    under both, (e) a host-only client on config 2, (f) no witness error
    over the phase.  ``part`` is the client part's object; returns the
    ``witness:`` line's object."""
    from gochugaru_tpu_torch.utils import metrics

    t15 = time.perf_counter()
    W = LATENCY_WORLDS
    worlds = {k: part[k] for k in ("config3", "config3 head")}
    with ApartLaunches(K) as apart:
        for name in ("config3 aligned", "config2", "config2 aligned"):
            w = W[name]
            worlds[name] = wit_world(K, apart, name, w["ek"], w["ep"], w["ds"], w["q"])[0]
        for name in ("config4", "config4 aligned"):
            w = W[name]
            worlds[name + " holder"] = wit_world(K, apart, name + " holder", w["ek"],
                                                 w["ep"], w["ds"], w["hq"], ctx=w["ctx"])[0]
        host = wit_host_only(K, apart, W["config2"]["ds"].snapshot, rbac[3])
    errors = int(metrics.default.counter("explain.witness_errors"))
    if errors:
        raise AssertionError(f"witness (f): explain.witness_errors = {errors}")
    seconds = part["seconds"] + time.perf_counter() - t15
    log(f"witness (f): explain.witness_errors = 0; phase 15: {seconds:.1f}s")
    return dict(card=card, worlds=worlds, explain=part["explain"],
                latency=part["latency"], serving=part["serving"], host_only=host,
                launches_b_d=part["launches_b_d"], witness_errors=errors,
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 16: the operations layer (flight recorder, SLO engine, telemetry
# endpoint, /perf with the measured roofline, with_profiling, group commit
# with the chain compactor)
# ---------------------------------------------------------------------------

#: the probe kernels' entry points in a profiler trace (csrc/)
PROBE_KERNELS = ("gochugaru_slot_tile_kernel", "gochugaru_warp_reduce_kernel",
                 "fused_runs_kernel")
OPS_BATCH = 4_096
OPS_BATCHES = 20
OPS_PROFILED = 2
OPS_WRITERS, OPS_TXNS = 64, 4
OPS_LAT_TIER, OPS_LAT_DISPATCHES, OPS_ROUNDS = 1_024, 1_000, 2


def ops_get(url, accept=None):
    import urllib.request

    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def ops_prom_count(text, name):
    """The value of one sample line of exposition text (0 when absent)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def ops_union(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def ops_trace(path):
    """One profiled dispatch's torch.profiler trace: the dispatch window
    (the ``gochugaru:`` range annotate_dispatch emits), the device busy
    share of that window and of the whole profile (the union of kernel,
    memcpy and memset intervals), the 10 device operations with the most
    total time, and the probe kernels' launches."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev and DEV == "cuda":  # a CPU rehearsal has no device timeline
        raise AssertionError(f"telemetry (c): {path} holds no device activity")
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
    ann = [e for e in ev if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("gochugaru:")]
    if len(ann) != 1:
        raise AssertionError(f"telemetry (c): {len(ann)} gochugaru: ranges in {path}")
    w0 = float(ann[0]["ts"])
    w1 = w0 + float(ann[0]["dur"])
    p0 = min(float(e["ts"]) for e in ev)
    p1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in ev)
    ops = {}
    for e in dev:
        n, t = ops.setdefault(e["name"][:96], [0, 0.0])
        ops[e["name"][:96]] = [n + 1, t + float(e.get("dur", 0))]
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        window_ms=(w1 - w0) / 1e3, profile_ms=(p1 - p0) / 1e3,
        busy_share=ops_union(iv, w0, w1) / max(w1 - w0, 1e-9),
        busy_share_profile=ops_union(iv, p0, p1) / max(p1 - p0, 1e-9),
        device_ms=sum(b - a for a, b in iv) / 1e3,
        top=[dict(name=n, count=c, ms=t / 1e3) for n, (c, t) in top],
        probe_launches=sum(1 for e in dev if e.get("cat") == "kernel"
                           and any(k in e["name"] for k in PROBE_KERNELS)))


def ops_endpoints(tel, rels, base):
    """Phase 16 (a): OPS_BATCHES batches of OPS_BATCH checks, half eager
    and half on the latency path, then every endpoint scraped over HTTP."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils import perf as _perf
    from gochugaru_tpu_torch.utils.context import background

    ctx, url = background(), tel.telemetry.url
    prom = "gochugaru_checks_dispatch_seconds_count"
    n0 = ops_prom_count(ops_get(url + "/metrics")[2], prom)
    ms = {"eager": [], "latency": []}
    for b in range(OPS_BATCHES):
        side = "eager" if b < OPS_BATCHES // 2 else "latency"
        tel._latency_mode = side == "latency"
        batch = rels[b * OPS_BATCH:(b + 1) * OPS_BATCH]
        t0 = time.perf_counter()
        got = tel.check(ctx, consistency.full(), *batch)
        ms[side].append((time.perf_counter() - t0) * 1e3)
        if got != base[b * OPS_BATCH:(b + 1) * OPS_BATCH]:
            raise AssertionError(f"telemetry (a): batch {b} ({side}) disagrees with"
                                 " the plain client")
    tel._latency_mode = False
    out = dict(batch_ms={k: float(np.median(v)) for k, v in ms.items()})
    _, ctype, text = ops_get(url + "/metrics")
    n1 = ops_prom_count(text, prom)
    _, om_type, om = ops_get(url + "/metrics", "application/openmetrics-text")
    n_om = ops_prom_count(om, prom)
    if not (n1 - n0 == OPS_BATCHES and n_om == n1 and om.endswith("# EOF\n")
            and om_type.startswith("application/openmetrics-text")):
        raise AssertionError(f"telemetry (a): checks.dispatch counted {n1 - n0}"
                             f" (openmetrics {n_om - n0}) for {OPS_BATCHES} batches")
    out["metrics"] = dict(checks_dispatch=n1 - n0, text_bytes=len(text),
                          openmetrics_bytes=len(om))
    bench = json.loads(ops_get(url + "/perf?bench=1")[2])
    bw = bench["roofline"]
    cached = json.loads(ops_get(url + "/perf")[2])["roofline"]
    if bw is None or bw["cached"] or not cached or cached["gbps"] != bw["gbps"]:
        raise AssertionError(f"telemetry (a): /perf?bench=1 {bw}, then /perf {cached}")
    if not bw or bw.get("platform") != ("gpu" if DEV == "cuda" else DEV):
        raise AssertionError(f"telemetry (a): /perf?bench=1 measured {bw}")
    if bw["gbps"] > 1.05 * H100_BYTES_PER_S / 1e9:
        raise AssertionError(f"telemetry (a): {bw['gbps']} GB/s is past 105% of"
                             f" the H100's {H100_BYTES_PER_S / 1e9:.0f} GB/s")
    log(f"telemetry (a) measure_bandwidth on the card: {bw['gbps']} GB/s beside"
        f" the data sheet's {H100_BYTES_PER_S / 1e9:.0f} GB/s"
        f" ({bw['gbps'] / (H100_BYTES_PER_S / 1e9):.3f} of it), triad of"
        f" {bw['bytes_moved']} B, best of {bw['reps']}: {bw['best_s'] * 1e3:.4f} ms")
    comp = json.loads(ops_get(url + "/perf?compile=1")[2])
    bad = [e for e in comp["cost"] if e.get("pending") or not e.get("unavailable")]
    if not comp["cost"] or bad:
        raise AssertionError(f"telemetry (a): /perf?compile=1 entries {bad[:3]}")
    head = tel._dsnap_cache[max(tel._dsnap_cache)]
    km = _perf.kernel_bytes_model(head)
    out["perf"] = dict(
        roofline_gbps=bw["gbps"], roofline_best_ms=bw["best_s"] * 1e3,
        roofline_fingerprint=bw["fingerprint"], cost_entries=len(comp["cost"]),
        cost_kinds=sorted({e["kind"] for e in comp["cost"]}),
        bytes_model_total=comp["bytes_model"]["total"],
        head_bytes_per_check=_perf.gathered_bytes_model(head).total,
        kernel_bytes_per_check=sum(v["kernels"] for v in km.values()),
        kernel_bytes_saved_per_check=sum(v["saved"] for v in km.values()),
        gauge_kernels_bytes_per_check=metrics.default.gauge(
            "perf.kernels.bytes_per_check"),
        sections=sorted(comp))
    slo = json.loads(ops_get(url + "/slo")[2])
    health = json.loads(ops_get(url + "/healthz")[2])
    if not slo["enabled"] or health["status"] != "ok":
        raise AssertionError(f"telemetry (a): /slo {slo.get('enabled')},"
                             f" /healthz {health}")
    traces = ops_get(url + "/traces")[2].splitlines()
    dec = [json.loads(ln) for ln in ops_get(url + "/decisions?n=64")[2].splitlines()]
    if not dec[0]["enabled"] or len(dec) < 2:
        raise AssertionError(f"telemetry (a): /decisions served {dec[:1]}")
    out.update(slo=dict(healthy=slo["healthy"], slos=len(slo["slos"])),
               healthz=health["status"], traces=len(traces),
               decisions=len(dec) - 1)
    log(f"telemetry (a): {json.dumps(out)}")
    return out


def ops_incident(tel, rels, inc_dir):
    """Phase 16 (b): faults on the latency dispatch site until the breaker
    trips; the bundle, on disk and at /debug/incidents/<id>; then the
    breaker closes again."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.utils import faults, metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx, br = background(), tel._admission.breaker
    tel._latency_mode = True
    batch = rels[:256]
    want = tel.check(ctx, consistency.full(), *batch)
    trips = metrics.default.counter("breaker.trips")
    faults.arm("latency.dispatch", times=br.threshold)
    try:
        t0 = time.perf_counter()
        got = tel.check(ctx, consistency.full(), *batch)
        trip_ms = (time.perf_counter() - t0) * 1e3
    finally:
        faults.reset()
    if got != want or metrics.default.counter("breaker.trips") != trips + 1:
        raise AssertionError("telemetry (b): the breaker did not trip once, or the"
                             " answers changed")
    state_open = br.state
    tel.recorder.flush()
    files = [f for f in os.listdir(inc_dir) if "breaker.trip" in f]
    if len(files) != 1:
        raise AssertionError(f"telemetry (b): bundles in the incident dir: {files}")
    with open(os.path.join(inc_dir, files[0])) as f:
        text = f.read()
    lines = [json.loads(ln) for ln in text.splitlines()]
    head = lines[0]
    trs = [t for t in lines if t["kind"] == "trace"]
    failing = [t["trace_id"] for t in trs if any(
        "error" in (sp.get("attrs") or {}) for sp in t["spans"])]
    keys = sorted(head["context"])
    if (head["trigger"] != "breaker.trip" or not failing
            or not set(failing) <= set(head["trace_ids"])
            or not any(k.startswith("admission") for k in keys)
            or not any(k.startswith("perf") for k in keys)
            or not head.get("decisions")):
        raise AssertionError(f"telemetry (b): bundle head {json.dumps(head)[:400]}")
    served = ops_get(f"{tel.telemetry.url}/debug/incidents/{head['id']}")[2]
    if served != text:
        raise AssertionError("telemetry (b): /debug/incidents/<id> differs from the file")
    time.sleep(tel._admission.config.breaker_cooldown_s + 0.05)
    if tel.check(ctx, consistency.full(), *batch) != want or br.state != 0:
        raise AssertionError(f"telemetry (b): the breaker is {br.state} after the probe")
    tel._latency_mode = False
    out = dict(trigger=head["trigger"], info=head["info"], bundle_bytes=len(text),
               traces=len(trs), failing_traces=len(failing), context=keys,
               decisions=len(head["decisions"]), breaker_open=state_open,
               breaker_after=br.state, check_through_trip_ms=trip_ms,
               lines=[ln["kind"] for ln in lines][:1] + sorted(
                   {ln["kind"] for ln in lines[1:]}))
    log(f"telemetry (b): {json.dumps(out)}")
    return out


def ops_profiled(K, tel, rels, base, prof_dir):
    """Phase 16 (c): OPS_PROFILED profiled batches of the 100,000 checks:
    one trace each, read back."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    n0 = metrics.default.snapshot().get("checks.device_time_s.count", 0)
    rows = []
    tel._profile_dir = prof_dir
    try:
        for b in range(OPS_PROFILED):
            before = set(os.listdir(prof_dir))
            K.reset_launches()
            t0 = time.perf_counter()
            got = tel.check(ctx, consistency.full(), *rels)
            wall = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            new = sorted(set(os.listdir(prof_dir)) - before)
            if got != base or len(new) != 1:
                raise AssertionError(f"telemetry (c): batch {b}: {len(new)} traces,"
                                     f" answers equal: {got == base}")
            row = ops_trace(os.path.join(prof_dir, new[0]))
            if DEV == "cuda" and (row["probe_launches"] != sum(launches.values())
                                  or not launches.get("block")):
                raise AssertionError(f"telemetry (c): the trace holds"
                                     f" {row['probe_launches']} probe kernels, the"
                                     f" wrappers counted {launches}")
            row.update(wall_ms=wall, launches=launches,
                       trace_bytes=os.path.getsize(os.path.join(prof_dir, new[0])))
            rows.append(row)
            log(f"telemetry (c) profiled batch {b}: {json.dumps(row)}")
    finally:
        tel._profile_dir = None
    n = metrics.default.snapshot()["checks.device_time_s.count"] - n0
    if n != OPS_PROFILED:
        raise AssertionError(f"telemetry (c): checks.device_time_s counted {n}")
    return dict(batches=rows, device_time_count=n,
                busy_share=[r["busy_share"] for r in rows],
                busy_share_profile=[r["busy_share_profile"] for r in rows])


def ops_group_commit(tel, n_docs, n_users, n_groups, direct):
    """Phase 16 (d): OPS_WRITERS threads x OPS_TXNS transactions through
    the committer, then 256 checks at ``at_least(last token)``."""
    import threading

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.store.store import RevisionToken, parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx, store = background(), tel.store
    head0, log0 = store.head_revision, len(store._log)
    groups0 = metrics.default.counter("write.groups")
    toks, errs, lock = [], [], threading.Lock()
    touched = []

    def writer(w):
        rng = random.Random(1000 + w)
        try:
            for _ in range(OPS_TXNS):
                txn = rel.Txn()
                if rng.random() < 0.5:
                    r = rel.must_from_triple(f"document:d{rng.randrange(n_docs)}",
                                             "viewer", f"user:u{rng.randrange(n_users)}")
                else:
                    r = rel.must_from_tuple(f"group:g{rng.randrange(n_groups)}#member",
                                            f"user:u{rng.randrange(n_users)}")
                txn.touch(r)
                tok = tel.write(ctx, txn)
                with lock:
                    toks.append(parse_revision(tok))
                    touched.append(r)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(OPS_WRITERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    t1 = time.perf_counter()
    n = OPS_WRITERS * OPS_TXNS
    if errs or len(toks) != n or any(t.is_alive() for t in threads):
        raise AssertionError(f"telemetry (d): {len(toks)} of {n} writes, errors {errs[:2]}")
    ends = [e.revision for e in store._log[log0:]]
    sizes = [b - a for a, b in zip([head0] + ends[:-1], ends)]
    groups = metrics.default.counter("write.groups") - groups0
    if sorted(toks) != list(range(head0 + 1, head0 + n + 1)) or sum(sizes) != n \
            or len(sizes) != groups or groups >= n // 4:
        raise AssertionError(f"telemetry (d): tokens not dense and unique, or"
                             f" {groups} groups (sizes {sizes[:16]})")
    last = max(toks)
    rng = random.Random(77)
    checks = [rel.must_from_triple(f"document:{r.resource_id}", "view", f"user:{r.subject_id}")
              for r in touched if r.resource_type == "document"][:64]
    checks += [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "view",
                                    f"user:{r.subject_id}")
               for r in touched if r.resource_type == "group"][:64]
    checks += [rel.must_from_triple(f"document:d{rng.randrange(n_docs)}", "view",
                                    f"user:u{rng.randrange(n_users)}")
               for _ in range(256 - len(checks))]
    got = tel.check(ctx, consistency.at_least(RevisionToken(last)), *checks)
    t2 = time.perf_counter()
    nds = tel._dsnap_cache[store.head_revision]
    if nds.flat_meta.delta is None or nds.delta_acc is None:
        raise AssertionError(
            f"telemetry (d): the first check took a full prepare (node radix"
            f" {nds.flat_meta.N} vs nodes {nds.snapshot.num_nodes}, edges"
            f" {nds.snapshot.num_edges})")
    oracle = SnapshotOracle(nds.snapshot, {}, now_us=None)
    if got != [oracle.check_relationship(c) == T for c in checks] or not got[0]:
        raise AssertionError("telemetry (d): answers disagree with the oracle")
    out = dict(txns=n, groups=groups, group_sizes=sizes,
               txns_per_s=n / (t1 - t0), write_ms=(t1 - t0) * 1e3,
               first_check_ms=(t2 - t1) * 1e3, revision=nds.revision,
               delta=True, direct=[dict(write_ms=w, first_check_ms=c)
                                   for _i, w, c, _f in direct])
    log(f"telemetry (d) group commit: {n} transactions from {OPS_WRITERS} threads in"
        f" {out['write_ms']:.3f} ms ({out['txns_per_s']:.1f} transactions/s),"
        f" {groups} groups (sizes {sizes}), tokens dense and unique; write -> first"
        f" check {out['first_check_ms']:.3f} ms (delta prepare of revision"
        f" {nds.revision} + 256 checks, oracle-equal) beside phase 11's direct"
        f" one-revision-a-write {json.dumps(out['direct'])}")
    return out


def ops_compactor(n_users=400, n_groups=60, n_folders=150, n_docs=1500):
    """Phase 16 (e): phase 12 (d)'s feature world through a cuda client
    with group commit and a small ``lsm_compact_min``: writes until the
    compactor merges the chain, then the next revision's 3,000 checks
    against the oracle."""
    import threading

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_engine_config, with_group_commit,
    )
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.schema import compile_schema, parse_schema
    from gochugaru_tpu_torch.store.group import GroupCommitConfig
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    cfg = EngineConfig.for_schema(compile_schema(parse_schema(FEATURE_SCHEMA)),
                                  lsm_compact_min=256)
    c = new_evaluator(with_engine_config(cfg), with_group_commit(
        GroupCommitConfig(max_group=64, hold_max_s=0.002, compact_poll_s=0.0)),
        device=DEV)
    try:
        c.write_schema(ctx, FEATURE_SCHEMA)
        rng = random.Random(41)
        c.import_relationships(ctx, feature_rels(rng, n_users, n_groups, n_folders, n_docs))
        probe = feature_checks(rng, n_users, n_groups, n_docs, 64)
        c.check(ctx, consistency.full(), *probe)
        merges0 = metrics.default.counter("store.bg_compactions")
        rounds, compacted = 0, False
        while not compacted and rounds < 40:
            rounds += 1

            def writer(w, r=rounds):
                lr = random.Random(r * 1000 + w)
                for _ in range(8):
                    txn = rel.Txn()
                    txn.touch(rel.must_from_tuple(f"doc:d{lr.randrange(n_docs)}#reader",
                                                  f"user:u{lr.randrange(n_users)}"))
                    c.write(ctx, txn)

            ths = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            c.check(ctx, consistency.full(), *probe)  # the device follows the chain
            compacted = c._compactor.poll_once()
        merges = metrics.default.counter("store.bg_compactions") - merges0
        if not compacted or merges < 1:
            raise AssertionError(f"telemetry (e): no compaction in {rounds} rounds")
        txn = rel.Txn()
        txn.touch(rel.must_from_triple("doc:d7", "reader", "user:u11"))
        tok = c.write(ctx, txn)
        checks = feature_checks(rng, n_users, n_groups, n_docs, 3000)
        t0 = time.perf_counter()
        got = c.check(ctx, consistency.at_least(tok), *checks)
        first_ms = (time.perf_counter() - t0) * 1e3
        snap = c.store.snapshot_for(consistency.at_least(tok))
        programs = {n: compile_cel(n, d.params, d.expression)
                    for n, d in snap.compiled.schema.caveats.items()}
        oracle = SnapshotOracle(snap, programs)
        want = [oracle.check_relationship(r) == T for r in checks]
        if got != want:
            raise AssertionError(f"telemetry (e): {sum(a != b for a, b in zip(got, want))}"
                                 " answers disagree with the oracle")
        ds = c._dsnap_cache[parse_revision(tok)]
        delta = ds.flat_meta is not None and ds.flat_meta.delta is not None
        out = dict(rounds=rounds, bg_compactions=merges, revision=snap.revision,
                   edges=snap.num_edges, prepare="delta" if delta else "full",
                   first_check_ms=first_ms, checks=len(checks), allowed=sum(want))
        log(f"telemetry (e) chain compactor: {json.dumps(out)}")
        return out
    finally:
        c._committer.close()
        c._compactor.close()


def ops_recorder_cost(tel, client, rels, q):
    """Phase 16 (f): the 100,000-check batch (``check``, once a side)
    and OPS_LAT_DISPATCHES tier-1,024 latency dispatches (a serving
    handle's ``check_columns`` with no hold-back, half a side) through
    the telemetry client (tracer, flight recorder and SLO engine
    installed) and phase 15's plain client (tracer and recorder
    removed), alternating in OPS_ROUNDS rounds; medians, no claim."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.serve import ServeConfig
    from gochugaru_tpu_torch.utils import trace as _trace
    from gochugaru_tpu_torch.utils.context import background

    ctx, cs = background(), consistency.full()
    tr, rec = _trace.get(), _trace.recorder()
    lat = [tuple(np.ascontiguousarray(a[i * OPS_LAT_TIER:(i + 1) * OPS_LAT_TIER])
                 for a in q) for i in range(8)]
    sides = {"telemetry": tel, "plain": client}
    ms = {s: {"batch": [], "latency": []} for s in sides}
    per_round = OPS_LAT_DISPATCHES // (2 * OPS_ROUNDS)
    scfg = ServeConfig(hold_max_s=0.0)

    def arm(side):
        _trace.install(tr if side == "telemetry" else None)
        _trace.install_recorder(rec if side == "telemetry" else None)

    answers = {}
    try:
        for side, c in sides.items():  # warm: each client's head, its pins
            arm(side)
            with c.with_serving(cs, scfg) as h:
                answers[side] = [np.asarray(h.check_columns(ctx, *lat[0])).tolist()]
        for r in range(OPS_ROUNDS):
            for side in (("plain", "telemetry") if r % 2 == 0 else ("telemetry", "plain")):
                c = sides[side]
                arm(side)
                if r == 0:  # the 100k batch once a side: ~6 s of host lowering
                    t0 = time.perf_counter()
                    answers[side].append(c.check(ctx, cs, *rels))
                    ms[side]["batch"].append((time.perf_counter() - t0) * 1e3)
                with c.with_serving(cs, scfg) as h:
                    for i in range(per_round):
                        t0 = time.perf_counter()
                        h.check_columns(ctx, *lat[i % len(lat)])
                        ms[side]["latency"].append((time.perf_counter() - t0) * 1e3)
    finally:
        arm("telemetry")
    if answers["telemetry"] != answers["plain"]:
        raise AssertionError("telemetry (f): the two clients' answers differ")
    out = {s: {k: float(np.median(v)) for k, v in d.items()} for s, d in ms.items()}
    out["dispatches"] = {s: len(d["latency"]) for s, d in ms.items()}
    out["batches"] = {s: len(d["batch"]) for s, d in ms.items()}
    out["kept_flight_traces"] = len(rec.traces())
    log(f"telemetry (f) the recorder's cost (medians, ms; no claim): {json.dumps(out)}")
    return out


def phase_operations(K, cap, client, q, names, direct, n_docs, n_users, n_groups):
    """Phase 16 (see the module docstring): the operations layer on the
    store and the prepared head of the client phases 11, 14 and 15 hold."""
    import tempfile

    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_admission_control, with_decision_log,
        with_group_commit, with_profiling, with_store, with_telemetry,
    )
    from gochugaru_tpu_torch.store.group import GroupCommitConfig
    from gochugaru_tpu_torch.utils import decisions, slo
    from gochugaru_tpu_torch.utils import perf as _perf
    from gochugaru_tpu_torch.utils import trace as _trace
    from gochugaru_tpu_torch.utils.admission import AdmissionConfig
    from gochugaru_tpu_torch.utils.context import background

    t16 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gochugaru_ops_")
    inc_dir, prof_dir = os.path.join(tmp, "incidents"), os.path.join(tmp, "profiles")
    os.makedirs(prof_dir)
    ctx = background()
    rels = wit_rels(names, range(len(names)))
    snap = client.store.snapshot_for(consistency.full())
    head = client._dsnap_for(client._engine, snap)
    # the plain client's answers to the batch, from its interned columns
    # (the device planes, the host oracle for the rows they flag)
    base = np.asarray(client._evaluate_columns_direct(
        snap, *q, latency=False)).tolist()
    t_setup = time.perf_counter() - t16
    tel = new_evaluator(
        with_store(client.store),
        with_telemetry(port=0, incident_dir=inc_dir),
        with_profiling(prof_dir),
        with_group_commit(GroupCommitConfig(max_group=256, hold_max_s=0.002)),
        with_admission_control(AdmissionConfig(breaker_threshold=2)),
        with_decision_log(sample_rate=0.01),
        device=DEV)
    tel._engine, tel._engine_schema = client._engine, snap.compiled
    # the bandwidth meter's cache in this run's directory: /perf?bench=1
    # measures afresh, and a plain /perf then serves that measurement
    _perf.ROOFLINE_CACHE_PATH = os.path.join(tmp, "roofline.json")
    tel._dsnap_cache[snap.revision] = head
    # with_profiling traces (c)'s dispatches only: the other steps measure
    # the unprofiled path
    tel._profile_dir = None
    out = dict(setup_s=t_setup, revision=snap.revision)
    try:
        steps = out["step_s"] = {}

        def step(name, fn):
            t0 = time.perf_counter()
            out[name] = fn()
            steps[name] = time.perf_counter() - t0

        with ApartLaunches(K, cap) as apart:
            step("endpoints", lambda: ops_endpoints(tel, rels, base))
            step("incident", lambda: ops_incident(tel, rels, inc_dir))
            decisions.install(None)  # sampled decisions only for (a)-(b)
            out["launches_a_b"] = apart.take()
            step("profiled", lambda: ops_profiled(K, tel, rels, base, prof_dir))
            apart.take()
            step("group_commit", lambda: ops_group_commit(
                tel, n_docs, n_users, n_groups, direct))
            out["launches_d"] = apart.take()
            step("compactor", ops_compactor)
            apart.take()
            step("recorder_cost", lambda: ops_recorder_cost(tel, client, rels, q))
            if DEV == "cuda" and not out["launches_d"].get("block"):
                raise AssertionError(f"telemetry (d): no block launch {out['launches_d']}")
    finally:
        tel._committer.close()
        tel._compactor.close()
        tel.telemetry.close()
        slo.install_engine(None)
        decisions.install(None)
        _trace.disable()
        tel._dsnap_cache.clear()
    out["seconds"] = time.perf_counter() - t16
    log(f"phase 16: {out['seconds']:.1f}s ({t_setup:.1f}s of it building the"
        f" 100,000 relationships and the plain client's answers; steps"
        f" {json.dumps(out['step_s'])})")
    return out


# ---------------------------------------------------------------------------
# phase 17: the tuner on the card (tune/) over BASELINE config 2
# ---------------------------------------------------------------------------

#: the tuner's mixed load, the profile of benchmarks/bench11_tune.py:1-34
#: and :139-220: interactive CheckMany submissions of TUNE_SUBMIT checks on
#: a Poisson clock (TUNE_RATE a second for TUNE_INTER_S seconds), bulk
#: CheckMany of TUNE_BULK_SUBMIT checks at TUNE_BULK_RATE, and a
#: duplicate-heavy round (TUNE_DUP submissions drawn from TUNE_DUP_KEYS
#: windows of the pool); users zipf TUNE_ZIPF, read 90% / admin 10%.  The
#: schedules are drawn once and replayed by both arms
TUNE_RATE = 400.0
TUNE_SUBMIT = 9
TUNE_INTER_S = 2.0
TUNE_BULK = 60
TUNE_BULK_SUBMIT = 300
TUNE_BULK_RATE = 70.0
TUNE_DUP = 300
TUNE_DUP_SUBMIT = 16
TUNE_DUP_KEYS = 24
TUNE_ZIPF = 1.2
TUNE_POOL = 1 << 16
#: the forced ladder (tests/test_tune.py:51), its jittered dispatches a
#: tier and layout, and the rows of each layout held against the oracle
TUNED_TIERS = (192, 576, 1344)
TUNE_DISPATCHES = 300
TUNE_ORACLE_ROWS = 2_000
#: the controller's ticks, each after TUNE_TICK_S of interactive load
TUNE_TICKS = 6
TUNE_TICK_S = 0.4


def tune_pool(store, n_repos, n_users, rng):
    """bench11's pool over the store's config 2 world: (res, perm, subj)
    columns and each row's (repo index, permission, user index)."""
    from gochugaru_tpu_torch import consistency

    snap = store.snapshot_for(consistency.full())
    inter, slot = snap.interner, snap.compiled.slot_of_name
    repos = np.array([inter.node("repo", f"r{i}") for i in range(n_repos)], np.int32)
    users = np.array([inter.node("user", f"u{i}") for i in range(n_users)], np.int32)
    ri = rng.integers(0, n_repos, TUNE_POOL)
    ui = (rng.zipf(TUNE_ZIPF, TUNE_POOL) - 1) % n_users
    admin = rng.random(TUNE_POOL) >= 0.9
    perm = np.where(admin, slot["admin"], slot["read"]).astype(np.int32)
    return dict(res=repos[ri], perm=perm, subj=users[ui], ri=ri, ui=ui, admin=admin,
                snap=snap)


def tune_schedules(rng):
    """The three profiles' fixed schedules: (arrivals s, pool offsets, n)."""
    n_inter = int(TUNE_RATE * TUNE_INTER_S)
    inter = (np.cumsum(rng.exponential(1.0 / TUNE_RATE, n_inter)),
             rng.integers(0, TUNE_POOL - TUNE_SUBMIT, n_inter), TUNE_SUBMIT)
    bulk = (np.cumsum(rng.exponential(1.0 / TUNE_BULK_RATE, TUNE_BULK)),
            rng.integers(0, TUNE_POOL - TUNE_BULK_SUBMIT, TUNE_BULK),
            TUNE_BULK_SUBMIT)
    keys = rng.integers(0, TUNE_POOL - TUNE_DUP_SUBMIT, TUNE_DUP_KEYS)
    dup = (np.cumsum(rng.exponential(1.0 / TUNE_RATE, TUNE_DUP)),
           rng.choice(keys, TUNE_DUP), TUNE_DUP_SUBMIT)
    return {"interactive": inter, "bulk": bulk, "duplicates": dup}


def tune_paced(h, pool, sched):
    """Open-loop arrivals from a fixed schedule; per-submission latency
    from the futures (the first 10% are the profile's warm transient)."""
    from gochugaru_tpu_torch.utils.context import background
    from gochugaru_tpu_torch.utils.errors import ShedError

    ctx = background()
    arrivals, starts, n = sched
    futs = []
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        for k, (a, s) in enumerate(zip(arrivals, starts)):
            slack = t0 + a - time.perf_counter()
            if slack > 0.0015:
                time.sleep(slack - 0.001)
            s = int(s)
            while True:
                try:
                    futs.append(h.submit_columns(
                        ctx, pool["res"][s:s + n], pool["perm"][s:s + n],
                        pool["subj"][s:s + n], client_id=k % 8))
                    break
                except ShedError:
                    time.sleep(0.001)
        outs = [f.result(timeout=120.0) for f in futs]
    finally:
        gc.enable()
    el = time.perf_counter() - t0
    lat = np.array([(f.t_done - f.t_submit) * 1e3 for f in futs[max(3, len(futs) // 10):]])
    return dict(submissions=len(futs), checks_per_s=len(futs) * n / el,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99))), (starts, n, outs)


def tune_occupancy_pad(m):
    """Pad waste of the formed batches: 1 - live lanes / tier lanes over
    the serve.occupancy.t* histograms (the tuner's own measure)."""
    live = lanes = 0.0
    for name, (_b, _c, count, total, _e) in m.hist_snapshot().items():
        if name.startswith("serve.occupancy.t"):
            live += total
            lanes += float(name[len("serve.occupancy.t"):]) * count
    return (1.0 - live / lanes) if lanes else None


def tune_oracle(pool, outs_of, rows):
    """``rows`` sampled answers of the arm vs the host oracle."""
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

    oracle = SnapshotOracle(pool["snap"], {}, now_us=EPOCH)
    bad = 0
    for starts, n, outs in outs_of:
        for s, out in list(zip(starts, outs))[:rows // max(1, len(outs_of))]:
            s = int(s)
            for j in range(n):
                i = s + j
                want = oracle.check("repo", f"r{pool['ri'][i]}",
                                    "admin" if pool["admin"][i] else "read",
                                    "user", f"u{pool['ui'][i]}", "", now_us=EPOCH) == T
                bad += bool(out[j]) != want
    return bad


def tune_arm(label, client, serve_cfg, pool, scheds, warm_tiers):
    """One arm: a serving handle, each tier's pins warmed sequentially,
    then the three profiles on the fixed schedules.  Returns the
    profiles' numbers, the occupancy pad waste of the window and the
    oracle mismatches of a sample of its answers."""
    from gochugaru_tpu_torch.utils import metrics

    h = client.with_serving(config=serve_cfg)
    try:
        from gochugaru_tpu_torch.utils.context import background

        ctx = background()
        for _ in range(2):
            for t in warm_tiers:
                n = min(int(t), TUNE_POOL - 1)
                h.submit_columns(ctx, pool["res"][:n], pool["perm"][:n],
                                 pool["subj"][:n]).result(timeout=120.0)
        metrics.default.reset()
        out, answers = {}, []
        for name, sched in scheds.items():
            out[name], ans = tune_paced(h, pool, sched)
            answers.append(ans)
        out["pad_waste"] = tune_occupancy_pad(metrics.default)
        out["oracle_mismatches"] = tune_oracle(pool, answers, 200)
    finally:
        h.close()
    log(f"tune {label}: {json.dumps(out)}")
    if out["oracle_mismatches"]:
        raise AssertionError(f"tune {label}: {out['oracle_mismatches']} answers"
                             " disagree with the host oracle")
    return out


def tune_ladder(K, cs, snap, q, names, layout):
    """The forced ladder TUNED_TIERS on one layout: TUNE_DISPATCHES
    jittered dispatches a tier; one capture per (permissions, tier), no
    recapture, replayed planes == check_columns' kernel planes == the
    plain planes, sampled rows == the host oracle, block and gate inside
    the captures."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.utils import metrics

    cfg = dict(latency_tiers=TUNED_TIERS, **layout)
    ek = DeviceEngine(cs, EngineConfig(kernels=DEV == "cuda" or None, **cfg), device=DEV)
    ep = DeviceEngine(cs, EngineConfig(kernels=False, **cfg), device=DEV)
    ds = ek.prepare(snap)
    lp = ek.latency_path(ds)
    rng = np.random.default_rng(17)
    oracle = SnapshotOracle(snap, {}, now_us=EPOCH)
    retr0 = metrics.default.counter("latency.retraces")
    n_q = q[0].shape[0]
    lo, keys, checked, bad, per_tier = 0, set(), 0, 0, {}
    per_dispatch = -(-TUNE_ORACLE_ROWS // (TUNE_DISPATCHES * len(TUNED_TIERS)))
    for tier in TUNED_TIERS:
        c0 = lp.compile_count
        times = []
        for i in range(TUNE_DISPATCHES):
            B = int(rng.integers(lo + 1, tier + 1))
            at = int(rng.integers(0, n_q - B))
            cols = (q[0][at:at + B], q[1][at:at + B], q[2][at:at + B])
            key = (tuple(np.unique(cols[1])), tier)
            t0 = time.perf_counter()
            got = lp.dispatch_columns(*cols, now_us=EPOCH)
            times.append(time.perf_counter() - t0)
            if lp.last_budget.tier != tier:
                raise AssertionError(f"B={B} served at tier {lp.last_budget.tier}, not {tier}")
            first = key not in keys
            keys.add(key)
            if first or i % 5 == 0:
                _lat_same(f"tuned ladder {layout} tier {tier} B={B}", got,
                          ek.check_columns(ds, *cols, now_us=EPOCH),
                          ep.check_columns(ds, *cols, now_us=EPOCH))
                checked += 1
            d, p, o = got
            for j in rng.choice(B, min(B, per_dispatch + 1), replace=False):
                rt, rid, perm, st, sid = names[at + j]
                want = oracle.check(rt, rid, perm, st, sid, "", now_us=EPOCH) == T
                gotj = want if (o[j] or (p[j] and not d[j])) else bool(d[j])
                bad += gotj != want
                per_tier[tier] = per_tier.get(tier, 0) + 1
        log(f"tuned ladder {layout}: tier {tier}: {TUNE_DISPATCHES} dispatches,"
            f" captures {lp.compile_count - c0}, p50/p99 ms {_ms_p(times)}")
        lo = tier
    pins = lp.pins()
    modes = _lat_modes([lp])
    recaptures = metrics.default.counter("latency.retraces") - retr0
    rows = sum(per_tier.values())
    out = dict(captures=lp.compile_count, keys=len(keys), pins=len(pins),
               captures_per_tier={str(t): sum(1 for k in keys if k[1] == t)
                                  for t in TUNED_TIERS},
               recaptures=recaptures, planes_checked=checked, oracle_rows=rows,
               oracle_mismatches=bad, modes_in_captures=modes)
    log(f"tuned ladder {layout}: {json.dumps(out)}")
    if lp.compile_count != len(keys) or len(pins) != len(keys) or recaptures:
        raise AssertionError(f"tuned ladder {layout}: {lp.compile_count} captures for"
                             f" {len(keys)} (permissions, tier) keys, {recaptures} recaptures")
    if bad or rows < TUNE_ORACLE_ROWS:
        raise AssertionError(f"tuned ladder {layout}: {bad} of {rows} sampled rows"
                             " disagree with the oracle (or too few rows)")
    pre = "aligned." if layout.get("flat_aligned") else ""
    missing = [m for m in (pre + "block", pre + "gate") if not modes.get(m)]
    if missing and DEV == "cuda":
        raise AssertionError(f"tuned ladder {layout}: never launched inside a capture: {missing}")
    return out


def tune_kernels_knob(K, cs, snap, q):
    """Diffs that set ``kernels`` False, then True, on the card: equal
    planes, launches only under True."""
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.serve import ServeConfig
    from gochugaru_tpu_torch.tune import TuneDiff, TuneTarget, apply_diff
    from gochugaru_tpu_torch.tune.tuner import KnobDiff

    target = TuneTarget(engine=EngineConfig(), serve=ServeConfig())
    out, planes = {}, {}
    for cur, want in ((True, False), (False, True)):
        diff = TuneDiff((KnobDiff("kernels", "engine", cur, want, "forced", {}),))
        eng = apply_diff(target, diff).engine
        if eng.kernels is not want:
            raise AssertionError(f"apply_diff left kernels={eng.kernels}, not {want}")
        if DEV != "cuda":  # a CPU rehearsal: kernels=True needs the card
            eng = dataclasses.replace(eng, kernels=None)
        before = dict(K.LAUNCHES)
        e = DeviceEngine(cs, eng, device=DEV)
        planes[want] = e.check_columns(e.prepare(snap), *q, now_us=EPOCH)
        n = sum(K.LAUNCHES[k] - before[k] for k in K.LAUNCHES)
        out[str(want)] = n
        if (n > 0) != (want and DEV == "cuda"):
            raise AssertionError(f"kernels={want}: {n} kernel launches")
    _lat_same("kernels knob False vs True", planes[False], planes[True])
    log(f"tune: the kernels knob on the card: launches {out}, planes equal")
    return out


def tune_controller(client, pool, scheds):
    """The OnlineController on a live handle behind /tune: TUNE_TICKS
    ticks under interactive load, every move within its bounds, /tune
    enabled, revert() back to the preset."""
    import urllib.request

    from gochugaru_tpu_torch.serve import ServeConfig
    from gochugaru_tpu_torch.tune import OnlineController
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.telemetry import TelemetryServer

    preset = ServeConfig()
    h = client.with_serving(config=preset)
    vc = client._vcache
    ctl = OnlineController(h.batcher, vcache=vc, cooldown_steps=1)
    srv = TelemetryServer(port=0, controller=ctl)
    arrivals, starts, n = scheds["interactive"]
    per_tick = max(1, int(TUNE_RATE * TUNE_TICK_S))
    moves, trail = [], []
    try:
        for t in range(TUNE_TICKS):
            sl = slice((t * per_tick) % len(starts), (t * per_tick) % len(starts) + per_tick)
            arr = arrivals[sl] - arrivals[sl][0]
            tune_paced(h, pool, (arr, starts[sl], n))
            moves.append(ctl.step())
            st = ctl.status()
            trail.append(dict(hold_max_s=st["hold_max_s"], dedup=st["dedup"],
                              vcache_bytes=st["vcache_bytes"]))
            if not (ctl.hold_bounds[0] <= st["hold_max_s"] <= ctl.hold_bounds[1]):
                raise AssertionError(f"controller: hold {st['hold_max_s']} out of bounds")
            if vc is not None and not (ctl.cache_bounds[0] <= vc.max_bytes
                                       <= ctl.cache_bounds[1]):
                raise AssertionError(f"controller: cache {vc.max_bytes} out of bounds")
        with urllib.request.urlopen(srv.url + "/tune", timeout=30) as r:
            tune_ep = json.loads(r.read())
        if tune_ep.get("enabled") is not True:
            raise AssertionError(f"/tune: {tune_ep}")
        ctl.revert()
        if h.batcher.config != preset or (vc is not None and vc.max_bytes != ctl._preset[1]):
            raise AssertionError("controller: revert() did not restore the preset")
    finally:
        srv.close()
        ctl.close()
        h.close()
    out = dict(ticks=TUNE_TICKS, moves=moves, trail=trail,
               counters=tune_ep["counters"], frozen=tune_ep["status"]["frozen"],
               reverted=True)
    log(f"tune: controller {json.dumps(out)}")
    return out


def phase_tune(K, card, n_repos=10_000, n_users=1_000, n_teams=100, n_orgs=10):
    """Phase 17 (see the module docstring).  Returns the ``tune:`` line's
    object."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_engine_config, with_latency_mode, with_store,
        with_verdict_cache,
    )
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.serve import ServeConfig
    from gochugaru_tpu_torch.tune import TuneTarget, apply_diff, collect_snapshot, propose
    from gochugaru_tpu_torch.utils import metrics, perf

    t17 = time.perf_counter()
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    eng0 = EngineConfig()
    c0 = new_evaluator(with_latency_mode(), with_verdict_cache(),
                       with_engine_config(eng0), device=DEV)
    cs, snap, q, names = build_rbac(n_repos, n_users, n_teams, n_orgs, store=c0.store)
    rng = np.random.default_rng(29)
    pool = tune_pool(c0.store, n_repos, n_users, rng)
    scheds = tune_schedules(rng)
    # (1) the load under the defaults
    default = tune_arm("default", c0, ServeConfig(), pool, scheds, eng0.latency_tiers)
    # (2) the snapshot, with the offline packed/unpacked byte models
    cand = {}
    for label, packed in (("packed", True), ("unpacked", False)):
        e = DeviceEngine(cs, EngineConfig(flat_packed=packed), device=DEV)
        cand[label] = perf.gathered_bytes_model(e.prepare(snap)).total
    ds = c0._dsnap_cache[max(c0._dsnap_cache)]
    tsnap = collect_snapshot(
        metrics.default, engine_config=eng0, serve_config=ServeConfig(),
        vcache=c0._vcache, cost=c0._admission.cost, dsnap=ds,
        packed_candidates=cand)
    budget = tsnap.get("bytes", {}).get("device_budget")
    tables = sum(v.nbytes for v in ds.arrays.values())
    if DEV == "cuda" and not (
            budget and tables <= budget <= torch.cuda.get_device_properties(0).total_memory):
        raise AssertionError(f"tune: placement budget {budget} (tables {tables})")
    # (3) propose, apply, re-run the same schedules on the tuned client
    target = TuneTarget(engine=eng0, serve=ServeConfig(),
                        cache_bytes=c0._vcache.max_bytes)
    diff = propose(tsnap, target)
    print("tune diff: " + diff.to_json())
    for line in diff.render().splitlines():
        log("  " + line)
    tuned = apply_diff(target, diff)
    c1 = new_evaluator(with_latency_mode(), with_verdict_cache(tuned.cache_bytes or True),
                       with_engine_config(tuned.engine), with_store(c0.store), device=DEV)
    tuned_run = tune_arm("tuned", c1, tuned.serve, pool, scheds, tuned.engine.latency_tiers)
    kd = diff.get("latency_tiers")
    predicted = None
    if kd is not None and default["pad_waste"] is not None:
        predicted = default["pad_waste"] + kd.predicted.get("pad_waste_frac", 0.0)
    # (4) the forced non-pow2 ladder on both layouts
    ladder = {"off": tune_ladder(K, cs, snap, q, names, {}),
              "aligned": tune_ladder(K, cs, snap, q, names, ALIGNED)}
    # (5) the kernels knob
    knob = tune_kernels_knob(K, cs, snap, q)
    # (6) the controller behind /tune
    controller = tune_controller(c0, pool, scheds)
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] += saved[0][k]
        K.LANES[k] += saved[1][k]
    del c0, c1
    gc.collect()
    seconds = time.perf_counter() - t17
    out = dict(card=card, world=dict(edges=snap.num_edges, revision=snap.revision),
               diff={k.knob: dict(current=k.current, proposed=k.proposed,
                                  predicted=dict(k.predicted)) for k in diff.knobs},
               tuned_tiers=list(tuned.engine.latency_tiers),
               placement_budget=dict(bytes=budget, tables=tables),
               pad_waste=dict(default=default["pad_waste"], tuned=tuned_run["pad_waste"],
                              predicted_tuned=predicted),
               default=default, tuned=tuned_run, ladder=ladder, kernels_knob=knob,
               controller=controller, launches=got, seconds=seconds)
    log(f"phase 17: {seconds:.1f}s; launches {json.dumps(got)}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the fleet on the card (fleet/) over BASELINE config 2
# ---------------------------------------------------------------------------

#: router-side load: FLEET_THREADS callers, each call FLEET_CALL checks
FLEET_THREADS = 4
FLEET_CALL = 16
FLEET_LOAD_S = 2.0
#: consistency: checks a strategy, in calls of FLEET_CALL
FLEET_CHECKS = 2_000
#: single-edge toggles written under load, on the first FLEET_TOGGLE_REPOS
#: repos (the callers check the others, whose answers stay put)
FLEET_TOGGLES = 40
FLEET_TOGGLE_REPOS = 50
#: transactions of the group-committed write
FLEET_GROUP = 8
#: the router's FleetConfig: fast probes, so a death is seen in ~0.1 s
FLEET_CFG = dict(probe_interval_s=0.05, probe_timeout_s=2.0, heartbeat_s=0.05,
                 freshness_wait_s=30.0, freshness_poll_s=0.01)


class FleetCounts:
    """Per-engine counts of full and delta prepares and of latency
    captures (and failed captures), by wrapping the engine's prepare and
    the latency path's capture for the phase."""

    def __init__(self):
        from gochugaru_tpu_torch.engine.device import DeviceEngine
        from gochugaru_tpu_torch.engine.latency import LatencyPath

        self.classes = (DeviceEngine, LatencyPath)
        self.orig = (DeviceEngine.prepare, LatencyPath._capture)
        self.n = {}
        self.lock = threading.Lock()

    def _inc(self, eng, key):
        with self.lock:
            row = self.n.setdefault(id(eng), dict(full=0, delta=0, captures=0,
                                                  capture_failures=0))
            row[key] += 1

    def __enter__(self):
        prep, cap = self.orig
        counts = self

        def prepare(eng, snap, prev=None):
            ds = prep(eng, snap, prev)
            counts._inc(eng, "full" if ds.delta_acc is None else "delta")
            return ds

        def capture(lp, pin, key):
            counts._inc(lp.engine, "captures")
            try:
                return cap(lp, pin, key)
            except BaseException:
                counts._inc(lp.engine, "capture_failures")
                raise

        self.classes[0].prepare = prepare
        self.classes[1]._capture = capture
        return self

    def __exit__(self, *exc):
        self.classes[0].prepare, self.classes[1]._capture = self.orig
        return False

    def of(self, replica):
        eng = replica._client._engine
        return dict(self.n.get(id(eng), dict(full=0, delta=0, captures=0,
                                             capture_failures=0)))


def fleet_queries(rng, n, n_repos, n_users, lo=FLEET_TOGGLE_REPOS):
    """``n`` (repo, permission, user) checks on repos past the toggled
    ones."""
    ri = rng.integers(lo, n_repos, n)
    ui = rng.integers(0, n_users, n)
    perm = np.where(rng.random(n) < 0.9, "read", "admin")
    return [(f"repo:r{a}", p, f"user:u{b}") for a, p, b in zip(ri, perm, ui)]


def fleet_load(router, oracle_of, queries, seconds, strategy, stop=None):
    """FLEET_THREADS callers on the router for ``seconds`` (or until
    ``stop``): each call FLEET_CALL checks, every answer held against the
    oracle's.  Returns checks/s, per-call p50/p99 ms, calls, mismatches
    and errors."""
    from gochugaru_tpu_torch import rel
    from gochugaru_tpu_torch.utils.context import background

    lat, bad, errs, calls = [], [0], [], [0]
    lock = threading.Lock()
    t_end = time.perf_counter() + seconds

    def caller(seed):
        rng = np.random.default_rng(seed)
        while (stop is None and time.perf_counter() < t_end) or (
                stop is not None and not stop.is_set()):
            idx = rng.integers(0, len(queries), FLEET_CALL)
            rels = [rel.must_from_triple(*queries[i]) for i in idx]
            t0 = time.perf_counter()
            try:
                got = router.check(background().with_timeout(60.0), strategy(), *rels)
            except BaseException as e:  # counted: the phase fails on any
                with lock:
                    errs.append(repr(e))
                continue
            dt = time.perf_counter() - t0
            want = [oracle_of[queries[i]] for i in idx]
            with lock:
                lat.append(dt)
                calls[0] += 1
                # one answer a check, each the oracle's
                bad[0] += (sum(a != b for a, b in zip(got, want))
                           + abs(len(got) - len(want)))

    t0 = time.perf_counter()
    ts = [threading.Thread(target=caller, args=(s,)) for s in range(FLEET_THREADS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    el = time.perf_counter() - t0
    return dict(calls=calls[0], checks_per_s=calls[0] * FLEET_CALL / el,
                p50_ms=float(np.percentile(lat, 50) * 1e3) if lat else None,
                p99_ms=float(np.percentile(lat, 99) * 1e3) if lat else None,
                mismatches=bad[0], errors=errs[:3], n_errors=len(errs))


def fleet_load_held(res, what):
    """Raises unless a ``fleet_load`` window made calls and every one of them
    was answered, and answered as the oracle does."""
    if not res.get("calls") or res.get("mismatches") or res.get("n_errors"):
        raise AssertionError(f"fleet: {what}: {res}")


def fleet_toggles(router, oracle, oracle_of, queries, n_users):
    """FLEET_TOGGLES single-edge toggles on the first FLEET_TOGGLE_REPOS
    repos, written through the router while FLEET_THREADS callers check
    the other repos; each toggle read back through its zookie against the
    host ``oracle``.  Raises on a stale answer or a wrong or failed call
    under load; returns the toggles, stale answers (0), read-your-writes
    p50/p99 ms and the load's numbers."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.utils.context import background

    ctx = background()
    stop = threading.Event()
    res = {}
    th = threading.Thread(target=lambda: res.update(fleet_load(
        router, oracle_of, queries, 0, consistency.min_latency, stop=stop)))
    th.start()
    stale, ryw_ms = 0, []
    trng = np.random.default_rng(47)
    try:
        for _ in range(FLEET_TOGGLES):
            t = (f"repo:r{trng.integers(1, FLEET_TOGGLE_REPOS)}", "reader",
                 f"user:u{trng.integers(n_users)}")
            r_ = rel.must_from_triple(*t)
            txn = rel.Txn()
            live = oracle.check(ctx, consistency.full(),
                                rel.must_from_triple(t[0], "reader", t[2]))[0]
            if live:
                txn.delete(r_)
            else:
                txn.touch(r_)
            zk = router.write(ctx, txn)
            qr = rel.must_from_triple(t[0], "read", t[2])
            exp = oracle.check(ctx, consistency.full(), qr)
            t0 = time.perf_counter()
            got = router.check(background().with_timeout(60.0),
                               consistency.min_latency(), qr, zookie=zk)
            ryw_ms.append((time.perf_counter() - t0) * 1e3)
            stale += got != exp
    finally:
        stop.set()
        th.join()
    out = dict(toggles=FLEET_TOGGLES, stale=stale,
               ryw_p50_p99_ms=[float(np.percentile(ryw_ms, 50)),
                               float(np.percentile(ryw_ms, 99))],
               load=res)
    if stale:
        raise AssertionError(f"fleet: {stale} stale read-your-writes: {out}")
    fleet_load_held(res, "load under writes")
    return out


def phase_fleet(K, card, n_repos=10_000, n_users=1_000, n_teams=100, n_orgs=10,
                load_s=FLEET_LOAD_S):
    """Phase 18 (see the module docstring).  Returns the ``fleet:`` line's
    object."""
    from dataclasses import replace as dc_replace

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_host_only_evaluation, with_latency_mode, with_store,
        with_verdict_cache,
    )
    from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter, Replica
    from gochugaru_tpu_torch.store.store import RevisionToken
    from gochugaru_tpu_torch.utils import faults, metrics
    from gochugaru_tpu_torch.utils.context import background

    t18 = time.perf_counter()
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    m = metrics.default
    cfg = dc_replace(FleetConfig(), **FLEET_CFG)
    router = FleetRouter(config=cfg)
    reps, out = [], {}
    counts = FleetCounts()
    m0 = {k: m.counter(k) for k in ("fleet.kill_detections", "fleet.applied_entries",
                                    "fleet.group_applies", "breaker.trips",
                                    "breaker.latency_rerouted", "latency.retraces")}

    def spawn(rid):
        t0 = time.perf_counter()
        r = Replica(("127.0.0.1", router.port), replica_id=rid, config=cfg,
                    client_options=(with_verdict_cache(), with_latency_mode()),
                    device=DEV)
        router.add_replica(r.host, r.port, wait_ready_s=120.0)
        return r, time.perf_counter() - t0

    try:
        with counts:
            t0 = time.perf_counter()
            cs, snap, q, names = build_rbac(n_repos, n_users, n_teams, n_orgs,
                                            store=router.store)
            out["world"] = dict(edges=snap.num_edges, revision=snap.revision,
                                build_s=time.perf_counter() - t0)
            oracle = new_evaluator(with_store(router.store), with_host_only_evaluation())
            rng = np.random.default_rng(41)
            queries = fleet_queries(rng, 4096, n_repos, n_users)
            ctx = background()
            want = oracle.check(ctx, consistency.full(),
                                *[rel.must_from_triple(*t) for t in queries])
            oracle_of = dict(zip(queries, want))
            # (1) one replica, then two; bootstrap seconds, load with each
            boot, load = [], {}
            warm = [rel.must_from_triple(*t) for t in queries[:512]]
            for i in range(2):
                r, s = spawn(f"card{i}")
                reps.append(r)
                boot.append(s)
                for n in (1, 16, 64, 512):  # its first prepare and captures
                    router.check(background().with_timeout(120.0),
                                 consistency.min_latency(), *warm[:n])
                load[f"{i + 1}_replicas"] = fleet_load(
                    router, oracle_of, queries, load_s, consistency.min_latency)
                log(f"fleet: {i + 1} replica(s): bootstrap {s:.2f}s; load"
                    f" {json.dumps(load[f'{i + 1}_replicas'])}")
                fleet_load_held(load[f"{i + 1}_replicas"],
                                f"load with {i + 1} replica(s)")
            out["bootstrap_s"], out["load"] = boot, load
            # (2) consistency: full, at_least(zookie), min_latency after a quiesce
            txn = rel.Txn()
            txn.touch(rel.must_from_triple("repo:r0", "reader", "user:u0"))
            zk = router.write(ctx, txn)
            head = router.head_revision
            deadline = time.monotonic() + 60
            while any(r.head < head for r in reps) and time.monotonic() < deadline:
                time.sleep(0.01)
            checks = fleet_queries(np.random.default_rng(43), FLEET_CHECKS, n_repos,
                                   n_users, lo=0)
            rels = [rel.must_from_triple(*t) for t in checks]
            want = oracle.check(ctx, consistency.at_least(RevisionToken(head)), *rels)
            strat = {}
            for label, cs_, kw in (("full", consistency.full(), {}),
                                   ("at_least", consistency.min_latency(), {"zookie": zk}),
                                   ("min_latency", consistency.min_latency(), {})):
                got = []
                for a in range(0, len(rels), FLEET_CALL * 4):
                    got += router.check(background().with_timeout(60.0), cs_,
                                        *rels[a:a + FLEET_CALL * 4], **kw)
                strat[label] = int(sum(x != y for x, y in zip(got, want)))
            out["consistency"] = dict(checks=len(rels), mismatches=strat)
            log(f"fleet: consistency {json.dumps(out['consistency'])}")
            if any(strat.values()):
                raise AssertionError(f"fleet: answers differ from the oracle: {strat}")
            # (3) single-edge toggles under load, each read back by its zookie
            out["writes"] = fleet_toggles(router, oracle, oracle_of, queries, n_users)
            out["writes"]["prepares"] = {r.id: counts.of(r) for r in reps}
            log(f"fleet: writes under load {json.dumps(out['writes'])}")
            # (4) failover: replica.kill armed mid-traffic
            stop = threading.Event()
            res = {}
            th = threading.Thread(target=lambda: res.update(fleet_load(
                router, oracle_of, queries, 0, consistency.min_latency, stop=stop)))
            th.start()
            try:
                time.sleep(0.3)
                faults.arm("replica.kill", times=1)
                deadline = time.monotonic() + 30
                while (len(router.status()["ring"]) > 1 or not any(r._dead for r in reps)) \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
                evicted = len(router.status()["ring"]) == 1
                time.sleep(0.3)
            finally:
                stop.set()
                th.join()
                faults.disarm("replica.kill")
            dead = [r for r in reps if r._dead]
            kills = m.counter("fleet.kill_detections") - m0["fleet.kill_detections"]
            if not evicted or len(dead) != 1 or not kills:
                raise AssertionError(f"fleet: kill not detected: ring"
                                     f" {router.status()['ring']}, dead {len(dead)}")
            fleet_load_held(res, "failover window")
            for r in dead:
                reps.remove(r)
                out.setdefault("dead", []).append(dict(id=r.id, **counts.of(r)))
                r.close()
            r, s = spawn("card-rejoin")
            reps.append(r)
            if len(router.status()["ring"]) != 2:
                raise AssertionError(f"fleet: rejoin left ring {router.status()['ring']}")
            got = router.check(background().with_timeout(60.0), consistency.full(),
                               *rels[:256])
            want = oracle.check(ctx, consistency.full(), *rels[:256])
            out["failover"] = dict(window=res, kill_detections=kills, rejoin_s=s,
                                   rejoined_mismatches=int(sum(
                                       x != y for x, y in zip(got, want))))
            log(f"fleet: failover {json.dumps(out['failover'])}")
            if out["failover"]["rejoined_mismatches"]:
                raise AssertionError("fleet: the rejoined fleet disagrees with the oracle")
            # (5) group commit: one entry on each replica
            a0 = m.counter("fleet.applied_entries")
            g0 = m.counter("fleet.group_applies")
            txns = []
            for k in range(FLEET_GROUP):
                txn = rel.Txn()
                txn.touch(rel.must_from_triple(f"repo:r{k + 1}", "reader", "user:u1"))
                txns.append(txn)
            zks = router.write_group(ctx, txns)
            head = router.head_revision
            deadline = time.monotonic() + 30
            while any(r.head < head for r in reps) and time.monotonic() < deadline:
                time.sleep(0.01)
            got = router.check(ctx, consistency.min_latency(),
                               rel.must_from_triple(f"repo:r{FLEET_GROUP}", "read",
                                                    "user:u1"), zookie=zks[-1])
            out["group_commit"] = dict(
                txns=FLEET_GROUP, applied_entries=m.counter("fleet.applied_entries") - a0,
                group_applies=m.counter("fleet.group_applies") - g0, ryw=got)
            log(f"fleet: group commit {json.dumps(out['group_commit'])}")
            if (out["group_commit"]["applied_entries"] != len(reps)
                    or out["group_commit"]["group_applies"] != len(reps) or got != [True]):
                raise AssertionError(f"fleet: group commit {out['group_commit']}")
            out["replicas"] = {r.id: counts.of(r) for r in reps}
    finally:
        router.close()
        for r in reps:
            r.close()
    out["breaker"] = {k: m.counter(k) - m0[k] for k in
                      ("breaker.trips", "breaker.latency_rerouted", "latency.retraces")}
    fails = sum(v["capture_failures"] for v in out.get("replicas", {}).values()) + sum(
        v["capture_failures"] for v in out.get("dead", []))
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] += saved[0][k]
        K.LANES[k] += saved[1][k]
    out["launches"] = got
    out["card"] = card
    out["seconds"] = time.perf_counter() - t18
    log(f"phase 18: {out['seconds']:.1f}s; launches {json.dumps(got)};"
        f" breaker {json.dumps(out['breaker'])}")
    if fails or any(out["breaker"].values()):
        raise AssertionError(f"fleet: {fails} capture failures, breaker {out['breaker']}")
    missing = [k for k in ("block", "gate") if not got.get(k)]
    if missing and DEV == "cuda":
        raise AssertionError(f"fleet: {missing} never launched in the replicas' checks")
    return out


# ---------------------------------------------------------------------------
# phase 19: the scattered layout (EngineConfig.flat_blockslice=False)
# ---------------------------------------------------------------------------

#: the scattered layout's EngineConfig fields
SCATTERED = {"flat_blockslice": False}
#: phase 19's rows by world name, and its client part (the ``scattered:``
#: line)
SCATTERED_OUT = {}
#: the client part's tiers, sampled rows, check_all groups and lookups
SCAT_TIERS = (256, 1_024)
SCAT_ROWS = 2_000
SCAT_EXPLAIN = 256
SCAT_LOOKUPS = 3


def _settled(planes):
    """Rows a layout settles on the card: not overflowed, and definite or
    not possible."""
    d, p, o = planes
    return ~o & (d | ~p)


def phase_scattered_world(K, name, cs, snap, q, names, bs_planes):
    """Phase 19 on one world: ``check_world`` with ``flat_blockslice=False``
    on the snapshot the blockslice layout prepared (kernels vs plain
    planes, sampled rows vs the oracle, checks/s), with the launch counts
    set to 0 just before and read just after: the scattered program has
    no probe-kernel site, so it must launch none.  Every row both layouts
    settle must have the blockslice planes' verdict."""
    label = f"{name} scattered"
    (ek, ep, ds, planes), got = own_launches(
        K, label,
        lambda: check_world(label, cs, snap, q, names, K, **SCATTERED),
        need=())
    if got:
        raise AssertionError(f"{label}: launched probe kernels {got}; the"
                             " scattered program has no probe-kernel site")
    meta = ds.flat_meta
    if (meta.blockslice or meta.fold_pairs or meta.has_rev or meta.packed
            or meta.rc_slots or meta.aligned):
        raise AssertionError(f"{label}: the snapshot is not the scattered layout")
    s_set, b_set = _settled(planes), _settled(bs_planes)
    both = s_set & b_set
    differ = int((planes[0][both] != bs_planes[0][both]).sum())
    if differ:
        raise AssertionError(f"{label}: {differ} rows both layouts settle have"
                             " different verdicts")
    B = int(q[0].shape[0])
    row = dict(
        edges=int(snap.num_edges), batch=B,
        prepare_s=PREPARE_S[label], blockslice_prepare_s=PREPARE_S[name],
        device_mib=DEVICE_MIB[label], blockslice_device_mib=DEVICE_MIB[name],
        checks_per_s=RATES[label], blockslice_checks_per_s=RATES[name],
        overflow_share=float(planes[2].mean()),
        blockslice_overflow_share=float(bs_planes[2].mean()),
        host_settled_share=float((~s_set).mean()),
        settled_both=int(both.sum()),
        settled_only_scattered=int((s_set & ~b_set).sum()),
        settled_only_blockslice=int((b_set & ~s_set).sum()),
        launches=got,
    )
    log(f"{label}: no probe-kernel launch (the scattered program has no psite"
        f" call); settled rows agree with the blockslice planes; {json.dumps(row)}")
    SCATTERED_OUT[name] = row
    del ek, ep, ds
    gc.collect()


def scat_explain(client, ek, ds, rels):
    """Phase 19's explains: each row's ``Client.explain`` at the head
    against the card's witness code of that row alone (the code explain
    seeds its walk with: a batch's codes may name another branch where
    its permission set differs, ROADMAP queue 3) and of the whole batch:
    the tree's verdict is the check's, it names the single-row code as
    its witness and holds both codes' branches (``witness_consistent``)."""
    from gochugaru_tpu_torch import consistency
    from gochugaru_tpu_torch.engine.explain import witness_consistent, witness_name
    from gochugaru_tpu_torch.utils.context import background

    ctx, full = background(), consistency.full()
    verdicts = client.check(ctx, full, *rels)
    batch = ek.witness_codes(ds, rels)
    ms, seeded, other = [], 0, 0
    for i, r in enumerate(rels):
        wc = int(ek.witness_codes(ds, [r])[0])
        t0 = time.perf_counter()
        tree = client.explain(ctx, full, r)
        ms.append((time.perf_counter() - t0) * 1e3)
        if (tree["result"] == "allowed") != verdicts[i]:
            raise AssertionError(f"scattered explain: row {i} explains"
                                 f" {tree['result']}, the check said {verdicts[i]}")
        if tree.get("witness") != witness_name(wc) if wc else "witness" in tree:
            raise AssertionError(f"scattered explain: row {i}'s tree names"
                                 f" {tree.get('witness')}, the card {witness_name(wc)}")
        for code in {wc, int(batch[i])}:
            if (code or not verdicts[i]) and not witness_consistent(tree, code):
                raise AssertionError(f"scattered explain: row {i}'s tree does not"
                                     f" hold the witness {witness_name(code)}")
        seeded += wc != 0
        other += wc != int(batch[i])
    row = dict(rows=len(rels), allowed=int(sum(verdicts)), seeded=seeded,
               batch_code_differs=other, histogram=wit_histogram(batch),
               explain_p50_ms=float(np.percentile(ms, 50)),
               explain_p99_ms=float(np.percentile(ms, 99)))
    log(f"scattered explain: {json.dumps(row)}")
    return row


def phase_scattered_client(K):
    """Phase 19, client part: a ``with_latency_mode()`` client with the
    scattered layout on BASELINE config 2 imported into its store:
    ``check`` of SCAT_ROWS sampled rows and ``check_all`` against the
    oracle, lookups on the walker (the layout has no reverse index)
    against the oracle, ``explain`` trees holding the card's witness
    codes, SCAT_TIERS pins with LAT_WARM warm dispatches each and no
    recapture, then a write and a check that reads it (a full prepare:
    the scattered layout has no delta level)."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_engine_config, with_latency_mode)
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    t_phase = time.perf_counter()
    c = new_evaluator(with_latency_mode(),
                      with_engine_config(EngineConfig(**SCATTERED)),
                      device=DEV)
    t0 = time.perf_counter()
    cs, snap, q, names = build_rbac(store=c.store)
    import_s = time.perf_counter() - t0
    oracle = SnapshotOracle(snap, {}, now_us=EPOCH)
    ctx, full = background(), consistency.full()
    rng = np.random.default_rng(19)
    idx = rng.choice(len(names), SCAT_ROWS, replace=False)
    rels = wit_rels(names, idx)
    want = [oracle.check(*names[i], "", now_us=EPOCH) == T for i in idx]
    m = metrics.default
    before = m.counter("latency.dispatches")
    t0 = time.perf_counter()
    got = c.check(ctx, full, *rels[:200])  # the first check prepares
    first_s = time.perf_counter() - t0
    for lo in range(200, SCAT_ROWS, 200):
        got += c.check(ctx, full, *rels[lo:lo + 200])
    if got != want:
        raise AssertionError("scattered client: check disagrees with the oracle on"
                             f" {sum(a != b for a, b in zip(got, want))} rows")
    moved = int(m.counter("latency.dispatches") - before)
    if moved <= 0:
        raise AssertionError("scattered client: the latency path never ran")
    for g in range(0, 160, 8):
        if c.check_all(ctx, full, *rels[g:g + 8]) != all(want[g:g + 8]):
            raise AssertionError("scattered client: check_all disagrees with the oracle")
    head = c.store.snapshot_for(full)
    ek = c._engine_for(head)
    ds = c._dsnap_for(ek, head)
    if ds.flat_meta is None or ds.flat_meta.blockslice or ds.flat_meta.has_rev:
        raise AssertionError("scattered client: the head is not the scattered layout")
    # lookups: the walker serves (no reverse index); the frontier and the
    # fused program must never be entered
    lk = ("lookups.walker", "lookups.frontier", "lookups.fused")
    lk0 = {k: m.counter(k) for k in lk}
    t0 = time.perf_counter()
    n_res = n_sub = 0
    for u in range(SCAT_LOOKUPS):
        got = list(c.lookup_resources(ctx, full, "repo#read", f"user:u{u}"))
        if got != sorted(oracle.lookup_resources("repo", "read", "user", f"u{u}", "")):
            raise AssertionError(f"scattered client: lookup_resources for u{u}"
                                 " disagrees with the oracle")
        n_res += len(got)
    for r in range(SCAT_LOOKUPS):
        got = list(c.lookup_subjects(ctx, full, f"repo:r{r}", "read", "user"))
        if got != sorted(oracle.lookup_subjects("repo", f"r{r}", "read", "user", "")):
            raise AssertionError(f"scattered client: lookup_subjects for r{r}"
                                 " disagrees with the oracle")
        n_sub += len(got)
    lookup_s = time.perf_counter() - t0
    lk1 = {k: int(m.counter(k) - lk0[k]) for k in lk}
    if lk1["lookups.walker"] < 2 * SCAT_LOOKUPS or lk1["lookups.frontier"] or lk1["lookups.fused"]:
        raise AssertionError(f"scattered client: lookups not on the walker: {lk1}")
    # explain: each tree's verdict is the check's and holds the card's code
    with ApartLaunches(K) as apart:
        wrow = scat_explain(c, ek, ds, rels[:SCAT_EXPLAIN])
        lat = lat_warm("scattered config2", dict(ek=ek, ds=ds, q=q),
                       np.random.default_rng(5), tiers=SCAT_TIERS)
        launches = apart.take()
    if launches:
        raise AssertionError(f"scattered client: probe kernels launched {launches}")
    pins = pin_report(ek) if DEV == "cuda" else {}
    lp = ek.latency_path(ds)
    # a write, then a check that reads it: the next prepare is a full one
    i = next(i for i in range(len(names))
             if names[i][2] == "read"
             and oracle.check(*names[i], "", now_us=EPOCH) != T)
    r_new = rel.must_from_triple(f"repo:{names[i][1]}", "reader",
                                 f"user:{names[i][4]}")
    txn = rel.Txn()
    txn.create(r_new)
    t0 = time.perf_counter()
    tok = c.write(ctx, txn)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    after = c.check(ctx, consistency.at_least(tok), *wit_rels(names, [i]))
    first_check_ms = (time.perf_counter() - t0) * 1e3
    ds2 = c._dsnap_cache[parse_revision(tok)]
    if after != [True] or ds2.flat_meta.delta is not None or ds2.flat_meta.blockslice:
        raise AssertionError(f"scattered client: write -> check {after},"
                             f" delta={ds2.flat_meta.delta is not None}")
    row = dict(
        edges=int(snap.num_edges), import_s=import_s, first_check_s=first_s,
        checks=SCAT_ROWS, latency_dispatches=moved, check_all_groups=20,
        lookups=dict(resources=SCAT_LOOKUPS, results=n_res,
                     subjects=SCAT_LOOKUPS, subject_results=n_sub,
                     s=lookup_s, counters=lk1),
        explain=wrow, latency=lat, pins=pins, captures=lp.compile_count,
        write=dict(write_ms=write_ms, first_check_ms=first_check_ms,
                   full_prepare=True),
        s=time.perf_counter() - t_phase,
    )
    log(f"scattered client on {DEV}: checks, check_all, lookups (walker) agree with"
        f" the oracle; explain trees hold their witness; tiers {list(SCAT_TIERS)} with"
        f" {LAT_WARM} warm dispatches each and no recapture; write -> check took a"
        f" full prepare; {json.dumps(row)}")
    SCATTERED_OUT["client"] = row
    del c, ek, ds, ds2, lp
    gc.collect()
    return row



# ---------------------------------------------------------------------------
# phase 20: the model-sharded mesh (parallel/)
# ---------------------------------------------------------------------------

#: phase 20's rows by world name, and its client part (the ``mesh:`` line)
MESH_OUT = {}
#: the mesh client's sampled rows, lookups and timed batches
MESH_ROWS = 2_000
MESH_LOOKUPS = 3
MESH_TIMED = 3


def mesh_of(data, model):
    """A (data × model) mesh with every position on the one device."""
    from gochugaru_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    return make_mesh(data, model, devices=[dev] * (data * model))


def mesh_engine(cs, shape, **cfg):
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.parallel import ShardedEngine

    return ShardedEngine(cs, mesh_of(*shape),
                         EngineConfig(kernels=DEV == "cuda" or None, **cfg))


def mesh_settle(label, cs, snap, q, names, planes):
    """Rows the mesh leaves to the host (overflow, conditional) settled by
    the oracle, and MESH_ROWS sampled rows held to it: the verdicts."""
    from gochugaru_tpu_torch.caveats import compile_cel
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T

    d, p, ovf = planes
    programs = {n: compile_cel(n, c.params, c.expression)
                for n, c in cs.schema.caveats.items()}
    oracle = SnapshotOracle(snap, programs, now_us=EPOCH)
    verdict = d.copy()
    host = np.flatnonzero((p & ~d) | ovf)
    for i in host:
        verdict[i] = oracle.check(*names[i], "", now_us=EPOCH) == T
    rng = np.random.default_rng(20)
    sample = rng.choice(len(names), min(MESH_ROWS, len(names)), replace=False)
    bad = sum(bool(verdict[i]) != (oracle.check(*names[i], "", now_us=EPOCH) == T)
              for i in sample)
    if bad:
        raise AssertionError(f"{label}: {bad} of {len(sample)} sampled verdicts"
                             " disagree with the oracle")
    return verdict, int(host.shape[0])


def phase_mesh_world(K, name, shape, cs, snap, q, names, bs_planes):
    """Phase 20 on one world: a ShardedEngine over ``mesh_of(*shape)``
    (every shard on the one card; ``kernels=True``) on the snapshot the
    blockslice run prepared, the world's batch through ``check_columns``
    with the launch counts set to 0 just before and read just after: the
    sharded probes are plain gathers, so no probe kernel may launch.  A
    pow2 model size runs the bucket-sharded flat program and must give
    the blockslice planes bit for bit; a model size of 3 runs the sharded
    legacy program, whose rows both programs settle must agree.  Host
    rows are settled by the oracle and MESH_ROWS sampled verdicts held to
    it.  The row: prepare s (the partition-first build and the
    placement), MiB a shard (sharded and replicated) and on the card,
    checks/s beside the blockslice engine's, the collectives of a batch
    and their host ms."""
    from gochugaru_tpu_torch.engine.flat import placement_split
    from gochugaru_tpu_torch.parallel.sharded import resident_bytes

    label = f"{name} mesh {shape[0]}x{shape[1]}"
    q_res, q_perm, q_subj = q
    eng = mesh_engine(cs, shape)
    alloc0 = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    t0 = time.perf_counter()
    ds = eng.prepare(snap)
    if DEV == "cuda":
        torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    card_mib = ((torch.cuda.memory_allocated() - alloc0) / 2**20
                if DEV == "cuda" else None)
    flat = ds.flat_meta is not None
    if flat != (shape[1] & (shape[1] - 1) == 0):
        raise AssertionError(f"{label}: flat={flat} on a model size of {shape[1]}")
    if flat and not ds.flat_meta.sharded:
        raise AssertionError(f"{label}: the snapshot is not bucket-sharded")
    split = placement_split(ds)
    resident = resident_bytes(ds.arrays)

    def run():
        return eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)

    planes, got = own_launches(K, label, run, need=())
    if got:
        raise AssertionError(f"{label}: probe kernels launched on the mesh: {got}")
    coll = dict(eng.last_collectives)
    if shape[1] > 1 and coll["calls"] < 1:
        raise AssertionError(f"{label}: a batch made no collective")
    if flat:
        for nm, a, b in zip("dpo", planes, bs_planes):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label}: plane {nm} differs from the"
                                     " blockslice planes")
        differ = 0
    else:
        both = ~_flags(planes) & ~_flags(bs_planes)
        differ = int((planes[0][both] != bs_planes[0][both]).sum())
        if differ:
            raise AssertionError(f"{label}: {differ} rows both programs settle differ")
    verdict, host_rows = mesh_settle(label, cs, snap, q, names, planes)
    times = []
    for _ in range(MESH_TIMED):
        ts = time.perf_counter()
        eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)
        times.append(time.perf_counter() - ts)
    B = int(q_res.shape[0])
    rate = B / float(np.median(times))
    row = dict(
        shape=list(shape), program="flat" if flat else "legacy",
        edges=int(snap.num_edges), batch=B, prepare_s=prepare_s,
        build_s=ds.prepare_split["build_s"], place_s=ds.prepare_split["place_s"],
        shard_mib=dict(sharded=split["sharded"] / shape[1] / 2**20,
                       replicated=split["replicated"] / 2**20,
                       total=(split["sharded"] / shape[1]
                              + split["replicated"]) / 2**20),
        resident_mib=resident / 2**20, card_mib=card_mib,
        checks_per_s=rate, batch_s=times,
        blockslice_checks_per_s=RATES.get(name, {}).get("kernels"),
        blockslice_prepare_s=PREPARE_S.get(name),
        blockslice_device_mib=DEVICE_MIB.get(name),
        collectives=coll["calls"], collective_host_ms=coll["host_s"] * 1e3,
        overflow_share=float(planes[2].mean()), host_settled=host_rows,
        definite=int(planes[0].sum()), allowed=int(verdict.sum()),
        settled_differ=differ, launches=got,
    )
    log(f"{label}: 0 probe-kernel launches;"
        + (" planes equal the blockslice planes bit for bit;" if flat
           else " rows both programs settle agree;")
        + f" {MESH_ROWS} sampled verdicts agree with the oracle; {json.dumps(row)}")
    MESH_OUT[label] = row
    del eng, ds
    gc.collect()
    return planes


def phase_mesh_client(K):
    """Phase 20, the rest, on BASELINE config 2: a client with
    ``with_mesh(mesh_of(2, 2))`` holding config 2 in its store — sampled
    checks against the oracle, then a write and a check that reads it: the
    tip's delta prepare (the sharded base tables stay, the ``dl_*``
    overlays replicated) must give the planes of a full sharded prepare of
    the tip on the world's batch; then LookupResources / LookupSubjects
    through the sharded hops against an unsharded engine's looped answers
    (``spmm=False``).  No probe kernel may launch."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator, with_engine_config, with_mesh
    from gochugaru_tpu_torch.engine import spmv
    from gochugaru_tpu_torch.engine.device import DeviceEngine
    from gochugaru_tpu_torch.engine.lookup import (
        lookup_resources_device, lookup_subjects_device)
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    t_phase = time.perf_counter()
    c = new_evaluator(with_mesh(mesh_of(2, 2)), with_engine_config(
        EngineConfig(kernels=DEV == "cuda" or None)))
    cs, snap, q, names = build_rbac(store=c.store)
    oracle = SnapshotOracle(snap, {}, now_us=EPOCH)
    ctx, full = background(), consistency.full()
    rng = np.random.default_rng(21)
    idx = rng.choice(len(names), MESH_ROWS, replace=False)
    rels = wit_rels(names, idx)
    want = [oracle.check(*names[i], "", now_us=EPOCH) == T for i in idx]
    with ApartLaunches(K) as apart:
        t0 = time.perf_counter()
        got = c.check(ctx, full, *rels)
        first_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError("mesh client: check disagrees with the oracle on"
                                 f" {sum(a != b for a, b in zip(got, want))} rows")
        ek = c._engine_for(snap)
        ds0 = c._dsnap_for(ek, snap)
        # a write and a check that reads it: the incremental prepare
        i = next(i for i in range(len(names))
                 if names[i][2] == "read"
                 and oracle.check(*names[i], "", now_us=EPOCH) != T)
        txn = rel.Txn()
        txn.create(rel.must_from_triple(f"repo:{names[i][1]}", "reader",
                                        f"user:{names[i][4]}"))
        t0 = time.perf_counter()
        tok = c.write(ctx, txn)
        after = c.check(ctx, consistency.at_least(tok), *wit_rels(names, [i]))
        write_check_ms = (time.perf_counter() - t0) * 1e3
        rev = parse_revision(tok)
        inc = c._dsnap_cache[rev]
        if after != [True] or inc.flat_meta.delta is None or not inc.flat_meta.sharded:
            raise AssertionError(f"mesh client: write -> check {after},"
                                 f" delta={inc.flat_meta.delta is not None}")
        for k, v in ds0.arrays.items():
            if v.sharded and inc.arrays.get(k) is not v:
                raise AssertionError(f"mesh client: the delta prepare moved {k}")
        tip = inc.snapshot
        t0 = time.perf_counter()
        fds = ek.prepare(tip)
        full_prepare_s = time.perf_counter() - t0
        a = ek.check_columns(inc, *q, now_us=EPOCH)
        b = ek.check_columns(fds, *q, now_us=EPOCH)
        for nm, x, y in zip("dpo", a, b):
            if not np.array_equal(x, y):
                raise AssertionError(f"mesh client: plane {nm} of the delta prepare"
                                     " differs from a full prepare of the tip")
        # lookups: the sharded hops against an unsharded engine's looped
        # answers on the tip
        lk = ("lookups.frontier", "lookups.fused", "lookup.hops")
        lk0 = {k: metrics.default.counter(k) for k in lk}
        if not spmv.frontier_ok(ek, fds):
            raise AssertionError("mesh client: the frontier declined the mesh")
        ul = DeviceEngine(cs, EngineConfig(spmm=False, kernels=False), device=DEV)
        uds = ul.prepare(tip)
        toracle = SnapshotOracle(tip, {}, now_us=EPOCH)
        fac = lambda: toracle  # noqa: E731
        t0 = time.perf_counter()
        n_res = n_sub = 0
        for u in range(MESH_LOOKUPS):
            g = lookup_resources_device(ek, fds, "repo", "read", "user", f"u{u}",
                                        now_us=EPOCH, oracle_factory=fac)
            w = lookup_resources_device(ul, uds, "repo", "read", "user", f"u{u}",
                                        now_us=EPOCH, oracle_factory=fac)
            if g != w or not g:
                raise AssertionError(f"mesh client: lookup_resources u{u} differs"
                                     " from the unsharded looped answer")
            n_res += len(g)
        for r in range(MESH_LOOKUPS):
            g = lookup_subjects_device(ek, fds, "repo", f"r{r}", "read", "user",
                                       now_us=EPOCH, oracle_factory=fac)
            w = lookup_subjects_device(ul, uds, "repo", f"r{r}", "read", "user",
                                       now_us=EPOCH, oracle_factory=fac)
            if g != w or not g:
                raise AssertionError(f"mesh client: lookup_subjects r{r} differs"
                                     " from the unsharded looped answer")
            n_sub += len(g)
        lookup_s = time.perf_counter() - t0
        launches = apart.take()
    lk1 = {k: int(metrics.default.counter(k) - lk0[k]) for k in lk}
    if launches:
        raise AssertionError(f"mesh client: probe kernels launched {launches}")
    if lk1["lookups.fused"] or lk1["lookup.hops"] < 1:
        raise AssertionError(f"mesh client: lookups not on the sharded hops: {lk1}")
    row = dict(
        edges=int(snap.num_edges), checks=MESH_ROWS, first_check_s=first_s,
        write_check_ms=write_check_ms, delta_mib=dl_mib(inc),
        full_prepare_s=full_prepare_s,
        lookups=dict(resources=MESH_LOOKUPS, results=n_res, subjects=MESH_LOOKUPS,
                     subject_results=n_sub, s=lookup_s, counters=lk1),
        s=time.perf_counter() - t_phase,
    )
    log(f"mesh client 2x2 on {DEV}: checks agree with the oracle; write -> check"
        " took the sharded delta path, whose planes equal a full prepare of the"
        f" tip; sharded lookups equal the unsharded looped answers; {json.dumps(row)}")
    MESH_OUT["client"] = row
    del c, ek, ds0, inc, fds, ul, uds
    gc.collect()
    return row


# ---------------------------------------------------------------------------
# phase 21: the partitioned serve and the multi-process mesh
# ---------------------------------------------------------------------------

#: phase 21's rows (the ``part:`` line)
PART_OUT = {}
#: the partitioned client's served checks
PART_SERVED = 256


def _route_stats():
    from gochugaru_tpu_torch.utils import metrics

    m = metrics.default.snapshot()
    return m.get("dispatch.route_s.count", 0), m.get("dispatch.route_s.total_s", 0.0)


def _part_mib(ds, M):
    """MiB a position of a partitioned snapshot: the split tables' share,
    the whole tables, and their sum."""
    split = sum(v.nbytes for v in ds.arrays.values() if v.sharded) / M / 2**20
    whole = sum(v.nbytes for v in ds.arrays.values() if not v.sharded) / 2**20
    return dict(split=split, whole=whole, total=split + whole)


def _same_or_fail(label, got, want):
    for nm, a, b in zip("dpo", got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{label}: plane {nm} differs")


def phase_part_world(K, name, shape, cs, snap, q, names, bs_planes,
                     fallback=False, need_mesh=False, **cfg):
    """Phase 21 (a)/(b) on one world: a ShardedEngine over ``mesh_of(*
    shape)`` (``cfg`` overrides EngineConfig fields) prepared through the
    routed feed from the snapshot the blockslice run prepared, with the
    launch counts set to 0 just before the part and read just after
    (none may launch).  The world's batch must give the blockslice planes
    bit for bit, served routed exactly where its slots are routable on a
    one-row mesh; ``fallback`` requires the psum path.  The row: the path
    that served the batch, prepare s (the feed, then the placement), MiB
    a position and on the card, checks/s beside phase 5's (or 4's) and
    phase 20's (``need_mesh``: phase 20 ran this world on this shape, and
    its row must be there), the mean ``dispatch.route_s`` of the timed
    batches, the collectives."""
    from gochugaru_tpu_torch.parallel.sharded import resident_bytes

    label = f"{name} part {shape[0]}x{shape[1]}" + "".join(
        f" {k}={v}" for k, v in cfg.items())
    q_res, q_perm, q_subj = q
    eng = mesh_engine(cs, shape, **cfg)
    out = {}

    def run():
        alloc0 = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        t0 = time.perf_counter()
        ds = eng.prepare_snapshot_partitioned(snap)
        if DEV == "cuda":
            torch.cuda.synchronize()
        out["prepare_s"] = time.perf_counter() - t0
        out["card_mib"] = ((torch.cuda.memory_allocated() - alloc0) / 2**20
                           if DEV == "cuda" else None)
        if not (ds.flat_meta.part_serve and ds.flat_meta.sharded):
            raise AssertionError(f"{label}: the snapshot is not part-serve")
        n0, _ = _route_stats()
        planes = eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)
        out["served"] = "routed" if _route_stats()[0] > n0 else "psum"
        out["collectives"] = dict(eng.last_collectives)
        return ds, planes

    (ds, planes), got = own_launches(K, label, run, need=())
    if got:
        raise AssertionError(f"{label}: probe kernels launched: {got}")
    _same_or_fail(f"{label} vs the blockslice planes", planes, bs_planes)
    routable = eng._routable(ds.flat_meta, sorted({int(s) for s in q_perm}))
    if (out["served"] == "routed") != (routable and shape[0] == 1):
        raise AssertionError(f"{label}: served {out['served']}, routable={routable}")
    if fallback and out["served"] != "psum":
        raise AssertionError(f"{label}: the batch did not fall back")
    if out["served"] == "routed" and out["collectives"]["calls"]:
        raise AssertionError(f"{label}: a routed batch made collectives")
    verdict, host_rows = mesh_settle(label, cs, snap, q, names, planes)
    n0, s0 = _route_stats()
    times = []
    for _ in range(MESH_TIMED):
        ts = time.perf_counter()
        eng.check_columns(ds, q_res, q_perm, q_subj, now_us=EPOCH)
        times.append(time.perf_counter() - ts)
    n1, s1 = _route_stats()
    B = int(q_res.shape[0])
    mesh_key = f"{name} mesh {shape[0]}x{shape[1]}"
    mesh_row = MESH_OUT.get(mesh_key)
    if need_mesh and mesh_row is None:
        raise AssertionError(f"{label}: phase 20 has no row {mesh_key!r} to"
                             " compare with")
    mesh_row = mesh_row or {}
    row = dict(
        shape=list(shape), config=cfg, edges=int(snap.num_edges), batch=B,
        served=out["served"], routable=routable,
        fold=bool(ds.flat_meta.fold_pairs), tindex=ds.flat_meta.has_tindex,
        prepare_s=out["prepare_s"], feed_s=ds.prepare_split["build_s"],
        place_s=ds.prepare_split["place_s"],
        position_mib=_part_mib(ds, shape[1]),
        split_tables=sorted(k for k, v in ds.arrays.items() if v.sharded),
        resident_mib=resident_bytes(ds.arrays) / 2**20, card_mib=out["card_mib"],
        owned_rows=int(ds.snapshot.e_rel.shape[0]),
        checks_per_s=B / float(np.median(times)), batch_s=times,
        route_s=(s1 - s0) / (n1 - n0) if n1 > n0 else None,
        blockslice_checks_per_s=RATES.get(name, {}).get("kernels"),
        mesh_checks_per_s=mesh_row.get("checks_per_s"),
        mesh_prepare_s=mesh_row.get("prepare_s"),
        blockslice_prepare_s=PREPARE_S.get(name),
        collectives=out["collectives"]["calls"],
        collective_host_ms=out["collectives"]["host_s"] * 1e3,
        overflow_share=float(planes[2].mean()), host_settled=host_rows,
        definite=int(planes[0].sum()), allowed=int(verdict.sum()),
        launches=got,
    )
    log(f"{label}: 0 probe-kernel launches; served {out['served']}; planes equal"
        f" the blockslice planes bit for bit; {MESH_ROWS} sampled verdicts agree"
        f" with the oracle; {json.dumps(row)}")
    PART_OUT[label] = row
    del eng, ds
    gc.collect()


def phase_part_client(K):
    """Phase 21 (c), on BASELINE config 2: a ``with_mesh(mesh_of(1, 4),
    partitioned=True)`` client holding config 2 in its store — 2,000
    sampled checks against the oracle; a write and a check that reads it
    through the delta prepare (the fold stays armed, the split tables
    kept, its planes equal to a full partitioned prepare of the tip);
    lookups on the host walker (the feed declines the reverse index)
    against the oracle's; PART_SERVED checks through ``with_serving()``,
    whose formed batches take the routed path.  No probe kernel may
    launch."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator, with_engine_config, with_mesh
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.store.store import parse_revision
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    t_phase = time.perf_counter()
    c = new_evaluator(with_mesh(mesh_of(1, 4), partitioned=True),
                      with_engine_config(EngineConfig(kernels=DEV == "cuda" or None)))
    cs, snap, q, names = build_rbac(store=c.store)
    oracle = SnapshotOracle(snap, {}, now_us=EPOCH)
    ctx, full = background(), consistency.full()
    rng = np.random.default_rng(22)
    idx = rng.choice(len(names), MESH_ROWS, replace=False)
    want = [oracle.check(*names[i], "", now_us=EPOCH) == T for i in idx]
    with ApartLaunches(K) as apart:
        n0, _ = _route_stats()
        t0 = time.perf_counter()
        got = c.check(ctx, full, *wit_rels(names, idx))
        first_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError("part client: check disagrees with the oracle on"
                                 f" {sum(a != b for a, b in zip(got, want))} rows")
        if _route_stats()[0] <= n0:
            raise AssertionError("part client: the checks were not routed")
        ek = c._engine_for(snap)
        ds0 = c._dsnap_for(ek, snap)
        if not ds0.flat_meta.part_serve or ds0.fold_state is None:
            raise AssertionError("part client: not a folded part-serve snapshot")
        i = next(i for i in range(len(names))
                 if names[i][2] == "read"
                 and oracle.check(*names[i], "", now_us=EPOCH) != T)
        txn = rel.Txn()
        txn.create(rel.must_from_triple(f"repo:{names[i][1]}", "reader",
                                        f"user:{names[i][4]}"))
        t0 = time.perf_counter()
        tok = c.write(ctx, txn)
        after = c.check(ctx, consistency.at_least(tok), *wit_rels(names, [i]))
        write_check_ms = (time.perf_counter() - t0) * 1e3
        inc = c._dsnap_cache[parse_revision(tok)]
        dm = inc.flat_meta.delta
        if after != [True] or dm is None or dm.pf_off or inc.fold_state is None:
            raise AssertionError(f"part client: write -> check {after},"
                                 f" delta={dm is not None}, fold kept="
                                 f"{dm is not None and not dm.pf_off}")
        for k, v in ds0.arrays.items():
            if v.sharded and inc.arrays.get(k) is not v:
                raise AssertionError(f"part client: the delta prepare moved {k}")
        tip = inc.source_snapshot
        t0 = time.perf_counter()
        fds = ek.prepare_snapshot_partitioned(tip)
        full_prepare_s = time.perf_counter() - t0
        _same_or_fail("part client: delta vs full prepare of the tip",
                      ek.check_columns(inc, *q, now_us=EPOCH),
                      ek.check_columns(fds, *q, now_us=EPOCH))
        # lookups: the host walker (the feed declines the reverse index)
        w0 = metrics.default.counter("lookups.walker")
        toracle = SnapshotOracle(tip, {}, now_us=EPOCH)
        t0 = time.perf_counter()
        n_res = n_sub = 0
        for u in range(2):
            g = sorted(c.lookup_resources(ctx, full, "repo#read", f"user:u{u}"))
            w = sorted(toracle.lookup_resources("repo", "read", "user", f"u{u}"))
            if g != w or not g:
                raise AssertionError(f"part client: lookup_resources u{u} differs"
                                     " from the oracle's")
            n_res += len(g)
        for r in range(2):
            g = sorted(c.lookup_subjects(ctx, full, f"repo:r{r}", "read", "user"))
            w = sorted(toracle.lookup_subjects("repo", f"r{r}", "read", "user"))
            if g != w or not g:
                raise AssertionError(f"part client: lookup_subjects r{r} differs"
                                     " from the oracle's")
            n_sub += len(g)
        lookup_s = time.perf_counter() - t0
        walker = int(metrics.default.counter("lookups.walker") - w0)
        if walker < 4:
            raise AssertionError(f"part client: {walker} lookups on the walker")
        sidx = rng.choice(len(names), PART_SERVED, replace=False)
        swant = [toracle.check(*names[i], "", now_us=EPOCH) == T for i in sidx]
        n0, _ = _route_stats()
        t0 = time.perf_counter()
        with c.with_serving() as h:
            served = h.check(ctx, *wit_rels(names, sidx))
        serve_s = time.perf_counter() - t0
        if list(served) != swant:
            raise AssertionError("part client: served checks disagree with the oracle")
        if _route_stats()[0] <= n0:
            raise AssertionError("part client: the served batches were not routed")
        launches = apart.take()
    if launches:
        raise AssertionError(f"part client: probe kernels launched {launches}")
    row = dict(
        edges=int(snap.num_edges), checks=MESH_ROWS, first_check_s=first_s,
        write_check_ms=write_check_ms, delta_mib=dl_mib(inc),
        full_prepare_s=full_prepare_s,
        lookups=dict(resources=2, results=n_res, subjects=2,
                     subject_results=n_sub, s=lookup_s, walker=walker),
        served=dict(checks=PART_SERVED, s=serve_s),
        s=time.perf_counter() - t_phase,
    )
    log(f"part client 1x4 on {DEV}: checks agree with the oracle and routed; write"
        " -> check took the delta path with the fold armed, planes equal a full"
        " prepare of the tip; walker lookups and served checks agree with the"
        f" oracle; {json.dumps(row)}")
    PART_OUT["client"] = row
    del c, ek, ds0, inc, fds
    gc.collect()


#: phase 21 (d)'s loaded row: the timed batches a worker runs after its
#: first, and the deadline of the two workers together
PART_PROC_TIMED = 3
PART_PROC_TIMEOUT_S = 300


def part_proc_worker() -> int:
    """Phase 21 (d)'s loaded row, one of its two processes (``python3
    chip_smoke.py --part-worker``, spawned by :func:`phase_part_processes`
    with the GOCHUGARU_* process variables): join the gloo group, build
    BASELINE config 2 from its seed, hold two positions of a 1 × 4 mesh
    whose model row spans both processes (both on the card), prepare
    only the owned shards (``partition_feed(owned=owned_model_shards(
    mesh))``), and run the 100,000-check batch with ``fetch=False``, once
    and then PART_PROC_TIMED times.  The planes of every row it holds
    must equal phase 4's (the npz the parent names in
    CHIP_SMOKE_PART_WANT) bit for bit, each time.  Prints one
    ``PART-WORKER {...}`` line: the owned rows against the edges, the
    feed and placement s, each timed batch's s and collectives (calls,
    host ms, bytes a shard put in, the row's all-reduces across the
    processes with their host bytes and ms), and the launches (none
    may)."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gochugaru_tpu_torch.engine import kernels as K
    from gochugaru_tpu_torch.engine.partition import partition_feed, snapshot_raw_columns
    from gochugaru_tpu_torch.engine.plan import EngineConfig
    from gochugaru_tpu_torch.parallel import ShardedEngine
    from gochugaru_tpu_torch.parallel.multihost import (
        global_mesh, initialize, owned_model_shards)

    global DEV
    DEV = os.environ.get("GOCHUGARU_DRYRUN_DEVICE") or "cuda"
    dev = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    initialize()
    rank = dist.get_rank()
    mesh = global_mesh(1, 4, devices=[dev, dev])
    cs, snap, q, _names = build_rbac()
    eng = ShardedEngine(cs, mesh, EngineConfig(kernels=DEV == "cuda" or None))
    owned = owned_model_shards(mesh)
    t0 = time.perf_counter()
    part = partition_feed(
        snap.revision, cs, snap.interner, snapshot_raw_columns(snap),
        eng.config, eng.model_size, owned=owned, contexts=snap.contexts,
        epoch_us=EPOCH)
    feed_s = time.perf_counter() - t0
    if part is None:
        raise AssertionError("part worker: the feed partition declined config 2")
    t0 = time.perf_counter()
    ds = eng.prepare_partitioned(part)
    if DEV == "cuda":
        torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    want = np.load(os.environ["CHIP_SMOKE_PART_WANT"])
    B = int(q[0].shape[0])
    K.reset_launches()
    batches = []
    for i in range(1 + PART_PROC_TIMED):
        t0 = time.perf_counter()
        planes = eng.check_columns(ds, *q, now_us=EPOCH, fetch=False)
        planes = [x.cpu().numpy() for x in planes]
        s = time.perf_counter() - t0
        (lo, hi), = eng.last_local_rows
        if lo != 0 or hi < B:
            raise AssertionError(f"part worker {rank}: holds rows {lo}-{hi} of {B}")
        for nm, a in zip("dpo", planes):
            if not np.array_equal(a[:B], want[nm]):
                raise AssertionError(f"part worker {rank}: plane {nm} differs from"
                                     " phase 4's")
        c = eng.last_collectives
        if i:
            batches.append(dict(
                s=s, collectives=c["calls"], host_ms=c["host_s"] * 1e3,
                bytes=c["bytes"], cross_calls=c["cross_calls"],
                cross_bytes=c["cross_bytes"], cross_ms=c["cross_s"] * 1e3))
    report = dict(
        proc=rank, mesh=[1, 4], device=DEV, owned=list(owned),
        edges=int(snap.num_edges), local_rows=int(part.snapshot.e_rel.shape[0]),
        batch=B, feed_s=feed_s, place_s=place_s,
        cross_process_rows=int(mesh.group(0) is not None), batches=batches,
        launches={k: v for k, v in K.LAUNCHES.items() if v})
    print("PART-WORKER " + json.dumps(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def part_proc_loaded(want_planes):
    """Phase 21 (d)'s loaded row: two :func:`part_proc_worker` processes
    on a fresh coordinator port, killed at PART_PROC_TIMEOUT_S; their
    reports."""
    import tempfile

    from gochugaru_tpu_torch.parallel.multihost import _communicate_all, _free_port

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "want.npz")
        np.savez(path, **{nm: np.asarray(a) for nm, a in zip("dpo", want_planes)})
        coordinator = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--part-worker"],
            env=dict(os.environ, GOCHUGARU_COORDINATOR=coordinator,
                     GOCHUGARU_NUM_PROCESSES="2", GOCHUGARU_PROCESS_ID=str(p),
                     GOCHUGARU_DRYRUN_DEVICE=DEV, CHIP_SMOKE_PART_WANT=path,
                     GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in range(2)]
        outs, rcs = _communicate_all(procs, PART_PROC_TIMEOUT_S)
    reps = [json.loads(line.split(" ", 1)[1]) for out in outs
            for line in out.splitlines() if line.startswith("PART-WORKER ")]
    if rcs != [0, 0] or len(reps) != 2:
        for p, (out, rc) in enumerate(zip(outs, rcs)):
            tail = "\n".join(out.splitlines()[-12:])
            log(f"--- part worker {p} (rc {rc}) tail ---\n{tail}")
        raise AssertionError("processes 1x4 config2: a worker failed")
    return reps


def phase_part_processes(K, rbac):
    """Phase 21 (d): two processes on the card joined by gloo (both on
    ``cuda:0``, parallel/multihost.py ``dryrun_multihost``): the 2 × 2
    dryrun (each model row within one process), then a 1 × 4 mesh whose
    model row spans both (disjoint owned shards from ``partition_feed``,
    a psum batch with ``fetch=False`` verified row by row in each
    process), each worker reporting its collectives and their host ms
    (an unloaded floor: 157 edges, a batch of 32), and the kernel
    launches it made (none may); then the spanning 1 × 4 mesh under load,
    config 2 (``rbac``) at full size with its 100,000-check batch
    (:func:`part_proc_worker`), planes equal to phase 4's in each
    process, with the collectives' host ms and bytes."""
    from gochugaru_tpu_torch.parallel.multihost import dryrun_multihost

    out = {}
    for label, model in (("2x2", 0), ("1x4", 4)):
        t0 = time.perf_counter()
        reps = dryrun_multihost(2, 4, timeout_s=300, model=model, device=DEV)
        for r in reps:
            if r["launches"]:
                raise AssertionError(f"processes {label}: proc {r['proc']} launched"
                                     f" {r['launches']}")
        if model and not all(r["cross_process_rows"] == 1
                              and r["local_rows"] < r["edges"] for r in reps):
            raise AssertionError(f"processes {label}: the model row does not span"
                                 f" the processes with disjoint ownership: {reps}")
        out[label] = dict(workers=reps, s=time.perf_counter() - t0)
        log(f"processes {label} on {DEV}: every row verified in its process;"
            f" {json.dumps(out[label])}")
    label = "1x4 config2"
    t0 = time.perf_counter()
    reps = part_proc_loaded(rbac[4])
    for r in reps:
        if r["launches"]:
            raise AssertionError(f"processes {label}: proc {r['proc']} launched"
                                 f" {r['launches']}")
        if not (r["cross_process_rows"] == 1 and r["local_rows"] < r["edges"]
                and all(b["cross_calls"] for b in r["batches"])):
            raise AssertionError(f"processes {label}: the model row does not span"
                                 f" the processes with disjoint ownership: {r}")
    if sorted(r["proc"] for r in reps) != [0, 1] or sum(
            r["local_rows"] for r in reps) != reps[0]["edges"]:
        raise AssertionError(f"processes {label}: the owned rows do not partition"
                             f" the edges: {reps}")
    out[label] = dict(workers=reps, s=time.perf_counter() - t0)
    log(f"processes {label} on {DEV}: each process's planes equal phase 4's bit"
        f" for bit; {json.dumps(out[label])}")
    PART_OUT["processes"] = out


# ---------------------------------------------------------------------------
# phase 22: the operator entry points as processes on the card
# ---------------------------------------------------------------------------

PROCS_OUT = {}
FLEETD = "gochugaru_tpu_torch.scripts.fleetd"
#: replica processes behind the router, as scripts/fleet_smoke.sh and
#: benchmarks/bench10_fleet.py run them
PROCS_REPLICAS = 3
#: seconds a child may take to print a line it owes (bootstrap, join)
PROCS_BOOT_S = 600.0
#: seconds a child may take to stop after SIGINT
PROCS_STOP_S = 60.0
#: checks of (c)'s config 3 sample, held to the oracle
PROCS_SAMPLE = 4_096
#: seed of the replica (a) kills
PROCS_KILL_SEED = 53


#: every child phase 22 started (none may outlive it)
PROCS_CHILDREN = []


def proc_spawn(tmp, name, module, *args):
    """``python -m module args`` as a child (scripts/procs.py), its output
    in ``tmp``; unbuffered, and no roofline cache written (telemetryd's
    /perf?bench=1 measures afresh)."""
    from gochugaru_tpu_torch.scripts.procs import Child, module_argv

    child = Child(module_argv(module, *args), os.path.join(tmp, f"{name}.log"),
                  env=dict(os.environ, PYTHONUNBUFFERED="1",
                           GOCHUGARU_ROOFLINE_CACHE="0"),
                  name=name)
    PROCS_CHILDREN.append(child)
    return child


def card_free_mib():
    """Free memory on the card (every process's allocations counted), MiB;
    None off the card."""
    if DEV != "cuda":
        return None
    return torch.cuda.mem_get_info()[0] / 2**20


def proc_replica(tmp, port, rid, latency=True, join=True):
    """One ``fleetd replica`` process on DEV against the router at
    ``port``; with ``join`` it asks the router to admit it."""
    return proc_spawn(tmp, rid, FLEETD, "replica", "--upstream",
                      f"127.0.0.1:{port}", "--id", rid, "--device", DEV,
                      *(["--join"] if join else []),
                      *(["--latency-mode"] if latency else []))


def proc_joined(child, t0, router=None):
    """Waits for a replica process's REPLICA-READY line, then for its
    JOINED line, or (``router``: started without ``--join``) admits it:
    its bootstrap stats, seconds to ready (bootstrapped) and to joined
    (in the ring) from ``t0``."""
    ready = json.loads(child.wait_line("REPLICA-READY", PROCS_BOOT_S).split(" ", 1)[1])
    ready_s = time.perf_counter() - t0
    if router is None:
        child.wait_line("JOINED", PROCS_BOOT_S)
    else:
        router.add_replica(ready["host"], ready["port"], wait_ready_s=PROCS_BOOT_S)
    return dict(id=child.name, pid=child.pid, ready_s=ready_s,
                joined_s=time.perf_counter() - t0, bootstrap=ready["bootstrap"])


class RssPeak:
    """A process's peak resident set, MiB: its VmRSS read every ``every``
    seconds on a thread until ``stop``.  Sampled because the card
    machine's /proc has no VmHWM, and a child's getrusage peak starts from
    its parent's resident set at the fork."""

    def __init__(self, pid, every=0.05):
        self.path, self.peak_mib = f"/proc/{pid}/status", 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(every,), daemon=True)
        self._thread.start()

    def _run(self, every):
        while not self._stop.is_set():
            try:
                with open(self.path) as f:
                    kib = next((int(ln.split()[1]) for ln in f
                                if ln.startswith("VmRSS:")), 0)
            except OSError:
                return
            self.peak_mib = max(self.peak_mib, kib / 1024)
            self._stop.wait(every)

    def stop(self):
        self._stop.set()
        self._thread.join(5)
        return self.peak_mib


def proc_exit(child, signalled=False):
    """SIGINT a replica process (``signalled``: already sent), and its
    REPLICA-EXIT report (it must exit 0)."""
    rc = child.wait(PROCS_STOP_S) if signalled else child.stop(PROCS_STOP_S)
    if rc != 0:
        raise AssertionError(f"procs: {child.name} exited {rc}:\n{child.tail()}")
    return json.loads(child.wait_line("REPLICA-EXIT", 5).split(" ", 1)[1])


def proc_warm(router, queries):
    """Router checks of 1, 16, 64 and 512 rows: the replicas' first
    prepares and latency captures, before a timed window."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.utils.context import background

    warm = [rel.must_from_triple(*t) for t in queries[:512]]
    for n in (1, 16, 64, 512):
        router.check(background().with_timeout(300.0), consistency.min_latency(),
                     *warm[:n])


def procs_fleet(tmp, inproc, n_repos=10_000, n_users=1_000, n_teams=100, n_orgs=10,
                load_s=FLEET_LOAD_S):
    """Phase 22 (a): BASELINE config 2 in a router's store in this process,
    served by PROCS_REPLICAS ``fleetd replica`` processes on the card."""
    from dataclasses import replace as dc_replace

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_host_only_evaluation, with_store)
    from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter
    from gochugaru_tpu_torch.scripts.procs import close_all
    from gochugaru_tpu_torch.utils import metrics
    from gochugaru_tpu_torch.utils.context import background

    m = metrics.default
    out = {}
    router = FleetRouter(config=dc_replace(FleetConfig(), **FLEET_CFG))
    kids = []
    try:
        t0 = time.perf_counter()
        cs, snap, q, names = build_rbac(n_repos, n_users, n_teams, n_orgs,
                                        store=router.store)
        out["world"] = dict(edges=snap.num_edges, revision=snap.revision,
                            build_s=time.perf_counter() - t0)
        oracle = new_evaluator(with_store(router.store), with_host_only_evaluation())
        queries = fleet_queries(np.random.default_rng(41), 4096, n_repos, n_users)
        want = oracle.check(background(), consistency.full(),
                            *[rel.must_from_triple(*t) for t in queries])
        oracle_of = dict(zip(queries, want))
        free = dict(before=card_free_mib())
        # PROCS_REPLICAS processes started together; one joins the ring,
        # the others wait out its load window bootstrapped, then join
        boot, load = [], {}
        t0 = time.perf_counter()
        kids += [proc_replica(tmp, router.port, f"proc{i}", join=i == 0)
                 for i in range(PROCS_REPLICAS)]
        boot.append(proc_joined(kids[0], t0))
        ready = [json.loads(k.wait_line("REPLICA-READY", PROCS_BOOT_S).split(" ", 1)[1])
                 for k in kids[1:]]
        proc_warm(router, queries)
        load["1_process"] = fleet_load(router, oracle_of, queries, load_s,
                                       consistency.min_latency)
        log(f"procs (a): 1 process: bootstrap {json.dumps(boot[0])}; load"
            f" {json.dumps(load['1_process'])}")
        fleet_load_held(load["1_process"], "load with 1 process")
        for k in kids[1:]:
            boot.append(proc_joined(k, t0, router=router))
        if len(router.status()["ring"]) != PROCS_REPLICAS:
            raise AssertionError(f"procs (a): ring {router.status()['ring']}")
        proc_warm(router, queries)
        key = f"{PROCS_REPLICAS}_processes"
        load[key] = fleet_load(router, oracle_of, queries, load_s,
                               consistency.min_latency)
        free[f"with_{PROCS_REPLICAS}"] = card_free_mib()
        log(f"procs (a): {PROCS_REPLICAS} processes: bootstrap"
            f" {json.dumps(boot[1:])} (ready {json.dumps(ready)}); load"
            f" {json.dumps(load[key])}")
        fleet_load_held(load[key], f"load with {PROCS_REPLICAS} processes")
        out["bootstrap"], out["load"] = boot, load
        out["in_process"] = {k: inproc["load"][k] for k in inproc.get("load", {})}
        # writes under load, each read back through its zookie
        out["writes"] = fleet_toggles(router, oracle, oracle_of, queries, n_users)
        log(f"procs (a): writes under load {json.dumps(out['writes'])}")
        # a seeded SIGKILL of one process mid-load
        victim = kids[int(np.random.default_rng(PROCS_KILL_SEED).integers(len(kids)))]
        k0 = m.counter("fleet.kill_detections")
        stop = threading.Event()
        res = {}
        th = threading.Thread(target=lambda: res.update(fleet_load(
            router, oracle_of, queries, 0, consistency.min_latency, stop=stop)))
        th.start()
        try:
            time.sleep(0.5)
            t_kill = time.perf_counter()
            victim.send(signal.SIGKILL)
            deadline = time.monotonic() + 30
            while (len(router.status()["ring"]) >= PROCS_REPLICAS
                   or m.counter("fleet.kill_detections") == k0) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            evict_s = time.perf_counter() - t_kill
            time.sleep(0.5)
        finally:
            stop.set()
            th.join()
        rc = victim.wait(30)
        kills = m.counter("fleet.kill_detections") - k0
        ring = router.status()["ring"]
        if rc != -signal.SIGKILL or len(ring) != PROCS_REPLICAS - 1 or not kills:
            raise AssertionError(f"procs (a): kill of {victim.name} (rc {rc}) not"
                                 f" detected: ring {ring}, detections {kills}")
        fleet_load_held(res, "the SIGKILL window")
        # the card gives the dead process's memory back
        deadline = time.monotonic() + 20
        freed = None
        while DEV == "cuda" and time.monotonic() < deadline:
            freed = card_free_mib() - free[f"with_{PROCS_REPLICAS}"]
            if freed > 256:
                break
            time.sleep(0.2)
        free["after_kill"] = card_free_mib()
        out["failover"] = dict(victim=victim.name, rc=rc, window=res,
                               kill_detections=kills, evicted_s=evict_s)
        log(f"procs (a): SIGKILL {json.dumps(out['failover'])}; card free MiB"
            f" {json.dumps(free)}")
        if DEV == "cuda" and not freed > 256:
            raise AssertionError(f"procs (a): the card did not free the killed"
                                 f" process's memory: {free}")
        # a restarted process bootstraps, catches up, rejoins and answers
        t0 = time.perf_counter()
        again = proc_replica(tmp, router.port, "proc-restart")
        kids.append(again)
        out["restart"] = proc_joined(again, t0)
        ring = router.status()["ring"]
        rels = [rel.must_from_triple(*t) for t in queries[:512]]
        got = router.check(background().with_timeout(300.0), consistency.full(), *rels)
        out["restart"]["mismatches"] = int(sum(
            a != b for a, b in zip(got, want[:512])) + abs(len(got) - 512))
        log(f"procs (a): restart {json.dumps(out['restart'])}; ring {ring}")
        if len(ring) != PROCS_REPLICAS or out["restart"]["mismatches"]:
            raise AssertionError(f"procs (a): the restarted process: ring {ring},"
                                 f" {out['restart']}")
        # SIGINT the survivors together: each reports its device and launches
        survivors = [k for k in kids if k is not victim]
        for k in survivors:
            k.send(signal.SIGINT)
        out["exits"] = [proc_exit(k, signalled=True) for k in survivors]
        out["card_free_mib"] = free
    except BaseException:
        for k in kids:
            log(f"--- {k.name} (alive {k.alive()}) tail ---\n{k.tail()}")
        raise
    finally:
        router.close()
        close_all(kids)
    launches = {}
    for rep in out["exits"]:
        if rep["device"] != DEV or (DEV == "cuda" and not rep["launches"]):
            raise AssertionError(f"procs (a): {rep['id']} exited with {rep}")
        for k_, v in rep["launches"].items():
            launches[k_] = launches.get(k_, 0) + v
    out["launches"] = launches
    missing = [k_ for k_ in ("block", "gate") if not launches.get(k_)]
    if missing and DEV == "cuda":
        raise AssertionError(f"procs (a): {missing} never launched in the"
                             f" replica processes: {out['exits']}")
    return out


DEMO_SCHEMA = """
definition user {}
definition doc {
    relation owner: user
    relation reader: user
    permission read = reader + owner
}
"""


def procs_router_role(tmp):
    """Phase 22 (b): ``fleetd router --demo-world`` and one ``fleetd
    replica --join`` on DEV, every (doc, user) pair of the demo world
    through the router's wire ``check`` op against a host oracle holding
    the same world."""
    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import new_evaluator, with_host_only_evaluation
    from gochugaru_tpu_torch.fleet import wire
    from gochugaru_tpu_torch.scripts.procs import close_all
    from gochugaru_tpu_torch.utils.context import background

    t0 = time.perf_counter()
    kids = []
    try:
        router = proc_spawn(tmp, "router", FLEETD, "router", "--demo-world")
        kids.append(router)
        kv = dict(w.split("=", 1) for w in
                  router.wait_line("ROUTER-READY", PROCS_BOOT_S).split()[1:])
        rep = proc_replica(tmp, int(kv["port"]), "demo0", latency=False)
        kids.append(rep)
        boot = proc_joined(rep, t0)
        oracle = new_evaluator(with_host_only_evaluation())
        ctx = background()
        oracle.write_schema(ctx, DEMO_SCHEMA)
        txn = rel.Txn()
        for i in range(32):
            txn.touch(rel.must_from_triple(f"doc:d{i}", "owner", f"user:u{i % 8}"))
        oracle.write(ctx, txn)
        rels = [rel.must_from_triple(f"doc:d{d}", "read", f"user:u{u}")
                for d in range(32) for u in range(8)]
        want = oracle.check(ctx, consistency.full(), *rels)
        conn = wire.Conn((kv["host"], int(kv["port"])), connect_timeout=10.0,
                         io_timeout=300.0)
        try:
            t1 = time.perf_counter()
            got = conn.request({
                "op": "check", "cs": wire.strategy_to_wire(consistency.full()),
                "rels": [wire.rel_to_wire(r) for r in rels]})["verdicts"]
            check_s = time.perf_counter() - t1
        finally:
            conn.close()
        bad = int(sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want)))
        exit_rep = proc_exit(rep)
        rc = router.stop(PROCS_STOP_S)
    except BaseException:
        for k in kids:
            log(f"--- {k.name} (alive {k.alive()}) tail ---\n{k.tail()}")
        raise
    finally:
        close_all(kids)
    out = dict(pairs=len(rels), allowed=int(sum(want)), mismatches=bad,
               check_s=check_s, bootstrap=boot, exit=exit_rep, router_rc=rc,
               seconds=time.perf_counter() - t0)
    log(f"procs (b): router role {json.dumps(out)}")
    if bad or rc != 0 or exit_rep["device"] != DEV:
        raise AssertionError(f"procs (b): {out}")
    return out


def procs_bootstrap(tmp, scale):
    """Phase 22 (c): BASELINE config 3 at ``scale`` in a router's store in
    this process, bootstrapped over the wire by one ``fleetd replica``
    process on DEV: seconds split into the export stream, the import, the
    first snapshot and the first prepare, the process's peak RSS, and a
    PROCS_SAMPLE-check sample against the host oracle."""
    from dataclasses import replace as dc_replace

    from gochugaru_tpu_torch import consistency, rel
    from gochugaru_tpu_torch.client import (
        new_evaluator, with_host_only_evaluation, with_store)
    from gochugaru_tpu_torch.engine.oracle import SnapshotOracle, T
    from gochugaru_tpu_torch.fleet import FleetConfig, FleetRouter
    from gochugaru_tpu_torch.scripts.procs import close_all
    from gochugaru_tpu_torch.utils.context import background

    out = dict(scale=scale)
    router = FleetRouter(config=dc_replace(FleetConfig(), **FLEET_CFG))
    kids = []
    try:
        t0 = time.perf_counter()
        host = new_evaluator(with_store(router.store), with_host_only_evaluation())
        cs, snap, _q, _names = build_docs(scale, client=host)
        out["world"] = dict(edges=snap.num_edges, revision=snap.revision,
                            build_s=time.perf_counter() - t0)
        log(f"procs (c): config 3 at {scale}: {json.dumps(out['world'])}")
        t0 = time.perf_counter()
        rep = proc_replica(tmp, router.port, "boot3", latency=False)
        kids.append(rep)
        rss = RssPeak(rep.pid)
        out["bootstrap"] = proc_joined(rep, t0)
        n_users, _g, _f, n_docs = docs_sizes(scale)
        rng = np.random.default_rng(29)
        pairs = list(zip(rng.integers(0, n_docs, PROCS_SAMPLE),
                         rng.integers(0, n_users, PROCS_SAMPLE)))
        rels = [rel.must_from_triple(f"document:d{a}", "view", f"user:u{b}")
                for a, b in pairs]
        t1 = time.perf_counter()
        got = router.check(background().with_timeout(PROCS_BOOT_S),
                           consistency.full(), *rels)
        out["first_check_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        router.check(background().with_timeout(PROCS_BOOT_S), consistency.full(),
                     *rels)
        out["second_check_s"] = time.perf_counter() - t1
        out["peak_rss_mib"] = rss.stop()
        out["exit"] = proc_exit(rep)
        oracle = SnapshotOracle(snap, {}, now_us=EPOCH)
        want = [oracle.check("document", f"d{a}", "view", "user", f"u{b}", "",
                             now_us=EPOCH) == T for a, b in pairs]
        out["allowed"] = int(sum(want))
        out["mismatches"] = int(sum(a != b for a, b in zip(got, want))
                                + abs(len(got) - len(want)))
    except BaseException:
        for k in kids:
            log(f"--- {k.name} (alive {k.alive()}) tail ---\n{k.tail()}")
        raise
    finally:
        router.close()
        close_all(kids)
    b = out["bootstrap"]["bootstrap"]
    out["split_s"] = dict(stream=b["stream_s"], import_=b["import_s"],
                          materialize=b["materialize_s"],
                          first_prepare=out["exit"]["prepare_s"])
    log(f"procs (c): config 3 bootstrap {json.dumps(out)}")
    if out["mismatches"] or b["relationships"] != out["world"]["edges"]:
        raise AssertionError(f"procs (c): {out}")
    return out


def _http(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read().decode()


def procs_telemetryd(tmp, card):
    """Phase 22 (d): ``telemetryd --device DEV --checks 32``: what
    scripts/telemetry_smoke.sh polls, and /perf?bench=1 naming the card."""
    import re

    from gochugaru_tpu_torch.scripts.procs import close_all

    t0 = time.perf_counter()
    d = proc_spawn(tmp, "telemetryd", "gochugaru_tpu_torch.scripts.telemetryd",
                   "--device", DEV, "--checks", 32)
    try:
        url = d.wait_line("READY url=", PROCS_BOOT_S).split("=", 1)[1]
        deadline = time.monotonic() + 120
        while True:
            metrics_ = _http(url + "/metrics")
            if (re.search(r"^gochugaru_checks_requested_total [1-9]", metrics_, re.M)
                    and re.search(r'^gochugaru_checks_dispatch_seconds\{quantile="0.99"\}',
                                  metrics_, re.M)):
                break
            if time.monotonic() > deadline:
                raise AssertionError("procs (d): no checks counter or dispatch p99")
            time.sleep(0.5)
        health = json.loads(_http(url + "/healthz"))
        trace = json.loads(_http(url + "/traces").splitlines()[0])
        slo = json.loads(_http(url + "/slo"))
        incidents = json.loads(_http(url + "/debug/incidents"))
        bench = json.loads(_http(url + "/perf?bench=1"))["roofline"]
        rc = d.stop(PROCS_STOP_S)
        text = d.text()
    except BaseException:
        log(f"--- telemetryd (alive {d.alive()}) tail ---\n{d.tail()}")
        raise
    finally:
        close_all([d])
    kind = torch.cuda.get_device_name(0) if DEV == "cuda" else DEV
    out = dict(healthz=health["status"], trace_id=trace.get("trace_id"),
               slo_enabled=slo["enabled"], incidents=len(incidents["incidents"]),
               p99_s=float(re.search(
                   r'^gochugaru_checks_dispatch_seconds\{quantile="0.99"\} (\S+)',
                   metrics_, re.M).group(1)),
               fingerprint=bench["fingerprint"], gbps=bench["gbps"], rc=rc,
               card=card, seconds=time.perf_counter() - t0)
    log(f"procs (d): telemetryd {json.dumps(out)}")
    if (health["status"] != "ok" or not out["trace_id"] or slo["enabled"] is not True
            or f"kind={kind}" not in bench["fingerprint"] or rc != 0
            or f"demo world ready on {DEV}" not in text):
        raise AssertionError(f"procs (d): {out}")
    return out


def procs_tune(tmp, n_repos=10_000, n_users=1_000, ticks=6):
    """Phase 22 (e): ``tune --json --seconds 1.5 --online 6`` on DEV at
    config 2's repos and users; scripts/tune_smoke.sh's assertions on its
    output."""
    import re

    from gochugaru_tpu_torch.scripts.procs import close_all
    from gochugaru_tpu_torch.tune import TuneDiff

    t0 = time.perf_counter()
    c = proc_spawn(tmp, "tune", "gochugaru_tpu_torch.scripts.tune", "--json",
                   "--device", DEV, "--repos", n_repos, "--users", n_users,
                   "--seconds", 1.5, "--online", ticks)
    try:
        rc = c.wait(PROCS_BOOT_S)
        text = c.text()
    finally:
        close_all([c])
    if rc != 0:
        raise AssertionError(f"procs (e): tune exited {rc}:\n{c.tail(40)}")
    lines = text.splitlines()
    js = "\n".join(lines[lines.index("{"):max(
        i for i, ln in enumerate(lines) if ln == "}") + 1])
    diff = json.loads(js)
    preset = float(re.search(r"hold ([0-9.]+)ms", text).group(1)) / 1e3
    fixed = json.loads(re.search(r"^# fixed point: (.*)$", text, re.M).group(1))
    moves = sum(int(x) for x in re.findall(r"^#   tick \d+: moves=(\d+)", text, re.M))
    reverted = float(re.search(r"^# reverted to preset: hold=([0-9.e-]+)s", text,
                               re.M).group(1))
    out = dict(knobs={k["knob"]: [k["current"], k["proposed"]] for k in diff["knobs"]},
               evidence=all(k["evidence"] for k in diff["knobs"]),
               round_trip=TuneDiff.from_json(js).to_json(indent=2) == js,
               fixed_point=fixed,
               moves=moves, reverted_hold_s=reverted, preset_hold_s=preset,
               seconds=time.perf_counter() - t0)
    log(f"procs (e): tune {json.dumps(out)}")
    if (not diff["knobs"] or not out["evidence"] or not out["round_trip"]
            or fixed["re_proposed"] or moves < 1 or reverted != preset):
        raise AssertionError(f"procs (e): {out}")
    return out


def procs_profile(tmp, edges=1_000_000):
    """Phase 22 (f): ``profile_prepare --device DEV --edges 1000000``: the
    prepare stage timers and the first check's top frames."""
    import re

    from gochugaru_tpu_torch.scripts.procs import close_all

    t0 = time.perf_counter()
    c = proc_spawn(tmp, "profile", "gochugaru_tpu_torch.scripts.profile_prepare",
                   "--device", DEV, "--edges", edges, "--top", 12)
    try:
        rc = c.wait(PROCS_BOOT_S)
        text = c.text()
    finally:
        close_all([c])
    if rc != 0:
        raise AssertionError(f"procs (f): profile_prepare exited {rc}:\n{c.tail(40)}")
    stages = {k: float(v) for k, v in re.findall(
        r"^#\s+(prepare\.\S+)\s+([0-9.]+)s$", text, re.M)}
    first = float(re.search(r"^# first check after import: ([0-9.]+)s", text,
                            re.M).group(1))
    frames = [ln.strip() for ln in text.splitlines()
              if re.match(r"^\s+\d+(/\d+)?\s+[0-9.]+\s+[0-9.]+\s+[0-9.]+", ln)]
    out = dict(edges=edges, first_check_s=first, stages_s=stages,
               top_frames=frames, seconds=time.perf_counter() - t0)
    log(f"procs (f): profile_prepare {json.dumps(out)}")
    if "prepare.total_s" not in stages or not frames:
        raise AssertionError(f"procs (f): {out}")
    return out


PROCS_PARTS = "abcdef"


def phase_processes(K, card, inproc, scale, parts=PROCS_PARTS):
    """Phase 22 (see the module docstring): ``parts`` of (a)-(f).  The
    kernels launch in the child processes; this process launches none
    (its counts are set to 0 before and restored after)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t22 = time.perf_counter()
    saved = dict(K.LAUNCHES), dict(K.LANES)
    K.reset_launches()
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    def timed(part, run):
        t0 = time.perf_counter()
        PROCS_OUT[part] = run()
        PROCS_OUT[part]["part_s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="gochugaru_procs_") as tmp:
        # (a) and (c) measure alone; (b), (d), (e) and (f) run side by side
        # (the smoke's time; (f)'s stage timers then share the host)
        for part, run in (("a", lambda: procs_fleet(tmp, inproc)),
                          ("c", lambda: procs_bootstrap(tmp, scale))):
            if part in parts:
                timed(part, run)
        together = [(part, run) for part, run in (
            ("b", lambda: procs_router_role(tmp)),
            ("d", lambda: procs_telemetryd(tmp, card)),
            ("e", lambda: procs_tune(tmp)),
            ("f", lambda: procs_profile(tmp))) if part in parts]
        if together:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(together)) as pool:
                for fut in [pool.submit(timed, *pr) for pr in together]:
                    fut.result()
            PROCS_OUT["side_by_side_s"] = time.perf_counter() - t0
    own = {k: v for k, v in K.LAUNCHES.items() if v}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] += saved[0][k]
        K.LANES[k] += saved[1][k]
    alive = [c.name for c in PROCS_CHILDREN if c.alive()]
    PROCS_OUT["children"] = dict(started=len(PROCS_CHILDREN), alive=alive)
    if alive:
        raise AssertionError(f"procs: children outlived the phase: {alive}")
    if own:
        raise AssertionError(f"procs: this process launched {own}; the replicas"
                             " should have")
    PROCS_OUT["card"] = card
    PROCS_OUT["phase_s"] = time.perf_counter() - t22
    log(f"phase 22: {PROCS_OUT['phase_s']:.1f}s")
    return PROCS_OUT


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale3", type=float, default=1.0,
                    help="size of BASELINE config 3 (1.0 = 1M docs, 10M edges)")
    ap.add_argument("--edges4", type=int, default=10_000_000,
                    help="edges of BASELINE config 4 (published: 100,000,000)")
    ap.add_argument("--edges5", type=int, default=2_500_000,
                    help="edges of BASELINE config 5 (one card's share of the"
                         " published 1B on 16 chips: 62,500,000)")
    ap.add_argument("--scale19", type=float, default=0.1,
                    help="size of phase 19's config 3 world (the scattered"
                         " layout; 1.0 = 1M docs, 10M edges)")
    ap.add_argument("--scale20", type=float, default=0.1,
                    help="size of phases 20 (a) and 21 (a)'s config 3 world"
                         " (1.0 = phase 5's snapshot, 1M docs, 10M edges; cut"
                         " to leave phase 22 room in the smoke's time)")
    ap.add_argument("--scale22", type=float, default=0.1,
                    help="size of phase 22 (c)'s config 3 world, bootstrapped"
                         " over the wire (1.0 = 1M docs, 10M edges)")
    ap.add_argument("--phase22-only", metavar="PARTS", default=None,
                    help="build the kernels and run only these parts of phase"
                         " 22 (letters of abcdef; (a) without phase 18's"
                         " in-process numbers), printing the procs: line and"
                         " no result line")
    ap.add_argument("--part-worker", action="store_true",
                    help="run as one of phase 21 (d)'s two processes (the"
                         " smoke spawns them itself)")
    args = ap.parse_args()
    if args.part_worker:
        return part_proc_worker()
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gochugaru_tpu_torch.engine import kernels as K
    from gochugaru_tpu_torch.engine.kernels.build import build_all

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = build_all(["fused_probe", "fused_probe_aligned"])
    K._launcher()
    K._aligned_launcher()
    log(f"kernel build: {time.perf_counter() - t0:.2f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                log(f"  ptxas {name}: {line.strip()}")
    if args.phase22_only is not None:
        print("procs: " + json.dumps(phase_processes(
            K, card, {}, args.scale22, parts=args.phase22_only)))
        return 0

    phase_kernel_vs_plain(K)
    phase_runs_vs_plain(K)
    phase_runs_edges(K)
    phase_aligned_vs_plain(K)
    phase_block_edges(K)
    phase_gate_cav_edges(K)
    phase_until2_edges(K)
    phase_reduced_edges_aligned(K)

    # ---- the main path: counts from zero, phases 4-7 ------------------
    K.reset_launches()
    with Capture(K) as cap:
        t0 = time.perf_counter()
        cs, snap, q, names = build_rbac()
        log(f"config2: world built in {time.perf_counter() - t0:.2f}s")
        ek, ep, ds, planes = check_world("config2", cs, snap, q, names, K)
        LATENCY_WORLDS["config2"] = dict(ek=ek, ep=ep, ds=ds, q=q)
        ek, ep, ds, al_planes = check_world("config2 aligned", cs, snap, q, names,
                                            K, **ALIGNED)
        same_planes("config2 aligned", al_planes, planes)
        LATENCY_WORLDS["config2 aligned"] = dict(ek=ek, ep=ep, ds=ds, q=q)
        del ek, ep, ds
        t19 = time.perf_counter()
        phase_scattered_world(K, "config2", cs, snap, q, names, planes)
        t19 = time.perf_counter() - t19
        log(f"launches after config2: {json.dumps(K.LAUNCHES)}")
        rbac = (cs, snap, q, names, planes)  # phase 12's world
        del snap
        t0 = time.perf_counter()
        from gochugaru_tpu_torch.client import new_evaluator

        client = new_evaluator() if DEV == "cuda" else new_evaluator(device=DEV)
        cs, snap, q, names = build_docs(args.scale3, client=client)
        log(f"config3 (scale {args.scale3}): world built in {time.perf_counter() - t0:.2f}s"
            f" (imported into a client's store, revision {snap.revision})")
        ek, ep, ds, planes = check_world("config3", cs, snap, q, names, K)
        docs = (cs, snap, q, names, planes)  # phase 12's world
        log(f"launches after config3 checks: {json.dumps(K.LAUNCHES)}")
        n_users, n_groups, _n_folders, n_docs = docs_sizes(args.scale3)
        direct = phase_write_check(K, client, ek, ds, snap, PREPARE_S["config3"],
                                   n_docs, n_users, n_groups)
        serving = phase_serving(K, cap, client, n_docs, n_users, n_groups, card)
        witness = phase_witness_client(K, cap, client, ek, ep, ds, q, names, n_docs,
                                       n_users)
        telemetry = phase_operations(K, cap, client, q, names, direct, n_docs,
                                     n_users, n_groups)
        del client
        gc.collect()
        serving["pins_after_client"] = pin_report(ek)
        log("serving: the engine's latency pins once the client is gone:"
            f" {json.dumps(serving['pins_after_client'])}")
        answers = phase_lookups(cs, snap, ek, ep, ds, args.scale3, card)
        log(f"launches after config3 lookups: {json.dumps(K.LAUNCHES)}")
        LATENCY_WORLDS["config3"] = dict(ek=ek, ep=ep, ds=ds, q=q, scale=args.scale3)
        del ek, ep, ds
        # ---- phases 20 (a) and 21 (a): config 3 split four ways on the ---
        # one card, then partitioned and routed on 1 x 4 (at full size on
        # phase 5's snapshot with --scale20 1.0; cut, after phase 19 on a
        # world of that size)
        t20 = t21 = 0.0
        full20 = args.scale20 >= 1.0
        if full20:
            t20 = time.perf_counter()
            phase_mesh_world(K, "config3", (1, 4), cs, snap, q, names, planes)
            t20 = time.perf_counter() - t20
            t21 = time.perf_counter()
            phase_part_world(K, "config3", (1, 4), cs, snap, q, names, planes,
                             need_mesh=True)
            t21 = time.perf_counter() - t21
        # ---- phase 5b: config 3 aligned on phase 5's snapshot ------------
        ek, ep, ds, al_planes = check_world("config3 aligned", cs, snap, q, names,
                                            K, **ALIGNED)
        same_planes("config3 aligned", al_planes, planes)
        phase_lookups(cs, snap, ek, ep, ds, args.scale3, card,
                      name="config3 aligned", want=answers)
        log(f"launches after config3 aligned: {json.dumps(K.LAUNCHES)}")
        LATENCY_WORLDS["config3 aligned"] = dict(ek=ek, ep=ep, ds=ds, q=q)
        del ek, ep, ds, snap
        gc.collect()
        # ---- phase 19: config 3 scattered, on a world of its own ----------
        t0 = time.perf_counter()
        w19, name19 = build_docs(args.scale19), f"config3 at {args.scale19}"
        planes19 = check_world(name19, *w19, K)[3]
        phase_scattered_world(K, name19, *w19, planes19)
        t19 += time.perf_counter() - t0
        if not full20:
            # phases 20 (a) and 21 (a) cut to --scale20 (phase 19's world
            # where the sizes match)
            t0 = time.perf_counter()
            if args.scale20 != args.scale19:
                w19, name19 = build_docs(args.scale20), f"config3 at {args.scale20}"
                planes19 = check_world(name19, *w19, K)[3]
            phase_mesh_world(K, name19, (1, 4), *w19, planes19)
            t20 += time.perf_counter() - t0
            t0 = time.perf_counter()
            phase_part_world(K, name19, (1, 4), *w19, planes19, need_mesh=True)
            t21 += time.perf_counter() - t0
        del w19, planes19
        gc.collect()
        phase_config4(K, args.edges4)
        log(f"launches after config4: {json.dumps(K.LAUNCHES)}")
        phase_overflow(K)
        phase_overflow(K, **ALIGNED)
        log(f"launches after the overflow worlds: {json.dumps(K.LAUNCHES)}")
        phase_client()
        phase_client(**ALIGNED)
        phase_client_caveats()
        phase_client_caveats(**ALIGNED)
    launches, lanes = dict(K.LAUNCHES), dict(K.LANES)
    log(f"kernels launches on the main path: {json.dumps(launches)}")
    log(f"kernels lanes on the main path: {json.dumps(lanes)}")
    want_modes = list(K.LAUNCHES)
    missing = [m for m in want_modes if launches[m] < 1]
    if missing:
        raise AssertionError(f"modes never launched on the main path: {missing}")

    # ---- the delta chain's own paths, each with counts from zero --------
    phase_delta_chain(K)
    phase_delta_chain(K, **ALIGNED)
    phase_config5(K, args.edges5)

    # ---- phase 12: the legacy two-phase program (no kernel of its own) --
    t12 = time.perf_counter()
    legacy2 = phase_legacy_world(K, "config2", *rbac)
    phase_legacy_world(K, "config3", *docs)
    # config 3 plus the nested-group edges its chains imply, as many as
    # fill the membership columns: the same answers, and rows the deep
    # caps (8/8/8) settle on the card
    t0 = time.perf_counter()
    filled = build_docs(args.scale3, fill_nested=True)
    log(f"config3 filled: world built in {time.perf_counter() - t0:.2f}s,"
        f" {filled[1].mp_subj.shape[0] - docs[1].mp_subj.shape[0]} implied"
        f" nested-group edges added (membership rows {filled[1].mp_subj.shape[0]})")
    phase_legacy_world(K, "config3 filled", *filled, docs[4], settled_min=0.9)
    del docs, filled
    phase_legacy_spill(K, *rbac[:3], legacy2)
    own_launches(K, "client legacy", phase_legacy_client, need=())
    log(f"phase 12: {time.perf_counter() - t12:.1f}s")

    # ---- phase 15 (the rest): the witness plane on phase 13's worlds -----
    witness = phase_witness_worlds(K, rbac, card, witness)

    # ---- phase 13: the latency path on pinned CUDA graphs ---------------
    latency = phase_latency(K, card)

    # ---- phases 17-18: the tuner and the fleet on config 2 ---------------
    tune = phase_tune(K, card)
    fleet = phase_fleet(K, card)

    # ---- phase 19 (client part): the scattered layout through a client --
    t0 = time.perf_counter()
    phase_scattered_client(K)
    t19 += time.perf_counter() - t0
    SCATTERED_OUT["phase_s"] = t19
    SCATTERED_OUT["card"] = card
    log(f"phase 19: {t19:.1f}s")

    # ---- phase 20 (the rest): config 2's meshes, a write, lookups -------
    t0 = time.perf_counter()
    phase_mesh_world(K, "config2", (2, 2), *rbac)
    phase_mesh_world(K, "config2", (1, 3), *rbac)
    phase_mesh_client(K)
    t20 += time.perf_counter() - t0
    MESH_OUT["phase_s"] = t20
    MESH_OUT["card"] = card
    log(f"phase 20: {t20:.1f}s")

    # ---- phase 21 (the rest): config 2 partitioned, a client, processes --
    t0 = time.perf_counter()
    phase_part_world(K, "config2", (1, 4), *rbac)
    # the same batch with the fold off: read/admin are walked permissions,
    # not routable, so it has to fall back to the psum path
    phase_part_world(K, "config2", (1, 4), *rbac, fallback=True, flat_fold=False)
    phase_part_world(K, "config2", (2, 2), *rbac, need_mesh=True)
    phase_part_client(K)
    phase_part_processes(K, rbac)
    t21 += time.perf_counter() - t0
    PART_OUT["phase_s"] = t21
    PART_OUT["card"] = card
    log(f"phase 21: {t21:.1f}s")

    # ---- phase 22: the operator entry points as processes on the card ---
    procs = phase_processes(K, card, fleet, args.scale22)

    # ---- per-mode timing at the largest main-path shape ----------------
    table = []
    for mode in K.MODES + (K.GATE_CAV,):
        row = time_mode(K, mode, *cap.best[mode][1:], card)
        if mode == "runs":
            deep = time_mode(K, mode, *cap.best["runs.deep"][1:], card)
            row["deep_bucket"] = {k: deep[k] for k in (
                "lanes", "cap", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by")}
        row["launches"] = launches[mode]
        row["lanes_total"] = lanes[mode]
        table.append(row)
    for mode in K.ALIGNED_MODES + (K.GATE_CAV,):
        row = time_aligned(K, mode, *cap.best[f"aligned.{mode}"][1:], card)
        deep = time_aligned(K, mode, *cap.best[f"aligned.{mode}.deep"][1:], card)
        row["deep_levels"] = {k: deep[k] for k in (
            "lanes", "capT", "levels", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by")}
        row["launches"] = launches[f"aligned.{mode}"]
        row["lanes_total"] = lanes[f"aligned.{mode}"]
        table.append(row)
    log(f"smoke: {time.perf_counter() - t_smoke:.1f}s from start to the result")
    print("latency: " + json.dumps(latency))
    print("serving: " + json.dumps(serving))
    print("witness: " + json.dumps(witness))
    print("telemetry: " + json.dumps(telemetry))
    print("spmm: " + json.dumps(SPMM))
    print("tune: " + json.dumps(tune))
    print("fleet: " + json.dumps(fleet))
    print("scattered: " + json.dumps(SCATTERED_OUT))
    print("mesh: " + json.dumps(MESH_OUT))
    print("part: " + json.dumps(PART_OUT))
    print("procs: " + json.dumps(procs))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
