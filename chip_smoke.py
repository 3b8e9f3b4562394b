#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spark_fsm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every kernel from ``csrc/`` with nvcc (sm_90a), one nvcc per
     source, and the native tokenizer (``data/_fasttok.c``) with gcc, all
     started together; print which tokenizer runs;
  3. the pair-support kernel against its plain PyTorch version on the card,
     exact equality, W in {1, 2, 3} on ragged shapes and at the main
     path's launches, plus the candidate extraction of ``batch_supports``;
     with the live-row hint (``n_live``, all-zero item rows after it) and
     without: at SPAM's wave on a mesh (P = 2 x the SPAM engine's node
     batch, NI=64, 17 live, S=990,016), at the stream sweep (17 live of
     128), at n_live 0, NI and a ragged 37 of 64;
  4. the kernel (with the hint its caller passes) and its plain version
     timed with CUDA events at the headline launch (P=2048, NI=360,
     S=77,504, W=1), at the queue engine's wide and late waves (P=1024 and
     P=128, NI=384, 360 live), at the classic engine's first launch
     (P=720, NI=360), at the stream sweep's widest level (P=2048, NI=128,
     17 live, S=131,072) and at SPAM's wave on a mesh, beside the least
     time the card could take for the same work over the live rows;
  5. the main path at full data size: ``mine_spade_torch`` on a
     BMS-WebView-2-shaped database (77,500 sequences) at minsup 0.1 %,
     which the router sends to the queue engine, byte-identical to the CPU
     oracle (a child process started at the top, as phase 13's), with
     one pair-support launch per wave; then the same mine
     pinned to the classic engine (``fused="never"``) and to the dense
     engine (``fused="dense"``, one launch per level), each byte-identical
     to the oracle; at minsup 50 the dense engine's frontier (and the
     queue engine's children a wave) overflow and ``fused="dense"`` and
     ``"auto"`` fall back to the classic engine, byte-identical to the
     SPAM engine's mine; the mine checkpointed (the queue engine in
     segments; a
     mid-mine snapshot resumed in the classic engine), byte-identical; the
     vertical build timed with the native and the numpy tokenizer;
  6. a multiword mine (W >= 2) against the oracle;
  7. the rule-support kernel against its plain PyTorch version on the card,
     exact equality, W in {1, 2, 3} on ragged shapes, every km of the
     launch planner's ladder, unused (-1) slots, stores at and one past the
     largest the staged path holds, and the resident route's waves;
  8. the rule-support kernel and its plain version timed with CUDA events at
     the headline launch (C=8192, km=2, M=256, S=990,000, W=1), at km=1 and
     at the resident route's wide and late waves (C=512 and C=64, km=4),
     beside the least time the card could take for the same work;
  9. the TSR path at full data size: ``mine_tsr_torch`` on a Kosarak-shaped
     database (990,000 sequences) with k=100, minconf=0.5, max_side=2,
     every rule's counts recounted on the host, the kernel's launches
     counted (phase 21 holds the mine through the kernel against the
     plain evaluator's on a tenth of the database); the vertical build
     timed, and both tokenizers on a tenth of the database;
 10. the TSR path against the copied CPU oracle (``mine_tsr_cpu``) at 1 %
     of that size, and on a multiword (W >= 2) database;
 11. the extension-count-prune kernel against its plain PyTorch version on
     the card, exactly (counts and survivor masks), W in {1, 2, 3}, ragged
     P and S, all-zero pad item rows, thresholds 1, the median count and
     one above the largest, with the live-row hint (``n_live``) and
     without; at threshold 1 its counts equal the pair-support kernel's;
 12. the extension-count-prune kernel and its plain version timed with
     CUDA events at the SPAM engine's wave on the MSNBC-shaped database
     (P = 2 x the engine's node batch on this card, NI=64 of which 17 rows
     are live, S=990,016, W=1) and at the BMS-WebView-2-shaped dense wave
     (P=128, NI=64, 26 live, S=77,504, W=1): without the hint against the
     bound over all 64 lanes, with it at threshold 1 and at the median
     count against the bound over the live lanes; the kernel per launch
     over 50 back-to-back calls (each with its one zero-fill) queued behind
     a spinning kernel, since a launch is shorter than the wrapper's host
     work;
 13. the SPAM path at full data size: ``mine_spam_torch`` on an
     MSNBC-shaped database (990,000 sequences) at minsup 0.5 %, which the
     planner routes to SPAM, byte-identical to the CPU oracle and to the
     queue engine, with one kernel launch per wave; the vertical build
     timed, and both tokenizers on a tenth of the database;
 14. the SPAM path on the hybrid plan: phase 5's database at minsup 0.1 %
     (dense items as wave lanes, sparse items as pair lanes),
     byte-identical to phase 5's oracle result, and a multiword SPAM mine
     against the oracle;
 15. TSR's resident-frontier route at full data size: phase 9's
     Kosarak-shaped vertical DB through ``TsrTorch`` with k=100,
     minconf=0.5 and no side cap, pinned to the resident route
     (``resident="always"``) and to the host loop (``"never"``),
     byte-identical to each other and to the host recount, the
     rule-support kernel launched once a wave, its bound summed over the
     rows each launch names; what ``auto`` picks at this size; at 1 % of
     it, ``mine_tsr_torch``'s ``auto`` takes the resident route,
     byte-identical to ``mine_tsr_cpu``, and ``auto`` and the host loop
     are timed warm in turns;
 16. constrained SPADE (cSPADE).  First the window-mask kernel
     (``csrc/maxstart_masks.cu``) against its plain version, bit for bit,
     on ragged shapes and at the Gazelle node batch (nb = 32, S = 59,601,
     W = 3 and 9), int8 and int16 states, windows None, 0, 3, 5 and past
     n_pos; then kernel and plain version timed at that batch (int16,
     maxwindow 5) beside its bytes bound.  Then ``mine_cspade_torch`` on a
     Gazelle-shaped database (59,000 sequences) with maxgap 2, maxwindow 5
     and minsup 0.5 %, and at 10 % of that size, each byte-identical to
     the copied CPU oracle ``mine_cspade``, with one mask launch and one
     B1 launch for each node batch with candidates.  The oracles run in
     two child processes started at the top, so they overlap the card
     phases;
 17. streaming windows at full size: the MSNBC-shaped database cut into
     ten micro-batches of 99,000 sequences, a window of five, minsup
     0.5 %, pushed through ``IncrementalWindowMiner`` (the pair-support
     kernel once a swept level) and through the re-mine ``WindowMiner``
     (``mine_spade_torch(..., shape_buckets=True)``): after every push the
     two pattern texts are byte-identical, and after pushes 1, 5 and 10
     they equal the copied oracle's mine of the window (three more child
     processes started at the top); per push and route the wall, the
     incremental miner's stage split and counters, the kernel's launches
     and the peak device memory;
 18. the repair fold and multiword batches on the card: a stream of small
     two-word batches at an absolute minsup that moves patterns across
     the border both ways, every push byte-identical to the oracle and to
     the gather-join branch (``use_kernel=False``), with nodes repaired
     after the first push;
 19. ``shape_buckets=True`` on the card: SPADE's ``auto`` route on phase
     5's database, SPAM on phase 17's first batch (10 % of phase 13's
     size), TSR on phase 15's 1 % database and cSPADE on phase 16's 10 %
     database, each against the oracle text an earlier phase holds, with
     the route each took;
 20. prediction scoring at the service's ``[predict]`` defaults over three
     rule sets that earlier phases hold: phase 9's Kosarak-shaped TSR
     rules and, through ``rules_from_patterns``, phase 5's
     BMS-WebView-2-shaped SPADE patterns and phase 13's MSNBC-shaped SPAM
     patterns.  Each is serialized, built through the artifact cache at
     the depth each request needs, and 2,050 prefixes drawn from its
     database (the empty one and an absent item among them) are scored in
     waves of 1, 16 and 64 rows at m = 8 through ``score_wave``, every row
     byte-identical to ``predict_host`` as sorted JSON; per wave width the
     wave's device time (CUDA events) and wall, median and p99, beside
     the host's pack, scoring (upload, launches, readback wait) and
     decode; the widest wave's peak device
     memory; then 16 threads send 512 requests through the broker with
     its window on (fused share, waves).  No hand kernel runs on this
     path (the scorer is torch code): B1, B2 and B3 launch 0 times;
 21. sequence meshes on the card (``parallel.launch.spawn_world``): a
     tenth of phase 9's database mined on one device through the kernel
     and through the plain evaluator, byte-identical; then a 1-rank NCCL
     world and a 2-rank gloo world whose ranks share the card.  Every rank mines, through the entry points with ``mesh=``:
     phase 5's BMS-WebView-2-shaped SPADE through ``auto`` (the queue
     engine) and ``fused="never"``, MSNBC-shaped SPAM on a tenth of
     phase 13's database (B1 on the shard, the all-reduce, the
     threshold; B3 never), a tenth of
     phase 9's Kosarak-shaped TSR (B2; the host loop, never the resident
     route; held against a one-device mine of that tenth),
     phase 16's full-size Gazelle-shaped cSPADE and the first five pushes
     of phase 17's stream through ``IncrementalWindowMiner(mesh=)``; each
     answer must equal the earlier phase's text (SHA-256 of the canonical
     text) on every rank.  Co-located ranks take the one-device pool
     budget divided by the ranks on the card, and the sum of their peaks
     must fit the card.  Both worlds mine the SPAM path, its partitioned
     SPAM and the stream's pushes on a tenth of phase 13's database, each
     held against a one-device mine of that tenth, to keep the smoke
     inside its time limit.  ``[mesh]`` lines print per world and mine
     the
     route, each rank's B1/B2/B3 and window-mask launches and kernel time
     (CUDA events around each launch; the cSPADE shard launches the mask
     kernel and B1 once each a node batch with candidates, no other mine
     the mask kernel), the all-reduces' count and time, each rank's
     wall beside the one-device wall of the earlier phase, and each
     rank's peak memory, with the card's name and power limit.  The
     2-rank world also mines in two class partitions
     (``partition_parts=2``, one partition row a rank, each on the bare
     one-device route, the exchange through gloo): phase 9's TSR, phase
     5's SPADE through ``auto`` and phase 13's SPAM, each rank
     byte-identical to the earlier phase's text, with its exchange rounds
     and bytes; in the 1-rank world ``partition_parts=2`` raises the
     ``ValueError`` of a mesh that does not split;
 22. class-partitioned mines at full size in one process (``mesh=None``:
     the partitions mined in turn on the card), each held by SHA-256 of
     its text against the earlier phase's: phase 9's Kosarak-shaped TSR
     (``max_side=2``) at 2 parts through ``TsrPartitioned`` on phase 9's
     vertical DB, beside the unpartitioned ``TsrTorch`` on it; phase 15's
     1 % TSR (``max_side=None``, each slice on the resident route) at 2
     parts (at 4 its first slice alone evaluates about 15 times the
     unpartitioned mine's candidates: ``profile_mine tsr-partition``);
     phase 5's BMS SPADE at 2
     parts through ``auto`` (queue slices) and ``"never"`` (classic);
     phase 13's MSNBC SPAM and phase 16's Gazelle cSPADE at 2 parts; and a
     composite checkpoint of the BMS mine (a snapshot at every chance)
     resumed from a snapshot taken mid-slice.  ``[part]`` lines print the
     plan's imbalance, per partition the wall, the candidates evaluated
     and the B1/B2/B3 and window-mask launches and kernel time (CUDA
     events; cSPADE one mask and one B1 launch a node batch), the
     exchanges (one a deepening round on TSR, one a mine otherwise), the
     peak and the unpartitioned wall of the same run; B1, B2 and B3 must
     each launch on the partitioned path;
 23. the service: the port's ``serve_background()`` (default device
     ``cuda``) in this process, with a source registered through
     ``service.sources.register`` that names the full-size databases of
     phases 9, 13, 16 and 5.  Over HTTP: ``TSR_TPU`` k=100, minconf 0.5,
     ``max_side=2`` on the Kosarak-shaped database, ``SPAM_TPU`` at
     0.5 % on the MSNBC-shaped one, ``SPADE_TPU`` with maxgap 2 and
     maxwindow 5 on the Gazelle-shaped one, ``SPADE_TPU`` at 0.1 % on the
     BMS-WebView-2-shaped one and that request again, which the engine
     cache answers (``store_cache_hit``).  Every ``/get/*`` body equals
     ``model.serialize_*`` of the earlier phase's library result by
     SHA-256; B2, B3 and B1 launch during the TSR, SPAM and SPADE
     requests, and the window-mask kernel and B1 once each a node batch
     during the cSPADE request; ``/predict`` against the TSR and SPADE
     results equals
     ``predict_host`` on 16 prefixes each; ``/admin/stats`` reports
     ``backend: "cuda"``.  ``[service]`` lines print each job's
     submit-to-finished wall beside the library walls of the same call,
     the cache hit's wall, ``/predict`` latency and the peak device
     memory, with the card's name and power limit;
 24. the warm and fused service on the card.  (a) Two fresh child
     processes (``python -m spark_fsm_tpu_torch.service.app --device
     cuda``, so the CUDA context, the kernel libraries' loads and the
     caching allocator start cold; both share the checkout's build
     directory, as two restarts of one service would): one boots
     without prewarm, the other with ``[prewarm] enabled`` at phase 5's
     BMS-WebView-2-shaped SPADE envelope (the boot prewarm, before it
     listens), then takes ``/admin/prewarm`` at phase 15's 1 %
     Kosarak-shaped TSR envelope.  Each takes ``SPADE_TPU`` at 0.1 % on
     the BMS database and ``TSR_TPU`` k=100, minconf 0.5 (no side cap:
     the resident route) on the 1 % database as ``/train`` requests
     (INLINE), each body equal to the library result by SHA-256.  Printed:
     each child's boot wall, the prewarm report (keys, walls, builds and
     first loads), each first job's wall, and ``/admin/shapes``: its
     ``drift`` after the BMS job and, after the TSR job, the recorded keys
     outside both prewarms' enumerations, each ``[]``; a report row with
     an ``error`` fails the phase.  (b) In this process, a service with
     ``[fusion] enabled`` and two miner workers takes two ``TSR_TPU``
     jobs at once, their first waves held in the broker's window until
     both jobs have one pending: on phase 9's Kosarak-shaped database
     (k=100, minconf 0.5, ``max_side=2``), both bodies equal to phase 9's
     library result by SHA-256, with the broker's decisions printed (at
     this size every wave fills one 8,192-lane launch, so the cost model
     rejects each group: fusing saves no dispatch and pays the prep
     concat); then on phase 13's MSNBC-shaped database (990,000
     sequences, 17 items; k=100, minconf 0.5, ``max_side=2``), where a
     wave's candidates leave its launches part-filled: both bodies equal
     the library result by SHA-256,
     ``fsm_fusion_launches_total{cross_job="true"}`` must rise and a fused
     store the broker built gives B2 equal to its plain version.  A
     full-size fused store laid out as the broker lays one out (two
     engines' first-round stores of phase 9's vertical DB) gives B2 equal
     to plain, timed against one job's store with the same candidates
     (the walk path against the staged).  (c) An injected ``device.oom``
     on the first broker launch of the MSNBC-shaped pair (a cross-job
     launch halved by the engine's own ladder) and on the first kernel
     launch of a Kosarak TSR mine on phase 9's vertical DB:
     ``degraded_launches`` >= 1 in each job and the rules byte-identical;
 25. the service on a mesh.  (a) Under a meshguard (``dead_after=1``),
     phase 9's Kosarak-shaped TSR at 2 parts (``TsrPartitioned`` on phase
     9's vertical DB) and phase 5's BMS SPADE at 2 parts, each with an
     injected ``device.dispatch`` fault on part 0's first dispatch: the
     dead row's slice is adopted in this process, every result
     byte-identical to the earlier phase's, dead rows ``[0]`` and epoch 1,
     the wall beside phase 22's healthy one.  (b) The same TSR drill on a
     tenth of the database in a 2-rank gloo world sharing the card, the
     fault on rank 0's row: rank 1 adopts part 0 through the exchange, the
     rules' SHA-256 equal on both ranks and to phase 21's one-device mine,
     the walls beside phase 21's healthy ones; then a service booted with
     ``[engine] mesh_devices = 2`` through the launcher (``python -m
     spark_fsm_tpu_torch.service.app``: rank 0 serves, rank 1 replays)
     takes phase 5's BMS SPADE and the tenth's TSR as ``/train`` jobs
     (FILE sources) and phase 17's first five pushes, every body equal to
     the library's by SHA-256, ``/admin/stats`` ``mesh_devices`` 2, and
     exits 0 on SIGTERM.  (c) A service in this process with ``[prewarm]``
     at phase 17's stream envelope (``stream_batch_sequences`` =
     ``stream_seq_floor`` = 99,000) takes the ten pushes over HTTP: route
     ``incremental``, each push's patterns equal to phase 17's by SHA-256,
     B1 on every push with a tracked tree, ``/admin/shapes`` drift ``[]``
     (the reference's four sweep row buckets hold its widest level).  ``[meshguard]``, ``[world]`` and
     ``[stream-service]`` lines print the walls beside the library's,
     launches and peaks with the card's name and power limit.
     ``python3 chip_smoke.py --phase 25`` runs this phase alone on
     inputs made here through the library.
 26. the replicated service: replicas of ``spark_fsm_tpu_torch.service.app``
     (``--device cuda``, each its own process, started through
     ``chip_smoke.py --replica`` so the phase reads their B1/B2/B3 launch
     counts and peaks) on one copied MiniRedis (``tests/_torch_miniredis.py``)
     in this process, ``[cluster]`` leases of 2 s.  (a) Replicas A and B,
     a 4 s delay armed on A's frontier saves (``/admin/faults``): phase
     5's BMS SPADE checkpointed on A's queue route, phase 13's MSNBC SPAM
     and the tenth's Kosarak TSR queued behind it and stolen by B; A is
     killed -9 as the spine flush after its first frontier save lands
     (taken from the store's writes, not a sleep); B adopts the drill only
     after A's lease expires and resumes it; every body equal to the
     earlier phase's by SHA-256, one terminal status each,
     ``fsm_job_time_to_adoption_seconds`` read from B, ``/admin/trace`` on
     B merging both replicas' spans, every journal intent, lease and
     marker settled, B1 launched on A and B1, B2, B3 on B.  (b) One
     replica (one worker, ``queue_depth`` 2, ``[storeguard]``, the store
     behind ``utils/netproxy.NetProxy``): the drill and two fillers, three
     more submits shed with 429 and an integer Retry-After, a kill -9 at
     the drill's first frontier save, a reboot on the same store resumes
     the drill to the same SHA-256 and fails the fillers durably
     ("interrupted by restart"), the queue-depth gauge back to 0.  (c)
     The rebooted replica mines the drill again and the proxy black-holes
     the store as its first frontier save lands: the job stalls, never
     fails; once the link is back the same replica reacquires it, replays
     its spool to empty and finishes with the same SHA-256.  (d) ``python
     -m spark_fsm_tpu_torch.service.fleet --initial 2`` (its default
     ``--device cuda``), three BMS jobs, a desired count of 3 published,
     the supervisor SIGKILLed as it boots the third replica and restarted
     with ``--initial 0``: three live heartbeats, no replica booted twice,
     every job settled once with parity.  ``[replica]`` lines print the
     boots, each job's wall beside the library's, the time to adoption,
     the stall and resume, each replica's launches and peak, with the
     card's name and power limit.  ``python3 chip_smoke.py --phase 26``
     runs this phase alone on inputs made here through the library.
 27. faults and bitrot.  (a) ``device.resident`` armed ``nth=1`` at its
     segment dispatch, its counter readback and its records readback
     around phase 15's 1 % Kosarak-shaped TSR (k=100, minconf 0.5,
     ``max_side=None``, ``resident="always"``): each mine raises out of
     ``mine_tsr_torch`` (the port has no resident-round fallback) with the
     site's counters at 1/1; the unarmed mine's rules equal phase 15's by
     SHA-256.  (b) A replica of ``spark_fsm_tpu_torch.service.app`` on the
     copied MiniRedis (faults, ``[rescache]`` and the integrity scrubber
     on): ``device.dispatch`` armed at B2's launch through
     ``/admin/faults`` fails the tenth's TSR job cleanly (the error names
     the site, nothing stored, journal and lease settled); disarmed, the
     resubmit's rules equal the library's by SHA-256 and warm the result
     cache.  (c) ``scripts/bitrot_smoke.py`` steps 1-6 on the card: phase
     5's BMS SPADE checkpointed on the classic route (B1) and the replica
     killed -9 as the checkpoint after two delta chunks lands; the last
     delta byte-flipped, the cache entry truncated, a flipped journal
     intent planted; the reboot's recovery line reports ``1
     quarantined``, the drill heals to the last good chunk and finishes
     with the library's patterns by SHA-256, the TSR resubmit mines cold
     with the library's rules, the scrubber quarantines an intent planted
     at rest, ``/admin/integrity`` lists the records, and the
     ``fsm_integrity_*`` families are live.  ``[chaos]`` and ``[bitrot]``
     lines print the walls, kill-to-ready, resume-to-finished, each
     replica's launches and peak, with the card's name and power limit.
     ``python3 chip_smoke.py --phase 27`` runs this phase alone on inputs
     made here through the library.
 28. the planes at size, on phase 27's inputs: one child of
     ``spark_fsm_tpu_torch.service.app`` (``chip_smoke.py --replica``,
     ``--device cuda``, one Miner worker) with ``[rescache]``, ``[usage]``
     (``flush_every_s`` 0), ``[fusion]``, ``[fairness]`` (tenants acme and
     globex), ``[cluster]`` on the in-proc store, tracing and faults on.
     (a) ``scripts/rescache_smoke.py``'s story at size: acme mines the
     tenth's TSR cold; while it runs, an identical pair of the 1 %
     database's TSR coalesces, leader and follower, into one mine (an
     entry is keyed by dataset and algorithm, so a pair on the tenth
     would replace the cold entry); the repeat is an exact hit, a smaller k
     a dominated serve, and BMS SPADE at 0.1 % then 0.2 % a dominated
     SPADE serve; every body SHA-256 == a library mine at its own
     parameters.  (b) ``scripts/usage_smoke.py``'s: per-tenant
     ``fsm_usage_launches_total`` sums exactly to
     ``fsm_fusion_launches_total`` (and traffic to the broker's), beside
     the child's own B2 count; ``/admin/usage`` serves both tenants' rows
     (acme's avoided seconds > 0) and the top jobs.  (c)
     ``scripts/obs_smoke.py``'s: ``/metrics`` parses, every fault site and
     retry policy has its series; the cold TSR job's merged dump has its
     job and mine spans, ``tsr.prep`` + ``tsr.launch`` spans ==
     ``kernel_launches``, ``fusion.launch`` spans == ``fusion_launches``,
     each launch span with ``predicted_s`` and a duration, the lifecycle
     marks; the BMS job's dump has ``queue.dispatch`` and
     ``queue.readback``; ``/admin/cluster`` and ``/admin/slo`` answer for
     the jobs just run.  (d) ``device.oom`` armed through
     ``/admin/faults`` around the 1 % TSR job: rules equal the library's,
     the event on the launch span with two half-width children (the
     broker's ``fusion.launch``, fusion being on), and the same drill on
     the library's direct path (``tsr.launch`` ``point="kernel"``).
     ``[planes]`` lines print the walls and counts with the card's name
     and power limit.  ``python3 chip_smoke.py --phase 28`` runs this
     phase alone on inputs made here through the library.
 29. the elastic fleet: three replicas (``chip_smoke.py --replica``,
     ``--device cuda``, the engine pool split three ways), each reaching
     one copied ``SnoopingMiniRedis`` through its own
     ``utils/netproxy.NetProxy`` from boot, with ``[fairness]``
     (``tenant_depth`` 4), ``[autoscale]`` (3 to 4 replicas), the store
     guard, 2 s leases, faults and tracing on.  Every job is phase 5's
     BMS-WebView-2-shaped SPADE at 0.1 % from a FILE source, every body
     held to phase 5's by SHA-256.  (a) The tenant ``flood`` submits ten
     jobs to A: those past its cap shed with 429 and a Retry-After whose
     error names the tenant; the tenant ``quiet``'s three are admitted
     meanwhile and finish.  (b) Four jobs on each replica, a tenant a
     replica: the leader publishes a desired count of the live replicas
     plus one, read through ``/admin/autoscale``.  (c) Four low-priority
     jobs to C, then ``/admin/drain?exit=1``: C exits 0, A and B steal
     its queue, each job settles once, ``/admin/cluster`` shrinks to two.
     (d) ``tests/_torch_storm.py``'s round, seed 7001 and eight steps,
     over A and B and their proxies, with phase 5's job and the same
     database at 0.2 % as its templates; healed, the checker holds one
     terminal status per accepted job, every finished body's text equal
     to the library's, lease tokens that never fall, and no journal
     intent, lease, admission marker or spool entry left.  (e) The
     ``fsm_autoscale_*``, ``fsm_tenant_*``, ``fsm_replica_drains_*`` and
     ``fsm_storeguard_*`` families are live on A and B.  ``[fleet]``
     lines print the boots, each job's wall beside the library's, the
     sheds, the decision and drain walls, the storm's events and
     accounting, each replica's launches and peak.  ``python3
     chip_smoke.py --phase 29`` runs this phase alone;
 30. the sources, the remote entry and the stream consumer: one child of
     the service (``--remote-port`` set, ``[rescache]`` off).  (a) Phase
     5's database as a sqlite ``clicks`` table read through a registered
     field spec (``table=`` and ``query=``), as a Piwik ecommerce export
     and as documents served by ``tests/_torch_minies.py`` (pages of
     10,000): each ``/train`` of ``SPADE_TPU`` at 0.1 % gives a body equal
     by SHA-256 to phase 5's.  (b) Over the actor protocol's socket: train
     -> status -> get of phase 21's tenth Kosarak-shaped TSR (k = 100,
     minconf 0.5, ``max_side=2``), its rules equal to the library's by
     SHA-256; a ``get:prediction`` equal to ``predict_host``; a malformed
     line, after which the connection still answers.  (c) Phase 17's
     stream through a fake ``poll()``-shaped consumer (two partitions,
     one multiline SPMF record a micro-batch, one poison record),
     ``KafkaFetch(on_bad="skip")`` and ``PollConsumer`` into the port's
     ``IncrementalWindowMiner``: the window after polls 1, 5 and 10 equal
     to phase 17's by SHA-256, the poison record counted and
     dead-lettered.  ``[sources]`` lines print the rows, each job's
     ``dataset_s`` and ``mine_s`` beside the library's mine, the walls a
     poll beside phase 17's pushes and B1's launches.  ``python3
     chip_smoke.py --phase 30`` runs this phase alone.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, as in the repository's
# measurement notes): 3.35 TB/s of device memory, and 32-bit integer work
# on the CUDA cores at 128 lanes per SM per clock — half of the 67 TFLOP/s
# fp32 rate, which counts 128 lanes and two operations per fused
# multiply-add.  128 is the most any mix can dispatch (four schedulers, one
# warp instruction a clock each); logic ops (LOP3) run on 64 of the lanes
# and adds (VIADD, IMAD) on the others, so a mix of the two can reach it.
# (64 lanes, the rate used before, is not a least time: B1's body of one
# LOP3 and one add a pair ran above it.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

# (P, NI, S, W) of the timed launches: the headline launch; the main path's
# queue waves, wide (2 x nb = 1024 rows) and late (2 x nb_late = 128 rows)
# over the item axis padded to 384; and the classic engine's first launch
# (the 360 frequent items as parents, plain and s-ext-transformed rows)
HEADLINE = (2048, 360, 77504, 1)
WIDE_WAVE = (1024, 384, 77504, 1)
LATE_WAVE = (128, 384, 77504, 1)
CLASSIC_LAUNCH = (720, 360, 77504, 1)
# the stream's widest sweep level: 2 x the level's pow2 width (phase 17
# checks it) over the batch store's 128 item rows (17 live items padded to
# the reference's I_TILE) and its bucketed 131,072 sequences
STREAM_SWEEP = (2048, 128, 131072, 1)
# live item rows (n_live) the callers pass at those launches: BMS's 360
# frequent items, the stream's 17 present items; SPAM's wave on a mesh
# (P set in main() from the engine's node batch, 17 live of NI = 64,
# S = 990,016) passes MSNBC's 17 items
PAIR_LIVE = {HEADLINE: 360, WIDE_WAVE: 360, LATE_WAVE: 360,
             CLASSIC_LAUNCH: 360, STREAM_SWEEP: 17}
SPAM_MESH_LIVE = 17
# (nb, S, W) of the Gazelle cSPADE node batch whose window masks phase 16
# times: 32 nodes, 59,601 sequences, 9 words (288 int16 state positions)
MASK_BATCH = (32, 59601, 9)
# (C, km, M, S, W) of the timed rule-support launches: the TSR path's
# headline launch (8192 candidates at km = 2 over the top 256 items of the
# Kosarak-shaped database) and the same launch at km = 1
RULE_HEADLINE = (8192, 2, 256, 990000, 1)
RULE_KM1 = (8192, 1, 256, 990000, 1)
# the resident route's waves on the same stores: nb = 512 popped entries
# (the caps on an 80 GB card) and the late width nb_late = 64, at the
# ring's km = 4 item slots a side
RULE_RESIDENT_WIDE = (512, 4, 256, 990000, 1)
RULE_RESIDENT_LATE = (64, 4, 256, 990000, 1)
# (P, NI, S, W) of the timed extension-count-prune launch at the BMS dense
# wave (64 nodes, 26 dense items padded to 64); the MSNBC wave's P is twice
# the engine's node batch on this card, set in main()
BMS_WAVE = (128, 64, 77504, 1)


# the stream of phase 17: MSNBC-shaped micro-batches, a window of five,
# minsup 0.5 % of the window; the copied oracle mines the window after
# pushes 1, 5 and 10 in child processes (the wall first, then the text)
STREAM_PUSHES, STREAM_KEEP, STREAM_MINSUP = 10, 5, 0.005
STREAM_ORACLE_PUSHES = (1, 5, 10)
STREAM_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import msnbc_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
push, n_push, keep, rel = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), float(sys.argv[4]))
db = msnbc_like(scale=1.0, fast=True)
per = len(db) // n_push
lo = max(0, push - keep) * per
hi = push * per if push < n_push else len(db)
window = db[lo:hi]
t0 = time.perf_counter()
res = mine_spade(window, abs_minsup(rel, len(window)))
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
# phase 20: prediction scoring; the broker run's requests and client threads
PREDICT_REQUESTS = 512
PREDICT_THREADS = 16
# phase 18's multiword stream: batches of 40 sequences of about 40
# itemsets (two words), a window of two, an absolute minsup
MW_STREAM = dict(seed=8, batches=5, per_batch=40, minsup=70)


# phase 21: the mesh worlds, both on the one card: (backend, ranks)
MESH_WORLDS = (("nccl", 1), ("gloo", 2))
MESH_STREAM_PUSHES = 5
# phase 21's Kosarak-shaped TSR: a tenth of phase 9's database (the
# reduce's cost shows at that size; phases 9 and 22 mine the full one)
MESH_KOSARAK_SCALE = 0.1
# both worlds mine their MSNBC-shaped SPAM, partitioned SPAM and stream
# pushes on a tenth of phase 13's database, held against one-device mines
# of that tenth (phase 13 mines the full one, phase 22 partitions it)
MESH_MSNBC_SCALE = 0.1
# phases 21 and 22: the class partitions of the partitioned mines
PARTITION_PARTS = 2
# phase 26: the replicated service.  Its replicas' configs, logs, launch
# counts and FILE sources go under build/smoke/replica/
ROOT = os.path.dirname(os.path.abspath(__file__))
REPLICA_DIR = os.path.join(ROOT, "build", "smoke", "replica")
REPLICA_TTL_S = 2.0
REPLICA_RECOVER_S = 0.5
# the per-save delay armed on replica A, whose first frontier save must
# come after B has stolen both fillers (one heartbeat, a third of the TTL)
REPLICA_SAVE_DELAY_S = 4.0
# the longest any one wait of phase 26 may take before the phase fails
REPLICA_WAIT_S = 240.0
# phase 27: faults and bitrot.  Its replicas' configs, logs and counts go
# under build/smoke/bitrot/.  The checkpointed drill takes the classic
# route at BITROT_NODE_BATCH nodes a batch, which saves a delta chunk a
# batch (BMS-WebView-2 on the queue route saves one snapshot, inline in
# the meta, so it has no delta chunk to rot), and is killed once
# BITROT_CHUNKS have landed
BITROT_DIR = os.path.join(ROOT, "build", "smoke", "bitrot")
BITROT_SCRUB_S = 0.5
BITROT_NODE_BATCH = 256
BITROT_CHUNKS = 2
# phase 28: the planes at size.  Its child's config, log, counts and FILE
# sources go under build/smoke/planes/.  The coalesced pair mines the 1 %
# database (a cache entry is keyed by the dataset and the algorithm, so a
# pair on the tenth would replace the cold job's entry and its repeat
# would no longer be an exact hit); the dominated TSR serve asks a smaller
# k, the dominated SPADE serve twice phase 5's relative minsup
PLANES_DIR = os.path.join(ROOT, "build", "smoke", "planes")
PLANES_DOM_K = 50
PLANES_DOM_MINSUP = 0.002
# phase 29: the elastic fleet.  Its replicas' configs, logs, counts and
# FILE source go under build/smoke/fleet/.  The storm's second job
# template mines phase 5's database at phase 28's dominated minsup
FLEET_DIR = os.path.join(ROOT, "build", "smoke", "fleet")
FLEET_DOM_MINSUP = PLANES_DOM_MINSUP
FLEET_STORM_SEED = 7001
# phase 30: the sources, the remote entry and the stream consumer.  Its
# child's files go under build/smoke/sources/; the poison record rides
# the fourth poll
SOURCES_DIR = os.path.join(ROOT, "build", "smoke", "sources")
SOURCES_ES_PAGE = 10000
STREAM_POISON_POLL = 3


T_START = time.perf_counter()


def clock(phase: int) -> None:
    """One line as each phase of the whole run begins: the seconds since
    the script started, so the log shows where the run's wall goes."""
    print(f"[clock] phase {phase} begins at "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)


def digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _timed_kernel(torch, fn, sink: list):
    """``fn`` (a kernel's wrapper) with CUDA events recorded around each
    call on the current stream; the wrapper's own launch count moves to
    this function's ``launches``, which the wrapper increments."""
    def timed(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        sink.append((a, b))
        return out
    timed.launches = 0
    return timed


def mesh_rank(mesh, plan: dict) -> dict:
    """Phase 21's mines on one mesh rank (run by ``spawn_world``): each
    answer's digest, route, B1/B2/B3 launches and kernel ms, all-reduces
    and their time, and wall; the rank's peak memory."""
    import torch

    from spark_fsm_tpu_torch.data.synth import (
        gazelle_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import maxstart_masks as MM
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    kernels = (("b1", PS, "pair_supports"), ("b2", RS, "rule_supports"),
               ("b3", EP, "extend_count_prune"),
               ("masks", MM, "window_masks"))
    sinks = {key: [] for key, _, _ in kernels}
    for key, mod, name in kernels:
        setattr(mod, name, _timed_kernel(torch, getattr(mod, name),
                                         sinks[key]))
    batches = support_batches()
    # co-located ranks split the one-device pool budget
    pool = auto_pool_bytes(mesh.device) // plan["ranks_on_card"]
    out = {"rank": mesh.rank, "gen_s": {}, "mines": {}}
    # the first collective sets the communicator up: not a mine's
    all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=mesh.device),
                   mesh)

    def run(label, fn):
        for key, mod, name in kernels:
            sinks[key].clear()
            getattr(mod, name).launches = 0
        batches.calls = 0
        mesh.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        text, stats = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        red = mesh.reduce_stats()
        out["mines"][label] = {
            "digest": digest(text), "wall_s": wall,
            "fused": stats.get("fused"), "resident": stats.get("resident"),
            "route": (f"fused={stats['fused']!r}" if "fused" in stats else
                      f"resident={bool(stats.get('resident'))}"
                      if label == "tsr" else stats.get("route", "-")),
            "launches": {key: getattr(mod, name).launches
                         for key, mod, name in kernels},
            "batches": batches.calls,
            "kernel_ms": {key: sum(a.elapsed_time(b) for a, b in sinks[key])
                          for key in sinks},
            "all_reduces": red["all_reduces"],
            "all_reduce_ms": red["all_reduce_ms"],
            "waves": stats.get("waves"), "evaluated": stats.get("evaluated"),
            "exchanges": stats.get("partition_exchanges"),
            "cross_bytes": stats.get("partition_cross_bytes"),
            "rounds": stats.get("deepening_rounds"),
            "peak": torch.cuda.max_memory_allocated(mesh.device),
        }

    def gen(name, make):
        t0 = time.perf_counter()
        db = make()
        out["gen_s"][name] = time.perf_counter() - t0
        return db

    db = plan["bms_db"]   # phase 5's database (its generator is slow)
    minsup = abs_minsup(0.001, len(db))
    for fused in ("auto", "never"):
        def spade(fused=fused):
            st: dict = {}
            extra = {"pool_bytes": pool} if fused == "never" else {}
            res = mine_spade_torch(db, minsup, mesh=mesh, fused=fused,
                                   stats_out=st, **extra)
            return patterns_text(res), st
        run(f"spade {fused}", spade)
    # class partitions: one row a rank on an even world; a 1-rank world
    # cannot hold two rows and must refuse
    parts = PARTITION_PARTS if mesh.size % PARTITION_PARTS == 0 else 0
    if mesh.size == 1:
        try:
            mine_spade_torch(db, minsup, mesh=mesh,
                             partition_parts=PARTITION_PARTS)
        except ValueError as exc:
            out["refused"] = str(exc)
    if parts:
        def spade_part():
            st: dict = {}
            res = mine_spade_torch(db, minsup, mesh=mesh,
                                   partition_parts=parts, stats_out=st)
            return patterns_text(res), st
        run("part spade auto", spade_part)
    db = gen("msnbc", lambda: msnbc_like(scale=MESH_MSNBC_SCALE, fast=True))
    minsup = abs_minsup(0.005, len(db))

    def spam(**kw):
        st: dict = {}
        res = mine_spam_torch(db, minsup, mesh=mesh, pool_bytes=pool,
                              stats_out=st, **kw)
        return patterns_text(res), st
    run("spam", spam)
    if parts:
        run("part spam", lambda: spam(partition_parts=parts))
    per = len(db) // plan["stream_pushes"]
    inc = IncrementalWindowMiner(plan["stream_minsup"],
                                 max_batches=plan["stream_keep"], mesh=mesh)
    for push in range(1, MESH_STREAM_PUSHES + 1):
        batch = db[(push - 1) * per:push * per]
        run(f"stream push {push}",
            lambda batch=batch: (patterns_text(inc.push(batch)), inc.stats))
    del inc, db
    db = gen("kosarak", lambda: kosarak_like(scale=MESH_KOSARAK_SCALE,
                                             fast=True))

    def tsr(**kw):
        st: dict = {}
        res = mine_tsr_torch(db, 100, 0.5, max_side=2, mesh=mesh,
                             stats_out=st, **kw)
        return rules_text(res), st
    run("tsr", tsr)
    if parts:
        run("part tsr", lambda: tsr(partition_parts=parts))
    db = gen("gazelle", lambda: gazelle_like(scale=1.0, fast=True))
    minsup = abs_minsup(0.005, len(db))

    def cspade():
        st: dict = {}
        res = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                                mesh=mesh, pool_bytes=pool, stats_out=st)
        return patterns_text(res), st
    run("cspade", cspade)
    out["peak"] = max(rec["peak"] for rec in out["mines"].values())
    return out


def _msnbc_tenth_texts(torch) -> dict:
    """One-device mines of the mesh worlds' tenth of phase 13's database:
    SPAM's digest and the first pushes' digests of phase 17's stream cut
    the same way, with their walls."""
    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    db = msnbc_like(scale=MESH_MSNBC_SCALE, fast=True)
    minsup = abs_minsup(0.005, len(db))
    out = {"want": {}, "walls": {}}
    t0 = time.perf_counter()
    got = mine_spam_torch(db, minsup)
    torch.cuda.synchronize()
    out["walls"]["spam"] = (round(time.perf_counter() - t0, 3),)
    out["want"]["spam"] = digest(patterns_text(got))
    per = len(db) // STREAM_PUSHES
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    for push in range(1, MESH_STREAM_PUSHES + 1):
        t0 = time.perf_counter()
        got = inc.push(db[(push - 1) * per:push * per])
        torch.cuda.synchronize()
        out["walls"][f"stream push {push}"] = (
            round(time.perf_counter() - t0, 3),)
        out["want"][f"stream push {push}"] = digest(patterns_text(got))
    print(f"[mesh] msnbc_like(scale={MESH_MSNBC_SCALE}) on one device "
          f"for the worlds: SPAM and {MESH_STREAM_PUSHES} pushes, walls "
          f"{out['walls']}", flush=True)
    return out


def mesh_phase(torch, want: dict, single_walls: dict, card: str,
               bms_db, tenth: dict) -> dict:
    """Phase 21: both mesh worlds on the card, every rank's answers held
    against the earlier phases' digests ``want``; the ranks get phase 5's
    database ``bms_db`` and make the others.  The one-device mine of the
    tenth of phase 9's database is also held against its plain route,
    and ``tenth`` gets (database, serialization, wall) for phase 25.
    Returns the mesh path's B1 and B2 launches (rank 0 of each world)."""
    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel.launch import spawn_world
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    t_phase = time.perf_counter()
    db = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    b2 = RS.rule_supports.launches
    t0 = time.perf_counter()
    rules = mine_tsr_torch(db, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    wall = round(time.perf_counter() - t0, 3)
    b2 = RS.rule_supports.launches - b2
    text = rules_text(rules)
    t0 = time.perf_counter()
    plain = rules_text(mine_tsr_torch(db, 100, 0.5, max_side=2,
                                      use_kernel=False))
    torch.cuda.synchronize()
    check(plain == text, "the tenth's TSR mine through the kernel differs "
          "from the plain evaluator's")
    print(f"[mesh] kosarak_like(scale={MESH_KOSARAK_SCALE}) TSR on one "
          f"device: {len(rules)} rules byte-identical to the plain "
          f"evaluator's mine; {wall} s, plain route "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want = dict(want, tsr=digest(text))
    single_walls = dict(single_walls, tsr=(wall,))
    tenth.update(db=db, payload=SM.serialize_rules(rules), wall=wall,
                 digest=digest(text), b2=b2)
    del db, text, rules, plain
    small = _msnbc_tenth_texts(torch)
    want = dict(want, **small["want"])
    single_walls = dict(single_walls, **small["walls"])
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    launched = {}
    for backend, ranks in MESH_WORLDS:
        plan = {"ranks_on_card": ranks, "stream_pushes": STREAM_PUSHES,
                "stream_keep": STREAM_KEEP, "stream_minsup": STREAM_MINSUP,
                "bms_db": bms_db}
        t0 = time.perf_counter()
        res = spawn_world(mesh_rank, ranks, backend, "cuda:0", (plan,),
                          timeout_s=900,
                          threads=max(1, (os.cpu_count() or 1) // ranks))
        world_s = time.perf_counter() - t0
        for r in res:
            for label, rec in r["mines"].items():
                check(rec["digest"] == want[label.removeprefix("part ")],
                      f"{backend} x{ranks} rank {r['rank']}: {label} "
                      f"differs from the one-device oracle text")
                if label.startswith("part "):
                    # one-rank rows: the bare route, no in-row reduce;
                    # the exchange is the one collective
                    check(rec["exchanges"] == (rec["rounds"] if label ==
                                               "part tsr" else 1),
                          f"{backend} x{ranks}: {label} made "
                          f"{rec['exchanges']} exchanges")
                else:
                    check(rec["all_reduces"] > 0,
                          f"{backend} x{ranks}: {label} made no all-reduce")
            if ranks == 1:
                check("does not split into 2 equal" in r.get("refused", ""),
                      f"a 1-rank world at partition_parts=2 did not raise "
                      f"the ValueError: {r.get('refused')!r}")
            else:
                pm = r["mines"]
                check(pm["part spade auto"]["launches"]["b1"] > 0
                      and pm["part spam"]["launches"]["b3"] > 0
                      and pm["part tsr"]["launches"]["b2"] > 0,
                      f"{backend} x{ranks}: partitioned launches "
                      f"{[pm[k]['launches'] for k in pm if k.startswith('part ')]}")
            m = r["mines"]
            check(m["spade auto"]["fused"] == "queue",
                  f"{backend} x{ranks}: auto routed to "
                  f"{m['spade auto']['fused']!r}")
            check(m["spade never"]["fused"] is False,
                  f"{backend} x{ranks}: never did not route classic")
            check(m["spam"]["launches"]["b1"] > 0
                  and m["spam"]["launches"]["b3"] == 0,
                  f"{backend} x{ranks}: SPAM launches {m['spam']['launches']}")
            check(m["tsr"]["launches"]["b2"] > 0 and not m["tsr"]["resident"],
                  f"{backend} x{ranks}: TSR launches {m['tsr']['launches']}, "
                  f"resident {m['tsr']['resident']}")
            # each node batch of the cSPADE shard: one mask launch, one B1
            cs = m["cspade"]
            check(cs["launches"]["masks"] == cs["launches"]["b1"]
                  == cs["batches"] > 0,
                  f"{backend} x{ranks}: cSPADE launches {cs['launches']} "
                  f"over {cs['batches']} node batches with candidates")
            check(all(rec["launches"]["masks"] == 0
                      for label, rec in m.items() if label != "cspade"),
                  f"{backend} x{ranks}: the mask kernel launched outside "
                  f"cSPADE")
        peaks = [r["peak"] for r in res]
        check(sum(peaks) <= total, f"{backend} x{ranks}: the ranks' peaks "
              f"{peaks} exceed the card's {total} B")
        for label in res[0]["mines"]:
            recs = [r["mines"][label] for r in res]
            one = single_walls.get(label.removeprefix("part "))
            launches = [(rec["launches"]["b1"], rec["launches"]["b2"],
                         rec["launches"]["b3"], rec["launches"]["masks"])
                        for rec in recs]
            print(f"[mesh] {backend} x{ranks} {label}: byte-identical to the "
                  f"one-device text on every rank; route {recs[0]['route']}; "
                  f"per rank (B1, B2, B3, masks) launches {launches}, B1 ms "
                  f"{[round(rec['kernel_ms']['b1'], 3) for rec in recs]}, "
                  f"B2 ms {[round(rec['kernel_ms']['b2'], 3) for rec in recs]}, "
                  f"masks ms "
                  f"{[round(rec['kernel_ms']['masks'], 3) for rec in recs]}, "
                  f"all-reduces {[rec['all_reduces'] for rec in recs]} taking "
                  f"{[round(rec['all_reduce_ms'], 3) for rec in recs]} ms; "
                  f"wall {[round(rec['wall_s'], 3) for rec in recs]} s "
                  f"against one device {one} s; peak "
                  f"{[rec['peak'] for rec in recs]} B"
                  + (f"; exchanges {[rec['exchanges'] for rec in recs]} "
                     f"over {recs[0]['rounds']} rounds, bytes "
                     f"{[rec['cross_bytes'] for rec in recs]}"
                     if label.startswith("part ") else ""), flush=True)
        launched[(backend, ranks)] = {
            label: res[0]["mines"][label]["launches"]
            for label in res[0]["mines"]}
        if "part tsr" in res[0]["mines"]:
            tenth["world part tsr"] = [round(r["mines"]["part tsr"]["wall_s"],
                                             3) for r in res]
        if ranks == 1:
            print(f"[mesh] {backend} x1 partition_parts=2 raised: "
                  f"{res[0]['refused']}", flush=True)
        print(f"[mesh] {backend} x{ranks} world: {world_s:.1f} s with spawn "
              f"and data; generators {res[0]['gen_s']}; largest peak per "
              f"rank {peaks} B (sum {sum(peaks)} of {total} B); card {card}",
              flush=True)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


class PartMeter:
    """Phase 22's meter: B1, B2 and B3 wrapped with CUDA events
    (``_timed_kernel``) while it is entered, and each partition's
    stretches of work (a TSR round's slice, a SPADE/SPAM/cSPADE slice)
    timed and charged with the launches, kernel events and candidates
    inside them."""

    def __init__(self, torch, kernels):
        self.torch = torch
        self.kernels = kernels   # ((key, module, wrapper name), ...)
        self.sinks = {key: [] for key, _, _ in kernels}
        self.parts: dict = {}
        self._saved: list = []

    def __enter__(self):
        for key, mod, name in self.kernels:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, _timed_kernel(self.torch, fn, self.sinks[key]))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()

    def reset(self) -> None:
        self.parts = {}
        for key, mod, name in self.kernels:
            self.sinks[key].clear()
            getattr(mod, name).launches = 0

    def launches(self) -> dict:
        return {key: getattr(mod, name).launches
                for key, mod, name in self.kernels}

    def stretch(self, part, work, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` as partition ``part``'s work;
        ``work()`` reads the candidates evaluated so far."""
        self.torch.cuda.synchronize()
        l0, w0 = self.launches(), work()
        i0 = {key: len(v) for key, v in self.sinks.items()}
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.torch.cuda.synchronize()
            rec = self.parts.setdefault(part, {
                "wall_s": 0.0, "work": 0,
                "launches": {key: 0 for key in self.sinks},
                "events": {key: [] for key in self.sinks}})
            rec["wall_s"] += time.perf_counter() - t0
            rec["work"] += work() - w0
            for key, n in self.launches().items():
                rec["launches"][key] += n - l0[key]
                rec["events"][key] += self.sinks[key][i0[key]:]

    def summary(self) -> str:
        out = []
        for p in sorted(self.parts):
            rec = self.parts[p]
            ms = {key: round(sum(a.elapsed_time(b) for a, b in ev), 3)
                  for key, ev in rec["events"].items()}
            out.append(f"part {p}: {rec['wall_s']:.3f} s, evaluated "
                       f"{rec['work']}, ({', '.join(self.sinks)}) launches "
                       f"{tuple(rec['launches'].values())} taking "
                       f"{tuple(ms.values())} ms")
        return "; ".join(out)


class CompositeStore:
    """A checkpoint for the partitioned mines: a snapshot at every chance,
    each kept as a store would hold it (JSON), resuming ``state``."""

    def __init__(self, state=None, every_s: float = 0.0):
        self.state, self.every_s, self.saved = state, every_s, []

    def load(self):
        return self.state

    def save(self, state):
        self.saved.append(json.loads(json.dumps(state)))


def partition_phase(torch, inputs: dict, want: dict, single_walls: dict,
                    card: str, part_walls: dict) -> dict:
    """Phase 22: the partitioned mines of ``inputs`` in this process, each
    held against the earlier phase's digest in ``want``; ``part_walls``
    gets each mine's wall by label.  Returns each kernel's launches on the
    partitioned path."""
    from spark_fsm_tpu_torch.models import tsr as TT
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import maxstart_masks as MM
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.parallel import partition as PN
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    t_phase = time.perf_counter()
    meter = PartMeter(torch, (("b1", PS, "pair_supports"),
                              ("b2", RS, "rule_supports"),
                              ("b3", EP, "extend_count_prune"),
                              ("masks", MM, "window_masks")))
    batches = support_batches()
    launched = {key: 0 for key in meter.sinks}
    orig_round = TT.TsrTorch._mine_restricted
    orig_slices = PN.mine_partitioned_slices

    def tsr_round(self, m, *args, **kwargs):
        part = None if self._partition is None else self._partition[1]
        return meter.stretch(part, lambda: self.stats["evaluated"],
                             orig_round, self, m, *args, **kwargs)

    def slices(*, mine_part, stats=None, **kwargs):
        def metered(p, *args):
            return meter.stretch(p, lambda: stats.get("candidates", 0),
                                 mine_part, p, *args)
        return orig_slices(mine_part=metered, stats=stats, **kwargs)

    def measured(label, fn, want_digest, text_of, unpart, kernel):
        """One partitioned mine: parity, launches, exchanges, peak."""
        meter.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, stats = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        part_walls[label] = round(wall, 3)
        peak = torch.cuda.max_memory_allocated()
        check(digest(text_of(res)) == want_digest,
              f"the partitioned {label} differs from the earlier phase's text")
        n = meter.launches()
        check(n[kernel] > 0, f"the partitioned {label} launched {kernel} "
              f"0 times: {n}")
        for key in launched:
            launched[key] += n[key]
        rounds = stats.get("deepening_rounds", 1)
        check(stats["partition_exchanges"] == rounds,
              f"the partitioned {label}: {stats['partition_exchanges']} "
              f"exchanges for {rounds} rounds")
        print(f"[part] {label}: {len(res)} results byte-identical to the "
              f"earlier phase's text; parts {stats['partition_parts']}, "
              f"imbalance {stats['partition_imbalance']}; "
              f"{meter.summary()}; exchanges {stats['partition_exchanges']} "
              f"({stats['partition_cross_bytes']} B) over {rounds} rounds; "
              f"wall {wall:.3f} s against unpartitioned {unpart} s; peak "
              f"{peak} B; card {card}", flush=True)
        return res, stats

    TT.TsrTorch._mine_restricted = tsr_round
    PN.mine_partitioned_slices = slices
    try:
        with meter:
            # Kosarak-shaped TSR at two parts on phase 9's vertical DB,
            # beside the unpartitioned engine on it
            vdb = inputs["kos_vdb"]
            eng = TT.TsrTorch(vdb, 100, 0.5, max_side=2)
            meter.reset()
            t0 = time.perf_counter()
            one = eng.mine()
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one_b2 = meter.launches()["b2"]
            check(digest(rules_text(one)) == want["tsr"],
                  "the unpartitioned TSR engine on phase 9's DB differs")
            orch = TT.TsrPartitioned(vdb, 100, 0.5, parts=PARTITION_PARTS,
                                     max_side=2)
            _, st = measured(
                "kosarak_like TSR k=100 max_side=2",
                lambda: (orch.mine(), orch.stats), want["tsr"], rules_text,
                round(one_s, 3), "b2")
            print(f"[part] kosarak_like TSR: evaluated {st['evaluated']} "
                  f"partitioned against {eng.stats['evaluated']} "
                  f"unpartitioned (ratio "
                  f"{st['evaluated'] / eng.stats['evaluated']:.3f}); B2 "
                  f"launches {meter.launches()['b2']} partitioned against "
                  f"{one_b2} unpartitioned", flush=True)
            del eng, orch, one
            # the 1 % TSR, max_side=None: resident rows
            db = inputs["tsr_small_db"]
            t0 = time.perf_counter()
            one = rules_text(TT.mine_tsr_torch(db, 100, 0.5, max_side=None))
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            check(digest(one) == want["tsr 1%"], "the 1 % TSR mine differs")

            def small():
                st: dict = {}
                res = TT.mine_tsr_torch(db, 100, 0.5, max_side=None,
                                        partition_parts=PARTITION_PARTS,
                                        stats_out=st)
                return res, st
            _, st = measured("kosarak_like(scale=0.01) TSR max_side=None",
                             small, want["tsr 1%"], rules_text,
                             round(one_s, 3), "b2")
            check(st.get("resident_rounds", 0)
                  == PARTITION_PARTS * st["deepening_rounds"],
                  f"the 1 % partitioned TSR's slices took the resident "
                  f"route {st.get('resident_rounds', 0)} times")
            print(f"[part] kosarak_like(scale=0.01) TSR: resident rounds "
                  f"{st['resident_rounds']}, waves {st['resident_waves']}, "
                  f"evaluated {st['evaluated']}", flush=True)
            # BMS SPADE through the queue slices and the classic ones
            bms, bms_minsup = inputs["bms"]
            for fused in ("auto", "never"):
                def spade(fused=fused):
                    st: dict = {}
                    res = mine_spade_torch(bms, bms_minsup, fused=fused,
                                           partition_parts=PARTITION_PARTS,
                                           stats_out=st)
                    return res, st
                measured(f"bms_webview2_like SPADE fused={fused!r}", spade,
                         want[f"spade {fused}"], patterns_text,
                         single_walls[f"spade {fused}"], "b1")
            # MSNBC SPAM: B3 on each slice
            msnbc, msnbc_minsup = inputs["msnbc"]

            def spam():
                st: dict = {}
                res = mine_spam_torch(msnbc, msnbc_minsup,
                                      partition_parts=PARTITION_PARTS,
                                      stats_out=st)
                return res, st
            measured("msnbc_like SPAM", spam, want["spam"], patterns_text,
                     single_walls["spam"], "b3")
            # Gazelle cSPADE: its supports launch the mask kernel and B1
            gz, gz_minsup = inputs["gazelle"]
            meter.reset()
            batches.calls = 0
            t0 = time.perf_counter()
            cs: dict = {}
            got = mine_cspade_torch(gz, gz_minsup, maxgap=2, maxwindow=5,
                                    partition_parts=PARTITION_PARTS,
                                    stats_out=cs)
            torch.cuda.synchronize()
            cs_s = time.perf_counter() - t0
            check(digest(patterns_text(got)) == want["cspade"],
                  "the partitioned cSPADE mine differs from phase 16's")
            check(cs["partition_exchanges"] == 1, "cSPADE exchanges")
            n = meter.launches()
            check(n["masks"] == n["b1"] == batches.calls > 0,
                  f"the partitioned cSPADE mine: launches {n} over "
                  f"{batches.calls} node batches with candidates")
            print(f"[part] gazelle_like cSPADE: {len(got)} patterns "
                  f"byte-identical to phase 16's text; imbalance "
                  f"{cs['partition_imbalance']}; {meter.summary()}; wall "
                  f"{cs_s:.3f} s against unpartitioned "
                  f"{single_walls['cspade']} s", flush=True)
            # a composite checkpoint of the BMS mine, resumed mid-slice
            store = CompositeStore()
            meter.reset()
            got = mine_spade_torch(bms, bms_minsup,
                                   partition_parts=PARTITION_PARTS,
                                   checkpoint=store)
            check(digest(patterns_text(got)) == want["spade auto"],
                  "the checkpointed partitioned SPADE mine differs")
            mids = [st for st in store.saved
                    if st["partition"]["active_part"] is not None
                    and st["partition"]["active_state"]["stack"]]
            check(bool(mids), "no composite was saved mid-slice")
            mid = mids[len(mids) // 2]
            t0 = time.perf_counter()
            got = mine_spade_torch(bms, bms_minsup,
                                   partition_parts=PARTITION_PARTS,
                                   checkpoint=CompositeStore(mid, 1e9))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            check(digest(patterns_text(got)) == want["spade auto"],
                  "the resumed partitioned SPADE mine differs")
            print(f"[part] bms_webview2_like SPADE checkpointed: "
                  f"{len(store.saved)} composites, {len(mids)} mid-slice; "
                  f"composite {store.saved.index(mid)} (part "
                  f"{mid['partition']['active_part']}, "
                  f"{len(mid['partition']['active_state']['stack'])} live "
                  f"nodes, {len(mid['results'])} done rows) resumed "
                  f"byte-identical in {resume_s:.3f} s", flush=True)
    finally:
        TT.TsrTorch._mine_restricted = orig_round
        PN.mine_partitioned_slices = orig_slices
    print(f"[part] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"on the partitioned path {launched}; tallies {PN.tallies()}",
          flush=True)
    return launched


def start_child(script: str, *args, nice: int = 10) -> subprocess.Popen:
    """A CPU oracle in a child process, niced by default: it runs beside
    the card phases, which are on the smoke's critical path."""
    return subprocess.Popen(
        [sys.executable, "-c", f"import os; os.nice({nice})\n" + script,
         *map(str, args)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)


# cSPADE's copied CPU oracle on the Gazelle-shaped database at a scale,
# run in a child process: its wall first, then the canonical text
CSPADE_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import gazelle_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_cspade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
db = gazelle_like(scale=float(sys.argv[1]), fast=True)
t0 = time.perf_counter()
res = mine_cspade(db, abs_minsup(0.005, len(db)), maxgap=2, maxwindow=5)
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
GAZELLE_SCALES = (1.0, 0.1)
# the copied CPU oracle of phases 5 and 13 (SPADE on the BMS-WebView-2-
# and the MSNBC-shaped databases at their minsup), in child processes
# started at the top: the wall first, then the canonical text
SPADE_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import bms_webview2_like, msnbc_like
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
db = (bms_webview2_like() if sys.argv[1] == "bms"
      else msnbc_like(scale=1.0, fast=True))
t0 = time.perf_counter()
res = mine_spade(db, abs_minsup(float(sys.argv[2]), len(db)))
print(f"{time.perf_counter() - t0:.3f}")
print(patterns_text(res), end="")
"""
SPADE_ORACLES = (("bms", 0.001), ("msnbc", 0.005))
# TSR's copied CPU oracle (mine_tsr_cpu, k=100, minconf 0.5) on the 1 %
# Kosarak-shaped database of phases 10 (max_side 2) and 15 (max_side
# None), in child processes started at the top: the wall first, then the
# canonical rule text
TSR_ORACLE = r"""
import sys, time
from spark_fsm_tpu_torch.data.synth import kosarak_like
from spark_fsm_tpu_torch.models.tsr import mine_tsr_cpu
from spark_fsm_tpu_torch.utils.canonical import rules_text
side = None if sys.argv[1] == "None" else int(sys.argv[1])
db = kosarak_like(scale=0.01, fast=True)
t0 = time.perf_counter()
res = mine_tsr_cpu(db, 100, 0.5, max_side=side)
print(f"{time.perf_counter() - t0:.3f}")
print(rules_text(res), end="")
"""
TSR_ORACLE_SIDES = (2, None)
# phases 5, 9 and 13's full-size databases, made from their seeds in a
# child process started at the top (their generators are pure Python;
# BMS-WebView-2's alone takes about 20 s) and pickled, in the order the
# phases need them, under DATA_DIR; one line a database: its name and
# its generator's wall
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke", "data")
DATA_MAKER = r"""
import os, pickle, sys, time
from spark_fsm_tpu_torch.data.synth import (
    bms_webview2_like, kosarak_like, msnbc_like)
for name, make in (("bms", bms_webview2_like),
                   ("kosarak", lambda: kosarak_like(scale=1.0, fast=True)),
                   ("msnbc", lambda: msnbc_like(scale=1.0, fast=True))):
    t0 = time.perf_counter()
    db = make()
    gen_s = time.perf_counter() - t0
    path = os.path.join(sys.argv[1], name + ".pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(db, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)
    print(name, f"{gen_s:.3f}", flush=True)
"""


def take_made(proc: subprocess.Popen, name: str) -> tuple:
    """The database ``name`` from the DATA_MAKER child, once it has
    announced it (the child makes them in the phases' order): (database,
    the generator's wall in the child)."""
    import pickle

    line = proc.stdout.readline().split()
    check(line[:1] == [name], f"the data child announced {line}, not "
          f"{name} (exit code {proc.poll()})")
    gc.disable()   # millions of fresh tuples: no collection while loading
    try:
        with open(os.path.join(DATA_DIR, f"{name}.pkl"), "rb") as fh:
            return pickle.load(fh), float(line[1])
    finally:
        gc.enable()


def collect_oracle(proc: subprocess.Popen, what: str):
    """An oracle child's (seconds, patterns text); fails if it failed."""
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"the {what} oracle process exited with {proc.returncode}")
    secs, text = out.split("\n", 1)
    return float(secs), text


def check(cond: bool, msg) -> None:
    """Fail the run unless ``cond``.  ``msg`` is the text, or a function
    that makes it: a costly diagnosis (a CPU re-mine to diff against) is
    then made only when the check fails."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: "
                           + (msg() if callable(msg) else msg))


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_words(gen, *shape):
    """Sparse-ish 32-bit words (int32 holding a uint32's bits), with bit
    31 forced on in a tenth of them, made where the torch generator
    ``gen`` lives: on the card, the largest operands take milliseconds
    where numpy took seconds."""
    import torch

    def uniform():
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=gen.device, generator=gen)

    top = torch.rand(shape, device=gen.device, generator=gen) < 0.1
    return (uniform() & uniform() & uniform()) | torch.bitwise_left_shift(
        top.to(torch.int32), 31)


def pair_bound_ms(P: int, NI: int, S: int, W: int, n_live: int = None):
    """Least time for one pair-support launch: each parent row and each
    live item row read once and the [P, NI] output written once, against
    the fewest integer operations the function needs per live pair and
    sequence: one three-input logic op per word (AND folded into the
    running OR, the last one also setting the nonzero predicate) and one
    predicated add, W + 1 in all.  ``n_live`` (default NI) is how many
    leading item rows can be nonzero; the rest are known zero and need no
    work."""
    n_live = NI if n_live is None else n_live
    nbytes = (P + n_live) * S * W * 4 + P * NI * 4
    ops = P * n_live * S * (W + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def extend_bound_ms(P: int, NI: int, S: int, W: int, n_live: int = None):
    """Least time for one extension-count-prune launch: the pair-support
    bound over the live item rows (each read once, W + 1 operations per
    live pair and sequence) with the [P, NI] counts and the [P, NI/32] mask
    words written once.  ``n_live`` (default NI) is how many leading item
    rows can be nonzero; the rest are known zero and need no work."""
    n_live = NI if n_live is None else n_live
    nbytes = (P + n_live) * S * W * 4 + P * NI * 4 + P * (NI // 32) * 4
    ops = P * n_live * S * (W + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def mask_bound_ms(nb: int, S: int, W: int, elem_bytes: int):
    """Least time for one window-mask launch over a batch of ``nb`` nodes:
    both states read once (2 nb S 32 W elements of ``elem_bytes``) and
    both masks written once (2 nb S W words), against one compare, one
    shift and one OR a position."""
    nbytes = 2 * nb * S * 32 * W * elem_bytes + 2 * nb * S * W * 4
    ops = 3 * 2 * nb * S * 32 * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_start_states(gen, nb: int, S: int, n_pos: int, dtype):
    """``[nb, S, n_pos]`` max-start states made where the torch generator
    ``gen`` lives: a start 0..8 positions back where a pattern ends (one
    position in 4), else -1; int8 starts stay at or under 127."""
    import torch

    pos = torch.arange(n_pos, dtype=torch.int16, device=gen.device)
    back = torch.randint(0, 9, (nb, S, n_pos), dtype=torch.int16,
                         device=gen.device, generator=gen)
    start = (pos - back).clamp_(0, 127 if dtype == torch.int8 else n_pos)
    ends = torch.rand((nb, S, n_pos), device=gen.device, generator=gen) < 0.25
    return torch.where(ends, start, -1).to(dtype)


def support_batches():
    """The cSPADE engine's ``_supports`` wrapped, once a process, to count
    its calls (one a node batch with candidates, each launching the window
    -mask kernel once and B1 once); returns the wrapper, whose ``calls``
    the caller resets and reads."""
    from spark_fsm_tpu_torch.models.spade_constrained import (
        ConstrainedSpadeTorch as engine)

    fn = engine._supports
    if hasattr(fn, "calls"):
        return fn

    def counted(self, *args, **kwargs):
        counted.calls += 1
        return fn(self, *args, **kwargs)
    counted.calls = 0
    engine._supports = counted
    return counted


def mask_kernel_step(torch, gen) -> dict:
    """Phase 16's first part: the window-mask kernel bit-equal to its plain
    version on the card, on ragged shapes and at the Gazelle node batch
    (``MASK_BATCH``) for int8 and int16 states and windows None, 0, 3, 5
    and past n_pos; then kernel and plain version timed at that batch
    (int16, maxwindow 5) against the bytes bound.  Returns the kernels
    line's record, ``launches`` left for the mine to fill in."""
    from spark_fsm_tpu_torch.ops import maxstart_masks as MM
    from spark_fsm_tpu_torch.ops import maxstart_torch as MS

    nb, S, W = MASK_BATCH
    worst = 0
    for (n, s, w) in ((5, 1, 1), (5, 1001, 1), (3, 517, 3), (nb, S, 3),
                      (nb, S, W)):
        for dtype in (torch.int8, torch.int16):
            m = max_start_states(gen, n, s, 32 * w, dtype)
            pm = MS.prev_max(m, 2)
            for win in (None, 0, 3, 5, 32 * w + 4):
                got = MM.window_masks(m, pm, win, w)
                want = MM.window_masks_plain(m, pm, win, w)
                bad = int((got != want).sum())
                check(bad == 0, f"window_masks != plain at nb={n} S={s} "
                      f"W={w} {dtype} maxwindow={win}: {bad} words differ")
                worst = max(worst, bad)
            del m, pm, got, want
        print(f"[check] window_masks nb={n} S={s} W={w}, int8 and int16, "
              f"maxwindow None/0/3/5/{32 * w + 4}: equal to plain, bit for "
              f"bit", flush=True)
    m = max_start_states(gen, nb, S, 32 * W, torch.int16)
    pm = MS.prev_max(m, 2)
    ms = launch_ms(lambda: MM.window_masks(m, pm, 5, W), 3, 20)
    plain_ms = time_ms(lambda: MM.window_masks_plain(m, pm, 5, W), 1, 3)
    bound_ms, bound_by = mask_bound_ms(nb, S, W, m.element_size())
    clocks = smi("clocks.sm,power.draw,temperature.gpu")
    print(f"[time] window_masks nb={nb} S={S} W={W} int16 maxwindow 5: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} % of it "
          f"reached), library: none (no single PyTorch call packs a "
          f"compare into words); after timing nvidia-smi sm clock, power, "
          f"temp: {clocks}", flush=True)
    del m, pm
    torch.cuda.empty_cache()
    return {"name": "maxstart_masks", "route": "cuda",
            "source": "spark_fsm_tpu_torch/csrc/maxstart_masks.cu",
            "replaces": "spark_fsm_tpu/models/spade_constrained.py:141 "
                        "(a child state and its windowed support a candidate, "
                        "torch ops; no Pallas kernel)",
            "launches": None, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def rule_ops_per_seq(km: int, W: int) -> int:
    """Fewest int32 operations one candidate needs per sequence.  A
    three-input LOP3 combines three words (n words take ceil((n-1)/2) of
    them) and can set the nonzero predicate of its result in the same
    instruction (the compiled body has LOP3s that write a register and a
    predicate at once).  One word: the X fold, whose last LOP3 also tests
    A (a lone test when km = 1); one shift; the Y fold ANDed with the
    shifted A, km + 1 words, whose last LOP3 tests sup; two predicated
    adds.  W words: each word's X fold; the W A-words ORed, the last LOP3
    testing A; a funnel shift a word; the first word's Y fold with the
    shifted A, and each later word's with the shifted A and the running
    hit (km + 2 words), the last LOP3 testing sup; two predicated adds."""
    def lop3s(n: int) -> int:
        return -(-(n - 1) // 2)

    if W == 1:
        return max(1, lop3s(km)) + 1 + lop3s(km + 1) + 2
    x = W * lop3s(km) + lop3s(W)
    y = lop3s(km + 1) + (W - 1) * lop3s(km + 2)
    return x + W + y + 2


def rule_rows(xy) -> int:
    """Store rows one rule-support launch must read: the distinct prefix
    rows its X slots name plus the distinct suffix rows its Y slots name.
    An unused (-1) slot reads the all-ones pad row, which needs no read."""
    import torch

    return sum(int(torch.unique(xy[:, side][xy[:, side] >= 0]).numel())
               for side in (0, 1))


def rule_bound_ms(xy, S: int, W: int):
    """Least time for one rule-support launch on the candidates ``xy``
    [C, 2, km]: the ``rule_rows`` store rows read once, the candidates
    read and the [2, C] counts written once, against ``rule_ops_per_seq``
    operations per candidate and sequence."""
    C, _, km = xy.shape
    nbytes = rule_rows(xy) * S * W * 4 + C * 2 * km * 4 + 2 * C * 4
    ops = C * S * rule_ops_per_seq(km, W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rule_operands(dev, seed: int, C: int, km: int, M: int, S: int, W: int):
    """Seeded device operands of one rule-support launch: prefix/suffix
    stores [M+1, S*W] with the all-ones pad row M, and [C, 2, km]
    candidates of 1..km distinct rows a side (-1 in the unused slots)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def store():
        w = torch.randint(-2**31, 2**31 - 1, (M + 1, S * W), dtype=torch.int32,
                          device=dev, generator=g)
        for _ in range(2):
            w &= torch.randint(-2**31, 2**31 - 1, w.shape, dtype=torch.int32,
                               device=dev, generator=g)
        w[M] = -1
        return w

    rng = np.random.default_rng(seed)
    xy = np.full((C, 2, km), -1, np.int32)
    sizes = rng.integers(1, km + 1, (C, 2))
    for c in range(C):
        picks = rng.choice(M, sizes[c].sum(), replace=False)
        xy[c, 0, :sizes[c, 0]] = picks[:sizes[c, 0]]
        xy[c, 1, :sizes[c, 1]] = picks[sizes[c, 0]:]
    return store(), store(), torch.from_numpy(xy).to(dev)


def recount_rules(vdb, rules):
    """Every rule's (sup, supx) recounted on the host from the token table,
    by first and last positions per sequence: X => Y holds in a sequence
    iff max over x of first(x) < min over y of last(y).  Independent of
    the bitmaps, the prep and both evaluators."""
    S = vdb.n_sequences
    pos = vdb.tok_word.astype(np.int64) * 32 + np.log2(
        vdb.tok_mask.astype(np.float64)).astype(np.int64)
    starts = np.searchsorted(vdb.tok_item, np.arange(vdb.n_items + 1))
    first, last = {}, {}
    for item in {i for x, y, _, _ in rules for i in x + y}:
        k = int(np.searchsorted(vdb.item_ids, item))
        lo, hi = starts[k], starts[k + 1]
        seq, p = vdb.tok_seq[lo:hi], pos[lo:hi]   # sorted by (seq, pos)
        useq, fi = np.unique(seq, return_index=True)
        li = np.append(fi[1:], len(seq)) - 1      # each run's last token
        f = np.full(S, np.iinfo(np.int64).max)
        f[useq] = p[fi]
        lst = np.full(S, -1)
        lst[useq] = p[li]
        first[item], last[item] = f, lst
    out = []
    for x, y, _, _ in rules:
        fx = np.max([first[i] for i in x], axis=0)
        ly = np.min([last[j] for j in y], axis=0)
        has_x = fx < np.iinfo(np.int64).max
        out.append((x, y, int(np.count_nonzero(has_x & (fx < ly))),
                    int(np.count_nonzero(has_x))))
    return out


def ptxas_usage(log: str) -> list:
    """One entry per compiled kernel from a ``-Xptxas -v`` build log: its
    template arguments, registers and spills."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)I(\w*?)EEv",
                      ln)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
    return out


class SnapshotStore:
    """A checkpoint for ``mine_spade_torch``: nothing to resume, a
    snapshot at every chance (``every_s`` 0), every delta kept."""

    every_s = 0.0

    def __init__(self):
        self.saved = []

    def load(self):
        return None

    def save(self, state):
        self.saved.append(state)

    def merged(self, k: int) -> dict:
        """Snapshot ``k`` with every earlier delta's results merged in, as
        a checkpoint store hands it back."""
        snap = json.loads(json.dumps(self.saved[k]))
        snap["results"] = [r for s in self.saved[:k + 1] for r in s["results"]]
        snap["results_done"] = 0
        return snap


def tokenizer_times(name: str, db, minsup: int, sample: int = 1):
    """``build_vertical``'s wall with the native tokenizer, and both
    tokenizers on the first ``1/sample`` of the database, whose builds
    must agree.  Returns the full build."""
    from spark_fsm_tpu_torch.data import fasttok
    from spark_fsm_tpu_torch.data import vertical as V

    t0 = time.perf_counter()
    full = V.build_vertical(db, min_item_support=minsup)
    first_s = time.perf_counter() - t0
    part = db if sample == 1 else db[:len(db) // sample]
    t0 = time.perf_counter()
    a = full if sample == 1 else V.build_vertical(part,
                                                  min_item_support=minsup)
    part_s = first_s if sample == 1 else time.perf_counter() - t0
    saved = V.tokenize
    V.tokenize = fasttok.flatten_numpy
    try:
        t0 = time.perf_counter()
        b = V.build_vertical(part, min_item_support=minsup)
        numpy_s = time.perf_counter() - t0
    finally:
        V.tokenize = saved
    for f in ("item_ids", "seq_lengths", "item_supports", "tok_item",
              "tok_seq", "tok_word", "tok_mask"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{name}: the two tokenizers' vertical builds differ in {f}")
    print(f"[tok] {name}: build_vertical with the {fasttok.backend()} "
          f"tokenizer {first_s:.3f} s ({len(db)} sequences, "
          f"min_item_support {minsup}); on {len(part)} of them "
          f"{part_s:.3f} s against the numpy flatten's {numpy_s:.3f} s, "
          f"equal builds", flush=True)
    return full


def time_ms(fn, warmup: int, reps: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launch_ms(fn, warmup: int, n: int) -> float:
    """Device time per launch of a short kernel: CUDA events around n
    back-to-back calls queued behind a spinning kernel of about 0.1 s, so
    the wrapper's host work is done before the first of them runs and
    no gap between launches is counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda._sleep(200_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def predict_phase(torch, dev, rule_sets) -> None:
    """Phase 20: each rule set through the artifact cache at the
    ``[predict]`` defaults, its prefixes scored in waves of each width
    against ``predict_host``, timed, and sent through the broker."""
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops import rule_trie as RT
    from spark_fsm_tpu_torch.profile_mine import (
        PREDICT_M, PREDICT_WAVES, depth_groups, timed_wave, wave_summary)
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service import predictor as PR

    PR.configure({})   # the [predict] defaults
    cfg = dict(PR._cfg)
    t_phase = time.perf_counter()
    PS.pair_supports.launches = 0
    RS.rule_supports.launches = 0
    EP.extend_count_prune.launches = 0
    for name, kind, payload, prefixes in rule_sets:
        rules = (RT.rules_from_patterns(SM.deserialize_patterns(payload))
                 if kind == "patterns" else SM.deserialize_rules(payload))
        digest = RT.rules_digest(payload)
        want = [json.dumps(RT.predict_host(rules, p, PREDICT_M),
                           sort_keys=True) for p in prefixes]
        groups = depth_groups(prefixes, cfg["depth_floor"])
        tries = {d: PR._cache(dev).get_or_build(digest, d, lambda: rules,
                                                cfg["lanes_floor"])
                 for d in groups}

        def same(part, rows):
            return [prefixes[i] for i, r in zip(part, rows)
                    if json.dumps(r, sort_keys=True) != want[i]]

        # every row through score_wave, in waves of each width
        for W in PREDICT_WAVES:
            for d, idx in groups.items():
                for k in range(0, len(idx), W):
                    part = idx[k:k + W]
                    bad = same(part, RT.score_wave(
                        tries[d], [prefixes[i] for i in part], PREDICT_M))
                    check(not bad, f"{name}: score_wave at W={W} D={d} "
                          f"differs from predict_host at prefix {bad[:1]}")
        # the stages timed at the depth floor's artifact (the bulk)
        depth, idx = next(iter(groups.items()))
        trie = tries[depth]
        timing = {}
        for W in PREDICT_WAVES:
            timed_wave(trie, [prefixes[i] for i in idx[:W]], PREDICT_M)
            recs = []
            for k in range(0, len(idx), W):
                part = idx[k:k + W]
                rows, rec = timed_wave(trie, [prefixes[i] for i in part],
                                       PREDICT_M)
                check(not same(part, rows), f"{name}: the timed wave differs")
                recs.append(rec)
            timing[W] = wave_summary(recs)
        # the widest wave's peak on the deepest artifact
        deep_d = max(tries)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        RT.score_wave(tries[deep_d], [prefixes[i] for i in groups[deep_d][:64]],
                      PREDICT_M, wave_pad=64)
        torch.cuda.synchronize()
        wave_peak = torch.cuda.max_memory_allocated() - base
        stages = "; ".join(
            f"W={W}: device {t['device_ms']['median']:.4f} / "
            f"{t['device_ms']['p99']:.4f} ms, wall "
            f"{1e3 * t['wall_s']['median']:.4f} / "
            f"{1e3 * t['wall_s']['p99']:.4f} ms (pack "
            f"{1e3 * t['pack_s']['median']:.4f}, score "
            f"{1e3 * t['score_s']['median']:.4f}, decode "
            f"{1e3 * t['decode_s']['median']:.4f} ms)"
            for W, t in timing.items())
        print(f"[predict] {name}: {len(rules)} rules, lanes {trie.lanes}, F "
              f"{trie.F}, D {sorted(tries)} (prefixes a depth "
              f"{ {d: len(v) for d, v in groups.items()} }), nbytes "
              f"{ {d: t.nbytes() for d, t in tries.items()} }; "
              f"{len(prefixes)} prefixes byte-identical to predict_host at "
              f"W = {', '.join(map(str, PREDICT_WAVES))}, m = {PREDICT_M}; "
              f"at D={depth}, median / p99: {stages}; widest wave (W=64, "
              f"D={deep_d}) peak {wave_peak} B over {base} B allocated",
              flush=True)

        # the broker: clients in threads, the window on
        broker = PR.PredictBroker()
        before = dict(PR._stats)
        reqs = [idx[r % len(idx)] for r in range(PREDICT_REQUESTS)]
        tickets, errors = [None] * len(reqs), []

        def client(c):
            try:
                for r in range(c, len(reqs), PREDICT_THREADS):
                    tickets[r] = broker.submit(trie, prefixes[reqs[r]],
                                               PREDICT_M, "normal",
                                               tag=f"client{c}")
            except Exception as exc:   # reported by the check below
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        broker_s = time.perf_counter() - t0
        broker.shutdown()
        check(not errors, f"{name}: broker clients failed: {errors[:2]}")
        check(all(json.dumps(t.entries, sort_keys=True) == want[i]
                  for t, i in zip(tickets, reqs)),
              f"{name}: a broker answer differs from predict_host")
        d = {k: PR._stats[k] - before[k]
             for k in ("waves", "fused_waves", "fused_jobs", "solo_jobs")}
        share = d["fused_jobs"] / (d["fused_jobs"] + d["solo_jobs"])
        check(share > 0, f"{name}: no request rode a fused wave: {d}")
        waits = sorted(1e3 * (t.dispatch_t - t.submit_t) for t in tickets)
        print(f"[predict] {name} broker: {len(reqs)} requests from "
              f"{PREDICT_THREADS} threads, window {cfg['window_ms']} ms, "
              f"max_wave {cfg['max_wave']}: {d['waves']} waves "
              f"({d['fused_waves']} fused), fused share {share:.4f}, "
              f"{broker_s:.4f} s ({len(reqs) / broker_s:.1f} requests/s), "
              f"window wait median {statistics.median(waits):.4f} ms, "
              f"answers equal predict_host", flush=True)
    launched = (PS.pair_supports.launches, RS.rule_supports.launches,
                EP.extend_count_prune.launches)
    check(launched == (0, 0, 0),
          f"the prediction path launched a hand kernel: {launched}")
    print(f"[predict] B1, B2, B3 launches on the path {launched}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _http(port: int, endpoint: str, **params) -> dict:
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{endpoint}"
    data = urllib.parse.urlencode(params).encode()
    with urllib.request.urlopen(url, data=data, timeout=600) as resp:
        return json.loads(resp.read().decode())


def service_phase(torch, card: str, jobs: list, predict_sets: dict) -> None:
    """Phase 23: the port's service on the card, over HTTP.  ``jobs``:
    ``(name, db, params, get kind, the library result's serialization,
    the library walls (cold, warm), the kernel whose launches must rise:
    ``"masks"`` for cSPADE, whose supports launch the window-mask kernel
    and B1 once each a node batch)`` in the order they are sent; a
    ``None`` serialization repeats the previous job, which the engine cache
    must answer."""
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import maxstart_masks as MM
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops.rule_trie import (predict_host,
                                                   rules_from_patterns)
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service import sources
    from spark_fsm_tpu_torch.service.app import serve_background

    counters = {"b1": PS.pair_supports, "b2": RS.rule_supports,
                "b3": EP.extend_count_prune, "masks": MM.window_masks}
    batches = support_batches()
    dbs = {name: db for name, db, *_ in jobs}
    sources.register("SMOKE", lambda req, store: dbs[req.param("db")])
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = serve_background()   # no device given: the service takes cuda
    port = srv.server_port
    job_launches = {}
    try:
        payloads = {}
        for i, (name, db, params, get, want, lib_walls, kernel) in \
                enumerate(jobs):
            uid = f"smoke-{i}-{name}"
            for fn in counters.values():
                fn.launches = 0
            batches.calls = 0
            t0 = time.perf_counter()
            r = _http(port, "/train", uid=uid, source="SMOKE", db=name,
                      **params)
            check(r["status"] == "started", f"/train {name}: {r}")
            while True:
                st = _http(port, f"/status/{uid}")
                if st["status"] in ("finished", "failure"):
                    break
                time.sleep(0.005)
            wall_s = time.perf_counter() - t0
            check(st["status"] == "finished",
                  f"service job {name} failed: {st['data'].get('error')}")
            launches = {k: fn.launches for k, fn in counters.items()}
            job_launches.setdefault(name, launches)
            stats = json.loads(st["data"]["stats"])
            body = _http(port, f"/get/{get}", uid=uid)["data"][get]
            if want is None:   # the repeat: the cache answers it
                want = payloads[name]
                check(stats.get("store_cache_hit") is True,
                      f"the repeat {name} request missed the engine cache")
            check(digest(body) == digest(want),
                  f"/get/{get} of {name} differs from the library result "
                  f"by SHA-256")
            payloads[name] = body
            check(kernel is None or launches[kernel] > 0,
                  f"the {name} job launched {kernel} 0 times: {launches}")
            check(launches["masks"] == (batches.calls if kernel == "masks"
                                        else 0),
                  f"the {name} job launched the mask kernel "
                  f"{launches['masks']} times over {batches.calls} cSPADE "
                  f"node batches")
            check(kernel != "masks" or launches["b1"] == launches["masks"],
                  f"the {name} job's B1 and mask launches differ: {launches}")
            print(f"[service] {name} {params}: status finished, {get} body "
                  f"SHA-256 {digest(body)[:16]} == library result's; "
                  f"submit-to-finished {wall_s:.3f} s (job mine_s "
                  f"{stats.get('mine_s')}, dataset_s "
                  f"{stats.get('dataset_s')}), library cold/warm "
                  f"{lib_walls} s; route fused={stats.get('fused')!r} "
                  f"resident={stats.get('resident')!r} store_cache_hit="
                  f"{stats.get('store_cache_hit')!r}; launches {launches}; "
                  f"card {card}", flush=True)
        for name, (what, kind, payload, prefixes) in predict_sets.items():
            uid = next(f"smoke-{i}-{n}" for i, (n, *_r) in enumerate(jobs)
                       if n == name)
            rules = (SM.deserialize_rules(payload) if kind == "rules"
                     else rules_from_patterns(SM.deserialize_patterns(payload)))
            lat = []
            for prefix in prefixes:
                t0 = time.perf_counter()
                r = _http(port, "/predict", uid=uid,
                          items=",".join(map(str, prefix)), m="8")
                lat.append(time.perf_counter() - t0)
                check(r["status"] == "finished", f"/predict {name}: {r}")
                got = json.loads(r["data"]["predictions"])
                check(got == predict_host(rules, prefix, 8),
                      f"/predict on {name} differs from predict_host at "
                      f"prefix {prefix}")
            lat_ms = sorted(1e3 * x for x in lat)
            print(f"[service] /predict {what}: {len(prefixes)} prefixes "
                  f"equal to predict_host (m=8); latency median "
                  f"{statistics.median(lat_ms):.3f} ms, first (artifact "
                  f"build) {1e3 * lat[0]:.3f} ms, max {lat_ms[-1]:.3f} ms; "
                  f"card {card}", flush=True)
        admin = _http(port, "/admin/stats")
        check(admin["backend"] == "cuda" and admin["devices"] >= 1,
              f"/admin/stats reports {admin['backend']!r} x{admin['devices']}")
        check(admin["store_cache"]["hits"] >= 1,
              f"/admin/stats store_cache {admin['store_cache']}")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[service] /admin/stats backend {admin['backend']!r} devices "
              f"{admin['devices']}, store_cache {admin['store_cache']}, "
              f"jobs {admin['jobs']}; max_memory_allocated {peak} B; phase "
              f"{time.perf_counter() - t_phase:.1f} s; card {card}",
              flush=True)
    finally:
        srv.master.shutdown()
        srv.shutdown()
        srv.server_close()
        sources.SOURCES.pop("SMOKE", None)
    return job_launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _service_child(name: str, cfg: dict):
    """Boot ``spark_fsm_tpu_torch.service.app`` in a fresh process on the
    card with the boot config ``cfg``; returns (process, port, wall from
    start to the first answered ping, log path).  The prewarm, when the
    config enables it, runs before the server listens, so it is inside
    that wall."""
    import urllib.error

    port = _free_port()
    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = os.path.join(run_dir, f"{name}.json")
    log_path = os.path.join(run_dir, f"{name}.log")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_fsm_tpu_torch.service.app",
             "--config", cfg_path, "--device", "cuda", "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    while True:
        try:
            _http(port, "/admin/ping")
            return proc, port, time.perf_counter() - t0, log_path
        except (urllib.error.URLError, ConnectionError, OSError):
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                proc.kill()
                with open(log_path) as fh:
                    raise RuntimeError(f"service child {name} never answered:"
                                       f"\n{fh.read()[-3000:]}")
            time.sleep(0.05)


def _train_wait(port: int, uid: str, **params) -> tuple:
    """Submit a /train, wait for it; returns (status body, wall s)."""
    t0 = time.perf_counter()
    r = _http(port, "/train", uid=uid, **params)
    check(r["status"] == "started", f"/train {uid}: {r}")
    while True:
        st = _http(port, f"/status/{uid}")
        if st["status"] in ("finished", "failure"):
            break
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    check(st["status"] == "finished",
          f"{uid} failed: {st['data'].get('error')}")
    return st, wall


def warm_phase(torch, card: str, bms: tuple, small: tuple) -> None:
    """Phase 24 (a): a cold and a prewarmed service, each in a fresh
    process.  ``bms``/``small``: (database, /train params, the body's
    library serialization, its get kind, the prewarm envelope)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf

    inline = {name: format_spmf(job[0]) for name, job in
              (("bms", bms), ("small", small))}
    t_phase = time.perf_counter()
    for name, prewarmed in (("cold", False), ("prewarmed", True)):
        cfg = {"prewarm": dict(bms[4], enabled=True)} if prewarmed else {}
        proc, port, boot_s, log_path = _service_child(f"warm-{name}", cfg)
        try:
            line = [f"[warm] {name} child: boot (process start to the "
                    f"first answered ping) {boot_s:.3f} s"]
            enums = []

            def report(what: str, rep: dict) -> None:
                bad = [r for r in rep["keys"] if "error" in r]
                check(not bad, f"prewarm ({what}) rows with error: {bad}")
                kinds: dict = {}
                for r in rep["keys"]:
                    n, w = kinds.get(r["kind"], (0, 0.0))
                    kinds[r["kind"]] = (n + 1, round(w + r["wall_s"], 3))
                line.append(
                    f"prewarm ({what}) {len(rep['keys'])} keys in "
                    f"{rep['total_wall_s']} s, builds+first loads "
                    f"{sum(r['fresh_compiles'] for r in rep['keys'])} "
                    f"({round(sum(r['compile_s'] for r in rep['keys']), 3)}"
                    f" s), by kind (keys, wall s) {kinds}")
                enums.append(rep.get("enumerated") or _http(
                    port, "/admin/shapes")["enumerated"])
                tag = "boot" if what == "boot" else "admin"
                with open(os.path.join(os.path.dirname(os.path.abspath(
                        __file__)), "build", "smoke", f"prewarm_{tag}.json"),
                          "w") as fh:
                    json.dump(rep, fh, indent=1)

            if prewarmed:
                boot = _http(port, "/admin/stats")["prewarm"]
                check(boot is not None, "the boot prewarm left no report")
                report("boot", boot)
            for job_name, (db, params, want, get, _env) in (("bms", bms),
                                                          ("small", small)):
                if prewarmed and job_name == "small":
                    report("/admin/prewarm", _http(
                        port, "/admin/prewarm",
                        **{k: str(int(v)) for k, v in small[4].items()}))
                st, wall = _train_wait(port, f"{name}-{job_name}",
                                       source="INLINE",
                                       sequences=inline[job_name], **params)
                body = _http(port, f"/get/{get}",
                             uid=f"{name}-{job_name}")["data"][get]
                check(digest(body) == digest(want),
                      f"{name} child's {job_name} body differs from the "
                      f"library result by SHA-256")
                stats = json.loads(st["data"]["stats"])
                line.append(f"first {job_name} job {wall:.3f} s (mine_s "
                            f"{stats.get('mine_s')}, route fused="
                            f"{stats.get('fused')!r} resident="
                            f"{stats.get('resident')!r})")
                if prewarmed:
                    shp = _http(port, "/admin/shapes")
                    if job_name == "bms":
                        drift = shp["drift"]
                        check(shp["enumerated"] == enums[0],
                              "/admin/shapes lost the boot enumeration")
                    else:
                        known = set(enums[0]) | set(enums[1])
                        drift = sorted(k for k in shp["recorded"]
                                       if k not in known)
                    check(drift == [], f"drift after the {job_name} job: "
                          f"{drift}")
                    line.append(f"drift after it {drift}")
            print("; ".join(line) + f"; card {card}", flush=True)
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    print(f"[warm] phase (a) {time.perf_counter() - t_phase:.1f} s; child "
          f"logs and the prewarm reports (prewarm_*.json) under "
          f"build/smoke/", flush=True)


def _fused_pair(torch, port: int, broker, uids: tuple, params: dict,
                want: str) -> tuple:
    """Two TSR /train jobs on the SMOKE source at once, their first waves
    held in the broker's window until both jobs have a wave pending;
    returns (release-to-both-finished wall, broker stats delta, cross-job
    launches of the registry, B2 launches)."""
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import fusion as FZ

    def cross() -> float:
        return sum(v for _, key, v in FZ._LAUNCHES_TOTAL.samples()
                   if dict(key).get("cross_job") == "true")

    def pending_jobs() -> set:
        with broker._cond:
            return {w.uid for g in broker._groups.values() for w in g.waves}

    broker.hold()
    stats0, cross0 = dict(broker.stats), cross()
    for uid in uids:
        r = _http(port, "/train", uid=uid, source="SMOKE", algorithm="TSR_TPU",
                  **params)
        check(r["status"] == "started", f"/train {uid}: {r}")
    t_wait = time.perf_counter()
    while not set(uids) <= pending_jobs():
        check(time.perf_counter() - t_wait < 300,
              f"the jobs {uids} never had waves in one window")
        time.sleep(0.01)
    RS.rule_supports.launches = 0
    t0 = time.perf_counter()
    broker.release()
    for uid in uids:
        while _http(port, f"/status/{uid}")["status"] not in (
                "finished", "failure"):
            time.sleep(0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b2 = RS.rule_supports.launches
    for uid in uids:
        st = _http(port, f"/status/{uid}")
        check(st["status"] == "finished",
              f"{uid} failed: {st['data'].get('error')}")
        body = _http(port, "/get/rules", uid=uid)["data"]["rules"]
        check(digest(body) == digest(want),
              f"/get/rules of {uid} differs from the library result by "
              f"SHA-256")
    delta = {k: v - stats0.get(k, 0) for k, v in broker.stats.items()
             if v != stats0.get(k, 0)}
    return wall, delta, int(cross() - cross0), b2


def _b2_on(torch, p1, s1, rows: int, C: int, km: int, seed: int):
    """B2 against its plain version on a store, candidates over its first
    ``rows`` rows with unused (-1) slots; returns (max abs err, the
    candidates)."""
    from spark_fsm_tpu_torch.ops import rule_support as RS

    rng = np.random.default_rng(seed)
    xy = rng.integers(0, rows, size=(C, 2, km)).astype(np.int32)
    xy[rng.random(xy.shape) < 0.25] = -1
    xy[:, :, 0] = rng.integers(0, rows, size=(C, 2))
    xy_t = torch.from_numpy(xy).to(p1.device)
    got = RS.rule_supports(p1, s1, xy_t)
    want = RS.rule_supports_plain(p1, s1, xy_t)
    torch.cuda.synchronize()
    return int((got.long() - want.long()).abs().max()), xy_t


def fusion_phase(torch, card: str, kos_db, kos_vdb, kos_payload: str,
                 kos_digest: str, ms_db, ms_payload: str,
                 solo_b2: int, headline: tuple) -> None:
    """Phase 24 (b) and (c).  The fused pairs mine tenths, as phase 21's
    worlds do (at full size each job spent most of its wall building its
    vertical DB): ``kos_db``, ``kos_payload`` and ``solo_b2`` are phase
    21's tenth of the Kosarak-shaped database, its library result's
    serialization and that mine's B2 launches; ``ms_*`` a tenth of phase
    13's MSNBC-shaped database and its TSR library result (k=100, minconf
    0.5, ``max_side=2``).  ``kos_vdb`` and ``kos_digest``: phase 9's
    full-size vertical DB and the SHA-256 of its rule text, for the
    full-size fused store and the OOM drill on the kernel path;
    ``headline``: (C, km) of phase 8's headline launch."""
    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.models.tsr import TsrTorch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import fusion as FZ
    from spark_fsm_tpu_torch.service import sources
    from spark_fsm_tpu_torch.service.app import make_server
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    saved = TC.get_config()
    fuse = FZ._fuse_preps
    kept: list = []

    def keep_last(uniq, m_pad, total_m):
        out = fuse(uniq, m_pad, total_m)
        kept[:] = [out, total_m]
        return out

    t_phase = time.perf_counter()
    dbs = {"kosarak": kos_db, "msnbc": ms_db}
    TC.set_config(TC.parse_config({"fusion": {"enabled": True,
                                              "window_ms": 20.0}}))
    FZ._fuse_preps = keep_last
    sources.register("SMOKE", lambda req, store: dbs[req.param("db")])
    srv = make_server(0, miner_workers=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    C, km = headline
    try:
        b = FZ.broker()
        tsr = dict(k="100", minconf="0.5", max_side="2")
        # (b) the full-size pair: the cost model decides every group
        wall, delta, cross, b2 = _fused_pair(
            torch, srv.server_port, b, ("fuse-a", "fuse-b"),
            dict(tsr, db="kosarak"), kos_payload)
        print(f"[fusion] two kosarak_like(scale={MESH_KOSARAK_SCALE}) TSR "
              f"jobs at once (k=100, minconf 0.5, max_side=2), both bodies "
              f"equal phase 21's library result by SHA-256; "
              f"release-to-both-finished {wall:.3f} s; broker {delta}; "
              f"cross-job launches {cross}; B2 launches {b2} against the "
              f"library mine's {solo_b2}; card {card}", flush=True)
        # the MSNBC-shaped pair: 17 items, so a wave's candidates leave
        # its launches part-filled and the cost model fuses
        kept.clear()
        wall, delta, cross, b2 = _fused_pair(
            torch, srv.server_port, b, ("fuse-c", "fuse-d"),
            dict(tsr, db="msnbc"), ms_payload)
        check(cross > 0, "no cross-job launch in the MSNBC-shaped pair: "
              "fsm_fusion_launches_total{cross_job=\"true\"} did not rise")
        check(bool(kept), "the broker built no fused store")
        (pf, sf), total_m = kept
        err, _ = _b2_on(torch, pf, sf, total_m, C, km, 24)
        check(err == 0, f"B2 on the broker's fused store != plain (max abs "
              f"err {err})")
        print(f"[fusion] two msnbc_like(scale={MESH_MSNBC_SCALE}) TSR jobs "
              f"at once (k=100, minconf 0.5, max_side=2), both bodies equal "
              f"the library result by "
              f"SHA-256; release-to-both-finished {wall:.3f} s; broker "
              f"{delta}; cross-job launches {cross}; B2 launches {b2}; a "
              f"fused store the broker built (M={pf.shape[0] - 1}, "
              f"{total_m} real rows): B2 equal to plain at C={C} km={km} "
              f"(max abs err {err}); card {card}", flush=True)
        del pf, sf
        kept.clear()
        # (c) the OOM drill on a fused launch: the broker's first launch
        # runs out of memory and halves through the engine's ladder
        with faults.injected("device.oom", nth=1):
            wall, delta, cross, b2 = _fused_pair(
                torch, srv.server_port, b, ("fuse-e", "fuse-f"),
                dict(tsr, db="msnbc"), ms_payload)
        halved = [json.loads(srv.master.store.get(f"fsm:stats:{u}") or "{}")
                  .get("degraded_launches", 0) for u in ("fuse-e", "fuse-f")]
        check(cross > 0 and min(halved) >= 1,
              f"the OOM on the first fused launch halved no cross-job "
              f"launch: cross-job launches {cross}, degraded_launches "
              f"{halved}")
        print(f"[fusion] OOM drill on a fused launch: device.oom injected on "
              f"the broker's first launch of the msnbc_like(scale="
              f"{MESH_MSNBC_SCALE}) pair; "
              f"degraded_launches {halved}, cross-job launches {cross}, both "
              f"bodies equal the library result by SHA-256; "
              f"release-to-both-finished {wall:.3f} s; broker {delta}; B2 "
              f"launches {b2}; card {card}", flush=True)
    finally:
        FZ._fuse_preps = fuse
        srv.master.shutdown()
        srv.shutdown()
        srv.server_close()
        sources.SOURCES.pop("SMOKE", None)
        TC.set_config(saved)
    torch.cuda.empty_cache()

    # a full-size fused store laid out as the broker lays one out (two
    # engines' first-round stores), B2 on it against the solo store
    engines = [TsrTorch(kos_vdb, 100, 0.5, max_side=2) for _ in range(2)]
    m = min(engines[0].item_cap, kos_vdb.n_items)
    preps = [e._prep(m) for e in engines]
    pf, sf = fuse(preps, 1 << (2 * m - 1).bit_length(), 2 * m)
    err, xy_t = _b2_on(torch, pf, sf, 2 * m, C, km, 25)
    check(err == 0, f"B2 on the full-size fused store != plain (max abs "
          f"err {err})")
    p1, s1 = preps[0]
    xy_solo = torch.where(xy_t >= 0, xy_t % m, -1).to(torch.int32)
    fused_ms = time_ms(lambda: RS.rule_supports(pf, sf, xy_t), 2, 10)
    solo_ms = time_ms(lambda: RS.rule_supports(p1, s1, xy_solo), 2, 10)
    M = pf.shape[0] - 1
    S = kos_vdb.n_sequences
    fbound, fby = rule_bound_ms(xy_t, S, 1)
    sbound, sby = rule_bound_ms(xy_solo, S, 1)
    print(f"[fusion] full-size fused store (two first-round stores, M={M}, "
          f"{2 * m} real rows): B2 equal to plain at C={C} km={km} (max abs "
          f"err {err}), {fused_ms:.4f} ms on the "
          f"{'staged' if M <= RS.staged_max_rows(km) else 'walk'} path "
          f"(bound {fbound:.4f} ms, {fby}) against {solo_ms:.4f} ms on one "
          f"job's store (M={m}, "
          f"{'staged' if m <= RS.staged_max_rows(km) else 'walk'} path; "
          f"bound {sbound:.4f} ms, {sby}), the same candidates folded onto "
          f"its rows; card {card}", flush=True)
    del engines, preps, pf, sf, p1, s1, xy_t, xy_solo
    torch.cuda.empty_cache()

    # (c) the OOM drill on the kernel path
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=2)
    t0 = time.perf_counter()
    with faults.injected("device.oom", nth=1):
        got_r = eng.mine()
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    check(digest(rules_text(got_r)) == kos_digest,
          "the OOM drill's rules differ from phase 9's")
    check(eng.stats.get("degraded_launches", 0) >= 1,
          f"the injected OOM halved no launch: {eng.stats}")
    print(f"[fusion] OOM drill: device.oom injected on the first kernel "
          f"launch of the kosarak_like TSR mine; degraded_launches "
          f"{eng.stats['degraded_launches']}, rules byte-identical to phase "
          f"9's; {drill_s:.3f} s, B2 launches "
          f"{eng.stats['kernel_launches'] - eng.stats['deepening_rounds']}; "
          f"phase (b)+(c) {time.perf_counter() - t_phase:.1f} s; card {card}",
          flush=True)


def world_drill(mesh, plan: dict) -> dict:
    """Phase 25 (b)'s rank side (run by ``spawn_world``): a tenth of phase
    9's Kosarak-shaped TSR at two parts with an injected
    ``device.dispatch`` fault on rank 0's row, under a meshguard of the
    rank's own (``dead_after=1``)."""
    import torch

    from spark_fsm_tpu_torch.config import MeshguardConfig
    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import meshguard as MG
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    db = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
    if mesh.rank == 0:
        faults.arm("device.dispatch", every=1, times=1, match="part0")
    try:
        RS.rule_supports.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        st: dict = {}
        t0 = time.perf_counter()
        res = mine_tsr_torch(db, 100, 0.5, max_side=2, mesh=mesh,
                             partition_parts=plan["parts"], stats_out=st)
        torch.cuda.synchronize()
        return {"digest": digest(rules_text(res)),
                "wall_s": time.perf_counter() - t0,
                "b2": RS.rule_supports.launches,
                "dead": sorted(guard.dead_rows()),
                "epoch": guard.current_epoch(),
                "exchanges": st["partition_exchanges"],
                "rounds": st["deepening_rounds"],
                "peak": torch.cuda.max_memory_allocated(mesh.device)}
    finally:
        faults.disarm()
        MG.reset()


def _adoption_one_process(torch, card: str, inp: dict) -> None:
    """Phase 25 (a): the partitioned TSR and SPADE mines in this process,
    healthy and with partition row 0 killed by an injected fault."""
    from spark_fsm_tpu_torch.config import MeshguardConfig
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import TsrPartitioned
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import meshguard as MG
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    bms, bms_minsup = inp["bms"]

    def tsr():
        orch = TsrPartitioned(inp["kos_vdb"], 100, 0.5,
                              parts=PARTITION_PARTS, max_side=2)
        return rules_text(orch.mine()), orch.stats

    def spade():
        st: dict = {}
        res = mine_spade_torch(bms, bms_minsup,
                               partition_parts=PARTITION_PARTS, stats_out=st)
        return patterns_text(res), st

    # (label, mine, digest, kernel wrapper, its name, the fault's match):
    # TSR's fault sites name their part, the queue engine's do not, so
    # the SPADE drill fails the first dispatch, which is part 0's
    for label, mine, want, fn, name, arm, healthy in (
            ("kosarak_like TSR k=100 max_side=2", tsr, inp["tsr"],
             RS.rule_supports, "B2", {"match": "part0"},
             "kosarak_like TSR k=100 max_side=2"),
            ("bms_webview2_like SPADE minsup 0.1 %", spade, inp["spade"],
             PS.pair_supports, "B1", {},
             "bms_webview2_like SPADE fused='auto'")):
        guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
        faults.arm("device.dispatch", every=1, times=1, **arm)
        try:
            fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            text, st = mine()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            dead, epoch = sorted(guard.dead_rows()), guard.current_epoch()
        finally:
            faults.disarm()
            MG.reset()
        check(digest(text) == want, f"the adopted partitioned {label} "
              "differs from the earlier phase's text")
        check(dead == [0] and epoch == 1,
              f"adopted {label}: dead rows {dead}, epoch {epoch}")
        per_part = {k: v for k, v in st.items()
                    if k.startswith("launches_part")}
        print(f"[meshguard] {label} at {PARTITION_PARTS} parts, row 0 "
              f"killed: byte-identical to the earlier phase's text; dead rows "
              f"{dead}, epoch {epoch}; exchanges {st['partition_exchanges']}; "
              f"{name} launches {fn.launches}"
              f"{' ' + str(per_part) if per_part else ''}; wall {wall:.3f} s "
              f"against the healthy partitioned mine's (phase 22) "
              f"{inp['part walls'].get(healthy, 'not measured')}; "
              f"max_memory_allocated {peak} B; card {card}", flush=True)


def _world_drill_phase(card: str, want: str, healthy) -> None:
    """Phase 25 (b), first half: the adoption drill in a 2-rank gloo world
    whose ranks share the card; ``want``: the one-device rules' digest;
    ``healthy``: phase 21's walls of the same world's healthy mine."""
    from spark_fsm_tpu_torch.parallel.launch import spawn_world

    t0 = time.perf_counter()
    res = spawn_world(world_drill, 2, "gloo", "cuda:0",
                      ({"parts": PARTITION_PARTS},), timeout_s=900,
                      threads=max(1, (os.cpu_count() or 1) // 2))
    world_s = time.perf_counter() - t0
    check(len({rec["digest"] for rec in res}) == 1,
          "the world's adopted TSR differs between the ranks")
    check(res[0]["digest"] == want,
          "the world's adopted TSR differs from the one-device mine")
    for rec in res:
        check(rec["dead"] == [0] and rec["epoch"] == 1,
              f"dead rows {rec['dead']}, epoch {rec['epoch']}")
        check(rec["exchanges"] == rec["rounds"] + 1,
              f"{rec['exchanges']} exchanges over {rec['rounds']} rounds")
    print(f"[world] gloo x2 on the card, kosarak_like(scale="
          f"{MESH_KOSARAK_SCALE}) TSR at {PARTITION_PARTS} parts, rank 0's "
          f"row killed: rules SHA-256 {res[0]['digest'][:16]} equal on both "
          f"ranks and to the one-device mine; dead rows {res[0]['dead']}, "
          f"epoch {res[0]['epoch']}; exchanges "
          f"{[rec['exchanges'] for rec in res]} over {res[0]['rounds']} "
          f"rounds; B2 launches {[rec['b2'] for rec in res]}; walls "
          f"{[round(rec['wall_s'], 3) for rec in res]} s against the healthy "
          f"mine's (phase 21) {healthy or 'not measured'}; peaks "
          f"{[rec['peak'] for rec in res]} B; card {card}", flush=True)
    print(f"[world] the drill's world {world_s:.1f} s (spawn included)",
          flush=True)


def _world_service_boot(inp: dict) -> tuple:
    """Phase 25 (b)'s service with ``[engine] mesh_devices = 2``: its FILE
    sources written, then the service booted through the launcher (two
    ranks sharing the card).  Returns ``_service_child``'s (process,
    port, boot wall, log path) and the sources' paths."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes

    import torch

    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(run_dir, exist_ok=True)
    files = {}
    for name, db in (("bms", inp["bms"][0]), ("kosarak", inp["tenth"][0])):
        files[name] = os.path.join(run_dir, f"{name}.spmf")
        with open(files[name], "w") as fh:
            fh.write(format_spmf(db))
    # co-located ranks split the one-device pool budget, as in phase 21
    pool = auto_pool_bytes(torch.device("cuda", 0)) // 2
    return _service_child("mesh-world", {
        "engine": {"mesh_devices": 2, "pool_bytes": pool}}) + (files,)


def _stop_service(proc: subprocess.Popen):
    """SIGTERM to a service child (rank 0 ends its world), then wait;
    returns the exit code, None if it had to be killed."""
    proc.terminate()
    try:
        return proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return None


def _serve_world(card: str, inp: dict, texts: list, booting) -> None:
    """Phase 25 (b), second half: the service that ``booting`` (a future
    of ``_world_service_boot``, started with the phase) booted takes the
    BMS SPADE and the tenth-of-Kosarak TSR as ``/train`` jobs and the
    stream's first pushes."""
    proc, port, boot_s, log_path, files = booting.result()
    try:
        print(f"[world] service with [engine] mesh_devices = 2 booted "
              f"through the launcher in {boot_s:.3f} s, beside (a) and the "
              f"drill's world (two ranks on the card, gloo; rank 1 binds no "
              f"port)", flush=True)
        for uid, params, get, want, lib_s in (
                ("world-bms", dict(algorithm="SPADE_TPU",
                                   support=str(inp["bms"][1]), source="FILE",
                                   path=files["bms"]),
                 "patterns", inp["spade payload"], inp["spade wall"]),
                ("world-kosarak", dict(algorithm="TSR_TPU", k="100",
                                       minconf="0.5", max_side="2",
                                       source="FILE",
                                       path=files["kosarak"]),
                 "rules", inp["tenth"][1], inp["tenth"][2])):
            st, wall = _train_wait(port, uid, **params)
            body = _http(port, f"/get/{get}", uid=uid)["data"][get]
            check(digest(body) == digest(want),
                  f"/get/{get} of {uid} differs from the library result")
            stats = json.loads(st["data"]["stats"])
            print(f"[world] {uid}: {get} body SHA-256 {digest(body)[:16]} == "
                  f"library result's; submit-to-finished {wall:.3f} s (mine_s "
                  f"{stats.get('mine_s')}) against the library's {lib_s} s; "
                  f"route fused={stats.get('fused')!r}; rank 0's kernel "
                  f"launches {stats.get('kernel_launches')}; card {card}",
                  flush=True)
        admin = _http(port, "/admin/stats")
        check(admin["mesh_devices"] == 2,
              f"/admin/stats mesh_devices {admin['mesh_devices']}")
        for push, text in enumerate(texts[:MESH_STREAM_PUSHES], 1):
            t0 = time.perf_counter()
            r = _http(port, "/stream/world", sequences=text,
                      support=str(STREAM_MINSUP),
                      max_batches=str(STREAM_KEEP), algorithm="SPADE_TPU")
            wall = time.perf_counter() - t0
            check(r["status"] == "finished", f"world push {push}: {r}")
            body = _http(port, "/get/patterns",
                         uid="stream:world")["data"]["patterns"]
            check(digest(body) == inp["stream"][push][0],
                  f"world push {push} differs from phase 17's")
            print(f"[world] stream push {push}: patterns SHA-256 "
                  f"{digest(body)[:16]} == phase 17's; push wall {wall:.3f} s "
                  f"over HTTP against the library's "
                  f"{inp['stream'][push][1]:.3f} s", flush=True)
        print(f"[world] /admin/stats mesh_devices {admin['mesh_devices']}, "
              f"devices {admin['devices']}, backend {admin['backend']!r}",
              flush=True)
    finally:
        rc = _stop_service(proc)
    with open(log_path) as fh:
        log = fh.read()
    check(rc == 0, f"the world service exited with {rc}:\n{log[-2000:]}")
    check("mesh: rank 0 of a world of 2 (gloo)" in log,
          f"the world service did not boot as rank 0:\n{log[-2000:]}")


def _stream_service(torch, card: str, inp: dict, texts: list) -> None:
    """Phase 25 (c): a service in this process booted as ``main`` boots
    one with ``[prewarm]`` at the stream's envelope, taking phase 17's
    stream over HTTP."""
    from spark_fsm_tpu_torch import config as TC
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.service import meshcall, prewarm
    from spark_fsm_tpu_torch.service.app import serve_background
    from spark_fsm_tpu_torch.utils import shapes

    saved = TC.get_config()
    per = inp["stream batch"]
    cfg = TC.parse_config({"prewarm": {
        "enabled": True, "stream_batch_sequences": per,
        "stream_seq_floor": per, "stream_items": inp["stream items"]}})
    TC.set_config(cfg)
    shapes.reset_recorded()   # the fresh service's registry
    srv = None
    try:
        t0 = time.perf_counter()
        report = meshcall.prewarm(prewarm.spec_from_config(cfg.prewarm),
                                  TC.engine_kwargs(
                                      "pool_bytes", "node_batch",
                                      "pipeline_depth", "chunk",
                                      "recompute_chunk"))
        warm_s = time.perf_counter() - t0
        check(not [row for row in report["keys"] if row.get("error")],
              f"a prewarm row failed: {report['keys']}")
        srv = serve_background()
        print(f"[stream-service] boot prewarm at stream_batch_sequences = "
              f"stream_seq_floor = {per}, stream_items = "
              f"{inp['stream items']}: "
              f"{len(report['keys'])} keys in "
              f"{warm_s:.3f} s ({[row['shape_key'] for row in report['keys']]})",
              flush=True)
        walls, launches = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for push, text in enumerate(texts, 1):
            PS.pair_supports.launches = 0
            t0 = time.perf_counter()
            r = _http(srv.server_port, "/stream/msnbc", sequences=text,
                      support=str(STREAM_MINSUP),
                      max_batches=str(STREAM_KEEP), algorithm="SPADE_TPU")
            walls.append(time.perf_counter() - t0)
            launches.append(PS.pair_supports.launches)
            check(r["status"] == "finished", f"stream push {push}: {r}")
            body = _http(srv.server_port, "/get/patterns",
                         uid="stream:msnbc")["data"]["patterns"]
            check(digest(body) == inp["stream"][push][0],
                  f"service push {push} differs from phase 17's")
            # the first push finds no tracked tree to sweep (phase 17)
            check((launches[-1] > 0) == (push > 1),
                  f"push {push} launched B1 {launches[-1]} times")
        peak = torch.cuda.max_memory_allocated()
        st = _http(srv.server_port, "/status/stream:msnbc")
        route = json.loads(st["data"]["stats"])["route"]
        check(route == "incremental", f"the stream took the {route!r} route")
        shp = _http(srv.server_port, "/admin/shapes")
        check(shp["drift"] == [], f"/admin/shapes drift {shp['drift']}")
        print(f"[stream-service] {len(texts)} pushes of {per} sequences over "
              f"HTTP, window {STREAM_KEEP}: route {route!r}, every push's "
              f"patterns SHA-256 == phase 17's; B1 launches a push (the "
              f"first has no tracked tree to sweep) "
              f"{launches}; push walls {[round(w, 3) for w in walls]} s "
              f"against the library's "
              f"{[round(inp['stream'][p][1], 3) for p in range(1, len(texts) + 1)]}"
              f" s; /admin/shapes drift {shp['drift']} over "
              f"{len(shp['recorded'])} recorded keys; max_memory_allocated "
              f"{peak} B; card {card}", flush=True)
    finally:
        if srv is not None:
            srv.master.shutdown()
            srv.shutdown()
            srv.server_close()
        TC.set_config(saved)


def mesh_service_phase(torch, card: str, inp: dict) -> None:
    """Phase 25: the service on a mesh.  ``inp``: phase 9's vertical DB
    (``kos_vdb``) and rules digest (``tsr``); phase 5's database and minsup
    (``bms``), its patterns digest (``spade``), serialization (``spade
    payload``) and wall (``spade wall``); the tenth of phase 9's database
    with its library serialization and wall (``tenth``); phase 17's
    batches' SPMF texts (``stream texts``), each push's serialization
    digest and wall (``stream``), the batch size and item count."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    texts = inp["stream texts"]
    # (b)'s service boots while (a) and the drill's world run
    boot = ThreadPoolExecutor(1)
    booting = boot.submit(_world_service_boot, inp)
    boot.shutdown(wait=False)
    try:
        _adoption_one_process(torch, card, inp)
        torch.cuda.empty_cache()
        _world_drill_phase(card, inp["tenth"][3], inp["world part tsr"])
    except BaseException:
        if booting.exception() is None:
            _stop_service(booting.result()[0])
        raise
    _serve_world(card, inp, texts, booting)
    torch.cuda.empty_cache()
    _stream_service(torch, card, inp, texts)
    print(f"[meshguard] phase 25 {time.perf_counter() - t_phase:.1f} s; "
          f"card {card}", flush=True)


def phase25_only(torch) -> int:
    """``python3 chip_smoke.py --phase 25``: the card, then phase 25 on
    inputs made here through the library, where the full run hands it the
    earlier phases' results (the kernels build at their first launch)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.synth import (
        bms_webview2_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import TsrTorch, mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
    from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

    card = smi("name,power.limit")
    print(f"[card] nvidia-smi: {card} | torch: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    bms = bms_webview2_like()
    minsup = abs_minsup(0.001, len(bms))
    t1 = time.perf_counter()
    got = mine_spade_torch(bms, minsup)
    torch.cuda.synchronize()
    bms_s = round(time.perf_counter() - t1, 3)
    kos_vdb = build_vertical(kosarak_like(scale=1.0, fast=True),
                             min_item_support=1)
    rules = TsrTorch(kos_vdb, 100, 0.5, max_side=2).mine()
    tenth = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t1 = time.perf_counter()
    trules = mine_tsr_torch(tenth, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    tenth_s = round(time.perf_counter() - t1, 3)
    db = msnbc_like(scale=1.0, fast=True)
    per = len(db) // STREAM_PUSHES
    batches = [db[i * per:(i + 1) * per if i < STREAM_PUSHES - 1 else len(db)]
               for i in range(STREAM_PUSHES)]
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    served = {}
    for push, batch in enumerate(batches, 1):
        t1 = time.perf_counter()
        res = inc.push(batch)
        torch.cuda.synchronize()
        served[push] = (digest(SM.serialize_patterns(res)),
                        time.perf_counter() - t1)
    print(f"[phase 25 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh_service_phase(torch, card, {
        "kos_vdb": kos_vdb, "tsr": digest(rules_text(rules)),
        "bms": (bms, minsup), "spade": digest(patterns_text(got)),
        "spade payload": SM.serialize_patterns(got), "spade wall": (bms_s,),
        "tenth": (tenth, SM.serialize_rules(trules), tenth_s,
                  digest(rules_text(trules))),
        "part walls": {}, "world part tsr": None,
        "stream texts": [format_spmf(b) for b in batches],
        "stream": served, "stream batch": len(batches[0]),
        "stream items": len({i for seq in batches[0] for its in seq
                             for i in its})})
    print(f"card: {card}")
    return 0


def replica_child(counts_path: str, args: list) -> int:
    """``python3 chip_smoke.py --replica COUNTS ARGS...``: one replica of
    phase 26, ``spark_fsm_tpu_torch.service.app``'s ``main()`` with ARGS
    (phase 26 passes ``--device cuda``), beside a thread that rewrites
    COUNTS every 0.1 s with the B1, B2 and B3 wrappers' launch counts and
    the process's peak device memory, which the phase reads, after a
    kill -9 too."""
    import torch

    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.service import app

    def dump() -> None:
        tmp = counts_path + ".tmp"
        while True:
            with open(tmp, "w") as fh:
                json.dump({"b1": PS.pair_supports.launches,
                           "b2": RS.rule_supports.launches,
                           "b3": EP.extend_count_prune.launches,
                           "peak": (torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_initialized() else 0)},
                          fh)
            os.replace(tmp, counts_path)
            time.sleep(0.1)

    threading.Thread(target=dump, daemon=True).start()
    sys.argv = ["spark_fsm_tpu_torch.service.app", *args]
    app.main()
    return 0


class Replica:
    """A phase-26 replica in a fresh process on the card (``replica_child``
    through ``chip_smoke.py --replica``); its boot config, log and launch
    counts live under ``build/smoke/replica/``."""

    def __init__(self, name: str, cfg: dict, where: str = REPLICA_DIR,
                 extra: tuple = ()):
        self.name = name
        self.port = _free_port()
        self.cfg_path = os.path.join(where, f"{name}.json")
        self.log_path = os.path.join(where, f"{name}.log")
        self.counts_path = os.path.join(where, f"{name}.counts.json")
        with open(self.cfg_path, "w") as fh:
            json.dump(cfg, fh)
        if os.path.exists(self.counts_path):
            os.remove(self.counts_path)
        self.rid = self.boot_s = None
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--replica",
                 self.counts_path, "--config", self.cfg_path, "--device",
                 "cuda", "--port", str(self.port), *extra],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    def log(self) -> str:
        with open(self.log_path) as fh:
            return fh.read()

    def ready(self) -> "Replica":
        """Wait for the first answered ping; the replica id from the log."""
        import urllib.error

        while True:
            try:
                _http(self.port, "/admin/ping")
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                if (self.proc.poll() is not None
                        or time.perf_counter() - self.t0 > 600):
                    self.proc.kill()
                    self.proc.wait()
                    raise RuntimeError(f"replica {self.name} never answered:"
                                       f"\n{self.log()[-3000:]}")
                time.sleep(0.05)
        self.boot_s = time.perf_counter() - self.t0
        m = re.search(r"^cluster replica (\S+) ", self.log(), re.M)
        check(m is not None, f"replica {self.name} printed no replica id")
        self.rid = m.group(1)
        return self

    def counts(self) -> dict:
        with open(self.counts_path) as fh:
            return json.load(fh)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def stop(self) -> int:
        """SIGTERM (the drain), then wait; returns the exit code."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.kill()
            return None


def _trigger_redis():
    """The copied MiniRedis (``tests/_torch_miniredis.py``) with a hook
    called as each SET or RPUSH lands, before its reply is sent: phase 26
    takes the moment of a kill or of a store outage from the writes of a
    job's checkpoint, never from a sleep."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_miniredis import SnoopingMiniRedis

    class TriggerRedis(SnoopingMiniRedis):
        hook = None

        def _dispatch(self, args):
            reply = super()._dispatch(args)
            hook = self.hook
            if hook is not None and len(args) > 1 and \
                    args[0].upper() in ("SET", "RPUSH"):
                hook(args[0].upper(), args[1])
            return reply

    return TriggerRedis()


class AtFirstSave:
    """A TriggerRedis hook: runs ``act`` once, as ``uid``'s first frontier
    save lands (``after_spine``: as the spine flush that follows it lands,
    so the flight recorder holds the job's spans up to the save).  Unless
    armed by then it runs nothing and records the miss."""

    def __init__(self, uid: str, act, after_spine: bool = False,
                 armed: bool = True):
        self.uid, self.act, self.after_spine = uid, act, after_spine
        self.saved = self.missed = False
        self.armed = threading.Event()
        if armed:
            self.armed.set()
        self.fired = threading.Event()
        self.t = None

    def __call__(self, cmd: str, key: str) -> None:
        if self.fired.is_set():
            return
        if cmd == "SET" and key == f"fsm:frontier:{self.uid}":
            self.saved = True
            if self.after_spine:
                return
        elif not (cmd == "RPUSH" and key == f"fsm:trace:{self.uid}"
                  and self.saved):
            return
        if self.armed.is_set():
            self.act()
            self.t = time.perf_counter()
        else:
            self.missed = True
        self.fired.set()


def _post_code(port: int, endpoint: str, **params) -> tuple:
    """(HTTP status, Retry-After header, JSON body), 4xx answers too."""
    import urllib.error
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{endpoint}"
    data = urllib.parse.urlencode(params).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=600) as resp:
            return resp.status, resp.headers.get("Retry-After"), \
                json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Retry-After"), \
            json.loads(err.read().decode())


def _series(port: int, family: str, label: str = "") -> float:
    """Sum of a ``/metrics`` family's samples whose labels hold ``label``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=600) as resp:
        text = resp.read().decode()
    total, seen = 0.0, False
    for line in text.splitlines():
        m = re.match(rf"^{re.escape(family)}(\{{[^}}]*\}})?\s+(\S+)$", line)
        if m and label in (m.group(1) or ""):
            total += float(m.group(2))
            seen = True
    check(seen, f"{family} missing from /metrics on :{port}")
    return total


def _wait(cond, what: str, timeout: float = REPLICA_WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.05)
    check(False, f"phase 26: timed out waiting for {what}")


def _lease_holder(client, uid: str):
    raw = client.get(f"fsm:lease:{uid}")
    return None if raw is None else json.loads(raw).get("replica")


def _terminals(client, uid: str) -> list:
    """The terminal entries of a uid's status log: exactly one for a job
    settled once (zero duplicated results)."""
    return [e.partition(":")[2] for e in client.lrange(f"fsm:status:log:{uid}")
            if e.partition(":")[2] in ("finished", "failure")]


def _settled(client) -> bool:
    """No journal intent, lease or admission marker left in the store."""
    return not (client.keys("fsm:journal:*") + client.keys("fsm:admission:*")
                + [k for k in client.keys("fsm:lease:*")
                   if k != "fsm:lease:token"])


def _finish_walls(port: int, t_submit: dict, want: dict) -> dict:
    """Poll ``/status`` until every uid in ``t_submit`` is terminal; check
    each finished with a ``/get`` body equal to ``want[uid]`` = (kind,
    payload) by SHA-256; returns each submit-to-finished wall."""
    walls: dict = {}
    while len(walls) < len(t_submit):
        for uid in t_submit:
            if uid in walls:
                continue
            st = _http(port, f"/status/{uid}")
            if st["status"] in ("finished", "failure"):
                walls[uid] = time.perf_counter() - t_submit[uid]
                check(st["status"] == "finished",
                      f"{uid} failed: {st['data'].get('error')}")
        check(time.perf_counter() - min(t_submit.values()) < REPLICA_WAIT_S,
              f"phase 26: jobs unfinished: {sorted(set(t_submit) - set(walls))}")
        time.sleep(0.05)
    for uid, (kind, payload) in want.items():
        body = _http(port, f"/get/{kind}", uid=uid)["data"][kind]
        check(digest(body) == digest(payload),
              f"/get/{kind} of {uid} differs from the library result by "
              f"SHA-256")
    return walls


def _failover_drill(card: str, inp: dict, pool: int) -> None:
    """Phase 26 (a): replicas A and B on one store; B steals A's queued
    fillers, A dies by kill -9 right after its drill's first frontier save,
    B adopts the drill once A's lease has expired and resumes it."""
    from spark_fsm_tpu_torch.service.resp import RespClient

    mini = _trigger_redis()
    client = RespClient(port=mini.port)
    base = {"fault_injection": True,
            "store": {"backend": "redis", "host": "127.0.0.1",
                      "port": mini.port},
            "cluster": {"enabled": True, "lease_ttl_s": REPLICA_TTL_S,
                        "recover_every_s": REPLICA_RECOVER_S},
            "observability": {"trace": True, "spine_flush_spans": 8},
            "engine": {"fused": "queue", "pool_bytes": pool}}
    # B runs both fillers at once: its steal budget is its idle workers
    a = Replica("a", dict(base, service={"miner_workers": 1,
                                         "queue_depth": 8}))
    b = Replica("b", dict(base, service={"miner_workers": 2,
                                         "queue_depth": 8}))
    try:
        a.ready()
        b.ready()
        check(a.rid != b.rid, "two replicas took one replica id")
        code, _, _ = _post_code(a.port, "/admin/faults", action="arm",
                                site="checkpoint.save", every="1",
                                delay_s=str(REPLICA_SAVE_DELAY_S), exc="none")
        check(code == 200, "replica A refused the fault arm")
        kill = AtFirstSave("r-bms", a.proc.kill, after_spine=True,
                           armed=False)
        mini.hook = kill
        t_submit, want = {}, {}
        for uid, params, kind, payload in (
                ("r-bms", dict(algorithm="SPADE_TPU",
                               support=str(inp["bms"][1]),
                               path=inp["files"]["bms"], checkpoint="1",
                               checkpoint_every_s="0"),
                 "patterns", inp["bms payload"]),
                ("r-spam", dict(algorithm="SPAM_TPU",
                                support=str(inp["msnbc"][1]),
                                path=inp["files"]["msnbc"]),
                 "patterns", inp["msnbc payload"]),
                ("r-tsr", dict(algorithm="TSR_TPU", k="100", minconf="0.5",
                               max_side="2", path=inp["files"]["tenth"]),
                 "rules", inp["tenth"][1])):
            t_submit[uid] = time.perf_counter()
            r = _http(a.port, "/train", uid=uid, source="FILE", **params)
            check(r["status"] == "started", f"/train {uid} on A: {r}")
            want[uid] = (kind, payload)
        # B steals both fillers off A's admission namespace
        _wait(lambda: all(_lease_holder(client, u) == b.rid
                          or client.get(f"fsm:status:{u}") == "finished"
                          for u in ("r-spam", "r-tsr")),
              "B to steal both fillers")
        t_stolen = time.perf_counter() - t_submit["r-tsr"]
        kill.armed.set()
        check(kill.fired.wait(REPLICA_WAIT_S), "A saved no frontier")
        check(not kill.missed, "A's first frontier save landed before B "
              "stole both fillers")
        a.proc.wait()
        a_counts = a.counts()
        check(client.get("fsm:journal:r-bms") is not None
              and _lease_holder(client, "r-bms") == a.rid,
              "A's journal intent or lease on the drill is gone at the kill")
        # B may adopt only once A's lease has expired
        t_adopt = _wait(
            lambda: (time.perf_counter() if client.get("fsm:status:r-bms")
                     == "finished" or _lease_holder(client, "r-bms")
                     == b.rid else None), "B to adopt the drill")
        walls = _finish_walls(b.port, t_submit, want)
        for uid in t_submit:
            check(_terminals(client, uid) == ["finished"],
                  f"{uid} settled {_terminals(client, uid)}")
        n = _series(b.port, "fsm_job_time_to_adoption_seconds_count")
        adoption_s = _series(b.port,
                             "fsm_job_time_to_adoption_seconds_sum") / n
        check(n >= 1 and 0.0 < adoption_s <=
              REPLICA_TTL_S + REPLICA_RECOVER_S + REPLICA_SAVE_DELAY_S + 5.0,
              f"B's fsm_job_time_to_adoption_seconds: {n} samples, mean "
              f"{adoption_s}")
        stolen = _series(b.port, "fsm_steal_attempts_total",
                         'outcome="stolen"')
        check(stolen >= 2, f"B stole {stolen} jobs")
        merged = _http(b.port, "/admin/trace/r-bms")
        reps = {s.get("replica") for s in merged.get("spans", [])}
        check(merged.get("merged") and {a.rid, b.rid} <= reps,
              f"/admin/trace/r-bms on B merges spans of {reps}")
        _wait(lambda: _settled(client), "every journal intent and lease to "
              "settle")
        b_counts = b.counts()
        check(a_counts["b1"] > 0 and b_counts["b1"] > 0
              and b_counts["b2"] > 0 and b_counts["b3"] > 0,
              f"launches on A {a_counts}, on B {b_counts}")
        print(f"[replica] (a) failover: replicas A {a.rid} and B {b.rid} on "
              f"one store, boots {a.boot_s:.3f} / {b.boot_s:.3f} s; B stole "
              f"both fillers {t_stolen:.3f} s after the last submit "
              f"(fsm_steal_attempts_total stolen {stolen:g}); A killed -9 "
              f"as its first frontier save of r-bms landed; B adopted it "
              f"{t_adopt - kill.t:.3f} s after the kill (lease ttl "
              f"{REPLICA_TTL_S} s), fsm_job_time_to_adoption_seconds "
              f"{adoption_s:.3f} s; /admin/trace/r-bms on B merges "
              f"{len(merged['spans'])} spans of both replicas; every body "
              f"SHA-256 == the library result's, one terminal status each, "
              f"journal, leases and markers settled; card {card}",
              flush=True)
        for uid, lib in (("r-bms", inp["bms wall"]),
                         ("r-spam", inp["msnbc wall"]),
                         ("r-tsr", inp["tenth"][2])):
            print(f"[replica] (a) {uid}: submit-to-finished {walls[uid]:.3f} "
                  f"s against the library call's {lib} s (cold, warm); card "
                  f"{card}", flush=True)
        for rep, counts in ((a, a_counts), (b, b_counts)):
            print(f"[replica] (a) replica {rep.name} ({rep.rid}): B1 "
                  f"{counts['b1']}, B2 {counts['b2']}, B3 {counts['b3']} "
                  f"launches, max_memory_allocated {counts['peak']} B; card "
                  f"{card}", flush=True)
    finally:
        if a.proc.poll() is None:
            a.kill()
        rc = b.stop()
        client.close()
        mini.close()
        _heartbeats((a, b), "phase 26 (a)")
    check(rc == 0, f"replica B exited with {rc}:\n{b.log()[-2000:]}")


def _restart_and_outage_drills(card: str, inp: dict, pool: int) -> None:
    """Phase 26 (b) and (c): one replica with a queue of two behind a
    NetProxy; a flood sheds, a kill -9 lands right after the drill's first
    frontier save, and the reboot on the same store resumes it (b); the
    rebooted replica then mines the drill again while the store is
    black-holed at its first frontier save: the job stalls, and once the
    link is restored the same replica reacquires it and finishes (c)."""
    from spark_fsm_tpu_torch.service.resp import RespClient
    from spark_fsm_tpu_torch.utils.netproxy import NetProxy

    mini = _trigger_redis()
    proxy = NetProxy("127.0.0.1", mini.port)
    client = RespClient(port=mini.port)   # straight to the store
    cfg = {"fault_injection": True,
           "service": {"miner_workers": 1, "queue_depth": 2},
           "store": {"backend": "redis", "host": "127.0.0.1",
                     "port": proxy.port, "timeout_s": 1.0},
           "cluster": {"enabled": True, "lease_ttl_s": REPLICA_TTL_S,
                       "recover_every_s": REPLICA_RECOVER_S},
           "storeguard": {"enabled": True, "probe_every_s": 0.25,
                          "down_after": 1, "spool_max_entries": 4096,
                          "stall_max_s": 120.0},
           "engine": {"fused": "queue", "pool_bytes": pool}}
    drill = dict(algorithm="SPADE_TPU", support=str(inp["bms"][1]),
                 source="FILE", path=inp["files"]["bms"], checkpoint="1",
                 checkpoint_every_s="0")
    filler = dict(algorithm="SPADE", source="INLINE",
                  sequences="1 -1 2 -2\n", support="1.0")
    c = Replica("c", cfg)
    c2 = None
    try:
        c.ready()
        code, _, _ = _post_code(c.port, "/admin/faults", action="arm",
                                site="checkpoint.save", every="1",
                                delay_s="1.0", exc="none")
        check(code == 200, "replica C refused the fault arm")
        kill = AtFirstSave("r-restart", c.proc.kill, armed=False)
        mini.hook = kill
        t0 = time.perf_counter()
        for uid, params in (("r-restart", drill), ("r-fill0", filler),
                            ("r-fill1", filler)):
            code, _, body = _post_code(c.port, "/train", uid=uid, **params)
            check(code == 200 and body["status"] == "started",
                  f"/train {uid}: {code} {body}")
            if uid == "r-restart":   # the worker takes it: the queue is free
                _wait(lambda: _series(c.port, "fsm_service_queue_depth")
                      == 0, "C's worker to take r-restart")
        hints = []
        for i in range(3):
            code, retry_after, body = _post_code(c.port, "/train",
                                                 uid=f"r-shed{i}", **filler)
            check(code == 429 and retry_after is not None
                  and retry_after.isdigit() and int(retry_after) >= 1
                  and body["data"]["retry_after_s"] == retry_after,
                  f"shed {i}: {code} Retry-After {retry_after!r} {body}")
            hints.append(int(retry_after))
        depth = _series(c.port, "fsm_service_queue_depth")
        kill.armed.set()
        check(kill.fired.wait(REPLICA_WAIT_S), "C saved no frontier")
        check(not kill.missed, "C's first frontier save landed before the "
              "flood was shed")
        c.proc.wait()
        c_counts = c.counts()
        c2 = Replica("c2", cfg).ready()   # the reboot on the same store
        walls = _finish_walls(c2.port, {"r-restart": t0},
                              {"r-restart": ("patterns",
                                             inp["bms payload"])})
        for uid in ("r-fill0", "r-fill1"):
            _wait(lambda: client.get(f"fsm:status:{uid}") in (
                "finished", "failure"), f"{uid} to settle")
            st = _http(c2.port, f"/status/{uid}")
            check(st["status"] == "failure" and "interrupted by restart"
                  in st["data"].get("error", ""),
                  f"{uid} after the restart: {st}")
        for uid in ("r-restart", "r-fill0", "r-fill1"):
            check(len(_terminals(client, uid)) == 1,
                  f"{uid} settled {_terminals(client, uid)}")
        check(all(client.get(f"fsm:status:r-shed{i}") is None
                  for i in range(3)), "a shed submit left a status")
        _wait(lambda: _settled(client), "the restart's journal and leases "
              "to settle")
        depth_after = _series(c2.port, "fsm_service_queue_depth")
        check(depth == 2 and depth_after == 0,
              f"queue-depth gauge {depth} before the kill, {depth_after} "
              f"after the reboot")
        print(f"[replica] (b) overload and kill-restart: replica C {c.rid} "
              f"(one worker, queue_depth 2) booted in {c.boot_s:.3f} s took "
              f"the checkpointed r-restart and two fillers, shed three more "
              f"with 429 (Retry-After {hints} s); killed -9 as r-restart's "
              f"first frontier save landed; the reboot C' {c2.rid} booted in "
              f"{c2.boot_s:.3f} s, resumed r-restart after C's lease expired "
              f"(patterns SHA-256 == phase 5's, submit-to-finished "
              f"{walls['r-restart']:.3f} s against the library's "
              f"{inp['bms wall']} s) and failed both fillers durably "
              f"('interrupted by restart'); queue-depth gauge {depth:g} -> "
              f"{depth_after:g}; C launched B1 {c_counts['b1']} times "
              f"(peak {c_counts['peak']} B); card {card}", flush=True)

        # (c) the store black-holed at the drill's first frontier save
        def cut() -> None:
            proxy.blackhole(True)

        outage = AtFirstSave("r-outage", cut)
        mini.hook = outage
        t0 = time.perf_counter()
        r = _http(c2.port, "/train", uid="r-outage", **drill)
        check(r["status"] == "started", f"/train r-outage: {r}")
        check(outage.fired.wait(REPLICA_WAIT_S), "r-outage saved no frontier")
        mini.hook = None

        def stalled():
            sg = _http(c2.port, "/admin/health").get("storeguard") or {}
            return sg if (sg.get("state") == "down"
                          and sg.get("stalled_jobs", 0) >= 1) else None

        # /admin/health's store reads wait out their timeouts during the
        # outage, so it is read once C' has logged the stall: a read
        # begun earlier could end just before it and cost one more
        _wait(lambda: '"storeguard_stall"' in c2.log(), "C' to log the stall")
        sg = _wait(stalled, "r-outage to stall")
        t_stall = time.perf_counter()
        check(client.get("fsm:status:r-outage") not in ("finished", "failure"),
              "r-outage reached a terminal status during the outage")
        proxy.heal()
        t_heal = time.perf_counter()
        t_reacq = _wait(lambda: (time.perf_counter() if _lease_holder(
            client, "r-outage") == c2.rid or client.get(
            "fsm:status:r-outage") == "finished" else None),
            "C' to reacquire r-outage")
        walls = _finish_walls(c2.port, {"r-outage": t0},
                              {"r-outage": ("patterns", inp["bms payload"])})
        t_done = time.perf_counter()
        check(_terminals(client, "r-outage") == ["finished"],
              f"r-outage settled {_terminals(client, 'r-outage')}")
        _wait(lambda: _settled(client), "the outage's journal and lease to "
              "settle")
        spool = _series(c2.port, "fsm_storeguard_spool_entries")
        replays = _series(c2.port, "fsm_storeguard_replays_total",
                          'outcome="ok"')
        resumed = _series(c2.port, "fsm_storeguard_stalls_total",
                          'outcome="resumed"')
        check(spool == 0 and replays >= 1 and resumed >= 1,
              f"spool {spool}, replays ok {replays}, stalls resumed "
              f"{resumed}")
        c2_counts = c2.counts()
        check(c2_counts["b1"] > 0, f"C' launches {c2_counts}")
        print(f"[replica] (c) store outage: the link to the store "
              f"black-holed as r-outage's first frontier save landed; "
              f"/admin/health (whose store reads wait out their timeouts "
              f"during the outage) read the job stalled "
              f"{t_stall - outage.t:.3f} s later (storeguard down, spool "
              f"{sg.get('spool_entries')} entries), never failed; link "
              f"restored after {t_heal - outage.t:.3f} s; C' "
              f"reacquired the job {t_reacq - t_heal:.3f} s after the heal "
              f"and finished it {t_done - t_heal:.3f} s after it (stall to "
              f"resume {t_done - t_stall:.3f} s; submit-to-finished "
              f"{walls['r-outage']:.3f} s), patterns SHA-256 == phase 5's, "
              f"spool replayed ({replays:g} ok) and drained, stalls resumed "
              f"{resumed:g}; C' launched B1 {c2_counts['b1']} times, peak "
              f"{c2_counts['peak']} B; card {card}", flush=True)
    finally:
        proxy.heal()
        if c.proc.poll() is None:
            c.kill()
        rc = c2.stop() if c2 is not None else 0
        client.close()
        proxy.close()
        mini.close()
    check(rc == 0, f"replica C' exited with {rc}:\n{c2.log()[-2000:]}")


class Supervisor:
    """``python -m spark_fsm_tpu_torch.service.fleet`` in a fresh process;
    a thread keeps its output (which its replicas inherit) in a log and
    harvests the replicas' pids and ports with each line's time."""

    def __init__(self, name: str, cfg_path: str, *args):
        self.log_path = os.path.join(REPLICA_DIR, f"{name}.log")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_fsm_tpu_torch.service.fleet",
             "--config", cfg_path, "--max", "4", "--poll", "0.5", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            bufsize=1, cwd=ROOT)
        self.lines, self.pids, self.ports = [], [], []
        self.booted_t, self.served_t = [], []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        with open(self.log_path, "w") as log:
            for line in self.proc.stdout:
                log.write(line)
                log.flush()
                self.lines.append(line)
                m = re.search(r"booted replica #\d+ \(pid (\d+)", line)
                if m:
                    self.pids.append(int(m.group(1)))
                    self.booted_t.append(time.perf_counter())
                m = re.search(r"service on http://[^:]+:(\d+)", line)
                if m:
                    self.ports.append(int(m.group(1)))
                    self.served_t.append(time.perf_counter())


def _alive(pid: int) -> bool:
    """True while ``pid`` runs (an exited, unreaped orphan is a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _fleet_drill(card: str, inp: dict, pool: int) -> None:
    """Phase 26 (d): the fleet supervisor boots two replicas, takes a
    desired count of three, dies by SIGKILL mid-scale-up, and restarted
    with ``--initial 0`` counts the orphans: three live heartbeats, no
    duplicate, every accepted job settled once with parity."""
    from spark_fsm_tpu_torch.service.fleet import live_heartbeats
    from spark_fsm_tpu_torch.service.resp import RespClient

    mini = _trigger_redis()
    client = RespClient(port=mini.port)
    cfg_path = os.path.join(REPLICA_DIR, "fleet.json")
    with open(cfg_path, "w") as fh:
        json.dump({
            "service": {"port": 0, "miner_workers": 1, "queue_depth": 16},
            "store": {"backend": "redis", "host": "127.0.0.1",
                      "port": mini.port},
            "cluster": {"enabled": True, "lease_ttl_s": REPLICA_TTL_S,
                        "recover_every_s": REPLICA_RECOVER_S},
            # the controller holds: the phase publishes the desired count
            "autoscale": {"enabled": True, "min_replicas": 1,
                          "max_replicas": 4, "hold_s": 3600.0,
                          "cooldown_s": 3600.0},
            "engine": {"pool_bytes": pool}}, fh)
    sups = []
    try:
        t0 = time.perf_counter()
        first = Supervisor("fleet-1", cfg_path, "--initial", "2")
        sups.append(first)
        _wait(lambda: len(first.ports) >= 2
              and live_heartbeats(client) >= 2, "the fleet's first two "
              "replicas")
        check(all("--device cuda" in line for line in first.lines
                  if "booted replica" in line),
              "the supervisor did not pass --device cuda")
        t_submit, want = {}, {}
        for i, extra in enumerate(({}, {"checkpoint": "1",
                                        "checkpoint_every_s": "0"}, {})):
            uid = f"f-bms{i}"
            t_submit[uid] = time.perf_counter()
            r = _http(first.ports[i % 2], "/train", uid=uid,
                      algorithm="SPADE_TPU", support=str(inp["bms"][1]),
                      source="FILE", path=inp["files"]["bms"], **extra)
            check(r["status"] == "started", f"/train {uid}: {r}")
            want[uid] = ("patterns", inp["bms payload"])
        client.set("fsm:autoscale:desired", json.dumps(
            {"desired": 3, "dir": "up", "reason": "chip_smoke phase 26",
             "leader": "chip_smoke", "seq": 1, "ts": round(time.time(), 3)}))
        _wait(lambda: len(first.pids) >= 3, "the third replica's boot")
        first.proc.kill()   # SIGKILL mid-scale-up
        first.proc.wait()
        walls = _finish_walls(first.ports[0], t_submit, want)
        # the half-booted third replica finishes its boot alone; the
        # restarted supervisor must count it (ROADMAP Queue C 6)
        _wait(lambda: live_heartbeats(client) >= 3, "the orphaned third "
              "replica's heartbeat")
        second = Supervisor("fleet-2", cfg_path, "--initial", "0")
        sups.append(second)
        _wait(lambda: any("supervising 0 replicas" in line
                          for line in second.lines), "the restarted "
              "supervisor")
        time.sleep(3.0)   # six polls
        hb = live_heartbeats(client)
        check(hb == 3 and not second.pids,
              f"after the restart {hb} heartbeats, replicas booted by the "
              f"restarted supervisor {second.pids}")
        for uid in t_submit:
            check(_terminals(client, uid) == ["finished"],
                  f"{uid} settled {_terminals(client, uid)}")
        _wait(lambda: _settled(client), "the fleet's journal and leases to "
              "settle")
        boots = [round(s - b, 3) for b, s in zip(first.booted_t,
                                                 first.served_t)]
        print(f"[replica] (d) fleet: `python -m "
              f"spark_fsm_tpu_torch.service.fleet --initial 2` booted two "
              f"replicas with --device cuda (boot to serving {boots} s, "
              f"first ping {time.perf_counter() - t0:.1f} s into the "
              f"drill); desired 3 published, the supervisor SIGKILLed as it "
              f"booted the third; restarted with --initial 0 it counted "
              f"{hb} live heartbeats and booted nothing; the three BMS jobs "
              f"settled once each, bodies SHA-256 == phase 5's, "
              f"submit-to-finished {[round(walls[u], 3) for u in t_submit]} "
              f"s against the library's {inp['bms wall']} s; card {card}",
              flush=True)
    finally:
        for sup in sups:
            if sup.proc.poll() is None:
                sup.proc.terminate()
        for sup in sups:
            try:
                sup.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                sup.proc.kill()
                sup.proc.wait()
        pids = [pid for sup in sups for pid in sup.pids]
        for pid in pids:   # the killed supervisor's orphans
            if _alive(pid):
                os.kill(pid, signal.SIGTERM)
        deadline = time.perf_counter() + 120
        while any(_alive(p) for p in pids) and time.perf_counter() < deadline:
            time.sleep(0.1)
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        client.close()
        mini.close()


def _host_load(tag: str) -> None:
    """Print the host's load and its busiest processes: the replica
    phases' leases last 2 s, so a host busy elsewhere shows here."""
    top = subprocess.run(
        ["ps", "-eo", "pid,ppid,pcpu,rss,etime,args", "--sort=-pcpu"],
        capture_output=True, text=True).stdout.splitlines()[:6]
    print(f"[host] {tag}: load average {os.getloadavg()}, {os.cpu_count()} "
          f"cores; busiest: " + " | ".join(line.strip()[:120]
                                           for line in top[1:]), flush=True)


class _GcPauses:
    """This process's garbage collections while installed: it serves the
    replicas' store, which answers nobody while a collection runs."""

    def __init__(self):
        self.n, self.longest, self._t0 = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.longest = max(self.longest, time.perf_counter() - self._t0)
            self._t0 = None

    def install(self) -> "_GcPauses":
        if self not in gc.callbacks:
            gc.callbacks.append(self)
        return self


STORE_GC = _GcPauses()


def _heartbeats(reps, tag: str) -> None:
    """Print each replica's late heartbeats (the port logs a beat that
    comes later than half the lease TTL after the one before, with the
    wall of the tick before it) beside the store process's collections."""
    parts = []
    for rep in reps:
        late = []
        for line in rep.log().splitlines():
            if '"lease_heartbeat_late"' in line:
                try:
                    ev = json.loads(line[line.index("{"):])
                except ValueError:
                    continue
                late.append((ev["gap_s"], ev["tick_s"]))
        parts.append(f"{rep.name} {len(late)} late" + (
            "" if not late else
            f", longest gap {max(late)[0]} s after a {max(late)[1]} s tick"))
    print(f"[host] {tag} heartbeats: {'; '.join(parts)}; the store's "
          f"process collected garbage {STORE_GC.n} times, the longest "
          f"{STORE_GC.longest:.3f} s", flush=True)


def replica_phase(torch, card: str, inp: dict) -> None:
    """Phase 26: the replicated service.  ``inp``: phase 5's database and
    minsup (``bms``), serialization (``bms payload``) and walls (``bms
    wall``); phase 13's (``msnbc``, ``msnbc payload``, ``msnbc wall``);
    the tenth of phase 9's database with its rules' serialization and wall
    (``tenth``)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _host_load("phase 26")
    STORE_GC.install()
    os.makedirs(REPLICA_DIR, exist_ok=True)
    # FILE sources: both replicas read them on this host (a body of
    # 990,000 sequences inline would be parsed from the HTTP request);
    # written before any replica boots, so this process does no long work
    # while they hold leases
    inp["files"] = {}
    for name, db in (("bms", inp["bms"][0]), ("msnbc", inp["msnbc"][0]),
                     ("tenth", inp["tenth"][0])):
        inp["files"][name] = os.path.join(REPLICA_DIR, f"{name}.spmf")
        with open(inp["files"][name], "w") as fh:
            fh.write(format_spmf(db))
    # co-located engines split the one card's pool: three at once in (a)
    # (A's drill, B's two fillers) and (d) (three replicas)
    pool = auto_pool_bytes(torch.device("cuda", 0))
    print(f"[replica] phase 26 inputs written in "
          f"{time.perf_counter() - t_phase:.1f} s; [engine] pool_bytes "
          f"{pool // 3} a replica in (a) and (d), {pool} in (b) and (c)",
          flush=True)
    _failover_drill(card, inp, pool // 3)
    _restart_and_outage_drills(card, inp, pool)
    _fleet_drill(card, inp, pool // 3)
    print(f"[replica] phase 26 {time.perf_counter() - t_phase:.1f} s; "
          f"card {card}", flush=True)


def phase26_only(torch) -> int:
    """``python3 chip_smoke.py --phase 26``: the card, then phase 26 on
    inputs made here through the library (the kernels build at their
    first launch, before any replica boots)."""
    from spark_fsm_tpu_torch.data.synth import (
        bms_webview2_like, kosarak_like, msnbc_like)
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM

    card = smi("name,power.limit")
    print(f"[card] nvidia-smi: {card} | torch: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    inp = {}
    for name, db, minsup, mine, ser in (
            ("bms", bms_webview2_like(), 0.001, mine_spade_torch,
             SM.serialize_patterns),
            ("msnbc", msnbc_like(scale=1.0, fast=True), 0.005,
             mine_spam_torch, SM.serialize_patterns)):
        minsup = abs_minsup(minsup, len(db))
        t1 = time.perf_counter()
        got = mine(db, minsup)
        torch.cuda.synchronize()
        inp[name] = (db, minsup)
        inp[f"{name} payload"] = ser(got)
        inp[f"{name} wall"] = (round(time.perf_counter() - t1, 3),)
    tenth = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t1 = time.perf_counter()
    rules = mine_tsr_torch(tenth, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    inp["tenth"] = (tenth, SM.serialize_rules(rules),
                    round(time.perf_counter() - t1, 3))
    print(f"[phase 26 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    replica_phase(torch, card, inp)
    print(f"card: {card}")
    return 0


def _resident_faults(torch, card: str, db, want: str) -> None:
    """Phase 27 (a): ``device.resident`` armed ``nth=1`` at each of its
    three points around the 1 % Kosarak-shaped TSR on the resident route:
    every mine raises out of ``mine_tsr_torch`` with the site's counters
    at 1/1; the unarmed mine's rules equal phase 15's by SHA-256."""
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.utils import faults
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    def counters():
        return dict(faults.counters().get("device.resident",
                                          {"calls": 0, "injected": 0}))

    rows = []
    for point in ("segment", "readback", "records"):
        was, b2 = counters(), RS.rule_supports.launches
        stats: dict = {}
        t0 = time.perf_counter()
        try:
            with faults.injected("device.resident", nth=1, match=point):
                mine_tsr_torch(db, 100, 0.5, max_side=None,
                               resident="always", stats_out=stats)
            raised = None
        except faults.FaultInjected as exc:
            raised = exc
        wall = time.perf_counter() - t0
        now = counters()
        moved = {k: now[k] - was[k] for k in ("calls", "injected")}
        check(raised is not None and point in str(raised),
              f"device.resident at {point!r} did not raise out of the mine")
        check(moved == {"calls": 1, "injected": 1},
              f"device.resident at {point!r}: counters moved {moved}")
        check(stats.get("resident_fallbacks", 0) == 0,
              f"a resident fallback at {point!r}: {stats}")
        rows.append(f"{point} raised after {wall:.3f} s, "
                    f"{RS.rule_supports.launches - b2} B2 launches")
    torch.cuda.synchronize()
    b2 = RS.rule_supports.launches
    stats = {}
    t0 = time.perf_counter()
    got = mine_tsr_torch(db, 100, 0.5, max_side=None, resident="always",
                         stats_out=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(stats.get("resident") is True
          and stats.get("resident_fallbacks", 0) == 0,
          f"the unarmed mine left the resident route: {stats}")
    check(digest(rules_text(got)) == want,
          "the unarmed 1 % resident mine differs from phase 15's by SHA-256")
    print(f"[chaos] (a) device.resident nth=1 on the 1 % Kosarak-shaped TSR "
          f"(k=100, minconf 0.5, resident='always'): {'; '.join(rows)}; "
          f"each the site's counters 1/1, resident_fallbacks 0; unarmed "
          f"{len(got)} rules SHA-256 == phase 15's in {wall:.3f} s, "
          f"{RS.rule_supports.launches - b2} B2 launches; card {card}",
          flush=True)


class KillAfterChunks:
    """A TriggerRedis hook: kills a replica as the checkpoint meta SET
    that follows ``chunks`` delta appends of ``uid`` lands, so the meta
    names every chunk in the list."""

    def __init__(self, uid: str, chunks: int, act):
        self.uid, self.chunks, self.act = uid, chunks, act
        self.pushed = 0
        self.fired = threading.Event()
        self.t = None

    def __call__(self, cmd: str, key: str) -> None:
        if self.fired.is_set():
            return
        if cmd == "RPUSH" and key == f"fsm:frontier:results:{self.uid}":
            self.pushed += 1
        elif (cmd == "SET" and key == f"fsm:frontier:{self.uid}"
              and self.pushed >= self.chunks):
            self.act()
            self.t = time.perf_counter()
            self.fired.set()


def _flip(value: str, at: int) -> str:
    """One bit of bitrot at ``at``."""
    return value[:at] + chr(ord(value[at]) ^ 0x01) + value[at + 1:]


def _job_until_terminal(port: int, uid: str) -> dict:
    def done():
        st = _http(port, f"/status/{uid}")
        return st if st["status"] in ("finished", "failure") else None

    return _wait(done, f"{uid} to settle")


def _bitrot_service(card: str, inp: dict, pool: int) -> None:
    """Phase 27 (b) and (c): one replica of the port's service over the
    copied MiniRedis, with faults enabled, the result cache and the
    integrity scrubber on.  (b) ``device.dispatch`` at B2's launch fails a
    TSR job cleanly; its resubmit warms the result cache.  (c)
    ``scripts/bitrot_smoke.py`` steps 1-6: kill -9 the checkpointed BMS
    drill after two delta chunks, rot the store, reboot, heal."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.service.resp import RespClient
    from spark_fsm_tpu_torch.utils import envelope

    os.makedirs(BITROT_DIR, exist_ok=True)
    bms_path = os.path.join(BITROT_DIR, "bms.spmf")
    with open(bms_path, "w") as fh:
        fh.write(format_spmf(inp["bms"][0]))
    tenth_text = format_spmf(inp["tenth"][0])
    mini = _trigger_redis()
    client = RespClient(port=mini.port)
    cfg = {"fault_injection": True,
           "service": {"miner_workers": 1, "queue_depth": 8},
           "store": {"backend": "redis", "host": "127.0.0.1",
                     "port": mini.port},
           "cluster": {"enabled": True, "lease_ttl_s": REPLICA_TTL_S,
                       "recover_every_s": REPLICA_RECOVER_S},
           "rescache": {"enabled": True},
           "integrity": {"scrub_every_s": BITROT_SCRUB_S,
                         "scrub_batch": 128},
           "engine": {"fused": "never", "node_batch": BITROT_NODE_BATCH,
                      "pool_bytes": pool}}
    tsr = dict(algorithm="TSR_TPU", source="INLINE", sequences=tenth_text,
               k="100", minconf="0.5", max_side="2")
    r1 = Replica("bitrot-1", cfg, BITROT_DIR)
    r2 = None
    try:
        r1.ready()
        # (b) device.dispatch at B2's launch, through /admin/faults
        code, _, body = _post_code(r1.port, "/admin/faults", action="arm",
                                   site="device.dispatch", every="1",
                                   match="kernel")
        check(code == 200, f"the replica refused the fault arm: {body}")
        t0 = time.perf_counter()
        r = _http(r1.port, "/train", uid="chaos-tsr", **tsr)
        check(r["status"] == "started", f"/train chaos-tsr: {r}")
        st = _job_until_terminal(r1.port, "chaos-tsr")
        fail_s = time.perf_counter() - t0
        err = st["data"].get("error", "")
        check(st["status"] == "failure" and "'device.dispatch'" in err,
              f"chaos-tsr under an armed device.dispatch: {st}")
        check(client.get("fsm:rule:chaos-tsr") is None,
              "the failed job stored rules")
        _wait(lambda: client.get("fsm:journal:chaos-tsr") is None
              and client.get("fsm:lease:chaos-tsr") is None,
              "the failed job's journal and lease to settle")
        check(_terminals(client, "chaos-tsr") == ["failure"],
              f"chaos-tsr settled {_terminals(client, 'chaos-tsr')}")
        fired = _series(r1.port, "fsm_fault_site_injected_total",
                        'site="device.dispatch"')
        code, _, body = _post_code(r1.port, "/admin/faults",
                                   action="disarm", site="device.dispatch")
        check(code == 200 and body["armed"] == {}, f"disarm: {body}")
        t0 = time.perf_counter()
        r = _http(r1.port, "/train", uid="warm-tsr", **tsr)
        check(r["status"] == "started", f"/train warm-tsr: {r}")
        walls = _finish_walls(r1.port, {"warm-tsr": t0},
                              {"warm-tsr": ("rules", inp["tenth"][1])})
        ekeys = _wait(lambda: client.keys("fsm:rescache:*"),
                      "the result cache entry of warm-tsr")
        check(len(ekeys) == 1, f"rescache keys {ekeys}")
        ekey = ekeys[0]
        print(f"[chaos] (b) device.dispatch (every launch at point "
              f"'kernel') armed through /admin/faults on replica "
              f"{r1.rid}: the tenth's Kosarak-shaped TSR job failed "
              f"cleanly in {fail_s:.3f} s ({fired:g} injections, its "
              f"retry included), error names the site, no rules stored, "
              f"journal and lease settled, one terminal status; disarmed, "
              f"the resubmit finished in {walls['warm-tsr']:.3f} s (the "
              f"library's {inp['tenth'][2]} s) with rules SHA-256 == the "
              f"library's, and warmed the result cache; card {card}",
              flush=True)

        # (c) the checkpointed drill, killed -9 after two delta chunks
        kill = KillAfterChunks("rot-bms", BITROT_CHUNKS, r1.proc.kill)
        mini.hook = kill
        t_submit = time.perf_counter()
        r = _http(r1.port, "/train", uid="rot-bms", algorithm="SPADE_TPU",
                  support=str(inp["bms"][1]), source="FILE", path=bms_path,
                  checkpoint="1", checkpoint_every_s="0")
        check(r["status"] == "started", f"/train rot-bms: {r}")
        check(kill.fired.wait(REPLICA_WAIT_S),
              f"rot-bms persisted {kill.pushed} delta chunks, no kill")
        mini.hook = None
        r1.proc.wait()
        counts1 = r1.counts()
        chunks_key = "fsm:frontier:results:rot-bms"
        chunks = client.lrange(chunks_key)
        check(len(chunks) == BITROT_CHUNKS
              and client.get("fsm:journal:rot-bms") is not None,
              f"at the kill: {len(chunks)} chunks, journal "
              f"{client.get('fsm:journal:rot-bms') is not None}")
        # the service is dead: rot its durable state
        client.ltrim(chunks_key, 0, len(chunks) - 2)
        client.rpush(chunks_key, _flip(chunks[-1], len(chunks[-1]) - 10))
        raw = client.get(ekey)
        client.set(ekey, raw[: len(raw) // 2])
        client.set("fsm:journal:poison-bitrot", _flip(envelope.wrap(
            json.dumps({"incarnation": "ghost"})), 80))

        r2 = Replica("bitrot-2", cfg, BITROT_DIR).ready()
        t_ready = time.perf_counter()
        m = re.search(r"^restart recovery: .*$", r2.log(), re.M)
        check(m is not None and "1 quarantined" in m.group(0),
              f"the reboot's recovery line: {m and m.group(0)}")
        check(client.get("fsm:journal:poison-bitrot") is None
              and client.get("fsm:quarantine:poison-bitrot"),
              "the poison intent was not quarantined at boot")
        walls = _finish_walls(r2.port, {"rot-bms": t_ready},
                              {"rot-bms": ("patterns", inp["bms payload"])})
        check(_terminals(client, "rot-bms") == ["finished"],
              f"rot-bms settled {_terminals(client, 'rot-bms')}")
        check(client.get("fsm:quarantine:frontier:results:rot-bms#1"),
              f"the rotten delta is not quarantined: "
              f"{client.keys('fsm:quarantine:*')}")
        # the rotten cache entry is never served: a cold re-mine
        t0 = time.perf_counter()
        r = _http(r2.port, "/train", uid="rehit-tsr", **tsr)
        check(r["status"] == "started", f"/train rehit-tsr: {r}")
        rehit = _finish_walls(r2.port, {"rehit-tsr": t0},
                              {"rehit-tsr": ("rules", inp["tenth"][1])})
        stats = json.loads(envelope.unwrap(
            client.get("fsm:stats:rehit-tsr"))[0] or "{}")
        check("served_from_cache" not in stats,
              f"the rotten cache entry was served: {stats}")
        check(client.get("fsm:quarantine:" + ekey[len("fsm:"):]),
              "the rotten cache entry is not quarantined")
        # the scrubber: damage at rest, no reads
        client.set("fsm:journal:rot-at-rest", _flip(envelope.wrap(
            json.dumps({"incarnation": "x"})), 80))
        t0 = time.perf_counter()
        _wait(lambda: client.get("fsm:journal:rot-at-rest") is None
              and client.get("fsm:quarantine:rot-at-rest"),
              "the scrubber to quarantine the intent at rest", 60.0)
        scrub_s = time.perf_counter() - t0
        rep = _http(r2.port, "/admin/integrity")
        surfaces = {row.get("surface") for row in rep["quarantine"]}
        check(rep["enabled"] is True
              and {"journal", "rescache", "checkpoint"} <= surfaces
              and set(rep["counters"]) >= {"scans", "verified", "legacy",
                                           "corrupt", "quarantined",
                                           "repaired"},
              f"/admin/integrity: {rep}")
        families = {fam: _series(r2.port, f"fsm_integrity_{fam}_total")
                    for fam in ("scans", "verified", "legacy", "corrupt",
                                "quarantined", "repaired")}
        check(families["scans"] >= 1 and families["verified"] >= 1
              and families["quarantined"] >= 2,
              f"fsm_integrity_* on /metrics: {families}")
        _wait(lambda: _settled(client), "every journal intent and lease "
              "to settle")
        counts2 = r2.counts()
        check(counts1["b1"] > 0 and counts2["b1"] > 0
              and counts2["b2"] > 0,
              f"launches {counts1} before the kill, {counts2} after")
        print(f"[bitrot] (c) replica {r1.rid} killed -9 as rot-bms's "
              f"checkpoint after {BITROT_CHUNKS} delta chunks landed "
              f"({kill.t - t_submit:.3f} s after the submit; classic route, "
              f"node_batch {BITROT_NODE_BATCH}); the last delta "
              f"byte-flipped, the cache entry truncated, a flipped journal "
              f"intent planted; the reboot {r2.rid} ready "
              f"{t_ready - kill.t:.3f} s after the kill, its recovery line "
              f"'{m.group(0)}'; the drill healed to the last good chunk "
              f"and finished {walls['rot-bms']:.3f} s after the reboot "
              f"(the library call's {inp['bms wall']} s, cold and warm) "
              f"with patterns SHA-256 "
              f"== the library's; the TSR resubmit mined cold in "
              f"{rehit['rehit-tsr']:.3f} s with rules SHA-256 == the "
              f"library's; the scrubber quarantined an intent at rest in "
              f"{scrub_s:.3f} s; /admin/integrity lists "
              f"{len(rep['quarantine'])} records over {sorted(surfaces)}; "
              f"fsm_integrity_* {families}; card {card}", flush=True)
        for rep_, counts in ((r1, counts1), (r2, counts2)):
            print(f"[bitrot] replica {rep_.name} ({rep_.rid}): booted in "
                  f"{rep_.boot_s:.3f} s; B1 {counts['b1']}, B2 "
                  f"{counts['b2']}, B3 {counts['b3']} launches, "
                  f"max_memory_allocated {counts['peak']} B; card {card}",
                  flush=True)
    finally:
        mini.hook = None
        if r1.proc.poll() is None:
            r1.kill()
        rc = r2.stop() if r2 is not None else 0
        client.close()
        mini.close()
    check(rc == 0, f"replica bitrot-2 exited with {rc}:\n{r2.log()[-2000:]}")


def fault_phase(torch, card: str, inp: dict) -> None:
    """Phase 27: faults and bitrot.  ``inp``: phase 15's 1 % database and
    its rules' digest (``tsr 1%``); phase 5's database, minsup,
    serialization and walls (``bms``, ``bms payload``, ``bms wall``); the
    tenth of phase 9's database with its rules' serialization and wall
    (``tenth``)."""
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _resident_faults(torch, card, *inp["tsr 1%"])
    t_a = time.perf_counter() - t_phase
    _bitrot_service(card, inp, auto_pool_bytes(torch.device("cuda", 0)))
    print(f"[chaos] phase 27 {time.perf_counter() - t_phase:.1f} s "
          f"((a) {t_a:.1f} s); card {card}", flush=True)


def _phase_card(torch) -> str:
    """Phase 1 of a phase run alone: the card's name and power limit."""
    card = smi("name,power.limit")
    print(f"[card] nvidia-smi: {card} | torch: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def _fault_inputs(torch) -> dict:
    """Phase 27's inputs made through the library (the 1 % rules' digest
    from the host loop, which phase 15 holds equal to the resident
    route's)."""
    from spark_fsm_tpu_torch.data.synth import bms_webview2_like, kosarak_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    small = kosarak_like(scale=0.01, fast=True)
    small_want = digest(rules_text(mine_tsr_torch(
        small, 100, 0.5, max_side=None, resident="never")))
    bms = bms_webview2_like()
    minsup = abs_minsup(0.001, len(bms))
    t1 = time.perf_counter()
    got = mine_spade_torch(bms, minsup)
    torch.cuda.synchronize()
    bms_s = round(time.perf_counter() - t1, 3)
    tenth = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t1 = time.perf_counter()
    rules = mine_tsr_torch(tenth, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    tenth_s = round(time.perf_counter() - t1, 3)
    return {"tsr 1%": (small, small_want), "bms": (bms, minsup),
            "bms payload": SM.serialize_patterns(got), "bms wall": (bms_s,),
            "tenth": (tenth, SM.serialize_rules(rules), tenth_s)}


def phase27_only(torch) -> int:
    """``python3 chip_smoke.py --phase 27``: the card, then phase 27 on
    inputs made here through the library."""
    card = _phase_card(torch)
    t0 = time.perf_counter()
    inp = _fault_inputs(torch)
    print(f"[phase 27 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fault_phase(torch, card, inp)
    print(f"card: {card}")
    return 0


_SAMPLE_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})?\s+(\S+)$')


def parse_prometheus(text: str) -> dict:
    """``/metrics`` as ``{family: {label string: value}}`` (the reference's
    ``scripts/obs_smoke.py`` parser): every sample line is ``name[{labels}]
    value`` with a numeric value, and every family has a ``# TYPE`` line;
    anything else raises."""
    families: dict = {}
    types: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            types[name] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        check(m is not None, f"/metrics line {lineno} malformed: {line!r}")
        families.setdefault(m.group(1), {})[m.group(2) or ""] = float(
            m.group(3))
    for fam in families:
        base = re.sub(r"_(bucket|count|sum)$", "", fam)
        check(fam in types or base in types,
              f"/metrics family {fam} has samples but no # TYPE line")
    return families


def check_histograms(families: dict) -> None:
    """Every histogram series ends at +Inf and its buckets are cumulative."""
    for fam, rows in families.items():
        if not fam.endswith("_bucket"):
            continue
        by_series: dict = {}
        for labels, value in rows.items():
            le = re.search(r'le="([^"]*)"', labels)
            check(le is not None, f"{fam}{labels}: a bucket without le=")
            rest = re.sub(r',?le="[^"]*"', "", labels)
            by_series.setdefault(rest, []).append(
                (float("inf") if le.group(1) == "+Inf"
                 else float(le.group(1)), value))
        for rest, pairs in by_series.items():
            pairs.sort()
            counts = [v for _, v in pairs]
            check(pairs[-1][0] == float("inf") and counts == sorted(counts),
                  f"{fam}{rest}: buckets not cumulative to +Inf")


def _stats_of(port: int, uid: str) -> dict:
    return json.loads(_http(port, f"/status/{uid}")["data"].get("stats")
                      or "{}")


def _launch_spans(spans: list, site: str) -> list:
    return [s for s in spans if s["site"] == site]


def _oom_children(spans: list) -> tuple:
    """The launch span that took the ``resource_exhausted`` event and its
    half-width children (launch spans whose parent it is)."""
    hit = [s for s in spans for e in s.get("events", ())
           if e["name"] == "resource_exhausted"]
    check(len(hit) >= 1, f"no resource_exhausted event in the dump "
          f"({sorted({s['site'] for s in spans})})")
    parent = hit[0]
    kids = [s for s in spans if s.get("parent_id") == parent["span_id"]
            and s["site"] == parent["site"]]
    check(len(kids) == 2 and all(
        k["attrs"]["width"] == parent["attrs"]["width"] // 2 for k in kids),
        f"the OOM'd launch's children: {[k['attrs'] for k in kids]} under "
        f"{parent['attrs']}")
    return parent, kids


def _planes_reuse(card: str, port: int, paths: dict, inp: dict,
                  want: dict) -> dict:
    """Phase 28 (a): result reuse at size; returns the walls."""
    tsr = dict(algorithm="TSR_TPU", source="FILE", path=paths["tenth"],
               k="100", minconf="0.5", max_side="2")
    t_submit = {}
    for uid, tenant, where in (("acme-cold", "acme", "tenth"),
                               ("globex-lead", "globex", "small"),
                               ("globex-follow", "globex", "small")):
        t_submit[uid] = time.perf_counter()
        r = _http(port, "/train", uid=uid, tenant=tenant,
                  **dict(tsr, path=paths[where]))
        check(r["status"] == "started", f"/train {uid}: {r}")
    inflight = _http(port, "/admin/rescache")
    walls = _finish_walls(port, t_submit, {
        "acme-cold": ("rules", inp["tenth"][1]),
        "globex-lead": ("rules", want["pair"]),
        "globex-follow": ("rules", want["pair"])})
    stats = {uid: _stats_of(port, uid) for uid in t_submit}
    check("served_from_cache" not in stats["acme-cold"]
          and "served_from_cache" not in stats["globex-lead"],
          f"a cold job was served: {stats}")
    check(stats["globex-follow"].get("coalesced_into") == "globex-lead",
          f"the follower did not coalesce: {stats['globex-follow']}")
    # the entries publish after FINISHED: wait for them, not the status
    _wait(lambda: (_http(port, "/admin/rescache")["entries"] or 0) >= 2,
          "the cold and the pair's cache entries")
    served = {}
    for uid, params, kind, payload in (
            ("acme-hit", tsr, "rules", inp["tenth"][1]),
            ("acme-dom", dict(tsr, k=str(PLANES_DOM_K)), "rules",
             want["dom"]),
            ("bms-cold", dict(algorithm="SPADE_TPU", source="FILE",
                              path=paths["bms"],
                              support=str(inp["bms"][1])), "patterns",
             inp["bms payload"]),
            ("bms-dom", dict(algorithm="SPADE_TPU", source="FILE",
                             path=paths["bms"],
                             support=str(want["bms minsup"])), "patterns",
             want["bms dom"])):
        if uid == "bms-dom":
            _wait(lambda: (_http(port, "/admin/rescache")["entries"]
                           or 0) >= 3, "bms-cold's cache entry")
        t0 = time.perf_counter()
        r = _http(port, "/train", uid=uid, tenant="acme", **params)
        check(r["status"] == "started", f"/train {uid}: {r}")
        walls.update(_finish_walls(port, {uid: t0}, {uid: (kind, payload)}))
        served[uid] = _stats_of(port, uid).get("served_from_cache")
    check(served == {"acme-hit": "exact", "acme-dom": "dominated",
                     "bms-cold": None, "bms-dom": "dominated"},
          f"served modes {served}")
    fams = parse_prometheus(_metrics_text(port))
    counts = {f: sum(fams[f"fsm_rescache_{f}_total"].values())
              for f in ("hits", "misses", "coalesced", "dominated_serves")}
    check(counts["hits"] >= 1 and counts["coalesced"] >= 1
          and counts["dominated_serves"] >= 2,
          f"fsm_rescache_* after the drill: {counts}")
    print(f"[planes] (a) result reuse over HTTP (one Miner worker, FILE "
          f"sources): the tenth's Kosarak-shaped TSR (k=100, minconf 0.5, "
          f"max_side=2) cold for acme {walls['acme-cold']:.3f} s (the "
          f"library's {inp['tenth'][2]} s); while it ran, an identical "
          f"pair of the 1 % database's TSR (the same parameters) for "
          f"globex coalesced, leader "
          f"{walls['globex-lead']:.3f} s, follower "
          f"{walls['globex-follow']:.3f} s (in flight at submit: "
          f"{inflight.get('inflight_followers')} follower); the repeat an "
          f"exact hit in {walls['acme-hit']:.3f} s; k={PLANES_DOM_K} "
          f"dominated in {walls['acme-dom']:.3f} s; BMS SPADE at 0.1 % "
          f"cold {walls['bms-cold']:.3f} s (the library's "
          f"{inp['bms wall'][0]} s), at {PLANES_DOM_MINSUP:.1%} dominated "
          f"in {walls['bms-dom']:.3f} s; every body SHA-256 == the "
          f"library mine at its own parameters; fsm_rescache_* {counts}; "
          f"card {card}", flush=True)
    return walls


def _metrics_text(port: int) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=600) as resp:
        return resp.read().decode()


def _planes_usage(card: str, port: int, counts, stage: str) -> dict:
    """Phase 28 (b): per-tenant usage against the broker's counters and
    the B2 wrapper's own count; returns the sums."""
    fams = parse_prometheus(_metrics_text(port))
    usage_launches = fams["fsm_usage_launches_total"]
    fusion = sum(fams["fsm_fusion_launches_total"].values())
    per_tenant = {t: sum(v for k, v in usage_launches.items()
                         if f'tenant="{t}"' in k)
                  for t in ("acme", "globex", "default")}
    traffic = sum(fams["fsm_usage_traffic_units_total"].values())
    broker = _http(port, "/admin/stats")["fusion"]
    check(sum(usage_launches.values()) == fusion,
          f"usage launches {per_tenant} != fsm_fusion_launches_total "
          f"{fusion}")
    check(traffic == broker.get("traffic_units"),
          f"usage traffic {traffic} != the broker's "
          f"{broker.get('traffic_units')}")
    time.sleep(0.3)  # one more write of the child's counts
    b2 = counts()["b2"]
    print(f"[planes] (b) usage {stage}: fsm_usage_launches_total per "
          f"tenant {per_tenant} sums to {sum(usage_launches.values()):g} == "
          f"fsm_fusion_launches_total {fusion:g}; traffic units {traffic:g} "
          f"== the broker's; the B2 wrapper's own launches in the child "
          f"{b2}; card {card}", flush=True)
    return {"usage": sum(usage_launches.values()), "fusion": fusion,
            "b2": b2}


def _planes_recorder(card: str, port: int) -> None:
    """Phase 28 (c): the flight recorder and the cluster plane."""
    from spark_fsm_tpu_torch.utils import faults, retry

    fams = parse_prometheus(_metrics_text(port))
    check_histograms(fams)
    for fam, sites in (("fsm_fault_site_calls_total", faults.KNOWN_SITES),
                       ("fsm_fault_site_injected_total", faults.KNOWN_SITES),
                       ("fsm_retry_attempts_total", retry.KNOWN_SITES)):
        got = {m.group(1) for k in fams.get(fam, {})
               for m in [re.search(r'site="([^"]*)"', k)] if m}
        check(set(sites) <= got,
              f"{fam}: no series for {sorted(set(sites) - got)}")
    stats = _stats_of(port, "acme-cold")
    dump = _http(port, "/admin/trace/acme-cold")
    spans = dump["spans"]
    sites = {}
    for s in spans:
        sites[s["site"]] = sites.get(s["site"], 0) + 1
    check(sites.get("job", 0) >= 1 and sites.get("job.mine", 0) >= 1,
          f"acme-cold's dump lacks the job or mine span: {sites}")
    check(sites.get("tsr.prep", 0) + sites.get("tsr.launch", 0)
          == stats["kernel_launches"],
          f"acme-cold: tsr.prep + tsr.launch spans {sites} != "
          f"kernel_launches {stats['kernel_launches']}")
    check(sites.get("fusion.launch", 0) == stats.get("fusion_launches", 0),
          f"acme-cold: fusion.launch spans {sites.get('fusion.launch')} != "
          f"fusion_launches {stats.get('fusion_launches')}")
    launches = (_launch_spans(spans, "tsr.launch")
                + _launch_spans(spans, "fusion.launch"))
    check(launches and all("predicted_s" in s["attrs"]
                           and s.get("duration_s") is not None
                           for s in launches),
          "a launch span without predicted_s or a duration")
    check(sites.get("tsr.dispatch", 0) >= 1, f"no tsr.dispatch: {sites}")
    marks = {m: sites.get(f"lifecycle.{m}", 0)
             for m in ("admitted", "started", "settled")}
    check(dump.get("merged") is True and all(marks.values()),
          f"acme-cold's merged timeline marks {marks}")
    bms = {}
    for s in _http(port, "/admin/trace/bms-cold")["spans"]:
        bms[s["site"]] = bms.get(s["site"], 0) + 1
    check(bms.get("queue.dispatch") == 1 and bms.get("queue.readback", 0)
          >= 1, f"bms-cold's dump {bms}")
    cluster = _http(port, "/admin/cluster")
    check(cluster.get("enabled") is True
          and cluster["totals"]["replicas"] == 1
          and any(r.get("self") for r in cluster["replicas"]),
          f"/admin/cluster {cluster}")
    slo = _http(port, "/admin/slo")
    e2e = slo["priorities"]["normal"]["e2e"]
    check(e2e["count"] >= 7 and "p99" in e2e
          and slo["tenants"]["acme"]["count"] >= 1
          and slo["tenants"]["globex"]["count"] >= 1,
          f"/admin/slo {slo}")
    print(f"[planes] (c) flight recorder: /metrics parsed ({len(fams)} "
          f"families, histograms cumulative), every fault site "
          f"({len(faults.KNOWN_SITES)}) and retry policy "
          f"({len(retry.KNOWN_SITES)}) has its series; acme-cold's merged "
          f"dump {dict(sorted(sites.items()))}: tsr.prep + tsr.launch == "
          f"kernel_launches {stats['kernel_launches']}, fusion.launch == "
          f"fusion_launches {stats.get('fusion_launches')}, each launch "
          f"span with predicted_s and a duration, lifecycle marks {marks}; "
          f"bms-cold's dump {dict(sorted(bms.items()))}; /admin/cluster "
          f"{cluster['totals']}; /admin/slo normal e2e {e2e}, tenants "
          f"acme {slo['tenants']['acme']}, globex "
          f"{slo['tenants']['globex']}; card {card}", flush=True)


def _planes_oom(torch, card: str, port: int, paths: dict, inp: dict) -> None:
    """Phase 28 (d): ``device.oom`` armed through ``/admin/faults`` around
    the 1 % TSR job, then the same drill on the library's direct path in
    this process."""
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.utils import faults, obs
    from spark_fsm_tpu_torch.utils.canonical import rules_text

    small, small_want = inp["tsr 1%"]
    code, _, body = _post_code(port, "/admin/faults", action="arm",
                               site="device.oom", nth="1")
    check(code == 200, f"the child refused the fault arm: {body}")
    t0 = time.perf_counter()
    r = _http(port, "/train", uid="oom-small", algorithm="TSR_TPU",
              source="FILE", path=paths["small"], k="100", minconf="0.5",
              resident="never")
    check(r["status"] == "started", f"/train oom-small: {r}")
    st = _job_until_terminal(port, "oom-small")
    wall = time.perf_counter() - t0
    check(st["status"] == "finished",
          f"oom-small failed: {st['data'].get('error')}")
    _post_code(port, "/admin/faults", action="disarm", site="device.oom")
    got = rules_text(SM.deserialize_rules(
        _http(port, "/get/rules", uid="oom-small")["data"]["rules"]))
    check(digest(got) == small_want,
          "oom-small's rules differ from the library's by SHA-256")
    stats = _stats_of(port, "oom-small")
    check(stats.get("degraded_launches", 0) >= 1,
          f"oom-small degraded no launch: {stats}")
    parent, kids = _oom_children(
        _http(port, "/admin/trace/oom-small")["spans"])
    # the same drill on the direct path (no broker): the event lands on
    # B2's own launch span
    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=4)
    lib: dict = {}
    try:
        with faults.injected("device.oom", nth=1), obs.trace("planes-oom"):
            rules = mine_tsr_torch(small, 100, 0.5, max_side=None,
                                   resident="never", stats_out=lib)
        torch.cuda.synchronize()
        lparent, lkids = _oom_children(obs.trace_dump("planes-oom")["spans"])
    finally:
        obs.configure_tracing(False)
        obs.clear_traces()
    check(digest(rules_text(rules)) == small_want
          and lib.get("degraded_launches", 0) >= 1,
          f"the library's OOM drill: {lib.get('degraded_launches')} "
          f"degraded launches")
    check(lparent["site"] == "tsr.launch"
          and lparent["attrs"]["point"] == "kernel",
          f"the library's OOM landed on {lparent['site']} "
          f"{lparent['attrs']}")
    print(f"[planes] (d) device.oom nth=1 armed through /admin/faults: the "
          f"1 % Kosarak-shaped TSR job (k=100, minconf 0.5, "
          f"resident='never') finished in {wall:.3f} s with rules SHA-256 "
          f"== the library's, degraded_launches "
          f"{stats['degraded_launches']}; the event on its "
          f"{parent['site']} span (km {parent['attrs']['km']}, width "
          f"{parent['attrs']['width']}) with children of width "
          f"{[k['attrs']['width'] for k in kids]}; the library's direct "
          f"path: tsr.launch point=kernel width "
          f"{lparent['attrs']['width']} -> "
          f"{[k['attrs']['width'] for k in lkids]}, degraded_launches "
          f"{lib['degraded_launches']}, rules SHA-256 == the library's; "
          f"card {card}", flush=True)


def planes_phase(torch, card: str, inp: dict) -> None:
    """Phase 28: result reuse, usage metering and the flight recorder with
    its cluster plane, in one child of the port's service on the card.
    ``inp`` is phase 27's."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    os.makedirs(PLANES_DIR, exist_ok=True)
    paths = {}
    for name, db in (("tenth", inp["tenth"][0]), ("bms", inp["bms"][0]),
                     ("small", inp["tsr 1%"][0])):
        paths[name] = os.path.join(PLANES_DIR, f"{name}.spmf")
        with open(paths[name], "w") as fh:
            fh.write(format_spmf(db))
    cfg = {"fault_injection": True,
           "observability": {"trace": True, "trace_max_spans": 1 << 15,
                             "spine_flush_spans": 8,
                             "spine_max_chunks": 1 << 14},
           "cluster": {"enabled": True, "lease_ttl_s": 5.0},
           "rescache": {"enabled": True},
           "usage": {"enabled": True, "flush_every_s": 0.0},
           "fusion": {"enabled": True},
           "fairness": {"enabled": True,
                        "weights": {"acme": 2.0, "globex": 1.0}},
           "engine": {"pool_bytes": auto_pool_bytes(
               torch.device("cuda", 0))}}
    child = Replica("planes", cfg, PLANES_DIR)
    try:
        # the library mines at the requests' own parameters, while the
        # child boots
        t0 = time.perf_counter()
        tenth = inp["tenth"][0]
        bms_dom = abs_minsup(PLANES_DOM_MINSUP, len(inp["bms"][0]))
        want = {"pair": SM.serialize_rules(mine_tsr_torch(
                    inp["tsr 1%"][0], 100, 0.5, max_side=2)),
                "dom": SM.serialize_rules(mine_tsr_torch(
                    tenth, PLANES_DOM_K, 0.5, max_side=2)),
                "bms minsup": bms_dom,
                "bms dom": SM.serialize_patterns(mine_spade_torch(
                    inp["bms"][0], bms_dom))}
        torch.cuda.synchronize()
        lib_s = time.perf_counter() - t0
        child.ready()
        _planes_reuse(card, child.port, paths, inp, want)
        usage1 = _planes_usage(card, child.port, child.counts,
                               "after the TSR and SPADE jobs")
        rep = _http(child.port, "/admin/usage")
        tenants = rep.get("tenants", {})
        check(rep.get("enabled") is True and rep.get("top_jobs")
              and all(tenants.get(t, {}).get("launches", 0) > 0
                      for t in ("acme", "globex"))
              and tenants["acme"].get("avoided_device_seconds", 0) > 0,
              f"/admin/usage {json.dumps(rep)[:2000]}")
        print(f"[planes] (b) /admin/usage: acme {tenants['acme']}, globex "
              f"{tenants['globex']}, top jobs "
              f"{[j.get('uid') for j in rep['top_jobs']]}; card {card}",
              flush=True)
        _planes_recorder(card, child.port)
        _planes_oom(torch, card, child.port, paths, inp)
        usage2 = _planes_usage(card, child.port, child.counts,
                               "after the OOM job")
        counts = child.counts()
    finally:
        rc = child.stop()
    check(rc == 0, f"the planes child exited with {rc}:\n"
          f"{child.log()[-2000:]}")
    print(f"[planes] the child booted in {child.boot_s:.3f} s (the library "
          f"mines beside its boot {lib_s:.3f} s); B1 {counts['b1']}, B2 "
          f"{counts['b2']}, B3 {counts['b3']} launches (usage "
          f"{usage1['usage']:g} / {usage2['usage']:g} launches, broker "
          f"{usage1['fusion']:g} / {usage2['fusion']:g}), "
          f"max_memory_allocated {counts['peak']} B; phase 28 "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)


def phase28_only(torch) -> int:
    """``python3 chip_smoke.py --phase 28``: the card, then phase 28 on
    phase 27's inputs made here through the library."""
    card = _phase_card(torch)
    t0 = time.perf_counter()
    inp = _fault_inputs(torch)
    print(f"[phase 28 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    planes_phase(torch, card, inp)
    print(f"card: {card}")
    return 0


def _storm_helpers():
    """``tests/_torch_storm.py`` and ``tests/_torch_minies.py`` (neither
    imports jax or the reference)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_minies
    import _torch_storm

    return _torch_storm, _torch_minies


def _fleet_cfg(store_port: int, pool: int) -> dict:
    """A phase-29 replica: ``scripts/autoscale_smoke.py``'s [fairness] and
    [autoscale] beside ``scripts/storm_smoke.py``'s store guard, leases,
    faults and tracing, the store reached at ``store_port``."""
    return {"fault_injection": True,
            "service": {"port": 0, "miner_workers": 1, "queue_depth": 16},
            "store": {"backend": "redis", "host": "127.0.0.1",
                      "port": store_port, "timeout_s": 1.0},
            # the leader counts the rows of heartbeats younger than one
            # heartbeat (at least 0.5 s): beats of 0.25 s keep a busy
            # replica's row in its view
            "cluster": {"enabled": True, "lease_ttl_s": REPLICA_TTL_S,
                        "heartbeat_s": 0.25,
                        "recover_every_s": REPLICA_RECOVER_S},
            "storeguard": {"enabled": True, "probe_every_s": 0.25,
                           "down_after": 1, "spool_max_entries": 4096,
                           "stall_max_s": 120.0},
            "observability": {"trace": True, "spine_flush_spans": 8},
            "fairness": {"enabled": True, "tenant_depth": 4},
            "autoscale": {"enabled": True, "min_replicas": 3,
                          "max_replicas": 4, "up_queue_per_worker": 1.0,
                          "hold_s": 0.5, "cooldown_s": 2.0,
                          "decide_every_s": 0.25, "leader_ttl_s": 1.0,
                          "drain_timeout_s": 120.0},
            "engine": {"fused": "queue", "pool_bytes": pool}}


def _submit_all(port: int, jobs: list, job: dict) -> tuple:
    """POST each (uid, extra parameters) in ``jobs`` to ``port``'s /train
    with ``job``'s parameters: (submit times of the admitted uids, the
    sheds as (uid, Retry-After, error))."""
    t_submit, sheds = {}, []
    for uid, extra in jobs:
        t = time.perf_counter()
        code, retry_after, body = _post_code(port, "/train", uid=uid,
                                             **job, **extra)
        if code == 429:
            sheds.append((uid, retry_after, body["data"].get("error", "")))
        else:
            check(code == 200 and body["status"] == "started",
                  f"/train {uid}: {code} {body}")
            t_submit[uid] = t
    return t_submit, sheds


def _fleet_walls(port: int, t_submit: dict, payload: str) -> list:
    """Each uid's submit-to-finished wall, every body SHA-256 == payload."""
    walls = _finish_walls(port, t_submit, {u: ("patterns", payload)
                                           for u in t_submit})
    return [round(walls[u], 3) for u in t_submit]


def fleet_boot(torch, inp: dict) -> dict:
    """Phase 29's FILE source, store (a SnoopingMiniRedis served from
    this process), one NetProxy a replica and the three replicas,
    started and not waited for: the whole run starts them before phase
    28, so they boot beside it.  ``inp``: phase 5's database
    (``bms``)."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes
    from spark_fsm_tpu_torch.service.resp import RespClient
    from spark_fsm_tpu_torch.utils.netproxy import NetProxy

    os.makedirs(FLEET_DIR, exist_ok=True)
    path = os.path.join(FLEET_DIR, "bms.spmf")
    with open(path, "w") as fh:
        fh.write(format_spmf(inp["bms"][0]))
    pool = auto_pool_bytes(torch.device("cuda", 0)) // 3
    mini = _trigger_redis()
    proxies = [NetProxy("127.0.0.1", mini.port) for _ in range(3)]
    reps = [Replica(f"fleet-{n}", _fleet_cfg(p.port, pool), FLEET_DIR)
            for n, p in zip("abc", proxies)]
    return {"path": path, "pool": pool, "mini": mini, "proxies": proxies,
            "client": RespClient(port=mini.port),   # straight to the store
            "reps": reps}


def fleet_stop(fleet: dict) -> list:
    """Stop what :func:`fleet_boot` started; the replicas' exit codes."""
    rcs = [r.stop() for r in fleet["reps"]]
    for p in fleet["proxies"]:
        p.close()
    fleet["client"].close()
    fleet["mini"].close()
    return rcs


def fleet_phase(torch, card: str, inp: dict, fleet: dict = None) -> None:
    """Phase 29: the elastic fleet (A19, then A20, on one fleet).  ``inp``:
    phase 5's database and minsup (``bms``), serialization (``bms
    payload``) and library walls (``bms wall``); ``fleet``:
    :func:`fleet_boot`'s result when the fleet was started earlier."""
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    storm, _ = _storm_helpers()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _host_load("phase 29")
    STORE_GC.install()
    early = fleet is not None
    fleet = fleet or fleet_boot(torch, inp)
    bms, minsup = inp["bms"]
    path, pool, client = fleet["path"], fleet["pool"], fleet["client"]
    mini, proxies, reps = fleet["mini"], fleet["proxies"], fleet["reps"]
    A, B, C = reps
    lib = inp["bms wall"]
    try:
        # the storm's second template, phase 28's dominated minsup: its
        # library text, mined while the replicas boot
        dom = abs_minsup(FLEET_DOM_MINSUP, len(bms))
        t0 = time.perf_counter()
        dom_text = patterns_text(mine_spade_torch(bms, dom))
        torch.cuda.synchronize()
        dom_s = time.perf_counter() - t0
        for r in reps:
            r.ready()
        _wait(lambda: _http(A.port, "/admin/cluster").get(
            "totals", {}).get("replicas") == 3, "the fleet of three")
        print(f"[fleet] phase 29: replicas a, b, c (--device cuda, pool "
              f"{pool} B each, each behind its own NetProxy to one "
              f"SnoopingMiniRedis) answered "
              f"{[round(r.boot_s, 3) for r in reps]} s after their start"
              f"{' (beside phase 28)' if early else ''}; ids "
              f"{[r.rid for r in reps]}; the 0.2 % library mine "
              f"{dom_s:.3f} s; card {card}", flush=True)
        job = dict(algorithm="SPADE_TPU", source="FILE", path=path,
                   support=str(minsup))

        # (a) fairness: flood's ten past its cap of 4 shed with its own
        # Retry-After; quiet's three are admitted and served with parity
        t_a, sheds = _submit_all(A.port, [
            (f"flood-{i}", {"tenant": "flood"}) for i in range(10)], job)
        check(sheds, "the flood tenant never hit its cap")
        for uid, retry_after, error in sheds:
            check(retry_after is not None and retry_after.isdigit()
                  and int(retry_after) >= 1 and "tenant 'flood'" in error,
                  f"shed {uid}: Retry-After {retry_after!r} {error!r}")
        t_q, quiet_sheds = _submit_all(A.port, [
            (f"quiet-{i}", {"tenant": "quiet"}) for i in range(3)], job)
        check(not quiet_sheds, f"the quiet tenant was shed: {quiet_sheds}")
        walls = _fleet_walls(A.port, {**t_a, **t_q}, inp["bms payload"])
        print(f"[fleet] (a) fairness: flood admitted {len(t_a)} and shed "
              f"{len(sheds)} (429, Retry-After {[s[1] for s in sheds]} s, "
              f"\"{sheds[0][2][:60]}...\"); quiet admitted 3 during the "
              f"flood; every body SHA-256 == phase 5's; submit-to-finished "
              f"flood {walls[:len(t_a)]} s, quiet {walls[len(t_a):]} s "
              f"against the library's {lib} s; card {card}", flush=True)

        # (b) scale-up: four jobs on each replica, a tenant a replica
        seq0 = max(int((_http(r.port, "/admin/autoscale").get("desired")
                        or {}).get("seq", 0)) for r in reps)
        t_load = time.perf_counter()
        t_b = {}
        for name, r in zip("ABC", reps):
            got, shed_b = _submit_all(r.port, [
                (f"load-{name}-{i}", {"tenant": f"bulk{name}"})
                for i in range(4)], job)
            check(not shed_b, f"load on {name} was shed: {shed_b}")
            t_b.update(got)
        decision = None
        while decision is None:
            for r in reps:
                d = _http(r.port, "/admin/autoscale").get("desired") or {}
                if d.get("dir") == "up" and int(d.get("seq", 0)) > seq0:
                    decision = d
                    break
            check(time.perf_counter() - t_load < REPLICA_WAIT_S,
                  "no scale-up decision under the load")
            time.sleep(0.05)
        decide_s = time.perf_counter() - t_load
        check(decision["desired"] == decision["replicas"] + 1
              and 2 <= decision["replicas"] <= 3
              and decision["desired"] <= 4,
              f"the scale-up decision {decision}")
        walls = _fleet_walls(A.port, t_b, inp["bms payload"])
        print(f"[fleet] (b) scale-up: leader {decision['leader']} published "
              f"desired {decision['desired']} over {decision['replicas']} "
              f"live replicas ({decision['reason']!r}) {decide_s:.3f} s "
              f"after the first load submit; the 12 load jobs' bodies "
              f"SHA-256 == phase 5's, submit-to-finished {walls} s; "
              f"card {card}", flush=True)

        # (c) forced scale-down: C drains its queue to A and B and exits
        steals0 = sum(_series(r.port, "fsm_steal_attempts_total",
                              'outcome="stolen"') for r in (A, B))
        t_c, shed_c = _submit_all(C.port, [
            (f"drain-{i}", {"tenant": "quiet", "priority": "low"})
            for i in range(4)], job)
        check(not shed_c, f"the drain jobs were shed: {shed_c}")
        t_drain = time.perf_counter()
        code, _, body = _post_code(C.port, "/admin/drain", exit="1")
        check(code == 200 and body["status"] == "draining",
              f"/admin/drain: {code} {body}")
        try:
            rc = C.proc.wait(timeout=REPLICA_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        drain_s = time.perf_counter() - t_drain
        check(rc == 0, f"the drained replica C exited with {rc}:\n"
              f"{C.log()[-2000:]}")
        walls = _fleet_walls(A.port, t_c, inp["bms payload"])
        for uid in t_c:
            check(_terminals(client, uid) == ["finished"],
                  f"{uid} settled {_terminals(client, uid)}")
        steals = sum(_series(r.port, "fsm_steal_attempts_total",
                             'outcome="stolen"') for r in (A, B)) - steals0
        _wait(lambda: _http(A.port, "/admin/cluster").get(
            "totals", {}).get("replicas") == 2, "the fleet view of two")
        c_counts = C.counts()
        print(f"[fleet] (c) forced scale-down: C took 4 low-priority jobs, "
              f"drained and exited rc 0 {drain_s:.3f} s after the drain "
              f"request; A and B stole {steals:g}; each job settled once, "
              f"bodies SHA-256 == phase 5's, submit-to-finished {walls} s; "
              f"/admin/cluster shows 2 replicas; C launched B1 "
              f"{c_counts['b1']} times, peak {c_counts['peak']} B; "
              f"card {card}", flush=True)

        # (d) the seeded storm on the survivors and their proxies
        templates = [(job, patterns_text(SM.deserialize_patterns(
                          inp["bms payload"]))),
                     (dict(job, support=str(dom)), dom_text)]
        accepted, oracles = set(), {}
        t_storm = time.perf_counter()

        def say(msg):
            print(f"[fleet] (d) {msg}", flush=True)

        shed_d, events = storm.storm_round(
            proxies[:2], [A.port, B.port], FLEET_STORM_SEED, templates,
            accepted, oracles, log=say)
        out = storm.check_invariants(
            client, accepted, oracles, [A.port, B.port], mini.lease_sets,
            f"seed {FLEET_STORM_SEED}", log=say, quiesce_s=REPLICA_WAIT_S)
        check(out["parity_ok"] >= 1, f"no storm job finished: {out}")
        check(not client.keys("fsm:admission:*"),
              "an admission marker was left after the storm")
        print(f"[fleet] (d) storm seed {FLEET_STORM_SEED}, "
              f"{storm.STORM_STEPS} steps over A and B: events {events}; "
              f"accepted {out['accepted']}, shed {shed_d}; every accepted "
              f"job settled once, every finished body's text == the "
              f"library's (SHA-256) ({out['parity_ok']}), lease tokens "
              f"never fell ({out['lease_sets']} lease writes), zero journal "
              f"intents, leases, admission markers and spool entries; "
              f"fence rejections {out['fence_rejections']}, replays ok "
              f"{out['replays_ok']}, replays refused "
              f"{out['replays_refused']}, stalls {out['stalls']}; the round "
              f"and its checks {time.perf_counter() - t_storm:.1f} s; card "
              f"{card}", flush=True)

        # (e) the planes' families on the survivors
        fams = ("fsm_autoscale_leader", "fsm_autoscale_desired_replicas",
                "fsm_autoscale_evals_total", "fsm_autoscale_decisions_total",
                "fsm_tenant_queue_depth", "fsm_tenant_admitted_total",
                "fsm_tenant_sheds_total", "fsm_tenant_dequeued_total",
                "fsm_replica_drains_total", "fsm_storeguard_probes_total",
                "fsm_storeguard_spool_entries", "fsm_storeguard_replays_total",
                "fsm_storeguard_stalls_total",
                "fsm_storeguard_transitions_total")
        for r in (A, B):
            text = storm.scrape(r.port)
            for fam in fams:
                storm.series_sum(text, fam)
        flood_sheds = _series(A.port, "fsm_tenant_sheds_total",
                              'tenant="flood"')
        check(flood_sheds >= len(sheds),
              f"fsm_tenant_sheds_total{{tenant=flood}} {flood_sheds}")
        counts = [r.counts() for r in (A, B)]
    finally:
        rcs = fleet_stop(fleet)
        _heartbeats(reps, "phase 29")
    check(rcs[:2] == [0, 0], f"the survivors exited with {rcs[:2]}")
    print(f"[fleet] (e) {len(fams)} fsm_autoscale_*, fsm_tenant_*, "
          f"fsm_replica_drains_* and fsm_storeguard_* families live on A "
          f"and B (flood sheds on A {flood_sheds:g}); launches B1/B2/B3 "
          f"and peak: A {counts[0]}, B {counts[1]}, C {c_counts}; phase 29 "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)


def _bms_inputs(torch) -> dict:
    """Phase 5's database, minsup, serialization and wall, through the
    library."""
    from spark_fsm_tpu_torch.data.synth import bms_webview2_like
    from spark_fsm_tpu_torch.data.vertical import abs_minsup
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch
    from spark_fsm_tpu_torch.service import model as SM

    bms = bms_webview2_like()
    minsup = abs_minsup(0.001, len(bms))
    t1 = time.perf_counter()
    got = mine_spade_torch(bms, minsup)
    torch.cuda.synchronize()
    return {"bms": (bms, minsup), "bms payload": SM.serialize_patterns(got),
            "bms wall": (round(time.perf_counter() - t1, 3),)}


def phase29_only(torch) -> int:
    """``python3 chip_smoke.py --phase 29``: the card, then phase 29 on
    phase 5's inputs made here through the library."""
    card = _phase_card(torch)
    t0 = time.perf_counter()
    inp = _bms_inputs(torch)
    print(f"[phase 29 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fleet_phase(torch, card, inp)
    print(f"card: {card}")
    return 0


class _PollRecord:
    """A record of a ``poll()``-shaped consumer: its value and offset."""

    def __init__(self, value, offset):
        self.value, self.offset = value, offset


class _FakePolls:
    """kafka-python's ``poll()`` shape over a list of polls."""

    def __init__(self, polls):
        self._polls = list(polls)

    def poll(self, timeout_ms=None):
        return self._polls.pop(0) if self._polls else {}


def _sources_jobs(card: str, port: int, inp: dict) -> None:
    """Phase 30 (a): phase 5's database as a sqlite table (``table=`` and
    ``query=``), a Piwik export and Elasticsearch documents, each trained
    over HTTP and held to phase 5's body by SHA-256."""
    _, minies = _storm_helpers()
    bms, minsup = inp["bms"]
    t0 = time.perf_counter()
    clicks = os.path.join(SOURCES_DIR, "clicks.sqlite")
    piwik = os.path.join(SOURCES_DIR, "piwik.sqlite")
    for f in (clicks, piwik):
        if os.path.exists(f):
            os.remove(f)
    minies.write_clicks(clicks, bms)
    minies.write_piwik(piwik, bms)
    docs = minies.es_docs(bms)
    write_s = time.perf_counter() - t0
    r = _http(port, "/register/item", group="grp")
    check(r["status"] == "finished", f"/register/item: {r}")
    job = dict(algorithm="SPADE_TPU", support=str(minsup))
    with minies.serve() as es_url:
        minies.MiniES.docs = docs
        for name, params in (
                ("sql table", dict(source="JDBC", db=clicks, table="clicks")),
                ("sql query", dict(source="JDBC", db=clicks,
                                   query="SELECT * FROM clicks")),
                ("piwik", dict(source="PIWIK", db=piwik, idsite="1")),
                ("elastic", dict(source="ELASTIC", url=es_url,
                                 index="clicks",
                                 page_size=str(SOURCES_ES_PAGE)))):
            uid = "src-" + name.replace(" ", "-")
            st, wall = _train_wait(port, uid, **job, **params)
            stats = json.loads(st["data"]["stats"])
            body = _http(port, "/get/patterns", uid=uid)["data"]["patterns"]
            check(digest(body) == digest(inp["bms payload"]),
                  f"the {name} source's body differs from phase 5's by "
                  f"SHA-256")
            check(stats.get("sequences") == len(bms),
                  f"the {name} source read {stats.get('sequences')} "
                  f"sequences")
            print(f"[sources] (a) {name}: {len(docs)} rows, "
                  f"{stats['sequences']} sequences; body SHA-256 == phase "
                  f"5's; submit-to-finished {wall:.3f} s (dataset_s "
                  f"{stats.get('dataset_s')}, mine_s {stats.get('mine_s')}) "
                  f"against the library's mine {inp['bms wall']} s; "
                  f"card {card}", flush=True)
    print(f"[sources] (a) the three layouts written in {write_s:.1f} s "
          f"(ELASTIC page_size {SOURCES_ES_PAGE}: "
          f"{-(-len(docs) // SOURCES_ES_PAGE)} pages)", flush=True)


def _remote_entry(card: str, remote_port: int, inp: dict) -> None:
    """Phase 30 (b): train -> status -> get of the tenth's TSR over the
    actor protocol's socket, a prediction task, a malformed line."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.ops.rule_trie import predict_host
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service.remote import RemoteClient

    tenth, payload, lib_s = inp["tenth"][:3]
    path = os.path.join(SOURCES_DIR, "tenth.spmf")
    with open(path, "w") as fh:
        fh.write(format_spmf(tenth))
    client = RemoteClient(port=remote_port, timeout=600)
    try:
        t0 = time.perf_counter()
        resp = client.request("train", {
            "algorithm": "TSR_TPU", "source": "FILE", "path": path,
            "k": "100", "minconf": "0.5", "max_side": "2"})
        check(resp["status"] == "started", f"remote train: {resp}")
        uid = resp["data"]["uid"]
        while True:
            st = client.request("status", {"uid": uid})
            if st["status"] in ("finished", "failure"):
                break
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        check(st["status"] == "finished", f"remote TSR job: {st}")
        got = client.request("get:rules", {"uid": uid})
        check(digest(got["data"]["rules"]) == digest(payload),
              "the socket's rules differ from the library's by SHA-256")
        rules = SM.deserialize_rules(payload)
        # the antecedent whose prefix has the most candidates
        prefix = max((sorted(r[0]) for r in rules), key=lambda p: (
            len(predict_host(rules, p, 1 << 30)), p))
        pred = client.request("get:prediction", {
            "uid": uid, "items": ",".join(map(str, prefix))})
        check(pred["status"] == "finished", f"remote prediction: {pred}")
        want = predict_host(rules, prefix, 1 << 30)
        check(json.loads(pred["data"]["predictions"]) == want,
              f"the socket's prediction at {prefix} differs from "
              f"predict_host's")
        client._file.write(b"this is not json\n")
        client._file.flush()
        bad = json.loads(client._file.readline())
        check(bad["status"] == "failure"
              and "malformed" in bad["data"]["error"],
              f"the malformed line's reply {bad}")
        after = client.request("status", {"uid": uid})
        check(after["task"] == "status" and after["status"] == "finished",
              f"the connection after the malformed line: {after}")
    finally:
        client.close()
    print(f"[sources] (b) remote entry: TSR_TPU k=100 minconf 0.5 "
          f"max_side=2 on the tenth ({len(tenth)} sequences, FILE) over the "
          f"socket train -> status -> get in {wall:.3f} s against the "
          f"library's {lib_s} s; {len(rules)} rules SHA-256 == the "
          f"library's; get:prediction at {prefix}: {len(want)} candidates "
          f"== predict_host's; a malformed line failed cleanly and the "
          f"connection answered after it; card {card}", flush=True)


def _stream_consumer(torch, card: str, inp: dict) -> None:
    """Phase 30 (c): phase 17's stream through a fake poll()-shaped
    consumer, ``KafkaFetch(on_bad="skip")`` and ``PollConsumer`` into the
    port's ``IncrementalWindowMiner`` on the card."""
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.streaming.consumer import PollConsumer
    from spark_fsm_tpu_torch.streaming.incremental import (
        IncrementalWindowMiner)
    from spark_fsm_tpu_torch.streaming.kafka import KafkaFetch
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    texts, want, push_walls = (inp["stream texts"], inp["stream digests"],
                               inp["stream walls"])
    polls = []
    for i, text in enumerate(texts):
        poll = {f"p{i % 2}": [_PollRecord(text.encode(), i)]}
        if i == STREAM_POISON_POLL:
            poll[f"p{(i + 1) % 2}"] = [_PollRecord(b"\xff poison", i)]
        polls.append(poll)
    fetch = KafkaFetch(_FakePolls(polls), on_bad="skip")
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    walls, b1, held = [], [], []
    t_poll = [time.perf_counter()]

    def push(batch):
        PS.pair_supports.launches = 0
        got = inc.push(batch)
        torch.cuda.synchronize()
        b1.append(PS.pair_supports.launches)
        return got

    def on_result(patterns):
        walls.append(round(time.perf_counter() - t_poll[0], 3))
        n = len(walls)
        if n in want:
            check(digest(patterns_text(patterns)) == want[n],
                  f"poll {n}: the consumer's window differs from phase "
                  f"17's by SHA-256")
            held.append(n)
        t_poll[0] = time.perf_counter()

    pc = PollConsumer(fetch, push, poll_interval_s=0, on_result=on_result)
    t_poll[0] = time.perf_counter()
    pc.run(max_polls=len(polls))
    check(pc.stats["batches"] == len(polls) and held == sorted(want),
          f"the consumer pushed {pc.stats['batches']} batches, held "
          f"{held}")
    ring = fetch.stats["dead_letters"]
    check(fetch.stats["bad_records"] == 1 and len(ring) == 1
          and ring[0]["offset"] == STREAM_POISON_POLL,
          f"the poison record: {fetch.stats}")
    check(sum(b1) > 0, f"B1 launches a poll {b1}")
    print(f"[sources] (c) stream consumer: {len(polls)} polls over two "
          f"partitions, one multiline SPMF record a micro-batch; the "
          f"window after polls {held} SHA-256 == phase 17's; the poison "
          f"record counted (bad_records 1) and dead-lettered "
          f"({ring[0]['partition']} offset {ring[0]['offset']}); wall a "
          f"poll {walls} s (parse and push, beside the child's jobs) "
          f"against phase 17's push "
          f"{push_walls} s; B1 launches a poll {b1}; card {card}",
          flush=True)


def sources_child(torch) -> tuple:
    """Start (not wait for) phase 30's child of the service, with
    ``--remote-port`` set and ``[rescache]`` off; (child, its remote
    port)."""
    from spark_fsm_tpu_torch.models._common import auto_pool_bytes

    os.makedirs(SOURCES_DIR, exist_ok=True)
    remote_port = _free_port()
    child = Replica("sources", {
        "cluster": {"enabled": True, "lease_ttl_s": 5.0},
        "rescache": {"enabled": False},
        "engine": {"pool_bytes": auto_pool_bytes(torch.device("cuda", 0))}},
        SOURCES_DIR, extra=("--remote-port", str(remote_port)))
    return child, remote_port


def sources_phase(torch, card: str, inp: dict, started=None) -> None:
    """Phase 30: the sources, the remote entry and the stream consumer.
    ``inp``: phase 5's (``bms``, ``bms payload``, ``bms wall``), phase 21's
    tenth (``tenth``: database, rules' serialization, wall), phase 17's
    batches as SPMF (``stream texts``), its window digests after pushes 1,
    5 and 10 (``stream digests``) and its push walls (``stream walls``).
    ``started``: :func:`sources_child`'s result when the child was started
    earlier (it then boots beside phases 28 and 29)."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    child, remote_port = started or sources_child(torch)

    try:
        child.ready()

        def served():
            _sources_jobs(card, child.port, inp)
            _remote_entry(card, remote_port, inp)

        # the child's jobs and the consumer in this process overlap: the
        # host work of each runs in its own process
        with ThreadPoolExecutor(1) as pool:
            jobs = pool.submit(served)
            _stream_consumer(torch, card, inp)
            jobs.result()
        counts = child.counts()
    finally:
        rc = child.stop()
    check(rc == 0, f"the sources child exited with {rc}:\n"
          f"{child.log()[-2000:]}")
    check(counts["b1"] > 0 and counts["b2"] > 0,
          f"the sources child's launches {counts}")
    print(f"[sources] the child answered {child.boot_s:.3f} s after its "
          f"start{' (beside phases 28 and 29)' if started else ''}; B1 "
          f"{counts['b1']}, B2 {counts['b2']}, B3 {counts['b3']} launches, "
          f"max_memory_allocated {counts['peak']} B; phase 30 "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)


def _stream_inputs(torch) -> dict:
    """Phase 17's batches as SPMF, and the incremental window's digests
    after pushes 1, 5 and 10 with every push's wall, through the
    library."""
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.synth import msnbc_like
    from spark_fsm_tpu_torch.streaming.incremental import (
        IncrementalWindowMiner)
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    db = msnbc_like(scale=1.0, fast=True)
    per = len(db) // STREAM_PUSHES
    batches = [db[i * per:(i + 1) * per if i < STREAM_PUSHES - 1 else len(db)]
               for i in range(STREAM_PUSHES)]
    del db
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    digests, walls = {}, []
    for push, batch in enumerate(batches, 1):
        t0 = time.perf_counter()
        got = inc.push(batch)
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 3))
        if push in STREAM_ORACLE_PUSHES:
            digests[push] = digest(patterns_text(got))
    return {"stream texts": [format_spmf(b) for b in batches],
            "stream digests": digests, "stream walls": walls}


def phase30_only(torch) -> int:
    """``python3 chip_smoke.py --phase 30``: the card, then phase 30 on
    inputs made here through the library."""
    from spark_fsm_tpu_torch.data.synth import kosarak_like
    from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
    from spark_fsm_tpu_torch.service import model as SM

    card = _phase_card(torch)
    t0 = time.perf_counter()
    inp = _bms_inputs(torch)
    tenth = kosarak_like(scale=MESH_KOSARAK_SCALE, fast=True)
    t1 = time.perf_counter()
    rules = mine_tsr_torch(tenth, 100, 0.5, max_side=2)
    torch.cuda.synchronize()
    inp["tenth"] = (tenth, SM.serialize_rules(rules),
                    round(time.perf_counter() - t1, 3))
    inp.update(_stream_inputs(torch))
    print(f"[phase 30 only] inputs through the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sources_phase(torch, card, inp)
    print(f"card: {card}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import spark_fsm_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:] == ["--phase", "25"]:
        return phase25_only(torch)
    if sys.argv[1:] == ["--phase", "26"]:
        return phase26_only(torch)
    if sys.argv[1:] == ["--phase", "27"]:
        return phase27_only(torch)
    if sys.argv[1:] == ["--phase", "28"]:
        return phase28_only(torch)
    if sys.argv[1:] == ["--phase", "29"]:
        return phase29_only(torch)
    if sys.argv[1:] == ["--phase", "30"]:
        return phase30_only(torch)
    if sys.argv[1:2] == ["--replica"]:
        return replica_child(sys.argv[2], sys.argv[3:])

    os.makedirs(DATA_DIR, exist_ok=True)
    oracles = {"data": start_child(DATA_MAKER, DATA_DIR, nice=0)}
    oracles.update({scale: start_child(CSPADE_ORACLE, scale)
                    for scale in GAZELLE_SCALES})
    # phase 5 reads the BMS oracle within a minute: it is not niced
    oracles.update({name: start_child(SPADE_ORACLE, name, rel,
                                      nice=0 if name == "bms" else 10)
                    for name, rel in SPADE_ORACLES})
    oracles.update({("stream", push): start_child(
        STREAM_ORACLE, push, STREAM_PUSHES, STREAM_KEEP, STREAM_MINSUP)
        for push in STREAM_ORACLE_PUSHES})
    oracles.update({("tsr", side): start_child(TSR_ORACLE, side)
                    for side in TSR_ORACLE_SIDES})
    try:
        return run(torch, oracles)
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run(torch, oracles) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from spark_fsm_tpu_torch.data import fasttok
    from spark_fsm_tpu_torch.data.spmf import format_spmf
    from spark_fsm_tpu_torch.data.synth import (
        gazelle_like, kosarak_like, msnbc_like, synthetic_db)
    from spark_fsm_tpu_torch.data.vertical import (
        abs_minsup, build_vertical, dataset_stats)
    from spark_fsm_tpu_torch.models.oracle import mine_spade
    from spark_fsm_tpu_torch.models.spade import SpadeTorch, mine_spade_torch
    from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
    from spark_fsm_tpu_torch.models.spade_queue import (
        queue_eligible, queue_geometry)
    from spark_fsm_tpu_torch.models.spam_bitmap import (
        mine_spam_torch, spam_geometry)
    from spark_fsm_tpu_torch.models._common import device_hbm_budget
    from spark_fsm_tpu_torch.models.tsr import (
        TsrTorch, mine_tsr_cpu, mine_tsr_torch)
    from spark_fsm_tpu_torch.ops import _build
    from spark_fsm_tpu_torch.ops import extend_prune as EP
    from spark_fsm_tpu_torch.ops import maxstart_masks as MM
    from spark_fsm_tpu_torch.ops import pair_support as PS
    from spark_fsm_tpu_torch.ops import ragged_batch as RB
    from spark_fsm_tpu_torch.ops import resident_frontier as RF
    from spark_fsm_tpu_torch.ops import rule_support as RS
    from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
    from spark_fsm_tpu_torch.profile_mine import predict_prefixes
    from spark_fsm_tpu_torch.service import model as SM
    from spark_fsm_tpu_torch.service.planner import choose_patterns_engine
    from spark_fsm_tpu_torch.streaming import (
        IncrementalWindowMiner, WindowMiner)
    from spark_fsm_tpu_torch.utils.canonical import (
        diff_patterns, patterns_text, rules_text)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    clock(1)
    # 1. the card
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[card] nvidia-smi: {card} | torch: {kind} x{count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    clock(2)
    # 2. build: one nvcc per source and the tokenizer's gcc, all started
    # together
    sources = ("pair_support", "rule_support", "extend_prune",
               "maxstart_masks")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        tok_build = pool.submit(fasttok.build)
        libs = list(pool.map(_build.build, sources))
        tok_err = tok_build.exception()
    PS._kernel()
    RS._kernel()
    EP._kernel()
    MM._kernel()
    build_s = time.perf_counter() - t0
    for name, lib_path in zip(sources, libs):
        usage = ptxas_usage(_build.build_log(name))
        check(bool(usage), f"the {name} build printed no ptxas report")
        print(f"[build] {name}.cu -> {os.path.basename(lib_path)}; ptxas: "
              f"{'; '.join(usage)}", flush=True)
    print(f"[build] {len(sources)} sources and the tokenizer in "
          f"{build_s:.3f} s", flush=True)
    print(f"[tok] tokenizer: {fasttok.backend()}"
          + ("" if fasttok.backend() == "native"
             else f" (native build failed: {fasttok.reason() or tok_err})"),
          flush=True)

    clock(3)
    # 3. kernel == plain version, exactly, on ragged shapes and at the main
    # path's launches; with the live-row hint at SPAM's mesh wave, the
    # stream sweep, 0, NI and a ragged 37 of 64 (item rows past the hint
    # all zero, as the engines' stores have them), and without it
    spam_mesh_wave = (2 * spam_geometry(990000, 17, 1, device=dev)
                      ["node_batch"], 64, 990016, 1)
    PAIR_LIVE[spam_mesh_wave] = SPAM_MESH_LIVE
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0
    timed = {}
    for (P, NI, S, W, live) in (
            (130, 77, 1001, 1, None), (67, 129, 517, 2, None),
            (3, 5, 4099, 3, None), (64, 64, 4099, 1, 37),
            (130, 64, 1001, 2, 0), (12, 64, 517, 1, 64),
            (12, 64, 2053, 3, 17)) + tuple(
                shape + (PAIR_LIVE[shape],) for shape in (
                    LATE_WAVE, CLASSIC_LAUNCH, WIDE_WAVE, HEADLINE,
                    STREAM_SWEEP, spam_mesh_wave)):
        pt = rand_words(gen, P, S * W)
        items = rand_words(gen, NI + 7, S * W)
        if live is not None:
            items[live:NI] = 0                  # all-zero pad item rows
        pref = torch.from_numpy(rng.integers(0, P, 999)).to(dev)
        item = torch.from_numpy(rng.integers(0, NI, 999)).to(dev)
        for hint in ((None,) if live is None else (live, None)):
            got = PS.pair_supports(pt, items, NI, n_words=W, n_live=hint)
            want = PS.pair_supports_plain(pt, items, NI, n_words=W,
                                          n_live=hint)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"pair_supports != plain at P={P} NI={NI} S={S} "
                  f"W={W} n_live={hint} (max abs err {err})")
            gb = PS.batch_supports(pt, items, NI, pref, item, n_words=W,
                                   n_live=hint)
            wb = PS.batch_supports_plain(pt, items, NI, pref, item,
                                         n_words=W, n_live=hint)
            check(torch.equal(gb, wb), f"batch_supports != plain at W={W} "
                  f"n_live={hint}")
            worst = max(worst, err)
        print(f"[check] pair_supports P={P} NI={NI} S={S} W={W}"
              + ("" if live is None else f" ({live} live rows, pad rows "
                 f"zero), with n_live={live} and without") + f": equal to "
              f"plain (max abs err {err}); batch_supports equal",
              flush=True)
        if (P, NI, S, W) in PAIR_LIVE:
            timed[(P, NI, S, W)] = (pt, items)
        del pt, items

    clock(4)
    # 4. timing at every launch shape above, with the hint its caller
    # passes, against the bound over the live rows: the device time a
    # launch (zero-fill of the output included) of back-to-back launches;
    # the kernels line reports the main path's wide queue wave, timed last
    pair_times = {}
    for shape in (LATE_WAVE, CLASSIC_LAUNCH, HEADLINE, STREAM_SWEEP,
                  spam_mesh_wave, WIDE_WAVE):
        pt, items = timed.pop(shape)
        P, NI, S, W = shape
        live = PAIR_LIVE[shape]
        ms = launch_ms(lambda: PS.pair_supports(pt, items, NI, n_words=W,
                                                n_live=live), 3, 20)
        plain_ms = time_ms(
            lambda: PS.pair_supports_plain(pt, items, NI, n_words=W,
                                           n_live=live), 1, 3)
        bound_ms, bound_by = pair_bound_ms(P, NI, S, W, live)
        pair_times[shape] = ms
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] pair_supports P={P} NI={NI} n_live={live} S={S} W={W}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms over the live rows ({bound_by}, "
              f"{100 * bound_ms / ms:.1f} % of it reached), "
              f"library: none (no single PyTorch call counts 'any' per "
              f"sequence); after timing nvidia-smi sm clock, power, temp: "
              f"{clocks}", flush=True)
        del pt, items
    torch.cuda.empty_cache()

    clock(5)
    # 5. the main path at full data size: the router's choice, the queue
    # engine, with B1 launched once per wave
    db, gen_s = take_made(oracles["data"], "bms")
    minsup = abs_minsup(0.001, len(db))
    vdb = build_vertical(db, min_item_support=minsup)
    geo = queue_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                         device=dev)
    store_bytes = ((geo["ni_pad"] + geo["caps"].ring + 2) * geo["n_seq"]
                   * vdb.n_words * 4)
    check(queue_eligible(vdb, dev),
          "the BMS-shaped mine is not queue-eligible")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PS.pair_supports.launches = 0
    stats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, stats_out=stats)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = PS.pair_supports.launches
    peak = torch.cuda.max_memory_allocated()
    check(stats.get("fused") == "queue",
          f"the router sent the main path to {stats.get('fused')!r}, not the "
          f"queue engine")
    check(not stats.get("fused_overflow"), "the queue engine overflowed")
    check(launches == stats["waves"] > 0,
          f"{launches} pair-support launches for {stats['waves']} waves")
    wstats: dict = {}
    t0 = time.perf_counter()
    got_warm = mine_spade_torch(db, minsup, stats_out=wstats)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    oracle_s, text = collect_oracle(oracles["bms"], "BMS SPADE")
    check(patterns_text(got) == text, "main-path mine differs from the oracle")
    check(patterns_text(got_warm) == text, "warm mine differs from the oracle")
    wide = stats["waves"] - stats["late_waves"]
    main_bound_ms = (
        wide * pair_bound_ms(*WIDE_WAVE, vdb.n_items)[0]
        + stats["late_waves"] * pair_bound_ms(*LATE_WAVE, vdb.n_items)[0])
    print(f"[mine] bms_webview2_like: {len(db)} sequences, {vdb.n_items} "
          f"frequent items, W={vdb.n_words}, minsup {minsup}: route "
          f"{stats['fused']!r}, {len(got)} patterns byte-identical to the "
          f"oracle; cold {cold_s:.3f} s, warm {warm_s:.3f} s; waves "
          f"{stats['waves']} ({wide} wide at nb {geo['caps'].nb}, "
          f"{stats['late_waves']} late at nb {geo['nb_late']}), pair-support "
          f"launches {launches} (bound summed over them {main_bound_ms:.3f} "
          f"ms), candidates {stats['candidates']}, ring {geo['caps'].ring}, "
          f"store {store_bytes} B, counter waits {stats['wait_s']:.4f} s "
          f"cold / {wstats['wait_s']:.4f} s warm, max_memory_allocated "
          f"{peak} B; host: generator {gen_s:.1f} s, oracle {oracle_s:.1f} "
          f"s (child processes)",
          flush=True)
    # phase 21 holds the mesh mines against this phase's text and walls
    mesh_want = {"spade auto": digest(text), "spade never": digest(text)}
    single_walls = {"spade auto": (round(cold_s, 3), round(warm_s, 3))}
    # phase 20 serves predictions from each path's output
    predict_sets = {"spade": ("bms_webview2_like SPADE minsup 0.1 %",
                              "patterns", SM.serialize_patterns(got),
                              predict_prefixes(db, 2))}
    del got, got_warm
    torch.cuda.empty_cache()

    # the same mine through the classic engine, pinned
    PS.pair_supports.launches = 0
    cstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, fused="never", stats_out=cstats)
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    c_launches = PS.pair_supports.launches
    check(cstats["fused"] is False and c_launches > 0,
          f"the classic route: {cstats['fused']!r}, {c_launches} launches")
    check(patterns_text(got) == text, lambda: "the classic engine differs "
          "from the oracle:\n" + diff_patterns(mine_spade(db, minsup), got))
    single_walls["spade never"] = (round(classic_s, 3),)
    print(f"[mine] bms_webview2_like fused='never': {len(got)} patterns "
          f"byte-identical to the oracle; {classic_s:.3f} s, pair-support "
          f"launches {c_launches}, candidates {cstats['candidates']}",
          flush=True)

    # pinned to the dense engine: the frontier's widest level (766 nodes)
    # fits its 1,024 lanes, so it mines with one launch per level
    PS.pair_supports.launches = 0
    dstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, fused="dense", stats_out=dstats)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    check(dstats["fused"] is True,
          f"fused='dense' at full size did not run the dense engine: "
          f"{ {k: v for k, v in dstats.items() if k.startswith('fused')} }")
    check(PS.pair_supports.launches == dstats["levels"] > 0,
          f"{PS.pair_supports.launches} launches for {dstats['levels']} "
          f"levels")
    check(patterns_text(got) == text, lambda: "the dense engine differs "
          "from the oracle:\n" + diff_patterns(mine_spade(db, minsup), got))
    print(f"[mine] bms_webview2_like fused='dense': {len(got)} patterns "
          f"byte-identical to the oracle; {dense_s:.3f} s, levels "
          f"{dstats['levels']} = pair-support launches, candidates "
          f"{dstats['candidates']}, counter waits {dstats['wait_s']:.4f} s",
          flush=True)

    # at minsup 50 the second level (about 1,250 nodes) overflows the dense
    # frontier (and the queue engine's 1,024 children a wave): the mine
    # falls back to the classic engine, held against the SPAM engine's
    low = 50
    PS.pair_supports.launches = 0
    ostats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, low, fused="dense", stats_out=ostats)
    torch.cuda.synchronize()
    over_s = time.perf_counter() - t0
    check(ostats.get("fused_overflow") and ostats["fused"] is False,
          f"fused='dense' at minsup {low} did not overflow and fall back: "
          f"{ {k: v for k, v in ostats.items() if k.startswith('fused')} }")
    over_launches = PS.pair_supports.launches
    astats: dict = {}
    t0 = time.perf_counter()
    got_auto = mine_spade_torch(db, low, stats_out=astats)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    want_low = mine_spam_torch(db, low)
    check(patterns_text(got) == patterns_text(want_low)
          and patterns_text(got_auto) == patterns_text(want_low),
          f"the fallbacks at minsup {low} differ from the SPAM engine's mine")
    print(f"[mine] bms_webview2_like minsup {low}: fused='dense' overflowed "
          f"after {ostats['fused_levels']} levels and fell back to the classic "
          f"engine ({over_s:.3f} s, pair-support launches {over_launches}); "
          f"fused='auto' routed "
          f"{ {k: v for k, v in astats.items() if k.startswith('fused')} } "
          f"({auto_s:.3f} s); both {len(got)} patterns byte-identical to the "
          f"SPAM engine's", flush=True)
    del got_auto

    # checkpointed: the queue engine in segments; a mid-mine snapshot
    # resumes in the classic engine
    ckpt = SnapshotStore()
    PS.pair_supports.launches = 0
    kstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spade_torch(db, minsup, checkpoint=ckpt, stats_out=kstats)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    check(kstats["fused"] == "queue" and kstats.get("checkpoints", 0) > 0,
          f"the checkpointed mine: route {kstats['fused']!r}, "
          f"{kstats.get('checkpoints', 0)} snapshots")
    check(PS.pair_supports.launches == kstats["waves"],
          f"{PS.pair_supports.launches} launches for {kstats['waves']} waves")
    check(patterns_text(got) == text, "the checkpointed mine differs")
    k = len(ckpt.saved) // 2
    snap = ckpt.merged(k)
    check(bool(snap["stack"]), "the mid-mine snapshot holds no frontier")
    t0 = time.perf_counter()
    resumed = SpadeTorch(vdb, minsup).mine(resume=snap)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(patterns_text(resumed) == text,
          "the classic engine's resume of a queue snapshot differs")
    print(f"[mine] bms_webview2_like checkpointed: {kstats['checkpoints']} "
          f"snapshots over {kstats['waves']} waves, byte-identical; "
          f"{ckpt_s:.3f} s; snapshot {k} ({len(snap['stack'])} live nodes, "
          f"{len(snap['results'])} results) resumed in the classic engine, "
          f"byte-identical, {resume_s:.3f} s", flush=True)
    del got, resumed, snap, ckpt
    torch.cuda.empty_cache()

    tokenizer_times("bms_webview2_like", db, minsup)
    bms_db, bms_minsup, bms_text = db, minsup, text
    del want_low, vdb
    torch.cuda.empty_cache()

    clock(6)
    # 6. multiword mine
    db = synthetic_db(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
                      max_itemsets=80)
    minsup_w = abs_minsup(0.5, len(db))
    vdb = build_vertical(db, min_item_support=minsup_w)
    check(vdb.n_words >= 2, f"multiword fixture has W={vdb.n_words}")
    PS.pair_supports.launches = 0
    got = mine_spade_torch(db, minsup_w, max_pattern_itemsets=3)
    torch.cuda.synchronize()
    mw_launches = PS.pair_supports.launches
    want = mine_spade(db, minsup_w, max_pattern_itemsets=3)
    check(patterns_text(got) == patterns_text(want),
          "multiword mine differs from the oracle:\n" + diff_patterns(want, got))
    check(mw_launches > 0, "the multiword mine launched the kernel 0 times")
    print(f"[mine] multiword W={vdb.n_words}: {len(got)} patterns "
          f"byte-identical to the oracle, pair-support launches {mw_launches}",
          flush=True)

    pair_record = {
        "name": "pair_support", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/pair_support.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_support.py:202",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }
    del db, got, want, vdb
    torch.cuda.empty_cache()

    clock(7)
    # 7. rule-support kernel == plain version, exactly
    rworst = 0
    shapes = [(C, km, 24, S, W) for (C, S, W) in ((77, 1001, 1), (130, 517, 2),
                                                   (257, 4099, 3))
              for km in RB.KM_LADDER] + [
        (200, 3, 24, 2500, 1),
        # the staged path at its largest store, and the walk path past it
        (300, 2, RS.staged_max_rows(2), 2500, 1),
        (300, 2, RS.staged_max_rows(2) + 1, 2500, 1),
        RULE_RESIDENT_LATE, RULE_RESIDENT_WIDE, RULE_KM1, RULE_HEADLINE]
    for i, (C, km, M, S, W) in enumerate(shapes):
        p1, s1, xy = rule_operands(dev, 100 + i, C, km, M, S, W)
        if i == 0:
            xy[: C // 2, 0] = -1        # all of one side unused: the pad row
        elif i == 1:
            xy[: C // 2, 1] = -1
        got_r = RS.rule_supports(p1, s1, xy, n_words=W)
        want_r = RS.rule_supports_plain(p1, s1, xy, n_words=W)
        torch.cuda.synchronize()
        err = int((got_r.long() - want_r.long()).abs().max())
        check(err == 0, f"rule_supports != plain at C={C} km={km} M={M} "
              f"S={S} W={W} (max abs err {err})")
        rworst = max(rworst, err)
        print(f"[check] rule_supports C={C} km={km} M={M} S={S} W={W}: "
              f"equal to plain (max abs err {err})", flush=True)
        del p1, s1, xy, got_r, want_r
    torch.cuda.empty_cache()

    clock(8)
    # 8. timing at the resident waves, at km = 1 and at the headline launch;
    # the kernels line reports the headline launch, timed last
    for i, shape in enumerate((RULE_RESIDENT_LATE, RULE_RESIDENT_WIDE,
                               RULE_KM1, RULE_HEADLINE)):
        C, km, M, S, W = shape
        p1, s1, xy = rule_operands(dev, 200 + i, C, km, M, S, W)
        rms = time_ms(lambda: RS.rule_supports(p1, s1, xy, n_words=W), 2, 10)
        rplain_ms = time_ms(
            lambda: RS.rule_supports_plain(p1, s1, xy, n_words=W), 1, 3)
        rbound_ms, rbound_by = rule_bound_ms(xy, S, W)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] rule_supports C={C} km={km} M={M} S={S} W={W}: kernel "
              f"{rms:.4f} ms, plain {rplain_ms:.4f} ms, bound {rbound_ms:.4f} "
              f"ms ({rbound_by}, {rule_rows(xy)} of {2 * M} store rows "
              f"named, {100 * rbound_ms / rms:.1f} % of it "
              f"reached), library: none (no single PyTorch call folds row "
              f"ANDs, shifts with a carry and counts 'any' per sequence); "
              f"after timing nvidia-smi sm clock, power, temp: {clocks}",
              flush=True)
        del p1, s1, xy
    torch.cuda.empty_cache()

    clock(9)
    # 9. the TSR path at full data size
    db, gen_s = take_made(oracles["data"], "kosarak")
    vdb = tokenizer_times("kosarak_like", db, 1, sample=10)   # the recount's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RS.rule_supports.launches = 0
    tstats: dict = {}
    t0 = time.perf_counter()
    rules = mine_tsr_torch(db, 100, 0.5, max_side=2, stats_out=tstats)
    torch.cuda.synchronize()
    tcold_s = time.perf_counter() - t0
    rlaunches = RS.rule_supports.launches
    tpeak = torch.cuda.max_memory_allocated()
    check(rlaunches > 0, "the TSR path launched the rule-support kernel 0 times")
    check(len(rules) >= 100, f"the TSR mine returned {len(rules)} < k rules")
    # warm: the engine again on the kept vertical DB (a second vertical
    # build of this database is the smoke's costliest host stage to repeat)
    t0 = time.perf_counter()
    rules_warm = TsrTorch(vdb, 100, 0.5, max_side=2).mine()
    torch.cuda.synchronize()
    twarm_s = time.perf_counter() - t0
    text = rules_text(rules)
    check(rules_text(rules_warm) == text, "warm TSR mine differs from cold")
    t0 = time.perf_counter()
    recount = recount_rules(vdb, rules)
    recount_s = time.perf_counter() - t0
    bad = [(r, c) for r, c in zip(rules, recount) if r != c]
    check(not bad, f"host recount disagrees on {len(bad)} rules, e.g. {bad[:3]}")
    km_stats = {k: v for k, v in tstats.items()
                if k.startswith(("launches_km", "evaluated_km", "width_km"))}
    print(f"[mine] kosarak_like: {len(db)} sequences, {vdb.n_items} items, "
          f"W={vdb.n_words}, k=100 minconf=0.5 max_side=2: {len(rules)} rules "
          f"byte-identical to the host recount (the plain route is held on "
          f"phase 21's tenth); cold {tcold_s:.3f} s, warm (the engine on "
          f"the kept vertical DB) {twarm_s:.3f} s; "
          f"rule-support launches {rlaunches}, "
          f"evaluated {tstats['evaluated']}, pruned_conf "
          f"{tstats['pruned_conf']}, deepening_rounds "
          f"{tstats['deepening_rounds']}, {km_stats}; "
          f"max_memory_allocated {tpeak} B; host: generator {gen_s:.1f} s "
          f"(child process), "
          f"recount {recount_s:.1f} s", flush=True)
    kos_vdb = vdb   # phase 15 mines it again
    service_dbs = {"kosarak": db}   # phase 23 serves it
    mesh_want["tsr"] = digest(text)
    single_walls["tsr"] = (round(tcold_s, 3), round(twarm_s, 3))
    predict_sets["tsr"] = ("kosarak_like TSR k=100", "rules",
                           SM.serialize_rules(rules), predict_prefixes(db, 1))
    del db, rules, rules_warm, vdb
    torch.cuda.empty_cache()

    clock(10)
    # 10. the TSR path against the copied CPU oracle
    for name, db, k, minconf, side in (
            ("kosarak_like(scale=0.01)", kosarak_like(scale=0.01, fast=True),
             100, 0.5, 2),
            ("multiword synthetic_db(seed=8)",
             synthetic_db(seed=8, n_sequences=120, n_items=12,
                          mean_itemsets=40.0, max_itemsets=80), 10, 0.3, 3)):
        n_words = build_vertical(db, min_item_support=1).n_words
        before = RS.rule_supports.launches
        got_t = mine_tsr_torch(db, k, minconf, max_side=side)
        torch.cuda.synchronize()
        n_l = RS.rule_supports.launches - before
        want_text = (collect_oracle(oracles[("tsr", side)], name)[1]
                     if name.startswith("kosarak") else
                     rules_text(mine_tsr_cpu(db, k, minconf, max_side=side)))
        check(rules_text(got_t) == want_text,
              f"TSR mine of {name} differs from mine_tsr_cpu")
        check(n_l > 0, f"the TSR mine of {name} launched the kernel 0 times")
        print(f"[mine] {name}: W={n_words}, {len(got_t)} rules byte-identical "
              f"to mine_tsr_cpu, rule-support launches {n_l}", flush=True)
    check(n_words >= 2, f"the multiword TSR fixture has W={n_words}")

    rule_record = {
        "name": "rule_support", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/rule_support.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_tsr.py:145",
        "launches": rlaunches, "max_abs_err": rworst,
        "ms": rms, "plain_ms": rplain_ms, "bound_ms": rbound_ms,
        "bound_by": rbound_by, "library_ms": None,
    }
    del db, got_t
    torch.cuda.empty_cache()

    clock(11)
    # 11. extension-count-prune kernel == plain version, exactly
    nb = spam_geometry(990000, 17, 1, device=dev)["node_batch"]
    msnbc_wave = (2 * nb, 64, 990016, 1)
    eworst = 0
    ewaves = {}
    for (P, NI, n_items, S, W) in ((12, 64, 17, 1001, 1), (37, 128, 100, 4099, 2),
                                   (128, 64, 26, 517, 3), (14, 128, 90, 77503, 1),
                                   msnbc_wave[:2] + (17,) + msnbc_wave[2:],
                                   BMS_WAVE[:2] + (26,) + BMS_WAVE[2:]):
        pt = rand_words(gen, P, S * W)
        items = rand_words(gen, NI + 3, S * W)
        items[n_items:NI] = 0                   # all-zero pad item rows
        counts = PS.pair_supports(pt, items, NI, n_words=W)
        # the median over the live item lanes: pad lanes count 0
        median = max(1, int(counts[:, :n_items].float().median()))
        for thr in (1, median, int(counts.max()) + 1):
            want_s, want_m = EP.extend_count_prune_plain(
                pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
                torch.zeros(P, dtype=torch.bool))
            for hint in (n_items, None):
                sup, mask = EP.extend_count_prune(pt, items, thr, NI,
                                                  n_words=W, n_live=hint)
                torch.cuda.synchronize()
                err = int((sup.long() - want_s.long()).abs().max())
                check(err == 0 and torch.equal(mask, want_m),
                      f"extend_count_prune != plain at P={P} NI={NI} S={S} "
                      f"W={W} thr={thr} n_live={hint} (max abs err {err})")
                if thr == 1:
                    check(torch.equal(sup, counts), f"extend_count_prune at "
                          f"thr=1 != pair_supports at P={P} NI={NI} S={S} "
                          f"W={W} n_live={hint}")
                eworst = max(eworst, err)
        print(f"[check] extend_count_prune P={P} NI={NI} ({n_items} items, "
              f"pad rows zero) S={S} W={W}: sup and mask equal to plain at "
              f"thr 1, median, max+1, with n_live={n_items} and without; "
              f"equal to pair_supports at thr 1", flush=True)
        if (P, NI, S, W) in (msnbc_wave, BMS_WAVE):
            ewaves[(P, NI, S, W)] = (pt, items, median, n_items)
        del pt, items, counts, sup, mask, want_s, want_m

    clock(12)
    # 12. timing at the BMS dense wave and at the MSNBC wave: without the
    # live-row hint at the median count (against the bound over all NI
    # lanes), then with it at threshold 1 and at the median (against the
    # bound over the live lanes); the kernels line reports the MSNBC wave
    # (the main path's) with the hint at the median, timed last
    for shape in (BMS_WAVE, msnbc_wave):
        pt, items, median, n_live = ewaves.pop(shape)
        P, NI, S, W = shape
        for hint, thr in ((None, median), (n_live, 1), (n_live, median)):
            ebound_ms, ebound_by = extend_bound_ms(P, NI, S, W, hint)
            ems = launch_ms(
                lambda: EP.extend_count_prune(pt, items, thr, NI, n_words=W,
                                              n_live=hint), 3, 50)
            print(f"[time] extend_count_prune P={P} NI={NI} S={S} W={W} "
                  f"n_live={hint or NI} thr={thr}: kernel {ems:.4f} ms, "
                  f"bound {ebound_ms:.4f} ms ({ebound_by}, "
                  f"{100 * ebound_ms / ems:.1f} % of it reached)", flush=True)
        eplain_ms = time_ms(lambda: EP.extend_count_prune_plain(
            pt.view(P, S, W), items[:NI].view(NI, S, W), thr,
            torch.zeros(P, dtype=torch.bool, device=dev)), 1, 5)
        clocks = smi("clocks.sm,power.draw,temperature.gpu")
        print(f"[time] extend_count_prune P={P} NI={NI} S={S} W={W} thr={thr}: "
              f"plain {eplain_ms:.4f} ms, library: none (no single PyTorch "
              f"call counts 'any' per sequence, thresholds and packs a mask); "
              f"after timing nvidia-smi sm clock, power, temp: {clocks}",
              flush=True)
        del pt, items
    torch.cuda.empty_cache()

    clock(13)
    # 13. the SPAM path at full data size
    db, gen_s = take_made(oracles["data"], "msnbc")
    minsup = abs_minsup(0.005, len(db))
    tokenizer_times("msnbc_like", db, minsup, sample=10)
    decision = choose_patterns_engine(dataset_stats(db, min_item_support=minsup))
    check(decision.engine == "SPAM_TPU",
          f"the planner routes the MSNBC-shaped mine to {decision.engine}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    EP.extend_count_prune.launches = 0
    PS.pair_supports.launches = 0
    RS.rule_supports.launches = 0
    sstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spam_torch(db, minsup, stats_out=sstats)
    torch.cuda.synchronize()
    scold_s = time.perf_counter() - t0
    elaunches = EP.extend_count_prune.launches
    speak = torch.cuda.max_memory_allocated()
    check(elaunches > 0, "the SPAM path launched the extend-prune kernel 0 times")
    check(elaunches == sstats["waves"],
          f"{elaunches} extend-prune launches for {sstats['waves']} waves")
    check(PS.pair_supports.launches == 0 and RS.rule_supports.launches == 0,
          "the pure-bitmap SPAM path launched another kernel")
    t0 = time.perf_counter()
    got_warm = mine_spam_torch(db, minsup)
    torch.cuda.synchronize()
    swarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_spade = mine_spade_torch(db, minsup)
    torch.cuda.synchronize()
    spade_s = time.perf_counter() - t0
    oracle_s, text = collect_oracle(oracles["msnbc"], "MSNBC SPADE")
    check(patterns_text(got) == text, "SPAM mine differs from the oracle")
    check(patterns_text(got_warm) == text, "warm SPAM mine differs from the oracle")
    check(patterns_text(got_spade) == text,
          "SPAM and the SPADE route differ on the MSNBC-shaped mine")
    print(f"[mine] msnbc_like: {len(db)} sequences, {sstats['rep_dense']} "
          f"frequent items, minsup {minsup}, planner: {decision.engine} "
          f"({decision.reason}): {len(got)} patterns byte-identical to the "
          f"oracle and to the SPADE route's; cold {scold_s:.3f} s, warm "
          f"{swarm_s:.3f} s, SPADE route {spade_s:.3f} s; node_batch {nb}, "
          f"waves {sstats['waves']}, extend-prune launches {elaunches}, "
          f"candidates {sstats['candidates']}, evaluated_lanes "
          f"{sstats['evaluated_lanes']}, wave_survivors "
          f"{sstats['wave_survivors']}, diffset_nodes {sstats['diffset_nodes']}, "
          f"engine launches {sstats['kernel_launches']}, recomputed_nodes "
          f"{sstats['recomputed_nodes']}; max_memory_allocated {speak} B; host: "
          f"generator {gen_s:.1f} s, oracle {oracle_s:.1f} s (child "
          f"processes)",
          flush=True)
    mesh_want["spam"] = digest(text)
    single_walls["spam"] = (round(scold_s, 3), round(swarm_s, 3))
    part_inputs = {"msnbc": (db, minsup)}   # phase 22 mines them again
    predict_sets["spam"] = ("msnbc_like SPAM minsup 0.5 %", "patterns",
                            SM.serialize_patterns(got),
                            predict_prefixes(db, 3))
    del db, got, got_warm, got_spade
    torch.cuda.empty_cache()

    clock(14)
    # 14. the SPAM path on the hybrid plan, and a multiword SPAM mine
    EP.extend_count_prune.launches = 0
    hstats: dict = {}
    t0 = time.perf_counter()
    got = mine_spam_torch(bms_db, bms_minsup, stats_out=hstats)
    torch.cuda.synchronize()
    hybrid_s = time.perf_counter() - t0
    hlaunches = EP.extend_count_prune.launches
    check(patterns_text(got) == bms_text,
          "hybrid SPAM mine differs from phase 5's oracle result")
    check(hstats["rep_dense"] > 0 and hstats["rep_idlist"] > 0,
          f"the BMS-shaped plan is not hybrid: {hstats['rep_dense']} dense, "
          f"{hstats['rep_idlist']} id-list items")
    check(hstats["pair_launches"] > 0, "the hybrid mine made no pair launches")
    check(hlaunches == hstats["waves"] > 0,
          f"{hlaunches} extend-prune launches for {hstats['waves']} waves")
    print(f"[mine] bms_webview2_like hybrid SPAM: rep_dense "
          f"{hstats['rep_dense']}, rep_idlist {hstats['rep_idlist']}, "
          f"{len(got)} patterns byte-identical to phase 5's oracle result; "
          f"{hybrid_s:.3f} s; waves {hstats['waves']}, extend-prune launches "
          f"{hlaunches}, pair_launches {hstats['pair_launches']}, candidates "
          f"{hstats['candidates']}, diffset_nodes {hstats['diffset_nodes']}",
          flush=True)
    del got
    db = synthetic_db(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
                      max_itemsets=80)
    minsup_w = abs_minsup(0.5, len(db))
    before = EP.extend_count_prune.launches
    got = mine_spam_torch(db, minsup_w, max_pattern_itemsets=3)
    torch.cuda.synchronize()
    n_l = EP.extend_count_prune.launches - before
    want = mine_spade(db, minsup_w, max_pattern_itemsets=3)
    check(patterns_text(got) == patterns_text(want),
          "multiword SPAM mine differs from the oracle:\n" + diff_patterns(want, got))
    check(n_l > 0, "the multiword SPAM mine launched the kernel 0 times")
    print(f"[mine] multiword SPAM W={build_vertical(db).n_words}: {len(got)} "
          f"patterns byte-identical to the oracle, extend-prune launches {n_l}",
          flush=True)

    del db, got, want
    torch.cuda.empty_cache()

    clock(15)
    # 15. TSR's resident-frontier route at full data size
    m0 = min(256, kos_vdb.n_items)   # the first deepening round's top-m
    probe = TsrTorch(kos_vdb, 100, 0.5, max_side=None)
    auto_resident = probe._resident_route(m0)
    caps = RF.caps_for(kos_vdb.n_sequences, kos_vdb.n_words, m0,
                       probe._ensure_budget())
    units = RB.overhead_units(kos_vdb.n_sequences, kos_vdb.n_words)
    check(auto_resident == (units >= caps.nb),
          f"auto's route {auto_resident} at overhead_units {units}, nb "
          f"{caps.nb}")
    del probe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RS.rule_supports.launches = 0
    # each wave's candidates kept on the card (a copy, no host sync), so
    # the bound can be summed over this run's wave launches afterwards
    plain_wave, launched = RF.wave, []

    def wave_keeping_candidates(*args):
        *head, evaluate = args

        def keep(p1, s1, xy, n_words):
            launched.append(xy.clone())
            return evaluate(p1, s1, xy, n_words)

        return plain_wave(*head, keep)

    RF.wave = wave_keeping_candidates
    try:
        eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="always")
        t0 = time.perf_counter()
        res_rules = eng.mine()
        torch.cuda.synchronize()
        rcold_s = time.perf_counter() - t0
    finally:
        RF.wave = plain_wave
    res_launches = RS.rule_supports.launches
    rpeak = torch.cuda.max_memory_allocated()
    rstats = eng.stats
    host_launches = sum(v for key, v in rstats.items()
                        if key.startswith("launches_km"))
    check(rstats.get("resident") is True and rstats["resident_waves"] > 0,
          f"resident='always' did not run the resident route: {rstats}")
    check(res_launches == rstats["resident_waves"] + host_launches,
          f"{res_launches} rule-support launches for "
          f"{rstats['resident_waves']} waves and {host_launches} host-loop "
          f"launches")
    n_waves = rstats["resident_waves"]
    check(len(launched) == n_waves,
          f"{len(launched)} wave evaluations seen for {n_waves} waves")
    S_k, W_k = kos_vdb.n_sequences, kos_vdb.n_words
    wave_rows = [rule_rows(xy) for xy in launched]
    wave_bound_ms = sum(rule_bound_ms(xy, S_k, W_k)[0] for xy in launched)
    del launched
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="always")
    t0 = time.perf_counter()
    res_warm = eng.mine()
    torch.cuda.synchronize()
    rwarm_s = time.perf_counter() - t0
    rwstats = eng.stats
    before = RS.rule_supports.launches
    eng = TsrTorch(kos_vdb, 100, 0.5, max_side=None, resident="never")
    t0 = time.perf_counter()
    host_rules = eng.mine()
    torch.cuda.synchronize()
    rhost_s = time.perf_counter() - t0
    hstats = eng.stats
    hl = RS.rule_supports.launches - before
    del eng
    text = rules_text(res_rules)
    check(rules_text(res_warm) == text, "warm resident mine differs")
    check(rules_text(host_rules) == text,
          "the resident route's rules differ from the host loop's")
    t0 = time.perf_counter()
    recount = recount_rules(kos_vdb, res_rules)
    recount_s = time.perf_counter() - t0
    bad = [(r, c) for r, c in zip(res_rules, recount) if r != c]
    check(not bad, f"host recount disagrees on {len(bad)} rules, e.g. {bad[:3]}")
    route_keys = ("resident_rounds", "resident_segments", "resident_waves",
                  "resident_deferred", "resident_spills", "resident_handoffs",
                  "resident_readback_bytes", "evaluated", "pruned_conf",
                  "kernel_launches", "deepening_rounds")
    print(f"[mine] kosarak_like max_side=None: {kos_vdb.n_sequences} "
          f"sequences, k=100 minconf=0.5: auto picks "
          f"{'the resident route' if auto_resident else 'the host loop'} "
          f"(overhead_units {units} vs caps.nb {caps.nb}; caps ring "
          f"{caps.ring}, nb_late {caps.nb_late}); resident='always': "
          f"{len(res_rules)} rules byte-identical to resident='never' and to "
          f"the host recount; cold {rcold_s:.3f} s, warm {rwarm_s:.3f} s, "
          f"host loop {rhost_s:.3f} s; "
          f"{ {k: rstats.get(k, 0) for k in route_keys} }, rule-support "
          f"launches {res_launches} ({host_launches} of them host-loop), "
          f"counter waits {rstats.get('wait_s', 0.0):.4f} s cold / "
          f"{rwstats.get('wait_s', 0.0):.4f} s warm; host loop: evaluated "
          f"{hstats['evaluated']}, rule-support launches {hl}; "
          f"max_memory_allocated {rpeak} B; recount {recount_s:.1f} s",
          flush=True)
    print(f"[bound] rule_supports on the resident route: {n_waves} wave "
          f"launches name {statistics.mean(wave_rows):.1f} store rows each "
          f"(min {min(wave_rows)}, max {max(wave_rows)}), bound summed over "
          f"them {wave_bound_ms:.3f} ms", flush=True)
    del res_rules, res_warm, host_rules   # phase 22 mines kos_vdb again
    torch.cuda.empty_cache()

    db = kosarak_like(scale=0.01, fast=True)
    s1: dict = {}
    before = RS.rule_supports.launches
    t0 = time.perf_counter()
    got_t = mine_tsr_torch(db, 100, 0.5, max_side=None, stats_out=s1)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    n_l = RS.rule_supports.launches - before
    check(s1.get("resident") is True,
          f"auto at 1 % size did not take the resident route: {s1}")
    cpu_s, text = collect_oracle(oracles[("tsr", None)],
                                 "1 % Kosarak TSR max_side=None")
    check(rules_text(got_t) == text,
          "the 1 % resident mine differs from mine_tsr_cpu")
    # the user's default request at this size on both routes, warm, in
    # turns on one vertical DB: auto (the resident route) and the host loop
    small_vdb = build_vertical(db, min_item_support=1)
    small_walls = {"auto": [], "never": []}
    for _ in range(3):
        for resident, walls in small_walls.items():
            eng = TsrTorch(small_vdb, 100, 0.5, max_side=None,
                           resident=resident)
            t0 = time.perf_counter()
            got_r = eng.mine()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(rules_text(got_r) == text,
                  f"the 1 % mine with resident={resident!r} differs")
            check((eng.stats.get("resident") is True) == (resident == "auto"),
                  f"resident={resident!r} took the wrong route at 1 %")
    del eng, got_r, small_vdb
    print(f"[mine] kosarak_like(scale=0.01) max_side=None: auto took the "
          f"resident route; {len(got_t)} rules byte-identical to "
          f"mine_tsr_cpu; {small_s:.3f} s (mine_tsr_cpu {cpu_s:.1f} s, child "
          f"process); "
          f"{ {k: s1.get(k, 0) for k in route_keys} }, rule-support "
          f"launches {n_l}; warm mines in turns (vertical DB built), auto "
          f"{[round(w, 4) for w in small_walls['auto']]} s, host loop "
          f"(resident='never') {[round(w, 4) for w in small_walls['never']]} "
          f"s, medians {statistics.median(small_walls['auto']):.4f} / "
          f"{statistics.median(small_walls['never']):.4f} s", flush=True)
    tsr_small_db, tsr_small_text = db, text   # phases 19 and 22 mine it
    tsr_small_payload = SM.serialize_rules(got_t)   # phase 24 serves it
    mesh_want["tsr 1%"] = digest(text)
    del db, got_t

    clock(16)
    # 16. the window-mask kernel against its plain version and timed; then
    # constrained SPADE against the copied oracle, full size and 10 %, its
    # supports one mask launch and one B1 launch a node batch
    mask_record = mask_kernel_step(torch, gen)
    batches = support_batches()
    for scale in GAZELLE_SCALES:
        db = gazelle_like(scale=scale, fast=True)
        minsup = abs_minsup(0.005, len(db))
        vdb = build_vertical(db, min_item_support=minsup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs: dict = {}
        MM.window_masks.launches = PS.pair_supports.launches = 0
        batches.calls = 0
        t0 = time.perf_counter()
        got = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                                stats_out=cs)
        torch.cuda.synchronize()
        ccold_s = time.perf_counter() - t0
        cpeak = torch.cuda.max_memory_allocated()
        mask_launches = MM.window_masks.launches
        check(mask_launches == PS.pair_supports.launches == batches.calls > 0,
              f"the cSPADE mine at scale {scale}: {mask_launches} mask "
              f"launches, {PS.pair_supports.launches} B1 launches, "
              f"{batches.calls} node batches with candidates")
        if scale == 1.0:
            mask_record["launches"] = mask_launches
        geo = cs["geometry"]
        t0 = time.perf_counter()
        got_warm = mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5)
        torch.cuda.synchronize()
        cwarm_s = time.perf_counter() - t0
        oracle_s, want_text = collect_oracle(oracles[scale], "cSPADE")
        check(patterns_text(got) == want_text,
              f"the cSPADE mine at scale {scale} differs from the oracle")
        check(patterns_text(got_warm) == want_text,
              f"the warm cSPADE mine at scale {scale} differs")
        check(len(got) > 0, f"the cSPADE mine at scale {scale} is empty")
        cspade_small = (db, minsup, want_text)   # phase 19: the last scale
        if scale == 1.0:
            part_inputs["gazelle"] = (db, minsup)
            gazelle_payload = SM.serialize_patterns(got)   # phase 23
            mesh_want["cspade"] = digest(want_text)
            single_walls["cspade"] = (round(ccold_s, 3), round(cwarm_s, 3))
        print(f"[mine] gazelle_like(scale={scale}) maxgap=2 maxwindow=5: "
              f"{len(db)} sequences, {vdb.n_items} frequent items, "
              f"W={vdb.n_words}, minsup {minsup}: {len(got)} patterns "
              f"byte-identical to the oracle; cold {ccold_s:.3f} s, warm "
              f"{cwarm_s:.3f} s, oracle {oracle_s:.1f} s (child process); "
              f"geometry dtype {geo['dtype']}, chunk {geo['chunk']}, "
              f"node_batch {geo['node_batch']}, pool_slots "
              f"{geo['pool_slots']}; candidates {cs['candidates']} "
              f"({cs['s_candidates']} s, {cs['i_candidates']} i), engine "
              f"launches {cs['kernel_launches']}, window-mask and B1 "
              f"launches {mask_launches} each, one a node batch with "
              f"candidates, recomputed_nodes "
              f"{cs['recomputed_nodes']}; max_memory_allocated {cpeak} B",
              flush=True)
        del db, got, got_warm, vdb
        torch.cuda.empty_cache()

    clock(17)
    # 17. streaming windows at full size: the incremental miner (B1 once
    # a swept level) and the re-mine miner, byte-identical after every push
    db = part_inputs["msnbc"][0]   # phase 13's database, cut in batches
    per = len(db) // STREAM_PUSHES
    batches = [db[i * per:(i + 1) * per if i < STREAM_PUSHES - 1 else len(db)]
               for i in range(STREAM_PUSHES)]
    del db
    inc = IncrementalWindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP)
    check(inc.use_kernel, "the incremental miner on the card does not use B1")
    remine_routes = []

    def remine(seqs, minsup):
        # WindowMiner's own default mine, with the route recorded
        st: dict = {}
        res = mine_spade_torch(seqs, minsup, shape_buckets=True, stats_out=st)
        remine_routes.append(st.get("fused"))
        return res

    rem = WindowMiner(STREAM_MINSUP, max_batches=STREAM_KEEP, mine=remine)
    stream_texts, widest, swept_levels, stream_b1 = {}, 0, 0, 0
    stream_digests = {}
    # phase 25 serves the stream again: each push's serialization digest
    # and the library's push wall
    stream_served = {}
    stream_bound_ms = 0.0
    counters = ("repaired_nodes", "sweep_candidates", "kernel_launches")
    for push, batch in enumerate(batches, 1):
        # the levels this push's sweep walks: tracked nodes with children
        widths, lv = [], [n for n in inc._root.values() if n.children]
        while lv:
            widths.append(len(lv))
            lv = [c for n in lv for c in n.children.values() if c.children]
        widest = max([widest] + widths)
        before = {k: inc.stats[k] for k in counters}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        PS.pair_supports.launches = 0
        t0 = time.perf_counter()
        got = inc.push(batch)
        torch.cuda.synchronize()
        inc_s = time.perf_counter() - t0
        b1 = PS.pair_supports.launches
        ipeak = torch.cuda.max_memory_allocated()
        check(b1 >= 1 or not widths,
              f"push {push}: the sweep walked {len(widths)} levels but B1 "
              f"launched {b1} times")
        swept_levels += len(widths)
        stream_b1 += b1
        # B1's bound over this push's launches: a level's parents, plain
        # and transformed, against the new batch store's live item rows
        st = list(inc._states.values())[-1]
        push_bound_ms = sum(pair_bound_ms(2 * w, st.ni_rows, st.n_seq,
                                          st.n_words, st.n_present)[0]
                            for w in widths)
        stream_bound_ms += push_bound_ms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        PS.pair_supports.launches = 0
        t0 = time.perf_counter()
        want = rem.push(batch)
        torch.cuda.synchronize()
        rem_s = time.perf_counter() - t0
        rb1 = PS.pair_supports.launches
        rpeak = torch.cuda.max_memory_allocated()
        text = patterns_text(got)
        check(text == patterns_text(want),
              f"push {push}: the incremental and re-mine routes differ:\n"
              + diff_patterns(want, got))
        if push in STREAM_ORACLE_PUSHES:
            stream_texts[push] = text
            stream_digests[push] = digest(text)   # phase 30 holds them
        stream_served[push] = (digest(SM.serialize_patterns(got)), inc_s)
        if push <= MESH_STREAM_PUSHES:
            mesh_want[f"stream push {push}"] = digest(text)
            single_walls[f"stream push {push}"] = (round(inc_s, 3),)
        delta = {k: inc.stats[k] - before[k] for k in counters}
        print(f"[stream] push {push}: window {inc.stats['window_sequences']} "
              f"sequences, minsup {inc.minsup_abs()}, {len(got)} patterns "
              f"byte-identical across the routes; incremental "
              f"{inc_s:.3f} s (phase_s {inc.stats['phase_s']}), swept level "
              f"widths {widths}, B1 launches {b1} (bound summed over them "
              f"{push_bound_ms:.3f} ms), {delta}, tracked_nodes "
              f"{inc.stats['tracked_nodes']}, store_cache_bytes "
              f"{inc.stats['store_cache_bytes']}, max_memory_allocated "
              f"{ipeak} B; re-mine {rem_s:.3f} s (route "
              f"{remine_routes[-1]!r}), B1 launches {rb1}, "
              f"max_memory_allocated {rpeak} B", flush=True)
    for push in STREAM_ORACLE_PUSHES:
        oracle_s, want_text = collect_oracle(oracles[("stream", push)],
                                             f"stream push {push}")
        check(stream_texts[push] == want_text,
              f"push {push}: the stream differs from the oracle's mine of "
              "the window")
        print(f"[stream] push {push}: byte-identical to the oracle's mine of "
              f"the window (oracle {oracle_s:.1f} s, child process)",
              flush=True)
    kept = sum(st.store is not None for st in inc._states.values())
    budget = 0.2 * device_hbm_budget(dev)
    sweep_p = 2 * next_pow2(widest)
    check(sweep_p == STREAM_SWEEP[0],
          f"the widest sweep level ({widest} parents) makes P={sweep_p}, not "
          f"phase 4's {STREAM_SWEEP[0]}")
    print(f"[stream] msnbc_like: {STREAM_PUSHES} pushes of {per} sequences, "
          f"window {STREAM_KEEP}, phase 13's database; B1 launched "
          f"{stream_b1} times over {swept_levels} swept levels (bound summed "
          f"over them {stream_bound_ms:.3f} ms); widest level "
          f"{widest} parents (P = {sweep_p} at the reference's pow2 width); "
          f"warm batch stores kept {kept} of {len(inc._states)} "
          f"({inc.stats['store_cache_bytes']} B against the 0.2 x budget "
          f"{budget:.0f} B); re-mine routes {remine_routes}", flush=True)
    stream_first = batches[0]   # phase 19 mines it again
    stream_spmf = [format_spmf(b) for b in batches]   # phase 25 posts them
    stream_shape = (len(batches[0]), len({i for seq in batches[0]
                                          for its in seq for i in its}))
    del batches, inc, rem, got, want
    torch.cuda.empty_cache()

    clock(18)
    # 18. the repair fold and multiword batches on the card
    rng = np.random.default_rng(MW_STREAM["seed"])
    mw_batches = [synthetic_db(seed=int(rng.integers(1 << 30)),
                               n_sequences=MW_STREAM["per_batch"], n_items=6,
                               mean_itemsets=40.0, mean_itemset_size=1.1)
                  for _ in range(MW_STREAM["batches"])]
    n_words = build_vertical(mw_batches[0]).n_words
    check(n_words >= 2, f"the multiword stream has W={n_words}")
    kern = IncrementalWindowMiner(MW_STREAM["minsup"], max_batches=2)
    gath = IncrementalWindowMiner(MW_STREAM["minsup"], max_batches=2,
                                  use_kernel=False)
    prev, entered, left, repaired_after_first = None, 0, 0, 0
    for push, batch in enumerate(mw_batches, 1):
        r0 = kern.stats["repaired_nodes"]
        PS.pair_supports.launches = 0
        got = kern.push(batch)
        torch.cuda.synchronize()
        b1 = PS.pair_supports.launches
        g_got = gath.push(batch)
        torch.cuda.synchronize()
        check(PS.pair_supports.launches == b1,
              "the gather-join branch launched B1")
        text = patterns_text(got)
        check(text == patterns_text(g_got),
              f"multiword push {push}: B1 and the gather-join differ")
        want = mine_spade(kern.window.sequences(), kern.minsup_abs())
        check(text == patterns_text(want),
              f"multiword push {push} differs from the oracle:\n"
              + diff_patterns(want, got))
        cur = {p for p, _ in got}
        if prev is not None:
            entered += len(cur - prev)
            left += len(prev - cur)
            repaired_after_first += kern.stats["repaired_nodes"] - r0
        prev = cur
        print(f"[stream] multiword W={n_words} push {push}: {len(got)} "
              f"patterns byte-identical to the oracle and to the gather-join "
              f"branch; repaired_nodes +{kern.stats['repaired_nodes'] - r0}, "
              f"B1 launches {b1}, engine launches "
              f"{kern.stats['kernel_launches']} (gather-join "
              f"{gath.stats['kernel_launches']})", flush=True)
    check(repaired_after_first > 0, "no node repaired after the first push")
    check(entered > 0 and left > 0,
          f"patterns crossed the border {entered} times in, {left} out")
    print(f"[stream] multiword: {repaired_after_first} nodes repaired after "
          f"the first push on the card; {entered} patterns entered and {left} "
          f"left the frequent set", flush=True)
    del kern, gath, mw_batches

    clock(19)
    # 19. shape_buckets=True on the card, against the oracle texts above
    bstats: dict = {}
    got = mine_spade_torch(bms_db, bms_minsup, shape_buckets=True,
                           stats_out=bstats)
    check(patterns_text(got) == bms_text,
          "SPADE with shape_buckets differs from phase 5's oracle result")
    print(f"[buckets] SPADE bms_webview2_like auto: route "
          f"{bstats.get('fused')!r}, {len(got)} patterns byte-identical to "
          f"phase 5's oracle result", flush=True)
    bstats = {}
    first_minsup = abs_minsup(STREAM_MINSUP, len(stream_first))
    got = mine_spam_torch(stream_first, first_minsup, shape_buckets=True,
                          stats_out=bstats)
    check(patterns_text(got) == stream_texts[1],
          "SPAM with shape_buckets differs from the first window's oracle")
    print(f"[buckets] SPAM on phase 17's first batch ({len(stream_first)} "
          f"sequences): {len(got)} patterns byte-identical to the oracle's "
          f"mine of push 1; waves {bstats['waves']}", flush=True)
    bstats = {}
    got_t = mine_tsr_torch(tsr_small_db, 100, 0.5, max_side=None,
                           shape_buckets=True, stats_out=bstats)
    check(rules_text(got_t) == tsr_small_text,
          "TSR with shape_buckets differs from mine_tsr_cpu")
    print(f"[buckets] TSR kosarak_like(scale=0.01) max_side=None: "
          f"{'the resident route' if bstats.get('resident') else 'the host loop'}"
          f", {len(got_t)} rules byte-identical to mine_tsr_cpu", flush=True)
    c_db, c_minsup, c_text = cspade_small
    bstats = {}
    got = mine_cspade_torch(c_db, c_minsup, maxgap=2, maxwindow=5,
                            shape_buckets=True, stats_out=bstats)
    check(patterns_text(got) == c_text,
          "cSPADE with shape_buckets differs from the oracle")
    print(f"[buckets] cSPADE gazelle_like(scale={GAZELLE_SCALES[-1]}): "
          f"{len(got)} patterns byte-identical to the oracle; geometry "
          f"{bstats['geometry']}", flush=True)
    mesh_bms = bms_db   # phase 21 mines it again
    part_inputs.update(kos_vdb=kos_vdb, tsr_small_db=tsr_small_db,
                       bms=(bms_db, bms_minsup))
    del got, got_t, bms_db, stream_first, tsr_small_db, cspade_small
    del kos_vdb

    clock(20)
    # 20. prediction scoring over the rule sets of phases 9, 5 and 13
    predict_phase(torch, dev, [predict_sets[k] for k in ("tsr", "spade",
                                                         "spam")])

    clock(21)
    # 21. sequence meshes on the card
    tenth: dict = {}
    mesh_phase(torch, mesh_want, single_walls, card, mesh_bms, tenth)
    del mesh_bms

    clock(22)
    # 22. class-partitioned mines at full size in this process
    part_walls: dict = {}
    partition_phase(torch, part_inputs, mesh_want, single_walls, card,
                    part_walls)

    clock(23)
    # 23. the service over HTTP on the full-size databases above
    (bms_db, bms_minsup), (ms_db, ms_minsup), (gz_db, gz_minsup) = (
        part_inputs[k] for k in ("bms", "msnbc", "gazelle"))
    kos_db = service_dbs.pop("kosarak")
    service_phase(torch, card, [
        ("kosarak", kos_db,
         dict(algorithm="TSR_TPU", k="100", minconf="0.5", max_side="2"),
         "rules", predict_sets["tsr"][2], single_walls["tsr"], "b2"),
        ("msnbc", ms_db, dict(algorithm="SPAM_TPU", support=str(ms_minsup)),
         "patterns", predict_sets["spam"][2], single_walls["spam"], "b3"),
        ("gazelle", gz_db, dict(algorithm="SPADE_TPU", support=str(gz_minsup),
                                maxgap="2", maxwindow="5"),
         "patterns", gazelle_payload, single_walls["cspade"], "masks"),
        ("bms", bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
         "patterns", predict_sets["spade"][2], single_walls["spade auto"],
         "b1"),
        ("bms", bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
         "patterns", None, single_walls["spade auto"], "b1"),
    ], {name: (what, kind, payload, prefixes[:16])
        for name, (what, kind, payload, prefixes) in (
            ("kosarak", predict_sets["tsr"]),
            ("bms", predict_sets["spade"]))})
    del gz_db

    clock(24)
    # 24. the warm and fused service
    bms_vdb = build_vertical(bms_db, min_item_support=bms_minsup)
    small_db = part_inputs["tsr_small_db"]
    small_vdb = build_vertical(small_db, min_item_support=1)
    warm_phase(torch, card, (
        bms_db, dict(algorithm="SPADE_TPU", support=str(bms_minsup)),
        predict_sets["spade"][2], "patterns",
        dict(sequences=len(bms_db), items=bms_vdb.n_items,
             words=bms_vdb.n_words)), (
        small_db, dict(algorithm="TSR_TPU", k="100", minconf="0.5"),
        tsr_small_payload, "rules",
        dict(sequences=len(small_db), items=small_vdb.n_items,
             words=small_vdb.n_words, tsr=True)))
    del bms_vdb, small_vdb
    ms_tenth = msnbc_like(scale=MESH_MSNBC_SCALE, fast=True)
    ms_rules = SM.serialize_rules(mine_tsr_torch(ms_tenth, 100, 0.5,
                                                 max_side=2))
    fusion_phase(torch, card, tenth["db"], part_inputs["kos_vdb"],
                 tenth["payload"], mesh_want["tsr"], ms_tenth, ms_rules,
                 tenth["b2"], RULE_HEADLINE[:2])
    del ms_tenth
    clock(25)
    # 25. the service on a mesh
    bms_payload = predict_sets["spade"][2]
    spam_payload = predict_sets["spam"][2]   # phase 26 holds it
    del predict_sets
    mesh_service_phase(torch, card, {
        "kos_vdb": part_inputs["kos_vdb"], "tsr": mesh_want["tsr"],
        "bms": (bms_db, bms_minsup), "spade": mesh_want["spade auto"],
        "spade payload": bms_payload,
        "spade wall": single_walls["spade auto"],
        "tenth": (tenth["db"], tenth["payload"], tenth["wall"],
                  tenth["digest"]),
        "part walls": part_walls,
        "world part tsr": tenth.get("world part tsr"),
        "stream texts": stream_spmf, "stream": stream_served,
        "stream batch": stream_shape[0], "stream items": stream_shape[1]})
    del kos_db, small_db
    # phases 26-30 serve their replicas' store (a MiniRedis) from this
    # process: a full collection over the earlier phases' databases (tens
    # of millions of tuples) stalls it for seconds, past a replica's 2 s
    # lease, so those objects leave the collector's view
    gc.freeze()
    clock(26)
    # 26. the replicated service
    replica_phase(torch, card, {
        "bms": (bms_db, bms_minsup), "bms payload": bms_payload,
        "bms wall": single_walls["spade auto"],
        "msnbc": (ms_db, ms_minsup), "msnbc payload": spam_payload,
        "msnbc wall": single_walls["spam"],
        "tenth": (tenth["db"], tenth["payload"], tenth["wall"])})
    clock(27)
    # 27. faults and bitrot on the engines and the service
    fault_inp = {
        "tsr 1%": (part_inputs["tsr_small_db"], mesh_want["tsr 1%"]),
        "bms": (bms_db, bms_minsup), "bms payload": bms_payload,
        "bms wall": single_walls["spade auto"],
        "tenth": (tenth["db"], tenth["payload"], tenth["wall"])}
    fault_phase(torch, card, fault_inp)
    clock(28)
    # 28. result reuse, usage and the flight recorder at size; phase 29's
    # replicas and phase 30's child boot beside it
    fleet = fleet_boot(torch, fault_inp)
    started = sources_child(torch)
    try:
        planes_phase(torch, card, fault_inp)
    except BaseException:
        fleet_stop(fleet)
        started[0].stop()
        raise
    clock(29)
    # 29. the elastic fleet: fairness, scale-up, a drain, a seeded storm
    try:
        fleet_phase(torch, card, fault_inp, fleet)
    except BaseException:
        started[0].stop()
        raise
    clock(30)
    # 30. the sources, the remote entry and the stream consumer
    sources_phase(torch, card, dict(
        fault_inp, **{"stream texts": stream_spmf,
                      "stream digests": stream_digests,
                      "stream walls": [round(stream_served[p][1], 3)
                                       for p in sorted(stream_served)]}),
                  started)
    del part_inputs, bms_db, ms_db, tenth, fault_inp, stream_spmf
    print(f"[clock] every phase done at {time.perf_counter() - T_START:.1f} "
          f"s", flush=True)

    print(json.dumps({"kernels": [pair_record, rule_record, {
        "name": "extend_prune", "route": "cuda",
        "source": "spark_fsm_tpu_torch/csrc/extend_prune.cu",
        "replaces": "spark_fsm_tpu/ops/pallas_extend.py:172",
        "launches": elaunches, "max_abs_err": eworst,
        "ms": ems, "plain_ms": eplain_ms, "bound_ms": ebound_ms,
        "bound_by": ebound_by, "library_ms": None,
    }, mask_record]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
