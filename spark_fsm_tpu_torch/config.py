"""Boot configuration — the reference's Configuration/application.conf analog.

The reference loads service host/port, Spark properties, and Redis/ES
endpoints from a Typesafe Config file at boot (SURVEY.md sec 1 L0, sec 5
config row); per-request knobs stay in the request's string map.  The
rebuild keeps that split: this module owns the boot-time knobs — service
address, store backend, device-mesh size, engine memory/batching budgets,
profiler output — loaded from a TOML or JSON file, while ``ServiceRequest``
carries the per-job vocabulary (``algorithm``, ``support``, ...).

File format (TOML shown; JSON with the same nesting also accepted):

    profile_dir = "traces"          # jax.profiler output root ("" = off)
    fault_injection = false         # allow /admin/faults (chaos lab) — the
                                    # endpoint is refused unless true

    [service]
    host = "0.0.0.0"
    port = 9000
    miner_workers = 2
    remote_port = 0                 # actor-protocol TCP entry (0 = off)
    job_retries = 1                 # failed-job re-runs before 'failure'
    queue_depth = 256               # bounded admission queue: submits past
                                    # this many queued jobs shed with HTTP
                                    # 429 + Retry-After (0 = unbounded)

    [store]
    backend = "inproc"              # or "redis"
    host = "127.0.0.1"
    port = 6379
    timeout_s = 10.0                # redis socket timeout (transport
                                    # failures past it surface as OSError
                                    # — what the storeguard probe reads)

    [storeguard]
    enabled = false                 # store-outage survival (service/
                                    # storeguard.py): health state machine
                                    # + write-behind durability spool +
                                    # outage-aware lease stalls; off = one
                                    # `is None` read per durable write
    probe_every_s = 1.0             # active store probe cadence while
                                    # unhealthy (0 = manual ticks, tests)
    down_after = 1                  # consecutive transport failures before
                                    # the probe is consulted for DOWN —
                                    # 1 (default) probes on the FIRST
                                    # failure, so an outage never burns a
                                    # job's retry budget before it is
                                    # proven; raise to probe lazier
    spool_max_entries = 512         # per-job write-behind spool bound;
                                    # overflow fences the job (terminal)
    stall_max_s = 120.0             # longest a job may stall at a safe
                                    # point waiting out an outage before
                                    # it conservatively self-fences
                                    # (0 = stall as long as the outage)
    ephemeral_admission = false     # admit loudly-flagged no-journal jobs
                                    # during an outage instead of 429

    [distributed]
    enabled = false                 # true: jax.distributed.initialize at boot
    coordinator_address = ""        # "" = JAX env vars / cloud auto-detect
    # num_processes / process_id: omit for env-var/cloud auto-detect

    [cluster]
    enabled = false                 # lease-fenced multi-replica mode: N
                                    # service replicas safely share ONE
                                    # Redis namespace (service/lease.py)
    replica_id = ""                 # "" = generated per boot (REQUIRED
                                    # unique per replica if set manually)
    lease_ttl_s = 10.0              # per-job lease TTL; a crashed
                                    # replica's jobs are adoptable after
                                    # at most this long
    heartbeat_s = 0.0               # renewal/heartbeat cadence
                                    # (0 = lease_ttl_s / 3)
    steal = true                    # idle replicas claim queued jobs
                                    # from loaded peers
    recover_every_s = 0.0           # periodic orphan-recovery cadence
                                    # (0 = lease_ttl_s)

    [engine]
    mesh_devices = 8                # 0 = single chip (no mesh)
    pool_bytes = 2147483648         # HBM slot-pool budget (default: adaptive, 35% of device HBM)
    node_batch = 256                # DFS nodes per device dispatch (default 1024, clamped to the pool)
    pipeline_depth = 4              # in-flight support readbacks
    chunk = 256                     # SPADE support-count batch width
    recompute_chunk = 256
    tsr_chunk = 2048                # TSR candidate batch (default adaptive)
    item_cap = 256                  # TSR iterative-deepening width
    fused = "auto"                  # SPADE routing: auto / always / never
                                    # / queue / dense (engine pins)
    watchdog_slack = 20.0           # dispatch watchdog: deadline = max(
                                    # watchdog_floor_s, estimate x slack);
                                    # omit to disable (utils/watchdog.py)
    watchdog_floor_s = 2.0

    [observability]
    trace = false                   # per-job flight recorder (utils/obs.py);
                                    # off = one global read per probe
    trace_max_spans = 512           # completed-span ring per job
    trace_jobs = 16                 # job traces kept (oldest evicted)
    spine_flush_spans = 32          # spans buffered per trace before an
                                    # automatic durable-spine flush
                                    # (cluster mode; terminal paths and
                                    # checkpoint saves always flush)
    spine_max_chunks = 256          # fsm:trace:{uid} retention: newest
                                    # N chunks kept (0 = unbounded)
    slo_window_s = 300.0            # /admin/slo sliding window

    [fusion]
    enabled = false                 # cross-job launch fusion broker
                                    # (service/fusion.py); off = one global
                                    # read per dispatch probe
    window_ms = 4.0                 # bounded fusion window: how long a
                                    # normal/low wave may wait for peers
    max_jobs = 8                    # waves co-scheduled into one launch
    max_width = 16384               # fused candidate-lane ceiling (pow2)
    dispatch_workers = 2            # broker dispatcher threads (matured
                                    # groups run concurrently)

    [partition]
    enabled = false                 # equivalence-class partitioned mining
                                    # (parallel/partition.py): split the
                                    # candidate frontier over the outer
                                    # axis of a 2-D parts x seq mesh
    parts = 0                       # partitions (0 = auto: one per
                                    # process in a multi-controller run,
                                    # else 2 when the mesh has >= 2
                                    # devices, else off)
    classes = 64                    # km-prefix hash buckets balanced
                                    # over the partitions

    [rescache]
    enabled = false                 # result-reuse tier above admission
                                    # (service/resultcache.py): content-
                                    # addressed dataset fingerprints,
                                    # in-flight request coalescing, and
                                    # dominance-based cache serving; off
                                    # = one attribute read per submit
    max_bytes = 67108864            # LRU byte budget for cached result
                                    # entries (0 = unbounded)
    coalesce = true                 # attach identical in-flight requests
                                    # as followers of one execution
    dominance = true                # serve dominated requests by host-
                                    # side filtering of cached results

    [fairness]
    enabled = false                 # weighted-fair multi-tenant admission
                                    # (service/fairness.py): DRR across
                                    # tenants within each priority class
    tenant_depth = 64               # per-tenant queued-job cap (0 = none)
    max_tenants = 64                # bounded live tenant vocabulary
    default_weight = 1.0            # weight for tenants not listed below
    [fairness.weights]              # tenant -> relative weight
    # gold = 4.0
    # free = 1.0

    [autoscale]
    enabled = false                 # elastic control plane (service/
                                    # autoscale.py); requires [cluster]
    min_replicas = 1
    max_replicas = 8
    up_queue_per_worker = 2.0       # scale up past this queued/worker
    up_p99_s = 0.0                  # scale up past this SLO p99 (0 = off)
    up_rate_derivative = 0.0        # PREDICTIVE scale-up: EWMA of the
                                    # fleet admission-rate derivative
                                    # (jobs/s per second) above which
                                    # load is accelerating (0 = off);
                                    # rides the same hold_s hysteresis
    rate_alpha = 0.3                # EWMA smoothing for the admission
                                    # rate and its derivative, in (0,1]
    down_free_frac = 0.5            # scale down past this idle fraction
    hold_s = 10.0                   # signal must persist (hysteresis)
    cooldown_s = 30.0               # min gap between decisions
    decide_every_s = 0.0            # controller cadence (0 = ttl/3)
    leader_ttl_s = 3.0              # fsm:autoscale:leader lease TTL
    drain_timeout_s = 60.0          # drain wait before exiting anyway

    [planner]
    mode = "auto"                   # engine planner (service/planner.py)
                                    # for algorithm=AUTO requests:
                                    # "auto" = density-crossover routing,
                                    # "pinned" = always route AUTO to the
                                    # engine below
    pinned = "SPADE_TPU"            # the engine AUTO resolves to under
                                    # pinned mode
    density_crossover = 0.02        # route patterns-AUTO to SPAM_TPU at
                                    # dataset density >= this (distinct
                                    # (item,seq) pairs / (alphabet*seqs);
                                    # calibrated — docs/DESIGN.md)
    max_alphabet = 512              # SPAM eligibility ceiling on the
                                    # frequent-alphabet width
    representation = "auto"         # per-ITEM vertical store within a
                                    # mine: "auto" = density crossover
                                    # picks bitmap (dense) vs id-list
                                    # (sparse) per item; "bitmap"/
                                    # "idlist" pin a uniform store
                                    # (debugging/bench lever)
    diffset_depth = 3               # pattern length at which supports
                                    # switch to the dEclat diffset
                                    # formulation (parent_support -
                                    # |diffset|); 0 disables

    [prewarm]
    enabled = true                  # AOT-compile the declared envelope at boot
    sequences = 77500               # expected dataset scale
    items = 384                     # expected frequent-projection width
    words = 1
    stream_batch_sequences = 99000  # per-push micro-batch size (0 = skip)
    stream_items = 256
    stream_seq_floor = 99000        # pin early pushes to the steady bucket

Unknown keys are rejected (a typo'd knob must not silently no-op).

Port: a copy of ``spark_fsm_tpu/config.py`` with its imports pointed at
``spark_fsm_tpu_torch``.  Every section, default and validation rule is
the reference's; :func:`refuse_unported` refuses the knobs whose planes
the port does not serve yet (``[engine] mesh_devices > 0``,
``[distributed]`` and ``[meshguard]`` enabled), and :func:`get_mesh` is
always None.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ServiceConfig:
    host: str = "127.0.0.1"
    port: int = 9000
    miner_workers: int = 1
    remote_port: int = 0  # actor-protocol TCP entry (0 = disabled)
    job_retries: int = 1  # re-runs of a failed train job before 'failure'
    queue_depth: int = 256  # admission-queue bound: queued (not yet
    # running) train jobs past this shed with 429 + Retry-After derived
    # from the cost model (0 = unbounded — the pre-admission behavior)


@dataclasses.dataclass
class StoreConfig:
    backend: str = "inproc"  # "inproc" | "redis"
    host: str = "127.0.0.1"
    port: int = 6379
    timeout_s: float = 10.0  # redis socket timeout; a blackholed store
    # surfaces as OSError after at most this long — the storm harness
    # (scripts/storm_smoke.py) shrinks it so outage detection is prompt


@dataclasses.dataclass
class StoreGuardConfig:
    """Store-outage survival (service/storeguard.py): a health state
    machine (healthy/flaky/down) consulted by every durable-write path,
    a bounded per-job write-behind spool that holds fenced writes while
    the store is DOWN and replays them IN ORDER under the same fencing
    token on reconnect, and outage-aware lease semantics — a holder
    whose renewals fail while the probe proves the store unreachable
    STALLS at its next jobctl safe point instead of raising terminal
    LEASE_LOST, and resumes through the journal-gated NX reacquire when
    the store returns.

    ``enabled = false`` (the default) builds no guard objects: every
    durable write pays exactly one ``is None`` read
    (scripts/bench_smoke.sh's dispatch counters stay byte-identical).
    ``probe_every_s`` is the active-probe cadence while unhealthy (0 =
    manual ticks — tests drive ``tick()``); ``down_after`` is how many
    consecutive transport failures arm the probe for the DOWN verdict;
    ``spool_max_entries`` bounds each job's spool (overflow fences the
    job — the current terminal-failure posture, never silent loss);
    ``stall_max_s`` bounds how long a job may wait out an outage at a
    safe point before conservatively self-fencing (0 = unbounded);
    ``ephemeral_admission`` admits loudly-flagged NO-JOURNAL jobs
    during an outage instead of shedding 429 (their results ride the
    spool; a crash before the store returns loses them — the flag in
    the submit response says so).
    """

    enabled: bool = False
    probe_every_s: float = 1.0
    down_after: int = 1
    spool_max_entries: int = 512
    stall_max_s: float = 120.0
    ephemeral_admission: bool = False


@dataclasses.dataclass
class EngineConfig:
    """Boot-time engine knobs; ``None`` means the engine's own default."""

    mesh_devices: int = 0  # 0 = no mesh; N = shard seq axis over N devices
    pool_bytes: Optional[int] = None
    node_batch: Optional[int] = None
    pipeline_depth: Optional[int] = None
    chunk: Optional[int] = None  # SPADE engines (default 2048 there)
    recompute_chunk: Optional[int] = None
    tsr_chunk: Optional[int] = None  # TSR candidate batch (default: sized
    # to the eval HBM budget — see models/tsr.py TsrTPU.__init__)
    item_cap: Optional[int] = None  # TSR iterative-deepening width
    fused: Optional[str] = None  # SPADE engine routing: "auto" (default) /
    # "always" / "never" / "queue" / "dense" (engine pins) — see
    # models/spade_tpu.mine_spade_tpu
    watchdog_slack: Optional[float] = None  # dispatch watchdog: deadline =
    # max(floor, cost-model estimate x slack); None (default) disables —
    # see utils/watchdog.py (enable on TPU deployments; the estimate is
    # anchored on TPU kernel walls)
    watchdog_floor_s: Optional[float] = None  # minimum deadline (default 2.0)


@dataclasses.dataclass
class PrewarmConfig:
    """AOT prewarm envelope (service/prewarm.py): the data geometry the
    deployment expects to serve, declared so every compile is paid at
    boot instead of on the first live ``/train``/``/stream`` (the 41.7 s
    cache-miss cold start, BASELINE.json ``cold_start``).

    ``sequences``/``items``/``words``: expected dataset scale and
    frequent-projection width for batch mines (0 = skip batch shapes).
    ``maxgap``/``maxwindow``: the cSPADE constraint pair requests will
    carry (each pair compiles different kernels; unset = skip).
    ``tsr``: also compile the TSR engine's static geometry.
    ``stream_batch_sequences``/``stream_items``: the incremental
    streaming envelope (per-push micro-batch size + window frequent-item
    width; 0 = skip streaming shapes).  ``stream_seq_floor``: pin live
    batch stores to at least this sequence bucket so early small pushes
    land on the prewarmed shapes (normally = stream_batch_sequences).
    ``checkpointed``: also compile the segmented (resumable) queue
    programs.
    """

    enabled: bool = False
    sequences: int = 0
    items: int = 0
    words: int = 1
    maxgap: Optional[int] = None
    maxwindow: Optional[int] = None
    tsr: bool = False
    stream_batch_sequences: int = 0
    stream_items: int = 0
    stream_seq_floor: int = 0
    checkpointed: bool = False
    max_tokens: int = 0  # token-table bound for store-build warming
    # (0 = 8 x sequences; see utils/shapes.WorkloadSpec)


@dataclasses.dataclass
class ObservabilityConfig:
    """Flight-recorder gating (utils/obs.py).  ``trace = false`` (the
    default) pins the disabled path to one module-global read per
    probe — the same contract as the fault registry; the metrics
    registry behind ``GET /metrics`` is always on (registry writes are
    a lock + dict update, and a scrape must work on any deployment).
    ``trace_max_spans`` bounds each job's completed-span ring (oldest
    evicted first); ``trace_jobs`` bounds how many job traces are kept.

    Cluster observability plane:
    ``spine_flush_spans`` is how many completed spans buffer per trace
    before an automatic flush to the durable spine (``fsm:trace:{uid}``;
    checkpoint saves and terminal paths flush regardless);
    ``spine_max_chunks`` bounds each uid's spine list (newest kept,
    0 = unbounded); ``slo_window_s`` is the /admin/slo sliding window.
    """

    trace: bool = False
    trace_max_spans: int = 512
    trace_jobs: int = 16
    spine_flush_spans: int = 32
    spine_max_chunks: int = 256
    slo_window_s: float = 300.0


@dataclasses.dataclass
class FusionConfig:
    """Cross-job launch fusion broker (service/fusion.py): co-schedule
    candidate waves from concurrent mines that share a device geometry
    into one super-batched launch.

    ``enabled``: route eligible engine waves through the broker (the
    disabled path costs one module-global read per dispatch probe —
    same pin as the fault registry).  ``window_ms``: the bounded fusion
    window — how long a normal/low-priority wave may wait for fusion
    peers before launching anyway (a ``high`` wave never waits: it
    launches immediately with whatever is already pending).
    ``max_jobs``: waves fused into one launch; ``max_width``: fused
    candidate-lane ceiling (the window also closes when pending lanes
    reach it).  ``dispatch_workers``: broker dispatcher threads —
    matured window groups with disjoint membership are independent
    device work, and a single serialized dispatcher would forfeit the
    concurrency the Miner worker pool feeds the broker (a group
    blocked in readback must not stall the next matured window).
    """

    enabled: bool = False
    window_ms: float = 4.0
    max_jobs: int = 8
    max_width: int = 16384
    dispatch_workers: int = 2


@dataclasses.dataclass
class PartitionConfig:
    """Equivalence-class partitioned mining (parallel/partition.py +
    models/tsr.TsrPartitioned): the candidate frontier splits by
    km-prefix class over the outer axis of a 2-D ``parts x seq`` mesh,
    each partition keeps the inner seq-axis shard + psum, and the only
    cross-partition traffic is one small exchange per round.  Output is
    byte-identical to the unpartitioned route (docs/DESIGN.md).

    ``parts = 0`` resolves at request time: one partition per process
    in a multi-controller run, else 2 when the boot mesh splits evenly,
    else partitioning stays off.  An explicit ``parts`` that cannot
    split the topology degrades to unpartitioned with a
    ``partition_config_invalid`` log line (a config typo must not fail
    every train request).  ``classes`` is the
    class-hash granularity (must comfortably exceed ``parts`` for the
    LPT balance to bite; 64 is plenty up to ~16 partitions).
    """

    enabled: bool = False
    parts: int = 0
    classes: int = 64


@dataclasses.dataclass
class MeshguardConfig:
    """Topology-survival plane (service/meshguard.py): per-partition-row
    health state machine (healthy -> suspect -> dead) fed by watchdog
    timeouts and ``device.dispatch``/``device.resident`` fault trips,
    plus an active zero-width probe per row.  Row deaths bump a
    monotonic ``topology_epoch`` published on the lease heartbeat; the
    partitioned orchestrator re-plans the dead row's equivalence
    classes LPT onto survivors and resumes from the composite frontier
    (parallel/partition.py ``replan_surviving``), byte-identical to the
    healthy mine (docs/DESIGN.md).

    ``enabled = false`` (default) keeps every dispatch probe at one
    module-global read and the pre-meshguard behavior byte-identical.
    ``dead_after`` is how many device-shaped trips move a row from
    suspect to dead (the first trip is always only suspect — one flaky
    launch must not kill a row).  ``probe_every_s`` is the active-probe
    cadence riding the lease heartbeat (0 = passive trips only).
    ``max_retries`` bounds per-round adoption attempts in the
    orchestrator before the mine fails for real (a mesh losing rows
    faster than re-planning converges is dead, not degraded).
    """

    enabled: bool = False
    dead_after: int = 2
    probe_every_s: float = 0.0
    max_retries: int = 4


@dataclasses.dataclass
class RescacheConfig:
    """Result-reuse tier above admission (service/resultcache.py):
    content-addressed dataset fingerprints, in-flight request
    coalescing (identical requests attach as followers of one
    execution with fan-out delivery), and dominance-based serving
    (a completed cached result answers strictly weaker requests by
    host-side filtering — zero device work).  The dominance predicates
    are proven conservative in docs/DESIGN.md.

    ``enabled = false`` (default) keeps the pre-rescache admission path
    byte-identical: the Miner holds no cache instance and every submit
    pays one attribute read.  ``max_bytes`` bounds the cached result
    entries with LRU eviction over a cursor SCAN (0 = unbounded).
    ``coalesce`` / ``dominance`` gate the two serving layers
    independently (fingerprinting stays on for both).
    """

    enabled: bool = False
    max_bytes: int = 67108864  # 64 MiB
    coalesce: bool = True
    dominance: bool = True


@dataclasses.dataclass
class FairnessConfig:
    """Weighted-fair multi-tenant admission (service/fairness.py):
    per-tenant token buckets layered UNDER the strict priority classes —
    within each class, queued jobs are served deficit-weighted
    round-robin across tenants, and each tenant's queue occupancy is
    capped, so one flooding tenant sheds 429s (with a Retry-After
    derived from its OWN bucket refill) while every other tenant's
    goodput holds at its weight-fair share.

    ``enabled = false`` (default) keeps the admission queue exactly as
    before — plain FIFO within each priority class, tenant param
    accepted but ignored (bench_smoke's dispatch counters stay
    byte-identical).  ``tenant_depth`` is each tenant's queued-job cap
    (its bucket size; 0 = no per-tenant cap — the global queue_depth
    still binds).  ``max_tenants`` bounds the live tenant vocabulary
    (tenant names label fsm_tenant_* series — unbounded cardinality is
    an operator hazard); a NEW tenant past the bound is refused with a
    failure envelope.  ``weights`` maps tenant name -> relative weight
    (``[fairness.weights]`` table in TOML); unlisted tenants get
    ``default_weight``.
    """

    enabled: bool = False
    tenant_depth: int = 64
    max_tenants: int = 64
    default_weight: float = 1.0
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AutoscaleConfig:
    """Elastic control plane (service/autoscale.py): a per-replica
    controller, leader-elected through a short-TTL ``fsm:autoscale:
    leader`` lease on the shared store, watches cluster queue depth,
    free capacity and the /admin/slo p99 and emits scale decisions —
    scale-UP publishes a desired-replica-count record
    (``fsm:autoscale:desired``) an operator hook or scripts/fleet.py
    acts on; scale-DOWN writes a drain directive for the least-loaded
    replica, which stops admitting, lets peers steal its queue,
    releases its leases and exits.

    Requires ``[cluster] enabled`` (the lease substrate IS the control
    plane's transport).  ``up_queue_per_worker``: queued jobs per
    fleet worker above which the fleet is under-provisioned.
    ``up_p99_s``: scale up when the /admin/slo e2e p99 exceeds this
    (0 = ignore the latency signal).  ``down_free_frac``: fraction of
    fleet workers idle (with an empty queue) above which the fleet is
    over-provisioned.  ``hold_s``: a signal must persist this long
    before it becomes a decision (hysteresis — load oscillating inside
    the band produces ZERO decisions); ``cooldown_s``: minimum gap
    between decisions.  ``decide_every_s`` (0 = leader_ttl_s / 3) is
    the controller cadence; ``leader_ttl_s`` bounds how long a dead
    leader stalls the loop.  ``drain_timeout_s``: how long a draining
    replica waits for peers to steal its queue before exiting anyway
    (leftovers become journal orphans the survivors' periodic recovery
    adopts — slower, never lost).
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    up_queue_per_worker: float = 2.0
    up_p99_s: float = 0.0
    # predictive scale-up (ROADMAP item 4 remainder): the leader tracks
    # the fleet's lifetime admission count (heartbeat-piggybacked),
    # EWMA-smooths its rate and the rate's derivative, and treats a
    # sustained positive derivative >= this (jobs/s per second) as an
    # up signal BEFORE the queue has built — guarded by the same hold_s
    # hysteresis as the reactive signals (0 = off, the default)
    up_rate_derivative: float = 0.0
    rate_alpha: float = 0.3
    down_free_frac: float = 0.5
    hold_s: float = 10.0
    cooldown_s: float = 30.0
    decide_every_s: float = 0.0
    leader_ttl_s: float = 3.0
    drain_timeout_s: float = 60.0


@dataclasses.dataclass
class PlannerConfig:
    """Dataset-shape-aware engine planner (service/planner.py) for
    ``algorithm=AUTO`` requests.  ``mode = "auto"`` (default) routes by
    the calibrated density crossover — patterns requests go to the SPAM
    fixed-shape wave engine when the dataset is dense enough
    (``density_crossover``) and the frequent alphabet narrow enough
    (``max_alphabet``), to the SPADE candidate-list engines otherwise;
    rules requests always route to TSR.  ``mode = "pinned"`` routes
    every AUTO to ``pinned`` unconditionally (soak/exclusion lever).
    Explicit ``algorithm=`` names bypass the planner entirely."""

    mode: str = "auto"
    pinned: str = "SPADE_TPU"
    density_crossover: float = 0.02
    max_alphabet: int = 512
    # per-item representation routing WITHIN a mine: the same
    # crossover that routes the engine routes each item to a dense SPAM
    # bitmap row or a SPADE id-list; "bitmap"/"idlist" pin a uniform
    # store (the debugging/bench fixed-representation modes)
    representation: str = "auto"
    # pattern length at which the engines switch to the dEclat diffset
    # support formulation (byte-identical by construction; 0 disables)
    diffset_depth: int = 3


@dataclasses.dataclass
class DistributedConfig:
    """Multi-host (jax.distributed) wiring; all-defaults = single host.

    ``enabled`` with empty coordinator/counts defers to JAX's own env vars
    and cloud auto-detection (see parallel/multihost.py).
    """

    enabled: bool = False
    coordinator_address: str = ""  # "" = JAX env var / auto-detect
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclasses.dataclass
class ClusterConfig:
    """Lease-fenced multi-replica service (service/lease.py): N replicas
    share one Redis journal namespace; per-job leases with fencing
    tokens make any replica's crash degrade capacity, never
    correctness.  ``enabled = false`` (default) keeps the earlier work
    single-instance posture at zero cost.

    ``replica_id`` must be unique per replica when set; "" generates one
    per boot.  ``lease_ttl_s`` bounds failover latency (a dead
    replica's jobs are adoptable after at most one TTL) and bounds how
    long a stalled replica may still believe it owns a job.
    ``heartbeat_s`` (0 = ttl/3) is the renewal cadence — /3 so two
    failed renewals still leave one attempt before the TTL lapses.
    ``steal`` lets idle replicas claim queued jobs from loaded peers.
    ``recover_every_s`` (0 = ttl) is the periodic orphan-adoption scan
    cadence.  ``max_adoptions`` is the crash-loop quarantine bound
    (service/meshguard.py + recover_orphans): a job whose journal
    intent records this many adoption resubmits settles as a durable
    ``POISON:`` failure instead of burning another replica — released
    only via ``/admin/quarantine``.
    """

    enabled: bool = False
    replica_id: str = ""
    lease_ttl_s: float = 10.0
    heartbeat_s: float = 0.0
    steal: bool = True
    recover_every_s: float = 0.0
    max_adoptions: int = 3


@dataclasses.dataclass
class PredictConfig:
    """Prediction serving plane (`POST /predict`, service/predictor.py):
    mined rule sets compile into device-resident packed tries and
    concurrent same-artifact requests fuse into one scoring wave.

    ``window_ms`` is the micro-batch window (0 disables fusion — every
    request launches solo); ``max_wave`` caps requests per wave (and
    bounds the enumerated pow2 wave ladder prewarm compiles).  ``topm``
    is the default consequent count when a request omits ``m``.
    ``lanes_floor`` / ``depth_floor`` pad every artifact UP to a shared
    geometry envelope so live predicts land on prewarmed shape keys
    (the stream_seq_floor idea applied to serving); a longer observed
    prefix or bigger rule set still works — it just compiles its own
    geometry on first touch.  ``artifact_entries`` / ``artifact_bytes``
    bound the compiled-trie LRU exactly like fusion's fused-prep cache.
    """

    enabled: bool = True
    window_ms: float = 2.0
    max_wave: int = 16
    topm: int = 8
    lanes_floor: int = 1024
    depth_floor: int = 16
    artifact_entries: int = 8
    artifact_bytes: int = 256 << 20


@dataclasses.dataclass
class IntegrityConfig:
    """Durable-state integrity plane (utils/envelope.py +
    service/integrity.py): every durable write is checksum-enveloped and
    verified on read unconditionally; this section tunes only the
    BACKGROUND SCRUBBER that verifies envelopes at rest.

    ``enabled = false`` removes the scrubber entirely (verify-on-read
    stays — it is a correctness property, not a feature).
    ``scrub_every_s`` is the pass cadence (riding the cluster heartbeat
    when one exists, a private daemon thread on solo boots; 0 = manual
    passes only, via tests/admin).  ``scrub_batch`` bounds the keys
    examined per pass — the walk carries its cursor across passes, so
    a large store is scrubbed incrementally, never in one scan storm.
    """

    enabled: bool = True
    scrub_every_s: float = 60.0
    scrub_batch: int = 256


@dataclasses.dataclass
class UsageConfig:
    """Resource attribution & usage metering plane (service/usage.py):
    per-job/per-tenant device-cost ledger with conservation guarantees.

    ``enabled = false`` (the default) removes the meter entirely —
    every dispatch-surface deposit probe then costs one module-global
    read, and dispatch behavior is byte-identical to a build without
    the plane.  ``window_s`` is the per-tenant sliding rollup window
    (the obs.SlidingQuantiles horizon behind ``/admin/usage`` window
    stats).  ``flush_every_s`` is the minimum interval between durable
    ledger flushes (riding the lease heartbeat in cluster mode, a
    private timer on solo boots).  ``top_jobs`` bounds the top-N
    settled-jobs table in ``/admin/usage``."""

    enabled: bool = False
    window_s: float = 300.0
    flush_every_s: float = 15.0
    top_jobs: int = 10


@dataclasses.dataclass
class Config:
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    distributed: DistributedConfig = dataclasses.field(
        default_factory=DistributedConfig)
    prewarm: PrewarmConfig = dataclasses.field(default_factory=PrewarmConfig)
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    partition: PartitionConfig = dataclasses.field(
        default_factory=PartitionConfig)
    cluster: ClusterConfig = dataclasses.field(
        default_factory=ClusterConfig)
    meshguard: MeshguardConfig = dataclasses.field(
        default_factory=MeshguardConfig)
    rescache: RescacheConfig = dataclasses.field(
        default_factory=RescacheConfig)
    fairness: FairnessConfig = dataclasses.field(
        default_factory=FairnessConfig)
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    storeguard: StoreGuardConfig = dataclasses.field(
        default_factory=StoreGuardConfig)
    planner: PlannerConfig = dataclasses.field(
        default_factory=PlannerConfig)
    predict: PredictConfig = dataclasses.field(
        default_factory=PredictConfig)
    integrity: IntegrityConfig = dataclasses.field(
        default_factory=IntegrityConfig)
    usage: UsageConfig = dataclasses.field(
        default_factory=UsageConfig)
    profile_dir: str = ""  # root dir for jax.profiler traces ("" disables)
    fault_injection: bool = False  # gate for /admin/faults: arming fault
    # sites over HTTP is a chaos-lab capability, refused unless the boot
    # config opts the deployment in explicitly (utils/faults.py)


class ConfigError(ValueError):
    pass


def _fill(cls, obj: Dict[str, Any], section: str):
    if not isinstance(obj, dict):
        raise ConfigError(f"[{section}] must be a table/object, "
                          f"got {type(obj).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise ConfigError(
            f"unknown key(s) {sorted(unknown)} in [{section}] "
            f"(valid: {sorted(fields)})")
    kwargs = {}
    for name, value in obj.items():
        f = fields[name]
        if f.type in ("int", "Optional[int]") and value is not None:
            value = int(value)
        elif f.type in ("float", "Optional[float]") and value is not None:
            value = float(value)
        elif f.type == "str":
            value = str(value)
        kwargs[name] = value
    return cls(**kwargs)


def parse_config(obj: Dict[str, Any]) -> Config:
    top = dict(obj)
    sections = {
        "service": (ServiceConfig, top.pop("service", {})),
        "store": (StoreConfig, top.pop("store", {})),
        "engine": (EngineConfig, top.pop("engine", {})),
        "distributed": (DistributedConfig, top.pop("distributed", {})),
        "prewarm": (PrewarmConfig, top.pop("prewarm", {})),
        "observability": (ObservabilityConfig,
                          top.pop("observability", {})),
        "fusion": (FusionConfig, top.pop("fusion", {})),
        "partition": (PartitionConfig, top.pop("partition", {})),
        "cluster": (ClusterConfig, top.pop("cluster", {})),
        "meshguard": (MeshguardConfig, top.pop("meshguard", {})),
        "rescache": (RescacheConfig, top.pop("rescache", {})),
        "fairness": (FairnessConfig, top.pop("fairness", {})),
        "autoscale": (AutoscaleConfig, top.pop("autoscale", {})),
        "storeguard": (StoreGuardConfig, top.pop("storeguard", {})),
        "planner": (PlannerConfig, top.pop("planner", {})),
        "predict": (PredictConfig, top.pop("predict", {})),
        "integrity": (IntegrityConfig, top.pop("integrity", {})),
        "usage": (UsageConfig, top.pop("usage", {})),
    }
    profile_dir = str(top.pop("profile_dir", ""))
    fault_injection = bool(top.pop("fault_injection", False))
    if top:
        raise ConfigError(
            f"unknown top-level key(s) {sorted(top)} "
            f"(valid: {sorted(sections) + ['fault_injection', 'profile_dir']})")
    parsed = {name: _fill(cls, section_obj, name)
              for name, (cls, section_obj) in sections.items()}
    cfg = Config(profile_dir=profile_dir, fault_injection=fault_injection,
                 **parsed)
    if cfg.store.backend not in ("inproc", "redis"):
        raise ConfigError(
            f"store.backend must be 'inproc' or 'redis', "
            f"got {cfg.store.backend!r}")
    if cfg.engine.mesh_devices < 0:
        raise ConfigError("engine.mesh_devices must be >= 0")
    if cfg.service.queue_depth < 0:
        raise ConfigError("service.queue_depth must be >= 0 (0 = unbounded)")
    if cfg.observability.trace_max_spans < 1:
        raise ConfigError("observability.trace_max_spans must be >= 1")
    if cfg.observability.trace_jobs < 1:
        raise ConfigError("observability.trace_jobs must be >= 1")
    if cfg.observability.spine_flush_spans < 1:
        raise ConfigError("observability.spine_flush_spans must be >= 1")
    if cfg.observability.spine_max_chunks < 0:
        raise ConfigError(
            "observability.spine_max_chunks must be >= 0 (0 = unbounded)")
    if cfg.observability.slo_window_s <= 0:
        raise ConfigError("observability.slo_window_s must be > 0")
    if cfg.engine.fused not in (None, "auto", "always", "never",
                                "queue", "dense"):
        raise ConfigError(
            f"engine.fused must be 'auto', 'always', 'never', 'queue' "
            f"or 'dense', got {cfg.engine.fused!r}")
    if cfg.fusion.window_ms < 0:
        raise ConfigError("fusion.window_ms must be >= 0")
    if cfg.fusion.max_jobs < 1:
        raise ConfigError("fusion.max_jobs must be >= 1")
    if cfg.fusion.max_width < 32:
        raise ConfigError("fusion.max_width must be >= 32 (one jnp lane)")
    if cfg.fusion.dispatch_workers < 1:
        raise ConfigError("fusion.dispatch_workers must be >= 1")
    if cfg.partition.parts < 0:
        raise ConfigError("partition.parts must be >= 0 (0 = auto)")
    if cfg.partition.classes < 1:
        raise ConfigError("partition.classes must be >= 1")
    if (cfg.partition.parts > 1
            and cfg.partition.classes < cfg.partition.parts):
        raise ConfigError(
            "partition.classes must be >= partition.parts (each "
            "partition needs at least one equivalence class to own)")
    if cfg.cluster.lease_ttl_s <= 0:
        raise ConfigError("cluster.lease_ttl_s must be > 0")
    if cfg.cluster.heartbeat_s < 0:
        raise ConfigError("cluster.heartbeat_s must be >= 0 (0 = ttl/3)")
    if (cfg.cluster.heartbeat_s
            and cfg.cluster.heartbeat_s >= cfg.cluster.lease_ttl_s):
        raise ConfigError(
            "cluster.heartbeat_s must be < cluster.lease_ttl_s (a lease "
            "renewed slower than it expires is permanently flapping)")
    if cfg.cluster.recover_every_s < 0:
        raise ConfigError("cluster.recover_every_s must be >= 0 (0 = ttl)")
    if cfg.cluster.max_adoptions < 1:
        raise ConfigError(
            "cluster.max_adoptions must be >= 1 (every orphan deserves "
            "at least one adoption before quarantine)")
    if cfg.meshguard.dead_after < 1:
        raise ConfigError("meshguard.dead_after must be >= 1")
    if cfg.meshguard.probe_every_s < 0:
        raise ConfigError(
            "meshguard.probe_every_s must be >= 0 (0 = passive only)")
    if cfg.meshguard.max_retries < 1:
        raise ConfigError("meshguard.max_retries must be >= 1")
    if cfg.rescache.max_bytes < 0:
        raise ConfigError("rescache.max_bytes must be >= 0 (0 = unbounded)")
    if cfg.fairness.tenant_depth < 0:
        raise ConfigError(
            "fairness.tenant_depth must be >= 0 (0 = no per-tenant cap)")
    if cfg.fairness.max_tenants < 1:
        raise ConfigError("fairness.max_tenants must be >= 1")
    if cfg.fairness.default_weight <= 0:
        raise ConfigError("fairness.default_weight must be > 0")
    if not isinstance(cfg.fairness.weights, dict):
        raise ConfigError("[fairness.weights] must be a table of "
                          "tenant -> weight")
    weights = {}
    for name, w in cfg.fairness.weights.items():
        try:
            w = float(w)
        except (TypeError, ValueError):
            raise ConfigError(
                f"fairness weight for tenant {name!r} must be a number, "
                f"got {w!r}")
        if w <= 0:
            raise ConfigError(
                f"fairness weight for tenant {name!r} must be > 0")
        weights[str(name)] = w
    cfg.fairness.weights = weights
    if cfg.autoscale.enabled and not cfg.cluster.enabled:
        raise ConfigError(
            "autoscale.enabled requires cluster.enabled (the autoscaler "
            "leader-elects and observes the fleet through the lease "
            "substrate)")
    if cfg.autoscale.min_replicas < 1:
        raise ConfigError("autoscale.min_replicas must be >= 1")
    if cfg.autoscale.max_replicas < cfg.autoscale.min_replicas:
        raise ConfigError(
            "autoscale.max_replicas must be >= autoscale.min_replicas")
    if cfg.autoscale.up_queue_per_worker <= 0:
        raise ConfigError("autoscale.up_queue_per_worker must be > 0")
    if cfg.autoscale.up_p99_s < 0:
        raise ConfigError("autoscale.up_p99_s must be >= 0 (0 = ignore)")
    if not 0 < cfg.autoscale.down_free_frac <= 1:
        raise ConfigError("autoscale.down_free_frac must be in (0, 1]")
    if cfg.autoscale.up_rate_derivative < 0:
        raise ConfigError(
            "autoscale.up_rate_derivative must be >= 0 (0 = off)")
    if not 0 < cfg.autoscale.rate_alpha <= 1:
        raise ConfigError("autoscale.rate_alpha must be in (0, 1]")
    if cfg.autoscale.hold_s < 0 or cfg.autoscale.cooldown_s < 0:
        raise ConfigError(
            "autoscale.hold_s / cooldown_s must be >= 0")
    if cfg.autoscale.decide_every_s < 0:
        raise ConfigError(
            "autoscale.decide_every_s must be >= 0 (0 = leader_ttl_s / 3)")
    if cfg.autoscale.leader_ttl_s <= 0:
        raise ConfigError("autoscale.leader_ttl_s must be > 0")
    if cfg.autoscale.drain_timeout_s <= 0:
        raise ConfigError("autoscale.drain_timeout_s must be > 0")
    if cfg.store.timeout_s <= 0:
        raise ConfigError("store.timeout_s must be > 0")
    if cfg.storeguard.probe_every_s < 0:
        raise ConfigError(
            "storeguard.probe_every_s must be >= 0 (0 = manual ticks)")
    if cfg.storeguard.down_after < 1:
        raise ConfigError("storeguard.down_after must be >= 1")
    if cfg.storeguard.spool_max_entries < 1:
        raise ConfigError("storeguard.spool_max_entries must be >= 1")
    if cfg.storeguard.stall_max_s < 0:
        raise ConfigError(
            "storeguard.stall_max_s must be >= 0 (0 = unbounded)")
    if cfg.planner.mode not in ("auto", "pinned"):
        raise ConfigError(
            f"planner.mode must be 'auto' or 'pinned', "
            f"got {cfg.planner.mode!r}")
    # ONE vocabulary: the planner's concrete-engine tuple (lazy import —
    # planner imports this module at top level, so the edge must stay
    # function-local here); a future engine added there is pinnable
    # with no second list to update
    from spark_fsm_tpu_torch.service.planner import CONCRETE_ENGINES

    if cfg.planner.pinned not in CONCRETE_ENGINES:
        raise ConfigError(
            f"planner.pinned must be a concrete engine "
            f"{list(CONCRETE_ENGINES)}, got {cfg.planner.pinned!r}")
    if not 0 <= cfg.planner.density_crossover <= 1:
        raise ConfigError("planner.density_crossover must be in [0, 1]")
    if cfg.planner.max_alphabet < 1:
        raise ConfigError("planner.max_alphabet must be >= 1")
    if cfg.planner.representation not in ("auto", "bitmap", "idlist"):
        raise ConfigError(
            f"planner.representation must be 'auto', 'bitmap' or "
            f"'idlist', got {cfg.planner.representation!r}")
    if cfg.planner.diffset_depth < 0:
        raise ConfigError(
            "planner.diffset_depth must be >= 0 (0 disables diffsets)")
    if cfg.predict.window_ms < 0:
        raise ConfigError("predict.window_ms must be >= 0 (0 = no fusion)")
    if cfg.predict.max_wave < 1:
        raise ConfigError("predict.max_wave must be >= 1")
    if cfg.predict.topm < 1:
        raise ConfigError("predict.topm must be >= 1")
    if cfg.predict.lanes_floor < 0 or cfg.predict.depth_floor < 0:
        raise ConfigError(
            "predict.lanes_floor / depth_floor must be >= 0 "
            "(0 = size each artifact exactly; no shared prewarm envelope)")
    if cfg.predict.artifact_entries < 1:
        raise ConfigError("predict.artifact_entries must be >= 1")
    if cfg.predict.artifact_bytes < 1:
        raise ConfigError("predict.artifact_bytes must be >= 1")
    if cfg.integrity.scrub_every_s < 0:
        raise ConfigError(
            "integrity.scrub_every_s must be >= 0 (0 = manual passes)")
    if cfg.integrity.scrub_batch < 1:
        raise ConfigError("integrity.scrub_batch must be >= 1")
    if cfg.usage.window_s <= 0:
        raise ConfigError("usage.window_s must be > 0")
    if cfg.usage.flush_every_s < 0:
        raise ConfigError(
            "usage.flush_every_s must be >= 0 (0 = flush every tick)")
    if cfg.usage.top_jobs < 1:
        raise ConfigError("usage.top_jobs must be >= 1")
    refuse_unported(cfg)
    return cfg


def refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a knob whose plane the port does
    not serve yet (ROADMAP Queue A item A13b, steps 5–7): a device mesh or
    a multi-process boot (the port's mesh is one process per rank, so a
    service mesh needs a launcher) and the degraded-topology guard."""
    refused = []
    if cfg.engine.mesh_devices > 0:
        refused.append("[engine] mesh_devices > 0")
    for name in ("distributed", "meshguard"):
        if getattr(cfg, name).enabled:
            refused.append(f"[{name}] enabled = true")
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)}: not served by spark_fsm_tpu_torch "
            "yet (ROADMAP A13b steps 5–7)")


def load_config(path: str) -> Config:
    """Load a TOML (``.toml``) or JSON boot config file."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".toml"):
        try:
            import tomllib  # py >= 3.11
        except ImportError:  # py 3.10: the API-identical backport
            import tomli as tomllib

        obj = tomllib.loads(raw.decode("utf-8"))
    else:
        obj = json.loads(raw.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ConfigError("config root must be a table/object")
    return parse_config(obj)


# --------------------------------------------------------------------------
# Process-wide active config (set once at boot by app.main; tests may swap)
# --------------------------------------------------------------------------

_lock = threading.Lock()
_active = Config()


def get_config() -> Config:
    return _active


def set_config(cfg: Config) -> None:
    global _active
    refuse_unported(cfg)
    with _lock:
        _active = cfg
    # the watchdog policy is process-global (engines read it at dispatch
    # time, no constructor plumbing) — the active config owns it
    from spark_fsm_tpu_torch.utils import watchdog

    watchdog.configure(
        slack=cfg.engine.watchdog_slack,
        floor_s=(2.0 if cfg.engine.watchdog_floor_s is None
                 else cfg.engine.watchdog_floor_s))
    # the flight recorder is process-global too (engines open spans
    # with no constructor plumbing) — same ownership as the watchdog
    from spark_fsm_tpu_torch.utils import obs

    obs.configure_tracing(cfg.observability.trace,
                          max_spans=cfg.observability.trace_max_spans,
                          max_jobs=cfg.observability.trace_jobs)
    # the fusion broker is process-global like the two above (engines
    # probe it at dispatch time with no constructor plumbing)
    from spark_fsm_tpu_torch.service import fusion

    fusion.configure(cfg.fusion)
    # cluster observability plane knobs (spine flush/retention, SLO
    # window) — same process-global ownership as the three above
    from spark_fsm_tpu_torch.service import obsplane

    obsplane.configure(cfg.observability)
    # the prediction plane's broker window + artifact cache budgets are
    # process-global like fusion's (the Master routes into module state)
    from spark_fsm_tpu_torch.service import predictor

    predictor.configure(cfg.predict)
    # the integrity plane's scrubber cadence/batch are process-global
    # like the planes above (read sites count into module counters; the
    # Miner installs the scrubber over its store)
    from spark_fsm_tpu_torch.service import integrity

    integrity.configure(cfg.integrity)
    # the usage metering plane's meter knobs are process-global like
    # the integrity scrubber's (dispatch surfaces deposit into module
    # state; the Miner installs the meter over its store)
    from spark_fsm_tpu_torch.service import usage

    usage.configure(cfg.usage)


def engine_kwargs(*names: str) -> Dict[str, Any]:
    """Configured engine knobs (subset ``names``, skipping unset ones)."""
    eng = _active.engine
    out = {}
    for name in names:
        value = getattr(eng, name)
        if value is not None:
            out[name] = value
    return out


def get_mesh():
    """The boot-configured device mesh: always None (one device), since
    :func:`set_config` refuses ``[engine] mesh_devices > 0``."""
    return None
