"""Result-reuse tier above admission — content-addressed
dataset fingerprints, in-flight request coalescing, and dominance-based
cache serving.

At millions of users most mine requests are redundant: same dataset,
identical or strictly weaker parameters.  This module sits between HTTP
admission and the Miner mailbox (service/actors.Miner.submit) and keeps
redundant work off the device entirely, in three cooperating layers:

- **Content-addressed fingerprints**: every resolved dataset gets a
  canonical streaming hash (data/spmf.fingerprint_db), computed once at
  dataset load and stamped on the job's JobControl — so two requests
  naming the same data resolve to one cache key regardless of how they
  spelled the source.  INLINE payloads hash at admission (the request
  carries the content); SYNTH specs are deterministic generators whose
  spec→fingerprint mapping is learned at first load
  (``fsm:rescache-src:{srckey}``); FILE paths resolve through the SAME
  learned mapping gated on an immutability validator (mtime + size +
  content sample, data/spmf.file_validator — ROADMAP 2b):
  an untouched artifact fp-resolves at admission and unlocks dominance
  serving for the FILE spelling, any mismatch falls back to the
  mutable path; truly mutable sources (TRACKED/JDBC/ELASTIC/PIWIK)
  never resolve a fingerprint at admission — their content can change
  under the same spelling, so they only coalesce (identical in-flight
  spec) and populate entries for OTHER spellings (an INLINE request
  for the same bytes still hits).  In CLUSTER mode each replica's
  heartbeat piggybacks its in-flight leaders' fingerprints; a local
  miss whose fp is in flight on a peer sheds with a ~2-heartbeat
  Retry-After instead of admitting a duplicate cold mine (ROADMAP 2c
  — a hint: replica-local coalescing semantics are unchanged).

- **In-flight coalescing**: an identical request (same dataset
  identity, algorithm, and effective result-affecting parameters —
  plugins.effective_params) arriving while a matching job is queued or
  running attaches as a *follower* instead of admitting.  One
  execution; fan-out delivery at the leader's sink.  Each follower
  still gets its own journal intent, lease, job-control entry, trace
  lifecycle, and result-store records, so crash recovery
  (service/actors.recover_orphans) and /admin/trace behave exactly as
  for a solo job — a kill -9 of the process leaves follower journal
  entries that the boot recovery pass settles, never a stuck uid.  In
  cluster mode followers attach only to leaders whose lease THIS
  replica holds; otherwise they admit normally (correct, just colder).
  A leader that reaches any terminal state other than success (cancel,
  deadline, failure, drain, steal, fence) has its followers
  re-dispatched through the normal admission path as independent cold
  mines — a leader's abort is its client's decision, not the
  followers'.

- **Dominance serving**: a completed cached entry
  (``fsm:rescache:{fingerprint}:{algo}``) serves any *dominated*
  request by filtering the cached result set on the host — zero device
  work.  The per-algorithm predicates are deliberately conservative and
  proven in docs/DESIGN.md ("Dominance predicates"):

    SPADE/SPADE_TPU (patterns): same fingerprint + EXACTLY equal
      maxgap/maxwindow + higher-or-equal absolute minsup.  Supports are
      invariant under a pure minsup raise, so filtering by
      ``sup >= minsup'`` is byte-exact.  Stricter constraints are NOT
      served (supports change under a tighter gap/window — recounting
      would need the data).
    TSR/TSR_TPU (rules, tie-inclusive top-k): smaller-or-equal k,
      same-or-higher minconf, same-or-stricter max_side — accepted only
      when the re-derived tie-inclusive threshold over the filtered
      cached set is >= the cached run's own threshold s_k0 (or the
      cached run was exhaustive, i.e. found < k rules).  Rules the
      cached run pruned all have sup < s_k0, so none can enter the
      filtered top-k; when the check fails the request MISSES and mines
      cold.

Cache entries live in the existing ResultStore with LRU byte-budget
eviction over a cursor SCAN; in cluster mode the entry write is fenced
through the earlier lease path (the writer proves it still owns the
producing job).  EVERY lookup/serve/coalesce path degrades to a plain
cold mine on any error — the tier can lose reuse, never correctness.
Disabled (``[rescache] enabled = false``, the default) the Miner holds
no cache instance and submit pays one attribute read; bench_smoke's
dispatch-shape counters stay byte-identical.

Fault sites: ``rescache.lookup`` / ``rescache.store`` (utils/faults
KNOWN_SITES), swept by tests/test_chaos.py.

Port: a copy of ``spark_fsm_tpu/service/resultcache.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.service import integrity, model, obsplane, usage
from spark_fsm_tpu_torch.service.model import ServiceRequest, Status
from spark_fsm_tpu_torch.utils import envelope, faults, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event

# ---------------------------------------------------------------- metrics
# The fsm_rescache_* vocabulary: unlabelled counters auto-seed at 0; the
# one labelled family seeds its op vocabulary so a fresh scrape shows
# every error class at 0 instead of no-data (the earlier hygiene
# pattern; scripts/obs_smoke.py pins all of these as non-orphans).

_HITS = obs.REGISTRY.counter(
    "fsm_rescache_hits_total",
    "requests served verbatim from a completed cache entry (exact "
    "effective-parameter match; zero device work)")
_DOMINATED = obs.REGISTRY.counter(
    "fsm_rescache_dominated_serves_total",
    "dominated requests served by host-side filtering of a cached "
    "result set (strictly weaker parameters; zero device work)")
_MISSES = obs.REGISTRY.counter(
    "fsm_rescache_misses_total",
    "reuse lookups that found nothing servable — the request mined cold")
_COALESCED = obs.REGISTRY.counter(
    "fsm_rescache_coalesced_total",
    "requests attached as followers of an identical in-flight job "
    "(one execution, fan-out delivery)")
_EVICTIONS = obs.REGISTRY.counter(
    "fsm_rescache_evictions_total",
    "cache entries evicted by the LRU byte budget")
_BYTES_TOTAL = obs.REGISTRY.counter(
    "fsm_rescache_bytes_total",
    "lifetime bytes written into cache entries")
_BYTES = obs.REGISTRY.gauge(
    "fsm_rescache_bytes",
    "resident cache-entry bytes (recomputed at each store/evict pass)")
_BYTES.set(0)  # gauges don't auto-seed; a fresh scrape must show 0
_ERRORS = (obs.REGISTRY.counter(
    "fsm_rescache_errors_total",
    "result-reuse operations that failed and degraded to a cold mine, "
    "by op — the tier loses reuse on error, never correctness")
    .seed(op="lookup").seed(op="store").seed(op="serve")
    .seed(op="coalesce").seed(op="fanout"))


# request params that do NOT affect mined results: excluded from the
# source identity (everything else in req.data names the data source)
_NON_SOURCE_PARAMS = frozenset({
    "uid", "algorithm", "support", "k", "minconf", "max_side",
    "maxgap", "maxwindow", "priority", "deadline_s", "retries",
    "checkpoint", "checkpoint_every_s", "profile", "use_pallas",
    "resident", "incremental",
})

# sources whose content can change under the same request spelling —
# never fingerprint-resolvable at admission (see module docstring).
# FILE left this set in earlier work (ROADMAP 2b): an mtime+size+content-
# sample validator (data/spmf.file_validator) now witnesses that a
# path still names the bytes it named at the last load, so IMMUTABLE
# file artifacts fp-resolve at admission and unlock dominance serving;
# any validator mismatch falls back to this mutable (coalesce-only)
# path.
_MUTABLE_SOURCES = frozenset(
    {"TRACKED", "JDBC", "ELASTIC", "PIWIK"})

_PEER_HINTS = obs.REGISTRY.counter(
    "fsm_rescache_peer_hints_total",
    "submits shed with a peer-aware Retry-After because an identical "
    "dataset fingerprint was in flight on a peer replica (ROADMAP 2c: "
    "the cross-replica coalesce hint — the retry hits the cache entry "
    "the peer publishes)")


def entry_key(fp: str, algo: str) -> str:
    return f"fsm:rescache:{fp}:{algo}"


def _lru_key(fp: str, algo: str) -> str:
    return f"fsm:rescache-lru:{fp}:{algo}"


def _src_key(srckey: str) -> str:
    return f"fsm:rescache-src:{srckey}"


def sidecar_key_for(ekey: str) -> str:
    """``fsm:rescache:{fp}:{algo}`` -> its LRU sidecar key."""
    return "fsm:rescache-lru:" + ekey[len("fsm:rescache:"):]


def entry_key_for_sidecar(skey: str) -> str:
    return "fsm:rescache:" + skey[len("fsm:rescache-lru:"):]


def parse_entry(payload: Optional[str],
                check_digest: bool = True) -> Optional[dict]:
    """Decode one cache-entry payload; with ``check_digest`` also
    cross-check the stored ``rules_digest`` against a recompute over the
    payload string — the earlier artifact cache keys compiled tries on
    that digest, so an artifact must never be built from bytes the
    digest does not vouch for.  None = undecodable or digest mismatch
    (the caller treats it as corrupt).  Entries predating the digest
    field pass undigested."""
    if payload is None:
        return None
    try:
        ent = json.loads(payload)
    except ValueError:
        return None
    if not isinstance(ent, dict) or not isinstance(ent.get("payload"), str):
        return None
    if check_digest and ent.get("digest"):
        from spark_fsm_tpu_torch.ops.rule_trie import rules_digest

        if rules_digest(ent["payload"]) != ent["digest"]:
            return None
    return ent


def open_entry(store, fp: str, algo: str, check_digest: bool = False):
    """Verified read of one cache entry: envelope unwrap + decode
    (+ digest cross-check when asked — the artifact-build path).
    Returns ``(ent, payload_size)``, or None — and on CORRUPT bytes
    first quarantines the entry and drops its sidecar, so the caller's
    fall-through to a cold mine also heals the keyspace: corrupt bytes
    are never served, and never crash admission."""
    key = entry_key(fp, algo)
    raw = store.get(key)
    if raw is None:
        return None
    payload, verdict = envelope.unwrap(raw)
    ent = None
    if verdict != "corrupt":
        ent = parse_entry(payload, check_digest=check_digest)
        if ent is None:
            verdict = "corrupt"
    integrity.note_read("rescache", verdict)
    if ent is not None:
        return ent, len(payload)
    integrity.quarantine(store, key, raw, "rescache", move=True)
    store.delete(sidecar_key_for(key))
    log_event("rescache_entry_quarantined", key=key)
    return None


def write_sidecar(store, ekey: str, ent: dict, size: int,
                  ts: Optional[float] = None) -> None:
    """(Re)write an entry's LRU sidecar — shared by the store path, the
    serve-time LRU touch, and the scrubber's sidecar repair (which
    passes no ``ts`` so the re-derived sidecar keeps the ENTRY's age
    instead of artificially refreshing its eviction rank)."""
    if ts is None:
        try:
            ts = float(ent.get("ts") or time.time())
        except (TypeError, ValueError):
            ts = time.time()
    store.set(sidecar_key_for(ekey), envelope.wrap(json.dumps(
        {"ts": ts, "bytes": size, "digest": ent.get("digest")})))


def _conf_frac(minconf: float) -> Tuple[int, int]:
    """minconf as an exact (num, den) — the SAME spelling models/tsr
    uses (Fraction over str), so serve-side confidence tests agree with
    the engines bit-for-bit."""
    from fractions import Fraction

    f = Fraction(str(minconf))
    return f.numerator, f.denominator


class _Identity:
    """A request's reuse identity: source key (hash of the source
    spelling), optional content fingerprint, the normalized
    result-affecting params (plugins.effective_params), and — for FILE
    spellings — the immutability validator that gates the learned
    path→fingerprint mapping."""

    __slots__ = ("source", "srckey", "stable", "fp", "params",
                 "validator")

    def __init__(self, source: str, srckey: str, stable: bool,
                 fp: Optional[str], params: dict,
                 validator: Optional[dict] = None):
        self.source = source
        self.srckey = srckey
        self.stable = stable
        self.fp = fp
        self.params = params
        self.validator = validator


class _Follower:
    __slots__ = ("uid", "req", "ctl", "priority", "t0")

    def __init__(self, uid: str, req: ServiceRequest,
                 ctl: jobctl.JobControl, priority: str):
        self.uid = uid
        self.req = req
        self.ctl = ctl
        self.priority = priority
        self.t0 = time.monotonic()


def build_for(miner) -> Optional["ResultCache"]:
    """The Miner's constructor hook: a cache instance when the boot
    config enables the tier, else None (one attribute read per submit
    thereafter — the disabled-cost pin)."""
    if not config.get_config().rescache.enabled:
        return None
    return ResultCache(miner)


class ResultCache:
    """One per Miner: the coalescing registry is process-local (a
    follower's fan-out must come from the worker that runs its leader),
    the completed-entry cache lives in the shared ResultStore."""

    def __init__(self, miner) -> None:
        self.miner = miner
        self.store = miner.store
        self.mgr = miner._lease
        rcfg = config.get_config().rescache
        self.max_bytes = int(rcfg.max_bytes)
        self.coalesce_enabled = bool(rcfg.coalesce)
        self.dominance_enabled = bool(rcfg.dominance)
        self._lock = threading.Lock()
        # serializes follower ATTACH I/O (journal/lease/status writes)
        # among attachers only — the registry lock above must stay
        # store-I/O-free because leader_admitted (inside the Miner's
        # enqueue section) and every fan-out pop take it
        self._attach_lock = threading.Lock()
        # coalescing registry: ckey -> leader uid; leader uid -> state
        self._leaders: Dict[str, str] = {}
        self._by_leader: Dict[str, dict] = {}
        # uids intercepted as prospective leaders, awaiting the admit
        # outcome (promoted just before enqueue, dropped on any abort)
        self._pending: Dict[str, str] = {}
        # prospective leaders' resolved dataset fingerprints — becomes
        # the heartbeat's in-flight hint (ROADMAP 2c) once promoted
        self._pending_fp: Dict[str, str] = {}
        # FILE requests' ADMISSION-time validators, keyed by uid: the
        # learned path→fp mapping is stored only when the load-time
        # validator equals this one, proving the file did not change
        # between admission and the load whose parse produced the
        # fingerprint (without the check, a rewrite racing a slow load
        # would bind the OLD content's fp to the NEW file's validator
        # and serve stale results).  Size-capped: a dropped entry only
        # loses one job's reuse, never correctness.
        self._admit_validator: Dict[str, dict] = {}

    # ------------------------------------------------------------ identity

    def _identity(self, req: ServiceRequest) -> _Identity:
        """Resolve the request's reuse identity.  Raises ValueError on
        malformed params — the caller degrades to the cold path, where
        the same ValueError surfaces through normal admission."""
        from spark_fsm_tpu_torch.service import plugins

        params = plugins.effective_params(req)
        source = (req.param("source") or "FILE").upper()
        fp = None
        if source == "INLINE":
            # the request IS the content: hash it at admission (cost is
            # one parse of the payload the worker would parse anyway)
            from spark_fsm_tpu_torch.data.spmf import fingerprint_db, parse_spmf

            text = req.param("sequences")
            if text is None:
                raise ValueError("INLINE source needs 'sequences'")
            fp = fingerprint_db(parse_spmf(text))
            spec: Dict[str, str] = {"source": source}
        elif source == "SYNTH":
            spec = {"source": source,
                    "dataset": req.param("dataset", "bms_webview1"),
                    "scale": repr(float(req.param("scale", "0.01")))}
        elif source == "FILE":
            # FILE artifacts (ROADMAP 2b): the path names the content
            # only while the immutability validator holds — computed
            # here (one stat + a bounded head/tail sample read, far
            # cheaper than the parse the worker pays anyway) and
            # compared against the learned mapping in _resolve_fp.
            # None (unreadable path) degrades to the mutable path; the
            # cold mine surfaces the real error.
            from spark_fsm_tpu_torch.data.spmf import file_validator

            path = req.param("path") or ""
            spec = {"source": source, "path": path}
            validator = file_validator(path) if path else None
            srckey = hashlib.sha256(
                json.dumps(spec, sort_keys=True).encode()).hexdigest()
            return _Identity(source, srckey, False, None, params,
                             validator=validator)
        else:
            # every non-control param is source-naming (path, db, url,
            # query, topic, ... and for custom sources even an inline
            # payload): the spec hash must cover all of them, or two
            # requests for DIFFERENT data could coalesce
            spec = {"source": source}
            for k in sorted(req.data):
                if k not in _NON_SOURCE_PARAMS:
                    spec[k] = str(req.data[k])
        srckey = hashlib.sha256(
            json.dumps(spec, sort_keys=True).encode()).hexdigest()
        stable = source in ("INLINE", "SYNTH")
        return _Identity(source, srckey, stable, fp, params)

    def _resolve_fp(self, ident: _Identity) -> Optional[str]:
        """Admission-time fingerprint: direct for INLINE, learned map
        for SYNTH, validator-gated learned map for FILE (the mapping
        is trusted only while the immutability witness still matches
        the one recorded at load — a touched/rewritten file misses and
        mines cold), None for mutable sources (their spelling does not
        pin their content)."""
        if ident.fp is not None:
            return ident.fp
        if not ident.stable and ident.validator is None:
            return None
        raw = self.store.peek(_src_key(ident.srckey))
        if not raw:
            return None
        try:
            ent = json.loads(raw)
        except ValueError:
            return None
        if not isinstance(ent, dict):
            return None
        if ident.stable:
            return ent.get("fp") or None
        # FILE: the learned fingerprint holds only under an EXACT
        # validator match (mtime_ns + size + content sample)
        if ent.get("validator") == ident.validator:
            return ent.get("fp") or None
        return None

    def _ckey(self, fp: Optional[str], ident: _Identity) -> str:
        """Coalescing identity: dataset (fingerprint when resolvable,
        source key otherwise) + algorithm + result-affecting params.
        minsup_abs is derived, not part of the spelling — identical
        requests share the raw support value."""
        p = dict(ident.params)
        p.pop("minsup_abs", None)
        return json.dumps([fp or ("src:" + ident.srckey), p],
                          sort_keys=True)

    # ----------------------------------------------------------- admission

    def intercept(self, req: ServiceRequest, priority: str,
                  deadline_s: Optional[float]) -> Optional[str]:
        """The admission hook: "served" (request answered from a
        completed entry), "coalesced" (attached as a follower), or None
        (proceed with normal cold admission — possibly registered as a
        prospective leader).  NEVER raises: any error counts and falls
        through to the cold path."""
        try:
            faults.fault_site("rescache.lookup", uid=req.uid)
            ident = self._identity(req)
        except Exception:
            # malformed params / injected lookup fault: the cold path
            # owns the error surface (a bad request still fails there)
            _ERRORS.inc(op="lookup")
            return None
        try:
            fp = self._resolve_fp(ident)
            if fp is not None and self.dominance_enabled:
                out = self._try_serve(req, fp, ident, priority)
                if out is not None:
                    return out
            if self.coalesce_enabled:
                ckey = self._ckey(fp, ident)
                if self._try_follow(req, ckey, priority, deadline_s):
                    return "coalesced"
                if (fp is not None and self.mgr is not None
                        and self.mgr.peer_inflight_fp(fp)):
                    # cross-replica coalesce HINT (ROADMAP 2c): the
                    # fingerprint is in flight on a peer — tell the
                    # submit layer to shed with a ~2-heartbeat
                    # Retry-After instead of admitting a duplicate
                    # cold mine.  Hint only: nothing here attaches
                    # across replicas, and the retry either hits the
                    # entry the peer published or mines cold.
                    _PEER_HINTS.inc()
                    log_event("rescache_peer_hint", uid=req.uid,
                              fp=fp[:16])
                    return "peer-inflight"
                with self._lock:
                    self._pending[req.uid] = ckey
                    if fp is not None:
                        self._pending_fp[req.uid] = fp
            if ident.validator is not None:
                with self._lock:
                    self._admit_validator[req.uid] = ident.validator
                    while len(self._admit_validator) > 1024:
                        self._admit_validator.pop(
                            next(iter(self._admit_validator)))
            _MISSES.inc()
            return None
        except Exception as exc:
            _ERRORS.inc(op="lookup")
            log_event("rescache_error", op="lookup", uid=req.uid,
                      error=str(exc))
            with self._lock:
                self._pending.pop(req.uid, None)
                self._pending_fp.pop(req.uid, None)
            return None

    def leader_admitted(self, uid: str) -> None:
        """Promote a pending interception to a live leader — called
        under the Miner's enqueue decision, strictly BEFORE the request
        reaches the queue, so a follower can never attach to a uid that
        already settled."""
        with self._lock:
            ckey = self._pending.pop(uid, None)
            fp = self._pending_fp.pop(uid, None)
            if ckey is None or ckey in self._leaders:
                return  # two same-key admits raced: first one leads
            self._leaders[ckey] = uid
            self._by_leader[uid] = {"ckey": ckey, "followers": [],
                                    "fp": fp}

    def admit_aborted(self, uid: str) -> None:
        """Drop a prospective leader whose admission never enqueued
        (shed, conflict, journal failure, shutdown)."""
        with self._lock:
            self._pending.pop(uid, None)
            self._pending_fp.pop(uid, None)
            self._admit_validator.pop(uid, None)

    def inflight_fps(self) -> List[str]:
        """Dataset fingerprints of live coalescing leaders — the
        heartbeat snapshot's cross-replica hint payload (bounded by
        the caller; a leader whose fp is still unknown contributes
        nothing)."""
        with self._lock:
            return sorted({s["fp"] for s in self._by_leader.values()
                           if s.get("fp")})

    # ---------------------------------------------------------- coalescing

    def _try_follow(self, req: ServiceRequest, ckey: str, priority: str,
                    deadline_s: Optional[float]) -> bool:
        with self._lock:
            leader = self._leaders.get(ckey)
            if leader is None:
                return False
            # the leader must still be live here: a registered control
            # entry proves it is queued or running on THIS miner; in
            # cluster mode the lease must be ours too (a stolen/
            # adopted leader fans out elsewhere)
            if jobctl.get(leader) is None:
                return False
            if self.mgr is not None \
                    and self.mgr.token_of(leader) is None:
                return False
        fresh_lease = journaled = False
        ctl = None
        attached = False
        try:
            with self._attach_lock:
                # liveness check + journal intent are atomic AMONG
                # ATTACHERS: two racing submits of the same uid
                # serialize here and the loser sees the fresh intent
                # (falling through to the cold path's 409); the
                # registry lock stays out of this store I/O
                entry = self.store.journal_get(req.uid)
                if entry is not None:
                    try:
                        if (json.loads(entry).get("incarnation")
                                == self.miner.incarnation):
                            return False
                    except ValueError:
                        pass
                if self.mgr is not None:
                    # own lease per follower: fan-out writes ride the
                    # fenced path exactly like a solo job's sink
                    fresh_lease = self.mgr.token_of(req.uid) is None
                    self.mgr.acquire(req.uid)  # LeaseHeld -> except
                self.store.clear_job(req.uid)
                self.store.journal_set(req.uid, json.dumps({
                    "uid": req.uid,
                    "incarnation": self.miner.incarnation,
                    "replica": (self.mgr.replica_id
                                if self.mgr is not None else None),
                    "ts": round(time.time(), 3),
                    "checkpoint": False,
                    "priority": priority,
                    "coalesced_into": leader,
                    "request": dict(req.data),
                }))
                journaled = True
                self.store.add_status(req.uid, Status.STARTED)
                self.store.incr("fsm:metric:jobs_submitted")
                ctl = jobctl.register(req.uid, deadline_s,
                                      priority=priority)
                ctl.follower_of = leader
                if self.mgr is not None:
                    self.mgr.attach(req.uid, ctl)
            with self._lock:
                # the leader may have settled (or lost its ckey to a
                # successor) during the attach I/O: only a leader still
                # registered can be trusted to fan out — otherwise roll
                # back and mine cold
                if self._leaders.get(ckey) == leader \
                        and jobctl.get(leader) is not None:
                    self._by_leader[leader]["followers"].append(
                        _Follower(req.uid, req, ctl, priority))
                    attached = True
        except Exception as exc:
            _ERRORS.inc(op="coalesce")
            log_event("rescache_error", op="coalesce", uid=req.uid,
                      error=str(exc))
        if not attached:
            # unwind the partial attach: a surviving live-looking
            # journal entry would 409 every future resubmit of the uid
            try:
                if journaled:
                    self.store.journal_clear(req.uid)
            except Exception:
                pass
            if ctl is not None:
                jobctl.release_entry(ctl)
            if self.mgr is not None and fresh_lease:
                try:
                    self.mgr.release(req.uid)
                except Exception:
                    pass
            return False
        _COALESCED.inc()
        log_event("job_coalesced", uid=req.uid, leader=leader,
                  priority=priority)
        obs.trace_begin(req.uid,
                        algorithm=req.param("algorithm", "SPADE_TPU"),
                        source=req.param("source", "FILE"))
        obs.lifecycle(req.uid, "admitted", priority=priority,
                      coalesced_into=leader,
                      replica=(self.mgr.replica_id
                               if self.mgr is not None else None))
        obs.flush_trace(req.uid)
        return True

    def _pop_followers(self, uid: str) -> List[_Follower]:
        with self._lock:
            state = self._by_leader.pop(uid, None)
            if state is None:
                return []
            if self._leaders.get(state["ckey"]) == uid:
                del self._leaders[state["ckey"]]
            return state["followers"]

    # ------------------------------------------------------ dataset stamps

    def note_dataset(self, req: ServiceRequest, db,
                     ctl: Optional[jobctl.JobControl]) -> Optional[str]:
        """Worker-side fingerprint stamp, once per dataset load: compute
        the content hash, carry it on the JobControl, and learn the
        stable-source spec → fingerprint mapping.  Never raises — a
        failure here only loses reuse."""
        try:
            faults.fault_site("rescache.store", uid=req.uid)
            from spark_fsm_tpu_torch.data.spmf import fingerprint_db

            fp = fingerprint_db(db)
            if ctl is not None:
                ctl.dataset_fp = fp
            ident = self._identity(req)
            learnable = ident.stable
            if ident.validator is not None:
                # FILE: the mapping may only bind this validator to
                # this fingerprint if the file provably did NOT change
                # between admission and now — the admission-time
                # validator must equal the one just recomputed.  A
                # rewrite racing the (possibly seconds-long) load
                # would otherwise pair the OLD content's fp with the
                # NEW file's validator and serve stale results; on any
                # mismatch (or an unknown admission validator) we skip
                # learning and the next untouched-run stores it.
                with self._lock:
                    v_admit = self._admit_validator.pop(req.uid, None)
                learnable = v_admit == ident.validator
            if ident.fp is None and learnable:
                # SYNTH: the deterministic generator spec now provably
                # names this content — admission can resolve it next
                # time.  FILE: witnessed-unchanged across the load.
                self.store.set(_src_key(ident.srckey), json.dumps(
                    {"fp": fp, "source": ident.source,
                     "validator": ident.validator}))
            # in-flight hint upkeep (ROADMAP 2c): a leader whose fp was
            # unknown at admission (first FILE mine of a path) becomes
            # visible to peers once the dataset is loaded
            with self._lock:
                state = self._by_leader.get(req.uid)
                if state is not None:
                    state["fp"] = fp
            return fp
        except Exception as exc:
            _ERRORS.inc(op="store")
            log_event("rescache_error", op="store", uid=req.uid,
                      error=str(exc))
            return None

    # ----------------------------------------------------- serving (reuse)

    def _try_serve(self, req: ServiceRequest, fp: str, ident: _Identity,
                   priority: str) -> Optional[str]:
        algo = ident.params["algo"]
        opened = open_entry(self.store, fp, algo)
        if opened is None:
            # missing — or corrupt: already quarantined, and the
            # request falls through to a cold mine (never served)
            return None
        ent, size = opened
        served = _servable(ent, ident.params)
        if served is None:
            return None
        payload, mode, n_results = served
        if not self._deliver(req, ent, payload, mode, n_results,
                             priority):
            return None
        (_HITS if mode == "exact" else _DOMINATED).inc()
        # LRU touch: serving refreshes the entry's eviction rank (the
        # sidecar also carries the entry's byte size so the eviction
        # sweep never has to read payloads)
        try:
            write_sidecar(self.store, entry_key(fp, algo), ent, size,
                          ts=time.time())
        except Exception:
            pass
        return "served"

    def _deliver(self, req: ServiceRequest, ent: dict, payload: str,
                 mode: str, n_results: int, priority: str) -> bool:
        """Synchronously settle ``req`` from the cache: the same
        durable shape as a solo job (journal intent → results →
        terminal status → journal clear), under the uid's own lease in
        cluster mode.  False = could not serve (live uid, lease held,
        store error) — the cold path takes over."""
        uid = req.uid
        t0 = time.monotonic()
        entry = self.store.journal_get(uid)
        if entry is not None:
            try:
                if (json.loads(entry).get("incarnation")
                        == self.miner.incarnation):
                    return False  # live uid: normal path 409s
            except ValueError:
                pass
        fresh_lease = False
        if self.mgr is not None:
            try:
                fresh_lease = self.mgr.token_of(uid) is None
                self.mgr.acquire(uid)
            except Exception:
                return False  # LeaseHeld/Unavailable: cold path decides
        journaled = False
        try:
            self.store.journal_set(uid, json.dumps({
                "uid": uid, "incarnation": self.miner.incarnation,
                "replica": (self.mgr.replica_id
                            if self.mgr is not None else None),
                "ts": round(time.time(), 3), "checkpoint": False,
                "priority": priority, "served_from_cache": mode,
                "request": dict(req.data)}))
            journaled = True
            self.store.clear_job(uid)
            self.store.add_status(uid, Status.STARTED)
            self.store.incr("fsm:metric:jobs_submitted")
            obs.trace_begin(uid,
                            algorithm=req.param("algorithm", "SPADE_TPU"),
                            source=req.param("source", "FILE"))
            obs.lifecycle(uid, "admitted", priority=priority,
                          served_from_cache=mode)
            stats = {"algorithm": ent["algo"],
                     "sequences": ent["n_sequences"],
                     "results": n_results,
                     "served_from_cache": mode,
                     "cache_uid": ent.get("uid"),
                     "dataset_s": 0.0, "mine_s": 0.0}
            self.store.set(f"fsm:stats:{uid}", json.dumps(stats))
            if ent["kind"] == "patterns":
                self.store.add_patterns(uid, payload)
            else:
                self.store.add_rules(uid, payload)
            self.store.add_status(uid, Status.TRAINED)
            self.store.add_status(uid, Status.FINISHED)
            self.store.journal_clear(uid)
            self.store.incr("fsm:metric:jobs_finished")
            e2e = time.monotonic() - t0
            obsplane.observe_job(priority, e2e, 0.0, e2e,
                                 tenant=(req.param("tenant")
                                         or obsplane.DEFAULT_TENANT))
            # avoided-cost credit (service/usage.py): this serve spent
            # ~zero device seconds where a cold mine would have spent
            # what the cached entry's recorded usage says it cost
            u = ent.get("usage") or {}
            usage.credit_avoided(
                req.param("tenant"),
                u.get("device_seconds_measured")
                or u.get("device_seconds_est") or 0.0, mode)
            obs.lifecycle(uid, "settled", outcome="finished",
                          served_from_cache=mode)
            obs.flush_trace(uid)
            if self.mgr is not None:
                self.mgr.release(uid)
            log_event("job_served_from_cache", uid=uid, mode=mode,
                      results=n_results, cache_uid=ent.get("uid"))
            return True
        except Exception as exc:
            _ERRORS.inc(op="serve")
            log_event("rescache_error", op="serve", uid=uid,
                      error=str(exc))
            # unwind so the cold path starts clean; best-effort — the
            # cold admission's clear_job re-wipes whatever remains.
            # Clear ONLY an intent WE wrote: when journal_set itself
            # failed, any surviving record is a predecessor's (e.g. a
            # dead replica's checkpointed orphan) and destroying it
            # would destroy its recoverability (same rule as _admit's
            # unwind in service/actors.py)
            try:
                if journaled:
                    self.store.journal_clear(uid)
            except Exception:
                pass
            if self.mgr is not None and fresh_lease:
                try:
                    self.mgr.release(uid)
                except Exception:
                    pass
            return False

    # ------------------------------------------------------ leader terminal

    def on_finished(self, req: ServiceRequest,
                    ctl: Optional[jobctl.JobControl], plugin, results,
                    stats: dict) -> None:
        """Leader success hook (called from the worker AFTER the sink,
        while the leader's lease is still held): store the cache entry,
        then fan the durable result out to every follower.  Never
        raises — the leader's job is already green."""
        uid = req.uid
        payload = None
        try:
            payload = (model.serialize_patterns(results)
                       if plugin.kind == "patterns"
                       else model.serialize_rules(results))
            self._store_entry(req, ctl, plugin, results, stats)
        except Exception as exc:
            _ERRORS.inc(op="store")
            log_event("rescache_error", op="store", uid=uid,
                      error=str(exc))
        for rec in self._pop_followers(uid):
            try:
                if payload is None:
                    raise RuntimeError("no fan-out payload")
                self._fanout_one(uid, rec, plugin.kind, payload, stats)
            except jobctl.JobAborted as exc:
                self._settle_follower_failure(rec, exc)
            except Exception as exc:
                _ERRORS.inc(op="fanout")
                log_event("rescache_error", op="fanout", uid=rec.uid,
                          leader=uid, error=str(exc))
                self._settle_follower_failure(rec, RuntimeError(
                    f"coalesced fan-out from leader {uid!r} failed: "
                    f"{exc}"))

    def _fanout_one(self, leader: str, rec: _Follower, kind: str,
                    payload: str, stats: dict) -> None:
        # the follower's OWN abort signals are owed first: a cancel or
        # deadline that landed while it waited must not be papered over
        jobctl.check_entry(rec.ctl)
        if self.mgr is not None:
            self.mgr.fence(rec.uid)  # raises JobLeaseLost when stale
        now = time.monotonic()
        if rec.ctl.started_t is None:
            rec.ctl.started_t = now
        self.store.clear_job(rec.uid, keep_status_log=True)
        self.store.set(f"fsm:stats:{rec.uid}", json.dumps(
            {**stats, "coalesced_into": leader}))
        if kind == "patterns":
            self.store.add_patterns(rec.uid, payload)
        else:
            self.store.add_rules(rec.uid, payload)
        self.store.add_status(rec.uid, Status.TRAINED)
        self.store.add_status(rec.uid, Status.FINISHED)
        self.store.journal_clear(rec.uid)
        jobctl.release_entry(rec.ctl)
        e2e = now - rec.ctl.submitted_t
        obsplane.observe_job(rec.priority, e2e, max(0.0, e2e), 0.0,
                             tenant=rec.ctl.tenant)
        # coalesced serve: the follower avoided the leader's measured
        # device cost (rode the same mine for free)
        u = stats.get("usage") or {}
        usage.credit_avoided(
            rec.ctl.tenant,
            u.get("device_seconds_measured")
            or u.get("device_seconds_est") or 0.0, "coalesced")
        obs.lifecycle(rec.uid, "settled", outcome="finished",
                      coalesced_into=leader)
        obs.flush_trace(rec.uid)
        if self.mgr is not None:
            self.mgr.release(rec.uid)
        self.store.incr("fsm:metric:jobs_finished")
        log_event("job_coalesced_fanout", uid=rec.uid, leader=leader)

    def _settle_follower_failure(self, rec: _Follower, exc) -> None:
        from spark_fsm_tpu_torch.service import actors

        try:
            actors._record_failure(self.store, rec.uid, exc,
                                   keep_frontier=True,
                                   lease_mgr=self.mgr)
        except Exception as settle_exc:
            log_event("rescache_follower_settle_failed", uid=rec.uid,
                      error=str(settle_exc))

    def on_leader_terminal(self, uid: str) -> None:
        """Leader reached a NON-success terminal state (failure, abort,
        drain, steal, fence): its followers are independent clients —
        re-dispatch each through normal admission as a cold mine
        (possibly re-coalescing onto a fresh leader).  Any follower
        whose re-dispatch fails gets a durable failure — never a stuck
        uid."""
        for rec in self._pop_followers(uid):
            try:
                # the follower's OWN abort signals are owed first, same
                # as the fan-out path: a cancel the client was already
                # told "cancelling" about, or a deadline spent waiting
                # on the leader, must not be papered over by a fresh
                # cold mine
                jobctl.check_entry(rec.ctl)
            except jobctl.JobAborted as exc:
                self._settle_follower_failure(rec, exc)
                continue
            try:
                if rec.ctl.deadline is not None:
                    # the re-dispatch re-registers the control entry:
                    # carry the REMAINING budget over, not a fresh one
                    rec.req.data["deadline_s"] = repr(max(
                        0.001, rec.ctl.deadline - time.monotonic()))
                # tear down follower-side state so the fresh admission
                # starts clean (its journal entry would 409 the submit)
                self.store.journal_clear(rec.uid)
                jobctl.release_entry(rec.ctl)
                if self.mgr is not None:
                    self.mgr.release(rec.uid)
                obs.lifecycle(rec.uid, "uncoalesced", leader=uid)
                obs.flush_trace(rec.uid)
                self.miner.submit(rec.req)
                log_event("job_uncoalesced", uid=rec.uid, leader=uid)
            except Exception as exc:
                self._settle_follower_failure(rec, RuntimeError(
                    f"coalesced leader {uid!r} did not finish and the "
                    f"cold re-dispatch failed: {exc}"))

    # ----------------------------------------------------- entry store/LRU

    def _store_entry(self, req: ServiceRequest,
                     ctl: Optional[jobctl.JobControl], plugin, results,
                     stats: dict) -> None:
        from spark_fsm_tpu_torch.service import plugins
        from spark_fsm_tpu_torch.utils.canonical import (sort_patterns,
                                                   sort_rules)

        fp = ctl.dataset_fp if ctl is not None else None
        if fp is None:
            return  # fingerprint never landed: nothing to key on
        faults.fault_site("rescache.store", uid=req.uid,
                          key=entry_key(fp, plugin.name))
        n = int(stats.get("sequences") or 0)
        params = plugins.effective_params(req, n_sequences=n)
        if self.mgr is not None:
            # fenced like the result sink: a superseded holder must not
            # publish a cache entry over the adopter's
            self.mgr.fence(req.uid)
        if plugin.kind == "patterns":
            payload = model.serialize_patterns(sort_patterns(results))
        else:
            payload = model.serialize_rules(sort_rules(results))
        # the rule-set digest the prediction plane keys its compiled
        # artifacts on (ops/rule_trie.rules_digest over the SAME payload
        # string) — stored on the entry AND the LRU sidecar so the
        # stats/admin surface can audit (fingerprint, digest) pairs
        # without pulling payloads off the store
        from spark_fsm_tpu_torch.ops.rule_trie import rules_digest

        digest = rules_digest(payload)
        ent = json.dumps({
            "algo": plugin.name, "kind": plugin.kind, "params": params,
            "n_sequences": n, "uid": req.uid, "digest": digest,
            "ts": round(time.time(), 3),
            # the mining job's recorded device cost (service/usage.py):
            # what a future serve from this entry AVOIDS — the usage
            # plane prices exact/dominated/coalesced credits from it
            "usage": stats.get("usage"),
            "payload": payload})
        # enveloped (utils/envelope.py) — entry FIRST, sidecar second:
        # a kill between the two leaves an intact entry whose sidecar
        # the scrubber (or the next serve-miss scrub) re-derives
        self.store.set(entry_key(fp, plugin.name), envelope.wrap(ent))
        self.store.set(_lru_key(fp, plugin.name), envelope.wrap(json.dumps(
            {"ts": time.time(), "bytes": len(ent), "digest": digest})))
        _BYTES_TOTAL.inc(len(ent))
        log_event("rescache_entry_stored", uid=req.uid, fp=fp[:16],
                  algo=plugin.name, bytes=len(ent))
        self._evict()

    def _meta_rows(self):
        """(last_used_ts, entry_key, tail, byte_size, digest) for every
        resident entry, read from the LRU sidecars — the eviction sweep
        and the stats endpoint must not pull full payloads off the
        store (at the default budget that would be up to 64 MiB per
        pass over a Redis backend).  An entry whose sidecar is
        missing/corrupt falls back to one payload read (digest absent
        for pre-sidecar-format entries)."""
        rows = []
        for key in self.store.scan_iter("fsm:rescache:"):
            tail = key[len("fsm:rescache:"):]
            ts, size, digest = 0.0, None, None
            side, _sv = envelope.unwrap(
                self.store.peek("fsm:rescache-lru:" + tail))
            if side:
                try:
                    meta = json.loads(side)
                    ts = float(meta.get("ts") or 0.0)
                    size = int(meta["bytes"])
                    digest = meta.get("digest")
                except (ValueError, TypeError, KeyError):
                    pass
            if size is None:
                raw = self.store.peek(key)
                if raw is None:
                    continue
                payload, _v = envelope.unwrap(raw)
                size = len(payload) if payload is not None else len(raw)
            rows.append((ts, key, tail, size, digest))
        return rows

    def _evict(self) -> None:
        """LRU byte-budget sweep over a cursor SCAN (never KEYS): drop
        the least-recently-used entries until the resident bytes fit
        ``max_bytes``.  Eviction is plain DELs — a concurrent serve
        that loses the race simply misses and mines cold."""
        rows = self._meta_rows()
        total = sum(size for _, _, _, size, _ in rows)
        if self.max_bytes:
            for ts, key, tail, size, _ in sorted(
                    rows, key=lambda r: (r[0], r[1])):
                if total <= self.max_bytes:
                    break
                self.store.delete(key)
                self.store.delete("fsm:rescache-lru:" + tail)
                total -= size
                _EVICTIONS.inc()
                log_event("rescache_evicted", key=key, bytes=size)
        _BYTES.set(total)

    # ------------------------------------------------------------ admin

    def stats(self) -> dict:
        with self._lock:
            leaders = len(self._by_leader)
            followers = sum(len(s["followers"])
                            for s in self._by_leader.values())
        try:
            rows = self._meta_rows()
            entries = len(rows)
            bytes_total = sum(size for _, _, _, size, _ in rows)
            # auditable per-entry identity: the
            # dataset fingerprint + algorithm the entry serves under and
            # the rule-set digest the prediction plane's artifact cache
            # keys on — an operator can now line /admin/predictor's
            # resident digests up against the cache that fed them
            detail = []
            for ts, _, tail, size, digest in sorted(rows, reverse=True,
                                                    key=lambda r: r[0]):
                fp, _, algo = tail.rpartition(":")
                detail.append({"fingerprint": fp, "algo": algo,
                               "digest": digest, "bytes": size,
                               "ts": round(ts, 3)})
        except Exception:
            entries = bytes_total = detail = None  # store down: stay
            # readable
        return {
            "enabled": True,
            "coalesce": self.coalesce_enabled,
            "dominance": self.dominance_enabled,
            "max_bytes": self.max_bytes,
            "entries": entries,
            "bytes": bytes_total,
            "entries_detail": detail,
            "inflight_leaders": leaders,
            "inflight_followers": followers,
            "counters": {
                "hits": _HITS.total(),
                "dominated_serves": _DOMINATED.total(),
                "misses": _MISSES.total(),
                "coalesced": _COALESCED.total(),
                "evictions": _EVICTIONS.total(),
                "errors": _ERRORS.total(),
            },
        }


# ----------------------------------------------------- dominance predicates

def _servable(ent: dict, want: dict
              ) -> Optional[Tuple[str, str, int]]:
    """(payload_json, mode, n_results) when the cached entry ``ent``
    can answer the effective params ``want`` EXACTLY, else None.  The
    conservative per-algorithm predicates — docs/DESIGN.md proves each;
    tests/test_resultcache.py pins parity against cold mines and the
    deliberately non-dominated misses."""
    if ent.get("algo") != want.get("algo"):
        return None
    if ent.get("kind") == "patterns":
        return _servable_patterns(ent, want)
    if ent.get("kind") == "rules":
        return _servable_rules(ent, want)
    return None


def _servable_patterns(ent: dict, want: dict
                       ) -> Optional[Tuple[str, str, int]]:
    from spark_fsm_tpu_torch.data.vertical import abs_minsup

    have = ent["params"]
    if (have.get("maxgap"), have.get("maxwindow")) != \
            (want.get("maxgap"), want.get("maxwindow")):
        # constraints must match EXACTLY: supports change under a
        # tighter gap/window, so filtering cannot reproduce a cold mine
        return None
    m0 = have.get("minsup_abs")
    if m0 is None:
        return None
    m1 = want.get("minsup_abs")
    if m1 is None:
        # relative support: same fingerprint => same |DB|, so the
        # cached entry's sequence count resolves it
        m1 = abs_minsup(float(want["support"]), int(ent["n_sequences"]))
    if m1 == m0:
        return ent["payload"], "exact", _payload_len(ent)
    if m1 < m0:
        return None  # lower minsup admits patterns the cached run pruned
    pats = model.deserialize_patterns(ent["payload"])
    kept = [(p, s) for p, s in pats if s >= m1]
    return model.serialize_patterns(kept), "dominated", len(kept)


def _servable_rules(ent: dict, want: dict
                    ) -> Optional[Tuple[str, str, int]]:
    have = ent["params"]
    k0, k1 = int(have["k"]), int(want["k"])
    n0, d0 = _conf_frac(have["minconf"])
    n1, d1 = _conf_frac(want["minconf"])
    s0, s1 = have.get("max_side"), want.get("max_side")
    same_conf = n0 * d1 == n1 * d0
    same_side = s0 == s1
    if k1 == k0 and same_conf and same_side:
        return ent["payload"], "exact", _payload_len(ent)
    if k1 > k0:
        return None  # a bigger k needs rules the cached run cut
    if n1 * d0 < n0 * d1:
        return None  # lower minconf admits rules the cached run pruned
    if s0 is not None and (s1 is None or int(s1) > int(s0)):
        return None  # looser side bound needs unexplored rules
    rules = model.deserialize_rules(ent["payload"])
    # the cached run's own tie-inclusive threshold: min support when
    # the heap filled (>= k0 rules), else the run was EXHAUSTIVE (it
    # returned every qualifying rule — nothing was support-pruned)
    exhaustive = len(rules) < k0
    s_k0 = min((r[2] for r in rules), default=0)
    cand = [r for r in rules
            if r[2] * d1 >= n1 * r[3]  # conf >= minconf', exact
            and (s1 is None or (len(r[0]) <= int(s1)
                                and len(r[1]) <= int(s1)))]
    if len(cand) >= k1:
        sups = sorted((r[2] for r in cand), reverse=True)
        s_k1 = sups[k1 - 1]
        if not exhaustive and s_k1 < s_k0:
            # rules the cached run support-pruned (sup < s_k0) could
            # enter this weaker top-k: refuse, mine cold
            return None
        kept = [r for r in cand if r[2] >= s_k1]
    else:
        if not exhaustive:
            return None  # the full qualifying set was never materialized
        kept = cand
    return model.serialize_rules(kept), "dominated", len(kept)


def _payload_len(ent: dict) -> int:
    try:
        return len(json.loads(ent["payload"]))
    except Exception:
        return 0
