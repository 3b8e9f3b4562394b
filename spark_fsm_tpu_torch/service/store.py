"""Result/metadata store — the reference's RedisSink/RedisCache contract.

The reference persists mined patterns/rules, job statuses, registered
field specs, and tracked events in Redis (SURVEY.md sec 1 L1, sec 5
checkpoint row: "the model IS the mined pattern/rule set persisted once at
job end").  This module provides the same contract behind an interface
with two implementations:

- ``ResultStore``: in-process, thread-safe dict store (the default — no
  external service needed, mirrors Redis key semantics).
- ``RedisResultStore``: the same contract over a real Redis server,
  speaking RESP2 directly via service/resp.py (no client package);
  selected with ``store.backend = "redis"`` in the boot config.

Key layout follows the reference's convention: ``fsm:status:<uid>``,
``fsm:pattern:<uid>``, ``fsm:rule:<uid>``, ``fsm:fields:<topic>``,
``fsm:track:<topic>``.

Port: a copy of ``spark_fsm_tpu/service/store.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_fsm_tpu_torch.utils import envelope, faults, obs

# Latency of the three guarded store verbs, labelled by op and backend
# (inproc latencies are the no-op baseline a Redis deployment's numbers
# are read against).  Sub-ms buckets dominate; the shared ladder keeps
# cross-metric comparisons on one set of edges.
_STORE_OP_SECONDS = obs.REGISTRY.histogram(
    "fsm_store_op_seconds", "result-store I/O verb latency")


class _timed:
    """Tiny context manager: observe the verb's wall into the shared
    histogram even when the verb raises (a slow FAILING store is the
    case the scrape most needs to show)."""

    __slots__ = ("op", "backend", "t0")

    def __init__(self, op: str, backend: str):
        self.op = op
        self.backend = backend

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        _STORE_OP_SECONDS.observe(time.monotonic() - self.t0,
                                  op=self.op, backend=self.backend)


class ResultStore:
    """Thread-safe in-process store with Redis-like key semantics.

    ``clock`` (default ``time.monotonic``) drives key EXPIRY — the lease
    layer's substrate (service/lease.py).  Injectable so lease tests run
    hermetically against a virtual clock instead of sleeping out TTLs.
    Expiry is lazy (Redis-style): an expired key is purged the next time
    any verb touches it or a ``keys`` scan walks past it.
    """

    def __init__(self, clock=None) -> None:
        self._lock = threading.RLock()
        self._kv: Dict[str, str] = {}
        self._lists: Dict[str, List[str]] = {}
        self._expiry: Dict[str, float] = {}  # key -> clock() deadline
        self._clock = clock if clock is not None else time.monotonic

    def _alive(self, key: str) -> bool:
        """Purge ``key`` if its TTL lapsed; True while it (still) lives.
        Callers hold ``self._lock``."""
        deadline = self._expiry.get(key)
        if deadline is not None and self._clock() >= deadline:
            self._expiry.pop(key, None)
            self._kv.pop(key, None)
            self._lists.pop(key, None)
            return False
        return key in self._kv or key in self._lists

    # -- generic ops (Redis GET/SET/RPUSH/LRANGE equivalents) --------------
    # The three primary I/O verbs carry fault-site guards (utils/faults):
    # the guard raises BEFORE the mutation, so an injected failure models
    # an I/O error with nothing applied — the retry policies layered on
    # top (StoreCheckpoint) re-run the whole verb safely.

    def set(self, key: str, value: str) -> None:
        with _timed("set", "inproc"):
            faults.fault_site("store.set", key=key)
            with self._lock:
                # Redis SET semantics: a plain SET clears any TTL
                self._expiry.pop(key, None)
                self._kv[key] = value

    def get(self, key: str) -> Optional[str]:
        with _timed("get", "inproc"):
            faults.fault_site("store.get", key=key)
            with self._lock:
                self._alive(key)
                value = self._kv.get(key)
            # bitrot chaos seam: disarmed = one global read
            return faults.corrupt_value("store.corrupt", value, key=key)

    def peek(self, key: str) -> Optional[str]:
        """Guard-free read for scrape-time metric collectors AND the
        lease layer: skips the fault-injection site AND the latency
        histogram, so a /metrics scrape can never advance (or consume)
        an armed ``store.get`` trigger mid-chaos-drill, collector reads
        don't pollute the I/O latency distribution, and lease
        verification carries its OWN fault sites (``lease.*``) instead
        of riding the store's."""
        with self._lock:
            self._alive(key)
            return self._kv.get(key)

    # -- key expiry (the lease layer's substrate) --------------------------
    # Mirrors the Redis verbs the lease protocol needs: atomic
    # SET..PX[..NX] for acquisition, PEXPIRE for heartbeat renewal, PTTL
    # for observation.  Deliberately NOT guarded by the store.* fault
    # sites — service/lease.py wraps these in its own ``lease.acquire``/
    # ``lease.renew``/``lease.steal`` sites so chaos drills target the
    # lease protocol without collateral damage to unrelated store drills.

    def set_px(self, key: str, value: str, px_ms: int,
               nx: bool = False) -> bool:
        """Redis ``SET key value PX px_ms [NX]``: write with a TTL;
        with ``nx`` only when the key does not (or no longer) exists.
        Returns False when NX refused the write."""
        with self._lock:
            if nx and self._alive(key):
                return False
            self._kv[key] = value
            self._expiry[key] = self._clock() + px_ms / 1000.0
            return True

    def pexpire(self, key: str, px_ms: int) -> bool:
        """Redis PEXPIRE: re-arm a live key's TTL; False if the key is
        missing/expired (the lease-renewal race signal)."""
        with self._lock:
            if not self._alive(key):
                return False
            self._expiry[key] = self._clock() + px_ms / 1000.0
            return True

    def pttl(self, key: str) -> int:
        """Redis PTTL: remaining TTL in ms; -1 = no expiry, -2 = no key."""
        with self._lock:
            if not self._alive(key):
                return -2
            deadline = self._expiry.get(key)
            if deadline is None:
                return -1
            return max(0, int((deadline - self._clock()) * 1000))

    def rpush(self, key: str, value: str) -> None:
        with _timed("rpush", "inproc"):
            faults.fault_site("store.rpush", key=key)
            with self._lock:
                self._lists.setdefault(key, []).append(value)

    def lrange(self, key: str) -> List[str]:
        with self._lock:
            values = list(self._lists.get(key, []))
        # per-ELEMENT bitrot seam: nth addresses a specific chunk
        return faults.corrupt_list("store.corrupt", values, key=key)

    def lpop(self, key: str) -> Optional[str]:
        with self._lock:
            lst = self._lists.get(key)
            return lst.pop(0) if lst else None

    def llen(self, key: str) -> int:
        with self._lock:
            return len(self._lists.get(key, ()))

    def ltrim(self, key: str, keep: int) -> None:
        """Keep only the FIRST ``keep`` entries of a list (Redis LTRIM
        key 0 keep-1) — the checkpoint torn-tail heal primitive."""
        with self._lock:
            lst = self._lists.get(key)
            if lst is not None:
                del lst[max(0, keep):]

    def delete(self, key: str) -> int:
        """Redis DEL: returns how many keys were removed (0 or 1) — the
        atomic ownership arbiter the work-stealing claim rides on
        (exactly ONE caller ever observes 1 for a given live key)."""
        with self._lock:
            alive = self._alive(key)
            self._expiry.pop(key, None)
            self._kv.pop(key, None)
            self._lists.pop(key, None)
            return 1 if alive else 0

    def incr(self, key: str) -> int:
        """Redis INCR: atomic counter (service metrics and the lease
        fencing-token sequence live on these)."""
        with self._lock:
            self._alive(key)
            value = int(self._kv.get(key, "0")) + 1
            self._kv[key] = str(value)
            return value

    def clear_job(self, uid: str, *, keep_status_log: bool = False,
                  keep_frontier: bool = False) -> None:
        """Remove a job's error/results (and optionally its status log) so a
        reused uid reports THIS job, not a predecessor's leftovers.
        ``keep_frontier`` preserves the checkpoint keys: a checkpointed
        resubmit (the restart-recovery path) must resume from the
        persisted frontier, not wipe it — the engine's fingerprint check
        still discards a frontier that doesn't match the new data."""
        keys = [f"fsm:error:{uid}", f"fsm:pattern:{uid}", f"fsm:rule:{uid}",
                f"fsm:stats:{uid}"]
        if not keep_frontier:
            keys += [f"fsm:frontier:{uid}", f"fsm:frontier:results:{uid}"]
        if not keep_status_log:
            keys.append(f"fsm:status:log:{uid}")
        for key in keys:
            self.delete(key)

    def keys(self, prefix: str) -> List[str]:
        """Keys (kv + list) starting with ``prefix``.  The Redis backend
        maps this to KEYS, which blocks the server while it scans — the
        recurring walks (heartbeat peers, steal scan, journal recovery)
        use :meth:`scan_iter` instead; this stays for tests and one-off
        admin reads."""
        with self._lock:
            return sorted({k for k in list(self._kv) + list(self._lists)
                           if k.startswith(prefix) and self._alive(k)})

    # -- cursor-based key scan (Redis SCAN) --------------------------------
    # The lease layer's steal/heartbeat/recovery walks repeat on every
    # heartbeat tick; at thousands of replicas sharing one store a KEYS
    # walk per tick would serialize the server on each scan (the ROADMAP
    # item 1 follow-up).  SCAN iterates in bounded batches.  Cursors are
    # OPAQUE strings (exactly the Redis contract): "0" starts AND ends an
    # iteration; any other value is backend-defined.  The in-process
    # backend (and MiniRedis) use the last key returned, so keys alive
    # for the whole iteration are seen exactly once; real Redis may
    # return duplicates across rehashes — every caller here is
    # idempotent per key (peer parse, atomic DEL claim, journal heal).

    def scan_keys(self, prefix: str, cursor: str = "0",
                  count: int = 512) -> Tuple[str, List[str]]:
        """One SCAN step: up to ``count`` live keys with ``prefix``
        after ``cursor``; returns ``(next_cursor, keys)`` with
        next_cursor == "0" when the iteration is complete."""
        with self._lock:
            keys = sorted({k for k in list(self._kv) + list(self._lists)
                           if k.startswith(prefix) and self._alive(k)})
        if cursor != "0":
            keys = keys[bisect.bisect_right(keys, cursor):]
        batch = keys[:max(1, int(count))]
        nxt = "0" if len(keys) <= len(batch) else batch[-1]
        return nxt, batch

    def scan_iter(self, prefix: str, count: int = 512):
        """Generator over :meth:`scan_keys` — the one spelling every
        recurring walk uses (lease peers/steal, journal recovery)."""
        cursor = "0"
        while True:
            cursor, batch = self.scan_keys(prefix, cursor, count)
            for key in batch:
                yield key
            if cursor == "0":
                return

    def probe(self) -> bool:
        """Active health probe (service/storeguard.py): can the store be
        reached RIGHT NOW?  The in-process store is reachable by
        construction — outages against it are simulated by wrapping
        (tests) or by the ``storeguard.probe`` fault site, which the
        guard weaves around this call."""
        return True

    # -- write-ahead job journal -------------------------------------------
    # One intent record per live train job (``fsm:journal:{uid}``),
    # written at submit and cleared on every terminal status.  A record
    # that survives a process death marks an ORPHAN: the boot recovery
    # pass (service/actors.recover_orphans) resubmits checkpointed
    # orphans (they resume from their persisted frontier) and gives the
    # rest a durable "interrupted by restart" failure, so no client ever
    # polls a forever-pending uid.

    def journal_set(self, uid: str, payload_json: str) -> None:
        faults.fault_site("service.journal", key=f"fsm:journal:{uid}")
        # every journal intent is written enveloped (utils/envelope.py);
        # journal_get verifies, and legacy pre-envelope intents pass
        # through untouched until their next write upgrades them
        self.set(f"fsm:journal:{uid}", envelope.wrap(payload_json))

    def journal_get(self, uid: str) -> Optional[str]:
        """Verified journal read: the intent payload on an intact or
        legacy value; on a CORRUPT envelope the raw damaged bytes are
        returned so the caller's JSON parse fails into its existing
        degrade path (recover_orphans quarantines, lease._parse treats
        it as not-ours) instead of this layer guessing a policy."""
        raw = self.get(f"fsm:journal:{uid}")
        payload, verdict = envelope.unwrap(raw)
        if verdict == "missing":
            return None
        # lazy import: integrity sits above the store in the service
        # layering (it holds the counters + quarantine policy)
        from spark_fsm_tpu_torch.service import integrity
        integrity.note_read("journal", verdict)
        return raw if verdict == "corrupt" else payload

    def journal_clear(self, uid: str) -> None:
        self.delete(f"fsm:journal:{uid}")

    def journal_uids(self) -> List[str]:
        # cursor-based: the recovery pass runs on every heartbeat tick
        # in cluster mode, not just at boot — a KEYS walk here would
        # block the shared server once per replica per tick
        return [k[len("fsm:journal:"):]
                for k in self.scan_iter("fsm:journal:")]

    # -- durable trace spine (service/obsplane.py) -------------------------
    # Append-only list of span-chunk JSON per job.  Deliberately
    # guard-free (like ``peek``): spine writes are observability riding
    # the job's threads — an armed ``store.rpush`` chaos drill targets
    # checkpoint deltas, and trace flushes consuming its trigger counts
    # would make pinned-seed drills nondeterministic.  Fencing lives a
    # layer up (obsplane.TraceSpine), not in the store verb.

    def spine_append(self, uid: str, chunk_json: str) -> None:
        with self._lock:
            self._lists.setdefault(f"fsm:trace:{uid}", []).append(chunk_json)

    def spine_chunks(self, uid: str) -> List[str]:
        with self._lock:
            values = list(self._lists.get(f"fsm:trace:{uid}", ()))
        # raise-free but NOT bitrot-free: the spine is a durable surface
        # too, and obsplane's verified reader must see planted damage
        return faults.corrupt_list("store.corrupt", values,
                                   key=f"fsm:trace:{uid}")

    def spine_trim(self, uid: str, keep_last: int) -> None:
        """Retention bound: keep only the NEWEST ``keep_last`` chunks
        (the opposite end from ltrim — old warmup chunks are the ones a
        straggler hunt can spare)."""
        with self._lock:
            lst = self._lists.get(f"fsm:trace:{uid}")
            if lst is not None and len(lst) > max(0, keep_last):
                del lst[:len(lst) - max(0, keep_last)]

    # -- job status registry (RedisCache.addStatus / status) ---------------

    def add_status(self, uid: str, status: str) -> None:
        ts = int(time.time() * 1000)
        self.set(f"fsm:status:{uid}", status)
        self.rpush(f"fsm:status:log:{uid}", f"{ts}:{status}")

    def status(self, uid: str) -> Optional[str]:
        return self.get(f"fsm:status:{uid}")

    def status_log(self, uid: str) -> List[Tuple[int, str]]:
        out = []
        for entry in self.lrange(f"fsm:status:log:{uid}"):
            ts, _, st = entry.partition(":")
            out.append((int(ts), st))
        return out

    # -- mined results (RedisSink.addPatterns / addRules) ------------------

    def add_patterns(self, uid: str, payload_json: str) -> None:
        self.set(f"fsm:pattern:{uid}", payload_json)

    def patterns(self, uid: str) -> Optional[str]:
        return self.get(f"fsm:pattern:{uid}")

    def add_rules(self, uid: str, payload_json: str) -> None:
        self.set(f"fsm:rule:{uid}", payload_json)

    def rules(self, uid: str) -> Optional[str]:
        return self.get(f"fsm:rule:{uid}")

    # -- field specs (FSMRegistrar / spec.Fields) --------------------------

    def add_fields(self, topic: str, spec_json: str) -> None:
        self.set(f"fsm:fields:{topic}", spec_json)

    def fields(self, topic: str) -> Optional[str]:
        return self.get(f"fsm:fields:{topic}")

    # -- tracked events (FSMTracker ingest) --------------------------------

    def track(self, topic: str, event_json: str) -> None:
        self.rpush(f"fsm:track:{topic}", event_json)

    def tracked(self, topic: str) -> List[str]:
        return self.lrange(f"fsm:track:{topic}")


class RedisResultStore(ResultStore):
    """Store over a real Redis — the reference's RedisSink/RedisCache pair
    (SURVEY.md sec 2), speaking RESP2 directly via service/resp.py (no
    client package needed).  Same key layout as the in-process store, so
    the two are interchangeable behind ``store.backend`` in the boot
    config; protocol-tested against an in-process RESP server in
    tests/test_redis_store.py.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout_s: float = 10.0) -> None:
        super().__init__()
        from spark_fsm_tpu_torch.service.resp import RespClient

        self._host, self._port = host, port
        self._timeout_s = float(timeout_s)
        self._r = RespClient(host=host, port=port, timeout=self._timeout_s)
        self._r.ping()  # fail fast at boot, not on first job
        # the probe rides a DEDICATED lazily-built connection with a
        # short timeout: a data connection wedged in a blackhole must
        # not alias onto the health verdict, and a probe against a
        # down store must answer in ~a second, not the data timeout
        self._probe_client = None

    def set(self, key: str, value: str) -> None:
        with _timed("set", "redis"):
            faults.fault_site("store.set", key=key)
            self._r.set(key, value)

    def get(self, key: str) -> Optional[str]:
        with _timed("get", "redis"):
            faults.fault_site("store.get", key=key)
            return faults.corrupt_value("store.corrupt", self._r.get(key),
                                        key=key)

    def peek(self, key: str) -> Optional[str]:
        return self._r.get(key)

    def set_px(self, key: str, value: str, px_ms: int,
               nx: bool = False) -> bool:
        return self._r.set_px(key, value, px_ms, nx=nx)

    def pexpire(self, key: str, px_ms: int) -> bool:
        return self._r.pexpire(key, px_ms)

    def pttl(self, key: str) -> int:
        return self._r.pttl(key)

    def rpush(self, key: str, value: str) -> None:
        with _timed("rpush", "redis"):
            faults.fault_site("store.rpush", key=key)
            self._r.rpush(key, value)

    def lrange(self, key: str) -> List[str]:
        return faults.corrupt_list("store.corrupt",
                                   self._r.lrange(key, 0, -1), key=key)

    def lpop(self, key: str) -> Optional[str]:
        return self._r.lpop(key)

    def llen(self, key: str) -> int:
        return self._r.llen(key)

    def ltrim(self, key: str, keep: int) -> None:
        if keep <= 0:
            self._r.delete(key)
        else:
            self._r.ltrim(key, 0, keep - 1)

    def delete(self, key: str) -> int:
        return self._r.delete(key)

    def incr(self, key: str) -> int:
        return self._r.incr(key)

    def keys(self, prefix: str) -> List[str]:
        # Redis KEYS is O(keyspace) and blocks the server — kept for
        # tests/one-off admin reads only; every recurring walk goes
        # through scan_keys/scan_iter below.
        return sorted(self._r.keys(prefix + "*"))

    def scan_keys(self, prefix: str, cursor: str = "0",
                  count: int = 512) -> Tuple[str, List[str]]:
        nxt, batch = self._r.scan(cursor, match=prefix + "*", count=count)
        # MATCH already filters server-side; re-filter defensively so a
        # backend returning unmatched keys cannot leak them upward
        return nxt, [k for k in batch if k.startswith(prefix)]

    def probe(self) -> bool:
        """One PING on the dedicated probe connection (built fresh after
        any failure, so a dead socket never caches a stale verdict).
        Raises the transport error on an unreachable store — the
        guard's state machine classifies it."""
        from spark_fsm_tpu_torch.service.resp import RespClient

        try:
            if self._probe_client is None:
                self._probe_client = RespClient(
                    host=self._host, port=self._port,
                    timeout=min(2.0, self._timeout_s))
            return self._probe_client.ping()
        except Exception:
            # drop the probe connection: the next probe reconnects from
            # scratch instead of reading a desynced stream
            try:
                if self._probe_client is not None:
                    self._probe_client.close()
            finally:
                self._probe_client = None
            raise

    def spine_append(self, uid: str, chunk_json: str) -> None:
        self._r.rpush(f"fsm:trace:{uid}", chunk_json)

    def spine_chunks(self, uid: str) -> List[str]:
        return faults.corrupt_list(
            "store.corrupt", self._r.lrange(f"fsm:trace:{uid}", 0, -1),
            key=f"fsm:trace:{uid}")

    def spine_trim(self, uid: str, keep_last: int) -> None:
        if keep_last <= 0:
            self._r.delete(f"fsm:trace:{uid}")
        else:  # LTRIM key -N -1: keep the newest N entries
            self._r.ltrim(f"fsm:trace:{uid}", -keep_last, -1)
