"""Durable-state integrity plane: per-surface verify-on-read
policy, the quarantine keyspace, and the background scrubber.

utils/envelope.py owns the BYTES (checksummed self-describing envelope
around every durable write); this module owns the POLICY — what each
surface does when a read fails its checksum, how corrupt values are
quarantined for the post-mortem, and the at-rest scrubber that finds
bitrot *before* a read path trips over it.

Per-surface degradation posture (the DESIGN.md table; each surface
degrades by its own blast radius, never by a shared policy):

==========  ========================================================
surface     on corrupt
==========  ========================================================
checkpoint  delta chunk: truncate to the last good snapshot embedded
            in the preceding chunk and RESUME (actors.StoreCheckpoint
            .load); meta: restart the mine fresh, loudly.  The
            scrubber only quarantine-COPIES checkpoint damage — the
            heal itself belongs to load(), the single writer.
journal     intent moved to ``fsm:quarantine:{uid}``; boot recovery
            continues over the remaining orphans
            (actors.recover_orphans).
rescache    entry invalidated + quarantined; the request falls
            through to a cold mine — corrupt bytes are NEVER served.
            A missing/corrupt LRU sidecar beside an intact entry is
            REPAIRED (re-derived from the entry), the one surface a
            live leader can heal in place.
spine       chunk skipped + counted (obsplane.merged_timeline) — the
            timeline is evidence and must never fail a dump.  The
            scrubber counts, it does not quarantine (no per-element
            list surgery).
lease       heartbeat/autoscale record treated as absent — the TTL
            layer already tolerates missing records; a corrupt one
            just ages out.
==========  ========================================================

The scrubber rides the lease heartbeat cadence in cluster mode
(lease.LeaseManager.tick -> :func:`tick`) and a private daemon thread
on solo boots (started by app.main); either way each pass walks at
most ``[integrity] scrub_batch`` keys via cursor-based ``scan_keys``
with the cursor carried ACROSS passes — it can never become a store
scan storm.  Reporting: ``/admin/integrity`` + the zero-seeded
``fsm_integrity_{scans,verified,legacy,corrupt,quarantined,repaired}_total``
families.

Port: a copy of ``spark_fsm_tpu/service/integrity.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Optional

from spark_fsm_tpu_torch.utils import envelope, obs
from spark_fsm_tpu_torch.utils.obs import log_event

#: label vocabulary for every fsm_integrity_* family (zero-seeded so a
#: scrape reads 0, not no-data, for surfaces with no events yet)
SURFACES = ("checkpoint", "journal", "rescache", "spine", "lease")

QUARANTINE_PREFIX = "fsm:quarantine:"

_SCANS = obs.REGISTRY.counter(
    "fsm_integrity_scans_total", "background scrubber passes completed")
_VERIFIED = obs.REGISTRY.counter(
    "fsm_integrity_verified_total",
    "durable values that passed envelope verification, by surface")
_LEGACY = obs.REGISTRY.counter(
    "fsm_integrity_legacy_total",
    "pre-envelope values accepted as verify=legacy, by surface")
_CORRUPT = obs.REGISTRY.counter(
    "fsm_integrity_corrupt_total",
    "durable values that FAILED verification, by surface")
_QUARANTINED = obs.REGISTRY.counter(
    "fsm_integrity_quarantined_total",
    "corrupt values preserved under fsm:quarantine:*, by surface")
_REPAIRED = obs.REGISTRY.counter(
    "fsm_integrity_repaired_total",
    "corrupt/missing values re-derived in place (rescache sidecars), "
    "by surface")
for _s in SURFACES:
    _VERIFIED.seed(surface=_s)
    _LEGACY.seed(surface=_s)
    _CORRUPT.seed(surface=_s)
    _QUARANTINED.seed(surface=_s)
    _REPAIRED.seed(surface=_s)


def note_read(surface: str, verdict: str) -> None:
    """Count one verify-on-read (or at-rest) verdict for ``surface``.
    ``missing`` is a key-absent read, not a verification outcome."""
    if verdict == "ok":
        _VERIFIED.inc(surface=surface)
    elif verdict == "legacy":
        _LEGACY.inc(surface=surface)
    elif verdict == "corrupt":
        _CORRUPT.inc(surface=surface)


def open_value(raw: Optional[str], surface: str):
    """`envelope.unwrap` + verdict counting in one call — the spelling
    most read sites use.  Returns ``(payload, verdict)`` unchanged."""
    payload, verdict = envelope.unwrap(raw)
    note_read(surface, verdict)
    return payload, verdict


def quarantine_key(key: str) -> str:
    """Quarantine address for a damaged key.  Journal intents map to
    the mandated ``fsm:quarantine:{uid}``; everything else keeps
    its post-``fsm:`` tail (e.g. ``fsm:quarantine:rescache:{fp}:{algo}``)
    so one scan of the prefix lists every quarantined surface."""
    if key.startswith("fsm:journal:"):
        return QUARANTINE_PREFIX + key[len("fsm:journal:"):]
    if key.startswith("fsm:"):
        return QUARANTINE_PREFIX + key[len("fsm:"):]
    return QUARANTINE_PREFIX + key


def quarantine(store, key: str, raw: Optional[str], surface: str,
               move: bool = False) -> str:
    """Preserve damaged bytes under the quarantine keyspace (enveloped,
    so the quarantine record itself is verifiable) and count it.  With
    ``move`` the original key is deleted — the journal/rescache posture;
    checkpoint damage is only COPIED (load() owns the heal).  Idempotent
    per key: a scrub pass re-walking known damage neither rewrites nor
    recounts it."""
    qkey = quarantine_key(key)
    if store.peek(qkey) is None:
        rec = json.dumps({"key": key, "surface": surface,
                          "ts": round(time.time(), 3), "value": raw})
        store.set(qkey, envelope.wrap(rec))
        _QUARANTINED.inc(surface=surface)
        log_event("integrity_quarantined", key=key, surface=surface,
                  moved=move)
    if move:
        store.delete(key)
    return qkey


def note_repaired(surface: str) -> None:
    _REPAIRED.inc(surface=surface)


# -- the background scrubber ----------------------------------------------

# (prefix, surface-kind) walked round-robin with a cross-pass cursor.
# fsm:frontier: covers both the meta and the fsm:frontier:results: list.
_WALK = (
    ("fsm:journal:", "journal"),
    ("fsm:rescache:", "rescache_entry"),
    ("fsm:rescache-lru:", "rescache_sidecar"),
    ("fsm:frontier:", "checkpoint"),
    ("fsm:trace:", "spine"),
)


class Scrubber:
    """Batch-bounded at-rest envelope verifier.

    One ``scrub()`` pass examines at most ``batch`` keys, resuming from
    the cursor the previous pass left off — a 10M-key store is scrubbed
    across many passes, never in one scan storm.  kv reads go through
    ``store.peek`` (guard-free: a scrub must not consume an armed chaos
    trigger aimed at the read path it protects); list surfaces ride
    ``lrange``/``spine_chunks``."""

    def __init__(self, store, scrub_every_s: float = 60.0,
                 batch: int = 256) -> None:
        self.store = store
        self.scrub_every_s = float(scrub_every_s)
        self.batch = int(batch)
        self._pi = 0          # index into _WALK
        self._cursor = "0"
        self._next_due = 0.0  # monotonic deadline for maybe_scrub
        self._run_lock = threading.Lock()  # tick thread vs solo thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.keys_scanned = 0
        self.last_pass: Optional[dict] = None

    # -- driving ----------------------------------------------------------

    def maybe_scrub(self) -> None:
        """Next-due-gated pass — safe to call from any cadence (lease
        tick AND the solo thread may both drive one scrubber)."""
        if self.scrub_every_s <= 0:
            return
        now = time.monotonic()
        if now < self._next_due:
            return
        if not self._run_lock.acquire(blocking=False):
            return
        try:
            self._next_due = now + self.scrub_every_s
            self.scrub()
        finally:
            self._run_lock.release()

    def start(self) -> None:
        """Solo-boot cadence thread (cluster mode rides the lease
        heartbeat via :func:`tick` instead and never needs this)."""
        if self._thread is not None or self.scrub_every_s <= 0:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.scrub_every_s):
                try:
                    self.maybe_scrub()
                except Exception as exc:  # scrub must never kill the loop
                    log_event("integrity_scrub_failed", error=str(exc))

        self._thread = threading.Thread(
            target=_loop, name="integrity-scrub", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- one pass ---------------------------------------------------------

    def scrub(self, limit: Optional[int] = None) -> dict:
        """One bounded pass; returns its tally (also kept as
        ``last_pass``).  Direct calls (tests, admin) bypass the cadence
        gate but still share the run lock."""
        budget = int(limit) if limit is not None else self.batch
        t0 = time.monotonic()
        tally = {"keys": 0, "corrupt": 0, "quarantined": 0, "repaired": 0}
        advances = 0
        while tally["keys"] < budget and advances <= len(_WALK):
            prefix, kind = _WALK[self._pi]
            step = min(64, budget - tally["keys"])
            nxt, keys = self.store.scan_keys(prefix, self._cursor, step)
            for key in keys:
                try:
                    self._verify_key(key, kind, tally)
                except Exception as exc:
                    # one unreadable key must not wedge the walk
                    log_event("integrity_scrub_key_failed", key=key,
                              error=str(exc))
                tally["keys"] += 1
            if nxt == "0":
                self._pi = (self._pi + 1) % len(_WALK)
                self._cursor = "0"
                advances += 1
            else:
                self._cursor = nxt
        self.passes += 1
        self.keys_scanned += tally["keys"]
        _SCANS.inc()
        tally["duration_ms"] = round((time.monotonic() - t0) * 1000, 3)
        tally["ts"] = round(time.time(), 3)
        self.last_pass = tally
        if tally["corrupt"]:
            log_event("integrity_scrub_found_corruption", **tally)
        return tally

    def _verify_key(self, key: str, kind: str, tally: dict) -> None:
        if kind == "journal":
            payload, verdict = open_value(self.store.peek(key), "journal")
            if verdict != "corrupt":
                return
            tally["corrupt"] += 1
            quarantine(self.store, key, self.store.peek(key), "journal",
                       move=True)
            tally["quarantined"] += 1
        elif kind == "rescache_entry":
            self._verify_rescache_entry(key, tally)
        elif kind == "rescache_sidecar":
            self._verify_rescache_sidecar(key, tally)
        elif kind == "checkpoint":
            self._verify_checkpoint(key, tally)
        elif kind == "spine":
            for chunk in self.store.lrange(key):
                payload, verdict = open_value(chunk, "spine")
                if verdict == "corrupt":
                    tally["corrupt"] += 1

    def _verify_rescache_entry(self, key: str, tally: dict) -> None:
        from spark_fsm_tpu_torch.service import resultcache

        raw = self.store.peek(key)
        if raw is None:
            return
        payload, verdict = envelope.unwrap(raw)
        ent = None
        if verdict != "corrupt":
            ent = resultcache.parse_entry(payload)
            if ent is None:
                verdict = "corrupt"  # decodes but fails its rules_digest
        note_read("rescache", verdict)
        if ent is None:
            tally["corrupt"] += 1
            quarantine(self.store, key, raw, "rescache", move=True)
            self.store.delete(resultcache.sidecar_key_for(key))
            tally["quarantined"] += 1
            return
        # intact entry: re-derive a missing/corrupt LRU sidecar — the
        # repair a live leader can always make (and the heal for a kill
        # between the entry write and the sidecar write)
        side_key = resultcache.sidecar_key_for(key)
        sp, sv = envelope.unwrap(self.store.peek(side_key))
        healthy = False
        if sv != "corrupt" and sp is not None:
            try:
                healthy = isinstance(json.loads(sp), dict)
            except ValueError:
                healthy = False
        if not healthy:
            resultcache.write_sidecar(self.store, key, ent, len(payload))
            note_repaired("rescache")
            tally["repaired"] += 1
            log_event("integrity_sidecar_repaired", key=side_key)

    def _verify_rescache_sidecar(self, key: str, tally: dict) -> None:
        sp, sv = envelope.unwrap(self.store.peek(key))
        bad = sv == "corrupt"
        if not bad and sp is not None:
            try:
                bad = not isinstance(json.loads(sp), dict)
            except ValueError:
                bad = True
        if not bad:
            note_read("rescache", sv)
            return
        note_read("rescache", "corrupt")
        tally["corrupt"] += 1
        # the entry walk rebuilds it next time it passes; here we only
        # clear the damage (an orphan sidecar with no entry just dies)
        self.store.delete(key)
        from spark_fsm_tpu_torch.service import resultcache
        entry_key = resultcache.entry_key_for_sidecar(key)
        if self.store.peek(entry_key) is not None:
            self._verify_rescache_entry(entry_key, tally)

    def _verify_checkpoint(self, key: str, tally: dict) -> None:
        if key.startswith("fsm:frontier:results:"):
            for i, chunk in enumerate(self.store.lrange(key)):
                payload, verdict = open_value(chunk, "checkpoint")
                if verdict == "corrupt":
                    tally["corrupt"] += 1
                    # COPY only — StoreCheckpoint.load owns the heal
                    # (ltrim + meta rewrite under the single writer)
                    quarantine(self.store, f"{key}#{i}", chunk,
                               "checkpoint")
                    tally["quarantined"] += 1
            return
        raw = self.store.peek(key)
        payload, verdict = open_value(raw, "checkpoint")
        if verdict == "corrupt":
            tally["corrupt"] += 1
            quarantine(self.store, key, raw, "checkpoint")
            tally["quarantined"] += 1

    def stats(self) -> dict:
        prefix, _ = _WALK[self._pi]
        return {"scrub_every_s": self.scrub_every_s, "batch": self.batch,
                "passes": self.passes, "keys_scanned": self.keys_scanned,
                "cursor": f"{prefix}@{self._cursor}",
                "last_pass": self.last_pass}


# -- module wiring (the obsplane install pattern) -------------------------

_cfg = None  # IntegrityConfig from the boot config; None = defaults
_scrubber: Optional[Scrubber] = None


def configure(icfg) -> None:
    """Adopt the ``[integrity]`` boot config (config.set_config)."""
    global _cfg
    _cfg = icfg
    s = _scrubber
    if s is not None and icfg is not None:
        s.scrub_every_s = float(icfg.scrub_every_s)
        s.batch = int(icfg.scrub_batch)


def install(store) -> Optional[Scrubber]:
    """Install the process-wide scrubber over ``store`` (Miner init;
    last install wins, mirroring obsplane).  Returns None when the
    integrity plane is disabled — verify-on-read stays unconditional
    either way (it is a correctness property, not a feature flag)."""
    global _scrubber
    if _scrubber is not None:
        _scrubber.stop()
    if _cfg is not None and not _cfg.enabled:
        _scrubber = None
        return None
    _scrubber = Scrubber(
        store,
        scrub_every_s=_cfg.scrub_every_s if _cfg is not None else 60.0,
        batch=_cfg.scrub_batch if _cfg is not None else 256)
    return _scrubber


def uninstall() -> None:
    global _scrubber
    if _scrubber is not None:
        _scrubber.stop()
    _scrubber = None


def get() -> Optional[Scrubber]:
    return _scrubber


def tick() -> None:
    """Heartbeat-cadence hook (lease.LeaseManager.tick): one global
    read when nothing is installed."""
    s = _scrubber
    if s is not None:
        s.maybe_scrub()


def report(store=None) -> dict:
    """The ``/admin/integrity`` body: config, scrubber progress, counter
    totals, and a bounded listing of the quarantine keyspace."""
    s = _scrubber
    cfg = _cfg
    out = {
        "enabled": bool(cfg.enabled) if cfg is not None else True,
        "scrub_every_s": (float(cfg.scrub_every_s) if cfg is not None
                          else 60.0),
        "scrub_batch": int(cfg.scrub_batch) if cfg is not None else 256,
        "scrubber": s.stats() if s is not None else None,
        "counters": {
            "scans": _SCANS.total(),
            "verified": _VERIFIED.total(),
            "legacy": _LEGACY.total(),
            "corrupt": _CORRUPT.total(),
            "quarantined": _QUARANTINED.total(),
            "repaired": _REPAIRED.total(),
        },
        "quarantine": [],
    }
    st = store if store is not None else (s.store if s is not None else None)
    if st is not None:
        for qkey in itertools.islice(
                st.scan_iter(QUARANTINE_PREFIX), 100):
            row = {"key": qkey}
            payload, verdict = envelope.unwrap(st.peek(qkey))
            if verdict != "corrupt" and payload is not None:
                try:
                    rec = json.loads(payload)
                    if isinstance(rec, dict):
                        row.update({k: rec.get(k)
                                    for k in ("key", "surface", "ts")
                                    if rec.get(k) is not None})
                        row["quarantine_key"] = qkey
                except ValueError:
                    pass
            out["quarantine"].append(row)
    return out
