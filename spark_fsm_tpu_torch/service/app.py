"""HTTP front end — the reference's REST surface (SURVEY.md sec 1 L6).

Endpoints (POST, form- or JSON-encoded parameters):

  /train              — start a mining job; returns uid + 'started'.
                        Admission control: a full [service] queue_depth
                        sheds with 429 + Retry-After (cost-model
                        estimate of the queued work); resubmitting a
                        LIVE uid is 409; 'priority' (high/normal/low)
                        classes the queue; 'deadline_s' stamps an abort
                        budget spent by queue wait + mining
  /status/{uid}       — job lifecycle status (also /status?uid=...)
  /get/patterns       — mined patterns for uid (when finished)
  /get/rules          — mined rules, optional antecedent/consequent filter
  /get/prediction     — ranked next-item candidates from mined rules
                        (items=observed ids; best rule per candidate)
  /track/{topic}      — ingest one event for later TRACKED-source mining
  /stream/{topic}     — push an SPMF micro-batch into the topic's sliding
                        window; the window is re-mined and results served
                        under uid "stream:{topic}" (eval config #5)
  /register/{topic}   — register a field spec
  /index/{topic}      — alias of register (reference keeps both)
  /admin/ping         — liveness; /admin/algorithms — plugin listing;
  /admin/stats        — service metrics (job counters, backend, devices,
                        the mesh's ranks, per-cache counters, last
                        prewarm walls);
  /admin/config       — the active boot config;
  /admin/prewarm      — AOT-compile the declared workload envelope NOW
                        (params override the boot [prewarm] section);
  /admin/shapes       — enumerated vs runtime-recorded shape keys + drift;
  /admin/faults       — chaos lab: arm/disarm/list fault-injection sites
                        (REFUSED unless the boot config sets
                        ``fault_injection = true``);
  /admin/health       — per-subsystem recovery counters: armed faults,
                        I/O retry/backoff, dispatch watchdog, devcache
                        circuit breakers, consumer leaked threads;
  /metrics            — the unified registry in Prometheus text
                        exposition format (GET; utils/obs.REGISTRY —
                        point a scrape job here);
  /admin/trace/{job}  — flight-recorder span dump for a job uid (JSON;
                        requires [observability] trace = true).  In
                        cluster mode the response is the MERGED
                        cross-replica timeline: the durable trace spine
                        (fsm:trace:{uid}, written through the fenced
                        path) plus this replica's local ring, ordered
                        by wall time — after a failover the survivor
                        serves admission-on-A → adoption-on-B end to
                        end (service/obsplane.py);
  /admin/trace/last   — the most recently touched trace;
  /admin/cluster      — aggregated cluster view from the lease
                        heartbeats' piggybacked metric snapshots:
                        per-replica rows + totals (queued, in-flight,
                        free, leases held, sheds, lease churn) — same
                        answer from ANY replica;
  /admin/slo          — per-priority p50/p95/p99 of end-to-end job
                        latency (submit → durable result) with
                        queue-wait/execution split, over a sliding
                        window ([observability] slo_window_s) — the
                        service-side counterpart of bench_throughput;
  /admin/rescache     — result-reuse tier stats (service/resultcache.py):
                        hit/coalesce/dominated-serve counters, resident
                        cache bytes, in-flight coalescing registry;
  /admin/autoscale    — elastic control plane (service/autoscale.py):
                        leader, last evaluation signals, the published
                        desired-replica record and decision log;
                        {"enabled": false} when [autoscale] is off;
  /admin/integrity    — durable-state integrity plane (service/
                        integrity.py): verify-on-read counters per
                        surface, background scrubber stats, and the
                        current quarantine listing (fsm:quarantine:*)
                        — the bitrot runbook's one-stop read;
  /admin/usage        — resource attribution plane (service/usage.py):
                        per-tenant device-cost rollups (estimated +
                        measured device-seconds, launches, traffic
                        units, readback bytes), avoided-cost credits
                        from result-cache serves, top-N jobs by cost,
                        and the durable fsm:usage:{tenant} ledger rows;
                        {"enabled": false} when [usage] is off;
  /admin/quarantine   — crash-loop quarantine ledger (service/
                        meshguard.py): lists every fsm:quarantine:*
                        record (poison AND integrity surfaces);
                        ``action=release&uid=...`` deletes a poison
                        record so the uid may be resubmitted (404 when
                        no record exists) — the operator end of the
                        [cluster] max_adoptions POISON: terminal;
  /admin/drain        — drive the scale-down drain protocol NOW (stop
                        admitting → peers steal the queue → leases
                        released); ``exit=1`` also stops the server
                        once the drain completes — the forced-scale-
                        down lever the autoscale smoke uses;
  /admin/cancel/{uid} — abort a live (queued or running) train job at
                        its next safe point; 404 when no live job owns
                        the uid

At boot, main() runs the crash-restart recovery pass BEFORE accepting
traffic: journal intent records left by a dead incarnation are healed —
checkpointed jobs resubmitted (they resume from their persisted
frontier), everything else marked with a durable "interrupted by
restart" failure (service/actors.recover_orphans).

Runs on the stdlib ThreadingHTTPServer: the service layer is deliberately
dependency-free; heavy lifting happens in the engines (device) behind the
Miner worker thread.

Port of ``spark_fsm_tpu/service/app.py``: the same endpoints and
envelopes over the port's Master, plugins and engines.  The service runs
on one device, resolved once at boot (``make_server``/``serve_background``
``device=``, CLI ``--device``; default ``cuda``, raising without a card;
``cpu`` for tests) and handed to the plugins, the engine caches, the
stream miners and the predictor.  ``/admin/stats`` reports ``backend``
``"cuda"`` or ``"cpu"``, ``devices`` (``torch.cuda.device_count()``, or
on a mesh each rank's device) and ``mesh_devices`` (the mesh's ranks).
The boot prewarm (``service/prewarm.py``) runs on the service's device
before the server listens, after ``utils/jitcache.enable_compile_cache``
points the kernels' build directory; ``/admin/prewarm`` runs it on
request.  A mesh (``[engine] mesh_devices``, ``[distributed]``) is a
world of ranks, one process each (``service/launch.py``): rank 0 serves
everything here, and the other ranks bind no port and replay its mesh
calls (``service/meshcall.py``: the device plugins' mines, the
incremental streams' pushes, the prewarm).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from spark_fsm_tpu_torch import config as cfgmod
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.service import plugins, usage
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.service.actors import Master
from spark_fsm_tpu_torch.service.model import ServiceRequest
from spark_fsm_tpu_torch.service.store import RedisResultStore, ResultStore


def _parse_body(handler: BaseHTTPRequestHandler) -> dict:
    length = int(handler.headers.get("Content-Length") or 0)
    raw = handler.rfile.read(length) if length else b""
    ctype = (handler.headers.get("Content-Type") or "").split(";")[0].strip()
    if ctype == "application/json" and raw:
        obj = json.loads(raw.decode("utf-8"))
        if not isinstance(obj, dict):
            raise ValueError("JSON body must be an object")
        return {str(k): str(v) for k, v in obj.items()}
    return {k: v for k, v in parse_qsl(raw.decode("utf-8"))}


def _route(path: str) -> Tuple[str, str]:
    parts = [p for p in path.split("/") if p]
    head = parts[0] if parts else ""
    tail = "/".join(parts[1:]) if len(parts) > 1 else ""
    return head, tail


class FsmHandler(BaseHTTPRequestHandler):
    master: Master  # set by make_server

    def log_message(self, fmt: str, *args) -> None:  # quiet by default
        pass

    def _send(self, code: int, payload: str,
              content_type: str = "application/json",
              headers: Optional[dict] = None) -> None:
        body = payload.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _metrics(self) -> None:
        # Prometheus text exposition of the whole registry (metrics are
        # ALWAYS on — a scrape must work whether or not tracing is)
        try:
            self._send(200, obs.REGISTRY.render_prometheus(),
                       content_type="text/plain; version=0.0.4; "
                                    "charset=utf-8")
        except Exception as exc:
            self._send(500, json.dumps({"status": "failure",
                                        "error": str(exc)}))

    def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
        try:
            url = urlsplit(self.path)
            head, tail = _route(url.path)
            data = {k: v for k, v in parse_qsl(url.query)}
            data.update(_parse_body(self))
        except Exception as exc:
            self._send(400, json.dumps({"status": "failure", "error": str(exc)}))
            return

        if head == "metrics":
            self._metrics()
            return
        if head == "admin":
            self._admin(tail, data)
            return
        if head not in ("train", "status", "get", "track", "register",
                        "index", "stream", "predict"):
            self._send(404, json.dumps({"status": "failure",
                                        "error": f"unknown endpoint /{head}"}))
            return
        if head == "status" and tail and "uid" not in data:
            data["uid"] = tail  # /status/{uid}
        if head == "predict" and tail and "uid" not in data:
            data["uid"] = tail  # /predict/{uid}
        task = head if head in ("train", "status", "predict") \
            else f"{head}:{tail}"
        req = ServiceRequest(service="fsm", task=task, data=data)
        try:
            resp = self.master.handle(req)
        except Exception as exc:  # worker bug -> failure envelope, not a
            self._send(400, json.dumps({       # dropped connection
                "service": "fsm", "task": task,
                "data": {"uid": req.uid, "error": str(exc)},
                "status": "failure"}))
            return
        # overload/conflict mapping: the Master stamps the HTTP status it
        # wants (429 shed / 409 live-uid conflict) into the envelope —
        # popped here so the JSON body stays protocol-neutral; a 429
        # carries Retry-After from the cost-model estimate of queued work
        code = int(resp.data.pop("http_status", 200))
        headers = None
        if code == 429 and resp.data.get("retry_after_s"):
            headers = {"Retry-After": resp.data["retry_after_s"]}
        self._send(code, resp.to_json(), headers=headers)

    def do_GET(self) -> None:  # noqa: N802
        # GET convenience mirrors POST for read-only endpoints.
        url = urlsplit(self.path)
        head, _ = _route(url.path)
        if head in ("status", "get", "admin", "metrics"):
            self.do_POST()
        else:
            self._send(405, json.dumps({"status": "failure",
                                        "error": "use POST"}))

    def _admin(self, task: str, data: Optional[dict] = None) -> None:
        try:
            if task == "ping":
                self._send(200, json.dumps({"status": "up"}))
            elif task == "algorithms":
                self._send(200, json.dumps(sorted(plugins.ALGORITHMS)))
            elif task == "stats":
                self._send(200, json.dumps(service_stats(self.master)))
            elif task == "config":
                self._send(200, json.dumps(
                    dataclasses.asdict(cfgmod.get_config())))
            elif task == "prewarm":
                # warm the declared workload envelope NOW (request params
                # override the boot [prewarm] section field by field) —
                # synchronous: the caller wants the first-use costs paid
                # before traffic lands, and the report is per-key walls
                from spark_fsm_tpu_torch.service import meshcall, prewarm

                spec = prewarm.spec_from_params(
                    data or {}, cfgmod.get_config().prewarm)
                report = meshcall.prewarm(spec, cfgmod.engine_kwargs(
                    "pool_bytes", "node_batch", "pipeline_depth",
                    "chunk", "recompute_chunk"))
                self._send(200, json.dumps(report))
            elif task == "faults":
                # chaos lab: gated on the BOOT config (not a request
                # param) so a production deployment cannot be armed by
                # anyone who can reach the admin port
                from spark_fsm_tpu_torch.utils import faults

                if not cfgmod.get_config().fault_injection:
                    self._send(403, json.dumps({
                        "status": "failure",
                        "error": "fault injection disabled (set "
                                 "fault_injection = true in the boot "
                                 "config to open the chaos lab)"}))
                    return
                d = data or {}
                action = d.get("action", "list")
                if action == "arm":
                    kw = {}
                    for name, conv in (("nth", int), ("every", int),
                                       ("p", float), ("seed", int),
                                       ("times", int), ("delay_s", float)):
                        if d.get(name) not in (None, ""):
                            kw[name] = conv(d[name])
                    if d.get("exc"):
                        kw["exc"] = d["exc"]
                    if d.get("match"):
                        kw["match"] = d["match"]
                    faults.arm(d["site"], **kw)
                elif action == "disarm":
                    faults.disarm(d.get("site"))
                elif action != "list":
                    raise ValueError(f"unknown faults action {action!r} "
                                     "(arm/disarm/list)")
                self._send(200, json.dumps({
                    "armed": faults.armed(),
                    "counters": faults.counters()}))
            elif task == "health":
                self._send(200, json.dumps(health_report(self.master)))
            elif task == "cancel" or task.startswith("cancel/"):
                # /admin/cancel/{uid} (uid may contain slashes — keep the
                # whole tail; /admin/cancel?uid=... works too): flag a
                # live job for abort at its next safe point
                _, _, uid = task.partition("/")
                uid = uid or (data or {}).get("uid", "")
                if not uid:
                    self._send(400, json.dumps({
                        "status": "failure",
                        "error": "cancel needs a uid: /admin/cancel/{uid}"}))
                    return
                was = self.master.cancel(uid)
                if was is None:
                    self._send(404, json.dumps({
                        "status": "failure",
                        "error": f"no live (queued or running) job owns "
                                 f"uid {uid!r}"}))
                    return
                self._send(200, json.dumps(
                    {"status": "cancelling", "uid": uid, "was": was}))
            elif task == "trace" or task.startswith("trace/"):
                # read-only flight-recorder dumps: /admin/trace/{job_id}
                # (uid may itself contain slashes — keep the whole tail),
                # /admin/trace/last, bare /admin/trace lists trace ids
                from spark_fsm_tpu_torch.service import obsplane

                _, _, tid = task.partition("/")
                if not tid:
                    self._send(200, json.dumps({
                        "enabled": obs.tracing_enabled(),
                        "traces": obs.trace_ids(),
                        "last": obs.last_trace_id(),
                        **obs.recorder_stats()}))
                    return
                if tid == "last":
                    tid = obs.last_trace_id() or ""
                dump = obs.trace_dump(tid) if tid else None
                mgr = self.master.miner._lease
                if mgr is not None and tid:
                    # cluster mode: merge the durable spine with the
                    # local ring — after a failover THIS replica can
                    # serve the dead owner's spans too
                    p = obsplane.plane()
                    merged = obsplane.merged_timeline(
                        self.master.store, tid, dump,
                        replica_id=mgr.replica_id,
                        boot_id=p.boot_id if p is not None else None)
                    if merged is not None and (merged["spans"] or dump):
                        dump = merged
                if dump is None:
                    self._send(404, json.dumps({
                        "status": "failure",
                        "error": (f"no trace for {tid!r}"
                                  if obs.tracing_enabled() else
                                  "tracing disabled (set [observability] "
                                  "trace = true in the boot config)")}))
                    return
                self._send(200, json.dumps(dump))
            elif task == "cluster":
                # aggregated cluster view from the heartbeat records'
                # piggybacked snapshots (served from the heartbeat-
                # cadence peer cache — polling this cannot become a
                # store scan storm)
                mgr = self.master.miner._lease
                if mgr is None:
                    self._send(200, json.dumps({"enabled": False}))
                else:
                    self._send(200, json.dumps(
                        {"enabled": True, **mgr.cluster_view()}))
            elif task == "slo":
                from spark_fsm_tpu_torch.service import obsplane

                self._send(200, json.dumps(obsplane.slo_snapshot()))
            elif task == "rescache":
                # result-reuse tier stats (service/resultcache.py):
                # counters, resident entries/bytes, in-flight
                # coalescing registry — {"enabled": false} when the
                # boot config leaves the tier off
                rc = self.master.miner._rescache
                self._send(200, json.dumps(
                    {"enabled": False} if rc is None else rc.stats()))
            elif task == "autoscale":
                a = self.master.autoscaler
                self._send(200, json.dumps(
                    {"enabled": False} if a is None else a.stats()))
            elif task == "integrity":
                # durable-state integrity plane (service/integrity.py):
                # verify-on-read counters, scrubber state, quarantine
                # listing — the bitrot runbook's one-stop read
                from spark_fsm_tpu_torch.service import integrity

                self._send(200, json.dumps(
                    integrity.report(self.master.store)))
            elif task == "usage":
                # resource attribution / usage metering plane
                # (service/usage.py): per-tenant device-cost rollups
                # (est + measured seconds, launches, traffic units,
                # readback bytes), avoided-cost credits, top-N jobs,
                # durable-ledger rows — flushes pending settlements
                # first so the response is read-your-writes
                from spark_fsm_tpu_torch.service import usage

                self._send(200, json.dumps(
                    usage.report(self.master.store)))
            elif task == "quarantine":
                # crash-loop quarantine ledger (service/meshguard.py):
                # list every preserved fsm:quarantine:* record, or
                # release one (action=release&uid=...) so a poisoned
                # uid may be resubmitted — the operator end of the
                # [cluster] max_adoptions POISON: terminal
                from spark_fsm_tpu_torch.service import meshguard

                d = data or {}
                action = d.get("action", "list")
                if action == "release":
                    uid = d.get("uid", "")
                    if not uid:
                        self._send(400, json.dumps({
                            "status": "failure",
                            "error": "release needs a uid: /admin/"
                                     "quarantine?action=release&uid=..."}))
                        return
                    if not meshguard.quarantine_release(
                            self.master.store, uid):
                        self._send(404, json.dumps({
                            "status": "failure",
                            "error": f"no quarantine record for uid "
                                     f"{uid!r}"}))
                        return
                    self._send(200, json.dumps(
                        {"status": "released", "uid": uid}))
                    return
                if action != "list":
                    raise ValueError(f"unknown quarantine action "
                                     f"{action!r} (list/release)")
                g = meshguard.get()
                self._send(200, json.dumps({
                    "records": meshguard.quarantine_list(
                        self.master.store),
                    "mesh": None if g is None else g.stats()}))
            elif task == "predictor":
                # prediction serving plane (service/predictor.py):
                # request/wave counters, resident artifact inventory
                # (digest + geometry + bytes per entry — the audit
                # surface for cache keys), live [predict] config
                self._send(200, json.dumps(self.master.predictor.stats()))
            elif task == "drain":
                # forced scale-down (operator lever / autoscale smoke):
                # run the drain protocol on a background thread and
                # return immediately — poll /admin/autoscale (or the
                # heartbeat's draining flag via /admin/cluster) for
                # progress.  exit=1 stops the HTTP server after the
                # drain, handing control to main()'s teardown.
                miner = self.master.miner
                if miner.draining:
                    self._send(200, json.dumps(
                        {"status": "already-draining"}))
                    return
                want_exit = (data or {}).get("exit", "0").lower() \
                    not in ("", "0", "false", "no", "off")
                server = self.server

                def _drain():
                    miner.drain(reason="/admin/drain")
                    if want_exit:
                        threading.Thread(target=server.shutdown,
                                         daemon=True).start()

                threading.Thread(target=_drain, daemon=True,
                                 name="fsm-admin-drain").start()
                self._send(200, json.dumps(
                    {"status": "draining",
                     "queued": miner.queue_size(),
                     "running": miner.running_count(),
                     "exit": want_exit}))
            elif task == "shapes":
                # enumerated (last prewarm) vs runtime-recorded shape
                # keys; "drift" lists observed geometries prewarm missed
                from spark_fsm_tpu_torch.service import prewarm
                from spark_fsm_tpu_torch.utils import shapes as shapereg

                report = prewarm.last_report()
                enumerated = report["enumerated"] if report else []
                self._send(200, json.dumps({
                    "enumerated": enumerated,
                    "recorded": shapereg.recorded(),
                    "drift": (shapereg.drift(enumerated)
                              if report else None),
                }))
            else:
                self._send(404, json.dumps(
                    {"status": "failure",
                     "error": f"unknown admin task {task!r}"}))
        except Exception as exc:  # e.g. store backend down: JSON envelope,
            self._send(500, json.dumps({       # not a dropped connection
                "status": "failure", "error": str(exc)}))


def _fusion_stats() -> dict:
    """The /admin/stats ``fusion`` block: enabled flag + window policy,
    and the broker's counters once one exists (it is lazily built on
    the first enabled configure)."""
    from spark_fsm_tpu_torch.service import fusion

    cfg = cfgmod.get_config().fusion
    out = {"enabled": fusion.eval_enabled(),
           "window_ms": cfg.window_ms, "max_jobs": cfg.max_jobs,
           "max_width": cfg.max_width,
           "dispatch_workers": cfg.dispatch_workers}
    b = fusion.broker()
    if b is not None:
        out.update(b.stats)
        out["pending"] = b.pending()
    return out


def service_stats(master: Master) -> dict:
    """Service-wide metrics for /admin/stats (SURVEY.md sec 5 metrics row):
    job counters from the store plus the device/backend the engines see."""
    import torch

    store = master.store
    counters = {
        name: int(store.get(f"fsm:metric:{name}") or 0)
        for name in ("jobs_submitted", "jobs_finished", "jobs_failed",
                     "stream_pushes", "stream_failures")
    }
    from spark_fsm_tpu_torch.service import meshcall, prewarm
    from spark_fsm_tpu_torch.service.devcache import (
        cspade_engine_cache, spade_engine_cache, tsr_engine_cache)
    from spark_fsm_tpu_torch.utils import shapes as shapereg

    report = prewarm.last_report()

    return {
        "jobs": counters,
        # admission-control view: live queue occupancy vs its bound
        # (canonical series: fsm_service_queue_depth / fsm_service_
        # sheds_total in the metrics block below)
        "admission": {"queued": master.miner.queue_size(),
                      "queue_depth": master.miner.queue_depth},
        # multi-replica lease layer (service/lease.py): replica id, held
        # leases, live peers (None = single-replica deployment)
        "cluster": (None if master.miner._lease is None
                    else master.miner._lease.stats()),
        "backend": plugins.service_device().type,
        # on a mesh: each rank's device, in rank order
        "devices": (meshcall.devices() if meshcall.active()
                    else torch.cuda.device_count()),
        "mesh_devices": cfgmod.mesh_size(),
        "algorithms": sorted(plugins.ALGORITHMS),
        # repeat-/train device-store reuse (service/devcache.py); one
        # counter block per cache so a cSPADE hit is visible as such
        "store_cache": dict(spade_engine_cache.stats),
        "cspade_cache": dict(cspade_engine_cache.stats),
        "tsr_cache": dict(tsr_engine_cache.stats),
        # cross-job launch fusion (service/fusion.py): broker counters
        # plus the live window policy (canonical series: fsm_fusion_*)
        "fusion": _fusion_stats(),
        # result-reuse tier (service/resultcache.py): hit/coalesce/
        # dominated-serve counters + resident bytes (canonical series:
        # fsm_rescache_*); None when [rescache] is off
        "rescache": (None if master.miner._rescache is None
                     else master.miner._rescache.stats()),
        # weighted-fair multi-tenant admission (service/fairness.py):
        # tenant vocabulary, weights, live per-tenant queue depths
        # (canonical series: fsm_tenant_*); None when [fairness] is off
        "fairness": (None if master.miner._fair is None
                     else {**master.miner._fair.stats(),
                           "queued": master.miner.tenant_depths()}),
        # elastic control plane (service/autoscale.py): leader, last
        # evaluation, desired record (canonical series:
        # fsm_autoscale_*); None when [autoscale] is off
        "autoscale": (None if master.autoscaler is None
                      else master.autoscaler.stats()),
        # prediction serving plane (service/predictor.py): request/wave
        # counters + artifact-cache inventory (canonical series:
        # fsm_predict_*)
        "predictor": master.predictor.stats(),
        # store-outage guard (service/storeguard.py): health state +
        # spool/stall depth (canonical series: fsm_store_health_state /
        # fsm_storeguard_*); None when [storeguard] is off
        "storeguard": (None if master.miner._guard is None
                       else master.miner._guard.stats()),
        # resource attribution / usage metering plane (service/
        # usage.py): live jobs, deposits/settles, flush counters
        # (canonical series: fsm_usage_*); None when [usage] is off —
        # the per-tenant rollup tables live on /admin/usage
        "usage": (usage.stats() if usage.get() is not None else None),
        # warm-path observability: null until the port's engines record
        # distinct device geometries seen, plus the last prewarm's
        # per-key walls (if any ran)
        "shape_keys_recorded": len(shapereg.recorded()),
        "prewarm": (None if report is None else
                    {"keys": report["keys"],
                     "total_wall_s": report["total_wall_s"],
                     "ts": report["ts"]}),
        # the canonical registry view (utils/obs.REGISTRY — what
        # GET /metrics exposes): the blocks above are documented ALIASES
        # of these fsm_* names for one release (docs/OPERATIONS.md
        # tables the mapping)
        "metrics": obs.REGISTRY.snapshot(),
    }


def _integrity_health() -> dict:
    """Compact /admin/health integrity block: config + counters, no
    store walk (the quarantine listing lives on /admin/integrity)."""
    from spark_fsm_tpu_torch.service import integrity

    try:
        return integrity.report()
    except Exception as exc:
        return {"error": str(exc)}


def health_report(master: Master) -> dict:
    """Per-subsystem recovery counters for ``/admin/health`` — the
    runbook's one-stop read when a deployment misbehaves: what is armed
    (should be NOTHING outside a chaos run), what retried, what timed
    out, which breakers are open, and which stop paths leaked threads."""
    from spark_fsm_tpu_torch.service.devcache import (
        cspade_engine_cache, spade_engine_cache, tsr_engine_cache)
    from spark_fsm_tpu_torch.streaming.consumer import consumer_health
    from spark_fsm_tpu_torch.utils import faults, watchdog
    from spark_fsm_tpu_torch.utils.retry import retry_counters

    store = master.store
    jobs = {}
    for name in ("jobs_submitted", "jobs_finished", "jobs_failed",
                 "jobs_retried", "stream_pushes", "stream_failures"):
        try:
            jobs[name] = int(store.get(f"fsm:metric:{name}") or 0)
        except Exception:
            # health must stay readable DURING a chaos drill: an armed
            # store.get fault (or a down store) blanks the counter, it
            # does not take down the one endpoint diagnosing it
            jobs[name] = None
    from spark_fsm_tpu_torch.utils import jobctl

    return {
        "faults": {
            "enabled": cfgmod.get_config().fault_injection,
            "armed": faults.armed(),
            "counters": faults.counters(),
        },
        "admission": {
            "queued": master.miner.queue_size(),
            "queue_depth": master.miner.queue_depth,
            "live_jobs": jobctl.live_count(),
        },
        "cluster": (None if master.miner._lease is None
                    else master.miner._lease.stats()),
        # store-outage guard (service/storeguard.py): health state,
        # spool depth, stalled jobs; None when [storeguard] is off
        "storeguard": (None if master.miner._guard is None
                       else master.miner._guard.stats()),
        "retry": retry_counters(),
        "watchdog": {**watchdog.stats(),
                     "slack": watchdog.configured_slack()},
        "breakers": {
            "store_cache": spade_engine_cache.breaker.snapshot(),
            "cspade_cache": cspade_engine_cache.breaker.snapshot(),
            "tsr_cache": tsr_engine_cache.breaker.snapshot(),
        },
        "consumers": consumer_health(),
        # durable-state integrity plane (service/integrity.py): verify-
        # on-read + scrub counters (no quarantine listing — that walk
        # belongs to /admin/integrity, health must stay scan-free)
        "integrity": _integrity_health(),
        "jobs": jobs,
        "tracing": {"enabled": obs.tracing_enabled(),
                    **obs.recorder_stats()},
        # canonical fsm_* registry names; the blocks above stay as
        # aliases for one release (docs/OPERATIONS.md "Metric names").
        # The jobs counters are deliberately read twice per response
        # (direct from THIS master's store above, via the registered
        # collector here): the collector is process-global and may be
        # bound to another master's store in multi-master test setups,
        # so the alias block must not be derived from it — six extra
        # guard-free peeks per health poll is the price of that
        # correctness.
        "metrics": obs.REGISTRY.snapshot(),
    }


def make_store(cfg: Optional[cfgmod.Config] = None) -> ResultStore:
    cfg = cfg if cfg is not None else cfgmod.get_config()
    if cfg.store.backend == "redis":
        return RedisResultStore(cfg.store.host, cfg.store.port,
                                timeout_s=cfg.store.timeout_s)
    return ResultStore()


def make_server(port: int = 0, host: str = "127.0.0.1",
                master: Optional[Master] = None,
                miner_workers: int = 1,
                device: DeviceLike = None) -> ThreadingHTTPServer:
    """The HTTP server over a Master (a fresh one unless given).  Resolves
    the service's ``device`` first (``None`` = CUDA, raising without a
    card) and hands it to the plugins, engine caches, stream miners and
    predictor."""
    plugins.set_device(device)
    if master is not None:
        m = master
    else:
        m = Master(store=make_store(), miner_workers=miner_workers)
    handler = type("BoundFsmHandler", (FsmHandler,), {"master": m})
    server = ThreadingHTTPServer((host, port), handler)
    server.master = m  # type: ignore[attr-defined]
    return server


def serve_background(port: int = 0,
                     device: DeviceLike = None) -> ThreadingHTTPServer:
    """Start a server on a daemon thread; returns it (``server_port`` set).
    ``device``: as :func:`make_server`."""
    server = make_server(port, device=device)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="fsm-http").start()
    return server


def main() -> None:
    parser = argparse.ArgumentParser(description="spark_fsm_tpu_torch service")
    parser.add_argument("--config", default=None,
                        help="boot config file (.toml or .json); flags "
                             "below override its [service] section")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--host", default=None)
    parser.add_argument("--miner-workers", type=int, default=None)
    parser.add_argument("--remote-port", type=int, default=None,
                        help="actor-protocol TCP port (0 disables)")
    parser.add_argument("--device", default=None,
                        help="the device the engines run on: cuda "
                             "(default; fails without a card) or cpu")
    args = parser.parse_args()
    cfg = cfgmod.load_config(args.config) if args.config else cfgmod.Config()
    if args.port is not None:
        cfg.service.port = args.port
    if args.host is not None:
        cfg.service.host = args.host
    if args.miner_workers is not None:
        cfg.service.miner_workers = args.miner_workers
    if args.remote_port is not None:
        cfg.service.remote_port = args.remote_port
    cfgmod.set_config(cfg)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from spark_fsm_tpu_torch.utils.jitcache import enable_compile_cache

    enable_compile_cache()  # the kernels' build directory, kept on disk
    from spark_fsm_tpu_torch.service import launch

    world = launch.plan(cfg, args.device)
    if world is None:
        _serve(cfg, plugins.set_device(args.device))
    elif world.rank != 0:
        # a [distributed] host's rank other than 0: no port, no Master
        launch.follow(cfg, world, world.rank)
    else:
        end = launch.lead(cfg, world)
        try:
            print(f"mesh: rank 0 of a world of {world.size} "
                  f"({world.backend})", flush=True)
            _serve(cfg, plugins.service_device())
        finally:
            end()


def _serve(cfg: cfgmod.Config, device) -> None:
    """The boot on this process's device, then the serve loop until a
    signal: what ``main`` runs on a one-process service and on rank 0."""
    if cfg.prewarm.enabled:
        # boot prewarm on the service's device BEFORE accepting traffic:
        # kernel builds, library loads, first launches and the allocator's
        # pools at the declared envelope.  Synchronous by design — a
        # not-yet-listening service is the honest signal that the
        # deployment is still paying its first-use bill
        from spark_fsm_tpu_torch.service import meshcall, prewarm

        spec = prewarm.spec_from_config(cfg.prewarm)
        if spec is None:
            print("prewarm enabled but the [prewarm] envelope is empty "
                  "(set sequences/items or stream_batch_sequences)",
                  flush=True)
        else:
            report = meshcall.prewarm(spec, cfgmod.engine_kwargs(
                "pool_bytes", "node_batch", "pipeline_depth",
                "chunk", "recompute_chunk"))
            print(f"prewarm: {len(report['keys'])} shape keys in "
                  f"{report['total_wall_s']}s", flush=True)
    server = make_server(cfg.service.port, cfg.service.host,
                         miner_workers=cfg.service.miner_workers,
                         device=device)
    # crash-restart recovery BEFORE accepting traffic: journal intents
    # from a dead incarnation are resubmitted (checkpointed — they
    # resume from the persisted frontier) or failed durably, so no
    # client polls a forever-pending uid from before the crash
    from spark_fsm_tpu_torch.service.actors import recover_orphans

    report = recover_orphans(server.master)  # type: ignore[attr-defined]
    if any(report.values()):
        print(f"restart recovery: {len(report['resumed'])} resumed, "
              f"{len(report['failed'])} failed durably, "
              f"{len(report['cleared'])} journal entries cleared, "
              f"{len(report.get('quarantined', ()))} quarantined",
              flush=True)
    scaler = server.master.autoscaler  # type: ignore[attr-defined]
    if scaler is not None:
        # a drain directive (scale-down victim) exits this process once
        # the queue has been stolen/adopted: stopping the serve loop
        # hands control to the teardown below, same as SIGTERM
        scaler.on_drained = lambda report: threading.Thread(
            target=server.shutdown, daemon=True).start()
        print(f"autoscale controller on (bounds "
              f"[{scaler.min_replicas}, {scaler.max_replicas}], "
              f"cadence {round(scaler.decide_every_s, 3)}s)", flush=True)
    guard = server.master.miner._guard  # type: ignore[attr-defined]
    if guard is not None:
        print(f"storeguard on (probe {guard.probe_every_s}s, "
              f"spool {guard.spool_max_entries}/job, "
              f"stall_max {guard.stall_max_s}s, "
              f"ephemeral_admission "
              f"{'on' if guard.ephemeral_admission else 'off'})",
              flush=True)
    mgr = server.master.miner._lease  # type: ignore[attr-defined]
    if mgr is not None:
        # multi-replica mode: peers identify this instance by replica id
        # in lease/heartbeat keys and /admin/stats
        print(f"cluster replica {mgr.replica_id} "
              f"(lease ttl {mgr.lease_ttl_s}s, "
              f"heartbeat {round(mgr.heartbeat_s, 3)}s, "
              f"steal {'on' if mgr.steal_enabled else 'off'})", flush=True)
    from spark_fsm_tpu_torch.service import integrity

    scr = integrity.get()
    if scr is not None and cfg.integrity.scrub_every_s > 0:
        if mgr is None:
            # solo boot: no heartbeat tick to ride — own daemon thread
            scr.start()
        print(f"integrity scrubber on "
              f"(every {round(cfg.integrity.scrub_every_s, 3)}s, "
              f"batch {cfg.integrity.scrub_batch}, "
              f"{'heartbeat' if mgr is not None else 'thread'} cadence)",
              flush=True)
    print(f"spark_fsm_tpu_torch service on http://{cfg.service.host}:"
          f"{server.server_port}", flush=True)
    remote = None
    if cfg.service.remote_port:
        # Second protocol entry (the reference's Akka-remote analog):
        # actor-vocabulary JSON lines over TCP, same Master.
        from spark_fsm_tpu_torch.service.remote import serve_remote_background

        remote = serve_remote_background(
            server.master, cfg.service.host,  # type: ignore[attr-defined]
            cfg.service.remote_port)
        print(f"spark_fsm_tpu_torch actor protocol on {cfg.service.host}:"
              f"{remote.port}", flush=True)

    def _term(signum, frame):
        # SIGTERM (k8s / systemd stop) drains exactly like Ctrl-C: the
        # serve loop exits, miners finish their CURRENT job and reach a
        # durable status, both protocol servers close — instead of the
        # default hard kill mid-mine.
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # cleanup can block on the miner drain (up to its join timeout):
        # a second TERM/Ctrl-C must not raise inside this block and skip
        # the remaining teardown
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        # close the listening sockets BEFORE draining so clients get
        # connection-refused instead of hanging in the accept backlog of
        # a server whose loop has already exited
        server.server_close()
        if remote is not None:
            remote.shutdown()
            remote.server_close()
        server.master.shutdown()  # type: ignore[attr-defined]
        print("spark_fsm_tpu_torch service stopped", flush=True)


if __name__ == "__main__":
    main()
