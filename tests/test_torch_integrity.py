"""The integrity plane on the port (``spark_fsm_tpu_torch/service/
integrity.py``, ``utils/envelope.py`` and the ``store.corrupt`` hooks of
``service/store.py``), against the reference's ``tests/test_integrity.py``.

Each scenario is one test parametrised over the two packages
(``_torch_cluster_rig.PKGS``): it runs once with each package's modules
over the same damaged bytes (the reference's envelope makes them, so
both packages read byte-identical input) and returns a record: the
verdicts, the quarantine records and their surfaces, the
``fsm_integrity_*`` counters it moved and the healed pattern text.  The
port's record must equal the reference's.  Envelopes and checkpoints
written by one package verify and load in the other.
"""

import importlib
import json
import types

import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, Twins


def _ns(name):
    P = PKGS[name]
    root = "spark_fsm_tpu_torch" if name == "port" else "spark_fsm_tpu"
    ns = types.SimpleNamespace(**vars(P))
    for attr, mod in (("integrity", "service.integrity"),
                      ("obsplane", "service.obsplane"),
                      ("resultcache", "service.resultcache"),
                      ("rule_trie", "ops.rule_trie")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


C = {name: _ns(name) for name in NAMES}
# the bytes every scenario damages come from one envelope
WRAP = C["reference"].envelope.wrap


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


# the port's record must equal the reference's, with the integrity
# counters each scenario moved
_held = Twins(C, families=("fsm_integrity_",)).held


def _quarantined(P, store):
    """Every quarantine record: key -> (damaged key, surface, bytes)."""
    out = {}
    for qkey in sorted(store.scan_iter("fsm:quarantine:")):
        payload, verdict = P.envelope.unwrap(store.peek(qkey))
        assert verdict == "ok", qkey
        rec = json.loads(payload)
        out[qkey] = (rec["key"], rec["surface"], rec["value"])
    return out


def _flip(value: str, at: int) -> str:
    return value[:at] + chr(ord(value[at]) ^ 0x01) + value[at + 1:]


# ---------------------------------------------------------------- envelope


def _envelope_scenario(P):
    E = P.envelope
    payload = json.dumps({"k": [1, 2, 3], "täxt": "ünïcode ✓"})
    w = WRAP(payload)
    verdicts = [E.is_enveloped(w), E.unwrap(w), E.unwrap(payload),
                E.unwrap(""), E.unwrap(None),
                E.unwrap(_flip(w, len(w) - 3)), E.unwrap(_flip(w, 8)),
                E.unwrap(w[: len(w) // 2]), E.unwrap("FSME9" + w[5:]),
                E.unwrap("FSME1:nonsense")]
    assert verdicts == [True, (payload, "ok"), (payload, "legacy"),
                        ("", "legacy"), (None, "missing")] + [
        (None, "corrupt")] * 5
    return {"verdicts": verdicts}


@pytest.mark.parametrize("pkg", NAMES)
def test_envelope_roundtrip_and_verdicts(pkg):
    _held(pkg, _envelope_scenario)


# ------------------------------------------------- checkpoint degradation


def _meta_scenario(P):
    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, "cm-1", every_s=0.0)
    ckpt.save({"version": 1, "stack": [{"x": 1}], "results_done": 0,
               "results": [[[[1]], 3]]})
    ckpt.save({"version": 1, "stack": [], "results_done": 1,
               "results": [[[[2]], 2]]})
    meta_key = "fsm:frontier:cm-1"
    store.set(meta_key, _flip(store.get(meta_key), 80))
    return {"load": ckpt.load(), "meta": store.peek(meta_key),
            "chunks": store.llen("fsm:frontier:results:cm-1"),
            "quarantine": _quarantined(P, store)}


@pytest.mark.parametrize("pkg", NAMES)
def test_corrupt_checkpoint_meta_restarts_fresh_loudly(pkg):
    rec = _held(pkg, _meta_scenario)
    assert rec["load"] is None and rec["meta"] is None
    assert rec["chunks"] == 0
    assert list(rec["quarantine"]) == ["fsm:quarantine:frontier:cm-1"]


def _legacy_scenario(P):
    store = P.store.ResultStore()
    store.set("fsm:frontier:leg-1", json.dumps(
        {"version": 1, "stack": [], "results_total": 2,
         "results_inline": [[[[1]], 3]]}))
    store.rpush("fsm:frontier:results:leg-1", json.dumps([[[[2]], 2]]))
    ckpt = P.actors.StoreCheckpoint(store, "leg-1", every_s=0.0)
    state = ckpt.load()
    loaded = state["results"]
    ckpt.save({**state, "results_done": 2, "results": [[[[3]], 1]]})
    return {"loaded": loaded,
            "upgraded": (P.envelope.is_enveloped(
                store.get("fsm:frontier:leg-1")), P.envelope.is_enveloped(
                store.lrange("fsm:frontier:results:leg-1")[-1])),
            "resumed": ckpt.load()["results"]}


@pytest.mark.parametrize("pkg", NAMES)
def test_legacy_checkpoint_loads_and_upgrades_on_next_save(pkg):
    rec = _held(pkg, _legacy_scenario)
    assert rec["loaded"] == [[[[1]], 3], [[[2]], 2]]
    assert rec["upgraded"] == (True, True)
    assert rec["resumed"] == [[[[1]], 3], [[[2]], 2], [[[3]], 1]]


# --------------------------------------------------- journal degradation


def _poison_journal_scenario(P):
    store = P.store.ResultStore()
    store.set("fsm:journal:poison-1",
              _flip(WRAP(json.dumps({"incarnation": "dead"})), 80))
    store.journal_set("zz-done", json.dumps({"incarnation": "dead"}))
    store.add_status("zz-done", "finished")
    master = P.actors.Master(store=store)
    try:
        report = P.actors.recover_orphans(master)
    finally:
        master.shutdown()
    return {"report": {k: report[k] for k in ("quarantined", "cleared",
                                               "resumed", "failed")},
            "journal": store.peek("fsm:journal:poison-1"),
            "quarantine": _quarantined(P, store)}


@pytest.mark.parametrize("pkg", NAMES)
def test_recover_orphans_quarantines_poison_journal_and_continues(pkg):
    rec = _held(pkg, _poison_journal_scenario)
    assert rec["report"]["quarantined"] == ["poison-1"]
    assert rec["report"]["cleared"] == ["zz-done"]
    assert rec["journal"] is None
    assert rec["quarantine"]["fsm:quarantine:poison-1"][1] == "journal"


def _journal_get_scenario(P):
    store = P.store.ResultStore()
    store.journal_set("u1", json.dumps({"replica": "a"}))
    clean = json.loads(store.journal_get("u1"))
    store.set("fsm:journal:u1", _flip(store.get("fsm:journal:u1"), 75))
    raw = store.journal_get("u1")
    with pytest.raises(ValueError):
        json.loads(raw)
    return {"clean": clean, "raw": raw, "absent": store.journal_get("nope")}


@pytest.mark.parametrize("pkg", NAMES)
def test_journal_get_returns_payload_and_raw_corruption(pkg):
    rec = _held(pkg, _journal_get_scenario)
    assert rec["clean"] == {"replica": "a"} and rec["absent"] is None


# ----------------------------------------------------- spine degradation


def _spine_scenario(P):
    store = P.store.ResultStore()
    good = WRAP(json.dumps(
        {"replica": "r1", "boot": "b1", "token": 1, "ts": 2.0,
         "spans": [{"span_id": 1, "site": "job", "ts": 2.0}]}))
    store.spine_append("u-spine", good)
    store.spine_append("u-spine", _flip(good, len(good) - 5))
    store.spine_append("u-spine", "not json at all {{")
    merged = P.obsplane.merged_timeline(store, "u-spine")
    return {"corrupt": merged["corrupt_chunks"],
            "chunks": merged["spine_chunks"],
            "spans": [s["span_id"] for s in merged["spans"]],
            "last": P.obsplane.last_activity_ts(store, "u-spine")}


@pytest.mark.parametrize("pkg", NAMES)
def test_merged_timeline_skips_and_counts_corrupt_chunks(pkg):
    assert {k: v for k, v in _held(pkg, _spine_scenario).items()
            if k != "moved"} == {"corrupt": 2, "chunks": 1, "spans": [1],
                                    "last": 2.0}


# ---------------------------------------------------------------- scrubber


def _entry(P, payload_obj) -> str:
    payload = json.dumps(payload_obj)
    return json.dumps({"algo": "SPADE_TPU", "kind": "patterns",
                       "params": {}, "n_sequences": 5, "uid": "u-e",
                       "digest": P.rule_trie.rules_digest(payload),
                       "ts": 1.0, "payload": payload})


def _scrub_scenario(P):
    RC = P.resultcache
    store = P.store.ResultStore()
    store.set("fsm:journal:rot-j", _flip(WRAP("{}"), 72))
    ekey = RC.entry_key("fp-ok", "SPADE_TPU")
    store.set(ekey, WRAP(_entry(P, [[[[1]], 4]])))
    bkey = RC.entry_key("fp-bad", "SPADE_TPU")
    wrapped = WRAP(_entry(P, [[[[2]], 4]]))
    store.set(bkey, wrapped[: len(wrapped) - 10])
    RC.write_sidecar(store, bkey, {"ts": 1.0}, 10)
    scr = P.integrity.Scrubber(store, scrub_every_s=0.0, batch=256)
    tally = scr.scrub()
    side = P.envelope.unwrap(store.peek(RC.sidecar_key_for(ekey)))[0]
    q0 = P.integrity._QUARANTINED.total()
    again = scr.scrub()
    return {"tally": {k: tally[k] for k in ("corrupt", "quarantined",
                                             "repaired")},
            "journal": store.peek("fsm:journal:rot-j"),
            "bad": (store.peek(bkey), store.peek(RC.sidecar_key_for(bkey))),
            "sidecar_ts": json.loads(side)["ts"],
            "requarantined": P.integrity._QUARANTINED.total() - q0,
            "again": {k: again[k] for k in ("quarantined", "repaired")},
            "quarantine": _quarantined(P, store)}


@pytest.mark.parametrize("pkg", NAMES)
def test_scrubber_quarantines_at_rest_and_repairs_sidecars(pkg):
    rec = _held(pkg, _scrub_scenario)
    assert rec["tally"]["corrupt"] >= 2 and rec["tally"]["quarantined"] >= 2
    assert rec["tally"]["repaired"] == 1
    assert rec["journal"] is None and rec["bad"] == (None, None)
    assert rec["sidecar_ts"] == 1.0 and rec["requarantined"] == 0
    assert {v[1] for v in rec["quarantine"].values()} >= {"journal"}


def _batch_scenario(P):
    store = P.store.ResultStore()
    for i in range(10):
        store.set(f"fsm:journal:u{i:02d}", _flip(WRAP("{}"), 72))
    scr = P.integrity.Scrubber(store, scrub_every_s=0.0, batch=4)
    sizes = []
    for _ in range(12):
        sizes.append(scr.scrub()["keys"])
        if not store.scan_keys("fsm:journal:", "0", 64)[1]:
            break
    return {"sizes": sizes,
            "left": store.scan_keys("fsm:journal:", "0", 64)[1],
            "quarantined": len(list(store.scan_iter("fsm:quarantine:"))),
            "passes": scr.passes}


@pytest.mark.parametrize("pkg", NAMES)
def test_scrubber_is_batch_bounded_with_cross_pass_cursor(pkg):
    rec = _held(pkg, _batch_scenario)
    assert max(rec["sizes"]) <= 4 and rec["left"] == []
    assert rec["quarantined"] == 10 and rec["passes"] >= 3


def _report_scenario(P):
    store = P.store.ResultStore()
    cfg = P.config.parse_config({"integrity": {"scrub_every_s": 7.5,
                                               "scrub_batch": 32}})
    P.integrity.configure(cfg.integrity)
    try:
        scr = P.integrity.install(store)
        assert scr is not None
        P.integrity.quarantine(store, "fsm:journal:qq", "damaged-bytes",
                               "journal", move=True)
        rep = P.integrity.report(store)
        return {"scrubber": (scr.scrub_every_s, scr.batch),
                "head": (rep["enabled"], rep["scrub_every_s"],
                         rep["scrub_batch"]),
                "rows": [{k: v for k, v in r.items() if k != "ts"}
                         for r in rep["quarantine"]],
                "counter_names": sorted(rep["counters"])}
    finally:
        P.integrity.uninstall()
        P.integrity.configure(P.config.Config().integrity)


@pytest.mark.parametrize("pkg", NAMES)
def test_report_lists_quarantine_and_counters(pkg):
    rec = _held(pkg, _report_scenario)
    assert rec["scrubber"] == (7.5, 32) and rec["head"] == (True, 7.5, 32)
    assert rec["rows"] == [{"key": "fsm:journal:qq", "surface": "journal",
                            "quarantine_key": "fsm:quarantine:qq"}]
    assert rec["counter_names"] == ["corrupt", "legacy", "quarantined",
                                    "repaired", "scans", "verified"]


def _disabled_scenario(P):
    store = P.store.ResultStore()
    cfg = P.config.parse_config({"integrity": {"enabled": False}})
    P.integrity.configure(cfg.integrity)
    try:
        installed = P.integrity.install(store)
        P.integrity.tick()
        enabled = P.integrity.report(store)["enabled"]
        store.set("fsm:journal:u9", _flip(WRAP("{}"), 72))
        raw = store.journal_get("u9")
        with pytest.raises(ValueError):
            json.loads(raw)
        return {"installed": installed, "enabled": enabled, "raw": raw}
    finally:
        P.integrity.uninstall()
        P.integrity.configure(P.config.Config().integrity)


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_plane_installs_nothing_but_still_verifies(pkg):
    rec = _held(pkg, _disabled_scenario)
    assert rec["installed"] is None and rec["enabled"] is False


@pytest.mark.parametrize("pkg", NAMES)
def test_integrity_config_parse_and_validation(pkg):
    P = C[pkg]
    cfg = P.config.parse_config({})
    assert cfg.integrity.enabled is True
    assert cfg.integrity.scrub_every_s == 60.0
    assert cfg.integrity.scrub_batch == 256
    with pytest.raises(ValueError):
        P.config.parse_config({"integrity": {"scrub_every_s": -1}})
    with pytest.raises(ValueError):
        P.config.parse_config({"integrity": {"scrub_batch": 0}})


# ------------------------------------------------------ across the packages


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_envelopes_and_checkpoints_cross_verify(writer, reader):
    """Bytes one package writes verify in the other: the envelope itself
    (both wrap a payload to the same bytes), a checkpoint's meta and
    delta chunks (the reader's ``StoreCheckpoint`` loads the writer's,
    and heals the writer's damaged delta to the same snapshot), and a
    journal intent."""
    W, R = C[writer], C[reader]
    payload = json.dumps({"stack": [[1, 2]], "täxt": "✓"})
    assert W.envelope.wrap(payload) == R.envelope.wrap(payload)
    assert R.envelope.unwrap(W.envelope.wrap(payload)) == (payload, "ok")
    src = W.store.ResultStore()
    ckpt = W.actors.StoreCheckpoint(src, "x-1", every_s=0.0)
    a, b, c = [[[[1]], 3]], [[[[1], [2]], 2]], [[[[2]], 2]]
    ckpt.save({"version": 1, "stack": [{"x": 1}], "results_done": 0,
               "results": list(a)})
    ckpt.save({"version": 1, "stack": [{"x": 2}], "results_done": 1,
               "results": list(b)})
    ckpt.save({"version": 1, "stack": [], "results_done": 2,
               "results": list(c)})
    src.journal_set("x-1", json.dumps({"replica": writer}))
    dst = R.store.ResultStore()
    dst.set("fsm:frontier:x-1", src.get("fsm:frontier:x-1"))
    chunks = src.lrange("fsm:frontier:results:x-1")
    for chunk in chunks:
        dst.rpush("fsm:frontier:results:x-1", chunk)
    dst.set("fsm:journal:x-1", src.get("fsm:journal:x-1"))
    state = R.actors.StoreCheckpoint(dst, "x-1").load()
    assert (state["results"], state["stack"]) == (a + b + c, [])
    assert json.loads(dst.journal_get("x-1")) == {"replica": writer}
    # the writer's newest delta rots in the reader's store: the reader
    # heals it to the snapshot the writer embedded in the chunk before
    assert len(chunks) == 2
    dst.delete("fsm:frontier:results:x-1")
    dst.rpush("fsm:frontier:results:x-1", chunks[0])
    dst.rpush("fsm:frontier:results:x-1",
              _flip(chunks[1], len(chunks[1]) // 2))
    healed = R.actors.StoreCheckpoint(dst, "x-1").load()
    assert (healed["results"], healed["stack"]) == (a + b, [{"x": 2}])
