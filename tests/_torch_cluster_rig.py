"""Shared rig of the replicated-service tests (``test_torch_redis_store``,
``test_torch_lease``, ``test_torch_admission``, ``test_torch_storeguard``,
``test_torch_replica``): each drill runs once with the reference's
service modules (``spark_fsm_tpu.service``) and once with the port's
(``spark_fsm_tpu_torch.service``, engines on the CPU) in one pytest
process, and the two runs' records must be equal.

``PKGS[name]`` is a namespace of one package's modules, so a drill body
is written once and reads ``P.actors.Miner``, ``P.obs.REGISTRY`` and so
on.  The two packages keep separate module state (registries, job
control, the installed store guard), so the runs do not see each other.
"""

import contextlib
import threading
import time
import types

import spark_fsm_tpu
import spark_fsm_tpu_torch

DRILL_TIMEOUT_S = 120.0
NAMES = ("reference", "port")


def _namespace(root) -> types.SimpleNamespace:
    import importlib

    mods = {
        "config": "config", "actors": "service.actors",
        "lease": "service.lease", "model": "service.model",
        "store": "service.store", "sources": "service.sources",
        "plugins": "service.plugins", "storeguard": "service.storeguard",
        "resp": "service.resp", "app": "service.app",
        "jobctl": "utils.jobctl", "obs": "utils.obs",
        "faults": "utils.faults", "envelope": "utils.envelope",
        "canonical": "utils.canonical", "spmf": "data.spmf",
        "synth": "data.synth", "vertical": "data.vertical",
        "oracle": "models.oracle", "resultcache": "service.resultcache",
        "usage": "service.usage", "fusion": "service.fusion",
        "obsplane": "service.obsplane", "autoscale": "service.autoscale",
        "fairness": "service.fairness", "remote": "service.remote",
        "kafka": "streaming.kafka", "consumer": "streaming.consumer",
        "incremental": "streaming.incremental",
    }
    ns = types.SimpleNamespace(
        name="port" if root is spark_fsm_tpu_torch else "reference")
    for attr, mod in mods.items():
        setattr(ns, attr, importlib.import_module(f"{root.__name__}.{mod}"))
    return ns


PKGS = {"reference": _namespace(spark_fsm_tpu),
        "port": _namespace(spark_fsm_tpu_torch)}


class Twins:
    """Records of scenarios run once on each package's namespace (``ns``,
    name -> namespace): :meth:`held` runs ``scenario(P, *args)`` and the
    port's record must equal the reference's (run then if the reference's
    case did not run in this process).  With ``families`` (name prefixes)
    the record also holds the registry families the scenario moved."""

    def __init__(self, ns: dict, families: tuple = ()):
        self.ns, self.families, self.records = ns, tuple(families), {}

    def run(self, pkg: str, scenario, *args) -> dict:
        P = self.ns[pkg]
        before = self._families(P)
        rec = scenario(P, *args)
        if self.families:
            rec["moved"] = moved(before, self._families(P))
        return rec

    def held(self, pkg: str, scenario, *args) -> dict:
        key = (scenario.__name__,) + args
        rec = self.run(pkg, scenario, *args)
        self.records.setdefault(key, {})[pkg] = rec
        if pkg == "port":
            ref = self.records[key].get("reference")
            if ref is None:
                ref = self.run("reference", scenario, *args)
            assert rec == ref
        return rec

    def _families(self, P) -> dict:
        if not self.families:
            return {}
        return {k: v for k, v in P.obs.REGISTRY.snapshot().items()
                if k.startswith(self.families)}


def moved(before: dict, after: dict) -> dict:
    """What each family (a number, or a dict of labelled samples) moved
    by between two registry snapshots; families that did not move are
    left out.  Histogram samples (dicts) compare their ``count``."""
    out = {}
    for fam, now in after.items():
        was = before.get(fam, {} if isinstance(now, dict) else 0)
        if isinstance(now, dict):
            d = {}
            for lab, v in now.items():
                w = was.get(lab, 0)
                if isinstance(v, dict):
                    v = v.get("count", 0)
                    w = w.get("count", 0) if isinstance(w, dict) else w
                if v != w:
                    d[lab] = v - w
        else:
            d = now - was
        if d:
            out[fam] = d
    return out


def assert_covers(names, *reference_files) -> None:
    """Every ``test_*`` function of the reference's ``reference_files``
    (under ``tests/``) has a twin of the same name among ``names``."""
    import ast
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    ours = {n for n in names if n.startswith("test_")}
    for ref in reference_files:
        with open(os.path.join(here, ref)) as fh:
            tree = ast.parse(fh.read())
        want = {f.name for f in tree.body if isinstance(f, ast.FunctionDef)
                and f.name.startswith("test_")}
        assert want <= ours, (ref, sorted(want - ours))


class PortOnCpu:
    """Pin the port's service device to the CPU for a test and restore
    what was there after (the port's plugins resolve ``cuda`` by
    default, which raises on a host without a card)."""

    def __enter__(self):
        plugins = PKGS["port"].plugins
        self._saved = plugins._device
        plugins.set_device("cpu")
        return self

    def __exit__(self, *exc):
        PKGS["port"].plugins._device = self._saved


@contextlib.contextmanager
def restored(module, name):
    """Put ``module.name`` back after a scenario that replaces it (a
    scenario takes no fixture, so that its record's key is its name)."""
    real = getattr(module, name)
    try:
        yield
    finally:
        setattr(module, name, real)


def req(P, uid, **extra):
    """The reference tests' tiny SPADE train request."""
    data = {"algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
            "uid": uid}
    data.update(extra)
    return P.model.ServiceRequest("fsm", "train", data)


def await_terminal(store, uid, timeout=DRILL_TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = store.status(uid)
        if st in ("finished", "failure"):
            return st
        time.sleep(0.01)
    raise TimeoutError(f"job {uid} reached no terminal status "
                       f"(now {store.status(uid)!r})")


def counter(P, name, label=None):
    """One family of ``P``'s registry snapshot (a labelled family's
    sample when ``label`` is given, 0 when it has none yet)."""
    value = P.obs.REGISTRY.snapshot()[name]
    return value.get(label, 0) if label is not None else value


def text_of(P, payload):
    """Canonical pattern text of a stored ``/get/patterns`` payload."""
    return P.canonical.patterns_text(P.model.deserialize_patterns(payload))


class Gate:
    """Deterministic worker occupancy, as the reference tests' ``_Gate``:
    ``P.sources.get_db`` blocks for the chosen uids until released, and
    records every uid that reaches it in order.  ``once`` blocks only the
    first run of each uid (an adopted or stolen re-run of the uid on the
    other in-process replica passes freely, as in ``tests/test_lease.py``)."""

    def __init__(self, P, monkeypatch, block_uids=(), once=False):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.block_uids = set(block_uids)
        self.run_order = []
        real = P.sources.get_db

        def gated(r, store):
            self.run_order.append(r.uid)
            if r.uid in self.block_uids:
                if once:
                    self.block_uids.discard(r.uid)
                self.entered.set()
                assert self.release.wait(DRILL_TIMEOUT_S), "gate never freed"
            return real(r, store)

        monkeypatch.setattr(P.sources, "get_db", gated)
