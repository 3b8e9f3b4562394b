"""The seeded storm of ``scripts/storm_smoke.py`` and its invariant
checker, for ``tests/test_torch_storm.py`` on the CPU and
``chip_smoke.py``'s phase 29 on the card.

``storm_round`` is a copy of the script's ``storm_round``: the same
seeded schedule (a submit, then one fault event, eight times over), with
the job templates and the store proxies passed in, so the card can give
it full-size jobs.  ``check_invariants`` is a copy of the script's
``check_invariants`` (the jepsen-lite checker) over a store client, the
accepted uids, the wanted texts, the replicas' ports and the lease writes
a ``SnoopingMiniRedis`` saw.  This module imports nothing of ``jax`` or
``spark_fsm_tpu``, so the card's host, which has neither, can run it."""

import json
import random
import re
import time
import urllib.error
import urllib.parse
import urllib.request

QUIESCE_TIMEOUT_S = 240.0


def post(port, endpoint, timeout=60, **params):
    """(HTTP status, JSON body) of a form POST; 4xx and 5xx answers too."""
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{port}{endpoint}"
    try:
        with urllib.request.urlopen(url, data=data,
                                    timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def scrape(port, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=timeout) as resp:
        return resp.read().decode()


def series_sum(text, family, label_filter=""):
    """Sum of a ``/metrics`` family's samples whose labels hold
    ``label_filter``; raises when the family is missing."""
    total, seen = 0.0, False
    for line in text.splitlines():
        m = re.match(rf"^{re.escape(family)}(\{{[^}}]*\}})?\s+(\S+)$", line)
        if m and label_filter in (m.group(1) or ""):
            total += float(m.group(2))
            seen = True
    assert seen, f"{family} missing from /metrics"
    return total


def leftovers(client, markers=True):
    """Journal intents, leases and (with ``markers``) admission markers
    left in the store."""
    keys = (client.keys("fsm:journal:*")
            + [k for k in client.keys("fsm:lease:*")
               if k != "fsm:lease:token"])
    if markers:
        keys += client.keys("fsm:admission:*")
    return keys


def check_invariants(client, accepted, oracles, ports, lease_sets, phase,
                     log=print, quiesce_s=QUIESCE_TIMEOUT_S, waive=()):
    """The checker; every violation is a hard failure (AssertionError),
    save those of the invariants named in ``waive``, which are listed in
    the accounting's ``waived`` instead.

    - quiescence: no journal intent, lease, admission marker
      (``markers``) or spooled write left (the spool gauge is 0 on every
      replica in ``ports``), every accepted uid terminal;
    - exactly-once settlement (``settlement``): one terminal entry in
      each accepted uid's status log;
    - ``parity``: every finished uid in ``oracles`` stores the wanted
      text;
    - ``tokens``: lease tokens (``lease_sets``: (uid, token, replica) in
      write order) never fall for a uid, and a token is re-SET only by
      its replica.

    Returns the accounting printed beside the verdict."""
    from spark_fsm_tpu_torch.service.model import deserialize_patterns
    from spark_fsm_tpu_torch.utils.canonical import patterns_text

    violations, waived = [], []

    def violate(invariant, text):
        (waived if invariant in waive else violations).append(text)

    markers = "markers" not in waive
    deadline = time.time() + quiesce_s
    left, spooled = None, None
    while True:
        left = leftovers(client, markers)
        spooled = 0.0
        try:
            for port in ports:
                spooled += series_sum(scrape(port),
                                      "fsm_storeguard_spool_entries")
        except Exception:
            spooled = -1.0
        terminal = all(
            client.get(f"fsm:status:{uid}") in ("finished", "failure")
            for uid in accepted)
        if not left and spooled == 0.0 and terminal:
            break
        if time.time() >= deadline:
            violate("quiescence", f"no quiescence: leftovers={left} "
                                  f"spooled={spooled}")
            for key in left or ():
                log(f"  [diag] {key} = {client.get(key)!r}")
            for port in ports:
                try:
                    _, health = post(port, "/admin/health", timeout=45)
                    log(f"  [diag] :{port} storeguard="
                        f"{health.get('storeguard')} "
                        f"admission={health.get('admission')}")
                except Exception as exc:
                    log(f"  [diag] :{port} health unreachable: {exc}")
            break
        time.sleep(0.25)
    if not markers:
        stray = client.keys("fsm:admission:*")
        if stray:
            violate("markers", f"admission markers left: {stray}")

    for uid in sorted(accepted):
        st = client.get(f"fsm:status:{uid}")
        if st not in ("finished", "failure"):
            violate("quiescence", f"{uid}: no terminal status ({st!r})")
            continue
        entries = [e.partition(":")[2]
                   for e in client.lrange(f"fsm:status:log:{uid}")]
        terminals = [e for e in entries if e in ("finished", "failure")]
        if len(terminals) != 1:
            violate("settlement",
                    f"{uid}: settled {len(terminals)} times ({entries})")

    parity_ok = 0
    for uid, want_text in sorted(oracles.items()):
        if client.get(f"fsm:status:{uid}") != "finished":
            continue
        raw = client.get(f"fsm:pattern:{uid}")
        if raw is None:
            violate("parity", f"{uid}: finished but no patterns")
            continue
        if patterns_text(deserialize_patterns(raw)) != want_text:
            violate("parity", f"{uid}: PARITY VIOLATION")
        else:
            parity_ok += 1

    last = {}
    for uid, token, replica in lease_sets:
        prev = last.get(uid)
        if prev is not None:
            ptok, prep = prev
            if token < ptok:
                violate("tokens", f"{uid}: token regressed {ptok} -> {token}")
            if token == ptok and replica != prep:
                violate("tokens", f"{uid}: token {token} reused across "
                                  f"replicas {prep} -> {replica}")
        last[uid] = (token, replica)

    fences = refused = replays = stalls = 0.0
    for port in ports:
        text = scrape(port)
        fences += series_sum(text, "fsm_lease_fence_rejections_total")
        refused += series_sum(text, "fsm_storeguard_replays_total",
                              'outcome="refused"')
        replays += series_sum(text, "fsm_storeguard_replays_total",
                              'outcome="ok"')
        stalls += series_sum(text, "fsm_storeguard_stalls_total",
                             'outcome="entered"')
    out = {"accepted": len(accepted), "parity_ok": parity_ok,
           "replays_ok": int(replays), "replays_refused": int(refused),
           "fence_rejections": int(fences), "stalls": int(stalls),
           "lease_sets": len(lease_sets), "waived": waived}
    log(f"[{phase}] checked " + " ".join(f"{k}={v}" for k, v in out.items()))
    assert not violations, "INVARIANT VIOLATIONS:\n  " + \
        "\n  ".join(violations)
    return out


STORM_STEPS = 8


def storm_round(proxies, ports, seed, templates, accepted, oracles,
                log=print):
    """One seeded fault schedule over live traffic: ``STORM_STEPS`` submits,
    each to a seeded replica (``ports``) with a seeded template
    (``templates``: (``/train`` parameters without the uid, wanted
    text)), checkpointed with probability 0.4, each followed by one
    seeded event on the store links (``proxies``, one a replica): a
    replica's black-hole, a global black-hole, a delay, a reset of a
    replica's connections, or a pause.  Accepted uids go into
    ``accepted`` and their texts into ``oracles``; the links are healed
    at the end.  Returns (sheds, the events as text)."""
    rng = random.Random(seed)
    log(f"storm seed={seed}")
    shed, events = 0, []

    def event(text):
        events.append(text)
        log(f"  event: {text}")

    for step in range(STORM_STEPS):
        uid = f"storm-{seed}-{step}"
        port = ports[rng.randrange(len(ports))]
        params, want = templates[rng.randrange(len(templates))]
        params = dict(params, uid=uid)
        if rng.random() < 0.4:
            params.update(checkpoint="1", checkpoint_every_s="0")
        try:
            code, body = post(port, "/train", timeout=30, **params)
        except Exception as exc:
            log(f"  submit {uid} failed transport-side ({exc}) — "
                f"counts as shed")
            code, body = 0, {}
        if code == 200 and body.get("status") == "started":
            accepted.add(uid)
            oracles[uid] = want
        else:
            shed += 1

        roll = rng.random()
        if roll < 0.30:
            victim = rng.randrange(len(proxies))
            dur = 0.5 + 2.0 * rng.random()
            event(f"black-hole R{victim} for {dur:.1f}s")
            proxies[victim].blackhole(True)
            time.sleep(dur)
            proxies[victim].heal()
        elif roll < 0.45:
            dur = 1.0 + 2.0 * rng.random()
            event(f"GLOBAL black-hole for {dur:.1f}s")
            for p in proxies:
                p.blackhole(True)
            time.sleep(dur)
            for p in proxies:
                p.heal()
        elif roll < 0.65:
            victim = rng.randrange(len(proxies))
            d = 0.05 + 0.15 * rng.random()
            event(f"delay R{victim} by {d * 1000:.0f}ms")
            proxies[victim].delay(d)
            time.sleep(1.0)
            proxies[victim].heal()
        elif roll < 0.80:
            victim = rng.randrange(len(proxies))
            n = proxies[victim].reset_all()
            event(f"reset R{victim} ({n} connections)")
        else:
            time.sleep(0.3 + 0.5 * rng.random())

    for p in proxies:
        p.heal()
    log(f"  seed {seed}: {len(accepted)} accepted, {shed} shed this "
        f"round; healing + quiescing")
    return shed, events
