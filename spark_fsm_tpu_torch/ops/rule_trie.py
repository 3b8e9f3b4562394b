"""Device-resident packed rule trie and batched prefix -> consequent
scoring — port of ``spark_fsm_tpu/ops/rule_trie.py``.

A finished mine's rule set is compiled once into int32 planes on the
device (:func:`build_trie`); waves of observed prefixes are then scored
against them in one pass each (:func:`score_wave`).  The host half is a
copy of the reference's: ``predict_host`` (the Questor semantics, the
byte-parity reference), ``rules_from_patterns``, ``rules_digest``,
``RuleTrie`` and ``_build_csr``, and ``build_trie``'s arithmetic (ranks
from Python float confidences, so float64 ties fall where the oracle's
do).  The planes are the reference's, as ``torch.int32`` tensors, so
``RuleTrie.nbytes()`` (the artifact cache's byte budget) is its too:

- ``ante_tok [F, D]``: one row per lane (a (rule, consequent item) pair),
  the antecedent padded with ``_PAD``; pad lanes start with ``_DEAD``;
- ``lane_item / lane_slot / lane_sup / lane_supx [F]``: consequent item,
  its dense slot (slots ascend with item ids), the exact support pair;
- ``sel_rank / score_rank / lane_of_rank [F]``: the oracle's comparison
  order, precomputed on the host, so the device compares int32 only;
- the CSR trie planes ``trie_child_off/tok/node``, ``trie_lane_off/ids``.

The scorer (:func:`score_device`, the reference's ``_score_fn`` body) is
plain torch on the trie's device, with no hand kernel: a masked AND-fold
of each lane's antecedent tokens over the wave's prefix rows (``[W, F, D,
D]`` membership), the observed-item mask, a scatter-min of ``sel_rank``
per consequent slot, and a stable argsort of the winners' ``score_rank``.
Every tensor it makes takes the trie's device explicitly, and its body
makes no host sync: the prefix rows go up through pinned memory and the
three top-m planes come back with ``models/_common.to_host`` (one event,
one wait a wave).  Rows are independent, so fusing requests into one
wave cannot change any row's bytes.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.models._common import to_device, to_host
from spark_fsm_tpu_torch.utils import shapes
from spark_fsm_tpu_torch.utils.canonical import (
    PatternResult, RuleResult, sort_patterns)

_PAD = -1          # unused antecedent token slot (matches vacuously)
_DEAD = -2         # pad-lane sentinel (matches nothing)
_BIG = np.int32(1 << 30)

# every plane the artifact holds on the device, in the reference's
# ``nbytes`` order; the first eight feed the scorer
PLANES = ("ante_tok", "lane_item", "lane_slot", "sel_rank", "lane_of_rank",
          "score_rank", "lane_sup", "lane_supx", "trie_child_off",
          "trie_child_tok", "trie_child_node", "trie_lane_off",
          "trie_lane_ids")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Host reference — the Questor prediction semantics, verbatim
# ---------------------------------------------------------------------------

def predict_host(rules: Sequence[RuleResult], prefix: Sequence[int],
                 m: int) -> List[dict]:
    """Brute-force prefix -> top-m consequent scoring over the raw rule
    list — the byte-parity reference for the device trie."""
    have = set(int(i) for i in prefix)
    best: Dict[int, tuple] = {}
    for x, y, sup, supx in rules:
        if supx <= 0 or not set(x) <= have:
            continue
        conf = sup / supx
        for it in y:
            if it in have:
                continue
            cur = best.get(it)
            if cur is None or (conf, sup) > (cur[0], cur[1]):
                best[it] = (conf, sup, supx, x, y)
    ranked = sorted(best.items(), key=lambda kv: (-kv[1][0], -kv[1][1], kv[0]))
    return [
        {"item": it, "confidence": conf, "support": sup,
         "antecedent_support": supx, "antecedent": list(x),
         "consequent": list(y)}
        for it, (conf, sup, supx, x, y) in ranked[:max(0, int(m))]
    ]


def rules_from_patterns(patterns: Sequence[PatternResult]) -> List[RuleResult]:
    """Derive prediction rules from a frequent-sequence set: for every
    pattern with >= 2 itemsets, antecedent = items of the prefix,
    consequent = the last itemset's new items, supx = the prefix
    pattern's own support (the set is closed under prefixes).
    Deterministic (canonical pattern order)."""
    sup_of = {tuple(p): s for p, s in patterns}
    rules: List[RuleResult] = []
    for pat, sup in sort_patterns(patterns):
        if len(pat) < 2:
            continue
        supx = sup_of.get(tuple(pat[:-1]))
        if supx is None or supx <= 0:
            continue
        x = tuple(sorted({i for s in pat[:-1] for i in s}))
        y = tuple(sorted(set(pat[-1]) - set(x)))
        if not y:
            continue
        rules.append((x, y, int(sup), int(supx)))
    return rules


def rules_digest(payload: str) -> str:
    """Content address of a serialized rule set — the artifact cache key
    component that makes re-mine staleness a cache miss."""
    return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Artifact compile
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RuleTrie:
    """Compiled artifact: device planes + the host rule list they index."""

    rules: List[RuleResult]            # payload order (oracle order)
    lanes: int                         # real lanes (rule, cons-item) pairs
    F: int                             # pow2 lane axis
    D: int                             # pow2 antecedent/prefix token axis
    digest: str                        # rule-set content digest
    built_ts: float                    # host wall at build (staleness)
    # device planes (int32 tensors; see the module docstring)
    ante_tok: Optional[torch.Tensor] = None
    lane_item: Optional[torch.Tensor] = None
    lane_slot: Optional[torch.Tensor] = None
    sel_rank: Optional[torch.Tensor] = None
    lane_of_rank: Optional[torch.Tensor] = None
    score_rank: Optional[torch.Tensor] = None
    lane_sup: Optional[torch.Tensor] = None
    lane_supx: Optional[torch.Tensor] = None
    # CSR trie planes (device-resident compact spelling)
    trie_child_off: Optional[torch.Tensor] = None
    trie_child_tok: Optional[torch.Tensor] = None
    trie_child_node: Optional[torch.Tensor] = None
    trie_lane_off: Optional[torch.Tensor] = None
    trie_lane_ids: Optional[torch.Tensor] = None
    # host mirrors for response decode
    h_lane_rule: Optional[np.ndarray] = None
    h_lane_item: Optional[np.ndarray] = None
    stats: Optional[dict] = None

    def nbytes(self) -> int:
        total = 0
        for f in PLANES:
            arr = getattr(self, f)
            if arr is not None:
                total += arr.numel() * arr.element_size()
        return total


def _build_csr(antes: List[Tuple[int, ...]],
               lane_ante: List[int]) -> dict:
    """Prefix trie over the unique antecedent token sequences; children
    CSR-packed per node, lanes attached to their terminal node."""
    children: List[Dict[int, int]] = [{}]
    node_of_ante: List[int] = []
    for ante in antes:
        node = 0
        for t in ante:
            nxt = children[node].get(t)
            if nxt is None:
                nxt = len(children)
                children[node][t] = nxt
                children.append({})
            node = nxt
        node_of_ante.append(node)
    n = len(children)
    child_off = np.zeros(n + 1, np.int32)
    toks: List[int] = []
    kids: List[int] = []
    for i, ch in enumerate(children):
        for t in sorted(ch):
            toks.append(t)
            kids.append(ch[t])
        child_off[i + 1] = len(toks)
    lanes_at: List[List[int]] = [[] for _ in range(n)]
    for lane, ai in enumerate(lane_ante):
        lanes_at[node_of_ante[ai]].append(lane)
    lane_off = np.zeros(n + 1, np.int32)
    lane_ids: List[int] = []
    for i, ls in enumerate(lanes_at):
        lane_ids.extend(ls)
        lane_off[i + 1] = len(lane_ids)
    return {
        "child_off": child_off,
        "child_tok": np.asarray(toks or [0], np.int32),
        "child_node": np.asarray(kids or [0], np.int32),
        "lane_off": lane_off,
        "lane_ids": np.asarray(lane_ids or [0], np.int32),
        "n_nodes": n,
        "token_slots": sum(len(a) for a in antes),
    }


def build_trie(rules: Sequence[RuleResult], *, lanes_floor: int = 0,
               depth_floor: int = 0, device: DeviceLike = None) -> RuleTrie:
    """Compile a rule list into the packed trie artifact, its planes on
    ``device`` (``cuda`` unless the caller asks for ``"cpu"``).

    ``lanes_floor``/``depth_floor`` pad the geometry up to a shared
    envelope, as in the reference (its prewarmed shape keys)."""
    dev = resolve_device(device)
    rules = [(tuple(int(i) for i in x), tuple(int(i) for i in y),
              int(sup), int(supx))
             for x, y, sup, supx in rules if int(supx) > 0]
    # lanes in payload order: rule r, consequent item y[j]
    lane_rule: List[int] = []
    lane_item: List[int] = []
    antes: List[Tuple[int, ...]] = []
    ante_ix: Dict[Tuple[int, ...], int] = {}
    lane_ante: List[int] = []
    for r, (x, y, sup, supx) in enumerate(rules):
        ai = ante_ix.get(x)
        if ai is None:
            ai = ante_ix[x] = len(antes)
            antes.append(x)
        for it in y:
            lane_rule.append(r)
            lane_item.append(it)
            lane_ante.append(ai)
    L = len(lane_rule)
    depth = max([len(x) for x, *_ in rules], default=0)
    F = _next_pow2(max(L, lanes_floor, 1))
    D = _next_pow2(max(depth, depth_floor, 1))

    # the oracle's comparison semantics, precomputed with the oracle's
    # own arithmetic: conf is a PYTHON float (sup/supx) so float64
    # collisions tie exactly where the Questor walk ties
    conf = [rules[lane_rule[i]][2] / rules[lane_rule[i]][3]
            for i in range(L)]
    sups = [rules[lane_rule[i]][2] for i in range(L)]
    order = sorted(range(L), key=lambda i: (-conf[i], -sups[i], i))
    sel_rank = np.arange(F, dtype=np.int32)
    lane_of_rank = np.arange(F, dtype=np.int32)
    for rank, lane in enumerate(order):
        sel_rank[lane] = rank
        lane_of_rank[rank] = lane
    score_rank = np.full(F, _BIG, np.int32)
    rank = -1
    prev = None
    for r_pos, lane in enumerate(order):
        key = (conf[lane], sups[lane])
        if key != prev:
            rank = r_pos  # dense-enough: equal pairs share, order holds
            prev = key
        score_rank[lane] = rank

    # dense consequent slots sorted by item id (slot asc == item asc,
    # the oracle's final tie-break axis)
    slot_items = sorted(set(lane_item))
    slot_of = {it: s for s, it in enumerate(slot_items)}

    ante_tok = np.full((F, D), _PAD, np.int32)
    ante_tok[L:, 0] = _DEAD
    l_item = np.full(F, -3, np.int32)
    l_slot = np.zeros(F, np.int32)
    l_sup = np.zeros(F, np.int32)
    l_supx = np.zeros(F, np.int32)
    for i in range(L):
        x = rules[lane_rule[i]][0]
        ante_tok[i, :len(x)] = x
        l_item[i] = lane_item[i]
        l_slot[i] = slot_of[lane_item[i]]
        l_sup[i] = rules[lane_rule[i]][2]
        l_supx[i] = rules[lane_rule[i]][3]

    csr = _build_csr(antes, lane_ante)
    digest = hashlib.sha256(repr(rules).encode()).hexdigest()
    art = RuleTrie(
        rules=rules, lanes=L, F=F, D=D, digest=digest,
        built_ts=time.time(),
        h_lane_rule=np.asarray(lane_rule or [0], np.int32),
        h_lane_item=np.asarray(l_item),
        stats={
            "rules": len(rules), "lanes": L, "F": F, "D": D,
            "consequent_slots": len(slot_items),
            "trie_nodes": csr["n_nodes"],
            # shared-prefix compression: token slots the trie stores
            # once vs the flat per-antecedent total
            "token_slots_flat": csr["token_slots"],
            "token_slots_trie": max(0, csr["n_nodes"] - 1),
        })
    planes = {
        "ante_tok": ante_tok, "lane_item": l_item, "lane_slot": l_slot,
        "sel_rank": sel_rank, "lane_of_rank": lane_of_rank,
        "score_rank": score_rank, "lane_sup": l_sup, "lane_supx": l_supx,
        "trie_child_off": csr["child_off"],
        "trie_child_tok": csr["child_tok"],
        "trie_child_node": csr["child_node"],
        "trie_lane_off": csr["lane_off"],
        "trie_lane_ids": csr["lane_ids"],
    }
    for k, v in planes.items():
        setattr(art, k, to_device(v, dev))
    return art


# ---------------------------------------------------------------------------
# Scoring: pack on the host, score on the trie's device, decode on the host
# ---------------------------------------------------------------------------

def pack_wave(trie: RuleTrie, prefixes: Sequence[Sequence[int]],
              wave_pad: int = 0) -> np.ndarray:
    """The wave's ``[W, D]`` int32 prefix rows (``_PAD`` filled), W the
    pow2 of the row count; a prefix longer than the trie's depth raises
    the reference's ``ValueError``."""
    W = _next_pow2(max(len(prefixes), wave_pad, 1))
    for p in prefixes:
        if len(p) > trie.D:
            raise ValueError(
                f"observed prefix length {len(p)} exceeds trie depth "
                f"{trie.D}; rebuild the artifact at a deeper geometry")
    q = np.full((W, trie.D), _PAD, np.int32)
    for i, p in enumerate(prefixes):
        if p:
            q[i, :len(p)] = np.asarray(list(p), np.int32)
    return q


def score_device(trie: RuleTrie, q_tok: torch.Tensor, M: int):
    """The reference's ``_score_fn`` body on the trie's device: for each
    prefix row, the top ``min(M, F)`` winning lanes and their support
    pairs (``-1`` where fewer items match).  Makes no host sync."""
    dev = trie.ante_tok.device
    F = trie.F
    W = q_tok.shape[0]
    big = int(_BIG)
    ante_tok = trie.ante_tok
    # masked AND-fold: every antecedent token slot is either pad or a
    # member of the row's observed-prefix tokens
    member = (ante_tok[None, :, :, None]
              == q_tok[:, None, None, :]).any(-1)             # [W, F, D]
    matched = ((ante_tok[None, :, :] == _PAD) | member).all(-1)  # [W, F]
    # the oracle never predicts an already-observed item
    seen = (trie.lane_item[None, :, None] == q_tok[:, None, :]).any(-1)
    key = torch.where(matched & ~seen, trie.sel_rank[None, :], big)
    slots = trie.lane_slot.long()[None, :].expand(W, F)
    best = torch.full((W, F), big, dtype=torch.int32, device=dev).scatter_reduce(
        1, slots, key, reduce="amin")                        # per-slot winner
    valid = best < big
    win = trie.lane_of_rank[best.clamp(max=F - 1).long()]    # [W, F]
    order_key = torch.where(valid, trie.score_rank[win.long()], big)
    # stable argsort == (score_rank asc, slot asc) == the oracle's
    # (-conf, -sup, item): slots ascend with item ids by construction
    order = torch.argsort(order_key, dim=-1, stable=True)[:, :M]
    top_valid = valid.gather(1, order)
    top_lane = torch.where(top_valid, win.gather(1, order), -1)
    safe = top_lane.clamp(min=0).long()
    top_sup = torch.where(top_valid, trie.lane_sup[safe], -1)
    top_supx = torch.where(top_valid, trie.lane_supx[safe], -1)
    return top_lane, top_sup, top_supx


def decode_wave(trie: RuleTrie, n: int, m: int, M: int,
                top_lane: np.ndarray, top_sup: np.ndarray,
                top_supx: np.ndarray) -> List[List[dict]]:
    """The first ``n`` rows' top-m entries in the Questor spelling (host
    float division over the winning lanes' exact integer pairs)."""
    out: List[List[dict]] = []
    for i in range(n):
        entries: List[dict] = []
        # the argsort slice yields min(M, F) columns — a top-m pad wider
        # than the lane axis cannot produce more winners than lanes
        for j in range(min(int(m), M, top_lane.shape[1])):
            lane = int(top_lane[i, j])
            if lane < 0:
                break
            x, y, sup, supx = trie.rules[int(trie.h_lane_rule[lane])]
            # the support planes rode the launch — cross-check the
            # device's winner against the host rule it indexes
            if int(top_sup[i, j]) != sup or int(top_supx[i, j]) != supx:
                raise AssertionError(
                    f"device support planes disagree with host rules at "
                    f"lane {lane}: {(int(top_sup[i, j]), int(top_supx[i, j]))}"
                    f" != {(sup, supx)}")
            entries.append({
                "item": int(trie.h_lane_item[lane]),
                "confidence": sup / supx,
                "support": sup,
                "antecedent_support": supx,
                "antecedent": list(x),
                "consequent": list(y),
            })
        out.append(entries)
    return out


def warm_geometry(F: int, D: int, W: int, M: int,
                  device: DeviceLike = None) -> str:
    """Score one geometry bucket with zero planes on ``device`` (the
    prewarm's entry point: the first wave of a live artifact at
    this geometry then finds the caching allocator warm) and record its
    shape key."""
    dev = resolve_device(device)
    z = np.zeros(F, np.int32)
    trie = RuleTrie(rules=[], lanes=0, F=F, D=D, digest="", built_ts=0.0)
    for name, v in (("ante_tok", np.full((F, D), _DEAD, np.int32)),
                    ("lane_item", z - 3), ("lane_slot", z),
                    ("sel_rank", np.arange(F, dtype=np.int32)),
                    ("lane_of_rank", np.arange(F, dtype=np.int32)),
                    ("score_rank", z + _BIG), ("lane_sup", z),
                    ("lane_supx", z)):
        setattr(trie, name, to_device(v, dev))
    q = np.full((W, D), _PAD, np.int32)
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        _, ev = to_host(score_device(trie, to_device(q, dev), M))
        if ev is not None:
            ev.synchronize()
    key = shapes.key_predict(F, D, W, M)
    shapes.record(key)
    return key


def score_wave(trie: RuleTrie, prefixes: Sequence[Sequence[int]],
               m: int, *, wave_pad: int = 0) -> List[List[dict]]:
    """Score a wave of observed prefixes on the trie's device; returns
    per-request top-m entry lists in the Questor response spelling, and
    records the wave's ``predict:`` shape key."""
    M = _next_pow2(max(int(m), 1))
    q = pack_wave(trie, prefixes, wave_pad)
    dev = trie.ante_tok.device
    # the trie's card as this thread's current device: the readback's
    # event is recorded on the current device's stream
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        host, ev = to_host(score_device(trie, to_device(q, dev), M))
        if ev is not None:
            ev.synchronize()
    shapes.record(shapes.key_predict(trie.F, trie.D, q.shape[0], M))
    return decode_wave(trie, len(prefixes), m, M,
                       *(h.numpy() for h in host))
