"""Time this tree's kernels B1, B2 and B3 against another checkout's, in
one process on one CUDA card.

    python3 -m spark_fsm_tpu_torch.kernel_ab OTHER_CHECKOUT

Builds ``OTHER_CHECKOUT/spark_fsm_tpu_torch/csrc/{pair_support,
rule_support,extend_prune}.cu`` with this tree's nvcc flags, loads both
libraries with ``ctypes`` beside this tree's, checks each pair equal on
every shape, and times the raw launches with CUDA events in turns (other,
this, this, other; each the mean of ``REPS`` launches queued behind a
spinning kernel, after warm-ups):

- B1 (pair supports) at the queue engine's wide and late waves on the
  BMS-WebView-2-shaped database (P=1024 and 128, NI=384 of which 360 rows
  are live, S=77,504), the classic engine's first launch (P=720, NI=360),
  SPAM's wave on a mesh on the MSNBC-shaped database (P=12, NI=64, 17
  live, S=990,016) and the stream's widest sweep (P=2048, NI=128, 17
  live, S=131,072), this tree's kernel with the ``n_live`` hint and
  without it.  Each launch includes one zero-fill of its output, the same
  for both.  Where the other checkout's ``pair_support_launch`` has the
  earlier interface (no ``n_live``; the caller's split count, computed
  here as that tree's wrapper did), it is called so.  The SASS of this tree's
  B1 instantiations is counted with ``cuobjdump -sass``: instructions,
  predicate-writing LOP3s, predicated adds and moves, 128-bit shared reads;

- B2 (rule supports) at the TSR path's headline launch (C=8192, km=2,
  M=256, S=990,000, W=1) on random candidates and on candidates in runs
  that share a side (as TSR's expansions come), and at km=1;
- B3 (extension count + prune) at the SPAM wave on the MSNBC-shaped
  database (P=12, NI=64 of which 17 rows are live, S=990,016) and at the
  BMS-WebView-2-shaped dense wave (P=128, NI=64, 26 live, S=77,504), this
  tree's kernel with the ``n_live`` hint and without it.

Each B3 launch includes one zero-fill of its output and counter buffer,
the same for both.  Where the other checkout's ``extend_prune_launch``
has the earlier interface, without ``n_live``, it is called so.  A
launcher's interface is read from its source.  Prints one JSON line
with every time, the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPS = 20
RULE_SHAPES = {"km2_random": (8192, 2, 256, 990000, False),
               "km2_runs": (8192, 2, 256, 990000, True),
               "km1_random": (8192, 1, 256, 990000, False)}
# (P, NI, live item rows, S)
WAVES = {"msnbc": (12, 64, 17, 990016), "bms": (128, 64, 26, 77504)}
PAIRS = {"queue_wide": (1024, 384, 360, 77504),
         "queue_late": (128, 384, 360, 77504),
         "classic": (720, 360, 360, 77504),
         "spam_mesh": (12, 64, 17, 990016),
         "stream_sweep": (2048, 128, 17, 131072)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _time(fn, warmup: int = 3, reps: int = REPS) -> float:
    """Device time per call: CUDA events around ``reps`` calls queued
    behind a spinning kernel of about 0.1 s, so the host has issued them
    all before the first runs and no host gap is counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda._sleep(200_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _ab(other, this) -> dict:
    """Times in the order other, this, this, other, and their means."""
    o1, t1, t2, o2 = _time(other), _time(this), _time(this), _time(other)
    return {"other_ms": [o1, o2], "this_ms": [t1, t2],
            "other_mean_ms": (o1 + o2) / 2, "this_mean_ms": (t1 + t2) / 2}


def _words(g, dev, rows: int, n: int):
    import torch

    w = torch.randint(-2**31, 2**31 - 1, (rows, n), dtype=torch.int32,
                      device=dev, generator=g)
    for _ in range(2):
        w &= torch.randint(-2**31, 2**31 - 1, w.shape, dtype=torch.int32,
                           device=dev, generator=g)
    return w


def _candidates(rng, C: int, km: int, M: int, runs: bool) -> np.ndarray:
    """[C, 2, km] rows, 1..km distinct a side, -1 in unused slots; with
    ``runs``, consecutive candidates share one side in runs of 1..40."""
    def side():
        n = rng.integers(1, km + 1)
        out = np.full(km, -1, np.int32)
        out[:n] = rng.choice(M, n, replace=False)
        return out

    xy = np.empty((C, 2, km), np.int32)
    c = 0
    while c < C:
        n = min(C - c, int(rng.integers(1, 41))) if runs else 1
        keep, fixed = rng.integers(0, 2), side()
        for r in range(c, c + n):
            xy[r, keep] = fixed
            xy[r, 1 - keep] = side()
        c += n
    return xy


def takes_live(csrc: Path, name: str) -> bool:
    """Whether ``csrc/<name>.cu``'s ``extern "C"`` launcher takes n_live."""
    text = (csrc / f"{name}.cu").read_text()
    head = text.split(f"int {name}_launch(", 1)[1].split(")", 1)[0]
    return "n_live" in head


def _old_pair_splits(sms: int, P: int, NI: int, S: int) -> int:
    """The split count the earlier B1 wrapper passed: about 16 blocks an
    SM over its 64 x 64 tiles, at least one 32-sequence stage a split."""
    tiles = -(-P // 64) * -(-NI // 64)
    return max(1, min(-(-16 * sms // tiles), -(-S // 32), 65535))


def sass_counts(lib: Path) -> dict:
    """Per B1 kernel instantiation in ``lib``: its SASS instructions, the
    LOP3s that write a predicate, the predicated adds, the predicated moves
    (a count spelled as add-then-select) and the 128-bit shared reads
    (``cuobjdump -sass``)."""
    from spark_fsm_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0, "lop3_pred": 0, "add_pred": 0,
                         "mov_pred": 0, "lds128": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name is None or not m:
            continue
        ins = m.group(1)
        c = out[name]
        c["instructions"] += 1
        c["lop3_pred"] += bool(re.match(r"LOP3\.LUT P\d", ins))
        c["add_pred"] += bool(re.match(r"@!?P\d (IADD3|IMAD\.IADD|VIADD) ", ins))
        c["mov_pred"] += bool(re.match(r"@!?P\d (MOV|IMAD\.MOV|SEL) ", ins))
        c["lds128"] += ins.startswith("LDS.128")
    return out


def main(argv=None) -> dict:
    import torch

    from spark_fsm_tpu_torch.ops import _build
    from spark_fsm_tpu_torch.ops import extend_prune as EP

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    other_csrc = Path(argv[0]).resolve() / "spark_fsm_tpu_torch" / "csrc"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    libs, live = {}, {}
    for who, csrc in (("other", other_csrc), ("this", _build.CSRC)):
        live[who] = {k: takes_live(csrc, k) for k in ("pair_support",
                                                      "extend_prune")}
        ps = ctypes.CDLL(str(_build.build("pair_support", csrc))).pair_support_launch
        ps.argtypes = ([_P] * 3 + [_I, _I] + [_I] * live[who]["pair_support"]
                       + [_LL, _I] + [_I] * (not live[who]["pair_support"])
                       + [_P])
        rs = ctypes.CDLL(str(_build.build("rule_support", csrc))).rule_support_launch
        rs.argtypes = [_P, _P, _P, _P, _I, _I, _LL, _I, _I, _P]
        ep = ctypes.CDLL(str(_build.build("extend_prune", csrc))).extend_prune_launch
        ep.argtypes = ([_P] * 5 + [_I, _I] + [_I] * live[who]["extend_prune"]
                       + [_LL, _I, _I, _I, _P])
        ps.restype = rs.restype = ep.restype = _I
        libs[who] = (rs, ep, ps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "b1_sass": sass_counts(_build.build("pair_support")), "b1": {},
              "b2": {}, "b3": {}}
    print(f"[b1] sass: {result['b1_sass']}", flush=True)

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rng = np.random.default_rng(4)
    for name, (P, NI, n_live, S) in PAIRS.items():
        pt = _words(g, dev, P, S)
        items = _words(g, dev, NI + 3, S)
        items[n_live:NI] = 0
        outs = {w: torch.zeros(P, NI, dtype=torch.int32, device=dev)
                for w in ("other", "this", "this_nohint")}
        old_splits = _old_pair_splits(sms, P, NI, S)

        def run(who):
            out = outs[who]
            out.zero_()
            ptrs = (pt.data_ptr(), items.data_ptr(), out.data_ptr())
            tree = "other" if who == "other" else "this"
            hint = NI if who == "this_nohint" else n_live
            if live[tree]["pair_support"]:
                rc = libs[tree][2](*ptrs, P, NI, hint, S, 1, stream)
            else:
                rc = libs[tree][2](*ptrs, P, NI, S, 1, old_splits, stream)
            if rc:
                raise RuntimeError(f"{who} pair_support launch: CUDA error {rc}")

        for who in outs:
            run(who)
        torch.cuda.synchronize()
        if not all(torch.equal(outs["other"], outs[w]) for w in outs):
            raise RuntimeError(f"B1 differs between the trees at {name}")
        result["b1"][name] = {
            "hint": _ab(lambda: run("other"), lambda: run("this")),
            "no_hint": _ab(lambda: run("other"), lambda: run("this_nohint"))}
        print(f"[b1] {name}: {result['b1'][name]}", flush=True)
        del pt, items, outs
    for name, (C, km, M, S, runs) in RULE_SHAPES.items():
        p1, s1 = _words(g, dev, M + 1, S), _words(g, dev, M + 1, S)
        p1[M] = -1
        s1[M] = -1
        xy = torch.from_numpy(_candidates(rng, C, km, M, runs)).to(dev)
        outs = {w: torch.zeros(2, C, dtype=torch.int32, device=dev)
                for w in libs}

        def run(who):
            outs[who].zero_()
            rc = libs[who][0](p1.data_ptr(), s1.data_ptr(), xy.data_ptr(),
                              outs[who].data_ptr(), C, km, S, 1, M + 1, stream)
            if rc:
                raise RuntimeError(f"{who} rule_support launch: CUDA error {rc}")

        run("other")
        run("this")
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            raise RuntimeError(f"B2 differs between the trees at {name}")
        result["b2"][name] = _ab(lambda: run("other"), lambda: run("this"))
        print(f"[b2] {name}: {result['b2'][name]}", flush=True)
        del p1, s1, xy

    for name, (P, NI, n_live, S) in WAVES.items():
        pt = _words(g, dev, P, S)
        items = _words(g, dev, NI + 3, S)
        items[n_live:NI] = 0
        n_mask, n_arr = NI // 32, P * -(-NI // 64)
        n_buf = P * (NI + n_mask) + n_arr
        bufs = {w: torch.zeros(n_buf, dtype=torch.int32, device=dev)
                for w in ("other", "this", "this_nohint")}
        # the median count over the live lanes: the threshold the wave sees
        ref = EP.extend_count_prune_plain(
            pt.view(P, S, 1), items[:NI].view(NI, S, 1), 1,
            torch.zeros(P, dtype=torch.bool, device=dev))[0]
        thr = max(1, int(ref[:, :n_live].float().median()))

        def run(who):
            buf = bufs[who]
            buf.zero_()
            ptrs = [pt.data_ptr(), items.data_ptr(), buf.data_ptr(),
                    buf[P * NI:].data_ptr(), buf[P * (NI + n_mask):].data_ptr()]
            tree = "other" if who == "other" else "this"
            hint = NI if who == "this_nohint" else n_live
            if live[tree]["extend_prune"]:
                rc = libs[tree][1](*ptrs, P, NI, hint, S, 1, thr, 16 * sms,
                                   stream)
            else:
                rc = libs[tree][1](*ptrs, P, NI, S, 1, thr, 16 * sms, stream)
            if rc:
                raise RuntimeError(f"{who} extend_prune launch: CUDA error {rc}")

        for who in bufs:
            run(who)
        torch.cuda.synchronize()
        if not all(torch.equal(bufs["other"][:P * (NI + n_mask)],
                               bufs[w][:P * (NI + n_mask)]) for w in bufs):
            raise RuntimeError(f"B3 differs between the trees at {name}")
        result["b3"][name] = {
            "thr": thr, "hint": _ab(lambda: run("other"), lambda: run("this")),
            "no_hint": _ab(lambda: run("other"), lambda: run("this_nohint"))}
        print(f"[b3] {name}: {result['b3'][name]}", flush=True)
        del pt, items
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
