"""The output check over databases drawn from other seeds.

A run's seed relabels the one database that the configuration's
``base_seed`` draws (``gen/synth.py``), so that every run does the same
work.  This check draws a new database from each seed it is given (the
seed in the place of ``base_seed``, then relabelled by it), so the number
of frequent items and patterns, the supports near the threshold and the
engines' queue and pool occupancy all change.  On each it runs the cell's
miner as a run does (the mix's set-up mines, then one mine more), frees
the program's state, and holds that last mine to the reference with a
run's comparison.

    python3 fsmbench/drawn.py --workload <cell> --seeds 1,2,3

It needs the card(s) the cell asks for.  Prints one line a seed and, last,
a JSON object with each seed's ``worst_mine_mismatch`` (limit 0).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(workload: str, seeds, bench=None, device: str = "cuda",
             log=sys.stdout) -> dict:
    """``{seed: {"mismatch", "patterns", "path_taken"}}`` for databases
    drawn from each seed."""
    from fsmbench.harness import Bench, _device_checks, _passes, _sync, \
        compare

    bench = bench or Bench()
    cell = bench.cell(workload)
    _device_checks(device, int(cell["chips"]))
    cfg = bench.load_json("configs", cell["config"])
    mix = bench.load_json("traffic", cell["traffic"])
    algo = bench.module("algos", cfg["algorithm"])
    gen = bench.module("gen", "synth")
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        db = gen.make_db(dict(cfg["data"], base_seed=seed), seed)
        miner = algo.miner(cfg, mix, device)
        for _ in range(int(mix.get("warm_mines", 1))):
            miner.mine(db)
        got, stats = miner.mine(db)
        _sync(device)
        taken = _passes(stats, mix.get("fail_unless", ()))
        miner.close()
        del miner
        gc.collect()
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()
        want = algo.reference(cfg, db)
        out[seed] = {"mismatch": compare(got, want), "patterns": len(want),
                     "path_taken": taken}
        print(f"seed {seed}: worst_mine_mismatch {out[seed]['mismatch']} "
              f"(limit 0) over {len(want)} patterns, cell's path "
              f"{'taken' if taken else 'NOT taken'}, "
              f"{time.perf_counter() - t0:.1f} s", file=log, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    from fsmbench.harness import RunError

    try:
        got = readings(args.workload,
                       [int(s) for s in args.seeds.split(",")])
    except RunError as exc:
        print(f"fsmbench: {exc}", file=sys.stderr)
        return exc.code
    print(json.dumps({"workload": args.workload, "drawn": got,
                      "worst": max(g["mismatch"] for g in got.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
