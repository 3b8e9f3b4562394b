"""The control of a cell's comparison: the plain reference put in the
port's place with its supports held in float16 (``fast.count_fp16``: exact
up to 2,048, rounded above), judged by the same comparison a run makes
(``harness.compare``) against the exact reference on the same database.
A sound comparison finds it wrong on every seed.

    python3 fsmbench/control.py --workload <cell> --seeds 1,2,3

It runs at the cell's own size on the host and imports nothing of the
port.  Prints one line a seed and, last, a JSON object with the readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(workload: str, seeds, bench=None) -> dict:
    from fsmbench.harness import Bench, compare
    from fsmbench.reference import fast

    bench = bench or Bench()
    cell = bench.cell(workload)
    cfg = bench.load_json("configs", cell["config"])
    algo = bench.module("algos", cfg["algorithm"])
    gen = bench.module("gen", "synth")
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        db = gen.make_db(cfg["data"], seed)
        want = algo.reference(cfg, db)
        got = algo.reference(cfg, db, count=fast.count_fp16)
        out[seed] = compare(got, want)
        print(f"seed {seed}: control worst_mine_mismatch {out[seed]} "
              f"(limit 0) over {len(want)} patterns, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    args = ap.parse_args(argv)
    got = readings(args.workload, [int(s) for s in args.seeds.split(",")])
    print(json.dumps({"workload": args.workload, "control": got,
                      "smallest": min(got.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
