"""The highest rate a live cell's session sustains: its pushes on ever
faster schedules, each for a short window, in one process.

    python3 flowbench/sweep.py --workload <live cell> --every-ms 20,10,5,... \\
        [--seconds 10] [--seed 1] [--out <file.jsonl>]

For each period, one run of the cell with ``push_every_ms`` set to it (each
push still carries ``push_ms`` of audio): the chunks completed a second,
the 95th percentile of the chunks' latency, and how late the last push was
sent. The session sustains a rate while the lateness stays bounded; above
it the backlog, and the lateness with it, grows all through the window.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "flowbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--every-ms", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    from flowbench.bench import Bench
    from flowbench.cell import run_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = Bench(ROOT)
    out = open(args.out, "a") if args.out else None
    for every in [float(v) for v in args.every_ms.split(",")]:
        traffic = bench.traffic(bench.workload(args.workload)["traffic"])
        traffic["push_every_ms"] = every
        t0 = time.perf_counter()
        result, notes = run_cell(bench, args.workload, args.seed, args.seconds, False, torch.device("cuda", 0), t0,
                                 traffic)
        window = next(n for n in notes if n.startswith("setup_s"))
        rec = {"workload": args.workload, "push_every_ms": every, "correct": result["correct"],
               "chunks_per_s": result["attempted"] / args.seconds,
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}, "notes": window}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
