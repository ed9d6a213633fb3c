"""Sets of runs of cells, each run its own process, and their spreads.

    python3 flowbench/sets.py --workloads a,b --seeds 11,12,13 [--sets 2] \\
        [--seconds 30] [--trace 0] [--out <file.jsonl>]

Runs ``flowbench/run.py`` once for each workload, set and seed, a cell's
runs one after another, and records each run's result line, exit code,
wall seconds and the end of its standard error. Then, for each workload and
metric, each set's median and its spread: the distance between the first
and third quartiles (``statistics.quantiles(n=4)``) as a share of the
median, and five times the wider spread, the bound it would give.
``--seconds`` defaults to ``run_seconds`` of ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "flowbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench.stats import quartile_spread  # noqa: E402


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "flowbench" / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    rec = {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0, "stderr_tail": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def spreads(records: list[dict]) -> dict:
    out = {}
    for wl in dict.fromkeys(r["workload"] for r in records):
        by_set: dict = {}
        for r in records:
            if r["workload"] == wl and "result" in r:
                for k, m in r["result"]["metrics"].items():
                    by_set.setdefault(k, {}).setdefault(r["set"], []).append(m["value"])
        out[wl] = {}
        for k, sets in by_set.items():
            row = {}
            for s, vals in sorted(sets.items()):
                row[f"set{s}"] = {"median": statistics.median(vals), "n": len(vals),
                                  "spread": quartile_spread(vals) if len(vals) >= 2 else None, "values": vals}
            widest = max((v["spread"] for v in row.values() if v["spread"] is not None), default=None)
            row["bound_5x"] = None if widest is None else 5 * widest
            out[wl][k] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    records = []
    out = open(args.out, "a") if args.out else None
    for wl in args.workloads.split(","):
        for s in range(args.sets):
            for seed in [int(x) for x in args.seeds.split(",")]:
                rec = one(wl, seed, seconds, args.trace)
                rec["set"] = s
                records.append(rec)
                res = rec.get("result", {})
                short = {k: round(v["value"], 4) for k, v in res.get("metrics", {}).items()}
                print(f"{wl} set {s} seed {seed} rc {rec['rc']} {rec['wall_s']:.1f} s correct {res.get('correct')} "
                      f"{short} checks {({k: v['value'] for k, v in res.get('checks', {}).items()})}", flush=True)
                print("  " + " | ".join(ln for ln in rec["stderr_tail"].splitlines()
                                        if ln.startswith(("setup_s", "start-up", "rows left"))), flush=True)
                if rec["rc"] != 0 or not res.get("correct"):
                    print(rec["stderr_tail"][-1500:], flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    summary = spreads(records)
    print(json.dumps(summary, indent=1))
    if out:
        out.write(json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
