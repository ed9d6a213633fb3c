"""Run one cell of the benchmark once.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m flowbench.run ...``) from the root of a checkout, on a
machine with the CUDA cards the cell asks for. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones,
read from a torch.profiler trace of the first ``trace_seconds`` of the
window. The last line of standard output is the result, a JSON object; the
numbers compared with the reference are also the last lines of standard
error, each beside its limit. Without enough cards, or with JAX loaded once
the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the folder itself would come first on the path; the
# package is imported from the root instead
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "flowbench":
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "audioflow_tpu")


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of compilers the program may use, at fixed paths inside the checkout
    cache = ROOT / "build" / "flowbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    t_torch = time.perf_counter()
    from flowbench.bench import Bench
    from flowbench.cell import run_cell

    bench = Bench(ROOT)
    chips = int(bench.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"flowbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)  # the CUDA context
    t_cuda = time.perf_counter()
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, notes = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             dev, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"flowbench: the run loaded {bad}; nothing of JAX or the JAX package may load", file=sys.stderr)
        return 3
    print(f"start-up: torch imported at {t_torch - T_START:.3f} s, CUDA context at {t_cuda - T_START:.3f} s",
          file=sys.stderr)
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
