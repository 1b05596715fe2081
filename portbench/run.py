"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with the reference beside its limit); the same numbers are the
last lines of standard error. An earlier line names the card, its power
limit, torch's version and the commit. Without a CUDA card, or with fewer
than the cell asks for, the run exits 2 and prints no result; if JAX or
the JAX package was loaded, it exits 3.

The process keeps to the first ``CPUS`` cores it may use: the program's
host threads (the server's worker and flusher, the clients) then stay on
the same cores, which steadies a host-paced run.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPUS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:CPUS])

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec["chips"]):
        print(f"cell {args.workload} needs {spec['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — the program, before any output

    print(json.dumps({"run": harness.card_facts()}), flush=True)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules that a run may not load: {found}",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)               # not portbench/ itself
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
