"""The readings that a cell's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--jobs N] [--out FILE]

For each seed: the cell's inputs from that seed, ``N`` jobs of the mix
(default 1) through the program as a run sends them, every answer judged
against the cell's reference (the program's reading), and the control, the
reference computed in the precision below the one stated (``tf32``) in the
program's place, judged the same way (the control's reading), and the
reference in float32 with TF32 off (a witness of float32's own reach).
One JSON line a seed, with the numbers a run judges its sample by (the
reference's ``aggregate``), the worst request's coupling gap, and each
request's value and coupling gaps, on standard output and in ``FILE``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, name: str, seed: int, jobs: int, device,
             cell=None) -> dict:
    """The worst numbers of the program and of the control on ``seed``."""
    from portbench import harness
    from portbench.entries import Outcome
    from portbench.loadgen import ClosedLoop

    cell = cell or harness.find_cell(bench, name)
    tr, cfg, ref_mod = cell.traffic, cell.config, cell.reference
    settings = cell.settings
    pool = cell.data.make_pool(cfg, int(tr["n"]), int(tr["pool"]), seed,
                               device)
    entry = cell.entry.Entry(cfg, tr, pool, settings, device)
    t0 = time.perf_counter()
    try:
        records = ClosedLoop(entry.submit, entry.wait, tr, seed
                             ).run(0.0, max_jobs=jobs)
    finally:
        entry.close()
    program_s = time.perf_counter() - t0
    out = {"seed": seed, "requests": len(records), "program_s": program_s}
    t0 = time.perf_counter()
    per_request = {}
    for rec in records:
        args = (settings, entry.inputs(rec.request), rec.request.gen_seed)
        ref = ref_mod.answer(*args)
        sides = {"program": rec.outcome}
        for side, precision in (("float32", "float32"), ("control", "tf32")):
            r = ref_mod.answer(*args, precision=precision)
            sides[side] = Outcome(r.value, r.rows, r.cols, r.T, r.status,
                                  r.n_iters)
        for side, got in sides.items():
            per_request.setdefault(side, []).append(
                ref_mod.compare(got, ref))
    for side, nums in per_request.items():
        out[side] = ref_mod.aggregate(nums)
        out[side]["coupling_rel_worst"] = max(r["coupling_rel"]
                                              for r in nums)
    out["per_request"] = {side: [[r["value_rel"], r["coupling_rel"]]
                                 for r in nums]
                          for side, nums in per_request.items()}
    out["reference_s"] = (time.perf_counter() - t0) / 3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload,
                           **readings(bench, args.workload, seed, args.jobs,
                                      "cuda", cell)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
