"""The benchmark's harness: one cell, one run.

Everything that belongs to one configuration, one traffic mix or one
metric is found by its name in ``BENCHMARK.json``:

* the cell's configuration file (``configs`` → ``file``), which names the
  modules that serve it: ``"entry"``, the module of ``portbench/entries/``
  that drives the program; ``problem.family``, the module of
  ``portbench/data/`` that makes its inputs; ``"reference"``, the module of
  ``portbench/reference/`` that gives the solver's settings and judges
  the answers. A configuration key that none of them, nor the harness,
  reads (their ``READS``) is refused;
* the traffic mix, ``portbench/traffic/<traffic>.json``, read by the one
  load generator (``portbench/loadgen.py``);
* each metric's reader, ``portbench/metrics/<metric name>.py``, a module
  with ``read(ctx) -> float or None``; ``None`` leaves the metric out of
  the result line.

A run sets up (inputs from the seed, the entry, a warm-up of the cell's
own jobs), measures a closed loop for the window, then checks a sample of
the window's answers against the plain reference and prints the result
line.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import devtrace, loadgen, stats
from portbench.loadgen import ClosedLoop, Record

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_BASE = 1 << 40           # warm-up and profiled jobs never
PROFILE_BASE = 1 << 41          # repeat a timed one
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STALLED = 2                     # status codes from STALLED up are failures
READS = ("name", "source", "reduced", "assumed", "guarantees", "entry",
         "reference", "problem.family", "limits")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict                   # the cell's entry in BENCHMARK.json
    config: dict                 # the configuration file
    traffic: dict                # the traffic mix file

    @property
    def entry(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.entries.{self.config['entry']}")

    @property
    def data(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.data.{self.config['problem']['family']}")

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"portbench.reference.{self.config['reference']}")

    @property
    def settings(self) -> dict:
        """The solver's settings at the mix's cloud size."""
        return self.reference.program_settings(self.config,
                                               int(self.traffic["n"]))


def unread_keys(config: dict, reads) -> List[str]:
    """Keys of ``config`` (``key``, or ``group.key`` inside a group) that
    no name of ``reads`` covers; a group named whole covers its keys."""
    out = []
    for key, value in config.items():
        if key in reads:
            continue
        if isinstance(value, dict):
            out += [f"{key}.{k}" for k in value if f"{key}.{k}" not in reads]
        else:
            out.append(key)
    return out


def check_cell(cell: Cell) -> None:
    """Refuse a cell whose mix or configuration holds a key that nothing
    reads, or whose limits are not the reference's numbers."""
    loadgen.check_mix(cell.traffic)
    reads = set(READS) | set(cell.entry.Entry.READS) | set(cell.data.READS) \
        | set(cell.reference.READS)
    unread = unread_keys(cell.config, reads)
    if unread:
        raise ValueError(f"configuration {cell.config['name']}: nothing "
                         f"reads {unread}")
    if set(cell.config["limits"]) != set(cell.reference.NUMBERS):
        raise ValueError(f"configuration {cell.config['name']}: limits "
                         f"must bound {list(cell.reference.NUMBERS)}")
    cell.settings                # refuses what the reference cannot judge


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration and mix."""
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                       f"{', '.join(w['name'] for w in bench['workloads'])})")
    cfg = next(c for c in bench["configs"] if c["name"] == spec["config"])
    cell = Cell(name, spec, load_json(root / cfg["file"]),
                load_json(HERE / "traffic" / f"{spec['traffic']}.json"))
    check_cell(cell)
    return cell


def metric_specs(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on."""
    specs = bench["per_layer" if trace else "end_to_end"]
    return [m for m in specs if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """The reader module of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a metric reader sees of a run."""
    cell: Cell
    records: List[Record]        # the window's requests, drained
    start_s: float               # host clock: the window's first request
    end_s: float                 # host clock: the window's close
    setup_s: float
    peak_bytes: Optional[int]    # max_memory_allocated over the window
    counters: Dict[str, Any]     # the entry's own counts over the window
    spans: List[dict]            # program spans that began in the window
    trace: Optional[devtrace.Summary]   # the traced rounds after the window

    @property
    def n(self) -> int:
        return int(self.cell.traffic["n"])

    @property
    def settings(self) -> dict:
        return self.cell.settings

    @property
    def loss(self) -> str:
        return self.cell.config["problem"]["loss"]

    def span_durations(self, name: str) -> List[float]:
        return [r["duration_s"] for r in self.spans if r["name"] == name]


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules (``sys.modules`` by default) that
    a run may not load, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_facts() -> dict:
    """The card's name and power limit, torch's version and the commit (or,
    outside a git checkout, a digest of the program's sources)."""
    facts = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        facts["card"] = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        facts["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        facts["nvidia_smi"] = "not available"
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=20)
        facts["commit"] = out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        facts["commit"] = None
    h = hashlib.sha256()
    for p in sorted((ROOT / "src" / "repro_torch").rglob("*")):
        if p.suffix in (".py", ".cu") and "__pycache__" not in p.parts:
            h.update(p.relative_to(ROOT).as_posix().encode())
            h.update(p.read_bytes())
    facts["program_digest"] = h.hexdigest()[:16]
    return facts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span_offset() -> float:
    """What turns a program span's ``start_s`` into the host clock."""
    from repro_torch.obs import span
    with span("portbench.clock") as rec:
        t = time.perf_counter()
    return t - rec["start_s"]


def _profiled_rounds(entry, traffic: dict, seed: int
                     ) -> devtrace.Summary:
    """The traced interval: after the window has drained, the calling
    thread sends ``profile_jobs`` jobs of the mix, each waited for, under
    the profiler. So no thread starts or ends while the profiler runs; the
    window is not slowed by it, nor by its start-up, which leaves the host
    slower after it; and the profiler's stop, which stalls the process for
    seconds, falls after the work."""
    devtrace.warm_up(entry.device)
    prof = devtrace.Profiler()
    prof.start()
    done = 0
    for j in range(int(traffic["profile_jobs"])):
        done += len(loadgen.send_job(
            entry.submit, entry.wait,
            loadgen.job(seed, PROFILE_BASE + j, traffic)))
    from repro_torch.obs import spans
    summary = prof.stop(spans(), _span_offset())
    summary.requests = done
    return summary


def check(cell: Cell, entry, records: List[Record], seed: int
          ) -> Dict[str, dict]:
    """Recompute a sample of the window's answers (drawn from the seed)
    with the cell's plain reference; the sample's numbers (the
    reference's ``aggregate``), each beside its limit."""
    k = min(int(cell.traffic["check_sample"]), len(records))
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64,
                                                        0x636865636B]))
    picked = sorted(rng.choice(len(records), size=k, replace=False))
    ref_mod, settings = cell.reference, cell.settings
    readings = []
    for i in picked:
        rec = records[i]
        ref = ref_mod.answer(settings, entry.inputs(rec.request),
                             rec.request.gen_seed)
        readings.append(ref_mod.compare(rec.outcome, ref))
    got = ref_mod.aggregate(readings)
    limits = cell.config["limits"]
    return {key: {"value": got.get(key, math.inf), "limit": limits[key]}
            for key in limits}


def _spreads(ctx: Context) -> dict:
    """Where the window's latencies and flushes lie (min, quartiles, p95,
    max): what a reader of a noisy tail looks at first."""
    out = {}
    for key, vals in (("latency_s", [r.latency_s for r in ctx.records]),
                      ("flush_s", ctx.span_durations("serve.dispatch")),
                      ("dispatch_s", ctx.span_durations("solve.dispatch"))):
        if len(vals) >= 2:
            q1, q2, q3 = statistics.quantiles(vals, n=4)
            out[key] = [min(vals), q1, q2, q3,
                        stats.percentile(vals, 95), max(vals)]
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, t_process: float,
             cell: Optional[Cell] = None) -> dict:
    """One run of cell ``name`` (its files as found, or ``cell``); returns
    the result line's object."""
    cell = cell or find_cell(bench, name)
    traffic, device = cell.traffic, torch.device(device)
    cuda = device.type == "cuda"
    pool = cell.data.make_pool(cell.config, int(traffic["n"]),
                               int(traffic["pool"]), seed, device)
    entry = cell.entry.Entry(cell.config, traffic, pool, cell.settings,
                             device)
    try:
        loop = ClosedLoop(entry.submit, entry.wait, traffic, seed,
                          keep=lambda out: out.to_host())
        loop.run(0.0, first_job=WARMUP_BASE,
                 max_jobs=int(traffic["warmup_jobs"]))
        _sync(device)
        from repro_torch.obs import clear_spans, spans
        clear_spans()
        entry.reset_counters()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        setup_s = start - t_process
        records = loop.run(seconds)
        end = start + seconds
        _sync(device)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        offset = _span_offset()
        window_spans = [r for r in spans()
                        if start <= r["start_s"] + offset <= end]
        counters = entry.counters()
        summary = _profiled_rounds(entry, traffic, seed) if trace else None
        ctx = Context(cell, records, start, end, setup_s, peak, counters,
                      window_spans, summary)
    finally:
        entry.close()
    metrics = {}
    for m in metric_specs(bench, name, trace):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for r in records
                 if r.outcome.status >= STALLED
                 or not math.isfinite(r.outcome.value))
    checks = {"failed": {"value": failed, "limit": 0},
              **check(cell, entry, records, seed)}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct), "attempted": len(records),
        "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": 1, "memory_peak_bytes": peak},
    }
    tf = devtrace.trace_fields(ctx.trace)
    if tf:
        result["device"].update(busy_s=tf["busy_s"],
                                window_s=tf["window_s"])
        result["breakdown"] = tf["breakdown"]
    result["counters"] = dict(ctx.counters, **_spreads(ctx))
    result["checks"] = checks
    return result
