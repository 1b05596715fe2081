"""``GWServer`` — the batched, cached, observable solve front door
(counterpart of ``repro.serve.server``).

Request lifecycle:

    server = GWServer(ServeConfig())             # on the CUDA card
    rid = server.submit(problem, solver="spar_gw",
                        generator=torch.Generator("cuda").manual_seed(0))
    server.poll(rid)        # "queued" | "running" | "done"
    res = server.result(rid)            # blocks; RequestResult

``submit`` resolves the solver (same rules as ``repro_torch.solve``),
pads both geometries to size buckets through the :class:`GeometryCache`
(on the server's device), records the caller's generator state, and
enqueues the request under its **batch signature**
(``serve/batching.py``). A bucket flushes when it reaches ``max_batch``
requests or its oldest request is older than ``max_wait_s`` — enforced
by a background flusher thread (daemon, ticks at ``max_wait_s / 4``;
``ServeConfig(flush_thread=False)`` checks the deadline only on
submit/poll/result/flush calls). Server state is guarded by one
re-entrant lock.

A flush tops the bucket up with filler lanes (replicas of lane 0 with
fault hooks disarmed) to a power of two and hands it to the server's
one **worker thread**, which runs flushes in order on the device, each
as one lane-batched solve where the family has one
(``serve/lanes.py``). Dispatch is asynchronous: ``submit`` never waits
on a solve, ``poll`` says ``running`` until the flush is done, and
``result`` waits on the flush outside the server lock, so the next
bucket accumulates while the device computes.

Generators: ``submit`` records the caller's generator state
(``get_state()``); the lane's draw and a later fallback both start from
it, each on a generator of its own, so the caller's generator is not
advanced and a fallback draws what a solo solve from that state draws.

Failure semantics are **per request**: each lane carries its own
:class:`~repro_torch.health.status.SolveStatus` (one poisoned request
cannot touch its bucket-mates' bits), and a lane that comes back
DIVERGED/STALLED is — under ``on_failure="fallback"`` — re-solved solo
through ``repro_torch.solve(..., on_failure="fallback")`` at its original
shape, walking the solver ladder for that request only.

Telemetry: the spans ``serve.submit`` (attribute ``rid``),
``serve.pad``, ``serve.dispatch`` (the worker's run of a flush:
``lanes``, ``source``, ``route``, ``rids``, the real lanes' request ids
in lane order, and ``queued_s``, how long the flush waited in the
worker's queue), ``serve.block`` (``rid``) and ``serve.fallback``
(``rid``); inside ``serve.dispatch`` the solver's spans (``solver.*``,
``serve/lanes.py``) and a ``solver.host_read`` (site ``values``) for the
values' read; and the ``repro_serve_*`` / ``repro_cache_*`` counters of
:class:`ServeMetrics` and :class:`GeometryCache`.
"""
from __future__ import annotations

import math
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.api.problem import QuadraticProblem
from repro_torch.api.solve import select_solver, solve
from repro_torch.api.solvers import get_solver
from repro_torch.health.status import STALLED, STATUS_NAMES
from repro_torch.kernels import dispatch
from repro_torch.obs.registry import registry
from repro_torch.obs.span import span
from repro_torch.serve.batching import (
    DEFAULT_BUCKETS,
    GeneratorState,
    batch_signature,
    bucket_for,
    disarm_fault,
    next_pow2,
    pad_problem,
    stack_items,
)
from repro_torch.serve.cache import GeometryCache
from repro_torch.serve.lanes import lane_route, run_lanes
from repro_torch.serve.metrics import ServeMetrics


@dataclass(frozen=True)
class ServeConfig:
    """Server policy knobs.

    buckets       — geometry-size buckets requests are padded up to
    max_batch     — flush a bucket once it holds this many requests
    max_wait_s    — flush a non-empty bucket once its oldest request has
                    waited this long (enforced by the flusher thread;
                    with ``flush_thread=False``, checked cooperatively on
                    every server call)
    flush_thread  — run a background daemon thread that ticks every
                    ``max_wait_s / 4`` and flushes overdue buckets
    cache_entries — GeometryCache capacity (artifacts, LRU)
    on_failure    — per-request policy for unhealthy lanes: "none"
                    returns the DIVERGED/STALLED output as-is; "fallback"
                    re-solves the request solo via
                    ``repro_torch.solve(on_failure="fallback")``
    device        — where the server solves: default the CUDA card
                    (raises without one); ``"cpu"`` runs the plain
                    versions of the kernels

    The reference's ``donate`` and ``compilation_cache_dir`` have no
    counterpart. PyTorch has no buffer donation. The port compiles
    nothing per shape: its only compiled artifacts are the
    content-addressed kernel libraries in ``build/kernels/``
    (``kernels/cuda_lib.py``), which a fresh process already reuses.
    """
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_batch: int = 8
    max_wait_s: float = 0.02
    flush_thread: bool = True
    cache_entries: int = 128
    on_failure: str = "fallback"
    device: Any = None

    def __post_init__(self):
        if self.on_failure not in ("none", "fallback"):
            raise ValueError(
                f"on_failure must be 'none' or 'fallback', got "
                f"{self.on_failure!r}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")


@dataclass
class RequestResult:
    """One request's outcome.

    output is the lane's ``GWOutput`` at the *padded* bucket shape
    (``padded_shape``) — or, when ``fell_back``, the fallback solve's
    output at the original shape. ``coupling_dense()`` always returns the
    original-shape coupling.
    """
    rid: int
    value: float
    output: Any
    status: Any                       # per-request SolveStatus
    status_name: str
    failed: bool                      # unhealthy after the batched attempt
    fell_back: bool                   # recovered via the solver ladder
    shape: Tuple[int, int]            # original (m, n)
    padded_shape: Tuple[int, int]
    latency_s: float

    def coupling_dense(self):
        m, n = self.shape
        dense = self.output.coupling_dense(*(
            self.shape if self.fell_back else self.padded_shape))
        return dense[:m, :n]


@dataclass
class _Request:
    rid: int
    problem: QuadraticProblem         # original, unpadded
    solver: Any
    generator: Optional[GeneratorState]
    item: Any                         # (padded problem, solver, generator)
    sig: Any
    shape: Tuple[int, int]
    padded_shape: Tuple[int, int]
    submitted_at: float
    state: str = "queued"             # queued -> running -> done
    batch: Any = None
    lane: int = -1
    result: Optional[RequestResult] = None


@dataclass
class _Batch:
    """One flush: its lanes' items, run by the worker thread."""
    items: Optional[list]             # (problem, solver, generator) a lane
    rids: List[int]                   # real lanes, in lane order
    n_lanes: int
    source: str
    dispatched_at: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    outputs: Optional[list] = None    # one GWOutput a lane
    values: Optional[list] = None     # their values, read on the host
    error: Optional[BaseException] = None

    def run(self) -> None:
        """Solve every lane, read the values on the host, mark done. An
        exception is kept for ``result`` to raise."""
        queued_s = time.perf_counter() - self.dispatched_at
        try:
            problem, solver = self.items[0][:2]
            with span("serve.dispatch", lanes=self.n_lanes,
                      source=self.source, route=lane_route(problem, solver),
                      rids=list(self.rids), queued_s=queued_s):
                self.outputs = run_lanes(stack_items(self.items))
                values = torch.stack(
                    [o.value.detach().float() for o in self.outputs])
                with span("solver.host_read", site="values"):
                    self.values = values.tolist()
        except Exception as err:  # noqa: BLE001 — re-raised by result()
            self.error = err
        finally:
            self.items = None             # the stacked inputs, for GC
            self.done.set()


def _worker_main(jobs: "queue.Queue") -> None:
    """The worker thread: run flushes in the order they were queued until
    the None sentinel."""
    while True:
        batch = jobs.get()
        if batch is None:
            return
        batch.run()


def _flusher_main(server_ref, interval_s: float,
                  stop: threading.Event) -> None:
    """Wall-clock flusher loop: pump overdue buckets every ``interval_s``.

    Holds only a weakref to the server so an abandoned (un-``close``d)
    server can still be garbage collected; the loop exits when the
    server dies or ``stop`` is set.
    """
    while not stop.wait(interval_s):
        server = server_ref()
        if server is None:
            return
        try:
            server._pump(source="timer")
        except Exception:  # noqa: BLE001 — the flusher must outlive hiccups
            registry().counter("repro_serve_flusher_errors_total",
                               "exceptions caught by the flusher").inc()
        del server


class GWServer:
    """Batched, cached, observable front door over the solver registry."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self.device = dispatch.resolve_device(self.config.device)
        self.cache = GeometryCache(self.config.cache_entries,
                                   device=self.device)
        self.metrics = ServeMetrics()
        self._requests: Dict[int, _Request] = {}
        self._queues: Dict[Any, List[int]] = {}
        self._next_rid = 0
        self._lock = threading.RLock()
        self._jobs: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=_worker_main, args=(self._jobs,), name="gwserver-worker",
            daemon=True)
        self._worker.start()
        self._flusher_stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if self.config.flush_thread and self.config.max_wait_s > 0:
            self._flusher = threading.Thread(
                target=_flusher_main,
                args=(weakref.ref(self), self.config.max_wait_s / 4,
                      self._flusher_stop),
                name="gwserver-flusher", daemon=True)
            self._flusher.start()

    def close(self) -> None:
        """Stop the flusher thread and the worker thread once it has run
        the flushes queued so far (idempotent). Queued requests stay
        retrievable via ``result``/``results``: after ``close`` a flush
        runs in the calling thread."""
        self._flusher_stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=1.0)
            self._flusher = None
        with self._lock:
            worker, self._worker = self._worker, None
            if worker is not None:
                self._jobs.put(None)
        if worker is not None:
            worker.join()

    def __del__(self):
        try:
            self._flusher_stop.set()
            self._jobs.put(None)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- submit -------------------------------------------------------------

    def submit(self, problem: QuadraticProblem,
               solver: Union[str, Any, None] = None,
               generator: Optional[torch.Generator] = None,
               validate: bool = True) -> int:
        """Enqueue one solve request; returns its request id."""
        with span("serve.submit") as sp:
            if solver is None:
                solver = select_solver(problem)
            elif isinstance(solver, str):
                solver = get_solver(solver).default_config(
                    max(problem.shape))
            if generator is None and getattr(type(solver), "requires_key",
                                             False):
                raise ValueError(
                    f"{type(solver).__name__} draws at random and needs a "
                    f"generator: submit(problem, solver, generator="
                    f"torch.Generator(device).manual_seed(seed))")
            if validate and not getattr(problem, "_validated", False):
                problem.check()
            m, n = problem.shape
            mb = bucket_for(m, self.config.buckets)
            nb = bucket_for(n, self.config.buckets)
            with span("serve.pad"):
                padded = pad_problem(
                    problem, mb, nb,
                    geom_x=self.cache.padded(problem.geom_x, mb),
                    geom_y=self.cache.padded(problem.geom_y, nb)
                ).to(self.device)
            state = None if generator is None else GeneratorState.of(
                generator)
            item = (padded, solver, state)
            sig = batch_signature(item)
            with self._lock:
                rid = sp["rid"] = self._next_rid
                self._next_rid += 1
                req = _Request(rid=rid, problem=problem, solver=solver,
                               generator=state, item=item, sig=sig,
                               shape=(m, n), padded_shape=(mb, nb),
                               submitted_at=self.metrics.record_submit())
                self._requests[rid] = req
                self._queues.setdefault(sig, []).append(rid)
                if len(self._queues[sig]) >= self.config.max_batch:
                    self._flush_bucket(sig, source="full")
                else:
                    self._pump()
            return rid

    # -- flushing -----------------------------------------------------------

    def _pump(self, source: str = "call") -> None:
        """Flush every bucket whose oldest request exceeded max_wait_s.
        ``source`` tags the dispatch span: "call" for cooperative checks
        on server calls, "timer" for the background flusher thread."""
        with self._lock:
            now = time.perf_counter()
            for sig in list(self._queues):
                rids = self._queues[sig]
                if rids and (now - self._requests[rids[0]].submitted_at
                             >= self.config.max_wait_s):
                    self._flush_bucket(sig, source=source)

    def flush(self) -> None:
        """Dispatch every non-empty bucket immediately."""
        with self._lock:
            for sig in list(self._queues):
                if self._queues[sig]:
                    self._flush_bucket(sig, source="flush")

    def _flush_bucket(self, sig, source: str = "call") -> None:
        with self._lock:
            rids = self._queues.pop(sig, [])
            if not rids:
                return
            n_lanes = next_pow2(len(rids))
            items = [self._requests[rid].item for rid in rids]
            p0, s0, g0 = items[0]
            items += [(p0, disarm_fault(s0), g0)] * (n_lanes - len(rids))
            batch = _Batch(items=items, rids=rids, n_lanes=n_lanes,
                           source=source)
            self.metrics.record_batch(len(rids), n_lanes)
            for lane, rid in enumerate(rids):
                req = self._requests[rid]
                req.state = "running"
                req.batch = batch
                req.lane = lane
            if self._worker is not None:
                self._jobs.put(batch)
            else:                         # closed: run it here
                batch.run()

    # -- poll / result ------------------------------------------------------

    def poll(self, rid: int) -> str:
        """Non-blocking state of a request: queued / running / done.
        Also advances time-based flushes (cooperative scheduling)."""
        self._pump()
        with self._lock:
            req = self._req(rid)
            if req.state == "running" and req.batch.done.is_set():
                return "done"
            return req.state

    def result(self, rid: int) -> RequestResult:
        """Block until the request's flush completes; per-request
        outcome. Raises what the flush raised (a kernel that failed to
        build or launch)."""
        with self._lock:
            req = self._req(rid)
            if req.result is not None:
                return req.result
            if req.state == "queued":
                self._flush_bucket(req.sig)
            batch, lane = req.batch, req.lane
        # wait outside the lock: the flusher and other submitters keep
        # running while the worker computes
        with span("serve.block", rid=rid):
            batch.done.wait()
        if batch.error is not None:
            raise RuntimeError(
                f"the flush of request {rid} failed") from batch.error
        out, value = batch.outputs[lane], batch.values[lane]
        failed = out.status.code >= STALLED or not math.isfinite(value)
        fell_back = False
        if failed and self.config.on_failure == "fallback":
            with span("serve.fallback", rid=rid) as sp:
                out, fell_back = self._fallback(req, out, sp)
            if fell_back:
                value = float(out.value)
        with self._lock:
            if req.result is not None:     # lost a race to another thread
                return req.result
            latency = self.metrics.record_result(
                req.submitted_at, batch.dispatched_at, failed, fell_back)
            req.state = "done"
            req.result = RequestResult(
                rid=rid, value=value, output=out, status=out.status,
                status_name=STATUS_NAMES[out.status.code], failed=failed,
                fell_back=fell_back, shape=req.shape,
                padded_shape=req.padded_shape, latency_s=latency)
            req.batch = None          # release the flush for GC
            req.item = None
            return req.result

    def results(self, rids: Sequence[int]) -> List[RequestResult]:
        """Drain a set of requests (flushes any still queued)."""
        self.flush()
        return [self.result(rid) for rid in rids]

    def _fallback(self, req: _Request, lane_out, sp: dict):
        """Re-solve one failed request solo through the solver ladder, at
        its original (unpadded) shape, from its recorded generator state.
        Returns ``(output, fell_back)``: the lane's own output when the
        ladder does not recover (or raises: the error is noted on the
        ``serve.fallback`` span)."""
        generator = None if req.generator is None else \
            req.generator.restore()
        try:
            out = solve(req.problem, req.solver, generator=generator,
                        device=self.device, on_failure="fallback")
        except Exception as err:  # noqa: BLE001 — fallback is best-effort
            sp["error"] = repr(err)
            return lane_out, False
        recovered = (out.status.code < STALLED
                     and math.isfinite(float(out.value)))
        return (out, True) if recovered else (lane_out, False)

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """One flat dict: request/batch/latency metrics + cache counters."""
        return self.metrics.summary(self.cache.stats())

    def metrics_text(self) -> str:
        """The process-wide metrics registry (including this server's
        ``repro_serve_*`` series) in Prometheus text exposition format —
        the payload ``launch/serve.py --metrics-port`` serves."""
        return registry().prometheus_text()

    def reset_stats(self) -> None:
        """Zero metrics and cache counters, keeping cached artifacts warm —
        the steady-state measurement hook."""
        self.metrics = ServeMetrics()
        self.cache.reset_counters()

    def _req(self, rid: int) -> _Request:
        try:
            return self._requests[rid]
        except KeyError:
            raise KeyError(f"unknown request id {rid}") from None
