"""The one general load generator: a closed loop of clients sending jobs.

A traffic mix is a data file, ``portbench/traffic/<mix>.json``::

    {"clients": 2,        # callers, each waiting for its job's answers
     "collection": 8,     # clouds in a job: it asks for all their pairs
     "n": 2048,           # points in each cloud
     "pool": 32,          # clouds made in set-up, which jobs draw from
     "warmup_jobs": 1,    # jobs set-up sends before the window
     "check_sample": 16,  # answers the reference recomputes after a run
     "profile_jobs": 1}   # jobs a traced run profiles after the window

Job j is a collection of ``collection`` distinct clouds of the pool, drawn
from (seed, j), and asks for the distance of each of their pairs (i < j in
the order drawn, the first cloud against the second): ``collection = 2``
sends one pair, ``collection = 8`` all 28 pairs of eight shapes. Client c
sends the jobs c, c + clients, c + 2·clients, ...: it submits every
request of a job, then waits for their answers in order, and sends its
next job once all are back, until the window closes; then every job in
flight is waited for. Request k of job j (P pairs a job) has the index
j·P + k and a generator seed drawn from (seed, index). So one seed gives
one sequence of requests, and every seed the same sizes and arrivals.

An entry (``portbench/entries``) gives ``submit(request) -> handle``,
which must not wait for the answer, and ``wait(handle) -> outcome``. A
request's latency runs from just before its ``submit`` to the return of
its ``wait``.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

KEYS = ("clients", "collection", "n", "pool", "warmup_jobs", "check_sample",
        "profile_jobs")


@dataclass(frozen=True)
class Request:
    index: int
    x: int                 # pool index of the first cloud
    y: int                 # pool index of the second cloud
    gen_seed: int          # seed of the request's torch.Generator


@dataclass
class Record:
    request: Request
    submit_s: float        # host clock when the request was sent
    done_s: float          # host clock when its reply was back
    outcome: Any = None

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submit_s


def check_mix(traffic: dict) -> None:
    """Refuse a mix whose keys are not exactly :data:`KEYS`, or that has
    fewer than two clouds to a job or in the pool."""
    if set(traffic) != set(KEYS):
        raise ValueError(f"a traffic mix has the keys {sorted(KEYS)}; got "
                         f"{sorted(traffic)}")
    if not 2 <= int(traffic["collection"]) <= int(traffic["pool"]):
        raise ValueError("a job's collection holds 2 to `pool` clouds")


def job(seed: int, index: int, traffic: dict) -> List[Request]:
    """The requests of job ``index`` of the sequence of ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % 2**64, 0x6A6F62, index]))
    clouds = rng.choice(int(traffic["pool"]), size=int(traffic["collection"]),
                        replace=False)
    pairs = list(itertools.combinations((int(c) for c in clouds), 2))
    base = index * len(pairs)
    out = []
    for k, (x, y) in enumerate(pairs):
        g = np.random.default_rng(np.random.SeedSequence(
            [seed % 2**64, base + k]))
        out.append(Request(base + k, x, y, int(g.integers(0, 2**63 - 1))))
    return out


def send_job(submit, wait, requests: List[Request],
             keep: Callable[[Any], Any] = lambda outcome: outcome
             ) -> List[Record]:
    """Submit every request of a job, then wait for each answer in order."""
    sent = []
    for req in requests:
        t0 = time.perf_counter()
        sent.append((req, t0, submit(req)))
    out = []
    for req, t0, handle in sent:
        res = wait(handle)
        out.append(Record(req, t0, time.perf_counter(), keep(res)))
    return out


@dataclass
class ClosedLoop:
    """Runs the jobs of ``traffic`` through ``submit`` and ``wait`` from
    ``traffic["clients"]`` threads.

    ``keep(outcome)`` is what a record keeps of an answer, taken in the
    client's thread once the answer is back (its latency is read first).
    """
    submit: Callable[[Request], Any]
    wait: Callable[[Any], Any]
    traffic: dict
    seed: int
    keep: Callable[[Any], Any] = lambda outcome: outcome
    errors: List[BaseException] = field(default_factory=list)

    def run(self, seconds: float, first_job: int = 0,
            max_jobs: Optional[int] = None) -> List[Record]:
        """Send jobs until ``seconds`` have passed (or, with ``max_jobs``,
        until the jobs below that number are sent), wait for those in
        flight, and return this run's records in the order of their
        indices."""
        lock = threading.Lock()
        out: List[Record] = []
        clients = int(self.traffic["clients"])
        t_end = time.perf_counter() + seconds

        def client(c: int):
            j = c
            while True:
                if max_jobs is None and time.perf_counter() >= t_end:
                    return
                if max_jobs is not None and j >= max_jobs:
                    return
                try:
                    recs = send_job(self.submit, self.wait,
                                    job(self.seed, first_job + j,
                                        self.traffic), self.keep)
                except BaseException as err:  # noqa: BLE001 — reported
                    with lock:
                        self.errors.append(err)
                    return
                with lock:
                    out.extend(recs)
                j += clients

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"portbench-client-{c}",
                                    daemon=True)
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.errors:
            raise RuntimeError("a request failed") from self.errors[0]
        out.sort(key=lambda r: r.request.index)
        return out
