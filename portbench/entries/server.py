"""The served entry: ``GWServer.submit`` / ``result`` (``repro_torch.serve``).

The server is built from the configuration's ``server`` settings
(``"buckets": "default"`` keeps the server's own). A request is a
``QuadraticProblem`` of two of the pool's geometries, built and checked as
the constructor does by default, submitted with no solver, so that the
server's auto-selection picks it, and a generator seeded from the request.
Waiting for it calls ``result``. Set-up checks that auto-selection
resolves to the configuration's solver with the reference's settings,
and fills the server's geometry cache with every pool geometry, as a
catalog would be warmed.
"""
from __future__ import annotations

import torch

from portbench.entries import Outcome, outcome_of
from repro_torch import Geometry, QuadraticProblem, select_solver
from repro_torch.serve import GWServer, ServeConfig
from repro_torch.serve.batching import bucket_for


class Entry:
    READS = ("server.max_batch", "server.max_wait_s", "server.buckets",
             "problem.loss", "solver.name")

    def __init__(self, config: dict, traffic: dict, pool, settings: dict,
                 device):
        self.device = torch.device(device)
        self.loss = config["problem"]["loss"]
        sc = config["server"]
        buckets = ({} if sc["buckets"] == "default"
                   else {"buckets": tuple(int(b) for b in sc["buckets"])})
        self.server = GWServer(ServeConfig(
            max_batch=int(sc["max_batch"]), max_wait_s=float(sc["max_wait_s"]),
            device=self.device, **buckets))
        self.gx = [Geometry(C, pool.a) for C in pool.costs]
        self.gy = [Geometry(C, pool.b) for C in pool.costs]
        got = select_solver(QuadraticProblem(self.gx[0], self.gy[1],
                                             loss=self.loss))
        wrong = {k: (getattr(got, k, None), v) for k, v in settings.items()
                 if getattr(got, k, None) != v}
        if getattr(type(got), "name", None) != config["solver"]["name"] \
                or wrong:
            raise RuntimeError(f"auto-selection gives {got!r}, not the "
                               f"configuration's solver ({wrong})")
        nb = bucket_for(int(traffic["n"]), self.server.config.buckets)
        for g in self.gx + self.gy:
            self.server.cache.warm(g, buckets=(nb,))

    def submit(self, req) -> int:
        problem = QuadraticProblem(self.gx[req.x], self.gy[req.y],
                                   loss=self.loss)
        gen = torch.Generator(device=self.device).manual_seed(req.gen_seed)
        return self.server.submit(problem, generator=gen)

    def wait(self, rid: int) -> Outcome:
        res = self.server.result(rid)
        return outcome_of(res.output, res.value, res.fell_back)

    def inputs(self, req):
        return (self.gx[req.x].cost, self.gx[req.x].weights,
                self.gy[req.y].cost, self.gy[req.y].weights)

    def counters(self) -> dict:
        m = self.server.metrics
        return {"lanes_per_flush": (m.n_lanes / m.n_batches
                                    if m.n_batches else None),
                "flushes": m.n_batches,
                "filler_lanes": m.n_filler_lanes,
                "queue_wait_p50_s": (m.summary()["queue_wait_p50_ms"] / 1e3
                                     if m.n_completed else None)}

    def reset_counters(self) -> None:
        self.server.reset_stats()

    def close(self) -> None:
        self.server.close()
