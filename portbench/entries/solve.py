"""The library entry: ``repro_torch.solve(problem, solver)``.

The solver is ``solver.name`` of the program's registry, built from the
reference's settings. Each request builds a ``QuadraticProblem`` from two
of the pool's geometries (checked, as the constructor does by default)
and calls the front door with that solver and a generator seeded from the
request; the call returns once the value is on the host.
"""
from __future__ import annotations

import torch

from portbench.entries import Outcome, outcome_of
from repro_torch import Geometry, QuadraticProblem, solve
from repro_torch.api.solvers import get_solver


class Entry:
    READS = ("problem.loss", "solver.name")

    def __init__(self, config: dict, traffic: dict, pool, settings: dict,
                 device):
        self.device = torch.device(device)
        self.loss = config["problem"]["loss"]
        self.solver = get_solver(config["solver"]["name"])(**settings)
        self.gx = [Geometry(C, pool.a) for C in pool.costs]
        self.gy = [Geometry(C, pool.b) for C in pool.costs]

    def submit(self, req):
        return req                  # the call below is the whole request

    def wait(self, req) -> Outcome:
        problem = QuadraticProblem(self.gx[req.x], self.gy[req.y],
                                   loss=self.loss)
        gen = torch.Generator(device=self.device).manual_seed(req.gen_seed)
        out = solve(problem, self.solver, generator=gen, device=self.device)
        return outcome_of(out, float(out.value))

    def inputs(self, req):
        return (self.gx[req.x].cost, self.gx[req.x].weights,
                self.gy[req.y].cost, self.gy[req.y].weights)

    def counters(self) -> dict:
        return {}

    def reset_counters(self) -> None:
        pass

    def close(self) -> None:
        pass
