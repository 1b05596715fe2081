"""The library entry for an unbalanced problem:
``repro_torch.solve(QuadraticProblem(..., lam=λ), solver)``.

As ``solve``, with the configuration's ``problem.lam`` on every request's
problem, so the solver runs its unbalanced path (Alg. 3). A request's
inputs for the reference are its (Cx, a, Cy, b) and λ.
"""
from __future__ import annotations

import torch

from portbench.entries import Outcome, outcome_of
from portbench.entries import solve as balanced
from repro_torch import QuadraticProblem, solve


class Entry(balanced.Entry):
    READS = balanced.Entry.READS + ("problem.lam",)

    def __init__(self, config: dict, traffic: dict, pool, settings: dict,
                 device):
        super().__init__(config, traffic, pool, settings, device)
        self.lam = float(config["problem"]["lam"])

    def wait(self, req) -> Outcome:
        problem = QuadraticProblem(self.gx[req.x], self.gy[req.y],
                                   loss=self.loss, lam=self.lam)
        gen = torch.Generator(device=self.device).manual_seed(req.gen_seed)
        out = solve(problem, self.solver, generator=gen, device=self.device)
        return outcome_of(out, float(out.value))

    def inputs(self, req):
        return super().inputs(req) + (self.lam,)
