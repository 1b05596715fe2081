"""How a configuration reaches the program: one module per entry point,
named by the configuration's ``"entry"`` key.

An entry module defines ``Entry(config, traffic, pool, settings, device)``
(``pool`` from the configuration's data family, ``settings`` the solver's
keyword arguments from its reference) with ``READS``, the configuration
keys it reads (``group.key``), ``device`` (the torch device it runs on)
and

* ``submit(request) -> handle`` — hand one request to the program's
  front door without waiting for its answer, and ``wait(handle) ->
  Outcome``, which returns once the answer is on the host;
* ``inputs(request)`` — the request's (Cx, a, Cy, b) as the program got
  them, for the reference;
* ``counters() -> dict`` and ``reset_counters()`` — the program's own
  counts over the window;
* ``close()`` — stop whatever the entry started.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass
class Outcome:
    """A request's answer as the program gave it."""
    value: float
    rows: Any              # (s,) support rows, on the device
    cols: Any              # (s,) support columns
    T: Any                 # (s,) coupling values
    status: int
    n_iters: int
    fell_back: bool = False

    def to_host(self) -> "Outcome":
        """The same answer with its tensors copied to host memory, so that
        answers kept for the check hold no device memory."""
        return dataclasses.replace(self, rows=self.rows.cpu(),
                                   cols=self.cols.cpu(), T=self.T.cpu())


def outcome_of(output, value: float, fell_back: bool = False) -> Outcome:
    """The Outcome of a ``GWOutput`` with a ``SparseCoupling``."""
    c = output.coupling
    return Outcome(value=value, rows=c.rows, cols=c.cols, T=c.vals,
                   status=int(output.status.code),
                   n_iters=int(output.n_iters), fell_back=fell_back)
