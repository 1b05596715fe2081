"""Solve-lifecycle spans: lightweight host-side timing scopes
(counterpart of ``repro.obs.span``).

A span is a named wall-clock interval::

    from repro_torch import obs

    with obs.span("solve.dispatch"):
        out = solver.run(problem, generator=gen)

Spans nest (the active stack is thread-local, so concurrent threads never
corrupt each other's nesting) and each completed span is appended to one
process-wide bounded ring, which :func:`spans` snapshots and
:func:`repro_torch.obs.report` aggregates into the per-stage lifecycle
breakdown (select → validate → dispatch → fallback).

A span times the host's wall clock and adds no device synchronisation:
work a span launches on the card may still be running when it closes
(``solve`` itself reads the loop's health verdict on the host every outer
iteration, so a solve's span covers its device work up to the last
iteration's value recomputation).

The record a span yields is a plain dict; callers may attach attributes
mid-flight (``with span("dispatch") as sp: ...; sp["recovered"] = True``).

Each record also carries a process-unique ``id``, its enclosing span's
``parent_id`` and a roll-up ``sub``: a span that closes adds itself to
every span still open on its thread's stack, as ``sub[name] = [count,
seconds]``. So a ``solve.dispatch`` record holds the totals of the
``solver.*`` spans under it, at any depth, and a reader needs neither a
tree walk nor the child records (which a time-window filter or the
ring's bound may have dropped).

With ``REPRO_OBS_PROFILER=1`` in the environment at import (or
``configure(profiler_annotations=True)``) every span also enters a
``torch.profiler.record_function`` of the same name, in whatever thread
it runs, so host spans land as named regions in ``torch.profiler``
traces with no change at the call sites.

Overhead per span is two ``perf_counter`` calls, one deque append and
one roll-up a still-open ancestor (~1-2 µs).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

_TRUTHY = {"1", "true", "yes", "on"}

# bounded: a long-lived process must not grow span history without limit
MAX_SPANS = 65536

_T0 = time.perf_counter()        # process-relative clock zero
_lock = threading.Lock()
_records: "deque[dict]" = deque(maxlen=MAX_SPANS)
_tls = threading.local()
_ids = itertools.count(1)        # next() is atomic under the GIL

# the REPRO_OBS_PROFILER env var, read once at import
_ENV_PROFILER = os.environ.get("REPRO_OBS_PROFILER",
                               "").strip().lower() in _TRUTHY
_profiler_annotations = _ENV_PROFILER


def configure(profiler_annotations: Optional[bool] = None) -> None:
    """Set the ``torch.profiler`` annotation pass-through (None = what the
    environment said at import)."""
    global _profiler_annotations
    _profiler_annotations = (_ENV_PROFILER if profiler_annotations is None
                             else profiler_annotations)


def _stack() -> List[dict]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


@contextmanager
def span(name: str, **attrs) -> Iterator[dict]:
    """Record a named wall-clock span; yields its (mutable) record dict.

    Extra keyword arguments become attributes of the record; more can be
    attached to the yielded dict before the block exits. Records carry
    ``name`` / ``start_s`` (process-relative) / ``duration_s`` /
    ``depth`` / ``parent`` / ``thread`` / ``id`` / ``parent_id`` /
    ``sub`` (``{name: [count, seconds]}`` of the spans closed under it).
    """
    stack = _stack()
    rec: Dict = {
        "name": name,
        "start_s": time.perf_counter() - _T0,
        "duration_s": 0.0,
        "depth": len(stack),
        "parent": stack[-1]["name"] if stack else None,
        "thread": threading.current_thread().name,
        "id": next(_ids),
        "parent_id": stack[-1]["id"] if stack else None,
        "sub": {},
    }
    rec.update(attrs)
    stack.append(rec)
    ann = None
    if _profiler_annotations:
        try:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        except Exception:  # noqa: BLE001 — profiling must never break a solve
            ann = None
    t_in = time.perf_counter()
    try:
        yield rec
    finally:
        dt = rec["duration_s"] = time.perf_counter() - t_in
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        stack.pop()
        for up in stack:
            slot = up["sub"].get(name)
            if slot is None:
                up["sub"][name] = [1, dt]
            else:
                slot[0] += 1
                slot[1] += dt
        with _lock:
            _records.append(rec)


def spans() -> List[dict]:
    """Snapshot of completed span records, ordered by start time.

    (Completion order puts children before parents; sorting by
    ``start_s`` restores the lifecycle order a reader expects.)
    """
    with _lock:
        out = [dict(r, sub={k: list(v) for k, v in r["sub"].items()})
               for r in _records]
    return sorted(out, key=lambda r: r["start_s"])


def clear_spans() -> None:
    with _lock:
        _records.clear()


def span_breakdown(records: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Aggregate span durations by name: ``{name: {count, total_s}}``."""
    if records is None:
        records = spans()
    agg: Dict[str, dict] = {}
    for r in records:
        slot = agg.setdefault(r["name"], {"count": 0, "total_s": 0.0})
        slot["count"] += 1
        slot["total_s"] += r["duration_s"]
    return agg
