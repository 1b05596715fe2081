"""Serving entry point (counterpart of ``repro.launch.serve``, gw mode).

``--mode gw`` (the default) drives a synthetic catalog-matching workload
through :class:`~repro_torch.serve.GWServer` — size-bucketed lane
batching, the content-hash geometry cache, per-request health status —
and prints each request's outcome and the server's metrics summary.

``--mode lm`` (the reference's LM serving loop) is not ported: it needs
``Model.decode_step`` and ``core/align.py`` (ROADMAP item 17).

Usage:
  python -m repro_torch.launch.serve --requests 16 --max-batch 8
  python -m repro_torch.launch.serve --device cpu --requests 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _demo_geometry(n: int, seed: int):
    from repro_torch import Geometry
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 2)).astype(np.float32)
    C = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    return Geometry(C, np.full(n, 1.0 / n, np.float32))


def gw_main(args) -> None:
    """Drive a synthetic catalog workload through GWServer and print the
    per-request outcomes + the metrics summary."""
    import repro_torch
    from repro_torch.serve import GWServer, ServeConfig

    http_server = None
    if args.metrics_port:
        from repro_torch.obs import serve_metrics_http
        http_server = serve_metrics_http(args.metrics_port)
        host, port = http_server.server_address[:2]
        print(f"metrics: http://{host}:{port}/metrics "
              f"(Prometheus text format)")

    server = GWServer(ServeConfig(max_batch=args.max_batch,
                                  max_wait_s=args.max_wait,
                                  on_failure=args.on_failure,
                                  device=args.device))
    try:
        solver = repro_torch.get_solver(args.solver).default_config(64)
        needs_generator = getattr(type(solver), "requires_key", False)
        reference = _demo_geometry(32, seed=999)
        sizes = (12, 18, 24, 28)
        t0 = time.time()
        rids = []
        for i in range(args.requests):
            query = _demo_geometry(sizes[i % len(sizes)], seed=100 + i % 6)
            problem = repro_torch.QuadraticProblem(query, reference)
            gen = (torch.Generator(device=server.device).manual_seed(i)
                   if needs_generator else None)
            rids.append(server.submit(problem, solver, generator=gen))
        results = server.results(rids)
        dt = time.time() - t0
        for r in results:
            print(f"  rid={r.rid:3d} shape={r.shape} -> "
                  f"bucket{r.padded_shape} value={r.value:.5f} "
                  f"status={r.status_name}"
                  f"{' (fallback)' if r.fell_back else ''} "
                  f"latency={r.latency_s * 1e3:.1f}ms")
        print(f"served {len(results)} requests in {dt:.2f}s "
              f"({len(results) / dt:.1f} req/s) on {server.device}")
        stats = server.stats()
        for k in sorted(stats):
            v = stats[k]
            print(f"  {k} = {v:.4f}" if isinstance(v, float) else
                  f"  {k} = {v}")
    finally:
        server.close()
        if http_server is not None:
            http_server.shutdown()
            http_server.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("gw", "lm"), default="gw",
                    help="gw: GW solve server demo (default); lm: the "
                         "reference's LM loop (not ported)")
    gw = ap.add_argument_group("gw mode")
    gw.add_argument("--requests", type=int, default=16)
    gw.add_argument("--solver", default="dense_gw")
    gw.add_argument("--max-batch", type=int, default=8)
    gw.add_argument("--max-wait", type=float, default=0.02)
    gw.add_argument("--on-failure", choices=("none", "fallback"),
                    default="fallback")
    gw.add_argument("--metrics-port", type=int, default=0,
                    help="serve the process metrics registry as Prometheus "
                         "text on this port (0 = off)")
    gw.add_argument("--device", default=None,
                    help="where to solve (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError(
            "--mode lm is not ported: it needs Model.decode_step and "
            "core/align.py (ROADMAP item 17)")
    gw_main(args)


if __name__ == "__main__":
    main()
