"""Serving entry points (counterpart of ``repro.launch.serve``).

``--mode gw`` (the default) drives a synthetic catalog-matching workload
through :class:`~repro_torch.serve.GWServer` — size-bucketed lane
batching, the content-hash geometry cache, per-request health status —
and prints each request's outcome and the server's metrics summary.

``--mode lm`` is the reference's LM serving loop: a prompt batch
teacher-forced through decode steps on a zero cache, then greedy (or
sampled) decoding (:func:`generate`), and with ``--metric gw`` the GW
distance between the hidden geometries of the batch and the batch
reversed (:func:`gw_similarity`, the paper's technique as a serving
feature). Every architecture runs, but the two whose reference
``lm_main`` fails (it draws 2-D prompts and passes no image embeddings):
a codebook model (musicgen) and a VLM raise, naming that failure; their
``generate`` takes (B, S0, n_codebooks) prompts and ``img=``.

Both run on the CUDA card unless ``--device`` says otherwise.

Usage:
  python -m repro_torch.launch.serve --requests 16 --max-batch 8
  python -m repro_torch.launch.serve --device cpu --requests 4
  python -m repro_torch.launch.serve --mode lm --arch zamba2-7b --reduced \
      --batch 4 --prompt-len 32 --gen 16 --metric gw
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import dispatch


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


# ---------------------------------------------------------------------------
# LM serving mode
# ---------------------------------------------------------------------------

def generate(model, params, prompts, max_new: int, act_dtype=torch.float32,
             temperature: float = 0.0, img=None, generator=None,
             device=None):
    """prompts: (B, S0) int, or (B, S0, n_codebooks) for a codebook model;
    ``img``: a VLM's image embeddings (B, N_img, D), passed to every
    decode step. Greedy (or sampled) continuation; returns the (B, S0 +
    max_new) (or (B, S0 + max_new, n_codebooks)) int64 tokens.

    Decode runs against a fresh cache of length S0 + max_new in
    ``act_dtype``: the prompt is teacher-forced through decode steps (as
    the reference does), then each new token is the argmax of the last
    logits (one a codebook), or with ``temperature > 0`` a draw from their
    softmax at that temperature (``torch.multinomial`` on ``generator``).
    Like the reference, the last token is decoded too.
    """
    dev = dispatch.resolve_device(device)
    prompts = prompts.to(dev)
    B, S0 = prompts.shape[0], prompts.shape[1]
    total = S0 + max_new
    cache = model.init_cache(B, total, dtype=act_dtype, device=dev)
    logits = None
    for t in range(S0):
        logits, cache = model.decode_step(params, prompts[:, t:t + 1],
                                          cache, t, img=img,
                                          act_dtype=act_dtype, device=dev)
    out = [prompts.long()]
    for t in range(S0, total):
        last = logits[:, -1]                   # (B, V) or (B, C, V)
        if temperature > 0:
            probs = torch.softmax(last.float() / temperature, -1)
            nxt = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator)
            nxt = nxt.reshape(last.shape[:-1])[:, None]
        else:
            nxt = torch.argmax(last, dim=-1)[:, None]
        out.append(nxt)
        logits, cache = model.decode_step(params, nxt, cache, t, img=img,
                                          act_dtype=act_dtype, device=dev)
    return torch.cat(out, dim=1)


def gw_similarity(model, params, batch_a, batch_b, s: int = 32,
                  act_dtype=torch.float32, generator=None, draws=None,
                  img=None, device=None):
    """GW distance between the hidden geometries of two request batches:
    ``Model.forward`` of each (through K5 or K6 where the architecture has
    them, on the card), then
    :func:`~repro_torch.core.align.gw_alignment_loss` with s_r = s_c =
    ``s``. Its draws come from ``generator`` (default: seed 0 on the
    hidden states' device, as the reference fixes ``PRNGKey(0)``) or
    ``draws``. ``img`` (a VLM's image embeddings) goes to both forwards;
    the reference's has no such argument, so it fails for a VLM."""
    from repro_torch.core.align import gw_alignment_loss

    _, h_a, _ = model.forward(params, batch_a, img=img, act_dtype=act_dtype,
                              device=device)
    _, h_b, _ = model.forward(params, batch_b, img=img, act_dtype=act_dtype,
                              device=device)
    if generator is None and draws is None:
        generator = torch.Generator(device=h_a.device).manual_seed(0)
    return gw_alignment_loss(generator, h_a, h_b, s_r=s, s_c=s, draws=draws)


# the reference's lm_main draws (B, S) prompts and passes no image
# embeddings: these are its failures on the two architectures that need
# more (``python -m repro.launch.serve --mode lm --arch <id> --reduced``)
LM_MAIN_FAILS = {
    "codebooks": "ValueError: not enough values to unpack (expected 3, "
                 "got 2)",
    "image": "TypeError: unsupported operand type(s) for @: 'NoneType' ...",
}


def lm_main(args) -> None:
    """Random weights (seed 0) and random prompts (seed 7), generate, and
    optionally the GW similarity of the batch and the batch reversed.
    A codebook model or a VLM raises ``ValueError``: the reference's
    ``lm_main`` fails on both, and the CLI adds no input it lacks."""
    from repro_torch.configs import base as cb
    from repro_torch.models import Model

    cfg = cb.get_reduced(args.arch) if args.reduced else cb.get_arch(
        args.arch)
    if cfg.n_codebooks > 1 or cfg.n_image_tokens > 0:
        need, fail = (("(B, S, n_codebooks) prompts", "codebooks")
                      if cfg.n_codebooks > 1 else
                      ("image embeddings (img=)", "image"))
        raise ValueError(
            f"--mode lm draws (B, S) prompts and no image embeddings; "
            f"{cfg.name} needs {need}. The reference's lm_main fails here "
            f"too ({LM_MAIN_FAILS[fail]}); call launch.serve.generate "
            f"directly")
    dev = dispatch.resolve_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(7), device=dev)
    t0 = time.time()
    seqs = generate(model, params, prompts, args.gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"generated {tuple(seqs.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    if args.metric == "gw":
        sim = gw_similarity(model, params, prompts, prompts.flip(0),
                            device=dev)
        print(f"GW(batch, reversed-batch) = {float(sim):.5f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("gw", "lm"), default="gw",
                    help="gw: GW solve server demo (default); lm: batched "
                         "LM generation loop")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
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
    lm = ap.add_argument_group("lm mode")
    lm.add_argument("--arch", default=None)
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)
    lm.add_argument("--metric", choices=("none", "gw"), default="none")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        if args.arch is None:
            ap.error("--mode lm requires --arch")
        lm_main(args)
    else:
        gw_main(args)


if __name__ == "__main__":
    main()
