"""SaGroW baseline (Kerdoncuff et al., 2021) — sampled-gradient GW.

Counterpart of ``repro.core.sagrow``. At each outer step the GW gradient
M = L(Cx, Cy) ⊗ T is estimated from s' index pairs drawn ∝ T
(self-normalized importance sampling), followed by a KL-proximal Sinkhorn
step: O(s' m n) a step. The paper's main sampling-based competitor
(Table 1, Figs. 2-3).

The pairs are drawn from a ``torch.Generator`` by inverse CDF on a
float64 cumsum (``core/sampling.sample_pairs_2d``); threefry's draws
cannot be reproduced, so ``draws`` takes them instead (the parity tests
pass the reference's ``jax.random.choice`` draws). The dense Sinkhorn is
``core/sinkhorn.sinkhorn``, not the K4 kernel, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import ground_cost as gc
from repro_torch.core.sampling import sample_pairs_2d
from repro_torch.core.sinkhorn import sinkhorn
from repro_torch.core.utils import flush_subnormal
from repro_torch.kernels import dispatch


def _sampled_gradient(generator, Cx, Cy, T, s_prime: int, loss: str,
                      chunk: int = 32, draws=None):
    """M̂ = (1/s') Σ_l L(Cx[:, i_l], Cy[:, j_l]),  (i_l, j_l) ~ T/m(T).

    ``draws=(ii, jj)`` fixes the s' pairs instead of drawing them. The
    terms are summed ``chunk`` pairs at a time, as in the reference.
    """
    L = gc.get_loss(loss)
    m, n = T.shape
    if draws is None:
        probs = flush_subnormal(T / torch.sum(T))
        ii, jj = sample_pairs_2d(generator, probs, s_prime)
    else:
        ii, jj = (torch.as_tensor(d, dtype=torch.int64, device=T.device)
                  for d in draws)
    assert s_prime % chunk == 0 or s_prime < chunk
    chunk = min(chunk, s_prime)
    acc = torch.zeros((m, n), dtype=T.dtype, device=T.device)
    for c in range(s_prime // chunk):
        A = Cx[:, ii[c * chunk:(c + 1) * chunk]]          # (m, chunk)
        B = Cy[:, jj[c * chunk:(c + 1) * chunk]]          # (n, chunk)
        acc = acc + L(A[:, None, :], B[None, :, :]).sum(dim=-1)
    return acc / s_prime


def sagrow(generator, a, b, Cx, Cy, s_prime: int, loss: str = "l2",
           epsilon: float = 1e-2, outer_iters: int = 20,
           inner_iters: int = 50, draws=None, device=None):
    """Returns (gw_estimate_of_final_plan, T). The estimate uses one extra
    sampled-gradient evaluation: GW ≈ <M̂(T), T> (unbiased given T).

    ``draws`` fixes the pairs of every gradient: ``outer_iters + 1`` pairs
    ``(ii, jj)``, one per step and one for the estimate. Runs on
    ``device`` (the card unless given).
    """
    dev = dispatch.resolve_device(device)
    a, b, Cx, Cy = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (a, b, Cx, Cy))
    if draws is not None and len(draws) != outer_iters + 1:
        raise ValueError(f"draws must hold outer_iters + 1 = "
                         f"{outer_iters + 1} pairs, got {len(draws)}")

    def gradient(step, T):
        return _sampled_gradient(generator, Cx, Cy, T, s_prime, loss,
                                 draws=None if draws is None
                                 else draws[step])

    T = flush_subnormal(a[:, None] * b[None, :])
    for step in range(outer_iters):
        M = gradient(step, T)
        K = flush_subnormal(flush_subnormal(
            torch.exp(-(M - torch.min(M)) / epsilon)) * T)
        T = sinkhorn(a, b, K, inner_iters)
    M = gradient(outer_iters, T)
    return torch.sum(M * T), T
