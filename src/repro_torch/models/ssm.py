"""Mamba2 (SSD, chunked): the port of ``repro.models.ssm``'s Mamba2 part.

Single B/C group and no short convolution, as in the reference. The
intra-chunk block ``y_intra`` runs through the SSD kernel (K6) on
(batch·chunks, k, H, P) views; the per-chunk input states, the sequential
scan over chunks and ``y_inter`` stay torch ops. Decode (S = 1 with a
state) runs the single-step recurrence. mLSTM, sLSTM and ``split_proj`` (a
tensor-parallel lever; the port runs on one card) are not ported yet
(ROADMAP items 17b and 17d).

jnp promotes bfloat16 with float32 inside ``einsum`` and ``@``; torch
refuses mixed dtypes there, so B and C are cast to float32 where the
reference's contractions meet float32 operands, which is the same
arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd.ops import ssd_intra
from repro_torch.kernels.ssd.ref import ssd_intra_ref
from repro_torch.models.attention import TensorSpec
from repro_torch.models.module import Builder


def mamba2_params(b: Builder, cfg: ArchConfig):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.ssm_heads
    N = cfg.ssm_state
    return {
        "a_log": b.param((H,), init="zeros"),
        "skip_d": b.param((H,), init="ones"),
        "dt_bias": b.param((H,), init="zeros"),
        "norm": b.param((d_in,), init="ones"),
        "out_proj": b.param((d_in, d)),
        "in_proj": b.param((d, 2 * d_in + 2 * N + H)),
    }


def _ssd_chunked(xh, dt, a_log, Bm, Cm, chunk: int, use_kernel: bool = True):
    """SSD over chunks. xh: (B,L,H,P), dt: (B,L,H), Bm/Cm: (B,L,N).

    Returns y: (B,L,H,P) float32 and the final state (B,H,N,P) float32.
    ``use_kernel=False`` takes K6's plain version for the intra-chunk block.
    """
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    c = L // chunk
    A = -torch.exp(a_log.float())                            # (H,) negative
    dA = dt * A                                              # (B,L,H)
    xk = (xh * dt[..., None]).reshape(Bsz, c, chunk, H, P)   # float32
    Bk = Bm.reshape(Bsz, c, chunk, N).float()
    Ck = Cm.reshape(Bsz, c, chunk, N).float()
    cs = torch.cumsum(dA.reshape(Bsz, c, chunk, H), dim=2)   # (B,c,k,H)

    # intra-chunk: y[s] = Σ_{t≤s} C_s·B_t · exp(cs_s - cs_t) · xk[t]
    views = (xk.reshape(Bsz * c, chunk, H, P), cs.reshape(Bsz * c, chunk, H),
             Bk.reshape(Bsz * c, chunk, N), Ck.reshape(Bsz * c, chunk, N))
    if use_kernel:
        y_intra = ssd_intra(*views, device=xh.device)
    else:
        y_intra = ssd_intra_ref(*views)
    y_intra = y_intra.reshape(xk.shape)

    # per-chunk input state: S_c = Σ_t exp(cs_last - cs_t) B_t ⊗ x_t
    last = cs[:, :, -1:, :]                                  # (B,c,1,H)
    w = torch.exp(last - cs)                                 # (B,c,k,H)
    S_c = torch.einsum("bctn,bcthp->bchnp", Bk, w[..., None] * xk)
    total = torch.exp(last[:, :, 0, :])                      # (B,c,H)

    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                        device=xh.device)
    prev = []
    for i in range(c):                                       # the chunk scan
        prev.append(state)
        state = state * total[:, i, :, None, None] + S_c[:, i]
    prev_states = torch.stack(prev, dim=1)                   # (B,c,H,N,P)

    y_inter = torch.einsum("bcsn,bchnp->bcshp", Ck, prev_states) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y, state


def mamba2_block(p, cfg: ArchConfig, x, state=None, use_kernel: bool = True):
    """x: (B,S,D). ``state=None`` for train and prefill (the chunked SSD);
    a state (B,H,N,P) for decode (S == 1, the single-step recurrence).
    Returns (out, new state); the prefill's comes in x's dtype, the
    decode's in the state's own."""
    B, S, D = x.shape
    d_in = cfg.ssm_expand * D
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = d_in // H
    proj = x @ p["in_proj"]
    z, xi, Bm, Cm, dt = torch.split(proj, [d_in, d_in, N, N, H], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B,S,H)
    xh = xi.reshape(B, S, H, P)

    if state is None:
        y, new_state = _ssd_chunked(xh, dt, p["a_log"], Bm, Cm,
                                    min(cfg.ssm_chunk, S), use_kernel)
        new_state = new_state.to(xh.dtype)
    else:
        # single-step recurrence: h <- exp(dt·A) h + dt·B ⊗ x, y = C·h
        A = -torch.exp(p["a_log"].float())
        dA = torch.exp(dt[:, 0] * A)                         # (B,H)
        dBx = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), dt[:, 0],
                           xh[:, 0].float())
        new_state = (state * dA[:, :, None, None] + dBx).to(state.dtype)
        ct = torch.promote_types(Cm.dtype, new_state.dtype)
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(ct),
                         new_state.to(ct))[:, None]
    y = y + xh * p["skip_d"][None, None, :, None]
    y = y.reshape(B, S, d_in) * F.silu(z)
    y32 = y.float()
    y = (y32 * torch.rsqrt((y32 * y32).mean(dim=-1, keepdim=True) + 1e-6)
         ).to(x.dtype) * p["norm"]
    return y @ p["out_proj"], new_state


def mamba2_state_spec(cfg: ArchConfig, batch: int, dtype):
    d_in = cfg.ssm_expand * cfg.d_model
    P = d_in // cfg.ssm_heads
    return TensorSpec((batch, cfg.ssm_heads, cfg.ssm_state, P), dtype)
