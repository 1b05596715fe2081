"""State-space and recurrent blocks: Mamba2 (SSD, chunked), mLSTM and
sLSTM (xLSTM), the port of ``repro.models.ssm``.

Mamba2 has a single B/C group and no short convolution, as in the
reference. The intra-chunk block ``y_intra`` runs through the SSD kernel
(K6) on (batch·chunks, k, H, P) views; the per-chunk input states, the
sequential scan over chunks and ``y_inter`` stay torch ops. Decode (S = 1
with a state) runs the single-step recurrence. ``split_proj`` (a
tensor-parallel lever; the port runs on one card) is not ported yet
(ROADMAP item 17d).

mLSTM runs its stabilised parallel form for train and prefill (and hands
its final state to decode) and its one-step recurrence in decode. sLSTM
is recurrent only: a Python loop over the sequence, one step of ~15 torch
ops each (the reference's ``lax.scan``). Both compute in torch ops, as
the reference does outside any Pallas kernel.

jnp promotes bfloat16 with float32 inside ``einsum`` and ``@``; torch
refuses mixed dtypes there, so B and C are cast to float32 where the
reference's contractions meet float32 operands, which is the same
arithmetic.
"""
from __future__ import annotations

import math

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


def _out_norm(p, h, x_dtype):
    """The LSTM blocks' output RMS norm (eps 1e-6) in x's dtype."""
    h = h.to(x_dtype)
    h32 = h.float()
    return (h32 * torch.rsqrt((h32 * h32).mean(dim=-1, keepdim=True) + 1e-6)
            ).to(x_dtype) * p["norm"]


# ---------------------------------------------------------------------------
# mLSTM — matrix-memory LSTM (xLSTM), stabilised parallel + recurrent forms
# ---------------------------------------------------------------------------

def mlstm_params(b: Builder, cfg: ArchConfig):
    d = cfg.d_model
    pd = int(cfg.lstm_proj_factor * d)
    return {
        "w_up": b.param((d, 2 * pd)),
        "wq": b.param((pd, pd)),
        "wk": b.param((pd, pd)),
        "wv": b.param((pd, pd)),
        "w_if": b.param((pd, 2 * cfg.n_heads)),
        "norm": b.param((pd,), init="ones"),
        "w_down": b.param((pd, d)),
    }


def mlstm_block(p, cfg: ArchConfig, x, state=None):
    """x: (B,S,D). ``state=None``: the parallel form, whose new state is
    the hand-off to decode; ``state = (C (B,H,P,P), n (B,H,P), m (B,H))``:
    one recurrent step (S == 1). C and n stay in the state's dtype, m in
    float32. Returns (out, new state)."""
    B, S, D = x.shape
    pd = int(cfg.lstm_proj_factor * D)
    H = cfg.n_heads
    P = pd // H
    up = x @ p["w_up"]
    xi, z = up[..., :pd], up[..., pd:]
    q = (xi @ p["wq"]).reshape(B, S, H, P)
    k = (xi @ p["wk"]).reshape(B, S, H, P) / math.sqrt(P)
    v = (xi @ p["wv"]).reshape(B, S, H, P)
    gates = (xi @ p["w_if"]).float()                          # (B,S,2H)
    i_raw, f_raw = gates[..., :H], gates[..., H:]
    log_f = F.logsigmoid(f_raw)                               # (B,S,H)

    if state is None:
        Fc = torch.cumsum(log_f, dim=1)                       # (B,S,H)
        Dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_raw[:, None, :, :]
        tri = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        Dmat = Dmat.masked_fill(~tri[None, :, :, None], -math.inf)
        m = Dmat.amax(dim=2, keepdim=True).clamp(min=-1e30)   # (B,S,1,H)
        W = torch.exp(Dmat - m)                               # (B,S,T,H)
        scores = torch.einsum("bshp,bthp->bsth", q, k) * W    # float32
        denom = torch.maximum(scores.sum(dim=2).abs(),
                              torch.exp(-m[:, :, 0, :]))      # (B,S,H)
        h = torch.einsum("bsth,bthp->bshp", scores, v.float()) \
            / denom[..., None]
        # the final recurrent state, for the hand-off to decode
        mT = Fc[:, -1:, :] - Fc + i_raw                       # (B,S,H)
        m_last = mT.amax(dim=1).clamp(min=-1e30)              # (B,H)
        wT = torch.exp(mT - m_last[:, None, :])
        C_last = torch.einsum("bsh,bshp,bshq->bhpq", wT, v.float(),
                              k.float()).to(v.dtype)
        n_last = torch.einsum("bsh,bshp->bhp", wT, k.float()).to(v.dtype)
        new_state = (C_last, n_last, m_last)
    else:
        C, n, m_prev = state
        i_t, lf_t = i_raw[:, 0], log_f[:, 0]                  # (B,H)
        m_new = torch.maximum(lf_t + m_prev, i_t)
        f_s = torch.exp(lf_t + m_prev - m_new)[:, :, None]
        i_s = torch.exp(i_t - m_new)[:, :, None]
        C = (C * f_s[..., None] + i_s[..., None] * torch.einsum(
            "bhp,bhq->bhpq", v[:, 0], k[:, 0])).to(C.dtype)
        n = (n * f_s + i_s * k[:, 0]).to(n.dtype)
        qt = torch.promote_types(C.dtype, q.dtype)            # as jnp does
        num = torch.einsum("bhpq,bhq->bhp", C.to(qt), q[:, 0].to(qt))
        den = torch.maximum((n * q[:, 0]).sum(dim=-1).abs(),
                            torch.exp(-m_new))[..., None]
        h = (num / den)[:, None]                              # (B,1,H,P)
        new_state = (C, n, m_new)

    h = _out_norm(p, h.reshape(B, S, pd), x.dtype)
    return (h * F.silu(z)) @ p["w_down"], new_state


def mlstm_state_spec(cfg: ArchConfig, batch: int, dtype):
    pd = int(cfg.lstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    P = pd // H
    return (TensorSpec((batch, H, P, P), dtype),
            TensorSpec((batch, H, P), dtype),
            TensorSpec((batch, H), torch.float32))


# ---------------------------------------------------------------------------
# sLSTM — scalar-memory LSTM with exponential gating (recurrent only)
# ---------------------------------------------------------------------------

def slstm_params(b: Builder, cfg: ArchConfig):
    d = cfg.d_model
    pd = int(cfg.lstm_proj_factor * d)
    H = cfg.n_heads
    hd = pd // H
    return {
        "w_up": b.param((d, 2 * pd)),
        "w_in": b.param((pd, 4 * pd)),                        # z,i,f,o
        "r": b.param((4, H, hd, hd), scale=0.5 / hd ** 0.5),  # per head
        "norm": b.param((pd,), init="ones"),
        "w_down": b.param((pd, d)),
    }


def _slstm_step(p, cfg: ArchConfig, pre, carry):
    """One recurrence step. pre: (B, 4·pd) input pre-activations; carry
    (c, n, m, h), each (B, pd) float32."""
    c, n, m, h = carry
    B, pd = c.shape
    H = cfg.n_heads
    hd = pd // H
    r = p["r"].to(torch.promote_types(h.dtype, p["r"].dtype))
    rec = torch.einsum("bhd,ghde->bghe", h.to(r.dtype).reshape(B, H, hd),
                       r).reshape(B, 4, pd)
    z_r, i_r, f_r, o_r = (pre.reshape(B, 4, pd) + rec).unbind(dim=1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    lf = F.logsigmoid(f_r.float())
    m_new = torch.maximum(lf + m, i_r.float())
    i_s = torch.exp(i_r - m_new)
    f_s = torch.exp(lf + m - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    h = o * (c / n.clamp(min=1.0))
    return (c, n, m_new, h)


def slstm_block(p, cfg: ArchConfig, x, state=None):
    """x: (B,S,D). ``state=None``: the recurrence from an empty history
    over all S positions; ``state = (c, n, m, h)``, each (B, pd) float32:
    one step (S == 1). Returns (out, new state)."""
    B, S, D = x.shape
    pd = int(cfg.lstm_proj_factor * D)
    up = x @ p["w_up"]
    xi, z_gate = up[..., :pd], up[..., pd:]
    pre = xi @ p["w_in"]                                      # (B,S,4pd)

    # the recurrent weights in the carry's float32 (jnp promotes in the
    # einsum), cast once rather than at every step
    p = {**p, "r": p["r"].to(torch.promote_types(torch.float32,
                                                 p["r"].dtype))}
    if state is None:
        zeros = torch.zeros((B, pd), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, torch.full_like(zeros, -1e30), zeros)
        hs = []
        for t in range(S):                                    # the scan
            carry = _slstm_step(p, cfg, pre[:, t], carry)
            hs.append(carry[3])
        new_state, h = carry, torch.stack(hs, dim=1)          # (B,S,pd)
    else:
        new_state = _slstm_step(p, cfg, pre[:, 0], state)
        h = new_state[3][:, None]
    h = _out_norm(p, h, x.dtype)
    return (h * F.silu(z_gate)) @ p["w_down"], new_state


def slstm_state_spec(cfg: ArchConfig, batch: int, dtype):
    pd = int(cfg.lstm_proj_factor * cfg.d_model)
    return tuple(TensorSpec((batch, pd), torch.float32) for _ in range(4))
