"""Parity of the port's causal GQA flash attention (K5) with the reference.

On the CPU ``repro_torch.kernels.flash_attention.ops.flash_attention``
runs the kernel's plain version: attention in float32 on the flattened
(B·H, S, hd) layout, output in q's dtype. The reference side runs its
Pallas kernel in interpret mode and its oracle ``attention_ref`` on the
same numpy inputs.

Tolerances:

* float32, port vs Pallas kernel and oracle: atol 2e-6 + rtol 1e-5. Both
  compute the same softmax-weighted sum of unit-normal values in float32;
  they differ in the order of the S-term sums and the last ulp of exp.
* bfloat16, port vs Pallas kernel: both compute in float32 and round the
  output to bfloat16 once, so they differ by at most one bfloat16 ulp
  where the float32 values straddle a rounding boundary: atol and rtol
  2⁻⁷. Port vs the float32 oracle: the port's rounding only, half an ulp,
  inside the same 2⁻⁷ (the reference sweep allows 5e-2).
* the oracles alone in bfloat16 (``attention_ref`` on both sides): each
  rounds the scores and the probabilities to bfloat16 at its einsums, and
  the two frameworks' bf16 matmuls may round a value one ulp apart at
  each of the two points: 2·2⁻⁷.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

F32_RTOL, F32_ATOL = 1e-5, 2e-6
BF16_TOL = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed):
    B, S, H, K, hd = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32))


def _port(q, k, v, tdt):
    out = flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                          device="cpu")
    assert out.dtype == tdt and out.device.type == "cpu"
    return out.float().numpy()


def _as(jdt, *arrays):
    return tuple(jnp.asarray(a).astype(jdt) for a in arrays)


# the reference's sweep (tests/test_kernels.py) and a zamba2-width head
@pytest.mark.parametrize("shape", [(2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                                   (2, 64, 6, 3, 16), (1, 512, 2, 1, 128),
                                   (1, 256, 4, 4, 112)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(shape, sum(shape))
    jq, jk, jv = _as(jdt, q, k, v)
    got = _port(np.asarray(jq.astype(jnp.float32)),
                np.asarray(jk.astype(jnp.float32)),
                np.asarray(jv.astype(jnp.float32)), tdt)
    pallas = np.asarray(ref_flash(jq, jk, jv).astype(jnp.float32))
    oracle = np.asarray(ref_oracle(jq.astype(jnp.float32),
                                   jk.astype(jnp.float32),
                                   jv.astype(jnp.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(got, pallas, rtol=F32_RTOL, atol=F32_ATOL)
        np.testing.assert_allclose(got, oracle, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, pallas, rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(got, oracle, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("shape", [(1, 200, 2, 1, 16), (2, 200, 4, 2, 112)])
def test_flash_attention_ragged_length_matches_oracle(shape):
    """S = 200 is not a multiple of the tile. Held to the oracle only: the
    reference's Pallas kernel builds its grid as S // bq
    (src/repro/kernels/flash_attention/flash_attention.py:66-68) and never
    writes rows 128-199, which come out NaN or garbage."""
    q, k, v = _inputs(shape, 7)
    got = _port(q, k, v, torch.float32)
    oracle = np.asarray(ref_oracle(*_as(jnp.float32, q, k, v)))
    np.testing.assert_allclose(got, oracle, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference_oracle(dtype):
    """The port's oracle follows the reference's dtype rules: in bfloat16
    the scores and probabilities round to bfloat16 as the einsums do."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs((2, 64, 6, 3, 16), 3)
    jq, jk, jv = _as(jdt, q, k, v)
    want = np.asarray(ref_oracle(jq, jk, jv).astype(jnp.float32))
    got = attention_ref(*(torch.tensor(np.asarray(a.astype(jnp.float32)))
                          .to(tdt) for a in (jq, jk, jv)))
    tol = F32_RTOL if dtype == "float32" else 2 * BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol if dtype != "float32" else F32_ATOL)


def test_plain_version_on_the_flattened_layout():
    """flash_attention_plain (the kernel's interface, q head i reading kv
    head i // G) agrees with the oracle on the (B, S, H, hd) layout."""
    B, S, H, K, hd = 2, 40, 6, 2, 8
    q, k, v = (torch.from_numpy(a) for a in _inputs((B, S, H, K, hd), 5))
    flat = fa_mod.flash_attention_plain(
        q.transpose(1, 2).reshape(B * H, S, hd),
        k.transpose(1, 2).reshape(B * K, S, hd),
        v.transpose(1, 2).reshape(B * K, S, hd), groups=H // K)
    want = attention_ref(q, k, v)
    torch.testing.assert_close(flat.reshape(B, H, S, hd).transpose(1, 2),
                               want, rtol=F32_RTOL, atol=F32_ATOL)
    fa_mod.reset_launch_counts()
    flash_attention(q, k, v, device="cpu")
    assert fa_mod.LAUNCHES == {"flash_attention": 0}   # plain runs: no launch


def test_flash_attention_refusals(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 16, 4, 2, 8), 0))
    with pytest.raises(NotImplementedError, match="causal"):
        flash_attention(q, k, v, causal=False, device="cpu")
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, k[:, :, :1].expand(1, 16, 3, 8), v, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, k, v)
