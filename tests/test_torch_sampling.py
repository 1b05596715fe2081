"""The port's importance sampler, checked by its frequencies (torch only).

JAX's threefry draws cannot be reproduced with a torch generator, so the
sampler is held to the distribution it must draw from: eq. (5)'s
p_ij = pa_i · pb_j, with ``shrink`` mixing in the uniform distribution.
With 200 000 draws the standard error of a cell frequency is below
0.0012, so atol 0.006 is a 5-sigma band.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sampling


def _weights():
    a = torch.tensor([0.5, 0.3, 0.15, 0.05, 0.0])
    b = torch.tensor([0.6, 0.3, 0.1])
    return a, b


@pytest.mark.parametrize("shrink", [0.0, 0.3])
def test_pair_frequencies_match_balanced_probs(shrink):
    a, b = _weights()
    probs = sampling.balanced_probs(a, b, shrink)
    assert torch.allclose(probs.pa.sum(), torch.tensor(1.0))
    if shrink:
        assert float(probs.pa.min()) >= shrink / 5 - 1e-7   # (H.4) floor
    else:
        assert float(probs.pa[4]) == 0.0                     # never drawn
    s = 200_000
    rows, cols = sampling.sample_pairs(torch.Generator().manual_seed(0),
                                       probs, s)
    assert rows.dtype == torch.int64 and rows.shape == (s,)
    freq = np.zeros((5, 3))
    np.add.at(freq, (rows.numpy(), cols.numpy()), 1.0 / s)
    want = torch.outer(probs.pa, probs.pb).numpy()
    np.testing.assert_allclose(freq, want, atol=0.006)
    pair = probs.pair_prob(rows[:10], cols[:10])
    np.testing.assert_allclose(pair.numpy(), want[rows[:10], cols[:10]],
                               rtol=1e-6)


def test_balanced_probs_are_sqrt_weights():
    a, b = _weights()
    probs = sampling.balanced_probs(a, b)
    sa = np.sqrt(a.numpy())
    np.testing.assert_allclose(probs.pa.numpy(), sa / sa.sum(), rtol=1e-6)


def test_same_seed_same_draw():
    probs = sampling.balanced_probs(*_weights())

    def draw():
        return sampling.sample_pairs(torch.Generator().manual_seed(5), probs,
                                     1000)
    (r1, c1), (r2, c2) = draw(), draw()
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
