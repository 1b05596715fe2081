"""Carry the reference's LM parameters into the port, through numpy.

The reference's ``Model.init`` pytree has the scanned superblocks stacked
on a leading axis (``blocks``), the tail as a list, and dicts elsewhere;
the port keeps ``blocks`` as a list with one dict per superblock. Every
other leaf crosses as it is: the MoE experts stacked (E, d, f), the MLA
latents' projections and norms, cross-attention's ``gate``, sLSTM's
recurrent ``r`` (4, H, hd, hd), ``codebook_embeds`` and ``heads``. With
the same parameters on both sides the two packages compute the same
function, which the parity tests hold them to.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import dispatch


def _convert(tree, device):
    if isinstance(tree, dict):
        return {key: _convert(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(val, device) for val in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _index(tree, i):
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    return tree[i]


def model_params_from_jax(cfg: ArchConfig, tree, device=None):
    """The port's parameters from the reference's ``Model(cfg).init`` tree
    with numpy (or array-like) leaves, on ``device`` (the card unless
    given)."""
    params = _convert(tree, dispatch.resolve_device(device))
    stacked = params["blocks"]
    params["blocks"] = [_index(stacked, i)
                        for i in range(cfg.resolved_superblocks)]
    return params
