"""The LM stack's models (the port of ``repro.models``): GQA, MLA and
cross-attention, MoE, Mamba2, mLSTM and sLSTM blocks, the zamba2-style
shared block, and ``Model`` with ``init``, ``forward``, ``loss``,
``prefill``, ``init_cache`` and ``decode_step`` for every architecture of
``configs.ARCH_IDS``."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
