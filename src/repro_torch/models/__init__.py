"""The LM stack's models (the port of ``repro.models``): GQA attention and
Mamba2 blocks, the zamba2-style shared block, and ``Model`` with ``init``,
``forward``, ``loss``, ``prefill`` and ``decode_step``."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
