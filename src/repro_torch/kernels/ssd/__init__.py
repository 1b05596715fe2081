"""Mamba2 SSD intra-chunk (diagonal block) output (K6)."""
