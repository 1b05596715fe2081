"""Causal GQA flash attention forward (K5)."""
