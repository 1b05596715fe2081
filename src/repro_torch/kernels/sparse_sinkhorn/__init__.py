"""Sparse log-domain Sinkhorn half-step (K7), one launch a half-step."""
