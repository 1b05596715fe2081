"""Core numerics of the port: ground costs, sampling, sparse Sinkhorn."""
