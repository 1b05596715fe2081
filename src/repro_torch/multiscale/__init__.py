"""Multiscale (quantized) GW pieces of the port; so far only the anchor
selection that the low-rank solver's anchor init needs."""
