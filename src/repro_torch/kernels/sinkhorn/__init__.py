"""Dense plain-domain Sinkhorn with K resident on chip (K4)."""
