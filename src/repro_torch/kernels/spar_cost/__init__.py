"""COO spar_cost family: gather-fused and materialized L-matvec + offset."""
