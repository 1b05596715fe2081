"""Grid GW cost assembly: C[k, m] = Σ_{l,p} L(A[k,l], B[m,p]) T[l,p]."""
