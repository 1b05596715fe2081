"""Plain references the benchmark judges the program's answers by.

Nothing here imports the program (``repro_torch``) or JAX: a reference
takes the benchmark's inputs and works the answer out again.
"""
