"""The plain reference of the benchmark: region discovery and the upstream
per-region closure, transcribed in Python and NumPy. It imports nothing of
the program and nothing of the JAX package."""
