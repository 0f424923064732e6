"""The plain reference the benchmark decides `correct` by, and its counts
of the kernels' work. Plain torch and numpy only: nothing here imports
the program or JAX."""
