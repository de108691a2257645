"""Plain references the benchmark judges the port by.

They import torch and numpy only: nothing of the port, nor JAX, nor the
JAX package, and they take nothing the port made.  Each works out again
from the benchmark's own inputs whatever the port derived from them.
"""
