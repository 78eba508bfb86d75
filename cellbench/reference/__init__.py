"""Plain references that decide ``correct``: NumPy and plain PyTorch only.

Nothing here imports the program (``repro_torch``), JAX or the JAX package,
and nothing here takes what the program made: each reference reads the
inputs the benchmark made and works out again what the program derived
from them (layouts, exchanged blocks, caches).  The program's outputs are
read only to judge them.
"""
