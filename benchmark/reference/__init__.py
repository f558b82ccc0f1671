"""The plain reference of the benchmark's configurations: a frozen copy of
the port's plain PyTorch versions (model parser, dynamics, collision, row
assembly, PGS, the block-pivoting escalation, the position update) with
every kernel dispatch removed, so that it runs the plain versions on any
device and dtype.  It imports nothing of the program.  Where a copied
docstring names a kernel, it describes the program the copy was taken
from; `env.py` puts the env layer on top."""
