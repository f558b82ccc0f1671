"""dartenv_tpu_torch: the PyTorch / CUDA port of the dartenv_tpu engine.

Sub-packages keep the names of the JAX package (`model`, `math`,
`dynamics`, `collision`, `lcp`, `engine`, `envs`, `parallel`, `bench`) so a
reader finds each counterpart.  Inside, PyTorch's idiom: plain functions on
tensors with the env batch written out as the LEADING axis, Python loops
where the JAX package scans, frozen dataclasses of tensors for state, and
an explicit `device` argument on every entry point (default "cuda"; no
entry point picks the CPU because it found no GPU).

The four kernels (the fused substep, the dynamics phase, PGS and the
block-pivoting exact solve) are hand-written CUDA C++ under `csrc/`, built
with nvcc for sm_90a at first use (`cuda_build.py`).

Full-f32 products are asserted at import — the counterpart of the JAX
package's `jax.default_matmul_precision("highest")` guard: TF32 keeps ~3
decimal digits, enough to cost the mass matrix its positive-definiteness.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
