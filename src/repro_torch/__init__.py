"""PyTorch + CUDA port of the REWAFL simulator (`repro`, the JAX package).

The subpackages mirror the JAX package's (`data`, `sim`, `nn`, `models`,
`core`, `kernels`, `launch`) and keep its module names, so each ported
function sits where its counterpart does. This package imports `torch`
and numpy only — never `jax` or `repro` — so it runs on a GPU host with
no JAX installed. The parity tests (`tests/test_torch_*.py`) are the one
place both packages meet.

Covered so far: the static-paper, sync, dense-telemetry REWAFL path,
from dataset and fleet construction through the chunked round driver and
`launch.fl_run.run_fl`. The two TPU kernels on that path are hand-written
CUDA C++ for Hopper (`kernels/csrc/`).
"""
