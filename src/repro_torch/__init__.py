"""PyTorch + CUDA port of the REWAFL simulator (`repro`, the JAX package).

The subpackages mirror the JAX package's (`data`, `sim`, `nn`, `models`,
`core`, `kernels`, `launch`) and keep its module names, so each ported
function sits where its counterpart does. This package imports `torch`
and numpy only — never `jax` or `repro` — so it runs on a GPU host with
no JAX installed. The parity tests (`tests/test_torch_*.py`) are the one
place both packages meet.

Covered so far: the static-paper, sync, dense-telemetry REWAFL path,
from dataset and fleet construction through the chunked round driver and
`launch.fl_run.run_fl`; and dense-LLM serving (`configs`, `nn/attention`,
`nn/transformer`, `models/lm`, `models/api`, `launch.serve.serve`):
prefill and greedy decode for the dense and vlm families. The three TPU
kernels on those paths are hand-written CUDA C++ for Hopper
(`kernels/csrc/`).
"""
