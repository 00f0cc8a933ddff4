"""`repro_torch.common.resolve_device`'s process-wide numerics switches.

On the card, cuDNN's default convolution backward algorithms add with
atomics, so one FL campaign run twice gave two different results there;
`resolve_device` pins cuDNN to its deterministic algorithms (and turns
the autotuner off) beside the TF32 switches. These tests show, in a
fresh interpreter, that resolving a device sets exactly those switches
and no other global state of torch, and that the cuDNN switches change
nothing on the CPU (the tier-1 workers run every later test with them
set).
"""
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

SNAPSHOT = r"""
import json, sys, torch
sys.path.insert(0, "src")

def snap():
    b = torch.backends
    return {
        "cudnn.enabled": b.cudnn.enabled,
        "cudnn.benchmark": b.cudnn.benchmark,
        "cudnn.benchmark_limit": b.cudnn.benchmark_limit,
        "cudnn.deterministic": b.cudnn.deterministic,
        "cudnn.allow_tf32": b.cudnn.allow_tf32,
        "matmul.allow_tf32": b.cuda.matmul.allow_tf32,
        "matmul.fp16_reduced": b.cuda.matmul.allow_fp16_reduced_precision_reduction,
        "matmul.bf16_reduced": b.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "deterministic_warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
        "deterministic_debug_mode": torch.get_deterministic_debug_mode(),
        "mkldnn.enabled": b.mkldnn.enabled,
        "default_dtype": str(torch.get_default_dtype()),
        "num_threads": torch.get_num_threads(),
        "grad_enabled": torch.is_grad_enabled(),
    }

before = snap()
from repro_torch.common import resolve_device
resolve_device("cpu")
print(json.dumps({"before": before, "after": snap()}))
"""


def test_resolve_device_sets_only_the_numerics_switches():
    out = subprocess.run([sys.executable, "-c", SNAPSHOT], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    got = json.loads(out.strip().splitlines()[-1])
    before, after = got["before"], got["after"]
    assert after["cudnn.deterministic"] is True and after["cudnn.benchmark"] is False
    assert after["cudnn.allow_tf32"] is False and after["matmul.allow_tf32"] is False
    switched = {"cudnn.deterministic", "cudnn.benchmark", "cudnn.allow_tf32",
                "matmul.allow_tf32"}
    assert {k: v for k, v in after.items() if k not in switched} == \
        {k: v for k, v in before.items() if k not in switched}
    # the global deterministic mode stays off: it would change (or refuse)
    # the card's index_add and scatter_reduce and fill every torch.empty
    assert after["deterministic_algorithms"] is False


def test_cudnn_switches_change_nothing_on_the_cpu():
    """A convolution's forward and backward on the CPU are bitwise the
    same with cuDNN's switches off and on."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 28, 28, generator=g)
    w = torch.randn(16, 3, 5, 5, generator=g, requires_grad=True)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    outs = []
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, not det
            y = torch.nn.functional.conv2d(x, w, padding=2)
            (gw,) = torch.autograd.grad(y.square().sum(), w)
            outs.append((y.detach(), gw))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
