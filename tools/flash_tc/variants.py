"""Build variants of the flash-attention CUDA source side by side, check
each against the plain version, and time them in turns on one GPU.

    python3 tools/flash_tc/variants.py tools/flash_tc/runs.json 12

`runs.json` maps a run number to its variants: name -> a list of
[old, new] string replacements applied to
`src/repro_torch/kernels/csrc/flash_attention.cu`. A list may start with
["_source", path] (another file as the base) or ["_flags", "..."] (extra
nvcc flags); a name that starts with "c_" is only compiled. For each
variant the script prints ptxas's spills and registers of the bf16
tensor-core kernel, whether 7 bf16 cases (GQA, MQA, ragged, window,
softcap, rows with no key) stay within one bf16 step of the plain
version (rtol 2**-7, atol 1e-5), and its device time at B 4, S 2048,
causal, for hd 128 (H 24, n_kv 8) and hd 64 (H 16, n_kv 4): CUDA events
around 20 calls, six turns alternating over the variants, median, min
and max. Timing variants only (an ablation that drops work) fail the
check and are still timed. The variants are built in
`build/flash_variants/`, which is git-ignored.
"""
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

SRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")
OUT = os.path.join(ROOT, "build/flash_variants")
# B, Sq, Sk, H, n_kv, hd, causal, window, softcap
CASES = [(4, 2048, 2048, 24, 8, 128, True, None, None), (2, 200, 70, 4, 2, 64, True, None, None),
         (1, 512, 512, 32, 16, 128, True, 64, 50.0), (1, 130, 130, 4, 2, 64, False, 0, None),
         (2, 300, 300, 48, 1, 128, True, None, None), (2, 77, 77, 8, 8, 64, True, 16, 30.0),
         (1, 2048, 2048, 16, 4, 64, True, None, None)]
SHAPES = {"hd128": (4, 2048, 24, 8, 128), "hd64": (4, 2048, 16, 4, 64)}


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def build(variants: dict) -> dict:
    """name -> ctypes entry `flash_attention_bf16`, all nvcc runs in parallel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, reps in variants.items():
        src = open(SRC).read()
        flags = []
        while reps and reps[0][0] in ("_source", "_flags"):
            if reps[0][0] == "_source":
                src = open(os.path.join(ROOT, reps[0][1])).read()
            else:
                flags = reps[0][1].split()
            reps = reps[1:]
        for old, new in reps:
            if old not in src:
                sys.exit(f"{name}: no {old!r} in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "flash_fwd_tc_kernel" in line and "Function properties" in line:
                hd = re.search(r"ILi(\d+)E", line).group(1)
                print(f"{name} hd{hd}: {lines[i + 1].strip()} | {lines[i + 2].strip()}",
                      flush=True)
            if "C7512" in line:
                print(f"{name}: ptxas serialises the wgmmas (too few registers)", flush=True)
        if name.startswith("c_"):
            continue
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).flash_attention_bf16
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I, I, ctypes.c_longlong,
                       ctypes.c_float, P]
        fn.restype = I
        fns[name] = fn
    return fns


def call(fn, q, k, v, causal=True, window=None, softcap=None):
    B, Sq, H, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, n_kv, hd,
             1.0 / math.sqrt(hd), int(causal), int(window is not None),
             0 if window is None else window, 0.0 if softcap is None else softcap,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def inputs(B, Sq, Sk, H, n_kv, hd, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g, device="cuda").bfloat16(),
            torch.randn(B, Sk, n_kv, hd, generator=g, device="cuda").bfloat16(),
            torch.randn(B, Sk, n_kv, hd, generator=g, device="cuda").bfloat16())


def check(name, fn) -> None:
    good, worst = True, 0.0
    for i, (B, Sq, Sk, H, n_kv, hd, causal, window, softcap) in enumerate(CASES):
        q, k, v = inputs(B, Sq, Sk, H, n_kv, hd, 7 + i)
        got = call(fn, q, k, v, causal, window, softcap)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap)
        d = (got.float() - want.float()).abs()
        good &= bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())
        worst = max(worst, d.max().item())
    print(f"{name}: cases ok {good}, max abs err {worst:.4g}", flush=True)


def time_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    with open(sys.argv[1]) as f:
        variants = json.load(f)[sys.argv[2]]
    print("card:", smi("name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"), flush=True)
    fns = build(variants)
    for name, fn in fns.items():
        check(name, fn)
    for sname, (B, S, H, n_kv, hd) in SHAPES.items():
        q, k, v = inputs(B, S, S, H, n_kv, hd, 0)
        ts = {n: [] for n in fns}
        for n in (list(fns) + list(fns)[::-1]) * 3:
            ts[n].append(time_ms(lambda: call(fns[n], q, k, v)))
        for n, t in ts.items():
            t.sort()
            print(f"time {sname} {n}: median {t[len(t) // 2]:.4f} min {t[0]:.4f} "
                  f"max {t[-1]:.4f} ms", flush=True)
    print("card after:", smi("clocks.sm,power.draw,temperature.gpu"), flush=True)


if __name__ == "__main__":
    main()
