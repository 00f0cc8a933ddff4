"""Build variants of the sLSTM CUDA source side by side, check each against
the plain version, and time them in turns on one GPU.

    python3 tools/slstm_tc/variants.py tools/slstm_tc/runs.json 2

`runs.json` maps a run number to its variants: name -> a list of
[old, new] string replacements applied to
`src/repro_torch/kernels/csrc/slstm.cu`; a list may start with
["_source", path] (another file as the base). For each variant the script
prints ptxas's registers and spills of the bf16 cluster kernel at hd 512,
whether 5 bf16 cases (the main shape, B 16, hd 256, hd 64, input gates
+60) stay within 2**-7 of the scale of the plain version's h and final
state, and the device time of one call and of its exchange floor
(`ops.barrier_floor`) at B 4, T 2048, NH 4, hd 512: CUDA events around 10
calls, five turns alternating over the variants, median, min and max. A
name that starts with "t_" is an ablation for timing only: its check is
printed and does not fail the run. The variants are built in
`build/slstm_variants/`, which is git-ignored.
"""
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm import ops, ref  # noqa: E402

SRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc/slstm.cu")
OUT = os.path.join(ROOT, "build/slstm_variants")
# B, T, NH, hd, input-gate shift
CASES = [(4, 2048, 4, 512, 0.0), (16, 64, 4, 512, 0.0), (4, 256, 4, 256, 0.0),
         (4, 64, 4, 64, 0.0), (4, 512, 4, 512, 60.0)]
MAIN = (4, 2048, 4, 512)


def build(variants: dict) -> dict:
    """name -> bound library, all nvcc runs in parallel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, reps in variants.items():
        src = open(SRC).read()
        if reps and reps[0][0] == "_source":
            src = open(os.path.join(ROOT, reps[0][1])).read()
            reps = reps[1:]
        for old, new in reps:
            if old not in src:
                sys.exit(f"{name}: no {old!r} in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and "slstm_tc_kernelILi32E" in line:
                used = next((x.split(":")[-1].strip() for x in lines[i + 1:i + 3]
                             if "Used" in x), "?")
                print(f"{name}: ptxas hd 512: {used}; {lines[i + 1].strip()}", flush=True)
        libs[name] = ops.bind(ctypes.CDLL(os.path.join(OUT, f"{name}.so")))
    return libs


def use(lib) -> None:
    """Point the wrapper at one variant's library."""
    ops._lib = functools.cache(lambda: lib)


def inputs(B, T, NH, hd, seed, shift, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, NH, 4, hd, generator=g, device=dev) * 0.5
    x[:, :, :, 1] += shift
    r = torch.randn(NH, hd, 4 * hd, generator=g, device=dev) / hd ** 0.5
    return x.reshape(B, T, NH, 4 * hd).bfloat16().contiguous(), r.bfloat16()


def check(name: str, plain: list) -> bool:
    ok, worst = True, 0.0
    for (x, r), (want_h, want_st) in plain:
        h, st = ops.slstm_scan(x, r)
        torch.cuda.synchronize()
        for got, want in [(h, want_h.bfloat16())] + list(zip(st, want_st)):
            d = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            worst = max(worst, d / scale)
            ok &= d <= 2.0 ** -7 * scale and bool(torch.isfinite(got.float()).all())
    print(f"{name}: {'ok' if ok else 'FAIL'} (worst |d| / scale {worst:.3g})", flush=True)
    return ok


def time_ms(fn, n: int = 10) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main() -> None:
    dev = torch.device("cuda")
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), flush=True)
    with open(sys.argv[1]) as f:
        variants = json.load(f)[sys.argv[2]]
    libs = build(variants)
    plain = []
    for i, (B, T, NH, hd, shift) in enumerate(CASES):
        x, r = inputs(B, T, NH, hd, 400 + i, shift, dev)
        plain.append(((x, r), ref.slstm_scan(x, r)))
    ok = True
    for name, lib in libs.items():
        use(lib)
        ok &= check(name, plain) or name.startswith("t_")
    B, T, NH, hd = MAIN
    x, r = inputs(B, T, NH, hd, 7, 0.0, dev)
    runs = {n: {"kernel": [], "floor": []} for n in libs}
    for name, lib in libs.items():   # warm-up
        use(lib)
        ops.slstm_scan(x, r)
        ops.barrier_floor(B, T, NH, hd, torch.bfloat16, dev)
    torch.cuda.synchronize()
    for _ in range(5):
        for name, lib in libs.items():
            use(lib)
            runs[name]["kernel"].append(time_ms(lambda: ops.slstm_scan(x, r)))
            runs[name]["floor"].append(time_ms(
                lambda: ops.barrier_floor(B, T, NH, hd, torch.bfloat16, dev)))
    for name, t in runs.items():
        print(f"time {name}: " + ", ".join(
            f"{k} {statistics.median(v):.4f} ms ({min(v):.4f}-{max(v):.4f})"
            for k, v in t.items()), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
