"""A first check of the bf16 sLSTM cluster kernel on one GPU: build it,
print ptxas's registers and spills for each head width it is compiled for
and how many HMMA (mma.sync) instructions the SASS holds, run bf16 cases
against the plain version (h and the final state within 2**-7 of their
scale), print how many clusters fit, and time the kernel and its exchange
floor at the xlstm-1.3b prefill layer (B 4, T 2048, NH 4, hd 512; CUDA
events around 10 calls, three times).

    python3 tools/slstm_tc/first_check.py

Exits 1 if a case is outside the limit or a kernel spills.
"""
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm import ops, ref  # noqa: E402

# B, T, NH, hd, input-gate shift
CASES = [(4, 1, 4, 512, 0.0), (4, 17, 4, 512, 0.0), (1, 5, 4, 512, 0.0), (4, 64, 4, 64, 0.0),
         (2, 9, 4, 32, 0.0), (3, 12, 1, 48, 0.0), (4, 40, 4, 64, 60.0), (16, 64, 4, 512, 0.0),
         (4, 256, 4, 256, 0.0), (4, 128, 8, 512, 0.0), (16, 17, 4, 128, 0.0),
         (16, 3, 8, 512, 0.0), (9, 20, 2, 384, 0.0), (4, 2048, 4, 512, 0.0),
         (4, 2048, 4, 512, 60.0)]
REL = 2.0 ** -7


def inputs(B, T, NH, hd, seed, shift, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, NH, 4, hd, generator=g, device=dev) * 0.5
    x[:, :, :, 1] += shift
    r = torch.randn(NH, hd, 4 * hd, generator=g, device=dev) / hd ** 0.5
    return x.reshape(B, T, NH, 4 * hd).bfloat16().contiguous(), r.bfloat16()


def time_ms(fn, n: int = 10) -> float:
    for _ in range(2):
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
    dev = torch.device("cuda")
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), torch.__version__,
          torch.version.cuda, flush=True)
    t0 = time.time()
    lib = _build.build_all(["slstm"])["slstm"]
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    ok = True
    lines = _build.ptxas_report("slstm").splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and "slstm_tc_kernel" in line:
            ks = re.search(r"ILi(\d+)E", line)
            used = next((x.split(":")[-1].strip() for x in lines[i + 1:i + 3] if "Used" in x), "?")
            print(f"ptxas hd {16 * int(ks.group(1)) if ks else '?'}: {used}; "
                  f"{lines[i + 1].strip()}", flush=True)
            ok &= " 0 bytes spill stores, 0 bytes spill loads" in " " + lines[i + 1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        print("sass: HMMA", sass.count("HMMA"), "LDSM", sass.count("LDSM"),
              "LDGSTS", sass.count("LDGSTS"), "UCGABAR", sass.count("UCGABAR"),
              "STL", sass.count("STL"), flush=True)
    for hd in (64, 128, 256, 384, 512):
        print(f"plan hd {hd}: CL, J = {ops.tc_plan(4, hd)}; clusters that fit "
              f"(NH 4, B 4): {ops.max_active_clusters(4, 4, hd, dev)}", flush=True)
    for i, (B, T, NH, hd, shift) in enumerate(CASES):
        x, r = inputs(B, T, NH, hd, 400 + i, shift, dev)
        tc0 = ops.tc_launches
        h, st = ops.slstm_scan(x, r)
        want_h, want_st = ref.slstm_scan(x, r)
        torch.cuda.synchronize()
        errs = []
        for got, want in [(h, want_h.bfloat16())] + list(zip(st, want_st)):
            d = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            errs.append(d)
            ok &= d <= REL * scale and bool(torch.isfinite(got.float()).all())
        ok &= ops.tc_launches == tc0 + 1
        print(f"B={B} T={T} NH={NH} hd={hd} +{shift:g}: max |d| h/h/c/n/m "
              f"{'/'.join(f'{e:.3g}' for e in errs)} (2**-7 of scale "
              f"{want_h.abs().max().item():.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    B, T, NH, hd = 4, 2048, 4, 512
    x, r = inputs(B, T, NH, hd, 7, 0.0, dev)
    for _ in range(3):
        k = time_ms(lambda: ops.slstm_scan(x, r))
        f = time_ms(lambda: ops.barrier_floor(B, T, NH, hd, torch.bfloat16, dev))
        print(f"time B 4 T 2048 NH 4 hd 512 bf16: kernel {k:.4f} ms, exchange floor "
              f"{f:.4f} ms", flush=True)
    xf, rf = x.float(), r.float()
    print(f"time same shape f32 (cooperative kernel): "
          f"{time_ms(lambda: ops.slstm_scan(xf, rf), 3):.4f} ms", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
