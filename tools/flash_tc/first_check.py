"""A first check of the bf16 tensor-core flash-attention kernel on one GPU:
build it, print ptxas's report (`-Xptxas -v`) and how many HGMMA (wgmma),
UTMALDG (TMA load), SYNCS (mbarrier) and USETMAXREG (setmaxnreg)
instructions the SASS holds, run 17 bf16 cases against the plain version
at one bf16 step (rtol 2**-7, atol 1e-5), and time the kernel and SDPA at
the llama3.2-3b prefill layer (B 4, S 2048, H 24, n_kv 8, hd 128, causal;
CUDA events around 20 calls, twice).

    python3 tools/flash_tc/first_check.py

Exits 1 if a case is outside the limit.
"""
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# B, Sq, Sk, H, n_kv, hd, causal, window, softcap
CASES = [
    (1, 128, 128, 2, 1, 128, True, None, None), (1, 128, 128, 2, 1, 128, False, None, None),
    (1, 64, 64, 2, 1, 64, True, None, None), (2, 17, 17, 24, 8, 128, True, None, None),
    (1, 512, 512, 24, 8, 128, True, None, None), (1, 512, 512, 32, 16, 128, True, 64, 50.0),
    (1, 300, 300, 32, 16, 128, True, 2**30, 50.0), (2, 300, 300, 48, 1, 128, True, None, None),
    (2, 100, 257, 8, 2, 128, False, None, None), (1, 200, 70, 4, 2, 64, True, 8, None),
    (2, 40, 40, 4, 4, 64, True, 8, 50.0), (1, 130, 130, 4, 2, 64, True, 0, None),
    (1, 130, 130, 4, 2, 64, False, 0, None), (2, 200, 70, 4, 2, 64, True, None, None),
    (1, 100, 257, 8, 2, 64, False, None, None), (2, 77, 77, 8, 8, 64, True, 16, 30.0),
    (4, 2048, 2048, 24, 8, 128, True, None, None),
]


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
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), torch.__version__,
          torch.version.cuda, flush=True)
    t0 = time.time()
    lib = _build.build_all(["flash_attention"])["flash_attention"]
    print(f"build {time.time() - t0:.1f} s", flush=True)
    print(_build.ptxas_report("flash_attention"), flush=True)
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
    for op in ("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG"):
        print("sass", op, sass.count(op), flush=True)
    bad = 0
    for i, (B, Sq, Sk, H, n_kv, hd, causal, window, softcap) in enumerate(CASES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        q = torch.randn(B, Sq, H, hd, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, Sk, n_kv, hd, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, Sk, n_kv, hd, generator=g, device="cuda").bfloat16()
        got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap)
        d = (got.float() - want.float()).abs()
        over = d > 2.0 ** -7 * want.float().abs() + 1e-5
        bad += bool(over.any())
        print(f"case {i} {(B, Sq, Sk, H, n_kv, hd, causal, window, softcap)}: max_abs "
              f"{d.max().item():.4g}, outside the limit {int(over.sum())}", flush=True)
    B, S, H, n_kv, hd = 4, 2048, 24, 8, 128
    q = torch.randn(B, S, H, hd, device="cuda").bfloat16()
    k = torch.randn(B, S, n_kv, hd, device="cuda").bfloat16()
    v = torch.randn(B, S, n_kv, hd, device="cuda").bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for _ in range(2):
        print("time kernel ms", time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
              "sdpa ms", time_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True)), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
