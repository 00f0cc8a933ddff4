"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: the nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds every kernel of the main path from `src/repro_torch/
   kernels/csrc/` (one nvcc per source, all started together);
3. rewafl_select on the card against its plain PyTorch version, bitwise
   (indices, live flags and masks), at S in {100, 1e5, 1e6}, K = 20,
   eps in {0, 0.25}: all available, ~30% unavailable, fewer than K
   available, and a block of equal utilities; and at S in {100, 1e5}
   with exponents (alpha, beta) other than 1;
4. fedavg against its plain version: (20, 206,922) f32, contiguous as
   the round keeps it and with rows padded to a multiple of 4 (the
   kernel's vector path), a ragged unaligned stack, and bf16; f32 within
   atol 1e-5 (the sum order differs), bf16 within 0.05;
5. flash_attention against its plain version: llama heads (H 24, n_kv 8,
   hd 128) causal at S in {17, 128, 2048}, gemma2 heads (H 32, n_kv 16)
   with window 64 and softcap 50 and as a global layer, granite's MQA,
   non-causal Sq != Sk, hd 64 with Sq > Sk, and rows that see no key; f32
   within atol 1e-5 (the sum order differs), bf16 within one bf16 step
   (rtol 2**-7, atol 1e-5);
6. times of each kernel, its plain version and one library call: device
   time from CUDA events around a replayed CUDA graph of 10 calls
   (median of 25, after warm-up), and the kernel's time per call issued
   from Python; beside the least time the card could take for the work;
7. the FL path: `run_fl("cnn@mnist", "rewafl", small=False,
   n_clients=100, n_select=20, rounds=10)` on the card, with every
   kernel's launch count read just after; then a small run on the card
   held against the same run on the CPU (plain versions, same draws):
   selections bitwise, losses and costs within rtol 1e-3;
8. the serving path: `serve("llama3.2-3b", batch=4, prompt_len=2048,
   tokens=32)` at full width (28 layers, d 3072, bf16 weights drawn on
   the card), after one warm-up call, with every kernel's launch count
   read just after (flash_attention: one per layer), then served 4 times
   more for the median and spread of its times; then reduced llama3.2-3b
   and gemma2-27b served on the card and on the CPU from the same
   weights, f32 and bf16: greedy ids equal, last logits within 5e-4 of
   their scale with f32 weights and 3e-2 with bf16 weights;
9. one JSON line of kernels, the card's name and power limit, and last
   `{"ok": true, "device": {...}}`.

`--profile` adds, before the last lines, the device time of 5 FL-path
rounds by kernel, from torch.profiler, and the device's busy share: that
device time over the wall time of the same 5 rounds run without the
profiler (which slows the host), and over the profiled wall time; then
the device time by kernel of one full-width prefill, and of the same
prefill with 8 decode steps, with the device's busy share of the
serving run's unprofiled prefill and decode times.

Without a CUDA device, or without the repository's `src/` beside it, it
exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet) for the bound: HBM3 rate,
# fp32 outside the tensor cores (rewafl_select and fedavg do f32 FMAs),
# and bf16 on the tensor cores (the least time for bf16 attention)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

MAIN_S, MAIN_K, MAIN_ROUNDS = 100, 20, 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _median_ms(run, reps: int, inner: int) -> float:
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return statistics.median(ts)


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median device time of one call: `inner` calls captured in a CUDA
    graph after warm-up, the graph replayed `reps` times between CUDA
    events. The host's time to issue a call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(graph.replay, reps, inner)


def time_eager_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median time of one call issued from Python, as the round issues it:
    CUDA events around `inner` back-to-back calls, after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_ms(run, reps, inner)


def bound(n_bytes: float, n_flops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ rewafl_select

def select_inputs(S: int, case: str, seed: int, dev):
    """Leaves (avail, UtilityInputs, rnd) on the card in the ranges a
    fleet produces; `case` picks the availability pattern or a tie block."""
    from repro_torch.core.utility import UtilityInputs
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(S, generator=g, device=dev)

    stat, t, e = u(0.0, 1e4), u(1.0, 120.0), u(10.0, 2000.0)
    residual, e0, rnd = u(1e3, 6e4), u(100.0, 3e3), u(0.0, 1.0)
    avail = torch.ones(S, dtype=torch.bool, device=dev)
    perm = torch.randperm(S, generator=g, device=dev)
    if case == "unavail30":
        avail = u(0.0, 1.0) >= 0.3
    elif case == "under_k":
        avail = torch.zeros_like(avail)
        avail[perm[:MAIN_K // 2]] = True
    elif case == "ties":
        # 2K devices scattered over the fleet (and over stage-1 tiles)
        # share the largest utility and the largest explore draw
        blk = perm[:min(S, 2 * MAIN_K)]
        stat[blk], t[blk], e[blk] = 1e4, 1.0, 10.0
        residual[blk], e0[blk], rnd[blk] = 6e4, 100.0, 0.999
    return avail, UtilityInputs(stat, t, e, residual, e0), rnd


def phase_select(dev) -> None:
    from repro_torch.core.selection import _explore_slots
    from repro_torch.kernels.rewafl_select import ops, ref
    n = 0
    for S in (100, 100_000, 1_000_000):
        for eps in (0.0, 0.25):
            for ci, case in enumerate(("all", "unavail30", "under_k", "ties")):
                avail, ui, rnd = select_inputs(S, case, 1000 * ci + S % 997, dev)
                kx = _explore_slots(eps, MAIN_K)
                kw = dict(k_exploit=MAIN_K - kx, k_explore=kx, T_round=60.0,
                          alpha=1.0, beta=1.0)
                idx, live = ops.select_topk(avail, ui, rnd, **kw)
                ridx, rlive = ref.select_topk(avail, ui, rnd, **kw)
                torch.cuda.synchronize()
                ok = (torch.equal(idx, ridx) and torch.equal(live, rlive)
                      and torch.equal(ops.mask_from_slots(idx, live, S),
                                      ops.mask_from_slots(ridx, rlive, S)))
                check(ok, f"rewafl_select S={S} eps={eps} case={case}: "
                          f"kernel {idx.tolist()}/{live.tolist()} vs plain "
                          f"{ridx.tolist()}/{rlive.tolist()}")
                n += 1
    # PyTorch's tensor ** scalar special-cases some exponents (2 as x*x,
    # 0.5 as sqrt); the kernel must follow it
    for S in (100, 100_000):
        for eps in (0.0, 0.25):
            for alpha, beta in ((2.0, 0.5), (3.0, 1.7), (0.5, 2.0), (1.3, -0.5)):
                avail, ui, rnd = select_inputs(S, "unavail30", 77 + S % 991, dev)
                kx = _explore_slots(eps, MAIN_K)
                kw = dict(k_exploit=MAIN_K - kx, k_explore=kx, T_round=60.0,
                          alpha=alpha, beta=beta)
                idx, live = ops.select_topk(avail, ui, rnd, **kw)
                ridx, rlive = ref.select_topk(avail, ui, rnd, **kw)
                torch.cuda.synchronize()
                check(torch.equal(idx, ridx) and torch.equal(live, rlive),
                      f"rewafl_select S={S} eps={eps} alpha={alpha} beta={beta}: "
                      f"kernel {idx.tolist()}/{live.tolist()} vs plain "
                      f"{ridx.tolist()}/{rlive.tolist()}")
                n += 1
    print(f"rewafl_select: {n} cases bitwise equal to the plain version",
          flush=True)


def time_select(dev, S: int = MAIN_S) -> dict:
    """Times at the main path's call (eps = 0: K exploit slots)."""
    from repro_torch.core import utility as util
    from repro_torch.kernels.rewafl_select import ops, ref
    K = MAIN_K
    avail, ui, rnd = select_inputs(S, "unavail30", 7, dev)
    kw = dict(k_exploit=K, k_explore=0, T_round=60.0, alpha=1.0, beta=1.0)

    def kernel():
        return ops.select_topk(avail, ui, rnd, **kw)

    def library():
        u = util.rewafl_utility_from(ui, T_round=60.0, alpha=1.0, beta=1.0)
        return torch.topk(torch.where(avail, u, ref.NEG), K)

    # reads five f32 leaves and the bool mask once, writes (K,) idx + live;
    # about 12 flops a device for the utility
    b_ms, b_by = bound(n_bytes=S * (5 * 4 + 1) + 2 * K * 4, n_flops=12 * S)
    return dict(ms=time_ms(kernel), eager_ms=time_eager_ms(kernel),
                plain_ms=time_ms(lambda: ref.select_topk(avail, ui, rnd, **kw)),
                library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


# ------------------------------------------------------------------- fedavg

FEDAVG_K, FEDAVG_P = 20, 206_922   # cnn@mnist at full width


def fedavg_inputs(K: int, P: int, layout: str, dtype, seed: int, dev):
    """(K, P) stack and normalised (K,) weights. layout: "contiguous" (as
    the round keeps it), "padded" (row stride rounded up to a multiple of
    4: the kernel's vector path) or "unaligned" (rows of stride P + 2
    starting one element in)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(K, P, generator=g, device=dev).to(dtype)
    w = torch.rand(K, generator=g, device=dev)
    if layout == "padded":
        x = vals.new_empty(K, -(-P // 4) * 4)[:, :P]
    elif layout == "contiguous":
        x = torch.empty_like(vals)
    else:
        x = vals.new_empty(K, P + 2)[:, 1:P + 1]
    x.copy_(vals)
    return x, w / w.sum()


def phase_fedavg(dev) -> float:
    from repro_torch.kernels.fedavg import ops, ref
    P = FEDAVG_P
    cases = [  # (name, K, P, layout, dtype, atol)
        ("main f32, contiguous", FEDAVG_K, P, "contiguous", torch.float32, 1e-5),
        ("f32 padded rows", FEDAVG_K, P, "padded", torch.float32, 1e-5),
        ("ragged unaligned f32", 7, 1001, "unaligned", torch.float32, 1e-5),
        ("bf16 contiguous", FEDAVG_K, P, "contiguous", torch.bfloat16, 0.05),
        ("bf16 padded rows", FEDAVG_K, P, "padded", torch.bfloat16, 0.05),
    ]
    main_err = None
    for i, (name, K, PP, layout, dtype, atol) in enumerate(cases):
        x, w = fedavg_inputs(K, PP, layout, dtype, 50 + i, dev)
        got = ops.weighted_aggregate(x, w)
        want = ref.weighted_aggregate(x, w)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (PP,), f"fedavg {name}: "
              f"got {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= atol, f"fedavg {name}: max |kernel - plain| = {err} > {atol}")
        print(f"fedavg {name}: K={K} P={PP} max_abs_err={err:.3g} (atol {atol})",
              flush=True)
        if main_err is None:
            main_err = err
    return main_err


def time_fedavg(dev) -> dict:
    from repro_torch.kernels.fedavg import ops, ref
    K, P = FEDAVG_K, FEDAVG_P
    # the round's contiguous stack: P = 206,922 is not a multiple of 4, so
    # the kernel takes its scalar path; padded rows take the vector path
    x, w = fedavg_inputs(K, P, "contiguous", torch.float32, 99, dev)
    xp = fedavg_inputs(K, P, "padded", torch.float32, 99, dev)[0]
    b_ms, b_by = bound(n_bytes=(K * P + P + K) * 4, n_flops=2 * K * P)
    return dict(ms=time_ms(lambda: ops.weighted_aggregate(x, w)),
                padded_ms=time_ms(lambda: ops.weighted_aggregate(xp, w)),
                eager_ms=time_eager_ms(lambda: ops.weighted_aggregate(x, w)),
                plain_ms=time_ms(lambda: ref.weighted_aggregate(x, w)),
                library_ms=time_ms(lambda: torch.matmul(w, x)),
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------- flash_attention

# (name, B, Sq, Sk, H, n_kv, hd, causal, window, softcap, dtype)
FLASH_CASES = [
    ("llama causal S=17 f32", 2, 17, 17, 24, 8, 128, True, None, None, torch.float32),
    ("llama causal S=17 bf16", 2, 17, 17, 24, 8, 128, True, None, None, torch.bfloat16),
    ("llama causal S=128 f32", 2, 128, 128, 24, 8, 128, True, None, None, torch.float32),
    ("llama causal S=128 bf16", 2, 128, 128, 24, 8, 128, True, None, None, torch.bfloat16),
    ("llama causal S=2048 f32", 1, 2048, 2048, 24, 8, 128, True, None, None, torch.float32),
    ("llama causal S=2048 bf16 (main path)", 4, 2048, 2048, 24, 8, 128, True, None, None,
     torch.bfloat16),
    ("gemma2 window 64 softcap 50 S=512 f32", 1, 512, 512, 32, 16, 128, True, 64, 50.0,
     torch.float32),
    ("gemma2 window 64 softcap 50 S=512 bf16", 1, 512, 512, 32, 16, 128, True, 64, 50.0,
     torch.bfloat16),
    ("gemma2 global layer (window 2**30) softcap 50 S=512 bf16", 1, 512, 512, 32, 16, 128,
     True, 2**30, 50.0, torch.bfloat16),
    ("granite MQA S=300 bf16", 2, 300, 300, 48, 1, 128, True, None, None, torch.bfloat16),
    ("non-causal Sq=100 Sk=257 f32", 2, 100, 257, 8, 2, 128, False, None, None, torch.float32),
    ("causal Sq=200 > Sk=70, window 8, hd 64 f32", 1, 200, 70, 4, 2, 64, True, 8, None,
     torch.float32),
    ("reduced gemma2 hd 64 window 8 softcap 50 S=40 f32", 2, 40, 40, 4, 4, 64, True, 8, 50.0,
     torch.float32),
    ("every row masked (causal, window 0) S=130 f32", 1, 130, 130, 4, 2, 64, True, 0,
     None, torch.float32),
    ("non-causal window 0 (the last row sees no key) S=130 f32", 1, 130, 130, 4, 2, 64,
     False, 0, None, torch.float32),
]
MAIN_FLASH = dict(B=4, S=2048, H=24, n_kv=8, hd=128)   # llama3.2-3b prefill
FLASH_F32_ATOL = 1e-5        # the sum order differs
FLASH_BF16_RTOL = 2.0 ** -7  # both round one f32 result to bf16: one step apart


def flash_inputs(B, Sq, Sk, H, n_kv, hd, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).to(dtype))


def phase_flash(dev) -> float:
    """The kernel against its plain version in every case; f32 within atol
    1e-5, bf16 within one bf16 step (rtol 2**-7, atol 1e-5). Returns the
    main-path case's max |kernel - plain|."""
    from repro_torch.kernels.flash_attention import ops, ref
    main_err = None
    for i, (name, B, Sq, Sk, H, n_kv, hd, causal, window, softcap, dt) in enumerate(
            FLASH_CASES):
        q, k, v = flash_inputs(B, Sq, Sk, H, n_kv, hd, dt, 300 + i, dev)
        got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        want = ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == q.shape,
              f"flash {name}: got {got.dtype} {tuple(got.shape)}")
        d = (got.float() - want.float()).abs()
        err = d.max().item()
        if dt == torch.float32:
            ok, tol = err <= FLASH_F32_ATOL, f"atol {FLASH_F32_ATOL}"
        else:
            ok = bool((d <= FLASH_BF16_RTOL * want.float().abs() + 1e-5).all())
            tol = "rtol 2**-7, atol 1e-5"
        check(ok and bool(torch.isfinite(got).all()),
              f"flash {name}: max |kernel - plain| = {err} ({tol})")
        print(f"flash_attention {name}: max_abs_err={err:.3g} ({tol})", flush=True)
        if "main path" in name:
            main_err = err
    return main_err


def time_flash(dev) -> dict:
    """Times at the main path's call: one llama3.2-3b prefill layer, B 4,
    S 2048, bf16, causal."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, n_kv, hd = (MAIN_FLASH[k] for k in ("B", "S", "H", "n_kv", "hd"))
    q, k, v = flash_inputs(B, S, S, H, n_kv, hd, torch.bfloat16, 7, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # views, (B, heads, S, hd)
    # each input read once, the output written once; 4·hd flops for each
    # (query, key) pair the causal mask keeps (q·k and p·v)
    n_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * n_kv * hd)
    n_flops = 4 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOP_PER_S)
    kernel = lambda: ops.flash_attention(q, k, v, causal=True)   # noqa: E731
    return dict(ms=time_ms(kernel), eager_ms=time_eager_ms(kernel),
                plain_ms=time_ms(lambda: ref.attention(q, k, v, causal=True),
                                 reps=5, inner=2),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------- main path

def phase_main_path(dev):
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.rewafl_select import ops as select_ops
    from repro_torch.launch.fl_run import run_fl, summary
    fedavg_ops.launches = select_ops.launches = 0
    t0 = time.time()
    res = run_fl("cnn@mnist", "rewafl", small=False, n_clients=MAIN_S,
                 n_select=MAIN_K, rounds=MAIN_ROUNDS, eval_every=5, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"rewafl_select": select_ops.launches, "fedavg": fedavg_ops.launches}
    R = res.rounds_run
    check(R == MAIN_ROUNDS, f"main path ran {R} rounds, not {MAIN_ROUNDS}")
    check(counts["rewafl_select"] == R,
          f"rewafl_select launched {counts['rewafl_select']} times in {R} rounds")
    check(counts["fedavg"] >= R, f"fedavg launched {counts['fedavg']} times in {R} rounds")
    for k, v in res.history.items():
        check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
              f"history {k!r} has non-finite values")
    check(res.history["H_trace"].shape == (R, MAIN_S),
          f"H_trace shape {res.history['H_trace'].shape}")
    n_sel = res.history["n_selected"]
    check(n_sel.shape == (R,) and int(n_sel.max()) <= MAIN_K,
          f"devices selected per round {n_sel.tolist()} (K = {MAIN_K})")
    check(int(n_sel.min()) > 0, "a round selected no device")
    check(all(0.0 <= a <= 1.0 for a in res.acc_curve) and len(res.acc_curve) == 2,
          f"accuracy curve {res.acc_curve}")
    print(json.dumps(summary(res, scenario="static-paper", telemetry="dense",
                             aggregation="sync", wall_s=wall)), flush=True)
    steady = float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3
    print(f"main path: {R} rounds in {wall:.2f} s, steady {steady:.1f} ms/round "
          f"(last chunk, eval included); launches {counts}", flush=True)
    return counts


def phase_small_agreement(dev) -> None:
    """A small run on the card against the same run on the CPU: the same
    fleet, data, params and draws; kernels on one side, plain versions on
    the other."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_eval_fn
    from repro_torch.launch.engine import run_rounds
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    S, K, R, n = 10, 4, 8, 32
    cfg = quick_cfg(K)
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(1)
    noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n)
             for _ in range(R)]
    out = {}
    for d in ("cpu", dev):
        fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                            init_energy_std=0.04, e0_frac=0.08)
        cx, cy, test = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=64,
                                  device=d)
        out[str(d)] = run_rounds(
            model, fleet, cx, cy, cfg, METHODS["rewafl"], rounds=R,
            params={k: v.to(d) for k, v in params.items()}, chunk_size=4,
            eval_fn=make_eval_fn(model, test["x"], test["y"]),
            noise_fn=lambda r, d=d: type(noise[r])(*(x.to(d) for x in noise[r])),
            device=d)
    a, b = out["cpu"], out[str(dev)]
    check(np.array_equal(a.history["selected"], b.history["selected"]),
          "small run: selections differ between the card and the CPU")
    # cuDNN and the CPU sum convolutions in other orders; eight rounds of
    # SGD grow that last-bit difference to about 1e-4 relative
    rel = {}
    for k in ("global_loss", "round_energy", "round_latency", "mean_H_selected"):
        check(np.allclose(a.history[k], b.history[k], rtol=1e-3, atol=1e-5),
              f"small run: {k} differs: {a.history[k]} vs {b.history[k]}")
        d = np.abs(np.asarray(a.history[k], np.float64) - b.history[k])
        rel[k] = float(np.max(d / np.maximum(np.abs(a.history[k]), 1e-30)))
    check(np.all(np.abs(a.acc_curve - b.acc_curve) <= 1 / 64 + 1e-9),
          f"small run: accuracy {a.acc_curve} vs {b.acc_curve}")
    print(f"small run: {R} rounds on the card agree with the CPU run "
          f"(selections bitwise, losses and costs within rtol 1e-3; max "
          f"relative difference {json.dumps(rel)})", flush=True)


# ------------------------------------------------------------- serving path

SERVE_ARCH, SERVE_B, SERVE_S, SERVE_TOKENS = "llama3.2-3b", 4, 2048, 32
SERVE_REPEATS = 5   # timed serves: the first also counts the launches


def serve_params(dev):
    """Full-width llama3.2-3b weights drawn on the card from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model_api
    cfg = get_config(SERVE_ARCH)
    t0 = time.time()
    with torch.inference_mode():
        params = get_model_api(cfg).init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"serve: {SERVE_ARCH} weights ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_dtype}) drawn on the card in {time.time() - t0:.1f} s", flush=True)
    return cfg, params


def phase_serve(dev, cfg, params):
    """The serving path at full width: prefill B 4 x S 2048, then 32 greedy
    decode steps, with every kernel's launch count read just after; then
    the same serve again, for the median and spread of the times over
    SERVE_REPEATS runs."""
    from repro_torch.configs import param_count
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rewafl_select import ops as select_ops
    from repro_torch.launch.serve import serve, summary
    kw = dict(batch=SERVE_B, prompt_len=SERVE_S, params=params, device=dev)
    serve(SERVE_ARCH, tokens=2, seed=1, **kw)   # warm-up: cuBLAS picks its kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.launches = fedavg_ops.launches = select_ops.launches = 0
    res = serve(SERVE_ARCH, tokens=SERVE_TOKENS, seed=0, **kw)
    counts = {"flash_attention": flash_ops.launches, "fedavg": fedavg_ops.launches,
              "rewafl_select": select_ops.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts["flash_attention"] == cfg.n_layers == res.flash_launches,
          f"flash_attention launched {counts['flash_attention']} times in one "
          f"prefill of {cfg.n_layers} layers")
    check(counts["fedavg"] == counts["rewafl_select"] == 0,
          f"the serving path launched FL kernels: {counts}")
    check(tuple(res.ids.shape) == (SERVE_B, SERVE_TOKENS + 1),
          f"generated ids of shape {tuple(res.ids.shape)}")
    check(int(res.ids.min()) >= 0 and int(res.ids.max()) < cfg.vocab,
          "generated ids outside the vocabulary")
    check(tuple(res.last_logits.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(res.last_logits).all()),
          "last logits not finite or of the wrong shape")
    check(res.n_params == param_count(cfg), "parameter count")
    runs = [summary(r) for r in [res] + [serve(SERVE_ARCH, tokens=SERVE_TOKENS, seed=0, **kw)
                                         for _ in range(SERVE_REPEATS - 1)]]
    out = summary(res)
    for key in ("prefill_ms", "decode_ms_per_token", "decode_tok_per_s"):
        vals = [r[key] for r in runs]
        out[key], out[key + "_runs"] = statistics.median(vals), vals
    out.update(peak_memory_gb=peak_gb, device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    spread = {k: (min(out[k + "_runs"]), max(out[k + "_runs"]))
              for k in ("prefill_ms", "decode_ms_per_token")}
    print(f"serve: {SERVE_ARCH} {res.n_params / 1e9:.3f} B params; median of "
          f"{SERVE_REPEATS}: prefill {SERVE_B} x {SERVE_S} in {out['prefill_ms']:.1f} ms "
          f"(range {spread['prefill_ms'][0]:.1f}-{spread['prefill_ms'][1]:.1f}), decode "
          f"{out['decode_ms_per_token']:.2f} ms/token (range "
          f"{spread['decode_ms_per_token'][0]:.2f}-{spread['decode_ms_per_token'][1]:.2f}; "
          f"{out['decode_tok_per_s']:.1f} tok/s over {SERVE_B} requests), {SERVE_TOKENS} "
          f"tokens decoded; launches {counts}; peak {peak_gb:.2f} GB", flush=True)
    return counts, out


# last logits' error relative to their scale, card against CPU, by weights'
# dtype: f32 weights still round k and v to bf16 caches (the CPU parity
# test measures up to 4.1e-5 against the reference); with bf16 weights
# every layer rounds to bf16 (up to 1.4e-2 there)
SERVE_AGREE_REL = {"float32": 5e-4, "bfloat16": 3e-2}


def phase_serve_agreement(dev) -> None:
    """Reduced llama3.2-3b and gemma2-27b (hd 64; gemma2 with windows and
    softcaps), with f32 and with bf16 weights, served on the card and on
    the CPU from the same weights: greedy ids equal, last logits within
    SERVE_AGREE_REL of their scale."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model_api
    for arch in ("llama3.2-3b", "gemma2-27b"):
        for dt, rel in SERVE_AGREE_REL.items():
            cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype=dt)
            params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
            kw = dict(reduced=True, param_dtype=dt, batch=2, prompt_len=40, tokens=8,
                      seed=5)
            cpu = serve(arch, device="cpu", params=params, **kw)
            card = serve(arch, device=dev, params=_to(params, dev), **kw)
            name = f"{arch} reduced {dt}"
            check(card.flash_launches == cfg.n_layers,
                  f"{name}: {card.flash_launches} flash launches on the card")
            check(torch.equal(cpu.ids, card.ids),
                  f"{name}: greedy ids differ: {cpu.ids.tolist()} vs {card.ids.tolist()}")
            scale = cpu.last_logits.abs().max().item()
            err = (cpu.last_logits - card.last_logits).abs().max().item()
            check(err <= rel * scale, f"{name}: last logits differ by {err} "
                                      f"(scale {scale}, rel {rel})")
            print(f"serve agreement {name}: ids equal over {kw['tokens']} steps, "
                  f"last logits within {err / scale:.3g} of scale {scale:.3g} "
                  f"(limit {rel})", flush=True)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _device_kernels(prof):
    """Device-side kernel events, largest first, and their summed time (s).
    Only kernels: an aten op's device time repeats the time of the kernels
    it launched."""
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return ev, sum(e.self_device_time_total for e in ev) / 1e6


def phase_profile_serve(dev, params, main: dict) -> None:
    """`--profile`: device time by kernel of one full-width prefill, and of
    the same prefill followed by 8 decode steps; the decode's device time
    per step is the difference over 8. Busy shares are taken against the
    unprofiled wall times of the main serving run (`main`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve
    kw = dict(batch=SERVE_B, prompt_len=SERVE_S, params=params, device=dev)
    busy, top = {}, {}
    for n in (0, 8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve(SERVE_ARCH, tokens=n, **kw)
        top[n], busy[n] = _device_kernels(prof)
    step_s = (busy[8] - busy[0]) / 8
    print(f"profile serve: prefill device busy {busy[0] * 1e3:.1f} ms of "
          f"{main['prefill_ms']:.1f} ms unprofiled wall ({100 * busy[0] * 1e3 / main['prefill_ms']:.1f}%); "
          f"decode device busy {step_s * 1e3:.2f} ms/step of "
          f"{main['decode_ms_per_token']:.2f} ms unprofiled wall "
          f"({100 * step_s * 1e3 / main['decode_ms_per_token']:.1f}%)", flush=True)
    for n, label in ((0, "prefill"), (8, "prefill+8 decode")):
        for e in top[n][:10]:
            print(f"profile serve {label}: {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d} calls  {e.key[:80]}", flush=True)


def phase_profile(dev) -> None:
    """`--profile`: device time by kernel over 5 main-path rounds, from
    torch.profiler, and the device's busy share of the rounds' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.fl_run import run_fl
    kw = dict(small=False, n_clients=MAIN_S, n_select=MAIN_K, rounds=5,
              eval_every=5, device=dev)
    run_fl("cnn@mnist", "rewafl", **kw)   # warm-up
    # the same 5 rounds without the profiler, which slows the host
    plain_s = statistics.median(
        float(run_fl("cnn@mnist", "rewafl", **kw).chunk_wall_s.sum())
        for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_fl("cnn@mnist", "rewafl", **kw)
        torch.cuda.synchronize()
    rounds_s = float(res.chunk_wall_s.sum())
    ev, busy_s = _device_kernels(prof)
    print(f"profile: 5 rounds (eval included), device busy {busy_s * 1e3:.1f} "
          f"ms; wall {plain_s * 1e3:.1f} ms without the profiler (median of "
          f"3), busy {100 * busy_s / plain_s:.1f}%; wall {rounds_s * 1e3:.1f} "
          f"ms under it, busy {100 * busy_s / rounds_s:.1f}%", flush=True)
    for e in ev[:15]:
        print(f"profile: {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d} calls  {e.key[:90]}", flush=True)


# --------------------------------------------------------------------- main

def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    try:
        from repro_torch.common import resolve_device
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    dev = resolve_device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name}", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {', '.join(sorted(libs))} in {time.time() - t0:.1f} s", flush=True)

    phase_select(dev)   # bitwise: any difference has failed the run
    fed_err = phase_fedavg(dev)
    flash_err = phase_flash(dev)
    times = {"rewafl_select": time_select(dev), "fedavg": time_fedavg(dev),
             "flash_attention": time_flash(dev)}
    for k, v in list(times.items()) + [
            ("rewafl_select S=1e6", time_select(dev, 1_000_000))]:
        extra = (f", padded rows {v['padded_ms']:.5f} ms"
                 if "padded_ms" in v else "")
        print(f"time {k}: kernel {v['ms']:.5f} ms{extra} (issued from Python "
              f"{v['eager_ms']:.5f} ms), plain {v['plain_ms']:.5f} ms, library "
              f"{v['library_ms']:.5f} ms, bound {v['bound_ms']:.6f} ms "
              f"({v['bound_by']})", flush=True)

    counts = phase_main_path(dev)       # the FL path: rewafl_select, fedavg
    phase_small_agreement(dev)
    cfg, params = serve_params(dev)
    serve_counts, serve_out = phase_serve(dev, cfg, params)
    counts["flash_attention"] = serve_counts["flash_attention"]
    phase_serve_agreement(dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(dev)
        phase_profile_serve(dev, params, serve_out)
    del params

    meta = {
        "rewafl_select": ("src/repro_torch/kernels/csrc/rewafl_select.cu",
                          "src/repro/kernels/rewafl_select/rewafl_select.py:150",
                          0.0, "bitwise"),
        "fedavg": ("src/repro_torch/kernels/csrc/fedavg.cu",
                   "src/repro/kernels/fedavg/fedavg.py:30", fed_err, "atol 1e-5"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:77",
                            flash_err, "bf16 rtol 2**-7 (f32 atol 1e-5)"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=counts[k], max_abs_err=err, **times[k], check=chk)
               for k, (src, rep, err, chk) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
