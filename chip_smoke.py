"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: the nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds every kernel from `src/repro_torch/kernels/csrc/`
   (one nvcc per source, all started together), and prints ptxas's
   registers and spills of the flash-attention kernels and of the slstm
   kernels (`-Xptxas -v`); neither bf16 tensor-core kernel may spill;
3. rewafl_select on the card against its plain PyTorch version, bitwise
   (indices, live flags and masks), at S in {1, 100, 2047, 2048, 2049,
   8192, 8193, 1e5, 1e6}, K in {1, 20, 256, 257, S} (K <= S; K = S up to
   1e5), eps in {0, 0.1, 0.5}: all available, ~30% unavailable, fewer
   than K available, none available, a block of equal utilities, NaN
   utilities, and -0 and +0 utilities; at S in {100, 1e5} with exponents
   (alpha, beta) other than 1; and which kernels a call runs (the
   wrapper's plan, and the names torch.profiler sees): `select_one` alone
   at S 100, `select_tiles` and `select_merge` at S 1e6;
4. fedavg against its plain version: (20, 206,922) f32, contiguous as
   the round keeps it, (30, 206,922) f32 as the async buffer holds it
   (buffer_m 10 + K 20 slots), rows padded to a multiple of 4 (the
   kernel's vector path), a ragged unaligned stack, and bf16; f32 within
   atol 1e-5 (the sum order differs), bf16 within 0.05; and the async
   buffer with one row of NaNs at weight 0 (a stale dead slot): NaN at
   the same positions on both sides, as 0 · NaN is NaN;
5. flash_attention against its plain version: llama heads (H 24, n_kv 8,
   hd 128) causal at S in {17, 128, 2048}, gemma2 heads (H 32, n_kv 16)
   with window 64 and softcap 50 and as a global layer, granite's MQA,
   non-causal Sq != Sk, hd 64 with Sq > Sk, and rows that see no key,
   bf16 at hd 64 with ragged Sq and Sk, olmoe-1b-7b's prefill layer
   (B 4, S 2048, H 16, n_kv 16: GQA group 1), and hd 112 (zamba2-7b's
   shared attention, run in the kernels' layout of 128): its prefill
   layer (B 4, S 2048, H 32, n_kv 32, window 4096), a window of 512 < S,
   GQA, Sq != Sk and Sq > Sk, bf16 and f32; f32 within atol 1e-5 (the sum order
   differs), bf16 within one bf16 step (rtol 2**-7, atol 1e-5); bf16 runs
   the tensor-core kernel, f32 the CUDA-core one (counted); slstm against its plain version at B in
   {1, 4}, T in {1, 17, 2048}, (NH, hd) in {(4, 64), (4, 512)}, f32 and
   bf16, and with input-gate pre-activations near +60 (the stabiliser m),
   and in bf16 at B 16 (two n8 tiles), hd 256 (clusters of 4) and NH 8 at
   hd 512 (eight clusters of 16, more than the card holds at once), and
   at B 17 and 32, f32 and bf16 (two launches, one a slice of at most 16
   rows, counted): h and
   the final state within 1e-5 of their scale (at least 1) in f32 and
   within one bf16 step of their scale (2**-7 of max |plain|) in bf16;
   bf16 runs the cluster kernel, f32 the cooperative one (counted), and
   each bf16 shape's cluster size and how many of its clusters fit
   (cudaOccupancyMaxActiveClusters) are printed; stat_util against its
   plain version at (20, 32), (100, 17) and (1e6, 32), f32 and bf16
   losses, within rtol 1e-5;
6. times of each kernel, its plain version and one library call where
   one PyTorch call computes the same function: device time from CUDA
   events around a replayed CUDA graph of 10 calls (median of 25, after
   warm-up; slstm 2 calls, median of 10), and the kernel's time per call
   issued from Python; beside the least time the card could take for the
   work and the launch floor, the time of the smallest PyTorch kernel on
   the same timer (`zero_()` on one element, `launch_floor_ms`); for
   slstm also the floor of its 2,048 sequential steps, the exchange of h
   between a cluster's blocks alone on the same clusters; rewafl_select
   at S 100 and 1e6, stat_util at S 1e6, fedavg at the async land's
   (30, 206,922), flash_attention at olmoe-1b-7b's and zamba2-7b's
   prefill layers beside SDPA, and the f32 kernel at hd 112 (B 1, S 512,
   H 32); one zamba2-7b Mamba2 layer's chunked SSD (plain PyTorch) and
   its f32 product of the bf16 mixing matrix with x, beside its bound;
   then the campaigns' batched calls (each kernel's op under
   `torch.func.vmap`, one launch a call): fedavg at (18, 20, 206,922)
   and (18, 40, 206,922) f32 with a NaN row at weight 0, within atol 1e-5
   and bitwise the 18 single launches; rewafl_select at B 6 x S 100 and
   B 3 x S 8,193 (~30% unavailable, NaN and ±0 utilities), bitwise the
   plain version and the single launches; stat_util at 18 x (20, 32);
   their times at the grid's shapes beside the plain batched versions, a
   library call (`torch.bmm`, a batched `topk`, `vector_norm`) and the
   bound;
7. the FL path: `run_fl("cnn@mnist", "rewafl", small=False,
   n_clients=100, n_select=20, rounds=10)` on the card, with every
   kernel's launch count read just after (stat_util once a round); then
   each method (random, oort, autofl, reafl, reafl_lupa, rewafl) on
   cnn@mnist, and rewafl and oort on cnn@har and lstm@shakespeare, each
   `run_fl(task, method, small=False, n_clients=100, n_select=20,
   rounds=6, eval_every=3)` with its launches counted from 0 (stat_util
   once a round, fedavg at least once, rewafl_select once a round for
   the rea methods and never for the others), finite history, 1 to 20
   devices a round, and its steady ms/round (the second chunk); the
   same run of rewafl on cnn@mnist under each fleet-dynamics scenario
   (commuter-diurnal, congested-urban, overnight-charging, churn-heavy),
   with no more devices available than online in any round, and the
   online and charging counts moving under churn-heavy; then small runs
   on the card held against the same runs on the CPU (plain versions,
   same draws, environment draws included) for rewafl, random, oort and
   autofl on cnn@mnist, rewafl with the probe every 2 rounds, rewafl on
   cnn@har and lstm@shakespeare, rewafl under each dynamic scenario and
   random under churn-heavy: selections and the charging, online and
   available counts bitwise, losses and costs within rtol 1e-3; then
   commuter-diurnal's round body from round 3,600 (every device in its
   weekend) for 3 rounds on the card and on the CPU, held the same way,
   the environment bitwise; then the async and fault paths at full
   width, each `run_fl("cnn@mnist", "rewafl", small=False, n_clients=100,
   n_select=20, rounds=6, eval_every=3, ...)` with its launches counted
   from 0 (rewafl_select and stat_util once a round, fedavg once a round
   sync and 1 + ceil(K / M) async) and finite history and parameters:
   async at the defaults (M 10, wall delays: fewer than M pending at every
   round end, dispatched = landed + pending, a clock that never goes
   back), async at M = K with unit delays beside the sync run of the same
   call (selections and counters equal, losses within rtol 1e-3),
   lossy-uplink (uploads lost), flaky-fleet sync and async (aborts,
   corruptions and rejections); then small async and fault runs on the
   card against the CPU (async M 2 with delay jitter, M = K unit, a slot
   TTL under 50x stragglers, lossy-uplink, flaky-fleet, flaky-fleet
   async): selections and every integer counter bitwise, losses, costs
   and the virtual clock within rtol 1e-3; then streaming telemetry at
   full width, beside the dense run of the same call (`run_fl(...,
   telemetry="streaming", health=HealthCfg(max_near_frac=None),
   trace=...)`, launches counted from 0 as for the runs above: the
   selection-count reducer equal to the dense `sel_count`, `tel/H/last`
   to the final H, no per-device key in the history, the per-round
   scalars within rtol 1e-3 of the dense run's, the trace's spans (chunk
   and dispatch twice, history_drain, eval, health, transfer), the health
   table and the span table printed, steady ms/round of both), async
   streaming at M 10 (ASYNC_SPECS; fedavg 3 a round; the last virtual
   clock equal to the history's), and small streaming runs with the
   health monitors on the card against the CPU (rewafl static and
   churn-heavy, async M 2 with jitter, flaky-fleet with FAULT_SPECS):
   integer reducers and health samples bitwise, float reducers within
   rtol 1e-3, quantiles within one bin width, and the histogram bins of
   NaN, ±inf and values beyond int32 on the card and the CPU (the
   compiled reference's: NaN and -inf first, +inf last); then
   the (method x seed) grid: `run_campaign_grid` of the six methods x
   seeds {0, 1, 2} on cnn@mnist at full width (S 100, K 20), 6 rounds in
   chunks of 3, per-seed fleets, streaming telemetry (DEFAULT_SPECS, rings
   of H and the masks, the health quantiles), launches counted from 0
   (fedavg and stat_util once a round for all 18 cells, rewafl_select
   never), each cell against its single campaign (round 0's masks
   bitwise, counters equal and losses within rtol 1e-3 until the masks
   part, printed), its steady ms/round beside the sum of the 18 single
   campaigns' and its peak memory; the per-method seed batch
   (`run_campaign_batch` of rewafl over seeds 0-5: one batched
   rewafl_select launch a round) against its singles the same way; the
   loop engine (`run_fl(..., engine="loop")`, 6 rounds, evaluated at 0,
   3 and 5) beside the chunked run; exact checkpoint and resume at the
   main path's widths, sync and async (M 10) on static-paper and
   flaky-fleet: 6 rounds in chunks of 2 uninterrupted against 4 with
   `checkpoint_every=2` resumed to 6 (`carry_sha` equal, rows 4-5 and
   the final state bitwise, the resumed run's launches those of its 2
   rounds), then the newest checkpoint corrupted: resumed from round 2,
   the carry the stopped run's; each checkpoint's bytes and its write
   and load ms; a small mixed sync x async grid and
   a small flaky-fleet grid on the card against the CPU (selections and
   counters bitwise, floats within rtol 1e-3); then
   `select_aggregate` (the select kernel, then `fedavg_indexed`, which
   reads the K selected rows in place) against its plain version (the
   dense masked sum) at S 100, K 20, P 206,922, S 8,193, K 257, P 4,096
   and S 8,193, K 257, P 206,922, f32 and bf16 deltas, eps 0 and 0.1,
   ~30% and all but K/2 devices unavailable: masks bitwise, the
   aggregate within atol 1e-5, one launch counted by each wrapper a
   call; at the first and last shape the device kernels a call
   (torch.profiler: 2, and 3 above 8,192 devices) and its times
   (graph-replayed, issued from Python, L2-cold after 256 MB are
   written; with programmatic dependent launch and without) beside the
   same steps issued one by one, and fedavg_indexed alone beside
   `embedding_bag`;
8. the serving paths, each `serve(arch, batch=4, prompt_len=2048,
   tokens=32)` at full width with bf16 weights drawn on the card, after
   one warm-up call, with every kernel's launch count read just after,
   then served again for the median and spread of its times:
   llama3.2-3b (28 layers, d 3072; flash_attention's tensor-core kernel
   once per layer, 5 serves), xlstm-1.3b (48 layers, d 2048; slstm's
   cluster kernel once per sLSTM layer, 6, 3 serves) and olmoe-1b-7b (16
   MoE layers, d 2048, 64 experts, top 8, the dense oracle;
   flash_attention's tensor-core kernel once per layer, 16, 4 serves) and
   zamba2-7b (81 Mamba2 layers, d 3584, a shared attention block of hd
   112 after every 6: flash_attention's tensor-core kernel 13 times, 3
   serves), with each serve's peak memory beside the card's name and
   power limit; kimi-k2-1t-a32b at full width is not
   attempted (one line: its parameters and the bytes its bf16 weights
   need against the card's memory); then reduced
   llama3.2-3b, gemma2-27b and xlstm-1.3b (at batch 2, and xlstm-1.3b at
   batch 17 too: two slstm launches a layer) served on the card and on the
   CPU from the same weights, f32 and bf16: greedy ids equal, last logits
   within 5e-4 of their scale with f32 weights and 3e-2 with bf16 weights
   (f32 weights run the CUDA-core flash kernel and the cooperative slstm
   kernel, bf16 the tensor-core ones); and reduced olmoe-1b-7b and
   kimi-k2-1t-a32b at batch 2, f32 and bf16, on the card and on the CPU
   under the flip rule (`tests/moe_flip_rule.py`: a token that chose other
   experts with no earlier flip upstream of it lies within 5e-4 (f32) or
   2**-5 (bf16) of a tie on the CPU's side; router inputs, ids and last
   logits that no flip reached within 5e-4 / 3e-2 of their scale), with
   each one's flip count and the largest gap among flips printed; and
   reduced zamba2-7b at prompt 128 (two SSD chunks; window 8 wraps the
   ring) and batch 2, f32 and bf16, card against CPU as the dense ones;
9. a JSON line of `select_aggregate`'s check and times, one of the
   grid's and the seed batch's ms/round beside their singles', one of
   kernels (each FL kernel with its batched call's check and times),
   the card's name and power limit, and last `{"ok": true, "device":
   {...}}`.

`--profile` adds, before the last lines, the device time of 5 FL-path
rounds by kernel, and of 5 rounds of rewafl on lstm@shakespeare, from
torch.profiler, with the engine's host phases (the trace spans, entered
as `record_function` ranges by `Tracer(profiler=True)`), and the
device's busy share: that
device time over the wall time of the same 5 rounds run without the
profiler (which slows the host), and over the profiled wall time; then,
for each serving path, the device time by kernel of one full-width
prefill, and of the same prefill with 8 decode steps, with the device's
busy share of the serving run's unprofiled prefill and decode times;
and the device time by kernel of one 3-round chunk of the 18-cell grid,
with its busy share.

Without a CUDA device, or without the repository's `src/` beside it, it
exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.append(os.path.join(ROOT, "tests"))   # the flip rule the card's moe tests use

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

SELECT_CASES = ("all", "unavail30", "under_k", "none", "ties", "nan", "negzero")


def select_grid():
    """(S, K) of the bitwise check: S up to 1e6, around 2,048 and around
    the one-block limit and stage-1 tile (8,192); K 1, 20, 256, 257 and S
    (K = S up to S 1e5)."""
    grid = []
    for S in (1, 100, 2047, 2048, 2049, 8192, 8193, 100_000, 1_000_000):
        ks = {1, MAIN_K, 256, 257} | ({S} if S <= 100_000 else set())
        grid += [(S, K) for K in sorted(ks) if K <= S]
    return grid


def select_inputs(S: int, case: str, seed: int, dev, K: int = MAIN_K):
    """Leaves (avail, UtilityInputs, rnd) on the card in the ranges a
    fleet produces; `case` picks the availability pattern, a tie block,
    NaN utilities or signed zeros."""
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
        avail[perm[:K // 2]] = True
    elif case == "none":
        avail = torch.zeros_like(avail)
    elif case == "ties":
        # 2K devices scattered over the fleet (and over stage-1 tiles)
        # share the largest utility and the largest explore draw
        blk = perm[:min(S, 2 * K)]
        stat[blk], t[blk], e[blk] = 1e4, 1.0, 10.0
        residual[blk], e0[blk], rnd[blk] = 6e4, 100.0, 0.999
    elif case == "nan":       # NaN utilities rank last and are live
        stat[perm[:max(1, S // 10)]] = float("nan")
    elif case == "negzero":   # -0 and +0 utilities: +0 ranks first (total order)
        blk = perm[:max(1, S // 4)]
        stat[blk[::2]] = -0.0
        e[blk[1::2]] = 1e9    # e above the headroom: utility +0
    return avail, UtilityInputs(stat, t, e, residual, e0), rnd


def phase_select(dev) -> None:
    from repro_torch.core.selection import _explore_slots
    from repro_torch.kernels.rewafl_select import ops, ref
    n = 0
    for S, K in select_grid():
        for eps in (0.0, 0.1, 0.5):
            kx = _explore_slots(eps, K)
            kw = dict(k_exploit=K - kx, k_explore=kx, T_round=60.0, alpha=1.0, beta=1.0)
            for ci, case in enumerate(SELECT_CASES):
                avail, ui, rnd = select_inputs(S, case, 1000 * ci + S % 997 + K, dev, K)
                idx, live = ops.select_topk(avail, ui, rnd, **kw)
                ridx, rlive = ref.select_topk(avail, ui, rnd, **kw)
                torch.cuda.synchronize()
                ok = (torch.equal(idx, ridx) and torch.equal(live, rlive)
                      and torch.equal(ref.mask_from_slots(idx, live, S),
                                      ref.mask_from_slots(ridx, rlive, S)))
                if not ok:
                    bad = torch.nonzero((idx != ridx) | (live != rlive)).flatten()[:8]
                    fail(f"rewafl_select S={S} K={K} eps={eps} case={case}: slots "
                         f"{bad.tolist()} differ: kernel {idx[bad].tolist()}/"
                         f"{live[bad].tolist()} vs plain {ridx[bad].tolist()}/"
                         f"{rlive[bad].tolist()}")
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
    # the kernels one call runs: the wrapper's plan (no scratch: one block
    # holds the fleet) and the names the profiler sees; one block up to
    # 8,192 devices, per-tile candidates and one merging block above
    lib = ops._lib()
    for S, want in ((MAIN_S, {"select_one"}),
                    (1_000_000, {"select_tiles", "select_merge"})):
        one_block = lib.rewafl_select_scratch(S, MAIN_K, 0) == 0
        check(one_block == (S <= 8192),
              f"rewafl_select S={S}: plan is {'one' if one_block else 'two'} launches")
        names = select_kernels(dev, S)
        check(names == want, f"rewafl_select S={S}: calls ran the kernels "
                             f"{sorted(names)}, not {sorted(want)}")
        print(f"rewafl_select S={S}: a call runs {sorted(names)}", flush=True)


def select_kernels(dev, S: int, calls: int = 3) -> set:
    """The names of the selection kernels that `calls` main-path-shaped
    calls at fleet size S ran, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rewafl_select import ops
    avail, ui, rnd = select_inputs(S, "unavail30", 3, dev)
    kw = dict(k_exploit=MAIN_K, k_explore=0, T_round=60.0, alpha=1.0, beta=1.0)
    ops.select_topk(avail, ui, rnd, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.select_topk(avail, ui, rnd, **kw)
        torch.cuda.synchronize()
    return {m.group(0) for e in _device_kernels(prof)[0]
            if (m := re.search(r"select_(one|tiles|merge)", e.key))}


def time_select(dev, S: int = MAIN_S) -> dict:
    """Times at the main path's call (eps = 0: K exploit slots)."""
    from repro_torch.core import utility as util
    from repro_torch.kernels.rewafl_select import ops, ref
    K = MAIN_K
    avail, ui, rnd = select_inputs(S, "unavail30", 7, dev, K)
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


def time_launch_floor() -> float:
    """The smallest PyTorch kernel on the kernels' timer: `zero_()` on a
    one-element tensor."""
    one = torch.empty(1, device="cuda")
    return time_ms(one.zero_)


# ------------------------------------------------------------------- fedavg

FEDAVG_K, FEDAVG_P = 20, 206_922   # cnn@mnist at full width
ASYNC_SLOTS = 10 + FEDAVG_K        # the async buffer: buffer_m 10 + K slots


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
        ("async buffer f32", ASYNC_SLOTS, P, "contiguous", torch.float32, 1e-5),
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


def phase_fedavg_nan(dev) -> None:
    """The async buffer with one row holding NaNs at weight 0 (a stale
    dead slot): 0 · NaN = NaN, so the kernel and its plain version both
    give NaN at that row's NaN positions and agree elsewhere."""
    from repro_torch.kernels.fedavg import ops, ref
    x, w = fedavg_inputs(ASYNC_SLOTS, FEDAVG_P, "contiguous", torch.float32, 61, dev)
    x[7, ::7] = float("nan")
    w[7] = 0.0
    got, want = ops.weighted_aggregate(x, w), ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and int(nan.sum()) == -(-FEDAVG_P // 7),
          f"fedavg NaN row: NaN at {int(torch.isnan(got).sum())} positions, plain "
          f"{int(nan.sum())}")
    err = (got[~nan] - want[~nan]).abs().max().item()
    check(err <= 1e-5, f"fedavg NaN row: max |kernel - plain| off the NaNs = {err}")
    print(f"fedavg NaN row at weight 0: K={ASYNC_SLOTS} P={FEDAVG_P}, NaN at the same "
          f"{int(nan.sum())} positions in both, max_abs_err elsewhere {err:.3g}", flush=True)


def time_fedavg(dev, K: int = FEDAVG_K) -> dict:
    from repro_torch.kernels.fedavg import ops, ref
    P = FEDAVG_P
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
    ("causal Sq=200 > Sk=70, hd 64 bf16", 2, 200, 70, 4, 2, 64, True, None, None,
     torch.bfloat16),
    ("non-causal Sq=100 Sk=257, hd 64 bf16", 1, 100, 257, 8, 2, 64, False, None, None,
     torch.bfloat16),
    ("window 16 softcap 30 S=77, hd 64 bf16", 2, 77, 77, 8, 8, 64, True, 16, 30.0,
     torch.bfloat16),
    ("every row masked (causal, window 0) S=130 hd 64 bf16", 1, 130, 130, 4, 2, 64, True, 0,
     None, torch.bfloat16),
    ("olmoe causal S=2048 H 16 n_kv 16 bf16 (moe serving path)", 4, 2048, 2048, 16, 16,
     128, True, None, None, torch.bfloat16),
    # hd 112: zamba2-7b's shared attention, in the kernels' layout of 128
    ("zamba2 causal window 4096 S=2048 H 32 n_kv 32 hd 112 bf16 (hybrid serving path)",
     4, 2048, 2048, 32, 32, 112, True, 4096, None, torch.bfloat16),
    ("hd 112 window 512 < S=2048 bf16", 2, 2048, 2048, 32, 32, 112, True, 512, None,
     torch.bfloat16),
    ("hd 112 GQA (H 32, n_kv 8) ragged S=300 bf16", 2, 300, 300, 32, 8, 112, True, None,
     None, torch.bfloat16),
    ("hd 112 non-causal Sq=100 Sk=257 bf16", 1, 100, 257, 8, 2, 112, False, None, None,
     torch.bfloat16),
    ("hd 112 causal Sq=200 > Sk=70 window 8 bf16", 1, 200, 70, 4, 2, 112, True, 8, None,
     torch.bfloat16),
    ("hd 112 causal window 4096 S=512 H 32 n_kv 32 f32", 1, 512, 512, 32, 32, 112, True,
     4096, None, torch.float32),
    ("hd 112 window 8 GQA S=200 f32", 2, 200, 200, 8, 2, 112, True, 8, None, torch.float32),
    ("hd 112 non-causal Sq=100 Sk=257 f32", 2, 100, 257, 8, 2, 112, False, None, None,
     torch.float32),
    ("hd 112 causal Sq=200 > Sk=70 window 8 softcap 50 f32", 1, 200, 70, 4, 2, 112, True,
     8, 50.0, torch.float32),
]
MAIN_FLASH = dict(B=4, S=2048, H=24, n_kv=8, hd=128)   # llama3.2-3b prefill
OLMOE_FLASH = dict(B=4, S=2048, H=16, n_kv=16, hd=128)  # olmoe-1b-7b prefill (group 1)
# zamba2-7b's shared attention at its prefill, as the path calls it (window
# 4096 >= S: the causal mask alone), and the f32 kernel at hd 112
ZAMBA_FLASH = dict(B=4, S=2048, H=32, n_kv=32, hd=112, window=4096)
ZAMBA_F32_FLASH = dict(B=1, S=512, H=32, n_kv=32, hd=112, window=4096, dtype=torch.float32)
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
        tc0 = ops.tc_launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        want = ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == q.shape,
              f"flash {name}: got {got.dtype} {tuple(got.shape)}")
        check(ops.tc_launches - tc0 == int(dt == torch.bfloat16),
              f"flash {name}: the tensor-core kernel ran {ops.tc_launches - tc0} times")
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


def time_flash(dev, shape: dict = MAIN_FLASH) -> dict:
    """Times at one prefill layer's call, causal, bf16 unless `shape` names
    a dtype: the main path's (llama3.2-3b, B 4, S 2048) unless `shape`
    names another, with its window where it has one (at least S: the
    library call takes the causal mask alone)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, n_kv, hd = (shape[k] for k in ("B", "S", "H", "n_kv", "hd"))
    window, dt = shape.get("window"), shape.get("dtype", torch.bfloat16)
    check(window is None or window >= S, f"time_flash: window {window} < S {S}")
    q, k, v = flash_inputs(B, S, S, H, n_kv, hd, dt, 7, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # views, (B, heads, S, hd)
    # each input read once, the output written once; 4·hd flops for each
    # (query, key) pair the causal mask keeps (q·k and p·v)
    n_bytes = q.element_size() * (2 * B * S * H * hd + 2 * B * S * n_kv * hd)
    n_flops = 4 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(n_bytes, n_flops,
                       BF16_FLOP_PER_S if dt == torch.bfloat16 else F32_FLOP_PER_S)
    kernel = lambda: ops.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
    return dict(ms=time_ms(kernel), eager_ms=time_eager_ms(kernel),
                plain_ms=time_ms(lambda: ref.attention(q, k, v, causal=True, window=window),
                                 reps=5, inner=2),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                bound_ms=b_ms, bound_by=b_by)


def time_ssd(dev) -> dict:
    """One Mamba2 layer's chunked SSD (`nn/ssm._ssd_chunk_scan`, plain
    PyTorch: the reference has no kernel for it) at zamba2-7b's prefill:
    B 4, L 2048, 112 heads of 64, state 64, bf16 operands; and its largest
    product alone, the mixing matrix M (rounded to bf16) times x in f32
    (TF32 off): 14,336 products of 64 x 64 x 64, with its bound."""
    from repro_torch.nn import ssm
    B, L, H, P, N, cl = 4, 2048, 112, 64, 64, 64
    nc = L // cl
    dims = ssm.Mamba2Dims(3584, H * P, H, P, N)
    g = torch.Generator(device=dev).manual_seed(11)
    xh = torch.randn(B, L, H, P, generator=g, device=dev).to(torch.bfloat16)
    dtp = torch.rand(B, L, H, generator=g, device=dev) * 0.1
    A = torch.linspace(1.0, 16.0, H, device=dev)
    Bc, Cc = (torch.randn(B, L, N, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    M = torch.randn(B, nc, cl, cl, H, generator=g, device=dev).to(torch.bfloat16).float()
    xc = xh.reshape(B, nc, cl, H, P).float()
    b_ms, b_by = bound(4 * (M.numel() + 2 * xc.numel()), 2 * B * nc * cl * cl * H * P)
    out = dict(ssd_ms=time_ms(lambda: ssm._ssd_chunk_scan(xh, dtp, A, Bc, Cc, dims),
                              reps=5, inner=2),
               mx_ms=time_ms(lambda: torch.einsum("bcijh,bcjhp->bcihp", M, xc),
                             reps=5, inner=2),
               mx_bound_ms=b_ms, mx_bound_by=b_by)
    print(f"time ssd zamba2-7b layer (B {B}, L {L}, H {H}, P {P}, N {N}, bf16 operands): "
          f"_ssd_chunk_scan {out['ssd_ms']:.5f} ms; its f32 M x product "
          f"{out['mx_ms']:.5f} ms, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return out


# -------------------------------------------------------------------- slstm

MAIN_SLSTM = dict(B=4, T=2048, NH=4, hd=512)   # one xlstm-1.3b prefill layer
# tolerances relative to a tensor's scale max|plain|: f32 within 1e-5 of
# max(1, scale) (the sum order differs; m and n grow to 10-60 with large
# input gates, where f32's own spacing is ~4e-6), bf16 within one bf16 step
# of the scale (a product rounded on the other side of a tie moves the
# steps after it)
SLSTM_F32_REL = 1e-5
SLSTM_BF16_REL = 2.0 ** -7


def slstm_inputs(B, T, NH, hd, dtype, seed, dev, gate_shift=0.0):
    """x_pre (B, T, NH, 4hd) ~ N(0, 0.25), `gate_shift` added to the input
    gate's columns; R (NH, hd, 4hd) ~ N(0, 1/hd), as the model draws it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, NH, 4, hd, generator=g, device=dev) * 0.5
    x[:, :, :, 1] += gate_shift
    r = torch.randn(NH, hd, 4 * hd, generator=g, device=dev) / hd ** 0.5
    return x.reshape(B, T, NH, 4 * hd).to(dtype).contiguous(), r.to(dtype)


def phase_slstm(dev) -> float:
    """The kernel against its plain version on h and the final state; f32
    within 1e-5 of max(1, max |plain|), bf16 within 2**-7 of max |plain|.
    Returns the
    main-path case's max |kernel - plain| on h."""
    from repro_torch.kernels.slstm import ops, ref
    cases = [(B, T, NH, hd, dt, 0.0) for B in (1, 4) for T in (1, 17, 2048)
             for NH, hd in ((4, 64), (4, 512)) for dt in (torch.float32, torch.bfloat16)]
    cases += [(4, 2048, 4, 512, torch.bfloat16, 60.0), (4, 17, 4, 64, torch.float32, 60.0)]
    # the bf16 cluster kernel: two n8 tiles, clusters of 4, eight clusters
    cases += [(16, 64, 4, 512, torch.bfloat16, 0.0), (4, 256, 4, 256, torch.bfloat16, 0.0),
              (4, 128, 8, 512, torch.bfloat16, 0.0)]
    # above the 16 rows a launch takes: two launches, one a slice
    cases += [(17, 64, 4, 512, torch.bfloat16, 0.0), (32, 17, 4, 512, torch.bfloat16, 0.0),
              (17, 17, 4, 64, torch.float32, 0.0), (32, 9, 4, 512, torch.float32, 0.0)]
    for B, NH, hd in sorted({(min(B, ops.MAX_B), NH, hd) for B, _, NH, hd, dt, _ in cases
                             if dt == torch.bfloat16}):
        cl, J = ops.tc_plan(B, hd)
        print(f"slstm bf16 B={B} NH={NH} hd={hd}: clusters of {cl} blocks (J {J}), "
              f"{NH} clusters; cudaOccupancyMaxActiveClusters "
              f"{ops.max_active_clusters(B, NH, hd, dev)}", flush=True)
    main_err = None
    for i, (B, T, NH, hd, dt, shift) in enumerate(cases):
        x, r = slstm_inputs(B, T, NH, hd, dt, 400 + i, dev, shift)
        l0, tc0 = ops.launches, ops.tc_launches
        h, st = ops.slstm_scan(x, r)
        want_h, want_st = ref.slstm_scan(x, r)
        torch.cuda.synchronize()
        name = f"B={B} T={T} NH={NH} hd={hd} {str(dt)[6:]}" + (
            f" input gates +{shift:g}" if shift else "")
        check(h.dtype == dt and h.shape == (B, T, NH, hd), f"slstm {name}: got {h.dtype} "
              f"{tuple(h.shape)}")
        n_launch = len(ops.batch_slices(B))
        check(ops.launches - l0 == n_launch, f"slstm {name}: {ops.launches - l0} launches, "
                                             f"not {n_launch}")
        check(ops.tc_launches - tc0 == n_launch * (dt == torch.bfloat16),
              f"slstm {name}: the cluster kernel ran {ops.tc_launches - tc0} times")
        errs = []
        for what, got, want in [("h", h, want_h.to(dt))] + list(zip("hcnm", st, want_st)):
            d = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = (SLSTM_F32_REL * max(1.0, scale) if dt == torch.float32
                   else SLSTM_BF16_REL * scale)
            check(d <= tol and bool(torch.isfinite(got).all()),
                  f"slstm {name}: {what} max |kernel - plain| = {d} > {tol} (scale {scale})")
            errs.append(d)
        tol = "1e-5 of max(1, scale)" if dt == torch.float32 else "2**-7 of scale"
        print(f"slstm {name}: max_abs_err h {errs[0]:.3g}, final h/c/n/m "
              f"{'/'.join(f'{e:.3g}' for e in errs[1:])} ({tol}; {n_launch} launch"
              f"{'es' if n_launch > 1 else ''})", flush=True)
        if (B, T, NH, hd, dt, shift) == (4, 2048, 4, 512, torch.bfloat16, 0.0):
            main_err = errs[0]
    return main_err


def time_slstm(dev) -> dict:
    """Times at the main path's call: one xlstm-1.3b prefill layer, B 4,
    T 2048, NH 4, hd 512, bf16; and the floor of its 2,048 steps, the
    exchange of h between a cluster's blocks alone, on the kernel's
    clusters."""
    from repro_torch.kernels.slstm import ops, ref
    B, T, NH, hd = (MAIN_SLSTM[k] for k in ("B", "T", "NH", "hd"))
    x, r = slstm_inputs(B, T, NH, hd, torch.bfloat16, 7, dev)
    # x_pre read once, h written once (bf16), R read once, the final
    # state (4 f32 leaves) written once; 2 flops a term of h·R
    n_bytes = 2 * (B * T * NH * 4 * hd + B * T * NH * hd + NH * hd * 4 * hd) \
        + 4 * 4 * B * NH * hd
    n_flops = 2 * B * T * NH * hd * 4 * hd
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOP_PER_S)
    kernel = lambda: ops.slstm_scan(x, r)   # noqa: E731
    return dict(ms=time_ms(kernel, reps=10, inner=2),
                eager_ms=time_eager_ms(kernel, reps=5, inner=2),
                plain_ms=time_ms(lambda: ref.slstm_scan(x, r), reps=3, inner=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                barrier_floor_ms=time_ms(lambda: ops.barrier_floor(
                    B, T, NH, hd, torch.bfloat16, dev), reps=10, inner=2))


# ---------------------------------------------------------------- stat_util

STAT_CASES = [(20, 32), (100, 17), (1_000_000, 32)]   # (S, n); (20, 32) the FL path's
STAT_RTOL = 1e-5   # the sum order differs


def stat_inputs(S, n, dtype, seed, dev, sizes_dtype=torch.int32):
    g = torch.Generator(device=dev).manual_seed(seed)
    losses = (torch.rand(S, n, generator=g, device=dev) * 5).to(dtype)
    sizes = torch.randint(1, 1000, (S,), generator=g, device=dev, dtype=torch.int32)
    return losses, sizes.to(sizes_dtype)


def phase_stat_util(dev) -> float:
    """The kernel against its plain version within rtol 1e-5. Returns the FL
    path's case's (20 x 32 f32) max |kernel - plain|."""
    from repro_torch.kernels.stat_util import ops, ref
    main_err = None
    for i, (S, n) in enumerate(STAT_CASES):
        for dt in (torch.float32, torch.bfloat16):
            losses, sizes = stat_inputs(S, n, dt, 500 + i, dev)
            got = ops.stat_utility(losses, sizes)
            want = ref.stat_utility(losses, sizes)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == (S,),
                  f"stat_util ({S}, {n}) {dt}: got {got.dtype} {tuple(got.shape)}")
            d = (got - want).abs()
            rel = (d / want.abs().clamp_min(1e-30)).max().item()
            check(rel <= STAT_RTOL, f"stat_util ({S}, {n}) {dt}: relative error {rel}")
            print(f"stat_util S={S} n={n} {str(dt)[6:]}: max_abs_err {d.max().item():.3g}, "
                  f"max relative {rel:.3g} (rtol {STAT_RTOL})", flush=True)
            if main_err is None:
                main_err = d.max().item()
    return main_err


def time_stat_util(dev, S: int, n: int) -> dict:
    import math

    from repro_torch.kernels.stat_util import ops, ref
    losses, sizes = stat_inputs(S, n, torch.float32, 9, dev, sizes_dtype=torch.float32)
    # losses and sizes read once, the (S,) utilities written once
    b_ms, b_by = bound(n_bytes=4 * (S * n + 2 * S), n_flops=2 * S * n + 4 * S)
    scale = sizes / math.sqrt(n)
    kernel = lambda: ops.stat_utility(losses, sizes)   # noqa: E731
    return dict(ms=time_ms(kernel), eager_ms=time_eager_ms(kernel),
                plain_ms=time_ms(lambda: ref.stat_utility(losses, sizes)),
                library_ms=time_ms(lambda: torch.linalg.vector_norm(losses, dim=1) * scale),
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------- main path

def _ops_modules():
    from repro_torch.kernels.fedavg import ops as fedavg
    from repro_torch.kernels.flash_attention import ops as flash_attention
    from repro_torch.kernels.rewafl_select import ops as rewafl_select
    from repro_torch.kernels.slstm import ops as slstm
    from repro_torch.kernels.stat_util import ops as stat_util
    return {"rewafl_select": rewafl_select, "fedavg": fedavg,
            "flash_attention": flash_attention, "slstm": slstm, "stat_util": stat_util}


TC_KERNELS = ("flash_attention", "slstm")   # those with a bf16 tensor-core kernel


def reset_launches() -> None:
    for k, m in _ops_modules().items():
        m.launches = 0
        if k == "fedavg":
            m.indexed_launches = 0
        if k in TC_KERNELS:
            m.tc_launches = 0


def read_launches() -> dict:
    return {k: m.launches for k, m in _ops_modules().items()}


def read_tc_launches() -> dict:
    """Launches of the bf16 tensor-core kernels: flash_attention's (TMA,
    wgmma) and slstm's (clusters, mma.sync)."""
    return {k: _ops_modules()[k].tc_launches for k in TC_KERNELS}


def phase_main_path(dev):
    from repro_torch.launch.fl_run import run_fl, summary
    reset_launches()
    t0 = time.time()
    res = run_fl("cnn@mnist", "rewafl", small=False, n_clients=MAIN_S,
                 n_select=MAIN_K, rounds=MAIN_ROUNDS, eval_every=5, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    R = res.rounds_run
    check(R == MAIN_ROUNDS, f"main path ran {R} rounds, not {MAIN_ROUNDS}")
    check(counts["rewafl_select"] == R == counts["stat_util"],
          f"rewafl_select and stat_util launched {counts['rewafl_select']} and "
          f"{counts['stat_util']} times in {R} rounds")
    check(counts["fedavg"] >= R, f"fedavg launched {counts['fedavg']} times in {R} rounds")
    check(counts["flash_attention"] == counts["slstm"] == 0,
          f"the FL path launched serving kernels: {counts}")
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


# (task, method, probe_every, rounds, scenario) of the card-against-CPU
# runs: the main path's for 8 rounds, then each other selector, the probe
# every 2 rounds, and the HAR and char tasks for 4; then rewafl on each
# dynamic scenario, and random on churn-heavy, for 4
DYNAMIC_SCENARIOS = ("commuter-diurnal", "congested-urban", "overnight-charging",
                     "churn-heavy")
AGREE_RUNS = [("cnn@mnist", "rewafl", 1, 8, "static-paper"),
              ("cnn@mnist", "random", 1, 4, "static-paper"),
              ("cnn@mnist", "oort", 1, 4, "static-paper"),
              ("cnn@mnist", "autofl", 1, 4, "static-paper"),
              ("cnn@mnist", "rewafl", 2, 4, "static-paper"),
              ("cnn@har", "rewafl", 1, 4, "static-paper"),
              ("lstm@shakespeare", "rewafl", 1, 4, "static-paper")] + [
              ("cnn@mnist", "rewafl", 1, 4, sc) for sc in DYNAMIC_SCENARIOS] + [
              ("cnn@mnist", "random", 1, 4, "churn-heavy")]
# what a dynamic round must give bitwise on both devices, beside `selected`
FLEET_COUNTS = ("n_charging", "n_online", "n_available")


def phase_small_agreement(dev) -> None:
    """Small runs on the card against the same runs on the CPU: the same
    fleet, data, params and draws (a dynamic scenario's initial and
    per-round environment draws too); kernels on one side, plain versions
    on the other. Selections and the fleet's counts bitwise, losses and
    costs within rtol 1e-3."""
    import dataclasses

    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_eval_fn
    from repro_torch.launch.engine import run_rounds
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import get_scenario, init_env_state
    S, K, n = 10, 4, 32
    for task, method, probe_every, R, scenario in AGREE_RUNS:
        name = (f"{task} {method}" + (f" probe_every={probe_every}" if probe_every > 1 else "")
                + (f" {scenario}" if scenario != "static-paper" else ""))
        spec, sc = METHODS[method], get_scenario(scenario)
        cfg = dataclasses.replace(quick_cfg(K), probe_every=probe_every)
        H_max = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
        model = make_fl_model(task, small=True)
        params = model.init(torch.Generator().manual_seed(2))
        gen = torch.Generator().manual_seed(1)
        noise = [draw_noise(gen, S, K, H_max, cfg.batch_size, n, sc.dynamic)
                 for _ in range(R)]
        env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
        out = {}
        for d in ("cpu", dev):
            fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                                init_energy_std=0.04, e0_frac=0.08)
            cx, cy, test = build_task(task, S, 0.8, per_client=n, n_test=64, device=d)
            out[str(d)] = run_rounds(
                model, fleet, cx, cy, cfg, spec, rounds=R,
                params={k: v.to(d) for k, v in params.items()}, chunk_size=4,
                eval_fn=make_eval_fn(model, test["x"], test["y"]),
                noise_fn=lambda r, d=d: noise[r].to(d), scenario=sc,
                env=init_env_state(fleet, sc, env_u.to(d)),
                device=d)
        a, b = out["cpu"], out[str(dev)]
        check(np.array_equal(a.history["selected"], b.history["selected"]),
              f"small run {name}: selections differ between the card and the CPU")
        for k in FLEET_COUNTS:
            check(np.array_equal(a.history[k], b.history[k]),
                  f"small run {name}: {k} differs: {a.history[k]} vs {b.history[k]}")
        for x, y in zip(a.env, b.env):
            check(torch.equal(x, y.cpu()), f"small run {name}: the final environment differs")
        # cuDNN and the CPU sum convolutions in other orders; eight rounds of
        # SGD grow that last-bit difference to about 1e-4 relative
        rel = {}
        for k in ("global_loss", "round_energy", "round_latency", "mean_H_selected"):
            check(np.allclose(a.history[k], b.history[k], rtol=1e-3, atol=1e-5),
                  f"small run {name}: {k} differs: {a.history[k]} vs {b.history[k]}")
            dk = np.abs(np.asarray(a.history[k], np.float64) - b.history[k])
            rel[k] = float(np.max(dk / np.maximum(np.abs(a.history[k]), 1e-30)))
        check(np.all(np.abs(a.acc_curve - b.acc_curve) <= 1 / 64 + 1e-9),
              f"small run {name}: accuracy {a.acc_curve} vs {b.acc_curve}")
        print(f"small run {name}: {R} rounds on the card agree with the CPU run "
              f"(selections bitwise, losses and costs within rtol 1e-3; max "
              f"relative difference {json.dumps(rel)})", flush=True)


# ------------------------------------------------- FL methods and tasks

# each run: two chunks of 3 rounds, the first warms up, the second is the
# steady ms/round
PATH_ROUNDS, PATH_EVAL = 6, 3
METHOD_RUNS = [("cnn@mnist", m) for m in
               ("random", "oort", "autofl", "reafl", "reafl_lupa", "rewafl")]
TASK_RUNS = [(t, m) for t in ("cnn@har", "lstm@shakespeare") for m in ("rewafl", "oort")]


def phase_fl_run(dev, task: str, method: str, scenario: str = "static-paper") -> None:
    """`run_fl(task, method, scenario=...)` at paper widths (S 100, K 20)
    on the card, the launch counts set to 0 just before it and read just
    after: stat_util once a round, fedavg at least once, rewafl_select
    once a round for the rea methods and never for the others. On a
    dynamic scenario, no more devices available than online each round;
    on churn-heavy, the online and charging counts move."""
    from repro_torch.core.methods import METHODS
    from repro_torch.launch.fl_run import run_fl
    reset_launches()
    t0 = time.time()
    res = run_fl(task, method, small=False, n_clients=MAIN_S, n_select=MAIN_K,
                 rounds=PATH_ROUNDS, eval_every=PATH_EVAL, scenario=scenario, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    R = res.rounds_run
    name = f"{task} {method}" + (f" {scenario}" if scenario != "static-paper" else "")
    check(R == PATH_ROUNDS, f"{name}: ran {R} rounds, not {PATH_ROUNDS}")
    n_select = R if METHODS[method].selector == "rea" else 0
    check(counts["stat_util"] == R and counts["rewafl_select"] == n_select
          and counts["fedavg"] >= R and counts["flash_attention"] == counts["slstm"] == 0,
          f"{name}: launches {counts} in {R} rounds (rewafl_select should "
          f"launch {n_select} times)")
    for k, v in res.history.items():
        check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
              f"{name}: history {k!r} has non-finite values")
    n_sel = res.history["n_selected"]
    check(n_sel.shape == (R,) and 0 < int(n_sel.min()) and int(n_sel.max()) <= MAIN_K,
          f"{name}: devices selected per round {n_sel.tolist()} (K = {MAIN_K})")
    check(all(0.0 <= a <= 1.0 for a in res.acc_curve), f"{name}: accuracy {res.acc_curve}")
    h = res.history
    check(bool(np.all(h["n_available"] <= h["n_online"])),
          f"{name}: available {h['n_available']} above online {h['n_online']}")
    if scenario == "churn-heavy":
        check(len(set(h["n_online"])) > 1 and len(set(h["n_charging"])) > 1,
              f"{name}: online {h['n_online']} or charging {h['n_charging']} constant")
    steady = float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3
    print(f"fl_run {name}: {R} rounds in {wall:.2f} s, steady {steady:.1f} ms/round "
          f"(second chunk of {PATH_EVAL}, eval included), final accuracy "
          f"{res.acc_curve[-1]:.4f}; launches {counts}"
          + (f"; online {h['n_online'].astype(int).tolist()}, charging "
             f"{h['n_charging'].astype(int).tolist()}, available "
             f"{h['n_available'].astype(int).tolist()}" if scenario != "static-paper" else ""),
          flush=True)


WEEKEND_ROUND = 3600   # 120 h at 2 minutes a round: every device's Saturday


def phase_weekend(dev) -> None:
    """commuter-diurnal's round body called directly for 3 rounds from
    round 3,600, on the card and on the CPU from the same state and draws:
    every device is in its weekend (the scenario's weekend multipliers
    apply); selections, the fleet's counts and the environment bitwise,
    losses and costs within rtol 1e-3."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_round_body
    from repro_torch.core.state import init_fleet_state
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import SCENARIOS, init_env_state
    from repro_torch.sim.dynamics.diurnal import day_of_week, is_weekend
    S, K, n, R = 10, 4, 32, 3
    sc, cfg = SCENARIOS["commuter-diurnal"], quick_cfg(K)
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(1)
    noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, True)
             for _ in range(R)]
    env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
    body = make_round_body(model, cfg, METHODS["rewafl"], sc)
    out = {}
    for d in ("cpu", dev):
        fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.3)
        cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=8, device=d)
        p, st = {k: v.to(d) for k, v in params.items()}, init_fleet_state(fleet, H0=cfg.policy.H0)
        env = init_env_state(fleet, sc, env_u.to(d))
        weekend = is_weekend(day_of_week(WEEKEND_ROUND, sc.minutes_per_round, env.phase_h))
        check(bool(weekend.all()), f"weekend: devices outside the weekend at round "
              f"{WEEKEND_ROUND}: {weekend.cpu().tolist()}")
        ms = []
        for r in range(WEEKEND_ROUND, WEEKEND_ROUND + R):
            p, st, env, m = body(p, st, env, fleet, cx, cy, noise[r - WEEKEND_ROUND].to(d), r)
            ms.append({k: v.cpu() for k, v in m.items()})
        out[str(d)] = ms, [x.cpu() for x in env]
    (cpu, cpu_env), (card, card_env) = out["cpu"], out[str(dev)]
    for r, (a, b) in enumerate(zip(cpu, card)):
        for k in ("selected",) + FLEET_COUNTS:
            check(torch.equal(a[k], b[k]), f"weekend round {WEEKEND_ROUND + r}: {k} differs: "
                  f"{a[k].tolist()} vs {b[k].tolist()}")
        for k in ("global_loss", "round_energy", "round_latency", "mean_H_selected"):
            check(torch.allclose(a[k], b[k], rtol=1e-3, atol=1e-5),
                  f"weekend round {WEEKEND_ROUND + r}: {k} differs: {a[k]} vs {b[k]}")
    check(all(torch.equal(x, y) for x, y in zip(cpu_env, card_env)),
          "weekend: the environment differs between the card and the CPU")
    print(f"weekend: commuter-diurnal rounds {WEEKEND_ROUND}-{WEEKEND_ROUND + R - 1}, every "
          f"device in its weekend, on the card agree with the CPU (selections, "
          f"{', '.join(FLEET_COUNTS)} and the environment bitwise; charging "
          f"{[int(m['n_charging']) for m in card]}, online "
          f"{[int(m['n_online']) for m in card]})", flush=True)


# ----------------------------------------- async aggregation and faults

def fedavg_per_round(aggregation: str, buffer_m: int = 10) -> int:
    """fedavg launches a round: the sync aggregate once; async, the first
    land's sync fast path and one aggregate per land (ceil(K / M))."""
    return 1 if aggregation == "sync" else 1 + -(-MAIN_K // buffer_m)


def phase_chaos_run(dev, name: str, scenario: str = "static-paper", **kw):
    """`run_fl("cnn@mnist", "rewafl", small=False, n_clients=100,
    n_select=20, rounds=6, eval_every=3, scenario=..., **kw)` on the card,
    the launch counts set to 0 just before it and read just after:
    rewafl_select and stat_util once a round, fedavg `fedavg_per_round`
    times; finite history and parameters. Returns the RunResult."""
    from repro_torch.launch.fl_run import run_fl
    reset_launches()
    t0 = time.time()
    res = run_fl("cnn@mnist", "rewafl", small=False, n_clients=MAIN_S, n_select=MAIN_K,
                 rounds=PATH_ROUNDS, eval_every=PATH_EVAL, scenario=scenario, device=dev,
                 **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    R = res.rounds_run
    per = fedavg_per_round(kw.get("aggregation", "sync"), kw.get("buffer_m") or MAIN_K // 2)
    check(R == PATH_ROUNDS, f"{name}: ran {R} rounds, not {PATH_ROUNDS}")
    check(counts == {"rewafl_select": R, "fedavg": per * R, "flash_attention": 0,
                     "slstm": 0, "stat_util": R},
          f"{name}: launches {counts} in {R} rounds (fedavg should launch {per} a round)")
    for k, v in res.history.items():
        check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
              f"{name}: history {k!r} has non-finite values")
    check(all(bool(torch.isfinite(v).all()) for v in res.final_params.values()),
          f"{name}: the global parameters are not finite")
    steady = float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3
    h = res.history
    extra = {k: h[k].astype(int).tolist() for k in
             ("n_aborted", "n_lost", "n_corrupted", "n_straggler", "n_rejected",
              "n_landed", "n_pending") if k in h}
    print(f"fl_run {name}: {R} rounds in {wall:.2f} s, steady {steady:.1f} ms/round "
          f"(second chunk of {PATH_EVAL}, eval included), final accuracy "
          f"{res.acc_curve[-1]:.4f}; launches {counts} ({per} fedavg a round)"
          + (f"; wall_clock {res.wall_clock_s:.1f} s" if res.wall_clock_s else "")
          + (f"; {json.dumps(extra)}" if extra else ""), flush=True)
    return res, counts


def phase_async_and_faults(dev) -> dict:
    """The async and fault paths at full width, each its own path with the
    counts read just after it: async at the defaults (M 10, wall delays);
    async at M = K with unit delays beside the sync run of the same call
    (selections and counters bitwise, losses within rtol 1e-3);
    lossy-uplink (uploads lost); flaky-fleet sync and async (aborts,
    corruptions and rejections). Returns the launch counts by path."""
    by_path = {}
    res, by_path["async"] = phase_chaos_run(dev, "cnn@mnist rewafl async",
                                            aggregation="async")
    h, ast, M = res.history, res.async_state, MAIN_K // 2
    check(bool(np.all(h["n_pending"] < M)), f"async: pending {h['n_pending']} reached M {M}")
    occ = int(ast.slot_live.sum())
    check(int(ast.n_dispatched) == int(ast.n_landed) + occ == int(ast.n_landed)
          + int(h["n_pending"][-1]),
          f"async: dispatched {int(ast.n_dispatched)} != landed {int(ast.n_landed)} + "
          f"pending {occ}")
    check(bool(np.all(np.diff(h["wall_clock"]) >= 0)) and h["wall_clock"][0] > 0,
          f"async: wall clock {h['wall_clock']}")
    check(int(h["n_landed"].sum()) > 0, "async: nothing landed")

    sync, by_path["sync"] = phase_chaos_run(dev, "cnn@mnist rewafl sync (beside M = K)")
    mk, by_path["async M=K"] = phase_chaos_run(dev, "cnn@mnist rewafl async M=K unit",
                                               aggregation="async", buffer_m=MAIN_K,
                                               async_delay="unit")
    for k in ("sel_count", "n_selected", "H_trace", "n_participating", "n_failed",
              "n_dropped", "n_available"):
        check(np.array_equal(mk.history[k], sync.history[k]),
              f"async M=K: {k} differs from the sync run: {mk.history[k]} vs "
              f"{sync.history[k]}")
    check(np.all(mk.history["n_pending"] == 0)
          and mk.history["server_version"].tolist() == list(range(1, PATH_ROUNDS + 1)),
          f"async M=K: pending {mk.history['n_pending']}, versions "
          f"{mk.history['server_version']}")
    for k in ("global_loss", "round_energy", "round_latency"):
        check(np.allclose(mk.history[k], sync.history[k], rtol=1e-3, atol=1e-5),
              f"async M=K: {k} {mk.history[k]} vs sync {sync.history[k]}")
    print("async M=K unit: selections and counters equal the sync run's, losses "
          "and costs within rtol 1e-3", flush=True)

    res, by_path["lossy-uplink"] = phase_chaos_run(dev, "cnn@mnist rewafl lossy-uplink",
                                                   "lossy-uplink")
    check(int(res.history["n_lost"].sum()) > 0, "lossy-uplink: no upload lost")
    for agg in ("sync", "async"):
        res, by_path[f"flaky-fleet {agg}"] = phase_chaos_run(
            dev, f"cnn@mnist rewafl flaky-fleet {agg}", "flaky-fleet", aggregation=agg)
        for k in ("n_aborted", "n_corrupted", "n_rejected"):
            check(int(res.history[k].sum()) > 0, f"flaky-fleet {agg}: {k} is 0")
    return by_path


# (name, scenario, AsyncCfg fields or None) of the small card-against-CPU
# runs of rewafl on cnn@mnist, 4 rounds each; STRAGGLERS is a static
# twin whose stragglers take 50 times longer, under a slot TTL
STRAGGLERS = "static stragglers x50"
CHAOS_RUNS = [("async M=2 jitter 0.3", "static-paper", dict(buffer_m=2, delay_jitter=0.3)),
              ("async M=K unit", "static-paper", dict(buffer_m=4, delay="unit")),
              ("async TTL", STRAGGLERS, dict(buffer_m=2, ttl=200.0, max_retries=1)),
              ("lossy-uplink", "lossy-uplink", None),
              ("flaky-fleet", "flaky-fleet", None),
              ("flaky-fleet async", "flaky-fleet", dict(buffer_m=2))]


def phase_small_chaos_agreement(dev) -> None:
    """The async and fault paths at S 10, K 4 on the card against the same
    runs on the CPU, from the same draws (the fault and delay-jitter
    draws included): selections and every integer counter bitwise (the
    fault and async counters, server_version, n_pending) and the final
    buffer's integer leaves; losses, costs and the virtual clock within
    rtol 1e-3."""
    from repro_torch.core.async_agg import AsyncCfg
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_eval_fn
    from repro_torch.launch.engine import run_rounds
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import Scenario, get_scenario, init_env_state
    from repro_torch.sim.faults import FaultCfg
    S, K, n, R = 10, 4, 32, 4
    cfg, spec = quick_cfg(K), METHODS["rewafl"]
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    for name, scenario, akw in CHAOS_RUNS:
        sc = (Scenario(name=STRAGGLERS, static=True,
                       faults=FaultCfg(straggler_rate=0.5, straggler_mult=50.0))
              if scenario == STRAGGLERS else get_scenario(scenario))
        acfg = AsyncCfg(**akw) if akw is not None else None
        gen = torch.Generator().manual_seed(1)
        noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, sc.dynamic,
                            sc.faults.enabled, acfg is not None and acfg.delay_jitter > 0)
                 for _ in range(R)]
        env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
        out = {}
        for d in ("cpu", dev):
            fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                                init_energy_std=0.04, e0_frac=0.08)
            cx, cy, test = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=64, device=d)
            out[str(d)] = run_rounds(
                model, fleet, cx, cy, cfg, spec, rounds=R,
                params={k: v.to(d) for k, v in params.items()}, chunk_size=2,
                eval_fn=make_eval_fn(model, test["x"], test["y"]),
                noise_fn=lambda r, d=d: noise[r].to(d), scenario=sc,
                env=init_env_state(fleet, sc, env_u.to(d)), async_cfg=acfg, device=d)
        a, b = out["cpu"], out[str(dev)]
        check(set(a.history) == set(b.history), f"small run {name}: history keys differ")
        rel = {}
        for k, v in a.history.items():
            if v.dtype.kind in "biu":
                check(np.array_equal(v, b.history[k]),
                      f"small run {name}: {k} differs: {v.tolist()} vs {b.history[k].tolist()}")
            else:
                check(np.allclose(v, b.history[k], rtol=1e-3, atol=1e-5, equal_nan=True),
                      f"small run {name}: {k} differs: {v} vs {b.history[k]}")
                dk = np.abs(np.asarray(v, np.float64) - b.history[k])
                rel[k] = float(np.max(dk / np.maximum(np.abs(v), 1e-30)))
        if acfg is not None:
            for k, x in a.async_state._asdict().items():
                if not x.is_floating_point():
                    check(torch.equal(x, getattr(b.async_state, k).cpu()),
                          f"small run {name}: the final buffer's {k} differs")
        counts = {k: int(a.history[k].sum()) for k in
                  ("n_aborted", "n_lost", "n_corrupted", "n_rejected", "n_landed",
                   "n_retried", "n_expired") if k in a.history}
        print(f"small run {name}: {R} rounds on the card agree with the CPU run "
              f"(selections and integer counters bitwise; totals {json.dumps(counts)}; "
              f"max relative difference {json.dumps(rel)})", flush=True)


# ------------------------------- streaming telemetry, health and trace

def _steady_ms(res) -> float:
    return float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3


def phase_streaming(dev) -> dict:
    """The streaming-telemetry path at full width, each run its own path
    with the counts read just after it: the dense run of the main call,
    then the same call with `telemetry="streaming"`, the health monitors
    and the trace (`tel/selected/count` equal to the dense `sel_count`,
    `tel/H/last` to the final H, no per-device key in the history, the
    per-round scalars within rtol 1e-3 of the dense run's; the health
    table and the trace's phase table printed, the trace's spans
    checked), then async streaming (ASYNC_SPECS: `tel/wall_clock/last`
    equal to the history's last virtual clock). Returns the launch
    counts by path."""
    import tempfile

    from repro_torch.core.metrics import ASYNC_SPECS, DEFAULT_SPECS, PER_DEVICE_METRICS
    from repro_torch.launch.fl_run import HIST_KEYS
    from repro_torch.obs import HealthCfg, format_health_table, format_span_table
    by_path = {}
    dense, _ = phase_chaos_run(dev, "cnn@mnist rewafl dense (beside streaming)")
    hcfg = HealthCfg(max_near_frac=None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "streaming.trace.json")
        res, by_path["streaming"] = phase_chaos_run(
            dev, "cnn@mnist rewafl streaming", telemetry="streaming", health=hcfg,
            trace=path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    h, tel = res.history, res.telemetry
    check(np.array_equal(tel["tel/selected/count"], dense.history["sel_count"])
          and np.array_equal(h["sel_count"], dense.history["sel_count"]),
          f"streaming: selection counts {tel['tel/selected/count'].tolist()} vs dense "
          f"{dense.history['sel_count'].tolist()}")
    check(np.array_equal(tel["tel/H/last"], res.final_state.H.cpu().numpy()),
          "streaming: tel/H/last differs from the final H")
    # the final state's (S,) leaves (residual_energy, ...) stay; no trace
    traces = ({k for k, v in h.items() if np.ndim(v) > 1}
              | ((set(PER_DEVICE_METRICS) - {"residual_energy"}) | {"H_trace", "n_selected"})
              & set(h))
    check(not traces, f"streaming: per-device traces in the history: {sorted(traces)}")
    specs = DEFAULT_SPECS + hcfg.quantile_specs(PATH_ROUNDS, float(h["init_energy"].max()))
    check(sorted(tel) == sorted(sp.out_key for sp in specs),
          f"streaming: telemetry keys {sorted(tel)}")
    for k in HIST_KEYS:
        check(np.allclose(h[k], dense.history[k], rtol=1e-3, atol=1e-5),
              f"streaming: {k} {h[k]} vs dense {dense.history[k]}")
    for k, v in tel.items():
        check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
              f"streaming: {k} is not finite")
    rep = res.health
    check(rep is not None and [sm["round"] for sm in rep.samples] == [2, 5],
          f"streaming: health samples {rep and rep.samples}")
    names = {}
    for e in events:
        names[e["name"]] = names.get(e["name"], 0) + 1
    want = {"run_fl": 1, "chunk": 2, "dispatch": 2, "history_drain": 2, "eval": 2,
            "health": 2, "transfer": 1}
    check(names == want, f"streaming: trace spans {names}, not {want}")
    print("streaming: " + json.dumps({
        "sel_count_equals_dense": True, "steady_ms_per_round":
        {"streaming": _steady_ms(res), "dense": _steady_ms(dense)},
        "health_ok": rep.ok, "health": rep.metrics, "warnings": rep.warnings}), flush=True)
    for line in format_health_table(rep).splitlines():
        print(f"streaming health: {line}", flush=True)
    for line in format_span_table(res.spans).splitlines():
        print(f"streaming spans: {line}", flush=True)

    res, by_path["streaming async"] = phase_chaos_run(
        dev, "cnn@mnist rewafl streaming async", aggregation="async", telemetry="streaming")
    tel = res.telemetry
    check(sorted(tel) == sorted(sp.out_key for sp in ASYNC_SPECS),
          f"streaming async: telemetry keys {sorted(tel)}")
    check(float(tel["tel/wall_clock/last"]) == res.history["wall_clock"][-1],
          f"streaming async: tel/wall_clock/last {float(tel['tel/wall_clock/last'])} vs "
          f"the history's {res.history['wall_clock'][-1]}")
    check(int(tel["tel/update_staleness/max"].max()) >= 0
          and "H_trace" not in res.history, "streaming async: telemetry")
    print(f"streaming async: tel/wall_clock/last {float(tel['tel/wall_clock/last']):.3f} s "
          f"equals the history's; steady {_steady_ms(res):.1f} ms/round", flush=True)
    return by_path


# (name, scenario, AsyncCfg fields or None, FAULT_SPECS appended) of the
# small card-against-CPU streaming runs of rewafl on cnn@mnist, 4 rounds
STREAM_RUNS = [("streaming static", "static-paper", None, False),
               ("streaming churn-heavy", "churn-heavy", None, False),
               ("streaming async M=2 jitter 0.3", "static-paper",
                dict(buffer_m=2, delay_jitter=0.3), False),
               ("streaming flaky-fleet FAULT_SPECS", "flaky-fleet", None, True)]


def phase_small_streaming_agreement(dev) -> None:
    """Streaming runs with the health monitors at S 10, K 4 on the card
    against the same runs on the CPU, from the same draws: integer
    reducer outputs (counts, maxima and last values of integer metrics)
    bitwise, float ones within rtol 1e-3, the quantiles within one bin
    width; the health samples (integer counts) and warnings bitwise."""
    from repro_torch.core.async_agg import AsyncCfg
    from repro_torch.core.methods import METHODS
    from repro_torch.core.metrics import (ASYNC_SPECS, DEFAULT_SPECS, FAULT_SPECS,
                                          TelemetryCfg)
    from repro_torch.core.round import draw_noise, make_eval_fn
    from repro_torch.launch.engine import run_rounds
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.obs import HealthCfg
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import get_scenario, init_env_state
    S, K, n, R = 10, 4, 32, 4
    cfg, spec, hcfg = quick_cfg(K), METHODS["rewafl"], HealthCfg(max_near_frac=None)
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    for name, scenario, akw, faults in STREAM_RUNS:
        sc = get_scenario(scenario)
        acfg = AsyncCfg(**akw) if akw is not None else None
        specs = (ASYNC_SPECS if acfg is not None else DEFAULT_SPECS) + (
            FAULT_SPECS if faults else ())
        tcfg = TelemetryCfg(mode="streaming", specs=specs)
        gen = torch.Generator().manual_seed(1)
        noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, sc.dynamic,
                            sc.faults.enabled, acfg is not None and acfg.delay_jitter > 0)
                 for _ in range(R)]
        env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
        out = {}
        for d in ("cpu", dev):
            fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                                init_energy_std=0.04, e0_frac=0.08)
            cx, cy, test = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=64, device=d)
            out[str(d)] = run_rounds(
                model, fleet, cx, cy, cfg, spec, rounds=R,
                params={k: v.to(d) for k, v in params.items()}, chunk_size=2,
                eval_fn=make_eval_fn(model, test["x"], test["y"]),
                noise_fn=lambda r, d=d: noise[r].to(d), scenario=sc,
                env=init_env_state(fleet, sc, env_u.to(d)), async_cfg=acfg,
                telemetry=tcfg, health=hcfg, device=d)
        a, b = out["cpu"], out[str(dev)]
        check(set(a.telemetry) == set(b.telemetry), f"small run {name}: telemetry keys differ")
        widths = {sp.out_key: (sp.hi - sp.lo) / sp.bins for sp in
                  hcfg.quantile_specs(R, float(fleet.init_energy.max()))}
        rel = {}
        for k, v in a.telemetry.items():
            w = b.telemetry[k]
            if k in widths:
                check(abs(float(v) - float(w)) <= widths[k] + 1e-6,
                      f"small run {name}: {k} {float(v)} vs {float(w)} (bin {widths[k]})")
            elif v.dtype.kind in "biu":
                check(np.array_equal(v, w), f"small run {name}: {k} differs: {v} vs {w}")
            else:
                check(np.allclose(v, w, rtol=1e-3, atol=1e-5),
                      f"small run {name}: {k} differs: {v} vs {w}")
                dk = np.abs(np.asarray(v, np.float64) - w)
                rel[k] = float(np.max(dk / np.maximum(np.abs(v), 1e-30)))
        check(a.health.samples == b.health.samples and a.health.warnings == b.health.warnings,
              f"small run {name}: health samples {a.health.samples} vs {b.health.samples}")
        if faults:
            check(all(float(a.telemetry[sp.out_key]) == float(a.history[sp.metric].sum())
                      for sp in FAULT_SPECS), f"small run {name}: fault sums")
        print(f"small run {name}: {R} rounds on the card agree with the CPU run (integer "
              f"reducers and health samples bitwise, quantiles within a bin; max relative "
              f"difference {json.dumps(rel)})", flush=True)
    phase_special_bins(dev)


def phase_special_bins(dev) -> None:
    """The histogram bin of NaN, ±inf and values beyond int32 on the card
    and on the CPU: the port clamps in float before converting to int32,
    so both give the compiled reference's bins (NaN and -inf the first,
    +inf and values past the range the last; tests/test_torch_metrics.py
    holds the CPU's against the reference)."""
    from repro_torch.core.metrics import (MetricSpec, TelemetryCfg, init_telemetry,
                                          update_telemetry)
    x = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 3e9, -3e9,
                      2.0 ** 31, -2.0 ** 31, 1e38, -1e38, 0.0, -0.0, 0.5, 1.0])
    tcfg = TelemetryCfg(mode="streaming", specs=(MetricSpec("x", "p50"),
                                                 MetricSpec("x", "p95")))
    want = torch.zeros(64)
    want[0], want[32], want[63] = 8, 1, 5
    for d in ("cpu", dev):
        c = init_telemetry(tcfg, {"x": x.to(d)})
        counts = update_telemetry(tcfg, c, {"x": x.to(d)}, 0).reducers["x/hist64@0.0:1.0"]
        check(torch.equal(counts.counts.cpu(), want),
              f"special bins on {d}: {counts.counts.nonzero().flatten().tolist()}")
    print("special bins: NaN, -NaN, -inf, -3e9, -2**31, -1e38, 0, -0 in bin 0; 0.5 in bin "
          "32; +inf, 3e9, 2**31, 1e38, 1.0 in bin 63, on the card as on the CPU", flush=True)
    # what each device's own float-to-int32 conversion makes of them
    print(f"special values {x[:10].tolist()} as int32: card "
          f"{x[:10].to(dev).to(torch.int32).cpu().tolist()}, CPU "
          f"{x[:10].to(torch.int32).tolist()}", flush=True)


# ------------------------------------------- campaign grids and the loop

GRID_SEEDS = (0, 1, 2)
BATCH_SEEDS = tuple(range(6))
GRID_ROUNDS, GRID_CHUNK = 6, 3
# run_fl's default fleet: the paper's low-initial-battery regime
FL_FLEET = dict(init_energy_mean=0.11, init_energy_std=0.04, e0_frac=0.08)
GRID_CELLS = 6 * len(GRID_SEEDS)
ASYNC_GRID_SLOTS = 2 * FEDAVG_K   # a mixed grid's buffer: max(M, K) + K slots


def phase_batched_kernels(dev) -> dict:
    """The batched calls against their plain versions, each called
    the way a campaign calls it (its op under `torch.func.vmap`) with its
    launches counted: fedavg at the grid's (18, 20, 206,922) f32 and a
    mixed grid's async buffer (18, 40, 206,922) with a NaN row at weight 0,
    within atol 1e-5 and bitwise the 18 single launches; rewafl_select at
    B 6 x S 100, K 20 (eps 0 and 0.1) and B 3 x S 8,193 (K 20 and 257)
    with ~30% unavailable, NaN and ±0 utilities, bitwise the plain
    version and the B single launches; stat_util at the grid's 18 cells x
    (20, 32), one (360, 32) launch within rtol 1e-5. Each batched call is
    one launch. Returns the max errors."""
    from repro_torch.core.selection import _explore_slots
    from repro_torch.core.utility import UtilityInputs
    from repro_torch.kernels.fedavg import ops as fops
    from repro_torch.kernels.fedavg import ref as fref
    from repro_torch.kernels.rewafl_select import ops as sops
    from repro_torch.kernels.rewafl_select import ref as sref
    from repro_torch.kernels.stat_util import ops as uops
    from repro_torch.kernels.stat_util import ref as uref
    vmap = torch.func.vmap
    errs = {}
    for name, K in (("grid", FEDAVG_K), ("mixed grid's async buffer", ASYNC_GRID_SLOTS)):
        g = torch.Generator(device=dev).manual_seed(70 + K)
        x = torch.randn(GRID_CELLS, K, FEDAVG_P, generator=g, device=dev)
        w = torch.rand(GRID_CELLS, K, generator=g, device=dev)
        w = w / w.sum(1, keepdim=True)
        if K == ASYNC_GRID_SLOTS:   # a stale dead slot: 0 · NaN is NaN
            x[5, 7, ::7] = float("nan")
            w[5, 7] = 0.0
        before = fops.launches
        got = vmap(fops.weighted_aggregate)(x, w)
        torch.cuda.synchronize()
        n = fops.launches - before
        singles = torch.stack([fops.weighted_aggregate(x[c], w[c]) for c in range(GRID_CELLS)])
        want = fref.weighted_aggregate_batched(x, w)
        nan = torch.isnan(want)
        check(n == 1, f"fedavg batched ({name}): {n} launches for one call")
        check(torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], singles[~nan]),
              f"fedavg batched ({name}): differs from the {GRID_CELLS} single launches")
        err = (got[~nan] - want[~nan]).abs().max().item()
        check(err <= 1e-5, f"fedavg batched ({name}): max |kernel - plain| = {err}")
        errs.setdefault("fedavg", err)
        print(f"fedavg batched ({name}): C={GRID_CELLS} K={K} P={FEDAVG_P}, 1 launch, "
              f"bitwise the {GRID_CELLS} single launches, max_abs_err {err:.3g} (atol 1e-5)"
              + (f", NaN at the same {int(nan.sum())} positions" if nan.any() else ""),
              flush=True)

    def one(kw):
        return lambda a, s, t, e, r, e0, u: sops.select_topk(
            a, UtilityInputs(s, t, e, r, e0), u, **kw)

    n_cases = 0
    for B, S, K, eps, cases in ((6, MAIN_S, MAIN_K, 0.0, ("unavail30", "nan", "negzero")),
                                (6, MAIN_S, MAIN_K, 0.1, ("unavail30", "ties")),
                                (3, 8193, MAIN_K, 0.0, ("unavail30", "nan", "negzero")),
                                (3, 8193, 257, 0.1, ("unavail30", "nan", "negzero"))):
        kx = _explore_slots(eps, K)
        kw = dict(k_exploit=K - kx, k_explore=kx, T_round=60.0, alpha=1.0, beta=1.0)
        for case in cases:
            ins = [select_inputs(S, case, 900 + 31 * b + S % 97, dev, K) for b in range(B)]
            avail = torch.stack([i[0] for i in ins])
            ui = UtilityInputs(*(torch.stack([i[1][j] for i in ins]) for j in range(5)))
            rnd = torch.stack([i[2] for i in ins])
            before = sops.launches
            idx, live = vmap(one(kw))(avail, *ui, rnd)
            torch.cuda.synchronize()
            n = sops.launches - before
            ridx, rlive = sref.select_topk_batched(avail, ui, rnd, **kw)
            check(n == 1, f"rewafl_select batched B={B} S={S}: {n} launches for one call")
            check(torch.equal(idx, ridx) and torch.equal(live, rlive),
                  f"rewafl_select batched B={B} S={S} K={K} eps={eps} {case}: differs "
                  "from the plain version")
            for b in range(B):
                si, sl = sops.select_topk(avail[b], UtilityInputs(*(x[b] for x in ui)),
                                          rnd[b], **kw)
                check(torch.equal(idx[b], si) and torch.equal(live[b], sl),
                      f"rewafl_select batched B={B} S={S} {case}: selection {b} differs "
                      "from its single launch")
            n_cases += 1
    errs["rewafl_select"] = 0.0
    print(f"rewafl_select batched: {n_cases} cases (B 6 x S {MAIN_S} and B 3 x S 8,193), one "
          "launch each, bitwise the plain version and the single launches", flush=True)

    g = torch.Generator(device=dev).manual_seed(77)
    losses = torch.rand(GRID_CELLS, MAIN_K, 32, generator=g, device=dev) * 5
    sizes = torch.randint(1, 1000, (GRID_CELLS, MAIN_K), generator=g, device=dev,
                          dtype=torch.int32)
    before = uops.launches
    got = vmap(uops.stat_utility)(losses, sizes)
    torch.cuda.synchronize()
    n = uops.launches - before
    want = uref.stat_utility(losses.reshape(-1, 32), sizes.reshape(-1)).reshape(got.shape)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    check(n == 1 and rel <= STAT_RTOL, f"stat_util batched: {n} launches, relative error {rel}")
    errs["stat_util"] = (got - want).abs().max().item()
    print(f"stat_util batched: {GRID_CELLS} cells x ({MAIN_K}, 32) as one "
          f"({GRID_CELLS * MAIN_K}, 32) launch, max relative error {rel:.3g} "
          f"(rtol {STAT_RTOL})", flush=True)
    return errs


def time_batched(dev) -> dict:
    """Times of the batched calls at the grid's shapes (the op under
    vmap, as the campaign calls it), beside the plain batched version, one
    library call and the bound."""
    from repro_torch.core import utility as util
    from repro_torch.core.utility import UtilityInputs
    from repro_torch.kernels.fedavg import ops as fops
    from repro_torch.kernels.fedavg import ref as fref
    from repro_torch.kernels.rewafl_select import ops as sops
    from repro_torch.kernels.rewafl_select import ref as sref
    from repro_torch.kernels.stat_util import ops as uops
    from repro_torch.kernels.stat_util import ref as uref
    vmap = torch.func.vmap
    C, K, P = GRID_CELLS, FEDAVG_K, FEDAVG_P
    g = torch.Generator(device=dev).manual_seed(98)
    x = torch.randn(C, K, P, generator=g, device=dev)
    w = torch.rand(C, K, generator=g, device=dev)
    w = w / w.sum(1, keepdim=True)
    b_ms, b_by = bound(n_bytes=(C * K * P + C * P + C * K) * 4, n_flops=2 * C * K * P)
    agg = lambda: vmap(fops.weighted_aggregate)(x, w)   # noqa: E731
    out = {"fedavg": dict(shape=f"C {C} x (K {K}, P {P}) f32", ms=time_ms(agg),
                          eager_ms=time_eager_ms(agg),
                          plain_ms=time_ms(lambda: fref.weighted_aggregate_batched(x, w)),
                          library_ms=time_ms(lambda: torch.bmm(w[:, None, :], x)),
                          bound_ms=b_ms, bound_by=b_by)}
    B, S = len(BATCH_SEEDS), MAIN_S
    ins = [select_inputs(S, "unavail30", 40 + b, dev) for b in range(B)]
    avail = torch.stack([i[0] for i in ins])
    ui = UtilityInputs(*(torch.stack([i[1][j] for i in ins]) for j in range(5)))
    kw = dict(k_exploit=MAIN_K, k_explore=0, T_round=60.0, alpha=1.0, beta=1.0)

    def sel():
        return vmap(lambda a, s, t, e, r, e0: sops.select_topk(
            a, UtilityInputs(s, t, e, r, e0), None, **kw))(avail, *ui)

    def library():
        u = util.rewafl_utility_from(ui, T_round=60.0, alpha=1.0, beta=1.0)
        return torch.topk(torch.where(avail, u, sref.NEG), MAIN_K, dim=1)

    b_ms, b_by = bound(n_bytes=B * (S * (5 * 4 + 1) + 2 * MAIN_K * 4), n_flops=12 * B * S)
    out["rewafl_select"] = dict(
        shape=f"B {B} x S {S}, K {MAIN_K}", ms=time_ms(sel), eager_ms=time_eager_ms(sel),
        plain_ms=time_ms(lambda: sref.select_topk_batched(avail, ui, None, **kw)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
    import math
    losses = torch.rand(C, K, 32, generator=g, device=dev) * 5
    sizes = torch.randint(1, 1000, (C, K), generator=g, device=dev).float()
    b_ms, b_by = bound(n_bytes=4 * (C * K * 32 + 2 * C * K), n_flops=2 * C * K * 32 + 4 * C * K)
    su = lambda: vmap(uops.stat_utility)(losses, sizes)   # noqa: E731
    out["stat_util"] = dict(
        shape=f"C {C} x ({K}, 32) f32", ms=time_ms(su), eager_ms=time_eager_ms(su),
        plain_ms=time_ms(lambda: uref.stat_utility(losses.reshape(-1, 32), sizes.reshape(-1))),
        library_ms=time_ms(lambda: torch.linalg.vector_norm(losses, dim=2)
                           * (sizes / math.sqrt(32))),
        bound_ms=b_ms, bound_by=b_by)
    return out


def grid_specs(energy_hi: float):
    """The grid's streaming specs, as the benchmark harness builds them
    (DEFAULT_SPECS, an H ring and the health quantiles), with every
    round's H and selection mask in rings (the cells' checks read them)."""
    from repro_torch.core.metrics import DEFAULT_SPECS, MetricSpec, TelemetryCfg
    from repro_torch.obs.health import HealthCfg
    return TelemetryCfg(mode="streaming", specs=DEFAULT_SPECS + (
        MetricSpec("H", "ring", every=1, cap=GRID_ROUNDS),
        MetricSpec("selected", "ring", every=1, cap=GRID_ROUNDS),
    ) + HealthCfg().quantile_specs(GRID_ROUNDS, energy_hi))


def single_campaign(dev, method: str, seed: int):
    """The campaign `run_fl("cnn@mnist", method, small=False,
    n_clients=100, n_select=20, rounds=6, seed=seed)` runs, built as
    run_fl builds it (fleet and data from `seed`, the model from `seed +
    2`, the round noise from `seed + 1`) and run by its engine
    (`run_rounds`, chunks of 3) with the per-round selection masks in the
    history. Returns (history, steady ms/round of the second chunk)."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import FLConfig, make_eval_fn
    from repro_torch.launch.engine import run_rounds
    from repro_torch.launch.fl_run import build_task
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    model = make_fl_model("cnn@mnist", small=False)
    fleet = build_fleet(MAIN_S, seed=seed, device=dev, **FL_FLEET)
    cx, cy, test = build_task("cnn@mnist", MAIN_S, 0.8, per_client=64, seed=seed, device=dev)
    res = run_rounds(model, fleet, cx, cy, FLConfig(n_select=MAIN_K), METHODS[method],
                     rounds=GRID_ROUNDS, seed=seed + 1, chunk_size=GRID_CHUNK,
                     params=model.init(torch.Generator(device=dev).manual_seed(seed + 2)),
                     eval_fn=make_eval_fn(model, test["x"], test["y"]), device=dev)
    torch.cuda.synchronize()
    return res.history, float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3


CELL_COUNTS = ("n_participating", "n_failed", "n_dropped", "n_available")
CELL_FLOATS = ("global_loss", "round_energy", "round_latency")


def check_cell(name: str, sel, h, single) -> str:
    """A campaign cell against its single run: round 0's mask bitwise;
    until the first round where the masks part (none, if they never do),
    the counters equal and the losses and costs within rtol 1e-3. Returns
    a note of where the masks part."""
    part = next((r for r in range(GRID_ROUNDS)
                 if not np.array_equal(sel[r].astype(bool), single["selected"][r])), None)
    check(part != 0, f"{name}: round 0's selection differs from the single run's")
    upto = GRID_ROUNDS if part is None else part
    for k in CELL_COUNTS:
        check(np.array_equal(np.asarray(h[k][:upto], np.int64),
                             np.asarray(single[k][:upto], np.int64)),
              f"{name}: {k} {h[k][:upto]} vs the single run's {single[k][:upto]}")
    for k in CELL_FLOATS:
        check(np.allclose(h[k][:upto], single[k][:upto], rtol=1e-3, atol=1e-5),
              f"{name}: {k} {h[k][:upto]} vs the single run's {single[k][:upto]}")
    return "masks equal every round" if part is None else f"masks part at round {part}"


def phase_grid(dev) -> dict:
    """`run_campaign_grid` of the six methods x seeds {0, 1, 2} on cnn@mnist
    at full width (S 100, K 20), 6 rounds in chunks of 3, per-seed fleets,
    streaming telemetry (`grid_specs`): launch counts from 0, one fedavg
    and one stat_util launch a round for all 18 cells, no rewafl_select
    (the traced selection has no kernel); finite history; each cell
    against its single campaign (`single_campaign`, `check_cell`); the
    grid's steady ms/round (its second chunk) beside the sum of the 18
    single campaigns' and its peak device memory."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import FLConfig, make_batch_eval_fn
    from repro_torch.launch.engine import run_campaign_grid
    from repro_torch.launch.fl_run import build_task_batch
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet_batch
    model = make_fl_model("cnn@mnist", small=False)
    fleet = build_fleet_batch(GRID_SEEDS, MAIN_S, device=dev, **FL_FLEET)
    cx, cy, test = build_task_batch("cnn@mnist", GRID_SEEDS, MAIN_S, 0.8, per_client=64,
                                    device=dev)
    tcfg = grid_specs(float(fleet.init_energy.max()))
    kw = dict(seeds=GRID_SEEDS, rounds=GRID_ROUNDS, chunk_size=GRID_CHUNK,
              per_seed_fleets=True, telemetry=tcfg, device=dev,
              eval_fn=make_batch_eval_fn(model, test["x"], test["y"], per_seed=True))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    grid = run_campaign_grid(model, fleet, cx, cy, FLConfig(n_select=MAIN_K),
                             dict(METHODS), **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(counts == {"rewafl_select": 0, "fedavg": GRID_ROUNDS, "flash_attention": 0,
                     "slstm": 0, "stat_util": GRID_ROUNDS},
          f"grid: launches {counts} in {GRID_ROUNDS} rounds of {GRID_CELLS} cells")
    M = len(METHODS)
    steady = float(grid["rewafl"]["chunk_wall_s"][-1]) * M / GRID_CHUNK * 1e3
    singles, notes = [], []
    for m in METHODS:
        h = grid[m]
        for k, v in h.items():
            check(bool(np.all(np.isfinite(np.asarray(v, np.float64)))),
                  f"grid {m}: {k!r} has non-finite values")
        check(h["global_loss"].shape == (len(GRID_SEEDS), GRID_ROUNDS)
              and h["tel/selected/ring"].shape == (len(GRID_SEEDS), GRID_ROUNDS, MAIN_S),
              f"grid {m}: shapes {h['global_loss'].shape}, {h['tel/selected/ring'].shape}")
        for j, s in enumerate(GRID_SEEDS):
            single, ms = single_campaign(dev, m, s)
            singles.append(ms)
            cell = {k: h[k][j] for k in CELL_COUNTS + CELL_FLOATS}
            note = check_cell(f"grid cell {m} seed {s}", h["tel/selected/ring"][j], cell,
                              single)
            check(np.array_equal(h["tel/selected/count"][j], single["selected"].sum(0))
                  or "part" in note, f"grid cell {m} seed {s}: selection counts differ")
            notes.append(f"{m}/{s}: {note}")
    total = sum(singles)
    print(f"grid: {M} methods x {len(GRID_SEEDS)} seeds = {GRID_CELLS} cells, "
          f"{GRID_ROUNDS} rounds in {wall:.2f} s, steady {steady:.1f} ms/round (second "
          f"chunk, eval included) against {total:.1f} ms/round summed over the "
          f"{GRID_CELLS} single campaigns ({total / steady:.2f}x); peak memory "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    print(f"grid cells against their single campaigns (round 0's masks bitwise, counters "
          f"equal and losses within rtol 1e-3 until the masks part): {'; '.join(notes)}",
          flush=True)
    return dict(counts=counts, ms_per_round=steady, singles_ms_per_round=total,
                singles=singles, peak_gib=peak, wall_s=wall)


def phase_seed_batch(dev) -> dict:
    """`run_campaign_batch` of rewafl over seeds 0-5 at full width: the
    per-method path, whose selections run as one batched rewafl_select
    launch a round (fedavg and stat_util once a round); each seed against
    its single campaign; steady ms/round beside the sum of the six
    single campaigns'."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import FLConfig
    from repro_torch.launch.engine import run_campaign_batch
    from repro_torch.launch.fl_run import build_task_batch
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet_batch
    model = make_fl_model("cnn@mnist", small=False)
    fleet = build_fleet_batch(BATCH_SEEDS, MAIN_S, device=dev, **FL_FLEET)
    cx, cy, _ = build_task_batch("cnn@mnist", BATCH_SEEDS, MAIN_S, 0.8, per_client=64,
                                 device=dev)
    reset_launches()
    t0 = time.time()
    h = run_campaign_batch(model, fleet, cx, cy, FLConfig(n_select=MAIN_K),
                           METHODS["rewafl"], seeds=BATCH_SEEDS, rounds=GRID_ROUNDS,
                           chunk_size=GRID_CHUNK, per_seed_fleets=True,
                           collect_per_device=True, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    check(counts == {"rewafl_select": GRID_ROUNDS, "fedavg": GRID_ROUNDS,
                     "flash_attention": 0, "slstm": 0, "stat_util": GRID_ROUNDS},
          f"seed batch: launches {counts} in {GRID_ROUNDS} rounds of {len(BATCH_SEEDS)} seeds")
    steady = float(h["chunk_wall_s"][-1]) / GRID_CHUNK * 1e3
    singles, notes = [], []
    for j, s in enumerate(BATCH_SEEDS):
        single, ms = single_campaign(dev, "rewafl", s)
        singles.append(ms)
        cell = {k: h[k][j] for k in CELL_COUNTS + CELL_FLOATS}
        notes.append(f"{s}: " + check_cell(f"seed batch seed {s}", h["selected"][j], cell,
                                           single))
    total = sum(singles)
    print(f"seed batch: rewafl x {len(BATCH_SEEDS)} seeds, {GRID_ROUNDS} rounds in "
          f"{wall:.2f} s, steady {steady:.1f} ms/round against {total:.1f} ms/round summed "
          f"over the single campaigns ({total / steady:.2f}x); launches {counts} (one "
          f"batched rewafl_select a round); seeds against their single campaigns: "
          f"{'; '.join(notes)}", flush=True)
    return dict(counts=counts, ms_per_round=steady, singles_ms_per_round=total,
                singles=singles, wall_s=wall)


# (name, scenario, methods) of the small card-against-CPU grids: a mixed
# sync x async grid and a faulted, dynamic one
SMALL_GRIDS = [("mixed sync x async", "static-paper", ("rewafl", "oort", "rewafl_async")),
               ("flaky-fleet", "flaky-fleet", ("random", "autofl", "rewafl"))]


def phase_small_grid_agreement(dev) -> None:
    """Two small grids (S 10, K 4, seeds 0 and 1, 4 rounds in chunks of 2,
    per-seed fleets) on the card against the same grids on the CPU: the
    same fleets, data, initial params and environments, and the same
    per-cell draws; the kernels' batched launches on one side, plain
    versions on the other. Selections and every integer counter bitwise,
    losses, costs and the virtual clock within rtol 1e-3."""
    from repro_torch.common import tree_map, tree_stack
    from repro_torch.core.methods import METHODS, async_variant
    from repro_torch.core.round import draw_noise
    from repro_torch.launch.engine import run_campaign_grid
    from repro_torch.launch.fl_run import build_task_batch, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet_batch
    from repro_torch.sim.dynamics import get_scenario, init_env_state
    S, K, n, R, seeds = 10, 4, 32, 4, (0, 1)
    specs = dict(METHODS, rewafl_async=async_variant(METHODS["rewafl"], 2))
    cfg = quick_cfg(K)
    model = make_fl_model("cnn@mnist", small=True)
    params = tree_stack([model.init(torch.Generator().manual_seed(s + 2)) for s in seeds])
    for name, scenario, names in SMALL_GRIDS:
        sc = get_scenario(scenario)
        methods = {m: specs[m] for m in names}
        gen = torch.Generator().manual_seed(5)
        noise = [[draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, sc.dynamic,
                             sc.faults.enabled) for _ in range(R)]
                 for _ in range(len(methods) * len(seeds))]
        env_u = torch.rand(len(seeds), 4, S, generator=gen)
        out = {}
        for d in ("cpu", dev):
            fleet = build_fleet_batch(seeds, S, device=d, **FL_FLEET)
            cx, cy, _ = build_task_batch("cnn@mnist", seeds, S, 0.8, per_client=n, n_test=8,
                                         device=d)
            env = tree_stack([init_env_state(tree_map(lambda x: x[b], fleet), sc,
                                             env_u[b].to(d)) for b in range(len(seeds))])
            out[str(d)] = run_campaign_grid(
                model, fleet, cx, cy, cfg, methods, seeds=seeds, rounds=R, chunk_size=2,
                per_seed_fleets=True, collect_per_device=True, scenario=sc,
                noise_fn=lambda c, r, d=d: noise[c][r].to(d),
                params=tree_map(lambda x: x.to(d), params), env=env, device=d)
        for m in methods:
            a, b = out["cpu"][m], out[str(dev)][m]
            for k, v in a.items():
                if k in ("chunk_wall_s", "compile_s"):
                    continue
                if np.asarray(v).dtype.kind in "biu":
                    check(np.array_equal(v, b[k]), f"small grid {name} {m}: {k} differs "
                          f"between the card and the CPU: {b[k]} vs {v}")
                else:
                    check(np.allclose(v, b[k], rtol=1e-3, atol=1e-5),
                          f"small grid {name} {m}: {k} differs: {b[k]} vs {v}")
        extra = {k: int(sum(out[str(dev)][m][k].sum() for m in methods))
                 for k in ("n_aborted", "n_lost", "n_rejected", "n_landed")
                 if k in out[str(dev)][names[0]]}
        print(f"small grid {name}: {len(methods)} methods x {len(seeds)} seeds, {R} rounds "
              f"on the card agree with the CPU (selections and counters bitwise, floats "
              f"within rtol 1e-3)" + (f"; totals {json.dumps(extra)}" if extra else ""),
              flush=True)


def phase_loop(dev) -> dict:
    """`run_fl("cnn@mnist", "rewafl", small=False, n_clients=100,
    n_select=20, rounds=6, eval_every=3, engine="loop")`, the per-round
    driver, launches counted from 0 (each kernel once a round), evaluated
    at rounds 0, 3 and 5, beside the chunked run of the same call:
    selections and counters equal, losses within rtol 1e-3."""
    from repro_torch.launch.fl_run import run_fl
    kw = dict(small=False, n_clients=MAIN_S, n_select=MAIN_K, rounds=GRID_ROUNDS,
              eval_every=GRID_CHUNK, device=dev)
    reset_launches()
    t0 = time.time()
    loop = run_fl("cnn@mnist", "rewafl", engine="loop", **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_launches()
    R = loop.rounds_run
    check(R == GRID_ROUNDS and counts == {"rewafl_select": R, "fedavg": R,
                                          "flash_attention": 0, "slstm": 0, "stat_util": R},
          f"loop: {R} rounds, launches {counts}")
    check(len(loop.acc_curve) == 3 and loop.chunk_wall_s is None,
          f"loop: accuracy {loop.acc_curve}, chunk walls {loop.chunk_wall_s}")
    scan = run_fl("cnn@mnist", "rewafl", **kw)
    for k in ("sel_count", "H_trace", "n_participating", "n_failed", "n_dropped"):
        check(np.array_equal(loop.history[k], scan.history[k]),
              f"loop: {k} {loop.history[k]} vs the chunked run's {scan.history[k]}")
    for k in ("global_loss", "round_energy", "round_latency"):
        check(np.allclose(loop.history[k], scan.history[k], rtol=1e-3, atol=1e-5),
              f"loop: {k} {loop.history[k]} vs the chunked run's {scan.history[k]}")
    print(f"loop: rewafl {R} rounds in {wall:.2f} s, {wall / R * 1e3:.1f} ms/round "
          f"(evals included), accuracy {[round(float(a), 4) for a in loop.acc_curve]} at rounds "
          f"0, 3, 5; launches {counts}; selections and counters equal the chunked run's",
          flush=True)
    return counts


# exact checkpoint and resume: 6 rounds in chunks of 2, a checkpoint every
# 2, stopped after 4 and resumed to 6; (aggregation, scenario) variants
RESUME_ROUNDS, RESUME_STOP, RESUME_EVERY = 6, 4, 2
RESUME_VARIANTS = [(agg, sc) for agg in ("sync", "async")
                   for sc in ("static-paper", "flaky-fleet")]


def phase_resume(dev, card: str) -> dict:
    """Exact checkpoint and resume on the main path at full width: for
    sync and async (M 10), each on static-paper and flaky-fleet,
    `run_fl("cnn@mnist", "rewafl", small=False, n_clients=100,
    n_select=20, chunk_size=2)` run uninterrupted for 6 rounds (with
    checkpoint_every=2, so it reports its carry digest), stopped after 4
    (checkpoint_every=2), resumed from that directory to 6, then with its
    newest checkpoint corrupted resumed again to 4. Checks: the resumed
    run's carry_sha equal to the uninterrupted run's and its rows 4-5
    (and final state) bitwise; the corrupted checkpoint skipped (start
    round 2, carry_sha equal to the stopped run's); each run's launches
    counted from 0 just before it (rewafl_select and stat_util once a
    round run, fedavg `fedavg_per_round` times). Prints each checkpoint's
    bytes and its write and load ms (the `checkpoint` and `resume` trace
    spans), beside `card` (the nvidia-smi name and power limit). Returns
    the resumed runs' launch counts by variant."""
    import tempfile

    from repro_torch.launch.fl_run import run_fl
    by_path, notes = {}, []
    t0 = time.time()
    for agg, scenario in RESUME_VARIANTS:
        name = f"resume {agg} {scenario}"
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="smoke_resume_", dir=os.path.join(ROOT, "build"))
        per = fedavg_per_round(agg)

        def run(rounds: int, **kw):
            reset_launches()
            res = run_fl("cnn@mnist", "rewafl", small=False, n_clients=MAIN_S,
                         n_select=MAIN_K, rounds=rounds, chunk_size=RESUME_EVERY,
                         scenario=scenario, aggregation=agg, device=dev,
                         trace=os.path.join(tmp, "trace.json"), **kw)
            torch.cuda.synchronize()
            counts = read_launches()
            ran = res.rounds_run - res.start_round
            check(counts == {"rewafl_select": ran, "fedavg": per * ran, "flash_attention": 0,
                             "slstm": 0, "stat_util": ran},
                  f"{name}: launches {counts} in {ran} rounds run ({per} fedavg a round)")
            return res, counts

        full, _ = run(RESUME_ROUNDS, checkpoint_every=RESUME_EVERY,
                      checkpoint_dir=os.path.join(tmp, "full"))
        d = os.path.join(tmp, "stopped")
        stopped, _ = run(RESUME_STOP, checkpoint_every=RESUME_EVERY, checkpoint_dir=d)
        newest = os.path.join(d, f"ckpt_r{RESUME_STOP:08d}.npz")
        check(os.path.exists(newest), f"{name}: no checkpoint at round {RESUME_STOP}")
        resumed, by_path[name] = run(RESUME_ROUNDS, resume=d)
        check(resumed.start_round == RESUME_STOP and resumed.rounds_run == RESUME_ROUNDS,
              f"{name}: resumed at {resumed.start_round}, ran to {resumed.rounds_run}")
        check(resumed.carry_sha == full.carry_sha,
              f"{name}: carry digest {resumed.carry_sha} against the uninterrupted run's "
              f"{full.carry_sha}")
        for k, v in full.history.items():
            w = resumed.history[k]
            if k == "sel_count":   # a sum over the rows: the resumed run's only
                continue
            rows = v.shape[:1] == (RESUME_ROUNDS,)
            check(np.array_equal(w[RESUME_STOP:] if rows else w, v[RESUME_STOP:] if rows else v),
                  f"{name}: {k} {w} against the uninterrupted run's {v}")
        if scenario == "flaky-fleet":
            check(int(full.history["n_rejected"].sum()) > 0, f"{name}: nothing rejected")
        size = os.path.getsize(newest)
        write_ms = stopped.spans["checkpoint"]["mean_s"] * 1e3
        load_ms = resumed.spans["resume"]["total_s"] * 1e3
        raw = bytearray(open(newest, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(newest, "wb").write(bytes(raw))
        back, _ = run(RESUME_STOP, resume=d)
        check(back.start_round == RESUME_EVERY and back.carry_sha == stopped.carry_sha,
              f"{name}: past the corrupted checkpoint resumed at {back.start_round} with "
              f"carry {back.carry_sha}, the stopped run's {stopped.carry_sha}")
        shutil.rmtree(tmp)
        notes.append(f"{agg} {scenario}: carry {full.carry_sha[:16]} equal, checkpoint "
                     f"{size} bytes, write {write_ms:.2f} ms, load {load_ms:.2f} ms, "
                     f"launches in the 2 resumed rounds {by_path[name]}")
    print(f"resume: {time.time() - t0:.1f} s; cnn@mnist rewafl at full width (S {MAIN_S}, "
          f"K {MAIN_K}), "
          f"{RESUME_ROUNDS} rounds uninterrupted against {RESUME_STOP} with checkpoint_every="
          f"{RESUME_EVERY} resumed to {RESUME_ROUNDS}: carry digests and rows "
          f"{RESUME_STOP}-{RESUME_ROUNDS - 1} bitwise; the newest checkpoint corrupted: "
          f"resumed from round {RESUME_EVERY}, carry equal to the stopped run's; "
          f"{'; '.join(notes)} ({card})", flush=True)
    return by_path


def phase_profile_grid(dev) -> None:
    """`--profile`: device time by kernel over one 3-round chunk of the
    18-cell grid (no eval), and the device's busy share of the same chunk
    run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import FLConfig
    from repro_torch.launch.engine import run_campaign_grid
    from repro_torch.launch.fl_run import build_task_batch
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet_batch
    model = make_fl_model("cnn@mnist", small=False)
    fleet = build_fleet_batch(GRID_SEEDS, MAIN_S, device=dev, **FL_FLEET)
    cx, cy, _ = build_task_batch("cnn@mnist", GRID_SEEDS, MAIN_S, 0.8, per_client=64,
                                 device=dev)
    tcfg = grid_specs(float(fleet.init_energy.max()))

    def run():
        g = run_campaign_grid(model, fleet, cx, cy, FLConfig(n_select=MAIN_K),
                              dict(METHODS), seeds=GRID_SEEDS, rounds=GRID_CHUNK,
                              chunk_size=GRID_CHUNK, per_seed_fleets=True, telemetry=tcfg,
                              device=dev)
        torch.cuda.synchronize()
        return float(g["rewafl"]["chunk_wall_s"].sum()) * len(METHODS)

    run()   # warm-up
    plain_s = statistics.median(run() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_s = run()
    ev, busy_s = _device_kernels(prof)
    print(f"profile grid: {GRID_CELLS} cells, {GRID_CHUNK} rounds: {sum(e.count for e in ev)} "
          f"kernels, device busy {busy_s * 1e3:.1f} ms; wall {plain_s * 1e3:.1f} ms without "
          f"the profiler (median of 3), busy {100 * busy_s / plain_s:.1f}%; wall "
          f"{prof_s * 1e3:.1f} ms under it, busy {100 * busy_s / prof_s:.1f}%", flush=True)
    for e in ev[:15]:
        print(f"profile grid: {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} calls  "
              f"{e.key[:90]}", flush=True)


# ------------------------------------------------------- select_aggregate

# (S, K, P): the paper CNN's parameters at the FL cell's fleet; a fleet
# above one block's 8,192 devices (two select launches) and K above 256,
# at P 4,096 and at the CNN's P (a 6.8 GB f32 stack)
AGG_CASES = [(MAIN_S, MAIN_K, FEDAVG_P), (8193, 257, 4096), (8193, 257, FEDAVG_P)]
AGG_TIMED = (AGG_CASES[0], AGG_CASES[2])
AGG_ATOL = 1e-5   # fedavg's: the K-row and dense S-row sums add in other orders
FLUSH_BYTES = 256 * 2**20   # written between L2-cold calls: the L2 holds 50 MB


def agg_inputs(S, K, P, case, seed, dev):
    avail, ui, rnd = select_inputs(S, case, seed, dev, K)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    deltas = torch.randn(S, P, generator=g, device=dev)
    weights = torch.rand(S, generator=g, device=dev) + 0.5
    return avail, ui, rnd, deltas, weights


def time_cold_ms(fn, reps: int = 50) -> float:
    """Median device time of one call with a cold L2: one call captured in
    a CUDA graph, replayed between CUDA events after FLUSH_BYTES are
    written (so the rows it reads come from device memory)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


AGG_COUNT = """
import json, re, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from repro_torch.kernels.rewafl_select import ops
S, K, P, calls = (int(a) for a in sys.argv[2:6])
dev = torch.device("cuda")
avail, ui, rnd, deltas, w = chip_smoke.agg_inputs(S, K, P, "unavail30", 11, dev)
kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)
torch.cuda.synchronize()
# a first profiled call, not counted: the device tracing's start-up
# (a run's count once came out one kernel short, 5 of 6)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)
    torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)
    torch.cuda.synchronize()
ev = chip_smoke._device_kernels(prof)[0]
print(json.dumps([sum(e.count for e in ev) / calls,
                  sorted(re.sub(r"^void |\\(.*", "", e.key.replace("(anonymous namespace)::", ""))
                         for e in ev)]))
"""


def agg_kernels_a_call(S: int, K: int, P: int, calls: int = 3):
    """(device kernels a call, their names) of `select_aggregate` at (S, K,
    P), f32, eps 0, under torch.profiler in a fresh process: in this one,
    after the earlier phases, the profiler records the host's launch calls
    but no device activity (the card tests count in their own process). A
    fresh process too has once recorded no device activity at all on an
    H100: then the count is taken again in another one, up to 3 times;
    whatever it records is held to the exact count."""
    for attempt in range(1, 4):
        out = subprocess.run([sys.executable, "-c", AGG_COUNT, ROOT, str(S), str(K),
                              str(P), str(calls)], capture_output=True, text=True, cwd=ROOT)
        check(out.returncode == 0, f"select_aggregate S={S}: the kernel count's process "
                                   f"exited {out.returncode}: {out.stderr[-2000:]}")
        per_call, names = json.loads(out.stdout.strip().splitlines()[-1])
        if names:
            break
        print(f"select_aggregate S={S}: the profiler recorded no device activity in "
              f"process {attempt} of 3", flush=True)
    return per_call, names


def phase_select_aggregate(dev) -> dict:
    """`select_aggregate` (the select kernel, then fedavg_indexed on the K
    selected rows, read in place) against its plain version (the dense
    masked S-row sum): masks bitwise, the aggregate within atol 1e-5, one
    launch counted by each wrapper a call; f32 and bf16 deltas, eps 0 and
    0.1, ~30% and all but K/2 devices unavailable, at every AGG_CASES
    row. Its own path: one call with the counts reset just before it and
    read just after. At the AGG_TIMED rows, eps 0, f32: the device kernels
    a call (torch.profiler: 2, 3 above 8,192 devices) and its times,
    graph-replayed, issued from Python and L2-cold, with programmatic
    dependent launch and without, beside the same steps issued one by one
    as the round issues them (`select_mask`, the slots of its mask,
    gather, `weighted_aggregate`), the plain version, and fedavg_indexed
    alone on the call's slots beside its plain version and one library
    call (`embedding_bag` in sum mode with the normalised weights)."""
    import torch.nn.functional as F

    from repro_torch.core.round import select_slots
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.rewafl_select import ops, ref
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    errs = {}
    for S, K, P in AGG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for eps in (0.0, 0.1):
                for case in ("unavail30", "under_k"):
                    avail, ui, rnd, deltas, w = agg_inputs(S, K, P, case, S + K, dev)
                    deltas = deltas.to(dtype)
                    l0 = ops.launches, fedavg_ops.launches, fedavg_ops.indexed_launches
                    mask, agg = ops.select_aggregate(rnd, K, avail, eps, ui, deltas, w, **kw)
                    pmask, pagg = ref.select_aggregate(rnd, K, avail, eps, ui, deltas, w, **kw)
                    torch.cuda.synchronize()
                    name = (f"select_aggregate S={S} K={K} P={P} {str(dtype)[6:]} "
                            f"eps={eps} {case}")
                    n = (ops.launches - l0[0], fedavg_ops.launches - l0[1],
                         fedavg_ops.indexed_launches - l0[2])
                    check(n == (1, 1, 1), f"{name}: {n[0]} select, {n[1]} fedavg "
                                          f"({n[2]} fedavg_indexed) launches")
                    check(torch.equal(mask, pmask), f"{name}: masks differ")
                    check(int(mask.sum()) == min(K, int(avail.sum())),
                          f"{name}: {int(mask.sum())} selected")
                    err = (agg - pagg).abs().max().item()
                    check(agg.shape == (P,) and agg.dtype == torch.float32
                          and err <= AGG_ATOL,
                          f"{name}: max |kernel - plain| = {err} > {AGG_ATOL}")
                    print(f"{name}: mask bitwise, max_abs_err {err:.3g} (atol {AGG_ATOL})",
                          flush=True)
                    errs.setdefault((S, K, P, dtype), err)
                    del deltas, pagg
    rows = {}
    for S, K, P in AGG_TIMED:
        avail, ui, rnd, deltas, w = agg_inputs(S, K, P, "unavail30", 11, dev)
        big = S * P > 10**8   # the plain versions' temporaries: fewer graph calls

        def call():
            return ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)

        def pdl_off():
            return ops.aggregate_launches(avail, ui, None, deltas, w, pdl=False,
                                          k_exploit=K, k_explore=0, **kw)

        def one_by_one():
            mask = ops.select_mask(rnd, K, avail, 0.0, ui=ui, **kw)
            idx, live = select_slots(mask, K)
            wk = w[idx] * live
            return mask, fedavg_ops.weighted_aggregate(deltas[idx], wk / wk.sum().clamp_min(1e-9))

        mask, agg = call()
        on_mask, on_agg = ops.aggregate_launches(avail, ui, None, deltas, w, pdl=True,
                                                 k_exploit=K, k_explore=0, **kw)
        off_mask, off_agg = pdl_off()
        torch.cuda.synchronize()
        check(all(torch.equal(mask, m) and torch.equal(agg, a)
                  for m, a in ((on_mask, on_agg), (off_mask, off_agg))),
              f"select_aggregate S={S}: PDL on and off differ")
        per_call, names = agg_kernels_a_call(S, K, P)
        want = 2 if S <= 8192 else 3
        check(per_call == want, f"select_aggregate S={S}: {per_call} device kernels "
                                f"a call, not {want}: {names}")
        print(f"select_aggregate S={S}: {per_call:g} device kernels a call: {names}",
              flush=True)
        idx, live = ops.select_topk(avail, ui, None, k_exploit=K, k_explore=0, **kw)
        wk = w[idx.long()] * (live > 0)
        wn = wk / wk.sum().clamp_min(1e-9)
        idx64, offsets = idx.long(), torch.zeros(1, dtype=torch.long, device=dev)
        # the pair: the leaves and the availability read, K rows and their
        # weights read, the mask and the (P,) aggregate written; ~12 flops a
        # device and 2 an element read. The kernel alone: K rows, the
        # slots and their weights read, the aggregate and the mask written
        b_ms, b_by = bound(n_bytes=S * 21 + K * (P + 1) * 4 + S + P * 4,
                           n_flops=12 * S + 2 * K * P)
        kb_ms, kb_by = bound(n_bytes=K * P * 4 + K * 12 + P * 4 + S, n_flops=2 * K * P)
        rows[f"S {S}, K {K}, P {P}"] = dict(
            ms=time_ms(call), pdl_off_ms=time_ms(pdl_off), eager_ms=time_eager_ms(call),
            cold_ms=time_cold_ms(call), pdl_off_cold_ms=time_cold_ms(pdl_off),
            separate_ms=time_ms(one_by_one), separate_eager_ms=time_eager_ms(one_by_one),
            plain_ms=time_ms(lambda: ref.select_aggregate(rnd, K, avail, 0.0, ui, deltas,
                                                          w, **kw),
                             **(dict(reps=5, inner=2) if big else {})),
            bound_ms=b_ms, bound_by=b_by, kernels_a_call=per_call,
            max_abs_err=errs[(S, K, P, torch.float32)],
            bf16_max_abs_err=errs[(S, K, P, torch.bfloat16)],
            fedavg_indexed=dict(
                ms=time_ms(lambda: fedavg_ops.weighted_aggregate_indexed(deltas, idx,
                                                                         live, w)),
                eager_ms=time_eager_ms(lambda: fedavg_ops.weighted_aggregate_indexed(
                    deltas, idx, live, w)),
                cold_ms=time_cold_ms(lambda: fedavg_ops.weighted_aggregate_indexed(
                    deltas, idx, live, w)),
                plain_ms=time_ms(lambda: fedavg_ref.weighted_aggregate_indexed(
                    deltas, idx, live, w)),
                library_ms=time_ms(lambda: F.embedding_bag(
                    idx64, deltas, offsets, mode="sum", per_sample_weights=wn)),
                bound_ms=kb_ms, bound_by=kb_by))
        half = deltas.bfloat16()   # the kernel alone on a bf16 stack
        del deltas
        rows[f"S {S}, K {K}, P {P}"]["fedavg_indexed"].update(
            bf16_ms=time_ms(lambda: fedavg_ops.weighted_aggregate_indexed(half, idx, live, w)),
            bf16_bound_ms=bound(n_bytes=K * P * 2 + K * 12 + P * 4 + S,
                                n_flops=2 * K * P)[0])
        del half
        torch.cuda.empty_cache()
    # its own path: one call, the counts reset just before and read after
    S, K, P = AGG_CASES[0]
    avail, ui, rnd, deltas, w = agg_inputs(S, K, P, "unavail30", 11, dev)
    reset_launches()
    ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)
    torch.cuda.synchronize()
    path = dict(read_launches(), fedavg_indexed=fedavg_ops.indexed_launches)
    check((path["rewafl_select"], path["fedavg"], path["fedavg_indexed"]) == (1, 1, 1),
          f"select_aggregate's own path launched {path}")
    main = rows[f"S {S}, K {K}, P {P}"]
    return dict(name="select_aggregate", route="rewafl_select.cu + fedavg.cu fedavg_indexed",
                source="src/repro_torch/kernels/rewafl_select/ops.py",
                replaces="src/repro/kernels/rewafl_select/ops.py:134",
                shape=f"S {S}, K {K}, P {P} f32, eps 0", launches=1,
                launches_by_path={"select_aggregate": path},
                check="mask bitwise, aggregate atol 1e-5 (f32 and bf16 deltas)",
                **{k: v for k, v in main.items() if k != "fedavg_indexed"},
                library_ms=None, rows=rows)


# ------------------------------------------------------------- serving path

SERVE_B, SERVE_S, SERVE_TOKENS = 4, 2048, 32
# timed serves of each serving path (the first also counts the launches)
SERVE_REPEATS = {"llama3.2-3b": 5, "xlstm-1.3b": 3, "olmoe-1b-7b": 4, "zamba2-7b": 3}


def prefill_launches(cfg, batch: int) -> dict:
    """The kernel launches one prefill of `cfg` at `batch` makes (slstm:
    one a slice of at most 16 rows; flash_attention: one a layer, or one a
    group of Mamba2 layers in the hybrid family, whose tail has no
    attention); every other kernel must launch 0 times."""
    if cfg.family == "ssm":
        return {"slstm": cfg.n_layers // cfg.slstm_group * -(-batch // 16)}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every}
    return {"flash_attention": cfg.n_layers}


def serve_params(dev, arch: str):
    """Full-width weights of `arch` drawn on the card from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model_api
    cfg = get_config(arch)
    t0 = time.time()
    with torch.inference_mode():
        params = get_model_api(cfg).init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"serve: {arch} weights ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_dtype}) drawn on the card in {time.time() - t0:.1f} s", flush=True)
    return cfg, params


def phase_serve(dev, arch: str, cfg, params, smi: str):
    """A serving path at full width: prefill B 4 x S 2048, then 32 greedy
    decode steps, with every kernel's launch count read just after; then
    the same serve again, for the median and spread of the times over
    SERVE_REPEATS[arch] runs."""
    from repro_torch.configs import param_count
    from repro_torch.launch.serve import serve, summary
    kw = dict(batch=SERVE_B, prompt_len=SERVE_S, params=params, device=dev)
    serve(arch, tokens=2, seed=1, **kw)   # warm-up: cuBLAS picks its kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = serve(arch, tokens=SERVE_TOKENS, seed=0, **kw)
    counts, tc = read_launches(), read_tc_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: prefill_launches(cfg, SERVE_B).get(k, 0) for k in counts}
    check(counts == want, f"{arch}: one prefill launched {counts}, not {want}")
    # bf16 weights: every attention and sLSTM launch is a tensor-core kernel's
    for k in TC_KERNELS:
        check(tc[k] == counts[k], f"{arch}: {tc[k]} of {counts[k]} {k} launches on the "
                                  "tensor cores")
    check((res.flash_launches, res.slstm_launches)
          == (counts["flash_attention"], counts["slstm"]),
          f"{arch}: the serve counted {res.flash_launches} flash and "
          f"{res.slstm_launches} slstm launches, the kernels {counts}")
    check(tuple(res.ids.shape) == (SERVE_B, SERVE_TOKENS + 1),
          f"generated ids of shape {tuple(res.ids.shape)}")
    check(int(res.ids.min()) >= 0 and int(res.ids.max()) < cfg.vocab,
          "generated ids outside the vocabulary")
    check(tuple(res.last_logits.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(res.last_logits).all()),
          "last logits not finite or of the wrong shape")
    check(res.n_params == param_count(cfg), "parameter count")
    repeats = SERVE_REPEATS[arch]
    runs = [summary(r) for r in [res] + [serve(arch, tokens=SERVE_TOKENS, seed=0, **kw)
                                         for _ in range(repeats - 1)]]
    out = summary(res)
    for key in ("prefill_ms", "decode_ms_per_token", "decode_tok_per_s"):
        vals = [r[key] for r in runs]
        out[key], out[key + "_runs"] = statistics.median(vals), vals
    out.update(peak_memory_gb=peak_gb, device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    spread = {k: (min(out[k + "_runs"]), max(out[k + "_runs"]))
              for k in ("prefill_ms", "decode_ms_per_token")}
    print(f"serve: {arch} {res.n_params / 1e9:.3f} B params; median of "
          f"{repeats}: prefill {SERVE_B} x {SERVE_S} in {out['prefill_ms']:.1f} ms "
          f"(range {spread['prefill_ms'][0]:.1f}-{spread['prefill_ms'][1]:.1f}), decode "
          f"{out['decode_ms_per_token']:.2f} ms/token (range "
          f"{spread['decode_ms_per_token'][0]:.2f}-{spread['decode_ms_per_token'][1]:.2f}; "
          f"{out['decode_tok_per_s']:.1f} tok/s over {SERVE_B} requests), {SERVE_TOKENS} "
          f"tokens decoded; launches {counts}, on the tensor cores {tc}; peak "
          f"{peak_gb:.2f} GB ({smi})", flush=True)
    return counts, tc, out


# last logits' error relative to their scale, card against CPU, by weights'
# dtype: f32 weights still round k and v to bf16 caches (the CPU parity
# test measures up to 4.1e-5 against the reference); with bf16 weights
# every layer rounds to bf16 (up to 1.4e-2 there)
SERVE_AGREE_REL = {"float32": 5e-4, "bfloat16": 3e-2}
# (arch, prompt length, batch): xlstm's prompt is one mLSTM chunk of 64;
# at batch 17 each sLSTM layer runs two slstm launches; the reduced moe
# family: olmoe-1b-7b (2 MoE layers of 4 experts, top 2) and
# kimi-k2-1t-a32b (a dense prefix layer, then a MoE layer with a shared
# expert); zamba2-7b's prompt is two SSD chunks of 64, and its reduced
# window of 8 wraps the shared block's ring cache
AGREE_ARCHS = [("llama3.2-3b", 40, 2), ("gemma2-27b", 40, 2), ("xlstm-1.3b", 64, 2),
               ("xlstm-1.3b", 64, 17), ("olmoe-1b-7b", 40, 2), ("kimi-k2-1t-a32b", 40, 2),
               ("zamba2-7b", 128, 2)]


def phase_serve_agreement(dev) -> None:
    """Reduced llama3.2-3b, gemma2-27b (hd 64; gemma2 with windows and
    softcaps), xlstm-1.3b (8 layers, 4 sLSTM of hd 64; at batch 2 and 17),
    olmoe-1b-7b, kimi-k2-1t-a32b and zamba2-7b (2 Mamba2 layers, then the
    shared attention block, window 8), with f32 and with bf16 weights,
    served on the card and on the CPU from the same weights: greedy ids
    equal, last logits within SERVE_AGREE_REL of their scale. The moe
    family is held under the flip rule (`tests/moe_flip_rule.py`) instead:
    a first-order flip (a token choosing other experts with no earlier
    flip upstream of it) within CARD_GAP_BOUND of a tie on the CPU's side;
    router inputs, greedy ids and last logits that no flip reached within
    CARD_STATE_REL of their scale (ids equal); the flip count and the
    largest gap among flips printed."""
    import contextlib
    import dataclasses

    from moe_flip_rule import record_port_routes
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model_api
    for arch, prompt_len, batch in AGREE_ARCHS:
        for dt, rel in SERVE_AGREE_REL.items():
            cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype=dt)
            params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
            kw = dict(reduced=True, param_dtype=dt, batch=batch, prompt_len=prompt_len,
                      tokens=8, seed=5)
            moe = cfg.family == "moe"
            record = record_port_routes if moe else contextlib.nullcontext
            with record() as cpu_log:
                cpu = serve(arch, device="cpu", params=params, **kw)
            tc0 = read_tc_launches()
            with record() as card_log:
                card = serve(arch, device=dev, params=_to(params, dev), **kw)
            tc = {k: v - tc0[k] for k, v in read_tc_launches().items()}
            name = f"{arch} reduced {dt} batch {batch}"
            want = prefill_launches(cfg, batch)
            got = {k: v for k, v in (("flash_attention", card.flash_launches),
                                     ("slstm", card.slstm_launches)) if v or k in want}
            check(got == want, f"{name}: launches on the card {got}, not {want}")
            bf16 = dt == "bfloat16"
            tc_want = {"flash_attention": card.flash_launches if bf16 else 0,
                       "slstm": card.slstm_launches if bf16 else 0}
            check(tc == tc_want, f"{name}: tensor-core launches {tc}, not {tc_want}")
            if moe:
                check_moe_served(cfg, card, cpu, card_log, cpu_log, dt, name)
                continue
            check(torch.equal(cpu.ids, card.ids),
                  f"{name}: greedy ids differ: {cpu.ids.tolist()} vs {card.ids.tolist()}")
            scale = cpu.last_logits.abs().max().item()
            err = (cpu.last_logits - card.last_logits).abs().max().item()
            check(err <= rel * scale, f"{name}: last logits differ by {err} "
                                      f"(scale {scale}, rel {rel})")
            print(f"serve agreement {name}: ids equal over {kw['tokens']} steps, "
                  f"last logits within {err / scale:.3g} of scale {scale:.3g} "
                  f"(limit {rel})", flush=True)


def check_moe_served(cfg, card, cpu, card_log, cpu_log, dt: str, name: str) -> None:
    """A moe serve on the card held to the CPU's under the flip rule."""
    from moe_flip_rule import CARD_GAP_BOUND, check_served
    try:
        r = check_served(card, cpu, card_log, cpu_log, dtype=dt, name=name,
                         n_moe=cfg.n_layers - cfg.moe.n_dense_prefix)
    except AssertionError as e:
        fail(f"moe agreement: {e}")
    gaps = [f.gap for f in r.flips]
    print(f"moe agreement {name}: {len(r.flips)} flips "
          f"({sum(f.first_order for f in r.flips)} first-order), largest gap "
          f"among flips {max(gaps, default=0.0):.3g} (bound {CARD_GAP_BOUND[dt]:.3g} "
          f"for first-order); router inputs no flip reached within "
          f"{r.max_state_err:.3g} of scale, last logits of the rows no flip "
          f"reached within {r.logit_err:.3g}", flush=True)
    for line in r.lines(name)[1:]:
        print(f"moe agreement {line}", flush=True)


def moe_full_width_note(smi: str) -> None:
    """kimi-k2-1t-a32b at its published widths is not served: its bf16
    weights alone exceed the card's memory."""
    from repro_torch.configs import get_config, param_count
    n = param_count(get_config("kimi-k2-1t-a32b"))
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"serve: kimi-k2-1t-a32b at full width not attempted: {n:,} parameters, "
          f"{2 * n / 1e9:,.1f} GB of bf16 weights against the card's "
          f"{total / 1e9:.1f} GB ({smi}); served reduced only", flush=True)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _device_kernels(prof, exclude=()):
    """Device-side kernel events, largest first, and their summed time (s).
    Only kernels: an aten op's device time repeats the time of the kernels
    it launched, and so does a named range (`exclude`: the names of
    `record_function` ranges)."""
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0 and e.key not in exclude]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return ev, sum(e.self_device_time_total for e in ev) / 1e6


# fragments of the serving kernels' names in a profile
PORT_KERNEL_KEYS = ("slstm", "flash_fwd")


def phase_profile_serve(dev, arch: str, params, main: dict) -> None:
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
            serve(arch, tokens=n, **kw)
        top[n], busy[n] = _device_kernels(prof)
    step_s = (busy[8] - busy[0]) / 8
    print(f"profile serve {arch}: prefill device busy {busy[0] * 1e3:.1f} ms of "
          f"{main['prefill_ms']:.1f} ms unprofiled wall ({100 * busy[0] * 1e3 / main['prefill_ms']:.1f}%); "
          f"decode device busy {step_s * 1e3:.2f} ms/step of "
          f"{main['decode_ms_per_token']:.2f} ms unprofiled wall "
          f"({100 * step_s * 1e3 / main['decode_ms_per_token']:.1f}%)", flush=True)
    for n, label in ((0, "prefill"), (8, "prefill+8 decode")):
        # the ten largest, and the port's own kernels wherever they rank
        own = [e for e in top[n][10:] if any(k in e.key for k in PORT_KERNEL_KEYS)]
        for e in top[n][:10] + own:
            print(f"profile serve {arch} {label}: {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d} calls  {e.key[:80]}", flush=True)


def phase_profile(dev, task: str = "cnn@mnist", method: str = "rewafl",
                  rounds: int = 5) -> None:
    """`--profile`: device time by kernel over `rounds` rounds of
    `run_fl(task, method)` at paper widths, from torch.profiler, and the
    device's busy share of the rounds' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.fl_run import run_fl
    from repro_torch.obs import Tracer, tracing
    kw = dict(small=False, n_clients=MAIN_S, n_select=MAIN_K, rounds=rounds,
              eval_every=rounds, device=dev)
    run_fl(task, method, **kw)   # warm-up
    # the same 5 rounds without the profiler, which slows the host
    plain_s = statistics.median(
        float(run_fl(task, method, **kw).chunk_wall_s.sum())
        for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the engine's phases, as named ranges on the profile's timeline
        with tracing(Tracer(profiler=True)) as tracer:
            res = run_fl(task, method, **kw)
        torch.cuda.synchronize()
    rounds_s = float(res.chunk_wall_s.sum())
    phases = {k: round(v["total_s"] * 1e3, 3) for k, v in tracer.summary().items()}
    print(f"profile {task} {method}: host phases under the profiler (ms, the "
          f"tracer's clock) {json.dumps(phases)}", flush=True)
    # the ranges also show on the device timeline: they are not kernels
    ev, busy_s = _device_kernels(prof, exclude={e["name"] for e in tracer.events})
    print(f"profile {task} {method}: {sum(e.count for e in ev)} kernels in {rounds} "
          f"rounds (eval included), device busy {busy_s * 1e3:.1f} "
          f"ms; wall {plain_s * 1e3:.1f} ms without the profiler (median of "
          f"3), busy {100 * busy_s / plain_s:.1f}%; wall {rounds_s * 1e3:.1f} "
          f"ms under it, busy {100 * busy_s / rounds_s:.1f}%", flush=True)
    for e in ev[:15]:
        print(f"profile {task} {method}: {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d} calls  {e.key[:90]}", flush=True)


# --------------------------------------------------------------------- main

# the bf16 tensor-core kernels (mangled-name fragment) and the head widths
# whose ptxas lines are printed: the main path's and its reduced config's
TC_FUNCS = {"flash_attention": ("flash_fwd_tc_kernel", None),
            "slstm": ("slstm_tc_kernel", {"64", "256", "512"})}


def print_ptxas(name: str, report: str) -> None:
    """Registers and spills of the functions of kernel `name`, from ptxas
    (of the slstm cluster kernel, compiled for every hd = 16·KS it takes,
    only hd 64, 256 and 512 and a summary); fails if a bf16 tensor-core
    kernel spills."""
    lines = report.splitlines()
    tc_fn, shown = TC_FUNCS[name]
    n_tc, max_regs = 0, 0
    for i, line in enumerate(lines):
        if "Function properties for" not in line:
            continue
        fn = line.split("Function properties for")[-1].strip()
        tc = tc_fn in fn
        kind = "tensor-core bf16" if tc else re.search(r"\d([a-z_]+kernel)", fn).group(1)
        arg = fn.split("ILi")[1].split("E")[0] if "ILi" in fn else "?"
        hd = str(16 * int(arg)) if tc and name == "slstm" else arg   # templated on hd / 16
        used = next((x.split(":")[-1].strip() for x in lines[i + 1:i + 3] if "Used" in x), "?")
        spills = lines[i + 1].strip()
        if tc:
            check(" 0 bytes spill stores, 0 bytes spill loads" in " " + spills,
                  f"the tensor-core {name} kernel spills at hd {hd}: {spills}")
            n_tc += 1
            max_regs = max(max_regs, int(used.split()[1]) if used.startswith("Used") else 0)
        if not tc or shown is None or hd in shown:
            print(f"ptxas {name} {kind} hd {hd}: {used}; {spills}", flush=True)
    check(n_tc > 0, f"ptxas reported no tensor-core {name} kernel")
    print(f"ptxas {name}: {n_tc} tensor-core instantiations, at most {max_regs} "
          "registers, none spills", flush=True)


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
    for k in TC_KERNELS:
        print_ptxas(k, _build.ptxas_report(k))

    phase_select(dev)   # bitwise: any difference has failed the run
    fed_err = phase_fedavg(dev)
    phase_fedavg_nan(dev)
    flash_err = phase_flash(dev)
    slstm_err = phase_slstm(dev)
    stat_err = phase_stat_util(dev)
    batched_err = phase_batched_kernels(dev)
    floor_ms = time_launch_floor()
    print(f"time launch floor: launch_floor_ms {floor_ms:.5f} (zero_() on one element)",
          flush=True)
    times = {"rewafl_select": time_select(dev), "fedavg": time_fedavg(dev),
             "flash_attention": time_flash(dev), "slstm": time_slstm(dev),
             "stat_util": time_stat_util(dev, MAIN_K, 32)}
    for v in times.values():
        v["launch_floor_ms"] = floor_ms
    # the async land's aggregate: the whole (buffer_m + K, P) delta buffer
    times["fedavg"]["async_land"] = land = time_fedavg(dev, ASYNC_SLOTS)
    land.update(shape=f"K {ASYNC_SLOTS}, P {FEDAVG_P} f32", launch_floor_ms=floor_ms)
    # flash_attention at olmoe-1b-7b's prefill layer (H 16, n_kv 16: GQA group 1)
    times["flash_attention"]["olmoe_prefill"] = olmoe_flash = time_flash(dev, OLMOE_FLASH)
    olmoe_flash.update(shape="B 4, S 2048, H 16, n_kv 16, hd 128 bf16 causal",
                       launch_floor_ms=floor_ms)
    # at zamba2-7b's shared attention (hd 112), bf16 as its prefill calls it,
    # and the f32 kernel at hd 112
    times["flash_attention"]["zamba2_prefill"] = zamba_flash = time_flash(dev, ZAMBA_FLASH)
    zamba_flash.update(shape="B 4, S 2048, H 32, n_kv 32, hd 112 bf16 causal window 4096",
                       launch_floor_ms=floor_ms)
    times["flash_attention"]["hd112_f32"] = f32_flash = time_flash(dev, ZAMBA_F32_FLASH)
    f32_flash.update(shape="B 1, S 512, H 32, n_kv 32, hd 112 f32 causal window 4096",
                     launch_floor_ms=floor_ms)
    time_ssd(dev)
    for k, v in time_batched(dev).items():   # the campaigns' batched calls
        v.update(launch_floor_ms=floor_ms, max_abs_err=batched_err[k])
        times[k]["batched"] = v
    for k, v in list(times.items()) + [(f"{k} batched ({v['batched']['shape']})",
                                        v["batched"]) for k, v in times.items()
                                       if "batched" in v] + [
            (f"fedavg K={ASYNC_SLOTS} (async land)", land),
            ("flash_attention olmoe-1b-7b prefill (H 16, n_kv 16)", olmoe_flash),
            ("flash_attention zamba2-7b prefill (H 32, n_kv 32, hd 112, window 4096)",
             zamba_flash),
            ("flash_attention f32 hd 112 (B 1, S 512, H 32, n_kv 32)", f32_flash),
            ("rewafl_select S=1e6", time_select(dev, 1_000_000)),
            ("stat_util S=1e6 n=32", time_stat_util(dev, 1_000_000, 32))]:
        extra = (f", padded rows {v['padded_ms']:.5f} ms" if "padded_ms" in v else
                 f", step floor {v['barrier_floor_ms']:.5f} ms"
                 if "barrier_floor_ms" in v else "")
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.5f} ms"
        print(f"time {k}: kernel {v['ms']:.5f} ms{extra} (issued from Python "
              f"{v['eager_ms']:.5f} ms), plain {v['plain_ms']:.5f} ms, library "
              f"{lib}, bound {v['bound_ms']:.6f} ms ({v['bound_by']}), launch floor "
              f"{floor_ms:.5f} ms", flush=True)

    # the FL path: rewafl_select, fedavg, stat_util
    counts = {k: v for k, v in phase_main_path(dev).items()
              if k in ("rewafl_select", "fedavg", "stat_util")}
    # every method on the image task, REWAFL and Oort on the HAR and char
    # tasks, each its own path with the counts read just after it
    for task, method in METHOD_RUNS + TASK_RUNS:
        phase_fl_run(dev, task, method)
    # the fleet-dynamics scenarios, each its own path with the counts read
    # just after it
    for scenario in DYNAMIC_SCENARIOS:
        phase_fl_run(dev, "cnn@mnist", "rewafl", scenario)
    phase_small_agreement(dev)
    phase_weekend(dev)
    # async aggregation and the fault scenarios, each its own path with
    # the counts read just after it
    chaos_counts = phase_async_and_faults(dev)
    phase_small_chaos_agreement(dev)
    # streaming telemetry with the health monitors and the trace, sync and
    # async, each its own path with the counts read just after it
    chaos_counts.update(phase_streaming(dev))
    phase_small_streaming_agreement(dev)
    # the (method x seed) grid, the per-method seed batch and the loop
    # engine, each its own path with the counts read just after it
    grid = phase_grid(dev)
    batch = phase_seed_batch(dev)
    chaos_counts.update({"grid": grid["counts"], "seed batch": batch["counts"],
                         "loop": phase_loop(dev)})
    # exact checkpoint and resume, sync and async, static and faulted,
    # each resumed run its own path with the counts read just after it
    chaos_counts.update(phase_resume(dev, smi))
    phase_small_grid_agreement(dev)
    agg = phase_select_aggregate(dev)
    for shape, r in agg["rows"].items():
        k = r["fedavg_indexed"]
        print(f"time select_aggregate {shape}: {r['ms']:.5f} ms (PDL off "
              f"{r['pdl_off_ms']:.5f}; issued from Python {r['eager_ms']:.5f}; L2-cold "
              f"{r['cold_ms']:.5f}, PDL off {r['pdl_off_cold_ms']:.5f}), select_mask + "
              f"slots + gather + weighted_aggregate {r['separate_ms']:.5f} ms (issued "
              f"from Python {r['separate_eager_ms']:.5f} ms), plain {r['plain_ms']:.5f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); fedavg_indexed "
              f"alone {k['ms']:.5f} ms (issued from Python {k['eager_ms']:.5f}; L2-cold "
              f"{k['cold_ms']:.5f}; bf16 stack "
              f"{k['bf16_ms']:.5f}, bound {k['bf16_bound_ms']:.6f}), plain "
              f"{k['plain_ms']:.5f} ms, library {k['library_ms']:.5f} ms, bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']})", flush=True)
    profile = "--profile" in sys.argv[1:]
    if profile:
        phase_profile(dev)
        # ~88,000 kernels a round: 2 rounds keep the trace's processing short
        phase_profile(dev, "lstm@shakespeare", "rewafl", rounds=2)
        phase_profile_grid(dev)
    # the serving paths: flash_attention (llama3.2-3b's count is the one
    # reported as `launches`), slstm, each path's in `launches_by_path`
    tc_counts, serve_paths = {}, {}
    for arch in SERVE_REPEATS:
        cfg, params = serve_params(dev, arch)
        serve_counts, serve_tc, serve_out = phase_serve(dev, arch, cfg, params, smi)
        for k in prefill_launches(cfg, SERVE_B):
            counts.setdefault(k, serve_counts[k])
            tc_counts.setdefault(k, serve_tc[k])
            serve_paths.setdefault(k, {})[arch] = serve_counts[k]
        if profile:
            phase_profile_serve(dev, arch, params, serve_out)
        del params
        torch.cuda.empty_cache()
    moe_full_width_note(smi)
    phase_serve_agreement(dev)

    meta = {
        "rewafl_select": ("src/repro_torch/kernels/csrc/rewafl_select.cu",
                          "src/repro/kernels/rewafl_select/rewafl_select.py:150",
                          0.0, "bitwise"),
        "fedavg": ("src/repro_torch/kernels/csrc/fedavg.cu",
                   "src/repro/kernels/fedavg/fedavg.py:30", fed_err, "atol 1e-5"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:77",
                            flash_err, "bf16 rtol 2**-7 (f32 atol 1e-5)"),
        "slstm": ("src/repro_torch/kernels/csrc/slstm.cu",
                  "src/repro/kernels/slstm/slstm.py:59", slstm_err,
                  "bf16 2**-7 of scale (f32 1e-5 of max(1, scale))"),
        "stat_util": ("src/repro_torch/kernels/csrc/stat_util.cu",
                      "src/repro/kernels/stat_util/stat_util.py:28", stat_err, "rtol 1e-5"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=counts[k], max_abs_err=err, **times[k], check=chk,
                    **({"tc_launches": tc_counts[k]} if k in TC_KERNELS else {}),
                    **({"launches_by_path": {p: c[k] for p, c in chaos_counts.items()}}
                       if k in ("rewafl_select", "fedavg", "stat_util") else {}),
                    **({"launches_by_path": serve_paths[k]} if k in serve_paths else {}))
               for k, (src, rep, err, chk) in meta.items()]
    # fedavg_indexed: on select_aggregate's path, timed alone on its slots
    ix = next(iter(agg["rows"].values()))   # the first timed row, the main one
    kernels.append(dict(
        name="fedavg_indexed", route="cuda", source="src/repro_torch/kernels/csrc/fedavg.cu",
        replaces="src/repro/kernels/rewafl_select/ops.py:134",
        via="select_aggregate: rewafl_select.cu + fedavg.cu fedavg_indexed",
        launches=agg["launches_by_path"]["select_aggregate"]["fedavg_indexed"],
        max_abs_err=agg["max_abs_err"], shape=agg["shape"],
        **ix["fedavg_indexed"], pair_ms=agg["ms"], pair_bound_ms=agg["bound_ms"],
        check="atol 1e-5 (f32 and bf16 stacks), mask bitwise",
        launch_floor_ms=floor_ms,
        launches_by_path=agg["launches_by_path"]))
    agg["launch_floor_ms"] = floor_ms
    print(json.dumps({"select_aggregate": agg}), flush=True)
    print(json.dumps({"campaign": {
        "grid": {k: grid[k] for k in ("ms_per_round", "singles_ms_per_round", "peak_gib",
                                      "singles")},
        "seed_batch": {k: batch[k] for k in ("ms_per_round", "singles_ms_per_round",
                                             "singles")}}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
