"""Steady ms/round of the FL path with dense telemetry, with streaming
telemetry, and with streaming telemetry, the health monitors and the
trace, run in turns in one process on one GPU.

    python3 tools/telemetry/alternate.py            # 6 rounds of each mode
    python3 tools/telemetry/alternate.py --turns 8

Each run is `run_fl("cnn@mnist", "rewafl", small=False, n_clients=100,
n_select=20, rounds=6, eval_every=3, ...)`, the smoke's full-width call;
its steady ms/round is the second chunk's wall over its 3 rounds (eval
included). The modes rotate, each turn starting one mode later than the
last, so drift on the host falls on every mode alike. After one warm-up
run of each mode, prints every run's time, each mode's median and
quartiles, the streaming runs' trace spans summed over the turns, and
the card's name and power limit.

Then two checks of what streaming adds to a round: the host time of one
`update_telemetry` call (the fold of one round's metrics at S 100, with
the default specs and with the health quantiles added), from the host
clock over 200 calls, issue only and then with the card's work; and the
host syncs of one 6-round run of each mode, counted with PyTorch's sync
debug mode set to warn (each sync a warning), and the fold alone run
with it set to error.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

MODES = ("dense", "streaming", "streaming+health+trace")


def run(mode: str, tmp: str):
    from repro_torch.launch.fl_run import run_fl
    from repro_torch.obs import HealthCfg
    kw = {}
    if mode != "dense":
        kw["telemetry"] = "streaming"
    if mode == "streaming+health+trace":
        kw.update(health=HealthCfg(max_near_frac=None),
                  trace=os.path.join(tmp, "run.trace.json"))
    res = run_fl("cnn@mnist", "rewafl", small=False, n_clients=100, n_select=20,
                 rounds=6, eval_every=3, device="cuda", **kw)
    torch.cuda.synchronize()
    return float(res.chunk_wall_s[-1]) / int(res.chunk_rounds[-1]) * 1e3, res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("alternate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    times = {m: [] for m in MODES}
    spans = {}
    with tempfile.TemporaryDirectory() as tmp:
        for m in MODES:       # warm-up: kernels built, cuDNN plans chosen
            run(m, tmp)
        for t in range(args.turns):
            for i in range(len(MODES)):
                m = MODES[(t + i) % len(MODES)]
                ms, res = run(m, tmp)
                times[m].append(ms)
                for k, v in (res.spans or {}).items():
                    spans[k] = spans.get(k, 0.0) + v["total_s"] * 1e3
    out = {}
    for m, v in times.items():
        q1, q3 = np.percentile(v, [25, 75])
        out[m] = {"median": statistics.median(v), "q1": float(q1), "q3": float(q3),
                  "runs": v}
        print(f"{m}: median {statistics.median(v):.1f} ms/round (quartiles {q1:.1f}, "
              f"{q3:.1f}) over {len(v)} runs: {[round(x, 1) for x in v]}", flush=True)
    print("spans of the traced runs, summed (ms): "
          + json.dumps({k: round(v, 3) for k, v in sorted(spans.items(),
                                                          key=lambda kv: -kv[1])}))
    fold = fold_cost()
    print(f"update_telemetry at S 100: {json.dumps(fold)} (ms a call)", flush=True)
    syncs = sync_counts()
    print(f"host syncs in one 6-round run: {json.dumps(syncs)}", flush=True)
    print(json.dumps({"ms_per_round": out, "fold_ms": fold, "syncs": syncs, "card": smi}))
    print(smi)


def _metrics(S: int = 100):
    """One round's metrics dict at S devices, with the round's dtypes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    return {"selected": torch.rand(S, generator=g, device=dev) < 0.2,
            "H": torch.randint(1, 30, (S,), generator=g, device=dev, dtype=torch.int32),
            "residual_energy": torch.rand(S, generator=g, device=dev) * 3e4,
            "staleness": torch.randint(0, 6, (S,), generator=g, device=dev,
                                       dtype=torch.int32)}


def fold_cost(calls: int = 200) -> dict:
    import time

    from repro_torch.core.metrics import DEFAULT_SPECS, TelemetryCfg, init_telemetry, \
        update_telemetry
    from repro_torch.obs import HealthCfg
    m = _metrics()
    out = {}
    for name, specs in (("default", DEFAULT_SPECS),
                        ("default+health", DEFAULT_SPECS
                         + HealthCfg().quantile_specs(6, 3e4))):
        cfg = TelemetryCfg(mode="streaming", specs=specs)
        tel = init_telemetry(cfg, m)
        for r in range(10):
            tel = update_telemetry(cfg, tel, m, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(calls):
            tel = update_telemetry(cfg, tel, m, r)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = {"issue": (t1 - t0) / calls * 1e3, "with_card": (t2 - t0) / calls * 1e3}
    return out


def sync_counts() -> dict:
    """Host syncs of one 6-round run of each mode (sync debug mode
    "warn"), and of 20 folds alone with the health quantiles (mode
    "error": raises at a sync)."""
    import warnings

    from repro_torch.core.metrics import DEFAULT_SPECS, TelemetryCfg, init_telemetry, \
        update_telemetry
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for m in MODES:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run(m, tmp)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            out[m] = sum("synchroniz" in str(x.message) for x in w)
    from repro_torch.obs import HealthCfg
    cfg = TelemetryCfg(mode="streaming",
                       specs=DEFAULT_SPECS + HealthCfg().quantile_specs(6, 3e4))
    met = _metrics()
    tel = init_telemetry(cfg, met)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in range(20):
            tel = update_telemetry(cfg, tel, met, r)
        out["fold alone"] = 0
    except RuntimeError as e:
        out["fold alone"] = f"sync: {e}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out


if __name__ == "__main__":
    main()
