"""Steady ms/round of the single-campaign FL path (or of the campaign
grid) of two checkouts, in turns on one card.

    python3 tools/campaign/turns.py --other build/parent [--turns 3] [--path grid]

`--other` is another checkout of the repository (for instance the parent
commit unpacked with `git archive` into the git-ignored `build/`). Each
turn runs, in fresh processes, the other tree, this tree, this tree and
the other tree (ABBA), each `run_fl("cnn@mnist", "rewafl", small=False,
n_clients=100, n_select=20, rounds=9, eval_every=3)` twice on the card
(the first warms up and builds the kernels) and reports the second run's
steady ms/round: the mean of its last two 3-round chunks (host clock,
eval included). `--path grid` runs `run_campaign_grid` of the six methods
x seeds {0, 1, 2} instead (cnn@mnist at full width, per-seed fleets,
streaming `DEFAULT_SPECS`, 9 rounds in chunks of 3), its ms/round over
the last two chunks. Prints one line a run, then the median and
quartiles of each tree and the card's name and power limit. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.fl_run import run_fl
kw = dict(small=False, n_clients=100, n_select=20, rounds=9, eval_every=3, device="cuda")
run_fl("cnn@mnist", "rewafl", **kw)
res = run_fl("cnn@mnist", "rewafl", **kw)
torch.cuda.synchronize()
w = res.chunk_wall_s
print(json.dumps({"ms_per_round": float(w[1:].sum() / res.chunk_rounds[1:].sum() * 1e3)}))
"""


GRID = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.core.methods import METHODS
from repro_torch.core.metrics import DEFAULT_SPECS, TelemetryCfg
from repro_torch.core.round import FLConfig
from repro_torch.launch.engine import run_campaign_grid
from repro_torch.launch.fl_run import build_task_batch
from repro_torch.models.fl_models import make_fl_model
from repro_torch.sim.devices import build_fleet_batch
seeds = (0, 1, 2)
fleet = build_fleet_batch(seeds, 100, device="cuda", init_energy_mean=0.11,
                          init_energy_std=0.04, e0_frac=0.08)
cx, cy, _ = build_task_batch("cnn@mnist", seeds, 100, 0.8, per_client=64, device="cuda")
kw = dict(seeds=seeds, rounds=9, chunk_size=3, per_seed_fleets=True, device="cuda",
          telemetry=TelemetryCfg(mode="streaming", specs=DEFAULT_SPECS))
model = make_fl_model("cnn@mnist", small=False)
run_campaign_grid(model, fleet, cx, cy, FLConfig(n_select=20), dict(METHODS), **kw)
h = run_campaign_grid(model, fleet, cx, cy, FLConfig(n_select=20), dict(METHODS),
                      **kw)["rewafl"]
torch.cuda.synchronize()
w = h["chunk_wall_s"] * len(METHODS)   # each method's share, times the methods
print(json.dumps({"ms_per_round": float(w[1:].sum() / h["chunk_rounds"][1:].sum() * 1e3)}))
"""


def one(src: str, path: str = "fl") -> float:
    out = subprocess.run([sys.executable, "-c", GRID if path == "grid" else RUN, src],
                         capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    return json.loads(out)["ms_per_round"]


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return q[0], statistics.median(xs), q[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="another checkout's root")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--path", default="fl", choices=("fl", "grid"))
    args = ap.parse_args()
    trees = {"other": os.path.join(os.path.abspath(args.other), "src"),
             "this": os.path.join(HERE, "src")}
    got = {k: [] for k in trees}
    for t in range(args.turns):
        for name in ("other", "this", "this", "other"):
            ms = one(trees[name], args.path)
            got[name].append(ms)
            print(f"turn {t} {args.path} {name}: {ms:.1f} ms/round", flush=True)
    for name, xs in got.items():
        lo, med, hi = quartiles(xs)
        print(f"{args.path} {name}: median {med:.1f} ms/round (quartiles "
              f"{lo:.1f}-{hi:.1f}) over {len(xs)} runs", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({k: sorted(v) for k, v in got.items()}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
