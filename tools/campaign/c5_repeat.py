"""Is one FL campaign on the card repeatable, and how far is a vmapped
grid (or seed-batch) cell's round from the single campaign's round on
the same inputs?

    python3 tools/campaign/c5_repeat.py [--procs 3] \
        [--modes port,cudnn-default,deterministic] [--out build/c5_repeat.json]

For each mode it starts `--procs` fresh worker processes. A worker builds
the campaigns as `chip_smoke.single_campaign` does (`run_fl`'s seeds:
fleet and data from `seed`, the model from `seed + 2`, the round noise
from `seed + 1`; cnn@mnist at full width, S 100, K 20, `FLConfig(
n_select=20)`), then sets cuDNN's switches by the mode:

- `port`: as the port's set-up (`resolve_device`) left them;
- `cudnn-default`: `cudnn.deterministic = False`, `cudnn.benchmark =
  False` (torch's defaults);
- `deterministic`: `cudnn.deterministic = True`, `cudnn.benchmark = False`,

and then steps the rounds itself (the same round body and noise stream
as `run_rounds`, without its `resolve_device`, which would set the
switches again):

1. reafl_lupa seed 2 and rewafl seed 0, 6 rounds each, twice: are the
   two histories (loss, energy, latency, masks) and final carries
   (params, FleetState) bitwise equal? Each run's digest is compared
   across the mode's workers too;
2. from reafl_lupa seed 2's carry before each round r, one round of the
   18-cell grid (the six methods x seeds 0-2, every cell given that
   carry, seed 2's data and round r's noise, the traced-method round
   `torch.func.vmap`ped as `run_campaign_grid` runs it), twice: cell
   reafl_lupa/2's loss, energy and latency (relative) and params (max
   abs) against the single's round r, its mask against the single's,
   and whether the two grid rounds agree bitwise;
3. the same for the six-seed rewafl batch (`run_campaign_batch`'s
   round: the MethodSpec's round vmapped over 6 cells) on rewafl seed
   0's carry.

Prints a line a worker and check, the verdicts across workers, and the
card's name and power limit; writes it all as JSON to `--out` (by
default `build/c5_repeat.json`, git-ignored). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S, K, ROUNDS, GRID_SEEDS = 100, 20, 6, (0, 1, 2)
FL_FLEET = dict(init_energy_mean=0.11, init_energy_std=0.04, e0_frac=0.08)
FLOATS = ("global_loss", "round_energy", "round_latency")


def worker(mode: str, device: str = "cuda", S: int = S, K: int = K,
           small: bool = False) -> dict:
    import numpy as np
    import torch
    from torch.func import vmap

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.common import batch_axes, resolve_device, tree_map
    from repro_torch.core.methods import METHODS, method_params_batch
    from repro_torch.core.round import (FLConfig, _build_round_body, draw_noise,
                                        make_round_body)
    from repro_torch.core.state import init_fleet_state
    from repro_torch.launch.fl_run import build_task
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import init_env_state
    from repro_torch.training.checkpoint import tree_digest

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    cfg = FLConfig(n_select=K)
    model = make_fl_model("cnn@mnist", small=small)
    data = {}
    for seed in (0, 2):
        fleet = build_fleet(S, seed=seed, device=dev, **FL_FLEET)
        cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=64, seed=seed, device=dev)
        data[seed] = (fleet, cx, cy)
    if mode != "port":
        torch.backends.cudnn.deterministic = mode == "deterministic"
        torch.backends.cudnn.benchmark = False
    switches = {"cudnn.deterministic": torch.backends.cudnn.deterministic,
                "cudnn.benchmark": torch.backends.cudnn.benchmark,
                "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    def campaign(method: str, seed: int):
        """Each round's (carry before, noise, metrics, carry after)."""
        fleet, cx, cy = data[seed]
        spec = METHODS[method]
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 2))
        state = init_fleet_state(fleet, H0=cfg.policy.H0)
        env = init_env_state(fleet, None, None)
        body = make_round_body(model, cfg, spec, None)
        H = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        rounds = []
        for r in range(ROUNDS):
            n = draw_noise(gen, S, K, H, cfg.batch_size, cx.shape[1])
            before = (params, state, env)
            params, state, env, m = body(params, state, env, fleet, cx, cy, n, r)
            rounds.append((before, n, m, (params, state)))
        sync()
        return rounds

    def host(rounds):
        hist = {k: np.stack([m[k].cpu().numpy() for _, _, m, _ in rounds])
                for k in FLOATS + ("selected",)}
        return hist, tree_digest({"history": hist, "carry": rounds[-1][3]})

    out = {"mode": mode, "switches": switches, "repeat": {}, "grid": [], "batch": []}
    single = {}
    for method, seed in (("reafl_lupa", 2), ("rewafl", 0)):
        a, b = campaign(method, seed), campaign(method, seed)
        (ha, da), (hb, db) = host(a), host(b)
        first = next((r for r in range(ROUNDS)
                      if any(not np.array_equal(ha[k][r], hb[k][r]) for k in ha)), None)
        out["repeat"][f"{method}/{seed}"] = dict(
            equal=da == db, digests=[da, db], first_round_apart=first,
            max_abs_loss=float(np.abs(ha["global_loss"] - hb["global_loss"]).max()))
        single[method] = a

    def cells_round(body, mp, carry, seed, n, r, C):
        """One round of `body` vmapped over C cells that all hold `carry`
        and seed's data."""
        fleet, cx, cy = data[seed]
        tile = lambda t: tree_map(lambda x: x.unsqueeze(0).expand(  # noqa: E731
            (C,) + x.shape).contiguous(), t)
        p, s, e = tile(carry)
        f, x, y, nn = tile(fleet), tile(cx), tile(cy), tile(n)

        def fn(mp, p, s, e, f, x, y, nn):
            p, s, _, e, m = body(mp, p, s, None, e, f, x, y, nn, r)
            return p, s, m

        dims = (None if mp is None else 0, 0, 0, 0, 0, 0, 0, batch_axes(nn))
        out = vmap(fn, in_dims=dims)(mp, p, s, e, f, x, y, nn)
        sync()
        return out

    names = list(METHODS)
    specs = [METHODS[m] for m in names]
    B = len(GRID_SEEDS)
    mp = method_params_batch(specs, alpha=cfg.alpha, beta=cfg.beta,
                             autofl_eta=cfg.autofl_eta, autofl_ema=cfg.autofl_ema,
                             fault_cfg=None, device=dev)
    mp = tree_map(lambda x: x.repeat_interleave(B, 0), mp)
    checks = (("grid", _build_round_body(model, cfg, None, None, None), mp, "reafl_lupa", 2,
               len(names) * B, names.index("reafl_lupa") * B + 2),
              ("batch", _build_round_body(model, cfg, METHODS["rewafl"], None, None), None,
               "rewafl", 0, 6, 0))
    for name, body, mpc, method, seed, C, i in checks:
        for r, (before, n, m, after) in enumerate(single[method]):
            p1, s1, m1 = cells_round(body, mpc, before, seed, n, r, C)
            p2, _, m2 = cells_round(body, mpc, before, seed, n, r, C)
            row = {"round": r,
                   "mask_equal": bool(torch.equal(m1["selected"][i], m["selected"])),
                   "repeat_bitwise": all(torch.equal(m1[k], m2[k]) for k in m1)
                   and all(torch.equal(p1[k], p2[k]) for k in p1),
                   "params_max_abs": max(float((p1[k][i] - after[0][k]).abs().max())
                                         for k in p1),
                   "residual_energy_max_rel": float(
                       ((s1.residual_energy[i] - after[1].residual_energy).abs()
                        / after[1].residual_energy.abs().clamp_min(1e-30)).max())}
            for k in FLOATS:
                a, b = float(m1[k][i]), float(m[k])
                row[k + "_rel"] = abs(a - b) / max(abs(b), 1e-30)
            out[name].append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--modes", default="port,cudnn-default,deterministic")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "c5_repeat.json"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    # a CPU rehearsal of one worker at S 10, K 4 with the reduced CNN
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        kw = dict(device="cpu", S=10, K=4, small=True) if args.rehearse else {}
        print(json.dumps(worker(args.worker, **kw)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("c5_repeat: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    _build.build_all(("rewafl_select", "fedavg", "stat_util"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    results = []
    for mode in args.modes.split(","):
        runs = []
        for w in range(args.procs):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", mode],
                               capture_output=True, text=True)
            if p.returncode != 0:
                sys.exit(f"worker {mode} {w} failed:\n{p.stderr[-4000:]}")
            res = json.loads(p.stdout.strip().splitlines()[-1])
            runs.append(res)
            print(f"{mode} worker {w}: switches {res['switches']}", flush=True)
            for k, v in res["repeat"].items():
                print(f"  1. {k} run twice: {'bitwise equal' if v['equal'] else 'DIFFERENT'}"
                      f" (first round apart {v['first_round_apart']}, loss max |diff| "
                      f"{v['max_abs_loss']:.3e}); digests {v['digests'][0][:16]} "
                      f"{v['digests'][1][:16]}", flush=True)
            for name in ("grid", "batch"):
                for row in res[name]:
                    print(f"  {2 if name == 'grid' else 3}. {name} r{row['round']}: mask "
                          f"{'equal' if row['mask_equal'] else 'DIFFERENT'}, repeat "
                          f"{'bitwise' if row['repeat_bitwise'] else 'DIFFERENT'}, loss rel "
                          f"{row['global_loss_rel']:.3e}, energy rel "
                          f"{row['round_energy_rel']:.3e}, latency rel "
                          f"{row['round_latency_rel']:.3e}, params max |diff| "
                          f"{row['params_max_abs']:.3e}, residual energy max rel "
                          f"{row['residual_energy_max_rel']:.3e}", flush=True)
        across = {k: len({d for r in runs for d in r["repeat"][k]["digests"]}) == 1
                  for k in runs[0]["repeat"]}
        worst = {name: {k: max(row[k] for r in runs for row in r[name])
                        for k in ("global_loss_rel", "round_energy_rel",
                                  "round_latency_rel", "params_max_abs")}
                 for name in ("grid", "batch")}
        print(f"{mode}: every run of a campaign bitwise equal across the {args.procs} workers: "
              f"{across}; worst cell-vs-single round gaps {json.dumps(worst)}", flush=True)
        results.append(dict(mode=mode, runs=runs, same_across_workers=across, worst=worst))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "results": results}, f, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
