"""How far the port and the reference part over 8 rounds, on the CPU.

    PYTHONPATH=src python -m tests.torch_parity_survey [--seeds 4]

Not a test (pytest does not collect it): a survey behind the choices of
`tests/test_torch_dynamics.py`. It prints

1. for each scenario (static-paper and the four fault-free dynamic ones),
   seed and method (rewafl, random), `run_rounds` of both packages at the
   engine tests' size (S 10, K 4, 8 rounds in chunks of 4, the
   reference's draws handed to the port): whether the selections match,
   the first round they do not, and the largest relative difference in
   global loss; then how many runs ended more than 1e-4 apart and how
   many selected differently;
2. the share of night weights (`sim.dynamics.diurnal.night_weight`, the
   one step of the environment through `cos`) that are bitwise equal
   between the two, over 10⁶ random hours, and the largest difference;
3. the operators one environment step issues at S 100 (torch.profiler,
   CPU: a count of the program's ops, not a time).
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import torch

from repro.sim.dynamics import diurnal as jdiurnal
from repro_torch.core.state import init_fleet_state
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import SCENARIOS, diurnal, init_env_state, step_env
from tests.test_torch_engine import _run_both

SCENARIO_NAMES = ("static-paper", "commuter-diurnal", "congested-urban",
                  "overnight-charging", "churn-heavy")


def survey_runs(seeds: int) -> None:
    n_apart = n_sel = n = 0
    for sc in SCENARIO_NAMES:
        for seed in range(seeds):
            for method in ("rewafl", "random"):
                got, want = _run_both("cnn@mnist", method, 8, 4, seed=seed, scenario=sc)
                bad = np.nonzero((got.history["selected"]
                                  != np.asarray(want.history["selected"])).any(1))[0]
                gl, jgl = got.history["global_loss"], np.asarray(want.history["global_loss"])
                rel = float(np.max(np.abs(gl - jgl) / np.abs(jgl)))
                n += 1
                n_apart += rel > 1e-4
                n_sel += len(bad) > 0
                print(f"{sc} seed {seed} {method}: selections "
                      f"{'equal' if not len(bad) else f'differ from round {bad[0]}'}, "
                      f"global loss apart {rel:.3g}", flush=True)
    print(f"{n} runs: {n_apart} ended more than 1e-4 apart in global loss, "
          f"{n_sel} selected differently")


def survey_night_weight() -> None:
    tod = np.random.RandomState(0).uniform(0, 24, 1_000_000).astype(np.float32)
    want = np.asarray(jax.jit(jdiurnal.night_weight)(tod))
    got = diurnal.night_weight(torch.from_numpy(tod)).numpy()
    print(f"night_weight over 10^6 hours: {np.mean(got == want):.4f} bitwise equal, "
          f"largest difference {np.max(np.abs(got - want)):.3g}")


def count_step_ops(S: int = 100) -> None:
    fleet = build_fleet(S, seed=0, device="cpu")
    state = init_fleet_state(fleet)
    for name, sc in SCENARIOS.items():
        if sc.static or sc.faults.enabled:
            continue
        env = init_env_state(fleet, sc, torch.rand(4, S, generator=torch.Generator().manual_seed(0)))
        u = torch.rand(3, S, generator=torch.Generator().manual_seed(1))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step_env(sc, fleet, env, state, 3600, u, 16e6)
        ops = [e for e in prof.events() if e.name.startswith("aten::")
               and e.cpu_parent is None]
        print(f"step_env {name}: {len(ops)} top-level aten ops at S {S}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    count_step_ops()
    survey_night_weight()
    survey_runs(args.seeds)


if __name__ == "__main__":
    main()
