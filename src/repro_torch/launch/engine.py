"""Chunked multi-round FL driver.

`run_rounds` runs rounds back to back on the device and touches the host
only at chunk boundaries: each round's metrics stay on the device, and a
chunk's dense history (per-round scalars plus the per-device `selected`
and `H` traces) is stacked and copied to the host once, after the chunk.
Accuracy (and so the early stop) is evaluated only there, as in
`repro.launch.engine.run_rounds` — a campaign overshoots its target by
at most chunk_size − 1 rounds.

Each round's random numbers come from one `torch.Generator` on the
device seeded from `seed`, or from `noise_fn(round_idx)` when given
(the parity tests hand the port the reference's draws that way).

`scenario` picks the fleet dynamics (None ≡ static-paper). A dynamic
scenario's environment is carried across rounds and chunks; without an
`env` argument its initial draws come from a generator of their own,
seeded `seed + ENV_SEED_OFFSET`, so the rounds' stream does not move —
the reference folds them from its loop key the same way.

`async_cfg` switches to FedBuff-style buffered aggregation
(`core.async_agg`): the pending-update buffer and virtual clock
(`AsyncState`) start empty and are carried across rounds and chunks, and
come back in `EngineResult.async_state`.

`telemetry=TelemetryCfg(mode="streaming")` folds every round's metrics
dict, per-device leaves included, into the reducers of `core.metrics` on
the device before those leaves are dropped: the history then holds the
per-round scalars only, and `EngineResult.telemetry` the reducers'
outputs, drained once at the end. The carry is built from the first
round's metrics dict, on the run's device. `health=HealthCfg(...)`
samples the fleet-health monitors (`obs.health`) at every chunk
boundary after the eval and reports in `EngineResult.health`; with
streaming on, their staleness and energy quantiles come from reducers
added to the specs before the carry is built.

The phases run under spans of the global tracer (`obs.trace`): `chunk`
(index, rounds, start) around each chunk, within it `dispatch` (the
round loop: issue only, the card runs behind), `history_drain` (the
chunk's stack-and-copy to the host, which waits for the card), `eval`
and `health`; `transfer` around the end's history concatenation and
telemetry drain. A first chunk that builds the kernels with nvcc is
still called `dispatch`: the build falls inside it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.async_agg import AsyncCfg
from repro_torch.core.methods import MethodSpec
from repro_torch.core.metrics import (DENSE_PER_DEVICE, PER_DEVICE_METRICS,
                                      TelemetryCfg, finalize_telemetry,
                                      init_telemetry, update_telemetry)
from repro_torch.core.round import (FLConfig, RoundNoise, draw_noise,
                                    make_async_round_body, make_round_body)
from repro_torch.core.state import (AsyncState, FleetState, init_async_state,
                                    init_fleet_state)
from repro_torch.models.fl_models import FLModel, Params
from repro_torch.obs.health import (HealthCfg, HealthReport, chunk_sample,
                                    finalize_report, with_health_specs)
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import span
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.dynamics import EnvState, Scenario, init_env_state

log = get_logger(__name__)

# the initial environment's generator seed, past the rounds' (the
# reference's side-channel salt for the same draw)
ENV_SEED_OFFSET = 0x0d1f


@dataclasses.dataclass
class EngineResult:
    params: Params
    state: FleetState
    history: Dict[str, np.ndarray]   # per-round arrays, length rounds_run
    rounds_run: int
    reached_round: Optional[int]     # first chunk-boundary round ≥ target
    acc_curve: np.ndarray            # one accuracy per completed chunk
    # per-chunk host wall clock (each ends in the history copy, which
    # waits for the chunk) + rounds per chunk
    chunk_wall_s: Optional[np.ndarray] = None
    chunk_rounds: Optional[np.ndarray] = None
    env: Optional[EnvState] = None   # final environment state
    async_state: Optional[AsyncState] = None   # final buffer (async runs)
    # streaming telemetry only: the reducers' outputs on the host
    # (`tel/<metric>/<reducer>` -> (S,) aggregates; see core.metrics)
    telemetry: Optional[Dict[str, np.ndarray]] = None
    # the fleet-health verdict (obs.health) when `health` was given
    health: Optional[HealthReport] = None


def run_rounds(model: FLModel, fleet: DeviceFleet, cx: torch.Tensor,
               cy: torch.Tensor, cfg: FLConfig, method: MethodSpec, *,
               rounds: int, seed: int = 0, params: Optional[Params] = None,
               state: Optional[FleetState] = None, chunk_size: int = 8,
               eval_fn: Optional[Callable] = None,
               target_acc: Optional[float] = None,
               noise_fn: Optional[Callable[[int], RoundNoise]] = None,
               scenario: Optional[Scenario] = None,
               env: Optional[EnvState] = None,
               async_cfg: Optional[AsyncCfg] = None,
               telemetry: TelemetryCfg = TelemetryCfg(),
               health: Optional[HealthCfg] = None,
               device="cuda") -> EngineResult:
    """Run up to `rounds` rounds in chunks of `chunk_size`, early-stopping
    on `target_acc` (needs `eval_fn`) at chunk boundaries, under
    `scenario`'s fleet dynamics from `env`, sync or (`async_cfg`) async,
    with dense or streaming `telemetry` and, given `health`, the
    fleet-health monitors. Every tensor argument must already be on
    `device`."""
    dev = resolve_device(device)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    for name, x in (("fleet", fleet.type_id), ("cx", cx), ("cy", cy)):
        if x.device.type != dev.type:
            raise ValueError(f"{name} is on {x.device}, the run on {dev}")
    S, n = cx.shape[0], cx.shape[1]
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if state is None:
        state = init_fleet_state(fleet, H0=cfg.policy.H0)
    dyn = scenario is not None and scenario.dynamic
    faults = scenario is not None and scenario.faults.enabled
    jitter = async_cfg is not None and async_cfg.delay_jitter > 0.0
    astate = None
    if async_cfg is None:
        body = make_round_body(model, cfg, method, scenario)
    else:
        body = make_async_round_body(model, cfg, method, scenario, async_cfg)
        astate = init_async_state(model.layout.flatten(params), S,
                                  async_cfg.slots(cfg.n_select))
    if env is None:
        u = None
        if dyn:
            env_gen = torch.Generator(device=dev).manual_seed(seed + ENV_SEED_OFFSET)
            u = torch.rand(4, S, generator=env_gen, device=dev)
        env = init_env_state(fleet, scenario, u)
    H_max = cfg.policy.H0 if method.policy == "fixed" else cfg.policy.H_max
    gen = torch.Generator(device=dev).manual_seed(seed)

    def noise(r: int) -> RoundNoise:
        if noise_fn is not None:
            return noise_fn(r)
        return draw_noise(gen, S, cfg.n_select, H_max, cfg.batch_size, n, dyn,
                          faults, jitter)

    tcfg, streaming = telemetry, telemetry.streaming
    if health is not None and streaming:
        # the monitors read the run's staleness / energy tails off
        # streaming quantile reducers: declare them before the carry
        tcfg = with_health_specs(tcfg, health, rounds, fleet)
    # dense history keeps `selected` and `H` as (R, S) traces; streaming
    # keeps no per-device leaf (the reducers folded them)
    drop = set(PER_DEVICE_METRICS) - (set() if streaming else set(DENSE_PER_DEVICE))
    tel = None

    host: Dict[str, List[np.ndarray]] = {}
    acc_curve: List[float] = []
    chunk_wall: List[float] = []
    chunk_len: List[int] = []
    health_samples: List[Dict[str, float]] = []
    health_warnings: List[str] = []
    reached = None
    done = 0
    ci = 0
    while done < rounds:
        length = min(chunk_size, rounds - done)
        t0 = time.time()
        with span("chunk", ci, rounds=length, start=done):
            ms = []
            with span("dispatch", ci):
                for r in range(done, done + length):
                    if astate is None:
                        params, state, env, m = body(params, state, env, fleet,
                                                     cx, cy, noise(r), r)
                    else:
                        params, state, astate, env, m = body(
                            params, state, astate, env, fleet, cx, cy, noise(r), r)
                    if streaming:
                        if tel is None:
                            tel = init_telemetry(tcfg, m)
                        tel = update_telemetry(tcfg, tel, m, r)
                    ms.append({k: v for k, v in m.items() if k not in drop})
            with span("history_drain", ci):   # one copy per key per chunk
                for k in ms[0]:
                    host.setdefault(k, []).append(
                        torch.stack([m[k] for m in ms]).cpu().numpy())
            done += length
            chunk_len.append(length)
            stop = False
            if eval_fn is not None:
                with span("eval", ci):
                    acc = float(eval_fn(params))
                acc_curve.append(acc)
                if target_acc is not None and acc >= target_acc:
                    reached = done - 1
                    stop = True
            if health is not None:   # a host sync, like the eval
                with span("health", ci):
                    sample, warns = chunk_sample(health, state, fleet, done - 1)
                health_samples.append(sample)
                for w in warns:
                    log.warning(w)
                health_warnings.extend(warns)
        chunk_wall.append(time.time() - t0)
        ci += 1
        if stop:
            break
    t0 = time.time()
    with span("transfer"):
        history = {k: np.concatenate(v) for k, v in host.items()}
        telemetry_out = None
        if tel is not None:          # one O(S) drain for the whole run
            telemetry_out = {k: v.cpu().numpy()
                             for k, v in finalize_telemetry(tcfg, tel).items()}
    if chunk_wall:
        chunk_wall[-1] += time.time() - t0
    report = None
    if health is not None:
        report = finalize_report(health, health_samples, health_warnings,
                                 state=state, fleet=fleet,
                                 telemetry=telemetry_out, rounds_run=done,
                                 history=history)
    return EngineResult(params=params, state=state, history=history,
                        rounds_run=done, reached_round=reached,
                        acc_curve=np.asarray(acc_curve, np.float64),
                        chunk_wall_s=np.asarray(chunk_wall, np.float64),
                        chunk_rounds=np.asarray(chunk_len, np.int64),
                        env=env, async_state=astate,
                        telemetry=telemetry_out, health=report)
