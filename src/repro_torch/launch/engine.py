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

`run_loop` is the reference's per-round driver (`run_fl(engine="loop")`):
one round a step, its scalars on the host after each, the early stop at
`eval_every` granularity. `run_campaign_batch` (one method over seeds)
and `run_campaign_grid` (a (method × seed) grid) run many campaigns in
one call: the round body `torch.func.vmap`ped over a cell axis, each op
issued once for all cells, each FL kernel launched once a round for all
of them (its op's vmap rule launches the kernel over the cell axis).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import vmap

from repro_torch.common import batch_axes, resolve_device, tree_map, tree_stack
from repro_torch.core.async_agg import AsyncCfg
from repro_torch.core.methods import MethodSpec, batchable, method_params_batch
from repro_torch.core.metrics import (DENSE_PER_DEVICE, PER_DEVICE_METRICS,
                                      TelemetryCfg, finalize_telemetry,
                                      init_telemetry, update_telemetry)
from repro_torch.core.round import (FLConfig, RoundNoise, _build_round_body,
                                    draw_noise, make_async_round_body,
                                    make_round_body)
from repro_torch.core.state import (AsyncState, FleetState, init_async_state,
                                    init_fleet_state, replicate_state)
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


def run_loop(model: FLModel, fleet: DeviceFleet, cx: torch.Tensor,
             cy: torch.Tensor, cfg: FLConfig, method: MethodSpec, *,
             rounds: int, seed: int = 0, params: Optional[Params] = None,
             eval_fn: Optional[Callable] = None, eval_every: int = 5,
             target_acc: Optional[float] = None,
             noise_fn: Optional[Callable[[int], RoundNoise]] = None,
             scenario: Optional[Scenario] = None, env: Optional[EnvState] = None,
             on_eval: Optional[Callable] = None,
             device="cuda") -> EngineResult:
    """The reference's per-round loop (`run_fl(engine="loop")`): one
    round a step, its scalars copied to the host after every round, the
    model evaluated at `round % eval_every == 0` and at the last round,
    stopping at the first evaluation at or above `target_acc`. Same
    round body, seeds and noise stream as `run_rounds`, so the two agree
    on every round both run. The history holds the per-round scalars
    and the (R, S) `selected` and `H` traces; `on_eval(round, acc,
    metrics)` is called at each evaluation. Sync, dense, static or
    dynamic scenarios only: the buffered, streaming and health modes
    live in `run_rounds`."""
    dev = resolve_device(device)
    S, n = cx.shape[0], cx.shape[1]
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    state = init_fleet_state(fleet, H0=cfg.policy.H0)
    dyn = scenario is not None and scenario.dynamic
    faults = scenario is not None and scenario.faults.enabled
    if env is None:
        u = None
        if dyn:
            env_gen = torch.Generator(device=dev).manual_seed(seed + ENV_SEED_OFFSET)
            u = torch.rand(4, S, generator=env_gen, device=dev)
        env = init_env_state(fleet, scenario, u)
    body = make_round_body(model, cfg, method, scenario)
    H_max = cfg.policy.H0 if method.policy == "fixed" else cfg.policy.H_max
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: List[Dict[str, np.ndarray]] = []
    acc_curve: List[float] = []
    reached = None
    for r in range(rounds):
        noise = (noise_fn(r) if noise_fn is not None else
                 draw_noise(gen, S, cfg.n_select, H_max, cfg.batch_size, n, dyn,
                            faults))
        params, state, env, m = body(params, state, env, fleet, cx, cy, noise, r)
        rows.append({k: v.cpu().numpy() for k, v in m.items()
                     if k not in PER_DEVICE_METRICS or k in DENSE_PER_DEVICE})
        if eval_fn is not None and (r % eval_every == 0 or r == rounds - 1):
            acc = float(eval_fn(params))
            acc_curve.append(acc)
            if on_eval is not None:
                on_eval(r, acc, rows[-1])
            if target_acc is not None and acc >= target_acc:
                reached = r
                break
    history = {k: np.stack([row[k] for row in rows]) for k in rows[0]} if rows else {}
    return EngineResult(params=params, state=state, history=history,
                        rounds_run=len(rows), reached_round=reached,
                        acc_curve=np.asarray(acc_curve, np.float64), env=env)


# ------------------------------------------------------- campaign batching
#
# A campaign batch is C independent campaigns ("cells") run side by side:
# every round is the round body `torch.func.vmap`ped over the cell axis,
# so each of the round's ops is issued once for all cells, and the
# `fedavg` and `stat_util` kernels (and `rewafl_select` on the per-method
# path) launch once a round for all of them through their ops' vmap
# rules. Each cell draws its own round noise from its own generator.

def _cell(tree, i: int = 0):
    return tree_map(lambda x: x[i], tree)


def _np(x) -> np.ndarray:
    """An eval result (tensor on any device, or array-like) as f64."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def _campaign_init(model: FLModel, fleet: DeviceFleet, cfg: FLConfig,
                   seeds: Sequence[int], scenario: Optional[Scenario],
                   per_seed_fleets: bool, dev: torch.device,
                   params: Optional[Params] = None, env: Optional[EnvState] = None):
    """Per-seed (B, ...)-leaf init params, FleetState and EnvState of a
    campaign batch, with `run_fl`'s seed offsets: the model init from
    `seed + 2`, a dynamic scenario's initial environment from `seed + 3`
    (and the round noise, drawn by the caller, from `seed + 1`), so with
    per-seed fleets seed j's cells reproduce `run_fl(seed=j)`'s draws.
    The caller's `params` / `env` replace the drawn ones where given."""
    B = len(seeds)
    S = fleet.type_id.shape[-1]
    dyn = scenario is not None and scenario.dynamic
    fleets = [_cell(fleet, b) for b in range(B)] if per_seed_fleets else [fleet] * B
    if params is None:
        params = tree_stack([model.init(torch.Generator(device=dev).manual_seed(s + 2))
                             for s in seeds])
    state = tree_stack([init_fleet_state(f, H0=cfg.policy.H0) for f in fleets])
    if env is None:
        envs = []
        for s, f in zip(seeds, fleets):
            u = None
            if dyn:
                gen = torch.Generator(device=dev).manual_seed(s + 3)
                u = torch.rand(4, S, generator=gen, device=dev)
            envs.append(init_env_state(f, scenario, u))
        env = tree_stack(envs)
    return params, state, env


def _run_cells(body, *, mp, params, state, astate, env, fleet, cx, cy,
               data_batched: bool, noise, rounds: int, chunk_size: int,
               collect_per_device: bool, tcfg: Optional[TelemetryCfg],
               eval_fn: Optional[Callable], target_acc: Optional[float],
               groups: int, dev: torch.device,
               **span_args) -> List[Dict[str, np.ndarray]]:
    """Run `rounds` rounds of `body` (a `core.round._build_round_body`
    round) vmapped over the cell axis of `params` / `state` / `astate` /
    `env` (and of `mp`, the fleet and the data when given batched), in
    chunks of `chunk_size`; `noise(r)` gives round r's (C, ...) noise.
    The C cells are `groups` consecutive batches of B = C / groups (a
    grid's methods); `eval_fn(params of one batch) -> (B,)` runs for each
    at every chunk boundary, never stopping early. Returns each batch's
    history as `run_campaign_batch` documents it, its wall time the
    batch's share of the chunks'."""
    C = state.residual_energy.shape[0]
    B = C // groups
    streaming = tcfg is not None
    drop = set(PER_DEVICE_METRICS)
    if collect_per_device and not streaming:
        drop -= set(DENSE_PER_DEVICE)
    ax = 0 if data_batched else None

    def vround(r: int, mp, p, s, a, e, f, x, y, n):
        def fn(mp, p, s, a, e, f, x, y, n):
            p, s, a, e, m = body(mp, p, s, a, e, f, x, y, n, r)
            return (p, s, e, m) if a is None else (p, s, a, e, m)

        dims = (None if mp is None else 0, 0, 0, None if a is None else 0, 0,
                ax, ax, ax, batch_axes(n))
        out = vmap(fn, in_dims=dims)(mp, p, s, a, e, f, x, y, n)
        if a is None:
            p, s, e, m = out
        else:
            p, s, a, e, m = out
        return p, s, a, e, m

    tel = None
    host: Dict[str, List[np.ndarray]] = {}
    accs: List[np.ndarray] = []
    chunk_wall: List[float] = []
    chunk_len: List[int] = []
    reached = np.full((groups, B), -1, np.int64)
    done = ci = 0
    while done < rounds:
        length = min(chunk_size, rounds - done)
        t0 = time.time()
        with span("chunk", ci, rounds=length, start=done, **span_args):
            ms = []
            with span("dispatch", ci):
                for r in range(done, done + length):
                    params, state, astate, env, m = vround(
                        r, mp, params, state, astate, env, fleet, cx, cy, noise(r))
                    if streaming:
                        if tel is None:
                            tel = replicate_state(init_telemetry(tcfg, _cell(m)), C)
                        tel = vmap(lambda t, mm: update_telemetry(tcfg, t, mm, r))(tel, m)
                    ms.append({k: v for k, v in m.items() if k not in drop})
            with span("history_drain", ci):   # one copy per key per chunk
                for k in ms[0]:
                    host.setdefault(k, []).append(
                        torch.stack([m[k] for m in ms], 1).cpu().numpy())
            done += length
            chunk_len.append(length)
            if eval_fn is not None:
                with span("eval", ci):
                    acc = np.stack([_np(eval_fn(tree_map(
                        lambda x: x[g * B:(g + 1) * B], params))) for g in range(groups)])
                accs.append(acc)
                if target_acc is not None:
                    reached[(acc >= target_acc) & (reached < 0)] = done - 1
        chunk_wall.append(time.time() - t0)
        ci += 1
    t0 = time.time()
    with span("transfer"):
        history = {k: np.concatenate(v, 1) for k, v in host.items()}
        if rounds == 0:
            # every key with a zero-length round axis: the metrics' shapes
            # from one round of the body on fake tensors (shapes without
            # data: no kernel and no op runs)
            n0 = noise(0)
            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                fake = lambda t: tree_map(mode.from_tensor, t)  # noqa: E731
                m = vround(0, fake(mp), fake(params), fake(state), fake(astate),
                           fake(env), fake(fleet), fake(cx), fake(cy), fake(n0))[-1]
            history = {k: np.zeros((C, 0) + tuple(v.shape[1:]),
                                   torch.empty((), dtype=v.dtype).numpy().dtype)
                       for k, v in m.items() if k not in drop}
            if streaming:
                tel = replicate_state(init_telemetry(tcfg, {
                    k: torch.empty(v.shape[1:], dtype=v.dtype, device=dev)
                    for k, v in m.items()}), C)
        if streaming:                # one O(S) drain for the whole run
            history.update({k: v.cpu().numpy()
                            for k, v in finalize_telemetry(tcfg, tel).items()})
        history["final_residual_energy"] = state.residual_energy.cpu().numpy()
        history["final_H"] = state.H.cpu().numpy()
        if astate is not None:
            history["final_wall_clock"] = astate.t_now.cpu().numpy()
    if chunk_wall:
        chunk_wall[-1] += time.time() - t0
    wall = np.asarray(chunk_wall, np.float64) / groups
    accs = np.stack(accs) if accs else np.zeros((0, groups, B))
    out = []
    for g in range(groups):
        h = {k: v[g * B:(g + 1) * B] for k, v in history.items()}
        h.update(chunk_wall_s=wall, chunk_rounds=np.asarray(chunk_len, np.int64),
                 compile_s=np.float64(0.0))
        if eval_fn is not None:
            h["acc_curve"] = accs[:, g]
            if target_acc is not None:
                h["reached_round"] = reached[g]
        out.append(h)
    return out


def _cell_noise(gens, cell_H: Sequence[int], H_run: int, S: int, K: int,
                B: int, n: int, dyn: bool, faults: bool, jitter: bool,
                noise_fn: Optional[Callable[[int, int], RoundNoise]]):
    """noise(r) -> round r's (C, ...) RoundNoise: cell c's from
    `noise_fn(c, r)` when given, else drawn on its own generator with its
    method's local-step count `cell_H[c]` (what a single run of that
    method draws), its minibatch indices zero-padded (or cut) to the
    batch's loop bound `H_run` (steps past a cell's H are masked
    no-ops)."""
    def pad(x: RoundNoise) -> RoundNoise:
        h = x.batch_idx.shape[1]
        if h >= H_run:   # a longer draw (noise_fn's) is cut to the bound
            return x._replace(batch_idx=x.batch_idx[:, :H_run])
        return x._replace(batch_idx=torch.cat(
            [x.batch_idx, x.batch_idx.new_zeros(K, H_run - h, B)], 1))

    def noise(r: int) -> RoundNoise:
        if noise_fn is not None:
            cells = [noise_fn(c, r) for c in range(len(cell_H))]
        else:
            cells = [draw_noise(g, S, K, h, B, n, dyn, faults, jitter)
                     for g, h in zip(gens, cell_H)]
        return tree_stack([pad(x) for x in cells])

    return noise


def _check_data(fleet, cx, cy, dev, per_seed_fleets: bool, B: int):
    for name, x in (("fleet", fleet.type_id), ("cx", cx), ("cy", cy)):
        if x.device.type != dev.type:
            raise ValueError(f"{name} is on {x.device}, the run on {dev}")
    if per_seed_fleets and (fleet.type_id.dim() != 2 or fleet.type_id.shape[0] != B
                            or cx.shape[0] != B or cy.shape[0] != B):
        raise ValueError(f"per_seed_fleets: fleet, cx and cy need a leading "
                         f"seed axis of {B} (sim.devices.build_fleet_batch, "
                         "launch.fl_run.build_task_batch)")


def run_campaign_batch(model: FLModel, fleet: DeviceFleet, cx: torch.Tensor,
                       cy: torch.Tensor, cfg: FLConfig, method: MethodSpec, *,
                       seeds: Sequence[int], rounds: int, chunk_size: int = 8,
                       collect_per_device: bool = False,
                       scenario: Optional[Scenario] = None,
                       per_seed_fleets: bool = False,
                       eval_fn: Optional[Callable] = None,
                       target_acc: Optional[float] = None,
                       telemetry: Optional[TelemetryCfg] = None,
                       async_cfg: Optional[AsyncCfg] = None,
                       noise_fn: Optional[Callable[[int, int], RoundNoise]] = None,
                       params: Optional[Params] = None,
                       env: Optional[EnvState] = None,
                       device="cuda") -> Dict[str, np.ndarray]:
    """One method's campaigns over the seed axis, as one vmapped round a
    round: the static MethodSpec's round body (its selector's kernel
    included: a `rea` method's selections run as one batched
    `rewafl_select` launch), seed j's params, state, environment and
    round noise from `run_fl(seed=seeds[j])`'s seeds.

    `per_seed_fleets=False`: one shared fleet and dataset. True: fleet,
    cx and cy carry a leading seed axis of len(seeds)
    (`sim.devices.build_fleet_batch`, `launch.fl_run.build_task_batch`)
    and seed j runs on its own, reproducing `run_fl(seed=seeds[j])`.
    `async_cfg` (or an async `method`, whose `buffer_m` sets one) runs
    the buffered round; a streaming `telemetry` folds its reducers per
    seed and merges the drained `tel/...` outputs as (B, ...) arrays.
    `eval_fn(params_batch) -> (B,)` (`core.round.make_batch_eval_fn`)
    runs at every chunk boundary, never stopping early; with
    `target_acc` the history gains `reached_round` (B,), the first
    chunk-end round a seed met it (-1: never). `noise_fn(seed_index,
    round)` replaces the drawn noise, and `params` / `env` ((B, ...)
    leaves) the drawn initial params and environment (to run the same
    campaigns on two devices, or on the reference's draws).

    Returns the history with leading axes (B, rounds), plus
    `final_residual_energy` / `final_H` (B, S), `final_wall_clock` (B,)
    when async, `chunk_wall_s` / `chunk_rounds` (n_chunks,), `compile_s`
    (0.0: the port compiles no program per chunk; the kernels' one-time
    nvcc build falls in the first chunk's wall) and `acc_curve`
    (n_chunks, B) with `eval_fn`."""
    dev = resolve_device(device)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    B = len(seeds)
    _check_data(fleet, cx, cy, dev, per_seed_fleets, B)
    if async_cfg is None and method.aggregation == "async":
        async_cfg = AsyncCfg(buffer_m=method.buffer_m)
    body = _build_round_body(model, cfg, method, scenario, async_cfg)
    params, state, env = _campaign_init(model, fleet, cfg, seeds, scenario,
                                        per_seed_fleets, dev, params, env)
    S, K = fleet.type_id.shape[-1], cfg.n_select
    astate = None
    if async_cfg is not None:
        astate = replicate_state(init_async_state(
            model.layout.flatten(_cell(params)), S, async_cfg.slots(K)), B)
    streaming = telemetry is not None and telemetry.streaming
    H = cfg.policy.H0 if method.policy == "fixed" else cfg.policy.H_max
    dyn = scenario is not None and scenario.dynamic
    faults = scenario is not None and scenario.faults.enabled
    jitter = async_cfg is not None and async_cfg.delay_jitter > 0.0
    n = cx.shape[2 if per_seed_fleets else 1]
    gens = [torch.Generator(device=dev).manual_seed(s + 1) for s in seeds]
    noise = _cell_noise(gens, [H] * B, H, S, K, cfg.batch_size, n, dyn, faults,
                        jitter, noise_fn)
    return _run_cells(
        body, mp=None, params=params, state=state, astate=astate, env=env,
        fleet=fleet, cx=cx, cy=cy, data_batched=per_seed_fleets, noise=noise,
        rounds=rounds, chunk_size=chunk_size,
        collect_per_device=collect_per_device,
        tcfg=telemetry if streaming else None, eval_fn=eval_fn,
        target_acc=target_acc, groups=1, dev=dev, seeds=B)[0]


def _run_grid_batched(model: FLModel, fleet: DeviceFleet, cx: torch.Tensor,
                      cy: torch.Tensor, cfg: FLConfig,
                      methods: Dict[str, MethodSpec], *, seeds: Sequence[int],
                      rounds: int, chunk_size: int, collect_per_device: bool,
                      scenario: Optional[Scenario], per_seed_fleets: bool,
                      eval_fn: Optional[Callable], target_acc: Optional[float],
                      telemetry: Optional[TelemetryCfg],
                      async_cfg: Optional[AsyncCfg],
                      noise_fn: Optional[Callable[[int, int], RoundNoise]],
                      params: Optional[Params], env: Optional[EnvState],
                      dev: torch.device) -> Dict[str, Dict[str, np.ndarray]]:
    """The (method × seed) grid as one cell axis of M·B cells,
    method-major (cell i·B+j runs method i on seed j), through the
    traced-method round (`core.round.make_round_body_mp`): each cell
    carries its method as MethodParams. With per-seed fleets each cell
    takes its seed's fleet and data (gathered once, before the rounds).
    Returns the per-method history dicts of `run_campaign_batch`, with
    `chunk_wall_s` and `compile_s` divided by M (each method's share)."""
    names = list(methods)
    M, B = len(names), len(seeds)
    C = M * B
    specs = [methods[n] for n in names]
    mp = method_params_batch(specs, alpha=cfg.alpha, beta=cfg.beta,
                             autofl_eta=cfg.autofl_eta,
                             autofl_ema=cfg.autofl_ema,
                             fault_cfg=scenario.faults if scenario is not None else None,
                             device=dev)
    if all(s.policy == "fixed" for s in specs):
        # the shared local-SGD bound covers every cell's method: an
        # all-fixed grid never exceeds H0 (a mixed one keeps H_max, and
        # its fixed cells take masked no-op steps past H0)
        cfg = dataclasses.replace(cfg, policy=dataclasses.replace(
            cfg.policy, H_max=cfg.policy.H0))
    K = cfg.n_select
    # a grid with any async cell runs the async round for every cell; a
    # sync cell rides it with buffer_m 0 (the full-cohort sentinel). The
    # buffer fits the largest trigger, the land count drains the smallest
    m_effs = [s.buffer_m if s.aggregation == "async" else K for s in specs]
    acfg = None
    if async_cfg is not None or any(s.aggregation == "async" for s in specs):
        base = async_cfg if async_cfg is not None else AsyncCfg(buffer_m=K)
        acfg = dataclasses.replace(base, capacity=max(max(m_effs), base.buffer_m) + K,
                                   n_lands=max(-(-K // m) for m in m_effs))
    body = _build_round_body(model, cfg, None, scenario, acfg)
    mp_cells = tree_map(lambda x: x.repeat_interleave(B, 0), mp)
    seed_idx = torch.arange(B, device=dev).repeat(M)
    params, state, env = _campaign_init(model, fleet, cfg, seeds, scenario,
                                        per_seed_fleets, dev, params, env)

    def tile(t):   # (B, ...) leaves to (M·B, ...) cells, method-major
        return tree_map(lambda x: x.repeat((M,) + (1,) * (x.dim() - 1)), t)

    params, state, env = tile(params), tile(state), tile(env)
    if per_seed_fleets:
        fleet = tree_map(lambda x: x[seed_idx], fleet)
        cx, cy = cx[seed_idx], cy[seed_idx]
    S = fleet.type_id.shape[-1]
    astate = None
    if acfg is not None:
        astate = replicate_state(init_async_state(
            model.layout.flatten(_cell(params)), S, acfg.slots(K)), C)
    streaming = telemetry is not None and telemetry.streaming
    H_run = cfg.policy.H_max
    cell_H = [cfg.policy.H0 if s.policy == "fixed" else H_run
              for s in specs for _ in range(B)]
    dyn = scenario is not None and scenario.dynamic
    faults = scenario is not None and scenario.faults.enabled
    jitter = acfg is not None and acfg.delay_jitter > 0.0
    n = cx.shape[2 if per_seed_fleets else 1]
    gens = [torch.Generator(device=dev).manual_seed(s + 1)
            for _ in range(M) for s in seeds]
    noise = _cell_noise(gens, cell_H, H_run, S, K, cfg.batch_size, n, dyn,
                        faults, jitter, noise_fn)

    return dict(zip(names, _run_cells(
        body, mp=mp_cells, params=params, state=state, astate=astate, env=env,
        fleet=fleet, cx=cx, cy=cy, data_batched=per_seed_fleets, noise=noise,
        rounds=rounds, chunk_size=chunk_size,
        collect_per_device=collect_per_device,
        tcfg=telemetry if streaming else None, eval_fn=eval_fn,
        target_acc=target_acc, groups=M, dev=dev, cells=C)))


def run_campaign_grid(model: FLModel, fleet: DeviceFleet, cx: torch.Tensor,
                      cy: torch.Tensor, cfg: FLConfig,
                      methods: Dict[str, MethodSpec], *, seeds: Sequence[int],
                      rounds: int, chunk_size: int = 8,
                      collect_per_device: bool = False,
                      scenario: Optional[Scenario] = None,
                      per_seed_fleets: bool = False,
                      eval_fn: Optional[Callable] = None,
                      target_acc: Optional[float] = None,
                      method_batched: bool = True,
                      telemetry: Optional[TelemetryCfg] = None,
                      async_cfg: Optional[AsyncCfg] = None,
                      noise_fn: Optional[Callable[[int, int], RoundNoise]] = None,
                      params: Optional[Params] = None,
                      env: Optional[EnvState] = None,
                      device="cuda") -> Dict[str, Dict[str, np.ndarray]]:
    """(method × seed) grid of FL campaigns → {method name: history}, each
    history as `run_campaign_batch` returns it.

    `method_batched=True` (default) with more than one method, all
    `core.methods.batchable`: one cell axis of M·B cells, each round
    issued once for the whole grid (`_run_grid_batched`), with selection
    masks bitwise those of the per-method path. Sync and async specs mix:
    a grid with an async spec runs every cell through the async round, a
    sync cell with the full-cohort sentinel. `async_cfg` gives the shared
    async knobs (delay model, jitter, staleness weighting) and forces
    async for an all-sync grid. A single method, `method_batched=False`
    or an unbatchable spec runs `run_campaign_batch` a method.
    `noise_fn(cell, round)` replaces the drawn noise, cells method-major
    on the batched path and seed-major within each method's batch
    otherwise; `params` / `env` ((B, ...) leaves, a seed's shared by its
    methods) the drawn initial params and environment."""
    dev = resolve_device(device)
    specs = list(methods.values())
    if method_batched and len(methods) > 1 and batchable(specs):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        _check_data(fleet, cx, cy, dev, per_seed_fleets, len(seeds))
        return _run_grid_batched(
            model, fleet, cx, cy, cfg, methods, seeds=seeds, rounds=rounds,
            chunk_size=chunk_size, collect_per_device=collect_per_device,
            scenario=scenario, per_seed_fleets=per_seed_fleets,
            eval_fn=eval_fn, target_acc=target_acc, telemetry=telemetry,
            async_cfg=async_cfg, noise_fn=noise_fn, params=params, env=env,
            dev=dev)

    def cell_acfg(spec: MethodSpec) -> Optional[AsyncCfg]:
        if spec.aggregation == "async":
            base = async_cfg if async_cfg is not None else AsyncCfg(
                buffer_m=spec.buffer_m)
            return dataclasses.replace(base, buffer_m=spec.buffer_m,
                                       capacity=None, n_lands=None)
        return async_cfg

    B = len(seeds)
    out = {}
    for i, (name, spec) in enumerate(methods.items()):
        fn = None
        if noise_fn is not None:
            fn = (lambda off: lambda c, r: noise_fn(off + c, r))(i * B)
        out[name] = run_campaign_batch(
            model, fleet, cx, cy, cfg, spec, seeds=seeds, rounds=rounds,
            chunk_size=chunk_size, collect_per_device=collect_per_device,
            scenario=scenario, per_seed_fleets=per_seed_fleets,
            eval_fn=eval_fn, target_acc=target_acc, telemetry=telemetry,
            async_cfg=cell_acfg(spec), noise_fn=fn, params=params, env=env,
            device=dev)
    return out
