"""End-to-end REWAFL federated-training driver (paper Secs. IV–V).

Builds the synthetic task, the device fleet, and runs FL rounds under a
chosen PS method until target accuracy or a round budget, on a CUDA
device by default. The port of `repro.launch.fl_run`'s chunked engine:
sync or async (FedBuff-style) aggregation, on the static fleet and every
fleet-dynamics scenario, the two fault scenarios included, with dense or
streaming telemetry, the fleet-health monitors and the engine's trace
spans.

CLI:  PYTHONPATH=src python -m repro_torch.launch.fl_run \
          --task cnn@mnist --method rewafl --rounds 100 \
          [--scenario flaky-fleet] [--probe-every 2] \
          [--aggregation async --buffer-m 10 --async-delay wall] \
          [--telemetry streaming] [--health | --health-strict] \
          [--trace out.trace.json] \
          [--checkpoint-every 2 --checkpoint-dir ckpts] [--resume ckpts]
(`--device cpu` runs on the CPU; without a GPU the default raises.)

Observability (`repro_torch.obs`): `--trace PATH` records the engine's
host spans (chunk / dispatch / history drain / eval / health / transfer)
as Perfetto-loadable Chrome trace JSON; `--health` samples the
fleet-health monitors (flat batteries, near-depletion, selection Gini,
staleness tails) at chunk boundaries and `--health-strict` turns a
tripped threshold into exit code 3. Progress chatter goes through the
`repro_torch` logger (`--quiet` / `-v`); the final JSON stays on stdout.

Checkpoints (`training.checkpoint`): `--checkpoint-every N
--checkpoint-dir DIR` saves the engine's whole carry every N rounds;
`--resume DIR` (or one checkpoint file) goes on from the newest intact
one, bitwise the uninterrupted run. The JSON's `carry_sha` (the final
carry's digest) and `start_round` show it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.async_agg import DELAY_MODES, AsyncCfg
from repro_torch.core.methods import METHODS
from repro_torch.core.metrics import ASYNC_SPECS, DEFAULT_SPECS, TelemetryCfg
from repro_torch.core.policy import PolicyCfg
from repro_torch.core.round import FLConfig, make_eval_fn
from repro_torch.core.state import AsyncState, FleetState
from repro_torch.data.partition import client_datasets
from repro_torch.data.synthetic import (make_char_dataset, make_har_dataset,
                                        make_image_dataset)
from repro_torch.launch.engine import run_loop, run_rounds
from repro_torch.models.fl_models import make_fl_model
from repro_torch.obs.health import HealthCfg, HealthReport, format_health_table
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.obs.trace import Tracer, format_span_table, tracing
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import SCENARIOS, get_scenario, init_env_state
from repro_torch.training.checkpoint import tree_digest

log = get_logger(__name__)


@dataclasses.dataclass
class RunResult:
    task: str
    method: str
    rounds_run: int
    reached_round: Optional[int]       # first round hitting target acc
    target_acc: float
    history: Dict[str, np.ndarray]     # per-round metric arrays
    final_state: FleetState
    overall_latency_s: float           # Σ round latency
    overall_energy_j: float
    dropout_ratio: float               # dropped / fleet at stop point
    acc_curve: np.ndarray
    final_params: object = None        # trained global model params
    # per-chunk wall clock (the first includes warm-up) + rounds per chunk
    chunk_wall_s: Optional[np.ndarray] = None
    chunk_rounds: Optional[np.ndarray] = None
    wall_clock_s: Optional[float] = None   # async: final virtual time
    async_state: Optional[AsyncState] = None   # async: final buffer
    # streaming telemetry only: the reducers' outputs
    # (`tel/<metric>/<reducer>` -> (S,) aggregates; see core.metrics)
    telemetry: Optional[Dict[str, np.ndarray]] = None
    # the fleet-health verdict (obs.health) when run_fl(health=...) was set
    health: Optional[HealthReport] = None
    # span aggregates ({name: {count, total_s, mean_s, max_s}}) when
    # run_fl(trace=...) recorded the run's engine phases
    spans: Optional[Dict[str, Dict[str, float]]] = None
    # checkpointing or resuming only: the digest of the final params,
    # FleetState, EnvState (and AsyncState), `training.checkpoint.
    # tree_digest` as the reference takes it
    carry_sha: Optional[str] = None
    start_round: int = 0               # the resumed checkpoint's round, or 0


def build_task(task: str, n_clients: int, lam: float, *, per_client: int = 128,
               n_test: int = 512, seed: int = 0, device="cuda"):
    """(cx (S, n, ...), cy (S, n) int64, test {"x", "y"}) on `device`,
    drawn exactly as the reference draws them. Images and HAR windows
    are f32 with λ-non-iid labels; the char task's cx are (S, n, T)
    int64 ids, one role a client, its cy zeros (the LM loss reads x
    only) and its test set the sequences of 4 further roles."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    if task == "lstm@shakespeare":
        seqs, _ = make_char_dataset(n_clients + 4, per_role=per_client, seed=seed)
        cx = seqs[:n_clients]
        tx = seqs[n_clients:].reshape(-1, seqs.shape[-1])[:n_test]
        return (t(cx, torch.int64), t(np.zeros(cx.shape[:2]), torch.int64),
                {"x": t(tx, torch.int64), "y": t(np.zeros(len(tx)), torch.int64)})
    n = n_clients * per_client + n_test
    if task in ("cnn@mnist", "cnn@cifar10"):
        x, y = make_image_dataset(task.split("@")[1], n, seed=seed)
        n_classes = 10
    elif task == "cnn@har":
        x, y = make_har_dataset(n, seed=seed)
        n_classes = 6
    else:
        raise ValueError(task)
    tx, ty = x[-n_test:], y[-n_test:]
    cx, cy = client_datasets(x[:-n_test], y[:-n_test], n_clients, lam,
                             per_client, n_classes, seed=seed)
    return (t(cx), t(cy, torch.int64),
            {"x": t(tx), "y": t(ty, torch.int64)})


def build_task_batch(task: str, seeds, n_clients: int, lam: float, *,
                     per_client: int = 128, n_test: int = 512, device="cuda"):
    """Per-seed client data stacked for a campaign batch with
    `per_seed_fleets=True`: seed s draws exactly `build_task(...,
    seed=s)`, what `run_fl(seed=s)` builds. Returns (cx (B, S, n, ...),
    cy (B, S, n), test {"x": (B, n_test, ...), "y": (B, n_test)})."""
    outs = [build_task(task, n_clients, lam, per_client=per_client,
                       n_test=n_test, seed=s, device=device) for s in seeds]
    return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
            {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]})


def quick_cfg(n_select: int = 20, alpha: float = 1.0,
              beta: float = 1.0) -> FLConfig:
    """Single-CPU-core benchmark scale: same algorithm, smaller loops."""
    return FLConfig(n_select=n_select, alpha=alpha, beta=beta,
                    batch_size=16, probe_size=16, lr=0.05,
                    uplink_bits=40e6,
                    policy=PolicyCfg(H0=5, H_max=16, dH=1.5))


HIST_KEYS = ("round_latency", "round_energy", "n_dropped",
             "n_participating", "n_failed", "mean_H_selected", "global_loss",
             "n_available", "n_charging", "n_online")

# the per-round scalars the async round adds (core.async_agg)
ASYNC_HIST_KEYS = ("wall_clock", "server_version", "n_pending",
                   "n_aggregations", "n_landed", "mean_update_staleness")

# the chaos and resilience counters (sim.faults, core.resilience, the
# async slot TTL): in the history only under the gates the run has on
FAULT_HIST_KEYS = ("n_aborted", "n_lost", "n_corrupted", "n_straggler",
                   "n_deadline_cut", "n_rejected", "n_retried", "n_expired")


def run_fl(task: str = "cnn@mnist", method: str = "rewafl", *,
           rounds: int = 100, n_clients: int = 100, n_select: int = 20,
           lam: float = 0.8, target_acc: float = 0.95,
           alpha: float = 1.0, beta: float = 1.0,
           seed: int = 0, per_client: int = 64, small: bool = True,
           fl_cfg: Optional[FLConfig] = None, fleet_kwargs: Optional[dict] = None,
           eval_every: int = 5, verbose: bool = False, engine: str = "scan",
           chunk_size: int = 8, scenario: str = "static-paper",
           probe_every: int = 1, telemetry: str = "dense",
           aggregation: str = "sync", buffer_m: Optional[int] = None,
           staleness_power: float = 0.5, delay_jitter: float = 0.0,
           async_delay: str = "wall", trace: Optional[str] = None,
           health: Optional[HealthCfg] = None,
           checkpoint_every: Optional[int] = None,
           checkpoint_dir: Optional[str] = None, resume: Optional[str] = None,
           fleet_shards: Optional[int] = None,
           device="cuda") -> RunResult:
    """Run one FL campaign on `device` (a CUDA device by default).

    Chunks never span more than `eval_every` rounds, so accuracy — and the
    early stop — is checked at least that often. `small` picks the
    reference's width-reduced model and `quick_cfg`; `small=False` runs the
    paper-scale model under the full `FLConfig`. Tasks: cnn@mnist,
    cnn@cifar10, cnn@har, lstm@shakespeare; methods: `core.methods.
    METHODS` (random, oort, autofl, reafl, reafl_lupa, rewafl);
    scenarios: `sim.dynamics.SCENARIOS` (lossy-uplink and flaky-fleet
    inject faults, and the robust screen turns on). `probe_every` N > 1
    probes the global model every N rounds. Seeds follow the reference:
    fleet and data from `seed`, the round noise generator from
    `seed + 1`, the model init from `seed + 2`, a dynamic scenario's
    initial environment from `seed + 3`.

    `aggregation="async"` switches to FedBuff-style buffered aggregation
    (`core.async_agg`): updates land on a virtual clock after the
    device's round time (`async_delay="wall"`) or one unit (`"unit"`),
    times a lognormal `delay_jitter`, and the server aggregates
    staleness-weighted (`staleness_power`) once `buffer_m` (default
    max(1, n_select // 2)) have arrived. History gains `ASYNC_HIST_KEYS`
    and `RunResult.wall_clock_s` is the final virtual time. With
    `buffer_m=n_select`, `async_delay="unit"` and no jitter the run is
    the sync run, bitwise.

    `telemetry="streaming"` folds `core.metrics.DEFAULT_SPECS` (async:
    `ASYNC_SPECS`) on the device instead of keeping (R, S) traces: the
    history has no `H_trace` (nor the port's `n_selected`), `sel_count`
    comes from the `tel/selected/count` reducer, and the aggregates land
    in `RunResult.telemetry`. `health=HealthCfg(...)` samples the
    fleet-health monitors at every chunk boundary and sets
    `RunResult.health`. `trace="out.trace.json"` records the engine's
    phase spans under a `run_fl` span, writes them as Chrome trace-event
    JSON and sets `RunResult.spans`; tracing is host-side only, and the
    run's numbers are bitwise those of the untraced run.

    `engine="loop"` is the reference's per-round driver
    (`launch.engine.run_loop`): one round a step with its scalars read on
    the host, evaluated at `round % eval_every == 0` and at the last
    round, stopping at the first evaluation at or above target; it has
    no chunks (`chunk_wall_s` None) and takes no async aggregation,
    streaming telemetry, health or checkpoints (ValueError). Same seeds,
    so its rounds are the chunked engine's.

    `checkpoint_every=N` with `checkpoint_dir` saves the engine's whole
    carry every N rounds (`launch.engine.run_rounds`); `resume` (a
    checkpoint file or directory) goes on from the newest intact one, and
    the rest of the run is bitwise the uninterrupted run's. Either sets
    `RunResult.carry_sha`; `start_round` is the resumed round.

    Not ported, raising NotImplementedError: `fleet_shards` above 1
    (ROADMAP A16)."""
    if trace is not None:
        kw = dict(locals())
        kw.pop("trace")
        with tracing(Tracer()) as tracer:
            with tracer.span("run_fl", task=task, method=method):
                res = run_fl(trace=None, **kw)
        tracer.write(trace)
        res.spans = tracer.summary()
        return res
    if engine not in ("scan", "loop"):
        raise ValueError(f"unknown engine {engine!r} (use 'scan' or 'loop')")
    if telemetry not in ("dense", "streaming"):
        raise ValueError(f"unknown telemetry {telemetry!r} "
                         "(use 'dense' or 'streaming')")
    if aggregation not in ("sync", "async"):
        raise ValueError(f"unknown aggregation {aggregation!r} "
                         "(use 'sync' or 'async')")
    if engine == "loop":   # the reference's refusals, in its order
        if aggregation == "async":
            raise ValueError("aggregation='async' needs engine='scan' — the "
                             "legacy loop driver has no buffer carry")
        if health is not None:
            raise ValueError("health monitoring needs engine='scan' — the "
                             "legacy loop driver has no chunk boundaries to "
                             "sample at")
        if checkpoint_every is not None or resume is not None:
            raise ValueError("checkpoint/resume needs engine='scan' — the "
                             "carry is serialized at chunk boundaries")
        if telemetry != "dense":
            raise ValueError("telemetry='streaming' needs engine='scan' — the "
                             "legacy loop driver has no on-device reducers")
    if (fleet_shards or 1) > 1:   # the ROADMAP item that brings it
        raise NotImplementedError(f"fleet_shards={fleet_shards!r} is not ported "
                                  "yet (ROADMAP A16)")
    scen = get_scenario(scenario)
    dev = resolve_device(device)
    model = make_fl_model(task, small=small)
    # benchmark-scale default: the paper's low-initial-battery regime
    fkw = {"init_energy_mean": 0.11, "init_energy_std": 0.04, "e0_frac": 0.08}
    fkw.update(fleet_kwargs or {})
    fleet = build_fleet(n_clients, seed=seed, device=dev, **fkw)
    cx, cy, test = build_task(task, n_clients, lam, per_client=per_client,
                              seed=seed, device=dev)
    cfg = fl_cfg or (quick_cfg(n_select, alpha, beta) if small else
                     FLConfig(n_select=n_select, alpha=alpha, beta=beta))
    if probe_every != 1:
        cfg = dataclasses.replace(cfg, probe_every=probe_every)
    acfg = None
    if aggregation == "async":
        acfg = AsyncCfg(buffer_m=(buffer_m if buffer_m is not None
                                  else max(1, cfg.n_select // 2)),
                        delay=async_delay, delay_jitter=delay_jitter,
                        staleness_power=staleness_power)
    streaming = telemetry == "streaming"
    tcfg = TelemetryCfg(mode=telemetry,
                        specs=ASYNC_SPECS if acfg is not None else DEFAULT_SPECS)
    env_u = None
    if scen.dynamic:
        env_gen = torch.Generator(device=dev).manual_seed(seed + 3)
        env_u = torch.rand(4, n_clients, generator=env_gen, device=dev)
    kw = dict(rounds=rounds, seed=seed + 1,
              params=model.init(torch.Generator(device=dev).manual_seed(seed + 2)),
              eval_fn=make_eval_fn(model, test["x"], test["y"]),
              target_acc=target_acc, scenario=scen,
              env=init_env_state(fleet, scen, env_u), device=dev)
    if engine == "loop":
        def on_eval(r, acc, m):
            if verbose:
                log.info(f"r={r:4d} acc={acc:.4f} loss={m['global_loss']:.4f} "
                         f"drop={int(m['n_dropped'])} "
                         f"H={float(m['mean_H_selected']):.1f}")

        res = run_loop(model, fleet, cx, cy, cfg, METHODS[method],
                       eval_every=eval_every, on_eval=on_eval, **kw)
    else:
        res = run_rounds(model, fleet, cx, cy, cfg, METHODS[method],
                         chunk_size=max(1, min(chunk_size, eval_every)),
                         async_cfg=acfg, telemetry=tcfg, health=health,
                         checkpoint_every=checkpoint_every,
                         checkpoint_dir=checkpoint_dir, resume=resume, **kw)
    carry_sha = None
    if checkpoint_every is not None or resume is not None:
        carry = {"params": res.params, "state": res.state, "env": res.env}
        if res.async_state is not None:
            carry["astate"] = res.async_state
        carry_sha = tree_digest(carry)
    h = res.history
    if verbose and engine == "scan":
        ends = np.cumsum(res.chunk_rounds) - 1
        for acc, r_end in zip(res.acc_curve, ends):
            log.info(f"r={r_end:4d} acc={acc:.4f} "
                     f"loss={h['global_loss'][r_end]:.4f} "
                     f"drop={int(h['n_dropped'][r_end])}")
    empty = np.zeros(0)
    if streaming:   # the per-device traces live in the O(S) reducers
        per_dev = {"sel_count": np.asarray(res.telemetry["tel/selected/count"],
                                           np.int64)}
    else:
        sel = np.asarray(h.get("selected", empty))
        per_dev = {
            "sel_count": sel.sum(0).astype(np.int64),
            # devices selected per round (the port's; derived like sel_count)
            "n_selected": sel.sum(-1).astype(np.int64),
            "H_trace": np.asarray(h.get("H", empty)),
        }
    hist_keys = HIST_KEYS + (ASYNC_HIST_KEYS if acfg is not None else ())
    return RunResult(
        task=task, method=method, rounds_run=res.rounds_run,
        reached_round=res.reached_round, target_acc=target_acc,
        history={k: np.asarray(h.get(k, empty), np.float64) for k in hist_keys}
        | {k: np.asarray(h[k], np.float64) for k in FAULT_HIST_KEYS
           if k in h and engine == "scan"}
        | per_dev | {
            "residual_energy": res.state.residual_energy.cpu().numpy(),
            "init_energy": fleet.init_energy.cpu().numpy(),
            "type_id": fleet.type_id.cpu().numpy(),
            "rate_mean": fleet.rate_mean.cpu().numpy(),
        },
        final_state=res.state,
        overall_latency_s=float(np.sum(h.get("round_latency", empty))),
        overall_energy_j=float(np.sum(h.get("round_energy", empty))),
        dropout_ratio=(float(h["n_dropped"][-1]) / n_clients
                       if len(h.get("n_dropped", empty)) else 0.0),
        acc_curve=res.acc_curve, final_params=res.params,
        chunk_wall_s=res.chunk_wall_s, chunk_rounds=res.chunk_rounds,
        wall_clock_s=(float(h["wall_clock"][-1])
                      if acfg is not None and len(h.get("wall_clock", empty)) else None),
        async_state=res.async_state, telemetry=res.telemetry, health=res.health,
        carry_sha=carry_sha, start_round=res.start_round)


def summary(res: RunResult, *, scenario: str, telemetry: str,
            aggregation: str, wall_s: float) -> dict:
    """The CLI's stdout JSON, the reference's keys."""
    return {
        "task": res.task, "method": res.method,
        "scenario": scenario, "telemetry": telemetry,
        "aggregation": aggregation,
        "rounds": res.rounds_run, "reached_round": res.reached_round,
        "dropout_ratio": res.dropout_ratio,
        "overall_latency_h": res.overall_latency_s / 3600,
        "overall_energy_kj": res.overall_energy_j / 1e3,
        "wall_clock_s": res.wall_clock_s,
        "final_acc": (float(res.acc_curve[-1]) if len(res.acc_curve) else None),
        "health_ok": res.health.ok if res.health is not None else None,
        "fault_totals": {k: float(np.sum(res.history[k]))
                         for k in FAULT_HIST_KEYS if k in res.history},
        "carry_sha": res.carry_sha, "start_round": res.start_round,
        "wall_s": round(wall_s, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="cnn@mnist")
    ap.add_argument("--method", default="rewafl", choices=sorted(METHODS))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--select", type=int, default=20)
    ap.add_argument("--lam", type=float, default=0.8)
    ap.add_argument("--target-acc", type=float, default=0.9)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="scan", choices=("scan", "loop"),
                    help="'scan': the chunked engine; 'loop': the per-round "
                         "driver (sync, dense telemetry, no health)")
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                    help="save the engine's whole carry every N completed "
                         "rounds (needs --checkpoint-dir; chunked engine only)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="directory for ckpt_r*.npz checkpoints (+ sha256 "
                         "sidecars)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume bitwise from a checkpoint file, or from the "
                         "newest intact checkpoint in a directory (corrupt "
                         "files are skipped)")
    ap.add_argument("--scenario", default="static-paper",
                    choices=sorted(SCENARIOS),
                    help="fleet dynamics; lossy-uplink and flaky-fleet "
                         "also inject faults")
    ap.add_argument("--probe-every", type=int, default=1,
                    help="re-probe the global model every N rounds "
                         "(1 = every round, the paper's exact semantics)")
    ap.add_argument("--aggregation", default="sync", choices=("sync", "async"),
                    help="'sync' is the FedAvg round barrier; 'async' is "
                         "FedBuff-style buffered aggregation on a virtual "
                         "wall clock")
    ap.add_argument("--buffer-m", type=int, default=None,
                    help="async: aggregate once M updates are buffered "
                         "(default n_select // 2)")
    ap.add_argument("--staleness-power", type=float, default=0.5,
                    help="async: staleness damping a in (1+stale)^-a")
    ap.add_argument("--delay-jitter", type=float, default=0.0,
                    help="async: lognormal sigma multiplying each "
                         "update's delay (0 = deterministic delays)")
    ap.add_argument("--async-delay", default="wall", choices=DELAY_MODES,
                    help="async delay model: 'wall' uses each device's "
                         "simulated compute+uplink seconds, 'unit' lands "
                         "every update one clock tick after dispatch")
    ap.add_argument("--full-width", action="store_true",
                    help="paper-scale model and FLConfig instead of the "
                         "width-reduced proxy and quick_cfg")
    ap.add_argument("--telemetry", default="dense", choices=("dense", "streaming"),
                    help="per-device history: 'dense' keeps (R, S) host "
                         "buffers; 'streaming' folds O(S) reducers on the "
                         "device instead")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the engine's phase spans to PATH as Chrome "
                         "trace-event JSON (ui.perfetto.dev)")
    ap.add_argument("--health", action="store_true",
                    help="sample the fleet-health monitors (flat batteries, "
                         "near-depletion, selection Gini, staleness tails) "
                         "at chunk boundaries")
    ap.add_argument("--health-strict", action="store_true",
                    help="imply --health and exit 3 when any health "
                         "threshold tripped")
    ap.add_argument("--max-flat-frac", type=float, default=0.10,
                    help="health: largest tolerated fraction of the fleet "
                         "at/below the depletion floor")
    ap.add_argument("--max-near-frac", type=float, default=0.50,
                    help="health: largest tolerated fraction of the fleet "
                         "within 50%% of the depletion floor (raise it for "
                         "fleets that start low, like the default one)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress chatter (warnings and the final "
                         "JSON still print)")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="debug-level logging")
    args = ap.parse_args(argv)
    configure_logging(verbosity=args.verbose, quiet=args.quiet)
    hcfg = (HealthCfg(max_flat_frac=args.max_flat_frac,
                      max_near_frac=args.max_near_frac)
            if args.health or args.health_strict else None)
    t0 = time.time()
    res = run_fl(args.task, args.method, rounds=args.rounds,
                 n_clients=args.clients, n_select=args.select, lam=args.lam,
                 target_acc=args.target_acc, alpha=args.alpha,
                 beta=args.beta, seed=args.seed, small=not args.full_width,
                 verbose=not args.quiet, engine=args.engine,
                 chunk_size=args.chunk_size, checkpoint_every=args.checkpoint_every,
                 checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                 scenario=args.scenario, probe_every=args.probe_every,
                 aggregation=args.aggregation, buffer_m=args.buffer_m,
                 staleness_power=args.staleness_power,
                 delay_jitter=args.delay_jitter, async_delay=args.async_delay,
                 telemetry=args.telemetry, trace=args.trace, health=hcfg,
                 device=args.device)
    if res.spans is not None:
        log.info("%s", format_span_table(res.spans))
        log.info("trace written to %s", args.trace)
    if res.health is not None:
        log.info("%s", format_health_table(res.health))
    print(json.dumps(summary(res, scenario=args.scenario, telemetry=args.telemetry,
                             aggregation=args.aggregation,
                             wall_s=time.time() - t0), indent=1))
    if args.health_strict and res.health is not None and not res.health.ok:
        sys.exit(3)


if __name__ == "__main__":
    main()
