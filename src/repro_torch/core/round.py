"""Algorithm 1 — one synchronous FL round.

Per round: on a dynamic scenario, the fleet's environment steps first
(channel migration, charging and drain, churn, recoverable dropout:
`sim.dynamics`) → uplink rates from the injected fading draw → the global
model's probe loss (every `probe_every` rounds) → per-device candidate H
(policy) → latency/energy estimates → selection by the method's selector
(`rea`: the Eqn-2 utility through the `rewafl_select` kernel op; random,
oort, autofl: the plain ε-greedy ranking) → masked, vmapped local SGD
on the K selected slots to the static H_max → FedAvg (the `fedavg`
kernel op) → the selected devices' statistical utility from their probe
losses (the `stat_util` kernel op) → fleet-state update (Algorithm 1
lines 18–27).

The round mirrors `repro.core.round.make_round_body` with faults,
deadline, screen and async off. Two things differ by design:

* Randomness is an argument. The round takes a `RoundNoise` (fading,
  explore and minibatch draws, and a dynamic scenario's environment
  draws) instead of a PRNG key, so a test can hand
  it exactly the reference's draws; `launch.engine` draws it per round
  from a `torch.Generator`.
* No host syncs. Slot padding is a sort, not `nonzero`; dead slots
  scatter into an (S+1)-long buffer whose extra entry is sliced off —
  the reference's out-of-bounds `mode="drop"` scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core import policy as pol
from repro_torch.core import selection as sel
from repro_torch.core import utility as util
from repro_torch.core.methods import MethodSpec
from repro_torch.core.state import FleetState
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.rewafl_select import ops as rsel_ops
from repro_torch.kernels.stat_util import ops as stat_util_ops
from repro_torch.models.fl_models import FLModel, Params
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.dynamics import (EnvState, Scenario, effective_rate_mean,
                                      step_env)
from repro_torch.sim.energy import min_round_cost, round_costs
from repro_torch.sim.wireless import sample_rates, sample_rates_from_mean


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_select: int = 20
    alpha: float = 1.0          # latency-utility exponent (paper default 1)
    beta: float = 1.0           # energy-utility exponent (paper default 1)
    T_round: float = 60.0       # developer-preferred round duration (s)
    batch_size: int = 32
    probe_size: int = 32        # per-client samples for loss estimation
    lr: float = 0.05
    # uplink payload (bits). None -> the trained model's true size
    uplink_bits: Optional[float] = None
    policy: pol.PolicyCfg = dataclasses.field(default_factory=pol.PolicyCfg)
    autofl_eta: float = 1.0
    autofl_ema: float = 0.5
    # probe the global model every N rounds (1: every round, the paper's
    # semantics); between probes the round reuses the last probed loss
    probe_every: int = 1


class RoundNoise(NamedTuple):
    """One round's random numbers."""
    fading_eps: torch.Tensor   # (S,) f32 standard normal: lognormal fading
    explore_u: torch.Tensor    # (S,) f32 uniform [0, 1): ε-greedy explore
    batch_idx: torch.Tensor    # (K, H_max, B) int64 in [0, n): minibatches
    # (3, S) f32 uniform [0, 1): the environment step's channel, plug and
    # online draws; None on a static scenario
    env_u: Optional[torch.Tensor] = None

    def to(self, device) -> "RoundNoise":
        return RoundNoise(*(None if x is None else x.to(device) for x in self))


def draw_noise(gen: torch.Generator, S: int, K: int, H_max: int, B: int,
               n: int, dynamic: bool = False) -> RoundNoise:
    """Draw one round's noise on `gen`'s device; the environment draws
    (dynamic scenarios) come after the others, so the static stream is
    the same with or without them."""
    dev = gen.device
    return RoundNoise(
        fading_eps=torch.randn(S, generator=gen, device=dev),
        explore_u=torch.rand(S, generator=gen, device=dev),
        batch_idx=torch.randint(0, n, (K, H_max, B), generator=gen, device=dev),
        env_u=torch.rand(3, S, generator=gen, device=dev) if dynamic else None)


def _probe_losses(model: FLModel, params: Params, cx: torch.Tensor,
                  cy: torch.Tensor, probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S,) mean loss and (S,) mean squared loss of the global model on a
    per-client probe subsample, as one flat (S·probe) forward."""
    S = cx.shape[0]
    px, py = cx[:, :probe], cy[:, :probe]
    p = px.shape[1]
    ls = model.per_sample_loss(params, {"x": px.reshape((S * p,) + px.shape[2:]),
                                        "y": py.reshape(S * p)})
    ls = ls.reshape(S, p)
    return ls.mean(1), (ls * ls).mean(1)


def _local_sgd(model: FLModel, global_flat: torch.Tensor, xk: torch.Tensor,
               yk: torch.Tensor, Hk: torch.Tensor, batch_idx: torch.Tensor,
               cfg: FLConfig) -> torch.Tensor:
    """Masked local SGD of K clients from the global params, to H_max
    iterations; iterations ≥ H_k leave client k unchanged.

    Returns the K client parameter sets as one contiguous (K, P) buffer,
    updated in place through per-leaf (K, ...) views."""
    K, P = xk.shape[0], global_flat.shape[0]
    client = global_flat.new_empty(K, P)
    client.copy_(global_flat.expand(K, P))
    views = model.layout.views(client)
    grad_fn = vmap(grad(lambda p, x, y: model.loss(p, {"x": x, "y": y})))
    rows = torch.arange(K, device=xk.device)[:, None]
    for it in range(cfg.policy.H_max):
        idx = batch_idx[:, it]
        g = grad_fn(views, xk[rows, idx], yk[rows, idx])
        coef = cfg.lr * (it < Hk).float()
        for name, v in views.items():
            v.sub_(coef.view((K,) + (1,) * (v.dim() - 1)) * g[name])
    return client


def _fedavg(global_flat: torch.Tensor, client: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """θ' = Σ w_k·θ_k / Σw through the fedavg kernel op, one launch for
    all parameters; θ unchanged when every weight is 0."""
    wn = weights / weights.sum().clamp_min(1e-9)
    agg = fedavg_ops.weighted_aggregate(client, wn)
    return torch.where(weights.sum() > 0, agg, global_flat)


def select_slots(selected: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sel_idx, slot_live) for the K training slots of a selection mask:
    selected device indices in ascending order, padded with index 0 and
    slot_live False when fewer than k are selected — the reference's
    `jnp.nonzero(size=k, fill_value=0)` without a host sync."""
    S = selected.shape[0]
    ar = torch.arange(S, device=selected.device)
    v = torch.sort(torch.where(selected, ar, S)).values[:k]
    if v.shape[0] < k:
        v = torch.cat([v, v.new_full((k - v.shape[0],), S)])
    slot_live = v < S
    return torch.where(slot_live, v, 0), slot_live


def make_round_body(model: FLModel, cfg: FLConfig, method: MethodSpec,
                    scenario: Optional[Scenario] = None):
    """Returns round(params, state, env, fleet, cx, cy, noise, round_idx)
    -> (params', state', env', metrics) for any selector (`random`,
    `oort`, `autofl`, `rea`) and policy (`fixed`, `adah`, `rewa`). cx/cy:
    stacked client data (S, n, ...); `round_idx` a Python int, so the
    `probe_every` schedule is a plain `if`.

    `scenario` (None ≡ static-paper) picks the fleet dynamics: a static
    one carries `env` through untouched; a dynamic one steps it first
    from `noise.env_u` and gates selection on `env.online`. Scenarios
    with fault injection raise NotImplementedError (ROADMAP A11)."""
    if method.selector not in ("random", "oort", "autofl", "rea"):
        raise ValueError(f"unknown selector {method.selector!r}")
    if method.policy not in ("rewa", "fixed", "adah"):
        raise ValueError(f"unknown policy {method.policy!r}")
    if scenario is not None and scenario.faults.enabled:
        raise NotImplementedError(
            f"scenario {scenario.name!r} injects faults, which are not "
            "ported yet (ROADMAP A11)")
    dyn = scenario is not None and scenario.dynamic
    K = cfg.n_select
    model_bits = float(cfg.uplink_bits or model.param_bits)
    pcfg = cfg.policy
    if method.policy == "fixed":
        # fixed-H baselines never exceed H0 — shrink the static loop bound
        cfg = dataclasses.replace(cfg, policy=dataclasses.replace(pcfg, H_max=pcfg.H0))

    @torch.no_grad()
    def round_fn(params: Params, state: FleetState, env: EnvState,
                 fleet: DeviceFleet, cx: torch.Tensor, cy: torch.Tensor,
                 noise: RoundNoise, round_idx: int):
        S = fleet.n
        dev = cx.device
        if dyn:
            env, state = step_env(scenario, fleet, env, state, round_idx,
                                  noise.env_u, model_bits)
            rate_mean = effective_rate_mean(env.channel_good, fleet)
            rates = sample_rates_from_mean(noise.fading_eps, rate_mean,
                                           fleet.rate_sigma)
        else:
            rate_mean = None
            rates = sample_rates(noise.fading_eps, fleet)

        # --- global-model probe (amortised when probe_every > 1) ---------
        if cfg.probe_every <= 1 or round_idx % cfg.probe_every == 0:
            g_loss, _ = _probe_losses(model, params, cx, cy, cfg.probe_size)
        else:
            g_loss = state.g_loss

        # --- candidate H per policy (Algorithm 1 line 8) -------------------
        if method.policy == "rewa":   # Eqn (3) growth gated by Eqn (4)
            eps = pol.stopping_eps(state.last_local_loss, g_loss,
                                   state.last_energy, fleet.e0_reserve,
                                   state.last_ecp)
            H_cand = pol.h_rewa(state.H, rates, eps, pcfg)
        elif method.policy == "adah":
            H_cand = pol.h_adah(round_idx, S, pcfg, dev)
        else:
            H_cand = state.H

        # --- cost estimates (line 9) ---------------------------------------
        costs = round_costs(fleet, H_cand, rates, model_bits)

        # --- utilities + selection (lines 13–16) ---------------------------
        # churn gates selection like dropout, but is transient
        available = (~state.dropped & env.online) if dyn else ~state.dropped
        u, eps = noise.explore_u, method.exploration
        if method.selector == "random":
            selected = sel.random_select(u, K, available)
        elif method.selector == "oort":
            stat_tu = sel.temporal_uncertainty(state.last_stat, round_idx,
                                               state.last_round)
            scores = util.oort_utility(stat_tu, costs.t_total,
                                       T_round=cfg.T_round, alpha=cfg.alpha)
            selected = rsel_ops.select_mask(u, K, available, eps, scores=scores)
        elif method.selector == "autofl":
            selected = rsel_ops.select_mask(u, K, available, eps,
                                            scores=state.q_value)
        else:   # "rea": Eqn (2), fused into the selection kernel; ε = 0
            ui = util.UtilityInputs(state.last_stat, costs.t_total,
                                    costs.e_total, state.residual_energy,
                                    fleet.e0_reserve)
            selected = rsel_ops.select_mask(u, K, available, 0.0, ui=ui,
                                            T_round=cfg.T_round,
                                            alpha=cfg.alpha, beta=cfg.beta)

        # --- feasibility: selected devices without enough battery fail ----
        feasible = costs.e_total < (state.residual_energy - fleet.e0_reserve)
        participating = selected & feasible
        failed = selected & ~feasible

        # --- local training on the K selected slots ------------------------
        sel_idx, slot_live = select_slots(selected, K)
        part_k = participating[sel_idx] & slot_live
        xk, yk = cx[sel_idx], cy[sel_idx]
        global_flat = model.layout.flatten(params)
        client = _local_sgd(model, global_flat, xk, yk, H_cand[sel_idx],
                            noise.batch_idx, cfg)
        weights = fleet.data_size[sel_idx].float() * part_k.float()
        new_params = model.layout.views(_fedavg(global_flat, client, weights))

        # --- post-training local losses (stat-utility refresh) -------------
        probe = cfg.probe_size
        ls = vmap(lambda p, x, y: model.per_sample_loss(p, {"x": x, "y": y}))(
            model.layout.views(client), xk[:, :probe], yk[:, :probe])
        l_loss_k = ls.mean(1)

        # --- state update (lines 18–27) -----------------------------------
        succ, succ_k = participating, part_k
        e_spent = torch.where(participating, costs.e_total, 0.0)
        new_E = state.residual_energy - e_spent
        new_u = torch.where(succ, 0, state.u + 1)
        new_H = torch.where(succ, H_cand, state.H)
        new_last_round = torch.where(succ, round_idx, state.last_round)

        # dead pad slots scatter to the extra index S and are dropped
        scatter_idx = torch.where(slot_live, sel_idx, S)

        def scatter(base, vals_k, mask_k):
            ext = torch.cat([base, base[:1]])
            ext[scatter_idx] = torch.where(mask_k, vals_k, base[sel_idx])
            return ext[:S]

        stat_k = stat_util_ops.stat_utility(ls, fleet.data_size[sel_idx])
        new_stat = scatter(state.last_stat, stat_k, succ_k)
        new_lll = scatter(state.last_local_loss, l_loss_k, succ_k)
        new_ecp = torch.where(succ, costs.e_comp, state.last_ecp)
        new_lastE = torch.where(succ, state.residual_energy, state.last_energy)

        # AutoFL bandit value: EMA of (global-loss drop proxy)/energy
        loss_drop_k = (g_loss[sel_idx] - l_loss_k).clamp_min(0.0)
        reward_k = util.autofl_reward(loss_drop_k, costs.e_total[sel_idx],
                                      eta=cfg.autofl_eta)
        q_sel = (cfg.autofl_ema * state.q_value[sel_idx]
                 + (1 - cfg.autofl_ema) * reward_k * 1e3)
        new_q = scatter(state.q_value, q_sel, succ_k)

        # dropout: can no longer afford even H=1 + uplink at its mean rate
        # (dynamic scenarios: the current channel's mean; the next round's
        # environment step clears it once charging refills the battery)
        min_cost = min_round_cost(fleet, model_bits, rate_mean)
        new_dropped = state.dropped | failed | (new_E - fleet.e0_reserve <= min_cost)

        new_state = FleetState(
            residual_energy=new_E, H=new_H, u=new_u,
            last_round=new_last_round, last_stat=new_stat,
            last_local_loss=new_lll, last_ecp=new_ecp,
            last_energy=new_lastE, dropped=new_dropped, q_value=new_q,
            n_participations=state.n_participations + participating.int(),
            n_selected=state.n_selected + selected.int(),
            g_loss=g_loss,
        )
        n_sel = selected.sum()
        metrics: Dict[str, torch.Tensor] = {
            "round_latency": torch.where(participating, costs.t_total, 0.0).max(),
            "round_energy": e_spent.sum(),
            "n_participating": participating.sum(),
            "n_failed": failed.sum(),
            "n_dropped": new_dropped.sum(),
            "mean_H_selected": (torch.where(selected, H_cand, 0).sum()
                                / n_sel.clamp_min(1)),
            "global_loss": g_loss.mean(),
            "n_available": available.sum(),
            "n_charging": (env.charging.sum() if dyn else
                           torch.zeros((), dtype=torch.int64, device=dev)),
            "n_online": (env.online.sum() if dyn else
                         torch.full((), S, dtype=torch.int64, device=dev)),
            "selected": selected,
            "H": new_H,
            "residual_energy": new_E,
            "staleness": new_u,
        }
        return new_params, new_state, env, metrics

    return round_fn


def make_eval_fn(model: FLModel, test_x: torch.Tensor, test_y: torch.Tensor):
    @torch.no_grad()
    def evaluate(params: Params) -> torch.Tensor:
        return model.accuracy(params, {"x": test_x, "y": test_y})

    return evaluate
