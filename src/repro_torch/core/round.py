"""Algorithm 1 — one FL round, sync or async.

Per round: on a dynamic scenario, the fleet's environment steps first
(channel migration, charging and drain, churn, recoverable dropout:
`sim.dynamics`) → uplink rates from the injected fading draw → the global
model's probe loss (every `probe_every` rounds) → per-device candidate H
(policy) → latency/energy estimates → selection by the method's selector
(`rea`: the Eqn-2 utility through the `rewafl_select` kernel op; random,
oort, autofl: the plain ε-greedy ranking) → on a faulted scenario, the
fault draws (stragglers, aborts, lost uploads) and the deadline cut →
masked, vmapped local SGD on the K selected slots to the static H_max →
corruption and the robust screen (`core.resilience`) → FedAvg (the
`fedavg` kernel op), or in async mode dispatch into the pending buffer
and the buffered, staleness-weighted lands (`core.async_agg`, the
`fedavg` kernel op again) → the selected devices' statistical utility
from their probe losses (the `stat_util` kernel op) → fleet-state update
(Algorithm 1 lines 18–27).

The round mirrors `repro.core.round._build_round_body` for a static
`MethodSpec`, with the reference's gates: with no faults, no deadline, no
screen and sync aggregation it runs exactly the fault-free sync ops. Two
things differ by design:

* Randomness is an argument. The round takes a `RoundNoise` (fading,
  explore and minibatch draws, a dynamic scenario's environment draws,
  a faulted scenario's fault draws and the async delay jitter) instead
  of a PRNG key, so a test can hand it exactly the reference's draws;
  `launch.engine` draws it per round from a `torch.Generator`.
* No host syncs. Slot padding is a sort, not `nonzero`; dead slots
  scatter into an (S+1)-long buffer whose extra entry is sliced off —
  the reference's out-of-bounds `mode="drop"` scatter; the reference's
  `lax.cond` computes both sides and `torch.where` picks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.common import scatter_drop
from repro_torch.core import async_agg
from repro_torch.core import policy as pol
from repro_torch.core import resilience as res
from repro_torch.core import selection as sel
from repro_torch.core import utility as util
from repro_torch.core.async_agg import AsyncCfg
from repro_torch.core.methods import MethodParams, MethodSpec, selector_branches
from repro_torch.core.resilience import ResilienceCfg
from repro_torch.core.state import AsyncState, FleetState
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.rewafl_select import ops as rsel_ops
from repro_torch.kernels.stat_util import ops as stat_util_ops
from repro_torch.models.fl_models import FLModel, Params
from repro_torch.sim import faults as flt
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
    # round deadline and robust update screen; the default adds nothing
    # to a fault-free round, and the screen turns on by itself when the
    # scenario injects faults
    resilience: ResilienceCfg = dataclasses.field(default_factory=ResilienceCfg)


class RoundNoise(NamedTuple):
    """One round's random numbers."""
    fading_eps: torch.Tensor   # (S,) f32 standard normal: lognormal fading
    explore_u: torch.Tensor    # (S,) f32 uniform [0, 1): ε-greedy explore
    batch_idx: torch.Tensor    # (K, H_max, B) int64 in [0, n): minibatches
    # (3, S) f32 uniform [0, 1): the environment step's channel, plug and
    # online draws; None on a static scenario
    env_u: Optional[torch.Tensor] = None
    # (6, S) f32 uniform [0, 1): the fault draws (`sim.faults.fault_draws`);
    # None when the scenario injects no faults
    fault_u: Optional[torch.Tensor] = None
    # (K,) f32 standard normal: the async delays' lognormal jitter; None
    # when `AsyncCfg.delay_jitter` is 0 (or the round is sync)
    delay_eps: Optional[torch.Tensor] = None

    def to(self, device) -> "RoundNoise":
        return RoundNoise(*(None if x is None else x.to(device) for x in self))


def draw_noise(gen: torch.Generator, S: int, K: int, H_max: int, B: int,
               n: int, dynamic: bool = False, faults: bool = False,
               jitter: bool = False) -> RoundNoise:
    """Draw one round's noise on `gen`'s device; the environment draws
    (dynamic scenarios), then the fault draws (faulted scenarios), then
    the delay jitter (async with `delay_jitter` > 0) come after the
    others, so the static stream is the same with or without them."""
    dev = gen.device
    return RoundNoise(
        fading_eps=torch.randn(S, generator=gen, device=dev),
        explore_u=torch.rand(S, generator=gen, device=dev),
        batch_idx=torch.randint(0, n, (K, H_max, B), generator=gen, device=dev),
        env_u=torch.rand(3, S, generator=gen, device=dev) if dynamic else None,
        fault_u=torch.rand(6, S, generator=gen, device=dev) if faults else None,
        delay_eps=torch.randn(K, generator=gen, device=dev) if jitter else None)


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


def _build_round_body(model: FLModel, cfg: FLConfig,
                      method: Optional[MethodSpec],
                      scenario: Optional[Scenario],
                      acfg: Optional[AsyncCfg] = None):
    """The round for any selector (`random`, `oort`, `autofl`, `rea`) and
    policy (`fixed`, `adah`, `rewa`):
    round(mp, params, state, astate, env, fleet, cx, cy, noise, round_idx)
    -> (params', state', astate', env', metrics). `acfg` None is the sync
    FedAvg barrier (`astate` passes through as None); an `AsyncCfg` splits
    the aggregation into dispatch and buffered lands.

    `method` a MethodSpec: Python dispatch on its selector and policy,
    and `mp` is None. `method` None: the traced form, where `mp` is a
    `MethodParams` — every policy's H and every selector's scores are
    computed and `torch.where` picks the cell's (the reference's
    `lax.switch`, which under vmap computes every branch too), and one
    ε-greedy selection with the cell's effective ε ranks them. The
    traced form is what `launch.engine` vmaps over a grid's cells."""
    if method is not None:
        if method.selector not in ("random", "oort", "autofl", "rea"):
            raise ValueError(f"unknown selector {method.selector!r}")
        if method.policy not in ("rewa", "fixed", "adah"):
            raise ValueError(f"unknown policy {method.policy!r}")
    dyn = scenario is not None and scenario.dynamic
    # the chaos/resilience gates: with every one off, the round runs the
    # fault-free ops and takes no fault draws
    fcfg = scenario.faults if scenario is not None else flt.FaultCfg()
    faults_on = fcfg.enabled
    rcfg = cfg.resilience
    deadline_on = rcfg.deadline_s is not None
    screen_on = rcfg.screen_on(faults_on)
    chaos = faults_on or deadline_on      # delivery ≠ participation
    K = cfg.n_select
    model_bits = float(cfg.uplink_bits or model.param_bits)
    pcfg = cfg.policy
    if method is not None and method.policy == "fixed":
        # fixed-H baselines never exceed H0 — shrink the static loop bound
        # (the traced form cannot: its bound covers every cell's method)
        cfg = dataclasses.replace(cfg, policy=dataclasses.replace(pcfg, H_max=pcfg.H0))
    n_lands = acfg.lands(K) if acfg is not None else 0

    @torch.no_grad()
    def round_fn(mp: Optional[MethodParams], params: Params, state: FleetState,
                 astate: Optional[AsyncState], env: EnvState, fleet: DeviceFleet,
                 cx: torch.Tensor, cy: torch.Tensor, noise: RoundNoise,
                 round_idx: int):
        S = fleet.n
        dev = cx.device
        # method hyperparameters: constants (MethodSpec) or the cell's
        # MethodParams leaves
        if mp is None:
            alpha, beta = cfg.alpha, cfg.beta
            autofl_eta, autofl_ema = cfg.autofl_eta, cfg.autofl_ema
        else:
            alpha, beta = mp.alpha, mp.beta
            autofl_eta, autofl_ema = mp.autofl_eta, mp.autofl_ema
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
        def h_rewa():   # Eqn (3) growth gated by Eqn (4)
            eps = pol.stopping_eps(state.last_local_loss, g_loss,
                                   state.last_energy, fleet.e0_reserve,
                                   state.last_ecp)
            return pol.h_rewa(state.H, rates, eps, pcfg)

        if mp is not None:   # branch order: methods.POLICY_IDS
            H_cand = torch.where(mp.policy_id == 0, state.H, torch.where(
                mp.policy_id == 1, pol.h_adah(round_idx, S, pcfg, dev), h_rewa()))
        elif method.policy == "rewa":
            H_cand = h_rewa()
        elif method.policy == "adah":
            H_cand = pol.h_adah(round_idx, S, pcfg, dev)
        else:
            H_cand = state.H

        # --- cost estimates (line 9) ---------------------------------------
        costs = round_costs(fleet, H_cand, rates, model_bits)

        # --- utilities + selection (lines 13–16) ---------------------------
        # churn gates selection like dropout, but is transient
        available = (~state.dropped & env.online) if dyn else ~state.dropped
        u = noise.explore_u
        if mp is not None:
            # one ε-greedy selection for every selector: the branch only
            # picks the scores, and mp.exploration is the effective ε
            # (random 1: every slot by the uniform draw; rea 0: pure
            # ranking); masks are bitwise the static branches'
            stat_tu = sel.temporal_uncertainty(state.last_stat, round_idx,
                                               state.last_round)
            scores = selector_branches({
                "random": torch.zeros_like(state.last_stat),
                "oort": util.oort_utility(stat_tu, costs.t_total,
                                          T_round=cfg.T_round, alpha=alpha),
                "autofl": state.q_value,
                "rea": util.rewafl_utility(
                    state.last_stat, costs.t_total, costs.e_total,
                    state.residual_energy, fleet.e0_reserve,
                    T_round=cfg.T_round, alpha=alpha, beta=beta)})
            sid = mp.selector_id
            scores = torch.where(sid == 0, scores[0], torch.where(
                sid == 1, scores[1], torch.where(sid == 2, scores[2], scores[3])))
            selected = rsel_ops.select_traced(u, scores, K, available,
                                              mp.exploration)
        elif method.selector == "random":
            selected = sel.random_select(u, K, available)
        elif method.selector == "oort":
            stat_tu = sel.temporal_uncertainty(state.last_stat, round_idx,
                                               state.last_round)
            scores = util.oort_utility(stat_tu, costs.t_total,
                                       T_round=cfg.T_round, alpha=alpha)
            selected = rsel_ops.select_mask(u, K, available, method.exploration,
                                            scores=scores)
        elif method.selector == "autofl":
            selected = rsel_ops.select_mask(u, K, available, method.exploration,
                                            scores=state.q_value)
        else:   # "rea": Eqn (2), fused into the selection kernel; ε = 0
            ui = util.UtilityInputs(state.last_stat, costs.t_total,
                                    costs.e_total, state.residual_energy,
                                    fleet.e0_reserve)
            selected = rsel_ops.select_mask(u, K, available, 0.0, ui=ui,
                                            T_round=cfg.T_round,
                                            alpha=alpha, beta=beta)

        # --- feasibility: selected devices without enough battery fail ----
        feasible = costs.e_total < (state.residual_energy - fleet.e0_reserve)
        participating = selected & feasible
        failed = selected & ~feasible

        # --- fault injection (sim.faults) ----------------------------------
        # `t_round` is the realised round time (straggler spikes included);
        # `delivered` the participants whose update reaches the server
        t_round = costs.t_total
        if faults_on:
            # the rates: the scenario's constants, or the cell's tensors
            fp = fcfg if mp is None else mp.faults
            dr = flt.fault_draws(noise.fault_u)
            straggler = participating & (dr.u_straggler < fp.straggler_rate)
            t_round = torch.where(straggler, costs.t_total * fp.straggler_mult,
                                  costs.t_total)
            # mid-round compute abort: h_frac of the local steps ran
            # (their energy is spent below); the update is lost
            aborted = participating & (dr.u_abort < fp.abort_rate)
            # upload loss: only a bad channel loses updates, after the
            # upload's energy was spent (inert on a static scenario)
            lost = (participating & ~aborted & ~env.channel_good
                    & (dr.u_loss < fp.loss_rate))
            delivered = participating & ~aborted & ~lost
        else:
            delivered = participating
        if deadline_on:
            # too-late survivors are cut from the aggregation (FedAvg
            # renormalises over the rest); their energy is spent
            cut = delivered & (t_round > rcfg.deadline_s)
            delivered = delivered & ~cut

        # --- local training on the K selected slots ------------------------
        sel_idx, slot_live = select_slots(selected, K)
        part_k = participating[sel_idx] & slot_live
        xk, yk = cx[sel_idx], cy[sel_idx]
        global_flat = model.layout.flatten(params)
        client = _local_sgd(model, global_flat, xk, yk, H_cand[sel_idx],
                            noise.batch_idx, cfg)
        deliver_k = delivered[sel_idx] & slot_live if chaos else part_k
        weights = fleet.data_size[sel_idx].float() * deliver_k.float()

        # --- update corruption + robust screen (core.resilience) -----------
        if faults_on:
            corrupt = delivered & (dr.u_corrupt < fp.corrupt_rate)
            client = flt.corrupt_cohort(client, global_flat,
                                        corrupt[sel_idx] & deliver_k,
                                        dr.u_cmode[sel_idx],
                                        scale=fcfg.corrupt_scale,
                                        nan_frac=fcfg.corrupt_nan_frac)
        if screen_on:
            client, weights, reject_k = res.screen_updates(
                global_flat, client, weights, norm_mult=rcfg.norm_mult)
            rejected = scatter_drop(torch.zeros_like(selected),
                                  torch.where(slot_live, sel_idx, S), reject_k)
            ok, ok_k = delivered & ~rejected, deliver_k & ~reject_k
        else:
            ok, ok_k = delivered, deliver_k

        if acfg is None:
            new_flat = _fedavg(global_flat, client, weights)
        else:
            # ---- async dispatch / land (core.async_agg) -------------------
            # the cohort snapshots θ now; its deltas arrive on the virtual
            # clock after the device's round time (or one unit)
            if acfg.delay == "unit":
                delays = torch.ones(K, device=dev)
            else:   # straggler-inflated under faults (t_round aliases t_total otherwise)
                delays = t_round[sel_idx]
            if acfg.delay_jitter > 0.0:
                delays = delays * torch.exp(acfg.delay_jitter * noise.delay_eps)
            if mp is None:
                m_eff = acfg.buffer_m
            else:   # 0 is the sync sentinel: the full K-cohort lands
                m_eff = torch.where(mp.buffer_m > 0, mp.buffer_m, K)
            pend_before = astate.slot_live.sum(dtype=torch.int32)
            # under chaos or the screen only the updates that arrived and
            # passed are pushed; fault-free, failed devices hold weight-0
            # slots (the server cannot tell a crashed device from a slow one)
            push_live = ok_k if (chaos or screen_on) else slot_live
            astate, n_pushed = async_agg.push_cohort(
                astate, client - global_flat, sel_idx, push_live, weights, delays)
            n_retried_r = n_expired_r = None
            if acfg.ttl is not None:
                astate, tinfo = async_agg.expire_and_retry(
                    astate, ttl=acfg.ttl, max_retries=acfg.max_retries,
                    retry_backoff=acfg.retry_backoff)
                n_retried_r, n_expired_r = tinfo["n_retried"], tinfo["n_expired"]
            # the trigger relaxes to the live occupancy when nothing was
            # pushed (a sub-M residue would park forever) and, at M = K,
            # for an under-K cohort entering an empty buffer (it lands at
            # once, as sync FedAvg would)
            pend_after = astate.slot_live.sum(dtype=torch.int32)
            stuck = (n_pushed == 0) & (pend_after > 0)
            fresh_under = ((pend_before == 0) & (n_pushed > 0)
                           & (n_pushed < m_eff) & (m_eff == K))
            m_land = torch.where(stuck | fresh_under,
                                 pend_after.clamp(max=m_eff).clamp_min(1), m_eff)
            # a fixed number of land attempts; the first arms the bitwise
            # sync fast path (this cohort alone, zero staleness)
            new_flat = global_flat
            n_agg = n_landed_r = stale_sum = 0
            for j in range(n_lands):
                sync_agg = sync_pred = None
                if j == 0 and acfg.server_lr == 1.0:
                    sync_agg = _fedavg(global_flat, client, weights)
                    sync_pred = (lambda n_landed:
                                 (pend_before == 0) & (n_landed == n_pushed))
                new_flat, astate, info = async_agg.land_once(
                    new_flat, astate, m_land,
                    staleness_power=acfg.staleness_power,
                    server_lr=acfg.server_lr,
                    sync_aggregate=sync_agg, sync_pred=sync_pred)
                n_agg = n_agg + info["did_aggregate"]
                n_landed_r = n_landed_r + info["n_landed"]
                stale_sum = stale_sum + info["stale_sum"]
        new_params = model.layout.views(new_flat)

        # --- post-training local losses (stat-utility refresh) -------------
        probe = cfg.probe_size
        ls = vmap(lambda p, x, y: model.per_sample_loss(p, {"x": x, "y": y}))(
            model.layout.views(client), xk[:, :probe], yk[:, :probe])
        l_loss_k = ls.mean(1)

        # --- state update (lines 18–27) -----------------------------------
        # a device whose update never reached (or never passed) the server
        # keeps its stale PS view, but its energy is spent regardless
        # (an abort spends only the compute that ran)
        succ, succ_k = (ok, ok_k) if (chaos or screen_on) else (participating, part_k)
        e_spent = torch.where(participating, costs.e_total, 0.0)
        if faults_on:
            e_spent = torch.where(aborted, costs.e_comp * dr.h_frac, e_spent)
        new_E = state.residual_energy - e_spent
        new_u = torch.where(succ, 0, state.u + 1)
        new_H = torch.where(succ, H_cand, state.H)
        new_last_round = torch.where(succ, round_idx, state.last_round)

        # dead pad slots scatter to the extra index S and are dropped
        scatter_idx = torch.where(slot_live, sel_idx, S)

        def scatter(base, vals_k, mask_k):
            return scatter_drop(base, scatter_idx,
                              torch.where(mask_k, vals_k, base[sel_idx]))

        stat_k = stat_util_ops.stat_utility(ls, fleet.data_size[sel_idx])
        new_stat = scatter(state.last_stat, stat_k, succ_k)
        new_lll = scatter(state.last_local_loss, l_loss_k, succ_k)
        new_ecp = torch.where(succ, costs.e_comp, state.last_ecp)
        new_lastE = torch.where(succ, state.residual_energy, state.last_energy)

        # AutoFL bandit value: EMA of (global-loss drop proxy)/energy
        loss_drop_k = (g_loss[sel_idx] - l_loss_k).clamp_min(0.0)
        reward_k = util.autofl_reward(loss_drop_k, costs.e_total[sel_idx],
                                      eta=autofl_eta)
        q_sel = (autofl_ema * state.q_value[sel_idx]
                 + (1 - autofl_ema) * reward_k * 1e3)
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
        # realised latency: straggler-inflated, but never past the deadline
        latency = torch.where(participating, t_round, 0.0).max()
        if deadline_on:
            latency = latency.clamp(max=rcfg.deadline_s)
        metrics: Dict[str, torch.Tensor] = {
            "round_latency": latency,
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
        # the chaos counters, each only under its gate (as the reference)
        if faults_on:
            metrics.update({"n_aborted": aborted.sum(), "n_lost": lost.sum(),
                            "n_corrupted": corrupt.sum(),
                            "n_straggler": straggler.sum()})
        if deadline_on:
            metrics["n_deadline_cut"] = cut.sum()
        if screen_on:
            metrics["n_rejected"] = reject_k.sum()
        if acfg is not None:
            metrics.update({
                # virtual wall clock + buffer health
                "wall_clock": astate.t_now,
                "server_version": astate.server_version,
                "n_pending": astate.slot_live.sum(),
                "n_aggregations": n_agg,
                "n_landed": n_landed_r,
                "mean_update_staleness": (stale_sum.float()
                                          / n_landed_r.clamp_min(1).float()),
                # per-device (S,): staleness of the last landed update
                "update_staleness": astate.update_staleness,
            })
            if acfg.ttl is not None:
                metrics["n_retried"] = n_retried_r
                metrics["n_expired"] = n_expired_r
        return new_params, new_state, astate, env, metrics

    return round_fn


def make_round_body(model: FLModel, cfg: FLConfig, method: MethodSpec,
                    scenario: Optional[Scenario] = None):
    """Returns round(params, state, env, fleet, cx, cy, noise, round_idx)
    -> (params', state', env', metrics): the sync FedAvg round. cx/cy:
    stacked client data (S, n, ...); `round_idx` a Python int, so the
    `probe_every` schedule is a plain `if`.

    `scenario` (None ≡ static-paper) picks the fleet dynamics: a static
    one carries `env` through untouched; a dynamic one steps it first
    from `noise.env_u` and gates selection on `env.online`. A scenario
    with fault injection draws its faults from `noise.fault_u`, and the
    screen (`cfg.resilience`) then turns on by itself."""
    body = _build_round_body(model, cfg, method, scenario)

    def round_fn(params: Params, state: FleetState, env: EnvState,
                 fleet: DeviceFleet, cx: torch.Tensor, cy: torch.Tensor,
                 noise: RoundNoise, round_idx: int):
        p, s, _, e, m = body(None, params, state, None, env, fleet, cx, cy,
                             noise, round_idx)
        return p, s, e, m

    return round_fn


def make_async_round_body(model: FLModel, cfg: FLConfig, method: MethodSpec,
                          scenario: Optional[Scenario] = None,
                          async_cfg: AsyncCfg = AsyncCfg()):
    """The async (FedBuff-style) round:
    round(params, state, astate, env, fleet, cx, cy, noise, round_idx)
    -> (params', state', astate', env', metrics), where `astate` is the
    pending-update buffer and virtual clock (`core.state.AsyncState`,
    from `init_async_state(flat params, S, async_cfg.slots(K))`).
    Selection, training and the fleet-state update are the sync round's;
    the dispatched deltas land after their delay and aggregate
    staleness-weighted once `async_cfg.buffer_m` have arrived. With the
    jitter on, `noise.delay_eps` carries its (K,) normal draw."""
    body = _build_round_body(model, cfg, method, scenario, async_cfg)

    def round_fn(params: Params, state: FleetState, astate: AsyncState,
                 env: EnvState, fleet: DeviceFleet, cx: torch.Tensor,
                 cy: torch.Tensor, noise: RoundNoise, round_idx: int):
        return body(None, params, state, astate, env, fleet, cx, cy, noise,
                    round_idx)

    return round_fn


def make_round_body_mp(model: FLModel, cfg: FLConfig,
                       scenario: Optional[Scenario] = None):
    """The traced-method sync round:
    round(mp, params, state, env, fleet, cx, cy, noise, round_idx)
    -> (params', state', env', metrics), with `mp` a
    `methods.MethodParams`. Its selection masks are bitwise those of
    `make_round_body(model, cfg, spec, scenario)` at equal
    hyperparameters; its local-SGD loop runs to `cfg.policy.H_max` for
    every method (fixed-H cells take masked no-op steps past H0), so its
    `noise.batch_idx` is (K, H_max, B)."""
    body = _build_round_body(model, cfg, None, scenario)

    def round_fn(mp: MethodParams, params: Params, state: FleetState,
                 env: EnvState, fleet: DeviceFleet, cx: torch.Tensor,
                 cy: torch.Tensor, noise: RoundNoise, round_idx: int):
        p, s, _, e, m = body(mp, params, state, None, env, fleet, cx, cy,
                             noise, round_idx)
        return p, s, e, m

    return round_fn


def make_async_round_body_mp(model: FLModel, cfg: FLConfig,
                             scenario: Optional[Scenario] = None,
                             async_cfg: AsyncCfg = AsyncCfg()):
    """The traced-method async round:
    round(mp, params, state, astate, env, fleet, cx, cy, noise, round_idx).
    `mp.buffer_m` is each cell's trigger (0, the sync sentinel, lands the
    full K-cohort each round, and with no jitter such a cell is the sync
    cell's round, bitwise, through the land's sync fast path); the buffer
    capacity and land count come from `async_cfg` and must cover every
    cell (`launch.engine.run_campaign_grid` derives them)."""
    return _build_round_body(model, cfg, None, scenario, async_cfg)


def make_eval_fn(model: FLModel, test_x: torch.Tensor, test_y: torch.Tensor):
    @torch.no_grad()
    def evaluate(params: Params) -> torch.Tensor:
        return model.accuracy(params, {"x": test_x, "y": test_y})

    return evaluate


def make_batch_eval_fn(model: FLModel, test_x: torch.Tensor,
                       test_y: torch.Tensor, per_seed: bool = False):
    """evaluate(params_batch) -> (B,) accuracies of a campaign batch's
    (B, ...)-leaf params, for `launch.engine.run_campaign_batch` /
    `run_campaign_grid`. `per_seed`: test_x / test_y carry a leading
    seed axis too (`launch.fl_run.build_task_batch`), and params row b is
    scored on test set b."""
    ax = 0 if per_seed else None
    acc = vmap(lambda p, x, y: model.accuracy(p, {"x": x, "y": y}),
               in_dims=(0, ax, ax))

    @torch.no_grad()
    def evaluate(params: Params) -> torch.Tensor:
        return acc(params, test_x, test_y)

    return evaluate
