"""Parity of the port's sync round body (`repro_torch.core.round`) with
the reference's (`repro.core.round.make_round_body`, kernel_backend
"xla"), on the CPU at small widths: the same fleet, data and params, and
the reference's own random draws handed to the port as `RoundNoise`.
Every method's selector (random, oort and autofl rank precomputed
scores; the rea methods go through the selection kernel's plain
version), and the global probe amortised over `probe_every` rounds.

The port's round computes the selected devices' statistical utility
through the `stat_util` kernel wrapper (its plain version for CPU
tensors); the reference's round through `util.statistical_utility`.
Selection masks and slot indices must match bitwise. Floats must match
within atol 1e-5 plus rtol 1e-5: the two frameworks sum and convolve in
different orders, so trained losses differ in the last bits, and
leaves scaled up from them (the statistical utility is |B|≈500 times a
loss; energies run to thousands of Joules, an f32 ulp of ~5e-4) cannot
meet a pure absolute 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as JFLConfig
from repro.core import METHODS as JMETHODS
from repro.core import init_fleet_state as j_init_state
from repro.core import make_round_body as j_make_round_body
from repro.core import select_slots as j_select_slots
from repro.core.policy import PolicyCfg as JPolicyCfg
from repro.launch.fl_run import build_task as j_build_task
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim.devices import build_fleet as j_build_fleet
from repro.sim.dynamics import init_env_state
from repro_torch.core.methods import METHODS
from repro_torch.core.policy import PolicyCfg
from repro_torch.core.round import (FLConfig, RoundNoise, make_round_body,
                                    select_slots)
from repro_torch.core.state import init_fleet_state
from repro_torch.launch.fl_run import build_task
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import init_env_state as t_init_env_state

ATOL, RTOL = 1e-5, 1e-5


def round_noise_from_key(kr, S, K, H_max, B, n, dynamic=False, faults=False,
                         jitter=False) -> RoundNoise:
    """The draws the reference round makes from its round key `kr`
    (`core/round.py:232`, `sim/wireless.py:14`, `core/selection.py:38`,
    `core/round.py:121-122,396`), as the port's RoundNoise. `dynamic`:
    the key splits in four, the first for the environment step, which
    splits it in three for its channel, plug and online uniforms
    (`core/round.py:227`, `sim/dynamics/env.py:79`). `faults`: the (6, S)
    fault uniforms from `fold_in(kr, FAULT_SALT)` (`sim/faults.py:135`);
    `jitter`: the async delays' (K,) normal from `fold_in(kr, 0xA57C)`
    (`core/round.py:445`)."""
    env_u = None
    if dynamic:
        k_env, k_rate, k_sel, k_train = jax.random.split(kr, 4)
        env_u = torch.from_numpy(np.array(jnp.stack(
            [jax.random.uniform(k, (S,)) for k in jax.random.split(k_env, 3)])))
    else:
        k_rate, k_sel, k_train = jax.random.split(kr, 3)
    eps = jax.random.normal(k_rate, (S,))
    u = jax.random.uniform(k_sel, (S,))
    its = jnp.arange(H_max)
    bidx = jax.vmap(lambda kk: jax.vmap(
        lambda it: jax.random.randint(jax.random.fold_in(kk, it), (B,), 0, n)
    )(its))(jax.random.split(k_train, K))
    fault_u = delay_eps = None
    if faults:
        fault_u = torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(kr, 0xFA17), (6, S))))
    if jitter:
        delay_eps = torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(kr, 0xA57C), (K,))))
    return RoundNoise(torch.from_numpy(np.array(eps)),
                      torch.from_numpy(np.array(u)),
                      torch.from_numpy(np.array(bidx, np.int64)), env_u,
                      fault_u, delay_eps)


def jax_noise_fn(key, S, K, H_max, B, n, dynamic=False, faults=False,
                 jitter=False):
    """noise_fn for the port's run_rounds reproducing the reference
    engine's per-round `key, kr = split(key)` chain (engine.py:349)."""
    rounds = []

    def fn(r):
        nonlocal key
        while len(rounds) <= r:
            key, kr = jax.random.split(key)
            rounds.append(round_noise_from_key(kr, S, K, H_max, B, n, dynamic,
                                               faults, jitter))
        return rounds[r]

    return fn


def assert_close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL))


S, K, N_PER = 10, 4, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = JFLConfig(n_select=K, batch_size=4, probe_size=4, lr=0.05,
                     uplink_bits=16e6, policy=JPolicyCfg(H0=2, H_max=6),
                     kernel_backend="xla")
    cfg = FLConfig(n_select=K, batch_size=4, probe_size=4, lr=0.05,
                   uplink_bits=16e6, policy=PolicyCfg(H0=2, H_max=6))
    return jcfg, cfg


def _run_one(setup, method, fleet_kw, key_seed, rounds=2, probe_every=1,
             n_dropped=0):
    """`rounds` rounds of both bodies; the first `n_dropped` devices start
    dropped."""
    jcfg, cfg = setup
    jcfg = dataclasses.replace(jcfg, probe_every=probe_every)
    cfg = dataclasses.replace(cfg, probe_every=probe_every)
    jmodel = j_make_model("cnn@mnist", small=True)
    model = make_fl_model("cnn@mnist", small=True)
    jfleet = j_build_fleet(S, seed=0, **fleet_kw)
    fleet = build_fleet(S, seed=0, device="cpu", **fleet_kw)
    jcx, jcy, _ = j_build_task("cnn@mnist", S, 0.8, per_client=N_PER, n_test=32)
    cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=N_PER, n_test=32,
                           device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(2))
    params = params_from_jax(jparams, device="cpu")
    jstate = j_init_state(jfleet, H0=2)
    state = init_fleet_state(fleet, H0=2)
    if n_dropped:
        jstate = jstate._replace(dropped=jnp.arange(S) < n_dropped)
        state = state._replace(dropped=torch.arange(S) < n_dropped)
    env, tenv = init_env_state(jfleet), t_init_env_state(fleet)
    jbody = jax.jit(j_make_round_body(jmodel, jcfg, JMETHODS[method]))
    body = make_round_body(model, cfg, METHODS[method])
    H_max = cfg.policy.H0 if METHODS[method].policy == "fixed" else cfg.policy.H_max
    key = jax.random.PRNGKey(key_seed)
    out = []
    for r in range(rounds):
        key, kr = jax.random.split(key)
        jparams, jstate, env, jm = jbody(jparams, jstate, env, jfleet, jcx, jcy,
                                         kr, jnp.asarray(r, jnp.int32))
        noise = round_noise_from_key(kr, S, K, H_max, 4, N_PER)
        params, state, tenv, m = body(params, state, tenv, fleet, cx, cy, noise, r)
        out.append((jparams, jstate, jm, params, state, m))
    return out


def _assert_rounds_match(out, fleet_sizes=None):
    """Selections and slots bitwise, every float within ATOL/RTOL. With
    `fleet_sizes`, `last_stat` is compared per sample, as last_stat/|B|:
    it is |B|·rms(loss), and a loss near 0 is logz − gold, two numbers at
    the logits' scale whose difference carries an absolute error of an
    f32 ulp of them (~2e-7 to 5e-7) in either framework, which |B| ≈ 500
    scales past ATOL."""
    for jparams, jstate, jm, params, state, m in out:
        jsel = np.asarray(jm["selected"])
        np.testing.assert_array_equal(m["selected"].numpy(), jsel)
        jidx, jlive = j_select_slots(jnp.asarray(jsel), K)
        idx, live = select_slots(m["selected"], K)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
        for name in state._fields:
            got, want = getattr(state, name).numpy(), np.asarray(getattr(jstate, name))
            if want.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=name)
            elif name == "last_stat" and fleet_sizes is not None:
                assert_close(got / fleet_sizes, want / fleet_sizes)
            else:
                assert_close(got, want)
        for layer, leaves in jparams.items():
            for leaf, want in leaves.items():
                assert_close(params[f"{layer}.{leaf}"].numpy(), want)
        for k in ("round_latency", "round_energy", "n_participating", "n_failed",
                  "n_dropped", "mean_H_selected", "global_loss", "n_available",
                  "n_charging", "n_online", "H", "residual_energy", "staleness"):
            assert_close(m[k].numpy(), jm[k])


HIGH = dict(init_energy_mean=0.3)
# the benchmark's low-battery fleet (over these 2 rounds no device drops:
# the baseline test below drops devices to run selection under K)
LOW = dict(init_energy_mean=0.11, init_energy_std=0.04, e0_frac=0.08)


@pytest.mark.parametrize("method,fleet_kw,key_seed", [
    ("rewafl", HIGH, 7),
    ("rewafl", LOW, 3),
    ("reafl", HIGH, 11),
    ("reafl_lupa", HIGH, 5),
])
def test_round_matches_reference(setup, method, fleet_kw, key_seed):
    _assert_rounds_match(_run_one(setup, method, fleet_kw, key_seed))


@pytest.mark.parametrize("method,key_seed,n_dropped,probe_every,rounds", [
    # the baselines: autofl's q_value and oort's stat start equal for
    # every device (round 0 is all ties); oort and autofl explore
    # round(0.1·K) = 1 slot; with 7 of 10 devices dropped, 3 < K remain
    ("random", 13, 0, 1, 2),
    ("random", 17, 7, 1, 2),
    ("oort", 19, 0, 1, 2),
    ("oort", 23, 7, 1, 2),
    ("autofl", 29, 0, 1, 2),
    ("autofl", 31, 7, 1, 2),
    # the global probe every 2 and 3 rounds: the rounds between probes
    # reuse the carried g_loss, the next probe refreshes it
    ("rewafl", 37, 0, 2, 3),
    ("rewafl", 41, 0, 3, 4),
    ("oort", 43, 0, 2, 3),
    ("oort", 47, 7, 3, 4),
])
def test_baseline_round_matches_reference(setup, method, key_seed, n_dropped,
                                          probe_every, rounds):
    out = _run_one(setup, method, HIGH, key_seed, rounds, probe_every, n_dropped)
    sizes = build_fleet(S, seed=0, device="cpu", **HIGH).data_size.numpy()
    _assert_rounds_match(out, fleet_sizes=sizes)
    for *_, m in out:
        n_sel = int(m["selected"].sum())
        assert n_sel == min(K, int(m["n_available"])) and n_sel <= S - n_dropped
    if probe_every > 1:     # g_loss is carried between probes
        for r in range(1, rounds):
            kept = torch.equal(out[r][4].g_loss, out[r - 1][4].g_loss)
            assert kept == (r % probe_every != 0), r


def test_select_slots_pads_like_nonzero():
    for sel in ([1, 0, 0, 1, 0, 1], [0] * 6, [1] * 6, [0, 0, 0, 0, 0, 1]):
        mask = np.asarray(sel, bool)
        for k in (1, 3, 4, 8):
            jidx, jlive = j_select_slots(jnp.asarray(mask), k)
            idx, live = select_slots(torch.from_numpy(mask), k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
