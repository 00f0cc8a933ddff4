"""Parity of the port's data, fleet and cost models with the reference.

Data, partitions and fleets come from numpy draws in both packages, so
they must be bitwise equal. Rates, costs, utilities and the REWA policy
are f32 arithmetic written op for op like the reference's; they must
agree within one f32 ulp or so (rtol 1e-6), and the integer H bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.core import utility as jutil
from repro.core.state import init_fleet_state as j_init_state
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.launch.fl_run import build_task as j_build_task
from repro.sim import energy as jenergy
from repro.sim import wireless as jwireless
from repro.sim.devices import build_fleet as j_build_fleet
from repro_torch.core import policy as pol
from repro_torch.core import utility as util
from repro_torch.core.state import init_fleet_state
from repro_torch.data import partition as part
from repro_torch.data import synthetic as syn
from repro_torch.launch.fl_run import build_task
from repro_torch.sim import energy, wireless
from repro_torch.sim.devices import build_fleet

RTOL = 1e-6


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("task", ["cnn@mnist", "cnn@cifar10"])
@pytest.mark.parametrize("lam", [0.0, 0.8, 1.0])
def test_build_task_bitwise(task, lam):
    jcx, jcy, jtest = j_build_task(task, 7, lam, per_client=12, n_test=20, seed=3)
    cx, cy, test = build_task(task, 7, lam, per_client=12, n_test=20, seed=3,
                              device="cpu")
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
    np.testing.assert_array_equal(test["x"].numpy(), np.asarray(jtest["x"]))
    np.testing.assert_array_equal(test["y"].numpy(), np.asarray(jtest["y"]))
    assert cx.dtype == torch.float32 and cy.dtype == torch.int64


@pytest.mark.parametrize("kind", ["mnist", "cifar10"])
def test_synthetic_and_partition_bitwise(kind):
    x, y = syn.make_image_dataset(kind, 300, seed=5)
    jx, jy = jsyn.make_image_dataset(kind, 300, seed=5)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(
        part.partition_non_iid(y, 9, 0.8, per_client=20, n_classes=10, seed=2),
        jpart.partition_non_iid(jy, 9, 0.8, per_client=20, n_classes=10, seed=2))


@pytest.mark.parametrize("n,kw", [(100, {}), (13, dict(init_energy_mean=0.11,
                                                      init_energy_std=0.04,
                                                      e0_frac=0.08))])
def test_build_fleet_bitwise(n, kw):
    jf = j_build_fleet(n, seed=4, **kw)
    f = build_fleet(n, seed=4, device="cpu", **kw)
    assert f.n == jf.n == n
    for name in f._fields:
        got, want = getattr(f, name).numpy(), np.asarray(getattr(jf, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    s, js = init_fleet_state(f, H0=5), j_init_state(jf, H0=5)
    for name in s._fields:
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fleet(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("cnn@mnist", 4, 0.8, per_client=8, n_test=8)


def _fleet_round(seed, S=37):
    """The same fleet in both packages, a mid-campaign H and a numpy rng."""
    rng = np.random.RandomState(seed)
    jf = j_build_fleet(S, seed=seed, init_energy_mean=0.3)
    f = build_fleet(S, seed=seed, device="cpu", init_energy_mean=0.3)
    return jf, f, rng.randint(1, 30, S).astype(np.int32), rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rates_and_round_costs(seed):
    jf, f, H, _ = _fleet_round(seed)
    # the reference draws its normal inside lognormal_fading; feed its
    # own draw to the port
    key = jax.random.PRNGKey(seed)
    jrates = jwireless.sample_rates(key, jf)
    jeps = np.asarray(jax.random.normal(key, (f.n,)))
    rates = wireless.sample_rates(torch.tensor(jeps), f)
    close(rates.numpy(), jrates)
    bits = 206_922 * 32.0
    jc = jenergy.round_costs(jf, jnp.asarray(H), jnp.asarray(jrates), bits)
    c = energy.round_costs(f, torch.from_numpy(H), torch.tensor(np.asarray(jrates)), bits)
    for name in c._fields:
        close(getattr(c, name).numpy(), getattr(jc, name))
    close(energy.min_round_cost(f, bits).numpy(), jenergy.min_round_cost(jf, bits))


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (2.0, 0.5)])
def test_utility_eqn2(alpha, beta):
    rng = np.random.RandomState(7)
    S = 64
    stat, t, e = (rng.uniform(0, 1e4, S), rng.uniform(1, 120, S),
                  rng.uniform(10, 2000, S))
    residual, e0 = rng.uniform(1e3, 6e4, S), rng.uniform(100, 3e3, S)
    t[:4] = 60.0                      # the T_round boundary
    e[4:8] = residual[4:8] - e0[4:8]  # the reserve boundary (exactly 0)
    leaves = [np.asarray(a, np.float32) for a in (stat, t, e, residual, e0)]
    want = jutil.rewafl_utility(*map(jnp.asarray, leaves), T_round=60.0,
                                alpha=alpha, beta=beta)
    got = util.rewafl_utility(*map(torch.from_numpy, leaves), T_round=60.0,
                              alpha=alpha, beta=beta)
    close(got.numpy(), want, rtol=RTOL if alpha == beta == 1.0 else 1e-5)
    if alpha == beta == 1.0:          # the exponent-1 guard: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    close(util.oort_utility(torch.from_numpy(leaves[0]), torch.from_numpy(leaves[1]),
                            T_round=60.0, alpha=alpha).numpy(),
          jutil.oort_utility(jnp.asarray(leaves[0]), jnp.asarray(leaves[1]),
                             T_round=60.0, alpha=alpha), rtol=1e-5)
    sizes = rng.randint(1, 900, S).astype(np.int32)
    lsq = rng.uniform(-0.1, 9.0, S).astype(np.float32)
    close(util.statistical_utility(torch.from_numpy(sizes), torch.from_numpy(lsq)).numpy(),
          jutil.statistical_utility(jnp.asarray(sizes), jnp.asarray(lsq)))


@pytest.mark.parametrize("seed", [0, 3])
def test_rewa_policy(seed):
    jf, f, H, rng = _fleet_round(seed)
    S = f.n
    rates = (np.asarray(jf.rate_mean) * rng.lognormal(0, 0.3, S)).astype(np.float32)
    lll, gl = rng.uniform(0, 5, S).astype(np.float32), rng.uniform(0, 5, S).astype(np.float32)
    last_e = rng.uniform(1e3, 6e4, S).astype(np.float32)
    ecp = rng.uniform(0, 300, S).astype(np.float32)
    ecp[:3] = 0.0
    cfg, jcfg = pol.PolicyCfg(), jpol.PolicyCfg()
    jeps = jpol.stopping_eps(*map(jnp.asarray, (lll, gl, last_e)), jf.e0_reserve,
                             jnp.asarray(ecp))
    teps = pol.stopping_eps(*map(torch.from_numpy, (lll, gl, last_e)), f.e0_reserve,
                            torch.from_numpy(ecp))
    close(teps.numpy(), jeps)
    close(pol.psi(torch.from_numpy(rates), cfg).numpy(), jpol.psi(jnp.asarray(rates), jcfg))
    jH = jpol.h_rewa(jnp.asarray(H), jnp.asarray(rates), jeps, jcfg)
    tH = pol.h_rewa(torch.from_numpy(H), torch.from_numpy(rates),
                    torch.tensor(np.asarray(jeps)), cfg)
    np.testing.assert_array_equal(tH.numpy(), np.asarray(jH))
    for r in (0, 4, 40):
        np.testing.assert_array_equal(
            pol.h_adah(r, S, cfg, "cpu").numpy(),
            np.asarray(jpol.h_adah(jnp.asarray(r, jnp.int32), S, jcfg)))
    np.testing.assert_array_equal(pol.h_fixed(S, cfg, "cpu").numpy(),
                                  np.asarray(jpol.h_fixed(S, jcfg)))
