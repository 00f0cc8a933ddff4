"""The slice end to end: the port's chunked driver against the reference's.

`run_rounds` of both packages at the verify-skill size (S = 10, K = 4,
8 rounds, chunks of 4, `quick_cfg`, the width-reduced CNN), on the same
fleet, data, params and random draws (the reference's key chain handed to
the port through `noise_fn`). `selected` must match bitwise every round;
the float history within rtol 1e-4 (the CNN's sums run in other orders in
the two frameworks, and eight rounds of SGD grow that last-bit drift);
accuracy within one test sample.

The same at 4 rounds for each baseline selector (random, oort, autofl)
on the image task and for REWAFL on the HAR and char tasks.

`run_fl` of both packages with `probe_every=2`, the port's fed the
reference's draws and initial params (`run_fl_with_reference_draws`):
what `run_fl` itself builds — fleet, data, config, chunks, evaluation —
must give the reference's run.

Also here: the CLI's stdout JSON, `--scenario` and `--probe-every`,
`--health-strict`'s exit code, the default device, the options the port
does not have yet, and that the port imports neither JAX nor the JAX
package.
"""
import ast
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import METHODS as JMETHODS
from repro.core.round import make_eval_fn as j_make_eval_fn
from repro.launch import engine as jengine
from repro.launch import fl_run as j_fl_run
from repro.launch.fl_run import build_task as j_build_task
from repro.launch.fl_run import quick_cfg as j_quick_cfg
from repro.models.fl_models import make_fl_model as j_make_model
from repro.obs.health import HealthCfg as JHealthCfg
from repro.sim.devices import build_fleet as j_build_fleet
from repro.sim.dynamics import init_env_state as j_init_env_state
from repro.sim.dynamics import get_scenario as j_get_scenario
from repro_torch.core.methods import METHODS
from repro_torch.core.round import make_eval_fn
from repro_torch.launch import fl_run
from repro_torch.launch.engine import run_rounds
from repro_torch.launch.fl_run import build_task, quick_cfg, run_fl
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.obs.health import HealthCfg
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import SCENARIOS, EnvState, get_scenario, init_env_state
from tests.test_torch_round import jax_noise_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, K, ROUNDS, CHUNK, N_PER, N_TEST = 10, 4, 8, 4, 64, 512
FLEET = dict(init_energy_mean=0.11, init_energy_std=0.04, e0_frac=0.08)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU rounds here are many small ops: one intra-op thread
    runs them as fast as many, and keeps the parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(task, method, rounds, chunk, seed=0, scenario="static-paper"):
    """Both drivers on the same fleet, data, params and draws; on a
    dynamic scenario the port is handed the reference's default initial
    environment, drawn from `fold_in(key, 0x0d1f)`."""
    jmodel, model = j_make_model(task, small=True), make_fl_model(task, small=True)
    jfleet = j_build_fleet(S, seed=seed, **FLEET)
    fleet = build_fleet(S, seed=seed, device="cpu", **FLEET)
    jcx, jcy, jtest = j_build_task(task, S, 0.8, per_client=N_PER, n_test=N_TEST)
    cx, cy, test = build_task(task, S, 0.8, per_client=N_PER, n_test=N_TEST,
                              device="cpu")
    jcfg = j_quick_cfg(K)
    cfg = quick_cfg(K)
    jparams = jmodel.init(jax.random.PRNGKey(seed + 2))
    key = jax.random.PRNGKey(seed + 1)
    jsc, sc = j_get_scenario(scenario), get_scenario(scenario)
    want = jengine.run_rounds(
        jmodel, jfleet, jcx, jcy, jcfg, JMETHODS[method], rounds=rounds, key=key,
        params=jparams, ecfg=jengine.EngineCfg(chunk_size=chunk),
        eval_fn=j_make_eval_fn(jmodel, jtest["x"], jtest["y"]), scenario=jsc)
    env = None
    if sc.dynamic:
        env = env_from_jax(j_init_env_state(jfleet, jsc,
                                            key=jax.random.fold_in(key, 0x0d1f)))
    H_max = cfg.policy.H0 if METHODS[method].policy == "fixed" else cfg.policy.H_max
    got = run_rounds(
        model, fleet, cx, cy, cfg, METHODS[method], rounds=rounds,
        params=params_from_jax(jparams, device="cpu"), chunk_size=chunk,
        eval_fn=make_eval_fn(model, test["x"], test["y"]),
        noise_fn=jax_noise_fn(key, S, K, H_max, cfg.batch_size, N_PER, sc.dynamic),
        scenario=sc, env=env, device="cpu")
    return got, want


def _assert_runs_match(got, want, rounds, chunk):
    assert got.rounds_run == want.rounds_run == rounds
    assert list(got.chunk_rounds) == list(want.chunk_rounds) == [chunk] * (rounds // chunk)
    assert set(got.history) == set(want.history)
    np.testing.assert_array_equal(got.history["selected"], want.history["selected"])
    assert got.history["selected"].sum(1).max() <= K
    for k, v in want.history.items():
        if k != "selected":
            np.testing.assert_allclose(np.asarray(got.history[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert len(got.acc_curve) == len(want.acc_curve) == rounds // chunk
    np.testing.assert_allclose(got.acc_curve, want.acc_curve, atol=1 / N_TEST + 1e-9)
    for name in got.state._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got.state, name).numpy(), np.float64),
            np.asarray(getattr(want.state, name), np.float64), rtol=1e-4, atol=1e-6,
            err_msg=name)


def test_run_rounds_matches_reference():
    got, want = _run_both("cnn@mnist", "rewafl", ROUNDS, CHUNK)
    _assert_runs_match(got, want, ROUNDS, CHUNK)


@pytest.mark.parametrize("task,method", [
    ("cnn@mnist", "random"), ("cnn@mnist", "oort"), ("cnn@mnist", "autofl"),
    ("cnn@har", "rewafl"), ("lstm@shakespeare", "rewafl")])
def test_run_rounds_matches_reference_for_each_method_and_task(task, method):
    """Each baseline on the image task, and REWAFL on the HAR and char
    tasks: 4 rounds in chunks of 2, `selected` bitwise every round; the
    char task's accuracy is over the 512 test sequences' next-char
    predictions."""
    got, want = _run_both(task, method, 4, 2)
    _assert_runs_match(got, want, 4, 2)


def test_early_stop_at_chunk_boundary():
    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet(6, seed=1, device="cpu")
    cx, cy, test = build_task("cnn@mnist", 6, 0.8, per_client=16, n_test=32, device="cpu")
    res = run_rounds(model, fleet, cx, cy, quick_cfg(2), METHODS["rewafl"], rounds=9,
                     seed=3, chunk_size=3, eval_fn=make_eval_fn(model, test["x"], test["y"]),
                     target_acc=0.0, device="cpu")
    assert res.rounds_run == 3 and res.reached_round == 2
    assert res.history["selected"].shape == (3, 6)
    assert len(res.acc_curve) == 1 and list(res.chunk_rounds) == [3]


# the reference CLI's stdout keys (repro/launch/fl_run.py main)
CLI_KEYS = {"task", "method", "scenario", "telemetry", "aggregation", "rounds",
            "reached_round", "dropout_ratio", "overall_latency_h",
            "overall_energy_kj", "wall_clock_s", "final_acc", "health_ok",
            "fault_totals", "carry_sha", "start_round", "wall_s"}


def test_cli_json_summary(capsys):
    fl_run.main(["--device", "cpu", "--rounds", "3", "--clients", "6", "--select", "2",
                 "--chunk-size", "2", "--quiet"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == CLI_KEYS
    assert out["rounds"] == 3 and 0.0 <= out["final_acc"] <= 1.0
    assert out["scenario"] == "static-paper" and out["aggregation"] == "sync"


@pytest.mark.parametrize("task,method", [("cnn@har", "oort"), ("lstm@shakespeare", "autofl"),
                                         ("cnn@cifar10", "random")])
def test_cli_runs_each_task_and_method(capsys, task, method):
    fl_run.main(["--device", "cpu", "--task", task, "--method", method, "--rounds", "2",
                 "--clients", "5", "--select", "2", "--chunk-size", "1", "--quiet"])
    out = json.loads(capsys.readouterr().out)
    assert (out["task"], out["method"], out["rounds"]) == (task, method, 2)
    assert 0.0 <= out["final_acc"] <= 1.0 and out["overall_energy_kj"] > 0


def test_run_fl_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fl(rounds=1, n_clients=4, n_select=2)


# the ROADMAP item that brings each option the port does not have yet
UNPORTED_ITEM = {"resume": "A14", "checkpoint_dir": "A14",
                 "checkpoint_every": "A14", "fleet_shards": "A16"}


@pytest.mark.parametrize("kw", [dict(resume="ckpts"),
                                dict(checkpoint_dir="ckpts"),
                                dict(checkpoint_every=2),
                                dict(fleet_shards=2)])
def test_unported_options_raise(kw):
    """Options of the reference's `run_fl` that the port does not have
    yet raise, naming the ROADMAP item that brings them: resuming and
    writing checkpoints (A14), fleet sharding (A16)."""
    args = dict(rounds=1, n_clients=4, n_select=2, device="cpu") | kw
    item = UNPORTED_ITEM[next(iter(kw))]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_fl(**args)


@pytest.mark.parametrize("kw", [dict(scenario="lossy-uplink"),
                                dict(scenario="flaky-fleet"),
                                dict(aggregation="async"),
                                dict(telemetry="streaming"),
                                dict(trace="t.json"),
                                dict(health=HealthCfg()),
                                dict(engine="loop")])
def test_formerly_unported_options_run(kw, tmp_path):
    """The fault scenarios (ROADMAP A11), async aggregation (A10),
    streaming telemetry, the trace and the health monitors (A12) and the
    per-round `loop` engine (A13), which raised or were missing until
    they were ported, run one CPU round."""
    if "trace" in kw:
        kw = dict(trace=str(tmp_path / kw["trace"]))
    res = run_fl(rounds=1, n_clients=4, n_select=2, device="cpu", **kw)
    assert res.rounds_run == 1 and np.isfinite(res.history["global_loss"]).all()
    if "scenario" in kw:
        assert "n_lost" in res.history
    elif "aggregation" in kw:
        assert res.wall_clock_s is not None and res.wall_clock_s > 0
    elif "telemetry" in kw:
        assert "H_trace" not in res.history
        np.testing.assert_array_equal(res.history["sel_count"],
                                      res.telemetry["tel/selected/count"])
    elif "engine" in kw:
        assert res.chunk_wall_s is None and len(res.acc_curve) == 1
        assert res.history["H_trace"].shape == (1, 4)
    elif "trace" in kw:
        names = {e["name"] for e in json.loads(pathlib.Path(kw["trace"]).read_text())
                 ["traceEvents"]}
        assert {"run_fl", "chunk", "dispatch", "eval", "transfer"} <= names
        assert res.spans["chunk"]["count"] == 1
    else:
        assert [s["round"] for s in res.health.samples] == [0]
        assert "sel_gini" in res.health.metrics


# Background drain far beyond any battery's round budget, no chargers:
# the whole fleet hits the depletion floor within a round or two (the
# reference's tests/test_obs.py scenario)
DRAIN_HEAVY = "test-drain-heavy"
DRAIN_HEAVY_FIELDS = dict(name=DRAIN_HEAVY, minutes_per_round=30.0, idle_drain_w=500.0,
                          plug_on_day=0.0, plug_on_night=0.0, frac_charging0=0.0)


@pytest.fixture
def drain_heavy(monkeypatch):
    """The drain-heavy scenario registered under one name in both
    packages' registries for the length of a test."""
    from repro.sim.dynamics import SCENARIOS as J_SCENARIOS
    for reg, get in ((SCENARIOS, get_scenario), (J_SCENARIOS, j_get_scenario)):
        monkeypatch.setitem(reg, DRAIN_HEAVY, dataclasses.replace(
            get("congested-urban"), **DRAIN_HEAVY_FIELDS))
    return DRAIN_HEAVY


@pytest.mark.parametrize("case", ["drain-heavy", "healthy"])
def test_cli_health_strict_exit_code(capsys, drain_heavy, case):
    """`--health-strict` exits 3 when a threshold tripped (the flat-battery
    alarm of the drain-heavy scenario) and returns normally on a healthy
    run; the JSON's `health_ok` follows the report."""
    argv = ["--device", "cpu", "--rounds", "2", "--clients", "6", "--select", "2",
            "--chunk-size", "1", "--quiet", "--health-strict"]
    if case == "drain-heavy":
        with pytest.raises(SystemExit) as e:
            fl_run.main(argv + ["--scenario", drain_heavy])
        assert e.value.code == 3
        out = capsys.readouterr()
        assert "flat-battery alarm" in out.err
        assert json.loads(out.out)["health_ok"] is False
    else:
        fl_run.main(argv + ["--scenario", "overnight-charging", "--max-near-frac", "1.0"])
        out = json.loads(capsys.readouterr().out)
        assert out["health_ok"] is True


def env_from_jax(jenv) -> EnvState:
    return EnvState(*(torch.from_numpy(np.array(x)) for x in jenv))


def run_fl_with_reference_draws(monkeypatch, task="cnn@mnist", method="rewafl", *,
                                scenario="static-paper", seed=0, **kw):
    """`run_fl` of both packages on the CPU at S = 10, K = 4. The port's
    `run_rounds` is wrapped so that it takes the reference's round draws
    (`PRNGKey(seed + 1)`), initial params (`PRNGKey(seed + 2)`) and, on a
    dynamic scenario, initial environment (`PRNGKey(seed + 3)`), after
    checking that the port's own `run_fl` handed it the round seed
    `seed + 1` and the environment drawn from a generator seeded
    `seed + 3`; on a faulted scenario or with async delay jitter, the
    reference's fault and jitter draws too. Returns (port's RunResult,
    reference's, the FLConfig the port ran)."""
    sc = get_scenario(scenario)
    real, seen = fl_run.run_rounds, {}

    def wrapped(model, fleet, cx, cy, cfg, spec, *, seed: int, params, env, **rkw):
        S, n = cx.shape[0], cx.shape[1]
        assert seed == seen["seed"] + 1
        u = torch.rand(4, S, generator=torch.Generator().manual_seed(seen["seed"] + 3))
        for got, want in zip(env, init_env_state(fleet, sc, u if sc.dynamic else None)):
            assert torch.equal(got, want)
        jfleet = j_build_fleet(S, seed=seen["seed"], **FLEET)
        if sc.dynamic:
            env = env_from_jax(j_init_env_state(jfleet, j_get_scenario(scenario),
                                                key=jax.random.PRNGKey(seen["seed"] + 3)))
        jparams = j_make_model(task, small=True).init(jax.random.PRNGKey(seen["seed"] + 2))
        H_max = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
        seen["cfg"] = cfg
        acfg = rkw.get("async_cfg")
        return real(model, fleet, cx, cy, cfg, spec, seed=seed, env=env,
                    params=params_from_jax(jparams, device="cpu"),
                    noise_fn=jax_noise_fn(jax.random.PRNGKey(seen["seed"] + 1), S,
                                          cfg.n_select, H_max, cfg.batch_size, n,
                                          sc.dynamic, sc.faults.enabled,
                                          acfg is not None and acfg.delay_jitter > 0),
                    **rkw)

    seen["seed"] = seed
    monkeypatch.setattr(fl_run, "run_rounds", wrapped)
    args = dict(rounds=8, n_clients=S, n_select=K, eval_every=4, seed=seed,
                scenario=scenario, fleet_kwargs=FLEET) | kw
    got = run_fl(task, method, device="cpu", **args)
    if isinstance(kw.get("health"), HealthCfg):   # the reference's own type
        args["health"] = JHealthCfg(**dataclasses.asdict(kw["health"]))
    want = j_fl_run.run_fl(task, method, **args)
    return got, want, seen["cfg"]


def assert_run_fl_match(got, want, training=True):
    """Selections bitwise, the fleet's counts exactly, the float history
    within rtol 1e-4, accuracy within one test sample. `training=False`
    leaves out what only the trained model sets (the global loss and the
    accuracy)."""
    assert got.rounds_run == want.rounds_run
    for k in ("sel_count", "H_trace"):
        np.testing.assert_array_equal(got.history[k], want.history[k], err_msg=k)
    for k in ("n_charging", "n_online", "n_available", "n_dropped",
              "n_participating", "n_failed"):
        np.testing.assert_array_equal(got.history[k], np.asarray(want.history[k],
                                                                 np.float64), err_msg=k)
    for k in ("round_latency", "round_energy", "mean_H_selected", "residual_energy") + (
            ("global_loss",) if training else ()):
        np.testing.assert_allclose(got.history[k], np.asarray(want.history[k], np.float64),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if training:
        np.testing.assert_allclose(got.acc_curve, want.acc_curve, atol=1 / N_TEST + 1e-9)
    assert got.dropout_ratio == want.dropout_ratio


def test_run_fl_probe_every_matches_reference(monkeypatch):
    """`run_fl(probe_every=2)` sets the config's `probe_every` as the
    reference's does, and the run matches the reference's: between
    probes the carried global loss repeats."""
    got, want, cfg = run_fl_with_reference_draws(monkeypatch, probe_every=2)
    assert cfg.probe_every == 2 and cfg.batch_size == quick_cfg(K).batch_size
    assert_run_fl_match(got, want)
    gl = got.history["global_loss"]
    assert np.all(gl[1::2] == gl[0::2])


def test_cli_scenario_and_probe_every(capsys, monkeypatch):
    real, seen = fl_run.run_rounds, {}

    def wrapped(*a, **kw):
        seen["probe_every"], seen["scenario"] = a[4].probe_every, kw["scenario"].name
        return real(*a, **kw)

    monkeypatch.setattr(fl_run, "run_rounds", wrapped)
    fl_run.main(["--device", "cpu", "--scenario", "churn-heavy", "--probe-every", "2",
                 "--rounds", "3", "--clients", "6", "--select", "2", "--chunk-size", "2",
                 "--quiet"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == CLI_KEYS
    assert out["scenario"] == "churn-heavy" and out["rounds"] == 3
    assert seen == {"probe_every": 2, "scenario": "churn-heavy"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (f, mod)
