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

Also here: the CLI's stdout JSON, the default device, the options this
slice does not port, and that the port imports neither JAX nor the JAX
package.
"""
import ast
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import METHODS as JMETHODS
from repro.core.round import make_eval_fn as j_make_eval_fn
from repro.launch import engine as jengine
from repro.launch.fl_run import build_task as j_build_task
from repro.launch.fl_run import quick_cfg as j_quick_cfg
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim.devices import build_fleet as j_build_fleet
from repro_torch.core.methods import METHODS
from repro_torch.core.round import make_eval_fn
from repro_torch.launch import fl_run
from repro_torch.launch.engine import run_rounds
from repro_torch.launch.fl_run import build_task, quick_cfg, run_fl
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.sim.devices import build_fleet
from tests.test_torch_round import jax_noise_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, K, ROUNDS, CHUNK, N_PER, N_TEST = 10, 4, 8, 4, 64, 512
FLEET = dict(init_energy_mean=0.11, init_energy_std=0.04, e0_frac=0.08)


def _run_both(task, method, rounds, chunk, seed=0):
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
    want = jengine.run_rounds(
        jmodel, jfleet, jcx, jcy, jcfg, JMETHODS[method], rounds=rounds, key=key,
        params=jparams, ecfg=jengine.EngineCfg(chunk_size=chunk),
        eval_fn=j_make_eval_fn(jmodel, jtest["x"], jtest["y"]))
    H_max = cfg.policy.H0 if METHODS[method].policy == "fixed" else cfg.policy.H_max
    got = run_rounds(
        model, fleet, cx, cy, cfg, METHODS[method], rounds=rounds,
        params=params_from_jax(jparams, device="cpu"), chunk_size=chunk,
        eval_fn=make_eval_fn(model, test["x"], test["y"]),
        noise_fn=jax_noise_fn(key, S, K, H_max, cfg.batch_size, N_PER),
        device="cpu")
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


@pytest.mark.parametrize("kw", [dict(scenario="commuter-diurnal"),
                                dict(aggregation="async"),
                                dict(telemetry="streaming")])
def test_unported_options_raise(kw):
    args = dict(rounds=1, n_clients=4, n_select=2, device="cpu") | kw
    with pytest.raises(NotImplementedError):
        run_fl(**args)


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
