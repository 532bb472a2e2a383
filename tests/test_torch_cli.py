"""The port's CLI against the JAX package's, files in to files out, on the CPU.

``cwbnwp_letkf_torch.cli.main --platform cpu`` and
``cwbnwp_letkf_tpu.cli.main`` run on the same input directories: the case of
tests/test_integration.py (``_make_inputs``: four WSM5 members, synop records,
T, QVAPOR and U) and the synthetic case of tests/test_synthetic_case.py
(``generate_case``, both weight functions).  Every variable of every
``wrfout_nc_###`` and of ``wrfout_nc_mean`` is held within 5e-4 of the
analysis increment ``max|xa_jax - xb|`` (over the members) for the
``var_update`` variables, and equal to JAX's for every other variable.  JAX runs its Newton-Schulz solve with full
float32 accumulation, which the port's plain versions reproduce.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu import cli as jcli
from cwbnwp_letkf_tpu import synthetic_case as jsynthetic
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_torch import cli, config, driver, synthetic_case
from cwbnwp_letkf_torch.io import native
from cwbnwp_letkf_torch.io.netcdf import NetcdfReader
from cwbnwp_letkf_torch.models import state, vcoord

from .test_integration import K, NML, _make_inputs
from .wrf_fixtures import make_wrf_ensemble

XA_RTOL = 5e-4
#: tests/test_streaming.py's tolerances: P/PH/MU ride on base states
BASE_ATOL = {"MU": 0.05, "P": 0.05, "PH": 0.05}
#: the synthetic cases of tests/test_synthetic_case.py
SYNTHETIC = {"wf0": dict(seed=5), "wf1": dict(seed=6, weight_function=1)}
#: a small generate_case input for the tests that stop before the analysis
SMALL_CASE = dict(k=4, nx=8, ny=6, nz=3, n_obs=10)


class _Stop(Exception):
    """Raised by a stand-in to end a CLI run at the analysis."""


def _jax_cli(argv):
    """The JAX CLI on one device (tests/conftest.py splits the CPU into
    eight, which the CLI would shard over), with its Newton-Schulz solve
    in full float32."""
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    try:
        return jcli.main(argv + ["--no-mesh"])
    finally:
        jsolver.set_eigh_backend("auto")
        jdense.set_accum_precision("high")


def _run(main, input_dir, output_dir, *extra):
    argv = ["--input", str(input_dir), "--output", str(output_dir),
            "--quiet", "--chunk", "64", *extra]
    if main is cli.main:
        argv += ["--platform", "cpu"]
    assert main(argv) == 0


def _read_all(path):
    with NetcdfReader(str(path)) as nc:
        return {n: nc.get_variable(n) for n in nc.variable_names()
                if n != "Times"}


def _assert_outputs_close(out, jout, input_dir, k, updated):
    """The ``updated`` variables of every file within XA_RTOL of JAX's
    increment (over the members), every other variable equal to JAX's."""
    names = [f"wrfout_nc_{m + 1:03d}" for m in range(k)] + ["wrfout_nc_mean"]
    got = {n: _read_all(out / n) for n in names}
    want = {n: _read_all(jout / n) for n in names}
    prior = [_read_all(input_dir / f"wrfinput_nc_{m + 1:03d}")
             for m in range(k)]
    incr = {v: max(float(np.abs(want[names[m]][v] - prior[m][v]).max())
                   for m in range(k)) for v in updated}
    for n in names:
        assert set(got[n]) == set(want[n]) == set(prior[0]), n
        for v, arr in want[n].items():
            if v in updated:
                assert incr[v] > 0, f"{v} was not updated"
                np.testing.assert_allclose(got[n][v], arr, rtol=0,
                                           atol=XA_RTOL * incr[v],
                                           err_msg=f"{n} {v}")
            else:
                assert np.array_equal(got[n][v], arr), (n, v)


@pytest.fixture(scope="module")
def integration(tmp_path_factory):
    """tests/test_integration.py's inputs and the JAX CLI's outputs (with its
    metrics line)."""
    d = tmp_path_factory.mktemp("cli")
    input_dir, _, _, _ = _make_inputs(d)
    jout = d / "jax_out"
    _run(_jax_cli, input_dir, jout,
         "--metrics-json", str(d / "jax_metrics.json"))
    return input_dir, jout, json.loads((d / "jax_metrics.json").read_text())


def test_arg_parser_matches_jax():
    def surface(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.nargs,
                         type(a).__name__) for a in parser._actions}

    assert surface(cli.build_arg_parser()) == surface(jcli.build_arg_parser())


def test_cli_matches_jax(integration, tmp_path):
    input_dir, jout, _ = integration
    native.reset_parses()
    _run(cli.main, input_dir, tmp_path)
    assert native.PARSES == {"native": K, "python": 0}
    _assert_outputs_close(tmp_path, jout, input_dir, K, ("T", "QVAPOR", "U"))


def test_stream_matches_eager(integration, tmp_path):
    """tests/test_streaming.py:24-61 on the port: member files and the mean
    file, with its tolerances."""
    input_dir = integration[0]
    eager, stream = tmp_path / "eager", tmp_path / "stream"
    _run(cli.main, input_dir, eager)
    _run(cli.main, input_dir, stream, "--stream")
    for m in range(K):
        e = _read_all(eager / f"wrfout_nc_{m + 1:03d}")
        s = _read_all(stream / f"wrfout_nc_{m + 1:03d}")
        assert set(e) == set(s)
        for name in e:
            np.testing.assert_allclose(s[name], e[name], rtol=1e-6,
                                       atol=BASE_ATOL.get(name, 1e-6),
                                       err_msg=f"member {m + 1} {name}")
    e = _read_all(eager / "wrfout_nc_mean")
    s = _read_all(stream / "wrfout_nc_mean")
    assert set(e) == set(s)
    for name in e:
        np.testing.assert_allclose(s[name], e[name], rtol=1e-5,
                                   atol=BASE_ATOL.get(name, 1e-5),
                                   err_msg=f"mean {name}")


def test_stream_heights_equal_eager(integration, tmp_path):
    """The streaming ensemble takes the eager path's float32 mean of the
    members' full geopotential, so both modes analyse at the same heights
    (the JAX package's streaming float64 mean differs by a rounding)."""
    input_dir = integration[0]
    cfg = config.LetkfConfig.from_namelist(str(input_dir / "input.nml"))
    paths = [str(input_dir / f"wrfinput_nc_{m + 1:03d}") for m in range(K)]
    stream = state.StreamingWrfEnsemble(
        paths, cfg, [str(tmp_path / f"sink_{m}") for m in range(K)])
    eager = state.read_ensemble(paths, cfg)
    assert np.array_equal(vcoord.mean_geopotential_height(stream),
                          vcoord.mean_geopotential_height(eager))


def test_mean_file_is_member_mean(integration, tmp_path):
    _run(cli.main, integration[0], tmp_path)
    t = np.stack([_read_all(tmp_path / f"wrfout_nc_{m + 1:03d}")["T"]
                  for m in range(K)], -1)
    np.testing.assert_allclose(_read_all(tmp_path / "wrfout_nc_mean")["T"],
                               t.mean(-1), rtol=1e-6, atol=1e-5)


def test_metrics_json_keys_match_jax(integration, tmp_path):
    input_dir, _, jmetrics = integration
    path = tmp_path / "metrics.json"
    _run(cli.main, input_dir, tmp_path / "out", "--metrics-json", str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == set(jmetrics)
    assert set(got["stages_s"]) == set(jmetrics["stages_s"])
    for key in ("platforms", "groups"):
        assert [set(x) for x in got[key]] == [set(x) for x in jmetrics[key]]
    assert got["total_var_points"] == jmetrics["total_var_points"]
    assert ([g["variables"] for g in got["groups"]]
            == [g["variables"] for g in jmetrics["groups"]])


def test_stage_stamps_match_jax(integration, tmp_path, capsys):
    """The StageTimer lines, in the JAX CLI's order and text."""
    input_dir = integration[0]

    def stamps(main, out):
        argv = ["--input", str(input_dir), "--output", str(out),
                "--chunk", "64", "--metrics-json", str(out) + ".json"]
        if main is cli.main:
            argv += ["--platform", "cpu"]
        capsys.readouterr()
        assert main(argv) == 0
        return [line.split("==========> ")[1]
                for line in capsys.readouterr().out.splitlines()
                if "==========> " in line]

    got = stamps(cli.main, tmp_path / "port")
    assert got == stamps(_jax_cli, tmp_path / "jax")
    assert got[:4] == ["reading namelist", "reading model data",
                       "read obs data", "get into letkf core"]
    assert got[-1] == "finish all steps"


def test_profile_dir_writes_trace(integration, tmp_path):
    """The program's spans and the counters beside them
    (``tracing.maybe_trace``)."""
    trace_dir = tmp_path / "trace"
    _run(cli.main, integration[0], tmp_path / "out", "--profile-dir",
         str(trace_dir))
    (trace,) = trace_dir.glob("trace_*.json")
    (counts,) = trace_dir.glob("counters_*.json")
    assert len(list(trace_dir.iterdir())) == 2
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"driver.prepare", "cycle.update", "solver.solve"} <= {
        e.get("name") for e in events}
    assert json.loads(counts.read_text())["accumulate.pairs"] > 0


def test_no_obs_is_noop(tmp_path):
    """tests/test_integration.py:181-194 on the port: no observation files,
    every output variable equal to the prior."""
    input_dir = tmp_path / "input"
    input_dir.mkdir()
    make_wrf_ensemble(str(input_dir), K, seed=4)
    (input_dir / "input.nml").write_text(NML.format(k=K))
    _run(cli.main, input_dir, tmp_path / "out")
    for m in range(K):
        a = _read_all(input_dir / f"wrfinput_nc_{m + 1:03d}")
        b = _read_all(tmp_path / "out" / f"wrfout_nc_{m + 1:03d}")
        for name in ("T", "QVAPOR", "U"):
            assert np.array_equal(a[name], b[name]), (m, name)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_case_matches_jax(tmp_path, name):
    """tests/test_synthetic_case.py's cases: the same bytes from both
    generators, the port's CLI within 5e-4 of JAX's increment, and the
    RMSE gain asked of JAX there."""
    kw = dict(k=6, nx=16, ny=14, nz=4, n_obs=30, **SYNTHETIC[name])
    case = synthetic_case.generate_case(str(tmp_path / "in"), **kw)
    jcase = jsynthetic.generate_case(str(tmp_path / "jin"), **kw)
    files = sorted(os.listdir(tmp_path / "in"))
    assert files == sorted(os.listdir(tmp_path / "jin")) and len(files) == 13
    for f in files:
        assert filecmp.cmp(tmp_path / "in" / f, tmp_path / "jin" / f,
                           shallow=False), f
    for field in ("truth_t", "obs_lon", "obs_lat"):
        assert np.array_equal(getattr(case, field), getattr(jcase, field))

    _run(cli.main, tmp_path / "in", tmp_path / "out", "--chunk", "256")
    _run(_jax_cli, tmp_path / "in", tmp_path / "jout", "--chunk", "256")
    _assert_outputs_close(tmp_path / "out", tmp_path / "jout",
                          tmp_path / "in", kw["k"], ("T", "QVAPOR"))
    scores = synthetic_case.score_case(case, str(tmp_path / "out"))
    assert scores == pytest.approx(
        jsynthetic.score_case(jcase, str(tmp_path / "jout")), rel=1e-4)
    if name == "wf0":
        assert scores["rmse_analysis"] < 0.7 * scores["rmse_prior"], scores
    else:
        assert scores["rmse_analysis"] < scores["rmse_prior"], scores


def _refused(argv, exc, match, tmp_path):
    """``main(argv)`` raises ``exc`` before it reads or writes anything."""
    missing = tmp_path / "no_such_input"
    with pytest.raises(exc, match=match):
        cli.main(["--input", str(missing), "--output",
                  str(tmp_path / "out")] + argv)
    assert not (tmp_path / "out").exists()


def test_no_card_raises_before_reading(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--platform", "gpu"], ["--platform", "cuda"]):
        _refused(argv, RuntimeError, "no CUDA device", tmp_path)
    _refused(["--platform", "tpu"], ValueError, "--platform", tmp_path)


@pytest.mark.parametrize("argv,match", [
    (["--distributed"], "torchrun's environment"),
    (["--distributed", "--platform", "cpu", "--coordinator",
      "127.0.0.1:1"], "--num-processes and --process-id"),
])
def test_unported_options_raise(tmp_path, monkeypatch, argv, match):
    """``--distributed`` without a complete rank, world size and address
    (torchrun's environment or the three flags) is refused before reading;
    the process group is never started."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    _refused(argv, ValueError, match, tmp_path)
    assert not torch.distributed.is_initialized()


def test_several_cards_raise_without_no_mesh(tmp_path, monkeypatch):
    """Several visible cards: no refusal any more; without ``--no-mesh``
    the CLI shards the points over an in-process mesh of the cards (as the
    JAX CLI does, cli.py:166-171), with it the update runs on one card."""
    from cwbnwp_letkf_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(pmesh, "device_kind", lambda d: "H100")
    for argv in ([], ["--no-mesh"]):
        args = cli.build_arg_parser().parse_args(argv)
        assert cli.select_device(args) == torch.device("cuda")
    meshes = []

    def run_analysis(cfg, ens, obs, *, mesh, **kw):
        meshes.append(mesh)
        raise _Stop

    monkeypatch.setattr(driver, "run_analysis", run_analysis)
    input_dir = tmp_path / "in"
    synthetic_case.generate_case(str(input_dir), **SMALL_CASE)
    for argv in ([], ["--no-mesh"]):
        with pytest.raises(_Stop):
            cli.main(["--input", str(input_dir), "--output",
                      str(tmp_path / "out"), "--quiet"] + argv)
    assert meshes[1] is None
    assert meshes[0].devices == (torch.device("cuda", 0),
                                 torch.device("cuda", 1))
    assert meshes[0].group is None
