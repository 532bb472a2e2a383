"""The port's device-time breakdown, its host constants and the rest of the
host layer, against the JAX package's, on the CPU.

``profiling.device_breakdown`` (tests/test_profiling.py, mirrored), the
breakdown through ``driver.run_analysis`` and ``cli.main
--device-breakdown``, the constants of ``constants.py``,
``obs.synthetic.toy_case`` and ``ops.dense.set_accum_precision``.
"""
import json

import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu import cli as jcli
from cwbnwp_letkf_tpu import config as jconfig
from cwbnwp_letkf_tpu import constants as jconstants
from cwbnwp_letkf_tpu import driver as jdriver
from cwbnwp_letkf_tpu.metrics import RunMetrics as JRunMetrics
from cwbnwp_letkf_tpu.models import state as jstate
from cwbnwp_letkf_tpu.obs import base as jbase
from cwbnwp_letkf_tpu.obs import synthetic as jsynthetic
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_torch import cli, config, constants, driver, ops
from cwbnwp_letkf_torch.metrics import RunMetrics
from cwbnwp_letkf_torch.models import state
from cwbnwp_letkf_torch.obs import base, synthetic
from cwbnwp_letkf_torch.ops import dense, eigh_kernel, ns_kernel, update
from cwbnwp_letkf_torch.profiling import device_breakdown

from .test_driver import NML
from .test_integration import _make_inputs
from .wrf_fixtures import make_wrf_ensemble

STAGES = ("localize_accumulate", "eigh", "weight_apply")


def _case(k=8, nobs=60):
    """tests/test_profiling.py::_case on the port's generators."""
    rng = np.random.default_rng(3)
    pts = synthetic.idealized_grid(12, 12, 4)
    truth, xb = synthetic.correlated_ensemble(rng, pts, k)
    st, po = synthetic.synthetic_gts_platform(rng, pts, truth, xb, nobs=nobs,
                                              max_lz_pts=16)
    return (torch.from_numpy(pts), torch.from_numpy(xb),
            [update.prepare_platform(st, po, device="cpu")])


def test_device_breakdown_stages_positive_and_additive():
    pts, xb, plats = _case()
    before = (dict(ns_kernel.LAUNCHES), dict(eigh_kernel.LAUNCHES))
    out = device_breakdown(xb, pts, plats, 0, sample=256, reps=1)
    assert (dict(ns_kernel.LAUNCHES), dict(eigh_kernel.LAUNCHES)) == before
    for s in STAGES:
        assert out[f"{s}_s"] > 0.0
        assert 0.0 <= out[f"{s}_frac"] <= 1.0
    assert out["total_s"] == pytest.approx(sum(out[f"{s}_s"] for s in STAGES))
    assert abs(sum(out[f"{s}_frac"] for s in STAGES) - 1.0) < 1e-9
    assert out["points"] == 256


def test_device_breakdown_caches_no_table():
    """The breakdown builds its dense tables for itself and drops them: a
    platform's cache, which the update reads, is left as it was."""
    pts, xb, plats = _case()
    cached = dict(plats[0].cache)
    device_breakdown(xb, pts, plats, 0, sample=64, reps=1)
    assert plats[0].cache.keys() == cached.keys()


def test_device_breakdown_requires_active_platform():
    pts, xb, _ = _case()
    with pytest.raises(ValueError, match="no active platform"):
        device_breakdown(xb, pts, [], 0, sample=64, reps=1)


@pytest.fixture(scope="module")
def driver_case(tmp_path_factory):
    """tests/test_driver.py's namelist on four 8x7x5 members and 25 synop
    records (the case of tests/test_torch_driver.py)."""
    k = 4
    d = tmp_path_factory.mktemp("breakdown")
    paths = make_wrf_ensemble(str(d), k, seed=7)
    cfg = config.LetkfConfig.from_namelist(NML.format(k=k))
    rng = np.random.default_rng(11)
    nobs = 25
    xyz = np.stack([rng.uniform(-2e4, 2e4, nobs), rng.uniform(-2e4, 2e4, nobs),
                    rng.uniform(0.0, 5e3, nobs)], 1)
    obs = rng.normal(0.0, 2.0, (5, nobs))
    hdxb = obs[:, :, None] + rng.normal(0.0, 1.0, (5, nobs, k))
    po = base.make_platform_obs(xyz, obs, hdxb,
                                rng.uniform(0.5, 1.5, (5, nobs)))
    return cfg, paths, po


def test_run_analysis_device_breakdown_keys_match_jax(driver_case):
    """``run_analysis(device_breakdown=True)``: the breakdown lands in the
    metrics under the JAX package's keys, with its own stage, and the
    analysis is the one without it."""
    cfg, paths, po = driver_case
    m = RunMetrics()
    ens = state.read_ensemble(paths, cfg)
    driver.run_analysis(cfg, ens, {"synop": po}, chunk=128, metrics=m,
                        device_breakdown=True, device="cpu")
    plain = state.read_ensemble(paths, cfg)
    driver.run_analysis(cfg, plain, {"synop": po}, chunk=128, device="cpu")
    for key in ("t", "qv", "w"):
        assert np.array_equal(ens.fields[key], plain.fields[key]), key

    jcfg = jconfig.LetkfConfig.from_namelist(NML.format(k=4))
    jm = JRunMetrics()
    jdriver.run_analysis(jcfg, jstate.read_ensemble(paths, jcfg),
                         {"synop": jbase.PlatformObs(**po._asdict())},
                         chunk=128, metrics=jm, device_breakdown=True)
    got, want = m.to_dict(), jm.to_dict()
    assert set(got) == set(want)
    assert set(got["device_breakdown"]) == set(want["device_breakdown"])
    assert list(got["stages_s"]) == list(want["stages_s"])
    assert "device_breakdown" in got["stages_s"]
    bd = got["device_breakdown"]
    assert bd["points"] == min(4096, got["groups"][0]["points"])
    assert all(bd[f"{s}_s"] > 0 for s in STAGES)
    assert "device_breakdown" not in RunMetrics().to_dict()


def test_cli_device_breakdown(tmp_path):
    """``--device-breakdown --platform cpu`` writes the JAX CLI's
    ``device_breakdown`` keys into ``--metrics-json``."""
    input_dir, _, _, _ = _make_inputs(tmp_path)
    common = ["--input", str(input_dir), "--quiet", "--chunk", "64",
              "--device-breakdown"]
    assert cli.main(common + ["--output", str(tmp_path / "out"),
                              "--platform", "cpu", "--metrics-json",
                              str(tmp_path / "m.json")]) == 0
    assert jcli.main(common + ["--output", str(tmp_path / "jout"),
                               "--no-mesh", "--metrics-json",
                               str(tmp_path / "jm.json")]) == 0
    got = json.loads((tmp_path / "m.json").read_text())
    want = json.loads((tmp_path / "jm.json").read_text())
    assert set(got["device_breakdown"]) == set(want["device_breakdown"])
    assert got["device_breakdown"]["total_s"] > 0
    assert "device_breakdown" in got["stages_s"]


@pytest.mark.parametrize("name", [
    "RadarType", "NUM_RADAR_INDEXES", "RADAR_NAMES", "GTS_NVAR",
    "GTS_VAR_NAMES", "ASSIMILABLE_GTS", "PI", "D2R", "R2D", "T0", "CV",
    "CVPM"])
def test_constants_equal_jax(name):
    got, want = getattr(constants, name), getattr(jconstants, name)
    if name == "RadarType":
        assert [(m.name, int(m)) for m in got] == [(m.name, int(m))
                                                    for m in want]
    elif isinstance(want, dict):
        assert {(k.name if hasattr(k, "name") else k): v
                for k, v in got.items()} == {
            (k.name if hasattr(k, "name") else k): v for k, v in want.items()}
    elif isinstance(want, tuple) and want and hasattr(want[0], "name"):
        assert [m.name for m in got] == [m.name for m in want]
    else:
        assert got == want


def test_toy_case_equals_jax():
    """The same seed gives the same arrays and platform in both packages."""
    for kw in (dict(), dict(seed=3, k=6, nx=10, ny=12, nz=4, nobs=40)):
        got = synthetic.toy_case(**kw)
        want = jsynthetic.toy_case(**kw)
        for x, y in zip(got[:3], want[:3]):
            assert np.array_equal(x, y)
        (st, po), = got[3]
        (jst, jpo), = want[3]
        assert st.name == jst.name and st.hclr == jst.hclr
        for name in po._fields:
            assert np.array_equal(getattr(po, name), getattr(jpo, name)), name


def test_set_accum_precision_refuses_as_jax():
    for name in ("high", "highest"):
        dense.set_accum_precision(name)
    dense.set_accum_precision("high")
    with pytest.raises(ValueError) as got:
        dense.set_accum_precision("bf16")
    with pytest.raises(ValueError) as want:
        jdense.set_accum_precision("bf16")
    assert str(got.value) == str(want.value)


def test_ops_exports_match_jax():
    from cwbnwp_letkf_tpu import ops as jops

    assert ops.__all__ == jops.__all__
    assert all(callable(getattr(ops, name)) for name in ops.__all__)
