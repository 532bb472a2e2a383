"""The port's run_analysis and the host modules under it, against the JAX
package's, on the same WRF member files, on the CPU.

The case of tests/test_driver.py: four 8x7x5 WSM5 members
(tests/wrf_fixtures.make_wrf_ensemble), 25 synop records, and T, P, QVAPOR
(one group) and W (its own point set).  Both packages read the same files
and the same observation arrays.  JAX runs its Newton-Schulz solve with full
float32 accumulation, which the port's plain versions reproduce.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu import config as jconfig
from cwbnwp_letkf_tpu import driver as jdriver
from cwbnwp_letkf_tpu.io.netcdf import NetcdfReader as JNetcdfReader
from cwbnwp_letkf_tpu.models import state as jstate
from cwbnwp_letkf_tpu.models import vcoord as jvcoord
from cwbnwp_letkf_tpu.obs import base as jbase
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.projection import LambertProjection as JLambert
from cwbnwp_letkf_torch import config, driver, metrics
from cwbnwp_letkf_torch.io.netcdf import NetcdfReader
from cwbnwp_letkf_torch.models import state, vcoord
from cwbnwp_letkf_torch.obs import base
from cwbnwp_letkf_torch.parallel import make_mesh
from cwbnwp_letkf_torch.parallel.multihost import member_block
from cwbnwp_letkf_torch.projection import LambertProjection

from .test_driver import NML
from .wrf_fixtures import make_wrf_ensemble, make_wrf_member

K = 4
CHUNK = 128
CPU = torch.device("cpu")
#: fields var_update analyzes, and fields nothing updates
UPDATED = ("t", "p", "qv", "w")
UNTOUCHED = ("u", "v", "ph", "mu", "psfc", "qr", "qs")
#: an analysis held against another solve of the same normal terms, in units
#: of the reference's increment max|xa_ref - xb| (tests/test_torch_cycle.py)
XA_RTOL = 5e-4
#: numpy's float32 trigonometry against XLA's: over 1e6 random points within
#: 8 degrees of the projection origin, x differs by at most 0.19 m and y by at
#: most 3 m (3 ulps of rh0 = 1.3e7 m, which y = rh0 - rh cos(..) cancels);
#: the limit is 4 ulps of rh0
XY_ULPS = 4

#: the inline namelist of tests/test_config.py:57-64 and a fuller one:
#: radar rows, repeats, Fortran double exponents, float64 and clean mode
NAMELISTS = {
    "driver": NML.format(k=K),
    "test_config": """
&control
 nmember = 4
 var_update = 'U', 'V'
 flags = 3*.true., F
/
""",
    "radar": """
&control
 nmember = 40
 var_update = 'U', 'V', 'T', 'QRAIN'
 wrf_mp_physics = 9
 norain_value = -7.5d0
/
&observations
 radar_nml % dbz % use_it = .true.
 radar_nml % dbz % max_lz_pts = 300
 radar_nml % dbz % error = 2.5
 radar_nml % dbz % hclr = 3*-1., 8.
 radar_nml % dbz % vclr = 3*-1., 2.
 radar_nml % vr % use_it = T
 radar_nml % vr % hclr = 36., 36., 24., -1.  ! trailing comment
 synop_nml % use_it = T
 synop_nml % hclr = 4*50.
 synop_nml % t % is_assim = T, T, T, F
/
&inflation
 multi_infl = 2*1.6, 1.1, 1.1
 use_rtpp = 4*T
 rtpp_alpha = 0.95
/
""",
}


@pytest.fixture(autouse=True)
def _ns_full_f32():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """``(cfg, jcfg, paths, obs, jobs)``: the port's and JAX's config and
    observations over the same member files."""
    d = tmp_path_factory.mktemp("driver")
    paths = make_wrf_ensemble(str(d), K, seed=7)
    cfg = config.LetkfConfig.from_namelist(NML.format(k=K))
    jcfg = jconfig.LetkfConfig.from_namelist(NML.format(k=K))
    proj = LambertProjection.from_config(cfg.projection)
    rng = np.random.default_rng(11)
    nobs = 25
    lat = rng.uniform(23.55, 23.85, nobs)
    lon = rng.uniform(119.85, 120.15, nobs)
    x, y = proj.lonlat_to_xy(lon, lat)
    xyz = np.stack([x, y, rng.uniform(0.0, 5e3, nobs)], 1)
    obs = rng.normal(0.0, 2.0, (5, nobs))
    hdxb = obs[:, :, None] + rng.normal(0.0, 1.0, (5, nobs, K))
    err = rng.uniform(0.5, 1.5, (5, nobs))
    po = base.make_platform_obs(xyz, obs, hdxb, err)
    return cfg, jcfg, paths, {"synop": po}, {
        "synop": jbase.PlatformObs(**po._asdict())}


def _port_run(case, cfg=None, fuse=True, ens=None, **kw):
    cfg0, _, paths, obs, _ = case
    cfg = cfg or cfg0
    ens = ens or state.read_ensemble(paths, cfg)
    return driver.run_analysis(cfg, ens, obs, chunk=CHUNK,
                               fuse_variables=fuse, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(case):
    """JAX's analysis in both branches, and the background."""
    _, jcfg, paths, _, jobs = case
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    try:
        out = {}
        for fuse in (True, False):
            ens = jstate.read_ensemble(paths, jcfg)
            jdriver.run_analysis(jcfg, ens, jobs, chunk=CHUNK,
                                 fuse_variables=fuse)
            out[fuse] = ens
    finally:
        jsolver.set_eigh_backend("auto")
        jdense.set_accum_precision("high")
    return out, jstate.read_ensemble(paths, jcfg)


def _assert_close_to(xa, ref, xb, what):
    """``max|xa - ref| <= XA_RTOL max|ref - xb|``."""
    incr = np.abs(ref - xb).max()
    assert incr > 0, f"{what}: not updated"
    np.testing.assert_allclose(xa, ref, rtol=0, atol=XA_RTOL * incr,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(NAMELISTS))
def test_namelist_parses_equal(name):
    text = NAMELISTS[name]
    assert config.parse_namelist(text) == jconfig.parse_namelist(text)
    cfg = config.LetkfConfig.from_namelist(text)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.LetkfConfig.from_namelist(text))
    for c in (cfg, cfg.replace(solver_dtype="float64",
                               replicate_stagger_quirk=False)):
        assert dataclasses.asdict(c) == dataclasses.asdict(
            jconfig.LetkfConfig.from_namelist(text).replace(
                solver_dtype=c.solver_dtype,
                replicate_stagger_quirk=c.replicate_stagger_quirk))
    with pytest.raises(ValueError):
        config.LetkfConfig()


@pytest.mark.parametrize("name", ["driver", "radar"])
def test_platform_statics_and_groups_equal(name):
    text = NAMELISTS[name]
    cfg = config.LetkfConfig.from_namelist(text)
    jcfg = jconfig.LetkfConfig.from_namelist(text)
    statics = base.platform_statics_from_config(cfg)
    jstatics = jbase.platform_statics_from_config(jcfg)
    assert [dataclasses.asdict(s) for s in statics] == [
        dataclasses.asdict(s) for s in jstatics]
    assert statics

    class _Dp:
        def __init__(self, st):
            self.static = st

    groups = driver._group_variables(cfg, [_Dp(s) for s in statics])
    jgroups = jdriver._group_variables(jcfg, [_Dp(s) for s in jstatics])
    assert groups == jgroups and groups


def _morrison_members(d, k=2):
    """tests/test_state_io.py:91-119: 2-moment members with the base-state
    scalars the dry-air density needs."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(7)
    paths = []
    for m in range(k):
        p = str(d / f"wrfinput_nc_{m + 1:03d}")
        make_wrf_member(p, rng, mp_vars=("QRAIN", "QSNOW", "QGRAUP",
                                         "QNRAIN", "QNSNOW", "QNGRAUPEL"))
        f = netcdf_file(p, "a", version=2)
        nz = 5
        for name, val in [("T00", 290.0), ("P00", 1e5), ("TLP", 50.0),
                          ("TISO", 0.0), ("P_STRAT", 0.0),
                          ("TLP_STRAT", -11.0), ("P_TOP", 5e3)]:
            v = f.createVariable(name, np.float32, ("Time",))
            v[:] = np.array([val], np.float32)
        znw = f.createVariable("ZNW", np.float32, ("Time", "bottom_top_stag"))
        znw[:] = np.linspace(1, 0, nz + 1)[None].astype(np.float32)
        znu = f.createVariable("ZNU", np.float32, ("Time", "bottom_top"))
        znu[:] = ((znw[0][1:] + znw[0][:-1]) * 0.5)[None].astype(np.float32)
        f.flush()
        f.close()
        paths.append(p)
    return paths


@pytest.mark.parametrize("scheme", ["wsm5", "morrison"])
def test_read_ensemble_equal(case, tmp_path, scheme):
    if scheme == "wsm5":
        cfg, jcfg, paths = case[:3]
    else:
        paths = _morrison_members(tmp_path)
        kw = dict(nmember=2, var_update=("T",), wrf_mp_physics=10,
                  wrf_mp_hail_opt=0, wrf_hypsometric_opt=2)
        cfg, jcfg = config.LetkfConfig(**kw), jconfig.LetkfConfig(**kw)
    ens = state.read_ensemble(paths, cfg)
    jens = jstate.read_ensemble(paths, jcfg)
    assert (ens.nx, ens.ny, ens.nz, ens.k) == (jens.nx, jens.ny, jens.nz,
                                               jens.k)
    assert dataclasses.asdict(ens.mp) == dataclasses.asdict(jens.mp)
    assert set(ens.fields) == set(jens.fields)
    for key in ens.fields:
        assert np.array_equal(ens.fields[key], jens.fields[key]), key
    for name in ("pb", "phb", "mub", "xlat", "xlon", "xlat_u", "xlon_u",
                 "xlat_v", "xlon_v", "hgt"):
        assert np.array_equal(getattr(ens, name), getattr(jens, name)), name
    if scheme == "morrison":
        assert ens.rhoa is not None and np.array_equal(ens.rhoa, jens.rhoa)
    else:
        assert ens.rhoa is None and jens.rhoa is None


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("hstag,vstag", [(0, 0), (1, 0), (2, 0), (0, 1),
                                         (0, -1)])
def test_analysis_points_equal(case, hstag, vstag, quirk):
    cfg, jcfg, paths = case[:3]
    ens = state.read_ensemble(paths, cfg)
    jens = jstate.read_ensemble(paths, jcfg)
    proj = LambertProjection.from_config(cfg.projection)
    z_w = vcoord.mean_geopotential_height(ens)
    jz_w = jvcoord.mean_geopotential_height(jens)
    assert np.array_equal(z_w, jz_w)
    pts, dims = vcoord.analysis_points(ens, proj, hstag, vstag, z_w,
                                       quirk=quirk)
    jpts, jdims = jvcoord.analysis_points(
        jens, JLambert.from_config(jcfg.projection), hstag, vstag, jz_w,
        quirk=quirk)
    assert dims == jdims and pts.shape == jpts.shape
    assert pts.dtype == jpts.dtype == np.float32
    assert np.array_equal(pts[:, 2], jpts[:, 2])
    tol = XY_ULPS * float(np.spacing(np.float32(proj.rh0)))
    np.testing.assert_allclose(pts[:, :2], jpts[:, :2], rtol=0, atol=tol)


@pytest.mark.parametrize("fuse", [True, False])
def test_run_analysis_matches_jax(case, jax_runs, fuse):
    jruns, jxb = jax_runs
    ens = _port_run(case, fuse=fuse)
    for key in UPDATED:
        _assert_close_to(ens.fields[key], jruns[fuse].fields[key],
                         jxb.fields[key], f"{key} (fuse={fuse})")
    for key in UNTOUCHED:
        assert np.array_equal(ens.fields[key], jruns[fuse].fields[key]), key
        assert np.array_equal(ens.fields[key], jxb.fields[key]), key


@pytest.mark.parametrize("solver_dtype,rtol", [("float32", 2e-5),
                                               ("float64", 1e-8)])
def test_fused_matches_per_variable(case, solver_dtype, rtol):
    """tests/test_driver.py:76-95 on the port, and in float64 at the float64
    tolerance of tests/test_torch_update.py: the fused cycle solves in the
    configured dtype as the per-variable loop does."""
    cfg = case[0].replace(solver_dtype=solver_dtype)
    paths = case[2]
    ens_a = _port_run(case, cfg, fuse=True)
    ens_b = _port_run(case, cfg, fuse=False)
    xb = state.read_ensemble(paths, cfg)
    for key in UPDATED:
        a, b = ens_a.fields[key], ens_b.fields[key]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol, err_msg=key)
        assert not np.array_equal(a, xb.fields[key]), f"{key} not updated"


def test_run_metrics_populated(case):
    """tests/test_driver.py:98-113 on the port."""
    m = metrics.RunMetrics()
    _port_run(case, metrics=m)
    d = m.to_dict()
    assert d["platforms"] and d["platforms"][0]["name"] == "synop"
    assert d["platforms"][0]["records"] == 25
    assert 0.0 < d["platforms"][0]["acceptance_rate"] <= 1.0
    assert len(d["groups"]) == 2  # T+P+QVAPOR fused, W separate
    assert d["total_var_points"] > 0
    assert d["var_points_per_s"] > 0
    assert set(d["stages_s"]) == {"prepare_platforms", "plan_groups",
                                  "update"}
    assert all(g["bucket_overflow"] == 0 and g["ns_residual"] <= 1e-4
               for g in d["groups"])
    # each group's wall is its own launch and drain, inside the update stage
    assert 0 < sum(g.wall_s for g in m.groups) <= m.stages["update"]
    assert all(0 <= g.load_s <= g.wall_s for g in m.groups)


def _read_file(reader, path):
    with reader(str(path)) as nc:
        return {n: nc.get_variable(n) for n in nc.variable_names()
                if n != "Times"}


def test_write_ensemble_files_agree(case, jax_runs, tmp_path):
    """Both packages' analysis files: the analysis fields within XA_RTOL of
    the JAX increment, everything else equal; the port's files read back
    equal to its in-memory analysis."""
    jruns, _ = jax_runs
    paths = case[2]
    ens = _port_run(case)
    out = [tmp_path / f"port_{m}" for m in range(K)]
    jout = [tmp_path / f"jax_{m}" for m in range(K)]
    state.write_ensemble(ens, [str(p) for p in out])
    jstate.write_ensemble(jruns[True], [str(p) for p in jout])
    for m in range(K):
        got = _read_file(NetcdfReader, out[m])
        want = _read_file(JNetcdfReader, jout[m])
        prior = _read_file(JNetcdfReader, paths[m])
        assert set(got) == set(want)
        for name in got:
            if name in ("T", "P", "QVAPOR", "W"):
                _assert_close_to(got[name], want[name], prior[name],
                                 f"member {m} {name}")
            else:
                assert np.array_equal(got[name], want[name]), (m, name)
        assert np.array_equal(got["T"], ens.fields["t"][..., m])


def test_streaming_matches_eager(case, tmp_path):
    """tests/test_streaming.py:24-62 on the port, file for file, with its
    tolerances (the eager path round-trips P/PH/MU through float32
    full = pert + base)."""
    cfg, _, paths = case[:3]
    eager = _port_run(case)
    out_e = [str(tmp_path / f"eager_{m}") for m in range(K)]
    state.write_ensemble(eager, out_e)
    out_s = [str(tmp_path / f"stream_{m}") for m in range(K)]
    _port_run(case, ens=state.StreamingWrfEnsemble(paths, cfg, out_s))
    base_atol = {"MU": 0.05, "P": 0.05, "PH": 0.05}
    for m in range(K):
        e = _read_file(NetcdfReader, out_e[m])
        s = _read_file(NetcdfReader, out_s[m])
        assert set(e) == set(s)
        for name in e:
            np.testing.assert_allclose(s[name], e[name], rtol=1e-6,
                                       atol=base_atol.get(name, 1e-6),
                                       err_msg=f"member {m} {name}")


@pytest.mark.parametrize("kw,match", [
    (dict(distributed=True, fuse=False), "fused path only"),
    (dict(distributed=True), "requires a global mesh"),
    (dict(accum_precision="bf16"), "accum_precision"),
])
def test_refusals(case, kw, match):
    """The JAX package's refusals (its driver.py:146-157): ``distributed=True``
    without a mesh, and on a mesh without the fused path."""
    cfg, kw = case[0], dict(kw)
    if "accum_precision" in kw:
        cfg = cfg.replace(accum_precision=kw.pop("accum_precision"))
    fuse = kw.pop("fuse", True)
    if not fuse:
        kw["mesh"] = make_mesh([CPU] * 2)
    with pytest.raises(ValueError, match=match):
        _port_run(case, cfg, fuse=fuse, **kw)


@pytest.mark.parametrize("fuse", [True, False])
def test_run_analysis_on_a_cpu_mesh(case, fuse):
    """``run_analysis(mesh=...)`` in both branches: three CPU shards, with
    per-shard budgets, within the 3e-5 of tests/test_sharding.py of the
    single-device run; the mesh is recorded in the metrics."""
    m = metrics.RunMetrics()
    ens = _port_run(case, fuse=fuse, mesh=make_mesh([CPU] * 3), metrics=m)
    ref = _port_run(case, fuse=fuse)
    for key in UPDATED:
        np.testing.assert_allclose(ens.fields[key], ref.fields[key],
                                   rtol=3e-5, atol=3e-5, err_msg=key)
    for key in UNTOUCHED:
        assert np.array_equal(ens.fields[key], ref.fields[key]), key
    n_points = ens.nx * ens.ny * ens.nz
    assert m.to_dict()["mesh_layout"] == {
        "devices": 3, "axes": {"grid": 3},
        "points_per_device": -(-n_points // 3), "device_kinds": ["cpu"]}
    if fuse:
        assert all(g.bucket_overflow == 0 for g in m.groups)


def test_record_mesh_matches_jax():
    import jax

    from cwbnwp_letkf_tpu import metrics as jmetrics
    from cwbnwp_letkf_tpu.parallel import make_mesh as jmake_mesh

    for n, n_points in ((8, 1000), (2, 7)):
        m, jm = metrics.RunMetrics(), jmetrics.RunMetrics()
        m.record_mesh(make_mesh([CPU] * n), n_points)
        jm.record_mesh(jmake_mesh(jax.devices()[:n]), n_points)
        assert m.mesh_layout == jm.mesh_layout
        assert m.to_dict()["mesh_layout"] == jm.to_dict()["mesh_layout"]


def test_distributed_in_process_mesh_equals_sharded(case, tmp_path):
    """``distributed=True`` on an in-process mesh (one process owns every
    member, the transposes split and join rows) writes the files of the
    sharded run on the same mesh, bit for bit."""
    cfg, _, paths = case[:3]
    mesh = make_mesh([CPU] * 2)
    out = {}
    for dist_ in (False, True):
        outs = [str(tmp_path / f"{dist_}_{m}") for m in range(K)]
        ens = state.StreamingWrfEnsemble(
            paths, cfg, outs, members=member_block(K, mesh))
        _port_run(case, ens=ens, mesh=mesh, distributed=dist_)
        out[dist_] = [_read_file(NetcdfReader, p) for p in outs]
    for m in range(K):
        for name, arr in out[False][m].items():
            assert np.array_equal(out[True][m][name], arr), (m, name)


def test_accum_precision_names_run_full_float32(case):
    """"high" and "highest" both accumulate in full float32 on the port."""
    a = _port_run(case, case[0].replace(accum_precision="high"))
    b = _port_run(case, case[0].replace(accum_precision="highest"))
    for key in UPDATED:
        assert np.array_equal(a.fields[key], b.fields[key]), key
