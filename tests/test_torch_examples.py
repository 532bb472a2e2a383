"""The port's ``examples/`` drives against the JAX package's, on the CPU.

Every drive runs with ``device="cpu"`` / ``--platform cpu`` (the kernels'
plain versions) and is held against the JAX package on the same seeded
inputs: the bench case bit for bit with ``bench.build_case()``, the WRF and
CLI-drive cases byte for byte with the JAX package's, each stage of
``profile_cycle`` and ``profile_groups`` against the same stage composed
from the JAX package's parts (on a 2,048-point dense-plus-bucketed case,
k=8, chunk 512, subchunk 128; both packages start from the same per-obs
statistics, as tests/test_torch_accum.py does), and the analyses of
``gpu_drive`` and ``run_synthetic_cycle`` against JAX's update and CLI.
JAX runs its Newton-Schulz solve with full float32 accumulation.
"""
import dataclasses
import filecmp
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from cwbnwp_letkf_tpu.obs import base as jbase
from cwbnwp_letkf_tpu.ops import neighbors as jneighbors
from cwbnwp_letkf_tpu.ops import cycle as jcycle
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops import update as jupdate
from cwbnwp_letkf_torch import examples
from cwbnwp_letkf_torch.examples import (bench_case, gpu_cli_drive, gpu_drive,
                                         memory_bench, profile_cycle,
                                         profile_groups, run_synthetic_cycle,
                                         wrf_case)
from cwbnwp_letkf_torch.ops import cycle, dense, update, whiten

from . import wrf_fixtures
from .test_torch_cli import _assert_outputs_close, _jax_cli
from .torch_parity import (assert_ns_close, cycle_case, group_fields,
                           one_torch_thread, to_port)  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
K_SMALL, CHUNK, SUB = 8, 512, 128
#: the groups of tests/torch_parity.py's GROUPS_SPEC in the small case
SMALL_GROUPS = (0, 3, 4)
#: a cap no candidate set reaches
NO_CAP = 10 ** 6
#: the per-term tolerance of the accumulated normal terms
#: (tests/test_torch_accum.py), summed over the terms
ACC_RTOL = 1e-5
TERMS = dense.terms_from_r2


@pytest.fixture(autouse=True)
def _backends():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


# ---------------------------------------------------------------- the cases

@pytest.fixture(scope="module")
def port_bench():
    return bench_case.build_case()


def _assert_plats_equal(got, want_port):
    assert len(got) == len(want_port)
    for (st, po), (wst, wpo) in zip(got, want_port):
        assert st == wst
        for name in po._fields:
            a, b = getattr(po, name), getattr(wpo, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_bench_case_equals_jax_bench(port_bench):
    pts, xb, plats = port_bench
    jpts, jxb, jplats = bench.build_case()
    assert pts.dtype == jpts.dtype and np.array_equal(pts, jpts)
    assert xb.dtype == jxb.dtype and np.array_equal(xb, jxb)
    assert pts.shape == (327680, 3) and xb.shape == (327680, bench.K)
    _assert_plats_equal(plats, [to_port(st, po) for st, po in jplats])
    for name in ("K", "N_VARS", "HYDRO", "PROD_GROUPS", "MULTI_INFL", "RTPP",
                 "RTPS"):
        assert getattr(bench_case, name) == getattr(bench, name), name
    assert ([tuple(g) for g in bench_case.prod_cycle_groups()]
            == [tuple(g) for g in bench._prod_cycle_groups()])
    assert all(type(g) is cycle.CycleGroup
               for g in bench_case.prod_cycle_groups())


def test_chip_smoke_bench_case_equals_build_case(port_bench):
    """``chip_smoke.bench_case`` (which also returns the truth) and
    :func:`bench_case.build_case` cannot drift apart."""
    pts, xb, plats = port_bench
    cpts, _, cxb, cplats = chip_smoke.bench_case(np.random.default_rng(0), 20)
    assert np.array_equal(cpts, pts) and np.array_equal(cxb, xb)
    _assert_plats_equal(cplats, plats)


def _same_files(a, b):
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and files
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f
    return files


@pytest.mark.parametrize("kw", [{}, dict(nx=6, ny=9, nz=3, dlat=0.02,
                                         mp_vars=("QRAIN",))])
def test_make_wrf_ensemble_writes_jax_bytes(tmp_path, kw):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = wrf_case.make_wrf_ensemble(str(tmp_path / "p"), 3, seed=2, **kw)
    want = wrf_fixtures.make_wrf_ensemble(str(tmp_path / "j"), 3, seed=2, **kw)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert len(_same_files(tmp_path / "p", tmp_path / "j")) == 3


def test_cli_drive_case_writes_jax_bytes(tmp_path, monkeypatch):
    from examples import tpu_cli_drive as jdrive

    sizes = dict(K=3, NX=12, NY=10, NZ=4, N_VR=600)
    for name, value in sizes.items():
        monkeypatch.setattr(jdrive, name, value)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    gpu_cli_drive.build_case(str(tmp_path / "p"), k=3, nx=12, ny=10, nz=4,
                             n_vr=600)
    jdrive.build_case(str(tmp_path / "j"))
    files = _same_files(tmp_path / "p", tmp_path / "j")
    assert len(files) == 3 * 3 + 1
    assert gpu_cli_drive.NML == jdrive.NML
    assert ((gpu_cli_drive.K, gpu_cli_drive.NX, gpu_cli_drive.NY,
             gpu_cli_drive.NZ, gpu_cli_drive.N_VR)
            == (24, 64, 64, 16, 30_000))


def test_memory_bench_case_writes_jax_bytes(tmp_path, monkeypatch):
    # the JAX script inserts into sys.path at import; restored after
    monkeypatch.setattr(sys, "path", list(sys.path))
    from examples import memory_bench as jbench

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    memory_bench.build_case(str(tmp_path / "p"), 10, 8, 3, 3)
    jbench.build_case(str(tmp_path / "j"), 10, 8, 3, 3)
    assert len(_same_files(tmp_path / "p", tmp_path / "j")) == 2 * 3 + 1
    assert memory_bench.NML == jbench.NML


# ------------------------------------------------------------ profile_cycle

def _shared_platforms(plats, cap=None):
    """JAX and port device platforms over the same per-obs statistics
    (JAX's, copied): independent float32 member means near 290 differ by
    their summation order alone."""
    jplats, tplats = [], []
    for st, po in plats:
        if cap is not None:
            st = dataclasses.replace(st, max_lz_pts=cap)
        jdp = jupdate.prepare_platform(st, po)
        tst, tpo = to_port(st, po)
        stats = whiten.ObsStats(*(torch.from_numpy(np.array(x))
                                  for x in jdp.stats))
        jplats.append(jdp)
        tplats.append(update.DevicePlatform(
            static=tst, xyz=torch.from_numpy(tpo.xyz), stats=stats, cache={}))
    return jplats, tplats


@pytest.fixture(scope="module")
def small():
    """2,048 points at 100 km (4 chunks of 512), synop 300 records (dense,
    with a cap of 2 that binds at many points) and vr 9,000 (bucketed), k=8.
    vr's cap is lifted: on the CPU the multisection over a subchunk's
    bucketed candidates takes seconds (tests/test_torch_cycle.py holds it
    against JAX); synop's runs the same function."""
    pts, xb_v, plats = cycle_case(nx=32, nz=2, k=K_SMALL, dx_m=100e3)
    assert plats[1][1].nrec >= update.BUCKET_MIN_RECORDS
    assert pts.shape[0] == 4 * CHUNK
    caps = {"synop": 2, "vr": NO_CAP}
    plats = [(dataclasses.replace(st, max_lz_pts=caps[st.name]), po)
             for st, po in plats]
    return pts, xb_v[:, 0], plats


def _groups(module):
    """The (U, V) group, the 2-D group and the group no platform feeds of
    tests/torch_parity.py: two inflation values, so two stacked solves."""
    fields = group_fields(K_SMALL)
    return [module.CycleGroup(*fields[i]) for i in SMALL_GROUPS]


def _port_stages(small, cap=None):
    pts, xb, plats = small
    _, tplats = _shared_platforms(plats, cap)
    groups = _groups(cycle)
    q = torch.from_numpy(pts)
    budgets = cycle.plan_cycle_budgets(q, tplats, groups, chunk=CHUNK,
                                       subchunk=SUB)
    stages = profile_cycle.make_stages(
        torch.from_numpy(xb), q, tplats, groups, budgets=budgets, chunk=CHUNK,
        subchunk=SUB)
    return stages, tplats, groups, budgets


@pytest.fixture(scope="module")
def port(small):
    """The port's stages on the small case, and one run of each."""
    stages, tplats, groups, budgets = _port_stages(small)
    results = {name: fn() for name, fn in stages.items()}
    _assert_terms_restored()
    return stages, tplats, groups, budgets, results


def _assert_terms_restored():
    assert cycle.terms_from_r2 is TERMS and dense.terms_from_r2 is TERMS


def test_profile_cycle_full_cycle(small, port):
    pts, xb, plats = small
    _, tplats, groups, budgets, results = port
    b = pts.shape[0]
    v_tot = sum(len(g.ivars) for g in groups)
    xa = results["full_cycle"]
    xb_v = np.broadcast_to(xb[:, None, :], (b, v_tot, K_SMALL))
    ref = cycle.update_points_cycle(
        torch.from_numpy(np.ascontiguousarray(xb_v)), torch.from_numpy(pts),
        tplats, groups, weight_function=0, chunk=CHUNK, subchunk=SUB,
        max_blocks=budgets)
    assert torch.equal(xa, ref)
    jplats, _ = _shared_platforms(plats)
    jgroups = _groups(jcycle)
    jb = jcycle.plan_cycle_budgets(jnp.asarray(pts), jplats, jgroups,
                                   chunk=CHUNK, subchunk=SUB)
    assert jb == budgets
    xa_j = np.asarray(jcycle.update_points_cycle(
        jnp.asarray(xb_v), jnp.asarray(pts), jplats, jgroups,
        weight_function=0, chunk=CHUNK, subchunk=SUB, max_blocks=jb))
    np.testing.assert_allclose(xa.numpy(), xa_j, rtol=0,
                               atol=5e-4 * np.abs(xa_j).max())
    assert not np.array_equal(xa[:, 0].numpy(), xb)
    np.testing.assert_array_equal(xa[:, -1].numpy(), xb)   # no platform


def _jax_budgets(budgets):
    """The port's planned budgets as the JAX package's (the two planners
    agree: tests/test_torch_cycle.py, tests/test_torch_update.py)."""
    return {n: jupdate.BucketBudget(*bb) for n, bb in budgets.items()}


def _jax_accum_sums(pts, plats, k, budgets):
    """``(sums [3, G], sums of |terms| [3, G])`` of a, g and count: the
    accumulation of the JAX drive (examples/profile_cycle.py:99-135),
    composed from ``_resolve_plans``, ``_dense_cycle_terms`` and
    ``_bucketed_cycle_terms`` per subchunk, summed in float64.  Op by op:
    under ``jax.jit`` XLA fuses the cap threshold's interpolation, which
    moves a record tied at the cap (tests/test_torch_accum.py)."""
    jplats, _ = _shared_platforms(plats)
    jgroups = _groups(jcycle)
    q = jnp.asarray(pts)
    plans = jcycle._resolve_plans(jplats, jgroups, method="auto",
                                  solver_dtype=jnp.float32,
                                  max_blocks=_jax_budgets(budgets))
    perm = jcycle._cycle_point_perm(q, plans, "auto")
    if perm is not None:
        q = q[perm]
    n_groups = len(jgroups)
    sums = np.zeros((3, n_groups))
    mags = np.zeros((3, n_groups))
    for s0 in range(0, q.shape[0], SUB):
        qs = q[s0:s0 + SUB]
        a_all = np.zeros((n_groups, SUB, k, k), np.float32)
        g_all = np.zeros((n_groups, SUB, k), np.float32)
        c_all = np.zeros((n_groups, SUB), np.int64)
        for plan in plans:
            if plan.kind == "bucketed":
                outs, _ = jcycle._bucketed_cycle_terms(qs, plan, jgroups, 0,
                                                       jnp.float32)
            else:
                outs = jcycle._dense_cycle_terms(qs, plan, jgroups, 0,
                                                 jnp.float32)
            for ci, gi in enumerate(plan.clients):
                a_p, g_p, c_p = outs[ci]
                a_all[gi] += np.asarray(a_p)
                g_all[gi] += np.asarray(g_p)
                c_all[gi] += np.asarray(c_p)
        for i, x in enumerate((a_all, g_all, c_all)):
            x = x.reshape(n_groups, -1).astype(np.float64)
            sums[i] += x.sum(1)
            mags[i] += np.abs(x).sum(1)
    return sums, mags


def test_profile_cycle_accum_matches_jax(small, port):
    pts, _, plats = small
    a, g, cnt = port[4]["accum_only"]
    sums, mags = _jax_accum_sums(pts, plats, K_SMALL, port[3])
    np.testing.assert_array_equal(cnt.numpy(), sums[2])
    for got, want, mag in ((a, sums[0], mags[0]), (g, sums[1], mags[1])):
        np.testing.assert_allclose(got.numpy(), want, rtol=ACC_RTOL,
                                   atol=ACC_RTOL * mag.max())
    assert cnt[:-1].min() > 0 and int(cnt[-1]) == 0   # the group no one feeds
    _assert_terms_restored()


def test_profile_cycle_nocap_and_cull(small, port):
    """Lifting the cap adds records where it binds and nothing where it does
    not; the cheap terms count one per point, group and platform."""
    pts = small[0]
    _, tplats, groups, _, results = port
    cnt, cnt_nocap = results["accum_only"][2], results["accum_nocap"][2]
    assert (cnt_nocap >= cnt).all() and int(cnt_nocap.sum()) > int(cnt.sum())
    a_c, g_c, cnt_c = results["cull_only"]
    feeds = [sum(dp.static.active(grp.ivars[0]) for dp in tplats)
             for grp in groups]
    np.testing.assert_array_equal(cnt_c.numpy(),
                                  np.array(feeds) * pts.shape[0])
    assert bool(torch.isfinite(a_c).all()) and not g_c.any()

    # with no cap that can bind, the two stages are the same computation
    lifted = _port_stages(small, cap=NO_CAP)[0]
    out, out_nocap = lifted["accum_only"](), lifted["accum_nocap"]()
    for x, y in zip(out, out_nocap):
        assert torch.equal(x, y)


def test_profile_cycle_restores_terms_on_error(small, monkeypatch):
    stages = _port_stages(small)[0]
    seen = []

    def fail(*args, **kwargs):
        seen.append(cycle.terms_from_r2)
        raise RuntimeError("made to fail")

    monkeypatch.setattr(cycle, "accumulate_chunk", fail)
    for name in ("accum_nocap", "cull_only"):
        with pytest.raises(RuntimeError, match="made to fail"):
            stages[name]()
        _assert_terms_restored()
    assert seen[0] not in (TERMS, profile_cycle.cheap_terms)
    assert seen[1] is profile_cycle.cheap_terms


def test_profile_cycle_solve_and_ns_match_jax(small, port):
    """The solve stages' per-chunk bodies against JAX's
    ``letkf_solve_cycle_from_normal`` and ``_ns_z`` on the same synthetic
    terms (examples/profile_cycle.py:159-205), at the tolerances of
    tests/test_torch_solver.py; each stage's total is its bodies' sum."""
    _, xb, _ = small
    groups, results = port[2], port[4]
    jgroups = _groups(jcycle)
    xbc = torch.from_numpy(xb[:CHUNK])
    a = profile_cycle.synthetic_normal(xbc).numpy()
    n_groups = len(groups)

    outs, diag = profile_cycle.solve_chunk(xbc, groups)
    outs_j, diag_j = jsolver.letkf_solve_cycle_from_normal(
        [jnp.asarray(a)] * n_groups,
        [jnp.ones((CHUNK, K_SMALL), jnp.float32)] * n_groups,
        [jnp.broadcast_to(jnp.asarray(xb[:CHUNK])[:, None, :],
                          (CHUNK, len(g.ivars), K_SMALL)) for g in jgroups],
        [g.inflats for g in jgroups], [jnp.ones((CHUNK,), bool)] * n_groups,
        rtpp_alpha_groups=[g.rtpp_alpha for g in jgroups],
        rtps_alpha_groups=[g.rtps_alpha for g in jgroups],
        solver_dtype=jnp.float32, return_diagnostics=True)
    assert float(diag["ns_residual"]) <= 1e-4
    assert float(diag_j["ns_residual"]) <= 1e-4
    for gi in range(n_groups):
        want = np.asarray(outs_j[gi])
        np.testing.assert_allclose(outs[gi].numpy(), want, rtol=0,
                                   atol=5e-4 * np.abs(want).max())

    zs = profile_cycle.ns_chunk(xbc, groups)
    assert len(zs) == 2                       # two inflation values
    for val, z in zs.items():
        n = sum(val in map(float, g.inflats) for g in groups)
        stack = np.concatenate([a] * n)
        assert z.shape == (n * CHUNK, K_SMALL, K_SMALL)
        z_j, _ = jsolver._ns_z(jnp.asarray(stack), val)
        assert_ns_close(z.numpy(), np.asarray(z_j), stack, val)

    x = torch.from_numpy(xb)
    solve_tot = sum(torch.cat(profile_cycle.solve_chunk(x[c0:c0 + CHUNK],
                                                        groups)[0], 1)
                    .sum(dtype=torch.float64)
                    + profile_cycle.solve_chunk(x[c0:c0 + CHUNK],
                                                groups)[1]["ns_residual"]
                    for c0 in range(0, x.shape[0], CHUNK))
    ns_tot = sum(z[:, 0, 0].sum(dtype=torch.float64)
                 for c0 in range(0, x.shape[0], CHUNK)
                 for z in profile_cycle.ns_chunk(x[c0:c0 + CHUNK],
                                                 groups).values())
    torch.testing.assert_close(results["solve_only"], solve_tot,
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(results["ns_only"], ns_tot, rtol=1e-12, atol=0)


def test_profile_cycle_record(small):
    """``profile`` writes the keys of the JAX drive's record
    (PROFILE_CYCLE_r05.json) plus the device, the repetitions and the
    Newton-Schulz kernel's launches (none on the CPU); on one chunk."""
    pts, xb, plats = small
    _, tplats = _shared_platforms(plats)
    out = profile_cycle.profile(
        torch.from_numpy(xb[:CHUNK]), torch.from_numpy(pts[:CHUNK]), tplats,
        _groups(cycle), chunk=CHUNK, subchunk=SUB, reps=1)
    want = json.loads((ROOT / "PROFILE_CYCLE_r05.json").read_text())
    assert set(out) == set(want) | {"device", "reps", "k1_launches"}
    assert set(out["derived"]) == set(want["derived"])
    assert out["device"] == "cpu" and out["points"] == CHUNK
    assert out["n_vars"] == 4 and out["k"] == K_SMALL
    assert out["k1_launches"] == dict.fromkeys(profile_cycle.STAGES, 0)
    assert all(out[s + "_s"] > 0 for s in profile_cycle.STAGES)
    assert out["derived"]["gather_distance_s"] == out["cull_only_s"]
    assert out["derived"]["solve_s"] == round(
        out["full_cycle_s"] - out["accum_only_s"], 4)
    _assert_terms_restored()


def test_table_k():
    for k in (1, 8, 40, 96):
        assert profile_cycle.table_k(k * (k + 1)) == k


# ----------------------------------------------------------- profile_groups

def test_profile_groups_matches_jax(small):
    """The accumulation against JAX's ``_accumulate_chunk`` chunk by chunk
    (examples/profile_groups.py:83-106), and the solve from those terms
    equal to the full group update; on the first two chunks."""
    pts, xb, plats = small[0][:2 * CHUNK], small[1][:2 * CHUNK], small[2]
    jplats, tplats = _shared_platforms(plats)
    ivars = bench_case.PROD_GROUPS[0][1]
    iv0 = ivars[0]
    q = torch.from_numpy(pts)
    budgets = update.plan_max_blocks(q, tplats, iv0, chunk=CHUNK)
    perm, terms = profile_groups.accumulate(q, tplats, iv0, budgets=budgets,
                                            chunk=CHUNK, k=K_SMALL)

    qj = jnp.asarray(pts)
    jb = _jax_budgets(budgets)
    act = [(dp, jneighbors.normalize_coords(dp.xyz, dp.static.hclr[iv0],
                                           dp.static.vclr[iv0]))
           for dp in jplats if dp.static.active(iv0) and dp.xyz.shape[0] > 0]
    kinds = [jupdate._resolve_kind("auto", dp) for dp, _ in act]
    perm_j, _ = jupdate._maybe_morton_perm(qj, "auto", act, kinds, iv0)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    qj = qj[perm_j]
    n_chunks = pts.shape[0] // CHUNK
    accs = jupdate._platform_accumulators(
        act, kinds, iv0, jb, jnp.float32,
        q_chunks=qj.reshape(n_chunks, CHUNK, 3))
    assert len(terms) == n_chunks
    for ci, (a, g, cnt) in enumerate(terms):
        a_j, g_j, c_j, _ = jupdate._accumulate_chunk(
            qj[ci * CHUNK:(ci + 1) * CHUNK], accs, iv0, 0, jnp.float32,
            CHUNK, K_SMALL)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(c_j))
        for got, want in ((a, a_j), (g, g_j)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=ACC_RTOL,
                                       atol=ACC_RTOL * np.abs(want).max())

    kw = profile_groups.group_args(ivars, K_SMALL)
    xb_v = torch.from_numpy(xb)[:, None, :].expand(-1, len(ivars), K_SMALL)
    xa = profile_groups.solve(xb_v, perm, terms, **kw)
    full = update.update_points_group(xb_v, q, tplats, ivars,
                                      weight_function=0, chunk=CHUNK,
                                      max_blocks=budgets, **kw)
    assert torch.equal(xa, full)


def test_profile_groups_record(small):
    """``profile``'s record on one chunk: the three times, and the solve
    from the accumulated terms equal to the full update."""
    pts, xb, plats = small
    _, tplats = _shared_platforms(plats)
    out = profile_groups.profile(torch.from_numpy(xb[:CHUNK]),
                                 torch.from_numpy(pts[:CHUNK]), tplats,
                                 chunk=CHUNK)
    assert out["solve_equals_full"] and out["device"] == "cpu"
    assert out["variables"] == list(bench_case.PROD_GROUPS[0][1])
    assert out["points"] == CHUNK and set(out["budgets"]) == {"vr"}
    assert min(out["full_s"], out["accumulation_s"], out["solve_s"]) > 0
    # each of the three is rounded to 1e-4 s on its own
    assert out["acc_plus_sol_s"] == pytest.approx(
        out["accumulation_s"] + out["solve_s"], abs=2e-4)


# ------------------------------------------------------------ the other drives

def test_gpu_drive_matches_jax():
    """The drive's checks pass on the CPU, and its analyses match JAX's
    ``update_points`` / ``update_points_group`` on the same arrays at
    tests/test_torch_update.py's tolerance."""
    report, analyses = gpu_drive.main(device="cpu")
    assert report["k1_launches"] == 0
    assert report["wf0"]["rmse_a"] < 0.5 * report["wf0"]["rmse_b"]
    pts, xb, _, _, (st, po) = gpu_drive.build_case()
    jst = jbase.PlatformStatic(**dataclasses.asdict(st))
    jdp = jupdate.prepare_platform(jst, jbase.PlatformObs(**po._asdict()))
    k = gpu_drive.K
    for wf in (0, 1):
        want = np.asarray(jupdate.update_points(
            xb, pts, [jdp], 0, inflat=(k - 1) / gpu_drive.RHO,
            weight_function=wf, chunk=gpu_drive.CHUNK))
        np.testing.assert_allclose(analyses[f"xa_wf{wf}"], want, rtol=0,
                                   atol=5e-4 * np.abs(want).max())
    xb3 = np.stack([xb, 0.5 * xb, xb + 3.0], axis=1)
    want = np.asarray(jupdate.update_points_group(
        xb3, pts, [jdp], (0, 0, 0),
        inflats=tuple((k - 1) / f for f, _, _ in gpu_drive.FUSED),
        weight_function=0, rtpp_alpha=tuple(p for _, p, _ in gpu_drive.FUSED),
        rtps_alpha=tuple(s for _, _, s in gpu_drive.FUSED),
        chunk=gpu_drive.CHUNK))
    np.testing.assert_allclose(analyses["xa_group"], want, rtol=0,
                               atol=5e-4 * np.abs(want).max())


def test_run_synthetic_cycle_matches_jax_cli(tmp_path):
    scores = run_synthetic_cycle.main(str(tmp_path), "cpu")
    assert scores["rmse_analysis"] < scores["rmse_prior"]
    assert _jax_cli(["--input", str(tmp_path / "input"), "--output",
                     str(tmp_path / "jout"), "--chunk", "512",
                     "--quiet"]) == 0
    _assert_outputs_close(tmp_path / "output", tmp_path / "jout",
                          tmp_path / "input", 8, ("T", "QVAPOR"))


def test_gpu_cli_drive_on_cpu(tmp_path):
    """The drive's checks and its metrics line, at a small size."""
    out = tmp_path / "metrics.json"
    metrics = gpu_cli_drive.main("cpu", str(out), k=3, nx=12, ny=10, nz=3,
                                 n_synop=40, n_vr=800)
    assert json.loads(out.read_text()) == metrics
    assert metrics["drive"]["device"] == "cpu"
    assert metrics["drive"]["case"] == {"nx": 12, "ny": 10, "nz": 3, "k": 3,
                                        "synop_records": 40,
                                        "vr_records": 800}
    assert [g["variables"] for g in metrics["groups"]]
    assert all(g["bucket_overflow"] == 0 for g in metrics["groups"])


def _memory_bench_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "cwbnwp_letkf_torch.examples.memory_bench",
         "--platform", "cpu", "--nx", "10", "--ny", "8", "--nz", "3",
         "--k", "3"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_memory_bench_cpu():
    """Both children, each in its own process, print their JSON; the harness
    prints one line."""
    result = _memory_bench_cpu()
    assert [r["mode"] for r in result["runs"]] == ["eager", "stream"]
    for r in result["runs"]:
        assert r["peak_rss_mb"] > 0 and r["device"] == "cpu"
        assert r["k1_launches"] == 0


def test_memory_bench_children_do_not_read_the_callers_memory():
    """A child's ``ru_maxrss`` starts from its parent's resident size; run
    as its own process, the harness keeps a large caller's memory out of
    its children's figures."""
    big = np.ones(2 ** 27)                    # 1 GiB touched in this process
    for r in _memory_bench_cpu()["runs"]:
        assert r["peak_rss_mb"] < big.nbytes // 2 ** 20


@pytest.mark.parametrize("drive", [
    "profile_cycle", "profile_groups", "gpu_drive", "run_synthetic_cycle",
    "gpu_cli_drive", "memory_bench"])
def test_drive_raises_without_card(drive, tmp_path, monkeypatch):
    """Without a card and without the CPU asked for, every drive raises
    before it builds or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = {"profile_cycle": lambda: profile_cycle.main([]),
             "profile_groups": lambda: profile_groups.main([]),
             "gpu_drive": lambda: gpu_drive.main(),
             "run_synthetic_cycle": lambda: run_synthetic_cycle.main(
                 str(tmp_path / "w")),
             "gpu_cli_drive": lambda: gpu_cli_drive.main(),
             "memory_bench": lambda: memory_bench.main([])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[drive]()
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples.select_device("gpu")
    assert examples.select_device("cpu") == torch.device("cpu")


def test_drives_import_nothing_of_bench_or_tests():
    pattern = re.compile(r"^\s*(import|from)\s+(bench|tests|examples)\b",
                         re.M)
    srcs = sorted((ROOT / "cwbnwp_letkf_torch" / "examples").glob("*.py"))
    assert len(srcs) == 12
    for path in srcs:
        assert not pattern.search(path.read_text()), path
