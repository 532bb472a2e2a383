"""The port's fused cycle, end to end, against the JAX package's on the CPU.

The case of tests/test_cycle.py at the size its overflow and background
tests use (16x16x4 points): a production-shaped grouping, one dense platform
(synop, 300 records) and one bucketed platform (vr, 9000 records, at least
BUCKET_MIN_RECORDS), plus a group no platform feeds; two chunks of four
subchunks.  JAX runs its Newton-Schulz solve, which the port's plain version
reproduces.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.ops import cycle as jcycle
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops import update as jupdate
from cwbnwp_letkf_torch.ops import cycle, update

from .torch_parity import cycle_case, group_fields, to_port

CHUNK, SUB = 512, 128


@pytest.fixture(scope="module")
def case():
    pts, xb_v, plats = cycle_case(nx=16, nz=4)
    assert plats[1][1].nrec >= update.BUCKET_MIN_RECORDS
    return pts, xb_v, plats


@pytest.fixture(autouse=True)
def _ns_full_f32():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


@pytest.mark.parametrize("weight_function", [0, 1])
def test_cycle_matches_jax(case, weight_function):
    pts, xb_v, plats = case
    jplats = [jupdate.prepare_platform(st, po) for st, po in plats]
    jgroups = [jcycle.CycleGroup(*f) for f in group_fields()]
    jbudgets = jcycle.plan_cycle_budgets(jnp.asarray(pts), jplats, jgroups,
                                         chunk=CHUNK, subchunk=SUB)
    xa_j, diag_j = jcycle.update_points_cycle(
        jnp.asarray(xb_v), jnp.asarray(pts), jplats, jgroups,
        weight_function=weight_function, chunk=CHUNK, subchunk=SUB,
        max_blocks=jbudgets, return_diagnostics=True)

    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    tgroups = [cycle.CycleGroup(*f) for f in group_fields()]
    budgets = cycle.plan_cycle_budgets(torch.from_numpy(pts), tplats, tgroups,
                                       chunk=CHUNK, subchunk=SUB)
    assert budgets == jbudgets
    xa, diag = cycle.update_points_cycle(
        torch.from_numpy(xb_v), torch.from_numpy(pts), tplats, tgroups,
        weight_function=weight_function, chunk=CHUNK, subchunk=SUB,
        max_blocks=budgets, return_diagnostics=True)

    assert int(diag["bucket_overflow"]) == 0 == int(diag_j["bucket_overflow"])
    assert float(diag["ns_residual"]) <= 1e-4
    xa_j = np.asarray(xa_j)
    np.testing.assert_allclose(xa.numpy(), xa_j, rtol=0,
                               atol=5e-4 * np.abs(xa_j).max())
    # the group no platform feeds keeps its background exactly
    np.testing.assert_array_equal(xa[:, -1].numpy(), xb_v[:, -1])
    assert not np.array_equal(xa[:, 0].numpy(), xb_v[:, 0])


def test_cycle_float64_matches_jax(case):
    """The cycle's float64 solve against the JAX package's, at the float64
    tolerance of tests/test_torch_update.py:153: the tables, the
    accumulation and the solve all run in float64, on float64 inputs."""
    pts, xb_v, plats = case
    pts, xb_v = pts.astype(np.float64), xb_v.astype(np.float64)
    plats = [(st, po._replace(**{n: getattr(po, n).astype(np.float64)
                                 for n in po._fields}))
             for st, po in plats]
    jplats = [jupdate.prepare_platform(st, po) for st, po in plats]
    jgroups = [jcycle.CycleGroup(*f) for f in group_fields()]
    jbudgets = jcycle.plan_cycle_budgets(
        jnp.asarray(pts), jplats, jgroups, chunk=CHUNK, subchunk=SUB,
        solver_dtype=jnp.float64)
    xa_j = jcycle.update_points_cycle(
        jnp.asarray(xb_v), jnp.asarray(pts), jplats, jgroups,
        weight_function=0, chunk=CHUNK, subchunk=SUB, max_blocks=jbudgets,
        solver_dtype=jnp.float64)

    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    tgroups = [cycle.CycleGroup(*f) for f in group_fields()]
    budgets = cycle.plan_cycle_budgets(
        torch.from_numpy(pts), tplats, tgroups, chunk=CHUNK, subchunk=SUB,
        solver_dtype=torch.float64)
    assert budgets == jbudgets
    xa, diag = cycle.update_points_cycle(
        torch.from_numpy(xb_v), torch.from_numpy(pts), tplats, tgroups,
        weight_function=0, chunk=CHUNK, subchunk=SUB, max_blocks=budgets,
        solver_dtype=torch.float64, return_diagnostics=True)
    assert xa.dtype == torch.float64 and int(diag["bucket_overflow"]) == 0
    np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_array_equal(xa[:, -1].numpy(), xb_v[:, -1])


def test_accumulate_chunk_counts_match_cycle_plans(case):
    """The factored per-chunk accumulation: shapes, exact counts, no overflow."""
    pts, _, plats = case
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    groups = [cycle.CycleGroup(*f) for f in group_fields()]
    q = torch.from_numpy(pts)
    budgets = cycle.plan_cycle_budgets(q, tplats, groups, chunk=CHUNK,
                                       subchunk=SUB)
    plans = cycle._resolve_plans(tplats, groups, max_blocks=budgets)
    perm = cycle._cycle_point_perm(q, plans)
    a, g, cnt, ovf = cycle.accumulate_chunk(
        q[perm[:CHUNK]], plans, groups, k=12, weight_function=0, subchunk=SUB)
    assert a.shape == (len(groups), CHUNK, 12, 12) and g.shape[:2] == cnt.shape
    assert int(ovf) == 0
    assert (cnt[:-1] > 0).all() and not cnt[-1].any()
    torch.testing.assert_close(a, a.transpose(-1, -2), rtol=1e-5, atol=1e-3)


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package blocked."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'cwbnwp_letkf_tpu'))]:\n"
        "    del sys.modules[name]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['cwbnwp_letkf_tpu'] = None\n"
        "import cwbnwp_letkf_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'cwbnwp_letkf_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for mod in ('ops.cycle', 'ops.update', 'ops.solver', 'ops.jacobi_eigh', 'ops.eigh_kernel',\n"
        "            'ops.ns_kernel', 'ops.cuda_build', 'driver', 'config', 'projection', 'metrics',\n"
        "            'models.state', 'models.vcoord', 'io.netcdf', 'cli', 'synthetic_case',\n"
        "            'profiling', 'tracing', 'io.native', 'obs.gts', 'obs.radar',\n"
        "            'ops.neighbors',\n"
        "            'ops.whiten', 'ops.dense', 'constants', 'obs.synthetic',\n"
        "            'parallel.mesh', 'parallel.update', 'parallel.multihost',\n"
        "            'parallel.scaling_model', 'examples.scaling_bench',\n"
        "            'examples.scaling_model_report', 'examples.bench_case',\n"
        "            'examples.wrf_case', 'examples.profile_cycle',\n"
        "            'examples.profile_groups', 'examples.gpu_drive',\n"
        "            'examples.run_synthetic_cycle', 'examples.gpu_cli_drive',\n"
        "            'examples.memory_bench', 'examples.layout_ab'):\n"
        "    assert 'cwbnwp_letkf_torch.' + mod in names, names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50
    for path in (root / "cwbnwp_letkf_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "cwbnwp_letkf_tpu" not in text, path


def test_root_exports_without_jax():
    """The root package's exports (the JAX package's ``__init__.py``), with
    jax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cwbnwp_letkf_tpu'] = None\n"
        "import cwbnwp_letkf_torch as pkg\n"
        "from cwbnwp_letkf_torch.config import LetkfConfig\n"
        "from cwbnwp_letkf_torch.projection import LambertProjection\n"
        "assert pkg.LetkfConfig is LetkfConfig\n"
        "assert pkg.LambertProjection is LambertProjection\n"
        "print(sorted(pkg.__all__), pkg.__version__)\n")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import cwbnwp_letkf_tpu

    assert out.stdout.split() == [
        "['LambertProjection',", "'LetkfConfig',", "'__version__']",
        cwbnwp_letkf_tpu.__version__]
