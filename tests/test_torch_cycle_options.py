"""The fused cycle's options on the port against the JAX package's, on the CPU.

``method``, ``point_order``, ``obs_presorted`` and an int ``max_blocks`` of
``ops/cycle.update_points_cycle`` and ``plan_cycle_budgets``, on the case of
tests/test_cycle.py at 12x12x3 points (synop 300 records, dense; vr 9000,
bucketed); and the refusal of ``method="gather"``, which the JAX cycle takes
and then fails on.
"""
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


@pytest.fixture(autouse=True)
def _ns_full_f32():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


def _f64(pts, xb_v, plats):
    return (pts.astype(np.float64), xb_v.astype(np.float64),
            [(st, po._replace(**{n: getattr(po, n).astype(np.float64)
                                 for n in po._fields})) for st, po in plats])


def _cycles(pts, xb_v, plats, fields, *, dtype, jax_too=True, **opts):
    """The port's cycle, and the JAX package's where ``jax_too``, on the same
    inputs with the same options; budgets planned by each and held equal.
    Returns ``(xa, diag, xa_jax or None, budgets)``."""
    max_blocks = opts.pop("max_blocks", None)
    plan_opts = {n: opts[n] for n in ("method", "point_order", "obs_presorted")
                 if n in opts}
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    tgroups = [cycle.CycleGroup(*f) for f in fields]
    tdtype = torch.float64 if dtype == "float64" else torch.float32
    budgets = cycle.plan_cycle_budgets(
        torch.from_numpy(pts), tplats, tgroups, chunk=SMALL_CHUNK,
        subchunk=SMALL_SUB, solver_dtype=tdtype, **plan_opts)
    mb = budgets if max_blocks is None else max_blocks
    xa, diag = cycle.update_points_cycle(
        torch.from_numpy(xb_v), torch.from_numpy(pts), tplats, tgroups,
        weight_function=0, chunk=SMALL_CHUNK, subchunk=SMALL_SUB,
        max_blocks=mb, solver_dtype=tdtype, return_diagnostics=True, **opts)
    xa_j = None
    if jax_too:
        jplats = [jupdate.prepare_platform(st, po) for st, po in plats]
        jgroups = [jcycle.CycleGroup(*f) for f in fields]
        jdtype = jnp.float64 if dtype == "float64" else jnp.float32
        jbudgets = jcycle.plan_cycle_budgets(
            jnp.asarray(pts), jplats, jgroups, chunk=SMALL_CHUNK,
            subchunk=SMALL_SUB, solver_dtype=jdtype, **plan_opts)
        assert budgets == jbudgets
        xa_j = np.asarray(jcycle.update_points_cycle(
            jnp.asarray(xb_v), jnp.asarray(pts), jplats, jgroups,
            weight_function=0, chunk=SMALL_CHUNK, subchunk=SMALL_SUB,
            max_blocks=jbudgets if max_blocks is None else max_blocks,
            solver_dtype=jdtype, **opts))
    return xa, diag, xa_j, budgets


SMALL_CHUNK, SMALL_SUB = 256, 64
#: U, V (vr at 36 km), W (vr at 12 km) and the group no platform feeds: two
#: client groups of each platform, whose wide metric is the first's
GROUPS = [group_fields()[i] for i in (0, 1, 4)]
GROUP_COLS = [0, 1, 2, 6]


@pytest.fixture(scope="module")
def small_case():
    pts, xb_v, plats = cycle_case(nx=12, nz=3)
    assert plats[1][1].nrec >= update.BUCKET_MIN_RECORDS
    return pts, xb_v, plats


@pytest.mark.parametrize("opt,value", [("method", "dense"),
                                       ("method", "bucketed"),
                                       ("point_order", "linear"),
                                       ("point_order", "morton")])
def test_cycle_options_match_jax(small_case, opt, value):
    """``method`` forced to one kind for every platform, and the two point
    orders, against the JAX package in float64 at rtol 1e-8: each option
    changes what is computed (the kind of each platform, the chunks), so a
    port that ignored one would still agree only by chance."""
    pts, xb_v, plats = _f64(*small_case)
    xa, diag, xa_j, budgets = _cycles(pts, xb_v[:, GROUP_COLS], plats,
                                      GROUPS, dtype="float64", **{opt: value})
    assert int(diag["bucket_overflow"]) == 0
    assert set(budgets) == {"dense": set(), "bucketed": {"synop", "vr"}}.get(
        value, {"vr"})
    np.testing.assert_allclose(xa.numpy(), xa_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(xa[:, -1].numpy(), xb_v[:, -1])
    assert not np.array_equal(xa[:, 0].numpy(), xb_v[:, 0])


def _hilbert_presorted(plats, hclr, vclr):
    """``plats`` with vr's records in Hilbert order of their coordinates
    normalized by ``(hclr, vclr)``, the blocking's metric."""
    from cwbnwp_letkf_torch.ops.bucketed import hilbert3
    from cwbnwp_letkf_torch.ops.neighbors import normalize_coords

    (st_s, po_s), (st, po) = plats
    keys = hilbert3(normalize_coords(torch.from_numpy(po.xyz), hclr, vclr))
    order = torch.argsort(keys, stable=True).numpy()
    assert not np.array_equal(order, np.arange(order.size))
    po = po._replace(xyz=po.xyz[order], obs=po.obs[:, order],
                     error=po.error[:, order], qc=po.qc[:, order],
                     hdxb=po.hdxb[:, order])
    return [(st_s, po_s), (st, po)]


def test_obs_presorted_equals_sorted(small_case):
    """One group (T, QVAPOR: vr at 24 km, 3 km) on records presorted in that
    metric: ``obs_presorted=True`` blocks them as given, bit for bit the
    sorted path (the stable sort of sorted keys is the identity), builds no
    sorted copy, and agrees with the JAX package's presorted cycle."""
    pts, xb_v, plats = small_case
    fields = [group_fields()[2]]                    # (3, 4)
    plats = _hilbert_presorted(plats, 24.0, 3.0)
    xb2 = np.ascontiguousarray(xb_v[:, 3:5])
    xa_p, diag_p, xa_j, bud_p = _cycles(pts, xb2, plats, fields,
                                        dtype="float32", obs_presorted=True)
    xa_s, _, _, bud_s = _cycles(pts, xb2, plats, fields, dtype="float32",
                                jax_too=False)
    assert bud_p == bud_s and int(diag_p["bucket_overflow"]) == 0
    assert torch.equal(xa_p, xa_s)
    np.testing.assert_allclose(xa_p.numpy(), xa_j, rtol=0,
                               atol=5e-4 * np.abs(xa_j).max())
    tplat = update.prepare_platform(*to_port(*plats[1]), device="cpu")
    cb = cycle._cycle_blocking(tplat, [tplat.static.assim_mask(3)], 24.0,
                               3.0, 128, torch.float32, presorted=True)
    assert torch.equal(cb.xyz_raw[:tplat.xyz.shape[0]], tplat.xyz)


def test_int_max_blocks(small_case):
    """An int budget for every bucketed platform: the planned budget as an
    int gives the planned run bit for bit (the same blocking, the same
    candidate count), and a budget of one block overflows."""
    pts, xb_v, plats = small_case
    xb_v = np.ascontiguousarray(xb_v[:, GROUP_COLS])
    xa_d, _, _, budgets = _cycles(pts, xb_v, plats, GROUPS, dtype="float32",
                                  jax_too=False)
    mb = budgets["vr"].max_blocks
    xa_i, diag, _, _ = _cycles(pts, xb_v, plats, GROUPS, dtype="float32",
                               jax_too=False, max_blocks=mb)
    assert int(diag["bucket_overflow"]) == 0 and torch.equal(xa_i, xa_d)
    _, diag, _, _ = _cycles(pts, xb_v, plats, GROUPS, dtype="float32",
                            jax_too=False, max_blocks=1)
    assert int(diag["bucket_overflow"]) > 0


def test_cycle_refuses_gather(small_case):
    """The JAX cycle has no gather branch (a gather plan has no tables); the
    port refuses the method and names the update that takes it."""
    pts, xb_v, plats = small_case
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    groups = [cycle.CycleGroup(*f) for f in group_fields()]
    q, xb = torch.from_numpy(pts), torch.from_numpy(xb_v)
    with pytest.raises(ValueError, match=r"update_points\(method='gather'\)"):
        cycle.update_points_cycle(xb, q, tplats, groups, weight_function=0,
                                  method="gather")
    with pytest.raises(ValueError, match=r"update_points\(method='gather'\)"):
        cycle.plan_cycle_budgets(q, tplats, groups, method="gather")
    with pytest.raises(ValueError, match="method must be one of"):
        cycle.update_points_cycle(xb, q, tplats, groups, weight_function=0,
                                  method="kdtree")


@pytest.mark.parametrize("entry", ["update", "plan"])
def test_cycle_refuses_unknown_point_order(small_case, entry):
    """A misspelt point order raises before any work, in the update and in
    its planning, instead of running as "linear"."""
    pts, xb_v, plats = small_case
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    groups = [cycle.CycleGroup(*f) for f in group_fields()]
    q, xb = torch.from_numpy(pts), torch.from_numpy(xb_v)
    with pytest.raises(ValueError, match="point_order must be one of"):
        if entry == "update":
            cycle.update_points_cycle(xb, q, tplats, groups,
                                      weight_function=0, point_order="hilbert")
        else:
            cycle.plan_cycle_budgets(q, tplats, groups, point_order="hilbert")
