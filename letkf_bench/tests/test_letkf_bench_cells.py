"""Each cell's whole run at a tiny size on the CPU, through its own entry:
the port's analyses pass the reference at the cell's limit, and a run whose
timed path is broken underneath reads ``correct`` false.  The harness's
look for a card is skipped (``on_card=False``); everything else is the
run the benchmark makes."""
import contextlib
import copy

import pytest
import torch

from letkf_bench import run as harness

#: one radar at the domain's centre, scanning three elevations to 60 km
TINY_RADAR = dict(sites=[[120.9, 23.7, 0.0]], elevations_deg=[0.5, 1.45, 2.4],
                  range_km=60.0, gate_km=3.0, beam_deg=6.0)
#: tiny shapes of each cell: the configuration's and the traffic's keys
TINY = {
    "full96.radar_gts": dict(
        cfg=dict(grid=dict(nx=16, ny=16, nz=4), nmember=8),
        traffic=dict(platforms=dict(synop=dict(per_10000_km2=250)),
                     radar=TINY_RADAR)),
    "full96.gts_only": dict(
        cfg=dict(grid=dict(nx=16, ny=16, nz=4), nmember=8),
        traffic=dict(platforms=dict(synop=dict(per_10000_km2=250)))),
    # 9,000 records: the bucketed path, as at full size
    "prod96.vr_slabs": dict(
        cfg=dict(grid=dict(nx=24, ny=24, nz=8), nmember=8, slabs=4,
                 chunk=512),
        traffic=dict(platforms=dict(vr=dict(records=9000)))),
}


def update(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested dictionaries key by key."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        out[key] = (update(out[key], value) if isinstance(value, dict)
                    else copy.deepcopy(value))
    return out


def tiny(workload: str):
    parts = harness.resolve(workload)
    over = TINY[workload]
    parts.cfg = update(parts.cfg, over["cfg"])
    parts.traffic = update(parts.traffic, over["traffic"])
    parts.cell = dict(parts.cell, sample_points=48)
    return parts


def go(workload: str, seed: int = 2 ** 31 + 17, trace: bool = False):
    torch.manual_seed(0)
    return harness.run(tiny(workload), seed, 0.2, trace, torch.device("cpu"),
                       on_card=False)


@contextlib.contextmanager
def broken(fault: str):
    """The timed path broken underneath, as ``fault`` says."""
    from cwbnwp_letkf_torch import driver
    from cwbnwp_letkf_torch.ops import cycle, solver

    if fault == "altered":          # every answer off: the solve's Z by 10%
        ns_z = solver._ns_z

        def wrong(a_obs, inflat):
            z, resid = ns_z(a_obs, inflat)
            return z * 1.1, resid
        patches = [(solver, "_ns_z", wrong)]
    elif fault == "no_inflation":   # multiplicative inflation dropped
        solve = cycle.letkf_solve_cycle_from_normal

        def plain(a, g, xb, inflats, has, **kw):
            k = xb[0].shape[-1]
            return solve(a, g, xb, [tuple(k - 1.0 for _ in i) for i in inflats],
                         has, **kw)
        patches = [(cycle, "letkf_solve_cycle_from_normal", plain)]
    else:
        update = cycle.update_points_cycle

        def partial(xb, pts, *args, **kw):
            out = update(xb, pts, *args, **kw)
            xa = out[0] if isinstance(out, tuple) else out
            # "unchanged": the state returned as it came; "half": half of
            # the points left out
            start = 0 if fault == "unchanged" else xa.shape[0] // 2
            with torch.inference_mode():
                xa[start:] = xb[start:]
            return out
        patches = [(cycle, "update_points_cycle", partial),
                   (driver, "update_points_cycle", partial)]
    from letkf_bench.trace import patched

    with patched(patches):
        yield


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_port_passes_the_reference(workload):
    out = go(workload)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {
        m["name"] for m in harness.resolve(workload).end_to_end}
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_inflation"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_broken_path_is_not_correct(workload, fault):
    with broken(fault):
        out = go(workload)
    assert not out["correct"], out["compared"]
    assert out["failed"] == out["attempted"]


def test_a_traced_run_reports_the_per_layer_metrics():
    out = go("full96.radar_gts", trace=True)
    assert out["correct"]
    assert "driver.load_share" in out["metrics"]     # a host clock
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_same_seed_gives_the_same_inputs():
    from letkf_bench import generate

    parts = tiny("full96.radar_gts")
    a, b = (generate.wrf_case(parts.cfg, 2 ** 33 + 1) for _ in range(2))
    assert all((a["fields"][k] == b["fields"][k]).all() for k in a["fields"])
    ra, rb = (generate.column_obs(parts.cfg, parts.traffic, a, 2 ** 33 + 1)
              for _ in range(2))
    assert all((ra[n]["xyz"] == rb[n]["xyz"]).all() for n in ra)
    parts = tiny("prod96.vr_slabs")
    sa, sb = (generate.slab_case(parts.cfg, parts.traffic, 5, "cpu")
              for _ in range(2))
    assert torch.equal(sa["xb"], sb["xb"])
    assert torch.equal(sa["records"]["vr"]["xyz"], sb["records"]["vr"]["xyz"])


def test_the_reference_places_the_points_where_the_port_does():
    """The reference's own projection and heights against the port's
    ``analysis_points`` for every stagger of the tiny WRF case."""
    import numpy as np
    from cwbnwp_letkf_torch.config import ProjectionConfig
    from cwbnwp_letkf_torch.models.state import MpScheme, WrfEnsemble
    from cwbnwp_letkf_torch.models.vcoord import (analysis_points,
                                                  mean_geopotential_height)
    from cwbnwp_letkf_torch.projection import LambertProjection

    from letkf_bench import generate
    from letkf_bench.reference import geometry

    parts = tiny("full96.radar_gts")
    cfg = parts.cfg
    w = generate.wrf_case(cfg, 3)
    g = cfg["grid"]
    ens = WrfEnsemble(nx=g["nx"], ny=g["ny"], nz=g["nz"], k=cfg["nmember"],
                      mp=MpScheme.from_option(9), fields=w["fields"],
                      pb=w["pb"], phb=w["phb"], mub=w["mub"], **w["geo"])
    proj = LambertProjection.from_config(ProjectionConfig(**cfg["projection"]))
    z_w = mean_geopotential_height(ens)
    for name, spec in geometry.VARIABLES.items():
        pts, dims = analysis_points(ens, proj, spec.hstag, spec.vstag, z_w)
        flat = np.arange(pts.shape[0])
        mine = geometry.points(spec, flat, w["geo"],
                               geometry.w_level_height(w["fields"]["ph"]),
                               geometry.Lambert.of(**cfg["projection"]))
        assert dims == geometry.extent(spec, g["nx"], g["ny"], g["nz"])
        assert np.array_equal(pts, mine), name
