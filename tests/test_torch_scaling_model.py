"""The port's analytic scaling model (``parallel/scaling_model.py``) against
the JAX package's, and its two drives, on the CPU.

Mirrors tests/test_scaling_model.py.  ``shard_work`` (measured per-shard
work) equals JAX's on the same float32 case; ``predict`` with the same
explicit rates and cards per host equals JAX's number for number, its keys
renamed from the TPU's interconnect to the H100's link (``ici`` ->
``link``, ``chips`` -> ``cards``), and only the topology text and the
sources differ.  The remaining tests hold the model's findings under its
H100 defaults (8 cards a host, 50 GB/s a card across hosts).
"""
import json
import re

import numpy as np
import torch

from cwbnwp_letkf_tpu.obs.synthetic import (correlated_ensemble,
                                            idealized_grid,
                                            synthetic_gts_platform)
from cwbnwp_letkf_tpu.ops.update import prepare_platform as jprepare
from cwbnwp_letkf_tpu.parallel import scaling_model as jsm
from cwbnwp_letkf_torch.examples import scaling_bench, scaling_model_report
from cwbnwp_letkf_torch.ops.update import prepare_platform
from cwbnwp_letkf_torch.parallel import scaling_model as sm

from .torch_parity import one_torch_thread, to_port  # noqa: F401

H2D = 25e9


def _case():
    """tests/test_scaling_model.py::_case, in float32: a 640 km domain, far
    wider than the localization ball, so shard work follows obs density."""
    rng = np.random.default_rng(2)
    pts = idealized_grid(32, 32, 4, dx_m=20e3)
    truth, xb = correlated_ensemble(rng, pts, 8, n_bumps=4)
    st, po = synthetic_gts_platform(rng, pts, truth, xb, nobs=9000, nvar=1,
                                    hclr_km=15.0, vclr_km=3.0,
                                    max_lz_pts=50, extent_frac=0.7)
    po = po._replace(**{n: np.asarray(getattr(po, n), np.float32)
                        if np.asarray(getattr(po, n)).dtype == np.float64
                        else getattr(po, n) for n in po._fields})
    return (pts.astype(np.float32), jprepare(st, po),
            prepare_platform(*to_port(st, po), device="cpu"))


def _tpu_to_h100(name):
    name = re.sub(r"(?<![a-z])ici(?![a-z])", "link", name)
    return re.sub(r"(?<![a-z])chips(?![a-z])", "cards", name)


def _jax_keys(tree):
    """JAX's output with the TPU names mapped to the port's (keys and the
    formula's text), without its topology text."""
    if isinstance(tree, dict):
        return {_tpu_to_h100(k): _jax_keys(v) for k, v in tree.items()
                if k != "topology"}
    return _tpu_to_h100(tree) if isinstance(tree, str) else tree


def _numbers(out):
    out = json.loads(json.dumps(out))
    out["assumptions"].pop("topology")
    out["assumptions"].pop("sources")
    return out


def test_shard_work_measures_imbalance_as_jax():
    pts, jdp, dp = _case()
    w = np.asarray(sm.shard_work(torch.from_numpy(pts), [dp], 0, 4,
                                 chunk=128))
    assert w.tolist() == jsm.shard_work(pts, [jdp], 0, 4, chunk=128)
    assert w.shape == (4,) and (w > 0).all()
    # obs packed into the central 70%: edge shards carry less work
    assert w.max() / w.mean() > 1.01
    assert sm.obs_bytes([dp]) == jsm.obs_bytes([jdp])


def test_predict_equals_jax_with_the_same_rates():
    pts, jdp, dp = _case()
    args = (65536, 16, 40, 2.0, sm.obs_bytes([dp]))
    imb = {8: 1.1, 16: 1.2, 32: 1.3}
    for born in (False, True):
        out = sm.predict(*args, n_hosts=(1, 2, 4, 8), imbalance=imb,
                         cards_per_host=4, link_bytes_s=45e9, h2d_bytes_s=H2D,
                         born_sharded=born)
        jout = jsm.predict(*args, n_hosts=(1, 2, 4, 8), imbalance=imb,
                           chips_per_host=4, ici_bytes_s=45e9,
                           h2d_bytes_s=H2D, born_sharded=born)
        assert _numbers(out) == _jax_keys(jout)


def test_predict_efficiency_shape():
    pts, _, dp = _case()
    out = sm.predict(65536, 16, 40, 2.0, sm.obs_bytes([dp]),
                     n_hosts=(1, 2, 4, 8), h2d_bytes_s=H2D,
                     imbalance={16: 1.1, 32: 1.2, 64: 1.3})
    assert out["model"] is True
    assert out["assumptions"]["cards_per_host"] == 8
    assert set(out["assumptions"]["sources"]) == {
        "link_bytes_s", "cards_per_host", "h2d_bytes_s"}
    effs = [out["per_host"][str(n)]["efficiency"] for n in (1, 2, 4, 8)]
    assert all(0.0 < e <= 1.0 + 1e-9 for e in effs)
    # efficiency cannot increase with host count in this model
    assert all(a >= b - 1e-9 for a, b in zip(effs, effs[1:]))
    # the transpose term appears whenever ingest is member-sharded
    assert out["per_host"]["2"]["t_transpose_s"] > 0
    assert out["per_host"]["1"]["t_obs_feed_s_overlapped"] == round(
        sm.obs_bytes([dp]) / H2D, 4)


def test_predict_production_volume():
    """At the production state volume (10.53M points x 16 variables x 96
    members) and a 30 s single-card cycle, the defaults predict >= 85% at
    2-8 hosts with 5% imbalance; the link sweep is monotone, 85% first holds
    at the listed rate the sweep names, and the ratio of transpose to
    compute does not depend on the host count."""
    b = 10_530_000
    out = sm.predict(b, 16, 96, 30.0, 500 << 20, n_hosts=(2, 4, 8),
                     h2d_bytes_s=H2D, imbalance={c: 1.05 for c in (16, 32, 64)})
    for n in (2, 4, 8):
        assert out["per_host"][str(n)]["efficiency"] >= 0.85, out
    sens = out["link_sensitivity_at_max_hosts"]
    assert sens["hosts"] == 8
    effs = sens["efficiency_by_link_gbs"]
    keys = ("5", "10", "15", "20", "30", "45", "60", "90")
    assert tuple(effs) == keys
    vals = [effs[k] for k in keys]
    assert all(a <= b_ + 1e-9 for a, b_ in zip(vals, vals[1:]))
    first = next(int(k) for k in keys if effs[k] >= 0.85)
    assert sens["min_link_gbs_for_85pct"] == first <= 50
    out4 = sm.predict(b, 16, 96, 30.0, 500 << 20, n_hosts=(2, 4),
                      h2d_bytes_s=H2D, imbalance={c: 1.05 for c in (16, 32)})
    effs4 = out4["link_sensitivity_at_max_hosts"]["efficiency_by_link_gbs"]
    assert abs(effs4["30"] - effs["30"]) < 0.02


def test_scaling_model_report_writes_json(tmp_path):
    path = tmp_path / "model.json"
    assert scaling_model_report.main(
        [str(path), "--t-compute-1", "11.6", "--h2d-gbs", "25",
         "--prod-compute-s", "199.4", "--grid", "32", "32", "4",
         "--device", "cpu"]) == 0
    out = json.loads(path.read_text())
    assert out["model"] is True
    assert set(out["inputs"]["imbalance_measured"]) == {"8", "16", "32", "64"}
    for name in ("bench_case", "production_volume_per_group"):
        assert out[name]["model"] is True
        assert out[name]["assumptions"]["h2d_bytes_s"] == 25e9


def test_scaling_bench_mock(capsys):
    assert scaling_bench.main(["--mock", "--shards", "2", "--points", "4096",
                               "--nobs", "500", "--chunk", "512"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mock"] is True and "says nothing of scaling" in out["note"]
    assert set(out["walls_s"]) == {"1", "2"} and out["analytic"] is None
