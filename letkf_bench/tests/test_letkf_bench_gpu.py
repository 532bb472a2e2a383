"""The control of each configuration on the card, at a size a test run
holds: the program with its float32 matrix products in TF32 fails the
cell's limit where the program as configured passes it.

    python -m pytest --noconftest -p no:cacheprovider letkf_bench/tests/test_letkf_bench_gpu.py

Skips without a CUDA card (the check is made inside the test).
"""
import pytest
import torch

from letkf_bench import calibrate, run
from letkf_bench.tests.test_letkf_bench_cells import update

SMALL = {
    "full96.radar_gts": dict(cfg=dict(grid=dict(nx=32, ny=32, nz=20))),
    "prod96.vr_slabs": dict(
        cfg=dict(grid=dict(nx=120, ny=120, nz=20), slabs=4),
        traffic=dict(platforms=dict(vr=dict(records=40000)))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    parts = run.resolve(workload)
    over = SMALL[workload]
    parts.cfg = update(parts.cfg, over.get("cfg", {}))
    parts.traffic = update(parts.traffic, over.get("traffic", {}))
    parts.cell = dict(parts.cell, sample_points=256)
    limits = parts.cell["limits"]
    dev = torch.device("cuda", 0)
    sound = calibrate.reading(parts, 2 ** 31 + 99, dev)
    control = calibrate.reading(parts, 2 ** 31 + 99, dev, control=True)
    # every number passes on the program as configured; the control fails
    # one of them
    assert all(max(sound[n]) <= limit for n, limit in limits.items())
    assert any(min(control[n]) > limit for n, limit in limits.items()
               if n in control)
    assert torch.backends.cuda.matmul.allow_tf32 is False
