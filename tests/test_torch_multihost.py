"""The port's multi-process layer (``parallel/multihost.py``) on the CPU.

Mirrors tests/test_multihost.py and tests/test_multiprocess.py.  The member
splits are held against the JAX package's (``member_block`` with JAX's
process count and index patched in: one card per process); the in-process
helpers run on a mesh of CPU shards; the process-group paths run in gloo
subprocesses (tests/torch_mp_worker.py, two and three ranks): the
member->point transposes round trip exactly, the sharded cycle matches the
single-process one within 3e-5, and ``python -m cwbnwp_letkf_torch.cli
--distributed`` on two processes writes the single-process CLI's files
within 5e-4 of the analysis increment.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.parallel import multihost as jmultihost
from cwbnwp_letkf_torch import cli
from cwbnwp_letkf_torch.ops.update import DevicePlatform
from cwbnwp_letkf_torch.parallel import multihost
from cwbnwp_letkf_torch.parallel.mesh import Mesh, make_mesh

from .test_multiprocess import NML, _free_port, _write_gts_obs
from .test_torch_cli import _assert_outputs_close
from .torch_parity import one_torch_thread  # noqa: F401
from .wrf_fixtures import make_wrf_ensemble

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
K = 8


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(argv_of, world, timeout=300):
    """Start ``world`` processes (``argv_of(rank, port)``) and wait for all;
    returns their outputs, failing on a non-zero exit."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of(r, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(),
                              cwd=ROOT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def test_member_slice_partitions_exactly():
    for k in (8, 96, 7):
        for pc in (1, 3, 8):
            got = []
            for pi in range(pc):
                sl = multihost.my_member_slice(k, pi, pc)
                assert sl == jmultihost.my_member_slice(k, pi, pc), (k, pc, pi)
                got.extend(range(k)[sl])
            assert got == list(range(k)), (k, pc)


def test_member_slice_balanced():
    sizes = [len(range(96)[multihost.my_member_slice(96, pi, 5)])
             for pi in range(5)]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n_proc", [1, 3, 8])
def test_member_block_matches_jax(monkeypatch, n_proc):
    """One card per process: JAX's mesh of ``n_proc`` devices over
    ``n_proc`` processes against the port's process-group mesh."""
    jmesh = types.SimpleNamespace(devices=np.empty(n_proc))
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    for k in (7, 8, 96):
        owned = []
        for pi in range(n_proc):
            monkeypatch.setattr(jax, "process_index", lambda pi=pi: pi)
            mesh = Mesh(devices=(CPU,) * n_proc, kinds=("cpu",) * n_proc,
                        group=object() if n_proc > 1 else None, rank=pi)
            blk = multihost.member_block(k, mesh)
            assert blk == jmultihost.member_block(k, jmesh), (k, n_proc, pi)
            owned.extend(range(k)[blk])
        assert owned == list(range(k))


def test_make_point_sharded_and_replicate():
    mesh = make_mesh([CPU] * 8)
    arr = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8 * 16, 3)
    shards = multihost.make_point_sharded(mesh, arr)
    assert len(shards) == 8 and all(s.shape == (16, 3) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), arr)

    obs = {"xyz": torch.ones((5, 3)), "err": torch.ones(5)}
    rep = multihost.replicate_obs(mesh, obs)
    assert len(rep) == 8
    assert all(r["xyz"].shape == (5, 3) and r["xyz"].device == CPU
               for r in rep)


def test_in_process_transposes_round_trip():
    """On an in-process mesh the process owns every member: the transposes
    only split rows (padded with zeros) and join them."""
    mesh = make_mesh([CPU] * 3)
    glob = np.random.default_rng(1).standard_normal((100, 2, 7)).astype(
        np.float32)
    assert multihost.member_block(7, mesh) == slice(0, 7)
    shards = multihost.member_group_to_points(mesh, glob, 7)
    assert [s.shape for s in shards] == [(34, 2, 7)] * 3
    np.testing.assert_array_equal(torch.cat(shards)[:100].numpy(), glob)
    assert not torch.cat(shards)[100:].any()
    back = multihost.points_to_member_columns(mesh, shards, 7, 100)
    np.testing.assert_array_equal(back, glob)
    blocks = multihost.make_member_sharded(mesh, glob[:, 0], 7)
    assert [b.shape for b in blocks] == [(100, 3)] * 3
    pts = multihost.members_to_points(mesh, blocks, 7)
    np.testing.assert_array_equal(torch.cat(pts)[:100].numpy(), glob[:, 0])


def test_replicate_keeps_a_platform_on_its_device():
    from cwbnwp_letkf_torch.ops.whiten import ObsStats

    dp = DevicePlatform(static=None, xyz=torch.zeros((4, 3)),
                        stats=ObsStats(*[torch.zeros(1)] * 4), cache={"t": 1})
    reps = multihost.replicate_obs(make_mesh([CPU] * 2), [dp])
    assert reps[0][0] is dp and reps[1][0] is dp


@pytest.mark.parametrize("world", [2, 3])
def test_multiprocess_transposes(world):
    outs = _run_ranks(lambda r, port: [
        sys.executable, str(ROOT / "tests" / "torch_mp_worker.py"),
        "transpose", str(r), str(world), str(port)], world)
    for r, out in enumerate(outs):
        assert f"MP-OK {r}" in out, out[-2000:]


def test_two_process_sharded_cycle():
    outs = _run_ranks(lambda r, port: [
        sys.executable, str(ROOT / "tests" / "torch_mp_worker.py"),
        "cycle", str(r), "2", str(port)], 2)
    for r, out in enumerate(outs):
        assert f"MP-OK {r}" in out, out[-2000:]


def test_two_process_distributed_cli(tmp_path):
    """``cli --distributed`` on two gloo processes (member-block streaming
    ingest, the member->point transpose, the sharded cycle, per-process
    member writes, barrier and the rank-0 mean) against the single-process
    port CLI with ``--stream`` (the same sink files)."""
    input_dir = tmp_path / "input"
    input_dir.mkdir()
    make_wrf_ensemble(str(input_dir), K, seed=5)
    (input_dir / "input.nml").write_text(NML.format(k=K))
    _write_gts_obs(input_dir, K)
    common = ["--input", str(input_dir), "--platform", "cpu", "--quiet",
              "--chunk", "64"]
    out_single = tmp_path / "out_single"
    assert cli.main(common + ["--output", str(out_single), "--stream"]) == 0
    out_dist = tmp_path / "out_dist"
    _run_ranks(lambda r, port: [
        sys.executable, "-m", "cwbnwp_letkf_torch.cli", *common,
        "--output", str(out_dist), "--distributed", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
        "--metrics-json", str(tmp_path / f"m{r}.json")], 2)
    assert (tmp_path / "m0.json").exists()
    assert not (tmp_path / "m1.json").exists()     # one metrics file a run
    _assert_outputs_close(out_dist, out_single, input_dir, K, ("T",))
