"""The port's CUDA kernels against their plain PyTorch versions, on a card.

K1 and K2 are the two packings of the Newton-Schulz kernel
(``csrc/ns_invsqrt.cu``), K3 and K4 the Jacobi eigensolvers
(``csrc/jacobi_eigh.cu``), K5 the cap search (``csrc/cap_search.cu``).

Every test here needs a CUDA device and ``nvcc``; without a card they skip.
On the card run them alone, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from cwbnwp_letkf_torch import tracing
from cwbnwp_letkf_torch.constants import GC1999_SQ
from cwbnwp_letkf_torch.localization import WEIGHT_GAUSSIAN
from cwbnwp_letkf_torch.ops import (cap_kernel, cuda_build, dense,
                                    eigh_kernel, ns_kernel, solver)
from cwbnwp_letkf_torch.ops.jacobi_eigh import (jacobi_cyclic, jacobi_eigh,
                                                jacobi_parallel)

from .torch_parity import (assert_eigh_close, assert_k96_sweep_level,
                           assert_ns_close, cap_case, cap_tie_rows,
                           ill_conditioned_case, normal_case, spd_case)

#: the ensemble sizes of the kernel checks: both Jacobi kernels, odd and
#: even, below and above a warp, and the production k (above 96: the
#: ``*_large_k`` tests)
KS = [2, 3, 8, 9, 40, 41, 96]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,b", [(1, 3), (8, 7), (12, 5), (21, 33), (40, 129),
                                 (64, 65), (96, 17), (97, 5), (127, 3),
                                 (128, 9)])
def test_kernel_matches_plain(cuda, k, b):
    rng = np.random.default_rng(k)
    a_np, _ = normal_case(rng, b, k, 2 * k)
    inflat = (k - 1) / 1.1
    a = torch.from_numpy(a_np).to(cuda)
    before = ns_kernel.LAUNCHES["trio"]
    z, iters, resid = ns_kernel.ns_invsqrt_cuda(a, inflat)
    torch.cuda.synchronize()
    assert ns_kernel.LAUNCHES["trio"] == before + 1
    assert float(resid) <= 1e-4
    assert 1 <= int(iters) <= 24
    z_plain = solver.ns_invsqrt(a, inflat)
    assert_ns_close(z.cpu().numpy(), z_plain.cpu().numpy(), a_np, inflat,
                    same_iteration=False)


@pytest.mark.parametrize("k", [40, 96])
def test_kernel_ill_conditioned(cuda, k):
    rng = np.random.default_rng(4)
    a_np = ill_conditioned_case(rng, 31, k)
    inflat = (k - 1) / 1.1
    a = torch.from_numpy(a_np).to(cuda)
    z, _, resid = ns_kernel.ns_invsqrt_cuda(a, inflat)
    assert float(resid) <= 1e-4
    z_plain = solver.ns_invsqrt(a, inflat)
    assert_ns_close(z.cpu().numpy(), z_plain.cpu().numpy(), a_np, inflat,
                    same_iteration=False)


@pytest.mark.parametrize("packing", ["trio", "rmul"])
@pytest.mark.parametrize("b", [1, 5, 130])
@pytest.mark.parametrize("k", [2, 3, 9, 41, 95])
def test_kernel_tile_edges(cuda, k, b, packing):
    """Ensemble sizes that fill no whole register tile (4 or 8 rows by 4
    columns) and batches of one, a few and about one block per SM: the zero
    padding must not leak into the k x k result."""
    rng = np.random.default_rng(1000 * k + b)
    a_np, _ = normal_case(rng, b, k, 2 * k)
    inflat = (k - 1) / 1.1
    a = torch.from_numpy(a_np).to(cuda)
    z, iters, resid = ns_kernel.launch(a, inflat, packing=packing)
    torch.cuda.synchronize()
    assert tuple(z.shape) == (b, k, k) and tuple(iters.shape) == (b,)
    assert float(resid.max()) <= 1e-4 and 1 <= int(iters.min())
    plain = solver.ns_invsqrt_rmul if packing == "rmul" else solver.ns_invsqrt
    assert_ns_close(z.cpu().numpy(), plain(a, inflat).cpu().numpy(), a_np,
                    inflat, same_iteration=False)


@pytest.mark.parametrize("packing", ["trio", "rmul"])
@pytest.mark.parametrize("k", [9, 40, 96])
def test_kernel_stops_each_matrix_on_its_own(cuda, k, packing):
    """Matrices without obs (``a_obs = 0``: the fewest steps) beside
    ill-conditioned ones (the most): each matrix's Z, step count and
    residual are what the same matrix gives in a batch of one."""
    rng = np.random.default_rng(7)
    a_np = ill_conditioned_case(rng, 12, k)
    a_np[::3] = 0.0
    a_np[1::3] *= 1e-3
    inflat = (k - 1) / 1.1
    a = torch.from_numpy(a_np).to(cuda)
    z, iters, resid = ns_kernel.launch(a, inflat, packing=packing)
    assert len(set(iters.tolist())) > 1          # they do stop apart
    for i in range(a.shape[0]):
        z1, iters1, resid1 = ns_kernel.launch(a[i:i + 1], inflat,
                                              packing=packing)
        assert int(iters1) == int(iters[i])
        assert float(resid1) == float(resid[i])
        assert torch.equal(z1[0], z[i])


@pytest.mark.parametrize("packing", ["trio", "rmul"])
@pytest.mark.parametrize("k", [9, 40, 96])
def test_kernel_nan_matrix_leaves_its_neighbours(cuda, k, packing):
    """A matrix with a NaN stops, reports a NaN residual and a NaN Z; every
    other matrix of the batch equals its value in the batch without it."""
    rng = np.random.default_rng(8)
    a_np, _ = normal_case(rng, 7, k, 2 * k)
    inflat = (k - 1) / 1.1
    clean = torch.from_numpy(a_np).to(cuda)
    dirty = clean.clone()
    dirty[3, k // 2, 0] = float("nan")
    z0, iters0, resid0 = ns_kernel.launch(clean, inflat, packing=packing)
    z, iters, resid = ns_kernel.launch(dirty, inflat, packing=packing)
    keep = [i for i in range(7) if i != 3]
    assert torch.equal(z[keep], z0[keep])
    assert torch.equal(iters[keep], iters0[keep])
    assert torch.equal(resid[keep], resid0[keep])
    assert bool(torch.isnan(resid[3])) and int(iters[3]) == 1
    assert bool(torch.isnan(z[3]).any())


def test_kernel_config_and_work(cuda):
    """What a launch uses at the bench and production sizes: whole warps (a
    multiple of four of them at k=96, one share per scheduler), the three
    buffers in shared memory, and no launch made."""
    before = dict(ns_kernel.LAUNCHES)
    for k in (40, 96):
        for packing in ("trio", "rmul"):
            cfg = ns_kernel.config(k, packing)
            assert cfg["threads"] % 32 == 0 and cfg["threads"] >= k * k // 32
            assert cfg["blocks_per_sm"] >= 1 and 0 < cfg["registers"] <= 255
            assert cfg["smem_bytes"] >= 3 * 4 * k * k
    assert ns_kernel.config(96)["threads"] % 128 == 0
    assert ns_kernel.config(96)["smem_bytes"] <= 227 * 1024
    assert ns_kernel.LAUNCHES == before


def test_ns_z_dispatches_cuda_to_kernel(cuda):
    rng = np.random.default_rng(5)
    a_np, _ = normal_case(rng, 9, 40, 80)
    before = dict(ns_kernel.LAUNCHES)
    z, resid = solver._ns_z(torch.from_numpy(a_np).to(cuda), 39 / 1.6)
    assert ns_kernel.LAUNCHES == {**before, "trio": before["trio"] + 1}
    assert z.is_cuda and float(resid) <= 1e-4


def test_ns_impl_xla_refuses_cuda_tensors(cuda):
    """``set_ns_impl("xla")`` never runs the plain iteration on a card: the
    solve raises and launches nothing; "pallas" launches K1."""
    a = torch.from_numpy(normal_case(np.random.default_rng(6), 5, 40, 80)[0])
    a = a.to(cuda)
    before = dict(ns_kernel.LAUNCHES)
    try:
        solver.set_ns_impl("xla")
        with pytest.raises(ValueError, match="CPU only"):
            solver._ns_z(a, 39 / 1.6)
        assert ns_kernel.LAUNCHES == before
        solver.set_ns_impl("pallas")
        z, resid = solver._ns_z(a, 39 / 1.6)
    finally:
        solver.set_ns_impl("auto")
    assert ns_kernel.LAUNCHES == {**before, "trio": before["trio"] + 1}
    assert z.is_cuda and float(resid) <= 1e-4


@pytest.mark.parametrize("bad", [
    lambda d: torch.zeros(4, 40, 40, dtype=torch.float64, device=d),
    lambda d: torch.zeros(4, eigh_kernel.MAX_K + 1, eigh_kernel.MAX_K + 1,
                          device=d),
    lambda d: torch.zeros(40, 40, device=d),
    lambda d: torch.zeros(4, 40, 80, device=d)[:, :, :40],
])
def test_kernel_rejects_bad_input(cuda, bad):
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad(cuda), 1.0)
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad(cuda), 1.0, packing="rmul")
    with pytest.raises(ValueError):
        eigh_kernel.launch(bad(cuda))


def test_ns_kernel_rejects_k_above_its_range(cuda):
    """K1/K2 take k <= 128; at 129 the wrapper raises before any launch
    (the solver never sends it there: ``solver.ns_route``)."""
    k = ns_kernel.MAX_K + 1
    before = dict(ns_kernel.LAUNCHES)
    for packing in ns_kernel.LAUNCHES:
        with pytest.raises(ValueError, match=f"k={k}"):
            ns_kernel.launch(torch.zeros(2, k, k, device=cuda), 1.0,
                             packing=packing)
    assert ns_kernel.LAUNCHES == before


def test_jacobi_kernel_rejects_empty_batch(cuda):
    with pytest.raises(ValueError):
        eigh_kernel.launch(torch.zeros(0, 8, 8, device=cuda))


@pytest.mark.parametrize("k", KS)
def test_rmul_kernel_matches_plain(cuda, k):
    """K2 against its plain version and against K1: the same map."""
    rng = np.random.default_rng(100 + k)
    a_np, _ = normal_case(rng, 37, k, 2 * k)
    inflat = (k - 1) / 1.1 if k > 1 else 1.0
    a = torch.from_numpy(a_np).to(cuda)
    before = dict(ns_kernel.LAUNCHES)
    z, iters, resid = ns_kernel.ns_invsqrt_cuda(a, inflat, packing="rmul")
    torch.cuda.synchronize()
    assert ns_kernel.LAUNCHES == {**before, "rmul": before["rmul"] + 1}
    assert float(resid) <= 1e-4 and 1 <= int(iters) <= 24
    z_plain = solver.ns_invsqrt_rmul(a, inflat)
    assert_ns_close(z.cpu().numpy(), z_plain.cpu().numpy(), a_np, inflat,
                    same_iteration=False)
    z_trio, _, _ = ns_kernel.ns_invsqrt_cuda(a, inflat)
    assert_ns_close(z.cpu().numpy(), z_trio.cpu().numpy(), a_np, inflat,
                    same_iteration=False)


@pytest.mark.parametrize("k", KS)
def test_jacobi_kernel_matches_plain(cuda, k):
    """K3 (even k >= 4) and K4 (odd or tiny k) against their plain versions
    on the card: the sweeps' eigenpairs bit for bit, in the same order, on
    the inputs of tests/test_pallas_eigh.py; then the polished
    eigenpairs of the solver's ``A = a_obs + inflat I`` within that file's
    tolerances (:28-35).  (On ``G G^T + 10 I`` at k=96 seven sweeps leave a
    reconstruction error of 4e-5 max|A| after the polish, in the plain
    version as in the TPU kernel; eight reach 1e-6.)"""
    rng = np.random.default_rng(200 + k)
    a = torch.from_numpy(spd_case(rng, 33, k)).to(cuda)
    name = eigh_kernel.kernel_for(k)
    plain = jacobi_parallel if name == "parallel" else jacobi_cyclic
    before = dict(eigh_kernel.LAUNCHES)
    lam, v = eigh_kernel.launch(a)
    torch.cuda.synchronize()
    assert eigh_kernel.LAUNCHES == {**before, name: before[name] + 1}
    lam_p, v_p = plain(a)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)
    a_obs, _ = normal_case(rng, 33, k, 2 * k)
    a_np = a_obs + (k - 1 if k > 1 else 1) / 1.6 * np.eye(k, dtype=np.float32)
    lam_w, v_w = jacobi_eigh(torch.from_numpy(a_np).to(cuda))
    assert_eigh_close(lam_w.cpu().numpy(), v_w.cpu().numpy(), a_np)


@pytest.mark.parametrize("b", [1, 5, 33, 130])
@pytest.mark.parametrize("k", [4, 6, 38, 40, 42, 94, 96])
def test_jacobi_parallel_partition_edges(cuda, k, b):
    """K3 bit for bit against its plain version where its partition has
    edges: a block of four warp-matrices partly filled (b = 1, 5, 33, 130),
    the compile-time k = 40 and 96 and the run-time k around them, k = 94
    with three matrices a block, and k = 4, 6 with most lanes idle."""
    rng = np.random.default_rng(400 + k + b)
    a = torch.from_numpy(spd_case(rng, b, k)).to(cuda)
    lam, v = eigh_kernel.launch(a)
    lam_p, v_p = jacobi_parallel(a)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


@pytest.mark.parametrize("b", [1, 5, 33, 130])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 9, 31, 33, 41, 63, 95])
def test_jacobi_cyclic_partition_edges(cuda, k, b):
    """K4 bit for bit against its plain version where its partition has
    edges: the compile-time k = 41 (two matrices a warp) with an idle half
    warp at odd b, the run-time k below and above a warp, k = 95 with three
    indices a lane, k = 1 with no rotation and k = 2 with one a sweep."""
    rng = np.random.default_rng(500 + k + b)
    a = torch.from_numpy(spd_case(rng, b, k)).to(cuda)
    lam, v = eigh_kernel.launch(a)
    lam_p, v_p = jacobi_cyclic(a)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


@pytest.mark.parametrize("b", [1, 3, 133])
@pytest.mark.parametrize("k", [98, 100, 126, 128, 130, 142, 160, 170, 172,
                               174, 176])
def test_jacobi_parallel_large_k(cuda, k, b):
    """K3 above k = 96, a block of 2 k threads per matrix with V in
    registers, bit for bit against its plain version: odd m with half 0's
    spare register pair (98, 126, 130, 142, 170, 174), even m (100, 128,
    160, 172, 176), the instances at two matrices an SM (k <= 128) and at
    one; a batch of 133 is more than one wave of 132 SMs.  V is never in
    device memory.  Two sweeps, to keep the plain version short."""
    rng = np.random.default_rng(600 + k + b)
    a = torch.from_numpy(spd_case(rng, b, k)).to(cuda)
    cfg = eigh_kernel.config(k)
    assert cfg["v_in_device_memory"] == 0 and cfg["v_in_registers"] == 1
    lam, v = eigh_kernel.launch(a, sweeps=2)
    lam_p, v_p = jacobi_parallel(a, sweeps=2)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [97, 129, 169, 171, 177])
def test_jacobi_cyclic_large_k(cuda, k, b):
    """K4 above k = 96, bit for bit against its plain version: the chain on
    A alone (two warps and one matrix a block, three matrices an SM through
    k = 137, two through 169, one above), then V from the rotation log,
    never in device memory but for the log.  One sweep, to keep the plain
    version short."""
    rng = np.random.default_rng(700 + k + b)
    a = torch.from_numpy(spd_case(rng, b, k)).to(cuda)
    cfg = eigh_kernel.config(k)
    assert cfg["v_in_device_memory"] == 0 and cfg["v_from_log"] == 1
    assert cfg["matrices_per_sm"] >= (3 if k <= 137 else 2 if k <= 169 else 1)
    before = eigh_kernel.LAUNCHES["cyclic"]
    lam, v = eigh_kernel.launch(a, sweeps=1)
    lam_p, v_p = jacobi_cyclic(a, sweeps=1)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)
    assert eigh_kernel.LAUNCHES["cyclic"] == before + 1


@pytest.mark.parametrize("k,b,cap_matrices", [(129, 3 * 132 + 1, None),
                                              (129, 7, 3), (177, 5, 1)])
def test_jacobi_cyclic_log_pieces(cuda, monkeypatch, k, b, cap_matrices):
    """K4 above k = 96 on a batch of more than one wave at three matrices an
    SM (3 x 132 + 1), and on batches whose rotation log passes the cap, cut
    into pieces of ``cap_matrices`` matrices, one launch each: bit for bit
    against the plain version either way.  One sweep."""
    if cap_matrices is not None:
        monkeypatch.setattr(eigh_kernel, "LOG_CAP_BYTES",
                            cap_matrices * eigh_kernel.log_bytes(k, 1))
    pieces = eigh_kernel.log_pieces(b, k, 1)
    assert len(pieces) == (1 if cap_matrices is None else -(-b // cap_matrices))
    rng = np.random.default_rng(750 + k + b)
    a = torch.from_numpy(spd_case(rng, b, k)).to(cuda)
    before = eigh_kernel.LAUNCHES["cyclic"]
    lam, v = eigh_kernel.launch(a, sweeps=1)
    lam_p, v_p = jacobi_cyclic(a, sweeps=1)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)
    assert eigh_kernel.LAUNCHES["cyclic"] == before + len(pieces)


def test_schur_fast_paths_are_exact(cuda):
    """K4's chain above k = 96 divides and takes square roots by the fast
    paths' own instructions, with no branch, where its range test admits
    the operands: there they must be the IEEE results, bit for bit, on every
    float the square root takes (all 1,920,991,232) and on 2^32 random
    divisions in the window."""
    got = eigh_kernel.fast_path_check(cuda)
    print(got)
    assert got["sqrt_checked"] == 0x7f800000 - 0x0d000000
    assert got["div_checked"] == 1 << 32
    assert got["sqrt_differ"] == 0 and got["div_differ"] == 0


@pytest.mark.parametrize("k", [97, 129, 177])
def test_jacobi_chain_floor_runs(cuda, k):
    """The chain's link alone (``eigh_kernel.chain_floor``) launches, ends
    finite and counts no K4 launch."""
    a = torch.from_numpy(spd_case(np.random.default_rng(k), 1, k)).to(cuda)
    before = dict(eigh_kernel.LAUNCHES)
    out = eigh_kernel.chain_floor(a, sweeps=1)
    torch.cuda.synchronize()
    assert out.shape == (32,) and bool(torch.isfinite(out).all())
    assert eigh_kernel.LAUNCHES == before


def test_jacobi_cyclic_nan_matrix_leaves_its_neighbours(cuda):
    """A NaN stays in its matrix, the other matrix of its warp included."""
    a = torch.from_numpy(spd_case(np.random.default_rng(77), 5, 41)).to(cuda)
    a[2, 0, 1] = float("nan")
    lam, v = eigh_kernel.launch(a)
    lam_p, v_p = jacobi_cyclic(a)
    keep = [0, 1, 3, 4]
    assert torch.equal(lam[keep], lam_p[keep]) and torch.equal(v[keep], v_p[keep])
    assert not bool(torch.isfinite(lam[2]).all())


def test_jacobi_cyclic_nan_matrix_leaves_its_neighbours_above_96(cuda):
    """K4 at k = 129, three matrices an SM: a NaN stays in its matrix through
    the chain and the V pass, and the matrices beside it equal the plain
    version."""
    a = torch.from_numpy(spd_case(np.random.default_rng(79), 5, 129)).to(cuda)
    a[2, 0, 1] = float("nan")
    lam, v = eigh_kernel.launch(a, sweeps=1)
    lam_p, v_p = jacobi_cyclic(a, sweeps=1)
    keep = [0, 1, 3, 4]
    assert torch.equal(lam[keep], lam_p[keep]) and torch.equal(v[keep], v_p[keep])
    assert not bool(torch.isfinite(lam[2]).all())


def test_jacobi_parallel_nan_matrix_leaves_its_neighbours(cuda):
    """K3 at k = 128, two matrices an SM: a NaN stays in its matrix, and the
    matrices beside it, on its SM and after it, equal the plain version."""
    a = torch.from_numpy(spd_case(np.random.default_rng(78), 6, 128)).to(cuda)
    a[2, 0, 1] = float("nan")
    assert eigh_kernel.config(128)["matrices_per_sm"] >= 2
    lam, v = eigh_kernel.launch(a, sweeps=2)
    lam_p, v_p = jacobi_parallel(a, sweeps=2)
    keep = [0, 1, 3, 4, 5]
    assert torch.equal(lam[keep], lam_p[keep]) and torch.equal(v[keep], v_p[keep])
    assert not bool(torch.isfinite(lam[2]).all())


@pytest.mark.parametrize("k,threads,matrices", [(41, 128, 8), (9, 128, 4),
                                                (40, 128, 4), (96, 256, 1),
                                                (128, 256, 1), (98, 224, 1),
                                                (176, 352, 1), (129, 64, 1),
                                                (177, 64, 1)])
def test_jacobi_config(cuda, k, threads, matrices):
    """The launch shapes: four warps a block of two k=41 matrices each (K4),
    of one matrix at any other k (K4, and K3 at k=40), one 256-thread block
    per k=96 matrix (K3); above k = 96 a block of 2 k threads (rounded up
    to a warp) per matrix, two resident an SM up to k = 128 (K3), and K4's
    chain on two warps, one matrix a block."""
    cfg = eigh_kernel.config(k)
    assert (cfg["threads"], cfg["matrices"]) == (threads, matrices)
    assert cfg["registers"] > 0 and cfg["blocks_per_sm"] >= 1
    assert cfg["matrices_per_sm"] == matrices * cfg["blocks_per_sm"]
    if eigh_kernel.kernel_for(k) == "parallel" and k > 96:
        assert cfg["blocks_per_sm"] == (2 if k <= 128 else 1)


def test_jacobi_kernel_k96_sweep_level(cuda):
    """K3 at the production k=96: seven sweeps keep their known accuracy on
    ``G G^T + 10 I`` (4.0e-5 max|A| after the polish), eight meet 3e-5."""
    before = eigh_kernel.LAUNCHES["parallel"]
    assert_k96_sweep_level(jacobi_eigh, cuda)
    assert eigh_kernel.LAUNCHES["parallel"] == before + 2


@pytest.mark.parametrize("k", [40, 41])
def test_jacobi_eigh_dispatches_cuda_to_kernel(cuda, k):
    a_np = spd_case(np.random.default_rng(300 + k), 9, k)
    before = sum(eigh_kernel.LAUNCHES.values())
    lam, v = jacobi_eigh(torch.from_numpy(a_np).to(cuda))
    assert sum(eigh_kernel.LAUNCHES.values()) == before + 1
    assert lam.is_cuda and v.is_cuda
    assert_eigh_close(lam.cpu().numpy(), v.cpu().numpy(), a_np)


def test_jacobi_solve_on_cuda_has_no_fallback(cuda, monkeypatch):
    """Under "jacobi" a CUDA solve launches the kernel up to
    ``eigh_kernel.MAX_K`` and takes ``torch.linalg.eigh`` above it (the JAX
    package's VMEM guard), chosen from k before any launch; a kernel that
    fails at a k it takes raises instead of giving way to the library."""
    solver.set_eigh_backend("jacobi")
    try:
        for k, kernel in ((12, True), (eigh_kernel.MAX_K + 1, False)):
            a_np, g_np = normal_case(np.random.default_rng(k), 8, k, 2 * k)
            a, g = (torch.from_numpy(x).to(cuda) for x in (a_np, g_np))
            xb = torch.randn(8, k, device=cuda)
            has = torch.ones(8, dtype=torch.bool, device=cuda)
            before = dict(eigh_kernel.LAUNCHES)
            lib = solver.LIBRARY_SOLVES["linalg_eigh"]
            xa = solver.letkf_solve_from_normal(a, g, xb, k - 1.0, has)
            assert bool(torch.isfinite(xa).all())
            launched = sum(eigh_kernel.LAUNCHES.values()) - sum(before.values())
            assert launched == int(kernel)
            assert solver.LIBRARY_SOLVES["linalg_eigh"] == lib + int(not kernel)

        def broken(*args, **kwargs):
            raise RuntimeError("jacobi_parallel_f32 launch failed")

        monkeypatch.setattr(eigh_kernel, "launch", broken)
        lib = solver.LIBRARY_SOLVES["linalg_eigh"]
        with pytest.raises(RuntimeError, match="launch failed"):
            solver.letkf_solve_from_normal(a[:, :12, :12].contiguous(),
                                           g[:, :12], xb[:, :12], 11.0, has)
        assert solver.LIBRARY_SOLVES["linalg_eigh"] == lib
    finally:
        solver.set_eigh_backend("auto")


@pytest.mark.parametrize("k,name", [(40, "parallel"), (41, "cyclic")])
def test_auto_eigen_factors_launch_jacobi_kernels(cuda, k, name):
    """Under "auto" the eigen factors of a float32 batch on a card are the
    Jacobi kernels' (K3 at even k, K4 at odd), never ``torch.linalg.eigh``;
    above the kernels' k they are ``torch.linalg.eigh``'s, with no launch."""
    a_np, g_np = normal_case(np.random.default_rng(310 + k), 16, k, 2 * k)
    a, g = (torch.from_numpy(x).to(cuda) for x in (a_np, g_np))
    inflat = (k - 1) / 1.6
    before = dict(eigh_kernel.LAUNCHES)
    lam, v, _ = solver.letkf_weight_factors_from_normal(a, g, inflat)
    after = dict(eigh_kernel.LAUNCHES)
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert_eigh_close(lam.cpu().numpy(), v.cpu().numpy(),
                      a_np + inflat * np.eye(k, dtype=np.float32))
    big = torch.eye(eigh_kernel.MAX_K + 1, device=cuda)[None]
    before = dict(eigh_kernel.LAUNCHES)
    lam, v, _ = solver.letkf_weight_factors_from_normal(
        big, torch.zeros(1, big.shape[-1], device=cuda), 1.0)
    assert eigh_kernel.LAUNCHES == before
    assert torch.allclose(lam, torch.full_like(lam, 2.0))


def test_refined_solve_takes_k1_on_card(cuda):
    """The float32 stage of the refined solve is K1 (one launch per distinct
    inflation value), and the solve is within 1e-6 of the analysis scale of
    the float64 solve (tests/test_ns_solver.py:144-163)."""
    k, nb = 40, 64
    a_np, g_np = normal_case(np.random.default_rng(320), nb, k, 80, scale=0.4)
    a, g = (torch.from_numpy(x).to(cuda).double() for x in (a_np, g_np))
    xb = torch.randn(nb, 2, k, device=cuda, dtype=torch.float64)
    has = torch.ones(nb, dtype=torch.bool, device=cuda)
    kw = dict(rtpp_alpha=(0.9, 0.0), rtps_alpha=(0.0, 0.9))
    inflats = ((k - 1) / 1.1, (k - 1) / 1.6)
    before = ns_kernel.LAUNCHES["trio"]
    xa = solver.letkf_solve_group_refined(a, g, xb, inflats, has, **kw)
    assert ns_kernel.LAUNCHES["trio"] == before + 2
    ref = solver.letkf_solve_group_from_normal(
        a, g, xb, inflats, has, solver_dtype=torch.float64, **kw)
    sc = float(ref.abs().max())
    assert float((xa - ref).abs().max()) <= 1e-6 * sc


#: K5's shapes: (batch, records, records within the radius, masked share):
#: the dense vr platform's subchunk (6,033 records), the production slab's
#: chunk (about 14,300 candidate records, the bucketed mask) and rows past
#: the shared-memory stage (read from device memory each pass)
CAP_SHAPES = [(512, 6033, 1500, 0.0), (512, 6033, 1500, 0.1),
              (2048, 14300, 2000, 0.0), (2048, 14300, 2000, 0.1),
              (64, 60000, 3000, 0.0), (64, 60000, 3000, 0.1)]
#: the vr platform's max_lz_pts
CAP_N_MAX = 300
#: the longest row staged in shared memory (cap_search.cu: 200 KB of slots)
CAP_STAGED_MAX_R = 51197


def cap_inputs(cuda, rng, b, r, inside, masked):
    r2, mask = cap_case(rng, b, r, inside, masked)
    return (torch.from_numpy(r2).to(cuda),
            None if mask is None else torch.from_numpy(mask).to(cuda))


def assert_cap_matches_plain(r2, mask, n_max=CAP_N_MAX):
    """K5 against its plain version, ``sel`` and ``over`` bit for bit;
    returns ``over``."""
    sel, over = cap_kernel.launch(r2, mask, n_max, GC1999_SQ)
    sel_p, over_p = cap_kernel.plain(r2, mask, n_max, GC1999_SQ)
    assert torch.equal(sel, sel_p) and torch.equal(over, over_p)
    return over


@pytest.mark.parametrize("b,r,inside,masked", CAP_SHAPES)
def test_cap_kernel_matches_plain(cuda, b, r, inside, masked):
    """At the main path's shapes, in each staging regime, with and without a
    record mask; one launch a call."""
    r2, mask = cap_inputs(cuda, np.random.default_rng(r + int(10 * masked)),
                          b, r, inside, masked)
    before = cap_kernel.LAUNCHES
    over = assert_cap_matches_plain(r2, mask)
    assert cap_kernel.LAUNCHES == before + 1
    assert over.any()
    assert cap_kernel.config(r)["staged"] == int(r <= CAP_STAGED_MAX_R)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("r", [CAP_N_MAX + 1, 1031, CAP_STAGED_MAX_R,
                               CAP_STAGED_MAX_R + 1])
def test_cap_kernel_edges(cuda, r, offset):
    """Rows at every 4-byte offset in their first slot (a view whose data
    starts ``offset`` floats into its buffer), ties at the candidates,
    +inf, NaN, denormals, exactly ``n_max`` and ``n_max + 1`` records
    inside, rows not over; R = n_max + 1 and either side of the stage's
    limit; with and without a mask, and at n_max = 0."""
    rng = np.random.default_rng(r + offset)
    rows = np.concatenate([cap_tie_rows(r, CAP_N_MAX),
                           cap_case(rng, 5, r, inside=2 * CAP_N_MAX)[0],
                           cap_case(rng, 3, r, inside=CAP_N_MAX // 3)[0]])
    buf = torch.empty(rows.size + offset, device=cuda)
    r2 = buf[offset:].view(rows.shape)
    r2.copy_(torch.from_numpy(rows))
    over = assert_cap_matches_plain(r2, None)
    assert over.any() and not over.all()
    mask = torch.from_numpy(rng.random(r) >= 0.2).to(cuda)
    assert not assert_cap_matches_plain(r2, mask).all()
    assert_cap_matches_plain(r2, mask, n_max=0)


def test_cap_kernel_does_not_sync(cuda):
    """A launch under ``set_sync_debug_mode("error")`` raises nothing."""
    r2, mask = cap_inputs(cuda, np.random.default_rng(2), 64, 6033, 1500,
                          0.1)
    cap_kernel.launch(r2, mask, CAP_N_MAX, GC1999_SQ)   # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sel, over = cap_kernel.launch(r2, mask, CAP_N_MAX, GC1999_SQ)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sel_p, over_p = cap_kernel.plain(r2, mask, CAP_N_MAX, GC1999_SQ)
    assert torch.equal(sel, sel_p) and torch.equal(over, over_p)


def test_cap_kernel_config_and_compiler_report(cuda):
    """Both instances without spills or a stack frame; the slab's rows
    staged with at least three blocks an SM."""
    lib = cuda_build.build(cap_kernel.SOURCE)[0]
    report = {name: res for name, res in cuda_build.resources(lib).items()
              if "cap_search_kernel" in name}
    assert len(report) == 2
    for res in report.values():
        assert res["spill_stores"] == res["spill_loads"] == 0, report
        assert res["stack"] == 0, report
    slab = cap_kernel.config(14300)
    assert slab["staged"] == 1 and slab["blocks_per_sm"] >= 3, slab
    assert cap_kernel.config(60000)["staged"] == 0


def test_terms_from_r2_takes_the_cap_kernel_on_a_card(cuda):
    """The capped branch on a CUDA tensor is one K5 launch, and its terms are
    bit for bit those of the branch's own code (the weights read the
    masked distances there); traced, ``accumulate.cap_launches`` counts it
    and ``accumulate.cap_bound`` reads the kernel's ``over``."""
    rng = np.random.default_rng(9)
    r2, mask = cap_inputs(cuda, rng, 256, 6033, 1500, 0.1)
    k = 8
    fused = torch.from_numpy(
        rng.standard_normal((6033, k * (k + 1))).astype(np.float32)).to(cuda)
    nvalid = torch.from_numpy(rng.integers(1, 4, 6033, dtype=np.int32)).to(cuda)
    before = cap_kernel.LAUNCHES
    tracing.reset_counters()
    with tracing.record():
        a, g, count = dense.terms_from_r2(
            r2, fused, nvalid, n_max=CAP_N_MAX,
            weight_function=WEIGHT_GAUSSIAN, row_mask=mask)
    got = tracing.counters()
    tracing.reset_counters()
    assert cap_kernel.LAUNCHES == before + 1
    assert got["accumulate.cap_launches"] == 1

    r2m = torch.where(mask[None, :], r2, float("inf"))
    sel = r2m <= dense._cap_threshold(r2m, CAP_N_MAX, GC1999_SQ)[:, None]
    w2 = torch.exp(-0.5 * torch.where(sel, r2m, 0.0))
    out = (torch.where(sel, w2, 0.0) @ fused).view(-1, k, k + 1)
    want = (sel.to(torch.float32) @ nvalid.to(torch.float32)).to(torch.int32)
    assert torch.equal(a, out[:, :, :k]) and torch.equal(g, out[:, :, k])
    assert torch.equal(count, want)
    assert got["accumulate.cap_bound"] == int(
        ((r2m <= GC1999_SQ).sum(1) > CAP_N_MAX).sum())
