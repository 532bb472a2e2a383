"""The CUDA Newton-Schulz kernel against its plain PyTorch version, on a card.

Every test here needs a CUDA device and ``nvcc``; without a card they skip.
On the card run them alone, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from cwbnwp_letkf_torch.ops import ns_kernel, solver

from .torch_parity import assert_ns_close, ill_conditioned_case, normal_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,b", [(1, 3), (8, 7), (12, 5), (21, 33), (40, 129),
                                 (64, 65), (96, 17)])
def test_kernel_matches_plain(cuda, k, b):
    rng = np.random.default_rng(k)
    a_np, _ = normal_case(rng, b, k, 2 * k)
    inflat = (k - 1) / 1.1
    a = torch.from_numpy(a_np).to(cuda)
    before = ns_kernel.LAUNCHES
    z, iters, resid = ns_kernel.ns_invsqrt_cuda(a, inflat)
    torch.cuda.synchronize()
    assert ns_kernel.LAUNCHES == before + 1
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


def test_ns_z_dispatches_cuda_to_kernel(cuda):
    rng = np.random.default_rng(5)
    a_np, _ = normal_case(rng, 9, 40, 80)
    before = ns_kernel.LAUNCHES
    z, resid = solver._ns_z(torch.from_numpy(a_np).to(cuda), 39 / 1.6)
    assert ns_kernel.LAUNCHES == before + 1
    assert z.is_cuda and float(resid) <= 1e-4


@pytest.mark.parametrize("bad", [
    lambda d: torch.zeros(4, 40, 40, dtype=torch.float64, device=d),
    lambda d: torch.zeros(4, 97, 97, device=d),
    lambda d: torch.zeros(40, 40, device=d),
    lambda d: torch.zeros(4, 40, 80, device=d)[:, :, :40],
])
def test_kernel_rejects_bad_input(cuda, bad):
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad(cuda), 1.0)
