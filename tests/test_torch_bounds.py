"""The kernels' work counts and their bounds on an H100 (no card needed).

``ns_kernel.work`` and ``eigh_kernel.work`` count the float32 operations and
the device-memory bytes of one launch from its shape; ``cuda_build.bound_ms``
turns them into the least time the card could take.  The counts are pinned
at the shapes ``chip_smoke.py`` times, and held against a brute count of what
the plain PyTorch versions do at a small size.
"""
import pytest
import torch
from torch.overrides import TorchFunctionMode

from cwbnwp_letkf_torch.ops import cuda_build, eigh_kernel, jacobi_eigh, ns_kernel, solver

#: (label, work, flop to three digits, bound in ms to three digits or None)
SHAPES = [
    ("K1 [12288,40,40]", ns_kernel.work(12288, 40, 5), 23.59e9, 0.352),
    ("K1 [2048,96,96]", ns_kernel.work(2048, 96, 5), 54.36e9, 0.811),
    ("K3 [4096,40,40]", eigh_kernel.work("parallel", 4096, 40), 16.10e9, 0.240),
    ("K3 [2048,96,96]", eigh_kernel.work("parallel", 2048, 96), 112.97e9, 1.686),
    ("K4 [4096,41,41]", eigh_kernel.work("cyclic", 4096, 41), 17.35e9, 0.259),
    ("K4 [512,9,9]", eigh_kernel.work("cyclic", 512, 9), 20.9e6, None),
    # the large-ensemble shapes of chip_smoke.py phase 17
    ("K1 [2048,128,128]", ns_kernel.work(2048, 128, 5), 128.85e9, 1.923),
    ("K3 [1024,128,128]", eigh_kernel.work("parallel", 1024, 128), 134.23e9, 2.004),
    ("K3 [512,160,160]", eigh_kernel.work("parallel", 512, 160), 131.29e9, 1.960),
    ("K3 [256,176,176]", eigh_kernel.work("parallel", 256, 176), 87.43e9, 1.305),
    ("K4 [256,129,129]", eigh_kernel.work("cyclic", 256, 129), 34.35e9, 0.513),
    ("K4 [64,177,177]", eigh_kernel.work("cyclic", 64, 177), 22.23e9, 0.332),
]
#: the shapes with a bound: all but K4 [512,9,9]
BOUNDED = [s for s in SHAPES if s[3] is not None]


@pytest.mark.parametrize("label,work,flop,bound", SHAPES, ids=[s[0] for s in SHAPES])
def test_work_at_the_timed_shapes(label, work, flop, bound):
    assert work[0] == pytest.approx(flop, rel=5e-4 if flop > 1e9 else 5e-3)


@pytest.mark.parametrize("label,work,flop,bound", BOUNDED, ids=[s[0] for s in BOUNDED])
def test_bound_at_the_timed_shapes(label, work, flop, bound):
    """All ten are bound by operations, not bytes."""
    got = cuda_build.bound_ms(*work)
    assert round(got, 3) == bound
    assert got == pytest.approx(1e3 * work[0] / cuda_build.PEAK_FP32_FLOPS, rel=1e-12)
    assert got > 1e3 * work[1] / cuda_build.PEAK_HBM_BYTES_PER_S


def test_bound_below_a_launch_at_k9():
    assert cuda_build.bound_ms(*eigh_kernel.work("cyclic", 512, 9)) < 1e-3


@pytest.mark.parametrize("work,nbytes", [
    (ns_kernel.work(12288, 40, 5), 157e6),
    (ns_kernel.work(2048, 96, 5), 151e6),
    (eigh_kernel.work("parallel", 4096, 40), 53e6),
    (eigh_kernel.work("cyclic", 512, 9), 0.35e6),
    (ns_kernel.work(2048, 128, 5), 268.4e6),
    (eigh_kernel.work("parallel", 256, 176), 63.6e6),
    (eigh_kernel.work("cyclic", 64, 177), 16.1e6),
])
def test_bytes_at_the_timed_shapes(work, nbytes):
    assert work[1] == pytest.approx(nbytes, rel=5e-3)


def test_bound_is_the_larger_of_the_two():
    assert cuda_build.bound_ms(67e12, 1.0) == pytest.approx(1e3)
    assert cuda_build.bound_ms(1.0, 3.35e12) == pytest.approx(1e3)
    assert cuda_build.bound_ms(67e9, 3.35e10) == pytest.approx(10.0)
    assert cuda_build.bound_ms(0.0, 0.0) == 0.0


def test_work_is_linear_in_batch_and_steps():
    flop, nbytes = ns_kernel.work(7, 12, 3)
    assert ns_kernel.work(14, 12, 3) == (2 * flop, 2 * nbytes)
    assert ns_kernel.work(7, 12, 4.5)[0] == pytest.approx(1.5 * flop)
    flop, nbytes = eigh_kernel.work("parallel", 5, 8, sweeps=2)
    assert eigh_kernel.work("parallel", 10, 8, sweeps=4) == (4 * flop, 2 * nbytes)
    with pytest.raises(ValueError):
        eigh_kernel.work("qr", 1, 8)


class _CountProducts(TorchFunctionMode):
    """Counts the batched ``k x k`` matrix products made under it."""

    def __init__(self, k):
        super().__init__()
        self.k = k
        self.flop = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.matmul, torch.Tensor.__matmul__, torch.matmul):
            assert all(tuple(x.shape[-2:]) == (self.k, self.k) for x in args)
            self.flop += 2 * self.k * out.numel()
        return out


@pytest.mark.parametrize("plain", [solver.ns_invsqrt, solver.ns_invsqrt_rmul],
                         ids=["trio", "rmul"])
@pytest.mark.parametrize("steps", [1, 4])
def test_ns_work_is_the_plain_versions_products(plain, steps):
    """``tol=0`` never stops early, so ``max_iters`` is the step count."""
    b, k = 3, 6
    y = torch.randn(b, k, 2 * k, generator=torch.Generator().manual_seed(0))
    a = y @ y.transpose(1, 2)
    with _CountProducts(k) as counter:
        _, iters, _ = plain(a, 2.0, tol=0.0, max_iters=steps, return_info=True)
    assert iters == steps
    flop, nbytes = ns_kernel.work(b, k, steps)
    assert counter.flop == flop
    assert nbytes == 4 * (a.numel() + a.numel())


@pytest.mark.parametrize("name,k", [("parallel", 6), ("cyclic", 5)])
def test_jacobi_work_is_the_plain_versions_rotated_pairs(monkeypatch, name, k):
    b, sweeps = 3, 2
    y = torch.randn(b, k, k, generator=torch.Generator().manual_seed(1))
    a = y @ y.transpose(1, 2) + torch.eye(k)
    pairs = []
    rotated = jacobi_eigh._rotated

    def counting(c, s, x, y):
        pairs.append(x.numel())
        return rotated(c, s, x, y)

    monkeypatch.setattr(jacobi_eigh, "_rotated", counting)
    plain = getattr(jacobi_eigh, f"jacobi_{name}")
    lam, v = plain(a, sweeps=sweeps)
    flop, nbytes = eigh_kernel.work(name, b, k, sweeps=sweeps)
    assert 6 * sum(pairs) == flop
    assert nbytes == 4 * (a.numel() + lam.numel() + v.numel())
