"""The port's plain Jacobi eigensolvers against the TPU kernels, on the CPU.

The TPU kernels run in Pallas interpret mode, as tests/test_pallas_eigh.py
runs them; tolerances are that file's (:28-35).  Both sides return the
eigenpairs unsorted, in the kernels' order, so the eigenvalues are also
compared element by element.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.ops.pallas_eigh import jacobi_eigh as jacobi_eigh_pallas
from cwbnwp_letkf_torch.ops import eigh_kernel
from cwbnwp_letkf_torch.ops.jacobi_eigh import (jacobi_cyclic, jacobi_eigh,
                                                jacobi_parallel, round_robin)

from .torch_parity import (assert_eigh_close, assert_k96_sweep_level,  # noqa: F401
                           one_torch_thread, spd_case)


@pytest.mark.parametrize("k", [4, 16, 40, 2, 3, 9, 13, 41])
def test_jacobi_eigh_matches_pallas_kernel(k):
    """k in {4, 16, 40}: the round-robin kernel (K3); {2, 3, 9, 13, 41}: the
    sequential one (K4), 41 being the odd k a path runs.  The inputs of
    tests/test_pallas_eigh.py:27-29."""
    a = spd_case(np.random.default_rng(71), 6, k)
    lam_p, v_p = jacobi_eigh_pallas(jnp.asarray(a), interpret=True)
    lam, v = jacobi_eigh(torch.from_numpy(a))
    assert lam.shape == (6, k) and v.shape == (6, k, k)
    assert_eigh_close(lam.numpy(), v.numpy(), a, lam_ref=np.asarray(lam_p))
    assert_eigh_close(np.asarray(lam_p), np.asarray(v_p), a)


@pytest.mark.parametrize("k", [16, 9])
def test_same_rotations_as_pallas_kernel_in_float64(k):
    """Run in float64, both sides apply the same rotations in the same
    order.  (In float32 their roundings differ, and where a rotation meets
    two nearly equal diagonal entries the two can leave a pair of eigenvalues
    in swapped places: one matrix in 30 at k=40 with other seeds.)"""
    a = spd_case(np.random.default_rng(110), 6, k).astype(np.float64)
    lam_p, v_p = jacobi_eigh_pallas(jnp.asarray(a), interpret=True,
                                    polish=False)
    lam, v = jacobi_eigh(torch.from_numpy(a), polish=False)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_p), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_p), rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [6, 9])
def test_plain_versions_without_polish(k):
    """The sweeps alone already reconstruct A; the polish only refines."""
    a = spd_case(np.random.default_rng(80 + k), 5, k)
    plain = jacobi_parallel if k % 2 == 0 else jacobi_cyclic
    lam, v = plain(torch.from_numpy(a))
    assert_eigh_close(lam.numpy(), v.numpy(), a)
    lam_w, _ = jacobi_eigh(torch.from_numpy(a), polish=False)
    assert torch.equal(lam_w, lam)


def test_plain_jacobi_k96_sweep_level():
    """Seven sweeps at the production k=96 keep their known accuracy."""
    assert_k96_sweep_level(jacobi_eigh, "cpu")


def test_round_robin_meets_every_pair_once_per_sweep():
    k = 10
    tables = round_robin(k, k - 1)
    pairs = {frozenset((int(t[i]), int(t[k // 2 + i])))
             for t in tables[:-1] for i in range(k // 2)}
    assert len(pairs) == k * (k - 1) // 2
    assert tables[0].tolist() == list(range(k))


@pytest.mark.parametrize("k", [4, 6, 8, 40, 96])
def test_ring_pairing_closed_form_matches_round_robin(k):
    """K3's closed-form pairing equals the plain version's table at every
    round of seven sweeps, the last row (the order the output is gathered
    in) included."""
    rounds = 7 * (k - 1)
    tables = round_robin(k, rounds).tolist()
    for r in range(rounds + 1):
        assert eigh_kernel.ring_pairing(k, r) == tables[r], (k, r)


def test_jacobi_eigh_takes_plain_version_on_cpu():
    a = torch.from_numpy(spd_case(np.random.default_rng(90), 3, 8))
    before = dict(eigh_kernel.LAUNCHES)
    lam, v = jacobi_eigh(a, polish=False)
    assert eigh_kernel.LAUNCHES == before
    lam_p, v_p = jacobi_parallel(a)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 4),
    torch.zeros(2, 4, 5),
    torch.zeros(2, 4, 4, device="meta"),
])
def test_jacobi_eigh_rejects_what_it_does_not_take(bad):
    with pytest.raises(ValueError):
        jacobi_eigh(bad)


def test_round_robin_plain_needs_even_k():
    with pytest.raises(ValueError):
        jacobi_parallel(torch.zeros(2, 5, 5))


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 40, 40),                          # on the CPU
    torch.zeros(4, 40, 40, dtype=torch.float64),
    torch.zeros(4, eigh_kernel.MAX_K + 1, eigh_kernel.MAX_K + 1),
    torch.zeros(40, 40),
    torch.zeros(4, 40, 80)[:, :, :40],
    torch.zeros(0, 40, 40),
])
def test_kernel_wrapper_rejects_what_it_does_not_take(bad):
    before = dict(eigh_kernel.LAUNCHES)
    with pytest.raises(ValueError):
        eigh_kernel.launch(bad)
    assert eigh_kernel.LAUNCHES == before
