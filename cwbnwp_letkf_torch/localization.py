"""Distance-based R-localization weight functions on torch tensors.

Port of the JAX package's ``localization.py`` (module_localization.f90 and
module_letkf_core.f90 of the Fortran reference).  Every function takes the
squared localization-normalized distance ``r2``, or the distance itself.
"""
from __future__ import annotations

import torch

from .constants import GC1999

#: Gaussian weight_function id (any value != 1; module_letkf_core.f90:443)
WEIGHT_GAUSSIAN = 0
#: Gaspari-Cohn weight_function id (module_letkf_core.f90:443)
WEIGHT_GC1999 = 1

_A = GC1999 / 2.0  # sqrt(10/3): the GC support half-width in normalized units


def gaspari_cohn_1999(x: torch.Tensor) -> torch.Tensor:
    """Gaspari & Cohn (1999) eq. 4.10 compact correlation function.

    ``x`` is the normalized distance; the support ends at
    ``x = 2*sqrt(10/3) = GC1999`` (module_localization.f90:333-364).
    """
    z = x / _A
    z2 = z * z
    inner = z2 * (z * (z * (-0.25 * z + 0.5) + 0.625) - 5.0 / 3.0) + 1.0
    zs = z.clamp_min(1e-30)  # guards (2/3)/z at z = 0
    outer = (z * (z * (z * (z * ((1.0 / 12.0) * z - 0.5) + 0.625) + 5.0 / 3.0)
                  - 5.0) + 4.0 - (2.0 / 3.0) / zs)
    # the outer polynomial can round to a tiny negative near z = 2; clamp so
    # sqrt(GC) in the error weighting never gives NaN
    return torch.where(z <= 1.0, inner,
                       torch.where(z <= 2.0, outer, 0.0)).clamp_min(0.0)


def obs_error_inv_weight(r2: torch.Tensor, err, weight_function: int):
    """Localized inverse observation error (module_letkf_core.f90:443-450).

    Gaussian (``weight_function != 1``): ``1 / (err * exp(0.25 r2))``;
    Gaspari-Cohn: ``sqrt(GC(sqrt(r2))) / err``.
    """
    if weight_function == WEIGHT_GC1999:
        return torch.sqrt(gaspari_cohn_1999(torch.sqrt(r2))) / err
    return 1.0 / (err * torch.exp(0.25 * r2))


def normalized_r2(dx, dy, dz, hclr_inv, vclr_inv):
    """Squared normalized distance (module_localization.f90:148-157).

    ``vclr_inv <= 0`` drops the vertical term (2-D localization); ``None``
    omits it.
    """
    r2 = (dx * hclr_inv) ** 2 + (dy * hclr_inv) ** 2
    if vclr_inv is not None:
        r2 = r2 + torch.where(torch.as_tensor(vclr_inv) > 0.0,
                              (dz * vclr_inv) ** 2, 0.0)
    return r2
