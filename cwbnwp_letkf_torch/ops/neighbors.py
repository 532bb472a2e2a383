"""Localization-normalized coordinates (the neighbor search is not ported)."""
from __future__ import annotations

import torch


def normalize_coords(xyz: torch.Tensor, hclr_km: float, vclr_km: float):
    """Scale (x, y, z) meters by the localization radii, km -> m.

    Horizontal coordinates are divided by ``hclr*1e3``; the vertical one by
    ``vclr*1e3`` when ``vclr > 0``, else scaled to exactly 0 (2-D
    localization; module_localization.f90:76-82,148-157).
    """
    h_inv = 1.0 / (hclr_km * 1e3)
    v_inv = 1.0 / (vclr_km * 1e3) if vclr_km > 0.0 else 0.0
    scale = torch.tensor([h_inv, h_inv, v_inv], dtype=xyz.dtype,
                         device=xyz.device)
    return xyz * scale
