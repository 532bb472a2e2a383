"""Device-ready observation platforms for the LETKF update.

Port of the containers of the JAX package's ``ops/update.py`` and of
``prepare_platform``.  The per-variable and per-group update paths are not
ported yet; the fused cycle (:mod:`.cycle`) is the port's update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.base import PlatformObs, PlatformStatic
from .whiten import ObsStats, platform_obs_stats

#: record count from which a platform takes the block-culled (bucketed)
#: accumulation instead of the all-records dense one
BUCKET_MIN_RECORDS = 8192


class BucketBudget(NamedTuple):
    """A planned candidate-block budget, valid only for its block size."""

    block_size: int
    max_blocks: int


class DevicePlatform(NamedTuple):
    """One platform's observations on the device, with per-obs statistics.

    ``cache`` memoizes the fused tables and blockings derived from the
    immutable statistics, across variable groups and cycle calls.
    """

    static: PlatformStatic
    xyz: torch.Tensor       # [R, 3] meters
    stats: ObsStats
    cache: dict | None = None


def prepare_platform(
    static: PlatformStatic,
    obs: PlatformObs,
    *,
    device: torch.device | str,
    norain_value: float = -5.0,
) -> DevicePlatform:
    """Copy one platform's arrays to ``device`` and compute its statistics."""

    def put(x):
        return torch.as_tensor(x, device=device)

    stats = platform_obs_stats(
        put(obs.obs), put(obs.hdxb), put(obs.error), put(obs.qc),
        static.err_muti, static.err_rej, is_dbz=static.is_dbz,
        norain_value=norain_value)
    return DevicePlatform(static=static, xyz=put(obs.xyz), stats=stats,
                          cache={})
