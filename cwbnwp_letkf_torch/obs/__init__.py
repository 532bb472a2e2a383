"""Observation ingest and host-side observation containers (numpy).

* base.py      — unified flat obs arrays + per-platform static config
* gts.py       — WRFDA "omboma" conventional-obs text parser and the
                 obs_gts station-altitude lookup
* radar.py     — radar retrieval (dbz/vr/zdr/kdp) text parser
* synthetic.py — synthetic obs generators for tests and the on-card smoke
"""

from .base import PlatformObs, PlatformStatic, platform_statics_from_config

__all__ = ["PlatformObs", "PlatformStatic", "platform_statics_from_config"]
