"""Structured run metrics: the observability layer the reference lacks.

Port of the JAX package's ``metrics.py``, with the same ``to_dict()`` keys.
The reference prints only stage wall clocks (timer(), mpi_util.f90:66-71;
cwb_letkf.f90:25-80) and silently drops QC/outlier-rejected observations
(module_letkf_core.f90:429-437).  Here every cycle produces a
:class:`RunMetrics` record: per-stage wall clock, per-platform obs counts and
acceptance rates, per-variable-group update timings and analyzed point
counts — queryable in-process and serializable to one JSON line for log
scraping.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PlatformMetrics:
    name: str
    kind: str
    records: int
    observed_vars: int
    #: fraction of (var, record) slots passing QC + outlier rejection
    #: (letkf_core.f90:429-437 drops these silently per gridpoint; here the
    #: gate is per-obs and countable)
    accepted: int
    slots: int

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.slots if self.slots else 0.0


@dataclass
class GroupMetrics:
    variables: List[str]
    points: int
    #: host seconds of the group's launch (load, copy, update call) and
    #: drain (tune_q, fetch, store); the groups' sum is the update stage
    #: less the loop's own overhead
    wall_s: float
    #: bucketed candidate-block budget overruns (obs silently dropped when
    #: nonzero — plan_max_blocks-sized budgets keep this 0 by construction)
    bucket_overflow: int = 0
    #: Newton-Schulz convergence certificate: max |ZY - I| at loop exit
    #: (0.0 on eigh backends; > tol means the iteration budget ran out)
    ns_residual: float = 0.0
    #: host seconds of the field read and its host-to-device copy (the
    #: spans ``driver.load`` and ``driver.h2d``).  The copy is from pageable
    #: memory and blocking: it waits for the stream to drain, so it holds
    #: whatever device work of the previous group is still queued
    load_s: float = 0.0


@dataclass
class RunMetrics:
    """One analysis cycle's metrics."""

    stages: Dict[str, float] = field(default_factory=dict)
    platforms: List[PlatformMetrics] = field(default_factory=list)
    groups: List[GroupMetrics] = field(default_factory=list)
    #: per-stage device seconds on a sample (profiling.device_breakdown)
    device_breakdown: Optional[Dict[str, float]] = None
    #: the mesh decomposition (the reference's rank->columns ownership dump
    #: to rsl.out.0000, mpi_util.f90:177-187)
    mesh_layout: Optional[dict] = None
    _t0: float = field(default_factory=time.perf_counter)
    _last: float = field(default_factory=time.perf_counter)

    def stage(self, name: str):
        """Close the current stage interval under ``name`` (host seconds on
        ``time.perf_counter``)."""
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + (now - self._last)
        self._last = now

    def add_platform(self, dp) -> None:
        """Record counts from a prepared DevicePlatform (on any device)."""
        valid = dp.stats.valid.cpu().numpy()
        self.platforms.append(PlatformMetrics(
            name=dp.static.name,
            kind=dp.static.kind,
            records=int(dp.xyz.shape[0]),
            observed_vars=int(valid.shape[0]),
            accepted=int(valid.sum()),
            slots=int(valid.size),
        ))

    def add_group(self, variables: List[str], points: int, wall_s: float,
                  bucket_overflow: int = 0, ns_residual: float = 0.0,
                  load_s: float = 0.0):
        self.groups.append(GroupMetrics(variables, points, wall_s,
                                        bucket_overflow, ns_residual,
                                        load_s))

    def record_mesh(self, mesh, n_points: int) -> None:
        """Record the mesh decomposition of ``n_points`` analysis points
        (a :class:`..parallel.mesh.Mesh`): its devices, its axis, the
        points of each shard and the device models."""
        n = mesh.size
        self.mesh_layout = {
            "devices": n,
            "axes": {str(k): int(v) for k, v in mesh.shape.items()},
            "points_per_device": -(-int(n_points) // n),
            "device_kinds": sorted(set(mesh.kinds)),
        }

    @property
    def total_var_points(self) -> int:
        return sum(len(g.variables) * g.points for g in self.groups)

    @property
    def update_wall_s(self) -> float:
        return sum(g.wall_s for g in self.groups)

    def to_dict(self) -> dict:
        out = {
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
            "platforms": [
                {"name": p.name, "kind": p.kind, "records": p.records,
                 "observed_vars": p.observed_vars,
                 "accepted": p.accepted, "slots": p.slots,
                 "acceptance_rate": round(p.acceptance_rate, 4)}
                for p in self.platforms
            ],
            "groups": [
                {"variables": g.variables, "points": g.points,
                 "wall_s": round(g.wall_s, 4),
                 "bucket_overflow": g.bucket_overflow,
                 "ns_residual": round(g.ns_residual, 8),
                 "load_s": round(g.load_s, 4)}
                for g in self.groups
            ],
            "total_var_points": self.total_var_points,
            "update_wall_s": round(self.update_wall_s, 4),
            "var_points_per_s": round(
                self.total_var_points / self.update_wall_s, 1)
            if self.update_wall_s else 0.0,
        }
        if self.mesh_layout is not None:
            out["mesh_layout"] = self.mesh_layout
        if self.device_breakdown is not None:
            out["device_breakdown"] = {
                k: round(float(v), 6) for k, v in self.device_breakdown.items()
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
