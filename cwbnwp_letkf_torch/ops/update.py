"""Per-variable and per-group LETKF updates over a batch of analysis points.

Port of the JAX package's ``ops/update.py``: the library path behind the
one-variable-at-a-time analysis (``driver.run_analysis(fuse_variables=False)``
there).  Points are Hilbert-ordered and processed in chunks; per chunk each
active platform's whitened normal terms are accumulated, densely over all
records (:mod:`.dense`), over culled record blocks (:mod:`.bucketed`) or from
each point's nearest records (:mod:`.neighbors` and :mod:`.whiten`), and the
ensemble-space solve (:mod:`.solver`) runs on the batch.  The chunk loop
is an eager Python loop.  The fused multi-group cycle is :mod:`.cycle`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from ..obs.base import PlatformObs, PlatformStatic
from .bucketed import (auto_block_size, bucket_platform,
                       bucketed_platform_terms, default_max_blocks, hilbert3,
                       pad_last, required_max_blocks)
from .dense import dense_platform_terms, fused_platform_table, pair_factors
from .neighbors import normalize_coords, radius_neighbors
from .solver import letkf_solve_from_normal, letkf_solve_group_from_normal
from .whiten import ObsStats, accumulate_platform_terms, platform_obs_stats

#: normal-term accumulation methods: "dense" (one product against the fused
#: per-record table), "bucketed" (the same over culled record blocks),
#: "gather" (top-k neighbor search and obs gather, the reference's kd-tree
#: structure) and "auto" (bucketed from BUCKET_MIN_RECORDS records, else
#: dense).  The same result wherever the cap does not bind; where it binds
#: gather keeps the n_max nearest records and dense/bucketed the records
#: under the cap multisection's threshold.
ACCUMULATE_METHODS = ("dense", "gather", "bucketed", "auto")

#: record count from which a platform takes the block-culled (bucketed)
#: accumulation instead of the all-records dense one
BUCKET_MIN_RECORDS = 8192


class BucketBudget(NamedTuple):
    """A planned candidate-block budget, valid only for its block size."""

    block_size: int
    max_blocks: int


class DevicePlatform(NamedTuple):
    """One platform's observations on the device, with per-obs statistics.

    ``cache`` memoizes the tables and blockings derived from the immutable
    statistics, across variable groups and calls.
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


def dense_table(dp: DevicePlatform, mask: tuple, dtype):
    """The platform's fused table and accepted-obs counts for one
    assimilation mask, in record order (:func:`.dense.fused_platform_table`),
    built once per ``(mask, dtype)`` and kept in ``dp.cache``."""
    cache = dp.cache if dp.cache is not None else {}
    key = ("fused", mask, str(dtype))
    if key not in cache:
        cache[key] = fused_platform_table(dp.stats, mask, dtype=dtype)
    return cache[key]


def dense_factors(dp: DevicePlatform, masks: tuple, dtype):
    """The :class:`.dense.PairFactors` of :func:`dense_table`'s tables, one
    per assimilation mask of ``masks``, in record order
    (:func:`.dense.pair_factors`), built once per ``(masks, dtype)`` and
    kept in ``dp.cache``."""
    cache = dp.cache if dp.cache is not None else {}
    key = ("factors", masks, str(dtype))
    if key not in cache:
        cache[key] = pair_factors(dp.stats, masks, dtype=dtype)
    return cache[key]


def _check_method(method: str) -> None:
    if method not in ACCUMULATE_METHODS:
        raise ValueError(f"method must be one of {ACCUMULATE_METHODS}")


def _resolve_kind(method: str, dp: DevicePlatform) -> str:
    if method == "auto":
        return ("bucketed" if dp.xyz.shape[0] >= BUCKET_MIN_RECORDS
                else "dense")
    return method


def _active(platforms, ivar):
    """``[(platform, its records normalized for ivar)]`` of the platforms
    that feed ``ivar``."""
    return [(dp, normalize_coords(dp.xyz, dp.static.hclr[ivar],
                                  dp.static.vclr[ivar]))
            for dp in platforms
            if dp.static.active(ivar) and dp.xyz.shape[0] > 0]


def _platform_accumulators(active, kinds, iv, max_blocks, solver_dtype,
                           q_chunks=None):
    """Each active platform's accumulation: ``(dp, obs_norm, kind, payload)``.

    The payload is the fused table, its counts and its factors, or the
    blocking (which holds its own table and factors, in block order) and its
    candidate budget; a gather platform has none.  The
    budget is the planned one (``max_blocks`` a dict of
    :class:`BucketBudget`, or an int), else the exact need of ``q_chunks``
    ``[n_chunks, chunk, 3]`` rounded up to 16s, else the heuristic.
    """
    accs = []
    dtype = str(solver_dtype)
    for (dp, on), kind in zip(active, kinds):
        st = dp.static
        cache = dp.cache if dp.cache is not None else {}
        mask = st.assim_mask(iv)
        if kind == "gather":
            accs.append((dp, on, "gather", None))
            continue
        if kind == "dense":
            accs.append((dp, on, "dense", (
                *dense_table(dp, mask, solver_dtype),
                dense_factors(dp, (mask,), solver_dtype)[0])))
            continue
        mb_req = (max_blocks.get(st.name) if isinstance(max_blocks, dict)
                  else max_blocks)
        bs = (mb_req.block_size if isinstance(mb_req, BucketBudget)
              else auto_block_size(on))
        bkey = ("bucketed", mask, dtype, st.hclr[iv], st.vclr[iv], bs)
        if bkey not in cache:
            cache[bkey] = bucket_platform(on, dp.stats, mask, block_size=bs,
                                          dtype=solver_dtype)
        bp = cache[bkey]
        if isinstance(mb_req, BucketBudget):
            mb = min(mb_req.max_blocks, bp.n_blocks)
        elif mb_req:
            mb = mb_req
        elif q_chunks is not None:
            qn = normalize_coords(q_chunks, st.hclr[iv], st.vclr[iv])
            needed = required_max_blocks(qn, bp.centers, bp.radii)
            mb = min(bp.n_blocks, max(16, -(-needed // 16) * 16))
        else:
            mb = default_max_blocks(bp.n_blocks)
        accs.append((dp, on, "bucketed", (bp, mb)))
    return accs


def _accumulate_chunk(qc, accs, iv, weight_function, solver_dtype, k):
    """All platforms' normal terms for one chunk of points:
    ``(a_obs [C, k, k], g [C, k], count [C] int32, overflow)``."""
    c = qc.shape[0]
    dev = qc.device
    a_obs = torch.zeros((c, k, k), dtype=solver_dtype, device=dev)
    g = torch.zeros((c, k), dtype=solver_dtype, device=dev)
    cnt = torch.zeros((c,), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    for dp, on, kind, payload in accs:
        st = dp.static
        qn = normalize_coords(qc, st.hclr[iv], st.vclr[iv])
        if kind == "bucketed":
            bp, mb = payload
            a_p, g_p, c_p, o_p = bucketed_platform_terms(
                qn, bp, n_max=st.max_lz_pts, weight_function=weight_function,
                max_blocks=mb)
            ovf += o_p
        elif kind == "dense":
            fused, nvalid, factors = payload
            a_p, g_p, c_p = dense_platform_terms(
                qn, on, fused, nvalid, n_max=st.max_lz_pts,
                weight_function=weight_function, factors=factors)
        else:
            nb = radius_neighbors(qn, on, n_max=st.max_lz_pts, chunk=c)
            a_p, g_p, c_p = accumulate_platform_terms(
                nb, dp.stats, st.assim_mask(iv), weight_function,
                solver_dtype=solver_dtype)
        a_obs += a_p
        g += g_p
        cnt += c_p
    return a_obs, g, cnt, ovf


def _maybe_morton_perm(q, point_order, active, kinds, iv):
    """Hilbert point order, so chunks are compact in localization distance.

    Keys are taken in the metric of the largest bucketed platform, or of the
    raw coordinates under ``point_order="morton"`` without one.  ``None``
    (input order) for ``"linear"``, and for ``"auto"`` without a bucketed
    platform.
    """
    bucketed = [dp for (dp, _), kind in zip(active, kinds)
                if kind == "bucketed"]
    if not (point_order == "morton"
            or (point_order == "auto" and bucketed)):
        return None
    if bucketed:
        st = max(bucketed, key=lambda d: d.xyz.shape[0]).static
        keys = hilbert3(normalize_coords(q, st.hclr[iv], st.vclr[iv]))
    else:
        keys = hilbert3(q)
    return torch.argsort(keys, stable=True)


def _padded_chunks(q, chunk):
    """``[n_chunks, chunk, 3]``: ``q`` padded with copies of its last point,
    which stay inside the last chunk and add no candidate block."""
    b = q.shape[0]
    n_chunks = -(-b // chunk)
    q_p = torch.cat([q, q[-1:].expand(n_chunks * chunk - b, 3)])
    return q_p.view(n_chunks, chunk, 3)


def point_shards(q: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``[n_shards, ceil(B / n_shards), 3]``: the sharded update's split of
    the points, padded with copies of the last point (inside the last
    shard's bounding box, so its Hilbert order keeps its resolution)."""
    b = q.shape[0]
    per = -(-b // n_shards)
    return pad_last(q, n_shards * per - b).view(n_shards, per, 3)


def merge_budgets(plans) -> dict:
    """The worst shard's budget per platform; the block size is the same
    on every shard, since every shard sees all the records."""
    merged: dict = {}
    for one in plans:
        for name, bb in one.items():
            prev = merged.get(name)
            merged[name] = bb if prev is None else BucketBudget(
                bb.block_size, max(prev.max_blocks, bb.max_blocks))
    return merged


def plan_max_blocks(
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    ivar: int,
    *,
    chunk: int = 4096,
    method: str = "auto",
    point_order: str = "auto",
    solver_dtype=torch.float32,
    n_shards: int = 1,
) -> dict:
    """Exact per-platform candidate budgets ``{name: BucketBudget}`` for
    :func:`update_points` with the same points, ``chunk``, ``method`` and
    ``point_order``: planned budgets never overflow.  Only the bucketed
    platforms get one.

    ``n_shards`` plans for the sharded update (``parallel.update``), which
    splits the batch, padded with copies of its last point, into
    ``n_shards`` contiguous shards; each shard Hilbert-orders and chunks its
    own points, so budgets planned on the whole batch's chunking could
    undersize a shard's chunk and drop obs with only the overflow count to
    show for it.  Each shard is planned as the update will run it, and each
    platform takes the worst shard's budget.
    """
    if n_shards > 1:
        return merge_budgets(
            plan_max_blocks(q_s, platforms, ivar, chunk=chunk, method=method,
                            point_order=point_order,
                            solver_dtype=solver_dtype)
            for q_s in point_shards(points_xyz, n_shards))
    _check_method(method)
    q = points_xyz
    b = q.shape[0]
    active = _active(platforms, ivar)
    kinds = [_resolve_kind(method, dp) for dp, _ in active]
    perm = _maybe_morton_perm(q, point_order, active, kinds, ivar)
    if perm is not None:
        q = q[perm]
    accs = _platform_accumulators(
        active, kinds, ivar, None, solver_dtype,
        q_chunks=_padded_chunks(q, min(chunk, max(b, 1))))
    return {dp.static.name: BucketBudget(payload[0].block_size, payload[1])
            for dp, _, kind, payload in accs if kind == "bucketed"}


def _chunked_update(xb, q, platforms, iv, solve: Callable, *,
                    weight_function, solver_dtype, chunk, method, max_blocks,
                    point_order, return_diagnostics):
    """The shared body of :func:`update_points` and
    :func:`update_points_group`: ``solve(a_obs, g, xb_chunk, has_obs)``
    returns ``(xa_chunk, diagnostics)``."""
    b, k = xb.shape[0], xb.shape[-1]
    if q.shape != (b, 3):
        raise ValueError(f"points_xyz must be [{b}, 3] to match xb "
                         f"{tuple(xb.shape)}, got {tuple(q.shape)}")
    _check_method(method)
    ovf = torch.zeros((), dtype=torch.int64, device=xb.device)
    resid = torch.zeros((), dtype=torch.float32, device=xb.device)
    active = _active(platforms, iv)
    if not active:
        # no platform feeds the variable: skipped (letkf_core.f90:63-66)
        xa = xb.clone()
    else:
        kinds = [_resolve_kind(method, dp) for dp, _ in active]
        perm = _maybe_morton_perm(q, point_order, active, kinds, iv)
        if perm is not None:
            q = q[perm]
        chunk = min(chunk, max(b, 1))
        accs = _platform_accumulators(active, kinds, iv, max_blocks,
                                      solver_dtype,
                                      q_chunks=_padded_chunks(q, chunk))
        xa = torch.empty_like(xb)
        for c0 in range(0, b, chunk):
            rows = (perm[c0:c0 + chunk] if perm is not None
                    else slice(c0, c0 + chunk))
            a_obs, g, cnt, o = _accumulate_chunk(
                q[c0:c0 + chunk], accs, iv, weight_function, solver_dtype, k)
            xa[rows], sdiag = solve(a_obs, g, xb[rows], cnt > 0)
            ovf += o
            resid = torch.maximum(resid, sdiag["ns_residual"])
    if return_diagnostics:
        return xa, {"bucket_overflow": ovf, "ns_residual": resid}
    return xa


@torch.inference_mode()
def update_points(
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    ivar: int,
    *,
    inflat: float,
    weight_function: int,
    use_rtpp: bool = False,
    rtpp_alpha: float = 0.85,
    use_rtps: bool = False,
    rtps_alpha: float = 0.85,
    solver_dtype=torch.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks: int | dict | None = None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """LETKF update of analysis variable ``ivar`` at ``B`` points.

    Args:
      xb:         ``[B, k]`` background ensemble values.
      points_xyz: ``[B, 3]`` Lambert x, y (m) and altitude (m).
      ivar:       position of the variable in ``var_update``; indexes every
                  per-variable configuration table.
      inflat:     ``(k-1)/multi_infl(ivar)``.
      chunk:      points per solve batch.
      method:     ``"auto"`` (bucketed from ``BUCKET_MIN_RECORDS`` records,
                  else dense), ``"dense"``, ``"bucketed"`` or ``"gather"``
                  (see ``ACCUMULATE_METHODS``).
      max_blocks: candidate-block budget: :func:`plan_max_blocks`' dict, an
                  int, or None for the exact need of these points.
      point_order: ``"morton"``, ``"linear"`` or ``"auto"`` (Hilbert order
                  iff a platform is bucketed).

    Returns ``xa [B, k]`` in ``xb``'s dtype; points without accepted obs keep
    their background.  With ``return_diagnostics`` also
    ``{"bucket_overflow", "ns_residual"}`` as 0-d tensors.
    """

    def solve(a_obs, g, xbc, has_obs):
        return letkf_solve_from_normal(
            a_obs, g, xbc, inflat, has_obs, use_rtpp=use_rtpp,
            rtpp_alpha=rtpp_alpha, use_rtps=use_rtps, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, return_diagnostics=True)

    return _chunked_update(
        xb, points_xyz, platforms, ivar, solve,
        weight_function=weight_function, solver_dtype=solver_dtype,
        chunk=chunk, method=method, max_blocks=max_blocks,
        point_order=point_order, return_diagnostics=return_diagnostics)


@torch.inference_mode()
def update_points_group(
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    ivars: Sequence[int],
    *,
    inflats: Sequence[float],
    weight_function: int,
    rtpp_alpha: Sequence[float],
    rtps_alpha: Sequence[float],
    solver_dtype=torch.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks: int | dict | None = None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """Fused LETKF update of a group of analysis variables at ``B`` points.

    The variables share their points and their localization signature
    (per-platform radii and assimilation mask; ``ivars[0]`` supplies it), so
    the normal terms, and the factorization, are computed once per chunk and
    only the weight application repeats per variable.

    ``xb`` is ``[B, V, k]``; ``inflats``, ``rtpp_alpha`` and ``rtps_alpha``
    are ``[V]`` (0 disables a relaxation).  ``method`` is one of the four of
    ``ACCUMULATE_METHODS``: ``"auto"``, ``"dense"``, ``"bucketed"`` or
    ``"gather"``.  Otherwise as :func:`update_points`.  Returns
    ``xa [B, V, k]``.
    """
    n_vars = xb.shape[1]
    if not (len(ivars) == len(inflats) == len(rtpp_alpha)
            == len(rtps_alpha) == n_vars):
        raise ValueError("per-variable arg lengths must match xb's V axis")
    inflats = tuple(float(x) for x in inflats)
    rtpp_alpha = tuple(float(x) for x in rtpp_alpha)
    rtps_alpha = tuple(float(x) for x in rtps_alpha)

    def solve(a_obs, g, xbc, has_obs):
        return letkf_solve_group_from_normal(
            a_obs, g, xbc, inflats, has_obs, rtpp_alpha=rtpp_alpha,
            rtps_alpha=rtps_alpha, solver_dtype=solver_dtype,
            return_diagnostics=True)

    return _chunked_update(
        xb, points_xyz, platforms, ivars[0], solve,
        weight_function=weight_function, solver_dtype=solver_dtype,
        chunk=chunk, method=method, max_blocks=max_blocks,
        point_order=point_order, return_diagnostics=return_diagnostics)
