"""Fused multi-group LETKF cycle: shared obs geometry across variable groups.

Port of the JAX package's ``ops/cycle.py``, the device path of the production
analysis.  The variable groups of the production namelist differ only in
localization radii and assimilation masks, so one cycle call shares, per
platform:

  * the Hilbert point ordering and chunking, computed in the platform's
    WIDEST client metric;
  * the candidate-block culling and the block gathers: with
    ``r2_g = dh2/hclr_g^2 + dv2/vclr_g^2`` the widest radii give the smallest
    normalized distances, so a block that is a candidate in the wide metric
    is a candidate for every client group;
  * the fused tables, one per distinct assimilation mask.

Only the group-specific work repeats per group: the distance matmul, the cap
threshold, the localization weights and the accumulation (the
``[C, R] @ [R, k*(k+1)]`` product, or on a card where the cap runs the sum
over the selected pairs, K6, from the tables' per-record factors).
Accumulation runs on sub-chunks of points (default 512: a
Hilbert sub-chunk's candidate set is far smaller than a 4096-point chunk's);
the k-by-k solves run per outer chunk (default 4096), where the batched
Newton-Schulz solve is efficient.  The chunk loops are eager Python loops.
The tables, the accumulation and the solve run in ``solver_dtype``; float32
(the default) takes the Newton-Schulz kernel on a card, float64 the float64
eigendecomposition.  ``method`` forces every platform's kind ("dense" or
"bucketed"); "gather" has no fused form (the JAX cycle takes it and fails in
its first chunk) and is refused: the gather path runs through
:func:`.update.update_points` and :func:`.update.update_points_group`.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .. import tracing
from ..constants import GC1999_SQ
from .bucketed import (auto_block_size, default_max_blocks, hilbert3,
                       hilbert_blocks, pad_last, required_max_blocks, sq_norm3)
from .dense import (PairFactors, accepted_counts, centered_r2,
                    fused_platform_table, gather_blocks, pair_factors,
                    selects_pairs, terms_from_r2)
from .neighbors import normalize_coords
from .solver import letkf_solve_cycle_from_normal
from .update import (BUCKET_MIN_RECORDS, BucketBudget, DevicePlatform,
                     dense_factors, dense_table, merge_budgets, point_shards)


class CycleGroup(NamedTuple):
    """One fused variable group inside a cycle call (all share points)."""

    ivars: Tuple[int, ...]
    inflats: Tuple[float, ...]
    rtpp_alpha: Tuple[float, ...]
    rtps_alpha: Tuple[float, ...]


class CycleBlocking(NamedTuple):
    """Wide-metric Hilbert blocking of one platform's records.

    Coordinates stay RAW (meters) so every client group normalizes with its
    own radii; only the culling geometry lives in the wide metric.  The
    tables and their factors are per distinct client assimilation mask, and
    empty on a geometry-only blocking (budget planning needs no tables).

    Shapes (NB = blocks, S = block size, F = k*(k+1), V = observed vars):
      xyz_raw:        [NB*S, 3]  raw coords, Hilbert(wide) order
      fused_by_mask:  tuple of [NB, S, F]
      nvalid_by_mask: tuple of [NB, S]
      factors_by_mask: tuple of PairFactors, [NB*S, V, k+1] and [NB*S, V],
                      one bgo shared
      rec_mask:       [NB, S]   True on real records, False on padding
      centers_w:      [NB, 3]   wide-normalized block centers
      radii_w:        [NB]      wide-normalized covering radii
    """

    xyz_raw: torch.Tensor
    fused_by_mask: Tuple[torch.Tensor, ...]
    nvalid_by_mask: Tuple[torch.Tensor, ...]
    rec_mask: torch.Tensor
    centers_w: torch.Tensor
    radii_w: torch.Tensor
    factors_by_mask: Tuple[PairFactors, ...] = ()

    @property
    def n_blocks(self) -> int:
        return self.rec_mask.shape[0]

    @property
    def block_size(self) -> int:
        return self.rec_mask.shape[1]


#: the accumulation methods of the cycle: "auto" (bucketed from
#: BUCKET_MIN_RECORDS records, else dense) or one kind for every platform
CYCLE_METHODS = ("auto", "dense", "bucketed")

#: the point orders of the cycle (:func:`_cycle_point_perm`)
CYCLE_POINT_ORDERS = ("auto", "morton", "linear")


def _check_cycle_options(method: str, point_order: str) -> None:
    if point_order not in CYCLE_POINT_ORDERS:
        raise ValueError(f"point_order must be one of {CYCLE_POINT_ORDERS}")
    if method == "gather":
        raise ValueError(
            "method='gather' has no fused cycle (a gather platform has no "
            "table to share across groups): use update_points(method="
            "'gather') or update_points_group(method='gather')")
    if method not in CYCLE_METHODS:
        raise ValueError(f"method must be one of {CYCLE_METHODS}")


class PlatformPlan(NamedTuple):
    """One platform's resolved role in a cycle call."""

    dp: DevicePlatform
    kind: str                        # 'dense' | 'bucketed'
    clients: Tuple[int, ...]         # group indices this platform feeds
    wide_h: float                    # widest client hclr (km)
    wide_v: float                    # widest client vclr (km; -1 = 2-D)
    mask_idx: Tuple[int, ...]        # per client: index into masks and
                                     # the per-mask tables
    masks: Tuple[tuple, ...]         # the distinct assimilation masks
    nvalid: Tuple[torch.Tensor, ...]  # per distinct mask: accepted obs
                                      # [R]; dense path only
    factors: Tuple[PairFactors, ...]  # per distinct mask: the fused table's
                                      # factors; dense path only (the table
                                      # itself is built, by dense_table,
                                      # for a call that takes the product)
    centers: Tuple[torch.Tensor, ...]  # per client: [1, 3] group-normalized
                                       # record centroid
    blocking: CycleBlocking | None   # bucketed path only
    budget: int | None               # candidate-block budget (bucketed)


def _wide_metric(st, groups, clients) -> Tuple[float, float]:
    """Widest (hclr, vclr) over the client groups; vclr<=0 wins (2-D)."""
    hs = [st.hclr[groups[g].ivars[0]] for g in clients]
    vs = [st.vclr[groups[g].ivars[0]] for g in clients]
    wide_v = -1.0 if any(v <= 0 for v in vs) else max(vs)
    return max(hs), wide_v


def _cycle_blocking(dp, masks, wide_h, wide_v, block_size, dtype,
                    presorted: bool = False,
                    geometry_only: bool = False) -> CycleBlocking:
    """Hilbert-block the records in the wide metric, raw coords retained.

    The reorder and padding act on the small per-record statistics before
    the table build (:func:`.dense.fused_platform_table`), so the peak memory
    is one table, in ``dtype``.  ``presorted`` takes the records in the
    given order (:func:`.bucketed.hilbert_blocks`): no sort and no
    reordered copy.  ``geometry_only`` skips the tables.
    """
    hb = hilbert_blocks(normalize_coords(dp.xyz, wide_h, wide_v), block_size,
                        presorted=presorted)
    nb, s = hb.rec_mask.shape
    fused_by_mask: Tuple[torch.Tensor, ...] = ()
    nvalid_by_mask: Tuple[torch.Tensor, ...] = ()
    factors_by_mask: Tuple[PairFactors, ...] = ()
    if not geometry_only:
        pairs = [fused_platform_table(dp.stats, m, order=hb.order,
                                      pad_to=nb * s, dtype=dtype)
                 for m in masks]
        fused_by_mask = tuple(f.view(nb, s, -1) for f, _ in pairs)
        nvalid_by_mask = tuple(nv.view(nb, s) for _, nv in pairs)
        factors_by_mask = pair_factors(dp.stats, masks, order=hb.order,
                                       pad_to=nb * s, dtype=dtype)
    xyz = dp.xyz if hb.order is None else dp.xyz[hb.order]
    return CycleBlocking(xyz_raw=pad_last(xyz, hb.pad),
                         fused_by_mask=fused_by_mask,
                         nvalid_by_mask=nvalid_by_mask, rec_mask=hb.rec_mask,
                         centers_w=hb.centers, radii_w=hb.radii,
                         factors_by_mask=factors_by_mask)


@tracing.labelled("cycle.resolve")
def _resolve_plans(
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    max_blocks: Dict[str, BucketBudget] | int | None,
    method: str = "auto",
    dtype=torch.float32,
    obs_presorted: bool = False,
    geometry_only: bool = False,
) -> List[PlatformPlan]:
    """Every active platform's cycle plan, cached on the platform.

    Under ``method="auto"`` a platform with at least ``BUCKET_MIN_RECORDS``
    records takes the bucketed path, a smaller one the dense path; "dense"
    or "bucketed" force the kind.  The budget is the planned
    :class:`.update.BucketBudget` (``max_blocks`` a dict), an int for every
    bucketed platform, or the heuristic.  The fused tables are built in
    ``dtype`` and cached per dtype; ``geometry_only`` (budget planning)
    builds none.
    """
    plans: List[PlatformPlan] = []
    for dp in platforms:
        st = dp.static
        clients = tuple(
            gi for gi, grp in enumerate(groups) if st.active(grp.ivars[0]))
        if not clients or dp.xyz.shape[0] == 0:
            continue
        kind = method
        if method == "auto":
            kind = ("bucketed" if dp.xyz.shape[0] >= BUCKET_MIN_RECORDS
                    else "dense")
        masks: List[tuple] = []     # distinct assimilation masks share tables
        mask_idx = []
        for gi in clients:
            m = st.assim_mask(groups[gi].ivars[0])
            if m not in masks:
                masks.append(m)
            mask_idx.append(masks.index(m))
        cache = dp.cache if dp.cache is not None else {}
        nvalid, factors = (), ()
        if kind == "dense" and not geometry_only:
            nvalid = tuple(accepted_counts(dp.stats, m) for m in masks)
            factors = dense_factors(dp, tuple(masks), dtype)
        wide_h, wide_v = _wide_metric(st, groups, clients)
        centers = []
        for gi in clients:
            iv = groups[gi].ivars[0]
            on = normalize_coords(dp.xyz, st.hclr[iv], st.vclr[iv])
            centers.append(on.mean(0, keepdim=True))
        blocking = None
        budget = None
        if kind == "bucketed":
            mb_req = (max_blocks.get(st.name) if isinstance(max_blocks, dict)
                      else max_blocks)
            planned = mb_req if isinstance(mb_req, BucketBudget) else None
            bs = (planned.block_size if planned is not None else
                  auto_block_size(normalize_coords(dp.xyz, wide_h, wide_v)))
            bkey = ("cycle", tuple(masks), str(dtype), wide_h, wide_v, bs,
                    obs_presorted)
            # a full blocking serves a geometry-only request as well
            blocking = cache.get(bkey + (False,))
            if blocking is None and geometry_only:
                blocking = cache.get(bkey + (True,))
            if blocking is None:
                blocking = _cycle_blocking(dp, masks, wide_h, wide_v, bs,
                                           dtype, presorted=obs_presorted,
                                           geometry_only=geometry_only)
                cache[bkey + (geometry_only,)] = blocking
            if planned is not None:
                budget = min(planned.max_blocks, blocking.n_blocks)
            elif mb_req:
                budget = int(mb_req)
            else:
                budget = default_max_blocks(blocking.n_blocks)
        plans.append(PlatformPlan(
            dp=dp, kind=kind, clients=clients, wide_h=wide_h, wide_v=wide_v,
            mask_idx=tuple(mask_idx), masks=tuple(masks), nvalid=nvalid,
            factors=factors,
            centers=tuple(centers), blocking=blocking, budget=budget))
    return plans


@tracing.labelled("accumulate.distance")
def _group_r2(q_raw, obs_raw, st, ivar, center):
    """Squared normalized distances as the per-group dense path has them.

    Normalizes raw coords with this group's radii, centers on the
    platform-wide group-normalized record centroid, and expands the distance
    through one 3-wide matmul.
    """
    return centered_r2(normalize_coords(q_raw, st.hclr[ivar], st.vclr[ivar]),
                       normalize_coords(obs_raw, st.hclr[ivar], st.vclr[ivar]),
                       center)


def _r2_dtype(q_raw, obs_raw, center):
    """The dtype of :func:`_group_r2`'s distances."""
    return torch.promote_types(torch.promote_types(q_raw.dtype, obs_raw.dtype),
                               center.dtype)


def _bucketed_cycle_terms(q_raw, plan, groups, weight_function):
    """Shared cull and gather, per-client terms, for one subchunk.

    The gather takes the candidates' factors where the calls sum the
    selected pairs (:func:`.dense.selects_pairs`: the same for every client
    of the platform), their fused rows where they take the product.
    Returns ``(per-client list of (a, g, cnt), overflow)``; ``overflow``
    counts candidate blocks that did not fit the budget (their obs are
    dropped, so planned budgets keep it 0).
    """
    cb = plan.blocking
    st = plan.dp.static
    nb, s = cb.n_blocks, cb.block_size
    m = min(plan.budget, nb)

    with tracing.span("accumulate.cull"):
        qw = normalize_coords(q_raw, plan.wide_h, plan.wide_v)
        dmin = torch.sqrt(sq_norm3(qw[:, None, :] - cb.centers_w[None]).amin(0))
        reach = torch.sqrt(torch.tensor(GC1999_SQ, dtype=dmin.dtype,
                                        device=dmin.device)) + cb.radii_w
        cand = dmin <= reach
        score = torch.where(cand, dmin - cb.radii_w, float("inf"))
        idx = torch.topk(-score, m).indices   # best candidates first
        keep = cand[idx]
        overflow = cand.sum() - keep.sum()

        obs_c = cb.xyz_raw.view(nb, s, 3)[idx].reshape(m * s, 3)
        row_mask = (keep[:, None] & cb.rec_mask[idx]).reshape(m * s)
        used = set(plan.mask_idx)
        nvalid_c = {mi: cb.nvalid_by_mask[mi][idx].reshape(m * s)
                    for mi in used}
        select = selects_pairs(
            m * s, st.max_lz_pts,
            _r2_dtype(q_raw, cb.xyz_raw, plan.centers[0]), q_raw.device,
            cb.factors_by_mask[0] if cb.factors_by_mask else None)
        fused_c, factors_c = dict.fromkeys(used), dict.fromkeys(used)
        if select:
            bgo_c = gather_blocks(cb.factors_by_mask[0].bgo, nb, idx)
            for mi in used:
                factors_c[mi] = PairFactors(
                    bgo_c, gather_blocks(cb.factors_by_mask[mi].e, nb, idx))
        else:
            for mi in used:
                fused_c[mi] = cb.fused_by_mask[mi][idx].reshape(m * s, -1)

    outs = []
    for ci, gi in enumerate(plan.clients):
        r2 = _group_r2(q_raw, obs_c, st, groups[gi].ivars[0], plan.centers[ci])
        mi = plan.mask_idx[ci]
        outs.append(terms_from_r2(
            r2, fused_c[mi], nvalid_c[mi], n_max=st.max_lz_pts,
            weight_function=weight_function, row_mask=row_mask,
            factors=factors_c[mi]))
    return outs, overflow


def _dense_cycle_terms(q_raw, plan, groups, weight_function):
    """All-records accumulation per client group (small platforms).  A call
    that takes the dense product (:func:`.dense.selects_pairs` does not
    hold) reads the fused table, built at its first use and kept in the
    platform's cache (:func:`.update.dense_table`); where every call sums
    the selected pairs, as capped calls on a card do, none is built."""
    st = plan.dp.static
    outs = []
    for ci, gi in enumerate(plan.clients):
        r2 = _group_r2(q_raw, plan.dp.xyz, st, groups[gi].ivars[0],
                       plan.centers[ci])
        mi = plan.mask_idx[ci]
        factors = plan.factors[mi]
        fused = None
        if not selects_pairs(r2.shape[1], st.max_lz_pts, r2.dtype, r2.device,
                             factors):
            fused, _ = dense_table(plan.dp, plan.masks[mi], factors.e.dtype)
        outs.append(terms_from_r2(r2, fused, plan.nvalid[mi],
                                  n_max=st.max_lz_pts,
                                  weight_function=weight_function,
                                  factors=factors))
    return outs


def _subchunk(b: int, chunk: int, subchunk: int) -> Tuple[int, int]:
    """``(chunk, sub)``: the outer chunk is a whole number of subchunks."""
    chunk = min(chunk, max(b, 1))
    sub = min(subchunk, chunk)
    return -(-chunk // sub) * sub, sub


@tracing.spanned("cycle.plan")
@torch.inference_mode()
def plan_cycle_budgets(
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    point_order: str = "auto",
    solver_dtype=torch.float32,
    n_shards: int = 1,
    obs_presorted: bool = False,
) -> Dict[str, BucketBudget]:
    """Exact per-platform candidate budgets for the cycle's subchunks.

    Culls in each bucketed platform's wide client metric at the subchunking
    :func:`update_points_cycle` will use with the same ``chunk``,
    ``subchunk``, ``method``, ``point_order`` and ``obs_presorted``, and
    rounds each budget up to a multiple of 16, so planned budgets never
    overflow.  ``solver_dtype`` is the one the update will take: a full
    blocking of that dtype, if cached, serves the planning.  Builds no
    table.  ``n_shards`` plans each shard of the sharded cycle
    (``parallel.update.sharded_update_points_cycle``) on its own points and
    takes the worst shard, as :func:`.update.plan_max_blocks` does.
    """
    if n_shards > 1:
        return merge_budgets(
            plan_cycle_budgets(q_s, platforms, groups, chunk=chunk,
                               subchunk=subchunk, method=method,
                               point_order=point_order,
                               solver_dtype=solver_dtype,
                               obs_presorted=obs_presorted)
            for q_s in point_shards(points_xyz, n_shards))
    _check_cycle_options(method, point_order)
    q = points_xyz
    b = q.shape[0]
    plans = _resolve_plans(platforms, groups, max_blocks=None, method=method,
                           dtype=solver_dtype, obs_presorted=obs_presorted,
                           geometry_only=True)
    perm = _cycle_point_perm(q, plans, point_order)
    if perm is not None:
        q = q[perm]
    _, sub = _subchunk(b, chunk, subchunk)
    n_sub = -(-b // sub)
    # padding repeats the last point, which adds no candidate block
    q_p = torch.cat([q, q[-1:].expand(n_sub * sub - b, 3)])
    out: Dict[str, BucketBudget] = {}
    for plan in plans:
        if plan.kind != "bucketed":
            continue
        cb = plan.blocking
        qn = normalize_coords(q_p, plan.wide_h, plan.wide_v)
        needed = required_max_blocks(qn.view(n_sub, sub, 3), cb.centers_w,
                                     cb.radii_w)
        mb = min(cb.n_blocks, max(16, -(-needed // 16) * 16))
        out[plan.dp.static.name] = BucketBudget(cb.block_size, mb)
    return out


def _cycle_point_perm(q, plans, point_order="auto"):
    """Hilbert point order in the largest bucketed platform's wide metric,
    or of the raw coordinates under ``point_order="morton"`` without one.

    ``None`` (input order) for ``"linear"``, and for ``"auto"`` when no
    platform is bucketed.
    """
    bucketed = [p for p in plans if p.kind == "bucketed"]
    if not (point_order == "morton"
            or (point_order == "auto" and bucketed)):
        return None
    if bucketed:
        p = max(bucketed, key=lambda p: p.dp.xyz.shape[0])
        keys = hilbert3(normalize_coords(q, p.wide_h, p.wide_v))
    else:
        keys = hilbert3(q)
    return torch.argsort(keys, stable=True)


@tracing.spanned("cycle.accumulate_chunk")
def accumulate_chunk(q_chunk, plans, groups, *, k: int, weight_function: int,
                     subchunk: int, dtype=torch.float32):
    """Every group's normal terms for one outer chunk of points.

    ``q_chunk`` ``[C, 3]`` raw points, accumulated ``subchunk`` points at a
    time against every platform plan (whose tables are in ``dtype``).
    Returns ``(a [G, C, k, k], g [G, C, k], count [G, C] int32, overflow)``
    with ``a`` and ``g`` in ``dtype`` and ``overflow`` a 0-d int64 count of
    dropped candidate blocks.
    """
    c = q_chunk.shape[0]
    n_groups = len(groups)
    dev = q_chunk.device
    a = torch.zeros((n_groups, c, k, k), dtype=dtype, device=dev)
    g = torch.zeros((n_groups, c, k), dtype=dtype, device=dev)
    cnt = torch.zeros((n_groups, c), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, c, subchunk):
        s1 = min(c, s0 + subchunk)
        qs = q_chunk[s0:s1]
        for plan in plans:
            if plan.kind == "bucketed":
                outs, o = _bucketed_cycle_terms(qs, plan, groups,
                                                weight_function)
                ovf += o
            else:
                outs = _dense_cycle_terms(qs, plan, groups, weight_function)
            # a label, not a span: these sums, like the fills above, are
            # the chunk span's own kernels and close its range on the device
            with tracing.label("accumulate.sum"):
                for ci, gi in enumerate(plan.clients):
                    a_p, g_p, c_p = outs[ci]
                    a[gi, s0:s1] += a_p
                    g[gi, s0:s1] += g_p
                    cnt[gi, s0:s1] += c_p
    return a, g, cnt, ovf


@tracing.spanned("cycle.update")
@torch.inference_mode()
def update_points_cycle(
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    weight_function: int,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    max_blocks: Dict[str, BucketBudget] | int | None = None,
    point_order: str = "auto",
    obs_presorted: bool = False,
    solver_dtype=torch.float32,
    return_diagnostics: bool = False,
):
    """Fused LETKF update of several variable groups at shared points.

    Args:
      xb:     ``[B, V_total, k]`` background; the V axis concatenates the
              groups' variables in ``groups`` order.
      points_xyz: ``[B, 3]`` shared analysis points (meters).
      groups: per-group ivars/inflats/relaxations; ``ivars[0]`` gives the
              group's localization radii and assimilation mask.
      method: ``"auto"``, ``"dense"`` or ``"bucketed"`` (``CYCLE_METHODS``);
              ``"gather"`` raises ``ValueError``.
      max_blocks: per-platform budgets from :func:`plan_cycle_budgets`, an
              int for every bucketed platform, or None (the heuristic;
              watch the overflow diagnostic).
      point_order: ``"auto"`` (Hilbert order iff a platform is bucketed),
              ``"morton"`` (always) or ``"linear"`` (the input order).
      obs_presorted: the records are already in Hilbert order of the
              blocking's wide metric (one client group: its own radii);
              the blocking takes them as given, without a sorted copy.
      chunk / subchunk: solve batch size / accumulation cull granularity.
      solver_dtype: dtype of the tables, the accumulation and the solve.

    Returns ``xa [B, V_total, k]`` in ``xb``'s dtype, and with
    ``return_diagnostics`` also ``{"bucket_overflow", "ns_residual"}`` as
    0-d tensors.  Points without accepted obs keep their background exactly.
    """
    q = points_xyz
    b, v_tot, k = xb.shape
    _check_cycle_options(method, point_order)
    if q.shape != (b, 3):
        raise ValueError(f"points_xyz must be [{b}, 3], got {tuple(q.shape)}")
    sizes = [len(grp.ivars) for grp in groups]
    if sum(sizes) != v_tot:
        raise ValueError(f"xb V axis {v_tot} != sum of group sizes {sizes}")
    col0 = [0]
    for s_ in sizes:
        col0.append(col0[-1] + s_)

    plans = _resolve_plans(platforms, groups, max_blocks=max_blocks,
                           method=method, dtype=solver_dtype,
                           obs_presorted=obs_presorted)
    perm = _cycle_point_perm(q, plans, point_order)
    chunk, sub = _subchunk(b, chunk, subchunk)
    xa = torch.empty((b, v_tot, k), dtype=xb.dtype, device=xb.device)
    ovf = torch.zeros((), dtype=torch.int64, device=xb.device)
    resid = torch.zeros((), dtype=torch.float32, device=xb.device)
    for c0 in range(0, b, chunk):
        rows = (perm[c0:c0 + chunk] if perm is not None
                else slice(c0, c0 + chunk))
        xbc = xb[rows]
        a, g, cnt, o = accumulate_chunk(q[rows], plans, groups, k=k,
                                        weight_function=weight_function,
                                        subchunk=sub, dtype=solver_dtype)
        # every group's solve, the NS calls stacked by inflation value
        xa_cols, sdiag = letkf_solve_cycle_from_normal(
            list(a), list(g),
            [xbc[:, col0[gi]:col0[gi + 1]] for gi in range(len(groups))],
            [grp.inflats for grp in groups], list(cnt > 0),
            rtpp_alpha_groups=[grp.rtpp_alpha for grp in groups],
            rtps_alpha_groups=[grp.rtps_alpha for grp in groups],
            solver_dtype=solver_dtype, return_diagnostics=True)
        xa[rows] = torch.cat(xa_cols, 1)
        ovf += o
        resid = torch.maximum(resid, sdiag["ns_residual"])
    if return_diagnostics:
        return xa, {"bucket_overflow": ovf, "ns_residual": resid}
    return xa
