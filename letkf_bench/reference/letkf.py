"""The plain LETKF analysis at chosen points, in float64 (Hunt et al. 2007).

Written from the method and the namelist's meaning, not from the program:
for every analysis point and variable it finds the records in the
localization ellipsoid by brute force, keeps the ``max_lz_pts`` nearest,
weights each observation by ``exp(-r2/2) / err^2`` (Gaussian,
``weight_function = 0``) or the Gaspari-Cohn function (``1``), solves the
k-by-k problem by an eigendecomposition and applies multiplicative
inflation, RTPP, RTPS and, for the moisture fields, the positivity fix.

Where float32 cannot tell which records a point keeps, the answer is not
unique.  A record whose squared normalized distance lies within the float32
resolution of the radius or of the cap's cut, or whose outlier test lies
within float32 of its threshold, is a *band* record: the reference computes
the analysis with and without it (every subset the cap allows, at most
``MAX_BAND`` band records a point) and :func:`compare_points` takes the
variant nearest to the program's answer.  Outside the band everything is
decided in float64.
"""
from __future__ import annotations

import itertools
import math
from typing import List, NamedTuple, Sequence

import torch

#: squared support of the localization, (2 sqrt(10/3))^2: records beyond it
#: carry no weight (module_localization.f90:202)
GC1999_SQ = 40.0 / 3.0
#: the program states that it keeps the nearest ``max_lz_pts`` records up to
#: a threshold found to ``GC1999_SQ * 16**-6`` (ops/dense.py), so records
#: tied within that resolution of the cut may be left out
CAP_RESOLUTION = GC1999_SQ * 16.0 ** -6
#: float32 rounding of a squared distance built from coordinates of size
#: |q|, |o|: a few units of 2**-24 of |q|^2 + |o|^2
F32_R2_ULPS = 8 * 2.0 ** -24
#: outlier tests within this relative distance of the threshold are
#: undecided in float32
F32_REJECT_RTOL = 1e-5
#: band records considered per point and variable (2**6 variants at most)
MAX_BAND = 6
#: float32 spacings of a point's own largest value that a float32 analysis
#: cannot avoid: it forms the mean, the increment, RTPP and RTPS at the
#: field's magnitude, each rounded there (the program's gaps on fields far
#: from zero read 2-3 spacings on every seed)
F32_FIELD_SPACINGS = 4.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 bits of mantissa (to nearest,
    ties to even), as a tensor core takes the operands of a product."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


class Platform(NamedTuple):
    """One platform's records and statistics, float64 on one device."""

    name: str
    xyz: torch.Tensor        # [R, 3] meters
    bg: torch.Tensor         # [V, R, k] H(xb) perturbations
    omm: torch.Tensor        # [V, R] obs minus the members' mean
    einv2: torch.Tensor      # [V, R] 1 / err^2
    valid: torch.Tensor      # [V, R] QC and outlier test passed
    unsure: torch.Tensor     # [V, R] outlier test undecided in float32
    max_lz_pts: int
    hclr: Sequence[float]    # km, per analysis variable; <= 0: not used
    vclr: Sequence[float]    # km; <= 0: horizontal localization only
    assim: Sequence[Sequence[bool]]  # [V][analysis variable]


def platform(name, xyz, obs, error, qc, hdxb, *, err_muti, err_rej,
             max_lz_pts, hclr, vclr, assim, is_dbz=False, norain_value=-5.0,
             device="cpu") -> Platform:
    """Statistics and QC of one platform's raw records (letkf_core.f90:
    420-510): the members' mean and perturbations of H(xb), the innovation,
    the error times its multiplier, any member's QC flag >= 0, and the
    outlier test ``|omm| > sqrt(spread^2 + err^2) * err_rej``; for
    reflectivity no test where the obs is the no-rain value, and no obs where
    the members' mean is too."""
    f64 = dict(dtype=torch.float64, device=device)
    hdxb = torch.as_tensor(hdxb).to(**f64)
    obs = torch.as_tensor(obs).to(**f64)
    k = hdxb.shape[-1]
    mean = hdxb.mean(-1)
    bg = hdxb - mean[..., None]
    omm = obs - mean
    spread2 = (bg * bg).sum(-1) / (k - 1)
    err = (torch.as_tensor(error).to(**f64)
           * torch.tensor(err_muti, **f64)[:, None])
    thr = torch.sqrt(spread2 + err * err) * torch.tensor(err_rej, **f64)[:, None]
    qc_ok = (torch.as_tensor(qc).to(device) >= 0).any(-1)
    outlier = omm.abs() > thr
    unsure = (omm.abs() - thr).abs() <= F32_REJECT_RTOL * thr
    if is_dbz:
        norain = obs == norain_value
        rejected = (outlier & ~norain) | (norain & (mean == norain_value))
        unsure &= ~norain
    else:
        rejected = outlier
    return Platform(name=name, xyz=torch.as_tensor(xyz).to(**f64), bg=bg,
                    omm=omm, einv2=1.0 / (err * err), valid=qc_ok & ~rejected,
                    unsure=unsure & qc_ok, max_lz_pts=int(max_lz_pts),
                    hclr=tuple(hclr), vclr=tuple(vclr),
                    assim=tuple(tuple(a) for a in assim))


def _weight(r2, weight_function):
    if weight_function == 1:    # Gaspari and Cohn 1999, eq. 4.10
        z = torch.sqrt(r2) / math.sqrt(10.0 / 3.0)
        inner = 1.0 + z * z * (-5.0 / 3.0 + z * (0.625 + z * (0.5 - 0.25 * z)))
        zs = z.clamp_min(1e-30)
        outer = (4.0 - 5.0 * z + z * z * (5.0 / 3.0 + z * (0.625 + z * (
            -0.5 + z / 12.0))) - (2.0 / 3.0) / zs)
        return torch.where(z <= 1.0, inner,
                           torch.where(z <= 2.0, outer, 0.0)).clamp_min(0.0)
    return torch.exp(-0.5 * r2)


def _normalize(xyz, h_km, v_km):
    scale = torch.tensor([1.0 / (h_km * 1e3), 1.0 / (h_km * 1e3),
                          1.0 / (v_km * 1e3) if v_km > 0 else 0.0],
                         dtype=xyz.dtype, device=xyz.device)
    return xyz * scale


class _Selection(NamedTuple):
    sure: torch.Tensor       # [P, R] kept whatever the rounding
    band: torch.Tensor       # [P, R] kept or not, as the rounding falls
    exact: torch.Tensor      # [P, R] kept in float64
    slack: torch.Tensor      # [P] band records the cap still allows
    r2: torch.Tensor         # [P, R]
    cut: torch.Tensor        # [P, 1] the radius, or the next record out


def _select(q, plat: Platform, ivar: int) -> _Selection:
    """Which records each point keeps: inside the radius, and where more than
    ``max_lz_pts`` are, those nearer than the next one out."""
    qn = _normalize(q, plat.hclr[ivar], plat.vclr[ivar])
    on = _normalize(plat.xyz, plat.hclr[ivar], plat.vclr[ivar])
    r2 = sum((qn[:, c, None] - on[None, :, c]) ** 2 for c in range(3))
    eps = F32_R2_ULPS * ((qn * qn).sum(-1, keepdim=True)
                         + (on * on).sum(-1).amax()) + 1e-12      # [P, 1]
    inside = r2 <= GC1999_SQ
    n = plat.max_lz_pts
    capped = inside.sum(1) > n
    if n < r2.shape[1]:
        nxt = torch.kthvalue(torch.where(inside, r2, math.inf), n + 1,
                             dim=1).values                     # [P]
    else:
        nxt = torch.full_like(r2[:, 0], math.inf)
    cut = torch.where(capped, nxt, GC1999_SQ)[:, None]
    exact = torch.where(capped[:, None], r2 < cut, inside)
    lo = torch.where(capped[:, None], cut - CAP_RESOLUTION - eps, cut - eps)
    band = (r2 >= lo) & (r2 <= cut + eps)
    sure = r2 < lo
    return _Selection(sure=sure, band=band, exact=exact,
                      slack=n - sure.sum(1), r2=r2, cut=cut)


class LocalTerms(NamedTuple):
    """Normal terms of a batch of points for every allowed choice of band
    records: variant ``j`` of point ``p`` is ``a[p, j]``, ``g[p, j]``,
    ``count[p, j]``; ``feasible[p, j]`` says whether the cap allows it and
    ``primary[p]`` which variant float64 decides."""

    a: torch.Tensor          # [P, J, k, k]
    g: torch.Tensor          # [P, J, k]
    count: torch.Tensor      # [P, J]
    feasible: torch.Tensor   # [P, J]
    primary: torch.Tensor    # [P] int64


def _record_terms(plat, ivar, rec, r2, weight_function, take, low=False):
    """``(a [N, k, k], g [N, k], count [N])`` of records ``rec`` ``[N]`` at
    squared distances ``r2`` ``[N]``, over the observed variables where
    ``take`` ``[V, N]`` holds; ``low``: the products in TF32."""
    e = torch.where(take, plat.einv2[:, rec], 0.0) * _weight(r2, weight_function)
    yb = torch.sqrt(e)[..., None] * plat.bg[:, rec]            # [V, N, k]
    yo = torch.sqrt(e) * plat.omm[:, rec]                      # [V, N]
    if low:
        yb, yo = tf32(yb), tf32(yo)
    return (torch.einsum("vnk,vnl->nkl", yb, yb).double(),
            torch.einsum("vnk,vn->nk", yb, yo).double(),
            take.sum(0).to(torch.float64))


def local_terms(q: torch.Tensor, platforms: Sequence[Platform], ivar: int,
                weight_function: int, low: bool = False) -> LocalTerms:
    """The normal terms ``sum w E bg bg^T``, ``sum w E omm bg`` and the
    count of observations taken, at points ``q`` ``[P, 3]`` (float64,
    meters) for analysis variable ``ivar``, with every variant of the band
    records (module docstring).  ``low``: the control's products, in TF32
    and summed in float32."""
    p_n = q.shape[0]
    k = platforms[0].bg.shape[-1]
    dev, f64 = q.device, torch.float64
    a = torch.zeros((p_n, k, k), dtype=f64, device=dev)
    g = torch.zeros((p_n, k), dtype=f64, device=dev)
    cnt = torch.zeros(p_n, dtype=f64, device=dev)
    # per point, its band entries: (platform, counts against the cap,
    # float64 takes it, distance to the cut, (a, g, count))
    bands: List[list] = [[] for _ in range(p_n)]
    slacks = [None] * len(platforms)
    for pi, plat in enumerate(platforms):
        mask = torch.tensor([m[ivar] for m in plat.assim], device=dev)
        if plat.hclr[ivar] <= 0 or not bool(mask.any()):
            continue
        sel = _select(q, plat, ivar)
        slacks[pi] = sel.slack.tolist()
        width = int(sel.sure.sum(1).max()) if p_n else 0
        if width:
            idx = torch.argsort((~sel.sure).to(torch.int8), dim=1,
                                stable=True)[:, :width]           # [P, W]
            on = torch.gather(sel.sure, 1, idx)
            r2 = torch.gather(sel.r2, 1, idx)
            ok = plat.valid[:, idx] & mask[:, None, None] & on[None]
            unsure = plat.unsure[:, idx] & mask[:, None, None] & on[None]
            e = torch.where(ok & ~unsure, plat.einv2[:, idx], 0.0) * \
                _weight(r2, weight_function)                      # [V, P, W]
            yb = torch.sqrt(e)[..., None] * plat.bg[:, idx]       # [V, P, W, k]
            yb = yb.permute(1, 0, 2, 3).reshape(p_n, -1, k)
            yo = (torch.sqrt(e) * plat.omm[:, idx]).permute(1, 0, 2)
            yo = yo.reshape(p_n, -1, 1)
            if low:
                yb, yo = tf32(yb), tf32(yo)
            a += (yb.transpose(1, 2) @ yb).double()
            g += (yb.transpose(1, 2) @ yo)[..., 0].double()
            cnt += (ok & ~unsure).sum((0, 2)).to(f64)
            # an undecided outlier test: its observations taken or not
            for p, j in torch.nonzero(unsure.any(0)).tolist():
                ta, tg, tc = _record_terms(plat, ivar, idx[p, j:j + 1],
                                           r2[p, j:j + 1], weight_function,
                                           unsure[:, p, j:j + 1], low)
                bands[p].append((pi, False, bool(ok[:, p, j].any()), 0.0,
                                 (ta[0], tg[0], tc[0])))
        bp, br = torch.nonzero(sel.band, as_tuple=True)
        if bp.numel():
            ta, tg, tc = _record_terms(plat, ivar, br, sel.r2[bp, br],
                                       weight_function,
                                       plat.valid[:, br] & mask[:, None], low)
            for j, (p, ex, gap) in enumerate(zip(
                    bp.tolist(), sel.exact[bp, br].tolist(),
                    (sel.r2[bp, br] - sel.cut[bp, 0]).abs().tolist())):
                bands[p].append((pi, True, ex, gap, (ta[j], tg[j], tc[j])))
    n_var = 1 << min(MAX_BAND, max((len(b) for b in bands), default=0))
    av = a[:, None].repeat(1, n_var, 1, 1)
    gv = g[:, None].repeat(1, n_var, 1)
    cv = cnt[:, None].repeat(1, n_var)
    feasible = [[False] * n_var for _ in range(p_n)]
    primary = [0] * p_n
    for p in range(p_n):
        band = sorted(bands[p], key=lambda b: b[3])
        for b in band[MAX_BAND:]:    # the surplus, farthest from the cut,
            if b[2]:                 # is decided in float64
                av[p] += b[4][0]
                gv[p] += b[4][1]
                cv[p] += b[4][2]
        band = band[:MAX_BAND]
        for j, bits in enumerate(itertools.product((0, 1), repeat=len(band))):
            used = [0] * len(platforms)
            for b, on in zip(band, bits):
                if on:
                    av[p, j] += b[4][0]
                    gv[p, j] += b[4][1]
                    cv[p, j] += b[4][2]
                    used[b[0]] += int(b[1])
            feasible[p][j] = all(s is None or used[i] <= s[p]
                                 for i, s in enumerate(slacks))
            if all(on == int(b[2]) for b, on in zip(band, bits)):
                primary[p] = j
    return LocalTerms(a=av, g=gv, count=cv,
                      feasible=torch.tensor(feasible, device=dev),
                      primary=torch.tensor(primary, device=dev))


def tune_q(q: torch.Tensor) -> torch.Tensor:
    """Moisture positivity fix (letkf_core.f90:252-278): negative members go
    to zero and the positive ones are scaled so that the members' sum is
    kept; no positive member leaves zero."""
    pos = q > 0
    total = q.sum(-1, keepdim=True)
    positive = torch.where(pos, q, 0.0).sum(-1, keepdim=True)
    ratio = torch.where(positive > 0, total / torch.where(positive > 0,
                                                          positive, 1.0), 0.0)
    return torch.where(pos, ratio * q, 0.0)


#: where the members' sum is negative and the positive members' sum under
#: this share of its size, the positivity fix scales by more than
#: ``1 / TUNE_Q_RTOL`` and float32 cannot decide its answer
TUNE_Q_RTOL = 0.1


def eigen(terms: LocalTerms, low: bool = False):
    """``(lam [P, J, k], v [P, J, k, k])`` of every variant's ``a`` on the
    CPU, float64 (float32 for the control); the variables that share the
    terms share it."""
    return torch.linalg.eigh(terms.a.cpu().to(
        torch.float32 if low else torch.float64))


def analysis(terms: LocalTerms, xb: torch.Tensor, *, multi_infl: float,
             rtpp_alpha: float, rtps_alpha: float, moisture: bool,
             eig=None, low: bool = False):
    """Every variant's analysis ``[P, J, k]`` of one variable whose
    background at the points is ``xb`` ``[P, k]`` (Hunt et al. 2007, eqs.
    20-24), on the CPU: with ``A = a + (k - 1) / multi_infl I =
    V diag(lam) V^T``, ``xa = mean + X' (A^-1 g) + sqrt(k - 1) X' A^(-1/2)``,
    then RTPP and RTPS (letkf_core.f90:684-698); points without an
    observation keep the background; then, for moisture, :func:`tune_q` at
    every point (letkf_core.f90:252-278).  Also returns ``undecided``
    ``[P, J]``: where the fix's answer is not decided in float32
    (``TUNE_Q_RTOL``).  ``low``: the control, in float32 with its products'
    operands in TF32."""
    dt = torch.float32 if low else torch.float64
    op = tf32 if low else (lambda x: x)
    k = xb.shape[-1]
    xb = xb.cpu().to(dt)[:, None, :]                           # [P, 1, k]
    mean = xb.mean(-1, keepdim=True)
    xp = xb - mean
    lam, v = eig if eig is not None else eigen(terms, low)
    lam = lam + (k - 1) / multi_infl
    g = terms.g.cpu().to(dt)
    w_mean = torch.einsum("pjab,pjb->pja", op(v), op(
        torch.einsum("pjba,pjb->pja", op(v), op(g)) / lam))
    w_pert = op(v / torch.sqrt(lam)[..., None, :]) @ op(v.transpose(-1, -2))
    xa = (mean + (op(xp) * op(w_mean)).sum(-1, keepdim=True)
          + math.sqrt(k - 1) * torch.einsum("pjab,pib->pja", op(w_pert),
                                            op(xp)))
    xa_mean = xa.mean(-1, keepdim=True)
    xa_p = (1.0 - rtpp_alpha) * (xa - xa_mean) + rtpp_alpha * xp
    sb = torch.sqrt((xp * xp).sum(-1, keepdim=True))
    sa = torch.sqrt((xa_p * xa_p).sum(-1, keepdim=True))
    factor = rtps_alpha * sb / sa.clamp_min(torch.finfo(dt).tiny) \
        - rtps_alpha + 1.0
    xa = torch.where(terms.count.cpu()[..., None] > 0, xa_mean + xa_p * factor,
                     xb)
    undecided = torch.zeros(xa.shape[:2], dtype=torch.bool)
    if moisture:
        total = xa.sum(-1)
        positive = torch.where(xa > 0, xa, 0.0).sum(-1)
        undecided = (total < 0) & (positive < TUNE_Q_RTOL * total.abs())
        xa = tune_q(xa)
    return xa, undecided


def control(terms: LocalTerms, xb, **spec) -> torch.Tensor:
    """The control's answers ``[P, k]``: the reference in the program's
    place in TF32 (``terms`` made with ``low=True``), its variant that
    float64 would take."""
    xa, _ = analysis(terms, xb, low=True, **spec)
    return xa[torch.arange(xa.shape[0]), terms.primary.cpu()]


class Compared(NamedTuple):
    """One variable's comparison at a sample of points."""

    gaps: List[float]  # per answer: largest gap past the float32 floor
    increment: float   # largest |reference - background|
    n_points: int
    n_undecided: int   # points the positivity fix leaves undecided


def compare_points(terms: LocalTerms, xb, xa_program, eig=None,
                   **spec) -> Compared:
    """The program's analyses ``xa_program`` ``[S, P, k]`` (``S`` answers at
    the same points ``P``, such as one a step) against the reference: a
    point's gap is its largest ``|program - reference|`` over the members,
    to the feasible variant nearest the program's answer, less
    ``F32_FIELD_SPACINGS`` float32 spacings of the point's largest value;
    the increment is the float64 variant's.  Points whose float64 answer
    the positivity fix leaves undecided are counted, not compared."""
    ref, undecided = analysis(terms, xb, eig=eig, **spec)      # [P, J, k]
    rows = torch.arange(ref.shape[0])
    primary = terms.primary.cpu()
    skip = undecided[rows, primary]
    pick = ref[rows, primary]
    top = pick.abs().amax(-1).to(torch.float32)
    floor = F32_FIELD_SPACINGS * (torch.nextafter(top, top + 1) - top).double()
    prog = torch.as_tensor(xa_program).cpu().to(torch.float64)
    d = (prog[:, :, None, :] - ref[None]).abs().amax(-1)        # [S, P, J]
    d = torch.where(terms.feasible.cpu()[None], d, math.inf).amin(-1)
    d = torch.where(torch.isfinite(prog).all(-1), d, math.inf)  # [S, P]
    d = torch.where(skip[None], 0.0, (d - floor[None]).clamp_min(0.0))
    gaps = d.amax(-1).tolist() if d.shape[1] else [0.0] * d.shape[0]
    xb64 = xb.cpu().to(torch.float64)[~skip]
    increment = (float((pick[~skip] - xb64).abs().amax())
                 if xb64.numel() else 0.0)
    return Compared(gaps=gaps, increment=increment,
                    n_points=int(xb.shape[0]), n_undecided=int(skip.sum()))


def merge(parts: Sequence[Compared]) -> Compared:
    """One comparison of the union of several batches of points."""
    return Compared(gaps=[max(g) for g in zip(*(p.gaps for p in parts))],
                    increment=max(p.increment for p in parts),
                    n_points=sum(p.n_points for p in parts),
                    n_undecided=sum(p.n_undecided for p in parts))


def xa_gap(compared: Sequence[Compared]) -> List[float]:
    """The number a cell is held to, for each answer: over the variables,
    the largest gap past the float32 floor in units of the variable's
    increment."""
    out = []
    for s in range(len(compared[0].gaps)):
        worst = 0.0
        for c in compared:
            gap = c.gaps[s]
            worst = max(worst, gap / c.increment if c.increment else
                        (0.0 if gap == 0 else math.inf))
        out.append(worst)
    return out


def report(names: Sequence[str], compared: Sequence[Compared]) -> None:
    """One line: each variable's worst gap over its increment, its
    increment, and the points left undecided."""
    print("xa_gap by variable: " + "; ".join(
        f"{n} {max(c.gaps) / (c.increment or 1.0):.3e} "
        f"(increment {c.increment:.4g}, undecided {c.n_undecided}/"
        f"{c.n_points})" for n, c in zip(names, compared)), flush=True)
