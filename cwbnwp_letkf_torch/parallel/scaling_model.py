"""Analytic multi-card scaling model (a MODEL, not a measurement).

Port of the JAX package's ``parallel/scaling_model.py``, with the same
formula and arguments and H100 assumptions in place of the TPU's.  Only one
card is reachable where the port is measured, so scaling efficiency at N
hosts cannot be measured; what can be computed exactly is what determines
it: each shard's load and each cycle's communication volume.  This module
computes those from a real case and folds them into a predicted
efficiency-per-host-count curve under an explicit cost model.

Per analysis cycle the sharded design (:mod:`.update`, :mod:`.multihost`)
moves exactly:

  1. the obs: every process reads the same obs files from the shared
     filesystem (as the reference's ranks do) and copies them to its card
     over PCIe, ``t_obs ~= obs_bytes / h2d``, once per cycle, overlappable
     with compute;
  2. the member->point transpose of each group's ``[B, V, k]`` input and
     the inverse transpose of its output (the reference's
     letkf_scatter_grid / letkf_gather_grid alltoallv pair,
     module_mpi_util.f90:190-358): an all-to-all moves
     ``bytes * (n - 1) / n``, twice; a single process reading the whole
     ensemble is born point-sharded and skips it;
  3. the diagnostics reduction: a few bytes, ignored.

Compute scales as ``t_compute(1) / n`` degraded by the measured work
imbalance: shards own contiguous point ranges, and their localized-obs work
differs with obs density.  The imbalance is max-shard work / mean-shard
work, per-shard work measured by the exact bucketed-culling prepass
(``ops.bucketed.required_max_blocks``, the quantity the budget planner
pays for).

    t(n) = t_compute(1)/n_cards * imbalance + t_transpose + t_obs_feed
    efficiency(n) = t(1) / (n_cards * t(n))

``t_transpose ~= 2 * state_bytes / (cards * link)``.  The assumptions, each
with its source, are in the output beside every prediction, labelled
``model``: the link rate is that of the all-to-all ACROSS hosts, one
400 Gb/s NDR InfiniBand port per card (50 GB/s; NVIDIA DGX H100 system
documentation, "Hardware Overview": eight single-port ConnectX-7 adapters,
one per GPU); a host holds 8 cards (the NVIDIA HGX H100 8-GPU baseboard,
HGX H100 datasheet).  Inside a host the cards are joined by NVLink, which is faster;
the model charges the InfiniBand rate throughout, which bounds the transpose
time from above.  The host-to-device rate is given by the caller, as the
pinned host-to-device copy rate measured on the card (``chip_smoke.py``
phase 15(d) measures it).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.bucketed import (auto_block_size, hilbert_blocks, pad_last,
                            required_max_blocks)
from ..ops.neighbors import normalize_coords
from ..ops.update import BUCKET_MIN_RECORDS, point_shards

#: the all-to-all rate across hosts, per card (bytes/s): one 400 Gb/s NDR
#: InfiniBand port per card (NVIDIA DGX H100 system documentation)
LINK_BYTES_S = 50e9
#: cards per host: the NVIDIA HGX H100 8-GPU baseboard
CARDS_PER_HOST = 8
#: where each assumption comes from, carried into every prediction
SOURCES = {
    "link_bytes_s": "one 400 Gb/s NDR InfiniBand port per card: NVIDIA DGX "
                    "H100 system documentation, Hardware Overview (8x "
                    "ConnectX-7)",
    "cards_per_host": "NVIDIA HGX H100 8-GPU baseboard (HGX H100 datasheet)",
    "h2d_bytes_s": "pinned host-to-device copy rate measured on the card "
                   "(chip_smoke.py phase 15(d)), as passed by the caller",
}


def obs_bytes(platforms) -> int:
    """The obs payload each card holds: every tensor a platform ships."""
    total = 0
    for dp in platforms:
        for t in (dp.xyz, *dp.stats):
            total += t.numel() * t.element_size()
    return total


def shard_work(points_xyz, platforms, ivar: int, n_shards: int,
               *, chunk: int = 512) -> List[float]:
    """Per-shard localized-obs work proxy, measured (not modelled).

    Work per shard = sum over bucketed-scale platforms of (candidate blocks
    needed per chunk) x (block size) x (chunks in the shard): proportional
    to the accumulation rows each shard processes.  Dense platforms cost
    every shard the same (all records scanned) and are left out.  Only the
    blocks' geometry is built (the blocking of ``bucket_platform``, without
    its table).
    """
    local = point_shards(torch.as_tensor(points_xyz), n_shards)
    work = np.zeros(n_shards)
    for dp in platforms:
        st = dp.static
        if not st.active(ivar) or dp.xyz.shape[0] < BUCKET_MIN_RECORDS:
            continue
        on = normalize_coords(dp.xyz, st.hclr[ivar], st.vclr[ivar])
        block_size = auto_block_size(on)
        hb = hilbert_blocks(on, block_size)
        for si in range(n_shards):
            qs = normalize_coords(local[si].to(on.device), st.hclr[ivar],
                                  st.vclr[ivar])
            n_chunks = -(-qs.shape[0] // chunk)
            qs = pad_last(qs, n_chunks * chunk - qs.shape[0])
            need = required_max_blocks(qs.view(n_chunks, chunk, 3),
                                       hb.centers, hb.radii)
            work[si] += need * block_size * n_chunks
    return work.tolist()


def predict(
    b: int,
    v_total: int,
    k: int,
    t_compute_1: float,
    obs_payload_bytes: int,
    n_hosts: Sequence[int],
    *,
    h2d_bytes_s: float,
    cards_per_host: int = CARDS_PER_HOST,
    imbalance: Dict[int, float] | None = None,
    born_sharded: bool = False,
    link_bytes_s: float = LINK_BYTES_S,
    _sweep: bool = True,
) -> dict:
    """Predicted cycle time and efficiency per host count (labelled model).

    ``t_compute_1``: the measured single-card cycle compute wall (s).
    ``h2d_bytes_s``: the measured pinned host-to-device rate (bytes/s).
    ``imbalance``: max/mean shard work per card count (:func:`shard_work`).
    ``born_sharded``: True when ingest lands point-sharded (one process
    reading the whole ensemble); False for member-block ingest, which pays
    the transpose pair.
    """
    state_bytes = b * v_total * k * 4
    out = {"model": True,
           "assumptions": {
               "link_bytes_s": link_bytes_s, "h2d_bytes_s": h2d_bytes_s,
               "cards_per_host": cards_per_host,
               "topology": "one process per H100; hosts of "
                           f"{cards_per_host} cards joined by NVLink, "
                           "hosts by one NDR InfiniBand port per card, "
                           "charged for the whole all-to-all; obs from "
                           "the shared filesystem per host (no network "
                           "broadcast)",
               "formula": "t(n) = t1/cards * imbalance + 2*state/"
                          "(cards*link) [+ obs/h2d, overlappable]; "
                          "eff = t(1)/(n_cards * t(n))",
               "sources": SOURCES},
           "state_bytes_per_cycle": state_bytes,
           "obs_bytes_per_cycle": obs_payload_bytes,
           "per_host": {}}
    t1 = t_compute_1
    for n in n_hosts:
        cards = n * cards_per_host
        imb = (imbalance or {}).get(cards, 1.0)
        t_c = t1 / cards * imb
        comm = 0.0
        if n > 1 or not born_sharded:
            # member->point transpose in and the inverse out: each card
            # moves ~state/cards bytes each way over its link
            comm += 2 * state_bytes * (cards - 1) / cards / (
                cards * link_bytes_s)
        # the obs feed overlaps run_analysis's pipelined compute: shown apart,
        # not on the critical path
        t_obs = obs_payload_bytes / h2d_bytes_s
        t_n = t_c + comm
        out["per_host"][str(n)] = {
            "cards": cards,
            "t_compute_s": round(t_c, 4),
            "t_transpose_s": round(comm, 4),
            "t_obs_feed_s_overlapped": round(t_obs, 4),
            "t_cycle_s": round(t_n, 4),
            "imbalance": round(imb, 4),
            "efficiency": round(t1 / (cards * t_n), 4),
        }
    if not _sweep:
        return out
    # link-rate sensitivity at the LARGEST host count (where the transpose
    # weighs most against compute), and the least rate at which 85% holds
    n_max = max(n_hosts)
    sweep = {}
    min_bw = None
    for bw_gbs in (5, 10, 15, 20, 30, 45, 60, 90):
        alt = predict(b, v_total, k, t_compute_1, obs_payload_bytes,
                      [n_max], h2d_bytes_s=h2d_bytes_s,
                      cards_per_host=cards_per_host, imbalance=imbalance,
                      born_sharded=born_sharded, link_bytes_s=bw_gbs * 1e9,
                      _sweep=False)
        eff = alt["per_host"][str(n_max)]["efficiency"]
        sweep[str(bw_gbs)] = eff
        if min_bw is None and eff >= 0.85:
            min_bw = bw_gbs
    out["link_sensitivity_at_max_hosts"] = {
        "hosts": n_max, "efficiency_by_link_gbs": sweep,
        "min_link_gbs_for_85pct": min_bw}
    return out


def pinned_h2d_bytes_s(device, nbytes: int = 1 << 28, reps: int = 5) -> float:
    """The pinned host-to-device copy rate of the card ``device``
    (bytes/s): the fastest of ``reps`` copies of ``nbytes``, each timed
    with CUDA events after a warm copy."""
    device = torch.device(device)
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        dst.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(host, non_blocking=True)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return nbytes / best
