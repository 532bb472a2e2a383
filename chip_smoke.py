#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's main paths, on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, in order; any failure raises and the exit code is not 0:

0. the card: name and power limit, torch and CUDA versions;
1. build both kernel libraries from ``cwbnwp_letkf_torch/csrc``, one
   ``nvcc`` per source, started together; print the compiler's report and
   what a Newton-Schulz launch uses at k=40 and k=96 and a Jacobi launch at
   the shapes of phases 6 and 17 (threads, shared memory, registers,
   resident blocks, and for the Jacobi kernels resident matrices, per SM);
   K3 above k = 96: V in registers at every even k of 98-176 and no spill
   or stack frame in any of its instances, its launch at phase 17's shapes;
   K4 above k = 96: V from the rotation log at every odd k of 97-177, no
   spill or stack frame in the chain's instances, the V pass or the chain
   floor, and the chain's and the V pass's launch at phase 17's shapes;
   the cap search (K5) at phase 18's record counts; the selected-pair
   accumulation (K6) at k = 40, 96 and 128;
2. K1, the Newton-Schulz kernel, against its plain PyTorch version at the
   main path's stacked shape ``[12288, 40, 40]`` and at ``[2048, 96, 96]``,
   on seeded normal matrices and on ill-conditioned dense-obs ones, with
   both times and the bound from the kernel's own mean step count;
3. the slice: the fused production-grouped cycle (prepare_platform ->
   plan_cycle_budgets -> update_points_cycle -> tune_q) on the bench case,
   327,680 points x 16 variables at k=40, checked for finite values, zero
   overflow, a converged solve, kernel launches and a lower analysis RMSE
   (the cap search's and the selected-pair accumulation's launches
   counted, their first inputs kept for phases 18 and 19);
   then a second, warm run, timed;
4. K1 against the plain version on the real normal matrices of the cycle's
   first chunk, with its mean steps, time per launch and bound there (the
   main path's own); then the first chunk's analysis through the Jacobi solve,
   K1, and lower-precision controls (fewer sweeps, no polish), each against
   float64 eigh in units of the analysis increment: what the limit of
   phases 7 and 8 can see;
5. K2, the ``rmul`` packing of the same kernel: its entry point
   ``ns_kernel.ns_invsqrt_cuda(packing="rmul")`` (the reach the TPU package
   gives it) driven on phase 4's real matrices, then K2 against its plain
   version and against K1 on phase 2's sets, with both times;
6. K3 and K4, the Jacobi eigensolvers, against their plain versions at
   ``[4096, 40, 40]`` and ``[2048, 96, 96]`` (K3), ``[4096, 41, 41]`` and
   ``[512, 9, 9]`` (K4): eigenvalues element by element, reconstruction,
   orthogonality and float64 eigenvalues, with both times, the bound of
   seven sweeps and the time of float32 ``torch.linalg.eigh`` on the same
   inputs (a yardstick the port never calls); and K3 on phase 4's real
   matrices at k=40 (reconstruction within ``REAL_REC_TOL``);
7. entry (a), the cycle of phase 3 under ``set_eigh_backend("jacobi")``
   (K3 at k=40), held against phase 3's Newton-Schulz analysis; then warm,
   timed;
8. entries (b) and (c) on the full grid: ``update_points_group`` for (U, V)
   under ``"jacobi"`` (K3), held against phase 7's columns; and
   ``update_points`` for T on a 41-member ensemble under ``"jacobi"`` (K4)
   and under ``"auto"`` (K1 at k=41), held against each other; under
   ``"jacobi"`` again, warm, timed, equal to the first run; and K4 bit for
   bit against its plain version on the first real ``[4096, 41, 41]``
   stack the entry gave it;
9. the entry point a user calls, ``driver.run_analysis``, on 40 WRF member
   files of the bench grid (128x128x20 at about 10 km, Milbrandt
   microphysics: the 16 production variables) written through the port's
   ``NetcdfWriter``, with a production-shaped namelist and synop, vr and
   dbz records at projected lon/lat over the whole domain:
   ``read_ensemble`` -> the fused run (five point sets; K1 only, its
   launches counted; finite, no overflow, converged, T's RMSE lower; K1
   against its plain version on the run's first batch) -> a second fused
   run, warm and timed (stage seconds, per-group wall and load, var-point
   updates/s, K1 seconds, peak device memory), equal bit for bit -> the
   per-variable run on a fresh read, within ``XA_RTOL`` of the fused
   increment per variable (``F32_ULPS`` where that is below one float32
   spacing) -> a control, the fused run with K1's Z off by ``Z_FAULT``,
   which every variable's limit must fail -> ``write_ensemble``, read back
   equal;
10. the command a user runs, ``cli.main`` (``python -m
   cwbnwp_letkf_torch.cli``), from input files to analysis files:
   (a) on ``synthetic_case.generate_case`` at its defaults (k=8, 24x20x6,
   40 stations): the card's output files held against the CLI's on the
   CPU (``--platform cpu``, the plain versions) within ``XA_RTOL`` of the
   increment, the analysis RMSE below 0.7 of the prior's, ``--stream``
   against eager on the card; (b) at full width: phase 9's 40 member files
   written again, its namelist with ``write_analy_mean = T``, and synop
   (``gts_letkf_###`` with an ``obs_gts`` altitude for every station), vr
   (``VR_letkf_###``) and dbz (``MR_letkf_###``) records at uniform
   lon/lat over the domain, written with the port's writers: the CLI eager
   (the native parser for every file, K1 alone and as often as phase 9,
   K1 against its plain version on the run's first batch, finite, no
   overflow, converged, T's analysis-mean RMSE lower, the mean file the
   member mean, the variables outside ``var_update`` byte-equal to the
   prior; the stage seconds, records parsed/s, var-point updates/s, K1
   seconds and peak device memory printed), then ``--stream``, held
   against eager;
11. the gather path at full width: entries (b) and (c) of phase 8 with
   ``method="gather"`` (top-k neighbor search and obs gather), (b) under
   ``"auto"`` (K1) and ``"jacobi"`` (K3), (c) under ``"jacobi"`` (K4) and
   ``"auto"`` (K1): one launch per chunk, finite, RMSE lower, a warm rerun
   timed and equal, the card against the CPU's plain versions on a subset
   (``GATHER_SUBSET``) within ``XA_RTOL`` of the increment, the gap to
   phase 8's ``method="auto"`` analysis and the points where the cap binds
   printed, each kernel against its plain version on its first real batch;
12. ``letkf_solve_group_refined`` (float32 Newton-Schulz, K1, refined by a
   float64 Newton step) on phase 4's real ``[4096, 40, 40]`` normal
   matrices, and on phase 13's first ``[2048, 96, 96]`` chunk: within
   ``REFINED_RTOL`` of the analysis scale of the float64 solve and
   ``REFINED_GAIN`` times closer to it than the float32 solve, one K1
   launch per inflation value, points/s of the refined, float32 and
   float64 solves;
13. the production shape of ``bench.py:548-717``: 450x450x52 points at
   3 km (10,530,000), k=96, 200,000 vr records presorted in Hilbert order,
   planned geometry-only (no table) and run with ``obs_presorted=True`` in
   slabs of 526,500 points at chunk = subchunk = 2048, ``PROD_RUN_SLABS``
   of them (the depth cut; :func:`prod_slabs`): finite, no overflow,
   converged, no library solve, K1 once per chunk and against its plain
   version on the first real ``[2048, 96, 96]`` batch, the first slab equal bit for
   bit to its run with ``obs_presorted=False``; seconds per slab,
   var-point updates/s, K1 seconds and mean steps, peak memory and the
   projection to 20 slabs printed;
14. the eigen factors under ``"auto"`` (``letkf_weight_factors_from_normal``
   on a seeded ``[4096, 40, 40]`` batch: K3 once, timed beside
   ``torch.linalg.eigh`` on the same matrices); ``profiling.device_breakdown``
   on the bench case (4,096 points): the stages positive and additive, K3
   launched in the ``eigh`` stage; and ``cli.main --device-breakdown`` on
   ``generate_case``'s case, its ``device_breakdown`` in ``--metrics-json``;
15. the multi-device layer (``parallel/``) on the one card: (a)
   ``sharded_update_points_cycle`` on an in-process mesh of two shards of
   the card (shards in turn), on phase 3's case with per-shard budgets (K1
   counted, no overflow, converged, against phase 3's analysis within
   ``XA_RTOL``), then warm beside a warm single-card cycle: the gap is the
   cost of sharding on one card, not scaling; (b)
   ``sharded_update_points_group`` for (U, V) under ``"jacobi"`` (K3) at
   two shards against phase 8's (b); (c) a process group of world size 1
   under NCCL: the member/point transposes round trip bit for bit, and
   ``run_analysis(mesh, distributed=True)`` on phase 9's files through the
   member-block streaming ensemble (K1 as often as phase 9) against phase
   9's fused analysis, file by file (bit for bit, or within ``XA_RTOL`` of
   the increment with the gap printed); (d) the pinned host-to-device rate
   and ``scaling_model.predict`` fed with it and phase 3's warm cycle,
   labelled a model.  NCCL at world size > 1 is not measured;
16. the drives of ``cwbnwp_letkf_torch/examples/`` at their full cases: (a)
   ``profile_cycle`` on phase 3's case (its six stages: the full cycle, the
   accumulation, without the cap search, cull and gathers only, the solve,
   the Newton-Schulz builds; ``PROFILE_REPS`` timed runs each after a warm
   one), K1 160 launches a run in the full cycle, the solve and the NS
   stages and none in the three accumulation stages, every stage's result
   finite, ``terms_from_r2`` restored, K1 against its plain version on the
   NS stage's first batch, the stage table and its derived split printed
   beside phase 3's warm cycle; (b) ``profile_groups`` (the UV group: full,
   accumulation, solve, the solve equal to the full update); (c)
   ``gpu_drive`` (its checks raise: RMSE near the stations below half,
   far corner untouched, spread down, reruns bit for bit, the fused group
   within 1e-3 of the per-variable solves); (d) ``gpu_cli_drive`` (the
   streaming CLI on its 64x64x16, k=24 case: files written, no overflow,
   finite groups; its metrics printed); (e) ``run_synthetic_cycle`` (RMSE
   below the prior's); (f) ``memory_bench`` at its defaults, run as its
   own command (eager and ``--stream`` children on the card, their peak
   host RSS and K1 launches).  K1 is counted in each, and no other kernel
   launches;
17. large ensembles, the JAX package's whole kernel range and the branches
   above it: (a) K1/K2 at ``[2048, 128, 128]`` (phase 2's rule; the plain
   iteration's time is the card's ``torch.matmul`` branch above k = 128),
   K3 at ``[1024, 128, 128]``, ``[512, 160, 160]`` and ``[256, 176,
   176]`` and K4 at ``[256, 129, 129]`` and ``[64, 177, 177]`` bit for bit
   (K4's plain version on the first ``LARGE_PLAIN_BATCH`` matrices), each
   with its bound, the share of it and of the issue floor (twice the
   bound), plain and ``torch.linalg.eigh`` times, K4 also with its chain
   floor (one link's latency, measured alone, times the rotations and the
   waves); (b) phase 13's case with
   128 members, the same ``PROD_RUN_SLABS`` slabs by the same runner (K1
   once a chunk, no library solve, no overflow, converged, K1 against its
   plain version on the first real batch, slab
   1's first chunk against a float64 solve within ``XA_RTOL`` of its
   increment; seconds a slab, the 20-slab projection, peak memory); (c) the
   CLI at ``nmember = 128`` on ``generate_case``'s case with
   ``--device-breakdown`` (K1 in the update, K3 at k = 128 in the
   breakdown), on the card against the CPU at phase 10(a)'s tolerance; (d)
   k = 178 under ``"jacobi"`` and k = 192 under ``"auto"`` on a real
   normal-matrix batch: no kernel launched, ``torch.linalg.eigh`` and the
   ``torch.matmul`` branch counted in ``solver.LIBRARY_SOLVES``, within
   ``XA_RTOL`` of a float64 solve; (e) the CLI at ``nmember = 129`` on the
   same case builder and grid with ``--device-breakdown``, on the card only
   (K4 above k = 96 in the breakdown's eigh stage, its time printed; the
   ``torch.matmul`` branch in the update; T's RMSE lower).  Each kernel's
   record gains the phase's measurements (``large_k``), error and
   launches;
18. K5, the cap search (``ops/cap_kernel.py``), against its plain version
   bit for bit (``sel`` and ``over``) at the main path's shapes
   ``CAP_SHAPES`` (the dense vr platform's subchunk, the production slab's
   chunk with the bucketed record mask) and on phase 3's first real input,
   with its time, the plain version's, its bound and the share of it, and
   the compiler's registers and spills for both instances (any spill or
   stack frame fails);
19. K6, the selected-pair accumulation (``ops/select_kernel.py``), against
   its plain version (the dense product with the fused rows) within the
   float32 bound of two orders of the sum, counts equal, at
   ``SELECT_SHAPES`` (the dense vr subchunk, the slab's chunk with the
   record mask; K5's selection, k = 96) and on phase 3's first real input,
   with max |da|, max |dg|, its time, its bound and the share of it, the
   plain version's time, the library's (``torch.matmul`` of the weights
   and the fused rows alone) and the compiler's registers and spills for
   every instance (any spill or stack frame fails).

Every path is driven with the launch counts set to 0 just before it and
read just after; the launches made to compare a kernel with its plain
version are not counted.  A kernel's bound is the least time an H100 could
take for the same work (``cuda_build.bound_ms`` of the kernel's ``work``:
float32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, the larger).
The last three lines of standard output are the kernel record (one JSON
object), the card's name and power limit, and the device record (one JSON
object).  The port is imported from this directory,
so the script fails when run alone, and it fails without a card.
"""
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

SEED = 0
K = 40
K_ODD = 41                  # entry (c): the sequential Jacobi kernel, K4
GRID = (128, 128, 20)       # 327,680 points at dx = 10 km
DX_M = 10e3
N_VARS = 16
CHUNK, SUBCHUNK = 4096, 512
#: var_update positions: 0:U 1:V 2:W 3:T 4:QVAPOR 5-12:hydrometeors 13:MU 14:P 15:PH
HYDRO = tuple(range(5, 13))
MOIST = slice(4, 13)        # the columns tune_q fixes
#: production variable groups by localization signature (input.nml:38-55):
#: (ivars, per-platform radii {platform: (hclr km, vclr km)})
PROD_GROUPS = (
    ((0, 1), {"synop": (50.0, 3.0), "vr": (36.0, 3.0)}),
    ((2,), {"synop": (50.0, 3.0), "vr": (12.0, 3.0)}),
    ((3, 4), {"synop": (50.0, 3.0), "vr": (24.0, 3.0)}),
    (HYDRO, {"dbz": (8.0, 2.0)}),
    ((13, 14, 15), {"synop": (50.0, -1.0), "vr": (24.0, -1.0)}),
)
#: platform, records, observed variables, max_lz_pts, obs error
PLATFORMS = (("synop", 2000, 5, 100, 0.5), ("vr", 20000, 1, 300, 1.0),
             ("dbz", 20000, 1, 300, 2.5))
#: multiplicative inflation (input.nml:160-170): 1.6 dynamics, 1.1 moisture
MULTI_INFL = tuple(1.1 if i >= 4 else 1.6 for i in range(N_VARS))
RTPP = RTPS = 0.95
NS_TOL = 1e-4
#: (batch, k) of the kernel checks: the main paths' per-launch shapes first
NS_SHAPES = ((12288, K), (2048, 96))
JACOBI_SHAPES = {"jacobi_parallel": ((4096, K), (2048, 96)),
                 "jacobi_cyclic": ((4096, K_ODD), (512, 9))}
#: an analysis held against another solve of the same normal matrices
#: (tests/test_torch_cycle.py:72-73, tests/test_cycle.py:109-112), relative
#: to the reference's analysis increment ``max|xa_ref - xb|``: the synthetic
#: field sits on a 290 offset, so ``max|xa|`` would scale the limit by the
#: offset, not by what the solve moves
XA_RTOL = 5e-4
#: K3's and K4's polished reconstruction bound on real first-chunk matrices
#: (phase 4's at k=40, entry (c)'s at k=41), in max|A|: seven sweeps leave
#: 4.6e-5 at k=40, above the 3e-5 of tests/test_pallas_eigh.py's synthetic
#: inputs (the TPU kernel's algorithm; the kernels equal their plain
#: versions bit for bit)
REAL_REC_TOL = 1e-4
#: the eigen solves of phase 4's control: (label, sweeps, polish)
EIGH_CONTROLS = (("7 sweeps + polish (the path)", 7, True),
                 ("8 sweeps + polish", 8, True),
                 ("7 sweeps, no polish", 7, False),
                 ("6 sweeps + polish", 6, True),
                 ("5 sweeps + polish", 5, True),
                 ("4 sweeps + polish", 4, True),
                 ("3 sweeps + polish", 3, True))
#: the control the limit must fail: 9x over it on the bench case
SHORT_CONTROL = "4 sweeps + polish"
#: warm runs of the library yardstick, and the seconds one shape's yardstick
#: may take before its batch is cut (the cut is printed and recorded)
LIBRARY_REPS = 3
LIBRARY_BUDGET_S = 5.0
#: phase 11: the CPU parity subsets of the gather entries, every n-th point
#: of the grid: 8,192 points for the Newton-Schulz entries and 1,024 for the
#: Jacobi ones, whose plain versions take about 5 s (K3) and 13 s (K4) a
#: thousand matrices on the CPU
GATHER_SUBSET = {"auto": 8192, "jacobi": 1024}
#: phase 11's runs: (entry, backend, kernel, the kernel's launch module)
GATHER_RUNS = (("b", "auto", "ns_invsqrt"), ("b", "jacobi", "jacobi_parallel"),
               ("c", "jacobi", "jacobi_cyclic"), ("c", "auto", "ns_invsqrt"))
#: phase 12: the refined-solve setting of bench.py:455-476, two variables at
#: inflation 1.1 and 1.6, RTPP = RTPS = 0.95, held against the float64 solve
#: within REFINED_RTOL of the analysis scale (tests/test_ns_solver.py:144-163)
REFINED_INFL = (1.1, 1.6)
REFINED_RTOL = 1e-6
#: and at least this many times closer to it than the float32 solve, as
#: tests/test_ns_solver.py:118-141 holds the refined Z: the float32 solve
#: alone sits inside REFINED_RTOL on these matrices
REFINED_GAIN = 20
#: phase 13: the production shape of bench.py:548-717: 450x450x52 points at
#: 3 km (10,530,000), k=96, 200,000 vr records presorted in Hilbert order of
#: the blocking's metric (hclr 24 km, vclr 3 km), cap 300, seed 9, in 20
#: slabs at chunk = subchunk = 2048
PROD_GRID = (450, 450, 52)
PROD_DX_M, PROD_DZ_M = 3e3, 400.0
PROD_K = 96
PROD_RECORDS = 200_000
PROD_RADII = (24.0, 3.0)
PROD_CAP = 300
PROD_SEED = 9
PROD_SLABS = 20
PROD_CHUNK = 2048
#: the depth cut of phases 13 and 17(b): the slabs run of the 20, the same
#: count at k=96 and k=128 so that their projections compare (phase 13 ran
#: slabs for 45 s before phase 17 needed the time)
PROD_RUN_SLABS = 2
#: phase 16: timed runs of each profile_cycle stage after its warm run (the
#: drive's own default is 2; one keeps phase 16 near 150 s)
PROFILE_REPS = 1
#: phase 17, large ensembles.  (a) the kernels at the new shapes: K1/K2 at
#: k=128, their largest k; K3 at 128, 160 and 176 and K4 at 129 and 177, up
#: to the Jacobi kernels' largest k (the JAX package's Pallas reach)
LARGE_NS_SHAPES = ((2048, 128),)
LARGE_JACOBI_SHAPES = {"jacobi_parallel": ((1024, 128), (512, 160),
                                           (256, 176)),
                       "jacobi_cyclic": ((256, 129), (64, 177))}
#: K4's plain version loops over k (k - 1) / 2 rotations a sweep in Python,
#: about 0.44 ms each on the card whatever the batch: it is held bit for bit
#: and timed (once) on the first LARGE_PLAIN_BATCH matrices; K3's plain
#: version is held on the whole batch and timed on that one run too
LARGE_PLAIN_BATCH = 8
#: the polished reconstruction bound at the large shapes, in max|A|: seven
#: sweeps of the round-robin order leave up to 4.3e-5 at k=176 on these
#: inputs (48 matrices, the plain version on the CPU), above the 3e-5 of
#: tests/test_pallas_eigh.py; the kernels equal their plain versions bit for
#: bit, so this bounds the algorithm at seven sweeps, not the kernels
LARGE_REC_TOL = REAL_REC_TOL
#: and the sorted eigenvalues' bound against float64, in max|A| beside the
#: rtol of 1e-4: seven sweeps at k=177 leave one of phase 17's 64 matrices
#: 6.9e-2 off (measured on an H100), above the 3e-5 max|A| of
#: tests/test_pallas_eigh.py; the same bound of the algorithm as above
LARGE_LAM_ATOL = 1e-3
#: (b) phase 13's case with LARGE_K members; (c) the CLI on
#: generate_case's case with LARGE_K members on LARGE_CLI_GRID
LARGE_K = 128
LARGE_CLI_GRID = dict(nx=16, ny=14, nz=4, n_obs=30)
#: (e) the CLI at this nmember on LARGE_CLI_GRID: the first odd k above 96
#: whose eigen factors take K4 above k = 96 (its Newton-Schulz solve takes
#: the torch.matmul branch above K1's 128)
LARGE_K4_CLI = 129
#: (d) the branches above the kernels: (k, backend) on the first
#: ABOVE_POINTS points of the first chunk of the bench grid's lowest
#: ABOVE_NZ levels, for the production groups ABOVE_GROUPS (U, V at
#: inflation 1.6; T, QVAPOR at 1.6 and 1.1): torch.linalg.eigh takes
#: milliseconds a matrix at these k, so the batch is kept small
ABOVE = ((178, "jacobi"), (192, "auto"))
ABOVE_NZ = 2
ABOVE_POINTS = 512
ABOVE_GROUPS = (0, 2)
#: phase 18, the cap search: (batch, records, records within the radius,
#: masked share of the records) of the dense vr platform's subchunk (6,033
#: records, no mask) and of the production slab's chunk (about 14,300
#: candidate records, the bucketed record mask), and the vr cap
CAP_SHAPES = {"dense_vr": (512, 6033, 1500, 0.0),
              "slab": (2048, 14300, 2000, 0.1)}
CAP_N_MAX = 300
#: phase 19, the selected-pair accumulation: (points, records, records
#: within the radius, masked share, k) of the dense vr subchunk and of the
#: production slab's chunk, K5's selection at the vr cap
SELECT_SHAPES = {"dense_vr": (512, 6033, 1500, 0.0, 96),
                 "slab": (2048, 14300, 2000, 0.1, 96)}
#: name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "ns_invsqrt": ("cuda", "cwbnwp_letkf_torch/csrc/ns_invsqrt.cu",
                   "cwbnwp_letkf_tpu/ops/pallas_ns.py:109"),
    "ns_invsqrt_rmul": ("cuda", "cwbnwp_letkf_torch/csrc/ns_invsqrt.cu",
                        "cwbnwp_letkf_tpu/ops/pallas_ns.py:268"),
    "jacobi_parallel": ("cuda", "cwbnwp_letkf_torch/csrc/jacobi_eigh.cu",
                        "cwbnwp_letkf_tpu/ops/pallas_eigh.py:144"),
    "jacobi_cyclic": ("cuda", "cwbnwp_letkf_torch/csrc/jacobi_eigh.cu",
                      "cwbnwp_letkf_tpu/ops/pallas_eigh.py:76"),
    "cap_search": ("cuda", "cwbnwp_letkf_torch/csrc/cap_search.cu",
                   "replaces no Pallas kernel; JAX _cap_threshold is XLA, "
                   "cwbnwp_letkf_tpu/ops/dense.py:239"),
    "select_terms": ("cuda", "cwbnwp_letkf_torch/csrc/select_terms.cu",
                     "replaces no Pallas kernel; the JAX package's dense "
                     "product is XLA, cwbnwp_letkf_tpu/ops/dense.py:342"),
}


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps=5):
    """Median of ``reps`` warm runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps=20):
    """The card's time for one call of ``fn``: ``reps`` calls queued behind
    a 20 ms spin of the card (``torch.cuda._sleep``) and timed with CUDA
    events, so that the host's time per call does not show where the card's
    is shorter.  A warm call first."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(20e-3 * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def timed_launches(module):
    """Every ``module.launch`` made under it is bracketed by a pair of CUDA
    events on the current stream (nothing waits on them); yields the list
    of pairs, for :func:`launch_seconds` after a synchronize."""
    events = []
    launch = module.launch

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    module.launch = timed
    try:
        yield events
    finally:
        module.launch = launch


@contextlib.contextmanager
def first_input(module):
    """Under it, a copy of the first batch given to ``module.launch`` and
    the call's other positional arguments are kept in the yielded list, as
    ``(batch, args)`` (the list stays empty if there is no launch)."""
    got = []
    launch = module.launch

    def capture(a, *args, **kwargs):
        if not got:
            got.append((a.clone(), args))
        return launch(a, *args, **kwargs)

    module.launch = capture
    try:
        yield got
    finally:
        module.launch = launch


def launch_seconds(events):
    return sum(start.elapsed_time(end) for start, end in events) / 1e3


def bound_of(work):
    """``{"bound_ms", "bound_by"}`` for a kernel's ``(flop, bytes)``."""
    from cwbnwp_letkf_torch.ops import cuda_build

    flop, nbytes = work
    by_ops = (flop / cuda_build.PEAK_FP32_FLOPS
              >= nbytes / cuda_build.PEAK_HBM_BYTES_PER_S)
    return {"bound_ms": cuda_build.bound_ms(flop, nbytes),
            "bound_by": "operations" if by_ops else "bytes"}


def timed_entry(err, ms, plain_ms, work, library_ms=None, **extra):
    """A kernel's measured part of the kernel record."""
    bound = bound_of(work)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "share_of_bound": bound["bound_ms"] / ms, "library_ms": library_ms,
            **extra}


def library_eigh_ms(a):
    """``(ms, batch)``: the median of ``LIBRARY_REPS`` warm float32
    ``torch.linalg.eigh`` calls on ``a``, the one PyTorch call that computes
    what K3 and K4 compute.  A probe on a sixteenth of the batch decides
    whether the whole batch fits ``LIBRARY_BUDGET_S``; if not, the batch is
    halved until it does, and the returned batch says so."""
    b = a.shape[0]
    probe = a[:max(1, b // 16)]
    torch.linalg.eigh(probe[:1])          # the solver's handle and workspace
    torch.cuda.synchronize()
    t0 = time.time()
    torch.linalg.eigh(probe)
    torch.cuda.synchronize()
    per_matrix = (time.time() - t0) / probe.shape[0]
    while b > 1 and (LIBRARY_REPS + 1) * per_matrix * b > LIBRARY_BUDGET_S:
        b //= 2
    part = a[:b]
    return median_ms(lambda: torch.linalg.eigh(part), reps=LIBRARY_REPS), b


def reset_counts():
    """Sets the kernels' launch counts and ``solver.LIBRARY_SOLVES`` to 0."""
    from cwbnwp_letkf_torch.ops import eigh_kernel, ns_kernel, solver

    for counts in (ns_kernel.LAUNCHES, eigh_kernel.LAUNCHES,
                   solver.LIBRARY_SOLVES):
        for key in counts:
            counts[key] = 0


def read_counts():
    """Launches per kernel since the last :func:`reset_counts`."""
    from cwbnwp_letkf_torch.ops import eigh_kernel, ns_kernel

    torch.cuda.synchronize()
    return {"ns_invsqrt": ns_kernel.LAUNCHES["trio"],
            "ns_invsqrt_rmul": ns_kernel.LAUNCHES["rmul"],
            "jacobi_parallel": eigh_kernel.LAUNCHES["parallel"],
            "jacobi_cyclic": eigh_kernel.LAUNCHES["cyclic"]}


def read_library():
    """Solves of the library branches (``solver.LIBRARY_SOLVES``: the card's
    ``torch.matmul`` Newton-Schulz iteration above K1's range, and every
    ``torch.linalg.eigh``) since the last :func:`reset_counts`."""
    from cwbnwp_letkf_torch.ops import solver

    return dict(solver.LIBRARY_SOLVES)


def check_no_library(what):
    """No library branch took a solve since the last :func:`reset_counts`."""
    lib = read_library()
    print(f"  {what}: library solves {lib}")
    check(not any(lib.values()), f"{what}: library solves {lib}")


def check_only(counts, name, expected, what):
    """``name`` launched ``expected`` times in the path, no other kernel."""
    print(f"  {what}: kernel launches {counts}")
    check(counts[name] == expected,
          f"{what}: {counts[name]} {name} launches, expected {expected}")
    check(all(n == 0 for key, n in counts.items() if key != name),
          f"{what}: other kernels launched: {counts}")


def normal_matrices(rng, b, k, dev):
    """``Y Y^T`` with ``Y`` ``[b, k, 2k]`` of N(0, 0.5^2) entries."""
    y = torch.from_numpy(
        rng.standard_normal((b, k, 2 * k)).astype(np.float32) * 0.5).to(dev)
    return y @ y.transpose(1, 2)


def ill_conditioned_matrices(rng, b, k, dev, n=300):
    """300 strong obs seeing one ensemble mode: kappa in the hundreds."""
    u = rng.standard_normal((b, k, 1)).astype(np.float32)
    w = rng.standard_normal((b, 1, n)).astype(np.float32)
    y = 5.0 * u * w + 0.1 * rng.standard_normal((b, k, n)).astype(np.float32)
    y = torch.from_numpy(y).to(dev)
    return y @ y.transpose(1, 2)


def compare_kernel(a, inflat, label, packing="trio"):
    """Kernel vs plain on one batch, with the CPU tests' tolerances.

    ``max|Z A Z - I|`` (float64) below ``max(5e-4, 20 kappa 1.2e-7)``, the
    float32 floor of the iteration (tests/test_ns_solver.py:115), and Z
    within ``max(2e-4, 20 kappa 1.2e-7) max|Z|`` of the plain version: 2e-4
    (tests/test_ns_solver.py:256-258) below kappa ~ 83, the same float32
    floor above, since the kernel stops each matrix on its own (and K1
    tracks ``W = ZY``, not ``Y``).  Against the float64 eigh solution the
    kernel's Z must also be no worse than twice the plain version's error
    (or ``2e-4 max|Z|``).  ``packing="rmul"`` checks K2 against
    ``ns_invsqrt_rmul`` and also against K1's Z.  Returns ``max|dZ|``.
    """
    from cwbnwp_letkf_torch.ops import ns_kernel, solver

    plain = solver.ns_invsqrt_rmul if packing == "rmul" else solver.ns_invsqrt
    z, iters, resid = ns_kernel.launch(a, inflat, packing=packing)
    z_plain, iters_plain, err_plain = plain(a, inflat, return_info=True)
    k = a.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    a64 = a.double() + inflat * eye
    lam, vec = torch.linalg.eigh(a64)
    kappa = float((lam[:, -1] / lam[:, 0]).max())
    floor = 20 * kappa * 1.2e-7
    z_true = (vec * lam.rsqrt()[:, None, :]) @ vec.transpose(1, 2)
    err_true = float((z.double() - z_true).abs().max())
    err_true_plain = float((z_plain.double() - z_true).abs().max())

    def zaz(zz):
        zz = zz.double()
        return float((zz @ a64 @ zz - eye).abs().max())

    res, res_plain = zaz(z), zaz(z_plain)
    res_tol = max(5e-4, floor)
    dz = float((z - z_plain).abs().max())
    dz_tol = max(2e-4, floor) * float(z_plain.abs().max())
    print(f"  {label} ({packing}): kappa_max {kappa:.1f}  iters kernel max "
          f"{int(iters.max())} mean {float(iters.float().mean()):.3f}, plain "
          f"{iters_plain}  NS residual kernel {float(resid.max()):.3e}, plain "
          f"{float(err_plain):.3e}  max|ZAZ-I| kernel {res:.3e}, plain "
          f"{res_plain:.3e} (tol {res_tol:.1e})  max|dZ| {dz:.3e} "
          f"(tol {dz_tol:.3e})  max|Z - Z_f64| kernel {err_true:.3e}, plain "
          f"{err_true_plain:.3e}")
    check(bool(torch.isfinite(z).all()), f"{label}: kernel Z not finite")
    check(float(resid.max()) <= NS_TOL, f"{label}: kernel did not converge")
    check(res < res_tol, f"{label}: max|ZAZ-I| {res} >= {res_tol}")
    check(dz <= dz_tol, f"{label}: kernel and plain Z differ by {dz}")
    # and no less accurate than the plain version, against float64 eigh
    check(err_true <= max(2 * err_true_plain, 2e-4 * float(z_true.abs().max())),
          f"{label}: kernel Z error {err_true} vs plain {err_true_plain}")
    if packing == "rmul":
        z_trio, _, _ = ns_kernel.launch(a, inflat)
        d_trio = float((z - z_trio).abs().max())
        print(f"    max|Z_rmul - Z_trio| {d_trio:.3e} (tol {dz_tol:.3e})")
        check(d_trio <= dz_tol, f"{label}: K2 and K1 differ by {d_trio}")
    return dz


def phase_kernel(dev, rng, packing="trio", shapes=NS_SHAPES):
    """Phases 2, 5 and 17(a): returns the kernel's measured record at the
    first of ``shapes`` (``timed_entry``), the error over all of them."""
    from cwbnwp_letkf_torch.ops import ns_kernel, solver

    plain = solver.ns_invsqrt_rmul if packing == "rmul" else solver.ns_invsqrt
    worst = 0.0
    entries = []
    for b, k in shapes:
        inflat = (k - 1) / 1.1
        a = normal_matrices(rng, b, k, dev)
        worst = max(worst, compare_kernel(a, inflat, f"normal [{b},{k},{k}]",
                                          packing))
        ill = ill_conditioned_matrices(rng, b // 8, k, dev)
        worst = max(worst, compare_kernel(
            ill, inflat, f"ill-conditioned [{b // 8},{k},{k}]", packing))
        ms = median_ms(lambda: ns_kernel.launch(a, inflat, packing=packing))
        plain_ms = median_ms(lambda: plain(a, inflat))
        steps = float(ns_kernel.launch(a, inflat, packing=packing)[1]
                      .float().mean())
        entry = timed_entry(worst, ms, plain_ms, ns_kernel.work(b, k, steps))
        entries.append(entry)
        print(f"  [{b},{k},{k}] {packing} kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  (median of 5 warm runs, CUDA events); "
              f"mean steps {steps:.3f}, bound {entry['bound_ms']:.4f} ms by "
              f"{entry['bound_by']}, share of bound "
              f"{entry['share_of_bound']:.3f}")
    print("  library_ms null: no single PyTorch call computes "
          "(a + inflat I)^(-1/2)")
    entries[0]["max_abs_err"] = worst
    return entries[0]


def bench_case(rng, nz, k=K):
    """The bench case, built by the port's synthetic generators (numpy)."""
    from cwbnwp_letkf_torch.config import MAX_VARS
    from cwbnwp_letkf_torch.obs.base import PlatformStatic
    from cwbnwp_letkf_torch.obs.synthetic import (correlated_ensemble,
                                                  idealized_grid,
                                                  synthetic_gts_platform)

    pts = idealized_grid(GRID[0], GRID[1], nz, dx_m=DX_M)
    truth, xb = correlated_ensemble(rng, pts, k, n_bumps=8, length_m=1.5e5)
    plats = []
    for name, nobs, nvar, cap, err in PLATFORMS:
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = [-1.0] * MAX_VARS, [-1.0] * MAX_VARS
        for ivars, radii in PROD_GROUPS:
            for iv in ivars:
                if name in radii:
                    h[iv], v[iv] = radii[name]
        plats.append((PlatformStatic(
            name=name, kind=st0.kind, nvar=nvar, max_lz_pts=cap,
            hclr=tuple(h), vclr=tuple(v), err_muti=st0.err_muti,
            err_rej=st0.err_rej, is_assim=st0.is_assim), po))
    return pts, truth, xb, plats


def cycle_groups():
    from cwbnwp_letkf_torch.ops.cycle import CycleGroup

    return [CycleGroup(ivars=tuple(ivars),
                       inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
                       rtpp_alpha=(RTPP,) * len(ivars),
                       rtps_alpha=(RTPS,) * len(ivars))
            for ivars, _ in PROD_GROUPS]


def main_path(xb_v, pts_d, plats, groups, dev):
    """The port's device path, as the driver runs it for one point set."""
    from cwbnwp_letkf_torch.ops import cycle, solver, update

    dplats = [update.prepare_platform(st, po, device=dev) for st, po in plats]
    budgets = cycle.plan_cycle_budgets(pts_d, dplats, groups, chunk=CHUNK,
                                       subchunk=SUBCHUNK)
    t0 = time.time()
    xa, diag = cycle.update_points_cycle(
        xb_v, pts_d, dplats, groups, weight_function=0, chunk=CHUNK,
        subchunk=SUBCHUNK, max_blocks=budgets, return_diagnostics=True)
    torch.cuda.synchronize(dev)
    cycle_s = time.time() - t0
    xa[:, MOIST] = solver.tune_q(xa[:, MOIST])
    return xa, diag, budgets, dplats, cycle_s


def rmse(x, truth):
    return float(((x - truth) ** 2).mean().sqrt())


def check_rmse(xa, xb_d, truth_d, cols, what):
    """The analysis-mean RMSE of each ``(column, name)`` below the
    background's."""
    rmse_b = rmse(xb_d.mean(-1), truth_d)
    for col, name in cols:
        rmse_a = rmse(xa[:, col].mean(-1), truth_d)
        print(f"  {what}, column {col} ({name}): mean RMSE background "
              f"{rmse_b:.4f} -> analysis {rmse_a:.4f}")
        check(rmse_a < rmse_b, f"{what}, column {col}: analysis RMSE not lower")


def check_close(xa, ref, xb, what):
    """``max|xa - ref| <= XA_RTOL max|ref - xb|``, the gap in units of the
    reference's analysis increment; returns ``max|xa - ref|``."""
    diff = float((xa - ref).abs().max())
    incr = float((ref - xb).abs().max())
    tol = XA_RTOL * incr
    print(f"  {what}: max|dxa| {diff:.3e} = {diff / incr:.3e} of the "
          f"increment max|xa_ref - xb| {incr:.4f} (tol {tol:.3e})")
    check(diff <= tol, f"{what}: max|dxa| {diff} > {tol}")
    return diff


def phase_slice(dev, case):
    """Phase 3: returns what phases 4 and 7 need, K1's launch count, and
    the cap search's and the selected-pair accumulation's launches in the
    first run, each with its first input."""
    from cwbnwp_letkf_torch.ops import cap_kernel, ns_kernel, select_kernel

    pts, truth, xb, plats = case
    b = pts.shape[0]
    groups = cycle_groups()
    pts_d = torch.from_numpy(pts).to(dev)
    xb_d = torch.from_numpy(xb).to(dev)
    truth_d = torch.from_numpy(truth).to(dev)
    xb_v = xb_d[:, None, :].expand(b, N_VARS, K)   # one field for all columns

    reset_counts()
    cap_before, sel_before = cap_kernel.LAUNCHES, select_kernel.LAUNCHES
    t0 = time.time()
    with first_input(cap_kernel) as cap_first, \
            first_input(select_kernel) as sel_first:
        xa, diag, budgets, dplats, _ = main_path(xb_v, pts_d, plats, groups,
                                                 dev)
    torch.cuda.synchronize(dev)
    cold_s = time.time() - t0
    counts = read_counts()
    launches = counts["ns_invsqrt"]
    cap_launches = cap_kernel.LAUNCHES - cap_before
    sel_launches = select_kernel.LAUNCHES - sel_before
    print(f"  first run: cap search launches {cap_launches}, selected-pair "
          f"accumulation launches {sel_launches}")
    check(cap_launches > 0 and cap_first, "the cycle never took the cap search")
    check(sel_launches == cap_launches and sel_first,
          "the capped calls did not all take the selected-pair accumulation")
    overflow = int(diag["bucket_overflow"])
    resid = float(diag["ns_residual"])
    print(f"  first run {cold_s:.3f} s: budgets "
          f"{ {n: tuple(bb) for n, bb in budgets.items()} }, overflow "
          f"{overflow}, ns_residual {resid:.3e}")
    check(tuple(xa.shape) == (b, N_VARS, K), f"xa shape {tuple(xa.shape)}")
    check(bool(torch.isfinite(xa).all()), "analysis not finite")
    check(overflow == 0, f"bucket overflow {overflow}")
    check(resid <= NS_TOL, f"ns_residual {resid} > {NS_TOL}")
    n_chunks = -(-b // CHUNK)
    check_only(counts, "ns_invsqrt", 2 * n_chunks,
               "NS cycle (2 per chunk: one per inflation value)")
    check_rmse(xa, xb_d, truth_d, ((0, "U"), (3, "T")), "NS cycle")
    del xa

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    with timed_launches(ns_kernel) as events:
        xa, diag, _, _, cycle_s = main_path(xb_v, pts_d, plats, groups, dev)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    check(bool(torch.isfinite(xa).all()), "warm analysis not finite")
    print(f"  warm run: K1 {launch_seconds(events):.4f} s on the card in "
          f"{len(events)} launches (CUDA events around each)")
    print(f"  warm run: wall {wall:.3f} s (prepare -> plan -> cycle -> "
          f"tune_q), {b * N_VARS / wall:.1f} var-point updates/s; "
          f"update_points_cycle alone {cycle_s:.3f} s, "
          f"{b * N_VARS / cycle_s:.1f} var-point updates/s; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return (pts_d, xb_d, truth_d, xa, dplats, groups, budgets, launches,
            cycle_s, (cap_launches, cap_first[0]),
            (sel_launches, sel_first[0]))


def phase_real(pts_d, dplats, groups, budgets):
    """Phase 4: the kernel on the real normal matrices of the first chunk.

    Returns ``(max|dZ|, [(stack, inflat)], (rows, a, g, count))``, one stack
    per inflation value, and the chunk's point rows and normal terms.  Also
    prints K1's mean steps, time and bound on each stack: the main path
    launches it on such stacks, not on phase 2's seeded ones.
    """
    from cwbnwp_letkf_torch.ops import cycle, ns_kernel

    plans = cycle._resolve_plans(dplats, groups, max_blocks=budgets)
    perm = cycle._cycle_point_perm(pts_d, plans)
    a, g, cnt, ovf = cycle.accumulate_chunk(
        pts_d[perm[:CHUNK]], plans, groups, k=K, weight_function=0,
        subchunk=SUBCHUNK)
    check(int(ovf) == 0, "overflow in the first chunk")
    worst = 0.0
    stacks = []
    for val in sorted({v for grp in groups for v in grp.inflats}):
        members = [gi for gi, grp in enumerate(groups) if val in grp.inflats]
        stack = torch.cat([a[gi] for gi in members])
        with_obs = int(sum((cnt[gi] > 0).sum() for gi in members))
        worst = max(worst, compare_kernel(
            stack, val, f"first chunk, inflat {val:.4f}, {stack.shape[0]} "
                        f"matrices ({with_obs} with obs)"))
        stacks.append((stack, val))
        ms = median_ms(lambda: ns_kernel.launch(stack, val))
        steps = float(ns_kernel.launch(stack, val)[1].float().mean())
        bound = bound_of(ns_kernel.work(stack.shape[0], K, steps))["bound_ms"]
        print(f"    K1 on this stack: mean steps {steps:.3f}, {ms:.4f} ms a "
              f"launch (median of 5 warm runs), bound {bound:.4f} ms, share "
              f"of bound {bound / ms:.3f}")
    return worst, stacks, (perm[:CHUNK], a, g, cnt)


def phase_eigh_control(first, xb_d, groups):
    """Phase 4, second part: the first chunk's analysis, per group with
    obs, through the Jacobi solve at ``EIGH_CONTROLS``' precisions and
    through K1, each against float64 ``torch.linalg.eigh``, in units of the
    analysis increment ``max|xa_ref - xb|`` over all groups.  The path's
    Jacobi solve and K1 must meet ``XA_RTOL``; the controls show what a
    less accurate eigen solve reads at that scale, and the limit must see a
    solve three sweeps short (``SHORT_CONTROL``).  Returns
    ``{label: gap / increment}``.
    """
    from cwbnwp_letkf_torch.ops import solver
    from cwbnwp_letkf_torch.ops.jacobi_eigh import jacobi_eigh

    rows, a, g, cnt = first
    xb = xb_d[rows]
    f64 = torch.float64
    eye = torch.eye(K, device=xb.device)
    gaps = {label: 0.0 for label, _, _ in EIGH_CONTROLS}
    gaps["Newton-Schulz, K1"] = 0.0
    incr = 0.0
    for gi, grp in enumerate(groups):
        has = cnt[gi] > 0
        if not bool(has.any()):
            continue
        a_g, g_g, xb_g = a[gi][has], g[gi][has], xb[has]
        val = grp.inflats[0]
        lam, v = torch.linalg.eigh(a_g.double() + val * eye.double())
        ref = solver.apply_weight_factors(lam, v, g_g.double(), xb_g.double(),
                                          solver_dtype=f64)
        incr = max(incr, float((ref - xb_g.double()).abs().max()))
        for label, sweeps, polish in EIGH_CONTROLS:
            lam, v = jacobi_eigh(a_g + val * eye, sweeps=sweeps, polish=polish)
            xa = solver.apply_weight_factors(lam, v, g_g, xb_g)
            gaps[label] = max(gaps[label], float((xa.double() - ref).abs().max()))
        z, _ = solver._ns_z(a_g, val)
        xa = solver._apply_z(z, g_g, xb_g)
        gaps["Newton-Schulz, K1"] = max(gaps["Newton-Schulz, K1"],
                                        float((xa.double() - ref).abs().max()))
    print(f"  first chunk, {len(groups)} groups: analysis increment "
          f"max|xa_f64 - xb| {incr:.4f}, limit XA_RTOL {XA_RTOL:.0e} of it")
    for label, gap in gaps.items():
        print(f"    {label}: max|xa - xa_f64| {gap:.3e} = {gap / incr:.3e} of "
              f"the increment ({gap / (XA_RTOL * incr):.3f} of the limit)")
    for label in (EIGH_CONTROLS[0][0], "Newton-Schulz, K1"):
        check(gaps[label] <= XA_RTOL * incr,
              f"first chunk, {label}: {gaps[label]} off float64")
    check(gaps[SHORT_CONTROL] > XA_RTOL * incr,
          f"first chunk, {SHORT_CONTROL}: {gaps[SHORT_CONTROL]} off float64 "
          f"passes the limit, which therefore cannot see it")
    return {label: gap / incr for label, gap in gaps.items()}


def phase_rmul(dev, stacks):
    """Phase 5: K2's entry point on the real matrices, then K2 against its
    plain version and K1 on phase 2's sets.  Returns its launches and its
    measured record."""
    from cwbnwp_letkf_torch.ops import ns_kernel

    reset_counts()
    outs = [ns_kernel.ns_invsqrt_cuda(stack, val, packing="rmul")
            for stack, val in stacks]
    counts = read_counts()
    check_only(counts, "ns_invsqrt_rmul", len(stacks),
               "ns_invsqrt_cuda(packing='rmul') on the first chunk's stacks")
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    for (stack, val), (z, iters, resid) in zip(stacks, outs):
        a64 = stack.double() + val * eye
        lam = torch.linalg.eigvalsh(a64)
        res_tol = max(5e-4, 20 * float((lam[:, -1] / lam[:, 0]).max()) * 1.2e-7)
        z = z.double()
        res = float((z @ a64 @ z - eye).abs().max())
        print(f"    inflat {val:.4f}: {int(iters)} steps at most, residual "
              f"{float(resid):.3e}, max|ZAZ-I| {res:.3e} (tol {res_tol:.1e})")
        check(float(resid) <= NS_TOL and res < res_tol,
              f"K2 on the real stack at inflat {val}: residual {float(resid)}, "
              f"max|ZAZ-I| {res}")
    entry = phase_kernel(dev, np.random.default_rng(SEED + 1), packing="rmul")
    return {"launches": counts["ns_invsqrt_rmul"], **entry}


def reconstruction(lam, v, a):
    """``max|V diag(lam) V^T - A| / max|A|`` in float64."""
    lam, v, a64 = lam.double(), v.double(), a.double()
    return float(((v * lam[:, None, :]) @ v.transpose(1, 2) - a64).abs().max()
                 / a64.abs().max())


def compare_jacobi(a, label, timed=True, rec_tol=3e-5, plain_batch=None,
                   lam_atol=3e-5):
    """K3/K4 against its plain version on one batch; returns ``(max|d|,
    record)``, the record (``timed_entry``, with the bound of seven sweeps and
    the library yardstick) None unless ``timed``.

    The raw sweeps' eigenvalues and eigenvectors bit for bit (the same
    roundings in the same order); then, on the wrapper's polished output, the
    tolerances of
    tests/test_pallas_eigh.py:28-35: ``max|V diag(lam) V^T - A| <= rec_tol
    max|A|`` (3e-5 there), ``max|V^T V - I| <= 1e-5`` and sorted ``lam``
    against float64 eigenvalues at rtol 1e-4 and ``lam_atol max|A|`` (3e-5
    there).  With ``plain_batch`` the plain version runs once, on the first
    ``plain_batch`` matrices (all of them if there are fewer), which hold
    the kernel's output bit for bit and give ``plain_ms`` (CUDA events, one
    run); without it, on all of them, and ``plain_ms`` is the median of 5.
    """
    from cwbnwp_letkf_torch.ops import eigh_kernel
    from cwbnwp_letkf_torch.ops.jacobi_eigh import (jacobi_cyclic, jacobi_eigh,
                                                    jacobi_parallel)

    b, k, _ = a.shape
    name = eigh_kernel.kernel_for(k)
    plain = jacobi_parallel if name == "parallel" else jacobi_cyclic
    lam_all, v_all = eigh_kernel.launch(a)
    nb = b if plain_batch is None else min(b, plain_batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lam_p, v_p = plain(a[:nb])
    end.record()
    end.synchronize()
    lam, v = lam_all[:nb], v_all[:nb]
    scale = float(a.abs().max())
    d_lam = float((lam - lam_p).abs().max())
    d_v = float((v - v_p).abs().max())
    lam_w, v_w = jacobi_eigh(a)
    rec = reconstruction(lam_w, v_w, a)
    lam_w, v_w, a64 = lam_w.double(), v_w.double(), a.double()
    orth = float((v_w.transpose(1, 2) @ v_w
                  - torch.eye(k, dtype=torch.float64, device=a.device))
                 .abs().max())
    ref = torch.linalg.eigvalsh(a64.cpu())
    d_sorted = (torch.sort(lam_w.cpu(), -1).values - ref).abs()
    sorted_ok = bool((d_sorted <= 1e-4 * ref.abs() + lam_atol * scale).all())
    print(f"  {label} ({name}): max|dlam| {d_lam:.3e}, max|dV| {d_v:.3e} vs "
          f"plain" + ("" if nb == b else f" on the first {nb} matrices")
          + f"; polished: reconstruction {rec:.3e} max|A| (tol "
          f"{rec_tol:.0e}), orthogonality {orth:.3e} (tol 1e-5), sorted lam vs f64 "
          f"max|d| {float(d_sorted.max()):.3e} = "
          f"{float(d_sorted.max()) / scale:.3e} max|A| (tol 1e-4 |lam| + "
          f"{lam_atol:.0e} max|A|)")
    check(bool(torch.isfinite(lam_all).all() and torch.isfinite(v_all).all()),
          f"{label}: kernel output not finite")
    check(torch.equal(lam, lam_p) and torch.equal(v, v_p),
          f"{label}: kernel and plain differ: max|dlam| {d_lam}, max|dV| {d_v}")
    check(rec <= rec_tol, f"{label}: reconstruction {rec} max|A|")
    check(orth <= 1e-5, f"{label}: orthogonality {orth}")
    check(sorted_ok, f"{label}: eigenvalues off float64 by "
                     f"{float(d_sorted.max())}")
    if not timed:
        return max(d_lam, d_v), None
    ms = median_ms(lambda: eigh_kernel.launch(a))
    if plain_batch is None:
        plain_ms, plain_how = median_ms(lambda: plain(a)), "median of 5 warm runs"
    else:
        plain_ms = start.elapsed_time(end)
        plain_how = f"one run at batch {nb}"
    lib_ms, lib_b = library_eigh_ms(a)
    cut = {} if lib_b == b else {"library_batch": lib_b}
    if plain_batch is not None:
        cut["plain_batch"] = nb
    entry = timed_entry(max(d_lam, d_v), ms, plain_ms,
                        eigh_kernel.work(name, b, k), lib_ms, **cut)
    entry["issue_floor_share"] = 2 * entry["share_of_bound"]
    print(f"  [{b},{k},{k}] {name} kernel {ms:.4f} ms (median of 5 warm runs,"
          f" CUDA events)  plain {plain_ms:.4f} ms ({plain_how}); bound "
          f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}, share of bound "
          f"{entry['share_of_bound']:.3f}, of the issue floor (twice the "
          f"bound) {entry['issue_floor_share']:.3f}; torch.linalg.eigh float32 "
          f"{lib_ms:.4f} ms (median of {LIBRARY_REPS} warm runs"
          + (")" if lib_b == b else f", BATCH CUT to {lib_b} of {b} to keep "
             f"the yardstick inside {LIBRARY_BUDGET_S:.0f} s: "
             f"{lib_ms * b / lib_b:.1f} ms if it scales with the batch)"))
    return max(d_lam, d_v), entry


def phase_jacobi(dev, rng, stacks):
    """Phase 6: returns {kernel: measured record} at the main paths' shapes
    (the error over all of a kernel's checks), the solver's
    ``A = Y Y^T + inflat I``; K3 also on phase 4's real
    ``[(a_obs stack, inflat)]``, untimed, within ``REAL_REC_TOL``."""
    from cwbnwp_letkf_torch.ops.jacobi_eigh import jacobi_eigh

    out = {}
    for name, shapes in JACOBI_SHAPES.items():
        worst = 0.0
        for b, k in shapes:
            a = normal_matrices(rng, b, k, dev)
            a += (k - 1) / 1.6 * torch.eye(k, device=dev)
            d, entry = compare_jacobi(a, f"[{b},{k},{k}]")
            worst = max(worst, d)
            if (b, k) == shapes[0]:
                out[name] = entry
        if name == "jacobi_parallel":
            eye = torch.eye(K, device=dev)
            for stack, val in stacks:
                a = stack + val * eye
                d, _ = compare_jacobi(
                    a, f"first chunk, inflat {val:.4f}, "
                    f"[{stack.shape[0]},{K},{K}]", timed=False,
                    rec_tol=REAL_REC_TOL)
                worst = max(worst, d)
                print(f"    with 8 sweeps: reconstruction "
                      f"{reconstruction(*jacobi_eigh(a, sweeps=8), a):.3e} "
                      f"max|A|")
        out[name]["max_abs_err"] = worst
    return out


def phase_jacobi_cycle(dev, pts_d, xb_d, truth_d, xa_ns, plats):
    """Phase 7: entry (a); returns (xa, K3 launches)."""
    from cwbnwp_letkf_torch.ops import eigh_kernel, solver

    b = pts_d.shape[0]
    groups = cycle_groups()
    xb_v = xb_d[:, None, :].expand(b, N_VARS, K)
    solver.set_eigh_backend("jacobi")
    try:
        reset_counts()
        t0 = time.time()
        xa, diag, _, _, _ = main_path(xb_v, pts_d, plats, groups, dev)
        torch.cuda.synchronize(dev)
        first_s = time.time() - t0
        counts = read_counts()
        overflow = int(diag["bucket_overflow"])
        print(f"  first run {first_s:.3f} s: overflow {overflow}, ns_residual "
              f"{float(diag['ns_residual']):.3e}")
        check(bool(torch.isfinite(xa).all()), "Jacobi analysis not finite")
        check(overflow == 0, f"bucket overflow {overflow}")
        n_chunks = -(-b // CHUNK)
        check_only(counts, "jacobi_parallel", len(groups) * n_chunks,
                   "Jacobi cycle (one per group and chunk)")
        check_rmse(xa, xb_d, truth_d, ((0, "U"), (3, "T")), "Jacobi cycle")
        check_close(xa, xa_ns, xb_v, "Jacobi cycle vs NS cycle")
        t0 = time.time()
        with timed_launches(eigh_kernel) as events:
            xa_w, _, _, _, cycle_s = main_path(xb_v, pts_d, plats, groups, dev)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        check(torch.equal(xa_w, xa), "Jacobi cycle not deterministic")
        del xa_w
        print(f"  warm run: K3 {launch_seconds(events):.4f} s on the card in "
              f"{len(events)} launches (CUDA events around each)")
        print(f"  warm run: wall {wall:.3f} s (prepare -> plan -> cycle -> "
              f"tune_q), {b * N_VARS / wall:.1f} var-point updates/s; "
              f"update_points_cycle alone {cycle_s:.3f} s, "
              f"{b * N_VARS / cycle_s:.1f} var-point updates/s")
    finally:
        solver.set_eigh_backend("auto")
    return xa, counts["jacobi_parallel"]


def phase_updates(dev, pts_d, xb_d, xa_jac, dplats, nz):
    """Phase 8: entries (b) and (c); returns the K4 launch count, the
    analyses (entry (b)'s, and entry (c)'s by backend) and entry (c)'s
    41-member case ``(q, xb, truth, device platforms, host platforms)``."""
    from cwbnwp_letkf_torch.ops import eigh_kernel, solver, update

    b = pts_d.shape[0]
    n_chunks = -(-b // CHUNK)
    ivars = (0, 1)
    solver.set_eigh_backend("jacobi")
    try:
        budgets = update.plan_max_blocks(pts_d, dplats, ivars[0], chunk=CHUNK)
        reset_counts()
        t0 = time.time()
        xa, diag = update.update_points_group(
            xb_d[:, None, :].expand(b, len(ivars), K), pts_d, dplats, ivars,
            inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
            weight_function=0, rtpp_alpha=(RTPP,) * 2, rtps_alpha=(RTPS,) * 2,
            chunk=CHUNK, max_blocks=budgets, return_diagnostics=True)
        torch.cuda.synchronize(dev)
        print(f"  (b) update_points_group (U, V), k={K}, jacobi: "
              f"{time.time() - t0:.3f} s, budgets "
              f"{ {n: tuple(bb) for n, bb in budgets.items()} }, overflow "
              f"{int(diag['bucket_overflow'])}")
        check_only(read_counts(), "jacobi_parallel", n_chunks,
                   "(b) group update (one per chunk)")
        check(int(diag["bucket_overflow"]) == 0, "(b): bucket overflow")
        check(bool(torch.isfinite(xa).all()), "(b): analysis not finite")
        check_close(xa, xa_jac[:, :2], xb_d[:, None, :],
                    "(b) vs the Jacobi cycle's U, V")
        xa_b = xa
    finally:
        solver.set_eigh_backend("auto")

    pts, truth, xb, plats = bench_case(np.random.default_rng(SEED), nz,
                                       k=K_ODD)
    q = torch.from_numpy(pts).to(dev)
    xb41 = torch.from_numpy(xb).to(dev)
    truth41 = torch.from_numpy(truth).to(dev)
    dplats41 = [update.prepare_platform(st, po, device=dev) for st, po in plats]
    ivar = 3
    budgets = update.plan_max_blocks(q, dplats41, ivar, chunk=CHUNK)
    kw = dict(inflat=(K_ODD - 1) / MULTI_INFL[ivar], weight_function=0,
              use_rtpp=True, rtpp_alpha=RTPP, use_rtps=True, rtps_alpha=RTPS,
              chunk=CHUNK, max_blocks=budgets, return_diagnostics=True)
    out = {}
    for backend, name in (("jacobi", "jacobi_cyclic"), ("auto", "ns_invsqrt")):
        solver.set_eigh_backend(backend)
        try:
            reset_counts()
            t0 = time.time()
            with first_input(eigh_kernel) as stacks:
                xa, diag = update.update_points(xb41, q, dplats41, ivar, **kw)
            torch.cuda.synchronize(dev)
            print(f"  (c) update_points T, k={K_ODD}, {backend}: "
                  f"{time.time() - t0:.3f} s, overflow "
                  f"{int(diag['bucket_overflow'])}, ns_residual "
                  f"{float(diag['ns_residual']):.3e}")
            counts = read_counts()
            check_only(counts, name, n_chunks, f"(c) {backend} (one per chunk)")
            if backend == "jacobi":
                t0 = time.time()
                with timed_launches(eigh_kernel) as events:
                    xa_w, _ = update.update_points(xb41, q, dplats41, ivar, **kw)
                torch.cuda.synchronize(dev)
                wall = time.time() - t0
                check(torch.equal(xa_w, xa), "(c) jacobi: warm run differs")
                del xa_w
                print(f"  (c) warm run: {wall:.3f} s, K4 "
                      f"{launch_seconds(events):.4f} s on the card in "
                      f"{len(events)} launches (CUDA events around each)")
                real = stacks[0][0]
        finally:
            solver.set_eigh_backend("auto")
        check(int(diag["bucket_overflow"]) == 0, f"(c) {backend}: overflow")
        check(bool(torch.isfinite(xa).all()), f"(c) {backend}: not finite")
        rmse_b, rmse_a = rmse(xb41.mean(-1), truth41), rmse(xa.mean(-1), truth41)
        print(f"  (c) {backend}: T mean RMSE background {rmse_b:.4f} -> "
              f"analysis {rmse_a:.4f}")
        check(rmse_a < rmse_b, f"(c) {backend}: analysis RMSE not lower")
        out[backend] = (xa, counts[name])
    check_close(out["jacobi"][0], out["auto"][0], xb41, "(c) K4 vs K1")
    check(tuple(real.shape) == (CHUNK, K_ODD, K_ODD),
          f"(c): first K4 stack {tuple(real.shape)}")
    compare_jacobi(real, f"(c) first chunk, {list(real.shape)}", timed=False,
                   rec_tol=REAL_REC_TOL)
    return (out["jacobi"][1], xa_b, {b: xa for b, (xa, _) in out.items()},
            (q, xb41, truth41, dplats41, plats))


#: phase 9's WRF case: the bench case's 128x128x20 grid at about 10 km
#: (dlat 0.09 degrees) around the projection origin, Milbrandt microphysics
#: (wrf_mp_physics = 9: all 16 production variables exist)
DLAT = 0.09
PROJECTION = {"cen_lon": 120.0, "cen_lat": 23.7, "truelat1": 10.0,
              "truelat2": 40.0, "sta_lon": 120.0}
VAR_UPDATE = ("U", "V", "W", "T", "QVAPOR", "QRAIN", "QSNOW", "QGRAUP",
              "QHAIL", "QNRAIN", "QNSNOW", "QNGRAUPEL", "QNHAIL", "MU", "P",
              "PH")
#: the radar retrievals of PLATFORMS (their error comes from the namelist)
RADAR = ("vr", "dbz")
#: WRF's base-state scalars in phase 9's member files (the values of
#: tests/test_state_io.py's 2-moment members)
BASE_STATE = {"T00": 290.0, "P00": 1e5, "TLP": 50.0, "TISO": 0.0,
              "P_STRAT": 0.0, "TLP_STRAT": -11.0, "P_TOP": 5e3}
#: phase 9's per-variable run against the fused one: the limit is
#: XA_RTOL of the increment, or F32_ULPS float32 spacings of the field's
#: largest value where XA_RTOL of the increment is below one spacing.  That
#: is PH's case: a full field (base state added, ~1e5, spacing 0.0078) with
#: a small increment, which each path rounds a few times at that scale
#: (mean + increment, RTPP, RTPS)
F32_ULPS = 4
#: phase 9's control: the fused run again with K1's Z scaled by
#: 1 + Z_FAULT, a kernel off by 1%; every field's limit must fail it
Z_FAULT = 1e-2


def driver_namelist(k):
    """The production namelist's shape (input.nml:7, 38-55, 160-170) for
    PROD_GROUPS, PLATFORMS, MULTI_INFL and RTPP/RTPS, with the analysis
    mean file asked for (``write_analy_mean``, the default, stated)."""
    def row(vals):
        return ", ".join(f"{v:g}" for v in vals)

    lines = ["&control", f" nmember = {k}",
             " var_update = " + ", ".join(f"'{v}'" for v in VAR_UPDATE),
             " weight_function = 0", " wrf_mp_physics = 9",
             " write_analy_mean = T", "/",
             "&projection"]
    lines += [f" {key} = {val}" for key, val in PROJECTION.items()]
    lines += ["/", "&observations"]
    for name, _, nvar, cap, err in PLATFORMS:
        h, v = [-1.0] * N_VARS, [-1.0] * N_VARS
        for ivars, radii in PROD_GROUPS:
            for iv in ivars:
                if name in radii:
                    h[iv], v[iv] = radii[name]
        nml = f"radar_nml % {name}" if name in RADAR else f"{name}_nml"
        lines += [f" {nml} % use_it = T", f" {nml} % max_lz_pts = {cap}",
                  f" {nml} % hclr = {row(h)}", f" {nml} % vclr = {row(v)}"]
        if name in RADAR:
            lines.append(f" {nml} % error = {err}")
        else:
            lines += [f" {nml} % {var} % is_assim = {N_VARS}*T"
                      for var in ("u", "v", "t", "p", "q")[:nvar]]
    lines += ["/", "&inflation", f" multi_infl = {row(MULTI_INFL)}",
              f" use_rtpp = {N_VARS}*T", f" rtpp_alpha = {N_VARS}*{RTPP}",
              f" use_rtps = {N_VARS}*T", f" rtps_alpha = {N_VARS}*{RTPS}",
              "/", ""]
    return "\n".join(lines)


def write_wrf_case(d, rng, grid, k):
    """``k`` Milbrandt member files ``wrfinput_nc_###`` in ``d`` (the CLI's
    names), written through
    the port's NetcdfWriter from a template that holds the geometry and
    base state.

    Every field is one smooth, spatially correlated member perturbation
    ``dxb`` (obs.synthetic.correlated_ensemble over the projected mass grid,
    the bench case's bumps) on its own offset and scale; T is the bench's
    field itself, near 290.  Returns ``(paths, T's truth [nx, ny], the
    members' T [nx, ny, k], the projected mass-grid x and y [nx, ny])``.
    """
    import concurrent.futures as cf

    from scipy.io import netcdf_file

    from cwbnwp_letkf_torch.config import ProjectionConfig
    from cwbnwp_letkf_torch.io.netcdf import NetcdfReader, NetcdfWriter
    from cwbnwp_letkf_torch.obs.synthetic import correlated_ensemble
    from cwbnwp_letkf_torch.projection import LambertProjection

    nx, ny, nz = grid
    c_lon, c_lat = PROJECTION["cen_lon"], PROJECTION["cen_lat"]
    lons = c_lon + (np.arange(nx) - nx / 2) * DLAT
    lats = c_lat + (np.arange(ny) - ny / 2) * DLAT
    lons_u = c_lon + (np.arange(nx + 1) - 0.5 - nx / 2) * DLAT
    lats_v = c_lat + (np.arange(ny + 1) - 0.5 - ny / 2) * DLAT
    proj = LambertProjection.from_config(ProjectionConfig(**PROJECTION))
    gx, gy = proj.lonlat_to_xy(*np.meshgrid(lons, lats, indexing="ij"))
    pts2 = np.stack([gx.ravel(), gy.ravel(), np.zeros(nx * ny)], 1)
    truth, xb = correlated_ensemble(rng, pts2.astype(np.float32), k,
                                    n_bumps=8, length_m=1.5e5)
    truth = truth.reshape(nx, ny)
    t_xb = xb.reshape(nx, ny, k)
    dxb = t_xb - np.float32(290.0)                        # [nx, ny, k]
    z_w = np.arange(nz + 1) * 500.0                       # w levels, m

    def lev(f2, n):
        return np.repeat(f2[:, :, None], n, axis=2)

    tpl = str(d / "template.nc")
    f = netcdf_file(tpl, "w", version=2)
    f.TITLE = "SYNTHETIC WRF (chip_smoke phase 9)"
    for name, size in (("Time", None), ("west_east", nx),
                       ("west_east_stag", nx + 1), ("south_north", ny),
                       ("south_north_stag", ny + 1), ("bottom_top", nz),
                       ("bottom_top_stag", nz + 1)):
        f.createDimension(name, size)
    d2, d2u, d2v = (("south_north", "west_east"),
                    ("south_north", "west_east_stag"),
                    ("south_north_stag", "west_east"))
    d3, d3w = ("bottom_top",) + d2, ("bottom_top_stag",) + d2
    dims = {"XLONG": d2, "XLAT": d2, "XLONG_U": d2u, "XLAT_U": d2u,
            "XLONG_V": d2v, "XLAT_V": d2v, "HGT": d2, "PSFC": d2, "MU": d2,
            "MUB": d2, "PHB": d3w, "PH": d3w, "W": d3w,
            "U": ("bottom_top",) + d2u, "V": ("bottom_top",) + d2v,
            "T": d3, "PB": d3, "P": d3, "QVAPOR": d3}
    dims.update({name: d3 for name in VAR_UPDATE[5:13]})
    # the base-state scalars and eta levels read_ensemble derives the
    # 2-moment schemes' dry-air density from (grid.f90:369-441), as the CLI
    # reads the members
    dims.update({name: () for name in BASE_STATE},
                ZNW=("bottom_top_stag",), ZNU=("bottom_top",))
    for name, dd in dims.items():
        f.createVariable(name, np.float32, ("Time",) + dd)
    znw = np.linspace(1.0, 0.0, nz + 1)
    fixed = {"HGT": np.zeros((nx, ny)), "MUB": np.full((nx, ny), 9.5e4),
             "PHB": lev(np.ones((nx, ny)), nz + 1) * (9.81 * z_w),
             "PB": lev(np.ones((nx, ny)), nz) * (1e5 - 4e3 * np.arange(nz)),
             "ZNW": znw, "ZNU": 0.5 * (znw[1:] + znw[:-1]), **BASE_STATE}
    for sfx, (xs, ys) in (("", (lons, lats)), ("_U", (lons_u, lats)),
                          ("_V", (lons, lats_v))):
        fixed["XLONG" + sfx], fixed["XLAT" + sfx] = np.meshgrid(
            xs, ys, indexing="ij")
    for name, var in f.variables.items():   # one record for every variable
        var[0] = np.asarray(fixed.get(name, 0.0), np.float32).T
    f.close()

    def member_fields(m):
        dm = dxb[:, :, m]
        out = {
            "T": lev(t_xb[:, :, m], nz),
            "U": lev(np.concatenate([dm, dm[-1:]], 0), nz) + 5.0,
            "V": lev(np.concatenate([dm, dm[:, -1:]], 1), nz) - 3.0,
            "W": lev(0.1 * dm, nz + 1), "PH": lev(2.0 * dm, nz + 1),
            "P": lev(50.0 * dm, nz), "MU": 50.0 * dm,
            "PSFC": 1e5 + 100.0 * dm,
            "QVAPOR": lev(8e-3 + 1e-3 * dm, nz)}
        for name in VAR_UPDATE[5:13]:   # some negative values: clamped on read
            scale = 1e3 if name.startswith("QN") else 1e-4
            out[name] = lev(scale * (1.0 + 0.5 * dm), nz)
        return out

    def write_member(m):
        path = str(d / f"wrfinput_nc_{m + 1:03d}")
        with NetcdfReader(tpl) as src, NetcdfWriter(path) as dst:
            dst.copy_header_from(src)
            for name, arr in member_fields(m).items():
                dst.write_variable(name, arr.astype(np.float32))
            dst.write_others(src)
        return path

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        paths = list(ex.map(write_member, range(k)))
    return paths, truth, t_xb, gx, gy


def driver_obs(rng, truth, t_xb, gx, gy, grid):
    """PLATFORMS' records at uniform lon/lat over the whole domain,
    projected; each observes T's truth at its nearest column with the
    platform's error, and H(xb) is that column's members."""
    from scipy.spatial import cKDTree

    from cwbnwp_letkf_torch.obs.base import make_platform_obs

    nx, ny, nz = grid
    k = t_xb.shape[-1]
    tree = cKDTree(np.stack([gx.ravel(), gy.ravel()], 1))
    lo = np.array([gx.min(), gy.min()])
    hi = np.array([gx.max(), gy.max()])
    obs_data = {}
    for name, nobs, nvar, _, err in PLATFORMS:
        xy = rng.uniform(lo, hi, (nobs, 2))
        alt = rng.uniform(0.0, 0.3 * nz * 500.0, nobs)
        _, gi = tree.query(xy, k=1)
        obs = truth.ravel()[gi][None] + rng.normal(0.0, err, (nvar, nobs))
        hdxb = np.repeat(t_xb.reshape(-1, k)[gi][None], nvar, 0)
        error = None if name in RADAR else np.full((nvar, nobs), err)
        obs_data[name] = make_platform_obs(np.column_stack([xy, alt]), obs,
                                           hdxb, error=error)
    return obs_data


def n_ns_launches(groups, chunk, multi_infl):
    """K1 launches of a fused run: per point set and chunk, one per distinct
    inflation value among its variables."""
    names = list(VAR_UPDATE)
    return sum(-(-g["points"] // chunk)
               * len({multi_infl[names.index(v)] for v in g["variables"]})
               for g in groups)


def field_limit(incr, field):
    """``(limit, spacing)``: phase 9's limit on ``max|dxa|`` of a field
    whose fused increment is ``incr`` (see ``F32_ULPS``), and the float32
    spacing of the field's largest value."""
    ulp = float(np.spacing(np.abs(field).max().astype(np.float32)))
    tol = XA_RTOL * incr
    return (tol if tol >= ulp else F32_ULPS * ulp), ulp


@contextlib.contextmanager
def scaled_z(factor):
    """Under it, every Newton-Schulz solve returns ``factor`` times its Z."""
    from cwbnwp_letkf_torch.ops import solver

    ns_z = solver._ns_z

    def faulty(a_obs, inflat):
        z, resid = ns_z(a_obs, inflat)
        return z * factor, resid

    solver._ns_z = faulty
    try:
        yield
    finally:
        solver._ns_z = ns_z


@contextlib.contextmanager
def pending_at_return(module):
    """Under it, each ``module.update_points_cycle`` call records whether
    the device still had its work queued when the call returned."""
    got = []
    fn = module.update_points_cycle

    def probe(*args, **kwargs):
        out = fn(*args, **kwargs)
        ev = torch.cuda.Event()
        ev.record()
        got.append(not ev.query())
        return out

    module.update_points_cycle = probe
    try:
        yield got
    finally:
        module.update_points_cycle = fn


def phase_driver(dev, smi_line, grid=GRID, k=K, chunk=CHUNK, root=None):
    """Phase 9: ``driver.run_analysis`` on WRF member files; returns the K1
    launches of the fused run, K1's ``max|dZ|`` against its plain version
    on the run's first batch, and the obs.  With ``root`` the files stay
    there (phase 15 reads them again): the inputs, ``input.nml`` and the
    fused analysis as ``wrfout_d01_###``."""
    from cwbnwp_letkf_torch import driver
    from cwbnwp_letkf_torch.config import LetkfConfig
    from cwbnwp_letkf_torch.io.netcdf import NetcdfReader
    from cwbnwp_letkf_torch.metrics import RunMetrics
    from cwbnwp_letkf_torch.models.state import read_ensemble, write_ensemble
    from cwbnwp_letkf_torch.models.variables import VAR_TABLE
    from cwbnwp_letkf_torch.ops import ns_kernel

    keys = [VAR_TABLE[v].field for v in VAR_UPDATE]
    with (contextlib.nullcontext(root) if root is not None else
          tempfile.TemporaryDirectory(prefix="chip_smoke_wrf_")) as tmp:
        d = Path(tmp)
        t0 = time.time()
        rng = np.random.default_rng(SEED + 9)
        paths, truth, t_xb, gx, gy = write_wrf_case(d, rng, grid, k)
        obs_data = driver_obs(rng, truth, t_xb, gx, gy, grid)
        (d / "input.nml").write_text(driver_namelist(k))
        cfg = LetkfConfig.from_namelist(str(d / "input.nml"))
        print(f"  case: {k} member files of {grid[0]}x{grid[1]}x{grid[2]}, "
              f"{len(VAR_UPDATE)} variables, records "
              f"{ {n: po.nrec for n, po in obs_data.items()} }; written in "
              f"{time.time() - t0:.2f} s")

        def read():
            t0 = time.time()
            ens = read_ensemble(paths, cfg, want_rhoa=False)
            return ens, time.time() - t0

        def run(ens, fuse):
            m = RunMetrics()
            t0 = time.time()
            driver.run_analysis(cfg, ens, obs_data, chunk=chunk,
                                fuse_variables=fuse, metrics=m, device=dev)
            torch.cuda.synchronize(dev)
            return m, time.time() - t0

        ens, read_s = read()
        xb_t = ens.fields["t"].copy()
        reset_counts()
        with pending_at_return(driver) as pending, \
                first_input(ns_kernel) as firsts:
            m, wall = run(ens, True)
        counts = read_counts()
        d1 = m.to_dict()
        print(f"  fused run (cold): read {read_s:.3f} s, run_analysis "
              f"{wall:.3f} s, stages {d1['stages_s']}")
        for g in d1["groups"]:
            check(g["bucket_overflow"] == 0,
                  f"{g['variables']}: bucket overflow {g['bucket_overflow']}")
            check(g["ns_residual"] <= NS_TOL,
                  f"{g['variables']}: ns_residual {g['ns_residual']}")
        for key in keys:
            check(bool(np.isfinite(ens.fields[key]).all()),
                  f"fused analysis of {key} not finite")
        expected = n_ns_launches(d1["groups"], chunk, MULTI_INFL)
        check_only(counts, "ns_invsqrt", expected,
                   f"run_analysis fused ({len(d1['groups'])} point sets; "
                   f"per chunk one per inflation value)")
        fused_launches = counts["ns_invsqrt"]
        check(len(firsts) == 1, "run_analysis fused: no K1 batch captured")
        stack, (inflat,) = firsts[0]
        check(tuple(stack.shape[1:]) == (k, k),
              f"run_analysis: first K1 batch {tuple(stack.shape)}")
        err = compare_kernel(stack, inflat, f"run_analysis first chunk "
                             f"{list(stack.shape)}, inflat {inflat:.4f}")
        del stack, firsts
        truth_t = np.repeat(truth[:, :, None], grid[2], 2)
        rmse_b = float(np.sqrt(((xb_t.mean(-1) - truth_t) ** 2).mean()))
        rmse_a = float(np.sqrt(((ens.fields["t"].mean(-1) - truth_t) ** 2)
                               .mean()))
        print(f"  fused run: T mean RMSE background {rmse_b:.4f} -> "
              f"analysis {rmse_a:.4f}")
        check(rmse_a < rmse_b, "run_analysis: T analysis RMSE not lower")
        del xb_t, truth_t

        ens_w, read_s = read()
        torch.cuda.reset_peak_memory_stats(dev)
        with timed_launches(ns_kernel) as events:
            m, wall = run(ens_w, True)
        d2 = m.to_dict()
        for key in keys:
            check(np.array_equal(ens_w.fields[key], ens.fields[key]),
                  f"warm fused run: {key} differs from the first run")
        del ens_w
        print(f"  {smi_line}: warm fused run: read {read_s:.3f} s, "
              f"run_analysis {wall:.3f} s, stages {d2['stages_s']}, "
              f"{d2['var_points_per_s']} var-point updates/s "
              f"(total_var_points {d2['total_var_points']} / update_wall_s "
              f"{d2['update_wall_s']}); K1 {launch_seconds(events):.4f} s "
              f"on the card in {len(events)} launches (CUDA events around "
              f"each); peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        for g, busy in zip(d2["groups"], pending):
            print(f"    {'+'.join(g['variables'])}: {g['points']} points, "
                  f"wall_s {g['wall_s']}, load_s {g['load_s']}, "
                  f"ns_residual {g['ns_residual']}; device work still "
                  f"queued when update_points_cycle returned (cold run): "
                  f"{busy}")

        ens_v, read_s = read()
        incr = {key: float(np.abs(ens.fields[key] - ens_v.fields[key]).max())
                for key in keys}
        reset_counts()
        m, wall = run(ens_v, False)
        counts = read_counts()
        print(f"  per-variable run: read {read_s:.3f} s, run_analysis "
              f"{wall:.3f} s")
        check_only(counts, "ns_invsqrt",
                   sum(len(g["variables"]) * -(-g["points"] // chunk)
                       for g in d1["groups"]),
                   "run_analysis per variable (one per variable and chunk)")
        limits, gaps = {}, []
        for key in keys:
            check(incr[key] > 0, f"fused run did not update {key}")
            diff = float(np.abs(ens_v.fields[key] - ens.fields[key]).max())
            limits[key], ulp = field_limit(incr[key], ens.fields[key])
            gaps.append(f"{key} {diff / incr[key]:.2e} ({diff / ulp:.0f} ulp, "
                        f"{diff / limits[key]:.3f} of the limit)")
            check(diff <= limits[key], f"per-variable vs fused {key}: max|dxa| "
                  f"{diff} > {limits[key]} (increment {incr[key]}, float32 "
                  f"spacing {ulp})")
        print(f"  per-variable vs fused, max|dxa| in units of the increment "
              f"(and of the field's float32 spacing, and of the limit): "
              f"{', '.join(gaps)}")
        del ens_v

        ens_c, read_s = read()
        with scaled_z(1.0 + Z_FAULT):
            m, wall = run(ens_c, True)
        gaps = {key: float(np.abs(ens_c.fields[key] - ens.fields[key]).max())
                / limits[key] for key in keys}
        del ens_c
        print(f"  control, K1's Z scaled by 1 + {Z_FAULT:g} (fused run "
              f"{wall:.3f} s): max|dxa| in units of the limit: "
              + ", ".join(f"{key} {gap:.2f}" for key, gap in gaps.items()))
        for key, gap in gaps.items():
            check(gap > 1.0, f"control: {key}'s limit passes a Z off by "
                  f"{Z_FAULT:g}, so it cannot see such a fault")

        t0 = time.time()
        out = [str(d / f"wrfout_d01_{m + 1:03d}") for m in range(k)]
        write_ensemble(ens, out)
        write_s = time.time() - t0
        base = {"p": ens.pb, "ph": ens.phb, "mu": ens.mub}
        for mi, path in enumerate(out):
            with NetcdfReader(path) as nc:
                for name, key in zip(VAR_UPDATE, keys):
                    want = ens.fields[key][..., mi]
                    if key in base:
                        want = want - base[key]
                    check(np.array_equal(nc.get_variable(name), want),
                          f"{path}: {name} read back differs")
        print(f"  write_ensemble {write_s:.3f} s; {k} files read back equal")
    return fused_launches, err, obs_data


#: phase 10: the StageTimer stages of the CLI, as (name, stamp that opens
#: it, stamp that closes it), in the JAX CLI's text
CLI_STAGES = (("read namelist", "reading namelist", "reading model data"),
              ("read model data", "reading model data", "read obs data"),
              ("read obs data", "read obs data", "get into letkf core"),
              ("letkf core", "get into letkf core", "finish letkf core"),
              ("write", "finish letkf core", "finish all steps"))
#: --stream against eager (tests/test_streaming.py:24-61): P, PH and MU
#: ride on base states, which the eager path round-trips through float32
STREAM_BASE_ATOL = {"MU": 0.05, "P": 0.05, "PH": 0.05}
#: phase 10(b)'s obs_gts: the WRFDA layout of tests/test_obs_gts_alt.py,
#: whose formats the parser reads from the file itself
OBS_GTS_HEADER = """\
TOTAL = {n:5d}  MISS. =-888888.
SYNOP = {n:5d}  METAR =     0  SHIP  =     0  BUOY  =     0  BOGUS =     0  TEMP  =     0
INFO   = PLATFORM, DATE, NAME, LEVELS, LATITUDE, LONGITUDE, ELEVATION, ID.
SRFC   = SLP, PW (DATA,QC,ERROR).
EACH   = PRES, SPEED, DIR, HEIGHT, TEMP, DEW PT, HUMID (DATA,QC,ERROR).
INFO_FMT  = (A12,1X,A19,1X,A40,1X,I6,3(F12.3,11X),6X,A40)
SRFC_FMT  = (F12.3,I4,F7.2,F12.3,I4,F7.3)
EACH_FMT  = (3(F12.3,I4,F7.2),11X,3(F12.3,I4,F7.2))
#------------------------------------------------------------------------------#
"""


def write_obs_gts(path, ids, lat, lon, alt):
    """One single-level FM-12 SYNOP report a station: INFO, SRFC and one
    EACH line whose height is the station's altitude."""
    def triple(v):
        return f"{v:12.3f}{0:4d}{1.0:7.2f}"

    lines = [OBS_GTS_HEADER.format(n=len(ids)).rstrip("\n")]
    for ident, la, lo, h in zip(ids, lat, lon, alt):
        lines.append(f"{'FM-12 SYNOP':<12s} {'2026-08-17_00:00:00':<19s} "
                     f"{'SURFACE SYNOPTIC OBSERVATIONS':<40s} {1:6d}"
                     f"{la:12.3f}{'':11s}{lo:12.3f}{'':11s}{h:12.3f}"
                     f"{'':11s}{'':6s}{ident:<40s}")
        lines.append(f"{1013.2:12.3f}{0:4d}{1.0:7.2f}{0.0:12.3f}{0:4d}"
                     f"{0.2:7.3f}")
        lines.append(triple(1e5) + triple(5.0) + triple(230.0) + " " * 11
                     + triple(h) + triple(290.0) + triple(285.0))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_cli_obs(d, rng, truth, t_xb, gx, gy, grid):
    """PLATFORMS' records at uniform lon/lat over the domain as the CLI's
    input files: ``gts_letkf_###`` (synop, with ``obs_gts``),
    ``VR_letkf_###`` and ``MR_letkf_###``, one a member, written with the
    port's writers.  Each record observes T's truth at the column nearest
    its coordinates as written (lon/lat to 0.01 degree in the GTS files,
    0.0001 in the radar files); H(xb) is that column's members.  Returns
    the number of record lines written."""
    from scipy.spatial import cKDTree

    from cwbnwp_letkf_torch.config import ProjectionConfig
    from cwbnwp_letkf_torch.obs.gts import GtsRecords, write_member_file
    from cwbnwp_letkf_torch.obs.radar import write_radar_file
    from cwbnwp_letkf_torch.projection import LambertProjection

    nx, ny, nz = grid
    k = t_xb.shape[-1]
    c_lon, c_lat = PROJECTION["cen_lon"], PROJECTION["cen_lat"]
    lo = np.array([c_lon - nx / 2 * DLAT, c_lat - ny / 2 * DLAT])
    hi = np.array([c_lon + (nx / 2 - 1) * DLAT, c_lat + (ny / 2 - 1) * DLAT])
    proj = LambertProjection.from_config(ProjectionConfig(**PROJECTION))
    tree = cKDTree(np.stack([gx.ravel(), gy.ravel()], 1))
    t_cols = t_xb.reshape(-1, k)
    n_lines = 0
    for name, nobs, nvar, _, err in PLATFORMS:
        lonlat = np.round(rng.uniform(lo, hi, (nobs, 2)),
                          4 if name in RADAR else 2)
        alt = rng.uniform(0.0, 0.3 * nz * 500.0, nobs)
        x, y = proj.lonlat_to_xy(lonlat[:, 0], lonlat[:, 1])
        _, gi = tree.query(np.stack([x, y], 1), k=1)
        obs = truth.ravel()[gi][None] + rng.normal(0.0, err, (nvar, nobs))
        n_lines += k * nobs
        if name in RADAR:
            prefix = {"vr": "VR", "dbz": "MR"}[name]
            for m in range(k):
                write_radar_file(
                    str(d / f"{prefix}_letkf_{m + 1:03d}"),
                    np.stack([obs[0], t_cols[gi, m], lonlat[:, 0],
                              lonlat[:, 1], alt], 1))
            continue
        ids = [f"S{i:04d}" for i in range(nobs)]
        write_obs_gts(str(d / "obs_gts"), ids, lonlat[:, 1], lonlat[:, 0],
                      alt)
        for m in range(k):
            omb = obs - t_cols[gi, m][None]
            rec = GtsRecords(
                ids=ids, lat=list(lonlat[:, 1]), lon=list(lonlat[:, 0]),
                pre=[1000.0] * nobs, obs=obs.T.tolist(), omb=omb.T.tolist(),
                qc=[[0] * nvar] * nobs, err=[[err] * nvar] * nobs,
                level=[1] * nobs)
            write_member_file(str(d / f"gts_letkf_{m + 1:03d}"),
                              {name: rec})
    return n_lines


def run_cli(*argv):
    """``cli.main(argv)`` with its standard output captured; returns the
    wall seconds (after a device synchronize) and the StageTimer stamps as
    ``{text: seconds}`` (the first of each text)."""
    from cwbnwp_letkf_torch import cli

    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(rc == 0, f"cli.main {argv}: exit code {rc}")
    stamps = {}
    for line in out.getvalue().splitlines():
        if " sec ==========> " in line:
            sec, text = line.split(" sec ==========> ")
            stamps.setdefault(text, float(sec))
    return wall, stamps


def stage_seconds(stamps):
    return {name: round(stamps[b] - stamps[a], 4)
            for name, a, b in CLI_STAGES}


def read_nc(path):
    from cwbnwp_letkf_torch.io.netcdf import NetcdfReader

    with NetcdfReader(str(path)) as nc:
        return {n: nc.get_variable(n) for n in nc.variable_names()
                if n != "Times"}


def out_names(k):
    return [f"wrfout_nc_{m + 1:03d}" for m in range(k)] + ["wrfout_nc_mean"]


def check_stream(stream, eager, k, what):
    """``--stream`` against eager, file for file, with the tolerances of
    tests/test_streaming.py (the mean file's rtol 1e-5)."""
    worst = {}
    for name in out_names(k):
        s, e = read_nc(stream / name), read_nc(eager / name)
        check(set(s) == set(e), f"{what} {name}: variables differ")
        rtol = 1e-5 if name.endswith("mean") else 1e-6
        for v, arr in e.items():
            atol = STREAM_BASE_ATOL.get(v, rtol)
            excess = np.abs(s[v] - arr) - (atol + rtol * np.abs(arr))
            worst[v] = max(worst.get(v, -np.inf), float(excess.max()))
            check(worst[v] <= 0, f"{what} {name} {v}: --stream off eager by "
                  f"{worst[v]} beyond the tolerance")
    return worst


def hold_cli_files(d, k, updated, what):
    """The card's output files (``d / "card"``) against the CPU's
    (``d / "cpu"``) on the inputs in ``d / "in"``: the ``updated`` variables
    within ``XA_RTOL`` of the CPU's increment over the members, every other
    variable equal.  Returns the largest gap of each updated variable in
    units of its increment."""
    incr = {v: 0.0 for v in updated}
    for m in range(k):
        ref = read_nc(d / "cpu" / f"wrfout_nc_{m + 1:03d}")
        prior = read_nc(d / "in" / f"wrfinput_nc_{m + 1:03d}")
        for v in updated:
            incr[v] = max(incr[v], float(np.abs(ref[v] - prior[v]).max()))
    gaps = {v: 0.0 for v in updated}
    for name in out_names(k):
        got, want = read_nc(d / "card" / name), read_nc(d / "cpu" / name)
        check(set(got) == set(want), f"{what} {name}: variables differ")
        for v, arr in want.items():
            if v in updated:
                check(incr[v] > 0, f"{what} case: {v} not updated")
                diff = float(np.abs(got[v] - arr).max())
                gaps[v] = max(gaps[v], diff / incr[v])
                check(diff <= XA_RTOL * incr[v], f"{what} {name} {v}: "
                      f"card vs CPU max|dxa| {diff} > {XA_RTOL} x "
                      f"{incr[v]}")
            else:
                check(np.array_equal(got[v], arr),
                      f"{what} {name} {v}: card differs from CPU")
    return gaps


def phase_cli_synthetic(root):
    """Phase 10(a): the CLI on ``generate_case``'s default case, on the card
    against the CPU, and ``--stream`` against eager on the card."""
    from cwbnwp_letkf_torch.synthetic_case import generate_case, score_case

    d = root / "synthetic"
    case = generate_case(str(d / "in"))
    k, updated = case.k, ("T", "QVAPOR")
    reset_counts()
    wall, _ = run_cli("--input", d / "in", "--output", d / "card", "--quiet")
    counts = read_counts()
    print(f"  synthetic case (k={k}, {case.nx}x{case.ny}x{case.nz}, "
          f"{len(case.obs_lon)} stations): card {wall:.3f} s, kernel "
          f"launches {counts}")
    check(counts["ns_invsqrt"] > 0, "synthetic case: K1 not launched")
    wall_cpu, _ = run_cli("--input", d / "in", "--output", d / "cpu",
                          "--quiet", "--platform", "cpu")
    gaps = hold_cli_files(d, k, updated, "synthetic")
    scores = score_case(case, str(d / "card"))
    print(f"  card vs CPU ({wall_cpu:.3f} s): max|dxa| in units of the "
          f"CPU increment {gaps}; T RMSE prior {scores['rmse_prior']:.4f} "
          f"-> analysis {scores['rmse_analysis']:.4f}")
    check(scores["rmse_analysis"] < 0.7 * scores["rmse_prior"],
          f"synthetic case: RMSE gain below 0.3: {scores}")
    wall_s, _ = run_cli("--input", d / "in", "--output", d / "stream",
                        "--quiet", "--stream")
    worst = check_stream(d / "stream", d / "card", k, "synthetic")
    print(f"  --stream on the card ({wall_s:.3f} s) against eager: largest "
          f"excess over the tolerance {max(worst.values()):.3e}")


def phase_cli(dev, smi_line, root, launches9, grid=GRID, k=K, chunk=CHUNK):
    """Phase 10(b): the CLI on phase 9's case as input files; returns K1's
    launches in the eager run and K1's ``max|dZ|`` against its plain version
    on that run's first batch."""
    from cwbnwp_letkf_torch.io import native
    from cwbnwp_letkf_torch.ops import ns_kernel

    d = root / "bench"
    inp = d / "in"
    inp.mkdir(parents=True)
    t0 = time.time()
    rng = np.random.default_rng(SEED + 9)
    _, truth, t_xb, gx, gy = write_wrf_case(inp, rng, grid, k)
    t_members = time.time() - t0
    (inp / "input.nml").write_text(driver_namelist(k))
    n_lines = write_cli_obs(inp, rng, truth, t_xb, gx, gy, grid)
    print(f"  input: {k} member files of {grid[0]}x{grid[1]}x{grid[2]} in "
          f"{t_members:.2f} s; {n_lines} record lines (synop, vr, dbz) and "
          f"obs_gts in {time.time() - t0 - t_members:.2f} s")

    def eager_run(out, *extra):
        native.reset_parses()
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with timed_launches(ns_kernel) as events, \
                first_input(ns_kernel) as firsts:
            wall, stamps = run_cli("--input", inp, "--output", out,
                                   "--chunk", chunk, "--metrics-json",
                                   str(out) + ".json", *extra)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        metrics = json.loads(Path(str(out) + ".json").read_text())
        check(native.PARSES == {"native": 3 * k, "python": 0},
              f"CLI {extra}: parsers served {native.PARSES}, expected "
              f"{3 * k} native")
        expected = n_ns_launches(metrics["groups"], chunk, MULTI_INFL)
        check(expected == launches9, f"CLI {extra}: point sets give "
              f"{expected} K1 launches, phase 9 {launches9}")
        check_only(counts, "ns_invsqrt", expected, f"CLI {' '.join(extra)}"
                   f" ({len(metrics['groups'])} point sets)")
        for g in metrics["groups"]:
            check(g["bucket_overflow"] == 0,
                  f"{g['variables']}: bucket overflow {g['bucket_overflow']}")
            check(g["ns_residual"] <= NS_TOL,
                  f"{g['variables']}: ns_residual {g['ns_residual']}")
        stages = stage_seconds(stamps)
        print(f"  {smi_line}: CLI {' '.join(extra) or 'eager'}: wall "
              f"{wall:.3f} s, stages {stages}; {n_lines} records parsed in "
              f"{stages['read obs data']} s "
              f"({n_lines / stages['read obs data']:.1f} records/s); "
              f"run_analysis stages {metrics['stages_s']}, "
              f"{metrics['var_points_per_s']} var-point updates/s "
              f"(total_var_points {metrics['total_var_points']} / "
              f"update_wall_s {metrics['update_wall_s']}); K1 "
              f"{launch_seconds(events):.4f} s on the card in {len(events)}"
              f" launches (CUDA events around each); peak device memory "
              f"{peak:.3f} GiB")
        check(len(firsts) == 1, f"CLI {extra}: no K1 batch captured")
        return counts["ns_invsqrt"], firsts[0]

    out, out_s = d / "eager", d / "stream"
    launches, (stack, (inflat,)) = eager_run(out)
    check(tuple(stack.shape[1:]) == (k, k),
          f"CLI: first K1 batch {tuple(stack.shape)}")
    err = compare_kernel(stack, inflat, f"CLI first chunk "
                         f"{list(stack.shape)}, inflat {inflat:.4f}")
    del stack
    eager_run(out_s, "--stream")

    t0 = time.time()
    acc = {}
    for m in range(k):
        got = read_nc(out / f"wrfout_nc_{m + 1:03d}")
        prior = read_nc(inp / f"wrfinput_nc_{m + 1:03d}")
        check(set(got) == set(prior), f"member {m + 1}: variables differ")
        for v, arr in got.items():
            if v in VAR_UPDATE:
                check(bool(np.isfinite(arr).all()),
                      f"member {m + 1} {v}: not finite")
                acc[v] = acc.get(v, 0.0) + arr.astype(np.float64)
            else:
                check(np.array_equal(arr, prior[v]), f"member {m + 1} {v}: "
                      "outside var_update, differs from the prior")
    mean = read_nc(out / "wrfout_nc_mean")
    for v, total in acc.items():
        np.testing.assert_allclose(
            mean[v], total / k, rtol=1e-5, atol=STREAM_BASE_ATOL.get(v, 1e-5),
            err_msg=f"mean file {v} is not the member mean")
    truth_t = truth[:, :, None]
    rmse_b = float(np.sqrt(((t_xb.mean(-1)[:, :, None] - truth_t) ** 2)
                           .mean()))
    rmse_a = float(np.sqrt(((mean["T"] - truth_t) ** 2).mean()))
    print(f"  T mean RMSE background {rmse_b:.4f} -> analysis "
          f"{rmse_a:.4f}; members finite, the rest byte-equal to the prior, "
          f"the mean file the member mean ({time.time() - t0:.2f} s)")
    check(rmse_a < rmse_b, "CLI: T analysis RMSE not lower")
    worst = check_stream(out_s, out, k, "bench")
    print(f"  --stream against eager: largest excess over the tolerance "
          f"{max(worst.values()):.3e}")
    return launches, err


def gather_entry(entry, q, xb, dplats):
    """Entry (b), ``update_points_group`` for (U, V) at k=40, or entry (c),
    ``update_points`` for T at k=41, with ``method="gather"``; returns
    ``(xa, diagnostics)``."""
    from cwbnwp_letkf_torch.ops import update

    if entry == "b":
        return update.update_points_group(
            xb, q, dplats, (0, 1),
            inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in (0, 1)),
            weight_function=0, rtpp_alpha=(RTPP,) * 2, rtps_alpha=(RTPS,) * 2,
            chunk=CHUNK, method="gather", return_diagnostics=True)
    return update.update_points(
        xb, q, dplats, 3, inflat=(K_ODD - 1) / MULTI_INFL[3],
        weight_function=0, use_rtpp=True, rtpp_alpha=RTPP, use_rtps=True,
        rtps_alpha=RTPS, chunk=CHUNK, method="gather",
        return_diagnostics=True)


def cap_binding(q, dplats, ivar):
    """``{platform: points with more in-radius records than its cap}``."""
    from cwbnwp_letkf_torch.constants import GC1999_SQ
    from cwbnwp_letkf_torch.ops.neighbors import normalize_coords

    out = {}
    for dp in dplats:
        st = dp.static
        if not st.active(ivar):
            continue
        on = normalize_coords(dp.xyz, st.hclr[ivar], st.vclr[ivar])
        center = on.mean(0, keepdim=True)
        on = on - center
        qn = normalize_coords(q, st.hclr[ivar], st.vclr[ivar]) - center
        osq = (on * on).sum(-1)
        n = 0
        for c0 in range(0, q.shape[0], CHUNK):
            qc = qn[c0:c0 + CHUNK]
            r2 = (qc * qc).sum(-1, keepdim=True) + osq - 2.0 * (qc @ on.T)
            n += int(((r2 <= GC1999_SQ).sum(1) > st.max_lz_pts).sum())
        out[st.name] = n
    return out


def phase_gather(dev, case40, xa_b, xa_c, case41):
    """Phase 11: entries (b) and (c) with ``method="gather"`` on the full
    grid, under ``"auto"`` (K1) and ``"jacobi"`` (K3 at k=40, K4 at k=41).

    Per run: the launches (one per chunk, that kernel alone), finite, the
    analysis-mean RMSE lower; a warm rerun, timed, equal to the first; the
    card against the same entry on the CPU (the plain versions) on a
    ``GATHER_SUBSET`` subset within ``XA_RTOL`` of the increment; the gap to
    phase 8's ``method="auto"`` analysis (printed: gather keeps the
    ``n_max`` nearest records where the cap binds, dense the records under
    the multisection's threshold); the kernel against its plain version on
    the first real batch the entry gave it.  Returns ``({kernel: {key:
    launches}}, {kernel: max|d| against the plain version})``.
    """
    from cwbnwp_letkf_torch.ops import eigh_kernel, ns_kernel, solver, update

    pts_d, xb_d, truth_d, dplats, plats = case40
    q41, xb41, truth41, dplats41, plats41 = case41
    b = pts_d.shape[0]
    n_chunks = -(-b // CHUNK)
    inputs = {"b": (pts_d, xb_d[:, None, :].expand(b, 2, K), dplats, plats,
                    truth_d, 0),
              "c": (q41, xb41, dplats41, plats41, truth41, 3)}
    refs = {("b", "auto"): xa_b, ("b", "jacobi"): xa_b,
            ("c", "auto"): xa_c["auto"], ("c", "jacobi"): xa_c["jacobi"]}
    for entry, (q, _, dpl, _, _, ivar) in inputs.items():
        print(f"  ({entry}) points whose in-radius records exceed the cap: "
              f"{cap_binding(q, dpl, ivar)} of {b}")
    cpu_plats = {}
    launches, errs = {}, {}
    for entry, backend, name in GATHER_RUNS:
        q, xb, dpl, pl, truth, _ = inputs[entry]
        module = ns_kernel if name == "ns_invsqrt" else eigh_kernel
        label = f"gather ({entry}) {backend}"
        solver.set_eigh_backend(backend)
        try:
            reset_counts()
            t0 = time.time()
            with first_input(module) as firsts:
                xa, diag = gather_entry(entry, q, xb, dpl)
            torch.cuda.synchronize(dev)
            cold_s = time.time() - t0
            counts = read_counts()
            check_only(counts, name, n_chunks, f"{label} (one per chunk)")
            check(bool(torch.isfinite(xa).all()), f"{label}: not finite")
            check(int(diag["bucket_overflow"]) == 0, f"{label}: overflow")
            check(float(diag["ns_residual"]) <= NS_TOL,
                  f"{label}: ns_residual {float(diag['ns_residual'])}")
            col = xa[:, 0] if entry == "b" else xa
            rmse_b, rmse_a = rmse(xb_d.mean(-1) if entry == "b"
                                  else xb.mean(-1), truth), rmse(
                col.mean(-1), truth)
            print(f"  {label}: first run {cold_s:.3f} s; "
                  f"{'U' if entry == 'b' else 'T'} mean RMSE background "
                  f"{rmse_b:.4f} -> analysis {rmse_a:.4f}")
            check(rmse_a < rmse_b, f"{label}: analysis RMSE not lower")
            t0 = time.time()
            with timed_launches(module) as events:
                xa_w, _ = gather_entry(entry, q, xb, dpl)
            torch.cuda.synchronize(dev)
            wall = time.time() - t0
            check(torch.equal(xa_w, xa), f"{label}: warm run differs")
            del xa_w
            print(f"  {label}: warm run {wall:.3f} s, "
                  f"{b * (2 if entry == 'b' else 1) / wall:.1f} var-point "
                  f"updates/s; {name} {launch_seconds(events):.4f} s on the "
                  f"card in {len(events)} launches (CUDA events around each)")
            if entry not in cpu_plats:
                cpu_plats[entry] = [update.prepare_platform(st, po,
                                                            device="cpu")
                                    for st, po in pl]
            n_sub = GATHER_SUBSET[backend]
            rows = torch.arange(0, b, b // n_sub, device=dev)[:n_sub]
            t0 = time.time()
            xa_cpu, _ = gather_entry(entry, q[rows].cpu(), xb[rows].cpu(),
                                     cpu_plats[entry])
            check_close(xa[rows].cpu(), xa_cpu, xb[rows].cpu(),
                        f"{label}: card vs CPU on {n_sub} points "
                        f"({time.time() - t0:.1f} s on the CPU)")
            ref = refs[(entry, backend)]
            gap = float((xa - ref).abs().max())
            incr = float((ref - (xb_d[:, None, :] if entry == "b"
                                 else xb)).abs().max())
            print(f"  {label}: gap to method='auto' (phase 8, "
                  f"{'jacobi' if entry == 'b' else backend}) max|dxa| "
                  f"{gap:.3e} = {gap / incr:.3e} of its increment")
            del xa
            stack, args = firsts[0]
            if module is ns_kernel:
                err = compare_kernel(stack, args[0], f"{label} first chunk "
                                     f"{list(stack.shape)}")
            else:
                err, _ = compare_jacobi(stack, f"{label} first chunk "
                                        f"{list(stack.shape)}", timed=False,
                                        rec_tol=REAL_REC_TOL)
            del stack, firsts
        finally:
            solver.set_eigh_backend("auto")
        key = "launches_gather_group" if entry == "b" else \
            "launches_gather_update"
        launches.setdefault(name, {})[key] = counts[name]
        errs[name] = max(errs.get(name, 0.0), err)
    return launches, errs


def phase_refined(a_obs, g, xb, has, label):
    """Phase 12: ``letkf_solve_group_refined`` on real normal matrices
    ``a_obs [B, k, k]`` (float32), ``g``, ``xb [B, k]`` and ``has``, two
    variables at ``REFINED_INFL``, against the float64 solve within
    ``REFINED_RTOL`` of the analysis scale and ``REFINED_GAIN`` times closer
    to it than the float32 solve; K1 launched once per inflation value; points/s of the three
    solves.  Returns the K1 launches."""
    from cwbnwp_letkf_torch.ops import solver

    b, k = xb.shape
    f64 = torch.float64
    inflats = tuple((k - 1) / r for r in REFINED_INFL)
    kw = dict(rtpp_alpha=(RTPP,) * 2, rtps_alpha=(RTPS,) * 2)
    a64, g64 = a_obs.to(f64), g.to(f64)
    xb64 = xb.to(f64)[:, None, :].expand(b, 2, k).contiguous()
    xb32 = xb64.float()

    def refined():
        return solver.letkf_solve_group_refined(a64, g64, xb64, inflats, has,
                                                return_diagnostics=True, **kw)

    def solve(a, gg, x, dtype):
        return solver.letkf_solve_group_from_normal(a, gg, x, inflats, has,
                                                    solver_dtype=dtype, **kw)

    reset_counts()
    xa_r, diag = refined()
    counts = read_counts()
    check_only(counts, "ns_invsqrt", len(set(inflats)),
               f"{label}: refined solve (one K1 per inflation value)")
    torch.cuda.synchronize()
    t0 = time.time()
    xa_64 = solve(a64, g64, xb64, f64)
    torch.cuda.synchronize()
    f64_s = time.time() - t0
    xa_32 = solve(a_obs, g, xb32, torch.float32)
    scale = float(xa_64.abs().max())
    incr = float((xa_64 - xb64).abs().max())
    err_r = float((xa_r - xa_64).abs().max())
    err_32 = float((xa_32.to(f64) - xa_64).abs().max())
    ms_r = median_ms(refined)
    ms_32 = median_ms(lambda: solve(a_obs, g, xb32, torch.float32))
    print(f"  {label}: [{b},{k},{k}], {int(has.sum())} with obs, NS residual "
          f"{float(diag['ns_residual']):.3e}; max|xa - xa_f64| refined "
          f"{err_r:.3e} = {err_r / scale:.3e} of the analysis scale "
          f"{scale:.3f} (tol {REFINED_RTOL:.0e}; {err_r / incr:.3e} of the "
          f"increment), float32 {err_32:.3e} = {err_32 / scale:.3e}")
    print(f"  {label}: points/s refined {b / ms_r * 1e3:.1f} ({ms_r:.4f} ms, "
          f"median of 5), float32 {b / ms_32 * 1e3:.1f} ({ms_32:.4f} ms), "
          f"float64 {b / f64_s:.1f} ({f64_s * 1e3:.1f} ms, one run)")
    check(err_r <= REFINED_RTOL * scale,
          f"{label}: refined solve off float64 by {err_r}")
    check(err_r <= err_32 / REFINED_GAIN,
          f"{label}: refined solve {err_r} not {REFINED_GAIN}x closer to "
          f"float64 than the float32 solve's {err_32}")
    return counts["ns_invsqrt"]


def prod_case(dev, k=PROD_K):
    """Phase 13's case on the card with ``k`` members (phase 17(b): 128):
    ``(points, xb [B, k], platform)``."""
    from cwbnwp_letkf_torch.config import MAX_VARS
    from cwbnwp_letkf_torch.obs.base import PlatformObs, PlatformStatic
    from cwbnwp_letkf_torch.obs.synthetic import idealized_grid
    from cwbnwp_letkf_torch.ops.bucketed import hilbert3
    from cwbnwp_letkf_torch.ops.neighbors import normalize_coords
    from cwbnwp_letkf_torch.ops.update import prepare_platform

    rng = np.random.default_rng(PROD_SEED)
    pts = idealized_grid(*PROD_GRID, dx_m=PROD_DX_M, dz_m=PROD_DZ_M)
    b, r = pts.shape[0], PROD_RECORDS
    gi = rng.integers(0, b, r)
    oxyz = (pts[gi] + rng.normal(0, 500.0, (r, 3))).astype(np.float32)
    noise = rng.normal(0, 1.0, r).astype(np.float32)
    pts_d = torch.from_numpy(pts).to(dev)
    truth = 290.0 + 5.0 * torch.exp(-(pts_d[:, 0] ** 2 + pts_d[:, 1] ** 2)
                                    / 4e5 ** 2)
    gen = torch.Generator(device=dev).manual_seed(PROD_SEED)
    xb = truth[:, None] - 2.0 + torch.randn((b, k), generator=gen,
                                            device=dev)
    gi_d = torch.from_numpy(gi).to(dev)
    oxyz_d = torch.from_numpy(oxyz).to(dev)
    # presorted in the blocking's metric (one group: its own radii)
    order = torch.argsort(hilbert3(normalize_coords(oxyz_d, *PROD_RADII)),
                          stable=True)
    gi_d = gi_d[order]
    po = PlatformObs(
        xyz=oxyz_d[order],
        obs=(truth[gi_d] + torch.from_numpy(noise).to(dev)[order])[None],
        error=torch.ones((1, r), device=dev),
        qc=torch.zeros((1, r, k), device=dev), hdxb=xb[gi_d][None])
    st = PlatformStatic(
        name="vr", kind="radar", nvar=1, max_lz_pts=PROD_CAP,
        hclr=(PROD_RADII[0],) * MAX_VARS, vclr=(PROD_RADII[1],) * MAX_VARS,
        err_muti=(1.0,), err_rej=(5.0,), is_assim=((True,) * MAX_VARS,))
    return pts_d, xb, prepare_platform(st, po, device=dev)


def prod_slabs(dev, smi_line, k):
    """Phase 13's production case with ``k`` members, ``PROD_RUN_SLABS``
    slabs through ``update_points_cycle`` (K1 at ``[2048, k, k]``, one
    launch a chunk, no library branch): finite, no overflow, converged;
    seconds a slab (the cycle; its plan is printed beside it), the 20-slab
    projection from the first slab and the mean of the others, peak device
    memory; K1 against its plain version on the first real batch, and that
    batch rebuilt by ``accumulate_chunk`` from the first chunk's points.
    Returns the case and what the callers hold it to."""
    from cwbnwp_letkf_torch.ops import cycle, ns_kernel

    t0 = time.time()
    pts_d, xb, dp = prod_case(dev, k)
    torch.cuda.synchronize(dev)
    b = pts_d.shape[0]
    slab = -(-b // PROD_SLABS)
    groups = (cycle.CycleGroup(ivars=(0,), inflats=((k - 1) / 1.1,),
                               rtpp_alpha=(RTPP,), rtps_alpha=(RTPS,)),)
    print(f"  case: {b} points ({'x'.join(map(str, PROD_GRID))} at "
          f"{PROD_DX_M / 1e3:g} km), k={k}, {PROD_RECORDS} vr records "
          f"presorted, cap {PROD_CAP}, {PROD_SLABS} slabs of {slab}; built "
          f"in {time.time() - t0:.2f} s, device memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    runs, plans_s, k1_s, expected, ovf, resid = [], [], 0.0, 0, 0, 0.0
    for si in range(PROD_RUN_SLABS):
        rows = slice(si * slab, (si + 1) * slab)
        n = min(b, (si + 1) * slab) - si * slab
        t0 = time.time()
        budgets = cycle.plan_cycle_budgets(
            pts_d[rows], [dp], groups, chunk=PROD_CHUNK, subchunk=PROD_CHUNK,
            obs_presorted=True)
        torch.cuda.synchronize(dev)
        plans_s.append(time.time() - t0)
        if si == 0:
            blockings = [v for v in dp.cache.values()
                         if isinstance(v, cycle.CycleBlocking)]
            check(blockings and all(not cb.fused_by_mask for cb in blockings),
                  f"k={k}: planning built a table")
        t0 = time.time()
        with first_input(ns_kernel) as firsts, \
                timed_launches(ns_kernel) as events:
            xa, diag = cycle.update_points_cycle(
                xb[rows, None, :], pts_d[rows], [dp], groups,
                weight_function=0, chunk=PROD_CHUNK, subchunk=PROD_CHUNK,
                max_blocks=budgets, obs_presorted=True,
                return_diagnostics=True)
        torch.cuda.synchronize(dev)
        runs.append(time.time() - t0)
        k1_s += launch_seconds(events)
        expected += -(-n // PROD_CHUNK)
        ovf += int(diag["bucket_overflow"])
        resid = max(resid, float(diag["ns_residual"]))
        check(bool(torch.isfinite(xa).all()), f"k={k} slab {si + 1}: not "
                                              f"finite")
        if si == 0:
            xa0, first, budgets0 = xa, firsts[0], budgets
        del xa, firsts
        print(f"  slab {si + 1}: plan {plans_s[-1]:.3f} s (geometry only), "
              f"cycle {runs[-1]:.3f} s, {n / runs[-1]:.1f} var-point "
              f"updates/s")
    counts = read_counts()
    check(ovf == 0, f"k={k} production shape: overflow {ovf}")
    check(resid <= NS_TOL, f"k={k} production shape: ns_residual {resid}")
    check_only(counts, "ns_invsqrt", expected,
               f"k={k} production shape, {PROD_RUN_SLABS} slabs (one per "
               f"chunk)")
    check_no_library(f"k={k} production shape")
    later = sum(runs[1:]) / len(runs[1:])
    print(f"  {smi_line}: k={k}, {PROD_RUN_SLABS} of {PROD_SLABS} slabs run "
          f"(the depth cut); cycle seconds {[round(t, 3) for t in runs]} "
          f"(the first builds the {PROD_RECORDS} x {k * (k + 1)} table); "
          f"{slab / later:.1f} var-point updates/s a slab after the first;"
          f" K1 {k1_s:.4f} s in {counts['ns_invsqrt']} "
          f"launches (CUDA events around each); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; projected"
          f" 20 slabs {runs[0] + (PROD_SLABS - 1) * later:.1f} s (slab 1 and "
          f"19 times the mean of the later slabs)")
    stack, (inflat,) = first
    check(tuple(stack.shape) == (PROD_CHUNK, k, k),
          f"first K1 batch {tuple(stack.shape)}")
    steps = float(ns_kernel.launch(stack, inflat)[1].float().mean())
    print(f"  K1 mean steps on the first batch: {steps:.3f}")
    err = compare_kernel(stack, inflat, f"k={k} production first chunk "
                         f"{list(stack.shape)}, inflat {inflat:.4f}")
    plans = cycle._resolve_plans([dp], groups, max_blocks=budgets0,
                                 obs_presorted=True)
    rows = cycle._cycle_point_perm(pts_d[:slab], plans)[:PROD_CHUNK]
    a, g, cnt, _ = cycle.accumulate_chunk(
        pts_d[rows], plans, groups, k=k, weight_function=0,
        subchunk=PROD_CHUNK)
    del plans
    check(torch.equal(a[0], stack), "the first chunk's normal matrices are "
                                    "not the first K1 batch")
    return types.SimpleNamespace(
        pts_d=pts_d, xb=xb, dp=dp, groups=groups, slab=slab,
        budgets0=budgets0, xa0=xa0, rows=rows, a=a[0], g=g[0],
        has=cnt[0] > 0, launches=counts["ns_invsqrt"], err=err)


def phase_prod(dev, smi_line):
    """Phase 13: the production shape (:func:`prod_slabs` at k=96); phase
    12 on its first chunk; slab 1 again with ``obs_presorted=False``.

    Returns the K1 launches of the slabs run and K1's ``max|dZ|`` against
    its plain version on the first real ``[2048, 96, 96]`` batch, and the
    refined solve's K1 launches."""
    from cwbnwp_letkf_torch.ops import cycle

    run = prod_slabs(dev, smi_line, PROD_K)
    print("phase 12 (k=96): the refined solves on the first production chunk")
    launches12 = phase_refined(run.a, run.g, run.xb[run.rows], run.has,
                               "production first chunk, k=96")

    run.dp.cache.clear()          # one 7.45 GB table at a time
    t0 = time.time()
    rows = slice(0, run.slab)
    budgets_s = cycle.plan_cycle_budgets(
        run.pts_d[rows], [run.dp], run.groups, chunk=PROD_CHUNK,
        subchunk=PROD_CHUNK, obs_presorted=False)
    check(budgets_s == run.budgets0,
          f"sorted budgets {budgets_s} != {run.budgets0}")
    xa_s = cycle.update_points_cycle(
        run.xb[rows, None, :], run.pts_d[rows], [run.dp], run.groups,
        weight_function=0, chunk=PROD_CHUNK, subchunk=PROD_CHUNK,
        max_blocks=budgets_s, obs_presorted=False)
    torch.cuda.synchronize(dev)
    check(torch.equal(xa_s, run.xa0), "slab 1: obs_presorted=False differs "
                                      "from the presorted run")
    print(f"  slab 1 with obs_presorted=False (sorts the records, builds "
          f"its own table): {time.time() - t0:.3f} s, equal bit for bit")
    run.dp.cache.clear()
    return run.launches, run.err, launches12


def phase_breakdown(dev, pts_d, xb_d, dplats, root):
    """Phase 14: the eigen factors under ``"auto"`` on a seeded
    ``[4096, 40, 40]`` batch (K3 once, no library call; timed beside
    ``torch.linalg.eigh`` on the same matrices, the call they took before
    K3 did under ``"auto"``), then ``profiling.device_breakdown`` on the
    bench case, whose ``eigh`` stage they are, and the CLI's
    ``--device-breakdown``; returns the K3 launches of the breakdown."""
    from cwbnwp_letkf_torch import profiling
    from cwbnwp_letkf_torch.ops import solver
    from cwbnwp_letkf_torch.synthetic_case import generate_case

    rng = np.random.default_rng(SEED + 14)
    a = normal_matrices(rng, CHUNK, K, dev)
    g = torch.from_numpy(rng.standard_normal((CHUNK, K)).astype(np.float32)
                         ).to(dev)
    inflat = (K - 1) / MULTI_INFL[0]
    reset_counts()
    lam, v, _ = solver.letkf_weight_factors_from_normal(a, g, inflat)
    check_only(read_counts(), "jacobi_parallel", 1,
               f"letkf_weight_factors_from_normal, [{CHUNK},{K},{K}], auto")
    a_full = a + inflat * torch.eye(K, device=dev)
    rec = reconstruction(lam, v, a_full)
    ms = median_ms(lambda: solver.letkf_weight_factors_from_normal(
        a, g, inflat))
    lib_ms, lib_b = library_eigh_ms(a_full)
    print(f"  eigen factors under 'auto': {ms:.4f} ms (K3 and the polish, "
          f"median of 5), reconstruction {rec:.3e} max|A|; "
          f"torch.linalg.eigh on the same matrices {lib_ms:.4f} ms at batch "
          f"{lib_b} of {CHUNK} ({lib_ms * CHUNK / lib_b:.1f} ms if it scales)")
    check(rec <= REAL_REC_TOL, f"eigen factors: reconstruction {rec}")
    del a, g, a_full, lam, v

    reps = 3
    stages = ("localize_accumulate", "eigh", "weight_apply")
    reset_counts()
    out = profiling.device_breakdown(xb_d, pts_d, dplats, 0,
                                     weight_function=0,
                                     inflat=(K - 1) / MULTI_INFL[0],
                                     sample=CHUNK, reps=reps)
    counts = read_counts()
    check_only(counts, "jacobi_parallel", reps + 1,
               "device_breakdown (K3 in the eigh stage: a warm call and "
               f"{reps} timed)")
    print(f"  device_breakdown, bench case, {out['points']} points: "
          + ", ".join(f"{s} {out[s + '_s'] * 1e3:.3f} ms "
                      f"({out[s + '_frac']:.3f})" for s in stages)
          + f"; total {out['total_s'] * 1e3:.3f} ms")
    check(out["points"] == CHUNK, f"breakdown points {out['points']}")
    check(all(out[s + "_s"] > 0 for s in stages), "a stage took no time")
    check(abs(sum(out[s + "_s"] for s in stages) - out["total_s"]) <= 1e-12
          and abs(sum(out[s + "_frac"] for s in stages) - 1.0) <= 1e-9,
          "stages not additive")
    d = root / "breakdown"
    generate_case(str(d / "in"))
    reset_counts()
    run_cli("--input", d / "in", "--output", d / "out", "--quiet",
            "--device-breakdown", "--metrics-json", d / "m.json")
    cli_counts = read_counts()
    bd = json.loads((d / "m.json").read_text()).get("device_breakdown")
    print(f"  cli.main --device-breakdown (generate_case): kernel launches "
          f"{cli_counts}; device_breakdown {bd}")
    check(bd is not None and set(bd) == set(out),
          f"--metrics-json device_breakdown: {bd}")
    check(cli_counts["jacobi_parallel"] == reps + 1,
          f"CLI breakdown: K3 launches {cli_counts}")
    return counts["jacobi_parallel"]


def phase_drives(dev, smi_line, case, cycle3_s, root):
    """Phase 16: the drives of ``cwbnwp_letkf_torch/examples/``; returns
    K1's launches by drive and its error against the plain version on the
    first batch of ``profile_cycle``'s NS stage."""
    from cwbnwp_letkf_torch.examples import (gpu_cli_drive, gpu_drive,
                                             memory_bench, profile_cycle,
                                             profile_groups,
                                             run_synthetic_cycle)
    from cwbnwp_letkf_torch.ops import cycle, dense, ns_kernel

    pts_d, xb_d, dplats, groups, budgets = case
    n_runs = 2 * -(-pts_d.shape[0] // CHUNK)      # K1 launches a cycle run
    launches = {}

    def only_k1(counts, what, expected=None):
        print(f"  {what}: kernel launches {counts}")
        check(counts["ns_invsqrt"] > 0, f"{what}: K1 was not launched")
        if expected is not None:
            check(counts["ns_invsqrt"] == expected,
                  f"{what}: {counts['ns_invsqrt']} K1 launches, expected "
                  f"{expected}")
        check(all(n == 0 for key, n in counts.items() if key != "ns_invsqrt"),
              f"{what}: other kernels launched: {counts}")
        return counts["ns_invsqrt"]

    t0 = time.time()
    terms = dense.terms_from_r2
    reset_counts()
    rec = profile_cycle.profile(xb_d, pts_d, dplats, groups, budgets=budgets,
                                reps=PROFILE_REPS)
    counts = read_counts()
    check(cycle.terms_from_r2 is terms and dense.terms_from_r2 is terms,
          "profile_cycle left terms_from_r2 swapped")
    for name, n in rec["k1_launches"].items():
        want = n_runs if name in ("full_cycle", "solve_only", "ns_only") else 0
        check(n == want, f"profile_cycle {name}: {n} K1 launches a run, "
                         f"expected {want}")
    launches["profile_cycle"] = only_k1(counts, "(a) profile_cycle",
                                        3 * n_runs * (1 + PROFILE_REPS))
    full = rec["full_cycle_s"]
    print(f"  (a) profile_cycle on {rec['device']}: {rec['points']} points, "
          f"{rec['n_vars']} variables, k={rec['k']}, best of {PROFILE_REPS} "
          f"after a warm run (phase 3's warm cycle {cycle3_s:.3f} s)")
    for name in profile_cycle.STAGES:
        sec = rec[name + "_s"]
        print(f"    {name:<12s} {sec:9.4f} s  {sec / full:7.1%} of full_cycle"
              f"  K1 {rec['k1_launches'][name]} a run")
    for name, sec in rec["derived"].items():
        print(f"    derived {name:<20s} {sec:9.4f} s  {sec / full:7.1%}")
    print("  " + json.dumps(rec))
    stages = profile_cycle.make_stages(xb_d, pts_d, dplats, groups,
                                       budgets=budgets)
    with first_input(ns_kernel) as got:
        stages["ns_only"]()
    batch, args = got[0]
    err = compare_kernel(batch, args[0], f"profile_cycle ns_only first batch "
                                         f"{list(batch.shape)}")
    print(f"  (a) in {time.time() - t0:.1f} s")

    t0 = time.time()
    reset_counts()
    rec = profile_groups.profile(xb_d, pts_d, dplats)
    n_chunks = -(-pts_d.shape[0] // profile_groups.CHUNK)
    launches["profile_groups"] = only_k1(read_counts(), "(b) profile_groups",
                                         4 * n_chunks)
    check(rec["solve_equals_full"], "profile_groups: the solve from the "
                                    "accumulated terms is not the full update")
    print(f"  (b) {json.dumps(rec)}  ({time.time() - t0:.1f} s)")

    t0 = time.time()
    reset_counts()
    report, _ = gpu_drive.main(dev)
    launches["gpu_drive"] = only_k1(read_counts(), "(c) gpu_drive",
                                    report["k1_launches"])
    print(f"  (c) {json.dumps(report)}  ({time.time() - t0:.1f} s)")

    t0 = time.time()
    reset_counts()
    metrics = gpu_cli_drive.main()
    launches["gpu_cli_drive"] = only_k1(read_counts(), "(d) gpu_cli_drive")
    print(f"  (d) {json.dumps(metrics)}  ({time.time() - t0:.1f} s)")

    t0 = time.time()
    reset_counts()
    scores = run_synthetic_cycle.main(str(root / "synthetic_cycle"))
    launches["run_synthetic_cycle"] = only_k1(read_counts(),
                                              "(e) run_synthetic_cycle")
    print(f"  (e) {json.dumps(scores)}  ({time.time() - t0:.1f} s)")

    # the harness in a process of its own, as a user runs it: a child's
    # ru_maxrss starts from its parent's resident size, which here would be
    # this script's
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", memory_bench.__name__],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True)
    check(out.returncode == 0,
          f"memory_bench exited {out.returncode}:\n{out.stderr[-4000:]}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for run in result["runs"]:
        check(run["k1_launches"] > 0 and run["device"] == smi_line,
              f"memory_bench {run['mode']}: not on the card: {run}")
    launches["memory_bench"] = sum(r["k1_launches"] for r in result["runs"])
    print(f"  (f) {json.dumps(result)}  ({time.time() - t0:.1f} s)")
    return launches, err


def check_large_k3(library):
    """Phase 1: K3 above k = 96 keeps V on chip, in registers, at every even
    k it takes, and no instance spills or keeps an array in local memory
    (the compiler's report of ``library``); prints the launch at the large
    shapes: threads, shared memory, registers, spills, matrices a block and
    an SM, and where V lives."""
    from cwbnwp_letkf_torch.ops import cuda_build, eigh_kernel

    big = {int(re.search(r"big_kernelILi(\d+)E", entry).group(1)): res
           for entry, res in cuda_build.resources(library).items()
           if "jacobi_parallel_big_kernel" in entry}
    check(sorted(big) == sorted({(k + 3) // 4 for k in range(98, 177, 2)}),
          f"K3 above 96: instances {sorted(big)}")
    for pairs, res in sorted(big.items()):
        check(res["spill_stores"] == res["spill_loads"] == res["stack"] == 0,
              f"K3 above 96, P={pairs}: local memory {res}")
    for k in range(98, eigh_kernel.MAX_K, 2):
        cfg = eigh_kernel.config(k)
        check(cfg["v_in_device_memory"] == 0 and cfg["v_in_registers"] == 1,
              f"K3 at k={k}: V not in registers: {cfg}")
    for _, k in LARGE_JACOBI_SHAPES["jacobi_parallel"]:
        cfg, res = eigh_kernel.config(k), big[(k + 3) // 4]
        print(f"  K3 at k={k}: {cfg['threads']} threads, "
              f"{cfg['smem_bytes']} bytes of shared memory, "
              f"{res['registers']} registers, spills {res['spill_stores']} / "
              f"{res['spill_loads']} bytes, stack {res['stack']} bytes; "
              f"{cfg['matrices']} matrix a block, {cfg['matrices_per_sm']} an "
              f"SM; V in registers")
    print(f"  K3 above 96: V in registers and no local memory at every even "
          f"k of 98-176 ({len(big)} instances)")


def check_large_k4(library):
    """Phase 1: K4 above k = 96 runs the chain (one instance a slot count,
    ``ceil(k / lanes)``) and the V pass from the rotation log, and no
    instance of either,
    nor the chain-floor kernel, spills or keeps an array in local memory
    (the compiler's report of ``library``); V comes from the log at every
    odd k of 97-177; prints the launch at the large shapes: threads, shared
    memory, registers, spills, matrices a block and an SM, and where V
    lives."""
    from cwbnwp_letkf_torch.ops import cuda_build, eigh_kernel

    res = cuda_build.resources(library)
    chain = {int(re.search(r"chain_kernelILi(\d+)ELb0E", entry).group(1)): r
             for entry, r in res.items()
             if re.search(r"jacobi_cyclic_chain_kernelILi\d+ELb0E", entry)}
    other = {name: r for name in ("jacobi_cyclic_v_kernel",
                                  "jacobi_chain_floor_kernel")
             for entry, r in res.items() if name in entry}
    lanes = eigh_kernel.config(97)["threads"]
    check(sorted(chain) == sorted({-(-k // lanes) for k in range(97, 178, 2)}),
          f"K4 above 96: chain instances {sorted(chain)} at {lanes} lanes")
    check(sorted(other) == ["jacobi_chain_floor_kernel", "jacobi_cyclic_v_kernel"],
          f"K4 above 96: V pass or chain floor missing: {sorted(other)}")
    for name, r in [(f"chain S={s}", r) for s, r in sorted(chain.items())] + \
            sorted(other.items()):
        check(r["spill_stores"] == r["spill_loads"] == r["stack"] == 0,
              f"K4 above 96, {name}: local memory {r}")
    for k in range(97, eigh_kernel.MAX_K + 1, 2):
        cfg = eigh_kernel.config(k)
        check(cfg["v_from_log"] == 1 and cfg["v_in_device_memory"] == 0,
              f"K4 at k={k}: V not from the log: {cfg}")
    vres = other["jacobi_cyclic_v_kernel"]
    for _, k in LARGE_JACOBI_SHAPES["jacobi_cyclic"]:
        cfg, r = eigh_kernel.config(k), chain[-(-k // lanes)]
        print(f"  K4 at k={k}: the chain {cfg['threads']} threads, "
              f"{cfg['smem_bytes']} bytes of shared memory (A alone), "
              f"{r['registers']} registers, spills {r['spill_stores']} / "
              f"{r['spill_loads']} bytes, stack {r['stack']} bytes; "
              f"{cfg['matrices']} matrix a block, {cfg['matrices_per_sm']} an SM; "
              f"V from the log by the V pass: {(k + 31) // 32} blocks of 32 "
              f"threads a matrix, {4 * ((64 + 33 * k + 3) // 4 * 4)} bytes of shared memory, "
              f"{vres['registers']} registers, spills {vres['spill_stores']} / "
              f"{vres['spill_loads']} bytes; the log "
              f"{eigh_kernel.log_bytes(k)} bytes a matrix in device memory")
    print(f"  K4 above 96: V from the log and no local memory at every odd k "
          f"of 97-177 ({len(chain)} chain instances, the V pass, the chain "
          f"floor)")


def phase_large_kernels(dev):
    """Phase 17(a): every kernel against its plain version at the large
    shapes; returns ``{kernel: [measured record, ...]}``, one a shape.  K1
    and K2 by phase 2's rule (their plain ``ns_invsqrt`` is the card's
    ``torch.matmul`` branch above k = 128, the path K1 would give way to);
    K3 and K4 bit for bit, with ``LARGE_REC_TOL``, each plain version timed
    on its one comparison run (K4's on ``LARGE_PLAIN_BATCH`` matrices); K4
    with its chain floor (``layout_ab.chain_floor``) beside its bound."""
    from cwbnwp_letkf_torch.examples import layout_ab

    out = {}
    for packing, name in (("trio", "ns_invsqrt"), ("rmul", "ns_invsqrt_rmul")):
        entry = phase_kernel(dev, np.random.default_rng(SEED + 17),
                             packing=packing, shapes=LARGE_NS_SHAPES)
        b, k = LARGE_NS_SHAPES[0]
        entry.update(shape=[b, k, k], matmul_branch_ms=entry["plain_ms"])
        if packing == "trio":
            print(f"  the card's torch.matmul branch (solver.ns_route "
                  f"'matmul', K1's plain version) at [{b},{k},{k}]: "
                  f"{entry['plain_ms']:.4f} ms against K1's {entry['ms']:.4f}"
                  f" ms")
        out[name] = [entry]
    rng = np.random.default_rng(SEED + 18)
    for name, shapes in LARGE_JACOBI_SHAPES.items():
        out[name] = []
        for b, k in shapes:
            a = normal_matrices(rng, b, k, dev)
            a += (k - 1) / 1.6 * torch.eye(k, device=dev)
            _, entry = compare_jacobi(
                a, f"[{b},{k},{k}]", rec_tol=LARGE_REC_TOL,
                lam_atol=LARGE_LAM_ATOL,
                plain_batch=LARGE_PLAIN_BATCH if name == "jacobi_cyclic"
                else b)
            entry["shape"] = [b, k, k]
            if name == "jacobi_cyclic":
                floor = layout_ab.chain_floor(a)
                entry["chain_floor_ms"] = floor["chain_floor_ms"]
                entry["chain_link_ns"] = floor["link_ns"]
                print(f"  [{b},{k},{k}] K4's chain floor {floor['chain_floor_ms']:.4f}"
                      f" ms ({floor['link_ns']:.2f} ns a link, one warp alone, "
                      f"median of 5; {floor['matrices_per_sm']} matrices an SM, "
                      f"{floor['waves']} wave(s)) beside its bound "
                      f"{entry['bound_ms']:.4f} ms and issue floor "
                      f"{2 * entry['bound_ms']:.4f} ms: kernel "
                      f"{entry['ms']:.4f} ms, {floor['chain_floor_ms'] / entry['ms']:.3f}"
                      f" of the chain floor")
            out[name].append(entry)
    return out


def phase_large_prod(dev, smi_line):
    """Phase 17(b): :func:`prod_slabs` at ``LARGE_K`` members (K1 at
    ``[2048, 128, 128]``); slab 1's analysis at the first chunk's points
    against a float64 solve of the same terms within ``XA_RTOL`` of its
    increment.  Returns K1's launches and its ``max|dZ|``."""
    from cwbnwp_letkf_torch.ops import solver

    run = prod_slabs(dev, smi_line, LARGE_K)
    xb_r = run.xb[run.rows][:, None, :]
    grp = run.groups[0]
    ref = solver.letkf_solve_group_from_normal(
        run.a, run.g, xb_r, grp.inflats, run.has, rtpp_alpha=grp.rtpp_alpha,
        rtps_alpha=grp.rtps_alpha, solver_dtype=torch.float64)
    check_close(run.xa0[run.rows].double(), ref, xb_r.double(),
                f"k={LARGE_K} slab 1, first chunk ({int(run.has.sum())} of "
                f"{PROD_CHUNK} points with obs) against the float64 solve")
    run.dp.cache.clear()
    return run.launches, run.err


def phase_large_cli(dev, root):
    """Phase 17(c): the command at ``nmember = LARGE_K``: phase 10(a)'s case
    builder (``generate_case``) with ``LARGE_K`` members on
    ``LARGE_CLI_GRID``, the CLI on the card with ``--device-breakdown`` (K1
    in the update, K3 at k = 128 in the breakdown's eigh stage) against the
    CLI on the CPU, file by file at phase 10(a)'s tolerance.  Returns the
    card run's kernel launches."""
    from cwbnwp_letkf_torch.synthetic_case import generate_case, score_case

    d = root / "large_cli"
    case = generate_case(str(d / "in"), k=LARGE_K, **LARGE_CLI_GRID)
    reset_counts()
    wall, _ = run_cli("--input", d / "in", "--output", d / "card", "--quiet",
                      "--device-breakdown", "--metrics-json", d / "m.json")
    counts = read_counts()
    bd = json.loads((d / "m.json").read_text()).get("device_breakdown")
    print(f"  generate_case k={case.k}, {case.nx}x{case.ny}x{case.nz}, "
          f"{len(case.obs_lon)} stations: CLI on the card {wall:.3f} s, kernel "
          f"launches {counts}; device_breakdown {bd}")
    check(counts["ns_invsqrt"] > 0, "k=128 CLI: K1 not launched")
    check(counts["jacobi_parallel"] > 0, "k=128 CLI: K3 not launched in the "
                                         "breakdown")
    check(counts["ns_invsqrt_rmul"] == 0 and counts["jacobi_cyclic"] == 0,
          f"k=128 CLI: other kernels launched: {counts}")
    check_no_library("k=128 CLI")
    check(bd is not None, "k=128 CLI: no device_breakdown in the metrics")
    wall_cpu, _ = run_cli("--input", d / "in", "--output", d / "cpu",
                          "--quiet", "--platform", "cpu")
    gaps = hold_cli_files(d, LARGE_K, ("T", "QVAPOR"), "k=128 CLI")
    scores = score_case(case, str(d / "card"))
    print(f"  card vs CPU ({wall_cpu:.3f} s): max|dxa| in units of the CPU "
          f"increment {gaps}; T RMSE prior {scores['rmse_prior']:.4f} -> "
          f"analysis {scores['rmse_analysis']:.4f}")
    return counts


def phase_large_cli_k4(root):
    """Phase 17(e): K4 above k = 96 on a real path: phase 10(a)'s case
    builder (``generate_case``) with ``LARGE_K4_CLI`` members on
    ``LARGE_CLI_GRID``, the CLI on the card with ``--device-breakdown``,
    whose eigh stage (``"auto"``'s eigen factors) launches K4 at k = 129
    (the Newton-Schulz solves take the ``torch.matmul`` branch above K1's
    range, counted; no ``torch.linalg.eigh``).  Card only: the analysis
    mean's T finite and its RMSE below the prior's.  Returns K4's launches
    and the eigh stage's ms."""
    from cwbnwp_letkf_torch.synthetic_case import generate_case, score_case

    d = root / "large_cli_k4"
    k = LARGE_K4_CLI
    case = generate_case(str(d / "in"), k=k, **LARGE_CLI_GRID)
    reset_counts()
    wall, _ = run_cli("--input", d / "in", "--output", d / "card", "--quiet",
                      "--device-breakdown", "--metrics-json", d / "m.json")
    counts = read_counts()
    lib = read_library()
    bd = json.loads((d / "m.json").read_text()).get("device_breakdown")
    check(bd is not None, f"k={k} CLI: no device_breakdown in the metrics")
    eigh_ms = 1e3 * bd["eigh_s"]
    print(f"  generate_case k={case.k}, {case.nx}x{case.ny}x{case.nz}, "
          f"{len(case.obs_lon)} stations: CLI on the card {wall:.3f} s, kernel "
          f"launches {counts}, library solves {lib}; device_breakdown {bd}")
    print(f"  k={k} CLI: the breakdown's eigh stage {eigh_ms:.4f} ms (best of "
          f"its runs) over {bd['points']} points, {counts['jacobi_cyclic']} K4 "
          f"launches")
    check(counts["jacobi_cyclic"] > 0, f"k={k} CLI: K4 not launched in the "
                                       f"breakdown")
    check(counts["ns_invsqrt"] == counts["ns_invsqrt_rmul"] ==
          counts["jacobi_parallel"] == 0,
          f"k={k} CLI: other kernels launched: {counts}")
    check(lib["ns_matmul"] > 0 and lib["linalg_eigh"] == 0,
          f"k={k} CLI: library solves {lib}")
    scores = score_case(case, str(d / "card"))
    print(f"  k={k} CLI: T RMSE prior {scores['rmse_prior']:.4f} -> analysis "
          f"{scores['rmse_analysis']:.4f}")
    check(np.isfinite(scores["rmse_analysis"]) and
          scores["rmse_analysis"] < scores["rmse_prior"],
          f"k={k} CLI: T RMSE {scores}")
    return counts["jacobi_cyclic"], eigh_ms


def phase_above(dev):
    """Phase 17(d): the branches above the kernels on a real normal-matrix
    batch, the bench case (its grid's lowest ``ABOVE_NZ`` levels) with ``k``
    members, the first ``ABOVE_POINTS`` points of its first chunk, for each
    ``(k, backend)`` of ``ABOVE``: ``letkf_solve_cycle_from_normal`` over
    the groups ``ABOVE_GROUPS``, no kernel launched, the ``torch.matmul``
    branch (``"auto"``: one solve a distinct inflation value) or
    ``torch.linalg.eigh`` (``"jacobi"``: one a group) counted in
    ``solver.LIBRARY_SOLVES``, the analysis within ``XA_RTOL`` of a float64
    solve's increment.  Returns the gaps."""
    from cwbnwp_letkf_torch.ops import cycle, solver, update

    gaps = {}
    for k, backend in ABOVE:
        t0 = time.time()
        pts, _, xb, plats = bench_case(np.random.default_rng(SEED + 19),
                                       ABOVE_NZ, k=k)
        pts_d = torch.from_numpy(pts).to(dev)
        xb_d = torch.from_numpy(xb).to(dev)
        dplats = [update.prepare_platform(st, po, device=dev)
                  for st, po in plats]
        groups = [cycle.CycleGroup(
            ivars=tuple(ivars),
            inflats=tuple((k - 1) / MULTI_INFL[iv] for iv in ivars),
            rtpp_alpha=(RTPP,) * len(ivars), rtps_alpha=(RTPS,) * len(ivars))
            for ivars, _ in (PROD_GROUPS[gi] for gi in ABOVE_GROUPS)]
        budgets = cycle.plan_cycle_budgets(pts_d, dplats, groups, chunk=CHUNK,
                                           subchunk=SUBCHUNK)
        plans = cycle._resolve_plans(dplats, groups, max_blocks=budgets)
        rows = cycle._cycle_point_perm(pts_d, plans)[:ABOVE_POINTS]
        a, g, cnt, ovf = cycle.accumulate_chunk(
            pts_d[rows], plans, groups, k=k, weight_function=0,
            subchunk=SUBCHUNK)
        del plans, dplats
        check(int(ovf) == 0, f"k={k}: overflow in the first chunk")
        n = rows.shape[0]
        xb_gs = [xb_d[rows][:, None, :].expand(n, len(grp.ivars), k)
                 for grp in groups]
        args = ([a[gi] for gi in range(len(groups))],
                [g[gi] for gi in range(len(groups))], xb_gs,
                [grp.inflats for grp in groups],
                [cnt[gi] > 0 for gi in range(len(groups))])
        kw = dict(rtpp_alpha_groups=[grp.rtpp_alpha for grp in groups],
                  rtps_alpha_groups=[grp.rtps_alpha for grp in groups])
        solver.set_eigh_backend(backend)
        try:
            routes = (solver.ns_route(k, dev),
                      solver.eigh_route(k, dev, torch.float32))
            reset_counts()
            outs, diag = solver.letkf_solve_cycle_from_normal(
                *args, return_diagnostics=True, **kw)
            counts = read_counts()
            lib = read_library()
        finally:
            solver.set_eigh_backend("auto")
        if backend == "auto":
            want = {"ns_matmul": len({v for grp in groups
                                      for v in grp.inflats}),
                    "linalg_eigh": 0}
        else:
            want = {"ns_matmul": 0, "linalg_eigh": len(groups)}
        print(f"  k={k}, '{backend}': routes (ns, eigh) {routes}, "
              f"{n} points of the bench grid, kernel launches {counts}, "
              f"library solves {lib} (built and accumulated in "
              f"{time.time() - t0:.2f} s)")
        check(all(n == 0 for n in counts.values()),
              f"k={k}: kernels launched above their range: {counts}")
        check(lib == want, f"k={k}, {backend}: library solves {lib}, "
                           f"expected {want}")
        check(float(diag["ns_residual"]) <= NS_TOL,
              f"k={k}: ns_residual {float(diag['ns_residual'])}")
        refs = solver.letkf_solve_cycle_from_normal(
            *args, solver_dtype=torch.float64, **kw)
        got = torch.cat([o.reshape(n, -1) for o in outs], 1).double()
        ref = torch.cat([r.reshape(n, -1) for r in refs], 1)
        xb_all = torch.cat([x.reshape(n, -1) for x in xb_gs], 1).double()
        gaps[k] = check_close(got, ref, xb_all, f"k={k}, '{backend}', "
                              f"{len(groups)} groups against the float64 "
                              f"solve")
        del a, g, cnt, outs, refs, got, ref, xb_all, xb_gs, args
    return gaps


def phase_large(dev, smi_line, root):
    """Phase 17: large ensembles, (a)-(d); returns ``{kernel: keys}`` for the
    kernel record: each kernel's large-shape measurements, the largest
    error against its plain version there, and its launches on the k = 128
    paths."""
    t_all = time.time()
    t0 = time.time()
    timed = phase_large_kernels(dev)
    print(f"  (a) in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches_prod, err_prod = phase_large_prod(dev, smi_line)
    print(f"  (b) in {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_counts = phase_large_cli(dev, root)
    print(f"  (c) in {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_above(dev)
    print(f"  (d) in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches_k4, eigh_ms_k4 = phase_large_cli_k4(root)
    print(f"  (e) in {time.time() - t0:.1f} s")
    out = {}
    for name, entries in timed.items():
        err = max(e["max_abs_err"] for e in entries)
        if name == "ns_invsqrt":
            err = max(err, err_prod)
        out[name] = {"large_k": entries, "max_abs_err_large_k": err,
                     "launches_large_k": {}}
    out["ns_invsqrt"]["launches_large_k"] = {
        "prod_shape_k128": launches_prod, "cli_k128": cli_counts["ns_invsqrt"]}
    out["jacobi_parallel"]["launches_large_k"] = {
        "cli_breakdown_k128": cli_counts["jacobi_parallel"]}
    out["jacobi_cyclic"]["launches_large_k"] = {
        "cli_breakdown_k129": launches_k4}
    out["jacobi_cyclic"]["cli_breakdown_k129_eigh_ms"] = eigh_ms_k4
    print(f"  phase 17 in {time.time() - t_all:.1f} s")
    return out


def free_port():
    """A free TCP port on 127.0.0.1, for a process group's store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_sharded(dev, smi_line, bench, xa3, cycle3_s, xa8b, d9, obs9,
                  launches9):
    """Phase 15: the multi-device layer on the one card; returns the
    launches of each sharded path by kernel.

    (a) ``sharded_update_points_cycle`` on an in-process mesh of two shards
    of the card, on phase 3's case, held against phase 3's analysis, then
    warm and timed: the gap to phase 3's warm cycle is the cost of sharding
    on one card (two Hilbert orders and chunkings, shards in turn), not
    scaling; (b) ``sharded_update_points_group`` for (U, V) under
    ``"jacobi"`` (K3) at two shards, against phase 8's (b); (c) a process
    group of world size 1 under NCCL: the member/point transposes round
    trip bit for bit, then ``run_analysis(distributed=True)`` on phase 9's
    files through the member-block streaming ensemble, against phase 9's
    fused analysis; (d) the pinned host-to-device rate and the scaling
    model fed with it and phase 3's warm cycle (a model, not a
    measurement).
    """
    import os

    import torch.distributed as dist

    from cwbnwp_letkf_torch import driver
    from cwbnwp_letkf_torch.config import LetkfConfig
    from cwbnwp_letkf_torch.examples.scaling_model_report import report
    from cwbnwp_letkf_torch.models.state import StreamingWrfEnsemble
    from cwbnwp_letkf_torch.ops import cycle, solver, update
    from cwbnwp_letkf_torch.parallel import make_mesh
    from cwbnwp_letkf_torch.parallel.multihost import (
        member_block, member_group_to_points, points_to_member_columns)
    from cwbnwp_letkf_torch.parallel.scaling_model import pinned_h2d_bytes_s
    from cwbnwp_letkf_torch.parallel.update import (
        sharded_update_points_cycle, sharded_update_points_group)

    pts_d, xb_d, dplats, groups = bench
    b = pts_d.shape[0]
    xb_v = xb_d[:, None, :].expand(b, N_VARS, K)
    mesh2 = make_mesh([dev, dev])
    chunks2 = 2 * -(-(-(-b // 2)) // CHUNK)    # the two shards' chunks
    out = {"ns_invsqrt": {}, "jacobi_parallel": {}}

    print(f"  (a) in-process mesh {[str(d) for d in mesh2.devices]}: the "
          f"shards run in turn on one card")
    kw = dict(weight_function=0, chunk=CHUNK, subchunk=SUBCHUNK)

    def sharded_cycle():
        budgets = cycle.plan_cycle_budgets(pts_d, dplats, groups, chunk=CHUNK,
                                           subchunk=SUBCHUNK, n_shards=2)
        t0 = time.time()
        xa, diag = sharded_update_points_cycle(
            mesh2, xb_v, pts_d, dplats, groups, max_blocks=budgets,
            return_diagnostics=True, **kw)
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        xa[:, MOIST] = solver.tune_q(xa[:, MOIST])
        return xa, diag, budgets, wall

    reset_counts()
    xa, diag, budgets, cold = sharded_cycle()
    counts = read_counts()
    overflow, resid = int(diag["bucket_overflow"]), float(diag["ns_residual"])
    print(f"  (a) first run {cold:.3f} s: budgets "
          f"{ {n: tuple(bb) for n, bb in budgets.items()} } (n_shards=2), "
          f"overflow {overflow}, ns_residual {resid:.3e}")
    check(tuple(xa.shape) == (b, N_VARS, K), f"(a) xa {tuple(xa.shape)}")
    check(bool(torch.isfinite(xa).all()), "(a) analysis not finite")
    check(overflow == 0, f"(a) bucket overflow {overflow}")
    check(resid <= NS_TOL, f"(a) ns_residual {resid} > {NS_TOL}")
    check_only(counts, "ns_invsqrt", 2 * chunks2,
               "(a) sharded NS cycle (2 per chunk of each shard)")
    out["ns_invsqrt"]["launches_sharded_cycle"] = counts["ns_invsqrt"]
    check_close(xa, xa3.to(dev), xb_v, "(a) two shards vs phase 3's cycle")
    # the single-card cycle again, just before the warm sharded run: the
    # host's launch rate drifts within a call, so the gap is read between
    # neighbours
    budgets1 = cycle.plan_cycle_budgets(pts_d, dplats, groups, chunk=CHUNK,
                                        subchunk=SUBCHUNK)
    t0 = time.time()
    cycle.update_points_cycle(xb_v, pts_d, dplats, groups,
                              max_blocks=budgets1, **kw)
    torch.cuda.synchronize(dev)
    single = time.time() - t0
    xa_w, _, _, warm = sharded_cycle()
    check(torch.equal(xa_w, xa), "(a) warm run differs from the first")
    del xa, xa_w
    print(f"  (a) {smi_line}: warm sharded_update_points_cycle {warm:.3f} s, "
          f"warm update_points_cycle just before it {single:.3f} s (phase "
          f"3's {cycle3_s:.3f} s): {warm - single:+.3f} s is the cost of "
          f"sharding on one card (two shards in turn), not scaling; "
          f"{b * N_VARS / warm:.1f} var-point updates/s")

    ivars = (0, 1)
    solver.set_eigh_backend("jacobi")
    try:
        budgets = update.plan_max_blocks(pts_d, dplats, ivars[0], chunk=CHUNK,
                                         n_shards=2)
        reset_counts()
        t0 = time.time()
        xa, diag = sharded_update_points_group(
            mesh2, xb_d[:, None, :].expand(b, 2, K), pts_d, dplats, ivars,
            inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
            weight_function=0, rtpp_alpha=(RTPP,) * 2, rtps_alpha=(RTPS,) * 2,
            chunk=CHUNK, max_blocks=budgets, return_diagnostics=True)
        torch.cuda.synchronize(dev)
        print(f"  (b) sharded_update_points_group (U, V), jacobi, two shards: "
              f"{time.time() - t0:.3f} s, budgets "
              f"{ {n: tuple(bb) for n, bb in budgets.items()} }, overflow "
              f"{int(diag['bucket_overflow'])}")
        counts = read_counts()
        check_only(counts, "jacobi_parallel", chunks2,
                   "(b) sharded group update (one per chunk of each shard)")
    finally:
        solver.set_eigh_backend("auto")
    check(int(diag["bucket_overflow"]) == 0, "(b) bucket overflow")
    check(bool(torch.isfinite(xa).all()), "(b) analysis not finite")
    check_close(xa, xa8b.to(dev), xb_d[:, None, :],
                "(b) two shards vs phase 8's (b)")
    out["jacobi_parallel"]["launches_sharded_group"] = \
        counts["jacobi_parallel"]
    del xa

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev)
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        print(f"  (c) NCCL process group, world size {mesh.size}, rank "
              f"{mesh.rank} on {mesh.devices[0]} ({mesh.kinds[0]}); started "
              f"in {time.time() - t0:.3f} s")
        glob = torch.from_numpy(np.random.default_rng(SEED + 15)
                                .standard_normal((100_003, 3, K))
                                .astype(np.float32))
        shards = member_group_to_points(mesh, glob.numpy(), K)
        back = points_to_member_columns(mesh, shards, K, glob.shape[0])
        check(len(shards) == 1 and torch.equal(shards[0].cpu(), glob)
              and np.array_equal(back, glob.numpy()),
              "(c) member/point transposes do not round trip")
        print(f"  (c) member_group_to_points -> points_to_member_columns on "
              f"{list(glob.shape)}: round trip bit for bit")

        k = K
        cfg = LetkfConfig.from_namelist(str(d9 / "input.nml"))
        paths = [str(d9 / f"wrfinput_nc_{m + 1:03d}") for m in range(k)]
        outs = [str(d9 / f"wrfout_dist_{m + 1:03d}") for m in range(k)]
        t0 = time.time()
        ens = StreamingWrfEnsemble(paths, cfg, outs,
                                   members=member_block(k, mesh))
        init_s = time.time() - t0
        reset_counts()
        t0 = time.time()
        driver.run_analysis(cfg, ens, obs9, mesh=mesh, distributed=True,
                            chunk=CHUNK, device=dev)
        torch.cuda.synchronize(dev)
        run_s = time.time() - t0
        counts = read_counts()
        print(f"  (c) run_analysis(mesh, distributed=True) on phase 9's "
              f"{k} files: streaming ensemble {init_s:.3f} s, run "
              f"{run_s:.3f} s")
        check_only(counts, "ns_invsqrt", launches9,
                   "(c) distributed run (as phase 9's fused run)")
        out["ns_invsqrt"]["launches_distributed"] = counts["ns_invsqrt"]
    finally:
        dist.destroy_process_group()
    equal, gaps = [], []
    for m in range(k):
        got = read_nc(outs[m])
        want = read_nc(d9 / f"wrfout_d01_{m + 1:03d}")
        prior = read_nc(paths[m])
        for name in VAR_UPDATE:
            if np.array_equal(got[name], want[name]):
                equal.append(name)
                continue
            diff = float(np.abs(got[name] - want[name]).max())
            incr = float(np.abs(want[name] - prior[name]).max())
            gaps.append(f"member {m + 1} {name}: {diff:.3e} = "
                        f"{diff / incr:.3e} of its increment")
            check(diff <= XA_RTOL * incr, f"(c) {gaps[-1]} > {XA_RTOL}")
    print(f"  (c) against phase 9's fused analysis: {len(equal)} of "
          f"{k * len(VAR_UPDATE)} member variables bit for bit"
          + (f"; the others within {XA_RTOL} of the increment: "
             + "; ".join(gaps) if gaps else ""))

    h2d = pinned_h2d_bytes_s(dev)
    model = report(pts_d, dplats, cycle3_s, h2d)
    pred = model["bench_case"]
    min_link = pred["link_sensitivity_at_max_hosts"]["min_link_gbs_for_85pct"]
    min_link = (f"{min_link} GB/s a card" if min_link is not None else
                "none (the imbalance alone keeps it below)")
    print(f"  (d) {smi_line}: pinned host-to-device copy {h2d / 1e9:.3f} GB/s "
          f"(256 MiB, the best of 5, CUDA events)")
    print("  (d) MODEL, not a measurement (parallel/scaling_model.py; phase "
          f"3's warm cycle {cycle3_s:.3f} s, the rate above, shard-work "
          f"imbalance {model['inputs']['imbalance_measured']}): efficiency "
          "by hosts of 8 cards "
          + json.dumps({n: v["efficiency"]
                        for n, v in pred["per_host"].items()})
          + f"; the least swept link rate for 85% at 8 hosts: {min_link}. "
          "NCCL at world size > 1 and any multi-card speed are not "
          "measured.")
    return out


def phase_cap_search(dev, first):
    """Phase 18: K5 against its plain version bit for bit at ``CAP_SHAPES``
    (distances of ``tests/torch_parity.cap_case``) and on ``first``, phase 3's first ``(r2, (row_mask, n_max, r2_cap))``
    (skipped where None), each shape timed beside the plain version and its
    bound; the compiler's report for both instances, where any spill or
    stack frame fails.  Returns K5's part of the kernel record."""
    from cwbnwp_letkf_torch.constants import GC1999_SQ
    from cwbnwp_letkf_torch.ops import cap_kernel, cuda_build
    from tests.torch_parity import cap_case

    lib = cuda_build.build(cap_kernel.SOURCE)[0]
    report = {name: res for name, res in cuda_build.resources(lib).items()
              if "cap_search_kernel" in name}
    for name, res in report.items():
        print(f"  {name}: {res}")
        check(res.get("spill_stores", 0) == res.get("spill_loads", 0) == 0
              and res.get("stack", 0) == 0, f"{name} spills: {res}")

    def same(r2, mask, n_max, r2_cap):
        sel, over = cap_kernel.launch(r2, mask, n_max, r2_cap)
        sel_p, over_p = cap_kernel.plain(r2, mask, n_max, r2_cap)
        torch.cuda.synchronize(dev)
        bad = int((sel != sel_p).sum()) + int((over != over_p).sum())
        check(bad == 0, f"cap search: {bad} elements off its plain version")
        return over

    if first is not None:
        r2, (mask, n_max, r2_cap) = first
        over = same(r2, mask, n_max, r2_cap)
        print(f"  phase 3's first input {tuple(r2.shape)}: bit for bit, "
              f"cap binds at {int(over.sum())} of {r2.shape[0]} points")
    rng = np.random.default_rng(SEED + 18)
    out = {"mismatches": 0,
           "registers": {n: res.get("registers") for n, res in report.items()},
           "spill_bytes": {n: res.get("spill_stores", 0)
                           for n, res in report.items()}}
    for label, (b, r, inside, masked) in CAP_SHAPES.items():
        r2, mask = cap_case(rng, b, r, inside, masked)
        r2 = torch.from_numpy(r2).to(dev)
        mask = None if mask is None else torch.from_numpy(mask).to(dev)
        over = same(r2, mask, CAP_N_MAX, GC1999_SQ)
        def kernel():
            cap_kernel.launch(r2, mask, CAP_N_MAX, GC1999_SQ)

        def plain():
            cap_kernel.plain(r2, mask, CAP_N_MAX, GC1999_SQ)

        ms, plain_ms = queued_ms(kernel), queued_ms(plain, reps=5)
        call_ms = median_ms(kernel, reps=20)
        entry = timed_entry(0.0, ms, plain_ms, cap_kernel.work(b, r),
                            call_ms=call_ms, config=cap_kernel.config(r),
                            cap_bound_rows=int(over.sum()))
        print(f"  {label} [{b}, {r}], mask {masked}: {ms:.4f} ms on the "
              f"card ({call_ms:.4f} ms a call timed alone, the wrapper's "
              f"host time included), plain {plain_ms:.4f} ms "
              f"({plain_ms / ms:.1f}x), bound {entry['bound_ms']:.4f} ms by "
              f"{entry['bound_by']}, share {entry['share_of_bound']:.3f}; "
              f"cap binds at {int(over.sum())} of {b} rows; "
              f"{entry['config']}")
        out[label] = entry
    return out


def phase_select_terms(dev, first):
    """Phase 19: K6 against its plain version at ``SELECT_SHAPES`` (the
    distances of ``tests/torch_parity.cap_case``, K5's selection, the
    factors of ``select_stats``) and on ``first``, phase 3's first ``(r2,
    (sel, bgo, e, nvalid, weight_function))`` (skipped where None): within
    the float32 bound of two orders of the sum (``select_tolerance``),
    counts equal.  Each shape is timed beside the plain version, the
    library's product alone and the bound; the compiler's report for every
    instance, where any spill or stack frame fails.  Returns K6's part of
    the kernel record."""
    from cwbnwp_letkf_torch.constants import GC1999_SQ
    from cwbnwp_letkf_torch.localization import WEIGHT_GAUSSIAN
    from cwbnwp_letkf_torch.ops import (cap_kernel, cuda_build, dense,
                                        select_kernel)
    from tests.torch_parity import cap_case, select_stats, select_tolerance

    lib = cuda_build.build(select_kernel.SOURCE)[0]
    report = {name: res for name, res in cuda_build.resources(lib).items()
              if "select_terms_kernel" in name}
    for name, res in report.items():
        print(f"  {name}: {res}")
        check(res.get("spill_stores", 0) == res.get("spill_loads", 0) == 0
              and res.get("stack", 0) == 0, f"{name} spills: {res}")

    def same(r2, sel, bgo, e, nvalid, wf):
        """``(max |da|, max |dg|, the worst gap over its bound)``."""
        a, g, count = select_kernel.launch(r2, sel, bgo, e, nvalid, wf)
        a_p, g_p, count_p = select_kernel.plain(r2, sel, bgo, e, nvalid, wf)
        tol = select_tolerance(r2, sel, (bgo, e), nvalid, wf)
        torch.cuda.synchronize(dev)
        k = bgo.shape[-1] - 1
        da, dg = (a.double() - a_p.double()).abs(), (g.double() - g_p.double()).abs()
        worst = max(float((da / tol[:, :, :k]).nan_to_num(0.0).max()),
                    float((dg / tol[:, :, k]).nan_to_num(0.0).max()))
        check(bool((da <= tol[:, :, :k]).all() and (dg <= tol[:, :, k]).all()),
              f"selected-pair accumulation off its plain version: {worst:.3f} "
              "of the bound")
        check(torch.equal(count, count_p), "selected-pair counts differ")
        return float(da.max()), float(dg.max()), worst

    if first is not None:
        r2, args = first
        da, dg, worst = same(r2, *args)
        print(f"  phase 3's first input {tuple(r2.shape)}, k = "
              f"{args[1].shape[-1] - 1}: max|da| {da:.3e}, max|dg| {dg:.3e} "
              f"({worst:.3f} of the float32 bound), counts equal")
    rng = np.random.default_rng(SEED + 19)
    out = {"registers": {n: res.get("registers") for n, res in report.items()},
           "spill_bytes": {n: res.get("spill_stores", 0)
                           for n, res in report.items()}}
    for label, (b, r, inside, masked, k) in SELECT_SHAPES.items():
        r2, mask = cap_case(rng, b, r, inside, masked)
        r2 = torch.from_numpy(r2).to(dev)
        mask = None if mask is None else torch.from_numpy(mask).to(dev)
        sel, over = cap_kernel.launch(r2, mask, CAP_N_MAX, GC1999_SQ)
        stats = select_stats(rng, 1, r, k)
        fused, nvalid = (x.to(dev) for x in dense.fused_platform_table(stats, (True,)))
        bgo, e = (x.to(dev) for x in dense.pair_factors(stats, ((True,),))[0])
        wf = WEIGHT_GAUSSIAN
        da, dg, worst = same(r2, sel, bgo, e, nvalid, wf)
        pairs = int((sel & (nvalid > 0)[None]).sum())
        gm = torch.where(sel, torch.exp(-0.5 * r2), 0.0)

        def kernel():
            select_kernel.launch(r2, sel, bgo, e, nvalid, wf)

        def plain():
            select_kernel.plain(r2, sel, bgo, e, nvalid, wf)

        def library():
            torch.matmul(gm, fused)

        ms, plain_ms = queued_ms(kernel), queued_ms(plain, reps=5)
        library_ms = median_ms(library)
        call_ms = median_ms(kernel, reps=20)
        entry = timed_entry(max(da, dg), ms, plain_ms,
                            select_kernel.work(b, r, k, 1, pairs),
                            library_ms=library_ms, call_ms=call_ms,
                            max_abs_da=da, max_abs_dg=dg, share_of_tol=worst,
                            config=select_kernel.config(k),
                            selected_pairs=pairs,
                            cap_bound_rows=int(over.sum()))
        print(f"  {label} [{b}, {r}], k = {k}, mask {masked}: {ms:.4f} ms on "
              f"the card ({call_ms:.4f} ms a call timed alone), plain "
              f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x), torch.matmul "
              f"{library_ms:.4f} ms ({library_ms / ms:.1f}x), bound "
              f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}, share "
              f"{entry['share_of_bound']:.3f}; {pairs} selected pairs "
              f"({pairs / (b * r):.2%}); max|da| {da:.3e}, max|dg| {dg:.3e} "
              f"({worst:.3f} of the bound), counts equal; {entry['config']}")
        out[label] = entry
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.time()
    print("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(smi_line)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from cwbnwp_letkf_torch.ops import (cap_kernel, cuda_build, eigh_kernel,
                                        ns_kernel, select_kernel)

    print("phase 1: build")
    t0 = time.time()
    libs = cuda_build.build(ns_kernel.SOURCE, eigh_kernel.SOURCE,
                            cap_kernel.SOURCE, select_kernel.SOURCE)
    print(f"  built {[lib.name for lib in libs]} in {time.time() - t0:.2f} s")
    for lib in libs:
        print("  " + lib.with_suffix(".log").read_text().strip()
              .replace("\n", "\n  "))
    for _, k in NS_SHAPES + LARGE_NS_SHAPES:
        for packing in ns_kernel.LAUNCHES:
            print(f"  ns_invsqrt {packing} at k={k}: "
                  f"{ns_kernel.config(k, packing)}")
    for shapes in (JACOBI_SHAPES, LARGE_JACOBI_SHAPES):
        for name, pairs in shapes.items():
            for _, k in pairs:
                print(f"  {name} at k={k}: {eigh_kernel.config(k)}")
    check_large_k3(libs[1])
    check_large_k4(libs[1])
    for _, r, _, _ in CAP_SHAPES.values():
        print(f"  cap_search at R={r}: {cap_kernel.config(r)}")
    for k in (K, 96, LARGE_K):
        print(f"  select_terms at k={k}: {select_kernel.config(k)}")

    record = {}
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        print("phase 2: K1 vs plain")
        entry = phase_kernel(dev, np.random.default_rng(SEED + 1))

        print("phase 3: slice")
        t0 = time.time()
        # the bench case's own seed: the same arrays as bench.py:71-112
        case = bench_case(np.random.default_rng(SEED), GRID[2])
        print(f"  case: {case[0].shape[0]} points ({GRID[0]}x{GRID[1]}x"
              f"{GRID[2]}), k={K}, {N_VARS} variables in {len(PROD_GROUPS)} "
              f"groups, records {[po.nrec for _, po in case[3]]}; built on "
              f"the host in {time.time() - t0:.2f} s")
        pts_d, xb_d, truth_d, xa_ns, dplats, groups, budgets, launches, \
            cycle3_s, cap3, sel3 = phase_slice(dev, case)
        xa3 = xa_ns.cpu()            # phase 15's reference, off the card

        print("phase 4: K1 on real normal matrices; eigen-solve controls")
        err4, stacks, first = phase_real(pts_d, dplats, groups, budgets)
        entry["max_abs_err"] = max(entry["max_abs_err"], err4)
        record["ns_invsqrt"] = {"launches": launches, **entry}
        phase_eigh_control(first, xb_d, groups)

        print("phase 5: K2")
        record["ns_invsqrt_rmul"] = phase_rmul(dev, stacks)

        print("phase 6: K3 and K4 vs plain")
        jac = phase_jacobi(dev, np.random.default_rng(SEED + 2), stacks)
        del stacks

        print("phase 7: entry (a), the Jacobi cycle")
        xa_jac, launches3 = phase_jacobi_cycle(dev, pts_d, xb_d, truth_d,
                                               xa_ns, case[3])
        del xa_ns
        record["jacobi_parallel"] = {"launches": launches3,
                                     **jac["jacobi_parallel"]}

        print("phase 8: entries (b) and (c)")
        launches4, xa_b, xa_c, case41 = phase_updates(dev, pts_d, xb_d,
                                                      xa_jac, dplats, GRID[2])
        xa8b = xa_b.cpu()            # phase 15(b)'s reference
        del xa_jac
        record["jacobi_cyclic"] = {"launches": launches4,
                                   **jac["jacobi_cyclic"]}

        print("phase 9: run_analysis on WRF member files")
        case9 = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_wrf_"))
        launches9, err9, obs9 = phase_driver(dev, smi_line, root=Path(case9))
        record["ns_invsqrt"]["launches_run_analysis"] = launches9
        record["ns_invsqrt"]["max_abs_err"] = max(
            record["ns_invsqrt"]["max_abs_err"], err9)

        print("phase 10: the CLI, input files to analysis files")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            t0 = time.time()
            phase_cli_synthetic(Path(tmp))
            print(f"  (a) in {time.time() - t0:.1f} s")
            t0 = time.time()
            launches10, err10 = phase_cli(dev, smi_line, Path(tmp),
                                          launches9)
            record["ns_invsqrt"]["launches_cli"] = launches10
            record["ns_invsqrt"]["max_abs_err"] = max(
                record["ns_invsqrt"]["max_abs_err"], err10)
            print(f"  (b) in {time.time() - t0:.1f} s")

        print("phase 11: the gather path at full width")
        t0 = time.time()
        launches11, errs11 = phase_gather(
            dev, (pts_d, xb_d, truth_d, dplats, case[3]), xa_b, xa_c, case41)
        del xa_b, xa_c, case41
        for name, keys in launches11.items():
            record[name].update(keys)
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"],
                                              errs11[name])
        print(f"  in {time.time() - t0:.1f} s")

        print("phase 12: the refined solves on phase 4's first chunk")
        rows, a, g, cnt = first
        record["ns_invsqrt"]["launches_refined"] = phase_refined(
            a[0], g[0], xb_d[rows], cnt[0] > 0, "bench first chunk, k=40")
        del first, a, g, cnt

        print("phase 13: the production shape")
        t0 = time.time()
        launches13, err13, launches12 = phase_prod(dev, smi_line)
        record["ns_invsqrt"]["launches_prod_shape"] = launches13
        record["ns_invsqrt"]["launches_refined"] += launches12
        record["ns_invsqrt"]["max_abs_err"] = max(
            record["ns_invsqrt"]["max_abs_err"], err13)
        print(f"  in {time.time() - t0:.1f} s")

        print("phase 14: the device-time breakdown")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bd_") as tmp:
            record["jacobi_parallel"]["launches_breakdown"] = \
                phase_breakdown(dev, pts_d, xb_d, dplats, Path(tmp))

        print("phase 15: the sharded paths (parallel/)")
        t0 = time.time()
        sharded = phase_sharded(dev, smi_line, (pts_d, xb_d, dplats, groups),
                                xa3, cycle3_s, xa8b, Path(case9), obs9,
                                launches9)
        record["ns_invsqrt"].update(sharded["ns_invsqrt"])
        record["jacobi_parallel"].update(sharded["jacobi_parallel"])
        print(f"  in {time.time() - t0:.1f} s")

        print("phase 16: the drives (examples/)")
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_drives_") as tmp:
            launches16, err16 = phase_drives(
                dev, smi_line, (pts_d, xb_d, dplats, groups, budgets),
                cycle3_s, Path(tmp))
        record["ns_invsqrt"]["launches_drives"] = launches16
        record["ns_invsqrt"]["max_abs_err"] = max(
            record["ns_invsqrt"]["max_abs_err"], err16)
        print(f"  in {time.time() - t0:.1f} s")

        print("phase 17: large ensembles")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as tmp:
            large = phase_large(dev, smi_line, Path(tmp))
        for name, keys in large.items():
            record[name].update(keys)
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"],
                                              keys["max_abs_err_large_k"])

        print("phase 18: K5, the cap search")
        record["cap_search"] = {"launches": cap3[0],
                                **phase_cap_search(dev, cap3[1])}

        print("phase 19: K6, the selected-pair accumulation")
        record["select_terms"] = {"launches": sel3[0],
                                  **phase_select_terms(dev, sel3[1])}
    print(f"all phases passed in {time.time() - t_start:.1f} s")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        check(record[name]["launches"] > 0,
              f"{name} was not launched by its path")
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, **record[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
