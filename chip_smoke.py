"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width (4096 agents, 1080 beams, 270 deg,
max_range 10) on both bundled maps, levine and berlin, and checks them:

1. the card's name and power limit, the PyTorch and CUDA versions;
2. builds the five sources, ``csrc/sector_sweep.cu`` (the list-routed
   sweep), ``csrc/dense_sweep.cu``, ``csrc/edf_march.cu`` (the EDF march
   and its gradient), ``csrc/general_sweep.cu`` (the general-segment
   sweep) and ``csrc/soft_edt.cu`` (the chamfer stencil of ``soft_edt``
   and its gradient), with one nvcc per source, started together;
3. per map, the sector backend: the list kernel against its plain PyTorch
   version on the card on the full 4096 x 1080 fan (mismatches must be 0;
   the rows, real slots and slots kept by the wedge cull on the kernel's
   device counter equal to the plain version's host count,
   ``sweeps.SWEEP_COUNTS``),
   the CUDA scan against the CPU scan on 64 poses given the same fan
   (bit-identical), and the scan against the float64 brute-force oracle
   ``maps.segments.raycast_segments_numpy`` on a few poses;
4. per map, the dense "segments" backend (the default): the kernel its
   default path runs (levine: the dense kernel; berlin: the list kernel
   over map tiles) against its plain version on the full fan, the CUDA
   scan against the CPU scan, the scan against the oracle; and the dense
   kernel over berlin's 4442 untiled segments against its plain version
   on 256 agents;
5. the sector scans that stand for the JAX package's other two list
   kernels (mode "sorted_pl", ``use_pallas=True``; both run the one list
   kernel, on its entry from poses), counted, against the default sector
   scan;
6. the main path: ``build_sim(name)`` (default backend) -> one step plus
   a 20-step noisy rollout per map (replayed from CUDA graphs), with every
   launch counter set to 0 just before and read just after (levine must
   have run the dense kernel, berlin the list kernel's entry from poses
   over map tiles, ``list_scan``, 25 times each: the
   step, 4 warm-up steps of the capture, 20 replays); "segments_pallas"
   equal to "segments"; then the same drive on the sector backend
   (``list_scan`` on both maps);
7. 3 BPTT train steps (T = 5, 4096 x 1080) on berlin with "segments" and
   with "sectors": loss finite, parameters moved, counters grown (each
   call's first scan, whose pose no parameter reaches, on ``list_scan``,
   the others on ``list_sweep``);
8. times (CUDA events, warm-up, inputs that change between repetitions):
   each kernel and its plain version, the full scans, the closed-loop
   steps, one train step; peak device memory;
9. the reference-style facade ``RacecarSimulator`` with batch shape ();
10. per map, the EDF march kernel ``edf_march`` against its plain
    PyTorch versions on the card on the full 4096 x 1080 fan, in its three
    variants (nearest, bilinear: the plain loop; implicit: the plain loop
    and ``_refine``, ``raymarch_diff._fwd_plain``; 0 mismatches on the
    ranges, and on the implicit variant's hit flags), with per-ray trips
    (sum, percentiles, and the warp- and block-level trips one ray a
    thread would take), the implicit variant's refined hits, time, plain
    time and bound; its gradient ``edf_march_grad`` (nearest: the EDF's; bilinear:
    the EDF's and the rays') against autograd through the plain loop on
    the same fan (the plain run in blocks of 512 agents), from the
    march's record: the rays' gradients with 0 mismatches, the EDF's
    within ``GRAD_TOL`` x max(1, the largest |plain|) (atomics sum in
    another order); with time, plain time and bound; the kernels'
    persistent grids and, from nvcc's resource report, their registers,
    spills (none allowed) and stack frames (one allowed: the bilinear
    gradient's ``GRAD_SLOTS`` positions a thread, 512 bytes); the implicit
    march's VJP in the poses ``implicit_pose_vjp`` against its plain
    version on the same fan (each ray's terms with 0 mismatches, the
    agents' sums within ``POSE_VJP_SUM_TOL`` x the sum of their |terms|,
    the same bits on a second launch), its time beside its bound, the
    plain version's and the composition's backward it replaces, and the
    "edf_implicit" scan's forward bit for bit the composition's, its
    forward + backward one ``edf_march`` and one ``implicit_pose_vjp``
    launch; the
    "edf" march on the card against the CPU march on 64 poses
    given the same fan (bit-identical), the scan against the NumPy oracle
    ``oracle/raycast.py`` (its native body) on 64 poses, pose by pose
    (tests/test_raymarch.py's bound), the full scan's time and its device
    operations per scan (profiler); the "edf" step and a 20-step rollout
    (replayed from CUDA graphs), counted (``edf_march`` 25 times, no other
    kernel), and the step's time;
11. per map, "edf_implicit" and "edf_bilinear" forward and backward at
    full width (EDF and pose gradients finite and non-zero; one
    ``edf_march`` launch a forward, the implicit variant for
    "edf_implicit", one ``implicit_pose_vjp`` launch an implicit backward
    and one ``edf_march_grad`` launch a bilinear backward, nothing else);
12. ``make_scan_fn(map_grad=True)`` on berlin's sector backend: forward
    equal to ``scan_poses_sectors`` bit for bit, EDF cotangent finite and
    non-zero, ``list_sweep`` launched exactly once per scan; the dedup
    cotangent against the scatter one;
13. per map, the chamfer stencil of ``soft_edt`` on the occupancy in
    three modes (``STENCIL_MODES``: hard min and softmin at 64
    iterations, ``demo_mapping``'s softmin with the log init at 96): the
    kernel ``soft_edt`` against the plain loop on the card (values and
    history; hard: 0 mismatches, softmin within ``STENCIL_TOL`` x max(1,
    the largest |plain|)), its gradient ``soft_edt_grad`` against the
    explicit plain backward (hard: 0 mismatches, softmin within
    ``STENCIL_TOL``) and against autograd through the plain loop (hard
    within ``STENCIL_TOL``, softmin ``STENCIL_GRAD_TOL``), the times of the
    kernels and their plain versions, of ``soft_edt`` forward + backward
    and of the plain loop under autograd, each beside its bound, and the
    peak device memory of both; ``soft_edt`` on the card against the CPU
    (hard min: bit-identical; softmin: 1e-4); then
    ``scan_from_occupancy`` on levine at 4096 x 1080, forward and
    backward: one launch each of ``soft_edt``, ``edf_march``,
    ``edf_march_grad`` and ``soft_edt_grad`` and nothing else, the
    occupancy gradient finite and non-zero, the ranges equal bit for bit
    to the same path with the plain stencil, timed against it in turns;
14. per map, "segments_simplified" (levine: every ray against the (6,
    128) table; berlin: each agent against its tile's list): the kernel
    ``general_sweep`` against its plain version on the card on the full
    4096 x 1080 fan, min-only and winner (0 mismatches on the ranges, wx
    and wy), with time, plain time and bound (and the bound at 27
    operations a real pair beside it); on the first map also against it
    on the adversarial set of ``tests/torch_general_cases.py`` (0
    mismatches in both modes, flat and per list, unknown lists NaN); the
    CUDA scan against the CPU scan given the same fan (bit-identical); one
    launch a scan; the step and rollout, counted (``general_sweep`` 25
    times), and times;
15. per map, the obstacle cycle through ``RacecarSimulator(device="cuda")``
    on "segments", "sectors", "edf" (with ``graph=True``: the step
    captured again after each edit) and "segments_simplified" (the general
    sweep): a box 1 m
    ahead of the scanner shortens the beam straight ahead; the sector
    incremental edit gives exactly the full rebuild's ranges; the launch
    counters show the dense or tile kernel, the sector kernel or the
    march on the edited map; ``clear_obstacles`` restores the earlier scan
    bit for bit (and the graphed "edf" step's beam ahead);
    the host time of ``add_obstacle``;
16. multitrack at full width: levine + berlin stacked, 2048 agents per
    map: the list kernel against its plain version over the stacked
    table, ``scan_poses_sectors_multi`` equal bit for bit to the two
    per-map scans, exactly one ``list_sweep`` launch per multi scan (with
    ``mode="sorted_pl"`` too), forward + backward, times;
17. a 1 x 1 mesh on the card, backend NCCL, in this process: the sharded
    sector step equal to ``make_step_fn``'s, the stacked step equal to the
    multitrack scan, the ring scan (one slab) equal to
    ``scan_poses_sectors``, all bit for bit, counted and timed; the
    ring's one launch (the gathered buffer as the table) against its plain
    version;
18. four gloo ranks on the one card through ``parallel.dryrun`` (mesh
    2 x 2, berlin, 1024 agents): the dense, sector and ring sweeps at the
    wedges' shapes against their plain versions; gathered ranges,
    collisions and pose gradients against the unsharded run and the
    oracle, each rank's launches;
19. ``utils.debug.checked`` on a clean and on a poisoned step;
    ``utils.profiling.rays_per_second`` of the berlin sector scan;
20. the native host tier (``_native/loader.py``, run first, before any map
    is loaded): built with the host's C++ compiler; per map at full size
    each of the five entry points against its NumPy or Python body (EDT
    bit for bit, membership entry for entry, the same segment set, the
    segment raycast within 1e-9 m, the EDF march within 1e-6 m) and both
    bodies' host times; ``load_builtin``, ``build_sim(name,
    backend="sectors")`` and ``add_obstacle`` host seconds with either
    body, the call counters showing which one ran;
21. the eight demos of ``examples/torch/`` through their ``main([...])``
    on the card, at 4096 x 1080 where a demo has agents (its own default
    where that is larger), steps and iterations cut: losses finite and
    falling where a demo optimises, ``demo_gradients`` within 0.01 m of
    the true pose, launch counters read around each (a demo that is meant
    to run a kernel and launched none fails the run; ``demo_mapping``
    runs the march and both stencil kernels);
22. ``scripts/parity_report_torch.py`` through its ``main([...])`` on the
    card, 16 poses per map: every exact-geometry row agrees with the
    float64 oracle on >= 99.9% of its beams within 1e-4 m, the "edf" march
    with the march oracle on >= 99% within 1e-3 m, both gradient rows lie
    under 1e-5, and every row that names a kernel launched its wrapper;
    the theta-bucket quantization on the card equals the CPU's bit for bit
    on the full fan;
23. ``bench_torch.py`` through its ``main([...])`` at full width with its
    defaults: no stage failed, the five parity gates are 0.0, every kernel
    stage launched its kernel; its rates are logged with the card's name
    and power limit;
24. the compiled step (``utils/graph.py``), per map on "segments",
    "sectors", "edf", "edf_implicit", "edf_bilinear" and
    "segments_simplified": the step replayed
    as a CUDA graph against the eager step
    over 4 replays with changing inputs, noise on from one seed (ranges,
    collision and every state field bit for bit); the graphed rollout
    (gap follower, T = 25, scans kept, noise off and on) against the
    eager loop; a replayed rollout adds T to its wrapper's counter and
    the host launches T graphs; on the exact backends the graphed rollout
    under an open-loop policy ``steer_seq[t]`` against the eager loop
    (after step 0 the policy's ``t`` is the device's step index), a
    policy that branches on ``t`` in Python raises, and a host-counting
    Adam under ``graph=None`` trains eagerly; the graphed BPTT train step
    (T = 5, Adam with ``capturable=True``) against the eager one, losses
    and parameters after 3 steps (on "edf_bilinear" its backward launches
    ``edf_march_grad``, on "edf_implicit" ``implicit_pose_vjp`` once a
    step of a call but the first (whose scan pose no parameter reaches),
    eager or replayed, and on no other backend; the
    graphed "edf_implicit" step launches about as
    many device kernels as the "edf" step: ``_refine``'s passes are
    gone); the facade with ``graph=True`` across
    ``add_obstacle`` and ``clear_obstacles`` against the eager facade (a
    stale table fails here); 10 scans after the first make no
    ``cudaStreamSynchronize`` and no host-to-device copy (profiler);
    times, eager and graphed: ms per
    step, per rollout step and per train step, the capture's seconds, the
    steps after which a rollout's first call is paid back, and from the
    profiler the graphed step's device launches, device-busy
    time and idle share.
25. (run inside the loop of 3-4) per map, the list kernel's entry from
    poses ``list_scan`` on the sector table and the map tiles at 4096 x
    1080, one origin outside the map's extent: against
    ``list_scan_plain`` and against the composition it replaces (the fan,
    the reciprocals, the rays-given ``list_sweep``, the clamp, the slice
    and the extent mask), 0 mismatches, the rows, real and kept slots on
    the device counter equal to both, every row ``fanned``; device times
    from graph replays of the entry, of the composition and of
    ``list_sweep`` alone, the plain time, and the bound (the sweep's kept
    tests and cull pass plus ``FAN_OPS_PER_RAY`` a ray; bytes: the range
    written and the staged slots); from nvcc's report both entries'
    registers (the rays-given one 32), no spill, no stack frame.

Every kernel's time stands beside its bound: the larger of its
operations over the card's FP32 instruction rate at ``clocks.max.sm``,
and its bytes (each input and output once) over the HBM rate. The
operations are counted from the function's arithmetic, not from the
compiled code: a sweep's are ``OPS_PER_TEST`` per ray-segment test, over
the real slots of the lists this run visits (the general sweep's
``TEST_OPS_PER_PAIR`` per real pair, plus the ``OPS_PER_PAIR -
TEST_SHARED_OPS`` that the test did not count per pair whose range lowers
or ties the running minimum, counted from the plain version on this run's
inputs; beside it the old bound of ``OPS_PER_PAIR`` per
real pair); the march's are ``MARCH_OPS_PER_TRIP`` per
trip of each ray (the kernel reports each ray's trips in this run), plus
``REFINE_OPS_PER_HIT`` per refined hit for the implicit variant, its
gradient's ``MARCH_GRAD_OPS_PER_TRIP``; the march's bytes are the rays
once, the outputs once and the EDF once (and its gradient once). The
chamfer stencil's are ``STENCIL_OPS`` a cell and iteration, its
exponentials and logarithms an issue slot each on the FP32 side and
``SFU_COST`` FP32 slots each on the SFU's own pipe, the longer of the two;
its bytes the field in and out once and the history once. Beside the bound stands, where the toolkit has
``cuobjdump``, what the compiled loop issues per test or per trip (its
SASS), as a reading.

Prints a JSON line describing the nine kernel wrappers (the two sweeps
that replace the five TPU kernels, ``list_sweep`` four of them, and the
list kernel's entry from poses ``list_scan``, which folds the fan and the
finished range into it; the EDF
march, which replaces three XLA loops, its
gradient, which replaces the scan's transpose under ``jax.grad``, the
implicit march's pose VJP, which replaces its custom_vjp's backward and
the fan's transpose, the general sweep, which replaces the
general-segment scans, and the chamfer
stencil of ``soft_edt`` and its gradient, which replace its scan and that
scan's transpose; their launches
path by path, each path counted from 0), then as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Exits non-zero, without that line, on any failure or
without a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

AGENTS = 4096
BEAMS = 1080
FOV = 4.712388980384690
MAX_RANGE = 10.0
STEPS = 20
# a rollout's first call on a backend that can be captured warms up its two
# graphs (step 0, every later step) with 2 eager steps each: real launches
WARMUP_STEPS = 4
ORACLE_POSES = 64
TRAIN_T = 5
MAPS = ("levine", "berlin")
SRC = "pyracecarsimulator_tpu_torch/csrc/"
TPU = "pyracecarsimulator_tpu/ops/raycast_pallas.py:"
# wrapper name -> (CUDA source, the TPU kernel it replaces, where it runs)
KERNELS = {
    "list_sweep": (SRC + "sector_sweep.cu",
                   f"{TPU}704, {TPU}505, {TPU}239, {TPU}186",
                   "sector backend (every mode, use_pallas), segments "
                   "backend on tiled maps (berlin), stacked maps, the ring"),
    "list_scan": (SRC + "sector_sweep.cu",
                  f"{TPU}704, {TPU}186 (the list sweep's entry from poses, "
                  "with the fan of pyracecarsimulator_tpu/ops/common.py "
                  "rotate_fan, raycast_segments._ray_invs, the clamp and the "
                  "extent mask)",
                  "scans of poses without a gradient on the sector backend "
                  "and on map tiles (berlin): steps, rollouts, the first "
                  "step of a train call"),
    "dense_sweep": (SRC + "dense_sweep.cu", TPU + "116",
                    "segments backend, untiled maps (levine)"),
    # XLA loops, no pallas_call: the JAX package has no Pallas march
    "edf_march": (SRC + "edf_march.cu",
                  "pyracecarsimulator_tpu/ops/raymarch_xla.py:139, "
                  "pyracecarsimulator_tpu/ops/raymarch_diff.py:116, "
                  "pyracecarsimulator_tpu/ops/raymarch_diff.py:150",
                  "the EDF backends: edf, edf_bilinear, edf_implicit"),
    "edf_march_grad": (SRC + "edf_march.cu",
                       "pyracecarsimulator_tpu/ops/raymarch_xla.py:139 "
                       "(the scan's transpose under jax.grad)",
                       "the EDF marches' gradient: edf_bilinear, and a "
                       "march whose EDF requires grad"),
    "implicit_pose_vjp": (SRC + "edf_march.cu",
                          "pyracecarsimulator_tpu/ops/raymarch_diff.py:214 "
                          "(_mri_bwd) and the transpose of the fan "
                          "(ops/common.py rays_from_poses)",
                          "edf_implicit's backward in the poses"),
    "general_sweep": (SRC + "general_sweep.cu",
                      "pyracecarsimulator_tpu/ops/raycast_general.py:34, "
                      "pyracecarsimulator_tpu/ops/raycast_general.py:73, "
                      "pyracecarsimulator_tpu/ops/raycast_general.py:145",
                      "segments_simplified backend"),
    "soft_edt": (SRC + "soft_edt.cu",
                 "pyracecarsimulator_tpu/ops/soft_edt.py:110",
                 "soft_edt on the card: scan_from_occupancy, demo_mapping"),
    "soft_edt_grad": (SRC + "soft_edt.cu",
                      "pyracecarsimulator_tpu/ops/soft_edt.py:110 (the "
                      "scan's transpose under jax.grad)",
                      "soft_edt's backward"),
}


# the bound's model: instruction slots per ray-segment test (7 separately
# rounded float32 operations, 2 compares, 1 select; -fmad=false forbids
# fusing), FP32 lanes per SM, and the HBM rate of an H100 SXM (NVIDIA's
# data sheet)
OPS_PER_TEST = 10
# the list kernel's wedge cull, once a real slot of a row that culls: the
# endpoints' offsets 3, the margin 7 (two maxima of magnitudes, two adds,
# a multiply, an add and a negation), four cross products 12, four
# compares, two ands and an or 7
CULL_OPS_PER_SLOT = 29
# dense_sweep_kernel's registers in nvcc's report (sm_90a), as before it
# counted its work (tests/test_torch_kernels.py holds the same)
DENSE_REGISTERS = 40
# the list kernel's entry from poses, once a ray besides the sweep: the fan
# 6 (four multiplies, a subtract, an add), two reciprocals 2 and their zero
# tests 2, the minimum and the clamp 2, the extent test 4 and its select 1
FAN_OPS_PER_RAY = 17
LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12
# the march's variants, and the gathers a trip of each issues
MARCH_VARIANTS = {"nearest": 1, "bilinear": 4, "implicit": 1}
# operations per trip that the march's function needs, counted from its
# arithmetic (-fmad=false: each multiply and add its own operation):
#   nearest: the grid coordinates 4 (subtract, multiply, twice), 2 floors,
#     2 float-to-int, the bounds 4, the flat index 1, the gather 1, the
#     stop tests 3, the step 5 (x += d c, y += d s, total += d), the trip
#     counter 2 = 24; the implicit variant's march the same (its last
#     step is a copy);
#   bilinear: the grid coordinates 4, the bounds 4, the half-cell shifts
#     2, their clamps 4, 2 floors, their clamps 2, the fractions 2,
#     float-to-int 2, the base index 1 and the 3 other taps' 3, 4 gathers,
#     1 - fx and 1 - fy 2, the value 9 (6 multiplies, 3 adds), the stop
#     tests 3, the step 5, the trip counter 2 = 51
MARCH_OPS_PER_TRIP = {"nearest": 24, "bilinear": 51, "implicit": 24}
# the implicit variant's operations per refined hit (raymarch_diff._fwd_plain
# after the march): the bracket 3 (a subtract, its clamp, an add); 12
# bisections of 47: the midpoint 2, the position 8, the patch's value 33
# (the half-cell shifts 2, their clamps 4, 2 floors, their clamps 2, the
# fractions 2, float-to-int 2, the 4 taps' indices 4, 4 gathers, 1 - fx and
# 1 - fy 2, the value 9), F 1, its test 1, the two selects 2; the Newton
# step 64: the position 8, the value 33, the slope 10, F 1, dE/dr 4, its
# floor 2, the division 1, the step 1, its two clamps 2, the range's clamp
# 1 and the hit test 1: 3 + 12 x 47 + 64 = 631
REFINE_OPS_PER_BISECTION = 47
REFINE_OPS_PER_HIT = 3 + 12 * REFINE_OPS_PER_BISECTION + 64
# the general sweep's operations per (ray, slot) pair (ops/raycast_general.py
# _pairs): the normal 1, denom 3, d_safe 2, the numerator 5, the division 1
# (counted as one, as the march's bounds count it), hx and hy 6, s 3, the
# four validity tests 4, the select 1, the running minimum 1 = 27: what a
# pair costs whose t lowers (winner: or ties) the running minimum
OPS_PER_PAIR = 27
# what every real pair costs to decide that it cannot win (the tests of
# csrc/general_sweep.cu): the normal 1, denom 3, the numerator 5 (the
# TEST_SHARED_OPS that OPS_PER_PAIR counts too), the quotient's sign 1, the
# threshold's and the sign test's products 2 and their compares 2 = 14.
# The bound charges it for every real pair, plus what the test did not
# count (OPS_PER_PAIR - TEST_SHARED_OPS = 18) for each pair that lowers or
# ties the running minimum, counted from the plain version
# (tests/torch_general_cases.py general_pair_counts): 32 for such a pair
TEST_OPS_PER_PAIR = 14
TEST_SHARED_OPS = 9
# its gradient's, with the forward's intermediates kept (the kernel marches
# again instead: that is its own cost, not the function's):
#   nearest: the forward trip 24 and one add into the EDF's gradient = 25;
#   bilinear: the forward trip 51 and the reverse 34: the step's adjoint 4,
#     the directions' 4, the rows' 2, d/dfx 7, d/dfy 3, the position's 6
#     (two clamp tests, two multiplies, two adds), the 4 taps' weights 4
#     and their adds 4 = 85
MARCH_GRAD_OPS_PER_TRIP = {"nearest": 25, "bilinear": 85}
# the tolerance of the EDF's gradient against autograd through the plain
# loop, relative to its largest cell (the kernel adds the taps with
# atomics, autograd's scatter in another order; the rays' gradients are
# held bit for bit)
GRAD_TOL = 1e-4
# the implicit march's pose VJP (raymarch_diff.implicit_pose_vjp): the
# operations of a hit ray, counted from raymarch_diff._pose_terms and its
# sum (-fmad=false): the direction 6 (ct, st: 2 multiplies and an add
# each), the position 8, the bounds 4, the patch's value 33 and slope 10,
# (ex, ey) 2, dE/dr 3, the gates 5 (val - tau, two |.| and two compares),
# the division 1, the x and y terms 2, the heading's term 5, the sums 3 and
# the hit test 1 = 83; a miss costs its flag's test, 1. Its bytes: each ray's
# cotangent, range and hit flag (9), each agent's x, y, cos and sin of the
# heading and its three outputs (28), each beam's cos and sin (8), once; the
# 4 taps of a hit come from the L2 (the EDF's cells, not counted)
POSE_VJP_OPS_PER_HIT = 83
POSE_VJP_BYTES_PER_RAY = 9
# its sums against the plain version's, relative to the sum of the agent's
# |terms| (float32 sums of 1080 terms in two orders; the terms themselves
# are held bit for bit)
POSE_VJP_SUM_TOL = 1e-5
# agents per block of the gradient's plain run (autograd keeps every
# trip's taps: ~40 MB a trip per 512 x 1080 rays)
GRAD_PLAIN_AGENTS = 512
# soft_edt's modes on the full maps: the hard min and the softmin at 64
# iterations (linear init), and examples/torch/demo_mapping.py's setting
STENCIL_MODES = {
    "hard": dict(iters=64),
    "soft": dict(iters=64, temperature=0.25),
    "demo": dict(iters=96, temperature=0.25, init="log", init_lambda=3.0)}
# tolerances relative to max(1, the largest |plain|), as
# tests/test_torch_kernels.py states them. STENCIL_TOL: the softmin against
# the plain loop and its gradient against the explicit plain backward on
# the same history (the 9 exponentials are summed in another order than
# torch's reduction), and the hard gradient against autograd (whose
# replicate-pad backward adds an edge cell's terms with atomics); the hard
# min and its gradient against the explicit backward are held bit for bit.
# STENCIL_GRAD_TOL: the softmin's gradient against autograd through the
# plain loop, which runs its own forward (fields that differ by ulps), where
# each weight exp(y_i - L) turns the rounding of |L| (up to (iters + 1) / T,
# 388 at the demo's 96 iterations and T = 0.25: an ulp of 3e-5) into a
# relative error of the weight
STENCIL_TOL = 1e-5
STENCIL_GRAD_TOL = 1e-4
# the stencil's operations a cell and iteration, (FP32, SFU), counted from
# the function (ops/soft_edt.py; -fmad=false: each multiply and add its
# own operation; a negation is a sign modifier of the next operation):
#   soft_edt hard: the candidates' 8 adds, 8 minima = 16;
#   soft_edt soft: the candidates 8, y = (-c) * inv_t 9, the maximum 8, its
#     infinity test and select 2, y - m 9, each exponential's scaling by
#     log2(e) 9, the sum 8, the logarithm's scaling by ln(2) 1, + m 1,
#     * neg_t 1 = 56, and 9 exponentials and 1 logarithm (MUFU.EX2 /
#     MUFU.LG2) at the SFU's rate;
#   soft_edt_grad hard: the candidates and the chain's running minima 16
#     (recomputed from the history: the function's input), each of the 8
#     links the halving 1, three compares, three selects = 56, the gather
#     (8 slots into the padded cell, the pad's sum, slot 0) 10 = 82;
#   soft_edt_grad soft: the softmin's L 55 (its 10 SFU), y - L 9 and the
#     weights' scaling 9 (9 SFU), the products g * neg_t 1, * w 9, * inv_t
#     9, the gather 10 = 102, and 19 SFU.
# The SFU (MUFU) pipe runs beside the FP32 pipe, and every instruction,
# MUFU included, takes one issue slot: a cell and iteration take at least
# max(fp32 + sfu, SFU_COST * sfu) FP32 slots, not their sum
STENCIL_OPS = {("soft_edt", "hard"): (16, 0), ("soft_edt", "soft"): (56, 10),
               ("soft_edt_grad", "hard"): (82, 0),
               ("soft_edt_grad", "soft"): (102, 19)}
# an SFU operation in FP32 slots: 16 SFU lanes per SM against 128 FP32
SFU_COST = LANES_PER_SM // 16


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_rates():
    """The card's FP32 instruction rate (SMs x lanes x the maximum SM clock
    that nvidia-smi reports) and HBM rate: what the bounds divide by."""
    import torch
    props = torch.cuda.get_device_properties(0)
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    except (ValueError, IndexError):    # "[N/A]": take PyTorch's figure
        mhz = props.clock_rate / 1e3
    sms = props.multi_processor_count
    return {"sm_clock_max_mhz": mhz, "sms": sms,
            "slots_per_s": sms * LANES_PER_SM * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def timed_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn(i)`` over ``reps`` calls, after
    ``warmup`` calls; CUDA events on the card."""
    from pyracecarsimulator_tpu_torch.utils.profiling import timed_loop
    return timed_loop(fn, reps=reps, warmup=warmup, index=True,
                      device="cuda") * 1e3


def graphed_ms(fn, calls=50, reps=5):
    """Device milliseconds per call of ``fn(i)``, ``calls`` calls captured
    in one CUDA graph and the graph replayed ``reps`` times between CUDA
    events: for a kernel shorter than its wrapper's host time, which
    ``timed_ms`` would measure instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def wrappers():
    """The wrappers of ``KERNELS`` from the port's registry."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    by_name = _kernels.wrappers()
    return {name: by_name[name] for name in KERNELS}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    return {name: w.launches for name, w in wrappers().items()}


def list_args(table, meta, ids, p, ct, st):
    """The list sweep's arguments for poses ``p`` (A, 3) whose padded fan
    (ct, st) (A, NBLK*bb) routes row by row to ``ids`` (A, NBLK)."""
    from pyracecarsimulator_tpu_torch.ops.common import _ray_invs
    g = ids.numel()
    nblk = g // p.shape[0]
    bb = ct.shape[1] // nblk
    ic, is_ = _ray_invs(ct, st)
    return (table, meta, ids.reshape(g).contiguous(),
            p[:, 0].repeat_interleave(nblk).contiguous(),
            p[:, 1].repeat_interleave(nblk).contiguous(),
            *(v.reshape(g, bb).contiguous() for v in (ct, st, ic, is_)))


def sector_case(smap, p):
    """(fan, args of the list sweep) of the sector scan of poses ``p``."""
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    ct, st = rs.fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                        p.device))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, p[:, 0], p[:, 1], ct, st, bb)
    return (ct, st), list_args(smap.table, smap.meta, ids, p, ct, st)


def segment_case(segmap, p):
    """(fan, args of the sweep the default segments path runs) for poses
    ``p``: the tile route on tiled maps, the dense sweep otherwise."""
    from pyracecarsimulator_tpu_torch.ops.common import (
        _padded_offsets, _ray_invs, beam_angles, fan_cos_sin, tile_ids)
    if segmap.tiles is not None:
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(BEAMS, FOV, 128,
                                                      p.device))
        nblk = ct.shape[1] // 128
        tid = tile_ids(segmap.tiles_shape, segmap.tile_size,
                       segmap.tile_origin, p[:, 0], p[:, 1])
        ids = tid[:, None].expand(-1, nblk).to(segmap.tile_sweep_meta.dtype)
        return (ct, st), list_args(segmap.tiles, segmap.tile_sweep_meta,
                                   ids, p, ct, st)
    ct, st = fan_cos_sin(p[:, 2], beam_angles(BEAMS, FOV, p.device))
    ic, is_ = _ray_invs(ct, st)
    flat = lambda v: v.reshape(-1).contiguous()
    return (ct, st), (segmap.params, segmap.sweep_meta,
                      flat(p[:, 0:1].expand(ct.shape)),
                      flat(p[:, 1:2].expand(ct.shape)),
                      *map(flat, (ct, st, ic, is_)))


def plain_of(name):
    from pyracecarsimulator_tpu_torch.ops import sweeps
    return {"dense_sweep": sweeps.dense_sweep_plain,
            "list_scan": sweeps.list_scan_plain}.get(name,
                                                     sweeps.list_sweep_plain)


def bound_of(name, args, rates):
    """The least time the card could take for one call of wrapper ``name``
    on ``args``: the larger of instruction slots over the instruction rate
    and bytes over the HBM rate. The dense sweep's tests are counted from
    its real slots. The list kernel's are its kept slots' tests (the slots
    its wedge cull keeps, from ``tests/torch_cull_cases.py``'s
    ``cull_masks``, apart from the kernel) plus ``CULL_OPS_PER_SLOT`` a
    real slot of each row long enough to cull; its bytes count each
    visited list, each ray tensor and each output once, and beside them
    stand the staged bytes (12 a real slot a row, read from L2) and the
    old bound from every real slot's tests, which no longer bounds the
    kernel."""
    import torch
    if name == "dense_sweep":
        params, sweep_meta, x = args[0], args[1], args[2]
        k = params.shape[1]
        v_hi, h_lo, h_end = (int(v) for v in sweep_meta.tolist())
        h_lo = min(max(h_lo, 0), k)
        slots = min(max(v_hi, 0), k) + min(max(h_end, h_lo), k) - h_lo
        rays = x.numel()
        tests = rays * slots
        nbytes = 12 * slots + 12 + 4 * rays * (6 + 2)
        extra = {}
    else:
        from pyracecarsimulator_tpu_torch.ops.sweeps import CULL_MIN_SLOTS
        table, meta, ids, _, _, ct = args[:6]
        k = table.shape[2]

        def real_slots(rows):
            m = meta[rows.long()].long()
            h_lo = m[:, 1].clamp(0, k)
            nv = torch.minimum(m[:, 0].clamp(min=0), h_lo)
            return nv + torch.maximum(m[:, 2], h_lo).clamp(max=k) - h_lo

        g, bb = ct.shape
        cases = helper_module("torch_cull_cases")
        kept = int(cases.cull_masks(args)[1].sum())
        real = real_slots(ids)
        tests = kept * bb
        culled = int(real[real >= CULL_MIN_SLOTS].sum())
        uniq = torch.unique(ids)
        nbytes = (12 * int(real_slots(uniq).sum()) + 12 * uniq.numel()
                  + 12 * g + 4 * g * bb * (4 + 2))
        slot_tests = int(real.sum()) * bb
        extra = {"kept_slots": kept, "real_slots": int(real.sum()),
                 "cull_ops": culled * CULL_OPS_PER_SLOT,
                 "staged_bytes": 12 * int(real.sum()),
                 "old_slot_bound_ms": slot_tests * OPS_PER_TEST
                 / rates["slots_per_s"] * 1e3}
    ops = tests * OPS_PER_TEST + extra.get("cull_ops", 0)
    ops_ms = ops / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    out = {"tests": tests, "bytes": nbytes, "bound_ops_ms": ops_ms,
           "bound_bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           **extra}
    # what the compiled loop spends per test (sass_report), where known:
    # the time its instruction stream needs at the full instruction rate
    per_test = rates.get("sass_per_test", {}).get(
        "dense_sweep" if name == "dense_sweep" else "sector_sweep")
    if per_test:
        out["compiled_slots_ms"] = (tests * per_test / rates["slots_per_s"]
                                    * 1e3)
    return out


def sass_report():
    """Where the toolkit has cuobjdump: the instructions each built
    kernel spends per ray-segment test, read from its SASS. A sweep loop
    is a backward branch whose body holds FSEL instructions, one per test
    (the select of the new minimum); the loop's instruction count over its
    FSEL count is what the compiled code spends per test, against the
    ``OPS_PER_TEST`` the function needs at least. With ``CHIP_SMOKE_OUT``
    set, the SASS is also written into that directory."""
    import shutil
    from pyracecarsimulator_tpu_torch.ops import _kernels
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: the instruction slots per test are reasoned "
            "from the sources")
        return {}
    out_dir = os.environ.get("CHIP_SMOKE_OUT")
    report = {}
    for name, info in _kernels.build_info.items():
        sass = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True,
                              timeout=120).stdout
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"sass_{name}.txt"), "w") as f:
                f.write(sass)
        if name == "edf_march":
            report[name] = march_sass(sass)
            continue
        if name == "general_sweep":
            report[name] = general_sass(sass)
            continue
        if name == "soft_edt":     # no sweep loop: nvcc's report above
            continue
        loops = []
        for body in innermost_loops(sass):
            if "FSEL" in body:
                mix = {o: body.count(o) for o in sorted(set(body))}
                loops.append({"instructions": len(body),
                              "tests": mix["FSEL"],
                              "per_test": len(body) / mix["FSEL"],
                              "mix": mix})
        report[name] = loops
        for lp in loops:
            log(f"{name}: SASS sweep loop of {lp['tests']} test(s): "
                f"{lp['instructions']} instructions = {lp['per_test']:.2f} "
                f"per test {lp['mix']}")
        check(loops, f"{name}: no sweep loop found in the SASS")
    return report


def innermost_loops(sass, full=False):
    """Each innermost loop of a SASS listing (a backward branch with no
    other backward branch inside it), function by function: addresses
    restart at every function. A loop is its opcodes without their
    suffixes ("LDS" for "LDS.128"), or with ``full`` its (address, opcode
    with its suffixes, branch target or None) triples."""
    loops = []
    for fn in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        ins = [(int(a, 16), op, int(tgt, 16) if tgt else None)
               for a, op, tgt in
               re.findall(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)"
                          r"(?:[^;]*?\s(0x[0-9a-f]+)\s*;)?", fn, flags=re.M)]
        back = [(tgt, addr) for addr, op, tgt in ins
                if op.split(".")[0] == "BRA" and tgt is not None
                and tgt < addr]
        for lo, hi in back:
            if any((a, b) != (lo, hi) and lo <= a and b <= hi
                   for a, b in back):
                continue                 # not innermost
            body = [i for i in ins if lo <= i[0] <= hi]
            loops.append(body if full else
                         [op.split(".")[0] for _, op, _ in body])
    return loops


def march_sass(sass):
    """What a trip of each variant's march loop issues: per function of
    the march kernel (one per variant, the template argument in its name),
    the longest innermost loop that gathers (LDG), one trip a pass; for
    the implicit variant the longest that gathers fewer than 4 times (its
    trip), and its bisection, the loop of 4 gathers, one bisection a pass
    (as "implicit bisection"). A reading beside the bound, which counts
    the function's operations."""
    out = {}
    names = {f"ILi{i}E": v for i, v in enumerate(MARCH_VARIANTS)}
    for fn in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        head = fn.splitlines()[0]
        variant = next((v for k, v in names.items() if k in head), None)
        loops = [b for b in innermost_loops("Function : " + fn)
                 if "LDG" in b]
        if "edf_march_kernel" not in head or variant is None or not loops:
            continue
        parts = {variant: loops}
        if variant == "implicit":
            parts = {variant: [b for b in loops if b.count("LDG") < 4],
                     "implicit bisection": [b for b in loops
                                            if b.count("LDG") >= 4]}
        for label, found in parts.items():
            if not found:
                continue
            body = max(found, key=len)
            out[label] = {"instructions": len(body),
                          "mix": {o: body.count(o) for o in sorted(set(body))}}
            need = (f"{MARCH_OPS_PER_TRIP[label]} a trip" if label in
                    MARCH_OPS_PER_TRIP
                    else f"{REFINE_OPS_PER_BISECTION} a bisection")
            log(f"edf_march {label}: SASS loop of {len(body)} instructions "
                f"a pass (the function needs {need}) {out[label]['mix']}")
    return out


def general_sass(sass):
    """What a pass of the general sweep's slot loop issues, per mode (the
    template argument in the function's name): the innermost loop that
    reads the staged slots as 16-byte loads (LDS.128, one a slot), its
    slots and pairs a pass (a slot feeds the source's ``kRays`` rays of a
    thread), its instructions a pair, and those a pair issues where every
    ray skips the slot (the loop without the code that its forward
    branches jump over: the division's path). A reading beside the bound,
    which counts the function's operations."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), SRC,
                       "general_sweep.cu")
    with open(src) as f:
        rays = int(re.search(r"constexpr int kRays = (\d+);",
                             f.read()).group(1))
    out = {}
    for fn in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        head = fn.splitlines()[0]
        mode = ("winner" if "ILb1E" in head else "min" if "ILb0E" in head
                else None)
        if "general_sweep_kernel" not in head or mode is None:
            continue
        best = None
        for body in innermost_loops("Function : " + fn, full=True):
            slots = sum(op.startswith("LDS") and op.endswith(".128")
                        for _, op, _ in body)
            if slots and (best is None or slots > best[0]):
                best = (slots, body)
        if best is None:
            continue
        slots, body = best
        jumped = set()
        for a, op, t in body:
            if op.split(".")[0] == "BRA" and t is not None and t > a:
                jumped.update(x for x, _, _ in body if a < x < t)
        skip_path = [op for a, op, _ in body if a not in jumped]
        ops = [op.split(".")[0] for _, op, _ in body]
        pairs = slots * rays
        out[mode] = {"instructions": len(body), "slots": slots,
                     "rays_a_thread": rays, "pairs": pairs,
                     "per_pair": len(body) / pairs,
                     "skip_path_instructions": len(skip_path),
                     "skip_path_per_pair": len(skip_path) / pairs,
                     "mix": {o: ops.count(o) for o in sorted(set(ops))}}
        log(f"general_sweep {mode}: SASS loop of {len(body)} instructions "
            f"a pass of {slots} slots x {rays} rays = "
            f"{out[mode]['per_pair']:.2f} a pair, "
            f"{out[mode]['skip_path_per_pair']:.2f} a skipped pair (the "
            f"function needs {TEST_OPS_PER_PAIR} to skip, "
            f"{TEST_OPS_PER_PAIR + OPS_PER_PAIR - TEST_SHARED_OPS} for a "
            f"pair that wins) {out[mode]['mix']}")
    return out


def general_case(gmap, p):
    """The general sweep's arguments for the scan of poses ``p`` (A, 3) on
    the simplified map ``gmap``, as ``raycast_general`` hands them over:
    the tiles and the agents' tile ids, or the (6, K) table as one list
    and no ids; the fan's rays, the origins as expanded views."""
    from pyracecarsimulator_tpu_torch.ops.common import (rays_from_poses,
                                                         tile_ids)
    _, q, xb, yb, ct, st = rays_from_poses(p, BEAMS, FOV)
    if gmap.tiles is not None:
        return (gmap.tiles, tile_ids(gmap.tiles_shape, gmap.tile_size,
                                     gmap.tile_origin, q[:, 0], q[:, 1]),
                xb, yb, ct, st)
    return (gmap.params[None], None, xb, yb, ct, st)


def helper_module(name):
    """``tests/<name>.py``, a helper module of the tests (no JAX)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def general_cases():
    """``tests/torch_general_cases.py``: the general sweep's adversarial
    set and its pair counter."""
    return helper_module("torch_general_cases")


def general_bound(args, winner, rates):
    """The least time the card could take for one general sweep on
    ``args``: the larger of the operations (``TEST_OPS_PER_PAIR`` for each
    real pair, each ray against the real slots (length >= 0) of its list,
    plus the ``OPS_PER_PAIR - TEST_SHARED_OPS`` that the test did not count
    for each pair that lowers or ties the running minimum,
    ``general_pair_counts`` of ``tests/torch_general_cases.py``) over the
    instruction rate, and the
    bytes (each visited list's real slots, 5 rows of float32, each row's
    list id and origin, each ray's direction, each output once: 4 bytes a
    ray for the minimum, 12 with the winner) over the HBM rate. Beside it
    ``bound_27_ms``: ``OPS_PER_PAIR`` for every real pair, the bound
    before the kernel skipped divisions."""
    import torch
    table, ids, _, _, ct, _ = args
    n = general_cases().general_pair_counts(args, winner)
    pairs, full = n["pairs"], n["full_pairs"]
    real = (table[:, 4, :] >= 0).sum(dim=1)
    rows, cols = ct.shape
    lists = (ids.long() if ids is not None else
             torch.zeros(rows, dtype=torch.long, device=ct.device))
    nbytes = (20 * int(real[torch.unique(lists)].sum())
              + (4 if ids is not None else 0) * rows + 8 * rows
              + 8 * rows * cols + (12 if winner else 4) * rows * cols)
    ops_ms = ((pairs * TEST_OPS_PER_PAIR
               + full * (OPS_PER_PAIR - TEST_SHARED_OPS))
              / rates["slots_per_s"] * 1e3)
    ops27_ms = pairs * OPS_PER_PAIR / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    out = {"pairs": pairs, "full_pairs": full,
           "full_pairs_a_ray": full / (rows * cols),
           "slots": table.shape[2],
           "mean_real_slots": pairs / (rows * cols), "bytes": nbytes,
           "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_27_ms": max(ops27_ms, bytes_ms)}
    sass = rates.get("general_sass", {}).get("winner" if winner else "min")
    if sass:
        out["sass_per_pair"] = sass["per_pair"]
        out["sass_skip_path_per_pair"] = sass["skip_path_per_pair"]
    return out


def resource_report(source, label_of):
    """``{label: {"registers", "stack", "spill_stores", "shared"}}`` from
    nvcc's ``--resource-usage`` report of this build of
    ``csrc/<source>.cu``: one entry a kernel whose mangled name
    ``label_of`` maps to a label (None leaves it out), the fields of its
    records merged."""
    from pyracecarsimulator_tpu_torch.ops import _kernels
    text = _kernels.build_info.get(source, {}).get("log", "")
    fields = (("registers", (r"REG:(\d+)", r"Used (\d+) registers")),
              ("stack", (r"STACK:(\d+)", r"(\d+) bytes stack frame")),
              ("spill_stores", (r"(\d+) bytes spill stores",)),
              ("shared", (r"SHARED:(\d+)", r"(\d+) bytes smem")))
    out = {}
    for chunk in re.split(r"Function (?:properties for )?", text)[1:]:
        label = label_of(chunk.split()[0].rstrip(":"))
        if label is None:
            continue
        res = out.setdefault(label, {})
        for key, pats in fields:
            hit = next((h for h in (re.search(p, chunk) for p in pats) if h),
                       None)
            if hit:
                res[key] = int(hit.group(1))
    return out


def list_resources():
    """Both instantiations of ``list_sweep_kernel`` (rays given, from
    poses): registers, stack frame, spills and static shared memory from
    nvcc's ``--resource-usage`` report of this build. Neither may spill
    nor have a stack frame, and the rays-given one keeps 32 registers."""
    def label_of(name):
        m = re.search(r"list_sweep_kernelILb([01])E", name)
        return m and ("from poses" if m.group(1) == "1" else "rays given")
    out = resource_report("sector_sweep", label_of)
    for label, res in sorted(out.items()):
        log(f"list_sweep_kernel, {label}: {res}")
    check(set(out) == {"rays given", "from poses"},
          f"the list kernel's two entries are not in nvcc's report: {out}")
    check(all(r.get("spill_stores", 0) == 0 and r.get("stack", 0) == 0
              for r in out.values())
          and out["rays given"].get("registers") == 32,
          f"a list kernel entry spills, has a stack frame, or the rays-given "
          f"one left 32 registers: {out}")
    return out


def dense_resources():
    """``dense_sweep_kernel``'s registers, stack frame and spills from
    nvcc's ``--resource-usage`` report of this build: no spill, no stack
    frame, and the ``DENSE_REGISTERS`` it had before it counted its
    work."""
    out = resource_report(
        "dense_sweep",
        lambda name: "dense_sweep_kernel" if "dense_sweep_kernel" in name
        else None).get("dense_sweep_kernel", {})
    log(f"dense_sweep_kernel: {out}")
    check(out.get("registers") == DENSE_REGISTERS
          and out.get("spill_stores", 0) == 0 and out.get("stack", 0) == 0,
          f"dense_sweep_kernel spills, has a stack frame, or left its "
          f"{DENSE_REGISTERS} registers: {out}")
    return out


def list_scan_args(table, meta, ids, p, bb, extent):
    """The list kernel's entry from poses: its arguments for poses ``p``
    (A, 3) routed to ``ids`` (A, NBLK) in blocks of ``bb`` beams."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.common import offset_factors
    return (table, meta, ids.to(torch.int32).contiguous(),
            p[:, 0].contiguous(), p[:, 1].contiguous(),
            torch.cos(p[:, 2]), torch.sin(p[:, 2]),
            *offset_factors(BEAMS, FOV, bb, p.device), MAX_RANGE, extent,
            BEAMS)


def composed_scan(args):
    """What ``list_scan`` replaces, with the rays-given kernel: the fan,
    the reciprocals, ``list_sweep``, the clamp, the slice to the real
    beams and the extent mask. Returns (ranges, the sweep's arguments)."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.common import (
        apply_extent_mask, finish_minima, rotate_fan)
    table, meta, ids, x0, y0, cth, sth, cd, sd, max_range, extent, nb = args
    ct, st = rotate_fan(cth, sth, cd, sd)
    rows = list_args(table, meta, ids, torch.stack([x0, y0], 1), ct, st)
    bv, bh = wrappers()["list_sweep"](*rows)
    r = finish_minima(bv.reshape(ct.shape), bh.reshape(ct.shape),
                      max_range)[0]
    return apply_extent_mask(r[:, :nb], x0, y0, extent, max_range), rows


def list_scan_phase(card, name, smap, segmap, poses, rates, errs, times):
    """25: per map, ``list_scan`` (the list kernel's entry from poses) on
    the sector table and on the map tiles (where the map has them) at
    4096 x 1080, one origin moved outside the map's extent: against
    ``list_scan_plain`` and against the composition it replaces with the
    rays-given kernel, 0 mismatches, the kept slots equal and every row
    counted as fanned (none by the rays-given kernel); device times from
    graph replays of the entry, of the composition and of the rays-given
    kernel alone, the plain time, and the bound."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops.common import (mid_offset_factors,
                                                         rotate_fan)
    from pyracecarsimulator_tpu_torch.ops.raycast_grad import tile_rows
    from pyracecarsimulator_tpu_torch.ops.sweeps import SWEEP_COUNTS
    sets = pose_sets(poses)
    for q in sets:
        q[0, 0] = smap.extent[1] + 1.0      # outside: all max_range
    kinds = [("sectors", smap.table, smap.meta, smap,
              rs.sector_block_width(smap, BEAMS, FOV))]
    if segmap.tiles is not None:
        kinds.append(("tiles", segmap.tiles, segmap.tile_sweep_meta, segmap,
                      128))
    scan = wrappers()["list_scan"]
    out = {}
    for kind, table, meta, m, bb in kinds:
        def case(q):
            if kind == "tiles":
                ids = tile_rows(m.tiles_shape, m.tile_size, m.tile_origin,
                                q[:, 0], q[:, 1], -(-BEAMS // bb))
            else:
                ids = rs._sector_ids(
                    m.tiles_shape, m.tile_size, m.tile_origin, m.ns, q[:, 0],
                    q[:, 1], *rotate_fan(torch.cos(q[:, 2]),
                                         torch.sin(q[:, 2]),
                                         *mid_offset_factors(BEAMS, FOV, bb,
                                                             q.device)))
            return list_scan_args(table, meta, ids, q, bb, m.extent)
        args = [case(q) for q in sets]
        label = f"{name} {kind}"
        counted = lambda: dict(SWEEP_COUNTS)
        c0, h0 = counted(), dict(SWEEP_COUNTS.host)
        r = scan(*args[0])
        r_p = plain_of("list_scan")(*args[0])
        plain = {k: SWEEP_COUNTS.host[k] - h0[k] for k in h0}
        c1 = counted()
        r_c, rows = composed_scan(args[0])
        c2 = counted()
        torch.cuda.synchronize()
        kernel = {k: c1[k] - c0[k] - plain[k] for k in c0}
        given = {k: c2[k] - c1[k] for k in c1}
        mism = int((r != r_p).sum()) + int((r != r_c).sum())
        err = max(float((r.double() - r_p.double()).abs().max()),
                  float((r.double() - r_c.double()).abs().max()))
        outside = bool((r[0] == MAX_RANGE).all())
        log(f"[{label}] list_scan vs list_scan_plain and vs the composition "
            f"with list_sweep on {tuple(r.shape)}: mismatches {mism}, max abs "
            f"err {err}; the origin outside the extent all max_range "
            f"{outside}; counted by the entry {kernel}, by the plain version "
            f"{plain}, by the rays-given kernel {given}")
        check(mism == 0 and outside, f"{label}: list_scan disagrees")
        check(kernel == plain and kernel["fanned"] == kernel["rows"]
              and given["fanned"] == 0
              and {k: given[k] for k in ("slots", "rows", "kept")}
              == {k: kernel[k] for k in ("slots", "rows", "kept")},
              f"{label}: list_scan counts other work than the rays-given "
              "kernel or the plain version")
        errs["list_scan"].append(err)
        n = len(args)
        res = {"ms": graphed_ms(lambda i: scan(*args[i % n])),
               "composed_ms": graphed_ms(lambda i: composed_scan(
                   args[i % n])),
               "list_sweep_alone_ms": graphed_ms(
                   lambda i, rows=rows: wrappers()["list_sweep"](*rows)),
               "plain_ms": timed_ms(lambda i: plain_of("list_scan")(
                   *args[i % n]), 3, warmup=1)}
        res["ms_2"] = graphed_ms(lambda i: scan(*args[i % n]))
        sweep = bound_of("list_sweep", rows, rates)
        a_n = r.shape[0]
        rays = rows[5].numel()
        ops = sweep["tests"] * OPS_PER_TEST + sweep["cull_ops"] + (
            FAN_OPS_PER_RAY * rays)
        nbytes = 4 * a_n * BEAMS + sweep["staged_bytes"]
        ops_ms = ops / rates["slots_per_s"] * 1e3
        bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
        res.update({"bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
                    "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes", "range_bytes": 4 * a_n * BEAMS,
                    "staged_bytes": sweep["staged_bytes"],
                    "kept_slots": sweep["kept_slots"],
                    "real_slots": sweep["real_slots"]})
        res["share_of_bound"] = res["bound_ms"] / min(res["ms"], res["ms_2"])
        times["list_scan"][label] = res
        log(f"[{label}] {card}: list_scan {res['ms']:.4f} / "
            f"{res['ms_2']:.4f} ms from graph replays, the composition it "
            f"replaces {res['composed_ms']:.4f} ms (list_sweep alone "
            f"{res['list_sweep_alone_ms']:.4f}), plain "
            f"{res['plain_ms']:.2f} ms; bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}; bytes {res['bound_bytes_ms']:.4f}: the "
            f"range {res['range_bytes']} B and the staged slots "
            f"{res['staged_bytes']} B)")
        out[kind] = res
    return out


def kernel_vs_plain(label, name, args):
    """One launch of wrapper ``name`` against its plain version on the same
    tensors; 0 mismatches required, and the work the kernel adds to its
    device counter equal to what the plain version counts on the host: the
    list kernel's rows and real slots, the slots its wedge cull keeps
    included (``sweeps.SWEEP_COUNTS``), the dense kernel's rays and pairs
    (``sweeps.DENSE_COUNTS``). Returns the max abs error."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.sweeps import (DENSE_COUNTS,
                                                         SWEEP_COUNTS)
    counts = DENSE_COUNTS if name == "dense_sweep" else SWEEP_COUNTS
    before, host = dict(counts), dict(counts.host)
    bv, bh = wrappers()[name](*args)
    kernel = {k: counts[k] - before[k] for k in before}
    bv_p, bh_p = plain_of(name)(*args)
    plain = {k: counts.host[k] - host[k] for k in host}
    torch.cuda.synchronize()
    mism = int(((bv != bv_p) | (bh != bh_p)).sum())
    err = max(float((bv.double() - bv_p.double()).abs().max()),
              float((bh.double() - bh_p.double()).abs().max()))
    per_row = ""
    if kernel.get("rows"):
        per_row = (f"; a row {kernel['slots'] / kernel['rows']:.2f} real "
                   f"slots, {kernel['kept'] / kernel['rows']:.2f} kept")
    if kernel.get("rays"):
        per_row = f"; {kernel['pairs'] / kernel['rays']} pairs a ray"
    log(f"[{label}] {name} vs plain on {tuple(bv.shape)} rays: (bv, bh) "
        f"mismatches = {mism}, max abs err = {err}; counted by the kernel "
        f"{kernel}, by the plain version {plain}{per_row}")
    check(mism == 0, f"{label}: {name} disagrees with its plain version")
    check(kernel == plain, f"{label}: {name} counts other work than its "
          "plain version")
    return err


def scan_checks(label, track, scan_rays, dev_map, cpu_map, poses, fan):
    """``scan_rays(map, poses, ct, st)`` on the card against the same on
    the CPU (same fan, 64 poses), and against the float64 oracle (8
    poses)."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch.maps.segments import (
        extract_segments, raycast_segments_numpy)
    ct, st = fan
    p = torch.as_tensor(poses[:64], device="cuda")
    r_dev = scan_rays(dev_map, p, ct[:64], st[:64]).cpu()
    r_cpu = scan_rays(cpu_map, p.cpu(), ct[:64].cpu(), st[:64].cpu())
    same = bool(torch.equal(r_dev, r_cpu))
    log(f"[{label}] scan on cuda vs CPU plain scan, same fan, 64 poses: "
        f"bit-identical = {same}")
    check(same, f"{label}: device scan differs from the CPU scan")
    segs = extract_segments(track.occupancy.cpu().numpy(), track.resolution,
                            (track.origin_x, track.origin_y))
    k = 8
    c64, s64 = (v[:k, :BEAMS].cpu().numpy().astype(np.float64)
                for v in (ct, st))
    ora = np.stack([raycast_segments_numpy(
        segs, np.full(BEAMS, poses[i, 0], np.float64),
        np.full(BEAMS, poses[i, 1], np.float64), c64[i], s64[i], MAX_RANGE)
        for i in range(k)])
    d = np.abs(r_dev[:k].numpy() - ora)
    share = float(np.mean(d <= 1e-4))
    log(f"[{label}] scan vs float64 brute-force oracle ({len(segs)} "
        f"segments, {k} poses): share within 1e-4 m = {share}, max abs "
        f"diff = {float(d.max())}")
    check(share >= 0.999, f"{label}: scan disagrees with the oracle")


def time_kernel(name, sets, rates, plain_reps=5):
    """Kernel, plain, kernel over the argument sets in turn, beside the
    bound of the first set."""
    w, plain = wrappers()[name], plain_of(name)
    n = len(sets)
    k_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    p_ms = timed_ms(lambda i: plain(*sets[i % n]), plain_reps, warmup=1)
    k2_ms = timed_ms(lambda i: w(*sets[i % n]), 50)
    out = {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms,
           **bound_of(name, sets[0], rates)}
    out["share_of_bound"] = out["bound_ms"] / min(k_ms, k2_ms)
    if name == "dense_sweep":
        out.update(dense_graphed(w, sets))
        out["graphed_share_of_bound"] = out["bound_ms"] / min(
            out["graphed_ms"], out["graphed_ms_2"])
    return out


def dense_graphed(w, sets):
    """The dense kernel's device time a call from CUDA graph replays
    (``graphed_ms``, twice), and its counter over them: each eager warm-up
    call and each replayed call adds its rays and their pairs, so the
    counter grows by exactly 2 x (3 + 6 x 50) calls' worth."""
    from pyracecarsimulator_tpu_torch.ops.sweeps import DENSE_COUNTS
    n = len(sets)
    rays = sets[0][2].numel()
    v_hi, h_lo, h_end = sets[0][1].tolist()
    before = dict(DENSE_COUNTS)
    ms = [graphed_ms(lambda i: w(*sets[i % n])) for _ in range(2)]
    grown = {k: DENSE_COUNTS[k] - before[k] for k in before}
    calls = 2 * (3 + 6 * 50)
    want = {"rays": calls * rays,
            "pairs": calls * rays * (v_hi + h_end - h_lo)}
    log(f"dense_sweep from graph replays: {ms[0]:.4f} / {ms[1]:.4f} ms a "
        f"call; counted {grown} over {calls} calls (want {want})")
    check(grown == want, "dense_sweep's counter missed graph replays")
    return {"graphed_ms": ms[0], "graphed_ms_2": ms[1],
            "pairs_per_ray": grown["pairs"] / grown["rays"]}


def pose_sets(poses, n=5):
    import torch
    out = []
    for j in range(n):
        p = torch.as_tensor(poses, device="cuda").clone()
        p[:, 2] += j * 1e-3
        out.append(p)
    return out


def drive(bundles, backend_label, poses_by_map):
    """One step and a STEPS-step noisy rollout per map, counted. Returns
    {map: launch counts} and checks the outputs."""
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.ops.sweeps import DENSE_COUNTS
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn)
    used = {}
    for name, bundle in bundles.items():
        step = make_step_fn(bundle, with_noise=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        state0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        run_fn = make_rollout_fn(step, make_gap_follower_policy(
            BEAMS, bundle.scan.fov), STEPS, BEAMS)
        reset_counts()
        dense0 = dict(DENSE_COUNTS)
        first = step(state0, act, gen)
        final, traj = run_fn(state0, gen)
        torch.cuda.synchronize()
        used[name] = {k: v for k, v in counts().items() if v}
        dense = {k: DENSE_COUNTS[k] - dense0[k] for k in dense0}
        if used[name].get("dense_sweep"):
            scans = used[name]["dense_sweep"]
            log(f"[{name}] {backend_label} main path: the dense counter "
                f"{dense}, {dense['pairs'] / dense['rays']} pairs a ray")
            check(dense == {"rays": scans * AGENTS * BEAMS,
                            "pairs": scans * AGENTS * BEAMS
                            * bundle.segmap.n_segments},
                  f"{name}: the dense counter is not every ray against "
                  f"every segment: {dense}")
        log(f"[{name}] {backend_label} main path (1 step + {STEPS}-step "
            f"rollout, graphed where the step can be captured: "
            f"{step.capturable}): launches {used[name]}")
        check(tuple(first.ranges.shape) == (AGENTS, BEAMS)
              and tuple(traj["pose"].shape) == (STEPS, AGENTS, 3)
              and tuple(traj["collision"].shape) == (STEPS, AGENTS),
              f"{name}: output shapes")
        for t in (first.ranges, final.x, final.y, final.theta, traj["pose"]):
            check(t.device.type == "cuda" and bool(torch.isfinite(t).all()),
                  f"{name}: outputs not finite or not on the card")
        r = first.ranges
        log(f"[{name}] {backend_label} step ranges mean "
            f"{float(r.mean()):.4f} m, min {float(r.min()):.4f}, max "
            f"{float(r.max()):.4f}; after {STEPS} steps "
            f"{int(traj['collision'][-1].sum())} of {AGENTS} cars latched, "
            f"mean speed {float(final.velocity.mean()):.3f} m/s")
    return used


def step_ms(bundle, poses, reps=50):
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    step = make_step_fn(bundle, with_noise=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.as_tensor(poses, device="cuda")
    state = [state_from_pose(p[:, 0], p[:, 1], p[:, 2])]
    act = (torch.full((AGENTS,), 2.0, device="cuda"),
           torch.zeros(AGENTS, device="cuda"))

    def one(i):
        state[0] = step(state[0], act, gen).state
    return timed_ms(one, reps, warmup=min(5, reps))


def train_phase(bundle, poses, label):
    """3 BPTT train steps at full width on the default path (one CUDA
    graph); returns (losses, train-step ms, launch counts of the 3 steps
    and the capture's 2 warm-up steps)."""
    import torch
    from pyracecarsimulator_tpu_torch import (SimParams, make_step_fn,
                                              state_from_pose)
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    bundle = bundle._replace(sim=SimParams(steer_mode="smooth"))
    step = make_step_fn(bundle, with_noise=False)

    def policy(params, state, ranges, t):
        steer = torch.tanh(ranges @ params["w"] + params["b"])
        return torch.full(state.batch_shape, 2.0, device="cuda"), steer

    def loss_fn(out, t):
        return (torch.mean((out.ranges - 10.0) ** 2)
                + 10.0 * torch.mean(out.collision.float()))

    train, init = make_bptt_train_fn(
        step, policy, loss_fn, TRAIN_T, BEAMS,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=3e-3,
                                              capturable=True))
    params = {"w": torch.zeros(BEAMS, device="cuda"),
              "b": torch.zeros((), device="cuda")}
    opt = init(params)
    p = torch.as_tensor(poses, device="cuda")
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    reset_counts()
    losses = []
    for _ in range(3):
        params, opt, loss, final = train(params, opt, s0)
        losses.append(float(loss))
    used = {k: v for k, v in counts().items() if v}
    moved = float(params["w"].detach().abs().sum())
    log(f"[berlin] {label} BPTT, {TRAIN_T} steps x {AGENTS} x {BEAMS}: "
        f"losses {losses}, |w|_1 after 3 Adam steps {moved}, launches "
        f"{used}")
    check(all(math.isfinite(v) for v in losses),
          f"{label}: training loss not finite")
    check(moved > 0, f"{label}: parameters did not move")
    ms = timed_ms(lambda i: train(params, opt, s0), 3, warmup=1)
    return losses, ms, used


def device_ops(fn):
    """CUDA kernels and copies one call of ``fn()`` puts on the card,
    counted by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA))


def same_fan_check(label, fn, dev_args, exact=True, tol=0.0):
    """``fn(*args)`` on the card against ``fn`` on CPU copies of the same
    tensors and maps: bit-identical (``exact``) or within ``tol``."""
    import torch
    cpu = [a.to("cpu") for a in dev_args]
    got = fn(*dev_args).cpu()
    ref = fn(*cpu)
    err = float((got.double() - ref.double()).abs().max())
    same = bool(torch.equal(got, ref))
    log(f"[{label}] cuda vs CPU on {tuple(got.shape)}: bit-identical = "
        f"{same}, max abs err = {err}")
    check(same if exact else err <= tol, f"{label}: cuda differs from CPU")
    return err


def march_resources():
    """Each march and gradient kernel's (and the pose VJP's) registers,
    stack frame, spills and static shared memory from nvcc's
    ``--resource-usage`` report of this build.
    No kernel may spill, and only the bilinear gradient has a stack frame:
    its ``GRAD_SLOTS`` positions a thread (8 bytes each)."""
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx

    def label_of(name):
        m = re.search(r"edf_march(_grad)?_kernelILi(\d)EE", name)
        if "implicit_pose_vjp_kernel" in name:
            return "implicit_pose_vjp"
        return m and (f"edf_march{m.group(1) or ''} "
                      f"{list(MARCH_VARIANTS)[int(m.group(2))]}")
    out = resource_report("edf_march", label_of)
    for label, res in sorted(out.items()):
        log(f"{label}: {res}")
    check(out, "no march kernel in nvcc's resource report")
    frames = {k: 8 * rx.GRAD_SLOTS if k == "edf_march_grad bilinear" else 0
              for k in out}
    check(all(r.get("spill_stores", 0) == 0 and r.get("stack", 0) == frames[k]
              for k, r in out.items()),
          f"a march kernel spills or has another stack frame: {out}")
    return out


def march_bound(edf, xb, trips, variant, rates, grad=None, refined=0):
    """The least time the card could take for one march of these rays
    (``grad`` None) or for its gradient (``grad`` = (EDF's, rays')): the
    larger of the operations (the trips this run's rays took, each
    ``MARCH_OPS_PER_TRIP`` or ``MARCH_GRAD_OPS_PER_TRIP`` of the variant,
    and for the implicit variant ``REFINE_OPS_PER_HIT`` for each of the
    ``refined`` hits, over the instruction rate) and the bytes (the EDF,
    each agent's origin, each ray's direction, each output once: the
    implicit variant's range and hit flag; the gradient also reads the
    ranges' cotangent, and writes the EDF's gradient and four per ray),
    over the HBM rate. Beside it, readings of the trips: their
    per-ray percentiles, and the trips of one-ray-a-thread launches,
    warp-level (32 x each warp's longest ray) and block-level (256 x each
    256-ray block's longest), and the SASS loop's instructions."""
    import torch
    ray_trips = int(trips.sum())
    flat = trips.reshape(-1)

    def padded_trips(width):
        f = torch.cat([flat, flat.new_zeros(-flat.numel() % width)])
        return width * int(f.reshape(-1, width).max(dim=1).values.sum())
    srt = flat.sort().values
    pct = {f"p{q}": int(srt[min(srt.numel() - 1, int(q / 100 * srt.numel()))])
           for q in (50, 90, 99)}
    rays = xb.numel()
    agents = rays // xb.shape[-1]
    nbytes = 4 * edf.numel() + 8 * agents + 8 * rays
    if grad is None:
        per_trip = MARCH_OPS_PER_TRIP[variant]
        nbytes += (5 if variant == "implicit" else 4) * rays
    else:
        per_trip = MARCH_GRAD_OPS_PER_TRIP[variant]
        nbytes += (4 * rays + 4 * edf.numel() * grad[0]
                   + 16 * rays * grad[1])
    ops = ray_trips * per_trip + refined * REFINE_OPS_PER_HIT
    ops_ms = ops / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    out = {"ray_trips": ray_trips, "warp_trips": padded_trips(32),
           "block_trips": padded_trips(256), "trip_percentiles": {
               **pct, "max": int(srt[-1])},
           "max_trips": int(srt[-1]), "ops_per_trip": per_trip,
           "refined_hits": refined, "ops": ops,
           "bytes": nbytes, "bound_ops_ms": ops_ms,
           "bound_bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    sass = rates.get("march_sass", {}).get(variant)
    if grad is None and sass:
        out["sass_per_trip"] = sass["instructions"]
        slots = ray_trips * sass["instructions"]
        bisect = rates.get("march_sass", {}).get("implicit bisection")
        if variant == "implicit" and bisect:
            out["sass_per_bisection"] = bisect["instructions"]
            slots += refined * 12 * bisect["instructions"]
        out["compiled_slots_ms"] = slots / rates["slots_per_s"] * 1e3
    return out


def march_kernel_checks(name, track, poses, rates, errs, times):
    """10: ``edf_march`` against its plain versions on the card, the full
    4096 x 1080 fan of ``poses``, all three variants: 0 mismatches; each
    variant's time, plain time and bound (the implicit variant's counting
    the hits it refines). Then
    ``edf_march_grad`` against autograd through the plain loop on the same
    fan, nearest and bilinear, from the march's record (as the backward
    takes it): the rays' gradients bit for bit, the EDF's within
    ``GRAD_TOL``; time (twice), plain time and bound."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    from pyracecarsimulator_tpu_torch.config import ScanParams
    sc = ScanParams()
    org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
    ox, oy = rx.origin_xy_f32(org, "cuda")
    tail = (MAX_RANGE, sc.ray_tracing_epsilon, sc.max_march_iters,
            (track.height, track.width))
    ray_sets = [rays_from_poses(q, BEAMS, FOV)[2:] for q in pose_sets(poses)]
    head = (track.edf, 1.0 / track.resolution, ox, oy)
    n = len(ray_sets)
    # the implicit variant's host scalars, as raymarch_diff._fwd_impl makes
    # them
    refine = (rd._surface_level(sc.ray_tracing_epsilon, track.resolution),
              0.4 * track.resolution, rd._DENOM_FLOOR)

    def plain(variant, rays):
        if variant == "implicit":
            return rd._fwd_plain(*head, *rays, *tail, refine)
        return rx.march_rays_plain(*head, *rays, *tail[:3], variant,
                                   tail[3])

    def kernel(variant, rays, ray_trips=None, walk=None):
        kw = dict(refine=refine) if variant == "implicit" else {}
        return rx.edf_march(*head, *rays, *tail, variant,
                            ray_trips=ray_trips, walk=walk, **kw)

    grids = {}
    for variant in MARCH_VARIANTS:
        rays = ray_sets[0]
        trips = torch.zeros(rays[0].shape, dtype=torch.int32, device="cuda")
        ref = plain(variant, rays)
        ref = (ref,) if torch.is_tensor(ref) else ref
        got = kernel(variant, rays, trips)
        torch.cuda.synchronize()
        got = (got,) if torch.is_tensor(got) else got
        mism = [int((a != b).sum()) for a, b in zip(got, ref)]
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, ref) if a.dtype == torch.float32)
        # the hits the implicit variant refines: the march's
        refined = (int(rd._march_nearest_plain(*head, *rays, *tail)[2].sum())
                   if variant == "implicit" else 0)
        log(f"[{name}] edf_march {variant} vs plain on "
            f"{tuple(got[0].shape)} rays: mismatches "
            f"{dict(zip(('range', 'hit'), mism))}, max abs err = {err}"
            + (f"; {refined} hits refined, {int(got[1].sum())} below "
               f"max_range" if refined else ""))
        check(not any(mism), f"{name}: edf_march {variant} disagrees with "
              "its plain version")
        errs["edf_march"].append(err)
        grids[f"edf_march {variant}"] = rx.persistent_grid(
            "cuda", "edf_march", variant)
        k_ms = timed_ms(lambda i: kernel(variant, ray_sets[i % n]), 50)
        p_ms = timed_ms(lambda i: plain(variant, ray_sets[i % n]), 2,
                        warmup=1)
        k2_ms = timed_ms(lambda i: kernel(variant, ray_sets[i % n]), 50)
        res = {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms,
               **march_bound(track.edf, rays[0], trips, variant, rates,
                             refined=refined)}
        res["share_of_bound"] = res["bound_ms"] / min(k_ms, k2_ms)
        times["edf_march"][f"{name} {variant}"] = res
        log(f"[{name}] edf_march {variant}: {k_ms:.4f} / {k2_ms:.4f} ms vs "
            f"plain {p_ms:.2f} ms; bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), share {res['share_of_bound']:.3f}; trips "
            f"per ray {res['ray_trips'] / rays[0].numel():.2f}, percentiles "
            f"{res['trip_percentiles']}; one ray a thread: warp-level / "
            f"per-ray {res['warp_trips'] / res['ray_trips']:.3f}, "
            f"block-level / per-ray "
            f"{res['block_trips'] / res['ray_trips']:.3f}")

    # the gradient: the EDF's (nearest), the EDF's and the rays' (bilinear)
    def grad_plain(variant, rays, g):
        """autograd through the plain loop, GRAD_PLAIN_AGENTS rows at a
        time (the EDF's gradient summed over the blocks)."""
        g_edf, g_rays = torch.zeros_like(track.edf), []
        for a in range(0, rays[0].shape[0], GRAD_PLAIN_AGENTS):
            blk = [v[a:a + GRAD_PLAIN_AGENTS] for v in rays]
            e, r = rx.march_grad_plain(*head, *blk, *tail, variant,
                                       g[a:a + GRAD_PLAIN_AGENTS], True,
                                       variant == "bilinear")
            g_edf += e
            g_rays.append(r)
        return g_edf, (tuple(torch.cat(v) for v in zip(*g_rays))
                       if variant == "bilinear" else None)

    gen = torch.Generator(device="cuda").manual_seed(7)
    for variant in ("nearest", "bilinear"):
        rays = ray_sets[0]
        ray_grad = variant == "bilinear"
        trips = torch.zeros(rays[0].shape, dtype=torch.int32, device="cuda")
        walks = [torch.empty(r[0].shape, dtype=torch.int32, device="cuda")
                 for r in ray_sets]
        for rs, w in zip(ray_sets, walks):
            kernel(variant, rs, walk=w)
        kernel(variant, rays, trips)
        g = torch.rand(rays[0].shape, generator=gen, device="cuda") + 0.5
        args = lambda rs: (*head, *rs, *tail, variant, g, True, ray_grad)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = grad_plain(variant, rays, g)
        end.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(end)
        scale = max(1.0, float(ref[0].abs().max()))
        got = rx.edf_march_grad(*args(rays), walk=walks[0])
        err_edf = float((got[0] - ref[0]).abs().max())
        ok = err_edf <= GRAD_TOL * scale and float(ref[0].abs().sum()) > 0
        err_rays = max([float((a - b).abs().max())
                        for a, b in zip(got[1] or (), ref[1] or ())],
                       default=0.0)
        mism = sum(int((a != b).sum())
                   for a, b in zip(got[1] or (), ref[1] or ()))
        log(f"[{name}] edf_march_grad {variant} vs autograd through the "
            f"plain loop on {tuple(rays[0].shape)} rays: EDF gradient max "
            f"abs err {err_edf} (largest |plain| {scale}, tolerance "
            f"{GRAD_TOL} x max(1, that)); rays' gradients mismatches "
            f"{mism}, max abs err {err_rays}")
        check(ok and mism == 0, f"{name}: edf_march_grad {variant} "
              "disagrees with autograd through the plain loop")
        errs["edf_march_grad"].append(max(err_edf, err_rays))
        grids[f"edf_march_grad {variant}"] = rx.persistent_grid(
            "cuda", "edf_march_grad", variant)
        recorded = lambda i: rx.edf_march_grad(*args(ray_sets[i % n]),
                                               walk=walks[i % n])
        k_ms = timed_ms(recorded, 20)
        k2_ms = timed_ms(recorded, 20)
        res = {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms,
               **march_bound(track.edf, rays[0], trips, variant, rates,
                             grad=(True, ray_grad))}
        res["share_of_bound"] = res["bound_ms"] / min(k_ms, k2_ms)
        times["edf_march_grad"][f"{name} {variant}"] = res
        log(f"[{name}] edf_march_grad {variant}: {k_ms:.4f} / {k2_ms:.4f} "
            f"ms from the record, vs plain {p_ms:.2f} ms "
            f"({GRAD_PLAIN_AGENTS}-agent blocks); bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}), share "
            f"{res['share_of_bound']:.3f}")
    log(f"[{name}] persistent grids, blocks of 256 threads over "
        f"{rates['sms']} SMs: {grids}")
    rates["march_grid"] = grids


def pose_vjp_checks(name, track, poses, rates, errs, times):
    """10: ``implicit_pose_vjp`` (the implicit march's VJP in the poses)
    against its plain version on the card, on the full 4096 x 1080 fan of
    ``poses`` and a seeded cotangent: each ray's three terms bit for bit,
    the agents' sums within ``POSE_VJP_SUM_TOL`` x the sum of the agent's
    |terms|, the same bits on a second launch; the time, beside its bound,
    the plain version's and the composition's it replaces (autograd
    through ``rays_from_poses`` + ``_MarchImplicit``, whose sums it is
    held to too, as a reading); "edf_implicit"'s scan forward bit for bit
    the composition's, and its forward + backward counted: one
    ``edf_march`` and one ``implicit_pose_vjp`` launch, the same
    cotangent."""
    import torch
    from pyracecarsimulator_tpu_torch.config import ScanParams
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    from pyracecarsimulator_tpu_torch.ops.common import (
        beam_angles, fan_factors, rays_from_poses, rotate_fan)
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import origin_xy_f32
    sc = ScanParams()
    eps, iters = sc.ray_tracing_epsilon, sc.max_march_iters
    hw = (track.height, track.width)
    res_m = track.resolution
    org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
    ox, oy = origin_xy_f32(org, "cuda")
    p = torch.as_tensor(poses, device="cuda")
    fan = fan_factors(p[:, 2], beam_angles(BEAMS, FOV, p.device))
    r, hit = rd._fwd_impl(track.edf, res_m, ox, oy, p[:, 0:1], p[:, 1:2],
                          *rotate_fan(*fan), MAX_RANGE, eps, iters, hw)
    gen = torch.Generator(device="cuda").manual_seed(11)
    gs = [torch.randn(r.shape, generator=gen, device="cuda")
          for _ in range(5)]
    args = lambda g: (track.edf, res_m, ox, oy, p, *fan, r, hit, g, eps, hw)
    terms = torch.empty((3, *r.shape), device="cuda")
    reset_counts()
    got = rd.implicit_pose_vjp(*args(gs[0]), terms=terms)
    again = rd.implicit_pose_vjp(*args(gs[0]))
    launched = counts()["implicit_pose_vjp"]
    ref_terms = rd._pose_terms(*args(gs[0]))
    ref = rd.implicit_pose_vjp_plain(*args(gs[0]))
    torch.cuda.synchronize()
    mism = [int((a != b).sum()) for a, b in zip(terms, ref_terms)]
    scale = torch.stack([t.abs().sum(-1) for t in ref_terms], -1)
    diff = (got - ref).abs()
    rel = float((diff / scale.clamp_min(1e-30)).max())
    ok_sums = bool((diff <= POSE_VJP_SUM_TOL * scale).all())
    log(f"[{name}] implicit_pose_vjp vs plain on {tuple(r.shape)} rays: "
        f"terms mismatches {dict(zip(('x', 'y', 'theta'), mism))}; sums "
        f"max abs diff {float(diff.max())}, max diff / sum |terms| {rel} "
        f"(tolerance {POSE_VJP_SUM_TOL}); second launch the same bits = "
        f"{torch.equal(got, again)}; launches {launched}")
    check(not any(mism) and ok_sums and torch.equal(got, again)
          and launched == 2 and float(got.abs().sum()) > 0,
          f"{name}: implicit_pose_vjp disagrees with its plain version")
    errs["implicit_pose_vjp"].append(float(diff.max()))

    # the composition it replaces, under autograd
    q = p.clone().requires_grad_(True)
    _, _, xb, yb, ct, st = rays_from_poses(q, BEAMS, FOV)
    r_old = rd.march_rays_implicit(track.edf, res_m, org, xb, yb, ct, st,
                                   MAX_RANGE, eps, iters, hw)
    old = lambda i: torch.autograd.grad(r_old, q, gs[i % 5],
                                        retain_graph=True)[0]
    rel_old = float(((old(0) - got).abs() / scale.clamp_min(1e-30)).max())
    hits = int(hit.sum())
    rays, agents = r.numel(), r.shape[0]
    ops = hits * POSE_VJP_OPS_PER_HIT + (rays - hits)
    nbytes = POSE_VJP_BYTES_PER_RAY * rays + 28 * agents + 8 * BEAMS
    ops_ms = ops / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    # the kernel's device time from a graph's replays (its wrapper's host
    # time is longer), and beside it the host-bound time of eager calls
    kernel = lambda i: rd.implicit_pose_vjp(*args(gs[i % 5]))
    res = {"ms": graphed_ms(kernel),
           "plain_ms": timed_ms(
               lambda i: rd.implicit_pose_vjp_plain(*args(gs[i % 5])), 5),
           "composition_ms": timed_ms(old, 5),
           "ms_2": graphed_ms(kernel),
           "eager_call_ms": timed_ms(kernel, 100),
           "hits": hits, "ops": ops, "bytes": nbytes, "bound_ops_ms": ops_ms,
           "bound_bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "composition_max_diff_over_sum": rel_old}
    res["share_of_bound"] = res["bound_ms"] / min(res["ms"], res["ms_2"])
    times["implicit_pose_vjp"][name] = res
    log(f"[{name}] implicit_pose_vjp: {res['ms']:.4f} / {res['ms_2']:.4f} "
        f"ms (graph replays; an eager call {res['eager_call_ms']:.4f} ms, "
        f"its host time) vs plain {res['plain_ms']:.4f} ms, the "
        f"composition's backward "
        f"{res['composition_ms']:.4f} ms (its sums' max diff / sum |terms| "
        f"{rel_old}); bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {ops:.4e} operations, {hits} hits), share "
        f"{res['share_of_bound']:.3f}")

    # the scan: forward bit for bit, forward + backward counted
    with torch.no_grad():
        reset_counts()
        r_new = rd.scan_poses_implicit(
            track.edf, res_m, org, p, num_beams=BEAMS, fov=FOV,
            max_range=MAX_RANGE, eps=eps, max_iters=iters, bounds_hw=hw)
        used_fwd = {k: v for k, v in counts().items() if v}
    reset_counts()
    q2 = p.clone().requires_grad_(True)
    r_grad = rd.scan_poses_implicit(
        track.edf, res_m, org, q2, num_beams=BEAMS, fov=FOV,
        max_range=MAX_RANGE, eps=eps, max_iters=iters, bounds_hw=hw)
    r_grad.backward(gs[0])
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    same = [torch.equal(v, r_old.detach()) for v in (r_new, r_grad.detach())]
    log(f"[{name}] edf_implicit scan: forward bit for bit the "
        f"composition's (no grad, grad) = {same}; launches forward "
        f"{used_fwd}, forward + backward {used}; pose cotangent the "
        f"kernel's = {torch.equal(q2.grad, got)}")
    check(all(same) and used_fwd == {"edf_march": 1}
          and used == {"edf_march": 1, "implicit_pose_vjp": 1}
          and torch.equal(q2.grad, got),
          f"{name}: the edf_implicit scan's route or values")
    del r_old, old
    return res


def march_phases(card, name, track, poses, rates, errs, times):
    """10-11: the EDF march backends on one map. Returns the times."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import build_sim, make_scan_fn
    from pyracecarsimulator_tpu_torch._native import loader as native
    from pyracecarsimulator_tpu_torch.oracle import raycast as orc
    from pyracecarsimulator_tpu_torch.ops import raymarch_xla as rx
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    from pyracecarsimulator_tpu_torch.ops.raymarch_diff import (
        scan_poses_implicit)
    march_kernel_checks(name, track, poses, rates, errs, times)
    out = {"pose_vjp": pose_vjp_checks(name, track, poses, rates, errs,
                                       times)}
    bundle = build_sim(track, backend="edf", device="cuda")
    sc = bundle.scan
    org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
    hw = (track.height, track.width)
    kw = dict(max_range=MAX_RANGE, eps=sc.ray_tracing_epsilon,
              max_iters=sc.max_march_iters, bounds_hw=hw)
    p = torch.as_tensor(poses, device="cuda")
    _, _, xb, yb, ct, st = rays_from_poses(p[:64], BEAMS, FOV)
    same_fan_check(f"{name} edf march, 64 poses", lambda e, o, *r:
                   rx.march_rays(e, track.resolution, o, *r, **kw),
                   (track.edf, org, xb, yb, ct, st))
    scan = make_scan_fn(bundle)
    edf_np = track.edf.cpu().numpy()
    served = native.trace_rays.calls
    ref = orc.scan_batch(edf_np, track.resolution,
                         (track.origin_x, track.origin_y),
                         poses[:ORACLE_POSES], num_beams=BEAMS, fov=FOV,
                         max_range=MAX_RANGE, eps=sc.ray_tracing_epsilon,
                         max_iters=1000, bounds_hw=hw)
    check(native.trace_rays.calls == served + 1,
          "the oracle did not take its native body")
    d = np.abs(scan(p[:ORACLE_POSES]).cpu().numpy() - ref)
    share = (d < 1e-3).mean(axis=1)
    log(f"[{name}] edf scan vs the oracle on {ORACLE_POSES} poses: least "
        f"share of a pose's beams within 1e-3 m = {float(share.min())}, "
        f"max abs diff = {float(d.max())}")
    check(share.min() > 0.99 and d.max() < 3 * track.resolution,
          f"{name}: edf scan disagrees with the oracle")
    sets = pose_sets(poses)
    out["edf_scan_ms"] = timed_ms(lambda i: scan(sets[i % 5]), 20)
    out["edf_scan_device_ops"] = device_ops(lambda: scan(sets[0]))
    out["edf_step_ms"] = step_ms(bundle, poses)
    log(f"[{name}] {card}: edf scan {out['edf_scan_ms']:.4f} ms "
        f"({out['edf_scan_device_ops']} device ops per scan), closed-loop "
        f"edf step {out['edf_step_ms']:.4f} ms")

    # 11. the differentiable marches
    def implicit(edf, q):
        return scan_poses_implicit(edf, track.resolution, org, q,
                                   num_beams=BEAMS, fov=FOV, **kw)

    def fwd_bwd(scan_fn, q):
        edf = track.edf.clone().requires_grad_(True)
        q = q.clone().requires_grad_(True)
        scan_fn(edf, q).sum().backward()
        return edf.grad, q.grad

    def bilinear(edf, q):
        return rx.scan_poses(edf, track.resolution, org, q, num_beams=BEAMS,
                             fov=FOV, interp="bilinear", **kw)

    # the implicit march's forward is one launch of the kernel's implicit
    # variant, its pose VJP one of implicit_pose_vjp (its map VJP
    # elementwise); the bilinear march's backward is edf_march_grad
    for label, fn, q, kernels in (
            ("edf_implicit", implicit, p, {"edf_march": 1,
                                           "implicit_pose_vjp": 1}),
            ("edf_bilinear", bilinear, p, {"edf_march": 1,
                                           "edf_march_grad": 1})):
        reset_counts()
        g_edf, g_pose = fwd_bwd(fn, q)
        torch.cuda.synchronize()
        used = {k: v for k, v in counts().items() if v}
        ok = all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
                 for g in (g_edf, g_pose))
        log(f"[{name}] {label} fwd+bwd on {q.shape[0]} x {BEAMS}: EDF grad "
            f"|.|_1 {float(g_edf.abs().sum()):.4f}, pose grad |.|_1 "
            f"{float(g_pose.abs().sum()):.4f}, finite and non-zero = {ok}; "
            f"launches {used}")
        check(ok, f"{name}: {label} gradients")
        check(used == kernels, f"{name}: {label} took another route "
              f"({used})")
        out[f"{label}_fwd_bwd_launches"] = used
        torch.cuda.reset_peak_memory_stats()
        out[f"{label}_fwd_bwd_ms"] = timed_ms(
            lambda i: fwd_bwd(fn, sets[i % 5][: q.shape[0]]), 2, warmup=1)
        out[f"{label}_fwd_bwd_agents"] = q.shape[0]
        out[f"{label}_fwd_bwd_peak_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            out[f"{label}_fwd_ms"] = timed_ms(
                lambda i: fn(track.edf, sets[i % 5]), 3, warmup=1)
        log(f"[{name}] {card}: {label} forward {AGENTS} x {BEAMS} "
            f"{out[f'{label}_fwd_ms']:.4f} ms; forward + backward "
            f"{q.shape[0]} x {BEAMS} {out[f'{label}_fwd_bwd_ms']:.4f} ms, "
            f"peak {out[f'{label}_fwd_bwd_peak_gb']:.2f} GB")
    # the main path of the EDF family: the "edf" step and its rollout,
    # replayed from CUDA graphs
    out["edf_launches"] = drive({name: bundle}, "edf", {name: poses})[name]
    check(out["edf_launches"] == {"edf_march": STEPS + 1 + WARMUP_STEPS},
          f"{name}: the edf path launched {out['edf_launches']}")
    return out


def mapgrad_phase(card, smap_bundle, poses):
    """12: make_scan_fn(map_grad=True) on a sector bundle."""
    import torch
    from pyracecarsimulator_tpu_torch import make_scan_fn
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops import raymarch_diff as rd
    track = smap_bundle.track
    scan_g = make_scan_fn(smap_bundle, map_grad=True)
    p = torch.as_tensor(poses, device="cuda")
    edf = track.edf.clone().requires_grad_(True)
    reset_counts()
    r = scan_g(p, edf)
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    ref = rs.scan_poses_sectors(smap_bundle.segmap, p, num_beams=BEAMS,
                                fov=FOV, max_range=MAX_RANGE)
    same = bool(torch.equal(r.detach(), ref))
    (r ** 2).sum().backward()
    g = edf.grad
    ok = bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    log(f"[berlin] map_grad sector scan: launches {used}, forward equal to "
        f"scan_poses_sectors = {same}, EDF cotangent |.|_1 "
        f"{float(g.abs().sum()):.4f}, finite and non-zero = {ok}")
    check(used == {"list_sweep": 1} and same and ok, "map_grad scan")
    sets = pose_sets(poses)
    n_scans = 3
    reset_counts()

    def fwd_bwd(i):
        e = track.edf.clone().requires_grad_(True)
        (scan_g(sets[i % 5], e) ** 2).sum().backward()
    ms = timed_ms(fwd_bwd, n_scans, warmup=0)
    grown = counts()
    log(f"[berlin] {card}: map_grad sector scan forward + backward "
        f"{ms:.4f} ms at {AGENTS} x {BEAMS}; launches over {n_scans} "
        f"scans {grown}")
    check(grown == {**{k: 0 for k in KERNELS}, "list_sweep": n_scans},
          f"map_grad: {n_scans} scans launched {grown}")
    # dedup against scatter, on the forward's own rays
    from pyracecarsimulator_tpu_torch.ops.common import rays_from_poses
    _, _, xb, yb, cts, sts = rays_from_poses(p[:512], BEAMS, FOV)
    with torch.no_grad():
        r512 = rs.scan_poses_sectors(smap_bundle.segmap, p[:512],
                                     num_beams=BEAMS, fov=FOV,
                                     max_range=MAX_RANGE)
    grads = []
    for dedup in (False, True):
        e = track.edf.clone().requires_grad_(True)
        org = torch.tensor([track.origin_x, track.origin_y], device="cuda")
        (rd.with_map_gradient(e, r512, xb, yb, cts, sts, track.resolution,
                              org, 1e-4, (track.height, track.width),
                              dedup) ** 2).sum().backward()
        grads.append(e.grad)
    err = float((grads[0] - grads[1]).abs().max())
    scale = float(grads[0].abs().max())
    log(f"[berlin] with_map_gradient dedup vs scatter, 512 x {BEAMS}: max "
        f"abs diff {err} (max |cotangent| {scale})")
    check(err <= 1e-5 * scale + 1e-6, "dedup cotangent differs")
    return {"fwd_bwd_ms": ms, "launches": used, "dedup_err": err}


def stencil_bound(cells, iters, key, rates, history=False):
    """The least time the card could take for one call of the chamfer
    stencil ``key`` = (kernel, mode) over ``cells`` cells and ``iters``
    iterations: the larger of the operations (``STENCIL_OPS`` a cell and
    iteration: the FP32 and SFU operations' issue slots, or the SFU's
    own pipe at its rate, whichever is longer) and the bytes (the field
    in and out once; the history, written by a forward that keeps it and
    read by the gradient, once: its first field is the gradient's input
    field)."""
    fp32, sfu = STENCIL_OPS[key]
    ops = cells * iters * max(fp32 + sfu, SFU_COST * sfu)
    nbytes = 4 * cells * (2 + iters * (history or key[0] == "soft_edt_grad"))
    ops_ms = ops / rates["slots_per_s"] * 1e3
    bytes_ms = nbytes / rates["hbm_bytes_per_s"] * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ops_ms": ops_ms,
            "bound_bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def plain_soft_edt(occupancy, resolution, iters=64, temperature=0.0,
                   init="linear", init_lambda=3.0):
    """``soft_edt`` as it ran before its kernels: the init, the plain
    stencil loop under autograd and the clip, on the occupancy's device."""
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    d = ps.init_field(occupancy, iters, init, init_lambda)
    d = ps.chamfer_stencil_plain(d, iters, temperature)
    return ps._clip(d, 0.0, iters + 1.0) * resolution


def peak_mb(fn):
    """Device memory that one call of ``fn()`` holds at its peak above
    what was allocated before it, in MB."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def soft_edt_phase(card, name, track, rates, errs, times):
    """13: the chamfer stencil of ``soft_edt`` on the map's occupancy, in
    ``STENCIL_MODES``: the kernels against the plain loop and autograd
    through it on the card, times, bounds and peak memory; ``soft_edt``
    on the card against the CPU (hard and soft, 64 iterations)."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    occ = track.occupancy
    cells = occ.numel()
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = torch.randn(occ.shape, generator=gen, device="cuda")
    out = {"shape": list(occ.shape)}
    for mode, kw in STENCIL_MODES.items():
        iters, t = kw["iters"], kw.get("temperature", 0.0)
        exact = t == 0.0
        d0 = ps.init_field(occ, iters, kw.get("init", "linear"),
                           kw.get("init_lambda", 3.0)).contiguous()
        # the forward: kernel (with and without the history) against the
        # plain loop
        hist = torch.empty((iters, *occ.shape), device="cuda")
        ref_hist = torch.empty_like(hist)
        got = ps.chamfer_stencil(d0, iters, t)
        got_h = ps.chamfer_stencil(d0, iters, t, hist)
        ref = ps.chamfer_stencil_plain(d0, iters, t, ref_hist)
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.abs().max()))
        fwd = {"mismatches": int((got != ref).sum()),
               "history_mismatches": int((hist != ref_hist).sum()),
               "max_abs_err": max(float((got - ref).abs().max()),
                                  float((hist - ref_hist).abs().max())),
               "scale": scale,
               "equal_with_history": bool(torch.equal(got, got_h))}
        del ref_hist
        # the gradient: kernel against the explicit plain backward (same
        # history) and against autograd through the plain loop
        gk = ps.chamfer_stencil_grad(hist, g, t)
        gp = ps.chamfer_stencil_grad_plain(hist, g, t)
        x = d0.clone().requires_grad_(True)
        ps.chamfer_stencil_plain(x, iters, t).backward(g)
        torch.cuda.synchronize()
        gscale = max(1.0, float(x.grad.abs().max()))
        bwd = {"mismatches_vs_plain": int((gk != gp).sum()),
               "err_vs_plain": float((gk - gp).abs().max()),
               "mismatches_vs_autograd": int((gk != x.grad).sum()),
               "err_vs_autograd": float((gk - x.grad).abs().max()),
               "scale": gscale}
        del x, gp
        log(f"[{name}] soft_edt {mode} ({iters} iters) {tuple(occ.shape)}: "
            f"kernel vs plain loop {fwd}; gradient kernel vs plain backward "
            f"and vs autograd {bwd}")
        tol = STENCIL_TOL * scale
        check(fwd["equal_with_history"]
              and (fwd["mismatches"] == 0 == fwd["history_mismatches"]
                   if exact else fwd["max_abs_err"] <= tol),
              f"{name} soft_edt {mode}: the kernel disagrees with the loop")
        check((bwd["mismatches_vs_plain"] == 0 if exact
               else bwd["err_vs_plain"] <= STENCIL_TOL * gscale)
              and bwd["err_vs_autograd"] <= (
                  STENCIL_TOL if exact else STENCIL_GRAD_TOL) * gscale,
              f"{name} soft_edt {mode}: the gradient kernel disagrees")
        errs["soft_edt"].append(fwd["max_abs_err"])
        errs["soft_edt_grad"].append(bwd["err_vs_autograd"])
        # times: kernel, plain, kernel
        res = track.resolution

        def kernel_fb(i):
            o = occ.clone().requires_grad_(True)
            ps.soft_edt(o, res, **kw).backward(g)

        def plain_fb(i):
            o = occ.clone().requires_grad_(True)
            plain_soft_edt(o, res, **kw).backward(g)
        fwd_ms = timed_ms(lambda i: ps.chamfer_stencil(d0, iters, t), 10)
        plain_ms = timed_ms(lambda i: ps.chamfer_stencil_plain(d0, iters, t),
                            3, warmup=1)
        fwd_ms_2 = timed_ms(lambda i: ps.chamfer_stencil(d0, iters, t), 10)
        grad_ms = timed_ms(lambda i: ps.chamfer_stencil_grad(hist, g, t), 10)
        grad_plain_ms = timed_ms(
            lambda i: ps.chamfer_stencil_grad_plain(hist, g, t), 3, warmup=1)
        grad_ms_2 = timed_ms(lambda i: ps.chamfer_stencil_grad(hist, g, t),
                             10)
        del hist
        fb_ms = timed_ms(kernel_fb, 5, warmup=1)
        fb_plain_ms = timed_ms(plain_fb, 3, warmup=1)
        fb_ms_2 = timed_ms(kernel_fb, 5, warmup=1)
        mem = {"kernel_mb": peak_mb(lambda: kernel_fb(0)),
               "plain_mb": peak_mb(lambda: plain_fb(0))}
        soft = "soft" if t > 0 else "hard"
        b_fwd = stencil_bound(cells, iters, ("soft_edt", soft), rates)
        b_fwd_h = stencil_bound(cells, iters, ("soft_edt", soft), rates,
                                history=True)
        b_grad = stencil_bound(cells, iters, ("soft_edt_grad", soft), rates)
        times["soft_edt"][f"{name} {mode}"] = {
            "ms": fwd_ms, "ms_2": fwd_ms_2, "plain_ms": plain_ms, **b_fwd,
            "share_of_bound": b_fwd["bound_ms"] / min(fwd_ms, fwd_ms_2),
            "bound_with_history": b_fwd_h}
        times["soft_edt_grad"][f"{name} {mode}"] = {
            "ms": grad_ms, "ms_2": grad_ms_2, "plain_ms": grad_plain_ms,
            **b_grad,
            "share_of_bound": b_grad["bound_ms"] / min(grad_ms, grad_ms_2)}
        fb_bound = b_fwd_h["bound_ms"] + b_grad["bound_ms"]
        out[mode] = {"iters": iters, "forward": fwd, "gradient": bwd,
                     "fwd_bwd_ms": [fb_ms, fb_ms_2],
                     "fwd_bwd_plain_ms": fb_plain_ms,
                     "fwd_bwd_bound_ms": fb_bound,
                     "fwd_bwd_share": fb_bound / min(fb_ms, fb_ms_2),
                     "peak_mb": mem}
        log(f"[{name}] {card}: soft_edt {mode} ({iters} iters): forward "
            f"{fwd_ms:.4f} / {fwd_ms_2:.4f} ms vs plain {plain_ms:.4f} "
            f"(bound {b_fwd['bound_ms']:.4f} {b_fwd['bound_by']}, with the "
            f"history {b_fwd_h['bound_ms']:.4f} {b_fwd_h['bound_by']}); "
            f"gradient {grad_ms:.4f} / {grad_ms_2:.4f} ms vs plain backward "
            f"{grad_plain_ms:.4f} (bound {b_grad['bound_ms']:.4f} "
            f"{b_grad['bound_by']}); soft_edt forward + backward "
            f"{fb_ms:.4f} / {fb_ms_2:.4f} ms vs plain loop under autograd "
            f"{fb_plain_ms:.4f} (bound {fb_bound:.4f}); peak device memory "
            f"{mem['kernel_mb']:.1f} MB vs {mem['plain_mb']:.1f} MB")
        torch.cuda.empty_cache()
    # soft_edt on the card (the kernels) against the CPU (the plain loop)
    for label, kw, exact, tol in (("hard", {}, True, 0.0),
                                  ("soft", dict(temperature=0.25), False,
                                   1e-4)):
        out[f"{label}_cpu_err"] = same_fan_check(
            f"{name} soft_edt {label} {tuple(occ.shape)}",
            lambda o: ps.soft_edt(o, track.resolution, **kw),
            (occ,), exact=exact, tol=tol)
    return out


def occupancy_scan_phase(card, track, poses):
    """13b: ``scan_from_occupancy`` at full width on levine, forward and
    backward of a loss of the ranges: counted (one launch each of
    ``soft_edt``, ``edf_march``, ``edf_march_grad`` and
    ``soft_edt_grad``, nothing else), the occupancy gradient finite and
    non-zero; against the same path with the plain stencil loop (the
    parent's), whose ranges it equals bit for bit, timed in turns."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import soft_edt as ps
    from pyracecarsimulator_tpu_torch.ops.raymarch_xla import scan_poses
    p = torch.as_tensor(poses, device="cuda")
    org = (track.origin_x, track.origin_y)
    hw = (track.height, track.width)
    w = torch.linspace(0.5, 1.5, BEAMS, device="cuda")
    kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE, max_iters=128)

    def run(plain):
        o = track.occupancy.clone().requires_grad_(True)
        if plain:
            edf = plain_soft_edt(o, track.resolution, iters=64)
            r = scan_poses(edf, track.resolution, org, p, interp="bilinear",
                           bounds_hw=hw, **kw)
        else:
            r = ps.scan_from_occupancy(o, track.resolution, org, p,
                                       edt_iters=64, bounds_hw=hw, **kw)
        (r * w).sum().backward()
        return r.detach(), o.grad

    reset_counts()
    r, g = run(False)
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    r_p, g_p = run(True)
    torch.cuda.synchronize()
    same = bool(torch.equal(r, r_p))
    err = float((g - g_p).abs().max())
    scale = max(1.0, float(g_p.abs().max()))
    ok = bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    log(f"[levine] scan_from_occupancy {AGENTS} x {BEAMS}, forward + "
        f"backward: launches {used}; ranges equal to the plain stencil's "
        f"path = {same}; occupancy gradient finite and non-zero = {ok}, "
        f"|.|_1 {float(g.abs().sum()):.6f}, max abs diff to the plain "
        f"path {err} (max |.| {scale})")
    check(used == {"soft_edt": 1, "edf_march": 1, "edf_march_grad": 1,
                   "soft_edt_grad": 1},
          f"scan_from_occupancy launched {used}")
    check(same and ok and err <= GRAD_TOL * scale,
          "scan_from_occupancy: ranges or occupancy gradient")
    ms = [timed_ms(lambda i: run(plain), 3, warmup=1)
          for plain in (True, False, False, True)]
    log(f"[levine] {card}: scan_from_occupancy forward + backward, turns "
        f"plain stencil, kernels, kernels, plain stencil: "
        f"{', '.join(f'{v:.4f}' for v in ms)} ms")
    return {"launches": used, "ranges_equal": same, "grad_err": err,
            "grad_scale": scale, "ms_plain": [ms[0], ms[3]],
            "ms_kernels": [ms[1], ms[2]]}


def simplified_phase(card, name, track, poses, rates, errs, times):
    """14: the "segments_simplified" backend on one map: the general
    sweep against its plain version on the full fan, both modes, timed
    beside its bound; the scan on the card against the CPU's; one launch
    a scan; the step and the rollout, counted."""
    import torch
    from pyracecarsimulator_tpu_torch import build_sim, make_scan_fn
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    from pyracecarsimulator_tpu_torch.ops.common import (apply_extent_mask,
                                                         rays_from_poses)
    out = {}
    t0 = time.perf_counter()
    bundle = build_sim(track, backend="segments_simplified", device="cuda")
    gmap = bundle.segmap
    out["build_s"] = time.perf_counter() - t0
    log(f"[{name}] segments_simplified: {gmap.n_segments} general segments "
        f"(params {tuple(gmap.params.shape)}, tiles "
        f"{None if gmap.tiles is None else tuple(gmap.tiles.shape)}), host "
        f"build {out['build_s']:.2f} s")

    def scan_rays(m, q, xb, yb, ct, st):
        if m.tiles is not None:
            r = rg.raycast_general_tiled(m.tiles, m.tiles_shape, m.tile_size,
                                         m.tile_origin, q[:, 0], q[:, 1],
                                         xb, yb, ct, st, MAX_RANGE)
        else:
            r = rg.raycast_general(m.params, xb, yb, ct, st, MAX_RANGE)
        return apply_extent_mask(r, q[:, 0], q[:, 1], m.extent, MAX_RANGE)

    # the kernel against its plain version on the full fan, both modes
    sets = pose_sets(poses)
    args = [general_case(gmap, q) for q in sets]
    n = len(args)
    layout = "tiled" if gmap.tiles is not None else "flat"
    for winner in (False, True):
        mode = "winner" if winner else "min"
        got = rg.general_sweep(*args[0], winner)
        ref = rg.general_sweep_plain(*args[0], winner)
        torch.cuda.synchronize()
        pairs = [(k, a, b) for k, a, b in zip(("best", "wx", "wy"), got, ref)
                 if a is not None]
        mism = {k: int((a != b).sum()) for k, a, b in pairs}
        err = max(float((a.double() - b.double()).abs().max())
                  for _, a, b in pairs)
        log(f"[{name}] general_sweep {mode} ({layout}, table "
            f"{tuple(args[0][0].shape)}) vs plain on "
            f"{tuple(got[0].shape)} rays: mismatches {mism}, max abs err = "
            f"{err}; hits within {MAX_RANGE} m "
            f"{float((got[0] < MAX_RANGE).float().mean()):.4f}")
        check(not any(mism.values()), f"{name}: general_sweep {mode} "
              "disagrees with its plain version")
        errs["general_sweep"].append(err)
        k_ms = timed_ms(lambda i: rg.general_sweep(*args[i % n], winner), 20)
        p_ms = timed_ms(
            lambda i: rg.general_sweep_plain(*args[i % n], winner), 2,
            warmup=1)
        k2_ms = timed_ms(lambda i: rg.general_sweep(*args[i % n], winner), 20)
        res = {"ms": k_ms, "ms_2": k2_ms, "plain_ms": p_ms,
               **general_bound(args[0], winner, rates)}
        res["share_of_bound"] = res["bound_ms"] / min(k_ms, k2_ms)
        res["share_of_bound_27"] = res["bound_27_ms"] / min(k_ms, k2_ms)
        times["general_sweep"][f"{name} {mode}"] = res
        log(f"[{name}] general_sweep {mode}: {k_ms:.4f} / {k2_ms:.4f} ms vs "
            f"plain {p_ms:.2f} ms; bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), share {res['share_of_bound']:.3f}; "
            f"at {OPS_PER_PAIR} a real pair {res['bound_27_ms']:.4f} ms, "
            f"share {res['share_of_bound_27']:.3f}; "
            f"{res['mean_real_slots']:.1f} real of {res['slots']} slots a "
            f"ray, {res['full_pairs_a_ray']:.2f} pairs a ray that lower or "
            f"tie the running minimum")
    if name == MAPS[0]:
        out["adversarial"] = general_adversarial(name, errs)

    p = torch.as_tensor(poses, device="cuda")
    _, q, xb, yb, ct, st = rays_from_poses(p[:64], BEAMS, FOV)
    same_fan_check(f"{name} segments_simplified scan, 64 poses",
                   lambda m, *a: scan_rays(m, *a),
                   (gmap, q, xb, yb, ct, st))
    scan = make_scan_fn(bundle)
    reset_counts()
    scan(p)
    torch.cuda.synchronize()
    out["scan_launches"] = {k: v for k, v in counts().items() if v}
    check(out["scan_launches"] == {"general_sweep": 1},
          f"{name}: a segments_simplified scan launched "
          f"{out['scan_launches']}")
    out["scan_ms"] = timed_ms(lambda i: scan(sets[i % 5]), 20)
    out["step_ms"] = step_ms(bundle, poses)
    out["launches"] = drive({name: bundle}, "segments_simplified",
                            {name: poses})[name]
    check(out["launches"] == {"general_sweep": STEPS + 1 + WARMUP_STEPS},
          f"{name}: segments_simplified launched {out['launches']}")
    log(f"[{name}] {card}: segments_simplified scan {out['scan_ms']:.4f} "
        f"ms ({out['scan_launches']}), step {out['step_ms']:.4f} ms")
    return out


def general_adversarial(name, errs):
    """Phase 14's adversarial set (``tests/torch_general_cases.py``: exact
    ties inside a chunk and across the cut of a 1024-slot list, rays
    through segment endpoints, zero and subnormal denominators, NaN rays,
    a list of padding only, ranges near 3e38) through ``general_sweep``
    against ``general_sweep_plain``, both modes: each row on its list,
    every list alone as the flat table, and rows on lists that do not
    exist (NaN there, the other rows as before). 0 mismatches, compared
    as torch.equal compares (a zero equals a zero of either sign: torch's
    amin leaves the sign at a tie of +0 and -0 open), a NaN equal to a
    NaN."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import raycast_general as rg
    cases = general_cases()
    table, ids, rays = cases.adversarial(0, device="cuda")
    # as torch.equal compares, but a NaN equals a NaN
    differ = lambda a, b: (a != b) & ~(a.isnan() & b.isnan())
    runs = [("tiles", table, ids)] + [(f"list {i}", table[i:i + 1], None)
                                      for i in range(table.shape[0])]
    out = {}
    for winner in (False, True):
        mode = "winner" if winner else "min"
        for label, tbl, ix in runs:
            got = rg.general_sweep(tbl, ix, *rays, winner)
            ref = rg.general_sweep_plain(tbl, ix, *rays, winner)
            mism = sum(int(differ(a, b).sum())
                       for a, b in zip(got, ref) if a is not None)
            out[f"{mode} {label}"] = mism
            errs["general_sweep"].append(max(
                float((a.double() - b.double()).abs().nan_to_num(0.0).max())
                for a, b in zip(got, ref) if a is not None))
        bad = cases.unknown_ids(ids)
        unknown = (bad < 0) | (bad >= table.shape[0])
        got = rg.general_sweep(table, bad, *rays, winner)
        ref = rg.general_sweep_plain(table, torch.where(unknown, 2, bad),
                                     *rays, winner)
        out[f"{mode} unknown lists"] = sum(
            int(differ(a[~unknown], b[~unknown]).sum())
            + int((~a[unknown].isnan()).sum())
            for a, b in zip(got, ref) if a is not None)
    torch.cuda.synchronize()
    log(f"[{name}] general_sweep adversarial set ({tuple(table.shape)} "
        f"table, {tuple(rays[0].shape)} rays) vs plain: mismatches {out}")
    check(not any(out.values()),
          "general_sweep disagrees with its plain version on the "
          "adversarial set")
    return out


def obstacle_phase(card, name, track, poses):
    """15: the facade's obstacle cycle on four backends of one map, the
    "edf" facade with its step replayed as a CUDA graph."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import RacecarSimulator
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    edf = track.edf.cpu().numpy()[: track.height, : track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    x = track.origin_x + (ix + 0.5) * track.resolution
    y = track.origin_y + (iy + 0.5) * track.resolution
    ahead = BEAMS // 2                 # the beam straight ahead
    box_x = x + 0.275 + 1.0            # 1 m ahead of the scanner
    expect = {"segments": {"levine": "dense_sweep",
                           "berlin": "list_scan"}[name],
              "sectors": "list_scan", "edf": "edf_march",
              "segments_simplified": "general_sweep"}
    out = {}
    for backend, kname in expect.items():
        graphed = backend == "edf"
        sim = RacecarSimulator(track, backend=backend, device="cuda",
                               with_noise=False, graph=graphed)
        sim.set_pose(x, y, 0.0)
        before = sim.run_scan()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.add_obstacle(box_x, y, size=0.4)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        with_box = sim.run_scan()
        stepped = sim.update_pose()
        torch.cuda.synchronize()
        used = {k: v for k, v in counts().items() if v}
        r0, r1 = float(before[ahead]), float(with_box[ahead])
        res = {"add_obstacle_host_ms": host_ms, "launches": used,
               "ahead_before": r0, "ahead_with_box": r1}
        check(0.7 < r1 < 0.9 and r1 < r0 - 0.1
              and float(stepped.ranges[ahead]) < 0.9,
              f"{name} {backend}: the box does not shorten the beam ahead "
              f"({r0} -> {r1})")
        # the scan, and the step: one launch eagerly; graphed, the capture
        # on the edited map (2 warm-up steps) and its replay
        check(used == {kname: 4 if graphed else 2},
              f"{name} {backend}: the edited map launched {used}")
        if backend == "sectors":
            inc = sim.bundle.segmap
            res["incremental"] = (
                inc.n_segments == sim._pristine_segmap.n_segments + 4
                and inc.table.shape == sim._pristine_segmap.table.shape)
            full = sim._build_segmap(sim.bundle.track)
            q = torch.as_tensor(poses[:256], device="cuda")
            kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
            same = bool(torch.equal(rs.scan_poses_sectors(inc, q, **kw),
                                    rs.scan_poses_sectors(full, q, **kw)))
            log(f"[{name}] sectors: incremental add_segments = "
                f"{res['incremental']}, ranges equal to the full rebuild's "
                f"on 256 x {BEAMS} = {same}")
            check(res["incremental"] and same, f"{name}: add_segments")
        sim.set_pose(x, y, 0.0)
        sim.clear_obstacles()
        restored = bool(torch.equal(sim.run_scan(), before))
        if graphed:
            cleared = float(sim.update_pose().ranges[ahead])
            caps = sim._step.graphed.captures
            res["graphed_step_captures"] = caps
            log(f"[{name}] {backend} graphed facade: beam ahead after "
                f"clear_obstacles {cleared:.4f} m; captures {caps}")
            check(cleared > 0.9 and caps == 2,
                  f"{name} {backend}: the graphed step read a stale EDF")
        log(f"[{name}] {card}: {backend} add_obstacle {host_ms:.1f} ms "
            f"host; beam ahead {r0:.4f} -> {r1:.4f} m; launches on the "
            f"edited map (scan + step) {used}; clear_obstacles restores "
            f"the scan bit for bit = {restored}")
        check(restored, f"{name} {backend}: clear_obstacles")
        out[backend] = res
    return out


def lidar_poses(state, car):
    """(A, 3) scanner poses of a state."""
    import torch
    d = car.scan_distance_to_base_link
    return torch.stack([state.x + d * torch.cos(state.theta),
                        state.y + d * torch.sin(state.theta), state.theta],
                       dim=-1)


def multitrack_phase(card, sec_bundles, poses_by_map, rates, errs):
    """16: multitrack serving over the two bundled maps, stacked."""
    import torch
    from pyracecarsimulator_tpu_torch.maps import stack_sector_maps
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    half = AGENTS // 2
    t0 = time.perf_counter()
    stack = stack_sector_maps([sec_bundles[m].segmap for m in MAPS])
    torch.cuda.synchronize()
    out = {"stack_s": time.perf_counter() - t0,
           "table": list(stack.table.shape),
           "table_bytes": stack.table.numel() * 4}
    log(f"[stack] {' + '.join(MAPS)} stacked in {out['stack_s']:.2f} s: "
        f"table {tuple(stack.table.shape)}, {out['table_bytes'] / 1e6:.1f} "
        f"MB, kv_sec {stack.kv_sec}, offsets {stack.offsets.tolist()}")
    check(stack.table.is_cuda and stack.table.shape[0] == sum(
        sec_bundles[m].segmap.table.shape[0] for m in MAPS), "stack shape")
    poses = torch.cat([torch.as_tensor(poses_by_map[m][:half], device="cuda")
                       for m in MAPS])
    mid = torch.arange(len(MAPS), device="cuda",
                       dtype=torch.int32).repeat_interleave(half)
    kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)

    def case(p):
        bb = rs.sector_block_width(stack, BEAMS, FOV)
        ct, st = rs.fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                            p.device))
        ids, _ = rs.stack_block_ids(stack, mid, p[:, 0], p[:, 1], ct, st,
                                    BEAMS, bb)
        return list_args(stack.table, stack.meta, ids, p, ct, st)

    sets = []
    for j in range(5):
        q = poses.clone()
        q[:, 2] += j * 1e-3
        sets.append(q)
    args = [case(q) for q in sets]
    errs["list_sweep"].append(kernel_vs_plain("stack", "list_sweep", args[0]))
    out["kernel"] = time_kernel("list_sweep", args, rates)
    log(f"[stack] {card}: list_sweep over the stacked table "
        f"{out['kernel']}")

    # the multi scan against the two per-map scans, counted
    per_map = lambda p: torch.cat([
        rs.scan_poses_sectors(sec_bundles[m].segmap,
                              p[i * half:(i + 1) * half], **kw)
        for i, m in enumerate(MAPS)])
    ref = per_map(poses)
    out["launches"] = {"list_sweep": 0}
    for mode in ("auto", "sorted_pl"):
        reset_counts()
        got = rs.scan_poses_sectors_multi(stack, mid, poses, mode=mode, **kw)
        torch.cuda.synchronize()
        used = {k: v for k, v in counts().items() if v}
        same = bool(torch.equal(got, ref))
        log(f"[stack] scan_poses_sectors_multi(mode={mode!r}) on "
            f"{tuple(got.shape)}: launches {used}, equal to the two "
            f"per-map scans bit for bit = {same}")
        check(same and used == {"list_sweep": 1},
              f"multitrack scan, mode {mode}: {used}, equal={same}")
        out["launches"]["list_sweep"] += used["list_sweep"]

    # forward + backward once
    reset_counts()
    p = poses.clone().requires_grad_(True)
    (rs.scan_poses_sectors_multi(stack, mid, p, **kw) ** 2).sum().backward()
    g = p.grad
    ok = (bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
          and counts()["list_sweep"] == 1)
    out["launches"]["list_sweep"] += counts()["list_sweep"]
    log(f"[stack] multi scan forward + backward: pose grad |.|_1 "
        f"{float(g.abs().sum()):.4f}, finite and non-zero, one launch = {ok}")
    check(ok, "multitrack gradients")

    def fwd_bwd(i):
        q = sets[i % 5].clone().requires_grad_(True)
        (rs.scan_poses_sectors_multi(stack, mid, q, **kw) ** 2
         ).sum().backward()

    out["multi_scan_ms"] = timed_ms(lambda i: rs.scan_poses_sectors_multi(
        stack, mid, sets[i % 5], **kw), 20)
    out["per_map_scans_ms"] = timed_ms(lambda i: per_map(sets[i % 5]), 20)
    out["multi_scan_ms_2"] = timed_ms(lambda i: rs.scan_poses_sectors_multi(
        stack, mid, sets[i % 5], **kw), 20)
    out["multi_fwd_bwd_ms"] = timed_ms(fwd_bwd, 10)
    log(f"[stack] {card}: multi scan {out['multi_scan_ms']:.4f} / "
        f"{out['multi_scan_ms_2']:.4f} ms, the two per-map scans "
        f"{out['per_map_scans_ms']:.4f} ms, multi forward + backward "
        f"{out['multi_fwd_bwd_ms']:.4f} ms at {AGENTS} x {BEAMS}")
    return out, stack, poses, mid


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_phase(card, bundle, stack, stack_poses, mid, poses, errs):
    """17: a 1 x 1 mesh on the card, backend NCCL, in this process."""
    import torch
    import torch.distributed as dist
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.parallel import (
        make_mesh, make_ring_scan, make_sharded_step, multihost, ringmap)
    multihost.initialize("nccl", f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0, timeout_s=120)
    try:
        mesh = make_mesh()
        one = torch.ones(4, device="cuda")
        dist.all_reduce(one)
        check(dist.get_backend() == "nccl" and mesh.shape == {
            "agents": 1, "beams": 1} and float(one.sum()) == 4.0,
              "the 1 x 1 NCCL mesh")
        kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        p = torch.as_tensor(poses, device="cuda")
        s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        out = {"launches": {}}

        # the sharded sector step against make_step_fn
        sharded = make_sharded_step(mesh, bundle, with_noise=False)
        plain = make_step_fn(bundle, with_noise=False)
        reset_counts()
        a = sharded(s0, act)
        out["launches"]["sharded sector step"] = dict(
            (k, v) for k, v in counts().items() if v)
        b = plain(s0, act)
        same = all(bool(torch.equal(u, v)) for u, v in (
            (a.ranges, b.ranges), (a.state.pose, b.state.pose),
            (a.collision, b.collision), (a.state.velocity,
                                         b.state.velocity)))
        log(f"[mesh 1x1 nccl] sharded sector step on {tuple(a.ranges.shape)}"
            f": launches {out['launches']['sharded sector step']}, equal to "
            f"make_step_fn's bit for bit = {same}")
        check(same and out["launches"]["sharded sector step"] == {
            "list_sweep": 1}, "sharded sector step")

        # the stacked step against the multitrack scan
        q = stack_poses
        stacked = make_sharded_step(mesh, bundle, with_noise=False,
                                    stack=stack)
        reset_counts()
        c = stacked(state_from_pose(q[:, 0], q[:, 1], q[:, 2]), act, mid)
        out["launches"]["stacked step"] = dict(
            (k, v) for k, v in counts().items() if v)
        ref = rs.scan_poses_sectors_multi(
            stack, mid, lidar_poses(c.state, bundle.car), **kw)
        same = bool(torch.equal(c.ranges, ref))
        log(f"[mesh 1x1 nccl] stacked step: launches "
            f"{out['launches']['stacked step']}, ranges equal to "
            f"scan_poses_sectors_multi at the stepped poses = {same}; "
            f"{int(c.collision.sum())} of {AGENTS} cars latched")
        check(same and out["launches"]["stacked step"] == {
            "list_sweep": 1}, "stacked sharded step")

        # the ring scan, one slab: its one launch sweeps the gathered
        # (G, 4, K) buffer as the table, row by row
        smap = bundle.segmap
        _, (_, meta, ids, *rays) = sector_case(smap, p)
        slab, ls = ringmap.shard_sector_table(mesh, smap)
        buf = ringmap._ring_gather(mesh, slab, ids, ls)
        errs["list_sweep"].append(kernel_vs_plain(
            f"ring buffer {tuple(buf.shape)}", "list_sweep",
            (buf, meta.index_select(0, ids.long()).contiguous(),
             torch.arange(ids.numel(), dtype=torch.int32, device="cuda"),
             *rays)))
        del slab, buf
        ring = make_ring_scan(mesh, smap, BEAMS, FOV, MAX_RANGE)
        reset_counts()
        r = ring(p)
        out["launches"]["ring scan"] = dict(
            (k, v) for k, v in counts().items() if v)
        ref = rs.scan_poses_sectors(bundle.segmap, p, **kw)
        same = bool(torch.equal(r, ref))
        log(f"[mesh 1x1 nccl] ring scan, S = 1, slab rows {ring.slab_rows}: "
            f"launches {out['launches']['ring scan']}, equal to "
            f"scan_poses_sectors bit for bit = {same}")
        check(same and out["launches"]["ring scan"] == {"list_sweep": 1}
              and ring.slab_rows == bundle.segmap.table.shape[0],
              "ring scan")

        sets = pose_sets(poses)
        state = [s0]

        def run(step, *extra):
            def one(i):
                state[0] = step(state[0], act, *extra).state
            state[0] = s0
            return timed_ms(one, 30, warmup=5)

        out["sharded_step_ms"] = run(sharded)
        out["plain_step_ms"] = run(plain)
        out["stacked_step_ms"] = run(stacked, mid)
        out["ring_scan_ms"] = timed_ms(lambda i: ring(sets[i % 5]), 20)
        out["replicated_scan_ms"] = timed_ms(
            lambda i: rs.scan_poses_sectors(bundle.segmap, sets[i % 5],
                                            **kw), 20)
        log(f"[mesh 1x1 nccl] {card}: noiseless sector step, sharded "
            f"{out['sharded_step_ms']:.4f} ms, make_step_fn "
            f"{out['plain_step_ms']:.4f} ms, stacked "
            f"{out['stacked_step_ms']:.4f} ms; ring scan "
            f"{out['ring_scan_ms']:.4f} ms, replicated scan "
            f"{out['replicated_scan_ms']:.4f} ms, at {AGENTS} x {BEAMS}")
        return out
    finally:
        dist.destroy_process_group()


def ranks_phase(card, bundle, flat, track, poses, errs):
    """18: four gloo ranks on the one card, mesh 2 x 2, berlin."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    from pyracecarsimulator_tpu_torch.maps.segments import (
        extract_segments, raycast_segments_numpy)
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops.common import (
        _ray_invs, fan_cos_sin, rays_from_poses)
    from pyracecarsimulator_tpu_torch.ops.raycast_grad import (
        raycast_all_diff)
    from pyracecarsimulator_tpu_torch.parallel import mesh as pmesh
    from pyracecarsimulator_tpu_torch.parallel.dryrun import dryrun
    n = 1024
    case = {"maps": ["berlin"], "poses": poses[:n], "action": (2.0, 0.0),
            "num_beams": BEAMS, "fov": FOV, "max_range": MAX_RANGE}
    t0 = time.perf_counter()
    res = dryrun(4, beams_axis=2, device="cuda", case=case, backend="gloo",
                 timeout_s=300)
    out = {"wall_s": time.perf_counter() - t0, "launches": res["launches"],
           "mesh": res["mesh"], "backend": res["backend"]}
    log(f"[4 ranks] dryrun(4, beams_axis=2, device='cuda') on berlin, {n} x "
        f"{BEAMS}: mesh {res['mesh']}, backend {res['backend']}, "
        f"{out['wall_s']:.1f} s wall; launches per rank {res['launches']}")
    check(res["mesh"] == (2, 2) and res["backend"] == "gloo"
          and res["launches"] == [{"list_sweep": 3, "dense_sweep": 2}] * 4,
          "the four ranks' mesh, backend or launches")

    kw = dict(num_beams=BEAMS, fov=FOV, max_range=MAX_RANGE)
    p = torch.as_tensor(poses[:n], device="cuda")

    # the sweeps the ranks launched, rebuilt here at the wedges' shapes (all
    # 1024 agents x each half of the fan), against their plain versions
    smap = bundle.segmap
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    flat_rays = lambda *v: [t.reshape(-1).contiguous() for t in v]
    for b in range(2):
        wedge = pmesh.Mesh(agents=2, beams=2, agents_index=0, beams_index=b,
                           beams_ranks=(0, 1))
        ct, st = fan_cos_sin(p[:, 2], pmesh._wedge_offsets(
            wedge, BEAMS, FOV, 0, "cuda"))
        errs["dense_sweep"].append(kernel_vs_plain(
            f"berlin untiled, wedge {b} of 2", "dense_sweep",
            (flat.params, flat.sweep_meta, *flat_rays(
                p[:, 0:1].expand(ct.shape), p[:, 1:2].expand(ct.shape), ct,
                st, *_ray_invs(ct, st)))))
        ct, st = fan_cos_sin(p[:, 2], pmesh._wedge_offsets(
            wedge, BEAMS, FOV, bb, "cuda"))
        ids = rs._list_ids(smap.tiles_shape, smap.tile_size,
                           smap.tile_origin, smap.ns, p[:, 0], p[:, 1], ct,
                           st, bb)
        args = list_args(smap.table, smap.meta, ids, p, ct, st)
        errs["list_sweep"].append(kernel_vs_plain(
            f"berlin sectors, wedge {b} of 2", "list_sweep", args))
        rows = args[2].long()
        errs["list_sweep"].append(kernel_vs_plain(
            f"berlin ring buffer, wedge {b} of 2", "list_sweep",
            (smap.table.index_select(0, rows),
             smap.meta.index_select(0, rows).contiguous(),
             torch.arange(rows.numel(), dtype=torch.int32, device="cuda"),
             *args[3:])))

    def with_grad(fn):
        q = p.clone().requires_grad_(True)
        r = fn(q)
        (r ** 2).sum().backward()
        return r.detach().cpu().numpy(), q.grad.cpu().numpy()

    def dense(q):
        _, _, xb, yb, ct, st = rays_from_poses(q, BEAMS, FOV)
        return raycast_all_diff(flat.params, flat.sweep_meta, xb, yb, ct,
                                st, MAX_RANGE)

    refs = {"sectors": with_grad(lambda q: rs.scan_poses_sectors(
        bundle.segmap, q, **kw)), "dense": with_grad(dense)}
    for kind, keys in (("sectors", ("scan_sectors", "grad_sectors")),
                       ("dense", ("scan_dense", "grad_dense")),
                       ("sectors", ("ring", "ring_grad"))):
        r_ref, g_ref = refs[kind]
        d = np.abs(res[keys[0]] - r_ref)
        share = float(np.mean(d <= 1e-5))
        g_err = float(np.abs(res[keys[1]] - g_ref).max()
                      / np.abs(g_ref).max())
        out[keys[0]] = {"share_within_1e-5": share,
                        "max_abs_diff": float(d.max()),
                        "equal": bool(np.array_equal(res[keys[0]], r_ref)),
                        "grad_rel_err": g_err}
        log(f"[4 ranks] {keys[0]} vs the unsharded run: {out[keys[0]]}")
        check(share >= 0.999 and g_err <= 1e-4,
              f"four ranks: {keys[0]} differs from the unsharded run")

    # the gathered ranges against the float64 oracle
    segs = extract_segments(track.occupancy.cpu().numpy(), track.resolution,
                            (track.origin_x, track.origin_y))
    _, _, _, _, ct, st = rays_from_poses(p[:4], BEAMS, FOV)
    ora = np.stack([raycast_segments_numpy(
        segs, np.full(BEAMS, poses[i, 0], np.float64),
        np.full(BEAMS, poses[i, 1], np.float64),
        ct[i].cpu().numpy().astype(np.float64),
        st[i].cpu().numpy().astype(np.float64), MAX_RANGE)
        for i in range(4)])
    for key in ("scan_sectors", "scan_dense", "ring"):
        share = float(np.mean(np.abs(res[key][:4] - ora) <= 1e-4))
        log(f"[4 ranks] gathered {key} ranges vs the float64 oracle, 4 "
            f"poses: share within 1e-4 m = {share}")
        check(share >= 0.999,
              f"four ranks: {key} ranges disagree with the oracle")

    # the sharded steps against make_step_fn
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((n,), 2.0, device="cuda"),
           torch.zeros(n, device="cuda"))
    for kind, b in (("sectors", bundle),
                    ("dense", bundle._replace(segmap=flat,
                                              backend="segments"))):
        ref = make_step_fn(b, with_noise=False)(s0, act)
        got = res[f"step_{kind}"]
        share = float(np.mean(np.abs(
            got["ranges"] - ref.ranges.cpu().numpy()) <= 1e-5))
        same = bool(np.array_equal(got["collision"],
                                   ref.collision.cpu().numpy()))
        dx = float(np.abs(got["state"]["x"]
                          - ref.state.x.cpu().numpy()).max())
        out[f"step_{kind}"] = {"share_within_1e-5": share,
                               "collisions_equal": same, "max_dx": dx}
        log(f"[4 ranks] step_{kind} vs make_step_fn: "
            f"{out[f'step_{kind}']}")
        check(share >= 0.999 and same and dx <= 1e-6,
              f"four ranks: step_{kind} differs from the unsharded step")
    check(res["slab_rows"] * 2 == res["table_rows"], "ring slab rows")
    return out


def tooling_phase(card, bundle, poses):
    """19: utils.debug.checked and utils.profiling.rays_per_second."""
    import torch
    from pyracecarsimulator_tpu_torch import (make_scan_fn, make_step_fn,
                                              state_from_pose)
    from pyracecarsimulator_tpu_torch.state import set_field
    from pyracecarsimulator_tpu_torch.utils.debug import checked
    from pyracecarsimulator_tpu_torch.utils.profiling import rays_per_second
    p = torch.as_tensor(poses, device="cuda")
    s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((AGENTS,), 2.0, device="cuda"),
           torch.zeros(AGENTS, device="cuda"))
    safe = checked(make_step_fn(bundle, with_noise=False))
    out = safe(s0, act)
    check(bool(torch.isfinite(out.ranges).all()), "checked: clean step")
    x = s0.x.clone()
    x[7] = float("nan")
    raised = ""
    try:
        safe(set_field(s0, x=x), act)
    except FloatingPointError as e:
        raised = str(e)
    log(f"checked(step): a clean step passes; an injected NaN raises "
        f"{raised!r}")
    check("non-finite x" in raised, "checked did not raise on a NaN")
    rate = rays_per_second(make_scan_fn(bundle), p, BEAMS, reps=20)
    log(f"[berlin] {card}: rays_per_second of the sector scan at {AGENTS} "
        f"x {BEAMS}: {rate:.4e} rays/s")
    check(rate > 0 and math.isfinite(rate), "rays_per_second")
    return {"rays_per_second": rate}


def host_ms(fn, reps=1):
    """Mean host milliseconds of ``fn()`` over ``reps`` calls, and the last
    result."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def host_cpu() -> str:
    """The host CPU as ``lscpu`` or ``/proc/cpuinfo`` name it: the model
    name, with vendor, family and model numbers beside it (a virtual
    machine may report the name as "unknown")."""
    texts = []
    try:
        texts.append(subprocess.run(["lscpu"], capture_output=True,
                                    text=True, timeout=60).stdout)
    except OSError:
        pass
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            texts.append(f.read())

    def field(key):
        for text in texts:
            m = re.search(rf"^{key}\s*:\s*(\S.*)$", text,
                          re.IGNORECASE | re.MULTILINE)
            if m:
                return m.group(1).strip()
        return "not reported"

    return (f"model name {field('model name')!r} (vendor "
            f"{field('vendor(?: |_)id')}, family {field('cpu family')}, "
            f"model {field('model')})")


def native_phase(card):
    """20: the native host tier against its NumPy bodies, per map at full
    size, and the map builds' host times with either body."""
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import build_sim
    from pyracecarsimulator_tpu_torch._native import loader as native
    from pyracecarsimulator_tpu_torch.maps import (add_obstacle, edt_numpy,
                                                   load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.maps import sectors, segments
    from pyracecarsimulator_tpu_torch.oracle import raycast as orc
    host = f"{host_cpu()}, {os.cpu_count()} cores"
    check(native.compiler() is not None,
          "no C++ compiler on PATH ($CXX, else g++): the native tier "
          "cannot be built on this machine")
    t0 = time.perf_counter()
    check(native.available(), "the native library did not load")
    log(f"native host library: {native.build_info['path']} built in "
        f"{native.build_info['seconds']:.2f} s (available after "
        f"{time.perf_counter() - t0:.2f} s) with "
        f"{' '.join(native.compiler())} {' '.join(native.CXX_FLAGS)}; host: "
        f"{host}")
    out = {"host": host, "build_s": native.build_info["seconds"]}
    set_of = lambda segs: set(map(tuple, np.round(segs, 9)))
    for name in MAPS:
        res = {}
        native.reset_call_counts()
        with native.numpy_only():
            res["load_builtin_numpy_ms"], track = host_ms(
                lambda: load_builtin(name, device="cuda"))
        check(sum(native.call_counts().values()) == 0,
              "numpy_only() let a native call through")
        res["load_builtin_native_ms"], track_n = host_ms(
            lambda: load_builtin(name, device="cuda"), 3)
        check(native.edt.calls == 3, "load_builtin: the native EDT did not "
              f"run ({native.call_counts()})")
        check(bool(torch.equal(track.edf, track_n.edf))
              and bool(torch.equal(track.occupancy, track_n.occupancy)),
              f"{name}: load_builtin differs between the bodies")
        occ_p = track.occupancy.cpu().numpy()
        occ = occ_p[: track.height, : track.width]
        org = (track.origin_x, track.origin_y)
        hw = (track.height, track.width)

        # rc_edt against edt_numpy on the padded grid
        filled = occ_p >= 0.5
        res["edt_numpy_ms"], ref = host_ms(lambda: edt_numpy(filled))
        res["edt_native_ms"], got = host_ms(lambda: native.edt(filled), 3)
        res["edt_max_abs_diff_cells"] = float(np.abs(got - ref).max())
        check(np.array_equal(got, ref), f"{name}: rc_edt differs from "
              f"edt_numpy by {res['edt_max_abs_diff_cells']} cells")

        # rc_extract_segments against extract_segments (grid units)
        res["extract_python_ms"], segs_grid = host_ms(
            lambda: segments.extract_segments(occ, 1.0, (0.0, 0.0)))
        res["extract_native_ms"], got = host_ms(
            lambda: native.extract_segments(occ >= 0.5), 3)
        check(len(got) == len(segs_grid)
              and set_of(got) == set_of(segs_grid),
              f"{name}: rc_extract_segments gives another segment set")
        res["segments"] = len(got)

        # rc_sector_membership against the NumPy body, the sector
        # backend's geometry (tile 2 m, 16 sectors)
        segs = segments.extract_segments(occ_p, track.resolution, org)
        ts, ns = 2.0, 16
        nr = int(np.ceil(occ_p.shape[0] * track.resolution / ts))
        nc = int(np.ceil(occ_p.shape[1] * track.resolution / ts))
        rt = ts * np.sqrt(2.0) / 2.0 + 2.0 * track.resolution
        margs = (segs, nr, nc, ns, ts, org[0], org[1], rt, MAX_RANGE + rt,
                 0.285)
        with native.numpy_only():
            res["membership_numpy_ms"], ref = host_ms(
                lambda: sectors._membership(*margs))
        res["membership_native_ms"], got = host_ms(
            lambda: sectors._membership(*margs), 3)
        differ = int((got != ref).sum())
        res["membership_entries"] = int(ref.size)
        res["membership_differing"] = differ
        log(f"[{name}] membership {ref.shape}: {differ} differing entries; "
            f"list lengths in all {int(got.sum())} native, {int(ref.sum())} "
            "NumPy")
        check(differ == 0, f"{name}: rc_sector_membership differs from the "
              f"NumPy body in {differ} entries")

        # the two oracles on rays from 64 free poses
        poses = sample_free_poses(track, ORACLE_POSES,
                                  np.random.RandomState(1))
        ang = poses[:, 2:3].astype(np.float64) + orc.beam_angles(64, FOV)
        xs = np.repeat(poses[:, 0].astype(np.float64), 64)
        ys = np.repeat(poses[:, 1].astype(np.float64), 64)
        cts, sts = np.cos(ang).ravel(), np.sin(ang).ravel()
        res["raycast_numpy_ms"], ref = host_ms(
            lambda: segments.raycast_segments_numpy(segs, xs, ys, cts, sts,
                                                    MAX_RANGE))
        res["raycast_native_ms"], got = host_ms(
            lambda: native.raycast_segments(segs, xs, ys, cts, sts,
                                            MAX_RANGE), 3)
        res["raycast_max_abs_diff"] = float(np.abs(got - ref).max())
        check(res["raycast_max_abs_diff"] <= 1e-9,
              f"{name}: rc_raycast_segments off by "
              f"{res['raycast_max_abs_diff']}")
        edf_np = track.edf.cpu().numpy()
        # the Python body on a float64 copy of the EDF: on the float32 grid
        # NumPy 2 sums a ray's steps as float32 scalars, rc_trace_rays in
        # double
        edf64 = edf_np.astype(np.float64)
        res["trace_python_ms"], ref = host_ms(lambda: np.array([
            orc.trace_ray(edf64, track.resolution, org, xs[i], ys[i],
                          cts[i], sts[i], MAX_RANGE, 1e-4, 2000,
                          bounds_hw=hw) for i in range(len(xs))]))
        res["trace_native_ms"], got = host_ms(
            lambda: native.trace_rays(edf_np, hw, track.resolution, org, xs,
                                      ys, cts, sts, MAX_RANGE, 1e-4, 2000),
            3)
        res["trace_rays"] = len(xs)
        res["trace_max_abs_diff"] = float(np.abs(got - ref).max())
        check(res["trace_max_abs_diff"] <= 1e-6,
              f"{name}: rc_trace_rays off by {res['trace_max_abs_diff']}")

        # the entry points a user calls, with either body
        x, y = float(poses[0, 0]), float(poses[0, 1])
        for label, fn, counted in (
                ("build_sim_sectors",
                 lambda: build_sim(name, backend="sectors", device="cuda"),
                 ("edt", "sector_membership")),
                ("add_obstacle",
                 lambda: add_obstacle(track, x, y, size=0.4), ("edt",))):
            with native.numpy_only():
                res[f"{label}_numpy_ms"], ref = host_ms(fn)
            native.reset_call_counts()
            res[f"{label}_native_ms"], got = host_ms(fn, 3)
            used = native.call_counts()
            check(all(used[k] == 3 for k in counted),
                  f"{name} {label}: the native bodies did not run ({used})")
            same = bool(torch.equal(getattr(ref, "track", ref).edf,
                                    getattr(got, "track", got).edf))
            if label == "build_sim_sectors":
                same = same and all(
                    bool(torch.equal(getattr(ref.segmap, f),
                                     getattr(got.segmap, f)))
                    for f in ("table", "meta"))
            check(same, f"{name} {label}: the bodies' maps differ")
        log(f"[{name}] {card}; host {host}: native vs NumPy/Python body, "
            f"host ms: " + ", ".join(
                f"{k} {res[f'{k}_native_ms']:.2f} vs {res[other]:.2f}"
                for k, other in (
                    ("edt", "edt_numpy_ms"),
                    ("extract", "extract_python_ms"),
                    ("membership", "membership_numpy_ms"),
                    ("raycast", "raycast_numpy_ms"),
                    ("trace", "trace_python_ms"),
                    ("load_builtin", "load_builtin_numpy_ms"),
                    ("build_sim_sectors", "build_sim_sectors_numpy_ms"),
                    ("add_obstacle", "add_obstacle_numpy_ms"))))
        out[name] = res
    native.reset_call_counts()
    return out


def examples_phase(card):
    """21: every demo of examples/torch/ through its main([...]) on the
    card. Returns {demo: {"seconds", "launches", "result"}}."""
    import importlib.util
    import numpy as np
    import torch
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch")
    wide = ["--agents", str(AGENTS), "--beams", str(BEAMS)]
    runs = (
        ("demo_rollout", [*wide, "--steps", "200"], "dense_sweep"),
        ("demo_gradients", [], "dense_sweep"),
        ("demo_mpc", ["--candidates", str(AGENTS), "--beams", str(BEAMS),
                      "--control-steps", "5"], "dense_sweep"),
        ("demo_bptt", ["--iters", "10"], "dense_sweep"),
        ("demo_train", [*wide, "--iters", "8"], "list_sweep"),
        ("demo_mapping", ["--iters", "60"],
         ("edf_march", "soft_edt", "soft_edt_grad")),
        ("demo_mapping --fast", [], "list_sweep"),
        ("demo_multitrack", wide, "list_sweep"),
        # one rank, as torchrun would set it; the demo's own 65536 agents
        ("demo_multihost", ["--beams", str(BEAMS), "--steps", "5"],
         "list_sweep"),
    )
    rendezvous = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
                  "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    out = {}
    for label, argv, kname in runs:
        name, *flags = label.split()
        argv = flags + argv
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(root, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if name == "demo_multihost":
            os.environ.update(rendezvous)
        log(f"--- {name} {' '.join(argv)}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = {k: v for k, v in counts().items() if v}
        if name == "demo_multihost":
            for k in rendezvous:
                del os.environ[k]
        log(f"--- {label}: {seconds:.2f} s on {card}; launches {used}")
        check(not torch.distributed.is_initialized(),
              f"{label} left its process group open")
        names = (kname,) if isinstance(kname, str) else kname
        check(all(used.get(k, 0) > 0 for k in names),
              f"{label}: expected launches of {kname}, got {used}")
        out[label] = {"seconds": seconds, "launches": used, "result": res}
    r = {k: v["result"] for k, v in out.items()}
    check(r["demo_gradients"]["xy_err"] < 0.01,
          f"demo_gradients ends {r['demo_gradients']['xy_err']} m off")
    check(r["demo_bptt"]["final_loss"] < r["demo_bptt"]["first_loss"],
          "demo_bptt did not improve its objective")
    for k in ("demo_train", "demo_mapping"):
        losses = r[k]["losses"]
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{k}: the loss does not fall: {losses[0]} -> {losses[-1]}")
    fast = r["demo_mapping --fast"]
    check(fast["final_rmse"] < fast["rmse_trace"][0]
          and fast["native_calls"]["edt"] > 0
          and fast["native_calls"]["sector_membership"] > 0,
          f"demo_mapping --fast: {fast}")
    check(0.0 <= r["demo_rollout"]["crashed"] <= 1.0
          and r["demo_rollout"]["mean_speed"] > 0
          and r["demo_mpc"]["control_steps"] >= 1, "demo_rollout / demo_mpc")
    return out


def load_tool(rel):
    """A script of the checkout as a module (its ``main`` is called in
    this process)."""
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(f"tool_{name}",
                                                  os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parity_phase(card, poses):
    """22: the parity report on the card. Returns the report and the
    launches it caused."""
    import torch
    from pyracecarsimulator_tpu_torch.ops.common import (beam_angles,
                                                         quantize_angles)
    tool = load_tool("scripts/parity_report_torch.py")
    reset_counts()
    t0 = time.perf_counter()
    out = tool.main(["--poses", "16"])
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    log(f"--- parity report: {time.perf_counter() - t0:.1f} s on {card}; "
        f"launches {used}")
    check(out["device"] == card, f"the report ran on {out['device']}")
    check(sorted({r["map"] for r in out["rows"]}) == sorted(MAPS)
          and len(out["rows"]) == 11 * len(MAPS)
          and len(out["grads"]) == 2 * len(MAPS), "the report's rows")
    for r in out["rows"] + out["grads"]:
        label = f"parity report, {r['map']} {r.get('backend', r.get('check'))}"
        if r["kernel"]:
            check(r["launches"].get(r["kernel"], 0) >= 1,
                  f"{label}: {r['kernel']} was not launched "
                  f"({r['launches']})")
        if "check" in r:
            check(r["max_abs_diff"] <= 1e-5,
                  f"{label}: max |d| {r['max_abs_diff']}")
        elif r["kernel"] and r["kernel"] != "edf_march":
            check(r["share_within_1e-4"] >= 0.999,
                  f"{label}: {r['share_within_1e-4']} of the beams within "
                  "1e-4 m of the geometry oracle")
        elif r["backend"] == "edf march":
            check(r["share_within_1e-3"] >= 0.99,
                  f"{label}: {r['share_within_1e-3']} of the beams within "
                  "1e-3 m of the march oracle")
    # the theta-bucket table on the card against the CPU, the full fan
    ang = (torch.as_tensor(poses[:, 2], device="cuda")[:, None]
           + beam_angles(BEAMS, FOV, "cuda")[None, :])
    same = bool(torch.equal(quantize_angles(ang, 2000).cpu(),
                            quantize_angles(ang.cpu(), 2000)))
    log(f"quantize_angles on {tuple(ang.shape)} angles, cuda vs CPU: "
        f"bit-identical = {same}")
    check(same, "quantize_angles differs between the card and the CPU")
    return {"rows": out["rows"], "grads": out["grads"], "launches": used}


def bench_phase(card):
    """23: bench_torch.py at full width with its defaults. Returns its
    record and the launches it caused."""
    import torch
    from pyracecarsimulator_tpu_torch.ops import _kernels
    tool = load_tool("bench_torch.py")
    out_dir = os.environ.get("CHIP_SMOKE_OUT") or _kernels.BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    reset_counts()
    out = tool.main(["--detail",
                     os.path.join(out_dir, "BENCH_TORCH_DETAIL.json")])
    torch.cuda.synchronize()
    used = {k: v for k, v in counts().items() if v}
    log(f"--- bench_torch: {out['seconds']:.1f} s on {card}; launches "
        f"{used}")
    check(out["device"] == card and out["agents"] == AGENTS
          and out["beams"] == BEAMS, "bench_torch's device or width")
    check(not out["failed"], f"bench_torch: failed stages {out['failed']}")
    check(len(out["gates"]) == 5
          and all(v == 0.0 for v in out["gates"].values()),
          f"bench_torch: gates {out['gates']}")
    for key, t in out["timing"].items():
        log(f"{card}: bench_torch {key} = {out['rates'][key]:.4e} /s "
            f"(median {t['median_ms']:.4f} ms, spread {t['spread']:.3f}, "
            f"launches {t['launches']})")
        check(not t["kernel"] or t["launches"].get(t["kernel"], 0) > 0,
              f"bench_torch {key}: {t['kernel']} was not launched")
    check(all(math.isfinite(v) and v > 0 for v in out["rates"].values())
          and len(out["rates"]) == 42, "bench_torch's rates")
    return {"rates": out["rates"], "gates": out["gates"],
            "timing": out["timing"], "seconds": out["seconds"],
            "launches": used}


def graph_phase(card, seg_bundles, sec_bundles, poses_by_map, tracks):
    """24: the step, the rollout and the BPTT train step replayed as CUDA
    graphs, each held against its eager version bit for bit, counted and
    timed, on the exact backends, the three EDF backends and the
    simplified one. Returns ({cell: results}, {cell: launch counts})."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pyracecarsimulator_tpu_torch import (RacecarSimulator, SimParams,
                                              build_sim, make_scan_fn,
                                              make_step_fn, state_from_pose)
    from pyracecarsimulator_tpu_torch.parallel import (
        make_bptt_train_fn, make_gap_follower_policy, make_rollout_fn)
    from pyracecarsimulator_tpu_torch.state import FIELDS
    T = 25
    kernel_of = {("levine", "segments"): "dense_sweep",
                 ("berlin", "segments"): "list_scan",
                 ("levine", "sectors"): "list_scan",
                 ("berlin", "sectors"): "list_scan",
                 ("levine", "segments_simplified"): "general_sweep",
                 ("berlin", "segments_simplified"): "general_sweep"}

    def same_state(a, b):
        return all(bool(torch.equal(getattr(a, f), getattr(b, f)))
                   for f in FIELDS)

    def same_out(a, b):
        return (bool(torch.equal(a.ranges, b.ranges))
                and bool(torch.equal(a.collision, b.collision))
                and same_state(a.state, b.state))

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def train_policy(params, state, ranges, t):
        steer = torch.tanh(ranges @ params["w"] + params["b"])
        return torch.full(state.batch_shape, 2.0, device="cuda"), steer

    def train_loss(out, t):
        return (torch.mean((out.ranges - 10.0) ** 2)
                + 10.0 * torch.mean(out.collision.float()))

    def edf_train_loss(out, t):
        # the nearest march's ranges carry no gradient (its cell indices
        # are integers, as in JAX): a steering target keeps one
        return train_loss(out, t) + torch.mean(
            (out.state.steer_angle - 0.1) ** 2)

    out, launches = {}, {}
    for name in MAPS:
        cells = [("segments", seg_bundles[name]),
                 ("sectors", sec_bundles[name])]
        cells += [(b, build_sim(tracks[name], backend=b, device="cuda"))
                  for b in ("edf", "edf_implicit", "edf_bilinear",
                            "segments_simplified")]
        for backend, bundle in cells:
            cell = f"{name} {backend}"
            exact = backend in ("segments", "sectors")
            kname = kernel_of.get((name, backend), "edf_march")
            reps = 50 if exact else 20
            res = {}
            p = torch.as_tensor(poses_by_map[name], device="cuda")
            s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
            act = (torch.full((AGENTS,), 2.0, device="cuda"),
                   torch.zeros(AGENTS, device="cuda"))
            reset_counts()

            # the step: 4 replays with changing inputs, noise on
            eager = make_step_fn(bundle, with_noise=True)
            graphed = make_step_fn(bundle, with_noise=True, graph=True)
            gen_e, gen_g = seeded(5), seeded(5)
            t0 = time.perf_counter()
            graphed.graphed.prepare(s0, act, gen_g)
            torch.cuda.synchronize()
            res["step_capture_s"] = time.perf_counter() - t0
            before = counts()[kname]
            se, sg, same = s0, s0, []
            for i in range(4):
                a = (act[0] + 0.25 * i, act[1] + 0.02 * i)
                oe, og = eager(se, a, gen_e), graphed(sg, a, gen_g)
                same.append(same_out(oe, og))
                se, sg = oe.state, og.state
            grown = counts()[kname] - before
            log(f"[{cell}] graphed step against the eager step, 4 replays, "
                f"noise on from one seed: ranges, collision and every state "
                f"field bit-identical = {same}; 1 capture = "
                f"{graphed.graphed.captures == 1}; {kname} launches of the 4 "
                f"eager and 4 replayed steps {grown}")
            check(all(same) and graphed.graphed.captures == 1 and grown == 8,
                  f"{cell}: the graphed step differs from the eager step")

            # the rollout, noise off and on
            policy = make_gap_follower_policy(BEAMS, bundle.scan.fov)
            for noise in (False, True):
                run_e = make_rollout_fn(eager, policy, T, BEAMS,
                                        keep_scans=True, graph=False)
                run_g = make_rollout_fn(eager, policy, T, BEAMS,
                                        keep_scans=True, graph=True)
                ge, gg = (seeded(9), seeded(9)) if noise else (None, None)
                fe, te = run_e(s0, ge)
                fg, tg = run_g(s0, gg)
                same = (all(bool(torch.equal(te[k], tg[k])) for k in te)
                        and set(te) == set(tg) == {"pose", "collision",
                                                   "ranges"}
                        and same_state(fe, fg))
                # replayed once more: T launches on the counter, T graph
                # launches from the host, the next draws of the generators
                before = counts()[kname]
                fe, te = run_e(s0, ge)
                mid = counts()[kname]
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fg, tg = run_g(s0, gg)
                    torch.cuda.synchronize()
                again = all(bool(torch.equal(te[k], tg[k])) for k in te)
                n_graph = sum(e.count for e in prof.key_averages()
                              if e.key == "cudaGraphLaunch")
                log(f"[{cell}] graphed rollout against the eager loop, T = "
                    f"{T}, noise {'on' if noise else 'off'}: poses, "
                    f"collisions, kept scans and the final state "
                    f"bit-identical = {same}, a second rollout too = {again}"
                    f"; {kname} launches: eager {mid - before}, replayed "
                    f"{counts()[kname] - mid}; cudaGraphLaunch calls "
                    f"{n_graph}")
                check(same and again and mid - before == T
                      and counts()[kname] - mid == T and n_graph == T,
                      f"{cell}: the graphed rollout, noise {noise}")
            res["rollout_cuda_graph_launches"] = n_graph

            if exact:
                # a policy that depends on t: after step 0 it gets the device's
                # step index; a Python branch on it fails the capture (the
                # exact backends: the EDF cells share the policy code)
                seq = torch.linspace(-0.4, 0.4, T, device="cuda")
                open_loop = lambda s, r, t: (act[0], seq[t].expand(AGENTS))
                stale_loop = lambda s, r, t: open_loop(s, r, min(t, 1))
                fe, te = make_rollout_fn(eager, open_loop, T, BEAMS,
                                         graph=False)(s0)
                _, stale = make_rollout_fn(eager, stale_loop, T, BEAMS,
                                           graph=False)(s0)
                run_g = make_rollout_fn(eager, open_loop, T, BEAMS)
                same = []
                for _ in range(2):
                    fg, tg = run_g(s0)
                    same.append(all(bool(torch.equal(te[k], tg[k])) for k in te)
                                and same_state(fe, fg))
                differs = not bool(torch.equal(stale["pose"], te["pose"]))
                raised = ""
                try:
                    make_rollout_fn(
                        eager, lambda s, r, t: open_loop(s, r, 0 if t < 3 else 1),
                        T, BEAMS)(s0)
                except RuntimeError as e:
                    raised = str(e)
                log(f"[{cell}] graphed rollout with the open-loop policy "
                    f"steer_seq[t], T = {T}, twice: poses, collisions and the "
                    f"final state bit-identical to the eager loop = {same}; the "
                    f"eager loop with t held at 1 differs = {differs}; a policy "
                    f"that branches on t in Python raises: {raised[:160]!r}")
                check(all(same) and differs and "t >= 1" in raised
                      and "graph=False" in raised,
                      f"{cell}: the graphed rollout with a policy that depends "
                      f"on t")
                del run_g

            # the train step: 3 steps each way
            smooth = bundle._replace(sim=SimParams(steer_mode="smooth"))
            tstep = make_step_fn(smooth, with_noise=False)
            loss_fn = train_loss if exact else edf_train_loss
            got = {}
            for graph in (False, True):
                train, init = make_bptt_train_fn(
                    tstep, train_policy, loss_fn, TRAIN_T, BEAMS,
                    optimizer=lambda ps: torch.optim.Adam(
                        ps, lr=3e-3, capturable=True), graph=graph)
                params = {"w": torch.zeros(BEAMS, device="cuda"),
                          "b": torch.zeros((), device="cuda")}
                opt = init(params)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = []
                for _ in range(3):
                    params, opt, loss, final = train(params, opt, s0)
                    losses.append(loss.clone())
                torch.cuda.synchronize()
                first3 = time.perf_counter() - t0
                got[graph] = (torch.stack(losses),
                              params["w"].detach().clone(),
                              params["b"].detach().clone(), final)
                key = "graphed" if graph else "eager"
                res[f"train_{key}_first_3_steps_s"] = first3
                vjps = counts()["implicit_pose_vjp"]
                res[f"train_{key}_ms"] = timed_ms(
                    lambda i: train(params, opt, s0), 5, warmup=1)
                # the implicit march's pose VJP: one launch a step of a
                # call but the first, eager or replayed (the first step's
                # scan pose moves with the state's speed and steering,
                # before the action acts: no parameter reaches it); none
                # on the other backends
                vjps = counts()["implicit_pose_vjp"] - vjps
                check(vjps == (6 * (TRAIN_T - 1)
                               if backend == "edf_implicit" else 0),
                      f"{cell}: 6 {key} train steps launched "
                      f"implicit_pose_vjp {vjps} times")
                if graph:
                    check(train.graphed.captures == 1
                          and train.graphed.replays == 9,
                          f"{cell}: the train step captured "
                          f"{train.graphed.captures} times")
                    train.graphed.release()
            same = (all(bool(torch.equal(a, b))
                        for a, b in zip(got[False][:3], got[True][:3]))
                    and same_state(got[False][3], got[True][3]))
            moved = float(got[True][1].abs().sum())
            log(f"[{cell}] graphed BPTT train step against the eager one, T "
                f"= {TRAIN_T}, Adam(capturable=True), 3 steps: losses "
                f"{got[True][0].tolist()}, losses, w, b and the final state "
                f"bit-identical = {same}; |w|_1 {moved}")
            check(same and moved > 0 and bool(
                torch.isfinite(got[True][0]).all()),
                f"{cell}: the graphed train step differs from the eager one")
            if backend == "edf_bilinear":
                check(counts()["edf_march_grad"] > 0,
                      f"{cell}: the train step's backward did not launch "
                      f"edf_march_grad")

            if exact:
                # graph=None and an Adam that counts its steps on the host: the
                # eager step, not an error
                train, init = make_bptt_train_fn(
                    tstep, train_policy, train_loss, TRAIN_T, BEAMS,
                    optimizer=lambda ps: torch.optim.Adam(ps, lr=3e-3))
                params = {"w": torch.zeros(BEAMS, device="cuda"),
                          "b": torch.zeros((), device="cuda")}
                opt = init(params)
                for _ in range(2):
                    params, opt, loss, _ = train(params, opt, s0)
                check(train.graphed.captures == 0
                      and bool(torch.isfinite(loss))
                      and float(params["w"].detach().abs().sum()) > 0,
                      f"{cell}: graph=None with a host-counting Adam did not "
                      f"train eagerly")

            # times, eager and graphed
            state = [s0]

            def stepper(step, gen):
                def one(i):
                    state[0] = step(state[0], act, gen).state
                return one

            run_e = make_rollout_fn(eager, policy, T, BEAMS, graph=False)
            run_g = make_rollout_fn(eager, policy, T, BEAMS)
            for key, fn in (("eager", stepper(eager, gen_e)),
                            ("graphed", stepper(graphed, gen_g))):
                state[0] = s0
                res[f"step_{key}_ms"] = timed_ms(fn, reps, warmup=5)
            t0 = time.perf_counter()
            run_g(s0)
            torch.cuda.synchronize()
            res["rollout_first_call_s"] = time.perf_counter() - t0
            for key, fn in (("eager", run_e), ("graphed", run_g)):
                res[f"rollout_{key}_ms_per_step"] = timed_ms(
                    lambda i: fn(s0), 4 if exact else 2, warmup=1) / T
            # steps after which a rollout's first call (warm-up, 2 captures)
            # has cost less than the eager loop
            saved = (res["rollout_eager_ms_per_step"]
                     - res["rollout_graphed_ms_per_step"])
            extra = (res["rollout_first_call_s"] * 1e3
                     - T * res["rollout_graphed_ms_per_step"])
            res["rollout_break_even_steps"] = (
                extra / saved if saved > 0 else math.inf)

            # the graphed step under the profiler: launches, busy, idle
            state[0] = s0
            one = stepper(graphed, gen_g)
            n_prof = 10
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(n_prof):
                    one(i)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in events) / 1e3 / n_prof
            res["graphed_step_device_launches"] = (
                sum(e.count for e in events) / n_prof)
            res["graphed_step_cuda_graph_launches"] = sum(
                e.count for e in prof.key_averages()
                if e.key == "cudaGraphLaunch") / n_prof
            check(busy > 0, f"{cell}: the trace of the graphed step holds "
                  f"no device time")
            if backend == "edf_implicit":
                # the refinement runs inside the march's one launch: the
                # step launches about what the "edf" step does
                edf_step = out[f"{name} edf"]["graphed_step_device_launches"]
                check(res["graphed_step_device_launches"] <= edf_step + 20,
                      f"{cell}: the graphed step launches "
                      f"{res['graphed_step_device_launches']} device kernels "
                      f"against the edf step's {edf_step}")
            res["graphed_step_device_busy_ms"] = busy
            res["graphed_step_idle_share"] = 1 - busy / res["step_graphed_ms"]

            # 10 scans after the first: no synchronisation, no host copy
            scan = make_scan_fn(bundle)
            scan(p)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    scan(p)
                torch.cuda.synchronize()    # ends the trace
            host_calls = {e.key: e.count for e in prof.key_averages()
                          if e.key in ("cudaStreamSynchronize",
                                       "cudaMemcpyAsync", "cudaMemcpy")
                          or e.key.startswith("Memcpy HtoD")}
            log(f"[{cell}] 10 scans after the first: synchronisations and "
                f"copies in the trace {host_calls}")
            check(not host_calls, f"{cell}: a scan still synchronises or "
                  f"copies from the host: {host_calls}")
            res["scan_host_syncs_and_copies"] = host_calls

            launches[cell] = {k: v for k, v in counts().items() if v}
            log(f"[{cell}] {card}: step eager {res['step_eager_ms']:.4f} ms, "
                f"graphed {res['step_graphed_ms']:.4f} ms (capture "
                f"{res['step_capture_s']:.3f} s); rollout per step eager "
                f"{res['rollout_eager_ms_per_step']:.4f} ms, graphed "
                f"{res['rollout_graphed_ms_per_step']:.4f} ms (first call "
                f"with its 2 captures {res['rollout_first_call_s']:.3f} s, "
                f"paid back after {res['rollout_break_even_steps']:.0f} "
                f"steps); train step T = {TRAIN_T} "
                + (f"eager {res['train_eager_ms']:.4f} ms, graphed "
                   f"{res['train_graphed_ms']:.4f} ms (first 3 steps with "
                   f"the capture "
                   f"{res['train_graphed_first_3_steps_s']:.3f} s)")
                + "; graphed step under the profiler: "
                f"{res['graphed_step_device_launches']:.0f} device launches, "
                f"{res['graphed_step_cuda_graph_launches']:.0f} "
                f"cudaGraphLaunch, device busy "
                f"{res['graphed_step_device_busy_ms']:.4f} ms, idle share "
                f"{res['graphed_step_idle_share']:.4f}; launches of this "
                f"cell "
                f"{launches[cell]}")
            out[cell] = res
            graphed.graphed.release()
            del run_g, run_e, graphed
            torch.cuda.empty_cache()

        # a map swap under the graph: the facade, graphed against eager
        track = tracks[name]
        edf = track.edf.cpu().numpy()[: track.height, : track.width]
        iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
        x = track.origin_x + (ix + 0.5) * track.resolution
        y = track.origin_y + (iy + 0.5) * track.resolution
        for backend in ("segments", "sectors", "edf"):
            sims = [RacecarSimulator(track, backend=backend, device="cuda",
                                     with_noise=False, graph=g)
                    for g in (True, False)]
            for sim in sims:
                sim.set_pose(x, y, 0.0)
                sim.drive(1.0, 0.0)
            same, ahead = [], []
            for edit in (None, "add", "clear"):
                for sim in sims:
                    if edit == "add":
                        sim.add_obstacle(x + 0.275 + 1.0, y, size=0.4)
                    elif edit == "clear":
                        sim.clear_obstacles()
                a, b = (sim.update_pose() for sim in sims)
                same.append(same_out(a, b))
                ahead.append(float(a.ranges[BEAMS // 2]))
            caps = sims[0]._step.graphed.captures
            log(f"[{name} {backend}] graphed facade against the eager one "
                f"across add_obstacle and clear_obstacles: steps "
                f"bit-identical = {same}; beam ahead {ahead}; captures "
                f"{caps}")
            check(all(same) and caps == 3 and ahead[1] < 0.9 < ahead[0]
                  and ahead[2] > 0.9,
                  f"{name} {backend}: a map swap under the graph")
            sims[0]._step.graphed.release()
    return out, launches


def run():
    import numpy as np
    import torch
    from pyracecarsimulator_tpu_torch import RacecarSimulator, build_sim
    from pyracecarsimulator_tpu_torch._native import loader as native
    from pyracecarsimulator_tpu_torch.maps import (build_sector_map,
                                                   load_builtin,
                                                   sample_free_poses)
    from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
    from pyracecarsimulator_tpu_torch.ops import _kernels
    from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
    from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg

    from pyracecarsimulator_tpu_torch.utils.profiling import device_label
    card = device_label("cuda")
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 2. build, one nvcc per source, together
    t0 = time.perf_counter()
    _kernels.build("sector_sweep", "dense_sweep", "edf_march",
                   "general_sweep", "soft_edt")
    log(f"built the five sources in {time.perf_counter() - t0:.2f} s wall; "
        f"nvcc: {' '.join(_kernels.NVCC_FLAGS)}")
    for name, info in _kernels.build_info.items():
        log(f"{name}: {info['seconds']:.2f} s\n{info['log']}")
    sass = sass_report()
    rates = card_rates()

    # 20. the native host tier, before any map is loaded
    native_out = native_phase(card)
    # the unrolled main loop is the cheapest per test
    rates["sass_per_test"] = {k: min(lp["per_test"] for lp in v)
                              for k, v in sass.items()
                              if k not in ("edf_march", "general_sweep")}
    rates["march_sass"] = sass.get("edf_march", {})
    rates["general_sass"] = sass.get("general_sweep", {})
    rates["march_resources"] = march_resources()
    rates["list_resources"] = list_resources()
    rates["dense_resources"] = dense_resources()
    log(f"bounds: {OPS_PER_TEST} instruction slots per test over "
        f"{rates['sms']} SMs x {LANES_PER_SM} lanes x "
        f"{rates['sm_clock_max_mhz']:.0f} MHz (clocks.max.sm) = {rates['slots_per_s']:.4e} slots/s; HBM "
        f"{HBM_BYTES_PER_S:.3e} B/s")

    errs = {name: [] for name in KERNELS}
    times = {name: {} for name in KERNELS}
    tracks, smaps, segmaps, poses_by_map = {}, {}, {}, {}
    sector_scan = lambda m, p, ct, st: rs._scan_chunk(
        m, p, ct, st, BEAMS, MAX_RANGE, rs.sector_block_width(m, BEAMS, FOV))
    segment_scan = lambda m, p, ct, st: rseg._scan_rays(
        m, p, ct, st, BEAMS, MAX_RANGE)
    for name in MAPS:
        t0 = time.perf_counter()
        track = load_builtin(name, device="cuda")
        t1 = time.perf_counter()
        occ = track.occupancy.cpu().numpy()
        args = (occ, track.resolution, (track.origin_x, track.origin_y))
        kw = dict(max_range=MAX_RANGE, real_hw=(track.height, track.width),
                  device="cuda")
        smap = build_sector_map(*args, **kw)
        t2 = time.perf_counter()
        segmap = build_segment_map(*args, tile_size=4.0, **kw)
        t3 = time.perf_counter()
        log(f"[{name}] map load {t1 - t0:.2f} s; host sector build "
            f"{t2 - t1:.2f} s: table {tuple(smap.table.shape)}, kv_sec "
            f"{smap.kv_sec}; host segment build {t3 - t2:.2f} s: params "
            f"{tuple(segmap.params.shape)}, kv {segmap.kv}, sweep_meta "
            f"{segmap.sweep_meta.tolist()}, tiles "
            f"{None if segmap.tiles is None else tuple(segmap.tiles.shape)}"
            f", kv_tile {segmap.kv_tile}; {segmap.n_segments} segments")
        poses = sample_free_poses(track, AGENTS, np.random.RandomState(0))
        tracks[name], smaps[name], segmaps[name] = track, smap, segmap
        poses_by_map[name] = poses
        p = torch.as_tensor(poses, device="cuda")

        # 3. the sector backend
        fan, args = sector_case(smap, p)
        errs["list_sweep"].append(
            kernel_vs_plain(f"{name} sectors", "list_sweep", args))
        m = smap.meta[args[2].long()]
        log(f"[{name}] sector rows {args[2].numel()}, mean real slots per "
            f"visited list {float((m[:, 0] + m[:, 2] - m[:, 1]).float().mean()):.1f}")
        scan_checks(f"{name} sectors", track, sector_scan, smap,
                    smap.to("cpu"), poses, fan)

        # 4. the segments backend
        kname = "list_sweep" if segmap.tiles is not None else "dense_sweep"
        check(kname == {"levine": "dense_sweep",
                        "berlin": "list_sweep"}[name],
              f"{name}: the default map layout changed")
        fan, args = segment_case(segmap, p)
        errs[kname].append(kernel_vs_plain(f"{name} segments", kname, args))
        if kname == "list_sweep":
            m = segmap.tile_sweep_meta[args[2].long()]
            log(f"[{name}] tile rows {args[2].numel()}, mean real slots "
                f"per visited tile list "
                f"{float((m[:, 0] + m[:, 2] - m[:, 1]).float().mean()):.1f}")
        scan_checks(f"{name} segments", track, segment_scan, segmap,
                    segmap.to("cpu"), poses, fan)
        times[kname][name if kname == "dense_sweep" else f"{name} tiles"] = (
            time_kernel(kname, [segment_case(segmap, q)[1]
                                for q in pose_sets(poses)], rates))
        times["list_sweep"][f"{name} sectors"] = time_kernel(
            "list_sweep",
            [sector_case(smap, q)[1] for q in pose_sets(poses)], rates)

        # 25. the list kernel's entry from poses
        list_scan_phase(card, name, smap, segmap, poses, rates, errs, times)

    # 4b. the dense kernel over berlin's untiled set: several smem chunks
    flat = build_segment_map(
        tracks["berlin"].occupancy.cpu().numpy(), tracks["berlin"].resolution,
        (tracks["berlin"].origin_x, tracks["berlin"].origin_y),
        max_range=MAX_RANGE, tile_size=0.0, device="cuda",
        real_hw=(tracks["berlin"].height, tracks["berlin"].width))
    check(flat.tiles is None, "berlin untiled build kept tiles")
    few = [q[:256] for q in pose_sets(poses_by_map["berlin"])]
    errs["dense_sweep"].append(kernel_vs_plain(
        "berlin untiled, 256 agents", "dense_sweep",
        segment_case(flat, few[0])[1]))
    times["dense_sweep"]["berlin_untiled_256"] = time_kernel(
        "dense_sweep", [segment_case(flat, q)[1] for q in few], rates)
    full = [segment_case(flat, q)[1]
            for q in pose_sets(poses_by_map["berlin"], 2)]
    times["dense_sweep"]["berlin_untiled_4096_kernel_only_ms"] = timed_ms(
        lambda i: wrappers()["dense_sweep"](*full[i % 2]), 5, warmup=1)

    # 5. the sector scans of kernels 2.2 and 2.3, counted
    big = MAPS[-1]
    p = torch.as_tensor(poses_by_map[big], device="cuda")
    ref = rs.scan_poses_sectors(smaps[big], p, num_beams=BEAMS, fov=FOV,
                                max_range=MAX_RANGE)
    route_counts = {}
    for label, kw in (("mode sorted_pl", dict(mode="sorted_pl")),
                      ("use_pallas", dict(use_pallas=True))):
        reset_counts()
        got = rs.scan_poses_sectors(smaps[big], p, num_beams=BEAMS, fov=FOV,
                                    max_range=MAX_RANGE, **kw)
        torch.cuda.synchronize()
        route_counts[label] = {k: v for k, v in counts().items() if v}
        same = bool(torch.equal(got, ref))
        log(f"[{big}] sector scan with {kw}: launches "
            f"{route_counts[label]}, equal to the default sector scan = "
            f"{same}")
        check(same and route_counts[label] == {"list_scan": 1},
              f"sector scan, {label}: not one list_scan launch, or the "
              "scan changed")

    # 6. the main path: the default backend, then the sector backend
    # no device named: the entry points put everything on the card
    seg_bundles = {name: build_sim(name) for name in MAPS}
    check(all(b.backend == "segments" and b.track.edf.is_cuda
              and b.segmap.params.is_cuda for b in seg_bundles.values()),
          "build_sim's default is not the 'segments' backend on the card")
    main_counts = drive(seg_bundles, "segments", poses_by_map)
    n_main = STEPS + 1 + WARMUP_STEPS
    check(main_counts["levine"] == {"dense_sweep": n_main}
          and main_counts["berlin"] == {"list_scan": n_main},
          f"the default path launched {main_counts}")
    from pyracecarsimulator_tpu_torch import make_step_fn, state_from_pose
    for name in MAPS:
        p = torch.as_tensor(poses_by_map[name], device="cuda")
        s0 = state_from_pose(p[:, 0], p[:, 1], p[:, 2])
        act = (torch.full((AGENTS,), 2.0, device="cuda"),
               torch.zeros(AGENTS, device="cuda"))
        pal = build_sim(name, backend="segments_pallas", device="cuda")
        a = make_step_fn(seg_bundles[name], with_noise=False)(s0, act)
        b = make_step_fn(pal, with_noise=False)(s0, act)
        same = all(bool(torch.equal(u, v)) for u, v in (
            (a.ranges, b.ranges), (a.state.pose, b.state.pose),
            (a.collision, b.collision)))
        log(f"[{name}] segments_pallas step equals segments step: {same}")
        check(same, f"{name}: segments_pallas differs from segments")
    sec_bundles = {name: build_sim(name, backend="sectors", device="cuda")
                   for name in MAPS}
    sec_counts = drive(sec_bundles, "sectors", poses_by_map)
    check(all(c == {"list_scan": n_main} for c in sec_counts.values()),
          f"the sector path launched {sec_counts}")

    # 7. BPTT on berlin, both backends
    train = {}
    for label, bundle in (("segments", seg_bundles[big]),
                          ("sectors", sec_bundles[big])):
        torch.cuda.reset_peak_memory_stats()
        losses, ms, used = train_phase(bundle, poses_by_map[big], label)
        # the default train step is one CUDA graph: 2 warm-up steps of its
        # capture, then 3 replays; a call's first scan, whose pose no
        # parameter reaches, takes the entry from poses
        check(used == {"list_sweep": (2 + 3) * (TRAIN_T - 1),
                       "list_scan": 2 + 3},
              f"{label} training launched {used}")
        train[label] = {"losses": losses, "train_step_ms": ms,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": used}
        log(f"[{big}] {card}: {label} train step (T={TRAIN_T}, fwd + bwd, "
            f"Adam) {ms:.4f} ms, peak device memory "
            f"{train[label]['peak_gb']:.2f} GB")

    # 8. scan and step times
    rays = AGENTS * BEAMS
    for name in MAPS:
        sets = pose_sets(poses_by_map[name])
        for label, scan, m in (
                ("segments", rseg.scan_poses_segments, segmaps[name]),
                ("sectors", rs.scan_poses_sectors, smaps[name])):
            ms = timed_ms(lambda i: scan(m, sets[i % 5], num_beams=BEAMS,
                                         fov=FOV, max_range=MAX_RANGE), 20)
            times.setdefault("scans", {})[f"{name} {label}"] = ms
            log(f"[{name}] {card}: full {label} scan {ms:.4f} ms "
                f"({rays / (ms * 1e-3):.4e} rays/s)")
        for label, bundles in (("segments", seg_bundles),
                               ("sectors", sec_bundles)):
            ms = step_ms(bundles[name], poses_by_map[name])
            times.setdefault("steps", {})[f"{name} {label}"] = ms
            log(f"[{name}] {card}: closed-loop {label} step {ms:.4f} ms = "
                f"{AGENTS / (ms * 1e-3):.4e} env-steps/s")
    for name, t in times.items():
        if name in KERNELS:
            for shape, v in t.items():
                log(f"{card}: {name} {shape}: {v}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB")

    # 9. the facade, default backend
    sim = RacecarSimulator(MAPS[0], seed=0)
    check(sim.device.type == "cuda" and sim.state.x.is_cuda,
          "the facade's default device is not the card")
    sim.set_pose(*map(float, poses_by_map[MAPS[0]][0]))
    sim.drive(1.0, 0.05)
    for _ in range(3):
        out = sim.update_pose()
    check(sim.backend == "segments" and tuple(out.ranges.shape) == (BEAMS,)
          and tuple(out.state.x.shape) == ()
          and bool(torch.isfinite(out.ranges).all())
          and tuple(sim.run_scan().shape) == (BEAMS,), "facade outputs")
    log(f"facade ({sim.backend}): 3 update_pose calls on {MAPS[0]}, x "
        f"{float(sim.get_state().x):.4f}, collision "
        f"{bool(sim.check_collision())}")

    # 10-15. the EDF marches, map gradients, soft_edt, simplified
    # geometry and the obstacle cycle
    slice_out = {"edf": {}, "soft_edt": {}, "segments_simplified": {},
                 "obstacles": {}}
    for name in MAPS:
        slice_out["edf"][name] = march_phases(
            card, name, tracks[name], poses_by_map[name], rates, errs, times)
    slice_out["map_grad"] = mapgrad_phase(card, sec_bundles[big],
                                          poses_by_map[big])
    slice_out["occupancy_scan"] = occupancy_scan_phase(
        card, tracks[MAPS[0]], poses_by_map[MAPS[0]])
    for name in MAPS:
        slice_out["soft_edt"][name] = soft_edt_phase(
            card, name, tracks[name], rates, errs, times)
        slice_out["segments_simplified"][name] = simplified_phase(
            card, name, tracks[name], poses_by_map[name], rates, errs, times)
        slice_out["obstacles"][name] = obstacle_phase(
            card, name, tracks[name], poses_by_map[name])
    log(f"after phases 10-15: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # 16-19. multitrack, the 1 x 1 mesh, four ranks on the card, tooling
    slice_out["multitrack"], stack, stack_poses, mid = multitrack_phase(
        card, sec_bundles, poses_by_map, rates, errs)
    slice_out["mesh_1x1"] = mesh_phase(card, sec_bundles[big], stack,
                                       stack_poses, mid, poses_by_map[big],
                                       errs)
    del stack
    torch.cuda.empty_cache()
    slice_out["four_ranks"] = ranks_phase(card, sec_bundles[big], flat,
                                          tracks[big], poses_by_map[big],
                                          errs)
    slice_out["tooling"] = tooling_phase(card, sec_bundles[big],
                                         poses_by_map[big])
    log(f"the four ranks of phase 18 launched "
        f"{slice_out['four_ranks']['launches']}")
    slice_out["native"] = native_out
    check(sum(native.call_counts().values()) > 0,
          "phases 3-19 built their maps without the native bodies")
    log(f"native host calls of phases 3-19: {native.call_counts()}")

    # 21. the demos
    slice_out["examples"] = examples_phase(card)

    # 22-23. the parity report and the bench
    slice_out["parity_report"] = parity_phase(card, poses_by_map[big])
    slice_out["bench_torch"] = bench_phase(card)

    # 24. the compiled step: CUDA graphs against the eager paths
    slice_out["graphs"], graph_counts = graph_phase(
        card, seg_bundles, sec_bundles, poses_by_map, tracks)

    # launches of this process, path by path: each path was driven with the
    # counts set to 0 just before it and read just after
    by_path = {
        **{f"default step + rollout, {m}": c for m, c in main_counts.items()},
        **{f"sector step + rollout, {m}": c for m, c in sec_counts.items()},
        **{f"sector scan, {k}": c for k, c in route_counts.items()},
        **{f"BPTT train steps, {k}": v["launches"] for k, v in train.items()},
        "map_grad scans": slice_out["map_grad"]["launches"],
        "scan_from_occupancy forward + backward, levine":
            slice_out["occupancy_scan"]["launches"],
        **{f"edf step + rollout, {m}": res["edf_launches"]
           for m, res in slice_out["edf"].items()},
        **{f"{label} forward + backward, {m}":
           res[f"{label}_fwd_bwd_launches"]
           for m, res in slice_out["edf"].items()
           for label in ("edf_implicit", "edf_bilinear")},
        **{f"segments_simplified {k}, {m}": res[key]
           for m, res in slice_out["segments_simplified"].items()
           for k, key in (("scan", "scan_launches"),
                          ("step + rollout", "launches"))},
        **{f"obstacle cycle, {m} {backend}": res["launches"]
           for m, per_map in slice_out["obstacles"].items()
           for backend, res in per_map.items()},
        "multitrack scans": slice_out["multitrack"]["launches"],
        **{f"1 x 1 mesh, {k}": v
           for k, v in slice_out["mesh_1x1"]["launches"].items()},
        **{f"example {k}": v["launches"]
           for k, v in slice_out["examples"].items()},
        "parity report": slice_out["parity_report"]["launches"],
        "bench_torch": slice_out["bench_torch"]["launches"],
        **{f"graphed step, rollout and train step, {cell}": c
           for cell, c in graph_counts.items()}}
    launches_by_path = {name: {path: c[name] for path, c in by_path.items()
                               if c.get(name)} for name in KERNELS}
    log(f"launches by path: {launches_by_path}")
    check(all(launches_by_path.values()),
          f"a kernel was never launched: {launches_by_path}")
    shape_of = {"dense_sweep": "levine", "list_sweep": "berlin sectors",
                "list_scan": "berlin sectors",
                "edf_march": "levine nearest",
                "edf_march_grad": "levine bilinear",
                "implicit_pose_vjp": "levine",
                "general_sweep": "berlin min", "soft_edt": "levine hard",
                "soft_edt_grad": "levine hard"}
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "path": path, "launches": sum(launches_by_path[name].values()),
        "launches_by_path": launches_by_path[name],
        "max_abs_err": max(errs[name]),
        "ms": times[name][shape_of[name]]["ms"],
        "plain_ms": times[name][shape_of[name]]["plain_ms"],
        "bound_ms": times[name][shape_of[name]]["bound_ms"],
        "bound_by": times[name][shape_of[name]]["bound_by"],
        # no PyTorch call computes the first-hit sweeps, the march, the
        # chamfer iteration (its per-direction steps) or their gradients
        "library_ms": None,
        "shape_of_ms": f"{shape_of[name]} {AGENTS}x{BEAMS}"
        if name not in ("soft_edt", "soft_edt_grad")
        else f"{shape_of[name]} {STENCIL_MODES['hard']['iters']} iters",
        "ms_by_shape": times[name]}
        for name, (src, rep, path) in KERNELS.items()],
        "scans_ms": times["scans"], "steps_ms": times["steps"],
        "train": train,
        "slice": slice_out, "card": card, "rates": rates,
        "ops_per_test": OPS_PER_TEST, "sass_loops": sass}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pyracecarsimulator_tpu_torch")):
        print("chip_smoke.py: the pyracecarsimulator_tpu_torch package is "
              "not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = run()
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
