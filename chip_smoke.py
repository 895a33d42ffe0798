#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

Usage, from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit: `python3 chip_smoke.py`. It imports no JAX.

Phases, one output line or more each; any failure raises, so the script
exits non-zero and prints no final line:
 1. the device, and `nvidia-smi` name and power limit;
 2. nvcc builds csrc/ (kernels.build: one nvcc per .cu, all at once),
    timed, with ptxas register counts per kernel;
 3. kernel K2 (advance_kernel) at each group size G (1, 2, 4, 8 threads a
    lane) against its plain form on 2^16 random lanes of the Cornell box
    (with and without merged quads) and of the sphere-light scene
    (testing.assert_advance_agrees), and the 5% inactive lanes of each
    returned exactly as they went in, alive false; both timed at 2^18
    lanes, the kernel by device time (device_ms) beside its CUDA-event
    figure, the host's issue rate; K2 at cbox-64's shape (the per-bounce
    driver's launches of 4,096 lanes on the Cornell box at 64x64 x 16
    spp, the largest film render() sends to the driver, each kept and
    replayed): device time a launch, the G it takes there, the bound of
    the lanes each launch advances, and its launches with the full pool,
    the first below half, a tenth and a hundredth of the lanes active
    held against the plain form as above;
 4. kernel K1 (render_fused_kernel, with film_sum_kernel summing its
    per-item buffer) against its plain form on the Cornell
    box at 512x512 and the sphere-light scene at 256x256, and the
    per-bounce driver with K2 against it with the plain advance on the
    Cornell box at 64x64, 4 spp each: median per-pixel relative
    difference < 1e-4 and film means within 1%; K1 and its plain form
    timed on the Cornell box, K1's SIMT counters at 4 spp counting the
    plain form's vertices (within 1e-3); K1 at the main path's launch,
    512x512 x 256 spp: timed, with its SIMT counters (the share of warp
    lanes that advance a vertex in the loop's iterations, beside the
    plain form's lockstep proxies), the bound of the vertices they count,
    and two launches bit-equal; K1 on the mesh Cornell box with a
    displaced sphere of TALL_TRIANGLES triangles (the largest copy of the
    scans' rows in a block's shared memory that the mesh variant gives
    K1) at 128x128 x 4 spp against its plain form (median < 1e-4, means
    within 1%); then K1 against the per-bounce driver
    with K2 on the ragged film RAGGED_FILM (1920x1080: 506 whole
    4096-pixel blocks and a partial one of 1,024 pixels, which render()
    sends to K1) at 1 and 4 spp: median per-pixel relative difference
    <= 1e-6 and at most 0.5% of pixels off by more than 1e-3
    relatively, over the film and in its partial block, max |diff|; each
    route's device busy time in a traced render() and render()'s wall,
    warm, in turns (render() with its engines patched to the route);
    render() of the film launches K1 once and K2 never; then the same on
    the Cornell box at 64x64 (one whole block, the largest film render()
    sends to the driver, which it launches K2 for and K1 never) at 1 and
    16 spp, so the walls say which route is the faster at that size;
 5. the white box with K1 at 128x128 x 64 spp: mean within 3% of the
    analytic Le / (1 - rho) = 3.0;
 6. the main path through the CLI, with the launch counters reset before
    and read after: the Cornell box XML at 512x512 x 256 spp (K1) and at
    64x64 x 16 spp (one 4096-pixel block: the per-bounce driver and
    K2), the glass Cornell box XML at
    512x512 x 16 spp (the general engine and K3), and the volumetric
    Cornell box XML ('vol') at 512x512 x 256 spp (volpath, K8); the EXRs
    must be finite with mean luminance in (0.05, 5), (0.005, 0.5) for the
    foggy 'vol'), and the heterogeneous Cornell box XML ('hetvol', a
    128x128x50 density grid) at 768x576 x 32 spp (volpath, K9), mean
    luminance in (0.02, 2). Prints Mpaths/s of each large render for the
    whole CLI run and for render() alone;
 7. kernel K3 (intersect_brute_kernel, occluded_brute_kernel) against its
    plain forms on the 2^18 camera, bounce and shadow rays of the glass
    Cornell box and the sphere-light scene at 512x512
    (testing.general_rays): prim ids and hit bits agree on >= 99.9% of
    rays, t/u/v within rtol 1e-5 where both hit the same prim, and the rays
    on which K3 and the plain forms differ at all counted and printed; at
    glass-512's shape (the glass box's 2^18 bounce and shadow rays: the
    engine's pool is one lane a pixel) both variants timed by device time
    beside their CUDA-event figures, the host's issue rate, and their
    plain forms by CUDA events;
 8. the general engine with K3 against it with the plain casts (the K3
    wrappers patched to their plain forms for that run): the glass
    Cornell box at 128x128 x 4 spp, median per-pixel relative difference
    < 1e-4, film means within 1%;
 9. the furnace through render() at 64x64 x 64 spp: the sphere's mean
    within 3% of albedo x env radiance;
10. kernel K8 (render_fused_vol_kernel) against its plain form: 'vol' at
    512x512 x 4 spp (median per-pixel relative difference < 1e-4, film
    means within 1%), 'vol_hg' and the submerged sphere-light scene at
    256x256 x 32 spp (the same, and the RMS difference of 8x8-pixel block
    means over the film mean < 0.12), and 'vol' at the main path's last
    launch, 512x512 x 64 spp from sample 192 (median < 1e-4, means within
    1%); two launches give bit-equal films;
    K8 and its plain form timed on 'vol' at 4 spp by CUDA events, K8 also
    at the main path's 64 spp a launch, with its SIMT counters (the share
    of warp lanes that hold a path in the loop's iterations, beside the
    plain form's lockstep proxy) and the bound of the vertices they
    count; film_sum_kernel (the ordered film sum of K1, K8 and K9)
    bit-equal to its plain form on buffers with non-finite samples at
    K8's, K9's and K1's main-path shapes and at a padded stride, timed at
    512x512 x 64 spp;
11. the general volumetric engine (volpath._render_volpath_block) on the
    card at 128x128 x 4 spp: on 'vol' against K8, and on 'vol_glass' with
    K3 against it with the plain casts (it must launch K3 and not K8):
    median < 1e-4, means within 1%; loop iterations and wall time;
12. kernel K9 (render_fused_grid_kernel) against its plain form on
    'hetvol' and 'hetvol_hg' (128x128x50 grids) at 128x128 x 2 spp and
    on 'hetvol' at the main path's film, 768x576 x 1 spp and x 4 spp
    from sample 28 (the last items of the main path's launch): median
    per-pixel relative difference < 1e-4, film means within 1%; two
    launches give bit-equal films; K9 timed by CUDA events at 768x576 x
    1 and 4 spp, its plain form at 768x576 x 1 spp (the plain form's
    counters give the work the bound counts), and K9 at the main path's
    32 spp, with its SIMT counters by stage (casts, tracking steps,
    vertices; beside the plain form's lockstep proxy of the tracking
    steps) and the bound of the work they count;
13. the general event machine (volpath._render_volpath_block) on the card
    against K9 on 'hetvol' at 64x64 x 2 spp (4096 pixels, two whole
    2048-lane blocks, so K9 draws the engine's numbers): median < 1e-4,
    means within 1%; and on 'hetvol_smooth' (outside K9's class) with K3
    against it with the plain casts (it must launch K3 and not K9):
    median < 1e-4, means within 1%; loop iterations and wall time;
14. kernels K4-K7 (the cluster sweeps of scenes with a BVH) against their
    plain forms on the mesh Cornell box (a displaced sphere of ~56k
    triangles), on the 2^16 camera, bounce and shadow rays of its
    256x256 film: K5 and K4 on K5's hits, K6 (full-width lists) and K7
    (the tables repacked at 64 triangles a cluster), closest and any hit;
    K5 on a ~3.5k-triangle sphere with lists of one entry per
    supercluster, so that blocks overflow into supercluster mode; and the
    tie fixture (testing.sweep_tie_fixture: identical triangles a warp
    round of 32 apart in one cluster and in a second, listed first)
    through K5 in both list modes, K4 on its hits and K6, closest and any
    hit, and at 64 triangles a cluster (copies in lanes 7, 2 and 7 of a
    round) through K7, every output bit-equal to the plain forms; and K4 on
    the
    resolve's own tie fixture (testing.resolve_tie_fixture: two
    triangles of one cluster in different lanes at equal err), bit-equal
    to its plain form and naming the rule's prim. Gates:
    t bit-equal on >= 99.9% of rays and within rtol 3e-4 / atol 3e-5 on
    all, prim equal on >= 99.9%, u and v within 1e-4 where prim agrees,
    occlusion equal on all, prim >= 0 exactly where t is finite. A second witness on 2^14
    rays of each kind and each route (K5 + K4; K6, forced by
    RESIDENT_BYTES = 0; K7): the independent intersect_binned, at the same
    tolerances. Then each kernel timed by CUDA events at 2^18 rays
    (bounce rays for closest hit, shadow rays for any hit), each plain
    form once (its counters give the work the bound counts), and a whole
    cast (sort, lists, kernel) beside its kernel; K7 by device time, the
    median of 5 traces, beside its CUDA events (long enough there to time
    the card): they must agree within 20%;
15. the large-scene main path through the CLI, launch counters reset
    before each run and read after: `bigmesh-683` (the mesh Cornell box
    at ~56k triangles, 683x512 x 2 spp: K5 + K4) and `hugemesh-768`
    (~260k triangles, 768x575 x 1 spp: K6); finite EXRs, mean luminance
    in (0.05, 5); parse + compile, BVH, cluster, packing, upload and
    render() seconds, loop iterations, Mpaths/s; K5 (bigmesh-683) or K6
    (hugemesh-768) at render shape: on the rays of the closest-hit and
    the shadow cast of the warm render's sixth loop iteration (8192 or
    16384 rays), timed, with its plain form's time and the bound of the
    work the plain form counted; in bigmesh-683 also K4 on K5's hits of
    that closest-hit cast, bit-equal to its plain form, timed the same
    way. Each film at 128x96 x 2
    spp against the same render with the casts patched to
    intersect_binned: median < 1e-4, means within 1%. K7 on a path of
    its own: render() of the mesh Cornell box (~3.5k triangles, 128x96 x
    1 spp, `mesh-64`) with its tables repacked at 64 triangles a cluster,
    against the unrepacked scene's film; every K7 launch of that render
    kept: the rays a cast, every output bit-equal to the plain form on
    every cast, K7's device time a launch over the render's casts (closest
    and any hit), the plain form's time and the bound of the work it
    counted. The seam rays (testing.SEAM_PIXELS: the 8 pixel-centre rays
    of the 64x64 mesh box at 2,000 triangles that run along a wall seam
    and that lajolla_tpu's sweep misses): the depth film through K5 + K4
    alone against the plain sweep on the CPU, the seam rays each hits
    (they must agree) and the pixels whose hit differs.
16. the aux integrators (depth, shadingNormal, meanCurvature,
    rayDifferential, mipmapLevel) through the CLI, launch counters reset
    before each run and read after: the Cornell box XML at 512x512
    (`aux-512`, K3 alone) and the mesh Cornell box at 683x512
    (bigmesh-683's ~56k triangles, depth and shadingNormal: K5 + K4
    alone); finite EXRs of the film's shape; the CLI's and render()'s
    seconds; each film's scene against the port's own film on the CPU
    (plain casts) at 129x128 (AUX_CHECK_FILM): >= 99.9% of the values
    within 2e-3 of the film's largest magnitude (2e-2 for meanCurvature);
17. `disney-512`: the Disney Cornell box XML (six Disney BSDFs,
    testing.CBOX_DISNEY_SHAPES) at 512x512 x 8 spp through the CLI, the
    general engine with K3 alone (launch counters reset before and read
    after): a finite EXR with mean luminance in
    testing.CBOX_DISNEY_LUMINANCE; Mpaths/s of the CLI run and of render()
    alone, loop iterations; one traced render() of the film at 1 spp:
    loop iterations, wall, device busy time,
    idle share, device activities an iteration, K3's device time and its
    share; the general engine with K3 against it with the plain casts at
    128x128 x 4 spp (median per-pixel relative difference < 1e-4, means
    within 1%); the card's film against the CPU's at 64x64 x 4 spp (means
    within 1%, 8x8-block RMS over the film mean < 0.12: last bits across
    devices decorrelate some paths).
18. volpath versions 1 and 2: the threefry (core/random.py) fold_in,
    split and uniform on 2^20 keys on the card, bit-equal to the CPU's;
    `vol1-512` and `vol2-512`, the 'vol' Cornell box XML with <integer
    name="version"> 1 and 2 at 512x512 x 16 spp through the CLI (launch
    counters reset before each run and read after: K3 alone, closest hit
    for version 1, closest and any hit for version 2): finite EXRs with
    mean luminance in (0.005, 0.5) / (0.001, 0.5); Mpaths/s of the CLI
    run and of render() alone, K3's launches; one traced render() of
    vol2-512 (wall, device busy, idle share, device activities a sample);
    the card's film against the CPU's at 64x64 x 4 spp for both versions:
    median < 1e-4, means within 1%;
19. the gradients (integrators/diffpath.py): `diff-256`, render_diff of
    the Cornell box at 256x256 x 4 spp, depth 4, forward and backward()
    of the film mean with respect to a scale on the red wall's albedo
    (launch counters reset before and read after: K3 alone), the second
    of two runs: forward and backward seconds, max_memory_allocated; the
    card's albedo gradient at 32x32 x 2 spp against the CPU's (rel 1e-3),
    central differences on the card (rel 5e-3) and grad_fwd on the card
    (rel 1e-4); render_volpath_diff's sigma gradients, version 1 at 32x32
    x 4 spp and version 2 at x 16 spp on the 'vol' box, against the
    CPU's (rel 1e-3); the example's albedo recovery
    (examples/inverse_rendering.recover_albedo, 40 Adam steps at 24x24 x
    4 spp): the loss below 1e-2 of its start, kd within 0.02 of the truth.
20. the sharded renders (parallel/mesh.py render_sharded and
    render_diff_sharded, through parallel.spawn and testing.sharded_cases)
    on one rank over NCCL and on two ranks sharing the card over gloo:
    cbox-512 x 256 spp (K1), vol-512 x 256 spp (K8), hetvol-768 x 32 spp
    (K9), glass-512 x 16 spp (the general engine, K3), aux-512's depth
    film (K3) and diff-256's film mean and its gradient with respect to a
    scale on the texture table; every rank against the one-process render
    on the card (median per-pixel relative difference < 1e-4, film means
    within 1%; aux at [16]'s gate; gradient rel 1e-3 and grad_fwd against
    reverse mode rel 1e-4), each rank launching the kernels the
    one-process render launches (counters reset before each cell's first
    run and read after it); the wall time of each sharded render and of
    one collective of its film's size beside the one-process render's.
Then one JSON line of per-kernel results (each kernel's launches on the
main path of [6] or, for K4-K7, of [15], its largest difference from its plain form, its time,
its plain form's time, its bound and what bounds it, and the time of a
library call that computes the same function: none has one; K5, K6 and K7
also carry their any-hit variant's numbers as `any_hit_*`, K4-K7
their render-shape numbers as `render_*` (K5-K7 also
`render_any_hit_*`; K7 its CUDA-event times at 2^18 as
`cuda_event_ms` and `any_hit_cuda_event_ms`), K1, K8 and K9 their main-path numbers as `render_*`
with `render_spp` and `simt_efficiency`, K2 and K3 their render-shape
device times as `render_*` (K2 cbox-64's) and
their CUDA-event figures as `host_issue_ms`), and last the device line.
K3, K4 and K5 also carry their launches in [16] as `aux_launches`, K3 in
[17] as `disney_512_launches`, in [18] as `vol12_512_launches` and in [19]
as `diff_256_launches`; every kernel carries its launches in [20]'s
two-rank run, summed over the cells, as `sharded_launches` (rank 0's,
rank 1's).
`python3 chip_smoke.py --sweep-only` runs [1], [2], [14] and [15] and
prints neither of the two last lines (a shorter run while working on the
sweeps); `python3 chip_smoke.py --ragged-only` runs [1], [2] and [4]'s
check of K1 against the driver on the ragged film and at 64x64 alone
(~2 min) and prints neither either.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

KERNEL_SOURCE = 'lajolla_tpu_torch/csrc/path_kernels.cu'
K3_SOURCE = 'lajolla_tpu_torch/csrc/intersect_kernels.cu'
K3_REPLACES = 'lajolla_tpu/ops/intersect_pallas.py:29'
K8_SOURCE = 'lajolla_tpu_torch/csrc/volpath_kernels.cu'
K8_REPLACES = 'lajolla_tpu/integrators/volpath_kernel.py:552'
K9_SOURCE = 'lajolla_tpu_torch/csrc/volpath_grid_kernels.cu'
K9_REPLACES = 'lajolla_tpu/integrators/volpath_grid_kernel.py:910'
# film_sum_kernel replaces the film add inside K8's and K9's Pallas kernels
FILM_SUM_REPLACES = 'lajolla_tpu/integrators/volpath_kernel.py:612'
# The plain forms' 32-lane lockstep proxies of the per-thread designs that
# K8 and K9 replaced (PERF.md section 5): lane vertices of K8, tracking
# steps of K9, as per-lane totals.
K8_LOCKSTEP_PROXY = 0.539
K9_LOCKSTEP_PROXY = 0.174
# K1's (tools/profile_torch_path.py --proxies: the Cornell box at 64x64 x
# 256 spp, warps of 32 consecutive pixels): the nested sample and vertex
# loops it replaced (per sample), and one flat loop a pixel (per-lane
# totals), the design its persistent warps beat.
K1_NESTED_PROXY = 0.481
K1_FLAT_PROXY = 0.815
SWEEP_SOURCE = 'lajolla_tpu_torch/csrc/sweep_kernels.cu'
SWEEP_REPLACES = dict(
    sweep_resolve='lajolla_tpu/ops/intersect_sweep.py:368',
    sweep_resident='lajolla_tpu/ops/intersect_sweep.py:220',
    sweep_list='lajolla_tpu/ops/intersect_sweep.py:547',
    sweep_streaming='lajolla_tpu/ops/intersect_sweep.py:713')
# Triangle counts asked of the mesh Cornell box: its sweep table stays
# under ops/intersect_sweep.RESIDENT_BYTES (K5 + K4) or exceeds it (K6).
BIGMESH_TRIANGLES = 56000
HUGEMESH_TRIANGLES = 260000
# [4]'s tall table: the mesh Cornell box with a displaced sphere of 168
# triangles (179 cast prims, a copy of 23,376 B in each block of K1), the
# most triangles of the mesh variant below BVH_MIN_TRIS.
TALL_TRIANGLES = 168
# The aux integrators ([16])
AUX_MODES = ('depth', 'shadingNormal', 'meanCurvature', 'rayDifferential',
             'mipmapLevel')
# The film on which [16] holds the card's aux films against the CPU's: on
# a square film pixel-centre rays run exactly along the Cornell box's
# diagonal seams, where the two walls' t differ in the last bit and
# either device may pick the other wall; one more column puts no pixel
# centre on a diagonal (tests/test_torch_aux.py).
AUX_CHECK_FILM = (129, 128)
# [4]'s ragged film: more than one of K1's 4096-pixel blocks and not a
# whole number of them (506 blocks and 1,024 pixels).
RAGGED_FILM = (1920, 1080)
# The cast of a render whose rays K5 and K6 are timed on at render shape:
# the closest-hit and the shadow cast of the sixth loop iteration, where
# the lane pool holds paths at their later bounces.
CAPTURE_CALL = 5

# Peak rates of one H100 SXM (NVIDIA's data sheet, at the full 700 W):
# fp32 outside the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one piece of work, counted by hand in the CUDA
# sources and rounded down: a closest-hit Woop test (intersect_range:
# the three Woop rows 33, t, u, v 5, the limits 4, the compares 3); an
# any-hit test (occluded: Woop rows 33, U, V and the limit 9, the four
# sign tests 13); a sphere test (sphere_t); the rest of a path vertex
# (shade 60, emission and MIS 25, the light sample 45, two BSDF
# evaluations and a sample 240, roulette and merge 50); K8's closed-form
# free flight and NEE transmittance; one K9 tracking step (ff_micro: the
# slab 27, the supervoxel cell and its exit 80, the 8-corner density
# read 53, the tracking update 30); a sweep's slab test against one
# cluster (per axis two differences, two products and four min/max, and
# the compare).
OPS = dict(closest_test=45, any_test=55, sphere_test=28, vertex=420,
           vol_flight=40, track_step=190, slab_test=25)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, reps, name):
    """Mean device milliseconds of the kernels whose name holds `name`
    over reps calls of fn(), from a torch.profiler trace: a launch shorter
    than the host's time to issue it is timed by the card, where CUDA
    events around back-to-back launches would time the host. The trace
    may miss launches (9 of 10 were seen on the H100, and once none): the
    mean is over those it holds, and a trace that holds none is taken
    again, five times at most. After that (three traces in a row once held
    none, late in a run) the calls are timed by queued_ms instead, and a
    line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = [(e.time_range.end - e.time_range.start) / 1e3
              for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if ms:
            return sum(ms) / len(ms)
    ms = queued_ms(torch, fn, reps)
    print(f"device_ms: five traces held no launch of {name}; timed by "
          f"queued_ms instead: {ms:.4f} ms a call")
    return ms


def queued_ms(torch, fn, reps):
    """Mean device milliseconds of one fn() (all its launches) over reps
    calls, by CUDA events around each call while a spin kernel holds the
    stream: the calls queue behind it and then run back to back, so each
    pair of events brackets the card's work, not the host's time to issue
    it."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)          # ~0.1 s: longer than the issue
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def kernel_name(symbol):
    """The unqualified name of an entry function from its (Itanium)
    mangled symbol: '_ZN12_GLOBAL__N_119render_fused_kernelILi1E...' ->
    'render_fused_kernel'. Unmangled symbols come back as they are."""
    if not symbol.startswith('_Z'):
        return symbol
    rest = symbol[2:]
    nested = rest.startswith('N')
    rest = rest[1:] if nested else rest
    name = None
    while rest[:1].isdigit():
        j = 0
        while rest[j].isdigit():
            j += 1
        size = int(rest[:j])
        name, rest = rest[j:j + size], rest[j + size:]
        if not nested:
            break
    return name or symbol


def ptxas_summary(log):
    """'kernel: max registers, max spill bytes' over the instantiations,
    keyed by each entry function's own name."""
    out, name = {}, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            name = kernel_name(line.split("'")[1])
        elif name and 'spill stores' in line:
            spill = int(line.split('bytes spill stores')[0].split(',')[-1])
            regs, sp = out.get(name, (0, 0))
            out[name] = (regs, max(sp, spill))
        elif name and 'Used' in line and 'registers' in line:
            r = int(line.split('Used')[1].split('registers')[0])
            regs, sp = out.get(name, (0, 0))
            out[name] = (max(regs, r), sp)
    return '; '.join(f"{k}: <= {r} registers, <= {s} B spill stores"
                     for k, (r, s) in sorted(out.items()))


def luminance(im):
    """Mean Rec. 709 luminance of an (h, w, 3) image."""
    import numpy as np
    return float((im @ np.array([0.212671, 0.715160, 0.072169])).mean())


def counted(PP, fn):
    """fn() with the general engine's loop iterations counted
    (integrators/path `PP._render_block_sc`)."""
    iters = []
    real = PP._render_block_sc

    def counting(*a, **k):
        out = real(*a, **k)
        iters.append(out[2])
        return out
    with mock.patch.object(PP, '_render_block_sc', counting):
        out = fn()
    return out, sum(iters)


def busy_seconds(intervals):
    """Length of the union of (start, end) intervals in microseconds, in
    seconds."""
    busy, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6


def film_agreement(got, want):
    """(median per-pixel relative difference, relative difference of the
    film means, largest absolute difference) of two (h, w, 3) images."""
    import numpy as np
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError("non-finite pixels")
    rel = np.abs(got - want) / (want + 1e-3)
    return (float(np.median(rel)), abs(got.mean() - want.mean()) /
            want.mean(), float(np.abs(got - want).max()))


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for ops
    fp32 operations and nbytes bytes moved."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def table_bytes(scene):
    """Bytes of the scene tables a fused kernel reads (each once)."""
    return sum(t.numel() * t.element_size() for t in (
        scene.fp_woop, scene.fp_woop_occ, scene.fp_tri, scene.cast_src,
        scene.cast_alt, scene.cast_quad, scene.cast_occ_quad, scene.fp_light,
        scene.tri_stair_cdf, scene.fp_sph))


def vertex_ops(scene, vertices):
    """fp32 operations of `vertices` path vertices of K1, K2 or K8: a
    closest-hit scan of the cast table and of the spheres, one any-hit
    test (the least an NEE shadow scan can take: its length depends on
    where the first occluder sits in the table, which no count here
    records), the vertex's other work."""
    tc = scene.fp_woop.shape[0]
    s = scene.meta.num_spheres
    return vertices * (tc * OPS['closest_test'] + OPS['any_test'] +
                       s * OPS['sphere_test'] + OPS['vertex'])


def block_rms(got, want, b=8):
    """RMS difference of the b x b-pixel block means over the film mean
    (lajolla_tpu tests/test_vol_kernel.py's d8)."""
    h, w = want.shape[:2]
    a = got.reshape(h // b, b, w // b, b, 3).mean((1, 3))
    c = want.reshape(h // b, b, w // b, b, 3).mean((1, 3))
    return float(((a - c) ** 2).mean() ** 0.5 / c.mean())


def kernel_alone_ms(torch, kernels, fn, reps, timer=None):
    """queued_ms (or `timer`) of fn() with kernels.film_sum left out (a
    (3, n) view of the buffer in place of the film): the time of the
    kernel that fn launches (its wrapper's buffer, counter and launch).
    queued_ms warms up and times each call on the card alone: a host
    stall between back-to-back calls (cuda_ms) would count as kernel
    time."""
    with mock.patch.object(kernels, 'film_sum',
                           lambda buf, n, stride, nspp, film=None:
                           buf[:n].T):
        return (timer or queued_ms)(torch, fn, reps)


def simt(counters, stage, lanes):
    """Active lane-iterations over 32 x warp-iterations of a stage."""
    passes = counters[stage]
    return counters[lanes] / (32 * passes) if passes else 0.0


def film_sum_agrees(torch, kernels, plain, dev, shapes):
    """film_sum_kernel against its plain form, bit for bit, on random
    buffers of each (n, stride, nspp) shape with every 97th sample given
    a non-finite channel, summed whole and, as K1 sums its chunked
    launches, in two chunks of samples, the second added onto the film of
    the first; prints one line and raises on a difference."""
    for n, stride, nspp in shapes:
        g = torch.Generator(device=dev).manual_seed(n + nspp)
        buf = torch.rand((nspp * stride, 3), generator=g, device=dev)
        bad = torch.arange(0, nspp * stride, 97, device=dev)
        buf[bad, bad % 3] = torch.tensor(
            [float('nan'), float('inf'), -float('inf')], device=dev)[bad % 3]
        want = plain(buf, n, stride, nspp)
        k = nspp // 3
        film = kernels.film_sum(buf, n, stride, k)
        film = kernels.film_sum(buf[k * stride:], n, stride, nspp - k, film)
        same = bool(torch.equal(kernels.film_sum(buf, n, stride, nspp),
                                want))
        onto = bool(torch.equal(film, want))
        print(f"[10] film_sum_kernel vs plain, {nspp} samples of {n} pixels "
              f"at stride {stride}: bit-equal {same}; in chunks of {k} and "
              f"{nspp - k} samples, the second added onto the first, "
              f"bit-equal {onto}")
        same = same and onto
        if not same:
            raise AssertionError("film_sum_kernel differs from its plain "
                                 "form")


def hits_agree(torch, label, got, want):
    """Hold closest hits (t, prim, u, v) against their reference at the
    gates of phase 14; returns the largest |t| difference."""
    t, p, u, v = got
    pt, pp, pu, pv = want
    same_t = float((t == pt).float().mean())
    close = torch.allclose(t, pt, rtol=3e-4, atol=3e-5)
    same_p = float((p == pp).float().mean())
    hit = (p == pp) & (pp >= 0)
    uv = max(float((a[hit] - b[hit]).abs().max()) if bool(hit.any()) else 0.0
             for a, b in ((u, pu), (v, pv)))
    paired = bool(((p >= 0) == torch.isfinite(t)).all())
    both = torch.isfinite(t) & torch.isfinite(pt)
    err = float((t[both] - pt[both]).abs().max()) if bool(both.any()) else 0.0
    print(f"[14] {label} ({t.shape[0]} rays, hits "
          f"{float((pp >= 0).float().mean()):.3f}): t bit-equal "
          f"{same_t:.6f}, prim equal {same_p:.6f}, max |t diff| {err:.3g}, "
          f"max |u,v diff| {uv:.3g}")
    if not (same_t >= 0.999 and close and same_p >= 0.999 and uv <= 1e-4
            and paired):
        raise AssertionError(f"{label}: outside the gates (t close {close}, "
                             f"prim >= 0 where t finite {paired})")
    return err


def same_occlusion(label, got, want):
    share = float((got == want).float().mean())
    print(f"[14] {label}: occlusion equal {share:.6f} (occluded "
          f"{float(want.float().mean()):.3f})")
    if share != 1.0:
        raise AssertionError(f"{label}: occlusion differs")


def sweep_phases(torch, np, dev, smi):
    """Phases 14 and 15; returns the JSON entries of K4-K7."""
    from lajolla_tpu_torch import cli, kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.io.image import imread3
    from lajolla_tpu_torch.ops import intersect_binned as IB
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.ops.intersect import ray_bounds
    from lajolla_tpu_torch.scene import geometry as PG
    from lajolla_tpu_torch.scene.types import RenderOptions
    from lajolla_tpu_torch.utils import profiling

    plain = dict(sweep_resident=SW.sweep_resident_plain,
                 sweep_resolve=SW.sweep_resolve_plain,
                 sweep_list=SW.sweep_list_plain,
                 sweep_streaming=SW.sweep_streaming_plain)

    def fixture(res, triangles=BIGMESH_TRIANGLES):
        return PT.make_cornell_box(res, 1, 'mesh',
                                   triangles=triangles).to(dev)

    def rays_of(scene):
        """The camera, bounce and shadow rays of a film, made on the card
        with the plain forms, each kind sorted as a cast sorts it."""
        with mock.patch.multiple(kernels, **plain):
            rays = PT.general_rays(scene, seed=13, device=dev)
        out = {}
        for kind, (o, d, tn, tf) in rays.items():
            perm = torch.argsort(SW._sort_keys(scene, o, d), stable=True)
            out[kind] = tuple(x[perm].contiguous() for x in (o, d, tn, tf))
        return out

    def packed(ray):
        o, d, tn, tf = SW._pad_rays(*ray, SW.BLOCK_R)
        return SW._pack_rays(o, tn, d, tf)

    # ---- 14. K4-K7 against their plain forms
    mesh = fixture(256)
    mesh64 = PT.repack_clusters(mesh, 64)
    K, _, C = mesh.sw_lane.shape
    S = mesh.sw_saabb.shape[0]
    print(f"[14] mesh Cornell box: {mesh.meta.num_triangles} triangles, "
          f"{K} clusters of {C} in {S} superclusters, sweep table "
          f"{mesh.sw_lane.numel() * 4} B (resident up to "
          f"{SW.RESIDENT_BYTES} B); at 64 a cluster "
          f"{mesh64.sw_aabb.shape[0]} clusters")
    if mesh.sw_lane.numel() * 4 > SW.RESIDENT_BYTES:
        raise AssertionError("the mesh fixture's table is not resident")
    errs = dict.fromkeys(plain, 0.0)
    overflowed = 0
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)
    def resident_agrees(scene, kind, ray, L, label):
        """K5 (closest and any hit) and K4 on K5's hits against their
        plain forms for lists of L entries; returns (largest |t|
        difference, blocks in supercluster mode)."""
        args = SW.list_inputs(scene, *ray, SW.LIST_B, L)
        lists = (scene.sw_lane, scene.sw_aabb, *args[1:])
        t, kid = kernels.sweep_resident(args[0], *lists, False)
        pt, pkid = SW.sweep_resident_plain(args[0], *lists, False)
        z = zeros(t)
        err = hits_agree(torch, f"{label} vs plain, {kind} rays, lists of "
                         f"{L}", (t, kid, z, z), (pt, pkid, z, z))
        ta, _ = kernels.sweep_resident(args[0], *lists, True)
        pta, _ = SW.sweep_resident_plain(args[0], *lists, True)
        same_occlusion(f"{label} any hit vs plain, {kind} rays",
                       torch.isfinite(ta), torch.isfinite(pta))
        hits = torch.cat([args[0][:, :7], t[:, None]], dim=1).contiguous()
        got = kernels.sweep_resolve(hits, kid, scene.sw_lane)
        want = SW.sweep_resolve_plain(hits, kid, scene.sw_lane)
        hits_agree(torch, f"K4 on {label}'s hits vs plain, {kind} rays",
                   (t, *got), (t, *want))
        return err, int((args[1] < 0).sum())

    # K5's supercluster mode: a mesh of few clusters with lists of one
    # entry per supercluster, the shortest the list build takes
    few = fixture(256, 3500)
    for kind, ray in rays_of(few).items():
        err, over = resident_agrees(few, kind, ray, few.sw_saabb.shape[0],
                                    'K5 overflow')
        errs['sweep_resident'] = max(errs['sweep_resident'], err)
        overflowed += over
    print(f"[14] K5 overflow ({few.meta.num_triangles} triangles, "
          f"{few.sw_aabb.shape[0]} clusters): {overflowed} blocks swept "
          f"superclusters")
    if overflowed == 0:
        raise AssertionError("no block of K5 overflowed its list")

    # ties: identical triangles a round of 32 apart in one cluster, one
    # more in a second cluster that the lists hold first
    tables, tie_rays, _ = PT.sweep_tie_fixture(seed=5)
    ties = types.SimpleNamespace(**{k: torch.from_numpy(v).to(dev)
                                    for k, v in tables.items()})
    tie_ray = tuple(torch.from_numpy(x).to(dev) for x in tie_rays)
    perm = torch.argsort(SW._sort_keys(ties, *tie_ray[:2]), stable=True)
    tie_ray = tuple(x[perm].contiguous() for x in tie_ray)
    Kt = ties.sw_aabb.shape[0]
    for label, B, L in (('K5', SW.LIST_B, min(SW.LIST_LEN, Kt)),
                        ('K5 overflow', SW.LIST_B, 1),
                        ('K6', SW.LANE_R, Kt)):
        args = SW.list_inputs(ties, *tie_ray, B, L)
        lists = (ties.sw_lane, ties.sw_aabb, *args[1:])
        if label == 'K6':
            outs = {'closest': (kernels.sweep_list(args[0], *lists, False),
                                SW.sweep_list_plain(args[0], *lists, False)),
                    'any': (kernels.sweep_list(args[0], *lists, True),
                            SW.sweep_list_plain(args[0], *lists, True))}
        else:
            got = kernels.sweep_resident(args[0], *lists, False)
            want = SW.sweep_resident_plain(args[0], *lists, False)
            hits = torch.cat([args[0][:, :7], want[0][:, None]],
                             dim=1).contiguous()
            outs = {'closest': (got, want),
                    'any': (kernels.sweep_resident(args[0], *lists, True),
                            SW.sweep_resident_plain(args[0], *lists, True)),
                    'K4 on the hits': (
                        kernels.sweep_resolve(hits, want[1], ties.sw_lane),
                        SW.sweep_resolve_plain(hits, want[1], ties.sw_lane))}
        for what, (got, want) in outs.items():
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
            print(f"[14] ties, {label} {what} vs plain ({args[0].shape[0]} "
                  f"rays, {int((args[1] < 0).sum())} blocks in supercluster "
                  f"mode): every output bit-equal {same}")
            if not same:
                raise AssertionError(f"ties: {label} {what} differs from "
                                     "its plain form")

    # K7's ties: the fixture at 64 triangles a cluster, copies of A at 7,
    # 34 and 39 (lanes 7, 2 and 7 of a round), the clusters in id order
    tables, tie_rays, _ = PT.sweep_tie_fixture(seed=5, C=64)
    ties = types.SimpleNamespace(**{k: torch.from_numpy(v).to(dev)
                                    for k, v in tables.items()})
    tie_ray = tuple(torch.from_numpy(x).to(dev) for x in tie_rays)
    perm = torch.argsort(SW._sort_keys(ties, *tie_ray[:2]), stable=True)
    tie_ray = packed(tuple(x[perm].contiguous() for x in tie_ray))
    tabs = (ties.sw_saabb, ties.sw_aabb, ties.sw_lane)
    for what, any_hit in (('closest', False), ('any', True)):
        same = all(bool(torch.equal(a, b)) for a, b in zip(
            kernels.sweep_streaming(tie_ray, *tabs, any_hit),
            SW.sweep_streaming_plain(tie_ray, *tabs, any_hit)))
        print(f"[14] ties at 64 a cluster, K7 {what} vs plain "
              f"({tie_ray.shape[0]} rays): every output bit-equal {same}")
        if not same:
            raise AssertionError(f"ties: K7 {what} differs from its plain "
                                 "form")

    # the resolve's own ties: equal err at t_best -+ delta in two lanes of
    # the warp (testing.RESOLVE_PAIRS), the lower index in the lower and in
    # the higher lane, and a strictly smaller err at a higher index
    tables, rrays, rkid, rwant = PT.resolve_tie_fixture(seed=5)
    rargs = (torch.from_numpy(rrays).to(dev), torch.from_numpy(rkid).to(dev),
             torch.from_numpy(tables['sw_lane']).to(dev))
    got = kernels.sweep_resolve(*rargs)
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(got, SW.sweep_resolve_plain(*rargs)))
    named = bool((got[0].cpu().numpy() == rwant).all())
    print(f"[14] ties, K4 on equal err in two lanes {PT.RESOLVE_PAIRS} vs "
          f"plain ({rrays.shape[0]} rays): every output bit-equal {same}, "
          f"the prim the rule names {named}")
    if not (same and named):
        raise AssertionError("ties: K4 differs from its plain form or the "
                             "rule")

    for kind, ray in rays_of(mesh).items():
        err, _ = resident_agrees(mesh, kind, ray, min(SW.LIST_LEN, K), 'K5')
        errs['sweep_resident'] = max(errs['sweep_resident'], err)
        args = SW.list_inputs(mesh, *ray, SW.LANE_R, K)
        lists = (mesh.sw_lane, mesh.sw_aabb, *args[1:])
        errs['sweep_list'] = max(errs['sweep_list'], hits_agree(
            torch, f"K6 vs plain, {kind} rays",
            kernels.sweep_list(args[0], *lists, False),
            SW.sweep_list_plain(args[0], *lists, False)))
        same_occlusion(f"K6 any hit vs plain, {kind} rays",
                       kernels.sweep_list(args[0], *lists, True)[1] >= 0,
                       SW.sweep_list_plain(args[0], *lists, True)[1] >= 0)
        tabs = (mesh64.sw_saabb, mesh64.sw_aabb, mesh64.sw_lane)
        errs['sweep_streaming'] = max(errs['sweep_streaming'], hits_agree(
            torch, f"K7 vs plain, {kind} rays",
            kernels.sweep_streaming(packed(ray), *tabs, False),
            SW.sweep_streaming_plain(packed(ray), *tabs, False)))
        same_occlusion(
            f"K7 any hit vs plain, {kind} rays",
            kernels.sweep_streaming(packed(ray), *tabs, True)[1] >= 0,
            SW.sweep_streaming_plain(packed(ray), *tabs, True)[1] >= 0)

        # the second witness, through the public casts
        sub = tuple(x[::4].contiguous() for x in ray)
        want = IB.intersect_binned(mesh, *sub)
        want_occ = IB.occluded_binned(mesh, *sub)
        for route, scene, resident in (
                ('K5 + K4', mesh, SW.RESIDENT_BYTES), ('K6', mesh, 0),
                ('K7', mesh64, SW.RESIDENT_BYTES)):
            before = dict(kernels.LAUNCHES)
            with mock.patch.object(SW, 'RESIDENT_BYTES', resident):
                got = SW.intersect_sweep(scene, *sub)
                occ = SW.occluded_sweep(scene, *sub)
            ran = [k for k in plain if kernels.LAUNCHES[k] > before[k]]
            hits_agree(torch, f"{route} vs intersect_binned, {kind} rays, "
                       f"launched {ran}", got, want)
            same_occlusion(f"{route} vs occluded_binned, {kind} rays", occ,
                           want_occ)
    errs['sweep_resolve'] = 0.0     # K4 returns no t; prim, u, v gated above

    # times at 2^18 rays: bounce rays closest hit, shadow rays any hit
    big = fixture(512)
    big64 = PT.repack_clusters(big, 64)
    rays = rays_of(big)
    n = rays['bounce'][0].shape[0]
    entries = {}
    k7_events = {}                  # K7 at 2^18 by CUDA events

    def timed(name, any_hit, kernel_fn, plain_fn, nbytes, tris,
              label=None, nr=None, device=None, events=None):
        """A kernel's and its plain form's time and the bound of the work
        the plain form counted, printed under `label` (by default the
        2^18-ray line of [14]) with the work per ray of its nr rays. The
        kernel's time is by CUDA events or, given the kernel's `device`
        name, its device time in a trace (device_ms). Given `events`, a
        dict, the device time is the median of 5 traces (one trace has
        read half the time of a 1.8 ms launch), the CUDA-event time goes
        into events[name, any_hit], and the two must agree within 20%:
        for a launch far longer than its host call."""
        nr = nr or n
        which = 'any hit, shadow' if any_hit else 'closest hit, bounce'
        label = label or f"[14] {name} at 2^18 {which} rays"
        stats = {}
        ms = (device_ms(torch, kernel_fn, 10, device) if device else
              cuda_ms(torch, kernel_fn, 10))
        if events is not None:
            traced = sorted([ms] + [device_ms(torch, kernel_fn, 10, device)
                                    for _ in range(4)])
            ms = traced[2]
            ev = events[name, any_hit] = cuda_ms(torch, kernel_fn, 10)
            label += (" [median of traces " +
                      ", ".join(f"{x:.4f}" for x in traced) +
                      f"; CUDA events {ev:.4f} ms]")
            if abs(ms - ev) > 0.2 * ev:
                raise AssertionError(
                    f"{name}'s device time {ms:.4f} ms and CUDA events "
                    f"{ev:.4f} ms disagree by more than 20%")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_fn(stats)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        ops = (stats.get('slab_tests', 0) * OPS['slab_test'] +
               stats['cluster_tests'] * tris *
               OPS['any_test' if any_hit else 'closest_test'])
        bnd = bound(ops, nbytes)
        print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bnd[0]:.5f} ms ({bnd[1]}); per ray "
              f"{stats.get('slab_tests', 0) / nr:.2f} slab tests, "
              f"{stats['cluster_tests'] / nr:.3f} clusters of {tris} "
              f"triangles tested"
              + (f", {stats['entries']} (block, list entry) pairs swept"
                 if 'entries' in stats else '') + f" ({smi})")
        return ms, plain_ms, bnd

    def nbytes_of(*tensors):
        return sum(x.numel() * x.element_size() for x in tensors)

    def streaming_bytes(rays, scene):
        """The bytes K7 must move: its rays in, (t, prim, u, v) out, the
        box rows and the lane table's rows 0-12 (Woop, prim), each once."""
        K, _, Cs = scene.sw_lane.shape
        return (nbytes_of(rays, scene.sw_saabb, scene.sw_aabb) +
                16 * rays.shape[0] + 4 * 13 * K * Cs)

    def resolve_bytes(kid, prim, lane):
        """The bytes K4 must move: every ray's kid and (prim, u, v), each
        hit ray (32 bytes), rows 0-11 (Woop) of the lane table of each
        cluster a ray won, and the prim entry (row 12) of each triangle it
        resolved, each once. Rows 13-15 and the clusters no ray won are not
        read."""
        won = kid >= 0
        return (16 * kid.numel() + 32 * int(won.sum()) +
                48 * lane.shape[2] * int(kid[won].unique().numel()) +
                4 * int(prim[prim >= 0].unique().numel()))

    for any_hit, ray in ((False, rays['bounce']), (True, rays['shadow'])):
        key = 'any' if any_hit else 'closest'
        which = 'any hit, shadow' if any_hit else 'closest hit, bounce'
        Kb = big.sw_aabb.shape[0]
        args = SW.list_inputs(big, *ray, SW.LIST_B, min(SW.LIST_LEN, Kb))
        lists = (big.sw_lane, big.sw_aabb, *args[1:])
        entries[('sweep_resident', key)] = timed(
            'K5', any_hit,
            lambda: kernels.sweep_resident(args[0], *lists, any_hit),
            lambda st: SW.sweep_resident_plain(args[0], *lists, any_hit,
                                               stats=st),
            nbytes_of(args[0], *lists) + 8 * n, C)
        if not any_hit:
            t, kid = kernels.sweep_resident(args[0], *lists, False)
            hits = torch.cat([args[0][:, :7], t[:, None]], dim=1).contiguous()
            n_hit = int((kid >= 0).sum())
            prim = SW.sweep_resolve_plain(hits, kid, big.sw_lane)[0]
            entries[('sweep_resolve', key)] = timed(
                'K4', False,
                lambda: kernels.sweep_resolve(hits, kid, big.sw_lane),
                lambda st: (st.update(cluster_tests=n_hit),
                            SW.sweep_resolve_plain(hits, kid, big.sw_lane)),
                resolve_bytes(kid, prim, big.sw_lane), C)
        args6 = SW.list_inputs(big, *ray, SW.LANE_R, Kb)
        lists6 = (big.sw_lane, big.sw_aabb, *args6[1:])
        entries[('sweep_list', key)] = timed(
            'K6', any_hit,
            lambda: kernels.sweep_list(args6[0], *lists6, any_hit),
            lambda st: SW.sweep_list_plain(args6[0], *lists6, any_hit,
                                           stats=st),
            nbytes_of(args6[0], *lists6) + 16 * n, C)
        tabs = (big64.sw_saabb, big64.sw_aabb, big64.sw_lane)
        pk = packed(ray)
        entries[('sweep_streaming', key)] = timed(
            'K7', any_hit,
            lambda: kernels.sweep_streaming(pk, *tabs, any_hit),
            lambda st: SW.sweep_streaming_plain(pk, *tabs, any_hit, stats=st),
            streaming_bytes(pk, big64), 64,
            label=f"[14] K7 at 2^18 {which} rays (device time)",
            device='sweep_streaming_kernel', events=k7_events)
        cast = SW.occluded_sweep if any_hit else SW.intersect_sweep
        for route, resident in (('K5 + K4', SW.RESIDENT_BYTES), ('K6', 0)):
            with mock.patch.object(SW, 'RESIDENT_BYTES', resident):
                ms = cuda_ms(torch, lambda: cast(big, *ray), 5)
            print(f"[14] a whole {'any-hit' if any_hit else 'closest-hit'} "
                  f"cast of 2^18 rays through {route} (sort, lists, kernel):"
                  f" {ms:.3f} ms ({smi})")

    # ---- 15. large scenes end to end through the CLI
    def keep(casts, kind, cast):
        """`cast` that keeps the rays of its CAPTURE_CALL-th call in
        casts[kind]."""
        calls = []

        def wrapped(scene_, o, d, tnear, tfar):
            if len(calls) == CAPTURE_CALL:
                tn, tf = ray_bounds(o, tnear, tfar)
                casts[kind] = tuple(x.clone() for x in (o, d, tn, tf))
            calls.append(1)
            return cast(scene_, o, d, tnear, tfar)
        return wrapped

    def render_shape(cell, name, scene, ray, any_hit):
        """K5 or K6 on the rays of one cast of a render, sorted and listed
        as the cast does, through `timed`."""
        Kc, _, Cc = scene.sw_lane.shape
        perm = torch.argsort(SW._sort_keys(scene, *ray[:2]), stable=True)
        ray = tuple(x[perm].contiguous() for x in ray)
        resident = name == 'sweep_resident'
        B, L = (SW.LIST_B, min(SW.LIST_LEN, Kc)) if resident else \
            (SW.LANE_R, Kc)
        args = SW.list_inputs(scene, *ray, B, L)
        lists = (scene.sw_lane, scene.sw_aabb, *args[1:])
        kernel = kernels.sweep_resident if resident else kernels.sweep_list
        plain_fn = SW.sweep_resident_plain if resident else \
            SW.sweep_list_plain
        nr = args[0].shape[0]
        if resident and not any_hit:
            # K4 on K5's hits of the same rays, as the cast hands them over
            t, kid = kernels.sweep_resident(args[0], *lists, False)
            hits = torch.cat([args[0][:, :7], t[:, None]],
                             dim=1).contiguous()
            n_hit = int((kid >= 0).sum())
            want = SW.sweep_resolve_plain(hits, kid, scene.sw_lane)
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                kernels.sweep_resolve(hits, kid, scene.sw_lane), want))
            entries[('sweep_resolve', 'render_closest')] = timed(
                'K4', False,
                lambda: kernels.sweep_resolve(hits, kid, scene.sw_lane),
                lambda st: (st.update(cluster_tests=n_hit),
                            SW.sweep_resolve_plain(hits, kid, scene.sw_lane)),
                resolve_bytes(kid, want[0], scene.sw_lane), Cc,
                label=f"[15] {cell} render shape: K4 on K5's hits of the {nr} "
                f"rays of loop iteration {CAPTURE_CALL + 1} ({n_hit} hits, "
                f"{nr // 8} CUDA blocks; every output bit-equal to the plain "
                f"form's {same}; device time)", nr=nr,
                device='sweep_resolve_kernel')
            if not same:
                raise AssertionError(f"{cell}: K4 differs from its plain form "
                                     "at render shape")
        return timed(
            name, any_hit, lambda: kernel(args[0], *lists, any_hit),
            lambda st: plain_fn(args[0], *lists, any_hit, stats=st),
            nbytes_of(args[0], *lists) + (8 if resident else 16) * nr, Cc,
            label=f"[15] {cell} render shape: {'K5' if resident else 'K6'} "
            f"{'any hit' if any_hit else 'closest hit'} on the {nr} rays of "
            f"loop iteration {CAPTURE_CALL + 1} ({nr // B} list blocks of "
            f"{float(args[1].abs().float().mean()):.1f} entries, {nr // 8} "
            f"CUDA blocks; device time)", nr=nr, device=name + '_kernel')

    launches = dict.fromkeys(plain, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for cell, triangles, size, spp, expect, never in (
                ('bigmesh-683', BIGMESH_TRIANGLES, (683, 512), 2,
                 ('sweep_resident', 'sweep_resolve'), 'sweep_list'),
                ('hugemesh-768', HUGEMESH_TRIANGLES, (768, 575), 1,
                 ('sweep_list',), 'sweep_resident')):
            t0 = time.perf_counter()
            xml = PT.write_cornell_box_xml(os.path.join(tmp, cell), size, spp,
                                           variant='mesh',
                                           triangles=triangles)
            write_s = time.perf_counter() - t0
            exr = os.path.join(tmp, cell + '.exr')
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main([xml, '-o', exr, '--device', 'cuda']) != 0:
                raise AssertionError("CLI failed")
            cli_s = time.perf_counter() - t0
            ran = dict(kernels.LAUNCHES)
            print(f"[15] {cell}: CLI launches {ran}")
            if not (all(ran[k] > 0 for k in expect) and ran[never] == 0):
                raise AssertionError(f"{cell} launched {ran}: expected "
                                     f"{expect} and no {never}")
            for k in expect:
                launches[k] += ran[k]
            im = imread3(exr)
            lum = luminance(im)
            if not (im.shape == (size[1], size[0], 3) and
                    np.isfinite(im).all() and 0.05 < lum < 5.0):
                raise AssertionError(f"{cell}: bad image, luminance {lum}")
            t0 = time.perf_counter()
            with profiling.recording() as spans:
                scene_cpu, opt = parse_scene(xml, 'cpu')
            parse_s = time.perf_counter() - t0
            build = profiling.seconds_by_name(spans)
            t0 = time.perf_counter()
            scene = scene_cpu.to(dev)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            # the warm render, its casts of one loop iteration kept
            casts = {}
            with mock.patch.multiple(
                    PG, intersect_sweep=keep(casts, 'closest',
                                             SW.intersect_sweep),
                    occluded_sweep=keep(casts, 'any', SW.occluded_sweep)):
                render(scene, opt, device=dev)
            torch.cuda.synchronize()
            for any_hit in (False, True):
                name = expect[0]
                key = 'render_any' if any_hit else 'render_closest'
                entries[(name, key)] = render_shape(
                    cell, name, scene, casts[key[7:]], any_hit)
            t0 = time.perf_counter()
            _, iters = counted(PP, lambda: render(scene, opt, device=dev))
            render_s = time.perf_counter() - t0
            paths = size[0] * size[1] * spp
            Kc = scene.sw_aabb.shape[0]
            print(f"[15] {cell} {size[0]}x{size[1]} x {spp} spp, "
                  f"{scene.meta.num_triangles} triangles, {Kc} clusters, "
                  f"sweep table {scene.sw_lane.numel() * 4} B: mean "
                  f"luminance {lum:.5f}; scene files written in "
                  f"{write_s:.2f} s; parse + compile {parse_s:.2f} s, of it "
                  f"BVH {build.get('compile.bvh', 0.0):.2f} s, clusters "
                  f"{build.get('compile.clusters', 0.0):.2f} s, packing "
                  f"{build.get('compile.pack', 0.0):.2f} s; upload "
                  f"{upload_s:.3f} s; render() {render_s:.3f} s, "
                  f"{iters} loop iterations, "
                  f"{paths / render_s / 1e6:.4f} Mpaths/s; whole CLI run "
                  f"{cli_s:.2f} s, {paths / cli_s / 1e6:.4f} Mpaths/s; {smi}")

            # the same geometry on a small film against the plain casts
            small = PT.make_cornell_box((128, 96), 2, 'mesh',
                                        triangles=triangles).to(dev)
            opt2 = RenderOptions(samples_per_pixel=2)
            got = render(small, opt2, device=dev)
            with mock.patch.multiple(PG, intersect_sweep=IB.intersect_binned,
                                     occluded_sweep=IB.occluded_binned):
                want = render(small, opt2, device=dev)
            med, mean_rel, _ = film_agreement(got, want)
            lum_rel = abs(luminance(got) - luminance(want)) / luminance(want)
            print(f"[15] {cell} geometry at 128x96 x 2 spp, kernels vs "
                  f"intersect_binned: median rel {med:.3g}, mean rel "
                  f"{mean_rel:.3g}, luminance rel {lum_rel:.3g}")
            if not (med < 1e-4 and mean_rel < 0.01 and lum_rel < 0.01):
                raise AssertionError(f"{cell}: the kernels' film disagrees "
                                     "with the plain casts'")

    # K7 on a path of its own: render() of a scene whose tables are packed
    # at 64 triangles a cluster
    small = PT.make_cornell_box((128, 96), 1, 'mesh', triangles=3500).to(dev)
    small64 = PT.repack_clusters(small, 64)
    opt1 = RenderOptions(samples_per_pixel=1)
    want = render(small, opt1, device=dev)
    render(small64, opt1, device=dev)               # warm
    k7_calls = []
    real_k7 = kernels.sweep_streaming

    def keep_k7(*a):
        k7_calls.append(a)
        return real_k7(*a)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    with mock.patch.object(kernels, 'sweep_streaming', keep_k7):
        got = render(small64, opt1, device=dev)
    ran = dict(kernels.LAUNCHES)
    med, mean_rel, _ = film_agreement(got, want)
    print(f"[15] mesh Cornell box ({small.meta.num_triangles} triangles) at "
          f"128x96 x 1 spp, tables at 64 a cluster: launches {ran}; against "
          f"the film at 128 a cluster: median rel {med:.3g}, mean rel "
          f"{mean_rel:.3g}")
    if not (ran['sweep_streaming'] > 0 and ran['sweep_resident'] == 0 and
            ran['sweep_list'] == 0 and med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("the repacked scene did not render through K7, "
                             "or its film differs")
    launches['sweep_streaming'] = ran['sweep_streaming']
    # K7 at render shape: the render's own casts, replayed
    for any_hit in (False, True):
        calls = [a for a in k7_calls if bool(a[-1]) == any_hit]
        same = all(bool(torch.equal(x, y)) for a in calls for x, y in zip(
            real_k7(*a), SW.sweep_streaming_plain(*a)))
        nr = calls[0][0].shape[0]
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in calls:
            SW.sweep_streaming_plain(*a, stats=stats)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0) / len(calls)
        ms = device_ms(torch, lambda: [real_k7(*a) for a in calls], 3,
                       'sweep_streaming_kernel')
        ops = (stats['slab_tests'] * OPS['slab_test'] +
               stats['cluster_tests'] * 64 *
               OPS['any_test' if any_hit else 'closest_test'])
        bnd = bound(ops / len(calls), streaming_bytes(calls[0][0], small64))
        key = 'render_any' if any_hit else 'render_closest'
        entries[('sweep_streaming', key)] = (ms, plain_ms, bnd)
        print(f"[15] mesh-64 render shape: K7 "
              f"{'any hit' if any_hit else 'closest hit'} on the render's "
              f"{len(calls)} casts of {nr} rays ({nr // 8} CUDA blocks): "
              f"every output bit-equal to the plain form's on every cast "
              f"{same}; kernel {ms:.4f} ms a launch of device time, plain "
              f"{plain_ms:.1f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); per ray "
              f"{stats['slab_tests'] / (nr * len(calls)):.2f} slab tests, "
              f"{stats['cluster_tests'] / (nr * len(calls)):.3f} clusters of "
              f"64 triangles tested ({smi})")
        if not same:
            raise AssertionError("K7 differs from its plain form at render "
                                 "shape")

    # the seam rays (testing.SEAM_PIXELS): pixel-centre rays of the 64x64
    # mesh box that run along a wall seam, which lajolla_tpu's sweep
    # misses; K5 + K4 against the plain sweep on the CPU
    seam = PT.make_cornell_box(64, 1, 'mesh', triangles=PT.SEAM_TRIANGLES)
    depth = RenderOptions(integrator='depth')
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    got = render(seam, depth, device=dev)[..., 0]
    ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = render(seam, depth, device='cpu')[..., 0]
    ys, xs = np.array(PT.SEAM_PIXELS).T
    card_hits = int((got[ys, xs] > 0).sum())
    plain_hits = int((want[ys, xs] > 0).sum())
    print(f"[15] seam rays of the mesh box at 64x64 "
          f"({seam.meta.num_triangles} triangles; launches {ran}): K5 + K4 "
          f"hit {card_hits} of {len(ys)}, the plain sweep {plain_hits}; "
          f"pixels whose hit differs over the film "
          f"{int(((got > 0) != (want > 0)).sum())} of {got.size}")
    if set(ran) != {'sweep_resident', 'sweep_resolve'}:
        raise AssertionError("the seam film did not cast through K5 + K4")
    if card_hits != plain_hits:
        raise AssertionError("K5 + K4 differ from the plain sweep on the "
                             "seam rays")

    lines = []
    for name in ('sweep_resolve', 'sweep_resident', 'sweep_list',
                 'sweep_streaming'):
        ms, plain_ms, bnd = entries[(name, 'closest')]
        entry = {"name": name + "_kernel", "route": "cuda",
                 "source": SWEEP_SOURCE, "replaces": SWEEP_REPLACES[name],
                 "launches": launches[name], "max_abs_err": errs[name],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                 "bound_by": bnd[1], "library_ms": None}
        for key, prefix in (('any', 'any_hit_'),
                            ('render_closest', 'render_'),
                            ('render_any', 'render_any_hit_')):
            if (name, key) in entries:
                ms, plain_ms, bnd = entries[(name, key)]
                entry.update({prefix + 'ms': ms,
                              prefix + 'plain_ms': plain_ms,
                              prefix + 'bound_ms': bnd[0],
                              prefix + 'bound_by': bnd[1]})
        if name == 'sweep_streaming':
            entry.update(cuda_event_ms=k7_events['K7', False],
                         any_hit_cuda_event_ms=k7_events['K7', True])
        lines.append(entry)
    return lines


def aux_phase(torch, np, dev, smi):
    """[16]: the aux integrators through the CLI on the card. Returns the
    launches of their runs, by kernel."""
    from lajolla_tpu_torch import cli, kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.io.image import imread3
    from lajolla_tpu_torch.scene.types import RenderOptions

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    cells = (('aux-512', None, (512, 512), AUX_MODES, ('intersect_brute',)),
             ('bigmesh-683', 'mesh', (683, 512), ('depth', 'shadingNormal'),
              ('sweep_resident', 'sweep_resolve')))
    with tempfile.TemporaryDirectory() as tmp:
        for cell, variant, (w, h), modes, expect in cells:
            small = PT.make_cornell_box(AUX_CHECK_FILM, 1, variant,
                                        triangles=BIGMESH_TRIANGLES)
            small_dev = small.to(dev)
            for mode in modes:
                xml = PT.write_cornell_box_xml(
                    os.path.join(tmp, f'{cell}-{mode}'), (w, h), 1,
                    variant=variant, triangles=BIGMESH_TRIANGLES,
                    integrator=mode)
                exr = os.path.join(tmp, f'{cell}-{mode}.exr')
                for k in kernels.LAUNCHES:
                    kernels.LAUNCHES[k] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if cli.main([xml, '-o', exr, '--device', 'cuda']) != 0:
                    raise AssertionError("CLI failed")
                cli_s = time.perf_counter() - t0
                ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
                if not (set(ran) == set(expect)):
                    raise AssertionError(f"{cell} {mode} launched {ran}: "
                                         f"expected {expect} alone")
                for k, v in ran.items():
                    total[k] += v
                im = imread3(exr)
                if not (im.shape == (h, w, 3) and np.isfinite(im).all()):
                    raise AssertionError(f"{cell} {mode}: bad image")
                scene, opt = parse_scene(xml, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(scene, opt, device=dev)
                render_s = time.perf_counter() - t0
                opt = RenderOptions(integrator=mode)
                got = render(small_dev, opt, device=dev)
                want = render(small, opt, device='cpu')
                share = PT.aux_agreement(got, want, mode)
                print(f"[16] {cell} {mode} {w}x{h}: CLI {cli_s:.3f} s, "
                      f"render() {render_s:.4f} s; launches {ran}; at "
                      f"{AUX_CHECK_FILM[0]}x{AUX_CHECK_FILM[1]} against the "
                      f"CPU's film (plain casts): {share:.6f} of the values "
                      f"within the gate ({smi})")
                if share < 0.999 or (mode in ('depth', 'shadingNormal',
                                              'rayDifferential')
                                     and not np.abs(want).max() > 0):
                    raise AssertionError(f"{cell} {mode}: the card's film "
                                         "disagrees with the CPU's")
    print(f"[16] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


def disney_phase(torch, np, dev, smi):
    """[17]: the Disney Cornell box at 512x512 x 8 spp (disney-512)
    through the CLI on the card, its trace, and its films against the
    plain casts and the CPU. Returns the launches of the CLI run, by
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lajolla_tpu_torch import cli, kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.io.image import imread3
    from lajolla_tpu_torch.ops.intersect import (_brute_force_batched,
                                                 _occluded_batched)
    from lajolla_tpu_torch.scene.types import RenderOptions

    t_phase = time.perf_counter()
    res, spp = 512, 8
    paths = res * res * spp
    lo, hi = PT.CBOX_DISNEY_LUMINANCE
    with tempfile.TemporaryDirectory() as tmp:
        xml = PT.write_cornell_box_xml(os.path.join(tmp, 'disney'), res, spp,
                                       variant='disney')
        exr = os.path.join(tmp, 'disney512.exr')
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main([xml, '-o', exr, '--device', 'cuda']) != 0:
            raise AssertionError("CLI failed")
        cli_s = time.perf_counter() - t0
        ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if set(ran) != {'intersect_brute', 'occluded_brute'}:
            raise AssertionError(f"disney-512 launched {ran}: expected K3 "
                                 "alone")
        im = imread3(exr)
        lum = luminance(im)
        print(f"[17] disney-512 {res}x{res} x {spp} spp: CLI launches {ran}; "
              f"mean luminance {lum:.5f} (the builder's range {lo}-{hi})")
        if not (im.shape == (res, res, 3) and np.isfinite(im).all() and
                lo < lum < hi):
            raise AssertionError("disney-512: bad image")
        scene, opt = parse_scene(xml, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, iters = counted(PP, lambda: render(scene, opt, device=dev))
    render_s = time.perf_counter() - t0
    print(f"[17] disney-512: {paths / cli_s / 1e6:.4f} Mpaths/s over the "
          f"whole CLI run ({cli_s:.3f} s), {paths / render_s / 1e6:.4f} "
          f"Mpaths/s render() alone ({render_s:.3f} s), {iters} loop "
          f"iterations; {smi}")

    # one traced render of the film at 1 spp (tracing the 8 spp render
    # and reading its 1.6 million device activities takes ~56 s): the
    # device's idle share, launches an iteration, K3's share of the device
    # time
    opt1 = dataclasses.replace(opt, samples_per_pixel=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, iters1 = counted(PP, lambda: render(scene, opt1, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the profiler's raw events (µs): building prof.events() from a
    # million of them takes minutes
    ev = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    busy = busy_seconds((a, b) for _, a, b in ev)
    k3_s = sum(b - a for n, a, b in ev if 'brute_kernel' in n) / 1e6
    print(f"[17] disney-512 at 1 spp, traced render(): {iters1} loop "
          f"iterations, wall {wall:.3f} s, device busy "
          f"{busy:.3f} s, idle share {1.0 - busy / wall:.4f}; "
          f"{len(ev)} device activities, {len(ev) / iters1:.0f} an "
          f"iteration; K3 {1e3 * k3_s:.2f} ms, {k3_s / max(busy, 1e-9):.4f} "
          f"of the busy time (trace read in {time.perf_counter() - t1:.1f} s; "
          f"{smi})")

    # the general engine with K3 against it with the plain casts ([8])
    t1 = time.perf_counter()
    small = PT.make_cornell_box(128, 4, 'disney').to(dev)
    film_k, _, _ = PP._render_block_sc(small, RenderOptions(), 0, 0, 4)
    with mock.patch.multiple(kernels, intersect_brute=_brute_force_batched,
                             occluded_brute=_occluded_batched):
        film_p, _, _ = PP._render_block_sc(small, RenderOptions(), 0, 0, 4)
    med, mean_rel, _ = film_agreement(film_k.cpu().numpy() / 4,
                                      film_p.cpu().numpy() / 4)
    print(f"[17] general engine, K3 vs plain casts, disney 128x128 x 4 spp: "
          f"median rel {med:.3g}, mean rel {mean_rel:.3g} "
          f"({time.perf_counter() - t1:.1f} s)")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("disney: the general engine with K3 disagrees "
                             "with it with the plain casts")

    # the card's film against the CPU's
    s64 = PT.make_cornell_box(64, 4, 'disney')
    opt4 = RenderOptions(samples_per_pixel=4)
    t1 = time.perf_counter()
    got = render(s64, opt4, device=dev)
    t2 = time.perf_counter()
    want = render(s64, opt4, device='cpu')
    t3 = time.perf_counter()
    med, mean_rel, _ = film_agreement(got, want)
    d8 = block_rms(got, want)
    print(f"[17] disney 64x64 x 4 spp, the card's film against the CPU's: "
          f"mean rel {mean_rel:.3g}, 8x8-block RMS {d8:.4f}, median rel "
          f"{med:.3g}, pixels equal {float((got == want).mean()):.4f} "
          f"(card {t2 - t1:.1f} s, CPU {t3 - t2:.1f} s)")
    if not (mean_rel < 0.01 and d8 < 0.12):
        raise AssertionError("disney: the card's film disagrees with the "
                             "CPU's")
    print(f"[17] phase {time.perf_counter() - t_phase:.1f} s")
    return ran


def traced_render(torch, fn):
    """fn() under torch.profiler: (wall seconds, device busy seconds,
    device activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return wall, busy_seconds(ev), len(ev)


def vol12_phase(torch, np, dev, smi):
    """[18]: volpath versions 1 and 2 — the threefry on the card, the
    cells vol1-512 and vol2-512 through the CLI, a trace of vol2-512, and
    the card's films against the CPU's. Returns the launches of the CLI
    runs, by kernel."""
    from lajolla_tpu_torch import cli, kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.core import random as R
    from lajolla_tpu_torch.io.image import imread3
    from lajolla_tpu_torch.scene.types import RenderOptions

    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    n = 1 << 20
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2),
                                         dtype=np.uint64).astype(np.int64))
    data = torch.from_numpy(rng.integers(0, 1 << 32, n,
                                         dtype=np.uint64).astype(np.int64))
    kd, dd = keys.to(dev), data.to(dev)
    same = {
        'fold_in': torch.equal(R.fold_in(kd, dd).cpu(), R.fold_in(keys, data)),
        'split': all(torch.equal(a.cpu(), b) for a, b in
                     zip(R.split(kd), R.split(keys))),
        'uniform': torch.equal(R.uniform(kd, 5).cpu().view(torch.int32),
                               R.uniform(keys, 5).view(torch.int32))}
    print(f"[18] threefry on {n} keys, the card's words against the CPU's: "
          f"{same}")
    if not all(same.values()):
        raise AssertionError("the threefry differs on the card")

    res, spp = 512, 16
    paths = res * res * spp
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    expect = {1: {'intersect_brute'},
              2: {'intersect_brute', 'occluded_brute'}}
    lum_range = {1: (0.005, 0.5), 2: (0.001, 0.5)}
    with tempfile.TemporaryDirectory() as tmp:
        for version in (1, 2):
            cell = f'vol{version}-512'
            xml = PT.write_cornell_box_xml(os.path.join(tmp, cell), res, spp,
                                           variant='vol',
                                           vol_path_version=version)
            exr = os.path.join(tmp, cell + '.exr')
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main([xml, '-o', exr, '--device', 'cuda']) != 0:
                raise AssertionError("CLI failed")
            cli_s = time.perf_counter() - t0
            ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
            for k, v in ran.items():
                total[k] += v
            im = imread3(exr)
            lum = luminance(im)
            lo, hi = lum_range[version]
            if set(ran) != expect[version]:
                raise AssertionError(f"{cell} launched {ran}: expected "
                                     f"{expect[version]}")
            if not (im.shape == (res, res, 3) and np.isfinite(im).all() and
                    lo < lum < hi):
                raise AssertionError(f"{cell}: bad image (luminance {lum})")
            scene, opt = parse_scene(xml, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, opt, device=dev)
            render_s = time.perf_counter() - t0
            print(f"[18] {cell} {res}x{res} x {spp} spp: mean luminance "
                  f"{lum:.5f}; {paths / cli_s / 1e6:.3f} Mpaths/s over the "
                  f"whole CLI run ({cli_s:.3f} s), {paths / render_s / 1e6:.3f}"
                  f" Mpaths/s render() alone ({render_s:.3f} s); K3 launches "
                  f"closest {ran.get('intersect_brute', 0)}, any "
                  f"{ran.get('occluded_brute', 0)}; {smi}")
            if version == 2:
                wall, busy, acts = traced_render(
                    torch, lambda: render(scene, opt, device=dev))
                print(f"[18] {cell}, traced render(): wall {wall:.3f} s, "
                      f"device busy {busy:.3f} s, idle share "
                      f"{1.0 - busy / wall:.4f}; {acts} device activities, "
                      f"{acts / spp:.0f} a sample")

    # the card's films against the CPU's
    s64 = PT.make_cornell_box(64, variant='vol')
    for version in (1, 2):
        opt = RenderOptions(integrator='volpath', vol_path_version=version,
                            samples_per_pixel=4)
        got = render(s64, opt, device=dev)
        want = render(s64, opt, device='cpu')
        med, mean_rel, err = film_agreement(got, want)
        print(f"[18] version {version} 64x64 x 4 spp, the card's film against "
              f"the CPU's: median rel {med:.3g}, mean rel {mean_rel:.3g}, "
              f"largest |diff| {err:.3g}, pixels equal "
              f"{float((got == want).mean()):.4f}")
        if not (med < 1e-4 and mean_rel < 0.01):
            raise AssertionError(f"version {version}: the card's film "
                                 "disagrees with the CPU's")
    print(f"[18] phase {time.perf_counter() - t_phase:.1f} s")
    return total


def grad_phase(torch, np, dev, smi):
    """[19]: the gradients on the card — cell diff-256 (render_diff's
    forward and backward), the albedo gradient against the CPU's and
    central differences, grad_fwd against reverse mode, the volumetric
    gradients against the CPU's, and the example's albedo recovery.
    Returns the launches of diff-256, by kernel."""
    from lajolla_tpu_torch import kernels
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.examples import inverse_rendering as EX
    from lajolla_tpu_torch.integrators import diffpath as PD
    from lajolla_tpu_torch.integrators.media import MT_SA
    from lajolla_tpu_torch.scene.types import RenderOptions

    t_phase = time.perf_counter()
    opts = RenderOptions(max_depth=4)

    def albedo_loss(scene, spp, seed=1):
        tid = EX.red_wall_texture(scene)

        def loss(s):
            tab = scene.tex_tab.clone()
            tab[tid, 2:5] = scene.tex_tab[tid, 2:5] * s
            return PD.render_diff(dataclasses.replace(scene, tex_tab=tab),
                                  opts, seed=seed, spp=spp, depth=4).mean()
        return loss

    def reverse(loss, device):
        x = torch.tensor(1.0, device=device, requires_grad=True)
        loss(x).backward()
        return float(x.grad)

    def peak_above(base):
        """max_memory_allocated since the last reset, and that less the
        `base` bytes held before the render (earlier phases' tensors)."""
        peak = torch.cuda.max_memory_allocated(dev)
        return (f"max_memory_allocated {peak / 2**20:.1f} MiB, "
                f"{(peak - base) / 2**20:.1f} MiB above the "
                f"{base / 2**20:.1f} MiB held before it")

    # diff-256: forward and backward of the film mean, twice (the first
    # warms the allocator); the second is the cell's
    res, spp = 256, 4
    big = PT.make_cornell_box(res).to(dev)
    loss = albedo_loss(big, spp)
    for run in range(2):
        x = torch.tensor(1.0, device=dev, requires_grad=True)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        y = loss(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"[19] diff-256 {res}x{res} x {spp} spp, depth 4 (Cornell box, "
          f"{res * res * spp} lanes): forward {t1 - t0:.3f} s, backward "
          f"{t2 - t1:.3f} s, {peak_above(base)}; "
          f"d(mean)/d(red-wall scale) {float(x.grad):.6g}; launches {ran}; "
          f"{smi}")
    if set(ran) != {'intersect_brute', 'occluded_brute'}:
        raise AssertionError(f"diff-256 launched {ran}: expected K3 alone")
    if not np.isfinite(float(x.grad)) or not float(x.grad) > 0:
        raise AssertionError("diff-256: bad gradient")

    # the albedo gradient on the card against the CPU's, central
    # differences and forward mode
    small = PT.make_cornell_box(32)
    card = albedo_loss(small.to(dev), 2)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    g_card = reverse(card, dev)
    mem32 = peak_above(base)
    g_cpu = reverse(albedo_loss(small, 2), 'cpu')
    eps = 1e-2
    with torch.no_grad():
        fd = float(card(torch.tensor(1.0 + eps, device=dev)) -
                   card(torch.tensor(1.0 - eps, device=dev))) / (2 * eps)
    gf = float(PD.grad_fwd(card, torch.tensor(1.0, device=dev)))
    rel = dict(cpu=abs(g_card / g_cpu - 1), fd=abs(g_card / fd - 1),
               fwd=abs(gf / g_card - 1))
    print(f"[19] albedo gradient, Cornell box 32x32 x 2 spp: card "
          f"{g_card:.7g}, CPU {g_cpu:.7g} (rel {rel['cpu']:.3g}), central "
          f"differences on the card {fd:.7g} (rel {rel['fd']:.3g}), grad_fwd "
          f"on the card {gf:.7g} (rel {rel['fwd']:.3g}); reverse mode's "
          f"{mem32}")
    if not (rel['cpu'] < 1e-3 and rel['fd'] < 5e-3 and rel['fwd'] < 1e-4):
        raise AssertionError("the card's albedo gradient is off")

    # the volumetric gradients against the CPU's
    vol = PT.make_cornell_box(32, variant='vol')
    for version, cols, vspp in ((1, 3, 4), (2, 6, 16)):
        vo = RenderOptions(integrator='volpath', vol_path_version=version)

        def vloss(scene):
            def loss(s):
                med = scene.med_tab.clone()
                med[:, MT_SA:MT_SA + cols] = \
                    scene.med_tab[:, MT_SA:MT_SA + cols] * s
                return PD.render_volpath_diff(
                    dataclasses.replace(scene, med_tab=med), vo, seed=1,
                    spp=vspp).mean()
            return loss
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        vol_dev = vol.to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        g_card = reverse(vloss(vol_dev), dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        vran = {k: v for k, v in kernels.LAUNCHES.items() if v}
        vmem = peak_above(base)
        g_cpu = reverse(vloss(vol), 'cpu')
        r = abs(g_card / g_cpu - 1)
        print(f"[19] render_volpath_diff version {version}, vol 32x32 x "
              f"{vspp} spp, d(mean)/d(sigma scale): card {g_card:.7g}, CPU "
              f"{g_cpu:.7g} (rel {r:.3g}); card {card_s:.3f} s, {vmem}; "
              f"launches {vran}")
        if not r < 1e-3:
            raise AssertionError(f"version {version}: the card's gradient "
                                 "disagrees with the CPU's")

    # the example's albedo recovery on the card
    t0 = time.perf_counter()
    l0, lN, kd, kd_true = EX.recover_albedo(dev)
    dkd = float((kd - kd_true).abs().max())
    print(f"[19] albedo recovery (the example: 40 Adam steps at 24x24 x 4 "
          f"spp, depth 4): loss {l0:.4g} -> {lN:.4g} (ratio {lN / l0:.3g}), "
          f"kd {kd.cpu().numpy().round(4)} vs {kd_true.cpu().numpy()} (largest "
          f"|diff| {dkd:.4f}); {time.perf_counter() - t0:.1f} s")
    if not (lN < 1e-2 * l0 and dkd < 0.02):
        raise AssertionError("the albedo recovery failed on the card")
    print(f"[19] phase {time.perf_counter() - t_phase:.1f} s")
    return ran


def sharded_phase(torch, np, dev, smi):
    """[20]: render_sharded (parallel/mesh.py) on one rank over NCCL and on
    two ranks sharing the card over gloo (parallel.spawn), each cell
    against the one-process render on the card. Returns the two-rank
    run's launches, by kernel: [rank 0's, rank 1's], summed over the
    cells."""
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators.diffpath import render_diff
    from lajolla_tpu_torch.parallel.spawn import spawn
    from lajolla_tpu_torch.scene.types import RenderOptions

    t_phase = time.perf_counter()
    cbox = PT.make_cornell_box(512)
    cells = [  # (name, scene, options, kind, runs)
        ('cbox-512', cbox, RenderOptions(samples_per_pixel=256), 'render',
         2),
        ('vol-512', PT.make_cornell_box(512, 256, 'vol'),
         RenderOptions(integrator='volpath', samples_per_pixel=256),
         'render', 2),
        ('hetvol-768', PT.make_cornell_box((768, 576), 32, 'hetvol'),
         RenderOptions(integrator='volpath', samples_per_pixel=32),
         'render', 2),
        ('glass-512', PT.make_cornell_box(512, 16, 'glass'),
         RenderOptions(samples_per_pixel=16), 'render', 1),
        ('aux-512', cbox, RenderOptions(integrator='depth'), 'render', 2),
        ('diff-256', PT.make_cornell_box(256),
         RenderOptions(max_depth=4, samples_per_pixel=4), 'diff', 2)]
    cases = [dict(kind=kind, scene=scene, options=opts, seed=0, depth=4,
                  repeats=runs) for _, scene, opts, kind, runs in cells]

    # the one-process renders on the card, as many runs as the sharded
    # ones (the last run's time), launch counters reset before the first
    # and read after it
    want = {}
    for name, scene, opts, kind, runs in cells:
        scene = scene.to(dev)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        launches = None
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == 'diff':
                s = torch.tensor(1.0, device=dev, requires_grad=True)
                img = render_diff(dataclasses.replace(
                    scene, tex_tab=scene.tex_tab * s), opts, 0,
                    spp=opts.samples_per_pixel, depth=4)
                img.mean().backward()
                film, grad = img.detach().cpu().numpy(), float(s.grad)
            else:
                film, grad = render(scene, opts, device=dev), None
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launches or {k: v for k, v in kernels.LAUNCHES.items()
                                    if v}
        want[name] = dict(film=film, grad=grad, seconds=seconds,
                          launches=launches)

    runs = {}
    for ranks, backend in ((1, 'nccl'), (2, 'gloo')):
        t0 = time.perf_counter()
        out = spawn(PT.sharded_cases, ranks, cases, dev, backend=backend,
                    timeout=600)
        label = f"{ranks} rank{'s' if ranks > 1 else ''} ({backend})"
        print(f"[20] {label}: spawn and every cell "
              f"{time.perf_counter() - t0:.1f} s")
        for i, (name, _scene, opts, kind, _) in enumerate(cells):
            ref = want[name]
            for r, res in enumerate(o[i] for o in out):
                ran = {k: v for k, v in res['launches'].items() if v}
                if opts.integrator in AUX_MODES:
                    share = PT.aux_agreement(res['film'], ref['film'],
                                             opts.integrator)
                    ok = share >= 0.999
                    gate = f"{share:.6f} of the values within the aux gate"
                else:
                    med, mean_rel, _ = film_agreement(res['film'],
                                                      ref['film'])
                    ok = med < 1e-4 and mean_rel < 0.01
                    gate = f"median rel {med:.3g}, mean rel {mean_rel:.3g}"
                if kind == 'diff':
                    rel = abs(res['grad'] / ref['grad'] - 1)
                    fwd = abs(res['grad_fwd'] / res['grad'] - 1)
                    ok = ok and rel < 1e-3 and fwd < 1e-4
                    gate += (f"; gradient {res['grad']:.7g} against "
                             f"{ref['grad']:.7g} (rel {rel:.3g}), grad_fwd "
                             f"rel {fwd:.3g}")
                print(f"[20] {label} rank {r}, {name}: {gate}; render "
                      f"{', '.join(f'{t:.4f}' for t in res['seconds'])} s, "
                      f"its collective {res['collective_seconds']:.6f} s, "
                      f"one process {ref['seconds']:.4f} s; launches {ran} "
                      f"(one process {ref['launches']}) ({smi})")
                if not ok:
                    raise AssertionError(f"[20] {label} rank {r}: {name} "
                                         "disagrees with the one-process "
                                         "render")
                if set(ran) != set(ref['launches']):
                    raise AssertionError(
                        f"[20] {label} rank {r}: {name} launched {ran}, the "
                        f"one-process render {ref['launches']}")
        runs[ranks] = out
    print(f"[20] phase {time.perf_counter() - t_phase:.1f} s")
    return {k: [sum(c['launches'][k] for c in rank) for rank in runs[2]]
            for k in kernels.LAUNCHES}


def k2_phase(torch, np, dev, smi):
    """[3]: K2 at each group size against its plain form, the lanes it
    passes through, launches of a cbox-64 render, and its device time at
    2^18 lanes and cbox-64's shape. Returns the numbers of its line in the
    kernels JSON."""
    from lajolla_tpu_torch import kernels
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.integrators.path import (MAX_BOUNCES_CAP,
                                                    _render_block_kernel)
    from lajolla_tpu_torch.scene import compile as PC
    from lajolla_tpu_torch.scene.types import RenderOptions
    options = RenderOptions()

    def lanes_on(scene, n, seed):
        lanes = PT.random_lanes(scene, n, seed)
        return [torch.from_numpy(lanes[k]).to(dev) for k in
                ('org', 'dir', 'thr', 'rad', 'nv', 'dir_pdf', 'prev', 'un',
                 'act')]

    def as_dict(out):
        org, d, thr, rad, dp, _prev, alive = (x.cpu().numpy() for x in out)
        return dict(org=org, dir=d, thr=thr, rad=rad, dir_pdf=dp), alive

    def k2_at(scene, args, group):
        org, d, thr, rad, dp, alive = kernels.advance(
            scene, *args[:4], args[4].float(), *args[5:], group=group,
            **PK.statics(scene, options, MAX_BOUNCES_CAP))
        return org, d, thr, rad, dp, org, alive

    def held(scene, args, out, label):
        """Holds K2's outputs `out` on lanes `args` against the plain
        form's: an inactive lane exactly as it went in, alive false, and
        the active lanes within ADVANCE_RTOL. Returns max |diff|."""
        off = ~args[8]
        passed = all(torch.equal(x[..., off], y[..., off]) for x, y in
                     zip(out[:5], args[:4] + [args[5]]))
        if not passed or out[6][off].any():
            raise AssertionError(f"K2 changed an inactive lane of {label}")
        want, want_alive = as_dict(PK.advance_plain_t(
            scene, options, *args, MAX_BOUNCES_CAP))
        got, got_alive = as_dict(out)
        alive_share, shares, max_abs = PT.advance_agreement(
            got, got_alive, want, want_alive)
        print(f"[3] K2 vs plain, {label}: alive bits agree "
              f"{alive_share:.6f}, alive {want_alive.mean():.3f}; share "
              f"within tolerance {shares}; max |diff| {max_abs:.3g}; the "
              f"{int(off.sum())} inactive lanes passed through")
        PT.assert_advance_agrees(got, got_alive, want, want_alive)
        return max_abs

    PC.MERGE_QUADS = False          # the kernels' has_quads=False branch
    try:
        no_quads = PT.make_cornell_box(512)
    finally:
        PC.MERGE_QUADS = True
    err = 0.0
    for fixture, scene in (('cornell_box', PT.make_cornell_box(512)),
                           ('cornell_box_no_quads', no_quads),
                           ('sphere_lights', PT.make_sphere_light_scene())):
        scene = scene.to(dev)
        args = lanes_on(scene, 1 << 16, 11)
        for group in (1, 2, 4, 8):
            err = max(err, held(scene, args, k2_at(scene, args, group),
                                f"G = {group}, {fixture}, 2^16 lanes"))
    res = dict(err=err)

    def k2_bytes(scene, n):
        # lanes in (org, dir, thr, rad, prev 3 each, nv, dir_pdf, un 8:
        # fp32; act: bool), lanes out (4 x 3 + 1 fp32, alive: bool), the
        # tables
        return n * (4 * (15 + 2 + 8) + 1 + 4 * 13 + 1) + table_bytes(scene)

    cbox = PT.make_cornell_box(512).to(dev)
    args = lanes_on(cbox, 1 << 18, 12)

    def k2_fn():
        return PK.advance_kernel_t(cbox, options, *args, MAX_BOUNCES_CAP)
    res['ms'] = device_ms(torch, k2_fn, 20, 'advance_kernel')
    res['issue_ms'] = cuda_ms(torch, k2_fn, 20)
    res['plain_ms'] = cuda_ms(torch, lambda: PK.advance_plain_t(
        cbox, options, *args, MAX_BOUNCES_CAP), 5)
    res['bound'] = bound(vertex_ops(cbox, int(args[8].sum())),
                         k2_bytes(cbox, args[0].shape[1]))
    print(f"[3] K2 at 2^18 lanes (Cornell box, G = "
          f"{kernels.advance_group(1 << 18)}): kernel {res['ms']:.4f} ms of "
          f"device time (CUDA events, the host's issue rate: "
          f"{res['issue_ms']:.4f} ms), plain {res['plain_ms']:.3f} ms, bound "
          f"{res['bound'][0]:.5f} ms ({res['bound'][1]}) ({smi})")
    # the per-bounce driver's launches on the Cornell box at 64x64 x 16
    # spp (one lane a pixel: 4,096 lanes, the largest film render() sends
    # to the driver), kept and replayed; those with the full pool, the
    # first below half, a tenth and a hundredth of the lanes active held
    # against the plain form
    cbox64 = PT.make_cornell_box(64).to(dev)
    n = 64 * 64
    calls = []

    def keep(scene_, options_, *a):
        calls.append((scene_, options_, *(
            x.clone() if torch.is_tensor(x) else x for x in a)))
        return PK.advance_kernel_t(scene_, options_, *a)
    _render_block_kernel(cbox64, options, 0, 0, 16, advance=keep)
    active = [int(c[10].sum()) for c in calls]     # c[10]: the act lanes
    marks = [n + 1, n / 2, n / 10, n / 100]
    for k, a in enumerate(active):
        if marks and a < marks[0]:
            while marks and a < marks[0]:
                marks.pop(0)
            err = max(err, held(cbox64, list(calls[k][2:11]), k2_at(
                cbox64, list(calls[k][2:11]), 0),
                f"G = {kernels.advance_group(n)}, cbox-64 16 spp launch {k} "
                f"({a} of {n} lanes active)"))
    res['err'] = err
    res['render_ms'] = device_ms(torch, lambda: [PK.advance_kernel_t(*c)
                                                 for c in calls], 2,
                                 'advance_kernel')
    res['render_plain_ms'] = cuda_ms(torch, lambda: [
        PK.advance_plain_t(*c) for c in calls], 1) / len(calls)
    res['render_bound'] = bound(
        sum(vertex_ops(cbox64, a) for a in active) / len(calls),
        k2_bytes(cbox64, n))
    print(f"[3] K2 at cbox-64's shape ({len(calls)} launches of {n} lanes, "
          f"{sum(active) / len(active):.0f} active on average, G = "
          f"{kernels.advance_group(n)}): kernel {res['render_ms']:.4f} ms a "
          f"launch of device time, plain {res['render_plain_ms']:.3f} ms, "
          f"bound {res['render_bound'][0]:.5f} ms "
          f"({res['render_bound'][1]}) ({smi})")
    return res


def ragged_phase(torch, np, dev, smi):
    """[4]'s last check: K1 against the per-bounce driver with K2 on the
    Cornell box at RAGGED_FILM, 1 and 4 spp, and at 64x64, 1 and 16 spp
    (see the module docstring). Returns {(film, spp): numbers}."""
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.integrators import path_megakernel as PMK
    from lajolla_tpu_torch.integrators.path import _render_block_kernel
    from lajolla_tpu_torch.scene.types import RenderOptions
    seed = (1 << 31) + 7
    res, failed = {}, []

    def route_render(scene, options, route):
        # render() with the film sent to `route` whatever its size
        engine = PMK.render_fused if route == 'K1' else _render_block_kernel
        with mock.patch.object(PMK, 'render_fused', engine), \
                mock.patch.object(PP, '_render_block_kernel', engine):
            return render(scene, options, device=dev, seed=seed)

    for film, spp in ((RAGGED_FILM, 1), (RAGGED_FILM, 4), ((64, 64), 1),
                      ((64, 64), 16)):
        w, h = film
        n = w * h
        tail = n - n % PMK.BLOCK           # the partial block's first pixel
        own = 'K1' if n > PMK.BLOCK else 'driver'     # render()'s route
        scene = PT.make_cornell_box(film).to(dev)
        options = RenderOptions(samples_per_pixel=spp)
        k1 = PMK.render_fused(scene, options, seed, 0, spp).cpu().numpy()
        drv = _render_block_kernel(scene, options, seed, 0,
                                   spp).cpu().numpy()
        k1, drv = k1 / spp, drv / spp
        if not (np.isfinite(k1).all() and np.isfinite(drv).all()):
            raise AssertionError("K1 or the driver: non-finite pixels")
        rel = (np.abs(k1 - drv) / (drv + 1e-3)).reshape(n, 3)
        off = rel.max(axis=1) > 1e-3
        r = dict(median_rel=float(np.median(rel)),
                 off_share=float(off.mean()),
                 max_abs=float(np.abs(k1 - drv).max()))
        if tail < n:
            r.update(tail_off_share=float(off[tail:].mean()),
                     tail_median_rel=float(np.median(rel[tail:])))
        before = dict(kernels.LAUNCHES)
        render(scene, options, device=dev, seed=seed)
        launched = {k: kernels.LAUNCHES[k] - before[k]
                    for k in ('render_fused', 'advance')}
        walls = {'K1': [], 'driver': []}
        for route in ('K1', 'driver', 'driver', 'K1') * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            route_render(scene, options, route)
            torch.cuda.synchronize()
            walls[route].append(1e3 * (time.perf_counter() - t0))
        traced = {route: traced_render(torch, lambda: route_render(
            scene, options, route)) for route in ('K1', 'driver')}
        r.update(route=own, launches=launched,
                 wall_ms={k: sorted(v) for k, v in walls.items()},
                 traced={k: dict(wall_ms=1e3 * t[0], busy_ms=1e3 * t[1],
                                 activities=t[2])
                         for k, t in traced.items()})
        res[film, spp] = r
        part = (f" (partial block {r['tail_median_rel']:.3g})"
                if tail < n else '')
        print(f"[4] K1 vs the per-bounce driver + K2, Cornell box {w}x{h} "
              f"x {spp} spp ({n - tail} pixels in a partial block): median "
              f"rel {r['median_rel']:.3g}{part}, pixels rel > 1e-3 "
              f"{r['off_share']:.6f}"
              + (f" (partial block {r['tail_off_share']:.6f})"
                 if tail < n else '')
              + f", max |diff| {r['max_abs']:.3g}; render() takes {own}, "
              f"launched {launched}")
        for route in ('K1', 'driver'):
            t = r['traced'][route]
            print(f"[4]   {route} route, {w}x{h} x {spp} spp: render() "
                  f"wall ms {[round(x, 3) for x in r['wall_ms'][route]]}; "
                  f"traced render() wall {t['wall_ms']:.3f} ms, device "
                  f"busy {t['busy_ms']:.3f} ms, {t['activities']} device "
                  f"activities ({smi})")
        if not (r['median_rel'] <= 1e-6 and r['off_share'] <= 0.005 and
                r.get('tail_off_share', 0.0) <= 0.005):
            failed.append(f"{w}x{h} x {spp} spp")
        if not (launched == {'render_fused': 1, 'advance': 0}
                if own == 'K1' else
                launched['render_fused'] == 0 and launched['advance'] > 0):
            failed.append(f"{w}x{h} x {spp} spp launches {launched}")
    if failed:
        raise AssertionError(f"K1 and the per-bounce driver disagree, or "
                             f"render() took another route: {failed}")
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "needs one CUDA GPU")
    import numpy as np

    from lajolla_tpu_torch import cli, kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.integrators import path_megakernel as PMK
    from lajolla_tpu_torch.integrators import volpath as PV
    from lajolla_tpu_torch.integrators import volpath_grid_kernel as PGK
    from lajolla_tpu_torch.integrators import volpath_kernel as PVK
    from lajolla_tpu_torch.integrators.path import (MAX_BOUNCES_CAP,
                                                    _render_block_kernel)
    from lajolla_tpu_torch.io.image import imread3
    from lajolla_tpu_torch.ops.intersect import (_brute_force_batched,
                                                 _occluded_batched)
    from lajolla_tpu_torch.scene import compile as PC
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    options = RenderOptions()

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1] device {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.build()
    print(f"[2] nvcc build + load {time.perf_counter() - t0:.1f} s; "
          f"{ptxas_summary(kernels.build_log())}")
    if sys.argv[1:] == ['--sweep-only']:
        sweep_phases(torch, np, dev, smi)
        return
    if sys.argv[1:] == ['--ragged-only']:
        ragged_phase(torch, np, dev, smi)
        return

    # ---- 3. K2 against plain
    k2 = k2_phase(torch, np, dev, smi)
    cbox = PT.make_cornell_box(512).to(dev)

    # ---- 4. films: kernels against the plain forms
    spp = 4
    for fixture, scene, render_k in (
            ('Cornell box 512x512', cbox, PMK.render_fused),
            ('sphere lights 256x256',
             PT.make_sphere_light_scene(256).to(dev), PMK.render_fused),
            ('per-bounce driver + K2, Cornell box 64x64',
             PT.make_cornell_box(64).to(dev), _render_block_kernel)):
        film_k = render_k(scene, options, 0, 0, spp)
        vertices = []

        def counting(scene_, options_, *a):   # a[8]: the active lanes
            vertices.append(a[8].sum())
            return PK.advance_plain_t(scene_, options_, *a)
        t0 = time.perf_counter()
        film_p = _render_block_kernel(scene, options, 0, 0, spp,
                                      advance=counting)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        img_k = film_k.cpu().numpy() / spp
        img_p = film_p.cpu().numpy() / spp
        if not (np.isfinite(img_k).all() and np.isfinite(img_p).all()):
            raise AssertionError("kernel or plain form: non-finite pixels")
        rel = np.abs(img_k - img_p) / (img_p + 1e-3)
        mean_rel = abs(img_k.mean() - img_p.mean()) / img_p.mean()
        err = float(np.abs(img_k - img_p).max())
        print(f"[4] kernel vs plain, {fixture} x {spp} spp: median rel "
              f"{np.median(rel):.3g}, mean rel {mean_rel:.3g}, pixels rel "
              f"> 1e-3 {(rel > 1e-3).mean():.4f}, max |diff| {err:.3g}")
        if not (np.median(rel) < 1e-4 and mean_rel < 0.01):
            raise AssertionError(f"kernel disagrees with its plain form on "
                                 f"{fixture}")
        if scene is cbox:
            k1_err, k1_plain_ms = err, plain_ms
            k1_plain_v = int(sum(vertices))
            k1_bound = bound(vertex_ops(scene, k1_plain_v),
                             table_bytes(scene) + 12 * 512 * 512)
    k1_ms = kernel_alone_ms(torch, kernels, lambda: PMK.render_fused(
        cbox, options, 0, 0, spp), 3)
    k1_cnt4 = {}
    PMK.render_fused(cbox, options, 0, 0, spp, counters=k1_cnt4)
    print(f"[4] K1 at 512x512 x {spp} spp (Cornell box): kernel "
          f"{k1_ms:.3f} ms, plain {k1_plain_ms:.1f} ms; vertices: the "
          f"kernel's counters {k1_cnt4['path_lanes']}, the plain form's "
          f"{k1_plain_v} ({smi})")
    if abs(k1_cnt4['path_lanes'] / k1_plain_v - 1.0) > 1e-3:
        raise AssertionError("K1's counters and its plain form count "
                             "different vertices")
    # the main path's launch: the render's 256 spp (path.KERNEL_SPP_BLOCK)
    main_spp = PP.KERNEL_SPP_BLOCK
    k1_main_ms = kernel_alone_ms(torch, kernels, lambda: PMK.render_fused(
        cbox, options, 0, 0, main_spp), 3)
    k1_events_ms = kernel_alone_ms(torch, kernels, lambda: PMK.render_fused(
        cbox, options, 0, 0, main_spp), 3, cuda_ms)
    k1_summed_ms = cuda_ms(torch, lambda: PMK.render_fused(
        cbox, options, 0, 0, main_spp), 3)
    k1_cnt = {}
    films = [PMK.render_fused(cbox, options, 0, 0, main_spp,
                              counters=k1_cnt),
             PMK.render_fused(cbox, options, 0, 0, main_spp)]
    same = bool(torch.equal(*films))
    v = k1_cnt['path_lanes']
    k1_main_bound = bound(vertex_ops(cbox, v),
                          table_bytes(cbox) + 12 * 512 * 512)
    k1_simt = simt(k1_cnt, 'iterations', 'path_lanes')
    print(f"[4] K1 at 512x512 x {main_spp} spp (Cornell box, the main "
          f"path's launch): kernel {k1_main_ms:.3f} ms (by CUDA events "
          f"around 3 calls back to back: {k1_events_ms:.3f}; "
          f"{k1_summed_ms:.3f} with its film sum), bound "
          f"{k1_main_bound[0]:.3f} ms ({k1_main_bound[1]}); counters "
          f"{k1_cnt}: {v / (512 * 512 * main_spp):.3f} vertices a path "
          f"(the plain form's at {spp} spp, scaled: "
          f"{k1_plain_v * main_spp / spp:.0f}), SIMT efficiency of the loop "
          f"{k1_simt:.4f} (plain-form proxies of the nested design "
          f"{K1_NESTED_PROXY}, of one flat loop a pixel {K1_FLAT_PROXY}); two "
          f"launches bit-equal {same} ({smi})")
    if not same:
        raise AssertionError("two K1 launches gave different films")
    if not v >= 512 * 512 * main_spp:
        raise AssertionError("K1's counters count fewer vertices than paths")
    # K1 against its plain form at the main path's launch
    vertices = []

    def counting(scene_, options_, *a):   # a[8]: the active lanes
        vertices.append(a[8].sum())
        return PK.advance_plain_t(scene_, options_, *a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_p = _render_block_kernel(cbox, options, 0, 0, main_spp,
                                  advance=counting)
    torch.cuda.synchronize()
    k1_main_plain_ms = 1e3 * (time.perf_counter() - t0)
    med, mean_rel, k1_main_err = film_agreement(
        films[0].cpu().numpy() / main_spp, film_p.cpu().numpy() / main_spp)
    k1_main_plain_v = int(sum(vertices))
    print(f"[4] K1 vs plain, Cornell box 512x512 x {main_spp} spp (the main "
          f"path's launch): median rel {med:.3g}, mean rel {mean_rel:.3g}, "
          f"max |diff| {k1_main_err:.3g}; vertices: the kernel's counters "
          f"{v}, the plain form's {k1_main_plain_v}; plain form "
          f"{k1_main_plain_ms / 1e3:.2f} s")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError(f"K1 disagrees with its plain form at "
                             f"{main_spp} spp")
    if abs(v / k1_main_plain_v - 1.0) > 1e-3:
        raise AssertionError("K1's counters and its plain form count "
                             f"different vertices at {main_spp} spp")
    # a launch whose per-item buffer passes kernels.PATH_BUFFER_BYTES runs
    # as launches of whole samples, each summed onto the film before it
    chunk_spp = main_spp // 4
    before = kernels.LAUNCHES['render_fused']
    with mock.patch.object(kernels, 'PATH_BUFFER_BYTES',
                           12 * 512 * 512 * chunk_spp):
        chunked = PMK.render_fused(cbox, options, 0, 0, main_spp)
    split = kernels.LAUNCHES['render_fused'] - before
    same = bool(torch.equal(chunked, films[0]))
    print(f"[4] K1 at 512x512 x {main_spp} spp under a buffer cap of "
          f"{chunk_spp} samples: {split} launches, film bit-equal to the one "
          f"launch's {same}")
    if not (same and split == main_spp // chunk_spp):
        raise AssertionError("K1's chunked launches differ from its one "
                             "launch")
    # the tallest table the mesh variant gives K1 against the plain form
    spp = 4
    tall = PT.make_cornell_box(128, variant='mesh',
                               triangles=TALL_TRIANGLES).to(dev)
    film_p = _render_block_kernel(tall, options, 0, 0, spp,
                                  advance=PK.advance_plain_t)
    img_p = film_p.cpu().numpy() / spp
    img_k = PMK.render_fused(tall, options, 0, 0, spp).cpu().numpy() / spp
    med, mean_rel, err = film_agreement(img_k, img_p)
    print(f"[4] K1 vs plain, mesh Cornell box at {tall.fp_woop.shape[0]} "
          f"cast prims 128x128 x {spp} spp: median rel {med:.3g}, mean rel "
          f"{mean_rel:.3g}, max |diff| {err:.3g}")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("K1 disagrees with its plain form on a tall "
                             "table")
    ragged_phase(torch, np, dev, smi)

    # ---- 5. analytic white box through K1
    before = kernels.LAUNCHES['render_fused']
    img = render(PT.make_white_box_scene(res=128),
                 RenderOptions(samples_per_pixel=64), device=dev)
    print(f"[5] white box 128x128 x 64 spp: mean {img.mean():.5f} "
          f"(analytic 3.0)")
    if kernels.LAUNCHES['render_fused'] == before:
        raise AssertionError("the white box did not run K1")
    if not abs(img.mean() - 3.0) / 3.0 < 0.03:
        raise AssertionError("white box mean off the analytic value")

    # ---- 6. the main path through the CLI
    def luminance_of(path, lo, hi):
        im = imread3(path)
        lum = float((im @ np.array([0.212671, 0.715160, 0.072169])).mean())
        print(f"[6] {os.path.basename(path)} {im.shape} mean luminance "
              f"{lum:.5f}")
        if not (np.isfinite(im).all() and lo < lum < hi):
            raise AssertionError(f"{path}: bad image")

    def render_alone(xml):
        """render() of a parsed scene, warm, in seconds (one render first,
        for every scene: a kernel's first launch pays for its module
        load)."""
        scene, opt = parse_scene(xml, dev)
        render(scene, opt, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, opt, device=dev)
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        runs = [  # (xml, exr, (w, h, spp) to time or None, luminance)
            (PT.write_cornell_box_xml(os.path.join(tmp, 'big'), 512, 256),
             'cbox512.exr', (512, 512, 256), (0.05, 5.0)),
            (PT.write_cornell_box_xml(os.path.join(tmp, 'small'), 64, 16),
             'cbox64.exr', None, (0.05, 5.0)),
            (PT.write_cornell_box_xml(os.path.join(tmp, 'glass'), 512, 16,
                                      variant='glass'),
             'glass512.exr', (512, 512, 16), (0.05, 5.0)),
            (PT.write_cornell_box_xml(os.path.join(tmp, 'vol'), 512, 256,
                                      variant='vol'),
             'vol512.exr', (512, 512, 256), (0.005, 0.5)),
            (PT.write_cornell_box_xml(os.path.join(tmp, 'hetvol'),
                                      (768, 576), 32, variant='hetvol'),
             'hetvol768.exr', (768, 576, 32), (0.02, 2.0))]
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        cli_s = []
        for xml, exr, _, _ in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main([xml, '-o', os.path.join(tmp, exr),
                         '--device', 'cuda']) != 0:
                raise AssertionError("CLI failed")
            cli_s.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        print(f"[6] main-path launches {launches}")
        for k, v in launches.items():
            # the cluster sweeps are on the main path of phase 15
            if v < 1 and not k.startswith('sweep_'):
                raise AssertionError(f"the main path never launched {k}")
        for _, exr, _, (lo, hi) in runs:
            luminance_of(os.path.join(tmp, exr), lo, hi)
        for (xml, exr, size, _), cs in zip(runs, cli_s):
            if size:
                paths = size[0] * size[1] * size[2]
                rs = render_alone(xml)
                print(f"[6] {exr[:-4]} {size[0]}x{size[1]} x {size[2]} spp:"
                      f" {paths / cs / 1e6:.2f} Mpaths/s over the whole CLI "
                      f"run ({cs:.3f} s), {paths / rs / 1e6:.2f} Mpaths/s "
                      f"render() alone ({rs:.3f} s); {smi}")

    # ---- 7. K3 against its plain forms
    k3 = {}
    for fixture, scene in (
            ('glass cbox', PT.make_cornell_box(512, variant='glass')),
            ('sphere lights', PT.make_sphere_light_scene(512))):
        scene = scene.to(dev)
        rays = PT.general_rays(scene, seed=13)
        for kind, ray in rays.items():
            t, prim, u, v = kernels.intersect_brute(scene, *ray)
            pt, pprim, pu, pv = _brute_force_batched(scene, *ray)
            occ = kernels.occluded_brute(scene, *ray)
            pocc = _occluded_batched(scene, *ray)
            same = prim == pprim
            hit = same & (pprim >= 0)
            err = max(float((a[hit] - b[hit]).abs().max())
                      for a, b in ((t, pt), (u, pu), (v, pv)))
            close = all(torch.allclose(a[hit], b[hit], rtol=1e-5, atol=1e-6)
                        for a, b in ((t, pt), (u, pu), (v, pv)))
            prim_share = float(same.float().mean())
            occ_share = float((occ == pocc).float().mean())
            # rays on which K3 differs at all: prim or t anywhere, u or v
            # on a hit, occlusion
            differ = ~same | (t != pt) | (hit & ((u != pu) | (v != pv)))
            print(f"[7] K3 vs plain, {fixture}, {kind} rays "
                  f"({ray[0].shape[0]}): prim agree {prim_share:.6f} "
                  f"(hits {float((pprim >= 0).float().mean()):.3f}), max "
                  f"|t,u,v diff| {err:.3g}; any-hit agree {occ_share:.6f} "
                  f"(occluded {float(pocc.float().mean()):.3f}); rays that "
                  f"differ at all: closest hit {int(differ.sum())}, any hit "
                  f"{int((occ != pocc).sum())}")
            if not (prim_share >= 0.999 and occ_share >= 0.999 and close
                    and torch.isinf(t[pprim < 0]).all()):
                raise AssertionError(f"K3 disagrees with its plain forms on "
                                     f"{fixture} {kind} rays")
            k3['closest_err'] = max(k3.get('closest_err', 0.0), err)
            k3['occ_err'] = max(k3.get('occ_err', 0.0),
                                float((occ != pocc).float().max()))
        if fixture == 'glass cbox':
            bounce, shadow = rays['bounce'], rays['shadow']
            nb, tc = bounce[0].shape[0], scene.fp_woop.shape[0]
            ns, t_occ = shadow[0].shape[0], scene.fp_woop_occ.shape[0]
            # rays in (o, d, tnear, tfar: 8 fp32), hits out (t, prim, u,
            # v: 4 x 4 B) or bits out (1 B), the cast tables (12 fp32 and
            # a quad flag per prim, and 2 ids per closest-hit prim)
            k3['bound'] = bound(nb * tc * OPS['closest_test'],
                                nb * (32 + 16) + tc * (52 + 8))
            occluded = int(_occluded_batched(scene, *shadow).sum())
            # an occluded ray's scan ends at its first occluder: counted
            # at one test, the least it can take
            k3['occ_bound'] = bound(
                ((ns - occluded) * t_occ + occluded) * OPS['any_test'],
                ns * (32 + 1) + t_occ * 52)
            # glass-512's shape: its engine casts one lane a pixel
            for key, fn, plain_fn, kname, ray in (
                    ('', kernels.intersect_brute, _brute_force_batched,
                     'intersect_brute_kernel', bounce),
                    ('occ_', kernels.occluded_brute, _occluded_batched,
                     'occluded_brute_kernel', shadow)):
                k3[key + 'ms'] = device_ms(torch, lambda: fn(scene, *ray),
                                           20, kname)
                k3[key + 'issue_ms'] = cuda_ms(torch,
                                               lambda: fn(scene, *ray), 20)
                k3[key + 'plain_ms'] = cuda_ms(
                    torch, lambda: plain_fn(scene, *ray), 5)
            print(f"[7] K3 at 2^18 rays (glass cbox, glass-512's shape), "
                  f"device time: closest hit, bounce rays: kernel "
                  f"{k3['ms']:.5f} ms (CUDA events, the host's issue rate: "
                  f"{k3['issue_ms']:.4f} ms), plain {k3['plain_ms']:.4f} "
                  f"ms, bound {k3['bound'][0]:.5f} ms ({k3['bound'][1]}); "
                  f"any hit, shadow rays: kernel {k3['occ_ms']:.5f} ms "
                  f"(CUDA events {k3['occ_issue_ms']:.4f} ms), plain "
                  f"{k3['occ_plain_ms']:.4f} ms, bound "
                  f"{k3['occ_bound'][0]:.5f} ms ({k3['occ_bound'][1]}) "
                  f"({smi})")

    # ---- 8. the general engine with K3 against it with the plain casts
    glass = PT.make_cornell_box(128, variant='glass').to(dev)
    spp = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_k, _, iters = PP._render_block_sc(glass, options, 0, 0, spp)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    with mock.patch.multiple(kernels, intersect_brute=_brute_force_batched,
                             occluded_brute=_occluded_batched):
        film_p, _, _ = PP._render_block_sc(glass, options, 0, 0, spp)
    img_k = film_k.cpu().numpy() / spp
    img_p = film_p.cpu().numpy() / spp
    rel = np.abs(img_k - img_p) / (img_p + 1e-3)
    mean_rel = abs(img_k.mean() - img_p.mean()) / img_p.mean()
    print(f"[8] general engine, K3 vs plain casts, glass cbox 128x128 x "
          f"{spp} spp: median rel {np.median(rel):.3g}, mean rel "
          f"{mean_rel:.3g}, pixels rel > 1e-3 {(rel > 1e-3).mean():.4f}; "
          f"{iters} iterations in {engine_s:.3f} s")
    if not (np.isfinite(img_k).all() and np.median(rel) < 1e-4 and
            mean_rel < 0.01):
        raise AssertionError("the general engine with K3 disagrees with it "
                             "with the plain casts")

    # ---- 9. the furnace through the general engine
    albedo = 0.6
    img = render(PT.make_furnace_scene(albedo, res=64),
                 RenderOptions(samples_per_pixel=64), device=dev)
    sphere = img[PT.furnace_sphere_mask(64)]
    print(f"[9] furnace 64x64 x 64 spp: sphere mean {sphere.mean():.5f} "
          f"(albedo x env {albedo}), min {sphere.min():.4f}, max "
          f"{sphere.max():.4f}")
    if not (np.isfinite(img).all() and
            abs(sphere.mean() - albedo) / albedo < 0.03):
        raise AssertionError("furnace sphere off albedo x env")

    # ---- 10. K8 against its plain form
    vol_opts = RenderOptions(integrator='volpath')
    vol512 = PT.make_cornell_box(512, variant='vol').to(dev)
    # the main path's last K8 launch on vol-512 (256 spp of [6] in launches
    # of volpath.VOLK_SPP_BLOCK samples): its items, through the counter,
    # the buffer and the film sum, against the plain form
    main_s0 = 256 - PV.VOLK_SPP_BLOCK
    for fixture, scene, s0, spp, statistical in (
            ('vol 512x512', vol512, 0, 4, False),
            ('vol_hg 256x256', PT.make_cornell_box(
                256, variant='vol_hg').to(dev), 0, 32, True),
            ('submerged sphere lights 256x256', PC.compile_scene(
                PT.submerged_sphere_builder(256)).to(dev), 0, 32, True),
            (f'vol 512x512 from sample {main_s0}', vol512, main_s0,
             PV.VOLK_SPP_BLOCK, False)):
        img_k = PVK.render_fused_vol(scene, vol_opts, 0, s0, spp).cpu() \
            .numpy() / spp
        vertices = []
        real_core = PVK._advance_vol_core

        def counting(scene_, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                     act_in, *a, **k):
            vertices.append(act_in.sum())
            return real_core(scene_, o, d, thr, rad, bounces, dir_pdf, mtp,
                             nee_p, act_in, *a, **k)
        t0 = time.perf_counter()
        with mock.patch.object(PVK, '_advance_vol_core', counting):
            img_p = PVK.render_fused_vol_plain(scene, vol_opts, 0, s0, spp) \
                .cpu().numpy() / spp
        plain_s = time.perf_counter() - t0
        med, mean_rel, err = film_agreement(img_k, img_p)
        d8 = block_rms(img_k, img_p)
        print(f"[10] K8 vs plain, {fixture} x {spp} spp: median rel "
              f"{med:.3g}, mean rel {mean_rel:.3g}, 8x8-block RMS {d8:.3g}, "
              f"max |diff| {err:.3g}; means {img_k.mean():.6f} "
              f"{img_p.mean():.6f}; plain form {plain_s:.2f} s")
        if not (med < 1e-4 and mean_rel < 0.01 and
                (d8 < 0.12 or not statistical)):
            raise AssertionError(f"K8 disagrees with its plain form on "
                                 f"{fixture}")
        if scene is vol512 and s0 == 0:
            k8_err = err
            v = int(sum(vertices))
            k8_bound = bound(vertex_ops(scene, v) + v * OPS['vol_flight'],
                             table_bytes(scene) + 12 * 512 * 512)
    again = [PVK.render_fused_vol(vol512, vol_opts, 0, 0, 4)
             for _ in range(2)]
    same = bool(torch.equal(*again))
    print(f"[10] K8 twice, vol 512x512 x 4 spp: films bit-equal {same}")
    if not same:
        raise AssertionError("two K8 launches gave different films")
    k8_ms = kernel_alone_ms(torch, kernels, lambda: PVK.render_fused_vol(
        vol512, vol_opts, 0, 0, 4), 10)
    k8_plain_ms = cuda_ms(torch, lambda: PVK.render_fused_vol_plain(
        vol512, vol_opts, 0, 0, 4), 1)
    print(f"[10] K8 at 512x512 x 4 spp (vol): kernel {k8_ms:.3f} ms, plain "
          f"{k8_plain_ms:.1f} ms ({smi})")
    # the main path's launch: 64 spp (volpath.VOLK_SPP_BLOCK)
    spp = PV.VOLK_SPP_BLOCK
    k8_main_ms = kernel_alone_ms(torch, kernels, lambda: PVK.render_fused_vol(
        vol512, vol_opts, 0, 0, spp), 5)
    k8_cnt = {}
    PVK.render_fused_vol(vol512, vol_opts, 0, 0, spp, counters=k8_cnt)
    v = k8_cnt['path_lanes']
    k8_main_bound = bound(vertex_ops(vol512, v) + v * OPS['vol_flight'],
                          table_bytes(vol512) + 12 * 512 * 512 * spp)
    k8_simt = simt(k8_cnt, 'iterations', 'path_lanes')
    print(f"[10] K8 at 512x512 x {spp} spp (vol): kernel {k8_main_ms:.3f} ms,"
          f" bound {k8_main_bound[0]:.3f} ms ({k8_main_bound[1]}); counters "
          f"{k8_cnt}: {v / (512 * 512 * spp):.3f} vertices a path, SIMT "
          f"efficiency of the loop {k8_simt:.4f} (plain-form proxy, per-lane "
          f"totals, {K8_LOCKSTEP_PROXY}), "
          f"{k8_cnt['fetched_lanes'] / max(k8_cnt['fetches'], 1):.2f} lanes "
          f"a fetch ({smi})")
    if not v >= 512 * 512 * spp:
        raise AssertionError("K8's counters count fewer vertices than paths")
    n_main = 512 * 512
    film_sum_agrees(torch, kernels, PVK.film_sum_plain, dev,
                    ((n_main, n_main, spp), (768 * 576, 768 * 576, 32),
                     (100000, 102400, 4), (n_main, n_main, 256)))
    buf = torch.rand((spp * n_main, 3), device=dev)
    fs_ms = cuda_ms(torch, lambda: kernels.film_sum(buf, n_main, n_main,
                                                    spp), 20)
    fs_plain_ms = cuda_ms(torch, lambda: PVK.film_sum_plain(
        buf, n_main, n_main, spp), 3)
    fs_bound = bound(0, 12 * n_main * spp + 12 * n_main)
    print(f"[10] film_sum_kernel at 512x512 x {spp} spp: kernel "
          f"{fs_ms:.4f} ms, plain {fs_plain_ms:.3f} ms, bound "
          f"{fs_bound[0]:.4f} ms ({fs_bound[1]}) ({smi})")

    # ---- 11. the general volumetric engine on the card
    spp = 4
    vol128 = PT.make_cornell_box(128, variant='vol').to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_g, _, iters = PV._render_volpath_block(vol128, vol_opts, 0, 0, spp)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    img_k = PVK.render_fused_vol(vol128, vol_opts, 0, 0, spp).cpu().numpy()
    med, mean_rel, _ = film_agreement(img_k / spp, film_g.cpu().numpy()
                                      .reshape(128, 128, 3) / spp)
    print(f"[11] general engine vs K8, vol 128x128 x {spp} spp: median rel "
          f"{med:.3g}, mean rel {mean_rel:.3g}; engine {iters} iterations "
          f"in {engine_s:.3f} s")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("the general volumetric engine disagrees with "
                             "K8")
    vol_glass = PT.make_cornell_box(128, variant='vol_glass').to(dev)
    if PV._use_vol_kernel(vol_glass):
        raise AssertionError("vol_glass is inside K8's class")
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_k, _, iters = PV._render_volpath_block(vol_glass, vol_opts, 0, 0,
                                                spp)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if not (ran['intersect_brute'] > 0 and ran['render_fused_vol'] == 0):
        raise AssertionError(f"vol_glass launched {ran}: expected K3 and "
                             "no K8")
    with mock.patch.multiple(kernels, intersect_brute=_brute_force_batched,
                             occluded_brute=_occluded_batched):
        film_p, _, _ = PV._render_volpath_block(vol_glass, vol_opts, 0, 0,
                                                spp)
    med, mean_rel, _ = film_agreement(film_k.cpu().numpy() / spp,
                                      film_p.cpu().numpy() / spp)
    print(f"[11] general engine, K3 vs plain casts, vol_glass 128x128 x "
          f"{spp} spp: median rel {med:.3g}, mean rel {mean_rel:.3g}; "
          f"{iters} iterations in {engine_s:.3f} s; launches {ran}")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("the general volumetric engine with K3 "
                             "disagrees with it with the plain casts")

    # ---- 12. K9 against its plain form
    for fixture in ('hetvol', 'hetvol_hg'):
        scene = PT.make_cornell_box(128, 2, fixture).to(dev)
        spp = 2
        img_k = PGK.render_fused_grid(scene, vol_opts, 0, 0, spp).cpu() \
            .numpy() / spp
        t0 = time.perf_counter()
        img_p = PGK.render_fused_grid_plain(scene, vol_opts, 0, 0, spp) \
            .cpu().numpy() / spp
        plain_s = time.perf_counter() - t0
        med, mean_rel, err = film_agreement(img_k, img_p)
        print(f"[12] K9 vs plain, {fixture} 128x128 x {spp} spp: median rel "
              f"{med:.3g}, mean rel {mean_rel:.3g}, max |diff| {err:.3g}; "
              f"means {img_k.mean():.6f} {img_p.mean():.6f}; plain form "
              f"{plain_s:.2f} s")
        if not (med < 1e-4 and mean_rel < 0.01):
            raise AssertionError(f"K9 disagrees with its plain form on "
                                 f"{fixture}")
    # the main path's film: 768x576 = 216 whole 2048-lane blocks
    het768 = PT.make_cornell_box((768, 576), 1, 'hetvol').to(dev)
    k9_ms4 = kernel_alone_ms(torch, kernels, lambda: PGK.render_fused_grid(
        het768, vol_opts, 0, 0, 4), 3)
    k9_ms = kernel_alone_ms(torch, kernels, lambda: PGK.render_fused_grid(
        het768, vol_opts, 0, 0, 1), 5)
    img_k = PGK.render_fused_grid(het768, vol_opts, 0, 0, 1).cpu().numpy()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_p = PGK.render_fused_grid_plain(het768, vol_opts, 0, 0, 1,
                                        stats=stats).cpu().numpy()
    k9_plain_ms = 1e3 * (time.perf_counter() - t0)
    med, mean_rel, k9_err = film_agreement(img_k, img_p)
    print(f"[12] K9 vs plain, hetvol 768x576 x 1 spp: median rel {med:.3g}, "
          f"mean rel {mean_rel:.3g}, max |diff| {k9_err:.3g}; means "
          f"{img_k.mean():.6f} {img_p.mean():.6f}")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("K9 disagrees with its plain form on hetvol "
                             "768x576")
    n9 = 768 * 576
    grid_bytes = het768.fp_grid.numel() * 4 + het768.svox_data.shape[0] * 8

    def k9_work_bound(work, spp):
        return bound(
            work['casts'] * (het768.fp_woop.shape[0] * OPS['closest_test'] +
                             het768.meta.num_spheres * OPS['sphere_test']) +
            work['track_steps'] * OPS['track_step'] +
            work['vertices'] * OPS['vertex'],
            table_bytes(het768) + grid_bytes + 12 * n9 * spp)
    k9_bound = k9_work_bound(stats, 1)
    print(f"[12] K9 at 768x576 (hetvol, 128x128x50 grid): kernel "
          f"{k9_ms:.3f} ms at 1 spp, {k9_ms4:.3f} ms at 4 spp; plain form "
          f"{k9_plain_ms:.1f} ms at 1 spp; per path (plain form's counts) "
          f"{stats['vertices'] / n9:.3f} vertices, {stats['casts'] / n9:.3f}"
          f" casts, {stats['track_steps'] / n9:.3f} tracking steps; bound "
          f"{k9_bound[0]:.3f} ms ({k9_bound[1]}) ({smi})")
    # the last samples of the main path's launch (32 spp from 0): items
    # s0*n_q .. 32*n_q - 1, through the counter, the padded buffer and the
    # film sum, against the plain form
    s0, spp = 28, 4
    img_k = PGK.render_fused_grid(het768, vol_opts, 0, s0, spp).cpu().numpy()
    t0 = time.perf_counter()
    img_p = PGK.render_fused_grid_plain(het768, vol_opts, 0, s0, spp) \
        .cpu().numpy()
    plain_s = time.perf_counter() - t0
    med, mean_rel, err = film_agreement(img_k / spp, img_p / spp)
    print(f"[12] K9 vs plain, hetvol 768x576 x {spp} spp from sample {s0}: "
          f"median rel {med:.3g}, mean rel {mean_rel:.3g}, max |diff| "
          f"{err:.3g}; means {img_k.mean() / spp:.6f} "
          f"{img_p.mean() / spp:.6f}; pixels bit-equal "
          f"{float((img_k == img_p).all(-1).mean()):.6f}; plain form "
          f"{plain_s:.2f} s")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError(f"K9 disagrees with its plain form on hetvol "
                             f"768x576 from sample {s0}")
    again = [PGK.render_fused_grid(het768, vol_opts, 0, 0, 1)
             for _ in range(2)]
    same = bool(torch.equal(*again))
    print(f"[12] K9 twice, hetvol 768x576 x 1 spp: films bit-equal {same}")
    if not same:
        raise AssertionError("two K9 launches gave different films")
    # the main path's launch: the whole film's 32 spp in one
    spp = 32
    k9_main_ms = kernel_alone_ms(torch, kernels, lambda: PGK.render_fused_grid(
        het768, vol_opts, 0, 0, spp), 3)
    k9_cnt = {}
    PGK.render_fused_grid(het768, vol_opts, 0, 0, spp, counters=k9_cnt)
    k9_main_bound = k9_work_bound(k9_cnt, spp)
    k9_simt = {stage: simt(k9_cnt, passes, lanes) for stage, passes, lanes in (
        ('loop', 'iterations', 'path_lanes'),
        ('casts', 'cast_passes', 'casts'),
        ('track_steps', 'track_passes', 'track_steps'),
        ('vertices', 'vertex_passes', 'vertices'))}
    paths = n9 * spp
    print(f"[12] K9 at 768x576 x {spp} spp (hetvol): kernel "
          f"{k9_main_ms:.3f} ms, bound "
          f"{k9_main_bound[0]:.3f} ms ({k9_main_bound[1]}); counters {k9_cnt};"
          f" per path {k9_cnt['vertices'] / paths:.3f} vertices, "
          f"{k9_cnt['casts'] / paths:.3f} casts, "
          f"{k9_cnt['track_steps'] / paths:.3f} tracking steps; SIMT "
          f"efficiency by stage {k9_simt} (plain-form proxy of the tracking "
          f"steps, per-lane totals, {K9_LOCKSTEP_PROXY}) ({smi})")
    if not k9_cnt['vertices'] >= paths:
        raise AssertionError("K9's counters count fewer vertices than paths")

    # ---- 13. the general event machine on the card
    spp = 2
    het64 = PT.make_cornell_box(64, spp, 'hetvol').to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_g, _, iters = PV._render_volpath_block(het64, vol_opts, 0, 0, spp)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    img_k = PGK.render_fused_grid(het64, vol_opts, 0, 0, spp).cpu().numpy()
    med, mean_rel, _ = film_agreement(img_k / spp, film_g.cpu().numpy()
                                      .reshape(64, 64, 3) / spp)
    print(f"[13] event machine vs K9, hetvol 64x64 x {spp} spp: median rel "
          f"{med:.3g}, mean rel {mean_rel:.3g}; engine {iters} iterations "
          f"in {engine_s:.3f} s")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("the event machine disagrees with K9")
    smooth = PT.make_cornell_box(64, spp, 'hetvol_smooth').to(dev)
    if PV._use_grid_kernel(smooth):
        raise AssertionError("hetvol_smooth is inside K9's class")
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film_k, _, iters = PV._render_volpath_block(smooth, vol_opts, 0, 0, spp)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if not (ran['intersect_brute'] > 0 and ran['render_fused_grid'] == 0):
        raise AssertionError(f"hetvol_smooth launched {ran}: expected K3 "
                             "and no K9")
    with mock.patch.multiple(kernels, intersect_brute=_brute_force_batched,
                             occluded_brute=_occluded_batched):
        film_p, _, _ = PV._render_volpath_block(smooth, vol_opts, 0, 0, spp)
    med, mean_rel, _ = film_agreement(film_k.cpu().numpy() / spp,
                                      film_p.cpu().numpy() / spp)
    print(f"[13] event machine, K3 vs plain casts, hetvol_smooth 64x64 x "
          f"{spp} spp: median rel {med:.3g}, mean rel {mean_rel:.3g}; "
          f"{iters} iterations in {engine_s:.3f} s; launches {ran}")
    if not (med < 1e-4 and mean_rel < 0.01):
        raise AssertionError("the event machine with K3 disagrees with it "
                             "with the plain casts")

    sweep_lines = sweep_phases(torch, np, dev, smi)
    aux_launches = aux_phase(torch, np, dev, smi)
    disney_launches = disney_phase(torch, np, dev, smi)
    vol12_launches = vol12_phase(torch, np, dev, smi)
    diff_launches = grad_phase(torch, np, dev, smi)
    sharded_launches = sharded_phase(torch, np, dev, smi)
    for entry in sweep_lines:
        name_ = entry['name'][:-len('_kernel')]
        entry['aux_launches'] = aux_launches[name_]
        entry['sharded_launches'] = sharded_launches[name_]

    def line(name, source, replaces, launched, err, ms, plain_ms, bnd,
             **more):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "sharded_launches": sharded_launches[
                    name[:-len('_kernel')]], **more}

    print(json.dumps({"kernels": [
        line("render_fused_kernel", KERNEL_SOURCE,
             "lajolla_tpu/integrators/path_megakernel.py:105",
             launches['render_fused'], k1_err, k1_ms, k1_plain_ms, k1_bound,
             render_spp=main_spp, render_ms=k1_main_ms,
             render_plain_ms=k1_main_plain_ms,
             render_max_abs_err=k1_main_err,
             render_bound_ms=k1_main_bound[0],
             render_bound_by=k1_main_bound[1], simt_efficiency=k1_simt),
        line("advance_kernel", KERNEL_SOURCE,
             "lajolla_tpu/integrators/path_kernel.py:895",
             launches['advance'], k2['err'], k2['ms'], k2['plain_ms'],
             k2['bound'], host_issue_ms=k2['issue_ms'],
             render_ms=k2['render_ms'],
             render_plain_ms=k2['render_plain_ms'],
             render_bound_ms=k2['render_bound'][0],
             render_bound_by=k2['render_bound'][1]),
        line("intersect_brute_kernel", K3_SOURCE, K3_REPLACES,
             launches['intersect_brute'], k3['closest_err'], k3['ms'],
             k3['plain_ms'], k3['bound'], host_issue_ms=k3['issue_ms'],
             render_ms=k3['ms'], render_plain_ms=k3['plain_ms'],
             render_bound_ms=k3['bound'][0],
             render_bound_by=k3['bound'][1],
             aux_launches=aux_launches['intersect_brute'],
             disney_512_launches=disney_launches['intersect_brute'],
             vol12_512_launches=vol12_launches['intersect_brute'],
             diff_256_launches=diff_launches['intersect_brute']),
        line("occluded_brute_kernel", K3_SOURCE, K3_REPLACES,
             launches['occluded_brute'], k3['occ_err'], k3['occ_ms'],
             k3['occ_plain_ms'], k3['occ_bound'],
             host_issue_ms=k3['occ_issue_ms'], render_ms=k3['occ_ms'],
             render_plain_ms=k3['occ_plain_ms'],
             render_bound_ms=k3['occ_bound'][0],
             render_bound_by=k3['occ_bound'][1],
             aux_launches=aux_launches['occluded_brute'],
             disney_512_launches=disney_launches['occluded_brute'],
             vol12_512_launches=vol12_launches['occluded_brute'],
             diff_256_launches=diff_launches['occluded_brute']),
        line("render_fused_vol_kernel", K8_SOURCE, K8_REPLACES,
             launches['render_fused_vol'], k8_err, k8_ms, k8_plain_ms,
             k8_bound, render_spp=PV.VOLK_SPP_BLOCK, render_ms=k8_main_ms,
             render_bound_ms=k8_main_bound[0],
             render_bound_by=k8_main_bound[1], simt_efficiency=k8_simt),
        line("render_fused_grid_kernel", K9_SOURCE, K9_REPLACES,
             launches['render_fused_grid'], k9_err, k9_ms, k9_plain_ms,
             k9_bound, render_spp=32, render_ms=k9_main_ms,
             render_bound_ms=k9_main_bound[0],
             render_bound_by=k9_main_bound[1], simt_efficiency=k9_simt),
        line("film_sum_kernel", K8_SOURCE, FILM_SUM_REPLACES,
             launches['film_sum'], 0.0, fs_ms, fs_plain_ms, fs_bound)]
        + sweep_lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
