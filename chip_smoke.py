#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--mesh-only | --estimator-only | --floors-only | --widths-only
                           | --naive-only
                           | --preview-bench [DIR] | --path-bench [DIR] | --spp-bench [DIR]
                           | --options-bench [DIR [SETTING ...]] | --sass-counts [DIR]
                           | --widths-bench [DIR] | --naive-bench [DIR [march]]
                           | --tap-bench [DIR]]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA; ``--mesh-only`` runs phases 1-3 and 19 alone (say,
on a machine with several cards, where phase 19 adds meshes over them);
``--estimator-only`` runs phases 1-4 and 8e alone, ``--floors-only`` phases
1-4 and 8f, ``--widths-only`` phases 1-3 and 8g (with a JSON line of its
rows), ``--naive-only`` phases 1-3 and 8d (the same);
``--preview-bench [DIR]`` prints the preview's end-to-end numbers (frame
times and kernels per frame on both atlases, input to preview) for the port
package in DIR (default this checkout), so that two versions of the port can
be alternated in one call; ``--path-bench [DIR]`` does the same for the path
tracer (s/spp of the three scenes at 1920x1080 with kernels per spp, the
busy share and the bounce kernels' device time; the meshes' s/spp; the
preview frame and input to preview; the ms of each bounce of an Apollo spp;
the bounce entries' registers and spills, the tracker and march launchers,
per scene the entries' bit-equality with their twin, the census's cycle
split and the trackers' SIMT efficiency; ``compact_lanes`` and
``gen_rays`` per call and on the device; the tier-2 atlas's build split
and ``upsample`` per plane; the threefry launcher and its SASS; every
entry's registers and spills; ``rmo_ratio_track`` at one and four
wavelengths and the reference estimator's census at bounces 0 and
DEEP_BOUNCE with its tracking lanes per warp); ``--spp-bench [DIR]``
the three scenes' s/spp and the bounce kernels' device ms of 3 profiled
spp each, at the default config and at the reference's estimator;
``--options-bench [DIR [SETTING ...]]`` the settings of phases 8c, 8d, 8e
and 8f that DIR's package takes, or those named (bounce 0's two kernels of
the knob instances, s/spp against the setting's base; the naive flags with an
estimator option or a march floor, and the default config against itself) and
``--sass-counts [DIR]`` the bounce entries' SASS sizes and the options
sources' ptxas report, and ``--widths-bench [DIR]`` the hero-packet widths
(the width libraries' build and ptxas report, ``gen_rays`` at L = 1, 2, 4,
6, 16 and its SASS sizes, bounce 0's two kernels and s/spp against L = 4
at each width), and ``--naive-bench [DIR]`` the naive launchers
(``naive_march``, ``naive_delta_track``, ``naive_ratio_track``) per call and
on the device on the three scenes' naive_tracking arguments and the march's
at naive_march, at bounces 0 and DEEP_BOUNCE (captured afresh from the twin's
bounce on every run; each call held bit-equal to its twin with its steps;
the march's block rounds replayed and, where the package has it, the census
of its steps) and the census of bounce 0 under naive_cloud_tracking (each
site's warp cycles, the NEE cloud pass's iterations), naive_march and
naive_shadow (the march sites' steps and SIMT), for the package in DIR, and
``--tap-bench [DIR]`` the texture taps (``check_texture``'s rows, timed on the
device), the census's split of bounce 0 with the shade's surface branch on
the three scenes, their s/spp at the default and at bilinear_tracking,
frame_end and the preview frame, for the package in DIR. It imports
nothing of JAX or of the JAX package ``digital_earth_tpu`` (checked at the
end). Phases, each of which raises on failure (exit code 1):

1. toolchain: torch, CUDA, nvcc, Triton versions and the card
   (``nvidia-smi --query-gpu=name,power.limit``);
2. builds the kernels of ``digital_earth_tpu_torch/csrc`` with nvcc for
   sm_90a (timed), and prints ptxas's registers and spills of the bounce
   entries, ``compact_lanes``, ``preview``, ``atmos_march`` and
   ``select_tiles``;
3. reads the SASS of one threefry block from the built library
   (``cuobjdump``: the depth-2 fold launcher less the depth-1, by opcode
   and by pipe) and of one draw (the two-word sum launcher less the
   one-word); it fails if either pair is missing, and every bound below
   takes threefry's integer work from this census; holds the threefry
   header (a fold and 12 draws, the fold at depths 1 and 2, draws at
   counters past 2^31 and 2^32, the sums) bit for bit against ops/rng.py
   on edge keys, data and counters, and times the launcher at the frame's
   shape per call and on the device (a CUDA graph of 20 calls);
4. renders one spp of the main path's frame (Apollo 11, 1920x1080, default
   ``TraceConfig()``) through the kernels with one launch per bounce,
   keeping the bounce's full input state and live list at every bounce and
   the alive vectors the deepest bounce's compaction saw; then runs the
   bounce's plain twin on the card on the states of bounces 0 and
   DEEP_BOUNCE (its loops launch the tracker kernels) and keeps, per
   tracker call kind, the arguments of the call with the most active lanes,
   and bounce 0's table-lookup arguments;
5. checks the port against the committed 32x18 golden render on the card,
   through the kernel path;
6. the main path: ``render_offline`` of "scenes/config - Apollo 11.txt" at
   1920x1080, default ``TraceConfig()``, procedural 1024x2048 atlas, 1
   warm-up + 2 timed spp: ``bounce_flight`` and ``bounce_shade`` (the wide
   bounces) and ``bounce_window`` launch, ``compact_lanes`` once per bounce
   launch, ``land_march``,
   ``rmo_delta_track`` and ``cloud_track`` never (their loops run inside the
   bounce entries), every other path kernel at least once, the pixel map
   taken from ``gen_rays`` (never recomputed), a finite buffer of positive
   mean;
7. holds each tracker kernel against its plain twin on the arguments kept
   in phase 4, lane by lane, and times both; counts the trackers'
   iterations on those arguments (the twin's count) for their operations
   bound;
8. ``bounce_flight`` + ``bounce_shade`` against their plain twin on the
   states of bounces 0 and DEEP_BOUNCE (outcome and values lane by lane,
   gates below, and every lane bit-equal), the pair and each half timed,
   the entries' registers, spills and resident warps; the census (the
   census instances of ``bounce_flight``
   and ``bounce_shade`` leave the timed instances' state, and their trip
   counts at the seven loop sites equal those of the twin's plain loops on
   all but 1e-4 of the lanes); the per-bounce table of the frame (live
   lanes, ms, ns per lane, the bound from bytes and from the census's
   operations, mean trips and SIMT efficiency per loop site, the land
   march's SIMT under its design and the trackers'); florida and sunset
   hurricane at bounces 0 and DEEP_BOUNCE: the entries bit-equal to their
   twin, the census's cycle split and SIMT efficiency;
   ``bounce_window`` against ``run_window_plain`` from the bounce at which
   the frame enters the window (``bounce_schedule`` at
   ``kernels.window_threshold``), and the window started a few bounces
   earlier and later (the crossover); the Draine sampler step by step
   bit-equal to its twin (ROADMAP C #2); ``compact_lanes`` bit-equal to its
   twin on the alive vectors of bounces 0, DEEP_BOUNCE and the deepest
   reached and with no lane alive, every lane alive and no lane at all
   (timed per call from the host, back to back, and on the device from a
   CUDA graph of 20 calls, ``torch.argsort(stable=True)`` alike);
   ``density_check`` (the bounce's table
   lookups) against the plain lookups on bounce 0's flight segments and NEE
   origins, and the bounce's sphere taps and the stars' direction tap
   against the plain taps (through test launchers; ``check_texture``): at
   bounce 0's surface points, on the edge sweep of the 8-, 4- and 3-channel
   textures (u at 0 and 1, the seam, the poles, zero-length, NaN and
   infinite points), at the points of bounce 0's own march probes and at the
   frame's primary misses, nearest and bilinear, the bilinear tap bit for
   bit against the form texture.cuh first had, each timed on the device
   with its bound (bytes, and the SASS body's operations: the first form's
   for a bilinear tap); last,
   one 1920x1080
   Apollo spp under the window schedule bit-equal to the same spp with one
   launch per bounce, its launches as ``bounce_schedule`` predicts.
8b. the reference's own estimator (REF_ESTIMATOR: ``hero_lambdas=1``,
   ``stratify_spp=False``, ``analytic_transmittance=False``): the
   ``rmo_ratio_track`` kernel against its twin on the NEE lanes of Apollo
   bounce 0 (captured from the twin's bounce, at four wavelengths with the
   ratio tracking alone and at one with all three options), every lane
   bit-equal and its iterations the twin's, timed with its bound; the
   bounce entries' instances of the estimator against their twin on
   the three scenes at bounces 0 and DEEP_BOUNCE, every lane bit-equal,
   with the census's NEE RMO site (its lanes, iterations, share of the warp
   cycles and its tracking lanes per warp); ``gen_rays`` at each new mode
   against its twin; the
   estimator's path (``render_offline``, 3 spp, counts set to 0 before it
   and read after) under phase 6's gates, and ``frame_end`` at one
   wavelength against its twin; ``accumulate_interruptible(3)``, an
   adaptive pass over every tile and a (4, 1) ``MultiChipRenderer`` over
   the card, each bit-equal to one ``Renderer`` spp at the estimator; s/spp
   of Apollo at the default, each option alone and all three, and of
   florida and sunset at the default and all three.
8c. the scene and march options (``check_options``; OPTION_CASES: each of
   ``enable_clouds``, ``enable_land``, ``bilinear_tracking``, ``lazy_march``,
   ``march_exact_ocean``, ``march_ref_phantom`` and ``march_stall_patience``
   alone on the scene its CPU test uses, all seven off their defaults on the
   three scenes, and the five that act on land and clouds off their defaults
   with land and clouds on, on florida and sunset; the stall patience alone
   runs the default instances, which take it at run time): the options
   instances' ptxas registers and spills and
   resident warps beside the default instances'; the bounce entries' options
   instances against their twin at bounces 0 and DEEP_BOUNCE and
   ``bounce_window`` against ``run_window_plain`` from the bounce the frame
   enters it, every lane bit-equal, timed beside the default instances on each
   scene's default frame; each (L, RATIO) options instance forced at the
   defaults bit-equal to the default instance at bounces 0 and DEEP_BOUNCE
   (flight, shade and window) and timed beside it; the ``land_march`` launcher
   at each march option and ``cloud_track`` with bilinear taps on phase 4's
   arguments, under phase 7's gates (the default instances' there); the 480x270
   preview frame at each march option under phase 11's gates and check (the
   options instance, bit-equal); the path (``render_offline``, 3 spp) with all
   seven on Apollo, then with the five on florida, under phase 6's gates,
   every bounce launch the options instances'; s/spp of Apollo at each option
   alone and with all seven, of florida and sunset with all seven and with
   the five, each against its scene's default in five alternated rounds of 2
   spp (the ratio's median and spread). Phase 8's sphere taps add the bilinear topography tap
   at the march's probe points beside the nearest, its bound from its four
   texels a tap and its SASS.
8d. the reference-faithful naive arm (``check_naive``; NAIVE_CASES:
   ``naive_tracking`` at one wavelength, ``naive_march``,
   ``naive_cloud_tracking`` and ``naive_shadow``, each alone): the default
   bounce instances' SASS instruction counts against PARENT_DEFAULT_SASS
   (the naive code lives in the options instances only); the naive
   launchers (``naive_march``, ``naive_delta_track`` and
   ``naive_ratio_track``, gases and cloud) against their twins on each
   scene's bounce-0 arguments at naive_tracking, captured from the twin's
   bounce, every output and every lane's steps bit-equal, timed per call and
   on the device (the march at its three sites) with the trackers' SIMT
   efficiency one thread a lane and under their warp-cooperative steps
   (``naive_rounds``), the march's under its block rounds (``march_rounds``)
   and the census of its steps (``march_step_census``: the one-thread loop's
   clock64 cycles a step in the point and its divisions, the angles, the
   tap's read and the rest); Apollo's calls are the kernels line's rows,
   with their bounds from the work their data needs (the twin's steps, its
   density evaluations, cloud taps and draws: ``naive_work``; the march's
   SASS instructions a step at the issue rate, ``naive_step_sass``); the
   march's launcher on its block rounds' edges and the trackers' on the round
   structure's edge cases, built from Apollo's calls (``check_naive_edges``:
   every lane marching, one a block, land_march_steps 1, 7 and 250, a last
   block of 51 lanes; one tracking lane a warp, 32, a step cap inside a round,
   a stop on a round's last thread), bit-equal with their steps; per
   flag and scene the bounce entries' options instances against their twin
   at bounces 0 and DEEP_BOUNCE and ``bounce_window`` against
   ``run_window_plain`` from the bounce the frame enters it, every lane
   bit-equal, the census's steps at the flag's naive sites, bounce 0's two
   kernels timed beside the default instances on the scene's default frame
   (naive_tracking: the L = 1 estimator's); the naive_tracking path on
   Apollo under phase 6's gates, every bounce launch the options
   instances'; s/spp of each flag on Apollo against its default in five
   alternated rounds; and the paired accelerated-vs-naive_tracking error of
   the frame mean per channel +- its SE at 320x180 on the three scenes
   (``paired_parity``; both arms at one wavelength, winsorised at the
   99.9th percentile; no gate on the error, a non-finite value fails).
8e. the estimator options (``check_estimator_knobs``; ESTIMATOR_CASES and
   ESTIMATOR_EXTRA): the default bounce instances' SASS against
   PARENT_DEFAULT_SASS and the estimator instances' ptxas; ``flight_analytic``
   against its twin on phase 4's RMO flight arguments (event, distance,
   interaction id and each lane's steps bit-equal; timed with its bound) and
   ``fast_uniform_check`` on edge keys and counters and at the frame's shape
   (the kernels line's rows); the tracker launchers at fast_loop_rng, each
   lane bit-equal to the twin on the card or, where the twin's Python
   divisors part there, to the twin on the CPU, timed beside their threefry
   instances; per case and scene the estimator instances against their twin
   at bounces 0 and DEEP_BOUNCE and in the window, every lane bit-equal, with
   the census (at analytic_flight its Newton steps at the RMO site); the
   analytic_flight path on Apollo under phase 6's gates; s/spp of each
   ESTIMATOR_SPP setting on the three scenes against its default; the
   phase's seconds.
8f. the march floors (``check_march_floors``; FLOOR_CASES: the reference's
   cert_u0, cert_u001, cert25_u0, floor_sec01 and floor_pri05_sec005, and
   cert_u0 with analytic_flight): the default bounce instances' SASS against
   PARENT_DEFAULT_SASS, the floor instances', ``land_march``'s and
   ``preview``'s ptxas; the ``land_march`` launcher at each setting on phase
   4's arguments (the primary marches at their bounce's floor, the shadow
   march at its own) against its twin under phase 7's gates (the lanes not
   bit-equal printed beside the default instance's), timed beside the
   default instance with its bound; per case and scene the floor
   instances against their twin at bounces 0 and DEEP_BOUNCE and in the
   window, every lane bit-equal, bounce 0's two kernels on Apollo timed
   with their bounds; the 480x270 preview at cert_u0 and cert25_u0 on its
   floor instance, every lane bit-equal; the cert_u0 path on Apollo under
   phase 6's gates, every bounce launch the floor instances'; s/spp of
   the five settings on the three scenes against their default; the
   phase's seconds.
8g. the hero-packet widths other than 1 and 4 (``check_widths``; WIDTHS
   2, 6 and 16, each from its width library, ``kernels.width_library``):
   every bounce instance of the main library against PARENT_DEFAULT_SASS
   and PARENT_SASS (the parent's 64); the width libraries (and those of
   L = 3 and 7, for ``gen_rays``) built in one parallel nvcc batch (its
   seconds, each entry's ptxas registers and spills, the bounce entries'
   occupancy in the default and the floor instances); per width and scene
   (WIDTH_SCENES: the three at L = 2 and 6, Apollo at 16) the width
   library's bounce entries against their twin at bounces 0 and DEEP_BOUNCE
   and ``bounce_window`` against ``run_window_plain`` from the bounce the
   frame enters it, each in the default instances (which the default
   TraceConfig takes) and the floor instances (forced), with the
   closed-form and the ratio-tracked sun transmittance, ``gen_rays`` on the
   1080p path inputs,
   ``rmo_ratio_track`` on bounce 0's NEE lanes (the twin at
   analytic_transmittance=False) and ``frame_end`` on the frame's end, every
   lane bit-equal (frame_end under phase 16's gate, bit-equal in practice);
   each kernel on Apollo timed with its bound from the L-wide state's bytes
   (the bounce entries also in the floor instances); the path at each width
   on Apollo under phase 6's gates, every bounce launch, ``gen_rays`` and
   ``frame_end`` counted at the width (``"<kernel>/L<n>"``), none an options
   launch; ``gen_rays`` at L = 1, 2, 3, 6, 7 and 16 against its twin on the
   1080p path frame, a lane range whose last block is partial, a tile list
   and (L = 1) the preview, at L = 2 and 4 on a 3072-entry table, and
   ``gen_rays_kernel<L>``'s SASS at L = 1, 2 and 4 against
   PARENT_GEN_RAYS_SASS; s/spp of
   Apollo at each width and at L = 4 forced into its floor instance against
   L = 4, and at each width forced into its floor instances against its
   default instances, five alternated rounds;
   tests/test_hero_packets.py's z-test (|z| < 4, 6 seeds of 3072 paths) at
   L = 4 and each width against L = 1, the chroma variance (L = 4 under 0.3
   of L = 1's) and the fireflies at each; the phase's seconds.

The viewer's path (each run with the launch counts set to 0 just before it
and read just after):

9.  ``gen_rays`` against its plain twin on the 1920x1080 path-mode and the
    480x270 preview-mode inputs: every field bit-equal (keys, directions,
    wavelengths, responses, pdf, the pixel map); timed per call from the
    host and on the device alone, from a CUDA graph of 20 calls (the
    wrapper reads nothing back from the card, or the capture would fail);
10. ``film_postprocess`` against its twin on the phase-6 buffer, OpenDRT
    and AgX, a scalar spp and a per-pixel count; on the device from a CUDA
    graph of 20 calls against its bound (bytes, FP32 instructions, SFU);
11. the preview frame: Apollo 11 at 480x270 (the viewer's preview of a
    1920x1080 view), a warm ``accumulate`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (no synchronizing call),
    then ``accumulate`` + ``fetch_image``, 3 warm frames timed: ``preview``
    launches once per frame, ``atmos_march`` and ``land_march`` never
    (their loops run inside it); ``preview`` against ``march_paths_plain``
    on the card on the frame's own lanes, every lane bit-equal (the kernel
    timed, with its registers and resident warps); the kernel's time split
    into the march, the land and shadow marches (their test launchers on
    the same lanes) and the rest, and by the census instance (each lane's
    clock64 cycles in each); the twin timed, the bound printed;
    ``atmos_march`` bit-equal to its twin on the arguments of bounces 0-2 of
    that twin's run; the committed preview golden (32x18)
    on the card;
12. ``accumulate_interruptible(9)`` at 1920x1080 bit-equal to
    ``accumulate()`` for the same seed and round;
13. ``EarthViewer`` at 1920x1080 on an ephemeral port, driven over HTTP:
    a preview frame, then a path frame with spp >= 1, a new preview frame
    after ``/input?keys=w`` sent in the middle of a path spp (which polls
    for input between bounces; latency printed), then with 3 chunks per
    spp a path frame again, ``/frame.png`` a 1920x1080 PNG.

Adaptive tile sampling (Apollo 11 at 1920x1080, default ``TraceConfig()``):

14. two ``accumulate_adaptive(frac=1.0)`` passes bit-equal to two
    ``accumulate()`` calls, every count 2;
15. the adaptive run: 2 warm-up passes and 6 passes at frac=0.25, each
    adding exactly k * tile samples, pass and uniform-spp times printed,
    ``fetch_image`` finite within [0, 1]; ``gen_rays`` against its twin on
    the first frac=0.25 pass's own arguments (its list of k tiles);
16. ``frame_end`` against its plain twin on the 1920x1080 frame's
    end-of-sweep state (phase 4), on a frac=0.25 pass's tile list with
    counts, and on the 480x270 preview frame's lanes;
17. ``select_tiles`` against its plain twin on the buffers after the
    warm-up and after 4 adaptive passes: the same tile ids in order, m_bar
    and every tile score bit-equal, two launches per call; timed per call
    from the host and on the device (a CUDA graph of 20 calls);
18. ``EarthViewer(adaptive_frac=0.25, adaptive_fps=0.25)`` over HTTP: the
    mean spp goes fractional, input in the middle of a pass reaches a new
    preview frame (latency printed), the frame-rate controller sets the
    passes per frame.

Multi-device rendering (parallel/mesh.py; Apollo 11 at 1920x1080, default
``TraceConfig()``, the launch counts set to 0 before the mesh run and read
after its adaptive pass):

19. a (4, 1) mesh over ``[cuda:0] * 4`` bit-equal to ``Renderer`` over 2 spp;
    a (2, 2) step within MESH_RTOL of those two spp; the (4, 1) mesh's
    ``accumulate_interruptible(9)`` bit-equal; 2 warm-up and one frac=0.25
    adaptive pass, each device refining exactly the tiles
    ``select_tiles_shard_plain`` picks on its shard; the shard entries of
    ``select_tiles`` against their twins (shard means and every tile score
    bit-equal, ids equal in order; timed per call and on the device) on the
    warm-up buffers and after the pass; checkpoints (4, 1) ->
    (2, 2), -> ``Renderer`` and, with counts, (4, 1) -> (2, 1), exact; s/spp
    of the Renderer (before and after), the (4, 1) and the (2, 2) mesh; with
    more than one card an (n, 1) mesh over distinct cards bit-equal to the
    Renderer; ``EarthViewer`` over the ``--multichip`` renderer
    (``make_render_mesh()``: (1, 1) on one card) driven over HTTP.

The tier-2 texture path (the launch counts set to 0 before the atlas is
built and read after its render):

20. ``upsampled_procedural_atlas(dev, (10800, 21600))`` from the shipped
    1350x2700 base: host load, upload and the four ``upsample`` launches
    timed apart, ``max_memory_allocated``; ``render_offline`` of Apollo 11
    at 1920x1080, default ``TraceConfig()``, 1 warm-up + 2 timed spp on it
    under phase 6's gates (and 4 ``upsample`` launches), s/spp beside
    phase 6's; ``upsample`` bit-equal to its twin on the four full-size
    planes (timed beside the twin and an expand + reshape copy);
    ``bounce_flight`` + ``bounce_shade`` against their twin at tier-2
    bounce 0 under phase 8's gates; a 480x270 preview frame on the same
    atlas under phase 11's gates.

Last, since a profiler session can slow the launches after it:

21. Apollo 11 (on the 1024x2048 and on the tier-2 atlas), florida and
    sunset hurricane at 1920x1080, default ``TraceConfig()``, and Apollo 11
    on phase 19's (4, 1) mesh: s/spp (1 warm-up, 1 timed), then one spp
    under ``torch.profiler``: device kernels per spp (at most
    MAX_KERNELS_PER_SPP, four times that on the mesh), the device-busy share,
    the kernels with the most device time, the bounce entries' device
    time; then one warm 480x270 preview frame: device kernels per frame (at most
    MAX_KERNELS_PER_PREVIEW: ``gen_rays``, ``preview``, ``frame_end``,
    ``film_postprocess``), the device-busy share, ``preview``'s device time.

The line before the last is the card's name and power limit; before it, one
JSON line lists each kernel, each width library's kernels as
``"<kernel>/L<n>"`` (phase 8g: the launches of the width's path, the times
on Apollo, bounds from the L-wide state's bytes), and each options instance
as ``"<kernel>/options"`` (its launches from phase 8c's path with the five on
florida, the preview's from its frame at ``bilinear_tracking``; the bounce
entries' times with the five on florida, the launchers' and the preview's at
``bilinear_tracking``; its bound the default row's bytes and operations,
with the SASS's extra instructions a bilinear tap), with its launches (``select_tiles`` makes two
per call, ``select_tiles_shard`` one per shard mean and one per shard
selection, ``compact_lanes`` two (the scratch reset and the kernel),
counted as one; ``upsample`` four per atlas, its times the four planes'
sums; ``preview`` one per preview frame, its launches from phase 11; the
bounce entries' times at bounce 0, ``bounce_window``'s from the bounce the
frame enters it; ``compact_lanes``'s and ``gen_rays``'s per call from the
host, their device times printed beside them), error,
times and bound (the least time the card could take: the larger of the
bytes it must move at 3.35 TB/s and the operations at 67 TFLOP/s, counted
from this run's inputs, a transcendental as one operation, threefry's
blocks as this build's SASS instructions at the integer rate of the pipe
that issues each (phase 3); the bounce
entries' operations from the census's trip counts, the trackers' from
their iterations on phase 7's arguments; for ``preview`` and
``atmos_march`` the largest of the bytes' time, their FP32 instructions
at 128 per SM per clock and their special-function operations at 16 per
SM per clock, at the card's largest SM clock). The last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "scenes", "config - Apollo 11.txt")
RES = (1920, 1080)
DEEP_BOUNCE = 3
WINDOW_STARTS = 3  # window starts timed before the threshold's (check_window)

# Stated tolerances, kernel vs plain twin on the same inputs on the card.
# Both round op by op with the same CUDA libm, so a lane disagrees only
# where a probe or an event sits within an ulp of its threshold.
MIN_LANE_AGREEMENT = 1.0 - 1e-5  # share of lanes with the same outcome and value
T_RTOL = 1e-4                    # hit / event distance, relative (floor 1 m)
RATIO_RTOL, RATIO_ATOL = 1e-4, 1e-6  # ratio-tracking transmittance
# gen_rays: every field bit-equal to its twin. The twin's CUDA ops apply a
# Python divisor b (/ H, / res, / L) as a multiply by float32(1 / b), and the
# kernel rounds it so; directions were gated at 1e-6 absolute, wavelengths
# at 1e-6 and responses and pdf at 1e-4 relative while the kernel divided.
# preview and atmos_march: every lane bit-equal to march_paths_plain and
# ray_march_atmos_plain (the warp-cooperative march replays the per-lane
# march's operations in its order, the densities round Python divisors as
# PyTorch's CUDA ops do).
FILM_ATOL = 1e-4    # film_postprocess display values in [0, 1]
PREVIEW_RES = (480, 270)  # the viewer's preview (preview_scale=4) of RES
# frame_end: RGB and lum^2 within 1e-5 relative (atol 1e-6 of the largest
# value, for channels that cancel in xyz_to_rgb), counts exact. The twin
# rounds op by op in the kernel's order; both use the card's libm.
END_RTOL = 1e-5
ADAPTIVE_FRAC = 0.25
# bounce vs its twin: the share of live lanes with the same alive,
# primary_miss and work_class, and the share that also has pos, throughput,
# radiance and w_mis within BOUNCE_RTOL (atol 1e-6 of each field's largest
# value) and a direction within DIR_ANGLE (absolute, per component: a unit
# vector's error is an angle). Kernel and twin draw the same numbers and
# round op by op alike, so a lane's outcome differs only where an event or a
# march hit sits within an ulp of its threshold. Directions were gated at
# 2e-4 until the Draine lobe's last division was found to part (check_draine:
# PyTorch's CUDA ops multiply by float32(1 / b) for a Python divisor b, the
# kernel took 1.0f / float32(b)); since the kernel rounds it so, every
# direction agrees bit for bit at bounces 0 and DEEP_BOUNCE and through the
# window, and the gate is the other fields' absolute floor.
BOUNCE_AGREEMENT = 1.0 - 1e-4
BOUNCE_RTOL = 1e-4
DIR_ANGLE = 1e-6
DENSITY_RTOL = 1e-4  # density_check vs the plain lookups (atol 1e-6 of the max)
# sphere tap vs ops/texture.sample_sphere_texture: both round the angles
# (times float32(1/pi), as the twin's CUDA ops apply its Python divisor) and
# the lerp op by op alike, so they agree to the last bit but for libm's
# atan2f/asinf
TAP_ATOL = 1e-5
MAX_KERNELS_PER_SPP = 300
# The tier-2 atlas: the JAX bench's headline textures (bench.py --texture-res
# 10800), the shipped 1350x2700 base upsampled 8x on the card.
TIER2_RES = (10800, 21600)
# upsample's operations per jittered texel (csrc/upsample.cu): the hash (the
# seed's xor, three xor-shifts of 2, two multiplies: 9) and the scale (two
# conversions, the 2^-32 scale, jitter * u, 1 - that, the multiply, rint: 7)
UPSAMPLE_JITTER_OPS = 16
MAIN_PATH = ("bounce_flight", "bounce_shade", "bounce_window", "compact_lanes", "gen_rays",
             "frame_end", "film_postprocess")
# kernels whose loops now run inside bounce: none of their own launches on
# the path tracer's run (held against their twins in their own phase)
INLINED = ("land_march", "rmo_delta_track", "rmo_ratio_track", "cloud_track", "naive_march",
           "naive_delta_track", "naive_ratio_track", "flight_analytic", "fast_uniform_check")
OTHER_SCENES = ("config - florida.txt", "config - sunset hurricane.txt")
# bounce's bytes per live lane: its state read (pos, dir, wavelengths,
# lambda_pdf, throughput, radiance, w_mis, flags, work class, keys, list
# entry: 122 B) and written (pos, dir, throughput, radiance, w_mis, flags,
# work class: 78 B). The textures and the density table are inputs read at
# most once each, but which of their texels a run touches depends on the
# loops' trip counts, which this run does not observe: they are not
# counted, and the bound is a floor (as the lookup launchers' below)
BOUNCE_LANE_BYTES = 122 + 78
# bounce's operations (csrc/bounce.cuh and the loop headers), counted from the
# sources as the other rows are (below: an add, multiply, divide, square root,
# min or max, an expf, logf, powf, atan2f or asinf each one operation; a
# nearest 4-channel sphere tap 36), threefry's apart: each *_OPS count leaves
# it out, and its *_TF twin gives it as (blocks, draws), which ``tf_ops``
# turns into this build's SASS instructions by pipe (``sass_census``), at
# the integer rate in ``bound``. Every live lane: the hero extinctions (45),
# the topography tap and d_free, the spans (three rsi of 17, the cloud
# limits 41): 179, and the bounce key and three flight keys (4 blocks); then
# four wavelengths' extinctions (180), the MIS weight (the segment integral
# 60, tau, w, denominator: 109), the sun cone's sample (56), the scatter
# point and its planet test (23) and four wavelengths' Planck terms and
# three radiance terms (148): 537 as first counted (the parts named here
# sum to 516; the count is kept), and the cone's key and two draws.
BOUNCE_FLIGHT_OPS, BOUNCE_FLIGHT_TF = 179, (4, 0)
BOUNCE_FIXED_OPS, BOUNCE_FIXED_TF = BOUNCE_FLIGHT_OPS + 537, (5, 2)
# A lane whose flight ends on the surface (its shadow march ran): land_pos,
# the normal's four SDFs, the material grading, four albedo spectra, the
# offset, two BRDF evaluations, the terms and the hemisphere sample: 844,
# and the hemisphere key and draws (a block and two draws). A lane that
# takes the sun's transmittance (its NEE cloud pass ran): the cloud limits
# (41), the phase (30): 71, and two keys (two blocks); and with the closed
# form (no NEE RMO trips) its term (60). Lanes whose pass ran with no trips
# are not counted, nor the phase sample and the roulette: the bound is a
# floor.
BOUNCE_SURFACE_OPS, BOUNCE_SURFACE_TF = 844, (1, 2)
BOUNCE_NEE_OPS, BOUNCE_NEE_TF = 71, (2, 0)
BOUNCE_CLOSED_FORM_OPS = 60
# Per loop site (pre-march, cloud, RMO, march after, shadow, NEE cloud, NEE
# RMO): the operations of a call that takes at least one trip, of one
# iteration outside its probes, and of one probe, and (the *_TF tables)
# their threefry blocks and draws. A march call: the bounding rsi, the span
# and the crawl's setup (59); an iteration's stride update (4); a probe
# (110: its tap 36, the three mip bounds 27, the SDF, the ocean root). An
# RMO call: the perigee (19); an iteration: the segment's minimum radius
# (7), the density envelope (29), the majorant (7): 43, and the key (a
# block); a probe: the step (6), the point (7), the three densities (51),
# the test (6): 70, and two draws. A cloud call (2); an iteration: the
# budget (2), the majorant (3) (its key only in a tracking iteration, which
# the trip count does not tell apart: not counted); a probe at the skip
# mode's cost (45: the point and its tap; a tracking probe's two draws are
# not assumed). An NEE RMO call (the ratio tracker, csrc/rmo_track.cuh
# rmo_ratio_lane, counted at one wavelength, a floor for four): the
# majorant (5), the span (19), the setup (5): 29, and its key; an
# iteration: the transmittance's update and the stop test (3), and the key;
# a probe: the step (6), the prefix sums (2), the test (1), the point (7),
# the three densities (51), the factor (8): 75, and a draw. A march, RMO or
# NEE RMO iteration's K probes all count but the last iteration's, which
# counts one (its first stopping probe ends the loop); a cloud iteration
# counts one (a stop ends its sweep, not the loop). The counts are floors.
BOUNCE_CALL_OPS = (59, 2, 19, 59, 59, 2, 29)
BOUNCE_ITER_OPS = (4, 5, 43, 4, 4, 5, 3)
BOUNCE_PROBE_OPS = (110, 45, 70, 110, 110, 45, 75)
BOUNCE_CALL_TF = tuple((b, 0) for b in (0, 0, 0, 0, 0, 0, 1))
BOUNCE_ITER_TF = tuple((b, 0) for b in (0, 0, 1, 0, 0, 0, 1))
BOUNCE_PROBE_TF = tuple((0, d) for d in (0, 0, 2, 0, 0, 0, 1))
TRACKER_SITES = (1, 2, 5, 6)  # cloud, RMO, NEE cloud, NEE RMO
NEE_RMO = 6  # the census column of the NEE RMO ratio tracker


def site_probes(torch, t, k):
    """Probes a floor counts for the float64 trips ``t`` of sites whose
    iterations run ``k`` probes (a tensor broadcast against ``t``): k an
    iteration but the last's one."""
    return torch.clamp(k * t - (k - 1), min=0.0)


def site_k(march_k, tracking_k):
    """Per site, the probes a floor counts in an iteration that does not
    end the loop: the march's K, the RMO trackers' K, the cloud passes' 1."""
    return (march_k, 1, tracking_k, march_k, march_k, 1, tracking_k)


def bounce_ops(torch, trips, march_k, tracking_k, tf, part="bounce"):
    """The operations of one bounce of the lanes whose (m, sites) int32 trip
    counts ``trips`` the census gives (7 sites, or a census of 6 without the
    NEE RMO column), with ``march_k`` probes per march iteration and
    ``tracking_k`` per tracker iteration, as (other operations, threefry's
    ALU-pipe instructions, its FMA-pipe ones): BOUNCE_FIXED_OPS per lane,
    the surface and NEE extras of the lanes whose shadow march and NEE cloud
    pass took trips (the closed form's where the NEE RMO tracker took none),
    and per site each call's, iteration's and probe's operations (a floor);
    threefry's blocks and draws (the *_TF tables) at the SASS census ``tf``
    (``tf_ops``). ``part`` "flight" counts steps 1-3 alone
    (BOUNCE_FLIGHT_OPS, sites 0-3), "shade" the rest."""
    t = trips.to(torch.float64)
    m, n = t.shape

    def tab(x):
        return torch.tensor(x[:n], dtype=torch.float64, device=t.device)

    k = tab(site_k(march_k, tracking_k))
    calls, probes = (t > 0).to(torch.float64), site_probes(torch, t, k)
    # per site: the other operations, threefry's blocks and its draws
    other = (calls * tab(BOUNCE_CALL_OPS) + t * tab(BOUNCE_ITER_OPS)
             + probes * tab(BOUNCE_PROBE_OPS)).sum(0)
    blocks = (calls * tab([x[0] for x in BOUNCE_CALL_TF])
              + t * tab([x[0] for x in BOUNCE_ITER_TF])).sum(0)
    draws = (probes * tab([x[1] for x in BOUNCE_PROBE_TF])).sum(0)
    nee = t[:, 5] > 0
    closed = nee & (t[:, NEE_RMO] == 0) if n > NEE_RMO else nee
    surf, n_nee = float((t[:, 4] > 0).sum()), float(nee.sum())
    flight_tf = BOUNCE_FLIGHT_TF
    shade_tf = tuple(a - b for a, b in zip(BOUNCE_FIXED_TF, BOUNCE_FLIGHT_TF))
    parts = {
        "flight": (m * BOUNCE_FLIGHT_OPS + float(other[:4].sum()),
                   m * flight_tf[0] + float(blocks[:4].sum()),
                   m * flight_tf[1] + float(draws[:4].sum())),
        "shade": (m * (BOUNCE_FIXED_OPS - BOUNCE_FLIGHT_OPS) + surf * BOUNCE_SURFACE_OPS
                  + n_nee * BOUNCE_NEE_OPS + BOUNCE_CLOSED_FORM_OPS * float(closed.sum())
                  + float(other[4:].sum()),
                  m * shade_tf[0] + surf * BOUNCE_SURFACE_TF[0] + n_nee * BOUNCE_NEE_TF[0]
                  + float(blocks[4:].sum()),
                  m * shade_tf[1] + surf * BOUNCE_SURFACE_TF[1] + n_nee * BOUNCE_NEE_TF[1]
                  + float(draws[4:].sum())),
    }
    parts["bounce"] = tuple(a + b for a, b in zip(parts["flight"], parts["shade"]))
    other, blocks, draws = parts[part]
    return (other, *tf_ops(blocks, draws, tf))


def tracker_ops(torch, trips, k, site, tf):
    """The operations of a tracker launcher (``rmo_delta_track`` at the RMO
    site's counts, ``cloud_track`` at the cloud site's, ``rmo_ratio_track``
    at the NEE RMO site's) whose lanes took the (n,) int32 iterations
    ``trips`` with ``k`` probes per iteration: each call's, iteration's and
    probe's operations as ``bounce_ops`` counts them (a floor), the same
    triple."""
    t = trips.to(torch.float64)
    calls, probes = float((t > 0).sum()), float(site_probes(torch, t, site_k(k, k)[site]).sum())
    iters = float(t.sum())
    per = (BOUNCE_CALL_TF[site], BOUNCE_ITER_TF[site], BOUNCE_PROBE_TF[site])
    blocks = calls * per[0][0] + iters * per[1][0] + probes * per[2][0]
    draws = calls * per[0][1] + iters * per[1][1] + probes * per[2][1]
    other = (calls * BOUNCE_CALL_OPS[site] + iters * BOUNCE_ITER_OPS[site]
             + probes * BOUNCE_PROBE_OPS[site])
    return (other, *tf_ops(blocks, draws, tf))


def simt_efficiency(torch, trips, warp=32):
    """Per loop site, the share of a warp's iterations that do a lane's work
    under the launch's warp grouping (the list order): sum of the lanes'
    trips over the sum over warps of ``warp`` times the warp's largest trip
    count; None for a site no lane entered."""
    m = trips.shape[0]
    pad = (-m) % warp
    t = torch.cat([trips, trips.new_zeros((pad, trips.shape[1]))]).to(torch.float64)
    worst = t.view(-1, warp, t.shape[1]).amax(1).sum(0) * warp
    work = t.sum(0)
    return [None if w == 0 else float(a / w) for a, w in zip(work.tolist(), worst.tolist())]


MARCH_SITES = (0, 3, 4)  # pre-march, march after the flight, shadow march


def march_simt(torch, trips, k, warp=32):
    """SIMT efficiency of the warp-cooperative land march
    (csrc/land_march.cuh land_march_warp) at MARCH_SITES: lane iterations
    over the lane-iteration slots its warps issue. A warp of c marching
    lanes (those with trips) marches them in one pass, each on T threads,
    T the most of k, k / 2, ..., 1 with c T <= 32: 32 / T slots an
    iteration, for its longest lane's iterations. None for a site no lane
    entered."""
    m = trips.shape[0]
    pad = (-m) % warp
    t = torch.cat([trips, trips.new_zeros((pad, trips.shape[1]))]).to(torch.int64)
    out = []
    for site in MARCH_SITES:
        x = t[:, site].view(-1, warp)
        c = (x > 0).sum(1)
        lanes = torch.full_like(c, warp // k)  # lanes a pass holds: 32 / T
        for _ in range(k.bit_length()):
            lanes = torch.where(c > lanes, lanes * 2, lanes)
        work, total = int(x.sum()), int((torch.clamp(lanes, max=warp) * x.amax(1)).sum())
        out.append(None if total == 0 else work / total)
    return out


# NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores, for each kernel's bound; its SMs,
# FP32 lanes and special-function units per SM (the Hopper white paper) for
# the bounds of preview and atmos_march, which count instructions. 32-bit
# integer add, shift and logic operations (threefry's adds, rotates and
# xors) issue at 64 per SM per clock on compute capability 9.0, half the
# FP32 rate (the CUDA C++ Programming Guide's table of arithmetic
# instruction throughput), at the card's largest SM clock.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
H100_SMS, FP32_PER_SM, SFU_PER_SM, INT32_PER_SM = 132, 128, 16, 64
# Operations per lane or pixel, counted from the kernel sources: each add,
# multiply, divide, square root, min or max, and each expf, powf, log2f,
# atan2f or asinf, as one operation. The peak table gives no rate for the
# special-function unit, so a transcendental counts as the one operation it
# is at least, and each bound below is a floor.
# gen_rays: the pinhole ray, the 9-step search and 4 wavelengths (218), and
# threefry's three folds and three draws, at this build's SASS instructions
# by pipe (``tf_ops``).
GEN_RAYS_OPS, GEN_RAYS_TF = 218, (3, 3)
# atmos_march (csrc/atmos_march.cu): one density evaluation (elevation 7,
# clamp 1, Rayleigh 6, the cheapest Mie branch 3, ozone 16) is 33; a march
# step is a density, 33 of optical depth, in-scatter and advance, and the
# 17 of the planet-occlusion test (rsi); a lane's setup is 22. A step whose
# sun ray the planet does not occlude adds the atmosphere's rsi (17), the
# step length (1), 16 sun steps of a density, optical depth and advance
# (45 each) and the final exponential (6): 744.
ATMOS_LANE_OPS = 22 + 64 * (33 + 33 + 17)
ATMOS_SUN_OPS = 17 + 1 + 16 * 45 + 6
# The same march's special-function operations (each expf, sqrtf and true
# division issues one on the SFU; a Python divisor is a multiply by its
# reciprocal, and --fmad=false leaves every other multiply and add its own
# FP32 instruction): a density evaluation has 5 (the elevation's sqrtf,
# Rayleigh's expf, the one expf of the Mie branch that is kept, the ozone's
# two), a march step a density, the step's expf and division and the
# occlusion test's sqrtf (8), a sun march the atmosphere's sqrtf, 16
# densities and its expf (82), a lane's setup the Mie phase's division (1).
ATMOS_DENSITY_SFU = 5
ATMOS_STEP_SFU, ATMOS_SUN_SFU, ATMOS_LANE_SFU = ATMOS_DENSITY_SFU + 3, 16 * ATMOS_DENSITY_SFU + 2, 1
# preview (csrc/preview.cu), counted the same way; the land-march probes and
# the texture taps (normal, material, stars) are not counted, so its bound
# is a floor. Every lane: two Planck terms and the sun irradiance (22), the
# three extinctions (46), the scattering (2), the tile key's threefry block
# (77), the clamp (2): 149. A lane per bounce it enters alive and crossing
# the atmosphere: the atmosphere's rsi (17), the span (2), the cone key and
# its two draws (3 threefry blocks, 231), the cone sample (56), the
# accumulation (3), plus ATMOS_LANE_OPS and ATMOS_SUN_OPS per step that needs
# the sun march: 309; a lane entering bounce 1 or 2, the key chain's block
# (77). A surface lane: land_pos (6), the normal's four SDFs and difference
# (52), the material grading (86), the albedo spectrum (18), the night
# lights, offset and visibility (7), two BRDF evaluations (570), the direct
# and bounce terms (11), the hemisphere key and draws (231), the hemisphere
# sample (26): 1007. A primary miss: the sun test and add (6), the stars'
# spectrum (18), its term (3): 27.
PREVIEW_LANE_OPS, PREVIEW_BOUNCE_OPS, PREVIEW_CHAIN_OPS = 149, 309, 77
PREVIEW_SURFACE_OPS, PREVIEW_MISS_OPS = 1007, 27
# Its SFU operations beyond the marches': the two Planck terms' expf and
# three divisions each (8) per lane; the land-march probes, the BRDFs and
# the taps are not counted (a floor).
PREVIEW_LANE_SFU = 8
# dir (12 B), wavelength (4), tile and in-tile index (8 each) read, the
# radiance (4) written (the origin comes by value); the o3 and srgb2spec
# tables read once
PREVIEW_LANE_BYTES, PREVIEW_TABLE_BYTES = 36, 441 * 4 + 300 * 12
# device kernels of one profiled warm preview frame: gen_rays, preview,
# frame_end, film_postprocess (nothing else runs: the scene's floats and the
# rays' origin come from the host)
MAX_KERNELS_PER_PREVIEW = 4
# film_postprocess (csrc/film_postprocess.cu), per pixel of the OpenDRT
# chain with a scalar spp, counted from the kernel's source: FP32
# instructions, each add, multiply, fused multiply-add (the kernel's fmaf),
# compare, select, min, max, floor or conversion one, and each division,
# square root and pow one as well (the multiply by a reciprocal, by
# y log2 x); a value used twice (a denominator's test and reciprocal, a
# product) counted once, and values of the parameters alone (1/spp, the
# clamps' bounds) not at all: the vignette, /spp and exposure (17), the two
# 3x3 matrices (18: a multiply and two fused multiply-adds a row), the
# OpenDRT chain (127: hue, purity, luminance, tone scale, chroma
# compression, the clamp) and per channel the response-table lerp, the
# gamma and the sRGB encode (26, 78 for three); special-function operations,
# one per reciprocal and square root and two per pow (its log2 and exp2):
# the vignette's square root, OpenDRT's seven reciprocals (of its seven
# distinct denominators) and two square roots, the six pows (12).
FILM_OPS, FILM_SFU = 240, 22


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes, ops, sfu=None, int_ops=0.0, fma_ops=0.0):
    """(ms, "bytes" or "operations"): the least time for the work on the
    card. With ``sfu`` (special-function operations), ``ops`` counts FP32
    instructions at 128 per SM per clock (an add, a multiply and a fused
    multiply-add one each: under --fmad=false a multiply and an add fuse
    only where the source writes fmaf), and the SFU operations issue at 16
    per SM per clock, at the card's largest SM clock; else ``ops`` run at
    the FP32 peak, but for ``int_ops`` of them, 32-bit integer instructions
    on the ALU pipe (threefry's rotates, xors and three-input adds), which
    run at INT32_PER_SM per SM per clock, and ``fma_ops``, integer
    multiply-adds on the FMA pipe (threefry's adds issued as IMAD), which
    the same table gives the same rate: the largest of the three times (the
    pipes issue side by side; FP32 work beside the IMADs is not charged to
    their pipe, so the bound is a floor)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if sfu is None:
        t_ops = ((ops or 0) - int_ops - fma_ops) / PEAK_F32 * 1e3
        int_hz = H100_SMS * INT32_PER_SM * sm_clock_mhz() * 1e6
        if int_ops or fma_ops:
            t_ops = max(t_ops, int_ops / int_hz * 1e3, fma_ops / int_hz * 1e3)
    else:
        hz = sm_clock_mhz() * 1e6
        t_ops = max(ops / (H100_SMS * FP32_PER_SM * hz), sfu / (H100_SMS * SFU_PER_SM * hz)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def sm_clock_mhz():
    """The card's largest SM clock (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def toolchain(torch):
    from digital_earth_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    nv_line = [l for l in nv.stdout.splitlines() if "release" in l]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  triton {triton_v}")
    print(f"nvcc: {nv_line[0].strip() if nv_line else nv.stdout.strip()}")
    print(f"card: {nvidia_smi_line()}")


# SASS opcodes by the pipe that issues them on compute capability 9.0: the
# integer ALU pipe (16 lanes per SM sub-partition); the FMA pipe, which takes
# the integer multiply-adds (IMAD and its forms .IADD, .MOV, .SHL, .WIDE)
# at the integer rate and FP32 arithmetic, compares, selects and min / max
# at the FP32 rate (a floor for any that issue slower); the XU pipe,
# special functions and conversions (16 per SM per clock: the CUDA C++
# Programming Guide's throughput table); any other opcode is "other"
SASS_ALU = {"IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "SEL", "IMNMX", "IABS", "MOV",
            "PLOP3", "FLO", "POPC", "BMSK", "SGXT"}
SASS_F32 = {"FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FCHK", "I2FP", "F2FP"}
SASS_XU = {"MUFU", "I2F", "F2I", "F2F", "FRND"}


def sass_pipe(op):
    """The pipe of a SASS opcode: "alu", "imad", "f32", "xu" or "other"."""
    base = op.split(".")[0]
    return ("xu" if base in SASS_XU else "f32" if base in SASS_F32 else
            "imad" if base == "IMAD" else "alu" if base in SASS_ALU else "other")


def tf_ops(blocks, draws, tf):
    """(ALU-pipe, FMA-pipe) integer instructions of ``blocks`` threefry
    blocks and ``draws`` draws at the SASS census ``tf`` (``sass_census``'s
    "tf": a block's and a draw's ALU and IMAD instructions). Fails without
    one: no bound takes the source's count."""
    if not tf:
        fail("no SASS census of the threefry stream: the bounds' integer work comes from it")
    return (blocks * tf["block"]["alu"] + draws * tf["draw"]["alu"],
            blocks * tf["block"]["imad"] + draws * tf["draw"]["imad"])


def parse_sass(text):
    """{mangled function name: [opcode, ...]} of ``cuobjdump -sass`` output,
    NOPs left out; an opcode keeps its modifiers (``SHF.L.W.U32.HI``,
    ``IMAD.IADD``)."""
    import re

    funcs, ops = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            ops = funcs.setdefault(head[1], [])
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if ins and ops is not None and ins[1] != "NOP":
            ops.append(ins[1])
    return funcs


@functools.lru_cache(maxsize=None)
def sass_functions(so):
    """``parse_sass`` of the shared library ``so`` (``cuobjdump -sass``, the
    tool next to nvcc), read once a run."""
    from digital_earth_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                                     check=True).stdout)


def sass_histogram(ops):
    """(opcode -> count, pipe -> count) of a list of SASS opcodes, the pipe
    by ``sass_pipe``."""
    hist, pipes = {}, dict.fromkeys(("alu", "imad", "f32", "xu", "other"), 0)
    for op in ops:
        hist[op] = hist.get(op, 0) + 1
        pipes[sass_pipe(op)] += 1
    return hist, pipes


# the threefry launchers of csrc/threefry_check.cu whose instance 2 less
# instance 1 is one block (a fold of the fold's output) and one draw (a
# key's second word: its block, its conversion and the sum's FP32 add)
SASS_PAIRS = (("block", "threefry_fold_kernelILi{}E", "fold depth 2 less depth 1"),
              ("draw", "threefry_draw_sum_kernelILi{}E", "two-word sum less one-word"))


def sass_census(kernels, label="", funcs=None):
    """The SASS of one threefry block and of one draw in the built library
    (SASS_PAIRS: each launcher's instance 2 less its instance 1), by opcode
    and by pipe, and their integer instructions as "tf" (the bounds' count
    of threefry's work, ``tf_ops``: a block's and a draw's ALU-pipe and IMAD
    instructions); prints them and the instruction mix of
    ``threefry_uniform_kernel`` and of the default ``bounce_flight``. Fails
    if the disassembly lacks either pair. ``funcs``: the library's
    ``sass_functions``, where already read. A dict."""
    so = kernels.library()._name
    funcs = funcs if funcs is not None else sass_functions(so)
    out, tf = {}, {}
    for what, pattern, how in SASS_PAIRS:
        pair = [next((f for n, f in funcs.items() if pattern.format(c) in n), None)
                for c in (1, 2)]
        if None in pair:
            fail(f"the disassembly of {so} lacks the threefry launchers {pattern.format('1, 2')} "
                 f"({len(funcs)} functions, threefry: {[n for n in funcs if 'threefry' in n]})")
        (h1, p1), (h2, p2) = sass_histogram(pair[0]), sass_histogram(pair[1])
        delta = {op: h2.get(op, 0) - h1.get(op, 0) for op in sorted(set(h1) | set(h2))}
        delta = {op: c for op, c in delta.items() if c}
        pipes = {k: p2[k] - p1[k] for k in p1}
        tf[what] = {"alu": float(pipes["alu"]), "imad": float(pipes["imad"])}
        total = sum(delta.values())
        print(f"threefry SASS{label}, one {what} ({how}): {total} instructions, "
              + ", ".join(f"{k} {v}" for k, v in pipes.items()) + ": "
              + ", ".join(f"{op} {c}" for op, c in sorted(delta.items(), key=lambda x: -x[1])))
        out[what] = dict(ops=delta, pipes=pipes, total=total)
    out["tf"] = tf
    for key, patterns in (("threefry_uniform_kernel", ("threefry_uniform_kernel",)),
                          ("bounce_flight", ("bounce_flight_kernelILi4ELb0ELi0EE",
                                             "bounce_flight_kernelILi4ELb0ELb0EE"))):
        name = next((n for n in funcs if any(p in n for p in patterns)), None)
        if name is None:
            continue
        hist, pp = sass_histogram(funcs[name])
        top = sorted(hist.items(), key=lambda x: -x[1])[:8]
        print(f"SASS{label} {key}: {len(funcs[name])} instructions, "
              + ", ".join(f"{k} {v}" for k, v in pp.items()) + "; "
              + ", ".join(f"{op} {c}" for op, c in top))
        out[key] = dict(total=len(funcs[name]), pipes=pp, top=dict(top))
    return out


def sass_main_body(ops):
    """A kernel's SASS opcodes up to the EXIT that ends its body: the
    subroutines after it (the slow paths of IEEE divisions, ending in RET)
    and the padding left out."""
    ret = next((i for i, op in enumerate(ops) if op.startswith("RET")), len(ops))
    exits = [i for i, op in enumerate(ops[:ret]) if op == "EXIT"]
    return ops[:exits[-1] + 1] if exits else ops[:ret]


def sass_ops_bound(ops, n):
    """(ms, {pipe: ms}, {pipe: count}) of ``n`` executions of the SASS
    opcodes ``ops``, each pipe at its rate on the card (FP32 128, the
    integer ALU and IMAD 64, the XU pipe 16 per SM per clock at the largest
    SM clock): the slowest pipe's time, a floor (loads, stores and branches
    not counted)."""
    rates = {"f32": FP32_PER_SM, "alu": INT32_PER_SM, "imad": INT32_PER_SM, "xu": SFU_PER_SM}
    _, pipes = sass_histogram(ops)
    count = {p: pipes[p] for p in rates}
    hz = H100_SMS * sm_clock_mhz() * 1e6
    ms = {p: n * count[p] / (rates[p] * hz) * 1e3 for p in rates}
    return max(ms.values()), ms, count


def threefry_keys(torch, dev, n):
    """(n, 2) int64 keys of a seeded batch whose first lanes are edge keys:
    k0 = k1 (0, 1, 0x7FFFFFFF, 0xFFFFFFFF), ks[2] = 0 (k0 ^ k1 =
    0x1BD11BDA) and one word 0 or all ones."""
    from digital_earth_tpu_torch.ops import rng

    par = 0x1BD11BDA
    edge = [(v, v) for v in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)]
    edge += [(a, a ^ par) for a in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 0x12345678)]
    edge += [(0, 0xFFFFFFFF), (0xFFFFFFFF, 0), (par, 0), (0, par)]
    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(n, device=dev) * 7919)
    keys[:len(edge)] = torch.tensor(edge, dtype=torch.int64, device=dev)
    return keys


# fold data and draw counters the threefry check covers: 0, 1, the sign
# bit's edges and 2^32 - 1 (and counter runs that wrap past it)
THREEFRY_DATA = (0, 1, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
THREEFRY_BASES = (0, 0x7FFFFFFA, 0xFFFFFFFA)


def check_threefry(torch, dev):
    """The threefry header bit for bit against ops/rng.py on 65,536 lanes
    (edge keys first): a fold and 12 draws, the fold at depths 1 and 2 (at
    edge data), and 12 draws from each key at counter runs that cross 2^31
    and 2^32, and the one- and two-word sums whose SASS gives a draw's
    count; then the launcher at the
    frame's shape (a fold and 3 draws for each of 1920 x 1080 lanes) per
    call and on the device alone, with its bound from the SASS census. A
    JSON row; its "tf" is the census every bound of threefry's work takes
    (``tf_ops``)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import rng

    census = sass_census(kernels)
    keys = threefry_keys(torch, dev, 1 << 16)
    checks = 0
    for data in THREEFRY_DATA:
        got = kernels.threefry_uniform(keys, data, 12)
        want = rng.uniform(rng.fold(keys, data), (12,))
        k1 = rng.fold(keys, data)
        same = [torch.equal(got.view(torch.int32), want.view(torch.int32)),
                torch.equal(kernels.threefry_fold(keys, data, 1), kernels.keys_i32(k1)),
                torch.equal(kernels.threefry_fold(keys, data, 2),
                            kernels.keys_i32(rng.fold(k1, data)))]
        checks += len(same)
        if not all(same):
            fail(f"threefry header disagrees with ops/rng.py at data {data:#x} (uniform, fold "
                 f"depth 1, depth 2: {same})")
    for base in THREEFRY_BASES:
        ctr = (base + torch.arange(12, device=dev))[:, None]
        want = rng.uniform_at(keys[None], ctr)
        same = [torch.equal(kernels.threefry_draws(keys, base, 12).view(torch.int32),
                            want.view(torch.int32)),
                 torch.equal(kernels.threefry_draw_sum(keys, base, 1), want[0]),
                 torch.equal(kernels.threefry_draw_sum(keys, base, 2), want[0] + want[1])]
        checks += len(same)
        if not all(same):
            fail(f"threefry draws disagree with ops/rng.uniform_at at counters {base:#x} + 0..11 "
                 f"(the draws, the sums of 1 and 2: {same})")
    torch.cuda.synchronize()
    print(f"threefry: header bit-equal to ops/rng.py on 65536 lanes (17 edge keys first) in "
          f"{checks} checks: uniform(fold(key, d), 0..11), fold depth 1 and 2 at d in "
          f"{[hex(d) for d in THREEFRY_DATA]}; uniform(key, c) at counters "
          f"{[hex(b) for b in THREEFRY_BASES]} + 0..11, and the sums of the first 1 and 2")
    # at the bounce's shape: one site's key and its three draws (the phase
    # sample) for every lane of a 1080p frame; the keys given as int32, so
    # the launcher's time is its kernel's
    n = RES[0] * RES[1]
    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(n, device=dev))
    k32 = kernels.keys_i32(keys)
    got, ms = _time_ms(torch, lambda: kernels.threefry_uniform(k32, 4, 3), 20)
    graph_ms = _graph_ms(torch, lambda: kernels.threefry_uniform(k32, 4, 3))
    want, plain_ms = _plain_ms(torch, lambda: rng.uniform(rng.fold(keys, 4), (3,)))
    equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    # keys read (8 B) and 3 draws written per lane; a fold and 3 draws at
    # this build's SASS on the ALU and FMA pipes, at the integer rate (each
    # draw at a key's second word's count: a floor for its first)
    alu, fma = tf_ops(n, 3 * n, census["tf"])
    b_ms, b_by = bound(20 * n, alu + fma, int_ops=alu, fma_ops=fma)
    print(f"threefry {n} lanes, a fold and 3 draws: bit-equal {equal}  kernel {ms:.4f} ms per "
          f"call, {graph_ms:.4f} ms on the device (CUDA graph)  plain {plain_ms:.2f} ms  bound "
          f"{b_ms:.4f} ms ({b_by}; {alu:.4g} ALU-pipe and {fma:.4g} FMA-pipe instructions)  "
          f"{'ok' if equal else 'FAIL'}")
    if not equal:
        fail("threefry header disagrees with ops/rng.uniform at the frame's shape")
    return dict(max_abs_err=0.0, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bytes=20 * n,
                ops=alu + fma, int_ops=alu, fma_ops=fma, sass=census, tf=census["tf"])


def capture_frame_end(torch, run):
    """Run ``run()`` with render/frame_end.frame_end wrapped: the arguments
    of its first call, kept (the renderer drops its references after the
    call and neither version writes its inputs), the deposit targets only
    by size."""
    from digital_earth_tpu_torch.render import frame_end as fe

    original = fe.frame_end
    kept = {}

    def keep(responses, pid, color, count=None, lum2=None, **kwargs):
        if not kept:
            kept.update(responses=responses, pid=pid, n_pix=color.shape[0],
                        counts=count is not None, kwargs=kwargs)
        return original(responses, pid, color, count, lum2, **kwargs)

    fe.frame_end = keep
    try:
        run()
    finally:
        fe.frame_end = original
    return kept


def capture_tile_rays(torch, run):
    """Run ``run()`` with render/raygen.gen_rays wrapped: the arguments of
    its first call with a tile list, the tile list copied."""
    from digital_earth_tpu_torch.render import raygen

    original = raygen.gen_rays
    kept = {}

    def keep(*args, **kwargs):
        if not kept and args[-1] is not None:
            kept["args"] = (*args[:-1], args[-1].clone())
        return original(*args, **kwargs)

    raygen.gen_rays = keep
    try:
        run()
    finally:
        raygen.gen_rays = original
    return kept


def _clone_state(st):
    from digital_earth_tpu_torch.render import pathtracer as pt

    return pt.TraceState(**{k: v.clone() for k, v in vars(st).items()})


def _per_bounce(pt):
    """The package's run_bounces with one launch per bounce (window_at=0)."""
    return functools.partial(pt.run_bounces, window_at=0)


def capture_states(torch, dev, atlas, luts, bounces=None, scene=SCENE, cfg=None):
    """One spp of ``scene``'s 1920x1080 frame through the kernels on
    ``atlas`` (at the TraceConfig ``cfg``, default the default), one launch
    per bounce. Keeps the bounce's full input state and live list at each of
    ``bounces`` (None: every bounce), the alive vectors the deepest bounce's
    compaction saw, and the frame's end-of-sweep state: (states, deepest,
    frame_end arguments). Works with this checkout's package and with an
    earlier one's (``--path-bench``)."""
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.renderer import Renderer

    states, deepest = {}, {}
    run_bounce, run_bounces = pt.run_bounce, pt.run_bounces

    def keep_state(st, idx, b, *args):
        if len(args) > 5 and args[5] is not None:  # the live count on the device
            idx = idx[: int(args[5])]
        deepest.update(bounce=b, alive=st.alive.clone(), work_class=st.work_class.clone())
        if bounces is None or b in bounces:
            states[b] = dict(st=_clone_state(st), idx=idx.clone(), args=args[:4])
        return run_bounce(st, idx, b, *args)

    pt.run_bounce, pt.run_bounces = keep_state, _per_bounce(pt)
    try:
        r = Renderer(dev, image_res=RES, atlas=atlas, luts=luts,
                     **({} if cfg is None else {"cfg": cfg}))
        apply_config(r, load_config(scene))
        frame_end_args = capture_frame_end(torch, r.accumulate)
        torch.cuda.synchronize()
    finally:
        pt.run_bounce, pt.run_bounces = run_bounce, run_bounces
    if bounces is not None and set(states) != set(bounces):
        fail(f"the capture frame did not reach bounces {bounces}: {sorted(states)}")
    return states, deepest, frame_end_args


def capture_inputs(torch, dev, atlas, luts):
    """One spp of the main path's frame through the kernels
    (``capture_states`` at bounces 0 and DEEP_BOUNCE). Then runs the
    bounce's plain twin on the card on each kept state (its tracker calls
    launch the tracker kernels), keeping its output and, per tracker call
    kind, a copy of the arguments of the call with the most active lanes,
    bounce 0's arguments of the two table lookups (the flight's segment
    integrals, the NEE origins' transmittance), its surface points (the
    material tap's) and the arguments of each of its land-march calls.
    Returns (tracker arguments, bounce states, deepest alive vectors, lookup
    arguments, frame_end arguments)."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    states, deepest, frame_end_args = capture_states(torch, dev, atlas, luts)
    if not {0, DEEP_BOUNCE} <= set(states):
        fail(f"the capture frame did not reach bounces 0 and {DEEP_BOUNCE}: {sorted(states)}")
    captured, lookups = {}, {}
    state = {"bounce": None}
    originals = {name: getattr(pt, name) for name in
                 ("intersect_land", "delta_track_rmo", "track_cloud", "spectral_flight_weights",
                  "sample_transmittance", "get_land_material")}
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def keep(kind, args, kwargs, active):
        key = (kind, state["bounce"])
        n_act = int(active.sum())
        if key not in captured or n_act > captured[key][0]:
            captured[key] = (n_act, tuple(map(copy, args)),
                             {k: copy(v) for k, v in kwargs.items()})

    def land(*args, **kwargs):
        kind = "land_march/any_hit" if kwargs.get("any_hit") else "land_march"
        keep(kind, args, kwargs, args[4])
        if state["bounce"] == 0:
            lookups.setdefault("marches", []).append(
                (tuple(map(copy, args)), {k: copy(v) for k, v in kwargs.items()}))
        return originals["intersect_land"](*args, **kwargs)

    def rmo(*args, **kwargs):
        keep("rmo_delta_track", args, kwargs, args[6])
        return originals["delta_track_rmo"](*args, **kwargs)

    def cloud(*args, **kwargs):
        keep(f"cloud_track/{kwargs['mode']}", args, kwargs, args[7])
        return originals["track_cloud"](*args, **kwargs)

    def flight(*args):
        if state["bounce"] == 0:
            lookups["flight"] = tuple(map(copy, args))
        return originals["spectral_flight_weights"](*args)

    def nee(*args, **kwargs):
        if state["bounce"] == 0:
            lookups["nee"] = tuple(map(copy, args))
        return originals["sample_transmittance"](*args, **kwargs)

    def material(atlas_, land_pos, bilinear=True):
        if state["bounce"] == 0:
            lookups["surface"] = land_pos.clone()
        return originals["get_land_material"](atlas_, land_pos, bilinear)

    (pt.intersect_land, pt.delta_track_rmo, pt.track_cloud, pt.spectral_flight_weights,
     pt.sample_transmittance, pt.get_land_material) = (land, rmo, cloud, flight, nee, material)
    try:
        for b in (0, DEEP_BOUNCE):
            c = states[b]
            state["bounce"] = b
            c["twin"] = pt.run_bounce_plain(c["st"].take(c["idx"].long()), b, *c["args"])
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(pt, name, fn)
    kinds = sorted({kind for kind, _ in captured})
    print(f"captured at {RES[0]}x{RES[1]}: the bounce's state and live list at bounces "
          f"{sorted(states)} ({', '.join(str(c['idx'].numel()) for _, c in sorted(states.items()))}"
          f" live lanes), the deepest bounce's alive vector (bounce {deepest['bounce']}); "
          f"from the plain twin's run: "
          + ", ".join(f"{k}@{b} ({captured[(k, b)][0]} active)" for k, b in sorted(captured)))
    if {k.split("/")[0] for k in kinds} != {"land_march", "rmo_delta_track", "cloud_track"}:
        fail(f"the plain twin's run did not reach every tracker kernel: {kinds}")
    return captured, states, deepest, lookups, frame_end_args


def _t_close(torch, a, b):
    return (a - b).abs() <= T_RTOL * torch.clamp(b.abs(), min=1e4)


def compare_kernels(torch, captured, tf):
    """Each kernel against its plain twin on the captured inputs, lane by
    lane: (rows for the JSON line, True if all agree); the trackers'
    operations with threefry's at the SASS census ``tf``."""
    from digital_earth_tpu_torch.render import tracers

    rows = {}
    for (kind, b), (n_act, args, kwargs) in sorted(captured.items()):
        base = kind.split("/")[0]
        kern_fn, plain_fn = {
            "land_march": (tracers.intersect_land, tracers.intersect_land_plain),
            "rmo_delta_track": (tracers.delta_track_rmo, tracers.delta_track_rmo_plain),
            "cloud_track": (tracers.track_cloud, tracers.track_cloud_plain),
        }[base]
        # the trackers' iterations at bounce 0 for their operations bound:
        # counted by the compared twin run itself (one indexed add per
        # iteration of its loop, within its plain ms)
        n = args[1].shape[0]
        trips = (torch.zeros(n, dtype=torch.int32, device=args[1].device)
                 if b == 0 and base != "land_march" else None)
        count = {} if trips is None else {"trips": trips}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p_out = plain_fn(*args, **kwargs, **count)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        k_out = kern_fn(*args, **kwargs)
        start.record()
        for _ in range(5):
            kern_fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5

        if base == "land_march":
            kh, ph = k_out >= 0, p_out >= 0
            same = kh == ph
            both = kh & ph
            lane_ok = same & (~both | _t_close(torch, k_out, p_out))
            err = (k_out - p_out).abs()[both]
            rel = err / p_out[both].clamp(min=1e4)
            what = f"hit/miss equal {same.float().mean().item():.7f}"
        elif kind == "cloud_track/ratio":
            diff = (k_out - p_out).abs()
            lane_ok = diff <= RATIO_ATOL + RATIO_RTOL * p_out.abs()
            err = diff
            rel = diff / p_out.abs().clamp(min=RATIO_ATOL)
            what = f"mean trans {k_out.mean().item():.6f} vs {p_out.mean().item():.6f}"
        else:
            same = k_out[0] == p_out[0]
            if base == "rmo_delta_track":
                same = same & (k_out[2] == p_out[2])  # species
            ev = same & (p_out[0] > 0)
            lane_ok = same & (~ev | _t_close(torch, k_out[1], p_out[1]))
            err = (k_out[1] - p_out[1]).abs()[ev]
            rel = err / p_out[1][ev].abs().clamp(min=1e4)
            what = f"event equal {same.float().mean().item():.7f}"
        n = lane_ok.numel()
        agree = lane_ok.float().mean().item()
        max_abs = err.max().item() if err.numel() else 0.0
        max_rel = rel.max().item() if rel.numel() else 0.0
        ok = agree >= MIN_LANE_AGREEMENT
        print(f"{kind:20s} bounce {b}: {n} lanes ({n_act} active)  {what}  "
              f"lanes agreeing {agree:.7f} ({n - int(lane_ok.sum())} not)  "
              f"max abs err {max_abs:.3e}  max rel err {max_rel:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
        row = rows.setdefault(base, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, ok=True,
                                         bytes=0, ops=None, int_ops=0.0, fma_ops=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], max_abs)
        row["ok"] = row["ok"] and ok
        if b == 0:  # the bounce-0 wavefront carries most of the frame's work
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            # each input read once, each output written once; the trackers'
            # operations from their iterations on these inputs (the twin's
            # count); the march's depend on trip counts this run does not see
            if base == "land_march":  # topo; pos, dir, active, t_cap; t
                row["bytes"] += args[0].numel() + 33 * n
                continue
            if base == "rmo_delta_track":  # keys, pos, dir, span, ext_h, active; event, t, iid
                row["bytes"] += 65 * n
                cfg, site = args[7], 2
            else:  # clouds; keys, pos, dir, span, ext_w, active; (event, t) or trans
                row["bytes"] += args[6].numel() + 45 * n + (4 if "ratio" in kind else 8) * n
                cfg, site = args[8], 1
            other, int_ops, fma_ops = tracker_ops(torch, trips, cfg.tracking_k, site, tf)
            ops = other + int_ops + fma_ops
            row["ops"] = (row["ops"] or 0.0) + ops
            row["int_ops"] += int_ops
            row["fma_ops"] += fma_ops
            print(f"{kind:20s} bounce {b}: {int(trips.sum())} iterations ({int((trips > 0).sum())} "
                  f"lanes), {ops:.4g} operations ({int_ops:.4g} threefry ALU-pipe, {fma_ops:.4g} "
                  f"FMA-pipe): bound {bound(0, ops, int_ops=int_ops, fma_ops=fma_ops)[0]:.4f} ms "
                  f"(operations; {bound(0, ops)[0]:.4f} all at the FP32 rate)")
    return rows


def _event_ms(torch, fn, reps):
    """Mean ms of ``reps`` launches timed one by one, CUDA events: ``fn()``
    prepares a launch outside the timed region and returns it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        launch = fn()
        torch.cuda.synchronize()
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


BOUNCE_FIELDS = ("pos", "direction", "throughput", "radiance", "w_mis")


def lanes_not_bit_equal(torch, got, want):
    """The lanes of two states (the same lanes) that differ in any bit of
    any field the bounce writes."""
    diff = torch.zeros_like(want.alive)
    for name in BOUNCE_FIELDS + ("alive", "primary_miss", "work_class"):
        g, w = getattr(got, name), getattr(want, name)
        ne = g.view(torch.int32) != w.view(torch.int32) if g.is_floating_point() else g != w
        diff |= ne if ne.dim() == 1 else ne.any(-1)
    return int(diff.sum())


def _hold_lanes(torch, got, want, entered, label, exact=False):
    """Kernel state ``got`` against the twin's ``want`` on the same lanes:
    the outcome (alive, primary_miss, work_class) and every value under the
    bounce's gates, lane by lane, printed; fails below BOUNCE_AGREEMENT, and
    with ``exact`` if any lane differs from the twin's in any bit.
    ``entered`` are the lanes' work classes before. Returns the largest
    radiance error."""
    m = want.alive.numel()
    not_exact = lanes_not_bit_equal(torch, got, want)
    outcome = ((got.alive == want.alive) & (got.primary_miss == want.primary_miss)
               & (got.work_class == want.work_class))
    lane_ok = outcome.clone()
    errs = {}
    for name in BOUNCE_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        atol = 1e-6 * w[outcome].abs().max().clamp(min=1e-30)
        if name == "direction":
            close = ((g - w).abs() <= DIR_ANGLE).all(-1)
        else:
            close = ((g - w).abs() <= BOUNCE_RTOL * w.abs() + atol).all(-1)
        lane_ok &= close
        d = (g - w)[outcome].abs()
        rel = (d / w[outcome].abs().clamp(min=atol))[close[outcome]]
        errs[name] = (d.max().item() if d.numel() else 0.0, rel.max().item() if rel.numel() else 0.0)
    share_outcome = outcome.float().mean().item()
    share = lane_ok.float().mean().item()
    ok = share_outcome >= BOUNCE_AGREEMENT and share >= BOUNCE_AGREEMENT
    ok = ok and not (exact and not_exact)
    live_after = int(got.alive.sum())
    classes = torch.bincount(got.work_class[got.alive].long(), minlength=3).tolist()
    print(f"{label}: {m} live lanes; {live_after} alive after, next classes (cloud, gas, "
          f"surface) {classes}; same alive/primary_miss/work_class {share_outcome:.7f} "
          f"({m - int(outcome.sum())} not); same outcome and values within rtol {BOUNCE_RTOL} "
          f"(direction {DIR_ANGLE} absolute) {share:.7f} ({m - int(lane_ok.sum())} not); max "
          "abs err " + ", ".join(f"{k} {v[0]:.3e}" for k, v in errs.items())
          + "; max rel err on agreeing lanes "
          + ", ".join(f"{k} {v[1]:.3e}" for k, v in errs.items())
          + f"; bit-equal on all but {not_exact} lanes  {'ok' if ok else 'FAIL'}")
    if not bool(lane_ok.all()):
        # the stage of the lanes that disagree: the class they entered the
        # bounce with and the twin's next class (alive lanes only)
        bad = ~lane_ok
        nxt = want.work_class[bad & want.alive].long().clamp(0, 2)
        print(f"{label}: lanes not agreeing by entering class (cloud, gas, surface) "
              f"{torch.bincount(entered[bad].long().clamp(0, 2), minlength=3).tolist()}, by the "
              f"twin's next class {torch.bincount(nxt, minlength=3).tolist()} "
              f"({int((bad & ~want.alive).sum())} dead in the twin)")
    if not ok:
        fail(f"{label} disagrees with its plain twin")
    return errs["radiance"][0]


def _bounce_ms(torch, st0, launch, reps=3):
    """Mean ms of ``launch(st)`` on a fresh copy of ``st0`` each time."""
    def prepared():
        st = _clone_state(st0)
        return lambda: launch(st)

    return _event_ms(torch, prepared, reps)


def check_bounce(torch, states):
    """The path's wide-bounce kernels (bounce_flight + bounce_shade) against
    their plain twin on the captured states with a twin (bounces 0 and
    DEEP_BOUNCE), lane by lane over the live list; bounce 0's times of the
    pair and of each half, and the entries' registers and resident warps.
    Returns the bounce_flight and bounce_shade JSON rows (bounce 0's times;
    the halves share the whole bounce's twin and error)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import pathtracer as pt

    rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            for name in ("bounce_flight", "bounce_shade")}
    for b in sorted(b for b, c in states.items() if "twin" in c):
        c = states[b]
        idx, st0, args = c["idx"], c["st"], c["args"]
        m = idx.numel()
        frame = pt.BounceFrame(st0, *args)
        ka = lambda s: pt._kernel_args(s, idx, b, *args, frame)  # noqa: E731
        st = _clone_state(st0)
        pt.run_bounce(st, idx, b, *args, frame)
        torch.cuda.synchronize()
        flight = kernels.bounce_flight(*ka(_clone_state(st0)))
        t = {"pair": _bounce_ms(torch, st0, lambda s: pt.run_bounce(s, idx, b, *args, frame)),
             "flight": _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s))),
             "shade": _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))}
        print(f"bounce {b} ({m} lanes): bounce_flight + bounce_shade {t['pair']:.3f} ms "
              f"(bounce_flight {t['flight']:.3f}, bounce_shade {t['shade']:.3f})")
        err = _hold_lanes(torch, st.take(idx.long()), c["twin"], st0.work_class[idx.long()],
                          f"bounce {b}", exact=True)
        for row in rows.values():
            row["max_abs_err"] = max(row["max_abs_err"], err)
        if b == 0:
            _, plain_ms = _plain_ms(
                torch, lambda: pt.run_bounce_plain(st0.take(idx.long()), b, *args))
            print(f"bounce 0 plain twin (eager PyTorch + the tracker kernels): {plain_ms:.1f} ms")
            # the flight reads pos, dir, the hero wavelength, the key and the
            # list entry (40 B) and writes its 16 B outcome; the shade reads
            # the state and the outcome, and writes the state
            rows["bounce_flight"].update(ms=t["flight"], plain_ms=plain_ms, bytes=(40 + 16) * m)
            rows["bounce_shade"].update(ms=t["shade"], plain_ms=plain_ms,
                                        bytes=(BOUNCE_LANE_BYTES + 16) * m)
    for name, occ in bounce_registers(kernels).items():
        print(f"occupancy {name}: {occ['registers']} registers, {occ['local_bytes']} B local per "
              f"thread, spill stores {occ['spill_stores']} B, loads {occ['spill_loads']} B "
              f"(ptxas); {occ['warps_per_sm']} resident warps per SM")
    return rows


def bounce_registers(kernels):
    """Per bounce entry (``kernels.OCCUPANCY_ENTRIES``, the timed instances):
    registers and local bytes per thread and resident warps per SM
    (``kernels.bounce_occupancy``), and the spill stores and loads in bytes
    from ptxas's report of bounce.cu (the default instances: L = 4, the
    closed-form transmittance, not the options instance) of
    ``<entry>_kernel<L>`` with up to four more 0 arguments (not a census
    instance, ``<L, 1, ...>``, nor a knob instance, its OPTS argument not
    0, nor bounce_shade's BLOCK instance). None where this process did not
    build the kernels (no report); fails where it did and an entry's spill
    line is missing."""
    import re

    log = kernels.ptxas_log.get("bounce.cu", "")
    entries = ptxas_entries(log)
    spills = {}
    for n in kernels.OCCUPANCY_ENTRIES:
        name = next((k for k in entries if re.fullmatch(rf"{n}_kernel<\d+(?:,0){{0,4}}>", k)), None)
        if name is not None and entries[name][1] is not None:
            spills[n] = tuple(entries[name][1:])
    if log and set(spills) != set(kernels.OCCUPANCY_ENTRIES):
        fail(f"ptxas's report of bounce.cu has no spill line for "
             f"{sorted(set(kernels.OCCUPANCY_ENTRIES) - set(spills))}")
    out = {}
    for name in kernels.OCCUPANCY_ENTRIES:
        occ = kernels.bounce_occupancy(name)
        stores, loads = spills.get(name, (None, None))
        out[name] = dict(registers=occ["registers"], local_bytes=occ["local_bytes"],
                         warps_per_sm=occ["warps_per_sm"], spill_stores=stores,
                         spill_loads=loads)
    return out


# the sources whose entries' registers and spills --path-bench reports
PTXAS_SOURCES = ("bounce.cu", "bounce_l1.cu", "bounce_ratio.cu", "bounce_l1_ratio.cu",
                 "rmo_delta_track.cu", "rmo_ratio_track.cu", "cloud_track.cu", "gen_rays.cu",
                 "preview.cu", "threefry_check.cu")


def ptxas_entries(log):
    """{entry: [registers, spill stores, spill loads]} of the kernels in
    one source's ptxas report (``-Xptxas -v``), each named by its mangled
    name's identifier and template arguments (``bounce_shade_kernel<4,0>``;
    None where the report has no such line); device functions are left
    out."""
    import re

    out, entry, props = {}, None, None
    for line in log.splitlines():
        got = re.search(r"Compiling entry function '(\S+)'", line)
        if got:
            entry = got[1]
            continue
        got = re.search(r"Function properties for (\S+)", line)
        if got:
            props = got[1]
            continue
        got = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if got and props:
            out.setdefault(props, [None, None, None])[1:] = [int(got[1]), int(got[2])]
            props = None
            continue
        got = re.search(r"Used (\d+) registers", line)
        if got and entry:
            out.setdefault(entry, [None, None, None])[0] = int(got[1])
            entry = None
    named = {}
    for mangled, row in out.items():
        got = re.match(r"_ZN2de\d+(\w+?_kernel)(I.*?E)?E", mangled)
        if got is None:  # a device function's properties
            continue
        named[got[1] + ("<" + ",".join(re.findall(r"L[ib](\d+)E", got[2])) + ">"
                        if got[2] else "")] = row
    return named


def _graph_ms(torch, fn, reps=20):
    """Device ms per call of ``fn()``: ``reps`` calls captured in one CUDA
    graph and replayed between two events, so no host time lies between
    the launches."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _census(torch, st0, idx, b, args, frame):
    """The census instances of bounce_flight and bounce_shade on a copy of
    ``st0``: ((m, sites) trips, the state they left, (m, sites + 2) clock64
    cycles), sites the package's ``kernels.BOUNCE_SITES``."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import pathtracer as pt

    st = _clone_state(st0)
    m = idx.numel()
    trips = torch.empty((m, kernels.BOUNCE_SITES), dtype=torch.int32, device=idx.device)
    cycles = torch.empty((m, kernels.BOUNCE_CYCLE_COLS), dtype=torch.int64, device=idx.device)
    kw = dict(trips=trips, cycles=cycles)
    ka = pt._kernel_args(st, idx, b, *args, frame)
    kernels.bounce_shade(*ka, flight=kernels.bounce_flight(*ka, **kw), **kw)
    return trips, st, cycles


def warp_cycles(torch, cycles, warp=32):
    """The census's clock64 columns summed over the launch's warps (32
    consecutive list entries): a warp spends at a site the most cycles any
    of its threads spent there (its lanes wait on one another), and in a
    kernel its longest thread's. A float64 tensor of the columns."""
    m = cycles.shape[0]
    pad = (-m) % warp
    c = torch.cat([cycles, cycles.new_zeros((pad, cycles.shape[1]))])
    return c.view(-1, warp, c.shape[1]).amax(1).sum(0).to(torch.float64)


CENSUS_SITES = 7  # the census's loop sites (the package's kernels.BOUNCE_SITES)


def cycle_split(torch, cycles):
    """The bounce's time by the census's clock64 columns (``warp_cycles``;
    the seven sites, then the two kernels' whole, then, where the package's
    census has it, bounce_shade's surface branch): (each site's share of
    the two kernels' summed warp cycles, the surface branch's after them,
    bounce_flight's share, bounce_shade's, that sum). A package whose
    census has six sites (no NEE RMO column) gives six."""
    per_warp = cycles if cycles.dim() == 1 else warp_cycles(torch, cycles)
    n = CENSUS_SITES if per_warp.numel() > CENSUS_SITES + 1 else per_warp.numel() - 2
    total = float(per_warp[n] + per_warp[n + 1])
    shares = [float(x) / total for x in per_warp.tolist()]
    return shares[:n] + shares[n + 2:], shares[n], shares[n + 1], total


def split_text(split):
    sites, flight, shade, total = split
    names = ("pre-march", "cloud", "RMO", "march after", "shadow march", "NEE cloud", "NEE RMO",
             "surface branch")
    return (f"flight {flight:.3f} (" + ", ".join(f"{n} {x:.3f}" for n, x in zip(names[:4], sites))
            + f", rest {flight - sum(sites[:4]):.3f}), shade {shade:.3f} ("
            + ", ".join(f"{n} {x:.3f}" for n, x in zip(names[4:], sites[4:]))
            + f", rest {shade - sum(sites[4:]):.3f}) of {total:.4g} warp cycles")


def _states_equal(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("pos", "direction", "throughput", "radiance", "w_mis", "alive",
                "primary_miss", "work_class"))


def check_census(torch, states):
    """A's census: at bounces 0 and DEEP_BOUNCE the census instances of
    bounce_flight and bounce_shade leave the timed instances' state bit for
    bit, and their trip counts at the seven loop sites equal those of the
    twin's plain loops (run_bounce_plain(trips=...), on the card) on all but
    a share 1 - BOUNCE_AGREEMENT of the lanes (where a plain loop and its
    kernel part on an ulp). Returns {bounce: kernel trips}."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    out = {}
    for b in (0, DEEP_BOUNCE):
        c = states[b]
        idx, st0, args = c["idx"], c["st"], c["args"]
        frame = pt.BounceFrame(st0, *args)
        k_trips, st_census, _ = _census(torch, st0, idx, b, args, frame)
        st_timed = _clone_state(st0)
        pt.run_bounce(st_timed, idx, b, *args, frame)
        same_state = _states_equal(torch, st_census, st_timed)
        p_trips = torch.zeros_like(k_trips)
        t0 = time.time()
        pt.run_bounce_plain(st0.take(idx.long()), b, *args, trips=p_trips)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        lane_eq = (k_trips == p_trips).all(1)
        share = lane_eq.float().mean().item()
        m = idx.numel()
        per_site = ", ".join(
            f"{name} {k_trips[:, j].float().mean().item():.3f}/{p_trips[:, j].float().mean().item():.3f}"
            f" (max {int(k_trips[:, j].max())})" for j, name in enumerate(pt.CENSUS_SITES))
        ok = same_state and share >= BOUNCE_AGREEMENT
        print(f"census bounce {b}: {m} lanes; the census instance leaves the timed instance's "
              f"state bit for bit {same_state}; trip counts equal to the twin's plain loops on "
              f"{share:.7f} of lanes ({m - int(lane_eq.sum())} not); mean trips per lane kernel/"
              f"twin: {per_site}  (twin {plain_s:.1f} s)  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the bounce census disagrees with the twin's loops at bounce {b}")
        out[b] = k_trips
    return out


def bounce_table(torch, states, cfg, tf=None):
    """The per-bounce table of the captured Apollo frame: per bounce the live
    lanes, the package's run_bounce's ms (one bounce, all its launches) and
    ns per lane, and with the SASS census ``tf`` (``tf_ops``) the census's
    columns: the bounds (bytes, operations from the census's trips), the
    mean trips and SIMT efficiency of each loop site. Returns {bounce:
    row}."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    table = {}
    # over the spp: lanes with trips per site, warp cycles
    calls, spp_cycles = [0] * len(pt.CENSUS_SITES), 0.0
    for b, c in sorted(states.items()):
        idx, st0, args = c["idx"], c["st"], c["args"]
        m = idx.numel()
        if m == 0:
            continue
        frame = pt.BounceFrame(st0, *args)
        row = dict(live=m)
        row["ms"] = _bounce_ms(torch, st0, lambda s: pt.run_bounce(s, idx, b, *args, frame))
        if tf:
            trips, _, cycles = _census(torch, st0, idx, b, args, frame)
            calls = [a + n for a, n in zip(calls, (trips > 0).sum(0).tolist())]
            spp_cycles = spp_cycles + warp_cycles(torch, cycles)
            other, int_ops, fma_ops = bounce_ops(torch, trips, cfg.march_k, cfg.tracking_k, tf)
            ops = other + int_ops + fma_ops
            row["march_simt"] = march_simt(torch, trips, cfg.march_k)
            row["tracker_simt"] = tracker_simt(torch, trips)
            row["split"] = cycle_split(torch, cycles)
            row.update(ops=ops, int_ops=int_ops, fma_ops=fma_ops,
                       ops_ms=bound(0, ops, int_ops=int_ops, fma_ops=fma_ops)[0],
                       bytes_ms=BOUNCE_LANE_BYTES * m / PEAK_BYTES * 1e3,
                       trips=[round(x, 3) for x in trips.float().mean(0).tolist()],
                       simt=simt_efficiency(torch, trips))
        row["ns_per_lane"] = row["ms"] * 1e6 / m
        table[b] = row
        extra = ""
        if tf:
            simt = " ".join("-" if e is None else f"{e:.2f}" for e in row["simt"])
            extra = (f"  bound {max(row['ops_ms'], row['bytes_ms']):.4f} ms (ops "
                     f"{row['ops_ms']:.4f}, bytes {row['bytes_ms']:.4f})  mean trips "
                     f"{row['trips']}  SIMT eff {simt}")
        print(f"per-bounce {b:2d}: {m:8d} live  {row['ms']:.3f} ms  {row['ns_per_lane']:.2f} "
              f"ns/lane{extra}")
        if tf:
            print(f"per-bounce {b:2d} cycle split (census, clock64 warp cycles): "
                  f"{split_text(row['split'])}; "
                  f"{simt_text(row['march_simt'], row['tracker_simt'])}")
    if tf:
        print(f"census over the spp (every bounce one launch each): lanes taking trips per site "
              f"{dict(zip(pt.CENSUS_SITES, calls))} per spp, x 3 per 3 spp; cycle split "
              + split_text(cycle_split(torch, spp_cycles)))
    return table


def tracker_simt(torch, trips, warp=32):
    """SIMT efficiency of the trackers at TRACKER_SITES (cloud, RMO, NEE
    cloud, NEE RMO where the census has it): a thread runs its lane's
    iterations (csrc/cloud_track.cuh, rmo_track.cuh), so a warp's slots are
    32 a trip of its longest lane, as ``simt_efficiency`` counts them."""
    simt = simt_efficiency(torch, trips, warp)
    return [simt[site] for site in TRACKER_SITES if site < len(simt)]


def lanes_per_warp(torch, trips, warp=32):
    """Tracking lanes per warp at the NEE RMO site: the census's (m, sites)
    trips cut into the launch's warps (32 consecutive list entries); entry
    c counts the warps with c lanes that took trips there, c = 0 ... 32."""
    col = trips[:, NEE_RMO]
    col = torch.cat([col, col.new_zeros((-col.numel()) % warp)])
    return torch.bincount((col.view(-1, warp) > 0).sum(1), minlength=warp + 1).tolist()


def per_warp_text(hist):
    """``lanes_per_warp``'s histogram in bins, and the share of tracking
    lanes in warps of at most 16: those whose warp leaves a thread or more
    to each of them, which a design that spreads a lane's probes over a
    warp's idle threads could take (PERF.md §6)."""
    lanes = sum(c * w for c, w in enumerate(hist))
    sparse = sum(c * w for c, w in enumerate(hist[:17]))
    bins = ((0, 0), (1, 2), (3, 4), (5, 8), (9, 16), (17, 32))
    return ("tracking lanes per warp (warps) " + ", ".join(
        f"{a}-{b} {sum(hist[a:b + 1])}" for a, b in bins)
        + f"; {sparse / max(lanes, 1):.3f} of the tracking lanes in warps of at most 16")


def simt_text(march, tracker):
    return ("the land march's SIMT eff as launched (pre, after, shadow) "
            + " ".join("-" if e is None else f"{e:.2f}" for e in march)
            + "; the trackers' (cloud, RMO, NEE cloud, NEE RMO) "
            + " ".join("-" if e is None else f"{e:.2f}" for e in tracker))


def _bounce_and_twin(torch, c, b):
    """On the live lanes of the captured state ``c`` of bounce ``b``: the
    state run_bounce leaves, the state run_bounce_plain leaves, and the
    census instances' (m, sites) trips and (m, sites + 2) cycles."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    idx, st0, args = c["idx"], c["st"], c["args"]
    frame = pt.BounceFrame(st0, *args)
    lanes = idx.long()
    st = _clone_state(st0)
    pt.run_bounce(st, idx, b, *args, frame)
    trips, _, cycles = _census(torch, st0, idx, b, args, frame)
    return st.take(lanes), pt.run_bounce_plain(st0.take(lanes), b, *args), trips, cycles


def check_scenes(torch, dev, atlas, luts):
    """florida and sunset hurricane (1920x1080, default TraceConfig) at
    bounces 0 and DEEP_BOUNCE of one spp: bounce_flight + bounce_shade
    against run_bounce_plain, every lane bit-equal; the census's cycle
    split and SIMT efficiency per loop site (Apollo's are in the per-bounce
    table)."""
    for name in OTHER_SCENES:
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE),
                                      scene=os.path.join(ROOT, "scenes", name))
        for b, c in sorted(states.items()):
            got, want, trips, cycles = _bounce_and_twin(torch, c, b)
            _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                        f"{name[9:-4]} bounce {b}", exact=True)
            simt = " ".join("-" if e is None else f"{e:.2f}" for e in simt_efficiency(torch, trips))
            k = c["args"][3].march_k
            print(f"census {name[9:-4]} bounce {b}: {c['idx'].numel()} live; SIMT eff {simt}; "
                  f"{simt_text(march_simt(torch, trips, k), tracker_simt(torch, trips))}; "
                  f"cycle split {split_text(cycle_split(torch, cycles))}")
        del states


# The reference's own estimator (TraceConfig): one wavelength a path,
# independent uniform primary samples, the gases' sun transmittance by ratio
# tracking; and each option alone.
REF_ESTIMATOR = dict(hero_lambdas=1, stratify_spp=False, analytic_transmittance=False)
REF_OPTIONS = (("hero_lambdas=1", dict(hero_lambdas=1)),
               ("stratify_spp=False", dict(stratify_spp=False)),
               ("analytic_transmittance=False", dict(analytic_transmittance=False)),
               ("all three", REF_ESTIMATOR))


def capture_ratio_args(torch, c, b):
    """The arguments of the ratio tracker's call (the NEE lanes) in the
    bounce's plain twin, run on the card on the captured state ``c`` of
    bounce ``b`` with ``pathtracer.ratio_track_rmo`` wrapped, copied."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    original, kept = pt.ratio_track_rmo, {}

    def keep(*args):
        kept["args"] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        return original(*args)

    pt.ratio_track_rmo = keep
    try:
        pt.run_bounce_plain(c["st"].take(c["idx"].long()), b, *c["args"])
        torch.cuda.synchronize()
    finally:
        pt.ratio_track_rmo = original
    if "args" not in kept:
        fail(f"the twin's bounce {b} made no call of the ratio tracker")
    return kept["args"]


def check_ratio_track(torch, args, label, tf):
    """rmo_ratio_track against its twin on captured arguments: every lane's
    transmittance bit-equal, its iterations equal to the twin's loop count;
    timed, with its bound from bytes and from the operations of those
    iterations (threefry's at the integer rate, from the SASS census
    ``tf``). A JSON row."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracers

    keys, pos, d, t0, t1, ext, max_ext, active, cfg = args
    n, L = ext.shape[:2]
    kw = dict(max_steps=cfg.max_tracking_steps, k=cfg.tracking_k)
    (got, iters), ms = _time_ms(torch, lambda: kernels.rmo_ratio_track(
        keys, pos, d, t0, t1, ext, max_ext, active, iters=True, **kw), 5)
    trips = torch.zeros(n, dtype=torch.int32, device=pos.device)
    want = tracers.ratio_track_rmo_plain(*args, trips=trips)
    _, plain_ms = _plain_ms(torch, lambda: tracers.ratio_track_rmo_plain(*args))
    parted = int((got.view(torch.int32) != want.view(torch.int32)).any(-1).sum())
    same_iters = torch.equal(iters, trips)
    err = (got - want).abs().max().item()
    # keys, pos, dir, span, extinctions, majorant and the active flag read
    # once, the transmittance written
    nbytes = n * (8 + 24 + 8 + 12 * L + 4 + 1 + 4 * L)
    other, int_ops, fma_ops = tracker_ops(torch, iters, cfg.tracking_k, NEE_RMO, tf)
    ops = other + int_ops + fma_ops
    b_ms, b_by = bound(nbytes, ops, int_ops=int_ops, fma_ops=fma_ops)
    lanes = iters > 0
    ok = parted == 0 and same_iters
    print(f"rmo_ratio_track {label}: {n} lanes ({int(active.sum())} NEE, L = {L}, K = "
          f"{cfg.tracking_k}); transmittance bit-equal to the twin's on all but {parted} lanes, "
          f"iterations equal {same_iters}; mean trans {got.mean().item():.6f}; "
          f"{int(iters.sum())} iterations ({iters[lanes].float().mean().item():.3f} a tracked "
          f"lane, max {int(iters.max())}); kernel {ms:.4f} ms, plain {plain_ms:.1f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}; {ops:.4g} operations, {int_ops:.4g} threefry ALU-pipe, "
          f"{fma_ops:.4g} FMA-pipe; bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms); one thread a lane  {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"rmo_ratio_track disagrees with its plain twin ({label})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                int_ops=int_ops, fma_ops=fma_ops), iters


SPARSE_PER_WARP = (2, 4, 8, 16)  # tracking lanes a warp of the sparse launches


def ratio_args_per_warp(torch, args, c):
    """``rmo_ratio_track``'s first eight arguments with the tracking lanes
    of ``args`` (active, t_max >= 0, t_start < t_max) moved c to a warp of
    32, into its first c threads, in their order; every other thread
    inactive, on a copy of the first tracking lane."""
    keys, pos, d, t0, t1, ext, max_ext, active = args
    lanes = torch.nonzero(active & (t1 >= 0.0) & (t0 < t1)).squeeze(1)
    i = torch.arange(lanes.numel(), device=lanes.device)
    slot = (i // c) * 32 + i % c
    m = (-(-lanes.numel() // c)) * 32
    src = torch.full((m,), int(lanes[0]), dtype=torch.long, device=lanes.device)
    src[slot] = lanes
    act = torch.zeros(m, dtype=torch.bool, device=lanes.device)
    act[slot] = True
    return tuple(a[src].contiguous() for a in (keys, pos, d, t0, t1, ext, max_ext)) + (act,)


def check_reference_estimator(torch, dev, atlas, luts, tf):
    """The reference's own estimator (REF_ESTIMATOR) at 1920x1080:
    ``rmo_ratio_track`` against its twin on Apollo bounce 0's NEE lanes (at
    four wavelengths, the ratio tracking alone, and at one, all three
    options); the bounce entries' instances of the estimator against their
    twin on the three scenes at bounces 0 and DEEP_BOUNCE, every lane
    bit-equal, with the census's cycle split (the NEE RMO site's share) and
    the ratio tracker's iterations per NEE lane; ``gen_rays`` at each new
    mode against its twin; the path (``render_offline``, 3 spp) at the
    estimator under phase 6's gates, with the launch counts set to 0 before
    it and read after, and ``frame_end`` at one wavelength against its
    twin; the chunked, adaptive and mesh entry points bit-equal to the
    Renderer's spp; then s/spp of Apollo 11 at the default, each option alone and all
    three, and of florida and sunset at the default and all three, in this
    call; the tracker's bound from the SASS census ``tf``. Returns (the
    rmo_ratio_track row, the path's launch counts)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import raygen
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    card = nvidia_smi_line()
    ref = TraceConfig(**REF_ESTIMATOR)
    for label, cfg in (("analytic_transmittance=False", TraceConfig(analytic_transmittance=False)),
                       ("all three", ref)):
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), cfg=cfg)
        row, _ = check_ratio_track(torch, capture_ratio_args(torch, states[0], 0),
                                   f"Apollo 11 {RES[0]}x{RES[1]} bounce 0, {label} ({card})", tf)
        del states
    for scene in (SCENE, *(os.path.join(ROOT, "scenes", s) for s in OTHER_SCENES)):
        name = os.path.basename(scene)[9:-4]
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE),
                                      scene=scene, cfg=ref)
        for b, c in sorted(states.items()):
            got, want, trips, cycles = _bounce_and_twin(torch, c, b)
            _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                        f"reference estimator {name} bounce {b}", exact=True)
            nee = trips[:, NEE_RMO]
            if not bool((nee > 0).any()):
                fail(f"reference estimator {name} bounce {b}: no lane ran the ratio tracker")
            simt = simt_text(march_simt(torch, trips, ref.march_k), tracker_simt(torch, trips))
            print(f"census reference estimator {name} bounce {b}: {c['idx'].numel()} live; NEE RMO "
                  f"ratio tracking on {int((nee > 0).sum())} lanes, "
                  f"{nee[nee > 0].float().mean().item():.3f} iterations a lane (max "
                  f"{int(nee.max())}); {per_warp_text(lanes_per_warp(torch, trips))}; {simt}; "
                  f"cycle split {split_text(cycle_split(torch, cycles))} ({card})")
        del states
    r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts))
    for label, options in REF_OPTIONS[:2] + REF_OPTIONS[3:]:
        args = (r._seed_key, 0, 0, RES[0] * RES[1], RES, (1, RES[1]), r.camera_params(), luts,
                False, None, TraceConfig(**options))
        _hold_rays(torch, f"path {RES[0]}x{RES[1]} {label}", args)
    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    _hold_rays(torch, f"preview {PREVIEW_RES[0]}x{PREVIEW_RES[1]} stratify_spp=False",
               (r._seed_key, 0, 0, PREVIEW_RES[0] * PREVIEW_RES[1], PREVIEW_RES, r.block,
                r.camera_params(), luts, True, None, TraceConfig(stratify_spp=False)))
    del r
    # the estimator's path, through the entry point a user calls
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None, atlas=atlas,
                       luts=luts, cfg=ref)
    for _ in range(2):
        r.accumulate()
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_main_path(torch, counts, r, img, "reference estimator's path")
    # one wavelength a path: a hero whose CIE pdf is below the sampler's
    # 1e-3 cut has lambda_pdf 0, and its radiance is divided by the
    # denominator's 1e-12 floor, as in the reference (ROADMAP C #5)
    rays = raygen.gen_rays(r._seed_key, 0, 0, RES[0] * RES[1], RES, (1, RES[1]),
                           r.camera_params(), luts, False, None, ref)
    lum = r.color_buffer.sum(-1).flatten()
    top = torch.topk(lum, 8).values
    print(f"reference estimator's path: {int((rays.pdf == 0).sum())} of {RES[0] * RES[1]} lanes of "
          f"an spp with lambda_pdf 0; the buffer's 8 largest pixel sums {top.tolist()}, its mean "
          f"{r.color_buffer.mean().item():.6g}, without those 8 pixels "
          f"{(lum.sum() - top.sum()).item() / (3 * (lum.numel() - 8)):.6g}")
    del rays
    check_frame_end(torch, capture_frame_end(torch, r.accumulate),
                    f"path {RES[0]}x{RES[1]}, one wavelength a lane")
    del r, img
    # the other entry points at the estimator, each bit-equal to one
    # Renderer spp: a chunked spp, an adaptive pass over every tile, and a
    # (4, 1) mesh over this card
    from digital_earth_tpu_torch.parallel.mesh import MultiChipRenderer, make_render_mesh

    def spp(run, renderer):
        run(_apollo(renderer))
        torch.cuda.synchronize()
        return renderer.color_buffer

    want = spp(lambda r: r.accumulate(), Renderer(dev, image_res=RES, atlas=atlas, luts=luts,
                                                  seed=5, cfg=ref))
    same = {
        "accumulate_interruptible(3)": spp(lambda r: r.accumulate_interruptible(3), Renderer(
            dev, image_res=RES, atlas=atlas, luts=luts, seed=5, cfg=ref)),
        "accumulate_adaptive(frac=1)": spp(lambda r: r.accumulate_adaptive(frac=1.0), Renderer(
            dev, image_res=RES, atlas=atlas, luts=luts, seed=5, cfg=ref)),
        "MultiChipRenderer (4, 1)": spp(lambda r: r.accumulate(), MultiChipRenderer(
            make_render_mesh([dev] * 4, spp_axis=1), RES, atlas=atlas, luts=luts, seed=5,
            cfg=ref)),
    }
    same = {name: torch.equal(buf, want) for name, buf in same.items()}
    print(f"reference estimator's entry points at {RES[0]}x{RES[1]}, one spp bit-equal to "
          f"Renderer.accumulate(): {same}")
    if not all(same.values()):
        fail(f"an entry point at the reference estimator parts from the Renderer: {same}")
    del want
    # s/spp in this call: 1 warm-up spp, then 2 timed, each configuration
    runs = [(SCENE, label, options) for label, options in (("default", {}),) + REF_OPTIONS]
    runs += [(os.path.join(ROOT, "scenes", s), label, options) for s in OTHER_SCENES
             for label, options in (("default", {}), REF_OPTIONS[3])]
    for scene, label, options in runs:
        r = render_offline(load_config(scene), dev, spp=1, image_res=RES, out_path=None,
                           atlas=atlas, luts=luts, cfg=TraceConfig(**options))
        print(f"reference estimator s/spp {os.path.basename(scene)[9:-4]} {RES[0]}x{RES[1]} "
              f"{label}: {_spp_seconds(torch, r, 2):.5f} ({card})")
        del r
    return row, counts


# The scene and march options (render/params.SCENE_OPTIONS): each alone on
# the scene its CPU case uses (tests/test_torch_options.py), all seven off
# their defaults on the three scenes, and the five that act on land and
# clouds off their defaults with land and clouds on, on florida and sunset.
# Without land and clouds the other five have nothing to act on: all seven
# is the gases alone.
FLORIDA = os.path.join(ROOT, "scenes", "config - florida.txt")
SUNSET = os.path.join(ROOT, "scenes", "config - sunset hurricane.txt")
MARCH_FIVE = dict(bilinear_tracking=True, lazy_march=False, march_exact_ocean=False,
                  march_ref_phantom=False, march_stall_patience=0)
ALL_SEVEN = dict(enable_clouds=False, enable_land=False, **MARCH_FIVE)
OPTION_CASES = (("enable_clouds=False", dict(enable_clouds=False), SUNSET),
                ("enable_land=False", dict(enable_land=False), FLORIDA),
                ("bilinear_tracking=True", dict(bilinear_tracking=True), FLORIDA),
                ("lazy_march=False", dict(lazy_march=False), SUNSET),
                ("march_exact_ocean=False", dict(march_exact_ocean=False), FLORIDA),
                ("march_ref_phantom=False", dict(march_ref_phantom=False), SUNSET),
                ("march_stall_patience=0", dict(march_stall_patience=0), SUNSET))
ALL_SEVEN_CASES = tuple(("all seven", ALL_SEVEN, s) for s in (SCENE, FLORIDA, SUNSET))
FIVE_LABEL = "five with land and clouds"
FIVE_CASES = tuple((FIVE_LABEL, MARCH_FIVE, s) for s in (FLORIDA, SUNSET))
# the march's options, for the land_march launcher and the preview
MARCH_OPTIONS = tuple(c for c in OPTION_CASES if c[0].split("=")[0] in (
    "enable_land", "bilinear_tracking", "march_exact_ocean", "march_ref_phantom",
    "march_stall_patience")) + FIVE_CASES[:1]
# the (L, RATIO) sets of the bounce entries
ENTRY_SETS = (("L = 4, closed form", {}), ("L = 1, closed form", dict(hero_lambdas=1)),
              ("L = 4, ratio", dict(analytic_transmittance=False)),
              ("L = 1, ratio", dict(hero_lambdas=1, analytic_transmittance=False)))
# the options instances' sources: the bounce entries' sets, and the march
# and cloud launchers' and the preview's (beside their default instances)
# the bounce entries' estimator instances' sources (phase 8e)
FLOOR_SOURCES = ("bounce_floor.cu", "bounce_l1_floor.cu", "bounce_ratio_floor.cu",
                 "bounce_l1_ratio_floor.cu")
ESTIMATOR_SOURCES = ("bounce_est.cu", "bounce_l1_est.cu", "bounce_ratio_est.cu",
                     "bounce_l1_ratio_est.cu")
OPTIONS_SOURCES = ("bounce_opts.cu", "bounce_l1_opts.cu", "bounce_ratio_opts.cu",
                   "bounce_l1_ratio_opts.cu", "land_march.cu", "cloud_track.cu", "preview.cu")


def takes_options(options):
    """Whether a launch at ``options`` runs the options instance: a flag off
    its default (every instance takes the stall patience)."""
    return any(name != "march_stall_patience" for name in options)


def _one_launch(fn, options, run, what):
    """``run()``, failing unless it made one launch of ``fn``, of its
    options instance exactly when ``takes_options(options)``."""
    before = fn.launches, fn.options_launches
    out = run()
    made = fn.launches - before[0], fn.options_launches - before[1]
    if made != (1, int(takes_options(options))):
        fail(f"{what}: {made[0]} launches of {fn.__name__}, {made[1]} of its options instance")
    return out


def options_registers(kernels):
    """ptxas's registers and spill bytes of every options instance (its
    template's last argument 1, or the bounce sets' sources), printed with
    the default instances' beside them, and the resident warps of the
    options bounce entries and preview. {source: {entry: [regs, stores,
    loads]}}."""
    out = {}
    for src in OPTIONS_SOURCES + ("bounce.cu",):
        entries = ptxas_entries(kernels.ptxas_log.get(src, ""))
        out[src] = entries
        for name, (regs, stores, loads) in sorted(entries.items()):
            print(f"ptxas {src} {name}: {regs} registers, spill stores {stores} B, loads {loads} B")
    for name in kernels.OCCUPANCY_ENTRIES:
        d, o = kernels.bounce_occupancy(name), kernels.bounce_occupancy(name, options=True)
        print(f"occupancy {name}: default {d['registers']} registers, {d['warps_per_sm']} warps "
              f"per SM; options instance {o['registers']} registers, {o['local_bytes']} B local, "
              f"{o['warps_per_sm']} warps per SM")
    d, o = kernels.preview_occupancy(), kernels.preview_occupancy(options=True)
    print(f"occupancy preview: default {d['registers']} registers, {d['warps_per_sm']} warps per "
          f"SM; options instance {o['registers']} registers, {o['local_bytes']} B local, "
          f"{o['warps_per_sm']} warps per SM")
    return out


def bilinear_tap_extra(kernels):
    """The SASS instructions a bilinear 4-channel sphere tap adds to a
    nearest one, as the options rows' bounds count them per bilinear tap:
    the lower of the main bilinear body's difference and the first form's
    (the sphere_tap launcher's instances, ``tap_bodies``), both printed."""
    bodies = tap_bodies(kernels)
    near = len(bodies[("sphere", 4, "nearest")])
    bil, first = len(bodies[("sphere", 4, "bilinear")]), len(bodies[("sphere", 4, "first")])
    extra = min(bil, first) - near
    print(f"sphere tap SASS: nearest {near}, bilinear {bil} instructions: {bil - near} more a "
          f"bilinear tap (the first form {first - near}); the options rows' bounds count "
          f"{extra} more")
    return extra


def _option_probes(torch, trips, march_k):
    """The texture taps a floor counts in a bounce's census ``trips``: the
    march sites' probes and one a cloud iteration (sites 1 and 5)."""
    t = trips.to(torch.float64)
    march = sum(float(site_probes(torch, t[:, s], march_k).sum()) for s in MARCH_SITES)
    return march + float(t[:, 1].sum() + t[:, 5].sum())


def check_options(torch, dev, atlas, luts, captured, tf):
    """The scene and march options (OPTION_CASES, ALL_SEVEN_CASES,
    FIVE_CASES), at 1920x1080 on ``atlas``: the options instances' registers
    and spills; the bounce entries' instances the options take against their
    twin at bounces 0 and DEEP_BOUNCE, and bounce_window against
    run_window_plain from the bounce the frame enters it, every lane
    bit-equal; each (L, RATIO) options instance forced at the defaults
    bit-equal to the default instance (and timed beside it); the land_march
    and cloud_track launchers at the options on phase 4's arguments
    (``captured``) against their twins under phase 7's gates, as their
    default instances (their bit-equality printed); preview at the march
    options against march_paths_plain (phase 11's check); the path
    (``render_offline``, 3 spp) with all seven on Apollo 11 and with the five
    on florida under phase 6's gates, every bounce launch the options
    instance's; s/spp at each option against its scene's default
    (``spp_ratio``). Returns (the JSON rows of the options instances, named
    "<kernel>/options"; the launch counts of the path with the five; the
    preview frame's at bilinear_tracking)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import tracers
    from digital_earth_tpu_torch.render.params import TraceConfig

    card = nvidia_smi_line()
    options_registers(kernels)
    extra = bilinear_tap_extra(kernels)
    rows = {}
    # the default instances' times on each scene's default bounce 0, beside
    # the options instances' below
    default_ms = {}
    for scene in (SCENE, FLORIDA, SUNSET):
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=scene)
        c = states[0]
        frame = pt.BounceFrame(c["st"], *c["args"])
        ka = lambda s: pt._kernel_args(s, c["idx"], 0, *c["args"], frame)  # noqa: E731
        flight = kernels.bounce_flight(*ka(_clone_state(c["st"])))
        default_ms[scene] = (_bounce_ms(torch, c["st"], lambda s: kernels.bounce_flight(*ka(s))),
                             _bounce_ms(torch, c["st"],
                                        lambda s: kernels.bounce_shade(*ka(s), flight=flight)))
        del states, flight
    for label, options, scene in OPTION_CASES + ALL_SEVEN_CASES + FIVE_CASES:
        name = f"{os.path.basename(scene)[9:-4]}"
        cfg = TraceConfig(**options)
        states, _, _ = capture_states(torch, dev, atlas, luts, scene=scene, cfg=cfg)
        if 0 not in states:
            fail(f"options {label} {name}: the frame has no bounce 0")
        for b in (0, DEEP_BOUNCE):
            if b not in states:
                print(f"options {label} {name}: no live lane at bounce {b}")
                continue
            c = states[b]
            got, want, trips, _ = _bounce_and_twin(torch, c, b)
            _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                        f"options {label} {name} bounce {b}", exact=True)
            if not cfg.lazy_march and bool(trips[:, 3].any()):
                fail(f"options {label} {name} bounce {b}: a march after the flight")
            if b != 0:
                continue
            idx, st0, args = c["idx"], c["st"], c["args"]
            frame = pt.BounceFrame(st0, *args)
            ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
            flight = _one_launch(kernels.bounce_flight, options,
                                 lambda: kernels.bounce_flight(*ka(_clone_state(st0))),
                                 f"options {label} {name}")
            t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
            t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
            _, plain_ms = _plain_ms(torch, lambda: pt.run_bounce_plain(st0.take(idx.long()), 0,
                                                                        *args))
            d_f, d_s = default_ms[scene]
            m = idx.numel()
            probes = _option_probes(torch, trips, cfg.march_k) if cfg.bilinear_tracking else 0.0
            print(f"options {label} {name} bounce 0 ({m} lanes, {card}): bounce_flight "
                  f"{t_f:.3f} ms, bounce_shade {t_s:.3f} ms "
                  f"({'options' if takes_options(options) else 'default'} instances); the default "
                  f"instances at the default config on the same scene {d_f:.3f}, {d_s:.3f} ms; "
                  f"twin {plain_ms:.1f} ms; census taps {probes:.0f}")
            if label == FIVE_LABEL and "bounce_flight/options" not in rows:
                print(f"the options rows of bounce_flight and bounce_shade: {label} {name}")
                for part, ms in (("flight", t_f), ("shade", t_s)):
                    other, alu, fma = bounce_ops(torch, trips, cfg.march_k, cfg.tracking_k, tf,
                                                 part)
                    half = trips.clone()  # the part's own sites: 0-3 the flight's
                    if part == "flight":
                        half[:, 4:] = 0
                    else:
                        half[:, :4] = 0
                    taps = _option_probes(torch, half, cfg.march_k)
                    nbytes = ((40 + 16) * m if part == "flight" else (BOUNCE_LANE_BYTES + 16) * m)
                    # the lanes' bytes as the default rows count them (the
                    # textures' texels not counted), and the bilinear taps'
                    # extra instructions
                    rows[f"bounce_{part}/options"] = dict(
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                        ops=other + alu + fma + extra * taps, int_ops=alu, fma_ops=fma)
        # the window from the bounce at which the frame enters it
        bounces = sorted(states)
        n = states[0]["st"].alive.numel()
        counts = [states[b]["idx"].numel() for b in bounces] + [0]
        _, wb = pt.bounce_schedule(n, counts, kernels.window_threshold(dev), 0, cfg.max_bounces)
        if wb is not None and wb in states:
            c = states[wb]
            idx, st0, args = c["idx"], c["st"], c["args"]
            frame = pt.BounceFrame(st0, *args)
            st = _clone_state(st0)
            _one_launch(kernels.bounce_window, options,
                        lambda: pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame),
                        f"options {label} {name} bounce_window")
            twin = _clone_state(st0)
            t0 = time.time()
            pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
            torch.cuda.synchronize()
            w_plain = (time.time() - t0) * 1e3
            lanes = idx.long()
            _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                        f"options {label} {name} bounce_window from bounce {wb}", exact=True)
            w_ms = _bounce_ms(torch, st0, lambda s: pt.run_window(s, idx, wb, cfg.max_bounces,
                                                                    *args, frame))
            print(f"options {label} {name} bounce_window from bounce {wb} ({idx.numel()} lanes, "
                  f"{card}): {w_ms:.3f} ms; twin {w_plain:.1f} ms")
            if label == FIVE_LABEL and "bounce_window/options" not in rows:
                print(f"the options row of bounce_window: {label} {name}")
                rows["bounce_window/options"] = dict(max_abs_err=0.0, ms=w_ms, plain_ms=w_plain,
                                                     bytes=BOUNCE_LANE_BYTES * idx.numel(),
                                                     ops=None)
        else:
            print(f"options {label} {name}: the frame does not enter the window (live counts "
                  f"{counts[:-1]})")
        del states

    # each (L, RATIO) options instance forced at the defaults
    for label, options in ENTRY_SETS:
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE),
                                      cfg=TraceConfig(**options))
        for b, c in sorted(states.items()):
            idx, st0, args = c["idx"], c["st"], c["args"]
            frame = pt.BounceFrame(st0, *args)
            ka = lambda s: pt._kernel_args(s, idx, b, *args, frame)  # noqa: E731
            f1 = kernels.bounce_flight(*ka(_clone_state(st0)), options=True)
            f0 = kernels.bounce_flight(*ka(_clone_state(st0)))
            same = {"flight": torch.equal(f1.view(torch.int32), f0.view(torch.int32))}
            got, want = _clone_state(st0), _clone_state(st0)
            kernels.bounce_shade(*ka(got), flight=f0, options=True)
            kernels.bounce_shade(*ka(want), flight=f0)
            same["shade"] = _states_equal(torch, got, want)
            got, want = _clone_state(st0), _clone_state(st0)
            stop = args[3].max_bounces
            kernels.bounce_window(*ka(got), stop=stop, options=True)
            kernels.bounce_window(*ka(want), stop=stop)
            same["window"] = _states_equal(torch, got, want)
            t = {o: (_bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s), options=o)),
                     _bounce_ms(torch, st0, lambda s: kernels.bounce_window(*ka(s), stop=stop,
                                                                            options=o)))
                 for o in (False, True)}
            print(f"options instance at the defaults, {label}, Apollo 11 bounce {b} "
                  f"({idx.numel()} lanes, {card}): bit-equal to the default instance "
                  f"{same}; bounce_flight {t[True][0]:.3f} ms (default {t[False][0]:.3f}), "
                  f"bounce_window from here {t[True][1]:.3f} ms (default {t[False][1]:.3f})")
            del f0, f1, got, want
            if not all(same.values()):
                fail(f"the options instance at the defaults ({label}, bounce {b}) parts from "
                     f"the default instance: {same}")
        del states

    # the launchers at the options on phase 4's arguments
    for (kind, b), (n_act, args, kwargs) in sorted(captured.items()):
        base = kind.split("/")[0]
        if base == "land_march":
            cases = [(label, o) for label, o, _ in MARCH_OPTIONS]
        elif base == "cloud_track":
            cases = [("bilinear_tracking=True", dict(bilinear_tracking=True))]
        else:
            continue
        at = 5 if base == "land_march" else 8
        for label, options in cases:
            a = args[:at] + (TraceConfig(**options),) + args[at + 1:]
            kern, plain = ((tracers.intersect_land, tracers.intersect_land_plain)
                           if base == "land_march" else
                           (tracers.track_cloud, tracers.track_cloud_plain))
            fn = getattr(kernels, base)
            before = fn.launches, fn.options_launches
            got, ms = _time_ms(torch, lambda: kern(*a, **kwargs), 5)
            if (fn.launches - before[0], fn.options_launches - before[1]) != (
                    6, 6 * takes_options(options)):
                fail(f"{kind} at {label}: not the instance its options take")
            want, plain_ms = _plain_ms(torch, lambda: plain(*a, **kwargs))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want))
            err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
                      for g, w in zip(got, want))
            # phase 7's gates of the default instances (compare_kernels)
            if base == "land_march":
                kh, ph = got[0] >= 0, want[0] >= 0
                lane_ok = (kh == ph) & (~(kh & ph) | _t_close(torch, got[0], want[0]))
            elif kind == "cloud_track/ratio":
                lane_ok = (got[0] - want[0]).abs() <= RATIO_ATOL + RATIO_RTOL * want[0].abs()
            else:
                ev = (got[0] == want[0]) & (want[0] > 0)
                lane_ok = (got[0] == want[0]) & (~ev | _t_close(torch, got[1], want[1]))
            ok = lane_ok.float().mean().item() >= MIN_LANE_AGREEMENT
            print(f"{kind} options instance at {label}, bounce {b} ({got[0].numel()} lanes, "
                  f"{n_act} active, {card}): bit-equal {same}, max abs err {err:.3e}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{kind} at {label} parts from its twin")
            if b == 0 and label == "bilinear_tracking=True":
                row = rows.setdefault(f"{base}/options", dict(max_abs_err=0.0, ms=0.0,
                                                              plain_ms=0.0, bytes=0, ops=None))
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                n = a[1].shape[0]
                row["bytes"] += (a[0].numel() + 33 * n if base == "land_march"
                                 else a[6].numel() + 45 * n + (4 if "ratio" in kind else 8) * n)
                if base == "cloud_track":
                    trips = torch.zeros(n, dtype=torch.int32, device=dev)
                    plain(*a, **kwargs, trips=trips)
                    other, int_ops, fma_ops = tracker_ops(torch, trips, a[8].tracking_k, 1, tf)
                    row["ops"] = ((row["ops"] or 0.0) + other + int_ops + fma_ops
                                  + extra * float(trips.sum()))
                    row["int_ops"] = row.get("int_ops", 0.0) + int_ops
                    row["fma_ops"] = row.get("fma_ops", 0.0) + fma_ops

    # the preview at the march options, phase 11's check on the options instance
    preview_counts = None
    for label, options, _ in MARCH_OPTIONS:
        counts, prow, _ = preview_frame(torch, dev, atlas, luts, f"at {label}",
                                        cfg=TraceConfig(**options))
        if counts["preview/options"] != counts["preview"] * takes_options(options):
            fail(f"the preview frame at {label} did not launch the instance its options take: "
                 f"{counts}")
        if label == "bilinear_tracking=True":
            rows["preview/options"] = prow["preview"]
            preview_counts = counts

    # the path with all seven off their defaults on Apollo 11, then with the
    # five on florida (land and clouds on: the launches the kernels line
    # reports)
    for label, options, scene in (("all seven", ALL_SEVEN, SCENE), FIVE_CASES[0]):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r = render_offline(load_config(scene), dev, spp=1, image_res=RES, out_path=None,
                           atlas=atlas, luts=luts, cfg=TraceConfig(**options))
        for _ in range(2):
            r.accumulate()
        img = r.fetch_image()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_main_path(torch, counts, r, img, f"{label} options' path on "
                        f"{os.path.basename(scene)[9:-4]}")
        if any(counts[f"{k}/options"] != counts[k] for k in
               ("bounce_flight", "bounce_shade", "bounce_window")):
            fail(f"a bounce launch of the options path ran the default instance: {counts}")
        del r, img

    # s/spp in this call, each configuration against its scene's default in
    # alternation
    runs = [(SCENE, label, o) for label, o, _ in OPTION_CASES + ALL_SEVEN_CASES[:1]]
    runs += [(s, label, o) for s in (FLORIDA, SUNSET)
             for label, o in (("all seven", ALL_SEVEN), (FIVE_LABEL, MARCH_FIVE))]
    for scene, label, options in runs:
        make = lambda o: render_offline(load_config(scene), dev, spp=1, image_res=RES,  # noqa: E731
                                        out_path=None, atlas=atlas, luts=luts,
                                        cfg=TraceConfig(**o))
        d, o, ratios = spp_ratio(torch, make({}), make(options))
        print(f"options s/spp {os.path.basename(scene)[9:-4]} {RES[0]}x{RES[1]} {label}: "
              f"{o:.5f} against the default's {d:.5f}, ratio median "
              f"{ratios[len(ratios) // 2]:.3f} (min-max {ratios[0]:.3f}-{ratios[-1]:.3f} over "
              f"{len(ratios)} alternated rounds of {SPP_RATIO_STEPS} spp; {card})")
    return rows, counts, preview_counts


SPP_RATIO_ROUNDS, SPP_RATIO_STEPS = 5, 2


def spp_ratio(torch, default, other):
    """s/spp of the renderers ``default`` and ``other``, each warmed with one
    spp (render_offline's), then timed in SPP_RATIO_ROUNDS alternated rounds
    of SPP_RATIO_STEPS spp each: (the default's median s/spp, the other's,
    each round's ratio other / default, sorted)."""
    import statistics

    t = ([], [])
    for _ in range(SPP_RATIO_ROUNDS):
        for times, r in zip(t, (default, other)):
            times.append(_spp_seconds(torch, r, SPP_RATIO_STEPS))
    return (statistics.median(t[0]), statistics.median(t[1]),
            sorted(b / a for a, b in zip(*t)))


# The reference-faithful naive arm (render/params.NAIVE_OPTIONS): each flag
# alone, with the configuration its s/spp is set against (naive_tracking is
# single-wavelength: against the L = 1 estimator at its defaults).
NAIVE_CASES = (("naive_tracking", dict(naive_tracking=True, hero_lambdas=1), dict(hero_lambdas=1)),
               ("naive_march", dict(naive_march=True), {}),
               ("naive_cloud_tracking", dict(naive_cloud_tracking=True), {}),
               ("naive_shadow", dict(naive_shadow=True), {}))
# naive flags with an estimator option or a march floor (the estimator and
# floor instances' naive sites), each against that option alone
NAIVE_KNOB_CASES = (
    ("naive_tracking, fast_loop_rng", dict(naive_tracking=True, hero_lambdas=1, fast_loop_rng=True),
     dict(hero_lambdas=1, fast_loop_rng=True)),
    ("naive_cloud_tracking, cert_u0", dict(naive_cloud_tracking=True, march_certified_floor=True,
                                           march_uncert_floor_frac=1e-6),
     dict(march_certified_floor=True, march_uncert_floor_frac=1e-6)),
    ("naive_march, cert_u0", dict(naive_march=True, march_certified_floor=True,
                                  march_uncert_floor_frac=1e-6),
     dict(march_certified_floor=True, march_uncert_floor_frac=1e-6)))
# the census sites each flag's naive loops run at (CENSUS_SITES order)
NAIVE_SITES = {"naive_tracking": (0, 1, 2, 4, 5, 6), "naive_march": (0, 3, 4),
               "naive_cloud_tracking": (1, 5), "naive_shadow": (4,)}
# Operations of the naive trackers (csrc/naive.cuh), counted from the source
# as the other rows are (an add, multiply, divide, square root, min or max, an
# expf, logf or atan2f each one; a nearest 4-channel sphere tap 36, the three
# gas densities 51); the march's from the SASS of a step (``naive_step_sass``)
# at the issue rate. A tracker step: the exponential step and the test past
# t_max (5), the point
# (7), then the gases' elevation (7), densities (51), terms and total (5)
# and the test (2): 77, or the cloud's tap (36), radius (6), split-shape
# density (12), extinction (1) and test (2): 69; a ratio step the same with
# the transmittance's update and stop test (3) for the test: 79 and 71.
# Counted as the function needs them (``naive_work``): every step the
# exponential step and its test (NAIVE_STEP_OPS); a step that does not end
# past t_max the rest (NAIVE_EVAL_OPS) but the cloud's tap, which only a
# point inside the slab needs (NAIVE_TAP_OPS: outside it the density is 0
# whatever the tap). Threefry: every step folds its key (a block) and draws
# its first uniform; delta tracking draws the second where a step does not
# end past t_max and its total is above 0 (else no collision can happen),
# and the third at its collision.
NAIVE_STEP_OPS, NAIVE_TAP_OPS = 5, 36
NAIVE_EVAL_OPS = {("delta", "rmo"): 72, ("delta", "cloud"): 28, ("ratio", "rmo"): 74,
                  ("ratio", "cloud"): 30}
# bytes per lane of the launchers: the march's pos, dir, active and
# distance (29; the topography as read once); a tracker's keys, pos, dir,
# span, (n, 4) extinctions, majorant and active (61) and its event, t and
# iid (12) or transmittance (4; the cloud map as read once)
NAIVE_MARCH_LANE_BYTES, NAIVE_TRACK_LANE_BYTES = 29, 61
# the paired accelerated-vs-naive_tracking measurement (tools/parity_ab.py's
# design, both arms at one wavelength): its frame, winsorisation percentile
# (C #5's fireflies), batches per arm and seconds per scene
PARITY_RES, PARITY_CLIP_PCT, PARITY_BATCHES, PARITY_SECONDS = (320, 180), 99.9, 8, 20.0
PARITY_LUMINANCE = (0.2126729, 0.7151522, 0.0721750)  # Rec. 709 Y of linear RGB
# The default bounce instances' SASS instructions (cuobjdump -sass, NOPs
# left out; built for an NVIDIA H100 80GB HBM3 by nvcc 12.9, chip_smoke.py
# --tap-bench), which the options instances' new code must leave as they
# were: {entry<L, template flags>: instructions}, the flags COUNT (flight,
# shade), RATIO (shade, window) and OPTS (0) in the kernels' template order.
# The four bounce_flight entries, which tap nearest only, are commit
# 0584302's; the twelve others were re-recorded when texture.cuh's bilinear
# tap came to read a texel as one word (its bytes turned into floats by a
# PRMT and an FADD, u wrapped by a compare and a select) and the census
# instances gained the shade's surface-branch column.
PARENT_DEFAULT_SASS = {
    "bounce_flight<L=1, 0, 0>": 3957, "bounce_flight<L=1, 1, 0>": 4088,
    "bounce_flight<L=4, 0, 0>": 3958, "bounce_flight<L=4, 1, 0>": 4089,
    "bounce_shade<L=1, 0, 0, 0>": 10068, "bounce_shade<L=1, 0, 1, 0>": 10172,
    "bounce_shade<L=1, 1, 0, 0>": 10120, "bounce_shade<L=1, 1, 1, 0>": 10214,
    "bounce_shade<L=4, 0, 0, 0>": 11752, "bounce_shade<L=4, 0, 1, 0>": 11805,
    "bounce_shade<L=4, 1, 0, 0>": 11842, "bounce_shade<L=4, 1, 1, 0>": 11870,
    "bounce_window<L=1, 0, 0>": 11616, "bounce_window<L=1, 1, 0>": 11701,
    "bounce_window<L=4, 0, 0>": 13345, "bounce_window<L=4, 1, 0>": 13438,
}


def bounce_instances(funcs):
    """{mangled name: (entry, template flags, SASS instructions)} of the
    bounce entries in a ``sass_functions`` map (bounce_shade_block: the knob
    instances' bounce_shade with the naive shadow march block-cooperative,
    bounce_shade's BLOCK instance, a kernel of its own before it was one);
    the last flag is OPTS (0 the default instance, 1 the options instance, 2
    the estimator instance, 3 the floor instance; a bool before the
    estimator instances came)."""
    import re

    out = {}
    for name, ops in funcs.items():
        m = re.search(r"(bounce_flight|bounce_shade_block|bounce_shade|bounce_window)_kernelILi(\d)E"
                      r"((?:L[bi]\d+E)+)", name)
        if m:
            entry, args = m[1], tuple(int(b) for b in re.findall(r"L[bi](\d+)E", m[3]))
            if entry == "bounce_shade" and len(args) == 4:  # COUNT, RATIO, OPTS, BLOCK
                entry, args = ("bounce_shade_block" if args[3] else entry), args[:3]
            out[name] = (f"{entry}<L={m[2]}, {', '.join(map(str, args))}>", args, len(ops))
    return out


def default_sass(kernels):
    """{entry<L, template flags>: SASS instructions} of every default (OPTS
    false) instance of the bounce entries in the built library."""
    funcs = sass_functions(kernels.library()._name)
    return {entry: n for entry, flags, n in bounce_instances(funcs).values() if not flags[-1]}


def sass_counts():
    """``--sass-counts [DIR]``: the bounce entries' SASS instructions of
    every instance and the options sources' ptxas registers and spills, for
    the package imported (DIR's build); one JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch import kernels

    funcs = sass_functions(kernels.library()._name)
    inst = {entry: n for _, (entry, _, n) in sorted(bounce_instances(funcs).items())}
    ptxas = {src: ptxas_entries(kernels.ptxas_log.get(src, "")) for src in
             OPTIONS_SOURCES + ESTIMATOR_SOURCES + FLOOR_SOURCES + ("bounce.cu", "bounce_l1.cu",
                                                     "bounce_ratio.cu", "bounce_l1_ratio.cu")}
    print(json.dumps({"sass_counts": dict(package=os.path.dirname(os.path.abspath(pkg.__file__)),
                                          card=nvidia_smi_line(), instances=inst,
                                          default=default_sass(kernels), ptxas=ptxas)}))


def check_default_sass(kernels):
    """The default bounce instances' SASS instruction counts against the
    recorded ones (PARENT_DEFAULT_SASS): the knob sets' code lives in their
    own instances only. Fails on any difference."""
    now = default_sass(kernels)
    for entry, n in sorted(now.items()):
        print(f"SASS default instance {entry}: {n} instructions (recorded "
              f"{PARENT_DEFAULT_SASS.get(entry)})")
    if now != PARENT_DEFAULT_SASS:
        fail("a default bounce instance's SASS differs from its recorded count")


def _naive_launcher(torch, name, args, iters=False):
    """The naive launcher a twin call ``name`` (``tracking_naive``'s wrapper)
    with ``args`` makes, called directly: (its outputs, with ``iters`` the
    lanes' (n,) steps)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import rng

    if name == "intersect_land_naive":
        topo, pos, d, scale, active, cfg = args
        return kernels.naive_march(topo, pos, d, active, float(scale), steps=cfg.land_march_steps,
                                   enable=cfg.enable_land, bilinear=cfg.bilinear_tracking,
                                   iters=iters)
    keys, pos, d, t0, t1, ext, max_ext, clouds, species, active, cfg = args
    n = pos.shape[0]
    fn = kernels.naive_delta_track if name == "delta_track_naive" else kernels.naive_ratio_track
    return fn(rng.as_lane_keys(keys, n), pos, d, t0, t1, ext,
              torch.as_tensor(max_ext, dtype=torch.float32, device=pos.device).expand(n)
              .contiguous(), active, clouds, species=species, max_steps=cfg.max_tracking_steps,
              bilinear=cfg.bilinear_tracking, iters=iters)


def capture_naive_calls(torch, c, b):
    """The naive loops' calls (name, arguments) of the plain twin's bounce
    ``b`` on the captured state ``c`` (its loops launch the naive
    launchers), in call order."""
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import tracking_naive as tn

    calls = []
    originals = {name: getattr(tn, name) for name in
                 ("intersect_land_naive", "delta_track_naive", "ratio_track_naive")}

    def recorder(name, fn):
        @functools.wraps(fn)
        def rec(*args):
            calls.append((name, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                      for a in args)))
            return fn(*args)
        return rec

    for name, fn in originals.items():
        setattr(tn, name, recorder(name, fn))
    try:
        pt.run_bounce_plain(c["st"].take(c["idx"].long()), b, *c["args"])
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(tn, name, fn)
    return calls


def naive_work(torch, name, args):
    """The work a tracker call ``name`` (``tracking_naive``'s wrapper) with
    ``args`` needs, counted on its twin's own steps (``tracking_naive``'s
    *_plain, its loop body followed step by step): {"steps", "evals" (steps
    that do not end past t_max, whose density the function needs), "taps"
    (of those, the cloud's points inside the slab), "draws" (uniforms: the
    first of every step, delta tracking's second where the total is above 0
    and third at a collision)}."""
    from digital_earth_tpu_torch import constants as C
    from digital_earth_tpu_torch.ops import rng
    from digital_earth_tpu_torch.ops.math_utils import length
    from digital_earth_tpu_torch.render import tracking_naive as tn

    species, clouds, cfg = args[8], args[7], args[10]
    delta = name == "delta_track_naive"
    dev = args[1].device
    n = {k: torch.zeros((), dtype=torch.int64, device=dev)
         for k in ("steps", "evals", "taps", "draws")}
    run = tn._run_lanes

    def counting(budget, stride, state, ctx, body, trips=None):
        def step(i, s, c):
            u = rng.uniform(rng.fold(c["keys"], i), (3,))
            t_new = s["t"] - torch.log(torch.clamp(u[0], min=1e-12)) * c["inv_max"]
            ev = t_new < c["t_max"]
            pos = c["pos"] + torch.minimum(t_new, c["tms"])[:, None] * c["dir"]
            n["steps"] += ev.numel()
            n["evals"] += ev.sum()
            n["draws"] += ev.numel()
            if species == "cloud":
                r = length(pos)
                n["taps"] += (ev & (r > C.CLOUDS_LOWER_LIMIT) & (r < C.CLOUDS_UPPER_LIMIT)).sum()
            else:
                n["taps"] += ev.sum()
            if delta:
                total, _ = tn._total(species, pos, c["ext"], clouds, cfg.bilinear_tracking)
                thr = total * c["inv_max"]
                drawn = ev & (thr > 0.0)
                n["draws"] += drawn.sum() + (drawn & (u[1] < thr)).sum()
            return body(i, s, c)
        return run(budget, stride, state, ctx, step, trips)

    tn._run_lanes = counting
    try:
        getattr(tn, f"{name}_plain")(*args)
    finally:
        tn._run_lanes = run
    return {k: int(v) for k, v in n.items()}


def naive_step_sass(kernels):
    """The SASS of one step of the naive march at nearest taps, the loop's
    statements with its stop tests: the body of the measurement library's
    ``naive_steps_kernel<2>`` less that of ``<1>``
    (csrc/bench/naive_march_bench.cu; each up to its EXIT, the IEEE
    divisions' slow paths after it left out), so that a lane's loads, stores
    and index, paid once a lane, are not counted. {"instructions": n,
    "pipes": {pipe: n}, "ops": {opcode: n}}; fails if the build lacks a
    kernel."""
    funcs = sass_functions(kernels.bench_library()._name)
    pair = [next((f for n, f in funcs.items() if f"naive_steps_kernelILi{k}E" in n), None)
            for k in (1, 2)]
    if None in pair:
        fail("the disassembly lacks naive_steps_kernel<1, 2> (csrc/bench/naive_march_bench.cu)")
    (h1, p1), (h2, p2) = (sass_histogram(sass_main_body(f)) for f in pair)
    ops = {op: h2.get(op, 0) - h1.get(op, 0) for op in sorted(set(h1) | set(h2))}
    return dict(instructions=sum(ops.values()), pipes={k: p2[k] - p1[k] for k in p1},
                ops={op: c for op, c in ops.items() if c})


def naive_ops(torch, name, species, trips, tf, work=None, step=None):
    """(other operations, threefry ALU-pipe, FMA-pipe) of a naive launcher
    whose lanes took the (n,) steps ``trips``: a tracker's from its call's
    ``work`` (``naive_work``); the march's (SASS instructions, of them on
    the XU pipe, 0) from its steps and the SASS of a step ``step``
    (``naive_step_sass``), which ``bound`` takes at the issue rate (its
    ``sfu`` the XU pipe's)."""
    if name == "intersect_land_naive":
        t = float(trips.to(torch.float64).sum())
        return t * step["instructions"], t * step["pipes"]["xu"], 0.0
    kind = "delta" if name == "delta_track_naive" else "ratio"
    tap_ops = NAIVE_TAP_OPS if species == "cloud" else 0
    other = (work["steps"] * NAIVE_STEP_OPS + work["evals"] * NAIVE_EVAL_OPS[(kind, species)]
             + work["taps"] * tap_ops)
    return (float(other), *tf_ops(work["steps"], work["draws"], tf))


NAIVE_ROWS = {"intersect_land_naive": "naive_march", "delta_track_naive": "naive_delta_track",
              "ratio_track_naive": "naive_ratio_track"}
# the most warps of an edge case of check_naive_edges
EDGE_WARPS = 512


def naive_rounds(torch, trips, warp=32):
    """The naive trackers' warp-cooperative rounds (csrc/naive.cuh
    naive_track_warp) on lanes that took the (n,) ``trips`` in launch order:
    (their SIMT efficiency, lane steps over the thread-step slots its warps
    issue; the warps' rounds; the share of them at one thread a lane, c >
    16). Each round a warp's c tracking lanes take T threads each (the
    largest power of two with c T <= 32), 32 slots, and each lane advances by
    T steps (its last round by what is left): the kernel's own rounds, since
    a lane's steps are the twin's. (None, 0, None) where no lane stepped."""
    m = trips.shape[0]
    rem = torch.cat([trips, trips.new_zeros((-m) % warp)]).to(torch.int64).view(-1, warp)
    work, rounds, solo = int(rem.sum()), 0, 0
    rem = rem[(rem > 0).any(1)]
    while rem.numel():
        c = (rem > 0).sum(1)
        T = torch.full_like(c, warp)
        for _ in range(warp.bit_length()):
            T = torch.where((T > 1) & (c * T > warp), T // 2, T)
        rounds += rem.shape[0]
        solo += int((T == 1).sum())
        rem = torch.clamp(rem - T[:, None], min=0)
        rem = rem[(rem > 0).any(1)]
    if work == 0:
        return None, 0, None
    return work / (rounds * warp), rounds, solo / rounds


# csrc/naive.cuh: the naive march's block (a bounce_shade BLOCK block, the
# launcher's) and its steps a round while more lanes march than a warp holds
NAIVE_MARCH_BLOCK, NAIVE_MARCH_ROUND = 128, 8


def march_rounds(torch, trips, block=NAIVE_MARCH_BLOCK, rnd=NAIVE_MARCH_ROUND, warp=32):
    """The naive march's block rounds (csrc/naive.cuh naive_march_block) on
    lanes that took the (n,) ``trips`` in launch order, beside one thread a
    lane: (the rounds' SIMT efficiency, lane steps over the thread-step
    slots their warps issue; their warp-steps; one thread a lane's
    warp-steps, each warp's longest lane). Each round, where that empties a
    warp, a block packs its lanes still marching, in thread order, onto its
    first threads; each warp issues its longest lane's steps that round, at
    most ``rnd`` while more lanes march than a warp holds, else every step
    left: the kernel's own rounds, since a lane's steps are the twin's.
    (None, 0, 0) where no lane stepped."""
    m = trips.shape[0]
    rem = torch.cat([trips, trips.new_zeros((-m) % block)]).to(torch.int64).view(-1, block)
    work = int(rem.sum())
    if work == 0:
        return None, 0, 0
    solo = int(rem.view(-1, warp).amax(1).sum())
    rem = rem[(rem > 0).any(1)]
    issued = 0
    while rem.numel():
        n = (rem > 0).sum(1, keepdim=True)
        busy = (rem.view(rem.shape[0], -1, warp) > 0).any(2).sum(1, keepdim=True)
        packed = torch.gather(rem, 1, torch.sort((rem == 0).to(torch.int8), dim=1,
                                                 stable=True).indices)
        rem = torch.where((n + warp - 1) // warp < busy, packed, rem)
        take = torch.where(n > warp, torch.clamp(rem, max=rnd), rem)
        issued += int(take.view(rem.shape[0], -1, warp).amax(2).sum())
        rem = rem - take
        rem = rem[(rem > 0).any(1)]
    return work / (issued * warp), issued, solo


def march_step_census(torch, args, want, trips):
    """The census of the naive march's steps on a march call's ``args``
    (``intersect_land_naive``'s, at nearest taps): the measurement launcher's
    census instance (csrc/bench/naive_march_bench.cu naive_march_loop, the
    one-thread loop with clock64 between a step's parts) held bit-equal to the twin's
    distances ``want`` and steps ``trips`` (fails otherwise); {part: cycles a
    step of a lane's thread} for the point and its divisions, the angles, the
    tap's read and the rest. None where no lane stepped."""
    from digital_earth_tpu_torch import kernels

    topo, pos, d, scale, active, cfg = args
    out, it, cycles = kernels.naive_march_loop(topo, pos, d, active, float(scale),
                                               steps=cfg.land_march_steps, census=True)
    if not (torch.equal(out.view(torch.int32), want.view(torch.int32))
            and torch.equal(it, trips)):
        fail("naive_march_loop's census parts from the twin")
    steps = int(trips.sum())
    if steps == 0:
        return None
    per = (cycles.sum(0).to(torch.float64) / steps).tolist()
    return dict(zip(("point_and_divisions", "angles", "tap_read", "rest"), per))


def check_naive_launchers(torch, calls, label, tf, rows=None):
    """Each naive launcher call in ``calls`` against its plain twin
    (``tracking_naive``'s *_plain) on the same arguments: every output
    bit-equal, the launcher's steps per lane equal to the twin's; both
    timed; the march's block rounds replayed from the twin's steps
    (``march_rounds``) and, at nearest taps, the census of its steps
    (``march_step_census``). With ``rows``, each launcher's calls add to its
    JSON row (ms, plain ms, bytes, operations from the work the call needs:
    the march's SASS instructions at the issue rate)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracking_naive as tn

    card = nvidia_smi_line()
    seen = {}
    for name, args in calls:
        species = None if name == "intersect_land_naive" else args[8]
        tag = f"{NAIVE_ROWS[name]}{'' if species is None else '/' + species}"
        seen[tag] = seen.get(tag, 0) + 1
        tag = f"{tag} #{seen[tag]}"
        n = args[1].shape[0]
        n_act = int(args[4 if species is None else 9].sum())
        trips = torch.zeros(n, dtype=torch.int32, device=args[1].device)
        # one call of the twin (its operations warmed by the bounce's twin),
        # counting its steps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = getattr(tn, f"{name}_plain")(*args, trips=trips)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        (got, steps), ms = _time_ms(torch, lambda: _naive_launcher(torch, name, args, iters=True), 3)
        # the march's scale as a float, so that the capture reads no tensor
        targs = args if species is not None else (*args[:3], float(args[3]), *args[4:])
        dev_ms = _graph_ms(torch, lambda: _naive_launcher(torch, name, targs))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        differ = torch.zeros(n, dtype=torch.bool, device=args[1].device)
        for g, w in zip(got, want):
            differ |= g.view(torch.int32) != w.view(torch.int32)
        same = not bool(differ.any())
        err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        same_steps = torch.equal(steps, trips)
        t = trips[trips > 0].to(torch.float64)
        simt = simt_efficiency(torch, trips[:, None])[0]
        warp_simt = (None if name == "intersect_land_naive" or (name, species) == (
            "ratio_track_naive", "rmo") else naive_rounds(torch, trips)[0])
        march_text = ""
        if species is None and int(trips.sum()):
            # the one-thread loop (the design the block's replaced) beside it;
            # the scale as a float, so that the capture reads no tensor
            scale = float(args[3])
            loop = lambda: kernels.naive_march_loop(  # noqa: E731
                args[0], args[1], args[2], args[4], scale, steps=args[5].land_march_steps,
                bilinear=args[5].bilinear_tracking)
            l_out, l_it = loop()
            if not (torch.equal(l_out.view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(l_it, trips)):
                fail(f"naive {label} {tag}: the one-thread loop parts from the twin")
            march_text = f", one thread a lane {_graph_ms(torch, loop):.3f} ms on the device"
        if species is None:
            r_simt, issued, solo = march_rounds(torch, trips)
            if r_simt is not None:
                march_text += (f", block rounds {r_simt:.3f} ({issued} warp-steps against {solo} "
                               f"one thread a lane: x{issued / solo:.3f})")
            if not args[5].bilinear_tracking:
                census = march_step_census(torch, args, want[0], trips)
                if census is not None:
                    total = sum(census.values())
                    march_text += (f"; census of a step (one thread a lane), {total:.0f} cycles "
                                   "of a lane's thread: " + ", ".join(
                                       f"{k} {v:.0f} ({v / total:.2f})"
                                       for k, v in census.items()))
        bound_text = ""
        sfu = None
        if rows is not None:
            # the kernels line's calls (Apollo's): the bound from the work the
            # call needs, counted on a second run of the twin
            work = None if species is None else naive_work(torch, name, args)
            step = naive_step_sass(kernels) if species is None else None
            other, int_ops, fma_ops = naive_ops(torch, name, species, trips, tf, work, step)
            if species is None:  # SASS instructions at the issue rate, the XU pipe's apart
                ops, sfu, int_ops = other, int_ops, 0.0
            else:
                ops = other + int_ops + fma_ops
            nbytes = (NAIVE_MARCH_LANE_BYTES * n + args[0].numel() if species is None else
                      (NAIVE_TRACK_LANE_BYTES + (12 if name == "delta_track_naive" else 4)) * n
                      + (args[7].numel() if species == "cloud" else 0))
            b_ms, b_by = bound(nbytes, ops, sfu, int_ops=int_ops, fma_ops=fma_ops)
            bound_text = (f"{'' if work is None else f'; work {work}'}, bound {b_ms:.5f} ms "
                          f"({b_by}; {ops:.4g} "
                          f"{'operations' if sfu is None else f'SASS instructions, {sfu:.4g} XU'}"
                          f"{'' if step is None else f'; a step {step}'})")
        print(f"naive {label} {tag}: {n} lanes ({n_act} active, {card}): bit-equal {same} "
              f"({int(differ.sum())} lanes not), max abs err {err:.3e}, steps equal {same_steps} "
              f"({int((steps != trips).sum())} lanes not); steps {int(trips.sum())} on "
              f"{t.numel()} lanes (mean {float(t.mean()) if t.numel() else 0.0:.1f}, max "
              f"{int(trips.max()) if n else 0}), SIMT eff one thread a lane "
              f"{'-' if simt is None else f'{simt:.3f}'}"
              f"{'' if warp_simt is None else f', warp-cooperative steps {warp_simt:.3f}'}"
              f"{march_text}; kernel {ms:.3f} ms per call, {dev_ms:.3f} on the device"
              f"{bound_text}, plain {plain_ms:.1f} ms")
        if not (same and same_steps):
            fail(f"naive {label} {tag}: the launcher parts from its twin")
        if rows is not None:
            row = rows.setdefault(NAIVE_ROWS[name], dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                                         bytes=0, ops=0.0, int_ops=0.0,
                                                         fma_ops=0.0))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bytes"] += nbytes
            row["ops"] += ops
            row["int_ops"] += int_ops
            row["fma_ops"] += fma_ops
            if sfu is not None:
                row["sfu"] = row.get("sfu", 0.0) + sfu


def _naive_take(args, idx, n, **cfg):
    """A tracker call's arguments at the lanes ``idx`` of its ``n`` (every
    per-lane tensor taken), ``cfg`` replacing fields of its TraceConfig."""
    import dataclasses

    out = [a[idx] if hasattr(a, "shape") and a.dim() and a.shape[0] == n and i != 7 else a
           for i, a in enumerate(args)]
    out[10] = dataclasses.replace(out[10], **cfg)
    return tuple(out)


def check_naive_march_edges(torch, calls):
    """The march's launcher against its twin on its block rounds' edge
    cases, built from the first march call of ``calls`` with marching lanes
    (Apollo's bounce-0 pre-march at naive_tracking; 32 EDGE_WARPS of its
    marching lanes, those of more than 7 steps first, in launch order):
    every lane marching; one marching lane a block, on its thread 77;
    land_march_steps 1, 7 and 250; a last block of 51 lanes. Every distance
    and every lane's steps bit-equal; fails otherwise."""
    import dataclasses

    from digital_earth_tpu_torch.render import tracking_naive as tn

    march = next((a for name, a in calls if name == "intersect_land_naive" and bool(a[4].any())),
                 None)
    if march is None:
        fail("naive edges: no march call with a marching lane")
    topo, pos, d, scale, active, cfg = march
    _, steps = _naive_launcher(torch, "intersect_land_naive",
                               (topo, pos, d, float(scale), active, cfg), iters=True)
    marching = torch.nonzero(active).squeeze(1)
    longer = steps[marching] > 7
    lanes = torch.cat([marching[longer], marching[~longer]])[: 32 * EDGE_WARPS]
    m = lanes.numel()
    one = torch.zeros(m, dtype=torch.bool, device=pos.device)
    one[77::NAIVE_MARCH_BLOCK] = True
    cases = [("every lane marching", lanes, None, cfg.land_march_steps),
             ("one marching lane a block", lanes, one, cfg.land_march_steps)]
    cases += [(f"land_march_steps {k}", lanes, None, k) for k in (1, 7, 250)]
    cases.append(("a last block of 51 lanes", lanes[: m - m % NAIVE_MARCH_BLOCK - 77], None,
                  cfg.land_march_steps))
    for label, idx, act, steps in cases:
        n = idx.numel()
        act = torch.ones(n, dtype=torch.bool, device=pos.device) if act is None else act
        args = (topo, pos[idx].contiguous(), d[idx].contiguous(), float(scale), act,
                dataclasses.replace(cfg, land_march_steps=steps))
        trips = torch.zeros(n, dtype=torch.int32, device=pos.device)
        want = tn.intersect_land_naive_plain(*args, trips=trips)
        got, it = _naive_launcher(torch, "intersect_land_naive", args, iters=True)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32)) and torch.equal(it,
                                                                                          trips)
        print(f"naive edge naive_march {label}: {n} lanes, {int(act.sum())} marching, steps "
              f"{int(trips.sum())} (max {int(trips.max())}, {int((trips == steps).sum())} at the "
              f"budget, {int(((trips == steps) & (want >= 0)).sum())} of them a hit); bit-equal "
              f"with the twin's steps {same}")
        if not same:
            fail(f"naive edge naive_march {label}: the launcher parts from its twin")


def check_naive_edges(torch, calls):
    """The march's block rounds' edges (``check_naive_march_edges``), then
    the trackers' launchers (delta tracking of both species, the cloud's
    ratio tracking) against their twins on the round structure's edge cases,
    built from the tracker calls ``calls`` (Apollo's bounce 0 at
    naive_tracking; at most EDGE_WARPS warps each): one tracking lane a warp
    (the lanes with a span, one at the head of each warp, the rest inactive:
    each round T = 32); 32 tracking lanes a warp (the lanes with a span,
    packed); a step cap inside a round (the packed lanes at
    max_tracking_steps 1, 7 and 33); a stop on a round's last thread (one
    lane a warp whose twin stops after a multiple of 32 steps, its last
    round's last thread). Every output and every lane's steps bit-equal;
    fails otherwise."""
    from digital_earth_tpu_torch.render import tracking_naive as tn

    check_naive_march_edges(torch, calls)

    seen = set()
    for name, args in calls:
        if name == "intersect_land_naive" or (name, args[8]) in seen or (
                name, args[8]) == ("ratio_track_naive", "rmo"):
            continue
        species = args[8]
        seen.add((name, species))
        n = args[1].shape[0]
        dev = args[1].device
        spans = torch.nonzero(args[9] & (args[4] >= 0.0) & (args[3] < args[4])).squeeze(1)
        packed = spans[: 32 * EDGE_WARPS]
        # the stops after a multiple of 32 steps, found at four times the
        # global majorant (its null steps lengthen the tracks)
        thick = list(args)
        thick[6] = args[6] * 4.0
        pool = spans[: 64 * EDGE_WARPS]
        full = torch.zeros(pool.numel(), dtype=torch.int32, device=dev)
        getattr(tn, f"{name}_plain")(*_naive_take(thick, pool, n), trips=full)
        stops = pool[(full % 32 == 0) & (full > 0)
                     & (full < args[10].max_tracking_steps)][:EDGE_WARPS]
        cases = []
        for label, lanes, base in (("one tracking lane a warp", packed[:EDGE_WARPS], args),
                                   ("a stop on a round's last thread", stops, thick)):
            m = lanes.numel()
            idx = torch.repeat_interleave(lanes, 32)  # each lane heads a warp of its copies
            act = torch.zeros(32 * m, dtype=torch.bool, device=dev)
            act[::32] = True
            a = list(_naive_take(base, idx, n))
            a[9] = act
            cases.append((label, tuple(a)))
        cases.append(("32 tracking lanes a warp", _naive_take(args, packed, n)))
        for k in (1, 7, 33):
            cases.append((f"max_tracking_steps {k}", _naive_take(args, packed, n,
                                                                  max_tracking_steps=k)))
        for label, a in cases:
            m = a[1].shape[0]
            trips = torch.zeros(m, dtype=torch.int32, device=dev)
            want = getattr(tn, f"{name}_plain")(*a, trips=trips)
            want = want if isinstance(want, tuple) else (want,)
            got, steps = _naive_launcher(torch, name, a, iters=True)
            got = got if isinstance(got, tuple) else (got,)
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want)) and torch.equal(steps, trips)
            t = trips[trips > 0]
            print(f"naive edge {NAIVE_ROWS[name]}/{species} {label}: {m} lanes, "
                  f"{int((a[9]).sum())} active, steps {int(t.sum())} (max "
                  f"{int(t.max()) if t.numel() else 0}); bit-equal with the twin's steps {same}")
            if not same:
                fail(f"naive edge {NAIVE_ROWS[name]}/{species} {label}: the launcher parts from "
                     "its twin")
            if label == "a stop on a round's last thread" and not (
                    t.numel() and bool((t % 32 == 0).all())):
                fail(f"naive edge {name}/{species}: no lane stops after a multiple of 32 steps")


def naive_census_text(torch, trips, sites):
    """The census's trips at ``sites``: per site the lanes taking steps,
    their mean and largest steps and the site's SIMT efficiency."""
    simt = simt_efficiency(torch, trips)
    parts = []
    for s in sites:
        t = trips[:, s]
        took = t[t > 0].to(torch.float64)
        parts.append(f"{CENSUS_SITE_NAMES[s]} {took.numel()} lanes, mean "
                     f"{float(took.mean()) if took.numel() else 0.0:.1f}, max "
                     f"{int(t.max()) if t.numel() else 0}, SIMT "
                     f"{'-' if simt[s] is None else f'{simt[s]:.3f}'}")
    return "; ".join(parts)


CENSUS_SITE_NAMES = ("pre_march", "cloud", "rmo", "post_march", "shadow", "nee_cloud", "nee_rmo")


def paired_parity(torch, dev, atlas, luts, scene):
    """The accelerated estimator against naive_tracking, both at one
    wavelength (tools/parity_ab.py --paired's design) at PARITY_RES on
    ``scene``: PARITY_BATCHES batches per arm, batch b of both arms from the
    same seed (common random numbers), as many spp a batch as
    PARITY_SECONDS allow (set from one timed spp of each arm); the batch
    frame means winsorised per channel at the pooled PARITY_CLIP_PCT
    percentile of |value|; the relative error of the frame mean per
    channel and its SE from the paired differences (B - 1 dof), and the
    same of the winsorised frames' luminance. Returns (spp a batch, each
    arm's warm s/spp, the error, its SE, the raw error, the luminance's
    error and SE), the errors per channel."""
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    arms = (TraceConfig(hero_lambdas=1), TraceConfig(naive_tracking=True, hero_lambdas=1))

    def renderer(cfg, seed):
        r = Renderer(dev, image_res=PARITY_RES, atlas=atlas, luts=luts, seed=seed, cfg=cfg)
        apply_config(r, load_config(scene))
        return r

    per = []
    for cfg in arms:
        r = renderer(cfg, 1)
        r.accumulate()
        per.append(_spp_seconds(torch, r, 2))
    spp = max(1, int(PARITY_SECONDS / (PARITY_BATCHES * sum(per))))
    frames = ([], [])
    for b in range(PARITY_BATCHES):
        for arm, cfg in enumerate(arms):
            r = renderer(cfg, 1000 * (b + 1))
            for _ in range(spp):
                r.accumulate()
            frames[arm].append(r.color_buffer / spp)
    A, N = (torch.stack(f).to(torch.float64) for f in frames)  # (B, W, H, 3)
    if not (bool(torch.isfinite(A).all()) and bool(torch.isfinite(N).all())):
        fail(f"paired parity {scene}: a non-finite value in a batch frame")

    def stats(a, n):
        am, nm = a.mean((1, 2)), n.mean((1, 2))
        d = am - nm
        return (d.mean(0) / nm.mean(0).abs(), d.std(0, unbiased=True) / math.sqrt(d.shape[0])
                / nm.mean(0).abs())

    raw, _ = stats(A, N)
    thr = torch.quantile(torch.cat([A, N]).abs().reshape(-1, 3), PARITY_CLIP_PCT / 100.0, dim=0)
    Ac, Nc = (torch.maximum(torch.minimum(x, thr), -thr) for x in (A, N))
    err, se = stats(Ac, Nc)
    # the luminance of the winsorised frames, parity_ab's statistic of most power
    w = torch.tensor(PARITY_LUMINANCE, dtype=torch.float64, device=dev)
    lum, lum_se = stats((Ac * w).sum(-1, keepdim=True), (Nc * w).sum(-1, keepdim=True))
    out = [x.tolist() for x in (err, se, raw, lum, lum_se)]
    if not all(math.isfinite(v) for x in out for v in x):
        fail(f"paired parity {scene}: a non-finite error or SE")
    return (spp, per, *out)


def check_naive(torch, dev, atlas, luts, tf):
    """The naive arm (NAIVE_CASES) at 1920x1080 on ``atlas``: the default
    bounce instances' SASS against the parent's; the naive launchers against
    their twins on each scene's bounce-0 arguments at naive_tracking (every
    output bit-equal, their steps the twin's, timed with their bounds: the
    JSON rows, Apollo's); per flag and scene, the bounce entries' options
    instances against their twin at bounces 0 and DEEP_BOUNCE and
    bounce_window against run_window_plain from the bounce the frame enters
    it (every lane bit-equal), the census's steps at the flag's naive sites,
    bounce 0's two kernels timed beside the default instances on the scene's
    default frame; the naive_tracking path on Apollo under phase 6's gates
    (every bounce launch the options instances'); s/spp of each flag on
    Apollo against its default (``spp_ratio``); and the paired
    accelerated-vs-naive_tracking error of the frame mean on the three
    scenes (``paired_parity``). Returns the naive launchers' JSON rows."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.params import TraceConfig

    card = nvidia_smi_line()
    check_default_sass(kernels)
    rows = {}
    nt_cfg = TraceConfig(**NAIVE_CASES[0][1])
    for scene in (SCENE, FLORIDA, SUNSET):
        name = os.path.basename(scene)[9:-4]
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=scene,
                                      cfg=nt_cfg)
        calls = capture_naive_calls(torch, states[0], 0)
        kinds = {(c[0], None if c[0] == "intersect_land_naive" else c[1][8]) for c in calls}
        if len(kinds) != 5:
            fail(f"naive {name}: the twin's bounce 0 at naive_tracking made the calls {kinds}")
        check_naive_launchers(torch, calls, f"{name} bounce 0", tf,
                              rows if scene == SCENE else None)
        if scene == SCENE:
            check_naive_edges(torch, calls)
        del states, calls

    default_ms = {}
    for label, options, base in NAIVE_CASES:
        cfg = TraceConfig(**options)
        for scene in (SCENE, FLORIDA, SUNSET):
            name = os.path.basename(scene)[9:-4]
            key = (scene, tuple(sorted(base.items())))
            if key not in default_ms:
                st, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=scene,
                                          cfg=TraceConfig(**base))
                c = st[0]
                frame = pt.BounceFrame(c["st"], *c["args"])
                ka = lambda s, c=c, frame=frame: pt._kernel_args(s, c["idx"], 0, *c["args"],  # noqa: E731
                                                                 frame)
                flight = kernels.bounce_flight(*ka(_clone_state(c["st"])))
                default_ms[key] = (
                    _bounce_ms(torch, c["st"], lambda s: kernels.bounce_flight(*ka(s))),
                    _bounce_ms(torch, c["st"], lambda s: kernels.bounce_shade(*ka(s), flight=flight)))
                del st, c, flight
            states, _, _ = capture_states(torch, dev, atlas, luts, scene=scene, cfg=cfg)
            for b in (0, DEEP_BOUNCE):
                if b not in states:
                    print(f"naive {label} {name}: no live lane at bounce {b}")
                    continue
                c = states[b]
                got, want, trips, cycles = _bounce_and_twin(torch, c, b)
                _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                            f"naive {label} {name} bounce {b}", exact=True)
                print(f"census naive {label} {name} bounce {b}: {c['idx'].numel()} live; "
                      f"{naive_census_text(torch, trips, NAIVE_SITES[label])}; cycle split "
                      f"{split_text(cycle_split(torch, cycles))}")
                if b != 0:
                    continue
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
                flight = _one_launch(kernels.bounce_flight, options,
                                     lambda: kernels.bounce_flight(*ka(_clone_state(st0))),
                                     f"naive {label} {name}")
                t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
                t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
                d_f, d_s = default_ms[(scene, tuple(sorted(base.items())))]
                print(f"naive {label} {name} bounce 0 ({idx.numel()} lanes, {card}): bounce_flight "
                      f"{t_f:.3f} ms, bounce_shade {t_s:.3f} ms (options instances); the default "
                      f"instances at {base or 'the default config'} on the same scene {d_f:.3f}, "
                      f"{d_s:.3f} ms; flight x{t_f / d_f:.2f}, shade x{t_s / d_s:.2f}")
                del flight
            bounces = sorted(states)
            n = states[0]["st"].alive.numel()
            counts = [states[b]["idx"].numel() for b in bounces] + [0]
            _, wb = pt.bounce_schedule(n, counts, kernels.window_threshold(dev), 0,
                                       cfg.max_bounces)
            if wb is not None and wb in states:
                c = states[wb]
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                st = _clone_state(st0)
                _one_launch(kernels.bounce_window, options,
                            lambda: pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame),
                            f"naive {label} {name} bounce_window")
                twin = _clone_state(st0)
                t0 = time.time()
                pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
                torch.cuda.synchronize()
                w_plain = (time.time() - t0) * 1e3
                lanes = idx.long()
                _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                            f"naive {label} {name} bounce_window from bounce {wb}", exact=True)
                w_ms = _bounce_ms(torch, st0, lambda s: pt.run_window(s, idx, wb, cfg.max_bounces,
                                                                        *args, frame))
                print(f"naive {label} {name} bounce_window from bounce {wb} ({idx.numel()} "
                      f"lanes, {card}): {w_ms:.3f} ms; twin {w_plain:.1f} ms")
            else:
                print(f"naive {label} {name}: the frame does not enter the window (live counts "
                      f"{counts[:-1]})")
            del states

    # the naive_tracking path through the public entry point, counts set to
    # 0 just before it and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None, atlas=atlas,
                       luts=luts, cfg=nt_cfg)
    for _ in range(2):
        r.accumulate()
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_main_path(torch, counts, r, img, "naive_tracking path on Apollo 11")
    if any(counts[f"{k}/options"] != counts[k] for k in
           ("bounce_flight", "bounce_shade", "bounce_window")):
        fail(f"a bounce launch of the naive_tracking path ran the default instance: {counts}")
    del r, img

    for label, options, base in NAIVE_CASES:
        make = lambda o: render_offline(load_config(SCENE), dev, spp=1, image_res=RES,  # noqa: E731
                                        out_path=None, atlas=atlas, luts=luts,
                                        cfg=TraceConfig(**o))
        d, o, ratios = spp_ratio(torch, make(base), make(options))
        print(f"naive s/spp Apollo 11 {RES[0]}x{RES[1]} {label}: {o:.5f} against "
              f"{base or 'the default'}'s {d:.5f}, ratio median {ratios[len(ratios) // 2]:.3f} "
              f"(min-max {ratios[0]:.3f}-{ratios[-1]:.3f} over {len(ratios)} alternated rounds "
              f"of {SPP_RATIO_STEPS} spp; {card})")

    for scene in (SCENE, FLORIDA, SUNSET):
        t0 = time.time()
        spp, per, err, se, raw, lum, lum_se = paired_parity(torch, dev, atlas, luts, scene)
        fmt = lambda v: ", ".join(f"{100 * x:+.3f}" for x in v)  # noqa: E731
        print(f"paired parity {os.path.basename(scene)[9:-4]} {PARITY_RES[0]}x{PARITY_RES[1]} "
              f"(accelerated vs naive_tracking, both hero_lambdas=1; {PARITY_BATCHES} paired "
              f"batches of {spp} spp per arm, {PARITY_BATCHES * spp} spp per arm; warm spp "
              f"{per[0]:.4f} s and {per[1]:.4f} s; {time.time() - t0:.1f} s; {card}): per-channel "
              f"error of the frame mean, {PARITY_CLIP_PCT}% winsorised, % [{fmt(err)}] +- SE "
              f"[{', '.join(f'{100 * x:.3f}' for x in se)}]; luminance {fmt(lum)} +- "
              f"{100 * lum_se[0]:.3f}; raw [{fmt(raw)}]")
    return rows


# Phase 8e, the estimator options (render/params.ESTIMATOR_OPTIONS): each
# case the bounce entries' options instances are held to their twin at
# (the roulettes' start bounces set so that they act at bounces 0 and
# DEEP_BOUNCE: the NEE roulette acts past nee_rr_start, the cloud roulette
# from cloud_rr_start), and the settings whose s/spp is set against the
# default's (at the reference's start bounces, 9)
ESTIMATOR_CASES = (
    ("analytic_flight", dict(analytic_flight=True)),
    ("fast_loop_rng", dict(fast_loop_rng=True)),
    ("nee_rr_prob=0.5", dict(nee_rr_prob=0.5, nee_rr_start=-1)),
    ("cloud_rr_keep=0.5", dict(cloud_rr_keep=0.5, cloud_rr_start=0)),
    ("nee_off", dict(nee_off=True)),
    ("all but nee_off", dict(analytic_flight=True, flight_newton_iters=10, fast_loop_rng=True,
                             nee_rr_prob=0.5, nee_rr_start=-1, cloud_rr_keep=0.5,
                             cloud_rr_start=0)),
)
# analytic_flight and fast_loop_rng also at the reference's own estimator
# (the L = 1 ratio instances, whose sun transmittance of the gases is ratio
# tracking), analytic_flight marching first, and fast_loop_rng beside
# naive_tracking (whose loops keep threefry)
ESTIMATOR_EXTRA = (
    ("analytic_flight, reference estimator", dict(analytic_flight=True, **REF_ESTIMATOR)),
    ("fast_loop_rng, reference estimator", dict(fast_loop_rng=True, **REF_ESTIMATOR)),
    ("analytic_flight, lazy_march=False", dict(analytic_flight=True, lazy_march=False)),
    ("fast_loop_rng, naive_tracking", dict(fast_loop_rng=True, naive_tracking=True,
                                           hero_lambdas=1)),
)
ESTIMATOR_SPP = (("analytic_flight", dict(analytic_flight=True)),
                 ("fast_loop_rng", dict(fast_loop_rng=True)),
                 ("nee_rr_prob=0.5", dict(nee_rr_prob=0.5)),
                 ("cloud_rr_keep=0.5", dict(cloud_rr_keep=0.5)),
                 ("nee_off", dict(nee_off=True)),
                 ("all but nee_off", dict(analytic_flight=True, fast_loop_rng=True,
                                          nee_rr_prob=0.5, cloud_rr_keep=0.5)))
# Operations of the analytic flight (csrc/flight_analytic.cuh), counted from
# the source as the other rows are (an add, multiply, divide, square root,
# min, max, compare or select one; an expf or logf one): a table lookup
# F(rp, |x|) 133 (the row index 23, two rows 50 each, the lerps 10), tau(t)
# 151 (the lookup, the sign and clamped differences, the dot); per lane the
# perigee frame, f0, tau over the span, -ln u and the test: 319; a Newton
# step: tau, the residual, the radius and its densities (51), sigma, the
# bracket, the step and its test, the bisection: 231; a colliding lane's
# clamp, point, densities, species CMF and roulette: 78. Threefry: a draw
# a lane, two more a colliding lane
FLIGHT_LANE_OPS, FLIGHT_STEP_OPS, FLIGHT_HIT_OPS = 319, 231, 78
# bytes per lane of the launcher: keys, pos, dir, span, ext_h, active (53)
# read, event, t, iid (12) written; the table counted once
FLIGHT_LANE_BYTES = 65
# fast_uniform_check's integer work a word, from the source: the counter's
# and the index's products (2 IMAD), the two xors with the key words, two
# lowbias32 (each three shift-xors, 6 ALU-pipe instructions, and two
# multiplies on the FMA pipe): 14 ALU-pipe and 6 FMA-pipe instructions, a
# conversion and the 2^-32 scale
FAST_WORD_ALU, FAST_WORD_FMA, FAST_WORD_F32 = 14, 6, 2
FAST_COUNTERS = (0, 1, 7, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
FAST_SHAPE = (3, 4)  # a delta tracker's iteration at K = 4: 12 words a lane


def check_flight_analytic(torch, captured, tf):
    """flight_analytic against its twin on the RMO flight arguments phase 4
    captured at bounce 0 (Apollo 11 1080p): every lane's event, distance and
    interaction id bit-equal, its steps the twin's census count; timed per
    call and on the device with its bound. A JSON row."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.models import atmosphere_lut as atm
    from digital_earth_tpu_torch.render import tracers
    from digital_earth_tpu_torch.render.params import TraceConfig

    n_act, args, _ = captured[("rmo_delta_track", 0)]
    keys, pos, d, t0, t1, ext_h, active = args[:7]
    cfg = TraceConfig(analytic_flight=True)
    n = pos.shape[0]
    table = atm.density_table(pos.device)
    k32 = kernels.keys_i32(keys)
    launch = lambda: kernels.flight_analytic(k32, pos, d, t0, t1, ext_h, active, table,  # noqa: E731
                                             n_iter=cfg.flight_newton_iters, iters=True)
    ((event, t, iid), iters), ms = _time_ms(torch, launch, 5)
    graph_ms = _graph_ms(torch, lambda: kernels.flight_analytic(
        k32, pos, d, t0, t1, ext_h, active, table, n_iter=cfg.flight_newton_iters))
    trips = torch.zeros(n, dtype=torch.int32, device=pos.device)
    want = tracers.sample_rmo_flight_analytic_plain(keys, pos, d, t0, t1, ext_h, active, cfg,
                                                    trips=trips)
    _, plain_ms = _plain_ms(torch, lambda: tracers.sample_rmo_flight_analytic_plain(
        keys, pos, d, t0, t1, ext_h, active, cfg))
    parted = int(((event != want[0]) | (t.view(torch.int32) != want[1].view(torch.int32))
                  | (iid != want[2])).sum())
    same_iters = torch.equal(iters, trips)
    hits = int((iters > 0).sum())
    steps = float(iters.to(torch.float64).sum())
    alu, fma = tf_ops(0, n + 2 * hits, tf)
    ops = n * FLIGHT_LANE_OPS + steps * FLIGHT_STEP_OPS + hits * FLIGHT_HIT_OPS + alu + fma
    nbytes = n * FLIGHT_LANE_BYTES + table.numel() * 4
    b_ms, b_by = bound(nbytes, ops, int_ops=alu, fma_ops=fma)
    ok = parted == 0 and same_iters
    ev = event[active]
    print(f"flight_analytic Apollo 11 bounce 0 ({n} lanes, {n_act} active, "
          f"{cfg.flight_newton_iters} Newton steps; {nvidia_smi_line()}): event, t and iid "
          f"bit-equal to the twin's on all but {parted} lanes, steps equal {same_iters}; "
          f"{hits} colliding lanes ({int((ev == 2).sum())} scatter, {int((ev == 1).sum())} "
          f"absorb), {steps:.0f} steps; kernel {ms:.4f} ms per call, {graph_ms:.4f} ms on the "
          f"device (CUDA graph), plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}; {ops:.4g} "
          f"operations, {alu:.4g} threefry ALU-pipe, {fma:.4g} FMA-pipe; bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms)  {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flight_analytic disagrees with its plain twin")
    return dict(max_abs_err=0.0, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=ops, int_ops=alu, fma_ops=fma)


def check_fast_uniform(torch, dev):
    """fast_uniform_check bit for bit against ops/rng.fast_uniform on 65,536
    lanes (threefry's edge keys first) at counters across 2^31 and 2^32 - 1,
    12 words a lane; then at the frame's shape (2,073,600 lanes, a delta
    iteration's 12 words) per call and on the device with its bound. A JSON
    row."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import rng

    words = math.prod(FAST_SHAPE)
    keys = threefry_keys(torch, dev, 1 << 16)
    for c in FAST_COUNTERS:
        got = kernels.fast_uniform_check(keys, c, words)
        want = rng.fast_uniform(keys, c, (words,))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"fast_uniform_check disagrees with ops/rng.fast_uniform at counter {c:#x}")
    n = RES[0] * RES[1]
    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(n, device=dev))
    k32 = kernels.keys_i32(keys)
    got, ms = _time_ms(torch, lambda: kernels.fast_uniform_check(k32, 5, words), 20)
    graph_ms = _graph_ms(torch, lambda: kernels.fast_uniform_check(k32, 5, words))
    want, plain_ms = _plain_ms(torch, lambda: rng.fast_uniform(keys, 5, (words,)))
    equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    alu, fma = n * words * FAST_WORD_ALU, n * words * FAST_WORD_FMA
    ops = alu + fma + n * words * FAST_WORD_F32
    nbytes = n * (8 + 4 * words)
    b_ms, b_by = bound(nbytes, ops, int_ops=alu, fma_ops=fma)
    print(f"fast_uniform_check: bit-equal to ops/rng.fast_uniform on 65536 lanes (17 edge keys "
          f"first), {words} words a lane, at counters {[hex(c) for c in FAST_COUNTERS]}; at "
          f"{n} lanes x {words} words: bit-equal {equal}  kernel {ms:.4f} ms per call, "
          f"{graph_ms:.4f} ms on the device (CUDA graph)  plain {plain_ms:.2f} ms  bound "
          f"{b_ms:.4f} ms ({b_by}; {alu:.4g} ALU-pipe, {fma:.4g} FMA-pipe instructions)  "
          f"{'ok' if equal else 'FAIL'}")
    if not equal:
        fail("fast_uniform_check disagrees with ops/rng.fast_uniform at the frame's shape")
    return dict(max_abs_err=0.0, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bytes=nbytes,
                ops=ops, int_ops=alu, fma_ops=fma)


# lanes of a tracker launcher at fast_loop_rng that may part from the twin on
# the card and be held to the twin on the CPU instead (the twin's Python
# divisors round on the card as a multiply by float32(1 / b), ROADMAP C #2:
# the cloud tracker's slab height over 6000 and its transmittance over
# 0.05; the kernels divide, as the twin does on the CPU)
FAST_CPU_LANES = 4096


def _hold_to_twins(torch, kind, got, want, plain, args, cfg, kwargs, card, times):
    """A tracker launcher's outputs ``got`` against its twin's on the card
    ``want``, lane by lane and bit for bit; the lanes that part are run by
    the twin on the CPU, whose bits they must have. Fails otherwise."""
    diff = sum((g.view(torch.int32) != w.view(torch.int32)).reshape(g.shape[0], -1).any(-1)
               .to(torch.int32) for g, w in zip(got, want))
    lanes = torch.nonzero(diff).squeeze(1)
    ok = lanes.numel() <= FAST_CPU_LANES
    if lanes.numel() and ok:
        n = diff.shape[0]
        cpu = [a[lanes].cpu() if isinstance(a, torch.Tensor) and a.shape[:1] == (n,) else
               a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        host = plain(*cpu, cfg, **kwargs)
        host = host if isinstance(host, tuple) else (host,)
        ok = all(torch.equal(g[lanes].cpu().view(torch.int32), h.view(torch.int32))
                 for g, h in zip(got, host))
    print(f"{kind} at fast_loop_rng, Apollo 11 bounce 0 ({diff.shape[0]} lanes; {card}): "
          f"bit-equal to the twin's on the card on all but {lanes.numel()} lanes, those "
          f"bit-equal to the twin's on the CPU; fast_loop_rng instance {times[0]:.4f} ms, the "
          f"default instance (threefry) {times[1]:.4f} ms  {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{kind} at fast_loop_rng disagrees with its plain twin")


def check_fast_trackers(torch, dev, atlas, luts, captured):
    """The tracker launchers' options instances at fast_loop_rng against
    their twins at it: rmo_delta_track and cloud_track (delta and ratio) on
    phase 4's bounce-0 arguments, rmo_ratio_track on the reference
    estimator's bounce-0 NEE lanes at L = 4 (Apollo 11 1080p); every lane
    bit-equal to the twin on the card, or where that twin's Python divisors
    part from it (FAST_CPU_LANES) to the twin on the CPU (the ratio
    tracker's iterations equal too); each timed beside its default instance
    (threefry) on the same arguments. {kind: (ms, default ms)}."""
    import dataclasses

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import tracers

    card = nvidia_smi_line()
    out = {}
    for kind in ("rmo_delta_track", "cloud_track/delta", "cloud_track/ratio"):
        _, args, kwargs = captured[(kind, 0)]
        fast = dataclasses.replace(args[-1], fast_loop_rng=True)
        if kind == "rmo_delta_track":
            plain, wrapper = tracers.delta_track_rmo_plain, tracers.delta_track_rmo
        else:
            plain, wrapper = tracers.track_cloud_plain, tracers.track_cloud
        got, ms = _time_ms(torch, lambda: wrapper(*args[:-1], fast, **kwargs), 5)
        _, ms_default = _time_ms(torch, lambda: wrapper(*args, **kwargs), 5)
        want = plain(*args[:-1], fast, **kwargs)
        got, want = ((got,), (want,)) if kind.endswith("ratio") else (got, want)
        _hold_to_twins(torch, kind, got, want, plain, args[:-1], fast, kwargs, card,
                       (ms, ms_default))
        out[kind] = (ms, ms_default)
    from digital_earth_tpu_torch.render.params import TraceConfig

    states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,),
                                  cfg=TraceConfig(analytic_transmittance=False))
    args = capture_ratio_args(torch, states[0], 0)
    del states
    keys, pos, d, t0, t1, ext, max_ext, active, cfg = args
    fast = dataclasses.replace(cfg, fast_loop_rng=True)
    kw = dict(max_steps=cfg.max_tracking_steps, k=cfg.tracking_k, iters=True)
    (got, iters), ms = _time_ms(torch, lambda: kernels.rmo_ratio_track(
        keys, pos, d, t0, t1, ext, max_ext, active, fast_rng=True, **kw), 5)
    _, ms_default = _time_ms(torch, lambda: kernels.rmo_ratio_track(
        keys, pos, d, t0, t1, ext, max_ext, active, **kw), 5)
    trips = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    want = tracers.ratio_track_rmo_plain(*args[:-1], fast, trips=trips)
    if not torch.equal(iters, trips):
        fail("rmo_ratio_track at fast_loop_rng: iterations differ from the twin's")
    print(f"rmo_ratio_track NEE lanes: {int(active.sum())} of {pos.shape[0]}, L = {ext.shape[1]}, "
          f"iterations equal to the twin's")
    _hold_to_twins(torch, "rmo_ratio_track", (got,), (want,), tracers.ratio_track_rmo_plain,
                   args[:-1], fast, {}, card, (ms, ms_default))
    out["rmo_ratio_track"] = (ms, ms_default)
    return out


def check_estimator_knobs(torch, dev, atlas, luts, captured, tf):
    """Phase 8e, the estimator options at 1920x1080 on ``atlas``: the
    default bounce instances' SASS against the parent's; flight_analytic
    and fast_uniform_check against their twins (the JSON rows); the tracker
    launchers at fast_loop_rng; per case (ESTIMATOR_CASES, ESTIMATOR_EXTRA)
    and scene, the bounce entries' options instances against their twin at
    bounces 0 and DEEP_BOUNCE and bounce_window against run_window_plain
    from the bounce the frame enters it, every lane bit-equal, with the
    census (at analytic_flight its Newton steps at the RMO site), bounce 0's
    two kernels timed beside the default instances; the analytic_flight
    path on Apollo under phase 6's gates; and s/spp of each ESTIMATOR_SPP
    setting against its scene's default (``spp_ratio``). Returns the JSON
    rows."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.params import TraceConfig

    t_phase = time.time()
    card = nvidia_smi_line()
    check_default_sass(kernels)
    for src in ESTIMATOR_SOURCES:
        for name, (regs, stores, loads) in sorted(ptxas_entries(
                kernels.ptxas_log.get(src, "")).items()):
            print(f"ptxas {src} {name}: {regs} registers, spill stores {stores} B, loads {loads} B")
    for name in kernels.OCCUPANCY_ENTRIES:
        o = kernels.bounce_occupancy(name, options=kernels.INST_ESTIMATOR)
        print(f"occupancy {name}: estimator instance {o['registers']} registers, "
              f"{o['local_bytes']} B local, {o['warps_per_sm']} warps per SM")
    rows = {"flight_analytic": check_flight_analytic(torch, captured, tf),
            "fast_uniform_check": check_fast_uniform(torch, dev)}
    check_fast_trackers(torch, dev, atlas, luts, captured)

    default_ms = {}
    for label, options in ESTIMATOR_CASES + ESTIMATOR_EXTRA:
        cfg = TraceConfig(**options)
        # the default instances of the same width and sun transmittance
        base = {k: v for k, v in options.items() if k in REF_ESTIMATOR}
        for scene in (SCENE, FLORIDA, SUNSET):
            name = os.path.basename(scene)[9:-4]
            states, _, _ = capture_states(torch, dev, atlas, luts, scene=scene, cfg=cfg)
            for b in (0, DEEP_BOUNCE):
                if b not in states:
                    print(f"estimator {label} {name}: no live lane at bounce {b}")
                    continue
                c = states[b]
                got, want, trips, cycles = _bounce_and_twin(torch, c, b)
                _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                            f"estimator {label} {name} bounce {b}", exact=True)
                rmo = trips[:, 2]
                if cfg.analytic_flight and not cfg.naive_tracking:
                    steps = set(torch.unique(rmo).tolist())
                    if not steps <= {0, cfg.flight_newton_iters}:
                        fail(f"estimator {label} {name} bounce {b}: the census's RMO column "
                             f"holds {sorted(steps)}, not 0 or {cfg.flight_newton_iters}")
                print(f"census estimator {label} {name} bounce {b}: {c['idx'].numel()} live; "
                      f"{naive_census_text(torch, trips, range(kernels.BOUNCE_SITES))}; cycle "
                      f"split {split_text(cycle_split(torch, cycles))}")
                if b != 0 or scene != SCENE:
                    continue
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
                flight = _one_launch(kernels.bounce_flight, options,
                                     lambda: kernels.bounce_flight(*ka(_clone_state(st0))),
                                     f"estimator {label} {name}")
                t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
                t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
                key = tuple(sorted(base.items()))
                if key not in default_ms:
                    st_d, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,),
                                                cfg=TraceConfig(**base))
                    cd = st_d[0]
                    fd = pt.BounceFrame(cd["st"], *cd["args"])
                    kd = lambda s, cd=cd, fd=fd: pt._kernel_args(s, cd["idx"], 0,  # noqa: E731
                                                                 *cd["args"], fd)
                    fl = kernels.bounce_flight(*kd(_clone_state(cd["st"])))
                    default_ms[key] = (
                        _bounce_ms(torch, cd["st"], lambda s: kernels.bounce_flight(*kd(s))),
                        _bounce_ms(torch, cd["st"], lambda s: kernels.bounce_shade(*kd(s),
                                                                                   flight=fl)))
                    del st_d, cd, fl
                d_f, d_s = default_ms[key]
                print(f"estimator {label} {name} bounce 0 ({idx.numel()} lanes, {card}): "
                      f"bounce_flight {t_f:.3f} ms, bounce_shade {t_s:.3f} ms (estimator "
                      f"instances); the default instances at {base or 'the default config'} "
                      f"{d_f:.3f}, {d_s:.3f} ms; flight x{t_f / d_f:.2f}, shade x{t_s / d_s:.2f}")
                del flight
            bounces = sorted(states)
            n = states[0]["st"].alive.numel()
            counts = [states[b]["idx"].numel() for b in bounces] + [0]
            _, wb = pt.bounce_schedule(n, counts, kernels.window_threshold(dev), 0,
                                       cfg.max_bounces)
            if wb is not None and wb in states:
                c = states[wb]
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                st = _clone_state(st0)
                _one_launch(kernels.bounce_window, options,
                            lambda: pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame),
                            f"estimator {label} {name} bounce_window")
                twin = _clone_state(st0)
                pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
                lanes = idx.long()
                _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                            f"estimator {label} {name} bounce_window from bounce {wb}",
                            exact=True)
            else:
                print(f"estimator {label} {name}: the frame does not enter the window (live "
                      f"counts {counts[:-1]})")
            del states

    # the analytic_flight path through the public entry point, counts set to
    # 0 just before it and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None, atlas=atlas,
                       luts=luts, cfg=TraceConfig(analytic_flight=True))
    for _ in range(2):
        r.accumulate()
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_main_path(torch, counts, r, img, "analytic_flight path on Apollo 11")
    if any(counts[f"{k}/options"] != counts[k] for k in
           ("bounce_flight", "bounce_shade", "bounce_window")):
        fail(f"a bounce launch of the analytic_flight path ran the default instance: {counts}")
    del r, img

    for scene in (SCENE, FLORIDA, SUNSET):
        for label, options in ESTIMATOR_SPP:
            make = lambda o: render_offline(load_config(scene), dev, spp=1,  # noqa: E731
                                            image_res=RES, out_path=None, atlas=atlas, luts=luts,
                                            cfg=TraceConfig(**o))
            d, o, ratios = spp_ratio(torch, make({}), make(options))
            print(f"estimator s/spp {os.path.basename(scene)[9:-4]} {RES[0]}x{RES[1]} {label}: "
                  f"{o:.5f} against the default's {d:.5f}, ratio median "
                  f"{ratios[len(ratios) // 2]:.3f} (min-max {ratios[0]:.3f}-{ratios[-1]:.3f} "
                  f"over {len(ratios)} alternated rounds of {SPP_RATIO_STEPS} spp; {card})")
    print(f"phase 8e (the estimator options): {time.time() - t_phase:.1f} s")
    return rows


# The march floors (render/params.FLOOR_OPTIONS): the reference's own
# settings (tools/stage_bench.py) and cert_u0 beside the analytic flight. All
# run the bounce entries' floor instances; the certified ones run the
# land_march and preview floor instances too
CERT_U0 = dict(march_certified_floor=True, march_uncert_floor_frac=1e-6)
FLOOR_CASES = (
    ("cert_u0", CERT_U0),
    ("cert_u001", dict(march_certified_floor=True, march_uncert_floor_frac=0.001)),
    ("cert25_u0", dict(march_certified_floor=True, march_floor_frac=0.25,
                       march_uncert_floor_frac=1e-6)),
    ("floor_sec01", dict(march_floor_frac_secondary=0.01)),
    ("floor_pri05_sec005", dict(march_floor_frac=0.05, march_floor_frac_secondary=0.005)),
    ("cert_u0, analytic_flight", dict(analytic_flight=True, **CERT_U0)),
)
FLOOR_SETTINGS = FLOOR_CASES[:5]


def _bounce_bound(torch, trips, cfg, tf, part, m):
    """(ms, "bytes" or "operations") of one half of a bounce from its
    census ``trips``, as the options rows count it: the part's own sites'
    operations, the lanes' bytes."""
    other, alu, fma = bounce_ops(torch, trips, cfg.march_k, cfg.tracking_k, tf, part)
    nbytes = (40 + 16) * m if part == "flight" else (BOUNCE_LANE_BYTES + 16) * m
    return bound(nbytes, other + alu + fma, int_ops=alu, fma_ops=fma)


def check_march_floors(torch, dev, atlas, luts, captured, tf):
    """Phase 8f, the march floors at 1920x1080 on ``atlas``: the default
    bounce instances' SASS against the parent's, the floor instances',
    land_march's and preview's ptxas and occupancy; the land_march launcher
    at each setting on phase 4's arguments (``captured``; the primary marches
    at their bounce's floor, the shadow march at its own) against its twin,
    every lane bit-equal, timed beside the default instance with its bound;
    per case (FLOOR_CASES) and scene the floor instances against their
    twin at bounces 0 and DEEP_BOUNCE and bounce_window against
    run_window_plain from the bounce the frame enters it, every lane
    bit-equal, bounce 0's two kernels on Apollo timed beside the default
    instances with their bounds; the 480x270 preview at cert_u0 and at
    cert25_u0 (phase 11's check on the floor instance: every lane
    bit-equal); the cert_u0 path on Apollo under phase 6's gates, every
    bounce launch the floor instances'; s/spp of each FLOOR_SETTINGS
    setting against its scene's default (``spp_ratio``) on the three
    scenes."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import tracers
    from digital_earth_tpu_torch.render.params import TraceConfig

    t_phase = time.time()
    card = nvidia_smi_line()
    check_default_sass(kernels)
    for src in FLOOR_SOURCES + ("land_march.cu", "preview.cu"):
        for name, (regs, stores, loads) in sorted(ptxas_entries(
                kernels.ptxas_log.get(src, "")).items()):
            print(f"ptxas {src} {name}: {regs} registers, spill stores {stores} B, loads {loads} B")
    for name in kernels.OCCUPANCY_ENTRIES:
        o = kernels.bounce_occupancy(name, options=kernels.INST_FLOORS)
        print(f"occupancy {name}: floor instance {o['registers']} registers, "
              f"{o['local_bytes']} B local, {o['warps_per_sm']} warps per SM")
    o = kernels.preview_occupancy(options=2)
    print(f"occupancy preview: floor instance {o['registers']} registers, {o['local_bytes']} B "
          f"local, {o['warps_per_sm']} warps per SM")

    # the land_march launcher at each setting on phase 4's arguments, under
    # phase 7's gates as the default instance (whose twin on the card parts
    # from it on a few lanes in a million where the texel rounds otherwise,
    # ROADMAP C #2): the lanes not bit-equal printed beside the default's
    def parting(got, want):
        kh, ph = got >= 0, want >= 0
        ok = (kh == ph) & (~(kh & ph) | _t_close(torch, got, want))
        return int((got.view(torch.int32) != want.view(torch.int32)).sum()), ok

    for (kind, b), (n_act, args, kwargs) in sorted(captured.items()):
        if kind.split("/")[0] != "land_march":
            continue
        shadow = kind == "land_march/any_hit"
        base = {k: v for k, v in kwargs.items() if k != "floor"}
        dflt = tracers.intersect_land(*args, **base)
        d_bits, _ = parting(dflt, tracers.intersect_land_plain(*args, **base))
        n = args[1].shape[0]
        b_ms, b_by = bound(args[0].numel() + 33 * n, None)
        for label, options in FLOOR_SETTINGS:
            cfg = TraceConfig(**options)
            a = args[:5] + (cfg,) + args[6:]
            kw = dict(base, floor=tracers._march_floor(a[0], cfg, None if shadow else b))
            fn = kernels.land_march
            _, d_ms = _time_ms(torch, lambda: tracers.intersect_land(*args, **base), 5)
            before = fn.launches, fn.options_launches
            got, ms = _time_ms(torch, lambda: tracers.intersect_land(*a, **kw), 5)
            if (fn.launches - before[0], fn.options_launches - before[1]) != (
                    6, 6 * int(cfg.march_certified_floor)):
                fail(f"{kind} at {label}: not the instance its floors take")
            want, plain_ms = _plain_ms(torch, lambda: tracers.intersect_land_plain(*a, **kw))
            bits, lane_ok = parting(got, want)
            err = float((got - want).abs().max()) if got.numel() else 0.0
            ok = lane_ok.float().mean().item() >= MIN_LANE_AGREEMENT
            moved = int((got != dflt).sum())
            print(f"{kind} at {label}, bounce {b} ({n} lanes, {n_act} active, {card}): "
                  f"{bits} lanes not bit-equal to the twin (the default instance at the default "
                  f"{d_bits}), max abs err {err:.3e}, {moved} lanes moved from the default's; "
                  f"kernel {ms:.3f} ms ({'floor' if cfg.march_certified_floor else 'default'} "
                  f"instance), the default instance at the default {d_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); plain {plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{kind} at {label} parts from its twin")

    default_ms = {}
    for label, options in FLOOR_CASES:
        cfg = TraceConfig(**options)
        for scene in (SCENE, FLORIDA, SUNSET):
            name = os.path.basename(scene)[9:-4]
            states, _, _ = capture_states(torch, dev, atlas, luts, scene=scene, cfg=cfg)
            for b in (0, DEEP_BOUNCE):
                if b not in states:
                    print(f"floors {label} {name}: no live lane at bounce {b}")
                    continue
                c = states[b]
                got, want, trips, cycles = _bounce_and_twin(torch, c, b)
                _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                            f"floors {label} {name} bounce {b}", exact=True)
                print(f"census floors {label} {name} bounce {b}: {c['idx'].numel()} live; "
                      f"{naive_census_text(torch, trips, range(kernels.BOUNCE_SITES))}; cycle "
                      f"split {split_text(cycle_split(torch, cycles))}")
                if b != 0 or scene != SCENE:
                    continue
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
                flight = _one_launch(kernels.bounce_flight, options,
                                     lambda: kernels.bounce_flight(*ka(_clone_state(st0))),
                                     f"floors {label} {name}")
                t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
                t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
                m = idx.numel()
                (f_b, f_by), (s_b, s_by) = (_bounce_bound(torch, trips, cfg, tf, part, m)
                                            for part in ("flight", "shade"))
                if not default_ms:
                    st_d, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,))
                    cd = st_d[0]
                    fd = pt.BounceFrame(cd["st"], *cd["args"])
                    kd = lambda s, cd=cd, fd=fd: pt._kernel_args(s, cd["idx"], 0,  # noqa: E731
                                                                 *cd["args"], fd)
                    fl = kernels.bounce_flight(*kd(_clone_state(cd["st"])))
                    default_ms.update(
                        flight=_bounce_ms(torch, cd["st"], lambda s: kernels.bounce_flight(*kd(s))),
                        shade=_bounce_ms(torch, cd["st"],
                                         lambda s: kernels.bounce_shade(*kd(s), flight=fl)))
                    del st_d, cd, fl
                d_f, d_s = default_ms["flight"], default_ms["shade"]
                print(f"floors {label} {name} bounce 0 ({m} lanes, {card}): bounce_flight "
                      f"{t_f:.3f} ms (bound {f_b:.4f}, {f_by}), bounce_shade {t_s:.3f} ms (bound "
                      f"{s_b:.4f}, {s_by}) (floor instances); the default instances at the "
                      f"default config {d_f:.3f}, {d_s:.3f} ms; flight x{t_f / d_f:.2f}, shade "
                      f"x{t_s / d_s:.2f}")
                del flight
            bounces = sorted(states)
            n = states[0]["st"].alive.numel()
            counts = [states[b]["idx"].numel() for b in bounces] + [0]
            _, wb = pt.bounce_schedule(n, counts, kernels.window_threshold(dev), 0,
                                       cfg.max_bounces)
            if wb is not None and wb in states:
                c = states[wb]
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                st = _clone_state(st0)
                _one_launch(kernels.bounce_window, options,
                            lambda: pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame),
                            f"floors {label} {name} bounce_window")
                twin = _clone_state(st0)
                pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
                lanes = idx.long()
                _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                            f"floors {label} {name} bounce_window from bounce {wb}", exact=True)
                if scene == SCENE:
                    w_ms = _bounce_ms(torch, st0, lambda s: pt.run_window(
                        s, idx, wb, cfg.max_bounces, *args, frame))
                    print(f"floors {label} {name} bounce_window from bounce {wb} "
                          f"({idx.numel()} lanes, {card}): {w_ms:.3f} ms")
            else:
                print(f"floors {label} {name}: the frame does not enter the window (live "
                      f"counts {counts[:-1]})")
            del states

    # the preview at the certified floors, phase 11's check on the floor instance
    for label, options in FLOOR_SETTINGS:
        if not options.get("march_certified_floor") or label == "cert_u001":
            continue
        counts, prow, _ = preview_frame(torch, dev, atlas, luts, f"at {label}",
                                        cfg=TraceConfig(**options))
        if counts["preview/options"] != counts["preview"]:
            fail(f"the preview frame at {label} did not launch the floor instance: {counts}")
        row = prow["preview"]
        p_b, p_by = bound(row["bytes"], row["ops"], row.get("sfu"))
        print(f"preview floor instance at {label} ({card}): {row['ms']:.3f} ms, bound "
              f"{p_b:.4f} ms ({p_by}), plain {row['plain_ms']:.1f} ms")

    # the cert_u0 path through the public entry point, counts set to 0 just
    # before it and read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None, atlas=atlas,
                       luts=luts, cfg=TraceConfig(**CERT_U0))
    for _ in range(2):
        r.accumulate()
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_main_path(torch, counts, r, img, "cert_u0 path on Apollo 11")
    if any(counts[f"{k}/options"] != counts[k] for k in
           ("bounce_flight", "bounce_shade", "bounce_window")):
        fail(f"a bounce launch of the cert_u0 path ran the default instance: {counts}")
    del r, img

    for scene in (SCENE, FLORIDA, SUNSET):
        for label, options in FLOOR_SETTINGS:
            make = lambda o: render_offline(load_config(scene), dev, spp=1,  # noqa: E731
                                            image_res=RES, out_path=None, atlas=atlas, luts=luts,
                                            cfg=TraceConfig(**o))
            d, o, ratios = spp_ratio(torch, make({}), make(options))
            print(f"floors s/spp {os.path.basename(scene)[9:-4]} {RES[0]}x{RES[1]} {label}: "
                  f"{o:.5f} against the default's {d:.5f}, ratio median "
                  f"{ratios[len(ratios) // 2]:.3f} (min-max {ratios[0]:.3f}-{ratios[-1]:.3f} "
                  f"over {len(ratios)} alternated rounds of {SPP_RATIO_STEPS} spp; {card})")
    print(f"phase 8f (the march floors): {time.time() - t_phase:.1f} s")


# The hero-packet widths other than 1 and 4 (TraceConfig.hero_lambdas), each
# from a width library of its own (kernels.width_library): the widths built
# in one batch, the scenes each is held on
WIDTHS = (2, 6, 16)
WIDTH_SCENES = {2: (SCENE, FLORIDA, SUNSET), 6: (SCENE, FLORIDA, SUNSET), 16: (SCENE,)}
# gen_rays is also held at L = 1 (the main library's) and at 3 and 7, where a
# block's runs of packet members end in a scalar tail; TAIL_LANES (lane0, n)
# leaves the last block 163 lanes; WIDE_TABLE is the widest CIE table the
# wrapper takes (its 48 KiB of shared memory and the directions' 3 KiB
# pass the 48 KiB a block takes without opting in)
RAY_WIDTHS = (1, 2, 3, 6, 7, 16)
TAIL_LANES = (77, 100003)
WIDE_TABLE = 3072
# gen_rays_kernel<L>'s SASS instructions at the widths whose lanes store
# their own packet (L = 1 and 4 of the main library, 2 of its width
# library), as built from commit f2cbdd6 for an NVIDIA H100 80GB HBM3 by nvcc
# 12.9 (chip_smoke.py --widths-bench), which the other widths' packet stores
# must leave as they were
PARENT_GEN_RAYS_SASS = {1: 1621, 2: 1695, 4: 1826}


def bounce_lane_bytes(L):
    """The bounce's bytes per live lane at L wavelengths (BOUNCE_LANE_BYTES
    at L = 4): 42 + 20 L read, 30 + 12 L written."""
    return 72 + 32 * L


# BOUNCE_FIXED_OPS counts four wavelengths' extinctions (45 each) and their
# Planck and radiance terms (37 each); gen_rays' count (GEN_RAYS_OPS) its
# four wavelengths' rotation, CIE lerp and pdf, 25 each
BOUNCE_WAVELENGTH_OPS, GEN_RAYS_WAVELENGTH_OPS = 82, 25
# the hero-packet z-test of tests/test_hero_packets.py: paths per seed,
# seeds, the bound on |z|; the chroma test's paths, seeds and variance ratio
PACKET_PATHS, PACKET_SEEDS, PACKET_Z = 3072, 6, 4.0
CHROMA_PATHS, CHROMA_SEEDS, CHROMA_RATIO = 2048, 4, 0.3
# The SASS instructions of every bounce instance of the main library (the
# default, options, estimator and floor sets; cuobjdump -sass, NOPs left
# out) built for an NVIDIA H100 80GB HBM3 by nvcc 12.9 (chip_smoke.py
# --sass-counts), which the width libraries' build must leave as they were:
# {entry<L, template flags>: instructions}. The four default bounce_flight
# instances (last flag 0), which tap nearest only, are commit 18b6e19's.
# Every other entry holds a bilinear tap and was re-recorded when
# texture.cuh's bilinear tap came to read a texel as one word (its bytes
# turned into floats by a PRMT and an FADD, u wrapped by a compare and a
# select) and the census instances gained the shade's surface-branch column:
# the 48 knob instances (options 1, estimator 2, floors 3) as they run the
# naive trackers as warp-cooperative steps (csrc/naive.cuh naive_track_warp)
# and the 24 bounce_shade_block instances (the knob sets' bounce_shade with
# the naive shadow march as block rounds, naive_march_block;
# bounce_shade_kernel's BLOCK instances).
PARENT_SASS = {
    "bounce_flight<L=1, 0, 0>": 3957, "bounce_flight<L=1, 0, 1>": 7540,
    "bounce_flight<L=1, 0, 2>": 10619, "bounce_flight<L=1, 0, 3>": 11684,
    "bounce_flight<L=1, 1, 0>": 4088, "bounce_flight<L=1, 1, 1>": 7755,
    "bounce_flight<L=1, 1, 2>": 10863, "bounce_flight<L=1, 1, 3>": 11940,
    "bounce_flight<L=4, 0, 0>": 3958, "bounce_flight<L=4, 0, 1>": 7541,
    "bounce_flight<L=4, 0, 2>": 10620, "bounce_flight<L=4, 0, 3>": 11685,
    "bounce_flight<L=4, 1, 0>": 4089, "bounce_flight<L=4, 1, 1>": 7756,
    "bounce_flight<L=4, 1, 2>": 10864, "bounce_flight<L=4, 1, 3>": 11941,
    "bounce_shade<L=1, 0, 0, 0>": 10068, "bounce_shade<L=1, 0, 0, 1>": 12159,
    "bounce_shade<L=1, 0, 0, 2>": 14067, "bounce_shade<L=1, 0, 0, 3>": 15106,
    "bounce_shade<L=1, 0, 1, 0>": 10172, "bounce_shade<L=1, 0, 1, 1>": 12239,
    "bounce_shade<L=1, 0, 1, 2>": 14386, "bounce_shade<L=1, 0, 1, 3>": 15451,
    "bounce_shade<L=1, 1, 0, 0>": 10120, "bounce_shade<L=1, 1, 0, 1>": 12227,
    "bounce_shade<L=1, 1, 0, 2>": 14160, "bounce_shade<L=1, 1, 0, 3>": 15226,
    "bounce_shade<L=1, 1, 1, 0>": 10214, "bounce_shade<L=1, 1, 1, 1>": 12328,
    "bounce_shade<L=1, 1, 1, 2>": 14518, "bounce_shade<L=1, 1, 1, 3>": 15552,
    "bounce_shade<L=4, 0, 0, 0>": 11752, "bounce_shade<L=4, 0, 0, 1>": 13794,
    "bounce_shade<L=4, 0, 0, 2>": 15655, "bounce_shade<L=4, 0, 0, 3>": 16736,
    "bounce_shade<L=4, 0, 1, 0>": 11805, "bounce_shade<L=4, 0, 1, 1>": 13859,
    "bounce_shade<L=4, 0, 1, 2>": 16030, "bounce_shade<L=4, 0, 1, 3>": 17082,
    "bounce_shade<L=4, 1, 0, 0>": 11842, "bounce_shade<L=4, 1, 0, 1>": 13994,
    "bounce_shade<L=4, 1, 0, 2>": 15962, "bounce_shade<L=4, 1, 0, 3>": 16912,
    "bounce_shade<L=4, 1, 1, 0>": 11870, "bounce_shade<L=4, 1, 1, 1>": 14060,
    "bounce_shade<L=4, 1, 1, 2>": 16311, "bounce_shade<L=4, 1, 1, 3>": 17308,
    "bounce_shade_block<L=1, 0, 0, 1>": 13173, "bounce_shade_block<L=1, 0, 0, 2>": 14994,
    "bounce_shade_block<L=1, 0, 0, 3>": 16123, "bounce_shade_block<L=1, 0, 1, 1>": 13222,
    "bounce_shade_block<L=1, 0, 1, 2>": 15324, "bounce_shade_block<L=1, 0, 1, 3>": 16423,
    "bounce_shade_block<L=1, 1, 0, 1>": 13312, "bounce_shade_block<L=1, 1, 0, 2>": 15158,
    "bounce_shade_block<L=1, 1, 0, 3>": 16215, "bounce_shade_block<L=1, 1, 1, 1>": 13312,
    "bounce_shade_block<L=1, 1, 1, 2>": 15500, "bounce_shade_block<L=1, 1, 1, 3>": 16539,
    "bounce_shade_block<L=4, 0, 0, 1>": 14753, "bounce_shade_block<L=4, 0, 0, 2>": 16643,
    "bounce_shade_block<L=4, 0, 0, 3>": 17880, "bounce_shade_block<L=4, 0, 1, 1>": 14838,
    "bounce_shade_block<L=4, 0, 1, 2>": 17014, "bounce_shade_block<L=4, 0, 1, 3>": 18060,
    "bounce_shade_block<L=4, 1, 0, 1>": 14994, "bounce_shade_block<L=4, 1, 0, 2>": 16912,
    "bounce_shade_block<L=4, 1, 0, 3>": 17971, "bounce_shade_block<L=4, 1, 1, 1>": 15052,
    "bounce_shade_block<L=4, 1, 1, 2>": 17312, "bounce_shade_block<L=4, 1, 1, 3>": 18398,
    "bounce_window<L=1, 0, 0>": 11616, "bounce_window<L=1, 0, 1>": 16273,
    "bounce_window<L=1, 0, 2>": 19873, "bounce_window<L=1, 0, 3>": 21024,
    "bounce_window<L=1, 1, 0>": 11701, "bounce_window<L=1, 1, 1>": 16269,
    "bounce_window<L=1, 1, 2>": 20200, "bounce_window<L=1, 1, 3>": 21350,
    "bounce_window<L=4, 0, 0>": 13345, "bounce_window<L=4, 0, 1>": 17885,
    "bounce_window<L=4, 0, 2>": 21564, "bounce_window<L=4, 0, 3>": 22632,
    "bounce_window<L=4, 1, 0>": 13438, "bounce_window<L=4, 1, 1>": 17985,
    "bounce_window<L=4, 1, 2>": 21989, "bounce_window<L=4, 1, 3>": 23084,
}


def check_parent_sass(kernels):
    """Every bounce instance of the main library (default, options,
    estimator and floor sets) against PARENT_SASS: fails on any difference."""
    funcs = sass_functions(kernels.library()._name)
    now = {entry: n for entry, _, n in bounce_instances(funcs).values()}
    same = sum(PARENT_SASS.get(entry) == n for entry, n in now.items())
    print(f"SASS main library: {len(now)} bounce instances, {same} at the parent's count "
          f"({len(PARENT_SASS)} recorded)")
    if now != PARENT_SASS:
        fail("a bounce instance of the main library differs from the parent's SASS: "
             + ", ".join(f"{e} {n} (parent {PARENT_SASS.get(e)})" for e, n in sorted(now.items())
                         if PARENT_SASS.get(e) != n))


def gen_rays_sass(kernels, widths=()):
    """{L: SASS instructions of gen_rays_kernel<L>} of the main library (L =
    1 and 4) and of the width libraries of ``widths``."""
    import re

    out = {}
    for lib in [kernels.library()] + [kernels.width_library(L) for L in widths]:
        for name, ops in sass_functions(lib._name).items():
            got = re.search(r"gen_rays_kernelILi(\d+)E", name)
            if got:
                out[int(got[1])] = len(ops)
    return out


@contextlib.contextmanager
def forced_floors(kernels):
    """Every bounce launch inside takes the floor instance (the instance
    ``kernels._knob_instance`` asks for)."""
    knob = kernels._knob_instance
    kernels._knob_instance = lambda fp, ip: kernels.INST_FLOORS
    try:
        yield
    finally:
        kernels._knob_instance = knob


def _ratio_cfg(cfg):
    """``cfg`` with the gases' sun transmittance by ratio tracking."""
    return dataclasses.replace(cfg, analytic_transmittance=False)


def _hold_width_instances(torch, kernels, c, b, want, tag):
    """The bounce entries of a width library on the captured state ``c`` of
    bounce ``b`` against their twin, every lane bit-equal: the floor
    instances at the state's TraceConfig (``want``: the twin's state, which
    the default instances were held to), then the default and the floor
    instances at analytic_transmittance=False; each launch counted as the
    instance it asks for."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    idx, st0, (scene, atlas, luts, cfg) = c["idx"], c["st"], c["args"]
    lanes = idx.long()
    work = st0.work_class[lanes]
    for ratio in (False, True):
        args = (scene, atlas, luts, _ratio_cfg(cfg) if ratio else cfg)
        if ratio:
            want = pt.run_bounce_plain(st0.take(lanes), b, *args)
        for floors in ((False, True) if ratio else (True,)):
            st = _clone_state(st0)
            before = kernels.bounce_flight.options_launches
            with forced_floors(kernels) if floors else contextlib.nullcontext():
                pt.run_bounce(st, idx, b, *args, pt.BounceFrame(st0, *args))
            if (kernels.bounce_flight.options_launches > before) != floors:
                fail(f"width {tag} bounce {b}: the launch took the other instance set")
            _hold_lanes(torch, st.take(lanes), want, work,
                        f"width {tag} bounce {b} {'floor' if floors else 'default'} instances"
                        f"{', ratio tracking' if ratio else ''}", exact=True)


def _hold_width_window(torch, kernels, c, wb, stop, twin, tag):
    """bounce_window of a width library from bounce ``wb`` against
    run_window_plain, every lane bit-equal: the floor instances at the
    state's TraceConfig (``twin``: the twin's state, which the default
    instances were held to), then the default and the floor instances at
    analytic_transmittance=False."""
    from digital_earth_tpu_torch.render import pathtracer as pt

    idx, st0, (scene, atlas, luts, cfg) = c["idx"], c["st"], c["args"]
    lanes = idx.long()
    for ratio in (False, True):
        args = (scene, atlas, luts, _ratio_cfg(cfg) if ratio else cfg)
        if ratio:
            twin = _clone_state(st0)
            pt.run_window_plain(twin, idx, wb, stop, *args)
        for floors in ((False, True) if ratio else (True,)):
            st = _clone_state(st0)
            with forced_floors(kernels) if floors else contextlib.nullcontext():
                pt.run_window(st, idx, wb, stop, *args, pt.BounceFrame(st0, *args))
            _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                        f"width {tag} bounce_window from bounce {wb}, "
                        f"{'floor' if floors else 'default'} instances"
                        f"{', ratio tracking' if ratio else ''}", exact=True)


def _wide_luts(torch, luts, res):
    """``luts`` with the CIE CDF and response tables resampled to ``res``
    entries (linear in the table index)."""
    import numpy as np

    x = np.linspace(0.0, 1.0, res)
    xp = np.linspace(0.0, 1.0, luts.cie_cdf.shape[0])
    resample = lambda t: torch.tensor(  # noqa: E731
        np.stack([np.interp(x, xp, col) for col in t.cpu().numpy().T], axis=1),
        dtype=torch.float32, device=t.device)
    return luts._replace(cie_cdf=resample(luts.cie_cdf), cie_response=resample(luts.cie_response))


def _gen_rays_work(luts, n, L, tf):
    """(bytes, operations, ALU-pipe and FMA-pipe instructions) of gen_rays
    on n path lanes at L wavelengths: the tables read once; keys, dirs,
    wavelengths, responses, pdf and pid written; GEN_RAYS_OPS with L's
    rotations, and threefry's work at the SASS census ``tf``."""
    nbytes = luts.cie_cdf.shape[0] * 16 + n * (16 + 12 + 20 * L + 8)
    alu, fma = tf_ops(GEN_RAYS_TF[0] * n, GEN_RAYS_TF[1] * n, tf)
    ops = (GEN_RAYS_OPS + GEN_RAYS_WAVELENGTH_OPS * (L - 4)) * n + alu + fma
    return nbytes, ops, alu, fma


def check_width_rays(torch, dev, atlas, luts, card, tf):
    """gen_rays at RAY_WIDTHS against its twin, every field bit-equal
    (``_hold_rays``): the Apollo 1920x1080 path frame, TAIL_LANES (the last
    block partial, and where 163 L is not a multiple of 4 its runs ending in
    a scalar tail), a quarter of the frame's tiles in a seeded order (an
    adaptive pass's tile list), at L = 1 the 480x270 preview, and at L = 2
    and 4 a table of WIDE_TABLE entries; then gen_rays_kernel<L>'s SASS at
    L = 1, 2 and 4 against PARENT_GEN_RAYS_SASS (fails on a difference). {L:
    the path frame's device ms}; the path frame's bound printed beside it."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts))
    cam, key = r.camera_params("cpu"), r._seed_key
    bw, bh = r.block
    n_tiles = (RES[0] // bw) * (RES[1] // bh)
    order = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(21))
    tile_ids = order[: n_tiles // 4].to(torch.int32).to(dev)
    n = RES[0] * RES[1]
    lane0, tail_n = TAIL_LANES
    path_ms = {}
    for L in RAY_WIDTHS:
        cfg = TraceConfig(hero_lambdas=L)
        cases = [("path", (key, 0, 0, n, RES, (1, RES[1]), cam, luts, False, None, cfg)),
                 (f"lanes [{lane0}, {lane0 + tail_n})",
                  (key, 1, lane0, tail_n, RES, (1, RES[1]), cam, luts, False, None, cfg)),
                 (f"tile list of {tile_ids.numel()} {bw}x{bh} tiles",
                  (key, 2, 0, tile_ids.numel() * bw * bh, RES, (bw, bh), cam, luts, False,
                   tile_ids, cfg))]
        if L == 1:
            p = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts,
                                 mode="preview"))
            cases.append((f"preview {PREVIEW_RES[0]}x{PREVIEW_RES[1]}",
                          (p._seed_key, 0, 0, PREVIEW_RES[0] * PREVIEW_RES[1], PREVIEW_RES,
                           p.block, p.camera_params("cpu"), luts, True, None, cfg)))
        if L == 2:
            wide = _wide_luts(torch, luts, WIDE_TABLE)
            for wl in (2, 4):
                cases.append((f"a {WIDE_TABLE}-entry table at L = {wl}",
                              (key, 0, 0, 65536, RES, (1, RES[1]), cam, wide, False, None,
                               TraceConfig(hero_lambdas=wl))))
        for label, args in cases:
            _, _, ms, _, dev_ms = _hold_rays(torch, f"L = {L} {label}", args)
            if label == "path":
                path_ms[L] = dev_ms
                nbytes, ops, alu, fma = _gen_rays_work(luts, n, L, tf)
                b_ms, b_by = bound(nbytes, ops, int_ops=alu, fma_ops=fma)
                print(f"gen_rays L = {L} path: bound {b_ms:.4f} ms ({b_by}); the device time is "
                      f"{b_ms / dev_ms:.2f} of it ({card})")
    sass = gen_rays_sass(kernels, [L for L in RAY_WIDTHS if L not in kernels.BOUNCE_WIDTHS])
    print(f"SASS gen_rays_kernel<L>: {sass} (before the packet stores: {PARENT_GEN_RAYS_SASS}; "
          f"{card})")
    if any(sass.get(L) != n for L, n in PARENT_GEN_RAYS_SASS.items()):
        fail(f"gen_rays_kernel<L>'s SASS {sass} is not its parent's {PARENT_GEN_RAYS_SASS} at "
             f"L = 1, 2 and 4")
    return path_ms


def _width_bounce_bound(torch, trips, cfg, tf, part, m, L):
    """(ms, "bytes" or "operations") of one half of a bounce at L, as
    _bounce_bound counts it, with the L-wide state's bytes and the
    per-wavelength operations at L."""
    other, alu, fma = bounce_ops(torch, trips, cfg.march_k, cfg.tracking_k, tf, part)
    if part == "flight":
        nbytes = (40 + 16) * m
    else:
        nbytes = (bounce_lane_bytes(L) + 16) * m
        other += m * BOUNCE_WAVELENGTH_OPS * (L - 4)
    return bound(nbytes, other + alu + fma, int_ops=alu, fma_ops=fma), other + alu + fma, alu, fma


def _trace_mean_xyz(torch, dev, atlas, luts, L, n, seed):
    """tests/test_hero_packets.py's estimator: n paths from the Apollo
    camera towards seeded points about the planet (3 bounces), the hero by
    CIE inverse CDF with L - 1 rotations, through ``pathtracer.trace_paths``
    on the card; each path's XYZ (float64, on the host)."""
    import numpy as np

    from digital_earth_tpu_torch.ops import rng
    from digital_earth_tpu_torch.ops import spectral as sp
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.params import TraceConfig, make_scene_params

    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256,
                      hero_lambdas=L)
    g = np.random.default_rng(seed)
    cam = torch.tensor([35963490.0, 12765367.0, -42445899.0], device=dev)
    target = torch.from_numpy(g.normal(size=(n, 3)) * 4e6).to(dev, torch.float32)
    dirs = torch.nn.functional.normalize(target - cam, dim=-1).contiguous()
    u = torch.from_numpy(g.uniform(size=n).astype(np.float32)).to(dev)
    wl, resp, pdf = sp.spectrum_sample_hero(u, luts.cie_cdf, luts.cie_response, L)
    rad = pt.trace_paths(rng.prng_key(seed, dev), cam.expand(n, 3).contiguous(), dirs, wl,
                         make_scene_params(dev), atlas, luts, cfg, lambda_pdf=pdf)
    return torch.einsum("nl,nlc->nc", rad, resp).double().cpu().numpy()


def packet_ztests(torch, dev, card):
    """tests/test_hero_packets.py on the card at each width: the multi-seed
    z-test of the L estimator's mean XYZ against L = 1's (|z| < PACKET_Z),
    the chroma (X - Y) variance's median over seeds against L = 1's (under
    CHROMA_RATIO at L = 4, printed at the others) and the fireflies (paths
    whose Y passes 100 times the mean Y) at each L."""
    import numpy as np

    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas

    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    luts = load_spectral_luts(dev)
    runs = {L: [_trace_mean_xyz(torch, dev, atlas, luts, L, PACKET_PATHS,
                                (10 if L == 1 else 50) + s) for s in range(PACKET_SEEDS)]
            for L in (1, 4) + WIDTHS}
    means = {L: np.stack([x.mean(0) for x in xs]) for L, xs in runs.items()}
    a = means[1]
    for L in (4,) + WIDTHS:
        b = means[L]
        sem = np.sqrt(a.var(axis=0) / PACKET_SEEDS + b.var(axis=0) / PACKET_SEEDS)
        z = (b.mean(0) - a.mean(0)) / (sem + 1e-5 * np.abs(a.mean(0)) + 1e-9)
        ok = bool((np.abs(z) < PACKET_Z).all())
        print(f"hero packet z-test L = {L} vs L = 1 ({PACKET_SEEDS} seeds of {PACKET_PATHS} paths, "
              f"3 bounces; {card}): mean XYZ {b.mean(0).tolist()} vs {a.mean(0).tolist()}, z "
              f"{[round(float(v), 3) for v in z]}  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the L = {L} packet estimator's mean parts from the L = 1 estimator's")
    chroma = {}
    for L in (1, 4) + WIDTHS:
        v = [_trace_mean_xyz(torch, dev, atlas, luts, L, CHROMA_PATHS, 100 * L + s)
             for s in range(CHROMA_SEEDS)]
        chroma[L] = float(np.median([(x[:, 0] - x[:, 1]).var() for x in v]))
        y = np.concatenate([x[:, 1] for x in runs[L]])
        print(f"hero packet L = {L}: chroma (X - Y) variance, median of {CHROMA_SEEDS} seeds of "
              f"{CHROMA_PATHS} paths, {chroma[L]:.6g} ({chroma[L] / chroma.get(1, chroma[L]):.4f} "
              f"of L = 1's); fireflies (Y > 100 x mean Y) {int((y > 100 * y.mean()).sum())} of "
              f"{y.size} paths, max Y / mean Y {y.max() / y.mean():.1f}")
    if not chroma[4] < CHROMA_RATIO * chroma[1]:
        fail(f"the L = 4 packet's chroma variance {chroma[4]} is not under {CHROMA_RATIO} of "
             f"L = 1's {chroma[1]}")


def check_widths(torch, dev, atlas, luts, tf):
    """Phase 8g, the hero-packet widths other than 1 and 4 at 1920x1080 on
    ``atlas``: the main library's bounce instances' SASS against the
    parent's; the width libraries of WIDTHS and of gen_rays' other
    RAY_WIDTHS built in one parallel batch (seconds, ptxas registers and
    spills, the entries' occupancy in both instance sets); per width and
    scene (WIDTH_SCENES) the bounce entries against their twin at bounces 0
    and DEEP_BOUNCE and bounce_window against run_window_plain from the
    bounce the frame enters it, each in the default instances (the default
    TraceConfig's) and the floor instances (forced), with the closed-form
    and the ratio-tracked sun transmittance, gen_rays on the path inputs,
    rmo_ratio_track on bounce 0's NEE lanes (at analytic_transmittance=False)
    and frame_end on the frame's end, every lane bit-equal (frame_end under
    phase 16's gate); gen_rays at RAY_WIDTHS (``check_width_rays``); the path
    on Apollo at each width under phase 6's gates, every bounce launch,
    gen_rays and frame_end counted at the width, no bounce launch an options
    one; s/spp of Apollo at each width and at L = 4 forced into its floor
    instance, against L = 4, and at each width forced into its floor
    instances against its default instances, in SPP_RATIO_ROUNDS alternated
    rounds; the hero-packet tests. Rows ``"<kernel>/L<n>"`` for the JSON line
    (launches from the width's path, times on Apollo in the default
    instances)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    t_phase = time.time()
    card = nvidia_smi_line()
    check_default_sass(kernels)
    check_parent_sass(kernels)
    print(f"SASS checks: {time.time() - t_phase:.1f} s")
    t0 = time.time()
    built = sorted(set(WIDTHS) | set(RAY_WIDTHS) - set(kernels.BOUNCE_WIDTHS))
    kernels.build_width_libraries(built)
    print(f"width libraries L = {', '.join(map(str, built))}: built in one parallel batch in "
          f"{time.time() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)} -DDE_WIDTH=L; {card})")
    for L in built:
        for src, log in sorted(kernels.width_ptxas_log.get(L, {}).items()):
            for name, (regs, stores, loads) in sorted(ptxas_entries(log).items()):
                print(f"ptxas L = {L} {src} {name}: {regs} registers, spill stores {stores} B, "
                      f"loads {loads} B")
    for L in WIDTHS:
        for name in kernels.OCCUPANCY_ENTRIES:
            for label, inst in (("default", kernels.INST_DEFAULT), ("floor", kernels.INST_FLOORS)):
                o = kernels.bounce_occupancy(name, inst, width=L)
                print(f"occupancy {name} L = {L}: {label} instance {o['registers']} registers, "
                      f"{o['local_bytes']} B local, {o['warps_per_sm']} warps per SM")

    rows = {}
    for L in WIDTHS:
        cfg = TraceConfig(hero_lambdas=L)
        for scene in WIDTH_SCENES[L]:
            name = os.path.basename(scene)[9:-4]
            apollo = scene == SCENE
            t_scene = time.time()
            states, _, end_args = capture_states(torch, dev, atlas, luts, scene=scene, cfg=cfg)
            tag = f"L = {L} {name}"
            # bounce 0's input state is the rays': the ratio tracker's NEE
            # lanes come from its twin at analytic_transmittance=False there
            c0 = states[0]
            ratio_c = dict(c0, args=(*c0["args"][:3], TraceConfig(hero_lambdas=L,
                                                                  analytic_transmittance=False)))
            for b in (0, DEEP_BOUNCE):
                c = states[b]
                got, want, trips, cycles = _bounce_and_twin(torch, c, b)
                _hold_lanes(torch, got, want, c["st"].work_class[c["idx"].long()],
                            f"width {tag} bounce {b} default instances", exact=True)
                print(f"census width {tag} bounce {b}: {c['idx'].numel()} live; cycle split "
                      f"{split_text(cycle_split(torch, cycles))}")
                _hold_width_instances(torch, kernels, c, b, want, tag)
                del got, want
                if b != 0 or not apollo:
                    continue
                idx, st0, args = c["idx"], c["st"], c["args"]
                frame = pt.BounceFrame(st0, *args)
                ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
                flight = kernels.bounce_flight(*ka(_clone_state(st0)))
                t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
                t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
                m = idx.numel()
                for part, ms in (("flight", t_f), ("shade", t_s)):
                    (b_ms, b_by), ops, alu, fma = _width_bounce_bound(torch, trips, cfg, tf, part,
                                                                     m, L)
                    nbytes = (40 + 16) * m if part == "flight" else (bounce_lane_bytes(L) + 16) * m
                    rows[f"bounce_{part}/L{L}"] = dict(
                        max_abs_err=0.0, ms=ms, plain_ms=None, bytes=nbytes, ops=ops,
                        int_ops=alu, fma_ops=fma)
                    print(f"width {tag} bounce 0 bounce_{part} ({m} lanes, {card}): {ms:.3f} ms, "
                          f"bound {b_ms:.4f} ms ({b_by})")
                with forced_floors(kernels):
                    t_ff = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
                    t_sf = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s),
                                                                                 flight=flight))
                print(f"width {tag} bounce 0 floor instances: bounce_flight {t_ff:.3f} ms, "
                      f"bounce_shade {t_sf:.3f} ms, beside the default instances' {t_f:.3f} + "
                      f"{t_s:.3f} ({card})")
                t0 = time.time()
                pt.run_bounce_plain(st0.take(idx.long()), 0, *args)
                torch.cuda.synchronize()
                plain = (time.time() - t0) * 1e3
                for part in ("flight", "shade"):
                    rows[f"bounce_{part}/L{L}"]["plain_ms"] = plain
                del flight
            bounces = sorted(states)
            n = states[0]["st"].alive.numel()
            counts = [states[b]["idx"].numel() for b in bounces] + [0]
            _, wb = pt.bounce_schedule(n, counts, kernels.window_threshold(dev), 0,
                                       cfg.max_bounces)
            if wb is None or wb not in states:
                fail(f"width {tag}: the frame does not enter the window ({counts[:-1]})")
            c = states[wb]
            idx, st0, args = c["idx"], c["st"], c["args"]
            frame = pt.BounceFrame(st0, *args)
            st = _clone_state(st0)
            pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame)
            twin = _clone_state(st0)
            t0 = time.time()
            pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
            torch.cuda.synchronize()
            w_plain = (time.time() - t0) * 1e3
            lanes = idx.long()
            _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                        f"width {tag} bounce_window from bounce {wb}", exact=True)
            _hold_width_window(torch, kernels, c, wb, cfg.max_bounces, twin, tag)
            del st, twin
            if apollo:
                w_ms = _bounce_ms(torch, st0, lambda s: pt.run_window(
                    s, idx, wb, cfg.max_bounces, *args, frame))
                # the window's operations: each bounce's census from wb on
                ops = alu = fma = 0.0
                for b in bounces:
                    if b < wb:
                        continue
                    cb = states[b]
                    trips_b, _, _ = _census(torch, cb["st"], cb["idx"], b, cb["args"],
                                            pt.BounceFrame(cb["st"], *cb["args"]))
                    for part in ("flight", "shade"):
                        _, o, a, f = _width_bounce_bound(torch, trips_b, cfg, tf, part,
                                                         cb["idx"].numel(), L)
                        ops, alu, fma = ops + o, alu + a, fma + f
                nbytes = bounce_lane_bytes(L) * idx.numel()
                b_ms, b_by = bound(nbytes, ops, int_ops=alu, fma_ops=fma)
                rows[f"bounce_window/L{L}"] = dict(max_abs_err=0.0, ms=w_ms, plain_ms=w_plain,
                                                   bytes=nbytes, ops=ops, int_ops=alu, fma_ops=fma)
                with forced_floors(kernels):
                    w_floor = _bounce_ms(torch, st0, lambda s: pt.run_window(
                        s, idx, wb, cfg.max_bounces, *args, frame))
                print(f"width {tag} bounce_window from bounce {wb} ({idx.numel()} lanes, {card}): "
                      f"{w_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), twin {w_plain:.1f} ms; "
                      f"floor instance {w_floor:.3f} ms")
            del states
            erow = check_frame_end(torch, end_args, f"width {tag} {RES[0]}x{RES[1]}")
            del end_args
            r = Renderer(dev, image_res=RES, atlas=atlas, luts=luts, cfg=cfg)
            apply_config(r, load_config(scene))
            rargs = (r._seed_key, 0, 0, RES[0] * RES[1], RES, (1, RES[1]), r.camera_params("cpu"),
                     luts, False, None, cfg)
            _, g_err, g_ms, g_plain, g_dev = _hold_rays(torch, f"width {tag} path "
                                                        f"{RES[0]}x{RES[1]}", rargs)
            del r
            rrow, _ = check_ratio_track(torch, capture_ratio_args(torch, ratio_c, 0),
                                        f"width {tag} bounce 0 NEE lanes", tf)
            del ratio_c
            print(f"width {tag}: {time.time() - t_scene:.1f} s")
            if apollo:
                nbytes, g_ops, g_alu, g_fma = _gen_rays_work(luts, RES[0] * RES[1], L, tf)
                rows[f"gen_rays/L{L}"] = dict(max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
                                              bytes=nbytes, ops=g_ops, int_ops=g_alu,
                                              fma_ops=g_fma)
                rows[f"frame_end/L{L}"] = erow
                rows[f"rmo_ratio_track/L{L}"] = rrow
                b_ms, b_by = bound(nbytes, g_ops, int_ops=g_alu, fma_ops=g_fma)
                print(f"width {tag} gen_rays: device {g_dev:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                      f"{card})")

        # the path at L through the public entry point, counts set to 0
        # just before it and read just after
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None,
                           atlas=atlas, luts=luts, cfg=cfg)
        for _ in range(2):
            r.accumulate()
        img = r.fetch_image()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_main_path(torch, counts, r, img, f"L = {L} path on Apollo 11")
        widths = ("bounce_flight", "bounce_shade", "bounce_window", "gen_rays", "frame_end")
        if any(counts.get(f"{k}/L{L}", 0) != counts[k] for k in widths):
            fail(f"a launch of the L = {L} path ran at another width: {counts}")
        if any(counts.get(f"{k}/options", 0) for k in widths[:3]):
            fail(f"the L = {L} path at the default TraceConfig ran an options instance: {counts}")
        for k in widths + ("rmo_ratio_track",):
            rows[f"{k}/L{L}"]["launches"] = counts.get(f"{k}/L{L}", 0)
        del r, img

    path_ms = check_width_rays(torch, dev, atlas, luts, card, tf)
    print(f"gen_rays on the Apollo {RES[0]}x{RES[1]} path frame on the device: "
          + ", ".join(f"L = {L} {ms:.4f} ms" for L, ms in path_ms.items()) + f" ({card})")

    # s/spp at each width and at L = 4 forced into its floor instance, each
    # against L = 4 at its default instance; each width forced into its
    # floor instances against its default instances
    class Forced:
        """A renderer whose bounce launches take the floor instance."""

        def __init__(self, r):
            self.r = r

        def accumulate(self):
            with forced_floors(kernels):
                self.r.accumulate()

    make = lambda **kw: render_offline(load_config(SCENE), dev, spp=1,  # noqa: E731
                                       image_res=RES, out_path=None, atlas=atlas, luts=luts,
                                       cfg=TraceConfig(**kw))
    pairs = [(f"L = {L}", "L = 4's", {}, dict(hero_lambdas=L), False) for L in WIDTHS]
    pairs += [("L = 4 floor instance", "L = 4's", {}, {}, True)]
    pairs += [(f"L = {L} floor instances", "its default instances'", dict(hero_lambdas=L),
               dict(hero_lambdas=L), True) for L in WIDTHS]
    for label, base_label, base, kw, floors in pairs:
        other = make(**kw)
        if floors:
            other = Forced(other)
            before = kernels.bounce_flight.options_launches
            other.accumulate()
            if kernels.bounce_flight.options_launches == before:
                fail(f"{label}: the forced renderer ran no floor instance")
        d, o, ratios = spp_ratio(torch, make(**base), other)
        print(f"widths s/spp Apollo 11 {RES[0]}x{RES[1]} {label}: {o:.5f} against {base_label} "
              f"{d:.5f}, ratio median {ratios[len(ratios) // 2]:.3f} (min-max {ratios[0]:.3f}-"
              f"{ratios[-1]:.3f} over {len(ratios)} alternated rounds of {SPP_RATIO_STEPS} spp; "
              f"{card})")
        del other
    t0 = time.time()
    packet_ztests(torch, dev, card)
    print(f"hero packet tests: {time.time() - t0:.1f} s")
    print(f"phase 8g (the hero-packet widths): {time.time() - t_phase:.1f} s")
    return rows


BENCH_RAY_WIDTHS = (1, 2, 3, 4, 6, 7, 16)


def widths_bench(torch, dev):
    """``--widths-bench [DIR]``: the hero-packet widths of the package
    imported from DIR, so that versions can be alternated in one call: the
    main library's and the width libraries' (those of BENCH_RAY_WIDTHS
    outside the main library, one batch) build seconds (near 0 where built
    before), ptxas's registers and spills of
    gen_rays.cu and of each width library's bounce sources,
    gen_rays_kernel<L>'s SASS instructions, gen_rays per call and on the
    device (CUDA graph) on the Apollo 1920x1080 path frame at
    BENCH_RAY_WIDTHS and on the 480x270 preview, bounce 0's bounce_flight and
    bounce_shade ms at each width and at L = 4 (the instances the default
    TraceConfig takes), and Apollo's s/spp at each of WIDTHS against L = 4
    (``spp_ratio``). One JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import raygen
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line())
    t0 = time.time()
    kernels.library()
    out["main_build_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    built = [L for L in BENCH_RAY_WIDTHS if L not in kernels.BOUNCE_WIDTHS]
    kernels.build_width_libraries(built)
    out["width_build_s"] = round(time.time() - t0, 1)
    ptxas = {f"main {src}": ptxas_entries(log) for src, log in kernels.ptxas_log.items()
             if src == "gen_rays.cu"}
    for L in built:
        for src, log in kernels.width_ptxas_log.get(L, {}).items():
            if src == "gen_rays.cu" or src.startswith("width"):
                ptxas[f"L{L} {src}"] = ptxas_entries(log)
    out["ptxas"] = ptxas
    out["gen_rays_sass"] = gen_rays_sass(kernels, built)
    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts))
    p = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    cases = [(f"path L{L}", (r._seed_key, 0, 0, RES[0] * RES[1], RES, (1, RES[1]),
                             r.camera_params("cpu"), luts, False, None,
                             TraceConfig(hero_lambdas=L))) for L in BENCH_RAY_WIDTHS]
    cases.append(("preview L1", (p._seed_key, 0, 0, PREVIEW_RES[0] * PREVIEW_RES[1],
                                 PREVIEW_RES, p.block, p.camera_params("cpu"), luts, True)))
    rays = {}
    for label, args in cases:
        _, ms = _time_ms(torch, lambda: raygen.gen_rays(*args), 20)
        rays[label] = dict(ms=round(ms, 4),
                           device_ms=round(_graph_ms(torch, lambda: raygen.gen_rays(*args)), 4))
    out["gen_rays"] = rays
    bounce = {}
    for L in (4,) + WIDTHS:
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=SCENE,
                                      cfg=TraceConfig(hero_lambdas=L))
        c = states[0]
        frame = pt.BounceFrame(c["st"], *c["args"])
        ka = lambda s: pt._kernel_args(s, c["idx"], 0, *c["args"], frame)  # noqa: E731
        flight = kernels.bounce_flight(*ka(_clone_state(c["st"])))
        bounce[f"L{L}"] = dict(
            flight_ms=round(_bounce_ms(torch, c["st"], lambda s: kernels.bounce_flight(*ka(s))), 4),
            shade_ms=round(_bounce_ms(torch, c["st"], lambda s: kernels.bounce_shade(
                *ka(s), flight=flight)), 4))
        del states, c, flight
    out["bounce0"] = bounce
    make = lambda **kw: render_offline(load_config(SCENE), dev, spp=1,  # noqa: E731
                                       image_res=RES, out_path=None, atlas=atlas, luts=luts,
                                       cfg=TraceConfig(**kw))
    spp = {}
    for L in WIDTHS:
        d, o, ratios = spp_ratio(torch, make(), make(hero_lambdas=L))
        spp[f"L{L}"] = dict(s_per_spp=round(o, 5), l4_s_per_spp=round(d, 5),
                            ratio_median=round(ratios[len(ratios) // 2], 4),
                            ratios=[round(x, 4) for x in ratios])
    out["s_per_spp"] = spp
    print(json.dumps({"widths_bench": out}))


def options_bench(torch, dev, only=()):
    """``--options-bench [DIR [SETTING ...]]``: the options instances'
    settings of phases 8c, 8d, 8e and 8f (OPTION_CASES, all seven on Apollo,
    the five on florida; NAIVE_CASES on the three scenes, ESTIMATOR_SPP on
    Apollo;
    FLOOR_SETTINGS on Apollo and sunset; NAIVE_KNOB_CASES and the default
    config against itself on the three scenes) for the package imported
    from DIR, each setting whose options that package's TraceConfig has (and
    whose label, or label and scene as its key in the JSON line, is among the
    SETTINGs given, if any): bounce 0's
    bounce_flight and bounce_shade ms (the options instances) and s/spp
    against its base (the scene's default, naive_tracking's the L = 1
    estimator; ``spp_ratio``), so that versions can be alternated in one
    call. One JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.params import TraceConfig

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line())
    settings = [(label, options, {}, scene) for label, options, scene in
                OPTION_CASES + ALL_SEVEN_CASES[:1] + FIVE_CASES[:1]]
    settings += [(label, options, base, SCENE) for label, options, base in NAIVE_CASES]
    settings += [(label, options, base, s) for label, options, base in NAIVE_CASES
                 for s in (FLORIDA, SUNSET)]
    settings += [(label, options, {}, SCENE) for label, options in ESTIMATOR_SPP]
    settings += [(label, options, {}, s) for label, options in FLOOR_SETTINGS
                 for s in (SCENE, SUNSET)]
    settings += [(label, options, base, s) for label, options, base in NAIVE_KNOB_CASES
                 for s in (SCENE, FLORIDA, SUNSET)]
    settings += [("default", {}, {}, s) for s in (SCENE, FLORIDA, SUNSET)]
    fields = TraceConfig.__dataclass_fields__
    for label, options, base, scene in settings:
        key = f"{label} {os.path.basename(scene)[9:-4]}"
        if not set(options) <= set(fields) or (only and label not in only and key not in only):
            continue
        states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=scene,
                                      cfg=TraceConfig(**options))
        c = states[0]
        frame = pt.BounceFrame(c["st"], *c["args"])
        ka = lambda s: pt._kernel_args(s, c["idx"], 0, *c["args"], frame)  # noqa: E731
        flight = kernels.bounce_flight(*ka(_clone_state(c["st"])))
        t_f = _bounce_ms(torch, c["st"], lambda s: kernels.bounce_flight(*ka(s)))
        t_s = _bounce_ms(torch, c["st"], lambda s: kernels.bounce_shade(*ka(s), flight=flight))
        del states, c, flight
        make = lambda o: render_offline(load_config(scene), dev, spp=1, image_res=RES,  # noqa: E731
                                        out_path=None, atlas=atlas, luts=luts,
                                        cfg=TraceConfig(**o))
        d, o, ratios = spp_ratio(torch, make(base), make(options))
        out[f"{label} {os.path.basename(scene)[9:-4]}"] = dict(
            flight_ms=round(t_f, 4), shade_ms=round(t_s, 4), s_per_spp=round(o, 5),
            default_s_per_spp=round(d, 5), ratio_median=round(ratios[len(ratios) // 2], 4),
            ratios=[round(x, 4) for x in ratios])
    print(json.dumps({"options_bench": out}))

def naive_bench(torch, dev, march_only=False):
    """``--naive-bench [DIR [march]]``: the naive launchers (``naive_march``,
    ``naive_delta_track`` of both species, ``naive_ratio_track`` of both) of
    the package imported from DIR on the calls of the twin's bounce
    (``capture_naive_calls``) at naive_tracking (every launcher) and at
    naive_march (the march's three sites) on the three scenes at bounces 0
    and DEEP_BOUNCE: per call ms (three calls back to back), on the device
    (a CUDA graph of 20) and the lanes' steps, each call held bit-equal to
    its twin with its steps (fails otherwise), the march's calls with their
    block rounds replayed (``march_rounds``); then per scene bounce 0 under
    naive_cloud_tracking, naive_march and naive_shadow: its two kernels' ms
    and the census's warp cycles per site (``warp_cycles``), and under
    naive_cloud_tracking the NEE cloud pass's steps, its iterations one
    thread a lane (the sum over warps of the longest lane's steps) and as
    warp-cooperative rounds (``naive_rounds``), so that versions can be
    alternated in one call; with ``march_only`` (``march`` after DIR) the
    march's calls and censuses alone. One JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import tracking_naive as tn
    from digital_earth_tpu_torch.render.params import TraceConfig

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    from digital_earth_tpu_torch import kernels

    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line())
    # the census of a march step and its SASS, where the package has them
    census = hasattr(kernels, "bench_library")
    if census:
        out["step_sass"] = naive_step_sass(kernels)
    for scene in (SCENE, FLORIDA, SUNSET):
        for label in ("naive_tracking", "naive_march"):
            cfg = TraceConfig(**dict((c[0], c[1]) for c in NAIVE_CASES)[label])
            states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE),
                                          scene=scene, cfg=cfg)
            for b in sorted(states):
                seen = {}
                for name, args in capture_naive_calls(torch, states[b], b):
                    march = name == "intersect_land_naive"
                    if march_only and not march:
                        continue
                    got, steps = _naive_launcher(torch, name, args, iters=True)
                    trips = torch.zeros_like(steps)
                    want = getattr(tn, f"{name}_plain")(*args, trips=trips)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                               for g, w in zip(got, want)) and torch.equal(steps, trips)
                    tag = f"{NAIVE_ROWS[name]}{'' if march else '/' + args[8]}"
                    seen[tag] = seen.get(tag, 0) + 1
                    key = (f"{os.path.basename(scene)[9:-4]} b{b} "
                           + (f"{label} {tag} #{seen[tag]}" if march else tag))
                    if not same:
                        fail(f"naive bench {key}: the launcher parts from its twin")
                    # the march's scale as a float, so that the capture reads no tensor
                    targs = (*args[:3], float(args[3]), *args[4:]) if march else args
                    _, ms = _time_ms(torch, lambda: _naive_launcher(torch, name, targs), 3)
                    dev_ms = _graph_ms(torch, lambda: _naive_launcher(torch, name, targs))
                    t = steps[steps > 0]
                    out[key] = dict(ms=round(ms, 4), device_ms=round(dev_ms, 4),
                                    lanes=int(t.numel()), steps=int(t.sum()),
                                    max_steps=int(t.max()) if t.numel() else 0, bit_equal=same)
                    if march:
                        r_simt, issued, solo = march_rounds(torch, trips)
                        out[key].update(one_thread_simt=simt_efficiency(torch, trips[:, None])[0],
                                        rounds_simt=r_simt, rounds_warp_steps=issued,
                                        one_thread_warp_steps=solo)
                        if census and not args[5].bilinear_tracking:
                            out[key]["step_census"] = march_step_census(torch, args, want[0],
                                                                        trips)
            del states
    nee = CENSUS_SITE_NAMES.index("nee_cloud")
    for scene in (SCENE, FLORIDA, SUNSET):
        for label in ("naive_cloud_tracking", "naive_march", "naive_shadow")[int(march_only):]:
            cfg = TraceConfig(**dict((c[0], c[1]) for c in NAIVE_CASES)[label])
            states, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), scene=scene,
                                          cfg=cfg)
            c = states[0]
            idx, st0, args = c["idx"], c["st"], c["args"]
            frame = pt.BounceFrame(st0, *args)
            ka = lambda s: pt._kernel_args(s, idx, 0, *args, frame)  # noqa: E731
            flight = kernels.bounce_flight(*ka(_clone_state(st0)))
            t_f = _bounce_ms(torch, st0, lambda s: kernels.bounce_flight(*ka(s)))
            t_s = _bounce_ms(torch, st0, lambda s: kernels.bounce_shade(*ka(s), flight=flight))
            trips, _, cycles = _census(torch, st0, idx, 0, args, frame)
            wc = warp_cycles(torch, cycles).tolist()
            m = trips.shape[0]
            entry = dict(lanes=m, flight_ms=round(t_f, 4), shade_ms=round(t_s, 4),
                         warp_cycles=dict(zip(
                             CENSUS_SITE_NAMES + ("flight", "shade", "surface"), wc)))
            if label == "naive_cloud_tracking":
                nt = trips[:, nee]
                per_warp = torch.cat([nt, nt.new_zeros((-m) % 32)]).view(-1, 32).amax(1)
                simt, rounds, solo = naive_rounds(torch, nt)
                took = nt[nt > 0]
                entry["nee_cloud"] = dict(lanes=int(took.numel()), steps=int(took.sum()),
                                          max_steps=int(nt.max()) if m else 0,
                                          one_thread_iterations=int(per_warp.sum()),
                                          one_thread_simt=simt_efficiency(torch, nt[:, None])[0],
                                          rounds=rounds, rounds_simt=simt,
                                          solo_round_share=solo)
            else:
                entry["march_sites"] = {CENSUS_SITE_NAMES[k]: dict(
                    steps=int(trips[:, k].sum()),
                    rounds_simt=march_rounds(torch, trips[:, k])[0],
                    one_thread_simt=simt_efficiency(torch, trips[:, k:k + 1])[0])
                    for k in NAIVE_SITES[label]}
            out[f"{os.path.basename(scene)[9:-4]} b0 {label} census"] = entry
            del states, c, flight
    print(json.dumps({"naive_bench": out}))


def check_window(torch, states, table):
    """bounce_window against run_window_plain from the bounce at which the
    captured Apollo frame enters the window (bounce_schedule at
    kernels.window_threshold), lane by lane under the bounce's gates; its ms
    against the per-bounce launches it replaces; and the crossover: for
    each start b from WINDOW_STARTS before the threshold's bounce to two
    after it, the ms of one-launch-per-bounce from the first of them up to b
    and the window from b. Returns (JSON row, the window's bounce, the
    schedule, {b: that schedule's ms})."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import pathtracer as pt

    bounces = sorted(states)
    n = states[0]["st"].alive.numel()
    cfg = states[0]["args"][3]
    threshold = kernels.window_threshold(states[0]["st"].pos.device)
    counts = [states[b]["idx"].numel() for b in bounces] + [0]
    single, wb = pt.bounce_schedule(n, counts, threshold, 0, cfg.max_bounces)
    print(f"window: threshold {threshold} lanes (SMs x bounce_window's resident threads); "
          f"Apollo's live counts {counts[:-1]}: one launch per bounce for bounces {single}, "
          f"the window from bounce {wb}")
    if wb is None or wb not in states:
        fail(f"the captured frame does not enter the window ({wb})")
    c = states[wb]
    idx, st0, args = c["idx"], c["st"], c["args"]
    frame = pt.BounceFrame(st0, *args)
    st = _clone_state(st0)
    pt.run_window(st, idx, wb, cfg.max_bounces, *args, frame)
    torch.cuda.synchronize()
    ms = _bounce_ms(torch, st0, lambda s: pt.run_window(s, idx, wb, cfg.max_bounces, *args, frame))
    twin = _clone_state(st0)
    t0 = time.time()
    pt.run_window_plain(twin, idx, wb, cfg.max_bounces, *args)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    lanes = idx.long()
    err = _hold_lanes(torch, st.take(lanes), twin.take(lanes), st0.work_class[lanes],
                      f"bounce_window from bounce {wb}")
    per_bounce = sum(table[b]["ms"] for b in table if b >= wb)
    print(f"bounce_window from bounce {wb} ({idx.numel()} lanes, {cfg.max_bounces - wb} "
          f"bounces): {ms:.3f} ms in one launch against {per_bounce:.3f} ms of bounce_flight + "
          f"bounce_shade launches (their kernel time alone) from there; twin {plain_ms:.1f} ms")
    ops = sum(table[b]["ops"] for b in table if b >= wb)
    int_ops = sum(table[b]["int_ops"] for b in table if b >= wb)
    fma_ops = sum(table[b]["fma_ops"] for b in table if b >= wb)
    first = max(wb - WINDOW_STARTS, 0)
    starts = {}
    for b in range(first, min(wb + 3, cfg.max_bounces)):
        if b not in states or b not in table:
            break
        c = states[b]
        frame_b = pt.BounceFrame(c["st"], *c["args"])
        w_ms = _bounce_ms(torch, c["st"], lambda s: pt.run_window(
            s, c["idx"], b, cfg.max_bounces, *c["args"], frame_b))
        starts[b] = sum(table[j]["ms"] for j in range(first, b)) + w_ms
        print(f"window crossover: bounces {first}-{b - 1} one launch each "
              f"({starts[b] - w_ms:.3f} ms), then bounce_window from bounce {b} "
              f"({states[b]['idx'].numel()} lanes, {w_ms:.3f} ms): {starts[b]:.3f} ms"
              + ("  <- the threshold's schedule" if b == wb else ""))
    best = min(starts, key=starts.get)
    print(f"window crossover: the least kernel time from bounce {first} starts the window at "
          f"bounce {best} ({starts[best]:.3f} ms against {starts[wb]:.3f} at bounce {wb}; the "
          f"kernels' time alone: each launch before the window also takes a compact_lanes and "
          f"a host read)")
    # each lane's state read and written once for the whole window
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=BOUNCE_LANE_BYTES * idx.numel(),
                ops=ops, int_ops=int_ops, fma_ops=fma_ops), wb, (single, wb), starts


def _compact_times(torch, compact_lanes, alive, wc):
    """compact_lanes's ms per call two ways, with torch.argsort(stable=True)
    (the same order) timed alike: back to back from the host (``_time_ms``,
    5 calls between two events: the host's launch cost included, the way a
    bounce loop pays it) and on the device alone (``_graph_ms``, 20 calls
    replayed in a CUDA graph: no host time between the launches). Returns
    ((idx, n_live), {"call", "device", "library_call", "library_device"})."""
    out, call = _time_ms(torch, lambda: compact_lanes(alive, wc), 5)
    key = torch.where(alive, wc.clamp(0, 2), 3)
    _, lib_call = _time_ms(torch, lambda: torch.argsort(key, stable=True), 5)
    t = dict(call=call, device=_graph_ms(torch, lambda: compact_lanes(alive, wc)),
             library_call=lib_call)
    try:
        t["library_device"] = _graph_ms(torch, lambda: torch.argsort(key, stable=True))
    except RuntimeError as e:  # the yardstick's own launches may not capture
        print(f"torch.argsort in a CUDA graph: {e}")
        t["library_device"] = None
    return out, t


def check_compact(torch, states, deepest):
    """compact_lanes against its plain twin, bit for bit, on the alive
    vectors of bounces 0, DEEP_BOUNCE and the deepest bounce reached, and on
    1920x1080 vectors with no lane alive, every lane alive and no lane at
    all: a JSON row (DEEP_BOUNCE's times per call from the host, back to
    back, as earlier rows were timed; torch.argsort(stable=True) alike as
    the yardstick; the device times printed beside them)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import compact

    cases = [(f"bounce {b}", states[b]["st"].alive, states[b]["st"].work_class)
             for b in (0, DEEP_BOUNCE)]
    cases.append((f"bounce {deepest['bounce']} (deepest)", deepest["alive"],
                  deepest["work_class"]))
    wc = states[DEEP_BOUNCE]["st"].work_class
    cases += [("all dead", torch.zeros_like(cases[0][1]), wc),
              ("all alive", torch.ones_like(cases[0][1]), wc),
              ("empty", cases[0][1][:0], wc[:0])]
    row = dict(max_abs_err=0.0)
    for label, alive, wc in cases:
        (k_idx, k_n), t = _compact_times(torch, kernels.compact_lanes, alive, wc)
        (p_idx, p_n), plain_ms = _plain_ms(torch, lambda: compact.compact_by_alive_plain(alive, wc))
        n = int(p_n)
        equal = int(k_n) == n and torch.equal(k_idx[:n], p_idx[:n])
        lib_dev = "-" if t["library_device"] is None else f"{t['library_device']:.4f}"
        print(f"compact_lanes {label}: {alive.numel()} lanes, {n} alive; list and count "
              f"bit-equal {equal}  kernel {t['call']:.4f} ms per call from the host, back to "
              f"back, {t['device']:.4f} ms on the device ({kernels.COMPACT_STAGES} launches per "
              f"call: the scratch reset and one kernel)  plain {plain_ms:.2f} ms  "
              f"torch.argsort(stable=True) {t['library_call']:.4f} ms per call, {lib_dev} ms on "
              f"the device  {'ok' if equal else 'FAIL'}")
        if not equal:
            fail(f"compact_lanes disagrees with its plain twin ({label})")
        if label == f"bounce {DEEP_BOUNCE}":
            # alive and work_class read once, the live list and count written
            row.update(ms=t["call"], plain_ms=plain_ms, library_ms=t["library_call"],
                       bytes=5 * alive.numel() + 4 * n + 4, ops=None)
    return row


def check_window_spp(torch, dev, atlas, luts, schedule):
    """One 1920x1080 Apollo spp (the capture frame's seed and round) under
    the window schedule bit-equal to the same spp with one launch per
    bounce (window_at=0); the windowed run's launches of bounce and
    bounce_window as bounce_schedule predicts from the capture's counts."""
    import functools

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render.renderer import Renderer

    bufs, runs = [], {}
    run_bounces = pt.run_bounces
    for label, window_at in (("per bounce", 0), ("windowed", None)):
        r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts))
        pt.run_bounces = functools.partial(run_bounces, window_at=window_at)
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.time()
            r.accumulate()
            torch.cuda.synchronize()
            runs[label] = (time.time() - t0, kernels.launch_counts())
        finally:
            pt.run_bounces = run_bounces
        bufs.append(r.color_buffer)
    equal = torch.equal(*bufs)
    single, wb = schedule
    counts = runs["windowed"][1]
    wide = counts["bounce_flight"]
    launches_ok = wide == len(single) and counts["bounce_window"] == (wb is not None)
    print(f"windowed spp {RES[0]}x{RES[1]}: bit-equal to the per-bounce spp {equal}; "
          f"{runs['windowed'][0]:.3f} s against {runs['per bounce'][0]:.3f} s (first spp of "
          f"each); wide-bounce launches {wide} (schedule {len(single)}), bounce_window "
          f"{counts['bounce_window']}, compact_lanes {counts['compact_lanes']}  "
          f"{'ok' if equal and launches_ok else 'FAIL'}")
    if not (equal and launches_ok):
        fail("the windowed spp is not bit-equal to the per-bounce spp, or its launches are not "
             "the schedule's")


DRAINE_STEPS = ("t3", "t4a", "t4", "t4p3", "t6", "t5", "inner", "s", "cos")


def draine_steps(torch, u):
    """The twin's Draine sampler (models/volume.sample_draine_cos) step by
    step, in its own operations: the intermediates DRAINE_STEPS."""
    from digital_earth_tpu_torch.models import volume as vol
    from digital_earth_tpu_torch.ops.math_utils import rdiv

    g, a = vol.CLOUD_G_DRAINE, vol.CLOUD_ALPHA_DRAINE
    g2 = g * g
    g3, g4 = g * g2, g2 * g2
    g6 = g2 * g4
    pgp1_2 = (1.0 + g2) * (1.0 + g2)
    t1a = -a + a * g4
    t1a3 = t1a * t1a * t1a
    t2 = -1296.0 * (-1.0 + g2) * (a - a * g2) * t1a * (4.0 * g2 + a * pgp1_2)
    t3 = 3.0 * g2 * (1.0 + g * (-1.0 + 2.0 * u)) + a * (
        2.0 + g2 + g3 * (1.0 + 2.0 * g2) * (-1.0 + 2.0 * u))
    t4a = 432.0 * t1a3 + t2 + 432.0 * (a - a * g2) * t3 * t3
    t4b = -144.0 * a * g2 + 288.0 * a * g4 - 144.0 * a * g6
    t4 = t4a + torch.sqrt(torch.clamp(-4.0 * (t4b * t4b * t4b) + t4a * t4a, min=0.0))
    t4p3 = torch.pow(t4, 1.0 / 3.0)
    cbrt2 = 2.0 ** (1.0 / 3.0)
    pre = (2.0 * t1a + rdiv(48.0 * cbrt2 * (-(a * g2) + 2.0 * a * g4 - a * g6), t4p3)
           + t4p3 / (3.0 * cbrt2))
    t6 = pre / (a - a * g2)
    t5 = 6.0 * (1.0 + g2) + t6
    inner = (6.0 * (1.0 + g2)
             - (8.0 * t3) / (a * (-1.0 + g2) * torch.sqrt(torch.clamp(t5, min=1e-20))) - t6)
    s = -0.5 * torch.sqrt(torch.clamp(t5, min=0.0)) + torch.sqrt(torch.clamp(inner, min=0.0)) / 2.0
    cos = (1.0 + g2 - torch.pow(s, 2.0)) / (2.0 * g)
    return [t3, t4a, t4, t4p3, t6, t5, inner, s, cos], pre


def check_draine(torch, states):
    """ROADMAP C #2: the bounce's Draine sampler (csrc/draine_check.cu
    writes its intermediates) against the twin's operations step by step on
    the bounce-DEEP_BOUNCE lanes' own Draine draws: per intermediate the
    share of draws bit-equal; for the draw whose cos parts most, the first
    intermediate at which they part, its inputs, the kernel's powf, PyTorch's
    pow and the float64 cube root. Fails unless every step is bit-equal on
    every draw and PyTorch divides by a Python scalar b as x * float32(1 /
    b), the rounding the kernels copy. Returns the shares."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.models import volume as vol
    from digital_earth_tpu_torch.ops import rng

    c = states[DEEP_BOUNCE]
    keys = c["st"].rng[c["idx"].long()]
    u = rng.uniform(rng.fold(rng.fold(keys, DEEP_BOUNCE), 4), (3,))
    u0 = u[1][u[0] < vol.CLOUD_W_DRAINE].contiguous()
    trace, k64 = kernels.draine_check(u0)
    twin, pre = draine_steps(torch, u0)
    replica = torch.equal(torch.clamp(twin[-1], -1.0, 1.0),
                          vol.sample_draine_cos(u0, vol.CLOUD_G_DRAINE, vol.CLOUD_ALPHA_DRAINE))
    shares = [(trace[:, j] == t).float().mean().item() for j, t in enumerate(twin)]
    print(f"Draine sampler on {u0.numel()} bounce-{DEEP_BOUNCE} Draine draws (the twin's steps "
          f"reproduce models/volume.sample_draine_cos bit for bit: {replica}); kernel and twin "
          "bit-equal per step: " + ", ".join(
              f"{name} {share:.6f}" for name, share in zip(DRAINE_STEPS, shares))
          + f"; float32(pow(float64(t4), 1/3)) == the twin's pow on "
          f"{(k64 == twin[3]).float().mean().item():.6f}")
    # t6 = pre / (a - a g^2): PyTorch's division of a CUDA tensor by a Python
    # scalar b against the candidate roundings of it
    g = vol.CLOUD_G_DRAINE
    b = vol.CLOUD_ALPHA_DRAINE - vol.CLOUD_ALPHA_DRAINE * (g * g)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=pre.device)  # noqa: E731
    cands = {"x * float32(1 / b)": pre * f32(1.0 / b),
             "x * (1 / float32(b))": pre * (f32(1.0) / f32(b)),
             "x / float32(b)": pre / f32(b)}
    print(f"t6 = x / {b!r} in PyTorch on the card equals " + ", ".join(
        f"{k} on {(v == twin[4]).float().mean().item():.6f}" for k, v in cands.items()))
    i = int((trace[:, -1] - twin[-1]).abs().argmax())
    parts = [j for j in range(len(twin)) if trace[i, j] != twin[j][i]]
    if parts:
        j = parts[0]
        prev = {DRAINE_STEPS[k]: (trace[i, k].item(), twin[k][i].item()) for k in range(j)}
        print(f"Draine draw parting most (u0 {u0[i].item()!r}, cos kernel "
              f"{trace[i, -1].item()!r} twin {twin[-1][i].item()!r}): first parting step "
              f"{DRAINE_STEPS[j]}: kernel {trace[i, j].item()!r} twin {twin[j][i].item()!r}; "
              f"steps before it equal {prev}; t4 {twin[2][i].item()!r}: kernel powf "
              f"{trace[i, 3].item()!r}, torch.pow {twin[3][i].item()!r}, float64 "
              f"{torch.pow(twin[2][i].double(), 1.0 / 3.0).item()!r}")
    if not (replica and min(shares) == 1.0 and all(
            bool((v == twin[4]).all()) for k, v in cands.items() if k.startswith("x * float32"))):
        fail("the bounce's Draine sampler parts from its twin, or PyTorch no longer divides by a "
             "Python scalar as the kernels assume")
    return shares


def check_density(torch, lookups):
    """density_check (the bounce kernel's table lookups) against the plain
    lookups on bounce 0's flight segments and NEE origins, timed (the
    launcher computes both lookups for each lane)."""
    from digital_earth_tpu_torch.models import atmosphere_lut as atm

    pos, d, t0, t_w, ext = lookups["flight"][:5]
    t1 = torch.maximum(t_w, t0)
    _, origin, light, ext_n, _, _, active = lookups["nee"][:7]
    o, l, e = origin[active].contiguous(), light[active].contiguous(), ext_n[active].contiguous()
    zero = torch.zeros_like(o[:, 0])
    cases = (
        ("flight segments", 0, (pos, d, t0, t1, ext),
         lambda: atm.density_integral_segment(pos, d, t0, t1)),
        ("NEE transmittance", 1, (o, l, zero, zero, e),
         lambda: atm.rmo_transmittance_to_space(e, o, l)),
    )
    results = []
    for label, which, args, plain in cases:
        got, ms = _time_ms(torch, lambda: atm.density_check(*args), 5)
        g = got[which]
        w, plain_ms = _plain_ms(torch, plain)
        atol = 1e-6 * w.abs().max().clamp(min=1e-30)
        lane_ok = ((g - w).abs() <= DENSITY_RTOL * w.abs() + atol).all(-1)
        share = lane_ok.float().mean().item() if lane_ok.numel() else 1.0
        err = (g - w).abs().max().item() if g.numel() else 0.0
        results.append(share >= MIN_LANE_AGREEMENT)
        n = g.shape[0]
        # pos, dir, t0, t1, ext (4 x 3) read, segments (3) and transmittance
        # (4) written; the table's texels not counted (BOUNCE_LANE_BYTES)
        b_ms, b_by = bound(n * (80 + 28), None)
        print(f"density_check {label} (bounce 0): {n} lanes within rtol {DENSITY_RTOL} "
              f"{share:.7f} ({n - int(lane_ok.sum())} not), max abs err {err:.3e}  kernel "
              f"{ms:.3f} ms (both lookups)  plain {plain_ms:.2f} ms (this lookup)  bound "
              f"{b_ms:.4f} ms ({b_by})  {'ok' if results[-1] else 'FAIL'}")
    if not all(results):
        fail("density_check disagrees with the plain table lookups")


def tap_edge_points(torch, h, w, device="cpu", seed=25):
    """(n, 3) float32 points at which the taps of an (h, w) texture are held
    at their edges, as positions (ops/texture.sample_sphere_texture) or
    directions (sample_dir_texture): u exactly 0 and 1 (atan2 of -0 and +0
    at -1, at the equator and towards the poles); u within a texel of the seam on
    either side (x0f = -1 below half a texel; nearest 0.01 texel and more
    from its rounding edges); both poles and the rows the clamp holds (v
    within 1.25 texels of 0 and 1); zero-length, tiny and overflowing
    positions; NaN and infinite components; then 64 seeded unit directions."""
    rows = []
    for y in (0.0, 0.5, -0.5, 0.999, -0.999):
        c = math.sqrt(1.0 - y * y)
        rows += [(c, y, -0.0), (c, y, 0.0)]
    for k in (0.01, 0.25, 0.49, 0.51, 0.75, 0.99, 1.25):
        a = 2.0 * math.pi * k / w  # k texels from the seam: atan2 = -pi + a or pi - a
        for phi in (-math.pi + a, math.pi - a):
            for y in (0.0, 0.3):
                c = math.sqrt(1.0 - y * y)
                rows.append((-c * math.cos(phi), y, c * math.sin(phi)))
    for k in (0.0, 0.25, 0.49, 0.51, 0.75, 1.25):
        b = math.pi * k / h  # k texel rows from a pole
        for sy in (1.0, -1.0):
            for phi in (0.4, -2.5):
                rows.append((-math.sin(b) * math.cos(phi), sy * math.cos(b),
                             math.sin(b) * math.sin(phi)))
    nan, inf = math.nan, math.inf
    rows += [(0.0, 0.0, 0.0), (-0.0, -0.0, -0.0), (1e-30, 0.0, 0.0), (0.0, 1e-45, 0.0),
             (3e38, 3e38, 3e38), (-3e38, 1.0, 3e38), (nan, 0.0, 0.0), (0.0, nan, 0.0),
             (0.0, 0.0, nan), (nan, nan, nan), (inf, 0.0, 0.0), (-inf, 0.0, 0.0),
             (0.0, inf, 0.0), (0.0, -inf, 0.0), (0.0, 0.0, inf), (0.0, 0.0, -inf),
             (inf, inf, inf), (-inf, inf, -inf), (inf, nan, 1.0)]
    g = torch.Generator().manual_seed(seed)
    rnd = torch.randn((64, 3), generator=g, dtype=torch.float64)
    rnd = rnd / rnd.norm(dim=1, keepdim=True)
    pts = torch.cat([torch.tensor(rows, dtype=torch.float64), rnd])
    return pts.to(torch.float32).to(device)


def march_probe_points(torch, marches):
    """The points at which the land march's plain twin taps the topography
    in the march calls ``marches`` (bounce 0's, ``capture_inputs``): every
    probe of every iteration its lanes run (K an iteration, the probes past
    an iteration's first stop included, which the kernel skips), in the
    twin's order (call, iteration, probe, lane), as (P, 3) float32, and the
    flat index of each probe's texel, (P,) int64."""
    from digital_earth_tpu_torch.ops import texture as tx
    from digital_earth_tpu_torch.render import tracers

    points, texels = [], []
    tap, fetch = tx.sample_sphere_texture, tx.fetch_texel

    def recording_tap(tex, pos, bilinear=True):
        points.append(pos.reshape(-1, 3).clone())
        return tap(tex, pos, bilinear)

    def recording_fetch(tex, iy, ix):
        texels.append((iy * tex.shape[1] + ix).reshape(-1))
        return fetch(tex, iy, ix)

    tx.sample_sphere_texture, tx.fetch_texel = recording_tap, recording_fetch
    try:
        for args, kwargs in marches:
            tracers.intersect_land_plain(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        tx.sample_sphere_texture, tx.fetch_texel = tap, fetch
    return torch.cat(points), torch.cat(texels)


# the test launchers' instances (csrc/texture_check.cu) whose SASS bodies
# check_texture reads: {(tap, C, form): mangled name part}; form "nearest",
# "bilinear" (texture.cuh's branch) or "first" (the bilinear form texture.cuh
# first had, kept in the launcher)
TAP_INSTANCES = {("sphere", 4, "nearest"): "sphere_tap_kernelILi4ELb0E",
                 ("sphere", 4, "bilinear"): "sphere_tap_kernelILi4ELb1E",
                 ("sphere", 4, "first"): "sphere_tap_first_kernelILi4E",
                 ("sphere", 8, "nearest"): "sphere_tap_kernelILi8ELb0E",
                 ("sphere", 8, "bilinear"): "sphere_tap_kernelILi8ELb1E",
                 ("sphere", 8, "first"): "sphere_tap_first_kernelILi8E",
                 ("dir", 3, "nearest"): "dir_tap_kernelILi3ELb0E",
                 ("dir", 3, "bilinear"): "dir_tap_kernelILi3ELb1E",
                 ("dir", 3, "first"): "dir_tap_first_kernelILi3E"}


def tap_bodies(kernels):
    """{(tap, C, form): SASS main body} of the test launchers' instances
    (TAP_INSTANCES) in the built library; fails where one is missing."""
    funcs = sass_functions(kernels.library()._name)
    out = {}
    for key, part in TAP_INSTANCES.items():
        name = next((f for f in funcs if part in f), None)
        if name is None:
            fail(f"the disassembly has no {key} tap instance ({part})")
        out[key] = sass_main_body(funcs[name])
    return out


def xu_ops(body):
    """The XU-pipe opcodes of a SASS body and their counts."""
    hist, _ = sass_histogram(body)
    return {op: c for op, c in sorted(hist.items()) if sass_pipe(op) == "xu"}


def _same_bits(torch, a, b):
    """Rows of two (n, C) float32 tensors equal bit for bit (NaN payloads
    included)."""
    return (a.view(torch.int32) == b.view(torch.int32)).all(-1)


def _twin_rows(torch, got, want, held=None):
    """(rows equal to the twin's, a NaN equal to a NaN; the largest
    difference on the ``held`` rows (all by default) finite in both; the
    held rows not finite in both)."""
    same = ((got == want) | (got.isnan() & want.isnan())).all(-1)
    fin = got.isfinite().all(-1) & want.isfinite().all(-1)
    if held is None:
        held = torch.ones_like(fin)
    err = (got[fin & held] - want[fin & held]).abs().max().item() if bool((fin & held).any()) \
        else 0.0
    return same, err, int((held & ~fin).sum())


def _tap_case(torch, label, tap, twin, n, bodies, key, nbytes, rows, points=None):
    """One tap's check at one set of points: ``tap(bilinear, first_form)``
    the launcher, ``twin(bilinear)`` the plain tap. Nearest and bilinear
    each timed per call and on the device (a CUDA graph of 20 calls), every
    row finite in both and within TAP_ATOL of the twin, with their share
    bit-equal to it; with ``points`` (the edge sweep), only the rows whose
    point has no NaN or infinite component (the kernel's fminf and fmaxf
    take a NaN as missing, torch.clamp keeps it, so there the two may tap
    other texels: ROADMAP C #8), the others counted apart; the bilinear tap
    also against the first form (every row bit for bit, else fails), timed
    in turns with it (first, tap, tap, first). Bounds: ``nbytes`` (the
    nearest tap's, the bilinear tap's) at the memory rate and the
    operations of a SASS body (``bodies``, ``key`` = (tap, C)); the
    bilinear tap's from the lower of its body and the first form's (the
    work the function needs), the first form's own bound printed beside it.
    Fills ``rows[label]``; returns its forms' rows."""
    out = {}
    for bilinear in (False, True):
        form = "bilinear" if bilinear else "nearest"
        got, ms = _time_ms(torch, lambda: tap(bilinear, False), 5)
        want, plain_ms = _plain_ms(torch, lambda: twin(bilinear))
        held = None if points is None else points.isfinite().all(-1)
        same, err, nonfinite = _twin_rows(torch, got, want, held)
        share = same.float().mean().item() if n else 1.0
        row = dict(n=n, ms=ms, plain_ms=plain_ms, share=share, max_abs_err=err,
                   nonfinite=nonfinite)
        if held is not None:
            row["not_held"] = int((~held).sum())
            row["not_held_parted"] = int((~held & ~same).sum())
        body = bodies[(*key, form)]
        ops_ms, _, row["pipes"] = sass_ops_bound(body, n)
        row["body"] = len(body)
        bytes_ms = nbytes[bilinear] / PEAK_BYTES * 1e3
        if bilinear:
            first_body = bodies[(*key, "first")]
            first_ops_ms, _, row["first_pipes"] = sass_ops_bound(first_body, n)
            row["first_body"] = len(first_body)
            row["first_bound_ms"] = max(bytes_ms, first_ops_ms)
            ops_ms = min(ops_ms, first_ops_ms)
        row["bound_ms"], row["bound_by"] = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        if bilinear:
            first = tap(True, True)
            row["first_bit_equal_rows"] = int(_same_bits(torch, got, first).sum())
            row["first_share"] = (_twin_rows(torch, first, want)[0].float().mean().item()
                                  if n else 1.0)
            t = [_graph_ms(torch, lambda: tap(True, f)) for f in (True, False, False, True)]
            row["first_graph_ms"], row["graph_ms"] = [t[0], t[3]], [t[1], t[2]]
        else:
            row["graph_ms"] = [_graph_ms(torch, lambda: tap(False, False))]
        out[form] = row
        ok = (err <= TAP_ATOL and nonfinite == 0
              and (not bilinear or row["first_bit_equal_rows"] == n))
        print(f"tap {label} {form}: {n} points, bit-equal to the twin on {share:.6f}"
              + (f" (the first form {row['first_share']:.6f}); bit-equal to the first form on "
                 f"{row['first_bit_equal_rows']} of {n}" if bilinear else "")
              + f"; max abs err {err:.3e}, {nonfinite} rows not finite in both"
              + (f", on the {n - row['not_held']} points of finite components (of the "
                 f"{row['not_held']} others {row['not_held_parted']} part from the twin)"
                 if held is not None else "")
              + f"; {ms:.4f} ms per call, on the device "
              + ", ".join(f"{x:.4f}" for x in row["graph_ms"])
              + (" (the first form " + ", ".join(f"{x:.4f}" for x in row["first_graph_ms"])
                 + ")" if bilinear else "")
              + f" ms; plain {plain_ms:.2f} ms; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); its body {row['body']} instructions a tap by pipe "
              f"{row['pipes']}"
              + (f", the first form's {row['first_body']} by pipe {row['first_pipes']} (its "
                 f"bound {row['first_bound_ms']:.4f} ms)" if bilinear else "")
              + f"  {'ok' if ok else 'FAIL'}")
        if not ok:
            bad = ~(((got - want).abs().amax(-1) <= TAP_ATOL) & got.isfinite().all(-1)
                    & want.isfinite().all(-1)) & (held if held is not None else True)
            rows_bad = bad.nonzero().flatten()[:8].tolist()
            print(f"tap {label} {form}: rows past TAP_ATOL or not finite {rows_bad}"
                  + (f" at points {points[rows_bad].tolist()}" if points is not None else ""))
            fail(f"the {form} tap ({label}) disagrees with the twin or with the first form")
        del got, want
    rows[label] = out
    return out


def check_texture(torch, lookups, atlas, march_probes=0, frame_end_args=None):
    """The bounce's sphere taps (texture.cuh, through the sphere_tap test
    launcher) against ops/texture.sample_sphere_texture, and the stars'
    direction tap (dir_tap, as frame_end and preview take it) against
    sample_dir_texture (``_tap_case``: nearest and bilinear, the bilinear
    tap bit for bit against the form texture.cuh first had, each timed on
    the device): at bounce 0's surface points, the material (8 channels)
    and the topography (4); on the edge sweep (``tap_edge_points``)
    of the material, the topography and the stars (3); at bounce 0's own
    march probes (``march_probe_points``: its three marches' points, more
    than the census's floor of ``march_probes``, which counts an
    iteration's probes up to its first stop), the topography, with the
    distinct texels those probes read as the bytes of the bound (the
    nearest tap's one, the bilinear tap's four) and the nearest tap's
    launcher bound beside (its 12 B point read and 16 B tap written a
    probe); at the whole frame's primary misses (``frame_end_args``,
    ``capture_frame_end``), the stars. Prints the bodies' XU-pipe opcodes.
    A dict."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.ops import texture as tx

    bodies = tap_bodies(kernels)
    rows = {}
    for (tap, c, form), body in sorted(bodies.items()):
        print(f"tap SASS {tap} C = {c} {form}: {len(body)} instructions, XU {xu_ops(body)}")
    near = len(bodies[("sphere", 4, "nearest")])
    rows["extra"] = dict(now=len(bodies[("sphere", 4, "bilinear")]) - near,
                         first=len(bodies[("sphere", 4, "first")]) - near,
                         counted=bilinear_tap_extra(kernels))

    def sphere(tex, pos):
        return (lambda b, f: kernels.sphere_tap(tex, pos, b, first_form=f),
                lambda b: tx.sample_sphere_texture(tex, pos, bilinear=b))

    def direction(tex, d):
        return (lambda b, f: kernels.dir_tap(tex, d, b, first_form=f),
                lambda b: tx.sample_dir_texture(tex, d, bilinear=b))

    # bounce 0's surface points: the pos read, the taps written
    land_pos = lookups["surface"]
    n = land_pos.shape[0]
    for name, tex in (("material", atlas.material), ("topography", atlas.topography)):
        c = tex.shape[2]
        _tap_case(torch, f"{name} at bounce 0's surface points", *sphere(tex, land_pos), n,
                  bodies, ("sphere", c), (n * (12 + 4 * c),) * 2, rows)
    # the edge sweep
    for name, tex, kind in (("material", atlas.material, "sphere"),
                            ("topography", atlas.topography, "sphere"),
                            ("stars", atlas.stars, "dir")):
        pts = tap_edge_points(torch, *tex.shape[:2], device=tex.device)
        c = tex.shape[2]
        fns = sphere(tex, pts) if kind == "sphere" else direction(tex, pts)
        _tap_case(torch, f"{name} on the edge sweep", *fns, pts.shape[0], bodies, (kind, c),
                  (pts.shape[0] * (12 + 4 * c),) * 2, rows, points=pts)
    # the stars at the frame's primary misses
    if frame_end_args and frame_end_args["kwargs"].get("miss") is not None:
        st = frame_end_args["kwargs"]["miss"].st
        d = st.direction[st.primary_miss.bool()].contiguous()
        _tap_case(torch, "stars at the frame's primary misses", *direction(atlas.stars, d),
                  d.shape[0], bodies, ("dir", 3), (d.shape[0] * (12 + 12),) * 2, rows)
        del d
    if not march_probes or not lookups.get("marches"):
        return rows
    tex = atlas.topography
    pos, texels = march_probe_points(torch, lookups["marches"])
    p = pos.shape[0]
    distinct = int(torch.unique(texels).numel())
    corners, fetch = [], tx.fetch_texel

    def corner_fetch(tex_, iy, ix):
        corners.append((iy * tex_.shape[1] + ix).reshape(-1))
        return fetch(tex_, iy, ix)

    tx.fetch_texel = corner_fetch
    try:
        tx.sample_sphere_texture(tex, pos, bilinear=True)
    finally:
        tx.fetch_texel = fetch
    distinct_b = int(torch.unique(torch.cat(corners)).numel())
    del corners
    # the bytes of each form's bound: the distinct texels its taps read
    # (nearest one a tap, bilinear four)
    near = _tap_case(torch, "topography at bounce 0's march probes", *sphere(tex, pos), p, bodies,
                     ("sphere", 4), (4 * distinct, 4 * distinct_b), rows)["nearest"]
    launcher_ms = max((4 * distinct + 28 * p) / PEAK_BYTES * 1e3,
                      sass_ops_bound(bodies[("sphere", 4, "nearest")], p)[0])
    print(f"march probes ({nvidia_smi_line()}): {p} points of {len(lookups['marches'])} march "
          f"calls (the census's floor {march_probes}), {distinct} distinct texels (their four a "
          f"bilinear tap: {distinct_b}); the nearest tap's launcher bound {launcher_ms:.4f} ms "
          f"(with its points read and taps written)")
    del pos, texels
    return dict(rows, probes=p, floor_probes=march_probes, distinct_texels=distinct,
                distinct_texels_bilinear=distinct_b, ms=near["ms"], graph_ms=near["graph_ms"][0],
                bound_ms=near["bound_ms"], bound_by=near["bound_by"],
                launcher_bound_ms=launcher_ms, pipes=near["pipes"], body=near["body"])


def profile_spp(torch, r, label, run=None, unit="spp"):
    """One accumulate() (or ``run()``) under torch.profiler: (device kernels,
    device-busy seconds, wall seconds under the profiler, device us by
    kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        (run or r.accumulate)()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_only = [e for e in dev_events if not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e6
    by_name = {}
    for e in kernels_only:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"profile {label}: {len(kernels_only)} device kernels (+{len(dev_events) - len(kernels_only)}"
          f" copies/sets) per {unit}, device busy {busy:.4f} s of {wall:.4f} s profiled wall "
          f"({busy / wall:.3f}); most device time: "
          + ", ".join(f"{name[:40]} {us / 1e3:.2f} ms" for name, us in top))
    return len(kernels_only), busy, wall, by_name


def check_golden(torch, dev):
    """The 32x18 golden configuration on the card against the committed
    reference render (tests/golden, 2 spp)."""
    import numpy as np

    from digital_earth_tpu_torch.app.config_io import apply_config, load_config
    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_path.npz"))
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = Renderer(dev, image_res=(32, 18), atlas=atlas, seed=0, cfg=cfg)
    apply_config(r, load_config(SCENE))
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf = r.color_buffer.cpu().numpy()
    ref = golden["color_buffer"]
    share = np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean()
    mean_rel = np.abs(buf.mean((0, 1)) / ref.mean((0, 1)) - 1.0).max()
    print(f"golden apollo 32x18 on the card: {share:.4f} of pixels within rtol 1e-3, "
          f"channel means within {mean_rel:.4f}")
    # The share floor of tests/test_torch_render.py. The card's libm rounds
    # differently again from both CPU backends, and one flipped bright path
    # moves a 576-pixel channel mean by about 2%: means within 5%.
    if not (share >= 0.92 and mean_rel <= 0.05):
        fail("the card's render disagrees with the committed reference golden")


def _time_ms(torch, fn, reps):
    """(result of a first call, mean ms of ``reps`` further calls), CUDA events."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _plain_ms(torch, fn):
    """(result, ms) of one warm call of a plain twin (after one call that
    pays PyTorch's first-use setup), CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _apollo(renderer):
    from digital_earth_tpu_torch.app.config_io import apply_config, load_config

    apply_config(renderer, load_config(SCENE))
    return renderer


def _hold_rays(torch, label, args):
    """gen_rays against its twin on ``args``: every field bit-equal. Timed
    per call from the host, back to back (the wrapper's host work included),
    and on the device alone from a CUDA graph of 20 calls, which also shows
    that the wrapper reads nothing back from the card. (kernel result, max
    abs err, ms per call, plain ms, device ms)."""
    from digital_earth_tpu_torch.render import raygen

    got, ms = _time_ms(torch, lambda: raygen.gen_rays(*args), 20)
    dev_ms = _graph_ms(torch, lambda: raygen.gen_rays(*args))
    want, plain_ms = _plain_ms(torch, lambda: raygen.gen_rays_plain(*args))
    parted, err = [], 0.0
    for name, g, w in zip(got._fields, got, want):
        if (g is None) != (w is None) or (g is not None and g.shape != w.shape):
            fail(f"gen_rays {label}: field {name} differs in shape from its twin's")
        if g is None:
            continue
        bits = (g.view(torch.int32), w.view(torch.int32)) if g.is_floating_point() else (g, w)
        if not torch.equal(*bits):
            parted.append(name)
            err = max(err, (g.double() - w.double()).abs().max().item())
    print(f"gen_rays {label}: {args[3]} lanes, fields {', '.join(got._fields[:6])}"
          f"{', tile_index, lane_index' if got.tile_index is not None else ''} bit-equal to "
          f"the twin's{'' if not parted else ' but ' + ', '.join(parted)} (max abs err {err:.3e})  "
          f"kernel {ms:.4f} ms per call from the host, {dev_ms:.4f} ms on the device "
          f"(CUDA graph)  plain {plain_ms:.1f} ms  {'ok' if not parted else 'FAIL'}")
    if parted:
        fail(f"gen_rays disagrees with its plain twin ({label}): {parted}")
    return got, err, ms, plain_ms, dev_ms


def check_gen_rays(torch, dev, atlas, luts, tf):
    """gen_rays against its twin on the path frame's 1920x1080 inputs and
    the 480x270 preview's: a row for the JSON line (the 1080p times; its
    bound with threefry's work at the SASS census ``tf``)."""
    from digital_earth_tpu_torch.render.renderer import Renderer

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for mode, res in (("path", RES), ("preview", PREVIEW_RES)):
        r = _apollo(Renderer(dev, image_res=res, atlas=atlas, luts=luts, mode=mode))
        block = r.block if mode == "preview" else (1, res[1])
        args = (r._seed_key, 0, 0, res[0] * res[1], res, block, r.camera_params("cpu"), luts,
                mode == "preview")
        got, err, ms, plain_ms, dev_ms = _hold_rays(
            torch, f"{mode} {res[0]}x{res[1]} block {block}", args)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        n = args[3]
        L = got.wavelengths.shape[1]
        # tables read once; keys, dirs, wavelengths, responses, pdf and pid
        # written (and the preview's tile and in-tile lane)
        nbytes = luts.cie_cdf.shape[0] * 16 + n * (16 + 12 + 20 * L + 8 + (16 if L == 1 else 0))
        alu, fma = tf_ops(GEN_RAYS_TF[0] * n, GEN_RAYS_TF[1] * n, tf)
        ops = GEN_RAYS_OPS * n + alu + fma
        b_ms, b_by = bound(nbytes, ops, int_ops=alu, fma_ops=fma)
        print(f"gen_rays {mode} {res[0]}x{res[1]}: bound {b_ms:.4f} ms ({b_by}); the device "
              f"time is {b_ms / dev_ms:.2f} of it, the time per call {b_ms / ms:.2f}")
        if mode == "path":
            row.update(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops, int_ops=alu, fma_ops=fma)
    return row


def check_film(torch, buf, crf_curves):
    """film_postprocess against its twin on the 1080p main-path buffer."""
    from digital_earth_tpu_torch.render import film

    w, h = buf.shape[:2]
    counts = (torch.arange(w * h, device=buf.device) % 4 + 1).to(torch.float32).view(w, h, 1)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for drt in ("opendrt", "agx"):
        for spp in (3.0, counts):
            args = (buf, spp, 2.432, 1.001, crf_curves, 12, drt)
            got, ms = _time_ms(torch, lambda: film.postprocess(*args), 5)
            want, plain_ms = _plain_ms(torch, lambda: film.postprocess_plain(*args))
            err = (got - want).abs().max().item()
            kind = "scalar spp" if isinstance(spp, float) else "per-pixel count"
            print(f"film_postprocess {drt} {kind} {w}x{h}: max abs err {err:.3e}  "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  "
                  f"{'ok' if err <= FILM_ATOL else 'FAIL'}")
            if not err <= FILM_ATOL:
                fail(f"film_postprocess disagrees with its plain twin ({drt}, {kind})")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if drt == "opendrt" and kind == "scalar spp":
                row["ms"], row["plain_ms"] = ms, plain_ms
                row["bytes"] = 24 * w * h + crf_curves.numel() * 4  # buffer in, image out
                row["ops"], row["sfu"] = FILM_OPS * w * h, FILM_SFU * w * h
                row["graph_ms"] = _graph_ms(torch, lambda: film.postprocess(*args))
                b_ms, by = bound(row["bytes"], row["ops"], row["sfu"])
                print(f"film_postprocess {drt} {kind} {w}x{h} on the device (CUDA graph of 20): "
                      f"{row['graph_ms']:.4f} ms, {b_ms / row['graph_ms']:.2f} of the {b_ms:.4f} "
                      f"ms bound ({by}; bytes {bound(row['bytes'], None)[0]:.4f}, FP32 "
                      f"instructions {row['ops'] / (H100_SMS * FP32_PER_SM * sm_clock_mhz() * 1e3):.4f}, "
                      f"SFU {row['sfu'] / (H100_SMS * SFU_PER_SM * sm_clock_mhz() * 1e3):.4f})")
    return row


def preview_frame(torch, dev, atlas, luts, label="", cfg=None):
    """The preview frame at 480x270: one accumulate() under
    torch.cuda.set_sync_debug_mode("error") (it may make no synchronizing
    call), then 3 warm frames timed with their launches counted (``preview``
    once, ``atmos_march`` and ``land_march`` never); then ``check_preview``
    on the frame's own lanes (at the TraceConfig ``cfg``, default the
    default). Returns (launch counts of one frame, JSON rows of ``preview``
    and ``atmos_march``, the frame_end arguments)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher
    from digital_earth_tpu_torch.render.renderer import Renderer

    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview",
                         **({} if cfg is None else {"cfg": cfg})))
    march = {}
    original = raymarcher.march_paths

    def keep(*args, **kwargs):
        march.update(args=args, kwargs=kwargs)
        return original(*args, **kwargs)

    raymarcher.march_paths = keep
    try:
        # warm-up, and the capture of the frame's lanes and of its end
        kept = capture_frame_end(torch, r.accumulate)
        r.fetch_image()
        torch.cuda.synchronize()
    finally:
        raymarcher.march_paths = original
    where = f" {label}" if label else ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.accumulate()
    except RuntimeError as e:
        fail(f"a warm preview accumulate(){where} made a synchronizing call: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"preview frame{where}: a warm accumulate() made no synchronizing call "
          f"(torch.cuda.set_sync_debug_mode('error'))")
    times = []
    for _ in range(3):
        r.reset_framebuffer()
        kernels.reset_launch_counts()
        t0 = time.time()
        r.accumulate()
        img = r.fetch_image()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        counts = kernels.launch_counts()
    finite = bool(torch.isfinite(img).all()) and bool(torch.isfinite(r.color_buffer).all())
    print(f"preview frame Apollo 11 {PREVIEW_RES[0]}x{PREVIEW_RES[1]}{where} (accumulate + "
          f"fetch_image, warm, {nvidia_smi_line()}): {' '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"ms; launches {counts}; finite {finite}, buffer mean {r.color_buffer.mean().item():.6g}")
    if not (counts["preview"] == 1 and counts["atmos_march"] == 0 and counts["land_march"] == 0
            and counts["gen_rays"] == 1 and counts["frame_end"] == 1
            and counts["film_postprocess"] > 0):
        fail(f"the preview frame did not run as one preview launch: {counts}")
    if not (finite and r.color_buffer.mean().item() > 0.0):
        fail("the preview frame is not finite with a positive mean")
    rows = check_preview(torch, march["args"], march["kwargs"], counts["preview"], where)
    return counts, rows, kept


def _twin_lanes(torch, args, kwargs):
    """A captured march_paths call as its twin takes it: the lanes' origins
    from the origin passed by value, without the kernel's blocks."""
    kw = {k: v for k, v in kwargs.items() if k not in ("frame", "origin")}
    if args[1] is None:
        n = args[2].shape[0]
        pos = torch.tensor(kwargs["origin"], dtype=torch.float32, device=args[2].device)
        args = (args[0], pos.expand(n, 3).contiguous(), *args[2:])
    return args, kw


def check_preview(torch, args, kwargs, launches, where):
    """``preview`` against ``march_paths_plain`` on the card on one frame's
    lanes: every lane bit-equal (the kernel timed, 5 calls; the twin
    timed), its registers and resident warps; the kernel's time split into
    the march (the
    ``atmos_march`` launcher on the arguments of the twin's three bounces),
    the land marches (``land_march`` on the twin's six) and the rest;
    ``atmos_march`` bit-equal to its twin at bounces 0-2. Returns the JSON rows of both kernels."""
    from digital_earth_tpu_torch import constants as C
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import raymarcher

    args, kw = _twin_lanes(torch, args, kwargs)
    key, pos, dirs, wl, scene, atlas, luts, cfg = args
    frame = raymarcher.PreviewFrame(scene, atlas, luts, cfg, kw["tile"])

    def launch(**k):
        return kernels.preview(
            frame.fparams, frame.iparams, key.tolist(), None, dirs, wl, kw["tile_index"],
            kw["lane"], atlas.topography, atlas.material, atlas.stars, luts.o3_crossec,
            luts.srgb2spec, origin=pos[0].tolist(), cert_floor=frame.cert_floor, **k)

    atmos_args, land_args = [], []
    originals = raymarcher.ray_march_atmos, raymarcher.intersect_land

    def atmos(*a):
        atmos_args.append(tuple(x.clone() for x in a))
        return originals[0](*a)

    def land(*a, **k):
        land_args.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), k))
        return originals[1](*a, **k)

    raymarcher.ray_march_atmos, raymarcher.intersect_land = atmos, land
    try:
        want = raymarcher.march_paths_plain(*args, **kw)
        torch.cuda.synchronize()
    finally:
        raymarcher.ray_march_atmos, raymarcher.intersect_land = originals
    _, plain_ms = _plain_ms(torch, lambda: raymarcher.march_paths_plain(*args, **kw))
    if len(atmos_args) != 3 or len(land_args) != 6:
        fail(f"the twin did not run three bounces: {len(atmos_args)} marches")
    n = want.numel()
    got, ms = _time_ms(torch, launch, 5)
    # the options and floor instances have no census
    cert = frame.cert_floor is not None
    options = takes_options(cfg.options()) or cert
    occ = kernels.preview_occupancy(options=2 if cert else int(options))
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = (got - want).abs().max().item()
    # the split of the kernel's time, by the test launchers on the same lanes
    march_ms = sum(_time_ms(torch, lambda a=a: raymarcher.ray_march_atmos(*a), 5)[1]
                   for a in atmos_args)
    from digital_earth_tpu_torch.render.tracers import _march_floor, march_options

    step_floor, stall, cert_floor = _march_floor(atlas.topography, cfg)
    no_cap = torch.full((n,), float("inf"), device=dirs.device)

    def land_march(a):
        topo, p, d, _, act = a[:5]
        return kernels.land_march(topo, p, d, act, no_cap, frame.fparams[0], step_floor=step_floor,
                                  stall_thresh=stall, cert_floor=cert_floor,
                                  steps=cfg.land_march_steps, k=cfg.march_k, any_hit=False,
                                  **march_options(cfg))

    land_ms = sum(_time_ms(torch, lambda a=a: land_march(a), 5)[1] for a, _ in land_args)
    active = [int(a[-1].sum()) for a in atmos_args]
    surface = [int(a[4].sum()) for a, _ in land_args[1::2]]  # each bounce's shadow rays
    n_sun = [_atmos_sun_steps(torch, a) for a in atmos_args]
    ops = (PREVIEW_LANE_OPS * n + (PREVIEW_BOUNCE_OPS + ATMOS_LANE_OPS) * sum(active)
           + ATMOS_SUN_OPS * sum(n_sun) + PREVIEW_CHAIN_OPS * sum(active[1:])
           + PREVIEW_SURFACE_OPS * sum(surface) + PREVIEW_MISS_OPS * (n - active[0]))
    sfu = (PREVIEW_LANE_SFU * n + (ATMOS_LANE_SFU + 64 * ATMOS_STEP_SFU) * sum(active)
           + ATMOS_SUN_SFU * sum(n_sun))
    nbytes = PREVIEW_LANE_BYTES * n + PREVIEW_TABLE_BYTES
    b_ms, b_by = bound(nbytes, ops, sfu)
    floor_ms, _ = bound(nbytes, ops)
    print(f"preview vs march_paths_plain{where}: {n} lanes; per bounce {active} crossing the "
          f"atmosphere, {surface} on land, {n_sun} march steps with a sun march; every lane "
          f"bit-equal {same} (max abs err {err:.3e})  kernel {ms:.3f} ms ({occ['registers']} "
          f"registers, {occ['local_bytes']} B local, {occ['warps_per_sm']} resident warps per "
          f"SM)  plain {plain_ms:.1f} ms (eager, with the land_march and "
          f"atmos_march kernels)  bound {b_ms:.4f} ms ({b_by}: {ops:.4g} FP32 and {sfu:.4g} SFU "
          f"operations at {sm_clock_mhz():.0f} MHz, {nbytes} B; the FP32-peak floor "
          f"{floor_ms:.4f})  launches {launches}  {'ok' if same else 'FAIL'}")
    print(f"preview{where} time split (the launchers on the same lanes): the march "
          f"{march_ms:.3f} ms, the land and shadow marches {land_ms:.3f} ms, the rest "
          f"{ms - march_ms - land_ms:.3f} ms of {ms:.3f}")
    if not same:
        fail(f"the preview kernel differs from march_paths_plain{where}")
    rows = dict(preview=dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                             sfu=sfu),
                atmos_march=dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
    if options:
        return rows
    # the census instance: each lane's clock64 cycles in its land and shadow
    # marches, in the march and in all; its output must keep the bits
    got_c, cycles = launch(census=True)
    land_c, march_c, all_c = (float(x) for x in cycles.double().sum(0).tolist())
    census_same = torch.equal(got_c.view(torch.int32), want.view(torch.int32))
    print(f"preview{where} census (clock64 cycles summed over the lanes): the land and "
          f"shadow marches {land_c / all_c:.3f}, the march {march_c / all_c:.3f}, the rest "
          f"{1 - (land_c + march_c) / all_c:.3f} of {all_c:.4g} lane-cycles; as shares of the "
          f"kernel's {ms:.3f} ms: {ms * land_c / all_c:.3f}, {ms * march_c / all_c:.3f}, "
          f"{ms * (1 - (land_c + march_c) / all_c):.3f} ms; the census instance's "
          f"radiance bit-equal {census_same}")
    if not census_same:
        fail(f"the preview census instance differs from march_paths_plain{where}")
    row = rows["atmos_march"]
    occ = kernels.atmos_march_occupancy()
    for b, a in enumerate(atmos_args):
        act = a[-1]
        want_a, plain_a = _plain_ms(torch, lambda: raymarcher.ray_march_atmos_plain(*a))
        got_a, ms_a = _time_ms(torch, lambda: kernels.atmos_march(*a, mie_e=C.MIE_ASYMMETRY), 5)
        ok_a = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got_a, want_a))
        print(f"atmos_march bounce {b}{where}: {act.numel()} lanes ({active[b]} active): "
              f"{ms_a:.3f} ms ({occ['registers']} registers, {occ['warps_per_sm']} warps) "
              f"bit-equal {ok_a}; plain {plain_a:.1f} ms")
        if not ok_a:
            fail(f"atmos_march differs from its plain twin at bounce {b}")
        if b == 0:
            # 17 inputs and 2 outputs per lane; per active lane its 64
            # steps, and the sun march only of the steps that need it
            row.update(ms=ms_a, plain_ms=plain_a, bytes=73 * act.numel(),
                       ops=ATMOS_LANE_OPS * active[0] + ATMOS_SUN_OPS * n_sun[0],
                       sfu=(ATMOS_LANE_SFU + 64 * ATMOS_STEP_SFU) * active[0]
                       + ATMOS_SUN_SFU * n_sun[0])
    return rows


def _atmos_sun_steps(torch, args):
    """The march steps of an atmos_march call whose sun ray the planet does
    not occlude: the ones that run the 16-step sun transmittance. Positions
    advance as in the plain twin; the test is the kernel's (rsi with the
    planet, far root > 0)."""
    from digital_earth_tpu_torch import constants as C
    from digital_earth_tpu_torch.ops import math_utils as mu

    pos, d, t_start, t_max, sun_dir = args[:5]
    active = args[-1]
    pos, d, sd = pos[active], d[active], sun_dir[active]
    t0, t1 = t_start[active], t_max[active]
    dd = ((t1 - t0) / 64)[:, None]
    pos = pos + t0[:, None] * d
    n = torch.zeros((), dtype=torch.int64, device=pos.device)
    for _ in range(64):
        _, planet_far = mu.rsi(pos, sd, C.PLANET_R)
        n += (planet_far <= 0.0).sum()
        pos = pos + dd * d
    return int(n)


def check_preview_golden(torch, dev):
    """The committed 32x18 preview golden on the card, with the CPU test's
    floors (tests/test_torch_preview.py)."""
    import numpy as np

    from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
    from digital_earth_tpu_torch.assets.textures import build_atlas
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    golden = np.load(os.path.join(ROOT, "tests", "golden", "apollo_preview.npz"))
    atlas = build_atlas(generate_earth_textures((64, 128), seed=3), dev)
    cfg = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)
    r = _apollo(Renderer(dev, image_res=(32, 18), atlas=atlas, tile_pixels=576, seed=0,
                         cfg=cfg, mode="preview"))
    for _ in range(int(golden["spp"])):
        r.accumulate()
    buf, ref = r.color_buffer.cpu().numpy(), golden["color_buffer"]
    share = np.isclose(buf, ref, rtol=1e-3, atol=1e-7).all(-1).mean()
    mean_rel = np.abs(buf.mean((0, 1)) / ref.mean((0, 1)) - 1.0).max()
    print(f"golden apollo preview 32x18 on the card: {share:.4f} of pixels within rtol 1e-3, "
          f"channel means within {mean_rel:.2e}")
    if not (share >= 0.99 and mean_rel <= 1e-3):
        fail("the card's preview disagrees with the committed preview golden")


def check_chunked(torch, dev, atlas, luts):
    """accumulate_interruptible(9) at 1920x1080 against accumulate(), same
    seed and round: bit-equal. Returns (whole s, chunked s)."""
    from digital_earth_tpu_torch.render.renderer import Renderer

    a = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    b = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    torch.cuda.synchronize()
    t0 = time.time()
    a.accumulate()
    torch.cuda.synchronize()
    t_whole = time.time() - t0
    polls = []
    t0 = time.time()
    done = b.accumulate_interruptible(9, interrupt=lambda: polls.append(1) or False)
    torch.cuda.synchronize()
    t_chunked = time.time() - t0
    equal = torch.equal(a.color_buffer, b.color_buffer)
    print(f"chunked spp {RES[0]}x{RES[1]}: accumulate {t_whole:.3f} s, "
          f"accumulate_interruptible(9) {t_chunked:.3f} s ({len(polls)} polls: 8 between "
          f"chunks, the rest between bounces), bit-equal {equal}")
    # at least one bounce poll in each of the 9 chunks
    if not (done and equal and len(polls) >= 8 + 9):
        fail("the chunked spp is not bit-equal to the whole spp")
    return t_whole, t_chunked


class ViewerRun:
    """An EarthViewer at 1920x1080 with its render loop and HTTP server on
    an ephemeral port, driven over HTTP; ``close()`` stops both."""

    def __init__(self, dev, atlas, luts, name, renderer=None, **viewer_kwargs):
        import shutil
        import threading

        from digital_earth_tpu_torch.app.viewer import EarthViewer

        work = os.path.join(ROOT, "build", "chip_smoke", name)
        os.makedirs(work, exist_ok=True)
        config = os.path.join(work, "config.txt")
        shutil.copy(SCENE, config)
        self.t_start = time.time()
        if renderer is None:
            viewer_kwargs.update(device=dev, image_res=RES, atlas=atlas, luts=luts)
        self.v = EarthViewer(renderer=renderer, config_path=config,
                             screenshot_dir=os.path.join(work, "shots"), port=0, **viewer_kwargs)
        # every frame's source and time, as the render loop makes it: a
        # preview frame can be replaced by a path frame within one fast spp,
        # before a /state poll sees it
        self.frames = []
        snapshot = self.v._snapshot_frame

        def record():
            self.frames.append((self.v._frame_source, time.time()))
            snapshot()

        self.v._snapshot_frame = record
        self.v._running = True
        self.loop = threading.Thread(target=self.v._render_loop, daemon=True)
        self.loop.start()
        self.server = self.v.make_server(host="127.0.0.1", port=0)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=60) as resp:
            return resp.read()

    def wait_for(self, pred, limit):
        deadline = time.time() + limit
        while time.time() < deadline:
            s = json.loads(self.get("/state"))
            if s["error"]:
                fail(f"the viewer's render loop failed: {s['error']}")
            if pred(s):
                return s
            time.sleep(0.01)
        fail(f"the viewer did not reach the expected state within {limit} s: {s}")

    def frame_after(self, source, t0, limit):
        """Seconds from ``t0`` to the first frame from ``source`` made after
        it."""
        deadline = time.time() + limit
        while time.time() < deadline:
            made = [t for src, t in self.frames[-1000:] if src == source and t > t0]
            if made:
                return made[0] - t0
            self.wait_for(lambda s: True, 10)  # fails on a render loop error
            time.sleep(0.01)
        fail(f"the viewer made no {source} frame within {limit} s")

    def close(self):
        self.v._running = False
        self.server.shutdown()
        self.server.server_close()
        self.loop.join(timeout=120)
        if self.loop.is_alive():
            fail("the viewer's render loop did not stop")


VIEWER_KERNELS = ("bounce_flight", "bounce_shade", "bounce_window", "compact_lanes", "gen_rays",
                  "preview", "film_postprocess", "frame_end")


def check_viewer(torch, dev, atlas, luts):
    """EarthViewer at 1920x1080 driven over HTTP on an ephemeral port.
    Returns the launch counts of the whole viewer run."""
    import struct

    from digital_earth_tpu_torch import kernels

    kernels.reset_launch_counts()
    vs = ViewerRun(dev, atlas, luts, "viewer")
    try:
        vs.wait_for(lambda s: s["frames"] >= 1, 120)
        if vs.frames[0][0] != "preview":
            fail(f"the viewer's first frame is not a preview frame: {vs.frames[:3]}")
        t_first = vs.frames[0][1] - vs.t_start
        s = vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        t_path = time.time() - vs.t_start
        time.sleep(0.5)  # into the next spp, which runs as one chunk
        vs.v.spp_chunks = 3  # read when the spp after the input starts
        t0 = time.time()
        vs.get("/input?keys=w")
        latency = vs.frame_after("preview", t0, 60)
        t0 = time.time()
        s = vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        t_chunked = time.time() - t0
        state_t0 = time.time()
        vs.get("/state")
        state_s = time.time() - state_t0
        png = vs.get("/frame.png")
        w, h = struct.unpack(">II", png[16:24])
        print(f"viewer {RES[0]}x{RES[1]}: first preview frame after {t_first:.2f} s, first "
              f"path spp after {t_path:.2f} s; input -> new preview frame "
              f"{latency * 1e3:.1f} ms (to the frame's making); then a 3-chunk "
              f"path spp {t_chunked:.2f} s after the preview; "
              f"/state answered in {state_s * 1e3:.1f} ms; /frame.png {len(png)} bytes {w}x{h}")
        if not (png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR" and (w, h) == RES):
            fail("/frame.png is not a 1920x1080 PNG")
    finally:
        vs.close()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"launches in the viewer run: {counts}")
    if not all(counts[k] > 0 for k in VIEWER_KERNELS):
        fail(f"a kernel of the viewer's path never launched: {counts}")
    return counts


def _clones(torch, r):
    return tuple(t.clone() for t in (r.color_buffer, r.count_buffer, r.lum2_buffer))


def check_adaptive(torch, dev, atlas, luts):
    """Adaptive tile sampling at 1920x1080: a uniform pass bit-equal to
    accumulate(), then 2 warm-up and 6 frac=0.25 passes, each adding exactly
    k * tile samples. Returns the launch counts of the run, its tile-list
    frame_end arguments, the buffers after the warm-up and after 4 adaptive
    passes, and (block, k)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render.renderer import Renderer

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    a = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    b = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    t_acc, t_uni = [], []
    for _ in range(2):
        t_acc.append(timed(a.accumulate))
        t_uni.append(timed(lambda: b.accumulate_adaptive(frac=1.0)))
    equal = torch.equal(a.color_buffer, b.color_buffer)
    all_two = bool((b.count_buffer == 2.0).all())
    print(f"adaptive frac=1.0 x2 vs accumulate() x2 at {RES[0]}x{RES[1]}: color bit-equal "
          f"{equal}, every count 2 {all_two}; accumulate {' '.join(f'{t:.3f}' for t in t_acc)} s, "
          f"uniform pass {' '.join(f'{t:.3f}' for t in t_uni)} s")
    if not (equal and all_two and b.current_spp == 2):
        fail("a uniform adaptive pass is not bit-equal to accumulate()")
    del a, b

    r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=9))
    w, h = RES
    n_tiles = (w // r.block[0]) * (h // r.block[1])
    k = max(1, int(n_tiles * ADAPTIVE_FRAC))
    kernels.reset_launch_counts()
    t_warm = [timed(lambda: r.accumulate_adaptive(frac=ADAPTIVE_FRAC)) for _ in range(2)]
    warm_bufs = _clones(torch, r)
    t_pass, kept, rays, after4 = [], {}, {}, None

    def adaptive_pass():
        r.accumulate_adaptive(frac=ADAPTIVE_FRAC)

    for i in range(6):
        before = r.count_buffer.double().sum().item()
        if i == 0:  # also copies the pass's gen_rays and frame_end arguments, inside its time
            t_pass.append(timed(lambda: rays.update(capture_tile_rays(
                torch, lambda: kept.update(capture_frame_end(torch, adaptive_pass))))))
        else:
            t_pass.append(timed(adaptive_pass))
        added = r.count_buffer.double().sum().item() - before
        if added != k * r.tile:
            fail(f"adaptive pass {i} added {added} samples, expected k * tile = {k * r.tile}")
        if i == 3:
            after4 = _clones(torch, r)
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ok_img = bool(torch.isfinite(img).all()) and img.min().item() >= 0.0 and img.max().item() <= 1.0
    print(f"adaptive run {RES[0]}x{RES[1]}, block {r.block}, {n_tiles} tiles, k={k} "
          f"({k * r.tile} lanes per pass): warm-up passes {' '.join(f'{t:.3f}' for t in t_warm)} s, "
          f"frac={ADAPTIVE_FRAC} passes {' '.join(f'{t:.3f}' for t in t_pass)} s (the first copies "
          f"its frame_end arguments); each added k * tile samples; mean spp {r.mean_spp:.4f}; "
          f"fetch_image finite in [0, 1] {ok_img}; launches {counts}")
    if not ok_img:
        fail("fetch_image of the adaptive run is not finite within [0, 1]")
    if not (counts["select_tiles"] == 6 * 2 == 6 * kernels.SELECT_TILES_STAGES
            and counts["frame_end"] == 8
            and counts["gen_rays"] == 8):
        fail(f"the adaptive run did not launch its kernels once per pass: {counts}")
    tile_ids = rays["args"][-1]
    if not (tile_ids.numel() == k and tile_ids.unique().numel() == k):
        fail(f"the frac={ADAPTIVE_FRAC} pass traced {tile_ids.numel()} tiles, expected k={k} distinct")
    return counts, kept, rays["args"], warm_bufs, after4, (r.block, k)


def check_frame_end(torch, kept, label):
    """frame_end against its twin on captured arguments, from zero buffers:
    a JSON row (ms, plain_ms, bytes, ops)."""
    from digital_earth_tpu_torch.render import frame_end as fe

    dev = kept["pid"].device
    n_pix = kept["n_pix"]

    def buffers():
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        return (z(n_pix, 3), z(n_pix), z(n_pix)) if kept["counts"] else (z(n_pix, 3), None, None)

    def call(fn, bufs):
        return lambda: fn(kept["responses"], kept["pid"], *bufs, **kept["kwargs"])

    kb, pb = buffers(), buffers()
    call(fe.frame_end, kb)()
    call(fe.frame_end_plain, pb)()
    torch.cuda.synchronize()
    kc, pc = kb[0], pb[0]
    atol = 1e-6 * pc.abs().max().clamp(min=1e-30)
    ok = bool(((kc - pc).abs() <= END_RTOL * pc.abs() + atol).all())
    err = (kc - pc).abs().max().item()
    nz = pc != 0
    rel = ((kc - pc).abs()[nz] / pc.abs()[nz]).max().item() if nz.any() else 0.0
    same = (kc == pc).float().mean().item()
    if kept["counts"]:
        ok = ok and torch.equal(kb[1], pb[1]) and bool(
            ((kb[2] - pb[2]).abs() <= END_RTOL * pb[2].abs() + 1e-6 * pb[2].abs().max()).all())
    _, ms = _time_ms(torch, call(fe.frame_end, buffers()), 5)
    _, plain_ms = _plain_ms(torch, call(fe.frame_end_plain, buffers()))
    n, L = kept["responses"].shape[:2]
    miss = kept["kwargs"].get("miss")
    # each input read once, each output written once: per lane radiance,
    # responses, pixel id and the pixel's colour read and written (with
    # counts, count and lum2 too); per miss lane its shading inputs
    nbytes = n * (16 * L + 8 + 24 + (16 if kept["counts"] else 0))
    # operations (counted as for the other rows): per lane the clamp, the
    # XYZ contraction, xyz_to_rgb and the deposit (with counts lum, +1 and
    # lum^2); per miss lane the denominator, the sun test, the stars tap
    # (68) and per wavelength the Planck term, the spectrum and both adds
    ops = n * ((24 if miss is None else 10 * L + 15) + (8 if kept["counts"] else 0))
    n_miss = 0
    if miss is None:
        nbytes += 4 * n
    else:
        n_miss = int(miss.st.primary_miss.sum())
        # a miss lane's bilinear tap reads at most 4 RGB texels
        stars = min(miss.atlas.stars.numel(), 4 * 3 * n_miss)
        nbytes += n + n_miss * (12 + 16 * L) + stars + miss.luts.srgb2spec.numel() * 4
        ops += n_miss * (81 + 34 * L)
    print(f"frame_end {label}: {n} lanes ({n_miss} primary misses){', with counts' if kept['counts'] else ''}: "
          f"rgb max abs err {err:.3e}, max rel err {rel:.3e}, bit-equal share {same:.6f}"
          f"{', counts equal' if kept['counts'] else ''}  kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"frame_end disagrees with its plain twin ({label})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops)


def check_select_tiles(torch, bufs, block, k, label):
    """select_tiles against its twin on an adaptive run's buffers: the same
    ids in order, m_bar and every tile score bit for bit; timed per call from
    the host (5 calls back to back) and on the device (a CUDA graph of 20
    calls). A JSON row."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import adaptive

    color, count, lum2 = bufs
    got, m_bar, scores = kernels.select_tiles(adaptive._kernel_params(), *bufs, block, k,
                                              stats=True)
    _, ms = _time_ms(torch, lambda: adaptive.select_tiles(color, count, lum2, block, k), 5)
    graph_ms = _graph_ms(torch, lambda: adaptive.select_tiles(color, count, lum2, block, k))
    # launch A alone: the frame mean, as de_shard_mean runs it on the flat buffers
    mean_ms = _graph_ms(torch, lambda: adaptive.shard_mean(color.view(-1, 3), count.view(-1)))
    want, plain_ms = _plain_ms(torch, lambda: adaptive.select_tiles_plain(color, count, lum2, block, k))
    m_want = adaptive.shard_mean_plain(color.reshape(-1, 3), count.reshape(-1))
    s_want = adaptive.tile_scores_plain(color, count, lum2, block)
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    equal = torch.equal(got, want)
    stats_equal = torch.equal(bits(m_bar), bits(m_want)) and torch.equal(bits(scores), bits(s_want))
    w, h = count.shape
    n_tiles = (w // block[0]) * (h // block[1])
    nbytes = 20 * w * h + 4 * k
    b_ms, _ = bound(nbytes, None)
    print(f"select_tiles {label}: {n_tiles} tiles of {block}, k={k}: ids equal in order {equal}, "
          f"m_bar and every score bit-equal {stats_equal}, first {got[:5].tolist()}  kernel "
          f"{ms:.4f} ms per call from the host, {graph_ms:.4f} ms on the device (CUDA graph of 20; "
          f"{b_ms / graph_ms:.2f} of the {b_ms:.4f} ms bound; the mean's launch {mean_ms:.4f}, "
          f"the scores' and rank's {graph_ms - mean_ms:.4f}), {kernels.select_launches(n_tiles)} "
          f"launches  plain {plain_ms:.1f} ms  {'ok' if equal and stats_equal else 'FAIL'}")
    if not (equal and stats_equal):
        fail(f"select_tiles disagrees with its plain twin ({label})")
    # the three buffers read once, the ids written; per pixel 20 operations
    # (luminance 5; n, the mean and its share of the frame sum 3; the score
    # and its share of the tile sum 12) and the rank's sort
    n2 = 1 << max(0, (n_tiles - 1).bit_length())
    log2 = n2.bit_length() - 1
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                ops=20 * w * h + n2 // 2 * log2 * (log2 + 1) // 2, graph_ms=graph_ms)


def check_select_tiles_past_cap(torch, dev):
    """select_tiles past the sizes it once refused (more than 8192 tiles:
    3840x2160 at 512-pixel tiles, 17,280 tiles of 20x24), on seeded
    buffers of an adaptive run's kind (1-5 samples a pixel, one
    never-sampled tile), under check_select_tiles's gates."""
    from digital_earth_tpu_torch.render import raygen

    w, h = 3840, 2160
    block = raygen.pick_block_dims(w, h, 512)
    g = torch.Generator(device=dev).manual_seed(11)
    count = torch.randint(1, 6, (w, h), generator=g, device=dev).float()
    count[:block[0], :block[1]] = 0.0
    color = torch.exp(torch.randn((w, h, 3), generator=g, device=dev)) * count[..., None]
    lum2 = color.sum(-1) ** 2 / count.clamp(min=1) * (1 + torch.rand((w, h), generator=g,
                                                                      device=dev))
    n_tiles = (w // block[0]) * (h // block[1])
    return check_select_tiles(torch, (color, count, lum2), block, n_tiles // 4,
                              f"{w}x{h} seeded, past 8192 tiles")


def check_adaptive_viewer(torch, dev, atlas, luts):
    """EarthViewer(adaptive_frac=0.25, adaptive_fps=0.25) at 1920x1080 over
    HTTP: a fractional mean spp, input in the middle of a pass answered by a
    preview frame, the passes per frame set by the frame-rate controller."""
    from digital_earth_tpu_torch import kernels

    kernels.reset_launch_counts()
    vs = ViewerRun(dev, atlas, luts, "viewer_adaptive", adaptive_frac=ADAPTIVE_FRAC,
                       adaptive_fps=0.25)
    per_frame = []
    original = vs.v._accumulate_idle

    def record(spp_per_frame):
        per_frame.append(spp_per_frame)
        return original(spp_per_frame)

    vs.v._accumulate_idle = record
    try:
        s = vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] > 2.0
                        and s["spp"] != int(s["spp"]), 180)
        t_frac = time.time() - vs.t_start
        mean_spp = s["spp"]
        time.sleep(0.3)  # into the next pass
        t0 = time.time()
        vs.get("/input?keys=w")
        latency = vs.frame_after("preview", t0, 60)
        vs.wait_for(lambda s: s["frame_source"] == "path", 120)
    finally:
        vs.close()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"adaptive viewer {RES[0]}x{RES[1]} (adaptive_frac={ADAPTIVE_FRAC}, adaptive_fps=0.25): "
          f"/state spp {mean_spp} (a mean) after {t_frac:.2f} s; input -> new preview frame "
          f"{latency * 1e3:.1f} ms (to the frame's making); passes per idle "
          f"frame from the controller {per_frame}; launches {counts}")
    if len(per_frame) < 3 or not all(counts[k] > 0 for k in VIEWER_KERNELS + ("select_tiles",)):
        fail(f"the adaptive viewer did not run its passes and kernels: {per_frame} {counts}")
    return counts


MESH_RTOL, MESH_ATOL = 1e-5, 1e-7  # a (2, 2) step against two (4, 1) steps
MESH_KERNELS = ("bounce_flight", "bounce_shade", "bounce_window", "compact_lanes", "gen_rays",
                "frame_end", "select_tiles_shard", "film_postprocess")


def _mesh(torch, devices, n_spp, atlas, luts, seed):
    from digital_earth_tpu_torch.parallel.mesh import MultiChipRenderer, make_render_mesh

    return _apollo(MultiChipRenderer(make_render_mesh(devices, spp_axis=n_spp), RES, atlas=atlas,
                                     luts=luts, seed=seed))


def _spp_seconds(torch, r, steps):
    """Seconds per spp of ``steps`` accumulate() calls (host clock, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        r.accumulate()
    torch.cuda.synchronize()
    return (time.time() - t0) / (steps * getattr(r, "spp_per_step", 1))


def _shard_bufs(r, px):
    return r._color[px], r._count[px], r._lum2[px]


def check_select_tiles_shard(torch, shards, tile, k, label):
    """The shard entries of select_tiles (de_shard_mean, de_select_tiles_shard)
    against their twins on each px row's (color, count, lum2) shard: shard
    means bit-equal, then each row's ids against the mean of the means,
    equal in order, and every tile score bit-equal. A JSON row for one row's
    two calls (ms per call from the host, and on the device from a CUDA
    graph; plain ms)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.parallel.mesh import _sum_onto
    from digital_earth_tpu_torch.render import adaptive

    bits = lambda x: x.view(torch.int32)  # noqa: E731
    n_px = len(shards)
    means = [adaptive.shard_mean(c, n) for c, n, _ in shards]
    plain = [adaptive.shard_mean_plain(c, n) for c, n, _ in shards]
    ok = all(torch.equal(bits(a), bits(b)) for a, b in zip(means, plain))
    m_bar = _sum_onto(means, shards[0][0].device) / n_px
    fp = adaptive._kernel_params()
    for b in shards:
        ids, scores = kernels.select_tiles_shard(fp, *b, tile, k, m_bar, stats=True)
        want = adaptive.select_tiles_shard_plain(*b, tile, k, m_bar)
        ok = ok and torch.equal(ids, want) and ids.unique().numel() == k and torch.equal(
            bits(scores), bits(adaptive.shard_scores_plain(*b, tile, m_bar)))
    bufs = shards[0]

    def step():
        return adaptive.select_tiles_shard(*bufs, tile, k, adaptive.shard_mean(*bufs[:2]))

    _, ms = _time_ms(torch, step, 5)
    graph_ms = _graph_ms(torch, step)
    _, plain_ms = _plain_ms(torch, lambda: adaptive.select_tiles_shard_plain(
        *bufs, tile, k, adaptive.shard_mean_plain(*bufs[:2])))
    n = bufs[1].shape[0]
    nbytes = 36 * n + 4 * k
    b_ms, _ = bound(nbytes, None)
    print(f"select_tiles_shard {label}: {n_px} shards of {n // tile} tiles of {tile} pixels, "
          f"k_local={k}: shard means bit-equal, ids equal in order and every score bit-equal "
          f"{ok}, row 0 first {ids[:5].tolist()}  kernel {ms:.4f} ms per call from the host, "
          f"{graph_ms:.4f} on the device (CUDA graph of 20; {b_ms / graph_ms:.2f} of the "
          f"{b_ms:.4f} ms bound; one shard's mean and selection, 2 launches)  plain "
          f"{plain_ms:.1f} ms  {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"select_tiles_shard disagrees with its plain twin ({label})")
    # a shard read twice (color and count for the mean, 16 B a pixel; the
    # three buffers for the scores, 20 B), the ids written; per pixel 8
    # operations for the mean and 20 for the score (as select_tiles), and
    # the rank's sort
    n_t = n // tile
    n2 = 1 << max(0, (n_t - 1).bit_length())
    log2 = n2.bit_length() - 1
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                ops=28 * n + n2 // 2 * log2 * (log2 + 1) // 2, graph_ms=graph_ms)


def adaptive_mesh_pass(torch, devices, atlas, luts):
    """A (len(devices), 1) mesh's 2 warm-up passes and one frac=ADAPTIVE_FRAC
    pass at 1920x1080: warm-up counts all 2, then each device refines whole
    tiles, exactly those ``select_tiles_shard_plain`` picks on its shard
    against the mean of the shard means. Returns (renderer, the warm-up
    shards, the pass's seconds)."""
    from digital_earth_tpu_torch.parallel.mesh import _sum_onto
    from digital_earth_tpu_torch.render import adaptive

    n = len(devices)
    ma = _mesh(torch, devices, 1, atlas, luts, 9)
    ma.accumulate_adaptive(frac=ADAPTIVE_FRAC)
    ma.accumulate_adaptive(frac=ADAPTIVE_FRAC)
    k_local = max(1, min(ma.tiles_per_dev, int(ma.tiles_per_dev * ADAPTIVE_FRAC)))
    warm_ok = all(bool((c == 2.0).all()) for c in ma._count)
    warm = [tuple(t.clone() for t in _shard_bufs(ma, px)) for px in range(n)]
    m_bar = _sum_onto([adaptive.shard_mean_plain(*b[:2]) for b in warm], ma.device) / n
    want = [sorted(adaptive.select_tiles_shard_plain(*b, ma.tile, k_local, m_bar.to(b[0].device))
                   .tolist()) for b in warm]
    samples0 = ma.total_samples
    torch.cuda.synchronize()
    t0 = time.time()
    ma.accumulate_adaptive(frac=ADAPTIVE_FRAC)
    torch.cuda.synchronize()
    t_pass = time.time() - t0
    deltas = [(c - b[1]).view(-1, ma.tile) for c, b in zip(ma._count, warm)]
    got = [torch.nonzero(d[:, 0] == 1.0).flatten().tolist() for d in deltas]
    whole = all(torch.equal(d, d[:, :1].expand(-1, ma.tile)) for d in deltas)
    added = ma.total_samples - samples0
    ok = warm_ok and whole and got == want and added == n * k_local * ma.tile
    print(f"mesh adaptive ({n}, 1) over {sorted({str(d) for d in devices})}: warm-up counts all 2 "
          f"{warm_ok}; a frac={ADAPTIVE_FRAC} pass {t_pass:.3f} s refined per device the whole "
          f"tiles select_tiles_shard_plain picks {whole and got == want} (k_local={k_local}, "
          f"{added} samples)")
    if not ok:
        fail("the mesh's adaptive pass did not refine each device's own selection")
    return ma, warm, t_pass


def check_mesh(torch, dev, atlas, luts):
    """Multi-device rendering at 1920x1080, Apollo 11, default TraceConfig:
    meshes of logical devices on the one card (and over distinct cards where
    the machine has them). Returns (launch counts of the mesh run, the
    select_tiles_shard JSON row)."""
    import struct

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.parallel.mesh import MultiChipRenderer, _sum_onto, make_render_mesh
    from digital_earth_tpu_torch.render import adaptive
    from digital_earth_tpu_torch.render.renderer import Renderer

    card = nvidia_smi_line()
    one = [dev] * 4
    a = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    a.accumulate()
    a.accumulate()
    ref2 = a.color_buffer.clone()
    t_single = [_spp_seconds(torch, a, 2)]
    del a

    kernels.reset_launch_counts()
    m41 = _mesh(torch, one, 1, atlas, luts, 5)
    m41.accumulate()
    ref1 = m41.color_buffer
    m41.accumulate()
    equal41 = torch.equal(m41.color_buffer, ref2)
    t41 = _spp_seconds(torch, m41, 2)
    m22 = _mesh(torch, one, 2, atlas, luts, 5)
    m22.accumulate()  # spp 0 and 1 in one step
    close22 = torch.allclose(m22.color_buffer, ref2, rtol=MESH_RTOL, atol=MESH_ATOL)
    err22 = (m22.color_buffer - ref2).abs().max().item()
    t22 = _spp_seconds(torch, m22, 2)
    del m22
    mc = _mesh(torch, one, 1, atlas, luts, 5)
    polls = []
    done = mc.accumulate_interruptible(9, interrupt=lambda: polls.append(1) or False)
    equal_chunked = done and torch.equal(mc.color_buffer, ref1)
    del mc, ref1
    print(f"mesh {RES[0]}x{RES[1]} over [cuda:0] x 4 ({card}): (4, 1) block {m41.block}, "
          f"{m41.tiles_per_dev} tiles per device, bit-equal to Renderer over 2 spp {equal41}; "
          f"(2, 2) one step within rtol {MESH_RTOL} of the sequential steps {close22} (max abs "
          f"diff {err22:.3e}); accumulate_interruptible(9) bit-equal {equal_chunked} "
          f"({len(polls)} polls)")
    if not (equal41 and close22 and equal_chunked and len(polls) >= 8 + 9):
        fail("the mesh's frame disagrees with the single-device Renderer")

    ma, warm, t_pass = adaptive_mesh_pass(torch, one, atlas, luts)
    img = ma.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"launches in the mesh run: {counts}")
    if not bool(torch.isfinite(img).all()):
        fail("fetch_image of the mesh's adaptive run is not finite")
    if not all(counts[k] > 0 for k in MESH_KERNELS) or counts["select_tiles"]:
        fail(f"a kernel of the mesh's path never launched (or the whole-frame select_tiles did): "
             f"{counts}")
    k_local = max(1, min(ma.tiles_per_dev, int(ma.tiles_per_dev * ADAPTIVE_FRAC)))
    row = check_select_tiles_shard(torch, warm, ma.tile, k_local, "after 2 warm-up passes")
    check_select_tiles_shard(torch, [_shard_bufs(ma, px) for px in range(4)], ma.tile, k_local,
                             f"after the frac={ADAPTIVE_FRAC} pass")
    del warm

    ckpt = os.path.join(ROOT, "build", "chip_smoke", "mesh_ckpt.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    m41.save_checkpoint(ckpt)
    back = _mesh(torch, one, 2, atlas, luts, 0)
    back.load_checkpoint(ckpt)
    single = Renderer(dev, image_res=RES, atlas=atlas, luts=luts)
    single.load_checkpoint(ckpt)
    ma.save_checkpoint(ckpt)
    back_a = _mesh(torch, [dev] * 2, 1, atlas, luts, 0)
    back_a.load_checkpoint(ckpt)
    ck_ok = (torch.equal(back.color_buffer, m41.color_buffer)
             and torch.equal(single.color_buffer, m41.color_buffer)
             and back.current_spp == m41.current_spp
             and torch.equal(back_a.count_buffer, ma.count_buffer)
             and back_a.mean_spp == ma.mean_spp)
    print(f"mesh checkpoints: (4, 1) -> (2, 2) and -> Renderer, adaptive (4, 1) -> (2, 1): "
          f"round trip exact {ck_ok}")
    if not ck_ok:
        fail("a mesh checkpoint did not load back exactly")
    del m41, ma, back, back_a, single

    a = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts, seed=5))
    a.accumulate()
    t_single.append(_spp_seconds(torch, a, 2))
    del a
    print(f"mesh s/spp at {RES[0]}x{RES[1]} ({card}): Renderer {t_single[0]:.4f} then "
          f"{t_single[1]:.4f}; (4, 1) over [cuda:0] x 4 {t41:.4f} "
          f"({t41 / min(t_single):.2f}x); (2, 2) over [cuda:0] x 4 {t22:.4f} "
          f"({t22 / min(t_single):.2f}x)")

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device(f"cuda:{i}") for i in range(n_cards)]
        md = _mesh(torch, cards, 1, atlas, luts, 5)
        md.accumulate()
        md.accumulate()
        equal_d = torch.equal(md.color_buffer, ref2)
        t_d = _spp_seconds(torch, md, 2)
        del md
        spp_axis = 2 if n_cards % 2 == 0 else 1
        m2 = _mesh(torch, cards, spp_axis, atlas, luts, 5)
        m2.accumulate()
        if spp_axis == 1:
            m2.accumulate()
        close_2 = torch.allclose(m2.color_buffer, ref2, rtol=MESH_RTOL, atol=MESH_ATOL)
        t_2 = _spp_seconds(torch, m2, 2)
        print(f"mesh over {n_cards} distinct cards ({card}): ({n_cards}, 1) bit-equal to Renderer "
              f"over 2 spp {equal_d}, {t_d:.4f} s/spp ({t_d / min(t_single):.2f}x the Renderer's); "
              f"{m2.mesh.shape} within rtol {MESH_RTOL} {close_2}, {t_2:.4f} s/spp "
              f"({t_2 / min(t_single):.2f}x)")
        del m2
        if not (equal_d and close_2):
            fail("the mesh over distinct cards disagrees with the single-device Renderer")
        launched = kernels.select_tiles_shard.launches
        md, _, _ = adaptive_mesh_pass(torch, cards, atlas, luts)
        if kernels.select_tiles_shard.launches - launched != n_cards * kernels.SELECT_TILES_STAGES:
            fail("the distinct cards did not each launch their shard's select_tiles_shard")
        del md
    else:
        print("mesh over distinct cards: not run (this machine has 1 CUDA card)")

    vr = MultiChipRenderer(make_render_mesh(), RES, atlas=atlas, luts=luts)
    vs = ViewerRun(dev, atlas, luts, "viewer_multichip", renderer=vr)
    try:
        vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        t0 = time.time()
        vs.get("/input?keys=w")
        latency = vs.frame_after("preview", t0, 60)
        s = vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        png = vs.get("/frame.png")
    finally:
        vs.close()
    w, h = struct.unpack(">II", png[16:24])
    print(f"viewer over the --multichip renderer (mesh {vr.mesh.shape}): path spp {s['spp']}, "
          f"input -> new preview frame {latency * 1e3:.1f} ms, /frame.png {w}x{h}")
    if (w, h) != RES:
        fail("the --multichip viewer's /frame.png is not 1920x1080")
    del ref2
    return counts, row


def profile_preview(torch, dev, atlas, luts):
    """One warm 480x270 preview frame (accumulate + fetch_image) under
    torch.profiler: device kernels per frame (at most
    MAX_KERNELS_PER_PREVIEW) and the device-busy share."""
    from digital_earth_tpu_torch.render.renderer import Renderer

    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    r.accumulate()
    r.fetch_image()
    label = f"Apollo 11 preview {PREVIEW_RES[0]}x{PREVIEW_RES[1]}"
    n_kernels, busy, wall, by_name = profile_spp(
        torch, r, label, run=lambda: (r.accumulate(), r.fetch_image()), unit="frame")
    preview_us = sum(us for name, us in by_name.items() if "preview_kernel" in name)
    print(f"profile {label}: preview {preview_us / 1e3:.3f} ms of {busy * 1e3:.3f} ms "
          f"device-busy per frame ({nvidia_smi_line()}); its kernels: "
          + ", ".join(name[:48] for name in by_name))
    if not 0 < n_kernels <= MAX_KERNELS_PER_PREVIEW:
        fail(f"{n_kernels} device kernels per preview frame (expected 1-{MAX_KERNELS_PER_PREVIEW})")
    return n_kernels, busy, wall


def check_main_path(torch, counts, r, img, label):
    """Phase 6's gates on a main-path run's launch counts, buffer and image."""
    buf = r.color_buffer
    finite = bool(torch.isfinite(buf).all())
    mean = buf.mean().item()
    print(f"launches on the {label}: {counts}; buffer finite {finite}, mean {mean:.6g}")
    if not all(counts[k] > 0 for k in MAIN_PATH):
        fail(f"a kernel of the {label} never launched: {counts}")
    if any(counts[k] for k in INLINED):
        fail(f"the path tracer launched a loop kernel of its own: {counts}")
    launches = counts["bounce_flight"] + counts["bounce_window"]
    if not (counts["compact_lanes"] == launches and counts["gen_rays"] == 3
            and counts["bounce_shade"] == counts["bounce_flight"]
            and counts["bounce_window"] <= 3 and launches <= 3 * r.cfg.max_bounces):
        fail(f"compact_lanes did not launch once per bounce launch, or the window more than "
             f"once per spp: {counts}")
    if not (finite and mean > 0.0):
        fail(f"the accumulated buffer of the {label} is not finite with a positive mean")
    if not (bool(torch.isfinite(img).all()) and img.shape == (*RES, 3)):
        fail("fetch_image is not a finite (W, H, 3) image")


def build_tier2_atlas(torch, dev):
    """``upsampled_procedural_atlas(dev, TIER2_RES)`` from the shipped
    1350x2700 base, through a fresh cache under build/: the host load (the
    base's npz, its max-mips, the planes' cache), the upload and the four
    ``upsample`` launches timed apart (host clock, synchronized). Returns
    (atlas, each launch's arguments, the build's split in seconds)."""
    import shutil

    from digital_earth_tpu_torch.assets import textures as tex
    from digital_earth_tpu_torch.ops import texture as tx

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    shutil.rmtree(cache, ignore_errors=True)
    spent = {"host": 0.0, "kernel": []}
    calls = []
    cached, up = tex.cached_atlas_arrays, tx.upsample

    def timed_cached(*args, **kwargs):
        t0 = time.time()
        out = cached(*args, **kwargs)
        spent["host"] += time.time() - t0
        return out

    def timed_up(base, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = up(base, *args, **kwargs)
        torch.cuda.synchronize()
        spent["kernel"].append(time.time() - t0)
        calls.append((base, args, kwargs))
        return out

    tex.cached_atlas_arrays, tx.upsample = timed_cached, timed_up
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        atlas = tex.upsampled_procedural_atlas(dev, TIER2_RES, cache_dir=cache)
        torch.cuda.synchronize()
        total = time.time() - t0
    finally:
        tex.cached_atlas_arrays, tx.upsample = cached, up
    upload = total - spent["host"] - sum(spent["kernel"])
    base_mb = sum(c[0].numel() for c in calls) / 1e6
    shapes = {name: tuple(getattr(atlas, name).shape) for name in tex.TextureAtlas._fields}
    print(f"tier-2 atlas {TIER2_RES[1]}x{TIER2_RES[0]}: {total:.3f} s = host load "
          f"{spent['host']:.3f} s (shipped base, max-mips, plane cache) + upload {upload:.3f} s "
          f"({base_mb:.1f} MB of base planes) + upsample launches "
          f"{' '.join(f'{t * 1e3:.2f}' for t in spent['kernel'])} ms (host clock, synchronized); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {shapes}")
    want = {"material": 8, "topography": 4, "clouds": 4, "stars": 3}
    if len(calls) != 4 or any(shapes[k] != (*TIER2_RES, c) for k, c in want.items()):
        fail(f"the tier-2 atlas is not four upsampled {TIER2_RES} planes: {shapes}")
    split = dict(total_s=total, host_s=spent["host"], upload_s=upload,
                 kernel_ms=[t * 1e3 for t in spent["kernel"]])
    return atlas, calls, split


def check_upsample(torch, calls, atlas):
    """``upsample`` bit-equal to ``upsample_plain`` on the card on the four
    full-size planes of the tier-2 atlas, each timed beside its twin and
    the one PyTorch copy of the plain repeat: a JSON row for the atlas (the
    four planes' sums)."""
    from digital_earth_tpu_torch.assets.textures import TextureAtlas
    from digital_earth_tpu_torch.ops import texture as tx

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for name, (base, args, kwargs) in zip(TextureAtlas._fields, calls):
        got = getattr(atlas, name)
        want = tx.upsample_plain(base, *args, **kwargs)
        equal = torch.equal(got, want)
        err = 0.0 if equal else (got.to(torch.int16) - want.to(torch.int16)).abs().max().item()
        del want
        _, ms = _time_ms(torch, lambda: tx.upsample(base, *args, **kwargs), 5)
        _, plain_ms = _plain_ms(torch, lambda: tx.upsample_plain(base, *args, **kwargs))
        h, w, c = base.shape
        f = args[0]
        _, lib_ms = _time_ms(
            torch, lambda: base[:, None, :, None].expand(h, f, w, f, c).reshape(h * f, w * f, c), 5)
        jittered = kwargs.get("jitter", 0.0) > 0.0
        # the base read once, the plane written once; per jittered texel
        # the hash and the scale
        nbytes = base.numel() + got.numel()
        b_ms, b_by = bound(nbytes, UPSAMPLE_JITTER_OPS * h * f * w * f if jittered else None)
        print(f"upsample {name} {tuple(base.shape)} x{f} -> {tuple(got.shape)}"
              f"{' jitter ' + str(kwargs['jitter']) + ' seed ' + hex(kwargs['jitter_seed']) if jittered else ''}: "
              f"bit-equal {equal} (max abs err {err})  kernel {ms:.3f} ms  plain {plain_ms:.2f} ms  "
              f"expand+reshape copy {lib_ms:.3f} ms{' (without the jitter)' if jittered else ''}  "
              f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.2f} of the kernel's)  "
              f"{'ok' if equal else 'FAIL'}")
        if not equal:
            fail(f"upsample disagrees with its plain twin on the {name} plane")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms), ("bytes", nbytes)):
            row[k] += v
        row["ops"] += UPSAMPLE_JITTER_OPS * h * f * w * f if jittered else 0
    b_ms, _ = bound(row["bytes"], row["ops"])
    print(f"upsample, four planes: kernel {row['ms']:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_ms / row['ms']:.2f} of the kernel's), expand+reshape copies {row['library_ms']:.3f} ms")
    return row


def check_tier2(torch, dev, luts, s_per_spp):
    """The tier-2 texture path: the atlas built on the card (its launches
    counted from 0 with the render's), Apollo 11 at 1920x1080 with default
    ``TraceConfig()`` on it under phase 6's gates (s/spp beside the
    1024x2048 atlas's ``s_per_spp`` of this run), ``upsample`` against its
    twin, ``bounce`` against its twin at tier-2 bounce 0, and a 480x270
    preview frame. Returns (atlas, the upsample JSON row, launch counts)."""
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import encode_png, render_offline
    from digital_earth_tpu_torch.render import pathtracer as pt

    w, h = RES
    kernels.reset_launch_counts()
    atlas, calls, _ = build_tier2_atlas(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES, out_path=None,
                       atlas=atlas, luts=luts)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    t0 = time.time()
    for _ in range(2):
        r.accumulate()
    torch.cuda.synchronize()
    dt = (time.time() - t0) / 2
    img = r.fetch_image()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"render_offline Apollo 11 {w}x{h} on the tier-2 {TIER2_RES[1]}x{TIER2_RES[0]} atlas, "
          f"default TraceConfig, 3 spp: warm-up {warmup_s:.2f} s, {dt:.3f} s/spp "
          f"({dt / s_per_spp:.2f}x the 1024x2048 atlas's {s_per_spp:.3f} s/spp in this run), "
          f"{w * h / dt:.1f} paths/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_main_path(torch, counts, r, img, "tier-2 main path")
    if counts["upsample"] != 4:
        fail(f"the tier-2 atlas did not take four upsample launches: {counts}")
    with open(os.path.join(ROOT, "build", "chip_smoke", "apollo11_1080p_tier2_3spp.png"), "wb") as f:
        f.write(encode_png(r.fetch_image_np()))
    del r, img

    row = check_upsample(torch, calls, atlas)
    del calls
    states, _, _ = capture_states(torch, dev, atlas, luts, (0,))
    c = states[0]
    c["twin"] = pt.run_bounce_plain(c["st"].take(c["idx"].long()), 0, *c["args"])
    torch.cuda.synchronize()
    print("tier-2 atlas, bounce against its twin:")
    check_bounce(torch, states)
    del states, c
    preview_frame(torch, dev, atlas, luts, "on the tier-2 atlas")
    return atlas, row, counts


def _input_latencies(vs, samples):
    """Seconds from ``/input?keys=w`` to a new preview frame, ``samples``
    times, each sent 0.3 s into a path (or adaptive) frame."""
    out = []
    for _ in range(samples):
        vs.wait_for(lambda s: s["frame_source"] == "path" and s["spp"] >= 1, 120)
        time.sleep(0.3)
        t0 = time.time()
        vs.get("/input?keys=w")
        out.append(vs.frame_after("preview", t0, 60))
    return out


def preview_bench(torch, dev):
    """``--preview-bench [DIR]``: the preview's end-to-end numbers for the
    package imported from DIR (default this checkout), so that two versions
    can be alternated in one call: the 480x270 preview frame (accumulate +
    fetch_image, 2 warm-up and 10 timed frames, host clock to a
    synchronize) and one profiled frame (device kernels, device-busy share,
    the preview kernel's device time) on the 1024x2048 and on the tier-2
    atlas; the preview kernel alone on the first frame's lanes (5 calls back
    to back) and its registers (ptxas, when this process built the kernels;
    with its occupancy where the package reports it);
    ``select_tiles`` at 1920x1080 on seeded buffers (k a quarter of the
    tiles), per call from the host (5 calls back to back) and on the device
    (a CUDA graph of 20 calls); input to a new preview frame through
    EarthViewer at 1920x1080 with uniform and with adaptive idle frames, 5
    samples each. Prints one JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import (procedural_texture_atlas,
                                                         upsampled_procedural_atlas)
    from digital_earth_tpu_torch.render import adaptive, raygen, raymarcher
    from digital_earth_tpu_torch.render.renderer import Renderer

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line(),
               frame_ms={}, kernels_per_frame={}, busy_share={}, preview_profiled_ms={},
               input_to_preview_ms={})
    for name, at in (("1024x2048", atlas),
                     ("tier-2", upsampled_procedural_atlas(dev, TIER2_RES, cache_dir=cache))):
        r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=at, luts=luts, mode="preview"))
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.time()
            r.accumulate()
            r.fetch_image()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.time() - t0) * 1e3)
        n_k, busy, wall, by_name = profile_spp(torch, r, f"preview {name}",
                                               run=lambda: (r.accumulate(), r.fetch_image()),
                                               unit="frame")
        out["frame_ms"][name] = [round(t, 2) for t in times]
        out["kernels_per_frame"][name] = n_k
        out["busy_share"][name] = round(busy / wall, 4)
        out["preview_profiled_ms"][name] = round(
            sum(us for k, us in by_name.items() if "preview_kernel" in k) / 1e3, 4)
        if name == "1024x2048":
            # the preview kernel alone on this frame's lanes, 5 calls back to
            # back, with its blocks built beforehand
            march = {}
            original = raymarcher.march_paths

            def keep(*args, **kwargs):
                march.update(args=args, kwargs=kwargs)
                return original(*args, **kwargs)

            raymarcher.march_paths = keep
            try:
                r.accumulate()
            finally:
                raymarcher.march_paths = original
            args, kw = march["args"], dict(march["kwargs"])
            kw.setdefault("frame", raymarcher.PreviewFrame(*args[4:8], kw["tile"]))
            _, out["preview_kernel_ms"] = _time_ms(
                torch, lambda: raymarcher.march_paths(*args, **kw), 5)
            log = kernels.ptxas_log.get("preview.cu", "")
            out["preview_ptxas"] = [line.strip() for line in log.splitlines()
                                    if "registers" in line]
            if hasattr(kernels, "preview_occupancy"):
                out["preview_occupancy"] = kernels.preview_occupancy()
        del r, at
    # select_tiles at 1920x1080 on seeded buffers, k = a quarter of the tiles
    g = torch.Generator().manual_seed(5)
    w, h = RES
    block = raygen.pick_block_dims(w, h, 2048)
    k = (w // block[0]) * (h // block[1]) // 4
    count = torch.randint(1, 6, (w, h), generator=g).float()
    color = torch.exp(torch.randn((w, h, 3), generator=g)) * count[..., None]
    lum2 = color.sum(-1) ** 2 / count * (1 + torch.rand((w, h), generator=g))
    bufs = [t.to(dev).contiguous() for t in (color, count, lum2)]
    _, out["select_tiles_ms_per_call"] = _time_ms(
        torch, lambda: adaptive.select_tiles(*bufs, block, k), 5)
    out["select_tiles_graph_ms"] = _graph_ms(torch, lambda: adaptive.select_tiles(*bufs, block, k))
    out["select_tiles_launches_per_call"] = kernels.SELECT_TILES_STAGES
    for mode, kw in (("uniform", {}), ("adaptive", dict(adaptive_frac=ADAPTIVE_FRAC))):
        vs = ViewerRun(dev, atlas, luts, f"bench_{mode}", **kw)
        try:
            out["input_to_preview_ms"][mode] = [round(t * 1e3, 1)
                                                for t in _input_latencies(vs, 5)]
        finally:
            vs.close()
    print(json.dumps({"preview_bench": out}))


def threefry_bench(torch, dev, kernels):
    """The package's threefry launcher at the frame's shape (a fold and 3
    draws for each of 1920 x 1080 lanes; the keys given as int32 words to
    its C entry, so the time is its kernel's, in any version of the
    package): per call from the host, back to back, and on the device (a
    CUDA graph of 20 calls), bit-equal to the plain version or not; and the
    SASS census of a block and a draw where the library has their
    launchers. A dict."""
    from digital_earth_tpu_torch.ops import rng

    n = RES[0] * RES[1]
    keys = rng.lane_keys(rng.prng_key(7, dev), torch.arange(n, device=dev))
    k32 = kernels.keys_i32(keys)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)

    def launch():
        kernels._launch("de_threefry_uniform", kernels._ptr(k32), n, 4, 3, kernels._ptr(out))

    _, ms = _time_ms(torch, launch, 20)
    graph_ms = _graph_ms(torch, launch)
    want = rng.uniform(rng.fold(keys, 4), (3,))
    res = dict(ms=round(ms, 5), graph_ms=round(graph_ms, 5),
               bit_equal=torch.equal(out.view(torch.int32), want.view(torch.int32)))
    funcs = sass_functions(kernels.library()._name)
    if all(any(pattern.format(2) in name for name in funcs) for _, pattern, _ in SASS_PAIRS):
        import digital_earth_tpu_torch as pkg

        res["sass"] = sass_census(kernels, f" ({os.path.dirname(os.path.abspath(pkg.__file__))})",
                                  funcs)
    return res


def scene_runs(torch, dev, atlas, luts, profiled, cfg=None):
    """Per scene (Apollo 11, florida, sunset hurricane at 1920x1080; at
    ``cfg``, else the package's default config) through ``render_offline``:
    (name, s/spp of 3 spp after 1 warm-up, the ``profile_spp`` tuples of
    ``profiled`` more spp), for the package imported; a generator."""
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline

    kw = {} if cfg is None else dict(cfg=cfg)
    for scene in (SCENE, *(os.path.join(ROOT, "scenes", s) for s in OTHER_SCENES)):
        name = os.path.basename(scene)[9:-4]
        r = render_offline(load_config(scene), dev, spp=1, image_res=RES, out_path=None,
                           atlas=atlas, luts=luts, **kw)
        s_spp = _spp_seconds(torch, r, 3)
        profiles = [profile_spp(torch, r, name) for _ in range(profiled)]
        del r
        yield name, s_spp, profiles


def _bounce_device_ms(by_name):
    """The bounce kernels' device ms in a ``profile_spp`` breakdown."""
    return sum(us for k, us in by_name.items() if "bounce" in k) / 1e3


def tap_bench(torch, dev):
    """``--tap-bench [DIR]``: the texture taps of the package in DIR and what
    they move, so that versions can be alternated in one call:
    ``check_texture``'s rows (bounce 0's surface points and march probes,
    the stars at the whole frame's primary misses, the edge sweep; nearest
    and bilinear, each against its twin, the bilinear tap also against the
    first form, timed on the device); the census's cycle split of bounce 0
    on the three scenes (the shade's surface branch apart where the
    package's census has it); bounce 0's bounce_flight and bounce_shade on
    the three scenes at the default config (the default instances) and at
    bilinear_tracking (the options instances); per scene s/spp of the
    default config and of bilinear_tracking against it (``spp_ratio``); frame_end on the whole
    frame (per call, back to back); the 480x270 preview frame (2 warm-up
    and 10 timed frames) and its preview kernel alone (20 calls back to
    back); the bounce instances' SASS sizes. One JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render import frame_end as fe
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import raymarcher
    from digital_earth_tpu_torch.render.params import TraceConfig
    from digital_earth_tpu_torch.render.renderer import Renderer

    t0 = time.time()
    kernels.library()
    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line(),
               build_s=round(time.time() - t0, 1))
    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    _, states, _, lookups, frame_end_args = capture_inputs(torch, dev, atlas, luts)
    out["census_split"], out["bounce0_ms"] = {}, {}
    probes = 0
    for scene in (SCENE, FLORIDA, SUNSET):
        sts = states if scene == SCENE else capture_states(
            torch, dev, atlas, luts, bounces=(0,), scene=scene)[0]
        c = sts[0]
        name = os.path.basename(scene)[9:-4]
        for label, cfg in (("default", None), ("bilinear_tracking",
                                               TraceConfig(bilinear_tracking=True))):
            cb = c if cfg is None else capture_states(torch, dev, atlas, luts, bounces=(0,),
                                                      scene=scene, cfg=cfg)[0][0]
            frame = pt.BounceFrame(cb["st"], *cb["args"])
            ka = lambda st: pt._kernel_args(st, cb["idx"], 0, *cb["args"], frame)  # noqa: E731
            flight = kernels.bounce_flight(*ka(_clone_state(cb["st"])))
            out["bounce0_ms"][f"{label} {name}"] = [
                round(_bounce_ms(torch, cb["st"], lambda st: kernels.bounce_flight(*ka(st))), 4),
                round(_bounce_ms(torch, cb["st"],
                                 lambda st: kernels.bounce_shade(*ka(st), flight=flight)), 4)]
            del cb, frame, flight
        trips, _, cycles = _census(torch, c["st"], c["idx"], 0, c["args"],
                                   pt.BounceFrame(c["st"], *c["args"]))
        if scene == SCENE:
            t = trips.to(torch.float64)
            probes = int(sum(float(site_probes(torch, t[:, j], c["args"][3].march_k).sum())
                             for j in MARCH_SITES))
        split = cycle_split(torch, cycles)
        sites, fl, sh, total = split
        print(f"census {name} bounce 0: {split_text(split)}")
        out["census_split"][name] = dict(
            sites=[round(x, 4) for x in sites], flight=round(fl, 4), shade=round(sh, 4),
            shade_rest=round(sh - sum(sites[4:]), 4), warp_cycles=total)
        del sts, c, trips, cycles
    taps = check_texture(torch, lookups, atlas, probes, frame_end_args)
    out["taps"] = {k: v for k, v in taps.items() if isinstance(v, dict)}
    kept = frame_end_args
    n_pix = kept["n_pix"]

    def frame_end_call():
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        bufs = (z(n_pix, 3), z(n_pix), z(n_pix)) if kept["counts"] else (z(n_pix, 3), None, None)
        return fe.frame_end(kept["responses"], kept["pid"], *bufs, **kept["kwargs"])

    out["frame_end_ms"] = [round(_time_ms(torch, frame_end_call, 20)[1], 4) for _ in range(3)]
    del states, lookups, frame_end_args, kept
    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.time()
        r.accumulate()
        r.fetch_image()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(round((time.time() - t0) * 1e3, 3))
    out["preview_frame_ms"] = times
    march, original = {}, raymarcher.march_paths

    def keep(*args, **kwargs):
        march.update(args=args, kwargs=kwargs)
        return original(*args, **kwargs)

    raymarcher.march_paths = keep
    try:
        r.accumulate()
    finally:
        raymarcher.march_paths = original
    args, kw = march["args"], dict(march["kwargs"])
    kw.setdefault("frame", raymarcher.PreviewFrame(*args[4:8], kw["tile"]))
    out["preview_kernel_ms"] = [round(_time_ms(
        torch, lambda: raymarcher.march_paths(*args, **kw), 20)[1], 4) for _ in range(3)]
    del r, march, args, kw
    out["s_per_spp"] = {}
    for scene in (SCENE, FLORIDA, SUNSET):
        make = lambda o: render_offline(load_config(scene), dev, spp=1, image_res=RES,  # noqa: E731
                                        out_path=None, atlas=atlas, luts=luts,
                                        cfg=TraceConfig(**o))
        d, o, ratios = spp_ratio(torch, make({}), make(dict(bilinear_tracking=True)))
        out["s_per_spp"][os.path.basename(scene)[9:-4]] = dict(
            default=round(d, 5), bilinear_tracking=round(o, 5),
            ratio_median=round(ratios[len(ratios) // 2], 4), ratios=[round(x, 4) for x in ratios])
    funcs = sass_functions(kernels.library()._name)
    out["sass"] = {entry: n for _, (entry, _, n) in sorted(bounce_instances(funcs).items())}
    out["ptxas"] = {src: ptxas_entries(kernels.ptxas_log.get(src, "")) for src in
                    ("texture_check.cu", "bounce.cu", "bounce_opts.cu", "preview.cu",
                     "frame_end.cu")}
    print(json.dumps({"tap_bench": out}))


def spp_bench(torch, dev, reps=3):
    """``--spp-bench [DIR]``: per scene (``scene_runs``) at the default
    config and at the reference's estimator: s/spp, then ``reps`` profiled
    spp (the bounce kernels' device ms and the device kernels of each), for
    the package imported from DIR; lighter than ``--path-bench``, so
    versions can be alternated more often in one call. Prints one JSON
    line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render.params import TraceConfig

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line())
    for label, cfg in (("default", TraceConfig()), ("estimator", TraceConfig(**REF_ESTIMATOR))):
        for name, s_spp, profiles in scene_runs(torch, dev, atlas, luts, reps, cfg):
            out[f"{label} {name}"] = dict(
                s_per_spp=round(s_spp, 5), bounce_ms=[round(_bounce_device_ms(p[3]), 3) for p in profiles],
                kernels=[p[0] for p in profiles])
    print(json.dumps({"spp_bench": out}))


def path_bench(torch, dev):
    """``--path-bench [DIR]``: the path tracer's end-to-end numbers for the
    package imported from DIR (default this checkout), through its public
    API, so that two versions can be alternated in one call: s/spp of Apollo
    11, florida and sunset hurricane at 1920x1080 (1 warm-up, 3 timed spp),
    then one profiled spp each (device kernels, device-busy share, the
    bounce kernels' device ms); their s/spp at the reference's own estimator
    (REF_ESTIMATOR), where the package has its options; s/spp of the (4, 1) and (2, 2) meshes over
    [cuda:0] x 4 (1 warm-up, 2 timed); the 480x270 preview frame (2 warm-up,
    10 timed) and input to preview through EarthViewer with uniform idle
    frames (5 samples); the ms of the package's run_bounce at each bounce
    of one Apollo spp (one launch per bounce); the bounce entries'
    registers and spills; the tracker and march launchers on that spp's
    arguments at bounces 0 and DEEP_BOUNCE; per scene at those bounces the
    lanes of the bounce entries not bit-equal to their twin, the census's
    cycle split and the trackers' SIMT efficiency; and the package's
    compact_lanes on that spp's alive vectors at bounces 0, DEEP_BOUNCE and
    the deepest, timed both ways (``_compact_times``); ``gen_rays`` on the
    1080p path frame per call from the host and from a CUDA graph (where
    the package's wrapper allows one), its kernel's profiled device ms per
    spp; the tier-2 atlas's build split and each plane's ``upsample`` ms
    beside the expand+reshape copy. Prints one JSON line."""
    import digital_earth_tpu_torch as pkg
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas
    from digital_earth_tpu_torch.render.renderer import Renderer

    cache = os.path.join(ROOT, "build", "chip_smoke", "texture_cache")
    luts = load_spectral_luts(dev)
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7, cache_dir=cache)
    out = dict(package=os.path.dirname(os.path.abspath(pkg.__file__)), card=nvidia_smi_line(),
               s_per_spp={}, bounce_ms_per_spp={}, kernels_per_spp={}, busy_share={},
               busy_ms_per_spp={}, busy_of_unprofiled_spp={}, mesh_s_per_spp={},
               gen_rays_kernel_ms={})
    for name, s_spp, ((n_k, busy, wall, by_name),) in scene_runs(torch, dev, atlas, luts, 1):
        out["s_per_spp"][name] = round(s_spp, 5)
        out["kernels_per_spp"][name] = n_k
        out["busy_share"][name] = round(busy / wall, 4)
        # the profiler slows the host, not the device: the device's busy time
        # over the unprofiled spp's wall time
        out["busy_ms_per_spp"][name] = round(busy * 1e3, 3)
        out["busy_of_unprofiled_spp"][name] = round(busy / out["s_per_spp"][name], 4)
        out["bounce_ms_per_spp"][name] = round(_bounce_device_ms(by_name), 3)
        out["gen_rays_kernel_ms"][name] = round(
            sum(us for k, us in by_name.items() if "gen_rays" in k) / 1e3, 4)
    # the reference's own estimator, where the package has its options
    from digital_earth_tpu_torch.render.params import TraceConfig

    if "analytic_transmittance" in TraceConfig.__dataclass_fields__:
        out["reference_estimator_s_per_spp"] = {
            name: round(s_spp, 5) for name, s_spp, _ in
            scene_runs(torch, dev, atlas, luts, 0, TraceConfig(**REF_ESTIMATOR))}
    for shape, n_spp in (("(4, 1)", 1), ("(2, 2)", 2)):
        m = _mesh(torch, [dev] * 4, n_spp, atlas, luts, 0)
        m.accumulate()
        out["mesh_s_per_spp"][shape] = round(_spp_seconds(torch, m, 2), 5)
        del m
    r = _apollo(Renderer(dev, image_res=PREVIEW_RES, atlas=atlas, luts=luts, mode="preview"))
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.time()
        r.accumulate()
        r.fetch_image()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(round((time.time() - t0) * 1e3, 2))
    out["preview_frame_ms"] = times
    del r
    vs = ViewerRun(dev, atlas, luts, "path_bench")
    try:
        out["input_to_preview_ms"] = [round(t * 1e3, 1) for t in _input_latencies(vs, 5)]
    finally:
        vs.close()
    captured, states, deepest, _, _ = capture_inputs(torch, dev, atlas, luts)
    table = bounce_table(torch, states, states[0]["args"][3])
    out["per_bounce_ms"] = {b: round(row["ms"], 4) for b, row in table.items()}
    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.render import pathtracer as pt
    from digital_earth_tpu_torch.render import tracers

    out["bounce_registers"] = bounce_registers(kernels)
    # every entry's registers and spills (ptxas) of the sources that draw
    # from the threefry header
    out["ptxas"] = {src: ptxas_entries(kernels.ptxas_log.get(src, "")) for src in PTXAS_SOURCES
                    if src in kernels.ptxas_log}
    out["threefry"] = threefry_bench(torch, dev, kernels)
    # the tracker and march launchers on the path's arguments (per kind the
    # captured call with the most active lanes at bounces 0 and DEEP_BOUNCE)
    launchers = {"land_march": tracers.intersect_land, "rmo_delta_track": tracers.delta_track_rmo,
                 "cloud_track": tracers.track_cloud}
    out["launcher_ms"] = {}
    for (kind, b), (_, a, kw) in sorted(captured.items()):
        fn = launchers[kind.split("/")[0]]
        out["launcher_ms"][f"{kind}@{b}"] = round(_time_ms(torch, lambda: fn(*a, **kw), 5)[1], 4)
    del captured
    # bounce_flight and bounce_shade apart at bounces 0 and DEEP_BOUNCE, and
    # the window from the bounce its threshold picks
    out["flight_shade_ms"] = {}
    for b in (0, DEEP_BOUNCE):
        c = states[b]
        idx, st0, args = c["idx"], c["st"], c["args"]
        frame = pt.BounceFrame(st0, *args)
        ka = lambda st: pt._kernel_args(st, idx, b, *args, frame)  # noqa: E731
        flight = kernels.bounce_flight(*ka(_clone_state(st0)))
        out["flight_shade_ms"][b] = [
            round(_bounce_ms(torch, st0, lambda st: kernels.bounce_flight(*ka(st))), 4),
            round(_bounce_ms(torch, st0, lambda st: kernels.bounce_shade(*ka(st), flight=flight)), 4)]
    # per scene at bounces 0 and DEEP_BOUNCE: the lanes of bounce_flight +
    # bounce_shade not bit-equal to run_bounce_plain, the census's cycle
    # split (the sites, the flight's and the shade's shares, the warp
    # cycles) and the trackers' SIMT efficiency
    out["bounce_not_bit_equal"], out["cycle_split"], out["tracker_simt"] = {}, {}, {}
    for scene in (SCENE, *(os.path.join(ROOT, "scenes", s) for s in OTHER_SCENES)):
        name = os.path.basename(scene)[9:-4]
        sts = states if scene == SCENE else capture_states(
            torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE), scene=scene)[0]
        for b in (0, DEEP_BOUNCE):
            got, want, trips, cycles = _bounce_and_twin(torch, sts[b], b)
            out["bounce_not_bit_equal"][f"{name}@{b}"] = lanes_not_bit_equal(torch, got, want)
            sites, fl, sh, total = cycle_split(torch, cycles)
            out["cycle_split"][f"{name}@{b}"] = [round(x, 4) for x in sites] + [
                round(fl, 4), round(sh, 4), total]
            out["tracker_simt"][f"{name}@{b}"] = [
                None if e is None else round(e, 4) for e in tracker_simt(torch, trips)]
        del sts
    cfg = states[0]["args"][3]
    counts = [states[b]["idx"].numel() for b in sorted(states)] + [0]
    _, wb = pt.bounce_schedule(states[0]["st"].alive.numel(), counts,
                               kernels.window_threshold(dev), 0, cfg.max_bounces)
    c = states[wb]
    frame = pt.BounceFrame(c["st"], *c["args"])
    out["window_ms"] = [wb, round(_bounce_ms(torch, c["st"], lambda st: pt.run_window(
        st, c["idx"], wb, cfg.max_bounces, *c["args"], frame)), 4)]
    del c, frame
    # the reference estimator: rmo_ratio_track on Apollo bounce 0's NEE lanes
    # at four wavelengths (ratio tracking alone) and at one (all three
    # options), per call and on the device (a CUDA graph of 20 calls); the
    # estimator's bounce entries at bounces 0 and DEEP_BOUNCE on each scene:
    # lanes not bit-equal to the twin, the census's cycle split, the
    # trackers' SIMT and the NEE RMO site's tracking lanes per warp
    if "analytic_transmittance" in TraceConfig.__dataclass_fields__:
        out["ratio_track_ms"], out["estimator_cycle_split"] = {}, {}
        for label, cfg_r in (("L4", TraceConfig(analytic_transmittance=False)),
                             ("L1", TraceConfig(**REF_ESTIMATOR))):
            sts, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0,), cfg=cfg_r)
            keys, pos, d, t0, t1, ext, max_ext, active, cfg_a = capture_ratio_args(
                torch, sts[0], 0)
            kw = dict(max_steps=cfg_a.max_tracking_steps, k=cfg_a.tracking_k)
            call = lambda: kernels.rmo_ratio_track(  # noqa: E731
                keys, pos, d, t0, t1, ext, max_ext, active, **kw)
            out["ratio_track_ms"][label] = [round(_time_ms(torch, call, 5)[1], 4),
                                            round(_graph_ms(torch, call), 4)]
            # the same tracking lanes, c to a warp (the rest of each warp
            # inactive): the per-lane loop where a warp has threads to spare
            for c in SPARSE_PER_WARP:
                sparse = ratio_args_per_warp(torch, (keys, pos, d, t0, t1, ext, max_ext, active),
                                             c)
                out["ratio_track_ms"][f"{label} {c} a warp"] = round(_graph_ms(
                    torch, lambda: kernels.rmo_ratio_track(*sparse, **kw)), 4)
                del sparse
            del sts
        for key in ("not_bit_equal", "tracker_simt", "lanes_per_warp"):
            out[f"estimator_{key}"] = {}
        for scene in (SCENE, *(os.path.join(ROOT, "scenes", s) for s in OTHER_SCENES)):
            sts, _, _ = capture_states(torch, dev, atlas, luts, bounces=(0, DEEP_BOUNCE),
                                       scene=scene, cfg=TraceConfig(**REF_ESTIMATOR))
            for b in (0, DEEP_BOUNCE):
                at = f"{os.path.basename(scene)[9:-4]}@{b}"
                got, want, trips, cycles = _bounce_and_twin(torch, sts[b], b)
                sites, fl, sh, total = cycle_split(torch, cycles)
                out["estimator_cycle_split"][at] = [
                    round(x, 4) for x in sites] + [round(fl, 4), round(sh, 4), total]
                out["estimator_not_bit_equal"][at] = lanes_not_bit_equal(torch, got, want)
                out["estimator_tracker_simt"][at] = [
                    None if e is None else round(e, 4) for e in tracker_simt(torch, trips)]
                out["estimator_lanes_per_warp"][at] = lanes_per_warp(torch, trips)
            del sts
    # select_tiles on the device (a CUDA graph of 20 calls) on seeded
    # buffers: 1920x1080 (1,080 tiles) and 3840x2160 at 512-pixel tiles
    # (17,280 tiles)
    from digital_earth_tpu_torch.render import adaptive, raygen

    # film_postprocess on the device (a CUDA graph of 20 calls): OpenDRT,
    # scalar spp, on a seeded 1920x1080 buffer
    from digital_earth_tpu_torch.assets.luts import load_crf_pack
    from digital_earth_tpu_torch.render import film

    g = torch.Generator(device=dev).manual_seed(3)
    buf = torch.rand((*RES, 3), generator=g, device=dev) ** 4 * 40.0
    crf = load_crf_pack(dev).curves
    out["film_graph_ms"] = round(_graph_ms(
        torch, lambda: film.postprocess(buf, 3.0, 2.432, 1.001, crf, 12, "opendrt")), 5)
    del buf
    out["select_tiles_graph_ms"] = {}
    for (w, h), tp in ((RES, 2048), ((3840, 2160), 512)):
        g = torch.Generator(device=dev).manual_seed(11)
        count = torch.randint(1, 6, (w, h), generator=g, device=dev).float()
        color = torch.exp(torch.randn((w, h, 3), generator=g, device=dev)) * count[..., None]
        lum2 = color.sum(-1) ** 2 / count * (1 + torch.rand((w, h), generator=g, device=dev))
        block = raygen.pick_block_dims(w, h, tp)
        k = (w // block[0]) * (h // block[1]) // 4
        out["select_tiles_graph_ms"][f"{w}x{h}/{tp}"] = round(
            _graph_ms(torch, lambda: adaptive.select_tiles(color, count, lum2, block, k)), 5)
        del color, count, lum2

    out["compact_lanes_ms"] = {}
    cases = [(b, states[b]["st"].alive, states[b]["st"].work_class) for b in (0, DEEP_BOUNCE)]
    for b, alive, wc in cases + [(deepest["bounce"], deepest["alive"], deepest["work_class"])]:
        _, t = _compact_times(torch, kernels.compact_lanes, alive, wc)
        out["compact_lanes_ms"][b] = {k: None if v is None else round(v, 5) for k, v in t.items()}
    del states, deepest, table
    # gen_rays on the path frame's 1080p inputs: per call from the host, back
    # to back; on the device from a CUDA graph where the package's wrapper
    # reads nothing back from the card (the kernel's profiled time, above,
    # in either case)
    from digital_earth_tpu_torch.render import raygen

    r = _apollo(Renderer(dev, image_res=RES, atlas=atlas, luts=luts))
    args = (r._seed_key, 0, 0, RES[0] * RES[1], RES, (1, RES[1]), r.camera_params(), luts, False)
    _, ms = _time_ms(torch, lambda: raygen.gen_rays(*args), 20)
    out["gen_rays_ms_per_call"] = round(ms, 5)
    out["gen_rays_graph_ms"] = (round(_graph_ms(torch, lambda: raygen.gen_rays(*args)), 5)
                                if "pid" in raygen.Rays._fields else None)
    del r, args
    # the tier-2 atlas: the build's split, each plane's upsample and the
    # expand+reshape copy of its plain repeat
    from digital_earth_tpu_torch.ops import texture as tx

    atlas2, calls, split = build_tier2_atlas(torch, dev)
    out["tier2_build"] = {k: [round(x, 4) for x in v] if isinstance(v, list) else round(v, 4)
                          for k, v in split.items()}
    out["upsample_ms"], out["upsample_copy_ms"] = {}, {}
    for name, (base, a, kw) in zip(type(atlas2)._fields, calls):
        h, w, c = base.shape
        f = a[0]
        _, ms = _time_ms(torch, lambda: tx.upsample(base, *a, **kw), 5)
        _, lib = _time_ms(torch, lambda: base[:, None, :, None].expand(h, f, w, f, c).reshape(
            h * f, w * f, c), 5)
        out["upsample_ms"][name], out["upsample_copy_ms"][name] = round(ms, 4), round(lib, 4)
    del atlas2, calls
    print(json.dumps({"path_bench": out}))


def main():
    args = sys.argv[1:]
    mesh_only = args == ["--mesh-only"]
    estimator_only = args == ["--estimator-only"]
    floors_only = args == ["--floors-only"]
    widths_only = args == ["--widths-only"]
    naive_only = args == ["--naive-only"]
    bench = args[:1] == ["--preview-bench"] and len(args) <= 2
    pbench = args[:1] == ["--path-bench"] and len(args) <= 2
    sbench = args[:1] == ["--spp-bench"] and len(args) <= 2
    obench = args[:1] == ["--options-bench"]
    scount = args[:1] == ["--sass-counts"] and len(args) <= 2
    wbench = args[:1] == ["--widths-bench"] and len(args) <= 2
    nbench = args[:1] == ["--naive-bench"] and (len(args) <= 2 or args[2:] == ["march"])
    tbench = args[:1] == ["--tap-bench"] and len(args) <= 2
    if args and not (mesh_only or estimator_only or floors_only or widths_only or naive_only
                     or bench or pbench or sbench or obench or scount or wbench or nbench
                     or tbench):
        fail(f"unknown arguments {args} (the options are --mesh-only, --estimator-only, "
             "--floors-only, --widths-only, --naive-only, "
             "--preview-bench [DIR], --path-bench [DIR], --spp-bench [DIR], --options-bench "
             "[DIR [SETTING ...]], --sass-counts [DIR], --widths-bench [DIR], --naive-bench "
             "[DIR] and --tap-bench [DIR])")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "digital_earth_tpu_torch")):
        fail("run from a checkout: digital_earth_tpu_torch/ is missing beside chip_smoke.py")
    sys.path.insert(0, os.path.abspath(args[1]) if (bench or pbench or sbench or obench or scount
                                                    or wbench or nbench or tbench)
                    and len(args) >= 2 else ROOT)
    dev = torch.device("cuda:0")
    if bench:
        preview_bench(torch, dev)
        return
    if sbench:
        spp_bench(torch, dev)
        return
    if pbench:
        path_bench(torch, dev)
        return
    if obench:
        options_bench(torch, dev, tuple(args[2:]))
        return
    if scount:
        sass_counts()
        return
    if wbench:
        widths_bench(torch, dev)
        return
    if nbench:
        naive_bench(torch, dev, args[2:] == ["march"])
        return
    if tbench:
        tap_bench(torch, dev)
        return

    from digital_earth_tpu_torch import kernels
    from digital_earth_tpu_torch.app.config_io import load_config
    from digital_earth_tpu_torch.app.viewer import render_offline
    from digital_earth_tpu_torch.assets.luts import load_spectral_luts
    from digital_earth_tpu_torch.assets.textures import procedural_texture_atlas

    toolchain(torch)

    t0 = time.time()
    kernels.library()
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")
    for src in ("bounce.cu", "bounce_l1.cu", "bounce_ratio.cu", "bounce_l1_ratio.cu",
                "rmo_ratio_track.cu", "compact_lanes.cu", "preview.cu", "atmos_march.cu",
                "select_tiles.cu"):
        for line in kernels.ptxas_log.get(src, "").splitlines():
            # each entry's registers and spills (not those of its device calls)
            if "registers" in line or "Compiling entry" in line or (
                    "spill" in line and not line.strip().startswith("0 bytes stack")):
                print(f"ptxas {src}: {line.strip()}")

    tf = check_threefry(torch, dev)["tf"]

    t0 = time.time()
    atlas = procedural_texture_atlas(dev, (1024, 2048), seed=7,
                                     cache_dir=os.path.join(ROOT, "build", "chip_smoke", "texture_cache"))
    print(f"procedural 1024x2048 atlas: {time.time() - t0:.1f} s")
    luts = load_spectral_luts(dev)
    if naive_only:
        # phase 8d alone
        rows = check_naive(torch, dev, atlas, luts, tf)
        print(json.dumps({"kernels": [dict(name=name, max_abs_err=row["max_abs_err"], ms=row["ms"],
                                           plain_ms=row["plain_ms"],
                                           bound_ms=bound(row["bytes"], row["ops"], row.get("sfu"),
                                                          row.get("int_ops", 0),
                                                          row.get("fma_ops", 0))[0])
                                      for name, row in rows.items()]}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if widths_only:
        # phase 8g alone
        rows = check_widths(torch, dev, atlas, luts, tf)
        print(json.dumps({"kernels": [dict(name=name, launches=row.get("launches"),
                                           max_abs_err=row["max_abs_err"], ms=row["ms"],
                                           plain_ms=row["plain_ms"],
                                           bound_ms=bound(row["bytes"], row["ops"],
                                                          int_ops=row.get("int_ops", 0),
                                                          fma_ops=row.get("fma_ops", 0))[0])
                                      for name, row in rows.items()]}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if mesh_only:
        # phase 19 alone, e.g. on a machine with several cards
        check_mesh(torch, dev, atlas, luts)
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    captured, states, deepest, lookups, frame_end_whole = capture_inputs(torch, dev, atlas, luts)
    if estimator_only:
        # phase 8e alone, on phase 4's capture
        del states, deepest, lookups, frame_end_whole
        rows = check_estimator_knobs(torch, dev, atlas, luts, captured, tf)
        print(json.dumps({"kernels": rows}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if floors_only:
        # phase 8f alone, on phase 4's capture
        del states, deepest, lookups, frame_end_whole
        check_march_floors(torch, dev, atlas, luts, captured, tf)
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    check_golden(torch, dev)

    check_preview_golden(torch, dev)

    # --- the main path ---------------------------------------------------
    from digital_earth_tpu_torch.app.viewer import encode_png
    from digital_earth_tpu_torch.render import raygen

    w, h = RES
    # the pixel map comes from gen_rays: count any recomputation of it
    remapped, tile_map = [], raygen.tile_pixel_coords
    raygen.tile_pixel_coords = lambda *a, **k: remapped.append(1) or tile_map(*a, **k)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        r = render_offline(load_config(SCENE), dev, spp=1, image_res=RES,
                           out_path=None, atlas=atlas, luts=luts)
        torch.cuda.synchronize()
        warmup_s = time.time() - t0
        t0 = time.time()
        for _ in range(2):
            r.accumulate()
        torch.cuda.synchronize()
        dt = (time.time() - t0) / 2
        img = r.fetch_image()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        raygen.tile_pixel_coords = tile_map
    print(f"main path: the pixel map recomputed {len(remapped)} times (it comes from gen_rays)")
    if remapped:
        fail("trace_lanes recomputed the pixel map on the main path")
    buf = r.color_buffer
    print(f"render_offline Apollo 11 {w}x{h}, default TraceConfig, 3 spp: "
          f"warm-up {warmup_s:.2f} s, {dt:.3f} s/spp, {w * h / dt:.1f} paths/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_main_path(torch, counts, r, img, "main path")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "apollo11_1080p_3spp.png"), "wb") as f:
        f.write(encode_png(r.fetch_image_np()))

    rows = compare_kernels(torch, captured, tf)
    bad = [name for name, row in rows.items() if not row["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    rows.update(check_bounce(torch, states))
    census = check_census(torch, states)
    cfg = states[0]["args"][3]
    for name, part in (("bounce_flight", "flight"), ("bounce_shade", "shade")):
        other, alu, fma = bounce_ops(torch, census[0], cfg.march_k, cfg.tracking_k, tf, part)
        rows[name].update(ops=other + alu + fma, int_ops=alu, fma_ops=fma)
    table = bounce_table(torch, states, cfg, tf)
    check_scenes(torch, dev, atlas, luts)
    rows["bounce_window"], _, schedule, _ = check_window(torch, states, table)
    check_draine(torch, states)
    rows["compact_lanes"] = check_compact(torch, states, deepest)
    check_density(torch, lookups)
    march_k = states[0]["args"][3].march_k
    trips0 = census[0].to(torch.float64)
    probes = int(sum(float(site_probes(torch, trips0[:, site], march_k).sum())
                     for site in MARCH_SITES))
    check_texture(torch, lookups, atlas, probes, frame_end_whole)
    del states, deepest, lookups, census, table
    check_window_spp(torch, dev, atlas, luts, schedule)
    rows["rmo_ratio_track"], _ = check_reference_estimator(torch, dev, atlas, luts, tf)
    option_rows, option_counts, option_preview = check_options(torch, dev, atlas, luts,
                                                               captured, tf)
    missing = {f"{k}/options" for k in ("land_march", "cloud_track", "bounce_flight",
                                        "bounce_shade", "bounce_window", "preview")}
    missing -= set(option_rows)
    if missing:
        fail(f"the options phase measured no row for {sorted(missing)}")
    rows.update(option_rows)
    rows.update(check_naive(torch, dev, atlas, luts, tf))
    rows.update(check_estimator_knobs(torch, dev, atlas, luts, captured, tf))
    check_march_floors(torch, dev, atlas, luts, captured, tf)
    del captured
    width_rows = check_widths(torch, dev, atlas, luts, tf)
    rows.update(width_rows)

    # --- the viewer's path -------------------------------------------------
    rows["gen_rays"] = check_gen_rays(torch, dev, atlas, luts, tf)
    rows["film_postprocess"] = check_film(torch, buf, r.crf.curves)
    del r, buf, img
    preview_counts, preview_rows, frame_end_preview = preview_frame(torch, dev, atlas, luts)
    rows.update(preview_rows)
    check_chunked(torch, dev, atlas, luts)
    check_viewer(torch, dev, atlas, luts)

    # --- adaptive tile sampling ------------------------------------------
    adaptive_counts, frame_end_tiles, tile_rays, warm_bufs, after4, (block, k) = check_adaptive(
        torch, dev, atlas, luts)
    _, err, _, _, _ = _hold_rays(torch, f"frac={ADAPTIVE_FRAC} tile list of {tile_rays[-1].numel()} "
                                 f"tiles, round {tile_rays[1]}, {RES[0]}x{RES[1]}", tile_rays)
    rows["gen_rays"]["max_abs_err"] = max(rows["gen_rays"]["max_abs_err"], err)
    del tile_rays
    rows["frame_end"] = check_frame_end(torch, frame_end_whole, f"whole {RES[0]}x{RES[1]} frame")
    del frame_end_whole
    for kept, label in ((frame_end_tiles, f"frac={ADAPTIVE_FRAC} tile list"),
                        (frame_end_preview, f"preview {PREVIEW_RES[0]}x{PREVIEW_RES[1]}")):
        row = check_frame_end(torch, kept, label)
        rows["frame_end"]["max_abs_err"] = max(rows["frame_end"]["max_abs_err"], row["max_abs_err"])
    del frame_end_tiles, frame_end_preview
    check_select_tiles(torch, warm_bufs, block, k, "after 2 warm-up passes")
    rows["select_tiles"] = check_select_tiles(torch, after4, block, k, "after 4 adaptive passes")
    del warm_bufs, after4
    check_select_tiles_past_cap(torch, dev)
    check_adaptive_viewer(torch, dev, atlas, luts)

    # --- multi-device rendering ---------------------------------------------
    mesh_counts, rows["select_tiles_shard"] = check_mesh(torch, dev, atlas, luts)

    # --- the tier-2 texture path -------------------------------------------
    atlas2, rows["upsample"], tier2_counts = check_tier2(torch, dev, luts, dt)

    # --- kernels per spp (last: a profiler session can slow later launches)
    runs = [(SCENE, atlas, ""), (SCENE, atlas2, " tier-2 atlas")]
    runs += [(os.path.join(ROOT, "scenes", s), atlas, "") for s in OTHER_SCENES]
    for scene, run_atlas, suffix in runs:
        label = f"{os.path.basename(scene)[9:-4]} {w}x{h}{suffix}"
        r = render_offline(load_config(scene), dev, spp=1, image_res=RES, out_path=None,
                           atlas=run_atlas, luts=luts)
        torch.cuda.synchronize()
        t0 = time.time()
        r.accumulate()
        torch.cuda.synchronize()
        t_spp = time.time() - t0
        print(f"render_offline {label}, default TraceConfig: {t_spp:.3f} s/spp "
              f"(1 warm-up spp, then 1 timed)")
        n_kernels, busy, _, by_name = profile_spp(torch, r, label)
        bounce_us = sum(us for name, us in by_name.items() if "bounce" in name)
        print(f"profile {label}: bounce {bounce_us / 1e3:.2f} ms of {busy * 1e3:.2f} ms "
              f"device-busy per spp ({busy / t_spp:.3f} of the unprofiled spp's wall time)")
        if not 0 < n_kernels <= MAX_KERNELS_PER_SPP:
            fail(f"{n_kernels} device kernels per {label} spp (expected 1-{MAX_KERNELS_PER_SPP})")
        del r
    del atlas2
    # the (4, 1) mesh of phase 19: its bounce loop runs once per shard
    label = f"Apollo 11 {w}x{h}, (4, 1) mesh over [cuda:0] x 4"
    m = _mesh(torch, [dev] * 4, 1, atlas, luts, 0)
    m.accumulate()
    print(f"{label}: {_spp_seconds(torch, m, 1):.3f} s/spp (1 warm-up spp, then 1 timed)")
    n_kernels, busy, _, by_name = profile_spp(torch, m, label)
    bounce_us = sum(us for name, us in by_name.items() if "bounce" in name)
    print(f"profile {label}: bounce {bounce_us / 1e3:.2f} ms of {busy * 1e3:.2f} ms "
          f"device-busy per spp")
    if not 0 < n_kernels <= 4 * MAX_KERNELS_PER_SPP:
        fail(f"{n_kernels} device kernels per {label} spp (expected 1-{4 * MAX_KERNELS_PER_SPP})")
    del m
    profile_preview(torch, dev, atlas, luts)

    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "digital_earth_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded}")

    sources = {
        "land_march": ("cuda", "digital_earth_tpu_torch/csrc/land_march.cu",
                       "digital_earth_tpu/render/pathtracer.py:211"),
        "rmo_delta_track": ("cuda", "digital_earth_tpu_torch/csrc/rmo_delta_track.cu",
                            "digital_earth_tpu/render/pathtracer.py:631"),
        "rmo_ratio_track": ("cuda", "digital_earth_tpu_torch/csrc/rmo_ratio_track.cu",
                            "digital_earth_tpu/render/pathtracer.py:814"),
        "cloud_track": ("cuda", "digital_earth_tpu_torch/csrc/cloud_track.cu",
                        "digital_earth_tpu/render/pathtracer.py:906"),
        "naive_march": ("cuda", "digital_earth_tpu_torch/csrc/naive_march.cu",
                        "digital_earth_tpu/render/tracking_naive.py:31"),
        "naive_delta_track": ("cuda", "digital_earth_tpu_torch/csrc/naive_track.cu",
                              "digital_earth_tpu/render/tracking_naive.py:72"),
        "naive_ratio_track": ("cuda", "digital_earth_tpu_torch/csrc/naive_track.cu",
                              "digital_earth_tpu/render/tracking_naive.py:126"),
        "flight_analytic": ("cuda", "digital_earth_tpu_torch/csrc/flight_analytic.cu",
                            "digital_earth_tpu/models/atmosphere_lut.py:357"),
        "fast_uniform_check": ("cuda", "digital_earth_tpu_torch/csrc/fast_uniform_check.cu",
                               "digital_earth_tpu/ops/rng.py:66"),
        "gen_rays": ("cuda", "digital_earth_tpu_torch/csrc/gen_rays.cu",
                     "digital_earth_tpu/render/renderer.py:160"),
        "atmos_march": ("cuda", "digital_earth_tpu_torch/csrc/atmos_march.cu",
                        "digital_earth_tpu/render/raymarcher.py:56"),
        "film_postprocess": ("cuda", "digital_earth_tpu_torch/csrc/film_postprocess.cu",
                             "digital_earth_tpu/render/film.py:438"),
        "frame_end": ("cuda", "digital_earth_tpu_torch/csrc/frame_end.cu",
                      "digital_earth_tpu/render/pathtracer.py:2000"),
        "select_tiles": ("cuda", "digital_earth_tpu_torch/csrc/select_tiles.cu",
                         "digital_earth_tpu/render/renderer.py:425"),
        "select_tiles_shard": ("cuda", "digital_earth_tpu_torch/csrc/select_tiles.cu",
                               "digital_earth_tpu/parallel/mesh.py:156"),
        "bounce_flight": ("cuda", "digital_earth_tpu_torch/csrc/bounce.cu",
                          "digital_earth_tpu/render/pathtracer.py:1554"),
        "bounce_shade": ("cuda", "digital_earth_tpu_torch/csrc/bounce.cu",
                         "digital_earth_tpu/render/pathtracer.py:1554"),
        "bounce_window": ("cuda", "digital_earth_tpu_torch/csrc/bounce.cu",
                          "digital_earth_tpu/render/pathtracer.py:1554"),
        "compact_lanes": ("cuda", "digital_earth_tpu_torch/csrc/compact_lanes.cu",
                          "digital_earth_tpu/render/renderer.py:84"),
        "upsample": ("cuda", "digital_earth_tpu_torch/csrc/upsample.cu",
                     "digital_earth_tpu/ops/texture.py:74"),
        "preview": ("cuda", "digital_earth_tpu_torch/csrc/preview.cu",
                    "digital_earth_tpu/render/raymarcher.py:91"),
    }
    # the options instances (TraceConfig's scene and march options read at
    # run time), each beside its default instance: the bounce entries' set
    # of L = 4 and the closed form in its own source
    for name in ("land_march", "cloud_track", "preview"):
        sources[f"{name}/options"] = sources[name]
    for name in ("bounce_flight", "bounce_shade", "bounce_window"):
        sources[f"{name}/options"] = ("cuda", "digital_earth_tpu_torch/csrc/bounce_opts.cu",
                                      sources[name][2])
    # the width libraries' instances (phase 8g): the bounce entries' default
    # instances of csrc/width/, the other kernels' sources built at the width
    for key in width_rows:
        name = key.split("/")[0]
        src = ("digital_earth_tpu_torch/csrc/width/bounce_default.cu" if name.startswith("bounce")
               else sources[name][1])
        sources[key] = ("cuda", src, sources[name][2])
    # launches: the main path's run (0 for the trackers, whose loops run
    # inside bounce there, and for atmos_march, whose loop runs inside
    # preview), or for preview the preview frame's run, for select_tiles the
    # adaptive run's, for select_tiles_shard the mesh run's, for upsample the
    # tier-2 run's (its atlas and render)
    # the options instances' from the path with the five on florida (the
    # preview's from its frame at bilinear_tracking)
    launches = dict(counts, preview=preview_counts["preview"],
                    select_tiles=adaptive_counts["select_tiles"],
                    select_tiles_shard=mesh_counts["select_tiles_shard"],
                    upsample=tier2_counts["upsample"],
                    **{f"{k}/options": option_counts[f"{k}/options"] for k in
                       ("land_march", "cloud_track", "bounce_flight", "bounce_shade",
                        "bounce_window")},
                    **{"preview/options": option_preview["preview/options"]})
    entries = []
    for name, (route, src, rep) in sources.items():
        row = rows[name]
        bound_ms, bound_by = bound(row["bytes"], row["ops"], row.get("sfu"), row.get("int_ops", 0),
                                   row.get("fma_ops", 0))
        # one PyTorch call computes compact_lanes's order (a stable
        # argsort) and upsample's repeat (expand + reshape; without the
        # jitter on two of the four planes), none the others' functions
        entries.append({"name": name, "route": route, "source": src, "replaces": rep,
                        "launches": launches[name] if name in launches else row["launches"],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row.get("plain_ms"), "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": row.get("library_ms")})
    line = {"kernels": entries}
    print(json.dumps(line))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
