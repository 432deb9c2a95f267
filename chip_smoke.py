#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``volumerenderingproject_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA GPU
    python3 chip_smoke.py --parent DIR   # and time K4, K8, K9 of another checkout

``--parent`` names the root of another checkout of this repository (the
parent commit unpacked with ``git archive``): its smooth kernels and K4 are
built from its own ``csrc/`` and timed in turns with this tree's (phases
3b, 3g-3h, 3j, 3k and 3r: K4 plain, LUT, baked and LUT + baked, the K5
fold at 320^3 and 512^3, K4's segment and slab units, K8, K9).

Phases, each of which exits non-zero on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from ``csrc/`` (nvcc, in parallel);
  3. the forward march kernel (K1) against its plain PyTorch version on
     the card: on edge inputs at small shapes (TF(0).alpha = -3e-5
     among them), then at the main path's shapes (700x700 pixels, 500
     samples per ray) on two volumes: ``centered_sphere(100)`` and a
     seeded 182x218x182 volume (MNI152-1mm dims) of nested ellipsoid
     shells plus noise, so every interval of the default transfer
     function occurs; rays within 1e-7 of parallel to each face of the
     box, whose samples K1's clip lost before it took the pad;
  3b. the backward march kernel (K4) against its plain PyTorch version on
     the same edge inputs, on an interval of alpha exactly 1, on
     TF(0).alpha = -3e-5, 0.05 and 1, on 16 intervals, on a static
     density_scale, on rays that miss the box, a step longer than a voxel,
     the rays nearly parallel to a face, the sample windows of a (1, 4, 1)
     split and the first and the last slab of (1, 1, 2) under rays along
     x, and at 700x700x500 on both volumes (ortho and conic), with one
     seeded cotangent per case; the error is max |dK4 - dplain| / max
     |dplain|; K4's spans (``march_vjp.sample_range``) checked against
     the chain on the card (no sample with a voxel outside the chain's
     span, no owned sample outside the visited ones, every constant
     sample owned and off the volume) and, per volume, the samples in the
     chain's span against those that touch the volume;
  4. the render path: 8 orbit frames per volume through ``render()`` (the
     bench.py orbit, radius 1.5, early_termination=1e-3), with the kernels'
     launch counts set to 0 just before and read just after;
  5. the CLI: ``python -m volumerenderingproject_tpu_torch render ...``
     in a process of its own must write a valid 700x700 PNG;
  5b. the CLI's ``fit ...`` against that PNG must write a TF file that
     parses (this and the CLI's other phases but 5 and 5j, whose command
     spawns its ranks, run ``cli.main`` in this process, while 5 and 5j
     run in threads; 5's PNG must equal the same render's from
     ``cli.main`` byte for byte);
  6. the kernel's render of a small input against the back-to-front
     reference scan;
  7. the fit path: on each volume, 5 ``fit_transfer_function`` steps at
     700x700x500 (lr 1e-2) from the default TF with its colours 1..3
     perturbed by a seeded +-0.2, against the render of the default TF from
     an orbit camera, with the launch counts of both kernels set to 0 just
     before and read just after; the same steps once more under
     torch.profiler for the device's busy time and idle share; 5 steps at
     lr 3e-6, where the loss must fall at every step; the gradient at the
     start against a central difference of the loss; then 2 steps through
     the kernels against the same 2 steps through their plain versions.

The a5 (Algorithm.TEST) slice, at bench.py's ``a5_500`` shapes (500x500
pixels, 500 samples per ray), has phases of its own, each with its own seeds:

  3c. the a5 march kernel (K3) against its plain version: on edge inputs
     (odd dims with negatives and cal_max 200.9, the z-wrap and y-wrap
     scenes, a z > 127 volume, TF(0).alpha 0.05 and -3e-5, a
     single-interval table, eps 1e-3), then on both volumes with an orbit
     camera at eps 0 and at eps 1e-3 (also against the exact render) and
     with the preset camera; its time on the render path's inputs, the
     samples they need and the bound;
  3d. the a5 backward kernel (K6) against its plain version on the same
     edges, an interval of alpha 1 and 16 intervals, and on both volumes;
  4b. 8 orbit frames per volume through ``render()`` with Algorithm.TEST
     (eps 1e-3), K3's launch count set to 0 just before and read just after;
  5c, 5d. the CLI ``render`` and ``fit`` with ``--algorithm test``;
  6b. a small a5 render against the a5 back-to-front reference scan;
  7b. phase 7 on the a5 route (K3 and K6).

The lit and LUT slice, at bench.py's ``sobel_lit_700`` (700x700 pixels, 250
samples per ray, ``lighting=True``, ``gradient_filter="sobel"``) and
``lut_phong_300`` (300x300x300, ``tf_lut=256``, ``lighting=True``) rows and
the a5 mode of the latter (300x300x300, ``Algorithm.TEST``,
``lighting=True``), has phases of its own, each with its own seeds:

  3e. K1's LUT, baked-light and LUT + baked-light variants against
     ``march_plain``, which must be bit-exact (max abs err 0) at eps 0: on
     edge inputs (tf_lut 2, 96, 256, 1024, a LUT grid point on an interval
     bound, TF(0).alpha -3e-5, rays that miss the box, sobel + presmooth,
     front clip with density_scale), then on both volumes at
     ``sobel_lit_700``, ``lut_phong_300`` and ``lut_phong_300`` unlit, at
     eps 0 and at eps 1e-3 (against the exact render); each variant's
     time, the bake's, the plain version's and the bound;
  3f. K3's baked-light variant against ``march_a5_plain`` on the a5 edge
     inputs, lit, and on both volumes at the a5 lit 300x300x300 config with
     central and sobel gradients;
  4c. 8 orbit frames per volume and config after one warm-up through
     ``render()``, with each variant's launch count set to 0 just before
     and read just after;
  5e. the CLI ``render --lighting --gradient-filter sobel`` and ``render
     --config <json with tf_lut 256> --lighting``, a1 and ``--algorithm
     test``, each of which must write a valid PNG;
  6c. a small lit a1 render and a small lit a5 render against their
     back-to-front reference scans.

Smooth mode (``Interp.TRILINEAR``: trilinear intensities through the
sigmoid-product TF) at the a1 main path's shapes (700x700 pixels, 500
samples per ray, sharpness 200), on both volumes, has phases of its own,
each with its own seeds:

  3g. the smooth march kernel (K8) against ``march_smooth_plain`` at eps 0,
     to 2e-6 (bit-exact expected): on edge inputs (9x11x10 with negative
     voxels and cal_max 200.9, 61x37 pixels, K = 2, 4 and 16, sharpness
     40, 200 and 1000, ortho, conic and conic uncorrected, rays grazing the
     entry faces, alpha exactly 1, a front clip, eps 1e-3, a camera inside
     the volume, a view whose rays all miss the box, a sample step longer
     than a voxel), then ortho and conic on both volumes, and at eps 1e-3
     against the exact render; its time on the orbit's inputs, the plain
     version's and the bound;
  3h. the smooth backward kernel (K9) with the volume gradient against
     ``march_smooth_bwd_plain`` + ``splat_volume_grad_plain`` on the same
     edges and on both volumes (dcolors, dlower, dupper, dvolume, each
     within 5e-3 of max |dplain|); K9's time with and without the splat;
     per volume, the samples in the kernels' per-ray ranges
     (``smooth.sample_range``) against those with a corner in the volume;
     with ``--parent``, K8 and K9 of both trees in turns (parent, this
     tree, this tree, parent); central differences of the loss in three
     TF bounds and three voxels at 700x700x500 on the MNI-dims volume,
     within 1e-2;
  4d. 8 orbit frames per volume after one warm-up through ``render()``
     (eps 1e-3), K8's launches counted;
  5f. the CLI ``render --interp trilinear`` and ``fit --interp trilinear
     --fit-bounds``;
  6d. a small smooth render against the back-to-front reference scan;
  7c. phase 7 on the smooth route with ``fit_bounds=True`` (the bounds
     start moved by the JAX bound-recovery test's offsets), K8 and K9;
  7d. the JAX package's bound-recovery case (tests/test_fit_params.py:
     181-201: sharpness 40, 80 steps at lr 5e-3) through the kernels: the
     last loss below 0.35 of the first, the bound error falling;
  7e. a volume-gradient step (forward and backward with ``volume.data``
     requiring grad) at 700x700x500 on the MNI-dims volume, 5 times.

The fault repair and the lit, LUT and light fits (K4's baked-light, LUT
and LUT + baked-light variants, light gradients through tangent marches of
K1 baked), on both volumes, with their own seeds:

  3i. a TF with the alphas of intervals 1-3 at 1.2, which drives T below
     0: K1 (plain at 700x700x500; LUT, baked and LUT + baked at the lit
     configs), K3 (500x500x500) and K8 (smooth 700x700x500) bit-exact to
     their plain versions at eps 0; small renders of each through
     ``render()`` within 2e-5 of the plain scan, which composites on;
  3j. K4's baked, LUT and LUT + baked variants against
     ``march_bwd_plain`` (within 5e-3 of max |dplain|) on edge inputs (K
     = 2, 4, 16; an interval of alpha 1; TF(0).alpha 0.05 and 1; a front
     clip; LUT sizes 64, 256, 1024; rays that miss the box; a step longer
     than a voxel) and at full size: baked at
     ``sobel_lit_700``, LUT at 700x700x500 ``tf_lut=256``, LUT + baked at
     ``lut_phong_300``; each variant's time, the plain version's and the
     bound;
  5g. the CLI ``fit --lighting``, ``fit --config <json with tf_lut 256>``
     and ``fit --fit-light``;
  7f. 5 ``fit_transfer_function`` steps after one warm-up at each K4
     variant's config, with the launches of each K1 and K4 variant set to
     0 just before and read just after, the same steps under
     torch.profiler, and 2 steps through the kernels against 2 through
     the plain versions;
  7g. the same for a light fit (``light=``, from ambient 0.7 and diffuse
     0.2) at ``sobel_lit_700``: K4 baked and 12 launches of K1 baked a
     step;
  7h. the light gradient through the kernels against the plain versions
     (10 components within 1e-4 of the largest, the three colour
     components equal within 1e-6) and central differences of the loss in
     ambient and direction[0] (within 1e-2);
  7i. the JAX package's light-recovery case (tests/test_fit_params.py:
     158-178: 150 steps at lr 2e-2) through the kernels: the last loss
     below 0.2 of the first, the ambient error halved.

Single scattering and volumes beyond the TPU's resident budget (the JAX
package's streamed kernels K2, K5 and K7, which the port folds into K1, K4
and K6: on the card the volume stays in device memory), with their own
seeds:

  3k. bench.py's dense sphere (bench.py:214-219) at 320^3 and, by the same
     formula, 512^3, at its streamed rows' shapes (304x304 pixels, 300
     samples): K1 plain and baked, K3 unlit and baked (bit-exact to their
     plain versions at eps 0; eps 1e-3 within TOL_EPS), K4 plain and baked
     and K6 (within TOL_GRAD of max |dplain|; K4 plain also at
     TF(0).alpha 1, K4's spans checked), K8 (TOL_SMOOTH) and K9
     (TOL_GRAD) with their samples in range; each kernel's time, its plain
     version's (the smooth pair's at 320^3 only), its bound and the peak
     memory of prep and kernel;
  3l. scattered renders (strength 1.5) on the MNI-dims and dense 320^3
     volumes: a1 with non-zero HG g, a1 lit, a1 LUT 64 and a5, through K1
     and K3 baked, bit-exact to their plain versions at eps 0; the kernel,
     the scatter bake and the frame timed; the transmittance sweep and the
     scatter bake at 512^3;
  4e. 8 orbit frames through ``render()`` for streamed_320,
     streamed_lit_320 and streamed_a5_320 and their 512^3 twins, launches
     by variant set to 0 just before and read just after, peak memory;
  4f. 8 scattered orbit frames through ``render()`` on the MNI-dims volume
     (a1 700x700x500, ``sobel_lit_700``, a5 500x500x500), K1 or K3 baked
     launched once a frame;
  5h. the CLI ``render --scattering`` (a1 and a5) and ``fit --scattering``,
     started with the other CLI chains;
  6e. small scattered renders (a1 with HG g, lit, LUT 64; a5) against the
     plain scan within TOL_EXACT;
  7j. 5 colour-fit steps after a warm-up (a1, lit a1, a5) at 320^3 and
     512^3: ms/step, launches, device busy ms and idle share under
     torch.profiler, peak memory;
  7k. 5 scattered fit steps at ``sobel_lit_700`` on both volumes: K1 baked
     launched 1 + K + 1 times a step (the render, one tangent march per
     interval, the S -> 0 base) and K4 baked once; one step under
     torch.profiler; 5 steps at lr 3e-6 that must descend; the alpha
     gradient through T_light, kernels against plain, within TOL_LIGHT of
     its largest component; a central difference along the gradient within
     TOL_FD.

4-D multichannel volumes (K1's and K4's channel-grid variants) and K1's
in-kernel lighting (conic rays, any light colour), with their own seeds:

  3m. K1 mc against ``march_plain``, bit-exact at eps 0, at bench.py's
     ``multichannel_304`` shapes (304x304 pixels, 300 samples) on its
     3-channel 91^3 volume (bench.py:244-250), a seeded 3-channel volume
     at MNI-dims (182x218x182x3 f32) and seeded 2- and 4-channel volumes
     at cal_max 200.9: ortho, conic and density_scale 1.7; eps 1e-3 within
     TOL_EPS of the exact render; K1 mc's time, the plain version's, the
     prep's, the bound and the peak memory;
  3n. K4 mc against ``march_bwd_plain`` on the same volumes: the rgb
     columns exactly 0, the alpha column within TOL_GRAD of max |dplain|;
     on the 3-channel volumes at 61x37x37 also TF(0).alpha 1 and 0.05,
     rays that miss the box and a step longer than a voxel, and K4's spans
     checked; its time, the plain version's and the bound;
  3o. K1's in-kernel lighting (``lit``, and ``lut_lit`` with a LUT)
     against ``march_plain``, bit-exact at eps 0: on edge inputs (dense
     voxels on every face, a conic camera inside the volume, LUT 96, the
     light colour (1.0, 0.8, 0.6)), then conic at 700x700x500 (central
     filter, presmooth 0) on both volumes with the interval TF and
     ``tf_lut=256``, and ortho under the colour (1.0, 0.8, 0.6); times,
     bounds, peak memory;
  4g. 8 orbit frames after a warm-up through ``render()``:
     ``multichannel_304`` on both 3-channel volumes, conic lit a1 at
     700x700x500 (eps 1e-3) on both volumes, interval TF and LUT 256;
     launches by variant, ms/frame, rays/s, peak memory;
  5i. the CLI ``render`` and ``fit`` on a 4-D .nii written with numpy, and
     ``render --conic --lighting``, started with the other CLI chains;
  6f. a small 4-D render and a small conic lit render against the
     back-to-front reference scan;
  7l. phase 7 on the 4-D alpha-column fit at ``multichannel_304`` on both
     3-channel volumes (the start scales the alphas of intervals 1..3 by
     MC_FIT_ALPHA_SCALE): 1 K1 mc and 1 K4 mc a step, no other variant.

Sharded renders (``parallel/render_dist.py`` on ``torch.distributed``: the
work unit of each rank is K1's segment or slab mode or K3's segment mode),
with their own seeds:

  3p. K1's work units against ``march_plain``, bit-exact at eps 0: on edge
     inputs (13x17x20 at cal_max 200.9, 61x37 pixels, 37 samples: 23
     columns from 17 and samples 13..31, the first, a middle and the last
     slab, negative front.x, conic, LUT 96, a 3-channel volume,
     TF(0).alpha -3e-5 and 0.05, eps 1e-3), then every unit of a (2, 2, 2)
     mesh of 700x700x500 on both volumes (slabs of 91 planes on MNI-dims;
     plain, LUT 256), of (2, 2, 1) at ``sobel_lit_700`` (baked) and conic
     lit, of (2, 2, 2) at ``multichannel_304`` on the 3-channel MNI-dims
     volume and one unit of dense_320 at 304x304x300; the segment and slab
     units' times at eps 1e-3, the plain version's and the bound;
  3q. K3's segment mode against ``march_a5_plain``, bit-exact at eps 0: the
     a5 edge inputs at odd offsets, and the (2, 2, 1) units of ``a5_500``
     and a5 lit 300^3 (baked) on both volumes; times and the bound;
  4h. 4 ranks on the one card joined by gloo (``parallel/launch.spawn`` of
     ``tests/_torch_shard_worker.py``; the gathers go through the host): a1 700x700x500 on (2, 2, 1) and
     (1, 2, 2) on both volumes, conic a1 on (1, 2, 2), a5 ``a5_500`` on
     (2, 2, 1), each at eps 0 (every rank within TOL_EXACT of
     ``render()``) and at eps 1e-3 (within TOL_EPS of the exact render; 4
     timed frames after one, ms/frame time-shared by the four processes);
     each rank's K1 segment / slab and K3 segment launches set to 0 just
     before and read just after; then 1 rank through NCCL, bit-exact to
     ``render()``;
  5j. the CLI ``render --mesh rays=2,samples=2 --backend gloo`` against the
     whole render's PNG (at most one level apart, on under 1 % of the
     channels), started with the other CLI chains.

Sharded fits (``render_vrc_sharded(differentiable=True)``: each rank's work
unit runs K1 forward and K4 backward at its offsets, or K3 and K6), with
their own seeds:

  3r. on both volumes at eps 0: K1's baked slab (the forward of a lit
     slab's unit, ``sobel_lit_700`` on (1, 2, 2)) bit-exact to
     ``march_plain``; K4's segment units of (2, 2, 1) and slab units of
     (1, 2, 2), plain (700x700x500) and baked (``sobel_lit_700``), and K6's
     segment units of (2, 2, 1) (``a5_500``) within TOL_GRAD of max
     |dplain| under seeded cotangents (a unit that owns no sample with a
     gradient: the kernel's dcolors exactly 0); the units' dcolors, summed
     over a (2, 2, 1) and a (1, 2, 2) mesh (a5: (2, 2, 1) and (1, 4, 1))
     through the fold's cotangents of a seeded image cotangent, within
     TOL_SHARD_SUM of the whole render's K4 / K6 dcolors; each variant's
     ms per launch over a mesh's units, the plain version's and the bound;
     K4's spans checked on the plain slab units on MNI-dims, and there the
     first and the last unit of a (1, 4, 1) split and of a (1, 2, 2) split
     under an ortho camera along x against the plain version;
  7m. 4 ranks on the one card joined by gloo (``parallel/launch.spawn`` of
     ``tests/_torch_shard_worker.fit_jobs``), one spawn, on the MNI-dims
     volume: a1 colour fits (700x700x500) on (2, 2, 1) and (1, 2, 2), a lit
     colour and light fit (``sobel_lit_700``) on (2, 2, 1), a lit colour
     fit on (1, 2, 2), an a5 colour fit (``a5_500``) on (2, 2, 1); each
     takes 2 ``fit_transfer_function`` steps, after which every rank's
     parameters must be bit-equal, then one step whose gradients, summed
     over the mesh, must lie within TOL_SHARD_SUM of the single-device
     kernel fit's (of the largest component), then 3 timed steps with each
     rank's K1/K3 and K4/K6 launches by work unit set to 0 just before and
     read just after (rank 0's ms/step); then 1 rank through NCCL.

The scan route (``mode="scan"``: the plain scans under autograd in
checkpointed chunks of samples, for the fits that no differentiable kernel
computes; the volume axis's slab scan), with its own seeds:

  4h, 7m also run it among the gloo ranks: a lit a1 and an a5 render
     through the slab scan on (1, 1, 4) against ``render(mode="scan")``
     within TOL_EXACT, a LUT fit through the scan segments on (2, 2, 1) and
     a light fit through the slab scan on (1, 2, 2), step-1 gradients within
     TOL_EXACT of the single-device scan route's; no kernel launches;
  5k. the CLI ``fit --mode scan --lighting --conic --fit-light``;
  7n. full-width fits through the scan on MNI-dims: (a) conic lit colour
     and light 700x700x500, (b) lit a5 ``a5_500``, (c) a light fit at
     ``lut_phong_300``, (d) a smooth lit bound fit 700x700x500, (e) conic
     scattered 700x700x250, (f) lit 4-D ``multichannel_304``, (g) 20
     intervals and ``Interp.TRILINEAR_COLOR`` 700x700x500; each 1 timed
     step (CUDA events), finite losses, its peak device memory
     at most 8 GiB above the start and no hand-written kernel launched; (a)
     with its steps repeated (equal losses) and a central difference of its
     gradient within TOL_FD; then the scan route against K1/K4 baked
     (``sobel_lit_700``), K3/K6 (``a5_500``) and K8/K9 (the smooth bound
     fit at 700x700x500) at eps 0: losses within 1e-4 relative, every
     gradient within TOL_GRAD of its largest component.

K1's chunks and index width (the brick test's runs of 8 samples; with
channel grids the march computes the voxels of 8 samples and issues their
loads together, then composites them in order; 32-bit voxel indices below
2^31 elements, 64-bit beyond), with its own seeds:

  3s. K1 against ``march_plain``, bit-exact at the same eps: at
     700x700x500 on both volumes and at ``multichannel_304`` on the
     3-channel MNI-dims volume, eps 1e-3 under the default TF and eps 0.5
     with intervals 1-3 at alphas 0.9-0.95, where rays stop on the first,
     the last and an inner sample of a chunk and spans are not a whole
     number of chunks (counted from the plain chain on every 4th ray each
     way, and required to occur); a segment unit whose s_start lies inside
     a chunk of the whole ray; slabs whose chunks straddle the ownership plane (plain, LUT 256,
     mc, baked); lit and lut_lit at 500 samples a ray on
     ``centered_sphere(100)`` at eps 1e-3, where most shaded samples repeat
     the voxel before them, and lit rays within 1e-7 of parallel to each
     face of a volume dense on its faces; the kernel's index-width rule
     against ``march.index32`` at the 2^31 edge, and the plain, lit and mc
     variants on grids past it.

The a5 marches' spans (K3 and K6 run the position chain only on each ray's
samples that may lie in the volume; K3 skips or composites TF(0)'s colour
outside, K6 folds the constant samples once a ray) and index width:

  3t. K3 bit-exact to ``march_a5_plain`` and K6 within TOL_GRAD of
     ``march_a5_bwd_plain``, its block partials within TOL_SPAN_F64 of the
     float64 sums of the plain terms, on the CPU tests' span scenes
     (tests/_torch_a5_scenes.py: odd dims, orbits, a camera inside the
     volume, fronts along an axis, rays that miss, a step longer than a
     voxel, a 512-deep volume, segment units, rays stepped an ulp at a time
     across each face) at TF(0).alpha 0 and 0.05, eps 0 and 1e-3, baked;
     ``a5_500`` on both volumes, MNI-dims' (2, 2, 1) units and a5 lit
     300^3 at TF(0).alpha 0.05; no sample inside the volume outside a span;
     the kernels' index-width rule against ``a5.index32`` at the 2^31
     edge, and K3 and K6 on a 1300^3 id grid whose rays read past 2^31.

The a0 point cloud, the CLI's remaining commands, the default route and
the multi-device dry run, which add no kernel and no launch, with their own
seeds:

  8a. ``render()`` with ``Algorithm.POINT`` at 700x700 on both volumes:
     ms/frame (CUDA events around 8 orbit frames, mean), no kernel
     launched; the first frame against the same inputs on the CPU (at most
     0.1 % of the pixels may differ, their count printed); the exact native
     rasterizer's ms and more than 70 % of its pixels within 0.2 of the
     approximation; ``render_points_depth`` and ``render_depth_vrc`` (500
     samples a ray) finite, in [0, 1] and grey, with their ms;
  8b. in this process (``cli.main``), on a seeded MNI-dims NIfTI that it
     writes and on the sphere: ``render --algorithm point`` (with
     ``--depth``, ``--orbit``, ``--exact-points``), the ray caster's
     ``render --depth``, ``orbit --frames 2``, ``bench --repeats 2`` (its
     rays/s line), ``info`` and ``compare`` (exit 1 below its threshold);
     every PNG valid;
  8c. ``mode="auto"``: a conic scattered a1 frame at 700x700x250 takes
     the scan route (logged, no kernel launched), a plain a1 frame the
     kernel (one K1 launch);
  8d. ``parallel/dryrun.dryrun_multichip(8)`` on 8 gloo ranks sharing
     the card: both configs' gates, its seconds.

The render server, camera recovery and the last utilities, which launch K1
and K3 through ``render()`` and add no kernel:

  9a. ``harness/server.serve`` of 8b's NIfTI on port 0, from a thread:
     ``/health``; ``GET /render`` at the viewer's 300x300x300 for vrc, test,
     point, and vrc with lighting, conic, scattering and depth; ``POST
     /render`` with an orbit; 400 and 404; K1's and K3's launches rise by
     the requests that take them; each PNG, decoded with ``decode_png``,
     equal to ``to_uint8(to_display(...))`` of the same config rendered
     directly (0 pixels may differ); the mean ms of 8 requests that step
     the orbit as the viewer does;
  9b. ``camera_recovery.recover_camera`` of an a1 and an a5 target
     rendered at 100x100 from known cameras on a seeded asymmetric
     MNI-dims volume, 200 directions x 8 rolls and one refinement round:
     refined NCC >= 0.99, its seconds, its K1 / K3 launches equal to the
     renders it scored;
  9c. in this process, ``render --window 1400x1400`` (a valid 1400x1400
     PNG) and ``recover-golden`` over 9b's goldens (JSON that parses);
  9d. on the card against the CPU: ``accel/pyramid.build_pyramid`` bit
     for bit against ``native.build_pyramid``, ``conv3d(reference_kernel())``
     within 1e-6 of max |native.conv3d|, both composites and
     ``texture_quad_display`` within 1e-6.

Each phase's seconds are printed on a line of their own.  Kernel times are
CUDA events around repeated launches queued behind a GPU spin, the median
of 3 windows; a plain version's time is one call, most of them after the
check that has just run it on the same inputs.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on the main paths, its error against its plain version, its
time, the plain version's time and its bound; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W = H = 700
SPR = 500
FRAMES = 8
TOL_EXACT = 2e-5  # kernel vs plain, eps = 0 (and at equal eps)
POINT_CPU_SHARE = 1e-3  # point cloud: pixels that may differ card vs CPU
TOL_EPS = 1.1e-3  # kernel at eps = 1e-3 vs the exact plain render
TOL_GRAD = 5e-3  # backward kernel vs plain, relative to max |dplain|
# K4's per-block partials vs the float64 sums of march_bwd_plain's float32
# terms, relative to their largest: a sample that K4's spans drop or give
# the wrong interval on every ray of a block moves its partial far more
TOL_SPAN_F64 = 1e-4
TOL_FIT = 1e-5  # 2 fit steps, kernels vs plain versions
# central difference of the loss along its gradient (a step of FD_STEP in
# parameter units) against the change the gradient predicts: float32
# rounding of the two losses and the O(step^3) term stay well inside TOL_FD
FD_STEP = 1e-5
TOL_FD = 1e-2
FIT_STEPS = 5
FIT_LR = 1e-2
# at lr 1e-2 Adam moves TF(0).alpha by ~lr per step and the loss rises at
# 500 samples per ray (as in the JAX package); a step this small stays in
# the region where each update is a descent step
FIT_DESCENT_LR = 3e-6
# the 4-D alpha-column fit trains alphas only (rgb is the data's): its
# start scales the alphas of intervals 1..3 by this, so that the loss comes
# from the intervals the channel mean reaches (bone on both 3-channel
# volumes, brain on the MNI-dims one; muscle holds no voxel or 10); at 0.6
# the loss starts ~25x lower and TF(0).alpha's overshoot outweighs it
MC_FIT_ALPHA_SCALE = 0.2
CONIC_PIXEL_SHARE = 0.999  # conic: share of pixels within TOL_EXACT
# H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations one march sample costs: position 9, nearest-voxel index
# 18, time step 2, compositing 9 (csrc/march.cu)
FLOPS_PER_SAMPLE = 38
# float operations dL/dcolors needs, each counted once however a kernel
# schedules it.  A sample inside the volume: position 9, nearest-voxel index
# 18, time step 2; the chain w = T a, 1 - a, T (1 - a), w (g . c), its suffix
# sum, + T_N g_t, the division, T (g . c), da 9; w and da into its
# interval's sums 2 (g multiplies an interval's sum of w once per ray)
FLOPS_PER_BWD_SAMPLE = 40
# a sample off the volume takes id0's colour, whose g . c is per ray, and
# its alpha a0.  Where a0 != 0: the chain 9 and its two sums 2 (whether it
# is off the volume follows from the ray's clip against the box, as in the
# forward bounds)
FLOPS_PER_BWD_OUTSIDE_SAMPLE = 11
# where a0 == 0 such a sample leaves T and the suffix sum as they are, so
# every sample of a run of them has one dL/da, T gd0 - num: 2, times the
# run's length 1, into k0's sum 1, once a run; a ray has at most two runs
# (before and after the volume, whose samples are contiguous on a ray)
FLOPS_PER_BWD_OUTSIDE_RUN = 4
# and per ray: for every interval g . c_k 5 and g times its sum of w 3;
# T_N g_t 1
FLOPS_PER_BWD_RAY_PER_INTERVAL = 8
FLOPS_PER_BWD_RAY = 1
# a5 (Algorithm.TEST): bench.py's a5_500 row, 500x500 pixels, 500 samples
A5_W = A5_H = A5_SPR = 500
# float operations one a5 sample inside the volume needs, each counted once
# however a kernel schedules it (csrc/a5.cu): the position 16 (the TPU
# kernel's hoisted chain, csrc/a5_common.cuh: i s3 1, the inverse view's
# front and translation terms 9, the scale and translation to voxels 6),
# inside test 6, corner truncations and fractions 12, 1 - f 3, the y->x->z
# mix of 4 channels 84, compositing 9
FLOPS_PER_A5_SAMPLE = 130
# per ray: the chain's q 13 (px s1 + o1, py s2 + o2, and their inverse-view
# terms 9); C + T bg 6
FLOPS_PER_A5_RAY = 19
# a sample outside the volume on a live ray is TF(0)'s colour c0: where its
# alpha is not 0 it is composited, w = T a0, C += w c0, T (1 - a0) 8; where
# it is 0 it changes nothing and needs no operation (a5_fwd_ops)
FLOPS_PER_A5_OUTSIDE_SAMPLE = 8
# and what dL/dcolors needs per a5 sample inside the volume: position,
# inside, corners, fractions and 1 - f as above 37, the 8 trilinear weights
# from 4 pair products 12, each corner's weight into its interval's
# coefficient 8, the chain 9 (as a1's); then for each interval present (at
# most min(8, K)): a and g . rgb from its coefficient 4 (g . c_k is per ray)
# and coef w and coef da into its sums 4.  A sample off the volume costs
# what a1's does (bwd_outside_ops): its coefficients are [id0 == k].
FLOPS_PER_A5_BWD_SAMPLE = 66
FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL = 8
# and per ray, besides the per-interval terms: T_N g_t 1 and the chain's
# q 13
FLOPS_PER_A5_BWD_RAY = 14
# the lit slice: bench.py's sobel_lit_700 and lut_phong_300 rows and the a5
# mode of the latter; the baked variants add rgb * M + S, 6 operations, to
# every sample inside the volume
LIT_CONFIGS = {
    "sobel_lit_700": dict(width=700, height=700, samples_per_ray=250,
                          lighting=True, gradient_filter="sobel"),
    "lut_phong_300": dict(width=300, height=300, samples_per_ray=300,
                          tf_lut=256, lighting=True),
    "lut_300": dict(width=300, height=300, samples_per_ray=300, tf_lut=256),
}
A5_LIT = dict(width=300, height=300, samples_per_ray=300, lighting=True)
FLOPS_PER_BAKED_SAMPLE = 6
# smooth mode (Interp.TRILINEAR, K8 and K9), each float operation counted
# once however a kernel schedules it (csrc/smooth.cu, smooth_bwd.cu).  A
# sample with a corner in the volume: the time step 2, the position 15,
# floor and fractions 6, 1 - f 3, seven lerps 21, the division by cal_max
# 1, compositing 9; and per interval k >= 1 two sigmoids (argument 2, exp
# 1, 1 + e 1, division 1) 10, w_k 1, four colour terms 8.  A sample with no
# corner in the volume reads intensity 0, whose RGBA is the ray's constant:
# compositing 9.  Per ray C + T bg 6.
FLOPS_PER_SMOOTH_SAMPLE = 57
FLOPS_PER_SMOOTH_SAMPLE_PER_INTERVAL = 19
FLOPS_PER_SMOOTH_OUTSIDE_SAMPLE = 9
FLOPS_PER_SMOOTH_RAY = 6
# K9, a sample with a corner in the volume: the sample chain above without
# compositing 48, g . rgb 5, the transmittance chain 9 (as K4's), 1 - sum w
# and interval 0's two sums 5; per interval the chain 19 and dL/dw 3 (g .
# (c_k - c_0) is per ray), q 2, dL/dvn 3, sum w 1, dlower 3, dupper 3, the
# two colour sums 4; with the volume gradient dL/dvn / cal_max 1, the eight
# trilinear weights 12, times the gradient 8, the eight adds 8.  Off the
# volume as K4 (bwd_outside_ops), with a0 the alpha of classify(0 /
# cal_max), a sum of sigmoids, which is not 0.  Per ray as K4.
FLOPS_PER_SMOOTH_BWD_SAMPLE = 67
FLOPS_PER_SMOOTH_BWD_SAMPLE_PER_INTERVAL = 38
FLOPS_PER_SMOOTH_SPLAT_SAMPLE = 29
TOL_SMOOTH = 2e-6  # K8 vs plain at eps 0 (bit-exact expected)
SMOOTH_FD_BOUND_STEP = 1e-4  # central difference: bound step (units of vn)
SMOOTH_FD_VOXEL_STEP = 0.05  # and voxel step (intensity units)
# the JAX package's bound-recovery case (tests/test_fit_params.py:181-201)
RECOVERY_STEPS = 80
RECOVERY_LR = 5e-3
# the lit, LUT and light fits (K4's baked, LUT and LUT + baked variants):
# each variant at its main config; the LUT variant at the a1 main path's
# shapes, unlit
K4_VARIANT_CONFIGS = {
    "baked": ("sobel_lit_700", LIT_CONFIGS["sobel_lit_700"]),
    "lut": ("lut_700", dict(width=W, height=H, samples_per_ray=SPR,
                            tf_lut=256)),
    "lut_baked": ("lut_phong_300", LIT_CONFIGS["lut_phong_300"]),
}
# K4 baked adds the shade c * M + S, 6 operations, and w M, 1, per sample
# inside the volume (each once however a kernel schedules it), and reads
# M and S at the voxels the samples touch, 8 bytes for each, at most the
# two grids; the LUT variants' interval lookup is no float operation
FLOPS_PER_BWD_BAKED_SAMPLE = 7
# F1: the default TF with the alphas of intervals 1-3 above 1, so T goes
# negative on rays through them
ALPHA_ABOVE_ONE = 1.2
TOL_LIGHT = 1e-4  # light gradient, kernels vs plain, of the largest
TOL_LIGHT_SYM = 1e-6  # the three colour components' gradients, relative
LIGHT_FD_STEP = 1e-3  # central difference in ambient and direction[0]
# the JAX package's light-recovery case (tests/test_fit_params.py:158-178)
LIGHT_RECOVERY_STEPS = 150
LIGHT_RECOVERY_LR = 2e-2
# volumes beyond the TPU's resident budget: bench.py's streamed rows
# (bench.py:214-240) on its dense sphere at 320^3 and, by the same formula,
# 512^3
LARGE_SIZES = (320, 512)
LARGE_SHAPE = dict(width=304, height=304, samples_per_ray=300)
LARGE_ROWS = {"streamed": {}, "streamed_lit": dict(lighting=True),
              "streamed_a5": dict(a5=True)}
# single scattering: test_scatter_fused_hg_g's materials and strength 1.5
SCATTER_HG = (0.0, 0.7, -0.3, 0.5)
SCATTER_STRENGTH = 1.5
# 4-D multichannel volumes: bench.py's multichannel_304 row (bench.py:
# 244-257), K1 and K4 mc; a sample inside the volume reads its 1 or 3
# channel values (4 bytes each) beside the id, no float operation more
MC_SHAPE = dict(width=304, height=304, samples_per_ray=300)
# conic lit a1 renders through K1's in-kernel lighting (central differences,
# presmooth 0) at the a1 main path's shapes
CONIC_LIT = dict(width=W, height=H, samples_per_ray=SPR, lighting=True,
                 conic=True)
# float operations the in-kernel shade adds to a sample inside the volume,
# each counted once: three central differences 6, |n| 6, 1 / max 2, the unit
# normal 3, |n.l| 6, |n.h| 7, the specular power and product 2, w 3, the
# diffuse product 1, and per channel a c, (d c) l, + s l, w (..) + (1 - w) c
# 9 (1 - w once: 1); it reads the six neighbours (4 bytes each, at most the
# volume).  Per ray the half vector and 1 / max(|h|, 1e-8): 11
FLOPS_PER_LIT_SAMPLE = 64
FLOPS_PER_LIT_RAY = 11
# sharded renders (parallel/render_dist.py): each kernel's work units at the
# main paths' shapes, and ranks on the one card joined by gloo
SHARD_MESH = (2, 2, 2)  # the work units held against the plain versions
SHARD_RUN_MESHES = ((2, 2, 1), (1, 2, 2))  # 4 ranks through gloo
SHARD_RANKS = 4
SHARD_FRAMES = 4  # timed frames a job at eps 1e-3, after one untimed
# sharded fits (render_dist differentiable=True): the backward work units
# held against the plain versions on these meshes, and the units' summed
# dcolors against the whole render's, relative to its largest component
SHARD_FIT_MESHES = ((2, 2, 1), (1, 2, 2))
TOL_SHARD_SUM = 1e-4
# 4 ranks through gloo: fit_transfer_function steps checked across ranks,
# then one step whose gradients are held against the single-device fit's
# (of the largest component) and timed steps
SHARD_FIT_STEPS = 2
SHARD_FIT_TIMED = 3
TOL_PNG_LEVELS = 1  # sharded vs whole CLI PNG, levels of 8 bits
PNG_SHARE = 0.01  # and the share of channels that may differ at all
# timed windows per measurement; the median is reported
TIMING_WINDOWS = 3
# GPU cycles spun before a kernel's timed window (~50 ms at 1.98 GHz), so
# the host has queued the launches before the first event
PREFILL_CYCLES = 100_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    # the process's standard output, also while a CLI command run in this
    # process (``run_cli``) has its own output captured
    print(msg, file=sys.__stdout__, flush=True)


def run_cli(argv, want: int = 0) -> str:
    """The CLI in this process (``cli.main``), its standard output captured
    -> that output; it must exit ``want``.  The route printer that
    ``cli.main`` puts on ``route_log`` is taken off again, so that the
    later phases' renders print no route lines."""
    import contextlib
    import io

    from volumerenderingproject_tpu_torch.harness import cli
    from volumerenderingproject_tpu_torch.models.raycast import route_log

    handlers, level = list(route_log.handlers), route_log.level
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    finally:
        route_log.handlers[:] = handlers
        route_log.setLevel(level)
    out = buf.getvalue()
    lines = out.strip().splitlines()
    log(f"cli {' '.join(argv)}: exit {rc}; {lines[-1] if lines else ''}")
    check(rc == want, f"cli {argv}: exit {rc}, want {want}")
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def mni_like_volume(seed: int = 0) -> np.ndarray:
    """[182, 218, 182] float32: nested ellipsoid shells whose intensities
    fall in the empty, bone, brain and muscle intervals of the default
    transfer function, plus seeded Gaussian noise that straddles the bounds."""
    rng = np.random.default_rng(seed)
    dims = (182, 218, 182)
    axes = [np.arange(d, dtype=np.float32) - (d - 1) / 2.0 for d in dims]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((x / 80.0) ** 2 + (y / 100.0) ** 2 + (z / 78.0) ** 2)
    vol = np.full(dims, 10.0, np.float32)  # empty (alpha 0)
    vol[r < 1.0] = 55.0  # bone: [30, 80] / 255
    vol[r < 0.8] = 112.0  # brain: [105, 120] / 255
    vol[r < 0.45] = 150.0  # muscle: [140, 160] / 255
    vol += rng.normal(0.0, 6.0, dims).astype(np.float32)
    return vol


def timed_ms(fn, reps: int, prefill: bool = False,
             label: str | None = None, windows: int = TIMING_WINDOWS,
             warm_up: bool = True) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls, the median
    of ``windows`` such windows, with the garbage collector off, after one
    untimed call (unless ``warm_up`` is off).  With ``prefill`` (for
    kernels) the GPU spins first, so a host pause while the launches are
    queued does not show as device time; a plain version, whose time is its
    launches, is timed without it."""
    import gc

    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    gc.disable()
    try:
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if prefill:
                torch.cuda._sleep(PREFILL_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
    finally:
        gc.enable()
    if label:
        log(f"{label}: windows {[round(w, 5) for w in times]} ms")
    return sorted(times)[len(times) // 2]


def time_plain(fn) -> float:
    """ms of one call of a plain version, with no untimed call before it
    (most callers have just run it on the same inputs): its time is its
    host launches, seconds at the main paths' shapes, so one call is enough
    (and keeps the script inside its time limit)."""
    return timed_ms(fn, 1, windows=1, warm_up=False)


def orbit_cameras(P, rng, frames: int = FRAMES, radius: float = 1.5):
    """bench.py:123-135: an orbit at radius 1.5 with a small seeded jitter."""
    thetas = (np.linspace(0.0, 2.0 * np.pi, frames + 1)[:frames]
              + rng.random(frames) * 1e-4)
    return [P.Camera.initial(position=(radius * np.cos(t),
                                       0.4 + 0.2 * np.sin(2.0 * t),
                                       radius * np.sin(t)))
            for t in thetas]


def check_png(path: str, width: int, height: int) -> None:
    """Signature, chunk CRCs, IHDR size and the decompressed scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    pos, idat, ihdr, tags = 8, [], None, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc,
              f"{path}: bad CRC in {tag!r}")
        tags.append(tag)
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    check(ihdr is not None and tags[-1] == b"IEND", f"{path}: bad chunks")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    check((w, h) == (width, height), f"{path}: size {w}x{h}")
    raw = zlib.decompress(b"".join(idat))
    check(len(raw) == h * (1 + 3 * w), f"{path}: {len(raw)} pixel bytes")


def tf16(P, device):
    """16 overlapping intervals with seeded bounds and colours (alphas up
    to 0.7, one of them 0)."""
    import torch

    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    colors[5, 3] = 0.0
    return P.TransferFunction(*(torch.tensor(v, device=device) for v in (
        lo, hi, colors, np.zeros(16, np.float32))))


def tf_with_alpha(P, tf, k: int, alpha: float):
    """``tf`` with interval k's alpha set to ``alpha``."""
    colors = tf.colors.clone()
    colors[k, 3] = alpha
    return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


def away_camera(P, position):
    """A camera at ``position`` that looks away from the volume: every ray
    misses the box."""
    c = P.Camera.initial(position=position)
    return P.Camera(c.position, -c.front, c.right, c.up, c.top_left)


def cotangents(a, rng):
    """One seeded cotangent pair (g_rgb [W, H, 3], g_t [W, H]) on the card,
    N(0, 1) / (W * H): the scale of a mean-squared-error cotangent."""
    import torch

    scale = np.float32(1.0 / (a.width * a.height))
    g_rgb = rng.normal(0.0, 1.0, (a.width, a.height, 3)).astype(np.float32)
    g_t = rng.normal(0.0, 1.0, (a.width, a.height)).astype(np.float32)
    return (torch.tensor(g_rgb * scale, device=a.scal.device),
            torch.tensor(g_t * scale, device=a.scal.device))


def fwd_vs_plain(kernel, plain, label, a, conic=False):
    """A forward kernel and its plain version on the same inputs -> (kernel
    image, plain image, max abs error or None for conic rays)."""
    import torch

    got = kernel(a)
    want = plain(a)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    err = (got - want).abs().amax(dim=-1)
    if conic:
        within = int((err <= TOL_EXACT).sum())
        log(f"{label}: {within}/{err.numel()} pixels within "
            f"{TOL_EXACT:g}, max err {float(err.max()):.3e}")
        check(within >= CONIC_PIXEL_SHARE * err.numel(),
              f"{label}: only {within} pixels within tolerance")
        return got, want, None
    e = float(err.max())
    log(f"{label}: kernel vs plain max err {e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"{label}: max err {e}")
    return got, want, e


def bwd_vs_plain(kernel, plain, label, a, g):
    """A backward kernel and its plain version on the same inputs ->
    (max abs error, error relative to max |dplain|)."""
    import torch

    got = kernel(a, *g)
    want = plain(a, *g)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    e_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(scale > 0.0, f"{label}: the plain gradient is all zero")
    e_rel = e_abs / scale
    log(f"{label}: backward kernel vs plain max abs err {e_abs:.3e}, "
        f"relative {e_rel:.3e} (tol {TOL_GRAD:g}), max |dplain| {scale:.3e}")
    check(e_rel <= TOL_GRAD, f"{label}: relative error {e_rel}")
    return e_abs, e_rel


def needed_stats(plain, args) -> dict:
    """Means over ``args`` of the plain version's ``stats`` (every version
    gives "samples", those inside the volume on live rays; the a5 version
    also "outside", those outside it on live rays)."""
    total = {}
    for a in args:
        stats = {}
        plain(a, stats)
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
    return {k: v / len(args) for k, v in total.items()}


def samples_needed(plain, args) -> float:
    """Mean over ``args`` of the samples each march input needs (the plain
    version's ``stats["samples"]``: inside the volume, on live rays)."""
    return needed_stats(plain, args)["samples"]


def a5_fwd_ops(a5, args, per_sample: int) -> tuple:
    """-> (float operations, samples inside) that K3 needs on the mean of
    the a5 march inputs ``args``: ``per_sample`` for each sample inside the
    volume on a live ray, FLOPS_PER_A5_OUTSIDE_SAMPLE for each sample
    outside it on a live ray where TF(0)'s alpha is not 0, and
    FLOPS_PER_A5_RAY a ray."""
    n = needed_stats(a5.march_a5_plain, args)
    a = args[0]
    a0 = float(a.colors[int(a.scal[a5.S_ID0]), 3])
    ops = (n["samples"] * per_sample + a.width * a.height * FLOPS_PER_A5_RAY
           + (n["outside"] * FLOPS_PER_A5_OUTSIDE_SAMPLE if a0 != 0.0
              else 0.0))
    return ops, n["samples"]


def read_bytes(grid_bytes: float, reads: float) -> float:
    """Bytes of a grid that the samples read: one read each, at most the
    whole grid (the work follows the data: count what it needs)."""
    return min(grid_bytes, reads)


def bwd_outside_ops(outside: float, rays: int, a0: float) -> float:
    """Float operations dL/dcolors needs for ``outside`` samples off the
    volume on ``rays`` rays, where those samples' alpha is ``a0``: each
    sample's chain where a0 != 0 (FLOPS_PER_BWD_OUTSIDE_SAMPLE), else one
    dL/da a run of them (FLOPS_PER_BWD_OUTSIDE_RUN), at most two a ray."""
    if a0 != 0.0:
        return outside * FLOPS_PER_BWD_OUTSIDE_SAMPLE
    return min(outside, 2 * rays) * FLOPS_PER_BWD_OUTSIDE_RUN


def bwd_alpha0(a, s_id0: int) -> float:
    """The alpha of march input ``a``'s samples off the volume (density
    folded in): the colour of id0's interval, through the LUT's interval
    table where there is one; ``s_id0`` is id0's slot in ``a.scal``."""
    k0 = int(a.scal[s_id0])
    if getattr(a, "itv", None) is not None:
        k0 = int(a.itv[k0])
    return float(a.colors[k0, 3])


def bound(ops: float, nbytes: float):
    """-> (bound ms, what bounds it, operations ms, bytes ms): ``ops``
    float operations at the card's float32 peak against ``nbytes`` at its
    memory rate."""
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


class FitRoute:
    """One differentiable route of the fit: its forward kernel module and
    the backward module (each with a ``launches`` counter; the backward one
    holds the ``_forward``/``_backward`` that the autograd function calls),
    their plain versions, and the kernels' names in a profiler trace."""

    def __init__(self, label, fwd_mod, bwd_mod, plain_fwd, plain_bwd,
                 fwd_name, bwd_name):
        self.label, self.fwd_mod, self.bwd_mod = label, fwd_mod, bwd_mod
        self.plain = (plain_fwd, plain_bwd)
        self.names = (fwd_name, bwd_name)

    def reset(self):
        self.fwd_mod.launches = self.bwd_mod.launches = 0

    def counts(self):
        return self.fwd_mod.launches, self.bwd_mod.launches


def fit_phase(P, fit, route, vname, vol, rng, cfg, fit_bounds=False,
              alpha_only=False):
    """Phase 7 (a1), 7b (a5), 7c (the smooth bound fit, ``fit_bounds``:
    the bounds start moved by the JAX test's offsets and are fitted too) or
    7l (a 4-D volume, ``alpha_only``: rgb is the data's, so the start
    scales the alphas of intervals 1..3 by MC_FIT_ALPHA_SCALE instead of
    moving their colours) on one volume -> its numbers."""
    import torch

    kf, kb = route.label
    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg)
    colors = tf.colors.clone()
    if alpha_only:
        colors[1:, 3] *= MC_FIT_ALPHA_SCALE
    else:
        colors[1:, :3] += torch.tensor(
            rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32),
            device=colors.device)
    lower, upper = tf.lower, tf.upper
    if fit_bounds:
        lower, upper = bounds_moved(tf)
    start_tf = P.TransferFunction(lower, upper, colors, tf.hg_g)

    def run(steps, lr=FIT_LR):
        return fit.fit_transfer_function(vol, cam, target, start_tf, cfg,
                                         steps=steps, learning_rate=lr,
                                         fit_bounds=fit_bounds)

    run(1)  # warm-up step
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    route.reset()
    start.record()
    params, losses = run(FIT_STEPS)
    end.record()
    torch.cuda.synchronize()
    k1, k4 = route.counts()
    step_ms = start.elapsed_time(end) / FIT_STEPS
    log(f"{vname}: fit losses {losses}, {step_ms:.4f} ms/step, launches "
        f"{kf} {k1} {kb} {k4} for {FIT_STEPS} steps")
    check(k1 == k4 == FIT_STEPS, f"{vname}: launches {kf} {k1} {kb} {k4}")
    check(all(math.isfinite(v) for v in losses), f"{vname}: loss not finite")
    log(f"{vname}: at lr {FIT_LR:g} the loss after {FIT_STEPS} steps is "
        f"{losses[-1]:.6g} vs {losses[0]:.6g} at the start: "
        f"{'fell' if losses[-1] < losses[0] else 'did not fall'}")
    trace = profile_fit(lambda: run(FIT_STEPS), route.names)
    log(f"{vname}: the same {FIT_STEPS} steps under torch.profiler: "
        f"{trace['wall_ms'] / FIT_STEPS:.4f} ms/step, device busy "
        f"{trace['busy_ms'] / FIT_STEPS:.4f} ms/step ({kf} "
        f"{trace['k1_ms'] / FIT_STEPS:.4f}, {kb} "
        f"{trace['k4_ms'] / FIT_STEPS:.4f}),"
        f" idle {trace['idle_share']:.4f} of the span from the first kernel to "
        f"the last ({trace['span_ms'] / FIT_STEPS:.4f} ms/step), "
        f"{trace['kernels']} device operations")

    # descent: the same start at a step small enough that every update
    # lowers the loss
    route.reset()
    _, descent = run(FIT_STEPS, FIT_DESCENT_LR)
    d1, d4 = route.counts()
    log(f"{vname}: fit losses at lr {FIT_DESCENT_LR:g} {descent}, launches "
        f"{kf} {d1} {kb} {d4}")
    check(d1 == d4 == FIT_STEPS, f"{vname}: launches {kf} {d1} {kb} {d4}")
    check(all(b < a for a, b in zip(descent, descent[1:])),
          f"{vname}: the loss did not fall at every step at lr "
          f"{FIT_DESCENT_LR:g}")

    # the gradient at the start against a central difference of the loss
    # along it; the change it predicts is taken over the parameter steps as
    # float32 rounds them
    params = fit.FitParams.init(start_tf, fit_bounds=fit_bounds)
    fit.render_loss(params, start_tf, vol, cam, target, cfg).backward()
    grads = [p.grad for p in params.parameters()]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    check(math.isfinite(norm) and norm > 0.0, f"{vname}: gradient {norm}")
    with torch.no_grad():
        up, down = (fit.FitParams(*(p + (h / norm) * g for p, g in zip(
            params.parameters(), grads))) for h in (FD_STEP, -FD_STEP))
        l_up, l_down = (float(fit.render_loss(q, start_tf, vol, cam, target,
                                              cfg)) for q in (up, down))
        predicted = sum(float((g.double() * (u - d).double()).sum())
                        for g, u, d in zip(grads, up.parameters(),
                                           down.parameters()))
    fd_err = abs((l_up - l_down) - predicted) / abs(predicted)
    log(f"{vname}: |grad| {norm:.6g}; loss {l_down:.9g} a step of "
        f"{FD_STEP:g} down the gradient, {l_up:.9g} up it; the difference "
        f"{l_up - l_down:.6g} against {predicted:.6g} predicted by the "
        f"gradient (relative err {fd_err:.3e}, tol {TOL_FD:g})")
    check(fd_err <= TOL_FD and l_down < l_up,
          f"{vname}: gradient check failed")

    # the first 2 steps through the kernels and through the plain versions
    pk, lk = run(2)
    vjp = route.bwd_mod
    routes = vjp._forward, vjp._backward
    vjp._forward, vjp._backward = route.plain
    try:
        pp, lp = run(2)
    finally:
        vjp._forward, vjp._backward = routes
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(float((a - b).detach().abs().max())
                    for a, b in zip(pk.parameters(), pp.parameters()))
    log(f"{vname}: 2 fit steps, kernels vs plain: losses {lk} vs {lp} "
        f"(max relative err {loss_err:.3e}), parameters max abs err "
        f"{param_err:.3e} (tol {TOL_FIT:g})")
    check(lk == losses[:2], f"{vname}: the fit is not deterministic")
    check(loss_err <= TOL_FIT and param_err <= TOL_FIT,
          f"{vname}: kernels vs plain fit steps differ")
    return dict(step_ms=step_ms, k1=k1, k4=k4, losses=losses, fd_err=fd_err,
                descent=descent, trace=trace)


def profile_fit(fn, names) -> dict:
    """Run ``fn`` under torch.profiler -> its wall time, the device time of
    the two kernels ``names`` (forward, backward) and of all device
    operations (their union), and the device's idle share of the span from
    the first device operation to the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"
           and not getattr(e, "is_user_annotation", False)]
    check(len(ops) > 0, "the profiler recorded no device operation")
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + (hi - lo), s
        hi = max(hi, e)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]

    def kernel_ms(name):
        return sum(e.time_range.end - e.time_range.start for e in ops
                   if name in e.name) / 1e3

    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=1.0 - busy / span, kernels=len(ops),
                k1_ms=kernel_ms(names[0]), k4_ms=kernel_ms(names[1]))


def a5_edge_cases(P, tf, from_text):
    """Edge inputs of the a5 kernels at small shapes -> [(name, volume, tf,
    camera, config, eps)]: odd dims with negative intensities and cal_max
    200.9, the z-wrap and y-wrap scenes of tests/test_pallas_a5.py, a
    z > 127 volume, TF(0).alpha 0.05 and -3e-5, a single-interval table,
    eps 1e-3."""
    rng = np.random.default_rng(5)
    odd = P.make_volume(rng.uniform(-30, 255, (13, 17, 20)).astype(np.float32),
                        cal_max=200.9)
    zwrap = np.zeros((6, 6, 6), np.float32)
    zwrap[2, 3, 0] = zwrap[2, 2, 5] = 150.0
    wraps = np.zeros((6, 6, 130), np.float32)
    wraps[2, 3, 0] = wraps[2, 2, 129] = 150.0
    wraps[3, 0, 64] = wraps[2, 5, 64] = 150.0
    deep = P.make_volume(rng.uniform(-30, 255, (12, 14, 150))
                         .astype(np.float32))
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37,
                           algorithm=P.Algorithm.TEST)
    wrap_cfg = P.RenderConfig(width=16, height=16, samples_per_ray=24,
                              algorithm=P.Algorithm.TEST)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    wrap_cam = P.Camera.initial(position=(0.1, 0.2, 0.95))
    return [
        ("odd_negatives_calmax200.9", odd, tf, near, small, 0.0),
        ("z_wrap", P.make_volume(zwrap), tf, wrap_cam, wrap_cfg, 0.0),
        ("y_and_z_wraps_z130", P.make_volume(wraps), tf, wrap_cam, wrap_cfg,
         0.0),
        ("z150", deep, tf, near, small, 0.0),
        ("alpha0_0.05", odd, tf_with_alpha(P, tf, 0, 0.05), near, small, 0.0),
        ("negative_alpha0", odd, tf_with_alpha(P, tf, 0, -3e-5), near, small,
         0.0),
        ("single_interval_tf", odd, from_text("glass 0 1"), near, small, 0.0),
        ("eps1e-3", odd, tf, near, small, 1e-3),
    ]


def a5_kernel_phases(P, a5, a5_vjp, volumes, tf, edge, rng, per_volume):
    """Phases 3c (K3 against march_a5_plain) and 3d (K6 against
    march_a5_bwd_plain) -> (K3 max abs err, K6 max abs err, K6 max relative
    err); times and bounds go into ``per_volume``."""
    cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                         algorithm=P.Algorithm.TEST)

    def k3_vs_plain(label, a):
        return fwd_vs_plain(a5.march_a5_kernel, a5.march_a5_plain, label, a)

    # ---- 3c. K3 ----------------------------------------------------------
    k3_err = 0.0
    for name, vol, tfx, cam, c, eps in edge:
        _, _, e = k3_vs_plain(f"a5 edge/{name}",
                              a5.prepare_a5(vol, tfx, cam, c, eps))
        k3_err = max(k3_err, e)
    for vname, vol in volumes.items():
        orbit_cam = orbit_cameras(P, rng, 1)[0]
        exact = {}
        for name, cam, eps in (("orbit_eps0", orbit_cam, 0.0),
                               ("orbit_eps1e-3", orbit_cam, 1e-3),
                               ("preset_eps0", P.reset_preset(), 0.0)):
            got, want, e = k3_vs_plain(f"a5 {vname}/{name}",
                                       a5.prepare_a5(vol, tf, cam, cfg, eps))
            k3_err = max(k3_err, e)
            if eps == 0.0:
                exact[id(cam)] = want
                continue
            e2 = float((got - exact[id(cam)]).abs().max())
            log(f"a5 {vname}/{name}: K3 at eps {eps:g} vs exact plain max "
                f"err {e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"a5 {vname}/{name}: eps error {e2}")

        # K3 and plain times and the bound, at the render path's inputs
        cams = orbit_cameras(P, rng)
        main_cfg = cfg.replace(early_termination=1e-3)
        args = [a5.prepare_a5(vol, tf, cam, main_cfg, 1e-3) for cam in cams]

        def orbit_kernels():
            for a in args:
                a5.march_a5_kernel(a)

        k3_ms = timed_ms(orbit_kernels, 5, prefill=True,
                         label=f"a5 {vname}: K3 x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: a5.prepare_a5(vol, tf, cams[0], main_cfg,
                                                 1e-3), 5)
        ops, samples = a5_fwd_ops(a5, args, FLOPS_PER_A5_SAMPLE)
        plain_ms = time_plain(lambda: a5.march_a5_plain(args[0]))
        rays = A5_W * A5_H
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            ops, bound_bytes(args[0], rays, samples, 8))
        per_volume[vname].update(
            a5_ms=k3_ms, a5_plain_ms=plain_ms, a5_prep_ms=prep_ms,
            a5_bound_ms=bound_ms, a5_bound_by=bound_by, a5_samples=samples)
        log(f"a5 {vname}: K3 {k3_ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
            f"{prep_ms:.4f} ms, needed samples per frame {samples}, bound "
            f"{ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")

    # ---- 3d. K6 ----------------------------------------------------------
    grad_rng = np.random.default_rng(6)
    k6_abs = k6_rel = 0.0

    def k6_vs_plain(label, a, g):
        return bwd_vs_plain(a5_vjp.march_a5_bwd_kernel,
                            a5_vjp.march_a5_bwd_plain, label, a, g)

    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    odd = edge[0][1]
    small = edge[0][4]
    for name, vol, tfx, cam, c, _ in edge + [
            ("alpha_one", odd, tf_with_alpha(P, tf, 3, 1.0), near, small,
             0.0),
            ("k16", odd, tf16(P, tf.colors.device), near, small, 0.0)]:
        a, _ = a5_vjp.prepare_a5_diff(vol, tfx, cam, c)
        e_abs, e_rel = k6_vs_plain(f"a5 edge/{name}", a, cotangents(a,
                                                                 grad_rng))
        k6_abs, k6_rel = max(k6_abs, e_abs), max(k6_rel, e_rel)
    bwd_cam = orbit_cameras(P, np.random.default_rng(7), 1)[0]
    for vname, vol in volumes.items():
        a, _ = a5_vjp.prepare_a5_diff(vol, tf, bwd_cam, cfg)
        g = cotangents(a, grad_rng)
        e_abs, e_rel = k6_vs_plain(f"a5 {vname}/orbit", a, g)
        k6_abs, k6_rel = max(k6_abs, e_abs), max(k6_rel, e_rel)
        k6_ms = timed_ms(lambda: a5_vjp.march_a5_bwd_kernel(a, *g), 5,
                         prefill=True, label=f"a5 {vname}: K6")
        k6_plain_ms = time_plain(lambda: a5_vjp.march_a5_bwd_plain(a, *g))
        k3_eps0_ms = timed_ms(lambda: a5.march_a5_kernel(a), 5, prefill=True)
        k = a.colors.shape[0]
        rays = A5_W * A5_H
        # at eps 0 no ray stops early: the samples inside the volume
        inside = samples_needed(a5.march_a5_plain, [a])
        nbytes = (read_bytes(math.prod(vol.dims), inside * 8) + rays * 16
                  + k * 16 + a5_vjp.num_blocks(A5_W, A5_H) * k * 16)
        ops = (inside * (FLOPS_PER_A5_BWD_SAMPLE
                         + min(8, k) * FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL)
               + bwd_outside_ops(rays * A5_SPR - inside, rays,
                                 bwd_alpha0(a, a5.S_ID0))
               + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                         + FLOPS_PER_A5_BWD_RAY))
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
        per_volume[vname].update(
            a5_bwd_ms=k6_ms, a5_bwd_plain_ms=k6_plain_ms,
            a5_fwd_eps0_ms=k3_eps0_ms, a5_bwd_bound_ms=bound_ms,
            a5_bwd_bound_by=bound_by, a5_bwd_inside=inside)
        log(f"a5 {vname}: K6 {k6_ms:.4f} ms, plain {k6_plain_ms:.2f} ms, K3 "
            f"at eps 0 {k3_eps0_ms:.4f} ms, samples inside the volume "
            f"{inside} of {rays * A5_SPR}, bound {ops_ms:.4f} ms (operations)"
            f" / {bytes_ms:.4f} ms (bytes)")
    return k3_err, k6_abs, k6_rel


def a5_render_phase(P, a5, volumes, tf, rng, per_volume) -> int:
    """Phase 4b: 8 orbit frames per volume through ``render()`` with
    Algorithm.TEST at eps 1e-3 -> K3's launches, which must equal the
    frames."""
    import torch

    cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                         algorithm=P.Algorithm.TEST, early_termination=1e-3)
    frames = 0
    a5.launches = 0
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], cfg)  # warm-up frame
        frames += 1
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        frames += len(imgs)
        ms = start.elapsed_time(end) / len(imgs)
        for img in imgs:
            check(tuple(img.shape) == (A5_W, A5_H, 4),
                  f"a5 {vname}: shape {img.shape}")
            check(bool(torch.isfinite(img).all()), f"a5 {vname}: not finite")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"a5 {vname}: image is background only ({fg})")
        per_volume[vname]["a5_render_ms"] = ms
        log(f"a5 {vname}: render() {ms:.4f} ms/frame, "
            f"{A5_W * A5_H / ms * 1e3:.4e} rays/s")
    launches = a5.launches
    log(f"K3 launches on the a5 render path: {launches} for {frames} frames")
    check(launches == frames, f"a5 launches {launches} != frames {frames}")
    return launches


def a1_cli_render(tmp: str) -> str:
    """Phase 5: ``python -m volumerenderingproject_tpu_torch render`` in a
    process of its own (the module entry) must write a valid 700x700 PNG
    -> its path."""
    out = os.path.join(tmp, "sphere.png")
    proc = subprocess.run(
        [sys.executable, "-m", "volumerenderingproject_tpu_torch",
         "render", "--data", "sphere", "--width", str(W), "--height",
         str(H), "--spr", str(SPR), "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(f"cli exit {proc.returncode}: {proc.stdout.strip()} "
        f"{proc.stderr.strip()[-2000:]}")
    check(proc.returncode == 0, "cli render failed")
    check_png(out, W, H)
    return out


def a1_cli_fit(tmp: str, target: str, tf, from_text) -> None:
    """Phase 5b: the CLI ``fit`` against the PNG ``target`` must write a TF
    file that parses."""
    import torch

    out_tf = os.path.join(tmp, "fitted.txt")
    run_cli(["fit", "--data", "sphere", "--width", str(W), "--height",
             str(H), "--spr", str(SPR), "--target", target, "--steps", "3",
             "--out-tf", out_tf])
    with open(out_tf) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == tf.num_intervals
          and bool(torch.isfinite(fitted.colors).all()),
          "cli fit wrote a bad transfer function")


def a5_cli_phase(tmp: str, tf, from_text) -> None:
    """Phases 5c and 5d: the CLI ``render`` and ``fit`` with
    ``--algorithm test``."""
    import torch

    size = ["--width", str(A5_W), "--height", str(A5_H), "--spr", str(A5_SPR)]
    out = os.path.join(tmp, "sphere_a5.png")
    run_cli(["render", "--data", "sphere", *size, "--algorithm", "test",
             "--out", out])
    check_png(out, A5_W, A5_H)
    out_tf = os.path.join(tmp, "fitted_a5.txt")
    run_cli(["fit", "--data", "sphere", *size, "--algorithm", "test",
             "--target", out, "--steps", "3", "--out-tf", out_tf])
    with open(out_tf) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == tf.num_intervals
          and bool(torch.isfinite(fitted.colors).all()),
          "cli a5 fit wrote a bad transfer function")


def reset_launches(*mods) -> None:
    """Set each kernel module's launch counts, in all and by variant, to 0."""
    for m in mods:
        m.launches = 0
        m.variant_launches = dict.fromkeys(m.variant_launches, 0)


def bound_bytes(a, rays: int, samples: float, id_reads: int = 1) -> float:
    """Bytes a march must move, each once: the ids its ``samples`` read
    (``id_reads`` a sample: 1 for a1, the 8 corners for a5; at most the id
    grid), the brick map (a1), the colours, the baked (M, S) at the
    sampled voxels (8 bytes a sample, at most the two grids) and the
    output."""
    size = a.ids.element_size()
    n = (read_bytes(a.ids.numel() * size, samples * id_reads * size)
         + a.colors.numel() * 4 + rays * 16)
    occ = getattr(a, "occ", None)  # the a5 march has no brick map
    if occ is not None:
        n += occ.numel() * 4
    if a.mgrid is not None:
        n += read_bytes((a.mgrid.numel() + a.sgrid.numel()) * 4, samples * 8)
    return n


def exact_vs_plain(kernel, plain, label, a):
    """A kernel variant of this slice against its plain version: it must be
    bit-exact -> (kernel image, plain image, max abs error)."""
    import torch

    got = kernel(a)
    want = plain(a)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    e = float((got - want).abs().max())
    log(f"{label}: kernel vs plain max err {e:.3e} (must be 0)")
    check(e == 0.0, f"{label}: max err {e}")
    return got, want, e


def lit_edge_tfs(P, tf, from_text):
    """(TF with a bound on a 256-entry LUT grid point, TF(0).alpha -3e-5)."""
    pts = np.arange(256, dtype=np.float32) * (np.float32(1) / np.float32(255))
    bound = from_text(f"empty 0 1 0.1 0.1 0.1 0\n"
                      f"edge {float(pts[40])!r} {float(pts[90])!r} 1 0.4 0.2 "
                      f"0.3\nbone 0.5 0.7 0.9 0.9 0.8 0.6\n")
    return bound, tf_with_alpha(P, tf, 0, -3e-5)


def lit_kernel_phases(P, march, a5, phong, volumes, tf, from_text, rng,
                      per_volume):
    """Phases 3e (K1's LUT, baked and LUT + baked variants against
    march_plain) and 3f (K3 baked against march_a5_plain) -> {variant: max
    abs err}; times, bakes and bounds go into ``per_volume``."""
    import torch

    errs = {"lut": 0.0, "baked": 0.0, "lut_baked": 0.0, "a5_baked": 0.0}
    edge_rng = np.random.default_rng(10)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    far = P.Camera.initial(position=(0.9, 0.5, 1.0))  # most rays miss
    tf_bound, tf_neg = lit_edge_tfs(P, tf, from_text)
    lit = small.replace(lighting=True)
    edges = [
        ("lut2", tf, near, small.replace(tf_lut=2)),
        ("lut96_rays_miss_box", tf, far, small.replace(tf_lut=96)),
        ("lut256_bound_on_grid_point", tf_bound, near,
         small.replace(tf_lut=256)),
        ("lut256_negative_alpha0", tf_neg, near, small.replace(tf_lut=256)),
        ("lut1024", tf, near, small.replace(tf_lut=1024)),
        ("baked_central", tf, near, lit),
        ("baked_sobel_presmooth", tf, near,
         lit.replace(gradient_filter="sobel", presmooth_sigma=1.0)),
        ("baked_negative_alpha0", tf_neg, near, lit),
        ("baked_rays_miss_box", tf, far, lit),
        ("baked_front_clip_density", tf, near,
         lit.replace(front_clip=0.5, density_scale=0.45)),
        ("lut_baked_2", tf, near, lit.replace(tf_lut=2)),
        ("lut_baked_bound_on_grid_point", tf_bound, near,
         lit.replace(tf_lut=256)),
        ("lut_baked_negative_alpha0", tf_neg, near, lit.replace(tf_lut=96)),
        ("lut_baked_rays_miss_box", tf, far, lit.replace(tf_lut=256)),
        ("lut_baked_1024_sobel", tf, near,
         lit.replace(tf_lut=1024, gradient_filter="sobel")),
    ]
    # ---- 3e. K1 variants -------------------------------------------------
    for name, tfx, cam, c in edges:
        a = march.prepare(odd, tfx, cam, c, 0.0)
        var = march.variant(a)
        e = exact_vs_plain(march.march_kernel, march.march_plain,
                           f"lit edge/{name} ({var})", a)[2]
        errs[var] = max(errs[var], e)
    for vname, vol in volumes.items():
        for cname, kw in LIT_CONFIGS.items():
            cfg = P.RenderConfig(**kw)
            cam = orbit_cameras(P, rng, 1)[0]
            a = march.prepare(vol, tf, cam, cfg, 0.0)
            var = march.variant(a)
            label = f"{vname}/{cname} ({var})"
            _, exact, e = exact_vs_plain(
                march.march_kernel, march.march_plain, f"{label} eps0", a)
            errs[var] = max(errs[var], e)
            got = march.march_kernel(march.prepare(vol, tf, cam, cfg, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")

            # times, the bake and the bound at the render path's inputs
            main_cfg = cfg.replace(early_termination=1e-3)
            cams = orbit_cameras(P, rng)
            args = [march.prepare(vol, tf, c, main_cfg, 1e-3) for c in cams]

            def orbit_kernels():
                for x in args:
                    march.march_kernel(x)

            ms = timed_ms(orbit_kernels, 5, prefill=True,
                          label=f"{label}: kernel x{FRAMES}") / FRAMES
            prep_ms = timed_ms(lambda: march.prepare(vol, tf, cams[0],
                                                     main_cfg, 1e-3), 3)
            bake_ms = 0.0
            if cfg.lighting:
                light = phong.default_light()
                bake_ms = timed_ms(lambda: phong.bake_light_grids(
                    vol.data, cfg, light, -cams[0].front), 3)
            samples = samples_needed(march.march_plain, args)
            plain_ms = time_plain(lambda: march.march_plain(args[0]))
            rays = cfg.width * cfg.height
            ops = samples * (FLOPS_PER_SAMPLE + (
                FLOPS_PER_BAKED_SAMPLE if cfg.lighting else 0))
            bound_ms, bound_by, ops_ms, bytes_ms = bound(
                ops, bound_bytes(args[0], rays, samples))
            per_volume[vname][cname] = dict(
                variant=var, ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
                bake_ms=bake_ms, bound_ms=bound_ms, bound_by=bound_by,
                samples=samples)
            log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
                f"{prep_ms:.4f} ms (bake {bake_ms:.4f} ms), needed samples per"
                f" frame {samples}, bound {ops_ms:.4f} ms (operations) / "
                f"{bytes_ms:.4f} ms (bytes)")
            del args
            torch.cuda.empty_cache()

    # ---- 3f. K3 baked ----------------------------------------------------
    for name, vol, tfx, cam, c, eps in a5_edge_cases(P, tf, from_text):
        a = a5.prepare_a5(vol, tfx, cam, c.replace(lighting=True), eps)
        e = exact_vs_plain(a5.march_a5_kernel, a5.march_a5_plain,
                           f"a5 lit edge/{name}", a)[2]
        errs["a5_baked"] = max(errs["a5_baked"], e)
    for vname, vol in volumes.items():
        cfg = P.RenderConfig(algorithm=P.Algorithm.TEST, **A5_LIT)
        cam = orbit_cameras(P, rng, 1)[0]
        for gname, c in (("central", cfg),
                         ("sobel", cfg.replace(gradient_filter="sobel"))):
            label = f"a5 {vname}/a5_lit_300_{gname}"
            _, exact, e = exact_vs_plain(
                a5.march_a5_kernel, a5.march_a5_plain, f"{label} eps0",
                a5.prepare_a5(vol, tf, cam, c, 0.0))
            errs["a5_baked"] = max(errs["a5_baked"], e)
            got = a5.march_a5_kernel(a5.prepare_a5(vol, tf, cam, c, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: K3 baked at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
        main_cfg = cfg.replace(early_termination=1e-3)
        cams = orbit_cameras(P, rng)
        args = [a5.prepare_a5(vol, tf, c, main_cfg, 1e-3) for c in cams]

        def orbit_a5():
            for x in args:
                a5.march_a5_kernel(x)

        ms = timed_ms(orbit_a5, 5, prefill=True,
                      label=f"a5 {vname}: K3 baked x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: a5.prepare_a5(vol, tf, cams[0], main_cfg,
                                                 1e-3), 3)
        light = phong.default_light()
        bake_ms = timed_ms(lambda: phong.bake_light_grids(
            vol.data, cfg, light, -cams[0].front), 3)
        ops, samples = a5_fwd_ops(
            a5, args, FLOPS_PER_A5_SAMPLE + FLOPS_PER_BAKED_SAMPLE)
        plain_ms = time_plain(lambda: a5.march_a5_plain(args[0]))
        rays = cfg.width * cfg.height
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            ops, bound_bytes(args[0], rays, samples, 8))
        per_volume[vname]["a5_lit_300"] = dict(
            variant="a5_baked", ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
            bake_ms=bake_ms, bound_ms=bound_ms, bound_by=bound_by,
            samples=samples)
        log(f"a5 {vname}/a5_lit_300: K3 baked {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, prep {prep_ms:.4f} ms (bake {bake_ms:.4f} "
            f"ms), needed samples per frame {samples}, bound {ops_ms:.4f} ms "
            f"(operations) / {bytes_ms:.4f} ms (bytes)")
        del args
        torch.cuda.empty_cache()
    return errs


def lit_render_phase(P, march, a5, volumes, tf, rng, per_volume) -> dict:
    """Phase 4c: 8 orbit frames per volume and lit config through
    ``render()`` after one warm-up -> the launches of each new variant,
    which must equal that variant's frames."""
    import torch

    configs = [(name, P.RenderConfig(early_termination=1e-3, **kw))
               for name, kw in LIT_CONFIGS.items()]
    configs.append(("a5_lit_300", P.RenderConfig(
        algorithm=P.Algorithm.TEST, early_termination=1e-3, **A5_LIT)))
    frames = {}
    reset_launches(march, a5)
    for cname, cfg in configs:
        for vname, vol in volumes.items():
            cams = orbit_cameras(P, rng)
            P.render(vol, tf, cams[-1], cfg)  # warm-up frame
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
            end.record()
            torch.cuda.synchronize()
            var = per_volume[vname][cname]["variant"]
            frames[var] = frames.get(var, 0) + len(imgs) + 1
            ms = start.elapsed_time(end) / len(imgs)
            for img in imgs:
                check(tuple(img.shape) == (cfg.width, cfg.height, 4),
                      f"{vname}/{cname}: shape {img.shape}")
                check(bool(torch.isfinite(img).all()),
                      f"{vname}/{cname}: not finite")
                fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                           .float().mean())
                check(fg > 0.01, f"{vname}/{cname}: background only ({fg})")
            r = per_volume[vname][cname]
            r["render_ms"] = ms
            log(f"{vname}/{cname}: render() {ms:.4f} ms/frame, "
                f"{cfg.width * cfg.height / ms * 1e3:.4e} rays/s; bake "
                f"{r['bake_ms']:.4f} ms, prep {r['prep_ms']:.4f} ms, kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    launches = {"lut": march.variant_launches["lut"],
                "baked": march.variant_launches["baked"],
                "lut_baked": march.variant_launches["lut_baked"],
                "a5_baked": a5.variant_launches["baked"]}
    log(f"lit render path launches by variant: {launches}, frames {frames}; "
        f"K1 plain {march.variant_launches['plain']}, K3 unlit "
        f"{a5.variant_launches['unlit']}")
    check(launches == frames, f"lit launches {launches} != frames {frames}")
    check(march.variant_launches["plain"] == 0
          and a5.variant_launches["unlit"] == 0,
          "a lit or LUT render launched an unlit variant")
    return launches


def lit_cli_phase(tmp: str) -> None:
    """Phase 5e: the CLI's lit and ``--config`` renders, a1 and a5."""
    cfg_path = os.path.join(tmp, "lut_phong.json")
    with open(cfg_path, "w") as f:
        json.dump({"width": 300, "height": 300, "samples_per_ray": 300,
                   "tf_lut": 256}, f)
    sobel = ["--width", "700", "--height", "700", "--spr", "250",
             "--lighting", "--gradient-filter", "sobel"]
    for name, flags, size in (
            ("sobel_a1", sobel, 700),
            ("sobel_a5", sobel + ["--algorithm", "test"], 700),
            ("config_lut_a1", ["--config", cfg_path, "--lighting"], 300),
            ("config_lut_a5", ["--config", cfg_path, "--lighting",
                               "--algorithm", "test"], 300)):
        out = os.path.join(tmp, f"{name}.png")
        run_cli(["render", "--data", "sphere", *flags, "--out", out])
        check_png(out, size, size)


def scan_cli_phase(tmp: str, from_text) -> None:
    """Phase 5k: the CLI ``fit --mode scan --lighting --conic --fit-light``
    at 64x64 pixels and 64 samples a ray, against its own scan render: the
    TF file parses, the fitted light is printed."""
    out = os.path.join(tmp, "scan_fit_tf.txt")
    stdout = run_cli(
        ["fit", "--data", "sphere", "--width", "64", "--height", "64",
         "--spr", "64", "--steps", "2", "--mode", "scan", "--lighting",
         "--conic", "--camera", "0.9,0.5,1.0", "--fit-light", "--out-tf",
         out])
    check("fitted light:" in stdout, "cli fit --mode scan: no light")
    with open(out) as f:
        check(from_text(f.read()).num_intervals == 4,
              "cli fit --mode scan: the TF file")


def bounds_moved(tf):
    """The default TF's bounds moved by the JAX bound-recovery test's
    offsets (tests/test_fit_params.py:188-192) -> (lower, upper)."""
    import torch

    dev = tf.lower.device
    return (tf.lower + torch.tensor([0.0, 0.06, -0.05, 0.04], device=dev),
            tf.upper + torch.tensor([0.0, -0.06, 0.05, -0.04], device=dev))


def smooth_edge_cases(P, tf, from_text):
    """Edge inputs of the smooth kernels at small shapes -> [(name, volume,
    tf, camera, config, eps)]: non-cubic 9x11x10 dims with negative voxels
    and cal_max 200.9, 61x37 pixels, K = 2, 4 and 16, sharpness 40, 200 and
    1000 (exp overflows to inf), ortho, conic and conic uncorrected, rays
    grazing the entry faces, alpha exactly 1, a front clip, eps 1e-3, a
    camera inside the volume (conic and ortho), a view whose rays all miss
    the box (the kernels' ranges are empty) and 6 samples a ray (a step of
    3.7 voxels)."""
    rng = np.random.default_rng(12)
    odd = P.make_volume(rng.uniform(-40, 255, (9, 11, 10)).astype(np.float32),
                        cal_max=200.9)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37,
                           interp=P.Interp.TRILINEAR)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    # axis-aligned ortho rays: columns in the -1 band of the x and y faces
    graze = P.Camera.initial(position=(0.0, 0.0, 1.2))
    k2 = from_text("empty 0 1 0.1 0.2 0.3 0.05\nbone 0.3 0.6 0.9 0.8 0.7 "
                   "0.6\n")
    colors = tf.colors.clone()
    colors[:, 3] = 1.0
    opaque = P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)
    k16 = tf16(P, tf.colors.device)
    inside = P.Camera.initial(position=(0.1, 0.05, 0.2))
    away = P.Camera(near.position, -near.front, near.right, near.up,
                    near.top_left)  # looks away from the volume
    return [
        ("k2_s200", odd, k2, near, small, 0.0),
        ("k4_s40", odd, tf, near, small.replace(tf_sharpness=40.0), 0.0),
        ("k4_s1000", odd, tf, near, small.replace(tf_sharpness=1000.0), 0.0),
        ("k16_s200", odd, k16, near, small, 0.0),
        ("k16_s1000_conic", odd, k16, near,
         small.replace(tf_sharpness=1000.0, conic=True), 0.0),
        ("conic", odd, tf, near, small.replace(conic=True), 0.0),
        ("conic_uncorrected", odd, tf, near,
         small.replace(conic=True, conic_corrected=False), 0.0),
        ("grazing_entry_faces", odd, tf, graze, small, 0.0),
        ("alpha_one", odd, opaque, near, small, 0.0),
        ("front_clip", odd, tf, near, small.replace(front_clip=0.5), 0.0),
        ("eps1e-3", odd, tf, near, small, 1e-3),
        ("camera_inside_volume_conic", odd, tf, inside,
         small.replace(conic=True), 0.0),
        ("camera_inside_volume_ortho", odd, tf, inside, small, 0.0),
        ("all_rays_miss", odd, tf, away, small, 0.0),
        ("step_longer_than_a_voxel", odd, tf, near,
         small.replace(samples_per_ray=6), 0.0),
    ]


def smooth_bwd_vs_plain(smooth_vjp, label, a, g) -> dict:
    """K9 (with the volume gradient) against march_smooth_bwd_plain +
    splat_volume_grad_plain -> each output's max abs error and its error
    relative to max |dplain|."""
    import torch

    got = smooth_vjp.march_smooth_bwd_kernel(a, *g, True)
    want = smooth_vjp.march_smooth_bwd_plain(a, *g, True)
    torch.cuda.synchronize()
    errs = {}
    for name, x, y in zip(("dcolors", "dlower", "dupper", "dvolume"), got,
                          want):
        check(bool(torch.isfinite(x).all()), f"{label}: {name} not finite")
        e_abs = float((x - y).abs().max())
        scale = float(y.abs().max())
        e_rel = e_abs / scale if scale > 0.0 else (0.0 if e_abs == 0.0
                                                   else math.inf)
        errs[name] = (e_abs, e_rel)
        check(e_rel <= TOL_GRAD, f"{label}: {name} relative error {e_rel}")
    check(float(want[0].abs().max()) > 0.0,
          f"{label}: the plain colour gradient is all zero")
    log(f"{label}: K9 vs plain (abs, relative to max |dplain|) "
        + ", ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in errs.items())
        + f" (tol {TOL_GRAD:g})")
    return errs


def smooth_alpha0(smooth, a) -> float:
    """The alpha of smooth march input ``a``'s samples off the volume:
    that of classify(0 / cal_max), as the kernels take it."""
    import torch

    zero = torch.zeros((), dtype=torch.float32, device=a.scal.device)
    return float(smooth.smooth_classify(a, zero)[0][3])


def smooth_bwd_ops(k: int, inside: float, total: float, rays: int,
                   splat: bool, a0: float) -> float:
    """Float operations K9 needs (FLOPS_PER_SMOOTH_BWD_*), where the
    samples off the volume have alpha ``a0``."""
    per = (FLOPS_PER_SMOOTH_BWD_SAMPLE
           + (k - 1) * FLOPS_PER_SMOOTH_BWD_SAMPLE_PER_INTERVAL
           + (FLOPS_PER_SMOOTH_SPLAT_SAMPLE if splat else 0))
    return (inside * per + bwd_outside_ops(total - inside, rays, a0)
            + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL + FLOPS_PER_BWD_RAY))


def smooth_fd_check(P, smooth_vjp, vol, tf, cfg, rng) -> float:
    """Central differences of the loss at 700x700x500 in the three TF bounds
    and the three voxels of largest gradient, against K9's gradient -> the
    largest relative error."""
    import dataclasses

    import torch

    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg)
    lower, upper = bounds_moved(tf)
    lo = lower.clone().requires_grad_()
    hi = upper.clone().requires_grad_()
    data = vol.data.clone().requires_grad_()

    def loss_of(lo_, hi_, data_):
        img = smooth_vjp.render_vrc_smooth_diff(
            dataclasses.replace(vol, data=data_),
            P.TransferFunction(lo_, hi_, tf.colors, tf.hg_g), cam, cfg)
        return ((img[..., :3] - target[..., :3]).double() ** 2).mean()

    loss_of(lo, hi, data).backward()
    worst = 0.0
    with torch.no_grad():
        # the three bounds and the three voxels of largest gradient
        both = torch.cat([lo.grad[1:], hi.grad[1:]]).abs()
        k1 = lo.numel() - 1
        probes = []
        for j in torch.topk(both, 3).indices.tolist():
            which, idx = (0, j + 1) if j < k1 else (1, j - k1 + 1)
            probes.append((f"{('lower', 'upper')[which]}[{idx}]", which, idx))
        flat = data.grad.reshape(-1).abs()
        for idx in torch.topk(flat, 3).indices.tolist():
            probes.append((f"voxel {idx}", 2, idx))
        for name, which, idx in probes:
            h = SMOOTH_FD_VOXEL_STEP if which == 2 else SMOOTH_FD_BOUND_STEP
            grad = [lo.grad, hi.grad, data.grad.reshape(-1)][which][idx]
            ls = []
            for sign in (1.0, -1.0):
                args = [lower.clone(), upper.clone(), vol.data.clone()]
                args[which].reshape(-1)[idx] += sign * h
                ls.append(float(loss_of(*args)))
            fd = (ls[0] - ls[1]) / (2.0 * h)
            err = abs(fd - float(grad)) / abs(float(grad))
            worst = max(worst, err)
            log(f"smooth central difference {name}: step {h:g}, "
                f"{fd:.6e} vs gradient {float(grad):.6e} (relative err "
                f"{err:.3e}, tol {TOL_FD:g})")
            check(err <= TOL_FD, f"smooth central difference {name}: {err}")
    return worst


def range_share(smooth, a, touching: int, label: str) -> int:
    """Samples in the kernels' per-ray ranges (``smooth.sample_range``) of
    march input ``a``, logged against the ``touching`` samples with a
    corner in the volume (the plain version's ``stats["inside"]`` at eps
    0) -> the samples in range."""
    i_lo, i_hi = smooth.sample_range(a)
    in_range = int((i_hi - i_lo + 1).clamp_min(0).sum())
    total = a.width * a.height * a.spr
    log(f"{label}: samples in the per-ray ranges {in_range} of {total} "
        f"({in_range / total:.4f}), with a corner in the volume {touching} "
        f"({touching / total:.4f}); ranges over touching "
        f"{in_range / max(touching, 1):.4f}")
    check(in_range >= touching, f"{label}: fewer samples in range than touch")
    return in_range


def k4_span_check(march, march_vjp, a, g, label) -> dict:
    """K4's spans of march input ``a`` (``march_vjp.sample_range``, the
    kernel's float order) against the chain on the card: no sample whose
    chain gives a voxel outside the chain's span, no sample the unit owns
    outside the samples K4 visits, every constant sample owned and off the
    volume; logs the samples in the chain's span against those that touch
    the volume.  Then what the kernel's own spans give: its per-block
    partials under cotangents ``g`` within TOL_SPAN_F64 of the float64
    sums of march_bwd_plain's terms over each block's rays (exactly 0
    where those are) -> the counts and that error."""
    import torch

    r = march_vjp.sample_range(a)
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    keys = ("touch", "chain", "full", "visited", "touch_out", "owned_out",
            "const_bad")
    n = {k: torch.zeros((), dtype=torch.int64, device=a.scal.device)
         for k in keys}
    for i in range(a.s_start, a.s_start + a.spr):
        _, valid, _, ijk = ids_at(i)
        owned = (march.owned_by(a, ijk) if a.slab_x
                 else torch.ones_like(valid))
        vis, full = r.visits(i), r.full(i)
        chain = vis & (i >= r.chain_lo) & (i <= r.chain_hi)
        for k, m in (("touch", valid), ("chain", chain), ("full", full),
                     ("visited", vis), ("touch_out", valid & ~chain),
                     ("owned_out", owned & ~vis),
                     ("const_bad", vis & ~full & (valid | ~owned))):
            n[k] += m.sum()
    n = {k: int(v) for k, v in n.items()}
    total = a.width * a.height * a.spr
    log(f"{label}: K4 samples in the chain's span {n['chain']} of {total} "
        f"({n['chain'] / total:.4f}), run in full {n['full']}, visited "
        f"{n['visited']}, touching the volume {n['touch']} "
        f"({n['touch'] / total:.4f}); span over touching "
        f"{n['chain'] / max(n['touch'], 1):.4f}; touching outside the span "
        f"{n['touch_out']}, owned outside the visited {n['owned_out']}, "
        f"constant but touching or not owned {n['const_bad']} (each must be "
        "0)")
    check(n["touch_out"] == 0 and n["owned_out"] == 0
          and n["const_bad"] == 0, f"{label}: K4's spans leave out samples")
    got = march_vjp.march_bwd_kernel(a, *g, per_block=True).double()
    exact = march_vjp.block_sums(
        march_vjp.march_bwd_plain(a, *g, per_ray=True), a.width, a.height)
    scale = float(exact.abs().max())
    e_abs = float((got - exact).abs().max())
    e_rel = e_abs / scale if scale > 0.0 else (0.0 if e_abs == 0.0
                                               else math.inf)
    log(f"{label}: K4's {got.shape[0]} block partials vs the float64 sums of "
        f"the plain terms, max err {e_abs:.3e}, {e_rel:.3e} of their largest "
        f"(tol {TOL_SPAN_F64:g})")
    check(e_rel <= TOL_SPAN_F64, f"{label}: K4's block partials off the "
          f"float64 sums by {e_rel} of their largest")
    n["f64_rel"] = e_rel
    return n


def near_parallel_args(march, a, face: int, side: int, d_face: float):
    """March input ``a`` (a whole-volume render) recast as 64x8 ortho rays
    that run within ``d_face`` of parallel to face ``face`` (side 0: the
    low face, 1: the high one) of the volume's box, inwards, and cross its
    plane between t = -0.8 and 1.2 (z = 0 at 1.2), sampled to t = 2: there the
    position's last bit moves the crossing by ulp / d_face in t, 0.6 at
    1e-7, some ten samples (tests/test_torch_march_bwd_range.py)."""
    import torch

    L = float(max(a.dims))
    n = float(2 ** a.depth)
    hg = L / 2 - a.dims[face] / 2
    edge = hg + (0 if side == 0 else a.dims[face])
    plane = np.ceil(edge / L * n) / n - 0.5  # the leaf boundary at the edge
    d = np.array([0.0, 0.0, -1.0])
    d[face] = d_face if side == 0 else -d_face
    d = d / np.linalg.norm(d)
    tl = [0.01, -0.02, 1.2]
    tl[face] = plane - d[face] * 1.2
    right = np.zeros(3)
    right[face] = d[face] * 2.0 / 64
    up = np.zeros(3)
    up[1 - face] = -1e-3
    s = a.scal.clone()
    for slot, v in ((march.S_TL, tl), (march.S_FRONT, d),
                    (march.S_RIGHT, right), (march.S_UP, up)):
        s[slot:slot + 3] = torch.tensor(v, dtype=torch.float32)
    s[march.S_RSW], s[march.S_RSH] = 64.0, 8.0
    spr = int(2.0 / float(s[march.S_DS])) + 2
    return a._replace(scal=s, width=64, height=8, spr=spr, conic=False,
                      x_offset=0, full_width=0, s_start=0)


def k4_in_turns(march_vjp, libs, units, label) -> dict:
    """K4 over ``units`` ([(march input, (g_rgb, g_t))]) of every tree of
    ``libs`` ({tree: {source: library}}), launched straight through its C
    function with this tree's arguments (the C signature is the same) into
    partials that fit any block shape, timed in turns -> {tree: ms a
    unit}."""
    import torch

    a = units[0][0]
    dev = a.scal.device
    rows = max(u.width * u.height for u, _ in units)
    partials = torch.empty((rows, a.colors.shape[0], 4), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def runs(lib):
        fn = march_vjp.bind(lib["march_bwd"]).vrp_march_bwd_a1

        def run():
            for u, g in units:
                check(fn(*march_vjp.kernel_args(u, *g, partials), stream)
                      == 0, f"{label}: K4 launch failed")
        return {f"K4 x{len(units)}": run}

    means = time_in_turns({t: runs(lib) for t, lib in libs.items()}, label)
    return {t: next(iter(m.values())) / len(units) for t, m in means.items()}


# the sources timed against another checkout's
TREE_SOURCES = ("smooth", "smooth_bwd", "march_bwd")


def start_tree_build(_build, tree: str):
    """Start ``nvcc`` on the TREE_SOURCES of checkout ``tree`` (a directory
    holding ``volumerenderingproject_tpu_torch/csrc/``), one process a
    source, into ``build/trees/<tree's name>/`` -> {source: (process,
    library)}."""
    tree = os.path.abspath(tree)
    out = _build.BUILD_DIR.parent / "trees" / os.path.basename(tree)
    out.mkdir(parents=True, exist_ok=True)
    csrc = os.path.join(tree, "volumerenderingproject_tpu_torch", "csrc")
    procs = {}
    for name in TREE_SOURCES:
        lib = str(out / f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    return procs


def tree_libs(build) -> dict:
    """A tree's libraries, once ``start_tree_build``'s processes have ended
    -> {source: ctypes.CDLL}."""
    import ctypes

    libs = {}
    for name, (proc, lib) in build.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"{lib}: nvcc exit {proc.returncode}: "
              f"{text}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def smooth_runs(smooth, smooth_vjp, libs, args8, a9, g) -> dict:
    """{name: fn}: K8 over the march inputs ``args8`` and K9 on ``a9`` with
    cotangents ``g``, without and with the splat, launched straight
    through the C functions of ``libs`` (a tree's smooth kernels), with no
    wrapper around them, into buffers that fit any block shape (a block
    holds a pixel at least): so every tree's kernels run alike, whatever
    its blocks.  The partials are not summed; the volume gradient adds
    up over the calls."""
    import torch

    fwd = smooth.bind(libs["smooth"]).vrp_smooth_fwd
    bwd = smooth_vjp.bind(libs["smooth_bwd"]).vrp_smooth_bwd
    dev = a9.data.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((args8[0].width, args8[0].height, 4), device=dev)
    k = a9.colors.shape[0]
    partials = torch.empty((a9.width * a9.height, k, smooth_vjp.NCOLS),
                           device=dev)
    dvol = torch.zeros(a9.dims, device=dev)

    def march_args(a):
        return (a.scal.data_ptr(), a.lower.data_ptr(), a.upper.data_ptr(),
                a.colors.data_ptr(), a.colors.shape[0], a.data.data_ptr(),
                *a.dims, a.width, a.height, a.spr, int(a.conic))

    def k8():
        for a in args8:
            check(fwd(*march_args(a), out.data_ptr(), stream) == 0,
                  "K8 launch failed")

    def k9(splat):
        def run():
            check(bwd(*march_args(a9), g[0].data_ptr(), g[1].data_ptr(),
                      partials.data_ptr(),
                      dvol.data_ptr() if splat else None, stream) == 0,
                  "K9 launch failed")
        return run

    return {f"K8 x{len(args8)}": k8, "K9": k9(False),
            "K9 with the splat": k9(True)}


def time_in_turns(runs: dict, label: str) -> dict:
    """Every tree's runs ({tree: {name: fn}}) timed in turns, the trees in
    order and then in reverse (for two: parent, this tree, this tree,
    parent), each a ``timed_ms`` -> {tree: {name: the mean of its two
    turns, ms}}."""
    order = list(runs) + list(reversed(runs))
    times = {t: {n: [] for n in fns} for t, fns in runs.items()}
    for tree in order:
        for name, fn in runs[tree].items():
            times[tree][name].append(timed_ms(fn, 5, prefill=True))
    means = {t: {n: sum(v) / len(v) for n, v in d.items()}
             for t, d in times.items()}
    for name in next(iter(runs.values())):
        log(f"{label}: {name} in turns, ms: " + "; ".join(
            f"{t} {[round(x, 5) for x in times[t][name]]} mean "
            f"{means[t][name]:.4f}" for t in runs))
    return means


def smooth_kernel_phases(P, smooth, smooth_vjp, volumes, tf, from_text, rng,
                         per_volume, libs=None) -> dict:
    """Phases 3g (K8 against march_smooth_plain) and 3h (K9 against
    march_smooth_bwd_plain + splat_volume_grad_plain, the samples in range
    and the central differences) -> the errors; times and bounds go into
    ``per_volume``; with ``libs`` ({tree: {source: library}}, this tree's
    and another checkout's) K8 and K9 of both trees are timed in turns."""
    import torch

    orbits = {}  # each volume's K8 orbit, for the timing in turns

    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR,
                         interp=P.Interp.TRILINEAR)
    k8_err = 0.0

    def k8_vs_plain(label, a):
        got = smooth.march_smooth_kernel(a)
        want = smooth.march_smooth_plain(a)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: not finite")
        e = float((got - want).abs().max())
        log(f"{label}: K8 vs plain max err {e:.3e} (tol {TOL_SMOOTH:g})")
        check(e <= TOL_SMOOTH, f"{label}: max err {e}")
        return got, want, e

    # ---- 3g. K8 ----------------------------------------------------------
    edges = smooth_edge_cases(P, tf, from_text)
    for name, vol, tfx, cam, c, eps in edges:
        k8_err = max(k8_err, k8_vs_plain(
            f"smooth edge/{name}",
            smooth.prepare_smooth(vol, tfx, cam, c, eps))[2])
    for vname, vol in volumes.items():
        orbit_cam = orbit_cameras(P, rng, 1)[0]
        _, exact, e = k8_vs_plain(f"smooth {vname}/ortho_orbit_eps0",
                                  smooth.prepare_smooth(vol, tf, orbit_cam,
                                                        cfg, 0.0))
        k8_err = max(k8_err, e)
        got = smooth.march_smooth_kernel(
            smooth.prepare_smooth(vol, tf, orbit_cam, cfg, 1e-3))
        e2 = float((got - exact).abs().max())
        log(f"smooth {vname}: K8 at eps 1e-3 vs exact plain max err {e2:.3e}"
            f" (tol {TOL_EPS:g})")
        check(e2 <= TOL_EPS, f"smooth {vname}: eps error {e2}")
        k8_err = max(k8_err, k8_vs_plain(
            f"smooth {vname}/conic_eps0", smooth.prepare_smooth(
                vol, tf, P.Camera.initial(position=(0.9, 0.5, 1.0)),
                cfg.replace(conic=True), 0.0))[2])

        # K8 and plain times and the bound, at the render path's inputs
        cams = orbit_cameras(P, rng)
        main_cfg = cfg.replace(early_termination=1e-3)
        args = [smooth.prepare_smooth(vol, tf, cam, main_cfg, 1e-3)
                for cam in cams]

        def orbit_kernels():
            for x in args:
                smooth.march_smooth_kernel(x)

        ms = timed_ms(orbit_kernels, 5, prefill=True,
                      label=f"smooth {vname}: K8 x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: smooth.prepare_smooth(
            vol, tf, cams[0], main_cfg, 1e-3), 5)
        live = inside = 0
        for x in args:
            stats = {}
            smooth.march_smooth_plain(x, stats)
            live += stats["samples"] / FRAMES
            inside += stats["inside"] / FRAMES
        # the stats loop ran it
        plain_ms = time_plain(lambda: smooth.march_smooth_plain(args[0]))
        orbits[vname] = (cams, main_cfg)
        k = tf.num_intervals
        rays = W * H
        ops = (inside * (FLOPS_PER_SMOOTH_SAMPLE
                         + (k - 1) * FLOPS_PER_SMOOTH_SAMPLE_PER_INTERVAL)
               + (live - inside) * FLOPS_PER_SMOOTH_OUTSIDE_SAMPLE
               + rays * FLOPS_PER_SMOOTH_RAY)
        nbytes = (read_bytes(vol.data.numel() * 4, inside * 32) + k * 24
                  + rays * 16)  # 8 f32 corners a sample with one in the volume
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
        per_volume[vname]["smooth"] = dict(
            ms=ms, plain_ms=plain_ms, prep_ms=prep_ms, bound_ms=bound_ms,
            bound_by=bound_by, samples=live, inside=inside)
        log(f"smooth {vname}: K8 {ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
            f"{prep_ms:.4f} ms, samples per frame {live} on live rays "
            f"({inside} with a corner in the volume), bound {ops_ms:.4f} ms "
            f"(operations) / {bytes_ms:.4f} ms (bytes)")
        del args

    # ---- 3h. K9 ----------------------------------------------------------
    grad_rng = np.random.default_rng(13)
    k9 = {}

    def note(errs):
        for name, (e_abs, e_rel) in errs.items():
            a0, r0 = k9.get(name, (0.0, 0.0))
            k9[name] = (max(a0, e_abs), max(r0, e_rel))

    for name, vol, tfx, cam, c, eps in edges:
        if eps != 0.0:
            continue  # the differentiable march runs at eps 0
        a = smooth_vjp.prepare_smooth_diff(vol, tfx, cam, c)
        note(smooth_bwd_vs_plain(smooth_vjp, f"smooth edge/{name}", a,
                                 cotangents(a, grad_rng)))
    bwd_cam = orbit_cameras(P, np.random.default_rng(14), 1)[0]
    for vname, vol in volumes.items():
        cases = [("ortho_orbit", bwd_cam, cfg)]
        if vname == "sphere100":
            cases.append(("conic", P.Camera.initial(position=(0.9, 0.5, 1.0)),
                          cfg.replace(conic=True)))
        for name, cam, c in cases:
            a = smooth_vjp.prepare_smooth_diff(vol, tf, cam, c)
            g = cotangents(a, grad_rng)
            note(smooth_bwd_vs_plain(smooth_vjp, f"smooth {vname}/{name}", a,
                                     g))
            if c.conic:
                continue
            ms = timed_ms(lambda: smooth_vjp.march_smooth_bwd_kernel(a, *g),
                          5, prefill=True, label=f"smooth {vname}: K9")
            splat_ms = timed_ms(
                lambda: smooth_vjp.march_smooth_bwd_kernel(a, *g, True), 5,
                prefill=True, label=f"smooth {vname}: K9 with the splat")
            # the check above ran the plain backward with the splat, whose
            # operations without it are a part
            plain_ms = time_plain(
                lambda: smooth_vjp.march_smooth_bwd_plain(a, *g))
            plain_splat_ms = time_plain(
                lambda: smooth_vjp.march_smooth_bwd_plain(a, *g, True))
            fwd_ms = timed_ms(lambda: smooth.march_smooth_kernel(a), 5,
                              prefill=True)
            stats = {}
            smooth.march_smooth_plain(a, stats)
            in_range = range_share(smooth, a, stats["inside"],
                                   f"smooth {vname}/{name}")
            if libs is not None:
                cams, main_cfg = orbits[vname]
                args8 = [smooth.prepare_smooth(vol, tf, cam, main_cfg, 1e-3)
                         for cam in cams]
                per_volume[vname]["smooth_in_turns"] = time_in_turns(
                    {t: smooth_runs(smooth, smooth_vjp, lib, args8, a, g)
                     for t, lib in libs.items()}, f"smooth {vname}")
                del args8
            k = a.colors.shape[0]
            rays = W * H
            total = rays * SPR
            nbytes = (read_bytes(vol.data.numel() * 4, stats["inside"] * 32)
                      + rays * 16 + k * 24
                      + smooth_vjp.num_blocks(W, H) * k * 24)
            a0 = smooth_alpha0(smooth, a)
            b = bound(smooth_bwd_ops(k, stats["inside"], total, rays, False,
                                     a0), nbytes)
            bs = bound(smooth_bwd_ops(k, stats["inside"], total, rays, True,
                                      a0), nbytes + vol.data.numel() * 4)
            per_volume[vname]["smooth"].update(
                bwd_ms=ms, bwd_splat_ms=splat_ms, bwd_plain_ms=plain_ms,
                bwd_plain_splat_ms=plain_splat_ms, fwd_eps0_ms=fwd_ms,
                bwd_bound_ms=b[0], bwd_bound_by=b[1], bwd_splat_bound_ms=bs[0],
                bwd_splat_bound_by=bs[1], bwd_inside=stats["inside"],
                bwd_in_range=in_range)
            log(f"smooth {vname}: K9 {ms:.4f} ms, with the splat "
                f"{splat_ms:.4f} ms; plain {plain_ms:.2f} ms, with the splat "
                f"{plain_splat_ms:.2f} ms; K8 at eps 0 {fwd_ms:.4f} ms; "
                f"samples with a corner in the volume {stats['inside']} of "
                f"{total}; bound {b[0]:.4f} ms ({b[1]}), with the splat "
                f"{bs[0]:.4f} ms ({bs[1]})")
    fd_err = smooth_fd_check(P, smooth_vjp, volumes["mni_dims_182x218x182"],
                             tf, cfg, np.random.default_rng(15))
    return dict(k8=k8_err, k9=k9, fd=fd_err)


def smooth_render_phase(P, smooth, volumes, tf, rng, per_volume) -> int:
    """Phase 4d: 8 orbit frames per volume after one warm-up through
    ``render()`` with Interp.TRILINEAR at eps 1e-3 -> K8's launches, which
    must equal the frames."""
    import torch

    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR,
                         interp=P.Interp.TRILINEAR, early_termination=1e-3)
    frames = 0
    smooth.launches = 0
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], cfg)  # warm-up frame
        frames += 1
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        frames += len(imgs)
        ms = start.elapsed_time(end) / len(imgs)
        for img in imgs:
            check(tuple(img.shape) == (W, H, 4),
                  f"smooth {vname}: shape {img.shape}")
            check(bool(torch.isfinite(img).all()),
                  f"smooth {vname}: not finite")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"smooth {vname}: background only ({fg})")
        per_volume[vname]["smooth"]["render_ms"] = ms
        log(f"smooth {vname}: render() {ms:.4f} ms/frame, "
            f"{W * H / ms * 1e3:.4e} rays/s")
    launches = smooth.launches
    log(f"K8 launches on the smooth render path: {launches} for {frames} "
        f"frames")
    check(launches == frames, f"smooth launches {launches} != frames {frames}")
    return launches


def smooth_cli_phase(tmp: str, tf, from_text) -> None:
    """Phase 5f: the CLI ``render --interp trilinear`` and ``fit --interp
    trilinear --fit-bounds``."""
    import torch

    size = ["--width", str(W), "--height", str(H), "--spr", str(SPR)]
    out = os.path.join(tmp, "sphere_smooth.png")
    run_cli(["render", "--data", "sphere", *size, "--interp", "trilinear",
             "--out", out])
    check_png(out, W, H)
    out_tf = os.path.join(tmp, "fitted_bounds.txt")
    run_cli(["fit", "--data", "sphere", *size, "--interp", "trilinear",
             "--fit-bounds", "--target", out, "--steps", "3", "--lr",
             str(RECOVERY_LR), "--out-tf", out_tf])
    with open(out_tf) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == tf.num_intervals
          and all(bool(torch.isfinite(t).all())
                  for t in (fitted.colors, fitted.lower, fitted.upper)),
          "cli smooth fit wrote a bad transfer function")


def bound_recovery_phase(P, fit, smooth, smooth_vjp) -> dict:
    """Phase 7d: tests/test_fit_params.py:181-201 on the card through K8
    and K9: 80 steps at lr 5e-3 from bounds moved by the test's offsets,
    sharpness 40; the last loss must be below 0.35 of the first and the
    mean bound error must fall."""
    rng = np.random.default_rng(11)
    vol = P.make_volume(rng.uniform(0.0, 255.0, size=(9, 11, 10))
                        .astype(np.float32))
    tf = P.default_transfer_function()
    cam = P.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = P.RenderConfig(width=18, height=13, samples_per_ray=30,
                         interp=P.Interp.TRILINEAR, tf_sharpness=40.0)
    target = P.render(vol, tf, cam, cfg)
    lower, upper = bounds_moved(tf)
    start = P.TransferFunction(lower, upper, tf.colors, tf.hg_g)
    smooth.launches = smooth_vjp.launches = 0
    params, losses = fit.fit_transfer_function(
        vol, cam, target, start, cfg, steps=RECOVERY_STEPS,
        learning_rate=RECOVERY_LR, fit_bounds=True)
    launches = (smooth.launches, smooth_vjp.launches)
    err0 = float((lower - tf.lower).abs().mean())
    err1 = float((params.tf_lower.detach() - tf.lower).abs().mean())
    log(f"bound recovery: loss {losses[0]:.6g} -> {losses[-1]:.6g} in "
        f"{RECOVERY_STEPS} steps (must fall below 0.35 of the first: "
        f"{losses[-1] / losses[0]:.4f}), mean lower-bound error {err0:.5f} "
        f"-> {err1:.5f}, launches K8 {launches[0]} K9 {launches[1]}")
    check(launches == (RECOVERY_STEPS, RECOVERY_STEPS),
          f"bound recovery launches {launches}")
    check(losses[-1] < 0.35 * losses[0], "bound recovery: loss did not fall")
    check(err1 < err0, "bound recovery: the bound error did not fall")
    return dict(loss_ratio=losses[-1] / losses[0], err0=err0, err1=err1)


def volume_grad_phase(P, smooth, smooth_vjp, vol, tf, rng) -> dict:
    """Phase 7e: a forward and backward render with ``volume.data``
    requiring grad at 700x700x500 (K8, then K9 with the splat), 5 times
    after one warm-up, its ms by CUDA events and its launches."""
    import dataclasses

    import torch

    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR,
                         interp=P.Interp.TRILINEAR)
    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg)
    lower, upper = bounds_moved(tf)
    moved = P.TransferFunction(lower, upper, tf.colors, tf.hg_g)

    def step():
        data = vol.data.clone().requires_grad_()
        img = smooth_vjp.render_vrc_smooth_diff(
            dataclasses.replace(vol, data=data), moved, cam, cfg)
        torch.mean((img[..., :3] - target[..., :3]) ** 2).backward()
        return data.grad

    step()
    torch.cuda.synchronize()
    smooth.launches = smooth_vjp.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FIT_STEPS):
        grad = step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FIT_STEPS
    launches = (smooth.launches, smooth_vjp.launches)
    nz = int((grad != 0).sum())
    log(f"volume-gradient step (MNI-dims): {ms:.4f} ms, launches K8 "
        f"{launches[0]} K9 {launches[1]} for {FIT_STEPS} steps, "
        f"{nz} voxels with a nonzero gradient, max |grad| "
        f"{float(grad.abs().max()):.4e}")
    check(launches == (FIT_STEPS, FIT_STEPS),
          f"volume-gradient launches {launches}")
    check(bool(torch.isfinite(grad).all()) and nz > 0,
          "volume gradient not finite or all zero")
    return dict(ms=ms, k8=launches[0], k9=launches[1])


def tf_alpha_above_one(P, tf):
    """``tf`` with the alphas of intervals 1-3 at ALPHA_ABOVE_ONE."""
    colors = tf.colors.clone()
    colors[1:, 3] = ALPHA_ABOVE_ONE
    return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


def f1_phase(P, march, a5, smooth, volumes, tf, rng) -> dict:
    """Phase 3i: a TF alpha above 1, which makes T negative on rays through
    it.  K1 (plain at 700x700x500, the lit configs' variants), K3 (a5 500^3)
    and K8 (smooth 700x700x500) against their plain versions at eps 0 on
    both volumes, each bit-exact; then small renders through ``render()``
    against the plain scan, which composites on with T < 0 -> {kernel: max
    abs err}."""
    import torch

    tf12 = tf_alpha_above_one(P, tf)
    cases = [("a1", march, P.RenderConfig(width=W, height=H,
                                          samples_per_ray=SPR))]
    cases += [(cname, march, P.RenderConfig(**kw))
              for cname, kw in LIT_CONFIGS.items()]
    cases += [("a5", a5, P.RenderConfig(
        width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
        algorithm=P.Algorithm.TEST)),
        ("smooth", smooth, P.RenderConfig(width=W, height=H,
                                          samples_per_ray=SPR,
                                          interp=P.Interp.TRILINEAR))]
    fns = {march: (march.prepare, march.march_kernel, march.march_plain),
           a5: (a5.prepare_a5, a5.march_a5_kernel, a5.march_a5_plain),
           smooth: (smooth.prepare_smooth, smooth.march_smooth_kernel,
                    smooth.march_smooth_plain)}
    errs = {}
    for vname, vol in volumes.items():
        cam = orbit_cameras(P, rng, 1)[0]
        for cname, mod, cfg in cases:
            prep, kernel, plain = fns[mod]
            a = prep(vol, tf12, cam, cfg, 0.0)
            name = {a5: "K3", smooth: "K8"}.get(mod)
            if name is None:
                name = f"K1 {march.variant(a)}"
            e = exact_vs_plain(kernel, plain,
                               f"F1 {vname}/{cname} ({name})", a)[2]
            errs[name] = max(errs.get(name, 0.0), e)
            del a
        torch.cuda.empty_cache()
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    for vname, vol in volumes.items():
        cam = orbit_cameras(P, rng, 1)[0]
        for cname, kw in (("a1", {}), ("a1 LUT 256", dict(tf_lut=256)),
                          ("a1 lit", dict(lighting=True)),
                          ("a1 lit LUT 256", dict(lighting=True,
                                                  tf_lut=256)),
                          ("a5", dict(algorithm=P.Algorithm.TEST)),
                          ("smooth", dict(interp=P.Interp.TRILINEAR))):
            c = small.replace(**kw)
            got = P.render(vol, tf12, cam, c)
            ref = P.render(vol, tf12, cam, c, mode="scan")
            e = float((got - ref).abs().max())
            log(f"F1 {vname}/{cname} 100x100x100: kernel vs plain scan max "
                f"err {e:.3e} (tol {TOL_EXACT:g})")
            check(e <= TOL_EXACT, f"F1 {vname}/{cname}: kernel vs scan {e}")
        # with black colours and a white background the image is T_N
        black = P.TransferFunction(tf12.lower, tf12.upper, torch.cat(
            [torch.zeros_like(tf12.colors[:, :3]), tf12.colors[:, 3:]], 1),
            tf12.hg_g)
        t_n = P.render(vol, black, cam, small.replace(
            background=(1.0, 1.0, 1.0)), mode="scan")[..., 0]
        log(f"F1 {vname}: {int((t_n < 0).sum())} of {t_n.numel()} rays end "
            f"with T < 0 (min {float(t_n.min()):.4f})")
    log(f"F1 kernel vs plain max abs err by kernel: {errs}")
    return errs


def plain_fwd_a1(march, march_vjp):
    """The plain version of the differentiable a1 forward (the LUT's
    entries taken as the kernel's wrapper takes them)."""
    return lambda a: march.march_plain(march_vjp._fwd_args(a))


def k4_variant_phases(P, march, march_vjp, volumes, tf, from_text, rng,
                      per_volume, libs=None) -> dict:
    """Phase 3j: K4's baked, LUT and LUT + baked variants against
    ``march_bwd_plain`` on edge inputs (K = 2, 4, 16; an interval of alpha
    1; TF(0).alpha 0.05 and 1; a front clip; LUT sizes 64, 256, 1024; rays
    that miss the box; a step longer than a voxel) and at each variant's
    main config on both volumes (K4_VARIANT_CONFIGS); each variant's time,
    the plain version's and the bound
    at those shapes, and with ``libs`` ({tree: {source: library}}) the
    times of this tree and another checkout in turns -> {variant: [max abs
    err, max err relative to max |dplain|]}."""
    import torch

    errs = {v: [0.0, 0.0] for v in K4_VARIANT_CONFIGS}
    grad_rng = np.random.default_rng(13)
    edge_rng = np.random.default_rng(12)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    two = from_text("low 0 0.4 0.2 0.3 0.4 0.3\nhigh 0.4 1 0.9 0.8 0.7 0.6\n")
    away = away_camera(P, (0.9, 0.5, 1.0))
    tfs = [("k2", two), ("k4", tf), ("k16", tf16(P, tf.colors.device)),
           ("alpha_one", tf_with_alpha(P, tf, 3, 1.0)),
           ("alpha0_0.05", tf_with_alpha(P, tf, 0, 0.05)),
           ("alpha0_one", tf_with_alpha(P, tf, 0, 1.0))]
    edges = []
    for var, kw in (("baked", dict(lighting=True)),
                    ("lut", dict(tf_lut=256)),
                    ("lut_baked", dict(tf_lut=256, lighting=True))):
        edges += [(var, name, tfx, near, small.replace(**kw))
                  for name, tfx in tfs]
        edges.append((var, "front_clip", tf, near,
                      small.replace(front_clip=0.5, **kw)))
        edges.append((var, "all_rays_miss", tf, away, small.replace(**kw)))
        edges.append((var, "step_longer_than_a_voxel", tf, near,
                      small.replace(samples_per_ray=6, **kw)))
        if var != "baked":
            edges += [(var, f"lut{n}", tf, near,
                       small.replace(**dict(kw, tf_lut=n)))
                      for n in (64, 1024)]
    for var, name, tfx, cam, c in edges:
        a, _ = march_vjp.prepare_diff(odd, tfx, cam, c)
        check(march.variant(a) == var, f"{name}: variant {march.variant(a)}")
        e_abs, e_rel = bwd_vs_plain(
            march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
            f"K4 {var} edge/{name}", a, cotangents(a, grad_rng))
        errs[var] = [max(errs[var][0], e_abs), max(errs[var][1], e_rel)]
    plain_fwd = plain_fwd_a1(march, march_vjp)
    for var, (cname, kw) in K4_VARIANT_CONFIGS.items():
        cfg = P.RenderConfig(**kw)
        for vname, vol in volumes.items():
            cam = orbit_cameras(P, rng, 1)[0]
            a, _ = march_vjp.prepare_diff(vol, tf, cam, cfg)
            check(march.variant(a) == var, f"{cname}: variant {var}")
            g = cotangents(a, grad_rng)
            label = f"K4 {var} {vname}/{cname}"
            e_abs, e_rel = bwd_vs_plain(
                march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain, label,
                a, g)
            errs[var] = [max(errs[var][0], e_abs), max(errs[var][1], e_rel)]
            ms = timed_ms(lambda: march_vjp.march_bwd_kernel(a, *g), 5,
                          prefill=True, label=label)
            in_turns = (None if libs is None else
                        k4_in_turns(march_vjp, libs, [(a, g)], label))
            plain_ms = time_plain(lambda: march_vjp.march_bwd_plain(a, *g))
            rays = cfg.width * cfg.height
            samples = rays * cfg.samples_per_ray  # every sample: no skip
            # at eps 0 no ray stops early: the samples inside the volume
            inside = samples_needed(lambda x, st: march.march_plain(
                march_vjp._fwd_args(x), st), [a])
            k = a.colors.shape[0]
            baked = a.mgrid is not None
            nbytes = (read_bytes(a.ids.numel() * a.ids.element_size(),
                                 inside * a.ids.element_size()) + rays * 16
                      + k * 16 + march_vjp.num_blocks(cfg.width, cfg.height)
                      * k * 16)
            if a.itv is not None:
                nbytes += a.itv.numel()
            if baked:
                nbytes += 8 * min(inside, a.mgrid.numel())
            ops = (inside * (FLOPS_PER_BWD_SAMPLE
                             + (FLOPS_PER_BWD_BAKED_SAMPLE if baked else 0))
                   + bwd_outside_ops(samples - inside, rays,
                                     bwd_alpha0(a, march.S_ID0))
                   + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                             + FLOPS_PER_BWD_RAY))
            bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
            per_volume[vname][f"k4_{var}"] = dict(
                config=cname, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, inside=inside, err_abs=e_abs,
                err_rel=e_rel, in_turns=in_turns)
            log(f"{label}: K4 {var} {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                f"samples inside the volume {inside} of {samples}, bound "
                f"{ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")
            del a, g
            torch.cuda.empty_cache()
    log(f"K4 variants max errors (abs, relative): {errs}")
    return errs


def lit_fit_start(P, phong, tf, rng, light_fit: bool):
    """(start TF, start light or None): a colour fit starts from the
    default TF with colours 1..3 moved by a seeded +-0.2 (as phase 7); a
    light fit from the default TF and the JAX light-recovery test's light
    (ambient 0.7, diffuse 0.2; tests/test_fit_params.py:166-170)."""
    import dataclasses

    import torch

    if light_fit:
        light = phong.default_light()
        dev = light.ambient.device
        return tf, dataclasses.replace(
            light, ambient=torch.tensor(0.7, device=dev),
            diffuse=torch.tensor(0.2, device=dev))
    colors = tf.colors.clone()
    colors[1:, :3] += torch.tensor(
        rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32), device=colors.device)
    return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g), None


def swap_plain_a1(march, march_vjp):
    """Route the differentiable a1 march through the plain versions ->
    the kernels' routes, to restore."""
    routes = march_vjp._forward, march_vjp._backward
    march_vjp._forward = plain_fwd_a1(march, march_vjp)
    march_vjp._backward = march_vjp.march_bwd_plain
    return routes


def lit_fit_phase(P, fit, march, march_vjp, phong, label, var, vol, rng,
                  cfg, light_fit=False) -> dict:
    """Phase 7f (a colour fit through K4's ``var`` variant) or 7g (a light
    fit, ``light_fit``) on one volume: 5 steps after one warm-up (ms/step,
    launches by variant), the same under torch.profiler (device busy and
    idle share), then 2 steps through the kernels against 2 through the
    plain versions -> its numbers."""
    import torch

    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg, light=phong.default_light()
                      if light_fit else None)
    start_tf, start_light = lit_fit_start(P, phong, tf, rng, light_fit)

    def run(steps, lr=FIT_LR):
        return fit.fit_transfer_function(vol, cam, target, start_tf, cfg,
                                         steps=steps, learning_rate=lr,
                                         light=start_light)

    run(1)  # warm-up step
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches(march, march_vjp)
    start.record()
    params, losses = run(FIT_STEPS)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / FIT_STEPS
    k1 = dict(march.variant_launches)
    k4 = dict(march_vjp.variant_launches)
    per_step = 1 + (phong.N_LIGHT_PARAMS + 1 if light_fit else 0)
    log(f"{label}: fit losses {losses}, {step_ms:.4f} ms/step, launches "
        f"K1 {k1} K4 {k4} for {FIT_STEPS} steps")
    check(k1[var] == per_step * FIT_STEPS and k4[var] == FIT_STEPS
          and sum(k1.values()) == k1[var] and sum(k4.values()) == k4[var],
          f"{label}: launches K1 {k1} K4 {k4}")
    check(all(math.isfinite(v) for v in losses), f"{label}: loss not finite")
    trace = profile_fit(lambda: run(FIT_STEPS),
                        ("march_a1_kernel", "march_bwd_a1_kernel"))
    log(f"{label}: the same {FIT_STEPS} steps under torch.profiler: "
        f"{trace['wall_ms'] / FIT_STEPS:.4f} ms/step, device busy "
        f"{trace['busy_ms'] / FIT_STEPS:.4f} ms/step (K1 "
        f"{trace['k1_ms'] / FIT_STEPS:.4f}, K4 "
        f"{trace['k4_ms'] / FIT_STEPS:.4f}), idle "
        f"{trace['idle_share']:.4f} of the span from the first kernel to "
        f"the last ({trace['span_ms'] / FIT_STEPS:.4f} ms/step), "
        f"{trace['kernels']} device operations")

    pk, lk = run(2)
    routes = swap_plain_a1(march, march_vjp)
    try:
        pp, lp = run(2)
    finally:
        march_vjp._forward, march_vjp._backward = routes
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(float((a - b).detach().abs().max())
                    for a, b in zip(pk.parameters(), pp.parameters()))
    log(f"{label}: 2 fit steps, kernels vs plain: losses {lk} vs {lp} "
        f"(max relative err {loss_err:.3e}), parameters max abs err "
        f"{param_err:.3e} (tol {TOL_FIT:g})")
    check(lk == losses[:2], f"{label}: the fit is not deterministic")
    check(loss_err <= TOL_FIT and param_err <= TOL_FIT,
          f"{label}: kernels vs plain fit steps differ")
    if light_fit:
        log(f"{label}: fitted light "
            f"{phong.light_to_vec(params.light).detach().cpu().tolist()}")
    return dict(step_ms=step_ms, k1=k1[var], k4=k4[var], losses=losses,
                trace=trace)


def light_grad_phase(P, fit, march, march_vjp, phong, vname, vol, rng
                     ) -> dict:
    """Phase 7h at ``sobel_lit_700`` on one volume: the light gradient of
    the fit's loss through the kernels against the plain versions (each of
    the 10 components within TOL_LIGHT of the largest), the three colour
    components equal (TOL_LIGHT_SYM), and central differences of the loss
    in ambient and direction[0] (TOL_FD)."""
    import torch

    cfg = P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"])
    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg, light=phong.default_light())
    _, start = lit_fit_start(P, phong, tf, rng, True)

    def light_grad():
        params = fit.FitParams.init(tf, light=start)
        fit.render_loss(params, tf, vol, cam, target, cfg).backward()
        return torch.cat([p.grad.reshape(-1) for p in params.light.fields()])

    g = light_grad()
    routes = swap_plain_a1(march, march_vjp)
    try:
        gp = light_grad()
    finally:
        march_vjp._forward, march_vjp._backward = routes
    scale = float(gp.abs().max())
    err = float((g - gp).abs().max()) / scale
    sym = max(abs(float(g[3] - g[c])) / abs(float(g[3])) for c in (4, 5))
    log(f"{vname}: light gradient kernels {g.tolist()} vs plain "
        f"{gp.tolist()}: max err {err:.3e} of max |dplain| {scale:.4e} (tol "
        f"{TOL_LIGHT:g}); colour components equal within {sym:.3e} (tol "
        f"{TOL_LIGHT_SYM:g})")
    check(err <= TOL_LIGHT, f"{vname}: light gradient kernels vs plain {err}")
    check(sym <= TOL_LIGHT_SYM and float(g[3]) != 0.0,
          f"{vname}: colour gradients not symmetric {sym}")
    vec = phong.light_to_vec(start)
    fd = {}
    for name, idx in (("ambient", 6), ("direction[0]", 0)):
        losses, steps = [], []
        for h in (LIGHT_FD_STEP, -LIGHT_FD_STEP):
            v = vec.clone()
            v[idx] = v[idx] + h
            steps.append(float(v[idx]))
            params = fit.FitParams.init(tf, light=phong.light_from_vec(v))
            with torch.no_grad():
                losses.append(float(fit.render_loss(params, tf, vol, cam,
                                                    target, cfg)))
        predicted = float(g[idx]) * (steps[0] - steps[1])
        rel = abs((losses[0] - losses[1]) - predicted) / abs(predicted)
        fd[name] = rel
        log(f"{vname}: central difference in {name}: {losses[0] - losses[1]:.6g}"
            f" against {predicted:.6g} from the gradient (relative err "
            f"{rel:.3e}, tol {TOL_FD:g})")
        check(rel <= TOL_FD, f"{vname}: light central difference in {name}")
    return dict(err=err, sym=sym, fd=fd)


def light_recovery_phase(P, fit, march, march_vjp, phong) -> dict:
    """Phase 7i: tests/test_fit_params.py:158-178 on the card through K1
    baked and K4 baked: 150 steps at lr 2e-2 from ambient 0.7 and diffuse
    0.2 toward the default light; the last loss must be below 0.2 of the
    first and the ambient error must halve."""
    rng = np.random.default_rng(11)
    vol = P.make_volume(rng.uniform(0.0, 255.0, size=(9, 11, 10))
                        .astype(np.float32))
    tf = P.default_transfer_function()
    cam = P.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = P.RenderConfig(width=18, height=13, samples_per_ray=30)
    true = phong.default_light()
    target = P.render(vol, tf, cam, cfg, light=true)
    _, start = lit_fit_start(P, phong, tf, rng, True)
    reset_launches(march, march_vjp)
    t0 = time.perf_counter()
    params, losses = fit.fit_transfer_function(
        vol, cam, target, tf, cfg, steps=LIGHT_RECOVERY_STEPS,
        learning_rate=LIGHT_RECOVERY_LR, light=start)
    secs = time.perf_counter() - t0
    k1, k4 = march.variant_launches["baked"], march_vjp.variant_launches[
        "baked"]
    a0 = abs(0.7 - float(true.ambient))
    a1 = abs(float(params.light.ambient) - float(true.ambient))
    log(f"light recovery: loss {losses[0]:.6g} -> {losses[-1]:.6g} in "
        f"{LIGHT_RECOVERY_STEPS} steps ({losses[-1] / losses[0]:.4f}, must "
        f"be below 0.2), ambient error {a0:.4f} -> {a1:.4f} (must halve), "
        f"launches K1 baked {k1} K4 baked {k4}, {secs:.2f} s")
    check(k1 == LIGHT_RECOVERY_STEPS * (phong.N_LIGHT_PARAMS + 2)
          and k4 == LIGHT_RECOVERY_STEPS,
          f"light recovery launches K1 {k1} K4 {k4}")
    check(losses[-1] < 0.2 * losses[0], "light recovery: loss did not fall")
    check(a1 < 0.5 * a0, "light recovery: ambient error did not halve")
    return dict(loss_ratio=losses[-1] / losses[0], a0=a0, a1=a1)


def lit_fit_cli_phase(tmp: str, from_text) -> None:
    """Phase 5g: the CLI's ``fit --lighting``, ``fit --config <json with
    tf_lut 256>`` and ``fit --fit-light``; each must write a TF file that
    parses, the light fit its fitted light."""
    cfg_path = os.path.join(tmp, "lut_fit.json")
    with open(cfg_path, "w") as f:
        json.dump({"width": 300, "height": 300, "samples_per_ray": 300,
                   "tf_lut": 256}, f)
    sobel = ["--width", "700", "--height", "700", "--spr", "250",
             "--lighting", "--gradient-filter", "sobel"]
    for name, flags in (("lighting", sobel), ("config_lut",
                                              ["--config", cfg_path]),
                        ("fit_light", sobel + ["--fit-light"])):
        out_tf = os.path.join(tmp, f"fit_{name}.txt")
        stdout = run_cli(["fit", "--data", "sphere", *flags, "--steps", "2",
                          "--out-tf", out_tf])
        with open(out_tf) as f:
            fitted = from_text(f.read())
        check(fitted.num_intervals == 4
              and bool(np.isfinite(fitted.colors.cpu().numpy()).all()),
              f"cli fit {name} wrote a bad transfer function")
        if name == "fit_light":
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("fitted light:")]
            check(len(lines) == 1, "cli fit --fit-light printed no light")
            vec = json.loads(lines[0].split(":", 1)[1])
            check(len(vec) == 10 and all(math.isfinite(v) for v in vec),
                  f"cli fit --fit-light printed {vec}")


# ---- the scattering and large-volume slice --------------------------------

def peak_mb(base: int) -> tuple:
    """(peak allocated MiB since the last reset, its part above ``base``
    bytes, the memory allocated at that reset)."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    return peak / 2**20, (peak - base) / 2**20


def mem_reset() -> int:
    """Reset the peak-memory counter -> the bytes allocated now."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def large_config(P, row: str, **kw):
    """The RenderConfig of bench.py's streamed row ``row`` (LARGE_ROWS)."""
    extra = dict(LARGE_ROWS[row])
    if extra.pop("a5", False):
        extra["algorithm"] = P.Algorithm.TEST
    return P.RenderConfig(**LARGE_SHAPE, **extra, **kw)


def dense_volume(P, n: int):
    """bench.py:214-219's dense sphere at n^3, built with numpy: intensity
    55 + 60 r^2 inside r^2 < 0.8 of the [-1, 1]^3 cube, 0 outside."""
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    r2 = (xs[:, None, None] ** 2 + xs[None, :, None] ** 2
          + xs[None, None, :] ** 2)
    return P.make_volume(
        np.where(r2 < 0.8, 55.0 + 60.0 * r2, 0.0).astype(np.float32))


def large_kernel_phases(P, march, march_vjp, a5, a5_vjp, smooth, smooth_vjp,
                        phong, large, tf, rng, libs=None) -> dict:
    """Phase 3k: at bench.py's streamed rows (304x304 pixels, 300 samples)
    on the dense 320^3 and 512^3 volumes, K1 plain and baked and K3 unlit
    and baked against their plain versions (bit-exact at eps 0; eps 1e-3
    within TOL_EPS of the exact render), K4 plain and baked and K6 (within
    TOL_GRAD of max |dplain|), K8 (TOL_SMOOTH) and K9 (with the volume
    gradient, TOL_GRAD); each kernel's ms per launch at eps 1e-3 (forward)
    or 0 (backward, K8 and K9 at eps 0), its plain version's, its bound and
    the peak memory of prep + kernel, and K8's and K9's samples in range;
    K4's spans checked and counted, K4 plain with TF(0).alpha 1 against its
    plain version, and with ``libs`` K4 of this tree and another checkout
    in turns -> {volume: {kernel: numbers}}."""
    import torch

    res = {}
    grad_rng = np.random.default_rng(31)
    test = P.Algorithm.TEST
    for vname, vol in large.items():
        cam = orbit_cameras(P, rng, 1)[0]
        base = P.RenderConfig(**LARGE_SHAPE)
        rays = base.width * base.height
        r = res[vname] = {}
        for key, cfg in (("k1", base),
                         ("k1_baked", base.replace(lighting=True)),
                         ("k3", base.replace(algorithm=test)),
                         ("k3_baked", base.replace(algorithm=test,
                                                   lighting=True))):
            is_a5 = cfg.algorithm is test
            prep = a5.prepare_a5 if is_a5 else march.prepare
            kernel = a5.march_a5_kernel if is_a5 else march.march_kernel
            plain = a5.march_a5_plain if is_a5 else march.march_plain
            label = f"{vname}/{key}"
            m0 = mem_reset()
            a = prep(vol, tf, cam, cfg, 1e-3)
            ms = timed_ms(lambda: kernel(a), 10, prefill=True, label=label)
            peak, own = peak_mb(m0)
            prep_ms = timed_ms(lambda: prep(vol, tf, cam, cfg, 1e-3), 2)
            _, exact, e = exact_vs_plain(kernel, plain, f"{label} eps0",
                                         prep(vol, tf, cam, cfg, 0.0))
            e2 = float((kernel(a) - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
            plain_ms = time_plain(lambda: plain(a))
            per = (FLOPS_PER_A5_SAMPLE if is_a5 else FLOPS_PER_SAMPLE) + (
                FLOPS_PER_BAKED_SAMPLE if cfg.lighting else 0)
            if is_a5:
                ops, samples = a5_fwd_ops(a5, [a], per)
            else:
                samples = samples_needed(plain, [a])
                ops = samples * per
            b = bound(ops, bound_bytes(a, rays, samples, 8 if is_a5 else 1))
            r[key] = dict(ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
                          bound_ms=b[0], bound_by=b[1], samples=samples,
                          err=e, err_eps=e2, peak_mb=peak, own_mb=own)
            log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
                f"{prep_ms:.4f} ms, needed samples {samples}, bound "
                f"{b[2]:.4f} ms (operations) / {b[3]:.4f} ms (bytes), peak "
                f"memory {peak:.1f} MiB ({own:.1f} MiB above the start)")
            del a, exact
            torch.cuda.empty_cache()
        for key, cfg in (("k4", base),
                         ("k4_baked", base.replace(lighting=True)),
                         ("k6", base.replace(algorithm=test))):
            is_a5 = key == "k6"
            label = f"{vname}/{key}"
            m0 = mem_reset()
            if is_a5:
                a, _ = a5_vjp.prepare_a5_diff(vol, tf, cam, cfg)
                kernel, plain = (a5_vjp.march_a5_bwd_kernel,
                                 a5_vjp.march_a5_bwd_plain)
            else:
                a, _ = march_vjp.prepare_diff(vol, tf, cam, cfg)
                kernel, plain = (march_vjp.march_bwd_kernel,
                                 march_vjp.march_bwd_plain)
            g = cotangents(a, grad_rng)
            ms = timed_ms(lambda: kernel(a, *g), 5, prefill=True, label=label)
            peak, own = peak_mb(m0)
            e_abs, e_rel = bwd_vs_plain(kernel, plain, label, a, g)
            plain_ms = time_plain(lambda: plain(a, *g))
            spans = in_turns = None
            if not is_a5:
                spans = k4_span_check(march, march_vjp, a, g, label)
                if libs is not None:
                    in_turns = k4_in_turns(march_vjp, libs, [(a, g)], label)
            if key == "k4":  # every sample off the volume opaque
                a1, _ = march_vjp.prepare_diff(
                    vol, tf_with_alpha(P, tf, 0, 1.0), cam, cfg)
                ea, er = bwd_vs_plain(kernel, plain, f"{label}_alpha0_one",
                                      a1, cotangents(a1, grad_rng))
                e_abs, e_rel = max(e_abs, ea), max(e_rel, er)
                del a1
            k = a.colors.shape[0]
            total = rays * cfg.samples_per_ray
            fwd_plain = a5.march_a5_plain if is_a5 else march.march_plain
            inside = samples_needed(fwd_plain, [a])
            blocks = (a5_vjp if is_a5 else march_vjp).num_blocks(
                cfg.width, cfg.height)
            nbytes = (read_bytes(a.ids.numel(), inside * (8 if is_a5 else 1))
                      + rays * 16 + k * 16 + blocks * k * 16)
            if is_a5:
                ops = (inside * (FLOPS_PER_A5_BWD_SAMPLE + min(8, k)
                                 * FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL)
                       + bwd_outside_ops(total - inside, rays,
                                         bwd_alpha0(a, a5.S_ID0))
                       + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                                 + FLOPS_PER_A5_BWD_RAY))
            else:
                baked = a.mgrid is not None
                if baked:
                    nbytes += 8 * min(inside, a.mgrid.numel())
                ops = (inside * (FLOPS_PER_BWD_SAMPLE + (
                    FLOPS_PER_BWD_BAKED_SAMPLE if baked else 0))
                       + bwd_outside_ops(total - inside, rays,
                                         bwd_alpha0(a, march.S_ID0))
                       + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                                 + FLOPS_PER_BWD_RAY))
            b = bound(ops, nbytes)
            r[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                          bound_by=b[1], inside=inside, err=e_abs,
                          err_rel=e_rel, peak_mb=peak, own_mb=own,
                          spans=spans, in_turns=in_turns)
            log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                f"samples inside {inside} of {total}, bound {b[2]:.4f} ms "
                f"(operations) / {b[3]:.4f} ms (bytes), peak memory "
                f"{peak:.1f} MiB ({own:.1f} MiB above the start)")
            del a, g
            torch.cuda.empty_cache()
        # smooth mode (the JAX package runs its scan at these sizes)
        cfg = base.replace(interp=P.Interp.TRILINEAR)
        m0 = mem_reset()
        a = smooth.prepare_smooth(vol, tf, cam, cfg, 0.0)
        ms = timed_ms(lambda: smooth.march_smooth_kernel(a), 5, prefill=True,
                      label=f"{vname}/k8")
        peak, own = peak_mb(m0)
        stats = {}
        got = smooth.march_smooth_kernel(a)
        want = smooth.march_smooth_plain(a, stats)
        e = float((got - want).abs().max())
        log(f"{vname}/k8: K8 vs plain max err {e:.3e} (tol {TOL_SMOOTH:g})")
        check(e <= TOL_SMOOTH, f"{vname}/k8: max err {e}")
        # the plain versions are timed at the first size only: their time is
        # host launches, the same at both (the rays and samples are)
        timed = vol.dims[0] == LARGE_SIZES[0]
        plain_ms = time_plain(  # the check ran it
            lambda: smooth.march_smooth_plain(a)) if timed else None
        in_range = range_share(smooth, a, stats["inside"], f"{vname}/k8")
        k = tf.num_intervals
        b = bound(stats["inside"] * (FLOPS_PER_SMOOTH_SAMPLE + (k - 1)
                                     * FLOPS_PER_SMOOTH_SAMPLE_PER_INTERVAL)
                  + (stats["samples"] - stats["inside"])
                  * FLOPS_PER_SMOOTH_OUTSIDE_SAMPLE
                  + rays * FLOPS_PER_SMOOTH_RAY,
                  read_bytes(vol.data.numel() * 4, stats["inside"] * 32)
                  + k * 24 + rays * 16)
        r["k8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                       bound_by=b[1], err=e, peak_mb=peak, own_mb=own,
                       inside=stats["inside"], in_range=in_range)
        log(f"{vname}/k8: K8 {ms:.4f} ms, plain {plain_ms} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}), peak memory {peak:.1f} MiB")
        del a
        a = smooth_vjp.prepare_smooth_diff(vol, tf, cam, cfg)
        g = cotangents(a, grad_rng)
        m0 = mem_reset()
        ms = timed_ms(lambda: smooth_vjp.march_smooth_bwd_kernel(a, *g), 5,
                      prefill=True, label=f"{vname}/k9")
        peak, own = peak_mb(m0)
        errs = smooth_bwd_vs_plain(smooth_vjp, f"{vname}/k9", a, g)
        # the check ran the plain backward with the splat, whose operations
        # without it are a part
        plain_ms = time_plain(
            lambda: smooth_vjp.march_smooth_bwd_plain(a, *g)
        ) if timed else None
        total = rays * cfg.samples_per_ray
        b = bound(smooth_bwd_ops(k, stats["inside"], total, rays, False,
                                 smooth_alpha0(smooth, a)),
                  read_bytes(vol.data.numel() * 4, stats["inside"] * 32)
                  + rays * 16 + k * 24
                  + smooth_vjp.num_blocks(cfg.width, cfg.height) * k * 24)
        r["k9"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                       bound_by=b[1], err=max(v[0] for v in errs.values()),
                       err_rel=max(v[1] for v in errs.values()),
                       peak_mb=peak, own_mb=own)
        log(f"{vname}/k9: K9 {ms:.4f} ms, plain {plain_ms} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}), peak memory {peak:.1f} MiB")
        del a, g
        torch.cuda.empty_cache()
    return res


def large_render_phase(P, march, a5, large, tf, rng) -> dict:
    """Phase 4e: bench.py's streamed_320, streamed_lit_320 and
    streamed_a5_320 rows and their 512^3 twins, 8 orbit frames each after a
    warm-up through ``render()`` (eps 1e-3), with each variant's launches
    set to 0 just before and read just after -> {volume/row: numbers}."""
    import torch

    res = {}
    for vname, vol in large.items():
        for row in LARGE_ROWS:
            cfg = large_config(P, row, early_termination=1e-3)
            is_a5 = cfg.algorithm is P.Algorithm.TEST
            var = "baked" if cfg.lighting else ("unlit" if is_a5 else "plain")
            mod = a5 if is_a5 else march
            cams = orbit_cameras(P, rng)
            P.render(vol, tf, cams[-1], cfg)  # warm-up frame
            m0 = mem_reset()
            reset_launches(march, a5)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
            end.record()
            torch.cuda.synchronize()
            launches = dict(mod.variant_launches)
            ms = start.elapsed_time(end) / len(imgs)
            peak, own = peak_mb(m0)
            label = f"{vname}/{row}"
            for img in imgs:
                check(tuple(img.shape) == (cfg.width, cfg.height, 4)
                      and bool(torch.isfinite(img).all()),
                      f"{label}: bad image")
                fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                           .float().mean())
                check(fg > 0.01, f"{label}: image is background only ({fg})")
            log(f"{label}: render() {ms:.4f} ms/frame, "
                f"{cfg.width * cfg.height / ms * 1e3:.4e} rays/s, launches "
                f"{launches} for {len(imgs)} frames, peak memory {peak:.1f} "
                f"MiB ({own:.1f} MiB above the start)")
            check(launches[var] == len(imgs)
                  and sum(launches.values()) == len(imgs),
                  f"{label}: launches {launches}")
            res[label] = dict(ms=ms, launches=launches[var], variant=var,
                              peak_mb=peak, own_mb=own)
            del imgs
            torch.cuda.empty_cache()
    return res


def large_fit_phase(P, fit, march, march_vjp, a5, a5_vjp, phong, large, tf,
                    rng) -> dict:
    """Phase 7j: 5 colour-fit steps after a warm-up (a1, lit a1 and a5, at
    the streamed rows' shapes) on the dense 320^3 and 512^3 volumes: ms per
    step, launches of each kernel (1 forward and 1 backward a step), the
    same steps under torch.profiler for the device's busy ms and idle
    share, and the peak memory -> {volume/row: numbers}."""
    import torch

    res = {}
    for vname, vol in large.items():
        for row in LARGE_ROWS:
            cfg = large_config(P, row)
            is_a5 = cfg.algorithm is P.Algorithm.TEST
            fwd, bwd = (a5, a5_vjp) if is_a5 else (march, march_vjp)
            var = "baked" if cfg.lighting else ("unlit" if is_a5 else "plain")
            names = (("march_a5_kernel", "march_bwd_a5_kernel") if is_a5 else
                     ("march_a1_kernel", "march_bwd_a1_kernel"))
            cam = orbit_cameras(P, rng, 1)[0]
            target = P.render(vol, tf, cam, cfg)
            start_tf, _ = lit_fit_start(P, phong, tf, rng, False)

            def run(steps):
                return fit.fit_transfer_function(vol, cam, target, start_tf,
                                                 cfg, steps=steps,
                                                 learning_rate=FIT_LR)

            run(1)  # warm-up step
            m0 = mem_reset()
            reset_launches(march, march_vjp, a5)
            a5_vjp.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, losses = run(FIT_STEPS)
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / FIT_STEPS
            peak, own = peak_mb(m0)
            k_fwd = fwd.variant_launches[var]
            k_bwd = bwd.launches if is_a5 else bwd.variant_launches[var]
            label = f"{vname}/{row} fit"
            log(f"{label}: losses {losses}, {step_ms:.4f} ms/step, launches "
                f"forward {k_fwd} backward {k_bwd} for {FIT_STEPS} steps, "
                f"peak memory {peak:.1f} MiB ({own:.1f} MiB above the start)")
            check(k_fwd == k_bwd == FIT_STEPS == fwd.launches,
                  f"{label}: launches {k_fwd} {k_bwd}")
            check(all(math.isfinite(v) for v in losses),
                  f"{label}: loss not finite")
            trace = profile_fit(lambda: run(FIT_STEPS), names)
            log(f"{label}: under torch.profiler "
                f"{trace['wall_ms'] / FIT_STEPS:.4f} ms/step, device busy "
                f"{trace['busy_ms'] / FIT_STEPS:.4f} ms/step (forward "
                f"{trace['k1_ms'] / FIT_STEPS:.4f}, backward "
                f"{trace['k4_ms'] / FIT_STEPS:.4f}), idle "
                f"{trace['idle_share']:.4f}")
            res[label] = dict(step_ms=step_ms, fwd=k_fwd, bwd=k_bwd,
                              busy_ms=trace["busy_ms"] / FIT_STEPS,
                              idle_share=trace["idle_share"], peak_mb=peak,
                              own_mb=own, variant=var, a5=is_a5)
            torch.cuda.empty_cache()
    return res


def scatter_tf(P, tf):
    """The default TF with test_scatter_fused_hg_g's materials."""
    import torch

    return P.TransferFunction(tf.lower, tf.upper, tf.colors, torch.tensor(
        SCATTER_HG, dtype=torch.float32, device=tf.colors.device))


def scatter_kernel_phase(P, march, a5, phong, volumes, tf, rng) -> dict:
    """Phase 3l: scattered renders (strength 1.5) at the streamed rows'
    shapes on the MNI-dims and dense 320^3 volumes: a1 unlit (with non-zero
    HG g), lit and LUT 64, and a5, through K1 and K3 baked against their
    plain versions (bit-exact at eps 0, eps 1e-3 within TOL_EPS); the
    kernel's, the scatter bake's and the frame's time; then the
    transmittance sweep and the scatter bake at 512^3 -> numbers."""
    import torch

    res = {}
    base = P.RenderConfig(**LARGE_SHAPE, scattering=True,
                          scattering_strength=SCATTER_STRENGTH)
    tf_hg = scatter_tf(P, tf)
    light = phong.default_light()
    for vname, vol in volumes.items():
        cam = orbit_cameras(P, rng, 1)[0]
        for key, tfx, cfg in (
                ("a1_hg", tf_hg, base), ("a1_lit", tf, base.replace(
                    lighting=True)),
                ("a1_lut64", tf, base.replace(tf_lut=64)),
                ("a5", tf, base.replace(algorithm=P.Algorithm.TEST))):
            is_a5 = cfg.algorithm is P.Algorithm.TEST
            prep = a5.prepare_a5 if is_a5 else march.prepare
            kernel = a5.march_a5_kernel if is_a5 else march.march_kernel
            plain = a5.march_a5_plain if is_a5 else march.march_plain
            label = f"scatter {vname}/{key}"
            a0 = prep(vol, tfx, cam, cfg, 0.0)
            check(a0.sgrid is not None, f"{label}: no baked S grid")
            _, exact, e = exact_vs_plain(kernel, plain, f"{label} eps0", a0)
            got = kernel(prep(vol, tfx, cam, cfg, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
            a = prep(vol, tfx, cam, cfg, 1e-3)
            ms = timed_ms(lambda: kernel(a), 10, prefill=True, label=label)
            frame_cfg = cfg.replace(early_termination=1e-3)
            frame_ms = timed_ms(lambda: P.render(vol, tfx, cam, frame_cfg), 3)
            cal = vol.cal_max.to(torch.float32)
            cal_g = cal if is_a5 else torch.trunc(cal)
            bake_ms = timed_ms(lambda: phong.bake_scatter_grid(
                vol.data, tfx, cfg, light, cam.front, cal_g,
                torch.trunc(cal)), 3)
            res[label] = dict(err=e, err_eps=e2, ms=ms, frame_ms=frame_ms,
                              bake_ms=bake_ms, variant="a5_baked" if is_a5
                              else march.variant(a))
            log(f"{label}: kernel {ms:.4f} ms, frame through render() "
                f"{frame_ms:.4f} ms, scatter bake {bake_ms:.4f} ms "
                f"({bake_ms / frame_ms:.3f} of the frame)")
            del a, a0, exact, got
            torch.cuda.empty_cache()
    return res


def sweep_phase(P, phong, vol, tf) -> dict:
    """The transmittance sweep and the whole scatter bake on one volume
    (phase 3l, at 512^3): ms per call and peak memory."""
    import torch

    cfg = P.RenderConfig(scattering=True)
    light = phong.default_light()
    cal = torch.trunc(vol.cal_max.to(torch.float32))
    alpha = tf.classify(vol.data.clamp_min(0.0) / cal)[..., 3].contiguous()
    m0 = mem_reset()
    sweep_ms = timed_ms(lambda: phong.light_transmittance_grid(
        alpha, light.direction), 2)
    bake_ms = timed_ms(lambda: phong.bake_scatter_grid(
        vol.data, tf, cfg, light, P.reset_preset().front, cal, cal), 2)
    peak, own = peak_mb(m0)
    t = phong.light_transmittance_grid(alpha, light.direction)
    check(bool(torch.isfinite(t).all()) and float(t.max()) <= 1.0
          and float(t.min()) >= 0.0, "the transmittance grid is out of [0, 1]")
    planes = int(max(vol.dims))
    log(f"dense_{vol.dims[0]}: transmittance sweep {sweep_ms:.4f} ms (up to "
        f"{planes} planes), scatter bake {bake_ms:.4f} ms, peak memory "
        f"{peak:.1f} MiB ({own:.1f} MiB above the start)")
    return dict(sweep_ms=sweep_ms, bake_ms=bake_ms, peak_mb=peak,
                own_mb=own)


def scatter_small_phase(P, sphere, tf) -> float:
    """Phase 6e: small scattered renders (100x100x100 on the sphere)
    through the kernels against the plain scan, within TOL_EXACT."""
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100,
                           scattering=True,
                           scattering_strength=SCATTER_STRENGTH)
    worst = 0.0
    for name, tfx, c in (
            ("a1 hg", scatter_tf(P, tf), small),
            ("a1 lit", tf, small.replace(lighting=True)),
            ("a1 LUT 64", tf, small.replace(tf_lut=64)),
            ("a5", scatter_tf(P, tf), small.replace(
                algorithm=P.Algorithm.TEST))):
        got = P.render(sphere, tfx, P.reset_preset(), c)
        ref = P.render(sphere, tfx, P.reset_preset(), c, mode="scan")
        e = float((got - ref).abs().max())
        worst = max(worst, e)
        log(f"scattered {name} sphere 100x100x100: kernel vs plain scan max "
            f"err {e:.3e} (tol {TOL_EXACT:g})")
        check(e <= TOL_EXACT, f"scattered {name} kernel vs scan: {e}")
    return worst


def scatter_render_phase(P, march, a5, vol, tf, rng) -> dict:
    """Phase 4f: 8 scattered orbit frames after a warm-up through
    ``render()`` (eps 1e-3) on the MNI-dims volume: a1 700x700x500, a1
    ``sobel_lit_700`` lit, a5 500x500x500; each variant's launches set to 0
    just before and read just after -> {config: numbers}."""
    import torch

    res = {}
    for name, cfg, mod in (
            ("a1_700", P.RenderConfig(width=W, height=H, samples_per_ray=SPR),
             march),
            ("sobel_lit_700", P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"]),
             march),
            ("a5_500", P.RenderConfig(width=A5_W, height=A5_H,
                                      samples_per_ray=A5_SPR,
                                      algorithm=P.Algorithm.TEST), a5)):
        cfg = cfg.replace(scattering=True, early_termination=1e-3)
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], cfg)  # warm-up frame
        reset_launches(march, a5)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(imgs)
        launches = dict(mod.variant_launches)
        for img in imgs:
            check(bool(torch.isfinite(img).all()),
                  f"scatter {name}: bad image")
        log(f"scattered {name}: render() {ms:.4f} ms/frame, "
            f"{cfg.width * cfg.height / ms * 1e3:.4e} rays/s, launches "
            f"{launches} for {len(imgs)} frames")
        check(launches["baked"] == len(imgs)
              and sum(launches.values()) == len(imgs),
              f"scattered {name}: launches {launches}")
        res[name] = dict(ms=ms, launches=launches["baked"],
                         a5=mod is a5)
    return res


def scatter_fit_phase(P, fit, march, march_vjp, phong, vname, vol, rng
                      ) -> dict:
    """Phase 7k at ``sobel_lit_700`` with scattering on one volume: 5 fit
    steps after a warm-up (ms/step; K1 baked launched 1 + K + 1 times a
    step, K4 baked once), one step under torch.profiler (its tens of
    thousands of device operations make the trace's processing the
    phase's largest cost), 5 steps at lr
    3e-6 that must descend, the colour gradient (its alpha column through
    T_light) through the kernels against the plain versions (TOL_LIGHT of
    its largest component) and a central difference along it (TOL_FD)."""
    import torch

    cfg = P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"], scattering=True)
    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
    target = P.render(vol, tf, cam, cfg)
    start_tf, _ = lit_fit_start(P, phong, tf, rng, False)
    k = tf.num_intervals
    label = f"scattered fit {vname}/sobel_lit_700"

    def run(steps, lr=FIT_LR):
        return fit.fit_transfer_function(vol, cam, target, start_tf, cfg,
                                         steps=steps, learning_rate=lr)

    run(1)  # warm-up step
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches(march, march_vjp)
    start.record()
    _, losses = run(FIT_STEPS)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / FIT_STEPS
    k1 = dict(march.variant_launches)
    k4 = dict(march_vjp.variant_launches)
    log(f"{label}: losses {losses}, {step_ms:.4f} ms/step, launches K1 {k1} "
        f"K4 {k4} for {FIT_STEPS} steps")
    check(k1["baked"] == (1 + k + 1) * FIT_STEPS == sum(k1.values())
          and k4["baked"] == FIT_STEPS == sum(k4.values()),
          f"{label}: launches K1 {k1} K4 {k4}")
    check(all(math.isfinite(v) for v in losses), f"{label}: loss not finite")
    trace = profile_fit(lambda: run(1),
                        ("march_a1_kernel", "march_bwd_a1_kernel"))
    log(f"{label}: one step under torch.profiler {trace['wall_ms']:.4f} ms, "
        f"device busy {trace['busy_ms']:.4f} ms (K1 {trace['k1_ms']:.4f}, K4 "
        f"{trace['k4_ms']:.4f}), idle {trace['idle_share']:.4f}, "
        f"{trace['kernels']} device operations")
    reset_launches(march, march_vjp)
    _, descent = run(FIT_STEPS, FIT_DESCENT_LR)
    log(f"{label}: losses at lr {FIT_DESCENT_LR:g} {descent}")
    check(all(b < a for a, b in zip(descent, descent[1:])),
          f"{label}: the loss did not fall at every step")

    def grads():
        params = fit.FitParams.init(start_tf)
        fit.render_loss(params, start_tf, vol, cam, target, cfg).backward()
        return params, [p.grad for p in params.parameters()]

    params, g = grads()
    routes = swap_plain_a1(march, march_vjp)
    try:
        _, gp = grads()
    finally:
        march_vjp._forward, march_vjp._backward = routes
    scale = float(gp[0][:, 3].abs().max())
    err = float((g[0][:, 3] - gp[0][:, 3]).abs().max()) / scale
    err_all = max(float((a - b).abs().max()) for a, b in zip(g, gp)) / max(
        float(b.abs().max()) for b in gp)
    log(f"{label}: alpha gradient kernels {g[0][:, 3].tolist()} vs plain "
        f"{gp[0][:, 3].tolist()}: max err {err:.3e} of max {scale:.4e} (tol "
        f"{TOL_LIGHT:g}); all parameters {err_all:.3e}")
    check(scale > 0.0 and err <= TOL_LIGHT and err_all <= TOL_LIGHT,
          f"{label}: gradient kernels vs plain {err} {err_all}")
    norm = math.sqrt(sum(float((x.double() ** 2).sum()) for x in g))
    with torch.no_grad():
        up, down = (fit.FitParams(*(p + (h / norm) * x for p, x in zip(
            params.parameters(), g))) for h in (FD_STEP, -FD_STEP))
        l_up, l_down = (float(fit.render_loss(q, start_tf, vol, cam, target,
                                              cfg)) for q in (up, down))
        predicted = sum(float((x.double() * (u - d).double()).sum())
                        for x, u, d in zip(g, up.parameters(),
                                           down.parameters()))
    fd_err = abs((l_up - l_down) - predicted) / abs(predicted)
    log(f"{label}: central difference {l_up - l_down:.6g} against "
        f"{predicted:.6g} from the gradient (relative err {fd_err:.3e}, tol "
        f"{TOL_FD:g})")
    check(fd_err <= TOL_FD and l_down < l_up, f"{label}: gradient check")
    return dict(step_ms=step_ms, k1=k1["baked"], k4=k4["baked"],
                busy_ms=trace["busy_ms"],
                idle_share=trace["idle_share"], err=err, fd_err=fd_err,
                losses=losses, descent=descent)


def scatter_cli_phase(tmp: str, from_text) -> None:
    """Phase 5h: the CLI's ``render --scattering`` (a1 and a5) and ``fit
    --scattering`` (a1); each must write a valid PNG or a TF file that
    parses."""
    size = ["--width", "304", "--height", "304", "--spr", "300",
            "--scattering", "--scattering-strength", str(SCATTER_STRENGTH)]
    run_cli(["render", "--data", "sphere", *size, "--out",
             os.path.join(tmp, "s1.png")])
    run_cli(["render", "--data", "sphere", *size, "--algorithm", "test",
             "--out", os.path.join(tmp, "s5.png")])
    run_cli(["fit", "--data", "sphere", *size, "--steps", "2", "--out-tf",
             os.path.join(tmp, "fit_scatter.txt")])
    check_png(os.path.join(tmp, "s1.png"), 304, 304)
    check_png(os.path.join(tmp, "s5.png"), 304, 304)
    with open(os.path.join(tmp, "fit_scatter.txt")) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == 4
          and bool(np.isfinite(fitted.colors.cpu().numpy()).all()),
          "cli fit --scattering wrote a bad transfer function")


# ---- the multichannel and in-kernel lighting slice ------------------------

def mc_volumes(P) -> dict:
    """The 3-channel volumes of bench.py's multichannel_304 row: its 91^3
    synthetic (bench.py:244-250) and a seeded one at MNI-dims (182x218x182x3
    f32, 87 MB: the MNI-like shells, channel 1 and 2 at 0.8 and 0.6 of them
    plus seeded noise)."""
    xs = np.linspace(-1, 1, 91, dtype=np.float32)
    r2 = (xs[:, None, None] ** 2 + xs[None, :, None] ** 2
          + xs[None, None, :] ** 2)
    base = np.where(r2 < 0.8, 40.0 + 80.0 * (1.0 - r2), 0.0)
    bench3 = np.stack([base, base * 0.7, base * 0.4], -1).astype(np.float32)
    rng = np.random.default_rng(40)
    mni = mni_like_volume(0)
    noise = rng.normal(0.0, 4.0, mni.shape + (2,)).astype(np.float32)
    mni3 = np.stack([mni, mni * np.float32(0.8) + noise[..., 0],
                     mni * np.float32(0.6) + noise[..., 1]], -1)
    return {"bench3_91": P.make_volume(bench3),
            "mni3_182x218x182": P.make_volume(mni3)}


def mc_seeded_volumes(P) -> dict:
    """Seeded 2- and 4-channel volumes with negatives, at cal_max 200.9 (the
    channels take the float cal_max, the ids the mean's intervals)."""
    rng = np.random.default_rng(41)
    return {f"c{c}_64x72x56": P.make_volume(
        rng.uniform(-20, 255, (64, 72, 56, c)).astype(np.float32),
        cal_max=200.9) for c in (2, 4)}


def mc_kernel_phases(P, march, march_vjp, mc_vols, seeded, tf, rng,
                     res) -> dict:
    """Phases 3m (K1 mc against march_plain, bit-exact at eps 0, ortho,
    conic and density_scale 1.7; eps 1e-3 within TOL_EPS of the exact
    render) and 3n (K4 mc against march_bwd_plain: the rgb columns exactly
    0, the alpha column within TOL_GRAD of max |dplain|) on the 3-channel
    volumes and the seeded 2- and 4-channel ones, at 304x304x300 -> the
    max errors; times, bounds and peak memory of the 3-channel volumes go
    into ``res``."""
    import torch

    errs = {"k1": 0.0, "k4_abs": 0.0, "k4_rel": 0.0}
    cfg = P.RenderConfig(**MC_SHAPE)
    rays = cfg.width * cfg.height
    for vname, vol in {**mc_vols, **seeded}.items():
        cam = orbit_cameras(P, rng, 1)[0]
        for name, c in (("ortho", cfg), ("conic", cfg.replace(conic=True)),
                        ("density_1.7", cfg.replace(density_scale=1.7))):
            label = f"mc {vname}/{name}"
            a = march.prepare(vol, tf, cam, c, 0.0)
            check(march.variant(a) == "mc", f"{label}: {march.variant(a)}")
            _, exact, e = exact_vs_plain(march.march_kernel, march.march_plain,
                                         f"{label} eps0", a)
            errs["k1"] = max(errs["k1"], e)
            got = march.march_kernel(march.prepare(vol, tf, cam, c, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
        # 3n: K4 mc
        a, _ = march_vjp.prepare_diff(vol, tf, cam, cfg)
        g = cotangents(a, rng)
        got = march_vjp.march_bwd_kernel(a, *g)
        want = march_vjp.march_bwd_plain(a, *g)
        torch.cuda.synchronize()
        check(march.variant(a) == "mc"
              and not bool(got[:, :3].any()) and not bool(want[:, :3].any()),
              f"mc {vname}: the rgb columns of dcolors are not 0")
        e_abs, e_rel = bwd_vs_plain(march_vjp.march_bwd_kernel,
                                    march_vjp.march_bwd_plain,
                                    f"K4 mc {vname}", a, g)
        errs["k4_abs"] = max(errs["k4_abs"], e_abs)
        errs["k4_rel"] = max(errs["k4_rel"], e_rel)
        if vname not in mc_vols:
            continue
        # K4's spans at a small shape: an id0 interval of alpha 1,
        # TF(0).alpha 0.05, rays that miss the box, a step longer than a
        # voxel
        small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
        near = P.Camera.initial(position=(0.35, 0.45, 0.85))
        for name, tfx, cam_e, c in (
                ("alpha0_one", tf_with_alpha(P, tf, 0, 1.0), near, small),
                ("alpha0_0.05", tf_with_alpha(P, tf, 0, 0.05), near, small),
                ("all_rays_miss", tf, away_camera(P, (0.9, 0.5, 1.0)), small),
                ("step_longer_than_a_voxel", tf, near,
                 small.replace(samples_per_ray=6))):
            # c' off a 4-D volume is 0: with TF(0).alpha 1 a ray from
            # outside has no gradient, and K4's must be exactly 0 too
            ae, _ = march_vjp.prepare_diff(vol, tfx, cam_e, c)
            ea, er = unit_bwd_vs_plain(march_vjp.march_bwd_kernel,
                                       march_vjp.march_bwd_plain,
                                       f"K4 mc {vname}/{name}", ae,
                                       cotangents(ae, rng))
            errs["k4_abs"] = max(errs["k4_abs"], ea)
            errs["k4_rel"] = max(errs["k4_rel"], er)
        k4_span_check(march, march_vjp, a, g, f"K4 mc {vname}")
        # times, bounds and memory at the render path's inputs (eps 1e-3)
        main_cfg = cfg.replace(early_termination=1e-3)
        cams = orbit_cameras(P, rng)
        m0 = mem_reset()
        args = [march.prepare(vol, tf, c, main_cfg, 1e-3) for c in cams[:1]]
        march.march_kernel(args[0])
        peak, own = peak_mb(m0)
        args += [march.prepare(vol, tf, c, main_cfg, 1e-3) for c in cams[1:]]

        def orbit_kernels():
            for x in args:
                march.march_kernel(x)

        ms = timed_ms(orbit_kernels, 5, prefill=True,
                      label=f"mc {vname}: K1 mc x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: march.prepare(vol, tf, cams[0], main_cfg,
                                                 1e-3), 3)
        samples = samples_needed(march.march_plain, args)
        plain_ms = time_plain(lambda: march.march_plain(args[0]))
        grids = args[0].chans
        nbytes = bound_bytes(args[0], rays, samples) + read_bytes(
            grids.numel() * 4, samples * grids.shape[0] * 4)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            samples * FLOPS_PER_SAMPLE, nbytes)
        # K4 mc at eps 0: every sample of every ray
        bwd_ms = timed_ms(lambda: march_vjp.march_bwd_kernel(a, *g), 5,
                          prefill=True, label=f"mc {vname}: K4 mc")
        bwd_plain_ms = time_plain(
            lambda: march_vjp.march_bwd_plain(a, *g))
        k = a.colors.shape[0]
        total = rays * cfg.samples_per_ray
        inside = samples_needed(march.march_plain, [a])
        bwd_bytes = (read_bytes(math.prod(vol.dims), inside)
                     + read_bytes(grids.numel() * 4,
                                  inside * grids.shape[0] * 4)
                     + rays * 16 + k * 16
                     + march_vjp.num_blocks(cfg.width, cfg.height) * k * 16)
        bwd_ops = (inside * FLOPS_PER_BWD_SAMPLE
                   + bwd_outside_ops(total - inside, rays,
                                     bwd_alpha0(a, march.S_ID0))
                   + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                             + FLOPS_PER_BWD_RAY))
        bwd_bound, bwd_by, _, _ = bound(bwd_ops, bwd_bytes)
        res[vname] = dict(
            ms=ms, plain_ms=plain_ms, prep_ms=prep_ms, bound_ms=bound_ms,
            bound_by=bound_by, samples=samples, peak_mb=peak, own_mb=own,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bound,
            bwd_bound_by=bwd_by, bwd_inside=inside)
        log(f"mc {vname}: K1 mc {ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
            f"{prep_ms:.4f} ms, needed samples per frame {samples}, bound "
            f"{ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes); peak "
            f"memory of prep + kernel {peak:.1f} MiB ({own:.1f} MiB above the "
            f"start); K4 mc {bwd_ms:.4f} ms, plain {bwd_plain_ms:.2f} ms, "
            f"bound {bwd_bound:.4f} ms ({bwd_by})")
        del args
        torch.cuda.empty_cache()
    return errs


def faces_volume(P):
    """Dense voxels on every face of a small volume, so the in-kernel
    normals read the zero padding there."""
    rng = np.random.default_rng(42)
    data = rng.uniform(0, 40, (19, 23, 17)).astype(np.float32)
    for ax in range(3):
        for end in (0, -1):
            idx = [slice(None)] * 3
            idx[ax] = end
            data[tuple(idx)] = rng.uniform(40, 130, data[tuple(idx)].shape)
    return P.make_volume(data, cal_max=200.9)


def colour_light(phong):
    """The default light with the colour (1.0, 0.8, 0.6)."""
    import dataclasses

    import torch

    light = phong.default_light()
    return dataclasses.replace(light, color=torch.tensor(
        [1.0, 0.8, 0.6], device=light.color.device))


def lit_inkernel_phase(P, march, phong, volumes, tf, rng, res) -> dict:
    """Phase 3o: K1's in-kernel lighting variant (lit, and lut_lit with a
    LUT) against march_plain, bit-exact at eps 0: on edge inputs (dense
    voxels on every face, a conic camera inside the volume, LUT 96 with
    cal_max 200.9, the light colour (1.0, 0.8, 0.6)), then conic at
    700x700x500 with the central filter and presmooth 0 on both volumes,
    with the interval TF and with tf_lut=256, and once ortho under the
    colour (1.0, 0.8, 0.6); eps 1e-3 within TOL_EPS of the exact render ->
    {variant: max err}; times, bounds and peak memory go into ``res``."""
    import torch

    errs = {"lit": 0.0, "lut_lit": 0.0}
    light = colour_light(phong)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37,
                           lighting=True, conic=True)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    faces = faces_volume(P)
    edges = [
        ("faces_conic", faces, near, small, None),
        ("faces_ortho_colour", faces, near, small.replace(conic=False), light),
        ("conic_inside_volume", faces,
         P.Camera.initial(position=(0.1, 0.05, 0.2)), small, None),
        ("faces_lut96_density", faces, near,
         small.replace(tf_lut=96, density_scale=0.45), light),
    ]
    for name, vol, cam, c, lg in edges:
        a = march.prepare(vol, tf, cam, c, 0.0, light=lg)
        var = march.variant(a)
        e = exact_vs_plain(march.march_kernel, march.march_plain,
                           f"lit edge/{name} ({var})", a)[2]
        errs[var] = max(errs[var], e)
    cfg = P.RenderConfig(**CONIC_LIT)
    cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    rays = cfg.width * cfg.height
    for vname, vol in volumes.items():
        for name, c, lg in (("conic", cfg, None),
                            ("conic_lut256", cfg.replace(tf_lut=256), None),
                            ("ortho_colour", cfg.replace(conic=False),
                             light)):
            a = march.prepare(vol, tf, cam, c, 0.0, light=lg)
            var = march.variant(a)
            label = f"{vname}/{name} ({var})"
            _, exact, e = exact_vs_plain(march.march_kernel,
                                         march.march_plain, f"{label} eps0",
                                         a)
            errs[var] = max(errs[var], e)
            got = march.march_kernel(march.prepare(vol, tf, cam, c, 1e-3,
                                                   light=lg))
            e2 = float((got - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
        # times, bounds and memory at the conic orbit's inputs
        for var, c in (("lit", cfg), ("lut_lit", cfg.replace(tf_lut=256))):
            main_cfg = c.replace(early_termination=1e-3)
            cams = orbit_cameras(P, rng)
            m0 = mem_reset()
            args = [march.prepare(vol, tf, cams[0], main_cfg, 1e-3)]
            march.march_kernel(args[0])
            peak, own = peak_mb(m0)
            args += [march.prepare(vol, tf, x, main_cfg, 1e-3)
                     for x in cams[1:]]

            def orbit_kernels():
                for x in args:
                    march.march_kernel(x)

            ms = timed_ms(orbit_kernels, 3, prefill=True,
                          label=f"{vname}: K1 {var} x{FRAMES}") / FRAMES
            prep_ms = timed_ms(lambda: march.prepare(
                vol, tf, cams[0], main_cfg, 1e-3), 3)
            samples = samples_needed(march.march_plain, args[:2])
            plain_ms = time_plain(
                lambda: march.march_plain(args[0]))
            nbytes = bound_bytes(args[0], rays, samples) + read_bytes(
                args[0].vol.numel() * 4, samples * 6 * 4)
            bound_ms, bound_by, ops_ms, bytes_ms = bound(
                samples * (FLOPS_PER_SAMPLE + FLOPS_PER_LIT_SAMPLE)
                + rays * FLOPS_PER_LIT_RAY, nbytes)
            res.setdefault(vname, {})[var] = dict(
                ms=ms, plain_ms=plain_ms, prep_ms=prep_ms, bound_ms=bound_ms,
                bound_by=bound_by, samples=samples, peak_mb=peak, own_mb=own)
            log(f"{vname}/conic_lit_700 ({var}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.2f} ms, prep {prep_ms:.4f} ms, needed samples "
                f"per frame {samples}, bound {ops_ms:.4f} ms (operations) / "
                f"{bytes_ms:.4f} ms (bytes); peak memory of prep + kernel "
                f"{peak:.1f} MiB ({own:.1f} MiB above the start)")
            del args
            torch.cuda.empty_cache()
    return errs


def mc_lit_render_phase(P, march, mc_vols, volumes, tf, rng, res) -> dict:
    """Phase 4g: 8 orbit frames after one warm-up through ``render()``:
    multichannel_304 on both 3-channel volumes (K1 mc) and conic lit a1 at
    700x700x500, eps 1e-3, on both volumes, with the interval TF (K1 lit)
    and with tf_lut=256 (K1 lut_lit), with the launches by variant set to
    0 just before and read just after -> {variant: launches}."""
    import torch

    rows = [("multichannel_304", vname, vol,
             P.RenderConfig(early_termination=1e-3, **MC_SHAPE), "mc")
            for vname, vol in mc_vols.items()]
    for var, lut in (("lit", 0), ("lut_lit", 256)):
        rows += [(f"conic_{var}_700", vname, vol,
                  P.RenderConfig(early_termination=1e-3, tf_lut=lut,
                                 **CONIC_LIT), var)
                 for vname, vol in volumes.items()]
    launches = {"mc": 0, "lit": 0, "lut_lit": 0}
    for row, vname, vol, cfg, var in rows:
        cams = orbit_cameras(P, rng)
        reset_launches(march)
        P.render(vol, tf, cams[-1], cfg)  # warm-up frame
        m0 = mem_reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        counts = dict(march.variant_launches)
        ms = start.elapsed_time(end) / len(imgs)
        peak, own = peak_mb(m0)
        label = f"{vname}/{row}"
        for img in imgs:
            check(tuple(img.shape) == (cfg.width, cfg.height, 4)
                  and bool(torch.isfinite(img).all()), f"{label}: bad image")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"{label}: image is background only ({fg})")
        frames = len(imgs) + 1  # and the warm-up frame
        check(counts[var] == frames and sum(counts.values()) == frames,
              f"{label}: launches {counts} for {frames} frames")
        launches[var] += counts[var]
        r = res[vname] if var == "mc" else res[vname][var]
        r.update(render_ms=ms, render_peak_mb=peak, render_own_mb=own)
        log(f"{label}: render() {ms:.4f} ms/frame, "
            f"{cfg.width * cfg.height / ms * 1e3:.4e} rays/s, K1 {var} "
            f"{r['ms']:.4f} ms, prep {r['prep_ms']:.4f} ms, launches {counts} "
            f"for {frames} frames (warm-up included), peak memory {peak:.1f} MiB ({own:.1f} "
            f"MiB above the start)")
        del imgs
        torch.cuda.empty_cache()
    return launches


def write_nifti_4d(path: str, data_xyzc: np.ndarray, cal_max: float) -> None:
    """A NIfTI-1 float32 file of an [X, Y, Z, C] array (channel-major on
    disk, as the 4-D reader expects)."""
    import struct

    x, y, z, c = data_xyzc.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 4, x, y, z, c, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 124, cal_max)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(np.ascontiguousarray(np.moveaxis(data_xyzc, -1, 0),
                                     np.float32).tobytes())


def mc_cli_phase(tmp: str, mc_data: np.ndarray, from_text) -> None:
    """Phase 5i: the CLI ``render`` and ``fit`` on a 4-D .nii written with
    numpy (bench.py's 3-channel 91^3 volume, multichannel_304's shapes),
    and ``render --conic --lighting`` at 700x700x500."""
    import torch

    path = os.path.join(tmp, "mc.nii")
    write_nifti_4d(path, mc_data, 255.0)
    shape = ["--width", "304", "--height", "304", "--spr", "300"]
    out = os.path.join(tmp, "mc.png")
    out_tf = os.path.join(tmp, "mc_fit.txt")
    conic = os.path.join(tmp, "conic_lit.png")
    for args, size in (
            (["render", "--data", path, *shape, "--out", out], 304),
            (["fit", "--data", path, *shape, "--target", out, "--steps", "3",
              "--out-tf", out_tf], None),
            (["render", "--data", "sphere", "--width", str(W), "--height",
              str(H), "--spr", str(SPR), "--conic", "--lighting",
              "--camera", "0.9,0.5,1.0", "--out", conic], W)):
        run_cli(args)
        if size:
            check_png(args[-1], size, size)
    with open(out_tf) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == 4
          and bool(torch.isfinite(fitted.colors).all()),
          "cli fit of a 4-D volume wrote a bad transfer function")


def mc_lit_small_phase(P, march, sphere, tf) -> float:
    """Phase 6f: a small 4-D render (``rgb_sphere(64)``) and a small conic
    lit render (``centered_sphere(100)``) at 100x100x100 through the
    kernels against the back-to-front reference scan -> the max error."""
    from volumerenderingproject_tpu_torch.ingest import synthetic

    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    worst = 0.0
    for name, vol, c, var in (
            ("rgb_sphere(64)", synthetic.rgb_sphere(64), small, "mc"),
            ("sphere100 conic lit", sphere,
             small.replace(conic=True, lighting=True), "lit")):
        cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
        reset_launches(march)
        got = P.render(vol, tf, cam, c)
        check(march.variant_launches[var] == 1,
              f"{name}: launches {march.variant_launches}")
        ref = P.render(vol, tf, cam, c, mode="reference")
        e = float((got - ref).abs().max())
        log(f"{name} 100x100x100: K1 {var} vs back-to-front reference max "
            f"err {e:.3e} (tol {TOL_EXACT:g})")
        check(e <= TOL_EXACT, f"{name}: kernel vs reference scan {e}")
        worst = max(worst, e)
    return worst


def mesh_coords(shape):
    """Every coordinate of a (rays, samples, volume) mesh of ``shape``."""
    return [(r, s, v) for r in range(shape[0]) for s in range(shape[1])
            for v in range(shape[2])]


def unit_kwargs(vol, cfg, shape, coords) -> dict:
    """The keywords of ``march.prepare`` / ``a5.prepare_a5`` for the work
    unit at ``coords`` of a ``shape`` mesh, as parallel/render_dist.py
    cuts it."""
    from volumerenderingproject_tpu_torch.parallel import render_dist

    w, s, slab = render_dist.shard_sizes(vol, cfg, shape)
    ri, si, vi = coords
    kw = dict(x_offset=ri * w, local_width=w, s_start=si * s, s_count=s,
              segment=True)
    if slab:
        kw.update(x0=vi * slab, slab_x=slab)
    return kw


def seg_exact(kernel, plain, label, a) -> float:
    """A work unit's kernel (C, T) against its plain version's: bit-exact
    -> max abs error (0)."""
    import torch

    got = kernel(a)
    want = plain(a)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{label}: not finite")
    e = max(float((g - w).abs().max()) for g, w in zip(got, want))
    log(f"{label}: kernel vs plain (C, T) max err {e:.3e} (must be 0)")
    check(e == 0.0, f"{label}: max err {e}")
    return e


def unit_timing(P, kernel, plain, args, label, rays, grid_bytes,
                flops_per_sample, flops_per_ray, id_reads=1,
                ops_fn=None) -> dict:
    """ms per launch over every work unit in ``args``, the plain version's
    ms on the first, the mean samples a unit needs and the bound of the
    mean unit (with baked (M, S), their reads at the samples' voxels).
    ``ops_fn(args) -> (operations, samples)`` counts the operations where
    the samples' and rays' rates do not (a5_fwd_ops)."""
    def units():
        for a in args:
            kernel(a)

    ms = timed_ms(units, 5, prefill=True, label=label) / len(args)
    plain_ms = time_plain(lambda: plain(args[0]))
    if ops_fn is None:
        samples = samples_needed(plain, args)
        ops = samples * flops_per_sample + rays * flops_per_ray
    else:
        ops, samples = ops_fn(args)
    a = args[0]
    size = a.ids.element_size()
    nbytes = (read_bytes(grid_bytes, samples * id_reads * size)
              + a.colors.numel() * 4 + rays * 16)
    occ = getattr(a, "occ", None)
    if occ is not None:
        nbytes += occ.numel() * 4
    if a.mgrid is not None:
        nbytes += read_bytes((a.mgrid.numel() + a.sgrid.numel()) * 4,
                             samples * 8)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
    log(f"{label}: {ms:.4f} ms a unit, plain {plain_ms:.2f} ms, needed "
        f"samples a unit {samples}, bound {ops_ms:.4f} ms (operations) / "
        f"{bytes_ms:.4f} ms (bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, samples=samples, units=len(args))


def shard_kernel_phases(P, march, a5, volumes, mc_vols, dense, tf, a5_edge,
                        rng, res) -> dict:
    """Phases 3p (K1's segment and slab modes against ``march_plain``) and
    3q (K3's segment mode against ``march_a5_plain``), each bit-exact at eps
    0 -> max abs errors; the units' times and bounds go into ``res``."""
    import torch

    errs = {"segment": 0.0, "slab": 0.0, "a5_segment": 0.0}

    def k1(label, a):
        key = "slab" if a.slab_x else "segment"
        errs[key] = max(errs[key], seg_exact(
            march.march_kernel, march.march_plain, label, a))

    def k3(label, a):
        errs["a5_segment"] = max(errs["a5_segment"], seg_exact(
            a5.march_a5_kernel, a5.march_a5_plain, label, a))

    # ---- 3p. edge inputs: odd widths and sample starts, the first, a
    # middle and the last slab, negative front.x, TF(0).alpha -3e-5 / 0.05
    edge_rng = np.random.default_rng(50)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    odd4 = P.make_volume(edge_rng.uniform(-20, 255, (13, 17, 20, 3))
                         .astype(np.float32), cal_max=200.9)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    neg_x = P.Camera.initial(position=(0.6, 0.2, 0.7))
    check(float(neg_x.front[0]) < 0.0, "front.x of the mirrored camera")
    segs = [dict(x_offset=17, local_width=23, s_start=13, s_count=19),
            dict(x_offset=0, local_width=61, s_start=29, s_count=8)]
    slabs = [dict(x0=0, slab_x=5), dict(x0=5, slab_x=3),
             dict(x0=8, slab_x=5)]
    for tname, tfx in (("tf", tf),
                       ("alpha0_-3e-5", tf_with_alpha(P, tf, 0, -3e-5)),
                       ("alpha0_0.05", tf_with_alpha(P, tf, 0, 0.05))):
        for cname, cam, c in (("ortho", near, small),
                              ("negative_front_x", neg_x, small),
                              ("conic", near, small.replace(conic=True)),
                              ("lut96", near, small.replace(tf_lut=96))):
            for u in segs + [dict(segs[0], **s) for s in slabs]:
                k1(f"3p edge/{tname}/{cname}/{u}",
                   march.prepare(odd, tfx, cam, c, 0.0, segment=True, **u))
        for s in slabs:
            k1(f"3p edge/{tname}/mc/{s}",
               march.prepare(odd4, tfx, near, small, 0.0, segment=True,
                             **segs[0], **s))
        k1(f"3p edge/{tname}/eps1e-3",
           march.prepare(odd, tfx, near, small, 1e-3, segment=True,
                         **segs[0], **slabs[1]))

    # ---- 3p. the units of a (2, 2, 2) mesh at the main paths' shapes: the
    # MNI-dims volume splits into slabs of 91 planes
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    orbit_cam = orbit_cameras(P, rng, 1)[0]
    conic_cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    cases = [("plain", cfg, orbit_cam, SHARD_MESH),
             ("lut256", cfg.replace(tf_lut=256), orbit_cam, SHARD_MESH),
             ("baked_sobel_lit_700",
              P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"]), orbit_cam,
              (2, 2, 1)),
             ("conic_lit", P.RenderConfig(**CONIC_LIT), conic_cam, (2, 2, 1))]
    for vname, vol in volumes.items():
        for name, c, cam, shape in cases:
            for coords in mesh_coords(shape):
                k1(f"3p {vname}/{name}/{coords}", march.prepare(
                    vol, tf, cam, c, 0.0, **unit_kwargs(vol, c, shape,
                                                        coords)))
    mc_cfg = P.RenderConfig(**MC_SHAPE)
    mni3 = mc_vols["mni3_182x218x182"]
    for coords in mesh_coords(SHARD_MESH):
        k1(f"3p mni3/mc/{coords}", march.prepare(
            mni3, tf, orbit_cam, mc_cfg, 0.0,
            **unit_kwargs(mni3, mc_cfg, SHARD_MESH, coords)))
    lcfg = P.RenderConfig(**LARGE_SHAPE)
    k1("3p dense_320/(1, 1, 1)", march.prepare(
        dense, tf, orbit_cam, lcfg, 0.0,
        **unit_kwargs(dense, lcfg, SHARD_MESH, (1, 1, 1))))

    # times and bounds of the units at the render path's inputs (eps 1e-3)
    vol = volumes["mni_dims_182x218x182"]
    main_cfg = cfg.replace(early_termination=1e-3)
    for key, shape in (("segment", (2, 2, 1)), ("slab", SHARD_MESH)):
        args = [march.prepare(vol, tf, orbit_cam, main_cfg, 1e-3,
                              **unit_kwargs(vol, main_cfg, shape, xyz))
                for xyz in mesh_coords(shape)]
        grid = args[0].ids.numel()
        res[key] = unit_timing(
            P, march.march_kernel, march.march_plain, args,
            f"3p K1 {key} units of {shape}, MNI-dims 700x700x500",
            args[0].width * H, grid, FLOPS_PER_SAMPLE, 0)
        del args
    torch.cuda.empty_cache()

    # ---- 3q. K3's segment mode: the a5 edge inputs at odd offsets, then
    # the (2, 2, 1) units of a5_500 (unlit) and a5 lit 300^3 (baked)
    for name, evol, tfx, cam, c, eps in a5_edge:
        w = c.width
        for u in (dict(x_offset=w // 3, local_width=w - w // 3 - 1,
                       s_start=c.samples_per_ray // 3 + 1,
                       s_count=c.samples_per_ray // 2),
                  dict(x_offset=w - 1, local_width=1, s_start=0,
                       s_count=c.samples_per_ray)):
            k3(f"3q a5 edge/{name}/{u}",
               a5.prepare_a5(evol, tfx, cam, c, eps, segment=True, **u))
    a5_cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                            algorithm=P.Algorithm.TEST)
    a5_lit = P.RenderConfig(**A5_LIT, algorithm=P.Algorithm.TEST)
    for vname, vol in volumes.items():
        for name, c in (("a5_500", a5_cfg), ("a5_lit_300", a5_lit)):
            for coords in mesh_coords((2, 2, 1)):
                kw = unit_kwargs(vol, c, (2, 2, 1), coords)
                k3(f"3q {vname}/{name}/{coords}",
                   a5.prepare_a5(vol, tf, orbit_cam, c, 0.0, **kw))
    vol = volumes["mni_dims_182x218x182"]
    main_a5 = a5_cfg.replace(early_termination=1e-3)
    args = [a5.prepare_a5(vol, tf, orbit_cam, main_a5, 1e-3,
                          **unit_kwargs(vol, main_a5, (2, 2, 1), xyz))
            for xyz in mesh_coords((2, 2, 1))]
    res["a5_segment"] = unit_timing(
        P, a5.march_a5_kernel, a5.march_a5_plain, args,
        "3q K3 segment units of (2, 2, 1), MNI-dims a5_500",
        args[0].width * A5_H, args[0].ids.numel(), FLOPS_PER_A5_SAMPLE,
        FLOPS_PER_A5_RAY, 8,
        ops_fn=lambda xs: a5_fwd_ops(a5, xs, FLOPS_PER_A5_SAMPLE))
    del args
    torch.cuda.empty_cache()
    return errs


def shard_render_phase(P, launch, shard_worker, volumes, tf, rng, res
                       ) -> dict:
    """Phase 4h: sharded renders with 4 ranks on the one card, joined by
    gloo (the gathers go through the host), each rank on its own process:
    a1 700x700x500 on (2, 2, 1) and (1, 2, 2) on both volumes, conic a1 on
    (1, 2, 2), a5 500x500x500 on (2, 2, 1); at eps 0 every rank's image
    within TOL_EXACT of ``render()``, at eps 1e-3 within TOL_EPS of the
    exact render; each rank's K1 segment / slab and K3 segment launches
    counted (set to 0 on every rank just before its frames).  Then 1 rank
    through NCCL, bit-exact to ``render()``.  -> launches by kernel mode,
    summed over ranks and jobs."""
    import torch

    orbit_cam = orbit_cameras(P, rng, 1)[0]
    conic_cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    a5_cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                            algorithm=P.Algorithm.TEST)
    cpu_tf = tf.to("cpu")
    cpu_vols = {name: vol.to("cpu") for name, vol in volumes.items()}
    specs = []
    for vname, vol in volumes.items():
        for shape in SHARD_RUN_MESHES:
            specs.append((vname, vol, shape, orbit_cam, cfg))
        specs.append((vname, vol, (1, 2, 2), conic_cam,
                      cfg.replace(conic=True)))
    vol = volumes["mni_dims_182x218x182"]
    specs.append(("mni_dims_182x218x182", vol, (2, 2, 1), orbit_cam, a5_cfg))
    jobs, refs = [], {}
    # the slab scan (mode="scan", 7n's): a lit a1 and an a5 render on
    # (1, 1, 4), against the single-device scan; no kernel launches
    for c in (cfg.replace(lighting=True), a5_cfg):
        name = f"sphere100_{'lit' if c.lighting else 'a5'}_slab_scan_114"
        refs[name] = (P.render(volumes["sphere100"], tf, orbit_cam, c,
                               mode="scan"), 0.0, (1, 1, 4), c)
        jobs.append(dict(name=name, mesh=(1, 1, 4),
                         volume=cpu_vols["sphere100"], tf=cpu_tf,
                         camera=orbit_cam.to("cpu"), config=c, mode="scan"))
    for vname, vol, shape, cam, c in specs:
        exact = P.render(vol, tf, cam, c)  # eps 0: the exact render
        for eps in (0.0, 1e-3):
            name = (f"{vname}_{c.algorithm.name}{'_conic' if c.conic else ''}"
                    f"_{shape[0]}{shape[1]}{shape[2]}_eps{eps:g}")
            refs[name] = (exact, eps, shape, c)
            jobs.append(dict(name=name, mesh=shape, volume=cpu_vols[vname],
                             tf=cpu_tf, camera=cam.to("cpu"),
                             config=c.replace(early_termination=eps),
                             frames=SHARD_FRAMES if eps else 1))
    totals = {"segment": 0, "slab": 0, "a5_segment": 0}
    frame_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch.spawn(shard_worker.render_jobs, SHARD_RANKS, "gloo", jobs,
                     tmp, "gloo", "cuda")
        log(f"4h: {SHARD_RANKS} ranks (gloo) ran {len(jobs)} jobs in "
            f"{time.perf_counter() - t0:.1f} s")
        for job in jobs:
            exact, eps, shape, c = refs[job["name"]]
            tol = TOL_EXACT if eps == 0.0 else TOL_EPS
            a5_job = c.algorithm is P.Algorithm.TEST
            for r in range(SHARD_RANKS):
                base = os.path.join(tmp, f"{job['name']}.rank{r}")
                img = torch.from_numpy(np.load(base + ".npy")).to(
                    exact.device)
                with open(base + ".json") as f:
                    meta = json.load(f)
                check(tuple(img.shape) == tuple(exact.shape)
                      and bool(torch.isfinite(img).all()),
                      f"4h {job['name']} rank {r}: shape or not finite")
                e = float((img - exact).abs().max())
                check(e <= tol, f"4h {job['name']} rank {r}: max err {e}")
                frames = meta["frames"]
                if job.get("mode") == "scan":
                    got = {**meta["k1_shard"],
                           "a5_segment": meta["k3_segment"]}
                    want = dict.fromkeys(got, 0)
                elif a5_job:
                    got = {"a5_segment": meta["k3_segment"]}
                    want = {"a5_segment": frames}
                else:
                    slab = shape[2] > 1
                    got = meta["k1_shard"]
                    want = {"segment": 0 if slab else frames,
                            "slab": frames if slab else 0}
                check(all(got[k] == v for k, v in want.items()),
                      f"4h {job['name']} rank {r}: launches {got}, want "
                      f"{want}")
                for k, v in got.items():
                    totals[k] += v
                if r == 0:
                    log(f"4h {job['name']}: rank 0 max err {e:.3e} (tol "
                        f"{tol:g}), {meta['ms_per_frame']:.3f} ms/frame "
                        f"over {frames} frames on {meta['device']}, "
                        f"launches {got}")
                    if eps:
                        frame_ms[job["name"]] = meta["ms_per_frame"]
    res["frame_ms"] = frame_ms
    res["launches"] = dict(totals)

    # one rank through NCCL: the mesh (1, 1, 1) is the whole render
    exact = P.render(vol, tf, orbit_cam, cfg)
    job = dict(name="nccl_111", mesh=(1, 1, 1),
               volume=cpu_vols["mni_dims_182x218x182"],
               tf=cpu_tf, camera=orbit_cam.to("cpu"), config=cfg)
    with tempfile.TemporaryDirectory() as tmp:
        launch.spawn(shard_worker.render_jobs, 1, "nccl", [job], tmp,
                     "nccl", "cuda")
        img = torch.from_numpy(np.load(os.path.join(
            tmp, "nccl_111.rank0.npy"))).to(exact.device)
        with open(os.path.join(tmp, "nccl_111.rank0.json")) as f:
            meta = json.load(f)
    e = float((img - exact).abs().max())
    log(f"4h nccl (1, 1, 1): max err vs render() {e:.3e} (must be 0), "
        f"launches {meta['k1_shard']}")
    check(e == 0.0, f"4h nccl: max err {e}")
    check(meta["k1_shard"]["segment"] == 1, "4h nccl: K1 segment not run")
    totals["segment"] += 1
    res["launches"] = dict(totals)
    return totals


def shard_cli_phase(tmp: str, whole: str) -> None:
    """Phase 5j: the CLI ``render --mesh rays=2,samples=2 --backend gloo``
    (4 ranks on the one card) against ``whole``, the PNG of the same render
    on one device (phase 5's config, from ``cli.main``)."""
    from volumerenderingproject_tpu_torch.utils import imageio

    outs = {"whole": whole, "sharded": os.path.join(tmp, "mesh_sharded.png")}
    proc = subprocess.run(
        [sys.executable, "-m", "volumerenderingproject_tpu_torch",
         "render", "--data", "sphere", "--width", str(W), "--height",
         str(H), "--spr", str(SPR), "--out", outs["sharded"], "--mesh",
         "rays=2,samples=2", "--backend", "gloo"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"cli render sharded exit {proc.returncode}: "
        f"{proc.stdout.strip()} {proc.stderr.strip()[-2000:]}")
    check(proc.returncode == 0, "cli render sharded failed")
    check_png(outs["sharded"], W, H)
    a, b = (np.round(imageio.load_png(outs[k]) * 255.0).astype(np.int32)
            for k in ("whole", "sharded"))
    worst = int(np.abs(a - b).max())
    share = float((a != b).mean())
    log(f"5j: sharded CLI PNG vs whole: {worst} levels at most, "
        f"{share:.2e} of the channels differ")
    check(worst <= TOL_PNG_LEVELS and share < PNG_SHARE,
          f"5j: sharded PNG differs ({worst} levels, share {share})")


# ---- sharded fits ----------------------------------------------------------

def fold_mesh(P, render_dist, comp, vol, tf, cam, cfg, shape):
    """Every work unit of a ``shape`` mesh in this process, differentiable,
    folded as ``render_vrc_sharded`` folds what it gathers -> [W, H, 4]."""
    import torch

    n_rays, n_samp, n_vol = shape
    w = cfg.width // n_rays
    cols = []
    for ri in range(n_rays):
        segs = []
        for si in range(n_samp):
            units = [render_dist.render_segment(vol, tf, cam, cfg, shape,
                                                (ri, si, vi),
                                                differentiable=True)
                     for vi in range(n_vol)]
            segs.append(render_dist.fold_volume(
                [u[0] for u in units], [u[1] for u in units], cam, cfg,
                ri * w, w) if n_vol > 1 else units[0])
        seg = comp.fold_segments([x[0] for x in segs], [x[1] for x in segs])
        cols.append(comp.segment_finalize(seg, torch.tensor(
            cfg.background, dtype=torch.float32, device=seg[0].device)))
    return torch.cat(cols, dim=0)


def owned_samples(march, a) -> int:
    """The samples of a work unit that its slab owns (all of a segment's),
    off the volume too."""
    import torch

    if not a.slab_x:
        return a.width * a.height * a.spr
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    n = torch.zeros((), dtype=torch.int64, device=a.ids.device)
    for i in range(a.s_start, a.s_start + a.spr):
        n += march.owned_by(a, ids_at(i)[3]).sum()
    return int(n)


def shard_fit_kernel_phase(P, march, march_vjp, a5, a5_vjp, volumes, tf,
                           rng, res, libs=None) -> dict:
    """Phase 3r: the work units of sharded fits at the main paths' shapes
    (a1 700x700x500, ``sobel_lit_700``, ``a5_500``; eps 0) on both volumes:
    K1 baked slab units bit-exact to ``march_plain``; K4 segment and slab
    units, plain and baked, and K6 segment units within TOL_GRAD of max
    |dplain| under seeded cotangents; the units' dcolors summed over a
    (2, 2, 1) and a (1, 2, 2) mesh (a5: (2, 2, 1) and (1, 4, 1)) through
    the fold's cotangents within TOL_SHARD_SUM of the whole render's K4 /
    K6 dcolors; each variant's ms per launch over a mesh's units, its plain
    version's and its bound -> max errors (``res`` gets the times).  The
    units against plain versions: every unit on MNI-dims, the first and the
    last of each mesh on sphere100.  K4's spans are checked on the plain
    slab units on MNI-dims; K4's edges of units (on MNI-dims): the
    first and the last sample window of (1, 4, 1) and the first and the
    last slab of (1, 2, 2) under an ortho camera along x, whose slabs own
    the samples off the volume on their outer side.  With ``libs`` the K4 units of this tree and another
    checkout are timed in turns."""
    import torch

    from volumerenderingproject_tpu_torch.ops import composite as comp
    from volumerenderingproject_tpu_torch.parallel import render_dist

    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    lit = P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"])
    a5_cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                            algorithm=P.Algorithm.TEST)
    cam = orbit_cameras(P, rng, 1)[0]
    grad_rng = np.random.default_rng(53)
    errs = {"k1_baked_slab": 0.0, "k4_segment": [0.0, 0.0],
            "k4_segment_baked": [0.0, 0.0], "k4_slab": [0.0, 0.0],
            "k4_slab_baked": [0.0, 0.0], "k6_segment": [0.0, 0.0],
            "sum": 0.0}
    variants = (("k4_segment", cfg, (2, 2, 1)),
                ("k4_segment_baked", lit, (2, 2, 1)),
                ("k4_slab", cfg, (1, 2, 2)),
                ("k4_slab_baked", lit, (1, 2, 2)),
                ("k6_segment", a5_cfg, (2, 2, 1)))
    for vname, vol in volumes.items():
        # K1's baked slab: the forward of a lit slab's unit
        baked_slabs = [march_vjp.prepare_diff(
            vol, tf, cam, lit, **unit_kwargs(vol, lit, (1, 2, 2), xyz))[0]
            for xyz in mesh_coords((1, 2, 2))]
        for xyz, a in zip(mesh_coords((1, 2, 2)), baked_slabs):
            check(a.mgrid is not None and a.slab_x > 0, "3r: a baked slab")
            errs["k1_baked_slab"] = max(errs["k1_baked_slab"], seg_exact(
                march.march_kernel, march.march_plain,
                f"3r {vname}/K1 baked slab/{xyz}", a))
        if vname == "mni_dims_182x218x182":
            res["k1_baked_slab"] = unit_timing(
                P, march.march_kernel, march.march_plain, baked_slabs,
                f"3r K1 baked slab units of (1, 2, 2), {vname} "
                "sobel_lit_700 eps 0", baked_slabs[0].width * lit.height,
                baked_slabs[0].ids.numel(),
                FLOPS_PER_SAMPLE + FLOPS_PER_BAKED_SAMPLE, 0)
        del baked_slabs
        # K4 and K6 units against their plain versions, seeded cotangents
        for key, c, shape in variants:
            a5_unit = key.startswith("k6")
            kern, plain = ((a5_vjp.march_a5_bwd_kernel,
                            a5_vjp.march_a5_bwd_plain) if a5_unit else
                           (march_vjp.march_bwd_kernel,
                            march_vjp.march_bwd_plain))
            units = []
            coords = mesh_coords(shape)
            if vname != "mni_dims_182x218x182":  # every unit on MNI-dims
                coords = [coords[0], coords[-1]]
            for xyz in coords:
                kw = unit_kwargs(vol, c, shape, xyz)
                if a5_unit:
                    kw.pop("x0", None), kw.pop("slab_x", None)
                    a, _ = a5_vjp.prepare_a5_diff(vol, tf, cam, c, **kw)
                else:
                    a, _ = march_vjp.prepare_diff(vol, tf, cam, c, **kw)
                g = cotangents(a, grad_rng)
                e_abs, e_rel = unit_bwd_vs_plain(kern, plain,
                                                 f"3r {vname}/{key}/{xyz}",
                                                 a, g)
                errs[key] = [max(errs[key][0], e_abs),
                             max(errs[key][1], e_rel)]
                if key == "k4_slab" and vname == "mni_dims_182x218x182":
                    k4_span_check(march, march_vjp, a, g,  # ownership
                                  f"3r {vname}/{key}/{xyz}")
                units.append((a, g))
            if vname == "mni_dims_182x218x182":
                label = f"3r {key} units of {shape}, {vname}"
                res[key] = bwd_unit_timing(march, march_vjp, a5, a5_vjp,
                                           units, label, a5_unit)
                if libs is not None and not a5_unit:
                    res[key]["in_turns"] = k4_in_turns(march_vjp, libs,
                                                       units, label)
            del units
            torch.cuda.empty_cache()
        # K4's edges of units (on MNI-dims): sample windows before or after
        # many rays' spans, slabs that own samples off the volume on their
        # outer side
        along_x = P.Camera.initial(position=(1.3, 0.02, 0.03))
        for key, c, cam_u, shape in (("k4_segment", cfg, cam, (1, 4, 1)),
                                     ("k4_slab", cfg, along_x, (1, 2, 2))):
            if vname != "mni_dims_182x218x182":
                continue
            coords = mesh_coords(shape)
            for xyz in (coords[0], coords[-1]):
                a, _ = march_vjp.prepare_diff(
                    vol, tf, cam_u, c, **unit_kwargs(vol, c, shape, xyz))
                g = cotangents(a, grad_rng)
                label = f"3r {vname}/{key} edge/{shape}/{xyz}"
                if a.slab_x:
                    k4_span_check(march, march_vjp, a, g, label)
                e_abs, e_rel = unit_bwd_vs_plain(
                    march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
                    label, a, g)
                errs[key] = [max(errs[key][0], e_abs),
                             max(errs[key][1], e_rel)]
                del a, g
            torch.cuda.empty_cache()
        # the units' dcolors summed through the fold's cotangents against
        # the whole render's
        for c, shapes, whole in (
                (cfg, SHARD_FIT_MESHES, march_vjp.render_vrc_diff),
                (lit, SHARD_FIT_MESHES, march_vjp.render_vrc_diff),
                (a5_cfg, ((2, 2, 1), (1, 4, 1)), a5_vjp.render_test_diff)):
            g_img = torch.tensor(grad_rng.normal(
                0.0, 1.0, (c.width, c.height, 4)).astype(np.float32)
                / np.float32(c.width * c.height), device=tf.colors.device)

            def dcolors(render):
                colors = tf.colors.clone().requires_grad_()
                img = render(P.TransferFunction(tf.lower, tf.upper, colors,
                                                tf.hg_g))
                img.backward(g_img)
                return colors.grad

            want = dcolors(lambda t2: whole(vol, t2, cam, c))
            scale = float(want.abs().max())
            check(scale > 0.0, "3r: the whole render's dcolors are 0")
            for shape in shapes:
                got = dcolors(lambda t2: fold_mesh(
                    P, render_dist, comp, vol, t2, cam, c, shape))
                e = float((got - want).abs().max()) / scale
                name = (f"{c.algorithm.name}{' lit' if c.lighting else ''} "
                        f"{shape}")
                log(f"3r {vname}/{name}: units' summed dcolors vs the "
                    f"whole render's, max err {e:.3e} of max |d| {scale:.3e}"
                    f" (tol {TOL_SHARD_SUM:g})")
                check(e <= TOL_SHARD_SUM, f"3r {vname}/{name}: {e}")
                errs["sum"] = max(errs["sum"], e)
            torch.cuda.empty_cache()
    return errs


def unit_bwd_vs_plain(kernel, plain, label, a, g):
    """``bwd_vs_plain`` for a work unit, which may own no sample that
    reaches the gradient: then the kernel's dcolors must be exactly 0 as
    well."""
    import torch

    want = plain(a, *g)
    if float(want.abs().max()) > 0.0:
        return bwd_vs_plain(kernel, plain, label, a, g)
    got = kernel(a, *g)
    torch.cuda.synchronize()
    e = float(got.abs().max())
    log(f"{label}: the unit's plain dcolors are 0; kernel max |d| {e:.3e} "
        "(must be 0)")
    check(e == 0.0, f"{label}: kernel dcolors {e} where plain ones are 0")
    return 0.0, 0.0


def bwd_unit_timing(march, march_vjp, a5, a5_vjp, units, label,
                    a5_unit) -> dict:
    """ms per launch of a backward kernel over a mesh's work units (each
    with its cotangents), the plain version's ms on the first unit, and the
    bound of the mean unit: the samples inside the volume (at eps 0, the
    plain forward's count) and the unit's other samples that it owns, by
    the FLOPS_PER_BWD_* (FLOPS_PER_A5_BWD_*) rule of phases 3b and 3d."""
    kern = (a5_vjp.march_a5_bwd_kernel if a5_unit
            else march_vjp.march_bwd_kernel)
    plain = (a5_vjp.march_a5_bwd_plain if a5_unit
             else march_vjp.march_bwd_plain)

    def launch_all():
        for a, g in units:
            kern(a, *g)

    ms = timed_ms(launch_all, 5, prefill=True, label=label) / len(units)
    a, g = units[0]
    plain_ms = time_plain(lambda: plain(a, *g))  # the check ran it
    if a5_unit:
        inside = samples_needed(a5.march_a5_plain, [u[0] for u in units])
        owned = a.width * a.height * a.spr
    else:
        inside = samples_needed(lambda x, st: march.march_plain(
            march_vjp._fwd_args(x), st), [u[0] for u in units])
        owned = sum(owned_samples(march, u[0]) for u in units) / len(units)
    rays = a.width * a.height
    k = a.colors.shape[0]
    baked = a.mgrid is not None
    nbytes = (read_bytes(a.ids.numel(), inside * (8 if a5_unit else 1))
              + rays * 16 + k * 16
              + (a5_vjp if a5_unit else march_vjp).num_blocks(
                  a.width, a.height) * k * 16)
    if baked:
        nbytes += read_bytes((a.mgrid.numel() + a.sgrid.numel()) * 4,
                             inside * 8)
    if a5_unit:
        per_inside = (FLOPS_PER_A5_BWD_SAMPLE
                      + min(8, k) * FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL)
        per_ray = FLOPS_PER_A5_BWD_RAY
    else:
        per_inside = FLOPS_PER_BWD_SAMPLE + (
            FLOPS_PER_BWD_BAKED_SAMPLE if baked else 0)
        per_ray = FLOPS_PER_BWD_RAY
    a0 = bwd_alpha0(a, a5.S_ID0 if a5_unit else march.S_ID0)
    ops = (inside * per_inside + bwd_outside_ops(owned - inside, rays, a0)
           + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL + per_ray))
    bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
    log(f"{label}: {ms:.4f} ms a unit, plain {plain_ms:.2f} ms, samples a "
        f"unit inside the volume {inside} of {owned} owned, bound "
        f"{ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, inside=inside, owned=owned,
                units=len(units))


def shard_fit_phase(P, fit, phong, launch, shard_worker, volumes, tf, rng,
                    res) -> dict:
    """Phase 7m: sharded fits with 4 ranks on the one card, joined by gloo,
    in one spawn, on the MNI-dims volume: a1 colour fits (700x700x500) on
    (2, 2, 1) and (1, 2, 2), a lit colour and light fit (``sobel_lit_700``)
    on (2, 2, 1), a lit colour fit on (1, 2, 2) and an a5 colour fit
    (``a5_500``) on (2, 2, 1).  Each job: SHARD_FIT_STEPS
    ``fit_transfer_function`` steps, after which every rank's parameters
    must be bit-equal; then one step (the warm-up) whose gradients, summed
    over the mesh, must lie within TOL_SHARD_SUM (of the largest component)
    of the single-device kernel fit's, and SHARD_FIT_TIMED timed steps with
    each rank's K1, K3, K4 and K6 launches counted by work unit.  Then 1
    rank through NCCL.  -> launches by kernel variant and unit, summed over
    ranks."""
    import torch

    vname = "mni_dims_182x218x182"
    vol = volumes[vname]
    cam = orbit_cameras(P, rng, 1)[0]
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    lit = P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"])
    a5_cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                            algorithm=P.Algorithm.TEST)
    start_tf, _ = lit_fit_start(P, phong, tf, rng, False)
    _, start_light = lit_fit_start(P, phong, tf, rng, True)
    # what each step launches on every rank: (K1 or K3 launches by variant
    # and unit, K4 or K6 launches by variant and unit)
    specs = [("a1_221", (2, 2, 1), cfg, None, "segment", "plain", 1),
             ("a1_122", (1, 2, 2), cfg, None, "slab", "plain", 1),
             ("lit_light_221", (2, 2, 1), lit, start_light, "segment",
              "baked", 1 + phong.N_LIGHT_PARAMS + 1),
             ("lit_122", (1, 2, 2), lit, None, "slab", "baked", 1),
             ("a5_221", (2, 2, 1), a5_cfg, None, "segment", "a5", 1),
             # the scan route (7n's): a LUT fit through the scan segments
             # and a light fit through the slab scan; no kernel launches,
             # step-1 gradients within TOL_EXACT of the single-device scan
             # route's
             ("lut_scan_221", (2, 2, 1), cfg.replace(tf_lut=256), None,
              "segment", "scan", 0),
             ("lit_light_slab_scan_122", (1, 2, 2), lit, start_light, "slab",
              "scan", 0)]
    jobs, singles = [], {}
    cpu = dict(volume=vol.to("cpu"), camera=cam.to("cpu"))
    for name, shape, c, light, _, var, _ in specs:
        mode = "scan" if var == "scan" else "fast"
        target = P.render(vol, tf, cam, c, mode=mode)
        jobs.append(dict(name=name, mesh=shape, tf=start_tf.to("cpu"),
                         config=c, target=target.cpu(), steps=SHARD_FIT_STEPS,
                         lr=FIT_LR, mode=mode,
                         timed_steps=1 if var == "scan" else SHARD_FIT_TIMED,
                         light=None if light is None else light.to("cpu"),
                         **cpu))
        params = fit.FitParams.init(start_tf, light=light)
        loss = fit.render_loss(params, start_tf, vol, cam, target, c,
                               mode=mode)
        loss.backward()
        singles[name] = [torch.zeros_like(p) if p.grad is None
                         else p.grad.detach() for p in params.parameters()]
    totals = {"k1_segment": 0, "k1_slab": 0, "k1_baked_segment": 0,
              "k1_baked_slab": 0, "k4_segment": 0, "k4_slab": 0,
              "k4_segment_baked": 0, "k4_slab_baked": 0, "k3_segment": 0,
              "k6_segment": 0}
    step_ms, grad_errs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch.spawn(shard_worker.fit_jobs, SHARD_RANKS, "gloo", jobs, tmp,
                     "gloo", "cuda")
        log(f"7m: {SHARD_RANKS} ranks (gloo) ran {len(jobs)} fit jobs in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, shape, c, light, unit, var, k1_per in specs:
            outs, metas = [], []
            for r in range(SHARD_RANKS):
                base = os.path.join(tmp, f"{name}.rank{r}")
                outs.append(dict(np.load(base + ".npz")))
                with open(base + ".json") as f:
                    metas.append(json.load(f))
            n = len(singles[name])
            for r in range(1, SHARD_RANKS):
                check(all(np.array_equal(outs[r][f"p{i}"], outs[0][f"p{i}"])
                          for i in range(n)),
                      f"7m {name}: rank {r}'s parameters differ")
            check(all(np.isfinite(outs[0]["losses"])),
                  f"7m {name}: loss not finite")
            errs = []
            for i, want in enumerate(singles[name]):
                got = torch.from_numpy(outs[0][f"g{i}"]).to(want.device)
                scale = float(want.abs().max())
                errs.append(float((got - want).abs().max()) / scale
                            if scale > 0 else float(got.abs().max()))
            grad_errs[name] = max(errs)
            tol = TOL_EXACT if var == "scan" else TOL_SHARD_SUM
            check(grad_errs[name] <= tol,
                  f"7m {name}: step-1 gradients vs the single-device fit's "
                  f"{errs}")
            steps = metas[0]["steps"]
            for r, m in enumerate(metas):
                if var == "scan":
                    got = (sum(m["k1_shard"].values())
                           + sum(m["k4_shard"].values()) + m["k3_segment"]
                           + m["k6_segment"],)
                    check(got == (0,), f"7m {name} rank {r}: a kernel "
                          f"launched {m}")
                    continue
                if var == "a5":
                    got = (m["k3_segment"], m["k6_segment"])
                else:
                    got = (m["k1_shard"][unit], m["k4_shard"][unit])
                want = (k1_per * steps, steps)
                check(got == want, f"7m {name} rank {r}: launches {got} "
                      f"(K1/K3, K4/K6), want {want}")
                if var == "a5":
                    totals["k3_segment"] += got[0]
                    totals["k6_segment"] += got[1]
                else:
                    pre = "k1_baked_" if var == "baked" else "k1_"
                    totals[pre + unit] += got[0]
                    totals[f"k4_{unit}" + ("_baked" if var == "baked"
                                           else "")] += got[1]
            step_ms[name] = metas[0]["ms_per_step"]
            log(f"7m {name} {shape}: rank 0 {step_ms[name]:.3f} ms/step over "
                f"{steps} steps, step-1 gradients vs single-device max err "
                f"{grad_errs[name]:.3e} (tol {tol:g}), losses "
                f"{outs[0]['losses'].tolist()}, launches K1 "
                f"{metas[0]['k1_shard']} {metas[0]['k1']}, K4 "
                f"{metas[0]['k4_shard']} {metas[0]['k4']}, K3 segment "
                f"{metas[0]['k3_segment']}, K6 segment "
                f"{metas[0]['k6_segment']}")
    # one rank through NCCL: the mesh (1, 1, 1), one segment unit a step
    job = dict(jobs[0], name="nccl_111", mesh=(1, 1, 1))
    with tempfile.TemporaryDirectory() as tmp:
        launch.spawn(shard_worker.fit_jobs, 1, "nccl", [job], tmp, "nccl",
                     "cuda")
        out = dict(np.load(os.path.join(tmp, "nccl_111.rank0.npz")))
        with open(os.path.join(tmp, "nccl_111.rank0.json")) as f:
            meta = json.load(f)
    errs = []
    for i, want in enumerate(singles["a1_221"]):
        got = torch.from_numpy(out[f"g{i}"]).to(want.device)
        errs.append(float((got - want).abs().max())
                    / float(want.abs().max()))
    steps = meta["steps"]
    log(f"7m nccl (1, 1, 1): {meta['ms_per_step']:.3f} ms/step, gradients "
        f"vs single-device max err {max(errs):.3e}, launches K1 "
        f"{meta['k1_shard']}, K4 {meta['k4_shard']}")
    check(max(errs) <= TOL_SHARD_SUM, f"7m nccl: gradients {errs}")
    check(meta["k1_shard"]["segment"] == meta["k4_shard"]["segment"] == steps,
          f"7m nccl: launches {meta['k1_shard']} {meta['k4_shard']}")
    totals["k1_segment"] += steps
    totals["k4_segment"] += steps
    step_ms["nccl_111"] = meta["ms_per_step"]
    res["step_ms"] = step_ms
    res["grad_errs"] = grad_errs
    res["launches"] = dict(totals)
    return totals


# K1's chunks (csrc/march.cu kChunk): the brick test's grain, and with
# channel grids the batch of samples whose loads are issued together
# (kMcBatch) before they are composited in order
K1_CHUNK = 8


def k1_clip(march, a):
    """K1's clipped window of march input ``a``, per ray: (s_lo, s_hi)
    int64 [W, H], the unit's samples that may lie in the dataset box
    (``box_span`` of the box in scal, where the march is not full and the
    pad is finite), as the kernel takes it; its chunks start at s_lo."""
    import torch

    s = a.scal
    o, d = march._rays(a, a.x_offset, a.full_width)
    shape = (a.width, a.height)
    lo = torch.full(shape, a.s_start, dtype=torch.int64, device=s.device)
    hi = torch.full(shape, a.s_start + a.spr - 1, dtype=torch.int64,
                    device=s.device)
    if bool(s[march.S_FULL] > 0):
        return lo, hi
    ds, clip = s[march.S_DS], s[march.S_CLIP]
    pad = march.span_pad(o, d, ds, clip)
    b_lo, b_hi = march.box_span(o, d, s[march.S_BOX_LO:march.S_BOX_LO + 3],
                                s[march.S_BOX_HI:march.S_BOX_HI + 3], pad,
                                ds, clip, False)
    ok = pad >= 0.0
    return (torch.where(ok, torch.maximum(lo, b_lo), lo),
            torch.where(ok, torch.minimum(hi, b_hi), hi))


def k1_chunk_counts(march, a, stride: int = 4) -> dict:
    """Where K1's chunks fall on march input ``a``, on every ``stride``-th
    ray along each image axis, from the plain version's chain and
    transmittance (march_plain's float order): rays
    that stop (|T| <= eps) on the first sample of a chunk, on its last and
    inside it; rays whose clipped span is not a whole number of chunks; on
    a slab, rays with a chunk that holds samples of this slab and another;
    the samples inside the volume that a ray composites and those whose
    voxel is the one it composited last inside the volume (whose shade
    the in-kernel light computes again)."""
    import torch

    s = a.scal
    dev = s.device
    o, d = (x[::stride, ::stride] for x in march._rays(a, a.x_offset,
                                                        a.full_width))
    w, h = o.shape[:2]
    ids_at = march._sample_ids(a, o, d)
    alpha = march._effective_colors(a)[:, 3]
    eps = s[march.S_EPS].clamp_min(0.0)
    s_lo, s_hi = (x[::stride, ::stride] for x in k1_clip(march, a))
    t = torch.ones((w, h), dtype=torch.float32, device=dev)
    stop = torch.full((w, h), -1, dtype=torch.int64, device=dev)
    straddle = torch.zeros((w, h), dtype=torch.bool, device=dev)
    last_voxel = torch.full((w, h, 3), -1, dtype=torch.int64, device=dev)
    owned_prev = None
    inside = repeats = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.s_start, a.s_start + a.spr):
        active = t.abs() > eps
        mid, valid, _, ijk = ids_at(i)
        if a.slab_x:
            owned = march.owned_by(a, ijk)
            if owned_prev is not None:  # samples i - 1 and i in one chunk
                one_chunk = (i > s_lo) & (i <= s_hi) & ((i - s_lo)
                                                        % K1_CHUNK != 0)
                straddle |= one_chunk & (owned != owned_prev)
            owned_prev = owned
            active = active & owned
        shaded = active & valid
        inside = inside + shaded.sum()
        repeats = repeats + (shaded & (ijk == last_voxel).all(-1)).sum()
        last_voxel = torch.where(shaded[..., None], ijk, last_voxel)
        t_next = torch.where(active, t * (1.0 - alpha[mid]), t)
        stop = torch.where(active & ~(t_next.abs() > eps) & (stop < 0), i,
                           stop)
        t = t_next
    at = (stop - s_lo) % K1_CHUNK
    ended = stop >= 0
    span = s_hi - s_lo + 1
    return dict(
        stop_first=int((ended & (at == 0)).sum()),
        stop_last=int((ended & (at == K1_CHUNK - 1)).sum()),
        stop_inside=int((ended & (at > 0) & (at < K1_CHUNK - 1)).sum()),
        ragged_spans=int(((span > 0) & (span % K1_CHUNK != 0)).sum()),
        straddling=int(straddle.sum()), inside=int(inside),
        repeats=int(repeats))


# K1's index width at the edge of 2^31 (tests/test_torch_march_chain.py
# holds ops/march.index32 there): (dims, slab_x, channel grids, lit)
INDEX32_EDGES = (
    ((2**31 - 3, 1, 1), 0, 0, False), ((2**31 - 2, 1, 1), 0, 0, False),
    ((2**31 - 2, 1, 1), 0, 0, True), ((1289, 1290, 1290), 0, 0, False),
    ((1290, 1290, 1290), 0, 0, False), ((1290, 1290, 1290), 645, 0, False),
    ((1290, 1290, 1290), 0, 0, True), ((716, 1000, 1000), 0, 1, False),
    ((716, 1000, 1000), 0, 3, False), ((715, 1000, 1000), 0, 3, False),
    ((1000, 1000, 1000), 500, 3, False))


def index32_check(march, a) -> int:
    """The kernel's index-width rule (``vrp_march_a1_index32``) against its
    mirror ``march.index32`` on INDEX32_EDGES -> the cases that take 64
    bits.  ``a`` is any march input (the rule reads the shapes only)."""
    import ctypes

    import torch

    fn = march._kernel_lib().vrp_march_a1_index32
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    wide = 0
    for dims, slab_x, chans, lit in INDEX32_EDGES:
        b = a._replace(dims=dims, slab_x=slab_x,
                       chans=torch.zeros((chans, 1, 1, 1)) if chans else None,
                       vol=torch.zeros(1) if lit else None)
        got = bool(fn(*dims, slab_x, chans, int(lit)))
        check(got == march.index32(b), f"3s index width of {dims} slab "
              f"{slab_x} chans {chans} lit {lit}: kernel {got}")
        wide += not got
    log(f"3s index width: the kernel's rule equals ops/march.index32 on "
        f"{len(INDEX32_EDGES)} cases at the 2^31 edge ({wide} take 64 bits)")
    return wide


def wide_grid_args(P, march, variant: str, dims):
    """A march input on a grid past 32-bit indices: seeded random interval
    ids of the default TF, every brick occupied, 64x48 rays of 64 samples
    across the whole grid at eps 0; ``variant`` "plain", "mc" (3 seeded
    channel grids) or "lit" (conic rays, a seeded raw volume)."""
    import torch

    from volumerenderingproject_tpu_torch.ops.phong import default_light

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(71)
    tf = P.default_transfer_function()
    ids = torch.randint(0, tf.num_intervals, dims, generator=gen,
                        dtype=torch.uint8, device=dev)
    nb = tuple(-(-n // march.BRICK) for n in dims)
    occ = torch.ones(math.prod(nb), dtype=torch.int32, device=dev)
    depth = 0  # Volume.octree_depth
    while 2**depth < max(dims):
        depth += 1
    cfg = P.RenderConfig(width=64, height=48, samples_per_ray=64,
                         conic=variant == "lit")
    cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    scal = march.scal_vector(cam, cfg, dims, depth,
                             torch.tensor(255.0, device=dev), 0.0,
                             zero.bool(), zero)
    a = march.MarchArgs(scal=scal, colors=tf.colors.contiguous(), ids=ids,
                        occ=occ, nbricks=nb, dims=dims, depth=depth,
                        width=cfg.width, height=cfg.height,
                        spr=cfg.samples_per_ray, conic=cfg.conic,
                        density_scale=1.0)
    if variant == "mc":
        a = a._replace(chans=torch.rand((3,) + dims, generator=gen,
                                        device=dev))
    elif variant == "lit":
        a = a._replace(vol=torch.rand(dims, generator=gen, device=dev),
                       lvec=march.light_vector(default_light(dev)))
    return a


def k1_chunk_phase(P, march, march_vjp, phong, volumes, mc_vols, tf
                   ) -> None:
    """Phase 3s: K1 against march_plain, bit-exact at the same eps, where
    its chunks (the brick test's runs, and with channel grids the batches
    of loads) could go wrong: rays that stop on the first, the last and an
    inner sample of a chunk (eps 1e-3 under the default TF, eps 0.5 with
    the alphas of intervals 1-3 at 0.9, 0.95 and 0.9, at 700x700x500 on
    both volumes and at ``multichannel_304`` on the 3-channel MNI-dims
    volume), spans that are not a whole number of chunks, a segment unit
    (350 columns, up to 150 samples) whose s_start, 3 samples past the
    median ray's first, lies inside a chunk of many rays, slabs (planes
    91-181 and 60-119) whose chunks straddle the ownership plane (plain,
    LUT 256 and mc at eps 1e-3, baked at ``sobel_lit_700`` and eps 0), the
    in-kernel light at 500 samples a ray on ``centered_sphere(100)`` at
    eps 1e-3 (phase 3o holds it at eps 0), where a ray's samples repeat a
    voxel, and at the volume's faces (rays within 1e-7 of parallel to each
    face of a volume dense on its faces).  Each kind of case must occur
    (``k1_chunk_counts``, on every 4th ray each way).  Then the index width: the kernel's rule against
    ``march.index32`` at the 2^31 edge, and the plain, lit and mc variants
    on grids past it (1300^3 ids and volume; 3 x 800e6 channel voxels),
    whose rays read at indices past 2^31, bit-exact at eps 0."""
    import torch

    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    lit = P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"])
    high = tf
    for k, alpha in ((1, 0.9), (2, 0.95), (3, 0.9)):  # TF(0).alpha stays 0
        high = tf_with_alpha(P, high, k, alpha)
    cam = orbit_cameras(P, np.random.default_rng(60), 1)[0]
    total = {}

    def add(label, a, counts=True):
        if a.segment:
            seg_exact(march.march_kernel, march.march_plain, label, a)
        else:
            exact_vs_plain(march.march_kernel, march.march_plain, label, a)
        if not counts:
            return {}
        n = k1_chunk_counts(march, a)
        log(f"{label}: chunk counts {n}")
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        return n

    for vname, vol in volumes.items():
        for tname, tfx, eps in (("default", tf, 1e-3),
                                ("high_alpha", high, 0.5)):
            add(f"3s {vname}/{tname} eps {eps:g}", march.prepare(
                vol, tfx, cam, cfg.replace(early_termination=eps), eps))
    # the channel grids' batches of K1_CHUNK samples, on a slab too
    mc = P.RenderConfig(**MC_SHAPE)
    mni3 = mc_vols["mni3_182x218x182"]
    for tname, tfx, eps in (("default", tf, 1e-3), ("high_alpha", high, 0.5)):
        add(f"3s mni3/mc {tname} eps {eps:g}", march.prepare(
            mni3, tfx, cam, mc.replace(early_termination=eps), eps))
    for name in ("stop_first", "stop_last", "stop_inside", "ragged_spans"):
        check(total.get(name, 0) > 0, f"3s: no ray with {name}")

    vol = volumes["mni_dims_182x218x182"]
    whole = march.prepare(vol, tf, cam, cfg, 1e-3)
    half = W // 2
    lo_whole, hi_whole = (x[half:] for x in k1_clip(march, whole))
    # a window that starts 3 samples past the median ray's first sample
    s0 = int(lo_whole[hi_whole >= lo_whole].median()) + 3
    count = min(SPR - s0, SPR * 3 // 10)
    mid_chunk = int(((lo_whole < s0) & ((s0 - lo_whole) % K1_CHUNK != 0))
                    .sum())
    log(f"3s segment unit s_start {s0}: {mid_chunk} of {lo_whole.numel()} "
        f"rays have it inside a chunk of the whole ray")
    check(mid_chunk > 0, "3s: no ray with s_start inside a chunk")
    for eps in (1e-3, 0.0):
        add(f"3s mni/segment s_start {s0} eps {eps:g}", march.prepare(
            vol, tf, cam, cfg.replace(early_termination=eps), eps,
            x_offset=half, local_width=W - half, s_start=s0, s_count=count,
            segment=True), counts=False)

    def slabs(d1):  # from the middle plane, and the middle third
        return ((d1 // 2, d1 - d1 // 2), (d1 // 3, d1 // 3))

    straddling = 0
    for (x0, nx), (m0, mx) in zip(slabs(vol.dims[0]), slabs(mni3.dims[0])):
        name = f"slab_{x0}_{nx}"
        for tname, c in (("", cfg), ("_lut256", cfg.replace(tf_lut=256))):
            straddling += add(f"3s mni/{name}{tname} eps 1e-3",
                              march.prepare(vol, tf, cam, c, 1e-3, x0=x0,
                                            slab_x=nx, segment=True)
                              )["straddling"]
        a = march_vjp.prepare_diff(vol, tf, cam, lit, x0=x0, slab_x=nx,
                                   segment=True)[0]
        straddling += add(f"3s mni/baked {name} eps 0", a)["straddling"]
        straddling += add(f"3s mni3/mc slab_{m0}_{mx} eps 1e-3", march.prepare(
            mni3, tf, cam, mc, 1e-3, x0=m0, slab_x=mx, segment=True)
        )["straddling"]
    check(straddling > 0, "3s: no chunk straddles a slab's plane")

    sphere = volumes["sphere100"]
    conic = P.RenderConfig(**CONIC_LIT)
    light = colour_light(phong)
    repeats = inside = 0
    # phase 3o holds them at eps 0, and ortho rays under a light colour
    for name, c in (("conic", conic), ("conic_lut256",
                                       conic.replace(tf_lut=256))):
        n = add(f"3s sphere100/lit {name} eps 1e-3", march.prepare(
            sphere, tf, cam, c.replace(early_termination=1e-3), 1e-3))
        repeats, inside = repeats + n["repeats"], inside + n["inside"]
    log(f"3s sphere100 lit: {repeats} of {inside} shaded samples repeat "
        f"the voxel shaded before them ({repeats / max(inside, 1):.3f})")
    check(repeats > 0, "3s: no lit sample repeats a voxel")
    faces = faces_volume(P)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37,
                           lighting=True, conic=True)
    for face, side in ((0, 0), (0, 1), (1, 0), (1, 1)):
        a = march.prepare(faces, tf, near, small, 0.0, light=light)
        add(f"3s faces/lit near_parallel_face{face}_{side}",
            near_parallel_args(march, a, face, side, 1e-7), counts=False)

    # the index width: the rule at the 2^31 edge, then grids past it
    check(index32_check(march, whole) > 0, "3s: no case takes 64 bits")
    for variant, dims in (("plain", (1300, 1300, 1300)),
                          ("lit", (1300, 1300, 1300)),
                          ("mc", (800, 1000, 1000))):
        a = wide_grid_args(P, march, variant, dims)
        check(not march.index32(a), f"3s {variant} {dims}: 32-bit")
        o, d = march._rays(a)
        ids_at = march._sample_ids(a, o, d)
        # the last channel grid starts (channels - 1) grids in
        edge = 2**31 - (2 if variant == "mc" else 0) * math.prod(dims)
        past = sum(int((v & (f >= edge)).sum()) for v, f in (
            ids_at(i)[1:3] for i in range(a.spr)))
        log(f"3s {variant} {dims}: {past} samples read at indices past 2^31")
        check(past > 0, f"3s {variant} {dims}: no sample past 2^31")
        del ids_at
        add(f"3s {variant} {dims} (64-bit indices) eps 0", a, counts=False)
        del a
        torch.cuda.empty_cache()


# the a5 kernels' index width at the edge of 2^31 (tests/test_torch_a5_chain
# .py holds ops/a5.index32 there), and a grid past it
A5_INDEX32_EDGES = ((2**31 - 6, 1, 1), (2**31 - 5, 1, 1), (1289, 1289, 1289),
                    (1290, 1290, 1290), (1, 21844, 2**15), (1, 21845, 2**15),
                    (182, 218, 182), (512, 512, 512))
A5_WIDE_DIMS = (1300, 1300, 1300)


def a5_on_card(a):
    """An a5 march input of the CPU tests' scenes, its tensors on the
    card."""
    import torch

    dev = torch.device("cuda")

    def mv(t):
        return None if t is None else t.to(dev)

    return a._replace(scal=mv(a.scal), colors=mv(a.colors), ids=mv(a.ids),
                      mgrid=mv(a.mgrid), sgrid=mv(a.sgrid))


def k3_bits(a5, label, a) -> None:
    """K3 against march_a5_plain on march input ``a``: bit for bit (the
    image, or a unit's C and T)."""
    import torch

    got, want = a5.march_a5_kernel(a), a5.march_a5_plain(a)
    pairs = zip(got, want) if a.segment else [(got, want)]
    same = all(torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))
               for g, w in pairs)
    check(same, f"{label}: K3 not bit-exact to march_a5_plain")


def a5_span_counts(a5, a) -> dict:
    """Samples of march input ``a`` whose position lies in [0, dims)
    ("touch"), those in the rays' spans (``a5.sample_range``, the kernels'
    float order) and those that touch outside the spans ("lost", must be
    0), by the hoisted chain on the card."""
    import torch

    lo, hi = a5.sample_range(a)
    q = a5.ray_q(a)
    dims = torch.tensor(a.dims, dtype=torch.float32, device=q.device)
    touch = lost = torch.zeros((), dtype=torch.int64, device=q.device)
    for i in range(a.s_start, a.s_start + a.spr):
        p = a5.positions(a, q, i)
        ins = ((p >= 0.0) & (p < dims)).all(-1)
        touch = touch + ins.sum()
        lost = lost + (ins & ((i < lo) | (i > hi))).sum()
    return {"touch": int(touch), "lost": int(lost),
            "span": int((hi - lo + 1).clamp_min(0).sum())}


def k6_span_check(a5_vjp, label, a, g) -> float:
    """K6 against march_a5_bwd_plain (TOL_GRAD of max |dplain|) and its
    block partials (``per_block``) against the float64 sums of the plain
    terms over each block's rays (TOL_SPAN_F64 of their largest) -> that
    relative error."""
    bwd_vs_plain(a5_vjp.march_a5_bwd_kernel, a5_vjp.march_a5_bwd_plain,
                 label, a, g)
    got = a5_vjp.march_a5_bwd_kernel(a, *g, per_block=True).double()
    exact = a5_vjp.block_sums(a5_vjp.march_a5_bwd_plain(a, *g, per_ray=True),
                              a.width, a.height)
    scale = float(exact.abs().max())
    e_abs = float((got - exact).abs().max())
    e_rel = e_abs / scale if scale > 0.0 else (0.0 if e_abs == 0.0
                                               else math.inf)
    log(f"{label}: K6's {got.shape[0]} block partials vs the float64 sums of "
        f"the plain terms, max err {e_abs:.3e}, {e_rel:.3e} of their largest "
        f"(tol {TOL_SPAN_F64:g})")
    check(e_rel <= TOL_SPAN_F64, f"{label}: K6's block partials off the "
          f"float64 sums by {e_rel} of their largest")
    return e_rel


def wide_a5_args(P, a5, dims):
    """An a5 march input on a grid past 32-bit indices: seeded random
    interval ids of the default TF, 64x48 rays of 64 samples of an orbit
    camera across the whole grid, eps 0."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(72)
    tf = P.default_transfer_function()
    ids = torch.randint(0, tf.num_intervals, dims, generator=gen,
                        dtype=torch.uint8, device=dev)
    cfg = P.RenderConfig(width=64, height=48, samples_per_ray=64,
                         algorithm=P.Algorithm.TEST)
    cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    scal = a5.scal_vector(cam, dims, cfg, 0.0,
                          torch.zeros((), dtype=torch.int64, device=dev))
    return a5.A5Args(scal=scal, colors=tf.colors.contiguous(), ids=ids,
                     dims=dims, width=cfg.width, height=cfg.height,
                     spr=cfg.samples_per_ray)


def a5_span_phase(P, a5, a5_vjp, volumes, tf) -> dict:
    """Phase 3t: K3 bit-exact to march_a5_plain and K6 within TOL_GRAD of
    march_a5_bwd_plain, its block partials within TOL_SPAN_F64 of the
    float64 sums of the plain terms, where their spans could go wrong: the
    CPU tests' scenes (tests/_torch_a5_scenes.py: odd dims, orbits, a camera
    inside the volume, fronts along an axis, rays that miss, a step longer
    than a voxel, a 512-deep volume, segment units, rays stepped an ulp at
    a time across each face of the box at slopes 0.3 to 0), with
    TF(0).alpha 0 and 0.05, at eps 0 and 1e-3, baked; both volumes at
    ``a5_500`` with TF(0).alpha 0.05 and MNI-dims' (2, 2, 1) units and a5
    lit 300^3 with it; no sample inside the volume outside a span.  Then
    the index width: the kernels' rule against ``a5.index32`` at the 2^31
    edge, and K3 and K6 on a 1300^3 grid (64-bit indices) whose rays read
    past 2^31 -> the counts and the largest partials error."""
    import torch

    import _torch_a5_scenes as S

    res = {"k3": 0, "k6": 0, "lost": 0, "touch": 0, "span": 0, "f64": 0.0}
    grad_rng = np.random.default_rng(73)

    def spans(a):
        n = a5_span_counts(a5, a)
        for k in ("lost", "touch", "span"):
            res[k] += n[k]

    def k3(label, a):
        k3_bits(a5, label, a)
        res["k3"] += 1

    def k6(label, a):
        res["f64"] = max(res["f64"], k6_span_check(
            a5_vjp, label, a, cotangents(a, grad_rng)))
        res["k6"] += 1

    for name in S.SCENES:
        for alpha0 in (0.0, 0.05):
            for eps in (0.0, 1e-3):
                a = a5_on_card(S.scene(name, alpha0, eps))
                if eps == 0.0:
                    spans(a)
                    k6(f"3t {name} alpha0 {alpha0:g}", a)
                k3(f"3t {name} alpha0 {alpha0:g} eps {eps:g}", a)
    for name in ("orbit", "near", "inside"):
        for alpha0 in (0.0, 0.05):
            for j, kw in enumerate(S.units(name)):
                a = a5_on_card(S.scene(name, alpha0, 0.0, **kw))
                spans(a)
                k3(f"3t {name} unit {j} alpha0 {alpha0:g}", a)
                k6(f"3t {name} unit {j} alpha0 {alpha0:g}", a)
    pos, shape, cfg = S.SCENES["near"]
    for alpha0 in (0.0, 0.05):
        for eps in (0.0, 1e-3):
            k3(f"3t near baked alpha0 {alpha0:g} eps {eps:g}", a5_on_card(
                a5.prepare_a5(S.odd(shape), S.tf(alpha0), P.Camera.initial(
                    position=pos, device="cpu"), cfg.replace(lighting=True),
                    eps)))
    for face, side, slope in S.FACES:
        for alpha0 in (0.0, 0.05):
            a = a5_on_card(S.face_args(face, side, slope, alpha0))
            label = f"3t face {face} side {side} slope {slope:g} alpha0 " \
                    f"{alpha0:g}"
            spans(a)
            k3(label, a)
            if (face, side, slope) in S.FACE_CASES:
                k6(label, a)
    log(f"3t edge cases: {res['touch']} samples inside the volume, "
        f"{res['span']} in the spans, {res['lost']} inside outside a span "
        "(must be 0)")
    check(res["lost"] == 0, "3t: a span leaves out a sample inside the volume")

    # the main shapes with TF(0).alpha 0.05: every constant sample has alpha
    cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                         algorithm=P.Algorithm.TEST)
    tf05 = tf_with_alpha(P, tf, 0, 0.05)
    cam = orbit_cameras(P, np.random.default_rng(74), 1)[0]
    for vname, vol in volumes.items():
        for eps in (0.0, 1e-3):
            a = a5.prepare_a5(vol, tf05, cam, cfg, eps)
            k3(f"3t {vname} alpha0 0.05 eps {eps:g}", a)
        n = a5_span_counts(a5, a)
        log(f"3t {vname}: {n['touch']} of {A5_W * A5_H * A5_SPR} samples "
            f"inside the volume, {n['span']} in the spans "
            f"({n['span'] / max(n['touch'], 1):.3f} of them), {n['lost']} "
            "inside outside a span (must be 0)")
        check(n["lost"] == 0, f"3t {vname}: a span leaves out a sample")
        a, _ = a5_vjp.prepare_a5_diff(vol, tf05, cam, cfg)
        k6(f"3t {vname} alpha0 0.05", a)
    vol = volumes["mni_dims_182x218x182"]
    for xyz in mesh_coords((2, 2, 1)):
        kw = unit_kwargs(vol, cfg, (2, 2, 1), xyz)
        a, _ = a5_vjp.prepare_a5_diff(vol, tf05, cam, cfg, **kw)
        k3(f"3t mni unit {xyz} alpha0 0.05", a)
        k6(f"3t mni unit {xyz} alpha0 0.05", a)
    k3("3t mni a5_lit_300 alpha0 0.05", a5.prepare_a5(
        vol, tf05, cam, P.RenderConfig(**A5_LIT,
                                       algorithm=P.Algorithm.TEST), 0.0))

    # the index width: the rule at the 2^31 edge, then a grid past it
    import ctypes
    fn = a5._kernel_lib().vrp_a5_index32
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for dims in A5_INDEX32_EDGES:
        got = bool(fn(*dims))
        check(got == a5.index32(dims), f"3t index width of {dims}: kernel "
              f"{got}")
    wide = sum(not a5.index32(d) for d in A5_INDEX32_EDGES)
    log(f"3t index width: the kernels' rule equals ops/a5.index32 on "
        f"{len(A5_INDEX32_EDGES)} cases at the 2^31 edge ({wide} take 64 "
        "bits)")
    a = wide_a5_args(P, a5, A5_WIDE_DIMS)
    check(not a5.index32(a.dims), "3t: the wide grid takes 32 bits")
    corners = a5._corners(a)
    past = sum(int((c[2] & (c[3] >= 2**31)).sum())
               for c in (corners(i) for i in range(a.spr)))
    log(f"3t {A5_WIDE_DIMS}: {past} samples inside read at indices past "
        "2^31")
    check(past > 0, "3t: no sample reads past 2^31")
    k3(f"3t {A5_WIDE_DIMS} (64-bit indices)", a)
    k6(f"3t {A5_WIDE_DIMS} (64-bit indices)", a)
    del a, corners
    torch.cuda.empty_cache()
    log(f"3t: K3 bit-exact on {res['k3']} inputs, K6 on {res['k6']}, its "
        f"block partials within {res['f64']:.3e} of the float64 sums")
    return res


# ---- the scan route -----------------------------------------------------------

# phase 7n: every full-width scan-route fit takes one warm-up step and these
# timed steps; its peak device memory above the start stays below
# SCAN_PEAK_MIB; the scan route agrees with the kernels where both apply
# within TOL_SCAN_LOSS (the loss, relative) and TOL_GRAD (each gradient, of
# its largest component)
SCAN_FIT_TIMED = 1
SCAN_PEAK_MIB = 8192
TOL_SCAN_LOSS = 1e-4
# two identical scan fits, where an autograd op's CUDA backward is not
# deterministic (relative); bit-equal expected
TOL_SCAN_DET = 1e-6


def kernel_counts(mods) -> tuple:
    """The launches of each kernel module so far."""
    return tuple(m.launches for m in mods)


def scan_fit_case(P, fit, mods, label, vol, cam, cfg, start_tf, target,
                  fit_bounds=False, light=None, repeat=False) -> dict:
    """One full-width fit through the scan route: SCAN_FIT_TIMED timed
    steps (CUDA events; no warm-up: the scan compiles and builds nothing,
    and earlier phases warmed the allocator), the peak device memory above
    the start, no hand-written kernel launched; with ``repeat`` the timed
    steps once more, their losses equal."""
    import torch

    def run(steps):
        return fit.fit_transfer_function(vol, cam, target, start_tf, cfg,
                                         steps=steps, learning_rate=FIT_LR,
                                         fit_bounds=fit_bounds, light=light,
                                         mode="scan")

    base = mem_reset()
    before = kernel_counts(mods)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, losses = run(SCAN_FIT_TIMED)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SCAN_FIT_TIMED
    _, above = peak_mb(base)
    launched = [a - b for a, b in zip(kernel_counts(mods), before)]
    log(f"7n {label}: scan-route fit losses {losses}, {ms:.1f} ms/step, "
        f"peak {above:.1f} MiB above the start, kernel launches {launched}")
    check(all(math.isfinite(v) for v in losses),
          f"7n {label}: loss not finite")
    check(not any(launched), f"7n {label}: a kernel launched {launched}")
    check(above <= SCAN_PEAK_MIB,
          f"7n {label}: peak {above:.1f} MiB above the start")
    out = dict(ms=ms, peak_mib=above, losses=losses)
    if repeat:
        _, again = run(SCAN_FIT_TIMED)
        det = max(abs(a - b) / abs(b) for a, b in zip(again, losses))
        log(f"7n {label}: the same steps again: losses {again} "
            f"({'bit-equal' if again == losses else f'max relative {det:.3e}'})")
        check(det <= TOL_SCAN_DET, f"7n {label}: the scan fit is not "
              f"deterministic ({det})")
        out["bit_equal"] = again == losses
    return out


def scan_fd_check(P, fit, phong, label, vol, cam, cfg, start_tf, target,
                  light) -> float:
    """The scan route's gradient (colours, density, the light's ten) at the
    start against a central difference of the loss along it, as phase 7."""
    import torch

    params = fit.FitParams.init(start_tf, light=light)
    fit.render_loss(params, start_tf, vol, cam, target, cfg,
                    mode="scan").backward()
    ps = params.parameters()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    check(math.isfinite(norm) and norm > 0.0, f"7n {label}: gradient {norm}")

    def moved(h):
        q = [p + (h / norm) * g for p, g in zip(ps, grads)]
        return fit.FitParams(tf_colors=q[0], density_scale=q[1],
                             light=phong.Light(*q[2:]))

    with torch.no_grad():
        up, down = moved(FD_STEP), moved(-FD_STEP)
        l_up, l_down = (float(fit.render_loss(q, start_tf, vol, cam, target,
                                              cfg, mode="scan"))
                        for q in (up, down))
        predicted = sum(float((g.double() * (u - d).double()).sum())
                        for g, u, d in zip(grads, up.parameters(),
                                           down.parameters()))
    err = abs((l_up - l_down) - predicted) / abs(predicted)
    log(f"7n {label}: |grad| {norm:.6g}; central difference {l_up - l_down:.6g}"
        f" against {predicted:.6g} predicted (relative err {err:.3e}, tol "
        f"{TOL_FD:g})")
    check(err <= TOL_FD and l_down < l_up,
          f"7n {label}: gradient check failed")
    return err


def scan_vs_kernels(P, fit, mods, label, vol, cam, cfg, start_tf, target,
                    fit_bounds=False) -> dict:
    """The loss and every gradient through the scan route against the
    kernels' route (eps 0) on the same inputs: the kernels launched only in
    the fast step."""
    got = {}
    for mode in ("fast", "scan"):
        before = kernel_counts(mods)
        params = fit.FitParams.init(start_tf, fit_bounds=fit_bounds)
        loss = fit.render_loss(params, start_tf, vol, cam, target, cfg,
                               mode=mode)
        loss.backward()
        launched = [a - b for a, b in zip(kernel_counts(mods), before)]
        got[mode] = (float(loss.detach()),
                     [p.grad for p in params.parameters()],
                     launched)
    (lf, gf, nf), (ls, gs, ns) = got["fast"], got["scan"]
    loss_err = abs(ls - lf) / abs(lf)
    errs = [float((b - a).abs().max()) / float(a.abs().max())
            for a, b in zip(gf, gs)]
    log(f"7n {label}: scan route vs kernels at eps 0: loss {ls:.9g} vs "
        f"{lf:.9g} (relative {loss_err:.3e}, tol {TOL_SCAN_LOSS:g}), "
        f"gradients max err of the largest {errs} (tol {TOL_GRAD:g}); "
        f"launches kernels {nf}, scan {ns}")
    check(loss_err <= TOL_SCAN_LOSS, f"7n {label}: losses {ls} vs {lf}")
    check(max(errs) <= TOL_GRAD, f"7n {label}: gradients {errs}")
    check(sum(nf) >= 2 and not any(ns),
          f"7n {label}: launches kernels {nf}, scan {ns}")
    return dict(loss_err=loss_err, grad_err=max(errs))


def scan_route_phase(P, fit, phong, mods, volumes, mc_vols, tf, rng) -> dict:
    """Phase 7n: fits through the scan route at full width, each on the
    MNI-dims volume (the 4-D one on its 3-channel twin) from the default TF
    with colours 1..3 moved by a seeded +-0.2 (the alphas scaled for the
    4-D fit), against the scan render of the default TF: (a) conic lit
    colour and light fit at 700x700x500 (central filter, presmooth 0; the
    light from ambient 0.7 and diffuse 0.2), with a central difference of
    its gradient and its steps repeated; (b) lit a5 colour fit at
    ``a5_500``; (c) a light fit through a LUT at ``lut_phong_300``; (d) a
    smooth lit bound fit at 700x700x500; (e) a conic scattered colour fit
    at ``sobel_lit_700``'s shape; (f) a lit 4-D alpha fit at
    ``multichannel_304``; (g) a 20-interval and an ``Interp.TRILINEAR_COLOR``
    colour fit at 700x700x500.  Then the scan route against K1/K4 baked
    (``sobel_lit_700``), K3/K6 (``a5_500``) and K8/K9 (the smooth bound fit
    at 700x700x500), eps 0.  -> ms/step and peak MiB by case."""
    import torch

    vol = volumes["mni_dims_182x218x182"]
    cam = orbit_cameras(P, rng, 1)[0]
    conic_cam = P.Camera.initial(position=(0.9, 0.5, 1.0))
    a1 = dict(width=W, height=H, samples_per_ray=SPR)
    start_tf, _ = lit_fit_start(P, phong, tf, rng, False)
    _, start_light = lit_fit_start(P, phong, tf, rng, True)
    default_light = phong.default_light()
    # 20 intervals of width 0.05 over [0, 1], seeded colours
    dev = tf.colors.device
    k = 20
    lo = torch.linspace(0.0, 0.95, k, device=dev)
    up = lo + 0.05
    up[0] = 1.0
    colors = torch.tensor(rng.uniform(0.0, 0.5, (k, 4)).astype(np.float32),
                          device=dev)
    colors[0, 3] = 0.0
    k20_start = P.TransferFunction(lo, up, colors, torch.zeros(k, device=dev))
    moved = colors.clone()
    moved[1:] += 0.1
    k20_target_tf = P.TransferFunction(lo, up, moved, k20_start.hg_g)
    mc_vol = mc_vols["mni3_182x218x182"]
    mc_colors = tf.colors.clone()
    mc_colors[1:, 3] *= MC_FIT_ALPHA_SCALE
    mc_start = P.TransferFunction(tf.lower, tf.upper, mc_colors, tf.hg_g)
    lower, upper = bounds_moved(tf)
    bound_start = P.TransferFunction(lower, upper, start_tf.colors, tf.hg_g)
    cases = [
        ("a conic lit colour and light fit 700x700x500", vol, conic_cam,
         P.RenderConfig(**a1, lighting=True, conic=True), start_tf, tf,
         start_light, False),
        ("b lit a5 colour fit a5_500", vol, cam,
         P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                        algorithm=P.Algorithm.TEST, lighting=True),
         start_tf, tf, None, False),
        ("c light fit lut_phong_300", vol, cam,
         P.RenderConfig(**LIT_CONFIGS["lut_phong_300"]), tf, tf, start_light,
         False),
        ("d smooth lit bound fit 700x700x500", vol, cam,
         P.RenderConfig(**a1, interp=P.Interp.TRILINEAR, lighting=True),
         bound_start, tf, None, True),
        ("e conic scattered colour fit 700x700x250", vol, conic_cam,
         P.RenderConfig(width=W, height=H, samples_per_ray=250,
                        scattering=True, conic=True), start_tf, tf, None,
         False),
        ("f lit 4-D alpha fit multichannel_304", mc_vol, cam,
         P.RenderConfig(**MC_SHAPE, lighting=True), mc_start, tf, None,
         False),
        ("g1 20-interval colour fit 700x700x500", vol, cam,
         P.RenderConfig(**a1), k20_start, k20_target_tf, None, False),
        ("g2 TRILINEAR_COLOR colour fit 700x700x500", vol, cam,
         P.RenderConfig(**a1, interp=P.Interp.TRILINEAR_COLOR), start_tf, tf,
         None, False),
    ]
    res = {}
    for label, v, c, cfg, start, target_tf, light, bounds in cases:
        with torch.no_grad():
            target = P.render(v, target_tf, c, cfg, mode="scan",
                              light=None if light is None else default_light)
        key = label.split()[0]
        res[key] = scan_fit_case(P, fit, mods, label, v, c, cfg, start,
                                 target, fit_bounds=bounds, light=light,
                                 repeat=key == "a")
        if key == "a":
            res[key]["fd_err"] = scan_fd_check(P, fit, phong, label, v, c,
                                               cfg, start, target, light)
    # the scan route against the kernels where both apply, eps 0
    smooth_cfg = P.RenderConfig(**a1, interp=P.Interp.TRILINEAR)
    for label, cfg, start, bounds in (
            ("K1/K4 baked, lit colour fit sobel_lit_700",
             P.RenderConfig(**LIT_CONFIGS["sobel_lit_700"]), start_tf, False),
            ("K3/K6, a5 colour fit a5_500",
             P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                            algorithm=P.Algorithm.TEST), start_tf, False),
            ("K8/K9, smooth bound fit 700x700x500", smooth_cfg, bound_start,
             True)):
        target = P.render(vol, tf, cam, cfg)
        res[label.split(",")[0]] = scan_vs_kernels(
            P, fit, mods, label, vol, cam, cfg, start, target,
            fit_bounds=bounds)
    return res


def write_nifti_3d(path: str, data: np.ndarray, cal_max: float) -> None:
    """A NIfTI-1 float32 file of an [X, Y, Z] array (x fastest on disk, as
    the reader expects)."""
    import struct

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 124, cal_max)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(np.ascontiguousarray(data, np.float32).tobytes())


def grey_depth(img, label: str) -> float:
    """A depth map: finite, in [0, 1], grey (r = g = b), alpha 1, and not
    blank -> its least depth."""
    check(bool(img.isfinite().all()), f"{label}: non-finite depth")
    d = img[..., 0]
    check(float(d.min()) >= 0.0 and float(d.max()) <= 1.0,
          f"{label}: depth outside [0, 1]")
    check(bool((img[..., 1] == d).all() and (img[..., 2] == d).all()),
          f"{label}: depth not grey")
    check(bool((img[..., 3] == 1.0).all()), f"{label}: alpha not 1")
    check(float(d.min()) < 1.0, f"{label}: no depth below the clear value")
    return float(d.min())


def point_phase(P, point_splat, mods, volumes, tf, rng) -> dict:
    """Phase 8a: the a0 point cloud through ``render()`` with
    ``Algorithm.POINT`` at 700x700 on both volumes: ms/frame (CUDA events
    around 8 orbit frames after one warm-up, mean), no hand-written kernel
    launched; the first frame against the same inputs rendered on the CPU
    (at most POINT_CPU_SHARE of the pixels differ, their count printed);
    the exact native rasterizer's ms (host clock, the device synchronized;
    the ndc and colours copied from the card) and its agreement with the
    approximation (more than 70 % of the pixels within 0.2,
    tests/test_native.py:140-142); ``render_points_depth`` and
    ``render_depth_vrc`` (500 samples per ray): finite, in [0, 1], grey,
    with their ms."""
    import torch

    res = {}
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR,
                         algorithm=P.Algorithm.POINT)
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[0], cfg)
        before = kernel_counts(mods)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frames = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(cams)
        check(kernel_counts(mods) == before,
              f"point/{vname}: a hand-written kernel launched")
        img = frames[0]
        check(tuple(img.shape) == (W, H, 4)
              and bool(img.isfinite().all())
              and bool((img[..., 3] == 1.0).all()),
              f"point/{vname}: bad frame")
        cpu = P.render(vol, tf, cams[0], cfg, device="cpu")
        differ = int((img.cpu() != cpu).any(-1).sum())
        check(differ <= POINT_CPU_SHARE * W * H,
              f"point/{vname}: {differ} pixels differ from the CPU's")
        fg = int((img[..., :3] != cpu.new_tensor(cfg.background[:3])
                  .to(img.device)).any(-1).sum())
        check(fg > 0, f"point/{vname}: no voxel drawn")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exact = point_splat.render_points(vol, tf, cams[0], cfg, exact=True)
        torch.cuda.synchronize()
        exact_ms = (time.perf_counter() - t0) * 1e3
        close = float(torch.isclose(exact[..., :3], img[..., :3], atol=0.2)
                      .all(-1).float().mean())
        check(close > 0.7, f"point/{vname}: exact vs approximation {close}")
        depth_cfg = cfg.replace(algorithm=P.Algorithm.VRC)
        d_pts = point_splat.render_points_depth(vol, cams[0], cfg)
        d_vrc = point_splat.render_depth_vrc(vol, tf, cams[0], depth_cfg)
        near = (grey_depth(d_pts, f"point depth/{vname}"),
                grey_depth(d_vrc, f"vrc depth/{vname}"))
        depth_ms = timed_ms(
            lambda: point_splat.render_points_depth(vol, cams[0], cfg), 1,
            windows=1)
        vrc_ms = timed_ms(
            lambda: point_splat.render_depth_vrc(vol, tf, cams[0], depth_cfg),
            1, windows=1, warm_up=False)
        res[vname] = dict(ms=ms, cpu_differ=differ, foreground=fg,
                          exact_ms=exact_ms, exact_close=close,
                          depth_ms=depth_ms, depth_vrc_ms=vrc_ms,
                          least_depth=near)
        log(f"point/{vname}: {ms:.4f} ms/frame (8 frames, {W}x{H}, {fg} "
            f"pixels drawn); vs the CPU {differ} pixels differ (limit "
            f"{POINT_CPU_SHARE:g} of {W * H}); exact {exact_ms:.2f} ms, "
            f"{close:.4f} of pixels within 0.2 of the approximation; depth "
            f"{depth_ms:.4f} ms, ray-cast depth {vrc_ms:.4f} ms (least "
            f"depths {near[0]:.4f}, {near[1]:.4f})")
    return res


def point_cli_phase(tmp: str) -> dict:
    """Phase 8b: the CLI's new commands in this process
    (``cli.main``): ``render --algorithm point`` on a seeded MNI-dims
    NIfTI that it writes (the native loader), with ``--depth``, with
    ``--orbit``, ``--exact-points`` and the ray caster's ``--depth``;
    ``orbit --frames 2``; ``bench --repeats 2`` (its rays/s JSON line);
    ``info`` on the NIfTI; ``compare`` (exit 0 against itself at 0.999,
    exit 1 below an unreachable threshold).  Every PNG passes
    ``check_png``."""
    nii = os.path.join(tmp, "mni_dims.nii")
    data = mni_like_volume(7)
    write_nifti_3d(nii, data, 255.0)

    size = ["--width", str(W), "--height", str(H), "--spr", str(SPR)]

    def run(argv, want=0) -> str:
        if argv[0] in ("render", "orbit", "bench"):
            argv = argv[:1] + size + argv[1:]
        return run_cli(argv, want)

    pngs = {}
    for name, flags in (
            ("point", ["--data", nii, "--algorithm", "point"]),
            ("point_depth", ["--data", nii, "--algorithm", "point",
                             "--depth"]),
            ("point_orbit", ["--data", nii, "--algorithm", "point",
                             "--orbit", "30,-20,0.1"]),
            ("point_exact", ["--algorithm", "point", "--exact-points"]),
            ("vrc_depth", ["--data", nii, "--depth", "--spr", "250"])):
        pngs[name] = os.path.join(tmp, f"cli_{name}.png")
        run(["render", *flags, "--out", pngs[name]])
        check_png(pngs[name], W, H)
    prefix = os.path.join(tmp, "cli_orbit_")
    run(["orbit", "--algorithm", "point", "--frames", "2", "--out-prefix",
         prefix])
    for i in range(2):
        check_png(f"{prefix}{i:04d}.png", W, H)
    out = run(["bench", "--repeats", "2"])
    line = json.loads(out.strip().splitlines()[-1])
    check(line["metric"] == f"rays_per_sec_{W}x{H}_spr{SPR}"
          and line["value"] > 0, f"bench line {line}")
    out = run(["info", "--data", nii])
    dims = ", ".join(str(d) for d in data.shape)
    check("SIZEOF_HDR: 348" in out and f"DIM: (3, {dims}, 1" in out,
          "info: header fields")
    run(["compare", "--ours", pngs["point"], "--golden", pngs["point"],
         "--threshold", "0.999"])
    run(["compare", "--ours", pngs["point"], "--golden", pngs["point_depth"],
         "--threshold", "1.5"], want=1)
    return dict(bench_rays_per_sec=line["value"])


def auto_route_phase(P, march, mods, vol, tf, rng) -> dict:
    """Phase 8c: the default route (``mode="auto"``) on MNI-dims: one frame
    of a conic scattered a1 render at 700x700x250, which ``mode="fast"``
    refuses: the scan route, logged, no kernel launched, finite; then one
    plain a1 frame at 700x700x500: the kernel route, one K1 launch."""
    import logging

    import torch

    from volumerenderingproject_tpu_torch.models.raycast import route_log

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    keep = Keep()
    route_log.addHandler(keep)
    level = route_log.level
    route_log.setLevel(logging.INFO)
    cam = orbit_cameras(P, rng, 1)[0]
    try:
        cfg = P.RenderConfig(width=W, height=H, samples_per_ray=250,
                             conic=True, scattering=True)
        before = kernel_counts(mods)
        t0 = time.perf_counter()
        img = P.render(vol, tf, cam, cfg)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        check(kernel_counts(mods) == before,
              "auto/conic scattered: a kernel launched")
        check(bool(img.isfinite().all()) and tuple(img.shape) == (W, H, 4),
              "auto/conic scattered: bad frame")
        check(len(seen) == 1 and "takes the scan route" in seen[0],
              f"auto/conic scattered: route {seen}")
        k1 = march.launches
        P.render(vol, tf, cam, P.RenderConfig(width=W, height=H,
                                              samples_per_ray=SPR))
        check(march.launches == k1 + 1 and "kernel route" in seen[-1],
              f"auto/plain: route {seen[-1:]}")
    finally:
        route_log.removeHandler(keep)
        route_log.setLevel(level)
    log(f"auto route: conic scattered 700x700x250 -> {seen[0]} "
        f"({scan_s:.2f} s a frame); plain a1 -> {seen[-1]}")
    return dict(scan_s=scan_s, routes=seen)


def dryrun_phase(dryrun) -> dict:
    """Phase 8d: ``dryrun_multichip(8)``, both configs' gates, on 8 gloo
    ranks that share the card (``parallel/launch.spawn``)."""
    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(8)
    secs = time.perf_counter() - t0
    check(out["a"]["err"] < 1e-5 and out["b"]["err"] < 1e-4,
          f"dryrun render errors {out['a']['err']}, {out['b']['err']}")
    res = dict(seconds=secs, a_err=out["a"]["err"], b_err=out["b"]["err"],
               a_loss=out["a"]["loss"], a_s=out["a"]["seconds"],
               b_s=out["b"]["seconds"])
    log(f"dryrun_multichip(8) on 8 gloo ranks on the card: {secs:.1f} s "
        f"(rank 0: config A {res['a_s']:.1f} s, B {res['b_s']:.1f} s)")
    return res


# ---- the render server, camera recovery and the last utilities ------------

SERVER_SIZE = {"width": 300, "height": 300, "spr": 300}  # the viewer's
SERVER_ORBITS = 8  # timed /render requests, stepping the viewer's orbit
VIEWER_ORBIT_STEP = 4.0  # degrees a keypress (harness/viewer.py)
# the requests of 9a: name -> (parameters, the kernel each launches once:
# K1's plain or baked variant (an ortho lit or scattered a1 frame), or K3)
SERVER_CASES = {
    "vrc": ({}, "plain"),
    "test": ({"algorithm": "test"}, "k3"),
    "point": ({"algorithm": "point"}, None),
    "lighting": ({"lighting": 1}, "baked"),
    "conic": ({"conic": 1}, "plain"),
    "scattering": ({"scattering": 1}, "baked"),
    "depth": ({"depth": 1}, None),
}
SERVER_POST = {"orbit": "30,-20,0.1"}
RECOVERY_SIZE = 100  # the targets' pixels a side (golden-named PNGs)
RECOVERY_SPR = 100
RECOVERY_DIRS, RECOVERY_ROLLS = 200, 8
# each target's camera: a coarse candidate (direction index, roll index)
# moved by multiples of the refinement's first step (0.05 rad)
RECOVERY_TARGETS = {1: (57, 3, (0.05, -0.05, 0.1)),
                    5: (131, 6, (-0.05, 0.1, -0.05))}
RECOVERY_NCC = 0.99
TOL_CONV3D = 1e-6  # conv3d on the card vs native.conv3d, of max |native|
TOL_UTIL = 1e-6  # composites and the texture quad, card vs CPU


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def asymmetric_volume(seed: int) -> np.ndarray:
    """The MNI-dims shells (``mni_like_volume``) with an off-centre block of
    the muscle interval that stands out of the outer shell, so that no
    rotation maps the volume, or its silhouette, onto itself."""
    vol = mni_like_volume(seed)
    vol[140:180, 150:215, 50:110] = 150.0
    return vol


def http(url: str, body: bytes | None = None) -> tuple:
    """(status, content type, body) of a GET, or a POST of JSON ``body``;
    an HTTP error's status and body, not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def server_phase(P, march, a5, nii: str, dev) -> dict:
    """Phase 9a: ``harness/server.serve`` of the seeded MNI-dims NIfTI on
    port 0, answered from a thread: ``/health``; ``GET /render`` at the
    viewer's 300x300x300 for vrc, test, point, and vrc with lighting,
    conic, scattering and depth; ``POST /render`` with an orbit; 400 for a
    bad algorithm and 404 for an unknown path.  K1's and K3's launches rise
    by the requests that take them.  Each PNG, decoded with the package's
    ``decode_png``, equals ``to_uint8(to_display(...))`` of the same config
    rendered directly here (``render()``, ``render_depth_vrc``): 0 pixels
    may differ.  Then the mean ms of SERVER_ORBITS requests that step the
    orbit as the viewer's A key does (host clock around each request)."""
    import threading
    import urllib.parse

    from volumerenderingproject_tpu_torch.harness import server
    from volumerenderingproject_tpu_torch.models import point_splat
    from volumerenderingproject_tpu_torch.utils import imageio

    httpd = server.serve(nii, port=0, device=dev)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    pngs, want = {}, {"plain": 0, "baked": 0, "k3": 0}

    def counts():
        return {"plain": march.variant_launches["plain"],
                "baked": march.variant_launches["baked"],
                "k3": a5.launches, "k1": march.launches}
    try:
        code, _, body = http(url + "/health")
        health = json.loads(body)
        check(code == 200 and health["volume"] == [182, 218, 182],
              f"9a: /health {code} {health}")
        before = counts()
        for name, (extra, kernel) in SERVER_CASES.items():
            q = urllib.parse.urlencode({**SERVER_SIZE, **extra})
            code, ctype, pngs[name] = http(f"{url}/render?{q}")
            check(code == 200 and ctype == "image/png",
                  f"9a: GET {name}: {code} {ctype}")
            if kernel:
                want[kernel] += 1
        code, ctype, pngs["post_orbit"] = http(
            url + "/render", json.dumps({**SERVER_SIZE,
                                         **SERVER_POST}).encode())
        check(code == 200 and ctype == "image/png", f"9a: POST {code}")
        want["plain"] += 1
        got = {k: v - before[k] for k, v in counts().items()}
        check(got == {**want, "k1": want["plain"] + want["baked"]},
              f"9a: launches {got}, want {want}")
        code, _, _ = http(url + "/render?algorithm=bogus")
        check(code == 400, f"9a: a bad algorithm answered {code}")
        code, _, _ = http(url + "/nope")
        check(code == 404, f"9a: an unknown path answered {code}")
        k1 = march.variant_launches["plain"]
        times = []
        for i in range(SERVER_ORBITS):
            q = urllib.parse.urlencode(
                {**SERVER_SIZE, "camera": "preset",
                 "orbit": f"{VIEWER_ORBIT_STEP * (i + 1):.3f},0.000,0.000"})
            t0 = time.perf_counter()
            code, _, png = http(f"{url}/render?{q}")
            times.append((time.perf_counter() - t0) * 1e3)
            check(code == 200 and imageio.decode_png(png).shape
                  == (SERVER_SIZE["height"], SERVER_SIZE["width"], 3),
                  f"9a: orbit request {i}: {code}")
        orbit_k1 = march.variant_launches["plain"] - k1
        check(orbit_k1 == SERVER_ORBITS,
              f"9a: {orbit_k1} K1 launches for {SERVER_ORBITS} requests")
        want["plain"] += orbit_k1
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "9a: the server thread did not stop")
    # the same configs rendered directly in this process
    vol = P.load_nifti(nii, device=dev)
    tf = P.default_transfer_function(dev)
    differ = {}
    for name in pngs:
        extra = SERVER_POST if name == "post_orbit" else SERVER_CASES[name][0]
        cfg = P.RenderConfig(
            width=SERVER_SIZE["width"], height=SERVER_SIZE["height"],
            samples_per_ray=SERVER_SIZE["spr"],
            algorithm=P.Algorithm[extra.get("algorithm", "vrc").upper()],
            lighting=bool(extra.get("lighting", 0)),
            scattering=bool(extra.get("scattering", 0)),
            conic=bool(extra.get("conic", 0)))
        cam = P.reset_preset(dev)
        if "orbit" in extra:
            yaw, pitch, zoom = (float(v) for v in extra["orbit"].split(","))
            cam = cam.orbit(math.radians(yaw), math.radians(pitch), zoom,
                            screen_w=cfg.real_screen_width,
                            screen_h=cfg.real_screen_height)
        if extra.get("depth"):
            img = point_splat.render_depth_vrc(vol, tf, cam, cfg)
        else:
            img = P.render(vol, tf, cam, cfg, device=dev)
        direct = imageio.to_uint8(imageio.to_display(img, cfg.algorithm))
        served = imageio.decode_png(pngs[name])
        differ[name] = int((served != direct[..., :3]).any(-1).sum())
    log(f"9a: server PNGs vs direct renders, pixels that differ: {differ}")
    check(not any(differ.values()), f"9a: served PNGs differ: {differ}")
    ms = sum(times) / len(times)
    log(f"9a: {SERVER_ORBITS} orbit requests at "
        f"{SERVER_SIZE['width']}x{SERVER_SIZE['height']}x{SERVER_SIZE['spr']}"
        f": mean {ms:.2f} ms a request ({[round(t, 2) for t in times]}); "
        f"K1 {want['plain']} plain and {want['baked']} baked, K3 "
        f"{want['k3']} launches; {nvidia_smi_line()}")
    return dict(request_ms=ms, request_times=times, differ=differ, **want)


def recovery_phase(P, march, a5, tmp: str, dev) -> dict:
    """Phase 9b: ``camera_recovery.recover_camera`` of an a1 and an a5
    target, each rendered at RECOVERY_SIZE^2 x RECOVERY_SPR from a known
    camera on a seeded asymmetric volume and written as a golden-named PNG,
    over RECOVERY_DIRS x RECOVERY_ROLLS candidates and one refinement
    round: the refined NCC at least RECOVERY_NCC, the seconds, and the K1
    or K3 launches, which must equal the renders the search scored (the
    candidates plus the refinement's, counted at the score function) ->
    the golden directory's path among the results."""
    from volumerenderingproject_tpu_torch.harness import camera_recovery as rec
    from volumerenderingproject_tpu_torch.utils import imageio

    vol = P.make_volume(asymmetric_volume(11), device=dev)
    tf = P.default_transfer_function(dev)
    goldens = os.path.join(tmp, "goldens")
    os.makedirs(goldens, exist_ok=True)
    dirs = rec.fibonacci_directions(RECOVERY_DIRS)
    rolls = np.linspace(0.0, 2 * math.pi, RECOVERY_ROLLS, endpoint=False,
                        dtype=np.float32)
    scored = [0]
    make_score = rec._make_score_fn

    def counting_score_fn(*args, **kwargs):
        score = make_score(*args, **kwargs)

        def counted(cam):
            scored[0] += 1
            return score(cam)
        return counted

    res = {"goldens": goldens}
    rec._make_score_fn = counting_score_fn
    try:
        for alg_id, (d, r, moved) in RECOVERY_TARGETS.items():
            alg = rec.ALGO_BY_ID[alg_id]
            truth = np.float64([dirs[d][0], dirs[d][1], rolls[r]]) + moved
            cfg = P.RenderConfig(width=RECOVERY_SIZE, height=RECOVERY_SIZE,
                                 samples_per_ray=RECOVERY_SPR, algorithm=alg)
            img = P.render(vol, tf, rec.angles_to_camera(
                *np.float32(truth), device=dev), cfg, device=dev)
            path = os.path.join(
                goldens, f"image_{RECOVERY_SIZE}x{RECOVERY_SIZE}_a{alg_id}"
                f"_spr{RECOVERY_SPR}.png")
            imageio.save_png(path, img, alg)
            mod = a5 if alg is P.Algorithm.TEST else march
            before, scored[0] = mod.launches, 0
            sync(dev)
            t0 = time.perf_counter()
            out = rec.recover_camera(path, vol, tf, n_dirs=RECOVERY_DIRS,
                                     n_rolls=RECOVERY_ROLLS, refine_rounds=1,
                                     verbose=False, device=dev)
            sync(dev)
            secs = time.perf_counter() - t0
            launches = mod.launches - before
            cands = RECOVERY_DIRS * RECOVERY_ROLLS
            kname = "k3" if alg is P.Algorithm.TEST else "plain"
            miss = float(np.abs(np.float32(out["angles"]) - np.float32(truth))
                         .max())
            log(f"9b: a{alg_id} recovery: {secs:.2f} s, {launches} "
                f"{'K3' if kname == 'k3' else 'K1'} launches ({cands} "
                f"candidates + "
                f"{scored[0] - cands} refinement renders); NCC "
                f"{out['ncc_search']:.6f} -> {out['ncc_refined']:.6f}; "
                f"angles {[round(a, 4) for a in out['angles']]}, truth "
                f"{[round(a, 4) for a in truth.tolist()]} (largest "
                f"difference {miss:.2e} rad)")
            check(launches == scored[0] > cands,
                  f"9b: a{alg_id}: {launches} launches for {scored[0]} "
                  f"scored renders")
            check(out["ncc_refined"] >= RECOVERY_NCC,
                  f"9b: a{alg_id}: refined NCC {out['ncc_refined']}")
            res[f"a{alg_id}"] = dict(seconds=secs, launches=launches,
                                     refine_renders=scored[0] - cands,
                                     ncc_search=out["ncc_search"],
                                     ncc_refined=out["ncc_refined"],
                                     angle_miss=miss)
            res[kname] = launches
    finally:
        rec._make_score_fn = make_score
    return res


def cli_window_phase(tmp: str, nii: str, goldens: str, dev) -> dict:
    """Phase 9c, in this process: ``render --window 1400x1400`` must write a
    valid 1400x1400 PNG; ``recover-golden`` over 9b's golden directory with
    the seeded MNI-dims NIfTI as ``--dataset``, 6 directions x 2 rolls,
    must write JSON that parses, one record a golden."""
    out = os.path.join(tmp, "window.png")
    run_cli(["render", "--data", nii, "--width", "300", "--height", "300",
             "--spr", "300", "--window", "1400x1400", "--out", out,
             "--device", str(dev)])
    check_png(out, 1400, 1400)
    cams = os.path.join(tmp, "recovered", "cameras.json")
    run_cli(["recover-golden", "--golden-dir", goldens, "--dataset", nii,
             "--out", cams, "--n-dirs", "6", "--n-rolls", "2", "--device",
             str(dev)])
    with open(cams) as f:
        recs = json.load(f)
    names = sorted(f for f in os.listdir(goldens) if f.endswith(".png"))
    check(sorted(recs) == names
          and all(len(r["angles"]) == 3 and math.isfinite(r["ncc_refined"])
                  for r in recs.values()),
          f"9c: recover-golden wrote {recs}")
    return {n: r["ncc_refined"] for n, r in recs.items()}


def utilities_phase(P, nii: str, dev) -> dict:
    """Phase 9d, the utilities on the card against the CPU: the min/max
    pyramid of the seeded MNI-dims volume bit for bit against
    ``native.build_pyramid`` (and ``trace_query``'s lines against the CPU
    pyramid's); ``conv3d(reference_kernel())`` within TOL_CONV3D of
    ``native.conv3d``; both composites of seeded samples and
    ``texture_quad_display`` of a 300x300 frame onto 1400x1400 within
    TOL_UTIL of the same calls on the CPU."""
    import torch

    from volumerenderingproject_tpu_torch import native
    from volumerenderingproject_tpu_torch.accel import pyramid
    from volumerenderingproject_tpu_torch.ops import composite, conv3d
    from volumerenderingproject_tpu_torch.utils import texture

    cpu = torch.device("cpu")
    vol = P.load_nifti(nii, device=dev)
    data = vol.data.cpu().numpy()
    pyr = pyramid.build_pyramid(vol)
    nmin, nmax = native.build_pyramid(data, vol.octree_depth)
    same = all(np.array_equal(g.cpu().numpy(), n) for g, n in zip(
        pyr.levels_min + pyr.levels_max, nmin + nmax))
    check(same and pyr.depth == len(nmin) - 1,
          "9d: the pyramid differs from native.build_pyramid")
    cpu_pyr = pyramid.build_pyramid(vol.to(cpu))
    for p in np.random.default_rng(90).random((16, 3)).tolist():
        a, b = [], []
        pyramid.trace_query(pyr, p, out=a.append)
        pyramid.trace_query(cpu_pyr, p, out=b.append)
        check(a == b, f"9d: trace_query at {p}: {a} vs {b}")
    conv = conv3d.conv3d(vol.data, conv3d.reference_kernel(dev))
    want = native.conv3d(data, conv3d.reference_kernel(cpu).numpy())
    conv_err = float(np.abs(conv.cpu().numpy() - want).max())
    check(conv_err <= TOL_CONV3D * float(np.abs(want).max()),
          f"9d: conv3d {conv_err}")
    rng = np.random.default_rng(91)
    samples = rng.random((64, 64, 128, 4)).astype(np.float32)
    samples[..., 3] *= 0.1
    bg = (0.2, 0.2, 0.2, 1.0)
    comp_err = {}
    for name in ("composite_back_to_front", "composite_front_to_back"):
        fn = getattr(composite, name)
        got = fn(torch.as_tensor(samples, device=dev), bg).cpu()
        comp_err[name] = float((got - fn(torch.as_tensor(samples), bg))
                               .abs().max())
    check(max(comp_err.values()) <= TOL_UTIL, f"9d: composites {comp_err}")
    frame = P.render(vol, P.default_transfer_function(dev), P.reset_preset(dev),
                     P.RenderConfig(width=300, height=300,
                                    samples_per_ray=300), device=dev)
    quad = texture.texture_quad_display(frame, 1400, 1400).cpu()
    tex_err = float((quad - texture.texture_quad_display(frame.cpu(), 1400,
                                                         1400)).abs().max())
    check(tex_err <= TOL_UTIL, f"9d: texture quad {tex_err}")
    log(f"9d: pyramid bit-equal to native ({pyr.depth + 1} levels); conv3d "
        f"max abs err {conv_err:.3e} (max |native| "
        f"{float(np.abs(want).max()):.1f}); composites {comp_err}; texture "
        f"quad {tex_err:.3e}")
    return dict(conv3d_err=conv_err, composite_err=comp_err,
                texture_err=tex_err)


class PhaseClock:
    """Prints each phase's seconds on a line of its own."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - self.t:.1f} s")
        self.t = now


def main(argv) -> int:
    import torch

    parent = None
    if argv:
        if len(argv) != 2 or argv[0] != "--parent":
            log(__doc__)
            return 2
        parent = os.path.abspath(argv[1])
        if not os.path.isdir(os.path.join(
                parent, "volumerenderingproject_tpu_torch", "csrc")):
            log(f"FAIL: --parent {argv[1]} holds no checkout of this package")
            return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA GPU")
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.diff import fit
    from volumerenderingproject_tpu_torch.ops import (
        _build, a5, a5_vjp, march, march_vjp, phong, smooth, smooth_vjp)
    from volumerenderingproject_tpu_torch.parallel import launch
    import _torch_shard_worker as shard_worker
    from volumerenderingproject_tpu_torch.scene.transfer_function import (
        from_text)

    # ---- 1. the card --------------------------------------------------------
    clock = PhaseClock()
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.time()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    # the parent's smooth kernels and K4 build beside this tree's
    parent_build = (None if parent is None
                    else start_tree_build(_build, parent))
    _build.build(sources)
    march._kernel_lib()
    march_vjp._kernel_lib()
    a5._kernel_lib()
    a5_vjp._kernel_lib()
    smooth._kernel_lib()
    smooth_vjp._kernel_lib()
    libs = None if parent is None else {
        "parent": tree_libs(parent_build),
        "this tree": {n: _build.load(n) for n in TREE_SOURCES}}
    log(f"built {sources} in {time.time() - t0:.2f} s")
    clock("1-2 card and build")

    # ---- 3. kernel vs plain on the card ------------------------------------
    tf = P.default_transfer_function()
    rng = np.random.default_rng(0)
    volumes = {
        "sphere100": synthetic.centered_sphere(100),
        "mni_dims_182x218x182": P.make_volume(mni_like_volume(0)),
    }
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    colors0 = tf.colors.clone()
    colors0[0, 3] = 0.05  # TF(0).alpha > 0: every skip turns off
    tf_alpha0 = P.TransferFunction(tf.lower, tf.upper, colors0, tf.hg_g)
    max_err = 0.0
    per_volume = {}

    def kernel_vs_plain(label, a, conic):
        return fwd_vs_plain(march.march_kernel, march.march_plain, label, a,
                            conic)

    # edge inputs at small shapes: odd dims, truncated cal_max, front clip,
    # overlapping and single-interval tables, density_scale, a conic camera
    # inside the volume, skipping off, a ragged sample count
    edge_rng = np.random.default_rng(1)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    overlap = from_text("a 0.2 0.5 0.1 0.2 0.3 0.4\nb 0.4 0.7 0.5 0.6 0.7 0.8\n"
                        "c 0.45 0.46 0.9 0.8 0.7 0.6\nd 0.8 0.9 1 0 1 0.5 0.3\n")
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    # a fit's first Adam step can drive an alpha of 0 below 0
    tf_neg = tf_with_alpha(P, tf, 0, -3e-5)
    edge_cases = [
        ("front_clip", tf, near, small.replace(front_clip=0.5), 0.0),
        ("overlapping_tf_density", overlap, P.reset_preset(),
         small.replace(density_scale=0.45), 0.0),
        ("single_interval_tf", from_text("glass 0 1"), near, small, 0.0),
        ("conic_inside_volume", tf, P.Camera.initial(position=(0.1, 0.05, 0.2)),
         small.replace(conic=True), 0.0),
        ("no_skipping_eps1e-3", tf, P.reset_preset(),
         small.replace(empty_space_skipping=False), 1e-3),
    ]
    for name, tfx, cam, c, eps in edge_cases + [
            ("negative_alpha0_eps0", tf_neg, near, small, 0.0)]:
        kernel_vs_plain(f"edge/{name}", march.prepare(odd, tfx, cam, c, eps),
                        c.conic)
    # rays within 1e-7 of parallel to a face, which the clip lost samples
    # of before it took the pad
    for face, side in ((0, 0), (0, 1), (1, 0), (1, 1)):
        kernel_vs_plain(f"edge/near_parallel_face{face}_{side}_eps0",
                        near_parallel_args(march, march.prepare(
                            odd, tf, near, small, 0.0), face, side, 1e-7),
                        False)
    for vname, vol in volumes.items():
        orbit_cam = orbit_cameras(P, rng, 1)[0]
        cases = [
            ("ortho_preset_eps0", tf, P.reset_preset(), cfg, 0.0),
            ("ortho_orbit_eps0", tf, orbit_cam, cfg, 0.0),
            ("ortho_orbit_eps1e-3", tf, orbit_cam, cfg, 1e-3),
            ("conic_eps0", tf, P.Camera.initial(position=(0.9, 0.5, 1.0)),
             cfg.replace(conic=True), 0.0),
            ("ortho_alpha0_eps0", tf_alpha0, orbit_cam, cfg, 0.0),
            ("ortho_negative_alpha0_eps0", tf_neg, orbit_cam, cfg, 0.0),
        ]
        exact = {}
        for name, tfx, cam, c, eps in cases:
            a = march.prepare(vol, tfx, cam, c, eps)
            got, want, e = kernel_vs_plain(f"{vname}/{name}", a, c.conic)
            if e is None:
                continue
            max_err = max(max_err, e)
            if eps == 0.0:
                exact[(id(tfx), id(cam))] = want
            else:
                ref = exact[(id(tfx), id(cam))]
                e2 = float((got - ref).abs().max())
                log(f"{vname}/{name}: kernel at eps {eps:g} vs exact plain "
                    f"max err {e2:.3e} (tol {TOL_EPS:g})")
                check(e2 <= TOL_EPS, f"{vname}/{name}: eps error {e2}")

        # kernel and plain times and the bound, at the main path's inputs
        cams = orbit_cameras(P, rng)
        eps = 1e-3
        args = [march.prepare(vol, tf, cam, cfg.replace(early_termination=eps),
                              eps) for cam in cams]

        def orbit_kernels():
            for a in args:
                march.march_kernel(a)

        kernel_ms = timed_ms(orbit_kernels, 5, prefill=True,
                             label=f"{vname}: march kernel x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: march.prepare(
            vol, tf, cams[0], cfg.replace(early_termination=eps), eps), 5)
        samples = samples_needed(march.march_plain, args)
        plain_ms = time_plain(lambda: march.march_plain(args[0]))
        voxels = math.prod(vol.dims)
        nbytes = (read_bytes(voxels, samples) + args[0].occ.numel() * 4
                  + args[0].colors.numel() * 4 + W * H * 16)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            samples * FLOPS_PER_SAMPLE, nbytes)
        per_volume[vname] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 samples=samples)
        log(f"{vname}: march kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms,"
            f" prep {prep_ms:.4f} ms, needed samples per frame {samples}, "
            f"bound {ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")

    clock("3 K1 vs plain")

    # ---- 3b. the backward kernel vs plain on the card ------------------------
    grad_rng = np.random.default_rng(2)
    bwd_abs = bwd_rel = 0.0
    away = away_camera(P, (0.9, 0.5, 1.0))
    for name, tfx, cam, c, _ in edge_cases + [
            ("alpha_one", tf_with_alpha(P, tf, 3, 1.0), near, small, 0.0),
            ("negative_alpha0", tf_neg, near, small, 0.0),
            ("k16", tf16(P, tf.colors.device), near, small, 0.0),
            ("density_0.45", tf, near, small.replace(density_scale=0.45), 0.0),
            # K4's spans: an id0 interval of alpha 1, rays that miss
            # the box, a step longer than a voxel
            ("alpha0_one", tf_with_alpha(P, tf, 0, 1.0), near, small, 0.0),
            ("alpha0_0.05", tf_with_alpha(P, tf, 0, 0.05), near, small, 0.0),
            ("all_rays_miss", tf, away, small, 0.0),
            ("all_rays_miss_alpha0_0.3", tf_with_alpha(P, tf, 0, 0.3), away,
             small, 0.0),
            ("step_longer_than_a_voxel", tf, near,
             small.replace(samples_per_ray=6), 0.0)]:
        a, _ = march_vjp.prepare_diff(odd, tfx, cam, c)
        e_abs, e_rel = bwd_vs_plain(
            march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
            f"edge/{name}", a, cotangents(a, grad_rng))
        bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
    for face, side in ((0, 0), (0, 1), (1, 0), (1, 1)):
        for tfx in (tf, tf_with_alpha(P, tf, 0, 0.05)):
            a = near_parallel_args(
                march, march_vjp.prepare_diff(odd, tfx, near, small)[0],
                face, side, 1e-7)
            label = (f"edge/near_parallel_face{face}_{side}"
                     f"{'_alpha0_0.05' if tfx is not tf else ''}")
            g = cotangents(a, grad_rng)
            k4_span_check(march, march_vjp, a, g, label)
            e_abs, e_rel = bwd_vs_plain(
                march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
                label, a, g)
            bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
    # work units of the edge volume (13 x-planes): the sample windows of a
    # (1, 4, 1) split, some wholly before or after a ray's span, and the
    # first and the last slab of (1, 1, 2) under rays along x, which own
    # the samples off the volume on their outer side
    along_x = P.Camera.initial(position=(1.3, 0.02, 0.03))
    c36 = small.replace(samples_per_ray=36)
    units = [(f"segment_{s0}", near, c36,
              dict(s_start=s0, s_count=9, segment=True))
             for s0 in (0, 9, 18, 27)]
    units += [(f"slab_{x0}_{nx}{'_along_x' if cam is along_x else ''}", cam,
               small, dict(x0=x0, slab_x=nx, segment=True))
              for cam in (along_x, near) for x0, nx in ((0, 6), (6, 7))]
    tf_a0 = tf_with_alpha(P, tf, 0, 0.05)
    for name, cam, c, kw in units:
        tfs = [("", tf)]
        if name not in ("segment_9", "segment_18"):
            tfs.append(("_alpha0_0.05", tf_a0))
        for tname, tfx in tfs:
            a, _ = march_vjp.prepare_diff(odd, tfx, cam, c, **kw)
            label = f"edge/unit_{name}{tname}"
            g = cotangents(a, grad_rng)
            k4_span_check(march, march_vjp, a, g, label)
            e_abs, e_rel = unit_bwd_vs_plain(
                march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain, label,
                a, g)
            bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
    bwd_cam = orbit_cameras(P, np.random.default_rng(3), 1)[0]
    for vname, vol in volumes.items():
        for name, cam, c in (
                ("ortho_orbit", bwd_cam, cfg),
                ("conic", P.Camera.initial(position=(0.9, 0.5, 1.0)),
                 cfg.replace(conic=True))):
            a, _ = march_vjp.prepare_diff(vol, tf, cam, c)
            g = cotangents(a, grad_rng)
            e_abs, e_rel = bwd_vs_plain(
                march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
                f"{vname}/{name}", a, g)
            bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
            if c.conic:
                continue
            spans = k4_span_check(march, march_vjp, a, g,
                                  f"{vname}/{name}")
            # times and the bound at the fit path's shapes
            bwd_ms = timed_ms(lambda: march_vjp.march_bwd_kernel(a, *g), 5,
                              prefill=True,
                              label=f"{vname}: backward kernel")
            if libs is not None:
                per_volume[vname]["k4_in_turns"] = k4_in_turns(
                    march_vjp, libs, [(a, g)], f"K4 plain {vname}")
            bwd_plain_ms = time_plain(
                lambda: march_vjp.march_bwd_plain(a, *g))
            fwd_eps0_ms = timed_ms(lambda: march.march_kernel(a), 5,
                                   prefill=True)
            k = a.colors.shape[0]
            samples = W * H * SPR  # every sample of every ray: no skip
            # at eps 0 no ray stops early: the samples inside the volume
            inside = samples_needed(march.march_plain, [a])
            nbytes = (read_bytes(math.prod(vol.dims), inside) + W * H * 16
                      + k * 16
                      + march_vjp.num_blocks(W, H) * k * 16)
            ops = (inside * FLOPS_PER_BWD_SAMPLE
                   + bwd_outside_ops(samples - inside, W * H,
                                     bwd_alpha0(a, march.S_ID0))
                   + W * H * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                              + FLOPS_PER_BWD_RAY))
            bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
            per_volume[vname].update(
                bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                fwd_eps0_ms=fwd_eps0_ms, bwd_bound_ms=bound_ms,
                bwd_bound_by=bound_by, bwd_inside=inside, bwd_spans=spans)
            log(f"{vname}: backward kernel {bwd_ms:.4f} ms, plain "
                f"{bwd_plain_ms:.2f} ms, forward kernel at eps 0 "
                f"{fwd_eps0_ms:.4f} ms, samples inside the volume {inside} "
                f"of {samples}, bound {ops_ms:.4f} ms (operations) / "
                f"{bytes_ms:.4f} ms (bytes)")

    clock("3b K4 vs plain")

    # ---- 3c, 3d. the a5 kernels (K3, K6) vs plain on the card ---------------
    a5_rng = np.random.default_rng(8)
    a5_edge = a5_edge_cases(P, tf, from_text)
    k3_err, k6_abs, k6_rel = a5_kernel_phases(
        P, a5, a5_vjp, volumes, tf, a5_edge, a5_rng, per_volume)
    clock("3c-3d K3, K6 vs plain")

    # ---- 3e, 3f. the lit and LUT variants of K1 and K3 vs plain ------------
    lit_rng = np.random.default_rng(11)
    lit_errs = lit_kernel_phases(P, march, a5, phong, volumes, tf, from_text,
                                 lit_rng, per_volume)
    clock("3e-3f K1, K3 lit and LUT variants vs plain")

    # ---- 3g, 3h. the smooth kernels (K8, K9) vs plain on the card ----------
    smooth_rng = np.random.default_rng(17)
    smooth_errs = smooth_kernel_phases(P, smooth, smooth_vjp, volumes, tf,
                                       from_text, smooth_rng, per_volume,
                                       libs)
    clock("3g-3h K8, K9 vs plain")

    # ---- 3i. F1: alphas above 1, T < 0 ----------------------------------------
    f1_errs = f1_phase(P, march, a5, smooth, volumes, tf,
                       np.random.default_rng(20))
    clock("3i alpha above 1")

    # ---- 3j. K4's baked, LUT and LUT + baked variants vs plain --------------
    k4_errs = k4_variant_phases(P, march, march_vjp, volumes, tf, from_text,
                                np.random.default_rng(21), per_volume, libs)
    clock("3j K4 variants vs plain")

    # ---- 3k. volumes beyond the TPU's resident budget: 320^3 and 512^3 -----
    large = {f"dense_{n}": dense_volume(P, n) for n in LARGE_SIZES}
    large_k = large_kernel_phases(P, march, march_vjp, a5, a5_vjp, smooth,
                                  smooth_vjp, phong, large, tf,
                                  np.random.default_rng(30), libs)
    clock("3k kernels vs plain at 320^3 and 512^3")

    # ---- 3l. scattered renders: K1 and K3 baked vs plain; the sweep --------
    scatter_k = scatter_kernel_phase(
        P, march, a5, phong, {"mni_dims_182x218x182":
                              volumes["mni_dims_182x218x182"],
                              "dense_320": large["dense_320"]}, tf,
        np.random.default_rng(32))
    sweep = sweep_phase(P, phong, large["dense_512"], tf)
    clock("3l scattered kernels vs plain, the sweep at 512^3")

    # ---- 3m, 3n. 4-D volumes: K1 mc and K4 mc vs plain ---------------------
    mc_vols = mc_volumes(P)
    mc_res = {}
    mc_errs = mc_kernel_phases(P, march, march_vjp, mc_vols,
                               mc_seeded_volumes(P), tf,
                               np.random.default_rng(43), mc_res)
    clock("3m-3n K1 mc, K4 mc vs plain")

    # ---- 3o. K1's in-kernel lighting vs plain -------------------------------
    lit_res = {}
    inkernel_errs = lit_inkernel_phase(P, march, phong, volumes, tf,
                                       np.random.default_rng(44), lit_res)
    clock("3o K1 in-kernel lighting vs plain")

    # ---- 3p, 3q. the work units of sharded renders vs plain ----------------
    shard_res = {}
    shard_errs = shard_kernel_phases(
        P, march, a5, volumes, mc_vols, large["dense_320"], tf, a5_edge,
        np.random.default_rng(51), shard_res)
    clock("3p-3q K1 segment and slab, K3 segment vs plain")

    # ---- 3r. the work units of sharded fits vs plain ------------------------
    shard_fit_res = {}
    shard_fit_errs = shard_fit_kernel_phase(
        P, march, march_vjp, a5, a5_vjp, volumes, tf,
        np.random.default_rng(54), shard_fit_res, libs)
    clock("3r K1 baked slab, K4 segment and slab, K6 segment vs plain")

    # ---- 3s. K1's chunks and index width vs plain ----------------------------
    k1_chunk_phase(P, march, march_vjp, phong, volumes, mc_vols, tf)
    clock("3s K1's chunks and index width vs plain")

    # ---- 3t. K3's and K6's spans and index width vs plain -------------------
    a5_spans = a5_span_phase(P, a5, a5_vjp, volumes, tf)
    clock("3t K3's and K6's spans and index width vs plain")

    # ---- 4. the render path -------------------------------------------------
    main_cfg = cfg.replace(early_termination=1e-3)
    frames = 0
    march.launches = 0
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], main_cfg)  # warm-up frame
        frames += 1
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, main_cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        frames += len(imgs)
        ms = start.elapsed_time(end) / len(imgs)
        for img in imgs:
            check(tuple(img.shape) == (W, H, 4), f"{vname}: shape {img.shape}")
            check(bool(torch.isfinite(img).all()), f"{vname}: not finite")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"{vname}: image is background only ({fg})")
        plain_frame_ms = time_plain(
            lambda: march.march_plain(march.prepare(
                vol, tf, cams[0], main_cfg, 1e-3)))
        per_volume[vname]["render_ms"] = ms
        log(f"{vname}: render() {ms:.4f} ms/frame, {W * H / ms * 1e3:.4e} "
            f"rays/s; plain march {plain_frame_ms:.2f} ms/frame")
    launches = march.launches
    log(f"march kernel launches on the main path: {launches} "
        f"for {frames} frames")
    check(launches == frames, f"launches {launches} != frames {frames}")
    clock("4 render path")

    # ---- 4b. the a5 render path ---------------------------------------------
    a5_launches = a5_render_phase(P, a5, volumes, tf, a5_rng, per_volume)
    clock("4b a5 render path")

    # ---- 4c. the lit render paths -------------------------------------------
    lit_launches = lit_render_phase(P, march, a5, volumes, tf, lit_rng,
                                    per_volume)
    clock("4c lit render paths")

    # ---- 4d. the smooth render path -----------------------------------------
    smooth_launches = smooth_render_phase(P, smooth, volumes, tf, smooth_rng,
                                          per_volume)
    clock("4d smooth render path")

    # ---- 4e. the streamed rows' render paths at 320^3 and 512^3 ------------
    large_r = large_render_phase(P, march, a5, large, tf,
                                 np.random.default_rng(33))
    clock("4e large-volume render paths")

    # ---- 4f. the scattered render paths -------------------------------------
    scatter_r = scatter_render_phase(P, march, a5,
                                     volumes["mni_dims_182x218x182"], tf,
                                     np.random.default_rng(34))
    clock("4f scattered render paths")

    # ---- 4g. the multichannel and conic lit render paths --------------------
    mc_lit_launches = mc_lit_render_phase(
        P, march, mc_vols, volumes, tf, np.random.default_rng(45),
        {**mc_res, **lit_res})
    clock("4g multichannel and conic lit render paths")

    # ---- 4h. sharded renders: 4 ranks on the card (gloo), 1 through NCCL ---
    shard_launches = shard_render_phase(P, launch, shard_worker, volumes, tf,
                                        np.random.default_rng(52), shard_res)
    clock("4h sharded render path")

    # ---- 5-5k. the CLI: the module entry (5) and the sharded render (5j),
    # which spawns its ranks, in processes of their own, in threads while
    # the other commands run in this process (a process spends most of its
    # time starting up); 5j against the same render from cli.main, which
    # must equal 5's PNG byte for byte ----------------------------------
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        entry = pool.submit(a1_cli_render, tmp)  # 5
        whole = os.path.join(tmp, "sphere_in_process.png")
        run_cli(["render", "--data", "sphere", "--width", str(W), "--height",
                 str(H), "--spr", str(SPR), "--out", whole])
        sharded = pool.submit(shard_cli_phase, tmp, whole)  # 5j
        a5_cli_phase(tmp, tf, from_text)  # 5c, 5d
        lit_cli_phase(tmp)  # 5e
        smooth_cli_phase(tmp, tf, from_text)  # 5f
        lit_fit_cli_phase(tmp, from_text)  # 5g
        scatter_cli_phase(tmp, from_text)  # 5h
        mc_cli_phase(tmp, mc_vols["bench3_91"].data.cpu().numpy(),
                     from_text)  # 5i
        scan_cli_phase(tmp, from_text)  # 5k
        target = entry.result()
        with open(target, "rb") as a, open(whole, "rb") as b:
            check(a.read() == b.read(),
                  "5: the module entry's PNG differs from cli.main's")
        a1_cli_fit(tmp, target, tf, from_text)  # 5b
        sharded.result()
    clock("5-5k CLI")

    # ---- 6. a small input against the reference scan ----------------------
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    sphere = volumes["sphere100"]
    got = P.render(sphere, tf, P.reset_preset(), small)
    ref = P.render(sphere, tf, P.reset_preset(), small, mode="reference")
    e = float((got - ref).abs().max())
    log(f"sphere 100x100x100: kernel vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"kernel vs reference scan: {e}")

    # ---- 6b. a small a5 input against the a5 reference scan ---------------
    small_a5 = small.replace(algorithm=P.Algorithm.TEST)
    got = P.render(sphere, tf, P.reset_preset(), small_a5)
    ref = P.render(sphere, tf, P.reset_preset(), small_a5, mode="reference")
    e = float((got - ref).abs().max())
    log(f"a5 sphere 100x100x100: K3 vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"K3 vs a5 reference scan: {e}")

    # ---- 6c. small lit inputs against the reference scans -----------------
    for name, c in (("a1 lit", small.replace(lighting=True)),
                    ("a1 lit LUT 256", small.replace(lighting=True,
                                                     tf_lut=256)),
                    ("a5 lit", small_a5.replace(lighting=True))):
        got = P.render(sphere, tf, P.reset_preset(), c)
        ref = P.render(sphere, tf, P.reset_preset(), c, mode="reference")
        e = float((got - ref).abs().max())
        log(f"{name} sphere 100x100x100: kernel vs back-to-front reference "
            f"max err {e:.3e} (tol {TOL_EXACT:g})")
        check(e <= TOL_EXACT, f"{name} kernel vs reference scan: {e}")

    # ---- 6d. a small smooth input against the reference scan ---------------
    small_smooth = small.replace(interp=P.Interp.TRILINEAR)
    smooth.launches = 0
    got = P.render(sphere, tf, P.reset_preset(), small_smooth)
    check(smooth.launches == 1, "the small smooth render did not launch K8")
    ref = P.render(sphere, tf, P.reset_preset(), small_smooth,
                   mode="reference")
    e = float((got - ref).abs().max())
    log(f"smooth sphere 100x100x100: K8 vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"K8 vs smooth reference scan: {e}")

    # ---- 6e. small scattered inputs against the plain scan ------------------
    scatter_small = scatter_small_phase(P, sphere, tf)

    # ---- 6f. small 4-D and conic lit inputs against the reference scan -----
    mc_lit_small = mc_lit_small_phase(P, march, sphere, tf)

    clock("6-6f small renders vs the reference scans")

    # ---- 7. the fit path -----------------------------------------------------
    fit_rng = np.random.default_rng(4)
    fit_launches = {"k1": 0, "k4": 0}
    a1_route = FitRoute(("K1", "K4"), march, march_vjp,
                        plain_fwd_a1(march, march_vjp),
                        march_vjp.march_bwd_plain,
                        "march_a1_kernel", "march_bwd_a1_kernel")
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, a1_route, vname, vol, fit_rng,
                      P.RenderConfig(width=W, height=H, samples_per_ray=SPR))
        per_volume[vname]["fit_step_ms"] = r["step_ms"]
        per_volume[vname]["fit_idle_share"] = r["trace"]["idle_share"]
        fit_launches["k1"] += r["k1"]
        fit_launches["k4"] += r["k4"]
    log(f"march kernel launches on the fit path: {fit_launches['k1']}, "
        f"backward kernel launches: {fit_launches['k4']} "
        f"({FIT_STEPS} steps per volume)")
    clock("7 a1 fit path")

    # ---- 7b. the a5 fit path -------------------------------------------------
    a5_route = FitRoute(("K3", "K6"), a5, a5_vjp, a5.march_a5_plain,
                        a5_vjp.march_a5_bwd_plain, "march_a5_kernel",
                        "march_bwd_a5_kernel")
    a5_fit_rng = np.random.default_rng(9)
    a5_fit = {"k3": 0, "k6": 0}
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, a5_route, f"a5 {vname}", vol, a5_fit_rng,
                      P.RenderConfig(width=A5_W, height=A5_H,
                                     samples_per_ray=A5_SPR,
                                     algorithm=P.Algorithm.TEST))
        per_volume[vname]["a5_fit_step_ms"] = r["step_ms"]
        per_volume[vname]["a5_fit_idle_share"] = r["trace"]["idle_share"]
        a5_fit["k3"] += r["k1"]
        a5_fit["k6"] += r["k4"]
    log(f"K3 launches on the a5 fit path: {a5_fit['k3']}, K6 launches: "
        f"{a5_fit['k6']} ({FIT_STEPS} steps per volume)")
    clock("7b a5 fit path")

    # ---- 7c. the smooth bound fit path --------------------------------------
    smooth_route = FitRoute(("K8", "K9"), smooth, smooth_vjp,
                            smooth.march_smooth_plain,
                            smooth_vjp.march_smooth_bwd_plain,
                            "smooth_fwd_kernel", "smooth_bwd_kernel")
    smooth_fit_rng = np.random.default_rng(18)
    smooth_fit = {"k8": 0, "k9": 0}
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, smooth_route, f"smooth {vname}", vol,
                      smooth_fit_rng,
                      P.RenderConfig(width=W, height=H, samples_per_ray=SPR,
                                     interp=P.Interp.TRILINEAR),
                      fit_bounds=True)
        per_volume[vname]["smooth"]["fit_step_ms"] = r["step_ms"]
        per_volume[vname]["smooth"]["fit_trace"] = r["trace"]
        smooth_fit["k8"] += r["k1"]
        smooth_fit["k9"] += r["k4"]
    log(f"K8 launches on the bound fit path: {smooth_fit['k8']}, K9 "
        f"launches: {smooth_fit['k9']} ({FIT_STEPS} steps per volume)")

    clock("7c smooth bound fit path")

    # ---- 7d. the JAX package's bound-recovery case on the card --------------
    recovery = bound_recovery_phase(P, fit, smooth, smooth_vjp)

    # ---- 7e. a volume-gradient step -----------------------------------------
    vgrad = volume_grad_phase(P, smooth, smooth_vjp,
                              volumes["mni_dims_182x218x182"], tf,
                              np.random.default_rng(19))
    per_volume["mni_dims_182x218x182"]["smooth"]["vgrad_step_ms"] = (
        vgrad["ms"])
    clock("7d-7e bound recovery and volume gradient")

    # ---- 7f, 7g. the lit, LUT and light fit paths ----------------------------
    lit_fit_rng = np.random.default_rng(22)
    lit_fit = {v: {"k1": 0, "k4": 0} for v in K4_VARIANT_CONFIGS}
    light_fit = {"k1": 0, "k4": 0}
    routes = [(var, cname, kw, False)
              for var, (cname, kw) in K4_VARIANT_CONFIGS.items()]
    routes.append(("baked", "sobel_lit_700", LIT_CONFIGS["sobel_lit_700"],
                   True))
    for var, cname, kw, is_light in routes:
        for vname, vol in volumes.items():
            kind = "light fit" if is_light else f"{var} fit"
            r = lit_fit_phase(P, fit, march, march_vjp, phong,
                              f"{kind} {vname}/{cname}", var, vol,
                              lit_fit_rng, P.RenderConfig(**kw),
                              light_fit=is_light)
            key = "light_fit" if is_light else f"{var}_fit"
            per_volume[vname][key] = dict(
                config=cname, step_ms=r["step_ms"],
                busy_ms=r["trace"]["busy_ms"] / FIT_STEPS,
                k1_ms=r["trace"]["k1_ms"] / FIT_STEPS,
                k4_ms=r["trace"]["k4_ms"] / FIT_STEPS,
                idle_share=r["trace"]["idle_share"],
                launches_per_step=(r["k1"] / FIT_STEPS, r["k4"] / FIT_STEPS))
            acc = light_fit if is_light else lit_fit[var]
            acc["k1"] += r["k1"]
            acc["k4"] += r["k4"]
    log(f"lit and LUT fit launches by K4 variant: {lit_fit}; light fit "
        f"launches {light_fit} ({FIT_STEPS} steps per volume)")
    clock("7f-7g lit, LUT and light fit paths")

    # ---- 7h. the light gradient: kernels vs plain, central differences ------
    light_grads = {vname: light_grad_phase(P, fit, march, march_vjp, phong,
                                           vname, vol,
                                           np.random.default_rng(23))
                   for vname, vol in volumes.items()}
    clock("7h light gradient")

    # ---- 7i. the JAX package's light-recovery case on the card --------------
    light_recovery = light_recovery_phase(P, fit, march, march_vjp, phong)
    clock("7i light recovery")

    # ---- 7j. colour fits at 320^3 and 512^3 ---------------------------------
    large_f = large_fit_phase(P, fit, march, march_vjp, a5, a5_vjp, phong,
                              large, tf, np.random.default_rng(35))
    clock("7j large-volume fit paths")

    # ---- 7k. the scattered fit ----------------------------------------------
    scatter_f = {vname: scatter_fit_phase(P, fit, march, march_vjp, phong,
                                          vname, vol,
                                          np.random.default_rng(36))
                 for vname, vol in volumes.items()}
    clock("7k scattered fit path")

    # ---- 7l. the alpha-column fit of a 4-D volume ---------------------------
    mc_route = FitRoute(("K1 mc", "K4 mc"), march, march_vjp,
                        plain_fwd_a1(march, march_vjp),
                        march_vjp.march_bwd_plain, "march_a1_kernel",
                        "march_bwd_a1_kernel")
    mc_fit = {"k1": 0, "k4": 0}
    mc_fit_rng = np.random.default_rng(46)
    for vname, vol in mc_vols.items():
        reset_launches(march, march_vjp)
        r = fit_phase(P, fit, mc_route, f"mc {vname}", vol, mc_fit_rng,
                      P.RenderConfig(**MC_SHAPE), alpha_only=True)
        others = [n for m in (march, march_vjp)
                  for n, c in m.variant_launches.items() if c and n != "mc"]
        check(not others, f"mc {vname}: the fit launched {others}")
        mc_res[vname]["fit"] = dict(
            step_ms=r["step_ms"], busy_ms=r["trace"]["busy_ms"] / FIT_STEPS,
            k1_ms=r["trace"]["k1_ms"] / FIT_STEPS,
            k4_ms=r["trace"]["k4_ms"] / FIT_STEPS,
            idle_share=r["trace"]["idle_share"], fd_err=r["fd_err"],
            launches_per_step=(r["k1"] / FIT_STEPS, r["k4"] / FIT_STEPS))
        mc_fit["k1"] += r["k1"]
        mc_fit["k4"] += r["k4"]
    clock("7l multichannel fit path")

    # ---- 7m. sharded fits: 4 ranks on the card (gloo), 1 through NCCL -------
    shard_fit_launches = shard_fit_phase(
        P, fit, phong, launch, shard_worker, volumes, tf,
        np.random.default_rng(55), shard_fit_res)
    clock("7m sharded fit path")

    # ---- 7n. the scan route: fits through the plain scan at full width ------
    scan_res = scan_route_phase(
        P, fit, phong, (march, march_vjp, a5, a5_vjp, smooth, smooth_vjp),
        volumes, mc_vols, tf, np.random.default_rng(60))
    clock("7n scan route")

    # ---- 8a. the a0 point cloud and its depth maps --------------------------
    from volumerenderingproject_tpu_torch.models import point_splat
    from volumerenderingproject_tpu_torch.parallel import dryrun

    all_mods = (march, march_vjp, a5, a5_vjp, smooth, smooth_vjp)
    point_res = point_phase(P, point_splat, all_mods, volumes, tf,
                            np.random.default_rng(70))
    clock("8a point cloud and depth maps")

    # ---- 8b. the CLI's orbit, bench, info, compare and point renders --------
    # (its seeded MNI-dims NIfTI stays for phase 9)
    tmp8 = tempfile.TemporaryDirectory()
    point_cli = point_cli_phase(tmp8.name)
    nii = os.path.join(tmp8.name, "mni_dims.nii")
    clock("8b CLI orbit, bench, info, compare, point")

    # ---- 8c. the default route ---------------------------------------------
    auto_res = auto_route_phase(P, march, all_mods,
                                volumes["mni_dims_182x218x182"], tf,
                                np.random.default_rng(71))
    clock("8c auto route")

    # ---- 8d. the multi-device dry run --------------------------------------
    dryrun_res = dryrun_phase(dryrun)
    clock("8d dryrun_multichip(8)")

    # ---- 9. the render server, camera recovery, the CLI's --window and
    # recover-golden, the last utilities -------------------------------------
    cuda = torch.device("cuda")
    with tmp8:
        p9 = {"9a": server_phase(P, march, a5, nii, cuda)}
        clock("9a render server")
        p9["9b"] = recovery_phase(P, march, a5, tmp8.name, cuda)
        clock("9b camera recovery")
        p9["9c"] = cli_window_phase(tmp8.name, nii, p9["9b"]["goldens"],
                                    cuda)
        clock("9c CLI render --window, recover-golden")
        p9["9d"] = utilities_phase(P, nii, cuda)
        clock("9d pyramid, conv3d, composites, texture vs the CPU")
    p9_k1 = p9["9a"]["plain"] + p9["9b"]["plain"]
    p9_k3 = p9["9a"]["k3"] + p9["9b"]["k3"]

    main_vol = per_volume["mni_dims_182x218x182"]
    kernels = [{
        "name": "march_a1",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march.py:103",
        "launches": launches + fit_launches["k1"] + p9_k1,
        "max_abs_err": max_err,
        "ms": main_vol["ms"],
        "plain_ms": main_vol["plain_ms"],
        "bound_ms": main_vol["bound_ms"],
        "bound_by": main_vol["bound_by"],
        "library_ms": None,
    }, {
        "name": "march_bwd_a1",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march_vjp.py:88",
        "launches": fit_launches["k4"],
        "max_abs_err": bwd_abs,
        "ms": main_vol["bwd_ms"],
        "plain_ms": main_vol["bwd_plain_ms"],
        "bound_ms": main_vol["bwd_bound_ms"],
        "bound_by": main_vol["bwd_bound_by"],
        "library_ms": None,
    }, {
        "name": "march_a5",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/a5.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_a5.py:67",
        "launches": a5_launches + a5_fit["k3"] + p9_k3,
        "max_abs_err": k3_err,
        "ms": main_vol["a5_ms"],
        "plain_ms": main_vol["a5_plain_ms"],
        "bound_ms": main_vol["a5_bound_ms"],
        "bound_by": main_vol["a5_bound_by"],
        "library_ms": None,
    }, {
        "name": "march_bwd_a5",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/a5_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_a5.py:1128",
        "launches": a5_fit["k6"],
        "max_abs_err": k6_abs,
        "ms": main_vol["a5_bwd_ms"],
        "plain_ms": main_vol["a5_bwd_plain_ms"],
        "bound_ms": main_vol["a5_bwd_bound_ms"],
        "bound_by": main_vol["a5_bwd_bound_by"],
        "library_ms": None,
    }]
    # the scattered paths ride the baked variants
    scatter_k1 = sum(r["k1"] for r in scatter_f.values()) + sum(
        r["launches"] for r in scatter_r.values() if not r["a5"])
    scatter_k3 = sum(r["launches"] for r in scatter_r.values() if r["a5"])
    scatter_k4 = sum(r["k4"] for r in scatter_f.values())
    scatter_errs = {"baked": 0.0, "lut_baked": 0.0, "a5_baked": 0.0}
    for r in scatter_k.values():
        scatter_errs[r["variant"]] = max(scatter_errs[r["variant"]],
                                         r["err"])
    for var, cname, src, line in (
            ("lut", "lut_300", "march.cu", "pallas_march.py:103"),
            ("baked", "sobel_lit_700", "march.cu", "pallas_march.py:103"),
            ("lut_baked", "lut_phong_300", "march.cu", "pallas_march.py:103"),
            ("a5_baked", "a5_lit_300", "a5.cu", "pallas_a5.py:67")):
        r = main_vol[cname]
        fit_k1 = scatter_k3 if var == "a5_baked" else (
            lit_fit[var]["k1"] + (light_fit["k1"] + scatter_k1
                                  if var == "baked" else 0))
        kernels.append({
            "name": "march_a5_baked" if var == "a5_baked"
            else f"march_a1_{var}",
            "route": "cuda",
            "source": f"volumerenderingproject_tpu_torch/csrc/{src}",
            "replaces": f"volumerenderingproject_tpu/ops/{line}",
            "launches": lit_launches[var] + fit_k1
            + (p9["9a"]["baked"] if var == "baked" else 0),
            "max_abs_err": max(lit_errs[var], scatter_errs.get(var, 0.0)),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    for var in K4_VARIANT_CONFIGS:
        r = main_vol[f"k4_{var}"]
        kernels.append({
            "name": f"march_bwd_a1_{var}",
            "route": "cuda",
            "source": "volumerenderingproject_tpu_torch/csrc/march_bwd.cu",
            "replaces": "volumerenderingproject_tpu/ops/pallas_march_vjp.py:88",
            "launches": lit_fit[var]["k4"] + (
                light_fit["k4"] + scatter_k4 if var == "baked" else 0),
            "max_abs_err": k4_errs[var][0],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    sm = main_vol["smooth"]
    kernels += [{
        "name": "smooth_fwd",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/smooth.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_smooth.py:305",
        "launches": smooth_launches + smooth_fit["k8"] + vgrad["k8"],
        "max_abs_err": smooth_errs["k8"],
        "ms": sm["ms"],
        "plain_ms": sm["plain_ms"],
        "bound_ms": sm["bound_ms"],
        "bound_by": sm["bound_by"],
        "library_ms": None,
    }, {
        "name": "smooth_bwd",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/smooth_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_smooth.py:349",
        "launches": smooth_fit["k9"] + vgrad["k9"],
        "max_abs_err": max(e[0] for e in smooth_errs["k9"].values()),
        "ms": sm["bwd_ms"],
        "plain_ms": sm["bwd_plain_ms"],
        "bound_ms": sm["bwd_bound_ms"],
        "bound_by": sm["bwd_bound_by"],
        "library_ms": None,
    }]
    # the streamed TPU kernels folded into K1, K3, K4 and K6: the same CUDA
    # kernels on volumes beyond the TPU's resident budget, at 512^3
    big = large_k[f"dense_{LARGE_SIZES[-1]}"]
    for name, src, line, key, fwd, rows in (
            ("march_a1_large", "march.cu", "pallas_march.py:2485", "k1",
             True, ("streamed", "streamed_lit")),
            ("march_a5_large", "a5.cu", "pallas_a5.py:1105", "k3", True,
             ("streamed_a5",)),
            ("march_bwd_a1_large", "march_bwd.cu",
             "pallas_march_vjp.py:624", "k4", False,
             ("streamed", "streamed_lit")),
            ("march_bwd_a5_large", "a5_bwd.cu", "pallas_a5.py:1429", "k6",
             False, ("streamed_a5",))):
        count = sum(r["fwd" if fwd else "bwd"] for lbl, r in large_f.items()
                    if lbl.split("/")[1].split()[0] in rows)
        if fwd:
            count += sum(r["launches"] for lbl, r in large_r.items()
                         if lbl.split("/")[1] in rows)
        errs = [r[key]["err"] for r in large_k.values()] + [
            r[f"{key}_baked"]["err"] for r in large_k.values()
            if f"{key}_baked" in r]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"volumerenderingproject_tpu_torch/csrc/{src}",
            "replaces": f"volumerenderingproject_tpu/ops/{line}",
            "launches": count,
            "max_abs_err": max(errs),
            "ms": big[key]["ms"],
            "plain_ms": big[key]["plain_ms"],
            "bound_ms": big[key]["bound_ms"],
            "bound_by": big[key]["bound_by"],
            "library_ms": None,
        })
    mc_main = mc_res["mni3_182x218x182"]
    kernels.append({
        "name": "march_a1_mc",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march.py:659",
        "launches": mc_lit_launches["mc"] + mc_fit["k1"],
        "max_abs_err": mc_errs["k1"],
        "ms": mc_main["ms"],
        "plain_ms": mc_main["plain_ms"],
        "bound_ms": mc_main["bound_ms"],
        "bound_by": mc_main["bound_by"],
        "library_ms": None,
    })
    lit_main = lit_res["mni_dims_182x218x182"]
    for var in ("lit", "lut_lit"):
        kernels.append({
            "name": f"march_a1_{var}",
            "route": "cuda",
            "source": "volumerenderingproject_tpu_torch/csrc/march.cu",
            "replaces": "volumerenderingproject_tpu/ops/pallas_march.py:503",
            "launches": mc_lit_launches[var],
            "max_abs_err": inkernel_errs[var],
            "ms": lit_main[var]["ms"],
            "plain_ms": lit_main[var]["plain_ms"],
            "bound_ms": lit_main[var]["bound_ms"],
            "bound_by": lit_main[var]["bound_by"],
            "library_ms": None,
        })
    kernels.append({
        "name": "march_bwd_a1_mc",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march_vjp.py:315",
        "launches": mc_fit["k4"],
        "max_abs_err": mc_errs["k4_abs"],
        "ms": mc_main["bwd_ms"],
        "plain_ms": mc_main["bwd_plain_ms"],
        "bound_ms": mc_main["bwd_bound_ms"],
        "bound_by": mc_main["bwd_bound_by"],
        "library_ms": None,
    })
    # the work units of sharded renders: K1's segment and slab modes, K3's
    # segment mode (launches: every rank of 4h, and of 7m's fits; K1
    # baked slabs have an entry of their own)
    fl = shard_fit_launches
    shard_launches["segment"] += fl["k1_segment"] + fl["k1_baked_segment"]
    shard_launches["slab"] += fl["k1_slab"]
    shard_launches["a5_segment"] += fl["k3_segment"]
    for name, key, src, line in (
            ("march_a1_segment", "segment", "march.cu",
             "pallas_march.py:1837"),
            ("march_a1_slab", "slab", "march.cu", "pallas_march.py:1837"),
            ("march_a5_segment", "a5_segment", "a5.cu", "pallas_a5.py:851")):
        r = shard_res[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"volumerenderingproject_tpu_torch/csrc/{src}",
            "replaces": f"volumerenderingproject_tpu/ops/{line}",
            "launches": shard_launches[key],
            "max_abs_err": shard_errs[key],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    # the work units of sharded fits (launches: every rank of 7m)
    for name, key, src, line in (
            ("march_a1_baked_slab", "k1_baked_slab", "march.cu",
             "pallas_march_vjp.py:568"),
            ("march_bwd_a1_segment", "k4_segment", "march_bwd.cu",
             "pallas_march_vjp.py:88"),
            ("march_bwd_a1_segment_baked", "k4_segment_baked",
             "march_bwd.cu", "pallas_march_vjp.py:88"),
            ("march_bwd_a1_slab", "k4_slab", "march_bwd.cu",
             "pallas_march_vjp.py:88"),
            ("march_bwd_a1_slab_baked", "k4_slab_baked", "march_bwd.cu",
             "pallas_march_vjp.py:88"),
            ("march_bwd_a5_segment", "k6_segment", "a5_bwd.cu",
             "pallas_a5.py:1128")):
        r = shard_fit_res[key]
        err = shard_fit_errs[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"volumerenderingproject_tpu_torch/csrc/{src}",
            "replaces": f"volumerenderingproject_tpu/ops/{line}",
            "launches": fl[key],
            "max_abs_err": err if key == "k1_baked_slab" else err[0],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    units = {k: v for k, v in shard_fit_res.items() if k.startswith("k")}
    log(f"sharded fits: units {json.dumps(units)}; errors "
        f"{json.dumps(shard_fit_errs)}; ms/step "
        f"{json.dumps(shard_fit_res['step_ms'])}; step-1 gradients vs "
        f"single-device {json.dumps(shard_fit_res['grad_errs'])}")
    log(f"sharded renders: units {json.dumps(shard_res)}")
    log(f"scan route (7n): {json.dumps(scan_res)}")
    log(f"point cloud (8a): {json.dumps(point_res)}; CLI (8b) "
        f"{json.dumps(point_cli)}; auto route (8c) {json.dumps(auto_res)}; "
        f"dry run (8d) {json.dumps(dryrun_res)}")
    log(f"server, recovery, CLI, utilities (9): {json.dumps(p9)}")
    log(f"multichannel: {json.dumps(mc_res)}; K4 mc max relative err "
        f"{mc_errs['k4_rel']:.3e}; in-kernel lighting: {json.dumps(lit_res)};"
        f" small 4-D and conic lit renders vs the reference scan "
        f"{mc_lit_small:.3e}")
    log(f"large volumes: kernels {json.dumps(large_k)}; render paths "
        f"{json.dumps(large_r)}; fit paths {json.dumps(large_f)}")
    log(f"scattering: kernels {json.dumps(scatter_k)}; transmittance sweep "
        f"{json.dumps(sweep)}; render paths {json.dumps(scatter_r)}; fits "
        f"{json.dumps(scatter_f)}; small renders vs the scan "
        f"{scatter_small:.3e}")
    log(f"K9 max errors (abs, relative to max |dplain|) over all cases: "
        f"{smooth_errs['k9']}; smooth central differences max relative err "
        f"{smooth_errs['fd']:.3e}; bound recovery {recovery}")
    log(f"alpha above 1, kernel vs plain: {f1_errs}; K4 variants (abs, "
        f"relative): {k4_errs}; light gradients {light_grads}; light "
        f"recovery {light_recovery}")
    log(f"per volume: {json.dumps(per_volume)}")
    log(f"backward kernel max relative err over all cases {bwd_rel:.3e}")
    log(f"K6 max relative err over all cases {k6_rel:.3e}")
    clock("report")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
