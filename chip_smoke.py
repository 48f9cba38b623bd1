#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds every native source
   of the port at once, one compiler each: csrc/megakernel.cu,
   csrc/megakernel_bvh.cu, csrc/intersect_packed.cu and csrc/traverse.cu
   with nvcc (printing each kernel's ptxas registers and spills) and the
   host BVH builder csrc/bvh_builder.cpp with g++.
2. Cornell box (brute kernel):
   a. holds megakernel_trace against its plain PyTorch version on the
      card, lane by lane, at 64x64 x 4 spp, depth 6: at least 99.5% of
      lanes within rtol = atol = 2e-3 and the mean within 2e-3 relative
      (the bar of tests/test_megakernel.py: rounding may flip a rare
      russian-roulette or visibility decision);
   b. renders BASELINE config 1 through the public entry point,
      render(cornell_box(256, 256), MegakernelPathIntegrator(6, 5),
      spp=64), with every launch counter set to 0 just before and read
      just after; fails unless megakernel_trace launched.  Checks the
      image (shape, finite, mean within 1e-2 of the plain version's
      image), repeats the lane check on the path's inputs, prints the
      kernel's persistent grid (blocks, resident blocks per SM, threads)
      and the lanes each thread takes on average, and checks the
      schedule on those inputs: the persistent threads take lanes in
      whatever order their paths end, each thread tens of lanes in turn,
      so a second launch, and a launch on a seeded permutation of the
      lanes (un-permuted), must give every lane the same radiance bit
      for bit; with about 10 % of the lanes marked inactive (seeded),
      those must give exactly 0 and the others their radiance of the
      first launch.  Times the kernel (median of 5, CUDA events), the
      plain version and the render (host clock, median of 5).
3. The at-scale scene (BVH kernels): big_scene, the Cornell box plus a
   smooth icosphere, 81,956 triangles; prints the host BVH build time.
   a. holds megakernel_bounce_bvh (six launches, one per depth) and
      megakernel_trace_bvh against their plain versions, lane by lane,
      at 64x64 x 4 spp, depth 6, with the bar of 2a;
   b. renders render(big_scene(256, 256), MegakernelPathIntegrator(6,
      5), seed=7, spp=16) (the default sort_bounces=True) with the
      counters at 0; fails unless megakernel_bounce_bvh launched, at
      most 6 times.  Checks the image as in 2b, and the lane check of the
      path's per-lane radiance against the plain version at full size;
   c. renders again with sort_bounces=False: fails unless
      megakernel_trace_bvh launched, and unless the image mean is within
      1e-5 of 3b's (lanes ride the permutations, so the image is the
      same); repeats the lane check for it.  Prints both kernels'
      persistent grids (blocks, resident blocks per SM, threads, lanes a
      thread) and the tree's depth against the walk's stack cap, and
      checks both schedules at full size: for megakernel_trace_bvh on the
      Morton-ordered lanes the checks of 2b (second launch, permuted
      lanes, 10 % inactive); for megakernel_bounce_bvh on each depth's
      recorded state a second launch on a clone and a launch on a seeded
      permutation of its lanes, which must give that depth's recorded
      state out bit for bit;
   d. times, after warm-up renders: each kernel on the path's inputs
      (CUDA-event median of 5; the bounce kernel once per depth on that
      depth's sorted state, summed over the frame), the plain versions
      once, and both renders (host clock, median of 5, rays/s).
   Each kernel's bound is the larger of its operations (box tests,
   closest and shadow triangle tests that the plain version counts on
   these inputs, over 67 TFLOP/s) and its bytes over 3.35 TB/s: tables
   and inputs read once, output written once; for the bounce kernel,
   at each launch every lane's act flag and, for the live lanes only,
   the lane id and the rest of the state read and the state written.
4. The wavefront PathIntegrator on the Cornell box (intersect_packed):
   a. holds intersect_packed against its plain version, bit for bit
      (t, prim, u and v of every ray), on every call of a 64x64 x 4 spp
      path (primary rays, then each depth's shadow and bounce rays), and
      on the middle rays of that path's primary call under synthetic
      masks: all
      active, about 10 % active, none active (seeded), n = 1, and n one
      below and one above a chunk of slots and a batch of queued rays
      (one a thread; both sizes from the kernel's launch_config), each
      with maxt = inf and with a seeded finite maxt;
   b. renders BASELINE config 1 as written, render(cornell_box(256, 256),
      PathIntegrator(6, 5), seed=7, spp=64), with the counters at 0;
      fails unless intersect_packed launched (at most 12 times) and no
      other kernel did; prints the peak device memory;
   c. holds the path's per-lane radiance against
      MegakernelPathIntegrator's on the same rays (the bar of 2a) and the
      image mean against the megakernel render's (1e-2);
   d. times the render (host clock, median of 5) and, on the path's own
      calls, the kernel (CUDA-event median of 5 a call, summed over the
      frame) and the plain version (once a call, also checked against
      the kernel at full size, bit for bit), and prints the kernel's
      persistent grid (blocks, resident blocks per SM, threads, slots a
      chunk).  The bound is the larger of the tests the plain version
      counts (x 53 operations) over 67 TFLOP/s and
      the bytes over 3.35 TB/s: the face table once a frame (it stays in
      L2 between launches), each ray slot's active flag and 16 bytes
      out, and the other 28 bytes in (o, d, maxt) for an active ray
      only, since an inactive one is settled by its flag.
5. The same on big_scene (render(big_scene(256, 256), PathIntegrator(6,
   5), seed=7, spp=16)) through packet_closest_hit and packet_any_hit,
   held by the bar of 99.99 % of rays (hit, face, t within 1e-5
   relative): each must launch (at most 6 times), every launch by the
   pair route (the two-child walk; the tree is 18 deep), and no other
   kernel; the bound adds node visits x 26 operations (both counts from
   the plain miss-link walk), and the tables the pair walk reads
   (node_pair, leaf_geo, leaf_face) are read once a frame; the outputs
   are 8 (t, face) and 1 (occluded) bytes a ray.  Prints both kernels'
   grid and route (launch_config), each call's ms and active rays, and
   the pair walk's own record visits and tests from its eager twin
   (ops/bvh.py pair_walk), with the rays where kernel and twin differ.
   Checks each kernel's schedule on every call of the path (a second
   launch, and a launch on a seeded permutation of the rays,
   un-permuted, give every ray's outputs bit for bit), then holds both
   kernels against their plain versions by the same bar on the path's
   primary rays under 4a's synthetic masks (all, a tenth, none active;
   n = 1; one ray either side of a warp's chunk of slots and of each
   kernel's grid's total threads, all from launch_config), each with
   maxt = inf and a seeded finite maxt.
6. Fallback through MegakernelPathIntegrator(6, 5), which must launch
   the traversal kernels and no megakernel: big_scene(64, 64) whose
   floor glows too (two area lights), and the Cornell box (64x64) plus
   1,000 triangles in 40 nested clusters, whose BVH is deeper than the
   BVH kernels' walk takes (its image must equal the PathIntegrator's);
   there every hit launch must take the miss-link route (launch_config
   must say so too), and each call of that path is held against the
   plain versions by phase 5's bar.
7. BASELINE config 2 (max_depth 6, rr_depth 5, seed 7): the lobe builds
   of the path kernels, named with their BSDF codes (e.g.
   megakernel_trace[lobes 0,1,2]).
   a. The config-2 Cornell box: the small box a Cu SmoothConductor, the
      large box a SmoothDielectric (eta 1.5), then their GGX rough twins
      (alpha 0.2); each through phase 2's checks and times at 256x256 x
      64 spp (megakernel_trace), then the wavefront PathIntegrator
      (intersect_packed alone; its lanes held against the megakernel's,
      its image within the reference's 2e-2) and the DirectIntegrator
      (held per lane against the CPU's plain queries at 32x32 x 4, then
      at full size through intersect_packed alone); prints the three
      render times.
   b. big_scene with the ball a RoughDielectric (alpha 0.2, eta 1.5)
      and the small box a SmoothConductor (81,956 triangles): phase 3's
      checks, schedule checks and times at 256x256 x 16 spp for both
      BVH kernels, then the wavefront render (packet_closest_hit /
      packet_any_hit) held as in a.
8. Plastic, two-sided and bitmap-textured surfaces (max_depth 6,
   rr_depth 5, seed 7; utils/scenes.py): the surface builds of the path
   kernels, named with their BSDF codes as in 7, through
   MegakernelPathIntegrator(strict=True), which raises rather than fall
   back.
   a. The plastic, two-sided and textured Cornell boxes (the textured
      one's two bitmaps made from the seed), each through phase 2's
      checks and times at 256x256 x 64 spp (megakernel_trace), then the
      wavefront PathIntegrator (intersect_packed alone; lanes and image
      held against the megakernel's as in 7a).
   b. surfaces_big_scene (a RoughPlastic ball, a TwoSided Cu small box;
      81,956 triangles) through phase 3's checks and times at 256x256 x
      16 spp for both BVH kernels, then the wavefront render as in 7b.
   c. Its textured twin (the ball under a 512x512 bitmap): the same for
      megakernel_bounce_bvh alone, which sort_bounces=False must take
      too (megakernel_trace_bvh takes no texture).
   d. The build split: the config-2 scenes' megakernel_trace and
      megakernel_trace_bvh through their lobe build and through the
      surface build, in turns, timed; every lane bit for bit equal.
   build_all prints the ptxas registers and spills of the three builds
   of each path kernel (and of the environment-map builds of phase 9).
9. Environment-map lighting (max_depth 6, rr_depth 5, seed 7;
   utils/scenes.py, under sky_envmap, a 2048 x 1024 sky with a sun made
   from the seed): the environment builds of megakernel_trace and
   megakernel_bounce_bvh (named like megakernel_trace[lobes 0,3 env]),
   through MegakernelPathIntegrator(strict=True).
   a. envmap_scene (a diffuse floor and ball, the envmap alone, no light
      faces) and its twin with the area light before the envmap and a
      rough Cu ball, each through phase 2's checks and times at 256x256 x
      64 spp (megakernel_trace; the plain version's time includes its
      per-depth NEE draws, env_nee_sample, also timed alone at full size),
      then the wavefront PathIntegrator (lanes and image against the
      megakernel's as in 7a) and the DirectIntegrator as in 7a.
   b. envmap_big_scene (the ball 81,920 triangles, the area light and the
      envmap) through megakernel_bounce_bvh alone, sorted and unsorted
      (both must launch it and never megakernel_trace_bvh), with phase 3's
      checks, schedule checks and times at 256x256 x 16 spp, then the
      wavefront render as in 7b.
10. Differentiable rendering, BASELINE config 3 (max_depth 6, rr_depth
   5, seed 7), through prb_render (path-replay backpropagation), the
   scene parameters (utils/params.py) and Adam (utils/optimizers.py):
   a. the loop on textured_cornell(256, 256): the back wall's 512 x 512 x 3
      texels and the red wall's albedo, moved off their values from the
      seed, recovered against the image at the true values (same seed and
      spp, 16 / 16) by 8 steps of Adam(lr=0.05), each clamped to [0, 1].
      Prints each step's loss, ms, launches and peak memory, and the
      median step split into the primal walk, the L0 replay and the
      adjoint walk (each timed between synchronisations), the optimizer
      and the rest; fails unless every gradient is finite, the last loss
      is below half the first and intersect_packed alone launched;
   b. records every intersect_packed call of one step (primal, replay,
      adjoint walk; closest and shadow rays) and holds each against the
      plain version on the card, bit for bit, with phase 4's times and
      bound; prints the step's device-busy share (torch.profiler);
   c. holds the card's gradients of both parameters against the plain
      route on the CPU at 32x32 x 4 spp: relative norm within 1e-3 each;
   d. holds the red albedo's gradient of mean(image) at full width
      against central differences on the card (eps 5e-3, rr_depth 16):
      within 5 %;
   e. one step on big_scene (81,956 triangles, 256x256 x 16) with respect
      to the white albedo (Adam) and then, with the ball's vertices too
      (computed, not stepped), records every packet_closest_hit and
      packet_any_hit call of a step and holds each against its plain
      version by phase 5's bar; every launch by the pair route.
   The kernels line gains intersect_packed[prb], packet_closest_hit[prb]
   and packet_any_hit[prb]: ms summed over a step's launches.
11. The refit and lens design, BASELINE config 5 (the examples' full
   sizes, seed 0):
   a. big_scene (81,956 triangles) with its ball moved by -0.5 in x
      through params.update, no rebuild: a 256x256 x 4 frame's camera
      rays and their shadow rays toward the light through #5 and #6 over
      the tree refitted at the render, each call held against the plain
      walk over that tree by phase 5's bar; the hits against a rebuilt
      tree's (ties aside, counted; none may differ otherwise), the
      shadow rays likewise; the stale tree's other hits counted;
      refit_bvh timed (CUDA events) against a PathIntegrator render of
      the moved scene;
   b. the doublet achromat (examples/doublet_achromat_design.py: 24x24,
      2048 light paths a pixel, spectral, 8 rings x 16 sectors, 850
      faces): 5 Adam steps of the front glass's V_d alone at lr 0.6
      through intersect_packed alone, with every counter set to 0 just
      before; each step's loss, ms and the peak memory; fails on a
      non-finite step or unless V_d moves toward the achromat's; then one
      step's intersect_packed calls recorded and held against the plain
      version bit for bit, and the step's device-busy share;
   c. the triplet EFL design (examples/triplet_efl_design.py: 32x32, 128
      light paths a pixel, three sources to 7.5 degrees, 1,730 faces, a
      BVH refitted at every render): 3 Adam steps with fixed_efl=50
      through packet_closest_hit and packet_any_hit alone, on the pair
      route; fails on a non-finite step or unless the EFL stays at 50
      within 1e-3; then one loss's calls held against the plain walks by
      phase 5's bar;
   d. one doublet design gradient (8x8, 16 light paths a pixel) on the
      card and on the CPU route through the card's sensor poses: the
      loss within 1e-4, each parameter's gradient within 1e-3, relative.
   The kernels line gains intersect_packed[lens], packet_closest_hit[lens]
   and packet_any_hit[lens]: ms summed over a step's launches.
12. The realistic-lens camera (seed 7; make_lens_camera on the Cornell
   box's pose, a 35 mm film diagonal, focused at 3.9):
   a. builds the double Gauss (11 interfaces, a stop) with its exit-pupil
      table at 64 segments x 65,536 QMC rays, prints the build's and the
      table's times, and holds the card's table against the CPU route's:
      every box within the rays' spacing; the card's and the CPU's
      autofocused interfaces equal bit for bit (autofocus runs on the
      host);
   b. BASELINE config 1 through it: phase 2 on render(cornell_box(256,
      256) through the double Gauss, MegakernelPathIntegrator(6, 5),
      spp=64) (megakernel_trace must launch; the lane checks on the
      path's own lens rays, the image, the schedule checks, the times),
      the image finite and upright (the ceiling's rows brighter than the
      floor's); sample_rays timed through the lens and through the
      pinhole; then the same through the singlet sampling its rear
      element (cos^4 weight);
   c. phase 3 on big_scene(256, 256) through the double Gauss, 16 spp:
      megakernel_bounce_bvh sorted, megakernel_trace_bvh with
      sort_bounces=False, the image means within 1e-5;
   d. the spectral doublet on an emitting panel through the wavefront
      PathIntegrator(max_depth=2) at 256x256 x 64 spp: intersect_packed
      alone launches, every call of the frame held against the plain
      version bit for bit; the spectral image's |R - B| above 5 x the
      RGB doublet's (chromatic fringing);
   e. one prb_render step through the spectral singlet on a smoothly
      emitting panel at 256x256 x 16 spp: d mean(img^2) / d(Cauchy B
      of every glass) finite, its intersect_packed calls held bit for bit,
      the gradient against central differences (eps 2e-4, 15 %), and at
      32x32 x 4 the card's gradients against the CPU route's (1e-3).
   The kernels line gains megakernel_trace[camera],
   megakernel_bounce_bvh[camera], megakernel_trace_bvh[camera] (b, c)
   and intersect_packed[camera] (d).
13. Camera-pose, silhouette and shadow gradients (BASELINE config 4; seed
   7; PathProjectiveIntegrator(6, 5, sppp=4096, n_sub=4, guiding="grid")
   through prb_projective_render, as the JAX package's defaults run it:
   indirect=True, sppi 16384, indirect_depth 1, so the shadow-boundary
   term is on and, under "grid", uniform):
   a. the pose loop on cornell_box(256, 256): the pose translate(t) @ the
      true pose, t from (0.06, -0.04, 0), the target the true pose at 64
      spp, 8 Adam(lr=0.01) steps of the L2 loss at 16 spp; the loss and
      |t| must fall; each step's ms split into the primal, L0 replay,
      adjoint walk, boundary warm-up and main passes, S's backward, the
      shadow term's warm-up and main passes and its S backward, and Adam,
      its launches and peak memory; the shadow term alone on the step's
      adjoint (its launches and ms); the first step's pose gradient
      within 25 % (relative norm) of central differences (h 0.01) of the
      same estimator, PRB's alone printed beside it; at 32x32 x 4 the
      card's pose gradient against the CPU route's (1e-3); one step's
      intersect_packed calls (the shadow term's among them) held bit for
      bit, its device-busy share;
   b. big_scene(256, 256) with the ball's vertices through LargeSteps:
      the round trip within 1e-3 (with its CG iterations and ms), 3 Adam
      steps on u from the ball moved by 0.05 in x, finite, timed as in a
      plus the CG solves; one step's packet_closest_hit and
      packet_any_hit calls held against the plain walks by phase 5's
      bar, every launch by the pair route; then ROADMAP.md Queue 3 item
      5, whether the card's gradients repeat: the step's gradient computed
      twice from the same state and compared bit for bit, then each piece
      twice (the image, the vertex gradient, PRB's adjoint, the primary
      and shadow terms on a fixed adjoint image, LargeSteps' CG solve, its
      backward and the Laplacian product); prints each verdict and fails
      unless the step's gradient, the vertex gradient, the image, the CG
      solve, its backward, the product and PRB's adjoint (its gathers add
      in a fixed order, ops/gather.py; the guiding grid's and the splat's
      scatter-adds are a fixed-point sum) repeat;
   c. tests/test_projective.py's acceptance case on the card: the
      emissive quad at 32x32 x 64 spp, sppp 8192, n_sub 2, depth 2, its
      x-translation gradient within 0.25 |fd| + 0.05 of central
      differences (h 0.04), PRB's alone under 0.25 |fd|;
   d. the shadow term's own checks, on tests/test_projective.py's scenes
      (utils/scenes.py shadow_scene and probe_panel): the blocker's
      x-translation gradient on shadow_scene(256, 256) (spp 32, depth 2,
      sppp 4096, n_sub 2) under an x ramp, with the shadow term uniform
      ("grid"), octree-guided and projection-seeded (each one's value
      and backward ms printed), within 0.3 |fd| + 0.05 (uniform) and
      0.35 |fd| + 0.05 (the guides; the JAX package's bars) of central
      differences (h 0.03), without the term under 0.3 |fd|; on the
      probe panel (24x24, 65,536 shadow samples a seed) the depth-2
      gradient within 12 % of a common-random-number difference (4 seeds
      x 512 spp, h 0.05) and depth 1 under 5 %, and through the mirror
      depth 3 within 15 % and depth 2 under 5 %; at 32x32 the card's
      shadow-term blocker gradient (16,384 samples) against the CPU
      route's, 1e-3 relative.  Prints the phase's seconds.
   The kernels line gains intersect_packed[projective] (a),
   packet_closest_hit[projective] and packet_any_hit[projective] (b).
14. Exact analytic spheres, disks and cylinders (seed 7; utils/scenes.py
   analytic_cornell: the Cornell box plus an exact ball, a conductor
   cylinder and a disk; ANALYTIC_RUN holds the sizes):
   a. render(analytic_cornell(256, 256), PathIntegrator(6, 5), spp=64)
      with the counters at 0: intersect_packed alone must launch; every
      call of the render held against its plain version bit for bit
      (the kernel row's times and bound); per lane at 64x64 x 4 against
      the plain route on the card (the bar of 2a);
      MegakernelPathIntegrator logs its fallback, naming the analytic
      prims, and gives the PathIntegrator's image bit for bit; the exact
      ball alone in the Cornell box against big_scene's tessellated ball
      at 16 spp, image means within 1e-2; the render's time (median of
      3) and, over the frame's primary rays, the analytic sweep,
      intersect_packed and compute_si (CUDA events);
   b. analytic_cornell(256, 256, sphere_light=True) (the ceiling quad
      replaced by an analytic sphere lamp, cone-sampled NEE) through the
      DirectIntegrator and the PathIntegrator at 64 spp, each with a's
      launch and lane checks; then big_scene under the same lamp at
      256x256 x 16 through the PathIntegrator: packet_closest_hit and
      packet_any_hit alone launch, on the pair route, every call held
      against the plain walks by phase 5's bar, the lanes as in a;
   c. BASELINE config 4 on the analytic ball: PathProjectiveIntegrator(6,
      5, sppp=4096, n_sub=4, guiding="grid") with the shadow term on and
      the mesh ceiling light, 6 Adam(0.01) steps on the ball's centre
      from a shift of (0.05, 0, 0) against the true image at 64 spp, 16
      spp a step, split as in 13a with an "analytic boundary pass" row;
      the loss must fall; step 0's centre-x and radius gradients within
      25 % of central differences (h 0.01, common random numbers), each
      printed with and without analytic_boundary_grads' share; at 32x32
      x 4 (sppp 512, one path a side, sppi 1024) the card's gradients
      against the CPU route's (1e-3); the step's device-busy share.
      Prints each part's and the phase's seconds.
   The kernels line gains intersect_packed[analytic] (a),
   packet_closest_hit[analytic] and packet_any_hit[analytic] (b).
15. Curves, SDF grids and two-level instancing (seed 7, PathIntegrator(6,
   5); SHAPES_RUN holds the sizes), each scene the Cornell box plus the
   new shapes (utils/scenes.py):
   a. curves_cornell(256, 256) at 64 spp, the JAX tests' curve as a
      linear curve (3 segments) and as a cubic B-spline (8 sub-segments a
      parent segment): intersect_packed alone launches, every call of a
      render held against its plain version bit for bit (the row's times
      and bound), the render's ms and peak memory, the image mean within
      1e-2 of the tessellated twin's (a 48-sided tube, the B-spline's
      centre line at 32 samples a segment, icosphere end caps);
   b. sdf_cornell(256, 256) at 64 spp (a 32^3 sphere grid where
      analytic_cornell's ball stands): a's checks, the image mean within
      1e-2 of the exact ball's, the sphere trace's ms (CUDA events) and
      device kernels over the primary rays;
   c. instanced_cornell(256, 256, 16, 16, 4) at 16 spp: 256 instances of
      a 5,120-face icosphere (1,310,720 instanced triangles), the group's
      tree walked in object space by packet_closest_hit / packet_any_hit
      on the pair route, intersect_packed for the box; every group query
      held against the plain walks by phase 5's bar and bit for bit (a
      call that differs, against the pair walk's eager twin, which parts
      from the plain walk on ties only); the candidate rounds of each query;
      the group's device bytes against the flattened twin's meshes; then
      the 4 x 4 grid against its flattened twin (instance_meshes): image
      means within 1e-2, the primary rays' hits equal on >= 99.9 %;
   d. prb_render gradients at 128x128 x 4 spp with respect to one
      instance's translation, the SDF's values and the cubic curve's
      control points (the leaf cv_cp, which holds each parent segment's
      points once a prim): twice on the card, bit for bit, and against
      the CPU route within 1e-3 relative (the CPU route runs in a process
      of its own, the card hidden, started before phase 1); the sums of
      cv_cp's copies of each of the curve's own points are printed.
      Prints each part's and the phase's seconds.
   The kernels line gains intersect_packed[linear curve], [cubic curve],
   [sdf] and [instanced], packet_closest_hit[instanced] and
   packet_any_hit[instanced].
16. Scene files and the command line (seed 7; LOADED_RUN holds the sizes):
   a. load_dict(cornell_box_dict(256, 256, 64)) rendered by render(scene)
      with the scene's own path integrator (depth 8), the counters at 0:
      intersect_packed alone launches, every call bit for bit against its
      plain version; the image within 1e-5 (max abs) of
      render(cornell_box(256, 256), PathIntegrator(8, 5), spp=64); then
      MegakernelPathIntegrator(8, 5) on the loaded box through phase 2's
      checks (megakernel_trace launches, image within 1e-2 of the plain
      version's);
   b. a Cornell-box XML of version 0.6.0 (camelCase names, $spp and $res
      defaults, <lookAt>, <ref>, a PLY back wall) rendered by `python -m
      mitsuba_tpu_torch box.xml -o box.exr -D spp=64 -D res=256` in a
      subprocess, which must exit 0; its EXR read back by the port's
      read_image bit for bit against render(load_file(...)) here; the
      CLI's load and render seconds;
   c. big_scene()'s meshes (81,956 triangles) written as a binary PLY (the
      ball) and OBJ files with an XML naming them, loaded by load_file:
      the parse and BVH-build seconds; MegakernelPathIntegrator(6, 5) at
      16 spp launches megakernel_bounce_bvh (lanes against the plain
      version) and renders within 1e-5 of big_scene's image; the scene's
      own path render launches packet_closest_hit and packet_any_hit,
      each call held against the plain walk by phase 5's bar;
   d. four variants of the Cornell box (utils/scenes.py
      delta_lights_dict): (i) a point and a spot light beside the area
      light, (ii) a projector of a PNG written here, (iii) a constant sky,
      (iv) a directional sun, each through PathIntegrator(6, 5) and the
      DirectIntegrator at 256x256 x 64 (intersect_packed alone, every call
      bit for bit); MegakernelPathIntegrator on (i) logs its fallback and
      gives the wavefront's image bit for bit; the particle tracer from
      (i)'s lights at 256x256 x 16; every render at 32x32 x 4 within 1e-5
      of the CPU route's, relative to the largest pixel (its process,
      started before phase 1, renders them too; the particle tracer's
      splat adds in another order on each device).
   The kernels line gains intersect_packed[loaded], megakernel_trace
   [loaded], megakernel_bounce_bvh[loaded], packet_closest_hit[loaded],
   packet_any_hit[loaded] and intersect_packed[delta lights].
17. Prints one JSON line of the kernels (the rows of packet_closest_hit
   and packet_any_hit also name their walk, "walk_route"), the card's
   name and power limit again, and last {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line.  It also fails without a GPU, and when run from a directory
that does not hold the mitsuba_tpu_torch package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 7
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores (an FMA counts
# as two operations) and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# float adds, subtracts, multiplies, divides and compares of one
# Moller-Trumbore test (csrc/path_common.cuh tri_test) and of one slab
# test of a node box (csrc/megakernel_bvh.cu: 6 subtractions, 6
# multiplies, 6 per-axis min/max, 3 + 3 reductions and tmax, 1 compare);
# the shading around the tests is left out, so the bounds are lower bounds
OPS_PER_TRI_TEST = 53
OPS_PER_NODE_VISIT = 26
STATE_BYTES = 16 * 4
# what an active ray brings to a hit query besides its active flag (1
# byte, read for every ray): o and d (24 bytes) and maxt (4)
RAY_IN_BYTES = 28
SOURCES = ("megakernel", "megakernel_bvh", "bvh_builder", "intersect_packed",
           "traverse")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_lanes(name, got, ref):
    """The per-lane bar of tests/test_megakernel.py; returns max |got-ref|."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite lanes")
    close = torch.isclose(got, ref, rtol=2e-3, atol=2e-3).all(dim=-1)
    frac = float(close.float().mean())
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / float(ref.mean())
    err = float((got - ref).abs().max())
    print(f"{name}: {frac:.5f} of {got.shape[0]} lanes within 2e-3, "
          f"mean rel err {mean_rel:.3e}, max abs err {err:.3e}")
    if frac < 0.995 or mean_rel >= 2e-3:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_image(name, image, plain_image, width, height):
    import torch

    if tuple(image.shape) != (height, width, 3) \
            or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"{name}: bad image {tuple(image.shape)}")
    rel = abs(float(image.mean()) - float(plain_image.mean())) \
        / float(plain_image.mean())
    print(f"{name} image {width}x{height}: mean {float(image.mean()):.6f}, "
          f"plain {float(plain_image.mean()):.6f}, rel diff {rel:.3e}")
    if rel > 1e-2:
        raise AssertionError(f"{name}: the image mean disagrees with the "
                             "plain version")


def bound(ops, nbytes):
    """(bound ms, what bounds it) of work of ``ops`` float operations and
    ``nbytes`` bytes on the card."""
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def build_all():
    """Every native source at once, one compiler process each."""
    from mitsuba_tpu_torch.ops import _build

    # g++ prints nothing on success, so an empty log does not mean cached
    cached = {s for s in SOURCES if _build.library_path(s).exists()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(str(_build.library_path(s).name) for s in SOURCES)}")
    for name, log in logs.items():
        if name in cached:
            print(f"  {name}: cached, not built, no ptxas report")
        for line in log.splitlines():
            line = line.strip()
            if "Compiling entry function" in line:
                entry = line.split()[-3].strip(chr(39))
                # the builds of a path kernel: template <int LOBES, bool
                # ENV> (the single-launch BVH kernel: <int LOBES>)
                build = {"ILi0E": " [diffuse-only build]",
                         "ILi1E": " [lobe build]",
                         "ILi2E": " [surface build]",
                         "Lb1E": " [environment map]"}
                print(f"  {name}: {entry[:90]}" + "".join(
                    v for k, v in build.items() if k in entry))
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line}")


def cornell_phase(integ, make=None, label="cornell", plain_reps=3):
    """Phase 2 (and 7a, 8a, 9a): the brute kernel on ``make(width,
    height)``, the Cornell box by default; returns its row, the main
    path's image and the render's ms.  The plain version's time is the
    median of ``plain_reps`` runs."""
    import torch

    from mitsuba_tpu_torch import cornell_box, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.megakernel import (LIGHT_COLS, TRI_COLS,
                                                  env_nee_sample, env_view,
                                                  launch_config,
                                                  megakernel_trace,
                                                  megakernel_trace_plain,
                                                  pack_scene, scene_btypes)
    from mitsuba_tpu_torch.utils.profile_path import events_ms, wall_ms

    make = make or cornell_box

    def trace_inputs(scene, spp):
        ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
        tris, light, n_faces, n_lights, tex, env = pack_scene(scene)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        args = (tris, light, lane, ray.o, ray.d, active, SEED)
        kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                  n_faces=n_faces, n_lights=n_lights,
                  btypes=scene_btypes(scene), tex=tex, **env,
                  smooth=any(m.normals is not None for m in scene.meshes))
        return args, kw, weight, film_pos

    # ---- 2a. the kernel against its plain version, lane by lane
    args, kw, _, _ = trace_inputs(make(64, 64), 4)
    env = "env_data" in kw
    name = variant_name("megakernel_trace", kw["btypes"], env)
    got = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    check_lanes(f"{name} {label} 64x64x4", got,
                megakernel_trace_plain(*args, **kw))

    # ---- 2b. the main path, through the public entry point
    width = height = 256
    spp = 64
    scene = make(width, height)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = require_launches(f"{label} megakernel render",
                                {"megakernel_trace": 1})["megakernel_trace"]

    args, kw, weight, film_pos = trace_inputs(scene, spp)
    n = int(args[2].shape[0])
    counts = {}
    plain_L = megakernel_trace_plain(*args, **kw, counts=counts)
    film = scene.sensor.film
    check_image(label, image, film.develop(film.put_grouped(
        film_pos, plain_L * weight, spp, args[5])), width, height)

    kernel_L = megakernel_trace(*args, **kw)
    torch.cuda.synchronize()
    err_full = check_lanes(f"{name} {label} {width}x{height}x{spp}",
                           kernel_L, plain_L)

    grid = launch_config(kw["n_faces"], kw["n_lights"], n, kw["btypes"], env)
    print(f"{name} grid at {n} lanes: {grid}, "
          f"{n / (grid['blocks'] * grid['threads']):.1f} lanes a thread")
    tris, light, lane, o, d, active, seed = args
    check_schedule(name,
                   lambda *lanes: megakernel_trace(tris, light, *lanes, seed,
                                                   **kw),
                   lane, o, d, active, kernel_L)
    kernel_ms = events_ms(lambda: megakernel_trace(*args, **kw), 5)
    plain_ms = events_ms(lambda: megakernel_trace_plain(*args, **kw),
                         plain_reps)
    if env:
        # the plain version's NEE draws of the environment map alone: the
        # eager counterpart of the JAX package's per-(lane, depth) table
        ev = env_view(kw["env_data"], kw["env_meta"], kw["env_pos"])
        table_ms = events_ms(lambda: [
            env_nee_sample(ev, SEED, args[2], depth)
            for depth in range(integ.max_depth)], 3)
        print(f"{name} {label}: env_nee_sample over {integ.max_depth} "
              f"depths of {n} lanes (the plain NEE table): {table_ms:.3f} ms")
    render_ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 5)
    ops = (counts["closest_tests"] + counts["shadow_tests"]) * OPS_PER_TRI_TEST
    # a textured hit also reads its texels, an escape or an environment
    # NEE sample the map's texels and CDF entries (tex_floats and
    # env_floats, counted by the plain version)
    nbytes = n * (4 + 12 + 12 + 1 + 12) + 4 * (kw["n_faces"] * TRI_COLS
                                                + kw["n_lights"] * LIGHT_COLS
                                                + counts.get("tex_floats", 0)
                                                + counts.get("env_floats", 0))
    bound_ms, bound_by, t_ops, t_bytes = bound(ops, nbytes)
    print(f"{name} {label}: {kernel_ms:.4f} ms "
          f"({n / kernel_ms * 1e3:.4e} rays/s), plain {plain_ms:.2f} ms; "
          "closest tests "
          f"{counts['closest_tests']}, shadow tests {counts['shadow_tests']}, "
          f"texel floats {counts.get('tex_floats', 0)}, env floats "
          f"{counts.get('env_floats', 0)}, "
          f"{ops:.4e} ops -> {t_ops:.4f} ms, {nbytes} bytes -> "
          f"{t_bytes:.4f} ms; first render {render_s * 1e3:.2f} ms, render "
          f"{render_ms:.3f} ms ({n / render_ms * 1e3:.4e} rays/s, median "
          "of 5)")
    return {
        "name": name,
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/megakernel.cu",
        "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:1805",
        "launches": launches,
        "max_abs_err": err_full,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, image, render_ms


def variant_name(kernel, btypes, env=False):
    """A kernel's name in the kernels line: the diffuse-only build under
    its own name, the lobe and surface builds with the BSDF codes they
    ran, and an environment map's build with "env" after them."""
    if tuple(btypes) == (0,) and not env:
        return kernel
    return (f"{kernel}[lobes {','.join(str(b) for b in btypes)}"
            + (" env]" if env else "]"))


def check_schedule(name, trace, lane, o, d, active, first):
    """The schedule checks of a persistent whole-path kernel on the lanes
    whose first launch gave ``first``; ``trace(lane, o, d, active)``
    launches it.  A second launch, a launch on a seeded permutation of
    the lanes and a launch with about 10 % of the lanes inactive agree
    with the first bit for bit (inactive lanes give exactly 0)."""
    import torch

    n = int(lane.shape[0])
    g = torch.Generator(device=lane.device).manual_seed(SEED)
    perm = torch.randperm(n, generator=g, device=lane.device)
    again = trace(lane, o, d, active)
    permuted = trace(lane[perm], o[perm], d[perm], active[perm])
    unpermuted = torch.empty_like(permuted)
    unpermuted[perm] = permuted
    some = active & (torch.rand(n, generator=g, device=lane.device) >= 0.1)
    masked = trace(lane, o, d, some)
    torch.cuda.synchronize()
    checks = {
        "second launch": torch.equal(again, first),
        "permuted lanes": torch.equal(unpermuted, first),
        "inactive lanes give 0": bool((masked[~some] == 0).all()),
        "active lanes unchanged": torch.equal(masked[some], first[some]),
    }
    print(f"{name} schedule, {n} lanes, {int((~some).sum())} inactive: "
          f"{checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: a lane's radiance depends on the "
                             "schedule")


def check_bounce_schedule(name, bounce, recorded):
    """The schedule checks of the persistent bounce kernel on each depth's
    recorded state (lane ids, state in, state out, depth): a second launch
    on a clone of the state and a launch on a seeded permutation of its
    lanes (un-permuted) give the recorded state out bit for bit."""
    import torch

    for rlane, s_in, s_out, depth in recorded:
        n = int(rlane.shape[0])
        g = torch.Generator(device=rlane.device).manual_seed(SEED + depth)
        perm = torch.randperm(n, generator=g, device=rlane.device)
        again = bounce(rlane, s_in.clone(), depth)
        permuted = bounce(rlane[perm], s_in[:, perm].contiguous(), depth)
        unpermuted = torch.empty_like(permuted)
        unpermuted[:, perm] = permuted
        torch.cuda.synchronize()
        checks = {"second launch": same_bits(again, s_out),
                  "permuted lanes": same_bits(unpermuted, s_out)}
        print(f"{name} schedule, depth {depth}, "
              f"{int((s_in[15] > 0.5).sum())} live of {n} lanes: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"{name}: a lane's state depends on the "
                                 "schedule")


def kernel_wrappers():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from mitsuba_tpu_torch.ops.intersect_packed import intersect_packed
    from mitsuba_tpu_torch.ops.megakernel import megakernel_trace
    from mitsuba_tpu_torch.ops.megakernel_bvh import (megakernel_bounce_bvh,
                                                      megakernel_trace_bvh)
    from mitsuba_tpu_torch.ops.traverse import (packet_any_hit,
                                                packet_closest_hit)

    return {fn.__name__: fn for fn in (
        megakernel_trace, megakernel_bounce_bvh, megakernel_trace_bvh,
        intersect_packed, packet_closest_hit, packet_any_hit)}


def reset_counters():
    from mitsuba_tpu_torch.models.instancing import reset_round_counts

    reset_round_counts()
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def require_route(label, route):
    """Fails unless every launch of the hit queries since the reset took
    the walk ``route`` ("pair" or "miss_link")."""
    from mitsuba_tpu_torch.ops import traverse as tv

    for fn in (tv.packet_closest_hit, tv.packet_any_hit):
        print(f"{label}: {fn.__name__} launches by route {fn.routes}")
        if fn.routes[route] != fn.launches:
            raise AssertionError(f"{label}: {fn.__name__} launched off the "
                                 f"{route} route")


def require_launches(label, allowed):
    """The launch counts since the reset; fails unless each kernel named in
    ``allowed`` (name -> most launches) launched 1..most times and no
    other kernel launched."""
    got = {name: fn.launches for name, fn in kernel_wrappers().items()}
    print(f"{label}: launches {got}")
    for name, n in got.items():
        if not (1 <= n <= allowed[name] if name in allowed else n == 0):
            raise AssertionError(f"{label}: {name} launched {n} times")
    return got


def bvh_phase(integ, make=None, label="big_scene", single_launch=True):
    """Phase 3 (and 7b, 8b, 8c, 9b): the BVH kernels on ``make(width,
    height)``, the 81,956-triangle scene by default; returns their rows,
    the sorted render's image and the renders' ms.  Without
    ``single_launch`` (a textured scene or an environment map, which
    megakernel_trace_bvh does not take) only the per-depth pipeline runs:
    megakernel_bounce_bvh's checks and row, and sort_bounces=False must
    launch it too."""
    import torch

    import mitsuba_tpu_torch.models.integrators.megapath as megapath
    from mitsuba_tpu_torch import big_scene, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.bvh import build_bvh
    from mitsuba_tpu_torch.ops.megakernel import scene_btypes
    from mitsuba_tpu_torch.ops.megakernel_bvh import (
        launch_config, megakernel_bounce_bvh, megakernel_bounce_bvh_plain,
        megakernel_trace_bvh, megakernel_trace_bvh_plain, pack_scene_bvh,
        primary_state)
    from mitsuba_tpu_torch.utils.profile_path import (events_ms,
                                                      record_bounces, wall_ms)

    make = make or big_scene

    def inputs(scene, spp):
        ray, weight, film_pos, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        return ray, weight, film_pos, lane, active

    width = height = 256
    spp = 16
    t0 = time.perf_counter()
    scene = make(width, height)
    btypes = scene_btypes(scene)
    env = scene.env_index >= 0
    depth_kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                    smooth=True, btypes=btypes)
    names = {k: variant_name(f"megakernel_{k}_bvh", btypes, env)
             for k in ("bounce", "trace")}
    print(f"{label}({width}, {height}): {time.perf_counter() - t0:.3f} s, "
          f"{sum(int(m.faces.shape[0]) for m in scene.meshes)} triangles, "
          f"{scene.accel.n_nodes} BVH nodes, BSDF codes {btypes}")
    if make is big_scene:
        v, f = scene.geometry()[:2]
        v, f = v.cpu().numpy(), f.cpu().numpy()
        build_s = min(_timed(lambda: build_bvh(v, f, device=scene.device))
                      for _ in range(3))
        print(f"host BVH build of {f.shape[0]} triangles: "
              f"{build_s * 1e3:.2f} ms (best of 3)")

    # ---- 3a. each kernel against its plain version, lane by lane
    small = make(64, 64)
    tables = pack_scene_bvh(small)
    ray, _, _, lane, active = inputs(small, 4)
    got = primary_state(ray.o, ray.d, active)
    ref = got.clone()
    for depth in range(integ.max_depth):
        megakernel_bounce_bvh(tables, lane, SEED, got, depth, **depth_kw)
        ref = megakernel_bounce_bvh_plain(tables, lane, SEED, ref, depth,
                                          **depth_kw)
    torch.cuda.synchronize()
    check_lanes(f"{names['bounce']} {label} 64x64x4", got[6:9].T, ref[6:9].T)
    if single_launch:
        got = megakernel_trace_bvh(tables, lane, ray.o, ray.d, active, SEED,
                                   **depth_kw)
        torch.cuda.synchronize()
        check_lanes(f"{names['trace']} {label} 64x64x4", got,
                    megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d,
                                               active, SEED, **depth_kw))

    # ---- 3b. the main path, through the public entry point
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    first_render_s = time.perf_counter() - t0
    bounce_launches = megakernel_bounce_bvh.launches
    print(f"render sort_bounces=True: launches bounce_bvh {bounce_launches}, "
          f"trace_bvh {megakernel_trace_bvh.launches}; first render "
          f"{first_render_s * 1e3:.2f} ms")
    if not 1 <= bounce_launches <= integ.max_depth:
        raise AssertionError("the main path launched megakernel_bounce_bvh "
                             f"{bounce_launches} times, not 1..6")

    tables = pack_scene_bvh(scene)
    ray, weight, film_pos, lane, active = inputs(scene, spp)
    n = int(lane.shape[0])
    counts = {}
    t0 = time.perf_counter()
    plain_L = megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d, active,
                                         SEED, **depth_kw, counts=counts)
    torch.cuda.synchronize()
    plain_trace_ms = (time.perf_counter() - t0) * 1e3
    film = scene.sensor.film
    check_image(f"{label} sorted", image, film.develop(film.put_grouped(
        film_pos, plain_L * weight, spp, active)), width, height)

    # the path's own per-lane radiance, recording each depth's inputs
    sorted_L, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    torch.cuda.synchronize()
    err_bounce = check_lanes(
        f"{names['bounce']} {label} {width}x{height}x{spp} (sorted path)",
        sorted_L, plain_L)

    # ---- 3c. one launch for every depth
    unsorted = megapath.MegakernelPathIntegrator(
        integ.max_depth, integ.rr_depth, sort_bounces=False)
    reset_counters()
    image_unsorted = render(scene, unsorted, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    trace_launches = megakernel_trace_bvh.launches
    diff = abs(float(image_unsorted.mean()) - float(image.mean()))
    print(f"render sort_bounces=False: launches trace_bvh {trace_launches}, "
          f"bounce_bvh {megakernel_bounce_bvh.launches}; image mean "
          f"{float(image_unsorted.mean()):.7f} vs sorted "
          f"{float(image.mean()):.7f}, diff {diff:.3e}")
    if diff > 1e-5:
        raise AssertionError("sort_bounces=False changed the image")
    if not single_launch:
        if trace_launches or not megakernel_bounce_bvh.launches:
            raise AssertionError("sort_bounces=False on a textured or "
                                 "environment-lit scene did not take the "
                                 "per-depth pipeline")
    elif trace_launches < 1:
        raise AssertionError("sort_bounces=False never launched "
                             "megakernel_trace_bvh")
    if single_launch:
        perm = torch.as_tensor(megapath._morton_perm(width, height, n),
                               device=lane.device)
        m_args = (tables, lane[perm], ray.o[perm], ray.d[perm], active[perm],
                  SEED)
        trace_L = megakernel_trace_bvh(*m_args, **depth_kw)
        torch.cuda.synchronize()
        err_trace = check_lanes(
            f"{names['trace']} {label} {width}x{height}x{spp} (Morton order)",
            trace_L, plain_L[perm])

    # the persistent grids, and their schedule checks at full size
    kernels = ("trace", "bounce") if single_launch else ("bounce",)
    for kernel in kernels:
        grid = launch_config(kernel, n, btypes, env and kernel == "bounce")
        print(f"{names[kernel]} grid at {n} lanes: {grid}, "
              f"{n / (grid['blocks'] * grid['threads']):.1f} lanes a thread;"
              f" tree depth {tables.depth} of a stack cap of "
              f"{grid['stack_cap']}")
    if single_launch:
        check_schedule(names["trace"],
                       lambda *lanes: megakernel_trace_bvh(
                           tables, *lanes, SEED, **depth_kw),
                       *m_args[1:5], trace_L)
    check_bounce_schedule(
        names["bounce"], lambda rlane, st, depth: megakernel_bounce_bvh(
            tables, rlane, SEED, st, depth, **depth_kw), recorded)

    # ---- 3d. times
    render_ms = {}
    for name, it in (("sorted", integ), ("unsorted", unsorted)):
        render(scene, it, seed=SEED, spp=spp)
        render_ms[name] = wall_ms(lambda: render(scene, it, seed=SEED,
                                                 spp=spp), 5)
        print(f"{label} render {name}: {render_ms[name]:.3f} ms, "
              f"{n / render_ms[name] * 1e3:.4e} rays/s")
    bounce_ms = []
    plain_bounce_ms = 0.0
    for rlane, rstate, _, depth in recorded:
        bounce_ms.append(events_ms(
            lambda st: megakernel_bounce_bvh(tables, rlane, SEED, st, depth,
                                             **depth_kw),
            5, setup=rstate.clone))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        megakernel_bounce_bvh_plain(tables, rlane, SEED, rstate, depth,
                                    **depth_kw)
        torch.cuda.synchronize()
        plain_bounce_ms += (time.perf_counter() - t0) * 1e3
    print(f"{names['bounce']} {label} per depth ms: "
          + ", ".join(f"{t:.4f}" for t in bounce_ms)
          + f"; sum {sum(bounce_ms):.4f}, plain {plain_bounce_ms:.1f}")

    ops = (counts["node_visits"] * OPS_PER_NODE_VISIT
           + (counts["closest_tests"] + counts["shadow_tests"])
           * OPS_PER_TRI_TEST)
    # every lane's act is read; only a live lane goes on to read its lane
    # id and the rest of its state and to write the state back; a textured
    # hit also reads its texels, an escape or an environment NEE sample the
    # map's texels and CDF entries
    live = [int((rstate[15] > 0.5).sum()) for _, rstate, _, _ in recorded]
    texels = 4 * (counts.get("tex_floats", 0) + counts.get("env_floats", 0))
    b_bytes = tables.nbytes + texels + sum(
        4 * n + k * (4 + (STATE_BYTES - 4) + STATE_BYTES) for k in live)
    t_bytes_in = tables.nbytes + texels + n * (4 + 12 + 12 + 1 + 12)
    b_bound, b_by, t_ops, b_t = bound(ops, b_bytes)
    t_bound, t_by, _, t_t = bound(ops, t_bytes_in)
    print(f"work: {counts['node_visits']} node visits, "
          f"{counts['closest_tests']} closest tests, {counts['shadow_tests']} "
          f"shadow tests, {texels} texel bytes -> {ops:.4e} ops, "
          f"{t_ops:.4f} ms; live lanes per depth {live}; bytes bounce "
          f"{b_bytes} -> {b_t:.4f} ms, trace {t_bytes_in} -> {t_t:.4f} ms")

    common = {"route": "cuda",
              "source": "mitsuba_tpu_torch/csrc/megakernel_bvh.cu",
              "library_ms": None}
    rows = [{"name": names["bounce"], **common,
             "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:2206",
             "launches": bounce_launches, "max_abs_err": err_bounce,
             "ms": sum(bounce_ms), "plain_ms": plain_bounce_ms,
             "bound_ms": b_bound, "bound_by": b_by}]
    if single_launch:
        trace_ms = events_ms(lambda: megakernel_trace_bvh(*m_args,
                                                          **depth_kw), 5)
        print(f"{names['trace']} {label}: {trace_ms:.4f} ms, plain "
              f"{plain_trace_ms:.1f} ms")
        rows.append({"name": names["trace"], **common,
                     "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:1931",
                     "launches": trace_launches, "max_abs_err": err_trace,
                     "ms": trace_ms, "plain_ms": plain_trace_ms,
                     "bound_ms": t_bound, "bound_by": t_by})
    return rows, image, render_ms


def check_hits(name, t, prim, t_ref, prim_ref):
    """Hit queries against their plain versions: hit and prim agree on at
    least 99.99 % of rays, t within 1e-5 relative.  Returns the largest
    |t - t_ref| where both hit."""
    import torch

    hit, hit_ref = torch.isfinite(t), torch.isfinite(t_ref)
    both = hit & hit_ref
    same = (hit == hit_ref) & (prim.long() == prim_ref.long())
    dt = (t[both] - t_ref[both]).abs()
    same[both] &= dt <= 1e-5 * t_ref[both].abs()
    frac = float(same.float().mean())
    err = float(dt.max()) if dt.numel() else 0.0
    print(f"{name}: {frac:.6f} of {t.shape[0]} rays agree, "
          f"{float(hit.float().mean()):.4f} hit, max |dt| {err:.3e}")
    if frac < 0.9999:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def check_exact_hits(name, got, ref):
    """A hit query that must equal its plain version bit for bit: t, prim,
    u and v of every ray.  Returns the largest |dt| (0)."""
    import torch

    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    hit = torch.isfinite(got[0])
    print(f"{name}: t, prim, u, v bitwise equal {same} over "
          f"{got[0].shape[0]} rays, {float(hit.float().mean()):.4f} hit")
    if not all(same):
        raise AssertionError(f"{name}: kernel differs from the plain version")
    return 0.0


def check_masks(tris, o, d):
    """Phase 4a's synthetic masks: intersect_packed against its plain
    version, bit for bit, on the rays (o, d) under each mask and ray
    count (the middle rays of the call, where most hit), with maxt = inf
    and with a seeded finite maxt."""
    import torch

    from mitsuba_tpu_torch.ops import intersect_packed as ip

    n = int(o.shape[0])
    grid = ip.launch_config(int(tris.shape[1]), n)
    g = torch.Generator(device=o.device).manual_seed(SEED)
    half = torch.rand(n, generator=g, device=o.device) < 0.5
    ones = torch.ones(n, dtype=torch.bool, device=o.device)
    masks = {"all active": ones,
             "about 10 % active":
                 torch.rand(n, generator=g, device=o.device) < 0.1,
             "none active": ~ones, "n = 1": ones[:1]}
    for k in (grid["chunk"] - 1, grid["chunk"] + 1, grid["threads"] - 1,
              grid["threads"] + 1):
        masks[f"n = {k}, half active"] = half[:k]
    # primary hits of the Cornell box lie at t of about 3 to 5
    finite = 8.0 * torch.rand(n, generator=g, device=o.device)
    for label, mask in masks.items():
        k = int(mask.shape[0])
        mid = slice((n - k) // 2, (n - k) // 2 + k)
        for maxt in (torch.full((k,), float("inf"), device=o.device),
                     finite[:k]):
            args = (tris, o[mid], d[mid], maxt, mask)
            check_exact_hits(f"intersect_packed mask {label}, "
                             f"finite maxt {bool(torch.isfinite(maxt[0]))}",
                             ip.intersect_packed(*args),
                             ip.intersect_packed_plain(*args))


def check_occluded(name, occ, occ_ref):
    """Any-hit queries: at least 99.99 % of rays agree.  Returns the
    largest |occ - occ_ref| (0 or 1), from the count of rays that
    differ (a float mean of the matches can round below 1 on the card)."""
    n = int(occ.shape[0])
    differ = int((occ != occ_ref).sum())
    frac = 1.0 - differ / max(n, 1)
    print(f"{name}: {frac:.6f} of {n} rays agree ({differ} differ), "
          f"{float(occ.float().mean()):.4f} occluded")
    if frac < 0.9999:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return float(differ > 0)


def hold_calls(name, calls, q, refs=None):
    """Each recorded call (args, kwargs) of hit query ``q`` through its
    kernel and its plain version (appended to ``refs``, a list, if given,
    with the kernel's output: (got, ref)): checks them against each other and sums
    over the calls the kernel's CUDA-event median of 5, the plain version's
    single run, its work counts and the bytes: the tables its kernel reads
    once (they stay in L2 between the frame's launches), each ray's active
    flag and outputs, and o, d and maxt of an active ray.  Also returns
    each call's active rays and kernel ms."""
    import torch

    from mitsuba_tpu_torch.utils.profile_path import events_ms

    plain_ms = err = 0.0
    counts, n_active, call_ms = {}, [], []
    nbytes = q["table_bytes"](calls[0][0][0])
    for i, (args, kw) in enumerate(calls):
        got = q["kernel"](*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # each call its own counts (the plain walks' per-lane tallies
        # need one ray count), summed below
        call_counts = {}
        ref = q["plain"](*args, **kw, counts=call_counts)
        for k, v in call_counts.items():
            if k != "per_lane":
                counts[k] = counts.get(k, 0) + v
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        err = max(err, q["check"](f"{name} call {i}", got, ref))
        if refs is not None:
            refs.append((got, ref))
        call_ms.append(events_ms(lambda: q["kernel"](*args, **kw), 5))
        n_active.append(int(args[4].sum()))
        nbytes += (int(args[1].shape[0]) * (1 + q["out_bytes"])
                   + n_active[-1] * RAY_IN_BYTES)
    return sum(call_ms), plain_ms, err, counts, nbytes, n_active, call_ms


def hit_queries():
    """The wavefront's hit queries: what chip_smoke needs of each."""
    from mitsuba_tpu_torch.ops import intersect_packed as ip
    from mitsuba_tpu_torch.ops import traverse as tv

    def hits(name, got, ref):
        return check_hits(name, got[0], got[1], ref[0], ref[1])

    def walk_bytes(tables):
        """The tables the kernels' walk reads on the tree's route."""
        read = ((tables.node_pair, tables.leaf_geo, tables.leaf_face)
                if tv.route_for(tables.depth) == "pair" else tables.tensors())
        return sum(x.numel() * x.element_size() for x in read)

    return {
        "intersect_packed": dict(
            kernel=ip.intersect_packed, plain=ip.intersect_packed_plain,
            check=check_exact_hits, out_bytes=16,
            table_bytes=lambda tris: tris.nbytes,
            source="csrc/intersect_packed.cu",
            replaces="mitsuba_tpu/ops/pallas/intersect_pallas.py:125"),
        "packet_closest_hit": dict(
            kernel=tv.packet_closest_hit, plain=tv.packet_closest_hit_plain,
            check=hits, out_bytes=8, table_bytes=walk_bytes,
            kind="closest", source="csrc/traverse.cu",
            replaces="mitsuba_tpu/ops/pallas/traverse.py:2133"),
        "packet_any_hit": dict(
            kernel=tv.packet_any_hit, plain=tv.packet_any_hit_plain,
            check=check_occluded, out_bytes=1, table_bytes=walk_bytes,
            kind="any", source="csrc/traverse.cu",
            replaces="mitsuba_tpu/ops/pallas/traverse.py:2240"),
    }


def same_outputs(a, b):
    """Two outputs of a hit query equal bit for bit: (t, face) or
    occluded."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return same_bits(a[0], b[0]) and torch.equal(a[1], b[1])


def take(out, idx):
    """The rays ``idx`` of a hit query's output."""
    import torch

    return out[idx] if isinstance(out, torch.Tensor) else tuple(
        x[idx] for x in out)


def hit_grids(n, depth):
    """Prints and returns both BVH hit kernels' launch over n rays of a
    tree ``depth`` deep (launch_config: grid, route)."""
    from mitsuba_tpu_torch.ops import traverse as tv

    grids = {kind: tv.launch_config(n, depth, kind)
             for kind in ("closest", "any")}
    for kind, grid in grids.items():
        print(f"packet_{kind}_hit grid at {n} rays, tree {depth} deep: "
              f"{grid}")
    return grids


def check_hit_masks(tables, o, d):
    """Phase 5's synthetic masks: packet_closest_hit and packet_any_hit
    against their plain versions, by check_hits' and check_occluded's bar,
    on the rays (o, d) under each mask and ray count (the middle rays of
    the call, where most hit): all active, about 10 % active, none
    active, n = 1, and n one below and one above a warp's chunk of slots
    and each kernel's grid's total threads (all from launch_config),
    each with maxt = inf and with a seeded finite maxt."""
    import torch

    from mitsuba_tpu_torch.ops import traverse as tv

    q = hit_queries()
    n = int(o.shape[0])
    grids = [tv.launch_config(n, tables.depth, kind)
             for kind in ("closest", "any")]
    g = torch.Generator(device=o.device).manual_seed(SEED)
    half = torch.rand(n, generator=g, device=o.device) < 0.5
    ones = torch.ones(n, dtype=torch.bool, device=o.device)
    masks = {"all active": ones,
             "about 10 % active":
                 torch.rand(n, generator=g, device=o.device) < 0.1,
             "none active": ~ones, "n = 1": ones[:1]}
    sizes = {grids[0]["chunk"]} | {c["blocks"] * c["threads"] for c in grids}
    for k in sorted(sizes):
        for m in (k - 1, k + 1):
            masks[f"n = {m}, half active"] = half[:m]
    # primary hits of big_scene lie at t of about 3 to 6
    finite = 8.0 * torch.rand(n, generator=g, device=o.device)
    for label, mask in masks.items():
        k = int(mask.shape[0])
        mid = slice((n - k) // 2, (n - k) // 2 + k)
        for maxt in (torch.full((k,), float("inf"), device=o.device),
                     finite[:k]):
            args = (tables, o[mid], d[mid], maxt, mask)
            for name in ("packet_closest_hit", "packet_any_hit"):
                q[name]["check"](
                    f"{name} mask {label}, finite maxt "
                    f"{bool(torch.isfinite(maxt[0]))}",
                    q[name]["kernel"](*args), q[name]["plain"](*args))


def check_hit_schedule(name, kernel, calls):
    """On each recorded call of a hit kernel, a second launch and a launch
    on a seeded permutation of the rays (un-permuted) must give every
    ray's outputs bit for bit: the warps take slots in whatever order
    their walks end."""
    import torch

    for i, (args, kw) in enumerate(calls):
        tables, o, d, maxt, active = args
        first = kernel(*args, **kw)
        g = torch.Generator(device=o.device).manual_seed(SEED + i)
        perm = torch.randperm(int(o.shape[0]), generator=g, device=o.device)
        checks = {"second launch": same_outputs(kernel(*args, **kw), first),
                  "permuted rays": same_outputs(
                      kernel(tables, o[perm], d[perm], maxt[perm],
                             active[perm]), take(first, perm))}
        print(f"{name} schedule, call {i}, {int(active.sum())} active of "
              f"{int(o.shape[0])} rays: {checks}")
        if not all(checks.values()):
            raise AssertionError(f"{name}: a ray's outputs depend on the "
                                 "schedule")


def pair_twin(name, q, calls):
    """The pair walk's own work on the path's calls, from its eager twin
    (ops/bvh.py pair_walk), printed as information beside the bound, with
    the rays where the twin and the kernel differ."""
    import torch

    from mitsuba_tpu_torch.ops import bvh

    counts, differ = {}, 0
    for args, kw in calls:
        tables, o, d, maxt, active = args
        t, slot = bvh.pair_walk(tables.bvh(), tables.leaf_geo, o, d, maxt,
                                active, any_hit=q["kind"] == "any",
                                counts=counts)
        got = q["kernel"](*args, **kw)
        if q["kind"] == "any":
            differ += int((got != torch.isfinite(t)).sum())
        else:
            face = torch.where(slot >= 0, tables.leaf_face.long()[
                slot.clamp(min=0)], -1)
            differ += int(((got[0].view(torch.int32) != t.view(torch.int32))
                           | (got[1].long() != face)).sum())
    print(f"{name} pair walk (eager twin): {counts.get('record_visits', 0)} "
          f"record visits, {counts.get('tests', 0)} triangle tests; rays "
          f"where the kernel differs from the twin: {differ}")


def wavefront_phase(label, make, spp, names):
    """Phases 4 and 5: the wavefront PathIntegrator on ``make(256, 256)``
    at ``spp``, whose path must run exactly the hit queries ``names``.
    Returns their kernel rows."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                                   render)
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import record_calls, wall_ms

    integ = PathIntegrator(max_depth=6, rr_depth=5)
    queries = hit_queries()

    def traced_sample(scene, spp):
        """integ.sample on the scene's primary rays, recording each hit
        query's calls."""
        ray, _, _, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        with ExitStack() as stack:
            calls = {n: stack.enter_context(record_calls(scene_mod, n))
                     for n in names}
            L = integ.sample(scene, ray, lane, SEED, active)
        return L, (ray, lane, active), calls

    # ---- a. each kernel against its plain version, every call of a small
    # render (64x64 x 4: primary rays, then each depth's rays)
    _, _, calls = traced_sample(make(64, 64), 4)
    for n in names:
        for i, (args, kw) in enumerate(calls[n]):
            queries[n]["check"](f"{n} 64x64x4 call {i}",
                                queries[n]["kernel"](*args, **kw),
                                queries[n]["plain"](*args, **kw))
    if "intersect_packed" in names:
        tris, o, d = calls["intersect_packed"][0][0][:3]
        check_masks(tris, o, d)

    # ---- b. the main path, through the public entry point
    width = height = 256
    scene = make(width, height)
    n_lanes = width * height * spp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = require_launches(f"{label} render",
                                {n: 2 * integ.max_depth
                                 if n == "intersect_packed"
                                 else integ.max_depth for n in names})
    if "packet_closest_hit" in names:
        require_route(f"{label} render", "pair")
    print(f"{label} render {width}x{height}x{spp}: first {first_ms:.2f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---- c. per lane and image against the megakernel path
    L, (ray, lane, active), calls = traced_sample(scene, spp)
    mega = MegakernelPathIntegrator(integ.max_depth, integ.rr_depth)
    L_mega = mega.sample(scene, ray, lane, SEED, active)
    torch.cuda.synchronize()
    check_lanes(f"{label} PathIntegrator vs MegakernelPathIntegrator "
                f"{width}x{height}x{spp}", L, L_mega)
    check_image(f"{label} vs megakernel", image,
                render(scene, mega, seed=SEED, spp=spp), width, height)

    # ---- d. times
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 5)
    print(f"{label} render: {ms:.3f} ms, {n_lanes / ms * 1e3:.4e} rays/s")
    if "intersect_packed" in names:
        from mitsuba_tpu_torch.ops.intersect_packed import launch_config

        n_faces = int(calls["intersect_packed"][0][0][0].shape[1])
        print(f"intersect_packed grid at {n_lanes} rays: "
              f"{launch_config(n_faces, n_lanes)}")
    if "packet_closest_hit" in names:
        tables, o, d = calls["packet_closest_hit"][0][0][:3]
        walk_route = hit_grids(n_lanes, tables.depth)["closest"]["route"]
    rows = []
    for n in names:
        q = queries[n]
        kernel_ms, plain_ms, err, counts, nbytes, n_active, call_ms = \
            hold_calls(f"{n} {width}x{height}x{spp}", calls[n], q)
        ops = (counts.get("node_visits", 0) * OPS_PER_NODE_VISIT
               + counts["tests"] * OPS_PER_TRI_TEST)
        bound_ms, bound_by, t_ops, t_bytes = bound(ops, nbytes)
        print(f"{n}: {kernel_ms:.4f} ms over {len(calls[n])} launches, plain "
              f"{plain_ms:.2f} ms; node visits {counts.get('node_visits', 0)},"
              f" tests {counts['tests']} -> {ops:.4e} ops, {t_ops:.4f} ms; "
              f"active rays per call {n_active}; ms per call "
              f"{[round(x, 4) for x in call_ms]}; {nbytes} bytes -> "
              f"{t_bytes:.4f} ms")
        row = {"name": n, "route": "cuda",
               "source": f"mitsuba_tpu_torch/{q['source']}",
               "replaces": q["replaces"], "launches": launches[n],
               "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if n != "intersect_packed":
            pair_twin(n, q, calls[n])
            check_hit_schedule(n, q["kernel"], calls[n])
            row["walk_route"] = walk_route
        rows.append(row)
    if "packet_closest_hit" in names:
        check_hit_masks(tables, o, d)
    return rows


def fallback_phase():
    """Phase 6: a BVH scene with two area lights, outside the megakernel
    subset, through MegakernelPathIntegrator: it must fall back to the
    wavefront path and its BVH queries."""
    import dataclasses

    import torch

    from mitsuba_tpu_torch import MegakernelPathIntegrator, big_scene, render
    from mitsuba_tpu_torch.models.emitters import AreaEmitter
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.models.textures import ConstantTexture

    base = big_scene(64, 64)
    meshes = list(base.meshes)
    meshes[1] = dataclasses.replace(meshes[1], emitter_index=1)   # the floor
    glow = AreaEmitter(radiance=ConstantTexture(
        torch.tensor([0.5, 0.4, 0.3], device=base.device)))
    scene = make_scene(meshes, base.bsdfs, list(base.emitters) + [glow],
                       base.sensor, base.device)
    reset_counters()
    image = render(scene, MegakernelPathIntegrator(6, 5), seed=SEED, spp=4)
    torch.cuda.synchronize()
    require_launches("fallback two lights", {"packet_closest_hit": 6,
                                             "packet_any_hit": 6})
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError("fallback: bad image")
    print(f"fallback two lights 64x64x4: image mean {float(image.mean()):.6f}")

    # a tree deeper than the BVH kernels' walk takes: 1,000 triangles in
    # 40 nested clusters, each half the size of the one around it
    from mitsuba_tpu_torch import PathIntegrator, cornell_box
    from mitsuba_tpu_torch.models.shapes import Mesh
    from mitsuba_tpu_torch.ops.megakernel_bvh import STACK_CAP

    base = cornell_box(64, 64)
    g = torch.Generator().manual_seed(SEED)
    tris = []
    for k in range(40):
        c = torch.randn(25, 3, generator=g, dtype=torch.float64)
        c *= 0.3 * 0.5 ** k / c.norm(dim=1, keepdim=True)
        tris.append(c[:, None] + 0.003 * 0.5 ** k * torch.randn(
            25, 3, 3, generator=g, dtype=torch.float64))
    v = torch.cat(tris).reshape(-1, 3).float().numpy()
    cluster = Mesh.make(v, torch.arange(len(v)).reshape(-1, 3).numpy(),
                        bsdf_index=0, id="clusters", device=base.device)
    scene = make_scene(list(base.meshes) + [cluster], base.bsdfs,
                       base.emitters, base.sensor, base.device)
    if scene.accel.depth <= STACK_CAP:
        raise AssertionError(f"fallback: the nested clusters' tree is only "
                             f"{scene.accel.depth} deep")
    reset_counters()
    image = render(scene, MegakernelPathIntegrator(6, 5), seed=SEED, spp=4)
    torch.cuda.synchronize()
    label = f"fallback BVH {scene.accel.depth} deep (cap {STACK_CAP})"
    require_launches(label, {"packet_closest_hit": 6, "packet_any_hit": 6})
    require_route(label, "miss_link")
    n = 64 * 64 * 4
    if {g["route"] for g in hit_grids(n, scene.accel.depth).values()} \
            != {"miss_link"}:
        raise AssertionError(f"{label}: launch_config's route is not the "
                             "miss-link walk")
    same = torch.equal(image, render(scene, PathIntegrator(6, 5), seed=SEED,
                                     spp=4))
    print(f"fallback deep BVH 64x64x4: image mean {float(image.mean()):.6f}, "
          f"equal to the PathIntegrator's {same}")
    if not same or not bool(torch.isfinite(image).all()):
        raise AssertionError("fallback: the deep-tree image is not the "
                             "wavefront's")
    # the miss-link route's calls of that path against the plain versions
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import record_calls

    q = hit_queries()
    ray, _, _, lane = sample_rays(scene, SEED, 4)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    with ExitStack() as stack:
        calls = {name: stack.enter_context(record_calls(scene_mod, name))
                 for name in ("packet_closest_hit", "packet_any_hit")}
        PathIntegrator(6, 5).sample(scene, ray, lane, SEED, active)
    for name, recorded in calls.items():
        for i, (args, kw) in enumerate(recorded):
            q[name]["check"](f"{label} {name} call {i}",
                             q[name]["kernel"](*args, **kw),
                             q[name]["plain"](*args, **kw))


def config2_bsdfs(device, rough):
    """The small and the large box of BASELINE config 2: a Cu conductor
    and a dielectric of eta 1.5, smooth or GGX rough (alpha 0.2)."""
    import torch

    from mitsuba_tpu_torch.models.bsdfs import (CONDUCTOR_IOR, RoughConductor,
                                                RoughDielectric,
                                                SmoothConductor,
                                                SmoothDielectric)

    eta, k = (torch.tensor(x, device=device) for x in CONDUCTOR_IOR["Cu"])
    ior = torch.tensor(1.5, device=device)
    alpha = torch.tensor(0.2, device=device)
    if rough:
        return [RoughConductor(eta=eta, k=k, alpha=alpha),
                RoughDielectric(eta=ior, alpha=alpha)]
    return [SmoothConductor(eta=eta, k=k), SmoothDielectric(eta=ior)]


def config2_cornell(rough):
    """A factory (width, height, device) of the config-2 Cornell box: the
    boxes' BSDFs appended to the walls' (reference utils/scenes.py
    small_box_bsdf / large_box_bsdf)."""
    from mitsuba_tpu_torch import cornell_box
    from mitsuba_tpu_torch.models.scene import make_scene

    def make(width, height, device=None):
        base = cornell_box(width, height, small_box_bsdf=3, large_box_bsdf=4,
                           device=device)
        return make_scene(base.meshes, list(base.bsdfs) + config2_bsdfs(
            base.device, rough), base.emitters, base.sensor, base.device)
    return make


def config2_big_scene(width, height, device=None):
    """big_scene with the 81,920-triangle ball a GGX rough dielectric
    (eta 1.5, alpha 0.2) and the small box a smooth Cu conductor."""
    import dataclasses

    from mitsuba_tpu_torch import big_scene
    from mitsuba_tpu_torch.models.scene import make_scene

    base = big_scene(width, height, device=device)
    cond, _ = config2_bsdfs(base.device, rough=False)
    _, rdiel = config2_bsdfs(base.device, rough=True)
    meshes = list(base.meshes)
    n = len(base.bsdfs)
    meshes[-1] = dataclasses.replace(meshes[-1], bsdf_index=n)   # the ball
    meshes[6] = dataclasses.replace(meshes[6], bsdf_index=n + 1)  # small box
    return make_scene(meshes, list(base.bsdfs) + [rdiel, cond], base.emitters,
                      base.sensor, base.device)


def wavefront_check(label, scene, spp, integ, allowed, mega, mega_image):
    """A config-2 render through the wavefront ``integ`` (the
    PathIntegrator): it must launch only the kernels of ``allowed`` (name
    -> most launches); its lanes must hold the per-lane bar against the
    megakernel integrator ``mega`` on the same rays and its image the
    reference's 2e-2 against ``mega_image``.  Returns its render ms."""
    import torch

    from mitsuba_tpu_torch import render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    require_launches(f"{label} {type(integ).__name__} render", allowed)
    rel = float((image - mega_image).abs().mean() / mega_image.mean())
    print(f"{label} {type(integ).__name__} image vs megakernel: mean abs "
          f"rel diff {rel:.3e} (bound 2e-2)")
    if not bool(torch.isfinite(image).all()) or rel >= 2e-2:
        raise AssertionError(f"{label}: the wavefront and megakernel images "
                             "disagree")
    ray, _, _, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    check_lanes(f"{label} {type(integ).__name__} vs megakernel lanes",
                integ.sample(scene, ray, lane, SEED, active),
                mega.sample(scene, ray, lane, SEED, active))
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 3)
    print(f"{label} {type(integ).__name__} render: {ms:.3f} ms")
    return ms


def direct_check(label, make, spp):
    """The DirectIntegrator on ``make``'s scene: per lane against the same
    integrator over the plain hit queries on the CPU at 32x32 x 4, then
    at 256x256 x ``spp`` through intersect_packed alone (primary, shadow
    and BSDF rays).  Returns its render ms."""
    import torch

    from mitsuba_tpu_torch import DirectIntegrator, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    integ = DirectIntegrator()
    got, want = [], []
    for device, out in (("cuda", got), ("cpu", want)):
        scene = make(32, 32, device=device)
        ray, _, _, lane = sample_rays(scene, SEED, 4)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        out.append(integ.sample(scene, ray, lane, SEED, active).cpu())
    check_lanes(f"{label} DirectIntegrator card vs CPU 32x32x4", got[0],
                want[0])
    scene = make(256, 256)
    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    require_launches(f"{label} DirectIntegrator render",
                     {"intersect_packed": 3})
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError(f"{label}: bad DirectIntegrator image")
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 3)
    print(f"{label} DirectIntegrator render 256x256x{spp}: {ms:.3f} ms, "
          f"image mean {float(image.mean()):.6f}")
    return ms


def config2_phase(integ):
    """Phase 7: BASELINE config 2 (conductor and dielectric lobes) through
    the lobe builds of the three path kernels and the wavefront and
    direct integrators; returns the lobe builds' rows."""
    from mitsuba_tpu_torch import PathIntegrator

    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    for rough in (False, True):
        label = "config-2 cornell" + (" rough" if rough else "")
        make = config2_cornell(rough)
        row, mega_image, mega_ms = cornell_phase(integ, make, label)
        rows.append(row)
        scene = make(256, 256)
        wave_ms = wavefront_check(label, scene, 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        direct_ms = direct_check(label, make, 64)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms, direct {direct_ms:.3f} ms")
    label = "config-2 big_scene"
    bvh_rows, mega_image, mega_ms = bvh_phase(integ, config2_big_scene, label)
    rows += bvh_rows
    wave_ms = wavefront_check(label, config2_big_scene(256, 256), 16, wave,
                              {"packet_closest_hit": wave.max_depth,
                               "packet_any_hit": wave.max_depth},
                              integ, mega_image)
    print(f"{label} renders 256x256x16: megakernel sorted "
          f"{mega_ms['sorted']:.3f} ms, unsorted {mega_ms['unsorted']:.3f} "
          f"ms, path {wave_ms:.3f} ms")
    return rows


def surfaces_phase(integ):
    """Phase 8: plastic, two-sided and bitmap-textured surfaces (BSDF
    codes 5-7 and +16) through the surface builds of the path kernels and
    the wavefront PathIntegrator; returns the surface builds' rows."""
    import dataclasses
    import functools

    from mitsuba_tpu_torch import PathIntegrator
    from mitsuba_tpu_torch.utils.scenes import (plastic_cornell,
                                                surfaces_big_scene,
                                                textured_cornell,
                                                twosided_cornell)

    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    # no fallback: a scene the kernels refuse raises instead
    integ = dataclasses.replace(integ, strict=True)
    for label, make in (
            ("plastic cornell", plastic_cornell),
            ("two-sided cornell", twosided_cornell),
            ("textured cornell", functools.partial(textured_cornell,
                                                   seed=SEED))):
        row, mega_image, mega_ms = cornell_phase(integ, make, label)
        rows.append(row)
        wave_ms = wavefront_check(label, make(256, 256), 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms")
    bvh_walks = {"packet_closest_hit": wave.max_depth,
                 "packet_any_hit": wave.max_depth}
    for label, make, single in (
            ("surfaces big_scene", surfaces_big_scene, True),
            ("textured big_scene", functools.partial(
                surfaces_big_scene, textured=True, seed=SEED), False)):
        bvh_rows, mega_image, mega_ms = bvh_phase(integ, make, label,
                                                  single_launch=single)
        rows += bvh_rows
        wave_ms = wavefront_check(label, make(256, 256), 16, wave, bvh_walks,
                                  integ, mega_image)
        print(f"{label} renders 256x256x16: megakernel {mega_ms}, path "
              f"{wave_ms:.3f} ms")
    build_split_check(integ)
    return rows


def envmap_phase(integ):
    """Phase 9: environment-map lighting through the environment builds of
    megakernel_trace and megakernel_bounce_bvh and the wavefront and direct
    integrators; returns the environment builds' rows and the phase's
    seconds."""
    import dataclasses
    import functools

    from mitsuba_tpu_torch import PathIntegrator
    from mitsuba_tpu_torch.utils.scenes import (envmap_big_scene, envmap_scene,
                                                sky_envmap)

    t0 = time.perf_counter()
    sky = sky_envmap(seed=SEED)   # made once; every scene takes a copy
    rows = []
    wave = PathIntegrator(integ.max_depth, integ.rr_depth)
    # no fallback: a scene the kernels refuse raises instead
    integ = dataclasses.replace(integ, strict=True)
    for label, area in (("envmap scene", False), ("envmap+area scene", True)):
        make = functools.partial(envmap_scene, area_light=area, env=sky)
        row, mega_image, mega_ms = cornell_phase(integ, make, label,
                                                 plain_reps=1)
        rows.append(row)
        wave_ms = wavefront_check(label, make(256, 256), 64, wave,
                                  {"intersect_packed": 2 * wave.max_depth},
                                  integ, mega_image)
        direct_ms = direct_check(label, make, 64)
        print(f"{label} renders 256x256x64: megakernel {mega_ms:.3f} ms, "
              f"path {wave_ms:.3f} ms, direct {direct_ms:.3f} ms")
    label = "envmap big_scene"
    make = functools.partial(envmap_big_scene, env=sky)
    bvh_rows, mega_image, mega_ms = bvh_phase(integ, make, label,
                                              single_launch=False)
    rows += bvh_rows
    wave_ms = wavefront_check(label, make(256, 256), 16, wave,
                              {"packet_closest_hit": wave.max_depth,
                               "packet_any_hit": wave.max_depth},
                              integ, mega_image)
    print(f"{label} renders 256x256x16: megakernel {mega_ms}, path "
          f"{wave_ms:.3f} ms")
    return rows, time.perf_counter() - t0


def build_split_check(integ):
    """What merging the lobe build into the surface build would cost: the
    config-2 scenes' kernels run as they do (the lobe build) and through
    the surface build (a code it alone takes, 6, added to btypes; no face
    carries it), in turns (lobe, surface, surface, lobe), CUDA-event
    medians of 5 each; every lane must be the same bits."""
    import torch

    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.megakernel import (megakernel_trace,
                                                  pack_scene, scene_btypes)
    from mitsuba_tpu_torch.ops.megakernel_bvh import (megakernel_trace_bvh,
                                                      pack_scene_bvh)
    from mitsuba_tpu_torch.utils.profile_path import events_ms

    def launches(scene, spp):
        ray, _, _, lane = sample_rays(scene, SEED, spp)
        active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
        depth_kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth)
        bt = scene_btypes(scene)
        if scene.accel is None:
            tris, light, n_faces, n_lights, _, _ = pack_scene(scene)
            return lambda btypes: megakernel_trace(
                tris, light, lane, ray.o, ray.d, active, SEED, **depth_kw,
                n_faces=n_faces, n_lights=n_lights, btypes=btypes), bt
        tables = pack_scene_bvh(scene)
        return lambda btypes: megakernel_trace_bvh(
            tables, lane, ray.o, ray.d, active, SEED, **depth_kw,
            smooth=True, btypes=btypes), bt

    for label, scene, spp in (
            ("megakernel_trace config-2 cornell", config2_cornell(False)(
                256, 256), 64),
            ("megakernel_trace config-2 cornell rough", config2_cornell(True)(
                256, 256), 64),
            ("megakernel_trace_bvh config-2 big_scene",
             config2_big_scene(256, 256), 16)):
        run, bt = launches(scene, spp)
        surface_bt = tuple(sorted(set(bt) | {6}))
        same = same_bits(run(bt), run(surface_bt))
        ms = {}
        for b in (bt, surface_bt, surface_bt, bt):
            ms.setdefault(b, []).append(events_ms(lambda: run(b), 5))
        print(f"build split {label} {bt}: lobe build "
              f"{ms[bt][0]:.4f} / {ms[bt][1]:.4f} ms, surface build "
              f"{ms[surface_bt][0]:.4f} / {ms[surface_bt][1]:.4f} ms, "
              f"lanes bitwise equal {same}")
        if not same:
            raise AssertionError(f"build split {label}: the surface build "
                                 "changed a lane")


# ------------------------------------------------- phase 10: config 3

PRB_SPP = 16        # spp and spp_grad of the loop
PRB_STEPS = 8
PRB_LR = 0.05


def prb_rel_err(got, want):
    """||got - want|| / ||want||, both moved to the CPU."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def require_finite(label, grads):
    import torch

    bad = [k for k, g in grads.items() if g is None
           or not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite gradients {bad}")


def prb_grads(scene, integ, params, loss_fn, spp, seed=SEED):
    """(loss, {path: gradient}) of ``loss_fn(prb_render(scene with
    params))``, the parameters fresh leaves."""
    from mitsuba_tpu_torch import prb_render
    from mitsuba_tpu_torch.utils.params import update

    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    img = prb_render(update(scene, leaves), integ, seed, spp, spp,
                     device=scene.device)
    loss = loss_fn(img)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


class StageTimer:
    """Host-clock ms of the integrator's walks within a step, each between
    two synchronisations: the primal walk (the first ``sample`` of a
    step), the replay of L0 (the second) and the adjoint walk
    (``sample_backward``)."""

    def __init__(self, integ):
        import torch

        self.ms = {"primal": [], "replay": [], "adjoint walk": []}
        self.integ = integ
        self._samples = 0

        def timed(fn, key):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                k = key or ("primal" if self._samples % 2 == 0 else "replay")
                self._samples += key is None
                self.ms[k].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        integ.sample = timed(integ.sample, None)
        integ.sample_backward = timed(integ.sample_backward, "adjoint walk")

    def close(self):
        del self.integ.sample, self.integ.sample_backward


def prb_loop(scene, integ, truth, start, steps, label):
    """The config-3 loop: ``steps`` steps of Adam(lr=0.05) on the
    parameters from ``start``, each clamped to [0, 1], the loss the mean
    squared error against the image at ``truth`` (same seed and spp, so it
    is 0 at the optimum).  Prints each step's loss and times; returns
    (losses, the step records, final params)."""
    import statistics

    import torch

    from mitsuba_tpu_torch import prb_render
    from mitsuba_tpu_torch.utils.optimizers import Adam
    from mitsuba_tpu_torch.utils.params import update

    target = prb_render(update(scene, truth), integ, SEED, PRB_SPP,
                        device=scene.device)
    opt = Adam(lr=PRB_LR)
    params = {k: v.clone() for k, v in start.items()}
    state = opt.init(params)
    timer = StageTimer(integ)
    losses, steps_ms, opt_ms, launches, peaks = [], [], [], [], []
    try:
        for i in range(steps):
            reset_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads = prb_grads(scene, integ, params,
                                    lambda img: torch.mean((img - target) ** 2),
                                    PRB_SPP)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state = opt.step(params, grads, state)
            params = {k: v.clamp(0.0, 1.0) for k, v in params.items()}
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            require_finite(f"{label} step {i}", grads)
            losses.append(float(loss))
            opt_ms.append((t2 - t1) * 1e3)
            steps_ms.append((t2 - t0) * 1e3)
            launches.append({n: fn.launches for n, fn in
                             kernel_wrappers().items() if fn.launches})
            peaks.append(torch.cuda.max_memory_allocated())
            print(f"{label} step {i}: loss {losses[-1]:.6e}, "
                  f"{steps_ms[-1]:.2f} ms, launches {launches[-1]}, peak "
                  f"memory {peaks[-1] / 2**30:.3f} GiB")
    finally:
        timer.close()
    split = {k: statistics.median(v) for k, v in timer.ms.items()}
    split["optimizer"] = statistics.median(opt_ms)
    step = statistics.median(steps_ms)
    split["rest (rays, splat, delta_L, loss)"] = step - sum(split.values())
    print(f"{label} step median {step:.2f} ms, split (ms, walks timed "
          f"between synchronisations): "
          f"{ {k: round(v, 2) for k, v in split.items()} }; peak memory "
          f"{max(peaks) / 2**30:.3f} GiB")
    return losses, dict(step_ms=step, split=split, launches=launches[-1],
                        peak=max(peaks)), params


def recorded_step(step, names):
    """``step()`` once with the calls of each hit query of ``names``
    recorded and the launches counted, then once under torch.profiler
    for its device-busy share: (calls, launches, profile)."""
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch.utils.profile_path import profile_run, record_calls

    reset_counters()
    with ExitStack() as stack:
        calls = {n: stack.enter_context(record_calls(scene_mod, n))
                 for n in names}
        step()
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()
                if fn.launches}
    prof = profile_run(step)
    print(f"device busy over one step: {prof['device_busy_ms']:.2f} of "
          f"{prof['profiled_render_ms']:.2f} ms, share "
          f"{prof['device_busy_share']:.4f}, {prof['device_kernel_launches']}"
          f" device kernels; top {prof['top_kernels'][:4]}")
    return calls, launches, prof


def prb_recorded_step(scene, integ, params, loss_fn, names):
    """One PRB step with the calls of each hit query of ``names``
    recorded, and its device-busy share under torch.profiler."""
    return recorded_step(lambda: prb_grads(scene, integ, params, loss_fn,
                                           PRB_SPP), names)[0]


def step_rows(tag, label, calls, launches, refs=None):
    """The kernel rows ``<kernel>[<tag>]`` of a training step's recorded
    hit-query calls, each call held against its plain version by its
    phase-4/5 bar (the outputs of each query's calls put in ``refs``, a
    dict, if given)."""
    queries = hit_queries()
    rows = []
    for n, recorded in calls.items():
        q = queries[n]
        kernel_ms, plain_ms, err, counts, nbytes, n_active, call_ms = \
            hold_calls(f"{n} {label}", recorded, q,
                       None if refs is None else refs.setdefault(n, []))
        ops = (counts.get("node_visits", 0) * OPS_PER_NODE_VISIT
               + counts["tests"] * OPS_PER_TRI_TEST)
        bound_ms, bound_by, t_ops, t_bytes = bound(ops, nbytes)
        print(f"{n}[{tag}] {label}: {kernel_ms:.4f} ms over {len(recorded)} "
              f"launches a step, plain {plain_ms:.2f} ms; {ops:.4e} ops -> "
              f"{t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms; active "
              f"rays per call {n_active}")
        if launches.get(n) != len(recorded):
            raise AssertionError(f"{n}[{tag}]: {launches.get(n)} counted "
                                 f"launches, {len(recorded)} recorded calls")
        rows.append({"name": f"{n}[{tag}]", "route": "cuda",
                     "source": f"mitsuba_tpu_torch/{q['source']}",
                     "replaces": q["replaces"], "launches": launches[n],
                     "max_abs_err": err, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return rows


def prb_phase():
    """Phase 10: differentiable rendering (BASELINE config 3) through
    prb_render, the scene parameters and Adam; returns the kernel rows of
    the hit queries a PRB step launches and the phase's seconds."""
    import torch

    from mitsuba_tpu_torch import PRBIntegrator, big_scene, prb_render
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.scenes import textured_cornell

    t0 = time.perf_counter()
    integ = PRBIntegrator(max_depth=6, rr_depth=5)
    scene = textured_cornell(256, 256, seed=SEED)
    tex = f"bsdfs.{scene.meshes[3].bsdf_index}.reflectance.data"
    alb = "bsdfs.2.reflectance.value"
    leaves = traverse(scene)
    truth = {k: leaves[k] for k in (tex, alb)}
    g = torch.Generator(device=scene.device).manual_seed(SEED)
    start = {tex: (truth[tex] + 0.4 * torch.rand(
                 truth[tex].shape, generator=g, device=scene.device)
                 - 0.2).clamp(0.0, 1.0),
             alb: 0.2 + 0.6 * torch.rand(3, generator=g, device=scene.device)}
    print(f"config 3 loop: textured_cornell(256, 256), PRBIntegrator(6, 5), "
          f"spp {PRB_SPP} / {PRB_SPP}, Adam(lr={PRB_LR}) x {PRB_STEPS}; "
          f"parameters {tex} {tuple(truth[tex].shape)} and {alb}; start "
          f"albedo {start[alb].tolist()}, truth {truth[alb].tolist()}")

    # ---- a. the loop at full width
    losses, rec, params = prb_loop(scene, integ, truth, start, PRB_STEPS,
                                   "config 3")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"config 3: loss {losses[-1]} after "
                             f"{PRB_STEPS} steps, first {losses[0]}")
    print(f"config 3 losses {losses}; final albedo {params[alb].tolist()}")
    if "intersect_packed" not in rec["launches"] or set(rec["launches"]) \
            != {"intersect_packed"}:
        raise AssertionError(f"config 3: launches {rec['launches']}")

    # ---- b. every hit query of one step against its plain version
    w = torch.rand((256, 256, 3), generator=g, device=scene.device)
    calls = prb_recorded_step(scene, integ, params,
                              lambda img: torch.sum(img * w),
                              ["intersect_packed"])
    rows = step_rows("prb", "config 3 step", calls, rec["launches"])

    # ---- c. the card's gradients against the plain route on the CPU
    w32 = torch.rand((32, 32, 3), generator=g, device=scene.device)
    grads = {}
    for dev in ("card", "cpu"):
        sc = textured_cornell(32, 32, seed=SEED, device=(
            scene.device if dev == "card" else "cpu"))
        p = {k: v.to(sc.device) for k, v in start.items()}
        _, grads[dev] = prb_grads(
            sc, integ, p, lambda img: torch.sum(img * w32.to(img.device)), 4)
        require_finite(f"32x32 gradients on the {dev}", grads[dev])
    for k in start:
        err = prb_rel_err(grads["card"][k], grads["cpu"][k])
        print(f"32x32x4 gradient {k}: card vs CPU relative error {err:.3e}")
        if not err <= 1e-3:
            raise AssertionError(f"{k}: the card's gradient disagrees with "
                                 "the CPU route")

    # ---- d. the albedo gradient at full width against central differences
    fd_integ = PRBIntegrator(max_depth=6, rr_depth=16)
    a0 = truth[alb]
    eps = 5e-3
    _, ga = prb_grads(scene, fd_integ, {alb: a0}, torch.mean, PRB_SPP)
    require_finite("finite-difference check", ga)
    step = torch.tensor([eps, 0.0, 0.0], device=scene.device)

    def mean_at(a):
        return torch.mean(prb_render(update(scene, {alb: a}), fd_integ, SEED,
                                     PRB_SPP, device=scene.device))

    fd = float(mean_at(a0 + step) - mean_at(a0 - step)) / (2 * eps)
    got = float(ga[alb][0])
    print(f"albedo gradient 256x256x{PRB_SPP}: PRB {got:.6e}, central "
          f"differences {fd:.6e}, rel {abs(got - fd) / abs(fd):.3e}")
    if not abs(got - fd) < 0.05 * abs(fd):
        raise AssertionError("the albedo gradient disagrees with central "
                             "differences")

    # ---- e. one step on big_scene: #5 and #6
    big = big_scene(256, 256)
    white, verts = "bsdfs.0.reflectance.value", "meshes.8.vertices"
    bl = traverse(big)
    btruth = {white: bl[white]}
    bstart = {white: bl[white] * 0.7}
    _, brec, bparams = prb_loop(big, integ, btruth, bstart, 1, "big_scene")
    if set(brec["launches"]) != {"packet_closest_hit", "packet_any_hit"}:
        raise AssertionError(f"big_scene step: launches {brec['launches']}")
    bp = {white: bparams[white], verts: bl[verts]}
    _, bg = prb_grads(big, integ, bp, torch.mean, PRB_SPP)
    require_finite("big_scene gradients", bg)
    print(f"big_scene gradient norms: "
          f"{ {k: float(v.norm()) for k, v in bg.items()} }")
    if not float(bg[verts].norm()) > 0:
        raise AssertionError("big_scene: no gradient reaches the vertices")
    calls = prb_recorded_step(big, integ, bp, torch.mean,
                              ["packet_closest_hit", "packet_any_hit"])
    require_route("big_scene PRB step", "pair")
    rows += step_rows("prb", "big_scene step", calls, brec["launches"])
    return rows, time.perf_counter() - t0


# ---------------------------------------------- phase 11: config 5 (lens)

LENS_SEED = 0
REFIT_FRAME = dict(size=256, spp=4, render_spp=16)
# the examples' full sizes: film side, light paths a pixel, Adam steps
DOUBLET_RUN = dict(resolution=24, spp=2048, steps=5)
TRIPLET_RUN = dict(resolution=32, spp=128, steps=3)


def count_ties(t, prim, t_ref, prim_ref):
    """(rays whose hit differs, of them ties: both hit at t equal within
    1e-6 relative, another face)."""
    import torch

    hit, hit_ref = torch.isfinite(t), torch.isfinite(t_ref)
    other = (hit != hit_ref) | (hit & (prim.long() != prim_ref.long()))
    tie = other & hit & hit_ref & (
        (t - t_ref).abs() <= 1e-6 * t_ref.abs())
    return int(other.sum()), int(tie.sum())


def refit_phase():
    """Phase 11a: big_scene's ball moved by -0.5 in x through
    params.update, no rebuild.  #5 and #6 over the tree refitted at the
    render against the plain walks over it, and the hits against a
    rebuilt tree's (ties aside); the stale tree's hits counted; refit_bvh
    and the render of the moved scene timed."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import PathIntegrator, big_scene, render
    from mitsuba_tpu_torch.models.integrators import sample_rays
    from mitsuba_tpu_torch.ops.bvh import refit_bvh
    from mitsuba_tpu_torch.ops.traverse import pack_bvh_geometry
    from mitsuba_tpu_torch.utils.params import refresh_accel, traverse, update
    from mitsuba_tpu_torch.utils.profile_path import (events_ms, record_calls,
                                                      wall_ms)

    ball = "meshes.8.vertices"
    size = REFIT_FRAME["size"]
    base = big_scene(size, size)
    v = traverse(base)[ball]
    moved = update(base, {ball: v + torch.tensor([-0.5, 0.0, 0.0],
                                                  device=v.device)})
    ray, _, _, lane = sample_rays(moved, SEED, REFIT_FRAME["spp"])
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    queries = hit_queries()
    with record_calls(scene_mod, "packet_closest_hit") as closest, \
            record_calls(scene_mod, "packet_any_hit") as anyhit:
        ctx = moved.trace_ctx()
        si = moved.ray_intersect(ray, active, ctx)
        light = moved.meshes[0].vertices.mean(dim=0).expand_as(si.p)
        shadow = si.spawn_ray_to(light)
        occ = moved.ray_test(shadow, si.is_valid(), ctx)
    for name, calls in (("packet_closest_hit", closest),
                        ("packet_any_hit", anyhit)):
        hold_calls(f"refit {name}", calls, queries[name])
    t, prim = scene_mod.packet_closest_hit(*closest[0][0])

    def hits(scene):
        c = scene.trace_ctx()
        return scene_mod.packet_closest_hit(c["bvh"], *closest[0][0][1:]), c

    (t_new, prim_new), ctx_new = hits(refresh_accel(moved))
    other, ties = count_ties(t, prim, t_new, prim_new)
    print(f"refit: {t.shape[0]} camera rays against the rebuilt tree: "
          f"{other} differ, {ties} of them ties; tree depth "
          f"{moved.accel.depth}, {moved.accel.n_nodes} nodes")
    if other != ties:
        raise AssertionError("refit: hits differ from the rebuilt tree's")
    occ_new = scene_mod.packet_any_hit(ctx_new["bvh"], shadow.o, shadow.d,
                                       shadow.maxt, si.is_valid())
    print(f"refit: shadow rays occluded {int(occ.sum())}, rebuilt tree "
          f"{int(occ_new.sum())}, differ {int((occ != occ_new).sum())}")
    if int((occ != occ_new).sum()) > occ.numel() // 10000:
        raise AssertionError("refit: shadow rays differ from the rebuilt "
                             "tree's")
    # the stale tree: the moved faces over the built boxes
    v, f = moved.geometry()[:2]
    p = v.detach()[f]
    stale = pack_bvh_geometry(moved.accel, torch.cat(
        [p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1))
    t_stale, prim_stale = scene_mod.packet_closest_hit(
        stale, *closest[0][0][1:])
    n_stale = count_ties(t_stale, prim_stale, t_new, prim_new)[0]
    print(f"refit: the stale tree (no refit) gives {n_stale} other hits")
    refit_ms = events_ms(lambda: refit_bvh(moved.accel, v), 5)
    pack_ms = events_ms(lambda: moved.trace_ctx(), 5)
    integ = PathIntegrator(max_depth=6, rr_depth=5)
    spp = REFIT_FRAME["render_spp"]
    render(moved, integ, SEED, spp)
    render_ms = wall_ms(lambda: render(moved, integ, SEED, spp), 3)
    print(f"refit_bvh: {refit_ms:.4f} ms a render (CUDA events, median of "
          f"5; trace_ctx with it {pack_ms:.4f} ms) against the moved "
          f"scene's PathIntegrator render {size}x{size} x {spp}, "
          f"{render_ms:.2f} ms "
          f"(host clock, median of 3): {100 * refit_ms / render_ms:.3f} %")


def timed_design(dp, label, **opt_kw):
    """``dp.optimize(**opt_kw)`` with every launch counter set to 0 just
    before; each step's host-clock ms (synchronised), the launches and the
    peak memory.  Fails on a skipped (non-finite) step or a dropped
    sensor draw."""
    import statistics

    import torch

    marks = []

    def cb(it, p, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        print(f"{label} step {it}: loss {loss:.6e}, "
              f"{ {k: round(float(v), 6) for k, v in p.items()} }")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    p = dp.optimize(callback=cb, **opt_kw)
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()
                if fn.launches}
    steps = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: steps {[round(x, 2) for x in steps]} ms, median "
          f"{statistics.median(steps):.2f} ms; launches {launches}; peak "
          f"memory {peak / 2**30:.3f} GiB; skipped steps "
          f"{dp.skipped_steps}, sensor drops {dp.sensor_drops}")
    if dp.skipped_steps or any(dp.sensor_drops) or not all(
            math.isfinite(x) for x in dp.loss_history):
        raise AssertionError(f"{label}: a step had a non-finite loss or "
                             "gradient")
    return p, dict(steps=steps, launches=launches, peak=peak,
                   step_ms=statistics.median(steps))


def recorded_design_step(dp, names):
    """One gradient of the design's loss with the calls of each hit query
    of ``names`` recorded and counted (the counters set to 0 just before),
    and its device-busy share under torch.profiler."""
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch.lens.design import value_and_grad
    from mitsuba_tpu_torch.utils.profile_path import profile_run, record_calls

    fn = value_and_grad(dp.loss)
    reset_counters()
    with ExitStack() as stack:
        calls = {n: stack.enter_context(record_calls(scene_mod, n))
                 for n in names}
        v, g = fn(dp.params(), LENS_SEED)
    launches = {n: fn_.launches for n, fn_ in kernel_wrappers().items()
                if fn_.launches}
    require_finite("recorded design step", g)
    prof = profile_run(lambda: fn(dp.params(), LENS_SEED))
    print(f"design step: loss {float(v):.6e}; device busy "
          f"{prof['device_busy_ms']:.2f} of {prof['profiled_render_ms']:.2f} "
          f"ms, share {prof['device_busy_share']:.4f}, "
          f"{prof['device_kernel_launches']} device kernels; top "
          f"{prof['top_kernels'][:4]}")
    return calls, launches


def doublet_phase():
    """Phase 11b: the doublet achromat at the example's full size (24x24,
    2048 light paths a pixel, spectral, 8 rings x 16 sectors), 5 Adam
    steps of V_d alone at lr 0.6 through intersect_packed; one step's
    launches held against the plain version."""
    from mitsuba_tpu_torch.examples.doublet_achromat_design import (
        build_doublet, exact_vd, make_problem)

    ls = build_doublet()
    v_exact = exact_vd(ls)
    res, spp = DOUBLET_RUN["resolution"], DOUBLET_RUN["spp"]
    dp = make_problem(ls, spp=spp, resolution=res, lr=0.6,
                      iters=DOUBLET_RUN["steps"], seed=LENS_SEED)
    faces = sum(int(m.faces.shape[0]) for m in dp.base_scene.meshes)
    print(f"doublet: {faces} faces (BVH: {dp.base_scene.accel is not None}), "
          f"{res * res * spp} light paths a render, max depth "
          f"{dp.integrator.max_depth}, exact V_d {v_exact:.4f}")
    v0 = float(dp.params()["mat_sf11_V_d"])
    frozen = {k: 0.0 for k in dp.params() if k != "mat_sf11_V_d"}
    p, rec = timed_design(dp, "doublet", lr_overrides=frozen)
    if set(rec["launches"]) != {"intersect_packed"}:
        raise AssertionError(f"doublet: launches {rec['launches']}")
    v1 = float(p["mat_sf11_V_d"])
    print(f"doublet: V_d {v0:.4f} -> {v1:.4f} (exact {v_exact:.4f})")
    if not abs(v1 - v_exact) < abs(v0 - v_exact):
        raise AssertionError("doublet: V_d did not move toward the "
                             "achromat's")
    calls, launches = recorded_design_step(dp, ["intersect_packed"])
    return step_rows("lens", "doublet step", calls, launches), rec


def triplet_phase():
    """Phase 11c: the triplet EFL design at the example's full size (32x32,
    128 light paths a pixel, three sources to 7.5 degrees), 3 steps with
    fixed_efl=50 through packet_closest_hit / packet_any_hit on a tree
    refitted at every render; one loss's launches held against the plain
    walks by phase 5's bar."""
    from mitsuba_tpu_torch.examples.triplet_efl_design import (build_triplet,
                                                               make_problem)

    ls = build_triplet()
    res, spp = TRIPLET_RUN["resolution"], TRIPLET_RUN["spp"]
    dp = make_problem(ls, spp=spp, resolution=res, sources=3,
                      iters=TRIPLET_RUN["steps"])
    faces = sum(int(m.faces.shape[0]) for m in dp.base_scene.meshes)
    print(f"triplet: {faces} faces, BVH depth {dp.base_scene.accel.depth}, "
          f"{res * res * spp} light paths a sensor, 3 sensors, max depth "
          f"{dp.integrator.max_depth}; EFL {float(ls.compute_EFL()):.6f}")
    p, rec = timed_design(dp, "triplet", fixed_efl=50.0)
    if set(rec["launches"]) != {"packet_closest_hit", "packet_any_hit"}:
        raise AssertionError(f"triplet: launches {rec['launches']}")
    require_route("triplet design", "pair")
    efl = float(dp.lens_system.compute_EFL())
    print(f"triplet: EFL after {len(dp.loss_history)} steps {efl:.6f}; "
          f"losses {dp.loss_history}")
    if not abs(efl - 50.0) < 1e-3:
        raise AssertionError(f"triplet: EFL {efl}")
    calls, launches = recorded_design_step(
        dp, ["packet_closest_hit", "packet_any_hit"])
    require_route("triplet recorded step", "pair")
    return step_rows("lens", "triplet step", calls, launches), rec


def design_device_check():
    """Phase 11d: one doublet design gradient (8x8, 16 light paths a
    pixel) on the card and on the CPU route, the CPU problem watching
    through the card's sensors: the loss within 1e-4 and each parameter's
    gradient within 1e-3, relative."""
    from mitsuba_tpu_torch.examples.doublet_achromat_design import (
        build_doublet, make_problem)
    from mitsuba_tpu_torch.lens.design import value_and_grad

    out, sensors = {}, None
    for dev in ("cuda", "cpu"):
        dp = make_problem(build_doublet(device=dev), spp=16, resolution=8)
        if sensors is not None:
            dp.sensors = [dataclasses.replace(s, to_world=s.to_world.cpu())
                          for s in sensors]
        sensors = dp.sensors
        v, g = value_and_grad(dp.loss)(dp.params(), LENS_SEED)
        require_finite(f"design gradient on {dev}", g)
        out[dev] = (float(v), {k: x.cpu() for k, x in g.items()})
    (v_card, g_card), (v_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    print(f"design step card vs CPU: loss {v_card:.6e} / {v_cpu:.6e}, rel "
          f"{rel:.3e}")
    if not rel <= 1e-4:
        raise AssertionError("design: the card's loss disagrees with the CPU")
    for k in g_cpu:
        if float(g_cpu[k].norm()) == 0.0:
            continue
        err = prb_rel_err(g_card[k], g_cpu[k])
        print(f"design gradient {k}: card vs CPU relative error {err:.3e}")
        if not err <= 1e-3:
            raise AssertionError(f"{k}: the card's design gradient "
                                 "disagrees with the CPU route")


def lens_phase():
    """Phase 11: the refit, then the lens-design path (BASELINE config 5);
    returns the [lens] kernel rows and the phase's seconds."""
    t0 = time.perf_counter()
    refit_phase()
    rows, _ = doublet_phase()
    more, _ = triplet_phase()
    design_device_check()
    return rows + more, time.perf_counter() - t0


# ------------------------------------- phase 12: the realistic-lens camera

# the film side, camera paths a pixel (Cornell, big_scene, PRB), the
# card-against-CPU gradient's film side and spp, the exit-pupil table
LENS_CAMERA_RUN = dict(size=256, spp=64, big_spp=16, prb_spp=16,
                       check_size=32, check_spp=4, segments=64, rays=1 << 16)


def through_lens(scene, design, focus=3.9, **kw):
    """``scene`` seen through make_lens_camera(design) at its sensor's pose
    and film, on its device (35 mm film diagonal, the table's size of
    LENS_CAMERA_RUN)."""
    from mitsuba_tpu_torch import make_lens_camera

    s = scene.sensor
    run = LENS_CAMERA_RUN
    cam = make_lens_camera(design, film=s.film, to_world=s.to_world,
                           diagonal=0.035, focus_distance=focus,
                           pupil_segments=run["segments"],
                           pupil_rays_per_segment=run["rays"],
                           device=scene.device, **kw)
    return dataclasses.replace(scene, sensor=cam)


def emitter_plane(size, scale=0.35, smooth=False, device=None):
    """One emitting rectangle before a black background, seen from z = 3
    (tests/test_lens.py ``_emitter_plane_scene``): radiance 5, or a smooth
    bitmap (``smooth``) so that a camera gradient is not bound by
    visibility."""
    import numpy as np
    import torch

    from mitsuba_tpu_torch.core import transform as tf
    from mitsuba_tpu_torch.device import resolve_device
    from mitsuba_tpu_torch.models.bsdfs import SmoothDiffuse
    from mitsuba_tpu_torch.models.emitters import AreaEmitter
    from mitsuba_tpu_torch.models.film import Film, ReconstructionFilter
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.models.sensors import PerspectiveCamera
    from mitsuba_tpu_torch.models.shapes import Mesh, rectangle
    from mitsuba_tpu_torch.models.textures import (BitmapTexture,
                                                   ConstantTexture)

    device = resolve_device(device)
    v, f, _, uv = rectangle(tf.scale(scale))
    panel = Mesh.make(v, f, uvs=uv, bsdf_index=0, emitter_index=0,
                      id="panel", device=device)
    if smooth:
        yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32),
                             indexing="ij")
        data = 1.0 + 4.0 * np.exp(-8.0 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2))
        radiance = BitmapTexture(data=torch.tensor(
            np.repeat(data[..., None], 3, -1), dtype=torch.float32,
            device=device))
    else:
        radiance = ConstantTexture(torch.tensor([5.0] * 3, device=device))
    sensor = PerspectiveCamera(
        to_world=torch.tensor(tf.look_at([0, 0, 3.0], [0, 0, 0], [0, 1, 0]),
                              device=device),
        film=Film(size, size, rfilter=ReconstructionFilter.box()), fov=40.0)
    white = SmoothDiffuse(reflectance=ConstantTexture(
        torch.tensor([0.5] * 3, device=device)))
    return make_scene([panel], [white], [AreaEmitter(radiance=radiance)],
                      sensor, device)


def check_upright(label, image):
    """The Cornell box's image finite, lit, and upright: the rows of the
    ceiling's light brighter than the floor's (tests/test_lens.py)."""
    import torch

    h = image.shape[0]
    top = float(image[h * 2 // 24:h * 8 // 24].mean())
    bottom = float(image[h * 16 // 24:h * 22 // 24].mean())
    print(f"{label}: image mean {float(image.mean()):.6f}, ceiling rows "
          f"{top:.6f}, floor rows {bottom:.6f}")
    if not (bool(torch.isfinite(image).all()) and top > bottom
            and float(image.mean()) > 0.02):
        raise AssertionError(f"{label}: the image is not finite, lit and "
                             "upright")


def op_counter():
    """A TorchDispatchMode that counts the PyTorch operations dispatched
    inside it, views apart: on the card, one launch or more each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    return Count()


def camera_lut_check():
    """12a: the double Gauss's exit-pupil table on the card against the CPU
    route."""
    import torch

    from mitsuba_tpu_torch import cornell_box, make_lens_camera
    from mitsuba_tpu_torch.lens import compute_exit_pupil_lut
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    run = LENS_CAMERA_RUN
    base = cornell_box(run["size"], run["size"])
    kw = dict(film=base.sensor.film, diagonal=0.035, focus_distance=3.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cam = make_lens_camera("gauss", to_world=base.sensor.to_world,
                           sample_exit_pupil=True,
                           pupil_segments=run["segments"],
                           pupil_rays_per_segment=run["rays"], **kw)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    lut_ms = wall_ms(lambda: compute_exit_pupil_lut(cam, run["segments"],
                                                    run["rays"]), 3)
    cpu = make_lens_camera("gauss", to_world=base.sensor.to_world.cpu(),
                           device="cpu", **kw)
    t0 = time.perf_counter()
    mn, mx = compute_exit_pupil_lut(cpu, run["segments"], run["rays"])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same_focus = all(torch.equal(a.z_intercept.cpu(), b.z_intercept)
                     for a, b in zip(cam.interfaces, cpu.interfaces))
    spacing = 4.0 * 1.5 * float(cam.rear_radius) * math.sqrt(
        2.0 / run["rays"])
    err = max(float((cam.pupil_min.cpu() - mn).abs().max()),
              float((cam.pupil_max.cpu() - mx).abs().max()))
    equal = float(((cam.pupil_min.cpu() == mn).float().mean()
                   + (cam.pupil_max.cpu() == mx).float().mean()) / 2)
    print(f"double Gauss: {len(cam.interfaces)} interfaces, build with its "
          f"{run['segments']} x {run['rays']} exit-pupil table "
          f"{build_ms:.2f} ms, the table alone {lut_ms:.2f} ms (median of "
          f"3), on the CPU route {cpu_ms:.1f} ms; card vs CPU table: max "
          f"|diff| {err:.3e} (spacing {spacing:.3e}), {equal:.4f} of the "
          f"bounds equal; autofocused interfaces equal: {same_focus}")
    if err > spacing or not same_focus:
        raise AssertionError("the card's exit-pupil table or focus disagrees "
                             "with the CPU route")


def camera_cornell(integ):
    """12b: BASELINE config 1 through the double Gauss (phase 2's checks),
    then through the singlet; returns the double Gauss's row."""
    import torch

    from mitsuba_tpu_torch import cornell_box, sample_rays
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    run = LENS_CAMERA_RUN
    rows = {}
    for design, kw in (("gauss", dict(sample_exit_pupil=True)),
                       ("singlet", {})):
        label = f"cornell through the {design}"

        def make(width, height, device=None):
            return through_lens(cornell_box(width, height, device=device),
                                design, **kw)

        row, image, _ = cornell_phase(integ, make, label)
        check_upright(label, image)
        scene = make(run["size"], run["size"])
        pinhole = cornell_box(run["size"], run["size"])
        w = sample_rays(scene, SEED, run["spp"])[1]
        ms, ops = {}, {}
        for name, sc in ((design, scene), ("pinhole", pinhole)):
            ms[name] = wall_ms(lambda: sample_rays(sc, SEED, run["spp"]), 5)
            with op_counter() as count:
                sample_rays(sc, SEED, run["spp"])
            ops[name] = count.ops
        print(f"{label}: sample_rays over {w.shape[0]} lanes {ms[design]:.3f}"
              f" ms, the pinhole's {ms['pinhole']:.3f} ms (median of 5); "
              f"{float((w.amax(-1) > 0).float().mean()):.4f} of the lanes "
              f"transmitted; PyTorch operations (not views) "
              f"{ops[design]}, the pinhole's {ops['pinhole']}")
        torch.cuda.empty_cache()
        rows[design] = row
    # the double Gauss's row; cornell_phase printed the singlet's numbers
    return [dict(rows["gauss"], name="megakernel_trace[camera]")]


def camera_wavefront():
    """12d: the spectral doublet through the wavefront PathIntegrator, every
    intersect_packed call of the frame held bit for bit; the chromatic
    fringing against the RGB doublet.  Returns intersect_packed[camera]."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import PathIntegrator, render
    from mitsuba_tpu_torch.utils.profile_path import record_calls, wall_ms

    run = LENS_CAMERA_RUN
    integ = PathIntegrator(max_depth=2)
    plane = emitter_plane(run["size"])
    label = (f"spectral doublet wavefront {run['size']}x{run['size']}x"
             f"{run['spp']}")
    spectral = through_lens(plane, "doublet", focus=3.0, spectral=True)
    reset_counters()
    with record_calls(scene_mod, "intersect_packed") as calls:
        img = render(spectral, integ, seed=SEED, spp=run["spp"])
        torch.cuda.synchronize()
    launches = require_launches(label, {"intersect_packed":
                                        2 * integ.max_depth})
    rows = step_rows("camera", label, {"intersect_packed": calls}, launches)
    del calls
    ms = wall_ms(lambda: render(spectral, integ, seed=SEED, spp=run["spp"]),
                 5)
    rgb = render(through_lens(plane, "doublet", focus=3.0), integ, seed=SEED,
                 spp=run["spp"])
    fringe = {k: float((im[..., 0] - im[..., 2]).abs().mean())
              for k, im in (("spectral", img), ("rgb", rgb))}
    print(f"{label}: render {ms:.3f} ms (median of 5), image mean "
          f"{float(img.mean()):.6f}; |R - B| spectral {fringe['spectral']:.6e}"
          f", RGB {fringe['rgb']:.6e}")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3
            and fringe["spectral"] > 5.0 * max(fringe["rgb"], 1e-6)):
        raise AssertionError("the spectral doublet shows no chromatic "
                             "fringing")
    return rows


def glass_b_grads(scene, integ, spp, loss_fn):
    """(loss, d loss / d(Cauchy B) summed over every glass side of the
    camera, the gradients by path, the parameters by path) through
    prb_grads."""
    from mitsuba_tpu_torch.utils.params import traverse

    params = {k: v for k, v in traverse(scene, r"^sensor\..*\.cauchy$")
              .items() if float(v[0]) > 1.01}
    loss, grads = prb_grads(scene, integ, params, loss_fn, spp)
    require_finite("Cauchy-B gradients", grads)
    return loss, sum(float(g[1]) for g in grads.values()), grads, params


def camera_prb():
    """12e: a PRB step's Cauchy-B gradient through the spectral singlet,
    held against central differences and the CPU route."""
    import torch

    from mitsuba_tpu_torch import PRBIntegrator, prb_render
    from mitsuba_tpu_torch.utils.params import traverse, update

    run = LENS_CAMERA_RUN
    integ = PRBIntegrator(max_depth=2)

    def lens_plane(size, device=None):
        return through_lens(emitter_plane(size, scale=2.0, smooth=True,
                                          device=device),
                            "singlet", focus=3.0, spectral=True)

    def loss_fn(img):
        return torch.mean(img * img)

    scene = lens_plane(run["size"])
    label = f"PRB step through the spectral singlet {run['size']}^2 x "             f"{run['prb_spp']}"
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g, grads, params = glass_b_grads(scene, integ, run["prb_spp"],
                                           loss_fn)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()
                if fn.launches}
    if set(launches) != {"intersect_packed"}:
        raise AssertionError(f"{label}: launches {launches}")
    calls = prb_recorded_step(scene, integ, params, loss_fn,
                              ["intersect_packed"])
    step_rows("camera prb", label, calls, launches)
    del calls

    eps = 2e-4
    base = traverse(scene)

    def loss_at(db):
        step = torch.tensor([0.0, db], device=scene.device)
        moved = update(scene, {k: base[k] + step for k in grads})
        return float(loss_fn(prb_render(moved, integ, SEED, run["prb_spp"],
                                        device=scene.device)))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    print(f"{label}: loss {float(loss):.6e}, first step {step_ms:.2f} ms, "
          f"launches {launches}; d loss / dB PRB {g:.6e}, central "
          f"differences {fd:.6e}, rel {abs(g - fd) / abs(fd):.3e}")
    if not abs(g - fd) < 0.15 * max(abs(fd), 1e-6):
        raise AssertionError("the Cauchy-B gradient disagrees with central "
                             "differences")

    by_dev = {}
    for dev in ("card", "cpu"):
        sc = lens_plane(run["check_size"],
                        device=scene.device if dev == "card" else "cpu")
        by_dev[dev] = glass_b_grads(sc, integ, run["check_spp"], loss_fn)[2]
    for k, want in by_dev["cpu"].items():
        err = prb_rel_err(by_dev["card"][k], want)
        print(f"{run['check_size']}^2 x {run['check_spp']} gradient {k}: "
              f"card vs CPU relative error {err:.3e}")
        if not err <= 1e-3:
            raise AssertionError(f"{k}: the card's gradient disagrees with "
                                 "the CPU route")


def camera_phase(integ):
    """Phase 12: the realistic-lens camera on every path; returns the
    [camera] kernel rows and the phase's seconds."""
    from mitsuba_tpu_torch import big_scene

    t0 = time.perf_counter()
    camera_lut_check()
    rows = camera_cornell(integ)
    bvh_rows, _, _ = bvh_phase(
        integ, lambda w, h, device=None: through_lens(
            big_scene(w, h, device=device), "gauss", sample_exit_pupil=True),
        "big_scene through the gauss")
    rows += [dict(r, name=f"{r['name']}[camera]") for r in bvh_rows]
    rows += camera_wavefront()
    camera_prb()
    return rows, time.perf_counter() - t0


# ------------------- phase 13: config 4 (camera pose, silhouettes)

POSE_RUN = dict(size=256, spp=16, target_spp=64, steps=8, lr=0.01,
                offset=(0.06, -0.04, 0.0), sppp=4096, n_sub=4, fd_h=0.01,
                check_size=32, check_spp=4)
GEOMETRY_RUN = dict(size=256, spp=16, steps=3, lr=0.01,
                    shift=(0.05, 0.0, 0.0))
QUAD_RUN = dict(size=32, spp=64, sppp=8192, n_sub=2, depth=2, h=0.04)
POSE_KEY = "sensor.to_world"


class ProjectiveTimer:
    """Host-clock ms of the pieces of ``prb_projective_render`` steps,
    each between two synchronisations: the primal walk, the L0 replay and
    the adjoint walk of PRB, the boundary term's grid warm-up and main
    passes, S's backward, the analytic silhouettes' pass, the shadow
    term's warm-up and main passes and its S backward, and LargeSteps' CG
    solves.  ``take()`` returns the
    sums since the last take."""

    KEYS = ("primal", "L0 replay", "adjoint walk", "boundary warm-up pass",
            "boundary main pass", "S backward", "analytic boundary pass",
            "shadow warm-up pass", "shadow main pass", "shadow S backward",
            "CG solves")

    def __init__(self):
        import torch

        from mitsuba_tpu_torch.models.integrators import prb, projective
        from mitsuba_tpu_torch.utils.largesteps import LargeSteps

        self.ms = {k: 0.0 for k in self.KEYS}
        self._undo = []

        def wrap(owner, name, key):
            fn = getattr(owner, name)

            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.ms[key(args, kw)] += (time.perf_counter() - t0) * 1e3
                return out

            setattr(owner, name, run)
            self._undo.append((owner, name, fn))

        wrap(projective.PathProjectiveIntegrator, "sample",
             lambda a, kw: "primal")
        wrap(prb.PRBIntegrator, "sample", lambda a, kw: "L0 replay")
        wrap(prb.PRBIntegrator, "sample_backward",
             lambda a, kw: "adjoint walk")
        wrap(projective, "_boundary_pass", lambda a, kw: (
            "boundary main pass" if a[-1] == 0 else "boundary warm-up pass"))
        wrap(projective, "_boundary_backward", lambda a, kw: "S backward")
        wrap(projective, "_contour_pass",
             lambda a, kw: "analytic boundary pass")
        wrap(projective, "_shadow_pass", lambda a, kw: (
            "shadow warm-up pass" if kw.get("collect") else
            "shadow main pass"))
        wrap(projective, "_shadow_backward", lambda a, kw: "shadow S backward")
        wrap(LargeSteps, "_cg", lambda a, kw: "CG solves")

    def take(self):
        out, self.ms = self.ms, {k: 0.0 for k in self.KEYS}
        return out

    def close(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def translated(pose0, t):
    """translate(t) @ pose0 for a (3,) tensor t, differentiable in t."""
    import torch

    move = torch.eye(4, device=pose0.device).index_put(
        (torch.arange(3, device=pose0.device),
         torch.full((3,), 3, device=pose0.device)), t)
    return move @ pose0


def projective_loop(label, steps, lr, start, render, loss_fn):
    """``steps`` Adam(lr) steps on the (3,) or (V, 3) parameter ``start``,
    the loss ``loss_fn(render(leaf))``: prints each step's loss, ms,
    split, launches and peak memory; returns (losses before each step and
    after the last, parameters before each step and after the last, the
    first step's gradient, the step record)."""
    import statistics

    import torch

    from mitsuba_tpu_torch.utils.optimizers import Adam

    opt = Adam(lr=lr)
    params = {"x": start.clone()}
    state = opt.init(params)
    timer = ProjectiveTimer()
    losses, trail, steps_ms, splits, launches, peaks = [], [], [], [], [], []
    first_grad = None
    try:
        for i in range(steps):
            reset_counters()
            timer.take()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            leaf = params["x"].detach().clone().requires_grad_()
            loss = loss_fn(render(leaf))
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trail.append(params["x"])
            params, state = opt.step(params, {"x": leaf.grad}, state)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            require_finite(f"{label} step {i}", {"x": leaf.grad})
            losses.append(float(loss.detach()))
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"{label} step {i}: loss {losses[-1]}")
            first_grad = leaf.grad if first_grad is None else first_grad
            split = timer.take()
            split["Adam"] = (t2 - t1) * 1e3
            steps_ms.append((t2 - t0) * 1e3)
            split["rest (rays, splat, delta_L, loss, sensor term)"] = (
                steps_ms[-1] - sum(split.values()))
            splits.append(split)
            launches.append({n: fn.launches for n, fn in
                             kernel_wrappers().items() if fn.launches})
            peaks.append(torch.cuda.max_memory_allocated())
            print(f"{label} step {i}: loss {losses[-1]:.6e}, "
                  f"{steps_ms[-1]:.2f} ms, launches {launches[-1]}, peak "
                  f"memory {peaks[-1] / 2**30:.3f} GiB")
        with torch.no_grad():
            losses.append(float(loss_fn(render(params["x"]))))
        trail.append(params["x"])
    finally:
        timer.close()
    split = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    step = statistics.median(steps_ms)
    print(f"{label} step median {step:.2f} ms, split (medians, ms, each "
          f"piece between synchronisations): "
          f"{ {k: round(v, 2) for k, v in split.items()} }; peak memory "
          f"{max(peaks) / 2**30:.3f} GiB; losses {losses}")
    return losses, trail, first_grad, dict(step_ms=step, split=split,
                                           launches=launches[-1],
                                           peak=max(peaks))


def pose_render(scene, edges, integ, spp, device=None):
    """t -> the image of ``scene`` from translate(t) @ its pose through
    prb_projective_render."""
    from mitsuba_tpu_torch import prb_projective_render
    from mitsuba_tpu_torch.utils.params import update

    pose0 = scene.sensor.to_world

    def render(t):
        return prb_projective_render(
            update(scene, {POSE_KEY: translated(pose0, t)}), edges, integ,
            SEED, spp, device=device or scene.device)

    return render


def pose_phase():
    """13a: BASELINE config 4's camera-pose loop on the Cornell box; returns
    the intersect_packed[projective] row."""
    import torch

    from mitsuba_tpu_torch import (PathProjectiveIntegrator, PRBIntegrator,
                                   build_silhouette_edges, cornell_box,
                                   prb_render)
    from mitsuba_tpu_torch.utils.params import update

    run = POSE_RUN
    integ = PathProjectiveIntegrator(6, 5, sppp=run["sppp"],
                                     n_sub=run["n_sub"], guiding="grid")
    scene = cornell_box(run["size"], run["size"])
    edges = build_silhouette_edges(scene)
    zero = torch.zeros(3, device=scene.device)
    target = pose_render(scene, edges, integ, run["target_spp"])(zero)
    render = pose_render(scene, edges, integ, run["spp"])

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    start = torch.tensor(run["offset"], device=scene.device)
    label = (f"config 4 pose, cornell_box({run['size']}, {run['size']}) x "
             f"{run['spp']} spp, {integ}")
    print(f"{label}: {edges.v0.shape[0]} edges; Adam(lr={run['lr']}) x "
          f"{run['steps']} on t, the pose translate(t) @ the true pose, "
          f"from t = {run['offset']}; target {run['target_spp']} spp")
    losses, trail, g0, rec = projective_loop(label, run["steps"], run["lr"],
                                             start, render, loss_fn)
    errors = [float(t.norm()) for t in trail]
    print(f"config 4 losses {losses}; pose errors |t| {errors}; final t "
          f"{trail[-1].tolist()}")
    if not (losses[-1] < losses[0] and errors[-1] < errors[0]):
        raise AssertionError("config 4: the loss or the pose error did not "
                             "fall")
    if set(rec["launches"]) != {"intersect_packed"}:
        raise AssertionError(f"config 4: launches {rec['launches']}")

    # ---- the shadow term alone on the last step's adjoint image
    from mitsuba_tpu_torch import indirect_boundary_grads

    pose = translated(scene.sensor.to_world, trail[-1])
    with torch.no_grad():
        img = render(trail[-1])
    adjoint = 2.0 * (img - target) / img.numel()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indirect_boundary_grads(update(scene, {POSE_KEY: pose}), edges, adjoint,
                            SEED, n_samples=integ.sppi,
                            params={POSE_KEY: pose})
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()
                if fn.launches}
    print(f"the shadow term alone (sppi {integ.sppi}, uniform, depth 1): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, launches {launches}")

    # ---- the pose gradient against central differences at full size
    h = run["fd_h"]
    with torch.no_grad():
        fd = torch.stack([
            (loss_fn(render(start + h * e)) - loss_fn(render(start - h * e)))
            / (2 * h) for e in torch.eye(3, device=scene.device)])
    leaf = start.clone().requires_grad_()
    loss_fn(prb_render(update(scene, {POSE_KEY: translated(
        scene.sensor.to_world, leaf)}), PRBIntegrator(6, 5), SEED, run["spp"],
        device=scene.device)).backward()
    err = prb_rel_err(g0, fd)
    print(f"pose gradient at t0: prb_projective {g0.tolist()}, central "
          f"differences (h {h}) {fd.tolist()}, rel {err:.3e}; PRB alone "
          f"{leaf.grad.tolist()}, rel {prb_rel_err(leaf.grad, fd):.3e}")
    if not err <= 0.25:
        raise AssertionError("the pose gradient disagrees with central "
                             "differences")

    # ---- the card's pose gradient against the CPU route
    w = torch.rand((run["check_size"],) * 2 + (3,),
                   generator=torch.Generator().manual_seed(SEED))
    grads = {}
    for dev in ("card", "cpu"):
        sc = cornell_box(run["check_size"], run["check_size"],
                         device=scene.device if dev == "card" else "cpu")
        t = start.detach().to(sc.device).clone().requires_grad_()
        img = pose_render(sc, build_silhouette_edges(sc), integ,
                          run["check_spp"])(t)
        torch.sum(img * w.to(sc.device)).backward()
        grads[dev] = t.grad
        require_finite(f"{dev} pose gradient", {"t": t.grad})
    err = prb_rel_err(grads["card"], grads["cpu"])
    print(f"{run['check_size']}^2 x {run['check_spp']} pose gradient: card "
          f"{grads['card'].tolist()}, CPU {grads['cpu'].tolist()}, relative "
          f"error {err:.3e}")
    if not err <= 1e-3:
        raise AssertionError("the card's pose gradient disagrees with the "
                             "CPU route")

    # ---- every intersect_packed call of one step against the plain version
    def step():
        t = trail[-1].clone().requires_grad_()
        loss_fn(render(t)).backward()

    calls, launches, _ = recorded_step(step, ["intersect_packed"])
    return step_rows("projective", "config 4 pose step", calls, launches)


def repeats(label, fn):
    """Runs ``fn()`` (-> a tensor or a dict of them) twice and reports
    whether every tensor came back bit for bit."""
    import torch

    a, b = fn(), fn()
    if isinstance(a, torch.Tensor):
        a, b = {"": a}, {"": b}
    same = all(same_bits(a[k].contiguous(), b[k].contiguous()) for k in a)
    diff = max(float((a[k] - b[k]).abs().max()) for k in a)
    print(f"13b determinism: {label}: repeats bit for bit {same}, max abs "
          f"difference {diff:.3e}")
    return same


def determinism_check(scene, key, ls, u, render, loss_fn, integ, edges):
    """13b, ROADMAP Queue 3 item 5: the geometry step's gradient computed
    twice from the same state in one process, compared bit for bit; then
    each piece of the step twice (the image, the vertex gradient, PRB's
    adjoint, the primary and the shadow boundary terms on a fixed adjoint
    image, LargeSteps' CG solve and its backward, the Laplacian product).
    Fails unless the step's gradient, the render's vertex gradient and the
    pieces made deterministic (the image, the CG solve and its backward,
    the product, PRB's adjoint, whose gathers add in a fixed order, the
    guiding grid's and the splat's scatter-adds, ops/gather.py
    index_add_rows, a fixed-point sum) repeat; the boundary terms'
    verdicts are printed."""
    import torch

    from mitsuba_tpu_torch import PathIntegrator
    from mitsuba_tpu_torch.models.integrators import prb, projective
    from mitsuba_tpu_torch.utils.params import update

    def step_grad():
        leaf = u.clone().requires_grad_()
        loss_fn(render(leaf)).backward()
        return leaf.grad

    out = {"step": repeats("the step's gradient of u", step_grad)}
    v = ls.from_differential(u).detach()
    with torch.no_grad():
        img = render(u)

    def image():
        with torch.no_grad():
            return render(u)

    out["image"] = repeats("the image", image)
    adjoint = (2.0 * (img - loss_fn.target) / img.numel()).contiguous()

    def vertex_grad():
        leaf = v.clone().requires_grad_()
        loss_fn(projective.prb_projective_render(
            update(scene, {key: leaf}), edges, integ, SEED, GEOMETRY_RUN["spp"],
            device=scene.device)).backward()
        return leaf.grad

    out["vertex gradient"] = repeats("the render's vertex gradient",
                                     vertex_grad)
    det = projective._detached(scene)
    out["PRB adjoint"] = repeats("PRB's adjoint", lambda: prb._adjoint(
        det, integ._prb(), SEED, GEOMETRY_RUN["spp"], adjoint, {key: v}))
    out["primary boundary"] = repeats(
        "the primary boundary term", lambda: projective.primary_boundary_grads(
            det, edges, PathIntegrator(integ.max_depth, integ.rr_depth),
            adjoint, SEED, n_samples=integ.sppp, n_sub=integ.n_sub,
            guiding=integ.guiding, params={key: v}))
    out["shadow boundary"] = repeats(
        "the shadow term", lambda: projective.indirect_boundary_grads(
            det, edges, adjoint, SEED, n_samples=integ.sppi,
            params={key: v}))
    out["CG solve"] = repeats("LargeSteps' CG solve",
                              lambda: ls.from_differential(u))
    gv = vertex_grad()

    def cg_backward():
        leaf = u.clone().requires_grad_()
        return torch.autograd.grad(ls.from_differential(leaf), leaf, gv)[0]

    out["CG backward"] = repeats("LargeSteps' CG backward", cg_backward)
    out["Laplacian"] = repeats("the Laplacian product (a neighbour gather)",
                               lambda: ls._laplacian_matvec(u))
    print(f"13b determinism: verdicts {out}; {ls.iterations} CG iterations "
          f"a solve")
    parted = [k for k in ("image", "CG solve", "CG backward", "Laplacian",
                          "PRB adjoint", "vertex gradient", "step")
              if not out[k]]
    if parted:
        raise AssertionError(f"13b: {', '.join(parted)} did not repeat bit "
                             "for bit")
    return out


def geometry_phase():
    """13b: the ball of big_scene moved through LargeSteps and
    prb_projective_render; returns the packet_closest_hit[projective] and
    packet_any_hit[projective] rows."""
    import torch

    from mitsuba_tpu_torch import (LargeSteps, PathProjectiveIntegrator,
                                   big_scene, build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import traverse, update

    run = GEOMETRY_RUN
    integ = PathProjectiveIntegrator(6, 5, sppp=POSE_RUN["sppp"],
                                     n_sub=POSE_RUN["n_sub"])
    scene = big_scene(run["size"], run["size"])
    key = "meshes.8.vertices"
    v_true = traverse(scene)[key]
    edges = build_silhouette_edges(scene)
    ls = LargeSteps(v_true, scene.meshes[8].faces, device=scene.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = ls.from_differential(ls.to_differential(v_true))
    torch.cuda.synchronize()
    rt_ms = (time.perf_counter() - t0) * 1e3
    rt_err = float((back - v_true).abs().max())
    print(f"LargeSteps on the ball ({v_true.shape[0]} vertices, "
          f"{ls.n_edges} edges): round trip {rt_ms:.2f} ms, "
          f"{ls.iterations} CG iterations, max abs error {rt_err:.3e}")
    if not rt_err <= 1e-3:
        raise AssertionError("LargeSteps: the round trip misses by more "
                             "than 1e-3")
    with torch.no_grad():
        target = prb_projective_render(scene, edges, integ, SEED, run["spp"])

    def render(u):
        return prb_projective_render(
            update(scene, {key: ls.from_differential(u)}), edges, integ,
            SEED, run["spp"], device=scene.device)

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    loss_fn.target = target
    shift = torch.tensor(run["shift"], device=scene.device)
    label = (f"config 4 geometry, big_scene({run['size']}, {run['size']}) "
             f"x {run['spp']} spp, the ball through LargeSteps")
    print(f"{label}: {edges.v0.shape[0]} edges; Adam(lr={run['lr']}) x "
          f"{run['steps']} on u, from the ball moved by {run['shift']}")
    losses, _, _, rec = projective_loop(
        label, run["steps"], run["lr"], ls.to_differential(v_true + shift),
        render, loss_fn)
    print(f"CG iterations of the last solve {ls.iterations}")
    if set(rec["launches"]) != {"packet_closest_hit", "packet_any_hit"}:
        raise AssertionError(f"{label}: launches {rec['launches']}")

    u = ls.to_differential(v_true + shift)

    def step():
        leaf = u.clone().requires_grad_()
        loss_fn(render(leaf)).backward()

    calls, launches, _ = recorded_step(
        step, ["packet_closest_hit", "packet_any_hit"])
    require_route("config 4 geometry step", "pair")
    rows = step_rows("projective", "config 4 geometry step", calls, launches)
    determinism_check(scene, key, ls, u, render, loss_fn, integ, edges)
    return rows


def quad_phase():
    """13c: tests/test_projective.py's acceptance case: the emissive
    quad's x-translation gradient against central differences."""
    import torch

    from mitsuba_tpu_torch import (PathProjectiveIntegrator, PRBIntegrator,
                                   build_silhouette_edges,
                                   prb_projective_render, prb_render)
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.scenes import emissive_quad

    run = QUAD_RUN
    size = run["size"]
    integ = PathProjectiveIntegrator(max_depth=run["depth"], sppp=run["sppp"],
                                     n_sub=run["n_sub"], indirect=False)
    scene = emissive_quad(size, size)
    edges = build_silhouette_edges(scene)
    w = (torch.arange(size, dtype=torch.float32, device=scene.device)
         / size)[None, :, None].expand(size, size, 3)

    def x_grad(render, *args):
        v = traverse(scene)["meshes.0.vertices"].clone().requires_grad_()
        torch.sum(render(update(scene, {"meshes.0.vertices": v}), *args, 0,
                         run["spp"], device=scene.device) * w).backward()
        return float(v.grad[:, 0].sum())

    def primal(dx):
        with torch.no_grad():
            return float(torch.sum(prb_projective_render(
                emissive_quad(size, size, dx), edges, integ, 0, run["spp"])
                * w))

    ad = x_grad(prb_projective_render, edges, integ)
    h = run["h"]
    fd = (primal(h) - primal(-h)) / (2 * h)
    ad0 = x_grad(prb_render, PRBIntegrator(max_depth=run["depth"]))
    print(f"quad x-translation gradient ({size}^2 x {run['spp']}, sppp "
          f"{run['sppp']}): prb_projective {ad:.6f}, central differences "
          f"(h {h}) {fd:.6f}, PRB alone {ad0:.6f}")
    if not (math.isfinite(ad) and abs(ad - fd) < 0.25 * abs(fd) + 0.05
            and abs(ad0) < 0.25 * abs(fd)):
        raise AssertionError("the quad's boundary gradient misses its bars")


SHADOW_RUN = dict(size=256, spp=32, sppp=4096, n_sub=2, depth=2, h=0.03,
                  panel_spp=512, panel_seeds=4, panel_h=0.05,
                  panel_n=65536, check_size=32, check_n=16384)
BLOCKER = "meshes.1.vertices"


def x_ramp(size, device):
    import torch

    return (torch.arange(size, dtype=torch.float32, device=device)
            / size)[None, :, None].expand(size, size, 3)


def blocker_fd():
    """13d, first part: the blocker's x gradient on shadow_scene against
    central differences, the shadow term uniform, octree-guided and
    projection-seeded, and without it."""
    import torch

    from mitsuba_tpu_torch import (PathProjectiveIntegrator,
                                   build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.scenes import shadow_scene

    run = SHADOW_RUN
    size = run["size"]
    scene = shadow_scene(size, size)
    edges = build_silhouette_edges(scene)
    w = x_ramp(size, scene.device)
    integ = PathProjectiveIntegrator(max_depth=run["depth"], sppp=run["sppp"],
                                     n_sub=run["n_sub"])

    def primal(bx):
        with torch.no_grad():
            return float(torch.sum(prb_projective_render(
                shadow_scene(size, size, bx=bx), edges, integ, 0,
                run["spp"]) * w))

    def x_grad(it):
        b = traverse(scene)[BLOCKER].clone().requires_grad_()
        img = prb_projective_render(update(scene, {BLOCKER: b}), edges, it,
                                    0, run["spp"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.sum(img * w).backward()
        torch.cuda.synchronize()
        return float(b.grad[:, 0].sum()), (time.perf_counter() - t0) * 1e3

    h = run["h"]
    fd = (primal(h) - primal(-h)) / (2 * h)
    ok = True
    for guiding, shadow_guide, bar in (("grid", "uniform", 0.3),
                                       ("octree", "octree", 0.35),
                                       ("projective", "projective", 0.35)):
        ad, ms = x_grad(dataclasses.replace(integ, guiding=guiding))
        good = math.isfinite(ad) and abs(ad - fd) < bar * abs(fd) + 0.05
        ok &= good
        print(f"shadow_scene({size}, {size}) x {run['spp']} spp blocker x "
              f"gradient, shadow term {shadow_guide} (guiding {guiding!r}): "
              f"{ad:.6f} against central differences (h {h}) {fd:.6f}, "
              f"rel {abs(ad - fd) / abs(fd):.4f} (bar {bar} |fd| + 0.05), "
              f"backward {ms:.2f} ms")
    ad0, _ = x_grad(dataclasses.replace(integ, indirect=False))
    print(f"without the shadow term: {ad0:.6f}")
    if not (ok and abs(ad0) < 0.3 * abs(fd)):
        raise AssertionError("the blocker's shadow gradient misses its bars")


def panel_fd():
    """13d, second part: the probe panel's shadow seen through one bounce
    (depth 2) and, through the mirror, two (depth 3), against
    common-random-number central differences."""
    import statistics

    import torch

    from mitsuba_tpu_torch import (PathIntegrator, build_silhouette_edges,
                                   indirect_boundary_grads, render)
    from mitsuba_tpu_torch.utils.params import traverse
    from mitsuba_tpu_torch.utils.scenes import probe_panel

    run = SHADOW_RUN

    def fd_crn(mirror, depth):
        h = run["panel_h"]
        fds = []
        for sd in range(run["panel_seeds"]):
            lp, lm = (float(torch.sum(render(
                probe_panel(bx=s * h, mirror=mirror),
                PathIntegrator(max_depth=depth), sd, run["panel_spp"])))
                for s in (1, -1))
            fds.append((lp - lm) / (2 * h))
        return statistics.mean(fds), statistics.pstdev(fds) / math.sqrt(
            len(fds))

    def boundary_ad(mirror, depth, seeds):
        scene = probe_panel(mirror=mirror)
        edges = build_silhouette_edges(scene)
        w = torch.ones((24, 24, 3), device=scene.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = [float(indirect_boundary_grads(
            scene, edges, w, sd, n_samples=run["panel_n"],
            indirect_depth=depth,
            params={BLOCKER: traverse(scene)[BLOCKER]})[BLOCKER][:, 0].sum())
            for sd in seeds]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(seeds)
        return statistics.mean(vals), ms

    cases = ((False, 3, 2, (0, 1, 2, 3), 0.12, 50.0, 0.05),
             (True, 4, 3, (0, 1, 2, 3, 4, 5), 0.15, 20.0, 0.08))
    for mirror, walk_depth, depth, seeds, bar, least, err_bar in cases:
        fd, fd_err = fd_crn(mirror, walk_depth)
        ad, ms = boundary_ad(mirror, depth, seeds)
        ad_less, _ = boundary_ad(mirror, depth - 1, (0, 1))
        label = "probe panel" + (" through the mirror" if mirror else "")
        print(f"{label}: FD {fd:.3f} +- {fd_err:.3f}; depth {depth} "
              f"{ad:.3f} ({len(seeds)} seeds, {ms:.2f} ms a call of "
              f"{run['panel_n']} samples), rel {abs(ad - fd) / abs(fd):.4f} "
              f"(bar {bar}); depth {depth - 1} {ad_less:.3f}")
        if not (abs(fd) > least and fd_err < err_bar * abs(fd)
                and abs(ad - fd) < bar * abs(fd)
                and abs(ad_less) < 0.05 * abs(fd)):
            raise AssertionError(f"{label}: the depth-{depth} shadow "
                                 "gradient misses its bars")


def shadow_card_check():
    """13d, last part: the card's shadow-term blocker gradient against the
    CPU route's at the same seed."""
    import torch

    from mitsuba_tpu_torch import (build_silhouette_edges,
                                   indirect_boundary_grads)
    from mitsuba_tpu_torch.utils.params import traverse
    from mitsuba_tpu_torch.utils.scenes import shadow_scene

    run = SHADOW_RUN
    size = run["check_size"]
    grads = {}
    for dev in ("card", "cpu"):
        scene = shadow_scene(size, size,
                             device=None if dev == "card" else "cpu")
        grads[dev] = indirect_boundary_grads(
            scene, build_silhouette_edges(scene), x_ramp(size, scene.device),
            SEED, n_samples=run["check_n"],
            params={BLOCKER: traverse(scene)[BLOCKER]})[BLOCKER].cpu()
    require_finite("the card's shadow gradient", {"g": grads["card"]})
    err = prb_rel_err(grads["card"], grads["cpu"])
    print(f"{size}^2 shadow-term blocker gradient ({run['check_n']} "
          f"samples): card x {grads['card'][:, 0].sum():.6f}, CPU x "
          f"{grads['cpu'][:, 0].sum():.6f}, relative error {err:.3e}")
    if not (float(grads["cpu"].norm()) > 0 and err <= 1e-3):
        raise AssertionError("the card's shadow gradient disagrees with the "
                             "CPU route")


def shadow_phase():
    """13d: the shadow-boundary term's own checks."""
    blocker_fd()
    panel_fd()
    shadow_card_check()


def projective_phase():
    """Phase 13: camera-pose, silhouette and shadow gradients (BASELINE
    config 4); returns the [projective] kernel rows and the phase's
    seconds."""
    t0 = time.perf_counter()
    rows = pose_phase()
    rows += geometry_phase()
    quad_phase()
    shadow_phase()
    return rows, time.perf_counter() - t0


# ------------------------------------ phase 14: exact analytic prims

ANALYTIC_RUN = dict(size=256, spp=64, lane_size=64, lane_spp=4, ball_spp=16,
                    big_spp=16, loop_spp=16, target_spp=64, steps=6, lr=0.01,
                    shift=(0.05, 0.0, 0.0), fd_h=0.01, check_size=32,
                    check_spp=4)
BALL_KEY = "scene_analytic.sp_center"
RADIUS_KEY = "scene_analytic.sp_radius"


def plain_route(fn):
    """``fn()`` with the scene's hit queries swapped for their plain
    versions: the plain route on the card."""
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch.ops import intersect_packed as ip
    from mitsuba_tpu_torch.ops import traverse as tv

    names = ("intersect_packed", "packet_closest_hit", "packet_any_hit")
    saved = [getattr(scene_mod, n) for n in names]
    for n, plain in zip(names, (ip.intersect_packed_plain,
                                tv.packet_closest_hit_plain,
                                tv.packet_any_hit_plain)):
        setattr(scene_mod, n, plain)
    try:
        return fn()
    finally:
        for n, fn_ in zip(names, saved):
            setattr(scene_mod, n, fn_)


def plain_route_lanes(label, make, integ):
    """``integ``'s per-lane radiance on ``make``'s scene at 64x64 x 4,
    through the kernels and through the plain route: the bar of 2a."""
    import torch

    from mitsuba_tpu_torch import sample_rays

    run = ANALYTIC_RUN
    scene = make(run["lane_size"], run["lane_size"])
    ray, _, _, lane = sample_rays(scene, SEED, run["lane_spp"])
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    got = integ.sample(scene, ray, lane, SEED, active)
    want = plain_route(lambda: integ.sample(scene, ray, lane, SEED, active))
    torch.cuda.synchronize()
    return check_lanes(f"{label} {type(integ).__name__} "
                       f"{run['lane_size']}x{run['lane_size']}x"
                       f"{run['lane_spp']} vs the plain route", got, want)


def lit_by_sphere(make):
    """``make``'s scene (the Cornell box and its kin) with the ceiling quad
    replaced by analytic_cornell's sphere lamp."""
    from mitsuba_tpu_torch import analytic_prim, build_analytic
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.utils.scenes import ANALYTIC_LAMP

    def build(width, height):
        base = make(width, height)
        lamp = analytic_prim({"type": "sphere", **ANALYTIC_LAMP}, 0, 0)
        return make_scene(base.meshes[1:], base.bsdfs, base.emitters,
                          base.sensor, base.device,
                          analytic=build_analytic([lamp], base.device))
    return build


def checked_render(label, scene, integ, spp, allowed):
    """The main path: ``render`` with the counters at 0; fails unless the
    kernels of ``allowed`` (name -> most launches) alone launched and the
    image is finite and lit.  Returns (image, render ms, median of 3)."""
    import torch

    from mitsuba_tpu_torch import render
    from mitsuba_tpu_torch.utils.profile_path import wall_ms

    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    require_launches(f"{label} {type(integ).__name__} render", allowed)
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError(f"{label}: bad {type(integ).__name__} image")
    ms = wall_ms(lambda: render(scene, integ, seed=SEED, spp=spp), 3)
    print(f"{label} {type(integ).__name__} render {tuple(image.shape)} x "
          f"{spp} spp: {ms:.3f} ms (median of 3), image mean "
          f"{float(image.mean()):.6f}")
    return image, ms


def analytic_cornell_phase():
    """14a: analytic_cornell through the wavefront PathIntegrator (#1 for
    the meshes, the analytic sweep merged after it), the megakernel's
    fallback, the exact ball against big_scene's tessellated one, and the
    analytic stages' times.  Returns the intersect_packed[analytic] row."""
    import logging

    import torch

    from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                                   analytic_cornell, analytic_prim,
                                   big_scene, build_analytic, cornell_box,
                                   render, sample_rays)
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.ops.intersect_packed import intersect_packed
    from mitsuba_tpu_torch.utils.profile_path import events_ms
    from mitsuba_tpu_torch.utils.scenes import ANALYTIC_BALL

    run = ANALYTIC_RUN
    size, spp = run["size"], run["spp"]
    integ = PathIntegrator(6, 5)
    scene = analytic_cornell(size, size)
    image, _ = checked_render("14a analytic_cornell", scene, integ, spp,
                              {"intersect_packed": 2 * integ.max_depth})
    calls, launches, _ = recorded_step(
        lambda: render(scene, integ, seed=SEED, spp=spp), ["intersect_packed"])
    rows = step_rows("analytic", "14a analytic_cornell render", calls,
                     launches)
    plain_route_lanes("14a analytic_cornell", analytic_cornell, integ)

    # the megakernel integrator falls back, logged, to the same image
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log = logging.getLogger("mitsuba_tpu_torch.models.integrators.megapath")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        mega = render(scene, MegakernelPathIntegrator(6, 5), seed=SEED,
                      spp=spp)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    print(f"14a MegakernelPathIntegrator: {seen}; image bit for bit the "
          f"PathIntegrator's {same_bits(mega, image)}")
    if not (any("analytic prims" in m for m in seen)
            and same_bits(mega, image)):
        raise AssertionError("14a: the megakernel fallback")

    # the exact ball against big_scene's tessellated one
    base = cornell_box(size, size)
    ball = make_scene(base.meshes, base.bsdfs, base.emitters, base.sensor,
                      base.device, analytic=build_analytic(
                          [analytic_prim({"type": "sphere", **ANALYTIC_BALL})],
                          base.device))
    exact = render(ball, integ, seed=SEED, spp=run["ball_spp"])
    tess = render(big_scene(size, size), integ, seed=SEED,
                  spp=run["ball_spp"])
    rel = abs(float(exact.mean()) - float(tess.mean())) / float(tess.mean())
    print(f"14a the exact ball {float(exact.mean()):.6f} against big_scene's "
          f"tessellated ball {float(tess.mean()):.6f} at {size}x{size}x"
          f"{run['ball_spp']}: image means {rel:.3e} apart (bound 1e-2)")
    if not rel <= 1e-2:
        raise AssertionError("14a: the exact and tessellated balls disagree")

    # the stages of one frame's primary rays (CUDA events, median of 5)
    ray, _, _, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    ctx = scene.trace_ctx()
    an = scene.scene_analytic
    sweep = events_ms(lambda: an.intersect(ray.o, ray.d, ray.maxt, active))
    mesh = events_ms(lambda: intersect_packed(ctx["tris_packed"], ray.o,
                                              ray.d, ray.maxt, active))
    pi = scene.ray_intersect_preliminary(ray, active, ctx)
    si_ms = events_ms(lambda: scene.compute_si(pi, ray, ctx))
    n_ana = int((pi.shape_index >= scene._analytic_base()).sum())
    print(f"14a stages over the {lane.shape[0]} primary rays ({n_ana} on "
          f"analytic prims): the analytic sweep {sweep:.4f} ms, "
          f"intersect_packed {mesh:.4f} ms, compute_si (both branches) "
          f"{si_ms:.4f} ms")
    return rows


def sphere_light_phase():
    """14b: the Cornell box lit by an analytic sphere (cone-sampled NEE)
    through the DirectIntegrator and the PathIntegrator, then big_scene
    under the same lamp through #5 / #6.  Returns their [analytic] rows."""
    from mitsuba_tpu_torch import (DirectIntegrator, PathIntegrator,
                                   analytic_cornell, big_scene, render)

    run = ANALYTIC_RUN
    size = run["size"]

    def lit(width, height):
        return analytic_cornell(width, height, sphere_light=True)

    scene = lit(size, size)
    for integ, allowed in ((DirectIntegrator(), {"intersect_packed": 3}),
                           (PathIntegrator(6, 5), {"intersect_packed": 12})):
        checked_render("14b sphere-lit analytic_cornell", scene, integ,
                       run["spp"], allowed)
        plain_route_lanes("14b sphere-lit analytic_cornell", lit, integ)
    big_lit = lit_by_sphere(big_scene)
    big = big_lit(size, size)
    integ = PathIntegrator(6, 5)
    checked_render("14b sphere-lit big_scene", big, integ, run["big_spp"],
                   {"packet_closest_hit": 6, "packet_any_hit": 6})
    calls, launches, _ = recorded_step(
        lambda: render(big, integ, seed=SEED, spp=run["big_spp"]),
        ["packet_closest_hit", "packet_any_hit"])
    require_route("14b sphere-lit big_scene render", "pair")
    rows = step_rows("analytic", "14b sphere-lit big_scene render", calls,
                     launches)
    plain_route_lanes("14b sphere-lit big_scene", big_lit, integ)
    return rows


def analytic_loop_phase():
    """14c: BASELINE config 4's loop on the analytic ball of
    analytic_cornell (the mesh ceiling light, the shadow term on): Adam on
    the ball's centre from a shift, the gradients of the centre's x and
    of the radius against central differences with and without the
    analytic silhouette term, and the card against the CPU route."""
    import torch

    from mitsuba_tpu_torch import (PathIntegrator, PathProjectiveIntegrator,
                                   analytic_boundary_grads, analytic_cornell,
                                   build_silhouette_edges,
                                   prb_projective_render)
    from mitsuba_tpu_torch.utils.params import traverse, update
    from mitsuba_tpu_torch.utils.profile_path import profile_run

    run = ANALYTIC_RUN
    integ = PathProjectiveIntegrator(6, 5, sppp=POSE_RUN["sppp"],
                                     n_sub=POSE_RUN["n_sub"], guiding="grid")
    scene = analytic_cornell(run["size"], run["size"])
    edges = build_silhouette_edges(scene)
    c_true = traverse(scene)[BALL_KEY]
    r_true = traverse(scene)[RADIUS_KEY]

    def render(c, spp=run["loop_spp"], r=r_true, sc=scene, ed=edges):
        return prb_projective_render(update(sc, {BALL_KEY: c, RADIUS_KEY: r}),
                                     ed, integ, SEED, spp, device=sc.device)

    with torch.no_grad():
        target = render(c_true, run["target_spp"])

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    start = c_true + torch.tensor(run["shift"], device=scene.device)
    label = (f"14c config 4 on the analytic ball, analytic_cornell("
             f"{run['size']}, {run['size']}) x {run['loop_spp']} spp")
    print(f"{label}: {integ}; Adam(lr={run['lr']}) x {run['steps']} on "
          f"{BALL_KEY} from the ball moved by {run['shift']}")
    t0 = time.perf_counter()
    losses, trail, g0, rec = projective_loop(label, run["steps"], run["lr"],
                                             start, render, loss_fn)
    t_loop = time.perf_counter()
    errors = [float((c - c_true).norm()) for c in trail]
    print(f"14c losses {losses}; centre errors {errors}")
    if not losses[-1] < losses[0]:
        raise AssertionError("14c: the loss did not fall")
    if set(rec["launches"]) != {"intersect_packed"}:
        raise AssertionError(f"14c: launches {rec['launches']}")

    # step 0's centre-x and radius gradients against central differences
    # (common random numbers), with and without the analytic term
    leaves = {BALL_KEY: start.clone().requires_grad_(),
              RADIUS_KEY: r_true.clone().requires_grad_()}
    img = render(leaves[BALL_KEY], r=leaves[RADIUS_KEY])
    loss_fn(img).backward()
    adjoint = (2.0 * (img.detach() - target) / img.numel()).contiguous()
    ana = analytic_boundary_grads(
        update(scene, {BALL_KEY: start}), PathIntegrator(6, 5), adjoint, SEED,
        n_samples=max(integ.sppp // 2, 512), n_sub=integ.n_sub,
        params={BALL_KEY: start, RADIUS_KEY: r_true})
    h = run["fd_h"]
    ex = torch.zeros_like(start)
    ex[0, 0] = h
    with torch.no_grad():
        fd_x = (float(loss_fn(render(start + ex)))
                - float(loss_fn(render(start - ex)))) / (2 * h)
        fd_r = (float(loss_fn(render(start, r=r_true + h)))
                - float(loss_fn(render(start, r=r_true - h)))) / (2 * h)
    got_x = float(leaves[BALL_KEY].grad[0, 0])
    got_r = float(leaves[RADIUS_KEY].grad[0])
    for name, got, fd, term in (("centre x", got_x, fd_x,
                                 float(ana[BALL_KEY][0, 0])),
                                ("radius", got_r, fd_r,
                                 float(ana[RADIUS_KEY][0]))):
        err = abs(got - fd) / abs(fd)
        print(f"14c {name} gradient at step 0: {got:.6e} with the analytic "
              f"term ({term:.6e} of it), {got - term:.6e} without; central "
              f"differences (h {h}) {fd:.6e}; rel {err:.3e} (bound 0.25), "
              f"without the term {abs(got - term - fd) / abs(fd):.3e}")
        if not err <= 0.25:
            raise AssertionError(f"14c: the {name} gradient disagrees with "
                                 "central differences")

    t_fd = time.perf_counter()
    # the card against the CPU route, fewer boundary samples: the CPU's
    # walks are slow
    w = torch.rand((run["check_size"],) * 2 + (3,),
                   generator=torch.Generator().manual_seed(SEED))
    check = PathProjectiveIntegrator(6, 5, sppp=512, n_sub=1, sppi=1024)
    grads = {}
    for dev in ("card", "cpu"):
        sc = analytic_cornell(run["check_size"], run["check_size"],
                              device=scene.device if dev == "card" else "cpu")
        lv = {k: traverse(sc)[k].clone().requires_grad_()
              for k in (BALL_KEY, RADIUS_KEY)}
        im = prb_projective_render(update(sc, lv), build_silhouette_edges(sc),
                                   check, SEED, run["check_spp"],
                                   device=sc.device)
        torch.sum(im * w.to(sc.device)).backward()
        grads[dev] = {k: v.grad for k, v in lv.items()}
        require_finite(f"14c {dev} gradients", grads[dev])
    for k in grads["card"]:
        err = prb_rel_err(grads["card"][k], grads["cpu"][k])
        print(f"14c {run['check_size']}^2 x {run['check_spp']} {k}: card "
              f"{grads['card'][k].tolist()}, CPU {grads['cpu'][k].tolist()},"
              f" relative error {err:.3e}")
        if not err <= 1e-3:
            raise AssertionError(f"14c: the card's {k} gradient disagrees "
                                 "with the CPU route")

    def step():
        leaf = trail[-1].clone().requires_grad_()
        loss_fn(render(leaf)).backward()

    t_check = time.perf_counter()
    prof = profile_run(step)
    t_prof = time.perf_counter()
    print(f"14c device busy over one step: {prof['device_busy_ms']:.2f} of "
          f"{prof['profiled_render_ms']:.2f} ms, share "
          f"{prof['device_busy_share']:.4f}, "
          f"{prof['device_kernel_launches']} device kernels; peak memory "
          f"{rec['peak'] / 2**30:.3f} GiB; launches {rec['launches']}")
    print(f"14c parts: the loop {t_loop - t0:.1f} s, the gradients against "
          f"central differences {t_fd - t_loop:.1f} s, card against CPU "
          f"{t_check - t_fd:.1f} s, the profiled step {t_prof - t_check:.1f} s")


def analytic_phase():
    """Phase 14: exact analytic spheres, disks and cylinders; returns the
    [analytic] kernel rows and the phase's seconds."""
    t0 = time.perf_counter()
    rows = analytic_cornell_phase()
    t1 = time.perf_counter()
    rows += sphere_light_phase()
    t2 = time.perf_counter()
    analytic_loop_phase()
    t3 = time.perf_counter()
    print(f"phase 14 parts: 14a {t1 - t0:.1f} s, 14b {t2 - t1:.1f} s, 14c "
          f"{t3 - t2:.1f} s")
    return rows, t3 - t0


# --------------------- phase 15: curves, SDF grids, two-level instancing

SHAPES_RUN = dict(size=256, spp=64, inst_spp=16, grid=16, small_grid=4,
                  subdiv=4, grad_size=128, grad_spp=4, instance=136)
INSTANCE_KEY = "instances.0.to_world"
SDF_KEY = "scene_sdf.values"
CURVE_KEY = "scene_analytic.cv_cp"
# the CPU route of 15d and 16d runs beside phases 1-14 on this many of the
# host's cores
CPU_ROUTE_THREADS = 2


def shape_render(label, scene, integ, spp, allowed, owners):
    """The main path once: ``render`` with every launch counter at 0 and
    the calls of each hit query recorded where ``owners`` (name ->
    module) says the path calls it, timed by the host clock; fails
    unless the kernels of ``allowed`` alone launched and the image is
    finite and lit.  Returns (image, ms, peak bytes, calls, launches)."""
    import torch

    from mitsuba_tpu_torch import render
    from mitsuba_tpu_torch.utils.profile_path import record_calls

    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ExitStack() as stack:
        calls = {n: stack.enter_context(record_calls(m, n))
                 for n, m in owners.items()}
        t0 = time.perf_counter()
        image = render(scene, integ, seed=SEED, spp=spp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = require_launches(f"{label} render", allowed)
    if not bool(torch.isfinite(image).all()) or float(image.mean()) <= 0:
        raise AssertionError(f"{label}: bad image")
    print(f"{label} render {tuple(image.shape)} x {spp} spp: {ms:.1f} ms "
          f"(hit queries recorded), peak memory {peak / 2**30:.3f} GiB, "
          f"image mean {float(image.mean()):.6f}")
    return image, ms, peak, calls, {k: v for k, v in launches.items() if v}


def close_means(label, image, ref, bound):
    rel = abs(float(image.mean()) - float(ref.mean())) / float(ref.mean())
    print(f"{label}: image means {float(image.mean()):.6f} and "
          f"{float(ref.mean()):.6f}, {rel:.3e} apart (bound {bound})")
    if not rel <= bound:
        raise AssertionError(f"{label}: the images disagree")


def curves_phase():
    """15a: curves_cornell, the curve linear and cubic, through the
    PathIntegrator: #1 alone launches, every call bit for bit against its
    plain version, the image against the tessellated twin's, peak memory.
    Returns the intersect_packed[* curve] rows."""
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import PathIntegrator, curves_cornell, render

    run = SHAPES_RUN
    size, spp, integ = run["size"], run["spp"], PathIntegrator(6, 5)
    rows = []
    for kind, tag in (("linearcurve", "linear curve"),
                      ("bsplinecurve", "cubic curve")):
        label = f"15a curves_cornell[{kind}]"
        scene = curves_cornell(size, size, kind)
        print(f"{label}: {scene.scene_analytic.n_curves} curve prims")
        image, _, _, calls, launches = shape_render(
            label, scene, integ, spp,
            {"intersect_packed": 2 * integ.max_depth},
            {"intersect_packed": scene_mod})
        rows += step_rows(tag, f"{label} render", calls, launches)
        twin = curves_cornell(size, size, kind, tessellated=True)
        close_means(f"{label} against its tessellated twin "
                    f"({sum(int(m.faces.shape[0]) for m in twin.meshes)} "
                    "faces)", image, render(twin, integ, seed=SEED, spp=spp),
                    1e-2)
    return rows


def sdf_phase():
    """15b: sdf_cornell through the PathIntegrator (#1 for the meshes, the
    sphere trace merged after it): every #1 call bit for bit, the image
    against the exact ball's, the trace's ms and launches over the primary
    rays.  Returns the intersect_packed[sdf] row."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (PathIntegrator, analytic_prim,
                                   build_analytic, cornell_box, render,
                                   sample_rays, sdf_cornell)
    from mitsuba_tpu_torch.models.scene import make_scene
    from mitsuba_tpu_torch.utils.profile_path import events_ms, profile_run
    from mitsuba_tpu_torch.utils.scenes import ANALYTIC_BALL

    run = SHAPES_RUN
    size, spp, integ = run["size"], run["spp"], PathIntegrator(6, 5)
    scene = sdf_cornell(size, size)
    image, _, _, calls, launches = shape_render(
        "15b sdf_cornell", scene, integ, spp,
        {"intersect_packed": 2 * integ.max_depth},
        {"intersect_packed": scene_mod})
    rows = step_rows("sdf", "15b sdf_cornell render", calls, launches)
    base = cornell_box(size, size)
    ball = make_scene(base.meshes, base.bsdfs, base.emitters, base.sensor,
                      base.device, analytic=build_analytic(
                          [analytic_prim({"type": "sphere", **ANALYTIC_BALL})],
                          base.device))
    close_means("15b the SDF ball against the exact ball", image,
                render(ball, integ, seed=SEED, spp=spp), 1e-2)
    ray, _, _, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    sdf = scene.scene_sdf
    ms = events_ms(lambda: sdf.ray_intersect(ray.o, ray.d, ray.maxt, active),
                   3)
    prof = profile_run(lambda: sdf.ray_intersect(ray.o, ray.d, ray.maxt,
                                                 active))
    _, hit = sdf.ray_intersect(ray.o, ray.d, ray.maxt, active)
    print(f"15b sphere trace over the {lane.shape[0]} primary rays "
          f"({float(hit.float().mean()):.4f} hit the grid's ball): {ms:.3f} "
          f"ms (CUDA events, median of 3), "
          f"{prof['device_kernel_launches']} device kernels")
    return rows


def group_twin_check(label, calls, q, outputs):
    """Each recorded group query bit for bit against the plain miss-link
    walk (``packet_*_plain``), from ``outputs``, the calls' (kernel, plain)
    outputs that step_rows held by phase 5's bar; a call whose outputs
    differ is held bit for bit against the eager twin of the walk its
    kernel takes (ops/bvh.py pair_walk), which parts from the miss-link
    walk only on ties."""
    import torch

    from mitsuba_tpu_torch.ops import bvh

    differ_twin = differ_plain = rays = 0
    for (args, kw), (got, ref) in zip(calls, outputs):
        tables, o, d, maxt, active = args
        rays += int(o.shape[0])
        if q["kind"] == "any":
            bad = int((got != ref).sum())
        else:
            bad = int(((got[0].view(torch.int32) != ref[0].view(torch.int32))
                       | (got[1] != ref[1])).sum())
        differ_plain += bad
        if not bad:
            continue
        t, slot = bvh.pair_walk(tables.bvh(), tables.leaf_geo, o, d, maxt,
                                active, any_hit=q["kind"] == "any")
        if q["kind"] == "any":
            differ_twin += int((got != torch.isfinite(t)).sum())
        else:
            face = torch.where(slot >= 0, tables.leaf_face.long()[
                slot.clamp(min=0)], -1)
            differ_twin += int(((got[0].view(torch.int32)
                                 != t.view(torch.int32))
                                | (got[1].long() != face)).sum())
    print(f"{label}: {len(calls)} calls, {rays} object-space rays; rays "
          f"that differ from the plain miss-link walk {differ_plain}, of "
          f"those from the pair walk's eager twin {differ_twin}")
    if differ_twin:
        raise AssertionError(f"{label}: the kernel differs from its twin")


def instancing_phase():
    """15c: instanced_cornell, 256 instances of a 5,120-face ball walked
    in object space by #5 / #6 (#1 for the Cornell box): every group query
    against its plain versions, the rounds, the bytes against the
    flattened twin's; then the 4 x 4 grid against its flattened twin.
    Returns the [instanced] rows."""
    import torch

    import mitsuba_tpu_torch.models.instancing as inst_mod
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (PathIntegrator, instanced_cornell, render,
                                   sample_rays)
    from mitsuba_tpu_torch.models.shapes import Mesh, instance_meshes

    run = SHAPES_RUN
    size, spp, integ = run["size"], run["inst_spp"], PathIntegrator(6, 5)
    n = run["grid"]
    scene = instanced_cornell(size, size, n, n, run["subdiv"])
    g = scene.instances[0]
    flat = instance_meshes(Mesh(vertices=g.vertices, faces=g.faces,
                                normals=g.normals, uvs=g.uvs),
                           g.to_world.cpu().numpy())
    flat_bytes = sum(t.numel() * t.element_size() for m in flat
                     for t in (m.vertices, m.faces, m.normals, m.uvs))
    print(f"15c instanced_cornell({size}, {size}, {n}, {n}, {run['subdiv']}):"
          f" {g.n_inst} instances of {int(g.faces.shape[0])} faces "
          f"({g.n_inst * int(g.faces.shape[0])} instanced triangles), the "
          f"group's tree {g.accel.depth} deep; device bytes of the group "
          f"{g.nbytes}, of its flattened twin's meshes {flat_bytes} (before "
          f"any tree)")
    del flat
    many = 100 * integ.max_depth
    owners = {"intersect_packed": scene_mod, "packet_closest_hit": inst_mod,
              "packet_any_hit": inst_mod}
    _, _, _, calls, launches = shape_render(
        "15c instanced_cornell", scene, integ, spp,
        {"intersect_packed": 2 * integ.max_depth, "packet_closest_hit": many,
         "packet_any_hit": many}, owners)
    require_route("15c instanced_cornell render", "pair")
    for q in (inst_mod.group_closest, inst_mod.group_any):
        print(f"15c candidate rounds of {q.__name__}: {q.queries} queries, "
              f"{q.rounds} rounds (mean {q.rounds / max(q.queries, 1):.2f}, "
              f"max {q.max_rounds})")
    refs = {}
    rows = step_rows("instanced", "15c instanced_cornell render", calls,
                     launches, refs)
    queries = hit_queries()
    for name in ("packet_closest_hit", "packet_any_hit"):
        group_twin_check(f"15c {name} group queries", calls[name],
                         queries[name], refs[name])

    # the 4 x 4 grid against its flattened twin
    m = run["small_grid"]
    small = instanced_cornell(size, size, m, m, run["subdiv"])
    twin = instanced_cornell(size, size, m, m, run["subdiv"], flattened=True)
    close_means(f"15c the {m} x {m} grid against its flattened twin",
                render(small, integ, seed=SEED, spp=spp),
                render(twin, integ, seed=SEED, spp=spp), 1e-2)
    ray, _, _, lane = sample_rays(small, SEED, 1)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    a = small.ray_intersect_preliminary(ray, active, small.trace_ctx())
    b = twin.ray_intersect_preliminary(ray, active, twin.trace_ctx())
    # the twin's faces: the Cornell box's, then each instance's copy
    box_faces = sum(int(x.faces.shape[0]) for x in small.meshes)
    faces = int(small.instances[0].faces.shape[0])
    on = a.inst_index >= 0
    face_a = torch.where(on, box_faces + a.inst_index * faces + a.prim_index,
                         a.prim_index)
    hit_a, hit_b = torch.isfinite(a.t), torch.isfinite(b.t)
    same = (hit_a == hit_b) & (~hit_a | ((face_a == b.prim_index) & (
        (a.t - b.t).abs() <= 1e-5 * b.t.abs())))
    frac = float(same.float().mean())
    print(f"15c primary hits of the {m} x {m} grid and its flattened twin: "
          f"{frac:.6f} of {lane.shape[0]} rays agree, "
          f"{float(on.float().mean()):.4f} on an instance")
    if frac < 0.999:
        raise AssertionError("15c: the instanced and flattened hits differ")
    return rows


def shape_gradients(device, size, spp):
    """prb_render's gradients of sum(img * seeded weights) at size^2 x spp
    with respect to one instance's translation (instanced_cornell), the
    SDF's values (sdf_cornell) and the curve's control points
    (curves_cornell, cubic), each on its own scene."""
    import torch

    from mitsuba_tpu_torch import (PRBIntegrator, curves_cornell,
                                   instanced_cornell, prb_render, sdf_cornell)
    from mitsuba_tpu_torch.utils.params import traverse, update

    run = SHAPES_RUN
    w = torch.rand((size, size, 3), generator=torch.Generator().manual_seed(
        SEED))
    out = {}

    def grad(scene, key, leaf, value):
        img = prb_render(update(scene, {key: value}), PRBIntegrator(6, 5),
                         SEED, spp, device=scene.device)
        torch.sum(img * w.to(scene.device)).backward()
        return leaf.grad

    scene = instanced_cornell(size, size, run["grid"], run["grid"],
                              run["subdiv"], device=device)
    base = traverse(scene)[INSTANCE_KEY].detach()
    k = run["instance"]
    leaf = base[k, :3, 3].clone().requires_grad_()
    M = base.clone()
    M[k, :3, 3] = leaf
    out["instance translation"] = grad(scene, INSTANCE_KEY, leaf, M)
    scene = sdf_cornell(size, size, device=device)
    leaf = traverse(scene)[SDF_KEY].clone().requires_grad_()
    out["SDF values"] = grad(scene, SDF_KEY, leaf, leaf)
    scene = curves_cornell(size, size, device=device)
    leaf = traverse(scene)[CURVE_KEY].clone().requires_grad_()
    out["curve sub-segments' control points"] = grad(scene, CURVE_KEY, leaf,
                                                     leaf)
    return {k: v.cpu() for k, v in out.items()}


def cpu_route(path):
    """The CPU route, run by CpuRoute's process on ``CPU_ROUTE_THREADS``
    threads: 15d's gradients and 16d's renders, saved to ``path``."""
    import torch

    torch.set_num_threads(CPU_ROUTE_THREADS)
    run = SHAPES_RUN
    torch.save({"shapes": shape_gradients("cpu", run["grad_size"],
                                          run["grad_spp"]),
                "delta": delta_renders("cpu", LOADED_RUN["cpu_size"],
                                       LOADED_RUN["cpu_spp"])}, path)


def shape_gradients_phase(cpu_route):
    """15d: the three gradients on the card twice (bit for bit: the
    adjoint's gathers add in a fixed order) and on the CPU route (1e-3
    relative per leaf), from ``cpu_route`` (a CpuRoute)."""
    import torch

    run = SHAPES_RUN
    size, spp = run["grad_size"], run["grad_spp"]
    t0 = time.perf_counter()
    a = shape_gradients(None, size, spp)
    t1 = time.perf_counter()
    b = shape_gradients(None, size, spp)
    cpu = cpu_route.result()["shapes"]
    t2 = time.perf_counter()
    for key in a:
        same = torch.equal(a[key], b[key])
        err = prb_rel_err(a[key], cpu[key])
        print(f"15d {key} at {size}^2 x {spp}: |grad| "
              f"{float(a[key].norm()):.4e}, card against CPU {err:.3e} "
              f"(bound 1e-3), a second card backward bit for bit {same}")
        require_finite(f"15d {key}", {key: a[key]})
        if not (same and err <= 1e-3 and float(cpu[key].norm()) > 0):
            raise AssertionError(f"15d: the {key} gradient")
    key = "curve sub-segments' control points"
    points = [curve_point_grads(g[key]) for g in (a, cpu)]
    print(f"15d the curve's own control points (the sums of their copies): "
          f"|grad| {float(points[0].norm()):.4e}, card against CPU "
          f"{prb_rel_err(*points):.3e}")
    print(f"15d parts: one card run of the three gradients {t1 - t0:.1f} s, "
          f"the second and the wait for the CPU route {t2 - t1:.1f} s")


def curve_point_grads(g):
    """The gradient with respect to a cubic curve's own control points
    from that of its prims' ``cv_cp`` (K, 4, 3): each parent segment's
    ``CURVE_SUBDIV`` prims hold copies of its 4 points, which are the curve's
    points with the ends repeated (analytic_prim's clamping).  Hits that
    tie between two prims of one parent move their gradient between
    copies, never between points."""
    import torch

    from mitsuba_tpu_torch.utils.scenes import CURVE_CP, CURVE_SUBDIV

    n_points = len(CURVE_CP)
    par = g.reshape(-1, CURVE_SUBDIV, 4, 3).sum(1)
    out = torch.zeros(n_points, 3, dtype=g.dtype, device=g.device)
    for i in range(par.shape[0]):
        for m in range(4):
            out[min(max(i + m - 1, 0), n_points - 1)] += par[i, m]
    return out


class CpuRoute:
    """The CPU route of 15d and 16d in a process of its own, the card
    hidden from it: started early (``main`` starts it before phase 1, so
    that it runs beside the earlier phases), it writes its results beside
    the native builds, which git ignores; ``result`` waits for them once;
    ``stop`` ends it."""

    def __init__(self):
        import os

        build = ROOT / "mitsuba_tpu_torch" / "_build"
        build.mkdir(exist_ok=True)
        self.path = str(build / "cpu_route.pt")
        self.out = None
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import "
                f"chip_smoke; chip_smoke.cpu_route({self.path!r})")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                     env=env)

    def result(self):
        import torch

        if self.out is None:
            if self.proc.wait() != 0:
                raise AssertionError("the CPU route's process failed")
            self.out = torch.load(self.path)
        return self.out

    def stop(self):
        import os

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.path):
            os.remove(self.path)


def shapes_phase(cpu_route):
    """Phase 15: curves, SDF grids and two-level instancing; returns their
    kernel rows and the phase's seconds.  ``cpu_route``: 15d's CpuRoute."""
    t0 = time.perf_counter()
    rows = curves_phase()
    t1 = time.perf_counter()
    rows += sdf_phase()
    t2 = time.perf_counter()
    rows += instancing_phase()
    t3 = time.perf_counter()
    shape_gradients_phase(cpu_route)
    t4 = time.perf_counter()
    print(f"phase 15 parts: 15a {t1 - t0:.1f} s, 15b {t2 - t1:.1f} s, 15c "
          f"{t3 - t2:.1f} s, 15d {t4 - t3:.1f} s")
    return rows, t4 - t0

# ------------------------------- phase 16: scene files and the command line

# the loaded scenes' film side and camera paths a pixel (Cornell, the
# delta lights), the at-scale scene's, the particle tracer's, and the
# card-against-CPU renders' (also made by the CPU route)
LOADED_RUN = dict(size=256, spp=64, big_spp=16, pt_spp=16, cpu_size=32,
                  cpu_spp=4)
IMAGE_BAR = 1e-5    # a loaded scene's image against its twin's


def projector_bitmap_path():
    """The projector's bitmap, a PNG of a seeded 24 x 32 RGB checker,
    written beside the native builds (git ignores them) by ``main`` before
    the CPU route starts, which reads the same file."""
    return ROOT / "mitsuba_tpu_torch" / "_build" / "projector.png"


def write_projector_bitmap():
    import numpy as np

    from mitsuba_tpu_torch.utils.bitmap import write_image

    r = np.random.default_rng(SEED)
    cells = r.uniform(0.05, 1.0, (3, 4, 3)).astype(np.float32)
    img = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)
    path = projector_bitmap_path()
    path.parent.mkdir(exist_ok=True)
    write_image(str(path), img)
    return path


def delta_renders(device, size, spp):
    """16d's renders of the four delta-light variants of the Cornell box
    (utils/scenes.py delta_lights_dict) through PathIntegrator(6, 5) and
    the DirectIntegrator, and of variant (i) through the particle tracer:
    {label: image on the CPU}."""
    from mitsuba_tpu_torch import (DirectIntegrator, ParticleTracerIntegrator,
                                   PathIntegrator, load_dict, render)
    from mitsuba_tpu_torch.utils.scenes import (DELTA_VARIANTS,
                                                delta_lights_dict)

    out = {}
    for v in DELTA_VARIANTS:
        scene = load_dict(delta_lights_dict(size, size, spp, v,
                                            projector_bitmap_path()),
                          device=device)
        for name, integ in (("path", PathIntegrator(6, 5)),
                            ("direct", DirectIntegrator())):
            out[f"{v} {name}"] = render(scene, integ, SEED, spp,
                                        device=scene.device).cpu()
        if v == "point_spot":
            out[f"{v} ptracer"] = render(
                scene, ParticleTracerIntegrator(6, 5), SEED, spp,
                device=scene.device).cpu()
    return out


def timed_load(label, fn):
    """``fn()`` (a scene load), its seconds printed."""
    import torch

    t0 = time.perf_counter()
    scene = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    print(f"{label}: {s:.3f} s")
    return scene, s


def max_diff(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def loaded_cornell_phase():
    """16a: load_dict(cornell_box_dict(256, 256, 64)) under its own path
    integrator (depth 8): #1 alone, every call bit for bit, the image
    within 1e-5 of cornell_box's; then MegakernelPathIntegrator(8, 5)
    through phase 2's checks.  Returns the intersect_packed[loaded] and
    megakernel_trace[loaded] rows."""
    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (MegakernelPathIntegrator, PathIntegrator,
                                   cornell_box, cornell_box_dict, load_dict,
                                   render)

    run = LOADED_RUN
    size, spp = run["size"], run["spp"]
    scene, _ = timed_load("16a load_dict(cornell_box_dict(256, 256, 64))",
                          lambda: load_dict(cornell_box_dict(size, size, spp)))
    print(f"16a the scene's own integrator: {scene.integrator}")
    image, _, _, calls, launches = shape_render(
        "16a loaded Cornell", scene, None, spp,
        {"intersect_packed": 2 * scene.integrator.max_depth},
        {"intersect_packed": scene_mod})
    rows = step_rows("loaded", "16a loaded Cornell render", calls, launches)
    ref = render(cornell_box(size, size), PathIntegrator(8, 5), seed=SEED,
                 spp=spp)
    err = max_diff(image, ref)
    print(f"16a the loaded box against cornell_box through "
          f"PathIntegrator(8, 5): max abs difference {err:.3e} (bound "
          f"{IMAGE_BAR})")
    if not err <= IMAGE_BAR:
        raise AssertionError("16a: the loaded Cornell box renders another "
                             "image")
    row, _, _ = cornell_phase(
        MegakernelPathIntegrator(8, 5),
        lambda w, h: load_dict(cornell_box_dict(w, h, spp)),
        "16a loaded Cornell", plain_reps=1)
    rows.append(dict(row, name="megakernel_trace[loaded]"))
    return rows


CLI_XML = """<?xml version="1.0"?>
<scene version="0.6.0">
  <default name="spp" value="4"/>
  <default name="res" value="64"/>
  <integrator type="path">
    <integer name="maxDepth" value="6"/>
    <integer name="rrDepth" value="5"/>
  </integrator>
  <sensor type="perspective">
    <string name="fovAxis" value="smaller"/>
    <float name="fov" value="39.3077"/>
    <float name="nearClip" value="0.001"/>
    <float name="farClip" value="100"/>
    <transform name="toWorld">
      <lookAt origin="0, 0, 3.9" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent">
      <integer name="sampleCount" value="$spp"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="$res"/>
      <integer name="height" value="$res"/>
      <rfilter type="gaussian"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white">
    <rgb name="diffuseReflectance" value="0.885809, 0.698859, 0.666422"/>
  </bsdf>
  <bsdf type="diffuse" id="green">
    <rgb name="diffuseReflectance" value="0.105421, 0.37798, 0.076425"/>
  </bsdf>
  <bsdf type="diffuse" id="red">
    <rgb name="diffuseReflectance" value="0.570068, 0.0430135, 0.0443706"/>
  </bsdf>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="0.23" y="0.19" z="0.19"/>
      <rotate x="1" angle="90"/>
      <translate x="0" y="0.99" z="0.01"/>
    </transform>
    <ref id="white"/>
    <emitter type="area">
      <rgb name="radiance" value="18.387, 13.9873, 6.75357"/>
    </emitter>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/>
      <translate y="-1"/></transform>
    <ref id="white"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="90"/>
      <translate y="1"/></transform>
    <ref id="white"/>
  </shape>
  <shape type="ply">
    <string name="filename" value="back_wall.ply"/>
    <boolean name="faceNormals" value="true"/>
    <ref id="white"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate y="1" angle="-90"/>
      <translate x="1"/></transform>
    <ref id="green"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate y="1" angle="90"/>
      <translate x="-1"/></transform>
    <ref id="red"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.3"/>
      <rotate y="1" angle="-17"/>
      <translate x="0.335" y="-0.7" z="0.38"/></transform>
    <ref id="white"/>
  </shape>
</scene>
"""


def cli_phase(workdir):
    """16b: a Cornell-box XML of version 0.6.0 (camelCase names, $spp and
    $res, <lookAt>, <ref>, a PLY back wall) rendered by ``python -m
    mitsuba_tpu_torch`` in a subprocess; its EXR bit for bit against
    ``render(load_file(...))`` here.  Returns the CLI's (load, render)
    seconds."""
    import os

    import numpy as np

    from mitsuba_tpu_torch import load_file, render
    from mitsuba_tpu_torch.models.shapes import rectangle
    from mitsuba_tpu_torch.utils.bitmap import read_image
    from mitsuba_tpu_torch.utils.mesh_io import write_ply

    v, f, _, _ = rectangle(np.asarray([[1, 0, 0, 0], [0, 1, 0, 0],
                                       [0, 0, 1, -1], [0, 0, 0, 1]],
                                      np.float32))
    write_ply(str(workdir / "back_wall.ply"), v, f)
    xml = workdir / "box.xml"
    xml.write_text(CLI_XML)
    out = workdir / "box.exr"
    size, spp = LOADED_RUN["size"], LOADED_RUN["spp"]
    cmd = [sys.executable, "-m", "mitsuba_tpu_torch", str(xml), "-o",
           str(out), "-D", f"spp={spp}", "-D", f"res={size}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env={**os.environ,
                                         "PYTHONPATH": str(ROOT)})
    wall = time.perf_counter() - t0
    print(f"16b {' '.join(cmd[1:])}: exit {proc.returncode}, {wall:.1f} s "
          f"of process\n{proc.stdout.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"16b: the command line failed: {proc.stderr}")
    secs = {}
    for line in proc.stdout.splitlines():
        for key in ("loaded in", "rendered in"):
            if key in line:
                secs[key] = float(line.split(key)[1].split("s")[0])
    want = render(load_file(str(xml), spp=spp, res=size), seed=0)
    got = read_image(str(out))
    same = np.array_equal(got, want.cpu().numpy())
    print(f"16b the EXR read back ({got.shape}) against render(load_file()) "
          f"here: bit for bit {same}; the CLI's load {secs['loaded in']} s, "
          f"render {secs['rendered in']} s")
    if not same:
        raise AssertionError("16b: the command line's image differs")
    return secs["loaded in"], secs["rendered in"]


def big_scene_files(workdir):
    """16c: big_scene()'s meshes written as files, the ball (smooth
    normals) a binary PLY, the box's meshes OBJ, and an XML naming them
    with big_scene's BSDFs, light, camera and a path integrator of depth
    6.  Returns the XML's path and the triangles written."""
    from mitsuba_tpu_torch import big_scene
    from mitsuba_tpu_torch.utils.mesh_io import write_obj, write_ply

    ref = big_scene(8, 8, device="cpu")
    bsdfs = ("white", "green", "red")
    shapes = []
    for i, m in enumerate(ref.meshes):
        v = m.vertices.numpy()
        f = m.faces.numpy()
        if m.normals is not None:
            name = f"mesh{i}.ply"
            write_ply(str(workdir / name), v, f, m.normals.numpy())
            kind = "ply"
        else:
            name = f"mesh{i}.obj"
            write_obj(str(workdir / name), v, f)
            kind = "obj"
        emitter = ("<emitter type=\"area\"><rgb name=\"radiance\" "
                   "value=\"18.387, 13.9873, 6.75357\"/></emitter>"
                   if m.emitter_index >= 0 else "")
        shapes.append(f"<shape type=\"{kind}\"><string name=\"filename\" "
                      f"value=\"{name}\"/><ref id=\"{bsdfs[m.bsdf_index]}\"/>"
                      f"{emitter}</shape>")
    colors = [b.reflectance.value.tolist() for b in ref.bsdfs]
    xml = CLI_XML.split("<bsdf")[0]
    xml += "".join(
        f"<bsdf type=\"diffuse\" id=\"{n}\"><rgb name=\"reflectance\" "
        f"value=\"{', '.join(f'{x:.9g}' for x in c)}\"/></bsdf>\n"
        for n, c in zip(bsdfs, colors))
    xml += "\n".join(shapes) + "\n</scene>\n"
    path = workdir / "big_scene.xml"
    path.write_text(xml)
    return path, sum(int(m.faces.shape[0]) for m in ref.meshes)


def loaded_big_phase(workdir):
    """16c: the at-scale scene from files: parse and BVH-build seconds;
    MegakernelPathIntegrator(6, 5) at 256x256 x 16 launches
    megakernel_bounce_bvh (each lane against the plain version, phase 3's
    bar) and its image is within 1e-5 of big_scene's; the scene's own path
    render launches #5 and #6, each call held against the plain walk by
    phase 5's bar.  Returns the [loaded] rows of #4, #5 and #6."""
    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (MegakernelPathIntegrator, big_scene,
                                   load_dict, render, sample_rays)
    from mitsuba_tpu_torch.ops.bvh import build_bvh
    from mitsuba_tpu_torch.ops.megakernel import scene_btypes
    from mitsuba_tpu_torch.ops.megakernel_bvh import (
        megakernel_bounce_bvh, megakernel_bounce_bvh_plain,
        megakernel_trace_bvh_plain, pack_scene_bvh)
    from mitsuba_tpu_torch.utils.mesh_io import load_mesh_file
    from mitsuba_tpu_torch.utils.profile_path import events_ms, record_bounces
    from mitsuba_tpu_torch.utils.xml import xml_to_dict

    run = LOADED_RUN
    size, spp = run["size"], run["big_spp"]
    path, n_tris = big_scene_files(workdir)
    t0 = time.perf_counter()
    d = xml_to_dict(str(path), {"res": str(size), "spp": str(spp)})
    xml_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for v in d.values():
        if isinstance(v, dict) and "filename" in v:
            load_mesh_file(v["filename"])
    parse_s = time.perf_counter() - t0
    scene, load_s = timed_load(f"16c load_file of {n_tris} triangles (XML, "
                               "PLY, OBJ, BVH, device copies)",
                               lambda: load_dict(d))
    v, f = (x.cpu().numpy() for x in scene.geometry()[:2])
    build_s = min(_timed(lambda: build_bvh(v, f, device=scene.device))
                  for _ in range(3))
    print(f"16c parse: the XML {xml_s * 1e3:.1f} ms, the mesh files "
          f"{parse_s:.3f} s; the host BVH build of {f.shape[0]} triangles "
          f"{build_s * 1e3:.2f} ms (best of 3); load_dict in all "
          f"{load_s:.3f} s")

    integ = MegakernelPathIntegrator(6, 5)
    reset_counters()
    image = render(scene, integ, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    launches = require_launches("16c loaded big_scene megakernel render",
                                {"megakernel_bounce_bvh": integ.max_depth})
    ref = render(big_scene(size, size), integ, seed=SEED, spp=spp)
    err = max_diff(image, ref)
    print(f"16c the loaded scene against big_scene through "
          f"MegakernelPathIntegrator(6, 5) at {size}^2 x {spp}: max abs "
          f"difference {err:.3e} (bound {IMAGE_BAR})")
    if not err <= IMAGE_BAR:
        raise AssertionError("16c: the loaded scene renders another image")
    tables = pack_scene_bvh(scene)
    depth_kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                    smooth=True, btypes=scene_btypes(scene))
    ray, _, _, lane = sample_rays(scene, SEED, spp)
    active = torch.ones(lane.shape, dtype=torch.bool, device=lane.device)
    n = int(lane.shape[0])
    counts = {}
    plain_L = megakernel_trace_bvh_plain(tables, lane, ray.o, ray.d, active,
                                         SEED, **depth_kw, counts=counts)
    sorted_L, recorded = record_bounces(integ, scene, ray, lane, SEED, active)
    err_bounce = check_lanes("megakernel_bounce_bvh[loaded] 256x256x16",
                             sorted_L, plain_L)
    bounce_ms, plain_ms = 0.0, 0.0
    for rlane, rstate, _, depth in recorded:
        bounce_ms += events_ms(
            lambda st: megakernel_bounce_bvh(tables, rlane, SEED, st, depth,
                                             **depth_kw), 5,
            setup=rstate.clone)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        megakernel_bounce_bvh_plain(tables, rlane, SEED, rstate, depth,
                                    **depth_kw)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
    ops = (counts["node_visits"] * OPS_PER_NODE_VISIT
           + (counts["closest_tests"] + counts["shadow_tests"])
           * OPS_PER_TRI_TEST)
    live = [int((rstate[15] > 0.5).sum()) for _, rstate, _, _ in recorded]
    nbytes = tables.nbytes + sum(
        4 * n + k * (4 + (STATE_BYTES - 4) + STATE_BYTES) for k in live)
    b_ms, b_by, t_ops, t_bytes = bound(ops, nbytes)
    print(f"megakernel_bounce_bvh[loaded]: {bounce_ms:.4f} ms over "
          f"{len(recorded)} launches, plain {plain_ms:.1f} ms; {ops:.4e} ops "
          f"-> {t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms; live "
          f"lanes {live}")
    rows = [{"name": "megakernel_bounce_bvh[loaded]", "route": "cuda",
             "source": "mitsuba_tpu_torch/csrc/megakernel_bvh.cu",
             "replaces": "mitsuba_tpu/ops/pallas/megakernel.py:2206",
             "launches": launches["megakernel_bounce_bvh"],
             "max_abs_err": err_bounce, "ms": bounce_ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]
    names = ("packet_closest_hit", "packet_any_hit")
    image, _, _, calls, launches = shape_render(
        "16c loaded big_scene (its own path integrator)", scene, None, spp,
        {k: scene.integrator.max_depth for k in names},
        {k: scene_mod for k in names})
    require_route("16c loaded big_scene", "pair")
    return rows + step_rows("loaded", "16c loaded big_scene render", calls,
                            launches)


def delta_phase(cpu_route):
    """16d: the four delta-light variants at 256x256 x 64 through the
    PathIntegrator(6, 5) and the DirectIntegrator (#1 alone, every call
    bit for bit), MegakernelPathIntegrator's logged fallback on (i) (the
    wavefront's image bit for bit), the particle tracer from (i)'s lights
    at 256x256 x 16, and every render at 32x32 x 4 within 1e-5 of the CPU
    route's, relative to its largest pixel.  Returns the
    intersect_packed[delta lights] row."""
    import logging

    import torch

    import mitsuba_tpu_torch.models.scene as scene_mod
    from mitsuba_tpu_torch import (DirectIntegrator, MegakernelPathIntegrator,
                                   ParticleTracerIntegrator, PathIntegrator,
                                   load_dict, render)
    from mitsuba_tpu_torch.utils.scenes import (DELTA_VARIANTS,
                                                delta_lights_dict)

    run = LOADED_RUN
    size, spp = run["size"], run["spp"]
    rows = []
    for v in DELTA_VARIANTS:
        scene = load_dict(delta_lights_dict(size, size, spp, v,
                                            projector_bitmap_path()))
        print(f"16d ({v}): emitters "
              f"{[type(e).__name__ for e in scene.emitters]}, env_index "
              f"{scene.env_index}")
        for name, integ, most in (("path", PathIntegrator(6, 5), 12),
                                  ("direct", DirectIntegrator(), 3)):
            label = f"16d {v} {name}"
            image, _, _, calls, launches = shape_render(
                label, scene, integ, spp, {"intersect_packed": most},
                {"intersect_packed": scene_mod})
            out = step_rows("delta lights", f"{label} render", calls,
                            launches)
            if v == "point_spot" and name == "path":
                rows += out
                wave = image
        if v == "point_spot":
            log = logging.getLogger(
                "mitsuba_tpu_torch.models.integrators.megapath")
            seen = []
            handler = logging.Handler()
            handler.emit = lambda rec: seen.append(rec.getMessage())
            log.addHandler(handler)
            log.setLevel(logging.INFO)
            try:
                mega = render(scene, MegakernelPathIntegrator(6, 5),
                              seed=SEED, spp=spp)
            finally:
                log.removeHandler(handler)
            print(f"16d (i) MegakernelPathIntegrator: {seen}")
            if not (seen and "falling back" in seen[0]
                    and torch.equal(mega, wave)):
                raise AssertionError("16d: the megakernel path did not fall "
                                     "back to the wavefront's image")
            shape_render("16d point_spot ptracer", scene,
                         ParticleTracerIntegrator(6, 5), run["pt_spp"],
                         {"intersect_packed": 12},
                         {"intersect_packed": scene_mod})
    cpu = cpu_route.result()["delta"]
    card = delta_renders(None, run["cpu_size"], run["cpu_spp"])
    for k in card:
        err = max_diff(card[k], cpu[k])
        top = float(cpu[k].abs().max())
        print(f"16d {k} at {run['cpu_size']}^2 x {run['cpu_spp']}: card "
              f"against the CPU route, max abs difference {err:.3e}, "
              f"{err / top:.3e} of the largest pixel {top:.4f} (bound "
              f"{IMAGE_BAR}); image mean {float(card[k].mean()):.6f}")
        if not (err <= IMAGE_BAR * top and float(cpu[k].mean()) > 0):
            raise AssertionError(f"16d: {k} on the card against the CPU")
    return rows


def loaded_phase(cpu_route):
    """Phase 16: scene files and the command line; returns the [loaded]
    and [delta lights] kernel rows and the phase's seconds."""
    import tempfile

    t0 = time.perf_counter()
    rows = loaded_cornell_phase()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(Path(tmp))
        t2 = time.perf_counter()
        rows += loaded_big_phase(Path(tmp))
    t3 = time.perf_counter()
    rows += delta_phase(cpu_route)
    t4 = time.perf_counter()
    print(f"phase 16 parts: 16a {t1 - t0:.1f} s, 16b {t2 - t1:.1f} s, 16c "
          f"{t3 - t2:.1f} s, 16d {t4 - t3:.1f} s")
    return rows, t4 - t0


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "mitsuba_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    print(gpu_line())
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_all()
    write_projector_bitmap()
    # the CPU route of phases 15d and 16d, beside phases 1-14
    cpu_route = CpuRoute()
    try:
        return run_phases(cpu_route)
    finally:
        cpu_route.stop()


def run_phases(cpu_route):
    """Phases 2-17 (``main`` has printed the card and built the kernels)."""
    import torch

    from mitsuba_tpu_torch import MegakernelPathIntegrator

    integ = MegakernelPathIntegrator(max_depth=6, rr_depth=5)
    from mitsuba_tpu_torch import big_scene, cornell_box

    kernels = [cornell_phase(integ)[0], *bvh_phase(integ)[0]]
    kernels += wavefront_phase("cornell wavefront", cornell_box, 64,
                               ["intersect_packed"])
    kernels += wavefront_phase("big_scene wavefront", big_scene, 16,
                               ["packet_closest_hit", "packet_any_hit"])
    fallback_phase()
    kernels += config2_phase(integ)
    kernels += surfaces_phase(integ)
    env_rows, env_s = envmap_phase(integ)
    kernels += env_rows
    print(f"phase 9 (environment maps): {env_s:.1f} s")
    prb_kernel_rows, prb_s = prb_phase()
    kernels += prb_kernel_rows
    print(f"phase 10 (differentiable rendering): {prb_s:.1f} s")
    lens_rows, lens_s = lens_phase()
    kernels += lens_rows
    print(f"phase 11 (refit and lens design): {lens_s:.1f} s")
    camera_rows, camera_s = camera_phase(integ)
    kernels += camera_rows
    print(f"phase 12 (the realistic-lens camera): {camera_s:.1f} s")
    projective_rows, projective_s = projective_phase()
    kernels += projective_rows
    print(f"phase 13 (camera pose, silhouettes and shadows): "
          f"{projective_s:.1f} s")
    analytic_rows, analytic_s = analytic_phase()
    kernels += analytic_rows
    print(f"phase 14 (exact analytic prims): {analytic_s:.1f} s")
    shape_rows, shape_s = shapes_phase(cpu_route)
    kernels += shape_rows
    print(f"phase 15 (curves, SDF grids, instancing): {shape_s:.1f} s")
    loaded_rows, loaded_s = loaded_phase(cpu_route)
    kernels += loaded_rows
    print(f"phase 16 (scene files, the command line, delta lights): "
          f"{loaded_s:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
