"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of mundy_tpu_torch/csrc/ and drives BASELINE configs #1
(the row-grid spheres engine, kernel K1), #2 (the dry LCP spheres line,
kernels K2 and K3), #3 (the row-engine spherocylinder suspension, kernel
K4's rods op), #4 (flexible filaments: K2 in the default engine, K4's
filaments op in the row engine) and #5 (1M-bead chromatin with
spectral-Ewald Stokes mobility: kernels K5s and K5i, K2 where the rows
broad phase is feasible), then the polydisperse lines of #1 (kernel K6
with a radius plane) and #2 (K2's radius variant), the scalar-mobility
Delassus applies (kernel K3t), the hydro modes of #2 (K2, K3, and K5s
and K5i in rpy_spectral) and the HP1 periphery modes of #5 (K5s and K5i
on the free-space padded grid) through the port's own entry points, then
every example YAML through the port's CLI (`mundy_tpu_torch.driver.main`),
the flat cell-list SpheresSim and the granular app, then the (N, K) rods
engine RodsSim (K2 in its broad phase) with its three narrow phases, then
the general row pair engine with the small-box spheres, the rows layout of
the spectral-Ewald gridding (kernels K5s-rows and K5i-rows) and the
collision layouts beside the strided one, then the multi-rank engines
(the z-slab spheres and rods engines with K6 and K4 through ShardedSim,
LCP rpy_ring with K2 and K3, `main --devices 2`), then the
density-balanced z-slab engines (settling, LCP through ShardedSim, the
granular and LCP YAMLs through `main --devices 2`, float64 against the CPU),
then the whole-chain and whole-filament block engines (the 1M chromatin
YAML through ShardedSim with K5s and K5i on every rank, config #4 and HP1
through ShardedSim, float64 against the CPU, `main --devices 2`), then LCP
rpy_ring over ranks (K2 and K3 on every rank) and the last three engines
(parallel/sharded_step.py's v1 and v2, parallel/slab_lcp.py with K3),
float64 against the CPU, rpy_ring through `main --devices 2`, then the
f32-vs-f64 drift harness (mundy_tpu_torch/driver/drift.py) with its float32
leg on the card (K2 and K3 on the LCP legs). Each group of phases prints its
seconds ("[a]-[b] took").

1. build K1-K6 with nvcc (sm_90a), one process per source, all at once;
   print each kernel's registers and spills and the card with its power
   limit;
2. K1 vs its plain PyTorch version at the 1M-sphere config #1 shape
   (float32, with the valid mask as the step passes it, max |diff| over
   valid slots <= 2e-5 max|f|); its bound from the pairs within the early
   stop's cut in x and those in contact, both counted and printed;
3. examples/spheres_10k.yaml for 200 steps through load_yaml /
   config_from_dict -> RowSpheresSim(...).run();
4. config #1 in float64 (2000 spheres, 60 steps) on the card against the
   same run on the CPU, which takes the plain versions;
5. the 1M config #1 (phi = 0.05) for 100 steps through run_block, with the
   K1 count set to 0 just before: one K1 launch per step; then
   torch.profiler over 4 more steps;
6. the 1M LCP bench protocol of bench.py:39-74: init, 3 settle blocks of 9
   steps, a 2-step block at fixed capacities that must not overflow, then a
   24-step timed window with the K2/K3 counts set to 0 just before: one K3
   launch per step, one K2 launch per broad phase; then torch.profiler over
   4 more steps;
7. K2 vs its plain version at the row shape of the window's final state:
   ids and counts exactly equal; its bound from the ordered pairs within
   the cut in x and from occupancy, beside the first design's count;
8. K3 vs its plain version at the strided shape of the window's final
   state, bit-equal, with the number of blocks whose ids are
   nondecreasing (K3's fast path), and index_add_ timed beside them as the
   library yardstick;
9. examples/lcp_spheres_100k.yaml through LCPSpheresSim(...).run(): no
   overflow, finite positions;
10. the LCP line in float64 (2000 spheres, 30 steps) on the card against
    the CPU: equal counters at every step, positions within 1e-8;
11. K4 vs its plain version at the 1M config #3 shape (float32, from
    RowRodsSim.init at 1M rods: examples/rods_100k.yaml's physics and
    volume fraction in a box 10^(1/3) larger), max |diff| within 1e-5 of
    max|force| and of max|torque|; its bound from the pairs within reach
    in x and in 3D, both counted and printed;
12. examples/rods_100k.yaml, 100 of its 1000 steps, through load_yaml /
    config_from_dict -> RowRodsSim(...).run(): no rod lost, no overflow,
    finite, unit quaternions within 1e-5;
13. config #3 in float64 (400 rods, box 24, 60 steps) on the card against
    the CPU: equal rebuilds and layout, positions and quaternions (up to
    sign) within 1e-7;
14. the 1M config #3 through run_block: 3 warm-up steps, then 200 steps
    with the K4 count set to 0 just before: one K4 launch per step; K4 vs
    its plain version once more on the final state, whose rows have moved
    since their last sort (within 1e-5 of each max); then one keyed noise
    call timed alone, and torch.profiler over 4 more steps;
15. K4's filaments op vs its plain version at the 2000 x 50 row-engine
    shape (float32, from FilamentsSim(contact_engine="rows").init, the
    reference's benchmark size): f_start and f_end max |diff| within 1e-5
    of their max; its bound from the pairs within reach in x and in 3D,
    both counted and printed;
16. examples/filaments_sperm.yaml, 100 of its 1000 steps, through load_yaml /
    config_from_dict -> FilamentsSim(...).run() (float64, the active wave,
    the cell-list neighbor matrix): no overflow, finite, unit edge
    quaternions within 1e-10;
17. config #4 in float64 (12 x 8 nodes, box 24, D = 0.05, 60 steps, skin
    rebuilds) on the card against the CPU, for both engines: equal rebuilds
    and overflow, positions within 1e-7;
18. the 2000 x 50 config #4 (box 120, D = 0.05, float32, the default
    neighbor-matrix engine, built through K2): 3 warm-up steps, then 200
    steps of run_block with the K2 count set to 0 just before: one K2
    launch per broad phase; then torch.profiler over 4 more steps;
19. the same config with contact_engine="rows": 200 steps with the K4
    filaments count set to 0 just before: one launch per step; then
    torch.profiler over 4 more steps;
20. K5s and K5i (spectral-Ewald spread and interpolation) vs their plain
    versions at the config #5 shape: float32 pieces and forces from
    ChromatinSim.init on examples/chromatin_1m_spectral.yaml (1M beads, G =
    384, P = 6, m = 8, R as init sizes it), within 1e-5 of max|grid| and of
    max|u|, K5i on the inverse FFT's planar layout as the wave apply passes
    it, and bit-equal on a second launch; index_add_ of the precomputed N
    P^3 ids and values timed beside K5s as its library yardstick, and the
    ratio of the two printed;
21. config #5 in float64 (2 x 64 beads, box 24, 16 crosslinkers,
    rpy_spectral with the density split, 24 steps, skin rebuilds) on the
    card against the CPU: equal rebuilds, overflow flags and binding states
    at every step, positions within 1e-7; then the same config twice on the
    card in float32, positions bit-equal (no atomics on the path);
22. the 1M YAML: a regrow-aware warm-up of 2 steps through run_blocks,
    then 2 steps of run_block with the K5s/K5i/K2 counts set to 0 just
    before: one K5s and one K5i launch per step, one K2 launch per rows
    broad phase, no overflow; each layer of the step timed alone; then
    torch.profiler over 1 more step;
23. K6 (masked full-stencil Hertz, the monodisperse law on a constant
    radius plane) vs its plain version and vs K1 at the 1M config #1
    shape, each within 5e-5 of max|f| (the bound of
    tests/test_pallas_row_hertz.py), and bit-equal on a second launch, with
    K6's, K1's and the plain times and the bound from the pairs within
    their contact distance in x and those in contact;
24. polydisperse config #1 at 1M (polydispersity 0.4, as
    tests/test_polydisperse.py): K6 with radii vs its plain version
    at the init shape within 5e-5 of max|f| and bit-equal on a second
    launch, timed, its bound counted as [23]'s, then 100 steps of run_block
    with the K6 count set to 0 just before: one launch per step, no lost
    sphere, no overflow; then torch.profiler over 4 more steps;
25. that config in float64 (2000 spheres, 60 steps) on the card against
    the CPU: equal rebuilds and layout, positions within 1e-7;
26. K3t vs its plain version at the strided shape of [6]'s final state
    (bit-equal; the blocks with nondecreasing ids, K3t's run-sum path,
    counted), timed by event and device time beside K3 + the row gather; the
    local-drag, band and block Delassus applies on one gamma within 1e-5 of
    max|A gamma|; then resolve_collisions from the step's warm start with
    each as apply_override: iterations, ms per iteration, max|dgamma|
    against the band solve, and K3t's launches (iterations + 1);
27. the polydisperse 1M LCP line (polydispersity 0.5) with [6]'s protocol,
    the K2 radius and K3 counts set to 0 before the 24-step window: one K2
    radius-variant launch per broad phase, one K3 launch per step; K2's
    radius variant vs its plain version at the window's final row shape,
    ids and counts exactly equal, its bound counted as [7]'s;
28. that line in float64 (2000 spheres, 30 steps) on the card against the
    CPU: equal counters at every step, positions within 1e-8;
29. the LCP line's hydro modes at examples/lcp_spheres_100k.yaml with only
    `hydro` changed, float32: rpy_neighbors for 10 steps and rpy_spectral
    for 1 (G 128, P 6, the plain real-space scan on 13^3 cells) from init,
    with the K2, K3, K5s and K5i counts set to 0 before the sim is made:
    one K2 launch per broad phase, one K3 launch (and in rpy_spectral one
    K5s and one K5i launch) per mobility apply (BBPGD iterations + 2 per
    step); ms per step on the host clock, iterations, active pairs; at the
    final state K3 bit-equal to its plain version on the next step's active
    subset, and in rpy_spectral K5s and K5i within 1e-5 of max of theirs on
    the final binning; one mobility apply timed by CUDA events, in
    rpy_spectral split into the real space and the wave part;
30. the three modes (rpy_neighbors, rpy_ewald, rpy_spectral) in float64 at
    the reference test's size (150 spheres, box 14, dt 2e-3, D 0.02, 10
    steps) on the card against the CPU: equal counters at every step, a
    skin rebuild, positions within 1e-7;
31. the Ewald direct wave sum (2000 bodies in box 14, the rpy_ewald
    splitting) in float32 against float64 on the card, within 1e-5 of
    max|u| (full float32 products; TF32 would leave ~2e-3);
32. examples/hp1_chromatin.yaml as written (rpy_periphery: 7 x 405 beads,
    512 crosslinkers, periphery radius 25, order 12, float32), 100 of its
    1000 steps through run(), with the K5s/K5i counts set to 0 before the sim
    is made (no launch in this mode): init time with M^-1, ms/step on the
    host clock, doubly bound crosslinkers; no overflow, finite, every bead
    within the periphery radius + its own; one mobility apply at the final
    state by CUDA events, split into the dense RPY, the flow at the Q = 338
    nodes and the BIE correction; then torch.profiler over 4 more steps;
33. the same YAML with `hydro: rpy_periphery_spectral`: the free-space
    operator's host build (seconds, and the peak of numpy's host
    allocations by tracemalloc), G, P, m and the tile R; 2 warm-up steps
    through run_blocks, then 100 steps of run_block with the K5s/K5i counts
    set to 0 just before: one launch of each per step, no overflow; then
    torch.profiler over 4 more steps; one mobility apply split into the
    real space, the wave part and the BIE;
    K5s within 1e-5 of max|grid| of its plain version on the final
    binning (at P = 10, m = 12, slots below 0 counted), K5i within 1e-6
    of the magnitude of each bead's own summands, h^3 sum|w v| (the
    deconvolved free-space grid cancels ~1000-fold in the interpolation,
    so a float32 sum in another order is off max|u| by ~3e-5), and K5i
    no farther (x 1.25) than the plain version from the float64
    interpolation of the same grid; both kernels in float64 within 1e-12
    of max; timed beside index_add_ with their bounds; the warm-up
    regrows nothing (init sizes the capacities); the velocity within 2e-3 of
    max|u| of [32]'s dense operator at the same state and forces (the
    reference's bound, tests/test_app_chromatin.py:228-250);
34. both periphery modes in float64 at the reference test's size (2 x 48
    beads, 16 crosslinkers, periphery radius 8, order 8, D 0.002, skin
    0.03, 12 steps) on the card against the CPU: equal rebuilds (more than
    one), overflow and binding states at every step, positions within
    1e-7;
35. every examples/*.yaml through mundy_tpu_torch.driver.main.main([...,
    "--device", "cuda"]) in this process: spheres_10k for 500 of its 1000 steps and
    granular_settling for 500 of its 5000 steps, with --output-dir
    (trajectory frames every 100 and 250 steps, counted, and final.vtk
    checked), lcp_spheres_100k for 20 steps,
    rods_100k for 100, filaments_sperm for 100, hp1_chromatin for 100 and
    chromatin_1m_spectral for 1; each returns 0 and prints its ms/step; the
    K2/K3/K4/K5s/K5i counts are set to 0 before each run and printed after
    it, and must be non-zero on the paths that run them (K2 and K3 on the
    LCP YAML, K4 on rods, K2, K5s and K5i on the 1M chromatin YAML); the
    native IO library must have built;
36. the flat SpheresSim (the engine `app: spheres` runs) at 1M with config
    #1's physics (bench.py:87-105) through run_block: 3 warm-up steps, then
    100 steps, ms/step beside [5]'s row engine, rebuilds, no overflow; then
    torch.profiler over 4 more steps;
37. float64 on the card against the CPU: the flat SpheresSim (2000
    spheres, 60 steps, monodisperse and polydispersity 0.4) and the
    granular app (500 spheres settling from a layer 0.6 < z < 8, 300
    steps): equal rebuild counts, positions within 1e-7;
38. checkpoint continuation through the CLI: spheres_10k and
    granular_settling (float32) for 200 steps straight (checkpoints every
    100) twice, and for 100 steps then --continue for 100: the final
    checkpoints bit-equal (the resumed run and the repeated one);
39. examples/rods_100k.yaml through the CLI with engine=nmat for 100 steps
    (RodsSim, the spherocylinder narrow phase on the (N, K) neighbor
    matrix, built through K2 at K 32), the K2 count set to 0 just before:
    one launch per neighbor build (init's and each rebuild's), rebuilds
    read from the final checkpoint; on the final state K2 torch.equal to
    its plain version at the path's row shape, timed beside it with its
    bound, and each rod's neighbor set equal to the cell-list builder's;
40. the same YAML with friction=true (the CLI's route to RodsSim) for 100
    steps: ms/step, K2 launches and the largest tangential history;
41. the ellipsoid narrow phase at benchmarks/ellipsoid_bench.py's shape
    (20,000 rods, length 1.5, radius 0.25, box 81.4, K 32, PGD 24, L-BFGS
    8, warm PGD 6): the cold and the warm narrow phase by CUDA events over
    8 calls each, in ms and ns per candidate pair (N x K), then 10 app
    steps of run_block on the host clock; torch.profiler over 2 warm steps
    ([39] over 4 steps of its sim between rebuilds);
42. the three narrow phases in float64 (300 rods, box 14, K 16, both
    noises, 12 steps from a rebuild; the ellipsoid at length 0.5, where
    the reference's descent contracts) on the card against the CPU: equal
    rebuild counts and neighbor ids, positions and quaternions within the
    bound printed beside each;
43. pair_accumulate (the small-box fallback's Hertz pair_fn, through
    RowSpheresSim._small_box_forces) on config #1's 1M rows (152, 152, 88)
    against K1, 2e-5 of max|f|, with its time, y-chunk count and peak
    allocation; RowSpheresSim at ny = nz = 4 in float64 (100 spheres, box
    5.5) for 60 steps on the card against the CPU, 1e-7;
44. the rows layout of the spectral-Ewald gridding at config #5's grid
    (1,048,576 uniform beads in the YAML's 152 box, its operator: G 384,
    P 6, ES; m 8, 48 x 48 rows of R 664): K5s-rows and K5i-rows against
    their plain versions (1e-5 of the max) and a second launch (bit-equal),
    the rows grid against the tile K5s grid and se_wave_apply_rows against
    the tile wave apply (1e-5 of the max), the rows wave apply driven with
    the two counts set to 0 just before (one launch each), the K5s-rows
    grid and the K5i-rows u on its planar copy bit for bit their first
    design's (SE_ROWS_SHA), CUDA-event times beside their plain versions,
    index_add_ of the same spread terms, the tile K5s and K5i at the same
    beads and the first design's times (SE_ROWS_FIRST), one call each of
    se_spread_dense and se_interp_dense at this shape with its peak
    allocation (a yardstick on no path); float64 at 3000 beads on the
    card against the CPU (the kernels and se_spread_dense 1e-10, the wave
    apply through the float32 forward FFT 1e-5; the dense trio twice on the
    card bit-equal);
45. the collision layouts at [6]'s final 1M LCP state: collision_forces in
    the windowed (active_pair_subset, K3 on the gathered windows), j_perm
    and unordered layouts against the strided K3 result, 1e-6 of max|F|,
    two runs of each bit-equal; active_pair_subset selecting the same pairs
    as active_pair_subset_strided;
46. the z-slab spheres engine (parallel/slab_rows.py, K6 on each rank's
    halo-extended block) through ShardedSim around RowSpheresSim at 1M
    (config #1), at d = 1 on a one-rank NCCL group in this process and at
    d = 2 on gloo, two spawned ranks on this card (CUDA tensors staged
    through pinned host buffers): 30 steps from init against the
    single-device RowSpheresSim on the slab grid (2e-4, the reference's
    bound, tests/test_parallel.py:205), then 3 warm-up and 50 timed steps
    with K6's count and the group's byte and staging counters set to 0
    just before: ms/step per rank, one K6 launch per rank a step, rebuilds
    and their mode, bytes moved and staging ms a step; K6 on the
    halo-extended block of the final state against its plain version on
    the own slots (5e-5 of max|f|);
47. the same for the z-slab rods engine (parallel/slab_segments.py, K4's
    rods op) around RowRodsSim at 1M rods (config #3's physics at its
    volume fraction), quaternions up to sign; K4 within 1e-5 of each max;
48. both slab engines in float64 at d = 2 (600 spheres in box 16, 400 rods
    in box 24) on the card against the same two ranks on the CPU: equal
    rows and rebuild counts, positions and quaternions within 1e-8;
49. LCP rpy_ring on one rank: 4096 spheres at lcp_bench_config's volume
    fraction for 5 steps (float32), with the K2 and K3 counts set to 0
    before the sim is made (one K3 launch per mobility apply, K2 on each
    broad phase), one ring apply by CUDA events; 300 spheres in float64
    on the card against the CPU, equal counters at every step, 1e-8;
50. `python -m mundy_tpu_torch.driver.main examples/spheres_10k.yaml
    --devices 2` (200 steps) and `rods_100k.yaml --devices 2` (20 steps)
    as subprocesses on this card, at the end with the other CLI phases
    ([53], [59], [64]), all at once: exit 0, the plan line, one
    "stepped" line (rank 0 prints), the final VTK and the checkpoint
    written;
51. the density-balanced z-slab settling engine (parallel/balanced_slab.py)
    at 100,000 spheres from the reference test's clustered start (its box
    (10, 10, 24) scaled to the same number density), d = 2 on gloo, two
    spawned ranks on this card (CUDA tensors staged through pinned host
    buffers; a functional number, not scaling): own counts and bounds
    before and after 15 steps, ms/step, bytes moved and staging per rank,
    no overflow, no body lost; the uniform split's init on the same start
    overflows its own buffer;
52. the balanced LCP engine (parallel/balanced_lcp.py) through
    ShardedSim("lcp_spheres") at config #2's 1M spheres (bench.py's
    protocol config), in the same process group: 2 steps from init, then 4
    steps with the group's counters and peak allocation reset: ms/step,
    BBPGD iterations per step (equal on both ranks), bytes moved, staging
    and peak allocation per rank, no overflow, max overlap <= 1e-3;
53. `python -m mundy_tpu_torch.driver.main examples/lcp_spheres_100k.yaml
    --devices 2` (20 steps) and `granular_settling.yaml --devices 2` (200
    steps) as subprocesses on this card, with [50]'s at the end: exit 0, the plan
    line, the decomposition line and one "stepped" line once each, the
    final VTK and the checkpoint written by rank 0 alone;
54. the three balanced engines in float64 at d = 2 (1024 settling spheres,
    1024 clustered LCP spheres with D 0.05, 300 granular spheres) on the
    card against the same two ranks on the CPU: equal rebuild counts and
    BBPGD iterations at every step, positions (and granular velocities)
    within the bounds printed. These paths launch no hand kernel.
55. examples/chromatin_1m_spectral.yaml as written (2048 x 512 beads,
    65,536 crosslinkers, G 384) through ShardedSim("chromatin") at d = 2,
    two gloo ranks on this card (CUDA tensors staged through pinned host
    buffers; a functional number, not scaling): 1 step from init, then 1
    step with the K5s/K5i counts and the group's counters set to 0 just
    before: ms/step, one K5s and one K5i launch a step on each rank, bytes
    moved a step with the grid all_reduce's share, staging, peak
    allocation; on rank 0 K5s and K5i against their plain versions at its
    own binning (1e-5 of max) and timed beside [20]'s; the single-device
    ChromatinSim over the same blocks from the same state within 1e-4 with
    equal crosslinker states; no overflow, no bead dropped by the binning;
56. config #4 (2000 x 50, box 120, float32) through ShardedSim("filaments")
    at d = 1 on NCCL in this process (100 steps after 3) and at d = 2 on
    gloo (50 steps after 3): ms/step, rebuilds, bytes moved; FilamentsSim
    on the nmat engine over the same blocks within 1e-4;
57. examples/hp1_chromatin.yaml as written (rpy_periphery) through
    ShardedSim("chromatin") at d = 1 on NCCL, 50 steps against
    ChromatinSim's 50 within 1e-5 and equal crosslinker states, no TF32
    in the M^-1 slab product, every bead inside the periphery;
58. float64 at d = 2, card against CPU: the chromatin route with none,
    rpy_spectral and rpy_periphery at the reference tests' sizes,
    ChromatinSim(mesh=) with rpy_spectral, the filaments route: positions
    within 1e-8 (the keyed noise's float32 normals, as at [54]), equal
    rebuild counts and binding states;
59. `--devices 2` through the CLI as subprocesses, with [50]'s at the end:
    filaments_sperm.yaml (100 steps) and chromatin_1m_spectral.yaml with 64
    chains, 2048 crosslinkers and 1 step each exit 0 with the plan,
    decomposition and "stepped" lines once and the checkpoint;
    hp1_chromatin.yaml (7 chains) exits non-zero naming the num_chains %
    ranks rule before any rank starts;
60. LCP rpy_ring over ranks (LCPSpheresSim(group=): every rank the whole
    state, the mobility through the ring in blocks of N / d, one
    all_gather an apply) at 16,384 spheres of lcp_bench_config's volume
    fraction, float32, d = 2 on gloo (two spawned ranks on this card, CUDA
    tensors staged through pinned host buffers; a functional number, not
    scaling), then d = 1 in this process: the K2 and K3 counts set to 0
    before the sim is made, 1 step from init, then 3 timed steps with the
    group's counters set to 0 just before: ms/step and BBPGD iterations
    per step on each rank (equal on both ranks), bytes moved and staging a
    step, K2 launches (broad phases) and K3 launches (= mobility applies,
    iterations + 2 a step), one ring apply by CUDA events; on rank 0 K3 at
    the strided windows of the final state and K2 at its rows bit-equal to
    their plain versions; 300 spheres in float64 at d = 2 on the card
    against one CPU rank: counters equal at every step, positions within
    1e-8;
61. parallel.sharded_step's v1 (all_gather halo) and v2 (x-slab halo and
    migration) at 1,048,576 spheres with config #1's physics, float32, at
    d = 2 in the same group: 5 steps after 1, ms/step, bytes moved (v1's
    position all_gather), staging; finite, v2's flags 0 and every gid
    owned by exactly one slot;
62. parallel.slab_lcp at config #2's 1M protocol config, float32, d = 2:
    a 1-step block from init, then a 4-step block: ms/step, BBPGD
    iterations per step (equal on both ranks), the rebuild mode, K3
    launches a rank (= iterations + 2 a step), bytes moved, staging; on
    rank 0 K3 at the final pair list's windows bit-equal to its plain
    version; no overflow, every sphere valid once;
63. float64 at d = 2, card against CPU: v2 at 800 spheres (the reference
    test's config) and slab_lcp at 512 spheres with D 0.05 in both rebuild
    modes: gid and valid equal, positions within 1e-8, equal iterations
    and rebuilds;
64. `python -m mundy_tpu_torch.driver.main examples/lcp_spheres_100k.yaml
    --devices 2 --set hydro=rpy_ring num_spheres=4096 box_size=31.0
    num_steps=10` as a subprocess, with [50]'s at the end: exit 0, the
    plan and rpy_ring lines and
    one "stepped" line once each, rank 0's final VTK and checkpoint.
    `python3 chip_smoke.py --only-sharded` builds the kernels and runs
    [46]-[64] alone.
65. the f32-vs-f64 drift harness (mundy_tpu_torch/driver/drift.py,
    benchmarks/drift_f32.py's counterpart) with its float32 leg on the
    card: spheres and LCP at 2000 spheres for 100 steps with the float64
    leg on the CPU, and LCP at 1,048,576 spheres for 20 steps with the
    float64 leg on the card in float64 (DRIFT_RUNS): each run's JSON, the
    bars of tests/test_drift.py (per-step drift < 1e-4, in float32 ulps of
    the box: 8e-4 at 1M; spheres divergence at step 20 < 3e-2; both legs'
    max overlap < 5e-4 at the run's end), and the K2 and K3
    launches of the float32 LCP legs (> 0; counts set to 0 just before,
    each launch put down to the leg that made it).
    `python3 chip_smoke.py --only-drift` builds the kernels and runs [65]
    alone.

Kernel times are medians of CUDA-event timings after a synchronize, kernel
and plain version alternating; for K2, K3 and K3t the device time per
launch of 20 launches queued back to back is printed beside them. Prints
one JSON line of kernel results (K5s-rows and K5i-rows, the rows-contract
ports, beside the tile-contract K5s and K5i; K2's, K3's, K5s's and K5i's entries also
carry their launches on [29]'s paths, and K5s's and K5i's on [33]'s,
under "path_launches", and K2's, K3's, K4's, K5s's and K5i's those of each
YAML through the CLI at [35], as "cli <yaml>"; K2's launches add those of
[39] and [40], and its entry carries its times at [39]'s shape under
"rods_nmat"; K6's, K4's, K2's and K3's carry their launches on [46]-[49]'s
slab and rpy_ring paths, and K2's and K3's those on [60]'s and [62]'s
and on [65]'s float32 LCP legs, under "path_launches"),
then a final JSON line {"ok": true, "device": {...}}. Exits non-zero, with no
result, without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_BIG = 1_000_000
BIG_STEPS = 100
RODS_STEPS = 200
KERNELS = ("row_central", "row_extract", "seg_onehot", "row_segments", "se_grid",
           "row_hertz")
# FP32 operations that K4's function needs, counted from the algorithm, not
# from the kernel (each + - * / min max rint sqrt rsqrt as one; compares and
# selects not counted; a negation that a subtraction or a swapped cross
# product absorbs not counted). Per rod, once: u = 2e (3), a = |u|^2 (5),
# 1 / max(a, eps) (2); the rods op's |e| for the reach (2 more, 0.00003 ms
# at 1M) is left out. Per unordered pair within reach in x (the reach test,
# what a pair out of reach needs): separation and x minimum image 7, s^2 5,
# reach (|e_i| + |e_j|) + 2r 2, its square and margin 2. Per unordered pair
# within reach in 3D (a pair that may touch), both sides' outputs:
# separation and x minimum image 7 (shared with the reach test, counted
# there too), w = (e_j - e_i) - sep 6, b = u.v, d = u.w, e = v.w 15, det
# and the two numerators 9, the clamped solve 15 (e + b, -d, b - d, four
# clips, two guarded divisions), the four endpoint candidates 12, the five
# quadratics 41 (w2 5, 2b 2d 2e 3, the general one 11 in Horner form, its 0
# and 1 operands folded in the others: q(0,t) 4, q(s,0) 4, q(1,t) 7,
# q(s,1) 7), closest vector, d2 and noise floor 20, the own side's Hertz
# push, arm, torque and sums 39, the partner's arm (reusing radius D /
# dist), torque and sums 23
K4_OPS = 187.0
K4_REACH_OPS = 16.0
K4_ROD_OPS = 10.0
# K4's filaments op, per unordered pair within reach in 3D (the reach test
# and the per-segment work as the rods op's): the same closest points (125
# of the 187), then the own
# side's Hertz push (d2 clamp, rsqrt, dist, dist - 2r, clamp, coef delta,
# sqrt, product, mag / dist: 9), force 3, 1 - s 1, the node split 6 and
# sums 6, and the partner's split by 1 - t (1 + 6 + 6) with the force
# reused; the adjacency test is integer work, not counted
K4F_OPS = 163.0
# FP32 operations of the Hertzian row kernels, counted from the algorithm,
# each unordered pair once with both sides' sums. A pair needs its
# separation and r2 to be rejected; the others are out of contact on x
# alone and need nothing. K1 takes the minimum image on x only (difference,
# x 1/L, rint, x L, subtract: 5) and two differences on the pre-shifted
# rows, r2 5: 12 per occupied pair within its early stop's cut in x. K6
# takes three minimum images 15 and r2 5 (K6_PAIR_OPS); an occupied pair
# within its own contact distance in x pays K1's 12 (K6_REACH_OPS) and,
# with radii, ro + rc and its square 2 more, a pair in contact the other 8.
# The contact test is a compare, not counted. A pair in contact then needs
# the clamp, rsqrt and d 3, delta 2, w = coef delta sqrt(delta) / d 4 and
# both sums as 6 FMAs 12; with radii also ro rc, the clamp, the division,
# sqrt and its product with coef 5.
K1_PAIR_OPS = 12.0
K1_CONTACT_OPS = 21.0
K6_PAIR_OPS = 20.0
K6_REACH_OPS = 12.0
K6_CONTACT_OPS = K6_PAIR_OPS - K6_REACH_OPS + 21.0
K6_RADII_REACH_OPS = K6_REACH_OPS + 2.0
K6_RADII_CONTACT_OPS = K6_CONTACT_OPS + 5.0
FIL_STEPS = 200
# [12], [16] and [32]: steps of the YAMLs run as written otherwise (1000 each)
YAML_STEPS = 100
CHROM_STEPS = 2
CHROM_SMALL_STEPS = 24
HYDRO_STEPS = 10
SPECTRAL_STEPS = 1
HYDRO_SMALL_STEPS = 10
HP1_SPECTRAL_STEPS = 100
PERIPHERY_SMALL_STEPS = 12
# the YAMLs [35] runs through the CLI: (file, --set overrides, --output-every
# or None, the kernels its path launches)
CLI_RUNS = (
    ("spheres_10k", ("num_steps=500",), 100, ()),
    ("granular_settling", ("num_steps=500",), 250, ()),
    ("lcp_spheres_100k", ("num_steps=20",), None, ("K2", "K3")),
    ("rods_100k", ("num_steps=100",), None, ("K4",)),
    ("filaments_sperm", ("num_steps=100",), None, ()),
    ("hp1_chromatin", ("num_steps=100",), None, ()),
    ("chromatin_1m_spectral", ("num_steps=1",), None, ("K2", "K5s", "K5i")),
)
FLAT_STEPS = 100
RESUME_STEPS = 200
RODS_NMAT_STEPS = 100
ELLIPSOID_RODS = 20_000
ELLIPSOID_STEPS = 10
RODS_F64_STEPS = 12
SMALL_BOX_STEPS = 60
SE_ROWS_BEADS = 1 << 20
# [44]: the first design's digests of the K5s-rows grid and the K5i-rows u
# on its planar copy, and its times (NVIDIA H100 80GB HBM3, 700.00 W)
SE_ROWS_SHA = ("8d2af69b506c6fc2", "fd1ccce136dee4ef")
SE_ROWS_FIRST = ("K5s-rows 8.1265 ms (8.1265-8.2471), K5i-rows 2.3897 ms (2.3877-2.3926), "
                 "the rows wave apply 24.117-24.195 ms")
# [46]-[50]: the multi-rank slice
SLAB_PARITY_STEPS = 30
SLAB_STEPS = 50
F64_SPHERE_STEPS = 60
F64_ROD_STEPS = 30
RING_STEPS = 5
# [51]-[54]: the density-balanced z-slab engines (parallel/balanced_*.py,
# granular_shard.py) at d = 2
SETTLE_N = 100_000
SETTLE_STEPS = 15
LCP_SHARD_WARM = 2
LCP_SHARD_STEPS = 4
F64_SETTLE_STEPS = 40
F64_LCP_STEPS = 10
F64_GRANULAR_STEPS = 100
# [55]-[59]: the whole-chain and whole-filament block engines
# (parallel/chromatin_shard.py, spectral_shard.py, filaments_shard.py)
CHROM_SHARD_WARM = 1
CHROM_SHARD_STEPS = 1
CHROM_SHARD_BAR = 1e-4  # float32 positions up to |x| 152 (ulp 1.5e-5), 4 steps
FIL_SHARD_STEPS = 100
FIL_SHARD_STEPS_2 = 50
FIL_SHARD_BAR = 1e-4  # the reference's bar (tests/test_filaments_shard.py)
HP1_SHARD_STEPS = 50
HP1_SHARD_BAR = 1e-5
F64_SHARD_STEPS = 6
# the keyed noise's float32 normals differ in their last bits between the
# card and the CPU (as at [54], whose LCP bound is 1e-8 for that reason);
# a step moves a bead by sqrt(2 D dt) z = 4.47e-3 z (D = 0.05, dt 2e-4), so
# one ulp of a normal is <= 1.06e-9 of position for |z| < 4: < 6.4e-9 in 6 steps
F64_SHARD_BAR = 1e-8
# [60]-[64]: LCP rpy_ring over ranks and the last three engines
# (parallel/slab.py, sharded_step.py, slab_lcp.py) at d = 2
RING_N = 16_384
RING_SHARD_WARM = 1
RING_SHARD_STEPS = 3
RING_F64_STEPS = 14
SHARDED_N = 1 << 20
SHARDED_STEP_STEPS = 5
SLAB_LCP_WARM = 1
SLAB_LCP_STEPS = 4
# [50], [53], [59], [64]: (yaml, --set overrides, --output-dir, steps or None
# for a refusal) of each `--devices 2` subprocess, all started at once
CLI_DEVICES_RUNS = {
    50: [("spheres_10k", ("num_steps=200",), True, 200),
         ("rods_100k", ("num_steps=20",), True, 20)],
    53: [("lcp_spheres_100k", ("num_steps=20",), True, 20),
         ("granular_settling", ("num_steps=200",), True, 200)],
    59: [("filaments_sperm", ("num_steps=100",), False, 100),
         ("chromatin_1m_spectral", ("num_chains=64", "num_crosslinkers=2048", "num_steps=1"),
          False, 1),
         ("hp1_chromatin", (), False, None)],
    64: [("lcp_spheres_100k", ("hydro=rpy_ring", "num_spheres=4096", "box_size=31.0",
                               "num_steps=10"), True, 10)],
}
F64_V2_STEPS = 30
F64_SLAB_LCP_STEPS = 20
# [65]: (config, N, steps, where the float64 leg runs) of each drift run:
# the harness's defaults, then the per-step drift at BASELINE.json's 1M LCP
# size, whose float64 leg runs on the card (with it on the host the harness
# took 191 s for one step: PERF.md), for 20 steps, the window after which
# tests/test_drift.py reads its overlap bar (one step from the random start
# leaves the deepest overlaps in both legs, as in the reference)
DRIFT_RUNS = (("spheres", 2000, 100, "cpu"), ("lcp", 2000, 100, "cpu"),
              ("lcp", 1_048_576, 20, "cuda"))
# the bars of tests/test_drift.py, set at its N = 600 (box 18.45). The
# per-step bar is float32 rounding of positions below 32 times ~50; it is
# held in ulps: a box in a higher binade scales it by the ratio of the
# float32 ulps (1 at N = 2000, box 27.58; 8 at 1M, box 222.4)
DRIFT_PER_STEP_BAR = 1e-4
DRIFT_TEST_N = 600
DRIFT_SPHERES_20_BAR = 3e-2
DRIFT_OVERLAP_BAR = 5e-4

# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bench_config(SpheresConfig, n: int):
    """bench.py's headline config: phi = 0.05, box scaled to n."""
    radius, phi = 0.5, 0.05
    box = (n * (4.0 / 3.0) * math.pi * radius ** 3 / phi) ** (1.0 / 3.0)
    return SpheresConfig(num_spheres=n, box_size=box, radius=radius,
                         youngs_modulus=1000.0, diffusion_coeff=0.1, dt=1e-4,
                         skin=0.4, max_neighbors=32, cell_capacity=8,
                         chunk=16384, dtype="float32")


def lcp_bench_config(LCPSpheresConfig, n: int):
    """bench.py's measure_lcp config (bench.py:39-42)."""
    box = (n * (4.0 / 3.0) * math.pi * 0.125 / 0.05) ** (1.0 / 3.0)
    return LCPSpheresConfig(num_spheres=n, box_size=float(box), radius=0.5,
                            dt=1e-3, diffusion_coeff=0.1, constraint_buffer=0.45)


def stencil_work(valid, torch) -> tuple:
    """(K1 pairs, K2 candidate distances) that this row layout's data needs,
    from the occupancy of its (ny, nz) rows: K1's half stencil takes each
    occupied pair once, occ (occ - 1) / 2 in the own row plus occ x occ' with
    the rows (y, z+1), (y+1, z-1), (y+1, z), (y+1, z+1); K2 tests each
    occupied slot against every occupied slot of its 9 rows, itself
    included (the self test is by gid)."""
    occ = valid.sum(-1).to(torch.float64)

    def at(dy, dz):  # occupancy of row (iy + dy, iz + dz), periodic
        return torch.roll(occ, (-dy, -dz), dims=(0, 1))

    half = at(0, 1) + at(1, -1) + at(1, 0) + at(1, 1)
    nine = sum(at(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    k1_pairs = (occ * half).sum() + (occ * (occ - 1) / 2).sum()
    return float(k1_pairs), float((occ * nine).sum())


def contact_pairs(pos, valid, box, radii, torch) -> float:
    """Unordered pairs in contact on this row layout, by the plain version's
    pair test: over the full 9-row stencil, the minimum image on every axis,
    d = r2 rsqrt(r2) < ro + rc, both slots valid; radii: the (ny, nz, R)
    radius plane. Counted in y-slabs of ~5e7 pair entries."""
    L = torch.tensor(box, dtype=pos.dtype, device=pos.device)
    ny, nz, R = valid.shape
    not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
    step = max(1, int(5e7 // (nz * R * R)))
    hits = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            cp, cv, cr = (torch.roll(t, (-dy, -dz), dims=(0, 1)) for t in (pos, valid, radii))
            for y0 in range(0, ny, step):
                s = slice(y0, y0 + step)
                d = cp[s][..., None, :, :] - pos[s][..., :, None, :]
                d = d - L * torch.round(d / L)
                r2 = torch.clamp((d * d).sum(-1), min=1e-24)
                hit = ((r2 * torch.rsqrt(r2) < radii[s][..., :, None] + cr[s][..., None, :])
                       & valid[s][..., :, None] & cv[s][..., None, :])
                if (dy, dz) == (0, 0):
                    hit = hit & not_self
                hits += int(hit.sum())
    return hits / 2


def reach_pairs(pos, hedges, valid, box, radius, k4, torch) -> tuple:
    """Unordered pairs of valid rods on this row layout that the rods
    kernel's reach test (k4.segment_reach) keeps, over the full 9-row
    stencil with the minimum image on every axis: (within reach in x alone,
    within reach in 3D). Counted in y-slabs of ~5e7 pair entries."""
    L = torch.tensor(box, dtype=pos.dtype, device=pos.device)
    lens = k4.half_edge_lengths(hedges)
    ny, nz, R = valid.shape
    not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
    step = max(1, int(5e7 // (nz * R * R)))
    in_x = in_3d = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            cp, cv, cl = (torch.roll(t, (-dy, -dz), dims=(0, 1)) for t in (pos, valid, lens))
            for y0 in range(0, ny, step):
                s = slice(y0, y0 + step)
                d = cp[s][..., None, :, :] - pos[s][..., :, None, :]
                d = d - L * torch.round(d / L)
                sx, sy, sz = d.unbind(-1)
                lo, lc = lens[s][..., :, None], cl[s][..., None, :]
                pair = valid[s][..., :, None] & cv[s][..., None, :]
                if (dy, dz) == (0, 0):
                    pair = pair & not_self
                zero = torch.zeros_like(sx)
                in_x += int((pair & k4.segment_reach(sx, zero, zero, lo, lc, radius)).sum())
                in_3d += int((pair & k4.segment_reach(sx, sy, sz, lo, lc, radius)).sum())
    return in_x / 2, in_3d / 2


def cut_pairs_in_x(pos, valid, box, radii, reach, torch) -> float:
    """Unordered pairs of valid spheres on this row layout whose x
    separation alone a kernel's cut keeps, reach(dx^2, own radius,
    candidate radius) (row_central.contact_reach for K1, row_hertz's for
    K6, k2_bound's for K2), over the full 9-row stencil with the x minimum
    image; radii: the (ny, nz, R) radius plane. Counted in y-slabs of ~5e7
    pair entries."""
    ny, nz, R = valid.shape
    lx = float(box[0])
    not_self = ~torch.eye(R, dtype=torch.bool, device=pos.device)
    step = max(1, int(5e7 // (nz * R * R)))
    hits = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            cx, cv, cr = (torch.roll(t, (-dy, -dz), dims=(0, 1))
                          for t in (pos[..., 0], valid, radii))
            for y0 in range(0, ny, step):
                s = slice(y0, y0 + step)
                dx = cx[s][..., None, :] - pos[s][..., :, None, 0]
                dx = dx - lx * torch.round(dx / lx)
                hit = (reach(dx * dx, radii[s][..., :, None], cr[s][..., None, :])
                       & valid[s][..., :, None] & cv[s][..., None, :])
                if (dy, dz) == (0, 0):
                    hit = hit & not_self
                hits += int(hit.sum())
    return hits / 2


def k2_bound(rs, box, cutoff: float, K: int, radii, torch) -> tuple:
    """K2's bound on this row layout, counted from the algorithm: 13 FP32
    operations per ordered pair of occupied slots within the cut in x (x
    image 5, dy and dz 2, r2 5, the cut test), 15 with the radius variant's
    per-pair cut (s_own + s_cand and its square); bytes: the valid byte of
    every slot, the position and gid (and search radius) of each occupied
    slot read once, K ids and a count per slot written once. Returns (bound,
    ordered pairs within the cut in x, the first design's count: every
    occupied candidate x 13 (15) and every slot's planes read once)."""
    n_slots = rs.valid.numel()
    n_occ = int(rs.valid.sum())
    # each unordered pair is tested from both sides, with a symmetric test
    if radii is None:
        cut2 = torch.tensor(cutoff * cutoff, dtype=rs.pos.dtype, device=rs.pos.device)
        plane = torch.zeros(rs.valid.shape, dtype=rs.pos.dtype, device=rs.pos.device)
        pairs = 2 * cut_pairs_in_x(rs.pos, rs.valid, box, plane,
                                   lambda dx2, ro, rc: dx2 < cut2, torch)
    else:
        pairs = 2 * cut_pairs_in_x(rs.pos, rs.valid, box, radii,
                                   lambda dx2, ro, rc: dx2 < (ro + rc) * (ro + rc), torch)
    ops = 13.0 if radii is None else 15.0
    extra = 0 if radii is None else 4
    out_bytes = n_slots * (K + 1) * 4
    new = bound(pairs * ops, n_slots + n_occ * (12 + 4 + extra) + out_bytes)
    old = bound(stencil_work(rs.valid, torch)[1] * ops,
                n_slots * (12 + 4 + 1 + extra) + out_bytes)
    return new, pairs, old


def cuda_ms(fn, torch, reps: int) -> float:
    """Median device time of fn() in ms (CUDA events after a synchronize)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, torch, reps: int = 20) -> float:
    """Device time per launch of fn, a call that launches one kernel and
    never waits on the card. After a warm-up call, a spin on the card holds
    the stream while the host enqueues all `reps` calls between two events,
    so the events take in the kernels back to back and none of the host
    time of the wrapper (which an event pair around one call, as in
    cuda_ms, takes in, and which dominates a kernel of tens of us)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host_s = time.perf_counter() - t0
    b.synchronize()
    if host_s > 0.05:
        fail(f"enqueueing {reps} launches took {host_s:.3f} s, as long as the spin ahead of them")
    return a.elapsed_time(b) / reps


def k3_window_inputs(sim, st, n: int, seed: int, torch):
    """K3's inputs for the next step of an LCPSpheresSim at state st: the
    active subset through collision_forces' reshapes, gamma uniform from
    `seed` on the active pairs. Returns (values (nb, 3, W), loc (nb, W),
    active pairs)."""
    from mundy_tpu_torch.constraints.collision import (active_pair_subset_strided,
                                                       collision_setup_spheres)

    setup = collision_setup_spheres(st.pos, sim._radius(), st.pairs, sim.metric)
    act = active_pair_subset_strided(setup, sim._dyn_margin(setup), n, sim.seg_block,
                                     sim.act_window, st.seg_starts)
    nb, W, B = sim.nb_blocks, sim.act_window, sim.seg_block
    dev = st.pos.device
    pairs = act.setup.pairs
    gam = torch.rand(pairs.i.shape, generator=torch.Generator(dev).manual_seed(seed),
                     device=dev, dtype=st.pos.dtype)
    gn = -(torch.where(pairs.mask, gam, 0.0)[:, None] * act.setup.normals)
    values = gn.reshape(nb, W, 3).transpose(1, 2).contiguous()
    blk = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] * B
    loc = (pairs.i.reshape(nb, W) - blk).contiguous()
    return values, loc, int(pairs.mask.sum())


def alternate(kernel, plain, torch, reps_k: int, reps_p: int, rounds: int = 3):
    """Median kernel and plain times over rounds of plain, kernel, kernel,
    plain."""
    ms_k, ms_p = [], []
    for _ in range(rounds):
        ms_p.append(cuda_ms(plain, torch, reps_p))
        ms_k.append(cuda_ms(kernel, torch, reps_k))
        ms_k.append(cuda_ms(kernel, torch, reps_k))
        ms_p.append(cuda_ms(plain, torch, reps_p))
    return statistics.median(ms_k), statistics.median(ms_p)


def took(label: str, t0: float) -> float:
    """Print the seconds since t0 of a group of phases; return now."""
    now = time.perf_counter()
    print(f"{label} took {now - t0:.1f} s", flush=True)
    return now


def build_all(_build) -> None:
    """One nvcc process per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.build, KERNELS))
    print(f"[1] built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {os.path.basename(lib)}: {line.strip()}")


def profile_window(run, torch, step_ms: float, steps: int = 4) -> None:
    """Where the time of a step goes: torch.profiler over run(steps), a
    window of `steps` steps. Prints device busy time, host reads and kernel
    launches per step, the device time of the largest kernels, and the idle
    share against the profiled wall clock (which the profiler's own host
    overhead inflates) and against `step_ms`, the un-profiled window's
    ms/step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)

    def per_step(name):
        return sum(e.count for e in events if e.key == name) / steps

    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    print(f"    profile over {steps} steps: wall {wall_ms / steps:.3f} ms/step, device "
          f"busy {busy_ms / steps:.3f} ms/step, idle share {1 - busy_ms / wall_ms:.4f} "
          f"(un-profiled {1 - busy_ms / steps / step_ms:.4f}); per step "
          f"{per_step('aten::_local_scalar_dense'):.1f} host reads, "
          f"{per_step('cudaLaunchKernel'):.1f} kernel launches", flush=True)
    for e in kernels[:8]:
        print(f"      {1e-3 * e.self_device_time_total / steps:8.4f} ms/step  "
              f"{e.count / steps:7.1f} calls/step  {e.key[:90]}", flush=True)


def k5_ops(P: int) -> float:
    """FP32 operations per gridded particle of K5s or K5i at window support
    P (ES window), counted from the algorithm: floor and fraction per axis
    (6); 3P window weights at 9 each (offset, / wh, square, 1 -, clamp,
    sqrt, - 1, x beta, exp); the separable product w_x w_y (P^2) and x w_z
    (P^3); the weight times each of 3 components (3P^3) and their sums
    (3P^3). K5i adds its h^3 scale (3), not counted."""
    return 6.0 + 27.0 * P + P * P + 7.0 * P ** 3


def chromatin_phases(torch, dev, card: str) -> list:
    """Phases 20-22: config #5 (chromatin, spectral-Ewald RPY) with K5s and
    K5i, times printed with `card` (name and power limit). Returns their
    entries of the kernels line."""
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.regrow import run_blocks
    from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
    from mundy_tpu_torch.mobility import spectral
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import se_grid as k5

    # ---- 20. K5s and K5i vs plain at the config #5 shape -------------------
    raw = load_yaml(os.path.join(HERE, "examples", "chromatin_1m_spectral.yaml"))
    cfg = config_from_dict(ChromatinConfig, raw["params"])
    t0 = time.perf_counter()
    sim = ChromatinSim(cfg, device=dev)
    t1 = time.perf_counter()
    k2.row_neighbor_extract.launches = 0
    st = sim.init()
    torch.cuda.synchronize()
    k2_init = k2.row_neighbor_extract.launches
    geom = sim.se_geom
    print(f"[20] chromatin_1m_spectral.yaml: {sim.N} beads, {sim.X} crosslinkers, "
          f"ChromatinSim() {t1 - t0:.2f} s, init {time.perf_counter() - t1:.2f} s; G "
          f"{geom.G}, P {geom.P}, m {geom.m}, se R {geom.R}, hydro cells "
          f"{sim.hydro_cells_grid.nx}^3 x {sim.hydro_cells_grid.capacity}, split "
          f"{sim.hydro_split}, contact K {sim.contact_K}, kmc K {sim.kmc_K}, broad "
          f"phase {sim.broad_phase()} (K2 launches in init {k2_init}), real-space base "
          f"capacity {sim.hydro_split_grid.capacity if sim.hydro_split else None}, rows "
          f"slack {sim.rows_slack:.4f}", flush=True)
    if k2_init == 0 and sim.broad_phase() == "rows":
        fail("the rows broad phase of init did not launch K2")
    pieces = spectral.se_bin_geom(geom, st.pos, torch.float32)
    forces = sim._forces(st)
    grid_k = k5.se_spread(geom, pieces, forces)
    grid_p = k5.se_spread_plain(geom, pieces, forces)
    ugrid = spectral._k_apply(sim.spectral, grid_p)  # as the wave apply passes it
    u_k = k5.se_interp(geom, pieces, ugrid)
    i_same = bool(torch.equal(u_k, k5.se_interp(geom, pieces, ugrid)))
    u_p = k5.se_interp_plain(geom, pieces, ugrid)
    torch.cuda.synchronize()
    s_err = (grid_k - grid_p).abs().max().item()
    gmax = grid_p.abs().max().item()
    i_err = (u_k - u_p).abs().max().item()
    umax = u_p.abs().max().item()
    perm, _ovf, u, valid, slot_of = pieces
    n_valid = int(valid.sum())
    print(f"    {n_valid} binned beads in {perm.shape[0]} tiles of R = {perm.shape[1]}: K5s "
          f"max|diff| {s_err:.3e} of max|grid| {gmax:.3e}, K5i max|diff| {i_err:.3e} of "
          f"max|u| {umax:.3e} on the inverse FFT's layout (strides {ugrid.stride()}, a "
          f"second launch bit-equal {i_same}), overflow {bool(pieces[1])}", flush=True)
    if not (gmax > 0 and math.isfinite(s_err) and s_err <= 1e-5 * gmax):
        fail(f"K5s disagrees with its plain version: {s_err} > 1e-5 * {gmax}")
    if not (umax > 0 and math.isfinite(i_err) and i_err <= 1e-5 * umax and i_same):
        fail(f"K5i disagrees with its plain version ({i_err} > 1e-5 * {umax}) or with "
             f"itself (repeat bit-equal {i_same})")
    del grid_k
    s_ms, s_plain_ms = alternate(lambda: k5.se_spread(geom, pieces, forces),
                                 lambda: k5.se_spread_plain(geom, pieces, forces),
                                 torch, 10, 2, rounds=2)
    i_ms, i_plain_ms = alternate(lambda: k5.se_interp(geom, pieces, ugrid),
                                 lambda: k5.se_interp_plain(geom, pieces, ugrid),
                                 torch, 10, 2, rounds=2)
    # the library yardstick: one index_add_ of the precomputed N P^3
    # support ids and weighted forces into the flat grid (prepared untimed)
    sel = valid.reshape(-1).nonzero()[:, 0]
    idx, wt = k5._support(geom, u.reshape(-1, 3)[sel])
    vals = (wt[..., None] * forces[perm.reshape(-1)[sel].long()][:, None, None, None, :])
    idx, vals = idx.reshape(-1), vals.reshape(-1, 3)
    del wt
    acc = torch.zeros((geom.G ** 3, 3), device=dev)
    lib_err = (acc.clone().index_add_(0, idx, vals) - grid_p.reshape(-1, 3)).abs().max().item()
    s_lib_ms = statistics.median(
        [cuda_ms(lambda: acc.index_add_(0, idx, vals), torch, 5) for _ in range(3)])
    del idx, vals, acc
    # read each occupied slot's u once, perm (K5s) or slot_of and the grid
    # (K5i) once, the forces once; write the grid (K5s) or u (K5i) once
    grid_bytes = grid_p.numel() * 4
    s_bound = bound(n_valid * k5_ops(geom.P),
                    perm.numel() * 4 + n_valid * 12 + forces.numel() * 4 + grid_bytes)
    i_bound = bound(n_valid * (k5_ops(geom.P) + 3),
                    slot_of.numel() * 4 + n_valid * 12 + grid_bytes + u_p.numel() * 4)
    print(f"    K5s {s_ms:.4f} ms, plain {s_plain_ms:.4f} ms, index_add_ {s_lib_ms:.4f} ms "
          f"(max|diff| {lib_err:.3e}; K5s / index_add_ {s_ms / s_lib_ms:.4f}), bound "
          f"{s_bound[0]:.4f} ms ({s_bound[1]}, {s_ms / s_bound[0]:.1f}x); {card}", flush=True)
    print(f"    K5i {i_ms:.4f} ms, plain {i_plain_ms:.4f} ms, bound {i_bound[0]:.4f} ms "
          f"({i_bound[1]}, {i_ms / i_bound[0]:.1f}x); {card}", flush=True)
    del grid_p, ugrid, u_k, u_p, pieces, forces, sel

    # ---- 21. config #5 in float64, card vs CPU; float32 twice on the card --
    small = dict(num_chains=2, beads_per_chain=64, bead_radius=0.5, num_crosslinkers=16,
                 diffusion_coeff=0.05, dt=2e-4, skin=0.1, box_size=24.0,
                 hydro="rpy_spectral", binding_rate=50.0, unbinding_rate=5.0, chunk=256)
    traces = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        ssim = ChromatinSim(ChromatinConfig(**small, dtype="float64"), device=d)
        s = ssim.init()
        rows_ = []
        for _ in range(CHROM_SMALL_STEPS):
            s = ssim.run_block(s, 1)
            rows_.append((s.rebuild_count, bool(s.overflow), s.xl_state.cpu().tolist()))
        traces[name] = (rows_, s.pos.cpu(), ssim.hydro_split, ssim.doubly_bound(s))
    (tg, pg, split, dbound), (tc, pc, _, _) = traces["card"], traces["cpu"]
    diff = (pg - pc).abs().max().item()
    print(f"[21] chromatin float64 2 x 64 beads, {CHROM_SMALL_STEPS} steps: rebuilds "
          f"{tg[-1][0]} (cpu {tc[-1][0]}), split {split}, doubly bound {dbound}, max|pos "
          f"diff| vs cpu {diff:.3e}", flush=True)
    if not (tg == tc and diff <= 1e-7 and tg[-1][0] >= 2 and split is not None
            and dbound > 0 and not tg[-1][1]):
        fail("the float64 chromatin run on the card disagrees with the CPU run")
    runs = []
    for _ in range(2):
        ssim = ChromatinSim(ChromatinConfig(**small, dtype="float32"), device=dev)
        runs.append(ssim.run_block(ssim.init(), CHROM_SMALL_STEPS).pos)
    same = bool(torch.equal(runs[0], runs[1]))
    print(f"    float32 twice on the card: positions bit-equal {same}", flush=True)
    if not same:
        fail("two float32 chromatin runs on the card differ")

    # ---- 22. the 1M YAML through run_blocks and run_block ------------------
    st = run_blocks(sim, st, 2, 2, log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    rb0 = st.rebuild_count
    broad = sim.broad_phase()
    k5.se_spread.launches = k5.se_interp.launches = k2.row_neighbor_extract.launches = 0
    t0 = time.perf_counter()
    st = sim.run_block(st, CHROM_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    s_launches, i_launches = k5.se_spread.launches, k5.se_interp.launches
    k2_launches = k2.row_neighbor_extract.launches
    rebuilds = st.rebuild_count - rb0
    print(f"[22] 1M chromatin: {CHROM_STEPS} steps in {elapsed:.3f} s = "
          f"{CHROM_STEPS / elapsed:.4f} steps/s, {1e3 * elapsed / CHROM_STEPS:.3f} ms/step; "
          f"G {sim.spectral.grid_n}, P {sim.spectral.support}, se R {sim.se_geom.R}, broad "
          f"phase {broad}, rebuilds {rebuilds}, doubly bound {sim.doubly_bound(st)}/"
          f"{sim.X}, overflow {bool(st.overflow)}; launches K5s {s_launches}, K5i "
          f"{i_launches}, K2 {k2_launches}; {card}", flush=True)
    if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()):
        fail("the 1M chromatin window overflowed or went non-finite")
    if s_launches != CHROM_STEPS or i_launches != CHROM_STEPS:
        fail(f"K5s/K5i launched {s_launches}/{i_launches} times in {CHROM_STEPS} steps")
    if k2_launches != (rebuilds if broad == "rows" else 0):
        fail(f"K2 launched {k2_launches} times for {rebuilds} {broad} broad phases")
    # the step's layers alone at the window's final state
    f = sim._forces(st)
    pieces = spectral.se_bin_geom(sim.se_geom, st.pos, torch.float32)
    grid = k5.se_spread(sim.se_geom, pieces, f)
    parts = (
        ("kmc", lambda: sim._kmc(st)),
        ("forces", lambda: sim._forces(st)),
        ("velocity (binning, cells, real space, wave)", lambda: sim._velocity(st, f)),
        ("wave (K5s, FFT, K5i)", lambda: spectral.se_wave_apply_dense(
            sim.spectral, sim.se_geom, st.pos, f, pieces=pieces)),
        ("FFT mode product", lambda: spectral._k_apply(sim.spectral, grid)),
        ("noise", lambda: brownian_velocity_keyed(st.key, st.step, sim._gids,
                                                  cfg.diffusion_coeff, cfg.dt)),
        ("rebuild (contact + kmc searches)", lambda: sim._rebuild(st)))
    print(f"    the step's layers alone at the window's final state ({card}):", flush=True)
    for name, fn in parts:
        print(f"    {name}: {cuda_ms(fn, torch, 3):.3f} ms", flush=True)
    del f, pieces, grid
    profile_window(lambda n: sim.run_block(st, n), torch, 1e3 * elapsed / CHROM_STEPS,
                   steps=1)
    return [
        {"name": "se_spread", "route": "cuda", "source": "mundy_tpu_torch/csrc/se_grid.cu",
         "replaces": "mundy_tpu/ops/pallas/se_grid.py:429", "launches": s_launches,
         "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain_ms, "bound_ms": s_bound[0],
         "bound_by": s_bound[1], "library_ms": s_lib_ms},
        {"name": "se_interp", "route": "cuda", "source": "mundy_tpu_torch/csrc/se_grid.cu",
         "replaces": "mundy_tpu/ops/pallas/se_grid.py:486", "launches": i_launches,
         "max_abs_err": i_err, "ms": i_ms, "plain_ms": i_plain_ms, "bound_ms": i_bound[0],
         "bound_by": i_bound[1], "library_ms": None}]




def polydisperse_phases(torch, dev, lcp_sim, lcp_st, card: str) -> list:
    """Phases 23-28: K6 on config #1's rows and with radii on the
    polydisperse row engine, K3t and the scalar-mobility Delassus applies at
    [6]'s final LCP state, and the polydisperse LCP line with K2's radius
    variant, K6's times printed with `card` (name and power limit). Returns
    their entries of the kernels line."""
    from mundy_tpu_torch.constraints.collision import (
        active_pair_subset_strided, collision_setup_spheres, make_band_delassus_apply,
        make_block_delassus_apply, make_local_drag_apply, resolve_collisions)
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
    from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
    from mundy_tpu_torch.neighbor.rows import build_rows, make_row_grid
    from mundy_tpu_torch.ops.kernels import row_central as k1
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import row_hertz as k6
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    # ---- 23. K6 vs its plain version and K1 at the 1M config #1 shape -----
    big = bench_config(SpheresConfig, N_BIG)
    sim = RowSpheresSim(big, device=dev)
    rows = sim.init().rows
    args = (rows.pos, rows.valid, sim.box_static[0], big.radius, big.youngs_modulus,
            big.poissons_ratio)
    k6.row_hertzian_forces.launches = 0
    f6 = k6.row_hertzian_forces(*args)
    same = bool(torch.equal(f6, k6.row_hertzian_forces(*args)))
    f_p = k6.row_hertzian_forces_plain(*args)
    f1 = k1.row_hertzian_forces_sym(rows.pos, *args[2:], valid=rows.valid)
    torch.cuda.synchronize()
    m = rows.valid
    fmax = f_p[m].abs().max().item()
    k6_err = (f6 - f_p).abs().max().item()
    k6_k1 = (f6[m] - f1[m]).abs().max().item()
    ny, nz, R = m.shape
    print(f"[23] K6 at (ny, nz, R) = ({ny}, {nz}, {R}): max|diff| {k6_err:.3e} vs plain, "
          f"{k6_k1:.3e} vs K1, of max|f| {fmax:.3e}, invalid slots zero "
          f"{bool((f6[~m] == 0).all())}, a second launch bit-equal {same}", flush=True)
    if not (fmax > 0 and k6_err <= 5e-5 * fmax and k6_k1 <= 5e-5 * fmax
            and bool((f6[~m] == 0).all()) and same):
        fail(f"K6 disagrees: {k6_err} vs plain, {k6_k1} vs K1, bar 5e-5 * {fmax}, "
             f"repeat bit-equal {same}")
    del f6, f_p, f1
    k6_mono_ms, k6_mono_plain_ms = alternate(lambda: k6.row_hertzian_forces(*args),
                                             lambda: k6.row_hertzian_forces_plain(*args),
                                             torch, 10, 2)
    k1_again_ms = statistics.median(
        [cuda_ms(lambda: k1.row_hertzian_forces_sym(rows.pos, *args[2:], valid=rows.valid),
                 torch, 10)
         for _ in range(3)])
    # the occupied pairs within their contact distance in x at K6_REACH_OPS,
    # those in contact at K6_CONTACT_OPS more; read valid on every slot and
    # the occupied slots' positions once, write the forces on every slot once
    plane = m.to(rows.pos.dtype) * big.radius
    in_x = cut_pairs_in_x(rows.pos, m, args[2], plane, k6.contact_reach, torch)
    contacts = contact_pairs(rows.pos, m, args[2], plane, torch)
    k6_mono_bytes = m.numel() * (1 + 12) + int(m.sum()) * 12
    k6_mono_bound = bound(in_x * K6_REACH_OPS + contacts * K6_CONTACT_OPS, k6_mono_bytes)
    print(f"    K6 {k6_mono_ms:.4f} ms, K1 {k1_again_ms:.4f} ms, plain "
          f"{k6_mono_plain_ms:.4f} ms, bound {k6_mono_bound[0]:.4f} ms "
          f"({k6_mono_bound[1]}, {k6_mono_bytes / 1e6:.1f} MB; {in_x:.0f} pairs within reach "
          f"in x, {contacts:.0f} in contact), {k6_mono_ms / k6_mono_bound[0]:.1f}x the bound; "
          f"K6 launches in [23] {k6.row_hertzian_forces.launches} (comparison and timing; no "
          f"app runs the monodisperse law through K6, [24] counts the path's); {card}",
          flush=True)
    del sim, rows, args

    # ---- 24. polydisperse config #1 at 1M through K6 with radii ----------
    pcfg = dataclasses.replace(big, polydispersity=0.4)
    psim = RowSpheresSim(pcfg, device=dev)
    t0 = time.perf_counter()
    pst = psim.init()
    torch.cuda.synchronize()
    rows = pst.rows
    r_rows = psim.slot_planes(rows)[0]
    args = (rows.pos, rows.valid, psim.box_static[0], pcfg.radius, pcfg.youngs_modulus,
            pcfg.poissons_ratio)
    f6 = k6.row_hertzian_forces(*args, radii=r_rows)
    same = bool(torch.equal(f6, k6.row_hertzian_forces(*args, radii=r_rows)))
    f_p = k6.row_hertzian_forces_plain(*args, radii=r_rows)
    torch.cuda.synchronize()
    m = rows.valid
    fmax = f_p[m].abs().max().item()
    k6_err = max(k6_err, (f6 - f_p).abs().max().item())
    k6r_err = (f6 - f_p).abs().max().item()
    ny, nz, R = m.shape
    print(f"[24] polydisperse config #1 at 1M (p = 0.4): init {time.perf_counter() - t0:.2f} "
          f"s, cutoff {psim.cutoff:.4f}, (ny, nz, R) = ({ny}, {nz}, {R}); K6 radii max|diff| "
          f"{k6r_err:.3e} of max|f| {fmax:.3e}, a second launch bit-equal {same}", flush=True)
    if not (fmax > 0 and k6r_err <= 5e-5 * fmax and same):
        fail(f"K6 with radii disagrees with its plain version ({k6r_err} > 5e-5 * {fmax}) "
             f"or with itself (repeat bit-equal {same})")
    del f6, f_p
    k6_ms, k6_plain_ms = alternate(lambda: k6.row_hertzian_forces(*args, radii=r_rows),
                                   lambda: k6.row_hertzian_forces_plain(*args, radii=r_rows),
                                   torch, 10, 1, rounds=2)
    # the occupied pairs within their own contact distance in x at
    # K6_RADII_REACH_OPS, those in contact at K6_RADII_CONTACT_OPS more; read
    # valid on every slot and the occupied slots' positions and radii once,
    # write the forces on every slot once
    in_x = cut_pairs_in_x(rows.pos, m, args[2], r_rows, k6.contact_reach, torch)
    contacts = contact_pairs(rows.pos, m, args[2], r_rows, torch)
    k6_bytes = m.numel() * (1 + 12) + int(m.sum()) * (12 + 4)
    k6_bound = bound(in_x * K6_RADII_REACH_OPS + contacts * K6_RADII_CONTACT_OPS, k6_bytes)
    print(f"    K6 radii {k6_ms:.4f} ms, plain {k6_plain_ms:.4f} ms, bound "
          f"{k6_bound[0]:.4f} ms ({k6_bound[1]}, {k6_bytes / 1e6:.1f} MB; {in_x:.0f} pairs "
          f"within reach in x, {contacts:.0f} in contact; occupied pairs "
          f"{stencil_work(m, torch)[0]:.0f}), {k6_ms / k6_bound[0]:.1f}x the bound; {card}",
          flush=True)
    del rows, args, r_rows
    pst = psim.run_block(pst, 3)  # warm up
    torch.cuda.synchronize()
    rb0 = pst.rebuild_count
    k6.row_hertzian_forces.launches = 0
    t0 = time.perf_counter()
    pst = psim.run_block(pst, BIG_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k6_launches = k6.row_hertzian_forces.launches
    n_valid = int(pst.rows.valid.sum())
    print(f"    {BIG_STEPS} steps in {elapsed:.3f} s = {BIG_STEPS / elapsed:.2f} steps/s, "
          f"{1e3 * elapsed / BIG_STEPS:.3f} ms/step, rebuilds {pst.rebuild_count - rb0}, R "
          f"{psim.grid.row_capacity}, K6 launches {k6_launches}; {card}", flush=True)
    if n_valid != N_BIG or bool(pst.overflow) or not bool(
            torch.isfinite(psim.positions(pst)).all()):
        fail(f"the polydisperse 1M run lost spheres, overflowed or went non-finite "
             f"(valid {n_valid})")
    if k6_launches != BIG_STEPS:
        fail(f"K6 launched {k6_launches} times in {BIG_STEPS} steps")
    profile_window(lambda n: psim.run_block(pst, n), torch, 1e3 * elapsed / BIG_STEPS)
    del psim, pst

    # ---- 25. polydisperse config #1 in float64, card vs CPU ----------------
    small = SpheresConfig(num_spheres=2000, box_size=16.0, diffusion_coeff=0.01, dt=1e-4,
                          skin=0.1, polydispersity=0.4, dtype="float64")
    pos0 = torch.rand((2000, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(25)) * 16.0
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        ssim = RowSpheresSim(small, device=d)
        s = ssim.run_block(ssim.init(pos=pos0, key_words=(0, 25)), 60)
        runs[name] = (s, ssim.positions(s).cpu(), ssim.max_overlap(s))
    (sg, pg, og), (sc, pc, oc) = runs["card"], runs["cpu"]
    diff = (pg - pc).abs().max().item()
    print(f"[25] polydisperse float64 2000 spheres, 60 steps: rebuilds {sg.rebuild_count} "
          f"(cpu {sc.rebuild_count}), max|pos diff| vs cpu {diff:.3e}, max overlap "
          f"{og:.4f} (cpu {oc:.4f})", flush=True)
    if not (sg.rebuild_count == sc.rebuild_count >= 3 and diff <= 1e-7
            and torch.equal(sg.rows.gid.cpu(), sc.rows.gid)):
        fail("the polydisperse float64 run on the card disagrees with the CPU run")

    # ---- 26. K3t and the scalar-mobility Delassus applies at [6]'s state --
    lcfg, st, lsim = lcp_sim.config, lcp_st, lcp_sim
    setup = collision_setup_spheres(st.pos, lsim._radius(), st.pairs, lsim.metric)
    act = active_pair_subset_strided(setup, lsim._dyn_margin(setup), N_BIG, lsim.seg_block,
                                     lsim.act_window, st.seg_starts, dual_full=st.dual_full,
                                     prev=(st.prev_cum, st.gamma, lsim.act_window),
                                     gamma_full=st.gamma_full)
    nb, W, B = lsim.nb_blocks, lsim.act_window, lsim.seg_block
    aset = act.setup
    gam = torch.where(aset.pairs.mask, torch.rand(
        aset.pairs.i.shape, generator=torch.Generator(dev).manual_seed(26), device=dev), 0.0)
    g2 = gam.reshape(nb, W).contiguous()
    n_pl = aset.normals.reshape(nb, W, 3).transpose(1, 2).contiguous()
    blk = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] * B
    loc = (aset.pairs.i.reshape(nb, W) - blk).contiguous()
    t_k = k3.strided_onehot_t(g2, n_pl, loc, B)
    t_p = k3.strided_t_plain(g2, n_pl, loc, B)
    torch.cuda.synchronize()
    k3t_err = (t_k - t_p).abs().max().item()
    tmax = t_p.abs().max().item()
    n_act = int(aset.pairs.mask.sum())
    k3t_same = bool(torch.equal(t_k, t_p))
    n_sorted = int((loc[:, 1:] >= loc[:, :-1]).all(1).sum())
    print(f"[26] K3t at (nb, W, B) = ({nb}, {W}, {B}), {n_act} active pairs: max|diff| "
          f"{k3t_err:.3e}, max|t| {tmax:.3e}, bit-equal {k3t_same}, {n_sorted} of {nb} "
          f"blocks with nondecreasing ids", flush=True)
    if not (tmax > 0 and k3t_same):
        fail(f"K3t is not bit-equal to its plain version (max|diff| {k3t_err})")

    def k3_and_gather():  # the reference's fallback with K3: sum, gather, dot
        F = k3.strided_onehot_segment_sum((-g2[:, None, :] * n_pl).contiguous(), loc, B)
        lc = torch.where((loc >= 0) & (loc < B), loc.long(), 0)
        fx, fy, fz = (torch.gather(F[:, c], 1, lc) for c in range(3))
        return -((n_pl[:, 0] * fx + n_pl[:, 1] * fy) + n_pl[:, 2] * fz)

    k3g_err = (k3_and_gather() - t_p).abs().max().item()
    k3t_ms, k3t_plain_ms = alternate(lambda: k3.strided_onehot_t(g2, n_pl, loc, B),
                                     lambda: k3.strided_t_plain(g2, n_pl, loc, B),
                                     torch, 20, 3)
    k3g_ms = statistics.median([cuda_ms(k3_and_gather, torch, 20) for _ in range(3)])
    k3t_dev_ms = queued_ms(lambda: k3.strided_onehot_t(g2, n_pl, loc, B), torch)
    k3g_dev_ms = queued_ms(k3_and_gather, torch)
    # (-gamma) n and its sums 6 per active pair, the dot 5 per slot; read
    # gamma, normals and loc once, write t once
    k3t_bound = bound(6.0 * n_act + 5.0 * nb * W, nb * W * (4 + 12 + 4 + 4))
    print(f"    K3t {k3t_ms:.4f} ms (device time per launch {k3t_dev_ms:.4f} ms), plain "
          f"{k3t_plain_ms:.4f} ms, K3 + gather {k3g_ms:.4f} ms (device time "
          f"{k3g_dev_ms:.4f} ms, max|diff| {k3g_err:.3e}), bound {k3t_bound[0]:.4f} ms "
          f"({k3t_bound[1]}; {k3t_ms / k3t_bound[0]:.1f}x by event time, "
          f"{k3t_dev_ms / k3t_bound[0]:.1f}x by device time); {card}", flush=True)
    del t_k, t_p
    mob = torch.tensor(1.0 / (6.0 * math.pi * lcfg.viscosity * lcfg.radius), device=dev)
    applies = {
        "band": make_band_delassus_apply(aset, act.dual, lcfg.dt, lsim._pair_run_bound(),
                                         mobility_i=mob, mobility_j=mob),
        "local": make_local_drag_apply(aset, act.dual, lcfg.dt, mobility_i=mob,
                                       mobility_j=mob),
        "block": make_block_delassus_apply(aset, act.dual, lcfg.dt, mobility_i=mob,
                                           mobility_j=mob)}
    outs = {k: f(gam) for k, f in applies.items()}
    amax = outs["band"].abs().max().item()
    a_err = max((outs[k] - outs["band"]).abs().max().item() for k in ("local", "block"))
    print(f"    one gamma: local and block applies within {a_err:.3e} of the band apply, "
          f"max|A gamma| {amax:.3e}", flush=True)
    if not (amax > 0 and a_err <= 1e-5 * amax):
        fail(f"the Delassus applies disagree: {a_err} > 1e-5 * {amax}")
    u_ext = brownian_velocity_keyed(st.key, st.step,
                                    torch.arange(N_BIG, dtype=torch.int32, device=dev),
                                    lcfg.diffusion_coeff, lcfg.dt)
    solves = {}
    for name, fn in applies.items():
        torch.cuda.synchronize()
        k3.strided_onehot_t.launches = 0
        t0 = time.perf_counter()
        gamma, _vel, res = resolve_collisions(
            aset, lsim._mobility(st.pos, st.hydro_nmat)[0], N_BIG, lcfg.dt,
            max_allowable_overlap=lcfg.max_allowable_overlap,
            max_iterations=lcfg.max_col_iterations, gamma0=act.gamma0, u_ext=u_ext,
            alpha0=st.lcp_alpha, apply_override=fn)
        torch.cuda.synchronize()
        solves[name] = (gamma, res.num_iters, 1e3 * (time.perf_counter() - t0),
                        k3.strided_onehot_t.launches)
    gmax = solves["band"][0].abs().max().item()
    for name, (gamma, iters, ms, launches) in solves.items():
        print(f"    resolve_collisions with the {name} apply: {iters} iterations, "
              f"{ms / max(iters, 1):.4f} ms/iteration ({ms:.3f} ms), max|dgamma| vs band "
              f"{(gamma - solves['band'][0]).abs().max().item():.3e} of {gmax:.3e}, K3t "
              f"launches {launches}", flush=True)
    k3t_launches = solves["local"][3]
    if k3t_launches != solves["local"][1] + 1:
        fail(f"K3t launched {k3t_launches} times in {solves['local'][1]} iterations")
    del applies, outs, solves, setup, act, aset, g2, n_pl, loc, gam, u_ext

    # ---- 27. the polydisperse 1M LCP line (bench.py's protocol) -------------
    pcfg = dataclasses.replace(lcp_bench_config(LCPSpheresConfig, N_BIG),
                               polydispersity=0.5)
    psim = LCPSpheresSim(pcfg, device=dev)
    t0 = time.perf_counter()
    pst = psim.init()
    torch.cuda.synchronize()
    print(f"[27] polydisperse 1M LCP (p = 0.5) init in {time.perf_counter() - t0:.2f} s: "
          f"search radius {psim.search_radius:.4f}, pair capacity {psim.pair_capacity}, "
          f"rows_k {psim.rows_k}, rows_slack {psim.rows_slack:.4f}, act_window "
          f"{psim.act_window}, active {int(pst.act_count)}", flush=True)
    for _ in range(3):
        pst = psim.run_block(pst, 9)
    pst = pst.replace(overflow=torch.zeros((), dtype=torch.bool, device=dev))
    pst = psim.run_block(pst, 2, resize=False)
    torch.cuda.synchronize()
    if bool(pst.overflow):
        fail("polydisperse LCP capacities still overflow after the settle+resize blocks")
    rb0 = pst.rebuild_count
    window = 24
    k2.row_neighbor_extract.radius_launches = 0
    k3.strided_onehot_segment_sum.launches = 0
    t0 = time.perf_counter()
    pst = psim.run_block(pst, window, resize=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2r_launches = k2.row_neighbor_extract.radius_launches
    k3_launches = k3.strided_onehot_segment_sum.launches
    rebuilds = pst.rebuild_count - rb0
    print(f"    {window} steps in {elapsed:.3f} s = {window / elapsed:.3f} steps/s, "
          f"{1e3 * elapsed / window:.3f} ms/step, lcp_iters {pst.lcp_iters} (max "
          f"{pst.lcp_iters_max}), active {int(pst.act_count)}, rebuilds {rebuilds}, K2 "
          f"radius launches {k2r_launches}, K3 launches {k3_launches}", flush=True)
    if bool(pst.overflow) or not bool(torch.isfinite(pst.pos).all()):
        fail("the polydisperse 1M LCP window overflowed or went non-finite")
    if k3_launches != window:
        fail(f"K3 launched {k3_launches} times in {window} steps")
    if rebuilds < 1 or k2r_launches != rebuilds:
        fail(f"K2's radius variant launched {k2r_launches} times for {rebuilds} broad phases")
    K = min(pcfg.max_neighbors, psim.rows_k)
    cutoff = 2 * psim.search_radius
    grid = make_row_grid([0, 0, 0], [pcfg.box_size] * 3, cutoff, N_BIG,
                         capacity_slack=psim.rows_slack, dtype=torch.float32, align=8,
                         device=dev)
    rs = build_rows(pst.pos, torch.arange(N_BIG, dtype=torch.int32, device=dev), grid)
    sr_rows = torch.where(rs.valid, psim.search_radii[rs.gid.long()], 0.0)
    k2_args = (rs.pos, rs.gid, rs.valid, ((pcfg.box_size,) * 3, (True,) * 3), cutoff, K,
               N_BIG)
    ids_k, cnt_k = k2.row_neighbor_extract(*k2_args, radii=sr_rows)
    ids_p, cnt_p = k2.row_neighbor_extract_plain(*k2_args, radii=sr_rows)
    torch.cuda.synchronize()
    ny, nz, R = rs.valid.shape
    k2r_mismatch = int((ids_k != ids_p).sum()) + int((cnt_k != cnt_p).sum())
    k2r_err = max(int((ids_k - ids_p).abs().max()), int((cnt_k - cnt_p).abs().max()))
    print(f"    K2 radii at (ny, nz, R) = ({ny}, {nz}, {R}), K = {K}: {k2r_mismatch} "
          f"mismatched ids/counts, max count {int(cnt_p.max())}", flush=True)
    if k2r_mismatch != 0:
        fail(f"K2's radius variant disagrees with its plain version in {k2r_mismatch} entries")
    k2r_ms, k2r_plain_ms = alternate(lambda: k2.row_neighbor_extract(*k2_args, radii=sr_rows),
                                     lambda: k2.row_neighbor_extract_plain(*k2_args,
                                                                           radii=sr_rows),
                                     torch, 10, 1, rounds=2)
    k2r_bound, k2r_pairs, k2r_old = k2_bound(rs, (pcfg.box_size,) * 3, cutoff, K, sr_rows,
                                             torch)
    k2r_dev_ms = queued_ms(lambda: k2.row_neighbor_extract(*k2_args, radii=sr_rows), torch)
    print(f"    K2 radii {k2r_ms:.4f} ms (device time per launch {k2r_dev_ms:.4f} ms), "
          f"plain {k2r_plain_ms:.4f} ms, bound {k2r_bound[0]:.4f} ms ({k2r_bound[1]}; "
          f"{k2r_ms / k2r_bound[0]:.1f}x), {k2r_pairs:.0f} ordered pairs within the cut in "
          f"x; the first design's count over every occupied candidate: "
          f"{k2r_old[0]:.4f} ms, {k2r_old[1]}", flush=True)
    del ids_k, ids_p, cnt_k, cnt_p, rs, sr_rows, psim, pst

    # ---- 28. the polydisperse LCP line in float64, card vs CPU -------------
    small = dict(num_spheres=2000, box_size=20.0, radius=0.5, dt=1e-3, diffusion_coeff=0.01,
                 constraint_buffer=0.45, polydispersity=0.5, dtype="float64")
    pos0 = torch.rand((2000, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(28)) * 20.0
    trace = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        ssim = LCPSpheresSim(LCPSpheresConfig(**small), device=d)
        s = ssim.init(pos=pos0, key_words=(0, 28))
        rows_ = []
        for _ in range(30):
            s = ssim.run_block(s, 1, resize=False)
            rows_.append((s.lcp_iters, int(s.act_count), int(s.act_block_max),
                          s.rebuild_count, bool(s.overflow)))
        trace[name] = (rows_, s.pos.cpu(), ssim.max_overlap(s))
    diff = (trace["card"][1] - trace["cpu"][1]).abs().max().item()
    print(f"[28] polydisperse LCP float64 2000 spheres, 30 steps: rebuilds "
          f"{trace['card'][0][-1][3]} (cpu {trace['cpu'][0][-1][3]}), max|pos diff| vs cpu "
          f"{diff:.3e}, max overlap {trace['card'][2]:.3e}", flush=True)
    print(f"    lcp_iters card {[r[0] for r in trace['card'][0]]}", flush=True)
    if not (trace["card"][0] == trace["cpu"][0] and diff <= 1e-8
            and trace["card"][0][-1][3] >= 2):
        fail("the polydisperse float64 LCP run on the card disagrees with the CPU run")
    return [
        {"name": "row_hertzian_forces", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_hertz.cu",
         "replaces": "mundy_tpu/ops/pallas/row_hertz.py:101", "launches": k6_launches,
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "library_ms": None},
        {"name": "strided_onehot_t", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/seg_onehot.cu",
         "replaces": "mundy_tpu/ops/pallas/seg_onehot.py:120", "launches": k3t_launches,
         "max_abs_err": k3t_err, "ms": k3t_ms, "plain_ms": k3t_plain_ms,
         "bound_ms": k3t_bound[0], "bound_by": k3t_bound[1], "library_ms": None},
        {"name": "row_neighbor_extract (search radii)", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_extract.cu",
         "replaces": "mundy_tpu/ops/pallas/row_extract.py:210", "launches": k2r_launches,
         "max_abs_err": k2r_err, "ms": k2r_ms, "plain_ms": k2r_plain_ms,
         "bound_ms": k2r_bound[0], "bound_by": k2r_bound[1], "library_ms": None}]


def lcp_hydro_phases(torch, dev, card: str) -> dict:
    """Phases 29-31: the LCP line's hydro modes (config #2 with RPY
    mobility). Returns each kernel's launches on the two 100k paths of
    [29], counted from the sim's construction to its last step, for the
    kernels line."""
    import numpy as np

    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.mobility import ewald, spectral
    from mundy_tpu_torch.neighbor.cells3d import build_cells3d
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import se_grid as k5
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    counters = {"row_neighbor_extract": (k2.row_neighbor_extract, "launches"),
                "strided_onehot_segment_sum": (k3.strided_onehot_segment_sum, "launches"),
                "se_spread": (k5.se_spread, "launches"),
                "se_interp": (k5.se_interp, "launches")}
    paths = {name: {} for name in counters}

    # ---- 29. the 100k YAML with hydro rpy_neighbors and rpy_spectral -------
    raw = load_yaml(os.path.join(HERE, "examples", "lcp_spheres_100k.yaml"))
    for hydro, steps in (("rpy_neighbors", HYDRO_STEPS), ("rpy_spectral", SPECTRAL_STEPS)):
        cfg = config_from_dict(LCPSpheresConfig, dict(raw["params"], hydro=hydro))
        for fn_, attr in counters.values():
            setattr(fn_, attr, 0)
        t0 = time.perf_counter()
        sim = LCPSpheresSim(cfg, device=dev)
        broad = [0]
        broad_phase = sim._broad_phase

        def counted(pos, broad_phase=broad_phase, broad=broad):
            broad[0] += 1
            return broad_phase(pos)

        sim._broad_phase = counted
        st = sim.init()
        torch.cuda.synchronize()
        extra = ""
        if sim.spectral is not None:
            g3 = sim.hydro_cells_grid
            extra = (f"; G {sim.spectral.grid_n}, P {sim.spectral.support}, r_cut "
                     f"{sim.spectral.base.r_cut:.4f}, se R {sim.se_geom.R}, hydro cells "
                     f"{g3.nx}^3 x {g3.capacity}")
        print(f"[29] 100k LCP {hydro} ({cfg.dtype}): sim and init in "
              f"{time.perf_counter() - t0:.2f} s, act_window {sim.act_window}, active "
              f"{int(st.act_count)}{extra}", flush=True)
        iters, ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sim.run_block(st, 1, resize=False)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            iters.append(st.lcp_iters)
        got = {name: getattr(fn_, attr) for name, (fn_, attr) in counters.items()}
        for name, n in got.items():
            paths[name][f"lcp {hydro} 100k"] = n
        applies = sum(i + 2 for i in iters)  # g0, one per iteration, the final velocity
        print(f"    {steps} steps: ms/step {[round(m, 3) for m in ms]}, BBPGD iterations "
              f"{iters} ({sum(ms) / applies:.3f} ms per BBPGD iteration: step time over "
              f"iterations + 2), last residual "
              f"{float(st.lcp_residual):.3e} (tol {cfg.max_allowable_overlap:.1e}), max "
              f"overlap {sim.max_overlap(st):.3e}, active {int(st.act_count)}, rebuilds "
              f"{st.rebuild_count}, broad phases {broad[0]}, overflow "
              f"{bool(st.overflow)}; launches K2 {got['row_neighbor_extract']}, K3 "
              f"{got['strided_onehot_segment_sum']}, K5s {got['se_spread']}, K5i "
              f"{got['se_interp']}; {card}", flush=True)
        if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()):
            fail(f"the 100k {hydro} run overflowed or went non-finite")
        k5_want = applies if hydro == "rpy_spectral" else 0
        if (got["strided_onehot_segment_sum"] != applies
                or got["row_neighbor_extract"] != broad[0]
                or got["se_spread"] != k5_want or got["se_interp"] != k5_want):
            fail(f"the 100k {hydro} run launched {got} for {applies} mobility applies "
                 f"and {broad[0]} broad phases")
        # each kernel of this path against its plain version at this path's
        # sizes: K3 on the next step's active subset, K5s and K5i on the
        # final positions' binning (as [8] and [20] hold them at 1M)
        values, loc, n_act = k3_window_inputs(sim, st, cfg.num_spheres, 29, torch)
        s_k = k3.strided_onehot_segment_sum(values, loc, sim.seg_block)
        s_p = k3.strided_segment_sum_plain(values, loc, sim.seg_block)
        torch.cuda.synchronize()
        n_sorted = int((loc[:, 1:] >= loc[:, :-1]).all(1).sum())
        print(f"    K3 at (nb, W, B) = {tuple(loc.shape) + (sim.seg_block,)}, {n_act} active "
              f"pairs: max|diff| {(s_k - s_p).abs().max().item():.3e}, bit-equal "
              f"{bool(torch.equal(s_k, s_p))}, {n_sorted} of {loc.shape[0]} blocks with "
              f"nondecreasing ids", flush=True)
        if not (s_p.abs().max().item() > 0 and torch.equal(s_k, s_p)):
            fail(f"K3 is not bit-equal to its plain version on the 100k {hydro} path")
        del values, loc, s_k, s_p
        f = torch.randn((cfg.num_spheres, 3), device=dev, dtype=st.pos.dtype,
                        generator=torch.Generator(dev).manual_seed(29))
        mob, _ovf = sim._mobility(st.pos, st.hydro_nmat)
        parts = [("whole apply", lambda: mob(f))]
        if sim.spectral is not None:
            geom = sim.se_geom
            pieces = spectral.se_bin_geom(geom, st.pos, sim.dtype)
            grid_k = k5.se_spread(geom, pieces, f)
            grid_p = k5.se_spread_plain(geom, pieces, f)
            ugrid = spectral._k_apply(sim.spectral, grid_p).to(f.dtype)  # as the apply does
            u_k = k5.se_interp(geom, pieces, ugrid)
            u_p = k5.se_interp_plain(geom, pieces, ugrid)
            torch.cuda.synchronize()
            s_err, gmax = (grid_k - grid_p).abs().max().item(), grid_p.abs().max().item()
            i_err, umax = (u_k - u_p).abs().max().item(), u_p.abs().max().item()
            print(f"    K5s at {int(pieces[3].sum())} binned bodies in "
                  f"{pieces[0].shape[0]} tiles of R = {geom.R}, G {geom.G}: max|diff| "
                  f"{s_err:.3e} of max|grid| {gmax:.3e}; K5i max|diff| {i_err:.3e} of "
                  f"max|u| {umax:.3e}, overflow {bool(pieces[1])}", flush=True)
            if not (gmax > 0 and math.isfinite(s_err) and s_err <= 1e-5 * gmax):
                fail(f"K5s disagrees with its plain version on the 100k {hydro} path: "
                     f"{s_err} > 1e-5 * {gmax}")
            if not (umax > 0 and math.isfinite(i_err) and i_err <= 1e-5 * umax):
                fail(f"K5i disagrees with its plain version on the 100k {hydro} path: "
                     f"{i_err} > 1e-5 * {umax}")
            del grid_k, grid_p, ugrid, u_k, u_p
            cells = build_cells3d(st.pos, sim.hydro_cells_grid)
            parts += [("real space (3D cells)", lambda: ewald.ewald_real_apply_cells(
                          sim.spectral.base, cells, f, (cfg.box_size,) * 3)),
                      ("wave (K5s, FFT, K5i)", lambda: spectral.se_wave_apply_dense(
                          sim.spectral, geom, st.pos, f, pieces=pieces))]
        print("    one mobility apply at the final state: " + ", ".join(
            f"{name} {cuda_ms(fn_, torch, 3):.3f} ms" for name, fn_ in parts)
            + f"; {card}", flush=True)
        del f, mob, parts
        del sim, st

    # ---- 30. the three modes in float64, card vs CPU -----------------------
    small = dict(num_spheres=150, box_size=14.0, radius=0.5, dt=2e-3, diffusion_coeff=0.02,
                 dtype="float64", chunk=256, max_allowable_overlap=1e-6,
                 max_col_iterations=2000)
    pos0 = torch.rand((150, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(30)) * 14.0
    for hydro in ("rpy_neighbors", "rpy_ewald", "rpy_spectral"):
        trace = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            ssim = LCPSpheresSim(LCPSpheresConfig(**small, hydro=hydro), device=d)
            s = ssim.init(pos=pos0, key_words=(0, 30))
            rows_ = []
            for _ in range(HYDRO_SMALL_STEPS):
                s = ssim.run_block(s, 1, resize=False)
                rows_.append((s.lcp_iters, int(s.act_count), int(s.act_block_max),
                              s.rebuild_count, bool(s.overflow)))
            trace[name] = (rows_, s.pos.cpu(), ssim.max_overlap(s))
        diff = (trace["card"][1] - trace["cpu"][1]).abs().max().item()
        print(f"[30] LCP {hydro} float64 150 spheres, {HYDRO_SMALL_STEPS} steps: rebuilds "
              f"{trace['card'][0][-1][3]} (cpu {trace['cpu'][0][-1][3]}), max|pos diff| vs "
              f"cpu {diff:.3e}, max overlap {trace['card'][2]:.3e}, lcp_iters card "
              f"{[r[0] for r in trace['card'][0]]}", flush=True)
        if not (trace["card"][0] == trace["cpu"][0] and diff <= 1e-7
                and trace["card"][0][-1][3] >= 2 and not trace["card"][0][-1][4]):
            fail(f"the float64 LCP {hydro} run on the card disagrees with the CPU run")

    # ---- 31. the Ewald wave sum in float32 against float64 -----------------
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is allowed for float32 matmuls: the wave sum would raise")
    rng = np.random.default_rng(31)
    pos = rng.uniform(0.0, 14.0, (2000, 3))
    frc = rng.normal(size=(2000, 3))
    u = {}
    for dt_ in (torch.float64, torch.float32):
        op = ewald.build_ewald_rpy(14.0, 0.5, 1.0, xi=3.0 / 3.5, r_cut=3.5, tol=1e-4,
                                   dtype=dt_, device=dev)
        p_, f_ = (torch.as_tensor(a, dtype=dt_, device=dev) for a in (pos, frc))
        u[dt_] = (ewald.ewald_wave_apply(op, p_, f_).double(),
                  cuda_ms(lambda: ewald.ewald_wave_apply(op, p_, f_), torch, 5),
                  op.kvecs.shape[0])
    umax = u[torch.float64][0].abs().max().item()
    werr = (u[torch.float32][0] - u[torch.float64][0]).abs().max().item()
    print(f"[31] Ewald wave sum, 2000 bodies in box 14, {u[torch.float64][2]} k-modes: "
          f"float32 within {werr / umax:.3e} of float64 (max|u| {umax:.3e}); float32 "
          f"{u[torch.float32][1]:.3f} ms, float64 {u[torch.float64][1]:.3f} ms; {card}",
          flush=True)
    if not (umax > 0 and werr <= 1e-5 * umax):
        fail(f"the float32 Ewald wave sum is off the float64 one: {werr} > 1e-5 * {umax}")
    return paths


def periphery_phases(torch, dev, card: str) -> dict:
    """Phases 32-34: the HP1 periphery modes (examples/hp1_chromatin.yaml),
    times printed with `card`. Returns K5s's and K5i's launches on [33]'s
    path, for the kernels line."""
    import tracemalloc

    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.regrow import run_blocks
    from mundy_tpu_torch.geom.periodicity import free_space
    from mundy_tpu_torch.mobility import freespace, spectral
    from mundy_tpu_torch.mobility.ewald import ewald_real_apply
    from mundy_tpu_torch.mobility.periphery import no_slip_correction
    from mundy_tpu_torch.mobility.rpy import rpy_apply_dense, rpy_flow_at
    from mundy_tpu_torch.ops.kernels import se_grid as k5

    # ---- 32. the HP1 YAML as written (rpy_periphery) -----------------------
    raw = load_yaml(os.path.join(HERE, "examples", "hp1_chromatin.yaml"))
    cfg = config_from_dict(ChromatinConfig, dict(raw["params"], num_steps=YAML_STEPS))
    k5.se_spread.launches = k5.se_interp.launches = 0
    t0 = time.perf_counter()
    dsim = ChromatinSim(cfg, device=dev)
    st = dsim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    a, rp = cfg.bead_radius, cfg.periphery_radius
    print(f"[32] hp1_chromatin.yaml ({cfg.hydro}, {cfg.dtype}): {dsim.N} beads, {dsim.X} "
          f"crosslinkers, periphery radius {rp}, order {cfg.periphery_order} (Q "
          f"{dsim.periphery.points.shape[0]}); ChromatinSim() and init with M^-1 in "
          f"{init_s:.3f} s", flush=True)
    t0 = time.perf_counter()
    st = dsim.run(st, log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    step_ms = 1e3 * elapsed / cfg.num_steps
    r_max = st.pos.norm(dim=1).max().item()
    print(f"    {cfg.num_steps} steps in {elapsed:.3f} s, {step_ms:.4f} ms/step (run(), host "
          f"clock), rebuilds {st.rebuild_count}, doubly bound {dsim.doubly_bound(st)}/"
          f"{dsim.X}, overflow {bool(st.overflow)}, max|pos| {r_max:.4f} (limit "
          f"{rp + a}); launches K5s {k5.se_spread.launches}, K5i {k5.se_interp.launches}; "
          f"{card}", flush=True)
    if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()) or not r_max <= rp + a:
        fail("the HP1 rpy_periphery run overflowed, went non-finite or left the periphery")
    if st.step != cfg.num_steps or k5.se_spread.launches or k5.se_interp.launches:
        fail(f"the HP1 rpy_periphery run took {st.step} steps and launched K5s/K5i "
             f"{k5.se_spread.launches}/{k5.se_interp.launches} times")
    f = dsim._forces(st)
    per = dsim.periphery
    u_surf = rpy_flow_at(per.points, st.pos, f, a, cfg.viscosity)
    parts = [("whole apply", lambda: dsim._velocity(st, f)),
             ("dense RPY", lambda: rpy_apply_dense(st.pos, f, a, cfg.viscosity,
                                                   overlap_correction=True)),
             ("flow at the nodes", lambda: rpy_flow_at(per.points, st.pos, f, a,
                                                       cfg.viscosity)),
             ("BIE correction", lambda: no_slip_correction(per, u_surf, st.pos))]
    print("    one mobility apply at the final state: " + ", ".join(
        f"{name} {cuda_ms(fn_, torch, 5):.4f} ms" for name, fn_ in parts) + f"; {card}",
        flush=True)
    profile_window(lambda n: dsim.run_block(st, n), torch, step_ms)

    # ---- 33. the same YAML with hydro rpy_periphery_spectral ---------------
    scfg = dataclasses.replace(cfg, hydro="rpy_periphery_spectral")
    k5.se_spread.launches = k5.se_interp.launches = 0
    tracemalloc.start()
    t0 = time.perf_counter()
    ssim = ChromatinSim(scfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = tracemalloc.get_traced_memory()[1] / 1e9
    tracemalloc.stop()
    t0 = time.perf_counter()
    sst = ssim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    op, geom = ssim.freespace, ssim.fs_geom
    print(f"[33] hp1 rpy_periphery_spectral: ChromatinSim() {build_s:.3f} s (the free-space "
          f"operator's host build, peak numpy/python host allocation {peak_gb:.3f} GB by "
          f"tracemalloc), init {init_s:.3f} s; padded box {op.se.base.box:.4f}, G "
          f"{geom.G}, P {geom.P}, m {geom.m}, tile R {geom.R}, r_cut "
          f"{op.se.base.r_cut:.4f}, hydro K {ssim.fs_hydro_K}, hydro cells "
          f"{ssim.fs_cell_capacity}", flush=True)
    warm_log = []
    sst = run_blocks(ssim, sst, 2, 2, log=warm_log.append)
    torch.cuda.synchronize()
    for line in warm_log:
        print(f"    {line}", flush=True)
    warm = (k5.se_spread.launches, k5.se_interp.launches)
    geom = ssim.fs_geom
    regrows = sum("regrow" in line for line in warm_log)
    print(f"    after the warm-up ({regrows} regrows): tile R {ssim.fs_geom.R}, hydro K "
          f"{ssim.fs_hydro_K}, hydro cells {ssim.fs_cell_capacity}, contact K "
          f"{ssim.contact_K}, kmc K {ssim.kmc_K}", flush=True)
    if regrows:
        fail("HP1 rpy_periphery_spectral regrew after init's right-sizing")
    rb0 = sst.rebuild_count
    k5.se_spread.launches = k5.se_interp.launches = 0
    t0 = time.perf_counter()
    sst = ssim.run_block(sst, HP1_SPECTRAL_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    s_launches, i_launches = k5.se_spread.launches, k5.se_interp.launches
    spec_ms = 1e3 * elapsed / HP1_SPECTRAL_STEPS
    r_max = sst.pos.norm(dim=1).max().item()
    print(f"    {HP1_SPECTRAL_STEPS} steps in {elapsed:.3f} s, {spec_ms:.4f} ms/step "
          f"(run_block, host clock), rebuilds {sst.rebuild_count - rb0}, doubly bound "
          f"{ssim.doubly_bound(sst)}/{ssim.X}, overflow {bool(sst.overflow)}, max|pos| "
          f"{r_max:.4f}; launches K5s {s_launches}, K5i {i_launches} (warm-up {warm}); "
          f"{card}", flush=True)
    if bool(sst.overflow) or not bool(torch.isfinite(sst.pos).all()) or not r_max <= rp + a:
        fail("the HP1 rpy_periphery_spectral window overflowed, went non-finite or left "
             "the periphery")
    if s_launches != HP1_SPECTRAL_STEPS or i_launches != HP1_SPECTRAL_STEPS:
        fail(f"K5s/K5i launched {s_launches}/{i_launches} times in {HP1_SPECTRAL_STEPS} "
             "steps")
    path = {"se_spread": warm[0] + s_launches, "se_interp": warm[1] + i_launches}
    profile_window(lambda n: ssim.run_block(sst, n), torch, spec_ms)
    f = ssim._forces(sst)
    pieces = spectral.se_bin_geom(geom, freespace._shift(op, sst.pos), torch.float32)
    u_surf = rpy_flow_at(ssim.periphery.points, sst.pos, f, a, cfg.viscosity)
    metric = free_space(torch.float32, dev)
    parts = [("whole apply", lambda: ssim._velocity(sst, f)),
             ("real space", lambda: ewald_real_apply(op.se.base, sst.pos, f, sst.hydro_nmat,
                                                     metric)),
             ("wave (binning, K5s, FFT, K5i)", lambda: freespace.freespace_wave_apply_dense(
                 op, geom, sst.pos, f)),
             ("wave on a binning (K5s, FFT, K5i)", lambda: freespace.freespace_wave_apply_dense(
                 op, geom, sst.pos, f, pieces=pieces)),
             ("flow at the nodes + BIE", lambda: no_slip_correction(
                 ssim.periphery, rpy_flow_at(ssim.periphery.points, sst.pos, f, a,
                                             cfg.viscosity), sst.pos))]
    print("    one mobility apply at the final state: " + ", ".join(
        f"{name} {cuda_ms(fn_, torch, 5):.4f} ms" for name, fn_ in parts) + f"; {card}",
        flush=True)
    # K5s and K5i against their plain versions on the final binning
    perm, ovf, u, valid, slot_of = pieces
    n_valid = int(valid.sum())
    n_neg = int((u[valid] < 0).any(dim=1).sum())
    grid_k = k5.se_spread(geom, pieces, f)
    grid_p = k5.se_spread_plain(geom, pieces, f)
    ugrid = freespace._k_apply_free(op, grid_p)  # the planar layout, as the apply passes it
    u_k = k5.se_interp(geom, pieces, ugrid)
    u_p = k5.se_interp_plain(geom, pieces, ugrid)
    torch.cuda.synchronize()
    s_err, gmax = (grid_k - grid_p).abs().max().item(), grid_p.abs().max().item()
    i_err, umax = (u_k - u_p).abs().max().item(), u_p.abs().max().item()
    # K5i's float32 sums cancel here: the deconvolved free-space grid holds
    # ~1e5 at Nyquist where u is ~1e2, so a reordered float32 sum is held
    # per bead against the magnitude of its own P^3 summands, h^3 sum|w v|,
    # and both float32 sums against the float64 interpolation of the same
    # grid on the same binning: K5i no farther from it than the plain version
    sel = slot_of.long()
    idx, wt = k5._support(geom, u.reshape(-1, 3)[sel])
    summands = ((wt[..., None] * ugrid.reshape(-1, 3)[idx.reshape(-1)].reshape(idx.shape + (3,)))
                .abs().sum(dim=(1, 2, 3)) * (geom.box / geom.G) ** 3)
    i_rel = ((u_k - u_p).abs() / summands.clamp(min=1e-30)).max().item()
    del idx, wt
    p64 = (perm, ovf, u.double(), valid, slot_of)
    u_exact = k5.se_interp_plain(geom, p64, ugrid.double())
    k_exact = (u_k.double() - u_exact).abs().max().item()
    p_exact = (u_p.double() - u_exact).abs().max().item()
    del u_exact
    # and both kernels in float64 on the same binning and grid: the sums'
    # order apart, nothing cancels beyond float64's reach
    f64, ugrid64 = f.double(), freespace._k_apply_free(op, grid_p.double())
    s64 = (k5.se_spread(geom, p64, f64) - k5.se_spread_plain(geom, p64, f64)).abs().max().item()
    u64 = k5.se_interp_plain(geom, p64, ugrid64)
    i64 = (k5.se_interp(geom, p64, ugrid64) - u64).abs().max().item()
    u64max = u64.abs().max().item()
    del p64, f64, ugrid64, u64
    print(f"    K5s at {n_valid} binned beads in {perm.shape[0]} tiles of R = {geom.R} ({n_neg} "
          f"with u < 0 on some axis), G {geom.G}, P {geom.P}, m {geom.m}: max|diff| "
          f"{s_err:.3e} of max|grid| {gmax:.3e}; K5i max|diff| {i_err:.3e} of max|u| "
          f"{umax:.3e} ({i_err / umax:.3e}; max|ugrid| {ugrid.abs().max().item():.3e}, per "
          f"bead at most {i_rel:.3e} of its summands' magnitude, max "
          f"{summands.max().item():.3e}); off the float64 interpolation of the same grid: "
          f"K5i {k_exact:.3e}, plain {p_exact:.3e}; float64 K5s {s64:.3e} of max|grid|, K5i "
          f"{i64:.3e} of max|u| {u64max:.3e}; overflow {bool(ovf)}", flush=True)
    if not (gmax > 0 and math.isfinite(s_err) and s_err <= 1e-5 * gmax):
        fail(f"K5s disagrees with its plain version on the HP1 path: {s_err} > 1e-5 * {gmax}")
    if not (umax > 0 and math.isfinite(i_err) and i_rel <= 1e-6):
        fail(f"K5i disagrees with its plain version on the HP1 path: {i_rel} > 1e-6 of its "
             "summands' magnitude")
    if not k_exact <= 1.25 * p_exact:
        fail(f"K5i is farther from the float64 interpolation than its plain version: "
             f"{k_exact} > 1.25 * {p_exact}")
    if not (s64 <= 1e-12 * gmax and i64 <= 1e-12 * u64max):
        fail(f"K5s/K5i in float64 disagree with their plain versions on the HP1 path: "
             f"{s64}, {i64}")
    del grid_k, u_k, summands
    s_ms, s_plain_ms = alternate(lambda: k5.se_spread(geom, pieces, f),
                                 lambda: k5.se_spread_plain(geom, pieces, f), torch, 10, 3,
                                 rounds=2)
    i_ms, i_plain_ms = alternate(lambda: k5.se_interp(geom, pieces, ugrid),
                                 lambda: k5.se_interp_plain(geom, pieces, ugrid), torch, 10,
                                 3, rounds=2)
    sel = valid.reshape(-1).nonzero()[:, 0]
    idx, wt = k5._support(geom, u.reshape(-1, 3)[sel])
    vals = (wt[..., None] * f[perm.reshape(-1)[sel].long()][:, None, None, None, :])
    idx, vals = idx.reshape(-1), vals.reshape(-1, 3)
    acc = torch.zeros((geom.G ** 3, 3), device=dev)
    s_lib_ms = statistics.median(
        [cuda_ms(lambda: acc.index_add_(0, idx, vals), torch, 5) for _ in range(3)])
    del idx, vals, wt, acc
    grid_bytes = grid_p.numel() * 4
    s_bound = bound(n_valid * k5_ops(geom.P),
                    perm.numel() * 4 + n_valid * 12 + f.numel() * 4 + grid_bytes)
    i_bound = bound(n_valid * (k5_ops(geom.P) + 3),
                    slot_of.numel() * 4 + n_valid * 12 + grid_bytes + u_p.numel() * 4)
    print(f"    K5s {s_ms:.4f} ms, plain {s_plain_ms:.4f} ms, index_add_ {s_lib_ms:.4f} ms, "
          f"bound {s_bound[0]:.4f} ms ({s_bound[1]}, {s_ms / s_bound[0]:.1f}x); K5i "
          f"{i_ms:.4f} ms, plain {i_plain_ms:.4f} ms, bound {i_bound[0]:.4f} ms "
          f"({i_bound[1]}, {i_ms / i_bound[0]:.1f}x); {card}", flush=True)
    del grid_p, ugrid, u_p, pieces
    # the spectral velocity against [32]'s dense operator at the same state
    u_spec, _ = ssim._velocity(sst, f)
    u_dense, _ = dsim._velocity(sst, f)
    verr, vmax = (u_spec - u_dense).abs().max().item(), u_dense.abs().max().item()
    print(f"    velocity at the final state vs the dense operator: max|diff| {verr:.3e} of "
          f"max|u| {vmax:.3e} ({verr / vmax:.3e})", flush=True)
    if not (vmax > 0 and verr <= 2e-3 * vmax):
        fail(f"the spectral periphery velocity is off the dense one: {verr} > 2e-3 * {vmax}")
    del dsim, st, ssim, sst, f, u_surf, parts

    # ---- 34. both modes in float64, card vs CPU ----------------------------
    small = dict(num_chains=2, beads_per_chain=48, bead_radius=0.5, num_crosslinkers=16,
                 periphery_radius=8.0, periphery_order=8, diffusion_coeff=0.002, dt=2e-4,
                 skin=0.03, binding_rate=50.0, unbinding_rate=5.0, max_neighbors=64,
                 cell_capacity=64, chunk=256, dtype="float64")
    for hydro in ("rpy_periphery", "rpy_periphery_spectral"):
        trace = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            psim = ChromatinSim(ChromatinConfig(**small, hydro=hydro), device=d)
            s = psim.init()
            rows_ = []
            for _ in range(PERIPHERY_SMALL_STEPS):
                s = psim.run_block(s, 1)
                rows_.append((s.rebuild_count, bool(s.overflow), s.xl_state.cpu().tolist()))
            trace[name] = (rows_, s.pos.cpu(), psim.doubly_bound(s))
        (tg, pg, dbound), (tc, pc, _) = trace["card"], trace["cpu"]
        diff = (pg - pc).abs().max().item()
        print(f"[34] {hydro} float64 2 x 48 beads, {PERIPHERY_SMALL_STEPS} steps: rebuilds "
              f"{tg[-1][0]} (cpu {tc[-1][0]}), doubly bound {dbound}, max|pos diff| vs cpu "
              f"{diff:.3e}", flush=True)
        if not (tg == tc and diff <= 1e-7 and tg[-1][0] >= 2 and not tg[-1][1]):
            fail(f"the float64 {hydro} run on the card disagrees with the CPU run")
    return path


def run_cli(argv: list) -> list:
    """mundy_tpu_torch.driver.main.main(argv) in this process, its standard
    output captured; returns its lines. Fails unless it returns 0."""
    import contextlib
    import io

    from mundy_tpu_torch.driver.main import main as cli_main

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
    except BaseException as e:  # noqa: BLE001 (print what it said, then fail)
        print(buf.getvalue()[-4000:], flush=True)
        fail(f"main({argv}) raised {type(e).__name__}: {e}")
    lines = buf.getvalue().splitlines()
    if rc != 0:
        print("\n".join(lines[-20:]), flush=True)
        fail(f"main({argv}) returned {rc}")
    return lines


def checkpoint_arrays(directory: str, step: int) -> dict:
    import numpy as np

    with np.load(os.path.join(directory, f"ckpt_{step:012d}.npz")) as d:
        return {k: d[k] for k in d.files}


def cli_phases(torch, dev, card: str, row_ms: float) -> dict:
    """Phases 35-38: every example YAML through the port's CLI on the card,
    the flat SpheresSim at 1M, the flat engine and granular in float64
    against the CPU, and checkpoint continuation through the CLI. `row_ms`
    is [5]'s ms/step of the row engine. Returns the kernel launches each
    YAML made, by kernel entry name."""
    import shutil

    import numpy as np

    from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim
    from mundy_tpu_torch.io import native
    from mundy_tpu_torch.io.trajectory import TrajectoryReader
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import row_segments as k4
    from mundy_tpu_torch.ops.kernels import se_grid as k5
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    work = os.path.join(HERE, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counters = {"K2": (k2.row_neighbor_extract, "row_neighbor_extract"),
                "K3": (k3.strided_onehot_segment_sum, "strided_onehot_segment_sum"),
                "K4": (k4.row_segment_pairs_sym, "row_segment_pairs_sym"),
                "K5s": (k5.se_spread, "se_spread"), "K5i": (k5.se_interp, "se_interp")}
    paths = {}

    # ---- 35. every example YAML through main() -----------------------------
    for name, sets, every, need in CLI_RUNS:
        yaml = os.path.join(HERE, "examples", f"{name}.yaml")
        argv = [yaml, "--device", "cuda"] + (["--set", *sets] if sets else [])
        out = os.path.join(work, name)
        if every is not None:
            argv += ["--output-dir", out, "--output-every", str(every)]
        for fn, _ in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lines = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, (fn, _) in counters.items()}
        stepped = next((ln for ln in lines if ln.startswith("stepped ")), "")
        regrow = sum("regrow" in ln for ln in lines)
        print(f"[35] {name}{' ' + ' '.join(sets) if sets else ''}: rc 0, {stepped}, "
              f"{wall:.2f} s with init, {regrow} regrows; launches "
              f"{', '.join(f'{k} {v}' for k, v in got.items())}; {card}", flush=True)
        for k in need:
            if got[k] == 0:
                fail(f"{name} through the CLI launched {k} no time")
        for k, v in got.items():
            paths.setdefault(counters[k][1], {})[f"cli {name}"] = v
        if every is not None:
            total = int(next(ln for ln in lines if ln.startswith("step ")).split("/")[1])
            with TrajectoryReader(os.path.join(out, "trajectory.mtrj")) as r:
                frames, n = r.num_frames, r.n
                last = r.read(frames - 1)
            vtk = open(os.path.join(out, "final.vtk")).read().splitlines()
            print(f"    {frames} trajectory frames of {n} bodies (last at step {last[0]}), "
                  f"final.vtk {vtk[4]}", flush=True)
            if not (frames == total // every + 1 and last[0] == total
                    and np.isfinite(last[2]).all() and vtk[4] == f"POINTS {n} float"):
                fail(f"{name}: {frames} frames (want {total // every + 1}) or a bad final.vtk")
    lib = native.library()
    if lib is None or not native.library_path().exists():
        fail("the native IO library did not build on this machine")
    print(f"    native IO library {native.library_path().name} loaded", flush=True)

    # ---- 36. the flat SpheresSim at 1M, config #1's physics -----------------
    big = bench_config(SpheresConfig, N_BIG)
    t0 = time.perf_counter()
    sim = SpheresSim(big, device=dev)
    st = sim.init()
    st = sim.run_block(st, 3)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rb0 = st.rebuild_count
    t0 = time.perf_counter()
    st = sim.run_block(st, FLAT_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    flat_ms = 1e3 * elapsed / FLAT_STEPS
    print(f"[36] flat SpheresSim at 1M (config #1's physics, cells {sim.grid.dims}, K "
          f"{big.max_neighbors}, cell capacity {big.cell_capacity}): init + 3 steps "
          f"{init_s:.2f} s, {FLAT_STEPS} steps in {elapsed:.3f} s = {flat_ms:.3f} ms/step, "
          f"rebuilds {st.rebuild_count - rb0}, overflow {bool(st.overflow)}; the row "
          f"engine at [5] {row_ms:.3f} ms/step ({flat_ms / row_ms:.1f}x); {card}", flush=True)
    if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()):
        fail("the 1M flat SpheresSim overflowed or went non-finite")
    profile_window(lambda n: sim.run_block(st, n), torch, flat_ms)
    del sim, st

    # ---- 37. float64 on the card against the CPU -----------------------------
    small = SpheresConfig(num_spheres=2000, box_size=16.0, diffusion_coeff=0.01,
                          dt=1e-4, skin=0.1, dtype="float64")
    pos0 = torch.rand((2000, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5)) * 16.0
    for p in (0.0, 0.4):
        cfg = dataclasses.replace(small, polydispersity=p)
        runs = {}
        for d in ("cuda", "cpu"):
            sim = SpheresSim(dataclasses.replace(cfg), device=d)
            st = sim.run_block(sim.init(pos=pos0), 60)
            runs[d] = (st.rebuild_count, st.pos.cpu(), st.nmat.idx.cpu())
        diff = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
        same_nmat = bool(torch.equal(runs["cuda"][2], runs["cpu"][2]))
        print(f"[37] flat SpheresSim float64 2000 spheres (polydispersity {p}), 60 steps: "
              f"rebuilds {runs['cuda'][0]} (cpu {runs['cpu'][0]}), max|pos diff| vs cpu "
              f"{diff:.3e}, neighbor matrix equal {same_nmat}", flush=True)
        if not (runs["cuda"][0] == runs["cpu"][0] >= 3 and diff <= 1e-7):
            fail("the float64 flat SpheresSim on the card disagrees with the CPU run")
    gcfg = GranularConfig(num_spheres=500, box_size=10.0, dt=5e-4, normal_damping=100.0,
                          tang_damping=50.0, dtype="float64", cell_capacity=32,
                          max_neighbors=32, pair_capacity_per_body=16)
    rng = np.random.default_rng(7)
    gpos = np.column_stack([rng.uniform(1.0, 9.0, (500, 2)), rng.uniform(0.6, 8.0, 500)])
    runs = {}
    for d in ("cuda", "cpu"):
        sim = GranularSim(dataclasses.replace(gcfg), device=d)
        st = sim.run_block(sim.init(pos=torch.from_numpy(gpos)), 300)
        runs[d] = (st.rebuild_count, st.pos.cpu(), bool(st.overflow),
                   sim.kinetic_energy(st))
    diff = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    print(f"[37] granular float64 500 spheres, 300 steps: rebuilds {runs['cuda'][0]} (cpu "
          f"{runs['cpu'][0]}), max|pos diff| vs cpu {diff:.3e}, KE {runs['cuda'][3]:.6e} "
          f"(cpu {runs['cpu'][3]:.6e}), overflow {runs['cuda'][2]}", flush=True)
    if not (runs["cuda"][0] == runs["cpu"][0] >= 3 and diff <= 1e-7 and not runs["cuda"][2]):
        fail("the float64 granular run on the card disagrees with the CPU run")

    # ---- 38. checkpoint continuation through the CLI -------------------------
    half = RESUME_STEPS // 2
    for name in ("spheres_10k", "granular_settling"):
        yaml = os.path.join(HERE, "examples", f"{name}.yaml")
        a, b, c = (os.path.join(work, f"resume_{name}_{x}") for x in "abc")
        t0 = time.perf_counter()
        for ck in (a, c):  # two uninterrupted runs, checkpoints at the half and the end
            run_cli([yaml, "--device", "cuda", "--set", f"num_steps={RESUME_STEPS}",
                     "--checkpoint-dir", ck, "--checkpoint-every", str(half)])
        run_cli([yaml, "--device", "cuda", "--set", f"num_steps={half}", "--checkpoint-dir", b])
        lines = run_cli([yaml, "--device", "cuda", "--set", f"num_steps={RESUME_STEPS}",
                         "--checkpoint-dir", b, "--continue"])
        if not any(ln.startswith("resumed from") for ln in lines):
            fail(f"{name}: --continue did not resume")
        fa, fb, fc = (checkpoint_arrays(x, RESUME_STEPS) for x in (a, b, c))
        resumed = fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)
        repeat = fa.keys() == fc.keys() and all(np.array_equal(fa[k], fc[k]) for k in fa)
        print(f"[38] {name} (float32): {RESUME_STEPS} steps straight vs {half} + --continue "
              f"{half}: {len(fa)} leaves bit-equal {resumed}; a second straight run bit-equal "
              f"{repeat} ({time.perf_counter() - t0:.2f} s for the four runs)", flush=True)
        if not (resumed and repeat):
            fail(f"{name}: the resumed or the repeated run is not bit-equal")
    return paths


def final_state(directory: str) -> dict:
    """The leaves of the last checkpoint in `directory`, by field path."""
    from mundy_tpu_torch.io import latest_checkpoint
    import numpy as np

    with np.load(latest_checkpoint(directory)) as d:
        return {k.split("|", 1)[1]: d[k] for k in d.files}


def inner_steps(sim, state):
    """run(n): n steps of `sim` from `state` with no rebuild (its
    _inner_step), for profile_window: the steady step between rebuilds."""
    def run(n):
        s = state
        for _ in range(n):
            s = sim._inner_step(s)
        return s
    return run


def rods_nmat_phases(torch, dev, card: str) -> dict:
    """Phases 39-42: the (N, K) RodsSim at examples/rods_100k.yaml through
    the CLI (the spherocylinder narrow phase with engine=nmat, K2 at K 32
    held against its plain version and the cell list on the final state;
    then friction), the ellipsoid narrow phase at
    benchmarks/ellipsoid_bench.py's shape, and the three narrow phases in
    float64 against the CPU. Returns K2's launches on the paths [39] and
    [40] drove, and its measurements at [39]'s shape."""
    import shutil

    import numpy as np

    from mundy_tpu_torch.driver.apps.rods import RodsConfig, RodsSim
    from mundy_tpu_torch.driver.configurator import build_simulation_from_yaml
    from mundy_tpu_torch.neighbor.cell_list import build_cell_list, neighbor_matrix
    from mundy_tpu_torch.neighbor.rows import build_rows, neighbor_matrix_rows
    from mundy_tpu_torch.ops.kernels import row_extract as k2

    work = os.path.join(HERE, "build", "rods_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    yaml = os.path.join(HERE, "examples", "rods_100k.yaml")
    out = {"paths": {}}

    # ---- 39. the spherocylinder nmat engine at rods_100k.yaml ----------------
    # ---- 40. friction at the same YAML (the CLI's route to RodsSim) ----------
    for phase, sets in (("39", ("engine=nmat", f"num_steps={RODS_NMAT_STEPS}")),
                        ("40", ("friction=true", f"num_steps={RODS_NMAT_STEPS}"))):
        ck = os.path.join(work, f"ck{phase}")
        k2.row_neighbor_extract.launches = 0
        t0 = time.perf_counter()
        lines = run_cli([yaml, "--device", dev.type, "--set", *sets, "--checkpoint-dir", ck])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k2.row_neighbor_extract.launches
        st = final_state(ck)
        stepped = next((ln for ln in lines if ln.startswith("stepped ")), "")
        regrows = sum("regrow" in ln for ln in lines)
        rebuilds = int(st["rebuild_count"])
        print(f"[{phase}] rods_100k {' '.join(sets)} through the CLI: {stepped}, {wall:.2f} s "
              f"with init, rebuilds {rebuilds}, regrows {regrows}, K2 launches {launches}"
              + (f", largest |tangential history| {np.abs(st['tang']).max():.6e}"
                 if phase == "40" else "") + f"; {card}", flush=True)
        if not (np.isfinite(st["pos"]).all() and not bool(st["overflow"])):
            fail(f"[{phase}] the rods_100k nmat run went non-finite or overflowed")
        # one launch per neighbor build: init's, each rebuild's, each
        # regrow's (a block retried after a regrow launched for its rebuilds
        # too, and the state kept none of them)
        if launches == 0 or (launches != rebuilds if regrows == 0
                             else launches < rebuilds + regrows):
            fail(f"[{phase}] K2 launched {launches} times for {rebuilds} builds and "
                 f"{regrows} regrows")
        out["paths"][f"rods_100k nmat [{phase}]" if phase == "39"
                     else f"rods_100k friction [{phase}]"] = launches
        if phase != "39":
            continue
        # K2 on the final state at the path's shape, bit-equal to its plain
        # version; the neighbor sets equal to the cell list's
        _cfg, sim = build_simulation_from_yaml(yaml, {"engine": "nmat"}, device=dev)
        c = sim.config
        rg = sim._row_grid()
        if rg is None:
            fail("[39] rods_100k with engine=nmat did not take the rows broad phase (K2)")
        pos = torch.from_numpy(st["pos"]).to(dev)
        rs = build_rows(pos, torch.arange(c.num_rods, dtype=torch.int32, device=dev), rg)
        cutoff, K = 2 * float(sim.search_radius), c.max_neighbors
        box = ((c.box_size,) * 3, (True,) * 3)
        k2_args = (rs.pos, rs.gid, rs.valid, box, cutoff, K, c.num_rods)
        ids_k, cnt_k = k2.row_neighbor_extract(*k2_args)
        ids_p, cnt_p = k2.row_neighbor_extract_plain(*k2_args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(ids_k, ids_p) and torch.equal(cnt_k, cnt_p))
        rows_nm = neighbor_matrix_rows(pos, float(sim.search_radius), (c.box_size,) * 3,
                                       max_neighbors=K, grid=rg)
        cells_nm = neighbor_matrix(pos, build_cell_list(pos, sim.grid, c.cell_capacity),
                                   sim.search_radius, metric=sim.metric, max_neighbors=K,
                                   chunk=min(c.chunk, max(256, c.num_rods)))
        same_sets = bool(torch.equal(torch.sort(rows_nm.idx.long(), dim=1).values,
                                     torch.sort(cells_nm.idx.long(), dim=1).values))
        ny, nz, R = rs.valid.shape
        print(f"    K2 at (ny, nz, R) = ({ny}, {nz}, {R}), K = {K}: torch.equal to its plain "
              f"version {equal}, max count {int(cnt_p.max())}, mean "
              f"{cnt_p[rs.valid].float().mean().item():.3f}; neighbor sets equal to the cell "
              f"list's {same_sets} (overflow rows {bool(rows_nm.overflow)}, cells "
              f"{bool(cells_nm.overflow)})", flush=True)
        if not equal:
            fail("[39] K2 disagrees with its plain version at the rods nmat shape")
        if not same_sets or bool(rows_nm.overflow) or bool(cells_nm.overflow):
            fail("[39] the row and cell-list neighbor sets differ at the final state")
        ms, plain_ms = alternate(lambda: k2.row_neighbor_extract(*k2_args),
                                 lambda: k2.row_neighbor_extract_plain(*k2_args), torch, 10, 1,
                                 rounds=2)
        dev_ms = queued_ms(lambda: k2.row_neighbor_extract(*k2_args), torch)
        b, pairs, _old = k2_bound(rs, (c.box_size,) * 3, cutoff, K, None, torch)
        print(f"    K2 {ms:.4f} ms (device time per launch {dev_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; {ms / b[0]:.1f}x), "
              f"{pairs:.0f} ordered pairs within the cut in x; {card}", flush=True)
        out["k2"] = dict(ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, bound=b, shape=(ny, nz, R, K))
        del ids_k, ids_p, cnt_k, cnt_p, rs, rows_nm, cells_nm
        # where a step between rebuilds goes (the sim from the YAML's init)
        step_ms = float(stepped.split("(")[1].split(" ms/step")[0])
        profile_window(inner_steps(sim, sim.init()), torch, step_ms)
        del sim

    # ---- 41. the ellipsoid narrow phase at ellipsoid_bench.py's shape --------
    n = ELLIPSOID_RODS
    ecfg = RodsConfig(num_rods=n, box_size=float(max(40.0, (n / 8.0) ** (1 / 3) * 6)),
                      radius=0.25, length=1.5, shape="ellipsoid", engine="nmat", dt=2e-4,
                      dtype="float32", ellipsoid_pgd_iters=24, ellipsoid_refine_iters=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    esim = RodsSim(ecfg, device=dev)
    est = esim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pairs = n * ecfg.max_neighbors

    def narrow_ms(warm: bool) -> float:
        seed = est.warm_n
        esim._contact_forces_torques_ellipsoid(est.pos, est.quat, est.nmat,
                                               warm_n=seed if warm else None)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(8):
            _f, _t, nrm = esim._contact_forces_torques_ellipsoid(
                est.pos, est.quat, est.nmat, warm_n=seed if warm else None)
            seed = nrm
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 8

    cold_ms, warm_ms = narrow_ms(False), narrow_ms(True)
    rb0 = est.rebuild_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = esim.run_block(est, ELLIPSOID_STEPS)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / ELLIPSOID_STEPS
    print(f"[41] ellipsoid narrow phase, {n} rods (length 1.5, radius 0.25, box "
          f"{ecfg.box_size:.2f}, K {ecfg.max_neighbors}, rows broad phase "
          f"{esim.broad_phase() == 'rows'}), init {init_s:.2f} s: cold (PGD "
          f"{ecfg.ellipsoid_pgd_iters} x 7 starts + L-BFGS {ecfg.ellipsoid_refine_iters}) "
          f"{cold_ms:.3f} ms = {1e6 * cold_ms / pairs:.1f} ns per candidate pair; warm (PGD "
          f"{ecfg.ellipsoid_warm_pgd_iters} + L-BFGS {ecfg.ellipsoid_refine_iters}) "
          f"{warm_ms:.3f} ms = {1e6 * warm_ms / pairs:.1f} ns per pair; cold / warm "
          f"{cold_ms / warm_ms:.2f}; {ELLIPSOID_STEPS} app steps {step_ms:.3f} ms/step, "
          f"rebuilds {est.rebuild_count - rb0}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}", flush=True)
    if bool(est.overflow) or not bool(torch.isfinite(est.pos).all()):
        fail("[41] the ellipsoid run overflowed or went non-finite")
    profile_window(inner_steps(esim, est), torch, warm_ms, steps=2)
    del esim, est

    # ---- 42. the three narrow phases in float64, card against CPU -----------
    rng = np.random.default_rng(42)
    pos0 = rng.uniform(0, 14.0, (300, 3))
    q0 = rng.normal(size=(300, 4))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    base = dict(num_rods=300, box_size=14.0, max_neighbors=16, diffusion_coeff=0.05,
                rot_diffusion_coeff=0.05, dt=2e-4, skin=0.1, dtype="float64")
    # (name, overrides, bound on positions and quaternions): the ellipsoid at
    # semi-axes (0.25, 0.25, 0.5), where the reference's descent contracts
    # (at length 2 rounding differences grow ~5x per iteration and no two
    # devices' trajectories agree; tests/test_torch_distance.py); its cold
    # sweep's pick among starts moves a normal by up to ~1e-7
    for name, over, bnd in (("segment", dict(engine="nmat"), 1e-9),
                            ("friction", dict(friction=True), 1e-9),
                            ("ellipsoid", dict(shape="ellipsoid", length=0.5), 1e-8)):
        runs = {}
        t0 = time.perf_counter()
        for d in ("card", "cpu"):
            sim = RodsSim(RodsConfig(**base, **over), device=dev if d == "card" else "cpu")
            st = sim.init(pos=torch.from_numpy(pos0), quat=torch.from_numpy(q0),
                          key_words=(0, 5))
            st = sim.run_block(st, RODS_F64_STEPS)
            runs[d] = (st.rebuild_count, st.pos.cpu(), st.quat.cpu(), st.nmat.idx.cpu(),
                       bool(st.overflow))
        L = base["box_size"]
        dpos = runs["card"][1] - runs["cpu"][1]
        gap = (dpos - L * torch.round(dpos / L)).abs().max().item()
        qgap = (runs["card"][2] - runs["cpu"][2]).abs().max().item()
        same = bool(torch.equal(runs["card"][3], runs["cpu"][3]))
        print(f"[42] {name} float64 300 rods, {RODS_F64_STEPS} steps: rebuilds "
              f"{runs['card'][0]} (cpu {runs['cpu'][0]}), neighbor ids equal {same}, "
              f"max|pos gap| {gap:.3e}, max|quat gap| {qgap:.3e} (bound {bnd:.0e}), "
              f"{time.perf_counter() - t0:.2f} s for both", flush=True)
        if not (runs["card"][0] == runs["cpu"][0] >= 2 and same and gap <= bnd
                and qgap <= bnd and not runs["card"][4]):
            fail(f"[42] the float64 {name} run on the card disagrees with the CPU run")
    return out


def se_rows_ops(P: int, W: int) -> tuple:
    """FP32 operations per occupied slot of K5s-rows and K5i-rows at window
    support P and slab width W, counted from the algorithm (the window
    weights come precomputed in the pieces). K5s-rows: wz f (3 W), times wy
    (3 P W), times wx (3 P^2 W) and the sums into the grid (3 P^2 W).
    K5i-rows: the y sums (2 x 3 P^2 W), the x sums (2 x 3 P W), the z sums
    (2 x 3 W) and the h^3 scale (3)."""
    return 3.0 * W + 3.0 * P * W + 6.0 * P * P * W, 6.0 * P * P * W + 6.0 * P * W + 6.0 * W + 3.0


def slice15_phases(torch, dev, card: str, lcp_sim, lcp_st) -> list:
    """Phases 43-45: the general row pair engine and the small-box spheres
    ([43]), the rows layout of the spectral-Ewald gridding with kernels
    K5s-rows and K5i-rows ([44]), the windowed, j_perm and unordered
    collision layouts at [6]'s 1M LCP state ([45]); times printed with
    `card`. Returns the kernels line's entries of K5s-rows and K5i-rows."""
    from mundy_tpu_torch.constraints.collision import (active_pair_subset,
                                                       active_pair_subset_strided,
                                                       collision_forces,
                                                       collision_setup_spheres,
                                                       pair_j_permutation)
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
    from mundy_tpu_torch.mobility import spectral
    from mundy_tpu_torch.neighbor.cell_list import build_pair_list
    from mundy_tpu_torch.neighbor.rows import pair_chunk_rows
    from mundy_tpu_torch.ops.kernels import row_central as k1
    from mundy_tpu_torch.ops.kernels import se_grid as k5

    # ---- 43. pair_accumulate at config #1's 1M rows; small boxes ----------
    big = bench_config(SpheresConfig, N_BIG)
    sim = RowSpheresSim(big, device=dev)
    rows = sim.init().rows
    m = rows.valid
    f_k1 = k1.row_hertzian_forces_sym(rows.pos, sim.box_static[0], big.radius,
                                      big.youngs_modulus, big.poissons_ratio, valid=m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    f_pa = sim._small_box_forces(rows)  # the app's fallback: pair_accumulate, Hertz pair_fn
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fmax = f_k1[m].abs().max().item()
    pa_err = (f_pa[m] - f_k1[m]).abs().max().item()
    chunks = -(-rows.pos.shape[0] // pair_chunk_rows(rows))
    pa_ms = statistics.median([cuda_ms(lambda: sim._small_box_forces(rows), torch, 1)
                               for _ in range(3)])
    ny, nz, R = m.shape
    print(f"[43] pair_accumulate (Hertz pair_fn, box fast path) at (ny, nz, R) = ({ny}, {nz}, "
          f"{R}): max|diff| vs K1 {pa_err:.3e} of max|f| {fmax:.3e}; {pa_ms:.3f} ms (first "
          f"call {first_s:.3f} s), {chunks} y-chunks of {pair_chunk_rows(rows)} rows, peak "
          f"allocation {(peak - base) / 1e9:.3f} GB above {base / 1e9:.3f} GB "
          f"(max_memory_allocated {peak / 1e9:.3f} GB); K1 alone {cuda_ms(lambda: k1.row_hertzian_forces_sym(rows.pos, sim.box_static[0], big.radius, big.youngs_modulus, big.poissons_ratio, valid=m), torch, 5):.4f} ms; {card}",
          flush=True)
    if not (fmax > 0 and math.isfinite(pa_err) and pa_err <= 2e-5 * fmax):
        fail(f"pair_accumulate disagrees with K1 at 1M: {pa_err} > 2e-5 * {fmax}")
    del sim, rows, m, f_k1, f_pa
    small = SpheresConfig(num_spheres=100, box_size=5.5, diffusion_coeff=0.05, dt=1e-4,
                          skin=0.25, dtype="float64")
    pos0 = torch.rand((100, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(43)) * 5.5
    runs = {}
    for d in (dev, "cpu"):
        ssim = RowSpheresSim(small, device=d)
        st = ssim.run_block(ssim.init(pos=pos0), SMALL_BOX_STEPS)
        runs[str(d)] = (st, ssim.positions(st).cpu(), (ssim.grid.ny, ssim.grid.nz),
                        ssim.small_box)
    (sg, pg, shape, sb), (sc, pc, _, _) = runs[str(dev)], runs["cpu"]
    diff = (pg - pc).abs().max().item()
    print(f"    RowSpheresSim float64, 100 spheres in a 5.5 box, rows {shape} (small box "
          f"{sb}), {SMALL_BOX_STEPS} steps: rebuilds {sg.rebuild_count} (cpu "
          f"{sc.rebuild_count}), max|pos diff| vs cpu {diff:.3e}", flush=True)
    if not (sb and shape == (4, 4) and sg.rebuild_count == sc.rebuild_count >= 2
            and not bool(sg.overflow) and diff <= 1e-7):
        fail("the small-box float64 run on the card disagrees with the CPU run")

    # ---- 44. the rows SE layout at config #5's grid -----------------------
    raw = load_yaml(os.path.join(HERE, "examples", "chromatin_1m_spectral.yaml"))
    ccfg = config_from_dict(ChromatinConfig, raw["params"])

    def yaml_op(dtype, device):  # the operator the chromatin app builds from the YAML
        r_cut = min(0.25 * ccfg.box_size, 3.5 * 2.0 * ccfg.bead_radius)
        s2 = math.sqrt(max(math.log(1e4), 1.0))
        return spectral.build_spectral_ewald(ccfg.box_size, ccfg.bead_radius, ccfg.viscosity,
                                             tol=1e-4, xi=s2 / r_cut, r_cut=r_cut,
                                             dtype=dtype, device=device)

    op = yaml_op(torch.float32, dev)
    n = SE_ROWS_BEADS
    geom = spectral.make_se_geometry(op, n)
    gen = torch.Generator().manual_seed(44)  # on the host: the digests' inputs
    pos = (torch.rand((n, 3), generator=gen) * ccfg.box_size).to(dev)
    F = torch.randn((n, 3), generator=gen).to(dev)
    pieces = k5.se_bin_and_windows(geom, pos, torch.float32)
    grid_k = k5.se_spread_rows_pre(geom, pieces, F)
    s_same = bool(torch.equal(grid_k, k5.se_spread_rows_pre(geom, pieces, F)))
    # the first design's digests: K5s-rows' grid, K5i-rows' u on its planar copy
    u_d = k5.se_interp_rows_pre(geom, pieces, n, grid_k.permute(3, 0, 1, 2).contiguous()
                                .permute(1, 2, 3, 0))
    digests = tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                    for t in (grid_k, u_d))
    del u_d
    grid_p = k5.se_spread_rows_plain(geom, pieces, F)
    ugrid = spectral._k_apply(op, grid_p)  # the inverse FFT's planar layout
    u_k = k5.se_interp_rows_pre(geom, pieces, n, ugrid)
    i_same = bool(torch.equal(u_k, k5.se_interp_rows_pre(geom, pieces, n, ugrid)))
    u_p = k5.se_interp_rows_plain(geom, pieces, n, ugrid)
    tgeom = spectral.make_se_geometry_tiles(op, n, capacity_slack=1.5)
    tpieces = spectral.se_bin_geom(tgeom, pos, torch.float32)
    grid_t = k5.se_spread(tgeom, tpieces, F)
    torch.cuda.synchronize()
    gmax = grid_p.abs().max().item()
    s_err = (grid_k - grid_p).abs().max().item()
    t_err = (grid_k - grid_t).abs().max().item()
    umax = u_p.abs().max().item()
    i_err = (u_k - u_p).abs().max().item()
    perm = pieces[0]
    n_occ = int((perm < n).sum())
    P, W = geom.P, geom.m + geom.P
    print(f"[44] rows SE layout, {n} uniform beads in the {ccfg.box_size} box: G {geom.G}, "
          f"P {P}, m {geom.m}, W {W}, {perm.shape[0]} rows of R {geom.R}, {n_occ} occupied "
          f"slots, overflow {bool(pieces[1])}; K5s-rows max|diff| {s_err:.3e} of max|grid| "
          f"{gmax:.3e} (repeat bit-equal {s_same}), against the tile K5s grid {t_err:.3e}; "
          f"K5i-rows max|diff| {i_err:.3e} of max|u| {umax:.3e} on the planar layout (repeat "
          f"bit-equal {i_same})", flush=True)
    if bool(pieces[1]) or n_occ != n:
        fail("the rows binning at config #5's grid overflowed")
    if not (gmax > 0 and s_err <= 1e-5 * gmax and s_same and t_err <= 1e-5 * gmax):
        fail(f"K5s-rows disagrees with its plain version ({s_err}), the tile grid ({t_err}) "
             f"or itself (bit-equal {s_same}), max|grid| {gmax}")
    if not (umax > 0 and i_err <= 1e-5 * umax and i_same):
        fail(f"K5i-rows disagrees with its plain version ({i_err} > 1e-5 * {umax}) or with "
             f"itself (bit-equal {i_same})")
    print(f"    digests of the K5s-rows grid and the K5i-rows u {digests}, the first "
          f"design's {SE_ROWS_SHA}", flush=True)
    if digests != SE_ROWS_SHA:
        fail(f"the rows kernels' outputs {digests} differ from their first design's "
             f"{SE_ROWS_SHA}")
    # the main path: the rows wave apply from positions, counts set to 0 just before
    k5.se_spread_rows_pre.launches = k5.se_interp_rows_pre.launches = 0
    u_rows, ovf = spectral.se_wave_apply_rows(op, geom, pos, F)
    torch.cuda.synchronize()
    s_launches, i_launches = k5.se_spread_rows_pre.launches, k5.se_interp_rows_pre.launches
    u_tile, _ = spectral.se_wave_apply_dense(op, tgeom, pos, F, pieces=tpieces)
    torch.cuda.synchronize()
    wmax = u_tile.abs().max().item()
    w_err = (u_rows - u_tile).abs().max().item()
    print(f"    se_wave_apply_rows: K5s-rows {s_launches}, K5i-rows {i_launches} launches; "
          f"max|u - u_tile| {w_err:.3e} of max|u_tile| {wmax:.3e}, overflow {bool(ovf)}",
          flush=True)
    if s_launches != 1 or i_launches != 1:
        fail(f"se_wave_apply_rows launched K5s-rows {s_launches}, K5i-rows {i_launches} times")
    if not (wmax > 0 and w_err <= 1e-5 * wmax) or bool(ovf):
        fail(f"the rows wave apply disagrees with the tile one: {w_err} > 1e-5 * {wmax}")
    del grid_t, u_rows, u_tile
    s_ms, s_plain_ms = alternate(lambda: k5.se_spread_rows_pre(geom, pieces, F),
                                 lambda: k5.se_spread_rows_plain(geom, pieces, F),
                                 torch, 5, 2, rounds=2)
    i_ms, i_plain_ms = alternate(lambda: k5.se_interp_rows_pre(geom, pieces, n, ugrid),
                                 lambda: k5.se_interp_rows_plain(geom, pieces, n, ugrid),
                                 torch, 5, 2, rounds=2)
    s_dev_ms = queued_ms(lambda: k5.se_spread_rows_pre(geom, pieces, F), torch)
    i_dev_ms = queued_ms(lambda: k5.se_interp_rows_pre(geom, pieces, n, ugrid), torch)
    ts_ms = statistics.median([cuda_ms(lambda: k5.se_spread(tgeom, tpieces, F), torch, 5)
                               for _ in range(2)])
    ti_ms = statistics.median([cuda_ms(lambda: k5.se_interp(tgeom, tpieces, ugrid), torch, 5)
                               for _ in range(2)])
    wr_ms = cuda_ms(lambda: spectral.se_wave_apply_rows(op, geom, pos, F, pieces=pieces),
                    torch, 3)
    wt_ms = cuda_ms(lambda: spectral.se_wave_apply_dense(op, tgeom, pos, F, pieces=tpieces),
                    torch, 3)
    # the library yardstick: one index_add_ of the same P x P x W spread
    # terms, precomputed (untimed) in the plain version's arithmetic
    sel = (perm.reshape(-1) < n).nonzero()[:, 0]
    parts = [k5.rows_spread_terms(geom, pieces, F, sel[s0:s0 + (1 << 17)])
             for s0 in range(0, sel.shape[0], 1 << 17)]
    idx, vals = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    del parts
    acc = torch.zeros((geom.G ** 3, 3), device=dev)
    lib_err = (acc.clone().index_add_(0, idx, vals) - grid_p.reshape(-1, 3)).abs().max().item()
    s_lib_ms = statistics.median([cuda_ms(lambda: acc.index_add_(0, idx, vals), torch, 3)
                                  for _ in range(2)])
    n_terms = idx.numel()
    del idx, vals, acc
    # perm of every slot; an occupied slot's gx0, gy0, wx, wy, wz (an empty
    # one's are never read); the forces or u; the grid written or read once
    grid_bytes = grid_p.numel() * 4
    piece_bytes = perm.numel() * 4 + n_occ * (4 + 4 + 4 * (2 * P + W))
    s_ops, i_ops = se_rows_ops(P, W)
    s_bound = bound(n_occ * s_ops, piece_bytes + F.numel() * 4 + grid_bytes)
    i_bound = bound(n_occ * i_ops, piece_bytes + grid_bytes + u_p.numel() * 4)
    print(f"    K5s-rows {s_ms:.4f} ms (device time per launch {s_dev_ms:.4f}), plain "
          f"{s_plain_ms:.4f} ms, index_add_ of the "
          f"{n_terms} terms {s_lib_ms:.4f} ms (max|diff| {lib_err:.3e}), bound "
          f"{s_bound[0]:.4f} ms ({s_bound[1]}, {s_ms / s_bound[0]:.1f}x); tile K5s at the "
          f"same beads {ts_ms:.4f} ms (R {tgeom.R}); {card}", flush=True)
    print(f"    K5i-rows {i_ms:.4f} ms (device time per launch {i_dev_ms:.4f}), plain "
          f"{i_plain_ms:.4f} ms, bound {i_bound[0]:.4f} ms "
          f"({i_bound[1]}, {i_ms / i_bound[0]:.1f}x); tile K5i {ti_ms:.4f} ms; wave apply "
          f"rows {wr_ms:.3f} ms, tiles {wt_ms:.3f} ms; {card}", flush=True)
    print(f"    first design (PERF.md's table, NVIDIA H100 80GB HBM3, 700.00 W): "
          f"{SE_ROWS_FIRST}", flush=True)
    # the dense trio at the same shape: a plain yardstick, never on a path
    pdense = k5.se_bin_dense(geom, pos, torch.float32)
    dense = []
    for name, fn in (("se_spread_dense", lambda: k5.se_spread_dense(geom, pdense, F)),
                     ("se_interp_dense", lambda: k5.se_interp_dense(geom, pdense, n, ugrid))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(fn, torch, 1)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        dense.append(f"{name} {ms:.3f} ms, peak allocation {peak:.3f} GB above {base / 1e9:.3f}")
    print(f"    the dense trio, one call each: {'; '.join(dense)}; {card}", flush=True)
    del pdense
    del grid_k, grid_p, ugrid, u_k, u_p, pieces, tpieces, pos, F
    # float64 at a few thousand beads, the card against the CPU, with both
    # windows: the Gaussian's weights on the z terms between P and W are not
    # zero (the tile layout truncates them), so a kernel that dropped them
    # would miss the CPU's rows grid by the printed tail share
    n64 = 3000
    g64 = torch.Generator().manual_seed(45)
    pos64 = torch.rand((n64, 3), dtype=torch.float64, generator=g64) * 24.0
    F64 = torch.randn((n64, 3), dtype=torch.float64, generator=g64)
    for window in ("es", "gaussian"):
        res = []
        for d in (dev, "cpu"):
            r_cut = 3.5
            op64 = spectral.build_spectral_ewald(24.0, 0.5, 1.0, tol=1e-4,
                                                 xi=math.sqrt(math.log(1e4)) / r_cut,
                                                 r_cut=r_cut, dtype=torch.float64,
                                                 window=window, device=d)
            g = spectral.make_se_geometry(op64, n64)
            pc = k5.se_bin_and_windows(g, pos64.to(d), torch.float64)
            gr = k5.se_spread_rows_pre(g, pc, F64.to(d))
            ug = spectral._k_apply(op64, gr)
            uu = k5.se_interp_rows_pre(g, pc, n64, ug)
            pd = k5.se_bin_dense(g, pos64.to(d), torch.float64)  # the dense trio, twice
            dense = [(k5.se_spread_dense(g, pd, F64.to(d)), k5.se_interp_dense(g, pd, n64, ug))
                     for _ in range(2)]
            d_same = all(torch.equal(a, b) for a, b in zip(*dense))
            res.append((gr.cpu(), ug.cpu(), uu.cpu(), g, pc, dense[0][0].cpu(), d_same, op64))
        (gg, ugg, uug, g, pcg, dg, dsame, _), (gc, ugc, uuc, _, pcc, dc, _, opc) = res
        tg = spectral.make_se_geometry_tiles(opc, n64, capacity_slack=1.5)
        g_tile = k5.se_spread(tg, spectral.se_bin_geom(tg, pos64, torch.float64), F64)
        tails = ((gc - g_tile).abs().max() / gc.abs().max()).item()
        e_grid = ((gg - gc).abs().max() / gc.abs().max()).item()
        ui = k5.se_interp_rows_pre(g, pcg, n64, ugc.to(dev).permute(3, 0, 1, 2).contiguous()
                                   .permute(1, 2, 3, 0)).cpu()
        u_cpu = k5.se_interp_rows_pre(g, pcc, n64, ugc)
        e_interp = ((ui - u_cpu).abs().max() / u_cpu.abs().max()).item()
        e_wave = ((uug - uuc).abs().max() / uuc.abs().max()).item()
        e_dense = ((dg - dc).abs().max() / dc.abs().max()).item()
        print(f"    float64 {window}, {n64} beads (G {g.G}, P {g.P}, m {g.m}, W {g.m + g.P}, "
              f"R {g.R}), card vs CPU: K5s-rows {e_grid:.3e}, K5i-rows {e_interp:.3e} of the "
              f"max (the z terms beyond P carry {tails:.3e} of the rows grid's max); the wave "
              f"apply through the float32 forward FFT {e_wave:.3e}; se_spread_dense "
              f"{e_dense:.3e}, the dense trio twice on the card bit-equal {dsame}", flush=True)
        if not (e_grid <= 1e-10 and e_interp <= 1e-10 and e_wave <= 1e-5 and e_dense <= 1e-10
                and dsame):
            fail(f"the float64 rows gridding ({window}) on the card disagrees with the CPU "
                 f"or itself")
        if window == "gaussian" and not tails > 1e3 * 1e-10:
            fail(f"the Gaussian check's z tails ({tails}) are too small to test the W terms")

    # ---- 45. the collision layouts at [6]'s 1M state -----------------------
    lsim, st = lcp_sim, lcp_st
    setup = collision_setup_spheres(st.pos, lsim._radius(), st.pairs, lsim.metric)
    margin = lsim._dyn_margin(setup)
    strided = active_pair_subset_strided(setup, margin, N_BIG, lsim.seg_block, lsim.act_window,
                                         st.seg_starts)
    c_full = setup.pairs.i.shape[0]
    windowed, sel_w, n_act, w_ovf = active_pair_subset(
        setup, margin, c_full, N_BIG, seg_starts=st.seg_starts, block_bodies=lsim.seg_block,
        window=lsim.seg_window)
    # one multiplier per contact, both directions active (a pair at the
    # margin's rounding edge in one direction only carries none)
    act = setup.pairs.mask & (setup.sep0 < margin)
    dual = st.dual_full.long()
    u = torch.rand(c_full, generator=torch.Generator(dev).manual_seed(45), device=dev)
    g_full = torch.where(act & act[dual], u + u[dual], 0.0)
    upairs = build_pair_list(st.nmat, c_full)
    half = (setup.pairs.mask & (setup.pairs.i < setup.pairs.j)).nonzero()[:, 0]
    g_u = torch.zeros(c_full, device=dev)
    g_u[:half.shape[0]] = g_full[half]
    jp = pair_j_permutation(upairs, N_BIG)
    usetup = collision_setup_spheres(st.pos, lsim._radius(), upairs, lsim.metric, j_perm=jp)
    g_s = torch.where(strided.setup.pairs.mask,
                      g_full[torch.clamp(strided.sel, max=c_full - 1).long()], 0.0)
    g_w = torch.where(windowed.pairs.mask, g_full[torch.clamp(sel_w, max=c_full - 1).long()],
                      0.0)
    layouts = (("windowed", windowed, g_w), ("j_perm", usetup, g_u),
               ("unordered", usetup._replace(j_perm=None), g_u))
    F_s = collision_forces(strided.setup, g_s, N_BIG)
    fmax = F_s.abs().max().item()
    fs_ms = cuda_ms(lambda: collision_forces(strided.setup, g_s, N_BIG), torch, 10)
    same_set = bool(torch.equal(sel_w[windowed.pairs.mask],
                                strided.sel[strided.setup.pairs.mask]))
    print(f"[45] collision layouts at [6]'s 1M state: {int(n_act)} active pairs (windowed "
          f"overflow {bool(w_ovf)}, window overflow {bool(windowed.windows.overflow)}), "
          f"{int(upairs.num_pairs)} unordered pairs; the windowed and strided subsets select "
          f"the same pairs {same_set}; strided (K3) {fs_ms:.4f} ms, max|F| {fmax:.3e}; {card}",
          flush=True)
    if not same_set or bool(w_ovf) or bool(windowed.windows.overflow):
        fail("active_pair_subset and active_pair_subset_strided select different pairs")
    for name, lsetup, gam in layouts:
        F1 = collision_forces(lsetup, gam, N_BIG)
        F2 = collision_forces(lsetup, gam, N_BIG)
        torch.cuda.synchronize()
        err = (F1 - F_s).abs().max().item()
        same = bool(torch.equal(F1, F2))
        ms = cuda_ms(lambda: collision_forces(lsetup, gam, N_BIG), torch, 10)
        print(f"    {name}: max|F - F_strided| {err:.3e} of {fmax:.3e}, two runs bit-equal "
              f"{same}, {ms:.4f} ms", flush=True)
        if not (fmax > 0 and err <= 1e-6 * fmax and same):
            fail(f"collision_forces ({name}) disagrees with the strided layout ({err}) or "
                 f"with itself (bit-equal {same})")
    return [
        {"name": "se_spread_rows_pre", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/se_grid.cu",
         "replaces": "mundy_tpu/ops/pallas/se_grid.py:429", "launches": s_launches,
         "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain_ms, "bound_ms": s_bound[0],
         "bound_by": s_bound[1], "library_ms": s_lib_ms},
        {"name": "se_interp_rows_pre", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/se_grid.cu",
         "replaces": "mundy_tpu/ops/pallas/se_grid.py:486", "launches": i_launches,
         "max_abs_err": i_err, "ms": i_ms, "plain_ms": i_plain_ms, "bound_ms": i_bound[0],
         "bound_by": i_bound[1], "library_ms": None}]


def slab_sim(app: str, torch, dev):
    """The row sim of [46] (1M config #1, bench.py:87-105) or [47] (1M
    config #3: rods_100k.yaml's physics in a box 10^(1/3) larger), float32."""
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.rods import RodsConfig
    from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim

    if app == "spheres":
        return RowSpheresSim(bench_config(SpheresConfig, N_BIG), device=dev)
    raw = load_yaml(os.path.join(HERE, "examples", "rods_100k.yaml"))
    box = raw["params"]["box_size"] * (N_BIG / raw["params"]["num_rods"]) ** (1.0 / 3.0)
    cfg = config_from_dict(RodsConfig, dict(raw["params"], num_rods=N_BIG, box_size=box,
                                            dtype="float32"))
    return RowRodsSim(cfg, device=dev)


def slab_rank(group, app: str) -> dict:
    """One rank of [46] (app "spheres", K6) or [47] ("rods", K4): ShardedSim
    around the row sim at 1M; 30 steps from init gathered (their positions
    come back for the parity check), then 3 warm-up steps and SLAB_STEPS
    timed steps of the slab engine with the kernel's count and the group's
    byte and staging counters set to 0 just before; then the kernel on the
    halo-extended block of the final state against its plain version
    (after the count was read)."""
    import torch

    from mundy_tpu_torch.driver.sharded import ShardedSim
    from mundy_tpu_torch.ops.kernels import row_hertz as k6
    from mundy_tpu_torch.ops.kernels import row_segments as k4

    dev = group.device
    sim = slab_sim(app, torch, dev)
    s0 = sim.init()
    runner = ShardedSim(app, sim, group)
    eng = runner.engine
    t0 = time.perf_counter()
    s30 = runner.run_block(s0, SLAB_PARITY_STEPS)
    torch.cuda.synchronize(dev)
    parity_s = time.perf_counter() - t0
    out = {"rank": group.rank, "backend": group.backend, "planes": eng.grid.nz, "nzl": eng.nzl, "ny": eng.grid.ny,
           "R": eng.grid.row_capacity, "mode": eng.rebuild_mode, "parity_s": parity_s,
           "overflow30": bool(s30.overflow), "step30": s30.step}
    if group.rank == 0:
        out["pos30"] = sim.positions(s30).cpu().numpy()
        if app == "rods":
            out["quat30"] = sim.quaternions(s30).cpu().numpy()
    kernel = k6.row_hertzian_forces if app == "spheres" else k4.row_segment_pairs_sym
    st = eng.step_block(runner._dict, 3)  # warm-up
    torch.cuda.synchronize(dev)
    rb0 = st["rebuilds"]
    kernel.launches = 0
    group.reset_counters()
    t0 = time.perf_counter()
    st = eng.step_block(st, SLAB_STEPS)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    out.update(ms=1e3 * elapsed / SLAB_STEPS, launches=kernel.launches,
               rebuilds=st["rebuilds"] - rb0, bytes=group.bytes_moved / SLAB_STEPS,
               stage_ms=1e3 * group.stage_s / SLAB_STEPS, overflow=bool(st["overflow"]),
               valid=int(group.psum(st["valid"].sum().reshape(1))[0]))
    # the kernel against its plain version on the halo-extended block
    ny, nzl = st["pos"].shape[0], eng.nzl
    if app == "spheres":
        pe, ve, box = eng.extended(st)
        c = sim.config
        args = (box, c.radius, c.youngs_modulus, c.poissons_ratio)
        f_k = k6.row_hertzian_forces(pe, ve, *args)[1:1 + ny, 1:1 + nzl]
        f_p = k6.row_hertzian_forces_plain(pe, ve, *args)[1:1 + ny, 1:1 + nzl]
        torch.cuda.synchronize(dev)
        m = st["valid"]
        out["k_err"] = [(f_k[m] - f_p[m]).abs().max().item()]
        out["k_max"] = [f_p[m].abs().max().item()]
        out["block"] = tuple(pe.shape[:3])
    else:
        mid, he, ve, box = eng.extended(st)
        args = (box, sim.config.radius, sim.e_eff)
        fk, tk = (x[:, 1:1 + nzl] for x in k4.row_segment_pairs_sym(mid, he, ve, *args))
        fp, tp = (x[:, 1:1 + nzl] for x in k4.row_segment_pairs_plain(mid, he, *args))
        torch.cuda.synchronize(dev)
        m = st["valid"]
        out["k_err"] = [(fk[m] - fp[m]).abs().max().item(), (tk[m] - tp[m]).abs().max().item()]
        out["k_max"] = [fp[m].abs().max().item(), tp[m].abs().max().item()]
        out["block"] = tuple(mid.shape[:3])
    return out


def slab_f64_rank(group) -> dict:
    """[48] on one rank: both slab engines in float64 on the card (this
    group, gloo with the CUDA tensors staged) and on the CPU (a CPU group of
    the same ranks), from the same start; rank 0 returns the gathered
    states."""
    import torch

    from mundy_tpu_torch.parallel.comm import Group
    from mundy_tpu_torch.parallel.slab_rows import make_slab_rows_spheres_step
    from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step

    cpu = Group(group.rank, group.size, "cpu", group.backend)
    gen = torch.Generator().manual_seed(48)
    pos_s = torch.rand((600, 3), dtype=torch.float64, generator=gen) * 16.0
    pos_r = torch.rand((400, 3), dtype=torch.float64, generator=gen) * 24.0
    quat_r = torch.nn.functional.normalize(torch.randn((400, 4), dtype=torch.float64,
                                                       generator=gen), dim=1)
    res = {}
    for where, g in (("card", group), ("cpu", cpu)):
        eng = make_slab_rows_spheres_step(g, 600, 16.0, radius=0.5, youngs=200.0,
                                          diffusion=0.05, dt=2e-4, skin=0.1,
                                          dtype=torch.float64)
        runs = {"spheres": eng.step_block(eng.init(pos_s, (0, 48)), F64_SPHERE_STEPS)}
        eng = make_slab_rods_step(g, 400, 24.0, diffusion=0.05, rot_diffusion=0.05, dt=1e-3,
                                  skin=0.3, dtype=torch.float64)
        runs["rods"] = eng.step_block(eng.init(pos_r, (0, 48), quat=quat_r), F64_ROD_STEPS)
        res[where] = {
            app: {"rebuilds": st["rebuilds"],
                  **{k: torch.cat(g.all_gather(st[k]), dim=1).cpu().numpy()
                     for k in ("pos", "gid", "valid") + (("quat",) if app == "rods" else ())}}
            for app, st in runs.items()}
    return res if group.rank == 0 else None


def sharded_ranks(group) -> dict:
    """The d = 2 rank body: [46], [47] and [48] in one process group."""
    return {"spheres": slab_rank(group, "spheres"), "rods": slab_rank(group, "rods"),
            "f64": slab_f64_rank(group)}


def slab_reference(app: str, grid, torch, dev) -> dict:
    """The single-device row sim over SLAB_PARITY_STEPS from the same init,
    on the slab engine's grid (init right-sizes its row capacity)."""
    sim = slab_sim(app, torch, dev)
    s0 = sim.init()
    kw = dict(pos=sim.positions(s0), key_words=s0.key)
    if app == "rods":
        kw["quat"] = sim.quaternions(s0)
    sim.grid = grid
    st = sim.run_block(sim.init(**kw), SLAB_PARITY_STEPS)
    torch.cuda.synchronize()
    out = {"pos": sim.positions(st).cpu().numpy(), "R": sim.grid.row_capacity}
    if app == "rods":
        out["quat"] = sim.quaternions(st).cpu().numpy()
    return out


def sharded_phases(torch, dev, card: str, k5_single=None) -> dict:
    """Phases 46-49: the z-slab spheres engine (K6) and rods engine (K4)
    through ShardedSim at 1M on one rank (NCCL) and two ranks (gloo, both on
    this card), float64 against the CPU at two ranks, LCP rpy_ring; then
    [51]-[54], [55]-[58], [60]-[63], and last the `--devices 2` subprocesses
    of [50], [53], [59] and [64] all at once.
    Returns the path launches of K6, K4, K2, K3, K5s and K5i by entry name."""
    import numpy as np
    import tempfile

    from mundy_tpu_torch.neighbor.rows import make_row_grid
    from mundy_tpu_torch.parallel import comm
    from mundy_tpu_torch.parallel.slab_rows import slab_grid

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    paths = {"row_hertzian_forces": {}, "row_segment_pairs_sym": {},
             "row_neighbor_extract": {}, "strided_onehot_segment_sum": {}}
    # ---- 46-47 at d = 1: a one-rank NCCL group in this process -------------
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    one = comm.init_group(0, 1, "cuda", os.path.join(store, "store"))
    print(f"[46]-[47] d = 1: ranks 1, backend {one.backend}, devices [{one.device}]",
          flush=True)
    try:
        d1 = {app: slab_rank(one, app) for app in ("spheres", "rods")}
    finally:
        comm.close_group()
    torch.cuda.empty_cache()
    # ---- 46-48 at d = 2: two ranks on this card ----------------------------
    d2 = comm.spawn_ranks(sharded_ranks, 2, "cuda", timeout=600.0, threads=4,
                          log=lambda line: print(f"[46]-[48] d = 2: {line}", flush=True))
    torch.cuda.empty_cache()
    for app, phase, kernel, name, tol in (
            ("spheres", 46, "K6", "row_hertzian_forces", 5e-5),
            ("rods", 47, "K4", "row_segment_pairs_sym", 1e-5)):
        runs = {1: [d1[app]], 2: [d2[0][app], d2[1][app]]}
        sim = slab_sim(app, torch, dev)
        raw = make_row_grid([0, 0, 0], [sim.config.box_size] * 3, sim.cutoff, N_BIG,
                            capacity_slack=1.9, dtype=sim.dtype, device=dev)
        box = sim.config.box_size
        del sim
        for d, ranks in runs.items():
            r0 = ranks[0]
            grid = slab_grid(raw, d, box)
            if (grid.ny, grid.nz, grid.row_capacity) != (r0["ny"], r0["planes"], r0["R"]):
                fail(f"[{phase}] d = {d}: the ranks' grid is not the slab grid {grid}")
            ref = slab_reference(app, grid, torch, dev)
            diff = r0["pos30"] - ref["pos"]
            diff -= box * np.round(diff / box)
            err = float(np.abs(diff).max())
            qerr = 0.0
            if app == "rods":
                qerr = float(np.minimum(np.abs(r0["quat30"] - ref["quat"]).max(-1),
                                        np.abs(r0["quat30"] + ref["quat"]).max(-1)).max())
            launches = [r["launches"] for r in ranks]
            paths[name][f"slab_{'rows' if app == 'spheres' else 'segments'} d={d}"] = sum(
                launches)
            print(f"[{phase}] {N_BIG} {app} through ShardedSim, d = {d} on one card "
                  f"({r0['backend']}): {r0['planes']} planes, "
                  f"{r0['nzl']} per rank, (ny, R) ({r0['ny']}, {r0['R']}), {r0['mode']} "
                  f"rebuilds; 30 steps from init {r0['parity_s']:.2f} s, max|pos diff| vs "
                  f"the single-device row sim on this grid {err:.3e}"
                  + (f", quaternions {qerr:.3e}" if app == "rods" else "")
                  + f"; then {SLAB_STEPS} steps after 3: " + "; ".join(
                      f"rank {r['rank']} {r['ms']:.3f} ms/step, {kernel} launches/step "
                      f"{r['launches'] / SLAB_STEPS:.3f}, rebuilds {r['rebuilds']}, bytes "
                      f"moved/step {r['bytes']:.0f}, staging {r['stage_ms']:.4f} ms/step"
                      for r in ranks)
                  + f"; {kernel} on the halo-extended block {r0['block']} vs its plain "
                    f"version: max|diff| {r0['k_err']} of max {r0['k_max']}; {card}",
                  flush=True)
            if any(r["overflow"] or r["overflow30"] or r["step30"] != SLAB_PARITY_STEPS
                   for r in ranks) or r0["valid"] != N_BIG:
                fail(f"[{phase}] the d = {d} run overflowed, lost a body or miscounted steps")
            if not err <= 2e-4 or not qerr <= 2e-4:
                fail(f"[{phase}] d = {d} disagrees with the single-device row sim: {err}, {qerr}")
            if any(n != SLAB_STEPS for n in launches):
                fail(f"[{phase}] {kernel} launched {launches} times in {SLAB_STEPS} steps")
            if not all(m > 0 and e <= tol * m for e, m in zip(r0["k_err"], r0["k_max"])):
                fail(f"[{phase}] {kernel} disagrees with its plain version on the "
                     f"halo-extended block: {r0['k_err']} of {r0['k_max']}")
    # ---- 48. float64, card vs CPU at d = 2 ---------------------------------
    f64 = d2[0]["f64"]
    for app, tol in (("spheres", 1e-8), ("rods", 1e-8)):
        g, c = f64["card"][app], f64["cpu"][app]
        v = c["valid"]
        err = float(np.abs(g["pos"][v] - c["pos"][v]).max())
        same = bool(np.array_equal(g["gid"], c["gid"]) and np.array_equal(g["valid"], v))
        qerr = 0.0
        if app == "rods":
            qerr = float(np.minimum(np.abs(g["quat"] - c["quat"]).max(-1),
                                    np.abs(g["quat"] + c["quat"]).max(-1)).max())
        print(f"[48] float64 {app} at d = 2, card vs CPU: rebuilds {g['rebuilds']} (cpu "
              f"{c['rebuilds']}), rows equal {same}, max|pos diff| {err:.3e}"
              + (f", quaternions {qerr:.3e}" if app == "rods" else ""), flush=True)
        if not (same and g["rebuilds"] == c["rebuilds"] >= 2 and err <= tol and qerr <= tol):
            fail(f"[48] the float64 {app} slab run on the card disagrees with the CPU run")
    lcp_paths = lcp_ring_phase(torch, dev, card)
    for name, n in lcp_paths.items():
        paths[name]["lcp rpy_ring 4096"] = n
    print(f"[46]-[49] took {time.perf_counter() - t_start:.1f} s", flush=True)
    balanced_phases(torch, card)
    paths.update(block_phases(torch, dev, card, k5_single))
    for name, n in slice20_phases(torch, dev, card).items():  # [60]-[63]
        paths[name].update(n)
    devices_cli_phases()  # [50], [53], [59], [64]
    return paths


def lcp_ring_phase(torch, dev, card: str) -> dict:
    """[49]: LCP rpy_ring on one rank: 4096 spheres at lcp_bench_config's
    volume fraction for RING_STEPS steps (float32), with the K2 and K3
    counts set to 0 before the sim is made; one mobility apply by CUDA
    events; then 300 spheres in float64 on the card against the CPU."""
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    cfg = dataclasses.replace(lcp_bench_config(LCPSpheresConfig, 4096), hydro="rpy_ring")
    k2.row_neighbor_extract.launches = 0
    k3.strided_onehot_segment_sum.launches = 0
    sim = LCPSpheresSim(cfg, device=dev)
    st = sim.init()
    iters, ms = [], []
    for _ in range(RING_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run_block(st, 1, resize=False)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        iters.append(st.lcp_iters)
    got = {"row_neighbor_extract": k2.row_neighbor_extract.launches,
           "strided_onehot_segment_sum": k3.strided_onehot_segment_sum.launches}
    f = torch.randn((cfg.num_spheres, 3), device=dev, generator=torch.Generator(dev).manual_seed(49))
    mob, _ = sim._mobility(st.pos, st.hydro_nmat)
    apply_ms = cuda_ms(lambda: mob(f), torch, 5)
    applies = sum(i + 2 for i in iters)
    print(f"[49] LCP rpy_ring, {cfg.num_spheres} spheres in box {cfg.box_size:.3f} (float32, "
          f"one rank): ms/step {[round(m, 3) for m in ms]}, BBPGD iterations {iters}, "
          f"rebuilds {st.rebuild_count}, max overlap {sim.max_overlap(st):.3e}, overflow "
          f"{bool(st.overflow)}; launches K2 {got['row_neighbor_extract']}, K3 "
          f"{got['strided_onehot_segment_sum']} (mobility applies {applies}); one ring apply "
          f"{apply_ms:.3f} ms by CUDA events; {card}", flush=True)
    if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()):
        fail("[49] the rpy_ring run overflowed or went non-finite")
    if got["strided_onehot_segment_sum"] != applies or got["row_neighbor_extract"] < 1:
        fail(f"[49] rpy_ring launched {got} for {applies} mobility applies")
    del sim, st, mob, f
    small = LCPSpheresConfig(num_spheres=300, box_size=18.0, radius=0.5, dt=2e-3,
                             diffusion_coeff=0.02, dtype="float64", chunk=256,
                             max_allowable_overlap=1e-6, max_col_iterations=2000,
                             hydro="rpy_ring")
    pos0 = torch.rand((300, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(49)) * 18.0
    trace = {}
    for d in ("cuda", "cpu"):
        s_sim = LCPSpheresSim(small, device=d)
        s = s_sim.init(pos=pos0, key_words=(0, 49))
        rows = []
        for _ in range(14):
            s = s_sim.run_block(s, 1, resize=False)
            rows.append((s.lcp_iters, int(s.act_count), s.rebuild_count, bool(s.overflow)))
        trace[d] = (rows, s.pos.cpu())
    err = (trace["cuda"][1] - trace["cpu"][1]).abs().max().item()
    print(f"[49] float64 300 spheres, 14 steps, card vs CPU: counters equal at every step "
          f"{trace['cuda'][0] == trace['cpu'][0]}, rebuilds {trace['cuda'][0][-1][2]}, "
          f"max|pos diff| {err:.3e}", flush=True)
    if not (trace["cuda"][0] == trace["cpu"][0] and err <= 1e-8):
        fail("[49] the float64 rpy_ring run on the card disagrees with the CPU run")
    return got


def cli_devices(runs, timeout: float = 500.0) -> list:
    """Each (yaml, sets, outputs) of `runs` through `python -m
    mundy_tpu_torch.driver.main examples/<yaml>.yaml --devices 2 --set
    <sets> --checkpoint-dir ...` (and `--output-dir` where `outputs`) as a
    subprocess on this card, all started together, so that their start-up
    (each rank's interpreter, imports and CUDA context, most of a run's
    wall time) overlaps. Returns, per run, a dict of the exit code, the
    standard output and error, the wall seconds, the checkpoint files and
    whether the final VTK was written; the run's directory is removed."""
    import shutil
    import tempfile

    def one(run):
        yaml, sets, outputs = run
        out = tempfile.mkdtemp(prefix=f"chip_smoke_{yaml}_")
        ck = os.path.join(out, "ck")
        cmd = [sys.executable, "-m", "mundy_tpu_torch.driver.main",
               os.path.join(HERE, "examples", f"{yaml}.yaml"), "--devices", "2",
               "--set", *sets, "--checkpoint-dir", ck, "--rank-timeout", "300"]
        if outputs:
            cmd += ["--output-dir", os.path.join(out, "out")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                                  timeout=timeout, env=dict(os.environ, PYTHONPATH=HERE))
            return {"rc": proc.returncode, "lines": proc.stdout.splitlines(),
                    "stdout": proc.stdout, "stderr": proc.stderr,
                    "wall": time.perf_counter() - t0,
                    "files": sorted(os.listdir(ck)) if os.path.isdir(ck) else [],
                    "vtk": os.path.exists(os.path.join(out, "out", "final.vtk"))}
        finally:
            shutil.rmtree(out, ignore_errors=True)

    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        return list(pool.map(one, runs))


def cli_devices_phase(results: list) -> None:
    """[50]: spheres_10k.yaml and rods_100k.yaml through
    `python -m mundy_tpu_torch.driver.main ... --devices 2` on this card,
    cut in steps (CLI_DEVICES_RUNS[50], run with the other CLI phases at
    once):
    each exits 0, prints the plan line once, and rank 0 alone writes the
    final VTK and the checkpoint."""
    for (yaml, sets, _, steps), r in zip(CLI_DEVICES_RUNS[50], results):
        said = [ln for ln in r["lines"] if ln.startswith(("ranks ", "sharded ", "stepped "))]
        print(f"[50] {yaml}.yaml --devices 2, {steps} steps: rc {r['rc']}, "
              f"{r['wall']:.1f} s wall (the CLI phases at once); " + " | ".join(said)
              + f"; checkpoint files {r['files']}", flush=True)
        if (r["rc"] != 0 or sum(ln.startswith("stepped ") for ln in r["lines"]) != 1
                or not r["vtk"] or f"ckpt_{steps:012d}.npz" not in r["files"]):
            print(r["stdout"][-3000:], r["stderr"][-3000:], flush=True)
            fail(f"[50] {yaml}.yaml --devices 2 failed")


def settle_box(n: int) -> tuple:
    """tests/test_balanced_slab.py's box (10, 10, 24) for 1024 spheres,
    scaled to n at the same number density."""
    f = (n / 1024.0) ** (1.0 / 3.0)
    return (10.0 * f, 10.0 * f, 24.0 * f)


def clustered_start(n: int, box: tuple, frac: float, seed: int, torch, margin: float = 0.6):
    """n positions uniform in x and y (margin from the walls) and in the
    bottom `frac` of z: the clustered start of the reference's balanced-slab
    tests, float64 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 3), dtype=torch.float64, generator=gen)
    lo = torch.tensor([margin, margin, margin], dtype=torch.float64)
    hi = torch.tensor([box[0] - margin, box[1] - margin, frac * box[2]], dtype=torch.float64)
    return lo + (hi - lo) * u


def settle_phase(group) -> dict:
    """[51] on one rank: the balanced settling engine at SETTLE_N spheres
    from the clustered start (the reference test's radius 0.3 and skin
    0.24; dt 1.5e-3, as tests/test_torch_balanced_slab.py, so that the skin
    rebuilds rebalance within the window), SETTLE_STEPS steps timed after
    init, and the uniform split's init on the same start."""
    import torch

    from mundy_tpu_torch.parallel.balanced_slab import make_balanced_settling_step, ovf_bits_of

    def own_counts(group, state) -> list:
        n = state["valid"].sum().reshape(1).to(torch.int64)
        return [int(c[0]) for c in group.all_gather(n)]

    dev = group.device
    box = settle_box(SETTLE_N)
    pos = clustered_start(SETTLE_N, box, 0.5, 51, torch).to(torch.float32)
    out = {}
    for balance in ("balanced", "uniform"):
        eng = make_balanced_settling_step(group, SETTLE_N, box, radius=0.3, skin=0.24,
                                          dt=1.5e-3, balance=balance)
        st = eng.init(pos)
        row = {"counts0": own_counts(group, st), "bounds0": st["bounds"].cpu().tolist(),
               "bits0": ovf_bits_of(group, st), "n_cap": eng.n_cap, "g_cap": eng.g_cap}
        if balance == "balanced":
            group.reset_counters()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            st = eng.step_block(st, SETTLE_STEPS)
            torch.cuda.synchronize(dev)
            row["ms"] = 1e3 * (time.perf_counter() - t0) / SETTLE_STEPS
            row.update(bytes=group.bytes_moved / SETTLE_STEPS,
                       stage_ms=1e3 * group.stage_s / SETTLE_STEPS,
                       counts=own_counts(group, st), bounds=st["bounds"].cpu().tolist(),
                       bits=ovf_bits_of(group, st), rebuilds=st["rebuilds"])
            p, seen = eng.gather(st)
            row["lost"] = int((seen != 1).sum())
            row["finite"] = bool(torch.isfinite(p).all())
        out[balance] = row
        del eng, st
    return out


def lcp_shard_phase(group) -> dict:
    """[52] on one rank: config #2's 1M spheres (bench.py's LCP protocol
    state, lcp_bench_config) through ShardedSim("lcp_spheres"): a
    LCP_SHARD_WARM-step block from init, then a LCP_SHARD_STEPS-step block
    with the group's counters and the peak allocation reset just before."""
    import torch

    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    dev = group.device
    sim = LCPSpheresSim(lcp_bench_config(LCPSpheresConfig, N_BIG), device=dev)
    t0 = time.perf_counter()
    s0 = sim.init()
    runner = ShardedSim("lcp_spheres", sim, group)
    st = runner.run_block(s0, LCP_SHARD_WARM)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    warm_iters = list(runner._dict["iters"])
    group.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = runner.run_block(st, LCP_SHARD_STEPS)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    dd = runner._dict
    out = {"ms": 1e3 * elapsed / LCP_SHARD_STEPS, "iters": list(dd["iters"]),
           "warm_iters": warm_iters, "warm_s": warm_s, "rebuilds": dd["rebuilds"],
           "bytes": group.bytes_moved / LCP_SHARD_STEPS,
           "stage_ms": 1e3 * group.stage_s / LCP_SHARD_STEPS,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "n_cap": runner.engine.n_cap, "g_cap": runner.engine.g_cap,
           "own": int(dd["valid"].sum()), "step": st.step, "overflow": bool(st.overflow),
           "finite": bool(torch.isfinite(st.pos).all()), "describe": runner.describe()}
    if group.rank == 0:
        out["overlap"] = sim.max_overlap(st)
    return out


def balanced_f64_rank(group) -> dict:
    """[54] on one rank: the three balanced engines in float64 on the card
    (this group, gloo with the CUDA tensors staged) and on the CPU (a CPU
    group of the same ranks), from the same starts; rank 0 returns the
    counters and gathered states of both."""
    import torch

    from mundy_tpu_torch.parallel.balanced_lcp import make_balanced_lcp_step
    from mundy_tpu_torch.parallel.balanced_slab import make_balanced_settling_step
    from mundy_tpu_torch.parallel.comm import Group
    from mundy_tpu_torch.parallel.granular_shard import make_granular_slab_step

    cpu = Group(group.rank, group.size, "cpu", group.backend)
    f64 = torch.float64
    s_box = settle_box(1024)
    s_pos = clustered_start(1024, s_box, 0.5, 54, torch)
    l_box = float((1024 * (4 / 3) * math.pi * 0.3 ** 3 / 0.02) ** (1 / 3))
    l_pos = clustered_start(1024, (l_box, l_box, l_box), 0.35, 54, torch, margin=0.0)
    g_pos = clustered_start(300, (10.0, 10.0, 20.0), 0.45, 54, torch, margin=1.0)
    res = {}
    for where, g in (("card", group), ("cpu", cpu)):
        eng = make_balanced_settling_step(g, 1024, s_box, radius=0.3, skin=0.24, dt=1.5e-3,
                                          dtype=f64)
        st = eng.step_block(eng.init(s_pos), F64_SETTLE_STEPS)
        row = {"settle": {"rebuilds": st["rebuilds"], "pos": eng.gather(st)[0].cpu().numpy()}}
        eng = make_balanced_lcp_step(g, 1024, l_box, radius=0.3, dt=1e-3,
                                     constraint_buffer=0.15, diffusion_coeff=0.05, dtype=f64)
        st = eng.step_block(eng.init((0, 54), pos=l_pos), F64_LCP_STEPS)
        row["lcp"] = {"rebuilds": st["rebuilds"], "iters": list(st["iters"]),
                      "pos": eng.gather(st).cpu().numpy()}
        eng = make_granular_slab_step(g, 300, 10.0, dt=5e-4, normal_damping=100.0,
                                      tang_damping=50.0, dtype=f64)
        st = eng.step_block(eng.init(g_pos), F64_GRANULAR_STEPS)
        p, v = eng.gather(st)
        row["granular"] = {"rebuilds": st["rebuild_count"], "pos": p.cpu().numpy(),
                           "vel": v.cpu().numpy()}
        res[where] = row
    return res if group.rank == 0 else None


def balanced_ranks(group) -> dict:
    """The d = 2 rank body of [51], [52] and [54], in one process group."""
    import torch

    out = {"settle": settle_phase(group)}
    torch.cuda.empty_cache()
    out["lcp"] = lcp_shard_phase(group)
    torch.cuda.empty_cache()
    out["f64"] = balanced_f64_rank(group)
    return out


def balanced_phases(torch, card: str) -> None:
    """Phases 51-54: the density-balanced z-slab engines at d = 2, two gloo
    ranks on this card with the CUDA tensors staged through pinned host
    buffers (functional numbers, not scaling): balanced settling at 100k
    ([51]), the 1M LCP protocol through ShardedSim ([52]) and float64 card
    against CPU ([54]); [53] runs with the other CLI phases at the end."""
    import numpy as np

    from mundy_tpu_torch.parallel import comm

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    res = comm.spawn_ranks(balanced_ranks, 2, "cuda", timeout=600.0, threads=4,
                           log=lambda line: print(f"[51]-[54] d = 2: {line}", flush=True))
    # ---- 51 ----------------------------------------------------------------
    box = settle_box(SETTLE_N)
    r0 = res[0]["settle"]
    b, u = r0["balanced"], r0["uniform"]
    print(f"[51] balanced settling, {SETTLE_N} spheres from a clustered start (box "
          f"{tuple(round(x, 3) for x in box)}, radius 0.3, skin 0.24, dt 1.5e-3, float32), d = 2 "
          f"on one card (gloo, staged): n_cap {b['n_cap']}, g_cap {b['g_cap']}; balanced: own "
          f"counts {b['counts0']} -> {b['counts']}, bounds {[round(x, 4) for x in b['bounds0']]}"
          f" -> {[round(x, 4) for x in b['bounds']]}, {SETTLE_STEPS} steps: "
          + "; ".join(f"rank {k} {res[k]['settle']['balanced']['ms']:.3f} ms/step, bytes "
                      f"moved/step {res[k]['settle']['balanced']['bytes']:.0f}, staging "
                      f"{res[k]['settle']['balanced']['stage_ms']:.4f} ms/step"
                      for k in range(2))
          + f", rebuilds {b['rebuilds']}, overflow bits {b['bits']}; uniform: own counts "
            f"{u['counts0']} (capped at n_cap), bounds {[round(x, 4) for x in u['bounds0']]}, "
            f"overflows at init {u['bits0'] > 0} (bits {u['bits0']}); {card}", flush=True)
    if b["bits0"] or b["bits"] or b["lost"] or not b["finite"] or not u["bits0"] & 2:
        fail("[51] the balanced settling run overflowed, lost a body or went non-finite, or "
             "the uniform split did not overflow its own buffer")
    # ---- 52 ----------------------------------------------------------------
    lc = [res[k]["lcp"] for k in range(2)]
    print(f"[52] {N_BIG} LCP spheres (bench.py's protocol config, float32) through "
          f"ShardedSim, d = 2 on one card (gloo, staged): {lc[0]['describe']}; "
          f"{LCP_SHARD_WARM} steps from init in {lc[0]['warm_s']:.1f} s (BBPGD iterations "
          f"{lc[0]['warm_iters']}), then {LCP_SHARD_STEPS} steps: "
          + "; ".join(f"rank {k} {lc[k]['ms']:.1f} ms/step, own {lc[k]['own']}, bytes "
                      f"moved/step {lc[k]['bytes']:.0f}, staging {lc[k]['stage_ms']:.2f} "
                      f"ms/step, peak allocation {lc[k]['peak_gb']:.2f} GB" for k in range(2))
          + f"; BBPGD iterations per step {lc[0]['iters']}, rebuilds {lc[0]['rebuilds']}, "
            f"max overlap {lc[0]['overlap']:.3e}, step {lc[0]['step']}; {card}", flush=True)
    if (any(r["overflow"] or not r["finite"] for r in lc)
            or lc[0]["iters"] != lc[1]["iters"] or lc[0]["own"] + lc[1]["own"] != N_BIG
            or lc[0]["step"] != LCP_SHARD_WARM + LCP_SHARD_STEPS
            or not lc[0]["overlap"] <= 1e-3):
        fail("[52] the sharded 1M LCP run overflowed, lost a body, went non-finite, left an "
             "overlap or disagreed between ranks")
    # ---- 53 ----------------------------------------------------------------
    # ---- 54 ----------------------------------------------------------------
    f64 = res[0]["f64"]
    g, c = f64["card"], f64["cpu"]
    errs = {"settle": float(np.abs(g["settle"]["pos"] - c["settle"]["pos"]).max()),
            "lcp": float(np.abs(g["lcp"]["pos"] - c["lcp"]["pos"]).max()),
            "granular": float(np.abs(g["granular"]["pos"] - c["granular"]["pos"]).max()),
            "granular vel": float(np.abs(g["granular"]["vel"] - c["granular"]["vel"]).max())}
    bounds = {"settle": 1e-8, "lcp": 1e-8, "granular": 1e-8, "granular vel": 1e-7}
    same = {k: g[k]["rebuilds"] == c[k]["rebuilds"] for k in ("settle", "lcp", "granular")}
    same["lcp iters"] = g["lcp"]["iters"] == c["lcp"]["iters"]
    print("[54] float64 at d = 2, card vs CPU: "
          + "; ".join(f"{k} rebuilds {g[k]['rebuilds']} (cpu {c[k]['rebuilds']})"
                      for k in ("settle", "lcp", "granular"))
          + f"; LCP BBPGD iterations per step {g['lcp']['iters']} (cpu {c['lcp']['iters']})"
          + "; max|diff| " + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})"
                                        for k, v in errs.items()), flush=True)
    if not all(same.values()) or any(errs[k] > bounds[k] for k in errs):
        fail("[54] a float64 balanced engine on the card disagrees with the CPU run")
    print(f"[51], [52], [54] took {time.perf_counter() - t_start:.1f} s", flush=True)


def cli_balanced_phase(results: list) -> None:
    """[53]: lcp_spheres_100k.yaml and granular_settling.yaml through
    `python -m mundy_tpu_torch.driver.main ... --devices 2` on this card,
    cut in steps (CLI_DEVICES_RUNS[53]): each exits 0, prints the plan line and
    the decomposition once, and rank 0 alone writes the final VTK and the
    checkpoint."""
    for (yaml, sets, _, steps), r in zip(CLI_DEVICES_RUNS[53], results):
        said = [ln for ln in r["lines"] if ln.startswith(("ranks ", "sharded ", "stepped "))]
        print(f"[53] {yaml}.yaml --devices 2, {steps} steps: rc {r['rc']}, "
              f"{r['wall']:.1f} s wall (the CLI phases at once); " + " | ".join(said)
              + f"; checkpoint files {r['files']}", flush=True)
        once = all(sum(ln.startswith(h) for ln in r["lines"]) == 1
                   for h in ("ranks ", "sharded ", "stepped "))
        if (r["rc"] != 0 or not once or not r["vtk"]
                or r["files"] != [f"ckpt_{steps:012d}.json", f"ckpt_{steps:012d}.npz"]):
            print(r["stdout"][-3000:], r["stderr"][-3000:], flush=True)
            fail(f"[53] {yaml}.yaml --devices 2 failed")


# ---- 55-59: the whole-chain and whole-filament block engines ------------------

F64_CHROM = {  # the reference tests' sizes (tests/test_chromatin_shard.py), float64
    "none": dict(num_chains=8, beads_per_chain=32, num_crosslinkers=32, periphery_radius=9.0),
    "rpy_spectral": dict(num_chains=8, beads_per_chain=16, num_crosslinkers=16,
                         hydro="rpy_spectral", box_size=12.0, dt=1e-4),
    "rpy_periphery": dict(num_chains=8, beads_per_chain=16, num_crosslinkers=16,
                          periphery_radius=9.0, hydro="rpy_periphery", periphery_order=4,
                          dt=1e-4),
}
F64_CHROM_BASE = dict(diffusion_coeff=0.05, binding_rate=50.0, unbinding_rate=2.0, dt=2e-4,
                      max_neighbors=48, cell_capacity=48, dtype="float64", chunk=256,
                      log_every=10 ** 6)
F64_MESH = dict(num_chains=2, beads_per_chain=32, num_crosslinkers=0, diffusion_coeff=0.0,
                dt=2e-4, hydro="rpy_spectral", box_size=16.0, dtype="float64", chunk=256,
                log_every=10 ** 6)
F64_FIL = dict(num_filaments=16, nodes_per_filament=8, box_size=18.0, diffusion_coeff=0.02,
               active_amplitude=0.2, wave_omega=20.0, dt=2e-4, max_neighbors=24,
               cell_capacity=32, dtype="float64", chunk=256, log_every=10 ** 6)
F64_MESH_STEPS = 8
F64_FIL_STEPS = 20


def fil_config():
    """Config #4 (benchmarks/tpu_round2.py:82-98: 2000 x 50, box 120), float32."""
    from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig

    return FilamentsConfig(num_filaments=2000, nodes_per_filament=50, segment_length=1.0,
                           radius=0.25, box_size=120.0, diffusion_coeff=0.05,
                           dtype="float32", log_every=10 ** 6)


def chromatin_shard_phase(group) -> dict:
    """[55] on one rank: examples/chromatin_1m_spectral.yaml as written
    through ShardedSim("chromatin"): CHROM_SHARD_WARM steps from init, then
    CHROM_SHARD_STEPS steps with the K5s/K5i counts and the group's counters
    set to 0 just before. Rank 0 then holds K5s and K5i against their plain
    versions at its own binning and times them, and runs the single-device
    ChromatinSim over the same blocks from the same state."""
    import torch

    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.sharded import ShardedSim
    from mundy_tpu_torch.mobility import spectral
    from mundy_tpu_torch.ops.kernels import se_grid as k5

    dev = group.device
    raw = load_yaml(os.path.join(HERE, "examples", "chromatin_1m_spectral.yaml"))
    t0 = time.perf_counter()
    sim = ChromatinSim(config_from_dict(ChromatinConfig, raw["params"]), device=dev)
    s0 = sim.init()
    runner = ShardedSim("chromatin", sim, group)
    st = runner.run_block(s0, CHROM_SHARD_WARM)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    k5.se_spread.launches = k5.se_interp.launches = 0
    group.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = runner.run_block(st, CHROM_SHARD_STEPS)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    geom = sim.se_geom
    out = {"ms": 1e3 * elapsed / CHROM_SHARD_STEPS, "warm_s": warm_s,
           "launches": (k5.se_spread.launches, k5.se_interp.launches),
           "bytes": group.bytes_moved / CHROM_SHARD_STEPS,
           "grid_bytes": geom.G ** 3 * 3 * 4, "stage_ms": 1e3 * group.stage_s / CHROM_SHARD_STEPS,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "step": st.step,
           "overflow": bool(st.overflow), "finite": bool(torch.isfinite(st.pos).all()),
           "describe": runner.describe(), "N": sim.N, "R": geom.R,
           "cells": (sim.hydro_cells_grid.nx, sim.hydro_cells_grid.capacity),
           "rebuilds": st.rebuild_count - s0.rebuild_count}
    # where a step's time goes: one grid all_reduce (both ranks), then on
    # rank 0 alone its x-slab of the unsplit real-space scan
    grid0 = torch.zeros((geom.G,) * 3 + (3,), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    group.psum(grid0)
    torch.cuda.synchronize(dev)
    out["allreduce_s"] = time.perf_counter() - t0
    del grid0
    if group.rank != 0:
        return out
    from mundy_tpu_torch.mobility.ewald import rpy_real_cells_kernel
    from mundy_tpu_torch.neighbor import cells3d

    cg = sim.hydro_cells_grid
    cells = cells3d.build_cells3d(st.pos, cg)
    payload = cells3d.gather_from_flat(cells, sim._forces(st))
    nxl = -(-cg.nx // group.size)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cells3d.pair_apply_cells3d(cells, (sim.config.box_size,) * 3, payload,
                               rpy_real_cells_kernel(sim.spectral.base), 3, x_range=(0, nxl))
    torch.cuda.synchronize(dev)
    out["slab_scan_s"] = time.perf_counter() - t0
    del cells, payload
    # K5s and K5i at this rank's own binning, against their plain versions
    nl = sim.N // group.size
    pos_l = st.pos[:nl].contiguous()
    f_l = sim._forces(st)[:nl].contiguous()
    pieces = spectral.se_bin_geom(geom, pos_l, torch.float32)
    grid_k = k5.se_spread(geom, pieces, f_l)
    grid_p = k5.se_spread_plain(geom, pieces, f_l)
    ugrid = spectral._k_apply(sim.spectral, grid_p)  # the inverse FFT's planar layout
    u_k = k5.se_interp(geom, pieces, ugrid)
    u_p = k5.se_interp_plain(geom, pieces, ugrid)
    torch.cuda.synchronize(dev)
    out.update(s_err=(grid_k - grid_p).abs().max().item(), gmax=grid_p.abs().max().item(),
               i_err=(u_k - u_p).abs().max().item(), umax=u_p.abs().max().item(),
               binned=int(pieces[3].sum()), bin_overflow=bool(pieces[1]))
    del grid_k, u_k, u_p
    out["s_ms"], out["s_plain_ms"] = alternate(lambda: k5.se_spread(geom, pieces, f_l),
                                               lambda: k5.se_spread_plain(geom, pieces, f_l),
                                               torch, 10, 2, rounds=2)
    out["i_ms"], out["i_plain_ms"] = alternate(lambda: k5.se_interp(geom, pieces, ugrid),
                                               lambda: k5.se_interp_plain(geom, pieces, ugrid),
                                               torch, 10, 2, rounds=2)
    del grid_p, ugrid, pieces
    # the single-device sim over the same blocks from the same state
    t0 = time.perf_counter()
    ref = sim.run_block(sim.run_block(s0, CHROM_SHARD_WARM), CHROM_SHARD_STEPS)
    torch.cuda.synchronize(dev)
    out["single_s"] = time.perf_counter() - t0
    box = sim.config.box_size
    diff = st.pos - ref.pos
    diff = diff - box * torch.round(diff / box)
    out.update(pos_err=diff.abs().max().item(),
               xl_diff=int((st.xl_state != ref.xl_state).sum()),
               bound_diff=int((st.xl_bound_to != ref.xl_bound_to).sum()),
               doubly=sim.doubly_bound(st), ref_overflow=bool(ref.overflow))
    return out


def filaments_shard_run(group, steps: int, reference: bool) -> dict:
    """[56] on one rank: config #4 through ShardedSim("filaments"), 3
    warm-up steps and `steps` timed; with `reference` (rank 0) FilamentsSim
    on the nmat engine over the same blocks from the same state."""
    import torch

    from mundy_tpu_torch.driver.apps.filaments import FilamentsSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    dev = group.device
    sim = FilamentsSim(fil_config(), device=dev)
    s0 = sim.init()
    runner = ShardedSim("filaments", sim, group)
    st = runner.run_block(s0, 3)
    torch.cuda.synchronize(dev)
    rb0 = st.rebuild_count
    group.reset_counters()
    t0 = time.perf_counter()
    st = runner.run_block(st, steps)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    out = {"ms": 1e3 * elapsed / steps, "rebuilds": st.rebuild_count - rb0,
           "bytes": group.bytes_moved / steps, "stage_ms": 1e3 * group.stage_s / steps,
           "overflow": bool(st.overflow), "finite": bool(torch.isfinite(st.pos).all()),
           "step": st.step, "engine": sim.contact_engine, "describe": runner.describe()}
    if reference:
        ref = sim.run_block(sim.run_block(s0, 3), steps)
        torch.cuda.synchronize(dev)
        out["pos_err"] = (st.pos - ref.pos).abs().max().item()
        out["ref_rebuilds"] = ref.rebuild_count - rb0
    return out


def hp1_shard_run(group) -> dict:
    """[57] on one rank: examples/hp1_chromatin.yaml as written (7 chains,
    rpy_periphery) through ShardedSim("chromatin"), HP1_SHARD_STEPS steps
    from init, then ChromatinSim over the same steps from the same state."""
    import torch

    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.sharded import ShardedSim

    dev = group.device
    raw = load_yaml(os.path.join(HERE, "examples", "hp1_chromatin.yaml"))
    sim = ChromatinSim(config_from_dict(ChromatinConfig, raw["params"]), device=dev)
    s0 = sim.init()
    runner = ShardedSim("chromatin", sim, group)
    t0 = time.perf_counter()
    st = runner.run_block(s0, HP1_SHARD_STEPS)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref = sim.run_block(s0, HP1_SHARD_STEPS)
    torch.cuda.synchronize(dev)
    ref_s = time.perf_counter() - t1
    rp, a = sim.config.periphery_radius, sim.config.bead_radius
    return {"ms": 1e3 * elapsed / HP1_SHARD_STEPS, "ref_ms": 1e3 * ref_s / HP1_SHARD_STEPS,
            "pos_err": (st.pos - ref.pos).abs().max().item(),
            "xl_diff": int((st.xl_state != ref.xl_state).sum()),
            "rebuilds": st.rebuild_count - s0.rebuild_count,
            "ref_rebuilds": ref.rebuild_count - s0.rebuild_count,
            "overflow": bool(st.overflow) or bool(ref.overflow),
            "inside": bool(st.pos.norm(dim=1).max() <= rp + a), "doubly": sim.doubly_bound(st),
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32), "N": sim.N}


def block_f64_rank(group) -> dict:
    """[58] on one rank: in float64 on the card (this group, gloo with the
    CUDA tensors staged) and on the CPU (a CPU group of the same ranks),
    from the same starts: ShardedSim("chromatin") with none, rpy_spectral
    and rpy_periphery at the reference tests' sizes, ChromatinSim(mesh=)
    with rpy_spectral, ShardedSim("filaments"). Rank 0 returns both."""
    import torch

    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
    from mundy_tpu_torch.driver.sharded import ShardedSim
    from mundy_tpu_torch.parallel.comm import Group

    cpu = Group(group.rank, group.size, "cpu", group.backend)
    fil0 = FilamentsSim(FilamentsConfig(**F64_FIL), device="cpu").init()
    res = {}
    for where, g in (("card", group), ("cpu", cpu)):
        row = {}
        for case, kw in F64_CHROM.items():
            sim = ChromatinSim(ChromatinConfig(**{**F64_CHROM_BASE, **kw}), device=g.device)
            st = ShardedSim("chromatin", sim, g).run_block(sim.init(), F64_SHARD_STEPS)
            row[case] = {"pos": st.pos.cpu().numpy(), "rebuilds": st.rebuild_count,
                         "xl_state": st.xl_state.cpu().numpy(),
                         "bound_to": st.xl_bound_to.cpu().numpy(),
                         "overflow": bool(st.overflow)}
        sim = ChromatinSim(ChromatinConfig(**F64_MESH), device=g.device, mesh=g)
        st = sim.run_block(sim.init(), F64_MESH_STEPS)
        row["mesh"] = {"pos": st.pos.cpu().numpy(), "rebuilds": st.rebuild_count,
                       "overflow": bool(st.overflow)}
        sim = FilamentsSim(FilamentsConfig(**F64_FIL), device=g.device)
        st = ShardedSim("filaments", sim, g).run_block(
            sim.init(pos=fil0.pos.to(g.device), key_words=fil0.key), F64_FIL_STEPS)
        row["filaments"] = {"pos": st.pos.cpu().numpy(), "rebuilds": st.rebuild_count,
                            "overflow": bool(st.overflow)}
        res[where] = row
    return res if group.rank == 0 else None


def block_ranks(group) -> dict:
    """The d = 2 rank body of [55], [56] and [58], in one process group."""
    import torch

    out = {"chromatin": chromatin_shard_phase(group)}
    torch.cuda.empty_cache()
    out["filaments"] = filaments_shard_run(group, FIL_SHARD_STEPS_2, group.rank == 0)
    torch.cuda.empty_cache()
    out["f64"] = block_f64_rank(group)
    return out


def block_phases(torch, dev, card: str, k5_single=None) -> dict:
    """Phases 55-59: the whole-chain and whole-filament block engines. [56]
    and [57] at d = 1 on NCCL in this process; [55], [56] and [58] at d = 2,
    two gloo ranks on this card with the CUDA tensors staged through pinned
    host buffers (functional numbers, not scaling); [59] runs with the other
    CLI phases at the end. `k5_single`: [20]'s single-device K5s and K5i ms, printed
    beside [55]'s. Returns K5s's and K5i's launches on [55]'s path."""
    import tempfile

    import numpy as np

    from mundy_tpu_torch.parallel import comm

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    # ---- 56-57 at d = 1: a one-rank NCCL group in this process -------------
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    one = comm.init_group(0, 1, "cuda", os.path.join(store, "store"))
    print(f"[56]-[57] d = 1: ranks 1, backend {one.backend}, devices [{one.device}]",
          flush=True)
    try:
        fil1 = filaments_shard_run(one, FIL_SHARD_STEPS, True)
        torch.cuda.empty_cache()
        hp1 = hp1_shard_run(one)
    finally:
        comm.close_group()
    torch.cuda.empty_cache()
    # ---- 55, 56, 58 at d = 2: two ranks on this card ----------------------
    d2 = comm.spawn_ranks(block_ranks, 2, "cuda", timeout=900.0, threads=4,
                          log=lambda line: print(f"[55]-[58] d = 2: {line}", flush=True))
    torch.cuda.empty_cache()
    # ---- 55 ----------------------------------------------------------------
    ch = [d2[k]["chromatin"] for k in range(2)]
    c0 = ch[0]
    single = ("" if k5_single is None else
              f" (single-device at [20]: K5s {k5_single[0]:.4f} ms, K5i {k5_single[1]:.4f} ms)")
    print(f"[55] chromatin_1m_spectral.yaml as written ({c0['N']} beads) through ShardedSim, "
          f"d = 2 on one card (gloo, staged): {c0['describe']}; se R {c0['R']}, hydro cells "
          f"{c0['cells'][0]}^3 x {c0['cells'][1]} unsplit; {CHROM_SHARD_WARM} step from init "
          f"(both sims' init included) {c0['warm_s']:.1f} s, then {CHROM_SHARD_STEPS} steps: "
          + "; ".join(f"rank {k} {ch[k]['ms']:.1f} ms/step, K5s/K5i launches "
                      f"{ch[k]['launches'][0]}/{ch[k]['launches'][1]}, bytes moved/step "
                      f"{ch[k]['bytes']:.0f} (the grid all_reduce {ch[k]['grid_bytes']} B, "
                      f"{ch[k]['grid_bytes'] / max(ch[k]['bytes'], 1):.3f} of it), staging "
                      f"{ch[k]['stage_ms']:.1f} ms/step, peak allocation "
                      f"{ch[k]['peak_gb']:.2f} GB" for k in range(2))
          + f", rebuilds {c0['rebuilds']}; {card}", flush=True)
    print(f"    alone: one grid all_reduce {ch[0]['allreduce_s']:.2f} s and "
          f"{ch[1]['allreduce_s']:.2f} s (both ranks at once), rank 0's x-slab of the unsplit "
          f"real-space scan {c0['slab_scan_s']:.2f} s (rank 1 idle); {card}", flush=True)
    print(f"    rank 0's own binning ({c0['binned']} beads, overflow {c0['bin_overflow']}): "
          f"K5s max|diff| {c0['s_err']:.3e} of max|grid| {c0['gmax']:.3e}, K5i max|diff| "
          f"{c0['i_err']:.3e} of max|u| {c0['umax']:.3e}; K5s {c0['s_ms']:.4f} ms (plain "
          f"{c0['s_plain_ms']:.4f}), K5i {c0['i_ms']:.4f} ms (plain {c0['i_plain_ms']:.4f})"
          f"{single}; {card}", flush=True)
    print(f"    the single-device ChromatinSim over the same blocks ({c0['single_s']:.1f} s): "
          f"max|pos diff| {c0['pos_err']:.3e} (bar {CHROM_SHARD_BAR:.0e}), crosslinker states "
          f"differing {c0['xl_diff']}, bound targets differing {c0['bound_diff']}, doubly "
          f"bound {c0['doubly']}", flush=True)
    steps = CHROM_SHARD_WARM + CHROM_SHARD_STEPS
    if (any(r["overflow"] or not r["finite"] or r["step"] != steps for r in ch)
            or c0["bin_overflow"] or c0["ref_overflow"]
            or c0["binned"] != c0["N"] // 2):
        fail("[55] the sharded 1M chromatin run overflowed, lost a bead, went non-finite or "
             "miscounted steps")
    if any(r["launches"] != (CHROM_SHARD_STEPS, CHROM_SHARD_STEPS) for r in ch):
        fail(f"[55] K5s/K5i launched {[r['launches'] for r in ch]} in {CHROM_SHARD_STEPS} steps")
    if not (c0["gmax"] > 0 and c0["s_err"] <= 1e-5 * c0["gmax"] and c0["umax"] > 0
            and c0["i_err"] <= 1e-5 * c0["umax"]):
        fail("[55] K5s or K5i disagrees with its plain version at rank 0's binning")
    if not c0["pos_err"] <= CHROM_SHARD_BAR or c0["xl_diff"] or c0["bound_diff"]:
        fail("[55] the sharded 1M chromatin run disagrees with the single-device sim")
    # ---- 56 ----------------------------------------------------------------
    fl = [d2[k]["filaments"] for k in range(2)]
    for d, ranks, n in ((1, [fil1], FIL_SHARD_STEPS), (2, fl, FIL_SHARD_STEPS_2)):
        r0 = ranks[0]
        print(f"[56] config #4 (2000 x 50, float32) through ShardedSim, d = {d} on one card "
              f"({'nccl' if d == 1 else 'gloo, staged'}): {r0['describe']}; {n} steps after 3: "
              + "; ".join(f"rank {k} {r['ms']:.2f} ms/step, rebuilds {r['rebuilds']}, bytes "
                          f"moved/step {r['bytes']:.0f}, staging {r['stage_ms']:.3f} ms/step"
                          for k, r in enumerate(ranks))
              + f"; FilamentsSim ({r0['engine']}) over the same blocks: max|pos diff| "
                f"{r0['pos_err']:.3e} (bar {FIL_SHARD_BAR:.0e}), rebuilds "
                f"{r0['ref_rebuilds']}; {card}", flush=True)
        if any(r["overflow"] or not r["finite"] or r["step"] != n + 3 for r in ranks):
            fail(f"[56] the d = {d} filaments run overflowed, went non-finite or miscounted")
        if r0["engine"] != "nmat" or not r0["pos_err"] <= FIL_SHARD_BAR:
            fail(f"[56] the d = {d} filaments run disagrees with FilamentsSim (nmat)")
    # ---- 57 ----------------------------------------------------------------
    print(f"[57] hp1_chromatin.yaml as written ({hp1['N']} beads, rpy_periphery, float32) "
          f"through ShardedSim, d = 1 (nccl): {HP1_SHARD_STEPS} steps at {hp1['ms']:.2f} "
          f"ms/step (ChromatinSim {hp1['ref_ms']:.2f}), rebuilds {hp1['rebuilds']} (single "
          f"{hp1['ref_rebuilds']}, which skips the entry rebuild), max|pos diff| "
          f"{hp1['pos_err']:.3e} (bar {HP1_SHARD_BAR:.0e}), crosslinker states differing "
          f"{hp1['xl_diff']}, doubly bound {hp1['doubly']}, TF32 {hp1['tf32']}; {card}",
          flush=True)
    if (hp1["overflow"] or not hp1["inside"] or hp1["tf32"] or hp1["xl_diff"]
            or not hp1["pos_err"] <= HP1_SHARD_BAR):
        fail("[57] the sharded HP1 run overflowed, left the periphery or disagrees with "
             "ChromatinSim")
    # ---- 58 ----------------------------------------------------------------
    g, c = d2[0]["f64"]["card"], d2[0]["f64"]["cpu"]
    errs, same = {}, {}
    for k in g:
        errs[k] = float(np.abs(g[k]["pos"] - c[k]["pos"]).max())
        same[k] = (g[k]["rebuilds"] == c[k]["rebuilds"] and not g[k]["overflow"]
                   and not c[k]["overflow"]
                   and all(np.array_equal(g[k][f], c[k][f]) for f in ("xl_state", "bound_to")
                           if f in g[k]))
    print("[58] float64 at d = 2, card vs CPU: "
          + "; ".join(f"{k} rebuilds {g[k]['rebuilds']} (cpu {c[k]['rebuilds']}), max|pos "
                      f"diff| {errs[k]:.3e}, counters and binding states equal {same[k]}"
                      for k in g) + f" (bar {F64_SHARD_BAR:.0e})", flush=True)
    if not all(same.values()) or any(e > F64_SHARD_BAR for e in errs.values()):
        fail("[58] a float64 block engine on the card disagrees with the CPU run")
    # ---- 59 ----------------------------------------------------------------
    print(f"[55]-[58] took {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"se_spread": {f"chromatin_shard d=2 rank {k}": ch[k]["launches"][0]
                          for k in range(2)},
            "se_interp": {f"chromatin_shard d=2 rank {k}": ch[k]["launches"][1]
                          for k in range(2)}}


def cli_block_phase(results: list) -> None:
    """[59]: filaments_sperm.yaml and chromatin_1m_spectral.yaml (cut in
    chains and steps) through `python -m mundy_tpu_torch.driver.main ...
    --devices 2` on this card, and hp1_chromatin.yaml, whose 7 chains do not
    split over 2 ranks: it exits non-zero, naming the rule, before any rank
    starts (CLI_DEVICES_RUNS[59])."""
    for (yaml, sets, _, steps), r in zip(CLI_DEVICES_RUNS[59], results):
        said = [ln for ln in r["lines"] if ln.startswith(("ranks ", "sharded ", "stepped "))]
        if steps is None:
            err = (r["stderr"].strip().splitlines() or [""])[-1]
            print(f"[59] {yaml}.yaml --devices 2: rc {r['rc']}, {r['wall']:.1f} s wall, "
                  f"plan lines {len(said)}; {err}", flush=True)
            if r["rc"] == 0 or said or "num_chains % ranks" not in err:
                print(r["stdout"][-3000:], r["stderr"][-3000:], flush=True)
                fail(f"[59] {yaml}.yaml --devices 2 was not refused by its rule")
        else:
            print(f"[59] {yaml}.yaml --devices 2 {' '.join(sets)}: rc {r['rc']}, "
                  f"{r['wall']:.1f} s wall (the CLI phases at once); " + " | ".join(said)
                  + f"; checkpoint files {r['files']}", flush=True)
            once = all(sum(ln.startswith(h) for ln in r["lines"]) == 1
                       for h in ("ranks ", "sharded ", "stepped "))
            if (r["rc"] != 0 or not once
                    or r["files"] != [f"ckpt_{steps:012d}.json", f"ckpt_{steps:012d}.npz"]):
                print(r["stdout"][-3000:], r["stderr"][-3000:], flush=True)
                fail(f"[59] {yaml}.yaml --devices 2 failed")


def ring_shard_run(group) -> dict:
    """[60] on one rank of `group` (one rank: the single-device sim): LCP
    rpy_ring at RING_N spheres of lcp_bench_config's volume fraction
    (float32), with the K2 and K3 counts set to 0 before the sim is made;
    RING_SHARD_WARM steps from init, then RING_SHARD_STEPS timed steps with
    the group's counters set to 0 just before; one ring apply by CUDA
    events; then, on rank 0, K3 at the strided windows of the final state
    and K2 at its rows against their plain versions."""
    import torch

    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.neighbor.rows import build_rows, make_row_grid
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    dev = group.device
    cfg = dataclasses.replace(lcp_bench_config(LCPSpheresConfig, RING_N), hydro="rpy_ring")
    k2.row_neighbor_extract.launches = 0
    k3.strided_onehot_segment_sum.launches = 0
    t0 = time.perf_counter()
    sim = LCPSpheresSim(cfg, device=dev, group=group)
    st = sim.init()
    iters, ms = [], []
    for k in range(RING_SHARD_WARM + RING_SHARD_STEPS):
        if k == RING_SHARD_WARM:
            torch.cuda.synchronize(dev)
            warm_s = time.perf_counter() - t0
            group.reset_counters()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        st = sim.run_block(st, 1, resize=False)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t1))
        iters.append(st.lcp_iters)
    out = {"iters": iters, "ms": ms[RING_SHARD_WARM:], "warm_s": warm_s,
           "bytes": group.bytes_moved / RING_SHARD_STEPS,
           "stage_ms": 1e3 * group.stage_s / RING_SHARD_STEPS,
           "k2": k2.row_neighbor_extract.launches, "k3": k3.strided_onehot_segment_sum.launches,
           "applies": sum(i + 2 for i in iters), "rebuilds": st.rebuild_count,
           "overflow": bool(st.overflow), "finite": bool(torch.isfinite(st.pos).all()),
           "box": cfg.box_size}
    f = torch.randn((RING_N, 3), device=dev, generator=torch.Generator(dev).manual_seed(60))
    mob, _ = sim._mobility(st.pos, st.hydro_nmat)
    out["apply_ms"] = cuda_ms(lambda: mob(f), torch, 5)  # every rank: a collective
    if group.rank == 0:
        values, loc, n_act = k3_window_inputs(sim, st, RING_N, 60, torch)
        out["k3_equal"] = bool(torch.equal(
            k3.strided_onehot_segment_sum(values, loc, sim.seg_block),
            k3.strided_segment_sum_plain(values, loc, sim.seg_block)))
        out["k3_shape"] = (tuple(loc.shape), n_act)
        cutoff = 2 * sim.search_radius
        grid = make_row_grid([0, 0, 0], [cfg.box_size] * 3, cutoff, RING_N,
                             capacity_slack=sim.rows_slack, dtype=torch.float32, align=8,
                             device=dev)
        rs = build_rows(st.pos, torch.arange(RING_N, dtype=torch.int32, device=dev), grid)
        args = (rs.pos, rs.gid, rs.valid, ((cfg.box_size,) * 3, (True,) * 3), cutoff,
                min(cfg.max_neighbors, sim.rows_k), RING_N)
        ids_k, cnt_k = k2.row_neighbor_extract(*args)
        ids_p, cnt_p = k2.row_neighbor_extract_plain(*args)
        out["k2_equal"] = bool(torch.equal(ids_k, ids_p) and torch.equal(cnt_k, cnt_p))
        out["k2_shape"] = tuple(rs.valid.shape)
        out["overlap"] = sim.max_overlap(st)
    return out


def ring_f64_run(group) -> dict:
    """[60]'s float64 check on one rank: 300 spheres of rpy_ring over the
    group on the card, and on rank 0 the same on one CPU rank; rank 0
    returns both runs' per-step counters and final positions."""
    import torch

    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim

    small = LCPSpheresConfig(num_spheres=300, box_size=18.0, radius=0.5, dt=2e-3,
                             diffusion_coeff=0.02, dtype="float64", chunk=256,
                             max_allowable_overlap=1e-6, max_col_iterations=2000,
                             hydro="rpy_ring")
    pos0 = torch.rand((300, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(60)) * 18.0
    runs = {"card": (group.device, group)}
    if group.rank == 0:
        runs["cpu"] = ("cpu", None)
    trace = {}
    for where, (d, g) in runs.items():
        sim = LCPSpheresSim(small, device=d, group=g)
        s = sim.init(pos=pos0, key_words=(0, 60))
        rows = []
        for _ in range(RING_F64_STEPS):
            s = sim.run_block(s, 1, resize=False)
            rows.append((s.lcp_iters, int(s.act_count), s.rebuild_count, bool(s.overflow)))
        trace[where] = (rows, s.pos.cpu().numpy())
    return trace if group.rank == 0 else None


def sharded_step_run(group) -> dict:
    """[61] on one rank: config #1's physics (bench_config) at SHARDED_N
    spheres through parallel.sharded_step's v1 and v2, 1 step from init and
    SHARDED_STEP_STEPS timed steps each, the group's counters set to 0 just
    before them."""
    import torch

    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.parallel.sharded_step import (make_sharded_spheres_step,
                                                       make_slab_spheres_step)

    c = bench_config(SpheresConfig, SHARDED_N)
    kw = dict(n_total=SHARDED_N, box_size=c.box_size, radius=c.radius, youngs=c.youngs_modulus,
              poisson=c.poissons_ratio, viscosity=c.viscosity, diffusion=c.diffusion_coeff,
              dt=c.dt, skin=c.skin, max_neighbors=c.max_neighbors,
              cell_capacity=c.cell_capacity, dtype=torch.float32)
    dev, out = group.device, {}
    for name, make in (("v1", make_sharded_spheres_step), ("v2", make_slab_spheres_step)):
        step, init = make(group, **kw)
        st = init((0, 61))
        st = st if isinstance(st, tuple) else (st,)
        for k in range(1 + SHARDED_STEP_STEPS):
            if k == 1:
                torch.cuda.synchronize(dev)
                group.reset_counters()
                t0 = time.perf_counter()
            *st, over = step(*st, (0, 61), k)
        torch.cuda.synchronize(dev)
        r = {"ms": 1e3 * (time.perf_counter() - t0) / SHARDED_STEP_STEPS,
             "bytes": group.bytes_moved / SHARDED_STEP_STEPS,
             "stage_ms": 1e3 * group.stage_s / SHARDED_STEP_STEPS,
             "finite": bool(torch.isfinite(st[0]).all()), "overlap": float(over)}
        if name == "v2":
            pos, active, gid, flags = st
            r["capacity"] = int(active.shape[0])
            r["flags"] = int(flags)
            r["finite"] = bool(torch.isfinite(pos[active]).all())
            owned = torch.cat(group.all_gather(torch.where(active, gid, -1)))
            owned = torch.sort(owned[owned >= 0]).values
            r["owned_once"] = bool(owned.numel() == SHARDED_N and torch.equal(
                owned, torch.arange(SHARDED_N, dtype=owned.dtype, device=owned.device)))
            r["own"] = int(active.sum())
        out[name] = r
        del st
        torch.cuda.empty_cache()
    return out


def slab_lcp_run(group) -> dict:
    """[62] on one rank: config #2's protocol config (lcp_bench_config) at
    1M through parallel.slab_lcp, a block of SLAB_LCP_WARM steps from init,
    then a block of SLAB_LCP_STEPS timed steps, with the K3 count set to 0
    before the first and the group's counters before the second; then, on
    rank 0, K3 at the final pair list's windows against its plain version."""
    import torch

    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3
    from mundy_tpu_torch.ops.segments import sorted_blocked_planes
    from mundy_tpu_torch.parallel.slab_lcp import make_slab_lcp_spheres_step

    c = lcp_bench_config(LCPSpheresConfig, N_BIG)
    dev = group.device
    init, step_block, grid = make_slab_lcp_spheres_step(
        group, n_total=N_BIG, box_size=c.box_size, radius=c.radius, viscosity=c.viscosity,
        diffusion=c.diffusion_coeff, dt=c.dt, constraint_buffer=c.constraint_buffer,
        max_allowable_overlap=c.max_allowable_overlap, dtype=torch.float32)
    t0 = time.perf_counter()
    st = init((0, 62))
    k3.strided_onehot_segment_sum.launches = 0
    st = step_block(st, SLAB_LCP_WARM)
    torch.cuda.synchronize(dev)
    warm_s, warm_iters = time.perf_counter() - t0, st["iters"]
    group.reset_counters()
    t0 = time.perf_counter()
    st = step_block(st, SLAB_LCP_STEPS)
    torch.cuda.synchronize(dev)
    iters = warm_iters + st["iters"]
    out = {"ms": 1e3 * (time.perf_counter() - t0) / SLAB_LCP_STEPS, "warm_s": warm_s,
           "iters": iters, "applies": sum(i + 2 for i in iters),
           "k3": k3.strided_onehot_segment_sum.launches, "mode": st["mode"],
           "rebuilds": st["rebuilds"], "bytes": group.bytes_moved / SLAB_LCP_STEPS,
           "stage_ms": 1e3 * group.stage_s / SLAB_LCP_STEPS, "overflow": bool(st["overflow"]),
           "finite": bool(torch.isfinite(st["pos"][st["valid"]]).all()),
           "valid": int(group.psum(st["valid"].sum().reshape(1))[0]),
           "grid": (grid.ny, grid.nz, grid.row_capacity), "nzl": st["pos"].shape[1]}
    if group.rank == 0:
        n_slots = st["valid"].numel()
        g = torch.rand(st["pmask"].shape, generator=torch.Generator(dev).manual_seed(62),
                       device=dev)
        vals = torch.where(st["pmask"][:, None], g[:, None] * torch.randn(
            (g.shape[0], 3), generator=torch.Generator(dev).manual_seed(63), device=dev), 0.0)
        planes, loc = sorted_blocked_planes(vals, st["ii"], n_slots, st["windows"])
        B = st["windows"].block_bodies
        out["k3_equal"] = all(bool(torch.equal(k3.strided_onehot_segment_sum(p, loc, B),
                                               k3.strided_segment_sum_plain(p, loc, B)))
                              for p in planes)
        out["k3_shape"] = (tuple(loc.shape), B, int(st["pmask"].sum()))
    return out


def slice20_f64_rank(group) -> dict:
    """[63] on one rank: v2 (800 spheres, the reference test's config) and
    slab_lcp (512 spheres with D 0.05, both rebuild modes) in float64 on the
    card (this group) and on the CPU (a CPU group of the same ranks) from the
    same start; rank 0 returns the gathered slots."""
    import torch

    from mundy_tpu_torch.parallel.comm import Group
    from mundy_tpu_torch.parallel.sharded_step import make_slab_spheres_step
    from mundy_tpu_torch.parallel.slab_lcp import make_slab_lcp_spheres_step

    cpu = Group(group.rank, group.size, "cpu", group.backend)
    pos_v2 = torch.rand((800, 3), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(63)) * 20.0
    box = float((512 * (4 / 3) * math.pi * 0.125 / 0.05) ** (1 / 3))
    pos_lcp = torch.rand((512, 3), dtype=torch.float64,
                         generator=torch.Generator().manual_seed(64)) * box
    res = {}
    for where, g in (("card", group), ("cpu", cpu)):
        step, init = make_slab_spheres_step(g, n_total=800, box_size=20.0, radius=0.5,
                                            youngs=200.0, diffusion=0.05, dt=2e-4,
                                            dtype=torch.float64)
        st = init((0, 63), pos=pos_v2)
        for k in range(F64_V2_STEPS):
            *st, _ = step(*st, (0, 63), k)
        runs = {"v2": dict(zip(("pos", "valid", "gid"), (
            torch.cat(g.all_gather(x)).cpu().numpy() for x in st[:3])))}
        for mode in ("local", "global"):
            init, step_block, _ = make_slab_lcp_spheres_step(
                g, n_total=512, box_size=box, dt=1e-3, diffusion=0.05,
                pair_capacity_per_body=8, dtype=torch.float64, rebuild_mode=mode)
            s = step_block(init((0, 64), pos=pos_lcp), F64_SLAB_LCP_STEPS)
            runs[mode] = {k: torch.cat(g.all_gather(s[k]), dim=1).cpu().numpy()
                          for k in ("pos", "valid", "gid")}
            runs[mode].update(iters=s["iters"], rebuilds=s["rebuilds"])
        res[where] = runs
    return res if group.rank == 0 else None


def slice20_ranks(group) -> dict:
    """The d = 2 rank body of [60]-[63], in one process group."""
    import torch

    out = {"ring": ring_shard_run(group)}
    out["ring_f64"] = ring_f64_run(group)
    torch.cuda.empty_cache()
    out["sharded_step"] = sharded_step_run(group)
    torch.cuda.empty_cache()
    out["slab_lcp"] = slab_lcp_run(group)
    torch.cuda.empty_cache()
    out["f64"] = slice20_f64_rank(group)
    return out


def cli_ring_phase(results: list) -> None:
    """[64]: examples/lcp_spheres_100k.yaml with hydro=rpy_ring (4096
    spheres, box 31, 10 steps) through `python -m
    mundy_tpu_torch.driver.main ... --devices 2` on this card
    (CLI_DEVICES_RUNS[64]):
    exit 0, the plan and the rpy_ring line and one "stepped" line once each,
    the final VTK and the checkpoint written by rank 0 alone."""
    (yaml, sets, _, steps), r = CLI_DEVICES_RUNS[64][0], results[0]
    said = [ln for ln in r["lines"] if ln.startswith(("ranks ", "sharded ", "stepped "))]
    print(f"[64] {yaml}.yaml --devices 2 {' '.join(sets)}: rc {r['rc']}, "
          f"{r['wall']:.1f} s wall (the CLI phases at once); " + " | ".join(said)
          + f"; checkpoint files {r['files']}", flush=True)
    once = all(sum(ln.startswith(h) for ln in r["lines"]) == 1
               for h in ("ranks ", "sharded over 2 ranks: LCP rpy_ring", "stepped "))
    if (r["rc"] != 0 or not once or not r["vtk"]
            or r["files"] != [f"ckpt_{steps:012d}.json", f"ckpt_{steps:012d}.npz"]):
        print(r["stdout"][-3000:], r["stderr"][-3000:], flush=True)
        fail("[64] lcp_spheres_100k.yaml --devices 2 with hydro=rpy_ring failed")


def devices_cli_phases() -> None:
    """[50], [53], [59] and [64]: every `--devices 2` subprocess of
    CLI_DEVICES_RUNS started at once (cli_devices), then each phase's
    checks."""
    t0 = time.perf_counter()
    runs = [run for phase in CLI_DEVICES_RUNS.values() for run in phase]
    results = cli_devices([(yaml, sets, outputs) for yaml, sets, outputs, _ in runs])
    k = 0
    for phase, check in ((50, cli_devices_phase), (53, cli_balanced_phase),
                         (59, cli_block_phase), (64, cli_ring_phase)):
        n = len(CLI_DEVICES_RUNS[phase])
        check(results[k:k + n])
        k += n
    print(f"[50], [53], [59], [64] took {time.perf_counter() - t0:.1f} s", flush=True)


def slice20_phases(torch, dev, card: str) -> dict:
    """Phases 60-64: LCP rpy_ring over ranks ([60]: d = 2, then d = 1 in
    this process), parallel.sharded_step's v1 and v2 at 1M ([61]), slab_lcp
    at config #2's 1M ([62]), float64 card against CPU ([63]), all at d = 2
    in one group of two gloo ranks on this card (CUDA tensors staged through
    pinned host buffers: functional numbers, not scaling); [64] runs with
    the other CLI phases at the end. Returns K2's and K3's launches on these
    paths by entry name."""
    import numpy as np

    from mundy_tpu_torch.parallel import comm

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    d2 = comm.spawn_ranks(slice20_ranks, 2, "cuda", timeout=600.0, threads=4,
                          log=lambda line: print(f"[60]-[63] d = 2: {line}", flush=True))
    torch.cuda.empty_cache()
    one = ring_shard_run(comm.Group.single(dev))
    torch.cuda.empty_cache()
    # ---- 60 ----------------------------------------------------------------
    ring = [d2[k]["ring"] for k in range(2)]
    r0 = ring[0]
    for d, ranks in ((2, ring), (1, [one])):
        print(f"[60] LCP rpy_ring, {RING_N} spheres in box {r0['box']:.3f} (float32), d = {d}"
              + (" on one card (gloo, staged)" if d == 2 else " (one rank)")
              + f": init + {RING_SHARD_WARM} step {ranks[0]['warm_s']:.2f} s, then "
              f"{RING_SHARD_STEPS} steps: " + "; ".join(
                  f"rank {k} ms/step {[round(m, 3) for m in r['ms']]}, BBPGD iterations "
                  f"{r['iters']}, launches K2 {r['k2']}, K3 {r['k3']} (mobility applies "
                  f"{r['applies']}), bytes moved/step {r['bytes']:.0f}, staging "
                  f"{r['stage_ms']:.3f} ms/step, one ring apply {r['apply_ms']:.3f} ms by CUDA "
                  f"events" for k, r in enumerate(ranks))
              + f"; rebuilds {ranks[0]['rebuilds']}; {card}", flush=True)
    print(f"    rank 0 at d = 2: K3 at (nb, W) {r0['k3_shape'][0]} ({r0['k3_shape'][1]} active "
          f"pairs) bit-equal to its plain version {r0['k3_equal']}; K2 at (ny, nz, R) "
          f"{r0['k2_shape']} equal to its plain version {r0['k2_equal']}; max overlap "
          f"{r0['overlap']:.3e} (d = 1: {one['overlap']:.3e}); {card}", flush=True)
    if any(r["overflow"] or not r["finite"] for r in ring + [one]):
        fail("[60] an rpy_ring run overflowed or went non-finite")
    if ring[0]["iters"] != ring[1]["iters"]:
        fail(f"[60] the ranks took different BBPGD iterations: {ring[0]['iters']}, "
             f"{ring[1]['iters']}")
    if any(r["k3"] != r["applies"] or r["k2"] < 1 for r in ring + [one]):
        fail(f"[60] launches {[(r['k2'], r['k3'], r['applies']) for r in ring + [one]]}")
    if not (r0["k3_equal"] and r0["k2_equal"] and one["k3_equal"] and one["k2_equal"]):
        fail("[60] K2 or K3 disagrees with its plain version at the rpy_ring state")
    rows_card, pos_card = d2[0]["ring_f64"]["card"]
    rows_cpu, pos_cpu = d2[0]["ring_f64"]["cpu"]
    err = float(np.abs(pos_card - pos_cpu).max())
    print(f"[60] float64 300 spheres, {RING_F64_STEPS} steps, d = 2 on the card vs one CPU "
          f"rank: counters equal at every step {rows_card == rows_cpu}, rebuilds "
          f"{rows_card[-1][2]}, max|pos diff| {err:.3e}", flush=True)
    if not (rows_card == rows_cpu and err <= 1e-8):
        fail("[60] the float64 rpy_ring run over ranks on the card disagrees with the CPU")
    # ---- 61 ----------------------------------------------------------------
    ss = [d2[k]["sharded_step"] for k in range(2)]
    for name in ("v1", "v2"):
        print(f"[61] sharded_step {name}, {SHARDED_N} spheres (config #1's physics, float32), "
              f"d = 2 on one card (gloo, staged), {SHARDED_STEP_STEPS} steps after 1: "
              + "; ".join(f"rank {k} {r[name]['ms']:.3f} ms/step, bytes moved/step "
                          f"{r[name]['bytes']:.0f}" + (f" (the position all_gather "
                                                        f"{SHARDED_N // 2 * 12} B)"
                                                        if name == "v1" else
                                                        f", own {r[name]['own']} of capacity "
                                                        f"{r[name]['capacity']}")
                          + f", staging {r[name]['stage_ms']:.3f} ms/step"
                          for k, r in enumerate(ss))
              + f"; max overlap {ss[0][name]['overlap']:.4f}"
              + (f", flags {ss[0]['v2']['flags']}, every gid owned once "
                 f"{ss[0]['v2']['owned_once']}" if name == "v2" else "") + f"; {card}",
              flush=True)
    if not all(r[n]["finite"] for r in ss for n in ("v1", "v2")):
        fail("[61] a sharded_step run went non-finite")
    if ss[0]["v2"]["flags"] or not ss[0]["v2"]["owned_once"]:
        fail("[61] v2 overflowed or lost or duplicated a sphere")
    # ---- 62 ----------------------------------------------------------------
    sl = [d2[k]["slab_lcp"] for k in range(2)]
    s0 = sl[0]
    print(f"[62] slab_lcp, {N_BIG} spheres (config #2's protocol config, float32), d = 2 on "
          f"one card (gloo, staged): grid (ny, nz, R) {s0['grid']}, {s0['nzl']} planes per rank, "
          f"{s0['mode']} rebuilds; {SLAB_LCP_WARM} step from init {s0['warm_s']:.2f} s, then "
          f"{SLAB_LCP_STEPS} steps: " + "; ".join(
              f"rank {k} {r['ms']:.1f} ms/step, BBPGD iterations {r['iters']}, K3 launches "
              f"{r['k3']} (applies {r['applies']}), bytes moved/step {r['bytes']:.0f}, staging "
              f"{r['stage_ms']:.2f} ms/step" for k, r in enumerate(sl))
          + f"; rebuilds {s0['rebuilds']}, valid {s0['valid']}; {card}", flush=True)
    print(f"    rank 0: K3 at (nb, W) {s0['k3_shape'][0]}, B {s0['k3_shape'][1]} "
          f"({s0['k3_shape'][2]} ordered pairs) bit-equal to its plain version "
          f"{s0['k3_equal']}; {card}", flush=True)
    if any(r["overflow"] or not r["finite"] for r in sl) or s0["valid"] != N_BIG:
        fail("[62] the slab_lcp run overflowed, lost a sphere or went non-finite")
    if sl[0]["iters"] != sl[1]["iters"] or any(r["k3"] != r["applies"] for r in sl):
        fail(f"[62] iterations {[r['iters'] for r in sl]}, K3 launches "
             f"{[(r['k3'], r['applies']) for r in sl]}")
    if not s0["k3_equal"]:
        fail("[62] K3 disagrees with its plain version at rank 0's windows")
    # ---- 63 ----------------------------------------------------------------
    f64 = d2[0]["f64"]
    msgs, ok = [], True
    for name in ("v2", "local", "global"):
        g, c = f64["card"][name], f64["cpu"][name]
        same = bool(np.array_equal(g["gid"], c["gid"]) and np.array_equal(g["valid"], c["valid"]))
        v = c["valid"]
        err = float(np.abs(g["pos"][v] - c["pos"][v]).max())
        extra = "" if name == "v2" else (f", rebuilds {g['rebuilds']} (cpu {c['rebuilds']}), "
                                         f"iterations equal {g['iters'] == c['iters']}")
        msgs.append(f"{'v2' if name == 'v2' else 'slab_lcp ' + name}: gid and valid equal "
                    f"{same}, max|pos diff| {err:.3e}{extra}")
        ok = ok and same and err <= 1e-8 and (name == "v2" or (
            g["iters"] == c["iters"] and g["rebuilds"] == c["rebuilds"]))
    print("[63] float64 at d = 2, card vs CPU: " + "; ".join(msgs), flush=True)
    if not ok:
        fail("[63] a float64 run on the card disagrees with the CPU run")
    # ---- 64 ----------------------------------------------------------------
    print(f"[60]-[63] took {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"row_neighbor_extract": {
                **{f"lcp rpy_ring {RING_N} d=2 rank {k}": r["k2"] for k, r in enumerate(ring)},
                f"lcp rpy_ring {RING_N} d=1": one["k2"]},
            "strided_onehot_segment_sum": {
                **{f"lcp rpy_ring {RING_N} d=2 rank {k}": r["k3"] for k, r in enumerate(ring)},
                f"lcp rpy_ring {RING_N} d=1": one["k3"],
                **{f"slab_lcp 1M d=2 rank {k}": r["k3"] for k, r in enumerate(sl)}}}


def drift_phase(torch, card: str) -> dict:
    """[65]: the f32-vs-f64 drift harness (mundy_tpu_torch/driver/drift.py)
    with its float32 leg on the card, for each of DRIFT_RUNS. K2's and K3's
    counts are set to 0 just before the runs and read just after; each
    launch is put down to the leg (float32 or float64) whose init() or
    run_block() made it. Fails on a bar of tests/test_drift.py, a
    non-finite number, or no K2 or K3 launch over the float32 LCP legs.
    Returns the float32 legs' launches, {kernel name: count}."""
    import numpy as np

    from mundy_tpu_torch.driver import drift
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresSim
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    t_start = time.perf_counter()
    legs = {torch.float32: [0, 0], torch.float64: [0, 0]}  # (K2, K3) a leg
    ulp_test = float(np.spacing(np.float32(drift._box(DRIFT_TEST_N))))

    def counted(method):
        def wrapper(self, *args, **kwargs):
            c2 = k2.row_neighbor_extract.launches
            c3 = k3.strided_onehot_segment_sum.launches
            try:
                return method(self, *args, **kwargs)
            finally:
                legs[self.dtype][0] += k2.row_neighbor_extract.launches - c2
                legs[self.dtype][1] += k3.strided_onehot_segment_sum.launches - c3
        return wrapper

    originals = {name: getattr(LCPSpheresSim, name) for name in ("init", "run_block")}
    bad = []
    k2.row_neighbor_extract.launches = 0
    k3.strided_onehot_segment_sum.launches = 0
    try:
        for name, method in originals.items():
            setattr(LCPSpheresSim, name, counted(method))
        for config, n, steps, ref in DRIFT_RUNS:
            t0 = time.perf_counter()
            before = [list(v) for v in legs.values()]
            bar = DRIFT_PER_STEP_BAR * float(np.spacing(np.float32(drift._box(n)))) / ulp_test
            out = drift.run(config, n, steps, device="cuda", ref_device=ref)
            torch.cuda.synchronize()
            f32 = [a - b for a, b in zip(legs[torch.float32], before[0])]
            f64 = [a - b for a, b in zip(legs[torch.float64], before[1])]
            print(f"[65] drift {config} N = {n}, {steps} steps, float32 on the card, float64 "
                  f"on {ref}: per-step drift {out['per_step_drift']!r} (bar {bar!r}), divergence "
                  f"{out['divergence']}" + (
                      f", max overlap f64 {out['max_overlap_f64']!r} f32 "
                      f"{out['max_overlap_f32']!r}, K2/K3 launches float32 leg {f32}, "
                      f"float64 leg {f64}" if config == "lcp" else "")
                  + f", {time.perf_counter() - t0:.1f} s ({card})", flush=True)
            numbers = [out["per_step_drift"], *out["divergence"].values()]
            if config == "lcp":
                numbers += [out["max_overlap_f64"], out["max_overlap_f32"]]
            if out["backend_f32"] != "cuda" or not all(map(math.isfinite, numbers)):
                bad.append(f"{config} {n}: the float32 leg left the card or a number "
                           "is not finite")
            if not out["per_step_drift"] < bar:
                bad.append(f"{config} {n}: per-step drift {out['per_step_drift']} >= {bar}")
            if config == "spheres" and not out["divergence"]["20"] < DRIFT_SPHERES_20_BAR:
                bad.append(f"spheres {n}: divergence at 20 {out['divergence']['20']}")
            if config == "lcp" and not max(out["max_overlap_f64"],
                                           out["max_overlap_f32"]) < DRIFT_OVERLAP_BAR:
                bad.append(f"lcp {n}: max overlap {out['max_overlap_f64']}, "
                           f"{out['max_overlap_f32']}")
    finally:
        for name, method in originals.items():
            setattr(LCPSpheresSim, name, method)
    k2_f32, k3_f32 = legs[torch.float32]
    total = (k2.row_neighbor_extract.launches, k3.strided_onehot_segment_sum.launches)
    print(f"[65] K2 and K3 launches over the float32 LCP legs: {k2_f32}, {k3_f32} "
          f"(all legs {total[0]}, {total[1]})", flush=True)
    if bad:
        fail("[65] " + "; ".join(bad))
    if not (k2_f32 > 0 and k3_f32 > 0) or sum(legs[torch.float64]) + k2_f32 + k3_f32 != sum(total):
        fail(f"[65] K2 or K3 was not launched over the float32 LCP legs ({k2_f32}, {k3_f32}), "
             "or a launch fell outside the legs")
    print(f"[65] took {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"row_neighbor_extract": k2_f32, "strided_onehot_segment_sum": k3_f32}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import mundy_tpu_torch
    except ImportError as e:
        fail(f"the mundy_tpu_torch package is not beside this script ({e})")
    if os.path.dirname(os.path.dirname(os.path.abspath(mundy_tpu_torch.__file__))) != HERE:
        fail(f"mundy_tpu_torch was imported from {mundy_tpu_torch.__file__}, "
             "not from this checkout")
    from mundy_tpu_torch.core.config import config_from_dict, load_yaml
    from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
    from mundy_tpu_torch.driver.apps.lcp_spheres import (LCPSpheresConfig,
                                                         LCPSpheresSim)
    from mundy_tpu_torch.driver.apps.rods import RodsConfig
    from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
    from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
    from mundy_tpu_torch.dynamics.brownian import brownian_velocity_keyed
    from mundy_tpu_torch.geom.randomize import random_unit_quaternions
    from mundy_tpu_torch.neighbor.rows import build_rows, make_row_grid
    from mundy_tpu_torch.ops.kernels import _build
    from mundy_tpu_torch.ops.kernels import row_central as k1
    from mundy_tpu_torch.ops.kernels import row_extract as k2
    from mundy_tpu_torch.ops.kernels import row_segments as k4
    from mundy_tpu_torch.ops.kernels import seg_onehot as k3

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not read the card's power limit: {e}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()

    # ---- 1. build ---------------------------------------------------------
    build_all(_build)
    if sys.argv[1:] == ["--only-drift"]:  # a short run of [65] alone
        print(json.dumps({"path_launches": drift_phase(torch, card)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:] == ["--only-sharded"]:  # a short run of [46]-[64] alone
        print(json.dumps({"path_launches": sharded_phases(torch, dev, card)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return

    # ---- 2. K1 vs plain at the 1M main-path shape -------------------------
    big = bench_config(SpheresConfig, N_BIG)
    sim = RowSpheresSim(big, device=dev)
    state = sim.init()
    rows = state.rows
    box = sim.box_static[0]
    args = (box, big.radius, big.youngs_modulus, big.poissons_ratio)
    f_k = k1.row_hertzian_forces_sym(rows.pos, *args, valid=rows.valid)  # as the step calls it
    f_n = k1.row_hertzian_forces_sym(rows.pos, *args)  # the reference's signature
    f_p = k1.row_hertzian_forces_plain(rows.pos, *args)
    torch.cuda.synchronize()
    m = rows.valid
    k1_err = (f_k[m] - f_p[m]).abs().max().item()
    fmax = f_p[m].abs().max().item()
    same = bool(torch.equal(f_k, f_n))
    ny, nz, R = rows.valid.shape
    print(f"[2] K1 at (ny, nz, R) = ({ny}, {nz}, {R}), {int(m.sum())} valid "
          f"slots: max|diff| {k1_err:.3e}, max|f| {fmax:.3e}; without the mask bit-equal "
          f"{same}", flush=True)
    if not (fmax > 0 and math.isfinite(k1_err) and k1_err <= 2e-5 * fmax and same):
        fail(f"K1 disagrees with its plain version ({k1_err} > 2e-5 * {fmax}) or without "
             f"the mask (bit-equal {same})")
    k1_ms, k1_plain_ms = alternate(
        lambda: k1.row_hertzian_forces_sym(rows.pos, *args, valid=rows.valid),
        lambda: k1.row_hertzian_forces_plain(rows.pos, *args), torch, 10, 2)
    # the occupied pairs within the early stop's cut in x at K1_PAIR_OPS
    # each, those in contact at K1_CONTACT_OPS more; read valid on every slot
    # and the occupied slots' positions once (a padded slot's forces are +0
    # from valid alone), write the forces on every slot once
    k1_in_x = cut_pairs_in_x(rows.pos, m, box, m.to(rows.pos.dtype) * big.radius,
                             lambda dx2, ro, rc: k1.contact_reach(dx2, big.radius), torch)
    k1_contacts = contact_pairs(rows.pos, m, box, m.to(rows.pos.dtype) * big.radius, torch)
    k1_flops = k1_in_x * K1_PAIR_OPS + k1_contacts * K1_CONTACT_OPS
    k1_bytes = m.numel() * (1 + 12) + int(m.sum()) * 12
    k1_bound = bound(k1_flops, k1_bytes)
    print(f"    K1 {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}; operations {1e3 * k1_flops / PEAK_FP32:.4f} "
          f"ms, {k1_bytes / 1e6:.1f} MB {1e3 * k1_bytes / PEAK_BYTES:.4f} ms), "
          f"{k1_ms / k1_bound[0]:.1f}x the bound; {k1_in_x:.0f} pairs within the cut in x, "
          f"{k1_contacts:.0f} in contact (occupied half-stencil pairs "
          f"{stencil_work(m, torch)[0]:.0f}); {card}", flush=True)
    del f_k, f_n, f_p, sim, state, rows

    # ---- 3. examples/spheres_10k.yaml, 200 steps ----------------------------
    raw = load_yaml(os.path.join(HERE, "examples", "spheres_10k.yaml"))
    params = dict(raw["params"], num_steps=200, dtype="float32")
    cfg = config_from_dict(SpheresConfig, params)
    sim = RowSpheresSim(cfg, device=dev)
    t0 = time.perf_counter()
    st = sim.run(log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    pos = sim.positions(st)
    n_valid = int(st.rows.valid.sum())
    print(f"[3] spheres_10k.yaml: {st.step} steps in "
          f"{time.perf_counter() - t0:.2f} s, rebuilds {st.rebuild_count}, "
          f"max overlap {sim.max_overlap(st):.4f}", flush=True)
    if not (st.step == 200 and n_valid == cfg.num_spheres and not bool(st.overflow)
            and bool(torch.isfinite(pos).all())):
        fail("spheres_10k.yaml run lost particles, overflowed or went non-finite")

    # ---- 4. float64 on the card vs the CPU plain path ---------------------
    small = SpheresConfig(num_spheres=2000, box_size=16.0, diffusion_coeff=0.01,
                          dt=1e-4, skin=0.1, dtype="float64")
    runs = {}
    for d in ("cuda", "cpu"):
        sim = RowSpheresSim(small, device=d)
        st = sim.init(pos=torch.rand((2000, 3), dtype=torch.float64,
                                     generator=torch.Generator().manual_seed(5)) * 16.0)
        st = sim.run_block(st, 60)
        runs[d] = (st, sim.positions(st).cpu())
    (sg, pg), (sc, pc) = runs["cuda"], runs["cpu"]
    diff = (pg - pc).abs().max().item()
    print(f"[4] float64 2000 spheres, 60 steps: rebuilds {sg.rebuild_count} "
          f"(cpu {sc.rebuild_count}), max|pos diff| vs cpu {diff:.3e}", flush=True)
    if not (sg.rebuild_count == sc.rebuild_count >= 3 and diff <= 1e-7
            and torch.equal(sg.rows.gid.cpu(), sc.rows.gid)):
        fail("the float64 run on the card disagrees with the CPU run")

    # ---- 5. the 1M config #1 through run_block ----------------------------
    sim = RowSpheresSim(big, device=dev)
    st = sim.init()
    st = sim.run_block(st, 3)  # warm up allocator and kernel
    torch.cuda.synchronize()
    rb0 = st.rebuild_count
    k1.row_hertzian_forces_sym.launches = 0
    t0 = time.perf_counter()
    st = sim.run_block(st, BIG_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1_launches = k1.row_hertzian_forces_sym.launches
    pos = sim.positions(st)
    n_valid = int(st.rows.valid.sum())
    rebuilds = st.rebuild_count - rb0
    print(f"[5] 1M config #1: {BIG_STEPS} steps in {elapsed:.3f} s = "
          f"{BIG_STEPS / elapsed:.2f} steps/s, {1e3 * elapsed / BIG_STEPS:.3f} "
          f"ms/step, rebuilds {rebuilds}, R {sim.grid.row_capacity}, "
          f"K1 launches {k1_launches}", flush=True)
    if not bool(torch.isfinite(pos).all()):
        fail("non-finite positions in the 1M run")
    if n_valid != N_BIG or bool(st.overflow):
        fail(f"1M run lost particles or overflowed (valid {n_valid})")
    if rebuilds < 1:
        fail("no rebuild in the 1M window")
    if k1_launches != BIG_STEPS:
        fail(f"K1 launched {k1_launches} times in {BIG_STEPS} steps")
    row_ms = 1e3 * elapsed / BIG_STEPS  # [36] prints the flat engine beside it
    profile_window(lambda n: sim.run_block(st, n), torch, row_ms)
    del sim, st, pos

    # ---- 6. the 1M LCP bench protocol (bench.py:39-74) ---------------------
    lcfg = lcp_bench_config(LCPSpheresConfig, N_BIG)
    sim = LCPSpheresSim(lcfg, device=dev)
    t0 = time.perf_counter()
    st = sim.init()
    torch.cuda.synchronize()
    print(f"[6] 1M LCP init in {time.perf_counter() - t0:.2f} s: pair capacity "
          f"{sim.pair_capacity}, rows_k {sim.rows_k}, rows_slack "
          f"{sim.rows_slack:.4f}, seg_window {sim.seg_window}, act_window "
          f"{sim.act_window}, active {int(st.act_count)}", flush=True)
    for _ in range(3):  # settle + give the active-window resize chances
        st = sim.run_block(st, 9)
    settle_overflow = bool(st.overflow)
    st = st.replace(overflow=torch.zeros((), dtype=torch.bool, device=dev))
    st = sim.run_block(st, 2, resize=False)
    torch.cuda.synchronize()
    if bool(st.overflow):
        fail("LCP capacities still overflow after the settle+resize blocks")
    rb0 = st.rebuild_count
    window = 24
    k2.row_neighbor_extract.launches = 0
    k3.strided_onehot_segment_sum.launches = 0
    t0 = time.perf_counter()
    st = sim.run_block(st, window, resize=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2_launches = k2.row_neighbor_extract.launches
    k3_launches = k3.strided_onehot_segment_sum.launches
    rebuilds = st.rebuild_count - rb0
    print(f"    1M LCP line: {window} steps in {elapsed:.3f} s = "
          f"{window / elapsed:.3f} steps/s, {1e3 * elapsed / window:.3f} ms/step, "
          f"lcp_iters {st.lcp_iters} (max {st.lcp_iters_max}), active "
          f"{int(st.act_count)}, rebuilds/step {rebuilds / window:.4f}, "
          f"settle overflow {settle_overflow}, W {sim.act_window}, rows_k "
          f"{sim.rows_k}, K2 launches {k2_launches}, K3 launches {k3_launches}",
          flush=True)
    if bool(st.overflow) or not bool(torch.isfinite(st.pos).all()):
        fail("the 1M LCP window overflowed or went non-finite")
    if k3_launches != window:
        fail(f"K3 launched {k3_launches} times in {window} steps")
    if rebuilds < 1 or k2_launches != rebuilds:
        fail(f"K2 launched {k2_launches} times for {rebuilds} broad phases")
    profile_window(lambda n: sim.run_block(st, n, resize=False), torch,
                   1e3 * elapsed / window)

    # ---- 7. K2 vs plain at the 1M LCP row shape of the timed window ---------
    K = min(lcfg.max_neighbors, sim.rows_k)
    cutoff = 2 * sim.search_radius
    grid = make_row_grid([0, 0, 0], [lcfg.box_size] * 3, cutoff, N_BIG,
                         capacity_slack=sim.rows_slack, dtype=torch.float32,
                         align=8, device=dev)
    rs = build_rows(st.pos, torch.arange(N_BIG, dtype=torch.int32, device=dev), grid)
    k2_args = (rs.pos, rs.gid, rs.valid, ((lcfg.box_size,) * 3, (True,) * 3),
               cutoff, K, N_BIG)
    ids_k, cnt_k = k2.row_neighbor_extract(*k2_args)
    ids_p, cnt_p = k2.row_neighbor_extract_plain(*k2_args)
    torch.cuda.synchronize()
    ny, nz, R = rs.valid.shape
    k2_mismatch = int((ids_k != ids_p).sum()) + int((cnt_k != cnt_p).sum())
    k2_err = max(int((ids_k - ids_p).abs().max()), int((cnt_k - cnt_p).abs().max()))
    print(f"[7] K2 at (ny, nz, R) = ({ny}, {nz}, {R}), K = {K}: "
          f"{k2_mismatch} mismatched ids/counts, max count {int(cnt_p.max())}, "
          f"mean count {cnt_p[rs.valid].float().mean().item():.3f}", flush=True)
    if k2_mismatch != 0:
        fail(f"K2 disagrees with its plain version in {k2_mismatch} entries")
    k2_ms, k2_plain_ms = alternate(lambda: k2.row_neighbor_extract(*k2_args),
                                   lambda: k2.row_neighbor_extract_plain(*k2_args),
                                   torch, 10, 1, rounds=2)
    k2_b, k2_pairs, k2_old = k2_bound(rs, (lcfg.box_size,) * 3, cutoff, K, None, torch)
    k2_dev_ms = queued_ms(lambda: k2.row_neighbor_extract(*k2_args), torch)
    print(f"    K2 {k2_ms:.4f} ms (device time per launch {k2_dev_ms:.4f} ms), plain "
          f"{k2_plain_ms:.4f} ms, bound {k2_b[0]:.4f} ms ({k2_b[1]}; "
          f"{k2_ms / k2_b[0]:.1f}x), {k2_pairs:.0f} ordered pairs within the cut in x; "
          f"the first design's count over every occupied candidate: {k2_old[0]:.4f} ms, "
          f"{k2_old[1]}", flush=True)
    del ids_k, ids_p, cnt_k, cnt_p, rs

    # ---- 8. K3 vs plain at the 1M LCP strided shape of the timed window ----
    # the strided layout of the next step of the bench line: the active
    # subset of the window's final state, through collision_forces' reshapes
    values, loc, n_act = k3_window_inputs(sim, st, N_BIG, 3, torch)
    nb, W, B = sim.nb_blocks, sim.act_window, sim.seg_block
    blk = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] * B
    s_k = k3.strided_onehot_segment_sum(values, loc, B)
    s_p = k3.strided_segment_sum_plain(values, loc, B)
    torch.cuda.synchronize()
    k3_err = (s_k - s_p).abs().max().item()
    smax = s_p.abs().max().item()
    n_sorted = int((loc[:, 1:] >= loc[:, :-1]).all(1).sum())
    print(f"[8] K3 at (nb, W, B) = ({nb}, {W}, {B}), {n_act} active pairs: "
          f"max|diff| {k3_err:.3e}, max|sum| {smax:.3e}, bit-equal "
          f"{bool(torch.equal(s_k, s_p))}, {n_sorted} of {nb} blocks with "
          f"nondecreasing ids", flush=True)
    if not (smax > 0 and torch.equal(s_k, s_p)):
        fail(f"K3 is not bit-equal to its plain version (max|diff| {k3_err})")
    k3_ms, k3_plain_ms = alternate(lambda: k3.strided_onehot_segment_sum(values, loc, B),
                                   lambda: k3.strided_segment_sum_plain(values, loc, B),
                                   torch, 20, 3)
    # the library yardstick: one index_add_ of the (A, 3) pair vectors into
    # the body sums, dropped ids sent to a spare row (inputs prepared untimed)
    keep = (loc >= 0) & (loc < B)
    flat = torch.where(keep, blk.to(torch.int64) + loc, nb * B).reshape(-1)
    vals = values.transpose(1, 2).reshape(-1, 3).contiguous()
    acc = torch.zeros((nb * B + 1, 3), device=dev)
    lib_sum = acc.clone().index_add_(0, flat, vals)[:nb * B]
    lib_err = (lib_sum.reshape(nb, B, 3).transpose(1, 2) - s_p).abs().max().item()
    k3_lib_ms = statistics.median(
        [cuda_ms(lambda: acc.index_add_(0, flat, vals), torch, 20) for _ in range(3)])
    # 3 adds per active pair; read values and loc once, write the sums once
    k3_bound = bound(3.0 * n_act, values.numel() * 4 + loc.numel() * 4 + s_k.numel() * 4)
    k3_dev_ms = queued_ms(lambda: k3.strided_onehot_segment_sum(values, loc, B), torch)
    print(f"    K3 {k3_ms:.4f} ms (device time per launch {k3_dev_ms:.4f} ms), plain "
          f"{k3_plain_ms:.4f} ms, index_add_ "
          f"{k3_lib_ms:.4f} ms (max|diff| {lib_err:.3e}), bound "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]})", flush=True)
    lcp_sim, lcp_st = sim, st  # [26] holds K3t at this state
    del sim, st, values, loc, s_k, s_p, acc, vals, flat

    # ---- 9. examples/lcp_spheres_100k.yaml ---------------------------------
    raw = load_yaml(os.path.join(HERE, "examples", "lcp_spheres_100k.yaml"))
    cfg = config_from_dict(LCPSpheresConfig, raw["params"])
    sim = LCPSpheresSim(cfg, device=dev)
    t0 = time.perf_counter()
    st = sim.run(log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    print(f"[9] lcp_spheres_100k.yaml: {st.step} steps in "
          f"{time.perf_counter() - t0:.2f} s, rebuilds {st.rebuild_count}, "
          f"lcp_iters {st.lcp_iters} (max {st.lcp_iters_max}), max overlap "
          f"{sim.max_overlap(st):.3e}", flush=True)
    if not (st.step == cfg.num_steps and not bool(st.overflow)
            and bool(torch.isfinite(st.pos).all())):
        fail("lcp_spheres_100k.yaml overflowed or went non-finite")

    # ---- 10. the LCP line in float64 on the card vs the CPU ----------------
    small = dict(num_spheres=2000, box_size=20.0, radius=0.5, dt=1e-3,
                 diffusion_coeff=0.01, constraint_buffer=0.45, dtype="float64")
    pos0 = torch.rand((2000, 3), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(9)) * 20.0
    trace = {}
    for d in ("cuda", "cpu"):
        sim = LCPSpheresSim(LCPSpheresConfig(**small), device=d)
        st = sim.init(pos=pos0, key_words=(0, 9))
        rows_ = []
        for _ in range(30):
            st = sim.run_block(st, 1, resize=False)
            rows_.append((st.lcp_iters, int(st.act_count), int(st.act_block_max),
                          st.rebuild_count, bool(st.overflow)))
        trace[d] = (rows_, st.pos.cpu())
    diff = (trace["cuda"][1] - trace["cpu"][1]).abs().max().item()
    print(f"[10] LCP float64 2000 spheres, 30 steps: rebuilds "
          f"{trace['cuda'][0][-1][3]} (cpu {trace['cpu'][0][-1][3]}), max|pos "
          f"diff| vs cpu {diff:.3e}", flush=True)
    print(f"    lcp_iters card {[r[0] for r in trace['cuda'][0]]}", flush=True)
    print(f"    lcp_iters cpu  {[r[0] for r in trace['cpu'][0]]}", flush=True)
    if not (trace["cuda"][0] == trace["cpu"][0] and diff <= 1e-8
            and trace["cuda"][0][-1][3] >= 2):
        fail("the float64 LCP run on the card disagrees with the CPU run")
    del sim, st

    # ---- 11. K4 vs plain at the 1M config #3 shape -------------------------
    raw = load_yaml(os.path.join(HERE, "examples", "rods_100k.yaml"))
    big_rods = config_from_dict(RodsConfig, dict(
        raw["params"], num_rods=N_BIG,
        box_size=raw["params"]["box_size"] * (N_BIG / raw["params"]["num_rods"]) ** (1 / 3)))
    rsim = RowRodsSim(big_rods, device=dev)
    rst = rsim.init()
    rows = rst.rows
    k4_args = (rows.pos, rsim.half_edges(rows, rst.quat), rsim.box_static[0],
               big_rods.radius, rsim.e_eff)
    k4_kernel = (lambda: k4.row_segment_pairs_sym(*k4_args[:2], rows.valid, *k4_args[2:]))
    out_k = k4_kernel()
    out_p = k4.row_segment_pairs_plain(*k4_args)
    torch.cuda.synchronize()
    errs = [(g - r).abs().max().item() for g, r in zip(out_k, out_p)]
    maxs = [r.abs().max().item() for r in out_p]
    k4_err = max(errs)
    ny, nz, R = rows.valid.shape
    print(f"[11] K4 at (ny, nz, R) = ({ny}, {nz}, {R}), box {big_rods.box_size:.4f}, "
          f"{int(rows.valid.sum())} valid slots: force max|diff| {errs[0]:.3e} of "
          f"max {maxs[0]:.3e}, torque max|diff| {errs[1]:.3e} of max {maxs[1]:.3e}",
          flush=True)
    # each pair's arithmetic is the plain version's (no FMA contraction):
    # only the order of the candidate sums differs
    if not all(m > 0 and math.isfinite(e) and e <= 1e-5 * m for e, m in zip(errs, maxs)):
        fail(f"K4 disagrees with its plain version: {errs} vs 1e-5 * {maxs}")
    k4_ms, k4_plain_ms = alternate(k4_kernel,
                                   lambda: k4.row_segment_pairs_plain(*k4_args),
                                   torch, 5, 1, rounds=1)
    # the pairs within reach in x at K4_REACH_OPS, those within reach in 3D
    # at K4_OPS and the rods at K4_ROD_OPS; read valid on every slot and the
    # midpoints and half-edges of the valid slots once (a padded slot's
    # outputs are exact zeros that depend on valid alone), write force and
    # torque on every slot once
    k4_in_x, k4_in_3d = reach_pairs(rows.pos, k4_args[1], rows.valid, k4_args[2],
                                    big_rods.radius, k4, torch)
    n_rods = float(rows.valid.sum())
    k4_flops = k4_in_x * K4_REACH_OPS + k4_in_3d * K4_OPS + n_rods * K4_ROD_OPS
    k4_bytes = rows.valid.numel() * (1 + 24) + n_rods * (12 + 12)
    k4_bound = bound(k4_flops, k4_bytes)
    print(f"    K4 {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}; operations {1e3 * k4_flops / PEAK_FP32:.4f} ms, "
          f"{k4_bytes / 1e6:.1f} MB {1e3 * k4_bytes / PEAK_BYTES:.4f} ms), "
          f"{k4_ms / k4_bound[0]:.1f}x the bound; {k4_in_x:.0f} pairs within reach in x, "
          f"{k4_in_3d:.0f} in 3D; {card}", flush=True)
    del out_k, out_p, k4_args, k4_kernel, rows

    # ---- 12. examples/rods_100k.yaml, YAML_STEPS steps -----------------------
    cfg = config_from_dict(RodsConfig, dict(raw["params"], num_steps=YAML_STEPS))
    sim = RowRodsSim(cfg, device=dev)
    t0 = time.perf_counter()
    st = sim.run(log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    pos, quat = sim.positions(st), sim.quaternions(st)
    n_valid = int(st.rows.valid.sum())
    q_err = (quat.norm(dim=1) - 1).abs().max().item()
    print(f"[12] rods_100k.yaml: {st.step} steps in {elapsed:.2f} s = "
          f"{st.step / elapsed:.2f} steps/s, rebuilds {st.rebuild_count}, R "
          f"{sim.grid.row_capacity}, max| |q| - 1 | {q_err:.3e}", flush=True)
    if not (st.step == cfg.num_steps and n_valid == cfg.num_rods and not bool(st.overflow)
            and bool(torch.isfinite(pos).all()) and q_err <= 1e-5):
        fail("rods_100k.yaml lost rods, overflowed, went non-finite or lost unit quaternions")
    del sim, st, pos, quat

    # ---- 13. config #3 in float64 on the card vs the CPU -------------------
    small = RodsConfig(num_rods=400, box_size=24.0, radius=0.25, length=2.0,
                       diffusion_coeff=0.05, rot_diffusion_coeff=0.05, dt=1e-4,
                       dtype="float64")
    gen = torch.Generator().manual_seed(13)
    pos0 = torch.rand((400, 3), dtype=torch.float64, generator=gen) * 24.0
    quat0 = random_unit_quaternions(gen, 400, dtype=torch.float64)
    runs = {}
    for d in ("cuda", "cpu"):
        sim = RowRodsSim(small, device=d)
        st = sim.init(pos=pos0, quat=quat0, key_words=(0, 13))
        st = sim.run_block(st, 60)
        runs[d] = (st, sim.positions(st).cpu(), sim.quaternions(st).cpu())
    (sg, pg, qg), (sc, pc, qc) = runs["cuda"], runs["cpu"]
    diff = (pg - pc).abs().max().item()
    qdiff = torch.minimum((qg - qc).abs().amax(1), (qg + qc).abs().amax(1)).max().item()
    print(f"[13] rods float64 400 rods, 60 steps: rebuilds {sg.rebuild_count} (cpu "
          f"{sc.rebuild_count}), max|pos diff| {diff:.3e}, max|quat diff| {qdiff:.3e}",
          flush=True)
    if not (sg.rebuild_count == sc.rebuild_count >= 2 and diff <= 1e-7 and qdiff <= 1e-7
            and torch.equal(sg.rows.gid.cpu(), sc.rows.gid)):
        fail("the float64 rods run on the card disagrees with the CPU run")

    # ---- 14. the 1M config #3 through run_block -----------------------------
    rst = rsim.run_block(rst, 3)  # warm up allocator and kernel
    torch.cuda.synchronize()
    rb0 = rst.rebuild_count
    k4.row_segment_pairs_sym.launches = 0
    t0 = time.perf_counter()
    rst = rsim.run_block(rst, RODS_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k4_launches = k4.row_segment_pairs_sym.launches
    rebuilds = rst.rebuild_count - rb0
    print(f"[14] 1M config #3: {RODS_STEPS} steps in {elapsed:.3f} s = "
          f"{RODS_STEPS / elapsed:.3f} steps/s, {1e3 * elapsed / RODS_STEPS:.3f} "
          f"ms/step, rebuilds/step {rebuilds / RODS_STEPS:.4f}, R "
          f"{rsim.grid.row_capacity}, K4 launches {k4_launches}; {card}", flush=True)
    if not bool(torch.isfinite(rsim.positions(rst)).all()):
        fail("non-finite positions in the 1M rods run")
    if int(rst.rows.valid.sum()) != N_BIG or bool(rst.overflow):
        fail("the 1M rods run lost rods or overflowed")
    if rebuilds < 1:
        fail("no rebuild in the 1M rods window")
    if k4_launches != RODS_STEPS:
        fail(f"K4 launched {k4_launches} times in {RODS_STEPS} steps")
    # K4 on the final state: the rods moved since the last sort of the rows
    rows = rst.rows
    fin_args = (rows.pos, rsim.half_edges(rows, rst.quat), rsim.box_static[0],
                big_rods.radius, rsim.e_eff)
    out_k = k4.row_segment_pairs_sym(*fin_args[:2], rows.valid, *fin_args[2:])
    out_p = k4.row_segment_pairs_plain(*fin_args)
    torch.cuda.synchronize()
    fin_errs = [(g - r).abs().max().item() for g, r in zip(out_k, out_p)]
    fin_maxs = [r.abs().max().item() for r in out_p]
    x = torch.where(rows.valid, rows.pos[..., 0], float("nan"))
    unsorted = int((x[..., 1:] < x[..., :-1]).sum())
    print(f"    K4 on the final state ({unsorted} neighbouring valid slots out of x "
          f"order): force max|diff| {fin_errs[0]:.3e} of max {fin_maxs[0]:.3e}, torque "
          f"max|diff| {fin_errs[1]:.3e} of max {fin_maxs[1]:.3e}", flush=True)
    if not all(m > 0 and math.isfinite(e) and e <= 1e-5 * m
               for e, m in zip(fin_errs, fin_maxs)):
        fail(f"K4 disagrees with its plain version on the final state: {fin_errs} vs "
             f"1e-5 * {fin_maxs}")
    del out_k, out_p, fin_args, rows, x
    # one of the step's two keyed noise calls at this row shape, alone
    noise_ms = statistics.median([cuda_ms(
        lambda: brownian_velocity_keyed(rst.key, rst.step, rst.rows.gid,
                                        big_rods.diffusion_coeff, big_rods.dt), torch, 5)
        for _ in range(3)])
    print(f"    one keyed noise call at the row shape: {noise_ms:.4f} ms "
          f"(two per step)", flush=True)
    profile_window(lambda n: rsim.run_block(rst, n), torch, 1e3 * elapsed / RODS_STEPS)

    del rsim, rst

    # ---- 15. K4's filaments op vs plain at the 2000 x 50 row-engine shape --
    fil = dict(num_filaments=2000, nodes_per_filament=50, box_size=120.0,
               diffusion_coeff=0.05, dtype="float32")
    fsim = FilamentsSim(FilamentsConfig(**fil, contact_engine="rows"), device=dev)
    fst = fsim.init()
    rows = fst.nmat
    k4f_args = fsim.row_contact_args(fst.pos, rows)  # what the step passes to it
    out_k = k4.row_segment_filaments_sym(*k4f_args)
    # the plain version takes seconds here: its one call for the comparison
    # is also its time
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out_p = k4.row_segment_filaments_plain(*k4f_args)
    ev[1].record()
    ev[1].synchronize()
    k4f_plain_ms = ev[0].elapsed_time(ev[1])
    errs = [(g - r).abs().max().item() for g, r in zip(out_k, out_p)]
    maxs = [r.abs().max().item() for r in out_p]
    k4f_err = max(errs)
    ny, nz, R = rows.valid.shape
    print(f"[15] K4 filaments op at (ny, nz, R) = ({ny}, {nz}, {R}), "
          f"{int(rows.valid.sum())} segments: f_start max|diff| {errs[0]:.3e} of max "
          f"{maxs[0]:.3e}, f_end max|diff| {errs[1]:.3e} of max {maxs[1]:.3e}, max "
          f"occupancy {int(rows.valid.sum(-1).max())}", flush=True)
    if not all(m > 0 and math.isfinite(e) and e <= 1e-5 * m for e, m in zip(errs, maxs)):
        fail(f"K4's filaments op disagrees with its plain version: {errs} vs 1e-5 * {maxs}")
    del out_k, out_p
    k4f_ms = statistics.median(
        [cuda_ms(lambda: k4.row_segment_filaments_sym(*k4f_args), torch, 5) for _ in range(2)])
    # the pairs within reach in x at K4_REACH_OPS, those within reach in 3D
    # at K4F_OPS and the segments at K4_ROD_OPS; read valid on every slot and
    # the midpoints, half-edges and gids of the occupied slots once (a padded
    # slot's outputs are exact zeros that depend on valid alone), write the
    # two node forces on every slot once
    k4f_in_x, k4f_in_3d = reach_pairs(k4f_args[0], k4f_args[1], rows.valid, k4f_args[4],
                                      k4f_args[5], k4, torch)
    n_seg = float(rows.valid.sum())
    k4f_flops = k4f_in_x * K4_REACH_OPS + k4f_in_3d * K4F_OPS + n_seg * K4_ROD_OPS
    k4f_bytes = rows.valid.numel() * (1 + 24) + n_seg * (12 + 12 + 4)
    k4f_bound = bound(k4f_flops, k4f_bytes)
    print(f"    K4 filaments {k4f_ms:.4f} ms, plain {k4f_plain_ms:.4f} ms, bound "
          f"{k4f_bound[0]:.4f} ms ({k4f_bound[1]}; operations "
          f"{1e3 * k4f_flops / PEAK_FP32:.4f} ms, {k4f_bytes / 1e6:.1f} MB "
          f"{1e3 * k4f_bytes / PEAK_BYTES:.4f} ms), {k4f_ms / k4f_bound[0]:.1f}x the bound; "
          f"{k4f_in_x:.0f} pairs within reach in x, {k4f_in_3d:.0f} in 3D (occupied "
          f"half-stencil pairs {stencil_work(rows.valid, torch)[0]:.0f}); {card}", flush=True)
    del k4f_args, rows

    # ---- 16. examples/filaments_sperm.yaml, YAML_STEPS steps ----------------
    raw = load_yaml(os.path.join(HERE, "examples", "filaments_sperm.yaml"))
    cfg = config_from_dict(FilamentsConfig, dict(raw["params"], num_steps=YAML_STEPS))
    sim = FilamentsSim(cfg, device=dev)
    t0 = time.perf_counter()
    st = sim.run(log=lambda line: print(f"    {line}", flush=True))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    q_err = (st.rod.edge_q.norm(dim=-1) - 1).abs().max().item()
    print(f"[16] filaments_sperm.yaml: {st.step} steps in {elapsed:.2f} s = "
          f"{st.step / elapsed:.2f} steps/s, engine {sim.contact_engine}, rebuilds "
          f"{st.rebuild_count}, max| |q| - 1 | {q_err:.3e}", flush=True)
    if not (st.step == cfg.num_steps and not bool(st.overflow)
            and bool(torch.isfinite(st.pos).all()) and q_err <= 1e-10):
        fail("filaments_sperm.yaml overflowed, went non-finite or lost unit quaternions")
    del sim, st

    # ---- 17. config #4 in float64 on the card vs the CPU, both engines ------
    small = dict(num_filaments=12, nodes_per_filament=8, box_size=24.0, radius=0.25,
                 bend_modulus=2.0, stretch_stiffness=100.0, dt=2e-4, diffusion_coeff=0.05,
                 skin=0.1, chunk=256, dtype="float64")
    pos0 = FilamentsSim(FilamentsConfig(**small), device="cpu").init().pos
    for engine in ("nmat", "rows"):
        runs = {}
        for d in ("cuda", "cpu"):
            sim = FilamentsSim(FilamentsConfig(**small, contact_engine=engine), device=d)
            st = sim.run_block(sim.init(pos=pos0, key_words=(0, 17)), 60)
            runs[d] = (st, st.pos.cpu(), sim.contact_engine)
        (sg, pg, eg), (sc, pc, ec) = runs["cuda"], runs["cpu"]
        diff = (pg - pc).abs().max().item()
        print(f"[17] filaments float64 12 x 8, 60 steps, engine {eg}: rebuilds "
              f"{sg.rebuild_count} (cpu {sc.rebuild_count}), max|pos diff| {diff:.3e}",
              flush=True)
        if not (eg == ec == engine and sg.rebuild_count == sc.rebuild_count >= 4
                and bool(sg.overflow) == bool(sc.overflow) and diff <= 1e-7):
            fail(f"the float64 filaments run ({engine}) on the card disagrees with the CPU run")

    # ---- 18. the 2000 x 50 config #4, default engine, through run_block ----
    nsim = FilamentsSim(FilamentsConfig(**fil), device=dev)
    t0 = time.perf_counter()
    nst = nsim.init()
    torch.cuda.synchronize()
    print(f"[18] 2000 x 50 filaments, engine {nsim.contact_engine}: init in "
          f"{time.perf_counter() - t0:.2f} s, rows slack {nsim.rows_slack:.4f}, K "
          f"{nst.nmat.idx.shape[1]}", flush=True)
    nst = nsim.run_block(nst, 3)  # warm up allocator and kernels
    torch.cuda.synchronize()
    rb0 = nst.rebuild_count
    k2.row_neighbor_extract.launches = 0
    t0 = time.perf_counter()
    nst = nsim.run_block(nst, FIL_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k2_fil_launches = k2.row_neighbor_extract.launches
    rebuilds = nst.rebuild_count - rb0
    print(f"    {FIL_STEPS} steps in {elapsed:.3f} s = {FIL_STEPS / elapsed:.3f} steps/s, "
          f"{1e3 * elapsed / FIL_STEPS:.3f} ms/step, rebuilds/step "
          f"{rebuilds / FIL_STEPS:.4f}, K2 launches {k2_fil_launches}", flush=True)
    if bool(nst.overflow) or not bool(torch.isfinite(nst.pos).all()):
        fail("the 2000 x 50 filaments run (nmat) overflowed or went non-finite")
    if rebuilds < 1 or k2_fil_launches != rebuilds:
        fail(f"K2 launched {k2_fil_launches} times for {rebuilds} broad phases")
    profile_window(lambda n: nsim.run_block(nst, n), torch, 1e3 * elapsed / FIL_STEPS)
    del nsim, nst

    # ---- 19. the same config on the row engine (K4's filaments op) ---------
    fst = fsim.run_block(fst, 3)  # warm up
    torch.cuda.synchronize()
    rb0 = fst.rebuild_count
    k4.row_segment_filaments_sym.launches = 0
    t0 = time.perf_counter()
    fst = fsim.run_block(fst, FIL_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k4f_launches = k4.row_segment_filaments_sym.launches
    rebuilds = fst.rebuild_count - rb0
    print(f"[19] 2000 x 50 filaments, engine {fsim.contact_engine}: {FIL_STEPS} steps in "
          f"{elapsed:.3f} s = {FIL_STEPS / elapsed:.3f} steps/s, "
          f"{1e3 * elapsed / FIL_STEPS:.3f} ms/step, rebuilds/step "
          f"{rebuilds / FIL_STEPS:.4f}, R {fsim.row_grid.row_capacity}, K4 filaments "
          f"launches {k4f_launches}", flush=True)
    if bool(fst.overflow) or not bool(torch.isfinite(fst.pos).all()):
        fail("the 2000 x 50 filaments run (rows) overflowed or went non-finite")
    if k4f_launches != FIL_STEPS:
        fail(f"K4's filaments op launched {k4f_launches} times in {FIL_STEPS} steps")
    profile_window(lambda n: fsim.run_block(fst, n), torch, 1e3 * elapsed / FIL_STEPS)
    del fsim, fst

    t_group = took("[1]-[19]", t_start)
    k5_entries = chromatin_phases(torch, dev, card)
    t_group = took("[20]-[22]", t_group)
    poly_entries = polydisperse_phases(torch, dev, lcp_sim, lcp_st, card)
    t_group = took("[23]-[28]", t_group)
    rows_entries = slice15_phases(torch, dev, card, lcp_sim, lcp_st)  # [43]-[45]
    t_group = took("[43]-[45]", t_group)
    del lcp_sim, lcp_st
    hydro_paths = lcp_hydro_phases(torch, dev, card)
    t_group = took("[29]-[31]", t_group)
    hp1_paths = periphery_phases(torch, dev, card)
    t_group = took("[32]-[34]", t_group)
    cli_paths = cli_phases(torch, dev, card, row_ms)
    t_group = took("[35]-[38]", t_group)
    rods = rods_nmat_phases(torch, dev, card)
    t_group = took("[39]-[42]", t_group)
    k5_single = (k5_entries[0]["ms"], k5_entries[1]["ms"])
    sharded_paths = sharded_phases(torch, dev, card, k5_single)  # [46]-[64]
    drift_paths = drift_phase(torch, card)  # [65]

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [
        {"name": "row_hertzian_forces_sym", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_central.cu",
         "replaces": "mundy_tpu/ops/pallas/row_central.py:128",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "row_neighbor_extract", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_extract.cu",
         "replaces": "mundy_tpu/ops/pallas/row_extract.py:210",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_b[0], "bound_by": k2_b[1],
         "library_ms": None},
        {"name": "strided_onehot_segment_sum", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/seg_onehot.cu",
         "replaces": "mundy_tpu/ops/pallas/seg_onehot.py:55",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_lib_ms},
        {"name": "row_segment_pairs_sym", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_segments.cu",
         "replaces": "mundy_tpu/ops/pallas/row_segments.py:227",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None},
        {"name": "row_segment_filaments_sym", "route": "cuda",
         "source": "mundy_tpu_torch/csrc/row_segments.cu",
         "replaces": "mundy_tpu/ops/pallas/row_segments.py:227",
         "launches": k4f_launches, "max_abs_err": k4f_err, "ms": k4f_ms,
         "plain_ms": k4f_plain_ms, "bound_ms": k4f_bound[0], "bound_by": k4f_bound[1],
         "library_ms": None}] + k5_entries + poly_entries + rows_entries
    for entry in kernels:  # launches on the LCP hydro paths of [29] and HP1's of [33]
        if entry["name"] in hydro_paths:
            entry["path_launches"] = hydro_paths[entry["name"]]
        if entry["name"] in hp1_paths:
            entry["path_launches"]["hp1 rpy_periphery_spectral"] = hp1_paths[entry["name"]]
        if entry["name"] in cli_paths:  # each example YAML through the CLI, [35]
            entry.setdefault("path_launches", {}).update(cli_paths[entry["name"]])
        if entry["name"] in sharded_paths:  # the multi-rank paths, [46]-[49] and [55]
            entry.setdefault("path_launches", {}).update(sharded_paths[entry["name"]])
        if entry["name"] in drift_paths:  # the float32 LCP legs of the drift harness, [65]
            entry.setdefault("path_launches", {})["drift lcp float32"] = drift_paths[entry["name"]]
        if entry["name"] == "row_neighbor_extract":  # RodsSim's broad phase, [39]-[40]
            entry.setdefault("path_launches", {}).update(rods["paths"])
            entry["launches"] += sum(rods["paths"].values())
            k2r = rods["k2"]
            entry["rods_nmat"] = {"shape": list(k2r["shape"]), "ms": k2r["ms"],
                                  "device_ms": k2r["dev_ms"], "plain_ms": k2r["plain_ms"],
                                  "bound_ms": k2r["bound"][0], "bound_by": k2r["bound"][1]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
