#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``bevy_hanabi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_hanabi_tpu_torch/csrc`` and runs
the port's main paths through its public entry points: the
benchmark-headline frame and its three companion binnings, the firework
event tree, the mixed scene (``HanabiScene.update_render_chunk``), the
ribbon frame, the force field, the textured mesh frame, the painter pass
with its texture atlas and mesh/Lambert merge, antialiasing, instanced
groups, the reference's examples, and the rest of ``HanabiScene`` and the
renderer (multi-view, hot reload, checkpoints, validation, bloom), and
sharding over a mesh whose shards all lie on the one card. It never
imports JAX. Phases, each of which fails the run on any error:

1. a CUDA device must be present; print its name and power limit;
2. build the kernel library (nvcc, one process per source, ctypes) and,
   beside it, the first version of ``ribbon_segments``, the streaming
   copy of its bytes (``experiments/ribbon_segments_variants/``) and the
   first appearance kernel of ``tile_blend``
   (``experiments/tile_blend_variants/appear1.cu``), ``tile_blend`` before
   the redesign of its painter and antialiased code (``appear2.cu`` there)
   and the earlier ``gather_window``
   (``experiments/gather_window_variants/first.cu``), every nvcc process
   started together; print the registers and spill bytes of each
   ``tile_blend`` instantiation, the port's beside appear2's;
3. compare each raster kernel with its plain PyTorch version on the card,
   on a real 1M-particle headline frame, and time both: ``project_bin``
   (tiles, depths and depth range equal, rows at max abs err 0),
   ``bin_keys`` (bit-equal; beside it the stable sort of its int32 keys
   and of the same keys widened to int64), ``gather_window`` (bit-exact
   over the whole window and ``has``; beside it the earlier kernel, held
   bit-exact too and timed in the same call) and
   ``tile_blend`` in BLEND (max abs err 0); then ``tile_blend`` in MASK,
   which no main path runs, on the same draw's 13-float window with a
   cutoff of 0.5, depth written (max abs err 0, depth planes equal); then
   the four kernels again at each companion's binning (``hifi``:
   ``tile_slots=2``, T 8, 4096 tiles, 2M entries; ``slots2``:
   ``tile_slots=2``, 2M entries; ``exact``: ``tile_slots=0``, 4M entries),
   ``gather_window`` reading row ``entry mod N``;
4. an 8192-particle gradient frame at 128x128 through the kernels on the
   card against the plain versions on the CPU (checksums within 0.5%);
5. the headline: ``gradient_effect(1 << 20)`` warmed past its 5 s
   lifetime, then timed ``step_render_chunk`` chunks of K = 120 frames at
   512x512, ``tile_slots=1``; every raster kernel's launch counter must
   move, and the last frame is rendered again on the CPU through the plain
   versions (checksums within 0.5%);
5b. the headline's companions (bench.py:510-563) on the same pool, in its
   order ``hifi``, ``slots2``, ``exact``: two warm-up chunks, then three
   timed chunks of K = 120 each (frames/s, particle-frames/s); each one's
   raster launch counters set to 0 before its timed chunks and required to
   move; its last frame rendered again on the CPU (checksums within 0.5%);
   then ``torch.profiler`` over 30 headline and 30 ``exact`` frames;
6. the 2k -> 8k firework tree, ``HanabiScene(seed=17)``, stepped by
   ``update(1/60)`` on the card and on the CPU: rocket and trail alive
   counts equal, alive masks and PCG seeds bit-equal, positions and
   velocities of the alive lanes within rtol 1e-2 / atol 1e-3, after 30
   frames (the JAX package's gate, bench.py:253-293, where no rocket has
   died yet) and after 90 (events flowing);
7. the 64k -> 256k firework tree, ``HanabiScene(seed=5)``:
   a. after a warm-up chunk, ``event_compact`` against its plain version
      on the rocket pool (n = 65536, the ~2k alive rockets of a burst
      active, payload = position), bit-exact, and both timed;
   d. three timed ``update_chunk(240, 1/60)`` runs, each ending in an
      alive-count readback, then 65 more frames and ``scene.render`` of
      one 512x512 frame (``tile_slots=1``, the headline camera) with rockets
      and trails on screen; every kernel's launch counter must move over
      the chunks and the frame; the frame is rendered again on the CPU
      through the plain versions (checksums within 0.5%);
   b. on that frame's 327,680 entries, ``project_bin``, ``bin_keys`` and
      ``gather_window`` against their plain versions (as in phase 3), and
      ``tile_blend`` in ADD mode against its plain version, max abs err 0;
      then the trail step's payload gather (``gather_rows`` of the
      rocket buffer's [65536, 3] positions at the 262144 trail lanes' event
      indices, with dying rockets' events pending) bit-exact; all timed.

8. ``torch.profiler`` over 30 more firework frames: launches, copies and
   synchronisations a frame, device time by op and by kernel;
9. the JAX package's painter gate (bench.py:331-357): blend, add and opaque
   effects, three ``update(1/60)`` and ``render(pipeline="painter")`` at
   128x128 (``tile_slots=1``, the port's binning) on the card and on the
   CPU: alive masks and PCG seeds bit-equal, checksums within 0.5%;
10. a small mixed scene (opaque debris 1024, gradient 4096, rockets 512 ->
    trails 2048) through twelve ``update_render_chunk(8, 1/60)`` on the card
    and on the CPU, for the ``"auto"`` (painter) and ``"split"`` pipelines:
    alive masks and PCG seeds of all four effects bit-equal, every frame's
    checksum within 0.5%, and trails spawned from events;
10b. ``HanabiScene.render(camera)`` with no config (JAX's default
    ``RasterConfig``, ``tile_slots=0``) on that small scene 90 frames in,
    both pipelines, card against CPU: masks and seeds bit-equal, checksums
    within 0.5%;
11. the full mixed scene (bench.py:672-774: debris 65 536 opaque, gradient
    524 288, rockets 65 536 -> trails 262 144, 917 504 lanes) at 512x512:
    warmed to steady state, then one untimed and three timed chunks of
    K = 120 for ``"auto"``, ``"split"`` and ``"auto"`` with M = 128 (best of
    three, frames/s); each pipeline's launch counters are set to 0 before
    its chunks and must move for every kernel of that pipeline; the last
    (``"auto"``, M = 128) frame is rendered again on the CPU through the
    plain versions (checksums within 0.5%); then a ``"split"`` chunk ends
    75 frames into a burst, with rockets and trails on screen, and its last
    frame is rendered again on the CPU too. On that frame each kernel of
    both pipelines is held against its plain version at the pass's own
    shapes, and timed: the painter pass's ``project_bin`` (with the painter
    columns), ``bin_keys`` with its sort, ``gather_window`` and
    ``tile_blend`` SCENE at M = 64 and M = 128;
    the split pipeline's depth-writing OPAQUE debris pass, then its BLEND
    gradient pass and its ADD rocket + trail batch (the fast path), both
    depth-tested against the debris pass's depth plane; every framebuffer at
    max abs err 0 and every depth plane equal; and the trail step's payload
    ``gather_rows``, as in phase 7b. Then
    ``torch.profiler`` over 30 frames of ``update_render_chunk``;
12. the ribbon gate (bench.py:221-251): ``ribbon_order_check_effect(8192,
    64)``, 30 frames of 256 spawns through ``step_render_chunk`` at 128x128
    (``tile_slots=1``) on the card and on the CPU: alive masks and PCG seeds
    bit-equal, every frame's checksum within 0.5%, the valid segments and
    their order equal;
12b. the JAX package's own device checks at its own config,
    ``RasterConfig(128, 128)`` (``tile_slots=0``), card against CPU:
    ``gradient_render_8k`` (bench.py:203-219, checksums within 0.5%) and
    ``ribbon_trails_8k_64`` (bench.py:226-250, alive masks equal, checksums
    within 0.5%);
13. the ribbon frame (bench.py:605-669): ``ribbon_bench_effect(1 << 20,
    4096)`` warmed past its 4 s lifetime, then three timed
    ``step_render_chunk`` chunks of K = 120 at 512x512 (``tile_slots=1``,
    ADD), each ending in an alive-count readback (frames/s and
    particle-frames/s, best of three); every kernel of the path must move
    (``ribbon_keys``, ``ribbon_segments``, then the ``payload`` raster pass's
    ``project_bin``, ``bin_keys``, ``gather_window``, ``tile_blend`` ADD); the
    last frame is rendered again on the CPU through the plain versions
    (checksums within 0.5%); on it ``ribbon_keys`` (both stages, keys equal)
    and ``ribbon_segments`` (max abs err 0) are held against their plain
    versions, beside the two stable sorts, the first version of
    ``ribbon_segments`` (equal too) and the call's two floors, then the
    raster pass's kernels as in phase 7b; all timed. Then ``torch.profiler``
    over 30 ribbon frames;
14. the force field (bench.py:568-601): a gate, ``force_field_effect(4096)``
    for 300 frames with the attractor moved at frame 180 so that lanes
    leave the kill box, card against CPU (masks and seeds bit-equal,
    positions within rtol 1e-2 / atol 1e-3, some lanes killed by the box
    before their lifetime); then ``force_field_effect(100_000)`` through
    ``step_chunk``, warmed past its lifetime, three timed chunks of K
    (steps/s, particle-steps/s; eager torch, no hand-written kernel);
15. textured and mesh particles:
    a. the JAX package's ``textured_mesh_2k`` (bench.py:295-327):
       ``HanabiScene(seed=5)``, ``textured_mesh_check_effect(2048)`` with
       ``ParticleTextureModifier(0)`` and ``ParticleMesh.icosphere(0.4, 1)``,
       the 32x32 circle texture, three updates and a render at
       ``RasterConfig(128, 128)``, card against CPU (masks equal, checksums
       within 0.5%);
    b. ``example_puffs`` (Lambert on mesh normals), ``example_circle`` (the
       flipbook) and ``example_2d`` (the squircle), 30 frames of 32 spawns
       each through ``step_render_chunk`` at 512x512, card against CPU (masks
       and seeds equal, every checksum within 0.5%);
    c. the textured mesh frame at full width: the same composition at
       ``textured_mesh_check_effect(16384)`` (~1.31M triangle entries),
       ``RasterConfig(512, 512)`` (``tile_slots=0``, span 2, ~5.2M bin
       entries), the gate's camera at 512x512, BLEND, warmed three chunks
       past its 5 s lifetime, then three timed ``step_render_chunk`` chunks
       of K = 120 (frames/s; ``mesh_expand``, ``project_bin``, ``bin_keys``,
       ``gather_window`` and ``tile_blend``'s appearance BLEND variant must
       launch), the last frame rendered again on the CPU (checksums within
       0.5%); on it ``mesh_expand``, ``project_bin`` with triangles (17-float
       rows), ``bin_keys``, ``gather_window`` (F = 17) and ``tile_blend``
       (textured triangles, then the same window in PREMULTIPLY and
       MULTIPLY) against their plain versions, exactly, and timed, the first
       appearance kernel (``experiments/tile_blend_variants/appear1.cu``,
       built in phase 2) held and timed beside ``tile_blend`` (``first_ms``),
       the warp-entry iterations under the triangle and the quad bound
       printed beside the covered pairs; then ``tile_blend`` on the same
       frame at M = 128 (bench.py's wider M, a timing row that no main path
       launches; its ``gather_window`` a timing row too); then
       ``torch.profiler`` over 30 frames;
    d. the same frame lit per fragment
       (``LambertianLightingModifier((0.577, 0.577, 0.577), 0.7)``: 26-float
       rows, the normals through ``mesh_expand``), as in c, and its
       ``gather_window`` at M = 512 (M * F = 13 312, above the 12 288 floats
       the earlier kernel staged; a timing row that no main path launches),
       exactly;
    e. ``gather_window`` and ``tile_blend`` on the last frame of
       ``example_circle`` (the flipbook, 11-float rows) and ``example_2d``
       (the squircle: at most 0.2% of the
       pixels may differ, checksums within 0.5%, since the card's ``powf``
       and PyTorch's ``pow`` may differ in the last ulp), timed, the first
       appearance kernel beside it;
    f. textured quads: a billboard (``textured_mesh_check_effect(2048)``
       with ``ParticleTextureModifier(0)`` and no mesh: texture layers and no
       appearance column, so 10-float rows) under BLEND and MULTIPLY, and
       the same with ``ParticleMesh.cross()`` (quads only: no UV column)
       under ADD and PREMULTIPLY, 20 frames of 64 spawns each through
       ``step_render_chunk`` at 256x256 over a coloured background, card
       against CPU (masks equal, every checksum within 0.5%; ``tile_blend``'s
       appearance variant must launch); then ``gather_window`` and
       ``tile_blend`` on the billboard's last BLEND frame against their plain
       versions, exactly, and timed, the first appearance kernel beside it.
16. the painter atlas gate: the JAX package's painter compositions
    (tests/test_scene.py:1859-2315: multilayer textures, a triangle mesh
    with quads, a UV-less textured mesh beside one with UVs sharing a
    texture, a lit mesh with quads, two conflicting Lambert setups, textured
    effects, a textured flipbook) at 64x64 on the card and on the CPU: every
    image exact card against CPU (each JAX test's painter-against-split
    tolerance is 1e-6 there; 0.5% of the checksum where it is 1e-5),
    painter against split on the card within that tolerance; then
    ``update_render_chunk(4)`` of a two-layer painter against its per-frame
    render on each device and card against CPU (checksums within 0.5%);
17. the full-width painter frame: the mixed scene of phase 11 beside two
    ``textured_mesh_check_effect(16384)`` icosphere effects with the 32x32
    circle texture (one texture object, one atlas layer), lit by two
    Lambert setups (per-entry light columns), 14 units before the camera:
    ~3.5M entries of 40-float rows through ``update_render_chunk`` under
    ``"auto"`` (the painter plan, asserted) at 512x512, ``tile_slots=1``,
    M = 64; three timed chunks of K (frames/s), every kernel of the path
    launched, the last frame re-rendered on the CPU (checksums within
    0.5%); on the frame ``mesh_expand``, ``project_bin``, ``bin_keys``,
    ``gather_window`` at F = 40 and ``tile_blend`` SCENE with the atlas
    against their plain versions, exactly, and timed, the same window
    antialiased (a timing row), each mesh effect's covered pairs (> 0);
    then ``torch.profiler`` over 30 frames;
18. antialiasing: (a) the headline with ``antialias=True`` on the same pool
    right after phase 5b (two warm-up and three timed chunks, the
    antialiased BLEND variant launched, the last frame on the CPU), and
    ``tile_blend``'s antialiased BLEND on the headline's window in phase 3;
    (b) the textured mesh frames of phases 15c-d, unlit and lit,
    antialiased (frames/s, the frame on the CPU, the antialiased
    appearance variant against its plain version on the frame's window);
    (c) the three examples at ``examples/run_all.py``'s config
    (``tile_size=16``, ``tile_span=2``, ``max_entries_per_tile=128``,
    ``antialias=True``), 12 frames each, card against CPU, and the
    flipbook's and the squircle's windows antialiased against the plain
    version;
19. instanced groups (bench.py::bench_instanced, bench.py:403-437):
    a. the gate: ``InstancedEffect(instancing_effect(4096), 8)`` through 30
       frames of ``step_render_chunk`` at 128x128 on the card and on the
       CPU: every instance's alive mask, seeds and counter bit for bit,
       positions within rtol 1e-2 / atol 1e-3, every checksum within 0.5%;
    b. 256 instances x 4096 (1 048 576 lanes), ``make_spawner_bank(seed=1)``:
       four warm-up ``step_chunk`` chunks of K = 120 past the 3 s lifetime,
       then three timed chunks, each ending in a readback (steps/s,
       particle-steps/s);
    c. one warm-up and three timed ``step_render_chunk`` chunks at
       ``RasterConfig(512, 512)`` (frames/s; ``project_bin``, ``bin_keys``,
       ``gather_window`` and ``tile_blend`` BLEND must launch), the last
       frame rendered again on the CPU (checksums within 0.5%);
    d. on that frame the four kernels against their plain versions,
       exactly, and timed;
    e. ``torch.profiler`` over 30 rendered frames;
20. the examples: every ``examples_registry`` entry (30 frames; ``worms``
    60), the gallery's 5x5 ``add_group`` grid (examples/run_all.py:81-97)
    and a textured flipbook ribbon through ``HanabiScene`` and a 512x512
    ``render``, card against CPU (alive counts equal, checksums within
    0.5%), and the ``set_spawner_active`` / ``reset_spawner`` scenarios of
    the JAX package's tests/test_examples.py:71-125, card against CPU;
21. ``ribbon_segments`` with the sprite column on the textured ribbon's
    frame, exactly against its plain version, and timed (and, in phase 13,
    on the ribbon frame's 1M rows with a sprite column);
22. the rest of ``HanabiScene`` and the renderer:
    a. phase 11's mixed scene (917 504 lanes, 512x512) warmed to 75 frames
       into a burst, then ``render_views`` from three cameras (phase 11's,
       a raised three-quarter one, and one whose frustum culls the rocket
       and the trail): each view equal to ``render`` of its camera (max abs
       err at most 1e-5), the third view equal to the frame without the
       culled members; ``render_views`` timed against three ``render``
       calls; three ``update_render_chunk(40, 1/60, cameras)`` chunks
       (frames/s; every kernel of the painter path launched); on the
       second view's frame ``project_bin``, ``bin_keys``, ``gather_window``
       and ``tile_blend`` SCENE exactly against their plain versions;
    b. hot reload on ``gradient_effect(1 << 20)``: a constant edit
       recompiles and keeps the pool, a layout edit migrates the 1M lanes
       (alive mask, seeds and every shared attribute exact), both timed;
    c. the 64k -> 256k firework tree saved and loaded mid-burst (events in
       flight) into a scene of another seed: 120 frames later the pools
       equal the uninterrupted run's bit for bit; save and load ms and bytes;
    d. ``DebugSettings.validate`` on the tree: ``update()`` steps/s with
       validation off and on, the validated frames clean; a poisoned live
       rocket lane raises at its frame;
    e. the bloom of examples/run_all.py:289-295 and the ACES of
       examples/animate.py:65 on the tree's 512x512 HDR frame, card
       against CPU (within 1e-5 of the values' scale), timed;
    f. ``example_multicam`` at examples/run_all.py:251-287's config
       (256x256, antialiased, two cameras through ``render_views``) and a
       LOCAL-space effect under ``camera_2d``, card against CPU (alive
       counts equal, checksums within 0.5%);
23. the sharded paths on a (dp=4, sp=2) mesh whose eight shards all lie on
    ``cuda:0`` (``make_mesh([cuda:0] * 8)``), one process driving them:
    a. ``ShardedEffect(spawn_gravity_effect(131072), 4)`` (524 288 lanes,
       65 536 a shard; __graft_entry__.py:127-157's sizes): two steps of
       65 536 spawns an instance and a 6-frame ``step_chunk``, the pools
       bit-equal to an ``InstancedEffect`` stepped on the same inputs;
       steps/s of both over three chunks of 60 frames;
    b. 8 x ``gradient_effect(131072)`` (1 048 576 lanes) on a ring, warmed
       past its lifetime, rendered at 512x512 (``tile_slots=1``) in slice
       mode (BLEND) and psum (its ADD twin): ms a frame, every raster
       kernel launched; each frame against the unsharded render of the
       assembled pools on the card, equal on the tiles that do not overflow
       M (slice: and border no slice, where the centre tile of a quad
       straddling a slice edge is clamped into each slice) with the
       overflowing tiles counted, the slice frame's checksum within 0.5%;
       each frame against the same sharded render on a mesh of the CPU
       (checksums within 0.5%; the psum frame at 128x128 there); the
       route's sort, window and copies timed; ribbons and a tetrahedron
       mesh at the dryrun's sizes (__graft_entry__.py:214-266, 8-pixel
       tiles) card against CPU and exactly against the unsharded render;
    c. the 64k -> 256k firework tree with ``add(..., mesh=mesh)`` and an
       inherited trail, ``update_chunk(240)`` (steps/s, sharded and
       unsharded), then 75 frames into the next burst: rocket and trail
       pools bit-equal to the unsharded tree on the card;
    d. __graft_entry__.py:289-331's scene (a plain effect beside a sharded
       ADD group): ``update``, ``render`` (the psum pass),
       ``update_render_chunk(2)`` and ``render(pipeline="painter")`` against
       the same scene with a plain group;
    e. on b's slice frame ``project_bin`` at ``y_offset`` != 0,
       ``gather_window`` at the route's width and cap, ``tile_blend`` BLEND
       on a slice's window, and on c ``event_compact`` on one shard's lanes,
       each exactly against its plain version, and timed;
24. the native host runtime, the antialiased appearance variants and the
    instanced event path:
    a. ``make_spawner_bank`` returns the port's ``NativeSpawnerBank``
       (built with g++ into ``build/``); ``burst(uniform(1, 10), 0.05)``
       over 6 instances, seed 123, 10 ticks of 1/60 s sums to the JAX
       package's ``[16 22 17 19 13 27]``; a ``HanabiScene.add_group`` of
       256 ``instancing_effect(1024)`` instances with uniform burst counts,
       20 frames on cuda:0 and on the CPU: alive counts, masks, seeds and
       counters equal;
    b. the textured mesh frame's effect stepped three chunks (phase 18b's
       pool); on its antialiased 512x512 window (M = 64; 10- and 13-float
       rows, random cutoffs and mode ids) each of the fifteen antialiased
       appearance variants of ``tile_blend`` exactly against its plain
       version, over a random framebuffer and depth plane; the ten this
       slice adds also timed; then an additive textured flipbook
       (``example_circle`` in ADD) 6 frames at 256x256 antialiased, card
       against CPU (masks and seeds equal, checksums within 0.5%), its ADD
       appearance variant launched, and on its window against its plain
       version, timed;
    c. ``InstancedEffect(firework_effect(1024), 64)`` stepped 60 frames on
       the card and on the CPU (0-39 spawns an instance a frame): alive
       masks, seeds, counters and every frame's event slots, counts and
       num_events bit-equal, positions and the event payloads within rtol
       1e-2 / atol 1e-3; ``event_compact_segmented`` launched once a frame;
       then against its plain version, exactly, on the last frame's
       emissions (64 x 1024, the firework's payload words) and at 256 x
       4096 (random lanes at the same active share), both timed.

Prints a ``{"kernels": [...]}`` line with a row per kernel and path: the
headline's (``tile_blend`` in BLEND, and ``tile_blend[mask]`` with the
launches of all four paths), the firework's (``[firework]``,
``tile_blend[add]``, ``event_compact``) and the mixed scene's (``[mixed]``,
``tile_blend[scene]``, ``tile_blend[scene,M=128]``, ``tile_blend[opaque]``,
``tile_blend[blend,split]``, ``tile_blend[add,split]``) and the ribbon
frame's (``[ribbon]``, ``tile_blend[add,ribbon]``), the companions'
(``[hifi]``, ``[slots2]``, ``[exact]``, BLEND) and the textured mesh
frames' (``mesh_expand``, ``project_bin``, ``bin_keys``, ``gather_window``
and ``tile_blend`` at ``[mesh]`` and ``[mesh,lit]``, ``tile_blend[mesh,M=128]``
with 0 launches,
``tile_blend[premultiply,mesh]`` and ``[multiply,mesh]``, which no main path
launches, ``tile_blend[flipbook]`` and ``[round]`` with the examples'
own launches, and ``tile_blend[textured quads]`` with the billboard's BLEND
frames' launches; ``gather_window`` on the same windows, ``[mesh,M=128]``
and ``[mesh,lit,M=512]`` with 0 launches), the painter frame's
(``mesh_expand``, ``project_bin``, ``bin_keys``, ``gather_window`` at
``[painter]``, ``tile_blend[scene,atlas]`` and ``[scene,atlas,aa]`` with 0
launches) and the antialiased variants' (``tile_blend[blend,aa]``,
``[mesh,aa]``, ``[mesh,lit,aa]``, ``[flipbook,aa]``, ``[round,aa]``), the
instanced frame's (``project_bin``, ``bin_keys``, ``gather_window`` and
``tile_blend`` at ``[instanced]``) and the textured ribbon's
(``ribbon_segments[sprite]``, and ``[sprite,1M]``, a timing row with 0
launches) and the multi-view chunk's (``project_bin``, ``bin_keys``,
``gather_window`` at ``[views]`` and ``tile_blend[scene,views]``, compared
on its second view's frame) and the sharded frames' (``project_bin[slice]``,
``gather_window[route]``, ``tile_blend[blend,slice]`` with the slice
frame's launches, ``gather_window`` counting its route windows and its
slices' windows together, and ``event_compact[sharded]`` with the sharded
tree's) and phase 24's (``tile_blend[<mode>[,depth][,write],mesh,aa]`` for
the ten new antialiased appearance variants with 0 launches,
``tile_blend[add,flipbook,aa]`` with the additive flipbook's launches,
``event_compact[segmented]`` with the instanced firework's and
``[segmented,256x4096]`` with 0). Each row holds the
path's launches, the kernel's and its plain version's device ms, the
library call's (``index_select`` for the gathers, of the window's rows
for ``gather_window``, of the appearance rows by the segment order for
``ribbon_segments``; else null), and
``bound_ms``: the larger of the bytes the call must move over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (``bound_by`` says which), computed from
that call's inputs and counting only the work every correct kernel must
do; ``share`` is ``bound_ms / ms``. The ``gather_window`` rows also hold
``first_ms`` (the earlier kernel; null where it refuses the window) and
``filled_entries``; the ``bin_keys``
rows ``sort_ms`` and ``sort_int64_ms``; the ``tile_blend`` rows
``filled_entries`` and ``covered_pairs``, what their bound counts (the
filled entries' rows, and the covered (entry, pixel) pairs' test and
blend), and ``first_ms``: the first appearance kernel's on the appearance
rows, appear2's on the painter's SCENE with the atlas and every
antialiased row (:data:`REDESIGNED_ROWS`, held exact against it too and
printed beside it on a line before the kernel rows); the ``ribbon_keys``
row ``counter_ms`` and ``order_ms`` (each stage)
and ``sort_counter_ms`` and ``sort_order_ms`` (the stable sort of each
stage's keys); the ``ribbon_segments`` row ``gather_rows_ms`` (its
appearance gather alone, by ``gather_rows``), ``first_ms`` (the first
version of its kernel), ``floor_coalesced_ms`` (that version with every read
in order: ``perm1`` None, ``perm2`` the identity) and ``floor_copy_ms`` (a
streaming copy of the bytes the call moves). Then, as its last line,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available or any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

K = 120  # frames per chunk, as the JAX package's benchmark
DT = 1.0 / 60.0
CAPACITY = 1 << 20
CHECKSUM_REL = 0.005  # bench.py:155-161: f32 blend arithmetic, 5x margin
# Every kernel rounds op for op like its plain version (built with
# -fmad=false), so each comparison below is exact: tiles, depths, keys and
# depth planes equal, rows and framebuffers at max abs err 0.
POS_RTOL, POS_ATOL = 1e-2, 1e-3  # bench.py:121-130, 189: positions, transcendental ULPs
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): device memory and FP32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations that every correct kernel must do, counted from the
# reference's code: project_bin per particle (three projections of 4 dot
# products, the divide and viewport map, the half axes, the screen and size
# tests, the tile floor), bin_keys per entry (the quantisation and the
# packing). tile_blend: per filled entry its clamped det (two products, a
# difference, the clamp's compare and select); per covered (entry, pixel)
# pair the test that finds it covered (dx, dy, two numerators of two products
# and a difference, two comparisons) and its equation's blend (BLEND: 1 - a,
# two products and a sum a channel, alpha's product and sum; ADD: a product
# and a sum a channel, alpha's sum and clamp; PREMULTIPLY: 1 - a, a product
# and a sum a channel, alpha's product and sum; MULTIPLY: 1 - a, three
# products and a sum a channel; OPAQUE selects; MASK's cutoff compare;
# SCENE's transparent entries as BLEND). A pair no pixel of which
# is covered needs no work: a kernel may skip it by a bound per entry and
# block, as tile_blend.cu does.
PROJECT_OPS, KEY_OPS = 150, 10
ENTRY_OPS, COVER_TEST_OPS = 5, 10
# antialiased coverage of a pair (raster.py:644-671): two divisions for u,
# v, the two ramps and their clips and product (a triangle's three
# half-planes cost more; counted as a quad's)
AA_OPS = 14
BLEND_EQ_OPS = {"blend": 12, "add": 8, "opaque": 0, "mask": 1, "scene": 12, "premultiply": 9,
                "multiply": 13}
HEADLINE_KERNELS = ("gather_window", "project_bin", "bin_keys", "tile_blend")  # tile_blend in BLEND
# gather_rows: the trail step's event payload gather
FIREWORK_KERNELS = ("gather_rows", "gather_window", "project_bin", "bin_keys", "tile_blend[add]",
                    "event_compact")
FW_K = 240  # frames per firework chunk, as bench.py::bench_firework_events
FW_INTO_BURST = 10  # frames into a 2 s burst period at which the timed chunks start
FW_RENDER_AT = 75  # frames into a burst period at which the frame is rendered
# every kernel of each pipeline of the mixed scene
MIXED_KERNELS = {
    "auto": ("gather_rows", "gather_window", "project_bin", "bin_keys", "tile_blend[scene]",
             "event_compact"),
    "split": ("gather_rows", "gather_window", "project_bin", "bin_keys", "tile_blend[opaque]",
              "tile_blend", "tile_blend[add]", "event_compact"),
}
# the runtime calls that launch a kernel (event_compact's launch is cooperative)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC")
MIXED_K = 8  # frames per chunk of the small mixed gate (phase 10)
MIXED_M_WIDE = 128  # the third timing's max_entries_per_tile (bench.py:765)
# the lit mesh window's M above the earlier kernel's cap (tests/test_parallel.py:146-337's M)
MESH_M_WIDE = 512
# every kernel of the ribbon frame: the segment build, then the ADD payload pass
RIBBON_KERNELS = ("ribbon_keys", "ribbon_segments", "project_bin", "bin_keys", "gather_window",
                  "tile_blend[add]")
RIBBONS = 4096  # bench.py:614
# the headline's three companion frames (bench.py:470-472, 550), in its order
COMPANIONS = {
    "hifi": dict(tile_slots=2, tile_size=8),
    "slots2": dict(tile_slots=2),
    "exact": dict(tile_slots=0),
}
# a round pass's pixels that may differ between tile_blend and its plain
# version: the squircle's powf against PyTorch's pow (last-ulp differences
# flip pixels on the squircle's edge)
SQUIRCLE_PIXELS = 0.002
# the textured mesh frame: ~16 384 alive x 80 icosphere triangles =
# 1 310 720 triangle entries, the headline's scale in raster entries
MESH_CAPACITY = 16_384
# every kernel of the textured mesh frame (tile_blend in its appearance BLEND variant)
MESH_KERNELS = ("mesh_expand", "project_bin", "bin_keys", "gather_window",
                "tile_blend[blend,appearance]")
# FP32 operations of mesh_expand an entry (the frame: cross product, two
# square roots and the normalisation, three mapped vectors; with normals,
# two more normalised axes and three normalised mapped normals)
MESH_OPS, MESH_LIT_OPS = 60, 130
# the reference examples held card against CPU (Lambert on mesh normals,
# the flipbook, the squircle), and their spawns a frame
EXAMPLES = ("example_puffs", "example_circle", "example_2d")
EXAMPLE_SPAWN = 32
# the headline antialiased (phase 18a), and examples/run_all.py:253-256's
# raster config of the examples at 512x512 (phase 18c)
AA_HEADLINE = {"antialias": dict(tile_slots=1, antialias=True)}
EXAMPLES_AA = dict(width=512, height=512, tile_size=16, tile_span=2, max_entries_per_tile=128,
                   antialias=True)
# their frames: the CPU's plain blend of M = 128 takes 1-3 s a frame, so
# fewer than phase 15b's 30 keep the script within half its time limit
EXAMPLE_FRAMES_AA = 12
# the textured quads held card against CPU (phase 15f): (mesh, alpha mode)
TEXTURED_QUADS = (("billboard", "BLEND"), ("billboard", "MULTIPLY"), ("cross", "ADD"),
                  ("cross", "PREMULTIPLY"))
FF_CAPACITY = 100_000  # bench.py:568
FF_MOVED = (9.0, 1.0, 0.0)  # the gate's attractor from FF_MOVE_AT: lanes leave the kill box
FF_MOVE_AT = 180
# ribbon_segments' first version and the streaming copy of its bytes, built
# beside the library and timed in phase 13: (label, source, extra nvcc flags)
_VARIANTS = Path(__file__).resolve().parent / "experiments" / "ribbon_segments_variants"
RIBBON_VARIANTS = (
    ("first", _VARIANTS / "first.cu", []),
    ("copy", _VARIANTS / "probe.cu", ["-DHANABI_PROBE=1"]),
)
# tile_blend's first appearance kernel, built beside the library and timed
# beside the port's on every appearance row (``first_ms``); and the kernel
# before the redesign of its painter and antialiased code (``appear2``),
# timed as ``first_ms`` on those rows instead: the painter's SCENE with the
# atlas and every antialiased row (:data:`REDESIGNED_ROWS`)
_BLEND_VARIANTS = Path(__file__).resolve().parent / "experiments" / "tile_blend_variants"
TILE_BLEND_VARIANTS = (
    ("appear1", _BLEND_VARIANTS / "appear1.cu", []),
    ("appear2", _BLEND_VARIANTS / "appear2.cu", []),
)
# gather_window's earlier kernel, built beside the library and timed beside the port's
# on every gather_window row (``first_ms``); it stages a tile's floats in
# 48 KB, so it refuses M * F > 12 288, and its C entry point takes ``vec4``
# (the tile's start 16-byte aligned) before the stream
GATHER_WINDOW_VARIANTS = (
    ("first", Path(__file__).resolve().parent / "experiments" / "gather_window_variants"
     / "first.cu", []),
)
FIRST_WINDOW_FLOATS = 12288
VARIANT_LIBS = {}  # phase 2's variant builds by label
# compare_tile_blend's arguments on REDESIGNED_ROWS (set in phase 2): appear2
# as ``first``
REDESIGNED_KW = {}
# the rows whose first_ms is appear2's, each held exact against it (and
# phase 24's ten ``tile_blend[<mode>...,mesh,aa]``)
REDESIGNED_ROWS = ("tile_blend[scene,atlas]", "tile_blend[scene,atlas,aa]", "tile_blend[blend,aa]",
                   "tile_blend[mesh,aa]", "tile_blend[mesh,lit,aa]", "tile_blend[flipbook,aa]",
                   "tile_blend[round,aa]", "tile_blend[add,flipbook,aa]")
# bench.py::bench_instanced (bench.py:403-437): 256 instances x 4096 lanes
INSTANCES, INSTANCE_CAPACITY = 256, 4096
INSTANCED_GATE = (8, 4096)  # the instanced gate's instances x lanes (phase 19a)
# phase 24a: the JAX package's native bank's sums for burst(uniform(1, 10),
# 0.05), 6 instances, seed 123, 10 ticks of 1/60 s (computed on the CPU)
UNIFORM_BURST_SUMS = [16, 22, 17, 19, 13, 27]
NATIVE_GROUP = (256, 1024, 20)  # phase 24a's group: instances, lanes, frames
# phase 24b: tile_blend's antialiased appearance variants (mode, depth_test,
# write_depth): the five of PR 12, then the ten this slice adds
AA_APPEARANCE_FIRST = (("blend", False, False), ("blend", True, False), ("opaque", False, False),
                       ("opaque", True, True), ("scene", True, True))
AA_APPEARANCE_NEW = (("add", False, False), ("add", True, False), ("opaque", True, False),
                     ("mask", False, False), ("mask", True, False), ("mask", True, True),
                     ("premultiply", False, False), ("premultiply", True, False),
                     ("multiply", False, False), ("multiply", True, False))
# phase 24b's additive flipbook: 6 frames at 256², where the CPU's plain
# antialiased blend takes well under a second a frame
FLIPBOOK_AA = dict(width=256, height=256, tile_span=2, max_entries_per_tile=64, antialias=True)
FLIPBOOK_FRAMES = 6
INSTANCED_FIREWORK = (64, 1024, 60)  # phase 24c: instances, rockets, frames
SEGMENTED_WIDE = (256, 4096)  # phase 24c's second event_compact_segmented shape


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def ptxas_kernels(log: str, source: str = "tile_blend.cu") -> list:
    """``(kernel, template arguments, registers, spill stores, spill loads)``
    of each kernel that nvcc's ``-Xptxas -v`` report ``log`` gives for
    ``source`` (the library's log holds a ``== source`` section a source; a
    variant's log is its one source's), template arguments as written in the
    mangled name (``Li4E`` an int, ``Lb1E`` a bool)."""
    import re

    if f"== {source}" in log:
        log = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            # _ZN <length><name>... I <args> E: the last name is the kernel's
            i, kernel = name.find("_ZN") + 3, name
            while 2 < i < len(name) and name[i].isdigit():
                j = i
                while name[j].isdigit():
                    j += 1
                kernel, i = name[j:j + int(name[i:j])], j + int(name[i:j])
            args = re.findall(r"L[ib](\d+)E", name[i:].split("EE", 1)[0] + "E")
            out.append((kernel, ",".join(args), int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def checksum_close(a: float, b: float) -> bool:
    return abs(a - b) <= CHECKSUM_REL * max(abs(b), 1.0)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).

    The device first sleeps long enough for the host to enqueue all
    ``reps`` calls, so the events time the device and not the host's
    launch overhead (which dominates kernels of a few microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2.0 * reps * host_s + 1e-3) * 2e9))  # cycles, ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def headline_camera():
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(
        view=look_at([0.0, 0.0, 26.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        proj=perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(512, 512),
    )


def chunk_inputs(fx, spawner, frame: int, k: int = K):
    from bevy_hanabi_tpu_torch import SimParams, StepInputs

    inputs, sims = [], []
    for j in range(k):
        inputs.append(StepInputs.make(spawner.tick(DT), frame + j))
        sims.append(SimParams(time=(frame + j) * DT, delta_time=DT))
    return fx.stack_frames(inputs, sims)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved_bytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its FP32 operations over the peak rate."""
    by_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / FP32_OPS_PER_S
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def torch_equal_nan(a, b) -> bool:
    """Equal values, NaN where the other is NaN."""
    import torch

    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def compare_project_bin(pb_args, nt: int, label: str, row: int, extra=None, config=None,
                        appearance=None, **slice_kw):
    """``project_bin`` against its plain version on ``pb_args``, with
    ``row``-float rows (then the ``appearance`` columns, if any) and
    ``config``'s binning (``tile_slots`` and ``tile_span``; the centre tile
    without one), ``slice_kw`` a slice's ``raster_size`` and ``y_offset``:
    tiles, depths and the depth range equal, rows at max abs err 0. Returns
    the result row and the plain outputs (tile, depth, rows, range)."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    kw = dict(extra=extra, row=row, **slice_kw)
    if appearance is not None:
        kw["appearance"] = appearance
    if config is not None:
        kw.update(tile_slots=config.tile_slots, tile_span=config.tile_span)
    tile_k, depth_k, rows_k, range_k = raster.project_bin(*pb_args, **kw)
    plain = raster.project_bin_plain(*pb_args, **kw)
    tile_p, depth_p, rows_p, range_p = plain
    torch.cuda.synchronize()
    bad = int(((tile_k != tile_p) | (depth_k != depth_p)).sum())
    rows_err = float((rows_k - rows_p).abs().nan_to_num(0.0).max())
    n, entries = rows_p.shape[0], tile_p.shape[0]
    valid = int((tile_p < nt).sum())
    print(f"{label}: {n} particles, {entries} entries, {valid} binned on screen, {rows_p.shape[1]}-float "
          f"rows, {bad} tile/depth mismatches, rows max abs err {rows_err:g}, depth range "
          f"{range_k.tolist()} (plain {range_p.tolist()})")
    if bad:
        fail(f"{label}: {bad} of {entries} tiles/depths differ from the plain version")
    if not torch.equal(rows_k.isnan(), rows_p.isnan()) or rows_err != 0.0:
        fail(f"{label}: rows differ from the plain version (max abs err {rows_err:g})")
    if not torch_equal_nan(range_k, range_p):
        fail(f"{label}: depth range {range_k.tolist()} differs from the plain {range_p.tolist()}")
    inputs = (*pb_args[:5], extra, *(appearance or ()))
    result = {
        "max_abs_err": rows_err,
        "ms": cuda_ms(lambda: raster.project_bin(*pb_args, **kw), 50),
        "plain_ms": cuda_ms(lambda: raster.project_bin_plain(*pb_args, **kw), 10),
        "library_ms": None,
        **bound(nbytes(*inputs, *plain), PROJECT_OPS * n),
    }
    return result, plain


def compare_bin_keys(projected, nt: int, mode, label: str) -> dict:
    """``bin_keys`` against its plain version on a pass's ``project_bin``
    outputs, bit for bit, and both timed; beside them the sort that the
    path runs on those int32 keys, and the same sort of the keys widened to
    int64 (the form the 32-bit keys replaced)."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    tile, depth, _, rng = projected
    got = raster.bin_keys(tile, depth, rng, nt, mode)
    want = raster.bin_keys_plain(tile, depth, rng, nt, mode)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or not torch.equal(got, want):
        fail(f"{label}: keys differ from the plain version")
    wide = got.to(torch.int64) + (1 << 31)  # the unsigned key, as the int64 sort took it
    if mode in ("first", "depth"):
        sort32, sort64 = (lambda: torch.sort(got)), (lambda: torch.sort(wide))
    else:
        sort32, sort64 = (lambda: torch.sort(got, stable=True)), (lambda: torch.sort(wide, stable=True))
    result = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: raster.bin_keys(tile, depth, rng, nt, mode), 100),
        "plain_ms": cuda_ms(lambda: raster.bin_keys_plain(tile, depth, rng, nt, mode), 20),
        "library_ms": None,
        **bound(nbytes(tile, depth, rng, got), KEY_OPS * tile.shape[0]),
        "sort_ms": cuda_ms(sort32, 50),
        "sort_int64_ms": cuda_ms(sort64, 50),
    }
    print(f"{label}: {tile.shape[0]} keys, mode {mode!r}, bit-exact; kernel {result['ms']:.4f} ms, "
          f"sort of the int32 keys {result['sort_ms']:.4f} ms (int64 {result['sort_int64_ms']:.4f})")
    return result


def covered_pairs(window, has, T: int, ntx: int, tri_col: int = -1, antialias=False) -> int:
    """The (entry, pixel) pairs of a ``tile_blend`` window that the
    reference's test covers (raster.py:620-642, the triangle test for the
    entries whose ``tri_col`` is set; with ``antialias`` the pairs of
    coverage > 0, raster.py:644-671; a pair that then fails a depth test
    or the squircle included: those tests run on it)."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    nt, M, _ = window.shape
    dev = window.device
    ar = torch.arange(T, device=dev)
    tiles = torch.arange(nt, device=dev)
    py = ((tiles // ntx)[:, None, None] * T + ar[None, :, None]).to(torch.float32) + 0.5
    px = ((tiles % ntx)[:, None, None] * T + ar[None, None, :]).to(torch.float32) + 0.5
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for m in range(M):
        cx, cy, a1x, a1y, a2x, a2y = (window[:, m, k, None, None] for k in range(6))
        det = a1x * a2y - a1y * a2x
        det = torch.where(det.abs() < 1e-9, 1e-9, det)
        dx, dy = px - cx, py - cy
        u = (a2y * dx - a2x * dy) / det
        v = (-a1y * dx + a1x * dy) / det
        inside = (u.abs() <= 1.0) & (v.abs() <= 1.0)
        is_tri = None
        if tri_col >= 0:
            is_tri = window[:, m, tri_col, None, None] > 0.5
            inside = torch.where(is_tri, (u >= -0.5) & (v >= -0.5) & (u + v <= 0.0), inside)
        if antialias:
            inside = raster._coverage(u, v, det[:, 0, 0], *(window[:, m, k] for k in range(2, 6)),
                                      torch.ones_like(inside), is_tri) > 0.0
        total += (inside & has[:, m, None, None]).sum()
    return int(total)


def appearance_ops(ap) -> int:
    """FP32 operations of a covered pair's appearance (raster.py:686-776),
    counted from the reference's code: the triangle test and the divisions
    for u, v (8), the squircle (two pows of ~20, 8 more), vertex colours
    (4 interpolations of 5, 4 products), Lambert (3 interpolations, the
    norm and its square root, 3 divisions, the dot product, the clip and 3
    products: 35), a triangle's UVs (2 interpolations), the flipbook cell
    (10), and a texture layer (the indices and fractions, 14; 3 lerps of 4
    channels, 24; the modulation, 4)."""
    if ap is None:
        return 0
    ops = 8
    ops += 48 if ap.offset("roundness") >= 0 else 0
    ops += 24 if ap.offset("vcol") >= 0 else 0
    ops += 35 if ap.lighting is not None else 0
    ops += 10 if ap.offset("uv") >= 0 else 0
    ops += 10 if (tuple(ap.grid) != (1, 1) and ap.layers) or ap.atlas_layers else 0
    return ops + 42 * (len(ap.layers) + ap.atlas_layers)


def blend_bound(mode: str, window, has, T: int, ntx: int, fb_out, depth_out=None, fb_in=None,
                depth_in=None, appearance=None, textures=(), antialias=False) -> dict:
    """``tile_blend``'s bound: the bytes the function must move (the filled
    entries' rows, the ``has`` flags, the planes in and out, each texture
    layer once) and the FP32 operations every correct kernel must do
    (``ENTRY_OPS`` a filled entry, the test, the appearance and the blend of
    each covered pair). Also returns the filled entries and the covered
    pairs."""
    filled = int(has.sum())
    tri_col = -1 if appearance is None else appearance.offset("tri")
    pairs = covered_pairs(window, has, T, ntx, tri_col, antialias)
    rows = filled * window.shape[2] * window.element_size()
    ops = ENTRY_OPS * filled + (COVER_TEST_OPS + BLEND_EQ_OPS[mode] + AA_OPS * antialias
                                + appearance_ops(appearance)) * pairs
    texs = {slot: textures[slot] for slot, _ in (appearance.layers if appearance else ())}
    if appearance is not None and appearance.atlas_layers:
        texs = {0: textures[0]}
    return {**bound(rows + nbytes(has, fb_out, depth_out, fb_in, depth_in, *texs.values()), ops),
            "filled_entries": filled, "covered_pairs": pairs}


def project_args(draw, cam, config) -> tuple:
    """``project_bin``'s positional arguments for a draw, camera and config."""
    return (draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color.contiguous(),
            cam.view, cam.proj, cam.viewport, config.tile_size, config.tiles_x, config.tiles_y)


def first_window_launcher(lib, rows, pidx_sorted, starts, ends, m: int, from_start: bool):
    """The earlier ``gather_window`` (:data:`GATHER_WINDOW_VARIANTS`) through
    ``lib``'s C entry point: a function of no argument that returns
    ``(window, has)`` as the port's wrapper does, or None where M * F is
    above the 12 288 floats it stages."""
    import ctypes

    import torch

    from bevy_hanabi_tpu_torch import cuda_build

    nt, width = starts.shape[0], rows.shape[1]
    if m * width > FIRST_WINDOW_FLOATS:
        return None
    fn = lib.hanabi_gather_window
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def run():
        window = torch.empty((nt, m, width), dtype=torch.float32, device=rows.device)
        has = torch.empty((nt, m), dtype=torch.bool, device=rows.device)
        code = fn(rows.data_ptr(), pidx_sorted.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                  window.data_ptr(), has.data_ptr(), nt, pidx_sorted.shape[0], rows.shape[0], m,
                  width, int(from_start), int(pidx_sorted.dtype == torch.int64),
                  int((m * width) % 4 == 0), cuda_build.current_stream())
        cuda_build.check(code, "gather_window (first version)")
        return window, has

    return run


def compare_gather_window(projected, nt: int, m: int, mode, label: str):
    """``gather_window`` against its plain version on a pass's entries
    (``project_bin``'s outputs, sorted as ``rasterize`` sorts them), bit for
    bit over the whole window and ``has``, and timed: the kernel; the earlier
    kernel in the same call (``first_ms``, held bit-exact too; None above
    the M * F it stages); its plain version; and one ``index_select`` of the
    same window's rows (``library_ms``: the gather half only, since no
    single PyTorch call builds the window). The bound counts the tile
    bounds, the filled slots' indices and rows read, and the whole window
    and ``has`` written. Returns the row and ``(window, has)``."""
    import torch

    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster

    tile, depth, rows, rng = projected
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, nt, mode, rng)
    args = (rows, pidx_sorted, starts, ends, m, mode is not None)
    window, has = gather.gather_window(*args)
    want_w, want_has = gather.gather_window_plain(*args)
    first = first_window_launcher(VARIANT_LIBS["first"], *args)
    outs = {"": (window, has)}
    if first is not None:
        outs[" (first version)"] = first()
    torch.cuda.synchronize()
    for name, (w, h) in outs.items():
        if not torch.equal(h, want_has) or not torch.equal(w.view(torch.int32),
                                                           want_w.view(torch.int32)):
            fail(f"gather_window{name} ({label}): differs from its plain version")
    filled = int(has.sum())
    # with several entries a particle, an entry reads row entry mod N
    n_rows = rows.shape[0] if pidx_sorted.shape[0] > rows.shape[0] else None
    idx = raster.window_index(*args[1:], n_rows=n_rows)[0].reshape(-1)
    read = filled * (pidx_sorted.element_size() + rows.shape[1] * rows.element_size())
    result = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather.gather_window(*args), 100),
        "first_ms": cuda_ms(first, 100) if first else None,
        "plain_ms": cuda_ms(lambda: gather.gather_window_plain(*args), 50),
        "library_ms": cuda_ms(lambda: rows.index_select(0, idx), 100),
        **bound(nbytes(starts, ends, window, has) + read),
        "filled_entries": filled,
    }
    first_ms = "refused" if first is None else f"{result['first_ms']:.4f} ms"
    print(f"gather_window ({label}): {nt} tiles x {m} slots x {rows.shape[1]} floats, {filled} "
          f"filled, {pidx_sorted.shape[0]} {pidx_sorted.dtype} entry ids over {rows.shape[0]} rows, "
          f"bit-exact; kernel {result['ms']:.4f} ms, first version {first_ms}, "
          f"index_select {result['library_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    return result, (window, has)


def compare_tile_blend(label: str, window, has, T: int, ntx: int, nty: int, background, mode: str,
                       first=None, plain_reps: int = 3, timed: bool = True, **kw):
    """``tile_blend`` against its plain version on a pass's window: the
    framebuffer at max abs err 0 and, where written, the depth plane equal
    (a round draw's squircle: at most :data:`SQUIRCLE_PIXELS` of the pixels
    differ and the checksums agree within 0.5%, since the card's powf and
    PyTorch's pow may differ in the last ulp); both timed. ``first``: a
    library holding another build of the kernel (the first appearance
    kernel, or on :data:`REDESIGNED_ROWS` the one before their redesign),
    held to the same standard and timed beside it as ``first_ms``.
    ``timed=False``: the comparisons alone (the row holds
    ``max_abs_err``). Returns the row and the kernel's depth plane (or
    None)."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    args = (window, has, T, ntx, nty, background, mode)
    write = kw.get("write_depth", False)
    want = raster.tile_blend_plain(*args, **kw)
    fb_p, d_p = want if write else (want, None)
    entries = int(has.sum())
    ap = kw.get("appearance")
    round_ = ap is not None and ap.offset("roundness") >= 0

    def check(got, who):
        torch.cuda.synchronize()
        fb_k, d_k = got if write else (got, None)
        err = float((fb_k - fb_p).abs().max())
        depth_ok = not write or torch.equal(d_k, d_p)
        differ = int(((fb_k - fb_p).abs() > 0).any(-1).sum())
        planes = f", depth planes {'equal' if depth_ok else 'DIFFER'}" if write else ""
        print(f"tile_blend {label}{who}: {entries} window entries, max abs err {err:g}, {differ} "
              f"pixels differ{planes}")
        if round_:
            s_k, s_p = float(fb_k.sum()), float(fb_p.sum())
            if differ > SQUIRCLE_PIXELS * fb_p[..., 0].numel() or not checksum_close(s_k, s_p):
                fail(f"tile_blend {label}{who}: {differ} pixels differ, checksums {s_k} and {s_p}")
        elif err != 0.0:
            fail(f"tile_blend {label}{who}: max abs err {err:g}")
        if not depth_ok or entries == 0:
            fail(f"tile_blend {label}{who}: the depth planes differ, or an empty window")
        return err, fb_k, d_k

    err, fb_k, d_k = check(raster.tile_blend(*args, **kw), "")

    def run_first():
        return raster.tile_blend_launch(first, window, has, T, ntx, background, mode, **kw)

    if first is not None:
        check(run_first(), " (first version)")
    if not timed:
        return {"max_abs_err": err}, d_k
    row = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: raster.tile_blend(*args, **kw), 50),
        "plain_ms": cuda_ms(lambda: raster.tile_blend_plain(*args, **kw), plain_reps),
        "library_ms": None,
        **blend_bound(mode, window, has, T, ntx, fb_k, d_k, kw.get("framebuffer"),
                      kw.get("scene_depth"), ap, kw.get("textures", ()), kw.get("antialias", False)),
    }
    if first is not None:
        row["first_ms"] = cuda_ms(run_first, 50)
    return row, d_k


def gather_row(table, idx) -> dict:
    """``gather_rows``'s timings and bound: the indices, the rows it reads
    and the rows it writes. Its plain version is one library call,
    ``index_select``, so that time is also ``library_ms``."""
    from bevy_hanabi_tpu_torch.ops import gather

    plain_ms = cuda_ms(lambda: gather.gather_rows_plain(table, idx), 100)
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather.gather_rows(table, idx), 100),
        "plain_ms": plain_ms,
        "library_ms": plain_ms,
        **bound(nbytes(idx) + 2 * idx.shape[0] * table.shape[1] * table.element_size()),
    }


def compare_gather(table, idx, label: str) -> None:
    """``gather_rows`` against ``table.index_select(0, idx)``, bit for bit."""
    import torch

    from bevy_hanabi_tpu_torch.ops import gather

    got = gather.gather_rows(table, idx)
    want = gather.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{label}: differs from table.index_select(0, idx)")
    print(f"{label}: [{table.shape[0]}, {table.shape[1]}] x {idx.shape[0]} rows, bit-exact")


def headline_frame(dev):
    """The headline's draw on the card: ``gradient_effect(1 << 20)`` stepped
    past its 5 s lifetime (steady churn), with its camera and config:
    ``(draw, cam, config)``."""
    import numpy as np

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, RasterConfig
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    asset = gradient_effect(CAPACITY)
    fx = CompiledEffect(asset, device=dev)
    pool = fx.create_pool()
    spawner = EffectSpawner(asset.spawner, rng=np.random.default_rng(1))
    frame = 0
    for _ in range(int(5.5 / DT) // K + 1):
        pool = fx.step_chunk(pool, *chunk_inputs(fx, spawner, frame))
        frame += K
    cam = headline_camera()
    return extract_draw_data(asset, pool, cam), cam, RasterConfig(512, 512, tile_slots=1)


def compare_kernels(dev):
    """Phase 3: each kernel against its plain version on a real frame."""
    import torch

    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster

    draw, cam, cfg = headline_frame(dev)
    T, ntx, nty, nt = cfg.tile_size, cfg.tiles_x, cfg.tiles_y, cfg.num_tiles
    M = cfg.max_entries_per_tile
    results = {}

    # the BLEND pass reads no column past alpha: 10-float rows
    results["project_bin"], projected = compare_project_bin(
        project_args(draw, cam, cfg), nt, "project_bin", raster.row_width("blend", False))
    results["bin_keys"] = compare_bin_keys(projected, nt, None, "bin_keys")

    results["gather_window"], win = compare_gather_window(projected, nt, M, None, "headline")
    results["tile_blend"], _ = compare_tile_blend("blend", *win, T, ntx, nty, cfg.background, "blend")
    # the antialiased headline's pass: the same window, tile_blend's kAA variant
    results["tile_blend[blend,aa]"], _ = compare_tile_blend(
        "blend (antialiased)", *win, T, ntx, nty, cfg.background, "blend",
        **REDESIGNED_KW, antialias=True)

    # MASK, which no main path runs: the headline's draw in 13-float rows
    # with rasterize's default cutoff (0.5), writing depth as the split
    # pipeline's opaque phase does
    n = draw.position.shape[0]
    extra = torch.stack([torch.full((n,), 0.5, device=dev), torch.zeros((n,), device=dev)], dim=1)
    masked = raster.project_bin(*project_args(draw, cam, cfg), extra=extra, row=raster.ROW)
    _, win = compare_gather_window(masked, nt, M, None, "headline, 13-float rows")
    results["tile_blend[mask]"], _ = compare_tile_blend(
        "mask", *win, T, ntx, nty, cfg.background, "mask", depth_test=True, write_depth=True)

    # the companions' binnings on the same draw: S = 2 (T 8 and 16), span^2 = 4
    for name, binning in COMPANIONS.items():
        c = RasterConfig(512, 512, **binning)
        results[f"project_bin[{name}]"], projected = compare_project_bin(
            project_args(draw, cam, c), c.num_tiles, f"project_bin ({name})",
            raster.row_width("blend", False), config=c)
        results[f"bin_keys[{name}]"] = compare_bin_keys(projected, c.num_tiles, None,
                                                         f"bin_keys ({name})")
        results[f"gather_window[{name}]"], win = compare_gather_window(
            projected, c.num_tiles, c.max_entries_per_tile, None, name)
        results[f"tile_blend[{name}]"], _ = compare_tile_blend(
            f"blend ({name})", *win, c.tile_size, c.tiles_x, c.tiles_y, c.background, "blend")
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def small_frame(device):
    """The 8192-particle gradient frame at 128x128 on ``device``: three
    frames of spawns [4096, 1024, 2048] at dt = 2 s (the third reaps)."""
    from bevy_hanabi_tpu_torch import CompiledEffect, RasterConfig, SimParams, StepInputs
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    fx = CompiledEffect(gradient_effect(8192), device=device)
    ins = [StepInputs.make(s, 7 + 31 * i) for i, s in enumerate([4096, 1024, 2048])]
    sims = [SimParams(time=2.0 * i, delta_time=2.0) for i in range(3)]
    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
    pool, img, sums = fx.step_render_chunk(
        fx.create_pool(), *fx.stack_frames(ins, sims), cam, RasterConfig(128, 128, tile_slots=1)
    )
    return pool, img, sums


def reset_launches(kernels) -> None:
    for kernel in kernels.values():
        kernel.wrapper.launches = 0
    tb = kernels["tile_blend"].wrapper
    for by_mode in (tb.launches_by_mode, tb.launches_appearance, tb.launches_antialias):
        for mode in by_mode:
            by_mode[mode] = 0


def read_launches(kernels) -> dict:
    """Launches by kernel, ``tile_blend`` by equation: ``tile_blend`` is
    BLEND, ``tile_blend[add]``, ``[opaque]``, ``[mask]``, ``[scene]``,
    ``[premultiply]``, ``[multiply]`` the others,
    ``tile_blend[<mode>,appearance]`` the appearance variants' launches
    among them and ``tile_blend[<mode>,antialias]`` the antialiased ones'."""
    counts = {name: k.wrapper.launches for name, k in kernels.items()}
    tb = kernels["tile_blend"].wrapper
    for mode, n in tb.launches_by_mode.items():
        counts["tile_blend" if mode == "blend" else f"tile_blend[{mode}]"] = n
    for mode, n in tb.launches_appearance.items():
        counts[f"tile_blend[{mode},appearance]"] = n
    for mode, n in tb.launches_antialias.items():
        counts[f"tile_blend[{mode},antialias]"] = n
    return counts


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] == 0:
            fail(f"{path} never launched {name}")


def firework_scene(device, seed, rockets, trails):
    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect

    scene = HanabiScene(seed=seed, device=device)
    scene.add(firework_effect(rockets), "rocket")
    scene.add(firework_trail_effect(trails), "trail", parent="rocket")
    return scene


def firework_gate():
    """Phase 6: the 2k -> 8k tree on the card against the CPU."""
    import numpy as np

    card = firework_scene("cuda", 17, 2048, 8192)
    cpu = firework_scene("cpu", 17, 2048, 8192)
    frame = 0
    for checkpoint in (30, 90):
        while frame < checkpoint:
            card.update(DT)
            cpu.update(DT)
            frame += 1
        counts_g = (card["rocket"].alive_count(), card["trail"].alive_count())
        counts_c = (cpu["rocket"].alive_count(), cpu["trail"].alive_count())
        print(f"firework 2k->8k after {frame} frames: alive (rocket, trail) card {counts_g} "
              f"cpu {counts_c}")
        if counts_g != counts_c:
            fail(f"firework 2k->8k: alive counts differ after {frame} frames")
        for name in ("rocket", "trail"):
            attrs_g, alive_g, seed_g, _ = card[name].pool.to_numpy()
            attrs_c, alive_c, seed_c, _ = cpu[name].pool.to_numpy()
            if not np.array_equal(alive_g, alive_c):
                fail(f"firework 2k->8k: {name} alive masks differ after {frame} frames")
            if not np.array_equal(seed_g, seed_c):
                fail(f"firework 2k->8k: {name} PCG seeds differ after {frame} frames")
            # a trail inherits its rocket's position through the payload gather
            for attr in ("position", "velocity"):
                a, b = attrs_g[attr][alive_c], attrs_c[attr][alive_c]
                err = float(np.abs(a - b).max(initial=0.0))
                if not np.allclose(a, b, rtol=POS_RTOL, atol=POS_ATOL):
                    fail(f"firework 2k->8k: {name} {attr} differs after {frame} frames "
                         f"(max abs err {err:g})")
                print(f"  {name} {attr}: {a.shape[0]} alive lanes, max abs err {err:g}")
    if counts_g[1] == 0:
        fail("firework 2k->8k: no trail spawned in 90 frames: no event flowed")


def compare_event_compact(scene):
    """Phase 7a: event_compact against its plain version on the rocket pool
    (n = 65536; the alive rockets are the active lanes, count 4, payload =
    position)."""
    import torch

    from bevy_hanabi_tpu_torch.runtime import events

    pool = scene["rocket"].pool
    n = pool.capacity
    mask = pool.alive.contiguous()
    count = torch.full((n,), 4, dtype=torch.int64, device=mask.device)
    payload = pool.attrs["position"].contiguous().view(torch.int32)
    got = events.event_compact(mask, count, payload)
    want = events.event_compact_plain(mask, count, payload)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("event_compact: differs from the stable-sort plain version")
    active = int(got[2])
    print(f"event_compact: n={n}, {active} active lanes, W={payload.shape[1]}, bit-exact")
    if active == 0:
        fail("event_compact: the comparison had no active lane")
    return {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: events.event_compact(mask, count, payload), 100),
        "plain_ms": cuda_ms(lambda: events.event_compact_plain(mask, count, payload), 20),
        "library_ms": None,
        **bound(nbytes(mask, count, payload, *got)),
    }


def compare_payload_gather(scene):
    """Phase 7b: the trail step's payload gather on the card against its
    plain version: the rocket buffer's position table [65536, 3] at the
    event index (rank // 4) of every one of the 262144 trail lanes, as the
    next ``update`` would gather it, while rockets are dying."""
    import torch

    from bevy_hanabi_tpu_torch.ops.compaction import exclusive_rank
    from bevy_hanabi_tpu_torch.runtime import events

    trail = scene["trail"]
    buf = scene["rocket"].last_events[trail.child_channel]
    table = buf.payload["position"].contiguous()
    rank = exclusive_rank(~trail.pool.alive)
    idx = events.event_index(buf, rank, trail.fx.parent_const_count).to(torch.int32)
    pending = int(buf.num_events)
    print(f"payload gather: {pending} events pending")
    if pending == 0:
        fail("payload gather: no event pending, so no trail would inherit a position")
    compare_gather(table, idx, "gather_rows (event payload)")
    return gather_row(table, idx)


def compare_firework_frame(scene, cam, config):
    """Phase 7b: ``project_bin``, ``bin_keys``, ``gather_window`` and the
    ADD ``tile_blend`` against their plain versions on the scene's real
    512x512 frame (its one transparent batch pass, 327,680 entries)."""
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import concat_draws, extract_draw_data

    sim = scene.clock.sim_params()
    draw = concat_draws([extract_draw_data(e.asset, e.pool, cam, sim=sim, transform=e.transform)
                         for e in scene.effects()])
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    M = config.max_entries_per_tile
    pb_row, projected = compare_project_bin(
        project_args(draw, cam, config), nt, "project_bin (firework)", raster.row_width("add", False))
    tile = projected[0]
    mode = raster.fast_mode(config, "add", tile.shape[0])
    keys_row = compare_bin_keys(projected, nt, mode, "bin_keys (firework)")
    window_row, win = compare_gather_window(projected, nt, M, mode, "firework")
    blend_row, _ = compare_tile_blend(f"add ({mode!r}, {tile.shape[0]} entries)", *win, T, ntx, nty,
                                      config.background, "add")
    return {
        "project_bin[firework]": pb_row,
        "bin_keys[firework]": keys_row,
        "gather_window[firework]": window_row,
        "tile_blend[add]": blend_row,
    }


def firework_tree(kernels, cam):
    """Phase 7: the 64k -> 256k tree through update_chunk and render."""
    import copy

    import torch

    from bevy_hanabi_tpu_torch import ParticlePool, RasterConfig

    config = RasterConfig(512, 512, tile_slots=1)
    scene = firework_scene("cuda", 5, 65536, 262144)
    # The spawner bursts 2048 rockets every 2 s (120 frames): warm up to 10
    # frames into a burst period, when every rocket of the burst is alive.
    t0 = time.perf_counter()
    scene.update_chunk(FW_K + FW_INTO_BURST, DT)
    print(f"firework 64k->256k warm-up: {FW_K + FW_INTO_BURST} frames in "
          f"{time.perf_counter() - t0:.2f} s, alive rockets {scene['rocket'].alive_count()} "
          f"trails {scene['trail'].alive_count()}")
    results = {"event_compact": compare_event_compact(scene)}

    reset_launches(kernels)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene.update_chunk(FW_K, DT)
        alive = scene["trail"].alive_count()  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"firework chunk times (s): {times}")
    print(f"firework 64k->256k: {FW_K} frames in {best:.4f} s: {FW_K / best:.2f} steps/s, "
          f"alive rockets {scene['rocket'].alive_count()} trails {alive}")
    # Render 75 frames into the burst period, when rockets are dying and
    # trails spawning, so the frame holds both.
    scene.update_chunk(FW_RENDER_AT - FW_INTO_BURST, DT)
    print(f"rendered frame: alive rockets {scene['rocket'].alive_count()} "
          f"trails {scene['trail'].alive_count()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = scene.render(cam, config)
    checksum = float(img.sum())  # readback: waits for the frame
    render_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    print(f"launches in the timed chunks and the frame: {launches}")
    require_launches(launches, FIREWORK_KERNELS, "the firework tree")
    if not torch.isfinite(img).all() or not checksum > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail("firework frame is not finite, not positive or not 512x512x4")
    render_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        float(scene.render(cam, config).sum())
        render_ms.append(1e3 * (time.perf_counter() - t1))
    print(f"firework frame 512x512 ({scene['rocket'].pool.capacity + scene['trail'].pool.capacity}"
          f" entries): first {1e3 * render_s:.3f} ms, then {render_ms} ms, checksum {checksum:.6e}")
    results.update(compare_firework_frame(scene, cam, config))
    results["gather_rows[firework]"] = compare_payload_gather(scene)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    cpu = firework_scene("cpu", 5, 65536, 262144)
    cpu.clock = copy.deepcopy(scene.clock)
    for name in ("rocket", "trail"):
        cpu[name].pool = ParticlePool.from_numpy(*scene[name].pool.to_numpy(), device="cpu")
    s_p = float(cpu.render(cam, config).sum())
    print(f"firework frame re-rendered: card {checksum:.6e} vs cpu plain {s_p:.6e}")
    if not checksum_close(checksum, s_p):
        fail(f"firework frame checksum {checksum} on the card vs {s_p} on the CPU")
    return scene, results, launches


def profile_frames(label: str, run, frames: int = 30) -> None:
    """Phases 8 and 11: launches, copies, synchronisations, the device's
    busy share and device time by op and by kernel over ``frames`` frames
    of ``run(frames)``, which ends in a readback (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(frames)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    by_call = {call: sum(e.count for e in events if e.key == call) for call in LAUNCH_CALLS}
    launches = sum(by_call.values())
    copies = sum(e.count for e in events if e.key == "cudaMemcpyAsync")
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    print(f"profile {label}: {frames} frames, wall {1e3 * wall:.2f} ms (profiled), device busy "
          f"{device_us / 1e3:.3f} ms ({100.0 * device_us / 1e6 / wall:.1f}% of the wall); per frame "
          f"{launches / frames:.1f} launches ("
          + ", ".join(f"{call} {n / frames:.1f}" for call, n in by_call.items())
          + f"), {copies / frames:.1f} cudaMemcpyAsync, {syncs / frames:.1f} cudaStreamSynchronize")
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    print(f"profile {label}: aten ops by device time (ms a frame, calls a frame, host ms a frame)")
    for e in ops[:10]:
        print(f"  {e.key:32s} {e.device_time_total / 1e3 / frames:8.4f} "
              f"{e.count / frames:6.1f} {e.cpu_time_total / 1e3 / frames:8.4f}")
    print(f"profile {label}: kernels by device time (ms a frame)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / frames:8.4f}  {e.key[:110]}")


def profile_firework(scene, frames: int = 30) -> None:
    """Phase 8: ``profile_frames`` over ``frames`` firework frames."""

    def run(k):
        scene.update_chunk(k, DT)
        scene["trail"].alive_count()

    profile_frames("firework", run, frames)


def gate_camera(eye_z: float = 6.0, fov: float = 0.9, far: float = 100.0):
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(look_at((0, 0, eye_z), (0, 0, 0)), perspective(fov, 1.0, 0.1, far), (128, 128))


def compare_pools(card, cpu, names, label: str) -> None:
    """Alive masks and PCG seeds of ``names``, card against CPU, bit for bit."""
    import numpy as np

    for name in names:
        _, alive_g, seed_g, _ = card[name].pool.to_numpy()
        _, alive_c, seed_c, _ = cpu[name].pool.to_numpy()
        if not np.array_equal(alive_g, alive_c):
            fail(f"{label}: {name} alive masks differ between the card and the CPU")
        if not np.array_equal(seed_g, seed_c):
            fail(f"{label}: {name} PCG seeds differ between the card and the CPU")


def painter_gate():
    """Phase 9: the JAX package's painter gate (bench.py:331-357), card
    against CPU."""
    from bevy_hanabi_tpu_torch import AlphaMode, HanabiScene, RasterConfig
    from bevy_hanabi_tpu_torch.models import gradient_effect, spawn_gravity_effect

    def run(device):
        s = HanabiScene(seed=9, device=device)
        s.add(gradient_effect(capacity=2048), "blend")
        s.add(gradient_effect(capacity=2048).with_alpha_mode(AlphaMode.ADD), "add")
        s.add(spawn_gravity_effect(capacity=1024, rate=2000.0).with_alpha_mode(AlphaMode.OPAQUE), "opq")
        for _ in range(3):
            s.update(DT)
        img = s.render(gate_camera(), RasterConfig(128, 128, tile_slots=1), pipeline="painter")
        return s, img

    (card, img_g), (cpu, img_c) = run("cuda"), run("cpu")
    compare_pools(card, cpu, ("blend", "add", "opq"), "painter gate")
    s_g, s_c = float(img_g.sum()), float(img_c.sum())
    print(f"painter gate 128x128: alive {[card[n].alive_count() for n in ('blend', 'add', 'opq')]}, "
          f"checksum card {s_g:.6e} cpu {s_c:.6e}")
    if not bool(img_g.isfinite().all()) or not checksum_close(s_g, s_c):
        fail(f"painter gate: checksum {s_g} on the card vs {s_c} on the CPU")


def debris_effect(capacity: int):
    """The mixed scene's opaque debris, built as bench.py:702-723 builds it."""
    from bevy_hanabi_tpu_torch import AlphaMode, EffectAsset, ExprWriter, SpawnerSettings
    from bevy_hanabi_tpu_torch import attributes as A
    from bevy_hanabi_tpu_torch.modifiers import (
        SetAttributeModifier,
        SetPositionSphereModifier,
        SetSizeModifier,
        SetVelocitySphereModifier,
        ShapeDimension,
    )

    w = ExprWriter()
    return (
        EffectAsset("debris", capacity, SpawnerSettings.rate(capacity / 4.0), w.finish())
        .init(SetPositionSphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(3.0),
                                        ShapeDimension.VOLUME))
        .init(SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(1.0)))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.HDR_COLOR, w.lit((0.9, 0.6, 0.2, 1.0)).expr()))
        .render(SetSizeModifier((0.05,) * 3))
        .with_alpha_mode(AlphaMode.OPAQUE)
    )


MIXED_NAMES = ("debris", "grad", "rocket", "trail")


def mixed_scene(device, debris, grad, rockets, trails):
    """The mixed scene of bench.py:724-728 at the given capacities."""
    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect, gradient_effect

    scene = HanabiScene(seed=3, device=device)
    scene.add(debris_effect(debris), "debris")
    scene.add(gradient_effect(capacity=grad), "grad")
    scene.add(firework_effect(capacity=rockets), "rocket")
    scene.add(firework_trail_effect(capacity=trails), "trail", parent="rocket")
    return scene


def mixed_camera(size: int = 512):
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(
        view=look_at([0.0, 0.0, 26.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        proj=perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(size, size),
    )


def mixed_gate():
    """Phase 10: the small mixed scene through update_render_chunk, card
    against CPU, for both pipelines."""
    from bevy_hanabi_tpu_torch import RasterConfig

    cam, cfg = mixed_camera(128), RasterConfig(128, 128, tile_slots=1)
    for pipeline in ("auto", "split"):
        card = mixed_scene("cuda", 1024, 4096, 512, 2048)
        cpu = mixed_scene("cpu", 1024, 4096, 512, 2048)
        for chunk in range(12):  # 96 frames: the first burst's rockets die, trails spawn
            _, sums_g = card.update_render_chunk(MIXED_K, DT, cam, cfg, pipeline=pipeline)
            _, sums_c = cpu.update_render_chunk(MIXED_K, DT, cam, cfg, pipeline=pipeline)
            for k, (a, b) in enumerate(zip(sums_g.cpu().tolist(), sums_c.tolist())):
                if not checksum_close(a, b):
                    fail(f"mixed gate {pipeline}: chunk {chunk} frame {k}: checksum {a} on the card "
                         f"vs {b} on the CPU")
        compare_pools(card, cpu, MIXED_NAMES, f"mixed gate {pipeline}")
        if int(cpu["trail"].pool.counter) == 0:
            fail(f"mixed gate {pipeline}: no trail spawned: no event flowed")
        print(f"mixed gate {pipeline}: {12 * MIXED_K} frames, alive "
              f"{[card[n].alive_count() for n in MIXED_NAMES]}, masks and seeds bit-equal, last "
              f"checksum card {float(sums_g[-1]):.6e} cpu {float(sums_c[-1]):.6e}")


def scene_draws(scene, cam) -> dict:
    """Each effect's draw data of the scene's current frame, by name."""
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    sim = scene.clock.sim_params()
    return {e.name: extract_draw_data(e.asset, e.pool, cam, sim=sim,
                                      properties=e.properties.as_dict(), transform=e.transform)
            for e in scene.effects()}


def painter_draw(scene, draws):
    """The painter pass's one draw of every effect, and its ``extra``
    columns (mask cutoff, blend-mode id), as ``HanabiScene`` builds them."""
    import torch

    from bevy_hanabi_tpu_torch.render.extract import concat_painter_draws

    effects = scene.effects()
    painter = concat_painter_draws([draws[e.name] for e in effects],
                                   [e.asset.alpha_mode.kind for e in effects])
    return painter, torch.stack([painter.alpha_cutoff, painter.mode_id.to(torch.float32)], dim=1)


def painter_target(config, device):
    """The painter pass's seeded framebuffer, tiled: opaque black."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    black = torch.tensor((0.0, 0.0, 0.0, 1.0), device=device).expand(config.height, config.width, 4)
    return raster.to_tiles(black, config, 0.0)


def warm_mixed(scene, cam, config) -> int:
    """Run the mixed scene to steady state (bench.py:738: past the longest
    lifetime) in chunks of K frames; returns the frames run."""
    warm = (int(5.0 / DT) + K) // K + 1
    for _ in range(warm):
        float(scene.update_render_chunk(K, DT, cam, config)[1][-1])
    return warm * K


def compare_mixed_kernels(scene, cam, config):
    """Phase 11: each kernel of both pipelines against its plain version at
    the pass's own shapes on the full scene's frame: the painter pass's
    ``project_bin`` (with the cutoff and mode columns), window gather and
    ``tile_blend`` SCENE at M = 64 and M = 128; the split pipeline's
    depth-writing OPAQUE debris pass, then its BLEND gradient pass and its
    ADD rocket + trail batch, both depth-tested against the debris pass's
    depth plane, as ``HanabiScene._render_frame`` threads it; then the trail
    step's payload gather."""
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import concat_draws

    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    M = config.max_entries_per_tile
    draws = scene_draws(scene, cam)
    clear = (0.0, 0.0, 0.0, 0.0)  # a split pass's layer background (blend, add, opaque)
    results = {}

    def project(draw, label, row, extra=None):
        return compare_project_bin(project_args(draw, cam, config), nt, f"project_bin ({label})", row,
                                   extra)

    def window(projected, label, m, mode=None):
        return compare_gather_window(projected, nt, m, mode, label)

    def blend_row(label, win, background, mode, **kw):
        return compare_tile_blend(label, *win, T, ntx, nty, background, mode, **kw)

    # the painter pass ("auto"): every effect in one window
    painter, extra = painter_draw(scene, draws)
    results["project_bin[mixed]"], projected = project(
        painter, f"painter, {painter.alive.shape[0]} entries", raster.row_width("scene", True), extra)
    results["bin_keys[mixed]"] = compare_bin_keys(projected, nt, None, "bin_keys (painter)")
    fb0 = painter_target(config, extra.device)
    for m, name in ((M, "tile_blend[scene]"), (MIXED_M_WIDE, f"tile_blend[scene,M={MIXED_M_WIDE}]")):
        gathered, win = window(projected, f"painter M={m}", m)
        if m == M:
            results["gather_window[mixed]"] = gathered
        results[name], _ = blend_row(f"scene M={m}", win, config.background, "scene",
                                     framebuffer=fb0, depth_test=True, write_depth=True)

    # the split pipeline: the opaque phase writes the depth plane that the
    # transparent passes test against
    wide = raster.row_width("opaque", True)
    _, win = window(project(draws["debris"], "debris, opaque", wide)[1], "debris", M)
    results["tile_blend[opaque]"], debris_depth = blend_row(
        "opaque", win, clear, "opaque", depth_test=True, write_depth=True)
    _, win = window(project(draws["grad"], "gradient, blend", wide)[1], "gradient", M)
    results["tile_blend[blend,split]"], _ = blend_row(
        "blend split", win, clear, "blend", scene_depth=debris_depth, depth_test=True)
    batch = concat_draws([draws["rocket"], draws["trail"]])
    mode = raster.fast_mode(config, "add", batch.alive.shape[0])
    _, win = window(project(batch, "rocket + trail, add", wide)[1], "rocket + trail", M, mode)
    results["tile_blend[add,split]"], _ = blend_row(
        f"add split ({mode!r})", win, clear, "add", scene_depth=debris_depth, depth_test=True)
    # the trail step's payload gather, as in the firework tree
    results["gather_rows[mixed]"] = compare_payload_gather(scene)
    return results


def rerender_on_cpu(scene, cam, config, pipeline: str, checksum: float, label: str) -> None:
    """The scene's last frame again on the CPU through the plain versions,
    from its pools and clock copied there: checksums within 0.5%."""
    import copy

    from bevy_hanabi_tpu_torch import ParticlePool

    cpu = mixed_scene("cpu", 65536, 1 << 19, 65536, 262144)
    cpu.clock = copy.deepcopy(scene.clock)
    for name in MIXED_NAMES:
        cpu[name].pool = ParticlePool.from_numpy(*scene[name].pool.to_numpy(), device="cpu")
    t0 = time.perf_counter()
    s_p = float(cpu.render(cam, config, pipeline=pipeline).sum())
    print(f"mixed frame ({label}) re-rendered: card {checksum:.6e} vs cpu plain {s_p:.6e} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    if not checksum_close(checksum, s_p):
        fail(f"mixed frame ({label}) checksum {checksum} on the card vs {s_p} on the CPU")


def mixed_full(kernels):
    """Phase 11: the full mixed scene through update_render_chunk."""
    import dataclasses

    import torch

    from bevy_hanabi_tpu_torch import RasterConfig

    cam = mixed_camera()
    cfg = RasterConfig(width=512, height=512, tile_slots=1)
    scene = mixed_scene("cuda", 65536, 1 << 19, 65536, 262144)
    lanes = sum(e.pool.capacity for e in scene.effects())
    t0 = time.perf_counter()
    frames = warm_mixed(scene, cam, cfg)
    print(f"mixed scene ({lanes} lanes) warm-up: {frames} frames in {time.perf_counter() - t0:.2f} s, "
          f"alive {[scene[n].alive_count() for n in MIXED_NAMES]}")
    launches = {}
    for label, c, pipeline in (
        ("auto", cfg, "auto"),
        ("split", cfg, "split"),
        (f"auto M={MIXED_M_WIDE}", dataclasses.replace(cfg, max_entries_per_tile=MIXED_M_WIDE), "auto"),
    ):
        reset_launches(kernels)
        scene.update_render_chunk(K, DT, cam, c, pipeline=pipeline)  # untimed, as bench.py:749
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, sums = scene.update_render_chunk(K, DT, cam, c, pipeline=pipeline)
            checksum = float(sums[-1])  # readback: waits for the chunk
            times.append(time.perf_counter() - t0)
        launches[label] = read_launches(kernels)
        best = min(times)
        print(f"mixed scene {label}: {K} frames in {best:.4f} s: {K / best:.2f} frames/s "
              f"({1e3 * best / K:.3f} ms a frame), chunk times (s) {times}, alive "
              f"{scene.total_alive()}, checksum {checksum:.6e}")
        print(f"launches in the {label} chunks (4 x {K} frames): {launches[label]}")
        require_launches(launches[label], MIXED_KERNELS[pipeline], f"the mixed scene ({label})")
    if not bool(img.isfinite().all()) or not checksum > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail("mixed scene frame is not finite, not positive or not 512x512x4")
    # the last frame (auto, M=128) again on the CPU through the plain versions
    rerender_on_cpu(scene, cam, c, "auto", checksum, f"auto M={MIXED_M_WIDE}")

    # Every chunk above ends on a burst boundary, when no rocket or trail is
    # alive; a split chunk ending 75 frames into a burst puts both on screen
    # for the split frame's re-render and the kernel comparisons.
    img, sums = scene.update_render_chunk(FW_RENDER_AT, DT, cam, cfg, pipeline="split")
    checksum = float(sums[-1])
    print(f"split frame {FW_RENDER_AT} frames into a burst: alive "
          f"{[scene[n].alive_count() for n in MIXED_NAMES]}")
    rerender_on_cpu(scene, cam, cfg, "split", checksum, "split")
    results = compare_mixed_kernels(scene, cam, cfg)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    def run(k):
        float(scene.update_render_chunk(k, DT, cam, cfg)[1][-1])

    profile_frames("mixed", run)
    return results, launches


def ribbon_camera():
    """The ribbon frame's camera (bench.py:620-626)."""
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(
        view=look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        proj=perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(512, 512),
    )


def ribbon_gate():
    """Phase 12: the ribbon gate (bench.py:221-251), card against CPU."""
    import numpy as np

    from bevy_hanabi_tpu_torch import CompiledEffect, RasterConfig, SimParams, StepInputs
    from bevy_hanabi_tpu_torch.models import ribbon_order_check_effect
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.ribbon import build_ribbon_segments, ribbon_sort

    cam = gate_camera()

    def run(device):
        fx = CompiledEffect(ribbon_order_check_effect(8192, 64), device=device)
        ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
        sims = [SimParams(time=i * DT, delta_time=DT) for i in range(30)]
        pool, img, sums = fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam,
                                               RasterConfig(128, 128, tile_slots=1))
        draw = extract_draw_data(fx.asset, pool, cam)
        valid = build_ribbon_segments(draw, cam).alive.cpu()
        return pool, img, sums.cpu().tolist(), valid, ribbon_sort(draw).order.cpu()

    (pool_g, img_g, sums_g, valid_g, order_g), (pool_c, _, sums_c, valid_c, order_c) = (
        run("cuda"), run("cpu"))
    if not np.array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1]):
        fail("ribbon gate: alive masks differ between the card and the CPU")
    if not np.array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2]):
        fail("ribbon gate: PCG seeds differ between the card and the CPU")
    for k, (a, b) in enumerate(zip(sums_g, sums_c)):
        if not checksum_close(a, b) or not b > 0.0:
            fail(f"ribbon gate: frame {k}: checksum {a} on the card vs {b} on the CPU")
    if not bool(valid_g.equal(valid_c)) or not bool(order_g[valid_c].equal(order_c[valid_c])):
        fail("ribbon gate: the valid segments or their order differ between the card and the CPU")
    if not bool(img_g.isfinite().all()):
        fail("ribbon gate: non-finite pixels on the card")
    print(f"ribbon gate 128x128: alive {pool_g.alive_count()}, {int(valid_c.sum())} valid segments "
          f"in the same order, masks and seeds bit-equal, last checksum card {sums_g[-1]:.6e} "
          f"cpu {sums_c[-1]:.6e}")


def segments_launcher(lib, position, axis_y, color, alpha_cutoff, perm1, perm2, key,
                      camera_position):
    """``ribbon_segments`` through another library's C entry point (a
    variant or probe of :data:`RIBBON_VARIANTS`), as the port's wrapper
    calls it: a function of no argument that returns the same tuple. The
    rows are ``perm2``'s, which may be fewer than the tables' (a prefix of
    the sorted rows)."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import cuda_build

    n, dev = perm2.shape[0], position.device
    cam = np.ascontiguousarray(torch.as_tensor(camera_position, dtype=torch.float32).cpu().numpy())

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        out = [torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(3)]
        out.append(torch.empty((n,), dtype=torch.bool, device=dev))
        out.append(torch.empty((n, 4), dtype=torch.float32, device=dev))
        out.append(None if alpha_cutoff is None else torch.empty((n,), dtype=torch.float32,
                                                                  device=dev))
        code = lib.hanabi_ribbon_segments(
            position.data_ptr(), axis_y.data_ptr(), color.data_ptr(), ptr(alpha_cutoff),
            ptr(perm1), perm2.data_ptr(), key.data_ptr(), cam.ctypes.data,
            *(ptr(t) for t in out), n, cuda_build.current_stream())
        cuda_build.check(code, "ribbon_segments (variant)")
        return tuple(out)

    return run


def compare_ribbon_kernels(draw, cam, variants) -> dict:
    """Phase 13: ``ribbon_keys`` (both stages) and ``ribbon_segments``
    against their plain versions on the ribbon frame's draw, keys equal and
    segments at max abs err 0; both timed, beside the two stable sorts and
    the appearance gather (``index_select`` of the colour rows by the segment
    order, ``ribbon_segments``' ``library_ms``; and ``gather_rows_ms``, the
    same gather by the port's ``gather_rows``). ``ribbon_segments`` also
    beside the first version of its kernel (``first_ms``; its results equal
    too) and the two floors of the call: ``floor_coalesced_ms``, the first
    version with ``perm1`` None and ``perm2`` the identity (every read in
    order), and ``floor_copy_ms``, a streaming copy of the call's bytes."""
    import torch

    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import ribbon

    n = draw.alive.shape[0]
    alive, counter, rid, age = draw.alive, draw.counter, draw.ribbon_id, draw.age
    key1 = ribbon.ribbon_keys(alive, counter=counter)
    perm1 = torch.sort(key1, stable=True).indices
    key2 = ribbon.ribbon_keys(alive, ribbon_id=rid, age=age, perm=perm1)
    plain1 = ribbon.ribbon_keys_plain(alive, counter=counter)
    plain2 = ribbon.ribbon_keys_plain(alive, ribbon_id=rid, age=age, perm=perm1)
    key_sorted, perm2 = torch.sort(key2, stable=True)
    torch.cuda.synchronize()
    if not (torch.equal(key1, plain1) and torch.equal(key2, plain2)):
        fail("ribbon_keys: keys differ from the plain version")

    def both_stages(keys):
        return lambda: (keys(alive, counter=counter),
                        keys(alive, ribbon_id=rid, age=age, perm=perm1))

    keys_row = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(both_stages(ribbon.ribbon_keys), 100),
        "plain_ms": cuda_ms(both_stages(ribbon.ribbon_keys_plain), 20),
        "library_ms": None,
        **bound(nbytes(alive, counter, key1) + nbytes(perm1, alive, rid, age, key2)),
        "counter_ms": cuda_ms(lambda: ribbon.ribbon_keys(alive, counter=counter), 100),
        "order_ms": cuda_ms(lambda: ribbon.ribbon_keys(alive, ribbon_id=rid, age=age, perm=perm1),
                            100),
        "sort_counter_ms": cuda_ms(lambda: torch.sort(key1, stable=True), 50),
        "sort_order_ms": cuda_ms(lambda: torch.sort(key2, stable=True), 50),
    }
    print(f"ribbon_keys: {n} lanes, both stages bit-exact; kernel {keys_row['ms']:.4f} ms "
          f"(counter {keys_row['counter_ms']:.4f}, order {keys_row['order_ms']:.4f}), stable sorts "
          f"int32 {keys_row['sort_counter_ms']:.4f} ms, int64 {keys_row['sort_order_ms']:.4f} ms")

    args = (draw.position.contiguous(), draw.axis_y.contiguous(), draw.color.contiguous(), None,
            perm1, perm2, key_sorted, cam.position)
    got = ribbon.ribbon_segments(*args)
    want = ribbon.ribbon_segments_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want) if a is not None)
    exact = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
    valid = int(got[3].sum())
    print(f"ribbon_segments: {n} rows, {valid} valid segments, max abs err {err:g}")
    if err != 0.0 or not exact or valid == 0:
        fail(f"ribbon_segments: max abs err {err:g} against the plain version, or no valid segment")
    first = segments_launcher(variants["first"], *args)
    if not all(torch.equal(a, b) for a, b in zip(first(), want) if a is not None):
        fail("ribbon_segments: the first version's results differ from the plain version")
    coalesced = segments_launcher(variants["first"], *args[:4], None,
                                  torch.arange(n, device=perm2.device), *args[6:])
    order = perm1[perm2]
    order32 = order.to(torch.int32)
    color = args[2]
    seg_row = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ribbon.ribbon_segments(*args), 100),
        "plain_ms": cuda_ms(lambda: ribbon.ribbon_segments_plain(*args), 20),
        "library_ms": cuda_ms(lambda: color.index_select(0, order), 100),
        # the same appearance gather by the port's own row gather kernel
        "gather_rows_ms": cuda_ms(lambda: gather.gather_rows(color, order32), 100),
        "first_ms": cuda_ms(first, 100),
        "floor_coalesced_ms": cuda_ms(coalesced, 100),
        "floor_copy_ms": cuda_ms(segments_launcher(variants["copy"], *args), 100),
        # the two permutations and the sorted key, the geometry, the
        # segment written, the appearance rows read and written
        **bound(nbytes(perm1, perm2, key_sorted, args[0], args[1], color, *got)),
    }
    print(f"ribbon_segments: kernel {seg_row['ms']:.4f} ms, first version "
          f"{seg_row['first_ms']:.4f} ms; floors: coalesced {seg_row['floor_coalesced_ms']:.4f} "
          f"ms, streaming copy {seg_row['floor_copy_ms']:.4f} ms; the appearance gather alone "
          f"({n} x 4 floats by the order): index_select {seg_row['library_ms']:.4f} ms, "
          f"gather_rows {seg_row['gather_rows_ms']:.4f} ms")
    # a textured ribbon's flipbook frame (phase 21's path) at the frame's
    # 1M rows: one more 4-byte column read through the same chain
    sprite = torch.randint(0, 8, (n,), dtype=torch.int32, device=perm2.device)
    sargs = (*args, sprite)
    got_s, want_s = ribbon.ribbon_segments(*sargs), ribbon.ribbon_segments_plain(*sargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got_s, want_s) if a is not None) or (
            got_s[6] is None):
        fail("ribbon_segments with a sprite column: differs from the plain version")
    sprite_row = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ribbon.ribbon_segments(*sargs), 100),
        "plain_ms": cuda_ms(lambda: ribbon.ribbon_segments_plain(*sargs), 20),
        "library_ms": cuda_ms(lambda: sprite.index_select(0, order), 100),
        **bound(nbytes(perm1, perm2, key_sorted, args[0], args[1], color, sprite, *got_s)),
    }
    print(f"ribbon_segments with a sprite column: {n} rows, exact; kernel {sprite_row['ms']:.4f} ms "
          f"(without {seg_row['ms']:.4f}), the sprite gather alone by index_select "
          f"{sprite_row['library_ms']:.4f} ms")
    return {"ribbon_keys[ribbon]": keys_row, "ribbon_segments[ribbon]": seg_row,
            "ribbon_segments[sprite,1M]": sprite_row}


def warm_ribbons(config):
    """The ribbon frame's effect (``ribbon_bench_effect(1 << 20, 4096)`` on
    the card) stepped and rendered by ``config`` past its 4 s lifetime
    (bench.py:643): ``(fx, pool, spawner, frame)``."""
    import numpy as np

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner
    from bevy_hanabi_tpu_torch.models import ribbon_bench_effect

    asset = ribbon_bench_effect(CAPACITY, RIBBONS)
    fx = CompiledEffect(asset, device="cuda")
    pool = fx.create_pool()
    spawner = EffectSpawner(asset.spawner, rng=np.random.default_rng(0))
    frame = 0
    for _ in range((int(4.0 / DT) + K) // K + 1):
        pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame), ribbon_camera(),
                                          config)
        frame += K
    return fx, pool, spawner, frame


def ribbon_frame(kernels, variants):
    """Phase 13: the 1M / 4096-ribbon frame through step_render_chunk.
    ``variants``: the libraries of :data:`RIBBON_VARIANTS`."""
    import torch

    from bevy_hanabi_tpu_torch import ParticlePool, RasterConfig
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.ribbon import build_ribbon_segments

    cam = ribbon_camera()
    config = RasterConfig(width=512, height=512, tile_slots=1)
    t0 = time.perf_counter()
    fx, pool, spawner, frame = warm_ribbons(config)
    asset = fx.asset
    alive_before = int(pool.alive_count())
    print(f"ribbon warm-up: {frame} frames in {time.perf_counter() - t0:.2f} s, alive {alive_before}")
    reset_launches(kernels)
    times = []
    for _ in range(3):
        ins, sims = chunk_inputs(fx, spawner, frame)
        frame += K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, img, sums = fx.step_render_chunk(pool, ins, sims, cam, config)
        alive_after = int(pool.alive_count())  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    launches = read_launches(kernels)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"ribbon chunk times (s): {times}")
    print(f"ribbons 1M / {RIBBONS}: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
          f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, "
          f"checksum {float(sums[-1]):.6e}")
    print(f"launches in the timed chunks: {launches}")
    require_launches(launches, RIBBON_KERNELS, "the ribbon frame")
    if not bool(img.isfinite().all()) or not float(sums[-1]) > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail("ribbon frame is not finite, not positive or not 512x512x4")

    # the last pool again: by the kernels, and on the CPU through the plain versions
    def render(p):
        segs = build_ribbon_segments(extract_draw_data(asset, p, cam), cam)
        return raster.rasterize(segs, cam, config, alpha_mode="add"), segs

    img_k, segs = render(pool)
    t0 = time.perf_counter()
    img_p, _ = render(ParticlePool.from_numpy(*pool.to_numpy(), device="cpu"))
    s_k, s_p = float(img_k.sum()), float(img_p.sum())
    print(f"ribbon frame re-rendered: card {s_k:.6e} vs cpu plain {s_p:.6e} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    if not checksum_close(s_k, s_p):
        fail(f"ribbon frame checksum {s_k} on the card vs {s_p} on the CPU")

    results = compare_ribbon_kernels(extract_draw_data(asset, pool, cam), cam, variants)
    # the ADD payload pass on the frame's segments, as rasterize runs it
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    pb_row, projected = compare_project_bin(project_args(segs, cam, config), nt,
                                            "project_bin (ribbon)", raster.row_width("add", False))
    mode = raster.fast_mode(config, "add", segs.alive.shape[0])
    results["project_bin[ribbon]"] = pb_row
    results["bin_keys[ribbon]"] = compare_bin_keys(projected, nt, mode, "bin_keys (ribbon)")
    results["gather_window[ribbon]"], win = compare_gather_window(
        projected, nt, config.max_entries_per_tile, mode, "ribbon")
    results["tile_blend[add,ribbon]"], _ = compare_tile_blend(
        f"add ({mode!r}, ribbon segments)", *win, T, ntx, nty, config.background, "add")
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    def run(k):
        nonlocal pool, frame
        pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame, k), cam, config)
        frame += k
        int(pool.alive_count())

    profile_frames("ribbon", run)
    return results, launches


def rerender_headline(asset, pool, cam, config, label: str) -> None:
    """The pool's frame by the kernels and again on the CPU through the
    plain versions: checksums within 0.5%."""
    from bevy_hanabi_tpu_torch import ParticlePool
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    img_k = raster.rasterize(extract_draw_data(asset, pool, cam), cam, config)
    cpu_pool = ParticlePool.from_numpy(*pool.to_numpy(), device="cpu")
    img_p = raster.rasterize(extract_draw_data(asset, cpu_pool, cam), cam, config)
    s_k, s_p = float(img_k.sum()), float(img_p.sum())
    print(f"{label} frame re-rendered: card {s_k:.6e} vs cpu plain {s_p:.6e}")
    if not bool(img_k.isfinite().all()) or not checksum_close(s_k, s_p):
        fail(f"{label} frame checksum {s_k} on the card vs {s_p} on the CPU")


def companion_frames(fx, pool, spawner, frame, cam, kernels, companions=COMPANIONS, profile=True):
    """Phase 5b: the headline's companions (bench.py:510-563) on its pool:
    for each, two warm-up chunks, then three timed ``step_render_chunk``
    chunks of K frames, each ending in an alive-count readback (frames/s
    and particle-frames/s, best of three); the raster kernels' launches
    counted over the timed chunks alone; the last frame rendered again on
    the CPU; then (``profile``) the profiles of 30 headline and 30 exact
    frames. Phase 18a runs it on the antialiased headline. Returns
    ``(pool, frame, launches by companion)``."""
    import torch

    from bevy_hanabi_tpu_torch import RasterConfig

    launches = {}
    for name, binning in companions.items():
        config = RasterConfig(width=512, height=512, **binning)
        for _ in range(2):
            pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame), cam, config)
            frame += K
        alive_before = int(pool.alive_count())
        reset_launches(kernels)
        times = []
        for _ in range(3):
            ins, sims = chunk_inputs(fx, spawner, frame)
            frame += K
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool, img, sums = fx.step_render_chunk(pool, ins, sims, cam, config)
            alive_after = int(pool.alive_count())  # readback: waits for the chunk
            times.append(time.perf_counter() - t0)
        launches[name] = read_launches(kernels)
        best = min(times)
        alive_mean = 0.5 * (alive_before + alive_after)
        print(f"{name} ({binning}) chunk times (s): {times}")
        print(f"{name}: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
              f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, "
              f"checksum {float(sums.sum()):.6e}")
        print(f"launches in the {name} chunks: {launches[name]}")
        require_launches(launches[name], HEADLINE_KERNELS, f"the {name} frame")
        if not bool(img.isfinite().all()) or not float(sums.sum()) > 0.0:
            fail(f"{name} image is not finite or its checksum is not positive")
        rerender_headline(fx.asset, pool, cam, config, name)
    if not profile:
        return pool, frame, launches
    # where the time goes: the exact frame's 4M-entry sort against the headline's 1M
    for label, binning in (("headline", dict(tile_slots=1)), ("exact", COMPANIONS["exact"])):
        config = RasterConfig(width=512, height=512, **binning)

        def run(k, config=config):
            nonlocal pool, frame
            pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame, k), cam,
                                              config)
            frame += k
            int(pool.alive_count())

        profile_frames(label, run)
    return pool, frame, launches


def reference_checks():
    """Phase 12b: the JAX package's own device checks at its own config,
    ``RasterConfig(128, 128)`` (bench.py:200: ``tile_slots=0``), card
    against CPU: ``gradient_render_8k`` (bench.py:203-219) and
    ``ribbon_trails_8k_64`` (bench.py:226-250)."""
    import numpy as np

    from bevy_hanabi_tpu_torch import (
        CompiledEffect,
        EffectRenderer,
        RasterConfig,
        SimParams,
        StepInputs,
    )
    from bevy_hanabi_tpu_torch.models import gradient_effect, ribbon_order_check_effect

    cam, cfg = gate_camera(), RasterConfig(width=128, height=128)

    def gradient(device):
        g = gradient_effect(8192)
        fx = CompiledEffect(g, device=device)
        pool, _ = fx.step(fx.create_pool(), StepInputs.make(8192, 3), SimParams(delta_time=DT))
        return float(EffectRenderer(g, cfg).render(pool, cam, SimParams()).sum())

    s_g, s_c = gradient("cuda"), gradient("cpu")
    print(f"gradient_render_8k at tile_slots=0: checksum card {s_g:.6e} cpu {s_c:.6e}")
    if not math.isfinite(s_g) or not s_c > 0.0 or not checksum_close(s_g, s_c):
        fail(f"gradient_render_8k at tile_slots=0: checksum {s_g} on the card vs {s_c} on the CPU")

    def ribbons(device):
        fx = CompiledEffect(ribbon_order_check_effect(8192, 64), device=device)
        ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
        sims = [SimParams(time=i * DT, delta_time=DT) for i in range(30)]
        pool, img, _ = fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam, cfg)
        return pool.to_numpy()[1], float(img.sum())

    (alive_g, s_g), (alive_c, s_c) = ribbons("cuda"), ribbons("cpu")
    print(f"ribbon_trails_8k_64 at tile_slots=0: alive {int(alive_c.sum())}, checksum card "
          f"{s_g:.6e} cpu {s_c:.6e}")
    if not np.array_equal(alive_g, alive_c):
        fail("ribbon_trails_8k_64 at tile_slots=0: alive masks differ between the card and the CPU")
    if not math.isfinite(s_g) or not s_c > 0.0 or not checksum_close(s_g, s_c):
        fail(f"ribbon_trails_8k_64 at tile_slots=0: checksum {s_g} on the card vs {s_c} on the CPU")


def default_config_render():
    """Phase 10b: ``HanabiScene.render(camera)`` with no config (JAX's
    default ``RasterConfig``: ``tile_slots=0``) on the small mixed scene,
    90 frames in, under both pipelines, card against CPU."""
    cam = mixed_camera(128)
    card = mixed_scene("cuda", 1024, 4096, 512, 2048)
    cpu = mixed_scene("cpu", 1024, 4096, 512, 2048)
    for _ in range(90):  # the first burst's rockets die, trails spawn
        card.update(DT)
        cpu.update(DT)
    compare_pools(card, cpu, MIXED_NAMES, "default-config render")
    for pipeline in ("auto", "split"):
        img_g = card.render(cam, pipeline=pipeline)
        img_c = cpu.render(cam, pipeline=pipeline)
        s_g, s_c = float(img_g.sum()), float(img_c.sum())
        print(f"HanabiScene.render(camera) {pipeline}, no config: checksum card {s_g:.6e} "
              f"cpu {s_c:.6e}")
        if not bool(img_g.isfinite().all()) or not s_c > 0.0 or not checksum_close(s_g, s_c):
            fail(f"default-config render {pipeline}: checksum {s_g} on the card vs {s_c} on the CPU")


def force_field_chunks(fx, pool, spawner, frame: int, k: int = K, moved_at=None):
    """``k`` frames of the force field's inputs from ``frame``; from frame
    ``moved_at`` on, the attractor at :data:`FF_MOVED` (else its default)."""
    from bevy_hanabi_tpu_torch import SimParams, StepInputs

    ins, sims = [], []
    for j in range(frame, frame + k):
        props = None
        if moved_at is not None:
            props = {"attractor": FF_MOVED if j >= moved_at else (0.0, 1.0, 0.0)}
        ins.append(StepInputs.make(spawner.tick(DT), j, properties=props))
        sims.append(SimParams(time=j * DT, delta_time=DT))
    return fx.step_chunk(pool, *fx.stack_frames(ins, sims))


def force_field_gate():
    """Phase 14a: ``force_field_effect(4096)`` for 5 s (past its 4 s
    lifetime), the attractor moved at 3 s as the reference example's cursor
    moves it, on the card and on the CPU: alive masks and PCG seeds equal,
    positions within rtol 1e-2 / atol 1e-3; the lanes spawned in the last
    4 s and dead already died by the kill box."""
    import numpy as np

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner
    from bevy_hanabi_tpu_torch.models import force_field_effect

    out = {}
    for device in ("cuda", "cpu"):
        fx = CompiledEffect(force_field_effect(4096), device=device)
        spawner = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
        pool, counters = fx.create_pool(), []
        for frame in range(0, 300, 60):
            pool = force_field_chunks(fx, pool, spawner, frame, 60, moved_at=FF_MOVE_AT)
            counters.append(int(pool.counter))
        out[device] = pool.to_numpy(), counters
    (attrs_g, alive_g, seed_g, _), _ = out["cuda"]
    (attrs_c, alive_c, seed_c, _), counters = out["cpu"]
    if not np.array_equal(alive_g, alive_c):
        fail("force field gate: alive masks differ between the card and the CPU")
    if not np.array_equal(seed_g, seed_c):
        fail("force field gate: PCG seeds differ between the card and the CPU")
    for attr in ("position", "velocity"):
        a, b = attrs_g[attr][alive_c], attrs_c[attr][alive_c]
        if not np.allclose(a, b, rtol=POS_RTOL, atol=POS_ATOL):
            fail(f"force field gate: {attr} differs (max abs err {float(np.abs(a - b).max()):g})")
    early = (counters[-1] - counters[0]) - int(alive_c.sum())
    print(f"force field gate 4096, 300 frames: alive {int(alive_c.sum())}, masks and seeds "
          f"bit-equal; {counters[-1] - counters[0]} lanes spawned in the last 4 s, {early} of them "
          f"killed by the box before their lifetime")
    if early <= 0:
        fail("force field gate: no lane died by the kill box")


def force_field_full():
    """Phase 14b: ``force_field_effect(100_000)`` through ``step_chunk``
    (bench.py:568-601), warmed past its 4 s lifetime, then three timed
    chunks of K frames, each ending in an alive-count readback."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner
    from bevy_hanabi_tpu_torch.models import force_field_effect

    fx = CompiledEffect(force_field_effect(FF_CAPACITY), device="cuda")
    spawner = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
    pool, frame = fx.create_pool(), 0
    t0 = time.perf_counter()
    for _ in range((int(4.0 / DT) + K) // K + 1):
        pool = force_field_chunks(fx, pool, spawner, frame)
        frame += K
    alive_before = int(pool.alive_count())
    print(f"force field warm-up: {frame} frames in {time.perf_counter() - t0:.2f} s, "
          f"alive {alive_before}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = force_field_chunks(fx, pool, spawner, frame)
        alive_after = int(pool.alive_count())  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
        frame += K
    best = min(times)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"force field chunk times (s): {times}")
    print(f"force field {FF_CAPACITY}: {K} steps in {best:.4f} s: {K / best:.2f} steps/s, "
          f"{alive_mean * K / best:.4e} particle-steps/s, alive {alive_after} (the step is eager "
          f"torch: this path runs no hand-written kernel)")
    if not 0 < alive_after <= FF_CAPACITY:
        fail(f"force field: {alive_after} alive lanes")


def mesh_asset(capacity: int, lit: bool = False):
    """The textured mesh gate's composition (bench.py:295-327): an
    icosphere (80 triangles) per particle, the circle texture through
    ParticleTextureModifier, lit per fragment where ``lit``."""
    from bevy_hanabi_tpu_torch import ParticleTextureModifier
    from bevy_hanabi_tpu_torch.models import LambertianLightingModifier, textured_mesh_check_effect
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    asset = textured_mesh_check_effect(capacity).render(ParticleTextureModifier(0))
    if lit:
        asset = asset.render(LambertianLightingModifier((0.577, 0.577, 0.577), 0.7))
    return asset.with_mesh(ParticleMesh.icosphere(radius=0.4, subdivisions=1))


def mesh_camera(size: int):
    """The gate's camera (bench.py:195-199) at ``size`` squared."""
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    return CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0),
                        (size, size))


def mesh_gate():
    """Phase 15a: the JAX package's ``textured_mesh_2k`` (bench.py:295-327),
    ``HanabiScene(seed=5)``, three updates and a 128x128 render at
    ``RasterConfig(128, 128)``, card against CPU."""
    import numpy as np

    from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
    from bevy_hanabi_tpu_torch.models import make_circle_texture

    out = {}
    for device in ("cuda", "cpu"):
        scene = HanabiScene(seed=5, device=device)
        scene.add(mesh_asset(2048), "mesh", textures=[make_circle_texture(32)])
        for _ in range(3):
            scene.update(DT)
        img = scene.render(mesh_camera(128), RasterConfig(width=128, height=128))
        out[device] = scene["mesh"].pool.to_numpy()[1], img.cpu()
    (alive_g, img_g), (alive_c, img_c) = out["cuda"], out["cpu"]
    s_g, s_c = float(img_g.sum()), float(img_c.sum())
    print(f"textured_mesh_2k: alive {int(alive_c.sum())}, checksum card {s_g:.6e} cpu {s_c:.6e}")
    if not np.array_equal(alive_g, alive_c):
        fail("textured_mesh_2k: alive masks differ between the card and the CPU")
    if not bool(img_g.isfinite().all()) or not s_c > 0.0 or not checksum_close(s_g, s_c):
        fail(f"textured_mesh_2k: checksum {s_g} on the card vs {s_c} on the CPU")


def example_run(name: str, device, config=None, frames: int = 30):
    """One of :data:`EXAMPLES`, ``frames`` frames of :data:`EXAMPLE_SPAWN`
    spawns through ``step_render_chunk`` at 512x512 on ``device`` (at
    ``config``, else ``RasterConfig(512, 512)``): ``(fx, pool, image,
    checksums, camera, textures)``."""
    from bevy_hanabi_tpu_torch import CompiledEffect, RasterConfig, SimParams, StepInputs
    from bevy_hanabi_tpu_torch.models import examples, make_anim_sprite_sheet
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    cam = CameraParams(look_at((0, 0, 3), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (512, 512))
    textures = [make_anim_sprite_sheet(8, 32)] if name == "example_circle" else []
    fx = CompiledEffect(getattr(examples, name)(), device=device)
    ins = [StepInputs.make(EXAMPLE_SPAWN, 7 * i + 1) for i in range(frames)]
    sims = [SimParams(time=i * DT, delta_time=DT) for i in range(frames)]
    pool, img, sums = fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam,
                                           config or RasterConfig(width=512, height=512), textures)
    return fx, pool, img, sums.cpu(), cam, textures


def example_checks(kernels, config=None, frames: int = 30) -> dict:
    """Phase 15b: ``example_puffs`` (Lambert on mesh normals),
    ``example_circle`` (the flipbook) and ``example_2d`` (the squircle),
    each ``frames`` frames of :data:`EXAMPLE_SPAWN` spawns through
    ``step_render_chunk`` at 512x512 (at ``config``: phase 18c runs
    ``examples/run_all.py``'s antialiased one), card against CPU: masks and
    seeds equal, every frame's checksum within 0.5%. Returns, by example,
    the card's last pool, its camera, textures and launches."""
    import numpy as np

    out = {}
    for name in EXAMPLES:
        reset_launches(kernels)
        t0 = time.perf_counter()
        fx, pool_g, img_g, sums_g, cam, textures = example_run(name, "cuda", config, frames)
        launches = read_launches(kernels)
        t1 = time.perf_counter()
        _, pool_c, _, sums_c, _, _ = example_run(name, "cpu", config, frames)
        t2 = time.perf_counter()
        (_, alive_g, seed_g, _), (_, alive_c, seed_c, _) = pool_g.to_numpy(), pool_c.to_numpy()
        print(f"{name}{' (antialiased)' if config is not None else ''}: {frames} frames at 512x512, "
              f"alive {int(alive_c.sum())}, last checksum card "
              f"{float(sums_g[-1]):.6e} cpu {float(sums_c[-1]):.6e} (card {t1 - t0:.1f} s, cpu "
              f"{t2 - t1:.1f} s); launches {launches}")
        if not np.array_equal(alive_g, alive_c) or not np.array_equal(seed_g, seed_c):
            fail(f"{name}: alive masks or PCG seeds differ between the card and the CPU")
        if not bool(img_g.isfinite().all()) or not float(sums_c[-1]) > 0.0:
            fail(f"{name}: the image is not finite or its checksum is not positive")
        for k, (a, b) in enumerate(zip(sums_g.tolist(), sums_c.tolist())):
            if not checksum_close(a, b):
                fail(f"{name} frame {k}: checksum {a} on the card vs {b} on the CPU")
        out[name] = (fx, pool_g, cam, textures, launches)
    return out


def compare_mesh_expand(draw, mesh, label: str) -> dict:
    """``mesh_expand`` against its plain version on a frame's draw: every
    output equal (NaN where it is NaN), both timed. The bound counts the
    particles' inputs, the mesh's tables and every output once."""
    import torch

    from bevy_hanabi_tpu_torch.render import mesh as mesh_mod

    tables = mesh_mod.mesh_tables(mesh, draw.position.device)
    tri = mesh.num_triangles > 0
    kw = dict(want_uv=mesh.uvs is not None and tri,
              want_nrm=draw.lighting is not None and mesh.normals is not None and tri,
              want_vcol=mesh.colors is not None and tri)
    args = (draw.position.contiguous(), draw.axis_x.contiguous(), draw.axis_y.contiguous(),
            draw.color.contiguous(), draw.alive, tables)
    got = mesh_mod.mesh_expand(*args, **kw)
    want = mesh_mod.mesh_expand_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for key, w in want.items():
        g = got[key]
        if (g is None) != (w is None) or (w is not None and not torch_equal_nan(g.float(), w.float())):
            fail(f"mesh_expand ({label}): {key} differs from the plain version")
        if w is not None:
            err = max(err, float((g.float() - w.float()).abs().nan_to_num(0.0).max()))
    entries = got["position"].shape[0]
    out_bytes = nbytes(*(t for t in got.values() if t is not None))
    in_bytes = nbytes(*args[:5], *(t for t in tables[2:] if t is not None))
    result = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: mesh_mod.mesh_expand(*args, **kw), 50),
        "plain_ms": cuda_ms(lambda: mesh_mod.mesh_expand_plain(*args, **kw), 5),
        "library_ms": None,
        **bound(in_bytes + out_bytes, (MESH_LIT_OPS if kw["want_nrm"] else MESH_OPS) * entries),
    }
    print(f"mesh_expand ({label}): {draw.position.shape[0]} particles x {tables.geom.shape[0]} "
          f"elements = {entries} entries, {out_bytes / entries:.0f} B an entry out, max abs err "
          f"{err:g}; "
          f"kernel {result['ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    return result


def warp_iterations(window, has, T: int, ntx: int, ap, label: str) -> dict:
    """The (warp, entry) iterations of ``tile_blend``'s blend loop on a
    window under the triangle-tight bound and under the quad bound of the
    first appearance kernel (``raster.warp_entries_plain``), printed beside
    the covered pairs."""
    from bevy_hanabi_tpu_torch.render import raster

    tri_col = ap.offset("tri")
    out = {
        "warp_iterations": int(raster.warp_entries_plain(window, has, T, ntx, tri_col).sum()),
        "warp_iterations_quad_bound": int(raster.warp_entries_plain(
            window, has, T, ntx, tri_col, triangle_bound=False).sum()),
    }
    pairs = covered_pairs(window, has, T, ntx, tri_col)
    print(f"tile_blend ({label}): {out['warp_iterations']} warp-entry iterations under the "
          f"triangle bound, {out['warp_iterations_quad_bound']} under the quad bound; "
          f"{pairs} covered pairs")
    return out


def warm_mesh(lit: bool, antialias: bool = False):
    """The textured mesh frame's effect (:func:`mesh_asset` at
    :data:`MESH_CAPACITY`) on the card, warmed three chunks of K frames
    through ``step_render_chunk`` at ``RasterConfig(512, 512, antialias=)``,
    past its 5 s lifetime: ``(fx, pool, spawner, frame, camera, config,
    textures)``."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, RasterConfig
    from bevy_hanabi_tpu_torch.models import make_circle_texture

    cam, config = mesh_camera(512), RasterConfig(width=512, height=512, antialias=antialias)
    fx = CompiledEffect(mesh_asset(MESH_CAPACITY, lit), device="cuda")
    textures = [torch.from_numpy(make_circle_texture(32)).cuda()]
    spawner = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
    pool, frame = fx.create_pool(), 0
    for _ in range(3):
        pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame), cam, config,
                                          textures)
        frame += K
    return fx, pool, spawner, frame, cam, config, textures


def appearance_window(asset, pool, cam, config, textures, m=None):
    """``(window, has, appearance)`` of a textured or mesh draw's BLEND pass
    as ``rasterize`` builds it on the ordered path, through the kernels
    (``mesh_expand``, ``project_bin``, ``bin_keys``, ``gather_window``), with
    ``m`` slots a tile (the config's ``max_entries_per_tile`` by default)."""
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw

    draw = extract_draw_data(asset, pool, cam, textures=textures)
    if asset.mesh is not None:
        draw = expand_mesh_draw(draw, asset.mesh)
    ap, columns = raster.draw_appearance(draw, raster.ROW_QUAD)
    tile, depth, rows, rng = raster.project_bin(
        *project_args(draw, cam, config), row=raster.ROW_QUAD, tile_slots=config.tile_slots,
        tile_span=config.tile_span, appearance=columns)
    sorted_ = raster.sort_tiles(tile, depth, config.num_tiles, None, rng)
    window, has = gather.gather_window(rows, *sorted_, m or config.max_entries_per_tile, False)
    return window, has, ap


def mesh_frame(kernels, lit: bool, first=None, antialias=False):
    """Phases 15c-d: the textured mesh frame at full width,
    ``textured_mesh_check_effect(16384)`` with the icosphere and the
    circle texture (lit per fragment where ``lit``) through
    ``step_render_chunk`` at ``RasterConfig(512, 512)`` (``tile_slots=0``,
    span 2), BLEND: warmed three chunks (past its 5 s lifetime), then three
    timed chunks of K frames (frames/s); every kernel of the path must
    launch; the last frame rendered again on the CPU (checksums within
    0.5%); each kernel held against its plain version at the frame's
    shapes and timed; then a profile of 30 frames. Phase 18b runs it
    ``antialias``ed: the same up to the re-render, then ``tile_blend``'s
    ``kAA`` appearance variant alone on the frame's window."""
    import torch

    from bevy_hanabi_tpu_torch import ParticlePool
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw

    tag = ("mesh,lit" if lit else "mesh") + (",aa" if antialias else "")
    t0 = time.perf_counter()
    fx, pool, spawner, frame, cam, config, textures = warm_mesh(lit, antialias)
    asset, mesh = fx.asset, fx.asset.mesh
    alive_before = int(pool.alive_count())
    print(f"{tag} warm-up: {frame} frames in {time.perf_counter() - t0:.2f} s, alive {alive_before}")
    reset_launches(kernels)
    times = []
    for _ in range(3):
        ins, sims = chunk_inputs(fx, spawner, frame)
        frame += K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, img, sums = fx.step_render_chunk(pool, ins, sims, cam, config, textures)
        alive_after = int(pool.alive_count())  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    launches = read_launches(kernels)
    alive_mean = 0.5 * (alive_before + alive_after)
    k = mesh.num_quads + mesh.num_triangles
    print(f"{tag} chunk times (s): {times}")
    print(f"{tag} frame {MESH_CAPACITY} x {k} triangles: {K} frames in {best:.4f} s: "
          f"{K / best:.2f} frames/s, {alive_mean * K / best:.4e} particle-frames/s, "
          f"{alive_mean * k * K / best:.4e} triangle-frames/s, alive {alive_after} "
          f"({alive_after * k} triangle entries alive of {MESH_CAPACITY * k}), "
          f"checksum {float(sums[-1]):.6e}")
    print(f"launches in the timed chunks: {launches}")
    require_launches(launches, MESH_KERNELS + (("tile_blend[blend,antialias]",) if antialias else ()),
                     f"the {tag} frame")
    if not bool(img.isfinite().all()) or not float(sums[-1]) > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail(f"{tag} frame is not finite, not positive or not 512x512x4")

    # the last pool again: by the kernels, and on the CPU through the plain versions
    def render(p, texs):
        draw = extract_draw_data(asset, p, cam, textures=texs)
        return raster.rasterize(expand_mesh_draw(draw, mesh), cam, config, textures=texs), draw

    img_k, draw = render(pool, textures)
    t0 = time.perf_counter()
    img_p, _ = render(ParticlePool.from_numpy(*pool.to_numpy(), device="cpu"),
                      [t.cpu() for t in textures])
    s_k, s_p = float(img_k.sum()), float(img_p.sum())
    print(f"{tag} frame re-rendered: card {s_k:.6e} vs cpu plain {s_p:.6e} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    if not checksum_close(s_k, s_p):
        fail(f"{tag} frame checksum {s_k} on the card vs {s_p} on the CPU")

    # every kernel of the path at the frame's shapes
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    M = config.max_entries_per_tile
    expanded = expand_mesh_draw(draw, mesh)
    ap, columns = raster.draw_appearance(expanded, raster.row_width("blend", False))
    if antialias:  # the other kernels are the plain frame's, at the same shapes
        win = appearance_window(asset, pool, cam, config, textures)[:2]
        row, _ = compare_tile_blend(f"blend ({tag}, {ap.row}-float rows)", *win, T, ntx, nty,
                                    config.background, "blend", **REDESIGNED_KW,
                                    appearance=ap, textures=textures, antialias=True)
        return {f"tile_blend[{tag}]": row}, launches
    results = {f"mesh_expand[{tag}]": compare_mesh_expand(draw, mesh, tag)}
    results[f"project_bin[{tag}]"], projected = compare_project_bin(
        project_args(expanded, cam, config), nt, f"project_bin ({tag}, triangles)",
        raster.row_width("blend", False), config=config, appearance=columns)
    results[f"bin_keys[{tag}]"] = compare_bin_keys(projected, nt, None, f"bin_keys ({tag})")
    results[f"gather_window[{tag}]"], win = compare_gather_window(projected, nt, M, None, tag)
    for mode in ("blend",) if lit else ("blend", "premultiply", "multiply"):
        name = f"tile_blend[{tag}]" if mode == "blend" else f"tile_blend[{mode},{tag}]"
        results[name], _ = compare_tile_blend(f"{mode} ({tag}, {ap.row}-float rows)", *win, T, ntx,
                                              nty, config.background, mode, first=first,
                                              appearance=ap, textures=textures)
    results[f"tile_blend[{tag}]"].update(warp_iterations(*win, T, ntx, ap, tag))
    if lit:
        # a window past the earlier kernel's 48 KB of staged floats (M * F = 13 312)
        wide = f"mesh,lit,M={MESH_M_WIDE}"
        results[f"gather_window[{wide}]"], _ = compare_gather_window(projected, nt, MESH_M_WIDE,
                                                                     None, wide)
    else:
        # the same frame's blend on twice the entries a tile: bench.py's wider M
        wide = f"mesh,M={MIXED_M_WIDE}"
        results[f"gather_window[{wide}]"], win = compare_gather_window(projected, nt, MIXED_M_WIDE,
                                                                       None, wide)
        results[f"tile_blend[{wide}]"], _ = compare_tile_blend(
            f"blend ({wide}, {ap.row}-float rows)", *win, T, ntx, nty, config.background, "blend",
            first=first, appearance=ap, textures=textures)
        results[f"tile_blend[{wide}]"].update(warp_iterations(*win, T, ntx, ap, wide))
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    def run(k):
        nonlocal pool, frame
        pool, _, _ = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame, k), cam, config,
                                          textures)
        frame += k
        int(pool.alive_count())

    profile_frames(tag, run)
    return results, launches


def example_kernels(example_runs, first=None, config=None) -> dict:
    """Phase 15e: ``tile_blend`` on the last frame of ``example_circle``
    (the flipbook, 11-float rows) and ``example_2d`` (the squircle), each
    against its plain version, timed, and the first appearance kernel
    (``first``) beside it; with an antialiased ``config`` (phase 18c) the
    ``kAA`` variant alone (rows ``[flipbook,aa]``, ``[round,aa]``)."""
    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    aa = config is not None and config.antialias
    config = config or RasterConfig(width=512, height=512)
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    results = {}
    for name, label in (("example_circle", "flipbook"), ("example_2d", "round")):
        fx, pool, cam, textures, _ = example_runs[name]
        texs = [raster.texture_tensor(t, "cuda") for t in textures]
        draw = extract_draw_data(fx.asset, pool, cam, textures=texs)
        ap, columns = raster.draw_appearance(draw, raster.ROW_QUAD)
        projected = raster.project_bin(*project_args(draw, cam, config), row=raster.ROW_QUAD,
                                       tile_slots=config.tile_slots, tile_span=config.tile_span,
                                       appearance=columns)
        gathered, win = compare_gather_window(projected, nt, config.max_entries_per_tile, None,
                                              label)
        if aa:
            results[f"tile_blend[{label},aa]"], _ = compare_tile_blend(
                f"blend ({label}, {ap.row}-float rows, antialiased)", *win, T, ntx, nty,
                config.background, "blend", **REDESIGNED_KW, appearance=ap,
                textures=texs, antialias=True)
            continue
        results[f"gather_window[{label}]"] = gathered
        results[f"tile_blend[{label}]"], _ = compare_tile_blend(
            f"blend ({label}, {ap.row}-float rows)", *win, T, ntx, nty, config.background, "blend",
            first=first, appearance=ap, textures=texs)
    return results


def textured_quad_run(mesh: str, alpha_mode: str, device):
    """A textured quad of :data:`TEXTURED_QUADS` (the check effect with the
    circle texture, a billboard or ``ParticleMesh.cross()``), 20 frames of 64
    spawns through ``step_render_chunk`` at 256x256 on ``device``: ``(fx,
    pool, checksums, camera, config, textures)``."""
    from bevy_hanabi_tpu_torch import (AlphaMode, CompiledEffect, ParticleTextureModifier,
                                       RasterConfig, SimParams, StepInputs)
    from bevy_hanabi_tpu_torch.models import make_circle_texture, textured_mesh_check_effect
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    cam = mesh_camera(256)
    config = RasterConfig(width=256, height=256, background=(0.9, 0.8, 0.7, 0.5))
    textures = [make_circle_texture(32)]
    asset = (textured_mesh_check_effect(2048).render(ParticleTextureModifier(0))
             .with_alpha_mode(getattr(AlphaMode, alpha_mode)))
    if mesh == "cross":
        asset = asset.with_mesh(ParticleMesh.cross())
    fx = CompiledEffect(asset, device=device)
    ins = [StepInputs.make(64, 7 * i + 1) for i in range(20)]
    sims = [SimParams(time=i * DT, delta_time=DT) for i in range(20)]
    pool, _, sums = fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam, config,
                                         textures)
    return fx, pool, sums.cpu(), cam, config, textures


def textured_quad_checks(kernels, first=None):
    """Phase 15f: the textured quads of :data:`TEXTURED_QUADS`, 20 frames
    each through ``step_render_chunk`` at 256x256, card against CPU (masks
    equal, every checksum within 0.5%); the appearance variant of the
    effect's equation must launch. Then ``tile_blend`` on the billboard's
    last BLEND frame (10-float rows) against its plain version, timed, and
    the first appearance kernel (``first``) beside it. Returns that row and
    the billboard's BLEND launches."""
    import numpy as np

    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    blend_run = None
    for mesh, alpha_mode in TEXTURED_QUADS:
        label = f"textured {mesh} ({alpha_mode})"
        reset_launches(kernels)
        fx, pool_g, sums_g, cam, config, textures = textured_quad_run(mesh, alpha_mode, "cuda")
        launches = read_launches(kernels)
        _, pool_c, sums_c, _, _, _ = textured_quad_run(mesh, alpha_mode, "cpu")
        mode = fx.asset.alpha_mode.kind
        print(f"{label}: 20 frames at 256x256, alive {int(pool_c.alive_count())}, last checksum "
              f"card {float(sums_g[-1]):.6e} cpu {float(sums_c[-1]):.6e}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        require_launches(launches, (f"tile_blend[{mode},appearance]",), label)
        if not np.array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1]):
            fail(f"{label}: alive masks differ between the card and the CPU")
        if not float(sums_c[-1]) > 0.0:
            fail(f"{label}: the checksum is not positive")
        for k, (a, b) in enumerate(zip(sums_g.tolist(), sums_c.tolist())):
            if not checksum_close(a, b):
                fail(f"{label} frame {k}: checksum {a} on the card vs {b} on the CPU")
        if (mesh, alpha_mode) == ("billboard", "BLEND"):
            blend_run = fx, pool_g, launches, cam, config, textures

    fx, pool, launches, cam, config, textures = blend_run
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    texs = [raster.texture_tensor(t, "cuda") for t in textures]
    draw = extract_draw_data(fx.asset, pool, cam, textures=texs)
    ap, columns = raster.draw_appearance(draw, raster.ROW_QUAD)
    projected = raster.project_bin(*project_args(draw, cam, config), row=raster.ROW_QUAD,
                                   tile_slots=config.tile_slots, tile_span=config.tile_span,
                                   appearance=columns)
    window_row, win = compare_gather_window(projected, nt, config.max_entries_per_tile, None,
                                            "textured quads")
    result, _ = compare_tile_blend(f"blend (textured quads, {ap.row}-float rows)", *win, T, ntx,
                                   nty, config.background, "blend", first=first, appearance=ap,
                                   textures=texs)
    return ({"tile_blend[textured quads]": result, "gather_window[textured quads]": window_row},
            launches)



# ---- phases 16-17: the painter's atlas and mesh merge, antialiasing ----------


def phase_asset(name, pos, mode, color, sprite=None):
    """A 4-particle effect at one point (the JAX package's
    tests/test_scene.py:1135-1154), a flipbook frame where ``sprite``."""
    from bevy_hanabi_tpu_torch import AlphaMode, EffectAsset, ExprWriter, SpawnerSettings
    from bevy_hanabi_tpu_torch import attributes as A
    from bevy_hanabi_tpu_torch.modifiers import SetAttributeModifier, SetSizeModifier

    w = ExprWriter()
    a = (EffectAsset(name, 4, SpawnerSettings.once(1.0), w.finish())
         .init(SetAttributeModifier(A.POSITION, w.lit(pos).expr()))
         .init(SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr())))
    if sprite is None:
        a = a.init(SetAttributeModifier(A.HDR_COLOR, w.lit(color).expr()))
    else:
        a = a.init(SetAttributeModifier(A.SPRITE_INDEX, w.lit(sprite, None).expr()))
    return a.render(SetSizeModifier((0.5, 0.5, 0.5))).with_alpha_mode(getattr(AlphaMode,
                                                                               mode.upper()))


def painter_textures() -> dict:
    """The compositions' textures (the JAX package's tests/test_scene.py)."""
    import numpy as np

    ch = np.indices((8, 8)).sum(0) % 2
    yy, xx = np.mgrid[0:6, 0:6]
    fade = np.clip(1.0 - np.hypot(xx - 2.5, yy - 2.5) / 3.0, 0.0, 1.0)
    ramp = np.zeros((8, 8, 4), np.float32)
    u = np.linspace(0.1, 1.0, 8, dtype=np.float32)
    ramp[..., 0], ramp[..., 1], ramp[..., 3] = u[None, :], u[:, None], 1.0
    ramp[0, 0] = 0.0
    tint = np.ones((4, 4, 4), np.float32)
    tint[..., 0], tint[..., 2] = 0.2, 0.9
    sheet = np.zeros((8, 8, 4), np.float32)
    sheet[:4, :4], sheet[:4, 4:] = (1, 0, 0, 1), (0, 1, 0, 1)
    sheet[4:, :4], sheet[4:, 4:] = (0, 0, 1, 1), (1, 1, 0, 1)
    return {
        "checker": np.stack([ch, 1 - ch, np.zeros_like(ch), np.ones_like(ch)], -1).astype(np.float32),
        "fade": np.stack([fade, fade, fade, np.ones_like(fade)], -1).astype(np.float32),
        "ramp": ramp, "tint": tint, "sheet": sheet, "flat": np.full((4, 4, 4), 0.6, np.float32),
    }


def painter_composition(name: str, tex: dict) -> list:
    """One of :data:`PAINTER_COMPOSITIONS` as ``[(asset, name, textures)]``:
    the JAX package's painter tests (tests/test_scene.py:1859-2315)."""
    from bevy_hanabi_tpu_torch import (FlipbookModifier, ImageSampleMapping,
                                       ParticleTextureModifier)
    from bevy_hanabi_tpu_torch.models import LambertianLightingModifier
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    M = ImageSampleMapping
    blend_quad = phase_asset("bl", (0.6, 0.6, 0.5), "blend", (0.9, 0.1, 0.1, 0.5))
    if name in ("multilayer", "chunk_two_layer"):
        chunk = name == "chunk_two_layer"
        two = phase_asset("two", (-0.3 if chunk else -0.4, 0.0, -0.5), "blend", (1, 1, 1, 0.9))
        two = two.render(ParticleTextureModifier(0, M.MODULATE)).render(
            ParticleTextureModifier(1, M.MODULATE_OPACITY_FROM_R))
        plain = phase_asset("plain", (0.3, 0.0, 0.5) if chunk else (0.0, 0.5, 0.0), "add",
                            (0.3, 0.3, 0.1, 1.0))
        if chunk:
            return [(two, "two", [tex["checker"], tex["flat"]]), (plain, "plain", [])]
        one = phase_asset("one", (0.4, 0.0, 0.5), "blend", (1, 1, 1, 0.6)).render(
            ParticleTextureModifier(0, M.MODULATE_RGB))
        return [(two, "two", [tex["checker"], tex["fade"]]), (one, "one", [tex["checker"]]),
                (plain, "plain", [])]
    if name == "meshes_and_quads":
        tri = ParticleMesh(vertices=[[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.6, 0.0]],
                           indices=[[0, 1, 2]], colors=[[1, 1, 1, 1]] * 3)
        return [(phase_asset("tri", (0.0, 0.0, -0.5), "opaque", (0.2, 0.3, 0.9, 1.0)).with_mesh(tri),
                 "tri", []), (blend_quad, "bl", [])]
    if name == "uvless_mesh":
        verts = [[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.6, 0.0]]
        out = []
        for label, pos, uvs in (("nu", (-0.4, 0.0, -0.5), None),
                                ("wu", (0.4, 0.0, 0.5), [[0.0, 1.0], [1.0, 1.0], [0.5, 0.0]])):
            mesh = ParticleMesh(vertices=verts, indices=[[0, 1, 2]], uvs=uvs)
            a = phase_asset(label, pos, "blend", (1.0, 1.0, 1.0, 0.8)).with_mesh(mesh)
            out.append((a.render(ParticleTextureModifier(0)), label, [tex["ramp"]]))
        return out
    if name == "lit_mesh":
        lit = phase_asset("ico", (0.0, 0.0, -0.5), "opaque", (0.8, 0.8, 0.8, 1.0)).with_mesh(
            ParticleMesh.icosphere(0.5, subdivisions=1))
        return [(lit.render(LambertianLightingModifier((1.0, 0.0, 0.0), 0.2)), "ico", []),
                (blend_quad, "bl", [])]
    if name == "two_lamberts":
        out = []
        for label, pos, ldir in (("a", (-0.4, 0.0, -0.5), (1.0, 0.0, 0.0)),
                                 ("b", (0.4, 0.0, -0.5), (0.0, 1.0, 0.0))):
            a = phase_asset(label, pos, "opaque", (0.8, 0.8, 0.8, 1.0)).with_mesh(
                ParticleMesh.icosphere(0.4, subdivisions=0))
            out.append((a.render(LambertianLightingModifier(ldir, 0.2)), label, []))
        return out + [(phase_asset("bl", (0.0, 0.5, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]
    if name == "textured":
        t1 = phase_asset("t1", (-0.4, 0.0, -0.5), "blend", (1, 1, 1, 0.8)).render(
            ParticleTextureModifier(0, M.MODULATE))
        t2 = phase_asset("t2", (0.4, 0.0, 0.5), "blend", (1, 1, 1, 0.6)).render(
            ParticleTextureModifier(0, M.MODULATE_RGB))
        return [(t1, "t1", [tex["checker"]]), (t2, "t2", [tex["tint"]]),
                (phase_asset("plain", (0.0, 0.5, 0.0), "add", (0.3, 0.3, 0.1, 1.0)), "plain", [])]
    # flipbook: a 2x2 sheet at frame 2 beside a blend quad
    flip = phase_asset("flip", (-0.4, 0.0, -0.5), "blend", None, sprite=2).render(
        FlipbookModifier((2, 2))).render(ParticleTextureModifier(0, M.MODULATE))
    return [(flip, "flip", [tex["sheet"]]),
            (phase_asset("bl", (0.5, 0.5, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]


# the compositions and the JAX package's painter-against-split tolerance of each
PAINTER_COMPOSITIONS = {"multilayer": 1e-6, "meshes_and_quads": 1e-6, "uvless_mesh": 1e-5,
                        "lit_mesh": 1e-6, "two_lamberts": 1e-6, "textured": 1e-6,
                        "flipbook": 1e-6, "chunk_two_layer": 1e-5}


def painter_atlas_gate(kernels):
    """Phase 16: the JAX package's painter compositions (textured, flipbook,
    meshes, UV-less, lit and two Lambert setups) on the card and on the
    CPU at 64x64: each image card against CPU exactly where the JAX
    package's own painter test is exact (1e-6), else within 0.5% of the
    checksum, and painter against split on the card within that test's
    tolerance; then update_render_chunk(4) of the two-layer painter against
    its per-frame render on the card and against the CPU's chunk."""
    import dataclasses

    import torch

    from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, orthographic

    cam = CameraParams(look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                       orthographic(-1, 1, -1, 1, 0.1, 10.0), (64, 64))
    cfg = RasterConfig(64, 64, tile_size=16)
    tex = painter_textures()

    def build(name, device, seed=0):
        s = HanabiScene(seed=seed, device=device)
        for asset, label, texs in painter_composition(name, tex):
            s.add(asset, label, textures=texs)
        s.update(DT)
        return s

    reset_launches(kernels)
    for name, tol in PAINTER_COMPOSITIONS.items():
        if name == "chunk_two_layer":
            continue
        card, cpu = build(name, "cuda"), build(name, "cpu")
        plan = card._scene_render_plan(card.effects(), cam, "painter")
        img_g = card.render(cam, cfg, background=(0, 0, 0, 0), pipeline="painter").cpu()
        img_s = card.render(cam, cfg, background=(0, 0, 0, 0), pipeline="split").cpu()
        img_c = cpu.render(cam, cfg, background=(0, 0, 0, 0), pipeline="painter")
        err = float((img_g - img_c).abs().max())
        split_err = float((img_g - img_s).abs().max())
        s_g, s_c = float(img_g.sum()), float(img_c.sum())
        print(f"painter atlas gate {name}: plan {plan[1][0][0]}, card vs cpu max abs err {err:g} "
              f"(checksums {s_g:.6e} / {s_c:.6e}), painter vs split on the card {split_err:g}")
        if plan[1][0][0] != "painter" or not s_c > 0.0:
            fail(f"painter atlas gate {name}: no painter plan, or an empty image")
        if (err != 0.0 if tol == 1e-6 else not checksum_close(s_g, s_c)) or split_err > tol:
            fail(f"painter atlas gate {name}: card vs cpu {err:g}, painter vs split {split_err:g}")
    # the fused chunk: 4 frames against the per-frame render, card and CPU
    chunk_cfg = dataclasses.replace(cfg)
    sums = {}
    for device in ("cuda", "cpu"):
        a, b = build("chunk_two_layer", device, 11), build("chunk_two_layer", device, 11)
        img, sums[device] = a.update_render_chunk(4, DT, cam, chunk_cfg)
        for _ in range(4):
            b.update(DT)
        err = float((img - b.render(cam, chunk_cfg)).abs().max())
        if err > PAINTER_COMPOSITIONS["chunk_two_layer"] or not float(img[..., :3].max()) > 0.05:
            fail(f"painter atlas gate chunk ({device}): chunk vs frames {err:g}")
    for k, (x, y) in enumerate(zip(sums["cuda"].cpu().tolist(), sums["cpu"].tolist())):
        if not checksum_close(x, y):
            fail(f"painter atlas gate chunk frame {k}: checksum {x} on the card vs {y} on the CPU")
    launches = read_launches(kernels)
    print(f"painter atlas gate: update_render_chunk(4) card {sums['cuda'].cpu().tolist()} cpu "
          f"{sums['cpu'].tolist()}; launches {launches}")
    require_launches(launches, ("tile_blend[scene,appearance]",), "the painter atlas gate")


# the painter frame's two mesh effects: textured icospheres of
# textured_mesh_check_effect(16384), each lit by its own Lambert setup (so the
# merge carries per-entry light columns), at these places in the mixed view:
# 14 units before the camera, in front of the gradient's cloud (radius ~11),
# so that their triangles are among each tile's nearest M entries
PAINTER_MESHES = ((((0.577, 0.577, 0.577), 0.7), (-4.0, 2.0, 12.0)),
                  (((0.0, 1.0, 0.0), 0.2), (4.0, -2.0, 12.0)))
PAINTER_NAMES = MIXED_NAMES + ("mesh0", "mesh1")
# every kernel of the painter frame
PAINTER_KERNELS = ("gather_rows", "gather_window", "project_bin", "bin_keys", "mesh_expand",
                   "tile_blend[scene,appearance]", "event_compact")


def painter_scene(device, circle):
    """The mixed scene of bench.py:724-728 at full size beside the two lit
    textured mesh effects of :data:`PAINTER_MESHES` (one texture object
    ``circle``, so one atlas layer)."""
    import numpy as np

    from bevy_hanabi_tpu_torch import ParticleTextureModifier
    from bevy_hanabi_tpu_torch.models import LambertianLightingModifier, textured_mesh_check_effect
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    scene = mixed_scene(device, 65536, 1 << 19, 65536, 262144)
    for k, (light, at) in enumerate(PAINTER_MESHES):
        asset = (textured_mesh_check_effect(MESH_CAPACITY).render(ParticleTextureModifier(0))
                 .render(LambertianLightingModifier(*light))
                 .with_mesh(ParticleMesh.icosphere(radius=0.4, subdivisions=1)))
        tf = np.eye(3, 4, dtype=np.float32)
        tf[:, 3] = at
        scene.add(asset, f"mesh{k}", transform=tf, textures=[circle])
    return scene


def painter_frame_draw(scene, cam):
    """The painter pass's draw of the scene's current frame as
    ``HanabiScene._render_painter`` builds it (meshes expanded, textures
    shared by object), each effect's entry count, and its extra columns."""
    import torch

    from bevy_hanabi_tpu_torch.render.extract import concat_painter_draws, extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw

    insts = [scene[n] for n in PAINTER_NAMES]
    shared = {}
    texs = [tuple(shared.setdefault(id(s), t) for s, t in zip(i.texture_sources, i.textures))
            for i in insts]
    sim = scene.clock.sim_params()
    draws = []
    for inst, ts in zip(insts, texs):
        d = extract_draw_data(inst.asset, inst.pool, cam, sim=sim,
                              properties=inst.properties.as_dict(), textures=list(ts),
                              transform=inst.transform)
        draws.append(expand_mesh_draw(d, inst.asset.mesh) if inst.asset.mesh is not None else d)
    flat = concat_painter_draws(draws, [i.asset.alpha_mode.kind for i in insts],
                                textures_per_draw=texs)
    extra = torch.stack([flat.alpha_cutoff, flat.mode_id.to(torch.float32)], dim=1)
    return flat, [d.alive.shape[0] for d in draws], extra


def painter_frame(kernels):
    """Phase 17: the full mixed scene (917 504 lanes) beside two lit textured
    icosphere effects of 16 384 particles (~2.6M triangle entries) through
    update_render_chunk under "auto" (the painter pass) at 512x512,
    tile_slots=1, M = 64: frames/s (best of three chunks of K), every
    kernel of the path launched, each mesh effect filling tiles, every kernel
    against its plain version on a captured frame (and tile_blend's
    antialiased SCENE variant on the same window, a timing row), a profile
    of 30 frames, and the last frame re-rendered on the CPU."""
    import copy

    import torch

    from bevy_hanabi_tpu_torch import ParticlePool, RasterConfig
    from bevy_hanabi_tpu_torch.models import make_circle_texture
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster

    cam, cfg = mixed_camera(), RasterConfig(width=512, height=512, tile_slots=1)
    circle = make_circle_texture(32)
    scene = painter_scene("cuda", circle)
    plan = scene._scene_render_plan(scene.effects(), cam, "auto")
    if plan[0] or plan[1][0][0] != "painter":
        fail(f"the painter frame's plan is not the painter pass: {plan}")
    t0 = time.perf_counter()
    frames = warm_mixed(scene, cam, cfg)
    print(f"painter frame warm-up: {frames} frames in {time.perf_counter() - t0:.2f} s, alive "
          f"{[scene[n].alive_count() for n in PAINTER_NAMES]}")
    reset_launches(kernels)
    scene.update_render_chunk(K, DT, cam, cfg)  # untimed, as bench.py:749
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, sums = scene.update_render_chunk(K, DT, cam, cfg)
        checksum = float(sums[-1])  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    launches = read_launches(kernels)
    best = min(times)
    alive = [scene[n].alive_count() for n in PAINTER_NAMES]
    print(f"painter frame: {K} frames in {best:.4f} s: {K / best:.2f} frames/s "
          f"({1e3 * best / K:.3f} ms a frame), chunk times (s) {times}, alive {alive}, "
          f"checksum {checksum:.6e}")
    print(f"launches in the painter frame chunks (4 x {K} frames): {launches}")
    require_launches(launches, PAINTER_KERNELS, "the painter frame")
    if not bool(img.isfinite().all()) or not checksum > 0.0 or tuple(img.shape) != (512, 512, 4):
        fail("painter frame is not finite, not positive or not 512x512x4")

    # the last frame again on the CPU through the plain versions
    cpu = painter_scene("cpu", circle)
    cpu.clock = copy.deepcopy(scene.clock)
    for name in PAINTER_NAMES:
        cpu[name].pool = ParticlePool.from_numpy(*scene[name].pool.to_numpy(), device="cpu")
    t0 = time.perf_counter()
    s_p = float(cpu.render(cam, cfg).sum())
    s_k = float(scene.render(cam, cfg).sum())
    print(f"painter frame re-rendered: card {s_k:.6e} vs cpu plain {s_p:.6e} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not checksum_close(s_k, s_p):
        fail(f"painter frame checksum {s_k} on the card vs {s_p} on the CPU")

    # every kernel at the frame's shapes
    T, ntx, nty, nt = cfg.tile_size, cfg.tiles_x, cfg.tiles_y, cfg.num_tiles
    M = cfg.max_entries_per_tile
    flat, counts, extra = painter_frame_draw(scene, cam)
    ap, columns = raster.draw_appearance(flat, raster.ROW)
    results = {"mesh_expand[painter]": compare_mesh_expand(
        extract_mesh_draw(scene, "mesh1", cam), scene["mesh1"].asset.mesh, "painter, mesh1")}
    results["project_bin[painter]"], projected = compare_project_bin(
        project_args(flat, cam, cfg), nt, f"project_bin (painter, {flat.alive.shape[0]} entries)",
        raster.ROW, extra, appearance=columns)
    results["bin_keys[painter]"] = compare_bin_keys(projected, nt, None, "bin_keys (painter)")
    results["gather_window[painter]"], win = compare_gather_window(projected, nt, M, None,
                                                                    f"painter, F={ap.row}")
    fb0 = painter_target(cfg, extra.device)
    texs = (flat.atlas,)
    for name, aa in (("tile_blend[scene,atlas]", False), ("tile_blend[scene,atlas,aa]", True)):
        results[name], _ = compare_tile_blend(
            f"scene ({ap.row}-float rows, {ap.atlas_layers} atlas layer{'s' * (ap.atlas_layers > 1)}"
            f"{', antialiased' if aa else ''})", *win, T, ntx, nty, cfg.background, "scene",
            **REDESIGNED_KW, framebuffer=fb0, depth_test=True, write_depth=True,
            appearance=ap, textures=texs, antialias=aa)
    # each mesh effect fills tiles: its entries' covered pairs in the window
    pidx_sorted, starts, ends = raster.sort_tiles(*projected[:2], nt, None, projected[3])
    pidx, _ = raster.window_index(pidx_sorted, starts, ends, M)
    first = [sum(counts[:k]) for k in range(len(counts))]
    for k, name in enumerate(PAINTER_NAMES):
        if not name.startswith("mesh"):
            continue
        mine = (pidx >= first[k]) & (pidx < first[k] + counts[k]) & win[1]
        pairs = covered_pairs(win[0], mine, T, ntx, ap.offset("tri"))
        print(f"painter frame: {name} holds {int(mine.sum())} window entries, {pairs} covered pairs")
        if pairs == 0:
            fail(f"painter frame: {name} fills no tile")
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    def run(k):
        float(scene.update_render_chunk(k, DT, cam, cfg)[1][-1])

    profile_frames("painter", run)
    return results, launches


def extract_mesh_draw(scene, name, cam):
    """One mesh effect's draw of the scene's current frame (not expanded)."""
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    inst = scene[name]
    return extract_draw_data(inst.asset, inst.pool, cam, sim=scene.clock.sim_params(),
                             properties=inst.properties.as_dict(), textures=list(inst.textures),
                             transform=inst.transform)


# ---- phases 19-21: instanced groups, the examples, textured ribbons -----------


def instanced_inputs(fx, bank, rng, frame: int, k: int = K):
    """K frames of bench.py::bench_instanced's inputs (bench.py:409-421):
    the bank's spawn counts, frame seeds from ``rng``, identity transforms."""
    import numpy as np

    from bevy_hanabi_tpu_torch import SimParams

    ins = [fx.make_inputs(bank.tick(DT), rng.integers(0, 2**32, fx.num_instances, dtype=np.uint32))
           for _ in range(k)]
    sims = [SimParams(time=(frame + j) * DT, delta_time=DT) for j in range(k)]
    return fx.effect.stack_frames(ins, sims)


def instanced_setup(device, instances: int, capacity: int):
    """``InstancedEffect(instancing_effect(capacity), instances)`` on
    ``device`` with bench.py::bench_instanced's bank (seed 1) and frame-seed
    stream (seed 0): ``(fx, pools, bank, rng)``."""
    import numpy as np

    from bevy_hanabi_tpu_torch import InstancedEffect
    from bevy_hanabi_tpu_torch.models import instancing_effect
    from bevy_hanabi_tpu_torch.spawn import make_spawner_bank

    asset = instancing_effect(capacity)
    fx = InstancedEffect(asset, instances, capacity, device=device)
    return (fx, fx.create_pools(), make_spawner_bank(asset.spawner, instances, seed=1),
            np.random.default_rng(0))


def instanced_gate():
    """Phase 19a: 8 x 4096 instances through 30 frames of
    ``step_render_chunk`` at 128x128, card against CPU, to bench.py:121-130's
    tolerances: every instance's alive mask, seeds and counter bit for bit,
    positions within rtol 1e-2 / atol 1e-3, every frame's checksum within
    0.5%."""
    import numpy as np

    from bevy_hanabi_tpu_torch import RasterConfig

    i, cap = INSTANCED_GATE
    cam = gate_camera(eye_z=8.0)
    out = []
    for device in ("cuda", "cpu"):
        fx, pools, bank, rng = instanced_setup(device, i, cap)
        pools, img, sums = fx.step_render_chunk(pools, *instanced_inputs(fx, bank, rng, 0, 30), cam,
                                                RasterConfig(128, 128))
        out.append((pools, img, sums.cpu().tolist()))
    (pg, img_g, sums_g), (pc, _, sums_c) = out
    (ag, alive_g, seed_g, cnt_g), (ac, alive_c, seed_c, cnt_c) = pg.to_numpy(), pc.to_numpy()
    if not (np.array_equal(alive_g, alive_c) and np.array_equal(seed_g, seed_c)
            and np.array_equal(cnt_g, cnt_c)):
        fail("instanced gate: alive masks, seeds or counters differ between the card and the CPU")
    for name in ("position", "velocity"):
        if not np.allclose(ag[name][alive_c], ac[name][alive_c], rtol=POS_RTOL, atol=POS_ATOL):
            fail(f"instanced gate: {name} differs beyond rtol {POS_RTOL} / atol {POS_ATOL}")
    for k, (a, b) in enumerate(zip(sums_g, sums_c)):
        if not checksum_close(a, b) or not b > 0.0:
            fail(f"instanced gate frame {k}: checksum {a} on the card vs {b} on the CPU")
    if not bool(img_g.isfinite().all()):
        fail("instanced gate: non-finite pixels on the card")
    print(f"instanced gate {i} x {cap}: alive per instance {alive_c.sum(-1).tolist()}, counters "
          f"{cnt_c.tolist()}, masks, seeds and counters bit-equal, positions within the gate, last "
          f"checksum card {sums_g[-1]:.6e} cpu {sums_c[-1]:.6e}")


def instanced_frame(kernels):
    """Phase 19b-e: bench.py::bench_instanced at full width, 256 instances x
    4096 lanes of ``instancing_effect`` (1 048 576 lanes). (b) Four warm-up
    ``step_chunk`` chunks of K past the 3 s lifetime, then three timed
    chunks, each ending in a readback (steps/s, particle-steps/s); (c) one
    warm-up and three timed ``step_render_chunk`` chunks at
    ``RasterConfig(512, 512)`` (the JAX package's default binning) with the
    kernels' launches counted over the timed chunks (frames/s), the last
    frame rendered again on the CPU through the plain versions; (d) on that
    frame ``project_bin``, ``bin_keys``, ``gather_window`` and
    ``tile_blend`` BLEND against their plain versions, exactly, and timed;
    (e) ``torch.profiler`` over 30 rendered frames. Returns ``(results,
    launches)``."""
    import torch

    from bevy_hanabi_tpu_torch import ParticlePool, RasterConfig
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    i, cap = INSTANCES, INSTANCE_CAPACITY
    fx, pools, bank, rng = instanced_setup("cuda", i, cap)
    frame = 0
    t0 = time.perf_counter()
    for _ in range(4):  # > the 3 s lifetime: steady churn (bench.py:423-425)
        pools = fx.step_chunk(pools, *instanced_inputs(fx, bank, rng, frame))
        frame += K
    alive_before = int(fx.total_alive(pools))
    print(f"instanced warm-up: {frame} frames of {i} x {cap} in {time.perf_counter() - t0:.2f} s, "
          f"alive {alive_before}")
    times = []
    for _ in range(3):
        ii, ss = instanced_inputs(fx, bank, rng, frame)
        frame += K
        int(fx.total_alive(pools))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools = fx.step_chunk(pools, ii, ss)
        alive_after = int(fx.total_alive(pools))  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"instanced step_chunk times (s): {times}")
    print(f"instanced {i} x {cap}: {K} steps in {best:.4f} s: {K / best:.2f} steps/s, "
          f"{alive_mean * K / best:.4e} particle-steps/s, alive {alive_after}")

    cam = headline_camera()
    config = RasterConfig(512, 512)
    pools, _, _ = fx.step_render_chunk(pools, *instanced_inputs(fx, bank, rng, frame), cam, config)
    frame += K
    alive_before = int(fx.total_alive(pools))
    reset_launches(kernels)
    times = []
    for _ in range(3):
        ii, ss = instanced_inputs(fx, bank, rng, frame)
        frame += K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools, img, sums = fx.step_render_chunk(pools, ii, ss, cam, config)
        alive_after = int(fx.total_alive(pools))
        times.append(time.perf_counter() - t0)
    launches = read_launches(kernels)
    best = min(times)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"instanced step_render_chunk times (s): {times}")
    print(f"instanced frames at 512x512: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
          f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, checksum "
          f"{float(sums.sum()):.6e}")
    print(f"launches in the instanced chunks: {launches}")
    require_launches(launches, HEADLINE_KERNELS, "the instanced frame")
    if not bool(img.isfinite().all()) or not float(sums.sum()) > 0.0 or tuple(img.shape) != (
            512, 512, 4):
        fail("instanced image is not finite, empty or of the wrong shape")
    flat = pools.flatten()
    rerender_headline(fx.asset, flat, cam, config, "instanced")

    draw = extract_draw_data(fx.asset, flat, cam)
    nt = config.num_tiles
    results = {}
    results["project_bin[instanced]"], projected = compare_project_bin(
        project_args(draw, cam, config), nt, "project_bin (instanced)",
        raster.row_width("blend", False), config=config)
    results["bin_keys[instanced]"] = compare_bin_keys(projected, nt, None, "bin_keys (instanced)")
    results["gather_window[instanced]"], win = compare_gather_window(
        projected, nt, config.max_entries_per_tile, None, "instanced")
    results["tile_blend[instanced]"], _ = compare_tile_blend(
        "blend (instanced)", *win, config.tile_size, config.tiles_x, config.tiles_y,
        config.background, "blend")
    del draw, projected, win

    def run(k):
        nonlocal pools, frame
        pools, _, _ = fx.step_render_chunk(pools, *instanced_inputs(fx, bank, rng, frame, k), cam,
                                           config)
        frame += k
        int(fx.total_alive(pools))

    profile_frames("instanced", run)
    return results, launches


def gallery_grid(scene) -> None:
    """examples/run_all.py:81-97: a 5x5 grid of small emitters, one group."""
    import numpy as np

    from bevy_hanabi_tpu_torch import Gradient, SizeOverLifetimeModifier
    from bevy_hanabi_tpu_torch.models import instancing_effect

    grid = np.tile(np.eye(3, 4, dtype=np.float32), (25, 1, 1))
    grid[:, 0, 3] = (np.arange(25) % 5 - 2) * 2.0
    grid[:, 1, 3] = (np.arange(25) // 5 - 2) * 2.0
    asset = instancing_effect(capacity=512).render(
        SizeOverLifetimeModifier(Gradient.linear((0.15,), (0.05,))))
    scene.add_group(asset, 25, "grid", transforms=grid)


def textured_ribbon_asset():
    """example_ribbon with a flipbook: ParticleTextureModifier(0),
    FlipbookModifier((4, 1)) and a SPRITE_INDEX animated by age, a column
    that varies along each trail."""
    from bevy_hanabi_tpu_torch import INT, ExprWriter, FlipbookModifier, ParticleTextureModifier
    from bevy_hanabi_tpu_torch import SetAttributeModifier, attributes
    from bevy_hanabi_tpu_torch.models import example_ribbon

    asset = example_ribbon()
    w = ExprWriter()
    w.module = asset.module
    frame_expr = (w.attr(attributes.AGE) * 3.0).min(w.lit(3.0)).cast(INT)
    return (asset.update(SetAttributeModifier(attributes.SPRITE_INDEX, frame_expr.expr()))
            .render(ParticleTextureModifier(0)).render(FlipbookModifier((4, 1))))


def example_scenes():
    """Every ``examples_registry`` entry (``lifetime``'s trio, ``worms``'
    parent and child), the gallery's 5x5 ``add_group`` grid and a textured
    ribbon: ``(label, build(scene), camera eye, frames)``. ``worms`` runs 60
    frames: its heads spawn at 2/s, the first after 0.5 s."""
    from bevy_hanabi_tpu_torch.models import examples_registry, make_anim_sprite_sheet

    def single(builder, textures=()):
        return lambda s: s.add(builder(), "fx", textures=textures)

    def multi(builder):
        def build(s):
            assets = builder()
            if "bodies" in assets:
                s.add(assets["heads"], "heads")
                s.add(assets["bodies"], "bodies", parent="heads")
            else:
                for name, asset in assets.items():
                    s.add(asset, name)
        return build

    out = []
    for name, builder in examples_registry().items():
        if name in ("lifetime", "worms"):
            out.append((name, multi(builder), (0.0, 0.0, 8.0), 60 if name == "worms" else 30))
        elif name == "circle":
            out.append((name, single(builder, [make_anim_sprite_sheet(8, 32)]), (0.0, 1.0, 4.0),
                        30))
        else:
            out.append((name, single(builder), (0.0, 0.0, 8.0), 30))
    out.append(("gallery instancing", gallery_grid, (0.0, 0.0, 14.0), 30))
    out.append(("textured ribbon", lambda s: s.add(textured_ribbon_asset(), "fx", textures=[
        make_anim_sprite_sheet(4, 16)]), (0.0, 0.0, 8.0), 30))
    return out


def example_phase(kernels):
    """Phase 20: every example scene of :func:`example_scenes` through
    ``HanabiScene`` (seed 1) for its 30 (60) ``update(1/60)`` and one
    ``render`` at 512x512 (``RasterConfig(512, 512)``), card against CPU:
    every effect's and group's alive count equal, checksums within 0.5%;
    then the ``set_spawner_active`` / ``reset_spawner`` scenarios of the JAX
    package's tests/test_examples.py:71-125, card against CPU. Returns the
    textured ribbon's launches (phase 21's path)."""
    import torch

    from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    config = RasterConfig(512, 512)
    ribbon_launches = None
    for label, build, eye, frames in example_scenes():
        cam = CameraParams(look_at(eye, (0.0, 0.0, 0.0)), perspective(0.9, 1.0, 0.1, 200.0),
                           (512, 512))
        res = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            if device == "cuda" and label == "textured ribbon":
                reset_launches(kernels)
            scene = HanabiScene(seed=1, device=device)
            build(scene)
            for _ in range(frames):
                scene.update(DT)
            img = scene.render(cam, config)
            alive = {n: scene[n].alive_count() for n in scene._order}
            alive.update({n: scene.group_alive(n) for n in scene._groups})
            res[device] = (alive, float(img.sum()), bool(img.isfinite().all()),
                           time.perf_counter() - t0)
            if device == "cuda" and label == "textured ribbon":
                ribbon_launches = read_launches(kernels)
        (alive_g, sum_g, fin_g, t_g), (alive_c, sum_c, _, t_c) = res["cuda"], res["cpu"]
        print(f"example {label}: alive {alive_c}, checksum card {sum_g:.6e} cpu {sum_c:.6e} "
              f"(card {t_g:.1f} s, cpu {t_c:.1f} s)")
        if alive_g != alive_c:
            fail(f"example {label}: alive counts {alive_g} on the card vs {alive_c} on the CPU")
        if not fin_g or not checksum_close(sum_g, sum_c):
            fail(f"example {label}: checksum {sum_g} on the card vs {sum_c} on the CPU")

    def activate(device):
        from bevy_hanabi_tpu_torch.models import example_activate

        s = HanabiScene(seed=3, device=device)
        s.add(example_activate(), "fx")
        seen = []
        for active in (None, True, False):
            if active is not None:
                s.set_spawner_active("fx", active)
            for _ in range(30 if active is not False else 10):
                s.update(DT)
            seen.append(s["fx"].alive_count())
        return seen

    def spawn_on_command(device):
        from bevy_hanabi_tpu_torch.models import example_spawn_on_command

        s = HanabiScene(seed=4, device=device)
        s.add(example_spawn_on_command(), "fx")
        s.set_property("fx", "spawn_color", 0xFF00FF00)
        s.set_property("fx", "normal", (0.0, 1.0, 0.0))
        for _ in range(5):
            s.update(DT)
        seen = [s["fx"].alive_count()]
        s.set_spawner_active("fx", True)
        s.reset_spawner("fx")
        s.update(DT)
        pool = s["fx"].pool
        colors = pool.get("color")[pool.alive].cpu()
        return seen + [s["fx"].alive_count(), bool((colors == 0xFF00FF00).all())]

    for name, scenario, want in (("activate", activate, None),
                                 ("spawn_on_command", spawn_on_command, [0, 100, True])):
        got_g, got_c = scenario("cuda"), scenario("cpu")
        print(f"scenario {name}: card {got_g}, cpu {got_c}")
        if got_g != got_c or (want is not None and got_c != want) or (
                name == "activate" and not (got_c[0] == 0 and got_c[1] > 0 and got_c[2] <= got_c[1])):
            fail(f"scenario {name}: card {got_g} vs cpu {got_c}")
    torch.cuda.synchronize()
    return ribbon_launches


def textured_ribbon_kernels(kernels) -> dict:
    """Phase 21: ``ribbon_segments`` with the sprite column on the textured
    ribbon's frame (30 frames of phase 20's scene on the card), exactly
    against its plain version, and timed."""
    import torch

    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.models import make_anim_sprite_sheet
    from bevy_hanabi_tpu_torch.render import ribbon
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data

    scene = HanabiScene(seed=1, device="cuda")
    scene.add(textured_ribbon_asset(), "fx", textures=[make_anim_sprite_sheet(4, 16)])
    for _ in range(30):
        scene.update(DT)
    cam = ribbon_camera()
    draw = extract_draw_data(scene["fx"].asset, scene["fx"].pool, cam)
    order = ribbon.ribbon_sort(draw)
    args = (draw.position.contiguous(), draw.axis_y.contiguous(), draw.color.contiguous(), None,
            order.perm1, order.perm2, order.key, cam.position, draw.sprite_index.contiguous())
    got, want = ribbon.ribbon_segments(*args), ribbon.ribbon_segments_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want) if a is not None)
    valid = int(got[3].sum())
    sprites = got[6][got[3]].unique().tolist()
    print(f"ribbon_segments[sprite]: {draw.alive.shape[0]} rows, {valid} valid segments, sprite "
          f"frames {sprites}, max abs err {err:g}")
    if err != 0.0 or valid == 0 or len(sprites) < 2:
        fail(f"ribbon_segments[sprite]: max abs err {err:g}, {valid} valid, frames {sprites}")
    return {"ribbon_segments[sprite]": {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ribbon.ribbon_segments(*args), 100),
        "plain_ms": cuda_ms(lambda: ribbon.ribbon_segments_plain(*args), 20),
        "library_ms": cuda_ms(lambda: args[8].index_select(0, order.order), 100),
        **bound(nbytes(order.perm1, order.perm2, order.key, *args[:3], args[8], *got)),
    }}



VIEWS_K = 40  # frames per multi-view chunk (phase 22a)


def views_cameras(size: int = 512) -> list:
    """Phase 22a's three views sharing one viewport: phase 11's camera, a
    raised three-quarter camera, and one standing at x = 5.5 looking away
    from the origin, whose frustum holds the gradient's and the debris'
    boxes (out to x ~ 11 and ~ 7) and culls the rocket's and the trail's
    (within x ~ 3)."""
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    proj = perspective(math.radians(60.0), 1.0, 0.1, 200.0)
    return [
        mixed_camera(size),
        CameraParams(look_at([14.0, 12.0, 18.0], [0.0, 1.0, 0.0]), proj, (size, size)),
        CameraParams(look_at([5.5, 0.0, 0.0], [20.0, 0.0, 0.0]), proj, (size, size)),
    ]


def host_ms(fn, reps: int = 3) -> float:
    """Best host wall time of ``fn()`` (ms), each run ending synchronised."""
    import torch

    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        best = ms if best is None else min(best, ms)
    return best


def views_phase(kernels):
    """Phase 22a: the full mixed scene (phase 11's, 917 504 lanes at
    512x512) rendered from three cameras by ``render_views``: each view
    equal to ``render`` of its camera, the plan (the painter pass) frozen
    under the first; the third camera culls the rocket and the trail, which
    contribute nothing to its view. Then ``update_render_chunk`` over the
    three cameras (frames/s, every kernel of the painter path launched), and
    the four raster kernels against their plain versions on the second
    view's frame."""
    import torch

    from bevy_hanabi_tpu_torch import RasterConfig
    from bevy_hanabi_tpu_torch.render import raster

    cams = views_cameras()
    size = cams[0].viewport[0]
    cfg = RasterConfig(width=size, height=size, tile_slots=1)
    scene = mixed_scene("cuda", 65536, 1 << 19, 65536, 262144)
    t0 = time.perf_counter()
    frames = warm_mixed(scene, cams[0], cfg)
    # end 75 frames into a burst: rockets and trails on screen
    scene.update_render_chunk(FW_RENDER_AT, DT, cams[0], cfg)
    print(f"views: mixed scene warm-up {frames + FW_RENDER_AT} frames in "
          f"{time.perf_counter() - t0:.2f} s, alive {[scene[n].alive_count() for n in MIXED_NAMES]}")
    insts = scene.effects()
    vis_eff, _ = scene._per_view_visibility(cams, insts, [])
    print(f"views: visibility by view (rows) and effect {MIXED_NAMES}: {vis_eff.tolist()}")
    if not vis_eff[0].all() or not vis_eff[1].all() or vis_eff[2].tolist() != [True, True, False,
                                                                               False]:
        fail(f"views: the third camera must cull the rocket and the trail alone: {vis_eff.tolist()}")
    views = scene.render_views(cams, cfg)
    if tuple(views.shape) != (3, size, size, 4) or not bool(views.isfinite().all()):
        fail(f"views: render_views gave {tuple(views.shape)} or non-finite pixels")
    for v, cam in enumerate(cams):
        single = scene.render(cam, cfg)
        err = float((views[v] - single).abs().max())
        print(f"views: view {v} against render(camera {v}): max abs err {err:g}, checksums "
              f"{float(views[v].sum()):.6e} {float(single.sum()):.6e}")
        if err > 1e-5:
            fail(f"views: view {v} differs from render(camera {v}) by {err:g}")
    # the culled members contribute nothing to the third view: it equals the
    # frame of the scene without them
    for name in ("rocket", "trail"):
        scene.set_visible(name, False)
    without = scene.render(cams[2], cfg)
    for name in ("rocket", "trail"):
        scene.set_visible(name, True)
    if not torch.equal(without, views[2]):
        fail("views: the culled rocket and trail changed the third view")
    views_ms = host_ms(lambda: scene.render_views(cams, cfg))
    renders_ms = host_ms(lambda: [scene.render(c, cfg) for c in cams])
    print(f"render_views V=3 at {size}x{size}: {views_ms:.3f} ms, three render calls {renders_ms:.3f} ms")

    reset_launches(kernels)
    scene.update_render_chunk(VIEWS_K, DT, cams, cfg)  # untimed
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, sums = scene.update_render_chunk(VIEWS_K, DT, cams, cfg)
        checksum = float(sums[-1])  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    launches = read_launches(kernels)
    best = min(times)
    print(f"multi-view chunk (3 views, {size}x{size}): {VIEWS_K} frames in {best:.4f} s: "
          f"{VIEWS_K / best:.2f} frames/s ({3 * VIEWS_K / best:.2f} views/s), chunk times (s) "
          f"{times}, checksum {checksum:.6e}")
    print(f"launches in the multi-view chunks (3 x {VIEWS_K} frames x 3 views): {launches}")
    require_launches(launches, MIXED_KERNELS["auto"], "the multi-view chunk")
    if tuple(img.shape) != (3, size, size, 4) or not bool(img.isfinite().all()) or not checksum > 0:
        fail(f"multi-view chunk: the last frame is not [3, {size}, {size}, 4], finite and positive")

    # the painter pass's kernels on the second view's frame
    cam = cams[1]
    T, nt, M = cfg.tile_size, cfg.num_tiles, cfg.max_entries_per_tile
    painter, extra = painter_draw(scene, scene_draws(scene, cam))
    results = {}
    results["project_bin[views]"], projected = compare_project_bin(
        project_args(painter, cam, cfg), nt, f"project_bin (view 1, {painter.alive.shape[0]} "
        "entries)", raster.row_width("scene", True), extra)
    results["bin_keys[views]"] = compare_bin_keys(projected, nt, None, "bin_keys (view 1)")
    results["gather_window[views]"], win = compare_gather_window(projected, nt, M, None,
                                                                 "view 1")
    results["tile_blend[scene,views]"], _ = compare_tile_blend(
        "scene (view 1)", *win, T, cfg.tiles_x, cfg.tiles_y, cfg.background, "scene",
        framebuffer=painter_target(cfg, extra.device), depth_test=True, write_depth=True)
    return results, launches


def scene_tools_phase() -> None:
    """Phase 22b-f: hot reload of 1M lanes, a checkpoint of the firework
    tree, validation, bloom and ACES, ``example_multicam`` and a LOCAL-space
    2D frame, card against CPU."""
    import os

    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig, SimulationSpace
    from bevy_hanabi_tpu_torch import attributes as A
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.modifiers import SetAttributeModifier, SetVelocitySphereModifier
    from bevy_hanabi_tpu_torch.render import bloom, tonemap_aces
    from bevy_hanabi_tpu_torch.utils import load_scene_state, save_scene_state

    # b. hot reload on 1M lanes: a constant edit, then a layout edit
    asset = gradient_effect(CAPACITY)
    scene = HanabiScene(seed=2, device="cuda")
    scene.add(asset, "grad")
    scene.update_chunk(3 * K, DT)  # past the 5 s lifetime
    old_fx, old_pool = scene["grad"].fx, scene["grad"].pool.alive
    m = asset.module
    asset.init_modifiers[3] = SetVelocitySphereModifier(m.lit((0.0, 0.0, 0.0)), m.lit(3.0))
    const_ms = host_ms(lambda: scene.apply_asset_changes(), 1)
    if scene["grad"].fx is old_fx or scene["grad"].pool.alive is not old_pool:
        fail("hot reload: a constant edit must recompile and keep the pool")
    scene.update_chunk(30, DT)
    before = {k: v.clone() for k, v in scene["grad"].pool.attrs.items()}
    alive, seed = scene["grad"].pool.alive.clone(), scene["grad"].pool.seed.clone()
    asset.init(SetAttributeModifier(A.F32_0, m.lit(7.0)))
    t0 = time.perf_counter()
    changed = scene.apply_asset_changes()
    torch.cuda.synchronize()
    migrate_ms = 1e3 * (time.perf_counter() - t0)
    pool = scene["grad"].pool
    kept = all(torch.equal(pool.attrs[k], v) for k, v in before.items())
    if changed != ["grad"] or not kept or not torch.equal(pool.alive, alive) or not torch.equal(
            pool.seed, seed) or not bool((pool.attrs["f32_0"][alive] == 0.0).all()):
        fail(f"hot reload: the layout edit ({changed}) did not migrate the pool exactly")
    scene.update_chunk(30, DT)
    print(f"hot reload (gradient_effect({CAPACITY}), {int(alive.sum())} alive): constant edit "
          f"apply_asset_changes {const_ms:.3f} ms; layout edit migrating {pool.capacity} lanes "
          f"{migrate_ms:.3f} ms, alive mask, seeds and {len(before)} shared attributes exact, "
          f"alive after 30 more frames {scene['grad'].alive_count()}")
    del scene, pool, before

    # c. the firework tree checkpointed mid-burst, resumed on the card
    path = Path(__file__).resolve().parent / "build" / "phase22_checkpoint.npz"
    path.parent.mkdir(exist_ok=True)
    run = firework_scene("cuda", 5, 65536, 262144)
    run.update_chunk(FW_K + FW_RENDER_AT, DT)
    in_flight = int(run["rocket"].last_events[0].num_events)
    save_ms = host_ms(lambda: save_scene_state(run, str(path)), 1)
    size = os.path.getsize(path)
    resumed = firework_scene("cuda", 99, 65536, 262144)
    load_ms = host_ms(lambda: load_scene_state(resumed, str(path)), 1)
    os.remove(path)
    for s in (run, resumed):
        s.update_chunk(K, DT)
    for name in ("rocket", "trail"):
        a, b = run[name].pool.to_numpy(), resumed[name].pool.to_numpy()
        if not all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])):
            fail(f"checkpoint: the resumed {name} pool's integer state differs")
        if not all(np.array_equal(a[0][k], b[0][k]) for k in a[0]):
            fail(f"checkpoint: the resumed {name} pool's attributes differ")
    print(f"checkpoint of the 64k -> 256k tree ({in_flight} events in flight): save "
          f"{save_ms:.1f} ms, load {load_ms:.1f} ms, {size} bytes; {K} frames after the resume "
          f"bit-equal to the uninterrupted run (alive {run['trail'].alive_count()} trails)")

    # d. validation on the firework tree: clean frames pass, a poisoned live
    # lane raises at its frame
    fw = firework_scene("cuda", 5, 65536, 262144)
    fw.update_chunk(FW_K + FW_INTO_BURST, DT)
    rates = {}
    for validate in (False, True, False, True):
        fw.debug.validate = validate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            fw.update(DT)
        torch.cuda.synchronize()
        rate = 30 / (time.perf_counter() - t0)
        rates[validate] = max(rates.get(validate, 0.0), rate)
    rocket = fw["rocket"].pool
    lane = int(torch.nonzero(rocket.alive)[0])
    rocket.attrs["position"][lane] = float("nan")
    try:
        fw.update(DT)
    except FloatingPointError as e:
        print(f"validate: 60 validated clean frames passed; the poisoned rocket lane {lane} raised at its "
              f"frame: {e}")
    else:
        fail("validate: a poisoned live lane did not raise")
    print(f"firework 64k->256k update(): {rates[False]:.2f} steps/s with validate off, "
          f"{rates[True]:.2f} with validate on")
    del fw

    # e. bloom and ACES on the tree's 512x512 HDR frame, card against CPU
    cam, cfg = headline_camera(), RasterConfig(512, 512, tile_slots=1)
    hdr = run.render(cam, cfg)
    # examples/run_all.py:289-295's firework look, and examples/animate.py:65's
    posts = {"bloom(1.0, 3.0, 0.8)": lambda img: bloom(img, threshold=1.0, sigma=3.0, intensity=0.8),
             "tonemap_aces(bloom(0.8, 2.5, 0.9))": lambda img: tonemap_aces(bloom(img, 0.8, 2.5, 0.9))}
    for label, post in posts.items():
        card, cpu = post(hdr).cpu(), post(hdr.cpu())
        err = float((card - cpu).abs().max())
        print(f"{label} 512x512 (HDR max {float(hdr.max()):.3f}): card against CPU max abs err "
              f"{err:g}")
        if err > 1e-5 * max(1.0, float(cpu.abs().max())):
            fail(f"{label}: card against CPU max abs err {err:g}")
    print(f"bloom 512x512 (sigma 3): {cuda_ms(lambda: bloom(hdr, 1.0, 3.0, 0.8), 20):.4f} ms, "
          f"with ACES (sigma 2.5): {cuda_ms(lambda: tonemap_aces(bloom(hdr, 0.8, 2.5, 0.9)), 20):.4f}"
          f" ms")
    del run, resumed

    # f. example_multicam at examples/run_all.py:251-287's config, and a
    # LOCAL-space frame under camera_2d, card against CPU
    from bevy_hanabi_tpu_torch.models import examples_registry, spawn_gravity_effect
    from bevy_hanabi_tpu_torch.modifiers import OrientModifier
    from bevy_hanabi_tpu_torch.modifiers.output import OrientMode
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, camera_2d, look_at, perspective

    cfg = RasterConfig(width=256, height=256, tile_size=16, tile_span=2, max_entries_per_tile=128,
                       antialias=True)
    proj = perspective(0.9, 1.0, 0.1, 200.0)
    mc = [CameraParams(look_at((0, 0, 10), (0, 0, 0)), proj, (256, 256)),
          CameraParams(look_at((4.0, 3.0, 8.0), (0, 0, 0)), proj, (256, 256))]
    tf = np.asarray([[1.3, -0.75, 0.0, 0.5], [0.75, 1.3, 0.0, -0.5], [0.0, 0.0, 1.5, 1.0]],
                    np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        s = HanabiScene(seed=1, device=device)
        s.add(examples_registry()["multicam"](), "fx")
        for _ in range(200):
            s.update(DT)
        both = s.render_views(mc, cfg)
        local = HanabiScene(seed=1, device=device)
        local.add(spawn_gravity_effect(4096, 600.0).with_simulation_space(SimulationSpace.LOCAL)
                  .render(OrientModifier(OrientMode.FACE_CAMERA_POSITION)), "fx", transform=tf)
        for _ in range(30):
            local.update(DT)
        frame = local.render(camera_2d((512, 512), scale=3.0), RasterConfig(512, 512))
        out[device] = ([float(both[v].sum()) for v in range(2)], s["fx"].alive_count(),
                       float(frame.sum()), local["fx"].alive_count())
    (views_g, alive_g, local_g, lalive_g), (views_c, alive_c, local_c, lalive_c) = (
        out["cuda"], out["cpu"])
    print(f"example_multicam (256x256, antialiased, 2 views): alive {alive_g} / {alive_c}, view "
          f"checksums card {views_g} cpu {views_c}; LOCAL camera_2d frame: alive {lalive_g} / "
          f"{lalive_c}, checksum card {local_g:.6e} cpu {local_c:.6e}")
    if alive_g != alive_c or lalive_g != lalive_c or not all(
            checksum_close(a, b) for a, b in zip(views_g + [local_g], views_c + [local_c])):
        fail("example_multicam / LOCAL camera_2d: card and CPU disagree")
    if not min(views_g) > 0 or not local_g > 0:
        fail("example_multicam / LOCAL camera_2d: an empty frame")



SHARD_DEVICES = 8  # phase 23's mesh: (dp=4, sp=2), every shard on cuda:0
SHARD_STEP = (4, 131072)  # __graft_entry__.py:127-157: dp instances of 65 536 x sp lanes
SHARD_RENDER = (8, 131072)  # the render group: 8 x 131 072 = 1 048 576 lanes
SHARD_STEP_K = 60  # frames per timed chunk of the sharded and plain steps
SHARD_WARM = 330  # frames past the gradient's 5 s lifetime before the render
SHARD_TREE = (65536, 262144)  # the firework tree's rockets and trails (phase 7's)
SHARD_TREE_K = 240  # the firework tree's update_chunk
SHARD_KERNELS = ("project_bin", "bin_keys", "gather_window", "tile_blend")


def shard_mesh(dev):
    from bevy_hanabi_tpu_torch.parallel import make_mesh

    return make_mesh([dev] * SHARD_DEVICES, dp=4, sp=2)


def same_pools(a, b) -> bool:
    """Two whole pools equal bit for bit (NaN bits included)."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return (all(torch.equal(bits(a.attrs[k]), bits(b.attrs[k])) for k in a.attrs)
            and torch.equal(a.alive, b.alive) and torch.equal(a.seed, b.seed)
            and torch.equal(a.counter, b.counter))


def sharded_step(dev) -> None:
    """Phase 23a: ``ShardedEffect`` against ``InstancedEffect`` on the card."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import InstancedEffect, SimParams
    from bevy_hanabi_tpu_torch.models import spawn_gravity_effect
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect

    n_inst, cap = SHARD_STEP
    asset = spawn_gravity_effect(capacity=cap, rate=0.0)
    fx = ShardedEffect(asset, n_inst, shard_mesh(dev), device=dev)
    plain = InstancedEffect(asset, n_inst, device=dev)
    grav = {"gravity": np.tile(np.asarray([0.0, -3.0, 0.0], np.float32), (n_inst, 1))}
    pools, ref = fx.create_pools(), plain.create_pools()
    for f in range(2):
        args = (np.full(n_inst, cap // 2, np.int32), np.arange(n_inst, dtype=np.uint32) + f)
        sim = SimParams(time=f * DT, delta_time=DT)
        pools, _ = fx.step(pools, fx.shard_inputs(fx.make_inputs(*args, properties=grav)), sim)
        ref, _ = plain.step(ref, plain.make_inputs(*args, properties=grav), sim)

    def frames(start, k):
        ins = [fx.make_inputs(np.zeros(n_inst, np.int32), np.full(n_inst, start + j, np.uint32),
                              properties=grav) for j in range(k)]
        sims = [SimParams(time=(start + j) * DT, delta_time=DT) for j in range(k)]
        return fx.effect.stack_frames(ins, sims)

    pools = fx.step_chunk(pools, *frames(2, 6))
    ref = plain.step_chunk(ref, *frames(2, 6))
    alive = int(fx.total_alive(pools))
    if alive != n_inst * cap:
        fail(f"sharded step: {alive} alive lanes, expected {n_inst * cap}")
    if not same_pools(fx.assemble(pools), ref):
        fail("sharded step: the pools differ from the unsharded group's")
    print(f"sharded step: {n_inst} x {cap} lanes over (dp=4, sp=2) on one card "
          f"({cap // 2} lanes a shard), two steps and a 6-frame chunk bit-equal to "
          f"InstancedEffect, alive {alive}")
    rates = {}
    for name, eff, p in (("sharded", fx, pools), ("plain", plain, ref)):
        times = []
        for c in range(3):
            ii, ss = frames(8 + c * SHARD_STEP_K, SHARD_STEP_K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = eff.step_chunk(p, ii, ss)
            int(eff.total_alive(p))  # readback: waits for the chunk
            times.append(time.perf_counter() - t0)
        rates[name] = SHARD_STEP_K / min(times)
        print(f"sharded step ({name}): chunk times (s) {times}, {rates[name]:.2f} steps/s, "
              f"{rates[name] * n_inst * cap:.4e} particle-steps/s")


def shard_render_setup(dev):
    """Phase 23b's group: 8 ``gradient_effect(131072)`` instances on a ring
    of radius 6 facing the headline camera, stepped past their 5 s
    lifetime over the (dp=4, sp=2) mesh; ``(fx, pools, asset)``."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import SimParams
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect
    from bevy_hanabi_tpu_torch.spawn import make_spawner_bank

    n_inst, cap = SHARD_RENDER
    asset = gradient_effect(cap)
    fx = ShardedEffect(asset, n_inst, shard_mesh(dev), device=dev)
    ang = np.arange(n_inst) * (2.0 * np.pi / n_inst)
    tfs = np.tile(np.eye(3, 4, dtype=np.float32), (n_inst, 1, 1))
    tfs[:, 0, 3], tfs[:, 1, 3] = 6.0 * np.cos(ang), 6.0 * np.sin(ang)
    bank, rng = make_spawner_bank(asset.spawner, n_inst, seed=1), np.random.default_rng(0)
    pools = fx.create_pools()
    t0 = time.perf_counter()
    for c in range(SHARD_WARM // 110):
        ins = [fx.make_inputs(bank.tick(DT), rng.integers(0, 2**32, n_inst, dtype=np.uint32), tfs)
               for _ in range(110)]
        sims = [SimParams(time=(c * 110 + j) * DT, delta_time=DT) for j in range(110)]
        pools = fx.step_chunk(pools, *fx.effect.stack_frames(ins, sims))
    alive = int(fx.total_alive(pools))
    torch.cuda.synchronize()
    print(f"sharded render group: {n_inst} x {cap} lanes warmed {SHARD_WARM} frames in "
          f"{time.perf_counter() - t0:.2f} s, alive {alive}")
    return fx, pools, asset


def small_camera(cam, size: int):
    """``cam`` at a ``size`` x ``size`` viewport."""
    from bevy_hanabi_tpu_torch.render.camera import CameraParams

    return CameraParams(cam.view, cam.proj, (size, size))


def tile_counts(draw, cam, config):
    """Entries binned into each tile of a single-device frame ([nt])."""
    import torch

    from bevy_hanabi_tpu_torch.render import raster

    tile, _, _, _ = raster.project_bin(*project_args(draw, cam, config),
                                       row=raster.row_width("blend", False),
                                       tile_slots=config.tile_slots, tile_span=config.tile_span)
    return torch.bincount(tile.long(), minlength=config.num_tiles + 1)[:-1]


def per_tile(img, config):
    """[nt, T*T*4] view of an image's tiles (tile-major)."""
    T = config.tile_size
    return (img.reshape(config.tiles_y, T, config.tiles_x, T, 4).permute(0, 2, 1, 3, 4)
            .reshape(config.num_tiles, -1))


def hold_sharded_image(label, img, ref, counts, config, exact_tiles, atol=0.0):
    """A sharded frame against the single-device frame of the same pools:
    equal (within ``atol``) on ``exact_tiles``, the whole checksum within
    0.5%. Returns the count of tiles outside ``exact_tiles``."""
    import torch

    a, b = per_tile(img, config), per_tile(ref, config)
    if not bool(exact_tiles.any()):
        fail(f"{label}: no tile to hold exactly")
    err = float((a[exact_tiles] - b[exact_tiles]).abs().max())
    s_a, s_b = float(img.sum()), float(ref.sum())
    over = int((counts > config.max_entries_per_tile).sum())
    print(f"{label}: {over} of {config.num_tiles} tiles overflow M = {config.max_entries_per_tile}; "
          f"{int(exact_tiles.sum())} tiles held exactly: max abs err {err:g}; checksum "
          f"{s_a:.6e} against the unsharded {s_b:.6e} ({100.0 * (s_a - s_b) / s_b:+.3f}%)")
    if not torch.isfinite(img).all() or err > atol:
        fail(f"{label}: max abs err {err:g} on the tiles held exactly (allowed {atol:g})")
    return s_a, s_b


def sharded_render(kernels, dev):
    """Phase 23b: 1 048 576 lanes rendered at 512x512 in slice mode (BLEND)
    and psum (the ADD twin); the route's sort, window and copies timed; the
    ribbon and mesh slices at the dryrun's sizes."""
    import torch

    from bevy_hanabi_tpu_torch import AlphaMode, EffectRenderer, RasterConfig, SimParams
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer, make_mesh
    from bevy_hanabi_tpu_torch.parallel import render as prender
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.runtime.pool import ShardedPool

    import copy

    fx, pools, asset = shard_render_setup(dev)
    cam = headline_camera()
    config = RasterConfig(512, 512, tile_slots=1)
    n_dev = SHARD_DEVICES
    flat = fx.assemble(pools).flatten()
    counts = tile_counts(extract_draw_data(asset, flat, cam), cam, config)
    fits = counts <= config.max_entries_per_tile
    # tile_slots=1 bins a quad at its centre tile; a slice clamps the centre
    # of a quad straddling its edge into its own edge row (render.py's bbox
    # route), so the rows beside each slice edge are held by the checksum
    rows_per_slice = config.tiles_y // n_dev
    ty = torch.arange(config.num_tiles, device=dev) // config.tiles_x
    edge = ((ty % rows_per_slice == 0) & (ty > 0)) | ((ty % rows_per_slice == rows_per_slice - 1)
                                                      & (ty < config.tiles_y - 1))
    cpu_mesh = make_mesh(["cpu"] * n_dev, dp=4, sp=2)
    cpu_pools = ShardedPool.split(fx.assemble(pools, "cpu"), cpu_mesh.devices, instanced=True)
    out = {}
    for mode, alpha in (("slice", "blend"), ("psum", "add")):
        # with_alpha_mode edits its asset: the ADD twin is a copy
        a = asset if alpha == "blend" else copy.deepcopy(asset).with_alpha_mode(AlphaMode.ADD)
        fxm = fx if alpha == "blend" else ShardedEffect(a, fx.num_instances, fx.mesh, device=dev)
        r = ShardedRenderer(fxm, config)
        if r.mode != mode:
            fail(f"sharded render: auto picked {r.mode!r} for {alpha}, expected {mode!r}")
        r.render(pools, cam)  # warm
        reset_launches(kernels)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = r.render(pools, cam)
            float(img.sum())  # readback: waits for the frame
            times.append(1e3 * (time.perf_counter() - t0))
        launches = read_launches(kernels)
        require_launches(launches, ("project_bin", "bin_keys", "gather_window",
                                    "tile_blend" if alpha == "blend" else "tile_blend[add]"),
                         f"the sharded {mode} frame")
        ref = EffectRenderer(a, config).render(flat, cam)
        single_ms = host_ms(lambda: float(EffectRenderer(a, config).render(flat, cam).sum()))
        print(f"sharded {mode} frame ({alpha}, 1 048 576 lanes, 512x512, tile_slots=1): "
              f"{min(times):.3f} ms a frame (runs {times}), unsharded render {single_ms:.3f} ms; "
              f"launches {launches}")
        if mode == "slice":
            # a slice's tile keeps the nearest M entries that touch the slice:
            # exact where the tile does not overflow and is no slice's edge
            # row; an edge row also bins the quads straddling the edge (their
            # centre tile clamped into the slice), so under overflow their
            # slots hold entries that barely cover the tile (render.py:44-53;
            # the checksum against the unsharded frame is printed, and held
            # at the exact binning below)
            hold_sharded_image(f"sharded slice ({alpha})", img, ref, counts, config, fits & ~edge)
        else:
            # the partial images summed: exact up to the order of the f32 adds
            # where no shard's tile overflows M (a tile of the whole frame that
            # fits fits in every shard); an overflowing tile keeps M entries a
            # shard, so its sum holds more of them (render.py:44-53)
            hold_sharded_image(f"sharded psum ({alpha})", img, ref, counts, config, fits,
                               atol=1e-4 * max(1.0, float(ref.abs().max())))
        # the same pools on a mesh of the CPU, through the plain versions: the
        # slice frame at 512x512, the psum frame (eight full-frame partial
        # images) at 128x128, the card's psum rendered there too
        cam_c = cam if mode == "slice" else small_camera(cam, 128)
        if mode == "psum":
            img = r.render(pools, cam_c)
        fx_c = ShardedEffect(a, fx.num_instances, cpu_mesh, device="cpu")
        t0 = time.perf_counter()
        img_c = ShardedRenderer(fx_c, config).render(cpu_pools, cam_c)
        s_g, s_c = float(img.sum()), float(img_c.sum())
        print(f"sharded {mode} frame on the CPU at {cam_c.viewport} ({time.perf_counter() - t0:.1f}"
              f" s): checksum {s_c:.6e}, card {s_g:.6e}")
        if not checksum_close(s_g, s_c):
            fail(f"sharded {mode}: checksum {s_g} on the card against {s_c} on the CPU")
        out[mode] = {"ms": min(times), "launches": launches}

    # the JAX package's contract for slice mode (render.py:50-53) under its
    # default, exact binning (tile_slots=0): each slice bins a quad into the
    # tiles it touches as the whole frame does, so the slice frame equals
    # the unsharded one on every tile that does not overflow M, and keeps
    # the same candidates in every tile
    exact = RasterConfig(512, 512, tile_slots=0)
    counts0 = tile_counts(extract_draw_data(asset, flat, cam), cam, exact)
    img0 = ShardedRenderer(fx, exact).render(pools, cam)
    ref0 = EffectRenderer(asset, exact).render(flat, cam)
    s_a, s_b = hold_sharded_image("sharded slice (blend, tile_slots=0)", img0, ref0, counts0, exact,
                                  counts0 <= exact.max_entries_per_tile)
    if not checksum_close(s_a, s_b):
        fail(f"sharded slice (tile_slots=0): checksum {s_a} against the unsharded {s_b}")

    # the route of the slice frame, source shard 0: its sort, window, copies
    r = ShardedRenderer(fx, config)
    draws = [r._extract(p, cam, SimParams(), {}) for p in pools.flat]
    dests = [prender.slice_destinations(d, cam, config, n_dev) for d in draws]
    rows, _ = prender._pack_draw(draws[0], prender._SLICE_FIELDS)
    cap = r._route_cap(rows.shape[0], n_dev)
    entries, starts, ends = prender.route_keys(*dests[0], n_dev)
    sends = [prender.route_window(prender._pack_draw(d, prender._SLICE_FIELDS)[0],
                                  *prender.route_keys(*dd, n_dev), cap)
             for d, dd in zip(draws, dests)]
    route = {
        "sort_ms": cuda_ms(lambda: prender.route_keys(*dests[0], n_dev), 20),
        "window_ms": cuda_ms(lambda: prender.route_window(rows, entries, starts, ends, cap), 20),
        "copy_ms": cuda_ms(lambda: prender.deliver(sends, fx.mesh.flat_devices()), 5),
    }
    routed = int(sum(int((d0 < n_dev).sum() + (d1 < n_dev).sum()) for d0, d1 in dests))
    print(f"slice route: {rows.shape[0]} rows of {rows.shape[1]} floats a source, cap {cap}, "
          f"{routed} entries routed over {n_dev} sources; source 0's sort {route['sort_ms']:.4f} ms, "
          f"window {route['window_ms']:.4f} ms; the copies of all {n_dev} sources "
          f"{route['copy_ms']:.4f} ms")
    kernel_rows = shard_kernel_rows(r, pools, cam, config, rows, entries, starts, ends, cap)
    sharded_small_slices(dev)
    return out, route, kernel_rows


def shard_kernel_rows(r, pools, cam, config, rows, entries, starts, ends, cap):
    """Phase 23e on the slice frame: ``project_bin`` of a slice at its
    ``y_offset``, ``gather_window`` at the route's width and cap, and
    ``tile_blend`` BLEND on that slice's window, each against its plain
    version and timed."""
    import dataclasses

    import torch

    from bevy_hanabi_tpu_torch import SimParams
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster

    n_dev = SHARD_DEVICES
    received = r.slice_draws(pools, cam, SimParams(), {}, config)
    t = n_dev // 2 + 1  # a slice below the frame's middle
    slice_h = config.height // n_dev
    cfg = dataclasses.replace(config, height=slice_h)
    sdraw = received[t]
    results = {}
    results["project_bin[slice]"], projected = compare_project_bin(
        project_args(sdraw, cam, cfg), cfg.num_tiles, f"project_bin (slice {t}, y_offset "
        f"{t * slice_h})", raster.row_width("blend", False), config=cfg,
        y_offset=float(t * slice_h), raster_size=(cfg.width, cfg.height))
    _, win = compare_gather_window(projected, cfg.num_tiles, cfg.max_entries_per_tile, None,
                                   f"slice {t}")
    results["tile_blend[blend,slice]"], _ = compare_tile_blend(
        f"blend (slice {t})", *win, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, cfg.background,
        "blend")
    # the route's window: destinations in place of tiles, entry e reading
    # row e mod N, the first cap entries of each run
    args = (rows, entries, starts, ends, cap, True)
    got = gather.gather_window(*args)
    want = gather.gather_window_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0].view(torch.int32),
                                                         want[0].view(torch.int32))):
        fail("gather_window (route): differs from its plain version")
    filled = int(got[1].sum())
    idx = raster.window_index(entries, starts, ends, cap, True, rows.shape[0])[0].reshape(-1)
    results["gather_window[route]"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather.gather_window(*args), 50),
        "plain_ms": cuda_ms(lambda: gather.gather_window_plain(*args), 10),
        "library_ms": cuda_ms(lambda: rows.index_select(0, idx), 50),
        **bound(nbytes(starts, ends, *got) + filled * (entries.element_size()
                                                      + rows.shape[1] * rows.element_size())),
        "filled_entries": filled,
    }
    print(f"gather_window (route): {n_dev} destinations x {cap} slots x {rows.shape[1]} floats, "
          f"{filled} filled, bit-exact; kernel {results['gather_window[route]']['ms']:.4f} ms")
    return results


def sharded_small_slices(dev) -> None:
    """Phase 23b's ribbons and tetrahedron mesh through slice mode at the
    dryrun's sizes (__graft_entry__.py:214-266): card against the CPU and
    against the card's unsharded render of the same pools."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import AlphaMode, EffectRenderer, RasterConfig, SimParams
    from bevy_hanabi_tpu_torch.models import ribbon_bench_effect, spawn_gravity_effect
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer, make_mesh
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    dp, sp = 4, 2
    cam = CameraParams(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)), perspective(1.05, 1.0, 0.1, 100.0),
                       (64, 64))
    grav = {"gravity": np.tile(np.asarray([0.0, -3.0, 0.0], np.float32), (dp, 1))}
    cases = {
        "ribbons": (ribbon_bench_effect(capacity=512 * sp, num_ribbons=16)
                    .with_alpha_mode(AlphaMode.ADD),
                    [(np.full(dp, 80, np.int32), np.full(dp, f * 7 + 1, np.uint32), {})
                     for f in range(6)], True),
        "mesh": (spawn_gravity_effect(capacity=256 * sp, rate=0.0)
                 .with_mesh(ParticleMesh.tetrahedron()),
                 [(np.full(dp, 64, np.int32), np.full(dp, 3, np.uint32), grav)], False),
    }
    # 8-pixel tiles: each 8-row slice holds a whole row of tiles, so a slice
    # bins an entry's span square as the whole frame does
    config = RasterConfig(64, 64, tile_size=8, max_entries_per_tile=512)
    for name, (asset, frames, composite) in cases.items():
        sums = {}
        for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
            fx = ShardedEffect(asset, dp, make_mesh([d] * SHARD_DEVICES, dp=dp, sp=sp), device=d)
            pools = fx.create_pools()
            for f, (spawn, seeds, props) in enumerate(frames):
                pools, _ = fx.step(pools, fx.shard_inputs(fx.make_inputs(spawn, seeds, properties=props)),
                                   SimParams(time=f * DT, delta_time=DT))
            img = ShardedRenderer(fx, config, mode="slice", slice_capacity_factor=8.0).render(pools, cam)
            sums[key] = float(img.sum())
            if key == "card":
                flat = fx.assemble(pools).flatten(composite_ribbon_ids=composite)
                ref = EffectRenderer(asset, config).render(flat, cam)
                err, s_ref = float((img - ref).abs().max()), float(ref.sum())
                alive = int(fx.total_alive(pools))
        print(f"sharded slice {name} (64x64, {alive} alive): card {sums['card']:.6e}, cpu "
              f"{sums['cpu']:.6e}, the card's unsharded render {s_ref:.6e} (max abs err {err:g})")
        if not sums["card"] > 0.0 or not checksum_close(sums["card"], sums["cpu"]) or err != 0.0:
            fail(f"sharded slice {name}: card {sums['card']} against cpu {sums['cpu']}, max abs "
                 f"err {err:g} against the unsharded render")


def sharded_trees(dev, kernels=None):
    """The 64k -> 256k firework tree sharded over the mesh (``add(mesh=)``,
    the trail inheriting it) and unsharded on ``dev``: ``update_chunk(240)``
    timed for each, then 75 frames into the next burst, where both trees'
    pools must be bit-equal. With ``kernels`` the sharded chunk's launches
    are counted and returned (else None); also returns the sharded scene."""
    import torch

    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect

    mesh = shard_mesh(dev)
    scenes = {}
    for name, m in (("sharded", mesh), ("plain", None)):
        s = HanabiScene(seed=5, device=dev)
        s.add(firework_effect(SHARD_TREE[0]), "rocket", mesh=m)
        s.add(firework_trail_effect(SHARD_TREE[1]), "trail", parent="rocket")
        scenes[name] = s
    sh, pl = scenes["sharded"], scenes["plain"]
    if sh["trail"].fx.mesh is not mesh or sh["trail"].fx.parent_const_count is not None:
        fail("sharded tree: the trail did not inherit the mesh with the general rank map")
    launches = None
    for name, s in (("plain", pl), ("sharded", sh)):
        if name == "sharded" and kernels:
            reset_launches(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.update_chunk(SHARD_TREE_K, DT)
        trails = s["trail"].alive_count()  # readback: waits for the chunk
        secs = time.perf_counter() - t0
        if name == "sharded" and kernels:
            launches = read_launches(kernels)
        print(f"sharded tree ({name}): update_chunk({SHARD_TREE_K}) in {secs:.3f} s, "
              f"{SHARD_TREE_K / secs:.2f} steps/s, rockets {s['rocket'].alive_count()} "
              f"trails {trails}")
    # 240 frames end a burst period with every rocket and trail dead: go on
    # to 75 frames into the next burst, rockets dying and trails spawning
    for s in (pl, sh):
        s.update_chunk(FW_RENDER_AT, DT)
    for n in ("rocket", "trail"):
        if not same_pools(sh[n].pool.assemble(dev), pl[n].pool):
            fail(f"sharded tree: the {n} pools differ from the unsharded tree's")
    if sh["trail"].alive_count() == 0:
        fail("sharded tree: no trail spawned")
    print(f"sharded tree: {FW_RENDER_AT} frames into the next burst, rockets "
          f"{sh['rocket'].alive_count()} trails {sh['trail'].alive_count()}, both pools bit-equal "
          "to the unsharded tree's")
    return launches, sh


def sharded_tree(kernels, dev):
    """Phase 23c: :func:`sharded_trees` on the card, and ``event_compact`` on
    one shard's lanes against its plain version."""
    import torch

    from bevy_hanabi_tpu_torch.runtime import events

    launches, sh = sharded_trees(dev, kernels)
    require_launches(launches, ("event_compact", "gather_rows"), "the sharded tree")
    # event_compact on the shard holding the most alive rockets
    shard = max(sh["rocket"].pool.flat, key=lambda p: int(p.alive.sum()))
    mask = shard.alive.contiguous()
    count = torch.full((mask.shape[0],), 4, dtype=torch.int64, device=dev)
    payload = shard.attrs["position"].contiguous().view(torch.int32)
    got = events.event_compact(mask, count, payload)
    want = events.event_compact_plain(mask, count, payload)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)) or int(got[2]) == 0:
        fail("event_compact (sharded): differs from its plain version or has no active lane")
    print(f"event_compact (sharded): a shard's n={mask.shape[0]}, {int(got[2])} active, bit-exact")
    row = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: events.event_compact(mask, count, payload), 100),
        "plain_ms": cuda_ms(lambda: events.event_compact_plain(mask, count, payload), 20),
        "library_ms": None,
        **bound(nbytes(mask, count, payload, *got)),
    }
    return launches, row


def sharded_scene(dev) -> None:
    """Phase 23d: __graft_entry__.py:289-331's scene (a plain effect beside
    a sharded ADD group) through ``update``, ``render``,
    ``update_render_chunk(2)`` and ``render(pipeline="painter")``, against
    the same scene with a plain group."""
    from bevy_hanabi_tpu_torch import AlphaMode, HanabiScene, RasterConfig
    from bevy_hanabi_tpu_torch.models import gradient_effect, spawn_gravity_effect
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

    sp = 2
    asset = spawn_gravity_effect(capacity=256 * sp, rate=64.0).with_alpha_mode(AlphaMode.ADD)
    cam = CameraParams(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)), perspective(1.05, 1.0, 0.1, 100.0),
                       (64, 64))
    config = RasterConfig(64, 64)
    got = {}
    for name in ("sharded", "plain"):
        s = HanabiScene(seed=3, device=dev)
        s.add(gradient_effect(capacity=256), "plain")
        if name == "sharded":
            s.add_sharded_group(asset, count=8, mesh=shard_mesh(dev), name="big")
        else:
            s.add_group(asset, count=8, name="big")
        for _ in range(3):
            s.update(DT)
        img = s.render(cam, config, pipeline="split")
        chunk, sums = s.update_render_chunk(2, DT, cam, config)
        painter = s.render(cam, config, pipeline="painter")
        got[name] = (img, chunk, sums, painter, s.group_alive("big"))
    (a, b, c, d, n), (a2, b2, c2, d2, n2) = got["sharded"], got["plain"]
    errs = [float((x - y).abs().max()) for x, y in ((a, a2), (b, b2), (c, c2), (d, d2))]
    print(f"sharded scene: group alive {n} (plain {n2}); max abs err against the plain group: "
          f"split {errs[0]:g} (psum), chunk {errs[1]:g}, chunk sums {errs[2]:g}, painter "
          f"{errs[3]:g}; checksums {float(a.sum()):.6e} {float(d.sum()):.6e}")
    if n != n2 or n == 0 or errs[0] > 1e-4 or max(errs[1:]) != 0.0 or not float(a.sum()) > 0:
        fail(f"sharded scene: alive {n} against {n2}, errors {errs}")


def sharded_phase(kernels):
    """Phase 23: the sharded paths on one card, a (dp=4, sp=2) mesh whose
    eight shards all lie on cuda:0."""
    import torch

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    sharded_step(dev)
    frames, route, results = sharded_render(kernels, dev)
    tree_launches, results["event_compact[sharded]"] = sharded_tree(kernels, dev)
    sharded_scene(dev)
    print(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    launches = dict(frames["slice"]["launches"])
    launches["event_compact"] = tree_launches["event_compact"]
    return results, launches


def native_phase() -> None:
    """Phase 24a: the native spawner bank and a uniform group, card against CPU."""
    import numpy as np

    t_start = time.perf_counter()
    from bevy_hanabi_tpu_torch import HanabiScene
    from bevy_hanabi_tpu_torch.cpu_value import CpuValue
    from bevy_hanabi_tpu_torch.models import instancing_effect
    from bevy_hanabi_tpu_torch.native import NativeSpawnerBank
    from bevy_hanabi_tpu_torch.spawn import SpawnerSettings, make_spawner_bank

    bank = make_spawner_bank(SpawnerSettings.burst(CpuValue.uniform(1.0, 10.0), 0.05), 6, seed=123)
    if type(bank) is not NativeSpawnerBank:
        fail(f"make_spawner_bank returned {type(bank).__name__}, not the native bank")
    sums = sum(bank.tick(DT).astype(np.int64) for _ in range(10)).tolist()
    print(f"native bank: burst(uniform(1, 10), 0.05) x 6, seed 123, 10 ticks: {sums} "
          f"(the JAX package's {UNIFORM_BURST_SUMS})")
    if sums != UNIFORM_BURST_SUMS:
        fail(f"native bank sums {sums}, expected {UNIFORM_BURST_SUMS}")
    i, cap, frames = NATIVE_GROUP
    asset = instancing_effect(cap).with_spawner(
        SpawnerSettings.burst(CpuValue.uniform(5.0, 40.0), 0.05))
    out = []
    for device in ("cuda:0", "cpu"):
        t0 = time.perf_counter()
        scene = HanabiScene(seed=24, device=device)
        scene.add_group(asset, i, "g")
        g = scene._groups["g"]
        if type(g["bank"]) is not NativeSpawnerBank:
            fail(f"add_group took a {type(g['bank']).__name__}, not the native bank")
        for _ in range(frames):
            scene.update(DT)
        out.append((g["fx"].alive_counts(g["pools"]).cpu().numpy(), g["pools"].to_numpy()[1:],
                    time.perf_counter() - t0))
    (alive_g, state_g, t_g), (alive_c, state_c, t_c) = out
    print(f"uniform group {i} x {cap}, {frames} frames: alive {int(alive_c.sum())} (per instance "
          f"{int(alive_c.min())}-{int(alive_c.max())}), card {t_g:.1f} s, cpu {t_c:.1f} s")
    if not np.array_equal(alive_g, alive_c) or not alive_c.min() > 0:
        fail("uniform group: alive counts differ between the card and the CPU, or an instance "
             "spawned nothing")
    if not all(np.array_equal(a, b) for a, b in zip(state_g, state_c)):
        fail("uniform group: alive masks, seeds or counters differ between the card and the CPU")
    print(f"phase 24a in {time.perf_counter() - t_start:.1f} s")


def aa_appearance_phase(kernels):
    """Phase 24b: the fifteen antialiased appearance variants on the mesh
    frame's window, the ten new ones timed; the additive flipbook."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import (AlphaMode, CompiledEffect, EffectSpawner, RasterConfig,
                                       SimParams, StepInputs)
    from bevy_hanabi_tpu_torch.models import examples, make_anim_sprite_sheet, make_circle_texture
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import raster
    from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw

    t0 = time.perf_counter()
    cam, config = mesh_camera(512), RasterConfig(width=512, height=512, antialias=True)
    fx = CompiledEffect(mesh_asset(MESH_CAPACITY), device="cuda")
    textures = [torch.from_numpy(make_circle_texture(32)).cuda()]
    spawner = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
    pool = fx.step_chunk(fx.create_pool(), *chunk_inputs(fx, spawner, 0, 3 * K))
    draw = expand_mesh_draw(extract_draw_data(fx.asset, pool, cam, textures=textures),
                            fx.asset.mesh)
    n = draw.position.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(24)
    extra = torch.stack([torch.rand(n, device="cuda", generator=gen),
                         torch.randint(0, 6, (n,), device="cuda", generator=gen).to(torch.float32)],
                        dim=1)
    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    windows = {}
    for row in (raster.ROW_QUAD, raster.ROW):
        ap, columns = raster.draw_appearance(draw, row)
        tile, depth, rows, rng = raster.project_bin(
            *project_args(draw, cam, config), row=row, extra=extra if row == raster.ROW else None,
            tile_slots=config.tile_slots, tile_span=config.tile_span, appearance=columns)
        sorted_ = raster.sort_tiles(tile, depth, nt, None, rng)
        windows[row] = (*gather.gather_window(rows, *sorted_, config.max_entries_per_tile, False), ap)
    fb0 = torch.rand((nt, T, T, 4), device="cuda", generator=gen)
    depth0 = torch.rand((nt, T, T), device="cuda", generator=gen) * 8.0
    results = {}
    for mode, dt, wd in AA_APPEARANCE_FIRST + AA_APPEARANCE_NEW:
        window, has, ap = windows[raster.row_width(mode, dt)]
        kw = dict(framebuffer=fb0, depth_test=dt, write_depth=wd, appearance=ap,
                  textures=textures, antialias=True)
        if dt:
            kw["scene_depth"] = depth0
        tag = f"{mode}{',depth' if dt else ''}{',write' if wd else ''}"
        new = (mode, dt, wd) in AA_APPEARANCE_NEW
        row, _ = compare_tile_blend(f"{tag} (mesh,aa, {ap.row}-float rows)", window, has, T, ntx,
                                    nty, config.background, mode, plain_reps=1, timed=new,
                                    **REDESIGNED_KW, **kw)
        if new:
            results[f"tile_blend[{tag},mesh,aa]"] = row
    del fx, pool, draw, windows
    print(f"phase 24b: the fifteen variants in {time.perf_counter() - t0:.1f} s")

    # an additive textured flipbook, antialiased, through step_render_chunk
    t0 = time.perf_counter()
    size = (FLIPBOOK_AA["width"], FLIPBOOK_AA["height"])
    cam = CameraParams(look_at((0, 0, 3), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), size)
    cfg = RasterConfig(**FLIPBOOK_AA)
    out = []
    for device in ("cuda", "cpu"):
        if device == "cuda":
            reset_launches(kernels)
        add = CompiledEffect(examples.example_circle().with_alpha_mode(AlphaMode.ADD), device=device)
        texs = [torch.from_numpy(make_anim_sprite_sheet(8, 32)).to(device)]
        ins = [StepInputs.make(EXAMPLE_SPAWN, 7 * j + 1) for j in range(FLIPBOOK_FRAMES)]
        sims = [SimParams(time=j * DT, delta_time=DT) for j in range(FLIPBOOK_FRAMES)]
        p, img, sums = add.step_render_chunk(add.create_pool(), *add.stack_frames(ins, sims), cam,
                                             cfg, texs)
        if device == "cuda":
            launches = read_launches(kernels)
            card = (add.asset, p, texs)
        out.append((p.to_numpy(), sums.cpu().tolist(), img))
    (st_g, sums_g, img_g), (st_c, sums_c, _) = out
    print(f"additive flipbook, antialiased, {FLIPBOOK_FRAMES} frames: last checksum card "
          f"{sums_g[-1]:.6e} cpu {sums_c[-1]:.6e}; launches {launches}")
    if not (np.array_equal(st_g[1], st_c[1]) and np.array_equal(st_g[2], st_c[2])):
        fail("additive flipbook: alive masks or seeds differ between the card and the CPU")
    if not bool(img_g.isfinite().all()) or not sums_c[-1] > 0.0 or not all(
            checksum_close(a, b) for a, b in zip(sums_g, sums_c)):
        fail(f"additive flipbook: checksums card {sums_g} vs cpu {sums_c}")
    if launches["tile_blend[add,antialias]"] == 0 or launches["tile_blend[add,appearance]"] == 0:
        fail("additive flipbook: the antialiased ADD appearance variant never launched")
    asset, p, texs = card
    window, has, ap = appearance_window(asset, p, cam, cfg, texs)
    results["tile_blend[add,flipbook,aa]"], _ = compare_tile_blend(
        f"add (flipbook,aa, {ap.row}-float rows)", window, has, cfg.tile_size, cfg.tiles_x,
        cfg.tiles_y, cfg.background, "add", **REDESIGNED_KW, appearance=ap,
        textures=texs, antialias=True)
    print(f"phase 24b: the additive flipbook in {time.perf_counter() - t0:.1f} s")
    return results, launches


def instanced_events_phase(kernels):
    """Phase 24c: an emitting asset's instanced steps, card against CPU,
    and ``event_compact_segmented`` against its plain version."""
    import numpy as np
    import torch

    from bevy_hanabi_tpu_torch import InstancedEffect, SimParams
    from bevy_hanabi_tpu_torch.models import firework_effect
    from bevy_hanabi_tpu_torch.runtime import events

    i, cap, frames = INSTANCED_FIREWORK
    r = np.random.default_rng(24)
    inputs = [(r.integers(0, 40, i), r.integers(0, 2**32, i, dtype=np.uint32))
              for _ in range(frames)]
    runs = []
    for device in ("cuda", "cpu"):
        fx = InstancedEffect(firework_effect(cap), i, device=device)
        pools, bufs = fx.create_pools(), []
        if device == "cuda":
            reset_launches(kernels)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j, (counts, seeds) in enumerate(inputs):
            pools, ev = fx.step(pools, fx.make_inputs(counts, seeds),
                                SimParams(time=j * DT, delta_time=DT))
            bufs.append(ev[0])
        int(fx.total_alive(pools))  # readback: waits for the frames
        seconds = time.perf_counter() - t0
        if device == "cuda":
            launches = read_launches(kernels)
        runs.append((pools.to_numpy(), [b.to("cpu") for b in bufs], seconds))
    (card, bufs_g, t_g), (cpu, bufs_c, t_c) = runs
    emitted = [int(b.num_events.sum()) for b in bufs_c]
    print(f"instanced firework {i} x {cap}, {frames} frames: card {t_g:.2f} s, cpu {t_c:.2f} s, "
          f"alive {int(cpu[1].sum())}, events a frame {emitted[-5:]} (last five); launches "
          f"{launches}")
    if launches["event_compact_segmented"] != frames or launches["event_compact"] != 0:
        fail(f"instanced firework: {launches['event_compact_segmented']} segmented compactions "
             f"in {frames} frames")
    if not all(np.array_equal(a, b) for a, b in zip(card[1:], cpu[1:])):
        fail("instanced firework: alive masks, seeds or counters differ between the card and CPU")
    alive = cpu[1]
    for name in ("position", "velocity"):
        if not np.allclose(card[0][name][alive], cpu[0][name][alive], rtol=POS_RTOL, atol=POS_ATOL):
            fail(f"instanced firework: {name} beyond rtol {POS_RTOL} / atol {POS_ATOL}")
    for j, (g, c) in enumerate(zip(bufs_g, bufs_c)):
        if not (torch.equal(g.num_events, c.num_events) and torch.equal(g.parent_slot, c.parent_slot)
                and torch.equal(g.count, c.count)):
            fail(f"instanced firework frame {j}: event slots, counts or num_events differ")
        for k in c.payload:
            for inst, ne in enumerate(c.num_events.tolist()):
                if not torch.allclose(g.payload[k][inst, :ne], c.payload[k][inst, :ne], rtol=POS_RTOL,
                                      atol=POS_ATOL):
                    fail(f"instanced firework frame {j}: payload {k} of instance {inst} differs")
    if not emitted[-1] > 0:
        fail("instanced firework: no event in the last frame")

    # the kernel on the last frame's emissions, and at the wider shape
    last = bufs_g[-1].to("cuda")
    lanes = torch.arange(cap, device="cuda")[None, :]
    active = lanes < last.num_events[:, None].long()
    mask = torch.zeros((i, cap), dtype=torch.bool, device="cuda")
    mask.scatter_(1, last.parent_slot, active)
    count = torch.zeros((i, cap), dtype=torch.int64, device="cuda")
    count.scatter_(1, last.parent_slot, torch.where(active, last.count, 0))
    payload = torch.cat([events._to_words(v.reshape((i * cap,) + tuple(v.shape[2:])))
                         for v in last.payload.values()], dim=1)
    W = payload.shape[1]
    payload = payload.reshape(i, cap, W).contiguous()
    share = float(active.float().mean())
    wi, wn = SEGMENTED_WIDE
    gen = torch.Generator(device="cuda").manual_seed(24)
    wide = (torch.rand((wi, wn), device="cuda", generator=gen) < share,
            torch.randint(1, 5, (wi, wn), device="cuda", generator=gen),
            torch.randint(-2**31, 2**31, (wi, wn, W), device="cuda", generator=gen,
                          dtype=torch.int64).to(torch.int32))
    results = {}
    for name, args in (("event_compact[segmented]", (mask, count, payload)),
                       (f"event_compact[segmented,{wi}x{wn}]", wide)):
        got = events.event_compact_segmented(*args)
        want = events.event_compact_segmented_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{name}: differs from the plain version")
        shape = tuple(args[2].shape)
        print(f"{name}: [I, N, W] = {list(shape)}, {int(got[2].sum())} active lanes, bit-exact")
        results[name] = {
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: events.event_compact_segmented(*args), 100),
            "plain_ms": cuda_ms(lambda: events.event_compact_segmented_plain(*args), 20),
            "library_ms": None,
            **bound(nbytes(*args, *got)),
        }
    return results, launches


def phase24(kernels):
    """Phase 24: the native runtime, the antialiased appearance variants and
    the instanced event path."""
    t0 = time.perf_counter()
    native_phase()
    aa_results, aa_launches = aa_appearance_phase(kernels)
    ev_results, ev_launches = instanced_events_phase(kernels)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    return {**aa_results, **ev_results}, {"aa": aa_launches, "events": ev_launches}


def main() -> int:
    import torch

    t_start = time.perf_counter()

    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, RasterConfig, cuda_build
    from bevy_hanabi_tpu_torch.models import gradient_effect
    from bevy_hanabi_tpu_torch.ops import gather
    from bevy_hanabi_tpu_torch.render import mesh, raster, ribbon
    from bevy_hanabi_tpu_torch.runtime import events

    kernels = {**gather.KERNELS, **raster.KERNELS, **events.KERNELS, **ribbon.KERNELS,
               **mesh.KERNELS}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # Phase 2: build the kernels from the checkout's sources, and beside them
    # the variants that phase 13 times, every nvcc process started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        ribbon_builds = ex.submit(cuda_build.build_variants, RIBBON_VARIANTS, "ribbon_segments")
        blend_builds = ex.submit(cuda_build.build_variants, TILE_BLEND_VARIANTS, "tile_blend")
        window_builds = ex.submit(cuda_build.build_variants, GATHER_WINDOW_VARIANTS,
                                  "gather_window")
        lib_path = cuda_build.build()
        variant_builds = {**ribbon_builds.result(), **blend_builds.result()}
        window_builds = window_builds.result()
    cuda_build.library()
    print(f"built {lib_path.name} and {len(variant_builds)} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    print(lib_path.with_suffix(".log").read_text().strip())
    variants = {}
    for label, (lib, log) in variant_builds.items():
        print(f"== variant {label}\n{log.strip()}")
        if lib is None:
            fail(f"the variant {label!r} did not build")
        variants[label] = lib
    first_blend = variants.pop("appear1")
    VARIANT_LIBS["appear2"] = variants.pop("appear2")
    REDESIGNED_KW.update(first=VARIANT_LIBS["appear2"])
    # registers and spills of tile_blend's instantiations, the port's beside
    # appear2's: kernel, template arguments (equation, depth test, depth
    # write[, compacted pairs], antialiased), registers, spill stores, loads
    logs = [("port", lib_path.with_suffix(".log").read_text()),
            ("appear2", variant_builds["appear2"][1])]
    regs = {label: {(k, a): (n, st, ld) for k, a, n, st, ld in ptxas_kernels(log)}
            for label, log in logs}
    print("tile_blend registers and spill bytes (stores/loads): "
          + ", ".join(label for label, _ in logs))
    for key in sorted(regs["port"]):
        print(f"  {key[0]}<{key[1]}>: " + ", ".join(
            "{} ({}/{})".format(*regs[label].get(key, (0, 0, 0))) for label, _ in logs))
    for label, (lib, log) in window_builds.items():
        print(f"== gather_window variant {label}\n{log.strip()}")
        if lib is None:
            fail(f"the gather_window variant {label!r} did not build")
        VARIANT_LIBS[label] = lib

    # Phase 3: kernels against their plain versions at the main path's shapes.
    results = compare_kernels(dev)

    # Phase 4: the small frame through the kernels against the CPU's plain path.
    pool_g, img_g, sums_g = small_frame(dev)
    pool_c, img_c, sums_c = small_frame("cpu")
    sums_g, sums_c = sums_g.cpu().numpy(), sums_c.numpy()
    if not torch.isfinite(img_g).all():
        fail("small frame: non-finite pixels on the card")
    for k, (a, b) in enumerate(zip(sums_g, sums_c)):
        if not checksum_close(float(a), float(b)):
            fail(f"small frame {k}: checksum {a} on the card vs {b} on the CPU")
    if not np.array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1]):
        fail("small frame: alive masks differ between the card and the CPU")
    if not np.array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2]):
        fail("small frame: PCG seeds differ between the card and the CPU")
    print(f"small frame: checksums card {sums_g.tolist()} cpu {sums_c.tolist()}")

    # Phase 5: the headline.
    asset = gradient_effect(CAPACITY)
    fx = CompiledEffect(asset, device=dev)
    pool = fx.create_pool()
    spawner = EffectSpawner(asset.spawner, rng=np.random.default_rng(0))
    cam = headline_camera()
    config = RasterConfig(width=512, height=512, tile_slots=1)
    frame = 0
    t0 = time.perf_counter()
    for _ in range((int(5.0 / DT) + K) // K + 1):
        pool, img, sums = fx.step_render_chunk(pool, *chunk_inputs(fx, spawner, frame), cam, config)
        frame += K
    alive_before = int(pool.alive_count())
    print(f"warm-up: {frame} frames in {time.perf_counter() - t0:.2f} s, alive {alive_before}")
    reset_launches(kernels)
    times = []
    for _ in range(3):
        ins, sims = chunk_inputs(fx, spawner, frame)
        frame += K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool, img, sums = fx.step_render_chunk(pool, ins, sims, cam, config)
        alive_after = int(pool.alive_count())  # readback: waits for the chunk
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"headline chunk times (s): {times}")
    launches = read_launches(kernels)
    alive_mean = 0.5 * (alive_before + alive_after)
    print(f"headline: {K} frames in {best:.4f} s: {K / best:.2f} frames/s, "
          f"{alive_mean * K / best:.4e} particle-frames/s, alive {alive_after}, "
          f"checksum {float(sums.sum()):.6e}")
    print(f"launches in the timed chunks: {launches}")
    require_launches(launches, HEADLINE_KERNELS, "the headline")
    if not torch.isfinite(img).all() or not float(sums.sum()) > 0.0:
        fail("headline image is not finite or its checksum is not positive")
    if tuple(img.shape) != (512, 512, 4):
        fail(f"headline image has shape {tuple(img.shape)}")

    # The last pool rendered again by the kernels and by the CPU's plain path.
    rerender_headline(asset, pool, cam, config, "headline")

    # Phase 5b: the headline's three companion frames on the same pool.
    pool, frame, comp_launches = companion_frames(fx, pool, spawner, frame, cam, kernels)
    # Phase 18a: the headline antialiased, on the same pool.
    pool, frame, aa_launches = companion_frames(fx, pool, spawner, frame, cam, kernels,
                                                AA_HEADLINE, profile=False)
    require_launches(aa_launches["antialias"], ("tile_blend[blend,antialias]",),
                     "the antialiased headline")
    del pool

    # Phase 6: the 2k -> 8k firework tree, card against CPU.
    firework_gate()

    # Phase 7: the 64k -> 256k firework tree.
    fw_scene, fw_results, fw_launches = firework_tree(kernels, cam)
    profile_firework(fw_scene)
    del fw_scene

    # Phases 9-11: the mixed scene.
    painter_gate()
    mixed_gate()
    default_config_render()
    mx_results, mx_launches = mixed_full(kernels)

    # Phases 12-13: ribbons, and the reference's device checks at its config.
    ribbon_gate()
    reference_checks()
    rb_results, rb_launches = ribbon_frame(kernels, variants)

    # Phase 14: the force field.
    force_field_gate()
    force_field_full()

    # Phase 15: textured and mesh particles.
    mesh_gate()
    example_runs = example_checks(kernels)
    ms_results, ms_launches = mesh_frame(kernels, lit=False, first=first_blend)
    lit_results, lit_launches = mesh_frame(kernels, lit=True, first=first_blend)
    ex_results = example_kernels(example_runs, first=first_blend)
    tq_results, tq_launches = textured_quad_checks(kernels, first=first_blend)

    # Phases 16-17: the painter's atlas and mesh/Lambert merge.
    painter_atlas_gate(kernels)
    pt_results, pt_launches = painter_frame(kernels)

    # Phase 18b-c: the textured mesh frames and the examples antialiased.
    msaa_results, msaa_launches = mesh_frame(kernels, lit=False, antialias=True)
    litaa_results, litaa_launches = mesh_frame(kernels, lit=True, antialias=True)
    example_runs_aa = example_checks(kernels, RasterConfig(**EXAMPLES_AA), EXAMPLE_FRAMES_AA)
    exaa_results = example_kernels(example_runs_aa, config=RasterConfig(**EXAMPLES_AA))

    # Phase 19: instanced groups: the gate, then bench_instanced at full width.
    instanced_gate()
    in_results, in_launches = instanced_frame(kernels)

    # Phases 20-21: every example through HanabiScene, card against CPU, and
    # the textured ribbon's ribbon_segments with its sprite column.
    tr_launches = example_phase(kernels)
    tr_results = textured_ribbon_kernels(kernels)

    # Phase 22: the rest of HanabiScene and the renderer: multi-view, hot
    # reload, checkpoints, validation, bloom, multicam and LOCAL 2D.
    vw_results, vw_launches = views_phase(kernels)
    scene_tools_phase()

    # Phase 23: the sharded paths, a (dp=4, sp=2) mesh on cuda:0.
    sh_results, sh_launches = sharded_phase(kernels)

    # Phase 24: the native runtime, the antialiased appearance variants, the
    # instanced event path.
    p24_results, p24_launches = phase24(kernels)

    results.update(fw_results)
    results.update(mx_results)
    results.update(rb_results)
    results.update(ms_results)
    results.update(lit_results)
    results.update(ex_results)
    results.update(tq_results)
    for r in (pt_results, msaa_results, litaa_results, exaa_results, in_results, tr_results,
              vw_results, sh_results, p24_results):
        results.update(r)
    # name, kernel, launches: each row holds one path's launches and its
    # comparison at that path's shapes (the headline's, the firework's,
    # then the mixed scene's, by pipeline)
    rows = (
        [(name, name, launches[name]) for name in HEADLINE_KERNELS]
        # MASK runs on no main path: its launches are those of all four (0)
        + [("tile_blend[mask]", "tile_blend",
            sum(n["tile_blend[mask]"]
                for n in (launches, fw_launches, *mx_launches.values(), rb_launches)))]
        + [
            (name if "[" in name or name == "event_compact" else f"{name}[firework]",
             name.split("[")[0], fw_launches[name])
            for name in FIREWORK_KERNELS
        ]
        + [
            (f"{name}[mixed]", name, sum(n[name] for n in mx_launches.values()))
            for name in ("project_bin", "bin_keys", "gather_window", "gather_rows")
        ]
        + [
            ("tile_blend[scene]", "tile_blend", mx_launches["auto"]["tile_blend[scene]"]),
            (f"tile_blend[scene,M={MIXED_M_WIDE}]", "tile_blend",
             mx_launches[f"auto M={MIXED_M_WIDE}"]["tile_blend[scene]"]),
            ("tile_blend[opaque]", "tile_blend", mx_launches["split"]["tile_blend[opaque]"]),
            ("tile_blend[blend,split]", "tile_blend", mx_launches["split"]["tile_blend"]),
            ("tile_blend[add,split]", "tile_blend", mx_launches["split"]["tile_blend[add]"]),
        ]
        + [
            (f"{name}[ribbon]" if name != "tile_blend[add]" else "tile_blend[add,ribbon]",
             name.split("[")[0], rb_launches[name])
            for name in RIBBON_KERNELS
        ]
        + [
            (f"{name}[{c}]", name, comp_launches[c][name])
            for c in COMPANIONS
            for name in HEADLINE_KERNELS
        ]
        + [
            (f"{name}[{tag}]", name, counts[name])
            for tag, counts in (("mesh", ms_launches), ("mesh,lit", lit_launches))
            for name in ("mesh_expand", "project_bin", "bin_keys", "gather_window")
        ]
        + [
            ("tile_blend[mesh]", "tile_blend", ms_launches["tile_blend[blend,appearance]"]),
            ("tile_blend[mesh,lit]", "tile_blend", lit_launches["tile_blend[blend,appearance]"]),
            # a timing row: the mesh frame's blend at M = 128 (its path runs M = 64)
            (f"tile_blend[mesh,M={MIXED_M_WIDE}]", "tile_blend", 0),
            # no main path runs these: the launches of the mesh frames (0)
            ("tile_blend[premultiply,mesh]", "tile_blend",
             ms_launches["tile_blend[premultiply]"] + lit_launches["tile_blend[premultiply]"]),
            ("tile_blend[multiply,mesh]", "tile_blend",
             ms_launches["tile_blend[multiply]"] + lit_launches["tile_blend[multiply]"]),
            # the examples' own 30 frames
            ("tile_blend[flipbook]", "tile_blend",
             example_runs["example_circle"][4]["tile_blend[blend,appearance]"]),
            ("tile_blend[round]", "tile_blend",
             example_runs["example_2d"][4]["tile_blend[blend,appearance]"]),
            ("tile_blend[textured quads]", "tile_blend", tq_launches["tile_blend[blend,appearance]"]),
            # timing rows of windows no main path gathers at that M
            (f"gather_window[mesh,M={MIXED_M_WIDE}]", "gather_window", 0),
            (f"gather_window[mesh,lit,M={MESH_M_WIDE}]", "gather_window", 0),
            ("gather_window[flipbook]", "gather_window",
             example_runs["example_circle"][4]["gather_window"]),
            ("gather_window[round]", "gather_window",
             example_runs["example_2d"][4]["gather_window"]),
            ("gather_window[textured quads]", "gather_window", tq_launches["gather_window"]),
        ]
        + [
            (f"{name}[painter]", name, pt_launches[name])
            for name in ("mesh_expand", "project_bin", "bin_keys", "gather_window")
        ]
        + [
            ("tile_blend[scene,atlas]", "tile_blend", pt_launches["tile_blend[scene,appearance]"]),
            # a timing row: the painter frame's window antialiased (its path is not)
            ("tile_blend[scene,atlas,aa]", "tile_blend", pt_launches["tile_blend[scene,antialias]"]),
            ("tile_blend[blend,aa]", "tile_blend",
             aa_launches["antialias"]["tile_blend[blend,antialias]"]),
            ("tile_blend[mesh,aa]", "tile_blend", msaa_launches["tile_blend[blend,antialias]"]),
            ("tile_blend[mesh,lit,aa]", "tile_blend", litaa_launches["tile_blend[blend,antialias]"]),
            ("tile_blend[flipbook,aa]", "tile_blend",
             example_runs_aa["example_circle"][4]["tile_blend[blend,antialias]"]),
            ("tile_blend[round,aa]", "tile_blend",
             example_runs_aa["example_2d"][4]["tile_blend[blend,antialias]"]),
        ]
        + [
            (f"{name}[instanced]", name, in_launches[name]) for name in HEADLINE_KERNELS
        ]
        + [
            ("ribbon_segments[sprite]", "ribbon_segments", tr_launches["ribbon_segments"]),
            # a timing row: the ribbon frame's 1M rows with a sprite column
            ("ribbon_segments[sprite,1M]", "ribbon_segments", 0),
        ]
        + [
            (f"{name}[views]", name, vw_launches[name])
            for name in ("project_bin", "bin_keys", "gather_window")
        ]
        + [("tile_blend[scene,views]", "tile_blend", vw_launches["tile_blend[scene]"])]
        # the slice frame's three renders (gather_window: its route windows
        # and its slices' windows together), the sharded tree's chunk
        + [
            ("project_bin[slice]", "project_bin", sh_launches["project_bin"]),
            ("gather_window[route]", "gather_window", sh_launches["gather_window"]),
            ("tile_blend[blend,slice]", "tile_blend", sh_launches["tile_blend"]),
            ("event_compact[sharded]", "event_compact", sh_launches["event_compact"]),
        ]
        # phase 24: no main path runs the ten new antialiased appearance
        # variants on the mesh window (timing rows); the additive flipbook's
        # own launches; the instanced firework's segmented compactions
        + [(name, "tile_blend", 0) for name in p24_results if name.endswith(",mesh,aa]")]
        + [
            ("tile_blend[add,flipbook,aa]", "tile_blend",
             p24_launches["aa"]["tile_blend[add,antialias]"]),
            ("event_compact[segmented]", "event_compact_segmented",
             p24_launches["events"]["event_compact_segmented"]),
            ("event_compact[segmented,{}x{}]".format(*SEGMENTED_WIDE), "event_compact_segmented",
             0),
        ]
    )
    kernel_rows = [
        {
            "name": name,
            "route": "cuda",
            "source": kernels[kernel].source,
            "replaces": kernels[kernel].replaces,
            "launches": count,
            **results[name],
            "share": results[name]["bound_ms"] / results[name]["ms"],
        }
        for name, kernel, count in rows
    ]
    print("kernel rows: name, launches, ms, bound ms (by), share of the bound, plain ms, library ms"
          " (, the first version's ms)")
    for r in kernel_rows:
        print(f"  {r['name']:28s} {r['launches']:6d} {r['ms']:.4f} {r['bound_ms']:.4f} "
              f"({r['bound_by']}) {100.0 * r['share']:.1f}% {r['plain_ms']:.4f} {r['library_ms']}"
              + (f" {r['first_ms']}" if "first_ms" in r else ""))
    print("redesigned tile_blend rows: ms against appear2's first_ms")
    for r in kernel_rows:
        if r["name"] in REDESIGNED_ROWS or r["name"].endswith(",mesh,aa]"):
            print(f"  {r['name']:36s} {r['ms']:.4f} against {r['first_ms']:.4f} "
                  f"({r['ms'] / r['first_ms']:.3f}x)")
    print(json.dumps({"kernels": kernel_rows}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
