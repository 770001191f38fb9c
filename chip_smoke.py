#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives dxrpathtracer_tpu_torch's main paths and checks every kernel on
them: the path-traced frame (the Sponza-class stand-in, 246,084 triangles, at
1920x1080, path length 3, one CMJ sample per pixel per frame), the
alpha-tested, spot-lit frame (SponzaAlpha-checker: the stand-in plus 384
alpha-tested foliage cards with a checker opacity mask and four spot lights,
dxrpathtracer_tpu_torch/tools/alpha_cases.py; same size and path length),
the `render` command, the GI lightmap bake (the stand-in, a 4096x4096
lightmap on the pair atlas, default settings: path length 3,
sqrt_num_samples 4), raster mode (both scenes at 1080p MSAA4x, sun
shadows by rays or cascaded depth maps, and the raster commands), scene
import (SponzaAlpha-checker written as an FBX with DDS textures and
imported through the scene cache), dynamic geometry (the `animate`
flow: the stand-in rotated and its W8 table rebuilt on the card every
frame), the interactive viewer (app/interactive.py: a scripted session
on the stand-in at 1080p with its raster toggle, the bake window, scene
switches, checkpoints, hot reload and crash dumps) and the traversal
engines the default settings route through (packets for depth-1 rays, the
sun-space grid for sun shadows, the dense-proxy and AABB-cut screens in
front of the per-ray walks) and the seeded and binned alternates of an
opaque closest hit that the JAX package keeps off by default (temporal hit
reuse, proxy seeding, the software raster of camera rays), its split
alpha route and load-time alpha subdivision, off by default too, and
multi-device rendering (parallel/mesh.py: rows, samples and both over a
list of devices, and the texel-row-sharded bake), here with every shard on
the one card, and the learned denoiser's trainer (tools/train_denoiser.py:
dataset bakes, patches, 3000 Adam steps, the held-in eval). Phases, each
fatal on failure:

  1. device: a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the traversal kernel (csrc/traverse.cu), the row-gather
     kernel (csrc/gather.cu), the engines' kernels (csrc/packet.cu,
     csrc/sungrid.cu, csrc/screen.cu), the seeded routes' kernels
     (csrc/history.cu, csrc/swraster.cu) and the native SAH and morton
     builders from the checkout, all at once, with the seconds each took;
     for each (width, first_hit, alpha) instantiation of the traversal
     kernel (eight), ptxas' registers, stack frame and spills and the warps
     one SM holds at once (the persistent grid); the opaque W32
     instantiations must have no stack frame and no spills; the same ptxas
     figures of the engine kernels (packet closest and any, their
     opaque-only instantiations and the K-candidate ones for K = 1..8, the
     grid walk and its alpha instantiation, the proxy and cut screens, the proxy's nearest hit, the
     history's revalidation, the raster), with the warps one SM holds at
     once; the packet kernels but the K-candidate ones (one warp per
     packet, its stack in registers) and the opaque grid walk must have
     no stack frame and no spills;
  3. traversal kernel against plain: the kernel and its plain torch version,
     both on the card, (a) on the five ray classes of one plain-route 1080p
     sample (depth-1 closest on W8, depth-1 sun on W8, depth-2 closest, sun
     and terminal on W32): 0 lanes whose tri id, t, u or v differ in any
     bit; times of both, M visits/s; the plain walk counts its internal and
     leaf visits, the filled child slots and triangles of the records it
     visits and the distinct table rows it touches, which give each class
     its bound (BOUND below); (b) on the adversarial cases of
     dxrpathtracer_tpu_torch/tools/traverse_cases.py (equal-t ties, coplanar
     boxes under axis-aligned rays, hits at t = +-0, inactive rays, and the
     alpha cases: an opacity of exactly 0.35, chains of up to 16
     rejections, an opaque and an alpha triangle at equal t, a card seen
     edge-on), W8 and W32, closest and any hit: again 0 lanes that differ in
     any bit;
  V. the division check: raygen's steps for the 1080p camera rays (CMJ
     jitter, pixel positions, NDC, the unprojected points, the rays) on the
     card and on the CPU, with the NDC divided by a Python number (ATen's
     CUDA divide multiplies by its reciprocal then) and by a tensor on the
     device (core/math3.div, the port's rule): the lanes that differ at
     each step; with the tensor divisor no step may differ, nor may
     raygen's rays, card against CPU;
  4. frame main path: RenderSession on the card with the default settings
     (the engines on); init and first-frame seconds, median ms/frame over
     10 frames, Mrays/s by bench.py's formula W*H*(1+(L-1)*2)/dt; the
     accumulation must be finite; per frame the traversal kernel must have
     launched twice (depth-2 closest and terminal), the packet kernel once
     closest and once any hit (depth 1), the grid and the proxy once each
     (depth-2 sun, terminal), the cut never (its probe gates it off on the
     stand-in), and the gather kernel at least once;
  E1. engine classes, kernels against plain: the calls of one sample of
     that session recorded as the integrator makes them (depth-1 closest
     and sun in packets, depth-2 sun in the grid, the proxy-screened
     terminal rays, the depth-2 closest rays): each engine kernel against
     its plain version on the card, 0 lanes that differ in any bit; the
     packets against the per-ray kernel (t on every lane, the lanes with
     another t, which may only be nearer, and with another triangle at
     equal t; any-hit visibility, which may only be more occluded); the
     grid and proxy-screened visibility against the per-ray any hit, the
     same rule; the cut built un-gated on the depth-2 closest and terminal
     classes (cut-screened hits equal to unscreened); the proxy on the
     depth-2 sun class too; the gated cut on the classes of one 1080p
     BoxTest sample with the packets off (camera rays, depth-2 closest,
     the first per-ray shadow request): bit-equal, screened equal to
     unscreened, and some camera rays must be cleared; each with kernel
     and plain ms, its visits or tests and its bound; the probe fraction
     of every scene the script builds (BoxTest >= 0.10 > the stand-ins');
     the edge cases of tools/traverse_cases.py, each kernel against its
     plain version, 0 lanes that differ: packets (closest and any) on the
     ties and soup cases padded to whole packets and, on the stand-in's W8
     table, a packet with no active ray, packets with one, a packet whose
     rays all hit in the first leaf (its any-hit walk must visit one
     leaf) and one that reaches the deepest stack the table needs (the
     plain walk's stack height must equal the deepest leaf's depth); the
     proxy at K = 8 and 1,365 (the soup) and 24 (BoxTest) on rays with n
     not a multiple of 32, inactive lanes, t_max <= t_min and +-0
     direction components; the grid walk on grid_edge_cases (cell
     borders, origins outside the box or NaN, empty cells, thr on a
     record's suffix- and own-zmax, the longest chain, t_max <= t_min,
     inactive lanes, n = 37 and 1) of the grids of GRID_SCENES and of the
     stand-in, each set in its own launch and all in one, never less
     occluded than the per-ray walk; the grid's classes also carry the
     plain walk's shape: record steps per active lane against the
     longest lane of its 32-ray warp, lanes per distinct record of a
     warp step, and the busiest of the kernel's persistent ranges (and
     of the same fetches dealt out in turn) against the mean;
  E2. engines A/B: 10 timed frames after a first per configuration, the
     settings switched on that session: the stand-in with the engines on
     (the defaults) and off (the five fields), and with each of packets,
     grid, proxy and cut off alone; the SunTemple stand-in on and off;
     BoxTest on (its cut gated on) and with enable_clear_cut off: ms/frame,
     spread, launches per frame by kernel; every image within rel-RMSE
     1e-4 of its scene's engines-on image; the grid's host build seconds;
  M. multi-device rendering on the phase 4 session, the mesh [cuda:0] * n
     (the device list and torch.cuda.device_count() printed; with one
     card the shards run one after another): M1, the row step with the
     default engines at 3 shards of 360 rows, bit-equal to the unsharded
     render_sample of the same frame constants and accumulation, at 4
     shards of 270 rows (2x64 packet tiles) within rel-RMSE 1e-4, the
     differing pixels printed, and at 3 shards with per-shard raster bins
     (`raster_shards`) bit-equal to the unsharded frame with the full
     frame's bins; the median ms of 5 synchronised 3-shard steps beside 5
     unsharded samples; M2, the sample-parallel step, 4 shards x 2 steps
     against 8 sequential samples, and M3, the 2x2 (samples, rows) step, 2
     steps against 4, each within allclose(1e-4, 1e-4); launches per
     shard as the route wants; M4 (after phase 7): one step of phase 6's
     4096^2 bake over 4 texel-row shards (each walking its 1024 rows in
     512-row slabs) bit-equal to Baker.bake_step at the same sample index,
     both timed;
  S. the seeded and binned routes, each on its own 1080p stand-in session
     (its switch set while it renders), against the default route's 10
     frames after a first on the phase 4 session: temporal history
     (DXRPT_HISTORY=1: the second frame's depth-1 closest and sun
     revalidations recorded, the kernel against revalidate_plain, the
     seeded results against the packet walks on the same rays, never
     farther nor less occluded, the lanes the revalidation resolved and
     the sun lanes that skipped the walk), proxy seeding
     (DXRPT_PROXY_SEED=1: the depth-2 closest class, proxy_closest against
     its plain version, the seeded W32 walk against the unseeded one,
     never farther) and the software raster (DXRPT_RASTER_MIN_PIXELS=1:
     the camera rays, the raster kernel against its plain version and the
     packet walk, never farther; its pairs, deepest tile and host binning
     seconds): 0 lanes that differ from the plain versions in any bit,
     times of kernel, plain, bound (the revalidation by bytes, the others
     by the tests they make) and of the per-ray and packet walks on the
     same rays; each route's 10 frames after a first: ms/frame, spread,
     launches per frame (2 revalidations, 1 proxy_closest, 1 raster) and
     the image within rel-RMSE 1e-4 of the default route's; the edge
     cases, each kernel against its plain version: predictions of -1,
     stale, beyond t_max, inactive lanes and n = 2045; proxy_edge_rays at
     K = 8, 1,365 and 24; the raster on traverse_cases.raster_edge_scene
     (a tile of 804 triangles, empty tiles, a repeated quad: the lower id,
     a triangle through the near plane);
  5. same frame, kernel against plain: one 240x135 sample on the card and
     on the CPU; relative RMSE <= 1e-4;
  A. alpha ray classes, kernel against plain: on the SponzaAlpha-checker
     session with max_any_hit_path_length 3, the seven traversal calls of
     one 1080p sample with the alpha test (depth-1 closest, sun and spot on
     W8; depth-2 closest, sun, spot and terminal on W32; the spot rays of
     the four lights in one call): 0 lanes that differ in any bit; ms, M
     visits/s, candidates, texture taps and rejections per ray, bound;
     Then the grid kernel's alpha instantiation (sun_any_hit with the
     AlphaTest, csrc/sungrid.cu) on the two alpha-tested sun classes
     (d1 on W8, d2 on W32) through the session's sun grid: 0 lanes that
     differ from its plain version (sun_any_hit_plain with the test as
     accept_fn) and from the per-ray alpha any hit, blockers that only the
     test rejects present; ms, plain ms, the per-ray walk's ms, candidates,
     taps and rejections, and the bound (the grid's bytes and operations
     plus TAP_BYTES and TAP_OPS a tap);
  B. the alpha frame main path: that session at the reference's
     max_any_hit_path_length 1 and at 3 (every ray alpha-tested), 10 frames
     each after a first: median ms/frame with the spread, Mrays/s by
     bench.py's formula (which counts no spot rays), traversal launches per
     frame by instantiation; the accumulation must be finite; per frame, at
     1: 6 traversal launches (the depth-1 rays alpha-tested; the depth-2
     closest, spot and terminal opaque), the grid once (depth-2 sun) and
     the proxy twice (depth-2 spot and terminal); at 3: 7 traversal
     launches and no engine (every ray alpha-tested);
  K. the split alpha route (DXRPT_SPLIT_ALPHA=1: opaque-only packet walks,
     the K-candidate packet walk of the alpha-only table, the candidates'
     taps; with the raster on, bins masked to opaque triangles) and the
     load-time subdivision (DXRPT_ALPHA_SPLIT=1), on that session: one
     split sample at max_any_hit_path_length 1 recorded, each of its four
     packet calls (depth-1 opaque-only closest on W8 and its K = 8
     candidates, K = 4 too; depth-1 sun opaque-only any hit and its
     candidates) against its plain twin, 0 lanes that differ in the hit,
     in every candidate slot's t, tri id, u, v and in the overflow bit,
     with kernel and plain ms, the per-ray alpha walk on the same rays,
     visits and the bound; the whole split closest hit's ms; the
     K-candidate edge cases of tools/traverse_cases.py (overflow on a
     leaf-12 table, a full buffer of rejected candidates, equal t, an
     inactive packet, K = 1), each mode against its twin; 10 frames after
     a first of the default alpha route and the split route at
     max_any_hit_path_length 1 and 3 and of the split route with the
     masked bins at 1 (ms/frame, spread, launches per frame: one
     opaque-only closest (none with the bins) and any hit and two
     K-candidate walks; rel-RMSE against the default route), the
     subdivided scene's stats, triangles and frames; each route's frame
     (split at max_any_hit_path_length 3, split with the masked bins at 1,
     the subdivided scene at 1) at 256x128 on the card and on the CPU (the
     plain twins): rel-RMSE <= 1e-4, and in that frame on the card the
     split kernels' launches as the route wants (1, 1, 2; 0, 1, 2 with the
     bins; none on the subdivided scene), candidates tapped on the split
     routes and none elsewhere, the bins masked on the raster route, on
     the CPU no launch;
  C. same alpha frame, kernels against plain: one 240x135 sample on the
     card and on the CPU, every traversal call's rays and results recorded.
     At the reference's max_any_hit_path_length 1: relative RMSE <= 1e-4.
     At 2 (depth-2 rays alpha-tested too): per call, the lanes whose rays
     differ between the routes (an op that rounds differently on the card
     would show here; the NDC division did, phase V) and by how much, the
     lanes whose results differ, none of which may have bit-equal rays,
     and the lanes whose hit differs; each pixel off by more than 1e-3 of
     the image's maximum, with the calls in which its hit differs; then the
     CPU route once more, given the card's rays for its depth-2
     (alpha-tested W32) calls: relative RMSE <= 1e-4 against the card; and
     the plain card vs CPU reading, <= 1e-4;
  D. the `render` command: `python -m dxrpathtracer_tpu_torch render
     --current-scene Sponza --width 1920 --height 1080 --sqrt-num-samples 2`
     as a subprocess, writing chiprun_out/render.png and render.exr; the EXR
     read back must equal the accumulation of the same 4 samples rendered
     here; the PNG's size; `display_image` timed at 1080p;
  6. bake main path: Baker on the card at full size; atlas, texel-map and
     surface-map seconds, covered texels (>= 50 %), first-step seconds,
     median seconds per bake step over 3 more steps with the spread,
     Mrays/s as covered*(1+(L-1)*2)/dt, traversal and gather launches per
     step (both > 0), peak device memory, and the ms of the median, guided
     and learned denoisers on the 4096^2 lightmap; the accumulation and
     every denoised map must be finite; per step the grid and the proxy
     must launch, the packets and the cut not; then E1's bake classes:
     the depth-1 and depth-2 sun calls of the slab (of one step's eight)
     whose depth-1 class has the most active rays, the grid kernel against
     its plain version and the per-ray walk as on the frame's class, with
     its times, bound and walk shape; then E2's bake: 3 steps
     with the grid and proxy (the defaults) and 3 without, each from an
     empty accumulation: s/step, launches, the accumulations equal within
     rel-RMSE 1e-4;
  7. row gather against plain: kernel, plain (`table[idx.long()]`) and
     torch.index_select, bit-equal, timed with CUDA events on (a) the TPU
     microbenchmark's shapes (32768 rows, 2^20 indices, width 32 and 128),
     (b) the shading row (the stand-in's (246084, 64) tri_shade by the
     2,073,600 depth-1 hit ids of one 1080p sample) and (c) the surface
     map's gathers at 4096^2; each with M rows/s and its bound;
  8. same bake, kernels against plain: BoxTest at 64x64, 2 steps, on the
     card and on the CPU; relative RMSE <= 1e-4 and validCount equal.
  E3. engines card vs CPU: one engines-on BoxTest frame at 256x128 (packet
     tiles, the cut gated on) on the card and on the CPU: rel-RMSE <=
     1e-4, each engine reached on both routes (launches on the card, the
     plain versions' calls on the CPU);
  R1. raster frame main path (EnableRayTracing=false, the reference's
     defaults: MSAA4x, cluster mode 3): the opaque stand-in at 1080p with
     sun shadow rays; median ms/frame over 10 frames after the first with
     the spread, the profiler's scope ms, traversal launches per frame by
     instantiation (one primary closest, one sun any) and the gather's;
     the frame must be finite and lit;
  R2. the alpha raster frame: SponzaAlpha-checker at 1080p MSAA4x in the
     rays, pcf, evsm and msm shadow modes, 3 frames each after a first:
     ms/frame, the profiler's five scope ms, launches per frame (rays: one
     primary closest and two any-hit launches, the sun's and the four
     spots'; the map modes: three closest-hit launches, the cascade
     depth, spot depth and primary rays);
  R3. raster ray classes, kernel against plain: the calls of a rays and a
     pcf frame of R2's session as the frame makes them (primary closest,
     sun any, the four spots' any in one launch, cascade depth 4 x 512^2,
     spot depth 4 x 1024^2; all W32 with the alpha test): 0 lanes that
     differ in any bit; ms, visits, bound as in phase 3;
  R4. same raster frame, kernels against plain: SponzaAlpha-checker at
     240x135 on the card and on the CPU, rays and pcf (cascade maps
     128^2): relative RMSE <= 1e-4; every traversal call's rays and
     results recorded on both routes, as in phase C: per call, the lanes
     whose rays differ and whose results differ, none of which may have
     bit-equal rays;
  R5. the raster commands as subprocesses on the card: `bake` BoxTest
     256^2 (pair atlas) into an .npz bundle, `render --raster --lightmap`
     from it, `render --raster --shadow-mode pcf --profile-trace` on the
     stand-in (the trace must hold kernel events), `uvviz`; the PNGs'
     sizes and the HDR frames' finiteness are checked.
  F. scene import: SponzaAlpha-checker written by
     dxrpathtracer_tpu_torch/tools/fbx_cases.py as the Sponza preset's FBX
     under a temporary asset root (246,852 triangles, 4 spot lights, the
     cards' checker opacity and two albedo maps as DDS) and a temporary
     DXRPT_SCENE_CACHE; parse, cache-write and cache-hit seconds, the hit
     byte-equal to the parse; the triangles, lights and opacity map as
     written; RenderSession(asset_root=...) at 1080p, path length 3: the
     seven alpha classes kernel against plain (max_any_hit_path_length 3),
     then 10 frames after a first at the reference's
     max_any_hit_path_length 1, ms/frame, launches per frame as phase B's
     at 1; the same frame at 240x135 on the
     card and the CPU, rel-RMSE <= 1e-4;
  AN. dynamic geometry: the `animate` flow on the stand-in at 1080p with
     the command's defaults (24 frames, 4 samples each): per frame, rotate,
     device-build and render ms (CUDA events); the device table at two
     frames bit-identical to the native morton build and to
     build_table_numpy of the same rotated vertices on the host; the five
     classes on the last frame's W8 table, kernel against plain; per
     sample three traversal launches and one packet closest and any hit,
     and no grid, proxy or cut (the moved geometry drops them); E4: the
     last frame's geometry, one sample with the engine fields on and one
     with them off, rel-RMSE <= 1e-4; one animated frame at 240x135 on the
     card and the CPU: tables bit-equal, rel-RMSE <= 1e-4;
     `python -m dxrpathtracer_tpu_torch animate` at
     480x270, 4 frames, into chiprun_out/animate/ (a GIF where PIL is
     installed).
  I. the interactive viewer, its terminal frames presented into a buffer
     (the bytes are counted, never printed):
     I1. InteractiveApp on the stand-in at 1080p: 8 frames, `w`, `l`, `]`,
       a settings-menu edit of roughness_scale (restart-relevant), `m` (3
       raster frames at the reference's defaults), `m`, `p`: the sample
       index after every step as the CPU tests assert it, median path and
       raster ms/frame (the app's frame times: each frame synchronises),
       present ms, launches per frame (path >= 2 traversals, >= 1
       packet closest and any hit, grid and proxy, >= 1 gather; raster >= 2
       and >= 1); every thumbnail the pipelined present
       drew byte-equal to a synchronous display_thumbnail of the same
       accumulation; the screenshot in chiprun_out/interactive/;
     I2. scene key `1` (BoxTest), then `b`: atlas, texel-map and
       surface-map seconds; 4 bake frames cycling `v`: ms per bake frame,
       launches per bake frame (both > 0); all seven previews of the right
       shape, their sources finite;
     I3. scene keys 3, 4, 5 (the SunTemple stand-in, WhiteFurnace,
       Stronghold -> the stand-in): seconds each, first frame finite;
     I4. one script (moves, a menu edit, `m` and back) on BoxTest at
       240x135 through the app on the card and on the CPU: equal sample
       indices and cameras, rel-RMSE <= 1e-4 and thumbnails within 1
       (the values that differ are counted) after every step;
     I5. 3 samples, checkpoint_state, restore_state into a new session, 2
       more: bit-equal to 5 samples of one session (stand-in, 1080p);
     I6. hot reload in a copy of the package (with its build/) imported by
       a subprocess: the viewer renders 2 frames, the copy's
       csrc/gather.cu is edited, the watcher reloads accel.gather and its
       dependents, nvcc builds a new hash-named library (seconds), the
       accumulation restarts and the next 2 frames equal the first 2 bit
       for bit;
     I7. `bake --checkpoint F` (F a 32x32 accumulation, a 64^2 bake) as a
       subprocess with DXRPT_CRASH_DUMP set: it exits non-zero and its
       dump names the card, torch and CUDA, the settings, the frame and
       scene tables, and ends in the ValueError's traceback;
     I8. `python -m dxrpathtracer_tpu_torch interactive --current-scene
       Sponza --width 1920 --height 1080 --script 'w:2,l:1,:4'
       --max-frames 8`: exit 0, and its stderr reports the script's 7
       frames and a mean ms/frame.

  T. training the learned denoiser: the functions of
     dxrpathtracer_tpu_torch/tools/train_denoiser.py at the width of the JAX
     repository's recipe (the net's ARCH, 2048 patches of 64^2, batch 16,
     3000 Adam steps at lr 1e-3 under the cosine decay, 1, 2 and 4 spp
     bakes against 96 spp at 192^2), cut to BoxTest alone (the default
     scenes add Stronghold, whose charted atlas takes ~15 minutes on the
     host): bake_dataset (the atlas and bake seconds), make_patches (its
     seconds), train (its seconds, of which train's set-up and first
     step, ms per step as the mean, after the first and as the median of
     the intervals between CUDA events recorded after each step, the peak
     device memory; the first step's loss and the mean of the
     last 200, which must be below it; the bakes' kernel launches; TF32
     must stay off); one step's loss and gradients from the trained
     weights on the card and on the CPU (loss within 1e-5, gradients
     within 1e-3 of their layer's largest); save_net, load_net bit for
     bit; evaluate with learned_denoise(net=) (noisy / guided / learned
     log-RMSE, learned below guided at 1 spp); make_denoise_eval on
     BoxTest at 64^2 into a temporary directory, read back.

BOUND: the least time the card could take, the larger of the bytes moved
(each input read once, each output written once) over 3.35 TB/s (NVIDIA H100
SXM data sheet) and the f32 operations over 33.5 T operations/s. The data
sheet's 67 TFLOP/s counts a fused multiply-add as two operations; the
traversal kernel is built --fmad=false (every product rounded on its own, as
the reference rounds it), so it cannot fuse, and its slab and
Moller-Trumbore work is subtractions, products, min/max and comparisons:
one f32 operation per lane per clock, 132 SMs x 128 lanes x 1.98 GHz. A
traversal class moves its rays (45 B in, 16 B out each) and the distinct
512 B table rows its walk touches, and does SLAB_OPS per child slot of each
internal visit and MT_OPS per triangle of each leaf visit, every slot of
the record, as the kernel tests them (the script prints the share of those
operations that falls on empty slots: padding). A gather of n
rows of `width` words moves its distinct rows, its indices and its output:
(distinct*width + n + n*width)*4 B; beside it the script prints the time of
n*width*4*2 + n*4 B, every gathered row counted as a read from memory.

An alpha class adds to its bound the texture taps its walk takes: TAP_OPS
f32 operations and TAP_BYTES (four channel-0 texels) each. The plain walk
steps the active rays only (an inactive ray keeps t_max and tri id -1
without a step), so its time counts no inactive lane.

An engine kernel moves its rays (a packet or walk ray as the traversal
class's 45 B in and 16 B out; a grid ray 33 B in, 4 B of index and 4 B
out; a screened ray 33 B in and 1 B out) and, for packets and the grid,
the distinct 512 B records its walk touches, or the screen's columns; its
operations are what this run's data needs: SLAB_OPS per filled slot the
packet's mask allows and live ray (active, and in any-hit mode without a
hit yet) of each internal visit and MT_OPS per filled triangle and live
ray of each leaf visit; GRID_RAY_OPS per active grid ray, GRID_STEP_OPS per
record visit and PROXY_OPS per filled triangle of each tested record up to
the first blocking one; PROXY_OPS or CUT_OPS per column a lane tests up to
its first blocking triangle or overlapped box.

A revalidated lane moves its prediction, ray and outputs (50 B) and each
distinct predicted row (36 B); proxy_closest and the raster move their
rays (33 B in, 16 B out), the columns or pair lists and rows, and do
MT_OPS per triangle test they make (every column of an active lane; every
pair's triangle against its tile's active lanes).

The line before the last is {"kernels": [...]}: one entry per traversal
instantiation, one for the gather kernel and one for each engine kernel
(packet_closest, packet_any, sun_any_hit, proxy_blocked, cut_clear,
history_revalidate, proxy_closest, raster_closest_hit, and the split
alpha route's packet_closest_opaque, packet_any_opaque and
packet_candidates), whose `launches` count the main paths' runs (the
opaque frame, the alpha frames, the bake, the raster frames of R1 and R2,
the imported frames of F, the animation of AN, the viewer of I1-I3, E2's
frames and bake steps, S's routes, K's split routes, M's sharded steps and
T's bakes) and every one of which must be > 0, and one for the grid's alpha
instantiation (sun_any_hit_alpha), whose `launches` are phase A's check's:
no route sends sun rays to it, as no JAX caller passes the grid an
accept_fn (its ms, plain ms and bound are the two classes' sums); the last
is {"ok": true, "device": {...}}.
The CPU frames of K's, C's and R4's card-vs-CPU checks, the longest parts
of the run, render in three worker processes (spawned, two torch threads
each, at the lowest priority) from the end of K's timed runs on, while
the card goes on with the phases after (they are paused during R1, R2 and
I1-I3, whose host-bound frames they would slow); each check reads its
frames after phase I, and the workers are stopped however the run ends. Full results
also go to chiprun_out/chip_smoke.json. Exits non-zero, with no result
line, when there is no CUDA device or any phase fails. Imports no JAX.
"""

import contextlib
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAVERSE_SOURCE = "dxrpathtracer_tpu_torch/csrc/traverse.cu"
TRAVERSE_REPLACES = "dxrpathtracer_tpu/accel/pallas_body.py:52"
GATHER_SOURCE = "dxrpathtracer_tpu_torch/csrc/gather.cu"
GATHER_REPLACES = "tools/microbench_dma_gather.py:28"
# the traversal engines' kernels: (source, the JAX function it replaces)
ENGINE_KERNELS = {
    "packet_closest": ("dxrpathtracer_tpu_torch/csrc/packet.cu",
                       "dxrpathtracer_tpu/accel/packet.py:58"),
    "packet_any": ("dxrpathtracer_tpu_torch/csrc/packet.cu",
                   "dxrpathtracer_tpu/accel/packet.py:58"),
    "sun_any_hit": ("dxrpathtracer_tpu_torch/csrc/sungrid.cu",
                    "dxrpathtracer_tpu/accel/sunspace.py:267"),
    "proxy_blocked": ("dxrpathtracer_tpu_torch/csrc/screen.cu",
                      "dxrpathtracer_tpu/accel/proxy.py:154"),
    "cut_clear": ("dxrpathtracer_tpu_torch/csrc/screen.cu",
                  "dxrpathtracer_tpu/accel/proxy.py:346"),
    "history_revalidate": ("dxrpathtracer_tpu_torch/csrc/history.cu",
                           "dxrpathtracer_tpu/accel/history.py:50"),
    "proxy_closest": ("dxrpathtracer_tpu_torch/csrc/screen.cu",
                      "dxrpathtracer_tpu/accel/proxy.py:112"),
    "raster_closest_hit": ("dxrpathtracer_tpu_torch/csrc/swraster.cu",
                           "dxrpathtracer_tpu/render/swraster.py:360"),
    "packet_closest_opaque": ("dxrpathtracer_tpu_torch/csrc/packet.cu",
                              "dxrpathtracer_tpu/accel/packet.py:234"),
    "packet_any_opaque": ("dxrpathtracer_tpu_torch/csrc/packet.cu",
                          "dxrpathtracer_tpu/accel/packet.py:234"),
    "packet_candidates": ("dxrpathtracer_tpu_torch/csrc/packet.cu",
                          "dxrpathtracer_tpu/accel/packet.py:254"),
}
# the engines of phase S, which only their own routes launch
ROUTE_KERNELS = ("history_revalidate", "proxy_closest", "raster_closest_hit")
# Where and at what size the phases run: the card at full size. (A rehearsal
# on the CPU may shrink them; the card's run never does.)
DEVICE = "cuda"
FRAME_SIZE = (1920, 1080)
SAME_FRAME_SIZE = (240, 135)
# The CPU frames of C's, R4's and K's card-vs-CPU checks take the longest of
# the run: CPU_WORKERS spawned processes of CPU_WORKER_THREADS torch threads
# each render them while the card goes on with the next phases
CPU_WORKERS = 3
CPU_WORKER_THREADS = 2
BAKE_RES = 4096
MICROBENCH_ROWS, MICROBENCH_N = 32768, 1 << 20
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9  # no FMA: one f32 operation/lane/clock
# f32 operations of csrc/traverse.cu per child slot of an internal visit:
# 6 subtractions and 6 products (slabs), 6 min/max for t_near and 6 for
# t_far, and 3 comparisons (bounds valid, t_near <= t_far, nearest key).
SLAB_OPS = 27
# ... and per triangle of a leaf visit (Moller-Trumbore): p = d x e2 (9),
# det (5), |det| test (2), 1/det (2), s = o - v0 (3), u (6), q = s x e1 (9),
# v (6), t (6), the five range tests with u + v (6) and the nearest key (1).
MT_OPS = 55
RAY_IN_BYTES = 45  # origin, direction, 1/direction, t_min, t_max, active
HIT_BYTES = 16     # t, tri_id, u, v
ROW_BYTES = 512    # one table record
# f32 operations of one alpha-test texture tap (csrc/traverse.cu
# alpha_accept): 1-u-v (2), the UV lerp (10), uv*size-0.5 (4), size to
# float (2), floor (2), fractions (2), to int (2), the three texel lerps (9)
# and the cutoff (1); its integer index arithmetic is not counted. It reads
# four channel-0 texels.
TAP_OPS = 34
TAP_BYTES = 16
# The engines' kernels: a screen's ray (origin, direction, t_min, t_max,
# active: 33 B) and verdict (1 B); the proxy's Moller-Trumbore without the
# nearest key (54 operations) and the cut's slab test with slack (29: 12
# for the six slab distances, 12 min/max, 3 for the slack, 2 for the
# compare); a grid step's three tail comparisons, a grid ray's 12 + 4 B
# (projection and index read, its 9 products and 6 sums, the floors and
# clips: 25 operations) and its 4 B of visibility.
SCREEN_RAY_BYTES = 34
PROXY_OPS = 54
CUT_OPS = 29
GRID_RAY_BYTES = 41
GRID_RAY_OPS = 25
GRID_STEP_OPS = 3
E_FRAMES = 10           # E2: frames after the first, per configuration
S_FRAMES = 10           # S: frames after the first, per route
E3_SIZE = (256, 128)    # E3: BoxTest card vs CPU, a packet-tileable size
ENGINE_FIELDS = ("enable_packet_traversal", "enable_sunspace_shadows",
                 "enable_sw_raster", "enable_dense_proxy", "enable_clear_cut")
PLAIN_CHUNK = 1 << 21  # rays per plain walk: its lockstep state stays small


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, repeat=1):
    """Mean device milliseconds of fn() over `repeat` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeat):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeat, out


def bound_ms(nbytes, ops=0):
    """(bound ms, "bytes" or "operations") by the BOUND rule above."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync():
    torch.cuda.synchronize()


_CPU_POOL = []


def _cpu_worker_init():
    # the lowest priority: the host work of the phases that run meanwhile
    # (the raster's depth-map rays, the viewer) goes first
    os.nice(19)
    torch.set_num_threads(CPU_WORKER_THREADS)


def _cpu_run(payload):
    fn, args = pickle.loads(payload)
    return fn(*args)


def cpu_submit(fn, *args):
    """fn(*args) in one of the CPU_WORKERS worker processes (spawned, so
    without the card's state), while this process goes on: the
    AsyncResult, whose get() returns fn's result or raises its error. The
    arguments are pickled by value here and now: the pool's own pickler
    would move their tensors into shared memory from its feeder thread,
    under the phases that read them meanwhile."""
    if not _CPU_POOL:
        import multiprocessing
        _CPU_POOL.append(multiprocessing.get_context("spawn").Pool(
            CPU_WORKERS, initializer=_cpu_worker_init))
    return _CPU_POOL[0].apply_async(_cpu_run, (pickle.dumps((fn, args)),))


@contextlib.contextmanager
def cpu_workers_paused():
    """The workers stopped inside (SIGSTOP, then SIGCONT): for the phases
    whose frames are timed on the host's clock and wait on its work (the
    raster's depth-map rays and froxels, the viewer's present), which the
    workers slow by a third even at the lowest priority."""
    import multiprocessing
    import signal
    workers = multiprocessing.active_children()
    for w in workers:
        os.kill(w.pid, signal.SIGSTOP)
    try:
        yield
    finally:
        for w in workers:
            os.kill(w.pid, signal.SIGCONT)


def stop_cpu_workers():
    for pool in _CPU_POOL:
        pool.terminate()
        pool.join()
    _CPU_POOL.clear()


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    """Builds the four native libraries at once (one compiler each)."""
    from concurrent.futures import ThreadPoolExecutor

    from dxrpathtracer_tpu_torch.accel import (bvh, gather, history, packet,
                                               proxy, sunspace, traverse)
    from dxrpathtracer_tpu_torch.render import swraster

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    jobs = {"traverse_s": traverse.kernel_library,
            "gather_s": gather.kernel_library,
            "packet_s": packet.kernel_library,
            "sungrid_s": sunspace.kernel_library,
            "screen_s": proxy.kernel_library,
            "history_s": history.kernel_library,
            "swraster_s": swraster.kernel_library,
            "sah_builder_s": bvh.sah_library,
            "lbvh_builder_s": bvh.lbvh_library}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
        secs = {k: f.result() for k, f in futures.items()}
    log(f"build (in parallel): traverse.cu (nvcc sm_90a) "
        f"{secs['traverse_s']:.2f} s, gather.cu (nvcc sm_90a) "
        f"{secs['gather_s']:.2f} s, packet.cu {secs['packet_s']:.2f} s, "
        f"sungrid.cu {secs['sungrid_s']:.2f} s, screen.cu "
        f"{secs['screen_s']:.2f} s, history.cu {secs['history_s']:.2f} s, "
        f"swraster.cu {secs['swraster_s']:.2f} s, sah_builder.cpp (g++) "
        f"{secs['sah_builder_s']:.2f} s, lbvh_builder.cpp (g++) "
        f"{secs['lbvh_builder_s']:.2f} s")
    for line in gather.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas gather: {line.strip()}")
    kernels = ptxas_report(traverse.BUILD_LOG)
    for key, row in sorted(kernels.items()):
        row["resident_warps_per_sm"] = traverse.resident_warps(*key)
        log(f"  traverse {instance_name(key)}: "
            + ", ".join(f"{k} {v}" for k, v in row.items()))
        if key[0] == 32 and not key[2] and (row["stack_frame_bytes"]
                                            or row["spill_stores"]
                                            or row["spill_loads"]):
            raise SystemExit(f"chip_smoke: the W32 traversal kernel uses "
                             f"local memory: {row}")
    if sorted(kernels) != INSTANCES:
        raise SystemExit(f"chip_smoke: ptxas reported traversal kernels "
                         f"{sorted(kernels)}")
    secs["traverse_kernels"] = {instance_name(k): row
                                for k, row in kernels.items()}
    engines = {}
    warps = engine_resident_warps(packet, sunspace, proxy)
    warps["history_revalidate"] = history.resident_warps()
    warps["raster_closest_hit"] = swraster.resident_warps()
    warps["sun_any_hit_alpha"] = sunspace.resident_warps(True)
    warps["packet_closest_opaque"] = packet.resident_warps(False)
    warps["packet_any_opaque"] = packet.resident_warps(True)
    for k in range(1, packet.MAX_CANDS + 1):
        warps[f"packet_candidates_k{k}"] = packet.resident_warps(False, k)
    for lib in (packet, sunspace, proxy, history, swraster):
        for name, row in ptxas_entries(lib.BUILD_LOG).items():
            if name in warps:
                row["resident_warps_per_sm"] = warps[name]
            engines[name] = row
            log(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in row.items()))
            # one warp per packet: the stack lives in registers; the grid
            # walk keeps its rays and records in registers (the K-candidate
            # walk's and the grid's alpha instantiation's figures are
            # reported, not held)
            if ((name.startswith("packet") and "candidates" not in name)
                    or name == "sun_any_hit") and (
                    row["stack_frame_bytes"] or row["spill_stores"]
                    or row["spill_loads"]):
                raise SystemExit(f"chip_smoke: the {name} kernel uses local "
                                 f"memory: {row}")
    want = {"packet_closest", "packet_any", "sun_any_hit",
            "sun_any_hit_alpha", "proxy_blocked",
            "cut_clear", *ROUTE_KERNELS, "packet_closest_opaque",
            "packet_any_opaque",
            *(f"packet_candidates_k{k}"
              for k in range(1, packet.MAX_CANDS + 1))}
    if set(engines) != want:
        raise SystemExit(f"chip_smoke: ptxas reported engine kernels "
                         f"{sorted(engines)}, want {sorted(want)}")
    secs["engine_kernels"] = engines
    return secs


def engine_resident_warps(packet, sunspace, proxy):
    """{kernel: warps one SM holds at once} of the packet kernels, the grid
    walk and the screens (the proxy at PROXY_K columns, the cut at CUT_C
    boxes), by the occupancy queries of csrc/packet.cu, csrc/sungrid.cu and
    csrc/screen.cu."""
    import ctypes
    plib, slib = packet.kernel_library(), proxy.kernel_library()
    plib.dxrpt_packet_resident_warps.argtypes = [ctypes.c_int32]
    slib.dxrpt_screen_resident_warps.argtypes = [ctypes.c_int32,
                                                 ctypes.c_int32]
    out = {"packet_closest": plib.dxrpt_packet_resident_warps(0),
           "packet_any": plib.dxrpt_packet_resident_warps(1),
           "sun_any_hit": sunspace.resident_warps(),
           "proxy_blocked": slib.dxrpt_screen_resident_warps(
               1, proxy.PROXY_K),
           "proxy_closest": slib.dxrpt_screen_resident_warps(
               2, proxy.PROXY_K),
           "cut_clear": slib.dxrpt_screen_resident_warps(0, proxy.CUT_C)}
    if min(out.values()) <= 0:
        raise SystemExit(f"chip_smoke: occupancy queries failed: {out}")
    return out


def ptxas_entries(log_text):
    """{kernel: registers, stack frame and spills} of the engines' kernels
    in nvcc's -Xptxas -v output (packet_kernel<first_hit, exclude_alpha,
    K> in its closest, any, opaque-only and K = 1..8 candidate
    instantiations, sungrid_kernel<alpha> opaque and alpha-tested,
    proxy_kernel, proxy_closest_kernel, cut_kernel, revalidate_kernel,
    raster_kernel)."""
    import re
    names = {"packet_kernelILb0ELb0ELi0E": "packet_closest",
             "packet_kernelILb1ELb0ELi0E": "packet_any",
             "packet_kernelILb0ELb1ELi0E": "packet_closest_opaque",
             "packet_kernelILb1ELb1ELi0E": "packet_any_opaque",
             **{f"packet_kernelILb0ELb0ELi{k}E": f"packet_candidates_k{k}"
                for k in range(1, 9)},
             "sungrid_kernelILb0E": "sun_any_hit",
             "sungrid_kernelILb1E": "sun_any_hit_alpha",
             # a build from before the alpha instantiation (engine_ab's
             # parent)
             "sungrid_kernelEPKf": "sun_any_hit",
             "proxy_kernel": "proxy_blocked",
             "proxy_closest_kernel": "proxy_closest",
             "cut_kernel": "cut_clear",
             "revalidate_kernel": "history_revalidate",
             "raster_kernel": "raster_closest_hit"}
    out, cur = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = next((v for k, v in names.items() if k in line), None)
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# (width, first_hit, alpha) of the traversal kernel's instantiations
INSTANCES = [(w, fh, a) for w in (8, 32) for fh in (False, True)
             for a in (False, True)]


def instance_name(key):
    width, first_hit, alpha = key
    return (f"W{width}_{'any' if first_hit else 'closest'}"
            + ("_alpha" if alpha else ""))


def ptxas_report(log_text):
    """{(width, first_hit, alpha): registers, stack frame and spills} of each
    traversal kernel instantiation in nvcc's -Xptxas -v output (warp_kernel
    walks W32 tables, thread_kernel W8)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\S*(warp|thread)_kernelILb"
                      r"([01])ELb([01])E", line)
        if m:
            cur = (32 if m.group(1) == "warp" else 8, m.group(2) == "1",
                   m.group(3) == "1")
            out[cur] = {}
            continue
        if "Compiling entry function" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def plain_walk(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha=None,
               counts=None):
    """traverse_plain over the active rays, in chunks of PLAIN_CHUNK (each
    ray's walk is its own, so the chunks give the whole call's hits; an
    inactive ray's walk takes no step and keeps t = t_max, tri id -1,
    u = v = 0); with `counts`, adds every chunk's walk_counts to it instead
    and returns None."""
    from dxrpathtracer_tpu_torch.accel.traverse import (HitRecord,
                                                        traverse_plain)
    lanes = act.nonzero()[:, 0]
    parts = []
    for i in range(0, lanes.shape[0], PLAIN_CHUNK):
        sel = lanes[i:i + PLAIN_CHUNK]
        rays = (o[sel], d[sel], inv_d[sel], tmin[sel], tmax[sel], act[sel])
        if counts is None:
            parts.append(traverse_plain(bvh, *rays, first_hit, alpha))
            continue
        for k, v in walk_counts(bvh, first_hit, *rays, alpha).items():
            counts[k] = (counts[k] | v if k == "touched" else
                         counts[k] + v) if k in counts else v
    if counts is not None:
        counts.setdefault("touched", torch.zeros(
            bvh.num_rows, dtype=torch.bool, device=o.device))
        for k in ("internal", "leaf", "slots", "tris"):
            counts.setdefault(k, 0)
        return None
    n = o.shape[0]
    out = HitRecord(t=tmax.clone(),
                    tri_id=torch.full((n,), -1, dtype=torch.int32,
                                      device=o.device),
                    u=torch.zeros(n, device=o.device),
                    v=torch.zeros(n, device=o.device))
    for f in ("t", "tri_id", "u", "v"):
        if parts:
            getattr(out, f)[lanes] = torch.cat([getattr(p, f) for p in parts])
    return out


def ray_classes(sess):
    """The traversal calls of one 1080p sample, its rays made on the plain
    route: {name: (bvh, first_hit, o, d, t_min, t_max, active, alpha)},
    where alpha is the alpha test or None (a name ends in _alpha then)."""
    from dxrpathtracer_tpu_torch.accel.traverse import safe_inv
    from dxrpathtracer_tpu_torch.render import integrator as it

    s, dev = sess.settings, sess.device
    w, h = sess.width, sess.height
    frame = sess.frame_constants(0)
    o, d, length, pix = it.raygen(s, frame, w, h, dev)
    alpha = it._make_alpha_test(sess.scene, s)

    def plain(bvh, first_hit, o, d, tmin, tmax, act, a):
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(o.shape[0]).contiguous()
        return plain_walk(bvh, first_hit, o, d, safe_inv(d), tmin, tmax,
                          act, a)

    def name(depth, kind, table, a):
        return (f"d{depth}_{kind}_W{table.width}"
                + ("_alpha" if a is not None else ""))

    out = {}
    n = w * h
    state = it._path_state0(o, d, length)
    for depth, flags in it._depth_schedule(s):
        table = sess.bvh if depth == 1 else sess.bvh_ray
        a = alpha if flags["use_any_hit"] else None
        args = (state["ray_o"], state["ray_d"], state["t_min"],
                state["t_max"], state["active"])
        out[name(depth, "closest", table, a)] = (table, False, *args, a)
        rec = plain(table, False, *args, a)
        state, reqs, mid = it._shade_vertex(
            sess.scene, sess.sky_cube, s, frame, depth, flags, state, rec,
            pix, n, 1, frame.curr_sample_idx)
        plan = it._shadow_plan(sess.scene, s, alpha is not None, flags)
        vis = [None] * len(reqs)
        for kind, tab, r, a, pos in it._shadow_calls(
                sess.bvh, sess.bvh_ray, alpha, depth, plan, reqs):
            out[name(depth, kind + "_any", tab, a)] = (tab, True, *r, a)
            v = torch.where(plain(tab, True, *r, a).hit, 0.0, 1.0)
            for j, i in enumerate(pos):
                vis[i] = v[j * n:(j + 1) * n]
        state = it._apply_vertex(s, sess.sky_cube, depth, flags, state, mid,
                                 vis)
    return out


def walk_counts(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha=None):
    """{internal and leaf visits, filled child slots and triangles of the
    visited records, the table rows touched (a mask), and with `alpha` the
    alpha test's candidates, texture taps and rejections} of the plain walk
    on these rays: traverse_plain's loop, counting as it steps. A slot is
    filled where its box is not inverted, a triangle where its tri id is
    >= 0; the rest are padding that the kernel tests all the same."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import LEAF_SIZE
    s = traverse.init_lanes(bvh, o, d, inv_d, tmin, tmax, act)
    done = bvh.num_rows
    # per row, read both ways: filled child slots, filled leaf triangles
    slots = sum((lo[0] <= hi[0]).sum(1) for lo, hi, *_ in
                traverse._child_banks(bvh, bvh.table))
    tris = (bvh.table[:, 9 * LEAF_SIZE:10 * LEAF_SIZE].view(torch.int32)
            >= 0).sum(1)
    zero = torch.zeros((), dtype=torch.int64, device=o.device)
    n = {k: zero.clone() for k in ("internal", "leaf", "slots", "tris")}
    tally = {}
    accept = None if alpha is None else counting_accept(alpha, tally)
    touched = torch.zeros(bvh.num_rows, dtype=torch.bool, device=o.device)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    it = 0
    while it < max_iters and bool((s.cur != done).any()):
        alive = s.cur != done
        is_leaf = alive & (s.cur < 0)
        is_int = alive & ~is_leaf
        row = torch.where(is_leaf, ~s.cur, s.cur)
        n["internal"] += is_int.sum()
        n["leaf"] += is_leaf.sum()
        n["slots"] += slots[row[is_int].long()].sum()
        n["tris"] += tris[row[is_leaf].long()].sum()
        touched[row[alive].long()] = True
        s = traverse.traverse_step_plain(bvh, s, first_hit, accept)
        it += 1
    return {**{k: int(v) for k, v in n.items()}, **tally,
            "touched": touched}


def counting_accept(alpha, tally):
    """accept_fn for the plain walk: `alpha`'s verdicts, adding to `tally`
    the candidates it is asked about (triangles that pass the geometric
    test), the texture taps among them (opacity-mapped ones) and the
    rejections."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.scene.types import TRI_SHADE_META

    def accept(tid, u, v):
        ok = alpha(tid, u, v)
        rows = alpha.tri_shade.index_select(0, torch.clamp_min(tid, 0).long())
        taps = rows.view(torch.int32)[:, TRI_SHADE_META
                                      + traverse._HAS_OPACITY] != 0
        for k, c in (("candidates", ok.numel()), ("taps", taps.sum()),
                     ("rejected", (~ok).sum())):
            tally[k] = tally.get(k, 0) + int(c)
        return ok
    return accept


def hit_mismatches(got, ref):
    """Lanes whose tri id, t, u or v differ in any bit."""
    bad = got.tri_id != ref.tri_id
    for f in ("t", "u", "v"):
        bad |= (getattr(got, f).view(torch.int32)
                != getattr(ref, f).view(torch.int32))
    return int(bad.sum())


def phase_kernel_vs_plain(sess, label="traversal, five classes",
                          classes=None):
    """Every traversal class of one 1080p sample of `sess` (or `classes`,
    as ray_classes gives them): the kernel against the plain walk, bit for
    bit, with times, counts and bounds. Returns (rows by class, max |err|,
    totals, the depth-1 closest hit ids, sums by kernel instantiation)."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import LEAF_SIZE
    results, max_err = {}, 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
             "ops_ms": 0.0, "filled_ops_ms": 0.0}
    by_instance = {}
    d1_hits = None
    if classes is None:
        classes = ray_classes(sess)
    for name, (bvh, first_hit, o, d, tmin, tmax, act, alpha) in \
            classes.items():
        o, d = o.contiguous(), d.contiguous()
        tmin = torch.as_tensor(tmin, dtype=torch.float32, device=o.device)
        tmin = tmin.expand(o.shape[0]).contiguous()
        tmax, act = tmax.contiguous(), act.contiguous()
        inv_d = traverse.safe_inv(d).contiguous()
        kernel = lambda: traverse._launch_kernel(bvh, o, d, inv_d, tmin, tmax,
                                                 act, first_hit, alpha)
        kernel()  # warm-up
        ms, got = cuda_ms(kernel, repeat=3)
        plain_ms, ref = cuda_ms(lambda: plain_walk(
            bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha))
        c = {}
        plain_walk(bvh, first_hit, o, d, inv_d, tmin, tmax, act, alpha, c)
        c["rows"] = int(c.pop("touched").sum())
        taps = c.get("taps", 0)
        n = int(o.shape[0])
        nbytes = (n * (RAY_IN_BYTES + HIT_BYTES) + c["rows"] * ROW_BYTES
                  + taps * TAP_BYTES)
        ops = (c["internal"] * bvh.width * SLAB_OPS
               + c["leaf"] * LEAF_SIZE * MT_OPS + taps * TAP_OPS)
        filled_ops = (c["slots"] * SLAB_OPS + c["tris"] * MT_OPS
                      + taps * TAP_OPS)
        b_ms, b_by = bound_ms(nbytes, ops)
        visits = c["internal"] + c["leaf"]
        row = {"rays": n, "active": int(act.sum()),
               "ms": ms, "plain_ms": plain_ms,
               "internal_visits": c["internal"], "leaf_visits": c["leaf"],
               "mvisits_per_s": visits / ms / 1e3,
               "slots_filled_per_internal": c["slots"] / max(c["internal"], 1),
               "tris_filled_per_leaf": c["tris"] / max(c["leaf"], 1),
               "rows_touched": c["rows"], "bytes": nbytes, "ops": ops,
               "padding_ops_share": 1.0 - filled_ops / max(ops, 1),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
               "mismatches": hit_mismatches(got, ref),
               "hits": int(ref.hit.sum())}
        if alpha is not None:
            row.update(candidates_per_ray=c.get("candidates", 0) / n,
                       taps_per_ray=taps / n,
                       rejected_per_ray=c.get("rejected", 0) / n,
                       taps=taps, rejected=c.get("rejected", 0))
        if first_hit:
            row["vis_mismatches"] = int((got.hit != ref.hit).sum())
            # the occluder ids (any_hit_rec), within `mismatches` too
            row["occluder_mismatches"] = int((got.tri_id != ref.tri_id).sum())
        elif d1_hits is None:
            d1_hits = got.tri_id
        both = got.hit & ref.hit
        if bool(both.any()):
            max_err = max([max_err] + [
                float((getattr(got, f) - getattr(ref, f))[both].abs().max())
                for f in ("t", "u", "v")])
        ok = row["mismatches"] == 0
        err = 0.0
        if bool(both.any()):
            err = max(float((getattr(got, f) - getattr(ref, f))[both].abs()
                            .max()) for f in ("t", "u", "v"))
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        total["bytes_ms"] += bound_ms(nbytes)[0]
        total["ops_ms"] += bound_ms(0, ops)[0]
        total["filled_ops_ms"] += bound_ms(0, filled_ops)[0]
        inst = by_instance.setdefault(
            (bvh.width, first_hit, alpha is not None),
            {"classes": [], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0})
        inst["classes"].append(name)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bytes_ms", bound_ms(nbytes)[0]),
                     ("ops_ms", bound_ms(0, ops)[0])):
            inst[k] += v
        inst["max_abs_err"] = max(inst["max_abs_err"], err)
        results[name] = row
        log(f"{name}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
        if not ok:
            raise SystemExit(f"chip_smoke: kernel and plain traversal "
                             f"disagree on {name}: {row}")
    total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations")
    for inst in by_instance.values():
        inst["bound_by"] = ("bytes" if inst["bytes_ms"] >= inst["ops_ms"]
                            else "operations")
    log(f"{label}: kernel {total['ms']:.3f} ms, plain "
        f"{total['plain_ms']:.1f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms'] * 100:.1f} % of the kernel's "
        f"time; bytes terms {total['bytes_ms']:.4f} ms, operations terms "
        f"{total['ops_ms']:.4f} ms, of which filled slots "
        f"{total['filled_ops_ms']:.4f} ms)")
    return results, max_err, total, d1_hits, by_instance


def phase_adversarial():
    """The kernel against the plain walk, bit for bit, on the adversarial
    cases (tools/traverse_cases.py) at W8 and W32, closest and any hit."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh
    from dxrpathtracer_tpu_torch.tools.traverse_cases import cases
    results = {}
    for case, (tris, rays) in cases().items():
        r = {f: torch.from_numpy(a).to(DEVICE) for f, a in rays.items()}
        inv_d = traverse.safe_inv(r["d"]).contiguous()
        args = (r["o"], r["d"], inv_d, r["tmin"], r["tmax"], r["active"])
        for width in (8, 32):
            bvh = build_bvh(*tris, width=width).to(DEVICE)
            for first_hit in (False, True):
                got = traverse._launch_kernel(bvh, *args, first_hit)
                ref = traverse.traverse_plain(bvh, *args, first_hit)
                name = f"{case}_W{width}_{'any' if first_hit else 'closest'}"
                row = {"rays": int(r["o"].shape[0]),
                       "active": int(r["active"].sum()),
                       "hits": int(ref.hit.sum()),
                       "zero_t_hits": int((ref.hit & (ref.t == 0)).sum()),
                       "mismatches": hit_mismatches(got, ref)}
                results[name] = row
                log(f"adversarial {name}: " + ", ".join(
                    f"{k}={v}" for k, v in row.items()))
                if row["mismatches"]:
                    raise SystemExit(f"chip_smoke: kernel and plain traversal "
                                     f"disagree on the adversarial case "
                                     f"{name}: {row}")
    results.update(phase_adversarial_alpha())
    return results


def phase_adversarial_alpha():
    """The alpha instantiations against the plain walk with the alpha test,
    bit for bit, on the alpha cases of tools/traverse_cases.py: W8 (with
    alpha flags) and W32, closest and any hit."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene
    from dxrpathtracer_tpu_torch.app.settings import AppSettings
    from dxrpathtracer_tpu_torch.render.integrator import _make_alpha_test
    from dxrpathtracer_tpu_torch.tools.traverse_cases import (
        alpha_case_scene, alpha_cases)
    results = {}
    for case, (meshes, mask, rays) in alpha_cases().items():
        scene = alpha_case_scene(meshes, mask)
        alpha = _make_alpha_test(scene.to(DEVICE), AppSettings())
        r = {f: torch.from_numpy(a).to(DEVICE) for f, a in rays.items()}
        inv_d = traverse.safe_inv(r["d"]).contiguous()
        args = (r["o"], r["d"], inv_d, r["tmin"], r["tmax"], r["active"])
        for width in (8, 32):
            bvh = build_bvh_for_scene(scene, width=width,
                                      flag_alpha=width == 8).to(DEVICE)
            for first_hit in (False, True):
                got = traverse._launch_kernel(bvh, *args, first_hit, alpha)
                ref = traverse.traverse_plain(bvh, *args, first_hit, alpha)
                c = plain_counts(bvh, first_hit, args, alpha)
                name = f"{case}_W{width}_{'any' if first_hit else 'closest'}"
                row = {"rays": int(r["o"].shape[0]),
                       "active": int(r["active"].sum()),
                       "hits": int(ref.hit.sum()),
                       "candidates": c.get("candidates", 0),
                       "taps": c.get("taps", 0),
                       "rejected": c.get("rejected", 0),
                       "mismatches": hit_mismatches(got, ref)}
                results[name] = row
                log(f"adversarial {name}: " + ", ".join(
                    f"{k}={v}" for k, v in row.items()))
                if row["mismatches"] or not row["candidates"]:
                    raise SystemExit(f"chip_smoke: alpha kernel and plain "
                                     f"traversal disagree on the adversarial "
                                     f"case {name}: {row}")
    return results


def plain_counts(bvh, first_hit, rays, alpha):
    counts = {}
    plain_walk(bvh, first_hit, *rays, alpha, counts)
    counts.pop("touched", None)
    return counts


def phase_main_path(smi):
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    (w, h), frames = FRAME_SIZE, 10
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    t0 = time.time()
    sess = RenderSession(settings, w, h, device=DEVICE)
    sync()
    init_s = time.time() - t0
    log(f"main path: init {init_s:.2f} s ({sess.scene.num_triangles} "
        f"triangles, W8 {sess.bvh.num_rows} rows, W32 "
        f"{sess.bvh_ray.num_rows} rows)")

    checks = phase_kernel_vs_plain(sess)

    first_s, dts, launches = timed_frames(sess, frames)
    accum = sess.accum
    if tuple(accum.shape) != (h, w, 3) or not bool(accum.isfinite().all()):
        raise SystemExit("chip_smoke: the accumulation is not a finite "
                         f"{h}x{w}x3 image")
    # the engines' route (the defaults): depth-1 closest and sun in packets,
    # depth-2 sun in the grid, the terminal rays proxy-screened; the cut
    # stays gated off on the stand-in
    check_launches("main path", launches, frames + 1, traverse=2,
                   packet_closest=1, packet_any=1, sun_any_hit=1,
                   proxy_blocked=1, cut_clear=0)
    if launches["row_gather"] < frames + 1:
        raise SystemExit(f"chip_smoke: {launches} kernel launches in "
                         f"{frames + 1} frames, want >= 1 gather per frame")
    med = statistics.median(dts)
    spread = (max(dts) - min(dts)) / med * 100.0
    mrays = w * h * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
    main = {"width": w, "height": h, "path_length": settings.max_path_length,
            "init_s": init_s, "first_frame_s": first_s,
            "ms_per_frame_median": med * 1e3, "spread_pct": spread,
            "frames": frames, "mrays_per_s": mrays,
            "kernel_launches": launches, "accum_mean": float(accum.mean()),
            "card": smi}
    log(f"main path: first frame {first_s:.3f} s; {med * 1e3:.2f} ms/frame "
        f"(median of {frames}, spread {spread:.1f}%), {mrays:.1f} Mrays/s; "
        f"kernel launches {launches}; accum mean {main['accum_mean']:.4f} "
        f"[{smi}]")
    return sess, main, checks, launches


def reset_launches():
    from dxrpathtracer_tpu_torch.accel import (gather, history, packet, proxy,
                                               sunspace, traverse)
    from dxrpathtracer_tpu_torch.render import swraster
    gather.KERNEL_LAUNCHES = 0
    traverse.KERNEL_LAUNCHES.clear()
    packet.KERNEL_LAUNCHES.update(closest=0, any=0, closest_opaque=0,
                                  any_opaque=0, candidates=0)
    sunspace.KERNEL_LAUNCHES = 0
    proxy.KERNEL_LAUNCHES.update(proxy_blocked=0, proxy_closest=0,
                                 cut_clear=0)
    history.KERNEL_LAUNCHES = 0
    swraster.KERNEL_LAUNCHES = 0


def read_launches():
    """The kernel launches since reset_launches: in all and by traversal
    instantiation, and each engine kernel's."""
    from dxrpathtracer_tpu_torch.accel import (gather, history, packet, proxy,
                                               sunspace, traverse)
    from dxrpathtracer_tpu_torch.render import swraster
    return {"traverse": sum(traverse.KERNEL_LAUNCHES.values()),
            "row_gather": gather.KERNEL_LAUNCHES,
            "traverse_by_instance": {
                instance_name(k): v
                for k, v in sorted(traverse.KERNEL_LAUNCHES.items())},
            "packet_closest": packet.KERNEL_LAUNCHES["closest"],
            "packet_any": packet.KERNEL_LAUNCHES["any"],
            "sun_any_hit": sunspace.KERNEL_LAUNCHES,
            "proxy_blocked": proxy.KERNEL_LAUNCHES["proxy_blocked"],
            "cut_clear": proxy.KERNEL_LAUNCHES["cut_clear"],
            "history_revalidate": history.KERNEL_LAUNCHES,
            "proxy_closest": proxy.KERNEL_LAUNCHES["proxy_closest"],
            "raster_closest_hit": swraster.KERNEL_LAUNCHES,
            "packet_closest_opaque": packet.KERNEL_LAUNCHES["closest_opaque"],
            "packet_any_opaque": packet.KERNEL_LAUNCHES["any_opaque"],
            "packet_candidates": packet.KERNEL_LAUNCHES["candidates"]}


def check_launches(label, launches, frames, traverse, **engines):
    """Fails unless `frames` frames launched exactly `traverse` per-ray
    traversals and the given launches of each engine kernel per frame."""
    want = {"traverse": traverse, **engines}
    got = {k: launches[k] for k in want}
    if any(got[k] != v * frames for k, v in want.items()):
        raise SystemExit(f"chip_smoke: {label}: launches {got} in {frames} "
                         f"frames, want per frame {want}")


def timed_frames(sess, frames):
    """The launch counts set to 0, a first frame, then `frames` frames, each
    synchronised: (first frame s, frame s, launches of all of them)."""
    reset_launches()
    t0 = time.time()
    sess.render_frame()
    sync()
    first_s = time.time() - t0
    dts = []
    for _ in range(frames):
        t0 = time.time()
        sess.render_frame()
        sync()
        dts.append(time.time() - t0)
    return first_s, dts, read_launches()


def phase_alpha(smi):
    """The slice's frame: SponzaAlpha-checker (tools/alpha_cases.py) at
    1080p, path length 3, benchmark mode. (A) its traversal classes with
    the alpha test at every depth, kernel against plain; (B) the frame at
    max_any_hit_path_length 1 and 3, 10 frames each."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.scene.registry import checker_mask
    from dxrpathtracer_tpu_torch.tools import alpha_cases
    (w, h), frames = FRAME_SIZE, 10
    t0 = time.time()
    scene, preset = alpha_cases.sponza_alpha_checker()
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3, max_any_hit_path_length=3)
    sess = RenderSession(settings, w, h, device=DEVICE, scene=scene,
                         preset=preset)
    sync()
    init_s = time.time() - t0
    log(f"alpha frame: init {init_s:.2f} s ({sess.scene.num_triangles} "
        f"triangles, {scene.num_lights} spot lights, W8 {sess.bvh.num_rows} "
        f"rows with alpha flags {sess.bvh.has_alpha_flags}, W32 "
        f"{sess.bvh_ray.num_rows} rows); the reference's foliage DDS is not "
        f"in the repository, the checker is bound "
        f"({float((checker_mask() < 0.35).mean()):.2f} of its texels "
        f"reject)")
    classes = ray_classes(sess)
    checks = phase_kernel_vs_plain(sess, "alpha traversal classes", classes)
    grid_alpha = phase_grid_alpha(sess, classes, smi)
    del classes

    runs = {}
    for any_hit_len in (1, 3):
        sess.settings = sess.settings.replace(
            max_any_hit_path_length=any_hit_len)
        first_s, dts, launches = timed_frames(sess, frames)
        accum = sess.accum
        if (tuple(accum.shape) != (h, w, 3)
                or not bool(accum.isfinite().all())):
            raise SystemExit("chip_smoke: the alpha accumulation is not a "
                             f"finite {h}x{w}x3 image")
        med = statistics.median(dts)
        spread = (max(dts) - min(dts)) / med * 100.0
        mrays = w * h * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
        per_frame = {k: v / (frames + 1) for k, v in
                     launches["traverse_by_instance"].items()}
        runs[f"max_any_hit_{any_hit_len}"] = {
            "first_frame_s": first_s, "ms_per_frame_median": med * 1e3,
            "ms_per_frame": [t * 1e3 for t in dts], "spread_pct": spread,
            "frames": frames, "mrays_per_s": mrays,
            "kernel_launches": launches,
            "traverse_launches_per_frame": per_frame,
            "accum_mean": float(accum.mean()), "card": smi}
        log(f"alpha frame, max_any_hit_path_length {any_hit_len}: first "
            f"frame {first_s:.3f} s; {med * 1e3:.2f} ms/frame (median of "
            f"{frames}, spread {spread:.1f}%), {mrays:.1f} Mrays/s (bench.py's "
            f"formula: no spot rays counted); traversal launches per frame "
            f"{per_frame}, gather launches {launches['row_gather']}; accum "
            f"mean {float(accum.mean()):.4f} [{smi}]")
        if any_hit_len == 1:
            # depth-1 rays alpha-tested (per ray); depth 2 opaque: its sun
            # in the grid, its spot and terminal rays proxy-screened
            check_launches("alpha frame, max_any_hit 1", launches,
                           frames + 1, traverse=6, packet_closest=0,
                           packet_any=0, sun_any_hit=1, proxy_blocked=2,
                           cut_clear=0)
        else:
            # every ray alpha-tested: no engine sees one
            check_launches("alpha frame, max_any_hit 3", launches,
                           frames + 1, traverse=7, packet_closest=0,
                           packet_any=0, sun_any_hit=0, proxy_blocked=0,
                           cut_clear=0)
    out = {"width": w, "height": h, "path_length": settings.max_path_length,
           "triangles": sess.scene.num_triangles,
           "spot_lights": scene.num_lights,
           "init_s": init_s, "runs": runs, "grid_alpha": grid_alpha}
    launches = [r["kernel_launches"] for r in runs.values()]
    return out, checks, launches, sess


def phase_grid_alpha(sess, classes, smi):
    """The grid kernel's alpha instantiation (sun_any_hit with the scene's
    AlphaTest) on the alpha-tested sun classes of `classes` (ray_classes of
    the SponzaAlpha-checker session at max_any_hit_path_length 3: d1 on W8,
    d2 on W32), through the session's grid: against its plain version
    (sun_any_hit_plain with the test as accept_fn) and against the per-ray
    alpha any hit of the class's table, 0 lanes that differ from either;
    with the opaque grid's verdict on the same rays (the lanes only
    rejected triangles block), the plain walk's candidates, taps and
    rejections, times and the bound (the grid's bytes and operations plus
    TAP_BYTES and TAP_OPS a tap). No route sends sun rays here (no JAX
    caller passes an accept_fn), so its launches are this check's."""
    from dxrpathtracer_tpu_torch.accel import sunspace, traverse
    from dxrpathtracer_tpu_torch.render import integrator as it
    grid = sess.update_sun_grid()
    alpha = it._make_alpha_test(sess.scene, sess.settings)
    if grid is None or alpha is None:
        raise SystemExit("chip_smoke: the alpha session has no sun grid or "
                         "no alpha test")
    launches0 = sunspace.ALPHA_KERNEL_LAUNCHES
    rows = {}
    for name, (table, _, o, d, tmin, tmax, act, a) in classes.items():
        if "_sun_any_" not in name or a is None:
            continue
        n = o.shape[0]
        rays = (o.contiguous(), d.contiguous(),
                torch.as_tensor(tmin, dtype=torch.float32,
                                device=o.device).expand(n).contiguous(),
                tmax.contiguous(), act.contiguous())
        stats, tally = {}, {}
        ref = sunspace.sun_any_hit_plain(
            grid, *rays, stats=stats,
            accept_fn=counting_accept(alpha, tally))
        kern = lambda r=rays: sunspace._launch_kernel(  # noqa: E731
            grid, *r, alpha=alpha)
        got = kern()
        walk = traverse.any_hit(table, *rays, alpha=alpha)
        opaque = sunspace._launch_kernel(grid, *rays)
        walk_ms, _ = cuda_ms(lambda r=rays, t=table: traverse.any_hit(
            t, *r, alpha=alpha), repeat=3)
        nbytes, ops = grid_work(stats, act)
        taps = tally.get("taps", 0)
        extra = {"rays": n, "active": int(act.sum()),
                 "records": grid.num_rows,
                 "mismatches_vs_plain": int((got != ref).sum()),
                 "max_abs_err": float((got - ref).abs().max()),
                 "vis_differ_vs_per_ray": int((got != walk).sum()),
                 "blocked": int((got == 0).sum()),
                 "blocked_opaque": int((opaque == 0).sum()),
                 "blocked_only_by_rejected": int(((opaque == 0)
                                                  & (got == 1)).sum()),
                 "candidates": tally.get("candidates", 0), "taps": taps,
                 "rejected": tally.get("rejected", 0),
                 "record_visits": stats["visits"],
                 "triangle_tests": stats["tri_tests"],
                 "rows_touched": int(stats["touched"].sum()),
                 "per_ray_alpha_walk_ms": walk_ms,
                 "per_ray_table": f"W{table.width}"}
        rows[name] = engine_row(
            f"{name} alpha grid", kern,
            lambda r=rays: sunspace.sun_any_hit_plain(grid, *r,
                                                      accept_fn=alpha),
            nbytes + taps * TAP_BYTES, ops + taps * TAP_OPS, extra,
            phase="A")
        rows[name]["bytes_ms"] = bound_ms(rows[name]["bytes"])[0]
        rows[name]["ops_ms"] = bound_ms(0, rows[name]["ops"])[0]
        if extra["mismatches_vs_plain"] or extra["vis_differ_vs_per_ray"]:
            raise SystemExit(f"chip_smoke: the grid's alpha instantiation "
                             f"on {name}: {extra}")
        if not extra["blocked_only_by_rejected"] or not taps:
            raise SystemExit(f"chip_smoke: {name}: the alpha test rejected "
                             f"no blocker ({extra})")
    if sorted(rows) != ["d1_sun_any_W8_alpha", "d2_sun_any_W32_alpha"]:
        raise SystemExit(f"chip_smoke: alpha sun classes {sorted(rows)}")
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    total.update(
        bound_by=("bytes" if total["bytes_ms"] >= total["ops_ms"]
                  else "operations"),
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        launches=sunspace.ALPHA_KERNEL_LAUNCHES - launches0)
    log(f"A grid alpha: {total['ms']:.4f} ms, plain "
        f"{total['plain_ms']:.1f} ms, bound {total['bound_ms']:.4f} ms "
        f"({total['bound_by']}), {total['launches']} launches [{smi}]")
    return {"classes": rows, "total": total}


def recorded_frame(dev, any_hit_len, size, inject=None):
    """One sample of C's alpha, spot-lit frame (SponzaAlpha-checker, path
    length 3, max_any_hit_path_length `any_hit_len`) at `size` on `dev`,
    every traversal call of it recorded: (seconds, accumulation on the
    CPU, [{"key": (first_hit, table width, alpha-tested, rays), "rays":
    (o, d, t_min, t_max, active), "out": results}], both on the CPU). With
    `inject` (the calls of another run), the alpha-tested calls on the W32
    table take that run's rays instead of their own."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.render import integrator as it
    from dxrpathtracer_tpu_torch.tools.alpha_cases import sponza_alpha_checker
    scene, preset = sponza_alpha_checker()
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3,
                           max_any_hit_path_length=any_hit_len)
    t0 = time.time()
    calls = []
    originals = it.closest_hit, it.any_hit

    def recording(fn, first_hit):
        def call(bvh, o, d, tmin, tmax, active=None, alpha=None):
            n, d_ = o.shape[0], o.device
            rays = [o, d] + [torch.as_tensor(x, dtype=torch.float32,
                                             device=d_).expand(n)
                             for x in (tmin, tmax)]
            rays.append(torch.ones(n, dtype=torch.bool, device=d_)
                        if active is None else active)
            key = (first_hit, bvh.width, alpha is not None, n)
            if inject is not None and alpha is not None and bvh.width == 32:
                other = inject[len(calls)]
                assert other["key"] == key, (other["key"], key)
                rays = [x.to(d_) for x in other["rays"]]
            out = fn(bvh, *rays, alpha=alpha)
            res = out if first_hit else torch.stack(
                [out.t, out.tri_id.view(torch.float32), out.u, out.v])
            calls.append({"key": key, "rays": [x.cpu() for x in rays],
                          "out": res.cpu()})
            return out
        return call

    it.closest_hit = recording(originals[0], False)
    it.any_hit = recording(originals[1], True)
    try:
        sess = RenderSession(settings, *size, device=dev, scene=scene,
                             preset=preset)
        sess.render_frame()
        return time.time() - t0, sess.accum.cpu(), calls
    finally:
        it.closest_hit, it.any_hit = originals


def call_differences(a, b, pixels):
    """Per traversal call of two recorded runs of `pixels` pixels: the lanes
    whose rays differ in any bit and the largest difference of an origin or
    direction component; the lanes whose results differ in any bit, and of
    those the lanes whose rays are bit-equal; the lanes whose hit differs
    (another triangle, or the other visibility). Returns (rows, per call
    the (pixels,) mask of pixels with a lane whose hit differs)."""
    rows, masks = [], []
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 \
        else x.to(torch.int32)
    for ca, cb in zip(a, b, strict=True):
        if ca["key"] != cb["key"]:
            raise SystemExit(f"chip_smoke: traversal calls differ: "
                             f"{ca['key']} and {cb['key']}")
        first_hit, width, alpha, n = ca["key"]
        ray_diff = torch.zeros(n, dtype=torch.bool)
        for x, y in zip(ca["rays"], cb["rays"]):
            diff = bits(x) != bits(y)
            ray_diff |= diff.reshape(n, -1).any(1)
        ray_abs = max(float((x - y).abs().max()) for x, y in
                      zip(ca["rays"][:2], cb["rays"][:2]))
        out_diff = bits(ca["out"]) != bits(cb["out"])
        if first_hit:
            hit_diff = out_diff
        else:
            hit_diff = out_diff[1]  # the triangle id
            out_diff = out_diff.any(0)
        masks.append(hit_diff.reshape(-1, pixels).any(0))
        rows.append({"call": f"{'any' if first_hit else 'closest'}_W{width}"
                     + ("_alpha" if alpha else ""), "rays": n,
                     "rays_differ": int(ray_diff.sum()),
                     "max_abs_ray_diff": ray_abs,
                     "results_differ": int(out_diff.sum()),
                     "results_differ_rays_equal":
                         int((out_diff & ~ray_diff).sum()),
                     "hits_differ": int(hit_diff.sum())})
    return rows, masks


def phase_same_alpha_frame():
    """C: the alpha, spot-lit frame at SAME_FRAME_SIZE on the card now and
    on the CPU in the workers: at max_any_hit_path_length 1 held at
    rel-RMSE <= 1e-4; at 2, the witness that the gap between the routes
    enters through the depth-2 rays and not through the kernel. Returns
    the check, a function that waits for the CPU frames and returns the
    readings."""
    card, cpu = {}, {}
    for any_hit_len in (1, 2):
        card[any_hit_len] = recorded_frame(DEVICE, any_hit_len,
                                           SAME_FRAME_SIZE)
        log(f"same alpha frame {SAME_FRAME_SIZE}, max_any_hit_path_length "
            f"{any_hit_len}, on {DEVICE}: {card[any_hit_len][0]:.2f} s")
        cpu[any_hit_len] = cpu_submit(recorded_frame, "cpu", any_hit_len,
                                      SAME_FRAME_SIZE)
    # the CPU route given the card's rays for its alpha-tested W32 calls
    # (the depth-2 closest, sun and spot rays)
    given = cpu_submit(recorded_frame, "cpu", 2, SAME_FRAME_SIZE, card[2][2])
    return lambda: same_alpha_frame_readings(card, cpu, given)


def same_alpha_frame_readings(card_runs, cpu_jobs, given_job):
    """C's readings, once the workers' CPU frames are in."""
    runs = {}
    for any_hit_len, job in cpu_jobs.items():
        secs, img, calls = job.get()
        log(f"same alpha frame {SAME_FRAME_SIZE}, max_any_hit_path_length "
            f"{any_hit_len}, on cpu (a worker): {secs:.2f} s")
        runs[any_hit_len, DEVICE] = card_runs[any_hit_len][1:]
        runs[any_hit_len, "cpu"] = img, calls
    out = {}
    got, ref = runs[1, DEVICE][0], runs[1, "cpu"][0]
    rel = rel_rmse(got, ref)
    exact = float((got == ref).float().mean())
    log(f"same alpha frame, max_any_hit_path_length 1: rel RMSE cuda "
        f"(kernel) vs cpu (plain) {rel:.3e}, {exact:.4f} of values "
        f"bit-equal")
    if not (rel <= 1e-4 and bool(got.isfinite().all())
            and float(ref.abs().max()) > 0):
        raise SystemExit(f"chip_smoke: kernel alpha frame differs from the "
                         f"plain frame (rel RMSE {rel:.3e})")
    out["max_any_hit_1"] = {"rel_rmse": rel, "bit_equal_fraction": exact}

    # max_any_hit_path_length 2: the routes compared call by call, then the
    # CPU route given the card's rays for its alpha-tested W32 calls
    (card, card_calls), (cpu, cpu_calls) = runs[2, DEVICE], runs[2, "cpu"]
    secs, given, _ = given_job.get()
    log(f"same alpha frame, max_any_hit_path_length 2, on cpu (a worker) "
        f"with the card's depth-2 rays: {secs:.2f} s")
    w, h = SAME_FRAME_SIZE
    calls, hit_masks = call_differences(card_calls, cpu_calls, w * h)
    for row in calls:
        log("  card vs cpu " + ", ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
    scale = float(card.abs().max())
    reading = {}
    for name, img in (("cpu", cpu), ("cpu_given_card_depth2_rays", given)):
        off = ((img - card).abs().amax(-1) > 1e-3 * scale).reshape(-1)
        # each pixel that is off, with the calls in which one of its lanes
        # hit another triangle or got the other visibility
        pixels = [{"x": int(p) % w, "y": int(p) // w,
                   "calls_whose_hit_differs": [
                       f"{i}:{calls[i]['call']}"
                       for i, m in enumerate(hit_masks) if bool(m[p])]}
                  for p in off.nonzero()[:, 0][:8]]
        reading[name] = {
            "rel_rmse": rel_rmse(img, card),
            "bit_equal_fraction": float((img == card).float().mean()),
            "pixels_off_by_1e-3_of_max": int(off.sum()),
            "pixels_off": pixels}
        log(f"same alpha frame, max_any_hit_path_length 2: cuda (kernel) vs "
            f"{name}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                    else f"{k} {v}"
                                    for k, v in reading[name].items()))
    unexplained = sum(r["results_differ_rays_equal"] for r in calls)
    if (unexplained or reading["cpu_given_card_depth2_rays"]["rel_rmse"]
            > 1e-4 or reading["cpu"]["rel_rmse"] > 1e-4):
        raise SystemExit(f"chip_smoke: at max_any_hit_path_length 2, "
                         f"{unexplained} traversal lanes differ on bit-equal "
                         f"rays, or the frames differ: {reading}")
    out["max_any_hit_2"] = {**reading, "calls": calls}
    return out


def phase_render_command(smi):
    """`python -m dxrpathtracer_tpu_torch render` on the card, as a user
    runs it; its EXR against the same samples rendered here."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.render.film import read_exr
    w, h = FRAME_SIZE
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    png, exr = (os.path.join(out_dir, f) for f in ("render.png",
                                                   "render.exr"))
    cmd = [sys.executable, "-m", "dxrpathtracer_tpu_torch", "render",
           "--current-scene", "Sponza", "--width", str(w), "--height", str(h),
           "--sqrt-num-samples", "2", "--output", png, "--save-hdr", exr]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    cmd_s = time.time() - t0
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the render command failed:\n"
                         f"{proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            log(f"render command: {line}")
    hdr, names = read_exr(exr)
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza,
                                     sqrt_num_samples=2), w, h)
    sess.render_to_completion()
    accum = sess.accum.cpu()
    got = torch.from_numpy(hdr)
    if names != ["R", "G", "B"] or tuple(got.shape) != (h, w, 3):
        raise SystemExit(f"chip_smoke: render.exr holds {names} "
                         f"{tuple(got.shape)}")
    rel = rel_rmse(got, accum)
    exact = float((got == accum).float().mean())
    # display_image at 1080p (bloom and the tone curve), CUDA events
    sess.display_image()
    disp_ms, disp = cuda_ms(sess.display_image, repeat=5)
    png_bytes = os.path.getsize(png)
    log(f"render command: {cmd_s:.1f} s; render.png {png_bytes} B, "
        f"render.exr vs the accumulation of the same 4 samples here: rel "
        f"RMSE {rel:.3e}, {exact:.4f} of values bit-equal; display_image "
        f"{disp_ms:.3f} ms at {w}x{h} [{smi}]")
    if rel > 1e-6 or not bool(disp.isfinite().all()) or png_bytes < 1000:
        raise SystemExit(f"chip_smoke: render command output wrong (EXR "
                         f"rel RMSE {rel:.3e}, PNG {png_bytes} B)")
    return {"command_s": cmd_s, "png_bytes": png_bytes, "exr_rel_rmse": rel,
            "exr_bit_equal_fraction": exact, "display_image_ms": disp_ms,
            "card": smi}


def phase_same_frame():
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    imgs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.time()
        sess = RenderSession(settings, *SAME_FRAME_SIZE, device=dev)
        sess.render_frame()
        imgs[dev] = sess.accum.cpu()
        log(f"same frame {SAME_FRAME_SIZE} on {dev}: "
            f"{time.time() - t0:.2f} s")
    ref, got = imgs["cpu"], imgs[DEVICE]
    rel = rel_rmse(got, ref)
    exact = float((got == ref).float().mean())
    log(f"same frame: rel RMSE cuda (kernel) vs cpu (plain) {rel:.3e}, "
        f"{exact:.4f} of values bit-equal")
    if not (rel <= 1e-4 and bool(got.isfinite().all())):
        raise SystemExit(f"chip_smoke: kernel frame differs from plain frame "
                         f"(rel RMSE {rel:.3e})")
    return {"rel_rmse": rel, "bit_equal_fraction": exact}


def rel_rmse(got, ref):
    return float(((got - ref) ** 2).mean().sqrt() / (ref.abs().max() + 1e-9))


def phase_bake(smi):
    """The bake main path, as `python -m dxrpathtracer_tpu_torch bake
    --current-scene Sponza --resolution 4096 --atlas pair` drives it."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.bake.baker import Baker
    res, steps = BAKE_RES, 3
    settings = AppSettings(current_scene=Scenes.Sponza)
    t0 = time.time()
    sess = RenderSession(settings, 8, 8)  # no device: the card
    if sess.device.type != DEVICE:
        raise SystemExit(f"chip_smoke: RenderSession defaulted to "
                         f"{sess.device}")
    init_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    baker = Baker(sess, resolution=res, atlas_mode="pair")
    covered = int((baker.surface_maps["position"][..., 3] > 0).sum())
    coverage = covered / (res * res)
    log(f"bake: session init {init_s:.2f} s; atlas "
        f"{baker.setup_s['atlas']:.3f} s, texel map "
        f"{baker.setup_s['texel_map']:.2f} s (host), surface maps "
        f"{baker.setup_s['surface_maps']:.3f} s; {covered} covered texels "
        f"({coverage * 100:.1f} %), {len(baker._row0)} slabs of "
        f"{baker._slab_rows} rows")
    if coverage < 0.5:
        raise SystemExit(f"chip_smoke: bake coverage {coverage:.3f} < 0.5")

    reset_launches()
    t0 = time.time()
    baker.bake_step()
    sync()
    first_s = time.time() - t0
    dts = []
    for _ in range(steps):
        t0 = time.time()
        baker.bake_step()
        sync()
        dts.append(time.time() - t0)
    launches = read_launches()
    per_step = {k: launches[k] / (steps + 1)
                for k in ("traverse", "row_gather", "sun_any_hit",
                          "proxy_blocked")}
    if not bool(baker.accum.isfinite().all()):
        raise SystemExit("chip_smoke: the bake accumulation is not finite")
    # every sun ray in the grid, opaque shadow rays proxy-screened; no
    # packets (hemisphere rays) and no cut
    if (min(launches["traverse"], launches["row_gather"],
            launches["sun_any_hit"], launches["proxy_blocked"]) == 0
            or launches["packet_closest"] + launches["packet_any"]
            + launches["cut_clear"]):
        raise SystemExit(f"chip_smoke: bake launches {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(dts)
    spread = (max(dts) - min(dts)) / med * 100.0
    mrays = covered * (1 + (settings.max_path_length - 1) * 2) / med / 1e6
    log(f"bake: first step {first_s:.3f} s; {med:.3f} s/step (median of "
        f"{steps}, spread {spread:.1f}%), {mrays:.1f} Mrays/s; launches per "
        f"step {per_step}; peak device memory {peak_gib:.2f} GiB [{smi}]")

    # denoisers on the 4096^2 lightmap (the learned net warms up on a crop:
    # weight load and cuDNN set-up)
    from dxrpathtracer_tpu_torch.render.learned_denoise import learned_denoise
    maps = baker.surface_maps
    learned_denoise(baker.lightmap()[:64, :64], maps["albedo"][:64, :64],
                    maps["normal"][:64, :64])
    denoise_ms = {}
    for mode in ("median", "guided", "learned"):
        sync()
        t0 = time.time()
        out = baker.denoised_lightmap(mode)
        sync()
        denoise_ms[mode] = (time.time() - t0) * 1e3
        if tuple(out.shape) != (res, res, 3) or not bool(out.isfinite().all()):
            raise SystemExit(f"chip_smoke: {mode} denoise is not a finite "
                             f"{res}x{res}x3 map")
    log(f"bake: denoise ms on {res}^2: " + ", ".join(
        f"{k} {v:.1f}" for k, v in denoise_ms.items()))
    out = {"resolution": res, "atlas": "pair",
           "path_length": settings.max_path_length,
           "sqrt_num_samples": settings.sqrt_num_samples,
           "session_init_s": init_s, "setup_s": baker.setup_s,
           "covered_texels": covered, "coverage": coverage,
           "slabs": len(baker._row0), "first_step_s": first_s,
           "step_s": dts, "step_s_median": med, "spread_pct": spread,
           "mrays_per_s": mrays, "kernel_launches": launches,
           "launches_per_step": per_step, "peak_memory_gib": peak_gib,
           "denoise_ms": denoise_ms,
           "lightmap_mean": float(baker.lightmap().mean()), "card": smi}
    return baker, out, launches


def gather_case(name, table, idx, repeat):
    from dxrpathtracer_tpu_torch.accel import gather
    got = gather._launch_kernel(table, idx)
    ref = gather.row_gather_plain(table, idx)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise SystemExit(f"chip_smoke: gather kernel differs from plain on "
                         f"{name}")
    err = float((got - ref).abs().max()) if len(idx) else 0.0
    ms, _ = cuda_ms(lambda: gather._launch_kernel(table, idx), repeat)
    plain_ms, _ = cuda_ms(lambda: gather.row_gather_plain(table, idx), repeat)
    library_ms, _ = cuda_ms(lambda: torch.index_select(table, 0, idx), repeat)
    n, width = int(idx.shape[0]), int(table.shape[1])
    distinct = int(torch.unique(idx).numel())
    # the table's rows that these indices touch are read once, the indices
    # once and the output written once
    b_ms, b_by = bound_ms(distinct * width * 4 + n * 4 + n * width * 4)
    row = {"rows": int(table.shape[0]), "n": n, "width": width,
           "dtype": str(table.dtype).replace("torch.", ""),
           "distinct_rows": distinct, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "mrows_per_s": n / ms / 1e3,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
           # every gathered row counted as read from memory
           "n_rows_bound_ms": bound_ms(n * width * 4 * 2 + n * 4)[0],
           "max_abs_err": err}
    log(f"gather {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()))
    return row


def phase_gather(frame_sess, d1_hits, baker):
    """Row-gather kernel against its plain version and index_select."""
    from dxrpathtracer_tpu_torch.accel.gather import row_gather
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = {}
    rows, n = MICROBENCH_ROWS, MICROBENCH_N
    for width in (32, 128):
        table = torch.randn((rows, width), generator=gen, device=DEVICE)
        idx = torch.randint(0, rows, (n,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        cases[f"a_microbench_w{width}"] = gather_case(
            f"(a) microbench width {width}", table, idx, repeat=20)
    shade_idx = torch.clamp_min(d1_hits, 0).to(torch.int32).contiguous()
    cases["b_shading_row"] = gather_case(
        "(b) shading row", frame_sess.scene.tri_shade, shade_idx, repeat=10)
    scene = baker.session.scene
    tri_map = torch.from_numpy(baker.texel_map[0].reshape(-1)).to(DEVICE)
    safe_tri = torch.clamp_min(tri_map, 0)
    corner = row_gather(scene.tri_idx, safe_tri)[:, 0].contiguous()
    mat = row_gather(scene.tri_material[:, None], safe_tri)[:, 0].contiguous()
    for name, table, idx in (("tri_idx", scene.tri_idx, safe_tri),
                             ("positions", scene.positions, corner),
                             ("uvs", scene.uvs, corner),
                             ("tri_material", scene.tri_material[:, None],
                              safe_tri),
                             ("packed_meta", scene.packed_meta, mat)):
        cases[f"c_surface_{name}"] = gather_case(
            f"(c) surface map {name}", table, idx, repeat=5)
    return cases


def phase_same_bake():
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.bake.baker import Baker
    settings = AppSettings(current_scene=Scenes.BoxTest)
    accums = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.time()
        baker = Baker(RenderSession(settings, 8, 8, device=dev),
                      resolution=64, atlas_mode="charts",
                      atlas_opts={"grid_cols": 512})
        for _ in range(2):
            baker.bake_step()
        accums[dev] = baker.accum.cpu()
        log(f"same bake BoxTest 64^2 x 2 on {dev}: {time.time() - t0:.2f} s")
    got, ref = accums[DEVICE], accums["cpu"]
    count_equal = bool(torch.equal(got[..., 3], ref[..., 3]))
    lm = lambda a: torch.where(a[..., 3:] > 0, a[..., :3]
                               / torch.clamp_min(a[..., 3:], 1.0), 0.0)
    rel = rel_rmse(lm(got), lm(ref))
    log(f"same bake: rel RMSE cuda (kernels) vs cpu (plain) {rel:.3e}, "
        f"validCount equal {count_equal}")
    if not (rel <= 1e-4 and count_equal and bool(got.isfinite().all())):
        raise SystemExit(f"chip_smoke: kernel bake differs from plain bake "
                         f"(rel RMSE {rel:.3e}, validCount equal "
                         f"{count_equal})")
    return {"rel_rmse": rel, "valid_count_equal": count_equal}

# ---------------------------------------------------------------------------
# Raster mode (EnableRayTracing=false)

RASTER_FRAMES = 10      # R1: frames after the first
RASTER_MODE_FRAMES = 3  # R2: frames after the first, per shadow mode
SHADOW_MODES = ("rays", "pcf", "evsm", "msm")
SAME_RASTER_MAP = 128   # R4's cascade map size (the spot maps are twice it)


def timed_raster_frames(sess, frames, mode):
    """The launch counts and the profiler set to 0, a first raster frame,
    then `frames` frames, each synchronised: (first frame s, frame s,
    launches of all of them, the last frame, the profiler's scope ms)."""
    from dxrpathtracer_tpu_torch.app.profiler import Profiler
    sess.profiler = Profiler(sess.device)
    reset_launches()
    t0 = time.time()
    img = sess.render_raster_frame(shadow_mode=mode)
    sync()
    first_s = time.time() - t0
    dts = []
    for _ in range(frames):
        t0 = time.time()
        img = sess.render_raster_frame(shadow_mode=mode)
        sync()
        dts.append(time.time() - t0)
    launches = read_launches()
    scopes = {k: v["avg"] * 1e3 for k, v in sess.profiler.stats().items()}
    h, w = sess.height, sess.width
    if tuple(img.shape) != (h, w, 3) or not bool(img.isfinite().all()) \
            or float(img.max()) <= 0.0:
        raise SystemExit(f"chip_smoke: the {mode} raster frame is not a "
                         f"finite, lit {h}x{w}x3 image: shape "
                         f"{tuple(img.shape)}, "
                         f"{int((~img.isfinite()).sum())} values not "
                         f"finite, max {float(img.nan_to_num().max())}")
    return first_s, dts, launches, img, scopes


def raster_run(label, sess, frames, mode, smi, want_per_frame):
    """One timed raster run; its traversal launches per frame must be
    `want_per_frame` ({instantiation: count}) and the gather must launch."""
    first_s, dts, launches, img, scopes = timed_raster_frames(sess, frames,
                                                              mode)
    med = statistics.median(dts)
    spread = (max(dts) - min(dts)) / med * 100.0
    per_frame = {k: v / (frames + 1) for k, v in
                 launches["traverse_by_instance"].items()}
    row = {"first_frame_s": first_s, "ms_per_frame_median": med * 1e3,
           "ms_per_frame": [t * 1e3 for t in dts], "spread_pct": spread,
           "frames": frames, "kernel_launches": launches,
           "traverse_launches_per_frame": per_frame, "scope_ms": scopes,
           "image_mean": float(img.mean()), "card": smi}
    log(f"{label}: first frame {first_s:.3f} s; {med * 1e3:.2f} ms/frame "
        f"(median of {frames}, spread {spread:.1f}%); traversal launches "
        f"per frame {per_frame}, gather launches {launches['row_gather']}; "
        "scopes (ms, profiler) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           sorted(scopes.items()))
        + f"; image mean {row['image_mean']:.4f} [{smi}]")
    if per_frame != {k: float(v) for k, v in want_per_frame.items()} \
            or launches["row_gather"] < frames + 1:
        raise SystemExit(f"chip_smoke: {label}: launches {launches}, want "
                         f"{want_per_frame} per frame and the gather")
    return row, launches


def phase_raster_opaque(smi):
    """R1: the opaque Sponza-class stand-in's raster frame at 1080p MSAA4x,
    sun shadows by rays (one primary closest-hit launch and one sun any-hit
    launch per frame, every subsample's rays in each)."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    w, h = FRAME_SIZE
    t0 = time.time()
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza), w, h,
                         device=DEVICE)
    sync()
    init_s = time.time() - t0
    row, launches = raster_run("R1 raster frame, opaque, rays", sess,
                               RASTER_FRAMES, "rays", smi,
                               {"W32_any": 1, "W32_closest": 1})
    return {"width": w, "height": h, "msaa": str(sess.settings.msaa_mode),
            "init_s": init_s, **row}, launches


def phase_raster_alpha(smi):
    """R2: SponzaAlpha-checker's raster frame at 1080p MSAA4x in the four
    shadow modes, every ray alpha-tested on the W32 table."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.tools.alpha_cases import sponza_alpha_checker
    w, h = FRAME_SIZE
    scene, preset = sponza_alpha_checker()
    t0 = time.time()
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza), w, h,
                         device=DEVICE, scene=scene, preset=preset)
    sync()
    init_s = time.time() - t0
    runs, launches = {}, []
    for mode in SHADOW_MODES:
        # rays: the primary rays, then the sun's and the four spots' shadow
        # rays (one launch); maps: the cascade depth rays, the spot depth
        # rays and the primary rays, all closest hit
        want = ({"W32_closest_alpha": 1, "W32_any_alpha": 2}
                if mode == "rays" else {"W32_closest_alpha": 3})
        runs[mode], l = raster_run(f"R2 raster frame, alpha, {mode}", sess,
                                   RASTER_MODE_FRAMES, mode, smi, want)
        launches.append(l)
    return sess, {"width": w, "height": h, "init_s": init_s,
                  "triangles": sess.scene.num_triangles,
                  "spot_lights": scene.num_lights, "runs": runs}, launches


@contextlib.contextmanager
def raster_calls(record):
    """Records every traversal call of the raster frames rendered inside:
    appends (first_hit, bvh, [o, d, t_min, t_max, active] as full tensors,
    alpha, the call's result) to `record`."""
    from dxrpathtracer_tpu_torch.render import raster, shadows
    originals = raster.closest_hit, raster.any_hit, shadows.closest_hit

    def recording(fn, first_hit):
        def call(bvh, o, d, tmin, tmax, active=None, alpha=None):
            n, dev = o.shape[0], o.device
            full = lambda x: torch.as_tensor(
                x, dtype=torch.float32, device=dev).expand(n).contiguous()
            rays = [o.contiguous(), d.contiguous(), full(tmin), full(tmax),
                    torch.ones(n, dtype=torch.bool, device=dev)
                    if active is None else active.contiguous()]
            out = fn(bvh, *rays, alpha=alpha)
            record.append((first_hit, bvh, rays, alpha, out))
            return out
        return call

    raster.closest_hit = recording(originals[0], False)
    raster.any_hit = recording(originals[1], True)
    shadows.closest_hit = recording(originals[2], False)
    try:
        yield
    finally:
        raster.closest_hit, raster.any_hit, shadows.closest_hit = originals


# R3's classes in the order a rays frame, then a pcf frame, make their calls
RASTER_CALLS = ("primary_closest", "sun_any", "spot_any",
                "cascade_depth_closest", "spot_depth_closest",
                "primary_closest")


def raster_classes(sess):
    """R3's ray classes: the traversal calls of a `rays` and a `pcf` raster
    frame of `sess`, as the frame makes them: {name: (bvh, first_hit, o, d,
    t_min, t_max, active, alpha)}. The pcf frame's primary rays are the
    rays frame's again."""
    record = []
    with raster_calls(record):
        sess.render_raster_frame(shadow_mode="rays")
        sess.render_raster_frame(shadow_mode="pcf")
    if len(record) != len(RASTER_CALLS):
        raise SystemExit(f"chip_smoke: {len(record)} traversal calls in a "
                         f"rays and a pcf raster frame, want "
                         f"{len(RASTER_CALLS)}")
    out = {}
    for name, (first_hit, bvh, rays, alpha, _) in zip(RASTER_CALLS, record):
        name = f"raster_{name}_W{bvh.width}" + ("_alpha" if alpha else "")
        out.setdefault(name, (bvh, first_hit, *rays, alpha))
    return out


RASTER_SAME_MODES = ("rays", "pcf")


def raster_same_frame(dev, mode, size):
    """R4's frame: SponzaAlpha-checker's raster frame in `mode` at `size`
    on `dev` (cascade maps SAME_RASTER_MAP^2), every traversal call of it
    recorded as recorded_frame records them: (seconds, image on the CPU,
    calls)."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.tools.alpha_cases import sponza_alpha_checker
    scene, preset = sponza_alpha_checker()
    t0 = time.time()
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza), *size,
                         device=dev, scene=scene, preset=preset)
    record = []
    with raster_calls(record):
        img = sess.render_raster_frame(
            shadow_mode=mode, shadow_map_size=SAME_RASTER_MAP).cpu()
    calls = [{
        "key": (fh, bvh.width, alpha is not None, rays[0].shape[0]),
        "rays": [x.cpu() for x in rays],
        "out": (res if fh else torch.stack(
            [res.t, res.tri_id.view(torch.float32), res.u, res.v])).cpu()}
        for fh, bvh, rays, alpha, res in record]
    return time.time() - t0, img, calls


def same_raster_cpu_frames():
    """R4's CPU frames, submitted to the workers (the longest of the run's
    CPU frames: they start well before R4's card frames)."""
    return {mode: cpu_submit(raster_same_frame, "cpu", mode, SAME_FRAME_SIZE)
            for mode in RASTER_SAME_MODES}


def phase_same_raster_frame(cpu_jobs):
    """R4: SponzaAlpha-checker's raster frame at SAME_FRAME_SIZE on the card
    now and on the CPU in the workers (`cpu_jobs`, same_raster_cpu_frames),
    in the rays and pcf modes: rel-RMSE <= 1e-4, and, as phase C does,
    every traversal call's rays and results recorded on both routes: no
    result may differ where the rays are bit-equal. Returns the check, a
    function that waits for the CPU frames and returns the readings."""
    card = {}
    for mode in RASTER_SAME_MODES:
        card[mode] = raster_same_frame(DEVICE, mode, SAME_FRAME_SIZE)
        log(f"same raster frame {SAME_FRAME_SIZE} {mode} on {DEVICE}: "
            f"{card[mode][0]:.2f} s")
    return lambda: same_raster_frame_readings(card, cpu_jobs)


def same_raster_frame_readings(card, cpu_jobs):
    """R4's readings, once the workers' CPU frames are in."""
    out = {}
    for mode in RASTER_SAME_MODES:
        secs, ref, ref_calls = cpu_jobs[mode].get()
        log(f"same raster frame {SAME_FRAME_SIZE} {mode} on cpu (a worker): "
            f"{secs:.2f} s")
        _, got, got_calls = card[mode]
        rel = rel_rmse(got, ref)
        exact = float((got == ref).float().mean())
        rows, _ = call_differences(got_calls, ref_calls, 1)
        for row in rows:
            log(f"  {mode} card vs cpu " + ", ".join(
                f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
        unexplained = sum(r["results_differ_rays_equal"] for r in rows)
        log(f"same raster frame, {mode}: rel RMSE cuda (kernels) vs cpu "
            f"(plain) {rel:.3e}, {exact:.4f} of values bit-equal; "
            f"{unexplained} traversal lanes differ on bit-equal rays")
        if not (rel <= 1e-4 and unexplained == 0
                and bool(got.isfinite().all()) and float(ref.max()) > 0):
            raise SystemExit(f"chip_smoke: kernel raster frame ({mode}) "
                             f"differs from the plain one (rel RMSE "
                             f"{rel:.3e}, {unexplained} lanes differ on "
                             f"bit-equal rays)")
        out[mode] = {"rel_rmse": rel, "bit_equal_fraction": exact,
                     "shadow_map_size": SAME_RASTER_MAP, "calls": rows}
    return out


def run_command(args, timeout=600):
    """`python -m dxrpathtracer_tpu_torch ARGS` on the card: its seconds."""
    cmd = [sys.executable, "-m", "dxrpathtracer_tpu_torch", *args]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    secs = time.time() - t0
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: {' '.join(args[:2])} failed:\n"
                         f"{proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            log(f"  {line}")
    return secs


def png_shape(path):
    """(height, width) of a PNG, from its IHDR chunk."""
    import struct
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit(f"chip_smoke: {path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def phase_raster_commands(smi):
    """R5: the raster-mode commands as a user runs them, on the card: a
    BoxTest bake into an .npz bundle, the lightmap-lit render from it, a
    pcf render with a torch.profiler trace, and uvviz."""
    import numpy as np
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = lambda f: os.path.join(out_dir, f)
    w, h = FRAME_SIZE
    size = ["--width", str(w), "--height", str(h)]
    secs = {}
    secs["bake"] = run_command(
        ["bake", "--current-scene", "BoxTest", "--resolution", "256",
         "--atlas", "pair", "--samples", "4", "--output",
         path("raster_lightmap.npz")])
    # the HDR frames (25 MB each) stay out of the output directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    hdr_path = lambda f: os.path.join(tmp, f)
    secs["render_lightmap"] = run_command(
        ["render", "--raster", "--lightmap", path("raster_lightmap.npz"),
         "--current-scene", "BoxTest", *size, "--output",
         path("raster_lightmap.png"), "--save-hdr",
         hdr_path("raster_lightmap.npy")])
    trace_dir = path("raster_trace")
    secs["render_pcf_trace"] = run_command(
        ["render", "--raster", "--shadow-mode", "pcf", "--profile-trace",
         trace_dir, "--current-scene", "Sponza", *size, "--output",
         path("raster_pcf.png"), "--save-hdr", hdr_path("raster_pcf.npy")])
    secs["uvviz"] = run_command(
        ["uvviz", "--current-scene", "BoxTest", "--resolution", "1024",
         "--atlas", "pairs", "--output", path("uvviz.png")])
    with np.load(path("raster_lightmap.npz")) as bundle:
        lm = bundle["lightmap"]
    checks = {"raster_lightmap.png": (h, w), "raster_pcf.png": (h, w),
              "uvviz.png": (1024, 1024)}
    for f, shape in checks.items():
        if png_shape(path(f)) != shape:
            raise SystemExit(f"chip_smoke: {f} is {png_shape(path(f))}, "
                             f"want {shape}")
    hdr = {f: np.load(hdr_path(f)) for f in ("raster_lightmap.npy",
                                             "raster_pcf.npy")}
    shutil.rmtree(tmp)
    trace = os.path.join(trace_dir, "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    bad = [f for f, a in hdr.items()
           if a.shape != (h, w, 3) or not np.isfinite(a).all()
           or a.max() <= 0]
    if bad or lm.shape != (256, 256, 3) or not np.isfinite(lm).all() \
            or kernels == 0:
        raise SystemExit(f"chip_smoke: raster command outputs wrong: {bad}, "
                         f"lightmap {lm.shape}, {kernels} kernel events in "
                         f"the trace")
    row = {"command_s": secs, "trace_bytes": os.path.getsize(trace),
           "trace_kernel_events": kernels,
           "lightmap_mean": float(lm.mean()),
           "lightmap_frame_mean": float(hdr["raster_lightmap.npy"].mean()),
           "pcf_frame_mean": float(hdr["raster_pcf.npy"].mean()),
           "card": smi}
    log("R5 raster commands: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items())
        + f"; PNGs of the right size, HDR frames finite; trace "
        f"{row['trace_bytes']} B with {kernels} kernel events [{smi}]")
    return row


# ---------------------------------------------------------------------------
# Repair of the card's camera rays: division by a Python number


def raygen_stages(settings, frame, w, h, dev, scalar_division):
    """render/integrator.raygen's steps, each kept: the CMJ jitter, the pixel
    positions, the NDC coordinates (dividing by a Python number as before
    the repair, or by a tensor on the device as math3.div does), the
    unprojected points and the camera rays."""
    from dxrpathtracer_tpu_torch.core import cmj
    from dxrpathtracer_tpu_torch.core.math3 import div, dot, sqrt
    f32 = torch.float32
    yy, xx = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    pixel_idx = torch.arange(h * w, dtype=torch.int64, device=dev)
    n = int(settings.sqrt_num_samples)
    jitter = cmj.sample_cmj_2d(frame.curr_sample_idx, n, n, pixel_idx)
    px = xx.reshape(-1) + jitter[..., 0]
    py = yy.reshape(-1) + jitter[..., 1]
    if scalar_division:
        ncd_x = px / (w * 0.5) - 1.0
        ncd_y = -(py / (h * 0.5) - 1.0)
    else:
        ncd_x = div(px, w * 0.5) - 1.0
        ncd_y = -(div(py, h * 0.5) - 1.0)
    ivp = frame.inv_view_projection

    def unproject(z):
        out = (ncd_x[..., None] * ivp[0] + ncd_y[..., None] * ivp[1]
               + z * ivp[2] + ivp[3])
        return out, out[..., :3] / out[..., 3:4]

    near_h, ray_start = unproject(0.0)
    far_h, ray_end = unproject(1.0)
    seg = ray_end - ray_start
    ray_len = sqrt(torch.clamp_min(dot(seg, seg), 1e-30))
    ray_dir = seg / ray_len[..., None]
    return {"jitter": jitter, "px": px, "py": py, "ncd_x": ncd_x,
            "ncd_y": ncd_y, "near_h": near_h, "far_h": far_h,
            "ray_start": ray_start, "ray_len": ray_len, "ray_dir": ray_dir}


def lanes_differ(a, b):
    """Lanes (rows) of two float tensors whose bits differ."""
    n = a.shape[0]
    return int((a.view(torch.int32) != b.view(torch.int32))
               .reshape(n, -1).any(1).sum())


def phase_division(smi):
    """Repair 2's check, on the frame's 1080p camera rays: raygen's steps
    on the card and on the CPU, bit for bit, with the NDC division by a
    Python number (as before the repair: ATen's CUDA divide multiplies by
    the reciprocal instead) and by a tensor on the device (the repair); and
    raygen itself, card against CPU."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.render.integrator import raygen
    w, h = FRAME_SIZE
    settings = AppSettings(current_scene=Scenes.BoxTest, benchmark_mode=True)
    sess = RenderSession(settings, w, h, device="cpu")
    frame = sess.frame_constants(0)
    out = {}
    for scalar in (True, False):
        card = raygen_stages(settings, frame.to(DEVICE), w, h, DEVICE, scalar)
        cpu = raygen_stages(settings, frame, w, h, "cpu", scalar)
        row = {k: lanes_differ(card[k].cpu(), cpu[k]) for k in card}
        out["python_number_divisor" if scalar else "device_divisor"] = row
        log(f"division check, NDC divided by "
            f"{'a Python number' if scalar else 'a tensor on the device'}: "
            f"lanes of {w * h} that differ card vs cpu: " + ", ".join(
                f"{k} {v}" for k, v in row.items()))
    got = raygen(settings, frame.to(DEVICE), w, h, DEVICE)
    ref = raygen(settings, frame, w, h, "cpu")
    mirror = raygen_stages(settings, frame, w, h, "cpu", False)
    out["raygen"] = {k: lanes_differ(g.cpu(), r) if g.is_floating_point()
                     else int((g.cpu() != r).sum())
                     for k, g, r in zip(("ray_start", "ray_dir", "ray_len",
                                         "pixel_idx"), got, ref)}
    log(f"division check: raygen card vs cpu, lanes that differ "
        f"{out['raygen']} [{smi}]")
    if not (torch.equal(mirror["ray_dir"], ref[1])
            and not any(out["device_divisor"].values())
            and not any(out["raygen"].values())):
        raise SystemExit(f"chip_smoke: the camera rays differ between the "
                         f"card and the CPU: {out}")
    return out


# ---------------------------------------------------------------------------
# F: scene import (an FBX written by tools/fbx_cases.py)

FBX_FRAMES = 10   # frames after the first


def phase_fbx(smi):
    """SponzaAlpha-checker written as FBX + DDS (tools/fbx_cases.py), then
    imported as a user does: load_scene(Sponza, asset_root=DIR) through the
    scene cache, and RenderSession(..., asset_root=DIR) at 1080p."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.scene import cache, registry
    from dxrpathtracer_tpu_torch.tools import fbx_cases
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fbx_")
    root = os.path.join(tmp, "assets")
    old_cache = os.environ.get("DXRPT_SCENE_CACHE")
    os.environ["DXRPT_SCENE_CACHE"] = os.path.join(tmp, "scene_cache")
    try:
        t0 = time.time()
        fbx = fbx_cases.sponza_alpha_fbx(root)
        write_s = time.time() - t0
        fbx_bytes = os.path.getsize(fbx)
        preset = registry.PRESETS[Scenes.Sponza]
        t0 = time.time()
        fresh = registry._load_fbx_scene_full(preset, root, strict=True)
        parse_s = time.time() - t0
        t0 = time.time()
        cache.store_cached_scene(str(fbx), preset, fresh)
        store_s = time.time() - t0
        t0 = time.time()
        scene, _ = registry.load_scene(Scenes.Sponza, strict=True,
                                       asset_root=root)
        hit_s = time.time() - t0
        same = all(torch.equal(getattr(scene, k).view(torch.uint8),
                               getattr(fresh, k).view(torch.uint8))
                   for k in ("positions", "normals", "uvs", "tangents",
                             "bitangents", "tri_idx", "tri_material",
                             "tri_shade", "texels", "texture_meta",
                             "packed_meta"))
        same &= torch.equal(scene.has_opacity, fresh.has_opacity) and all(
            torch.equal(getattr(scene.lights, k), getattr(fresh.lights, k))
            for k in ("position", "direction", "intensity"))
        cards = int(scene.has_opacity.sum())
        opacity_texels = int(scene.texture_meta[-1, 1] *
                             scene.texture_meta[-1, 2])
        log(f"F scene import: wrote {fbx_bytes} B of FBX in "
            f"{write_s:.2f} s; parse {parse_s:.2f} s, cache write "
            f"{store_s:.2f} s, cache hit {hit_s:.2f} s (byte-equal to the "
            f"parse: {same}); {scene.num_triangles} triangles, "
            f"{scene.num_lights} spot lights, {cards} opacity-mapped "
            f"materials, opacity map {opacity_texels} texels")
        if not (same and scene.num_triangles == 246_852
                and scene.num_lights == 4 and cards == 384
                and opacity_texels == 64 * 64):
            raise SystemExit("chip_smoke: the imported FBX scene is not the "
                             "one written")

        (w, h), frames = FRAME_SIZE, FBX_FRAMES
        settings = AppSettings(current_scene=Scenes.Sponza,
                               benchmark_mode=True, max_path_length=3,
                               max_any_hit_path_length=3)
        t0 = time.time()
        sess = RenderSession(settings, w, h, device=DEVICE, asset_root=root)
        sync()
        init_s = time.time() - t0
        checks = phase_kernel_vs_plain(sess, "F alpha traversal classes")
        sess.settings = sess.settings.replace(max_any_hit_path_length=1)
        first_s, dts, launches = timed_frames(sess, frames)
        accum = sess.accum
        if not bool(accum.isfinite().all()):
            raise SystemExit("chip_smoke: F frame not finite")
        check_launches("F frame", launches, frames + 1, traverse=6,
                       packet_closest=0, packet_any=0, sun_any_hit=1,
                       proxy_blocked=2, cut_clear=0)
        med = statistics.median(dts)
        spread = (max(dts) - min(dts)) / med * 100.0
        log(f"F frame (imported, 1080p, path length 3): init {init_s:.2f} s "
            f"(cache hit); first frame {first_s:.3f} s; {med * 1e3:.2f} "
            f"ms/frame (median of {frames}, spread {spread:.1f}%); launches "
            f"{launches['traverse_by_instance']} [{smi}]")

        imgs = {}
        for dev in (DEVICE, "cpu"):
            s = RenderSession(AppSettings(current_scene=Scenes.Sponza,
                                          benchmark_mode=True,
                                          max_path_length=3),
                              *SAME_FRAME_SIZE, device=dev, asset_root=root)
            s.render_frame()
            imgs[dev] = s.accum.cpu()
        rel = rel_rmse(imgs[DEVICE], imgs["cpu"])
        exact = float((imgs[DEVICE] == imgs["cpu"]).float().mean())
        log(f"F same frame {SAME_FRAME_SIZE}: rel RMSE cuda vs cpu "
            f"{rel:.3e}, {exact:.4f} of values bit-equal")
        if rel > 1e-4:
            raise SystemExit(f"chip_smoke: F frame card vs cpu {rel:.3e}")
    finally:
        if old_cache is None:
            os.environ.pop("DXRPT_SCENE_CACHE", None)
        else:
            os.environ["DXRPT_SCENE_CACHE"] = old_cache
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"fbx_bytes": fbx_bytes, "write_s": write_s, "parse_s": parse_s, "cache_write_s": store_s,
           "cache_hit_s": hit_s, "triangles": scene.num_triangles,
           "spot_lights": scene.num_lights, "session_init_s": init_s,
           "first_frame_s": first_s, "ms_per_frame": [t * 1e3 for t in dts],
           "ms_per_frame_median": med * 1e3, "spread_pct": spread,
           "kernel_launches": launches, "same_frame_rel_rmse": rel,
           "same_frame_bit_equal_fraction": exact, "card": smi}
    return out, checks, launches


# ---------------------------------------------------------------------------
# AN: dynamic geometry (the `animate` command's flow)

ANIM_FRAMES, ANIM_SPP = 24, 4   # the animate command's defaults
ANIM_CHECK_FRAMES = (0, 7)      # frames whose table is held to the host's
ANIM_SAME_THETA = 1.3           # the frame rendered on the card and the CPU


def phase_animate(smi):
    """The `animate` flow on the Sponza-class stand-in at 1080p, as the
    command runs it: per frame the scene rotated on the card, its W8 table
    built there, ANIM_SPP samples with every traversal class on that table;
    rotate, build and render ms by CUDA events. At ANIM_CHECK_FRAMES the
    table against the native morton build and build_table_numpy of the same
    vertices on the host, bit for bit; then the kernel against the plain
    walk on the last table's five classes; one frame at SAME_FRAME_SIZE on
    the card and on the CPU; and the command as a subprocess."""
    import importlib.util

    import numpy as np

    from dxrpathtracer_tpu_torch.accel import bvh as host_bvh
    from dxrpathtracer_tpu_torch.accel.device_build import (build_bvh_device,
                                                            lbvh_plan)
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.scene.animate import (rotate_scene_y,
                                                       triangle_vertices,
                                                       turntable_center,
                                                       turntable_geometry)
    w, h = FRAME_SIZE
    settings = AppSettings(current_scene=Scenes.Sponza)
    t0 = time.time()
    sess = RenderSession(settings, w, h, device=DEVICE)
    init_s = time.time() - t0
    t0 = time.time()
    plan = lbvh_plan(sess.scene.num_triangles)
    plan_s = time.time() - t0
    center = turntable_center(sess.scene_host.positions.numpy())
    base = sess.scene
    steps = {"rotate_ms": [], "build_ms": [], "render_ms": [],
             "frame_ms": []}
    tables = {}
    reset_launches()
    for f in range(ANIM_FRAMES):
        theta = np.float32(2.0 * np.pi * f / ANIM_FRAMES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        sync()
        t0 = time.time()
        ev[0].record()
        scene = rotate_scene_y(base, theta, center)
        ev[1].record()
        verts = triangle_vertices(scene)
        bvh = build_bvh_device(*verts, plan)
        ev[2].record()
        sess.use_geometry(scene, bvh)
        sess.render_to_completion(ANIM_SPP)
        sess.display_image()
        ev[3].record()
        sync()
        steps["frame_ms"].append((time.time() - t0) * 1e3)
        for k, (a, b) in (("rotate_ms", (0, 1)), ("build_ms", (1, 2)),
                          ("render_ms", (2, 3))):
            steps[k].append(ev[a].elapsed_time(ev[b]))
        if f in ANIM_CHECK_FRAMES:
            tables[f] = (bvh.table.cpu(), [v.cpu().numpy() for v in verts])
    launches = read_launches()
    if not bool(sess.accum.isfinite().all()):
        raise SystemExit("chip_smoke: animate frames not finite")
    # moved geometry: no grid, proxy or cut; the packets walk the frame's
    # table, the depth-2 rays walk it per ray
    check_launches("animate", launches, ANIM_FRAMES * ANIM_SPP, traverse=3,
                   packet_closest=1, packet_any=1, sun_any_hit=0,
                   proxy_blocked=0, cut_clear=0)
    e4 = animated_engines_ab(sess)
    checks = {}
    for f, (table, verts) in tables.items():
        t0 = time.time()
        native = host_bvh.build_bvh(*verts, mode="morton").table
        native_s = time.time() - t0
        t0 = time.time()
        host = torch.from_numpy(host_bvh.build_table_numpy(*verts)[0])
        numpy_s = time.time() - t0
        bits = lambda t: t.view(torch.int32)
        checks[f] = {"words_differ_native": int((bits(table)
                                                 != bits(native)).sum()),
                     "words_differ_numpy": int((bits(table)
                                                != bits(host)).sum()),
                     "native_build_s": native_s, "numpy_build_s": numpy_s}
    med = {k: statistics.median(v) for k, v in steps.items()}
    log(f"AN animate flow (Sponza-class, {w}x{h}, {ANIM_FRAMES} frames x "
        f"{ANIM_SPP} spp): init {init_s:.2f} s, plan {plan_s:.3f} s "
        f"({plan.num_rows} rows); medians: rotate {med['rotate_ms']:.3f} ms, "
        f"device build {med['build_ms']:.3f} ms, render "
        f"{med['render_ms']:.2f} ms, frame {med['frame_ms']:.2f} ms (host "
        f"clock); build ms {min(steps['build_ms']):.3f}-"
        f"{max(steps['build_ms']):.3f}; launches "
        f"{launches['traverse_by_instance']}; tables against the host's "
        f"{checks} [{smi}]")
    if any(c["words_differ_native"] or c["words_differ_numpy"]
           for c in checks.values()):
        raise SystemExit(f"chip_smoke: the device table differs from the "
                         f"host builds: {checks}")
    classes = phase_kernel_vs_plain(sess, "AN W8 classes on a device table")
    del sess, base, scene, bvh
    torch.cuda.empty_cache()

    # one frame on the card and on the CPU: the same table, bit for bit
    outs = {}
    for dev in (DEVICE, "cpu"):
        s = RenderSession(settings, *SAME_FRAME_SIZE, device=dev)
        sc, b = turntable_geometry(
            s.scene, np.float32(ANIM_SAME_THETA),
            turntable_center(s.scene_host.positions.numpy()),
            lbvh_plan(s.scene.num_triangles))
        s.use_geometry(sc, b)
        outs[dev] = (b.table.cpu(), s.render_to_completion(1).cpu())
    tables_equal = torch.equal(outs[DEVICE][0].view(torch.int32),
                               outs["cpu"][0].view(torch.int32))
    rel = rel_rmse(outs[DEVICE][1], outs["cpu"][1])
    log(f"AN same frame {SAME_FRAME_SIZE}, theta {ANIM_SAME_THETA}: tables "
        f"bit-equal {tables_equal}; rel RMSE cuda vs cpu {rel:.3e}")
    if not tables_equal or rel > 1e-4:
        raise SystemExit(f"chip_smoke: animated frame card vs cpu: tables "
                         f"equal {tables_equal}, rel RMSE {rel:.3e}")

    out_dir = os.path.join(ROOT, "chiprun_out", "animate")
    shutil.rmtree(out_dir, ignore_errors=True)
    pil = importlib.util.find_spec("PIL") is not None
    args = ["animate", "--current-scene", "Sponza", "--width", "480",
            "--height", "270", "--frames", "4", "--output", out_dir]
    if pil:
        args += ["--gif", os.path.join(out_dir, "turntable.gif")]
    command_s = run_command(args)
    for f in range(4):
        shape = png_shape(os.path.join(out_dir, f"frame_{f:03d}.png"))
        if shape != (270, 480):
            raise SystemExit(f"chip_smoke: animate frame {f} is {shape}")
    log(f"AN animate command: {command_s:.1f} s; 4 PNGs of 480x270"
        + (", and a GIF" if pil else "; PIL is not installed: no --gif"))
    out = {"width": w, "height": h, "frames": ANIM_FRAMES, "spp": ANIM_SPP,
           "triangles": plan.num_tris, "rows": plan.num_rows,
           "session_init_s": init_s, "plan_s": plan_s, "steps_ms": steps,
           "median_ms": med, "kernel_launches": launches,
           "table_checks": checks, "same_frame_tables_equal": tables_equal,
           "e4_engines_on_off": e4,
           "same_frame_rel_rmse": rel, "command_s": command_s,
           "pil_installed": pil, "card": smi}
    return out, classes, launches


# ---------------------------------------------------------------------------
# I: the interactive viewer (app/interactive.py)

VIEW_FRAMES = 8          # I1's accumulating frames
VIEW_RASTER_FRAMES = 3   # I1's raster frames
BAKE_VIEW_FRAMES = 4     # I2's bake frames
SAME_VIEW_SIZE = (240, 135)
CKPT_N, CKPT_M = 3, 2    # I5: samples before and after the checkpoint
VIEW_COMMAND = ["interactive", "--current-scene", "Sponza", "--width",
                "1920", "--height", "1080", "--script", "w:2,l:1,:4",
                "--max-frames", "8"]
VIEW_COMMAND_FRAMES = 7  # the script's frames: w:2 + l:1 + :4 (< 8)


def menu_edit(field, keys="l"):
    """Script steps: open the settings menu, move to `field`, press `keys`
    there, close the menu."""
    import dataclasses

    from dxrpathtracer_tpu_torch.app.settings import AppSettings
    names = [f.name for f in dataclasses.fields(AppSettings)
             if not isinstance(f.default, tuple)]
    return ([("o", 0)] + [("j", 0)] * names.index(field)
            + [(k, 0) for k in keys] + [("o", 0)])


class ViewerProbe:
    """Instruments an InteractiveApp while it runs: per frame its kind, its
    ms (the app's own frame_times) and its kernel launches; per present its
    host ms; per key its host seconds; after every path or raster frame a
    synchronous display_thumbnail of the accumulation the frame left; every
    thumbnail the present draws (the input of ansi_halfblock_frame), with
    the mode it was drawn in. Inside `with probe:` the app's terminal
    output goes to `probe.screen`, not to this script's output."""

    def __init__(self, app):
        self.app = app
        self.frames, self.presents, self.keys = [], [], []
        self.sync_thumbs, self.drawn = [], []
        self.screen = None
        render_one, present, handle_key = (app.render_one, app.present,
                                           app.handle_key)

        def render():
            kind = ("bake" if app.bake_mode else
                    "raster" if app.raster_mode else "path")
            before = read_launches()
            render_one()
            after = read_launches()
            self.frames.append({
                "kind": kind, "ms": app.frame_times[-1] * 1e3,
                **{k: after[k] - before[k] for k in (
                    "traverse", "row_gather", *ENGINE_KERNELS)}})
            if kind != "bake":
                cols = min(app.PRESENT_COLS, app.width)
                rows = min(app.PRESENT_ROWS, app.height)
                self.sync_thumbs.append(
                    app.session.display_thumbnail(cols, rows).cpu().numpy())

        def timed_present():
            t0 = time.perf_counter()
            present()
            self.presents.append((time.perf_counter() - t0) * 1e3)

        def timed_key(key):
            t0 = time.perf_counter()
            handle_key(key)
            self.keys.append((key, time.perf_counter() - t0))

        app.render_one, app.present, app.handle_key = (render, timed_present,
                                                      timed_key)

    def __enter__(self):
        import io

        from dxrpathtracer_tpu_torch.app import interactive
        self._ansi = interactive.ansi_halfblock_frame
        app, ansi = self.app, self._ansi

        def drawing(rgb8, *a, **kw):
            self.drawn.append((app.bake_mode, rgb8.copy()))
            return ansi(rgb8, *a, **kw)

        interactive.ansi_halfblock_frame = drawing
        self.screen = io.StringIO()
        self._redirect = contextlib.redirect_stdout(self.screen)
        self._redirect.__enter__()
        return self

    def __exit__(self, *exc):
        from dxrpathtracer_tpu_torch.app import interactive
        self._redirect.__exit__(*exc)
        interactive.ansi_halfblock_frame = self._ansi

    def run(self, script):
        """Each step through run_scripted; the sample index after each."""
        samples = []
        for step in script:
            self.app.run_scripted([step])
            samples.append(self.app.session.sample_idx)
        return samples

    def frame_stats(self, kind, frames=None):
        rows = [f for f in (self.frames if frames is None else frames)
                if f["kind"] == kind]
        return {"frames": len(rows),
                "ms_median": statistics.median(f["ms"] for f in rows),
                "ms": [f["ms"] for f in rows],
                "traverse_per_frame": sorted({f["traverse"] for f in rows}),
                "row_gather_per_frame": sorted({f["row_gather"]
                                                for f in rows})}


def phase_viewer(smi):
    """I1-I3 on one InteractiveApp on the card, its terminal frames
    presented into a buffer: the full-size scripted session, the bake
    window on BoxTest, three scene switches. Returns the results and the
    kernel launches of the three."""
    from dxrpathtracer_tpu_torch.app.interactive import InteractiveApp
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    w, h = FRAME_SIZE
    out_dir = os.path.join(ROOT, "chiprun_out", "interactive")
    os.makedirs(out_dir, exist_ok=True)
    for old in os.listdir(out_dir):
        if old.startswith("screenshot_"):
            os.remove(os.path.join(out_dir, old))
    reset_launches()
    t0 = time.time()
    app = InteractiveApp(AppSettings(current_scene=Scenes.Sponza), w, h,
                         display=True, device=DEVICE)
    sync()
    init_s = time.time() - t0
    probe = ViewerProbe(app)
    edit = menu_edit("roughness_scale")   # a restart-relevant field
    script = [(None, VIEW_FRAMES), ("w", 1), ("l", 1), ("]", 1), *edit,
              (None, 1), ("m", VIEW_RASTER_FRAMES), ("m", 1), ("p", 0)]
    want = [VIEW_FRAMES, 1, 1, 2, *([2] * (len(edit) - 2)), 0, 0, 1, 0, 1,
            1]
    cwd = os.getcwd()
    os.chdir(out_dir)   # the screenshot lands here
    try:
        with probe:
            got = probe.run(script)
            i1_frames = len(probe.frames)
            i1_drawn = [d for bake, d in probe.drawn if not bake]
            i1_screen = len(probe.screen.getvalue().encode())
            # I2: the bake window on BoxTest
            n_keys = len(probe.keys)
            probe.run([("1", 0)])
            probe.run([("b", 1)])
            bake_key_s = probe.keys[-1][1]
            probe.run([("v", 1)] * (BAKE_VIEW_FRAMES - 1))
            previews = {}
            side = min(app.PRESENT_ROWS, app.PRESENT_COLS,
                       app.baker.resolution)
            for i, name in enumerate(app.PREVIEWS):
                app.preview_idx = i
                previews[name] = app._bake_preview_thumb(side, side)
            baker = app.baker
            sources = {"accum": baker.accum,
                       "lightmap": baker.lightmap(),
                       "guided": baker.denoised_lightmap("guided"),
                       "median": baker.denoised_lightmap("median"),
                       **baker.surface_maps}
            # I3: scene switches
            switches = []
            for key in ("3", "4", "5"):
                probe.run([(key, 1)])
                sess = app.session
                switches.append({
                    "key": key, "scene": sess.preset.name,
                    "triangles": sess.scene.num_triangles,
                    "switch_s": probe.keys[-1][1],
                    "first_frame_ms": probe.frames[-1]["ms"],
                    "finite": bool(sess.accum.isfinite().all())})
            screen_bytes = len(probe.screen.getvalue().encode())
    finally:
        os.chdir(cwd)
    launches = read_launches()

    # I1 checks
    if got != want:
        raise SystemExit(f"chip_smoke: viewer sample indices {got}, want "
                         f"{want}")
    i1 = probe.frames[:i1_frames]
    path = probe.frame_stats("path", i1)
    raster = probe.frame_stats("raster", i1)
    for f in i1:
        # path frames: two per-ray walks, two packet walks, the grid and
        # the proxy (the engines' route); raster frames: rays only
        need = ({"traverse": 2, "row_gather": 1, "packet_closest": 1,
                 "packet_any": 1, "sun_any_hit": 1, "proxy_blocked": 1}
                if f["kind"] == "path" else {"traverse": 2, "row_gather": 1})
        if any(f[k] < v for k, v in need.items()):
            raise SystemExit(f"chip_smoke: viewer {f['kind']} frame "
                             f"launched {f}, want >= {need}")
    thumbs = probe.sync_thumbs[:sum(f["kind"] != "bake" for f in i1)]
    if len(i1_drawn) != len(thumbs) - 1:
        raise SystemExit(f"chip_smoke: viewer drew {len(i1_drawn)} "
                         f"thumbnails for {len(thumbs)} frames")
    for k, (drawn, ref) in enumerate(zip(i1_drawn, thumbs)):
        if drawn.shape != ref.shape or not (drawn == ref).all():
            raise SystemExit(f"chip_smoke: pipelined thumbnail {k} differs "
                             f"from the synchronous one")
    shots = [n for n in os.listdir(out_dir) if n.startswith("screenshot_")]
    if shots != ["screenshot_000.png"] or png_shape(
            os.path.join(out_dir, shots[0])) != (h, w):
        raise SystemExit(f"chip_smoke: viewer screenshots {shots}")
    present = statistics.median(probe.presents[:i1_frames])
    i1_res = {"init_s": init_s, "sample_idx": got, "path": path,
              "raster": raster, "present_ms_median": present,
              "thumbnails_checked": len(i1_drawn),
              "bytes_presented": i1_screen, "card": smi}
    # I2 checks
    bake = probe.frame_stats("bake")
    if bake["frames"] != BAKE_VIEW_FRAMES or min(
            bake["traverse_per_frame"]) < 1 or min(
            bake["row_gather_per_frame"]) < 1:
        raise SystemExit(f"chip_smoke: viewer bake frames {bake}")
    for name, src in sources.items():
        if not bool(src.isfinite().all()):
            raise SystemExit(f"chip_smoke: bake window {name} not finite")
    for name, th in previews.items():
        if th.shape != (side, side, 3) or th.dtype.name != "uint8":
            raise SystemExit(f"chip_smoke: preview {name} {th.shape} "
                             f"{th.dtype}")
    i2_res = {"resolution": baker.resolution,
              "triangles": baker.session.scene.num_triangles,
              "b_key_s": bake_key_s, "setup_s": baker.setup_s,
              "bake": bake, "previews": {
                  n: float(th.mean()) for n, th in previews.items()},
              "preview_side": side, "keys_s": probe.keys[n_keys:]}
    # I3 checks
    if not all(s["finite"] for s in switches):
        raise SystemExit(f"chip_smoke: scene switches {switches}")
    res = {"I1": i1_res, "I2": i2_res, "I3": switches,
           "bytes_presented": screen_bytes, "kernel_launches": launches}
    log(f"I1 viewer (Sponza-class stand-in {w}x{h}): init {init_s:.2f} s; "
        f"path {path['ms_median']:.2f} ms/frame (median of "
        f"{path['frames']}), raster {raster['ms_median']:.2f} ms/frame "
        f"(median of {raster['frames']}), present "
        f"{present:.3f} ms (median); the sample index as expected after "
        f"each of {len(script)} steps; launches per path "
        f"frame {path['traverse_per_frame']} traversal, "
        f"{path['row_gather_per_frame']} gather; per raster frame "
        f"{raster['traverse_per_frame']}, {raster['row_gather_per_frame']}; "
        f"{len(i1_drawn)} pipelined thumbnails byte-equal to synchronous "
        f"ones; {i1_screen} bytes presented [{smi}]")
    log(f"I2 bake window (BoxTest, {baker.resolution}^2): b {bake_key_s:.2f}"
        f" s (atlas {baker.setup_s['atlas']:.2f} s, texel map "
        f"{baker.setup_s['texel_map']:.3f} s, surface maps "
        f"{baker.setup_s['surface_maps']:.3f} s); {bake['ms_median']:.2f} "
        f"ms/bake frame (median of {bake['frames']}), launches per bake "
        f"frame {bake['traverse_per_frame']} traversal, "
        f"{bake['row_gather_per_frame']} gather; seven previews {side}^2 "
        f"finite [{smi}]")
    for s in switches:
        log(f"I3 key {s['key']}: {s['scene']} ({s['triangles']} triangles) "
            f"{s['switch_s']:.2f} s, first frame {s['first_frame_ms']:.1f} "
            f"ms, finite")
    return res, launches


def phase_viewer_same():
    """I4: one script on BoxTest at SAME_VIEW_SIZE through InteractiveApp
    on the card and on the CPU: equal sample indices and camera states,
    accumulations within rel-RMSE 1e-4 and thumbnails within 1 per channel
    after every step."""
    from dxrpathtracer_tpu_torch.app.interactive import InteractiveApp
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    script = [(None, 2), ("w", 1), ("j", 1),
              *menu_edit("max_path_length"), (None, 1), ("m", 1), ("m", 1)]
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.time()
        app = InteractiveApp(AppSettings(current_scene=Scenes.BoxTest),
                             *SAME_VIEW_SIZE, display=False, device=dev)
        cols = min(app.PRESENT_COLS, app.width)
        rows = min(app.PRESENT_ROWS, app.height)
        states = []
        for step in script:
            app.run_scripted([step])
            s = app.session
            states.append((s.sample_idx, s.camera.state_tuple(),
                           s.accum.cpu(),
                           s.display_thumbnail(cols, rows).cpu()))
        runs[dev] = states
        log(f"I4 on {dev}: {time.time() - t0:.2f} s")
    worst, differ = 0.0, 0
    for k, (got, ref) in enumerate(zip(runs[DEVICE], runs["cpu"])):
        if got[:2] != ref[:2]:
            raise SystemExit(f"chip_smoke: I4 step {k}: sample/camera "
                             f"{got[:2]} vs {ref[:2]}")
        rel = rel_rmse(got[2], ref[2])
        diff = (got[3].int() - ref[3].int()).abs()
        if not (rel <= 1e-4 and bool(got[2].isfinite().all())
                and int(diff.max()) <= 1):
            raise SystemExit(f"chip_smoke: I4 step {k}: rel RMSE {rel:.3e}, "
                             f"thumbnail off by {int(diff.max())}")
        worst = max(worst, rel)
        differ += int((diff > 0).sum())
    log(f"I4 same viewer session card vs cpu (BoxTest {SAME_VIEW_SIZE}, "
        f"{len(script)} steps): sample indices and cameras equal, worst rel "
        f"RMSE {worst:.3e}, {differ} thumbnail values differ by 1")
    return {"steps": len(script), "worst_rel_rmse": worst,
            "thumbnail_values_differing": differ}


def phase_viewer_checkpoint(smi):
    """I5: CKPT_N samples, checkpoint_state, restore_state into a new
    session, CKPT_M more: bit-equal to CKPT_N + CKPT_M samples of one
    session (the Sponza-class stand-in at FRAME_SIZE)."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    settings = AppSettings(current_scene=Scenes.Sponza)
    a = RenderSession(settings, *FRAME_SIZE, device=DEVICE)
    a.render_to_completion(CKPT_N)
    sync()
    t0 = time.time()
    state = a.checkpoint_state()
    ckpt_ms = (time.time() - t0) * 1e3
    whole = a.render_to_completion(CKPT_N + CKPT_M).cpu()
    b = RenderSession(settings, *FRAME_SIZE, device=DEVICE)
    t0 = time.time()
    b.restore_state(state)
    sync()
    restore_ms = (time.time() - t0) * 1e3
    for _ in range(CKPT_M):
        b.render_frame()
    resumed = b.accum.cpu()
    if b.sample_idx != CKPT_N + CKPT_M or not torch.equal(resumed, whole):
        raise SystemExit(f"chip_smoke: I5 resumed render differs (sample "
                         f"{b.sample_idx}, max diff "
                         f"{float((resumed - whole).abs().max()):.3e})")
    log(f"I5 checkpoint: {CKPT_N} + {CKPT_M} samples resumed in a new "
        f"session bit-equal to {CKPT_N + CKPT_M} uninterrupted; "
        f"checkpoint_state {ckpt_ms:.2f} ms, restore_state {restore_ms:.2f} "
        f"ms at {FRAME_SIZE[0]}x{FRAME_SIZE[1]} [{smi}]")
    return {"n": CKPT_N, "m": CKPT_M, "bit_equal": True,
            "checkpoint_ms": ckpt_ms, "restore_ms": restore_ms}


_HOT_RELOAD = r"""
import glob
import json
import os
import sys
import time

import torch

root, w, h = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import dxrpathtracer_tpu_torch as pkg
assert pkg.__file__.startswith(root), pkg.__file__
from dxrpathtracer_tpu_torch.accel import gather
from dxrpathtracer_tpu_torch.app.interactive import InteractiveApp
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes

app = InteractiveApp(AppSettings(current_scene=Scenes.Sponza), w, h,
                     display=False)
app.run_scripted([(None, 2)])
before = app.session.accum.clone()
launches_before = gather.KERNEL_LAUNCHES
build = os.path.join(root, "dxrpathtracer_tpu_torch", "build")
libs = set(glob.glob(os.path.join(build, "libgather_*.so")))
src = str(gather.KERNEL_SOURCE)
assert src.startswith(root), src
with open(src, "a") as f:
    f.write("\n// edited while the viewer runs\n")
st = os.stat(src)
os.utime(src, (st.st_atime, st.st_mtime + 2.0))
t0 = time.time()
reloaded = app.check_hot_reload(now=time.monotonic() + 2.0)
reload_s = time.time() - t0
g = sys.modules["dxrpathtracer_tpu_torch.accel.gather"]
t = sys.modules["dxrpathtracer_tpu_torch.accel.traverse"]
dropped = g._kernel is None and g.KERNEL_LAUNCHES == 0
restarted = app.session.sample_idx == 0
t0 = time.time()
g.kernel_library()
nvcc_s = time.time() - t0
new = sorted(set(glob.glob(os.path.join(build, "libgather_*.so"))) - libs)
app.run_scripted([(None, 2)])
after = app.session.accum
print(json.dumps({
    "reloaded": reloaded, "reload_s": reload_s, "nvcc_s": nvcc_s,
    "new_libraries": [os.path.basename(p) for p in new],
    "library_dropped": dropped, "restarted": restarted,
    "notice": app.reload_notice,
    "gather_launches_before": launches_before,
    "gather_launches_after": g.KERNEL_LAUNCHES,
    "traverse_launches_after": sum(t.KERNEL_LAUNCHES.values()),
    "bit_equal": bool(torch.equal(before, after)),
    "finite": bool(after.isfinite().all())}))
"""


def phase_hot_reload(smi):
    """I6: the package (with its build/ directory) copied to a temporary
    directory and imported there by a subprocess, which starts the viewer
    at FRAME_SIZE, renders 2 frames, appends a comment to the copy's
    csrc/gather.cu and polls the viewer's watcher: accel.gather and its
    dependents reload, a new hash-named library is built (nvcc's seconds),
    the accumulation restarts, and the next 2 frames equal the first 2 bit
    for bit. The repository's own files are never edited."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reload_")
    try:
        pkg = "dxrpathtracer_tpu_torch"
        shutil.copytree(os.path.join(ROOT, pkg), os.path.join(tmp, pkg),
                        ignore=shutil.ignore_patterns("__pycache__"))
        # what the package reads outside itself: the C++ sources of its
        # native BVH libraries (its data files are its own)
        shutil.copytree(os.path.join(ROOT, "native"),
                        os.path.join(tmp, "native"),
                        ignore=shutil.ignore_patterns("*.so"))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", _HOT_RELOAD, tmp, *map(str, FRAME_SIZE)],
            cwd=tmp, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=tmp))
        secs = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: I6 hot reload failed:\n"
                         f"{proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    need = {f"dxrpathtracer_tpu_torch.{m}" for m in (
        "accel.gather", "accel.traverse", "render.integrator",
        "app.session")}
    if not (need <= set(r["reloaded"]) and len(r["new_libraries"]) == 1
            and r["library_dropped"] and r["restarted"] and r["bit_equal"]
            and r["finite"] and r["gather_launches_after"] > 0
            and r["traverse_launches_after"] > 0):
        raise SystemExit(f"chip_smoke: I6 hot reload: {r}")
    r["subprocess_s"] = secs
    log(f"I6 hot reload (a copy of the package; csrc/gather.cu edited): "
        f"{len(r['reloaded'])} modules reloaded in {r['reload_s']:.2f} s, "
        f"new library {r['new_libraries'][0]} built by nvcc in "
        f"{r['nvcc_s']:.2f} s; the frames after bit-equal to the frames "
        f"before; gather launches {r['gather_launches_before']} before, "
        f"{r['gather_launches_after']} after the reload; {secs:.1f} s in "
        f"all [{smi}]")
    return r


def phase_crash_dump(smi):
    """I7: `bake --checkpoint F` with F a 32x32 accumulation on a 64^2 bake:
    Baker.restore_state raises; the command must exit non-zero and leave a
    crash dump with the card, the versions, the settings, the frame, the
    scene tables and the traceback of that ValueError."""
    import numpy as np
    out_dir = os.path.join(ROOT, "chiprun_out", "interactive")
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "bad_checkpoint.npz")
    dump = os.path.join(out_dir, "crash.json")
    if os.path.exists(dump):
        os.remove(dump)
    np.savez(ckpt, accum=np.zeros((32, 32, 4), np.float32), sample_index=3)
    proc = subprocess.run(
        [sys.executable, "-m", "dxrpathtracer_tpu_torch", "bake",
         "--current-scene", "BoxTest", "--resolution", "64", "--checkpoint",
         ckpt, "--output", os.path.join(out_dir, "never.png")], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, DXRPT_CRASH_DUMP=dump))
    if proc.returncode == 0 or not os.path.exists(dump):
        raise SystemExit(f"chip_smoke: I7 bake exited {proc.returncode}, "
                         f"dump {os.path.exists(dump)}")
    with open(dump) as f:
        rep = json.load(f)
    plat = rep["platform"]
    card = torch.cuda.get_device_name(0)
    ok = (plat.get("torch_version") == torch.__version__
          and plat.get("cuda_version") == torch.version.cuda
          and plat.get("devices") and plat["devices"][0]["name"] == card
          and plat.get("current_device") == 0
          and "BoxTest" in rep["settings"]["current_scene"]
          and rep["frame"]["scene"] == "BoxTest"
          and rep["scene_tables"]["num_triangles"] > 0
          and rep["traceback"][-1].startswith("ValueError")
          and "does not fit" in rep["traceback"][-1])
    if not ok:
        raise SystemExit(f"chip_smoke: I7 crash dump: {json.dumps(rep)[:3000]}")
    log(f"I7 crash dump: bake exited {proc.returncode}; {dump} names "
        f"{plat['devices'][0]['name']} (capability "
        f"{plat['devices'][0]['capability']}), torch "
        f"{plat['torch_version']}, CUDA {plat['cuda_version']}; the "
        f"settings, frame {rep['frame']}, scene tables "
        f"{rep['scene_tables']}; traceback ends "
        f"{rep['traceback'][-1].strip()!r}")
    return {"exit_code": proc.returncode, "frame": rep["frame"],
            "scene_tables": rep["scene_tables"], "platform": plat}


def phase_viewer_command(smi):
    """I8: the interactive command as a user runs it on the card."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dxrpathtracer_tpu_torch", *VIEW_COMMAND],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    secs = time.time() - t0
    import re
    m = re.search(r"(\d+) frames, mean ([\d.]+) ms/frame", proc.stderr)
    if proc.returncode != 0 or m is None or int(m.group(1)) != \
            VIEW_COMMAND_FRAMES:
        raise SystemExit(f"chip_smoke: I8 interactive exited "
                         f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    log(f"I8 `{' '.join(VIEW_COMMAND)}`: exit 0, {m.group(1)} frames, "
        f"mean {m.group(2)} ms/frame, {secs:.1f} s in all [{smi}]")
    return {"frames": int(m.group(1)), "mean_ms": float(m.group(2)),
            "command_s": secs}


def phase_interactive(smi):
    """Phase I: I1-I8. Returns the results and the kernel launches of the
    viewer's runs (I1-I3)."""
    t0 = time.time()
    with cpu_workers_paused():
        res, launches = phase_viewer(smi)
    torch.cuda.empty_cache()
    res["I4"] = phase_viewer_same()
    res["I5"] = phase_viewer_checkpoint(smi)
    torch.cuda.empty_cache()
    res["I6"] = phase_hot_reload(smi)
    res["I7"] = phase_crash_dump(smi)
    res["I8"] = phase_viewer_command(smi)
    res["phase_s"] = time.time() - t0
    log(f"phase I: {res['phase_s']:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# E: the traversal engines (packets, sun-space grid, dense proxy, AABB cut)
# ---------------------------------------------------------------------------

def engine_classes(sess):
    """The engines' ray classes of one sample of `sess` (the 1080p stand-in
    with the default settings), recorded as trace_paths makes its calls:
    {name: (o, d, t_min, t_max, active)} for d1_closest (packets),
    d1_sun (packets), d2_closest (per ray), d2_sun (grid) and d2_terminal
    (proxy-screened)."""
    from dxrpathtracer_tpu_torch.render import integrator as it
    calls = {}
    names = {"packet_closest_hit": "d1_closest", "packet_any_hit": "d1_sun",
             "closest_hit": "d2_closest", "sun_any_hit": "d2_sun",
             "screened_any": "d2_terminal"}
    saved = {k: getattr(it, k) for k in names}

    def recorder(fn_name):
        fn = saved[fn_name]

        def record(*args, **kw):
            rays = args[1:6]  # after the table, grid or walk
            calls.setdefault(names[fn_name], tuple(
                torch.as_tensor(x).contiguous() for x in rays))
            return fn(*args, **kw)
        return record

    try:
        for k in names:
            setattr(it, k, recorder(k))
        sess.reset_accumulation()
        sess.render_frame()
        sync()
    finally:
        for k, fn in saved.items():
            setattr(it, k, fn)
    if set(calls) != set(names.values()):
        raise SystemExit(f"chip_smoke: E1 recorded classes {sorted(calls)}")
    n = sess.width * sess.height
    for name, rays in calls.items():
        calls[name] = tuple(
            x.expand(n).contiguous() if x.dim() == 0 else x for x in rays)
    return calls


def bits_differ(a, b):
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def engine_row(name, kernel, plain, nbytes, ops, extra, phase="E1"):
    """Times kernel() (5 launches after a warm-up) and plain() (once) with
    CUDA events and their bound; logs (under `phase`) and returns the
    row."""
    kernel()
    ms, _ = cuda_ms(kernel, repeat=5)
    plain_ms, _ = cuda_ms(plain)
    b_ms, b_by = bound_ms(nbytes, ops)
    row = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
           "library_ms": None, **extra}
    log(f"{phase} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()))
    return row


def cut_classes(sess):
    """The cut's classes of one sample of `sess` (BoxTest with the default
    settings, where the probe gates the cut on) with the packets off, so
    that the cut screens the camera rays too: {name: (o, d, t_min, t_max,
    active)} for d1_closest and d2_closest (the integrator's first two
    closest-hit screens) and shadow (the first per-ray shadow request that
    screened_any sends through it)."""
    from dxrpathtracer_tpu_torch.accel import proxy
    from dxrpathtracer_tpu_torch.render import integrator as it
    calls = {}
    saved = (it.cut_clear, proxy.cut_clear, sess.settings)

    def recorder(names, fn):
        def record(cut, *rays):
            name = names[min(len(names) - 1, sum(k in calls for k in names))]
            calls.setdefault(name, tuple(
                torch.as_tensor(x).contiguous() for x in rays))
            return fn(cut, *rays)
        return record

    try:
        it.cut_clear = recorder(("d1_closest", "d2_closest"), saved[0])
        proxy.cut_clear = recorder(("shadow",), saved[1])
        sess.settings = saved[2].replace(enable_packet_traversal=False)
        sess.reset_accumulation()
        sess.render_frame()
        sync()
    finally:
        it.cut_clear, proxy.cut_clear, sess.settings = saved
    if set(calls) != {"d1_closest", "d2_closest", "shadow"}:
        raise SystemExit(f"chip_smoke: E1 BoxTest cut classes {sorted(calls)}")
    for name, rays in calls.items():
        n = rays[0].shape[0]
        calls[name] = tuple(
            x.expand(n).contiguous() if x.dim() == 0 else x for x in rays)
    return calls


def screen_row(name, sess, screen, obj, rays, closest):
    """One screen kernel (proxy_blocked with the DenseProxy `obj`, or
    cut_clear with the AABBCut `obj`) against its plain version on `rays`,
    0 lanes that differ, with its times and bound; the screened result
    against the unscreened per-ray walk of `sess` on every lane: proxy
    visibility may only be more occluded, cut-screened hits (`closest`) or
    visibility must be equal."""
    from dxrpathtracer_tpu_torch.accel import proxy, traverse
    o, d, tmin, tmax, act = rays
    n = o.shape[0]
    cols = obj.tris if screen == "proxy_blocked" else obj.boxes
    plain_fn = (proxy.proxy_blocked_plain if screen == "proxy_blocked"
                else proxy.cut_clear_plain)
    stats = {}
    ref = plain_fn(obj, *rays, stats=stats)
    kern = lambda: proxy._launch(screen, cols, rays)  # noqa: E731
    got = kern()
    extra = {"rays": n, "active": int(act.sum()), "decided": int(got.sum()),
             "mismatches_vs_plain": int((got != ref).sum()),
             "max_abs_err": float((got.float() - ref.float()).abs().max()),
             "column_tests": stats["tests"]}

    def walk_any(*r):
        return traverse.any_hit(sess.bvh_ray, *r)

    if screen == "proxy_blocked":
        screened = proxy.screened_any(walk_any, *rays, proxy=obj)
        walk = walk_any(*rays)
        extra["vis_differ_vs_per_ray"] = int((screened != walk).sum())
        extra["vis_above_per_ray"] = int((screened > walk).sum())
        bad = extra["vis_above_per_ray"]
        ops = stats["tests"] * PROXY_OPS
    elif closest:
        full = traverse.closest_hit(sess.bvh_ray, *rays)
        cut = traverse.closest_hit(sess.bvh_ray, o, d, tmin, tmax,
                                   act & ~got)
        bad = sum(bits_differ(getattr(cut, f), getattr(full, f))
                  for f in ("t", "u", "v")) + int(
                      (cut.tri_id != full.tri_id).sum())
        extra["hits_differ_vs_unscreened"] = bad
        ops = stats["tests"] * CUT_OPS
    else:
        screened = proxy.screened_any(walk_any, *rays, cut=obj)
        bad = int((screened != walk_any(*rays)).sum())
        extra["vis_differ_vs_per_ray"] = bad
        ops = stats["tests"] * CUT_OPS
    nbytes = n * SCREEN_RAY_BYTES + cols.numel() * 4
    row = engine_row(f"{name} ({screen})", kern,
                     lambda: plain_fn(obj, *rays), nbytes, ops, extra)
    if extra["mismatches_vs_plain"] or bad:
        raise SystemExit(f"chip_smoke: E1 {name}: {extra}")
    return row


def grid_warps():
    """The grid kernel's persistent warps on the card: its resident warps
    per SM times the SMs."""
    from dxrpathtracer_tpu_torch.accel import sunspace
    return (sunspace.resident_warps()
            * torch.cuda.get_device_properties(0).multi_processor_count)


def walk_shape(stats, act, warps):
    """The grid walk's shape from its plain version's stats: record steps
    per active lane against the longest lane of its 32-ray warp (a warp of
    one thread per ray walks as long as that lane), the share of issued
    lane-steps that walk (over all lanes and over the active ones), the
    lanes a warp step has per distinct record it reads, and how evenly the
    kernel's `warps` persistent warps share the steps: each warp's range
    of whole 32-ray fetches cut as csrc/sungrid.cu cuts them, the busiest
    range's record steps against the mean range's, and the same were the
    fetches dealt out in turn (fetch f to warp f mod `warps`)."""
    pad = torch.nn.functional.pad
    steps = stats["lane_steps"]
    lanes = pad(steps, (0, -steps.numel() % 32)).view(-1, 32)
    on = pad(act.to(torch.int64), (0, -act.numel() % 32)).view(-1, 32)
    longest = lanes.max(dim=1).values
    total, active = int(steps.sum()), int(act.sum())
    held = int((on.sum(dim=1) * longest).sum())
    walked = steps[act].double()
    per_fetch = lanes.sum(dim=1)
    fetches = per_fetch.numel()
    per_warp = -(-fetches // warps)
    ranges = pad(per_fetch, (0, -fetches % per_warp)).view(-1, per_warp)
    dealers = min(warps, fetches)
    dealt = pad(per_fetch, (0, -fetches % dealers)).view(-1, dealers)

    def max_over_mean(x):
        return float(x.max()) / max(float(x.double().mean()), 1e-30)

    return {"steps_per_active_lane": total / max(active, 1),
            "warp_longest_per_active_lane": held / max(active, 1),
            "step_efficiency_all_lanes": total / max(32 * int(longest.sum()),
                                                     1),
            "step_efficiency_active_lanes": total / max(held, 1),
            "lane_steps_p99": float(walked.kthvalue(max(1, int(
                0.99 * walked.numel()))).values) if walked.numel() else 0.0,
            "lane_steps_max": int(steps.max()) if steps.numel() else 0,
            "lanes_per_distinct_record":
                stats["visits"] / max(stats["warp_records"], 1),
            "persistent_warps": warps, "range_rays": per_warp * 32,
            "range_steps_max_over_mean": max_over_mean(ranges.sum(dim=1)),
            "dealt_steps_max_over_mean": max_over_mean(dealt.sum(dim=0))}


def grid_work(stats, act):
    """(bytes, operations) of a grid call by the BOUND rule, from its plain
    version's stats."""
    nbytes = (act.numel() * GRID_RAY_BYTES
              + int(stats["touched"].sum()) * ROW_BYTES)
    ops = (int(act.sum()) * GRID_RAY_OPS + stats["visits"] * GRID_STEP_OPS
           + stats["tri_tests"] * PROXY_OPS)
    return nbytes, ops


def grid_row(name, grid, bvh_ray, rays, **info):
    """The grid kernel against its plain version on `rays`, 0 lanes that
    differ, and against the per-ray walk of `bvh_ray` (the grid may see an
    occluder that the walk's slab test culls, never miss one the walk
    finds), with its times, its bound and its walk's shape."""
    from dxrpathtracer_tpu_torch.accel import sunspace, traverse
    o, d, tmin, tmax, act = rays
    n = o.shape[0]
    stats = {}
    ref = sunspace.sun_any_hit_plain(grid, *rays, stats=stats)
    kern = lambda: sunspace._launch_kernel(grid, *rays)  # noqa: E731
    got = kern()
    walk = traverse.any_hit(bvh_ray, *rays)
    extra = {"rays": n, "active": int(act.sum()), "records": grid.num_rows,
             **info, "mismatches_vs_plain": int((got != ref).sum()),
             "max_abs_err": float((got - ref).abs().max()),
             "vis_differ_vs_per_ray": int((got != walk).sum()),
             "vis_above_per_ray": int((got > walk).sum()),
             "record_visits": stats["visits"],
             "records_tested": stats["tested"],
             "triangle_tests": stats["tri_tests"],
             "rows_touched": int(stats["touched"].sum()),
             **walk_shape(stats, act, grid_warps())}
    row = engine_row(f"{name} grid", kern,
                     lambda: sunspace.sun_any_hit_plain(grid, *rays),
                     *grid_work(stats, act), extra)
    if extra["mismatches_vs_plain"] or extra["vis_above_per_ray"]:
        raise SystemExit(f"chip_smoke: E1 {name}: {extra}")
    return row


def bake_sun_classes(baker):
    """The grid's two classes of one slab of a bake step, recorded as
    trace_paths makes its sun calls (depth 1, then 2): {"bake_d1_sun",
    "bake_d2_sun": (o, d, t_min, t_max, active)} of the slab whose depth-1
    class has the most active rays, and its first row. Every slab of the
    step is traced as `Baker.bake_step` traces it; the bake's state is left
    as it was."""
    from dxrpathtracer_tpu_torch.bake.baker import bake_sample
    from dxrpathtracer_tpu_torch.render import integrator as it
    sess = baker.session
    frame = sess.frame_constants(sess.sample_idx)
    pos, nrm = baker.surface_maps["position"], baker.surface_maps["normal"]
    rows, grid = baker._slab_rows, sess.update_sun_grid()
    saved, slabs = it.sun_any_hit, {}

    def record(g, *rays):
        n = rays[0].shape[0]
        slabs[r0].append(tuple(
            x.expand(n).contiguous() if x.dim() == 0 else x.contiguous()
            for x in (torch.as_tensor(y) for y in rays)))
        return saved(g, *rays)

    try:
        it.sun_any_hit = record
        for r0 in baker._row0:
            slabs[r0] = []
            bake_sample(sess.scene, sess.bvh_ray, sess.sky_cube,
                        sess.settings, frame, pos[r0:r0 + rows],
                        nrm[r0:r0 + rows], baker.accum[r0:r0 + rows],
                        baker.sample_index, row_offset=r0,
                        total_texels=baker.resolution ** 2, sun_grid=grid,
                        proxy=sess.proxy)
        sync()
    finally:
        it.sun_any_hit = saved
    if any(len(c) != 2 for c in slabs.values()):
        raise SystemExit(f"chip_smoke: E1 bake: sun calls per slab "
                         f"{[len(c) for c in slabs.values()]}, want 2")
    r0 = max(slabs, key=lambda k: int(slabs[k][0][4].sum()))
    return {"bake_d1_sun": slabs[r0][0], "bake_d2_sun": slabs[r0][1]}, r0


def phase_engine_bake_classes(baker, smi):
    """E1, the bake: the grid kernel on the depth-1 and depth-2 sun classes
    of one slab of a 4096^2 step (`bake_sun_classes`), as on the frame's."""
    t0 = time.time()
    classes, r0 = bake_sun_classes(baker)
    log(f"E1 bake: the grid's classes of the slab at row {r0} ("
        f"{baker._slab_rows} rows) recorded in {time.time() - t0:.2f} s; "
        "active lanes " + ", ".join(f"{k} {int(v[4].sum())}"
                                    for k, v in classes.items())
        + f" [{smi}]")
    sess = baker.session
    rows = {name: grid_row(name, sess.update_sun_grid(), sess.bvh_ray, rays,
                           slab_row=r0)
            for name, rays in classes.items()}
    return {"classes": rows, "card": smi}


def grid_edge_rows(sess):
    """E1's grid edge cases: tools/traverse_cases.grid_edge_cases on the
    grids of its GRID_SCENES (three seeded soups, one with a 96-cell grid
    and one with a steep sun, and BoxTest) and on the stand-in's own grid,
    each set in a launch of its own and all of a grid's sets in one more,
    the kernel against its plain version, 0 lanes that differ, and never
    less occluded than the per-ray walk."""
    import numpy as np

    from dxrpathtracer_tpu_torch.accel import bvh as bvh_mod
    from dxrpathtracer_tpu_torch.accel import sunspace, traverse
    from dxrpathtracer_tpu_torch.tools import traverse_cases as tc
    grids = {}
    for name in tc.GRID_SCENES:
        v0, v1, v2, sun, size = tc.grid_scene(name)
        grids[name] = (sunspace.build_sun_grid(v0, v1, v2, sun,
                                               grid_size=size),
                       bvh_mod.build_bvh(v0, v1, v2, width=8).to(
                           sess.device), sun)
    # the stand-in's rays along its grid's basis row 2
    grids["stand-in"] = (sess.update_sun_grid().to("cpu"), sess.bvh_ray, None)
    rows = {}
    for name, (grid, walk_bvh, sun) in grids.items():
        sets = tc.grid_edge_cases(grid.table.numpy(), grid.index.numpy(),
                                  grid.params.numpy(), grid.basis.numpy(),
                                  grid.grid_size, sun=sun)
        sets["all"] = tc.concat_rays(sets)[0]
        grid = grid.to(sess.device)
        for key, r in sets.items():
            rays = tuple(torch.from_numpy(np.ascontiguousarray(r[f])).to(
                sess.device) for f in tc.RAY_FIELDS)
            stats = {}
            ref = sunspace.sun_any_hit_plain(grid, *rays, stats=stats)
            got = sunspace._launch_kernel(grid, *rays)
            walk = traverse.any_hit(walk_bvh, *rays)
            rows[f"grid {name} {key}"] = {
                "rays": rays[0].shape[0], "active": int(rays[4].sum()),
                "blocked": int((got == 0).sum()),
                "lane_steps_max": int(stats["lane_steps"].max()),
                "mismatches_vs_plain": int((got != ref).sum()),
                "vis_above_per_ray": int((got > walk).sum())}
    for key, row in rows.items():
        log(f"E1 edge {key}: " + ", ".join(f"{k}={v}"
                                           for k, v in row.items()))
    return rows


def engine_edge_cases(sess, box_sess):
    """E1's edge cases, each kernel against its plain version on the card,
    0 lanes that differ in any bit: the packet walk, closest and any hit,
    on the ties and soup cases padded to whole packets (their W8 tables)
    and on tools/traverse_cases.packet_edge_cases of the stand-in's W8
    table (a packet with no active ray, packets with one, a packet whose
    rays all hit in the first leaf it reaches, a packet that reaches the
    deepest stack the table needs); the proxy screen on proxy_edge_rays at
    K = 8 and K = 1,365 (the soup) and K = 24 (BoxTest's proxy); the grid
    walk on `grid_edge_rows`."""
    import numpy as np

    from dxrpathtracer_tpu_torch.accel import bvh as bvh_mod
    from dxrpathtracer_tpu_torch.accel import packet, proxy, traverse
    from dxrpathtracer_tpu_torch.tools import traverse_cases as tc

    def tensors(rays):
        return tuple(torch.from_numpy(np.ascontiguousarray(rays[f])).to(
            sess.device) for f in tc.RAY_FIELDS)

    sets = [(name, bvh_mod.build_bvh(*tris, width=8).to(sess.device),
             tc.pad_to_packets(rays))
            for name, (tris, rays) in tc.cases(0).items()]
    pos = sess.scene_host.positions.numpy()
    tri = sess.scene_host.tri_idx.numpy()
    table = sess.bvh.table.cpu().numpy()
    for name, rays in tc.packet_edge_cases(
            pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]], table,
            sess.bvh.root_code).items():
        sets.append((f"stand-in {name}", sess.bvh, rays))
    rows, bad = {}, []
    for name, bvh, rays in sets:
        o, d, tmin, tmax, act = rays = tensors(rays)
        inv = traverse.safe_inv(d).contiguous()
        for first_hit in (False, True):
            stats = {}
            ref = packet.packet_traverse_plain(bvh, o, d, inv, tmin, tmax,
                                               act, first_hit, stats)
            got = packet._launch_kernel(bvh, o, d, inv, tmin, tmax, act,
                                        first_hit)
            key = f"packet {name} {'any' if first_hit else 'closest'}"
            row = rows[key] = {
                "rays": o.shape[0], "active": int(act.sum()),
                "hits": int(got.hit.sum()), "leaf_visits": stats["leaf"],
                "internal_visits": stats["internal"],
                "mismatches_vs_plain": sum(
                    bits_differ(getattr(got, f), getattr(ref, f))
                    for f in ("t", "u", "v"))
                + int((got.tri_id != ref.tri_id).sum())}
            if name == "stand-in first_leaf" and first_hit:
                # any hit ends in the first leaf: every ray hits there
                row["made_to_reach"] = (stats["leaf"] == 1
                                        and row["hits"] == row["rays"])
            if name == "stand-in deep_stack" and not first_hit:
                depth, _ = tc.deepest_leaf(table, bvh.root_code)
                row["stack_height"] = tc.packet_stack_height(bvh, rays)
                row["deepest_leaf_depth"] = depth
                row["made_to_reach"] = row["stack_height"] == depth
            log(f"E1 edge {key}: " + ", ".join(f"{k}={v}"
                                               for k, v in row.items()))
            if row["mismatches_vs_plain"] or row.get("made_to_reach") is \
                    False:
                bad.append(key)
    v0, v1, v2 = tc.soup(0)
    t = v0.shape[0]
    soup_pos = np.concatenate([v0, v1, v2])
    soup_tri = np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy()
    rays = proxy._rays(*tensors(tc.proxy_edge_rays()))
    o, d, tmin, tmax, act = rays
    for name, px in (("k8", proxy.build_dense_proxy(soup_pos, soup_tri, k=8)),
                     ("k1365", proxy.build_dense_proxy(
                         soup_pos, soup_tri, k=proxy.MAX_COLUMNS)),
                     ("box_k24", box_sess.proxy)):
        px = px.to(sess.device)
        ref = proxy.proxy_blocked_plain(px, *rays)
        got = proxy._launch("proxy_blocked", px.tris, rays)
        key = f"proxy {name}"
        row = rows[key] = {
            "k": px.k, "rays": o.shape[0], "active": int(act.sum()),
            "empty_segments": int((act & (tmax <= tmin)).sum()),
            "signed_zero_lanes": int(((d == 0) & torch.signbit(d)).any(
                dim=1).sum()),
            "blocked": int(got.sum()),
            "mismatches_vs_plain": int((got != ref).sum())}
        log(f"E1 edge {key}: " + ", ".join(f"{k}={v}"
                                           for k, v in row.items()))
        if row["mismatches_vs_plain"] or row["k"] != {
                "k8": 8, "k1365": proxy.MAX_COLUMNS, "box_k24": 24}[name]:
            bad.append(key)
    for key, row in grid_edge_rows(sess).items():
        rows[key] = row
        if row["mismatches_vs_plain"] or row["vis_above_per_ray"]:
            bad.append(key)
    if bad:
        raise SystemExit(f"chip_smoke: E1 edge cases {bad}: "
                         f"{[rows[k] for k in bad]}")
    return rows


def engine_session(scene):
    """A 1080p session of `scene` with the default settings (the engines
    on), as E1 and E2 drive it."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    t0 = time.time()
    sess = RenderSession(AppSettings(
        current_scene=getattr(Scenes, scene), benchmark_mode=True,
        max_path_length=3), *FRAME_SIZE, device=DEVICE)
    sync()
    log(f"E {scene}: session init {time.time() - t0:.2f} s, cut "
        f"{'on' if sess.cut is not None else 'off'} (probe "
        f"{sess.cut_clear_fraction:.5f})")
    return sess


def phase_engine_classes(sess, box_sess, smi):
    """E1: each engine kernel against its plain version on the card on the
    classes of one 1080p stand-in sample in tile order, bit for bit, with
    times and bounds; packets against the per-ray kernel (t, and the lanes
    whose triangle differs at equal t); grid and screened visibility against
    the per-ray any hit; the cut un-gated there, and gated on in the
    classes of one 1080p sample of `box_sess` (BoxTest), where it must
    clear lanes; every scene's probe fraction."""
    from dxrpathtracer_tpu_torch.accel import (packet, proxy, sunspace,
                                               traverse)
    from dxrpathtracer_tpu_torch.app.settings import Scenes
    from dxrpathtracer_tpu_torch.scene.registry import load_scene
    from dxrpathtracer_tpu_torch.tools import alpha_cases

    t0 = time.time()
    classes = engine_classes(sess)
    log(f"E1: classes recorded in {time.time() - t0:.2f} s; active lanes "
        + ", ".join(f"{k} {int(v[4].sum())}" for k, v in classes.items()))
    rows = {}
    n = sess.width * sess.height

    # packets: closest and any hit against the plain walk and the per-ray
    # kernel on the W8 table
    for name, first_hit in (("d1_closest", False), ("d1_sun", True)):
        o, d, tmin, tmax, act = classes[name]
        inv = traverse.safe_inv(d).contiguous()
        kern = lambda: packet._launch_kernel(sess.bvh, o, d, inv, tmin,  # noqa: E731
                                             tmax, act, first_hit)
        stats = {}
        ref = packet.packet_traverse_plain(sess.bvh, o, d, inv, tmin, tmax,
                                           act, first_hit, stats)
        got = kern()
        walk = traverse._launch_kernel(sess.bvh, o, d, inv, tmin, tmax, act,
                                       first_hit)
        mism = sum(bits_differ(getattr(got, f), getattr(ref, f))
                   for f in ("t", "u", "v")) + int(
                       (got.tri_id != ref.tri_id).sum())
        t_diff = got.t.view(torch.int32) != walk.t.view(torch.int32)
        both = got.hit & ref.hit
        extra = {"rays": n, "active": int(act.sum()),
                 "mismatches_vs_plain": mism,
                 "max_abs_err": max([0.0] + [
                     float((getattr(got, f) - getattr(ref, f))[both].abs()
                           .max()) for f in ("t", "u", "v")
                     if bool(both.any())]),
                 "internal_visits": stats["internal"],
                 "leaf_visits": stats["leaf"],
                 "slot_tests": stats["slot_tests"],
                 "triangle_tests": stats["tri_tests"],
                 "rows_touched": int(stats["touched"].sum())}
        # Against the per-ray walk a packet may find a hit the walk's own
        # slab test culls (a ray grazing a box face reaches a triangle edge
        # the triangle test accepts, through a neighbour's descent): it may
        # be nearer or occluded where the walk is not, never the reverse.
        if first_hit:
            # the occluder ids (packet_any_hit_rec), within the mismatches
            extra["occluder_mismatches"] = int(
                (got.tri_id != ref.tri_id).sum())
            vis_k = torch.where(act & got.hit, 0.0, 1.0)
            vis_w = torch.where(act & walk.hit, 0.0, 1.0)
            extra["vis_differ_vs_per_ray"] = int((vis_k != vis_w).sum())
            extra["vis_above_per_ray"] = int((vis_k > vis_w).sum())
            bad = mism or extra["vis_above_per_ray"]
        else:
            extra["t_differ_vs_per_ray"] = int(t_diff.sum())
            extra["t_farther_than_per_ray"] = int(
                (got.t[t_diff] > walk.t[t_diff]).sum())
            extra["equal_t_other_triangle"] = int(
                ((got.tri_id != walk.tri_id) & ~t_diff).sum())
            bad = mism or extra["t_farther_than_per_ray"]
        nbytes = n * (RAY_IN_BYTES + HIT_BYTES) + extra["rows_touched"] \
            * ROW_BYTES
        ops = stats["slot_tests"] * SLAB_OPS + stats["tri_tests"] * MT_OPS
        rows[name] = engine_row(
            f"{name} packets", kern,
            lambda: packet.packet_traverse_plain(sess.bvh, o, d, inv, tmin,
                                                 tmax, act, first_hit),
            nbytes, ops, extra)
        if bad:
            raise SystemExit(f"chip_smoke: E1 {name}: {extra}")

    # the grid on the depth-2 sun class
    rows["d2_sun"] = grid_row("d2_sun", sess.update_sun_grid(), sess.bvh_ray,
                              classes["d2_sun"],
                              grid_build_s=sess.sun_grid_build_s)

    # the screens: the proxy on the terminal and depth-2 sun classes, the
    # cut (built un-gated: the probe keeps it off on the stand-in) on the
    # depth-2 closest and terminal classes
    ungated = proxy.build_aabb_cut(sess.scene_host.positions.numpy(),
                                   sess.scene_host.tri_idx.numpy()).to(
                                       sess.device)
    for name, screen, cls in (("proxy_terminal", "proxy_blocked",
                               "d2_terminal"),
                              ("proxy_d2_sun", "proxy_blocked", "d2_sun"),
                              ("cut_d2_closest", "cut_clear", "d2_closest"),
                              ("cut_terminal", "cut_clear", "d2_terminal")):
        obj = sess.proxy if screen == "proxy_blocked" else ungated
        rows[name] = screen_row(name, sess, screen, obj, classes[cls],
                                closest=cls == "d2_closest")

    # the cut where the probe gates it on: the classes of one 1080p BoxTest
    # sample. It must clear camera rays (most see the sky); the bounce and
    # shadow rays start on a surface, inside the box that holds it, so it
    # may clear none of them.
    if box_sess.cut is None:
        raise SystemExit(f"chip_smoke: E1 BoxTest: the cut is gated off "
                         f"(probe {box_sess.cut_clear_fraction})")
    for cls, rays in cut_classes(box_sess).items():
        name = f"cut_box_{cls}"
        rows[name] = screen_row(name, box_sess, "cut_clear", box_sess.cut,
                                rays, closest=cls != "shadow")
    if rows["cut_box_d1_closest"]["decided"] == 0:
        raise SystemExit("chip_smoke: E1 cut_box_d1_closest: the cut cleared"
                         " no camera ray")

    # every scene's probe fraction (the cut's gate, threshold 0.10)
    probes = {}
    scenes = {k.name: load_scene(k)[0] for k in (
        Scenes.Sponza, Scenes.SunTemple, Scenes.WhiteFurnace, Scenes.BoxTest)}
    scenes["SponzaAlpha-checker"] = alpha_cases.sponza_alpha_checker()[0]
    for name, sc in scenes.items():
        pos, tri = sc.positions.numpy(), sc.tri_idx.numpy()
        cut = proxy.build_aabb_cut(pos, tri)
        probes[name] = (0.0 if cut is None
                        else proxy.probe_clear_fraction(cut, pos, tri))
    log("E1 probe clear fractions (the cut is on at >= "
        f"{proxy.CUT_MIN_CLEAR}): " + ", ".join(
            f"{k} {v:.5f}" for k, v in probes.items()) + f" [{smi}]")
    if not (probes["BoxTest"] >= proxy.CUT_MIN_CLEAR
            > max(probes["Sponza"], probes["SunTemple"])):
        raise SystemExit(f"chip_smoke: E1 probe fractions {probes}")
    return {"classes": rows, "edge_cases": engine_edge_cases(sess, box_sess),
            "probe_clear_fraction": probes, "card": smi}


def engine_run(label, sess, base, fields, smi, frames=E_FRAMES,
               phase="E2"):
    """One timed configuration of the engines: the settings with `fields`,
    the accumulation restarted, a first frame and `frames` more; returns
    its row and the image."""
    sess.settings = base.replace(**fields)
    sess.reset_accumulation()
    first_s, dts, launches = timed_frames(sess, frames)
    med = statistics.median(dts)
    per_frame = {k: launches[k] / (frames + 1)
                 for k in ("traverse", *ENGINE_KERNELS)}
    per_frame.update({f"traverse_{k}": v / (frames + 1) for k, v in
                      launches["traverse_by_instance"].items()})
    row = {"fields": fields, "first_frame_s": first_s,
           "ms_per_frame_median": med * 1e3,
           "ms_per_frame": [t * 1e3 for t in dts],
           "spread_pct": (max(dts) - min(dts)) / med * 100.0,
           "launches_per_frame": per_frame, "kernel_launches": launches}
    log(f"{phase} {label}: {med * 1e3:.2f} ms/frame (median of {frames}, spread "
        f"{row['spread_pct']:.1f}%), first {first_s:.2f} s; launches per "
        f"frame " + ", ".join(f"{k} {v:g}" for k, v in per_frame.items()
                              if v) + f" [{smi}]")
    if not bool(sess.accum.isfinite().all()):
        raise SystemExit(f"chip_smoke: {phase} {label}: image not finite")
    return row, sess.accum.clone()


def phase_engine_ab(frame_sess, box_sess, smi):
    """E2: the engines on (the defaults) against off, 10 frames after a
    first, on the 1080p stand-in (with each engine off alone too), the
    SunTemple stand-in and BoxTest (the cut gated on there); every
    configuration's image within rel-RMSE 1e-4 of the defaults'."""
    off = {k: False for k in ENGINE_FIELDS}
    singles = {"no_packets": {"enable_packet_traversal": False},
               "no_grid": {"enable_sunspace_shadows": False},
               "no_proxy": {"enable_dense_proxy": False},
               "no_cut": {"enable_clear_cut": False}}
    out, launches = {}, []
    for scene in ("Sponza", "SunTemple", "BoxTest"):
        sess = {"Sponza": frame_sess, "BoxTest": box_sess}.get(scene) \
            or engine_session(scene)
        base = sess.settings.replace(**{k: True for k in ENGINE_FIELDS})
        configs = {"on": {}, "off": off}
        if scene == "Sponza":
            configs.update(singles)
        elif scene == "BoxTest":
            configs = {"on": {}, "no_cut": singles["no_cut"]}
        rows, imgs = {}, {}
        for label, fields in configs.items():
            rows[label], imgs[label] = engine_run(f"{scene} {label}", sess,
                                                  base, fields, smi)
            launches.append(rows[label]["kernel_launches"])
        for label in configs:
            rows[label]["rel_rmse_vs_on"] = rel_rmse(imgs[label], imgs["on"])
        on_ms = rows["on"]["ms_per_frame_median"]
        log(f"E2 {scene}: grid build {sess.sun_grid_build_s:.2f} s (host); "
            + ", ".join(f"{k} {v['ms_per_frame_median']:.2f} ms "
                        f"({v['ms_per_frame_median'] / on_ms:.3f}x on, "
                        f"rel RMSE vs on {v['rel_rmse_vs_on']:.2e})"
                        for k, v in rows.items()) + f" [{smi}]")
        if any(v["rel_rmse_vs_on"] > 1e-4 for v in rows.values()):
            raise SystemExit(f"chip_smoke: E2 {scene}: images differ "
                             f"{[(k, v['rel_rmse_vs_on']) for k, v in rows.items()]}")
        # the probe gates the cut on for BoxTest only
        if bool(rows["on"]["kernel_launches"]["cut_clear"]) != (
                scene == "BoxTest"):
            raise SystemExit(f"chip_smoke: E2 {scene}: cut launches "
                             f"{rows['on']['kernel_launches']['cut_clear']}")
        out[scene] = {"cut_clear_fraction": sess.cut_clear_fraction,
                      "grid_build_s": sess.sun_grid_build_s, "runs": rows}
        sess.settings = base
        del sess
        torch.cuda.empty_cache()
    return out, launches


def phase_engine_bake_ab(baker, smi, steps=3):
    """E2, the bake: `steps` steps with the grid and the proxy (the
    defaults) and without, each from an empty accumulation; the two
    accumulations must be equal."""
    sess = baker.session
    base = sess.settings
    res, accums = {}, {}
    launches = []
    for label, fields in (("on", {}), ("off", {
            "enable_sunspace_shadows": False, "enable_dense_proxy": False})):
        sess.settings = base.replace(**fields)
        baker.accum.zero_()
        baker.sample_index = 0
        reset_launches()
        dts = []
        for _ in range(steps):
            sync()
            t0 = time.time()
            baker.bake_step()
            sync()
            dts.append(time.time() - t0)
        lw = read_launches()
        launches.append(lw)
        accums[label] = baker.accum.clone()
        res[label] = {"step_s": dts, "step_s_median": statistics.median(dts),
                      "launches_per_step": {
                          k: lw[k] / steps for k in ("traverse",
                                                     *ENGINE_KERNELS)}}
        log(f"E2 bake {label}: {res[label]['step_s_median']:.3f} s/step "
            f"(median of {steps}); launches per step "
            f"{res[label]['launches_per_step']} [{smi}]")
    sess.settings = base
    rel = rel_rmse(accums["on"], accums["off"])
    res["rel_rmse_on_vs_off"] = rel
    log(f"E2 bake: on {res['on']['step_s_median']:.3f} s/step, off "
        f"{res['off']['step_s_median']:.3f} s/step; accumulations rel RMSE "
        f"{rel:.2e}")
    if rel > 1e-4 or not launches[0]["sun_any_hit"] or launches[1][
            "sun_any_hit"]:
        raise SystemExit(f"chip_smoke: E2 bake: rel RMSE {rel:.2e}, "
                         f"launches {launches}")
    return res, launches


def phase_engine_same_frame(smi):
    """E3: one engines-on BoxTest frame at E3_SIZE (packet-tileable, the cut
    gated on) on the card and on the CPU: rel-RMSE <= 1e-4, every engine
    reached on both routes (kernel launches on the card, the plain versions'
    calls on the CPU)."""
    from dxrpathtracer_tpu_torch.accel import packet, proxy, sunspace
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    plain = {"packet": (packet, "packet_traverse_plain"),
             "sun_any_hit": (sunspace, "sun_any_hit_plain"),
             "proxy_blocked": (proxy, "proxy_blocked_plain"),
             "cut_clear": (proxy, "cut_clear_plain")}
    calls = {k: 0 for k in plain}
    saved = {k: getattr(m, f) for k, (m, f) in plain.items()}

    def counted(key):
        def fn(*a, **kw):
            calls[key] += 1
            return saved[key](*a, **kw)
        return fn

    settings = AppSettings(current_scene=Scenes.BoxTest, benchmark_mode=True,
                           max_path_length=3)
    imgs, engaged = {}, {}
    for dev in (DEVICE, "cpu"):
        sess = RenderSession(settings, *E3_SIZE, device=dev)
        reset_launches()
        try:
            for k, (m, f) in plain.items():
                setattr(m, f, counted(k))
            sess.render_frame()
        finally:
            for k, (m, f) in plain.items():
                setattr(m, f, saved[k])
        imgs[dev] = sess.accum.cpu()
        lw = read_launches()
        engaged[dev] = ({"packet": lw["packet_closest"] + lw["packet_any"],
                         **{k: lw[k] for k in ("sun_any_hit",
                                               "proxy_blocked", "cut_clear")}}
                        if dev == DEVICE else dict(calls))
    rel = rel_rmse(imgs[DEVICE], imgs["cpu"])
    log(f"E3 BoxTest {E3_SIZE}, engines on: rel RMSE card vs CPU {rel:.3e}; "
        f"engines reached {engaged} [{smi}]")
    if rel > 1e-4 or not all(all(v > 0 for v in e.values())
                             for e in engaged.values()):
        raise SystemExit(f"chip_smoke: E3: rel RMSE {rel:.3e}, engines "
                         f"{engaged}")
    return {"size": E3_SIZE, "rel_rmse": rel, "engaged": engaged}


def animated_engines_ab(sess):
    """E4: the last animated frame's geometry, one sample with the engine
    fields on (the packets; the session dropped the grid, proxy and cut
    with the moved geometry) and one with them off: rel-RMSE <= 1e-4."""
    base = sess.settings
    imgs = {}
    for label, fields in (("on", {}), ("off", {k: False
                                               for k in ENGINE_FIELDS})):
        sess.settings = base.replace(**fields)
        sess.reset_accumulation()
        sess.render_to_completion(1)
        imgs[label] = sess.accum.clone()
    sess.settings = base
    rel = rel_rmse(imgs["on"], imgs["off"])
    exact = float((imgs["on"] == imgs["off"]).float().mean())
    log(f"E4 animated frame, engines on vs off: rel RMSE {rel:.3e}, "
        f"{exact:.4f} of values bit-equal; grid {sess.sun_grid}, proxy "
        f"{sess.proxy}, cut {sess.cut}")
    if rel > 1e-4 or sess.proxy is not None or sess.cut is not None:
        raise SystemExit(f"chip_smoke: E4: rel RMSE {rel:.3e}")
    return {"rel_rmse": rel, "bit_equal_fraction": exact}


# ---------------------------------------------------------------------------
# S: the seeded and binned routes (temporal history, proxy seeding, raster)
# ---------------------------------------------------------------------------

# A revalidated lane: its prediction (4 B) and ray (33 B) in, ok, t, u and v
# (13 B) out; a predicted triangle's row, 36 B. A closest-hit ray of the
# proxy's and the raster's nearest-hit tests: 33 B in, 16 B out.
HISTORY_LANE_BYTES = 50
TRI_ROW_BYTES = 36
CLOSEST_RAY_BYTES = 49


@contextlib.contextmanager
def env_var(name, value):
    """The environment variable `name` set to `value` inside, as it was
    after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def recording(module, fn_name, calls):
    """module.fn_name appends the arguments of each call to `calls`."""
    fn = getattr(module, fn_name)

    def record(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)

    setattr(module, fn_name, record)
    try:
        yield
    finally:
        setattr(module, fn_name, fn)


def hit_bits_differ(got, ref):
    """Lanes whose t, u or v differ in any bit or whose triangle differs."""
    return sum(bits_differ(getattr(got, f), getattr(ref, f))
               for f in ("t", "u", "v")) + int((got.tri_id != ref.tri_id).sum())


def hit_abs_err(got, ref, both):
    """The largest |got - ref| of t, u and v over the lanes `both` marks
    (lanes where both hit), 0 where there is none; got and ref are
    (t, u, v) triples."""
    if not bool(both.any()):
        return 0.0
    return max(float((g - r)[both].abs().max()) for g, r in zip(got, ref))


def against_walk(got, walk):
    """{lanes whose t differs from the walk's, of them nearer, and lanes of
    another triangle at an equal t}."""
    t_diff = got.t.view(torch.int32) != walk.t.view(torch.int32)
    return {"t_differ": int(t_diff.sum()),
            "t_nearer": int((got.t < walk.t).sum()),
            "t_farther": int((got.t > walk.t).sum()),
            "equal_t_other_triangle": int(
                ((got.tri_id != walk.tri_id) & ~t_diff).sum())}


def walk_ms(fns):
    """{name: mean ms of 5 launches after a warm-up} of the walks."""
    out = {}
    for name, fn in fns.items():
        fn()
        out[name] = cuda_ms(fn, repeat=5)[0]
    return out


def route_run(label, sess, base_img, smi, kernel, per_frame):
    """A route's frames (engine_run: the accumulation restarted, a first
    frame and S_FRAMES more): ms/frame, launches, and the image against the
    default route's; `kernel` must launch `per_frame` times a frame."""
    row, img = engine_run(label, sess, sess.settings, {}, smi,
                          frames=S_FRAMES, phase="S")
    row["rel_rmse_vs_default"] = rel_rmse(img, base_img)
    row["pixels_differ_vs_default"] = int((img != base_img).any(dim=-1).sum())
    got = row["kernel_launches"][kernel]
    log(f"S {label}: image vs the default route rel RMSE "
        f"{row['rel_rmse_vs_default']:.3e}, {row['pixels_differ_vs_default']} "
        f"pixels differ; {kernel} {got} launches [{smi}]")
    if (row["rel_rmse_vs_default"] > 1e-4
            or got != per_frame * (S_FRAMES + 1)):
        raise SystemExit(f"chip_smoke: S {label}: {row}")
    return row


def s_history(base_img, smi):
    """S, temporal history: a session built with DXRPT_HISTORY=1; the
    second frame's depth-1 closest and sun calls recorded (their
    predictions are the first frame's hits and occluders): the
    revalidation kernel against its plain version, the seeded results
    against the default route's packet walks on the same rays, the walks'
    times; then the route's frames."""
    from dxrpathtracer_tpu_torch.accel import history, packet, traverse
    with env_var("DXRPT_HISTORY", "1"):
        sess = engine_session("Sponza")
    if sess.tri_table is None:
        raise SystemExit("chip_smoke: S history: no triangle table")
    sess.reset_accumulation()
    sess.render_frame()
    calls = []
    with recording(history, "revalidate", calls):
        sess.render_frame()
    sync()
    if len(calls) != 2:
        raise SystemExit(f"chip_smoke: S history: {len(calls)} revalidations "
                         f"in a frame, want 2")
    rows = {}
    bvh = sess.bvh
    for name, args in zip(("d1_closest", "d1_sun"), calls):
        lanes = history._lanes(*(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args))
        table, pred, o, d, tmin, tmax, act = lanes
        n = o.shape[0]
        ref = history.revalidate_plain(*lanes)
        got = history._launch_kernel(*lanes)
        mism = int((got[0] != ref[0]).sum()) + sum(
            bits_differ(g, r) for g, r in zip(got[1:], ref[1:]))
        ok = got[0]
        rows_read = int(torch.unique(torch.clamp(pred, 0)).numel())
        extra = {"rays": n, "active": int(act.sum()),
                 "predicted": int((act & (pred >= 0)).sum()),
                 "revalidated": int(ok.sum()), "rows_read": rows_read,
                 "mismatches_vs_plain": mism,
                 "max_abs_err": hit_abs_err(got[1:], ref[1:],
                                            got[0] & ref[0])}
        if name == "d1_closest":
            pk = lambda *r: packet.packet_closest_hit(bvh, *r)  # noqa: E731
            seeded, _ = history.seeded_closest(pk, table, pred, o, d, tmin,
                                               tmax, act)
            walk = pk(o, d, tmin, tmax, act)
            cmp_ = against_walk(seeded, walk)
            bound = torch.where(ok, got[1], tmax)
            # where the walk under the bound finds nothing nearer, the
            # prediction is the hit
            under = pk(o, d, tmin, bound, act)
            extra.update(cmp_, prediction_taken=int(
                (ok & (under.tri_id < 0)).sum()))
            bad = cmp_["t_farther"]
            extra["walk_ms"] = walk_ms({
                "packet": lambda: pk(o, d, tmin, tmax, act),
                "packet_seeded_bound": lambda: pk(o, d, tmin, bound, act),
                "per_ray_W8": lambda: traverse.closest_hit(bvh, o, d, tmin,
                                                           tmax, act)})
        else:
            rec = lambda *r: packet.packet_any_hit_rec(bvh, *r)  # noqa: E731
            vis, _ = history.seeded_any(rec, table, pred, o, d, tmin, tmax,
                                        act)
            walk_vis, occ = rec(o, d, tmin, tmax, act)
            extra.update(
                vis_differ=int((vis != walk_vis).sum()),
                vis_above_walk=int((vis > walk_vis).sum()),
                skipped_the_walk=int(ok.sum()),
                occluded=int((act & (walk_vis == 0)).sum()))
            bad = extra["vis_above_walk"]
            rest = act & ~ok
            extra["walk_ms"] = walk_ms({
                "packet": lambda: rec(o, d, tmin, tmax, act),
                "packet_unresolved_lanes": lambda: rec(o, d, tmin, tmax,
                                                       rest),
                "per_ray_W8": lambda: traverse.any_hit(bvh, o, d, tmin,
                                                       tmax, act)})
        nbytes = n * HISTORY_LANE_BYTES + rows_read * TRI_ROW_BYTES
        rows[name] = engine_row(
            f"history {name} (revalidate)",
            lambda: history._launch_kernel(*lanes),
            lambda: history.revalidate_plain(*lanes), nbytes, n * MT_OPS,
            extra, phase="S")
        if mism or bad:
            raise SystemExit(f"chip_smoke: S history {name}: {extra}")
    log(f"S history: the revalidation resolved "
        f"{rows['d1_closest']['revalidated']} of "
        f"{rows['d1_closest']['active']} depth-1 closest lanes (the walk ran "
        f"under their bound), and {rows['d1_sun']['skipped_the_walk']} of "
        f"{rows['d1_sun']['active']} sun lanes skipped the walk [{smi}]")
    run = route_run("history", sess, base_img, smi, "history_revalidate", 2)
    del sess
    torch.cuda.empty_cache()
    return {"classes": rows, "run": run}, run["kernel_launches"]


def s_proxy(base_img, smi):
    """S, proxy seeding: a session rendering with DXRPT_PROXY_SEED=1; the
    depth-2 closest class recorded: the proxy_closest kernel against its
    plain version, the seeded walk against the unseeded one on the same
    rays, the walks' times; then the route's frames."""
    from dxrpathtracer_tpu_torch.accel import packet, proxy, traverse
    with env_var("DXRPT_PROXY_SEED", "1"):
        sess = engine_session("Sponza")
        sess.reset_accumulation()
        calls = []
        with recording(proxy, "proxy_closest", calls):
            sess.render_frame()
        sync()
        if len(calls) != 1:
            raise SystemExit(f"chip_smoke: S proxy: {len(calls)} seeded "
                             f"closest calls in a frame, want 1")
        px = calls[0][0]
        rays = proxy._rays(*(x.clone() for x in calls[0][1:6]))
        o, d, tmin, tmax, act = rays
        n = o.shape[0]
        stats = {}
        ref = proxy.proxy_closest_plain(px, *rays, stats=stats)
        got = proxy._launch_closest(px, rays)
        w32 = lambda *r: traverse.closest_hit(sess.bvh_ray, *r)  # noqa: E731
        seeded = proxy.seeded_closest(w32, px, *rays)
        walk = w32(*rays)
        cmp_ = against_walk(seeded, walk)
        bound = torch.where(got.tri_id >= 0,
                            got.t * torch.tensor(proxy.SEED_SLACK,
                                                 device=got.t.device), got.t)
        extra = {"rays": n, "active": int(act.sum()), "k": px.k,
                 "proxy_hits": int(got.hit.sum()),
                 "mismatches_vs_plain": hit_bits_differ(got, ref),
                 "max_abs_err": hit_abs_err((got.t, got.u, got.v),
                                            (ref.t, ref.u, ref.v),
                                            got.hit & ref.hit),
                 "column_tests": stats["tests"], **cmp_,
                 "walk_ms": walk_ms({
                     "per_ray_W32": lambda: w32(*rays),
                     "per_ray_W32_seeded_bound": lambda: w32(o, d, tmin,
                                                             bound, act),
                     "per_ray_W8": lambda: traverse.closest_hit(
                         sess.bvh, *rays),
                     "packet_W8": lambda: packet.packet_closest_hit(
                         sess.bvh, *rays)})}
        nbytes = n * CLOSEST_RAY_BYTES + px.k * 40
        rows = {"d2_closest": engine_row(
            "proxy d2_closest (proxy_closest)",
            lambda: proxy._launch_closest(px, rays),
            lambda: proxy.proxy_closest_plain(px, *rays), nbytes,
            stats["tests"] * MT_OPS, extra, phase="S")}
        # the seeded walk finds the proxy triangle itself under its bound,
        # or nearer; where the walk's slab test culls a grazing hit the
        # proxy's stands, so a lane is never farther than the unseeded walk
        if extra["mismatches_vs_plain"] or cmp_["t_farther"]:
            raise SystemExit(f"chip_smoke: S proxy: {extra}")
        run = route_run("proxy_seed", sess, base_img, smi, "proxy_closest", 1)
    del sess
    torch.cuda.empty_cache()
    return {"classes": rows, "run": run}, run["kernel_launches"]


def s_raster(base_img, smi):
    """S, the software raster: a session rendering with
    DXRPT_RASTER_MIN_PIXELS=1; its bins (pairs, deepest tile, the host
    binning's seconds) and the recorded camera rays: the raster kernel
    against its plain version and against the packet walk on the same rays,
    the walks' times; then the route's frames."""
    import numpy as np

    from dxrpathtracer_tpu_torch.accel import packet, traverse
    from dxrpathtracer_tpu_torch.render import integrator as it
    from dxrpathtracer_tpu_torch.render import swraster
    with env_var("DXRPT_RASTER_MIN_PIXELS", "1"):
        sess = engine_session("Sponza")
        sess.reset_accumulation()
        calls = []
        with recording(it, "raster_closest_hit", calls):
            sess.render_frame()
        sync()
        bins = sess.raster_bins
        if len(calls) != 1 or bins is None:
            raise SystemExit(f"chip_smoke: S raster: {len(calls)} raster "
                             f"calls in a frame, bins {bins}")
        depth = (bins.tile_start[1:] - bins.tile_start[:-1]).cpu()
        cam = sess.camera
        t0 = time.perf_counter()
        swraster.build_raster_bins(
            sess.scene_host.positions.numpy(),
            sess.scene_host.tri_idx.numpy(),
            np.asarray(cam.view_projection(), np.float64),
            float(cam.near_clip), sess.width, sess.height, bins.ty, bins.tx,
            bins.tri_table)
        host_s = time.perf_counter() - t0
        rays = swraster._lanes(bins, *(x.clone() for x in calls[0][1:6]))
        o, d, tmin, tmax, act = rays
        n = o.shape[0]
        stats = {}
        ref = swraster.raster_closest_hit_plain(bins, *rays, stats=stats)
        got = swraster._launch_kernel(bins, *rays)
        walk = packet.packet_closest_hit(sess.bvh, *rays)
        cmp_ = against_walk(got, walk)
        rows_read = int(torch.unique(bins.tri_id).numel())
        extra = {"rays": n, "active": int(act.sum()), "pairs": bins.pairs,
                 "tiles": bins.n_tiles, "deepest_tile": int(depth.max()),
                 "empty_tiles": int((depth == 0).sum()),
                 "binning_host_s": host_s,
                 "session_build_s": sess.raster_build_s,
                 "hits": int(got.hit.sum()),
                 "mismatches_vs_plain": hit_bits_differ(got, ref),
                 "max_abs_err": hit_abs_err((got.t, got.u, got.v),
                                            (ref.t, ref.u, ref.v),
                                            got.hit & ref.hit),
                 "triangle_tests": stats["tests"],
                 **cmp_, "walk_ms": walk_ms({
                     "packet_W8": lambda: packet.packet_closest_hit(
                         sess.bvh, *rays),
                     "per_ray_W8": lambda: traverse.closest_hit(sess.bvh,
                                                                *rays)})}
        nbytes = (n * CLOSEST_RAY_BYTES + bins.pairs * 4
                  + (bins.n_tiles + 1) * 4 + rows_read * TRI_ROW_BYTES)
        rows = {"d1_camera": engine_row(
            "raster d1_camera (raster_closest_hit)",
            lambda: swraster._launch_kernel(bins, *rays),
            lambda: swraster.raster_closest_hit_plain(bins, *rays), nbytes,
            stats["tests"] * MT_OPS, extra, phase="S")}
        # never farther than the walk: a nearer hit is one the walk's slab
        # test culls (a grazing ray), which the raster, testing every binned
        # triangle, finds
        if extra["mismatches_vs_plain"] or cmp_["t_farther"]:
            raise SystemExit(f"chip_smoke: S raster: {extra}")
        run = route_run("raster", sess, base_img, smi, "raster_closest_hit",
                        1)
    del sess
    torch.cuda.empty_cache()
    return {"classes": rows, "run": run}, run["kernel_launches"]


def s_edge_cases(smi):
    """S's edge cases, each kernel against its plain version on the card, 0
    lanes that differ in any bit: the revalidation on the soup with
    predictions that mix true hits, -1, stale triangles and hits beyond
    t_max, a fifth of the lanes inactive, n not a multiple of 32
    (traverse_cases.history_predictions); proxy_closest on proxy_edge_rays
    at K = 8 and 1,365 (the soup) and 24 (BoxTest); the raster on
    traverse_cases.raster_edge_scene at 64x32 (a triangle through the near
    plane, empty tiles, a tile of more than 320 triangles, a repeated quad:
    the lower id at equal t)."""
    import numpy as np

    from dxrpathtracer_tpu_torch.accel import history, proxy, traverse
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.convert import frame_from_numpy
    from dxrpathtracer_tpu_torch.render import integrator as it
    from dxrpathtracer_tpu_torch.render import swraster
    from dxrpathtracer_tpu_torch.render.camera import FirstPersonCamera
    from dxrpathtracer_tpu_torch.scene.registry import load_scene
    from dxrpathtracer_tpu_torch.tools import traverse_cases as tc

    def indexed(v0, v1, v2):
        t = v0.shape[0]
        return (np.concatenate([v0, v1, v2]),
                np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy())

    def tensors(rays):
        return tuple(torch.from_numpy(np.ascontiguousarray(rays[f])).to(
            DEVICE) for f in tc.RAY_FIELDS)

    rows, bad = {}, []
    # the revalidation
    soup = tc.soup(0)
    pos, tri = indexed(*soup)
    bvh = build_bvh(*soup, width=8).to(DEVICE)
    rays = {f: a[:2045] for f, a in tc.soup_rays(5).items()}
    r = tensors(rays)
    rec = traverse.closest_hit(bvh, *r)
    _, occ = traverse.any_hit_rec(bvh, *r)
    table = torch.from_numpy(history.build_tri_table(pos, tri)).to(DEVICE)
    mixed, prim, sun = tc.history_predictions(
        rays, rec.tri_id.cpu().numpy(), rec.t.cpu().numpy(),
        occ.cpu().numpy(), table.shape[0])
    r = tensors(mixed)
    for name, pred in (("closest", prim), ("sun", sun)):
        lanes = history._lanes(table, torch.from_numpy(pred).to(DEVICE), *r)
        got = history._launch_kernel(*lanes)
        ref = history.revalidate_plain(*lanes)
        row = rows[f"history {name}"] = {
            "rays": r[0].shape[0], "active": int(r[4].sum()),
            "no_prediction": int((lanes[1] < 0).sum()),
            "held": int(got[0].sum()),
            "mismatches_vs_plain": int((got[0] != ref[0]).sum()) + sum(
                bits_differ(g, f) for g, f in zip(got[1:], ref[1:]))}
        if row["mismatches_vs_plain"] or not 0 < row["held"] < row["active"]:
            bad.append(f"history {name}")
    # proxy_closest
    box, _ = load_scene(Scenes.BoxTest)
    r = proxy._rays(*tensors(tc.proxy_edge_rays()))
    for name, px in (("k8", proxy.build_dense_proxy(pos, tri, k=8)),
                     ("k1365", proxy.build_dense_proxy(
                         pos, tri, k=proxy.MAX_COLUMNS)),
                     ("box_k24", proxy.build_dense_proxy(
                         box.positions.numpy(), box.tri_idx.numpy()))):
        px = px.to(DEVICE)
        got = proxy._launch_closest(px, r)
        ref = proxy.proxy_closest_plain(px, *r)
        row = rows[f"proxy_closest {name}"] = {
            "k": px.k, "rays": r[0].shape[0], "hits": int(got.hit.sum()),
            "mismatches_vs_plain": hit_bits_differ(got, ref)}
        if row["mismatches_vs_plain"] or not row["hits"]:
            bad.append(f"proxy_closest {name}")
    # the raster
    pos, tri = indexed(*tc.raster_edge_scene())
    w, h = 64, 32
    cam = FirstPersonCamera(aspect=w / h)
    frame = frame_from_numpy(cam.inv_view_projection(), cam.position,
                             [0, 1, 0], [1, 1, 1], [1, 1, 1], 1.0, 0.0,
                             0).to(DEVICE)
    o, d, length, _ = it.raygen(AppSettings(sqrt_num_samples=2), frame, w, h,
                                DEVICE)
    dims = it._packet_tile_dims(h, w)
    o, d, length = (it._tile_order(x, h, w, *dims) for x in (o, d, length))
    bins = swraster.build_raster_bins(
        pos, tri, np.asarray(cam.view_projection(), np.float64),
        float(cam.near_clip), w, h, *dims,
        history.build_tri_table(pos, tri)).to(DEVICE)
    rays = swraster._lanes(bins, o, d, 0.0, length, None)
    got = swraster._launch_kernel(bins, *rays)
    ref = swraster.raster_closest_hit_plain(bins, *rays)
    depth = (bins.tile_start[1:] - bins.tile_start[:-1]).cpu()
    ids = got.tri_id.cpu()
    row = rows["raster edge scene"] = {
        "rays": w * h, "deepest_tile": int(depth.max()),
        "empty_tiles": int((depth == 0).sum()),
        "stack_hits": int(((ids >= 0) & (ids < 800)).sum()),
        "repeated_quad_hits": int(((ids >= 800) & (ids < 804)).sum()),
        "repeated_quad_upper_copy": int(((ids >= 802) & (ids < 804)).sum()),
        "near_plane_triangle_hits": int((ids == 804).sum()),
        "mismatches_vs_plain": hit_bits_differ(got, ref)}
    if (row["mismatches_vs_plain"] or row["deepest_tile"] <= 320
            or not row["empty_tiles"] or not row["stack_hits"]
            or not row["repeated_quad_hits"]
            or row["repeated_quad_upper_copy"]
            or not row["near_plane_triangle_hits"]):
        bad.append("raster edge scene")
    for key, row in rows.items():
        log(f"S edge {key}: " + ", ".join(f"{k}={v}" for k, v in row.items()))
    if bad:
        raise SystemExit(f"chip_smoke: S edge cases {bad}: "
                         f"{[rows[k] for k in bad]}")
    return rows


def phase_seeded_routes(frame_sess, smi):
    """S: the three exact alternates of an opaque closest hit that the JAX
    package keeps off by default, each on its own 1080p stand-in session
    (one sample per pixel, path length 3): temporal history
    (DXRPT_HISTORY), proxy seeding (DXRPT_PROXY_SEED) and the software
    raster (DXRPT_RASTER_MIN_PIXELS=1), against the default route's frames
    on `frame_sess`; then their kernels' edge cases. Returns (results, the
    routes' launches)."""
    t0 = time.time()
    base_row, base_img = engine_run("default route", frame_sess,
                                    frame_sess.settings, {}, smi,
                                    frames=S_FRAMES, phase="S")
    out, runs = {"default": base_row}, [base_row["kernel_launches"]]
    for name, fn in (("history", s_history), ("proxy_seed", s_proxy),
                     ("raster", s_raster)):
        out[name], launches = fn(base_img, smi)
        runs.append(launches)
    out["edge_cases"] = s_edge_cases(smi)
    out["phase_s"] = time.time() - t0
    log(f"phase S: {out['phase_s']:.1f} s")
    return out, runs


# ---------------------------------------------------------------------------
# M: multi-device rendering (parallel/mesh.py), the shards on the one card
# ---------------------------------------------------------------------------

M_TIMED = 5  # M1: timed sharded steps, and unsharded samples beside them


def m_card():
    """The device every shard of phase M names (the card's index 0)."""
    return torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(
        DEVICE)


def m_timed(fn, repeat=M_TIMED):
    """(median ms of `repeat` synchronised calls of fn on the host clock,
    the last call's result)."""
    dts = []
    for _ in range(repeat):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        dts.append((time.time() - t0) * 1e3)
    return statistics.median(dts), out


def m_run(label, fn, calls, **per_call):
    """fn() between reset_launches and read_launches; the launches must
    be `per_call` times `calls` (check_launches). (result, launches)."""
    reset_launches()
    out = fn()
    sync()
    launches = read_launches()
    check_launches(label, launches, calls, **per_call)
    return out, launches


def phase_multi_device(sess, smi):
    """M1-M3 on the 1080p frame session (the default engines' route), every
    shard on the card: row shards against the unsharded render_sample of
    the same frame constants and accumulation, sample-parallel and 2x2
    steps against sequential samples. Returns (results, launches)."""
    import numpy as np

    from dxrpathtracer_tpu_torch.parallel import mesh as M
    from dxrpathtracer_tpu_torch.render.integrator import render_sample
    from dxrpathtracer_tpu_torch.render.swraster import build_raster_bins
    t_phase = time.time()
    w, h, s, card = sess.width, sess.height, sess.settings, m_card()
    grid = sess.update_sun_grid()
    eng = dict(sun_grid=grid, proxy=sess.proxy, cut=sess.cut,
               alpha_bvh=sess.bvh_alpha)
    frame = sess.frame_constants(sess.sample_idx)
    accum = sess.accum.clone()
    out = {"device_count": torch.cuda.device_count(), "card": smi}
    runs = []
    # the engines' route per shard: 2 per-ray walks, packet closest and
    # any, the grid, the proxy; the cut gated off
    route = dict(traverse=2, packet_closest=1, packet_any=1, sun_any_hit=1,
                 proxy_blocked=1, cut_clear=0)

    def unsharded(acc, **kw):
        return render_sample(sess.scene, sess.bvh, sess.bvh_ray,
                             sess.sky_cube, s, frame, w, h, acc, **eng, **kw)

    def sharded(step, mesh, acc, **kw):
        return step(sess.scene, sess.bvh, M.shard_accum(mesh, acc),
                    sess.sky_cube, frame, ray_bvh=sess.bvh_ray, **eng, **kw)

    ref = unsharded(accum)
    # M1: row shards
    rows = {}
    for n in (3, 4):
        mesh = M.make_render_mesh([card] * n)
        log(f"M1: {n} row shards of {h // n} rows on "
            f"{[str(d) for d in mesh.flat()]} (torch.cuda.device_count() "
            f"{torch.cuda.device_count()}: the shards run one after another "
            f"on the one card)")
        step = M.make_sharded_step(mesh, s, w, h)
        parts, launches = m_run(f"M1 {n} row shards", lambda: sharded(
            step, mesh, accum), n, **route)
        runs.append(launches)
        got = M.gather_shards(mesh, parts, card)
        r = {"shards": n, "rows_per_shard": h // n,
             "pixels_differ": int((got != ref).any(dim=-1).sum()),
             "rel_rmse": rel_rmse(got, ref),
             "bit_equal": bool(torch.equal(got, ref))}
        if n == 3:
            r["ms_sharded_median"], _ = m_timed(lambda: sharded(
                step, mesh, accum))
            r["ms_unsharded_median"], _ = m_timed(lambda: unsharded(accum))
        rows[f"rows_{n}"] = r
        log(f"M1 {n} row shards: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items()) + f" [{smi}]")
        if (n == 3 and not r["bit_equal"]) or r["rel_rmse"] > 1e-4:
            raise SystemExit(f"chip_smoke: M1 {n} row shards: {r}")
    # M1, the raster route: per-shard bins against the full frame's
    host = sess.scene_host
    args = (host.positions.numpy(), host.tri_idx.numpy(),
            np.asarray(sess.camera.view_projection(), np.float64),
            float(sess.camera.near_clip), w, h)
    mesh = M.make_render_mesh([card] * 3)
    t0 = time.time()
    shards = M.raster_shards(mesh, *args, sess._triangle_table())
    bin_s = time.time() - t0
    full = build_raster_bins(*args, shards[0].ty, shards[0].tx,
                             sess._triangle_table()).to(card)
    ref_r = unsharded(accum, raster=full)
    step = M.make_sharded_step(mesh, s, w, h)
    parts, launches = m_run("M1 raster shards", lambda: sharded(
        step, mesh, accum, raster=shards), 3,
        **{**route, "packet_closest": 0, "raster_closest_hit": 1})
    runs.append(launches)
    got = M.gather_shards(mesh, parts, card)
    rows["raster_3"] = r = {
        "shards": 3, "tile": [shards[0].ty, shards[0].tx],
        "pairs": [b.pairs for b in shards], "full_pairs": full.pairs,
        "shard_binning_s": bin_s,
        "pixels_differ": int((got != ref_r).any(dim=-1).sum()),
        "bit_equal": bool(torch.equal(got, ref_r)),
        "rel_rmse_vs_packet_route": rel_rmse(ref_r, ref)}
    log("M1 3 raster shards: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in r.items()))
    if not r["bit_equal"]:
        raise SystemExit(f"chip_smoke: M1 raster shards: {r}")
    out["rows"] = rows
    del ref, ref_r, got, parts, shards, full

    # M2, M3: sample-parallel (4 x 2 steps) and 2x2 (2 steps) against the
    # sequential samples 0..7 and 0..3, with the tables and the grid alone
    # (the steps' arguments, as in the JAX package)
    seq = torch.zeros((h, w, 3), dtype=torch.float32, device=card)
    for i in range(8):
        seq = render_sample(sess.scene, sess.bvh, sess.bvh_ray,
                            sess.sky_cube, s, sess.frame_constants(i), w, h,
                            seq, sun_grid=grid)
        if i == 3:
            seq4 = seq.clone()
    smesh = M.make_render_mesh([card] * 4, axis_name="samples")
    gmesh = M.RenderMesh([[card] * 2] * 2, ("samples", "rows"))
    for key, mesh, step, steps, want in (
            ("samples_4x2", smesh,
             M.make_sample_parallel_step(smesh, s, w, h), 2, seq),
            ("grid_2x2", gmesh, M.make_grid_step(gmesh, s, w, h), 2, seq4)):
        acc = M.shard_accum(mesh, torch.zeros(
            (mesh.shape["samples"], h, w, 3), dtype=torch.float32,
            device=card), axis_name="samples")

        def run(acc=acc, step=step, steps=steps):
            for i in range(steps):
                acc = step(sess.scene, sess.bvh, acc, sess.sky_cube,
                           sess.frame_constants(i), ray_bvh=sess.bvh_ray,
                           sun_grid=grid)
            return acc

        # per shard and step the route above, the terminal rays unscreened
        acc, launches = m_run(f"M {key}", run, mesh.size * steps,
                              **{**route, "proxy_blocked": 0})
        runs.append(launches)
        img = M.sample_parallel_image(M.gather_shards(mesh, acc, card))
        diff = (img - want).abs()
        r = {"shards": mesh.size, "steps": steps,
             "samples": mesh.shape["samples"] * steps,
             "rel_rmse": rel_rmse(img, want),
             "max_abs_diff": float(diff.max()),
             "allclose_1e-4": bool(torch.allclose(img, want, rtol=1e-4,
                                                  atol=1e-4))}
        out[key] = r
        log(f"M {key} ({'M2' if key.startswith('samples') else 'M3'}): "
            + ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                        else f"{k}={v}" for k, v in r.items()))
        if not r["allclose_1e-4"]:
            raise SystemExit(f"chip_smoke: M {key}: {r}")
    out["phase_s"] = time.time() - t_phase
    log(f"phase M1-M3: {out['phase_s']:.1f} s")
    return out, runs


def phase_multi_device_bake(baker, smi):
    """M4: one step of the 4096^2 bake over 4 texel-row shards on the card
    against Baker.bake_step at the same sample index, bit for bit (each
    shard walks its 1024 rows in the Baker's 512-row slabs). Advances the
    baker by that step. Returns (results, launches)."""
    from dxrpathtracer_tpu_torch.parallel import mesh as M
    sess, res, card = baker.session, baker.resolution, m_card()
    frame = sess.frame_constants(sess.sample_idx)
    index, acc0 = baker.sample_index, baker.accum.clone()
    grid = sess.update_sun_grid()
    mesh = M.make_render_mesh([card] * 4)
    step = M.make_sharded_bake_step(mesh, sess.settings, res)
    maps = baker.surface_maps
    pos, nrm = (M.shard_accum(mesh, maps[k]) for k in ("position", "normal"))

    def run():
        return step(sess.scene, sess.bvh_ray, M.shard_accum(mesh, acc0),
                    sess.sky_cube, frame, pos, nrm, index, sun_grid=grid,
                    proxy=sess.proxy)

    slab = M._slab_rows(res // 4, res)  # the Baker's 512 rows at 4096^2
    slabs = res // slab
    # per slab: 3 per-ray walks, 2 grid walks, the proxy
    per_slab = dict(traverse=3, sun_any_hit=2, proxy_blocked=1,
                    packet_closest=0, packet_any=0, cut_clear=0)
    sync()
    t0 = time.time()
    parts, launches = m_run("M4 bake shards", run, slabs, **per_slab)
    sharded_s = time.time() - t0
    got = M.gather_shards(mesh, parts, card)
    del parts
    sync()
    t0 = time.time()
    baker.bake_step()
    sync()
    baker_s = time.time() - t0
    out = {"shards": 4, "rows_per_shard": res // 4, "slab_rows": slab,
           "baker_slab_rows": baker._slab_rows, "sample_index": index,
           "step_s_sharded": sharded_s, "step_s_baker": baker_s,
           "texels_differ": int((got != baker.accum).any(dim=-1).sum()),
           "bit_equal": bool(torch.equal(got, baker.accum)), "card": smi}
    log("M4 bake, 4 texel-row shards: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in out.items()))
    if not out["bit_equal"]:
        raise SystemExit(f"chip_smoke: M4: {out}")
    return out, launches


# ---------------------------------------------------------------------------
# K: the split alpha route (opaque-only and K-candidate packet walks, the
# candidates' resolution, the masked raster bins) and the load-time alpha
# subdivision
# ---------------------------------------------------------------------------

K_FRAMES = 10            # K: frames after the first, per route
K_SAME_SIZE = (256, 128)  # K: card vs CPU, a packet-tileable size
CAND_BYTES = 16          # a candidate slot written: t, tri, u, v
SPLIT_KERNELS = ("packet_closest_opaque", "packet_any_opaque",
                 "packet_candidates")


def split_calls(sess):
    """One sample of `sess` under DXRPT_SPLIT_ALPHA=1 at
    max_any_hit_path_length 1, the integrator's calls of the packet walks
    recorded: [(function name, table, rays, keywords)]."""
    from dxrpathtracer_tpu_torch.render import integrator as it
    names = ("packet_closest_hit", "packet_any_hit_rec",
             "packet_closest_hit_alpha")
    originals = {n: getattr(it, n) for n in names}
    calls = []

    def wrap(name):
        def call(bvh, *rays, **kw):
            calls.append((name, bvh, tuple(
                x.clone() if isinstance(x, torch.Tensor) else x
                for x in rays), kw))
            return originals[name](bvh, *rays, **kw)
        return call

    for n in names:
        setattr(it, n, wrap(n))
    try:
        with env_var("DXRPT_SPLIT_ALPHA", "1"):
            sess.settings = sess.settings.replace(max_any_hit_path_length=1)
            sess.reset_accumulation()
            sess.render_frame()
            sync()
    finally:
        for n, f in originals.items():
            setattr(it, n, f)
    return calls


def split_mismatches(got, ref, k):
    """Lanes (or candidate slots) whose t, u, v, tri id, or overflow bit
    differ between two results of the same mode, and the largest |error|
    of t, u and v where both hit."""
    rec_g, rec_r = (got[0], ref[0]) if k else (got, ref)
    mism = hit_bits_differ(rec_g, rec_r)
    err = hit_abs_err((rec_g.t, rec_g.u, rec_g.v),
                      (rec_r.t, rec_r.u, rec_r.v), rec_g.hit & rec_r.hit)
    if k:
        cg, cr = got[1], ref[1]
        mism += sum(bits_differ(cg[f], cr[f]) for f in ("t", "u", "v"))
        mism += int((cg["tri"] != cr["tri"]).sum())
        mism += int((cg["overflow"] != cr["overflow"]).sum())
        both = (cg["tri"] >= 0) & (cr["tri"] >= 0)
        err = max(err, hit_abs_err((cg["t"], cg["u"], cg["v"]),
                                   (cr["t"], cr["u"], cr["v"]), both))
    return mism, err


def split_row(name, bvh, rays, first_hit, k, per_ray=None, phase="K"):
    """A split-route class: the opaque-only (k 0) or K-candidate kernel
    against its plain twin on the card, 0 lanes that differ; kernel and
    plain ms, the bound from the plain walk's counts, the walk's shape;
    `per_ray` (a function) times the default route's per-ray walk with the
    alpha test on the same rays."""
    from dxrpathtracer_tpu_torch.accel import packet
    lanes = packet._rays(bvh, *rays)
    n = lanes[0].shape[0]
    stats = {}
    ref = packet.packet_traverse_plain(bvh, *lanes, first_hit, stats,
                                       exclude_alpha=not k, k_cands=k)
    got = packet._launch_alpha_kernel(bvh, *lanes, first_hit, k)
    mism, err = split_mismatches(got, ref, k)
    rec = got[0] if k else got
    extra = {"rays": n, "active": int(lanes[5].sum()),
             "hits": int(rec.hit.sum()),
             "internal_visits": stats["internal"],
             "leaf_visits": stats["leaf"], "slot_tests": stats["slot_tests"],
             "triangle_tests": stats["tri_tests"],
             "rows": int(stats["touched"].sum()),
             "mismatches_vs_plain": mism, "max_abs_err": err}
    if k:
        c = got[1]
        full = c["tri"][:, -1] >= 0
        extra.update(k=k, candidates=int((c["tri"] >= 0).sum()),
                     full_buffers=int(full.sum()),
                     overflow=int(c["overflow"].sum()))
    if per_ray is not None:
        per_ray()
        extra["per_ray_alpha_walk_ms"] = cuda_ms(per_ray, repeat=3)[0]
    nbytes = (n * (RAY_IN_BYTES + HIT_BYTES + (k * CAND_BYTES + 1 if k
                                                else 0))
              + extra["rows"] * ROW_BYTES)
    ops = stats["slot_tests"] * SLAB_OPS + stats["tri_tests"] * MT_OPS
    row = engine_row(
        name, lambda: packet._launch_alpha_kernel(bvh, *lanes, first_hit, k),
        lambda: packet.packet_traverse_plain(bvh, *lanes, first_hit,
                                             exclude_alpha=not k, k_cands=k),
        nbytes, ops, extra, phase=phase)
    if mism:
        raise SystemExit(f"chip_smoke: K {name}: the kernel differs from "
                         f"its plain twin on {mism} lanes: {row}")
    return row


def k_classes(sess):
    """K's 1080p classes: one split-route sample recorded; each opaque-only
    and K-candidate call (K = 8, and K = 4 on the closest rays' candidate
    call) held against its plain twin, with the per-ray alpha walk on the
    same rays."""
    from dxrpathtracer_tpu_torch.accel import traverse
    from dxrpathtracer_tpu_torch.render.integrator import _make_alpha_test
    calls = split_calls(sess)
    want = [("packet_closest_hit", True), ("packet_closest_hit_alpha", 8),
            ("packet_any_hit_rec", True), ("packet_closest_hit_alpha", 8)]
    got = [(n, kw.get("exclude_alpha", kw.get("k_cands")))
           for n, _, _, kw in calls]
    if got != want:
        raise SystemExit(f"chip_smoke: K: the split route's calls {got}, "
                         f"want {want}")
    alpha = _make_alpha_test(sess.scene, sess.settings)
    (_, w8, closest, _), (_, ab, cand, _), (_, _, sun, _), \
        (_, _, sun_cand, _) = calls
    rows = {
        "d1_opaque_closest": split_row(
            "d1 opaque-only closest (W8)", w8, closest, False, 0,
            lambda: traverse.closest_hit(w8, *closest, alpha=alpha)),
        "d1_candidates_k8": split_row(
            "d1 candidates K=8 (alpha table)", ab, cand, False, 8,
            lambda: traverse.closest_hit(w8, *cand, alpha=alpha)),
        "d1_candidates_k4": split_row(
            "d1 candidates K=4 (alpha table)", ab, cand, False, 4),
        "d1_sun_opaque_any": split_row(
            "d1 sun opaque-only any hit (W8)", w8, sun, True, 0,
            lambda: traverse.any_hit(w8, *sun, alpha=alpha)),
        "d1_sun_candidates_k8": split_row(
            "d1 sun candidates K=8 (alpha table)", ab, sun_cand, False, 8)}
    # the whole split closest hit (both walks and the taps) against the
    # per-ray alpha walk on the camera rays
    from dxrpathtracer_tpu_torch.render import integrator as it
    from dxrpathtracer_tpu_torch.accel import packet
    split = lambda: it._split_alpha_closest(  # noqa: E731
        lambda *r: packet.packet_closest_hit(w8, *r, exclude_alpha=True),
        lambda *r: packet.packet_closest_hit_alpha(ab, *r, k_cands=8),
        alpha, *closest)
    split()
    rows["d1_split_closest_total_ms"] = cuda_ms(split, repeat=3)[0]
    log(f"K d1 split closest hit (both walks, the taps): "
        f"{rows['d1_split_closest_total_ms']:.4f} ms against the per-ray "
        f"alpha walk's {rows['d1_opaque_closest']['per_ray_alpha_walk_ms']:.4f}"
        f" ms on the same rays")
    for name in ("d1_candidates_k8", "d1_candidates_k4"):
        if rows[name]["full_buffers"] == 0 or rows[name]["candidates"] == 0:
            raise SystemExit(f"chip_smoke: K {name}: no full buffer")
    return rows


def k_edge_cases(dev):
    """The K-candidate cases of tools/traverse_cases.py, each kernel
    against its plain twin: the opaque-only walks (closest and any) on the
    scene's W8 table and the K-candidate walk on its alpha table (leaf 2,
    or 12 for "overflow"), 0 lanes that differ; each case must reach what
    it is made for."""
    import numpy as np

    from dxrpathtracer_tpu_torch.accel.bvh import (build_alpha_bvh_for_scene,
                                                   build_bvh_for_scene)
    from dxrpathtracer_tpu_torch.tools import traverse_cases as tc
    scene = tc.alpha_case_scene(*tc.kcand_case_meshes())
    w8 = build_bvh_for_scene(scene, width=8, flag_alpha=True).to(dev)
    tabs = {leaf: build_alpha_bvh_for_scene(scene, leaf_size=leaf).to(dev)
            for leaf in (2, 12)}
    rows = {}
    for name, (rays, leaf, k) in tc.kcand_cases().items():
        r = tuple(torch.from_numpy(np.ascontiguousarray(rays[f])).to(dev)
                  for f in tc.RAY_FIELDS)
        rows[f"{name} opaque closest"] = split_row(
            f"edge {name} opaque closest", w8, r, False, 0, phase="K edge")
        rows[f"{name} opaque any"] = split_row(
            f"edge {name} opaque any", w8, r, True, 0, phase="K edge")
        row = rows[f"{name} K={k}"] = split_row(
            f"edge {name} leaf {leaf} K={k}", tabs[leaf], r, False, k,
            phase="K edge")
        reach = {"overflow": row["overflow"] > 0,
                 "all_rejected": row["full_buffers"] > 0,
                 "equal_t": row["candidates"] > row["active"],
                 "inactive": row["active"] == row["rays"] - 128,
                 "k1": row["full_buffers"] > 0}[name]
        if not reach or (name != "overflow" and row["overflow"]):
            raise SystemExit(f"chip_smoke: K edge {name} does not reach "
                             f"what it is made for: {row}")
    return rows


def k_route(label, sess, env, any_hit, base_img, smi):
    """A split route's frames on `sess` (engine_run: a first frame and
    K_FRAMES more) under the environment `env`; its image against the
    default alpha route's (None for the default itself)."""
    with contextlib.ExitStack() as stack:
        for k, v in env.items():
            stack.enter_context(env_var(k, v))
        row, img = engine_run(label, sess, sess.settings,
                              {"max_any_hit_path_length": any_hit}, smi,
                              frames=K_FRAMES, phase="K")
    if base_img is not None:
        row["rel_rmse_vs_default"] = rel_rmse(img, base_img)
        row["pixels_differ_vs_default"] = int(
            (img != base_img).any(dim=-1).sum())
        log(f"K {label}: image vs the default alpha route rel RMSE "
            f"{row['rel_rmse_vs_default']:.3e}, "
            f"{row['pixels_differ_vs_default']} pixels differ [{smi}]")
    return row, img


def k_same_frame(dev, scene, env, any_hit, size):
    """One frame of a K route at `size` on `dev`: SponzaAlpha-checker (or
    `scene`, a (scene, preset) pair), path length 3, under the environment
    `env`, the launch counts set to 0 before it: (seconds, image on the
    CPU, the launches, the candidates the resolution tapped, whether the
    session's raster bins hold only opaque triangles (None without
    bins))."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.render import integrator as it
    from dxrpathtracer_tpu_torch.tools.alpha_cases import sponza_alpha_checker
    scene, preset = scene or sponza_alpha_checker()
    resolve, tapped = it._resolve_candidates, []

    def counting(rec, cands, accept):
        tapped.append(int(((cands["tri"] >= 0)
                           & (cands["t"] < rec.t[:, None])).sum()))
        return resolve(rec, cands, accept)

    t0 = time.time()
    it._resolve_candidates = counting
    try:
        with contextlib.ExitStack() as stack:
            for k, v in env.items():
                stack.enter_context(env_var(k, v))
            sess = RenderSession(
                AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                            max_path_length=3,
                            max_any_hit_path_length=any_hit),
                *size, device=dev, scene=scene, preset=preset)
            reset_launches()
            sess.render_frame()
            img = sess.accum.cpu()
            launches = read_launches()
    finally:
        it._resolve_candidates = resolve
    bins = sess.raster_bins
    return (time.time() - t0, img, launches, sum(tapped),
            None if bins is None else bool(bins.opaque_only))


# K's card-vs-CPU routes: (environment, max_any_hit_path_length, the
# subdivided scene's, the split kernels' launches in one frame:
# packet_closest_opaque, packet_any_opaque, packet_candidates)
K_SAME_ROUTES = {
    "split_3": ({"DXRPT_SPLIT_ALPHA": "1"}, 3, False, (1, 1, 2)),
    "split_raster_1": ({"DXRPT_SPLIT_ALPHA": "1",
                        "DXRPT_RASTER_MIN_PIXELS": "1"}, 1, False, (0, 1, 2)),
    "alpha_split_1": ({}, 1, True, (0, 0, 0))}


def k_same(split_scene):
    """Each K route's frame at K_SAME_SIZE on the card now and on the CPU
    (the plain twins) in the workers; `split_scene` is the subdivided
    (scene, preset). Returns the check, a function that waits for the CPU
    frames and holds each route at rel-RMSE <= 1e-4, the split kernels'
    launches, candidates tapped and masked bins as the route wants."""
    card, cpu = {}, {}
    for label, (env, any_hit, subdivided, _) in K_SAME_ROUTES.items():
        scene = split_scene if subdivided else None
        cpu[label] = cpu_submit(k_same_frame, "cpu", scene, env, any_hit,
                                K_SAME_SIZE)
        card[label] = k_same_frame(DEVICE, scene, env, any_hit, K_SAME_SIZE)
        log(f"K same {label} {K_SAME_SIZE} on {DEVICE}: "
            f"{card[label][0]:.2f} s")
    return lambda: k_same_readings(card, cpu)


def k_same_readings(card, cpu_jobs):
    """K's card-vs-CPU readings, once the workers' CPU frames are in."""
    out = {}
    for label, (env, _, _, want) in K_SAME_ROUTES.items():
        secs, ref, ref_launches, ref_tapped, ref_masked = cpu_jobs[label].get()
        _, got, launches, tapped, masked = card[label]
        log(f"K same {label} {K_SAME_SIZE} on cpu (a worker): {secs:.2f} s")
        split = tuple(launches[k] for k in SPLIT_KERNELS)
        split_cpu = tuple(ref_launches[k] for k in SPLIT_KERNELS)
        rel = rel_rmse(got, ref)
        out[label] = {"rel_rmse": rel, "bit_equal_fraction": float(
            (got == ref).float().mean()), "split_launches": split,
            "candidates_tapped": tapped, "candidates_tapped_cpu": ref_tapped,
            "masked_bins": masked, "masked_bins_cpu": ref_masked}
        log(f"K same {label}: rel RMSE cuda (kernels) vs cpu (plain twins) "
            f"{rel:.3e}, {out[label]['bit_equal_fraction']:.4f} of values "
            f"bit-equal; split launches {split} on the card, {split_cpu} "
            f"on the CPU; candidates tapped {tapped} and {ref_tapped}; "
            f"bins masked {masked} and {ref_masked}")
        split_route = "DXRPT_SPLIT_ALPHA" in env
        masked_want = True if "DXRPT_RASTER_MIN_PIXELS" in env else None
        if not (rel <= 1e-4 and bool(ref.isfinite().all())
                and float(ref.abs().max()) > 0 and split == want
                and not any(split_cpu) and (tapped > 0) == split_route
                and (ref_tapped > 0) == split_route
                and masked == masked_want and ref_masked == masked_want):
            raise SystemExit(f"chip_smoke: K same {label}: {out[label]}, "
                             f"want split launches {want}")
    return out


def phase_split_alpha(sess, smi):
    """K: the split alpha route on SponzaAlpha-checker at 1080p, path length
    3 (`sess`, phase_alpha's session): its classes kernel against plain,
    the edge cases, the routes' frames beside the default alpha route's;
    its card-vs-CPU check (k_same) follows. Returns (results, the routes'
    launches, the subdivided (scene, preset))."""
    from dxrpathtracer_tpu_torch.app.session import RenderSession
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    from dxrpathtracer_tpu_torch.scene import alphasplit
    from dxrpathtracer_tpu_torch.tools import alpha_cases
    t0 = time.time()
    out = {"alpha_table": {"rows": sess.bvh_alpha.num_rows,
                           "leaf_size": sess.bvh_alpha.leaf_size}}
    log(f"K: the alpha-only table {sess.bvh_alpha.num_rows} rows, leaf "
        f"{sess.bvh_alpha.leaf_size}")
    out["classes"] = k_classes(sess)
    out["edge_cases"] = k_edge_cases(sess.device)
    runs, launches = {}, []
    split = {"DXRPT_SPLIT_ALPHA": "1"}
    for any_hit in (1, 3):
        runs[f"default_{any_hit}"], base = k_route(
            f"default alpha route, max_any_hit {any_hit}", sess, {},
            any_hit, None, smi)
        runs[f"split_{any_hit}"], _ = k_route(
            f"split alpha, max_any_hit {any_hit}", sess, split, any_hit,
            base, smi)
        if any_hit == 1:
            runs["split_raster_1"], _ = k_route(
                "split alpha + masked bins, max_any_hit 1", sess,
                {**split, "DXRPT_RASTER_MIN_PIXELS": "1"}, 1, base, smi)
            bins = sess.raster_bins
            if bins is None or not bins.opaque_only:
                raise SystemExit("chip_smoke: K: the split route's raster "
                                 "bins are not masked")
            runs["split_raster_1"]["masked_bins_pairs"] = bins.pairs
            base_1 = base
    for name in ("split_1", "split_3", "split_raster_1"):
        lp = runs[name]["launches_per_frame"]
        if not (lp["packet_closest_opaque"] == (0 if "raster" in name else 1)
                and lp["packet_any_opaque"] == 1
                and lp["packet_candidates"] == 2):
            raise SystemExit(f"chip_smoke: K {name}: launches per frame "
                             f"{lp}")
        launches.append(runs[name]["kernel_launches"])

    # the load-time subdivision: its own scene and session
    recorded = []
    split_fn = alphasplit.split_alpha_meshes

    def record(*a, **kw):
        res = split_fn(*a, **kw)
        recorded.append(res[2])
        return res

    alphasplit.split_alpha_meshes = record
    try:
        with env_var("DXRPT_ALPHA_SPLIT", "1"):
            t1 = time.time()
            scene, preset = alpha_cases.sponza_alpha_checker()
            build_s = time.time() - t1
    finally:
        alphasplit.split_alpha_meshes = split_fn
    asess = RenderSession(AppSettings(current_scene=Scenes.Sponza,
                                      benchmark_mode=True, max_path_length=3),
                          *FRAME_SIZE, device=DEVICE, scene=scene,
                          preset=preset)
    stats = recorded[0]
    out["alpha_split"] = {"stats": stats, "scene_build_s": build_s,
                          "triangles": scene.num_triangles,
                          "alpha_table_rows": (asess.bvh_alpha.num_rows
                                               if asess.bvh_alpha else 0)}
    log(f"K alpha split (level 4): {stats}, scene {scene.num_triangles} "
        f"triangles (built in {build_s:.2f} s), W8 {asess.bvh.num_rows} rows")
    runs["alpha_split_1"], _ = k_route(
        "load-time alpha split, max_any_hit 1", asess, {}, 1, base_1, smi)
    launches.append(runs["alpha_split_1"]["kernel_launches"])
    out["runs"] = runs
    del asess
    torch.cuda.empty_cache()
    out["phase_k_s"] = time.time() - t0
    log(f"phase K: {out['phase_k_s']:.1f} s (its card-vs-CPU check, "
        f"k_same, follows)")
    return out, launches, (scene, preset)


# ---------------------------------------------------------------------------
# T: training the learned denoiser (tools/train_denoiser.py)
# ---------------------------------------------------------------------------

# The JAX repository's recipe for the shipped weights (its trainer's
# defaults): the net's ARCH, 1, 2 and 4 spp bakes against a 96-spp reference
# at 192^2, 2048 patches of 64^2, batch 16, 3000 Adam steps at lr 1e-3. The
# one cut: BoxTest alone, not BoxTest and Stronghold, whose stand-in's
# charted atlas takes ~15 minutes on the host.
T_SCENE, T_RES, T_NOISY, T_REF = "BoxTest", 192, (1, 2, 4), 96
T_PATCH, T_PATCHES, T_BATCH, T_STEPS, T_LR, T_SEED = 64, 2048, 16, 3000, \
    1e-3, 0
T_LAST = 200   # the steps whose mean loss must be below the first step's
# One step on the card against the CPU, from the same weights and batch:
# loss within T_LOSS_RTOL, every gradient within T_GRAD_TOL of its layer's
# largest. A weight's gradient sums 65,536 texels' products, which cancel:
# it is small against its terms, so the float32 rounding of the sum is
# large against it; cuDNN picks the order per run (implicit GEMM, FFT, and
# a nondeterministic backward). Read on an H100: 8.4e-6 to 9.2e-5 in three
# runs (the CPU tests read ~1e-6 between XLA's and torch's CPU
# convolutions on 4 patches of 16^2). A wrong gradient (the tie rules of
# max or abs, a missing factor) differs by 1e-2 or more.
T_LOSS_RTOL, T_GRAD_TOL = 1e-5, 1e-3
T_EVAL_RES = 64  # make_denoise_eval: BoxTest, 1 and 2 spp against 8


@contextlib.contextmanager
def tee_stderr():
    """What the block writes to sys.stderr, still written there, also in
    the yielded StringIO."""
    import io

    class Tee(io.StringIO):
        def write(self, text):
            real.write(text)
            return super().write(text)

    real, buf = sys.stderr, Tee()
    sys.stderr = buf
    try:
        yield buf
    finally:
        sys.stderr = real


@contextlib.contextmanager
def step_events(td, events, first_done):
    """train_step wrapped to record a CUDA event after each step (no
    synchronise): the intervals between them are the loop's steps on the
    card's timeline. After the first step alone it synchronises and
    appends the host clock to `first_done`: train's set-up (the patches'
    upload, the optimizer) and the first step (cuDNN's and the
    optimizer's first calls) end there."""
    step = td.train_step

    def timed(*args):
        loss = step(*args)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if not first_done:
            sync()
            first_done.append(time.time())
        return loss

    td.train_step = timed
    try:
        yield
    finally:
        td.train_step = step


def t_step_card_vs_cpu(td, net, feats, refs, masks):
    """One batch's loss and gradients from the trained weights, on the card
    and on the CPU: (loss relative difference, per parameter the largest
    gradient difference over its largest gradient, the card's loss)."""
    import copy
    import numpy as np
    idx = np.random.default_rng(T_SEED + 1).integers(0, feats.shape[0],
                                                     T_BATCH)
    out = {}
    for dev in (DEVICE, "cpu"):
        m = copy.deepcopy(net).to(dev)
        m.zero_grad(set_to_none=True)
        batch = [torch.as_tensor(np.ascontiguousarray(a[idx]), device=dev)
                 .permute(0, 3, 1, 2) for a in (feats, refs, masks)]
        loss = td.denoise_loss(m, *batch)
        loss.backward()
        out[dev] = (float(loss.detach()),
                    [p.grad.cpu() for p in m.parameters()])
    (lc, gc), (lh, gh) = out[DEVICE], out["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    grad_rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(gc, gh)]
    return loss_rel, grad_rel, lc


def phase_train(smi):
    """The trainer's functions on the card (dxrpathtracer_tpu_torch/tools/
    train_denoiser.py), as its main runs them: bake_dataset, make_patches,
    train; then one step against the CPU, save_net / load_net, evaluate
    with learned_denoise(net=), and the eval-set tool."""
    import numpy as np
    from dxrpathtracer_tpu_torch.render.learned_denoise import (load_net,
                                                                save_net)
    from dxrpathtracer_tpu_torch.tools import make_denoise_eval
    from dxrpathtracer_tpu_torch.tools import train_denoiser as td
    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    with tee_stderr() as err:
        pairs = td.bake_dataset(T_SCENE, T_RES, T_NOISY, T_REF, DEVICE)
    bake_s = time.time() - t0
    atlas_s = float(re.search(r"charted atlas ([0-9.]+)s",
                              err.getvalue()).group(1))
    t0 = time.time()
    feats, refs, masks = td.make_patches(pairs, T_PATCH, T_PATCHES,
                                         np.random.default_rng(T_SEED),
                                         DEVICE)
    patch_s = time.time() - t0
    if feats.shape != (T_PATCHES, T_PATCH, T_PATCH, 13):
        raise SystemExit(f"chip_smoke: T patches {feats.shape}")
    events, first_done = [], []
    sync()
    t0 = time.time()
    with step_events(td, events, first_done):
        net, losses = td.train(feats, refs, masks, T_STEPS, T_BATCH, T_LR,
                               T_SEED, device=DEVICE)
    sync()
    train_s = time.time() - t0
    first_s = first_done[0] - t0
    rest_ms = (train_s - first_s) / (T_STEPS - 1) * 1e3
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    med_ms = statistics.median(step_ms)
    first, last = float(losses[0]), float(losses[-T_LAST:].mean())
    log(f"T: {T_SCENE} {T_RES}^2, spp {T_NOISY} vs {T_REF}: charted atlas "
        f"{atlas_s:.2f} s, bakes {bake_s:.2f} s (atlas included); "
        f"{T_PATCHES} patches of {T_PATCH}^2 in {patch_s:.2f} s; {T_STEPS} "
        f"steps of batch {T_BATCH} in {train_s:.2f} s "
        f"({train_s / T_STEPS * 1e3:.3f} ms/step): set-up and first step {first_s:.2f} s, then "
        f"{rest_ms:.3f} ms/step; median step {med_ms:.3f} ms (CUDA events, "
        f"{len(step_ms)} intervals); peak device memory {peak_gib:.2f} GiB "
        f"[{smi}]")
    counts = {k: v for k, v in launches.items()
              if k != "traverse_by_instance"}
    log(f"T: loss first step {first:.5f}, mean of the last {T_LAST} "
        f"{last:.5f}; launches of the bakes and the training {counts}")
    if not (np.isfinite(losses).all() and np.isfinite(feats).all()
            and all(np.isfinite(a).all() for p in pairs for a in p[:4])):
        raise SystemExit("chip_smoke: T losses, patches or bakes not finite")
    if not last < first:
        raise SystemExit(f"chip_smoke: T mean loss of the last {T_LAST} "
                         f"steps {last} not below the first step's {first}")
    if launches["traverse"] == 0 or launches["row_gather"] == 0:
        raise SystemExit(f"chip_smoke: T bakes launched {launches}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise SystemExit("chip_smoke: T turned TF32 on")

    loss_rel, grad_rel, step_loss = t_step_card_vs_cpu(td, net, feats, refs,
                                                       masks)
    log(f"T: one step card vs CPU from the trained weights: loss "
        f"{step_loss:.6f}, rel diff {loss_rel:.3e} (<= {T_LOSS_RTOL}); "
        f"gradients max diff / max, weight and bias of each layer "
        + ", ".join(f"{x:.1e}" for x in grad_rel) + f" (<= {T_GRAD_TOL})")
    if not (loss_rel <= T_LOSS_RTOL and max(grad_rel) <= T_GRAD_TOL):
        raise SystemExit("chip_smoke: T step differs between card and CPU")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        path = os.path.join(tmp, "weights.npz")
        save_net(net, path)
        back = load_net(DEVICE, path)
        same = all(torch.equal(a, b) for a, b in
                   zip(net.state_dict().values(), back.state_dict().values()))
        if not same:
            raise SystemExit("chip_smoke: T reloaded weights differ")
        rows = td.evaluate(back, pairs)
        for spp, row in zip(T_NOISY, rows):
            log(f"T: eval {spp} spp log-RMSE noisy / guided / learned "
                + " / ".join(f"{x:.4f}" for x in row))
        if not (all(r is not None and np.isfinite(r).all() for r in rows)
                and rows[0][2] < rows[0][1]):
            raise SystemExit(f"chip_smoke: T learned not below guided at "
                             f"1 spp: {rows}")
        t0 = time.time()
        eval_path = os.path.join(tmp, "eval.npz")
        make_denoise_eval.main(["--scene", "BoxTest", "--resolution",
                                str(T_EVAL_RES), "--noisy-spp", "1,2",
                                "--ref-spp", "8", "--out", eval_path,
                                "--device", DEVICE])
        eval_s = time.time() - t0
        with np.load(eval_path) as z:
            maps = [z[f"{k}{i}"] for i in range(int(z["count"]))
                    for k in ("noisy", "ref", "albedo", "normal")]
            ok = (int(z["count"]) == 2 and list(z["spps"]) == [1, 2]
                  and bytes(z["scene"]) == b"BoxTest"
                  and all(a.dtype == np.float16
                          and a.shape == (T_EVAL_RES, T_EVAL_RES, 3)
                          and np.isfinite(a).all() for a in maps)
                  and z["valid0"].dtype == bool and z["valid0"].any())
        if not ok:
            raise SystemExit("chip_smoke: T make_denoise_eval's file is not "
                             f"2 finite BoxTest pairs at {T_EVAL_RES}^2")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.time() - t_phase
    log(f"T: make_denoise_eval BoxTest {T_EVAL_RES}^2 (1, 2 vs 8 spp) "
        f"{eval_s:.2f} s; "
        f"weights read back bit for bit; phase T {phase_s:.1f} s")
    return {"scene": T_SCENE, "resolution": T_RES, "noisy_spp": T_NOISY,
            "ref_spp": T_REF, "patch": T_PATCH, "patches": T_PATCHES,
            "batch": T_BATCH, "steps": T_STEPS, "lr": T_LR,
            "atlas_s": atlas_s, "bake_s": bake_s, "patch_s": patch_s,
            "train_s": train_s, "step_ms_mean": train_s / T_STEPS * 1e3,
            "setup_first_step_s": first_s, "step_ms_after_first": rest_ms,
            "step_ms_median": med_ms, "peak_memory_gib": peak_gib,
            "loss_first": first, "loss_last_mean": last,
            "losses_every_100": [float(x) for x in losses[::100]],
            "step_card_vs_cpu": {"loss_rel": loss_rel, "grad_rel": grad_rel},
            "eval": rows, "eval_tool_s": eval_s, "phase_s": phase_s,
            "kernel_launches": launches, "card": smi}, launches


def main():
    smi = phase_device()
    sys.path.insert(0, ROOT)
    build = phase_build()
    adversarial = phase_adversarial()
    division = phase_division(smi)
    frame_sess, main_path, (classes, _, trav, d1_hits, opaque_inst), \
        frame_launches = phase_main_path(smi)
    same = phase_same_frame()
    box_sess = engine_session("BoxTest")
    engines = phase_engine_classes(frame_sess, box_sess, smi)
    engine_ab, engine_launches = phase_engine_ab(frame_sess, box_sess, smi)
    del box_sess
    torch.cuda.empty_cache()
    seeded, seeded_launches = phase_seeded_routes(frame_sess, smi)
    multi, multi_launches = phase_multi_device(frame_sess, smi)
    torch.cuda.empty_cache()
    alpha, (alpha_classes, _, alpha_trav, _, alpha_inst), alpha_launches, \
        alpha_sess = phase_alpha(smi)
    split_alpha, split_launches, split_scene = phase_split_alpha(alpha_sess,
                                                                smi)
    del alpha_sess
    torch.cuda.empty_cache()
    # from here on the workers render the card-vs-CPU checks' CPU frames,
    # R4's (the longest) first; each check reads its frames at the end
    raster_cpu = same_raster_cpu_frames()
    k_check = k_same(split_scene)
    same_alpha_check = phase_same_alpha_frame()
    render = phase_render_command(smi)
    torch.cuda.empty_cache()
    baker, bake, bake_launches = phase_bake(smi)
    engine_bake = phase_engine_bake_classes(baker, smi)
    bake_ab, bake_ab_launches = phase_engine_bake_ab(baker, smi)
    gathers = phase_gather(frame_sess, d1_hits, baker)
    multi["bake"], m4_launches = phase_multi_device_bake(baker, smi)
    same_bake = phase_same_bake()
    engine_same = phase_engine_same_frame(smi)
    shade = gathers["b_shading_row"]
    del frame_sess, baker
    torch.cuda.empty_cache()

    with cpu_workers_paused():
        raster_opaque, r1_launches = phase_raster_opaque(smi)
        torch.cuda.empty_cache()
        raster_sess, raster_alpha, r2_launches = phase_raster_alpha(smi)
    raster_rows, _, raster_trav, _, _ = phase_kernel_vs_plain(
        raster_sess, "R3 raster ray classes", raster_classes(raster_sess))
    del raster_sess
    torch.cuda.empty_cache()
    same_raster_check = phase_same_raster_frame(raster_cpu)
    raster_commands = phase_raster_commands(smi)
    torch.cuda.empty_cache()
    fbx_import, (fbx_classes, _, fbx_trav, _, fbx_inst), fbx_launches = \
        phase_fbx(smi)
    torch.cuda.empty_cache()
    anim, (anim_classes, _, anim_trav, _, anim_inst), anim_launches = \
        phase_animate(smi)
    torch.cuda.empty_cache()
    viewer, viewer_launches = phase_interactive(smi)
    t0 = time.time()
    same_alpha = same_alpha_check()
    same_raster = same_raster_check()
    split_alpha["same"] = k_check()
    stop_cpu_workers()
    log(f"card-vs-CPU checks of C, R4 and K: waited {time.time() - t0:.1f} s "
        f"for the workers' CPU frames")
    torch.cuda.empty_cache()
    training, t_launches = phase_train(smi)

    # each traversal instantiation: its launches on the main paths (the
    # opaque frame, the alpha frames, the bake, the raster frames, the
    # imported frame, the animation, the viewer) and its ray classes' sums
    runs = [frame_launches, *alpha_launches, bake_launches, r1_launches,
            *r2_launches, fbx_launches, anim_launches, viewer_launches,
            *engine_launches, *bake_ab_launches, *seeded_launches,
            *split_launches, *multi_launches, m4_launches, t_launches]
    entries = []
    for key in INSTANCES:
        name = instance_name(key)
        launches = sum(r["traverse_by_instance"].get(name, 0) for r in runs)
        inst = (alpha_inst if key[2] else opaque_inst).get(key)
        if launches == 0 or inst is None:
            raise SystemExit(f"chip_smoke: traversal {name}: {launches} "
                             f"launches on the main paths, classes {inst}")
        err = max(i[key]["max_abs_err"] for i in (opaque_inst, alpha_inst,
                                                  fbx_inst, anim_inst)
                  if key in i)
        entries.append({
            "name": f"traverse_{name}", "route": "cuda",
            "source": TRAVERSE_SOURCE, "replaces": TRAVERSE_REPLACES,
            "launches": launches, "max_abs_err": err,
            "ms": inst["ms"], "plain_ms": inst["plain_ms"],
            "bound_ms": inst["bound_ms"], "bound_by": inst["bound_by"],
            "library_ms": None})
    entries.append(
        {"name": "row_gather", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": GATHER_REPLACES,
         "launches": sum(r["row_gather"] for r in runs),
         "max_abs_err": max(c["max_abs_err"] for c in gathers.values()),
         "ms": shade["ms"], "plain_ms": shade["plain_ms"],
         "bound_ms": shade["bound_ms"], "bound_by": shade["bound_by"],
         "library_ms": shade["library_ms"]})
    # each engine kernel: its launches on the main paths (those runs, E2's
    # configurations and S's routes), its E1 class on the 1080p stand-in
    # (the cut's on 1080p BoxTest, where its probe gates it on), or for the
    # routes' kernels their S class
    e1_class = {"packet_closest": "d1_closest", "packet_any": "d1_sun",
                "sun_any_hit": "d2_sun", "proxy_blocked": "proxy_terminal",
                "cut_clear": "cut_box_d1_closest"}
    s_class = {"history_revalidate": ("history", "d1_closest"),
               "proxy_closest": ("proxy_seed", "d2_closest"),
               "raster_closest_hit": ("raster", "d1_camera")}
    k_class = {"packet_closest_opaque": "d1_opaque_closest",
               "packet_any_opaque": "d1_sun_opaque_any",
               "packet_candidates": "d1_candidates_k8"}
    for name, (source, replaces) in ENGINE_KERNELS.items():
        launches = sum(r[name] for r in runs)
        if name in k_class:
            row = split_alpha["classes"][k_class[name]]
        elif name in s_class:
            route, cls = s_class[name]
            row = seeded[route]["classes"][cls]
        else:
            row = engines["classes"][e1_class[name]]
        if launches == 0:
            raise SystemExit(f"chip_smoke: {name}: no launch on the main "
                             f"paths")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    # the grid's alpha instantiation: no route sends sun rays to it, so its
    # launches are phase A's check's
    ga = alpha["grid_alpha"]["total"]
    if ga["launches"] == 0:
        raise SystemExit("chip_smoke: sun_any_hit_alpha never launched")
    entries.append({
        "name": "sun_any_hit_alpha", "route": "cuda",
        "source": ENGINE_KERNELS["sun_any_hit"][0],
        "replaces": ENGINE_KERNELS["sun_any_hit"][1],
        "launches": ga["launches"], "max_abs_err": ga["max_abs_err"],
        "ms": ga["ms"], "plain_ms": ga["plain_ms"],
        "bound_ms": ga["bound_ms"], "bound_by": ga["bound_by"],
        "library_ms": None})
    kernels = {"kernels": entries}
    instances = {instance_name(k): v
                 for k, v in {**opaque_inst, **alpha_inst}.items()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build": build, "ray_classes": classes,
                   "traversal_total": trav, "adversarial": adversarial,
                   "main_path": main_path, "same_frame": same,
                   "alpha_ray_classes": alpha_classes,
                   "alpha_traversal_total": alpha_trav, "alpha_frame": alpha,
                   "same_alpha_frame": same_alpha, "render_command": render,
                   "traversal_instances": instances, "bake": bake,
                   "gather": gathers, "same_bake": same_bake,
                   "raster_opaque": raster_opaque,
                   "raster_alpha": raster_alpha,
                   "raster_ray_classes": raster_rows,
                   "raster_traversal_total": raster_trav,
                   "same_raster_frame": same_raster,
                   "raster_commands": raster_commands,
                   "division_check": division, "fbx_import": fbx_import,
                   "fbx_ray_classes": fbx_classes,
                   "fbx_traversal_total": fbx_trav, "animate": anim,
                   "animate_ray_classes": anim_classes,
                   "animate_traversal_total": anim_trav,
                   "interactive": viewer, "engine_classes": engines,
                   "engine_bake_classes": engine_bake, "engine_ab": engine_ab,
                   "engine_bake_ab": bake_ab,
                   "engine_same_frame": engine_same,
                   "seeded_routes": seeded, "split_alpha": split_alpha,
                   "multi_device": multi, "training": training,
                   **kernels}, f,
                  indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_cpu_workers()
