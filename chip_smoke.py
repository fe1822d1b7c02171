#!/usr/bin/env python3
"""Drive the PyTorch port's render (serving) path, its training step, the
flagship training step (also on device meshes: data and grid tensor
parallelism), the train CLI and its stochastic-corner estimators,
the render CLI with its baked preview, the interactive preview,
evaluation (the closed-set and open-vocabulary CLIs and a reference
checkpoint's import), the interactive labelling backend (the GUI's
backend process, the user simulation, online mapping), camera
registration with joint pose refinement, the teacher towers
(DemoCLIP trained through its CLI, DINO, FCN-ResNet50, LSeg, the CLIP text
tower, compute_feature_maps), and mapping (bundle adjustment through K9,
IncrementalSfM's cv2-free stages, the mapping CLI's scale and bounds),
the online ROS node and the labelling window, on one CUDA card.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --mesh-cards {1,4}  # phase 19 alone (4: a card a rank)
    python3 chip_smoke.py --phase 20  # phase 20 alone

Phases, each failing loudly:
  1. the card's name and power limit, torch and CUDA versions, and which
     of cv2, PIL, h5py, sklearn, pandas and matplotlib import (in a
     child);
  2. build every kernel of both paths from csrc/ (nvcc, sm_90a, one
     process per source, in parallel);
  3. hold the hash-grid encode kernel (K1) against its plain version at
     TPU_GRID (N = 524,288, x including 0 and 1) and at the reference
     preset (16 x 2 x 2^19, N = 65,536); time it at both (the reference
     preset's narrow rows at N = 524,288 too), with the bytes its gathers
     read beside its bound, and print its launch shapes (blocks, threads,
     shared bytes, blocks per SM, registers) as the C library plans them;
  4. hold the fused head kernel (K3f, N = 524,288) and the proposal MLP
     kernel (K4f, N = 1,048,576) against their plain versions; print
     their launch shapes;
  5. the render slice: a full-width model (TPU_GRID trilinear encode
     through K1, fused heads through K3f, the 36-64-64-1 proposal net
     through K4f, hidden 128, geo 15, 64 semantic features, 6 classes,
     bound 2) with seeded random weights is written as a numpy checkpoint,
     loaded through InferenceModel.from_checkpoint, and renders 2 frames of
     480 x 360 (num_steps 32, proposal_steps 64, max_ray_batch 16384: 11
     chunks a frame), with every launch count set to 0 just before and read
     just after; the same render with the plain versions swapped in is the
     reference; before it, K1 is held and timed on the main samples of one
     render chunk (16,384 rays x 32, in ray order), recorded from a render;
  6. ms per frame, rays/s and each kernel's time from CUDA events; the
     steady state, frames rendered in turns (plain, kernels, kernels,
     plain) with their median and quartiles; one frame under
     torch.profiler for device time by kernel and the device's busy share;
  7. the backward kernels alone at the training step's shapes: the
     hash-grid table gradient (K2) at TPU_GRID (N = 131,072, x including 0
     and 1) and at the reference preset, each element within the stated
     bound of two fp32 summation orders (hashgrid_cuda.backward_tolerance),
     with its atomics floor (as many float4 atomic rows into random rows
     of 16 and 64 MiB); its narrow rows at the reference presets' N =
     524,288 on the 'native', 'tcnn' and 'torch_ngp' lattices, uniform
     and ray-ordered points, timed on the tcnn one beside its bound, its
     16-byte request floor, its plain version and one index_add_ of the
     pre-weighted corner rows (k2_yardstick); the fused head backward
     (K3b, N = 131,072) and the
     proposal-MLP backward (K4b, N = 262,144) against their plain versions
     (K3b's dA and dB also against the fp32 plain version, no further from
     it than the bf16 plain version is; K3b's and K4b's weight gradients
     bit-equal across two launches), with their times, bounds and the
     autograd backward of the bf16 torch.matmul chains as the library
     yardstick (by CUDA events and by the profiler's device time); K2's,
     K3b's and K4b's launch shapes, K3b's peak memory and its breakdown:
     device time by kernel from torch.profiler, beside K3f at the same N
     (the recompute alone);
  8. the training slice: SimpleTrainer on the same full-width model (all
     six kernels: K1, K2, K3f, K3b, K4f, K4b), batch 4096, proposal 64 ->
     32, perturbed, exact trilinear gathers, on ray batches of a procedural
     scene (a sphere coloured and labelled by its normal, seen from 8
     cameras). (a) one step with the kernels against one with the plain
     versions, same params and draws: loss parts and every parameter's
     gradient; (b) 200 steps through train_iterations, every launch count
     set to 0 just before and read just after: each kernel launched once a
     step, every loss finite, the held-out rgb loss falling; then K2
     held and timed on the (g, x) of one more step's backward, the main
     path's own ray-ordered samples; (c) ms per
     step and rays/s in turns (plain, kernels, kernels, plain); (d) one
     step's peak memory, and one step under torch.profiler; (e) the trained model's checkpoint served
     through InferenceModel.from_checkpoint, equal to the trainer's own
     render;
  9. the flagship step: SimpleTrainer on bench.py's model (TPU_GRID with
     simplex interpolation, as model_utils builds it from the CLI's flags,
     grid_impl left at 'xla') and options (sampled_backward 2,
     backward_points 0.25), under heads_impl 'xla' and 'pallas', on the
     same scene: K1s, K5 and K2s on every step, and on the 'pallas' leg the
     four head kernels too. (b) one step per leg with the kernels against
     one with the plain versions, same params and draws: loss parts and
     every gradient but the table's; (c) 200 steps ('xla') and 20
     ('pallas') through train_iterations, every count set to 0 just before
     and read just after: each kernel once a step, every loss finite, the
     held-out rgb loss falling; (a) on one more step's recorded inputs:
     K1s (indices equal, weights bit-equal, the bf16 encode within half a
     bf16 unit of the fp32 one and within the plain bf16 chain's
     roundings), K5 (its counts exactly the floors of its own fp32 scan,
     read from its workspace; that scan and its coefs within their
     rounding bounds of float64; its coefs within those of the plain
     subsample's wherever the two give a point the same count, and every
     other difference within the two scans' measured deviations of a
     boundary), K2s against the plain scatter fed
     the same (sel, coef), K2s exact against the plain exact gradient, and
     64 draws of K5 + K2s whose mean is the exact gradient within 4
     standard errors; their times, bounds, launch shapes, the split of
     their device time (K5 by kernel, K2s's memset beside its kernel),
     K1s in both forms (training: bf16 out, atoms written; eval: fp32
     out) by events and by device time, each beside its DRAM bound and
     the L2 gather floor (the distinct rows each of its warps needs,
     read by hashgrid_cuda.gather_rows),
     and the bf16 -> fp32 cast before K3f; (d) ms per step in turns (plain, kernels,
     kernels, plain), peak memory and one profiled step per leg; (e) the
     flagship checkpoint served through InferenceModel.from_checkpoint,
     through K1s's eval form, equal to the trainer's own render;
 10. the train CLI, autolabel_tpu_torch.train.main in-process, on a sphere
     scene written by utils.fixtures (16 frames of 320 x 240) and read
     through SceneDataset. Run A, README's command (--proposal, every other
     flag at its default: 4,096 rays x 128 samples a step, N = 524,288)
     for 300 iterations with --eval at factor 1, every count set to 0
     just before and read just after: K1s (training form), K5 and K2s once
     a step and K1s's eval form once an eval chunk, none of the heads'
     kernels; the model-hash directory with params.pkl, metrics.jsonl and
     the checkpoint; the eval MSE at least 4-fold below a 1-iteration run
     of the same command; the checkpoint served through
     InferenceModel.from_checkpoint, a finite frame; K1s (both forms), K5
     and K2s held on the last step's recorded inputs as in phase 9 (a),
     K1s timed there in both forms beside its bounds and L2 gather
     floor.
     On Run A's trainer: the loader's ms per batch on the host, ms per
     step through the loader and on a pre-made batch on the device, the
     device's busy time over 5 profiled steps and its share of the same
     steps' wall clock. Run B (--heads-impl pallas --occupancy-grid
     --occupancy-near-far --tensorboard, 100 iterations at factor 2): the
     seven kernels once a step (K1s also once per chunk of the occupancy
     update), one update with its ms and peak memory, the events read
     back, the loss finite; K3b held on the last step's recorded inputs
     as in phase 8; then, on a grid updated afresh from the trained field
     and thresholded to mask at least half the cells, shrink_near_far
     narrowing rays and equal to its CPU run, and a test frame rendered
     with the grid through the kernels against the plain versions. Both
     runs' ms per step over the epoch's wall clock.
 11. the stochastic-corner and residual encodes (K6, K7) through the train
     CLI on phase 10's scene. Run C, README's command with
     --sampled-backward 0 (the TPU grid's simplex encode of 2 draws), 200
     iterations, and Run D, --grid-preset reference
     --stochastic-exact-levels 4 (16 x 2^19 x 2, trilinear, narrow rows),
     100 iterations, each with --eval at factor 1 and every count set to 0
     just before and read just after: K6 and K7 once a step, K1s (Run C)
     or K1 (Run D) only for the eval chunks, no other kernel; the eval MSE
     at least 4-fold below a 1-iteration run of the same command; ms per
     step over the epoch's wall clock; the device's busy time by kernel
     over 5 more steps through the CLI's loader and its share of their
     wall clock. Run E, --grid-preset reference --stochastic-corners 0
     (the reference preset's exact estimator), 50 iterations without
     eval, every count set to 0 just before and read just after: K1 and
     K2 (narrow rows) once a step, no other kernel; the losses finite and
     falling; ms per step, the busy share and K2's share of 5 traced
     steps; K2 held and timed on a step's recorded (g, x). Then 5 steps
     of Run C's command at --stochastic-corners
     33 (more draws a level than a warp has lanes): K6 and K7 once a step,
     no other kernel, the losses of one more step finite. (a) On each
     run's last recorded (table, x), at N = 131,072 and 524,288, K6 and K7
     in every mode of the CPU tests (TPU grid: trilinear at 1, 2, 3 draws,
     simplex at 1, 2, residual with both interps; reference: trilinear at
     1, 2, 3; each at three exact_levels), and at N = 131,072 in the run's
     own mode at 33 and 64 draws: K6's rows equal to the plain version's,
     flips counted and allowed only within 1 ulp of a boundary, its encode
     bit-equal; K7 within its term-count tolerance
     (hashgrid_cuda.check_stochastic); the mean of 64 draws of K6 and of
     K7 within 4 standard errors of the exact encode and gradient; each
     run's own mode timed by events and device time, beside its bound, its
     plain version and (K7) one index_add_ of the pre-weighted drawn rows,
     after a probe of the profiler's trace (K6's calls traced bare and
     opened by the marker launches every trace here opens with); K6's and
     K7's launch shapes.
 12. the render CLI, autolabel_tpu_torch.render.__main__.frames (the
     tiles main writes; the card's machine has no cv2 for the mp4), on
     phase 10's scene, every 8th test frame (2 frames a path) at the
     CLI's default 480 x 360: the dense default (512 samples a ray, 11
     chunks of 16,384 rays a frame: K1s eval and K3f once a chunk) and
     --proposal (K4f too) on Run B's workspace, Run D's at --num-steps 32
     (K1, narrow rows) and --baked at its defaults on Run B's (the bake's
     192^3 density queries through K1s, then K8's 4 launches a frame and
     no field kernel). Each path runs in turns with the plain versions
     (plain, kernels, kernels, plain), every count set to 0 just before
     and read just after each run (the plain runs must launch no kernel),
     with the second frame's ms of each run, and the dense run's peak
     memory; the kernels' outputs against
     the plain run's by phase 6's limits, classes equal but at near ties
     of the logits, the baked tiles' depth and semantic quadrants equal
     (the plain versions render the dense path at 2,048 rays a chunk:
     their gathers at 16,384 would not fit). K8 held alone against
     splat_render_plain by splat_cuda.check_splat's rules (pixels flip
     only at a .5 boundary, z, depth, classes and splat_hit equal, tied
     colours within (count - 1) ulp) on the baked scene and on its splats
     without SH, at 480 x 360 and 1280 x 720 from two test cameras, its
     boundary and tie counts printed; K8 timed by events and device time
     (split into the tiled fill and the scatter stage) and its wrapper's
     host time, beside its byte bound counted once (splat_cuda.bound_bytes:
     the valid flags, the valid splats' points, the winners' colour, SH
     and class read, 21 bytes a pixel written; the earlier count, which
     also charged the passes' state, beside it), the plain version and
     the three scatter_reduce_ calls of its scatter stage (the fill passes
     have no one-call counterpart); so again on two full clouds of 2^19
     valid splats at 480 x 360, one with tied winners, each also held by
     check_splat's rules.
 13. the interactive preview, the port's counterpart of
     benchmarks/preview_fps.py at its defaults (the configuration the GUI
     backend serves): the flagship field (hg+freq, TPU_GRID, hidden 128,
     colour 128, semantic 64, 6 classes, bound 2, proposal) with seeded
     weights, baked at 128^3 into 2^18 splats (alpha threshold 0, so the
     budget is full; degree-1 SH); 30 orbit poses (radius 2.5, height 1,
     looking at the origin) at 1280 x 720, focal 0.9 w, 8 fill passes.
     BakedRenderer's ms a frame over the 30 poses fenced by one fetch,
     every count set to 0 just before and read just after (K8 4 times a
     frame, nothing else); one frame's device time by kernel and busy
     share; GovernedPreviewRenderer at 30 fps over 90 frames after its
     warm-up, its fps and level; IncrementalBaker (128^3, 2^18 splats, 16
     blocks): one block's refresh after the cold start; K8 held by
     check_splat's rules from 2 poses and timed as in phase 12 at 1280 x
     720.
 14. evaluation, on the sphere scene written again by utils.fixtures at
     1280 x 960 (16 frames; the CLIs evaluate at factor 4, 320 x 240) with
     labelme masks, gt semantic maps and a mesh of 262,144 surface points,
     phase 10's geometry and bbox. (b) autolabel_tpu_torch.evaluate.main on
     Run B's workspace (K1s eval form and K3f once a chunk of 8,182 rays)
     in turns with the plain versions (plain, kernels, kernels, plain),
     every count set to 0 just before each run and read just after (the
     plain runs launch nothing), the classes of each evaluated frame equal
     to the plain run's but at near ties, the per-class IoU, mIoU and ms
     per evaluated frame. (c) language.evaluate.main with --allow-fallback
     on a workspace of seeded full-width weights (CLI defaults with
     --features lseg --feature-dim 512, the 606-class head, 'xla' heads)
     and a two-row label map, in 2D (K1s once a chunk) and with --pc (K1s
     10 times a 50,000-point chunk, 60 in all); then the 3D query alone
     (jittered_semantic_features over the 262,144 points, 10 queries a
     point) in turns with the plain versions on the same seeds, its
     features held by phase 6's limits and its labels equal but at near
     ties of the similarities; ms per chunk, points/s, one chunk's busy
     share and the peak memory. (d) seeded params of the reference's
     hg+freq model (16 x 2 x 2^19 on the tcnn lattice) written by
     torch_export.export_torch_checkpoint and loaded by
     InferenceModel.from_checkpoint (geo_relu, the tcnn variant, the
     params back bit-equal but the colour net's 16 SH-folded rows); K1 on
     that lattice held against its plain version at N = 524,288 and timed
     beside its bound; two 480 x 360 frames from phase 5's cameras (K1
     once a chunk, no other kernel) held against the plain render;
 15. the interactive labelling backend, on the room fixture written at
     1280 x 960 (16 frames; the backend reads it at factor 4, 320 x 240).
     (a) gui.BackendClient spawns the backend child at the GUI's defaults
     (its entry wraps gui.run_backend to stamp each step, each request's
     parts and one traced stretch of 5 steps, and to report its launch
     counts when it stops): the first preview after the spawn, ms a loop
     iteration, the steps pending on the card after each step (the
     bounded window), the busy share, 10 previews' round trips with their
     parts (the wait for the loop, the queued steps, the render, the
     fetch, the send, the Pipe), a repainted label PNG taken up, best.pth
     written; then in process best.pth resumed, its preview held against
     the plain versions and served through InferenceModel. (b)
     --baked-preview in process: the first request's bake, 10 round trips
     between steps, a slab refresh. (c) --heads-impl pallas --proposal
     --occupancy-grid in process: 10 steps and 2 previews (K3f, K3b, K4f,
     K4b). (d) simulate_user.main on the room at 160 x 120 with dense gt
     maps, its flags cut (USER_SIM_CUT): ms a round, the mIoU curve. (e)
     DynamicDataset at scripts/ros/node.py's training configuration,
     frames of 256 x 192 with RandomFeatureExtractor's 512-d features fed
     from a thread past the capacity of 325 while 3 bursts of 100 steps
     train: ms a step, the share spent waiting for a batch.
 16. camera registration and joint pose refinement. (a) K2x, the encode's
     gradient for the points, against its plain version at N = 131,072
     (points on 0, 1, cell faces and tied fractions): TPU_GRID simplex
     (K1s's atoms as its rows) and trilinear, the tcnn lattice's narrow
     rows (16 x 2 x 2^19), a stochastic leg (2 draws, the finest level
     exact; K6's rows) and a residual leg, each within
     encoders.point_grad_tolerance and bit-equal across two calls, timed
     by events and by the profiler's device time (on wide rows its level
     kernel and level sum together) beside its byte bound (g on the
     levels it reads, the rows, each distinct table row once, x and dx)
     and the plain version, with its launch shapes; the same on the
     inputs the register CLI's first iteration hands K2x in (c). (b) One
     registration step (2,048 rays of a sphere frame, 64 main and 32
     proposal samples, a non-zero delta) on phase 5's full-width model
     with the kernels against the plain versions (K4f kept in both, so
     both place the same samples): the loss within 2e-2, the gradient for
     (rot, t) within 5e-2 of its norm and no further from the fp32 plain
     versions' than the bf16 plain versions' is (room 1.5); K1, K2x, K3f,
     K3b and K4f once, no K2 and no K4b (the proposal places samples
     through a stop-gradient). (c) The register CLI at its defaults
     (2,048 rays, 400 iterations, lr 3e-3, 64 / 32 samples) on a room of
     16 frames at 160 x 120 trained through the train CLI (--proposal
     --heads-impl pallas, TPU_GRID simplex, hidden 128) for
     POSE_TRAIN_ITERS iterations, a frame perturbed by 5 degrees and
     7 cm: both errors halved; ms an iteration (p50), the CLI's seconds,
     the busy share of 5 traced iterations, each kernel's launches (K1s,
     K2x, K3f, K3b and K4f once an iteration, no table scatter, no K4b).
     (d) The train CLI with --pose-refine-experimental for 200 steps on
     the same room: every level window entered, frame 0's pose kept to
     1e-6, the other deltas moved and finite, poses_refined.npz written.
 17. the teacher towers (library calls in full fp32: cuBLAS, cuDNN,
     scaled_dot_product_attention; no hand kernel). (a) python -m
     autolabel_tpu_torch.train_demo_teacher at its defaults (1,500
     iterations, crop 96, batch 8, frames stride 4) on a room of
     make_room_scene's defaults (96 frames of 160 x 120), in process:
     ms a step by events around every step (median, quartiles), the
     CLI's seconds, its peak memory, the final loss, the busy share of 5
     traced steps, and the held-out phrasings' pixel accuracy on frame 0
     (tests/test_demo_clip.py's five, above 0.8). (b) Every tower at full
     width with seeded weights, a batch of 2 frames of a 1,280 x 960 room
     at compute_feature_maps' sizes: DINO ViT-S/8 and FCN-ResNet50 at
     720 x 960, LSeg ViT-L/16 + DPT at 242 x 322 (run at half size), the
     trained DemoCLIP pixel tower at 242 x 322, the CLIP ViT-B text tower
     on 606 prompts x 77 tokens: ms a batch by events, the same forward
     with TF32 allowed (the cost of full fp32), one traced batch's busy
     share and top kernels (the attention backend among them), peak
     memory, FLOPs and the share of the fp32 peak, and the fp32 output
     against the same module in float64 on the card (relative norm at
     most 1e-4, the largest element within 1e-3 of the largest |want|).
     (c) The language CLI with --feature-checkpoint (the trained teacher,
     no --allow-fallback) on a --features demo --feature-dim 512
     workspace of seeded weights on phase 14's scene: scores in [0, 1],
     the label map's embeddings within 1e-5 of DemoCLIPFE's on the CPU,
     its launches. (d) compute_feature_maps' extraction and compression
     (--autoencode, 64 codes) on the card for demo and dino on the room:
     seconds a frame; the features.hdf write is not run (the line says
     so).
 18. mapping. (a) K9 (csrc/ba_normal.cu, bundle adjustment's two LM
     products) against the plain version (torch.func's vjp and jvp of
     mapping.ba._residual) at a final bundle adjustment's size: 300
     cameras on a seeded arc (one at theta = 0), 40,000 points each seen
     by 9 frames (N = 360,000), 0.5 px noise, 2% outliers at 20-50 px,
     Huber weights: r, the cost, g and the damped product on a seeded v at
     refine_focal off and on, within 1e-5 by relative norm, and against
     the plain version in float64 (K9's error at most 2x the plain fp32
     version's); the same on observations at the depth clamp and at a
     tie. K9's CG solve (entry 3, one cooperative launch) against
     cg(frozen=True) over the matvec entry and over the plain products:
     bit-equal across two calls, its first product (and focal entry)
     within 1e-5 of the matvec entry, k equal, the delta within 1e-4 or,
     with refine_focal, no farther from float64 than 2x the loop. (b)
     Each entry by events and device time, the plain product, the
     yardstick (two torch.sparse.mm of a CSR J built once), the byte
     bound; the solve in turns with the torch loop around the matvec
     entry, and its bound. (c) bundle_adjust (30 LM steps, 50 CG
     iterations) in turns loop, kernels, kernels, loop, then over 10 LM
     steps plain, kernels, kernels, plain: seconds, LM and CG iterations,
     K9 launches an LM step (one solve and three residual calls), an LM
     step's wall and busy share in turns with the loop, the 10-step
     solve's final rms within 1e-3 px of the plain solve's, rotations and
     centres after Sim(3) against the truth, one
     traced LM step's busy share, and a refine_focal solve from a focal
     10% wrong. (d) On the fixture room (make_room_scene's 96 frames),
     tracks projected from its surfaces with 0.3 px noise and perturbed
     poses: IncrementalSfM's _run_ba, _prune_outliers,
     _drop_pose_outliers, _drop_tear_frames and write_colmap_model, then
     the mapping CLI's ScaleEstimation and PoseSaver: pose/*.txt and
     bbox.txt against the truth (Sim(3) scale within 2%, mean centre error
     below 2 cm); and, in a child where `import cv2` fails, the cv2 front
     end raising naming cv2.
 19. data and grid tensor parallelism (autolabel_tpu_torch/parallel),
     bench.py's flagship step (phase 9's model and options, 'pallas'
     heads) for 5 steps from one seed's params, batches and draws. (a)
     Without a mesh twice, then on a world of one under NCCL (the
     collectives called): each kernel once a step; each of the 5 steps
     taken again from no mesh's params before it: its loss parts and
     every gradient but the table's bit-equal to no mesh's, the table's
     within K2s's sum-order tolerance of it (its float atomics take
     their own order, as no mesh run again does). (b) Two
     spawned ranks sharing the card, under gloo (NCCL refuses them, which
     a probe of two NCCL ranks on the card shows): DP 2, then TP 2 (the
     table's feature axis over 'model'), each kernel once a step on each
     rank; step 1's loss parts within rtol 1e-5 of (a)'s, its other
     gradients and the encode's cotangent within 1e-5 by relative norm
     (TP: bit-equal); off the rows of the points the subsample counted
     otherwise (each of them within a scan's bound of a boundary: TP sums
     two slices' squares), the table gradient gathered whole within
     K2s's sum-order tolerance of (a)'s, widened by K5's coefficient
     bound and the cotangent's difference, no element of the other sign,
     and the table after step 1 within 1e-6 of (a)'s. (c) On each rank, K1s and K5 + K2s at the
     shard width (F = 64 under TP) on step 1's own inputs through
     _check_k1s and _check_select_scatter, K5's squared norms bit-equal
     to select_chain_norms, the rank's draws bit-equal to the full-range
     scan's in its rows, and under TP the global selection against
     itself, float64 and the plain version (check_selection from the
     gathered norms), the same draws on both model ranks. (d) The train
     CLI with --mesh-devices 2 --mesh-model 2 (batch 1,024, 32 samples)
     for 60 iterations, then resumed for 40: the checkpoint's table, EMA
     and Adam moments whole at step 100, rank 0's launches one a step.
     (e) Joint pose refinement on the flagship model (pose_refine from the
     8 cameras' poses, iters 20: the level windows open one by one and
     the deltas move from step 3; its encode exact: K1s, K2s as the exact
     scatter and K2x once a step, K5 never), 5 steps without a mesh, on
     the world of one (step 1's loss parts and pose gradient bit-equal to
     no mesh's) and on (b)'s ranks under TP 2: step 1's loss parts within
     rtol 1e-5 and its pose gradient within 1e-5 by relative norm of no
     mesh's, the step-1 pose gradient and the deltas after 5 steps
     bit-equal on both ranks; on each rank K2x held against its plain
     version and timed on its first call's inputs, the rank's F = 64
     slice (the ranks timing it in turns); the train CLI with
     --pose-refine-experimental and (d)'s flags for 10 iterations:
     poses_refined.npz from rank 0, frame 0 kept, K1s, K2s and K2x once
     a step on rank 0 (the CLI's heads are 'xla').
     (f) InteractiveTrainer on the world of one and on (b)'s ranks under
     DP 2, 3 take_steps against SimpleTrainer's on the same mesh and
     inputs: step 1 bit-equal; each of the 3 taken again from
     SimpleTrainer's params before it, its loss parts and every gradient
     but the table's bit-equal to SimpleTrainer's (run on, the two part
     by K2s's atomic order: steps 2-3 are printed beside no mesh run
     again's). Each run's step walls and its collectives' share of them.
 20. the last host-side modules, each through its entry point with
     only its transport stood in for. (a) The online ROS node
     (ros/node.py) at its own configuration (--features lseg
     --allow-fallback: the repo has no teacher weights, so stand-in
     features; the field on the card), under a ROS stand-in this script carries
     (subscribers, publishers and services as callables, cv_bridge
     passing arrays through): one camera_info, then phase 15 (e)'s 36
     room frames of 256 x 192 as rgb, depth and keyframe messages, 4 of
     them with their depth 50 ms late; odometry, one prompt message, both
     services (a triple sent while paused); until 3 bursts of 100 steps
     have trained, then stop(). Checks: exactly the in-sync triples taken
     in, with their poses; the services and camera_info's
     unsubscription; both threads ended; every preview's image and depth
     (192, 256, 3) uint8 from finite maps, the features a colouring of
     the 5 prompts; finite burst losses; the field on the card; K6 and
     K7 launched at least once a step (counts set to 0 just before the
     first message, read after stop()). Prints ms a burst step, ms a
     preview and the busy share of one traced burst. (b) The labelling
     window (ui/window.py, PyQt6 stood in for by tests/qt_stub.py) over
     phase 15's room (made anew when absent) at the GUI's defaults, with
     a live backend child on the card: strokes of classes 1 and 2 on
     frame 0, each stroke's end (its PNG, labels_changed) timed to the
     next preview of the frame; the PNG equal to the AnnotationStore's
     bitmap, every preview's shapes, dtypes and classes, and closeEvent
     stopping the child (exit code 0) within gui.STOP_TIMEOUT_S.
The last lines are the kernel table as JSON and
{"ok": true, "device": {...}}. Exits non-zero without them when there is
no CUDA device, when run outside the repository, or when any check fails.
"""
import argparse
import contextlib
import functools
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, 'chiprun_out')
WORK_DIR = os.path.join(HERE, 'build', 'chip_smoke')

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s in fp32 outside the tensor cores and in bf16 on them.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

FRAME_W, FRAME_H = 480, 360
NUM_STEPS, PROPOSAL_STEPS, MAX_RAY_BATCH = 32, 64, 16384
N_FRAMES = 2
TIMED_ROUNDS = 4  # each round renders plain, kernels, kernels, plain

# The training slice: bench.py's batch and sample counts.
TRAIN_BATCH, TRAIN_STEPS = 4096, 200
TRAIN_CHUNK = 20  # steps per train_iterations call (one EMA tick each)
TRAIN_ROUNDS, STEPS_PER_TURN = 4, 5
SPHERE_RADIUS = 0.8
# The flagship slice: steps of the main path per head implementation, and
# draws of the sampled backward averaged against the exact gradient.
FLAGSHIP_STEPS = {'xla': 200, 'pallas': 20}
UNBIASED_DRAWS = 64


def _fail_early(msg):
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(2)


def _gpu_line(index=0):
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[index].strip()


def _cuda_ms(fn, reps):
    """Mean device ms of fn over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _quartiles(values):
    import numpy as np
    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return {'median': float(med), 'q1': float(q1), 'q3': float(q3),
            'n': len(values)}


# The marker launches (one-thread spin kernels, left out of every device
# time) that open every trace. A trace here loses the first device
# activities after it opens (the probe below records which): all 5
# launches of K6 in a bare 5-call trace, up to 6 of 8 markers where
# markers open it, never a launch after the first one it records; 50 ms
# of host idle before and after the traced work did not stop it. So the
# markers, not the measured launches, are what it loses.
TRACE_MARKERS = 32
MARKER = 'spin_kernel'


def _traced(fn, markers=TRACE_MARKERS):
    """torch.profiler's trace of one call of fn, opened by `markers`
    marker launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(markers):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return prof


def _device_profile(fn):
    """Device time of one call of fn by kernel, from torch.profiler:
    (rows of (name, ms, launches) by time, total device ms), or (None,
    None) when the trace holds no device time."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in _traced(fn).key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and MARKER not in e.key]
    if not rows:
        return None, None
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def _trace_probe(gpu, tag, fn, reps=5):
    """Which launches a short trace loses: reps calls of fn traced bare,
    opened by 8 markers and by TRACE_MARKERS; each trace's device
    activities in time order, m a marker and k a launch of fn."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    out = {}
    for markers in (0, 8, TRACE_MARKERS):
        events = _traced(lambda: [fn() for _ in range(reps)],
                         markers).events()
        device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        seq = ''.join('m' if MARKER in e.name else 'k' for e in device)
        out[markers] = seq
        print(f'profiler window probe [{gpu}] {tag}, {reps} calls, {markers} '
              f'markers: recorded in time order "{seq}" ({seq.count("k")} '
              'launches of fn)')
    return out


def _kernel_ms(fn, reps=5):
    """Device ms per call of fn by kernel name, from torch.profiler over
    reps calls (after one warm-up), or None when the trace holds no device
    time."""
    import torch
    fn()
    torch.cuda.synchronize()
    rows, _ = _device_profile(lambda: [fn() for _ in range(reps)])
    if rows is None:
        return None
    # A trace that holds fewer launches than were made (seen on the H100
    # before traces opened with markers: 2 to 4 of 5 calls' kernels, or
    # none) is reported, and a kernel's ms a call is then its ms per
    # recorded launch times its launches a call, the count rounded up.
    out = {}
    for name, ms, count in rows:
        per_call = -(-count // reps)
        if count != per_call * reps:
            print(f'profiler: {count} launches of {name[:60]} recorded over '
                  f'{reps} calls; counted as {per_call} a call')
        out[name] = ms / count * per_call
    return out


def _print_shapes(gpu, shapes):
    for kernel, sh in shapes.items():
        print(f'launch shape [{gpu}] {kernel}: ' + ', '.join(
            f'{k} {v}' for k, v in sh.items()))


# K1's narrow rows at the edges of its layout: point counts that end a
# warp or a block (128 threads) early, feature widths whose point rows are
# or are not whole 16-byte pieces (F = 3: 3 threads a point, not dividing
# a warp), and level counts of 1, 5 and 16.
NARROW_EDGES = dict(n=(0, 1, 31, 33, 129, 1000), features=(1, 2, 3, 8),
                    levels=(1, 5, 16))


def _hold_narrow_edges(checks, hashgrid_cuda, config_class, dev, g):
    """K1 on narrow rows bit-equal to its plain version at every
    NARROW_EDGES shape, on the tcnn lattice, points up to 0.05 outside
    [0, 1]; one check for them all, naming the shapes that differ."""
    import itertools
    import torch
    differ = []
    shapes = list(itertools.product(*NARROW_EDGES.values()))
    for n, f, levels in shapes:
        config = config_class(n_levels=levels, n_features=f,
                              log2_hashmap_size=12, base_resolution=8,
                              per_level_scale=1.6, variant='tcnn')
        table = (torch.rand((levels, 4096, f), generator=g) * 2 - 1).to(dev)
        x = (torch.rand((n, 3), generator=g) * 1.1 - 0.05).to(dev)
        if not torch.equal(hashgrid_cuda.hashgrid_encode(table, x, config),
                           hashgrid_cuda.hashgrid_encode_plain(table, x,
                                                               config)):
            differ.append((n, f, levels))
    checks.true(f'K1 narrow rows bit-equal at {len(shapes)} edge shapes '
                f'(n, F, L in {tuple(NARROW_EDGES.values())})', not differ,
                f'differ at {differ}')


def _bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class Checks:
    """Collects every comparison, so one run reports them all."""

    def __init__(self):
        self.failures = []

    def close(self, name, got, want, atol, rtol):
        import torch
        got, want = got.float(), want.float()
        err = (got - want).abs()
        allowed = atol + rtol * want.abs()
        max_abs = float(err.max()) if err.numel() else 0.0
        # The worst element's share of its allowance (1 = at the limit).
        used = float((err / allowed).max()) if err.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and bool((err <= allowed).all())
        print(f'check {name}: max_abs_err={max_abs:.3e} '
              f'max|want|={float(want.abs().max()):.3e} '
              f'(atol={atol}, rtol={rtol}, worst uses {used:.3f} of it) '
              f'{"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return max_abs

    def rel_norm(self, name, got, want, tol):
        """|got - want| / |want| in the Frobenius norm, at most tol."""
        import torch
        got, want = got.float(), want.float()
        err = float((got - want).norm() / want.norm().clamp(min=1e-30))
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f'check {name}: rel_err={err:.3e} |want|={float(want.norm()):.3e}'
              f' (tol {tol}) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return err

    def flips(self, name, got, want, atol, max_share):
        """At most max_share of the elements differ by more than atol
        (the rest may not: see the callers for why some can)."""
        import torch
        err = (got.float() - want.float()).abs()
        share = float((err > atol).float().mean())
        ok = bool(torch.isfinite(got).all()) and share <= max_share
        print(f'check {name}: {share:.3e} of the elements beyond '
              f'{atol:.3e} (at most {max_share}); max_abs_err '
              f'{float(err.max()):.3e} {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return float(err.max())

    def no_worse(self, name, got, ref, want, atol, room):
        """got is no further from want than ref is, up to the factor room:
        in the Frobenius norm and in the share of elements beyond atol."""
        import torch
        want = want.float()

        def errors(x):
            d = x.float() - want
            return (float(d.norm() / want.norm().clamp(min=1e-30)),
                    float((d.abs() > atol).float().mean()))

        (norm_got, share_got), (norm_ref, share_ref) = errors(got), errors(ref)
        ok = bool(torch.isfinite(got).all()) \
            and norm_got <= room * norm_ref and share_got <= room * share_ref
        print(f'check {name}: rel_err {norm_got:.4e} against {norm_ref:.4e}, '
              f'share beyond {atol:.3e} {share_got:.4e} against '
              f'{share_ref:.4e} (room {room}) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return dict(rel_err=norm_got, ref_rel_err=norm_ref, share=share_got,
                    ref_share=share_ref)

    def within(self, name, got, want, tol):
        """|got - want| at most tol, element by element."""
        import torch
        err = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
        used = float((err / tol.clamp(min=1e-38)).max()) if err.numel() \
            else 0.0
        print(f'check {name}: max_abs_err={float(err.max()):.3e} '
              f'max|want|={float(want.abs().max()):.3e} (worst uses '
              f'{used:.3f} of its tolerance) {"ok" if ok else "FAILED"}')
        if not ok:
            self.failures.append(name)
        return float(err.max())

    def true(self, name, cond, detail=''):
        print(f'check {name}: {"ok" if cond else "FAILED"} {detail}')
        if not cond:
            self.failures.append(name)


def _look_at(pos, target=(0.0, 0.0, 0.0)):
    """OpenCV camera-to-world rotation (x right, y down, z forward)."""
    import numpy as np
    pos = np.asarray(pos, np.float64)
    forward = np.asarray(target) - pos
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=1)


def _frame(rays, pos):
    import numpy as np
    R = _look_at(pos)
    dirs, norms = rays.compute_directions(
        R, np.arange(FRAME_W * FRAME_H), FRAME_W, 400.0, 400.0,
        FRAME_W / 2, FRAME_H / 2)
    return {
        'rays_o': np.broadcast_to(np.asarray(pos, np.float32),
                                  (FRAME_H, FRAME_W, 3)).copy(),
        'rays_d': dirs.reshape(FRAME_H, FRAME_W, 3),
        'direction_norms': norms.reshape(FRAME_H, FRAME_W, 1),
    }


def _scene_frame(rays, pos):
    """A frame of the procedural training scene: _frame's rays and the
    ground truth of a sphere of radius SPHERE_RADIUS at the origin, its
    colour and class (the dominant axis of the normal and its sign: 6
    classes) taken from the normal; the background is white (the
    renderer's bg_color), unlabelled (-1) and has no depth."""
    import numpy as np
    frame = _frame(rays, pos)
    o = frame['rays_o'].reshape(-1, 3).astype(np.float64)
    d = frame['rays_d'].reshape(-1, 3).astype(np.float64)
    norms = frame['direction_norms'].reshape(-1)
    b = (o * d).sum(-1)
    disc = b * b - ((o * o).sum(-1) - SPHERE_RADIUS ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    normal = (o + t[:, None] * d) / SPHERE_RADIUS
    axis = np.abs(normal).argmax(-1)
    cls = 2 * axis + (normal[np.arange(len(axis)), axis] < 0)
    frame['pixels'] = np.where(hit[:, None], 0.2 + 0.3 * (normal + 1.0),
                               1.0).astype(np.float32).reshape(
                                   FRAME_H, FRAME_W, 3)
    frame['depth'] = np.where(hit, t / norms, 0.0).astype(
        np.float32).reshape(FRAME_H, FRAME_W)
    frame['semantic'] = np.where(hit, cls, -1).reshape(FRAME_H, FRAME_W)
    return frame


class _RayBatches:
    """Endless batches of rays drawn uniformly, on the card, from a pool
    of frames held on the card."""

    def __init__(self, frames, batch, device, seed, extra_keys=()):
        import numpy as np
        import torch
        keys = ('rays_o', 'rays_d', 'direction_norms', 'pixels', 'depth',
                'semantic') + tuple(extra_keys)
        self.pool = {k: torch.as_tensor(np.concatenate(
            [np.asarray(f[k]).reshape(FRAME_W * FRAME_H, -1)
             for f in frames])).squeeze(-1).to(device) for k in keys}
        self.n = self.pool['rays_o'].shape[0]
        self.batch = batch
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def __iter__(self):
        return self

    def __next__(self):
        import torch
        idx = torch.randint(0, self.n, (self.batch,),
                            generator=self.generator,
                            device=self.generator.device)
        return {k: v[idx] for k, v in self.pool.items()}


def _psnr(mse):
    import math
    return -10.0 * math.log10(max(mse, 1e-12))


@contextlib.contextmanager
def _plain_kernels(hashgrid_cuda, heads_cuda):
    """Swap the three kernel wrappers for their plain versions (bf16
    operands for the heads, as the kernels), on the card."""
    import torch
    saved = (hashgrid_cuda.hashgrid_encode, heads_cuda.fused_heads,
             heads_cuda.fused_mlp3)
    hashgrid_cuda.hashgrid_encode = hashgrid_cuda.hashgrid_encode_plain
    heads_cuda.fused_heads = lambda p, A, B: heads_cuda.fused_heads_plain(
        p, A, B, torch.bfloat16)
    heads_cuda.fused_mlp3 = lambda p, X: heads_cuda.fused_mlp3_plain(
        p, X, torch.bfloat16)
    try:
        yield
    finally:
        (hashgrid_cuda.hashgrid_encode, heads_cuda.fused_heads,
         heads_cuda.fused_mlp3) = saved


def _model_config(interp='trilinear', heads_impl='pallas'):
    """The full-width model the slices drive, as model_utils builds it from
    the CLI's flags (grid_impl left at 'xla': on the card every encode runs
    a kernel): TPU_GRID with `interp` interpolation, the 36-64-64-1
    proposal net, hidden 128, geo 15, 64 semantic features, 6 classes,
    bound 2. With simplex it is bench.py's model (bench.py:90-99)."""
    import numpy as np
    from autolabel_tpu_torch import model_utils
    flags = model_utils.model_flag_parser().parse_args(
        ['--grid-preset', 'tpu', '--proposal', '--heads-impl', heads_impl,
         '--grid-interp', interp, '--feature-dim', '64'])
    lo, hi = np.full(3, -1.0), np.full(3, 1.0)  # bound = 2.0
    return model_utils.model_config(lo, hi, 6, flags)


def _train_slice(dev, seed, config=None, options=None, name='train'):
    """A training slice: (trainer, loader of ray batches, held-out frame).
    SimpleTrainer on a fresh full-width field (default: the exact
    trilinear model of phases 5-8), batch TRAIN_BATCH, proposal 64 -> 32,
    perturbed (default: exact gathers), on rays of the procedural sphere
    scene seen from 8 cameras."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.render.renderer import RenderOptions
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    positions = [(3.2 * np.cos(a), 3.2 * np.sin(a), 0.9 * (-1) ** k)
                 for k, a in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1])]
    loader = _RayBatches([_scene_frame(rays, pos) for pos in positions],
                         TRAIN_BATCH, dev, seed + 4)
    held_out = _scene_frame(rays, (2.2, 2.6, -0.4))
    if options is None:
        options = RenderOptions(perturb=True, stochastic_corners=0,
                                sampled_backward=0, num_steps=NUM_STEPS,
                                proposal_steps=PROPOSAL_STEPS)
    field = Field(config or _model_config(), device=dev,
                  generator=torch.Generator().manual_seed(seed + 2))
    trainer = SimpleTrainer('chip_smoke', field, lr=5e-3, iters=10000,
                            render_options=options,
                            workspace=os.path.join(WORK_DIR, name),
                            use_checkpoint=None,
                            max_ray_batch=MAX_RAY_BATCH, metrics=False,
                            seed=seed)
    return trainer, loader, held_out


def _flagship_options():
    """bench.py's render options for the flagship step (bench.py:119-124):
    simplex's sampled backward 2 on a quarter of the points."""
    from autolabel_tpu_torch.render.renderer import RenderOptions
    return RenderOptions(num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
                         perturb=True, stochastic_corners=0,
                         sampled_backward=2, backward_points=0.25)


def _record_flagship_inputs(trainer, loader, hashgrid_cuda):
    """What one flagship step hands K1s (table, x), K5 (g, u, k) and K2s
    (the atoms and rows): the step's main samples, ray by ray."""
    rec = {}
    atoms, select, scatter = (hashgrid_cuda._atoms_call,
                              hashgrid_cuda._select_call,
                              hashgrid_cuda._sampled_scatter_call)

    def rec_atoms(table, x, config, interp, out_dtype, with_atoms):
        rec.setdefault('atoms', (table.detach().clone(), x.clone()))
        return atoms(table, x, config, interp, out_dtype, with_atoms)

    def rec_select(g, u, k):
        rec.setdefault('select', (g.clone(), u.clone(), k))
        return select(g, u, k)

    def rec_scatter(g, idx, w, u, rows, config, sel, coef, count):
        rec.setdefault('scatter', (idx.clone(), w.clone(), rows))
        return scatter(g, idx, w, u, rows, config, sel, coef, count)

    (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
     hashgrid_cuda._sampled_scatter_call) = rec_atoms, rec_select, rec_scatter
    try:
        trainer.train_step(next(loader))
    finally:
        (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
         hashgrid_cuda._sampled_scatter_call) = atoms, select, scatter
    return rec


def _record_k2_inputs(trainer, loader):
    """The (g, x) that one training step's backward hands the table
    gradient kernel (K2): the step's main samples, ray by ray."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    recorded, launch = [], hashgrid_cuda._launch_backward

    def record(g, x, config):
        recorded.append((g.detach().clone(), x.detach().clone()))
        return launch(g, x, config)

    hashgrid_cuda._launch_backward = record
    try:
        trainer.train_step(next(loader))
    finally:
        hashgrid_cuda._launch_backward = launch
    return recorded[0]


def _check_k2(checks, name, hashgrid_cuda, g, x, config):
    """K2 against its plain version on (g, x): each element within
    hashgrid_cuda.backward_tolerance (the same fp32 products summed in
    another order: 2 k 2^-24 of the terms' magnitudes, k the terms of the
    element's row), and the hottest row's k. Returns the largest
    error."""
    got = hashgrid_cuda.hashgrid_encode_backward(g, x, config)
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    tol = hashgrid_cuda.backward_tolerance(g, x, config)
    err = checks.within(name, got, want, tol)
    # the hottest row's terms: the tolerance over 2^-23 times the
    # magnitude, where the magnitude is largest
    magnitude = hashgrid_cuda.hashgrid_encode_backward_plain(g.abs(), x,
                                                             config)
    hottest = float((tol / (2.0 ** -23 * magnitude).clamp(
        min=1e-38)).max())
    print(f'  {name}: the hottest row sums {hottest:.0f} terms')
    return err


def k2_yardstick(encoders, g, x, config):
    """K2's library yardstick: one index_add_ of the 8 L N corner rows,
    weighted as the plain version weighs them (made here, outside the
    timing), into the flattened (L T, F) table gradient; returns the
    call."""
    import torch
    cell, frac, stride, use_dense, size = encoders._grid_geometry(x, config)
    f = config.n_features
    rows, terms = [], []
    for l in range(config.n_levels):
        g_l = g[:, l * f:(l + 1) * f].float()
        for corner in encoders._CORNERS:
            rows.append(l * config.table_size + encoders._corner_index(
                cell[:, l], corner, stride[l], use_dense[l], size[l]))
            terms.append(g_l * encoders._corner_weight(frac[:, l],
                                                       corner)[:, None])
    rows, terms = torch.cat(rows), torch.cat(terms)
    flat = torch.empty((config.n_levels * config.table_size, f),
                       device=g.device)

    def library():
        flat.zero_()
        flat.index_add_(0, rows, terms)
        return flat

    return library


def _k2_narrow_measure(gpu, tag, hashgrid_cuda, g, x, config):
    """K2 on (g, x) by CUDA events (20 launches) and device ms a call
    (memset included), beside its plain version, the index_add_ yardstick,
    its bound (g and x read once, the (L, T, F) gradient written once; an
    fp32 mul and add a corner and element) and its request floor: the
    16-byte atomics warps of 32 points make at the least
    (gather_sectors(..., points=32, sector=16)), beside the 8 L N F scalar
    atomics of the first form."""
    import torch

    def kernel():
        return hashgrid_cuda.hashgrid_encode_backward(g, x, config)

    n, f, levels = x.shape[0], config.n_features, config.n_levels
    by_kernel = _kernel_ms(kernel)
    r = dict(ms=_cuda_ms(kernel, 20),
             device_ms=None if by_kernel is None else sum(by_kernel.values()),
             plain_ms=_cuda_ms(lambda: hashgrid_cuda
                               .hashgrid_encode_backward_plain(g, x, config),
                               3),
             bound=_bound(_nbytes(g, x) + levels * config.table_size * f * 4,
                          16 * n * config.out_dim, PEAK_FP32),
             requests=sum(hashgrid_cuda.gather_sectors(x, config, points=32,
                                                       sector=16)),
             scalar_atomics=8 * levels * n * f)
    library = k2_yardstick(hashgrid_cuda.encoders, g, x, config)
    r['library_ms'] = _cuda_ms(library, 5)
    by_kernel = _kernel_ms(library)
    r['library_device_ms'] = None if by_kernel is None \
        else sum(by_kernel.values())
    del library
    torch.cuda.empty_cache()
    print(f'kernel K2 narrow [{gpu}] {tag} N={n}: {r["ms"]:.4f} ms by events,'
          f' {r["device_ms"]} ms device, plain {r["plain_ms"]:.4f} ms, '
          f'library {r["library_ms"]:.4f} ms ({r["library_device_ms"]} ms '
          f'device; one index_add_ of the pre-weighted corner rows), bound '
          f'{r["bound"][0]:.4f} ms ({r["bound"][1]}); warps of 32 points '
          f'request {r["requests"]} 16-byte pieces at the least, against '
          f'{r["scalar_atomics"]} scalar atomics')
    return r


def _ray_points(n, g, samples=32):
    """n points as a render chunk orders them: n / samples rays, each from
    a point of the unit cube along a random direction, its samples
    consecutive and evenly spaced over a length of 0.5, clamped to the
    cube."""
    import torch
    rays = n // samples
    origin = torch.rand((rays, 1, 3), generator=g)
    direction = torch.nn.functional.normalize(
        torch.randn((rays, 1, 3), generator=g), dim=-1)
    t = torch.linspace(0.0, 0.5, samples)[None, :, None]
    return (origin + t * direction).clamp(0.0, 1.0).reshape(n, 3)


def _k2_narrow(checks, gpu, hashgrid_cuda, dev, gen, n=524288):
    """K2's narrow rows at the reference presets' N: held against the
    plain version on the three lattices ('native', 'tcnn', 'torch_ngp'),
    uniform and ray-ordered points; measured on the tcnn lattice."""
    import torch
    encoders = hashgrid_cuda.encoders
    lattices = {'native': encoders.HashGridConfig(),
                'tcnn': encoders.HashGridConfig(variant='tcnn'),
                'torch_ngp': encoders.HashGridConfig.from_desired_resolution(
                    2 ** 18, variant='torch_ngp')}
    xs = {'uniform': torch.rand((n, 3), generator=gen).to(dev),
          'ray-ordered': _ray_points(n, gen).to(dev)}
    g = torch.randn((n, lattices['tcnn'].out_dim), generator=gen).to(dev)
    held = {f'{lattice} {kind}': _check_k2(
        checks, f'K2 table gradient reference {lattice} N={n} {kind}',
        hashgrid_cuda, g, x, config)
        for lattice, config in lattices.items() for kind, x in xs.items()}
    timed = {kind: _k2_narrow_measure(gpu, f'tcnn {kind}', hashgrid_cuda, g,
                                      x, lattices['tcnn'])
             for kind, x in xs.items()}
    return dict(held=held, max_abs_err=max(held.values()), **timed)


def _check_k1s(checks, tag, table, x, idx, w, grid):
    """K1s on one step's recorded (table, x), the step's own atoms (idx, w)
    beside them. Eval form: equal to the plain exact encode (the same fp32
    products and sums in the same order). Training form: indices equal
    and weights bit-equal to the plain atoms and to the step's; the bf16
    encode that fp32 sum rounded once (equal to the plain exact encode
    rounded to bf16; half a bf16 unit: 2^-8 of the value), and within the
    plain bf16 chain's roundings ((4 A + 1) 2^-8 of the terms' magnitudes:
    the table entries, weights, products and partial sums each rounded to
    bf16 there, the kernel's sum once). Returns the largest error against
    the plain bf16 version and the training form's encode."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    n = x.shape[0]
    enc_e, _, _ = hashgrid_cuda.encode_atoms(table, x, grid, 'simplex',
                                             torch.float32, False)
    want_e, want_idx, want_w = hashgrid_cuda.encode_atoms_plain(
        table, x, grid, 'simplex', torch.float32)
    checks.true(f'K1s eval {tag} N={n}: equal to the plain exact encode',
                torch.equal(enc_e, want_e),
                f'max |diff| {float((enc_e - want_e).abs().max()):.3e}')
    del enc_e
    enc_t, idx_t, w_t = hashgrid_cuda.encode_atoms(
        table, x, grid, 'simplex', torch.bfloat16, True)
    checks.true(f'K1s atoms {tag} N={n}: indices equal, weights bit-equal '
                'to the plain atoms and to the step\'s',
                torch.equal(idx_t, want_idx) and torch.equal(w_t, want_w)
                and torch.equal(idx_t, idx) and torch.equal(w_t, w))
    del idx_t, w_t, want_idx, want_w
    checks.true(f'K1s training {tag} N={n}: the plain exact encode rounded '
                'to bf16 once', torch.equal(enc_t, want_e.to(torch.bfloat16)))
    checks.within(f'K1s training {tag} bf16 against fp32 N={n}', enc_t,
                  want_e, 2.0 ** -8 * want_e.abs() + 1e-30)
    del want_e
    want_t = hashgrid_cuda.encode_atoms_plain(table, x, grid, 'simplex',
                                              torch.bfloat16, False)[0]
    terms = hashgrid_cuda.encoders._gather_from_atoms(
        table.abs(), idx, w, grid, torch.float32)
    err = checks.within(f'K1s training {tag} against plain bf16 N={n}',
                        enc_t, want_t, 17 * 2.0 ** -8 * terms + 1e-30)
    return err, enc_t


def _k1s_measure(gpu, tag, table, x, idx, grid):
    """K1s's times, bounds and L2 gather floor on one step's recorded
    (table, x) and its atoms idx, in both forms: the training form (bf16
    out, atoms written) and the eval form (fp32 out, no atoms), each by
    CUDA events (20 launches) and by the profiler's device ms a call. The
    bounds count x, each table row the atoms name once (per level), the
    output and, in training, the atoms; a mul and an add per atom and
    element in fp32. The L2 gather floor is gather_rows timed on the
    distinct rows each of the kernel's warps needs (tile_rows at its
    32 / A points): the least time its gathers can take at the rate L2
    serves scattered rows."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    n, levels, a = x.shape[0], grid.n_levels, idx.shape[1]
    out = {}
    for form, dtype, atoms in (('training', torch.bfloat16, True),
                               ('eval', torch.float32, False)):
        def call(dtype=dtype, atoms=atoms):
            return hashgrid_cuda.encode_atoms(table, x, grid, 'simplex',
                                              dtype, atoms)
        by_kernel = _kernel_ms(call)
        out[form] = dict(
            ms=_cuda_ms(call, 20),
            device_ms=None if by_kernel is None else sum(by_kernel.values()))
    rows = sum(int(torch.unique(idx[l]).numel()) for l in range(levels))
    flops = 2 * a * n * grid.out_dim
    fixed = _nbytes(x) + rows * grid.n_features * 4
    out['training']['bound'] = _bound(
        fixed + n * grid.out_dim * 2 + 2 * levels * a * n * 4, flops,
        PEAK_FP32)
    out['eval']['bound'] = _bound(fixed + n * grid.out_dim * 4, flops,
                                  PEAK_FP32)
    # The L2 gather floor: the distinct rows of each warp's points.
    shape = hashgrid_cuda.atoms_launch_shape(grid, n)
    per_level, tile_list = hashgrid_cuda.tile_rows(idx, shape['points'],
                                                   grid.table_size)
    def floor_fn():
        hashgrid_cuda.gather_rows(table, tile_list)
    floor_ms = _cuda_ms(floor_fn, 20)
    by_kernel = _kernel_ms(floor_fn)
    floor_device = None if by_kernel is None else sum(by_kernel.values())
    tile_bytes = tile_list.numel() * grid.n_features * 4
    del tile_list
    print(f'K1s [{gpu}] {tag} N={n}: the atoms name {rows} distinct table '
          f'rows of {levels * grid.table_size}; a warp\'s {shape["points"]} '
          f'points need {per_level} distinct rows per level (of {n * a} '
          f'each), {tile_bytes / 1e9:.4f} GB from L2; L2 gather floor '
          f'{floor_ms:.4f} ms by events, {floor_device} ms device '
          f'({tile_bytes / floor_ms / 1e9:.3f} TB/s by events)')
    for form in ('training', 'eval'):
        r = out[form]
        print(f'kernel K1s {form} form [{gpu}] {tag} N={n}: {r["ms"]:.4f} ms '
              f'by events, {r["device_ms"]} ms device, DRAM bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]}), L2 gather floor '
              f'{floor_ms:.4f} ms')
    return dict(ms=out['training']['ms'],
                device_ms=out['training']['device_ms'],
                bound=out['training']['bound'], eval_ms=out['eval']['ms'],
                eval_device_ms=out['eval']['device_ms'],
                eval_bound_ms=out['eval']['bound'][0], distinct_rows=rows,
                tile_points=shape['points'], tile_rows=per_level,
                l2_floor_ms=floor_ms, l2_floor_device_ms=floor_device)


def _check_k3b(checks, tag, packed, A, B, g1, gf, gl, need_dB=True):
    """K3b against its plain version on (A, B, g1, gf, gl) and the bf16
    packed weights. Both take bf16 operands and sum in another order.
    That order can round an activation that sits at 0 to either side,
    and the ReLU mask of that (point, unit) then flips: the point's
    cotangents differ by O(their size) there. So dA and dB are held
    within 1e-2 of their norm, with at most 3e-4 of their elements beyond
    2e-2 of the largest magnitude; and, the second witness, for the
    cause: against the fp32 plain version the kernel is no less accurate
    than the bf16 plain version (room 1.1). Both round at the same
    places, so mask flips alone grow that distance by a small share; a
    fault (a wrong index, a dropped term or mask) adds errors of the
    values' own size. Each weight gradient, a sum over the points, within
    1e-2 of its norm; a second launch gives the same weight gradients'
    bits. Returns dA's largest error and the fp32 witness."""
    import torch
    from autolabel_tpu_torch.ops import heads_cuda
    n = A.shape[0]
    dA, dB, dws = heads_cuda.fused_heads_backward(packed, A, B, g1, gf, gl,
                                                  need_dB)
    wA, wB, wws = heads_cuda.fused_heads_backward_plain(
        packed, A, B, g1, gf, gl, torch.bfloat16)
    fA, fB, _ = heads_cuda.fused_heads_backward_plain(packed, A, B, g1, gf,
                                                      gl, torch.float32)
    errors, witness = {}, {}
    for key, got, ref, want in (('dA', dA, wA, fA), ('dB', dB, wB, fB)):
        if got is None:
            continue
        checks.rel_norm(f'K3b {key} {tag} N={n}', got, ref, 1e-2)
        errors[key] = checks.flips(f'K3b {key} {tag} N={n} elements', got,
                                   ref, 2e-2 * float(ref.abs().max()), 3e-4)
        witness[key] = checks.no_worse(
            f'K3b {key} {tag} N={n} against fp32', got, ref, want,
            2e-2 * float(want.abs().max()), 1.1)
    del dA, dB, wA, wB, fA, fB
    weight_names = ('WA', 'WBs', 'W1s', 'W2s', 'WBc', 'WSc', 'W1c', 'W2c',
                    'WSf', 'W1f', 'W2f', 'WFo', 'WSo', 'W1o')
    for name, a, b in zip(weight_names, dws, wws):
        checks.rel_norm(f'K3b d{name} {tag} N={n}', a, b, 1e-2)
    _, _, again = heads_cuda.fused_heads_backward(packed, A, B, g1, gf, gl,
                                                  need_dB)
    checks.true(f'K3b dW {tag} N={n} bit-equal across two launches',
                all(torch.equal(a, b) for a, b in zip(dws, again)))
    return errors['dA'], witness


def _check_select_scatter(checks, gpu, dev, tag, g, u, k, idx, w, rows,
                          grid):
    """K5 and K2s on one step's recorded inputs: K5 against itself, float64
    and the plain subsample (its counts exactly the floors of its own fp32
    scan, read from its workspace; that scan within select_scan_bound of
    float64, its coefs within select_coef_bound of float64 on every point
    drawn and of the plain version's on every point both give the same
    count), then K2s against the plain scatter fed the same (sel, coef),
    within sampled_backward_tolerance. Returns the selection and the
    errors."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    n = g.shape[0]
    work = torch.empty(hashgrid_cuda.select_workspace_bytes(n),
                       dtype=torch.uint8, device=dev)
    sel, coef, count = hashgrid_cuda._select_call(g, u, k, work)
    m = int(count[0])
    sel_check = hashgrid_cuda.check_selection(
        g, u[0, n], k, sel, coef, count,
        hashgrid_cuda.select_workspace_views(work, n))
    del work
    print(f'K5 [{gpu}] {tag} N={n} k={k}: {m} points drawn; counts equal '
          f'to its own scan\'s floors: {sel_check["counts_equal"]}; scan '
          f'{sel_check["scan_dev"]:.3e} counts from float64 (bound '
          f'{hashgrid_cuda.select_scan_bound(n, k, g.shape[1]):.3e}); '
          f'coefs {sel_check["coef_rel"]:.3e} from float64 (bound '
          f'{hashgrid_cuda.select_coef_bound(n, g.shape[1]):.3e}); '
          f'{sel_check["truth_off"]} counts off float64, '
          f'{sel_check["plain_off"]} off the plain version\'s (its scan '
          f'{sel_check["plain_dev"]:.3e} counts from float64); coefs '
          f'{sel_check["plain_coef_rel"]:.3e} from the plain version\'s on '
          f'{sel_check["plain_compared"]} points')
    failures = hashgrid_cuda.selection_failures(sel_check, n, k, g.shape[1])
    checks.true(f'K5 selection {tag} N={n} against itself, float64 and '
                'plain', not failures,
                '; '.join(failures) or 'all conditions hold')
    sel_m, coef_m = sel[:m].long(), coef[:m]
    got = hashgrid_cuda.sampled_scatter(g, idx, w, u, rows, grid, sel, coef,
                                        count)
    want = hashgrid_cuda.encoders.sampled_scatter_plain(
        g, idx, w, u, rows, grid, sel_m, coef_m)
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows, grid,
                                                   sel_m, coef_m)
    k2s_err = checks.within(f'K2s sampled scatter {tag} N={n} k={m}', got,
                            want, tol)
    return dict(sel=sel, coef=coef, count=count, m=m, sel_m=sel_m,
                coef_m=coef_m, sel_check=sel_check,
                k5_err=sel_check['plain_coef_rel'],
                off=sel_check['plain_off'], k2s_err=k2s_err)


def _flagship_phase(dev, seed, gpu, checks, results, shapes, chunks):
    """Phase 9 (see the module docstring). Adds K1s, K5 and K2s to
    `results` and `shapes`; returns what the output file keeps."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.render.renderer import draw_perturbations
    # ---- 9. the flagship step through SimpleTrainer: bench.py's model and
    # options (simplex, sampled backward 2, backward_points 0.25), under
    # both head implementations: K1s, K5 and K2s on every step, and on the
    # 'pallas' leg K3f, K3b, K4f and K4b too.
    fl_options = _flagship_options()
    legs = {impl: _train_slice(dev, seed, _model_config('simplex', impl),
                               fl_options, f'flagship_{impl}')
            for impl in ('xla', 'pallas')}
    fl_held = legs['xla'][2]
    grid = legs['xla'][0].field.config.grid_config
    new_names = {'K1s': hashgrid_cuda.ATOMS_NAME,
                 'K5': hashgrid_cuda.SELECT_NAME,
                 'K2s': hashgrid_cuda.SAMPLED_BWD_NAME}

    # (b) one step, kernels against plain versions: same params and draws.
    # The table's gradient is left to (a): the two subsamples may differ
    # where k cum - u lies within their rounding of an integer.
    fl_grad_errors = {}
    for impl, (tr, ld, _) in legs.items():
        batch = next(ld)
        draws = draw_perturbations(tr.generator, TRAIN_BATCH, fl_options,
                                   grid.n_levels)
        parts_k, grads_k = tr.loss_and_grads(batch, draws)
        with _plain_kernels(hashgrid_cuda, heads_cuda):
            parts_p, grads_p = tr.loss_and_grads(batch, draws)
        for key in parts_k:
            checks.close(f'flagship {impl} step loss {key}', parts_k[key],
                         parts_p[key], atol=1e-6, rtol=2e-2)
        fl_grad_errors[impl] = {
            name: checks.rel_norm(f'flagship {impl} step grad {name}',
                                  grads_k[name], grads_p[name], 5e-2)
            for name in grads_k if name != 'encoder.grid'}
        del grads_k, grads_p

    # (c) the main path: FLAGSHIP_STEPS[impl] steps through
    # train_iterations, every count set to 0 just before and read after.
    fl_launches, fl_curves, fl_mse, fl_train_s = {}, {}, {}, {}
    for impl, (tr, ld, held) in legs.items():
        _, mse_before = tr.eval_step(held)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        curve = [tr.train_iterations(ld, TRAIN_CHUNK)
                 for _ in range(FLAGSHIP_STEPS[impl] // TRAIN_CHUNK)]
        torch.cuda.synchronize()
        fl_train_s[impl] = time.perf_counter() - t0
        fl_launches[impl] = dict(_kernels.launches)
        steps = FLAGSHIP_STEPS[impl]
        expected = dict.fromkeys(new_names.values(), steps)
        expected.update({hashgrid_cuda.NAME: 0, hashgrid_cuda.BWD_NAME: 0})
        for name in (heads_cuda.HEADS, heads_cuda.HEADS_BWD, heads_cuda.MLP3,
                     heads_cuda.MLP3_BWD):
            expected[name] = steps if impl == 'pallas' else 0
        for name, want in expected.items():
            got = fl_launches[impl].get(name, 0)
            checks.true(f'flagship {impl} launches {name}', got == want,
                        f'{got} (expected {want})')
        fl_curves[impl] = [{k: float(v) for k, v in c.items()}
                           for c in curve]
        checks.true(f'flagship {impl} losses finite', all(
            np.isfinite(v) for c in fl_curves[impl] for v in c.values()))
        _, mse_after = tr.eval_step(held)
        fl_mse[impl] = [mse_before, mse_after]
        # 200 steps: at least 2-fold; 20 steps: lower.
        factor = 2.0 if steps >= 200 else 1.0
        checks.true(f'flagship {impl} held-out rgb loss falls',
                    mse_after * factor < mse_before,
                    f'{mse_before:.5f} -> {mse_after:.5f} (PSNR '
                    f'{_psnr(mse_before):.2f} -> {_psnr(mse_after):.2f} dB, '
                    f'{steps} steps)')

    # (a) each new kernel against its plain version on one more step's own
    # recorded inputs (the 'xla' leg, after its 200 steps).
    trainer, loader, _ = legs['xla']
    rec = _record_flagship_inputs(trainer, loader, hashgrid_cuda)
    table_f, x_f = rec['atoms']
    g_f, u_f, k_f = rec['select']
    idx_f, w_f, rows_f = rec['scatter']
    n_f = x_f.shape[0]
    k1s_err, enc_t = _check_k1s(checks, 'step samples', table_f, x_f, idx_f,
                                w_f, grid)
    # K5 against itself, float64 and the plain subsample, and K2s against
    # the plain scatter fed the same (sel, coef), on the step's cotangent.
    sc = _check_select_scatter(checks, gpu, dev, 'step samples', g_f, u_f,
                               k_f, idx_f, w_f, rows_f, grid)
    sel_f, coef_f, count_f, m_f = (sc['sel'], sc['coef'], sc['count'],
                                   sc['m'])
    sel_m, coef_m, sel_check = sc['sel_m'], sc['coef_m'], sc['sel_check']
    k5_err, off, k2s_err = sc['k5_err'], sc['off'], sc['k2s_err']
    # K2s exact: every level at its 4 rows, every point.
    exact = hashgrid_cuda.sampled_scatter(g_f, idx_f, w_f, None, (4,) * 4,
                                          grid)
    want_x = hashgrid_cuda.encoders.sampled_scatter_plain(
        g_f, idx_f, w_f, None, (4,) * 4, grid)
    checks.within(f'K2s exact simplex step samples N={n_f}', exact, want_x,
                  hashgrid_cuda.sampled_backward_tolerance(
                      g_f, idx_f, w_f, None, (4,) * 4, grid))
    del want_x
    # Unbiasedness on the card: the mean of UNBIASED_DRAWS draws of K5 +
    # K2s is the exact gradient within 4 standard errors (in the norm, from
    # the draws' own spread).
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    acc = torch.zeros(exact.shape, dtype=torch.float64, device=dev)
    acc2 = torch.zeros_like(acc)
    for _ in range(UNBIASED_DRAWS):
        u_d = torch.rand(u_f.shape, generator=gen, device=dev)
        s_d, c_d, n_d = hashgrid_cuda.select_points(g_f, u_d, k_f)
        est = hashgrid_cuda.sampled_scatter(g_f, idx_f, w_f, u_d, rows_f,
                                            grid, s_d, c_d, n_d).double()
        acc += est
        acc2 += est * est
    mean = acc / UNBIASED_DRAWS
    var = (acc2 / UNBIASED_DRAWS - mean * mean).clamp(min=0) \
        * UNBIASED_DRAWS / (UNBIASED_DRAWS - 1)
    se = float(torch.sqrt(var.sum() / UNBIASED_DRAWS))
    bias = float((mean - exact.double()).norm())
    unbiased_ratio = bias / max(se, 1e-30)
    print(f'K5+K2s unbiasedness [{gpu}]: |mean of {UNBIASED_DRAWS} draws - '
          f'exact| = {bias:.4e}, standard error {se:.4e}: ratio '
          f'{unbiased_ratio:.3f} (|exact| {float(exact.norm()):.4e})')
    checks.true('K5+K2s unbiased', unbiased_ratio <= 4.0,
                f'ratio {unbiased_ratio:.3f} (at most 4)')
    del acc, acc2, mean, var, est, exact
    torch.cuda.empty_cache()

    # Times on the recorded inputs, plain versions, bounds and shapes.
    k1s = _k1s_measure(gpu, 'step samples', table_f, x_f, idx_f, grid)
    k1s_plain = _cuda_ms(lambda: hashgrid_cuda.encode_atoms_plain(
        table_f, x_f, grid, 'simplex', torch.bfloat16), 3)
    k5_ms = _cuda_ms(lambda: hashgrid_cuda.select_points(g_f, u_f, k_f), 20)
    k5_plain = _cuda_ms(lambda: hashgrid_cuda.encoders._select_backward_points(
        g_f, u_f[0, n_f], k_f), 5)
    k2s_ms = _cuda_ms(lambda: hashgrid_cuda.sampled_scatter(
        g_f, idx_f, w_f, u_f, rows_f, grid, sel_f, coef_f, count_f), 20)
    k2s_plain = _cuda_ms(lambda: hashgrid_cuda.encoders.sampled_scatter_plain(
        g_f, idx_f, w_f, u_f, rows_f, grid, sel_m, coef_m), 3)
    cast_ms = _cuda_ms(lambda: enc_t.float(), 20)
    # Device time per call from torch.profiler (all of a call's device
    # work: K2s's memset of the gradient, K5's four kernels), which CUDA
    # events over back-to-back calls overstate where a call's host work
    # exceeds its device time.
    device_ms, device_split = {}, {}
    for key, fn in (
            ('K5', lambda: hashgrid_cuda.select_points(g_f, u_f, k_f)),
            ('K2s', lambda: hashgrid_cuda.sampled_scatter(
                g_f, idx_f, w_f, u_f, rows_f, grid, sel_f, coef_f,
                count_f))):
        by_name = _kernel_ms(fn)
        device_ms[key] = None if by_name is None else sum(by_name.values())
        device_split[key] = by_name
    # The split of K5 by kernel and of K2s into its memset and kernel.
    for key in ('K5', 'K2s'):
        if device_split[key] is None:
            print(f'{key} split: the trace holds no device time: not '
                  'measured')
            continue
        print(f'{key} split [{gpu}] N={n_f} drawn={m_f}: device ms per call '
              + ', '.join(f'{name[:40]} {ms:.4f}' for name, ms in
                          device_split[key].items()))
    n_out = grid.out_dim
    a_atoms = 4
    # K5: g read, the selection written; a mul and an add per element.
    k5_bound = _bound(_nbytes(g_f) + 4 + m_f * 8 + 4,
                      2 * g_f.numel(), PEAK_FP32)
    # K2s: the selected points' g, atoms and uniforms and the selection
    # read, the table gradient written; two muls and an add per term.
    rows_sum = sum(rows_f)
    k2s_bound = _bound(m_f * (n_out * g_f.element_size() + 8
                              + grid.n_levels * (a_atoms * 8 + 4))
                       + _nbytes(table_f),
                       3 * m_f * rows_sum * grid.n_features, PEAK_FP32)
    results['K1s'] = dict(max_abs_err=k1s_err, plain_ms=k1s_plain,
                          library_ms=None, **k1s)
    results['K5'] = dict(max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain,
                         bound=k5_bound, library_ms=None, selected=m_f,
                         k=k_f, off=off, scan_dev=sel_check['scan_dev'],
                         coef_rel=sel_check['coef_rel'],
                         device_ms=device_ms['K5'],
                         device_split=device_split['K5'])
    results['K2s'] = dict(max_abs_err=k2s_err, ms=k2s_ms,
                          plain_ms=k2s_plain, bound=k2s_bound,
                          library_ms=None, unbiased_ratio=unbiased_ratio,
                          device_ms=device_ms['K2s'],
                          device_split=device_split['K2s'])
    shapes.update(hashgrid_cuda.sampled_launch_shapes(grid, n_f, k_f,
                                                      rows_f))
    _print_shapes(gpu, {f'{k} N={n_f}': v for k, v in shapes.items()
                        if k.startswith(('K1s', 'K5', 'K2s'))})
    print(f'cast bf16 -> fp32 before K3f [{gpu}] ({n_f} x {n_out}): '
          f'{cast_ms:.4f} ms')
    for key in ('K1s', 'K5', 'K2s'):
        r = results[key]
        print(f'kernel {key} [{gpu}] step samples: {r["ms"]:.4f} ms by '
              f'events, {r["device_ms"]} ms device, plain '
              f'{r["plain_ms"]:.4f} ms, bound {r["bound"][0]:.4f} ms '
              f'({r["bound"][1]})')
    del rec, table_f, x_f, g_f, u_f, idx_f, w_f, enc_t, sc
    torch.cuda.empty_cache()

    # (d) ms per step in turns (plain, kernels, kernels, plain) per leg;
    # peak memory and one profiled step per leg.
    fl_steady, fl_stats, fl_peak, fl_profile = {}, {}, {}, {}
    for impl, (tr, ld, _) in legs.items():
        def fl_step_ms():
            batches = [next(ld) for _ in range(STEPS_PER_TURN)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for batch in batches:
                tr.train_step(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) * 1e3 / STEPS_PER_TURN

        turns = {'kernels': [], 'plain': []}
        for _ in range(TRAIN_ROUNDS):
            for side in ('plain', 'kernels', 'kernels', 'plain'):
                if side == 'plain':
                    with _plain_kernels(hashgrid_cuda, heads_cuda):
                        turns[side].append(fl_step_ms())
                else:
                    turns[side].append(fl_step_ms())
        fl_steady[impl] = turns
        fl_stats[impl] = {k: _quartiles(v) for k, v in turns.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(next(ld))
        torch.cuda.synchronize()
        fl_peak[impl] = torch.cuda.max_memory_allocated()
        fl_profile[impl] = _device_profile(lambda: tr.train_step(next(ld)))

    # (e) the flagship checkpoint, served: the simplex encode through K1s's
    # eval form, equal to the trainer's own render.
    trainer, _, _ = legs['xla']
    trainer.save_checkpoint('best', include_optimizer=False)
    served_fl = InferenceModel.from_checkpoint(
        Field(_model_config('simplex', 'xla'), device=dev,
              generator=torch.Generator().manual_seed(seed + 5)),
        trainer.workspace, num_steps=NUM_STEPS,
        proposal_steps=PROPOSAL_STEPS, max_ray_batch=MAX_RAY_BATCH)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    served_fl_out = served_fl.render(fl_held)
    fl_render_launches = dict(_kernels.launches)
    own_fl = trainer.test_step(fl_held)[0].cpu().numpy()
    checks.true('flagship checkpoint render launches K1s',
                fl_render_launches.get(hashgrid_cuda.ATOMS_NAME, 0) == chunks
                and fl_render_launches.get(hashgrid_cuda.NAME, 0) == 0,
                f'{fl_render_launches}')
    fl_served_err = float(np.abs(served_fl_out['image'] - own_fl).max())
    checks.true('flagship checkpoint serves',
                served_fl_out['image'].shape == (FRAME_H, FRAME_W, 3)
                and bool(np.isfinite(served_fl_out['image']).all())
                and fl_served_err < 1e-5,
                f'max |served - trainer render| = {fl_served_err:.3e}')

    for impl in legs:
        print(f'flagship {impl} [{gpu}]: {FLAGSHIP_STEPS[impl]} steps in '
              f'{fl_train_s[impl]:.3f} s; loss at chunk ends '
              f'{[round(c["total"], 5) for c in fl_curves[impl]]}; '
              f'launches {fl_launches[impl]}')
        for side, st in fl_stats[impl].items():
            print(f'flagship steady [{gpu}] {impl} {side}: ms per step median'
                  f' {st["median"]:.3f} (q1 {st["q1"]:.3f}, q3 '
                  f'{st["q3"]:.3f}, n {st["n"]}); rays/s '
                  f'{TRAIN_BATCH / st["median"] * 1e3:.1f}')
        print(f'flagship step peak memory [{gpu}] {impl}: '
              f'{fl_peak[impl] / 1e9:.3f} GB allocated at {TRAIN_BATCH} rays')
        rows_p, busy_p = fl_profile[impl]
        if rows_p is None:
            print(f'flagship {impl} profile: the trace holds no device time: '
                  'not measured')
        else:
            wall = fl_stats[impl]['kernels']['median']
            print(f'flagship {impl} profile [{gpu}]: device busy '
                  f'{busy_p:.3f} ms of a {wall:.3f} ms step (median wall, '
                  f'unprofiled): busy share {busy_p / wall:.4f}')
            for name, ms, count in rows_p[:18]:
                print(f'  {ms:9.3f} ms {ms / busy_p:7.2%} x{count:<5d} '
                      f'{name[:90]}')
        print(f'flagship {impl} step grads: worst relative error '
              f'{max(fl_grad_errors[impl].values()):.3e}')

    return dict(launches=fl_launches, curves=fl_curves, mse=fl_mse,
                train_s=fl_train_s, grad_errors=fl_grad_errors,
                steady=fl_steady, stats=fl_stats, peak=fl_peak,
                profile={k: v[0] for k, v in fl_profile.items()},
                profile_busy_ms={k: v[1] for k, v in fl_profile.items()},
                render_launches=fl_render_launches,
                served_err=fl_served_err, cast_ms=cast_ms,
                names=new_names)


def _check_occupancy_render(checks, gpu, trainer, testset):
    """The occupancy grid's masking and near/far shrink on the card, on a
    grid that masks. A fresh grid of the trainer's config and trained mask
    is updated once from the trained field (its density then the field's
    sigma at the cell centres, with no decayed past) and thresholded at
    the larger of the config's threshold and the median density, so that
    at most about half the cells count. On it: the occupied share of the
    cells is in (0, 1); shrink_near_far, on frame 0's rays of the test
    split, narrows some rays and gives the bits its CPU run gives on the
    same inputs; and the frame rendered (eval form, the trainer's options)
    through the kernels agrees with the plain versions' render on the same
    grid as phase 5 holds a frame. Returns what the output file keeps."""
    import dataclasses

    import numpy as np
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.render.occupancy import OccupancyGrid
    from autolabel_tpu_torch.render.renderer import (ray_aabb_intersect,
                                                     render_rays,
                                                     shrink_near_far)
    field, old = trainer.field, trainer.occupancy
    bound = field.config.bound
    grid = OccupancyGrid(old.config, bound)
    grid.trained = old.trained.clone()
    grid.update(field)
    threshold = max(old.config.threshold, float(grid.density.median()))
    occupancy = grid.state() + (threshold,)
    share = float(((grid.density > threshold) & grid.trained).float()
                  .mean())
    checks.true('cli B occupancy: a grid that masks', 0.0 < share < 1.0,
                f'{share:.4f} of the cells occupied and trained at threshold '
                f'{threshold:.4e} (the config\'s {old.config.threshold})')
    frame = testset._get_test(0)
    dev = field.device
    rays_o, rays_d = (torch.as_tensor(frame[k].reshape(-1, 3), device=dev)
                      for k in ('rays_o', 'rays_d'))
    norms = torch.as_tensor(frame['direction_norms'].reshape(-1, 1),
                            device=dev)
    options = dataclasses.replace(trainer.render_options, perturb=False)
    near, far = ray_aabb_intersect(rays_o, rays_d, bound)
    shrunk = shrink_near_far(occupancy, rays_o, rays_d, near, far, bound,
                             options.occupancy_probes)
    on_cpu = shrink_near_far(tuple(t.cpu() if torch.is_tensor(t) else t
                                   for t in occupancy),
                             rays_o.cpu(), rays_d.cpu(), near.cpu(),
                             far.cpu(), bound, options.occupancy_probes)
    narrowed = float(((shrunk[0] > near) | (shrunk[1] < far)).float().mean())
    checks.true('cli B occupancy: shrink_near_far narrows rays, its bits '
                'those of its CPU run',
                0.0 < narrowed and all(torch.equal(a.cpu(), b)
                                       for a, b in zip(shrunk, on_cpu)),
                f'{narrowed:.4f} of {rays_o.shape[0]} rays narrowed')

    def render(occ):
        parts = []
        with torch.no_grad():
            for s in range(0, rays_o.shape[0], 4096):
                parts.append(render_rays(
                    field, rays_o[s:s + 4096], rays_d[s:s + 4096],
                    norms[s:s + 4096], options=options, occupancy=occ))
        return {k: torch.cat([p[k] for p in parts]).cpu().numpy()
                for k in ('image', 'depth', 'semantic', 'semantic_features')}

    ours = render(occupancy)
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        plain = render(occupancy)
    unmasked = render(None)
    errors = {}
    for key in ours:
        err = np.abs(ours[key] - plain[key])
        scale = 1.0 if key == 'image' else float(np.abs(plain[key]).max())
        mean, p999 = float(err.mean()), float(np.quantile(err, 0.999))
        errors[key] = dict(mean_abs=mean, p99_9=p999, max=float(err.max()),
                           scale=scale)
        checks.true(f'cli B occupancy render {key} vs plain render',
                    bool(np.isfinite(ours[key]).all())
                    and mean < 5e-3 * scale and p999 < 5e-2 * scale,
                    f'mean_abs={mean:.3e} p99.9={p999:.3e} '
                    f'max={float(err.max()):.3e} (scale {scale:.3e})')
    moved = float(np.abs(ours['image'] - unmasked['image']).mean())
    print(f'cli B occupancy [{gpu}]: the masked render moves the image by '
          f'{moved:.4e} on average from the unmasked one')
    return dict(share=share, threshold=threshold, narrowed=narrowed,
                errors=errors, moved_by_mask=moved)


# The train CLI (phase 10): the sphere scene of utils.fixtures, iterations
# of README's command (Run A) and of the command with every option this
# slice ports (Run B).
CLI_SCENE = dict(n_frames=16, width=320, height=240)
CLI_ITERS = {'A': 300, 'B': 100}
CLI_BASE = ['--proposal']
CLI_B = ['--proposal', '--heads-impl', 'pallas', '--occupancy-grid',
         '--occupancy-near-far', '--tensorboard']
# The model-hash directory scripts/train.py names for README's flags
# (tests/test_torch_port_cli.py holds the two CLIs equal).
CLI_HASH = 'g15_hg+freq_plain_rgb1.0_d0.1_s1.0_f0.5_tpugrid_prop_simplex'
LOADER_BATCHES, PROFILED_STEPS, TIMED_STEPS = 40, 5, 20


def _cli_phase(dev, gpu, checks, results):
    """Phase 10 (see the module docstring). Adds the CLI's launch counts
    and its K1s, K5, K2s and K3b checks at its own shapes to `results`;
    returns what the output file keeps."""
    import shutil

    import numpy as np
    import torch
    from autolabel_tpu_torch import model_utils
    from autolabel_tpu_torch.core.dataset import LenDataset, SceneDataset
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.render import occupancy as occupancy_module
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.train.loader import PrefetchIterator
    from autolabel_tpu_torch.train.tb_events import read_events
    from autolabel_tpu_torch.utils import fixtures
    phase_start = time.perf_counter()
    root = os.path.join(WORK_DIR, 'cli')
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, 'sphere')
    t0 = time.perf_counter()
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    scene_s = time.perf_counter() - t0
    full = ['--factor-train', '1', '--factor-test', '1', '--eval']

    def workspace(name):
        return ['--workspace', os.path.join(root, name)]

    # A 1-iteration run of Run A's command: the untrained field's eval.
    base = cli.main([scene] + CLI_BASE + full + ['--iters', '1']
                    + workspace('base'))
    del base.trainer

    # Run A, every count set to 0 just before and read just after; the
    # last step's K1s (training form), K5 and K2s inputs recorded, and
    # K1s's launches split into its training form (atoms written) and its
    # eval form.
    steps_a = CLI_ITERS['A']
    rec, forms = {}, {'training': 0, 'eval': 0}
    atoms, select, scatter = (hashgrid_cuda._atoms_call,
                              hashgrid_cuda._select_call,
                              hashgrid_cuda._sampled_scatter_call)
    calls = {'select': 0, 'scatter': 0}

    def rec_atoms(table, x, config, interp, out_dtype, with_atoms):
        form = 'training' if with_atoms else 'eval'
        forms[form] += 1
        if with_atoms and forms[form] == steps_a:
            rec['atoms'] = (table.detach().clone(), x.clone())
        return atoms(table, x, config, interp, out_dtype, with_atoms)

    def rec_select(g, u, k):
        calls['select'] += 1
        if calls['select'] == steps_a:
            rec['select'] = (g.clone(), u.clone(), k)
        return select(g, u, k)

    def rec_scatter(g, idx, w, u, rows, config, sel, coef, count):
        calls['scatter'] += 1
        if calls['scatter'] == steps_a:
            rec['scatter'] = (idx.clone(), w.clone(), rows)
        return scatter(g, idx, w, u, rows, config, sel, coef, count)

    (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
     hashgrid_cuda._sampled_scatter_call) = (rec_atoms, rec_select,
                                             rec_scatter)
    try:
        _kernels.reset_launches()
        run_a = cli.main([scene] + CLI_BASE + full
                         + ['--iters', str(steps_a)] + workspace('a'))
        launches_a = dict(_kernels.launches)
    finally:
        (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
         hashgrid_cuda._sampled_scatter_call) = atoms, select, scatter
    trainer, dataset = run_a.trainer, run_a.dataset
    testset = SceneDataset('test', scene, factor=1.0)
    frame_rays = testset.w * testset.h
    chunks = -(-frame_rays // 4096)  # the trainer's max_ray_batch
    eval_chunks = len(testset.poses) * chunks
    grid = trainer.field.config.grid_config
    names = {'K1s': hashgrid_cuda.ATOMS_NAME,
             'K5': hashgrid_cuda.SELECT_NAME,
             'K2s': hashgrid_cuda.SAMPLED_BWD_NAME,
             'K3f': heads_cuda.HEADS, 'K3b': heads_cuda.HEADS_BWD,
             'K4f': heads_cuda.MLP3, 'K4b': heads_cuda.MLP3_BWD}
    checks.true('cli A: K1s training form once a step, eval form once a '
                'chunk', forms == {'training': steps_a, 'eval': eval_chunks}
                and launches_a.get(names['K1s'], 0) == steps_a + eval_chunks,
                f'{forms}, {launches_a.get(names["K1s"], 0)} launches '
                f'(expected {steps_a} + {eval_chunks}: {len(testset.poses)} '
                f'frames x {chunks} chunks)')
    for key in ('K5', 'K2s'):
        got = launches_a.get(names[key], 0)
        checks.true(f'cli A launches {key}', got == steps_a,
                    f'{got} (expected {steps_a})')
    for key in ('K3f', 'K3b', 'K4f', 'K4b'):  # 'xla' heads: none
        got = launches_a.get(names[key], 0)
        checks.true(f'cli A launches no {key}', got == 0, f'{got}')
    model_dir = run_a.model_dir
    want_dir = os.path.join(root, 'a', 'sphere', CLI_HASH)
    files = {f: os.path.exists(os.path.join(model_dir, f)) for f in (
        'params.pkl', 'metrics.jsonl', 'checkpoints/ngp_ep0001.pth')}
    checks.true('cli A workspace: the model-hash directory and its files',
                model_dir == want_dir and all(files.values()),
                f'{model_dir}: {files}')
    mse_a, mse_base = run_a.eval_mse, base.eval_mse
    checks.true('cli A eval mse falls 4-fold from 1 iteration',
                np.isfinite(mse_a) and mse_a * 4 < mse_base,
                f'{mse_base:.5f} -> {mse_a:.5f} (PSNR {_psnr(mse_base):.2f} '
                f'-> {_psnr(mse_a):.2f} dB)')
    # The checkpoint, served: a fresh field from params.pkl's flags.
    flags = model_utils.read_params(model_dir)
    served = InferenceModel.from_checkpoint(
        model_utils.create_model(dataset.min_bounds, dataset.max_bounds, 2,
                                 flags,
                                 generator=torch.Generator().manual_seed(7)),
        model_dir, num_steps=flags.num_steps,
        proposal_steps=flags.proposal_steps)
    frame = testset._get_test(0)
    image = served.render(frame)['image']
    served_mse = float(np.mean((image - frame['pixels']) ** 2))
    checks.true('cli A checkpoint serves a finite frame',
                image.shape == (testset.h, testset.w, 3)
                and bool(np.isfinite(image).all()),
                f'{image.shape}, mse {served_mse:.5f}')
    del served

    # K1s, K5 and K2s on the last step's own inputs, at the CLI's shape.
    checks.true('cli A recorded the last step\'s K1s, K5 and K2s inputs',
                set(rec) == {'atoms', 'select', 'scatter'}, f'{sorted(rec)}')
    if set(rec) == {'atoms', 'select', 'scatter'}:
        table_a, x_a = rec['atoms']
        g_a, u_a, k_a = rec['select']
        idx_a, w_a, rows_a = rec['scatter']
        n_a = x_a.shape[0]
        k1s_err, enc_a = _check_k1s(checks, 'cli step', table_a, x_a, idx_a,
                                    w_a, grid)
        del enc_a
        sc = _check_select_scatter(checks, gpu, dev, 'cli step', g_a, u_a,
                                   k_a, idx_a, w_a, rows_a, grid)
        k1s_cli = _k1s_measure(gpu, 'cli step', table_a, x_a, idx_a, grid)
        # their device ms per call at this shape, from the profiler
        cli_ms = {key: _kernel_ms(fn) for key, fn in (
            ('K5', lambda: hashgrid_cuda.select_points(g_a, u_a, k_a)),
            ('K2s', lambda: hashgrid_cuda.sampled_scatter(
                g_a, idx_a, w_a, u_a, rows_a, grid, sc['sel'], sc['coef'],
                sc['count'])))}
        cli_ms = {key: None if v is None else sum(v.values())
                  for key, v in cli_ms.items()}
        bound = k1s_cli.pop('bound')
        results['K1s']['cli'] = dict(n=n_a, max_abs_err=k1s_err,
                                     bound_ms=bound[0], bound_by=bound[1],
                                     **k1s_cli)
        results['K5']['cli'] = dict(
            n=n_a, k=k_a, drawn=sc['m'], max_abs_err=sc['k5_err'],
            off=sc['off'], scan_dev=sc['sel_check']['scan_dev'],
            device_ms=cli_ms['K5'])
        results['K2s']['cli'] = dict(n=n_a, drawn=sc['m'],
                                     max_abs_err=sc['k2s_err'],
                                     device_ms=cli_ms['K2s'])
        print(f'K5, K2s [{gpu}] cli step N={n_a} drawn={sc["m"]}: '
              + ', '.join(f'{key} {ms} ms' for key, ms in cli_ms.items())
              + ' device a call')
        del table_a, x_a, g_a, u_a, idx_a, w_a, sc
    del rec

    # Timing on Run A's trainer: the loader's batch on the host, steps
    # through the CLI's loader (by the wall clock, and profiled), steps on
    # one pre-made batch.
    t0 = time.perf_counter()
    host = [dataset._next_train() for _ in range(LOADER_BATCHES)]
    host_ms = (time.perf_counter() - t0) * 1e3 / LOADER_BATCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in host:
        trainer._device_batch(batch)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3 / LOADER_BATCHES
    del host

    def loader_steps(n, copy_on_loader=True):
        loader = PrefetchIterator(LenDataset(dataset, n),
                                  transform=(trainer._device_batch
                                             if copy_on_loader else None))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in loader:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / n

    loop_ms = loader_steps(TIMED_STEPS)
    # the same with the copy to the device made by the step, on the main
    # thread: what the loader thread's copy costs the step
    main_copy_ms = loader_steps(TIMED_STEPS, copy_on_loader=False)
    # the device's busy time and the wall clock of the same profiled steps
    profiled = []
    profile_rows, busy_ms = _device_profile(
        lambda: profiled.append(loader_steps(PROFILED_STEPS)))
    profiled_ms = profiled[0]
    # A batch made once and held on the device, as bench_torch.py times
    # its steps (bench_torch.py's own batch carries 6 classes' labels).
    premade = trainer._device_batch(dataset._next_train())
    trainer.train_step(premade)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        trainer.train_step(premade)
    torch.cuda.synchronize()
    premade_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    step_ms = {'A': run_a.train_s * 1e3 / steps_a}
    del run_a, trainer, premade
    torch.cuda.empty_cache()

    # Run B: the heads' kernels, the occupancy grid (one update, timed,
    # with its peak memory) and TensorBoard events; the last step's K3b
    # inputs recorded.
    steps_b = CLI_ITERS['B']
    update = occupancy_module.OccupancyGrid.update
    updates = []

    def timed_update(self, field):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        update(self, field)
        torch.cuda.synchronize()
        updates.append(dict(
            ms=(time.perf_counter() - t1) * 1e3,
            peak_bytes=torch.cuda.max_memory_allocated() - before,
            occupied=float((self.density > self.config.threshold).float()
                           .mean())))

    rec = {}
    heads_bwd, k3b_calls = heads_cuda._heads_backward_launch, [0]

    def rec_heads_bwd(ws, A, B, g1, gf, gl, need_dB=True):
        k3b_calls[0] += 1
        if k3b_calls[0] == steps_b:
            rec['heads_bwd'] = ([w.clone() for w in ws], A.clone(),
                                B.clone(), g1.clone(), gf.clone(),
                                gl.clone(), need_dB)
        return heads_bwd(ws, A, B, g1, gf, gl, need_dB)

    occupancy_module.OccupancyGrid.update = timed_update
    heads_cuda._heads_backward_launch = rec_heads_bwd
    try:
        _kernels.reset_launches()
        run_b = cli.main([scene] + CLI_B + ['--iters', str(steps_b)]
                         + workspace('b'))
        launches_b = dict(_kernels.launches)
    finally:
        occupancy_module.OccupancyGrid.update = update
        heads_cuda._heads_backward_launch = heads_bwd
    update_chunks = -(-run_b.trainer.occupancy.config.resolution ** 3
                      // occupancy_module.UPDATE_CHUNK)
    for key, name in names.items():
        want = steps_b + (update_chunks * len(updates) if key == 'K1s'
                          else 0)
        got = launches_b.get(name, 0)
        checks.true(f'cli B launches {key}', got == want,
                    f'{got} (expected {want}'
                    + (f': {steps_b} steps + {update_chunks} chunks of the '
                       'occupancy update)' if key == 'K1s' else ')'))
    checks.true('cli B one occupancy update', len(updates) == 1,
                f'{updates}')
    (events,) = os.listdir(os.path.join(run_b.model_dir, 'run', 'ngp'))
    read = read_events(os.path.join(run_b.model_dir, 'run', 'ngp', events))
    checks.true('cli B TensorBoard events read back',
                len(read) == 1 and read[0][0] == steps_b
                and 'train/total' in read[0][1]
                and all(np.isfinite(v) for v in read[0][1].values()),
                f'{read}')
    with open(os.path.join(run_b.model_dir, 'metrics.jsonl')) as f:
        loss_b = json.loads(f.readline())['total']
    checks.true('cli B loss finite', bool(np.isfinite(loss_b)),
                f'{loss_b}')
    step_ms['B'] = run_b.train_s * 1e3 / steps_b

    # K3b on the last step's own inputs, at the CLI's shape.
    checks.true('cli B recorded the last step\'s K3b inputs',
                'heads_bwd' in rec, f'{sorted(rec)}')
    if 'heads_bwd' in rec:
        ws, A_b, B_b, g1, gf, gl, need_dB = rec.pop('heads_bwd')
        k3b_err, k3b_witness = _check_k3b(checks, 'cli step', ws, A_b, B_b,
                                          g1, gf, gl, need_dB)
        k3b_split = _kernel_ms(lambda: heads_cuda.fused_heads_backward(
            ws, A_b, B_b, g1, gf, gl, need_dB))
        k3b_events = _cuda_ms(lambda: heads_cuda.fused_heads_backward(
            ws, A_b, B_b, g1, gf, gl, need_dB), 10)
        results['K3b']['cli'] = dict(
            n=A_b.shape[0], need_dB=need_dB, max_abs_err=k3b_err,
            against_fp32=k3b_witness, ms=k3b_events,
            device_ms=None if k3b_split is None else sum(k3b_split.values()))
        print(f'K3b [{gpu}] cli step N={A_b.shape[0]}: '
              f'{results["K3b"]["cli"]["device_ms"]} ms device a call '
              f'({k3b_split}), {k3b_events:.4f} ms by events')
        del ws, A_b, B_b, g1, gf, gl
        torch.cuda.empty_cache()
    occupancy_check = _check_occupancy_render(checks, gpu, run_b.trainer,
                                              testset)
    del run_b

    for key in ('A', 'B'):
        print(f'cli {key} [{gpu}]: {CLI_ITERS[key]} steps, ms per step over '
              f'the epoch\'s wall clock {step_ms[key]:.3f}')
    print(f'cli loader [{gpu}] host thread: ms per batch {host_ms:.3f} '
          f'(numpy assembly of {dataset.batch_size} rays), '
          f'{copy_ms:.3f} more to copy it to the device; scene written in '
          f'{scene_s:.1f} s')
    print(f'cli step [{gpu}] through the loader {loop_ms:.3f} ms over '
          f'{TIMED_STEPS} steps (the copy made by the step instead: '
          f'{main_copy_ms:.3f} ms); on a pre-made batch on the device (as '
          f'bench_torch.py times) {premade_ms:.3f} ms')
    if profile_rows is None:
        print('cli profile: the trace holds no device time: not measured')
    else:
        print(f'cli profile [{gpu}]: device busy {busy_ms:.3f} ms over '
              f'{PROFILED_STEPS} steps through the loader '
              f'({busy_ms / PROFILED_STEPS:.3f} a step) of the same steps\' '
              f'{profiled_ms * PROFILED_STEPS:.3f} ms wall clock (profiled):'
              f' busy share {busy_ms / (profiled_ms * PROFILED_STEPS):.4f}')
        for name, ms, count in profile_rows[:12]:
            print(f'  {ms:9.3f} ms {ms / busy_ms:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    print(f'cli phase: {time.perf_counter() - phase_start:.1f} s')
    for u in updates:
        print(f'cli occupancy update [{gpu}]: {u["ms"]:.3f} ms, peak '
              f'{u["peak_bytes"] / 1e9:.3f} GB above the step\'s; '
              f'{u["occupied"]:.4f} of the cells occupied')
    return dict(launches={'A': launches_a, 'B': launches_b},
                k1s_forms=forms, eval_chunks=eval_chunks,
                ms_per_step=step_ms,
                eval_mse={'A': mse_a, 'base': mse_base},
                served_mse=served_mse, loader_host_ms=host_ms,
                loader_copy_ms=copy_ms, loop_ms=loop_ms,
                main_copy_loop_ms=main_copy_ms, premade_ms=premade_ms,
                profile_busy_ms=busy_ms, profiled_ms=profiled_ms,
                profile=profile_rows, occupancy_updates=updates,
                occupancy_check=occupancy_check, names=names)


# The stochastic-corner and residual encodes (phase 11): README's command
# with the sampled backward off (Run C, the TPU grid's simplex encode of 2
# draws) and on the reference preset with its 4 finest levels exact (Run
# D), on phase 10's scene; K6 and K7 held in every mode of the CPU tests
# on the last step's recorded (table, x) of each run.
CLI_STOCHASTIC = {'C': (['--sampled-backward', '0'], 200),
                  'D': (['--grid-preset', 'reference',
                         '--stochastic-exact-levels', '4'], 100)}
# (interp, n_samples, residual) and the exact levels of each preset's modes
STOCHASTIC_MODES = {
    'C': ([('trilinear', 1, False), ('trilinear', 2, False),
           ('trilinear', 3, False), ('simplex', 1, False),
           ('simplex', 2, False), ('trilinear', 2, True),
           ('simplex', 2, True)], (0, 1, 4)),
    'D': ([('trilinear', 1, False), ('trilinear', 2, False),
           ('trilinear', 3, False)], (0, 4, 16))}
STOCHASTIC_POINTS = (131072, 524288)
# More draws a level than a warp has lanes (K6 once capped them at 32):
# held at STOCHASTIC_POINTS[0] on each run's recorded inputs, and a few CLI
# steps of Run C's command at 33.
STOCHASTIC_MANY = (33, 64)
CLI_MANY = (['--sampled-backward', '0', '--stochastic-corners', '33'], 5)
# Run E: the exact reference estimator (the original autolabel's tcnn
# training: exact gathers on the reference preset), K1's and K2's narrow
# rows once a step; the CLI runs its iterations as one epoch.
CLI_EXACT = (['--grid-preset', 'reference', '--stochastic-corners', '0'], 50)
LOSS_WINDOW = 10  # Run E's first and last steps whose mean losses compare


def k7_yardstick(encoders, g, idx, w, plan, config, n_samples):
    """K7's library yardstick: one index_add_ of the drawn rows, weighted as
    K7 weighs them (made here, outside the timing), into a flattened table
    gradient; returns the call."""
    import torch
    f = config.n_features
    levels = torch.repeat_interleave(
        torch.arange(config.n_levels, device=idx.device),
        torch.tensor([r for _, r in plan], device=idx.device))
    flat_rows = (levels[:, None] * config.table_size
                 + idx.long()).reshape(-1)
    terms = []
    for l, (kind, rows, _, wfirst) in enumerate(encoders.plan_starts(plan)):
        g_l = g[:, l * f:(l + 1) * f]
        if kind == encoders.DRAWS and n_samples > 1:
            g_l = g_l * encoders.sample_scale(n_samples, g.device)
        for r in range(rows):
            terms.append(g_l if kind == encoders.DRAWS
                         else w[wfirst + r][:, None] * g_l)
    terms = torch.cat(terms)
    flat = torch.empty((config.n_levels * config.table_size, f),
                       device=g.device)

    def library():
        flat.zero_()
        flat.index_add_(0, flat_rows, terms)
        return flat

    return library


def _stochastic_measure(gpu, tag, table, x, u, config, interp, n_samples,
                        plan):
    """K6 (training form: rows written) and K7 on one step's recorded
    inputs, by CUDA events (20 launches) and the profiler's device ms a
    call, beside their bounds, their plain versions' times and, for K7,
    the library yardstick: one index_add_ of the pre-weighted drawn rows
    into the flattened table. K6's bound counts x, the uniforms of the
    levels that draw (EXACT levels read none), each table row its draws
    name once, the output and the rows written (the indices of every row,
    the weights of the RESIDUAL and EXACT rows only); K7's the cotangent,
    those rows read and the gradient written once (fp32 adds and muls: two
    an element of a row)."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    encoders = hashgrid_cuda.encoders
    n, s = x.shape[0], sum(r for _, r in plan)

    def k6():
        return hashgrid_cuda._stochastic_call(table, x, u, config, interp,
                                              n_samples, plan, True)

    out, idx, w = k6()
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device)
                    .manual_seed(11))

    def k7():
        return hashgrid_cuda._stochastic_scatter_call(g, idx, w, plan, config,
                                                      n_samples)

    # the phase's first trace, where a bare trace of K6 held none of its
    # launches
    res = {'probe': _trace_probe(gpu, f'K6 {tag}', k6)}
    for key, fn, plain in (
            ('K6', k6, lambda: hashgrid_cuda.stochastic_encode_plain(
                table, x, u, config, interp, n_samples, plan)),
            ('K7', k7, lambda: encoders.stochastic_scatter_plain(
                g, idx, w, plan, config, n_samples))):
        by_kernel = _kernel_ms(fn)
        res[key] = dict(ms=_cuda_ms(fn, 20), plain_ms=_cuda_ms(plain, 3),
                        device_ms=None if by_kernel is None
                        else sum(by_kernel.values()),
                        device_split=by_kernel)
    levels = torch.repeat_interleave(
        torch.arange(config.n_levels, device=idx.device),
        torch.tensor([r for _, r in plan], device=idx.device))
    flat_rows = (levels[:, None] * config.table_size + idx.long()).reshape(-1)
    distinct = int(torch.unique(flat_rows).numel())
    f = config.n_features
    flops = 2 * s * n * f
    drawing = sum(k != encoders.EXACT for k, _ in plan)
    u_bytes = _nbytes(u) * drawing // config.n_levels
    res['K6']['bound'] = _bound(
        _nbytes(x, out, idx, w) + u_bytes + distinct * f * 4, flops,
        PEAK_FP32)
    dtable = k7()
    res['K7']['bound'] = _bound(_nbytes(g, idx, w, dtable), flops, PEAK_FP32)
    del dtable
    library = k7_yardstick(encoders, g, idx, w, plan, config, n_samples)
    res['K7']['library_ms'] = _cuda_ms(library, 5)
    by_kernel = _kernel_ms(library)
    res['K7']['library_device_ms'] = None if by_kernel is None \
        else sum(by_kernel.values())
    res['K6']['library_ms'] = None
    del library
    for key in ('K6', 'K7'):
        r = res[key]
        print(f'kernel {key} [{gpu}] {tag} N={n}: {r["ms"]:.4f} ms by events, '
              f'{r["device_ms"]} ms device, plain {r["plain_ms"]:.4f} ms, '
              f'library {r["library_ms"]} ms'
              + (f' ({r["library_device_ms"]} ms device)' if key == 'K7'
                 else ' (none: no one PyTorch call)')
              + f', bound {r["bound"][0]:.4f} ms ({r["bound"][1]})')
    print(f'  {tag}: the draws name {distinct} distinct table rows of '
          f'{config.n_levels * config.table_size}; {s} rows a point')
    return res


def _cli_exact(gpu, checks, scene, root, names):
    """Run E (CLI_EXACT) on phase 10's scene: K1 and K2 (narrow rows) once
    a step and no other encode kernel, the losses finite and falling, ms a
    step over the epoch's wall clock, the busy share and top kernels of
    PROFILED_STEPS traced steps through the loader with K2's share, and K2
    held against its plain version on a step's recorded (g, x) at the
    CLI's own N. Returns what the output file keeps."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core.dataset import LenDataset
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.train.loader import PrefetchIterator
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    flags, steps = CLI_EXACT
    losses, train_step = [], SimpleTrainer.train_step

    def recorded_step(self, data, draws=None):
        parts = train_step(self, data, draws)
        losses.append(parts['total'])
        return parts

    SimpleTrainer.train_step = recorded_step
    try:
        _kernels.reset_launches()
        run = cli.main([scene] + CLI_BASE + flags + [
            '--factor-train', '1', '--iters', str(steps), '--workspace',
            os.path.join(root, 'E')])
        launches = dict(_kernels.launches)
    finally:
        SimpleTrainer.train_step = train_step
    for name in names:
        want = steps if name in ('K1', 'K2') else 0
        got = launches.get(names[name], 0)
        checks.true(f'cli E launches {name}', got == want,
                    f'{got} (expected {want}'
                    + (': one a step)' if want else ')'))
    curve = torch.stack(losses).float().cpu().numpy()
    first = float(curve[:LOSS_WINDOW].mean())
    last = float(curve[-LOSS_WINDOW:].mean())
    checks.true(f'cli E losses finite and falling over {steps} steps',
                bool(np.isfinite(curve).all()) and last < first,
                f'mean of the first {LOSS_WINDOW} {first:.5f}, of the last '
                f'{last:.5f}')
    step_ms = run.train_s * 1e3 / steps
    print(f'cli E [{gpu}] {" ".join(flags)}: {steps} steps, ms per step '
          f'over the epoch\'s wall clock {step_ms:.3f}')
    trainer, dataset, wall = run.trainer, run.dataset, []

    def loader_steps():
        loader = PrefetchIterator(LenDataset(dataset, PROFILED_STEPS),
                                  transform=trainer._device_batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in loader:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)

    loader_steps()
    rows, busy = _device_profile(loader_steps)
    profile = None
    if rows is None:
        print('cli E profile: the trace holds no device time: not measured')
    else:
        k2_ms = sum(ms for name, ms, _ in rows
                    if 'scatter_group_kernel' in name)
        profile = dict(busy_ms=busy, wall_ms=wall[-1], rows=rows[:12],
                       k2_ms=k2_ms)
        print(f'cli E profile [{gpu}]: device busy {busy:.3f} ms over '
              f'{PROFILED_STEPS} steps through the loader '
              f'({busy / PROFILED_STEPS:.3f} a step) of their '
              f'{wall[-1]:.3f} ms wall clock: busy share '
              f'{busy / wall[-1]:.4f}; K2 narrow {k2_ms / PROFILED_STEPS:.4f}'
              f' ms a step, {k2_ms / busy:.2%} of the busy time, '
              f'{k2_ms / wall[-1]:.2%} of the wall clock')
        for name, ms, count in rows[:12]:
            print(f'  {ms:9.3f} ms {ms / busy:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    g, x = _record_k2_inputs(trainer, iter(PrefetchIterator(
        LenDataset(dataset, 1), transform=trainer._device_batch)))
    config = trainer.field.config.grid_config
    del run, trainer, dataset
    torch.cuda.empty_cache()
    err = _check_k2(checks, f'K2 table gradient cli E step N={x.shape[0]}',
                    hashgrid_cuda, g, x, config)
    timed = _k2_narrow_measure(gpu, 'cli E step', hashgrid_cuda, g, x,
                               config)
    return dict(launches=launches, ms_per_step=step_ms, loss_first=first,
                loss_last=last, loss_curve=curve.tolist(), profile=profile,
                k2_max_abs_err=err, k2=timed)


def _stochastic_phase(dev, gpu, checks, results, shapes, scene):
    """Phase 11 (see the module docstring). Adds K6 and K7 to `results` and
    `shapes`; returns what the output file keeps."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core.dataset import LenDataset, SceneDataset
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.train.loader import PrefetchIterator
    phase_start = time.perf_counter()
    root = os.path.join(WORK_DIR, 'stochastic')
    full = ['--factor-train', '1', '--factor-test', '1', '--eval']
    testset = SceneDataset('test', scene, factor=1.0)
    eval_chunks = len(testset.poses) * -(-testset.w * testset.h // 4096)
    names = {'K6': hashgrid_cuda.STOCHASTIC_NAME,
             'K7': hashgrid_cuda.STOCHASTIC_BWD_NAME,
             'K1': hashgrid_cuda.NAME, 'K2': hashgrid_cuda.BWD_NAME,
             'K1s': hashgrid_cuda.ATOMS_NAME,
             'K5': hashgrid_cuda.SELECT_NAME,
             'K2s': hashgrid_cuda.SAMPLED_BWD_NAME,
             'K3f': heads_cuda.HEADS, 'K3b': heads_cuda.HEADS_BWD,
             'K4f': heads_cuda.MLP3, 'K4b': heads_cuda.MLP3_BWD}
    launches, step_ms, mse, recorded, profiles = {}, {}, {}, {}, {}
    call = hashgrid_cuda._stochastic_call
    for key, (flags, steps) in CLI_STOCHASTIC.items():
        argv = [scene] + CLI_BASE + flags + full

        def workspace(name):
            return ['--workspace', os.path.join(root, name)]

        base = cli.main(argv + ['--iters', '1'] + workspace(f'{key}_base'))
        del base.trainer
        calls = [0]

        def rec_call(table, x, u, config, interp, n_samples, plan, rows,
                     key=key, steps=steps):
            if rows:
                calls[0] += 1
                if calls[0] == steps:
                    recorded[key] = (table.detach().clone(), x.clone(),
                                     config, interp, n_samples, plan)
            return call(table, x, u, config, interp, n_samples, plan, rows)

        hashgrid_cuda._stochastic_call = rec_call
        try:
            _kernels.reset_launches()
            run = cli.main(argv + ['--iters', str(steps)] + workspace(key))
            launches[key] = dict(_kernels.launches)
        finally:
            hashgrid_cuda._stochastic_call = call
        step_ms[key] = run.train_s * 1e3 / steps
        mse[key] = {'run': run.eval_mse, 'base': base.eval_mse}
        eval_key = 'K1' if key == 'D' else 'K1s'
        for name, want in (('K6', steps), ('K7', steps),
                           (eval_key, eval_chunks)):
            got = launches[key].get(names[name], 0)
            checks.true(f'cli {key} launches {name}', got == want,
                        f'{got} (expected {want}'
                        + (f': {eval_chunks} eval chunks)' if name == eval_key
                           else ': one a step)'))
        for name in names:
            if name not in ('K6', 'K7', eval_key):
                got = launches[key].get(names[name], 0)
                checks.true(f'cli {key} launches no {name}', got == 0,
                            f'{got}')
        checks.true(f'cli {key} eval mse falls 4-fold from 1 iteration',
                    np.isfinite(run.eval_mse)
                    and run.eval_mse * 4 < base.eval_mse,
                    f'{base.eval_mse:.5f} -> {run.eval_mse:.5f} (PSNR '
                    f'{_psnr(base.eval_mse):.2f} -> {_psnr(run.eval_mse):.2f}'
                    f' dB, {steps} steps)')
        print(f'cli {key} [{gpu}] {" ".join(flags)}: {steps} steps, ms per '
              f'step over the epoch\'s wall clock {step_ms[key]:.3f}')
        # the device's busy time by kernel over PROFILED_STEPS more steps
        # through the CLI's loader, and its share of their wall clock
        trainer, dataset, wall = run.trainer, run.dataset, []

        def loader_steps():
            loader = PrefetchIterator(LenDataset(dataset, PROFILED_STEPS),
                                      transform=trainer._device_batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for batch in loader:
                trainer.train_step(batch)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t1) * 1e3)

        loader_steps()
        rows, busy = _device_profile(loader_steps)
        if rows is None:
            print(f'cli {key} profile: the trace holds no device time: not '
                  'measured')
        else:
            profiles[key] = dict(busy_ms=busy, wall_ms=wall[-1],
                                 rows=rows[:12])
            print(f'cli {key} profile [{gpu}]: device busy {busy:.3f} ms over '
                  f'{PROFILED_STEPS} steps through the loader '
                  f'({busy / PROFILED_STEPS:.3f} a step) of their '
                  f'{wall[-1]:.3f} ms wall clock: busy share '
                  f'{busy / wall[-1]:.4f}')
            for name, ms, count in rows[:12]:
                print(f'  {ms:9.3f} ms {ms / busy:7.2%} x{count:<5d} '
                      f'{name[:90]}')
        del run, trainer, dataset
        torch.cuda.empty_cache()

    run_e = _cli_exact(gpu, checks, scene, root, names)

    # A few steps of Run C's command at 33 draws a level.
    flags, steps = CLI_MANY
    _kernels.reset_launches()
    run = cli.main([scene] + CLI_BASE + flags + ['--factor-train', '1',
                                                 '--iters', str(steps),
                                                 '--workspace',
                                                 os.path.join(root, 'many')])
    launches['many'] = dict(_kernels.launches)
    for name in names:
        want = steps if name in ('K6', 'K7') else 0
        got = launches['many'].get(names[name], 0)
        checks.true(f'cli {" ".join(flags)} launches {name}', got == want,
                    f'{got} (expected {want})')
    parts = run.trainer.train_step(run.trainer._device_batch(
        run.dataset._next_train()))
    checks.true(f'cli {" ".join(flags)} losses finite after {steps} steps',
                all(bool(torch.isfinite(v).all()) for v in parts.values()),
                ', '.join(f'{k} {float(v):.5f}' for k, v in parts.items()))
    del run, parts
    torch.cuda.empty_cache()

    # (a) K6 and K7 in every mode on each run's last recorded (table, x).
    gen = torch.Generator(device=dev).manual_seed(21)
    held, timed, unbiased = {}, {}, {}
    for key in CLI_STOCHASTIC:
        checks.true(f'cli {key} recorded the last step\'s K6 inputs',
                    key in recorded, f'{sorted(recorded)}')
        if key not in recorded:
            continue
        table, x_all, config, interp_run, n_run, plan_run = recorded.pop(key)
        modes, exact = STOCHASTIC_MODES[key]
        for n in STOCHASTIC_POINTS:
            x = x_all[:n].contiguous()
            for (interp, n_samples, residual), ex in itertools.product(
                    modes, exact):
                plan = hashgrid_cuda.encoders.stochastic_plan(
                    config, interp, n_samples, ex, residual)
                u = torch.rand(hashgrid_cuda.encoders.uniform_shape(
                    config.n_levels, n, interp, n_samples, residual),
                    generator=gen, device=dev)
                g = torch.randn((n, config.out_dim), generator=gen,
                                device=dev)
                failures, d = hashgrid_cuda.check_stochastic(
                    table, x, u, config, interp, n_samples, plan, g)
                tag = (f'{key} {"residual " if residual else ""}{interp} '
                       f'n_samples={n_samples} exact={ex} N={n}')
                checks.true(f'K6+K7 {tag}', not failures,
                            f'{d["flips"]} flips ({d["unexplained"]} '
                            f'unexplained); K6 max_abs_err '
                            f'{d["k6_max_abs_err"]:.3e}; K7 max_abs_err '
                            f'{d["k7_max_abs_err"]:.3e} (worst uses '
                            f'{d["k7_used"]:.3f} of its tolerance)'
                            + ('; ' + '; '.join(failures) if failures
                               else ''))
                held[tag] = {k: d[k] for k in (
                    'flips', 'unexplained', 'k6_max_abs_err',
                    'k7_max_abs_err', 'k7_used')}
                del d, u, g
        # more draws a level than a warp has lanes, in the run's own mode
        x = x_all[:STOCHASTIC_POINTS[0]].contiguous()
        exact_run = sum(k == hashgrid_cuda.encoders.EXACT
                        for k, _ in plan_run)
        for n_samples in STOCHASTIC_MANY:
            plan = hashgrid_cuda.encoders.stochastic_plan(
                config, interp_run, n_samples, exact_run)
            u = torch.rand(hashgrid_cuda.encoders.uniform_shape(
                config.n_levels, x.shape[0], interp_run, n_samples),
                generator=gen, device=dev)
            g = torch.randn((x.shape[0], config.out_dim), generator=gen,
                            device=dev)
            failures, d = hashgrid_cuda.check_stochastic(
                table, x, u, config, interp_run, n_samples, plan, g)
            tag = (f'{key} {interp_run} n_samples={n_samples} '
                   f'exact={exact_run} N={x.shape[0]}')
            checks.true(f'K6+K7 {tag}', not failures,
                        f'{d["flips"]} flips ({d["unexplained"]} '
                        f'unexplained); K6 max_abs_err '
                        f'{d["k6_max_abs_err"]:.3e}; K7 max_abs_err '
                        f'{d["k7_max_abs_err"]:.3e} (worst uses '
                        f'{d["k7_used"]:.3f} of its tolerance)'
                        + ('; ' + '; '.join(failures) if failures else ''))
            held[tag] = {k: d[k] for k in (
                'flips', 'unexplained', 'k6_max_abs_err', 'k7_max_abs_err',
                'k7_used')}
            del d, u, g
            torch.cuda.empty_cache()
        # the run's own mode at the CLI's N: times, bounds, shapes
        u_run = torch.rand(hashgrid_cuda.encoders.uniform_shape(
            config.n_levels, x_all.shape[0], interp_run, n_run),
            generator=gen, device=dev)
        timed[key] = _stochastic_measure(
            gpu, f'cli {key} step', table, x_all, u_run, config, interp_run,
            n_run, plan_run)
        for kernel, sh in hashgrid_cuda.stochastic_launch_shapes(
                config, x_all.shape[0], plan_run, interp_run,
                n_run).items():
            shapes[f'{kernel} ({key})'] = sh
            print(f'launch shape [{gpu}] {kernel} ({key}) N='
                  f'{x_all.shape[0]}: '
                  + ', '.join(f'{k} {v}' for k, v in sh.items()))
        # unbiasedness: 64 draws of K6 and K7 against the exact encode (K1s
        # or K1) and gradient (K2s exact or K2), in the norm, within 4
        # standard errors of the draws' own spread
        x = x_all[:STOCHASTIC_POINTS[0]].contiguous()
        t = table.clone().requires_grad_(True)
        g = torch.randn((x.shape[0], config.out_dim), generator=gen,
                        device=dev)
        with torch.no_grad():
            exact = hashgrid_cuda.hashgrid_encode(
                table, x, config, interp=interp_run).double()
        (exact_grad,) = torch.autograd.grad(hashgrid_cuda.hashgrid_encode(
            t, x, config, interp=interp_run), t, g)
        exact_grad = exact_grad.double()
        sums = [torch.zeros_like(exact), torch.zeros_like(exact),
                torch.zeros_like(exact_grad), torch.zeros_like(exact_grad)]
        for _ in range(UNBIASED_DRAWS):
            u = torch.rand(hashgrid_cuda.encoders.uniform_shape(
                config.n_levels, x.shape[0], interp_run, n_run),
                generator=gen, device=dev)
            out = hashgrid_cuda.hashgrid_encode(
                t, x, config, interp=interp_run, u=u, n_samples=n_run,
                exact_levels=sum(k == hashgrid_cuda.encoders.EXACT
                                 for k, _ in plan_run))
            (grad,) = torch.autograd.grad(out, t, g)
            for k, v in ((0, out.detach().double()), (2, grad.double())):
                sums[k] += v
                sums[k + 1] += v * v
        unbiased[key] = {}
        for k, kernel, want in ((0, 'K6', exact), (2, 'K7', exact_grad)):
            mean = sums[k] / UNBIASED_DRAWS
            var = (sums[k + 1] / UNBIASED_DRAWS - mean * mean).clamp(min=0) \
                * UNBIASED_DRAWS / (UNBIASED_DRAWS - 1)
            se = float(torch.sqrt(var.sum() / UNBIASED_DRAWS))
            bias = float((mean - want).norm())
            ratio = bias / max(se, 1e-30)
            unbiased[key][kernel] = ratio
            checks.true(f'{kernel} unbiased cli {key} N={x.shape[0]}',
                        ratio <= 4.0,
                        f'|mean of {UNBIASED_DRAWS} draws - exact| = '
                        f'{bias:.4e}, standard error {se:.4e}: ratio '
                        f'{ratio:.3f} (at most 4; |exact| '
                        f'{float(want.norm()):.4e})')
        del table, x_all, t, g, exact, exact_grad, sums
        torch.cuda.empty_cache()

    for kernel in ('K6', 'K7'):
        main = timed.get('C', {}).get(kernel)
        if main is None:
            continue
        errs = [v['k6_max_abs_err' if kernel == 'K6' else 'k7_max_abs_err']
                for v in held.values()]
        results[kernel] = dict(
            max_abs_err=max(errs) if errs else None, ms=main['ms'],
            plain_ms=main['plain_ms'], bound=main['bound'],
            library_ms=main['library_ms'], device_ms=main['device_ms'],
            device_split=main['device_split'],
            flips=sum(v['flips'] for v in held.values()),
            reference={k: v for k, v in timed.get('D', {}).get(
                kernel, {}).items() if k != 'device_split'},
            unbiased_ratio={k: v.get(kernel) for k, v in unbiased.items()})
        if kernel == 'K7':
            results[kernel]['library_device_ms'] = main['library_device_ms']
    print(f'stochastic phase: {time.perf_counter() - phase_start:.1f} s')
    return dict(launches=launches, ms_per_step=step_ms, eval_mse=mse,
                eval_chunks=eval_chunks, held=held, unbiased=unbiased,
                names=names, profiles=profiles, exact=run_e,
                window_probe={k: v['probe'] for k, v in timed.items()})


# The render CLI (phase 12): render.__main__.frames on phase 10's scene,
# 2 frames a path at the CLI's default 480 x 360 (every RENDER_STRIDE-th of
# the 16 test frames), on Run B's workspace (fused heads, proposal net,
# simplex) and, for K1, Run D's (reference preset, trilinear).
RENDER_STRIDE = 8
RENDER_PATHS = {'dense': ('B', []), 'proposal': ('B', ['--proposal']),
                'trilinear': ('D', ['--num-steps', '32']),
                'baked': ('B', ['--baked'])}
# The plain versions render the dense path in chunks of this many rays (the
# kernels' 16,384 a chunk at 512 samples a ray is 8,388,608 points, whose
# plain gathers would not fit the card); rays are independent.
PLAIN_RAY_BATCH = 2048
K8_SIZES = ((480, 360), (1280, 720))


def _semantic_flips(ours, ref):
    """Pixels whose class differs, and of them those whose reference's top
    two logits lie within the render limit (5e-2 of the largest |logit|)
    of each other, which a rounding can flip."""
    import numpy as np
    top2 = np.sort(ref, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 5e-2 * np.abs(ref).max()
    differ = ours.argmax(-1) != ref.argmax(-1)
    return int(differ.sum()), int((differ & ~near).sum())


def _render_cli_phase(dev, gpu, checks, results):
    """Phase 12 (see the module docstring). Adds K8 to `results`; returns
    what the output file keeps."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core.dataset import SceneDataset
    from autolabel_tpu_torch.ops import (_kernels, hashgrid_cuda, heads_cuda,
                                         splat_cuda)
    from autolabel_tpu_torch.render import __main__ as render_cli
    from autolabel_tpu_torch.render import baked as baked_module
    phase_start = time.perf_counter()
    scene = os.path.join(WORK_DIR, 'cli', 'sphere')

    def model_dir(run):
        base = os.path.join(WORK_DIR, 'cli' if run == 'B' else 'stochastic',
                            run.lower() if run == 'B' else run, 'sphere')
        (name,) = os.listdir(base)
        return os.path.join(base, name)

    names = {'K1': hashgrid_cuda.NAME, 'K1s': hashgrid_cuda.ATOMS_NAME,
             'K3f': heads_cuda.HEADS, 'K4f': heads_cuda.MLP3,
             'K8': splat_cuda.NAME}
    others = (hashgrid_cuda.BWD_NAME, hashgrid_cuda.SELECT_NAME,
              hashgrid_cuda.SAMPLED_BWD_NAME, hashgrid_cuda.STOCHASTIC_NAME,
              hashgrid_cuda.STOCHASTIC_BWD_NAME, heads_cuda.HEADS_BWD,
              heads_cuda.MLP3_BWD)
    testset = SceneDataset('test', scene, size=(FRAME_W, FRAME_H),
                           lazy=True, load_semantic=False)
    n_frames = len(testset.indices[::RENDER_STRIDE])
    chunks = -(-FRAME_W * FRAME_H // render_cli.MAX_RAY_BATCH)
    # the kernels each path's frames launch (K1s or K1 for the encode)
    expected = {'dense': {'K1s': chunks, 'K3f': chunks},
                'proposal': {'K1s': chunks, 'K3f': chunks, 'K4f': chunks},
                'trilinear': {'K1': chunks},
                'baked': {'K8': splat_cuda.launches_for(
                    baked_module.fill_passes_for(FRAME_W, 2))}}

    def run(path, plain, profile=False):
        """One run of frames(): tiles, the outputs render() made, each
        frame's ms, the launches (the bake's apart) and the peak memory;
        with `profile`, the second frame under torch.profiler instead of
        timed."""
        ws, extra = RENDER_PATHS[path]
        flags = render_cli.read_args(
            [scene, '--model-dir', model_dir(ws), '--out', os.devnull,
             '--stride', str(RENDER_STRIDE)] + extra)
        outputs, bake_info = [], {}
        compute, bake = render_cli.compute_semantics, baked_module.bake

        def record(out, classes, transform):
            outputs.append({k: out[k] for k in ('image', 'depth', 'semantic',
                                                'semantic_features')})
            return compute(out, classes, transform)

        def timed_bake(field, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scene_ = bake(field, **kwargs)
            torch.cuda.synchronize()
            bake_info.update(s=time.perf_counter() - t0, scene=scene_,
                             launches=dict(_kernels.launches),
                             queries=kwargs['resolution'] ** 3)
            return scene_

        saved = (render_cli.MAX_RAY_BATCH, splat_cuda.splat_render)
        render_cli.compute_semantics = record
        baked_module.bake = timed_bake
        plain_ctx = (_plain_kernels(hashgrid_cuda, heads_cuda) if plain
                     else contextlib.nullcontext())
        tiles, frame_ms, profiled = [], [], {}
        try:
            if plain:
                render_cli.MAX_RAY_BATCH = PLAIN_RAY_BATCH
                splat_cuda.splat_render = splat_cuda.splat_render_plain
            with plain_ctx:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_bytes = torch.cuda.memory_allocated()
                _kernels.reset_launches()
                gen = render_cli.frames(flags)
                while True:
                    t0 = time.perf_counter()
                    try:
                        if profile and len(tiles) == 1:
                            got = []
                            rows, busy = _device_profile(
                                lambda: got.append(next(gen)))
                            (_, tile), = got
                            profiled.update(rows=rows, busy_ms=busy)
                        else:
                            _, tile = next(gen)  # numpy: synchronised
                    except StopIteration:
                        break
                    frame_ms.append((time.perf_counter() - t0) * 1e3)
                    tiles.append(tile)
                launches = dict(_kernels.launches)
                peak = torch.cuda.max_memory_allocated()
        finally:
            render_cli.compute_semantics, baked_module.bake = compute, bake
            render_cli.MAX_RAY_BATCH, splat_cuda.splat_render = saved
        if 'launches' in bake_info:
            before = bake_info.pop('launches')
            bake_info['bake_launches'] = before
            launches = {k: v - before.get(k, 0) for k, v in launches.items()
                        if v - before.get(k, 0)}
        return dict(tiles=tiles, outputs=outputs, frame_ms=frame_ms,
                    launches=launches, peak_bytes=peak,
                    base_bytes=base_bytes, profiled=profiled, **bake_info)

    out = {}
    for path in RENDER_PATHS:
        # in turns: plain, kernels (counted, checked), kernels, plain
        turns = [run(path, True), run(path, False), run(path, False),
                 run(path, True), run(path, False, profile=True)]
        plain, ours = turns[0], turns[1]
        for i in (0, 3):
            # a swap that missed a call site would compare the kernels
            # with themselves: the plain runs launch nothing
            ran = {k: v for k, v in {**turns[i]['launches'],
                                     **turns[i].get('bake_launches', {})
                                     }.items() if v}
            checks.true(f'render cli {path} plain run {i} launches no '
                        'kernel', not ran, f'{ran}')
        launches = ours['launches']
        for key, per_frame in expected[path].items():
            want = per_frame * n_frames
            checks.true(f'render cli {path} launches {key}',
                        launches.get(names[key], 0) == want,
                        f'{launches.get(names[key], 0)} (expected {want}: '
                        f'{per_frame} a frame x {n_frames} frames)')
        stray = {k: v for k, v in launches.items()
                 if k not in {names[key] for key in expected[path]}}
        checks.true(f'render cli {path} launches no other kernel',
                    not stray and not any(launches.get(k) for k in others),
                    f'{stray}')
        checks.true(f'render cli {path} tiles',
                    len(ours['tiles']) == len(plain['tiles']) == n_frames
                    and all(t.shape == (720, 960, 3) and t.dtype == np.uint8
                            for t in ours['tiles']),
                    f'{len(ours["tiles"])} tiles')
        errors = {}
        for i, (a, b) in enumerate(zip(ours['outputs'], plain['outputs'])):
            for key in ('image', 'depth', 'semantic', 'semantic_features'):
                err = np.abs(a[key] - b[key])
                scale = 1.0 if key == 'image' else float(
                    np.abs(b[key]).max())
                mean, p999 = float(err.mean()), float(np.quantile(err, 0.999))
                errors[f'frame {i} {key}'] = dict(mean_abs=mean, p99_9=p999,
                                                  max=float(err.max()))
                checks.true(f'render cli {path} frame {i} {key} vs plain',
                            bool(np.isfinite(a[key]).all())
                            and mean < 5e-3 * scale and p999 < 5e-2 * scale,
                            f'mean_abs={mean:.3e} p99.9={p999:.3e} '
                            f'max={float(err.max()):.3e} (scale {scale:.3e})')
            differ, unexplained = _semantic_flips(a['semantic'],
                                                  b['semantic'])
            checks.true(f'render cli {path} frame {i} classes vs plain',
                        unexplained == 0, f'{differ} pixels differ, '
                        f'{unexplained} of them not at a near tie')
        for i, (a, b) in enumerate(zip(ours['tiles'], plain['tiles'])):
            d = np.abs(a[:360].astype(np.float64) - b[:360]) / 255.0
            mean, p999 = float(d.mean()), float(np.quantile(d, 0.999))
            checks.true(f'render cli {path} tile {i} rgb | depth vs plain',
                        mean < 5e-3 and p999 < 5e-2,
                        f'mean_abs={mean:.3e} p99.9={p999:.3e}')
            if path == 'baked':
                # K8's rules: depth and classes equal; the semantic and
                # depth quadrants of the tile therefore too
                checks.true(f'render cli baked tile {i} depth and semantic '
                            'quadrants equal to plain',
                            np.array_equal(a[:360, 480:], b[:360, 480:])
                            and np.array_equal(a[360:], b[360:]))
        frame_ms = {'plain': turns[0]['frame_ms'][1:]
                    + turns[3]['frame_ms'][1:],
                    'kernels': turns[1]['frame_ms'][1:]
                    + turns[2]['frame_ms'][1:]}
        prof = turns[4]['profiled']
        wall = float(np.median(frame_ms['kernels']))
        if prof.get('rows') is None:
            print(f'render cli {path} profile: the trace holds no device '
                  'time: not measured')
        else:
            print(f'render cli {path} profile [{gpu}]: device busy '
                  f'{prof["busy_ms"]:.3f} ms of a {wall:.3f} ms frame '
                  f'(median wall, unprofiled): busy share '
                  f'{prof["busy_ms"] / wall:.4f}')
            for name, ms, count in prof['rows'][:8]:
                print(f'  {ms:9.3f} ms {ms / prof["busy_ms"]:7.2%} '
                      f'x{count:<5d} {name[:90]}')
        out[path] = dict(launches=launches, errors=errors,
                         frame_ms=frame_ms, profile=prof,
                         first_frame_ms={'kernels': ours['frame_ms'][0],
                                         'plain': plain['frame_ms'][0]},
                         peak_bytes=ours['peak_bytes'],
                         base_bytes=ours['base_bytes'],
                         plain_peak_bytes=plain['peak_bytes'])
        print(f'render cli {path} [{gpu}]: ms a frame (the second of each '
              f'run; in turns) kernels '
              f'{[round(v, 3) for v in frame_ms["kernels"]]}, plain '
              f'{[round(v, 3) for v in frame_ms["plain"]]}; first frame '
              f'{ours["frame_ms"][0]:.1f} ms; peak memory '
              f'{ours["peak_bytes"] / 1e9:.3f} GB allocated ('
              f'{ours["base_bytes"] / 1e9:.3f} before the run; plain '
              f'{plain["peak_bytes"] / 1e9:.3f} at {PLAIN_RAY_BATCH} rays a '
              'chunk)')
        if path == 'baked':
            scene_k, scene_p = ours['scene'], plain['scene']
            same = (scene_k.n_valid == scene_p.n_valid
                    and torch.equal(scene_k.points, scene_p.points))
            checks.true('render cli baked: the bake through the kernels '
                        'keeps the plain bake\'s cells', same,
                        f'{scene_k.n_valid} and {scene_p.n_valid} splats')
            rgb_err = float((scene_k.rgb - scene_p.rgb).abs().max())
            bake_k1s = ours['bake_launches'].get(names['K1s'], 0)
            chunk = 65536
            want = -(-ours['queries'] // chunk) + -(-scene_k.n_valid // chunk)
            checks.true('render cli baked: the bake\'s K1s launches',
                        bake_k1s == want,
                        f'{bake_k1s} (expected {want}: the density sweep\'s '
                        'chunks and the shading chunks)')
            out[path].update(bake_s=ours['s'], plain_bake_s=plain['s'],
                             bake_queries=ours['queries'],
                             splats=scene_k.n_valid, bake_rgb_err=rgb_err,
                             bake_launches=ours['bake_launches'])
            print(f'render cli bake [{gpu}]: {ours["queries"]} density '
                  f'queries, {scene_k.n_valid} splats, {ours["s"]:.3f} s '
                  f'(plain {plain["s"]:.3f} s); shading max |kernels - '
                  f'plain| {rgb_err:.3e}')
            out[path]['k8'] = _k8_measure(dev, gpu, checks, results,
                                          scene_k, testset)
        del turns, plain, ours
        torch.cuda.empty_cache()
    print(f'render cli phase: {time.perf_counter() - phase_start:.1f} s')
    return dict(paths=out, names=names, frames=n_frames, chunks=chunks)


def _k8_host_us(fn, reps=50):
    """The wrapper's host time a call: perf_counter around the enqueue, the
    device drained before each call and no synchronise inside; the median
    of reps calls, in microseconds."""
    import numpy as np
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def _k8_parts(device):
    """K8's device ms by part from a trace's kernels: the tiled fill (the
    resolve and every pass), and the scatter stage (the memset, project,
    winners)."""
    if device is None:
        return None, None
    fill = sum(ms for name, ms in device.items() if 'fill_kernel' in name)
    return fill, sum(device.values()) - fill


def _k8_time(gpu, tag, scene_args, K, T, h, w, cell, plain_reps=5):
    """K8 on one frame by events and by device time (split into the fill
    and the scatter stage), its wrapper's host time, beside the frame's
    count-once byte bound (splat_cuda.bound_bytes), the plain version,
    and the three scatter_reduce_ calls of the scatter stage. The earlier
    count of the bound, which also charged the passes' state (6 words a
    pixel read and written a pass), is printed beside it."""
    from autolabel_tpu_torch.ops import splat_cuda
    from autolabel_tpu_torch.render.baked import fill_passes_for
    passes = fill_passes_for(w, 2)
    frame = lambda: splat_cuda.splat_render(*scene_args, K, T, h, w, passes,
                                            cell)
    plain = lambda: splat_cuda.splat_render_plain(*scene_args, K, T, h, w,
                                                  passes, cell)
    n = h * w
    nbytes, data = splat_cuda.bound_bytes(*scene_args, K, T, h, w)
    bound = _bound(nbytes, 0, PEAK_FP32)
    state_bound = _bound(data['splat_bytes'] + passes * n * 6 * 4 * 2, 0,
                        PEAK_FP32)
    points, rgb, sh, semantic, valid = scene_args
    z, _, _, pid, ok, shaded = splat_cuda.project_plain(
        points, rgb, sh, valid, K, T, h, w)
    # scatter_plain: the three scatter_reduce_ calls (amin, sum, amax)
    # with the gather and casts between them
    library = lambda: splat_cuda.scatter_plain(z, pid, ok, shaded, semantic,
                                               n)
    out = dict(ms=_cuda_ms(frame, 50), plain_ms=_cuda_ms(plain, plain_reps),
               library_ms=_cuda_ms(library, 50), host_us=_k8_host_us(frame))
    device = _kernel_ms(frame)
    library_device = _kernel_ms(library)
    total = lambda d: None if d is None else sum(d.values())
    fill, scatter = _k8_parts(device)
    out.update(device_ms=total(device), device_split=device,
               fill_device_ms=fill, scatter_device_ms=scatter,
               library_device_ms=total(library_device), bound=bound,
               state_bound_ms=state_bound[0], passes=passes, **data)
    share = lambda ms, b: 'not measured' if ms is None else f'{b / ms:.1%}'
    print(f'kernel K8 [{gpu}] {tag}: {points.shape[0]} splats '
          f'({data["n_valid"]} valid, {data["winners"]} winners) {w}x{h}, '
          f'{passes} passes, {splat_cuda.launches_for(passes)} launches: '
          f'{out["ms"]:.4f} ms by events, {out["device_ms"]} ms device '
          f'(fill {fill}, scatter stage {scatter}; {device}), wrapper host '
          f'{out["host_us"]:.1f} us; plain {out["plain_ms"]:.4f} ms; bound '
          f'{bound[0]:.4f} ms ({bound[1]}: {data["splat_bytes"]} splat '
          f'bytes, {data["pixel_bytes"]} output bytes, each once; '
          f'{share(out["device_ms"], bound[0])} of it by device time; the '
          f'earlier count with the passes\' state {state_bound[0]:.4f} ms); '
          f'three scatter_reduce_ calls '
          f'{out["library_ms"]:.4f} ms by events, '
          f'{out["library_device_ms"]} ms device')
    return out


def _full_cloud(dev, K, T, w, h, k, ties, z_range):
    """k splats, every one valid, spread over the frame of camera (K, T)
    at depths in z_range: a full cloud at the CLI's --max-splats, about 3
    splats a pixel at 480 x 360; with `ties` every splat is repeated 3
    times, so most pixels hold tied winners. Colours, SH and classes (6)
    random, from a seed."""
    import numpy as np
    import torch
    g = torch.Generator(device=dev).manual_seed(13 + ties)
    m = -(-k // 3) if ties else k
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    u, v = rand(m) * (w - 1), rand(m) * (h - 1)
    z = z_range[0] + rand(m) * (z_range[1] - z_range[0])
    cam = torch.stack([(u - float(K[0, 2])) * z / float(K[0, 0]),
                       (v - float(K[1, 2])) * z / float(K[1, 1]), z], 1)
    R = torch.tensor(np.asarray(T)[:3, :3], dtype=torch.float32, device=dev)
    t = torch.tensor(np.asarray(T)[:3, 3], dtype=torch.float32, device=dev)
    points = (cam - t) @ R  # R^T (cam - t), row-wise
    if ties:
        points = points.repeat_interleave(3, dim=0)[:k]
    points = points.contiguous()
    return (points, rand(k, 3),
            torch.randn(k, 3, 3, generator=g, device=dev) * 0.3,
            torch.randint(0, 6, (k,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.ones(k, dtype=torch.bool, device=dev))


# What the kernels line and the output file keep of a K8 timing.
K8_KEYS = ('ms', 'device_ms', 'device_split', 'fill_device_ms',
           'scatter_device_ms', 'host_us', 'bound',
           'state_bound_ms', 'library_ms', 'library_device_ms', 'plain_ms',
           'winners', 'n_valid', 'passes')


def _k8_hold(checks, tag, args, K, T, w, h, cell):
    """K8 held against its plain version by check_splat's rules at
    BakedRenderer's passes for the width."""
    from autolabel_tpu_torch.ops import splat_cuda
    from autolabel_tpu_torch.render.baked import fill_passes_for
    r = splat_cuda.check_splat(*args, K, T, h, w, fill_passes_for(w, 2), cell)
    checks.true(f'K8 {tag} vs plain', r['ok'],
                f'{r["in_frame"]} splats in the frame, '
                f'{r["boundary"]} within 2 ulp of a .5 boundary, '
                f'{r["flips"]} flips ({r["flips_off_boundary"]} '
                f'off it), {r["ties"]} tied pixels (most '
                f'{r["max_count"]}), image max_abs_err '
                f'{r["max_abs_err"]:.3e}; depth, classes, splat_hit equal: '
                f'{r["depth_equal"]}, {r["classes_equal"]}, '
                f'{r["splat_hit_equal"]}')
    return r


def _k8_measure(dev, gpu, checks, results, scene, testset):
    """K8 held alone against its plain version by check_splat's rules, on
    the baked scene and on a second scene of the same splats without SH
    (each class its colour), at 480 x 360 and 1280 x 720 from the test
    frames' cameras; then timed on the baked scene at 480 x 360 (_k8_time),
    and held and timed on two full clouds of the bake's max_points, every
    splat valid, at the baked splats' depths: one of distinct splats and
    one of every splat three times (tied winners)."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.ops import splat_cuda
    b = scene
    flat_rgb = torch.rand(b.rgb.shape, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    scenes = {'baked': (b.points, b.rgb, b.sh, b.semantic, b.valid),
              'no sh': (b.points, flat_rgb, None, b.semantic, b.valid)}

    def hold(tag, args, K, T, w, h):
        return _k8_hold(checks, tag, args, K, T, w, h, b.cell_size)

    held = {}
    for name, args in scenes.items():
        for w, h in K8_SIZES:
            camera = testset.camera.scale((w, h))
            for index in testset.indices[::RENDER_STRIDE]:
                T = np.linalg.inv(testset.poses[index])
                tag = f'{name} {w}x{h} frame {index}'
                held[tag] = hold(tag, args, camera.camera_matrix, T, w, h)
    # timing at the CLI's frame on the first test camera
    w, h = FRAME_W, FRAME_H
    K = testset.camera.scale((w, h)).camera_matrix
    T = np.linalg.inv(testset.poses[0])
    out = _k8_time(gpu, 'baked scene', scenes['baked'], K, T, h, w,
                   b.cell_size)
    z, _, _, _, ok, _ = splat_cuda.project_plain(
        b.points, b.rgb, b.sh, b.valid, K, T, h, w)
    z_range = (float(z[ok].min()), float(z[ok].max()))
    full = {}
    for ties in (False, True):
        tag = 'full cloud' + (', tied' if ties else '')
        args = _full_cloud(dev, K, T, w, h, b.points.shape[0], ties, z_range)
        full[tag] = _k8_time(gpu, tag, args, K, T, h, w, b.cell_size,
                             plain_reps=3)
        r = held[f'{tag} {w}x{h} frame 0'] = hold(
            f'{tag} {w}x{h} frame 0', args, K, T, w, h)
        full[tag].update(ties=r['ties'], max_count=r['max_count'],
                         in_frame=r['in_frame'])
        checks.true(f'K8 {tag}: every splat valid, tied winners '
                    f'{"present" if ties else "counted"}',
                    full[tag]['n_valid'] == b.points.shape[0]
                    and (r['ties'] > 0 or not ties),
                    f'{full[tag]["n_valid"]} valid, {r["ties"]} tied pixels')
        del args
    results['K8'] = dict(
        max_abs_err=max(r['max_abs_err'] for r in held.values()),
        **{k: out[k] for k in K8_KEYS},
        boundary=sum(r['boundary'] for r in held.values()),
        flips=sum(r['flips'] for r in held.values()),
        ties=sum(r['ties'] for r in held.values()),
        full_cloud={tag: {k: v[k] for k in K8_KEYS + ('ties',)}
                    for tag, v in full.items()})
    return dict(held=held, baked=out, full=full)


# The interactive preview (phase 13): benchmarks/preview_fps.py at its
# defaults, the configuration the GUI backend serves frames from
# (autolabel_tpu/backend.py:169-190): the flagship field baked at 128^3
# into 2^18 splats, 1280 x 720 frames (8 fill passes), 30 orbit poses.
PREVIEW_SIZE = (1280, 720)
PREVIEW_RESOLUTION, PREVIEW_SPLATS = 128, 2 ** 18
PREVIEW_FRAMES, PREVIEW_GOVERNED = 30, 90
PREVIEW_BLOCKS = 4  # IncrementalBaker blocks timed after its cold start


def _preview_pose(i, frames):
    """preview_fps.py's orbit camera i of `frames`: radius 2.5, height 1,
    looking at the origin; its world -> camera transform."""
    import numpy as np
    angle = 2 * np.pi * i / frames
    pos = np.array([2.5 * np.cos(angle), 2.5 * np.sin(angle), 1.0])
    T_WC = np.eye(4)
    T_WC[:3, :3], T_WC[:3, 3] = _look_at(pos), pos
    return np.linalg.inv(T_WC)


def _preview_phase(dev, seed, gpu, checks, results):
    """Phase 13 (see the module docstring). Adds the preview's timing to
    K8's `results`; returns what the output file keeps."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.models.field import Field, FieldConfig
    from autolabel_tpu_torch.ops import _kernels, splat_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.baked import (BakedRenderer,
                                                  GovernedPreviewRenderer,
                                                  IncrementalBaker, bake,
                                                  fill_passes_for)
    phase_start = time.perf_counter()
    field = Field(FieldConfig(encoding='hg+freq', hidden_dim=128,
                              hidden_dim_color=128, hidden_dim_semantic=64,
                              semantic_classes=6, bound=2.0, grid=TPU_GRID,
                              proposal=True),
                  device=dev, generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = bake(field, resolution=PREVIEW_RESOLUTION,
                 max_points=PREVIEW_SPLATS, alpha_threshold=0.0,
                 view_dependent=True)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    checks.true('preview bake fills the splat budget',
                scene.n_valid == PREVIEW_SPLATS,
                f'{scene.n_valid} valid of {PREVIEW_SPLATS}')
    w, h = PREVIEW_SIZE
    focal = 0.9 * w
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    poses = [_preview_pose(i, PREVIEW_FRAMES) for i in range(PREVIEW_FRAMES)]
    passes = fill_passes_for(w, 2)
    # the fixed budget: BakedRenderer over every splat, fenced by one
    # fetch as preview_fps.py does, after a first frame and fetch
    renderer = BakedRenderer(scene)
    out = renderer.render(K, poses[0], (w, h))
    float(out['depth'].sum())
    _kernels.reset_launches()
    start = time.perf_counter()
    for pose in poses:
        out = renderer.render(K, pose, (w, h))
    float(out['depth'].sum())
    fixed_ms = (time.perf_counter() - start) / PREVIEW_FRAMES * 1e3
    launches = dict(_kernels.launches)
    want = PREVIEW_FRAMES * splat_cuda.launches_for(passes)
    checks.true('preview launches K8', launches == {splat_cuda.NAME: want},
                f'{launches} (expected {want}: {PREVIEW_FRAMES} frames x '
                f'{splat_cuda.launches_for(passes)}, no other kernel)')
    image, depth, sem = out['image'], out['depth'], out['semantic']
    checks.true('preview frame', image.shape == (h, w, 3)
                and bool(torch.isfinite(image).all())
                and float(image.min()) >= 0 and float(image.max()) <= 1
                and float(depth.min()) >= 0 and int(sem.min()) >= 0
                and int(sem.max()) < 6 and bool(out['splat_hit'].any()),
                f'{int(out["splat_hit"].sum())} pixels hit, '
                f'{int((depth > 0).sum())} covered after the passes')
    rows, busy = _device_profile(lambda: renderer.render(K, poses[1],
                                                         (w, h)))
    # the governor at 30 fps over 90 frames after its warm-up, fenced
    governed = GovernedPreviewRenderer(scene, target_fps=30.0)
    governed.warmup(K, (w, h))
    _kernels.reset_launches()
    start = time.perf_counter()
    for i in range(PREVIEW_GOVERNED):
        out = governed.render(K, poses[i % PREVIEW_FRAMES], (w, h))
    float(out['depth'].sum())
    governed_s = time.perf_counter() - start
    governed_launches = dict(_kernels.launches)
    # the backend's slab refresh: one block after the cold start's sweep
    baker = IncrementalBaker(field, resolution=PREVIEW_RESOLUTION,
                             max_points=PREVIEW_SPLATS, view_dependent=True)
    t0 = time.perf_counter()
    baker.update_next_block()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(PREVIEW_BLOCKS):
        baker.update_next_block()
    torch.cuda.synchronize()
    block_s = (time.perf_counter() - t0) / PREVIEW_BLOCKS
    args = (scene.points, scene.rgb, scene.sh, scene.semantic, scene.valid)
    held = {f'preview {w}x{h} pose {i}': _k8_hold(
        checks, f'preview {w}x{h} pose {i}', args, K, poses[i], w, h,
        scene.cell_size) for i in (0, PREVIEW_FRAMES // 2)}
    timed = _k8_time(gpu, f'preview {w}x{h}', args, K, poses[0], h, w,
                     scene.cell_size, plain_reps=3)
    fps = PREVIEW_GOVERNED / governed_s
    print(f'preview [{gpu}]: bake {bake_s:.3f} s ({PREVIEW_RESOLUTION}^3, '
          f'{scene.n_valid} splats); fixed budget {fixed_ms:.4f} ms a frame '
          f'({1e3 / fixed_ms:.1f} fps, {PREVIEW_FRAMES} frames, one fence); '
          f'governed at 30 fps: {fps:.2f} fps over {PREVIEW_GOVERNED} '
          f'frames, level {governed.level}, launches {governed_launches}; '
          f'IncrementalBaker block refresh {block_s:.4f} s (cold start '
          f'{cold_s:.3f} s, {baker.n_blocks} blocks)')
    if rows is None:
        print('preview profile: the trace holds no device time: not measured')
    else:
        print(f'preview profile [{gpu}]: device busy {busy:.4f} ms of a '
              f'{fixed_ms:.4f} ms frame: busy share {busy / fixed_ms:.4f}')
        for name, ms, count in rows[:8]:
            print(f'  {ms:9.4f} ms {ms / busy:7.2%} x{count:<5d} {name[:90]}')
    k8 = results['K8']
    results['K8'] = dict(
        {k: timed[k] for k in K8_KEYS},
        max_abs_err=max([k8['max_abs_err']]
                        + [r['max_abs_err'] for r in held.values()]),
        boundary=k8['boundary'] + sum(r['boundary'] for r in held.values()),
        flips=k8['flips'] + sum(r['flips'] for r in held.values()),
        ties=k8['ties'] + sum(r['ties'] for r in held.values()),
        render_cli=k8)
    return dict(launches=launches, governed_launches=governed_launches,
                bake_s=bake_s, splats=scene.n_valid, fixed_ms=fixed_ms,
                governed_fps=fps, governed_level=governed.level,
                block_s=block_s, cold_start_s=cold_s, profile=rows,
                busy_ms=busy, held=held, k8=timed)


# Evaluation (phase 14): the sphere scene again at ScanNet's frame scale
# (the CLIs evaluate at factor 4: 320 x 240), with labelme masks, gt
# semantic maps and a mesh of ScanNet-mesh scale (6 chunks of the 3D query).
EVAL_SCENE = dict(n_frames=16, width=1280, height=960)
EVAL_MESH_POINTS = 262144
EVAL_CHUNK = 50000  # InferenceModel's chunk of the 3D query
EVAL_BATCH = 8182  # the evaluation CLIs' default --batch-size
JITTER_SAMPLES, JITTER_SIGMA = 10, 0.02
LABEL_MAP = 'id,prompt\n1,background\n2,sphere|ball\n'
# The reference checkpoint: the reference's hg+freq model (16 levels of up
# to 2^19 rows of 2 features on the tcnn lattice), at phase 5's cameras.
REFERENCE_CLASSES = 2
REFERENCE_N = 524288
REFERENCE_REPEATS = 3  # warm repeats of the reference checkpoint's render


@contextlib.contextmanager
def _recording(model_class, keys, profile_at=None):
    """Record every InferenceModel.render of the block: the outputs' `keys`
    and the frame's ms (render returns numpy arrays: synchronised). The
    render of index `profile_at` is traced instead of timed: its device
    time by kernel goes into the third dict ('rows', 'busy_ms')."""
    outputs, frame_ms, profile = [], [], {}
    render = model_class.render

    def wrapped(self, batch):
        if len(outputs) == profile_at:
            out = []
            profile['rows'], profile['busy_ms'] = _device_profile(
                lambda: out.append(render(self, batch)))
            out = out[0]
        else:
            t0 = time.perf_counter()
            out = render(self, batch)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append({k: out[k] for k in keys})
        return out

    model_class.render = wrapped
    try:
        yield outputs, frame_ms, profile
    finally:
        model_class.render = render


def _print_profile(gpu, tag, rows, busy, wall_ms, unit):
    """A traced call's device busy time against the untraced `wall_ms` of
    one `unit`, and its top kernels. Returns the busy share, or None when
    the trace holds no device time."""
    if rows is None:
        print(f'{tag} profile: the trace holds no device time: not measured')
        return None
    share = busy / wall_ms
    print(f'{tag} profile [{gpu}]: one {unit} device busy {busy:.3f} ms of '
          f'a {wall_ms:.3f} ms {unit}: busy share {share:.4f}')
    for name, ms, count in rows[:8]:
        print(f'  {ms:9.3f} ms {ms / busy:7.2%} x{count:<5d} {name[:90]}')
    return share


def _hold_maps(checks, tag, ours, ref, keys):
    """Phase 6's limits on each map (mean |d| < 5e-3, 99.9th percentile <
    5e-2 of the largest |ref|, 1 for the image); the classes equal but at
    near ties of the logits. Returns the errors."""
    import numpy as np
    errors = {}
    for key in keys:
        err = np.abs(ours[key] - ref[key])
        scale = 1.0 if key == 'image' else float(np.abs(ref[key]).max())
        mean, p999 = float(err.mean()), float(np.quantile(err, 0.999))
        errors[key] = dict(mean_abs=mean, p99_9=p999, max=float(err.max()))
        checks.true(f'{tag} {key} vs plain',
                    bool(np.isfinite(ours[key]).all())
                    and mean < 5e-3 * scale and p999 < 5e-2 * scale,
                    f'mean_abs={mean:.3e} p99.9={p999:.3e} '
                    f'max={float(err.max()):.3e} (scale {scale:.3e})')
    if 'semantic' in keys:
        differ, unexplained = _semantic_flips(ours['semantic'],
                                              ref['semantic'])
        checks.true(f'{tag} classes vs plain', unexplained == 0,
                    f'{differ} differ, {unexplained} of them not at a near '
                    'tie')
        errors['class_flips'] = differ
    return errors


def _eval_phase(dev, seed, gpu, checks, results):
    """Phase 14 (see the module docstring). Adds K1's tcnn hold and the 3D
    query's times to `results`; returns what the output file keeps."""
    import dataclasses
    import shutil
    import types

    import numpy as np
    import torch
    from autolabel_tpu_torch import bridge, evaluation, model_utils
    from autolabel_tpu_torch import evaluate as eval_cli
    from autolabel_tpu_torch import inference, torch_export
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.language import evaluate as language_cli
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.ops.encoders import HashGridConfig
    from autolabel_tpu_torch.train import checkpoints
    from autolabel_tpu_torch.utils import Scene, fixtures
    phase_start = time.perf_counter()
    root = os.path.join(WORK_DIR, 'eval')
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, 'sphere')
    t0 = time.perf_counter()
    fixtures.make_synthetic_scene(scene, annotate=True,
                                  mesh_points=EVAL_MESH_POINTS, **EVAL_SCENE)
    scene_s = time.perf_counter() - t0
    with open(os.path.join(scene, 'bbox.txt')) as a, open(os.path.join(
            WORK_DIR, 'cli', 'sphere', 'bbox.txt')) as b:
        checks.true('eval scene: the bbox of phase 10\'s scene',
                    a.read() == b.read())
    names = {'K1': hashgrid_cuda.NAME, 'K1s': hashgrid_cuda.ATOMS_NAME,
             'K3f': heads_cuda.HEADS}
    width, height = EVAL_SCENE['width'] // 4, EVAL_SCENE['height'] // 4
    chunks = -(-width * height // EVAL_BATCH)
    n_masks = len(os.listdir(os.path.join(scene, 'gt_masks')))
    n_frames = EVAL_SCENE['n_frames']
    model_class = inference.InferenceModel

    def expect(tag, launches, want):
        """`launches` are `want` exactly: no other kernel."""
        got = {k: v for k, v in launches.items() if v}
        want = {names[k]: v for k, v in want.items()}
        checks.true(f'{tag} launches', got == want,
                    f'{got} (expected {want})')

    # (b) the closed set on Run B's workspace (K1s eval form and K3f), in
    # turns with the plain versions
    run_b = os.path.join(WORK_DIR, 'cli', 'b')
    per_class = []
    workspace = eval_cli.evaluate_workspace

    def evaluate_recorded(*args):
        params, ious = workspace(*args)
        per_class.append(ious)
        return params, ious

    def closed(plain, profile_at=None):
        ctx = (_plain_kernels(hashgrid_cuda, heads_cuda) if plain
               else contextlib.nullcontext())
        eval_cli.evaluate_workspace = evaluate_recorded
        try:
            with ctx, _recording(model_class, ('semantic',),
                                 profile_at) as (outs, ms, profile):
                torch.cuda.synchronize()
                _kernels.reset_launches()
                t0 = time.perf_counter()
                run = eval_cli.main([scene, '--workspace', run_b], dev)
                wall = time.perf_counter() - t0
                launches = dict(_kernels.launches)
        finally:
            eval_cli.evaluate_workspace = workspace
        return dict(run=run, outputs=outs, frame_ms=ms, wall_s=wall,
                    launches=launches, profile=profile)

    # the second kernels turn traces its second frame
    turns = [closed(True), closed(False), closed(False, 1), closed(True)]
    for i, turn in enumerate(turns):
        checks.true(f'eval closed run {i}: one model scored',
                    len(turn['run'].json_entries) == 1
                    and len(turn['outputs']) == n_masks,
                    f'{len(turn["run"].json_entries)} entries, '
                    f'{len(turn["outputs"])} frames of {n_masks} masks')
    for i in (0, 3):
        ran = {k: v for k, v in turns[i]['launches'].items() if v}
        checks.true(f'eval closed plain run {i} launches no kernel', not ran,
                    f'{ran}')
    closed_launches = turns[1]['launches']
    expect('eval closed', closed_launches,
           {'K1s': n_masks * chunks, 'K3f': n_masks * chunks})
    closed_errors = [_hold_maps(checks, f'eval closed frame {i}', a, b,
                                ('semantic',))
                     for i, (a, b) in enumerate(zip(turns[1]['outputs'],
                                                    turns[0]['outputs']))]
    miou = turns[1]['run'].json_entries[0]['iou']
    ious = per_class[1]
    checks.true('eval closed IoU', all(0.0 <= v <= 1.0 for v in
                                       ious.values()) and sorted(ious) == [1],
                f'{ious}')
    closed_ms = {'kernels': turns[1]['frame_ms'] + turns[2]['frame_ms'],
                 'plain': turns[0]['frame_ms'] + turns[3]['frame_ms']}
    print(f'eval closed [{gpu}]: {n_masks} frames of {width}x{height}, '
          f'{chunks} chunks of {EVAL_BATCH} rays a frame; per-class IoU '
          f'{ious} (plain {per_class[0]}), mIoU {miou:.6f}; ms per evaluated '
          f'frame (in turns) kernels '
          f'{[round(v, 3) for v in closed_ms["kernels"]]}, plain '
          f'{[round(v, 3) for v in closed_ms["plain"]]}; the CLI\'s wall '
          f'{[round(t["wall_s"], 3) for t in turns]} s')
    closed_profile = turns[2]['profile']
    closed_share = _print_profile(
        gpu, 'eval closed', closed_profile['rows'],
        closed_profile['busy_ms'], float(np.median(closed_ms['kernels'])),
        'frame')
    del turns
    torch.cuda.empty_cache()

    # (c) open vocabulary: a --features lseg --feature-dim 512 workspace of
    # seeded full-width weights with the 606-class head
    flags = model_utils.model_flag_parser().parse_args(
        ['--features', 'lseg', '--feature-dim', '512'])
    bbox = np.loadtxt(os.path.join(scene, 'bbox.txt'))
    gen = torch.Generator().manual_seed(seed + 14)
    field = model_utils.create_model(bbox[:3], bbox[3:6],
                                     language_cli.SCANNET_N_CLASSES, flags,
                                     device=dev, generator=gen)
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=gen) * 0.5)
    language_root = os.path.join(root, 'language')
    language_ws = os.path.join(language_root, 'sphere',
                               model_utils.model_hash(flags))
    tree = bridge.params_to_numpy(field)
    checkpoints.save_checkpoint(os.path.join(language_ws, 'checkpoints',
                                             'best.pth'),
                                {'params': tree, 'ema': tree, 'step': 0},
                                include_optimizer=False)
    model_utils.write_params(language_ws, flags)
    label_map = os.path.join(root, 'label_map.csv')
    with open(label_map, 'w') as f:
        f.write(LABEL_MAP)
    del field, tree
    language_out = {}
    language_launches = {}
    for leg, extra in (('2d', []), ('3d', ['--pc'])):
        out = os.path.join(root, f'language_{leg}.json')
        # the 2D leg traces its second frame
        with _recording(model_class, (), 1 if leg == '2d' else None) as (
                _, ms, profile):
            torch.cuda.synchronize()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            language_cli.main([scene, '--workspace', language_root,
                               '--label-map', label_map, '--allow-fallback',
                               '--out', out] + extra, dev)
            wall = time.perf_counter() - t0
            language_launches[leg] = dict(_kernels.launches)
        with open(out) as f:
            scores = json.load(f)
        values = [v for record in scores['iou'] + scores['acc']
                  for v in record.values()]
        checks.true(f'eval language {leg} scores',
                    len(scores['iou']) == 1 and 'sphere' in scores['iou'][0]
                    and all(v is None or 0.0 <= v <= 1.0 for v in values),
                    f'{scores}')
        language_out[leg] = dict(scores=scores, wall_s=wall, frame_ms=ms)
        print(f'eval language {leg} [{gpu}]: {scores}; {wall:.3f} s'
              + (f'; ms a frame {[round(v, 3) for v in ms]}' if ms else ''))
        if profile:
            language_out[leg].update(profile)
            language_out[leg]['busy_share'] = _print_profile(
                gpu, f'eval language {leg}', profile['rows'],
                profile['busy_ms'], float(np.median(ms)), 'frame')
    n_chunks = 1 + -(-(EVAL_MESH_POINTS - EVAL_CHUNK) // EVAL_CHUNK)
    expect('eval language 2d', language_launches['2d'],
           {'K1s': n_frames * chunks})
    expect('eval language 3d', language_launches['3d'],
           {'K1s': n_chunks * JITTER_SAMPLES})

    # the 3D query alone, in turns with the plain versions (the same seeds,
    # so the same jitter on the card)
    served = model_utils.create_model(bbox[:3], bbox[3:6],
                                      language_cli.SCANNET_N_CLASSES, flags,
                                      device=dev)
    model = model_class.from_checkpoint(served, language_ws)
    evaluator = evaluation.OpenVocabEvaluator3D(features='lseg',
                                                allow_fallback=True)
    evaluator.reset(model, language_cli.read_label_map(label_map))
    points, _ = evaluator._read_gt_pointcloud(
        types.SimpleNamespace(scene=Scene(scene)))

    def query(plain):
        ctx = (_plain_kernels(hashgrid_cuda, heads_cuda) if plain
               else contextlib.nullcontext())
        with ctx:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            feats = np.concatenate([
                model.jittered_semantic_features(
                    points[:EVAL_CHUNK], JITTER_SAMPLES, JITTER_SIGMA,
                    seed=0),
                model.jittered_semantic_features(
                    points[EVAL_CHUNK:], JITTER_SAMPLES, JITTER_SIGMA,
                    seed=1)])
            s = time.perf_counter() - t0
            return dict(features=feats, s=s, launches=dict(_kernels.launches),
                        peak_bytes=torch.cuda.max_memory_allocated() - base)

    q = [query(True), query(False), query(False), query(True)]
    for i in (0, 3):
        ran = {k: v for k, v in q[i]['launches'].items() if v}
        checks.true(f'eval 3d query plain run {i} launches no kernel',
                    not ran, f'{ran}')
    expect('eval 3d query', q[1]['launches'],
           {'K1s': n_chunks * JITTER_SAMPLES})
    feats, plain_feats = q[1]['features'], q[0]['features']
    checks.true('eval 3d query features', feats.shape == (
        EVAL_MESH_POINTS, 512) and bool(np.isfinite(feats).all()),
        f'{feats.shape}')
    text = evaluator.text_features[:, :feats.shape[-1]]
    query_errors = _hold_maps(checks, 'eval 3d query',
                              {'semantic_features': feats,
                               'semantic': feats @ text.T},
                              {'semantic_features': plain_feats,
                               'semantic': plain_feats @ text.T},
                              ('semantic_features', 'semantic'))
    query_ms = {'kernels': [t['s'] * 1e3 / n_chunks for t in (q[1], q[2])],
                'plain': [t['s'] * 1e3 / n_chunks for t in (q[0], q[3])]}
    rate = EVAL_MESH_POINTS / min(q[1]['s'], q[2]['s'])
    chunk_ms = min(query_ms['kernels'])
    rows, busy = _device_profile(lambda: model.jittered_semantic_features(
        points[:EVAL_CHUNK], JITTER_SAMPLES, JITTER_SIGMA, seed=0))
    print(f'eval 3d query [{gpu}]: {EVAL_MESH_POINTS} points, '
          f'{JITTER_SAMPLES} queries a point, {n_chunks} chunks: ms per '
          f'{EVAL_CHUNK}-point chunk (in turns) kernels '
          f'{[round(v, 3) for v in query_ms["kernels"]]}, plain '
          f'{[round(v, 3) for v in query_ms["plain"]]}; {rate:.1f} points/s '
          f'({rate * JITTER_SAMPLES:.1f} queries/s); peak memory '
          f'{q[1]["peak_bytes"] / 1e9:.3f} GB above the model (plain '
          f'{q[0]["peak_bytes"] / 1e9:.3f})')
    query_share = _print_profile(gpu, 'eval 3d query', rows, busy, chunk_ms,
                                 'chunk')
    results['K1s']['eval_3d'] = dict(chunk_ms=query_ms, points_per_s=rate,
                                     busy_ms=busy, busy_share=query_share,
                                     errors=query_errors)
    del q, model, served, evaluator
    torch.cuda.empty_cache()

    # (d) a reference checkpoint: the port's export of seeded params of the
    # reference's hg+freq model, imported by from_checkpoint
    lo, hi = np.full(3, -1.0), np.full(3, 1.0)  # bound 2, phase 5's
    reference_flags = model_utils.model_flag_parser().parse_args(
        ['--grid-preset', 'reference'])
    base = model_utils.model_config(lo, hi, REFERENCE_CLASSES,
                                    reference_flags)
    grid = dataclasses.replace(base.grid_config, variant='tcnn')
    config = dataclasses.replace(base, grid=grid, geo_relu=True)
    gen = torch.Generator().manual_seed(seed + 15)
    source = Field(config, device=dev, generator=gen)
    with torch.no_grad():
        table = torch.randn(source.encoder['grid'].shape, generator=gen) * 0.5
        for level, size in enumerate(grid.level_sizes):
            table[level, size:] = 0.0  # beyond the reference's buffer
        source.encoder['grid'].copy_(table)
    tree = bridge.params_to_numpy(source)
    reference_ws = os.path.join(root, 'reference', 'sphere', 'g15_hg+freq')
    os.makedirs(os.path.join(reference_ws, 'checkpoints'))
    torch_export.export_torch_checkpoint(
        os.path.join(reference_ws, 'checkpoints', 'ngp_ep0001.pth'), tree,
        config)
    del source
    served = Field(base, device=dev)
    model = model_class.from_checkpoint(served, reference_ws,
                                        num_steps=NUM_STEPS,
                                        max_ray_batch=MAX_RAY_BATCH)
    imported = model.field.config
    checks.true('eval reference: the field comes back with geo_relu and the '
                'tcnn lattice', imported.geo_relu and imported.grid == grid
                and imported.grid_config.variant == 'tcnn'
                and imported.heads_impl == 'xla',
                f'{imported}')
    back = bridge.params_to_numpy(model.field)
    same = [name for name in ('sigma_net', 'semantic_features',
                              'semantic_out')
            if all(np.array_equal(a, b) for a, b in zip(back[name],
                                                        tree[name]))]
    # the colour net's 16 SH rows pass through the direction fold and its
    # inverse, which rounds them again in fp32 (as in the JAX tests)
    colour = (all(np.array_equal(a, b) for a, b in zip(
        back['color_net'][1:], tree['color_net'][1:]))
        and np.array_equal(back['color_net'][0][16:],
                           tree['color_net'][0][16:])
        and np.allclose(back['color_net'][0][:16], tree['color_net'][0][:16],
                        rtol=1e-4, atol=1e-7))
    checks.true('eval reference: params exported and re-imported bit-equal '
                '(the colour net\'s 16 SH-folded rows within rtol 1e-4)',
                len(same) == 3 and colour and np.array_equal(
                    back['encoder']['grid'], tree['encoder']['grid']),
                f'bit-equal {same}, colour net {colour}')
    table = model.field.encoder['grid'].detach()
    x = torch.rand((REFERENCE_N, 3), generator=torch.Generator().manual_seed(
        seed + 16)).to(dev)
    enc = hashgrid_cuda.hashgrid_encode(table, x, grid)
    enc_plain = hashgrid_cuda.hashgrid_encode_plain(table, x, grid)
    k1_err = checks.close(f'K1 encode tcnn 16x2x2^19 N={REFERENCE_N}', enc,
                          enc_plain, atol=1e-5, rtol=0.0)
    checks.true(f'K1 encode tcnn 16x2x2^19 N={REFERENCE_N} bit-equal',
                torch.equal(enc, enc_plain))
    k1_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(table, x, grid),
                     20)
    k1_device = _kernel_ms(lambda: hashgrid_cuda.hashgrid_encode(table, x,
                                                                 grid))
    k1_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_plain(
        table, x, grid), 3)
    # the table's bytes are its levels' rows: the kernel hashes modulo a
    # level's size and reads no padding row beyond it
    table_bytes = (sum(grid.level_sizes) * grid.n_features
                   * table.element_size())
    k1_bound = _bound(_nbytes(x, enc) + table_bytes,
                      16 * REFERENCE_N * grid.out_dim, PEAK_FP32)
    # the sector floor: the 32-byte sectors the gathers touch, each read
    # from device memory once, beside the streams
    sectors = sum(hashgrid_cuda.gather_sectors(x, grid))
    k1_sector_floor = (_nbytes(x, enc) + 32 * sectors) / PEAK_BYTES * 1e3
    k1_shape = hashgrid_cuda.encode_launch_shapes(grid, REFERENCE_N)
    results['K1']['tcnn'] = dict(
        n=REFERENCE_N, max_abs_err=k1_err, ms=k1_ms,
        device_ms=None if k1_device is None else sum(k1_device.values()),
        plain_ms=k1_plain, bound_ms=k1_bound[0], bound_by=k1_bound[1],
        sectors=sectors, sector_floor_ms=k1_sector_floor, shape=k1_shape)
    print(f'K1 [{gpu}] tcnn 16x2x2^19 N={REFERENCE_N}: {k1_ms:.4f} ms '
          f'({results["K1"]["tcnn"]["device_ms"]} device), plain '
          f'{k1_plain:.4f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), '
          f'sector floor {k1_sector_floor:.4f} ms ({sectors} sectors), '
          f'shape {k1_shape}')
    del enc, enc_plain
    # the torch-ngp lattice at full size (level sizes not powers of two) on
    # the same points, rows beyond a level's size zero
    ngp = HashGridConfig.from_desired_resolution(2 ** 18,
                                                 variant='torch_ngp')
    ngp_table = torch.randn((ngp.n_levels, ngp.table_size, ngp.n_features),
                            generator=torch.Generator().manual_seed(
                                seed + 24)) * 0.5
    for level, size in enumerate(ngp.level_sizes):
        ngp_table[level, size:] = 0.0
    ngp_table = ngp_table.to(dev)
    for name, pts in (('unit', x), ('outside', x * 1.1 - 0.05)):
        checks.true(f'K1 encode torch_ngp 16x2x2^19 N={REFERENCE_N} {name} '
                    f'bit-equal', torch.equal(
                        hashgrid_cuda.hashgrid_encode(ngp_table, pts, ngp),
                        hashgrid_cuda.hashgrid_encode_plain(ngp_table, pts,
                                                            ngp)))
    del x, ngp_table
    frames = [_frame(rays, (3.2, -2.4, 1.2)), _frame(rays, (-2.8, -3.0, 0.8))]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    renders = [model.render(batch) for batch in frames]
    reference_s = time.perf_counter() - t0
    reference_launches = dict(_kernels.launches)
    render_chunks = -(-FRAME_W * FRAME_H // MAX_RAY_BATCH)
    expect('eval reference render', reference_launches,
           {'K1': render_chunks * len(frames)})
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        _kernels.reset_launches()
        plain_renders = [model.render(batch) for batch in frames]
        ran = {k: v for k, v in _kernels.launches.items() if v}
    checks.true('eval reference plain render launches no kernel', not ran,
                f'{ran}')
    reference_errors = [
        _hold_maps(checks, f'eval reference frame {i}', a, b,
                   ('image', 'depth', 'semantic', 'semantic_features'))
        for i, (a, b) in enumerate(zip(renders, plain_renders))]
    weights = [float(r['weights_sum'].mean()) for r in renders]
    # the same two frames again, warm, for a spread of the wall
    repeats = []
    for _ in range(REFERENCE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in frames:
            model.render(batch)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    print(f'eval reference [{gpu}]: {len(frames)} frames of '
          f'{FRAME_W}x{FRAME_H} at {NUM_STEPS} samples, {reference_s:.3f} s '
          f'(again, warm: {[round(v, 4) for v in repeats]} s); mean '
          f'weights_sum {weights}')
    print(f'eval phase: {time.perf_counter() - phase_start:.1f} s (scene '
          f'written in {scene_s:.1f} s)')
    return dict(launches={'closed': closed_launches,
                          '2d': language_launches['2d'],
                          '3d': language_launches['3d'],
                          'reference': reference_launches},
                names=names, closed_ms=closed_ms, closed_iou=ious,
                closed_profile=closed_profile['rows'],
                closed_busy_ms=closed_profile['busy_ms'],
                closed_busy_share=closed_share,
                closed_miou=miou, closed_errors=closed_errors,
                language=language_out,
                query_ms=query_ms, points_per_s=rate, query_busy_ms=busy,
                query_profile=rows, query_errors=query_errors,
                reference_errors=reference_errors,
                reference_weights_sum=weights, reference_s=reference_s,
                reference_repeats_s=repeats, scene_s=scene_s)


# The interactive backend (phase 15): the GUI's backend process at the
# GUI's defaults on the room fixture written at ScanNet's 1280 x 960 (the
# backend reads it at factor 4: 320 x 240), the user-in-the-loop
# simulation on the room at its own 160 x 120 with dense labels, and the
# online mapping node's training configuration on DynamicDataset.
BACKEND_SCENE = dict(n_frames=16, width=1280, height=960)
BACKEND_FLAGS = []  # the GUI's defaults
# The child traces 5 steps early on and drops the trace before the timed
# requests begin (reading a trace stalls its loop for about 12 s).
BACKEND_TRACE_AT, BACKEND_TRACE_STEPS = 30, 5
BACKEND_TRAIN_S = 3.0  # training after the trace, before the requests
BACKEND_REQUESTS, BACKEND_PAUSE_S = 10, 0.25
REPAINT_FRAME, REPAINT_CLASS = 1, 3
# simulate_user's defaults (warmup 15000, 250 iterations a round, 1500
# annotations) cut to fit the phase's time.
USER_SIM_CUT = ['--warmup', '400', '--iters-per-round', '25',
                '--max-annotations', '100']
USER_SIM_SCENE = dict(label_every=1)  # every frame's gt map in semantic/
# scripts/ros/node.py's training loop (:129-160, :182): 256 x 192 frames,
# capacity 325, 100-step bursts; its --bound default 2.5.
ONLINE_SIZE, ONLINE_INTRINSICS = (256, 192), (205.0, 205.0, 128.0, 96.0)
ONLINE_CAPACITY, ONLINE_BATCH = 325, 2048
ONLINE_BURSTS, ONLINE_BURST_STEPS = 3, 100
ONLINE_FRAMES, ONLINE_DISTINCT = 360, 36


def _online_camera():
    """The node's 3 x 3 camera matrix at its 256 x 192 frames."""
    import numpy as np
    fx, fy, cx, cy = ONLINE_INTRINSICS
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


@functools.lru_cache(maxsize=1)
def _online_frames():
    """The ONLINE_DISTINCT room frames a camera circling the room sees at
    the node's size: (T_CW, rgb uint8, depth uint16 in millimetres)."""
    import numpy as np
    from autolabel_tpu_torch.utils import fixtures
    w, h = ONLINE_SIZE
    out = []
    for i in range(ONLINE_DISTINCT):
        angle = 2 * np.pi * i / ONLINE_DISTINCT
        pos = np.array([0.95 * np.cos(angle), 0.95 * np.sin(angle),
                        0.9 + 0.35 * np.sin(3 * angle)])
        target = np.array([-0.9 * np.cos(angle), -0.9 * np.sin(angle), 0.8])
        T_WC = fixtures.look_at_cv(pos, target)
        rgb, depth, _ = fixtures.render_room_frame(T_WC, _online_camera(),
                                                   w, h)
        out.append((np.linalg.inv(T_WC), (rgb * 255).astype(np.uint8),
                    (depth * 1000).astype(np.uint16)))
    return out


def _sync():
    """Wait for the card (nothing to wait for before CUDA is used)."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _StampedConnection:
    """The child's end of the Pipe, stamping each message received and
    each send (time.monotonic, comparable across the two processes)."""

    def __init__(self, connection):
        self._connection = connection
        self.received, self.sent = [], []

    def poll(self, *args):
        return self._connection.poll(*args)

    def recv(self):
        message = self._connection.recv()
        self.received.append((time.monotonic(), message[0], message[1]))
        return message

    def send(self, message):
        t0 = time.monotonic()
        self._connection.send(message)
        self.sent.append((t0, time.monotonic(), message[1]['image_index']))


def _backend_child(flags, connection, device):
    """Phase 15 (a)'s child: gui.run_backend as the GUI starts it, with
    its steps, requests and one traced stretch stamped; when it stops, its
    launches and stamps go to <scene>/backend_child.json."""
    import gc
    sys.path.insert(0, HERE)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from autolabel_tpu_torch import backend, gui
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.train.trainer import InteractiveTrainer
    steps, pending, parts, trace = [], [], [], {}
    take_step = InteractiveTrainer.take_step
    test_step = InteractiveTrainer.test_step
    fetch, classes = backend._fetch_frame, backend._classes

    def stamped_step(self, draws=None):
        n = len(steps)
        if n == BACKEND_TRACE_AT and torch.cuda.is_initialized():
            _sync()
            trace['prof'] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            trace['prof'].start()
            for _ in range(TRACE_MARKERS):
                torch.cuda._sleep(1000)
            trace['t0'] = time.monotonic()
        elif n == BACKEND_TRACE_AT + BACKEND_TRACE_STEPS:
            if 'prof' in trace:
                _sync()
                trace['wall_ms'] = (time.monotonic() - trace['t0']) * 1e3
                prof = trace.pop('prof')
                prof.stop()
                rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0
                        and MARKER not in e.key]
                rows.sort(key=lambda r: -r[1])
                trace['rows'] = rows[:12]
                trace['busy_ms'] = sum(r[1] for r in rows)
                del prof
                gc.collect()
            trace['done'] = time.monotonic()
            # the parent times its requests only after this
            open(os.path.join(flags.scene, 'backend_trace.done'), 'w').close()
        out = take_step(self, draws)
        steps.append(time.monotonic())
        pending.append(sum(e is not None and not e.query()
                           for e in self._inflight))
        return out

    def timed_test_step(self, data):
        t0 = time.monotonic()
        _sync()  # the queued steps, drained
        t1 = time.monotonic()
        out = test_step(self, data)
        _sync()
        parts.append({'step': len(steps), 'drain_ms': (t1 - t0) * 1e3,
                      'render_ms': (time.monotonic() - t1) * 1e3})
        return out

    def timed_fetch(rgb, depth):
        t0 = time.monotonic()
        out = fetch(rgb, depth)
        parts[-1]['fetch_ms'] = (time.monotonic() - t0) * 1e3
        return out

    def timed_classes(semantic):
        t0 = time.monotonic()
        out = classes(semantic)
        parts[-1]['classes_ms'] = (time.monotonic() - t0) * 1e3
        return out

    InteractiveTrainer.take_step = stamped_step
    InteractiveTrainer.test_step = timed_test_step
    backend._fetch_frame, backend._classes = timed_fetch, timed_classes
    stamped = _StampedConnection(connection)
    started = time.monotonic()
    loop = gui.run_backend(flags, stamped, device)
    semantics = loop.train_dataset.semantics[REPAINT_FRAME]
    report = {'launches': dict(_kernels.launches), 'steps': steps,
              'pending': pending, 'parts': parts,
              'received': [r for r in stamped.received if r[1] != 'image'],
              'sent': stamped.sent, 'started': started,
              'global_step': loop.trainer.global_step,
              'painted': int((semantics == REPAINT_CLASS).sum()),
              'max_inflight': loop.trainer.MAX_INFLIGHT,
              'trace': {k: trace[k] for k in ('rows', 'busy_ms', 'wall_ms',
                                              'done') if k in trace}}
    with open(os.path.join(flags.scene, 'backend_child.json'), 'w') as f:
        json.dump(report, f)


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f'{what}: not within {timeout} s')
        time.sleep(0.002)


def _median(values):
    import numpy as np
    return float(np.median(values)) if len(values) else None


def _pcts(values, qs=(50, 90)):
    import numpy as np
    return [float(v) for v in np.percentile(values, qs)] if len(values) \
        else None


def _request(loop, conn, index):
    """('get_image', index) to an in-process TrainingLoop, pumped once,
    its reply read meanwhile on a thread (a preview outgrows the pipe's
    buffer, so the loop's send waits for the read). Returns the reply."""
    import threading
    conn.send(('get_image', index))
    got = []
    reader = threading.Thread(target=lambda: got.append(conn.recv()),
                              daemon=True)
    reader.start()
    loop._check_messages()
    reader.join(60)
    if not got:
        raise TimeoutError(f'no reply to get_image {index}')
    return got[0]


def _backend_size():
    """The backend's frame size: the scene's at factor 4."""
    return BACKEND_SCENE['width'] // 4, BACKEND_SCENE['height'] // 4


def _backend_child_leg(gpu, checks, scene, flags, names):
    """Phase 15 (a): the backend in a spawned child through
    gui.BackendClient; its report and the parent's round trips."""
    import numpy as np
    from autolabel_tpu_torch import gui, model_utils
    from autolabel_tpu_torch.utils import Scene
    from autolabel_tpu_torch.utils.images import (resize_nearest_pil,
                                                  write_png)
    best = os.path.join(scene, 'nerf', model_utils.model_hash(flags),
                        'checkpoints', 'best.pth')
    w, h = _backend_size()
    previews, sends = [], []
    t_start = time.monotonic()
    client = gui.BackendClient(flags, previews.append, target=_backend_child)
    try:
        client.request_preview(0)
        sends.append(time.monotonic())
        _wait(lambda: client.poll() or previews, 600, 'the first preview')
        first_s = time.monotonic() - t_start
        replies = [time.monotonic()]
        _wait(lambda: os.path.exists(os.path.join(
            scene, 'backend_trace.done')), 300, 'the child\'s trace')
        time.sleep(BACKEND_TRAIN_S)
        n_frames = BACKEND_SCENE['n_frames']
        for k in range(BACKEND_REQUESTS):
            index = (2 * k + 3) % n_frames
            count = len(previews)
            client.request_preview(index)
            sends.append(time.monotonic())
            _wait(lambda: client.poll() or len(previews) > count, 120,
                  f'preview {index}')
            replies.append(time.monotonic())
            checks.true(f'backend child preview {index}',
                        previews[-1]['image_index'] == index
                        and previews[-1]['rgb'].shape == (h, w, 3)
                        and previews[-1]['semantic'].dtype == np.int32
                        and bool(np.isfinite(previews[-1]['depth']).all()))
            time.sleep(BACKEND_PAUSE_S)
        frame_names = Scene(scene).image_names()
        painted = np.zeros((BACKEND_SCENE['height'], BACKEND_SCENE['width']),
                           np.uint8)
        painted[:, :BACKEND_SCENE['width'] // 2] = REPAINT_CLASS
        write_png(os.path.join(scene, 'semantic',
                               f'{frame_names[REPAINT_FRAME]}.png'), painted)
        client.labels_changed(REPAINT_FRAME)
        client.save_checkpoint()
        _wait(lambda: os.path.exists(best), 120, 'best.pth')
        time.sleep(0.5)
    finally:
        exitcode = client.stop()
    checks.true('backend child stops cleanly', exitcode == 0,
                f'exit code {exitcode}')
    with open(os.path.join(scene, 'backend_child.json')) as f:
        report = json.load(f)
    want = int((resize_nearest_pil(painted, (w, h))
                == REPAINT_CLASS).sum())
    checks.true('backend child takes up update_image',
                report['painted'] == want,
                f'{report["painted"]} pixels of class {REPAINT_CLASS} in '
                f'frame {REPAINT_FRAME} (expected {want})')
    launches = report['launches']
    n_steps = len(report['steps'])
    for key in ('K1s', 'K5', 'K2s'):
        got = launches.get(names[key], 0)
        checks.true(f'backend child launches {key}', got >= n_steps,
                    f'{got} launches over {n_steps} steps')
    # the loop: step-end stamps; an iteration that served a request is
    # counted apart
    stamps = np.array(report['steps'])
    served = {p['step'] for p in report['parts']}
    gaps = np.diff(stamps) * 1e3
    plain_gaps = [g for i, g in enumerate(gaps) if i + 1 not in served]
    pending = np.array(report['pending'])
    trace = report['trace']
    # each request's parts, in order (one request in flight at a time);
    # the first is the spawn's
    rtt = (np.array(replies) - np.array(sends)) * 1e3
    received = [r[0] for r in report['received'] if r[1] == 'get_image']
    checks.true('backend child answered each request once',
                len(report['parts']) == len(report['sent']) == len(sends)
                == len(received),
                f'{len(report["parts"])} renders, {len(report["sent"])} '
                f'sent, {len(received)} received of {len(sends)}')
    requests = [dict(part, index=sent[2],
                     wait_ms=(got - asked) * 1e3,
                     send_ms=(sent[1] - sent[0]) * 1e3,
                     to_parent_ms=(back - sent[1]) * 1e3, rtt_ms=float(ms))
                for part, sent, got, asked, back, ms in zip(
                    report['parts'], report['sent'], received, sends,
                    replies, rtt)][1:]
    rtt = rtt[1:]
    busy_share = untraced_share = None
    if trace.get('rows'):
        # device busy over the traced stretch's wall, and over the same
        # steps' untraced median wall
        busy_share = trace['busy_ms'] / trace['wall_ms']
        untraced_share = trace['busy_ms'] / (BACKEND_TRACE_STEPS
                                             * _median(plain_gaps))
        checks.true('backend child trace dropped before the timed requests',
                    trace['done'] < sends[1],
                    f'{(sends[1] - trace["done"]):.3f} s before')
    summary = dict(
        first_preview_s=first_s, steps=n_steps,
        loop_ms=_pcts(plain_gaps), loop_ms_all=_pcts(gaps),
        window_max=int(pending.max()), window_median=float(
            np.median(pending)), window_full=float((pending >= 8).mean()),
        busy_share=busy_share, untraced_busy_share=untraced_share,
        trace_busy_ms=trace.get('busy_ms'),
        trace_wall_ms=trace.get('wall_ms'), trace_rows=trace.get('rows'),
        rtt_ms=[float(v) for v in rtt], rtt_p50_p90=_pcts(rtt),
        request_parts=requests, launches=launches,
        global_step=report['global_step'])
    print(f'backend child [{gpu}]: first preview {first_s:.3f} s after '
          f'the spawn; {n_steps} steps; ms a loop iteration (p50, p90) '
          f'{summary["loop_ms"]} without a request, {summary["loop_ms_all"]}'
          f' all; window of {report["max_inflight"]}: pending steps max '
          f'{summary["window_max"]}, median {summary["window_median"]}, '
          f'full {summary["window_full"]:.4f} of the steps')
    if busy_share is None:
        print('backend child profile: the trace holds no device time: not '
              'measured')
    else:
        print(f'backend child profile [{gpu}]: {BACKEND_TRACE_STEPS} steps '
              f'from step {BACKEND_TRACE_AT}: device busy '
              f'{trace["busy_ms"]:.3f} of {trace["wall_ms"]:.3f} ms traced: '
              f'busy share {busy_share:.4f}; of the untraced '
              f'{BACKEND_TRACE_STEPS} x {_median(plain_gaps):.3f} ms: '
              f'{untraced_share:.4f}')
        for name, ms, count in trace['rows'][:8]:
            print(f'  {ms:9.3f} ms {ms / trace["busy_ms"]:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    print(f'backend child preview round trip [{gpu}] over {len(rtt)} '
          f'requests: ms {[round(float(v), 3) for v in rtt]}, p50/p90 '
          f'{summary["rtt_p50_p90"]}')
    for key in ('wait_ms', 'drain_ms', 'render_ms', 'fetch_ms', 'classes_ms',
                'send_ms', 'to_parent_ms'):
        values = [p[key] for p in requests if key in p]
        print(f'  {key}: p50/p90 {_pcts(values)}')
    return summary, painted


def _backend_phase(dev, seed, gpu, checks):
    """Phase 15 (see the module docstring). Returns what the output file
    keeps; its 'launches' are each leg's counts by kernel name."""
    import multiprocessing
    import shutil
    import threading
    import types

    import numpy as np
    import torch
    from autolabel_tpu_torch import gui, inference, model_utils, simulate_user
    from autolabel_tpu_torch.backend import TrainingLoop
    from autolabel_tpu_torch.core.dataset import DynamicDataset
    from autolabel_tpu_torch.features.fallback import RandomFeatureExtractor
    from autolabel_tpu_torch.ops import (_kernels, hashgrid_cuda, heads_cuda,
                                         splat_cuda)
    from autolabel_tpu_torch.render.baked import fill_passes_for
    from autolabel_tpu_torch.render.renderer import RenderOptions
    from autolabel_tpu_torch.train.losses import LossOptions
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    from autolabel_tpu_torch.utils import Camera, fixtures
    phase_start = time.perf_counter()
    root = os.path.join(WORK_DIR, 'backend')
    shutil.rmtree(root, ignore_errors=True)
    names = {'K1s': hashgrid_cuda.ATOMS_NAME,
             'K5': hashgrid_cuda.SELECT_NAME,
             'K2s': hashgrid_cuda.SAMPLED_BWD_NAME,
             'K3f': heads_cuda.HEADS, 'K3b': heads_cuda.HEADS_BWD,
             'K4f': heads_cuda.MLP3, 'K4b': heads_cuda.MLP3_BWD,
             'K8': splat_cuda.NAME}
    scene = os.path.join(root, 'room')
    t0 = time.perf_counter()
    fixtures.make_room_scene(scene, **BACKEND_SCENE)
    scene_s = time.perf_counter() - t0
    flags = gui.read_args([scene] + BACKEND_FLAGS)
    w, h = _backend_size()
    out = {'scene_s': scene_s, 'launches': {}}

    # (a) the backend in a spawned child, at the GUI's defaults
    torch.cuda.empty_cache()
    child, painted = _backend_child_leg(gpu, checks, scene, flags, names)
    out['child'] = child
    out['launches']['backend'] = child['launches']

    # the child's best.pth: resumed in process (the plain-version hold),
    # and served by InferenceModel
    conn, loop_end = multiprocessing.Pipe()
    loop = TrainingLoop(scene, flags, loop_end, device=dev)
    workspace = loop.workspace
    checks.true('backend best.pth resumes', loop.trainer.global_step > 0,
                f'global step {loop.trainer.global_step}')
    data = loop.train_dataset._get_test(0)
    with torch.no_grad():
        maps = {}
        for tag, ctx in (('kernels', contextlib.nullcontext()),
                         ('plain', _plain_kernels(hashgrid_cuda,
                                                  heads_cuda))):
            with ctx:
                rgb, depth, logits, _ = loop.trainer.test_step(data)
            maps[tag] = {'image': rgb.cpu().numpy(),
                         'depth': depth.cpu().numpy(),
                         'semantic': logits.cpu().numpy()}
    out['preview_vs_plain'] = _hold_maps(
        checks, 'backend preview frame 0', maps['kernels'], maps['plain'],
        ('image', 'depth', 'semantic'))
    reply = _request(loop, conn, 0)
    payload = reply[1]
    checks.true('backend payload', reply[0] == 'image' and set(payload)
                == {'image_index', 'rgb', 'depth', 'semantic', 'features'}
                and payload['rgb'].shape == (h, w, 3)
                and payload['rgb'].dtype == np.float32
                and payload['depth'].dtype == np.float32
                and payload['semantic'].dtype == np.int32
                and payload['features'] is None)
    model = inference.InferenceModel.from_checkpoint(
        model_utils.create_model(loop.train_dataset.min_bounds,
                                 loop.train_dataset.max_bounds,
                                 loop.train_dataset.n_classes, flags,
                                 device=dev), workspace, num_steps=128)
    served = model.render({k: data[k] for k in ('rays_o', 'rays_d',
                                                'direction_norms')})
    checks.true('backend best.pth serves through InferenceModel',
                served['image'].shape == (h, w, 3)
                and bool(np.isfinite(served['image']).all()))
    del model, loop
    torch.cuda.empty_cache()

    # (b) --baked-preview, in process: the first request's bake, round
    # trips between steps, one slab refresh
    flags_b = gui.read_args([scene, '--baked-preview'] + BACKEND_FLAGS)
    conn, loop_end = multiprocessing.Pipe()
    loop = TrainingLoop(scene, flags_b, loop_end, device=dev)
    _sync()
    _kernels.reset_launches()
    loop.trainer.init(loop.train_dataset)
    for _ in range(5):
        loop.trainer.take_step()
    t0 = time.perf_counter()
    first = _request(loop, conn, 0)
    first_bake_s = time.perf_counter() - t0
    baked_rtt = []
    frames = 1
    for k in range(BACKEND_REQUESTS):
        for _ in range(3):
            loop.trainer.take_step()
            loop._maybe_update_bake()
        t0 = time.perf_counter()
        reply = _request(loop, conn,
                         (2 * k + 3) % BACKEND_SCENE['n_frames'])
        baked_rtt.append((time.perf_counter() - t0) * 1e3)
        frames += 1
        checks.true(f'backend baked preview {k}', reply[0] == 'image'
                    and reply[1]['rgb'].shape == (h, w, 3)
                    and reply[1]['features'] is None
                    and bool(np.isfinite(reply[1]['rgb']).all()))
    _sync()
    slab_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loop._baker.update_next_block()
        _sync()
        slab_ms.append((time.perf_counter() - t0) * 1e3)
    baked_launches = dict(_kernels.launches)
    passes = 2 + loop._governed.level
    want = frames * splat_cuda.launches_for(fill_passes_for(w, passes))
    checks.true('backend baked launches K8',
                baked_launches.get(names['K8'], 0) == want
                and first[0] == 'image',
                f'{baked_launches.get(names["K8"], 0)} (expected {want}: '
                f'{frames} frames)')
    out['baked'] = dict(first_bake_s=first_bake_s, rtt_ms=baked_rtt,
                        rtt_p50_p90=_pcts(baked_rtt), slab_ms=slab_ms,
                        splats=int(loop._baker._valid.sum()),
                        launches=baked_launches)
    out['launches']['backend_baked'] = baked_launches
    print(f'backend baked [{gpu}]: first request (the bake at 128^3 into '
          f'2^18 splats, then the frame) {first_bake_s:.3f} s; round trip '
          f'ms {[round(v, 3) for v in baked_rtt]} (p50/p90 '
          f'{out["baked"]["rtt_p50_p90"]}); one slab refresh ms '
          f'{[round(v, 3) for v in slab_ms]}')
    del loop
    torch.cuda.empty_cache()

    # (c) --heads-impl pallas --proposal --occupancy-grid, in process
    flags_c = gui.read_args([scene, '--heads-impl', 'pallas', '--proposal',
                             '--occupancy-grid'] + BACKEND_FLAGS)
    conn, loop_end = multiprocessing.Pipe()
    loop = TrainingLoop(scene, flags_c, loop_end, device=dev)
    _sync()
    _kernels.reset_launches()
    loop.trainer.init(loop.train_dataset)
    losses = [loop.trainer.take_step() for _ in range(10)]
    replies = [_request(loop, conn, 0), _request(loop, conn, 5)]
    pallas_launches = dict(_kernels.launches)
    checks.true('backend pallas leg', all(
        r[0] == 'image' and bool(np.isfinite(r[1]['rgb']).all())
        for r in replies) and all(bool(torch.isfinite(l['total']))
                                  for l in losses))
    for key in ('K1s', 'K5', 'K2s', 'K3f', 'K3b', 'K4f', 'K4b'):
        checks.true(f'backend pallas leg launches {key}',
                    pallas_launches.get(names[key], 0) >= 10,
                    f'{pallas_launches.get(names[key], 0)}')
    out['launches']['backend_pallas'] = pallas_launches
    del loop
    torch.cuda.empty_cache()

    # (d) simulate_user on the room at 160 x 120, dense labels
    sim_scene = fixtures.make_room_scene(os.path.join(root, 'room_sim'),
                                         **USER_SIM_SCENE)
    stamps = {'annotate': [], 'evaluate': []}
    user_class = simulate_user.UserSimulation
    annotate, evaluate = user_class.annotate, user_class.evaluate

    def stamped(name, fn):
        def wrapped(self, *args):
            stamps[name].append(time.perf_counter())
            return fn(self, *args)
        return wrapped

    user_class.annotate = stamped('annotate', annotate)
    user_class.evaluate = stamped('evaluate', evaluate)
    try:
        _sync()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        user = simulate_user.main([sim_scene, '--workspace',
                                   os.path.join(root, 'ws')] + USER_SIM_CUT,
                                  dev)
        user_s = time.perf_counter() - t0
    finally:
        user_class.annotate, user_class.evaluate = annotate, evaluate
    user_launches = dict(_kernels.launches)
    rounds = np.diff(stamps['annotate']) * 1e3
    curve = [list(r) for r in user.results]
    checks.true('user simulation', os.path.exists(user.result_path)
                and all(0.0 <= r[2] <= 1.0 for r in curve)
                and int((user.dataset.semantics > 0).sum()) >= int(
                    USER_SIM_CUT[USER_SIM_CUT.index('--max-annotations')
                                 + 1]),
                f'{len(stamps["annotate"])} rounds, mIoU curve {curve}')
    out['user_sim'] = dict(seconds=user_s, rounds=len(stamps['annotate']),
                           round_ms=_pcts(rounds), curve=curve,
                           cut=USER_SIM_CUT, launches=user_launches)
    out['launches']['user_sim'] = user_launches
    print(f'user simulation [{gpu}]: {len(stamps["annotate"])} rounds in '
          f'{user_s:.3f} s (flags cut: {" ".join(USER_SIM_CUT)}); ms a round '
          f'(p50, p90, with a 10-frame evaluation every 5th) '
          f'{out["user_sim"]["round_ms"]}; mIoU curve (round, pixels, '
          f'mIoU) {curve}')
    del user
    torch.cuda.empty_cache()

    # (e) DynamicDataset at the online node's configuration
    w, h = ONLINE_SIZE  # the node's frames and render intrinsics
    K = _online_camera()
    extractor = RandomFeatureExtractor(512)
    distinct = []
    for T_CW, rgb8, depth16 in _online_frames():
        feats = extractor(np.transpose(rgb8 / 255.0, [2, 0, 1])[None])[0]
        feats = feats / np.maximum(np.linalg.norm(feats, axis=-1,
                                                  keepdims=True), 1e-9)
        distinct.append((T_CW, rgb8, depth16, feats))
    node = types.SimpleNamespace(encoding='hg+freq', geometric_features=15,
                                 feature_dim=512, features='lseg')
    bound = 2.5
    field = model_utils.create_model(np.full(3, -bound), np.full(3, bound),
                                     2, node, device=dev)
    trainer = SimpleTrainer(
        'ngp', field, lr=1e-2, iters=None,
        loss_options=LossOptions(rgb_weight=1.0, depth_weight=0.025,
                                 semantic_weight=0.0, feature_weight=0.5,
                                 feature_loss=True),
        render_options=RenderOptions(num_steps=128, perturb=True),
        workspace=None, ema_decay=0.95, max_ray_batch=ONLINE_BATCH)
    dataset = DynamicDataset(ONLINE_BATCH, Camera(K, (w, h)),
                             capacity=ONLINE_CAPACITY)
    fed = []

    def feed():
        for i in range(ONLINE_FRAMES):
            dataset.add_frame(*distinct[i % ONLINE_DISTINCT])
            fed.append(len(dataset))
            time.sleep(0.005)

    class Timed:
        """The dataset's batches, with the time spent waiting for each."""
        wait_s = 0.0

        def __iter__(self):
            iterator = iter(dataset)
            while True:
                t0 = time.perf_counter()
                batch = next(iterator)
                Timed.wait_s += time.perf_counter() - t0
                yield batch

    feeder = threading.Thread(target=feed, daemon=True)
    try:
        for frame in distinct[:6]:
            dataset.add_frame(*frame)
        _sync()
        _kernels.reset_launches()
        feeder.start()
        bursts = []
        for _ in range(ONLINE_BURSTS):
            Timed.wait_s = 0.0
            t0 = time.perf_counter()
            loss = trainer.train_iterations(Timed(), ONLINE_BURST_STEPS)
            total = float(loss['total'])
            wall = time.perf_counter() - t0
            bursts.append(dict(ms_step=wall / ONLINE_BURST_STEPS * 1e3,
                               wait_share=Timed.wait_s / wall,
                               frames=len(dataset), loss=total))
        online_launches = dict(_kernels.launches)
        feeder.join(120)
    finally:
        dataset.stop()
    checks.true('online feeder and prefetch thread end',
                not feeder.is_alive() and not dataset._prefetch_thread
                .is_alive())
    checks.true('online eviction holds the capacity',
                len(fed) == ONLINE_FRAMES and max(fed) == ONLINE_CAPACITY
                and len(dataset) == ONLINE_CAPACITY
                and all(len(getattr(dataset, k)) == ONLINE_CAPACITY
                        for k in ('poses', 'images', 'depths', 'features',
                                  'semantics')),
                f'{6 + len(fed)} frames fed, {len(dataset)} kept, at most '
                f'{max(fed)}')
    checks.true('online bursts', all(np.isfinite(b['loss']) for b in bursts),
                f'{bursts}')
    out['online'] = dict(bursts=bursts, launches=online_launches,
                         frames_fed=6 + len(fed))
    out['launches']['online'] = online_launches
    print(f'online [{gpu}]: DynamicDataset (capacity {ONLINE_CAPACITY}, '
          f'{w}x{h}, lseg 512 from RandomFeatureExtractor), {ONLINE_BURSTS} '
          f'bursts of {ONLINE_BURST_STEPS} steps at batch {ONLINE_BATCH} x '
          '128 samples '
          f'while {6 + len(fed)} frames arrive: ' + '; '.join(
              f'{b["ms_step"]:.3f} ms a step, waiting {b["wait_share"]:.4f} '
              f'of it, {b["frames"]} frames' for b in bursts))
    del trainer, field, dataset
    torch.cuda.empty_cache()
    out['phase_s'] = time.perf_counter() - phase_start
    print(f'backend phase: {out["phase_s"]:.1f} s (room scene {scene_s:.1f} '
          's)')
    return out


# Camera registration and joint pose refinement (phase 16): K2x held in
# each form of the encode at the slice's shapes; one registration step on
# phase 5's model in turns with the plain versions; the register CLI at its
# defaults on a room trained through the train CLI at full width; joint
# refinement through the train CLI.
POSE_N = 131072  # the register CLI's 2,048 rays x 64 main samples
POSE_SCENE = dict(n_frames=16, width=160, height=120)
POSE_TRAIN = ['--proposal', '--heads-impl', 'pallas', '--factor-train', '1',
              '--no-metrics']
POSE_TRAIN_ITERS = 2000
# The registered frame. Frame 3 of this room does not recover from 5
# degrees and 7 cm: its translation error grows to about 11 cm with the
# kernels, with the port's plain versions on the CPU, and in the JAX
# package's scripts/register.py given the same trained field
# (register_witness.py, PERF.md); frame 8 recovers in all three.
POSE_FRAME = 8
# 5 degrees and 7 cm, as tests/test_pose_refine.py:93-97 perturbs a frame
POSE_PERTURB = ['--perturb-deg', '5', '--perturb-cm', '7']
POSE_JOINT_ITERS = 200
POSE_TRACED = 5


def _pose_points(gen, n, config):
    """n points in the unit cube with 0, 1, faces of every level's cells
    and tied fractions (two or three axes equal)."""
    import torch
    x = torch.rand((n, 3), generator=gen)
    x[:8] = torch.tensor([[0., 0., 0.], [1., 1., 1.], [0., 1., 0.5],
                          [1., 0., 0.999999], [0.5, 0.5, 0.5],
                          [0.25, 0.25, 0.7], [0.3, 0.3, 0.3], [1., 0.5, 0.]])
    for l, scale in enumerate(config.scales):
        k = torch.randint(0, int(scale), (64, 3), generator=gen)
        x[8 + 64 * l:8 + 64 * (l + 1)] = k.float() / scale
    x[1024:2048, 1] = x[1024:2048, 0]
    x[2048:3072] = x[2048:3072, :1]
    return x


def _k2x_bound(encoders, config, x, interp, plan, rows):
    """K2x's least time: each input read once (x, g on the levels it reads,
    each distinct table row those levels gather, and a residual level's two
    drawn rows, which the function cannot recompute), dx written once; 2 F
    operations an atom a level a point. An exact level's corners follow
    from x, so the atom rows K1s or K6 hand the kernel are not charged."""
    import torch
    n, f = x.shape[0], config.n_features
    a = 4 if interp == 'simplex' else 8
    if plan is None:
        plan = ((encoders.EXACT, a),) * config.n_levels
    idx, _ = encoders._corner_idx_weights(x, config, interp)
    levels = distinct = row_reads = atoms = 0
    for l, (kind, count, first, _) in enumerate(encoders.plan_starts(plan)):
        if kind == encoders.DRAWS:
            continue
        levels += 1
        ids = idx[l] if kind == encoders.EXACT else rows[first:first + 2]
        distinct += int(torch.unique(ids).numel())
        atoms += a if kind == encoders.EXACT else 2
        row_reads += 0 if kind == encoders.EXACT else 2
    nbytes = (n * 3 * 4 * 2 + n * levels * f * 4 + row_reads * n * 4
              + distinct * f * 4)
    return _bound(nbytes, 2 * f * atoms * n, PEAK_FP32), nbytes


def _k2x_forms():
    """Phase 16 (a)'s forms of K2x: (tag, grid config, interp, the
    stochastic plan's (n_samples, residual, exact_levels) or None)."""
    import dataclasses
    from autolabel_tpu_torch.ops.encoders import TPU_GRID, HashGridConfig
    tcnn = dataclasses.replace(HashGridConfig(), variant='tcnn')
    return [('TPU_GRID simplex', TPU_GRID, 'simplex', None),
            ('TPU_GRID trilinear', TPU_GRID, 'trilinear', None),
            ('tcnn 16x2x2^19 narrow rows', tcnn, 'trilinear', None),
            ('TPU_GRID simplex stochastic 2 draws exact_levels 1', TPU_GRID,
             'simplex', (2, False, 1)),
            ('TPU_GRID simplex residual exact_levels 1', TPU_GRID,
             'simplex', (2, True, 1))]


def _k2x_inputs(gen, dev, config, interp, stochastic, n=POSE_N):
    """K2x's (g, table, x, config, interp, plan, rows) for one form: n of
    _pose_points, a N(0, 0.25) table and a N(0, 1) cotangent from gen; the
    rows K1s (exact simplex: its atoms) or K6 (stochastic, residual: its
    drawn rows) writes for them, None for the exact trilinear encode."""
    import torch
    from autolabel_tpu_torch.ops import encoders, hashgrid_cuda
    x = _pose_points(gen, n, config).to(dev)
    table = (torch.randn((config.n_levels, config.table_size,
                          config.n_features), generator=gen) * 0.5).to(dev)
    g = torch.randn((n, config.out_dim), generator=gen).to(dev)
    plan = rows = None
    if stochastic is not None:
        n_samples, residual, exact = stochastic
        u = torch.rand(encoders.uniform_shape(
            config.n_levels, n, interp, n_samples, residual),
            generator=gen).to(dev)
        plan = encoders.stochastic_plan(config, interp, n_samples, exact,
                                        residual)
        _, rows, _ = hashgrid_cuda._stochastic_call(
            table, x, u, config, interp, n_samples, plan, True)
    elif interp == 'simplex':
        _, idx, _ = hashgrid_cuda._atoms_call(table, x, config, 'simplex',
                                              torch.float32, True)
        plan = ((encoders.EXACT, 4),) * config.n_levels
        rows = idx.view(-1, n)
    return g, table, x, config, interp, plan, rows


@contextlib.contextmanager
def _first_point_grad(hashgrid_cuda, into):
    """While open, records in `into['args']` the first (g, table, x,
    config, interp, plan, rows) that an encode's backward hands
    hashgrid_cuda.point_grad (g as the fp32 the wrapper passes K2x; g, x
    and rows cloned, the table the frozen field's own)."""
    point_grad = hashgrid_cuda.point_grad

    def recording(g, table, x, config, interp='trilinear', plan=None,
                  rows=None):
        if 'args' not in into:
            into['args'] = (g.float().contiguous().clone(), table.detach(),
                            x.detach().clone(), config, interp, plan,
                            None if rows is None else rows.clone())
        return point_grad(g, table, x, config, interp, plan, rows)

    hashgrid_cuda.point_grad = recording
    try:
        yield into
    finally:
        hashgrid_cuda.point_grad = point_grad


def _k2x_form(checks, gpu, shapes, tag, args):
    """K2x on args (g, table, x, config, interp, plan, rows): one call
    (its two launches on wide rows counted once) within
    encoders.point_grad_tolerance of the plain version, bit-equal to a
    second call; its ms by events and the profiler's device ms (both
    launches), the plain version's, its byte bound and launch shapes."""
    import torch
    from autolabel_tpu_torch.ops import _kernels, encoders, hashgrid_cuda
    name = hashgrid_cuda.POINT_GRAD_NAME
    g, table, x, config, interp, plan, rows = args
    n = x.shape[0]
    _kernels.reset_launches()
    got = hashgrid_cuda._point_grad_call(*args)
    torch.cuda.synchronize()
    checks.true(f'K2x {tag} launched once', _kernels.launches[name] == 1)
    again = hashgrid_cuda._point_grad_call(*args)
    torch.cuda.synchronize()
    checks.true(f'K2x {tag} bit-equal across two calls',
                torch.equal(got, again))
    want = hashgrid_cuda.hashgrid_encode_point_grad_plain(*args)
    # Same terms in another order (partial dots reduced across lanes,
    # fused products): within 2 k 2^-24 of each element's terms'
    # magnitudes.
    tol = encoders.point_grad_tolerance(*args)
    err = checks.within(f'K2x {tag} N={n}', got, want, tol)
    del again, want, tol
    ms = _cuda_ms(lambda: hashgrid_cuda._point_grad_call(*args), 20)
    by_kernel = _kernel_ms(lambda: hashgrid_cuda._point_grad_call(*args))
    device_ms = sum_ms = None
    if by_kernel is not None:
        device_ms = sum(by_kernel.values())
        sum_ms = sum(v for k, v in by_kernel.items() if 'level_sum' in k)
    plain_ms = _cuda_ms(
        lambda: hashgrid_cuda.hashgrid_encode_point_grad_plain(*args), 3)
    bound, nbytes = _k2x_bound(encoders, config, x, interp, plan, rows)
    dev_text = ('device not measured' if device_ms is None else
                f'{device_ms:.4f} ms device (level sum {sum_ms:.4f})')
    print(f'kernel K2x [{gpu}] {tag} N={n}: {ms:.4f} ms by events, '
          f'{dev_text}, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms '
          f'({bound[1]}, {nbytes / 1e9:.4f} GB): {bound[0] / ms:.1%}')
    shapes[f'K2x {tag}'] = hashgrid_cuda.point_grad_launch_shape(
        config, n, interp, plan)
    _print_shapes(gpu, {f'{tag} N={n} {kernel}': sh
                        for kernel, sh in shapes[f'K2x {tag}'].items()})
    return dict(ms=ms, device_ms=device_ms, sum_device_ms=sum_ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                bytes=nbytes, share=bound[0] / ms, max_abs_err=err)


def _pose_phase(dev, seed, gpu, checks, results, shapes):
    import shutil
    import numpy as np
    import torch
    from autolabel_tpu_torch import register as register_cli
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.core.dataset import SceneDataset
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.renderer import RenderOptions
    from autolabel_tpu_torch.train import __main__ as train_cli
    from autolabel_tpu_torch.train import pose_refine
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    from autolabel_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 16)
    name = hashgrid_cuda.POINT_GRAD_NAME
    out = {'forms': {}}

    # (a) K2x against its plain version in each form, N = POSE_N
    for tag, config, interp, stochastic in _k2x_forms():
        out['forms'][tag] = _k2x_form(
            checks, gpu, shapes, tag,
            _k2x_inputs(gen, dev, config, interp, stochastic))
        torch.cuda.empty_cache()
    main_form = out['forms']['TPU_GRID simplex']
    results['K2x'] = dict(
        max_abs_err=max(f['max_abs_err'] for f in out['forms'].values()),
        ms=main_form['ms'], device_ms=main_form['device_ms'],
        plain_ms=main_form['plain_ms'],
        bound=(main_form['bound_ms'], main_form['bound_by']),
        library_ms=None, forms=out['forms'])

    # (b) one registration step on phase 5's model, kernels against the
    # plain versions: same params, pixels and delta
    field = Field(_model_config(), device=dev, generator=gen)
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=gen) * 0.5)
    pos = (2.2, 2.6, -0.4)
    frame = _scene_frame(rays, pos)
    pick = np.random.default_rng(seed + 16).choice(FRAME_W * FRAME_H, 2048,
                                                   replace=False)
    dirs_cam, norms = rays.compute_directions(
        np.eye(3), pick, FRAME_W, 400.0, 400.0, FRAME_W / 2, FRAME_H / 2)

    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    reg_in = (on_card(frame['pixels'].reshape(-1, 3)[pick]),
              on_card(dirs_cam), on_card(norms),
              on_card(_look_at(pos)), on_card(pos))
    depth = on_card(frame['depth'].reshape(-1)[pick])
    delta0 = {'rot': on_card([0.01, -0.02, 0.015]),
              't': on_card([0.02, -0.01, 0.03])}
    reg_opts = RenderOptions(num_steps=64, proposal_steps=32, perturb=False)

    def reg_step(reg_field=field, inputs=reg_in, d=None):
        delta = {k: v.clone().requires_grad_(True)
                 for k, v in (d or delta0).items()}
        with pose_refine.frozen(reg_field):
            loss = pose_refine.registration_loss(reg_field, delta, *inputs,
                                                 reg_opts, depth)
            grads = torch.autograd.grad(loss, [delta['rot'], delta['t']])
        return loss.detach(), torch.cat(grads)

    _kernels.reset_launches()
    loss_k, grad_k = reg_step()
    torch.cuda.synchronize()
    step_launches = dict(_kernels.launches)
    # The plain run keeps K4f: the proposal's densities place the main
    # samples by inverse CDF, and a bf16 rounding apart there moves
    # samples across bins, which moves the pose gradient at a kink of the
    # placement (seen: 10.6% of its norm on one seed, 0.2% on another).
    # K4f is held against its plain version in phase 4.
    fused_mlp3 = heads_cuda.fused_mlp3
    _kernels.reset_launches()
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        heads_cuda.fused_mlp3 = fused_mlp3
        loss_p, grad_p = reg_step()
    torch.cuda.synchronize()
    plain_launches = dict(_kernels.launches)
    checks.true('register step plain run launches K4f alone',
                plain_launches == {heads_cuda.MLP3: 1}, str(plain_launches))
    # and the fp32 plain versions throughout, the reference both are held
    # to: the bf16 heads put each about 5% of the norm from it
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        heads_cuda.fused_heads = heads_cuda.fused_heads_plain
        heads_cuda.fused_mlp3 = fused_mlp3
        _, grad_fp32 = reg_step()
    # PERF.md section 2's step bars: bf16 operands in the heads on both
    # sides, rounded at other places.
    checks.close('register step loss', loss_k, loss_p, atol=1e-6, rtol=2e-2)
    out['step_grad_rel_err'] = checks.rel_norm('register step grad (rot, t)',
                                               grad_k, grad_p, 5e-2)
    out['step_grad_fp32'] = checks.no_worse(
        'register step grad (rot, t) against the fp32 plain versions',
        grad_k, grad_p, grad_fp32, 1e-6, 1.5)
    # The proposal net's weights place the samples through a
    # stop-gradient (as JAX's renderer.py:241) and registration has no
    # interlevel loss, so K4b does not run.
    want_step = {hashgrid_cuda.NAME: 1, name: 1, heads_cuda.HEADS: 1,
                 heads_cuda.HEADS_BWD: 1, heads_cuda.MLP3: 1,
                 heads_cuda.MLP3_BWD: 0, hashgrid_cuda.BWD_NAME: 0}
    for kernel, count in want_step.items():
        checks.true(f'register step launches {kernel}',
                    step_launches.get(kernel, 0) == count,
                    f'{step_launches.get(kernel, 0)} (expected {count})')
    out['step_launches'] = step_launches
    del field
    torch.cuda.empty_cache()

    # (c) the register CLI at its defaults on a room trained at full width
    root = os.path.join(WORK_DIR, 'pose')
    shutil.rmtree(root, ignore_errors=True)
    scene = os.path.join(root, 'room')
    fixtures.make_room_scene(scene, **POSE_SCENE)
    t0 = time.perf_counter()
    trained = train_cli.main([scene, '--iters', str(POSE_TRAIN_ITERS)]
                             + POSE_TRAIN)
    torch.cuda.synchronize()
    out['train_s'] = time.perf_counter() - t0
    print(f'pose room [{gpu}]: {POSE_SCENE["n_frames"]} frames of '
          f'{POSE_SCENE["width"]} x {POSE_SCENE["height"]}, trained '
          f'{POSE_TRAIN_ITERS} iterations through the train CLI '
          f'({" ".join(POSE_TRAIN)}) in {out["train_s"]:.1f} s')
    stamps, captured = [], {}
    register_camera = register_cli.register_camera

    def timed(reg_field, pixels, dirs, norms_, R0, t0_, **kw):
        captured.update(field=reg_field, inputs=(
            on_card(pixels), on_card(dirs), on_card(norms_).reshape(-1, 1),
            on_card(R0), on_card(t0_)), depth=kw.get('depth'))

        def stamp(i, loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        stamps.append(time.perf_counter())
        return register_camera(reg_field, pixels, dirs, norms_, R0, t0_,
                               callback=stamp, **kw)

    register_cli.register_camera = timed
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with _first_point_grad(hashgrid_cuda, {}) as reg_k2x:
            reg = register_cli.main([scene, '--model-dir', trained.model_dir,
                                     '--frame-index', str(POSE_FRAME)]
                                    + POSE_PERTURB)
        torch.cuda.synchronize()
        out['register_s'] = time.perf_counter() - t0
    finally:
        register_cli.register_camera = register_camera
    reg_launches = dict(_kernels.launches)
    iters = int(register_cli.read_args(['s', '--model-dir', 'm']).iters)
    iter_ms = np.diff(stamps) * 1e3
    out['iter_ms'] = _quartiles(iter_ms)
    ds = SceneDataset('test', scene, factor=1.0, batch_size=512, lazy=True,
                      load_semantic=False)
    R_gt = np.asarray(ds.rotations[POSE_FRAME], np.float64)
    t_gt = np.asarray(ds.origins[POSE_FRAME], np.float64)

    def rot_err(R):
        return float(np.degrees(np.arccos(np.clip(
            (np.trace(np.asarray(R, np.float64) @ R_gt.T) - 1) / 2, -1, 1))))

    errors = dict(rot_deg=(rot_err(reg.R0), rot_err(reg.R)),
                  t_m=(float(np.linalg.norm(reg.t0 - t_gt)),
                       float(np.linalg.norm(reg.t - t_gt))))
    out['errors'] = errors
    for key, (before, after) in errors.items():
        checks.true(f'register CLI halves the {key} error',
                    after < 0.5 * before, f'{before:.4f} -> {after:.4f}')
    want_reg = {hashgrid_cuda.ATOMS_NAME: iters, name: iters,
                heads_cuda.HEADS: iters, heads_cuda.HEADS_BWD: iters,
                heads_cuda.MLP3: iters, heads_cuda.MLP3_BWD: 0,
                hashgrid_cuda.SAMPLED_BWD_NAME: 0}
    for kernel, count in want_reg.items():
        checks.true(f'register CLI launches {kernel}',
                    reg_launches.get(kernel, 0) == count,
                    f'{reg_launches.get(kernel, 0)} (expected {count})')
    out['register_launches'] = reg_launches
    # the busy share of POSE_TRACED iterations of the same registration
    reg_field, inputs = captured['field'], captured['inputs']
    depth = None if captured['depth'] is None else on_card(captured['depth'])
    delta_out = {'rot': on_card(np.zeros(3)), 't': on_card(np.zeros(3))}

    def iterations():
        for _ in range(POSE_TRACED):
            reg_step(reg_field, inputs, delta_out)

    iterations()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iterations()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_profile(iterations)
    out['busy_ms'], out['traced_wall_ms'] = busy, wall
    if rows is None:
        print('register profile: the trace holds no device time: not '
              'measured')
    else:
        print(f'register profile [{gpu}]: device busy {busy:.3f} ms of '
              f'{wall:.3f} ms wall over {POSE_TRACED} iterations: busy share '
              f'{busy / wall:.4f}')
        for kname, ms, count in rows[:10]:
            print(f'  {ms:9.3f} ms {ms / busy:7.2%} x{count:<5d} '
                  f'{kname[:90]}')
    print(f'register CLI [{gpu}]: {len(iter_ms)} iterations (--iters '
          f'{iters}), {out["iter_ms"]["median"]:.3f} ms an iteration (p50; '
          f'q1 {out["iter_ms"]["q1"]:.3f}, q3 {out["iter_ms"]["q3"]:.3f}), '
          f'{out["register_s"]:.2f} s the CLI; rotation error '
          f'{errors["rot_deg"][0]:.3f} -> {errors["rot_deg"][1]:.3f} deg, '
          f'translation {errors["t_m"][0] * 100:.2f} -> '
          f'{errors["t_m"][1] * 100:.2f} cm; final loss {reg.loss:.5f}; '
          'launches ' + ', '.join(f'{k} {v}' for k, v in
                                  sorted(reg_launches.items())))
    del reg_field, captured, inputs
    # K2x on what the CLI's first iteration handed it: TPU_GRID simplex,
    # the ray-ordered main samples of 2,048 rays, K1s's atoms as rows
    out['forms']['registration iteration'] = _k2x_form(
        checks, gpu, shapes, 'registration iteration', reg_k2x['args'])
    results['K2x']['max_abs_err'] = max(
        f['max_abs_err'] for f in out['forms'].values())
    del reg_k2x
    torch.cuda.empty_cache()

    # (d) joint refinement through the train CLI, the flagship estimator's
    # flags (pose refinement makes the encode exact)
    windows = set()
    step_options = SimpleTrainer.step_options

    def recording(self, step=None):
        options = step_options(self, step)
        windows.add(options.level_window)
        return options

    SimpleTrainer.step_options = recording
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        joint = train_cli.main([scene, '--iters', str(POSE_JOINT_ITERS),
                                '--workspace', os.path.join(root, 'joint'),
                                '--pose-refine-experimental'] + POSE_TRAIN)
        torch.cuda.synchronize()
        out['joint_s'] = time.perf_counter() - t0
    finally:
        SimpleTrainer.step_options = step_options
    joint_launches = dict(_kernels.launches)
    levels = TPU_GRID.n_levels
    want_windows = {(1.0,) * (k + 1) + (0.0,) * (levels - 1 - k)
                    for k in range(levels)} | {None}
    checks.true('joint refinement entered every level window',
                want_windows <= windows, str(sorted(map(str, windows))))
    saved_path = os.path.join(joint.model_dir, 'poses_refined.npz')
    checks.true('joint refinement wrote poses_refined.npz',
                os.path.exists(saved_path))
    saved = np.load(saved_path)
    R0s = np.asarray(joint.dataset.rotations)
    t0s = np.asarray(joint.dataset.origins)
    anchor = max(float(np.abs(saved['R'][0] - R0s[0]).max()),
                 float(np.abs(saved['t'][0] - t0s[0]).max()))
    checks.true('joint refinement keeps frame 0', anchor <= 1e-6,
                f'{anchor:.3e}')
    pose = {k: v.detach().cpu().numpy() for k, v in
            joint.trainer.pose.items()}
    moved = min(float(np.abs(pose['rot'][1:]).max()),
                float(np.abs(pose['t'][1:]).max()))
    checks.true('joint refinement moved the other deltas, finite',
                moved > 0 and all(np.isfinite(v).all()
                                  for v in pose.values()),
                f'{moved:.3e}')
    out['joint_launches'] = joint_launches
    out['joint_moved'] = {k: float(np.abs(v[1:]).max())
                          for k, v in pose.items()}
    print(f'joint refinement [{gpu}]: {POSE_JOINT_ITERS} steps in '
          f'{out["joint_s"]:.1f} s ({out["joint_s"] / POSE_JOINT_ITERS * 1e3:.2f}'
          f' ms a step with the CLI around it); largest delta rot '
          f'{out["joint_moved"]["rot"]:.3e} t {out["joint_moved"]["t"]:.3e}; '
          'launches ' + ', '.join(f'{k} {v}' for k, v in
                                  sorted(joint_launches.items())))
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'phase 16: {out["phase_s"]:.1f} s')
    out['names'] = {'K2x': name}
    return out


# Phase 17: the teacher towers. The trainer runs at the train_demo_teacher
# CLI's defaults on a room of make_room_scene's defaults (96 frames of
# 160 x 120); the towers at compute_feature_maps' sizes for a 1280 x 960
# scene (phase 15's room, made anew when absent), a batch of 2.
TEACHER_TRACED = 5
TOWER_SCENE = BACKEND_SCENE
TOWER_BATCH = 2
TOWER_REPS = 5
TEXT_PROMPTS = 606  # the language CLI's ScanNet label set
# tests/test_demo_clip.py's held-out phrasings and its bar
HELDOUT = {1: 'a wall with checkers', 2: 'sphere colored red',
           3: 'box colored green', 4: 'sphere colored blue',
           5: 'pillar colored yellow'}
HELDOUT_MIN_ACC = 0.8
# fp32 towers against the same module in float64 on the card. On an
# NVIDIA H100 80GB HBM3 at 700 W, phase 17's fp32 readings are at most
# 2.3e-6 by relative norm and 5.1e-6 by largest element, TF32's at least
# 2.6e-4 and 9.0e-4: each limit sits about 10x above fp32 and 10x below
# TF32, and the same forward with TF32 allowed must miss both (the
# control)
WITNESS_REL_NORM = 2e-5
WITNESS_MAX = 5e-5  # of the witness's largest magnitude
PEAK_TF32 = 495e12


def _text_flops(config, batch):
    n, w = config.context_length, config.width
    block = 2 * n * w * 12 * w + 4 * n * n * w
    return batch * (config.depth * block + 2 * w * config.embed_dim)


def _pixel_flops(params, batch, h, w):
    oh, ow = -(-h // 2), -(-w // 2)
    return batch * sum(2 * oh * ow * p.shape[0] * p.shape[1] * p.shape[2]
                       * p.shape[3] for p in params.values())


def _tower(dev, gpu, checks, tag, run, forward, params, inputs, flops):
    """One tower at full width: `run()` is the extractor's call (timed by
    events, traced once, its peak memory); `forward(params, inputs)` the
    fp32 forward it runs, held against float64 on the card. The same
    forward with TF32 allowed is timed (the precision's cost) and held
    against float64 too: it must miss both limits, or they could not tell
    a tower that lost full precision. Where cuDNN and cuBLAS keep fp32
    algorithms with TF32 allowed, its output is the fp32 one bit for bit
    and there is nothing to tell."""
    import torch

    from autolabel_tpu_torch import bridge
    from autolabel_tpu_torch.features.layers import full_precision
    out = {'flops': flops}
    with torch.no_grad():
        out['ms'] = _cuda_ms(run, TOWER_REPS)
        with full_precision(allow_tf32=True):
            out['ms_tf32'] = _cuda_ms(lambda: forward(params, inputs),
                                      TOWER_REPS)
            tf32 = forward(params, inputs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
        rows, busy = _device_profile(run)
        out['busy_share'] = _print_profile(gpu, f'teacher {tag}', rows,
                                           busy, out['ms'], 'batch')
        out['top_kernels'] = [(name[:90], ms) for name, ms, _ in
                              (rows or [])[:8]]
        with full_precision():
            got = forward(params, inputs)
        wide = bridge.tree_from_numpy(params, dev, torch.float64)
        want = forward(wide, inputs.double() if inputs.is_floating_point()
                       else inputs)
        del wide
    out['rel_norm'] = checks.rel_norm(
        f'teacher {tag} fp32 against float64', got, want, WITNESS_REL_NORM)
    scale = want.abs().max().clamp(min=1e-30)
    out['max_rel'] = float((got.double() - want).abs().max() / scale)
    checks.true(f'teacher {tag} largest element against float64',
                out['max_rel'] <= WITNESS_MAX,
                f'{out["max_rel"]:.3e} of max|want| (tol {WITNESS_MAX})')
    out['tf32_engaged'] = not torch.equal(tf32, got)
    out['rel_norm_tf32'] = float((tf32.double() - want).norm()
                                 / want.norm().clamp(min=1e-30))
    out['max_rel_tf32'] = float((tf32.double() - want).abs().max() / scale)
    checks.true(f'teacher {tag} TF32 control misses the float64 limits',
                not out['tf32_engaged'] or (
                    out['rel_norm_tf32'] > WITNESS_REL_NORM
                    and out['max_rel_tf32'] > WITNESS_MAX),
                f'TF32 rel_err={out["rel_norm_tf32"]:.3e} (limit '
                f'{WITNESS_REL_NORM}), largest element '
                f'{out["max_rel_tf32"]:.3e} (limit {WITNESS_MAX})'
                + ('' if out['tf32_engaged'] else
                   '; TF32 changed nothing: fp32 algorithms kept'))
    del got, want, tf32
    out['tflops'] = flops / out['ms'] / 1e9
    out['peak_share'] = flops / (out['ms'] * 1e-3) / PEAK_FP32
    out['peak_share_tf32'] = flops / (out['ms_tf32'] * 1e-3) / PEAK_TF32
    print(f'teacher {tag} [{gpu}]: {out["ms"]:.3f} ms a batch fp32 '
          f'({out["tflops"]:.2f} TFLOP/s, {out["peak_share"]:.2%} of the '
          f'fp32 peak), {out["ms_tf32"]:.3f} ms with TF32 '
          f'({out["peak_share_tf32"]:.2%} of the TF32 peak); '
          f'{flops / 1e9:.1f} GFLOP; peak memory '
          f'{out["peak_bytes"] / 1e9:.3f} GB')
    torch.cuda.empty_cache()
    return out


def _teacher_phase(dev, seed, gpu, checks):
    """Phase 17 (see the module docstring); returns what the output file
    keeps."""
    import importlib.util
    import shutil

    import numpy as np
    import torch
    from autolabel_tpu_torch import bridge, evaluation, model_utils
    from autolabel_tpu_torch import compute_feature_maps as cfm
    from autolabel_tpu_torch import train_demo_teacher as teacher_cli
    from autolabel_tpu_torch.features import (clip_text, demo_clip, dino,
                                              fcn, layers, lseg_tower, vit)
    from autolabel_tpu_torch.language import evaluate as language_cli
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.train import checkpoints
    from autolabel_tpu_torch.utils import Scene, fixtures
    from autolabel_tpu_torch.utils.images import read_png
    phase_start = time.perf_counter()
    root = os.path.join(WORK_DIR, 'teachers')
    shutil.rmtree(root, ignore_errors=True)
    out = {}

    # (a) DemoCLIP trained on the card through the CLI
    room = os.path.join(root, 'room')
    t0 = time.perf_counter()
    fixtures.make_room_scene(room)
    out['room_s'] = time.perf_counter() - t0
    step = demo_clip.DemoTeacherTrainer.step
    stamps, last = [], []

    def stamped(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(self)
        end.record()
        stamps.append((start, end))
        last[:] = [loss]
        return loss

    demo_clip.DemoTeacherTrainer.step = stamped
    try:
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        teacher = teacher_cli.main([room], dev)
        _sync()
        cli_s = time.perf_counter() - t0
    finally:
        demo_clip.DemoTeacherTrainer.step = step
    flags = teacher_cli.read_args([room])
    a = {'cli_s': cli_s, 'iters': flags.iters,
         'final_loss': float(last[0]),
         'peak_bytes': torch.cuda.max_memory_allocated(),
         'step_ms': _quartiles([s.elapsed_time(e) for s, e in stamps])}
    checks.true('teacher trained: steps and a finite final loss',
                len(stamps) == flags.iters
                and np.isfinite(a['final_loss']),
                f'{len(stamps)} steps stamped, loss {a["final_loss"]:.4f}')
    # 5 more steps, traced, against their untraced wall
    trainer = demo_clip.DemoTeacherTrainer(
        room, iters=4 * TEACHER_TRACED, crop=flags.crop, lr=flags.lr,
        seed=flags.seed, frames_stride=flags.frames_stride, device=dev)
    trainer.step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(TEACHER_TRACED):
        trainer.step()
    _sync()
    wall = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_profile(
        lambda: [trainer.step() for _ in range(TEACHER_TRACED)])
    a['busy_share'] = _print_profile(gpu, 'teacher train', rows, busy, wall,
                                     f'{TEACHER_TRACED} steps')
    del trainer
    # held-out phrasings on frame 0
    fe = demo_clip.DemoCLIPFE(teacher, device=dev)
    class_ids = sorted(HELDOUT)
    text = fe.encode_text([HELDOUT[c] for c in class_ids])
    rgb = read_png(os.path.join(room, 'rgb', '0.png'))[..., :3].astype(
        np.float32) / 255.0
    gt = read_png(os.path.join(room, 'gt_semantic', '0.png'))
    feats = fe(rgb.transpose(2, 0, 1)[None])[0].float().cpu().numpy()
    pred = np.argmax(feats @ text.T, axis=-1)
    gt_ds = gt[::demo_clip.STRIDE, ::demo_clip.STRIDE][:feats.shape[0],
                                                        :feats.shape[1]]
    remap = {c: i for i, c in enumerate(class_ids)}
    gt_idx = np.vectorize(lambda v: remap.get(v, -1))(gt_ds)
    valid = gt_idx >= 0
    a['heldout_acc'] = float((pred[valid] == gt_idx[valid]).mean())
    checks.true('teacher held-out prompts classify frame 0',
                a['heldout_acc'] > HELDOUT_MIN_ACC,
                f'accuracy {a["heldout_acc"]:.4f} (bar {HELDOUT_MIN_ACC})')
    print(f'teacher train [{gpu}]: CLI {cli_s:.2f} s for {flags.iters} '
          f'iterations (crop {flags.crop}, batch {demo_clip.BATCH}, frames '
          f'stride {flags.frames_stride}); ms a step {a["step_ms"]}; '
          f'final loss {a["final_loss"]:.4f}; held-out accuracy '
          f'{a["heldout_acc"]:.4f}; peak memory '
          f'{a["peak_bytes"] / 1e9:.3f} GB; room {out["room_s"]:.1f} s')
    out['train'] = a

    # (b) every tower at full width, seeded weights
    scene = os.path.join(WORK_DIR, 'backend', 'room')
    if not os.path.exists(os.path.join(scene, 'rgb')):
        scene = os.path.join(root, 'room_1280')
        fixtures.make_room_scene(scene, **TOWER_SCENE)
    paths = Scene(scene).rgb_paths()
    gen = torch.Generator().manual_seed(seed + 17)

    def frames(feature):
        size = cfm.compute_size(paths[0], feature)
        return torch.as_tensor(np.stack(
            [cfm.load_frame(p, size) for p in paths[:TOWER_BATCH]]),
            device=dev)

    def size(x):
        return f'{x.shape[2]}x{x.shape[3]}'

    towers = {}
    x720, x242 = frames('dino'), frames('demo')
    dino_config = vit.DINO_VITS8
    dino_params = vit.init_params(gen, dino_config, device=dev)
    dino_fe = dino.Dino(params=dino_params, device=dev, config=dino_config)
    hp, wp = x720.shape[2] // 8, x720.shape[3] // 8
    towers['dino'] = _tower(
        dev, gpu, checks, f'DINO ViT-S/8 {size(x720)}', lambda: dino_fe(x720),
        lambda p, x: vit.encode_image(p, layers.normalise(x), dino_config),
        dino_params, x720, vit.flops(dino_config, TOWER_BATCH, hp, wp))
    fcn_params = fcn.init_params(gen, device=dev)
    fcn_fe = fcn.FCN(fcn_params, dev)
    towers['fcn'] = _tower(
        dev, gpu, checks, f'FCN-ResNet50 {size(x720)}', lambda: fcn_fe(x720),
        fcn.fcn_features, fcn_params, x720,
        fcn.flops(fcn_params, TOWER_BATCH, *x720.shape[2:]))
    del fcn_params, fcn_fe
    lseg_config = lseg_tower.LSEG_VITL16
    lseg_params = lseg_tower.init_params(gen, lseg_config, device=dev)
    lseg_fe = lseg_tower.LSegImageEncoder(lseg_params, lseg_config, dev)
    half = lseg_tower.half_size(x242 * 2.0 - 1.0)
    towers['lseg'] = _tower(
        dev, gpu, checks,
        f'LSeg ViT-L/16+DPT {size(x242)} (run at {size(half)})',
        lambda: lseg_fe(x242),
        lambda p, x: lseg_tower.compute_features(p, x, lseg_config),
        lseg_params, half, lseg_tower.flops(lseg_config, TOWER_BATCH,
                                            *half.shape[2:]))
    del lseg_params, lseg_fe
    towers['pixel'] = _tower(
        dev, gpu, checks, f'DemoCLIP pixel {size(x242)}', lambda: fe(x242),
        lambda p, x: demo_clip.apply_pixel_tower(p, x.permute(0, 2, 3, 1)),
        fe.params['pixel'], x242,
        _pixel_flops(fe.params['pixel'], TOWER_BATCH, *x242.shape[2:]))
    config = clip_text.CLIP_VIT_B
    text_params = clip_text.init_params(gen, config, device=dev)
    lengths = torch.randint(2, 12, (TEXT_PROMPTS,), generator=gen)
    tokens = torch.randint(1, config.vocab_size - 2,
                           (TEXT_PROMPTS, config.context_length),
                           generator=gen)
    tokens[torch.arange(config.context_length)[None] > lengths[:, None]] = 0
    tokens[torch.arange(TEXT_PROMPTS), lengths] = config.vocab_size - 1
    tokens = tokens.to(dev)
    towers['clip_text'] = _tower(
        dev, gpu, checks, f'CLIP ViT-B text {TEXT_PROMPTS}x77',
        lambda: clip_text.encode_tokens(text_params, tokens, config),
        lambda p, t: clip_text.encode_tokens(p, t, config), text_params,
        tokens, _text_flops(config, TEXT_PROMPTS))
    del text_params
    out['towers'] = towers

    # (c) the language CLI with the trained teacher, no --allow-fallback
    eval_scene = os.path.join(WORK_DIR, 'eval', 'sphere')
    lflags = model_utils.model_flag_parser().parse_args(
        ['--features', 'demo', '--feature-dim', '512'])
    bbox = np.loadtxt(os.path.join(eval_scene, 'bbox.txt'))
    lgen = torch.Generator().manual_seed(seed + 14)
    field = model_utils.create_model(bbox[:3], bbox[3:6],
                                     language_cli.SCANNET_N_CLASSES, lflags,
                                     device=dev, generator=lgen)
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=lgen) * 0.5)
    language_root = os.path.join(root, 'language')
    ws = os.path.join(language_root, 'sphere', model_utils.model_hash(lflags))
    tree = bridge.params_to_numpy(field)
    checkpoints.save_checkpoint(os.path.join(ws, 'checkpoints', 'best.pth'),
                                {'params': tree, 'ema': tree, 'step': 0},
                                include_optimizer=False)
    model_utils.write_params(ws, lflags)
    del field, tree
    label_map = os.path.join(root, 'label_map.csv')
    with open(label_map, 'w') as f:
        f.write(LABEL_MAP)
    encoded = []
    encode_text = demo_clip.DemoCLIPFE.encode_text

    def recording(self, prompts):
        emb = encode_text(self, prompts)
        encoded.append((list(prompts), emb))
        return emb

    demo_clip.DemoCLIPFE.encode_text = recording
    scores_path = os.path.join(root, 'language.json')
    try:
        _sync()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        language_cli.main([eval_scene, '--workspace', language_root,
                           '--label-map', label_map, '--feature-checkpoint',
                           teacher, '--out', scores_path], dev)
        _sync()
        c = {'wall_s': time.perf_counter() - t0,
             'launches': dict(_kernels.launches)}
    finally:
        demo_clip.DemoCLIPFE.encode_text = encode_text
    with open(scores_path) as f:
        c['scores'] = json.load(f)
    values = [v for record in c['scores']['iou'] + c['scores']['acc']
              for v in record.values()]
    checks.true('teacher language CLI scores in [0, 1]',
                len(c['scores']['iou']) == 1 and values
                and all(v is None or 0.0 <= v <= 1.0 for v in values),
                f'{c["scores"]}')
    prompts, emb = encoded[0]
    ref = demo_clip.DemoCLIPFE(teacher, device='cpu').encode_text(prompts)
    c['text_max_abs'] = float(np.abs(emb - ref).max())
    checks.true('teacher language CLI text against DemoCLIPFE on the CPU',
                c['text_max_abs'] <= 1e-5,
                f'{prompts}: max |d| {c["text_max_abs"]:.3e} (tol 1e-5)')
    print(f'teacher language CLI [{gpu}]: {c["scores"]}; {c["wall_s"]:.3f} '
          f's; launches {c["launches"]}')
    out['language'] = c

    # (d) compute_feature_maps' extraction and compression, demo and dino
    d = {}
    for name, extractor, argv in (
            ('demo', fe, ['--checkpoint', teacher]),
            ('dino', dino_fe, [])):
        cflags = cfm.read_args([scene, '--features', name, '--autoencode']
                               + argv)
        timings = []
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        maps = cfm.extract_features(extractor, Scene(scene), cflags, dev,
                                    timings)
        _sync()
        total = time.perf_counter() - t0
        extract = sum(s for _, s in timings)
        n = len(paths)
        d[name] = {'s_a_frame': total / n, 'extract_s_a_frame': extract / n,
                   'compress_s': total - extract, 'shape': list(maps.shape),
                   'peak_bytes': torch.cuda.max_memory_allocated()}
        checks.true(f'teacher compute_feature_maps {name} codes',
                    maps.shape[0] == n and maps.shape[-1] == cflags.dim
                    and bool(torch.isfinite(maps.float()).all()),
                    f'{tuple(maps.shape)} {maps.dtype}')
        print(f'teacher compute_feature_maps {name} [{gpu}]: '
              f'{total / n:.4f} s a frame ({extract / n:.4f} extraction, '
              f'{total - extract:.3f} s compression of {n} frames; the raw '
              f'maps in host memory; peak card memory '
              f'{d[name]["peak_bytes"] / 1e9:.3f} GB)')
        del maps
    has_h5py = importlib.util.find_spec('h5py') is not None
    print('teacher compute_feature_maps: the features.hdf write is not run '
          + ('(h5py is not installed here)' if not has_h5py else
             '(this phase times extraction and compression only)'))
    out['feature_maps'] = d
    out['phase_s'] = time.perf_counter() - phase_start
    print(f'teacher phase: {out["phase_s"]:.1f} s')
    return out


# Phase 18: mapping. K9 (csrc/ba_normal.cu, bundle adjustment's two LM
# products) held against its plain version (torch.func's vjp and jvp of
# mapping.ba._residual, JAX's mirror) at a final-BA size, in fp32 and
# against the plain version in float64; the whole bundle_adjust in turns
# with the plain products; then IncrementalSfM's cv2-free stages and the
# mapping CLI's ScaleEstimation and PoseSaver on the fixture room.
BA_CAMERAS, BA_POINTS, BA_VIEWS = 300, 40000, 9
BA_INTR = (500.0, 500.0, 320.0, 240.0)
BA_NOISE_PX, BA_OUTLIERS, BA_OUTLIER_PX = 0.5, 0.02, (20.0, 50.0)
BA_PERTURB = (0.002, 0.02, 0.02)  # rad, m, m: poses and points
BA_ITERS, BA_CG = 30, 50
# (c)'s plain legs (torch.func on the card, host-bound: 22-38 s for 30 LM
# steps) run this many LM steps, and so does the K9 solve held against them
BA_PLAIN_ITERS = 10
BA_TOL = 1e-5  # K9 against the plain fp32 version, by relative norm
BA_ROOM = 2.0  # K9's float64 error at most this times the plain fp32's
BA_RMS_TOL = 1e-3  # px, the kernel solve's final rms against the plain's
BA_SOLVE_TOL = 1e-4  # K9's fused solve's delta against the torch CG loop's
BA_REPS = 20
# K9's fp32 operations an observation, counted from csrc/ba_normal.cu's
# kernel bodies with refine_focal off: an fma 2, any other add, multiply
# or divide 1, and a sum into a camera, a point or the cost 1 an addend,
# however the kernel reduces it (the warp scan's extra adds are not work
# the function needs). project: Xc, 3 rows of a multiply, 2 fma and an
# add (18), fx and fy (2), u and v (2); tangents: dR/drvec X, 9 entries of
# a multiply and 2 fma; jv: R v_p (15), A v_r + v_t added to it (21), the
# two rows (10); weight: sqrt_w J v (2); scatter: e (2), gx (8), A^T gx
# (15), R^T gx (15), the point's 3 and the camera's 6 sums; residual: 2
# rows of 4; cost: r^2 (3) and its sum (1). The matvec's damp_kernel adds
# a multiply a parameter.
K9_FLOPS = {
    'matvec': dict(project=22, tangents=45, jv=46, weight=2, scatter=49),
    'residual_grad': dict(project=22, residual=8, cost=4, tangents=45,
                          scatter=49)}
# The solve's bound, from what its rule needs: a CG iteration moves a
# product's bytes (the matvec's count, which holds the read of q and the
# write of Aq; q . Aq is taken as Aq is written) and makes 9 passes over
# the L-vectors beyond it: q_{k+1} = r + beta q_k (r and q_k read, q_{k+1}
# written: 3) and x, r updated (x, q, r and Aq read, x and r written: 6;
# r . r taken as r is written). It does a product's operations, lam q (1
# a parameter) and 10 a parameter (the two dots' multiply-adds, the two
# updates' fma, q_{k+1}'s fma); counted for the iterations this run's
# data took.
K9_CG_VECTOR_PASSES = 9
K9_CG_VECTOR_FLOPS = 10
MAP_TRACK_POINTS, MAP_NOISE_PX = 4000, 0.3
MAP_PERTURB = (0.005, 0.02, 0.02)  # rad, m, m


def _ba_look(a, height):
    """A camera on the arc at angle a, looking at the origin: (R, t),
    world -> camera. At a = 0 and height 0, R is the identity exactly
    (theta = 0, rodrigues' Taylor branch)."""
    import numpy as np
    C = np.array([4.0 * np.sin(a), height, -4.0 * np.cos(a)])
    z = -C / np.linalg.norm(C)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ C


def _ba_problem(seed):
    """A final-BA-sized problem: BA_CAMERAS cameras on a seeded arc of 120
    degrees around BA_POINTS points in a ball of radius 1.2, each point
    seen by BA_VIEWS consecutive cameras, 0.5 px noise and 2% outliers at
    20-50 px. Camera BA_CAMERAS // 2 sits at theta = 0. Returns the truth, the perturbed
    start and the observations."""
    import numpy as np
    from autolabel_tpu_torch.mapping.ba import rotmat_to_rvec
    m, p, views = BA_CAMERAS, BA_POINTS, BA_VIEWS
    rng = np.random.default_rng(seed)
    angles = (np.arange(m) - m // 2) * (2 * np.pi / 3) / m
    poses = [_ba_look(a, 0.3 * np.sin(3 * a)) for a in angles]
    rvecs = np.stack([rotmat_to_rvec(R) for R, _ in poses])
    tvecs = np.stack([t for _, t in poses])
    assert not rvecs[m // 2].any()
    d = rng.normal(size=(p, 3))
    points = d / np.linalg.norm(d, axis=1, keepdims=True) \
        * 1.2 * rng.random((p, 1)) ** (1 / 3)
    first = rng.integers(0, m - views + 1, p)
    cam_idx = (first[:, None] + np.arange(views)).ravel()
    pt_idx = np.repeat(np.arange(p), views)
    R_all = np.stack([R for R, _ in poses])
    Xc = np.einsum('nij,nj->ni', R_all[cam_idx], points[pt_idx]) \
        + tvecs[cam_idx]
    fx, fy, cx, cy = BA_INTR
    xy = Xc[:, :2] / Xc[:, 2:3] * [fx, fy] + [cx, cy]
    xy += rng.normal(scale=BA_NOISE_PX, size=xy.shape)
    bad = rng.random(len(xy)) < BA_OUTLIERS
    ang = rng.uniform(0, 2 * np.pi, len(xy))
    mag = rng.uniform(*BA_OUTLIER_PX, len(xy))
    xy += bad[:, None] * mag[:, None] * np.stack([np.cos(ang), np.sin(ang)],
                                                 1)
    dr, dt, dp = BA_PERTURB
    start = (rvecs + rng.normal(scale=dr, size=rvecs.shape),
             tvecs + rng.normal(scale=dt, size=tvecs.shape),
             points + rng.normal(scale=dp, size=points.shape))
    start[0][0], start[1][0] = rvecs[0], tvecs[0]  # the gauge anchor
    start[0][m // 2] = 0.0  # theta = 0 in every linearisation
    return dict(truth=(rvecs, tvecs, points), start=start, cam_idx=cam_idx,
                pt_idx=pt_idx, xy=xy, bad=bad)


def _clamp_problem():
    """K9 at the depth clamp: camera 1 at theta = 0 with t = (0, 0,
    1e-6); point 0 behind it (its observation clamped), point 1 at z = 0
    (z = 1e-6 exactly in fp32: a tie, half the gradient), points 2-5 in
    front; all seen by cameras 0-2, weighted by Huber as bundle_adjust
    weighs them (the clamped residuals are of order 1e8 px). Not held
    against float64: there 1e-6 is no longer fp32's, and the tie and the
    clamp fall elsewhere."""
    import numpy as np
    rv = np.array([[0.1, -0.2, 0.05], [0.0, 0.0, 0.0], [0.02, 0.3, -0.1]])
    tv = np.array([[0.1, 0.0, 3.0], [0.0, 0.0, float(np.float32(1e-6))],
                   [-0.5, 0.1, 3.5]])
    pts = np.array([[0.2, -0.1, -0.5], [0.3, 0.2, 0.0], [0.1, 0.1, 1.0],
                    [-0.4, 0.2, 1.5], [0.5, -0.3, 2.0], [0.0, 0.4, 0.8]])
    ci, pi = np.repeat(np.arange(3), 6), np.tile(np.arange(6), 3)
    xy = np.random.default_rng(0).uniform(0, 600, (18, 2))
    return (rv, tv, pts), ci, pi, xy


def _ba_tensors(dev, params, ci, pi, xy):
    """(params, const) on the card in fp32, with unit weights."""
    import numpy as np
    import torch
    f = dict(dtype=torch.float32, device=dev)
    tp = tuple(torch.as_tensor(np.asarray(a), **f) for a in params) \
        + (torch.zeros((), **f),)
    tc = (BA_INTR, torch.as_tensor(ci, dtype=torch.int32, device=dev),
          torch.as_tensor(pi, dtype=torch.int32, device=dev),
          torch.as_tensor(np.asarray(xy), **f), torch.ones(len(ci), **f))
    return tp, tc


def _k9_hold(checks, tag, params, const, v, lam, wide=True):
    """K9's residual, cost, gradient and matvec against the plain fp32
    version (BA_TOL by relative norm) at refine_focal off and on, and
    (wide) against the plain version in float64: K9's error at most
    BA_ROOM times the plain fp32 version's. Returns the largest |K9 -
    plain|."""
    import torch
    from autolabel_tpu_torch.mapping import ba
    p64 = tuple(t.double() for t in params)
    c64 = const[:3] + (const[3].double(), const[4].double())
    worst = 0.0
    for refine in (False, True):
        kern = ba.products(params, const, refine)
        plain = ba.PlainProducts(params, const, refine)
        got = list(kern.residual_grad()) + [kern.matvec(v, lam)]
        ref = list(plain.residual_grad()) + [plain.matvec(v, lam)]
        if wide:
            f64 = ba.PlainProducts(p64, c64, refine)
            ref64 = list(f64.residual_grad()) + [f64.matvec(v.double(), lam)]
        torch.cuda.synchronize()
        for i, name in enumerate(('r', 'cost', 'g', 'matvec')):
            a, b = got[i], ref[i]
            label = f'K9 {tag} {name} refine_focal={refine}'
            # in float64: the clamped rows' products pass fp32's range in
            # a norm
            a64, b64 = a.double().reshape(-1), b.double().reshape(-1)
            err = float((a64 - b64).norm() / b64.norm().clamp(min=1e-300))
            checks.true(label, bool(torch.isfinite(a).all()) and err <= BA_TOL,
                        f'rel_err={err:.3e} |want|={float(b64.norm()):.3e} '
                        f'(tol {BA_TOL})')
            worst = max(worst, float((a - b).abs().max()))
            if not wide:
                continue
            c = ref64[i]
            err_k = float((a.double() - c).norm() / c.norm().clamp(min=1e-300))
            err_p = float((b.double() - c).norm() / c.norm().clamp(min=1e-300))
            checks.true(f'{label} against float64',
                        err_k <= BA_ROOM * err_p or err_k <= 1e-7,
                        f'(K9 {err_k:.3e}, plain fp32 {err_p:.3e}, room '
                        f'{BA_ROOM}, or K9 within 1e-7)')
    return worst


def _csr_jacobian(params, const):
    """J (2N x L, fp32 CSR) and J^T (CSR), built once from K9's analytic
    blocks (mapping.ba's torch mirror), the gauge's columns (the focal's
    among them) zero: the library yardstick's operands."""
    import torch
    from autolabel_tpu_torch.mapping import ba
    prod = ba.AnalyticProducts(params, const, False)
    lin, sw = prod.lin, const[4]
    m, p = prod.m, prod.p
    n = sw.shape[0]
    live = lin['live'].to(torch.float32)
    rows = []
    for i, (f, q) in enumerate(((lin['fx'], lin['u']), (lin['fy'],
                                                        lin['v']))):
        # d pred_i / d Xc = f / z (e_i - q dz e_2)
        dXc = torch.zeros((n, 3), device=sw.device)
        dXc[:, i] = 1.0
        dXc[:, 2] -= q * lin['dz']
        dXc = dXc * (f * sw / lin['z'])[:, None]
        vals = torch.cat([
            (lin['A'] * dXc[:, None, :]).sum(-1) * live[:, None],
            dXc * live[:, None],
            (lin['Rc'] * dXc[:, :, None]).sum(1),
            torch.zeros((n, 1), device=sw.device)], dim=1)
        rows.append(vals)
    vals = torch.stack(rows, dim=1).reshape(2 * n, 10)
    cam, pt = lin['cam'], lin['pt']
    cols = torch.cat([3 * cam[:, None] + torch.arange(3, device=cam.device),
                      3 * m + 3 * cam[:, None]
                      + torch.arange(3, device=cam.device),
                      6 * m + 3 * pt[:, None]
                      + torch.arange(3, device=cam.device),
                      torch.full((n, 1), 6 * m + 3 * p, device=cam.device)],
                     dim=1)
    cols = cols.repeat_interleave(2, dim=0)
    row_idx = torch.arange(2 * n, device=cam.device).repeat_interleave(10)
    coo = torch.sparse_coo_tensor(torch.stack([row_idx, cols.reshape(-1)]),
                                  vals.reshape(-1),
                                  (2 * n, ba.size(m, p)))
    return coo.coalesce().to_sparse_csr(), coo.t().coalesce().to_sparse_csr()


@contextlib.contextmanager
def _plain_ba():
    """bundle_adjust on the card with the plain products (torch.func) and
    the plain residual in place of K9."""
    from autolabel_tpu_torch.mapping import ba
    saved = (ba.products, ba.residual)
    ba.products = lambda params, const, refine_focal, layout=None: \
        ba.PlainProducts(params, const, refine_focal)
    ba.residual = ba._residual
    try:
        yield
    finally:
        ba.products, ba.residual = saved


@contextlib.contextmanager
def _loop_ba():
    """The parent's path: K9's products with the torch CG loop
    (cg(frozen=True), ~30 launches an iteration) around K9's matvec entry
    in place of K9's fused solve."""
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import ba_cuda
    saved = ba_cuda.KernelProducts.cg_solve
    ba_cuda.KernelProducts.cg_solve = ba._TorchSolve.cg_solve
    try:
        yield
    finally:
        ba_cuda.KernelProducts.cg_solve = saved


def _k9_solve_hold(checks, tag, params, const, lam, maxiter, wide=True):
    """K9's fused solve against cg(frozen=True) over K9's matvec entry and
    over the plain products, at refine_focal off and on: bit-equal across
    two calls, k equal, and the delta within BA_SOLVE_TOL of each loop's
    by relative norm (in float64) or, where fp32 rounding moves every fp32
    solve further (refine_focal, whose focal and depths nearly trade off:
    at the final-BA size every fp32 solve lies near 7e-3 from float64, and
    two orders of the product's sums have parted by 1.5e-3), (wide) no
    farther from the float64 solve (cg over the plain products in float64)
    than BA_ROOM times that loop. That rule passes a solve whose product
    is off by a little, so the solve's own product (its first iteration's
    Aq, the focal entry summed over its blocks with refine_focal) is held
    to K9's matvec entry within BA_TOL, as a whole and at the focal entry
    alone. The K9 loop run twice gives that loop's own spread (its point
    atomics add in any order), printed. Returns the largest |solve - K9
    loop| and the relative errors and k by refine_focal."""
    import torch
    from autolabel_tpu_torch.mapping import ba
    rel = lambda a, b: float((a.double() - b.double()).norm()
                             / b.double().norm().clamp(min=1e-300))
    worst, out = 0.0, {}
    for refine in (False, True):
        kern = ba.products(params, const, refine)
        b = -kern.residual_grad()[2]
        x, k = kern.cg_solve(b, lam, maxiter)
        x2, k2 = kern.cg_solve(b, lam, maxiter)
        checks.true(f'K9 solve {tag} bit-equal across two calls refine_focal='
                    f'{refine}', bool(torch.equal(x, x2))
                    and int(k) == int(k2), f'k {int(k)}, {int(k2)}')
        # (in float64: at the clamp the products' norm overflows fp32)
        aq, mv = kern.solve_product(b, lam), kern.matvec(b, lam)
        for what, sl in (('', slice(None)),
                         ('\'s focal entry', slice(-1, None))):
            if what and not refine:
                continue
            err = rel(aq[sl], mv[sl])
            checks.true(f'K9 solve {tag} first product{what} against the '
                        f'matvec entry refine_focal={refine}',
                        bool(torch.isfinite(aq).all()) and err <= BA_TOL,
                        f'rel_err={err:.3e} (tol {BA_TOL}), |want| '
                        f'{float(mv[sl].double().norm()):.3e}')
        legs = {'K9 matvec loop': ba.cg(lambda v: kern.matvec(v, lam), b,
                                        kern.m, kern.p, maxiter,
                                        frozen=True),
                'plain loop': ba.PlainProducts(
                    params, const, refine).cg_solve(b, lam, maxiter)}
        x64 = None
        if wide:
            p64 = tuple(t.double() for t in params)
            c64 = const[:3] + (const[3].double(), const[4].double())
            x64 = ba.PlainProducts(p64, c64, refine).cg_solve(
                b.double(), lam, maxiter)[0]
        torch.cuda.synchronize()
        errs = {}
        for leg, (ref, k_ref) in legs.items():
            err = rel(x, ref)
            room = None if x64 is None else (rel(x, x64), rel(ref, x64))
            ok = err <= BA_SOLVE_TOL or (
                room is not None and room[0] <= BA_ROOM * room[1])
            against = 'not taken' if room is None else (
                f'solve {room[0]:.3e}, loop {room[1]:.3e} (room {BA_ROOM})')
            checks.true(f'K9 solve {tag} against the {leg} refine_focal='
                        f'{refine}', bool(torch.isfinite(x).all()) and ok
                        and int(k) == int(k_ref),
                        f'rel_err={err:.3e} (tol {BA_SOLVE_TOL}), against '
                        f'float64 {against}, k {int(k)} against '
                        f'{int(k_ref)}')
            errs[leg] = dict(rel=err, float64=room, k=int(k_ref))
            if leg == 'K9 matvec loop':
                worst = max(worst, float((x - ref).abs().max()))
        errs['loops'] = rel(legs['K9 matvec loop'][0], legs['plain loop'][0])
        again = ba.cg(lambda v: kern.matvec(v, lam), b, kern.m, kern.p,
                      maxiter, frozen=True)[0]
        errs['loop_self'] = rel(again, legs['K9 matvec loop'][0])
        print(f'K9 solve {tag} refine_focal={refine}: the K9 matvec loop '
              f'against itself rel {errs["loop_self"]:.3e}, against the '
              f'plain loop {errs["loops"]:.3e}')
        out[refine] = dict(k=int(k), legs=errs)
    return worst, out


def _pose_errors(truth, got):
    """Rotation errors (degrees) and camera-centre errors after a Sim(3)
    alignment of the centres to the truth: (median deg, max deg, mean m,
    max m, the alignment's scale)."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.mapping.ba import rodrigues
    R_t = rodrigues(torch.as_tensor(np.asarray(truth[0], np.float64))).numpy()
    R_g = rodrigues(torch.as_tensor(np.asarray(got[0], np.float64))).numpy()
    C_t = -np.einsum('nji,nj->ni', R_t, truth[1])
    C_g = -np.einsum('nji,nj->ni', R_g, np.asarray(got[1], np.float64))
    s, R, t = _umeyama(C_g, C_t)
    err = np.linalg.norm(C_t - (s * C_g @ R.T + t), axis=1)
    # the estimate's rotations in the truth's frame are R_g R^T
    rel = R_t @ R @ np.transpose(R_g, (0, 2, 1))
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    deg = np.degrees(np.arccos(cos))
    return (float(np.median(deg)), float(deg.max()), float(err.mean()),
            float(err.max()), float(s))


def _umeyama(src, dst):
    """Sim(3) aligning src -> dst: (s, R, t) (tests/test_mapping_sfm.py's)."""
    import numpy as np
    mus, mud = src.mean(0), dst.mean(0)
    sc, dc = src - mus, dst - mud
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / ((sc ** 2).sum() / len(src))
    return s, R, mud - s * R @ mus


def _ba_solve(dev, prob, intr, refine_focal, names, iters=BA_ITERS):
    """One bundle_adjust of `iters` LM steps through the entry point:
    (result, seconds, stats, K9 launches by name)."""
    import torch
    from autolabel_tpu_torch.mapping.ba import bundle_adjust
    from autolabel_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = {}
    out = bundle_adjust(*prob['start'], intr, prob['cam_idx'],
                        prob['pt_idx'], prob['xy'], max_iters=iters,
                        refine_focal=refine_focal, cg_iters=BA_CG,
                        device=dev, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: _kernels.launches.get(k, 0) for k in names}
    stats['cg'] = [int(k) for k in stats['cg']]
    return out, seconds, stats, launches


def _room_tracks(scene_dir, rng):
    """Tracks of the fixture room: MAP_TRACK_POINTS surface points
    back-projected from random pixels of random frames' depth, observed in
    every frame where they fall in the image, in front, and unoccluded
    (the frame's depth within 3 cm), with MAP_NOISE_PX of noise; points
    seen fewer than 3 times are dropped. Returns (K, T_CW by frame,
    points, {track: {frame: xy}})."""
    import numpy as np
    from autolabel_tpu_torch.utils import Scene
    from autolabel_tpu_torch.utils.images import read_png
    scene = Scene(str(scene_dir))
    K = scene.camera.camera_matrix
    poses = scene.poses
    depth = [read_png(p) / 1000.0 for p in scene.depth_paths()]
    h, w = depth[0].shape
    frames = rng.integers(0, len(poses), MAP_TRACK_POINTS)
    ys, xs = rng.integers(0, h, MAP_TRACK_POINTS), \
        rng.integers(0, w, MAP_TRACK_POINTS)
    world = []
    for f, y, x in zip(frames, ys, xs):
        z = depth[f][y, x]
        pc = np.array([(x + 0.5 - K[0, 2]) * z / K[0, 0],
                       (y + 0.5 - K[1, 2]) * z / K[1, 1], z])
        T_WC = np.linalg.inv(poses[f])
        world.append(T_WC[:3, :3] @ pc + T_WC[:3, 3])
    world = np.stack(world)
    obs = {t: {} for t in range(len(world))}
    for f, T_CW in enumerate(poses):
        xc = world @ T_CW[:3, :3].T + T_CW[:3, 3]
        uv = xc[:, :2] / np.maximum(xc[:, 2:3], 1e-9) * [K[0, 0], K[1, 1]] \
            + K[:2, 2]
        inside = (xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        for t in np.nonzero(inside)[0]:
            if abs(depth[f][int(uv[t, 1]), int(uv[t, 0])] - xc[t, 2]) < 0.03:
                noisy = uv[t] + rng.normal(scale=MAP_NOISE_PX, size=2)
                if 0 <= noisy[0] < w and 0 <= noisy[1] < h:
                    obs[t][f] = noisy
    keep = [t for t in obs if len(obs[t]) >= 3]
    return K, poses, world[keep], [obs[t] for t in keep]


_NO_CV2_PROBE = '''
import sys
sys.modules['cv2'] = None
import numpy as np
from autolabel_tpu_torch.mapping import IncrementalSfM
sfm = IncrementalSfM([('0.png', np.zeros((8, 8), np.uint8))] * 2, np.eye(3),
                     device=sys.argv[1])
try:
    sfm._build_tracks_klt()
    print('ran')
except ImportError as e:
    print(f'raised: {e}')
'''


def _mapping_phase(dev, seed, gpu, checks, results):
    import shutil
    import numpy as np
    import torch
    from autolabel_tpu_torch.mapping import __main__ as mapping_cli
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.mapping.sfm import IncrementalSfM
    from autolabel_tpu_torch.ops import _kernels, ba_cuda
    from autolabel_tpu_torch.utils import Scene, fixtures
    from autolabel_tpu_torch.utils.images import read_png
    t_phase = time.perf_counter()
    names = ba_cuda.NAMES
    out = {}

    # (a) K9 against the plain version at the final-BA size
    prob = _ba_problem(seed + 18)
    m, p, n = BA_CAMERAS, BA_POINTS, len(prob['cam_idx'])
    order = np.argsort(prob['cam_idx'], kind='stable')  # bundle_adjust's
    ci, pi, xy = (prob['cam_idx'][order], prob['pt_idx'][order],
                  prob['xy'][order])
    params, unit = _ba_tensors(dev, prob['start'], ci, pi, xy)
    sw = ba._huber_sqrt_weights(params, unit, 4.0)
    const = unit[:4] + (sw,)
    gen = torch.Generator().manual_seed(seed + 18)
    v = torch.randn(ba.size(m, p), generator=gen).to(dev)
    lam = 1e-2
    print(f'mapping [{gpu}]: M = {m} cameras, P = {p} points, N = {n} '
          f'observations ({int(prob["bad"].sum())} outliers), Huber weights '
          f'below 1 on {int((sw < 1).sum())}')
    worst = _k9_hold(checks, 'final-BA', params, const, v, lam)
    cp, cc, cpi, cxy = _clamp_problem()
    cparams, cunit = _ba_tensors(dev, cp, cc, cpi, cxy)
    cconst = cunit[:4] + (ba._huber_sqrt_weights(cparams, cunit, 4.0),)
    cv = torch.randn(ba.size(3, 6), generator=gen).to(dev)
    # (its products reach 1e20, so its largest |K9 - plain| is not the
    # kernels line's max_abs_err: that is the final-BA size's)
    _k9_hold(checks, 'clamp+tie', cparams, cconst, cv, 0.0, wide=False)
    # K9's fused solve against the torch CG loop around its matvec entry
    # and around the plain products
    solve_worst, solve_errs = _k9_solve_hold(checks, 'final-BA', params,
                                             const, lam, BA_CG)
    _k9_solve_hold(checks, 'clamp+tie', cparams, cconst, lam, 10, wide=False)
    out['solve_errors'] = solve_errs
    print(f'mapping (a): {time.perf_counter() - t_phase:.1f} s; the solve '
          f'against the loops and float64 by refine_focal {solve_errs}, '
          f'largest |solve - K9 loop| {solve_worst:.3e}')

    # (b) times: each entry by events and device time, the plain version,
    # the CSR yardstick, the bound
    kern = ba.products(params, const, False)
    plain = ba.PlainProducts(params, const, False)
    timing = {}
    for entry, fn in (('matvec', lambda: kern.matvec(v, lam)),
                      ('residual_grad', lambda: kern.residual_grad())):
        ms = _cuda_ms(fn, BA_REPS)
        dev_ms = _kernel_ms(fn) or _kernel_ms(fn)  # a trace may hold none
        timing[entry] = dict(ms=ms, device_ms=None if dev_ms is None
                             else sum(dev_ms.values()),
                             device_split=dev_ms)
    timing['matvec']['plain_ms'] = _cuda_ms(lambda: plain.matvec(v, lam), 5)
    timing['residual_grad']['plain_ms'] = _cuda_ms(
        lambda: ba.PlainProducts(params, const, False).residual_grad(),
        5)
    J, Jt = _csr_jacobian(params, const)
    vm = (v * ba.gauge_mask(m, p, False, dev))[:, None]
    lib = torch.sparse.mm(Jt, torch.sparse.mm(J, vm))[:, 0]
    checks.rel_norm('K9 matvec against the CSR J^T J v + lam v',
                    kern.matvec(v, lam), lib + lam * vm[:, 0], BA_TOL)
    timing['matvec']['library_ms'] = _cuda_ms(
        lambda: torch.sparse.mm(Jt, torch.sparse.mm(J, vm)), BA_REPS)
    timing['residual_grad']['library_ms'] = None
    ins = (kern.R, kern.dR, kern.tvecs, kern.points, kern.dlog_f, kern.cam,
           kern.pt, kern.sw)
    n_blocks = -(-n // ba_cuda.THREADS)
    nbytes = {'matvec': _nbytes(*ins, v, v),
              'residual_grad': _nbytes(*ins, kern.xy, kern.xy, v)
              + 4 * n_blocks}
    flops = {entry: sum(K9_FLOPS[entry].values()) * n
             for entry in ('matvec', 'residual_grad')}
    flops['matvec'] += ba.size(m, p)  # damp_kernel's lam * v
    for entry in ('matvec', 'residual_grad'):
        t = timing[entry]
        t['bound'] = _bound(nbytes[entry], flops[entry], PEAK_FP32)
        t['bytes'] = nbytes[entry]
        share = t['bound'][0] / t['ms']
        print(f'kernel K9 {entry} [{gpu}] N = {n}: {t["ms"]:.4f} ms by '
              f'events, device {t["device_ms"]} ms '
              f'({t["device_split"]}), plain {t["plain_ms"]:.4f} ms, '
              f'library {t["library_ms"]} ms (two torch.sparse.mm of a CSR '
              f'J built once), bound {t["bound"][0]:.4f} ms '
              f'({t["bound"][1]}, {nbytes[entry] / 1e6:.2f} MB): '
              f'{share:.1%} of it')
    # the fused solve in turns with the torch CG loop around the matvec
    # entry (the parent's path), the plain solve, the bound (its parts
    # alone: kernel_compare.py --only K9)
    b = -kern.residual_grad()[2]
    legs = {'solve': lambda: kern.cg_solve(b, lam, BA_CG),
            'loop': lambda: ba.cg(lambda v_: kern.matvec(v_, lam), b, m, p,
                                  BA_CG, frozen=True)}
    turns = {leg: [] for leg in legs}
    turns_dev = {leg: [] for leg in legs}
    for leg in ('loop', 'solve', 'solve', 'loop'):
        turns[leg].append(_cuda_ms(legs[leg], 5))
        d = _kernel_ms(legs[leg], 3)
        turns_dev[leg].append(None if d is None else sum(d.values()))
    solve_split = _kernel_ms(legs['solve'], 3)
    k_run = int(legs['solve']()[1])
    L = ba.size(m, p)
    solve_bytes = (nbytes['matvec'] + K9_CG_VECTOR_PASSES * 4 * L) * k_run \
        + _nbytes(b, b)
    solve_flops = (flops['matvec'] + K9_CG_VECTOR_FLOPS * L) * k_run
    plain_solve = ba.PlainProducts(params, const, False)
    # a trace may hold no device time: the median of those that do
    dev_med = {leg: (lambda v: float(np.median(v)) if v else None)(
        [t for t in turns_dev[leg] if t is not None]) for leg in legs}
    solve_t = dict(
        ms=float(np.median(turns['solve'])), device_ms=dev_med['solve'],
        device_split=solve_split, turns=turns, turns_device=turns_dev,
        loop_ms=float(np.median(turns['loop'])),
        loop_device_ms=dev_med['loop'],
        k=k_run, grid=ba_cuda.solve_grid(dev.index),
        plain_ms=_cuda_ms(lambda: plain_solve.cg_solve(b, lam, BA_CG), 1),
        library_ms=None, bytes=solve_bytes,
        bound=_bound(solve_bytes, solve_flops, PEAK_FP32),
        bound_once=_bound(_nbytes(*ins, b, b), solve_flops, PEAK_FP32))
    timing['solve'] = solve_t
    dev_share = (None if solve_t['device_ms'] is None else
                 f'{solve_t["bound"][0] / solve_t["device_ms"]:.1%}')
    print(f'kernel K9 cg_solve [{gpu}] N = {n}, {k_run} iterations, grid '
          f'{solve_t["grid"]} x {ba_cuda.SOLVE_THREADS}: in turns with the '
          f'torch loop around the matvec entry (loop, solve, solve, loop): '
          f'solve '
          f'{turns["solve"]} ms by events, {turns_dev["solve"]} device; '
          f'loop {turns["loop"]} by events, {turns_dev["loop"]} device; '
          f'plain (cg over torch.func) {solve_t["plain_ms"]:.1f} ms; bound '
          f'{solve_t["bound"][0]:.4f} ms ({solve_t["bound"][1]}, '
          f'{solve_bytes / 1e6:.1f} MB over {k_run} iterations): '
          f'{solve_t["bound"][0] / solve_t["ms"]:.1%} by events, {dev_share} '
          f'device; each input once {solve_t["bound_once"][0]:.4f} ms')
    out['timing'] = timing
    print(f'mapping (a)-(b): {time.perf_counter() - t_phase:.1f} s')

    # (c) the whole bundle_adjust in turns: the torch loop around K9's
    # products (the parent's path) and K9's solve over BA_ITERS LM steps,
    # then the plain version and K9's solve over BA_PLAIN_ITERS
    solves = {'plain': [], 'loop': [], 'kernels': [], 'kernels_short': []}
    for leg in ('loop', 'kernels', 'kernels', 'loop', 'plain',
                'kernels_short', 'kernels_short', 'plain'):
        if leg == 'plain':
            with _plain_ba():
                res = _ba_solve(dev, prob, BA_INTR, False, names,
                                BA_PLAIN_ITERS)
            checks.true(f'mapping ba plain run launches no K9',
                        not any(res[3].values()), str(res[3]))
        elif leg == 'loop':
            with _loop_ba():
                res = _ba_solve(dev, prob, BA_INTR, False, names)
        elif leg == 'kernels_short':
            res = _ba_solve(dev, prob, BA_INTR, False, names, BA_PLAIN_ITERS)
        else:
            res = _ba_solve(dev, prob, BA_INTR, False, names)
        solves[leg].append(res)
    k_out, k_s, k_stats, k_launches = solves['kernels'][0]
    p_out = solves['plain'][0][0]
    ks_out = solves['kernels_short'][0][0]
    l_out, _, l_stats, l_launches = solves['loop'][0]
    lm = k_stats['lm']
    per_step = {k: v_ / lm for k, v_ in k_launches.items()}
    print(f'mapping bundle_adjust [{gpu}] seconds in turns: loop '
          f'{[round(s[1], 3) for s in solves["loop"]]}, kernels '
          f'{[round(s[1], 3) for s in solves["kernels"]]}; over '
          f'{BA_PLAIN_ITERS} LM steps: plain '
          f'{[round(s[1], 3) for s in solves["plain"]]}, kernels '
          f'{[round(s[1], 3) for s in solves["kernels_short"]]}; LM '
          f'iterations {lm} (plain {solves["plain"][0][2]["lm"]}, loop '
          f'{l_stats["lm"]}), CG iterations {sum(k_stats["cg"])} '
          f'({k_stats["cg"]}; loop {sum(l_stats["cg"])}); K9 launches '
          f'{k_launches} = {per_step} an LM step (loop {l_launches})')
    checks.true('mapping ba kernels: one K9 solve and 3 residual calls an '
                'LM step, no product outside the solve',
                k_launches[names[2]] == lm and k_launches[names[1]] == 0
                and k_launches[names[0]] >= 3 * lm, str(k_launches))
    checks.true('mapping ba loop leg: the torch loop around K9\'s products',
                l_launches[names[2]] == 0 and l_launches[names[1]]
                >= l_stats['lm'] * (BA_CG + 1), str(l_launches))
    checks.true(f'mapping ba final rms over {BA_PLAIN_ITERS} LM steps: '
                'kernels within 1e-3 px of plain',
                abs(ks_out[4] - p_out[4]) <= BA_RMS_TOL,
                f'({ks_out[4]:.6f} against {p_out[4]:.6f} px)')
    checks.true('mapping ba final rms: kernels within 1e-3 px of the loop',
                abs(k_out[4] - l_out[4]) <= BA_RMS_TOL,
                f'({k_out[4]:.6f} against {l_out[4]:.6f} px)')
    for leg, res in (('kernels', k_out), ('plain', p_out),
                     ('kernels_short', ks_out),
                     ('start', prob['start'] + (None, None))):
        errs = _pose_errors(prob['truth'], res)
        print(f'mapping ba {leg}: rotation error median {errs[0]:.4f} max '
              f'{errs[1]:.4f} deg, centres after Sim(3) mean '
              f'{errs[2] * 100:.3f} max {errs[3] * 100:.3f} cm (scale '
              f'{errs[4]:.5f})' + ('' if res[4] is None else
                                   f', rms {res[4]:.4f} px'))
        out[f'ba_{leg}_errors'] = errs
    k_err = out['ba_kernels_errors']
    start_err = out['ba_start_errors']
    # 30 LM steps of 50 unpreconditioned CG iterations leave the
    # rotations short of their noise floor: the check is that they fall,
    # and the centres by half. ('plain' and 'kernels_short': 10 LM steps.)
    checks.true('mapping ba recovers the poses',
                k_err[0] < start_err[0] and k_err[2] < 0.5 * start_err[2],
                f'(rotation {k_err[0]:.4f} from {start_err[0]:.4f} deg, '
                f'centres {k_err[2]:.4f} from {start_err[2]:.4f} m)')
    # an LM step's wall and busy share (one traced step), in turns with
    # the torch loop around K9's products
    sqrt_w = ba._huber_sqrt_weights(params, unit, 4.0)
    step_const = unit[:4] + (sqrt_w,)
    layout = ba_cuda.Layout(const[1], const[2], m, p)
    step = lambda: ba._lm_step(params, step_const, 1e-2, False, BA_CG,
                               layout=layout)
    step_ms = {'loop': [], 'kernels': []}
    step_busy = {'loop': [], 'kernels': []}
    for leg in ('loop', 'kernels', 'kernels', 'loop'):
        with _loop_ba() if leg == 'loop' else contextlib.nullcontext():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 3
            rows, busy = _device_profile(step)
        step_ms[leg].append(ms)
        step_busy[leg].append(_print_profile(
            gpu, f'mapping LM step ({leg})', rows, busy, ms, 'LM step'))
    # what of the step's host time dR/drvec takes (torch.func's vmap(jacfwd))
    jac_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ba.rodrigues_jacobian(params[0])
        torch.cuda.synchronize()
        jac_ms.append((time.perf_counter() - t0) * 1e3)
    print(f'mapping LM step [{gpu}] in turns (loop, kernels, kernels, '
          f'loop): wall ms {step_ms}, busy share {step_busy}; '
          f'rodrigues_jacobian (M = {m}) {[round(t, 3) for t in jac_ms]} ms '
          f'of wall a call')
    out['lm_step_ms'] = step_ms
    out['lm_step_busy'] = step_busy
    out['rodrigues_jacobian_ms'] = jac_ms
    # refine_focal from a focal 10% wrong
    wrong = (BA_INTR[0] * 1.1, BA_INTR[1] * 1.1) + BA_INTR[2:]
    # (the kernels alone: a plain solve takes 26 s here)
    f_out, f_s, f_stats, f_launches = _ba_solve(dev, prob, wrong, True,
                                                names)
    print(f'mapping ba refine_focal [{gpu}]: focal {wrong[0]:.1f} -> '
          f'{f_out[3][0]:.3f} (truth {BA_INTR[0]}), rms {f_out[4]:.4f} px '
          f'(at the true focal {k_out[4]:.4f}), {f_s:.3f} s, LM '
          f'{f_stats["lm"]}, launches {f_launches}')
    checks.true('mapping ba refine_focal moves the focal to the truth',
                abs(f_out[3][0] - BA_INTR[0]) < 0.2 * (wrong[0] - BA_INTR[0]),
                f'({f_out[3][0]:.3f})')
    checks.true('mapping ba refine_focal rms within 1% of the true focal\'s',
                f_out[4] <= 1.01 * k_out[4],
                f'({f_out[4]:.6f} against {k_out[4]:.6f})')
    out.update(ba_seconds={k: [s[1] for s in v_] for k, v_ in solves.items()},
               ba_lm=lm, ba_cg=k_stats['cg'], ba_launches=k_launches,
               ba_launches_per_step=per_step, ba_rms=(ks_out[4], p_out[4]),
               ba_plain_iters=BA_PLAIN_ITERS,
               focal=f_out[3][0], focal_rms=f_out[4], focal_s=f_s)
    print(f'mapping (a)-(c): {time.perf_counter() - t_phase:.1f} s')

    # (d) the cv2-free mapping path on the fixture room
    t_room = time.perf_counter()
    room = os.path.join(WORK_DIR, 'mapping_room')
    shutil.rmtree(room, ignore_errors=True)
    fixtures.make_room_scene(room)
    rng = np.random.default_rng(seed + 180)
    K, gt_poses, world, tracks = _room_tracks(room, rng)
    names_img = sorted(os.listdir(os.path.join(room, 'rgb')),
                       key=lambda s_: int(s_.split('.')[0]))
    images = []
    for name in names_img:
        rgb = read_png(os.path.join(room, 'rgb', name))
        images.append((name, (rgb.astype(np.float64) @ [0.299, 0.587, 0.114])
                       .astype(np.uint8)))
    sfm = IncrementalSfM(images, K, device=dev)
    kps = [[] for _ in images]
    for tid, views in enumerate(tracks):
        sfm.tracks[tid] = {}
        for f, uv in views.items():
            sfm.tracks[tid][f] = len(kps[f])
            sfm.track_of_kp[(f, len(kps[f]))] = tid
            kps[f].append(uv)
    sfm.kps = [np.array(k, np.float64).reshape(-1, 2) for k in kps]
    dr, dt, dp = MAP_PERTURB
    for f, T_CW in enumerate(gt_poses):
        dR = ba.rodrigues(torch.as_tensor(rng.normal(scale=dr, size=3))) \
            .numpy()
        sfm.registered[f] = (dR @ T_CW[:3, :3],
                             T_CW[:3, 3] + rng.normal(scale=dt, size=3))
    sfm.registered[0] = (gt_poses[0][:3, :3], gt_poses[0][:3, 3])
    sfm.points = {t: world[t] + rng.normal(scale=dp, size=3)
                  for t in range(len(world))}
    n_obs = sum(len(t) for t in tracks)
    _kernels.reset_launches()
    sfm._run_ba(max_iters=30)
    first_rms = sfm.ba_rms_px
    pruned = sfm._prune_outliers()
    dropped = sfm._drop_pose_outliers()
    torn = sfm._drop_tear_frames()
    sfm._run_ba(max_iters=20)
    _sync()
    sfm_launches = {k: _kernels.launches.get(k, 0) for k in names}
    model = os.path.join(WORK_DIR, 'mapping_model')
    shutil.rmtree(model, ignore_errors=True)
    sfm.write_colmap_model(model)
    for sub in ('pose', 'bbox.txt'):
        path = os.path.join(room, sub)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    scene = Scene(room)
    scaled = mapping_cli.ScaleEstimation(scene, model).run()
    mapping_cli.PoseSaver(scene, scaled).run()
    written = sorted(int(f.split('.')[0])
                     for f in os.listdir(os.path.join(room, 'pose')))
    est = np.stack([(lambda T: -T[:3, :3].T @ T[:3, 3])(
        np.loadtxt(os.path.join(room, 'pose', f'{i}.txt'))) for i in written])
    gt = np.stack([-gt_poses[i][:3, :3].T @ gt_poses[i][:3, 3]
                   for i in written])
    s, R, t = _umeyama(est, gt)
    err = np.linalg.norm(gt - (s * est @ R.T + t), axis=1)
    bbox = np.loadtxt(os.path.join(room, 'bbox.txt'))[:6].reshape(2, 3)
    extent = bbox[1] - bbox[0]
    print(f'mapping sfm [{gpu}]: {len(images)} frames, {len(tracks)} tracks, '
          f'{n_obs} observations; _run_ba rms {first_rms:.4f} -> '
          f'{sfm.ba_rms_px:.4f} px, pruned {pruned}, pose outliers '
          f'{dropped}, tears {torn}; {len(written)} poses written; Sim(3) '
          f'scale {s:.5f}, centre error mean {err.mean() * 100:.3f} max '
          f'{err.max() * 100:.3f} cm; bbox extent {np.round(extent, 4)}; K9 '
          f'launches {sfm_launches}; {time.perf_counter() - t_room:.1f} s')
    # tests/test_mapping_sfm.py:146-173's bars, and tighter ones: the
    # tracks here are exact up to 0.3 px, so the trajectory and the metric
    # scale come back to within 2% and 2 cm.
    checks.true('mapping sfm poses for every frame',
                len(written) == len(images) - dropped - torn,
                f'({len(written)} of {len(images)})')
    checks.true('mapping sfm metric scale (test_mapping_sfm: 0.6 < s < 1.5)',
                0.98 < s < 1.02, f'(s = {s:.5f})')
    checks.true('mapping sfm centres (test_mapping_sfm: mean < 0.15 m)',
                err.mean() < 0.02, f'(mean {err.mean():.5f} m)')
    checks.true('mapping sfm bbox room-sized (test_mapping_sfm: 1 < extent '
                '< 6)', bool((extent > 1.0).all() and (extent < 6.0).all()),
                str(extent))
    # The front end without cv2: in a child where `import cv2` fails
    # (this machine may have cv2; the check must not depend on it).
    cv2_here = importlib.util.find_spec('cv2') is not None
    probe = subprocess.run(
        [sys.executable, '-c', _NO_CV2_PROBE, dev.type], cwd=HERE,
        capture_output=True, text=True, timeout=300)
    front_end = (probe.stdout.strip().splitlines() or [''])[-1]
    checks.true('mapping front end raises naming cv2 without it',
                probe.returncode == 0 and front_end.startswith('raised')
                and 'cv2' in front_end,
                f'{front_end} {probe.stderr[-500:]} (cv2 importable in this '
                f'process: {cv2_here})')
    out.update(sfm_frames=len(images), sfm_tracks=len(tracks),
               sfm_observations=n_obs, sfm_rms=(first_rms, sfm.ba_rms_px),
               sfm_scale=float(s), sfm_centre_err=(float(err.mean()),
                                                   float(err.max())),
               sfm_launches=sfm_launches, front_end=front_end,
               room_s=time.perf_counter() - t_room)

    for key, entry in (('K9m', 'matvec'), ('K9g', 'residual_grad'),
                       ('K9s', 'solve')):
        t = timing[entry]
        results[key] = dict(max_abs_err=solve_worst if key == 'K9s'
                            else worst, ms=t['ms'],
                            device_ms=t['device_ms'],
                            device_split=t['device_split'],
                            plain_ms=t['plain_ms'], bound=t['bound'],
                            library_ms=t['library_ms'])
    results['K9s'].update(loop_ms=solve_t['loop_ms'],
                          loop_device_ms=solve_t['loop_device_ms'],
                          k=solve_t['k'],
                          grid=solve_t['grid'],
                          bound_once_ms=solve_t['bound_once'][0])
    # The products now run inside the solve: the matvec row counts them,
    # the k of every solve of the main path (its entry is launched there
    # no time).
    ba_launches = dict(k_launches)
    ba_launches['products_in_solves'] = sum(k_stats['cg'])
    out['launches'] = {'ba': ba_launches, 'sfm': sfm_launches}
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'phase 18: {out["phase_s"]:.1f} s')
    return out


# Phase 19: data and grid tensor parallelism (autolabel_tpu_torch/parallel)
# on the one card. bench.py's flagship step (TPU_GRID simplex, batch 4096,
# proposal 64 -> 32, sampled_backward 2, backward_points 0.25, the fused
# heads) for MESH_STEPS steps from one seed's params, batches and draws:
# (a) without a mesh, twice (the trainer's own run-to-run spread: K2s's
# atomics leave the table gradient's last bits to their order), and on a
# world of one under NCCL; (b) two spawned ranks sharing the card under
# gloo, DP 2 then TP 2; (c) on the ranks, K1s, K5 and K2s held at the
# shard width; (d) the train CLI with --mesh-devices 2 --mesh-model 2;
# (e) joint pose refinement on the flagship model (its encode exact: K1s,
# K2s as the exact scatter, K2x on each rank's feature slice) without a
# mesh, on a world of one, on (b)'s ranks under TP 2, and through the CLI;
# (f) InteractiveTrainer on a world of one and on (b)'s ranks under DP 2.
MESH_STEPS = 5
MESH_CLI_ITERS = (60, 40)  # the CLI's two legs: trained, then resumed
# By the cards of the call: (b)'s meshes (name, data ranks, model ranks),
# on one world, (e)'s and (f)'s meshes on the same world, and (d)'s CLI
# flags. On one card the ranks share it (gloo, whose gathers pass through
# the host: the CLI's batch is cut to 1,024 rays of 32 samples); on four,
# a rank a card (NCCL), README's command.
MESH = {1: dict(modes=(('dp', 2, 1), ('tp', 1, 2)), pose=('tp', 1, 2),
                interactive=('dp', 2, 1),
                cli=['--proposal', '--batch-size', '1024', '--num-steps',
                     '32', '--factor-train', '1', '--save-optimizer',
                     '--mesh-devices', '2', '--mesh-model', '2']),
        4: dict(modes=(('dp2tp2', 2, 2), ('dp4', 4, 1)),
                pose=('dp2tp2', 2, 2), interactive=('dp4', 4, 1),
                cli=['--proposal', '--factor-train', '1', '--save-optimizer',
                     '--mesh-devices', '4', '--mesh-model', '2'])}
MESH_TABLE_ATOL = 1e-6  # an Adam step of lr 5e-3 of one sign, rounded
MESH_LOSS_RTOL = 1e-5
# (e): the pose trainer's iters, so that its MESH_STEPS steps open the
# level windows one by one (from steps 0, 2, 5, 7) and move the deltas from
# the third (the pose group's warmup is iters // 10 applied updates); the
# pose gradient's bar by relative norm; the CLI leg's iterations.
MESH_POSE_ITERS = 20
MESH_POSE_GRAD_RTOL = 1e-5
MESH_POSE_CLI_ITERS = 10
# (f): InteractiveTrainer's steps.
MESH_INTERACTIVE_STEPS = 3
NCCL_PROBE_S = 120
OPTIONAL_MODULES = ('cv2', 'PIL', 'h5py', 'sklearn', 'pandas', 'matplotlib')
_OPTIONAL_PROBE = '''
import importlib, json, sys
out = {}
for name in sys.argv[1:]:
    try:
        module = importlib.import_module(name)
        out[name] = str(getattr(module, '__version__', 'yes'))
    except Exception as e:
        out[name] = None
print(json.dumps(out))
'''


def _optional_modules():
    """Which of OPTIONAL_MODULES import here, with their versions (in a
    child, so this process imports none of them)."""
    out = subprocess.run([sys.executable, '-c', _OPTIONAL_PROBE,
                          *OPTIONAL_MODULES], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def _mesh_inputs(dev, seed):
    """MESH_STEPS global batches of the procedural scene and the render's
    draws for them, on the host."""
    import numpy as np
    import torch
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.renderer import draw_perturbations
    positions = [(3.2 * np.cos(a), 3.2 * np.sin(a), 0.9 * (-1) ** k)
                 for k, a in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1])]
    loader = _RayBatches([_scene_frame(rays, pos) for pos in positions],
                         TRAIN_BATCH, dev, seed + 4)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    batches, draws = [], []
    for _ in range(MESH_STEPS):
        batches.append({k: v.cpu() for k, v in next(loader).items()})
        draws.append({k: v.cpu() for k, v in draw_perturbations(
            gen, TRAIN_BATCH, _flagship_options(), TPU_GRID.n_levels,
            'simplex').items()})
    return batches, draws


def _mesh_pose_inputs(dev, seed):
    """(e)'s inputs: the cameras' (R0 (8, 3, 3), t0 (8, 3)), and MESH_STEPS
    global batches of _mesh_inputs' scene with each ray's frame index and
    camera-frame direction, with the render's draws for them (pose
    refinement turns the estimators off: no encode uniforms), on the
    host."""
    import dataclasses
    import numpy as np
    import torch
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.render.renderer import draw_perturbations
    positions = [(3.2 * np.cos(a), 3.2 * np.sin(a), 0.9 * (-1) ** k)
                 for k, a in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1])]
    dirs_cam, _ = rays.compute_directions(
        np.eye(3), np.arange(FRAME_W * FRAME_H), FRAME_W, 400.0, 400.0,
        FRAME_W / 2, FRAME_H / 2)
    frames = []
    for i, pos in enumerate(positions):
        frame = _scene_frame(rays, pos)
        frame['frame_idx'] = np.full((FRAME_H, FRAME_W), i, np.int32)
        frame['rays_d_cam'] = np.asarray(dirs_cam, np.float32).reshape(
            FRAME_H, FRAME_W, 3)
        frames.append(frame)
    loader = _RayBatches(frames, TRAIN_BATCH, dev, seed + 6,
                         ('frame_idx', 'rays_d_cam'))
    options = dataclasses.replace(_flagship_options(), sampled_backward=0)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    batches, draws = [], []
    for _ in range(MESH_STEPS):
        batches.append({k: v.cpu() for k, v in next(loader).items()})
        draws.append({k: v.cpu() for k, v in draw_perturbations(
            gen, TRAIN_BATCH, options, TPU_GRID.n_levels, 'simplex').items()})
    pose_init = (torch.as_tensor(np.stack([_look_at(p) for p in positions]),
                                 dtype=torch.float32),
                 torch.tensor(positions, dtype=torch.float32))
    return {'batches': batches, 'draws': draws, 'pose_init': pose_init}


def _mesh_pose_trainer(dev, seed, mesh, pose_init):
    """(e)'s trainer: _mesh_trainer's with joint pose refinement from
    pose_init over MESH_POSE_ITERS."""
    import torch
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    field = Field(_model_config('simplex', 'pallas'), device=dev,
                  generator=torch.Generator().manual_seed(seed + 2))
    return SimpleTrainer('chip_smoke_mesh_pose', field, lr=5e-3,
                         iters=MESH_POSE_ITERS,
                         render_options=_flagship_options(), workspace=None,
                         use_checkpoint=None, metrics=False, mesh=mesh,
                         seed=seed, pose_refine=pose_init)


def _interactive_losses(dev, seed, mesh, batches, draws, states):
    """(f): InteractiveTrainer on _mesh_trainer's field and schedule
    (iters 10000, as SimpleTrainer's), init over the global batches on the
    card, MESH_INTERACTIVE_STEPS take_steps with their draws: each step's
    loss parts, its local and global step counts and the kernels'
    launches. Then each step again from `states[i]` (SimpleTrainer's
    params before its step i) at global step i ('forced': its loss parts
    and every gradient but the table's)."""
    import torch
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.train.trainer import InteractiveTrainer
    field = Field(_model_config('simplex', 'pallas'), device=dev,
                  generator=torch.Generator().manual_seed(seed + 2))
    trainer = InteractiveTrainer('chip_smoke_interactive', field, lr=5e-3,
                                 iters=10000,
                                 render_options=_flagship_options(),
                                 workspace=None, use_checkpoint=None,
                                 metrics=False, mesh=mesh, seed=seed)
    steps = MESH_INTERACTIVE_STEPS

    def take(i):
        return {k: float(v) for k, v in trainer.take_step(
            {k: v.to(dev) for k, v in draws[i].items()}).items()}

    trainer.init(iter([{k: v.to(dev) for k, v in b.items()}
                       for b in batches[:steps]]))
    _kernels.reset_launches()
    losses = [take(i) for i in range(steps)]
    torch.cuda.synchronize()
    out = dict(losses=losses, step=trainer.step,
               global_step=trainer.global_step,
               launches=dict(_kernels.launches), forced=[])
    step = trainer.optimizer.step
    for i in range(steps):
        grads = {}

        def keep(got, mesh_=None):
            grads.update({k: g.clone() for k, g in got.items()
                          if g is not None and k != 'encoder.grid'})
            return step(got, mesh_)

        with torch.no_grad():
            trainer.field.load_state_dict(states[i])
        trainer.global_step = i
        trainer.init(iter([{k: v.to(dev) for k, v in batches[i].items()}]))
        trainer.optimizer.step = keep
        try:
            out['forced'].append(dict(losses=take(i), grads=grads))
        finally:
            trainer.optimizer.step = step
    return out


def _interactive_checks(checks, tag, got, ref, grads):
    """(f): got's step 1 loss parts bit-equal to ref's (SimpleTrainer's on
    the same mesh, batches and draws); each step taken again from
    SimpleTrainer's params before it: its loss parts and every gradient
    but the table's bit-equal to SimpleTrainer's (`grads`, that run's
    per step; the table's float atomics take their own order, so run on
    the two part as no mesh run again does); one local and global step a
    take_step."""
    import torch
    checks.true(f'{tag} step 1 loss parts bit-equal to SimpleTrainer\'s',
                got['losses'][0] == ref[0], str(got['losses'][0]))
    for i, run in enumerate(got['forced']):
        others = [k for k in grads[i] if k != 'encoder.grid']
        checks.true(f'{tag} step {i + 1} from SimpleTrainer\'s params: loss '
                    'parts and every gradient but the table\'s bit-equal to '
                    'SimpleTrainer\'s',
                    run['losses'] == ref[i]
                    and all(k in run['grads']
                            and torch.equal(run['grads'][k], grads[i][k])
                            for k in others),
                    f'{len(ref[i])} loss parts, {len(others)} gradients')
    n = len(got['losses'])
    checks.true(f'{tag} counts its steps', got['step'] == n
                and got['global_step'] == n,
                f'{got["step"]}, {got["global_step"]}')
    # what a report keeps of the forced steps: their loss parts
    got['forced'] = [run['losses'] for run in got['forced']]


class _Collectives:
    """Wraps parallel's collectives: counts their calls and their host
    wall (the card synchronised before and after each) on a clock."""

    def __init__(self, parallel):
        import torch
        self.calls, self.seconds = 0, 0.0
        self.parallel = parallel
        self.saved = (parallel.all_reduce_sum, parallel.all_gather)

        def timed(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return run

        parallel.all_reduce_sum, parallel.all_gather = map(timed, self.saved)

    def close(self):
        self.parallel.all_reduce_sum, self.parallel.all_gather = self.saved


def _mesh_trainer(dev, seed, mesh):
    import torch
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.train.trainer import SimpleTrainer
    field = Field(_model_config('simplex', 'pallas'), device=dev,
                  generator=torch.Generator().manual_seed(seed + 2))
    return SimpleTrainer('chip_smoke_mesh', field, lr=5e-3, iters=10000,
                         render_options=_flagship_options(), workspace=None,
                         use_checkpoint=None, metrics=False, mesh=mesh,
                         seed=seed)


def _mesh_run(trainer, batches, draws, dev, record=None, states=False):
    """train_steps on the global batches and draws: each step's loss parts
    and wall (synchronised after it), the launches, the step-1 gradients
    (the table's gathered whole) and table, the params (and pose deltas)
    after them, and with `record` (a dict) the step-1 inputs of K1s, K5
    and K2s and K5's workspace; with `states`, every step's params before
    it and its gradients ('states', 'grads'). Then steps 2 on again with
    the collectives timed (_Collectives: the card synchronised around
    each), which the walls above leave out."""
    import torch
    from autolabel_tpu_torch import parallel
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda
    out = {'losses': [], 'walls': [], 'timed_walls': [], 'collective_s': [],
           'states': [], 'grads': []}
    mesh = trainer.mesh
    step = trainer.optimizer.step
    saved = (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
             hashgrid_cuda._select_global_call,
             hashgrid_cuda._sampled_scatter_call)
    atoms, select, select_global, scatter = saved

    def first_step(grads, mesh_=None):
        if 'grads1' not in out or states:
            whole = {k: (parallel.gather_grid(g, mesh) if k == 'encoder.grid'
                         else g).clone() for k, g in grads.items()
                     if g is not None}
            out.setdefault('grads1', whole)
            out['grad1'] = out['grads1']['encoder.grid']
            if states:
                out['grads'].append(whole)
        return step(grads, mesh_)

    def rec_atoms(table, x, config, interp, out_dtype, with_atoms):
        got = atoms(table, x, config, interp, out_dtype, with_atoms)
        if with_atoms and 'atoms' not in record:
            record['atoms'] = (table.detach().clone(), x.clone(),
                               got[1].clone(), got[2].clone(), config)
        return got

    def rec_select(g, u, k, work=None):
        n = g.shape[0]
        work = torch.empty(hashgrid_cuda.select_workspace_bytes(n),
                           dtype=torch.uint8, device=g.device)
        got = select(g, u, k, work)
        record.setdefault('select', (g.clone(), u.clone(), k, work,
                                     [t.clone() for t in got]))
        return got

    def rec_select_global(g, u, k, mesh_, work=None):
        total = g.shape[0] * parallel.axis_size(mesh_, parallel.DATA)
        work = torch.empty(hashgrid_cuda.select_workspace_bytes(total),
                           dtype=torch.uint8, device=g.device)
        got = select_global(g, u, k, mesh_, work)
        record.setdefault('select', (g.clone(), u.clone(), k, work,
                                     [t.clone() for t in got]))
        return got

    def rec_scatter(g, idx, w, u, rows, config, sel, coef, count):
        record.setdefault('scatter', (u.clone(), rows))
        return scatter(g, idx, w, u, rows, config, sel, coef, count)

    trainer.optimizer.step = first_step
    if record is not None:
        (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
         hashgrid_cuda._select_global_call,
         hashgrid_cuda._sampled_scatter_call) = (
            rec_atoms, rec_select, rec_select_global, rec_scatter)
    try:
        for i, (batch, d) in enumerate(zip(batches, draws)):
            batch = {k: v.to(dev) for k, v in batch.items()}
            d = {k: v.to(dev) for k, v in d.items()}
            if states:
                out['states'].append({
                    k: v.detach().clone()
                    for k, v in trainer.field.state_dict().items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = trainer.train_step(batch, d)
            torch.cuda.synchronize()
            out['walls'].append(time.perf_counter() - t0)
            out['losses'].append({k: float(v) for k, v in parts.items()})
            if i == 0:
                (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
                 hashgrid_cuda._select_global_call,
                 hashgrid_cuda._sampled_scatter_call) = saved
                out['table1'] = parallel.gather_grid(
                    trainer.field.encoder['grid'].detach(), mesh).clone()
    finally:
        trainer.optimizer.step = step
        (hashgrid_cuda._atoms_call, hashgrid_cuda._select_call,
         hashgrid_cuda._select_global_call,
         hashgrid_cuda._sampled_scatter_call) = saved
    out['launches'] = dict(_kernels.launches)
    out['params'] = {k: parallel.gather_grid(v.detach(), mesh).cpu()
                     if k == 'encoder.grid' else v.detach().cpu()
                     for k, v in trainer.field.state_dict().items()}
    out['pose'] = {k: v.detach().cpu().clone()
                   for k, v in trainer.pose.items()}
    coll = _Collectives(parallel)
    try:
        for batch, d in zip(batches[1:], draws[1:]):
            batch = {k: v.to(dev) for k, v in batch.items()}
            d = {k: v.to(dev) for k, v in d.items()}
            torch.cuda.synchronize()
            c0, t0 = coll.seconds, time.perf_counter()
            trainer.train_step(batch, d)
            torch.cuda.synchronize()
            out['timed_walls'].append(time.perf_counter() - t0)
            out['collective_s'].append(coll.seconds - c0)
    finally:
        coll.close()
    out['collective_calls'] = coll.calls
    return out


def _mesh_walls(run):
    """A run's step walls, steps 2 on (step 1 pays the first launches and
    the communicators' set-up), and its collectives' share of the timed
    steps' walls."""
    walls, timed = run['walls'][1:], run['timed_walls']
    coll = run['collective_s']
    return (f'step walls ms {[round(w * 1e3, 3) for w in run["walls"]]}; '
            f'steps 2-{len(run["walls"])}: median '
            f'{sorted(walls)[len(walls) // 2] * 1e3:.3f} ms; with the card '
            f'synchronised around each of {run["collective_calls"]} '
            f'collectives ({len(timed)} steps): median '
            f'{sorted(timed)[len(timed) // 2] * 1e3:.3f} ms a step, '
            f'collectives {sum(coll) * 1e3 / len(coll):.3f} ms, '
            f'{sum(coll) / sum(timed):.4f} of it')


def _mesh_of(mode, world):
    """The mesh of a mode (name, data ranks, model ranks) of `world`."""
    from autolabel_tpu_torch import parallel
    _, n_data, n_model = mode
    return (parallel.make_mesh(world, device='cuda') if n_model == 1
            else parallel.make_mesh_2d(n_data, n_model, device='cuda'))


def _mesh_rank(rank, init_file, work, seed, modes, pose_mode,
               interactive_mode):
    """Phase 19 (b)-(c)'s rank: on each mesh of `modes` (name, data ranks,
    model ranks) in turn, one world; rank r writes <work>/rank<r>.json (its
    walls, collectives, launches and failed checks) and
    <work>/<mode>_rank<r>.pt. Then on the same world (e) on pose_mode's
    mesh (<work>/pose_rank<r>.pt: step 1's pose gradient and the deltas
    after MESH_STEPS; K2x held and timed on its first call's inputs, the
    rank's feature slice) and (f) on interactive_mode's."""
    sys.path.insert(0, HERE)
    import torch
    from autolabel_tpu_torch import parallel
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    world = modes[0][1] * modes[0][2]
    dev = parallel.init_world(rank, world, init_file, 'cuda')
    gpu = _gpu_line(dev.index)
    checks = Checks()
    report = {'backend': torch.distributed.get_backend(), 'device': str(dev)}
    try:
        inputs = torch.load(os.path.join(work, 'inputs.pt'))
        for mode, n_data, n_model in modes:
            mesh = _mesh_of((mode, n_data, n_model), world)
            trainer = _mesh_trainer(dev, seed, mesh)
            record = {}
            _kernels.reset_launches()
            run = _mesh_run(trainer, inputs['batches'], inputs['draws'], dev,
                            record, states=mode == interactive_mode[0])
            if mode == interactive_mode[0]:  # (f)'s reference
                steps = MESH_INTERACTIVE_STEPS
                inter_ref = dict(losses=run['losses'],
                                 states=run['states'][:steps],
                                 grads=[{k: v for k, v in g.items()
                                         if k != 'encoder.grid'}
                                        for g in run['grads'][:steps]])
            report[mode] = dict(walls=run['walls'], losses=run['losses'],
                                timed_walls=run['timed_walls'],
                                collective_s=run['collective_s'],
                                launches=run['launches'])
            print(f'mesh {mode} rank {rank} [{gpu}] ({report["backend"]}, '
                  f'{dev}): {_mesh_walls(run)}', flush=True)
            g, u, k, ws, (sel, coef, count) = record['select']
            total = g.shape[0] * parallel.axis_size(mesh, parallel.DATA)
            views = hashgrid_cuda.select_workspace_views(ws, total)
            save = {'counts': views['counts'].cpu(), 'sel': sel.cpu(),
                    'coef': coef.cpu(), 'count': count.cpu(), 'g': g.cpu()}
            if rank == 0:
                save.update(grads1={k: v.cpu() for k, v in
                                    run['grads1'].items()},
                            table1=run['table1'].cpu(), params=run['params'])
            torch.save(save, os.path.join(work, f'{mode}_rank{rank}.pt'))
            # (c) the kernels at the shard width, on step 1's own inputs
            table, x, idx, w, config = record['atoms']
            u_s, rows = record['scatter']
            tag = f'mesh {mode} rank {rank}'
            _check_k1s(checks, tag, table, x, idx, w, config)
            _check_select_scatter(checks, gpu, dev, tag, g, u, min(
                k, g.shape[0]), idx, w, rows, config)
            # the global subsample: its norms kernel without the root holds
            # its order; and the rank's draws are the full-range scan's in
            # its rows (the same norms, scanned with every row kept).
            sq = hashgrid_cuda.select_norms(g, root=False)
            chain_sq = hashgrid_cuda.select_chain_norms(g, root=False)
            checks.true(f'{tag} K5 squared norms bit-equal to its order',
                        sq.cpu().numpy().tobytes() == chain_sq.tobytes())
            whole = ws.clone()
            full = hashgrid_cuda.select_scan(whole, total, u[0, g.shape[0]:],
                                             k, 0, total)
            lo = parallel.axis_index(mesh, parallel.DATA) * g.shape[0]
            m_full, m = int(full[2][0]), int(count[0])
            fs, fc = full[0][:m_full].long(), full[1][:m_full]
            mine = (fs >= lo) & (fs < lo + g.shape[0])
            checks.true(
                f'{tag} K5 global draws: the full-range scan\'s in the '
                'rank\'s rows, bit-equal',
                torch.equal(fs[mine] - lo, sel[:m].long())
                and torch.equal(fc[mine], coef[:m]), f'{m} of {m_full}')
            if n_model > 1:
                check = hashgrid_cuda.check_selection(
                    g, u[0, g.shape[0]], k, full[0], full[1], full[2],
                    hashgrid_cuda.select_workspace_views(whole, total),
                    norms=views['s'].cpu().numpy())
                failures = hashgrid_cuda.selection_failures(
                    check, total, k, g.shape[1] * n_model)
                checks.true(f'{tag} K5 global selection against itself, '
                            'float64 and plain', not failures,
                            '; '.join(failures) or 'all conditions hold')
                # both model ranks draw the same points (sel and count
                # gathered whole: the same sizes on every rank)
                other = parallel.all_gather(torch.cat([count, sel]), mesh,
                                            parallel.MODEL)
                checks.true(f'{tag} K5 the model ranks draw the same points',
                            all(int(o[0]) == m and torch.equal(
                                o[1:m + 1], sel[:m]) for o in other))
            del record, run, trainer
            torch.cuda.empty_cache()
        # (e) joint pose refinement
        pose_in = torch.load(os.path.join(work, 'pose_inputs.pt'))
        trainer = _mesh_pose_trainer(dev, seed, _mesh_of(pose_mode, world),
                                     pose_in['pose_init'])
        _kernels.reset_launches()
        with _first_point_grad(hashgrid_cuda, {}) as k2x_in:
            run = _mesh_run(trainer, pose_in['batches'], pose_in['draws'],
                            dev)
        report['pose'] = dict(walls=run['walls'], losses=run['losses'],
                              timed_walls=run['timed_walls'],
                              collective_s=run['collective_s'],
                              launches=run['launches'])
        print(f'mesh (e) {pose_mode[0]} pose rank {rank} [{gpu}] '
              f'({report["backend"]}): {_mesh_walls(run)}', flush=True)
        torch.save({'grads1': {k: v.cpu() for k, v in run['grads1'].items()
                               if k.startswith('pose.')},
                    'pose': run['pose']},
                   os.path.join(work, f'pose_rank{rank}.pt'))
        del trainer, run
        torch.cuda.empty_cache()
        # the ranks share the card: each times K2x while the others wait
        args = k2x_in['args']
        for turn in range(world):
            if turn == rank:
                report['k2x'] = _k2x_form(
                    checks, gpu, {}, f'mesh (e) {pose_mode[0]} rank {rank} '
                    f'F={args[3].n_features}', args)
                report['k2x']['n_features'] = args[3].n_features
            parallel.barrier()
        del k2x_in, args
        torch.cuda.empty_cache()
        # (f) InteractiveTrainer, the ranks stepping together
        got = _interactive_losses(
            dev, seed, _mesh_of(interactive_mode, world), inputs['batches'],
            inputs['draws'], inter_ref['states'])
        _interactive_checks(checks, f'mesh (f) {interactive_mode[0]} rank '
                            f'{rank}', got, inter_ref['losses'],
                            inter_ref['grads'])
        report['interactive'] = got
        del inter_ref
        torch.cuda.empty_cache()
    finally:
        report['failures'] = checks.failures
        with open(os.path.join(work, f'rank{rank}.json'), 'w') as f:
            json.dump(report, f)
        torch.distributed.destroy_process_group()


def _nccl_probe_rank(rank, init_file, out):
    """Two ranks on card 0 under NCCL: what one all_reduce does."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group('nccl', init_method=f'file://{init_file}',
                                rank=rank, world_size=2)
        t = torch.ones(1, device='cuda')
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = f'ran: {float(t)}'
    except Exception as e:  # the outcome is what the probe reports
        result = f'refused: {type(e).__name__}: {str(e).splitlines()[0]}'
    with open(f'{out}.{rank}', 'w') as f:
        f.write(result)
    os._exit(0)


def _mesh_phase(dev, seed, gpu, checks, cards=1):
    """Phase 19 (see the module docstring) on `cards` cards: with one, (a)
    to (f); with four (--mesh-cards 4), (a) without its world of one, (b),
    (c), (e) and (f) with a rank a card under NCCL (DP 2 x TP 2, then DP
    4; (e) on DP 2 x TP 2, (f) on DP 4) and (d) and (e)'s CLI on four
    ranks. Returns what the output file keeps."""
    import shutil

    import torch
    from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
    t_phase = time.perf_counter()
    work = os.path.join(WORK_DIR, 'mesh')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    batches, draws = _mesh_inputs(dev, seed)
    torch.save({'batches': batches, 'draws': draws},
               os.path.join(work, 'inputs.pt'))
    pose_in = _mesh_pose_inputs(dev, seed)
    torch.save(pose_in, os.path.join(work, 'pose_inputs.pt'))
    names = [hashgrid_cuda.ATOMS_NAME, hashgrid_cuda.SELECT_NAME,
             hashgrid_cuda.SAMPLED_BWD_NAME, heads_cuda.HEADS,
             heads_cuda.HEADS_BWD, heads_cuda.MLP3, heads_cuda.MLP3_BWD]
    # (a) no mesh twice (A, A2), then (one card) a world of one (NCCL)
    runs, record = {}, {}
    for name in ('A', 'A2'):
        trainer = _mesh_trainer(dev, seed, None)
        runs[name] = _mesh_run(trainer, batches, draws, dev,
                               record if name == 'A' else None,
                               states=name == 'A')
        del trainer
    print(f'mesh (a) [{gpu}] no mesh: {_mesh_walls(runs["A"])}')
    out['no_mesh_walls'] = runs['A']['walls']
    # (e) joint pose refinement without a mesh, the ranks' reference
    _kernels.reset_launches()
    runs['P'] = _mesh_run(_mesh_pose_trainer(dev, seed, None,
                                             pose_in['pose_init']),
                          pose_in['batches'], pose_in['draws'], dev)
    print(f'mesh (e) [{gpu}] pose, no mesh: {_mesh_walls(runs["P"])}')
    out['pose_no_mesh_walls'] = runs['P']['walls']
    _check_launches(checks, 'mesh (e) pose no mesh', runs['P']['launches'],
                    _pose_names(), MESH_STEPS)
    moved = min(float(v[1:].abs().max()) for v in runs['P']['pose'].values())
    checks.true(f'mesh (e) pose no mesh: the deltas moved in {MESH_STEPS} '
                'steps', moved > 0, f'largest move {moved:.3e}')
    torch.cuda.empty_cache()
    if cards == 1:
        out['a'] = _mesh_world_of_one(dev, seed, gpu, checks, batches,
                                      draws, runs, record, names, pose_in)
    torch.cuda.empty_cache()
    out['b'] = _mesh_ranks(gpu, checks, work, seed, cards, runs, record,
                           names)
    del runs, record
    torch.cuda.empty_cache()
    if cards == 1:
        out['nccl_two_ranks_one_card'] = _nccl_probe(gpu, work)
    out['d'] = _mesh_cli(gpu, checks, work, cards, names)
    out['e_cli'] = _mesh_pose_cli(gpu, checks,
                                  os.path.join(WORK_DIR, 'cli', 'sphere'),
                                  os.path.join(work, 'cli_pose'),
                                  MESH[cards]['cli'])
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'phase 19: {out["phase_s"]:.1f} s')
    return out


def _sampled_tolerance(record, coef_rel=0.0, dg=None):
    """K2s's sum-order tolerance of the table gradient of the step that
    `record` (_mesh_run's) holds, per element; with coef_rel, each term's
    coefficient off by up to that share besides, and with dg (|g| of
    another run less this one's, fp32) the terms' cotangents off by it:
    their first-order spread, widened by (1 + coef_rel)."""
    from autolabel_tpu_torch.ops import encoders, hashgrid_cuda
    (_, _, idx, w, config), (g, _, _, _, (sel, coef, count)) = \
        record['atoms'], record['select']
    u, rows = record['scatter']
    m = int(count[0])
    sel, coef = sel[:m].long(), coef[:m]
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows,
                                                   config, sel, coef)
    if not coef_rel and dg is None:
        return tol
    spread = coef_rel * encoders.sampled_scatter_plain(
        g.float().abs(), idx, w, u, rows, config, sel, coef.abs())
    if dg is not None:
        spread += encoders.sampled_scatter_plain(dg, idx, w, u, rows, config,
                                                 sel, coef.abs())
    return (tol + spread) * (1.0 + coef_rel)


def _pose_names():
    """The kernels of a flagship step with pose refinement: its encode
    exact (K1s, K2s as the exact scatter, K2x), the fused heads and the
    proposal MLP; K5 not."""
    from autolabel_tpu_torch.ops import hashgrid_cuda, heads_cuda
    return [hashgrid_cuda.ATOMS_NAME, hashgrid_cuda.POINT_GRAD_NAME,
            hashgrid_cuda.SAMPLED_BWD_NAME, heads_cuda.HEADS,
            heads_cuda.HEADS_BWD, heads_cuda.MLP3, heads_cuda.MLP3_BWD]


def _check_launches(checks, tag, launches, names, count):
    """Each of `names` launched `count` times, K5 none unless named."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    want = dict.fromkeys(names, count)
    want.setdefault(hashgrid_cuda.SELECT_NAME, 0)
    for name, n in want.items():
        got = launches.get(name, 0)
        checks.true(f'{tag} launches {name}', got == n,
                    f'{got} (expected {n})')


def _later_spread(a, b, steps):
    """The largest relative difference of two runs' loss parts over steps
    2 to `steps`."""
    return max((abs(b['losses'][i][k] - v) / max(abs(v), 1e-30)
                for i in range(1, steps)
                for k, v in a['losses'][i].items()), default=0.0)


def _pose_gradient(grads):
    """Step 1's pose gradient (rot, t) as one tensor on the host."""
    import torch
    return torch.cat([grads['pose.rot'].cpu(), grads['pose.t'].cpu()])


def _mesh_world_of_one(dev, seed, gpu, checks, batches, draws, runs, record,
                       names, pose_in):
    """Phase 19 (a)'s world of one under NCCL, held against runs['A'] (and
    runs['A2'], no mesh run again). Each step taken from no mesh's params
    before it: the loss parts and every gradient but the table's
    bit-equal to no mesh's; the table's (K2s's float atomics take their
    own order) within K2s's sum-order tolerance of it. Run on, the two
    part by that rounding (Adam moves an element by about lr whatever its
    gradient's size): their losses after step 1 are printed beside no
    mesh run again's."""
    import torch
    from autolabel_tpu_torch import parallel
    from autolabel_tpu_torch.ops import _kernels
    mesh = parallel.make_mesh(1)
    backend = torch.distributed.get_backend()
    trainer = _mesh_trainer(dev, seed, mesh)
    _kernels.reset_launches()
    w1 = _mesh_run(trainer, batches, draws, dev)
    launches = w1['launches']
    a, a2 = runs['A'], runs['A2']
    # each step again from no mesh's params before it
    forced = []
    for i in range(MESH_STEPS):
        with torch.no_grad():
            trainer.field.load_state_dict(a['states'][i])
        trainer.global_step = i
        rec = {}
        forced.append((_mesh_run(trainer, batches[i:i + 1], draws[i:i + 1],
                                 dev, rec), rec))
    del trainer
    # (e) joint pose refinement and (f) InteractiveTrainer on the world of
    # one
    _kernels.reset_launches()
    pose_w1 = _mesh_run(_mesh_pose_trainer(dev, seed, mesh,
                                           pose_in['pose_init']),
                        pose_in['batches'], pose_in['draws'], dev)
    torch.cuda.empty_cache()
    inter_w1 = _interactive_losses(dev, seed, mesh, batches, draws,
                                   runs['A']['states'])
    torch.distributed.destroy_process_group()
    p = runs['P']
    _check_launches(checks, 'mesh (e) pose world of one',
                    pose_w1['launches'], _pose_names(), MESH_STEPS)
    checks.true('mesh (e) pose world of one: step 1 loss parts and pose '
                'gradient bit-equal to no mesh\'s',
                pose_w1['losses'][0] == p['losses'][0]
                and torch.equal(_pose_gradient(pose_w1['grads1']),
                                _pose_gradient(p['grads1'])),
                str(pose_w1['losses'][0]))
    delta_diff = max(float((pose_w1['pose'][k] - p['pose'][k]).abs().max())
                     for k in p['pose'])
    print(f'mesh (e) [{gpu}] pose world of one (nccl): {_mesh_walls(pose_w1)}'
          f'; deltas after {MESH_STEPS} steps within {delta_diff:.3e} of no '
          f'mesh\'s (K2s\'s atomics part the tables after step 1)')
    _interactive_checks(checks, 'mesh (f) world of one', inter_w1,
                        runs['A']['losses'], runs['A']['grads'])
    steps = MESH_INTERACTIVE_STEPS
    inter_w1['later'] = _later_spread(a, inter_w1, steps)
    print(f'mesh (f) [{gpu}] world of one: run on, steps 2-{steps} loss '
          f'parts within {inter_w1["later"]:.3e} relative of no mesh\'s (no '
          f'mesh run again: {_later_spread(a, a2, steps):.3e})')
    _check_launches(checks, 'mesh (f) world of one', inter_w1['launches'],
                    names, MESH_INTERACTIVE_STEPS)
    checks.true('mesh (a) world of one: NCCL, collectives called',
                backend == 'nccl' and w1['collective_calls'] > 0,
                f'{backend}, {w1["collective_calls"]} calls in '
                f'{len(w1["timed_walls"])} steps')
    for name in names:
        checks.true(f'mesh (a) world of one launches {name}',
                    launches.get(name, 0) == MESH_STEPS,
                    f'{launches.get(name, 0)} (expected {MESH_STEPS})')
    others = [k for k in a['grads1'] if k != 'encoder.grid']
    for i, (run, rec) in enumerate(forced):
        want, grads = a['losses'][i], a['grads'][i]
        checks.true(f'mesh (a) world of one step {i + 1} from no mesh\'s '
                    'params: loss parts and every gradient but the table\'s '
                    'bit-equal to no mesh\'s',
                    all(want[k] == run['losses'][0][k] for k in want)
                    and all(torch.equal(grads[k], run['grads1'][k])
                            for k in others),
                    f'{len(want)} loss parts, {len(others)} gradients')
        checks.within(f'mesh (a) world of one step {i + 1} from no mesh\'s '
                      'params: table gradient within K2s\'s sum-order '
                      'tolerance of no mesh\'s', run['grad1'],
                      grads['encoder.grid'], _sampled_tolerance(rec))
    table_equal = int((w1['grad1'] == a['grad1']).sum())
    own_equal = int((a2['grad1'] == a['grad1']).sum())

    def later(run):
        return max(abs(run['losses'][i][k] - v) / max(abs(v), 1e-30)
                   for i in range(1, MESH_STEPS)
                   for k, v in a['losses'][i].items())

    later_w1, later_a2 = later(w1), later(a2)
    items = [(a['losses'][i][k], a2['losses'][i][k], w1['losses'][i][k])
             for i in range(MESH_STEPS) for k in a['losses'][i]]
    items += [(a['params'][k], a2['params'][k], w1['params'][k])
              for k in a['params']]

    def same(x, y):
        return bool(torch.equal(x, y)) if torch.is_tensor(x) else x == y

    equal = sum(same(ref, got) for ref, _, got in items)
    equal_own = sum(same(ref, got) for ref, got, _ in items)
    print(f'mesh (a) [{gpu}] run on: step 1 table gradient bit-equal to no '
          f'mesh\'s on {table_equal} of {a["grad1"].numel()} elements (no '
          f'mesh run again: {own_equal}); losses and params after 5 steps '
          f'bit-equal: {equal} of {len(items)} (no mesh run again: '
          f'{equal_own}); steps 2-5 losses within {later_w1:.3e} relative '
          f'(no mesh run again: {later_a2:.3e})')
    print(f'mesh (a) [{gpu}] world of one (nccl): {_mesh_walls(w1)}')
    return dict(bit_equal=equal, compared=len(items),
                collective_s=w1['collective_s'], walls=w1['walls'],
                timed_walls=w1['timed_walls'], launches=launches,
                later=later_w1, later_no_mesh=later_a2,
                pose=dict(walls=pose_w1['walls'],
                          timed_walls=pose_w1['timed_walls'],
                          collective_s=pose_w1['collective_s'],
                          launches=pose_w1['launches'],
                          deltas_within=delta_diff),
                interactive=inter_w1)


def _mesh_ranks(gpu, checks, work, seed, cards, runs, record, names):
    """Phase 19 (b): the ranks of MESH[cards]'s modes spawned on one world
    (_mesh_rank, which holds (c)), each mesh held against runs['A']:
    step 1's loss parts within MESH_LOSS_RTOL; its encode cotangent and
    other gradients within 1e-5 by relative norm; its table gradient,
    off the rows of the points that K5 counts otherwise than one device
    (each within a scan's bound of a boundary), within K2s's sum-order
    tolerance widened by K5's coefficient bound (twice: both runs' coefs
    against float64) and the cotangent's difference, with no element of
    the other sign; and the table after step 1 within MESH_TABLE_ATOL
    there."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    modes = MESH[cards]['modes']
    pose_mode, inter_mode = MESH[cards]['pose'], MESH[cards]['interactive']
    world = modes[0][1] * modes[0][2]
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _mesh_rank, args=(os.path.join(work, 'rendezvous'), work, seed,
                          modes, pose_mode, inter_mode),
        nprocs=world, join=True, start_method='spawn')
    ranks_s = time.perf_counter() - t0
    reports = []
    for rank in range(world):
        with open(os.path.join(work, f'rank{rank}.json')) as f:
            reports.append(json.load(f))
        for failure in reports[-1]['failures']:
            checks.failures.append(f'rank {rank}: {failure}')
    want = 'gloo' if cards == 1 else 'nccl'
    checks.true(f'mesh (b) {world} ranks on {cards} card(s) run {want}',
                all(r['backend'] == want for r in reports),
                str([r['backend'] for r in reports]))
    a = runs['A']
    others = [k for k in a['grads1'] if k != 'encoder.grid']
    idx = record['atoms'][2]  # (L, 4, N): step 1's atoms, every run's
    g, u, k = record['select'][:3]
    counts = hashgrid_cuda.select_workspace_views(
        record['select'][3], g.shape[0])['counts'].cpu()
    grad_a, table_a = a['grad1'].cpu(), a['table1'].cpu()
    # How far k cum - u lies from an integer at each point or the one
    # before it (a count is the difference of two floors), in float64 from
    # (a)'s step-1 cotangent, and one fp32 scan's bound from it
    # (select_scan_bound): two scans count a point otherwise only where an
    # integer lies between their values.
    s64 = g.double().pow(2).sum(dim=-1).sqrt().cpu()
    v64 = k * (s64.cumsum(0) / s64.sum()) - float(u[0, g.shape[0]])
    v_dist = (v64 - v64.round()).abs()
    v_dist = torch.minimum(v_dist, torch.cat([v_dist.new_ones(1),
                                              v_dist[:-1]]))
    scan_bound = hashgrid_cuda.select_scan_bound(g.shape[0], k, g.shape[1])
    out = {'ranks_s': ranks_s}
    coef_rel = 2 * hashgrid_cuda.select_coef_bound(g.shape[0], g.shape[1])
    for mode, n_data, n_model in modes:
        mine = torch.load(os.path.join(work, f'{mode}_rank0.pt'))
        for r, rep in enumerate(reports):
            for name in names:
                got = rep[mode]['launches'].get(name, 0)
                checks.true(f'mesh (b) {mode} rank {r} launches {name}',
                            got == MESH_STEPS,
                            f'{got} (expected {MESH_STEPS})')
        losses = reports[0][mode]['losses']
        for key, v in a['losses'][0].items():
            checks.close(f'mesh (b) {mode} step 1 loss {key}',
                         torch.tensor(losses[0][key]), torch.tensor(v),
                         atol=0.0, rtol=MESH_LOSS_RTOL)
        checks.true(f'mesh (b) {mode} ranks report one loss',
                    all(r[mode]['losses'] == losses for r in reports))
        g1 = mine['grads1']
        rel = {n: float((g1[n] - a['grads1'][n].cpu()).norm()
                        / a['grads1'][n].cpu().norm().clamp(min=1e-30))
               for n in others}
        checks.true(f'mesh (b) {mode} step 1 gradients but the table\'s '
                    'within 1e-5 of (a)\'s by relative norm',
                    max(rel.values()) <= 1e-5,
                    f'largest {max(rel.values()):.3e} ({max(rel, key=rel.get)}'
                    f'), {sum(v == 0 for v in rel.values())} of {len(rel)} '
                    'bit-equal')
        flipped = torch.nonzero(mine['counts'] != counts).squeeze(1)
        dist = float(v_dist[flipped].max()) if flipped.numel() else 0.0
        checks.true(f'mesh (b) {mode} points drawn otherwise than in (a): '
                    'each within a scan\'s bound of a boundary',
                    dist <= scan_bound,
                    f'{flipped.numel()} points, farthest {dist:.3e} counts '
                    f'(bound {scan_bound:.3e})')
        rows = torch.zeros(idx.shape[0], TPU_GRID.table_size,
                           dtype=torch.bool)
        for level in range(idx.shape[0]) if flipped.numel() else ():
            rows[level, idx[level][:, flipped.to(idx.device)].reshape(
                -1).long().cpu()] = True
        keep = ~rows[..., None].expand_as(table_a)
        # the global cotangent in (a)'s layout: rank d * n_model + j holds
        # rows d, level-major features j of each level
        parts = [torch.load(os.path.join(work, f'{mode}_rank{r}.pt'))['g']
                 for r in range(world)]
        n = parts[0].shape[0]
        g_mesh = torch.cat([torch.cat(
            [parts[d * n_model + j].reshape(n, TPU_GRID.n_levels, -1)
             for j in range(n_model)], dim=2).reshape(n, -1)
            for d in range(n_data)])
        g_a = g.cpu()
        checks.true(f'mesh (b) {mode} step 1 encode cotangent within 1e-5 of '
                    '(a)\'s by relative norm', float(
                        (g_mesh.float() - g_a.float()).norm()
                        / g_a.float().norm().clamp(min=1e-30)) <= 1e-5,
                    f'{int((g_mesh == g_a).sum())} of {g_a.numel()} '
                    'bit-equal')
        dg = (g_mesh.float() - g_a.float()).abs().to(g.device)
        tol = _sampled_tolerance(record, coef_rel, dg).cpu()
        grad_b = g1['encoder.grid']
        checks.within(f'mesh (b) {mode} step 1 table gradient within K2s\'s '
                      'tolerance of (a)\'s, off the rows of the points '
                      'counted otherwise', grad_b[keep], grad_a[keep],
                      tol[keep])
        other = keep & (torch.sign(grad_b) != torch.sign(grad_a))
        checks.true(f'mesh (b) {mode} step 1 table gradient: no element of '
                    'the other sign off those rows', not bool(other.any()),
                    f'{int(other.sum())} elements; {flipped.numel()} points, '
                    f'{int(rows.sum())} rows left out')
        held = keep & (torch.sign(grad_b) == torch.sign(grad_a))
        err = (mine['table1'] - table_a).abs()[held]
        checks.true(
            f'mesh (b) {mode} table after step 1 within {MESH_TABLE_ATOL} '
            'of (a)\'s off those rows', bool((err <= MESH_TABLE_ATOL).all()),
            f'max {float(err.max()):.3e} on {int(held.sum())} of '
            f'{held.numel()} elements')
        out[mode] = dict(
            walls=[r[mode]['walls'] for r in reports],
            timed_walls=[r[mode]['timed_walls'] for r in reports],
            collective_s=[r[mode]['collective_s'] for r in reports],
            losses=losses, flipped=int(flipped.numel()),
            table_err=float(err.max()),
            launches=[r[mode]['launches'] for r in reports])
        del mine
    out['e'] = _mesh_pose_checks(checks, work, pose_mode, reports, runs['P'])
    # (f) InteractiveTrainer against SimpleTrainer on the same mesh (one of
    # (b)'s modes), held in the ranks (_interactive_checks); run on, its
    # later steps beside no mesh run again's
    spread = _later_spread(runs['A'], runs['A2'], MESH_INTERACTIVE_STEPS)
    ref = reports[0][inter_mode[0]]
    later = [_later_spread(ref, r['interactive'], MESH_INTERACTIVE_STEPS)
             for r in reports]
    print(f'mesh (f) [{gpu}] {inter_mode[0]}: run on, steps '
          f'2-{MESH_INTERACTIVE_STEPS} loss parts within '
          f'{[f"{v:.3e}" for v in later]} relative of SimpleTrainer\'s on '
          f'the mesh (no mesh run again: {spread:.3e})')
    for r, rep in enumerate(reports):
        _check_launches(checks, f'mesh (f) {inter_mode[0]} rank {r}',
                        rep['interactive']['launches'], names,
                        MESH_INTERACTIVE_STEPS)
    checks.true(f'mesh (f) {inter_mode[0]} ranks report one loss',
                all(r['interactive']['losses'] == reports[0]['interactive'][
                    'losses'] for r in reports))
    out['f'] = dict(mode=inter_mode[0], spread_no_mesh=spread, later=later,
                    interactive=[r['interactive'] for r in reports])
    print(f'mesh (b) [{gpu}]: {world} ranks {ranks_s:.1f} s with their '
          'checks and the spawn')
    return out


def _mesh_pose_checks(checks, work, pose_mode, reports, p):
    """Phase 19 (e) on the ranks, held against p (no mesh's pose run): each
    rank launches the pose step's kernels once a step; step 1's loss parts
    within MESH_LOSS_RTOL and its pose gradient within MESH_POSE_GRAD_RTOL
    by relative norm; the step-1 pose gradient and the deltas after
    MESH_STEPS steps bit-equal on every rank; K2x run at the rank's feature
    slice (each rank held it against its plain version on its inputs)."""
    import torch
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    mode, _, n_model = pose_mode
    tag = f'mesh (e) {mode} pose'
    for r, rep in enumerate(reports):
        _check_launches(checks, f'{tag} rank {r}', rep['pose']['launches'],
                        _pose_names(), MESH_STEPS)
        checks.true(f'{tag} rank {r} K2x at the slice\'s width',
                    rep['k2x']['n_features'] == TPU_GRID.n_features // n_model,
                    f'F = {rep["k2x"]["n_features"]}')
    losses = reports[0]['pose']['losses']
    for key, v in p['losses'][0].items():
        checks.close(f'{tag} step 1 loss {key}', torch.tensor(losses[0][key]),
                     torch.tensor(v), atol=0.0, rtol=MESH_LOSS_RTOL)
    checks.true(f'{tag} ranks report one loss',
                all(r['pose']['losses'] == losses for r in reports))
    saved = [torch.load(os.path.join(work, f'pose_rank{r}.pt'))
             for r in range(len(reports))]
    grads = [_pose_gradient(sv['grads1']) for sv in saved]
    rel = checks.rel_norm(f'{tag} step 1 pose gradient against one card\'s',
                          grads[0], _pose_gradient(p['grads1']),
                          MESH_POSE_GRAD_RTOL)
    checks.true(f'{tag} step 1 pose gradient bit-equal on every rank',
                all(torch.equal(g, grads[0]) for g in grads))
    deltas = [torch.cat([sv['pose']['rot'], sv['pose']['t']]) for sv in saved]
    checks.true(f'{tag} deltas after {MESH_STEPS} steps bit-equal on every '
                'rank', all(torch.equal(d, deltas[0]) for d in deltas),
                f'largest move {float(deltas[0].abs().max()):.3e}')
    return dict(mode=mode, pose_grad_rel_err=rel,
                walls=[r['pose']['walls'] for r in reports],
                timed_walls=[r['pose']['timed_walls'] for r in reports],
                collective_s=[r['pose']['collective_s'] for r in reports],
                losses=losses,
                launches=[r['pose']['launches'] for r in reports],
                k2x=[r['k2x'] for r in reports])


def _nccl_probe(gpu, work):
    """Two NCCL ranks on the one card: what an all_reduce does (the rule
    sends ranks sharing a card to gloo)."""
    import torch
    probe = os.path.join(work, 'nccl_probe')
    ctx = torch.multiprocessing.start_processes(
        _nccl_probe_rank, args=(os.path.join(work, 'nccl_rendezvous'), probe),
        nprocs=2, join=False, start_method='spawn')
    deadline = time.perf_counter() + NCCL_PROBE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                break
    except Exception as e:  # a rank that died: the outcome says so
        print(f'mesh nccl probe: {type(e).__name__}')
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()
    outcomes = []
    for rank in range(2):
        path = f'{probe}.{rank}'
        outcomes.append(open(path).read() if os.path.exists(path)
                        else f'no outcome in {NCCL_PROBE_S} s')
    print(f'mesh nccl probe [{gpu}]: two ranks on one card: {outcomes}')
    return outcomes


def _mesh_cli(gpu, checks, work, cards, names):
    """Phase 19 (d): the train CLI on MESH[cards]'s flags, trained then
    resumed: the checkpoint's table, EMA and moments whole, rank 0's
    launches one a step."""
    import numpy as np
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.train import checkpoints
    from autolabel_tpu_torch.utils import fixtures
    scene = os.path.join(WORK_DIR, 'cli', 'sphere')
    if not os.path.isdir(scene):
        fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    ws = os.path.join(work, 'cli')
    flags = MESH[cards]['cli']
    legs = []
    for iters in MESH_CLI_ITERS:
        t0 = time.perf_counter()
        run = cli.main([scene, '--workspace', ws, '--iters', str(iters)]
                       + flags)
        legs.append(dict(iters=iters, wall_s=time.perf_counter() - t0,
                         train_s=run.train_s, launches=run.launches))
    payload = checkpoints.load_checkpoint(os.path.join(run.model_dir,
                                                       'checkpoints'))
    whole = (TPU_GRID.n_levels, TPU_GRID.table_size, TPU_GRID.n_features)
    shapes = [np.shape(payload['model']['encoder']['grid']),
              np.shape(payload['ema']['encoder']['grid']),
              np.shape(payload['optimizer']['mu']['encoder.grid']),
              np.shape(payload['optimizer']['nu']['encoder.grid'])]
    checks.true('mesh (d) CLI checkpoint host-complete and resumed',
                all(s == whole for s in shapes)
                and payload['global_step'] == sum(MESH_CLI_ITERS)
                and bool(np.isfinite(payload['model']['encoder']['grid'])
                         .all()),
                f'{shapes}, step {payload["global_step"]}')
    for leg in legs:
        for name in names[:3]:
            got = leg['launches'].get(name, 0)
            checks.true(f'mesh (d) CLI {leg["iters"]} iterations rank 0 '
                        f'launches {name}', got == leg['iters'],
                        f'{got} (expected {leg["iters"]})')
        print(f'mesh (d) [{gpu}] CLI {" ".join(flags)} --iters '
              f'{leg["iters"]}: {leg["wall_s"]:.1f} s with the spawn, '
              f'{leg["train_s"] * 1e3 / leg["iters"]:.3f} ms a step on rank 0 '
              '(the communicators\' set-up in its first step included)')
    return legs


def _mesh_pose_cli(gpu, checks, scene, ws, flags):
    """Phase 19 (e) through the train CLI: `flags` with
    --pose-refine-experimental for MESH_POSE_CLI_ITERS iterations; rank 0
    writes poses_refined.npz (R, t and the frames' stems of the train
    split), frame 0 kept, the other frames moved; rank 0's launches one a
    step."""
    import numpy as np
    from autolabel_tpu_torch.core.dataset import SceneDataset
    from autolabel_tpu_torch.train import __main__ as cli
    iters = MESH_POSE_CLI_ITERS
    t0 = time.perf_counter()
    run = cli.main([scene, '--workspace', ws, '--iters', str(iters),
                    '--pose-refine-experimental'] + flags)
    leg = dict(iters=iters, wall_s=time.perf_counter() - t0,
               train_s=run.train_s, launches=run.launches)
    path = os.path.join(run.model_dir, 'poses_refined.npz')
    checks.true('mesh (e) CLI pose refinement: rank 0 wrote '
                'poses_refined.npz', run.poses_refined == path
                and os.path.exists(path), str(run.poses_refined))
    saved = np.load(path)
    ds = SceneDataset('train', scene, factor=1.0, batch_size=512, lazy=True,
                      load_semantic=False)
    R0, t0s = np.asarray(ds.rotations), np.asarray(ds.origins)
    n = len(ds.indices)
    stems = [os.path.basename(p).split('.')[0]
             for p in ds.scene.rgb_paths()]
    anchor = max(float(np.abs(saved['R'][0] - R0[0]).max()),
                 float(np.abs(saved['t'][0] - t0s[0]).max()))
    moved = float(np.abs(saved['t'][1:] - t0s[1:]).max())
    checks.true('mesh (e) CLI poses_refined.npz: the train frames\' R, t and '
                'stems, frame 0 kept, the others moved',
                saved['R'].shape == (n, 3, 3) and saved['t'].shape == (n, 3)
                and list(saved['frames']) == [stems[i] for i in ds.indices]
                and bool(np.isfinite(saved['R']).all()) and anchor <= 1e-6
                and moved > 0,
                f'{n} frames, frame 0 within {anchor:.3e}, largest move '
                f'{moved:.3e} m')
    # the CLI's heads are 'xla' (no --heads-impl pallas): the encode's
    # kernels alone
    _check_launches(checks, f'mesh (e) CLI {iters} iterations rank 0',
                    run.launches, _pose_names()[:3], iters)
    print(f'mesh (e) [{gpu}] CLI {" ".join(flags)} --pose-refine-experimental'
          f' --iters {iters}: {leg["wall_s"]:.1f} s with the spawn, '
          f'{leg["train_s"] * 1e3 / iters:.3f} ms a step on rank 0')
    return leg


def _mesh_cards_main(args, dev, gpu, checks, t_start, build_s):
    """--mesh-cards N: phase 19 alone on N cards (on four, a rank a
    card)."""
    import torch
    if torch.cuda.device_count() < args.mesh_cards:
        _fail_early(f'--mesh-cards {args.mesh_cards} needs as many cards; '
                    f'{torch.cuda.device_count()} present')
    for index in range(args.mesh_cards):
        print(f'card {index}: {_gpu_line(index)}')
    mesh_run = _mesh_phase(dev, args.seed, gpu, checks, args.mesh_cards)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_mesh_cards.json'), 'w') as f:
        json.dump({'gpu': gpu, 'build_s': build_s, 'mesh': mesh_run,
                   'failures': checks.failures}, f, indent=1)
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    if checks.failures:
        print(f'FAILED: {checks.failures}', file=sys.stderr)
        return 1
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


# The online node and the labelling window (phase 20). (a) ros/node.py at
# its own configuration under a ROS stand-in carried here (subscribers,
# publishers and services as callables, cv_bridge passing arrays through),
# fed phase 15 (e)'s room frames as messages, with --features lseg
# --allow-fallback: the card has no teacher weights, so the keyframes'
# features come from the stand-in extractor. (b) ui/window.py with Qt stood
# in for by tests/qt_stub.py (the card has no PyQt6) over phase 15's room at
# the GUI's defaults, its strokes reaching a live backend child on the card.
NODE_PROMPTS = 'background|wall|floor|ball|table'
NODE_BURSTS = 3  # the node's bursts of 100 steps waited for
NODE_LATE = (4, 13, 22, 31)  # frames whose depth comes 50 ms late: dropped
NODE_TRACED_BURST = 1  # this burst (from 0) runs under torch.profiler
WINDOW_STROKES = 5  # strokes, each timed from labels_changed to a preview


class _RosStandIn:
    """The ROS 1 modules the node imports (rospy, tf, cv_bridge and the
    message modules), as callables: subscribers and services kept by
    topic, publishers' messages kept by topic, cv_bridge passing arrays
    through. install() puts them in sys.modules, remove() takes them
    out."""

    def __init__(self):
        import types
        self.subs, self.pubs, self.services = {}, {}, {}
        ros = self

        class Subscriber:
            def __init__(self, topic, msg_type, callback, queue_size=None):
                self.topic = topic
                ros.subs[topic] = callback

            def unregister(self):
                ros.subs.pop(self.topic, None)

        class Publisher:
            def __init__(self, topic, msg_type, queue_size=None):
                self.msgs = ros.pubs.setdefault(topic, [])

            def publish(self, msg):
                self.msgs.append(msg)

        class Service:
            def __init__(self, name, srv, handler):
                ros.services[name] = handler

        class CvBridge:
            def imgmsg_to_cv2(self, msg, encoding=None):
                return msg.array

            def cv2_to_imgmsg(self, array, encoding=None):
                return types.SimpleNamespace(
                    array=array, header=types.SimpleNamespace(stamp=None))

        def module(name, **attrs):
            mod = types.ModuleType(name)
            mod.__dict__.update(attrs)
            return mod

        def msgs(name, *classes):
            return module(name, **{c: type(c, (), {}) for c in classes})

        now = types.SimpleNamespace(to_sec=lambda: time.monotonic())
        self.modules = {
            'rospy': module('rospy', Subscriber=Subscriber,
                            Publisher=Publisher, Service=Service,
                            Time=types.SimpleNamespace(now=lambda: now),
                            spin=lambda: None, init_node=lambda name: None),
            'tf': module('tf', TransformListener=lambda: None),
            'cv_bridge': module('cv_bridge', CvBridge=CvBridge),
            'geometry_msgs': module('geometry_msgs'),
            'geometry_msgs.msg': msgs('geometry_msgs.msg', 'PoseStamped'),
            'sensor_msgs': module('sensor_msgs'),
            'sensor_msgs.msg': msgs('sensor_msgs.msg', 'Image',
                                    'CameraInfo'),
            'std_msgs': module('std_msgs'),
            'std_msgs.msg': msgs('std_msgs.msg', 'String'),
            'std_srvs': module('std_srvs'),
            'std_srvs.srv': msgs('std_srvs.srv', 'Empty'),
        }
        self._saved = {}

    def install(self):
        self._saved = {name: sys.modules.get(name) for name in self.modules}
        sys.modules.update(self.modules)

    def remove(self):
        for name, module in self._saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _header(t, seq=0):
    import types
    return types.SimpleNamespace(
        stamp=types.SimpleNamespace(to_sec=lambda: t), seq=seq)


def _quaternion(R):
    """(x, y, z, w) of a rotation matrix (Shepperd's method)."""
    import numpy as np
    trace = np.trace(R)
    if trace > 0:
        s = 2.0 * np.sqrt(trace + 1.0)
        return ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s, 0.25 * s)
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = [0.0] * 4
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return tuple(q)


def _pose_message(t, T_CW):
    """A PoseStamped-like keyframe or odometry message of the camera at
    T_CW (its pose camera->world, as the SLAM front end publishes it)."""
    import types
    import numpy as np
    T_WC = np.linalg.inv(T_CW)
    x, y, z, w = _quaternion(T_WC[:3, :3])
    px, py, pz = T_WC[:3, 3]
    ns = types.SimpleNamespace
    return ns(header=_header(t), pose=ns(
        position=ns(x=px, y=py, z=pz), orientation=ns(x=x, y=y, z=z, w=w)))


def _node_leg(gpu, checks, names):
    """Phase 20 (a): the online node, fed the room frames as messages,
    until NODE_BURSTS bursts have trained; stopped; its launches read."""
    import threading
    import types

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from autolabel_tpu_torch.constants import COLORS
    from autolabel_tpu_torch.ops import _kernels
    from autolabel_tpu_torch.ros import node as node_mod
    t0 = time.perf_counter()
    frames = _online_frames()  # made once a run (phase 15 (e) first)
    frames_s = time.perf_counter() - t0
    w, h = ONLINE_SIZE
    ros = _RosStandIn()
    bursts, previews, parts, ingested = [], [], [], []
    finite = {'features': [], 'depth': []}
    trace = {k: threading.Event() for k in ('asked', 'open', 'done',
                                             'closed')}
    prof = None
    visualization = node_mod.visualization
    node = None
    ros.install()
    try:
        flags = node_mod.read_args(['--features', 'lseg',
                                    '--allow-fallback'])
        t0 = time.perf_counter()
        node = node_mod.AutolabelNode(flags)  # no device: the card
        build_s = time.perf_counter() - t0
        loop, trainer, bridge = node.training_loop, \
            node.training_loop.trainer, node.bridge
        train_iterations, render_frame = (trainer.train_iterations,
                                          loop.render_frame)
        add_frame, to_message = loop.add_frame, bridge.features_to_message
        staged_render = trainer._staged.render

        def timed_burst(dataloader, iterations, progress=True):
            traced = len(bursts) == NODE_TRACED_BURST
            if traced:  # the main thread opens the trace (see below)
                trace['asked'].set()
                trace['open'].wait(120)
            _sync()
            t0 = time.perf_counter()
            out = train_iterations(dataloader, iterations, progress)
            loss = float(out['total'])
            _sync()
            wall = time.perf_counter() - t0
            if traced:  # paused while the main thread reads the trace
                trace['wall_ms'] = wall * 1e3
                trace['done'].set()
                trace['closed'].wait(120)
            bursts.append(dict(ms_step=wall / iterations * 1e3, loss=loss,
                               frames=len(loop.dataset), traced=traced,
                               step=trainer.global_step))
            return out

        def timed_render():
            _sync()
            t0 = time.perf_counter()
            render_frame()
            _sync()
            previews.append((time.perf_counter() - t0) * 1e3)
            parts[-1]['whole_ms'] = previews[-1]

        def timed_staged(*args):
            t0 = time.perf_counter()
            out = staged_render(*args)
            _sync()
            parts.append({'render_ms': (time.perf_counter() - t0) * 1e3})
            return out

        def kept_frame(frame):
            ingested.append((frame.num, frame.T_CW))
            add_frame(frame)

        def features_to_message(feature_map):
            finite['features'].append(
                feature_map.shape == (h, w, 512)
                and bool(np.isfinite(feature_map).all()))
            t0 = time.perf_counter()
            msg = to_message(feature_map)
            parts[-1]['colour_ms'] = (time.perf_counter() - t0) * 1e3
            return msg

        def visualize_depth(depth, maxdepth=None):
            finite['depth'].append(depth.shape == (h, w)
                                   and bool(np.isfinite(depth).all()))
            return visualization.visualize_depth(depth, maxdepth)

        trainer.train_iterations, loop.render_frame = timed_burst, \
            timed_render
        trainer._staged.render = timed_staged
        loop.add_frame, bridge.features_to_message = kept_frame, \
            features_to_message
        node_mod.visualization = types.SimpleNamespace(
            visualize_depth=visualize_depth)

        _sync()
        _kernels.reset_launches()
        t_start = time.perf_counter()
        ros.subs['/slam/camera_info'](types.SimpleNamespace(
            K=list(_online_camera().ravel()), width=w, height=h))
        expected = []
        for i, (T_CW, rgb, depth) in enumerate(frames):
            t = 1.0 + 0.1 * i
            late = i in NODE_LATE
            ros.subs['/slam/rgb'](types.SimpleNamespace(
                header=_header(t, seq=i), array=rgb))
            ros.subs['/slam/depth'](types.SimpleNamespace(
                header=_header(t + (0.05 if late else 0.004)), array=depth))
            ros.subs['/slam/keyframe'](_pose_message(t + 0.008, T_CW))
            if not late:
                expected.append(i)
        feed_s = time.perf_counter() - t_start
        ros.subs['/slam/odometry'](_pose_message(9.0, frames[0][0]))
        ros.subs['/autolabel/segmentation_classes'](types.SimpleNamespace(
            data=NODE_PROMPTS))
        prompted = len(ros.pubs.get('/autolabel/features', []))
        toggles = []
        for service, state in (('/autolabel/pause', lambda: node.reading),
                               ('/autolabel/train', lambda: loop.training)):
            ros.services[service](None)
            toggles.append(state())
            if service == '/autolabel/pause':
                # paused: an in-sync triple is dropped
                T_CW, rgb, depth = frames[1]
                ros.subs['/slam/rgb'](types.SimpleNamespace(
                    header=_header(8.0, seq=99), array=rgb))
                ros.subs['/slam/depth'](types.SimpleNamespace(
                    header=_header(8.0), array=depth))
                ros.subs['/slam/keyframe'](_pose_message(8.0, T_CW))
            ros.services[service](None)
            toggles.append(state())
        # Wait for the bursts; open the profiler here, in the main thread,
        # when the loop's thread reaches the traced burst, and read it when
        # that burst is done (a trace opened in the loop's thread slowed
        # its steps tenfold; one read while the loop ran on slowed the next
        # burst twofold).
        deadline = time.monotonic() + 300
        while not (trainer.global_step >= 100 * NODE_BURSTS and len(
                ros.pubs.get('/autolabel/features', [])) > prompted
                and 'rows' in trace):
            if trace['asked'].is_set() and prof is None:
                # device activity only: a burst's host ops take long to read
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                for _ in range(TRACE_MARKERS):
                    torch.cuda._sleep(1000)
                trace['open'].set()
            if trace['done'].is_set() and 'rows' not in trace:
                t_read = time.perf_counter()
                prof.stop()
                rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0
                        and MARKER not in e.key]
                rows.sort(key=lambda r: -r[1])
                trace['rows'] = rows
                trace['busy_ms'] = sum(r[1] for r in rows)
                trace['read_s'] = time.perf_counter() - t_read
                trace['closed'].set()
            if time.monotonic() > deadline:
                raise TimeoutError(f'{NODE_BURSTS} bursts of the node: not '
                                   'within 300 s')
            time.sleep(0.002)
    finally:
        if prof is not None and 'rows' not in trace:
            prof.stop()
        trace['closed'].set()
        if node is not None:
            node.stop()
        node_mod.visualization = visualization
        ros.remove()
    launches = dict(_kernels.launches)
    checks.true('node takes in exactly the in-sync keyframes',
                [n for n, _ in ingested] == expected
                and len(loop.dataset) == len(expected)
                and all(np.abs(T - frames[n][0]).max() < 1e-9
                        for n, T in ingested),
                f'{len(ingested)} of {len(frames)} triples (+1 paused), '
                f'{len(expected)} in sync')
    checks.true('node services and camera_info',
                toggles == [False, True, False, True]
                and '/slam/camera_info' not in ros.subs
                and bridge.prompt_features.shape == (5, 512), f'{toggles}')
    checks.true('node threads end on stop()',
                not loop.training_thread.is_alive()
                and not loop.dataset._prefetch_thread.is_alive())
    image = ros.pubs['/autolabel/image']
    colours = ros.pubs['/autolabel/features'][-1].array
    palette = {tuple(c) for c in (COLORS[:5] * 255).astype(np.uint8)}
    checks.true('node previews',
                len(image) == len(previews) >= 1
                and all(m.array.shape == (h, w, 3) and m.array.dtype
                        == np.uint8 for m in image)
                and all(m.array.shape == (h, w, 3) and m.array.dtype
                        == np.uint8 for m in ros.pubs['/autolabel/depth'])
                and colours.shape == (h, w, 3)
                and {tuple(c) for c in colours.reshape(-1, 3)} <= palette
                and all(finite['features']) and all(finite['depth'])
                and len(finite['depth']) == len(previews),
                f'{len(previews)} previews: image, depth and class colours '
                f'of {NODE_PROMPTS.count("|") + 1} prompts at {w} x {h}, '
                f'{len(np.unique(colours.reshape(-1, 3), axis=0))} colours '
                'in the last')
    checks.true('node bursts', len(bursts) >= NODE_BURSTS and all(
        np.isfinite(b['loss']) for b in bursts), f'{bursts}')
    checks.true('node field on the card', all(
        t.device.type == 'cuda' for t in loop.field.state_dict().values()))
    for key in ('K6', 'K7'):
        got = launches.get(names[key], 0)
        checks.true(f'node launches {key}', got >= trainer.global_step,
                    f'{got} launches over {trainer.global_step} steps')
    plain = [b['ms_step'] for b in bursts if not b['traced']]
    busy_share = untraced_share = None
    if trace.get('rows'):
        busy_share = trace['busy_ms'] / trace['wall_ms']
        # against the next burst's wall, since a trace slows steps
        untraced_share = trace['busy_ms'] / (
            100 * bursts[NODE_TRACED_BURST + 1]['ms_step'])
    out = dict(bursts=bursts, preview_ms=previews, preview_parts=parts,
               preview_p50_p90=_pcts(previews), ms_step=_pcts(plain),
               busy_share=busy_share, untraced_busy_share=untraced_share,
               trace_busy_ms=trace.get('busy_ms'),
               trace_wall_ms=trace.get('wall_ms'),
               trace_read_s=trace.get('read_s'),
               trace_rows=trace.get('rows', [])[:12], launches=launches,
               feed_s=feed_s, frames=len(ingested), frames_s=frames_s,
               build_s=build_s,
               global_step=trainer.global_step)
    print(f'node [{gpu}]: --features lseg --allow-fallback (stand-in '
          'teacher features: the repo has no weights), built in '
          f'{build_s:.3f} s (frames made in {frames_s:.3f} s); '
          f'{len(ingested)} keyframes of {w} x {h} taken in over {feed_s:.3f}'
          f' s; {len(bursts)} bursts: ms a step '
          + ', '.join(f'{b["ms_step"]:.3f}' + (' (traced)' if b['traced']
                                               else '') for b in bursts)
          + f'; ms a preview (p50/p90) {out["preview_p50_p90"]} over '
          f'{len(previews)}: the render (24 chunks of 2,048 rays x 128 '
          f'samples) {_pcts([p["render_ms"] for p in parts])}, the class '
          f'colouring on the host {_pcts([p["colour_ms"] for p in parts])}'
          ', the rest (the copy to the host, the depth map, publishing) '
          + str(_pcts([p['whole_ms'] - p['render_ms'] - p['colour_ms']
                       for p in parts])))
    if busy_share is None:
        print('node profile: the trace holds no device time: not measured')
    else:
        print(f'node profile [{gpu}]: burst {NODE_TRACED_BURST}: device busy '
              f'{trace["busy_ms"]:.3f} of {trace["wall_ms"]:.3f} ms: busy '
              f'share {busy_share:.4f}; of the next burst\'s 100 x '
              f'{bursts[NODE_TRACED_BURST + 1]["ms_step"]:.3f} ms: '
              f'{untraced_share:.4f} (the trace read in '
              f'{trace["read_s"]:.3f} s, the loop paused)')
        for name, ms, count in trace['rows'][:6]:
            print(f'  {ms:9.3f} ms {ms / trace["busy_ms"]:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    return out


def _load_qt_stub():
    """tests/qt_stub.py, the PyQt6 stand-in, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        'qt_stub', os.path.join(HERE, 'tests', 'qt_stub.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _window_leg(gpu, checks):
    """Phase 20 (b): the labelling window over phase 15's room with a live
    backend child on the card: strokes of two classes, each stroke's end
    timed to the next preview of its frame; closeEvent stops the child."""
    import numpy as np
    from autolabel_tpu_torch import gui
    from autolabel_tpu_torch.ui import window as window_mod
    from autolabel_tpu_torch.utils import Scene, fixtures
    from autolabel_tpu_torch.utils.images import read_png
    qt_stub = _load_qt_stub()
    saved = {name: sys.modules.get(name) for name in
             ('PyQt6', 'PyQt6.QtCore', 'PyQt6.QtGui', 'PyQt6.QtWidgets')}
    qt_stub.install()
    scene = os.path.join(WORK_DIR, 'backend', 'room')
    t0 = time.perf_counter()
    if not os.path.isdir(scene):  # phase 20 alone
        fixtures.make_room_scene(scene, **BACKEND_SCENE)
    scene_s = time.perf_counter() - t0
    n_classes = Scene(scene).n_classes
    flags = gui.read_args([scene] + BACKEND_FLAGS)
    w, h = _backend_size()
    previews, codes, rtt = [], [], []
    win = None
    try:
        t_spawn = time.monotonic()
        win = window_mod.LabelerWindow(flags)  # no device: the card

        def on_preview(payload):
            previews.append((time.monotonic(), payload))
            win._on_preview(payload)

        win.backend.on_preview = on_preview
        _wait(lambda: win.backend.poll() or previews, 600,
              'the window\'s first preview')
        first_s = previews[0][0] - t_spawn
        for k in range(WINDOW_STROKES):
            cls = 1 + k % 2
            if win.active_class != cls:
                win.select_class(cls)
            y = 80.0 + 70.0 * k
            for x0 in range(60, 600, 90):
                win._on_stroke((float(x0), y), (float(x0 + 90), y + 20.0))
            count = len(previews)
            t0 = time.monotonic()
            win._on_stroke_end()  # the PNG, then labels_changed
            win._request_preview()  # what the window's timer sends
            _wait(lambda: win.backend.poll() or len(previews) > count, 120,
                  f'the preview after stroke {k}')
            rtt.append((previews[-1][0] - t0) * 1e3)
        bitmap = win.annotations.get(win.frame_name)
        png = read_png(os.path.join(scene, 'semantic',
                                    f'{win.frame_name}.png'))
        stop = win.backend.stop
        win.backend.stop = lambda: codes.append(stop())
        t0 = time.monotonic()
        win.closeEvent(qt_stub._Stub())
        close_s = time.monotonic() - t0
    finally:
        if win is not None and win.backend._process is not None:
            gui.BackendClient.stop(win.backend)
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    payload = previews[-1][1]
    checks.true('window PNG is the annotation bitmap',
                png.shape == bitmap.shape and bool((png == bitmap).all())
                and {2, 3} <= set(np.unique(bitmap).tolist()),
                f'{png.shape}, values {sorted(np.unique(bitmap).tolist())}')
    checks.true('window preview', all(
        p['image_index'] == 0 and p['rgb'].shape == (h, w, 3)
        and p['depth'].shape == (h, w) and p['semantic'].shape == (h, w)
        and p['semantic'].dtype == np.int32
        and bool(np.isfinite(p['rgb']).all())
        and bool(np.isfinite(p['depth']).all())
        and 0 <= int(p['semantic'].min())
        and int(p['semantic'].max()) < n_classes for _, p in previews),
        f'{len(previews)} previews of {w} x {h}, classes '
        f'{sorted(np.unique(payload["semantic"]).tolist())} of {n_classes}')
    checks.true('window closeEvent stops the child',
                codes == [0] and close_s < gui.STOP_TIMEOUT_S
                and win.backend._process is None,
                f'exit codes {codes} in {close_s:.3f} s')
    out = dict(scene_s=scene_s, first_preview_s=first_s,
               labels_to_preview_ms=rtt,
               labels_to_preview_p50=_median(rtt), close_s=close_s,
               previews=len(previews))
    print(f'window [{gpu}]: the room made in {scene_s:.3f} s; first preview '
          f'{first_s:.3f} s after the spawn; '
          f'{WINDOW_STROKES} strokes of classes 1 and 2 on frame 0: ms from '
          f'labels_changed to the next preview {[round(v, 3) for v in rtt]}'
          f' (p50 {out["labels_to_preview_p50"]:.3f}); closeEvent stopped '
          f'the child in {close_s:.3f} s')
    return out


def _host_modules_phase(dev, gpu, checks):
    """Phase 20 (see the module docstring). Returns what the output file
    keeps; its 'launches' are the node's counts by kernel name."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    del dev  # both legs run on the card by default, as a user's would
    phase_start = time.perf_counter()
    names = {'K6': hashgrid_cuda.STOCHASTIC_NAME,
             'K7': hashgrid_cuda.STOCHASTIC_BWD_NAME}
    torch.cuda.empty_cache()
    out = {'node': _node_leg(gpu, checks, names)}
    node_s = time.perf_counter() - phase_start
    torch.cuda.empty_cache()
    out['window'] = _window_leg(gpu, checks)
    out['launches'] = {'online_node': out['node']['launches']}
    out['phase_s'] = time.perf_counter() - phase_start
    print(f'phase 20: {out["phase_s"]:.1f} s (the node {node_s:.1f} s)')
    return out


def _phase_alone_main(args, dev, gpu, checks, t_start, build_s):
    """--phase 20: that phase alone, after the build."""
    import torch
    out = _host_modules_phase(dev, gpu, checks)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_phase20.json'), 'w') as f:
        json.dump({'gpu': gpu, 'build_s': build_s, 'host_modules': out,
                   'failures': checks.failures}, f, indent=1)
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    if checks.failures:
        print(f'FAILED: {checks.failures}', file=sys.stderr)
        return 1
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--mesh-cards', type=int, default=None,
                        choices=sorted(MESH),
                        help="Run phase 19 alone on this many cards (with "
                        "four, a rank a card under NCCL).")
    parser.add_argument('--phase', type=int, default=None, choices=(20,),
                        help="Run this phase alone, after the build.")
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail_early('no CUDA device is available')
    if not os.path.isdir(os.path.join(HERE, 'autolabel_tpu_torch')):
        _fail_early('autolabel_tpu_torch/ is not beside this script; run it '
                    'from a checkout of the repository')
    sys.path.insert(0, HERE)
    from autolabel_tpu_torch import bridge
    from autolabel_tpu_torch.core import rays
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.models.field import Field
    from autolabel_tpu_torch.ops import (_kernels, ba_cuda, hashgrid_cuda,
                                         heads_cuda)
    from autolabel_tpu_torch.ops.encoders import TPU_GRID, HashGridConfig
    from autolabel_tpu_torch.render.renderer import draw_perturbations
    from autolabel_tpu_torch.train import checkpoints

    # fp32 products in the plain versions stay full fp32 (PyTorch's
    # default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()
    checks = Checks()
    gpu = _gpu_line()
    print(f'gpu: {gpu}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]} devices '
          f'{torch.cuda.device_count()}')
    optional = _optional_modules()
    print('optional modules: ' + ', '.join(
        f'{name} {version}' if version else f'{name} missing'
        for name, version in optional.items()))

    # ---- 2. build
    build_s = _kernels.build_all()
    print(f'build: {build_s:.1f} s for {", ".join(_kernels.SOURCES)}')
    for source, log in _kernels.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {source}: {line.strip()}')
    if args.mesh_cards:
        return _mesh_cards_main(args, dev, gpu, checks, t_start, build_s)
    if args.phase:
        return _phase_alone_main(args, dev, gpu, checks, t_start, build_s)

    g = torch.Generator().manual_seed(args.seed)
    results = {}
    # ---- 3. K1: hash-grid encode
    n1 = 524288
    x = torch.rand((n1, 3), generator=g)
    x[:8] = torch.tensor([[0., 0., 0.], [1., 1., 1.], [0., 1., 0.5],
                          [1., 0., 0.999999], [1., 1., 0.], [0.5, 0., 1.],
                          [0.25, 0.75, 1.], [1., 0.5, 0.5]])
    x = x.to(dev)
    table = (torch.randn((TPU_GRID.n_levels, TPU_GRID.table_size,
                          TPU_GRID.n_features), generator=g) * 0.5).to(dev)
    enc = hashgrid_cuda.hashgrid_encode(table, x, TPU_GRID)
    enc_plain = hashgrid_cuda.hashgrid_encode_plain(table, x, TPU_GRID)
    torch.cuda.synchronize()
    # Same products and sums in the same order, rounded the same way: the
    # kernel should agree to the last bits; 1e-5 absolute on O(1) values.
    k1_err = checks.close('K1 encode TPU_GRID N=524288', enc, enc_plain,
                          atol=1e-5, rtol=0.0)
    ref_grid = HashGridConfig()
    x_ref = x[:65536].contiguous()
    table_ref = (torch.randn((ref_grid.n_levels, ref_grid.table_size,
                              ref_grid.n_features), generator=g)
                 * 0.5).to(dev)
    checks.close('K1 encode reference 16x2x2^19 N=65536',
                 hashgrid_cuda.hashgrid_encode(table_ref, x_ref, ref_grid),
                 hashgrid_cuda.hashgrid_encode_plain(table_ref, x_ref,
                                                     ref_grid),
                 atol=1e-5, rtol=0.0)
    _hold_narrow_edges(checks, hashgrid_cuda, HashGridConfig, dev,
                       torch.Generator().manual_seed(args.seed + 24))
    k1_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(table, x,
                                                           TPU_GRID), 20)
    k1_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_plain(
        table, x, TPU_GRID), 3)
    k1_bound = _bound(_nbytes(x, table, enc),
                      16 * n1 * TPU_GRID.out_dim, PEAK_FP32)
    results['K1'] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                         bound=k1_bound, library_ms=None)
    # The rows the gathers read (8 corner rows of F fp32 per point and
    # level), which the byte bound counts once per table row instead.
    k1_gathered = 8 * TPU_GRID.n_features * 4 * n1 * TPU_GRID.n_levels
    print(f'K1 [{gpu}] uniform N={n1}: {k1_ms:.4f} ms, gathers '
          f'{k1_gathered / 1e9:.3f} GB a launch '
          f'({k1_gathered / k1_ms / 1e9:.3f} TB/s), bound '
          f'{k1_bound[0]:.4f} ms ({k1_bound[1]})')
    # The narrow path (the reference preset's F = 2) at the same N, held
    # bit-equal to its plain version there.
    checks.true(f'K1 encode reference 16x2x2^19 N={n1} bit-equal',
                torch.equal(hashgrid_cuda.hashgrid_encode(table_ref, x,
                                                          ref_grid),
                            hashgrid_cuda.hashgrid_encode_plain(
                                table_ref, x, ref_grid)))
    k1_narrow_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(
        table_ref, x, ref_grid), 20)
    k1_narrow_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_plain(
        table_ref, x, ref_grid), 3)
    print(f'K1 [{gpu}] reference 16x2x2^19 N={n1} (narrow rows): '
          f'{k1_narrow_ms:.4f} ms, plain {k1_narrow_plain:.4f} ms')
    shapes = {'K1': hashgrid_cuda.encode_launch_shapes(TPU_GRID, n1),
              'K1 reference': hashgrid_cuda.encode_launch_shapes(ref_grid,
                                                                 n1)}
    _print_shapes(gpu, {f'{key} N={n1} {kernel}': sh
                        for key in ('K1', 'K1 reference')
                        for kernel, sh in shapes[key].items()})

    # ---- 5a. the model (built here so K3f/K4f see its real weights)
    config = _model_config()
    assert config.bound == 2.0 and config.grid == TPU_GRID
    field = Field(config, device=dev, generator=g)
    # A table far from its U(-1e-4, 1e-4) init, so density, color and
    # semantics are non-trivial.
    with torch.no_grad():
        field.encoder['grid'].copy_(
            torch.randn(field.encoder['grid'].shape, generator=g) * 0.5)
    params = {k: [w.detach() for w in ws]
              for k, ws in field.head_params().items()}

    # ---- 4. K3f: fused heads; K4f: proposal MLP
    n3 = 524288
    A = enc[:n3]
    B = torch.zeros((n3, 32), device=dev)
    B[:, :12] = torch.rand((n3, 12), generator=g).to(dev) * 2 - 1
    B[:, 16:32] = torch.randn((n3, 16), generator=g).to(dev) * 0.3
    # Packed and cast to bf16 once, as the field does.
    packed = [w.to(torch.bfloat16)
              for w in heads_cuda.pack_head_weights(params, 12)]
    got = heads_cuda.fused_heads(packed, A, B)
    want = heads_cuda.fused_heads_plain(packed, A, B, torch.bfloat16)
    torch.cuda.synchronize()
    # bf16 operands and fp32 accumulation on both sides; only the
    # accumulation order differs, which can flip the bf16 rounding of an
    # intermediate (2^-8 relative) and carries through the later layers.
    k3_err = max(checks.close(f'K3f {name} N=524288', a, b, atol=2e-2,
                              rtol=2e-2)
                 for name, a, b in zip(('out1', 'features', 'logits'),
                                       got, want))
    shapes['K3f'] = heads_cuda.heads_launch_shapes(packed, A, B)
    _print_shapes(gpu, {'K3f N=524288 heads_fwd_kernel':
                        shapes['K3f']['heads_fwd_kernel']})
    k3_ms = _cuda_ms(lambda: heads_cuda.fused_heads(packed, A, B), 10)
    k3_plain = _cuda_ms(lambda: heads_cuda.fused_heads_plain(
        packed, A, B, torch.bfloat16), 3)

    def heads_library():
        # The yardstick: the same stack as a chain of native bf16 cuBLAS
        # products (bf16 outputs between layers).
        (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
         W1o) = packed
        a, b = A.to(torch.bfloat16), B.to(torch.bfloat16)
        h = torch.relu(a @ WA + b @ WBs)
        S = torch.relu(h @ W1s) @ W2s
        c = torch.relu(torch.relu(b @ WBc + S @ WSc) @ W1c) @ W2c
        F = torch.relu(torch.relu(S @ WSf) @ W1f) @ W2f
        L = torch.relu(torch.relu(F) @ WFo + S @ WSo) @ W1o
        return torch.exp(torch.clamp(S[:, :1].float(), max=15.0)), \
            torch.sigmoid(c[:, :3].float()), F, L

    k3_lib = _cuda_ms(heads_library, 10)
    # The function's own work, at the real widths (no padding): A, B's 28
    # real columns (12 freq, 16 SH), the 14 bf16 matrices, and 4 + S + C
    # output columns; one MAC per weight entry per point.
    head_macs = sum(w.numel() for ws in params.values() for w in ws)
    n_out = 4 + params['semantic_features'][2].shape[1] \
        + params['semantic_out'][1].shape[1]
    k3_bound = _bound(_nbytes(A) + n3 * (12 + 16) * 4 + head_macs * 2
                      + n3 * n_out * 4, 2 * n3 * head_macs, PEAK_BF16)
    results['K3f'] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
                          bound=k3_bound, library_ms=k3_lib)

    n4 = 1048576
    X = torch.rand((n4, 36), generator=g).to(dev) * 2 - 1
    packed3 = [w.to(torch.bfloat16) for w in heads_cuda.pack_mlp3(
        [w.detach() for w in field.proposal])]
    got4 = heads_cuda.fused_mlp3(packed3, X)
    want4 = heads_cuda.fused_mlp3_plain(packed3, X, torch.bfloat16)
    k4_err = checks.close('K4f mlp3 N=1048576', got4, want4, atol=2e-2,
                          rtol=2e-2)
    shapes['K4f'] = {'mlp3_fwd_kernel': heads_cuda.mlp3_launch_shapes(
        packed3, X)['mlp3_fwd_kernel']}
    _print_shapes(gpu, {f'K4f N={n4} {kernel}': sh
                        for kernel, sh in shapes['K4f'].items()})
    k4_ms = _cuda_ms(lambda: heads_cuda.fused_mlp3(packed3, X), 20)
    k4_plain = _cuda_ms(lambda: heads_cuda.fused_mlp3_plain(
        packed3, X, torch.bfloat16), 5)

    def mlp3_library():
        Xp = torch.nn.functional.pad(X, (0, packed3[0].shape[0] - 36))
        h = torch.relu(Xp.to(torch.bfloat16) @ packed3[0])
        return torch.relu(h @ packed3[1]) @ packed3[2]

    k4_lib = _cuda_ms(mlp3_library, 20)
    # X, the 3 bf16 matrices and the one real output column (36-64-64-1).
    mlp3_macs = sum(w.numel() for w in field.proposal)
    k4_bound = _bound(_nbytes(X) + mlp3_macs * 2 + n4 * 4,
                      2 * n4 * mlp3_macs, PEAK_BF16)
    results['K4f'] = dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
                          bound=k4_bound, library_ms=k4_lib)
    del enc_plain, got, want, got4, want4, A, B, X

    # ---- 5b. the slice through the serving entry point
    model_dir = os.path.join(WORK_DIR, 'model')
    tree = bridge.params_to_numpy(field)
    checkpoints.save_checkpoint(
        os.path.join(model_dir, 'checkpoints', 'best.pth'),
        {'params': tree, 'ema': tree, 'step': 0}, include_optimizer=False)
    served = Field(config, device=dev,
                   generator=torch.Generator().manual_seed(args.seed + 1))
    model = InferenceModel.from_checkpoint(
        served, model_dir, num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
        max_ray_batch=MAX_RAY_BATCH)
    checks.true('checkpoint round trip', all(
        torch.equal(a, b) for a, b in zip(served.state_dict().values(),
                                          field.state_dict().values())))
    frames = [_frame(rays, (3.2, -2.4, 1.2)), _frame(rays, (-2.8, -3.0, 0.8))]
    chunks = -(-FRAME_W * FRAME_H // MAX_RAY_BATCH)

    # K1 on the main samples of one render chunk (16,384 rays x 32, in ray
    # order), recorded from a render: does their locality help the gathers?
    n_chunk = MAX_RAY_BATCH * NUM_STEPS
    recorded, encode = [], hashgrid_cuda.hashgrid_encode

    def record(table_, x_, config_, **kwargs):
        if not recorded and x_.shape[0] == n_chunk:
            recorded.append((table_.detach(), x_.detach().clone()))
        return encode(table_, x_, config_, **kwargs)

    hashgrid_cuda.hashgrid_encode = record
    try:
        model.render(frames[0])
    finally:
        hashgrid_cuda.hashgrid_encode = encode
    checks.true('K1 ray-ordered samples recorded', bool(recorded))
    table_r, x_r = recorded[0]
    checks.close(f'K1 encode ray-ordered N={n_chunk}',
                 hashgrid_cuda.hashgrid_encode(table_r, x_r, TPU_GRID),
                 hashgrid_cuda.hashgrid_encode_plain(table_r, x_r, TPU_GRID),
                 atol=1e-5, rtol=0.0)
    k1_ray_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode(
        table_r, x_r, TPU_GRID), 20)
    print(f'K1 [{gpu}] ray-ordered N={n_chunk}: {k1_ray_ms:.4f} ms '
          f'(uniform {k1_ms:.4f} ms)')
    del recorded, table_r, x_r

    torch.cuda.synchronize()
    _kernels.reset_launches()
    frame_s, renders = [], []
    for batch in frames:
        t0 = time.perf_counter()
        renders.append(model.render(batch))  # numpy: synchronised
        frame_s.append(time.perf_counter() - t0)
    launches = dict(_kernels.launches)
    expected = chunks * N_FRAMES
    for name in (hashgrid_cuda.NAME, heads_cuda.HEADS, heads_cuda.MLP3):
        checks.true(f'launches {name}', launches.get(name, 0) == expected,
                    f'{launches.get(name, 0)} (expected {expected})')

    with _plain_kernels(hashgrid_cuda, heads_cuda):
        plain_s, plain_renders = [], []
        for batch in frames:
            t0 = time.perf_counter()
            plain_renders.append(model.render(batch))
            plain_s.append(time.perf_counter() - t0)
    render_errors = {}
    for i, (ours, ref) in enumerate(zip(renders, plain_renders)):
        for key, shape in (('image', (FRAME_H, FRAME_W, 3)),
                           ('depth', (FRAME_H, FRAME_W)),
                           ('semantic', (FRAME_H, FRAME_W, 6)),
                           ('semantic_features', (FRAME_H, FRAME_W, 64))):
            checks.true(f'frame {i} {key} shape and finite',
                        ours[key].shape == shape
                        and bool(np.isfinite(ours[key]).all()))
        # bf16 differences of accumulation order can move a proposal sample
        # by one bin on a few rays: each map must agree with the plain
        # render on average and on all but a handful of pixels, relative to
        # its largest magnitude (1 for the image).
        for key in ('image', 'depth', 'semantic', 'semantic_features'):
            err = np.abs(ours[key] - ref[key])
            scale = 1.0 if key == 'image' else float(np.abs(ref[key]).max())
            mean, p999 = float(err.mean()), float(np.quantile(err, 0.999))
            render_errors[f'frame {i} {key}'] = dict(
                mean_abs=mean, p99_9=p999, max=float(err.max()), scale=scale)
            checks.true(f'frame {i} {key} vs plain render',
                        mean < 5e-3 * scale and p999 < 5e-2 * scale,
                        f'mean_abs={mean:.3e} p99.9={p999:.3e} '
                        f'max={float(err.max()):.3e} (scale {scale:.3e})')
        ws = ours['weights_sum']
        checks.true(f'frame {i} non-trivial density',
                    0.05 < float(ws.mean()) < 0.999,
                    f'mean weights_sum={float(ws.mean()):.4f}')

    # ---- 6. steady state and where the device time goes
    def render_ms(batch):
        t0 = time.perf_counter()
        model.render(batch)  # returns numpy: synchronised
        return (time.perf_counter() - t0) * 1e3

    steady = {'kernels': [], 'plain': []}
    for r in range(TIMED_ROUNDS):
        batch = frames[r % N_FRAMES]
        for side in ('plain', 'kernels', 'kernels', 'plain'):
            if side == 'plain':
                with _plain_kernels(hashgrid_cuda, heads_cuda):
                    steady[side].append(render_ms(batch))
            else:
                steady[side].append(render_ms(batch))
    steady_stats = {k: _quartiles(v) for k, v in steady.items()}
    profile_rows, busy_ms = _device_profile(lambda: model.render(frames[0]))

    rays_per_frame = FRAME_W * FRAME_H
    print(f'render [{gpu}]: ms per frame {[round(s * 1e3, 3) for s in frame_s]} '
          f'(kernels, first two), {[round(s * 1e3, 3) for s in plain_s]} '
          f'(plain)')
    for side, st in steady_stats.items():
        print(f'render steady [{gpu}] {side}: ms per frame median '
              f'{st["median"]:.3f} (q1 {st["q1"]:.3f}, q3 {st["q3"]:.3f}, '
              f'n {st["n"]}); rays/s {rays_per_frame / st["median"] * 1e3:.1f}')
    if profile_rows is None:
        print('profile: the trace holds no device time: not measured')
    else:
        wall = steady_stats['kernels']['median']
        print(f'profile [{gpu}]: device busy {busy_ms:.3f} ms of a '
              f'{wall:.3f} ms frame (median wall, unprofiled): busy share '
              f'{busy_ms / wall:.4f}')
        for name, ms, count in profile_rows[:12]:
            print(f'  {ms:9.3f} ms {ms / busy_ms:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    for key, r in results.items():
        print(f'kernel {key} [{gpu}]: {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]}, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})')

    # ---- 7. the backward kernels at the training step's shapes
    n_tr = TRAIN_BATCH * NUM_STEPS  # main samples per step: 131,072
    x2 = x[:n_tr].contiguous()  # holds the points at 0 and 1
    g2 = torch.randn((n_tr, TPU_GRID.out_dim), generator=g).to(dev)
    k2_err = _check_k2(checks, f'K2 table gradient TPU_GRID N={n_tr}',
                       hashgrid_cuda, g2, x2, TPU_GRID)
    g_ref = torch.randn((65536, ref_grid.out_dim), generator=g).to(dev)
    _check_k2(checks, 'K2 table gradient reference 16x2x2^19 N=65536',
              hashgrid_cuda, g_ref, x_ref, ref_grid)
    k2_narrow = _k2_narrow(checks, gpu, hashgrid_cuda, dev,
                           torch.Generator().manual_seed(args.seed + 25))
    k2_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward(
        g2, x2, TPU_GRID), 20)
    k2_plain = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward_plain(
        g2, x2, TPU_GRID), 3)
    # x and g read once, the 64 MiB table gradient written once; a mul and
    # an add per corner per element in fp32.
    k2_bound = _bound(_nbytes(x2, g2, table), 16 * n_tr * TPU_GRID.out_dim,
                      PEAK_FP32)
    # K2's atomics floor: as many float4 atomic rows as K2 would make with
    # no row combined (8 corners x points x levels, 512 bytes each), into
    # random rows of a buffer L2 holds (one level's gradient) and of one it
    # does not (all four levels').
    k2_updates = 8 * n_tr * TPU_GRID.n_levels
    k2_floor = {}
    for mib in (16, 64):
        buf = torch.zeros((mib * 2 ** 20 // 512, 128), device=dev)
        k2_floor[f'{mib} MiB'] = _cuda_ms(
            lambda: hashgrid_cuda.atomic_rows(buf, k2_updates), 10)
        del buf
    print(f'K2 atomics floor [{gpu}]: {k2_updates * 32} float4 atomics '
          f'({k2_updates * 512 / 1e9:.3f} GB) into random 512-byte rows: '
          f'{k2_floor["16 MiB"]:.4f} ms into 16 MiB, '
          f'{k2_floor["64 MiB"]:.4f} ms into 64 MiB; K2 {k2_ms:.4f} ms')
    results['K2'] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                         bound=k2_bound, library_ms=None,
                         atomics_floor_ms=k2_floor, narrow=k2_narrow)
    shapes['K2'] = hashgrid_cuda.encode_backward_launch_shapes(TPU_GRID, n_tr)
    shapes['K2 reference'] = hashgrid_cuda.encode_backward_launch_shapes(
        ref_grid, n_tr)
    _print_shapes(gpu, {f'{key} N={n_tr} {kernel}': sh
                        for key in ('K2', 'K2 reference')
                        for kernel, sh in shapes[key].items()})

    A3 = hashgrid_cuda.hashgrid_encode(table, x2, TPU_GRID)
    B3 = torch.zeros((n_tr, 32), device=dev)
    B3[:, :12] = torch.rand((n_tr, 12), generator=g).to(dev) * 2 - 1
    B3[:, 16:32] = torch.randn((n_tr, 16), generator=g).to(dev) * 0.3
    g1 = torch.randn((n_tr, packed[7].shape[1]), generator=g).to(dev)
    gf = torch.randn((n_tr, packed[10].shape[1]), generator=g).to(dev)
    gl = torch.randn((n_tr, packed[13].shape[1]), generator=g).to(dev)
    # (the seeded inputs gave 9.0e-5 and 5.0e-5 of dA's and dB's elements
    # beyond 2e-2 of the largest magnitude on the H100)
    k3b_err, k3b_witness = _check_k3b(checks, 'seeded', packed, A3, B3, g1,
                                      gf, gl)
    k3b_ms = _cuda_ms(lambda: heads_cuda.fused_heads_backward(
        packed, A3, B3, g1, gf, gl, need_dB=False), 10)
    k3b_plain = _cuda_ms(lambda: heads_cuda.fused_heads_backward_plain(
        packed, A3, B3, g1, gf, gl, torch.bfloat16), 3)
    shapes['K3b'] = heads_cuda.heads_launch_shapes(packed, A3, B3,
                                                   need_dB=False)
    _print_shapes(gpu, {f'K3b N={n_tr} {k}': v for k, v in
                        shapes['K3b'].items() if k != 'heads_fwd_kernel'})

    # K3b's peak memory above its inputs in the training step's call (the
    # workspace, the partials, dA and dW), and its kernels' device times by
    # name from torch.profiler: heads_bwd_kernel (recompute, backward chain
    # and the weight gradients' operands to the workspace), da_kernel,
    # dw_kernel for dWA and for the other 13, sum_partials_kernel; and K3f
    # at the same N, the recompute's own code alone.
    def k3b_train():
        return heads_cuda.fused_heads_backward(packed, A3, B3, g1, gf, gl,
                                               need_dB=False)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3b_train()
    torch.cuda.synchronize()
    k3b_mem = torch.cuda.max_memory_allocated() - base
    print(f'K3b memory [{gpu}] N={n_tr}: peak {k3b_mem / 1e6:.1f} MB above '
          f'its inputs ({k3b_mem / n_tr:.0f} B a point)')
    phase_ms = {'K3b': _kernel_ms(k3b_train),
                'K3f': _kernel_ms(lambda: heads_cuda.fused_heads(packed, A3,
                                                                 B3))}
    k3b_breakdown = None
    if all(v is not None for v in phase_ms.values()):
        def kernel(key, name):
            return sum(ms for k, ms in phase_ms[key].items() if name in k)

        k3b_breakdown = {
            'recompute (K3f alone)': kernel('K3f', 'heads_fwd_kernel'),
            'heads_bwd_kernel': kernel('K3b', 'heads_bwd_kernel'),
            'da_kernel': kernel('K3b', 'da_kernel'),
            'dw_kernel dWA': kernel('K3b', 'dw_kernel<true>'),
            'dw_kernel others': kernel('K3b', 'dw_kernel<false>'),
            'sum_partials_kernel': kernel('K3b', 'sum_partials'),
        }
        print(f'K3b phases [{gpu}] N={n_tr}, device ms per call: ' + ', '.join(
            f'{k} {v:.4f}' for k, v in k3b_breakdown.items()))
    else:
        print('K3b phases: the trace holds no device time: not measured')

    def heads_library_backward():
        # The yardstick: autograd's backward of the bf16 torch.matmul chain
        # (heads_library's products), graph built once.
        ws = [w.detach().clone().requires_grad_(True) for w in packed]
        (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
         W1o) = ws
        a = A3.to(torch.bfloat16).requires_grad_(True)
        b = B3.to(torch.bfloat16)
        h = torch.relu(a @ WA + b @ WBs)
        S = torch.relu(h @ W1s) @ W2s
        c = torch.relu(torch.relu(b @ WBc + S @ WSc) @ W1c) @ W2c
        F = torch.relu(torch.relu(S @ WSf) @ W1f) @ W2f
        L = torch.relu(torch.relu(F) @ WFo + S @ WSo) @ W1o
        outs = (torch.exp(torch.clamp(S[:, :1].float(), max=15.0)),
                torch.sigmoid(c[:, :3].float()), F, L)
        cots = (g1[:, :1], g1[:, 1:4], gf.to(torch.bfloat16),
                gl.to(torch.bfloat16))
        return lambda: torch.autograd.grad(outs, [a, *ws], cots,
                                           retain_graph=True)

    k3b_lib_fn = heads_library_backward()
    k3b_lib = _cuda_ms(k3b_lib_fn, 10)
    by_kernel = _kernel_ms(k3b_lib_fn)
    k3b_lib_device = None if by_kernel is None else sum(by_kernel.values())
    del k3b_lib_fn
    # Real widths: A, B's 28 columns and the cotangents of the 4 + S + C
    # real outputs read, dA and the fp32 weight gradients written; the
    # forward recomputed (all but the logits layer), the cotangents of
    # every layer but those of B, and every weight gradient.
    s_dim = params['semantic_features'][2].shape[1]
    c_dim = params['semantic_out'][1].shape[1]
    macs_fwd = head_macs - params['semantic_out'][1].numel()
    macs_data = head_macs - 12 * params['sigma_net'][0].shape[1] \
        - 16 * params['color_net'][0].shape[1]
    k3b_bound = _bound(
        2 * _nbytes(A3) + n_tr * (28 + 4 + s_dim + c_dim) * 4
        + head_macs * (2 + 4),
        2 * n_tr * (macs_fwd + macs_data + head_macs), PEAK_BF16)
    results['K3b'] = dict(max_abs_err=k3b_err, ms=k3b_ms,
                          plain_ms=k3b_plain, bound=k3b_bound,
                          library_ms=k3b_lib,
                          library_device_ms=k3b_lib_device)
    del A3, B3, g1, gf, gl, g2

    n4b = TRAIN_BATCH * PROPOSAL_STEPS  # proposal samples per step: 262,144
    X4 = (torch.rand((n4b, 36), generator=g) * 2 - 1).to(dev)
    g4 = torch.zeros((n4b, packed3[2].shape[1]), device=dev)
    g4[:, 0] = torch.randn(n4b, generator=g).to(dev)  # density's column
    dX, dws = heads_cuda.fused_mlp3_backward(packed3, X4, g4)
    wX, wws = heads_cuda.fused_mlp3_backward_plain(packed3, X4, g4,
                                                   torch.bfloat16)
    k4b_err = checks.close(f'K4b dX N={n4b}', dX, wX, rtol=0.0,
                           atol=2e-2 * float(wX.abs().max()))
    for name, a, b in zip(('W0', 'W1', 'W2'), dws, wws):
        checks.rel_norm(f'K4b d{name}', a, b, 1e-2)
    del dX, wX, wws
    # Per-block partials summed in a fixed order: a second launch on the
    # same inputs gives the same bits.
    _, again = heads_cuda.fused_mlp3_backward(packed3, X4, g4, need_dX=False)
    checks.true('K4b dW bit-equal across two launches',
                all(torch.equal(a, b) for a, b in zip(dws, again)))
    shapes['K4b'] = {'mlp3_bwd_kernel': heads_cuda.mlp3_launch_shapes(
        packed3, X4)['mlp3_bwd_kernel']}
    _print_shapes(gpu, {f'K4b N={n4b} mlp3_bwd_kernel':
                        shapes['K4b']['mlp3_bwd_kernel']})
    k4b_ms = _cuda_ms(lambda: heads_cuda.fused_mlp3_backward(
        packed3, X4, g4, need_dX=False), 20)
    k4b_plain = _cuda_ms(lambda: heads_cuda.fused_mlp3_backward_plain(
        packed3, X4, g4, torch.bfloat16), 5)

    def mlp3_library_backward():
        ws = [w.detach().clone().requires_grad_(True) for w in packed3]
        Xp = torch.nn.functional.pad(X4, (0, packed3[0].shape[0] - 36))
        out = torch.relu(torch.relu(Xp.to(torch.bfloat16) @ ws[0]) @ ws[1]) \
            @ ws[2]
        cot = g4.to(torch.bfloat16)
        return lambda: torch.autograd.grad(out, ws, cot, retain_graph=True)

    k4b_lib_fn = mlp3_library_backward()
    k4b_lib = _cuda_ms(k4b_lib_fn, 20)
    by_kernel = _kernel_ms(k4b_lib_fn)
    k4b_lib_device = None if by_kernel is None else sum(by_kernel.values())
    del k4b_lib_fn
    # X and the one real cotangent column read, the fp32 weight gradients
    # written; the forward recomputed without the output layer, the
    # hidden cotangents, and the three weight gradients (36-64-64-1).
    k4b_bound = _bound(
        _nbytes(X4) + n4b * 4 + mlp3_macs * (2 + 4),
        2 * n4b * ((mlp3_macs - 64) + (mlp3_macs - 36 * 64) + mlp3_macs),
        PEAK_BF16)
    results['K4b'] = dict(max_abs_err=k4b_err, ms=k4b_ms,
                          plain_ms=k4b_plain, bound=k4b_bound,
                          library_ms=k4b_lib,
                          library_device_ms=k4b_lib_device)
    del X4, g4, x2, table, enc, x, dws, again
    torch.cuda.empty_cache()

    # ---- 8. the training slice through SimpleTrainer
    trainer, loader, held_out = _train_slice(dev, args.seed)
    train_options = trainer.render_options
    workspace = trainer.workspace

    # (a) one step, kernels against plain versions: same params and draws.
    step_batch = next(loader)
    draws = draw_perturbations(trainer.generator, TRAIN_BATCH, train_options)
    parts_k, grads_k = trainer.loss_and_grads(step_batch, draws)
    with _plain_kernels(hashgrid_cuda, heads_cuda):
        parts_p, grads_p = trainer.loss_and_grads(step_batch, draws)
    # bf16 operands in the heads on both sides, rounded at other places
    # (the kernels round every cotangent to bf16, autograd of the plain
    # version keeps them fp32): loss parts within 2e-2, each gradient
    # within 5e-2 of its norm.
    for key in parts_k:
        checks.close(f'train step loss {key}', parts_k[key], parts_p[key],
                     atol=1e-6, rtol=2e-2)
    grad_errors = {name: checks.rel_norm(f'train step grad {name}',
                                         grads_k[name], grads_p[name], 5e-2)
                   for name in grads_k}
    del grads_k, grads_p

    # (b) the main path: TRAIN_STEPS steps through train_iterations.
    _, mse_before = trainer.eval_step(held_out)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    chunk_losses = [trainer.train_iterations(loader, TRAIN_CHUNK)
                    for _ in range(TRAIN_STEPS // TRAIN_CHUNK)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_kernels.launches)
    kernel_names = {'K1': hashgrid_cuda.NAME, 'K2': hashgrid_cuda.BWD_NAME,
                    'K3f': heads_cuda.HEADS, 'K3b': heads_cuda.HEADS_BWD,
                    'K4f': heads_cuda.MLP3, 'K4b': heads_cuda.MLP3_BWD}
    for name in kernel_names.values():
        checks.true(f'train launches {name}',
                    train_launches.get(name, 0) == TRAIN_STEPS,
                    f'{train_launches.get(name, 0)} (expected {TRAIN_STEPS})')
    loss_curve = [{k: float(v) for k, v in losses.items()}
                  for losses in chunk_losses]
    checks.true('train losses finite', all(
        np.isfinite(v) for losses in loss_curve for v in losses.values()))
    _, mse_after = trainer.eval_step(held_out)
    # A held-out view of the sphere after 200 steps: its rgb loss (MSE)
    # falls at least 4-fold from the untrained field's.
    checks.true('train held-out rgb loss falls', mse_after * 4 < mse_before,
                f'{mse_before:.5f} -> {mse_after:.5f} (PSNR '
                f'{_psnr(mse_before):.2f} -> {_psnr(mse_after):.2f} dB)')

    # K2 on the main path's own traffic: the (g, x) of one more step's
    # backward, after the 200 steps (main samples ray by ray, where the
    # trained proposal net concentrates them).
    g_s, x_s = _record_k2_inputs(trainer, loader)
    n_s = x_s.shape[0]
    _check_k2(checks, f'K2 table gradient step samples N={n_s}',
              hashgrid_cuda, g_s, x_s, TPU_GRID)
    k2_step_ms = _cuda_ms(lambda: hashgrid_cuda.hashgrid_encode_backward(
        g_s, x_s, TPU_GRID), 20)
    print(f'K2 [{gpu}] step samples N={n_s}: {k2_step_ms:.4f} ms (uniform '
          f'{results["K2"]["ms"]:.4f} ms)')
    results['K2']['ms_step_samples'] = k2_step_ms
    del g_s, x_s

    # (c) steady state, kernels against plain versions in turns.
    def step_ms():
        batches = [next(loader) for _ in range(STEPS_PER_TURN)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / STEPS_PER_TURN

    train_steady = {'kernels': [], 'plain': []}
    for _ in range(TRAIN_ROUNDS):
        for side in ('plain', 'kernels', 'kernels', 'plain'):
            if side == 'plain':
                with _plain_kernels(hashgrid_cuda, heads_cuda):
                    train_steady[side].append(step_ms())
            else:
                train_steady[side].append(step_ms())
    train_stats = {k: _quartiles(v) for k, v in train_steady.items()}

    # (d) one step's peak memory, then one step under the profiler.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(loader))
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    train_profile, train_busy = _device_profile(
        lambda: trainer.train_step(next(loader)))

    # (e) the trained checkpoint, served.
    trainer.save_checkpoint('best', include_optimizer=False)
    served_train = InferenceModel.from_checkpoint(
        Field(config, device=dev,
              generator=torch.Generator().manual_seed(args.seed + 3)),
        workspace, num_steps=NUM_STEPS, proposal_steps=PROPOSAL_STEPS,
        max_ray_batch=MAX_RAY_BATCH)
    served_out = served_train.render(held_out)
    own_image = trainer.test_step(held_out)[0].cpu().numpy()
    checks.true('trained checkpoint serves', served_out['image'].shape == (
        FRAME_H, FRAME_W, 3) and bool(np.isfinite(served_out['image']).all())
        and float(np.abs(served_out['image'] - own_image).max()) < 1e-5,
        f'max |served - trainer render| = '
        f'{float(np.abs(served_out["image"] - own_image).max()):.3e}')

    print(f'train [{gpu}]: {TRAIN_STEPS} steps in {train_s:.3f} s '
          f'({train_s * 1e3 / TRAIN_STEPS:.3f} ms per step incl. '
          f'{TRAIN_STEPS // TRAIN_CHUNK} EMA ticks); loss at chunk ends '
          f'{[round(c["total"], 5) for c in loss_curve]}')
    print(f'train step grads: worst relative error '
          f'{max(grad_errors.values()):.3e} '
          f'({max(grad_errors, key=grad_errors.get)})')
    for side, st in train_stats.items():
        print(f'train steady [{gpu}] {side}: ms per step median '
              f'{st["median"]:.3f} (q1 {st["q1"]:.3f}, q3 {st["q3"]:.3f}, '
              f'n {st["n"]}); rays/s '
              f'{TRAIN_BATCH / st["median"] * 1e3:.1f}')
    print(f'train step peak memory [{gpu}]: {train_peak / 1e9:.3f} GB '
          f'allocated at {TRAIN_BATCH} rays')
    if train_profile is None:
        print('train profile: the trace holds no device time: not measured')
    else:
        wall = train_stats['kernels']['median']
        print(f'train profile [{gpu}]: device busy {train_busy:.3f} ms of a '
              f'{wall:.3f} ms step (median wall, unprofiled): busy share '
              f'{train_busy / wall:.4f}')
        for name, ms, count in train_profile[:16]:
            print(f'  {ms:9.3f} ms {ms / train_busy:7.2%} x{count:<5d} '
                  f'{name[:90]}')
    for key in ('K2', 'K3b', 'K4b'):
        r = results[key]
        print(f'kernel {key} [{gpu}]: {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]} ms by '
              f'events, {r.get("library_device_ms")} ms device, bound '
              f'{r["bound"][0]:.4f} ms ({r["bound"][1]})')

    # ---- 9. the flagship step
    del trainer, loader
    torch.cuda.empty_cache()
    flagship = _flagship_phase(dev, args.seed, gpu, checks, results, shapes,
                               chunks)
    fl_launches, new_names = flagship['launches'], flagship['names']

    # ---- 10. the train CLI
    torch.cuda.empty_cache()
    cli_run = _cli_phase(dev, gpu, checks, results)
    cli_launches = cli_run['launches']

    # ---- 11. the stochastic-corner and residual encodes through the CLI
    torch.cuda.empty_cache()
    stochastic = _stochastic_phase(dev, gpu, checks, results, shapes,
                                   os.path.join(WORK_DIR, 'cli', 'sphere'))
    st_launches = stochastic['launches']
    exact_run = stochastic['exact']
    results['K2']['narrow']['cli E step'] = exact_run['k2']
    results['K2']['narrow']['max_abs_err'] = max(
        results['K2']['narrow']['max_abs_err'], exact_run['k2_max_abs_err'])

    # ---- 12. the render CLI: dense, proposal, trilinear and baked
    torch.cuda.empty_cache()
    render_cli = _render_cli_phase(dev, gpu, checks, results)
    rc_launches = {path: v['launches']
                   for path, v in render_cli['paths'].items()}

    # ---- 13. the interactive preview at 1280 x 720, 2^18 splats
    torch.cuda.empty_cache()
    preview = _preview_phase(dev, args.seed, gpu, checks, results)

    # ---- 14. evaluation: closed set, open vocabulary, reference checkpoint
    torch.cuda.empty_cache()
    evaluation = _eval_phase(dev, args.seed, gpu, checks, results)
    ev_launches = evaluation['launches']

    # ---- 15. the interactive backend, the user simulation, online mapping
    torch.cuda.empty_cache()
    interactive = _backend_phase(dev, args.seed, gpu, checks)

    # ---- 16. camera registration and joint pose refinement
    torch.cuda.empty_cache()
    pose = _pose_phase(dev, args.seed, gpu, checks, results, shapes)

    # ---- 17. the teacher towers
    torch.cuda.empty_cache()
    teachers = _teacher_phase(dev, args.seed, gpu, checks)

    # ---- 18. mapping: bundle adjustment (K9), IncrementalSfM's cv2-free
    # stages, the mapping CLI's scale and bounds
    torch.cuda.empty_cache()
    mapping = _mapping_phase(dev, args.seed, gpu, checks, results)

    # ---- 19. data and grid tensor parallelism: a world of one, two ranks
    # sharing the card (DP 2, TP 2), the train CLI on a mesh
    torch.cuda.empty_cache()
    mesh_run = _mesh_phase(dev, args.seed, gpu, checks)
    # K2x on each TP rank's feature slice, phase 19 (e)
    for r, form in enumerate(mesh_run['b']['e']['k2x']):
        results['K2x']['forms'][f'mesh pose rank {r} F={form["n_features"]}'] \
            = form
    results['K2x']['max_abs_err'] = max(
        f['max_abs_err'] for f in results['K2x']['forms'].values())

    # ---- 20. the online ROS node and the labelling window
    torch.cuda.empty_cache()
    host_modules = _host_modules_phase(dev, gpu, checks)

    table_rows = [
        ('K1 hashgrid_encode', 'autolabel_tpu_torch/csrc/hashgrid_encode.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:33', 'K1'),
        ('K2 hashgrid_encode_bwd', 'autolabel_tpu_torch/csrc/hashgrid_bwd.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:141', 'K2'),
        ('K3f fused_heads', 'autolabel_tpu_torch/csrc/heads_fwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:182', 'K3f'),
        ('K3b fused_heads_bwd', 'autolabel_tpu_torch/csrc/heads_bwd.cu',
         'autolabel_tpu/ops/heads_pallas.py:196', 'K3b'),
        ('K4f fused_mlp3', 'autolabel_tpu_torch/csrc/mlp3.cu',
         'autolabel_tpu/ops/heads_pallas.py:407', 'K4f'),
        ('K4b fused_mlp3_bwd', 'autolabel_tpu_torch/csrc/mlp3.cu',
         'autolabel_tpu/ops/heads_pallas.py:414', 'K4b'),
        ('K1s hashgrid_encode_atoms',
         'autolabel_tpu_torch/csrc/hashgrid_atoms.cu',
         'autolabel_tpu/ops/encoders.py:463', 'K1s'),
        ('K5 select_points', 'autolabel_tpu_torch/csrc/select_points.cu',
         'autolabel_tpu/ops/encoders.py:661', 'K5'),
        ('K2s hashgrid_sampled_bwd',
         'autolabel_tpu_torch/csrc/hashgrid_sampled_bwd.cu',
         'autolabel_tpu/ops/encoders.py:698', 'K2s'),
        ('K6 hashgrid_stochastic',
         'autolabel_tpu_torch/csrc/hashgrid_stochastic.cu',
         'autolabel_tpu/ops/encoders.py:776', 'K6'),
        ('K7 hashgrid_stochastic_bwd',
         'autolabel_tpu_torch/csrc/hashgrid_stochastic_bwd.cu',
         'autolabel_tpu/ops/encoders.py:761', 'K7'),
        ('K8 splat_render', 'autolabel_tpu_torch/csrc/splat_render.cu',
         'autolabel_tpu/render/baked.py:146', 'K8'),
        ('K2x hashgrid_point_grad',
         'autolabel_tpu_torch/csrc/hashgrid_point_grad.cu',
         'autolabel_tpu/ops/hashgrid_pallas.py:141', 'K2x'),
        ('K9 ba_normal_matvec', 'autolabel_tpu_torch/csrc/ba_normal.cu',
         'autolabel_tpu/mapping/ba.py:81', 'K9m'),
        ('K9 ba_residual_grad', 'autolabel_tpu_torch/csrc/ba_normal.cu',
         'autolabel_tpu/mapping/ba.py:63', 'K9g'),
        ('K9 ba_cg_solve', 'autolabel_tpu_torch/csrc/ba_normal.cu',
         'autolabel_tpu/mapping/ba.py:94', 'K9s'),
    ]
    kernel_names.update(new_names)
    kernel_names.update({k: stochastic['names'][k] for k in ('K6', 'K7')})
    kernel_names['K8'] = render_cli['names']['K8']
    kernel_names['K2x'] = pose['names']['K2x']
    kernel_names['K9g'], kernel_names['K9m'], kernel_names['K9s'] = \
        ba_cuda.NAMES
    # `launches`: the main path each kernel serves, phase 8's training
    # slice for the six kernels of slices 1-5, phase 9's flagship step
    # ('xla' heads) for K1s, K5 and K2s, phase 11's Run C for K6 and K7,
    # phase 13's fixed-budget preview frames for K8, phase 16's register
    # CLI for K2x, phase 18's bundle_adjust for K9 (the matvec row: the
    # products its solves ran, its entry being launched there no time).
    main_path = {key: (st_launches['C'] if key in ('K6', 'K7') else
                       preview['launches'] if key == 'K8' else
                       pose['register_launches'] if key == 'K2x' else
                       {kernel_names[key]: mapping['launches']['ba'][
                           'products_in_solves']} if key == 'K9m' else
                       mapping['launches']['ba'] if key in ('K9g', 'K9s')
                       else
                       fl_launches['xla'] if key in new_names
                       else train_launches) for *_, key in table_rows}
    kernels = [{
        'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': main_path[key].get(kernel_names[key], 0),
        'launches_train': train_launches.get(kernel_names[key], 0),
        'launches_render': launches.get(kernel_names[key], 0),
        'launches_flagship': fl_launches['xla'].get(kernel_names[key], 0),
        'launches_flagship_pallas': fl_launches['pallas'].get(
            kernel_names[key], 0),
        'launches_cli': cli_launches['A'].get(kernel_names[key], 0),
        'launches_cli_pallas': cli_launches['B'].get(kernel_names[key], 0),
        'launches_cli_stochastic': st_launches['C'].get(kernel_names[key], 0),
        'launches_cli_reference': st_launches['D'].get(kernel_names[key], 0),
        'launches_cli_exact': exact_run['launches'].get(kernel_names[key], 0),
        **{f'launches_render_cli_{path}': v.get(kernel_names[key], 0)
           for path, v in rc_launches.items()},
        'launches_preview_governed': preview['governed_launches'].get(
            kernel_names[key], 0),
        **{f'launches_eval_{leg}': v.get(kernel_names[key], 0)
           for leg, v in ev_launches.items()},
        **{f'launches_{leg}': v.get(kernel_names[key], 0)
           for leg, v in interactive['launches'].items()},
        'launches_register_step': pose['step_launches'].get(
            kernel_names[key], 0),
        'launches_register': pose['register_launches'].get(
            kernel_names[key], 0),
        'launches_joint': pose['joint_launches'].get(kernel_names[key], 0),
        'launches_teacher_language': teachers['language']['launches'].get(
            kernel_names[key], 0),
        'launches_mapping_ba': mapping['launches']['ba'].get(
            kernel_names[key], 0),
        'launches_mapping_sfm': mapping['launches']['sfm'].get(
            kernel_names[key], 0),
        'launches_mesh_world_of_one': mesh_run['a']['launches'].get(
            kernel_names[key], 0),
        **{f'launches_mesh_{mode}': mesh_run['b'][mode]['launches'][0].get(
            kernel_names[key], 0) for mode in ('dp', 'tp')},
        'launches_mesh_cli': sum(leg['launches'].get(kernel_names[key], 0)
                                 for leg in mesh_run['d']),
        'launches_mesh_pose_world_of_one': mesh_run['a']['pose'][
            'launches'].get(kernel_names[key], 0),
        'launches_mesh_pose': mesh_run['b']['e']['launches'][0].get(
            kernel_names[key], 0),
        'launches_mesh_pose_cli': mesh_run['e_cli']['launches'].get(
            kernel_names[key], 0),
        'launches_mesh_interactive': mesh_run['b']['f']['interactive'][0][
            'launches'].get(kernel_names[key], 0),
        'launches_online_node': host_modules['launches']['online_node'].get(
            kernel_names[key], 0),
        'max_abs_err': results[key]['max_abs_err'],
        'ms': results[key]['ms'], 'plain_ms': results[key]['plain_ms'],
        'bound_ms': results[key]['bound'][0],
        'bound_by': results[key]['bound'][1],
        'library_ms': results[key]['library_ms'],
        **{k: results[key][k] for k in ('ms_step_samples', 'atomics_floor_ms',
                                        'eval_ms', 'eval_device_ms',
                                        'eval_bound_ms', 'l2_floor_ms',
                                        'l2_floor_device_ms', 'device_ms',
                                        'device_split', 'library_device_ms',
                                        'cli', 'flips', 'reference',
                                        'unbiased_ratio', 'boundary',
                                        'ties', 'fill_device_ms',
                                        'scatter_device_ms', 'host_us',
                                        'state_bound_ms', 'render_cli',
                                        'tcnn', 'eval_3d', 'forms',
                                        'loop_ms', 'loop_device_ms', 'parts',
                                        'k', 'grid', 'bound_once_ms',
                                        'narrow')
           if k in results[key]},
    } for name, source, replaces, key in table_rows]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump({'gpu': gpu, 'torch': torch.__version__,
                   'cuda': torch.version.cuda, 'build_s': build_s,
                   'frame_s': frame_s, 'plain_frame_s': plain_s,
                   'steady_frame_ms': steady, 'steady_stats': steady_stats,
                   'profile_busy_ms': busy_ms,
                   'profile': profile_rows,
                   'render_errors': render_errors,
                   'train_s': train_s, 'train_launches': train_launches,
                   'train_loss_curve': loss_curve,
                   'train_heldout_mse': [mse_before, mse_after],
                   'train_grad_rel_errors': grad_errors,
                   'k3b_against_fp32': k3b_witness,
                   'launch_shapes': shapes, 'k3b_phases': k3b_breakdown,
                   'k1_gathered_bytes': k1_gathered,
                   'k1_ray_ordered_ms': k1_ray_ms,
                   'k1_narrow_ms': k1_narrow_ms,
                   'k1_narrow_plain_ms': k1_narrow_plain,
                   'k3b_phase_profiles': phase_ms, 'k3b_peak_bytes': k3b_mem,
                   'train_peak_bytes': train_peak,
                   'train_steady_step_ms': train_steady,
                   'train_steady_stats': train_stats,
                   'train_profile_busy_ms': train_busy,
                   'train_profile': train_profile,
                   'flagship': {k: v for k, v in flagship.items()
                                if k != 'names'},
                   'cli': {k: v for k, v in cli_run.items() if k != 'names'},
                   'stochastic': {k: v for k, v in stochastic.items()
                                  if k != 'names'},
                   'render_cli': {k: v for k, v in render_cli.items()
                                  if k != 'names'},
                   'preview': preview,
                   'evaluation': {k: v for k, v in evaluation.items()
                                  if k != 'names'},
                   'interactive': interactive,
                   'pose': {k: v for k, v in pose.items() if k != 'names'},
                   'teachers': teachers,
                   'mapping': mapping,
                   'mesh': mesh_run, 'host_modules': host_modules,
                   'optional_modules': optional,
                   'kernels': kernels, 'failures': checks.failures,
                   'build_log': _kernels.build_log}, f, indent=1)
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    if checks.failures:
        print(f'FAILED: {checks.failures}', file=sys.stderr)
        return 1
    print(gpu)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
