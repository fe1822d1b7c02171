"""Offline training of one scene: the train CLI.

    python -m autolabel_tpu_torch.train <scene> [flags]

Counterpart of scripts/train.py, with exactly its flags and workspace: a
SceneDataset('train') of the scene directory, the Field that
model_utils.create_model builds from the flags, and SimpleTrainer fed
through PrefetchIterator(LenDataset(...)) in epochs of up to 1,000
iterations; params.pkl, metrics.jsonl and the final checkpoint land in the
same model-hash directory (<scene>/nerf/<hash>, or
<workspace>/<scene name>/<hash>), so either package resumes or serves what
the other trained. --eval renders the test split and prints
"eval: mse=... psnr=...dB".

It runs on the card; tests call main([...], device='cpu'). With
--mesh-devices N (and --mesh-model M, which must divide N) it trains on a
device mesh as scripts/train.py does, N // M data ranks by M model ranks
(autolabel_tpu_torch/parallel): main spawns N ranks, one process each
(rank r on card r mod the cards, or the CPU), which meet through a file in
a temporary directory, build the same dataset with one seed and so the
same global batches, and train in lockstep; rank 0 alone writes
params.pkl, metrics.jsonl, the events, the checkpoint (the table whole)
and prints the eval line. Joint pose refinement on a mesh is not ported
and raises. The hidden --pose-refine-experimental trains the poses jointly
with the field
(train/pose_refine.py) and writes the refined poses (ngp frame: R, t and
the frames' stems) to <model dir>/poses_refined.npz, as the JAX CLI
does. --sampled-backward 0 trains through the
stochastic-corner encode (--stochastic-corners, --stochastic-exact-levels,
--stochastic-residual), as does the narrow reference grid
(--grid-preset reference), which turns the sampled backward off as the JAX
CLI does. --pose-refine errors as in the JAX CLI. --profile writes a
torch.profiler trace of the first epoch; --workers is accepted and
unused. The JAX CLI's AUTOLABEL_TIMING
stage timings are not carried over: main returns the training loop's
seconds.
"""
import argparse
import json
import os
import shutil
import time
import types

import numpy as np
import torch

from autolabel_tpu_torch import model_utils, parallel
from autolabel_tpu_torch.core.dataset import LenDataset, SceneDataset
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.ops import _kernels
from autolabel_tpu_torch.render.occupancy import (OccupancyGrid,
                                                  OccupancyGridConfig)
from autolabel_tpu_torch.render.renderer import RenderOptions
from autolabel_tpu_torch.train.loader import PrefetchIterator
from autolabel_tpu_torch.train.losses import LossOptions
from autolabel_tpu_torch.train.pose_refine import refined_poses
from autolabel_tpu_torch.train.trainer import SimpleTrainer


def read_args(argv=None):
    """scripts/train.py's flags, defaults and checks; argv defaults to
    sys.argv[1:]."""
    parser = model_utils.model_flag_parser()
    parser.add_argument('scene')
    parser.add_argument('--factor-train', type=float, default=2.0)
    parser.add_argument('--factor-test', type=float, default=2.0)
    parser.add_argument('--batch-size', '-b', type=int, default=4096)
    parser.add_argument('--iters', type=int, default=10000)
    parser.add_argument('--workers', '-w', type=int, default=1,
                        help="Accepted for the JAX CLI's sake; unused.")
    parser.add_argument('--eval', action='store_true')
    parser.add_argument(
        '--workspace',
        type=str,
        default=None,
        help="Save results in this directory instead of the scene directory.")
    parser.add_argument('--num-steps', type=int, default=128,
                        help="Volume-rendering samples per ray in training.")
    parser.add_argument('--upsample-steps', type=int, default=0,
                        help="Extra importance-sampled points per ray.")
    parser.add_argument('--mesh-devices', type=int, default=None,
                        help="Data-parallel over this many devices (one "
                        "process a device).")
    parser.add_argument('--mesh-model', type=int, default=1,
                        help="Shard the hash table's feature axis over this "
                        "many of the mesh's devices (grid tensor "
                        "parallelism).")
    parser.add_argument('--save-optimizer', action='store_true',
                        help="Persist Adam moments in the final checkpoint.")
    parser.add_argument('--occupancy-grid', action='store_true',
                        help="Maintain an occupancy grid masking density "
                        "in empty/unobserved cells during rendering.")
    parser.add_argument('--occupancy-near-far', action='store_true',
                        help="With --occupancy-grid, also shrink each "
                        "ray's [near, far] to the occupied span.")
    parser.add_argument('--stochastic-residual', action='store_true',
                        help="Rao-Blackwellized stochastic gathers (with "
                        "--stochastic-corners 2 and the TPU grid): the "
                        "max-weight corner at its weight, one draw for the "
                        "rest.")
    parser.add_argument('--stochastic-corners', type=int, default=2,
                        help="Hash-grid corners sampled per point in "
                        "training when --sampled-backward is 0 (an "
                        "unbiased estimate of the interpolation); 0 = "
                        "exact gathers.")
    parser.add_argument('--no-stochastic-corners', action='store_true',
                        help="Alias for --stochastic-corners 0.")
    parser.add_argument('--sampled-backward', default='2',
                        help="Exact-forward / sampled-backward hash gathers: "
                        "scatter rows per point and level (1, 2, or a "
                        "comma list coarsest level first); 0 disables.")
    parser.add_argument('--backward-points', type=float, default=0.25,
                        help="With --sampled-backward, the fraction of "
                        "points drawn to scatter, proportional to their "
                        "cotangent's norm; 1.0 disables.")
    parser.add_argument('--stochastic-exact-levels', type=int, default=0,
                        help="With stochastic corners, interpolate this "
                        "many of the finest grid levels exactly.")
    parser.add_argument('--sampled-warmup-fraction', type=float,
                        default=0.0,
                        help="With --sampled-backward 2, run this leading "
                        "fraction of the schedule with one row a level.")
    parser.add_argument('--exact-final-fraction', type=float, default=0.0,
                        help="Train the final fraction of the schedule "
                        "with exact gathers.")
    parser.add_argument('--no-metrics', action='store_true',
                        help="Skip the per-epoch metrics.jsonl scalars.")
    parser.add_argument('--tensorboard', action='store_true',
                        help="Also write TensorBoard event files to "
                        "<workspace>/run/ngp, scalars per epoch.")
    parser.add_argument('--profile', type=str, default=None,
                        help="Write a torch.profiler trace of the first "
                        "training epoch to this directory.")
    parser.add_argument('--pose-refine', action='store_true',
                        help="Removed, as in the JAX CLI: this flag errors.")
    parser.add_argument('--pose-refine-experimental', action='store_true',
                        help=argparse.SUPPRESS)
    flags = parser.parse_args(argv)
    if flags.pose_refine:
        parser.error(
            "--pose-refine was removed: joint refinement reliably makes "
            "poses worse (measured; NOTES.md). Localize frames with "
            "scripts/register.py (validated: 5 deg / 10 cm recovers to "
            "~0.9 deg / 1.6 cm against a trained field), or pass the "
            "hidden --pose-refine-experimental if you are studying the "
            "joint path itself.")
    flags.pose_refine = flags.pose_refine_experimental
    return flags


def main(argv=None, device=None, seed=None):
    """Train one scene as scripts/train.py does. device: None (the card;
    raises without one) or a torch device ('cpu' in the tests). seed: the
    dataset's batch draws (fresh ones when None; under a mesh every rank
    takes the one seed). Returns a namespace of the trainer, the dataset,
    the model directory, the seconds the training loop took (train_s) and,
    with --eval, eval_mse; under a mesh, rank 0's model directory,
    train_s, eval_mse and kernel launches, the trainer and dataset None
    (they lived in the ranks)."""
    flags = read_args(argv)
    device = resolve_device(device)
    if flags.mesh_devices:
        return _spawn_mesh(flags, device, seed)
    return _train(flags, device, seed=seed)


def _mesh(flags, device):
    """The device mesh, as scripts/train.py builds it."""
    if flags.mesh_model > 1:
        return parallel.make_mesh_2d(flags.mesh_devices // flags.mesh_model,
                                     flags.mesh_model, device=device)
    return parallel.make_mesh(flags.mesh_devices, device=device)


def _spawn_mesh(flags, device, seed):
    """Run the training on --mesh-devices ranks, one spawned process each;
    returns rank 0's result."""
    if flags.pose_refine:
        raise NotImplementedError('joint pose refinement on a device mesh '
                                  'is not ported')
    assert flags.mesh_devices % flags.mesh_model == 0
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % 2 ** 32)
    init_file = parallel.rendezvous_file()
    result = os.path.join(os.path.dirname(init_file), 'rank0.json')
    torch.multiprocessing.start_processes(
        _rank_main, nprocs=flags.mesh_devices, join=True,
        start_method='spawn',
        args=(flags, device.type, seed, init_file, result,
              model_utils.TPU_GRID))
    with open(result) as f:
        out = json.load(f)
    shutil.rmtree(os.path.dirname(init_file), ignore_errors=True)
    return types.SimpleNamespace(trainer=None, dataset=None, **out)


def _rank_main(rank, flags, device_type, seed, init_file, result, tpu_grid):
    """One rank of the mesh: join the world, train, and on rank 0 write the
    result for the parent. tpu_grid: the parent's model_utils.TPU_GRID, so
    the ranks build the parent's model."""
    model_utils.TPU_GRID = tpu_grid
    world = flags.mesh_devices
    if device_type == 'cpu':  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = parallel.init_world(rank, world, init_file, device_type)
    try:
        run = _train(flags, device, _mesh(flags, device_type), seed)
        if rank == 0:
            with open(result, 'w') as f:
                json.dump({'model_dir': run.model_dir, 'train_s': run.train_s,
                           'eval_mse': run.eval_mse,
                           'launches': dict(_kernels.launches)}, f)
    finally:
        torch.distributed.destroy_process_group()


def _train(flags, device, mesh=None, seed=None):
    """main's training on `device`, on `mesh` when given (then in every
    rank, which writes only as rank 0)."""
    writer = parallel.is_writer(mesh)

    loss_options = LossOptions(rgb_weight=flags.rgb_weight,
                               depth_weight=flags.depth_weight,
                               semantic_weight=flags.semantic_weight,
                               feature_weight=flags.feature_weight,
                               feature_loss=flags.features is not None)
    # Sampled-backward gathers exist for the wide-row (TPU_GRID) layout
    # only; the narrow reference-preset grid trains with exact gathers.
    sampled_backward = model_utils.parse_sampled_backward(
        flags.sampled_backward)
    if flags.grid_preset != 'tpu':  # create_model's grid is then None
        sampled_backward = 0
    render_options = RenderOptions(
        num_steps=flags.num_steps,
        upsample_steps=flags.upsample_steps,
        perturb=True,
        proposal_steps=flags.proposal_steps if flags.proposal else 0,
        stochastic_corners=(0 if flags.no_stochastic_corners else
                            flags.stochastic_corners),
        stochastic_exact_levels=flags.stochastic_exact_levels,
        stochastic_residual=flags.stochastic_residual,
        sampled_backward=sampled_backward,
        backward_points=flags.backward_points,
        occupancy_near_far=flags.occupancy_near_far)

    dataset = SceneDataset('train',
                           flags.scene,
                           factor=flags.factor_train,
                           batch_size=flags.batch_size,
                           features=flags.features)
    if seed is not None:
        # The batches' draws: the class-balanced sampler's and the rest.
        dataset.rng = np.random.default_rng(seed)
        dataset.index_sampler.random_state = np.random.RandomState(seed)
    n_classes = dataset.n_classes if dataset.n_classes is not None else 2
    field = model_utils.create_model(dataset.min_bounds, dataset.max_bounds,
                                     n_classes, flags, device=device)

    occupancy = None
    if flags.occupancy_grid:
        occupancy = OccupancyGrid(OccupancyGridConfig(), field.config.bound,
                                  device=device)
        occupancy.mark_untrained_grid(dataset.poses, dataset.intrinsics,
                                      dataset.camera.size)

    model_dir = model_utils.model_dir(flags.scene, flags)
    if writer:
        model_utils.write_params(model_dir, flags)
    pose_refine = None
    if flags.pose_refine:
        dataset.emit_frame_rays = True
        pose_refine = (dataset.rotations, dataset.origins)
    trainer = SimpleTrainer('ngp',
                            field,
                            lr=flags.lr,
                            iters=flags.iters,
                            loss_options=loss_options,
                            render_options=render_options,
                            workspace=model_dir,
                            ema_decay=0.95,
                            use_checkpoint='latest',
                            mesh=mesh,
                            occupancy=occupancy,
                            exact_final_fraction=flags.exact_final_fraction,
                            sampled_warmup_fraction=(
                                flags.sampled_warmup_fraction),
                            metrics=not flags.no_metrics,
                            tensorboard=flags.tensorboard,
                            pose_refine=pose_refine)

    iters_per_epoch = min(1000, flags.iters)
    epochs = int(np.ceil(flags.iters / iters_per_epoch))
    loader = PrefetchIterator(LenDataset(dataset, iters_per_epoch),
                              transform=trainer._device_batch)
    start = time.perf_counter()
    if flags.profile and writer:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            trainer.train(loader, 1, iters_per_epoch)
        os.makedirs(flags.profile, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(flags.profile, 'first_epoch.pt.trace.json'))
        if epochs > 1:
            trainer.train(loader, epochs - 1, iters_per_epoch)
    else:
        trainer.train(loader, epochs, iters_per_epoch)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - start
    trainer.save_checkpoint(include_optimizer=flags.save_optimizer)

    if pose_refine is not None:
        R, t = refined_poses(
            {k: v.detach().cpu().numpy() for k, v in trainer.pose.items()},
            (np.asarray(dataset.rotations), np.asarray(dataset.origins)))
        stems = [os.path.basename(p).split('.')[0]
                 for p in dataset.scene.rgb_paths()]
        path = os.path.join(model_dir, 'poses_refined.npz')
        np.savez(path, R=R, t=t,
                 frames=np.array([stems[i] for i in dataset.indices]))
        print(f"refined poses (ngp frame) -> {path}")

    eval_mse = None
    if flags.eval:
        testset = SceneDataset('test',
                               flags.scene,
                               factor=flags.factor_test,
                               batch_size=flags.batch_size * 2)
        losses = []
        for i in range(len(testset.poses)):
            _, loss = trainer.eval_step(testset._get_test(i))
            losses.append(loss)
        eval_mse = float(np.mean(losses))
        if writer:
            print(f"eval: mse={eval_mse:.5f} "
                  f"psnr={-10 * np.log10(eval_mse):.2f}dB")
    return types.SimpleNamespace(trainer=trainer, dataset=dataset,
                                 model_dir=model_dir, train_s=train_s,
                                 eval_mse=eval_mse)


if __name__ == '__main__':
    main()
