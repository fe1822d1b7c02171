"""Device meshes for data parallelism and grid tensor parallelism, on
torch.distributed.

Counterpart of autolabel_tpu/parallel/__init__.py. JAX builds one SPMD
program over a mesh of devices in one process, and XLA inserts the
collectives that its sharding annotations imply. Here every device of the
mesh is a rank, a process of its own (the train CLI spawns them), and those
collectives are written out:

- data parallelism (DP): the ray batch shards over the mesh's 'data' axis,
  every rank holds the parameters it trains whole, and the gradients are
  summed over 'data' (reduce_gradients);
- grid tensor parallelism (TP): the hash table (L, T, F) shards on its
  feature axis over 'model', its Adam moments and EMA copy alike
  (shard_field, tree_shardings); every rank of a model group encodes its
  feature slice of the same hashed rows, and gather_features all-gathers
  the slices into JAX's level-major (N, L F) layout for the replicated
  heads. The table's gradient shards sum over 'data' alone, among the
  ranks of one model index.

A mesh step computes JAX's one-device function on the global batch: the
loss means divide by the global counts (train/losses.py), the sampled
backward's point subsample draws over the global batch
(select_norms_global and its callers), and a non-finite gradient on any
rank skips the update on every rank (all_finite).

The backend follows a rule, never a try-and-fall-back: 'nccl' when every
rank has a CUDA device of its own, 'gloo' on the CPU and when ranks share a
card (NCCL refuses two ranks on one device). Gloo's collectives run on host
tensors here: a CUDA tensor is copied to the host and back, explicitly
(all_reduce_sum, all_gather), since gloo's all_gather takes no CUDA
tensors (and no bfloat16: a gather there moves bytes). Ranks meet
through a file in a temporary directory (init_world), never a fixed TCP
port.
"""
import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DATA, MODEL = 'data', 'model'
# How long a rank waits for the others at a rendezvous or a collective.
TIMEOUT = datetime.timedelta(minutes=10)


# -- the world and its meshes ----------------------------------------------

def backend_for(device_type, world_size, device_count=0):
    """The backend of a world of world_size ranks on `device_type` with
    device_count cards: 'nccl' when every rank has a card of its own,
    else (the CPU, or ranks sharing a card) 'gloo'."""
    if device_type == 'cuda' and world_size <= device_count:
        return 'nccl'
    return 'gloo'


def rank_device(device, rank):
    """The device of `rank`: the CPU, or card rank mod the cards."""
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    return torch.device('cuda', rank % torch.cuda.device_count())


def init_world(rank, world_size, init_file, device):
    """Join the world of world_size ranks as `rank` through the rendezvous
    file init_file, on `device` ('cpu', or 'cuda': rank r takes card r mod
    the cards). Returns the rank's torch.device."""
    device = rank_device(device, rank)
    count = 0
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        count = torch.cuda.device_count()
    dist.init_process_group(backend_for(device.type, world_size, count),
                            init_method=f'file://{init_file}', rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return device


def rendezvous_file():
    """A fresh rendezvous file's path, in a new temporary directory."""
    return os.path.join(tempfile.mkdtemp(prefix='autolabel_mesh_'),
                        'rendezvous')


def _device_type(device):
    """The mesh's device type: the card unless the caller asks for the
    CPU (the port's rule for every entry point)."""
    from autolabel_tpu_torch.device import resolve_device
    return resolve_device(device).type


def _world(device_type):
    """The world's size, joining a world of one (this process alone) when
    no launcher has made one."""
    if not dist.is_initialized():
        init_world(0, 1, rendezvous_file(), device_type)
    return dist.get_world_size()


def make_mesh(n_devices=None, device=None):
    """1-D data-parallel mesh ('data',) over the world's ranks (every rank
    calls it; without a world, this process alone). n_devices, when given,
    must be the world's size."""
    device_type = _device_type(device)
    world = _world(device_type)
    if n_devices is not None and n_devices != world:
        raise ValueError(f'the mesh spans every rank: {n_devices} devices '
                         f'asked of a world of {world}')
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA,))


def make_mesh_2d(n_data, n_model, device=None):
    """('data', 'model') mesh for DP x grid-TP training, 'data' outermost:
    rank r has data index r // n_model and model index r % n_model."""
    device_type = _device_type(device)
    world = _world(device_type)
    if n_data * n_model != world:
        raise ValueError(f'a {n_data} x {n_model} mesh needs a world of '
                         f'{n_data * n_model} ranks, not {world}')
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA, MODEL))


def axis_size(mesh, axis):
    """The ranks along `axis` (1 without a mesh or the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis):
    """This rank's index along `axis` (0 without a mesh or the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def is_writer(mesh):
    """Whether this rank writes the run's files: rank 0, or every process
    without a mesh."""
    return mesh is None or dist.get_rank() == 0


# -- shardings ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """Block `index` of `parts` equal blocks along axis `dim` (one part:
    the whole, replicated)."""
    dim: int
    index: int
    parts: int

    def bounds(self, n):
        """The block's [lo, hi) of an axis of length n, which the parts
        must divide (as JAX's sharding requires)."""
        if n % self.parts:
            raise ValueError(f'an axis of {n} does not shard into '
                             f'{self.parts} equal parts')
        size = n // self.parts
        return self.index * size, (self.index + 1) * size

    def take(self, a):
        """The block of a tensor or numpy array."""
        lo, hi = self.bounds(a.shape[self.dim])
        index = [slice(None)] * a.ndim
        index[self.dim] = slice(lo, hi)
        return a[tuple(index)]


def batch_sharding(mesh):
    """This rank's rows of a global batch: its block over 'data'."""
    return Sharding(0, axis_index(mesh, DATA), axis_size(mesh, DATA))


def replicated(mesh):
    del mesh
    return Sharding(0, 0, 1)


def grid_sharding(mesh):
    """The hash table (L, T, F) on its feature axis over 'model': this
    rank's slice [j F / m, (j + 1) F / m)."""
    return Sharding(-1, axis_index(mesh, MODEL), axis_size(mesh, MODEL))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_shardings(mesh, tree, grid_shape=None):
    """The sharding of every leaf of a params or optimizer-state tree:
    leaves of exactly the hash table's (L, T, F) shape shard on the feature
    axis over 'model' (when the mesh has it), everything else replicates.
    Adam moments mirror the param shapes, so this covers them too."""
    shard_grid = grid_shape is not None and axis_size(mesh, MODEL) > 1
    grid, rep = grid_sharding(mesh), replicated(mesh)
    return _map_tree(
        lambda leaf: grid if (shard_grid and hasattr(leaf, 'shape')
                              and tuple(leaf.shape) == tuple(grid_shape))
        else rep, tree)


def shard_tree(tree, mesh, grid_shape=None):
    """This rank's part of a tree of whole arrays (a checkpoint's): every
    leaf of the table's shape cut to the rank's feature slice."""
    shardings = tree_shardings(mesh, tree, grid_shape)
    flat = []
    _map_tree(flat.append, shardings)
    it = iter(flat)

    def take(leaf):
        sharding = next(it)
        return leaf if sharding.parts == 1 else sharding.take(leaf)

    return _map_tree(take, tree)


def grid_config_shard(config, mesh):
    """The hash-grid config of this rank's slice: n_features F / m. The
    hashed rows do not depend on F, so the slice's encode is the whole
    encode's feature slice."""
    m = axis_size(mesh, MODEL)
    if config is None or m == 1:
        return config
    if config.n_features % m:
        raise ValueError(f'{config.n_features} features do not shard over '
                         f'{m} model ranks')
    return dataclasses.replace(config, n_features=config.n_features // m)


def shard_field(field, mesh):
    """Put `field` on `mesh` in place: with a 'model' axis its hash table
    becomes this rank's feature slice, and field.mesh = mesh (its encode
    then gathers the slices, and the sampled backward subsamples over the
    global batch)."""
    grid = field.config.grid_config
    if grid is not None and axis_size(mesh, MODEL) > 1:
        with torch.no_grad():
            whole = field.encoder['grid']
            field.encoder['grid'] = torch.nn.Parameter(
                grid_sharding(mesh).take(whole.detach()).contiguous(),
                requires_grad=whole.requires_grad)
    field.mesh = mesh
    return field


def sharded_grid(field):
    """Whether the field's table is a feature slice of a 'model' axis."""
    return (field.config.grid_config is not None
            and axis_size(getattr(field, 'mesh', None), MODEL) > 1)


# -- collectives ----------------------------------------------------------

def all_reduce_sum(tensor, mesh, axis=None):
    """Sum `tensor` in place over `axis` of the mesh (every rank when axis
    is None); returns it. Under gloo a CUDA tensor is summed on the host
    and copied back."""
    group = dist.group.WORLD if axis is None else mesh.get_group(axis)
    if tensor.is_cuda and dist.get_backend(group) == 'gloo':
        host = tensor.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather(tensor, mesh, axis):
    """Every rank's `tensor` along `axis`, in the axis's order (a list).
    Under gloo the tensor travels as its bytes on the host: gloo gathers
    no CUDA tensor and not every type (bfloat16, int16), and a gather
    computes nothing."""
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    src = tensor.contiguous()
    gloo = dist.get_backend(group) == 'gloo'
    if gloo:
        src = src.reshape(-1).view(torch.uint8).cpu()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    if gloo:
        out = [o.to(tensor.device).view(tensor.dtype).reshape(tensor.shape)
               for o in out]
    return out


class _GatherFeatures(torch.autograd.Function):
    """The encode's feature slices all-gathered over 'model' into JAX's
    level-major layout; the backward takes this rank's slice of the
    cotangent, unreduced: every rank of a model group computes the same
    whole cotangent (replicated heads, the same rows), so a sum over the
    group, as torch.distributed.nn.functional.all_gather's backward takes,
    would scale the table's gradient by m."""

    @staticmethod
    def forward(ctx, enc, mesh, levels):
        parts = axis_size(mesh, MODEL)
        ctx.args = (axis_index(mesh, MODEL), parts, levels)
        n = enc.shape[0]
        slices = torch.stack(all_gather(enc, mesh, MODEL), dim=1)
        return slices.view(n, parts, levels, -1).transpose(1, 2).reshape(
            n, -1)

    @staticmethod
    def backward(ctx, g):
        index, parts, levels = ctx.args
        n = g.shape[0]
        mine = g.reshape(n, levels, parts, -1)[:, :, index]
        return mine.reshape(n, -1).contiguous(), None, None


def gather_features(enc, mesh, levels):
    """(N, L F / m) encode slices of the model group -> (N, L F), level l's
    features j F / m + i from rank j's column l F / m + i (JAX's
    g[:, l f:(l + 1) f], autolabel_tpu/ops/encoders.py). Identity on a mesh
    without a 'model' axis of more than one rank."""
    if axis_size(mesh, MODEL) == 1:
        return enc
    return _GatherFeatures.apply(enc, mesh, levels)


def sum_over_model(values, mesh):
    """The sum over the model group of every rank's `values`, added in rank
    order (every rank gets the same bits)."""
    if axis_size(mesh, MODEL) == 1:
        return values
    parts = all_gather(values, mesh, MODEL)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def gather_rows(values, mesh):
    """The data group's `values` concatenated in data order: the global
    batch's rows from each rank's block."""
    if mesh is None or DATA not in mesh.mesh_dim_names:
        return values
    return torch.cat(all_gather(values, mesh, DATA))


def gather_grid(tensor, mesh):
    """A table-shaped slice gathered whole over 'model' (its feature
    axis)."""
    if axis_size(mesh, MODEL) == 1:
        return tensor
    return torch.cat(all_gather(tensor, mesh, MODEL), dim=-1)


def barrier():
    """Wait for every rank of the world."""
    dist.barrier()


def reduce_gradients(grads, mesh):
    """Sum the gradients (name -> tensor or None) over 'data' in place, in
    one collective over a flat buffer: the replicated parameters' and the
    table slices' (among the ranks of one model index) alike."""
    live = [g for g in grads.values() if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in live])
    all_reduce_sum(flat, mesh, DATA)
    offset = 0
    for g in live:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return grads


def all_finite(finite, mesh):
    """A 0-dim bool that is true on every rank when it is on all of them:
    a non-finite gradient in one rank's table slice skips the update on
    every rank, so their parameters never part."""
    bad = (~finite).to(torch.int32).reshape(1)
    all_reduce_sum(bad, mesh)
    return bad[0] == 0


def local_draws(draws, mesh, n_rays, options):
    """The render's uniforms (renderer.draw_perturbations, drawn for the
    global batch of n_rays rays under render options `options`) cut to
    this rank's rays: rows of u_coarse and u_fine, and the columns of the
    encode's uniforms that its points own (a ray's samples are consecutive
    points). The sampled backward's systematic offset, the last column of
    a (L, N + 1) u, stays shared."""
    lo, hi = batch_sharding(mesh).bounds(n_rays)
    steps = {'u_enc': options.num_steps,
             'u_enc_upsample': options.upsample_steps}
    out = {}
    for name, u in draws.items():
        if name not in steps:
            out[name] = u[lo:hi]
            continue
        s = steps[name]
        mine = u[..., lo * s:hi * s]
        if u.shape[-1] == n_rays * s + 1:  # (L, N + 1): then u_sys
            mine = torch.cat([mine, u[..., -1:]], dim=-1)
        out[name] = mine.contiguous()
    return out
