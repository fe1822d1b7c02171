"""The neural field as an nn.Module.

Counterpart of autolabel_tpu/models/field.py. The module's parameters keep
the JAX param tree's keys and (in, out) matrix layouts: 'sigma_net.0' is
params['sigma_net'][0], 'encoder.grid' is params['encoder']['grid'] (L, T,
F), 'proposal.i' the proposal MLP (bridge.py converts both ways). Methods
keep the JAX names; the params are the module's own. On a device mesh with
a 'model' axis (parallel.shard_field) 'encoder.grid' is this rank's
feature slice (L, T, F / m) and the encode gathers the slices.

Head layout:
  encoder:   'freq' | 'hg' | 'hg+freq' positional encoding
  sigma_net: enc_dim -> 128 x2 -> 1 + geo_feat_dim     (trunc_exp density)
  color_net: sh16 + geo -> 128 x2 -> 3                 (sigmoid rgb)
  semantic_features: geo -> S x2 -> S
  semantic_out: relu(feat) + geo -> 64 x1 -> n_classes
"""
import dataclasses

import torch
from torch import nn

from autolabel_tpu_torch import parallel
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.ops import hashgrid_cuda, heads_cuda
from autolabel_tpu_torch.ops.activation import trunc_exp
from autolabel_tpu_torch.ops.encoders import (HashGridConfig,
                                              frequency_encode, hashgrid_init,
                                              sh_encode)
from autolabel_tpu_torch.ops.mlp import mlp_apply, mlp_init

HEAD_KEYS = ('sigma_net', 'color_net', 'semantic_features', 'semantic_out')


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    encoding: str = 'hg+freq'
    num_layers: int = 2
    hidden_dim: int = 128
    geo_feat_dim: int = 15
    num_layers_color: int = 2
    hidden_dim_color: int = 128
    hidden_dim_semantic: int = 64
    semantic_classes: int = 2
    bound: float = 1.0
    # Optional override of the hash-grid hyperparameters; None = the
    # reference-parity defaults per encoding.
    grid: HashGridConfig = None
    # Hash-grid implementation, the JAX package's switch ('xla' or
    # 'pallas'), carried so configs carry over. It routes nothing here: the
    # encodes run the CUDA kernels on the card and the plain versions on
    # the CPU either way (ops/hashgrid_cuda.hashgrid_encode).
    grid_impl: str = 'xla'
    # Head-stack implementation: 'xla' (mlp_apply chains) or 'pallas' (the
    # fused CUDA head and proposal kernels, ops/heads_cuda.py). Same math.
    heads_impl: str = 'xla'
    grid_interp: str = 'trilinear'
    proposal: bool = False
    proposal_hidden_dim: int = 64
    # Relu the geometric features before the heads (imported reference
    # checkpoints).
    geo_relu: bool = False

    @property
    def grid_config(self):
        if self.grid is not None and self.encoding in ('hg', 'hg+freq'):
            return self.grid
        if self.encoding == 'hg':
            return HashGridConfig.from_desired_resolution(2 ** 18)
        if self.encoding == 'hg+freq':
            return HashGridConfig()
        return None

    @property
    def encoder_dim(self):
        if self.encoding == 'freq':
            return 3 * 10 * 2
        if self.encoding == 'hg':
            return self.grid_config.out_dim
        if self.encoding == 'hg+freq':
            return 3 * 2 * 2 + self.grid_config.out_dim
        raise NotImplementedError(f"Unknown input encoding {self.encoding}")


def _params(tensors, device):
    return nn.ParameterList([nn.Parameter(t.to(device)) for t in tensors])


class Field(nn.Module):
    """Config + parameters. Parameters are drawn on the CPU from
    `generator` (a fresh torch.Generator seeded 0 when None), with the JAX
    package's init distributions, then moved to `device`."""

    def __init__(self, config: FieldConfig, device=None, generator=None):
        super().__init__()
        self.config = c = config
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._packs = {}  # name -> (weights, stamp, packed): _kernel_pack
        # The device mesh the field trains on (parallel.shard_field), or
        # None.
        self.mesh = None
        self.sigma_net = _params(
            mlp_init(generator, c.encoder_dim, c.hidden_dim,
                     1 + c.geo_feat_dim, c.num_layers), device)
        self.color_net = _params(
            mlp_init(generator, 16 + c.geo_feat_dim, c.hidden_dim_color, 3,
                     c.num_layers_color), device)
        self.semantic_features = _params(
            mlp_init(generator, c.geo_feat_dim, c.hidden_dim_semantic,
                     c.hidden_dim_semantic, 2), device)
        self.semantic_out = _params(
            mlp_init(generator, c.hidden_dim_semantic + c.geo_feat_dim, 64,
                     c.semantic_classes, 1), device)
        self.encoder = nn.ParameterDict()
        if c.grid_config is not None:
            self.encoder['grid'] = nn.Parameter(
                hashgrid_init(generator, c.grid_config).to(device))
        if c.proposal:
            # freq(n=6) on normalized coords -> 3*6*2 = 36 input dims.
            self.proposal = _params(
                mlp_init(generator, 36, c.proposal_hidden_dim, 1, 2), device)

    @property
    def device(self):
        return self.sigma_net[0].device

    def head_params(self):
        """The head matrices as the JAX tree's lists."""
        return {k: list(getattr(self, k)) for k in HEAD_KEYS}

    def _kernel_pack(self, name, weights, pack):
        """pack(), the kernels' packing of `weights`.

        While autograd records (training), the packing is built anew on
        every call, in fp32 and inside the graph, so the gradients of the
        padded blocks flow back to the raw weights (as the JAX package's
        differentiable pack_head_weights) and the kernels return fp32
        weight gradients. Otherwise (serving, under no_grad or
        inference_mode) it is built once, without a graph, in bf16 on the
        card (the kernels' operand type) and fp32 on the CPU, and rebuilt
        only when a weight is replaced, moved or written in place
        (load_params, load_state_dict, .to, an optimizer step).
        """
        if torch.is_grad_enabled() and any(w.requires_grad for w in weights):
            return pack()
        stamp = [(w.data_ptr(), w._version) for w in weights]
        cached = self._packs.get(name)
        if (cached is None or cached[1] != stamp
                or any(a is not b for a, b in zip(cached[0], weights))):
            with torch.no_grad():
                packed = pack()
                if self.device.type == 'cuda':
                    packed = tuple(w.to(torch.bfloat16) for w in packed)
            cached = self._packs[name] = (list(weights), stamp, packed)
        return cached[2]

    # -- encodings ---------------------------------------------------------

    def _normalized(self, x):
        """(x + bound) / (2 bound) clipped to [0, 1] as jnp.clip clips:
        a point on a face of the box (the first sample of a ray) passes
        half of its gradient, where torch.clamp would pass all of it. The
        ends are 0-dim CPU tensors, which act as scalars on any device and
        need no copy to the card."""
        bound = self.config.bound
        v = (x + bound) / (2.0 * bound)
        return torch.minimum(torch.maximum(v, torch.tensor(0.0)),
                             torch.tensor(1.0))

    def _grid_encode(self, normalized, u=None, sampled_backward=0,
                     backward_points=1.0, n_samples=1, exact_levels=0,
                     residual=False, level_window=None):
        """The hash-grid encode of normalized points, as JAX
        Field._grid_encode routes a key: exact (fp32) without u; with the
        uniforms u and sampled_backward the exact-forward / sampled-backward
        encode (in the compute dtype); with u alone the stochastic-corner
        encode of n_samples draws or (residual) the residual encode, the
        finest exact_levels levels exact (fp32). The kernels on the card,
        the plain versions on the CPU. level_window: one factor a level
        (renderer.RenderOptions.level_window) scaling its feature block; a
        zero freezes that level's table. On a device mesh the rank's
        feature slice is encoded with the slice's config and the slices are
        gathered whole (parallel.gather_features)."""
        c = self.config
        grid = parallel.grid_config_shard(c.grid_config, self.mesh)
        out = hashgrid_cuda.hashgrid_encode(
            self.encoder['grid'], normalized, grid,
            interp=c.grid_interp, u=u, sampled_backward=sampled_backward,
            backward_points=backward_points, n_samples=n_samples,
            exact_levels=exact_levels, residual=residual, mesh=self.mesh)
        out = parallel.gather_features(out, self.mesh, grid.n_levels)
        if level_window is not None:
            w = torch.as_tensor(level_window, dtype=out.dtype,
                                device=out.device)
            out = out * w.repeat_interleave(c.grid_config.n_features)
        return out

    def encode(self, x, **estimator):
        """Positional encoding of (N, 3) points in [-bound, bound]; exact
        unless `estimator` (u, sampled_backward, backward_points, n_samples,
        exact_levels, residual: see _grid_encode) asks for an estimator;
        level_window scales the grid's levels."""
        return torch.cat([s.float() for s in self._encode_segments(
            x, **estimator)], dim=-1)

    def _encode_segments(self, x, **estimator):
        """The encoding as a list of segments (same values and column order
        as encode(); mlp_apply consumes them as split products)."""
        c = self.config
        if c.encoding == 'freq':
            return [frequency_encode(self._normalized(x), 10)]
        if c.encoding == 'hg':
            return [self._grid_encode(self._normalized(x), **estimator)]
        if c.encoding == 'hg+freq':
            # Frequency part on the raw coordinates, grid on the
            # normalized ones.
            return [frequency_encode(x, 2),
                    self._grid_encode(self._normalized(x), **estimator)]
        raise NotImplementedError(f"Unknown input encoding {c.encoding}")

    # -- heads --------------------------------------------------------------

    def density(self, x, **estimator):
        """(N, 3) points -> (sigma (N,), geo_feat (N, G)); `estimator` as
        for encode."""
        h = mlp_apply(list(self.sigma_net),
                      self._encode_segments(x, **estimator))
        return trunc_exp(h[..., 0]), h[..., 1:]

    def fused_heads_available(self):
        """True when the fused head kernel covers this config."""
        c = self.config
        if c.heads_impl != 'pallas' or c.encoding not in ('hg', 'hg+freq'):
            return False
        if c.geo_relu:
            return False
        return heads_cuda.supported(self.head_params(),
                                    12 if c.encoding == 'hg+freq' else 0)

    def all_heads(self, x, d, **estimator):
        """Every head in one fused kernel: (N, 3) points + (N, 3) view dirs
        -> (sigma (N,), rgb (N, 3), logits (N, C), features (N, S));
        `estimator` as for encode. The fused head kernel takes fp32 A: the
        sampled encode's bf16 values are cast, exactly."""
        c = self.config
        A = self._grid_encode(self._normalized(x), **estimator).float()
        freq_dim = 12 if c.encoding == 'hg+freq' else 0
        B = torch.zeros((x.shape[0], 32), dtype=torch.float32,
                        device=x.device)
        if freq_dim:
            B[:, :freq_dim] = frequency_encode(x, 2)
        B[:, 16:32] = sh_encode(d)
        weights = [w for k in HEAD_KEYS for w in getattr(self, k)]
        packed = self._kernel_pack(
            'heads', weights, lambda: heads_cuda.pack_head_weights(
                self.head_params(), freq_dim))
        out1, feats, logits = heads_cuda.fused_heads(packed, A, B)
        n_classes = self.semantic_out[1].shape[1]
        feat_dim = self.semantic_features[2].shape[1]
        return (out1[:, 0], out1[:, 1:4], logits[:, :n_classes],
                feats[:, :feat_dim])

    def color(self, d, geo_feat):
        """Unit view dirs (N, 3) + geo features -> rgb (N, 3) in [0, 1]."""
        geo_feat = geo_feat.float()
        if self.config.geo_relu:
            geo_feat = torch.relu(geo_feat)
        return torch.sigmoid(mlp_apply(list(self.color_net),
                                       [sh_encode(d), geo_feat]))

    def proposal_sigma(self, x):
        """Cheap proposal density: (N, 3) -> (N,)."""
        c = self.config
        freq = frequency_encode(self._normalized(x), 6)
        weights = list(self.proposal)
        if c.heads_impl == 'pallas' and len(weights) == 3:
            packed = self._kernel_pack(
                'proposal', weights, lambda: heads_cuda.pack_mlp3(weights))
            h = heads_cuda.fused_mlp3(packed, freq)
            return trunc_exp(h[:, 0])
        h = mlp_apply(weights, freq)
        return trunc_exp(h[..., 0])

    def param_labels(self):
        """Optimizer group of every parameter, by state_dict name: the
        hash table is 'encoding' (no weight decay), the MLPs are 'net'
        (JAX Field.param_labels; the 'pose' group is not Field state)."""
        return {name: 'encoding' if name.startswith('encoder.') else 'net'
                for name, _ in self.named_parameters()}

    def semantic(self, geo_feat):
        """Geo features -> (class logits (N, C), features (N, S))."""
        geo_feat = geo_feat.float()
        if self.config.geo_relu:
            geo_feat = torch.relu(geo_feat)
        sem_features = mlp_apply(list(self.semantic_features), geo_feat)
        logits = mlp_apply(list(self.semantic_out),
                           [torch.relu(sem_features), geo_feat])
        return logits, sem_features
