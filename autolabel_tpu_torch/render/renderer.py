"""Volumetric rendering with dense, static-shape sampling.

Counterpart of autolabel_tpu/render/renderer.py: every ray carries a fixed
sample grid, placed uniformly or by the proposal net, and compositing is
closed-form exp/cumsum. Ported: the eval form (no perturbation) and the
training form (perturbed sample positions, the proposal net's interlevel
loss, the JAX package's stop-gradients), with the proposal, fused-head,
non-fused and upsample branches, with the exact encode, the
exact-forward / sampled-backward one (options.sampled_backward, which
takes precedence over stochastic_corners, as in the JAX package) or the
stochastic-corner and residual ones (options.stochastic_corners,
stochastic_exact_levels, stochastic_residual). JAX draws its perturbations
from a PRNG key; here they come in as tensors (`draws`) or from a
torch.Generator (`key`), so tests can feed JAX's own draws. With an
occupancy grid, samples in empty or untrained cells get sigma 0 and, with
options.occupancy_near_far, each ray's [near, far] shrinks to the
occupied span. Level windows are not ported and raise.

Output contract: image, depth, semantic, semantic_features,
depth_variance, coordinates_map, weights_sum, and interlevel (a scalar)
with a proposal net while autograd records.
"""
import dataclasses

import numpy as np
import torch

from autolabel_tpu_torch.ops.encoders import uniform_shape
from autolabel_tpu_torch.render.occupancy import occupied

MIN_NEAR = 0.05


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """The JAX package's RenderOptions, defaults mirrored exactly. Level
    windows, which are not ported, are carried so configs transfer; a
    render that would use them raises."""
    num_steps: int = 128
    upsample_steps: int = 0
    perturb: bool = False
    bg_color: float = 1.0
    proposal_steps: int = 0
    stochastic_corners: int = 2
    stochastic_exact_levels: int = 0
    stochastic_residual: bool = False
    sampled_backward: int = 0
    backward_points: float = 1.0
    occupancy_near_far: bool = False
    occupancy_probes: int = 32
    level_window: tuple = None


def ray_aabb_intersect(rays_o, rays_d, bound, min_near=MIN_NEAR):
    """Entry/exit distances of rays against the [-bound, bound]^3 cube,
    each (N, 1)."""
    safe_d = torch.where(rays_d.abs() < 1e-9,
                         torch.full_like(rays_d, 1e-9), rays_d)
    inv_d = 1.0 / safe_d
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp(near, min=min_near)
    far = torch.maximum(far, near + 1e-4)
    return near[..., None], far[..., None]


def shrink_near_far(occupancy, rays_o, rays_d, near, far, bound,
                    n_probe=32):
    """Tighten per-ray [near, far] to the span of occupied+trained cells.

    occupancy: (density_grid, trained_mask, threshold); near/far: (N, 1).
    Probes the grid at n_probe equally spaced points per ray and brackets
    the first/last occupied probe with a one-step margin. Rays with no
    occupied probe keep the full interval. The probe fractions are JAX
    linspace's i / (n_probe - 1), bit for bit.
    """
    frac = torch.arange(n_probe, dtype=torch.float32,
                        device=near.device) / (n_probe - 1)
    t = near + (far - near) * frac[None, :]  # (N, P)
    xyz = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
    occ = occupied(occupancy, xyz, bound)  # (N, P)
    any_occ = occ.any(dim=-1, keepdim=True)
    # argmax of a bool row: its first True (0 when there is none)
    first = torch.argmax(occ.to(torch.uint8), dim=-1)
    last = n_probe - 1 - torch.argmax(occ.flip(-1).to(torch.uint8), dim=-1)
    step = 1.0 / (n_probe - 1)
    lo = torch.clamp((first - 1) * step, 0.0, 1.0)[:, None]
    hi = torch.clamp((last + 1) * step, 0.0, 1.0)[:, None]
    new_near = torch.where(any_occ, near + (far - near) * lo, near)
    new_far = torch.where(any_occ, near + (far - near) * hi, far)
    return new_near, torch.maximum(new_far, new_near + 1e-4)


def _mask_sigma(occupancy, flat, sigma, bound):
    """sigma of (M, 3) points zeroed where their cell is empty or
    untrained; unchanged without an occupancy grid."""
    if occupancy is None:
        return sigma
    return sigma * occupied(occupancy, flat, bound).to(sigma.dtype)


def sample_pdf(z_mid, weights, n_samples, u=None):
    """Nearest-atom inverse-CDF sampling over coarse weights.

    z_mid: (N, S-1) bin centers; weights: (N, S-1). u: (N, n_samples)
    uniforms, or None for the deterministic eval grid
    linspace(0, 1, n + 2)[1:-1]. Returns (N, n_samples) depths: the z of
    the atom whose cumulative-mass interval holds u, as a masked max.
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples + 2,
                           device=z_mid.device)[1:-1]
        u = u.expand(*cdf.shape[:-1], n_samples)
    selectable = cdf[..., None, :-1] <= u[..., :, None]  # (N, n, S-1)
    neg_inf = torch.tensor(-torch.inf, device=z_mid.device)
    return torch.where(selectable, z_mid[..., None, :], neg_inf).amax(dim=-1)


def _composite_weights(sigma, deltas):
    """w_i = (1 - exp(-sigma_i d_i)) * exp(-sum_{j<i} sigma_j d_j)."""
    tau = sigma * deltas
    accum = torch.cumsum(tau, dim=-1) - tau  # exclusive prefix sum
    transmittance = torch.exp(-accum)
    alpha = 1.0 - torch.exp(-tau)
    return alpha * transmittance


def _deltas(z, last):
    """Sample spacings with the last one set to `last` (N, 1)."""
    return torch.cat([torch.diff(z, dim=-1), last.expand(z.shape[0], 1)],
                     dim=-1)


def _points(rays_o, rays_d, z, bound):
    xyz = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    return torch.clamp(xyz, -bound, bound)


def _interlevel_loss(z_main, d_main, w_main, z_prop, d_prop, w_prop):
    """mip-NeRF-360 proposal supervision: each main interval's weight must
    be covered by the proposal weights overlapping it (dense (S_m, S_p)
    overlap matrix per ray). z_*: sample starts (N, S); d_*: interval
    lengths; w_*: weights."""
    m0 = z_main[..., :, None]
    m1 = (z_main + d_main)[..., :, None]
    p0 = z_prop[..., None, :]
    p1 = (z_prop + d_prop)[..., None, :]
    overlap = (torch.minimum(m1, p1) - torch.maximum(m0, p0)) > 0
    bound = (overlap * w_prop[..., None, :]).sum(dim=-1)  # (N, S_m)
    excess = torch.relu(w_main - bound)
    return (excess ** 2 / (bound + 1e-4)).mean()


def _encode_uniform_shape(options, n_points, grid_levels, interp):
    """The shape of the encode's uniforms for n_points points of a grid of
    grid_levels levels (encoders.uniform_shape), or None when the render
    encodes exactly."""
    if not grid_levels or not (options.sampled_backward
                               or options.stochastic_corners):
        return None
    return uniform_shape(grid_levels, n_points, interp,
                         max(1, int(options.stochastic_corners)),
                         options.stochastic_residual,
                         options.sampled_backward, options.backward_points)


def draw_perturbations(generator, n_rays, options, grid_levels=0,
                       interp='trilinear'):
    """The uniforms a perturbed render consumes, drawn from `generator` on
    its device: 'u_coarse' jitters the first sample grid (the proposal
    samples, or the uniform samples when there is no proposal net),
    'u_fine' places the importance samples (proposal or upsample), and,
    with options.sampled_backward or options.stochastic_corners and a hash
    grid of grid_levels levels interpolated by `interp`, 'u_enc' (and
    'u_enc_upsample' for the upsample query) are the encode's uniforms in
    the shape encoders.uniform_shape gives, as the JAX package draws them
    from its k_enc key."""
    first = options.proposal_steps or options.num_steps
    fine = options.num_steps if options.proposal_steps \
        else options.upsample_steps
    dev = generator.device
    draws = {'u_coarse': torch.rand((n_rays, first), generator=generator,
                                    device=dev)}
    if fine:
        draws['u_fine'] = torch.rand((n_rays, fine), generator=generator,
                                     device=dev)
    shape = _encode_uniform_shape(options, n_rays * options.num_steps,
                                  grid_levels, interp)
    if shape is not None:
        draws['u_enc'] = torch.rand(shape, generator=generator, device=dev)
        if options.upsample_steps and not options.proposal_steps:
            draws['u_enc_upsample'] = torch.rand(
                _encode_uniform_shape(options,
                                      n_rays * options.upsample_steps,
                                      grid_levels, interp),
                generator=generator, device=dev)
    return draws


def render_rays(field, rays_o, rays_d, direction_norms, key=None,
                options=RenderOptions(), occupancy=None, draws=None):
    """Render a flat batch of rays.

    rays_o, rays_d: (N, 3); direction_norms: (N, 1), the z-depth factor
    |(u, v, 1)| from the ray generator. With options.perturb the render
    takes its training form: the uniforms come from `draws` (see
    draw_perturbations) or, when it is None, are drawn from `key`, a
    torch.Generator on the rays' device; with neither, or without
    perturb, the render is the eval form. occupancy: None, or
    (density_grid (R, R, R), trained_mask (R, R, R), threshold) from
    OccupancyGrid.state() and its config.
    """
    if options.level_window is not None:
        raise NotImplementedError('level windows are not ported yet')
    c = field.config
    bound = c.bound
    n_rays = rays_o.shape[0]
    num_steps = options.num_steps
    dev = rays_o.device
    grid = c.grid_config if c.encoding in ('hg', 'hg+freq') else None
    if options.perturb and draws is None and key is not None:
        draws = draw_perturbations(key, n_rays, options,
                                   grid.n_levels if grid else 0,
                                   c.grid_interp)
    if not options.perturb:
        draws = None
    u_coarse = None if draws is None else draws['u_coarse']
    u_fine = None if draws is None else draws.get('u_fine')
    # The encode's estimator for each main-field query (the proposal net has
    # no grid), as JAX's k_enc and fold_in(k_enc, 1) feed it: the sampled
    # backward, or else the stochastic-corner or residual encode; empty for
    # the exact encode.
    enc, enc_upsample = {}, {}
    if draws is not None and grid is not None and (
            options.sampled_backward or options.stochastic_corners):
        names = ['u_enc'] + (['u_enc_upsample'] if options.upsample_steps
                             and not options.proposal_steps else [])
        if any(name not in draws for name in names):
            raise ValueError(f'the encode\'s estimator needs {names} in '
                             'draws')
        if options.sampled_backward:
            opts = dict(sampled_backward=options.sampled_backward,
                        backward_points=options.backward_points)
        else:
            opts = dict(n_samples=max(1, int(options.stochastic_corners)),
                        exact_levels=options.stochastic_exact_levels,
                        residual=options.stochastic_residual)
        enc = dict(opts, u=draws['u_enc'])
        if 'u_enc_upsample' in names:
            enc_upsample = dict(opts, u=draws['u_enc_upsample'])

    near, far = ray_aabb_intersect(rays_o, rays_d, bound)
    if occupancy is not None and options.occupancy_near_far:
        near, far = shrink_near_far(occupancy, rays_o, rays_d, near, far,
                                    bound, options.occupancy_probes)
    sample_dist = (far - near) / num_steps  # (N, 1)

    proposal_info = None
    if options.proposal_steps > 0:
        sp = options.proposal_steps
        dist_p = (far - near) / sp
        z_p = near + (far - near) * torch.linspace(0.0, 1.0, sp,
                                                   device=dev)[None, :]
        if u_coarse is not None:
            z_p = z_p + (u_coarse - 0.5) * dist_p
        xyz_p = _points(rays_o, rays_d, z_p, bound)
        sigma_p = field.proposal_sigma(xyz_p.reshape(-1, 3))
        sigma_p = sigma_p.reshape(n_rays, sp)
        deltas_p = _deltas(z_p, dist_p)
        w_p = _composite_weights(sigma_p, deltas_p)
        proposal_info = (z_p, deltas_p, w_p)
        z_mid = 0.5 * (z_p[..., 1:] + z_p[..., :-1])
        z = sample_pdf(z_mid, w_p[..., :-1].detach(), num_steps, u=u_fine)
        z = torch.sort(z, dim=-1).values
    else:
        z = near + (far - near) * torch.linspace(0.0, 1.0, num_steps,
                                                 device=dev)[None, :]
        if u_coarse is not None:
            z = z + (u_coarse - 0.5) * sample_dist

    def query_density(z_vals, estimator):
        xyz = _points(rays_o, rays_d, z_vals, bound)
        flat = xyz.reshape(-1, 3)
        sigma, geo = field.density(flat, **estimator)
        sigma = _mask_sigma(occupancy, flat, sigma, bound)
        s = z_vals.shape[1]
        return xyz, sigma.reshape(n_rays, s), geo.reshape(n_rays, s, -1)

    use_fused = (c.heads_impl == 'pallas' and options.upsample_steps == 0
                 and field.fused_heads_available())
    if use_fused:
        xyz = _points(rays_o, rays_d, z, bound)
        flat = xyz.reshape(-1, 3)
        dirs_flat = rays_d[:, None, :].expand(n_rays, num_steps,
                                              3).reshape(-1, 3)
        sigma_f, rgb_f, logits_f, feats_f = field.all_heads(flat, dirs_flat,
                                                            **enc)
        sigma = _mask_sigma(occupancy, flat, sigma_f,
                            bound).reshape(n_rays, num_steps)
    else:
        xyz, sigma, geo = query_density(z, enc)

    if not use_fused and options.upsample_steps > 0:
        w_coarse = _composite_weights(sigma.detach(), _deltas(z, sample_dist))
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_new = sample_pdf(z_mid, w_coarse[..., :-1], options.upsample_steps,
                           u=u_fine).detach()
        xyz_new, sigma_new, geo_new = query_density(z_new, enc_upsample)
        z_all = torch.cat([z, z_new], dim=-1)
        z, order = torch.sort(z_all, dim=-1, stable=True)
        sigma = torch.gather(torch.cat([sigma, sigma_new], dim=-1), 1, order)
        geo_all = torch.cat([geo, geo_new], dim=1)
        geo = torch.gather(geo_all, 1,
                           order[..., None].expand(-1, -1, geo_all.shape[-1]))
        xyz = torch.gather(torch.cat([xyz, xyz_new], dim=1), 1,
                           order[..., None].expand(-1, -1, 3))

    total_steps = z.shape[1]
    deltas = _deltas(z, sample_dist)
    weights = _composite_weights(sigma, deltas)
    weights_sum = weights.sum(dim=-1)

    interlevel = None
    if proposal_info is not None and torch.is_grad_enabled():
        # The proposal learns to cover the main field's weights; the main
        # field is not influenced (stop-gradient on the main side). Only a
        # step that records a graph consumes it (the JAX package's eval
        # renderer drops it too), so renders under no_grad or
        # inference_mode skip its (N, S, S_p) overlap matrix.
        interlevel = _interlevel_loss(z.detach(), deltas.detach(),
                                      weights.detach(), *proposal_info)

    if use_fused:
        rgb = rgb_f.reshape(n_rays, total_steps, 3)
        sem_logits = logits_f.float().reshape(n_rays, total_steps, -1)
        sem_features = feats_f.reshape(n_rays, total_steps, -1)
    else:
        geo_flat = geo.reshape(-1, geo.shape[-1])
        dirs = rays_d[:, None, :].expand(n_rays, total_steps, 3)
        rgb = field.color(dirs.reshape(-1, 3), geo_flat)
        rgb = rgb.reshape(n_rays, total_steps, 3)
        logits, sem_features = field.semantic(geo_flat)
        sem_logits = logits.float().reshape(n_rays, total_steps, -1)
        sem_features = sem_features.reshape(n_rays, total_steps, -1)

    w = weights[..., None]
    image = (w * rgb).sum(dim=1) + (1.0 - weights_sum[:, None]) * \
        options.bg_color
    t_exp = (weights * z).sum(dim=-1)
    depth = t_exp / direction_norms[:, 0]
    z_depth = z / direction_norms
    depth_variance = (weights * (z_depth - depth[:, None]) ** 2).sum(dim=-1)
    out = {
        'image': image,
        'depth': depth,
        'depth_variance': depth_variance,
        'semantic': (w * sem_logits).sum(dim=1),
        'semantic_features': (w * sem_features).sum(dim=1),
        'coordinates_map': (w * xyz).sum(dim=1),
        'weights_sum': weights_sum,
    }
    if interlevel is not None:
        out['interlevel'] = interlevel
    return out


class StagedRenderer:
    """Memory-bounded full-frame rendering: rays in chunks of
    max_ray_batch, the last chunk as long as the rays left (rays render
    independently; the JAX package pads it to keep one compiled shape,
    which nothing here needs)."""

    def __init__(self, field, options=None, max_ray_batch=4096):
        self.field = field
        self.options = options or RenderOptions()
        self.max_ray_batch = max_ray_batch

    @torch.inference_mode()
    def render(self, rays_o, rays_d, direction_norms):
        """rays_*: (..., 3) arrays of any leading shape; returns a dict of
        tensors on the field's device with the same leading shape."""
        dev = self.field.device
        lead_shape = tuple(np.shape(rays_o)[:-1])

        def flat(a, width):
            return torch.as_tensor(np.asarray(a, np.float32).reshape(-1,
                                                                     width))

        o, d, dn = flat(rays_o, 3), flat(rays_d, 3), flat(direction_norms, 1)
        o, d, dn = o.to(dev), d.to(dev), dn.to(dev)
        chunk = self.max_ray_batch
        outs = []
        for start in range(0, o.shape[0], chunk):
            sl = slice(start, start + chunk)
            outs.append(render_rays(self.field, o[sl], d[sl], dn[sl],
                                    options=self.options))
        merged = {k: torch.cat([out[k] for out in outs]) for k in outs[0]}
        return {k: v.reshape(*lead_shape, *v.shape[1:])
                for k, v in merged.items()}
