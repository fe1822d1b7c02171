"""Baked fast preview: render rgb, depth and semantics without field
queries.

Counterpart of autolabel_tpu/render/baked.py, with the same two phases:

  bake():   evaluate the trained field once on a dense voxel grid (in
            chunks, through the field's own density, color and semantic
            heads, so on the card the encode kernels run), keep the
            surface cells (alpha above a threshold) and store them as a
            fixed-size splat cloud with per-splat rgb (or degree-1 SH
            colour), class id and cell size.
  render(): project the splats, resolve visibility with a z-buffer and
            grow each splat over its footprint: the splat render K8
            (ops/splat_cuda.py) on the card, its plain version on the CPU.

The host parts are numpy, as in the JAX package: the grid, the adaptive
alpha threshold, the top-alpha cut and the zero padding, so one field
bakes the same cells in both packages up to the rounding of its
densities. The field carries its own parameters, so the functions that
take `params` in the JAX package take none here. Splat caches are torch
tensors on the field's device.
"""
import dataclasses
import time

import numpy as np
import torch

from autolabel_tpu_torch.ops import splat_cuda


@dataclasses.dataclass
class BakedScene:
    """Fixed-size splat cloud: positions (K, 3), rgb (K, 3), class ids
    (K,), validity mask (K,) and the cell size (world units), as tensors
    on one device.

    `sh` optionally holds degree-1 spherical-harmonic colour coefficients
    (K, 3, 3): d rgb / d view-direction component. With it, the renderer
    evaluates rgb + view . sh per splat (view = unit vector camera ->
    splat), recovering the field's view dependence."""
    points: torch.Tensor
    rgb: torch.Tensor
    semantic: torch.Tensor
    valid: torch.Tensor
    cell_size: float
    sh: torch.Tensor = None

    @property
    def n_valid(self):
        return int(self.valid.sum())


_SH_DIRS = np.array([[1, 0, 0], [-1, 0, 0],
                     [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1]], np.float32)


def _make_shade_fn(field, view_dependent):
    """shade(x) -> (dc_rgb, lin or None, class), tensors on the field's
    device.

    view_dependent fits a degree-1 SH per splat from 6 axis-aligned view
    probes of the colour head (closed-form least squares on +/- axis
    pairs): dc = mean(colours), lin[a] = (c(+a) - c(-a)) / 2."""

    @torch.inference_mode()
    def shade(x):
        _, geo = field.density(x)
        logits, _ = field.semantic(geo)
        sem = torch.argmax(logits, dim=-1).to(torch.int32)
        if not view_dependent:
            view = torch.tensor([0.0, 0.0, -1.0],
                                device=x.device).expand(x.shape[0], 3)
            return field.color(view, geo), None, sem
        dirs = torch.as_tensor(_SH_DIRS, device=x.device)
        colors = torch.stack([field.color(d.expand(x.shape[0], 3), geo)
                              for d in dirs])  # (6, n, 3)
        dc = colors.mean(dim=0)
        lin = torch.stack([(colors[2 * a] - colors[2 * a + 1]) * 0.5
                           for a in range(3)], dim=1)  # (n, 3 axis, 3 rgb)
        return dc, lin, sem

    return shade


def _make_density_fn(field):
    @torch.inference_mode()
    def density(x):
        return field.density(x)[0]

    return density


def _sigmas(density_fn, grid, chunk, device):
    """The field's density at every row of the host grid, in chunks."""
    sigmas = np.empty(grid.shape[0], np.float32)
    for start in range(0, grid.shape[0], chunk):
        sl = slice(start, start + chunk)
        sigmas[sl] = density_fn(torch.as_tensor(grid[sl]).to(
            device)).cpu().numpy()
    return sigmas


def _top_alpha(alpha, threshold, budget):
    """Indices of the cells above threshold, the budget's top-alpha ones
    when there are more (the JAX package's descending argsort)."""
    candidates = np.flatnonzero(alpha > threshold)
    if candidates.size > budget:
        order = np.argsort(alpha[candidates])[::-1]
        candidates = candidates[order[:budget]]
    return candidates


def bake(field, resolution=192, max_points=2 ** 19, alpha_threshold=None,
         chunk=65536, view_dependent=True):
    """Evaluate the field on a resolution^3 grid and keep surface cells.

    With view_dependent (default), each splat stores a degree-1 SH colour
    fitted from 6 axis view probes; without it, the colour under a
    canonical downward view. Returns a BakedScene with exactly max_points
    rows (top-alpha cells, zero-padded) on the field's device.
    """
    bound = field.config.bound
    r = resolution
    cell = 2.0 * bound / r
    centers_1d = np.linspace(-bound + cell / 2, bound - cell / 2, r,
                             dtype=np.float32)
    grid = np.stack(np.meshgrid(centers_1d, centers_1d, centers_1d,
                                indexing='ij'), axis=-1).reshape(-1, 3)
    dev = field.device
    sigmas = _sigmas(_make_density_fn(field), grid, chunk, dev)

    alpha = 1.0 - np.exp(-sigmas * cell)
    if alpha_threshold is None:
        # Adaptive: half the near-max opacity, floored.
        alpha_threshold = max(0.5 * np.percentile(alpha, 99.9), 0.01)
    candidates = _top_alpha(alpha, alpha_threshold, max_points)
    n = candidates.size
    points = grid[candidates]

    shade = _make_shade_fn(field, view_dependent)
    rgb = np.zeros((max_points, 3), np.float32)
    sh = np.zeros((max_points, 3, 3), np.float32) if view_dependent else None
    semantic = np.zeros(max_points, np.int32)
    out_points = np.zeros((max_points, 3), np.float32)
    out_points[:n] = points
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        c, lin, s = shade(torch.as_tensor(points[sl]).to(dev))
        rgb[sl] = c.cpu().numpy()
        if view_dependent:
            sh[sl] = lin.cpu().numpy()
        semantic[sl] = s.cpu().numpy()

    valid = np.zeros(max_points, bool)
    valid[:n] = True
    return BakedScene(points=torch.as_tensor(out_points).to(dev),
                      rgb=torch.as_tensor(rgb).to(dev),
                      semantic=torch.as_tensor(semantic).to(dev),
                      valid=torch.as_tensor(valid).to(dev),
                      cell_size=cell,
                      sh=None if sh is None else torch.as_tensor(sh).to(dev))


def _slab_write(buf, upd, start):
    """Write `upd` into device buffer `buf` at row `start`."""
    buf[start:start + upd.shape[0]] = upd
    return buf


def _sync(tensor):
    """Wait for the work that produces `tensor` (nothing on the CPU)."""
    if tensor.device.type == 'cuda':
        torch.cuda.synchronize(tensor.device)


class IncrementalBaker:
    """Amortized re-bake: update one slab of the volume at a time.

    A full bake() sweeps resolution^3 density queries. This splits the
    volume into `n_blocks` slabs along x, each owning max_points //
    n_blocks splat rows (top-alpha within the slab), so one
    update_next_block() call costs about 1/n_blocks of a full bake and an
    interactive loop interleaves slab refreshes between train steps.
    """

    def __init__(self, field, resolution=128, max_points=2 ** 18,
                 n_blocks=16, chunk=65536, view_dependent=True):
        assert resolution % n_blocks == 0
        self.field = field
        self.resolution = resolution
        self.n_blocks = n_blocks
        self.chunk = chunk
        self.view_dependent = view_dependent
        self.points_per_block = max_points // n_blocks
        self.max_points = self.points_per_block * n_blocks

        bound = field.config.bound
        r = resolution
        self.cell = 2.0 * bound / r
        centers = np.linspace(-bound + self.cell / 2, bound - self.cell / 2,
                              r, dtype=np.float32)
        self._centers = centers
        self._rows_per_block = r // n_blocks

        self._points = np.zeros((self.max_points, 3), np.float32)
        self._rgb = np.zeros((self.max_points, 3), np.float32)
        self._sh = (np.zeros((self.max_points, 3, 3), np.float32)
                    if view_dependent else None)
        self._semantic = np.zeros(self.max_points, np.int32)
        self._valid = np.zeros(self.max_points, bool)
        self._next_block = 0
        # The alpha scale for thresholding is global: a decaying max of the
        # slabs' 99.9th alpha percentiles, 0.9x per full rotation (the
        # n_blocks-th root a block), so a mostly empty slab does not admit
        # low-alpha fog in front of surfaces baked from other slabs.
        self._alpha_scale = 0.0
        self._block_decay = 0.9 ** (1.0 / n_blocks)
        self._density_fn = _make_density_fn(field)
        self._shade_fn = _make_shade_fn(field, view_dependent)
        # The device-resident splat cache, built on the first scene();
        # update_block then uploads only its own slab.
        self._dev = None

    def _slab_alpha(self, block):
        """Density-sweep slab `block`: (grid points (M, 3), alpha (M,))."""
        rows = slice(block * self._rows_per_block,
                     (block + 1) * self._rows_per_block)
        grid = np.stack(np.meshgrid(self._centers[rows], self._centers,
                                    self._centers, indexing='ij'),
                        axis=-1).reshape(-1, 3)
        sigmas = _sigmas(self._density_fn, grid, self.chunk,
                         self.field.device)
        return grid, 1.0 - np.exp(-sigmas * self.cell)

    def update_block(self, block, _precomputed=None):
        """Re-evaluate slab `block` and refresh its splat rows."""
        if _precomputed is None:
            grid, alpha = self._slab_alpha(block)
            self._alpha_scale = max(float(np.percentile(alpha, 99.9)),
                                    self._block_decay * self._alpha_scale)
        else:
            grid, alpha = _precomputed
        threshold = max(0.5 * self._alpha_scale, 0.01)
        candidates = _top_alpha(alpha, threshold, self.points_per_block)
        n = candidates.size

        out = slice(block * self.points_per_block,
                    block * self.points_per_block + self.points_per_block)
        self._points[out] = 0.0
        self._valid[out] = False
        if n:
            pts = grid[candidates]
            self._points[out.start:out.start + n] = pts
            dev = self.field.device
            for start in range(0, n, self.chunk):
                sl = slice(start, min(start + self.chunk, n))
                c, lin, s = self._shade_fn(torch.as_tensor(pts[sl]).to(dev))
                dst = slice(out.start + sl.start, out.start + sl.stop)
                self._rgb[dst] = c.cpu().numpy()
                if self._sh is not None:
                    self._sh[dst] = lin.cpu().numpy()
                self._semantic[dst] = s.cpu().numpy()
            self._valid[out.start:out.start + n] = True
        self._commit_block(block)

    def _host(self):
        return (('points', self._points), ('rgb', self._rgb),
                ('semantic', self._semantic), ('valid', self._valid),
                ('sh', self._sh))

    def _commit_block(self, block):
        """Upload one refreshed slab into the device-side cache."""
        if self._dev is None:
            return
        out = slice(block * self.points_per_block,
                    (block + 1) * self.points_per_block)
        for key, host in self._host():
            if host is None:
                continue
            self._dev[key] = _slab_write(
                self._dev[key],
                torch.as_tensor(host[out]).to(self._dev[key].device),
                out.start)

    def update_next_block(self):
        """Refresh the next slab in rotation; returns the block index."""
        block = self._next_block
        if self._alpha_scale == 0.0:
            # Cold start: one density-only sweep of every slab sets the
            # global scale before any slab commits splats; the current
            # slab's sweep is reused for its own update.
            precomputed = None
            for b in range(self.n_blocks):
                pre = self._slab_alpha(b)
                self._alpha_scale = max(self._alpha_scale,
                                        float(np.percentile(pre[1], 99.9)))
                if b == block:
                    precomputed = pre
            self.update_block(block, _precomputed=precomputed)
        else:
            self.update_block(block)
        self._next_block = (block + 1) % self.n_blocks
        return block

    def update_all(self):
        """Full refresh: sweep every slab's densities first so the alpha
        threshold is set by global statistics (as bake()), then select and
        shade each slab against it."""
        slabs = [self._slab_alpha(b) for b in range(self.n_blocks)]
        self._alpha_scale = max(
            max(float(np.percentile(a, 99.9)) for _, a in slabs),
            0.9 * self._alpha_scale)
        for block, pre in enumerate(slabs):
            self.update_block(block, _precomputed=pre)

    def scene(self):
        if self._dev is None:
            dev = self.field.device
            # copies, also on the CPU, so later host edits stay host-side
            self._dev = {key: None if host is None else
                         torch.tensor(host, device=dev)
                         for key, host in self._host()}
        return BakedScene(points=self._dev['points'],
                          rgb=self._dev['rgb'],
                          semantic=self._dev['semantic'],
                          valid=self._dev['valid'],
                          cell_size=self.cell,
                          sh=self._dev['sh'])


class GovernedPreviewRenderer:
    """BakedRenderer with an fps governor: adapts the splat budget to hold
    a target frame rate.

    Level k renders every 2^k-th splat (stride subsampling keeps spatial
    coverage; one more fill pass per halving). Frames are synced every
    `sync_every` frames and the batch time is attributed evenly, so the
    governor sees pipelined throughput. A down-step must earn its fidelity
    cost: if, settled at the lower level, the frame time did not improve
    by `min_gain` over the level above, the governor reverts and locks the
    down-move out for `lockout` sync batches. It steps up when the time
    beats target * headroom. A level's first batch at a frame size is not
    timed. time_fn (default time.perf_counter) is the clock.
    """

    def __init__(self, baked: BakedScene, target_fps=30.0, n_levels=3,
                 ema=0.4, headroom=0.45, sync_every=8, min_gain=0.15,
                 lockout=8, time_fn=None):
        self.target_fps = target_fps
        self.headroom = headroom
        self.sync_every = sync_every
        self.min_gain = min_gain
        self.lockout = lockout
        self._ema_w = ema
        self._time = time_fn if time_fn is not None else time.perf_counter
        self.n_levels = n_levels
        self.level = 0
        self._ema_s = None
        self._level_time = {}     # settled per-frame time by level
        self._down_locked = 0     # sync batches until down-steps allowed
        self._probing_down = False
        self._batches_at_level = 0
        self._rendered = set()
        self._pending = 0
        self._batch_start = None
        self._last_out = None
        self.set_scene(baked)

    def set_scene(self, baked: BakedScene):
        """Swap in a fresh bake: each level's strided rows, made contiguous
        once here rather than at every frame."""
        self._levels = []
        for k in range(self.n_levels):
            stride = 1 << k
            self._levels.append(BakedScene(
                points=baked.points[::stride].contiguous(),
                rgb=baked.rgb[::stride].contiguous(),
                semantic=baked.semantic[::stride].contiguous(),
                valid=baked.valid[::stride].contiguous(),
                cell_size=baked.cell_size * stride,
                sh=None if baked.sh is None else
                baked.sh[::stride].contiguous()))

    def _renderer(self):
        return BakedRenderer(self._levels[self.level],
                             fill_passes=2 + self.level)

    def warmup(self, intrinsics, size):
        """Render every level once at this frame size, off the interactive
        path, so no timed batch pays a first call."""
        for level in range(self.n_levels):
            BakedRenderer(self._levels[level],
                          fill_passes=2 + level).render(
                              intrinsics, np.eye(4), size)
            self._rendered.add((level, tuple(size)))

    def render(self, intrinsics, T_CW, size):
        key = (self.level, tuple(size))
        first = key not in self._rendered
        if self._batch_start is None:
            self._batch_start = self._time()
        out = self._renderer().render(intrinsics, T_CW, size)
        self._rendered.add(key)
        self._pending += 1
        self._last_out = out
        if self._pending >= self.sync_every or first:
            _sync(out['depth'])
            elapsed = self._time() - self._batch_start
            per_frame = elapsed / self._pending
            self._pending = 0
            self._batch_start = None
            if not first:
                self._record(per_frame)
        out['splat_level'] = self.level
        return out

    def flush(self):
        """Sync any in-flight frames (call before idling so the next
        batch's timing does not absorb queued work)."""
        if self._pending and self._last_out is not None:
            _sync(self._last_out['depth'])
            elapsed = self._time() - self._batch_start
            self._record(elapsed / self._pending)
        self._pending = 0
        self._batch_start = None

    def _record(self, per_frame):
        self._ema_s = (per_frame if self._ema_s is None else
                       self._ema_w * per_frame
                       + (1 - self._ema_w) * self._ema_s)
        self._batches_at_level += 1
        if self._batches_at_level >= 2:
            self._govern()

    def _switch(self, level, probing_down=False):
        self._level_time[self.level] = self._ema_s
        self.level = level
        self._ema_s = None
        self._batches_at_level = 0
        self._probing_down = probing_down

    def _govern(self):
        budget = 1.0 / self.target_fps
        if self._down_locked > 0:
            self._down_locked -= 1
        if self._probing_down:
            # Did dropping splats buy time? If not, the floor is elsewhere:
            # revert and lock out.
            above = self._level_time.get(self.level - 1)
            if above is not None and \
                    self._ema_s > (1.0 - self.min_gain) * above:
                self._down_locked = self.lockout
                self._switch(self.level - 1)
                return
            self._probing_down = False
        if (self._ema_s > budget and self.level < self.n_levels - 1
                and self._down_locked == 0):
            self._switch(self.level + 1, probing_down=True)
        elif (self._ema_s < budget * self.headroom and self.level > 0):
            self._switch(self.level - 1)

    @property
    def fps_estimate(self):
        return None if not self._ema_s else 1.0 / self._ema_s


def fill_passes_for(width, fill_passes):
    """The fill passes BakedRenderer runs: one pixel ring a pass, so larger
    frames need more for the same physical splat radius (4 below 640 px of
    width, 8 from there); passes beyond a splat's radius are gated
    no-ops."""
    return max(fill_passes, 4 if width < 640 else 8)


class BakedRenderer:
    """Renders preview frames from a BakedScene at any resolution."""

    def __init__(self, baked: BakedScene, fill_passes=2):
        self.baked = baked
        self.fill_passes = fill_passes

    def render(self, intrinsics, T_CW, size):
        """intrinsics: (3, 3) camera matrix at `size`; T_CW: (4, 4)
        world->camera in the field's (converted) world space, i.e.
        np.linalg.inv(core.rays.convert_pose(T_CW_scene_file)), both host
        arrays; size: (width, height). Returns a dict of tensors on the
        scene's device: image (H, W, 3), depth (H, W) z-depth, semantic
        (H, W) class ids, splat_hit (H, W)."""
        width, height = int(size[0]), int(size[1])
        passes = fill_passes_for(width, self.fill_passes)
        b = self.baked
        # K8 on the card, its plain version on the CPU
        image, depth, classes, splat_hit = splat_cuda.splat_render(
            b.points, b.rgb, b.sh, b.semantic, b.valid, intrinsics, T_CW,
            height, width, passes, float(b.cell_size))
        return {'image': image, 'depth': depth, 'semantic': classes,
                'splat_hit': splat_hit}
