"""The splat render of the baked preview: csrc/splat_render.cu (K8).

Counterpart of autolabel_tpu/render/baked.py `_splat_render`, which XLA
compiles for the TPU: project K splats into an H x W frame, keep each
pixel's nearest splat with a scatter-min z-buffer, average the colours of
the splats that tie with it (scatter-add) and take the largest class among
them (scatter-max), then grow every splat over its projected footprint in
`fill_passes` passes over the 8 neighbours, and paint the pixels no splat
reached as background.

Outputs: image (H, W, 3) f32, depth (H, W) f32 (0 on the background),
classes (H, W) int32 and splat_hit (H, W) bool, the pixels a splat landed
on before the fill passes.

The arithmetic is the JAX package's as XLA computes it on the CPU: the
camera transform, the camera centre (once a frame, on the host), the view
direction's norm and the SH dot product are chains of fused multiply-adds (the first product rounded,
each further term added by an fma), which both versions reproduce by
rounding a double-precision product-sum to fp32 once per term; every other
operation is one correctly rounded fp32 operation in the JAX order (the
square root taken in double precision, since torch's fp32 root on the CPU
is not correctly rounded), so the pixel a splat
lands on, its depth and the fill passes' gate are the JAX package's.

`splat_render` computes the plain version (`splat_render_plain`, dense
torch ops: scatter_reduce_ amin / sum / amax and torch.roll) on CPU
tensors and launches K8 on CUDA tensors, or raises. The camera
(`intrinsics` (3, 3), `T_CW` (4, 4), world to camera) is host data, read
as fp32. K8 runs the fill passes on tiles with a halo in shared memory;
`fill_tiled_plain` is a plain mirror of that scheme, for the tests.
"""
import ctypes
import functools

import numpy as np
import torch

from autolabel_tpu_torch.ops import _kernels

NAME = 'splat_render'
_SOURCE = 'splat_render.cu'
BIG = 1e9  # the z-buffer's empty value and a hole's replaceable depth
NEAR = 0.05  # splats at z <= NEAR are behind the camera
# A splat wins its pixel when z <= zbuf * WIN_FACTOR: JAX's weak-typed
# (1.0 + 1e-4) rounded to fp32 (bits 0x3f800347, WIN_FACTOR_BITS in the
# kernel).
WIN_FACTOR = np.float32(1.0 + 1e-4)
# The fill kernel's output tile (TILE x TILE pixels a block) and the most
# passes one launch runs, its halo's width (the kernel's #defines).
TILE = 32
HALO_MAX = 8


def launches_for(passes):
    """K8's launches a frame: the memset of the accumulators, project,
    winners and one fill launch for every HALO_MAX passes (at least one:
    with no pass it resolves the frame alone)."""
    return 3 + max(1, -(-passes // HALO_MAX))


def _camera(intrinsics, T_CW):
    """The camera as fp32 host arrays (JAX's jnp.asarray(., float32))."""
    K = np.asarray(intrinsics, dtype=np.float32).reshape(3, 3)
    T = np.asarray(T_CW, dtype=np.float32).reshape(4, 4)
    return K, T


def _fma_chain(terms):
    """sum_i a_i * b_i in fp32 as XLA's CPU dot computes it: the first
    product rounded, each further term added by a fused multiply-add (one
    rounding of the double-precision product-sum)."""
    (a, b), rest = terms[0], terms[1:]
    acc = a * b
    for a, b in rest:
        acc = (a.double() * b.double() + acc.double()).float()
    return acc


def _centre(T):
    """The camera centre -R^T t of the fp32 world -> camera T, three fp32
    values as host floats, by _fma_chain's arithmetic on scalars (a
    product of two fp32 values is exact in double); K8 takes these."""
    t = T.tolist()
    out = []
    for j in range(3):
        acc = float(np.float32(-t[0][j] * t[0][3]))
        for i in (1, 2):
            acc = float(np.float32(-t[i][j] * t[i][3] + acc))
        out.append(acc)
    return out


def project_plain(points, rgb, sh, valid, intrinsics, T_CW, height, width):
    """Per splat: (z, u, v, pid, ok, shaded rgb). pid is the pixel a splat
    lands on (row-major), height * width for one that lands nowhere; ok
    marks the valid splats in front of the camera and in the frame."""
    K, T = _camera(intrinsics, T_CW)
    dev = points.device
    f32 = [[torch.tensor(float(T[i, j]), dtype=torch.float32, device=dev)
             for j in range(4)] for i in range(3)]
    p = points.unbind(1)
    cam = [_fma_chain([(p[0], f32[j][0]), (p[1], f32[j][1]),
                       (p[2], f32[j][2])]) + f32[j][3] for j in range(3)]
    z = cam[2]
    in_front = (z > NEAR) & valid
    if sh is not None:
        # The unit view direction camera centre -> splat and
        # rgb + sum_a view_a sh[:, a], clipped to [0, 1].
        centre = _centre(T)
        view = [p[a] - torch.tensor(centre[a], dtype=torch.float32,
                                    device=dev) for a in range(3)]
        # torch's fp32 sqrt on the CPU is not correctly rounded; the
        # double-precision root rounded to fp32 is.
        norm = _fma_chain([(view[a], view[a]) for a in range(3)])
        norm = torch.clamp(norm.double().sqrt().float(), min=1e-8)
        view = [view[a] / norm for a in range(3)]
        lin = torch.stack([_fma_chain([(view[a], sh[:, a, c])
                                       for a in range(3)])
                           for c in range(3)], dim=1)
        rgb = torch.clamp(rgb + lin, 0.0, 1.0)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    u = fx * cam[0] / z + cx
    v = fy * cam[1] / z + cy
    # jnp.round rounds half to even, as torch.round does; the frame test
    # is made on the rounded floats, so no out-of-range conversion happens.
    px, py = torch.round(u), torch.round(v)
    ok = in_front & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    zero = torch.zeros_like(px)
    pid = torch.where(ok, torch.where(ok, py, zero).long() * width
                      + torch.where(ok, px, zero).long(), height * width)
    return z, u, v, pid, ok, rgb


def scatter_plain(z, pid, ok, rgb, semantic, n_pixels):
    """The z-buffer and the winners' sums: three scatter_reduce_ calls
    (amin of z, sum of [rgb, 1] over the winners, amax of class + 1).
    Returns zbuf (n + 1,), sums (n + 1, 4), sem (n + 1,) int32; slot n is
    the dump of the splats that land nowhere."""
    dev = z.device
    big = torch.full_like(z, BIG)
    zbuf = torch.full((n_pixels + 1,), BIG, dtype=torch.float32,
                      device=dev).scatter_reduce_(
                          0, pid, torch.where(ok, z, big), 'amin')
    win = ok & (z <= zbuf[pid] * torch.tensor(WIN_FACTOR, device=dev))
    winf = win.float()[:, None]
    terms = torch.cat([rgb * winf, winf], dim=1)
    sums = torch.zeros((n_pixels + 1, 4), dtype=torch.float32,
                       device=dev).scatter_reduce_(
                           0, pid[:, None].expand(-1, 4), terms, 'sum')
    sem = torch.zeros(n_pixels + 1, dtype=torch.int32,
                      device=dev).scatter_reduce_(
                          0, pid, torch.where(win, semantic + 1,
                                              torch.zeros_like(semantic)),
                          'amax')
    return zbuf, sums, sem


def fill_pass_plain(state, ring, cell, focal):
    """One footprint pass (JAX `fill`): every pixel adopts the nearest of
    its 8 neighbours (jnp.roll's wrap-around, dy outer, dx inner) whose
    footprint reaches this ring and that is in front of what it shows."""
    image, depth, classes, hit = state
    margin = torch.maximum(3.0 * cell, depth * 0.05)
    beat = torch.where(hit, depth - margin, torch.full_like(depth, BIG))
    best_d = torch.full_like(depth, BIG)
    best_i, best_c = image, classes
    took = torch.zeros_like(hit)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nd = torch.roll(depth, (dy, dx), dims=(0, 1))
            ni = torch.roll(image, (dy, dx), dims=(0, 1))
            nc = torch.roll(classes, (dy, dx), dims=(0, 1))
            nh = torch.roll(hit, (dy, dx), dims=(0, 1))
            rad_px = cell * focal / (2.0 * torch.clamp(nd, min=1e-6))
            reach = torch.where(hit, rad_px, 2.0 * rad_px) + 0.5 >= ring
            take = nh & reach & (nd < torch.minimum(beat, best_d))
            best_d = torch.where(take, nd, best_d)
            best_i = torch.where(take[..., None], ni, best_i)
            best_c = torch.where(take, nc, best_c)
            took = took | take
    return best_i, torch.where(took, best_d, depth), best_c, hit | took


def resolve_plain(zbuf, sums, sem, height, width):
    """Stage (c) of the plain version: each pixel's mean colour, depth,
    class (+ 1, 0 for a hole) and hit from the scatters, the state the
    fill passes take; its hit is also splat_hit."""
    n_pixels = height * width
    cnt = sums[:n_pixels, 3:]
    image = sums[:n_pixels, :3] / torch.clamp(cnt, min=1.0)
    return (image.reshape(height, width, 3),
            zbuf[:n_pixels].reshape(height, width),
            sem[:n_pixels].reshape(height, width),
            cnt[:, 0].reshape(height, width) > 0)


def fill_plain(state, intrinsics, fill_passes, cell_size):
    """Stage (d) of the plain version: the fill passes over `state` and
    the background rule; (image, depth, classes). The image may carry
    more channels than 3; they ride through the passes with the colour."""
    K, _ = _camera(intrinsics, np.eye(4))
    dev = state[1].device
    focal = torch.tensor(np.float32(0.5) * (K[0, 0] + K[1, 1]), device=dev)
    cell = torch.tensor(np.float32(cell_size), device=dev)
    for i in range(fill_passes):
        state = fill_pass_plain(state, float(i + 1), cell, focal)
    image, depth, classes, hit = state
    image = torch.where(hit[..., None], image, torch.ones_like(image))
    depth = torch.where(hit, depth, torch.zeros_like(depth))
    classes = torch.where(hit, torch.clamp(classes - 1, min=0),
                          torch.zeros_like(classes))
    return image, depth, classes


def fill_tiled_plain(state, intrinsics, fill_passes, cell_size, tile=TILE,
                     halo_max=HALO_MAX):
    """fill_plain by K8's fill scheme, for the tests: the frame cut into
    tile x tile tiles, each read with a halo of P = min(passes left,
    halo_max) pixels a side, rows and columns modulo H and W; P passes over
    the tile and halo, on a region that shrinks by a pixel a side a pass;
    a state of (depth, the pixel whose image and class a pixel shows, -1
    for none) carried from one group of passes to the next; the image and
    class looked up once at the end."""
    image, depth, classes, hit = state
    height, width = depth.shape
    n, dev = height * width, depth.device
    K, _ = _camera(intrinsics, np.eye(4))
    focal = torch.tensor(np.float32(0.5) * (K[0, 0] + K[1, 1]), device=dev)
    cell = torch.tensor(np.float32(cell_size), device=dev)
    carried_d = depth.reshape(n)
    carried_s = torch.where(hit.reshape(n), torch.arange(n, device=dev), -1)
    ty = torch.arange(0, height, tile, device=dev)
    tx = torch.arange(0, width, tile, device=dev)
    inner = torch.arange(tile, device=dev)
    gy, gx = ty[:, None] + inner, tx[:, None] + inner  # the tiles' pixels
    inside = (gy < height)[:, None, :, None] & (gx < width)[None, :, None, :]
    tiles = (gy[:, None, :, None] * width + gx[None, :, None, :])[inside]
    done = 0
    while True:
        halo = min(fill_passes - done, halo_max)
        span = torch.arange(-halo, tile + halo, device=dev)
        rows = (ty[:, None] + span) % height
        cols = (tx[:, None] + span) % width
        region = rows[:, None, :, None] * width + cols[None, :, None, :]
        d, s = carried_d[region], carried_s[region]  # (tiles y, x, R, R)
        r = tile + 2 * halo
        for k in range(1, halo + 1):
            ring = float(done + k)
            own = (..., slice(k, r - k), slice(k, r - k))
            own_d, own_s = d[own], s[own]
            own_hit = own_s >= 0
            margin = torch.maximum(3.0 * cell, own_d * 0.05)
            beat = torch.where(own_hit, own_d - margin,
                               torch.full_like(own_d, BIG))
            best_d = torch.full_like(own_d, BIG)
            best_s, took = own_s, torch.zeros_like(own_hit)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    # jnp.roll(a, (dy, dx))[y, x] = a[y - dy, x - dx]
                    at = (..., slice(k - dy, r - k - dy),
                          slice(k - dx, r - k - dx))
                    nd, ns = d[at], s[at]
                    rad_px = cell * focal / (2.0 * torch.clamp(nd, min=1e-6))
                    reach = torch.where(own_hit, rad_px,
                                        2.0 * rad_px) + 0.5 >= ring
                    take = (ns >= 0) & reach & (
                        nd < torch.minimum(beat, best_d))
                    best_d = torch.where(take, nd, best_d)
                    best_s = torch.where(take, ns, best_s)
                    took = took | take
            d, s = d.clone(), s.clone()
            d[own] = torch.where(took, best_d, own_d)
            s[own] = best_s
        keep = (..., slice(halo, halo + tile), slice(halo, halo + tile))
        carried_d, carried_s = carried_d.clone(), carried_s.clone()
        carried_d[tiles] = d[keep][inside]
        carried_s[tiles] = s[keep][inside]
        done += halo
        if done == fill_passes:
            break
    hit = carried_s >= 0
    source = carried_s.clamp(min=0)
    flat = image.reshape(n, -1)
    image = torch.where(hit[:, None], flat[source], torch.ones_like(flat))
    cls = classes.reshape(n)[source]
    cls = torch.where(hit, torch.clamp(cls - 1, min=0), torch.zeros_like(cls))
    return (image.reshape(height, width, -1),
            torch.where(hit, carried_d, torch.zeros_like(carried_d)).reshape(
                height, width), cls.reshape(height, width))


def splat_render_plain(points, rgb, sh, semantic, valid, intrinsics, T_CW,
                       height, width, fill_passes=2, cell_size=0.0):
    """The plain version of K8, on any device: (image, depth, classes,
    splat_hit)."""
    z, _, _, pid, ok, rgb = project_plain(points, rgb, sh, valid,
                                          intrinsics, T_CW, height, width)
    zbuf, sums, sem = scatter_plain(z, pid, ok, rgb, semantic,
                                    height * width)
    state = resolve_plain(zbuf, sums, sem, height, width)
    return (*fill_plain(state, intrinsics, fill_passes, cell_size),
            state[3])


def _camera_words(intrinsics, T_CW):
    """The 19 floats the kernel takes: fx, fy, cx, cy, T_CW's rotation
    (row-major) and translation, and the camera centre."""
    K, T = _camera(intrinsics, T_CW)
    k, t = K.tolist(), T.tolist()
    return np.array([k[0][0], k[1][1], k[0][2], k[1][2], *t[0][:3],
                     *t[1][:3], *t[2][:3], t[0][3], t[1][3], t[2][3],
                     *_centre(T)], np.float32)


def _check_inputs(points, rgb, sh, semantic, valid):
    k = points.shape[0]
    want = [('points', points, torch.float32, (k, 3)),
            ('rgb', rgb, torch.float32, (k, 3)),
            ('semantic', semantic, torch.int32, (k,)),
            ('valid', valid, torch.bool, (k,))]
    if sh is not None:
        want.append(('sh', sh, torch.float32, (k, 3, 3)))
    for name, t, dtype, shape in want:
        if t.device != points.device or t.device.type != 'cuda':
            raise ValueError(f'{NAME}: inputs must be on one CUDA device')
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{NAME}: {name} must be {dtype} of shape '
                             f'{shape}, got {t.dtype} {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{NAME}: {name} must be contiguous')


@functools.cache
def _launcher():
    """K8's C entry point, its signature set once, when it loads."""
    fn = _kernels.library(_SOURCE).splat_render
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                            ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn


def _layout(k, n, passes):
    """Word offsets of K8's one int32 allocation: the workspace (colour sums
    and counts 4 n, z keys n, classes n, each splat's pixel k and z k),
    the fill launches' carried sources (2 n, only past HALO_MAX passes),
    then the outputs image 3 n, depth n, classes n and splat_hit (n bytes);
    and its length in words."""
    carry = 6 * n + 2 * k
    image = carry + (2 * n if passes > HALO_MAX else 0)
    splat_hit = image + 5 * n
    return dict(carry=carry, image=image, depth=image + 3 * n,
                classes=image + 4 * n, splat_hit=splat_hit), \
        splat_hit + -(-n // 4)


def _splat_call(points, rgb, sh, semantic, valid, intrinsics, T_CW, height,
                width, fill_passes, cell_size):
    """K8: (image, depth, classes, splat_hit, work); work holds each
    splat's pixel (-1 for none) in its first K words and, for a valid
    splat, its z (fp32 bits) in the next K."""
    _check_inputs(points, rgb, sh, semantic, valid)
    if height <= 0 or width <= 0 or fill_passes < 0:
        raise ValueError(f'{NAME}: bad frame {width} x {height} or passes '
                         f'{fill_passes}')
    fn = _launcher()
    k, n, dev = points.shape[0], height * width, points.device
    at, words = _layout(k, n, fill_passes)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    camera = _camera_words(intrinsics, T_CW)
    focal = np.float32(0.5) * (camera[0] + camera[1])  # fill_plain's
    status = fn(points.data_ptr(), rgb.data_ptr(),
                None if sh is None else sh.data_ptr(), semantic.data_ptr(),
                valid.data_ptr(), k, camera.ctypes.data, height, width,
                fill_passes, float(np.float32(cell_size)), float(focal), base,
                base + 4 * at['carry'], base + 4 * at['image'],
                base + 4 * at['depth'], base + 4 * at['classes'],
                base + 4 * at['splat_hit'],
                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(status, NAME)
    _kernels.launches[NAME] += launches_for(fill_passes)
    floats = buf.view(torch.float32)
    return (floats.as_strided((height, width, 3), (3 * width, 3, 1),
                              at['image']),
            floats.as_strided((height, width), (width, 1), at['depth']),
            buf.as_strided((height, width), (width, 1), at['classes']),
            buf.view(torch.bool).as_strided((height, width), (width, 1),
                                            4 * at['splat_hit']),
            buf[6 * n:6 * n + 2 * k])


def splat_render(points, rgb, sh, semantic, valid, intrinsics, T_CW, height,
                 width, fill_passes=2, cell_size=0.0):
    """(image, depth, classes, splat_hit) of a frame: the plain version on
    CPU tensors, K8 on CUDA tensors."""
    if points.device.type == 'cpu':
        return splat_render_plain(points, rgb, sh, semantic, valid,
                                  intrinsics, T_CW, height, width,
                                  fill_passes, cell_size)
    return _splat_call(points, rgb, sh, semantic, valid, intrinsics, T_CW,
                       height, width, fill_passes, cell_size)[:4]


def near_half(x):
    """Where fp32 x lies within 2 ulp of some k + 0.5: a 1-ulp difference
    in x can round it to either neighbour."""
    ulp = torch.nextafter(x.abs(), torch.tensor(np.inf, device=x.device)) \
        - x.abs()
    off = (x.double() - (torch.floor(x.double()) + 0.5)).abs()
    return off <= 2.0 * ulp.double()


def _expected(z, pid, ok, shaded, semantic, intrinsics, height, width,
              fill_passes, cell_size):
    """The plain version's outputs for splats landing on `pid` (n for
    none), and each pixel's image tolerance: where splats tie in a pixel
    their colour sum depends on the order of the atomics, so there within
    (count - 1) ulp of the largest term, carried through the fill passes
    with the colour it belongs to. Returns (image, depth, classes,
    splat_hit, tolerance, the winners' counts)."""
    n = height * width
    zbuf, sums, sem = scatter_plain(z, pid, ok, shaded, semantic, n)
    # the largest winning term of each pixel and channel, and its count
    win = ok & (z <= zbuf[pid] * torch.tensor(WIN_FACTOR, device=z.device))
    largest = torch.zeros((n + 1, 3), dtype=torch.float32,
                          device=z.device).scatter_reduce_(
                              0, pid[:, None].expand(-1, 3),
                              shaded * win.float()[:, None], 'amax')
    cnt = sums[:n, 3:]
    ulp = torch.nextafter(largest[:n], torch.tensor(np.inf,
                                                    device=z.device)) \
        - largest[:n]
    tol = torch.clamp(cnt - 1.0, min=0.0) * ulp
    image, depth, classes, hit = resolve_plain(zbuf, sums, sem, height,
                                               width)
    # the tolerance rides through the passes as 3 more image channels
    state = (torch.cat([image, tol.reshape(height, width, 3)], dim=2),
             depth, classes, hit)
    image, depth, classes = fill_plain(state, intrinsics, fill_passes,
                                       cell_size)
    tol = image[..., 3:] * (depth > 0)[..., None]
    return image[..., :3], depth, classes, hit, tol, cnt


def image_tolerance(points, rgb, sh, semantic, valid, intrinsics, T_CW,
                    height, width, fill_passes=2, cell_size=0.0):
    """Each pixel's image tolerance by check_splat's tie rule, on the plain
    version's pixels: how far two K8 frames' colours may lie apart is
    twice it."""
    z, _, _, pid, ok, shaded = project_plain(points, rgb, sh, valid,
                                             intrinsics, T_CW, height, width)
    return _expected(z, pid, ok, shaded, semantic, intrinsics, height, width,
                     fill_passes, cell_size)[4]


def bound_bytes(points, rgb, sh, semantic, valid, intrinsics, T_CW, height,
                width):
    """The bytes a K8 frame must move for this frame's data, each counted
    once: it reads a byte of `valid` a splat row, the valid splats' points
    (12 bytes) and the winners' colour (12), SH (36, with SH) and class (4),
    and writes 21 bytes a pixel (image 12, depth 4, class 4, splat_hit 1).
    Returns (bytes, the counts)."""
    z, _, _, pid, ok, _ = project_plain(points, rgb, None, valid,
                                        intrinsics, T_CW, height, width)
    zbuf, _, _ = scatter_plain(z, pid, ok, rgb, semantic, height * width)
    winners = int((ok & (z <= zbuf[pid] * torch.tensor(
        WIN_FACTOR, device=z.device))).sum())
    n_valid = int(valid.sum())
    splat_bytes = (points.shape[0] + 12 * n_valid
                   + winners * (12 + (36 if sh is not None else 0) + 4))
    pixel_bytes = 21 * height * width
    return splat_bytes + pixel_bytes, dict(
        n_valid=n_valid, winners=winners, splat_bytes=splat_bytes,
        pixel_bytes=pixel_bytes)


def check_splat(points, rgb, sh, semantic, valid, intrinsics, T_CW, height,
                width, fill_passes=2, cell_size=0.0):
    """K8 against the plain version on the same CUDA inputs, by its rules:
    each splat lands on the plain version's pixel except where u or v lies
    within 2 ulp of k + 0.5 (`boundary`; those that differ are `flips`);
    a valid splat's z is bit-equal; fed K8's own pixels, the plain version
    gives the same depth, classes and splat_hit, and the same image except
    where splats tie in a pixel, there within the tie rule's tolerance
    (`_expected`). Returns a dict of counts and errors with 'ok'."""
    image, depth, classes, splat_hit, work = _splat_call(
        points, rgb, sh, semantic, valid, intrinsics, T_CW, height, width,
        fill_passes, cell_size)
    k, n = points.shape[0], height * width
    pid_k = work[:k].long()
    z_k = work[k:2 * k].view(torch.float32)
    z, u, v, pid, ok, shaded = project_plain(points, rgb, sh, valid,
                                             intrinsics, T_CW, height, width)
    pid_plain = torch.where(ok, pid, torch.full_like(pid, -1))
    boundary = ok & (near_half(u) | near_half(v))
    flips = pid_k != pid_plain
    ok_k = pid_k >= 0
    pid_fed = torch.where(ok_k, pid_k, torch.full_like(pid_k, n))
    want_image, want_depth, want_classes, want_hit, tol, cnt = _expected(
        z, pid_fed, ok_k, shaded, semantic, intrinsics, height, width,
        fill_passes, cell_size)
    err = (image - want_image).abs()
    result = dict(
        splats=k, in_frame=int(ok.sum()), boundary=int(boundary.sum()),
        flips=int(flips.sum()),
        flips_off_boundary=int((flips & ~boundary).sum()),
        z_equal=bool(torch.equal(z_k[valid], z[valid])),
        depth_equal=bool(torch.equal(depth, want_depth)),
        classes_equal=bool(torch.equal(classes, want_classes)),
        splat_hit_equal=bool(torch.equal(splat_hit, want_hit)),
        ties=int((cnt > 1).sum()), max_count=int(cnt.max()) if n else 0,
        max_abs_err=float(err.max()) if n else 0.0,
        image_within=bool((err <= tol).all()),
        image_equal_untied=bool(torch.equal(image[tol == 0],
                                            want_image[tol == 0])))
    result['ok'] = (result['flips_off_boundary'] == 0 and result['z_equal']
                    and result['depth_equal'] and result['classes_equal']
                    and result['splat_hit_equal'] and result['image_within']
                    and result['image_equal_untied'])
    return result
