"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs alone with
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import itertools

import numpy as np
import pytest
import torch

from autolabel_tpu_torch.ops import (_kernels, hashgrid_cuda, heads_cuda,
                                     splat_cuda)
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.ops.mlp import dot, mlp_init

pytestmark = pytest.mark.cuda

# bf16 operands on both sides; only the accumulation order differs, and
# one bf16 rounding flip of an intermediate moves an output by about 2^-8
# of its magnitude.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _points(rng, n, device, domain):
    """As in test_torch_port_encoders: the unit cube with its corners and
    faces, or points up to 0.05 outside it (negative cell coordinates,
    where dense indices must wrap floor-mod the level size and never read
    outside the table)."""
    if domain == 'outside':
        x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
        x[:3] = [[-1e-3, -1e-3, -1e-3], [-0.02, 0.5, 1.02],
                 [1.001, -0.3, 0.0]]
    else:
        x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5],
                 [1.0, 0.0, 0.999999]]
    return torch.tensor(x, device=device)


@pytest.mark.parametrize('domain', ['unit', 'outside'])
@pytest.mark.parametrize('variant,features', [('native', 128),
                                              ('tcnn', 2),
                                              ('torch_ngp', 8)])
def test_encode_kernel_matches_plain(cuda, variant, features, domain):
    rng = np.random.default_rng(0)
    config = HashGridConfig(n_levels=4, n_features=features,
                            log2_hashmap_size=12, base_resolution=8,
                            per_level_scale=1.6, variant=variant)
    assert any(s ** 3 <= size for s, size in zip(config.dense_strides,
                                                 config.level_sizes))
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, features)).astype(
        np.float32), device=cuda)
    x = _points(rng, 1000, cuda, domain)
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode(table, x, config)
    assert _kernels.launches[hashgrid_cuda.NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_plain(table, x, config)
    # Same products and sums in the same order and rounding.
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# The wide-row encode's points per block (8 warps x 4 points of a level).
ENCODE_TILE = 32


@pytest.mark.parametrize('n', [0, 1, ENCODE_TILE - 1, ENCODE_TILE + 1, 1000])
@pytest.mark.parametrize('variant,domain', [('native', 'unit'),
                                            ('tcnn', 'outside'),
                                            ('torch_ngp', 'unit'),
                                            ('torch_ngp', 'outside')])
def test_encode_kernel_wide_rows_match_plain(cuda, variant, domain, n):
    """F = 128 (the wide-row kernel) on every lattice: hashed and dense
    levels, level sizes that are not powers of two (tcnn, torch_ngp: the
    division-free modulo), ragged point counts and points outside [0, 1]
    (negative dense indices: the 32-bit floor-mod)."""
    rng = np.random.default_rng(7)
    config = HashGridConfig(n_levels=4, n_features=128,
                            log2_hashmap_size=12, base_resolution=8,
                            per_level_scale=1.6, variant=variant)
    if variant == 'torch_ngp':
        assert any(s & (s - 1) for s in config.level_sizes)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, 128)).astype(
        np.float32), device=cuda)
    x = _points(rng, max(n, 4), cuda, domain)[:n].contiguous()
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode(table, x, config)
    assert _kernels.launches[hashgrid_cuda.NAME] == 1
    assert got.shape == (n, 4 * 128)
    want = hashgrid_cuda.hashgrid_encode_plain(table, x, config)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# The narrow-row encode's threads a block (K1N_THREADS): 128 points at
# F = 2, 64 at F = 8.
NARROW_BLOCK = 128


@pytest.mark.parametrize('n', [0, 1, 31, 33, NARROW_BLOCK + 1, 1000])
@pytest.mark.parametrize('features', [1, 2, 3, 8])
@pytest.mark.parametrize('levels', [1, 5, 16])
def test_encode_kernel_narrow_rows_equal_plain(cuda, levels, features, n):
    """The narrow-row encode (a thread per point and slice of W = 2 or 1
    features walking a group of levels, the levels of a 32-byte sector by
    default: 4 at F = 2, 8 at F = 1, 2 at F = 3, 1 at F = 8) bit-equal to
    its plain version: group rows that are whole 16-byte pieces (F = 2: 32
    bytes a point and group) and rows that are not (F = 2 at 5 levels, the
    last group of one level; F = 1 at 5; F = 3, whose 3 slices a point do
    not divide a warp, so each thread stores its own), ragged point counts
    (a warp's last points, a block's), on the tcnn lattice with points
    outside [0, 1]."""
    rng = np.random.default_rng(levels * 100 + features)
    config = HashGridConfig(n_levels=levels, n_features=features,
                            log2_hashmap_size=12, base_resolution=8,
                            per_level_scale=1.6, variant='tcnn')
    table = torch.tensor(rng.uniform(-1, 1, (levels, 4096, features)).astype(
        np.float32), device=cuda)
    x = _points(rng, max(n, 4), cuda, 'outside')[:n].contiguous()
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode(table, x, config)
    assert _kernels.launches[hashgrid_cuda.NAME] == 1
    assert got.shape == (n, levels * features)
    # the same products and sums in the same order and rounding
    assert torch.equal(got, hashgrid_cuda.hashgrid_encode_plain(table, x,
                                                                config))


@pytest.mark.parametrize('features,levels,group', [
    (2, 16, 5), (2, 18, 0), (2, 16, 16), (8, 5, 2), (1, 16, 3), (3, 16, 7),
    (2, 16, 1)])
@pytest.mark.parametrize('n', [33, 1000])
def test_encode_kernel_narrow_level_groups_equal_plain(cuda, features, levels,
                                                       group, n):
    """Narrow rows walked in groups of levels (a grid row of blocks a
    group; the launcher's group, 0 for its own choice, 4 levels at F = 2,
    so 18 levels take groups of 4 and a last of 2): groups that do not
    divide L, group rows that are not whole 16-byte pieces (5 levels of
    F = 2), every level in one group and one level a group, bit-equal to
    the plain version."""
    rng = np.random.default_rng(group * 10 + levels)
    config = HashGridConfig(n_levels=levels, n_features=features,
                            log2_hashmap_size=12, base_resolution=4,
                            per_level_scale=1.3, variant='torch_ngp')
    table = torch.tensor(rng.uniform(-1, 1, (levels, 4096, features)).astype(
        np.float32), device=cuda)
    x = _points(rng, n, cuda, 'outside')
    _kernels.reset_launches()
    got = hashgrid_cuda._launch(table, x, config, group=group)
    assert _kernels.launches[hashgrid_cuda.NAME] == 1
    assert torch.equal(got, hashgrid_cuda.hashgrid_encode_plain(table, x,
                                                                config))


def test_encode_launch_shapes_narrow_rows(cuda):
    """The narrow kernel's plan at the reference preset: 128 threads a
    block, 8 blocks an SM at no more than 64 registers, 4 levels walked by
    a thread (a grid row of blocks for each of the 4 groups), a warp
    storing 32 points' rows, each point's 8 floats of a group staged with
    4 more."""
    config = HashGridConfig(variant='tcnn')
    shape = hashgrid_cuda.encode_launch_shapes(config, 524288)
    lanes = shape['encode_lanes_kernel']
    assert lanes['threads'] == NARROW_BLOCK
    assert lanes['blocks'] == 524288 // NARROW_BLOCK * 4
    assert lanes['levels_per_thread'] == 4
    assert lanes['points_per_warp'] == 32
    assert lanes['smem_bytes'] == NARROW_BLOCK * (8 + 4) * 4
    assert lanes['registers'] <= 64 and lanes['blocks_per_sm'] >= 8


def test_encode_kernel_rejects_bad_inputs(cuda):
    config = HashGridConfig(n_levels=2, n_features=8, log2_hashmap_size=8)
    table = torch.zeros((2, 256, 8), device=cuda)
    with pytest.raises(ValueError):
        hashgrid_cuda.hashgrid_encode(table, torch.zeros((4, 2),
                                                         device=cuda), config)
    with pytest.raises(ValueError):
        hashgrid_cuda.hashgrid_encode(table.double(), torch.zeros(
            (4, 3), device=cuda, dtype=torch.float64), config)


def _head_params(generator, device, semantic=64, classes=6):
    params = {
        'sigma_net': mlp_init(generator, 12 + 128, 64, 16, 2),
        'color_net': mlp_init(generator, 16 + 15, 64, 3, 2),
        'semantic_features': mlp_init(generator, 15, semantic, semantic, 2),
        'semantic_out': mlp_init(generator, semantic + 15, 64, classes, 1),
        'proposal': mlp_init(generator, 36, 64, 1, 2),
    }
    return {k: [w.to(device) for w in v] for k, v in params.items()}


# The head kernels' tiles of points at the flagship widths: K3f's and
# K3b's.
FWD_TILE = 128
BWD_TILE = 64


@pytest.mark.parametrize('classes,n,weight_dtype,semantic', [
    (6, 1000, torch.float32, 64), (2, 333, torch.bfloat16, 64),
    (6, 0, torch.bfloat16, 64), (6, 1, torch.bfloat16, 64),
    (6, FWD_TILE - 1, torch.bfloat16, 64),
    (6, FWD_TILE + 1, torch.bfloat16, 64),
    (6, 5000, torch.bfloat16, 64), (6, 300, torch.bfloat16, 512)])
def test_head_kernels_match_plain(cuda, classes, n, weight_dtype, semantic):
    """fp32 weights are cast by the wrapper; bf16 ones (packed and cast
    once, as Field does) go to the kernel as they are. n = 333, 1, 127
    and 129 leave a partial tile of points, 0 none; 5000 points are fewer than
    one tile per SM; semantic 512 takes the widest feature head the field
    admits (four 128-column passes a layer)."""
    g = torch.Generator().manual_seed(1)
    params = _head_params(g, cuda, semantic=semantic, classes=classes)
    A = torch.randn((n, 128), generator=g).to(cuda) * 0.5
    B = torch.zeros((n, 32), device=cuda)
    B[:, :12] = torch.rand((n, 12), generator=g).to(cuda) * 2 - 1
    B[:, 16:32] = torch.randn((n, 16), generator=g).to(cuda) * 0.3
    packed = [w.to(weight_dtype)
              for w in heads_cuda.pack_head_weights(params, 12)]
    _kernels.reset_launches()
    got = heads_cuda.fused_heads(packed, A, B)
    assert _kernels.launches[heads_cuda.HEADS] == 1
    want = heads_cuda.fused_heads_plain(packed, A, B, torch.bfloat16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **BF16_TOL)
    packed3 = [w.to(weight_dtype)
               for w in heads_cuda.pack_mlp3(params['proposal'])]
    X = torch.rand((n, 36), generator=g).to(cuda)
    got3 = heads_cuda.fused_mlp3(packed3, X)
    assert _kernels.launches[heads_cuda.MLP3] == 1
    torch.testing.assert_close(
        got3, heads_cuda.fused_mlp3_plain(packed3, X, torch.bfloat16),
        **BF16_TOL)


# The proposal MLP kernel's points per warp tile, and per block round.
MLP3_TILE = 16
MLP3_BLOCK = 128


@pytest.mark.parametrize('hidden,d_in,d_out,n,weight_dtype', [
    (64, 36, 1, 0, torch.bfloat16), (64, 36, 1, 1, torch.bfloat16),
    (64, 36, 1, MLP3_TILE - 1, torch.bfloat16),
    (64, 36, 1, MLP3_TILE + 1, torch.float32),
    (64, 36, 1, MLP3_BLOCK - 1, torch.bfloat16),
    (64, 36, 1, MLP3_BLOCK + 1, torch.float32),
    (64, 36, 1, 5000, torch.float32), (128, 36, 1, 1000, torch.bfloat16),
    (128, 36, 1, 5000, torch.float32), (256, 36, 1, 1000, torch.bfloat16),
    (256, 36, 1, MLP3_BLOCK + 1, torch.float32),
    (64, 100, 80, 1000, torch.bfloat16), (32, 37, 16, 333, torch.float32)])
def test_mlp3_kernel_matches_plain(cuda, hidden, d_in, d_out, n,
                                   weight_dtype):
    """K4f against its plain version in bf16: ragged n around the warp's
    and the block's tiles, hidden widths 64 to 256 (the registers' A
    fragments), d_out 80 (two output passes), and X rows of 37 floats
    (not 16-byte copies)."""
    g = torch.Generator().manual_seed(8)
    packed = [w.to(cuda).to(weight_dtype) for w in heads_cuda.pack_mlp3(
        mlp_init(g, d_in, hidden, d_out, 2))]
    X = (torch.rand((n, d_in), generator=g) * 2 - 1).to(cuda)
    _kernels.reset_launches()
    got = heads_cuda.fused_mlp3(packed, X)
    assert _kernels.launches[heads_cuda.MLP3] == 1
    want = heads_cuda.fused_mlp3_plain(packed, X, torch.bfloat16)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **BF16_TOL)


@pytest.mark.parametrize('d_in,hidden', [(36, 512), (512, 256)])
def test_mlp3_kernel_refuses_widths_beyond_shared_memory(cuda, d_in, hidden):
    """A hidden layer wider than 256, or weights and X stages beyond the
    card's shared memory per block, raise ValueError; nothing launches."""
    g = torch.Generator().manual_seed(9)
    packed = [w.to(cuda) for w in heads_cuda.pack_mlp3(
        mlp_init(g, d_in, hidden, 1, 2))]
    X = torch.zeros((10, d_in), device=cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match='shared memory|at most 256'):
        heads_cuda.fused_mlp3(packed, X)
    assert _kernels.launches[heads_cuda.MLP3] == 0


def test_head_kernel_covers_a_256_wide_semantic_head(cuda):
    """--feature-dim 256: the feature head's layers span two 128-column
    tiles; the forward kernel matches its plain version there."""
    g = torch.Generator().manual_seed(2)
    params = _head_params(g, cuda, semantic=256)
    n = 300
    A = torch.randn((n, 128), generator=g).to(cuda) * 0.5
    B = torch.zeros((n, 32), device=cuda)
    B[:, :12] = torch.rand((n, 12), generator=g).to(cuda) * 2 - 1
    B[:, 16:32] = torch.randn((n, 16), generator=g).to(cuda) * 0.3
    packed = [w.to(torch.bfloat16)
              for w in heads_cuda.pack_head_weights(params, 12)]
    assert packed[10].shape == (256, 256)
    _kernels.reset_launches()
    got = heads_cuda.fused_heads(packed, A, B)
    assert _kernels.launches[heads_cuda.HEADS] == 1
    want = heads_cuda.fused_heads_plain(packed, A, B, torch.bfloat16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **BF16_TOL)


def test_head_kernel_rejects_widths_off_its_tile(cuda):
    """A layer width that is not a multiple of 16 is refused."""
    g = torch.Generator().manual_seed(2)
    packed = list(heads_cuda.pack_head_weights(_head_params(g, cuda), 12))
    packed[13] = torch.zeros((packed[13].shape[0], 24), device=cuda)
    A = torch.zeros((16, 128), device=cuda)
    B = torch.zeros((16, 32), device=cuda)
    with pytest.raises(ValueError):
        heads_cuda.fused_heads(packed, A, B)


def _rel_err(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-12))


def _relu_margins(ws, A, B, acts):
    """Each ReLU mask of the head stack, keyed by its activation's index in
    _forward_blocks' tuple acts: |pre-activation| over the sum of its
    terms' magnitudes, per point and unit, from bf16 operands as the
    kernels' (inf where the unit is padding)."""
    (WA, WBs, W1s, W2s, WBc, WSc, W1c, W2c, WSf, W1f, W2f, WFo, WSo,
     W1o) = ws
    h1s, h2s, S, c1, c2, R, f1, f2, F, o1, L = acts
    terms = {0: ((A, WA), (B, WBs)), 1: ((h1s, W1s),),
             3: ((B, WBc), (S, WSc)), 4: ((c1, W1c),), 6: ((S, WSf),),
             7: ((f1, W1f),), 8: ((f2, W2f),),
             9: ((torch.relu(F), WFo), (S, WSo))}
    margins = {}
    for i, pairs in terms.items():
        pre = sum(dot(x, w, torch.bfloat16) for x, w in pairs)
        mag = sum(dot(x.abs(), w.abs(), torch.bfloat16) for x, w in pairs)
        margins[i] = torch.where(mag > 0, pre.abs() / mag, float('inf'))
    return margins


def _flipped(acts, p, units):
    """Point p's activations with the ReLU masks of units ((index in acts,
    column) pairs) inverted: a unit at 0 made 1e-30, a positive one 0 (F,
    read through relu(F), made -1e-30)."""
    acts = [a[p:p + 1].clone() for a in acts]
    for i, j in units:
        on = bool(acts[i][0, j] > 0)
        acts[i][0, j] = (-1e-30 if i == 8 else 0.0) if on else 1e-30
    return acts


def _check_point_gradients(got, ws, A, B, cots):
    """K3b's per-point gradients got ({0: dA, 1: dB}, those asked for)
    against the bf16 plain version, element by element within 2e-2 of the
    largest magnitude. Both round to bf16 at the same places but sum in
    another order, which can round a pre-activation at 0 to either side
    and flip its ReLU mask: that point's cotangents then differ by their
    own size. So a point off is taken only where inverting some of its
    masks whose pre-activation lies within bf16 rounding of 0 (under 2^-8
    of its terms' magnitudes; any subset of the eight nearest) makes the
    plain version agree with the kernel at that point, element by
    element."""
    A = heads_cuda._pad_cols(A, ws[0].shape[0])
    B = heads_cuda._pad_cols(B, ws[1].shape[0])
    acts = heads_cuda._forward_blocks(ws, A, B, torch.bfloat16)
    want = heads_cuda._backward_blocks(ws, A, B, acts, *cots,
                                       torch.bfloat16)[:2]
    atol = {k: 2e-2 * float(want[k].abs().max()) for k in got}

    def off(k, g, w):
        return ((g - w[:, :g.shape[1]]).abs() > atol[k]).any(1)

    bad = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    for k, g in got.items():
        bad |= off(k, g, want[k])
    margins = None
    for p in bad.nonzero().flatten().tolist():
        if margins is None:
            margins = _relu_margins(ws, A, B, acts)
        near = sorted((float(m[p, j]), i, j) for i, m in margins.items()
                      for j in (m[p] < 2 ** -8).nonzero().flatten().tolist())
        near = [(i, j) for _, i, j in near[:8]]
        tries = [units for k in range(1, len(near) + 1)
                 for units in itertools.combinations(near, k)]

        def explains(units):
            flip = heads_cuda._backward_blocks(
                ws, A[p:p + 1], B[p:p + 1], _flipped(acts, p, units),
                *[c[p:p + 1] for c in cots], torch.bfloat16)
            return not any(bool(off(k, g[p:p + 1], flip[k]).any())
                           for k, g in got.items())

        found = next((units for units in tries if explains(units)), None)
        assert found is not None, (
            f'point {p} of {A.shape[0]} is off, and no ReLU mask near 0 '
            f'accounts for it (nearest: {near})')
        print(f'point {p} of {A.shape[0]} off: masks inverted at '
              + ', '.join(f'(activation {i}, unit {j}, margin '
                          f'{float(margins[i][p, j]):.2e})'
                          for i, j in found))


@pytest.mark.parametrize('variant,features,domain', [
    ('native', 128, 'unit'), ('native', 128, 'outside'), ('tcnn', 2, 'unit'),
    ('torch_ngp', 8, 'outside')])
def test_encode_backward_kernel_matches_plain(cuda, variant, features,
                                              domain):
    """K2, the table gradient, through autograd of the encode. Atomic adds
    in another order than index_add_'s: fp32 rounding of each row's sum."""
    rng = np.random.default_rng(5)
    config = HashGridConfig(n_levels=4, n_features=features,
                            log2_hashmap_size=12, base_resolution=8,
                            per_level_scale=1.6, variant=variant)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, features)).astype(
        np.float32), device=cuda, requires_grad=True)
    x = _points(rng, 2000, cuda, domain)
    g = torch.tensor(rng.normal(size=(2000, 4 * features)).astype(
        np.float32), device=cuda)
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, x, config)
    (got,) = torch.autograd.grad(out, table, g)
    assert _kernels.launches[hashgrid_cuda.BWD_NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    _assert_within_sum_orders(got, want, g, x, config)


def _assert_within_sum_orders(got, want, g, x, config):
    """K2 against its plain version: the same fp32 products summed in
    another order (atomics and in-tile groups against index_add_'s), so
    each element within hashgrid_cuda.backward_tolerance (2 k 2^-24 of
    its terms' magnitudes, k its row's terms)."""
    assert got.shape == want.shape
    tol = hashgrid_cuda.backward_tolerance(g, x, config)
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), (
        f'max excess {float((err - tol).max()):.3e}, max err '
        f'{float(err.max()):.3e}')


# K2's points per tile of one level (wide rows).
K2_TILE = 32


def _fine_grid(variant, features):
    """TPU_GRID's resolutions (16, 80, 406, 2048) on a 2^12 table: dense
    and hashed levels, cells from coarse to finer than the points' spread
    in a tile."""
    return HashGridConfig(n_levels=4, n_features=features,
                          log2_hashmap_size=12, base_resolution=16,
                          per_level_scale=5.04, variant=variant)


def _clustered(rng, n, kind, device):
    """All points inside one cell of every level ('one_cell'), or the
    samples of a few rays in ray order ('rays', 32 a ray, as a training
    step's main samples come)."""
    if kind == 'one_cell':
        x = 0.4321 + rng.uniform(0.0, 1e-5, (n, 3))
    else:
        rays = -(-n // 32)
        o = rng.uniform(0.1, 0.9, (rays, 1, 3))
        d = rng.normal(size=(rays, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 0.3, (rays, 32, 1)), axis=1)
        x = np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3)[:n]
    return torch.tensor(x.astype(np.float32), device=device)


@pytest.mark.parametrize('kind', ['one_cell', 'rays'])
@pytest.mark.parametrize('variant,features', [
    ('native', 128), ('tcnn', 128), ('torch_ngp', 128), ('native', 2),
    ('tcnn', 2), ('torch_ngp', 2)])
def test_encode_backward_kernel_on_clustered_points(cuda, variant, features,
                                                   kind):
    """K2 where a tile's updates share rows: every point in one cell (each
    corner's row a group of 32 entries in each of 64 tiles, and every
    tile's atomics into the same 8 rows a level) or ray-ordered
    samples."""
    rng = np.random.default_rng(13)
    config = _fine_grid(variant, features)
    n = 2048
    x = _clustered(rng, n, kind, cuda)
    g = torch.tensor(rng.normal(size=(n, config.out_dim)).astype(
        np.float32), device=cuda)
    if features == 128:
        shape = hashgrid_cuda.encode_backward_launch_shapes(config, n)
        assert shape['scatter_rows_kernel']['points_per_tile'] == K2_TILE
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode_backward(g, x, config)
    assert _kernels.launches[hashgrid_cuda.BWD_NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    _assert_within_sum_orders(got, want, g, x, config)


@pytest.mark.parametrize('n', [0, 1, K2_TILE - 1, K2_TILE + 1, 5000])
@pytest.mark.parametrize('variant,features,domain', [
    ('native', 128, 'unit'), ('torch_ngp', 128, 'outside'),
    ('tcnn', 2, 'unit')])
def test_encode_backward_kernel_ragged_tiles(cuda, variant, features, domain,
                                            n):
    """K2 on point counts around its tile (a partial tile, one point, none)
    and over many tiles, on dense and hashed levels."""
    rng = np.random.default_rng(14)
    config = _fine_grid(variant, features)
    x = _points(rng, max(n, 4), cuda, domain)[:n].contiguous()
    g = torch.tensor(rng.normal(size=(n, config.out_dim)).astype(
        np.float32), device=cuda)
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode_backward(g, x, config)
    assert _kernels.launches[hashgrid_cuda.BWD_NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    if n == 0:
        assert not bool(got.any())
    _assert_within_sum_orders(got, want, g, x, config)


# K2's narrow rows (scatter_group_kernel): a thread per (point, slice of W
# = 4, 2 or 1 features), K2N_THREADS a block, walking the levels whose
# slices of g fill a 32-byte sector; corners' atomics merged within the
# warp.
K2N_THREADS = 128


def _narrow_grid(variant, features, levels=6):
    """Dense levels (4, 8 and 16 cells a side; torch_ngp's sizes not
    powers of two) and hashed ones on a 2^12 table."""
    return HashGridConfig(n_levels=levels, n_features=features,
                          log2_hashmap_size=12, base_resolution=4,
                          per_level_scale=2.0, variant=variant)


def _scatter_holds(config, x, seed):
    g = torch.tensor(np.random.default_rng(seed).normal(
        size=(x.shape[0], config.out_dim)).astype(np.float32),
        device=x.device)
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode_backward(g, x, config)
    assert _kernels.launches[hashgrid_cuda.BWD_NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_backward_plain(g, x, config)
    if x.shape[0] == 0:
        assert not bool(got.any())
    _assert_within_sum_orders(got, want, g, x, config)


@pytest.mark.parametrize('domain', ['unit', 'outside'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('features', [1, 2, 3, 4, 8, 16, 24])
def test_encode_backward_narrow_rows_widths(cuda, features, variant, domain):
    """Every narrow width: W = 1 (F = 1, 3: x-neighbour pairs as one
    float2 at F = 1), W = 2 (F = 2: pairs as one float4), W = 4 (F = 4,
    8, 16, 24: a float4 a slice), points in and up to 0.05 outside [0, 1]
    (negative dense indices wrap floor-mod the level size)."""
    rng = np.random.default_rng(features)
    _scatter_holds(_narrow_grid(variant, features),
                   _points(rng, 1000, cuda, domain), 51)


@pytest.mark.parametrize('n', [0, 1, 31, 32, 33, K2N_THREADS - 1,
                               K2N_THREADS, K2N_THREADS + 1, 255, 257, 4099])
@pytest.mark.parametrize('features', [1, 2, 3, 8])
def test_encode_backward_narrow_rows_ragged(cuda, features, n):
    """Point counts at and around a warp's and a block's points (F = 3:
    3 threads a point, a warp ending inside a point), none and one."""
    rng = np.random.default_rng(n + 7)
    x = _points(rng, max(n, 4), cuda, 'outside')[:n].contiguous()
    _scatter_holds(_narrow_grid('tcnn', features, levels=5), x, 52)


@pytest.mark.parametrize('kind', ['one_cell', 'rays'])
@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('features', [1, 2, 4])
def test_encode_backward_narrow_rows_clustered(cuda, features, variant, kind):
    """Same-address traffic: every point in one cell (each round of a warp
    on one target, merged to one atomic) and ray-ordered samples."""
    rng = np.random.default_rng(17)
    _scatter_holds(_narrow_grid(variant, features),
                   _clustered(rng, 3000, kind, cuda), 53)


@pytest.mark.parametrize('features', [4097, 4100])
def test_encode_backward_narrow_rows_beyond_the_wide_kernel(cuda, features):
    """F beyond the wide kernel's staged g (4,096 floats): a multiple of 4
    (float4 slices) and an odd width (a thread a feature)."""
    rng = np.random.default_rng(features)
    config = HashGridConfig(n_levels=2, n_features=features,
                            log2_hashmap_size=6, base_resolution=2,
                            per_level_scale=2.0, variant='tcnn')
    _scatter_holds(config, _points(rng, 37, cuda, 'outside'), 54)


@pytest.mark.parametrize('kind', ['uniform', 'rays'])
def test_encode_backward_narrow_rows_tcnn_lattice(cuda, kind):
    """The full tcnn lattice (16 x 2^19 x 2: three dense levels, 13
    hashed) at N = 65,536."""
    rng = np.random.default_rng(19)
    x = (_points(rng, 65536, cuda, 'unit') if kind == 'uniform'
         else _clustered(rng, 65536, 'rays', cuda))
    _scatter_holds(HashGridConfig(variant='tcnn'), x, 55)


@pytest.mark.parametrize('variant', ['native', 'tcnn', 'torch_ngp'])
@pytest.mark.parametrize('kind', ['uniform', 'rays'])
def test_encode_backward_narrow_rows_reference_lattices(cuda, kind, variant):
    """The reference presets' lattices at the CLI's N = 524,288."""
    rng = np.random.default_rng(20)
    config = (HashGridConfig.from_desired_resolution(
        2 ** 18, variant='torch_ngp') if variant == 'torch_ngp'
        else HashGridConfig(variant=variant))
    x = (_points(rng, 524288, cuda, 'unit') if kind == 'uniform'
         else _clustered(rng, 524288, 'rays', cuda))
    _scatter_holds(config, x, 56)


def test_encode_backward_launch_shapes_narrow_rows(cuda):
    """The narrow kernel's plan: 128 threads a block at most 64 registers
    (8 blocks an SM), level groups of one 32-byte sector of g (4 at F =
    2, 8 at F = 1, 2 at F = 3 and 4, 1 from F = 5 on), groups slowest."""
    n = 1000
    for features, slices, group in ((2, 1, 4), (1, 1, 8), (3, 3, 2),
                                    (4, 1, 2), (8, 2, 1), (24, 6, 1)):
        config = HashGridConfig(n_features=features, variant='tcnn')
        (name, shape), = hashgrid_cuda.encode_backward_launch_shapes(
            config, n).items()
        assert name == 'scatter_group_kernel'
        assert shape['threads'] == K2N_THREADS
        assert shape['registers'] <= 64 and shape['blocks_per_sm'] >= 8
        assert shape['levels_per_thread'] == group
        assert shape['points_per_tile'] == (32 // slices if 32 % slices == 0
                                            else 0)
        assert shape['blocks'] == (-(-n * slices // K2N_THREADS)
                                   * -(-16 // group))


# K2x, the encode's gradient for the points, in each form: (interp,
# features, variant, the stochastic plan's (n_samples, residual,
# exact_levels) or None for the exact encode)
POINT_GRAD_FORMS = [
    ('trilinear', 128, 'native', None), ('trilinear', 8, 'torch_ngp', None),
    ('trilinear', 2, 'tcnn', None), ('simplex', 128, 'native', None),
    ('simplex', 8, 'native', None), ('trilinear', 128, 'native', (2, False, 1)),
    ('simplex', 128, 'native', (2, False, 1)),
    ('trilinear', 2, 'tcnn', (3, False, 1)),
    ('trilinear', 128, 'native', (2, True, 1)),
    ('simplex', 128, 'native', (2, True, 0))]


@pytest.mark.parametrize('n', [1, 9, 2000])
@pytest.mark.parametrize('interp,features,variant,stochastic',
                         POINT_GRAD_FORMS)
@pytest.mark.parametrize('frozen', [False, True])
def test_point_grad_kernel_matches_plain(cuda, interp, features, variant,
                                         stochastic, n, frozen):
    """K2x through each encode's autograd Function (K1, K1s or K6 forward),
    points on corners, faces and tied fractions: the gradient for x within
    point_grad_tolerance of the plain version fed the same rows, launched
    once; with the table frozen (registration) the Function still records
    and launches no table scatter, with it the scatter too."""
    rng = np.random.default_rng(n)
    config = _flagship_grid(features, variant)
    x = _tie_points(rng, n, cuda)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, features)).astype(
        np.float32), device=cuda, requires_grad=not frozen)
    g = torch.tensor(rng.normal(size=(n, config.out_dim)).astype(np.float32),
                     device=cuda)
    kw, plan, rows = {}, None, None
    if stochastic is not None:
        n_samples, residual, exact = stochastic
        u = torch.tensor(rng.random(hashgrid_cuda.encoders.uniform_shape(
            4, n, interp, n_samples, residual)).astype(np.float32),
            device=cuda)
        kw = dict(u=u, n_samples=n_samples, residual=residual,
                  exact_levels=exact)
        plan = hashgrid_cuda.encoders.stochastic_plan(
            config, interp, n_samples, exact, residual)
        rows = hashgrid_cuda.stochastic_encode_plain(
            table.detach(), x, u, config, interp, n_samples, plan)[1]
    xr = x.clone().requires_grad_(True)
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, xr, config, interp=interp,
                                        **kw)
    inputs = (xr,) if frozen else (xr, table)
    got = torch.autograd.grad(out, inputs, g)[0]
    torch.cuda.synchronize()
    assert _kernels.launches[hashgrid_cuda.POINT_GRAD_NAME] == 1
    scatters = sum(_kernels.launches[k] for k in (
        hashgrid_cuda.BWD_NAME, hashgrid_cuda.SAMPLED_BWD_NAME,
        hashgrid_cuda.STOCHASTIC_BWD_NAME))
    assert scatters == (0 if frozen else 1)
    args = (g, table.detach(), x, config, interp, plan, rows)
    want = hashgrid_cuda.hashgrid_encode_point_grad_plain(*args)
    tol = hashgrid_cuda.encoders.point_grad_tolerance(*args)
    assert bool(((got - want).abs() <= tol).all()), \
        float(((got - want).abs() / tol.clamp(min=1e-30)).max())


def test_point_grad_launch_shapes(cuda):
    """Wide rows launch the level kernel (a block of 4 warps of 32 / A
    points of one level, a level's blocks for each level that carries a
    gradient) and the level sum; narrow rows one kernel, a thread a
    point."""
    for features, want in ((128, ('point_grad_levels_kernel',
                                  'level_sum_kernel')),
                           (2, ('point_grad_points_kernel',))):
        config = HashGridConfig(n_features=features)
        shapes = hashgrid_cuda.point_grad_launch_shape(config, 131072,
                                                       'simplex')
        assert len(shapes) == len(want)
        for (name, shape), kernel in zip(shapes.items(), want):
            assert kernel in name and shape['blocks'] > 0
    plan = ((hashgrid_cuda.encoders.DRAWS, 2),) * 2 + (
        (hashgrid_cuda.encoders.EXACT, 4),) * 2
    shape = hashgrid_cuda.point_grad_launch_shape(
        HashGridConfig(n_levels=4, n_features=128), 131072, 'simplex', plan)
    assert shape['K2x point_grad_levels_kernel<4>']['blocks'] == \
        2 * 131072 // 32


def _point_grad_case(rng, n, config, interp, plan, device):
    """(g, table, x, config, interp, plan, rows) for K2x: _tie_points, a
    U(-1, 1) table, a N(0, 1) cotangent; a plan's rows from the plain
    stochastic encode, an exact simplex encode's from the plain atoms."""
    encoders = hashgrid_cuda.encoders
    x = _tie_points(rng, n, device)
    table = torch.tensor(rng.uniform(-1, 1, (
        config.n_levels, config.table_size, config.n_features)).astype(
            np.float32), device=device)
    g = torch.tensor(rng.normal(size=(n, config.out_dim)).astype(
        np.float32), device=device)
    rows = None
    if plan is not None:
        u = torch.tensor(rng.random(encoders.uniform_shape(
            config.n_levels, n, interp, 2)).astype(np.float32),
            device=device)
        rows = hashgrid_cuda.stochastic_encode_plain(
            table, x, u, config, interp, 2, plan)[1]
    elif interp == 'simplex':
        idx, _ = encoders._corner_idx_weights(x, config, 'simplex')
        rows = idx.reshape(-1, n).to(torch.int32).contiguous()
        plan = ((encoders.EXACT, 4),) * config.n_levels
    return g, table, x, config, interp, plan, rows


def _assert_point_grad(args):
    """K2x launched once, within point_grad_tolerance of the plain version
    fed the same rows."""
    _kernels.reset_launches()
    got = hashgrid_cuda.point_grad(*args)
    torch.cuda.synchronize()
    assert _kernels.launches[hashgrid_cuda.POINT_GRAD_NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_point_grad_plain(*args)
    tol = hashgrid_cuda.encoders.point_grad_tolerance(*args)
    assert bool(((got - want).abs() <= tol).all()), \
        float(((got - want).abs() / tol.clamp(min=1e-30)).max())
    return got


# Point counts around K2x's tiles: P = 32 / A points a warp and 4 P a block
# on wide rows (simplex 8 and 32, trilinear 4 and 16); 32 a warp and 128 a
# block on narrow rows.
POINT_GRAD_EDGES = [
    ('simplex', 128, n) for n in (7, 8, 9, 31, 33)] + [
    ('trilinear', 128, n) for n in (3, 4, 5, 15, 17)] + [
    ('trilinear', 2, n) for n in (31, 32, 33, 127, 129)]


@pytest.mark.parametrize('interp,features,n', POINT_GRAD_EDGES)
def test_point_grad_tile_edges(cuda, interp, features, n):
    """K2x at point counts one below, at and one above a warp's and a
    block's points: every point within point_grad_tolerance."""
    rng = np.random.default_rng(n)
    config = _flagship_grid(features, 'tcnn' if features == 2 else 'native')
    _assert_point_grad(_point_grad_case(rng, n, config, interp, None, cuda))


@pytest.mark.parametrize('interp,features', [
    ('trilinear', 4), ('simplex', 32), ('trilinear', 32),
    ('simplex', 512), ('trilinear', 512)])
def test_point_grad_feature_edges(cuda, interp, features):
    """F = 4 (narrow rows), 32 and 512 (the ends of the wide rows): within
    point_grad_tolerance."""
    rng = np.random.default_rng(features)
    config = _flagship_grid(features)
    _assert_point_grad(_point_grad_case(rng, 300, config, interp, None,
                                        cuda))


@pytest.mark.parametrize('interp,features', [
    ('trilinear', 128), ('simplex', 128), ('trilinear', 2)])
def test_point_grad_draws_at_both_ends(cuda, interp, features):
    """A plan whose first and last levels are DRAWS (no gradient, no
    partial of theirs): the two exact levels between within
    point_grad_tolerance."""
    encoders = hashgrid_cuda.encoders
    rng = np.random.default_rng(3)
    a = 4 if interp == 'simplex' else 8
    plan = ((encoders.DRAWS, 2), (encoders.EXACT, a), (encoders.EXACT, a),
            (encoders.DRAWS, 2))
    config = _flagship_grid(features, 'tcnn' if features == 2 else 'native')
    _assert_point_grad(_point_grad_case(rng, 1000, config, interp, plan,
                                        cuda))


@pytest.mark.parametrize('interp,features,variant,stochastic',
                         POINT_GRAD_FORMS)
def test_point_grad_bit_equal_across_calls(cuda, interp, features, variant,
                                           stochastic):
    """Two K2x calls on the same inputs give the same bits: no atomics,
    the levels summed in one order."""
    encoders = hashgrid_cuda.encoders
    rng = np.random.default_rng(5)
    config = _flagship_grid(features, variant)
    plan = None
    if stochastic is not None:
        n_samples, residual, exact = stochastic
        plan = encoders.stochastic_plan(config, interp, n_samples, exact,
                                        residual)
    if plan is not None and (residual or n_samples != 2):
        x = _tie_points(rng, 3000, cuda)
        table = torch.tensor(rng.uniform(-1, 1, (4, 4096, features)).astype(
            np.float32), device=cuda)
        g = torch.tensor(rng.normal(size=(3000, config.out_dim)).astype(
            np.float32), device=cuda)
        u = torch.tensor(rng.random(encoders.uniform_shape(
            4, 3000, interp, n_samples, residual)).astype(np.float32),
            device=cuda)
        rows = hashgrid_cuda.stochastic_encode_plain(
            table, x, u, config, interp, n_samples, plan)[1]
        args = (g, table, x, config, interp, plan, rows)
    else:
        args = _point_grad_case(rng, 3000, config, interp, plan, cuda)
    first = _assert_point_grad(args)
    assert torch.equal(first, hashgrid_cuda.point_grad(*args))


def _head_inputs(g, n, device):
    A = (torch.randn((n, 128), generator=g) * 0.5).to(device)
    B = torch.zeros((n, 32), device=device)
    B[:, :12] = torch.rand((n, 12), generator=g).to(device) * 2 - 1
    B[:, 16:32] = torch.randn((n, 16), generator=g).to(device) * 0.3
    return A, B


@pytest.mark.parametrize('semantic,n,need_dA,need_dB', [
    (64, 1000, True, True), (256, 333, True, True), (64, 0, True, True),
    (64, 1, True, True), (64, BWD_TILE - 1, True, True),
    (64, BWD_TILE + 1, True, True), (64, 5000, True, True),
    (512, 200, True, True), (64, 1000, True, False),
    (64, 1000, False, True), (64, 1000, False, False)])
def test_head_backward_kernel_matches_plain(cuda, semantic, n, need_dA,
                                            need_dB):
    """K3b through autograd of the head stack, on fp32 packed weights
    (cast to bf16 inside; fp32 weight gradients come back), against the
    plain backward with the same bf16 operands: dA and dB per element as
    _check_point_gradients holds them; each summed dW within 1e-2 of its
    norm. need_dA or need_dB False: that input takes no gradient (the
    kernel leaves dB out; dA it computes all the same)."""
    g = torch.Generator().manual_seed(3)
    params = _head_params(g, cuda, semantic=semantic)
    A, B = _head_inputs(g, n, cuda)
    A.requires_grad_(need_dA)
    B.requires_grad_(need_dB)
    packed = [w.requires_grad_(True)
              for w in heads_cuda.pack_head_weights(params, 12)]
    inputs = [A] * need_dA + [B] * need_dB + packed
    _kernels.reset_launches()
    outs = heads_cuda.fused_heads(packed, A, B)
    cot = [torch.randn(o.shape, generator=g).to(cuda) for o in outs]
    got = torch.autograd.grad(outs, inputs, cot)
    assert _kernels.launches[heads_cuda.HEADS_BWD] == 1
    assert all(d.dtype == torch.float32 for d in got)
    bf = [w.detach().to(torch.bfloat16) for w in packed]
    dA, dB, dws = heads_cuda.fused_heads_backward_plain(
        bf, A.detach(), B.detach(), *cot, compute_dtype=torch.bfloat16)
    points = dict(zip([k for k, need in ((0, need_dA), (1, need_dB))
                       if need], got))
    for k, a in points.items():
        assert a.shape == (dA, dB)[k].shape
    if n:
        _check_point_gradients(points, bf, A.detach(), B.detach(), cot)
    for a, b in zip(got[len(points):], dws):
        assert a.shape == b.shape
        assert _rel_err(a, b) < 1e-2


def test_head_backward_weight_gradients_are_deterministic(cuda):
    """Two K3b launches on the same inputs give bit-equal weight gradients
    (split-K partials summed in a fixed order; no float atomics)."""
    g = torch.Generator().manual_seed(6)
    params = _head_params(g, cuda)
    n = 20000
    A, B = _head_inputs(g, n, cuda)
    packed = [w.to(torch.bfloat16)
              for w in heads_cuda.pack_head_weights(params, 12)]
    cot = [torch.randn((n, w), generator=g).to(cuda)
           for w in (packed[7].shape[1], packed[10].shape[1],
                     packed[13].shape[1])]
    _, _, first = heads_cuda.fused_heads_backward(packed, A, B, *cot)
    _, _, second = heads_cuda.fused_heads_backward(packed, A, B, *cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K4b's points per warp tile, and per block step (8 warps).
MLP3_BWD_STEP = 128


@pytest.mark.parametrize('hidden,d_in,d_out,n,need_dX', [
    (64, 36, 1, 1000, True), (64, 36, 1, 0, True), (64, 36, 1, 1, False),
    (64, 36, 1, MLP3_TILE - 1, True), (64, 36, 1, MLP3_TILE + 1, False),
    (64, 36, 1, MLP3_BWD_STEP - 1, True),
    (64, 36, 1, MLP3_BWD_STEP + 1, True), (64, 36, 1, 5000, False),
    (16, 36, 1, 1000, True), (16, 36, 1, 5000, False),
    (128, 36, 1, 1000, True), (128, 36, 16, 5000, False),
    (256, 36, 1, 333, True), (256, 36, 1, MLP3_BWD_STEP + 1, False),
    (64, 100, 80, 1000, True), (32, 37, 16, 333, True)])
def test_mlp3_backward_kernel_matches_plain(cuda, hidden, d_in, d_out, n,
                                            need_dX):
    """K4b through autograd of the mlp3, on fp32 packed weights (cast to
    bf16 inside, fp32 weight gradients back), against the plain backward
    with the same bf16 operands: dX within 2e-2 of its largest magnitude,
    each dW within 1e-2 of its norm. Ragged n around the warp's tile and
    the block's step, hidden 16 to 256 (dW in registers up to 64, in the
    block's partial beyond), d_out 80 and X rows of 37 floats; need_dX
    False as the training step calls it (X takes no gradient)."""
    g = torch.Generator().manual_seed(4)
    weights = [w.to(cuda) for w in mlp_init(g, d_in, hidden, d_out, 2)]
    packed = [w.requires_grad_(True) for w in heads_cuda.pack_mlp3(weights)]
    X = (torch.rand((n, d_in), generator=g) * 2 - 1).to(cuda)
    X.requires_grad_(need_dX)
    _kernels.reset_launches()
    out = heads_cuda.fused_mlp3(packed, X)
    cot = torch.randn(out.shape, generator=g).to(cuda)
    inputs = [X] * need_dX + packed
    got = torch.autograd.grad(out, inputs, cot)
    assert _kernels.launches[heads_cuda.MLP3_BWD] == 1
    bf = [w.detach().to(torch.bfloat16) for w in packed]
    dX, dws = heads_cuda.fused_mlp3_backward_plain(
        bf, X.detach(), cot, compute_dtype=torch.bfloat16)
    if need_dX:
        assert got[0].shape == dX.shape
        if n:
            torch.testing.assert_close(got[0], dX, rtol=0,
                                       atol=2e-2 * float(dX.abs().max()))
    for a, b in zip(got[need_dX:], dws):
        assert a.dtype == torch.float32 and a.shape == b.shape
        if n:
            assert _rel_err(a, b) < 1e-2
        else:
            assert not bool(a.any())


@pytest.mark.parametrize('hidden,in_registers', [(64, 1), (128, 0)])
def test_mlp3_backward_weight_gradients_are_deterministic(cuda, hidden,
                                                          in_registers):
    """Two K4b launches on the same inputs give bit-equal weight
    gradients (per-block partials summed in block order; no float
    atomics), with dW in registers (the proposal net's widths) and in the
    block's partial."""
    g = torch.Generator().manual_seed(10)
    packed = [w.to(cuda).to(torch.bfloat16) for w in heads_cuda.pack_mlp3(
        mlp_init(g, 36, hidden, 1, 2))]
    n = 20000
    X = (torch.rand((n, 36), generator=g) * 2 - 1).to(cuda)
    cot = torch.randn((n, packed[2].shape[1]), generator=g).to(cuda)
    shape = heads_cuda.mlp3_launch_shapes(packed, X)['mlp3_bwd_kernel']
    assert shape['dw_in_registers'] == in_registers
    _, first = heads_cuda.fused_mlp3_backward(packed, X, cot, need_dX=False)
    _, second = heads_cuda.fused_mlp3_backward(packed, X, cot, need_dX=False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('d_in,hidden', [(36, 512), (512, 256)])
def test_mlp3_backward_kernel_refuses_widths_beyond_shared_memory(
        cuda, d_in, hidden):
    """A hidden layer wider than 256, or weights and one warp's tiles
    beyond the card's shared memory per block, raise ValueError; nothing
    launches."""
    g = torch.Generator().manual_seed(9)
    packed = [w.to(cuda) for w in heads_cuda.pack_mlp3(
        mlp_init(g, d_in, hidden, 1, 2))]
    X = torch.zeros((10, d_in), device=cuda)
    cot = torch.zeros((10, packed[2].shape[1]), device=cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match='shared memory|at most 256'):
        heads_cuda.fused_mlp3_backward(packed, X, cot)
    assert _kernels.launches[heads_cuda.MLP3_BWD] == 0


# -- K1s, K5, K2s: the simplex encode and the sampled backward -------------

def _flagship_grid(features=8, variant='native'):
    """TPU_GRID's resolutions on a 2^12 table (dense and hashed levels)."""
    return HashGridConfig(n_levels=4, n_features=features,
                          log2_hashmap_size=12, base_resolution=16,
                          per_level_scale=5.04, variant=variant)


def _tie_points(rng, n, device):
    """_points' unit cube with its corners and faces, plus points whose
    fractions tie on every level (x0 = x1, or all three equal)."""
    x = _points(rng, max(n, 16), device, 'unit')
    x[4:10, 1] = x[4:10, 0]
    x[10:14] = x[10:14, :1]
    x[14:16, 2] = 0.5
    return x[:n].contiguous()


@pytest.mark.parametrize('n', [1, 7, 33, 2000])
@pytest.mark.parametrize('interp,features,variant', [
    ('simplex', 8, 'native'), ('simplex', 128, 'native'),
    ('simplex', 16, 'tcnn'), ('trilinear', 128, 'native'),
    ('trilinear', 8, 'torch_ngp')])
def test_atoms_kernel_matches_plain(cuda, interp, features, variant, n):
    """K1s: indices equal and weights bit-equal to the plain atoms; the fp32
    encode equal to the plain exact encode (same products and sums in the
    same order); the bf16 encode its fp32 sum rounded once (within half a
    bf16 unit, 2^-8 of the value)."""
    rng = np.random.default_rng(20)
    config = _flagship_grid(features, variant)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, features)).astype(
        np.float32), device=cuda)
    x = _tie_points(rng, n, cuda)
    want, want_idx, want_w = hashgrid_cuda.encode_atoms_plain(
        table, x, config, interp, torch.float32)
    for out_dtype in (torch.float32, torch.bfloat16):
        for atoms in (True, False):
            _kernels.reset_launches()
            out, idx, w = hashgrid_cuda.encode_atoms(table, x, config, interp,
                                                     out_dtype, atoms)
            assert _kernels.launches[hashgrid_cuda.ATOMS_NAME] == 1
            assert out.dtype == out_dtype
            if atoms:
                assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
            else:
                assert idx is None and w is None
            if out_dtype == torch.float32:
                # the same fp32 products and sums in the same order
                assert torch.equal(out, want)
            else:
                err = (out.float() - want).abs()
                assert bool((err <= 2.0 ** -8 * want.abs() + 1e-30).all())


def _tile_grid(features, variant):
    """TPU_GRID's resolutions on a 2^13 table: level 0 dense (stride^3 at
    most its size), the finer ones hashed."""
    return HashGridConfig(n_levels=4, n_features=features,
                          log2_hashmap_size=13, base_resolution=16,
                          per_level_scale=5.04, variant=variant)


@pytest.mark.parametrize('edge', ['tile-1', 'tile', 'tile+1', '2tile+3'])
@pytest.mark.parametrize('kind', ['uniform', 'rays', 'outside'])
@pytest.mark.parametrize('interp,features,variant', [
    ('simplex', 128, 'native'), ('trilinear', 128, 'native'),
    ('simplex', 16, 'torch_ngp'), ('trilinear', 8, 'tcnn')])
def test_atoms_kernel_tile_edges(cuda, interp, features, variant, kind,
                                 edge):
    """K1s at the edges of a block's points (one short, a block's, one
    over, two blocks' and three over), on uniform points, ray-ordered ones
    (neighbouring samples share rows) and points up to 0.05 outside the
    unit cube (negative cells on the dense level 0): in every form the
    atoms equal to the plain atoms, the fp32 encode equal to the plain
    exact encode (the same fp32 products and sums in the same order) and
    the bf16 encode that sum rounded once."""
    rng = np.random.default_rng(40)
    config = _tile_grid(features, variant)
    assert hashgrid_cuda.encoders.level_geometry(config)[3][0]
    shape = hashgrid_cuda.atoms_launch_shape(config, 1, interp)
    tile = shape['threads'] // 32 * shape['points']  # a block's points
    n = {'tile-1': tile - 1, 'tile': tile, 'tile+1': tile + 1,
         '2tile+3': 2 * tile + 3}[edge]
    if kind == 'rays':
        x = _clustered(rng, n, 'rays', cuda)
    else:
        x = _points(rng, max(n, 16), cuda,
                    'outside' if kind == 'outside' else 'unit')[:n]
    table = torch.tensor(rng.uniform(-1, 1, (4, 8192, features)).astype(
        np.float32), device=cuda)
    want, want_idx, want_w = hashgrid_cuda.encode_atoms_plain(
        table, x, config, interp, torch.float32)
    for out_dtype in (torch.float32, torch.bfloat16):
        for atoms in (True, False):
            _kernels.reset_launches()
            out, idx, w = hashgrid_cuda.encode_atoms(table, x, config, interp,
                                                     out_dtype, atoms)
            assert _kernels.launches[hashgrid_cuda.ATOMS_NAME] == 1
            if atoms:
                assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
            assert torch.equal(out, want.to(out_dtype))


def test_simplex_encode_kernels_under_autograd(cuda):
    """The exact simplex encode on the card: K1s forward (atoms only when
    the table's gradient is taken), K2s with every level at 4 rows as its
    table gradient, against autograd of the plain version."""
    rng = np.random.default_rng(21)
    config = _flagship_grid(16)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, 16)).astype(
        np.float32), device=cuda, requires_grad=True)
    x = _tie_points(rng, 3000, cuda)
    g = torch.tensor(rng.normal(size=(3000, 64)).astype(np.float32),
                     device=cuda)
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, x, config, interp='simplex')
    (got,) = torch.autograd.grad(out, table, g)
    assert _kernels.launches[hashgrid_cuda.ATOMS_NAME] == 1
    assert _kernels.launches[hashgrid_cuda.SAMPLED_BWD_NAME] == 1
    with torch.no_grad():
        hashgrid_cuda.hashgrid_encode(table, x, config, interp='simplex')
    t = table.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(hashgrid_cuda.hashgrid_encode_plain(
        t, x, config, interp='simplex'), t, g)
    idx, w = hashgrid_cuda.encoders._corner_idx_weights(x, config, 'simplex')
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, None, (4,) * 4,
                                                   config)
    assert bool(((got - want).abs() <= tol + 1e-4 * want.abs()).all())


def _step_like_cotangent(rng, n, width, device, dtype):
    """Rows of spread magnitudes, a third zero, as a render's cotangent."""
    g = rng.normal(size=(n, width)) * np.exp(rng.normal(size=(n, 1)))
    g[::3] = 0.0
    return torch.tensor(g.astype(np.float32), device=device).to(dtype)


@pytest.mark.parametrize('n', [1, 999, 1024, 5000])
def test_select_kernel_matches_plain(cuda, n):
    """K5 against itself, float64 and the plain subsample
    (check_selection): its counts exactly the floors of its own scan, read
    from its workspace; the scan and the coefs within their rounding
    bounds of float64; the coefs within those of the plain version's
    wherever both give a point the same count; ascending; counts summing
    to k; rows so small that their squares underflow in fp32 included. A
    cotangent that is all zero draws uniformly."""
    rng = np.random.default_rng(22)
    g = _step_like_cotangent(rng, n, 64, cuda, torch.bfloat16)
    g[1::7] *= 1e-22
    u = torch.rand((4, n + 1), generator=torch.Generator().manual_seed(n)
                   ).to(cuda)
    k = max(1, n // 4)
    work = torch.empty(hashgrid_cuda.select_workspace_bytes(n),
                       dtype=torch.uint8, device=cuda)
    _kernels.reset_launches()
    sel, coef, count = hashgrid_cuda._select_call(g, u, k, work)
    assert _kernels.launches[hashgrid_cuda.SELECT_NAME] == 1
    check = hashgrid_cuda.check_selection(
        g, u[0, n], k, sel, coef, count,
        hashgrid_cuda.select_workspace_views(work, n))
    assert not hashgrid_cuda.selection_failures(check, n, k, g.shape[1]), \
        check
    m = int(count[0])
    assert bool((sel[1:m] > sel[:m - 1]).all())
    counts = hashgrid_cuda.select_workspace_views(work, n)['counts']
    assert int(counts.sum()) == k
    # no gradient at all: a uniform draw, k points of coef n / k
    sel0, coef0, count0 = hashgrid_cuda.select_points(torch.zeros_like(g), u,
                                                      k)
    assert int(count0[0]) == k
    torch.testing.assert_close(coef0[:k], torch.full((k,), n / k,
                                                     device=cuda))


def _card_cotangent(n, width, device, seed):
    """_step_like_cotangent made on the card (1 GiB of g at the largest
    shape): rows of spread magnitudes, a third zero, every seventh scaled
    by 1e-22."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, width), generator=gen, device=device) * torch.exp(
        torch.randn((n, 1), generator=gen, device=device))
    g[::3] = 0.0
    g[1::7] *= 1e-22
    return g.to(torch.bfloat16)


# N = 1, a tile - 1 and + 1; the norms kernel's grid below the SM count
# (64 rows a block at D = 512: 100 blocks) and the tiles above it (200);
# 1 GiB of g, more rows than the persistent norms grid takes at a time and
# 1,024 tiles.
@pytest.mark.parametrize('n', [1, hashgrid_cuda.SELECT_TILE - 1,
                               hashgrid_cuda.SELECT_TILE + 1, 6400,
                               200 * hashgrid_cuda.SELECT_TILE, 1 << 20])
def test_select_kernel_shapes(cuda, n):
    """K5 at the flagship's width D = 512 across its grids: two launches
    bit-equal (selection and workspace), the check of
    test_select_kernel_matches_plain, and the all-zero cotangent drawing
    uniformly (k points of coef n / k)."""
    g = _card_cotangent(n, 512, cuda, n)
    u = torch.rand((4, n + 1), generator=torch.Generator().manual_seed(n)
                   ).to(cuda)
    k = max(1, n // 4)
    outs = []
    for _ in range(2):
        work = torch.empty(hashgrid_cuda.select_workspace_bytes(n),
                           dtype=torch.uint8, device=cuda)
        outs.append((hashgrid_cuda._select_call(g, u, k, work), work))
    (sel, coef, count), work = outs[0]
    (sel2, coef2, count2), work2 = outs[1]
    m = int(count[0])
    assert int(count2[0]) == m
    assert torch.equal(sel[:m], sel2[:m]) and torch.equal(coef[:m],
                                                          coef2[:m])
    used = 4 * (3 * n + 2 * -(-n // hashgrid_cuda.SELECT_TILE) + 1)
    assert torch.equal(work[:used], work2[:used])
    check = hashgrid_cuda.check_selection(
        g, u[0, n], k, sel, coef, count,
        hashgrid_cuda.select_workspace_views(work, n))
    assert not hashgrid_cuda.selection_failures(check, n, k, 512), check
    assert bool((sel[1:m] > sel[:m - 1]).all())
    sel0, coef0, count0 = hashgrid_cuda.select_points(torch.zeros_like(g), u,
                                                      k)
    assert int(count0[0]) == k
    torch.testing.assert_close(coef0[:k], torch.full((k,), n / k,
                                                     device=cuda))


def test_select_kernel_takes_bf16_only(cuda):
    """K5 reads the sampled encode's cotangent, which is bf16: another
    dtype raises before any launch."""
    g = torch.ones((64, 16), device=cuda)
    u = torch.rand((4, 65), device=cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match='bfloat16'):
        hashgrid_cuda.select_points(g, u, 16)
    assert _kernels.launches[hashgrid_cuda.SELECT_NAME] == 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('interp,rows,subsample', [
    ('simplex', 1, False), ('simplex', 2, False), ('simplex', 4, False),
    ('simplex', (4, 4, 2, 2), False), ('simplex', 2, True),
    ('simplex', 1, True), ('trilinear', 2, True), ('trilinear', 8, False)])
def test_sampled_scatter_kernel_matches_plain(cuda, interp, rows, subsample,
                                              dtype):
    """K2s against the plain scatter fed the same draws and the same
    (sel, coef): each element within the sum-order bound of its row's
    terms (sampled_backward_tolerance)."""
    rng = np.random.default_rng(23)
    config = _flagship_grid(128)
    n = 4000
    x = _clustered(rng, n, 'rays', cuda)
    x[:16] = _tie_points(rng, 16, cuda)
    idx, w = hashgrid_cuda.encoders._corner_idx_weights(x, config, interp)
    g = _step_like_cotangent(rng, n, config.out_dim, cuda, dtype)
    u = torch.rand((4, n + 1), generator=torch.Generator().manual_seed(1)
                   ).to(cuda)
    rows = rows if isinstance(rows, tuple) else (rows,) * 4
    sel = coef = count = None
    if subsample:  # K5 reads bf16 cotangents only
        sel, coef, count = hashgrid_cuda.select_points(
            g.to(torch.bfloat16), u, n // 4)
    _kernels.reset_launches()
    got = hashgrid_cuda.sampled_scatter(g, idx, w, u, rows, config, sel,
                                        coef, count)
    assert _kernels.launches[hashgrid_cuda.SAMPLED_BWD_NAME] == 1
    if subsample:
        m = int(count[0])
        sel, coef = sel[:m].long(), coef[:m]
    want = hashgrid_cuda.encoders.sampled_scatter_plain(g, idx, w, u, rows,
                                                        config, sel, coef)
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows, config,
                                                   sel, coef)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert bool(want.any())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('rows', [2, (4, 4, 2, 2)])
@pytest.mark.parametrize('live', ['none', 'all', 'few'])
def test_sampled_scatter_kernel_counts(cuda, live, rows, dtype):
    """K2s reads how many of its k slots are live from the device: a count
    of 0 (a zero gradient), every slot (count = k), and a count far below
    k, as at the flagship (a sixth). Against the plain scatter fed the
    first count of (sel, coef), within sampled_backward_tolerance."""
    rng = np.random.default_rng(26)
    config = _flagship_grid(128)
    n, k = 8000, 2000
    x = _clustered(rng, n, 'rays', cuda)
    idx, w = hashgrid_cuda.encoders._corner_idx_weights(x, config, 'simplex')
    g = _step_like_cotangent(rng, n, config.out_dim, cuda, dtype)
    u = torch.rand((4, n + 1), generator=torch.Generator().manual_seed(2)
                   ).to(cuda)
    rows = rows if isinstance(rows, tuple) else (rows,) * 4
    sel = torch.tensor(np.sort(rng.choice(n, k, replace=False)).astype(
        np.int32), device=cuda)
    coef = torch.tensor(rng.uniform(0.5, 4.0, k).astype(np.float32),
                        device=cuda)
    m = {'none': 0, 'all': k, 'few': k // 6}[live]
    count = torch.tensor([m], dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    got = hashgrid_cuda.sampled_scatter(g, idx, w, u, rows, config, sel,
                                        coef, count)
    assert _kernels.launches[hashgrid_cuda.SAMPLED_BWD_NAME] == 1
    if m == 0:
        assert not bool(got.any())
        return
    sel_m, coef_m = sel[:m].long(), coef[:m]
    want = hashgrid_cuda.encoders.sampled_scatter_plain(
        g, idx, w, u, rows, config, sel_m, coef_m)
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows, config,
                                                   sel_m, coef_m)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert bool(want.any())


@pytest.mark.parametrize('interp,rows', [('simplex', 4), ('simplex', 2),
                                         ('trilinear', 8)])
def test_sampled_scatter_kernel_walks_many_tiles(cuda, interp, rows):
    """Every point of a flagship-sized step (N = 131,072) at TPU_GRID's
    widths: more tiles than K2s's persistent grid has blocks, so each
    block walks several; exact (every atom) and sampled rows, against the
    plain scatter within sampled_backward_tolerance."""
    rng = np.random.default_rng(27)
    config = hashgrid_cuda.encoders.TPU_GRID
    n = 131072
    x = _clustered(rng, n, 'rays', cuda)
    idx, w = hashgrid_cuda.encoders._corner_idx_weights(x, config, interp)
    g = _step_like_cotangent(rng, n, config.out_dim, cuda, torch.bfloat16)
    u = torch.rand((4, n), generator=torch.Generator().manual_seed(3)
                   ).to(cuda)
    rows = (rows,) * 4
    shape = hashgrid_cuda.sampled_launch_shapes(config, n, n, rows, interp)[
        'K2s sampled_rows_kernel']
    assert shape['blocks'] * shape['points'] < n
    got = hashgrid_cuda.sampled_scatter(g, idx, w, u, rows, config)
    want = hashgrid_cuda.encoders.sampled_scatter_plain(g, idx, w, u, rows,
                                                        config)
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows, config)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


def test_select_and_scatter_at_the_cli_step(cuda):
    """K5 and K2s at the train CLI's step (4,096 rays x 128 samples: N =
    524,288, k = 131,072) at TPU_GRID's widths: K5 by check_selection,
    K2s fed its selection against the plain scatter within
    sampled_backward_tolerance, on a ray-ordered cotangent made on the
    card."""
    rng = np.random.default_rng(31)
    config = hashgrid_cuda.encoders.TPU_GRID
    n, k = 524288, 131072
    x = _clustered(rng, n, 'rays', cuda)
    idx, w = hashgrid_cuda.encoders._corner_idx_weights(x, config, 'simplex')
    g = _card_cotangent(n, config.out_dim, cuda, 5)
    u = torch.rand((4, n + 1), generator=torch.Generator().manual_seed(5)
                   ).to(cuda)
    work = torch.empty(hashgrid_cuda.select_workspace_bytes(n),
                       dtype=torch.uint8, device=cuda)
    sel, coef, count = hashgrid_cuda._select_call(g, u, k, work)
    check = hashgrid_cuda.check_selection(
        g, u[0, n], k, sel, coef, count,
        hashgrid_cuda.select_workspace_views(work, n))
    assert not hashgrid_cuda.selection_failures(check, n, k,
                                                config.out_dim), check
    m = int(count[0])
    rows = (2,) * 4
    got = hashgrid_cuda.sampled_scatter(g, idx, w, u, rows, config, sel, coef,
                                        count)
    sel_m, coef_m = sel[:m].long(), coef[:m]
    want = hashgrid_cuda.encoders.sampled_scatter_plain(g, idx, w, u, rows,
                                                        config, sel_m, coef_m)
    tol = hashgrid_cuda.sampled_backward_tolerance(g, idx, w, u, rows, config,
                                                   sel_m, coef_m)
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert bool(want.any())


def test_atoms_kernel_at_the_cli_step(cuda):
    """K1s at the train CLI's step (N = 524,288 ray-ordered points) on
    TPU_GRID's table: the fp32 form equal to the plain exact encode; the
    training form's indices equal and weights bit-equal to the plain
    atoms, its bf16 encode the fp32 sum rounded once (2^-8 of the value)
    and within the plain bf16 chain's roundings ((4 A + 1) 2^-8 of the
    terms' magnitudes)."""
    rng = np.random.default_rng(33)
    config = hashgrid_cuda.encoders.TPU_GRID
    n = 524288
    x = _clustered(rng, n, 'rays', cuda)
    table = (torch.rand(hashgrid_cuda._table_shape(config),
                        generator=torch.Generator().manual_seed(33)) * 2
             - 1).to(cuda)
    want, want_idx, want_w = hashgrid_cuda.encode_atoms_plain(
        table, x, config, 'simplex', torch.float32)
    _kernels.reset_launches()
    out, _, _ = hashgrid_cuda.encode_atoms(table, x, config, 'simplex',
                                           torch.float32, False)
    assert torch.equal(out, want)  # the same fp32 products and sums
    del out
    out, idx, w = hashgrid_cuda.encode_atoms(table, x, config, 'simplex',
                                             torch.bfloat16, True)
    assert _kernels.launches[hashgrid_cuda.ATOMS_NAME] == 2
    assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
    assert bool(((out.float() - want).abs()
                 <= 2.0 ** -8 * want.abs() + 1e-30).all())
    del want
    plain = hashgrid_cuda.encode_atoms_plain(table, x, config, 'simplex',
                                             torch.bfloat16, False)[0]
    terms = hashgrid_cuda.encoders._gather_from_atoms(
        table.abs(), idx, w, config, torch.float32)
    assert bool(((out.float() - plain.float()).abs()
                 <= 17 * 2.0 ** -8 * terms + 1e-30).all())


def test_head_backward_kernel_at_the_cli_step(cuda):
    """K3b at the train CLI's step with --heads-impl pallas (N = 524,288
    points, a workspace of 2.85 GB) at the head widths create_model gives
    README's flags, dB left out as the step leaves it, held as
    chip_smoke.py holds it against the plain backward with the same bf16
    operands: dA within 1e-2 of its norm, at most 3e-4 of its elements
    beyond 2e-2 of the largest magnitude (ReLU masks that the other
    summation order rounds to the other side of 0: see
    _check_point_gradients), and no further from the fp32 plain version
    than the bf16 plain version is (room 1.1, in the norm and in the share
    beyond 2e-2 of the largest magnitude), which mask flips alone keep and
    a wrong index or a dropped term would not; each dW within 1e-2 of its
    norm."""
    from autolabel_tpu_torch import model_utils
    from autolabel_tpu_torch.train.__main__ import read_args
    flags = read_args(['scene', '--proposal', '--heads-impl', 'pallas'])
    field = model_utils.create_model(
        np.full(3, -1.0), np.full(3, 1.0), 2, flags, device=cuda,
        generator=torch.Generator().manual_seed(8))
    ws = [w.detach().to(torch.bfloat16) for w in
          heads_cuda.pack_head_weights(field.head_params(), 12)]
    n = 524288
    g = torch.Generator().manual_seed(34)
    A = (torch.randn((n, field.config.grid_config.out_dim), generator=g)
         * 0.5).to(cuda)
    B = torch.zeros((n, 32), device=cuda)
    B[:, :12] = torch.rand((n, 12), generator=g).to(cuda) * 2 - 1
    B[:, 16:32] = torch.randn((n, 16), generator=g).to(cuda) * 0.3
    cots = [torch.randn((n, w.shape[1]), generator=g).to(cuda)
            for w in (ws[7], ws[10], ws[13])]
    _kernels.reset_launches()
    dA, dB, dws = heads_cuda.fused_heads_backward(ws, A, B, *cots,
                                                  need_dB=False)
    assert _kernels.launches[heads_cuda.HEADS_BWD] == 1 and dB is None
    want, _, want_w = heads_cuda.fused_heads_backward_plain(
        ws, A, B, *cots, compute_dtype=torch.bfloat16)
    exact = heads_cuda.fused_heads_backward_plain(
        ws, A, B, *cots, compute_dtype=torch.float32)[0]

    def share(got, ref):
        return float(((got - ref).abs() > 2e-2 * float(ref.abs().max()))
                     .float().mean())

    assert dA.shape == want.shape
    assert _rel_err(dA, want) < 1e-2
    assert share(dA, want) <= 3e-4
    assert _rel_err(dA, exact) <= 1.1 * _rel_err(want, exact)
    assert share(dA, exact) <= 1.1 * share(want, exact)
    for a, b in zip(dws, want_w):
        assert a.shape == b.shape
        assert _rel_err(a, b) < 1e-2


def test_sampled_encode_launches_each_kernel_once(cuda):
    """The exact-forward / sampled-backward encode under autograd: K1s
    (bf16 out), K5 and K2s once each; zero cotangents for x and u."""
    rng = np.random.default_rng(24)
    config = _flagship_grid(128)
    table = torch.tensor(rng.uniform(-1, 1, (4, 4096, 128)).astype(
        np.float32), device=cuda, requires_grad=True)
    x = _tie_points(rng, 2000, cuda).requires_grad_(True)
    u = torch.rand((4, 2001), device=cuda, requires_grad=True)
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, x, config, interp='simplex',
                                        u=u, sampled_backward=2,
                                        backward_points=0.25)
    assert out.dtype == torch.bfloat16
    out.float().pow(2).sum().backward()
    for name in (hashgrid_cuda.ATOMS_NAME, hashgrid_cuda.SELECT_NAME,
                 hashgrid_cuda.SAMPLED_BWD_NAME):
        assert _kernels.launches[name] == 1, name
    assert x.grad is None or not bool(x.grad.any())
    assert u.grad is None or not bool(u.grad.any())
    assert bool(table.grad.any())


@pytest.mark.parametrize('interp,kernel', [
    ('trilinear', hashgrid_cuda.NAME), ('simplex', hashgrid_cuda.ATOMS_NAME)])
def test_field_from_create_model_launches_the_encode_kernel(cuda, interp,
                                                            kernel):
    """A Field as model_utils.create_model builds it (grid_impl left at
    'xla', as the CLI leaves it) renders on the card through the encode
    kernels, never the plain encode: K1 for trilinear, K1s for simplex."""
    from autolabel_tpu_torch import model_utils
    from autolabel_tpu_torch.render.renderer import RenderOptions, render_rays
    flags = model_utils.model_flag_parser().parse_args(
        ['--grid-interp', interp, '--proposal'])
    field = model_utils.create_model(np.full(3, -1.0), np.full(3, 1.0), 6,
                                     flags, device=cuda)
    assert field.config.grid_impl == 'xla'
    rng = np.random.default_rng(25)
    o = torch.tensor(rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32),
                     device=cuda)
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(64, 3)).astype(np.float32), device=cuda), dim=-1)
    _kernels.reset_launches()
    with torch.no_grad():
        out = render_rays(field, o, d, torch.ones((64, 1), device=cuda),
                          options=RenderOptions(num_steps=16,
                                                proposal_steps=32))
    assert _kernels.launches[kernel] == 1
    assert bool(torch.isfinite(out['image']).all())


# -- K6, K7: the stochastic-corner and residual encodes ---------------------

# (interp, n_samples, residual): the modes of test_torch_port_stochastic.
STOCHASTIC_MODES = [('trilinear', 1, False), ('trilinear', 2, False),
                    ('trilinear', 3, False), ('simplex', 1, False),
                    ('simplex', 2, False), ('trilinear', 2, True),
                    ('simplex', 2, True)]


def _stochastic_case(config, interp, n_samples, residual, exact_levels, n,
                     seed, device, kind='rays'):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    x = _clustered(rng, n, kind, device) if kind != 'ties' \
        else _tie_points(rng, n, device)
    table = (torch.rand(hashgrid_cuda._table_shape(config), generator=gen)
             * 2 - 1).to(device)
    u = torch.rand(hashgrid_cuda.encoders.uniform_shape(
        config.n_levels, n, interp, n_samples, residual),
        generator=gen).to(device)
    g = torch.randn((n, config.out_dim), generator=gen).to(device)
    plan = hashgrid_cuda.encoders.stochastic_plan(config, interp, n_samples,
                                                  exact_levels, residual)
    return table, x, u, g, plan


def _assert_stochastic_holds(config, interp, n_samples, residual,
                             exact_levels, n, seed, device, kind='rays'):
    table, x, u, g, plan = _stochastic_case(config, interp, n_samples,
                                            residual, exact_levels, n, seed,
                                            device, kind)
    _kernels.reset_launches()
    failures, details = hashgrid_cuda.check_stochastic(
        table, x, u, config, interp, n_samples, plan, g)
    assert not failures, failures
    assert _kernels.launches[hashgrid_cuda.STOCHASTIC_NAME] == 2
    assert _kernels.launches[hashgrid_cuda.STOCHASTIC_BWD_NAME] == 1
    assert details['out'].shape == (n, config.out_dim)
    assert details['idx'].shape == (sum(r for _, r in plan), n)


@pytest.mark.parametrize('exact_levels', [0, 1, 4])
@pytest.mark.parametrize('interp,n_samples,residual', STOCHASTIC_MODES)
def test_stochastic_kernels_at_the_cli_step(cuda, interp, n_samples,
                                            residual, exact_levels):
    """K6 and K7 at the train CLI's step (N = 524,288 ray-ordered points)
    on TPU_GRID's table, every mode: K6's rows equal to the plain
    version's (flips only within 1 ulp of a boundary), its encode
    bit-equal; K7 within the term-count tolerance of the plain scatter."""
    _assert_stochastic_holds(hashgrid_cuda.encoders.TPU_GRID, interp,
                             n_samples, residual, exact_levels, 524288, 40,
                             cuda)


@pytest.mark.parametrize('exact_levels', [0, 4, 16])
@pytest.mark.parametrize('n_samples', [1, 2, 3])
def test_stochastic_kernels_on_the_reference_grid(cuda, n_samples,
                                                  exact_levels):
    """The narrow kernels on the reference preset (16 x 2^19 x 2,
    trilinear) at the CLI's N = 524,288."""
    _assert_stochastic_holds(HashGridConfig(), 'trilinear', n_samples, False,
                             exact_levels, 524288, 41, cuda)


@pytest.mark.parametrize('n', [1, 7, 33, 2000])
@pytest.mark.parametrize('features,interp,n_samples,residual', [
    (128, 'simplex', 2, False), (128, 'trilinear', 3, False),
    (128, 'simplex', 2, True), (8, 'trilinear', 2, True),
    (2, 'trilinear', 2, False), (2, 'trilinear', 5, False)])
def test_stochastic_kernels_ragged_and_tied(cuda, features, interp,
                                            n_samples, residual, n):
    """Ragged point counts, tied fractions and cube corners, wide rows
    (also F = 8, below the float4 lanes' width), narrow rows and an odd
    count of 5 draws, with one exact level."""
    _assert_stochastic_holds(_flagship_grid(features), interp, n_samples,
                             residual, 1, n, 42, cuda, kind='ties')


@pytest.mark.parametrize('n_samples', [33, 64])
@pytest.mark.parametrize('features', [128, 2])
def test_stochastic_kernels_cap_the_rows_a_level(cuda, features, n_samples):
    """No cap on the rows a level: 33 and 64 draws (more than a warp's 32
    lanes, which K6 once capped them at) hold against the plain version,
    with one exact level, K6's rounds carrying the blend in order."""
    _assert_stochastic_holds(_flagship_grid(features), 'trilinear',
                             n_samples, False, 1, 333, 46, cuda)


@pytest.mark.parametrize('group', [1, 3, 4, 16])
def test_stochastic_narrow_groups_match_plain(cuda, group):
    """K6's narrow rows in any grouping of the levels a thread walks (1:
    levels slowest; 4: a 32-byte sector a point at F = 2; 16, the
    library's choice: the whole point; 3 leaves a ragged last group) are
    bit-equal to the plain version."""
    config = HashGridConfig()
    table, x, u, _, plan = _stochastic_case(config, 'trilinear', 2, False, 4,
                                            5000, 47, cuda)
    want = hashgrid_cuda.stochastic_encode_plain(table, x, u, config,
                                                 'trilinear', 2, plan)
    got = hashgrid_cuda._stochastic_call(table, x, u, config, 'trilinear', 2,
                                         plan, True, group=group)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize('preset', ['reference', 'tpu'])
def test_stochastic_scatter_levels_alone_match_plain(cuda, preset):
    """K7 with every level scattered alone into a zeroed gradient (how its
    atomics are timed level by level) sums to the plain scatter within
    its term-count tolerance, as the whole launch does: the narrow rows'
    warp merge on the reference preset, the wide rows' tile grouping on
    the TPU grid."""
    config = HashGridConfig() if preset == 'reference' \
        else hashgrid_cuda.encoders.TPU_GRID
    table, x, u, g, plan = _stochastic_case(config, 'trilinear', 3, False, 1,
                                            20000, 48, cuda)
    _, idx, w = hashgrid_cuda.stochastic_encode_plain(table, x, u, config,
                                                      'trilinear', 3, plan)
    want = hashgrid_cuda.encoders.stochastic_scatter_plain(g, idx, w, plan,
                                                           config, 3)
    tol = hashgrid_cuda.stochastic_backward_tolerance(g, idx, w, plan,
                                                      config, 3)
    got = hashgrid_cuda._stochastic_scatter_call(g, idx, w, plan, config, 3)
    assert bool(((got - want).abs() <= tol).all())
    alone = torch.zeros_like(got)
    for level in range(config.n_levels):
        hashgrid_cuda._stochastic_scatter_call(g, idx, w, plan, config, 3,
                                               level, alone)
    assert bool(((alone - want).abs() <= tol).all())


@pytest.mark.parametrize('parts', ['draws', 'gathers', 'stores'])
def test_stochastic_parts_launch(cuda, parts):
    """K6's parts, launched alone for timing, run on both kernels; the
    draws write the rows the encode writes."""
    for config, interp in ((_flagship_grid(128), 'simplex'),
                           (HashGridConfig(), 'trilinear')):
        table, x, u, _, plan = _stochastic_case(config, interp, 2, False, 1,
                                                3000, 49, cuda)
        _, idx, w = hashgrid_cuda._stochastic_call(table, x, u, config,
                                                   interp, 2, plan, True)
        _, idx_p, w_p = hashgrid_cuda._stochastic_call(
            table, x, u, config, interp, 2, plan, True, parts=parts)
        torch.cuda.synchronize()
        if parts == 'draws':
            assert torch.equal(idx_p, idx) and torch.equal(w_p, w)


def test_stochastic_encode_under_autograd(cuda):
    """The stochastic encode under autograd: K6 once with its rows, K7 once;
    the table gradient is the plain scatter's; the gradient for x is K2x's
    (held in test_point_grad_kernel_matches_plain)."""
    config = _flagship_grid(128)
    table, x, u, g, plan = _stochastic_case(config, 'simplex', 2, False, 1,
                                            3000, 43, cuda)
    table.requires_grad_(True)
    _kernels.reset_launches()
    out = hashgrid_cuda.hashgrid_encode(table, x, config, interp='simplex',
                                        u=u, n_samples=2, exact_levels=1)
    assert out.dtype == torch.float32
    (grad,) = torch.autograd.grad(out, table, g)
    assert _kernels.launches[hashgrid_cuda.STOCHASTIC_NAME] == 1
    assert _kernels.launches[hashgrid_cuda.STOCHASTIC_BWD_NAME] == 1
    _, idx, w = hashgrid_cuda.stochastic_encode_plain(
        table.detach(), x, u, config, 'simplex', 2, plan)
    want = hashgrid_cuda.encoders.stochastic_scatter_plain(g, idx, w, plan,
                                                           config, 2)
    tol = hashgrid_cuda.stochastic_backward_tolerance(g, idx, w, plan,
                                                      config, 2)
    assert bool(((grad - want).abs() <= tol).all())
    xr = x.clone().requires_grad_(True)
    out = hashgrid_cuda.hashgrid_encode(table, xr, config, interp='simplex',
                                        u=u, n_samples=2)
    _kernels.reset_launches()
    torch.autograd.grad(out.sum(), (table, xr))
    assert _kernels.launches[hashgrid_cuda.POINT_GRAD_NAME] == 1


@pytest.mark.parametrize('preset', ['tpu_simplex', 'reference'])
def test_stochastic_kernels_are_unbiased(cuda, preset):
    """The mean of 64 draws of K6 is the exact encode (K1s or K1), and the
    mean of 64 K7 gradients the exact gradient (K2s exact or K2), each
    within 4 standard errors in the norm (from the draws' own spread)."""
    if preset == 'reference':
        config, interp = HashGridConfig(), 'trilinear'
    else:
        config, interp = hashgrid_cuda.encoders.TPU_GRID, 'simplex'
    table, x, _, g, plan = _stochastic_case(config, interp, 2, False, 0,
                                            20000, 44, cuda)
    with torch.no_grad():
        exact = hashgrid_cuda.hashgrid_encode(table, x, config,
                                              interp=interp).double()
    t = table.clone().requires_grad_(True)
    (exact_grad,) = torch.autograd.grad(hashgrid_cuda.hashgrid_encode(
        t, x, config, interp=interp), t, g)
    gen = torch.Generator(device=cuda).manual_seed(45)
    draws = 64
    sums = [torch.zeros_like(exact), torch.zeros_like(exact),
            torch.zeros_like(exact_grad, dtype=torch.float64),
            torch.zeros_like(exact_grad, dtype=torch.float64)]
    for _ in range(draws):
        u = torch.rand(hashgrid_cuda.encoders.uniform_shape(
            config.n_levels, x.shape[0], interp, 2), generator=gen,
            device=cuda)
        out = hashgrid_cuda.hashgrid_encode(t, x, config, interp=interp,
                                            u=u, n_samples=2)
        (grad,) = torch.autograd.grad(out, t, g)
        for k, v in ((0, out.detach().double()), (2, grad.double())):
            sums[k] += v
            sums[k + 1] += v * v
    for k, want in ((0, exact), (2, exact_grad.double())):
        mean = sums[k] / draws
        var = (sums[k + 1] / draws - mean * mean).clamp(min=0) \
            * draws / (draws - 1)
        se = float(torch.sqrt(var.sum() / draws))
        bias = float((mean - want).norm())
        assert bias <= 4 * se, (k, bias, se)


# -- K8, the baked preview's splat render -----------------------------------

def _splat_scene(kind, with_sh, device, camera=None, k=65536):
    """Splat clouds for K8: 'random' (a dense cloud in front of the
    camera, some splats invalid or behind it), 'ties' (every splat
    repeated 3 times, so pixels hold tied winners) and 'edges' (a few
    splats landing on the frame's edge pixels of `camera` = (K, T, width,
    height), with footprints of several pixels, read across the edges by
    the fill passes)."""
    rng = np.random.default_rng(11)
    if kind == 'edges':
        K, T, width, height = camera
        w1, h1 = width - 1, height - 1
        px = np.concatenate([np.zeros(8), np.full(8, w1),
                             rng.uniform(0, w1, 16)])
        py = np.concatenate([rng.uniform(0, h1, 16), np.zeros(8),
                             np.full(8, h1)])
        z = rng.uniform(2.5, 3.5, len(px))
        cam = np.stack([(px - K[0, 2]) * z / K[0, 0],
                        (py - K[1, 2]) * z / K[1, 1], z], 1)
        points = (cam - T[:3, 3]) @ T[:3, :3]  # R^T (cam - t), row-wise
        cell = 4.0 * 3.0 / K[0, 0]  # a footprint radius of 2 pixels
    else:
        points = rng.uniform(-1.0, 1.0, (k, 3))
        points[:, 2] += 2.5
        points[: k // 64, 2] = -1.0  # behind the camera
        cell = 0.02
        if kind == 'ties':
            points = np.repeat(points[:k // 3], 3, axis=0)
    n = len(points)
    sh = torch.tensor(rng.normal(size=(n, 3, 3)) * 0.3, dtype=torch.float32,
                      device=device) if with_sh else None
    return (torch.tensor(points, dtype=torch.float32, device=device),
            torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32,
                         device=device), sh,
            torch.tensor(rng.integers(0, 6, n), dtype=torch.int32,
                         device=device),
            torch.tensor(rng.uniform(size=n) < 0.95, device=device), cell)


def _splat_camera(width, height):
    K = np.array([[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2],
                  [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(np.eye(3) + 0.05 * np.random.default_rng(
        12).normal(size=(3, 3)))[0]
    T[:3, 3] = [0.05, -0.02, 0.1]
    return K, T


@pytest.mark.parametrize('width, height', [(64, 48), (480, 360),
                                           (1280, 720)])
@pytest.mark.parametrize('with_sh', [True, False])
@pytest.mark.parametrize('kind', ['random', 'ties', 'edges'])
def test_splat_kernel_matches_plain(cuda, kind, with_sh, width, height):
    """K8 against its plain version by splat_cuda.check_splat's rules, at
    BakedRenderer's pass count for the width; launches_for(passes)
    launches (4: memset, project, winners, one tiled fill)."""
    K, T = _splat_camera(width, height)
    points, rgb, sh, semantic, valid, cell = _splat_scene(
        kind, with_sh, cuda, (K, T, width, height))
    from autolabel_tpu_torch.render.baked import fill_passes_for
    passes = fill_passes_for(width, 2)
    _kernels.reset_launches()
    result = splat_cuda.check_splat(points, rgb, sh, semantic, valid, K, T,
                                    height, width, passes, cell)
    assert _kernels.launches[splat_cuda.NAME] == splat_cuda.launches_for(
        passes) == 4
    assert result['ok'], result
    assert result['in_frame'] > 0
    if kind == 'ties':
        assert result['ties'] > 0


@pytest.mark.parametrize('passes', [0, 1, 2])
def test_splat_kernel_few_passes(cuda, passes):
    """With no pass the fill kernel resolves the frame alone; with one the
    first pass is the last."""
    points, rgb, sh, semantic, valid, cell = _splat_scene(
        'random', True, cuda, k=4096)
    K, T = _splat_camera(64, 48)
    result = splat_cuda.check_splat(points, rgb, sh, semantic, valid, K, T,
                                    48, 64, passes, cell)
    assert result['ok'], result


@pytest.mark.parametrize('passes', [0, 1, 4, 8, splat_cuda.HALO_MAX + 1,
                                    2 * splat_cuda.HALO_MAX + 3])
@pytest.mark.parametrize('width, height', [(1, 1), (5, 3), (33, 17),
                                           (64, 48)])
def test_splat_kernel_tiles(cuda, width, height, passes):
    """The fill's tiles and halo: frames of one pixel, smaller than the
    halo (rows and columns wrap several times), not a multiple of the tile
    and of 2 x 2 tiles; passes beyond HALO_MAX carried between launches."""
    K, T = _splat_camera(width, height)
    points, rgb, sh, semantic, valid, _ = _splat_scene(
        'random', True, cuda, k=8192)
    cell = 0.3  # footprints of several pixels, so the passes adopt
    _kernels.reset_launches()
    result = splat_cuda.check_splat(points, rgb, sh, semantic, valid, K, T,
                                    height, width, passes, cell)
    assert _kernels.launches[splat_cuda.NAME] == splat_cuda.launches_for(
        passes)
    assert result['ok'], result


def test_splat_kernel_is_what_the_renderer_launches(cuda):
    from autolabel_tpu_torch.render.baked import BakedRenderer, BakedScene
    points, rgb, sh, semantic, valid, cell = _splat_scene(
        'random', True, cuda, k=4096)
    scene = BakedScene(points=points, rgb=rgb, semantic=semantic,
                       valid=valid, cell_size=cell, sh=sh)
    K, T = _splat_camera(64, 48)
    _kernels.reset_launches()
    out = BakedRenderer(scene).render(K, T, (64, 48))
    assert _kernels.launches[splat_cuda.NAME] == splat_cuda.launches_for(4)
    want = splat_cuda.splat_render_plain(points, rgb, sh, semantic, valid,
                                         K, T, 48, 64, 4, cell)
    assert torch.equal(out['depth'], want[1])
    assert torch.equal(out['semantic'], want[2])
    assert out['image'].device.type == 'cuda'


def test_splat_kernel_rejects_bad_inputs(cuda):
    points, rgb, sh, semantic, valid, cell = _splat_scene(
        'random', False, cuda, k=64)
    K, T = _splat_camera(64, 48)
    with pytest.raises(ValueError):
        splat_cuda.splat_render(points, rgb, sh, semantic.long(), valid, K,
                                T, 48, 64, 4, cell)
    with pytest.raises(ValueError):
        splat_cuda.splat_render(points, rgb.cpu(), sh, semantic, valid, K,
                                T, 48, 64, 4, cell)
    with pytest.raises(ValueError):
        splat_cuda.splat_render(points[:, :2], rgb, sh, semantic, valid, K,
                                T, 48, 64, 4, cell)


# -- evaluation: the reference's lattices at full size, the 3D query ---------

@pytest.mark.parametrize('variant', ['tcnn', 'torch_ngp'])
@pytest.mark.parametrize('domain', ['unit', 'outside'])
def test_encode_kernel_on_the_reference_lattices(cuda, variant, domain):
    """K1 on an imported reference checkpoint's grid: 16 levels of up to
    2^19 rows of 2 features, level sizes rounded to 8 (tcnn) or not
    powers of two, positions offset by half a cell; rows beyond a level's
    size zero, as torch_import packs them."""
    import dataclasses
    if variant == 'tcnn':
        config = dataclasses.replace(HashGridConfig(), variant='tcnn')
    else:
        config = HashGridConfig.from_desired_resolution(
            2 ** 18, variant='torch_ngp')
    rng = np.random.default_rng(14)
    table = rng.normal(0.0, 0.5, (config.n_levels, config.table_size,
                                  config.n_features)).astype(np.float32)
    for level, size in enumerate(config.level_sizes):
        table[level, size:] = 0.0
    table = torch.tensor(table, device=cuda)
    x = _points(rng, 65536, cuda, domain)
    _kernels.reset_launches()
    got = hashgrid_cuda.hashgrid_encode(table, x, config)
    assert _kernels.launches[hashgrid_cuda.NAME] == 1
    want = hashgrid_cuda.hashgrid_encode_plain(table, x, config)
    # the same products and sums in the same order and rounding
    assert torch.equal(got, want)


@pytest.mark.parametrize('given_noise', [True, False])
def test_jittered_features_on_the_card(cuda, monkeypatch, given_noise):
    """jittered_semantic_features through K1s (eval form) against the plain
    encode on the same jitter: given as noise, or drawn by the card's
    generator from the same seed. K1s's fp32 encode is bit-equal to the
    plain one and the heads are the same torch.matmul, so the features
    agree to fp32 rounding."""
    from autolabel_tpu_torch.inference import InferenceModel
    from autolabel_tpu_torch.models.field import Field, FieldConfig
    from autolabel_tpu_torch.ops.encoders import TPU_GRID
    field = Field(FieldConfig(encoding='hg+freq', hidden_dim_semantic=64,
                              semantic_classes=6, bound=2.0, grid=TPU_GRID,
                              grid_interp='simplex'),
                  device=cuda, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        field.encoder['grid'].normal_(0.0, 0.5)
    model = InferenceModel(field)
    model._chunk = 4096
    rng = np.random.default_rng(15)
    n = 10000
    points = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    noise = (rng.normal(size=(9, n, 3)) * 0.02).astype(np.float32) \
        if given_noise else None
    _kernels.reset_launches()
    got = model.jittered_semantic_features(points, 10, 0.02, seed=3,
                                           noise=noise)
    assert _kernels.launches[hashgrid_cuda.ATOMS_NAME] == 3 * 10
    monkeypatch.setattr(hashgrid_cuda, 'hashgrid_encode',
                        hashgrid_cuda.hashgrid_encode_plain)
    _kernels.reset_launches()
    want = model.jittered_semantic_features(points, 10, 0.02, seed=3,
                                            noise=noise)
    assert not any(_kernels.launches.values())
    assert got.shape == (n, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the teacher towers (library calls, full fp32) on the card ---------------


def _tower_cases():
    from autolabel_tpu_torch.features import (clip_text, demo_clip, fcn,
                                              lseg_tower, vit)

    def text(gen):
        config = clip_text.CLIPTextConfig(vocab_size=99, width=64, depth=2,
                                          heads=4, context_length=16,
                                          embed_dim=32)
        tokens = torch.randint(1, 90, (5, 16), generator=gen)
        tokens[:, 9:] = 0
        tokens[:, 8] = 98
        return (clip_text.init_params(gen, config),
                lambda p, t: clip_text.encode_tokens(p, t, config), tokens)

    def dino(gen):
        config = vit.ViTConfig(width=96, depth=2, heads=3)
        return (vit.init_params(gen, config, pos_grid=4),
                lambda p, x: vit.encode_image(p, x, config),
                torch.randn((2, 3, 40, 56), generator=gen))

    def resnet(gen):
        return (fcn.init_params(gen, depths=(1, 2, 1, 1), width=8, head=32),
                fcn.fcn_features, torch.rand((2, 3, 45, 61), generator=gen))

    def lseg(gen):
        config = lseg_tower.LSegConfig(
            vit=vit.ViTConfig(patch_size=16, width=64, depth=4, heads=4),
            hooks=(0, 1, 2, 3), neck_dims=(16, 32, 64, 64), features=32,
            out_dim=48)
        return (lseg_tower.init_params(gen, config, pos_grid=4),
                lambda p, x: lseg_tower.compute_features(p, x, config),
                torch.randn((2, 3, 50, 70), generator=gen))

    def pixel(gen):
        return (demo_clip.init_pixel_params(gen),
                demo_clip.apply_pixel_tower,
                torch.rand((2, 33, 48, 3), generator=gen))

    return {'clip_text': text, 'vit': dino, 'fcn': resnet, 'lseg': lseg,
            'pixel': pixel}


@pytest.mark.parametrize('tower', ['clip_text', 'vit', 'fcn', 'lseg',
                                   'pixel'])
def test_teacher_tower_on_card_matches_cpu(cuda, tower):
    """fp32 on the card (TF32 off) against the same module on the CPU:
    within 1e-4 of the output's largest magnitude."""
    from autolabel_tpu_torch import bridge
    from autolabel_tpu_torch.features.layers import full_precision
    params, forward, x = _tower_cases()[tower](
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = forward(params, x)
        with full_precision():
            got = forward(bridge.tree_from_numpy(params, cuda), x.to(cuda))
    assert got.device.type == 'cuda' and got.shape == want.shape
    err = (got.cpu() - want).abs().max()
    assert err <= 1e-4 * want.abs().max(), (err, want.abs().max())


def test_demo_teacher_trains_on_card(cuda, tmp_path):
    """Three steps on the card from the CPU run's init: the same batches,
    losses within 1e-3 relative."""
    from autolabel_tpu_torch.features import demo_clip
    from autolabel_tpu_torch.utils import fixtures
    scene = str(tmp_path / 'room')
    fixtures.make_room_scene(scene, n_frames=4, width=80, height=60,
                             label_every=1)
    kwargs = dict(iters=3, crop=32, frames_stride=1, seed=1)
    cpu = demo_clip.DemoTeacherTrainer(scene, device='cpu', **kwargs)
    card = demo_clip.DemoTeacherTrainer(scene, device=cuda, **kwargs)
    for _ in range(3):
        a, b = float(cpu.step()), float(card.step())
        assert abs(a - b) <= 1e-3 * abs(a), (a, b)
    fe_path = str(tmp_path / 't.npz')
    demo_clip.save_checkpoint(fe_path, card.trained(), card.prompt_bank)
    fe = demo_clip.DemoCLIPFE(fe_path, device=cuda)
    out = fe(np.random.default_rng(0).random((1, 3, 20, 30), np.float32))
    assert out.device.type == 'cuda' and out.dtype == torch.float16
    assert fe.encode_text(['red ball']).shape == (1, 512)


@pytest.mark.parametrize('where', ['host', 'card'])
def test_compress_features_on_card(cuda, where):
    """The maps in host memory (as extract_features keeps them) or on the
    card: the codes come back on the card."""
    from autolabel_tpu_torch.compute_feature_maps import compress_features
    maps = torch.randn((2, 16, 24, 64), generator=torch.Generator()
                       .manual_seed(0)).to(torch.float16)
    if where == 'card':
        maps = maps.to(cuda)
    codes = compress_features(maps, 8, epochs=2, batch_size=256,
                              device=cuda)
    assert codes.shape == (2, 16, 24, 8) and codes.device.type == 'cuda'
    assert bool(torch.isfinite(codes.float()).all()) and bool(
        (codes >= 0).all())


def _ba_ring(seed, n_cams=12, n_pts=400, views=6):
    """A ring of cameras around points near the origin, each point seen by
    `views` consecutive cameras, 0.5 px noise and 3% outliers; camera 1
    at theta = 0 (R = I) looking along +z from (0, 0, -3)."""
    rng = np.random.default_rng(seed)
    from autolabel_tpu_torch.mapping.ba import rodrigues, rotmat_to_rvec
    rv, tv = [], []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams if i != 1 else 0.0
        C = np.array([3 * np.sin(a), 0.2 * np.cos(3 * a) * (i != 1),
                      -3 * np.cos(a)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        rv.append(rotmat_to_rvec(R))
        tv.append(-R @ C)
    rv, tv = np.stack(rv), np.stack(tv)
    pts = rng.uniform(-0.8, 0.8, (n_pts, 3))
    first = rng.integers(0, n_cams, n_pts)
    ci = ((first[:, None] + np.arange(views)) % n_cams).ravel()
    pi = np.repeat(np.arange(n_pts), views)
    R = rodrigues(torch.tensor(rv)).numpy()
    Xc = np.einsum('nij,nj->ni', R[ci], pts[pi]) + tv[ci]
    xy = Xc[:, :2] / Xc[:, 2:3] * 400 + [320, 240]
    xy += rng.normal(scale=0.5, size=xy.shape)
    xy += (rng.random(len(xy)) < 0.03)[:, None] * rng.uniform(-40, 40,
                                                               xy.shape)
    start = (rv + rng.normal(scale=0.003, size=rv.shape),
             tv + rng.normal(scale=0.02, size=tv.shape),
             pts + rng.normal(scale=0.02, size=pts.shape))
    start[0][1] = 0.0
    return start, (400.0, 400.0, 320.0, 240.0), ci, pi, xy


def _ba_inputs(device, start, intr, ci, pi, xy, order=True):
    from autolabel_tpu_torch.mapping import ba
    if order:
        o = np.argsort(ci, kind='stable')
        ci, pi, xy = ci[o], pi[o], xy[o]
    f = dict(dtype=torch.float32, device=device)
    params = tuple(torch.tensor(np.asarray(a), **f) for a in start) \
        + (torch.tensor(0.01, **f),)
    unit = (intr, torch.tensor(ci, dtype=torch.int32, device=device),
            torch.tensor(pi, dtype=torch.int32, device=device),
            torch.tensor(xy, **f), torch.ones(len(ci), **f))
    sw = ba._huber_sqrt_weights(params, unit, 4.0)
    return params, unit[:4] + (sw,)


def _rel(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


@pytest.mark.parametrize('order', [True, False])
@pytest.mark.parametrize('refine_focal', [False, True])
def test_ba_kernel_matches_plain(cuda, refine_focal, order):
    """K9's residual, cost, gradient and damped product against the plain
    version (torch.func) within 1e-5 by relative norm, in camera order
    (bundle_adjust's) and in track order (the segmented camera sums must
    not need the order); each entry counted once a call."""
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import ba_cuda
    prob = _ba_ring(0)
    params, const = _ba_inputs(cuda, *prob, order=order)
    kern = ba.products(params, const, refine_focal)
    assert isinstance(kern, ba_cuda.KernelProducts)
    plain = ba.PlainProducts(params, const, refine_focal)
    v = torch.randn(ba.size(12, 400), generator=torch.Generator()
                    .manual_seed(1)).to(cuda)
    _kernels.reset_launches()
    got = list(kern.residual_grad()) + [kern.matvec(v, 0.3)]
    torch.cuda.synchronize()
    assert dict(_kernels.launches) == {n: 1 for n in ba_cuda.NAMES[:2]}
    want = list(plain.residual_grad()) + [plain.matvec(v, 0.3)]
    for name, a, b in zip(('r', 'cost', 'g', 'matvec'), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    g = got[2]
    assert not g[:3].any() and not g[36:39].any()
    assert bool(g[-1] != 0) == refine_focal


def test_ba_kernel_at_clamp_and_tie(cuda):
    """An observation behind its camera (the depth clamp) and one exactly
    at z = 1e-6 (a tie, half the gradient), Huber-weighted: K9 within 1e-5
    of the plain version by relative norm (taken in float64: the clamped
    rows' products pass fp32's range in a norm)."""
    from autolabel_tpu_torch.mapping import ba
    rv = np.array([[0.1, -0.2, 0.05], [0.0, 0.0, 0.0], [0.02, 0.3, -0.1]])
    tv = np.array([[0.1, 0.0, 3.0], [0.0, 0.0, float(np.float32(1e-6))],
                   [-0.5, 0.1, 3.5]])
    pts = np.array([[0.2, -0.1, -0.5], [0.3, 0.2, 0.0], [0.1, 0.1, 1.0],
                    [-0.4, 0.2, 1.5], [0.5, -0.3, 2.0], [0.0, 0.4, 0.8]])
    ci, pi = np.repeat(np.arange(3), 6), np.tile(np.arange(6), 3)
    xy = np.random.default_rng(0).uniform(0, 600, (18, 2))
    params, const = _ba_inputs(cuda, (rv, tv, pts), (500.0, 500.0, 320.0,
                                                     240.0), ci, pi, xy)
    # point 1 sits exactly at the clamp depth of camera 1: a tie
    assert float(params[2][1, 2] + params[1][1, 2]) == ba.Z_MIN \
        or float(params[2][1, 2] + params[1][1, 2]) == float(
            np.float32(ba.Z_MIN))
    v = torch.randn(ba.size(3, 6), generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    for refine in (False, True):
        kern = ba.products(params, const, refine)
        plain = ba.PlainProducts(params, const, refine)
        got = list(kern.residual_grad()) + [kern.matvec(v, 0.0)]
        want = list(plain.residual_grad()) + [plain.matvec(v, 0.0)]
        for name, a, b in zip(('r', 'cost', 'g', 'matvec'), got, want):
            assert _rel(a, b) <= 1e-5, (name, refine, _rel(a, b))


def test_ba_kernel_refuses_what_it_does_not_take(cuda):
    from autolabel_tpu_torch.mapping import ba
    params, const = _ba_inputs(cuda, *_ba_ring(0))
    wide = tuple(t.double() for t in params)
    with pytest.raises(ValueError):
        ba.products(wide, const, False)
    kern = ba.products(params, const, False)
    with pytest.raises(ValueError):
        kern.matvec(torch.zeros(5, device=cuda), 0.1)
    cpu_const = const[:1] + tuple(t.cpu() for t in const[1:])
    with pytest.raises(ValueError):
        ba.products(params, cpu_const, False)


@pytest.mark.parametrize('refine_focal', [False, True])
def test_ba_bundle_adjust_on_card(cuda, refine_focal):
    """bundle_adjust on the card goes through K9 (counted: one solve and 3
    residual calls an LM step, one more for the final rms, and no product
    outside the solve) and ends within 1e-3 px of the same solve with the
    plain products (and `cg` over them) on the card."""
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import ba_cuda
    start, intr, ci, pi, xy = _ba_ring(3)
    if refine_focal:
        intr = (440.0, 440.0, 320.0, 240.0)
    _kernels.reset_launches()
    stats = {}
    got = ba.bundle_adjust(*start, intr, ci, pi, xy, max_iters=8,
                           refine_focal=refine_focal, cg_iters=20,
                           device=cuda, stats=stats)
    lm = stats['lm']
    assert _kernels.launches[ba_cuda.NAMES[2]] == lm
    assert _kernels.launches[ba_cuda.NAMES[1]] == 0
    assert _kernels.launches[ba_cuda.NAMES[0]] == lm * 3 + 1
    assert all(0 < int(k) <= 20 for k in stats['cg'])
    saved = ba.products, ba.residual
    ba.products = lambda params, const, refine_focal, layout=None: \
        ba.PlainProducts(params, const, refine_focal)
    ba.residual = ba._residual
    try:
        want = ba.bundle_adjust(*start, intr, ci, pi, xy, max_iters=8,
                                refine_focal=refine_focal, cg_iters=20,
                                device=cuda)
    finally:
        ba.products, ba.residual = saved
    assert abs(got[4] - want[4]) <= 1e-3, (got[4], want[4])
    # the rms counts the 3% outliers (up to 40 px): it falls, not to the
    # noise
    before = ba.bundle_adjust(*start, intr, ci, pi, xy, max_iters=0,
                              device=cuda)[4]
    assert got[4] < 0.8 * before, (got[4], before)
    if refine_focal:
        assert abs(got[3][0] - 400.0) < 0.5 * 40.0, got[3]


def _ba_solve_inputs(cuda, refine_focal, seed=0):
    from autolabel_tpu_torch.mapping import ba
    params, const = _ba_inputs(cuda, *_ba_ring(seed))
    kern = ba.products(params, const, refine_focal)
    return params, const, kern, -kern.residual_grad()[2]


@pytest.mark.parametrize('lam,maxiter', [(1e-2, 20), (1e8, 50)])
@pytest.mark.parametrize('refine_focal', [False, True])
def test_ba_cg_solve_matches_the_loop(cuda, refine_focal, lam, maxiter):
    """K9's fused solve (one launch, counted once) against cg(frozen=True)
    over K9's matvec entry and over the plain products: k equal, and the
    delta within 1e-4 by relative norm, or no farther from the float64
    solve than 2x the loop (chip_smoke.py's rule: with refine_focal the
    focal and the depths nearly trade off, and fp32 rounding moves every
    fp32 solve); at lam = 1e8 the test stops it before maxiter, at 1e-2 it
    runs to maxiter. Bit-equal across two calls (no atomics, the sums in a
    fixed order)."""
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import ba_cuda
    params, const, kern, b = _ba_solve_inputs(cuda, refine_focal)
    _kernels.reset_launches()
    x, k = kern.cg_solve(b, lam, maxiter)
    torch.cuda.synchronize()
    assert dict(_kernels.launches) == {ba_cuda.NAMES[2]: 1}
    x2, k2 = kern.cg_solve(b, lam, maxiter)
    assert torch.equal(x, x2) and int(k) == int(k2)
    loop, k_loop = ba.cg(lambda v: kern.matvec(v, lam), b, kern.m, kern.p,
                         maxiter, frozen=True)
    plain = ba.PlainProducts(params, const, refine_focal)
    ref, k_ref = plain.cg_solve(b, lam, maxiter)
    assert bool(torch.isfinite(x).all())
    assert int(k) == int(k_loop) == int(k_ref)
    assert (int(k) < maxiter) == (lam == 1e8), int(k)
    p64 = tuple(t.double() for t in params)
    c64 = const[:3] + (const[3].double(), const[4].double())
    x64 = ba.PlainProducts(p64, c64, refine_focal).cg_solve(
        b.double(), lam, maxiter)[0]
    for want in (loop, ref):
        assert _rel(x, want) <= 1e-4 or \
            _rel(x, x64) <= 2 * _rel(want, x64), (_rel(x, want),
                                                  _rel(x, x64),
                                                  _rel(want, x64))
    mask = ba.gauge_mask(kern.m, kern.p, refine_focal, cuda)
    assert not bool((x * (1 - mask)).any())


@pytest.mark.parametrize('refine_focal', [False, True])
def test_ba_cg_solve_first_product_matches_the_matvec(cuda, refine_focal):
    """The solve's own product (its first iteration's Aq, the focal entry
    summed over its blocks with refine_focal) against K9's matvec entry
    within 1e-5 by relative norm, and the focal entry alone within 1e-5."""
    params, const, kern, b = _ba_solve_inputs(cuda, refine_focal)
    aq, mv = kern.solve_product(b, 1e-2), kern.matvec(b, 1e-2)
    assert _rel(aq, mv) <= 1e-5, _rel(aq, mv)
    if refine_focal:
        assert _rel(aq[-1:], mv[-1:]) <= 1e-5, (float(aq[-1]), float(mv[-1]))


def test_ba_cg_solve_at_clamp_and_tie(cuda):
    """The solve on observations at the depth clamp and at a tie (products
    of order 1e20) against cg(frozen=True) over K9's matvec entry."""
    from autolabel_tpu_torch.mapping import ba
    rv = np.array([[0.1, -0.2, 0.05], [0.0, 0.0, 0.0], [0.02, 0.3, -0.1]])
    tv = np.array([[0.1, 0.0, 3.0], [0.0, 0.0, float(np.float32(1e-6))],
                   [-0.5, 0.1, 3.5]])
    pts = np.array([[0.2, -0.1, -0.5], [0.3, 0.2, 0.0], [0.1, 0.1, 1.0],
                    [-0.4, 0.2, 1.5], [0.5, -0.3, 2.0], [0.0, 0.4, 0.8]])
    ci, pi = np.repeat(np.arange(3), 6), np.tile(np.arange(6), 3)
    xy = np.random.default_rng(0).uniform(0, 600, (18, 2))
    params, const = _ba_inputs(cuda, (rv, tv, pts), (500.0, 500.0, 320.0,
                                                     240.0), ci, pi, xy)
    for refine in (False, True):
        kern = ba.products(params, const, refine)
        b = -kern.residual_grad()[2]
        x, k = kern.cg_solve(b, 1e-2, 10)
        loop, k_loop = ba.cg(lambda v: kern.matvec(v, 1e-2), b, 3, 6, 10,
                             frozen=True)
        assert int(k) == int(k_loop), (int(k), int(k_loop))
        assert _rel(x, loop) <= 1e-4, (refine, _rel(x, loop))


def test_ba_cg_solve_refuses_what_it_does_not_take(cuda):
    """CPU tensors (K9's wrapper never falls back), observations out of
    camera order, and a grid larger than the card holds resident (the
    cooperative launch's refusal, raised naming K9)."""
    from autolabel_tpu_torch.mapping import ba
    from autolabel_tpu_torch.ops import ba_cuda
    params, const, kern, b = _ba_solve_inputs(cuda, False)
    with pytest.raises(ValueError, match='CUDA'):
        kern.cg_solve(b.cpu(), 1e-2, 5)
    unsorted = ba.products(*_ba_inputs(cuda, *_ba_ring(0), order=False),
                           False)
    with pytest.raises(ValueError, match='camera order'):
        unsorted.cg_solve(b, 1e-2, 5)
    grid = ba_cuda.solve_grid(cuda.index or 0)
    with pytest.raises(RuntimeError, match='K9'):
        kern.cg_solve(b, 1e-2, 5, grid=grid + 1)
    x, k = kern.cg_solve(b, 1e-2, 5, grid=grid)
    assert int(k) == 5
