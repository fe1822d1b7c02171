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

from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
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


def test_encode_backward_refuses_the_point_gradient(cuda):
    config = HashGridConfig(n_levels=2, n_features=8, log2_hashmap_size=8)
    table = torch.zeros((2, 256, 8), device=cuda, requires_grad=True)
    x = torch.rand((10, 3), device=cuda, requires_grad=True)
    out = hashgrid_cuda.hashgrid_encode(table, x, config)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


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
