"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs alone with
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from autolabel_tpu_torch.ops import _kernels, hashgrid_cuda, heads_cuda
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.ops.mlp import mlp_init

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


@pytest.mark.parametrize('classes,n,weight_dtype', [
    (6, 1000, torch.float32), (2, 333, torch.bfloat16)])
def test_head_kernels_match_plain(cuda, classes, n, weight_dtype):
    """fp32 weights are cast by the wrapper; bf16 ones (packed and cast
    once, as Field does) go to the kernel as they are. n = 333 leaves a
    partial tile of points."""
    g = torch.Generator().manual_seed(1)
    params = _head_params(g, cuda, classes=classes)
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


def test_head_kernel_rejects_widths_beyond_its_tiles(cuda):
    g = torch.Generator().manual_seed(2)
    params = _head_params(g, cuda, semantic=256)
    packed = heads_cuda.pack_head_weights(params, 12)
    A = torch.zeros((16, 128), device=cuda)
    B = torch.zeros((16, 32), device=cuda)
    with pytest.raises(ValueError):
        heads_cuda.fused_heads(packed, A, B)
