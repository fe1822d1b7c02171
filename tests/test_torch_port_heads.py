"""The port's head kernels' plain versions (autolabel_tpu_torch.ops.heads_cuda)
and mlp_apply against the JAX package.

The JAX fused kernels run in interpret mode on the CPU, where both
packages compute in fp32. Tolerance rtol=1e-4: the same fp32 products,
summed in another order (padded vs split products).
"""
import jax
import numpy as np
import pytest
import torch

from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops import heads_pallas as jax_heads
from autolabel_tpu.ops import mlp as jax_mlp
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu_torch.ops import _kernels, heads_cuda, mlp

RTOL, ATOL = 1e-4, 1e-5
GRID = dict(n_levels=4, n_features=8, log2_hashmap_size=10,
            base_resolution=8, per_level_scale=1.6)


def _params(seed=0, semantic_classes=5, proposal=True, semantic_dim=64):
    field = JaxField(JaxFieldConfig(encoding='hg+freq', hidden_dim=64,
                                    hidden_dim_color=64,
                                    hidden_dim_semantic=semantic_dim,
                                    semantic_classes=semantic_classes,
                                    grid=JaxGridConfig(**GRID),
                                    proposal=proposal))
    return jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(seed)))


def _torch_tree(params):
    return {k: ([torch.tensor(w) for w in v] if isinstance(v, list)
                else {kk: torch.tensor(vv) for kk, vv in v.items()})
            for k, v in params.items()}


def _blocks(n, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(n, 32)) * 0.1).astype(np.float32)
    B = np.zeros((n, 128), np.float32)
    B[:, :12] = rng.uniform(-1, 1, (n, 12))
    B[:, 16:32] = rng.normal(size=(n, 16)) * 0.3
    return A, B


def test_supported_gate():
    params = _torch_tree(_params())
    assert heads_cuda.supported(params, 12)
    assert not heads_cuda.supported(params, 17)
    assert not heads_cuda.supported({'sigma_net': []}, 12)


def test_pack_head_weights_matches_jax():
    """The port pads to 16, the JAX package to 128: each real block sits at
    the same place in both, and the JAX packing is zero beyond ours."""
    params = _params()
    ours = heads_cuda.pack_head_weights(_torch_tree(params), 12)
    ref = jax_heads.pack_head_weights(params, 12)
    assert len(ours) == len(ref) == 14
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape[0] % 16 == 0 and a.shape[1] % 16 == 0
        np.testing.assert_array_equal(a, b[:a.shape[0], :a.shape[1]])
        assert not b[a.shape[0]:].any() and not b[:, a.shape[1]:].any()


@pytest.mark.parametrize('semantic_classes,semantic_dim',
                         [(5, 64), (2, 64), (5, 256)])
def test_fused_heads_plain_matches_jax(semantic_classes, semantic_dim):
    """semantic_dim 256: the feature head spans two of the kernels'
    128-column passes."""
    params = _params(semantic_classes=semantic_classes,
                     semantic_dim=semantic_dim)
    A, B = _blocks(300)
    packed = heads_cuda.pack_head_weights(_torch_tree(params), 12)
    out1, feats, logits = heads_cuda.fused_heads(
        packed, torch.tensor(A), torch.tensor(B[:, :packed[1].shape[0]]))
    r1, rf, rl = jax_heads.fused_heads(
        jax_heads.pack_head_weights(params, 12), A, B)
    r1, rf, rl = np.asarray(r1), np.asarray(rf), np.asarray(rl)
    w = out1.shape[1]
    np.testing.assert_allclose(out1.numpy(), r1[:, :w], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), rf[:, :feats.shape[1]],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), rl[:, :logits.shape[1]],
                               rtol=RTOL, atol=ATOL)
    # Padding lanes stay exactly zero (the layout invariant).
    assert float(out1[:, 4:].abs().max()) == 0.0
    assert float(logits[:, semantic_classes:].abs().max()) == 0.0


def test_heads_reference_matches_jax_and_the_fused_plain_version():
    params = _params()
    A, B = _blocks(200, seed=2)
    ours = heads_cuda.heads_reference(_torch_tree(params), 12,
                                      torch.tensor(A), torch.tensor(B))
    ref = jax_heads.heads_reference(params, 12, A, B)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    packed = heads_cuda.pack_head_weights(_torch_tree(params), 12)
    fused = heads_cuda.fused_heads_plain(packed, torch.tensor(A),
                                         torch.tensor(B[:, :32]))
    np.testing.assert_allclose(fused[0][:, :4].numpy(),
                               ours[0][:, :4].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused[1].numpy(), ours[1].numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused[2][:, :5].numpy(), ours[2].numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('n', [257, 1])
def test_fused_mlp3_plain_matches_jax(n):
    params = _params()
    X = np.random.default_rng(3).uniform(-1, 1, (n, 36)).astype(np.float32)
    ours = heads_cuda.fused_mlp3(
        heads_cuda.pack_mlp3([torch.tensor(w) for w in params['proposal']]),
        torch.tensor(X))
    ref = np.asarray(jax_heads.fused_mlp3(
        jax_heads.pack_mlp3(params['proposal']), X))
    assert ours.shape == (n, 16)
    np.testing.assert_allclose(ours.numpy(), ref[:, :ours.shape[1]],
                               rtol=RTOL, atol=ATOL)
    assert float(ours[:, 1:].abs().max()) == 0.0
    for a, b in zip(heads_cuda.pack_mlp3(
            [torch.tensor(w) for w in params['proposal']]),
            jax_heads.pack_mlp3(params['proposal'])):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a, b[:a.shape[0], :a.shape[1]])
        assert not b[a.shape[0]:].any() and not b[:, a.shape[1]:].any()


def test_mlp_apply_with_segments_matches_jax():
    params = _params()
    rng = np.random.default_rng(4)
    freq = rng.uniform(-1, 1, (100, 12)).astype(np.float32)
    grid = rng.normal(size=(100, 32)).astype(np.float32)
    ours = mlp.mlp_apply([torch.tensor(w) for w in params['sigma_net']],
                         [torch.tensor(freq), torch.tensor(grid)])
    ref = jax_mlp.mlp_apply(params['sigma_net'], [freq, grid])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    whole = mlp.mlp_apply([torch.tensor(w) for w in params['sigma_net']],
                          torch.tensor(np.concatenate([freq, grid], -1)))
    np.testing.assert_allclose(whole.numpy(), ours.numpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError):
        mlp.mlp_apply([torch.tensor(w) for w in params['sigma_net']],
                      [torch.tensor(freq)])


def test_narrow_segments_stay_fp32():
    """Segments narrower than 32 are multiplied in fp32 even when the
    compute dtype is bf16 (ops/mlp.py's rule)."""
    rng = np.random.default_rng(5)
    w = torch.tensor(rng.normal(size=(8, 4)).astype(np.float32))
    x = torch.tensor(rng.normal(size=(10, 8)).astype(np.float32))
    out = mlp.mlp_apply([w], [x], compute_dtype=torch.bfloat16)
    torch.testing.assert_close(out, x @ w, rtol=1e-6, atol=1e-6)


def test_cpu_heads_launch_no_kernel():
    _kernels.reset_launches()
    params = _params()
    A, B = _blocks(20)
    packed = heads_cuda.pack_head_weights(_torch_tree(params), 12)
    heads_cuda.fused_heads(packed, torch.tensor(A), torch.tensor(B[:, :32]))
    heads_cuda.fused_mlp3(
        heads_cuda.pack_mlp3([torch.tensor(w) for w in params['proposal']]),
        torch.zeros((4, 36)))
    assert _kernels.launches[heads_cuda.HEADS] == 0
    assert _kernels.launches[heads_cuda.MLP3] == 0
