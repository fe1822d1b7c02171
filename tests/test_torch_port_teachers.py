"""The port's teacher towers (autolabel_tpu_torch/features/) against the
JAX package's, on the CPU, at small widths.

The same params (the JAX package's own init, carried across as numpy by
bridge.tree_from_numpy) and the same seeded inputs go through both sides
in fp32. Each forward is held to 2e-5 of its output's largest magnitude
(the two sides differ only in summation order: measured 2e-7 to 5e-6),
the fp16 outputs of the extractors to one fp16 rounding of it. Every
state-dict loader takes the same synthetic state dict in both packages
and gives the same tree. The resize rules are checked on their own:
jax.image's cubic (Keys a = -0.5, antialiased when shrinking) and
nearest rules, and lseg_jax's bilinear matrices, where torch's own
bicubic and 'nearest' differ.
"""
import gzip
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autolabel_tpu.features import (clip_text_jax, fcn_jax, lseg_jax,
                                    vit_jax)
from autolabel_tpu.features import demo_clip as jax_demo
from autolabel_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.compute_feature_maps import compression_loss
from autolabel_tpu_torch.features import (clip_text, demo_clip, dino, fcn,
                                          fcn50, feature_utils, layers,
                                          lseg, lseg_tower, vit)
from autolabel_tpu_torch.models.autoencoder import Autoencoder
from tests.test_fcn_jax import _random_torchvision_state
from tests.test_lseg_jax import TINY as JAX_TINY
from tests.test_lseg_jax import _random_lseg_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2e-5  # of the reference's largest magnitude


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    """The module's torch work on two threads (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return bridge.tree_from_numpy(_np_tree(tree), 'cpu')


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= rtol * scale, (err, scale)


def _trees_equal(ours, ref):
    ours, ref = bridge.tree_to_numpy(ours), _np_tree(ref)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))


# -- the resize rules ---------------------------------------------------------


@pytest.mark.parametrize('src,dst', [((4, 4), (7, 9)), ((28, 28), (9, 12)),
                                     ((6, 6), (3, 5)), ((5, 5), (5, 2))])
def test_cubic_resize_is_jax_image_cubic(src, dst):
    grid = np.random.default_rng(0).normal(size=(*src, 3)).astype(
        np.float32)
    ref = jax.image.resize(grid, (*dst, 3), method='cubic')
    _close(layers.cubic_resize(torch.tensor(grid), dst), ref, 1e-6)


@pytest.mark.parametrize('n_in,n_out', [(7, 3), (9, 4), (11, 5), (243, 121),
                                        (323, 161)])
def test_nearest_indices_are_jax_image_nearest(n_in, n_out):
    x = np.arange(n_in, dtype=np.float32)
    ref = np.asarray(jax.image.resize(x, (n_out,), method='nearest'))
    assert np.array_equal(x[layers.nearest_indices(n_in, n_out)], ref)


@pytest.mark.parametrize('n_out,n_in,align', [(10, 4, True), (10, 4, False),
                                              (3, 7, False), (16, 8, True),
                                              (15, 15, False)])
def test_resize_matrix_is_lseg_jax(n_out, n_in, align):
    ref = np.asarray(lseg_jax._resize_matrix(n_out, n_in, align))
    assert np.array_equal(layers.resize_matrix(n_out, n_in, align).numpy(),
                          ref)


@pytest.mark.parametrize('size,kernel,stride,dilation,want',
                         [(8, 3, 2, 1, (0, 1)), (9, 3, 2, 1, (1, 1)),
                          (8, 3, 1, 2, (2, 2)), (7, 1, 1, 1, (0, 0))])
def test_same_padding_is_xla(size, kernel, stride, dilation, want):
    assert layers.same_padding(size, kernel, stride, dilation) == want


def test_full_precision_restores_the_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with layers.full_precision():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_tree_leaves_are_tree_flatten_order():
    tree = {'b': [np.ones(1), None, {'z': np.zeros(2), 'a': np.ones(3)}],
            'a': np.full(4, 2.0)}
    ours = bridge.tree_leaves(tree)
    ref = jax.tree_util.tree_leaves(tree)
    assert [a.shape for a in ours] == [a.shape for a in ref]
    rebuilt = bridge.tree_unflatten(tree, ref)
    assert rebuilt['b'][1] is None and rebuilt['b'][2]['a'].shape == (3,)


# -- the CLIP text tower ------------------------------------------------------

SMALL_TEXT = dict(vocab_size=99, width=32, depth=2, heads=4,
                  context_length=16, embed_dim=24)


def _tokens(batch=3, seq=16, seed=0):
    """Random ids with one EOT (the largest id) a row, zeros after."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((batch, seq), np.int32)
    for i in range(batch):
        n = int(rng.integers(3, seq - 1))
        tokens[i, :n] = rng.integers(1, 90, n)
        tokens[i, n] = 98
    return tokens


def test_encode_tokens_matches_jax():
    jcfg = clip_text_jax.CLIPTextConfig(**SMALL_TEXT)
    params = clip_text_jax.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = _tokens()
    ref = clip_text_jax.encode_tokens(params, tokens, jcfg)
    got = clip_text.encode_tokens(_port(params), tokens,
                                  clip_text.CLIPTextConfig(**SMALL_TEXT))
    _close(got, ref)


def _hf_clip_state():
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(0)
    config = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, projection_dim=24, eos_token_id=98,
        hidden_act='quick_gelu')
    model = transformers.CLIPTextModelWithProjection(config).eval()
    return dict(model.state_dict())


def _openai_state(hf):
    """The HF state dict renamed to OpenAI's clip naming."""
    out = {
        'token_embedding.weight':
            hf['text_model.embeddings.token_embedding.weight'],
        'positional_embedding':
            hf['text_model.embeddings.position_embedding.weight'],
        'ln_final.weight': hf['text_model.final_layer_norm.weight'],
        'ln_final.bias': hf['text_model.final_layer_norm.bias'],
        'text_projection': hf['text_projection.weight'].T.contiguous(),
        'visual.proj': torch.zeros(3),
    }
    for i in range(2):
        src, dst = f'text_model.encoder.layers.{i}.', \
            f'transformer.resblocks.{i}.'
        out[dst + 'attn.in_proj_weight'] = torch.cat(
            [hf[src + f'self_attn.{k}_proj.weight'] for k in 'qkv'])
        out[dst + 'attn.in_proj_bias'] = torch.cat(
            [hf[src + f'self_attn.{k}_proj.bias'] for k in 'qkv'])
        for ours, theirs in (('attn.out_proj', 'self_attn.out_proj'),
                             ('ln_1', 'layer_norm1'), ('ln_2', 'layer_norm2'),
                             ('mlp.c_fc', 'mlp.fc1'),
                             ('mlp.c_proj', 'mlp.fc2')):
            for part in ('weight', 'bias'):
                out[f'{dst}{ours}.{part}'] = hf[f'{src}{theirs}.{part}']
    return out


@pytest.mark.parametrize('naming', ['hf', 'openai'])
def test_clip_loaders_match_jax(naming):
    hf = _hf_clip_state()
    state = hf if naming == 'hf' else _openai_state(hf)
    load = {'hf': 'load_hf_state_dict',
            'openai': 'load_openai_state_dict'}[naming]
    ours, config = getattr(clip_text, load)(state)
    ref, jconfig = getattr(clip_text_jax, load)(state)
    assert config.__dict__ == jconfig.__dict__
    _trees_equal(ours, ref)
    tokens = _tokens()
    _close(clip_text.encode_tokens(ours, tokens, config),
           clip_text_jax.encode_tokens(ref, tokens, jconfig))


def _merges(path, compress):
    lines = ['bpe test vocab v0', 't h', 'th e</w>', 'c a', 'ca t</w>',
             'r e', 'd o', 'do g</w>', 'Ã ©']
    content = '\n'.join(lines) + '\n'
    if compress:
        with gzip.open(path, 'wt', encoding='utf-8') as f:
            f.write(content)
    else:
        with open(path, 'w', encoding='utf-8') as f:
            f.write(content)
    return str(path)


PROMPTS = ['The cat, the dog!', 'a red  ball', "it's 42 cats",
           'café crème', '&amp; the DOG', 'x' * 40]


@pytest.mark.parametrize('pattern', ['unicode', 'ascii'])
def test_tokenizer_matches_jax(tmp_path, monkeypatch, pattern):
    """Both word splitters: with `regex` (unicode classes) and the ASCII
    one the card's machine takes without it."""
    path = _merges(tmp_path / 'bpe.txt.gz', compress=True)
    if pattern == 'ascii':
        monkeypatch.setattr(clip_text_jax, '_WORD_PAT',
                            clip_text.ASCII_WORD_PAT)
        ours = clip_text.SimpleTokenizer(path,
                                         pattern=clip_text.ASCII_WORD_PAT)
    else:
        assert clip_text.WORD_PAT is clip_text.UNICODE_WORD_PAT
        ours = clip_text.SimpleTokenizer(path)
    ref = clip_text_jax.SimpleTokenizer(path)
    assert ours.encoder == ref.encoder
    for prompt in PROMPTS:
        assert ours.encode(prompt) == ref.encode(prompt), prompt
    assert np.array_equal(ours.tokenize(PROMPTS, 12),
                          ref.tokenize(PROMPTS, 12))
    if pattern == 'ascii':
        # the splitters differ on non-ASCII letters only
        unicode = clip_text.SimpleTokenizer(path)
        assert unicode.encode('café') != ours.encode('café')
        assert unicode.encode('the cat') == ours.encode('the cat')


def test_char_tokenizer_is_demo_clips():
    ours = demo_clip._char_tokenizer()
    ref = jax_demo._char_tokenizer()
    assert len(ours.encoder) == 514 and ours.encoder == ref.encoder
    assert np.array_equal(ours.tokenize(PROMPTS, 32),
                          ref.tokenize(PROMPTS, 32))


def test_clip_text_encoder_from_env(tmp_path, monkeypatch):
    hf = _hf_clip_state()
    weights = tmp_path / 'clip.pt'
    torch.save(_openai_state(hf), weights)
    bpe = _merges(tmp_path / 'bpe.txt', compress=False)
    monkeypatch.setenv('AUTOLABEL_CLIP_WEIGHTS', str(weights))
    monkeypatch.setenv('AUTOLABEL_CLIP_BPE', bpe)
    ours = clip_text.from_env('cpu')
    ref = clip_text_jax.from_env()
    # the test vocab is 9 merges: ids past 98 are out of the 99-id
    # checkpoint, which both refuse
    for enc in (ours, ref):
        with pytest.raises(ValueError, match='vocab'):
            enc.encode_text(['the cat'])
    monkeypatch.setattr(ours.tokenizer, 'tokenize',
                        lambda texts, n: _tokens(len(texts), n))
    monkeypatch.setattr(ref.tokenizer, 'tokenize',
                        lambda texts, n: _tokens(len(texts), n))
    got, want = ours.encode_text(['a', 'b', 'c']), ref.encode_text(
        ['a', 'b', 'c'])
    assert got.dtype == np.float32
    _close(got, want)
    monkeypatch.delenv('AUTOLABEL_CLIP_BPE')
    assert clip_text.from_env('cpu') is None


# -- the ViT and DINO ---------------------------------------------------------

SMALL_VIT = dict(patch_size=8, width=48, depth=2, heads=3, mlp_ratio=4)


@pytest.mark.parametrize('hw', [(32, 32), (24, 40), (48, 56), (16, 16)],
                         ids=['same', 'mixed', 'up', 'down'])
def test_encode_image_matches_jax(hw):
    """The 4 x 4 position grid kept, resized up (6 x 7), down (2 x 2) and
    both ways (3 x 5) by the cubic rule."""
    jcfg = vit_jax.ViTConfig(**SMALL_VIT)
    params = vit_jax.init_params(jax.random.PRNGKey(1), jcfg, pos_grid=4)
    x = np.random.default_rng(1).normal(size=(2, 3, *hw)).astype(np.float32)
    _close(vit.encode_image(_port(params), torch.tensor(x),
                            vit.ViTConfig(**SMALL_VIT)),
           vit_jax.encode_image(params, x, jcfg))


def _hf_vit_state():
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(2)
    config = transformers.ViTConfig(
        hidden_size=384, num_hidden_layers=2, num_attention_heads=6,
        intermediate_size=1536, image_size=32, patch_size=8,
        layer_norm_eps=1e-6)
    return dict(transformers.ViTModel(config, add_pooling_layer=False)
                .eval().state_dict())


def _timm_state(hf):
    """The HF ViT state dict renamed to DINO's timm naming."""
    out = {'patch_embed.proj.weight':
           hf['embeddings.patch_embeddings.projection.weight'],
           'patch_embed.proj.bias':
           hf['embeddings.patch_embeddings.projection.bias'],
           'cls_token': hf['embeddings.cls_token'],
           'pos_embed': hf['embeddings.position_embeddings'],
           'norm.weight': hf['layernorm.weight'],
           'norm.bias': hf['layernorm.bias']}
    for i in range(2):
        src, dst = f'encoder.layer.{i}.', f'blocks.{i}.'
        for part in ('weight', 'bias'):
            out[f'{dst}attn.qkv.{part}'] = torch.cat(
                [hf[f'{src}attention.attention.{k}.{part}']
                 for k in ('query', 'key', 'value')])
            for ours, theirs in (('attn.proj', 'attention.output.dense'),
                                 ('norm1', 'layernorm_before'),
                                 ('norm2', 'layernorm_after'),
                                 ('mlp.fc1', 'intermediate.dense'),
                                 ('mlp.fc2', 'output.dense')):
                out[f'{dst}{ours}.{part}'] = hf[f'{src}{theirs}.{part}']
    return out


@pytest.mark.parametrize('naming', ['hf', 'timm'])
def test_vit_loaders_match_jax(naming):
    hf = _hf_vit_state()
    state = hf if naming == 'hf' else _timm_state(hf)
    load = {'hf': 'load_hf_state_dict',
            'timm': 'load_timm_state_dict'}[naming]
    ours = getattr(vit, load)(state)
    ref = getattr(vit_jax, load)(state)
    _trees_equal(ours, ref)


def test_dino_matches_jax(tmp_path, monkeypatch):
    """AUTOLABEL_DINO_WEIGHTS (a timm-named checkpoint under 'student',
    'module.backbone.' prefixes): ImageNet-normalised, fp16 out."""
    state = {f'module.backbone.{k}': v
             for k, v in _timm_state(_hf_vit_state()).items()}
    path = tmp_path / 'dino.pth'
    torch.save({'student': state}, path)
    monkeypatch.setenv('AUTOLABEL_DINO_WEIGHTS', str(path))
    ours = feature_utils.get_feature_extractor('dino', device='cpu')
    assert isinstance(ours, dino.Dino) and ours.config.depth == 2
    x = np.random.default_rng(3).random((2, 3, 24, 40)).astype(np.float32)
    params = vit_jax.load_timm_state_dict(dino.read_dino_state(str(path)))
    norm = ((x - jax_dino_mean()) / jax_dino_std()).astype(np.float32)
    ref = np.asarray(vit_jax.encode_image(params, norm,
                                          vit_jax.ViTConfig(depth=2)))
    got = ours(x)
    assert got.dtype == torch.float16 and ours.shape((24, 40)) == (3, 5)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-3,
                               atol=1e-5 * np.abs(ref).max())


def jax_dino_mean():
    from autolabel_tpu.features import dino as jax_dino
    return jax_dino._IMAGENET_MEAN[None, :, None, None]


def jax_dino_std():
    from autolabel_tpu.features import dino as jax_dino
    return jax_dino._IMAGENET_STD[None, :, None, None]


# -- the ResNet and the FCN head ----------------------------------------------


def test_hf_resnet_backbone_matches_jax():
    """The HF naming, reduced depths (1, 2), the classification strides."""
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(4)
    config = transformers.ResNetConfig(
        num_channels=3, embedding_size=8, hidden_sizes=[16, 32],
        depths=[1, 2], layer_type='bottleneck')
    model = transformers.ResNetModel(config).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    state = dict(model.state_dict())
    ours = fcn.load_hf_resnet_state_dict(state, depths=(1, 2))
    ref = fcn_jax.load_hf_resnet_state_dict(state, depths=(1, 2))
    _trees_equal(bridge.tree_from_numpy(ours, 'cpu'), ref)
    x = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    _close(fcn.backbone_forward(bridge.tree_from_numpy(ours, 'cpu'),
                                torch.tensor(x), strides=(1, 2),
                                dilations=(1, 1)),
           fcn_jax.backbone_forward(ref, x, strides=(1, 2),
                                    dilations=(1, 1)))


@pytest.mark.parametrize('depths,hw', [((1, 1, 1, 1), (40, 56)),
                                       ((2, 1, 2, 1), (33, 47))])
def test_fcn_features_match_jax(depths, hw):
    """torchvision's naming, the segmentation dilations (output stride
    8), an odd size too."""
    state = _random_torchvision_state(np.random.default_rng(5), depths)
    ours = fcn.load_torchvision_state_dict(state)
    ref = fcn_jax.load_torchvision_state_dict(state)
    _trees_equal(bridge.tree_from_numpy(ours, 'cpu'), ref)
    x = np.random.default_rng(6).random((2, 3, *hw)).astype(np.float32)
    _close(fcn.fcn_features(bridge.tree_from_numpy(ours, 'cpu'),
                            torch.tensor(x)),
           fcn_jax.fcn_features(ref, x))


def test_fcn50_matches_jax(tmp_path, monkeypatch):
    """AUTOLABEL_FCN50_WEIGHTS into the port's ResNet (the JAX package
    takes its own port there, torchvision being absent)."""
    state = {k: torch.as_tensor(v) for k, v in
             _random_torchvision_state(np.random.default_rng(7)).items()}
    path = tmp_path / 'fcn.pth'
    torch.save({'model': state}, path)
    monkeypatch.setenv('AUTOLABEL_FCN50_WEIGHTS', str(path))
    from autolabel_tpu.features.fcn50 import FCN50 as JaxFCN50
    ours = feature_utils.get_feature_extractor('fcn50', device='cpu')
    assert isinstance(ours, fcn50.FCN50)
    x = np.random.default_rng(8).random((1, 3, 32, 48)).astype(np.float32)
    got = ours(x)
    ref = JaxFCN50()(x)
    assert got.dtype == torch.float16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               rtol=2e-3, atol=1e-4)
    torch.save({'model': {'backbone.conv1.weight': torch.zeros(1)}}, path)
    with pytest.raises(RuntimeError, match='does not match'):
        fcn50.FCN50(device='cpu')


# -- LSeg ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def lseg_state():
    return _random_lseg_state(np.random.default_rng(9))


def test_lseg_loader_matches_jax(lseg_state):
    ours, config = lseg_tower.load_lseg_state_dict(lseg_state)
    ref, jconfig = lseg_jax.load_lseg_state_dict(lseg_state)
    assert config.hooks == jconfig.hooks == (0, 1, 2, 3)
    assert config.neck_dims == jconfig.neck_dims
    _trees_equal(ours, ref)
    assert lseg_tower.default_hooks(24) == lseg_jax.default_hooks(24)


@pytest.mark.parametrize('hw', [(48, 80), (50, 70)])
def test_compute_features_matches_jax(lseg_state, hw):
    """Sides that are and are not multiples of the 16-pixel patch."""
    ours, config = lseg_tower.load_lseg_state_dict(lseg_state)
    ref, jconfig = lseg_jax.load_lseg_state_dict(lseg_state)
    x = np.random.default_rng(10).random((1, 3, *hw)).astype(np.float32)
    _close(lseg_tower.compute_features(bridge.tree_from_numpy(ours, 'cpu'),
                                       torch.tensor(x), config),
           lseg_jax.compute_features(ref, x, jconfig))


def test_hf_dpt_neck_overlay_matches_jax():
    transformers = pytest.importorskip('transformers')
    from transformers.models.dpt.modeling_dpt import DPTNeck
    torch.manual_seed(11)
    t = JAX_TINY
    neck = DPTNeck(transformers.DPTConfig(
        hidden_size=t.vit.width, num_hidden_layers=t.vit.depth,
        num_attention_heads=t.vit.heads, intermediate_size=128,
        image_size=64, patch_size=16, neck_hidden_sizes=list(t.neck_dims),
        fusion_hidden_size=t.features, reassemble_factors=[4, 2, 1, 0.5],
        readout_type='project', is_hybrid=False)).eval()
    state = dict(neck.state_dict())
    config = lseg_tower.LSegConfig(
        vit=vit.ViTConfig(patch_size=16, width=32, depth=4, heads=2),
        hooks=t.hooks, neck_dims=t.neck_dims, features=t.features,
        out_dim=t.out_dim)
    ours = lseg_tower.load_hf_dpt_neck_state_dict(state, {}, config)
    ref = lseg_jax.load_hf_dpt_neck_state_dict(state, {}, t)
    _trees_equal(ours, ref)
    rng = np.random.default_rng(11)
    tokens = [rng.normal(size=(2, 5 * 3 + 1, 32)).astype(np.float32) * 0.5
              for _ in range(4)]
    _close(lseg_tower.neck(ours, [torch.tensor(a) for a in tokens], 5, 3,
                           config),
           lseg_jax.neck(ref, tokens, 5, 3, t))


@pytest.mark.parametrize('hw', [(64, 96), (63, 95), (64, 97)],
                         ids=['even', 'odd', 'mixed'])
def test_lseg_image_encoder_matches_jax(lseg_state, hw):
    """[-1, 1], half size (every other pixel on even sides, jax.image's
    nearest rule otherwise), then the tower."""
    ours = lseg_tower.LSegImageEncoder(
        *lseg_tower.load_lseg_state_dict(lseg_state), device='cpu')
    ref = lseg_jax.LSegImageEncoder(*lseg_jax.load_lseg_state_dict(
        lseg_state))
    x = np.random.default_rng(12).random((2, 3, *hw)).astype(np.float32)
    got = ours(x)
    assert got.dtype == torch.float32
    assert got.shape[1:3] == ours.shape(hw)
    _close(got, ref(x))


def test_lseg_fe_from_env(lseg_state, tmp_path, monkeypatch):
    """The image tower from AUTOLABEL_LSEG_WEIGHTS (a lightning-style
    checkpoint), text from the hash stand-in only with allow_fallback."""
    path = tmp_path / 'demo_e200.ckpt'
    torch.save({'state_dict': {k: torch.as_tensor(v)
                               for k, v in lseg_state.items()},
                'epoch': 200}, path)
    monkeypatch.setenv('AUTOLABEL_LSEG_WEIGHTS', str(path))
    monkeypatch.delenv('AUTOLABEL_CLIP_WEIGHTS', raising=False)
    fe = feature_utils.get_feature_extractor('lseg', device='cpu')
    assert isinstance(fe, lseg.LSegFE) and fe.out_dim == 24
    x = np.random.default_rng(13).random((1, 3, 64, 64)).astype(np.float32)
    from autolabel_tpu.features.lseg import LSegFE as JaxLSegFE
    _close(fe(x), JaxLSegFE()(x))
    with pytest.raises(RuntimeError, match='allow-fallback'):
        fe.encode_text(['chair'])
    stand_in = lseg.LSegFE(str(path), allow_fallback=True, device='cpu')
    assert stand_in.encode_text(['chair']).shape == (1, 24)


# -- the DemoCLIP pixel tower and the autoencoder -----------------------------


@pytest.mark.parametrize('hw', [(8, 8), (9, 11), (10, 7), (32, 48)])
def test_pixel_tower_matches_jax(hw):
    """XLA's 'SAME' padding on even and odd sides."""
    params = jax_demo.init_pixel_params(jax.random.PRNGKey(2))
    x = np.random.default_rng(14).random((2, *hw, 3)).astype(np.float32)
    got = demo_clip.apply_pixel_tower(_port(params), torch.tensor(x))
    _close(got, jax_demo.apply_pixel_tower(params, x))
    assert got.shape[1:3] == (-(-hw[0] // 2), -(-hw[1] // 2))


def test_autoencoder_loss_with_jax_dropout_mask():
    """compute_feature_maps' loss on the same params and batch, the port
    fed jax.random.bernoulli's keep-mask."""
    coder = JaxAutoencoder(64, 16)
    params = coder.init(jax.random.PRNGKey(0))
    batch = np.random.default_rng(15).normal(size=(256, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(1)

    def jax_loss(p):
        reconstructed, code = coder.apply(p, batch, key=key)
        return (jnp.mean((reconstructed - batch) ** 2)
                + 0.01 * jnp.mean(jnp.abs(code)))

    ref, ref_grads = jax.value_and_grad(jax_loss)(params)
    keep = np.asarray(jax.random.bernoulli(key, 0.9, (256, 16)))
    ours = Autoencoder(64, 16)
    tree = {k: [torch.tensor(np.asarray(w), requires_grad=True)
                for w in ws] for k, ws in params.items()}
    loss = compression_loss(ours, tree, torch.tensor(batch),
                            keep=torch.tensor(keep))
    loss.backward()
    _close(loss.detach(), ref)
    for k in tree:
        for w, g in zip(tree[k], ref_grads[k]):
            _close(w.grad, g)
    without = compression_loss(ours, tree, torch.tensor(batch))
    code = ours.encode(tree, torch.tensor(batch))
    assert float(without) < float(loss) and code.shape == (256, 16)


# -- the dispatch -------------------------------------------------------------


@pytest.mark.parametrize('teacher', ['fcn50', 'dino', 'lseg', 'demo'])
def test_teachers_without_weights_raise(teacher, monkeypatch):
    for var in ('AUTOLABEL_DINO_WEIGHTS', 'AUTOLABEL_FCN50_WEIGHTS',
                'AUTOLABEL_LSEG_WEIGHTS', 'AUTOLABEL_CLIP_WEIGHTS',
                'AUTOLABEL_DEMO_TEACHER'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError):
        feature_utils.get_feature_extractor(teacher, device='cpu')
    if teacher != 'demo':
        stand_in = feature_utils.get_feature_extractor(
            teacher, allow_fallback=True)
        x = np.random.default_rng(0).random((1, 3, 32, 32))
        assert stand_in(x).shape == (1, *stand_in.shape((32, 32)),
                                     stand_in.out_dim)
    with pytest.raises(NotImplementedError):
        feature_utils.get_feature_extractor('vgg')


def test_towers_without_a_card_raise(lseg_state, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    path = tmp_path / 'lseg.npz'
    np.savez(path, **lseg_state)
    monkeypatch.setenv('AUTOLABEL_LSEG_WEIGHTS', str(path))
    with pytest.raises(RuntimeError, match='CUDA'):
        lseg.LSegFE()
    with pytest.raises(RuntimeError, match='CUDA'):
        fcn.FCN(fcn.load_torchvision_state_dict(
            _random_torchvision_state(np.random.default_rng(0))))


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = '''
import sys
import autolabel_tpu_torch.features.feature_utils
import autolabel_tpu_torch.utils.feature_utils
import autolabel_tpu_torch.compute_feature_maps
import autolabel_tpu_torch.train_demo_teacher
for m in ('dino', 'fcn50', 'lseg', 'demo_clip', 'vit', 'fcn', 'lseg_tower',
          'clip_text', 'layers'):
    __import__('autolabel_tpu_torch.features.' + m)
import autolabel_tpu_torch.models.autoencoder
print('BAD', sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'autolabel_tpu')))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert 'BAD []' in out, out
