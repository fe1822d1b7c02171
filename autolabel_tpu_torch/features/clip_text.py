"""CLIP's text tower and its byte-pair tokenizer, the open-vocabulary
query side.

Counterpart of autolabel_tpu/features/clip_text_jax.py: the same
parameter tree (init_params, load_openai_state_dict, load_hf_state_dict),
the OpenAI forward (token and position embeddings, causal pre-LN blocks
with QuickGELU, LayerNorm eps 1e-5, the final LayerNorm, pooling at the
per-row argmax id, the text projection), the lowercased BPE tokenizer
reading `bpe_simple_vocab_16e6.txt.gz`, and CLIPTextEncoder on local
files (AUTOLABEL_CLIP_WEIGHTS + AUTOLABEL_CLIP_BPE). Only the weights and
the merges file come from outside; nothing is downloaded.
"""
import dataclasses
import gzip
import html
import os
import re

import numpy as np
import torch

from autolabel_tpu_torch.bridge import tree_from_numpy
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features.layers import (attention, dense,
                                                 full_precision, layer_norm)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 512
    depth: int = 12
    heads: int = 8
    context_length: int = 77
    embed_dim: int = 512

    @property
    def head_dim(self):
        return self.width // self.heads


CLIP_VIT_B = CLIPTextConfig()
CLIP_VIT_L = CLIPTextConfig(width=768, depth=12, heads=12, embed_dim=768)


def init_params(generator, config=CLIP_VIT_B, device='cpu'):
    """Random parameter tree in the loaders' layout (clip_text_jax.
    init_params' scales), drawn on the CPU from `generator`."""
    w = config.width

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def dense_init(d_in, d_out):
        return {'w': normal(d_in, d_out) * (2.0 / (d_in + d_out)) ** 0.5,
                'b': torch.zeros(d_out)}

    def norm():
        return {'scale': torch.ones(w), 'bias': torch.zeros(w)}

    params = {
        'token_embedding': normal(config.vocab_size, w) * 0.02,
        'pos_embed': normal(config.context_length, w) * 0.01,
        'ln_final': norm(),
        'text_projection': normal(w, config.embed_dim) * w ** -0.5,
        'blocks': [],
    }
    for _ in range(config.depth):
        params['blocks'].append({
            'ln1': norm(), 'ln2': norm(),
            'qkv': dense_init(w, 3 * w), 'proj': dense_init(w, w),
            'fc1': dense_init(w, 4 * w), 'fc2': dense_init(4 * w, w)})
    return tree_from_numpy(params, device)


# -- weight import -----------------------------------------------------------


def _t(array):
    if isinstance(array, torch.Tensor):
        return array.detach().to('cpu', torch.float32).clone()
    return torch.as_tensor(np.asarray(array, np.float32))


def infer_depth(state_dict, prefix):
    depth = 0
    while any(k.startswith(f'{prefix}{depth}.') for k in state_dict):
        depth += 1
    return depth


def _shape(state_dict, key, axis=0):
    return int(np.shape(state_dict[key])[axis])


def load_openai_state_dict(state_dict, config=None):
    """OpenAI `clip` naming (token_embedding.weight, positional_embedding,
    transformer.resblocks.N.*, ln_final, text_projection); visual.* keys
    are ignored. config=None infers the shape from the checkpoint, with
    64-wide heads. Returns (params on the CPU, config)."""
    if config is None:
        width = _shape(state_dict, 'ln_final.weight')
        config = CLIPTextConfig(
            vocab_size=_shape(state_dict, 'token_embedding.weight'),
            width=width,
            depth=infer_depth(state_dict, 'transformer.resblocks.'),
            heads=max(1, width // 64),
            context_length=_shape(state_dict, 'positional_embedding'),
            embed_dim=_shape(state_dict, 'text_projection', 1))
    s = state_dict
    params = {
        'token_embedding': _t(s['token_embedding.weight']),
        'pos_embed': _t(s['positional_embedding']),
        'ln_final': {'scale': _t(s['ln_final.weight']),
                     'bias': _t(s['ln_final.bias'])},
        'text_projection': _t(s['text_projection']),
        'blocks': [],
    }
    for i in range(config.depth):
        pre = f'transformer.resblocks.{i}.'
        params['blocks'].append({
            'ln1': {'scale': _t(s[pre + 'ln_1.weight']),
                    'bias': _t(s[pre + 'ln_1.bias'])},
            'ln2': {'scale': _t(s[pre + 'ln_2.weight']),
                    'bias': _t(s[pre + 'ln_2.bias'])},
            'qkv': {'w': _t(s[pre + 'attn.in_proj_weight']).T.contiguous(),
                    'b': _t(s[pre + 'attn.in_proj_bias'])},
            'proj': {'w': _t(s[pre + 'attn.out_proj.weight']).T.contiguous(),
                     'b': _t(s[pre + 'attn.out_proj.bias'])},
            'fc1': {'w': _t(s[pre + 'mlp.c_fc.weight']).T.contiguous(),
                    'b': _t(s[pre + 'mlp.c_fc.bias'])},
            'fc2': {'w': _t(s[pre + 'mlp.c_proj.weight']).T.contiguous(),
                    'b': _t(s[pre + 'mlp.c_proj.bias'])},
        })
    return params, config


def load_hf_state_dict(state_dict, config=None):
    """HuggingFace CLIPTextModelWithProjection naming
    (text_model.encoder.layers.N.self_attn.{q,k,v,out}_proj, ...).
    Returns (params on the CPU, config)."""
    s = state_dict
    if config is None:
        width = _shape(s, 'text_model.final_layer_norm.weight')
        config = CLIPTextConfig(
            vocab_size=_shape(
                s, 'text_model.embeddings.token_embedding.weight'),
            width=width,
            depth=infer_depth(s, 'text_model.encoder.layers.'),
            heads=max(1, width // 64),
            context_length=_shape(
                s, 'text_model.embeddings.position_embedding.weight'),
            embed_dim=_shape(s, 'text_projection.weight'))
    params = {
        'token_embedding': _t(
            s['text_model.embeddings.token_embedding.weight']),
        'pos_embed': _t(s['text_model.embeddings.position_embedding.weight']),
        'ln_final': {'scale': _t(s['text_model.final_layer_norm.weight']),
                     'bias': _t(s['text_model.final_layer_norm.bias'])},
        # HF keeps the projection as a Linear (out, in); OpenAI (in, out).
        'text_projection': _t(s['text_projection.weight']).T.contiguous(),
        'blocks': [],
    }
    for i in range(config.depth):
        pre = f'text_model.encoder.layers.{i}.'
        qkv_w = torch.cat([_t(s[pre + f'self_attn.{k}_proj.weight']).T
                           for k in ('q', 'k', 'v')], dim=1)
        qkv_b = torch.cat([_t(s[pre + f'self_attn.{k}_proj.bias'])
                           for k in ('q', 'k', 'v')])
        params['blocks'].append({
            'ln1': {'scale': _t(s[pre + 'layer_norm1.weight']),
                    'bias': _t(s[pre + 'layer_norm1.bias'])},
            'ln2': {'scale': _t(s[pre + 'layer_norm2.weight']),
                    'bias': _t(s[pre + 'layer_norm2.bias'])},
            'qkv': {'w': qkv_w, 'b': qkv_b},
            'proj': {'w': _t(s[pre + 'self_attn.out_proj.weight']).T
                     .contiguous(),
                     'b': _t(s[pre + 'self_attn.out_proj.bias'])},
            'fc1': {'w': _t(s[pre + 'mlp.fc1.weight']).T.contiguous(),
                    'b': _t(s[pre + 'mlp.fc1.bias'])},
            'fc2': {'w': _t(s[pre + 'mlp.fc2.weight']).T.contiguous(),
                    'b': _t(s[pre + 'mlp.fc2.bias'])},
        })
    return params, config


# -- forward ------------------------------------------------------------------


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def encode_tokens(params, tokens, config=CLIP_VIT_B):
    """tokens: (B, context) int ids, zero-padded after <|endoftext|> ->
    (B, embed_dim) unnormalised text embeddings, taken at each row's
    largest id (the EOT token). Runs where params live, in their dtype."""
    device = params['token_embedding'].device
    tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=device).long()
    n = tokens.shape[1]
    x = params['token_embedding'][tokens] + params['pos_embed'][:n]
    for block in params['blocks']:
        x = x + attention(layer_norm(x, block['ln1'], 1e-5), block,
                          config.heads, causal=True)
        h = dense(layer_norm(x, block['ln2'], 1e-5), block['fc1'])
        x = x + dense(quick_gelu(h), block['fc2'])
    x = layer_norm(x, params['ln_final'], 1e-5)
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=device), eot]
    return pooled @ params['text_projection']


# -- tokenizer ----------------------------------------------------------------


def bytes_to_unicode():
    """GPT-2's byte <-> printable-unicode table (the BPE works on these)."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('\xa1'), ord('\xac') + 1)) +
          list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_SPECIAL = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
# The stdlib re module has no \p{L} / \p{N}: without the `regex` package
# (the card's machine has none) words split on ASCII classes, which
# tokenizes English prompts as CLIP does.
ASCII_WORD_PAT = re.compile(_SPECIAL + r"|[a-z]+|[0-9]|[^\sa-z0-9]+",
                            re.IGNORECASE)
try:
    import regex as _regex
    UNICODE_WORD_PAT = _regex.compile(
        _SPECIAL + r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", _regex.IGNORECASE)
except ImportError:
    UNICODE_WORD_PAT = None
WORD_PAT = UNICODE_WORD_PAT or ASCII_WORD_PAT


class SimpleTokenizer:
    """CLIP's lowercased byte-pair tokenizer.

    bpe_path: the `bpe_simple_vocab_16e6.txt.gz` merges file (or a plain
    file of that format: a header line, then one merge pair a line);
    merges: the pairs themselves, in place of a file. Vocabulary: the 256
    byte symbols, their '</w>' forms, one token a merge, then
    <|startoftext|> and <|endoftext|>. pattern: the word splitter
    (WORD_PAT by default).
    """

    MAX_MERGES = 49152 - 256 - 2

    def __init__(self, bpe_path=None, merges=None, pattern=None):
        if merges is None:
            opener = gzip.open if bpe_path.endswith('.gz') else open
            with opener(bpe_path, 'rt', encoding='utf-8') as f:
                lines = f.read().split('\n')
            merges = [tuple(line.split()) for line in
                      lines[1:self.MAX_MERGES + 1]
                      if len(line.split()) == 2]
        merges = [tuple(m) for m in merges]
        self.pattern = pattern or WORD_PAT
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [v + '</w>' for v in vocab]
        vocab += [''.join(merge) for merge in merges]
        vocab += ['<|startoftext|>', '<|endoftext|>']
        self.encoder = {token: i for i, token in enumerate(vocab)}
        self.bpe_ranks = {merge: i for i, merge in enumerate(merges)}
        self.sot = self.encoder['<|startoftext|>']
        self.eot = self.encoder['<|endoftext|>']
        self._cache = {}

    def _bpe(self, token):
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    def encode(self, text):
        """One string -> list of BPE ids (no SOT/EOT)."""
        text = html.unescape(html.unescape(text))
        text = re.sub(r'\s+', ' ', text).strip().lower()
        ids = []
        for token in self.pattern.findall(text):
            token = ''.join(self.byte_encoder[b]
                            for b in token.encode('utf-8'))
            ids.extend(self.encoder[t] for t in self._bpe(token))
        return ids

    def tokenize(self, texts, context_length=77):
        """list of strings -> (N, context_length) int32, zero-padded, in
        <|startoftext|> ... <|endoftext|> framing (clip.tokenize, cutting
        overlong prompts)."""
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = ([self.sot] + self.encode(text)[:context_length - 2]
                   + [self.eot])
            out[i, :len(ids)] = ids
        return out


def read_state(weights):
    """A CLIP checkpoint as a state dict: a TorchScript archive
    (torch.jit.load) or a plain, possibly nested, state dict."""
    try:
        return torch.jit.load(weights, map_location='cpu').state_dict()
    except RuntimeError:  # not a TorchScript archive
        state = torch.load(weights, map_location='cpu', weights_only=True)
        return state.get('state_dict', state)


class CLIPTextEncoder:
    """Prompt -> unit-norm embedding, from local files.

    weights: an OpenAI CLIP checkpoint (a .pt TorchScript archive or a
    plain state dict) or an HF CLIP state dict; bpe: the merges file.
    device: None (the card; raises without one) or a torch device.
    """

    def __init__(self, weights, bpe, device=None):
        self.device = resolve_device(device)
        state = {k: v for k, v in read_state(weights).items()
                 if not k.startswith('visual.')}
        if any(k.startswith('text_model.') for k in state):
            params, self.config = load_hf_state_dict(state)
        else:
            params, self.config = load_openai_state_dict(state)
        self.params = tree_from_numpy(params, self.device)
        self.tokenizer = SimpleTokenizer(bpe)

    def encode_text(self, prompts):
        """list of N strings -> unit-norm (N, embed_dim) float32 numpy."""
        tokens = self.tokenizer.tokenize(list(prompts),
                                         self.config.context_length)
        if tokens.max() >= self.config.vocab_size:
            # an out-of-range id would raise inside the lookup; name the
            # cause instead
            raise ValueError(
                f"tokenizer produced id {int(tokens.max())} outside the "
                f"checkpoint's vocab ({self.config.vocab_size}); the BPE "
                "file and weights are mismatched.")
        with torch.no_grad(), full_precision():
            features = encode_tokens(self.params, tokens,
                                     self.config).cpu().numpy()
        return features / np.linalg.norm(features, axis=-1, keepdims=True)


def from_env(device=None):
    """CLIPTextEncoder from AUTOLABEL_CLIP_WEIGHTS + AUTOLABEL_CLIP_BPE, or
    None when either is unset or missing."""
    weights = os.environ.get('AUTOLABEL_CLIP_WEIGHTS')
    bpe = os.environ.get('AUTOLABEL_CLIP_BPE')
    if weights and bpe and os.path.exists(weights) and os.path.exists(bpe):
        return CLIPTextEncoder(weights, bpe, device)
    return None
