"""DemoCLIP: a small text and pixel teacher trained into one shared
embedding space on a labelled scene.

Counterpart of autolabel_tpu/features/demo_clip.py: a convolutional pixel
tower (a stride-2 stem, two dilated 3x3s, a 1x1 projection to 512) and a
small CLIP text tower (features/clip_text.py, 192 wide, 3 blocks, on a
character-level vocabulary) trained against each other by InfoNCE over
the classes of each labelled pixel, with synonym and compositional
prompts and wrong-pairing hard negatives. After training, phrasings never
seen in training embed near the pixels they describe, so the open-
vocabulary paths get real semantics with no weights from outside.

The checkpoint is the JAX package's .npz: the leaves of the parameter
tree as leaf_{i} in jax.tree_util.tree_flatten's order (dict keys sorted,
lists in order, convolutions HWIO) and a `meta` JSON with the text
config and the prompt bank, so a checkpoint either package trains loads
and encodes in the other.

The trainer draws every batch (frames, crops, synonyms, negatives) from
np.random.default_rng(seed) in the JAX package's order, so both train on
the same batches; only the initial params (a torch.Generator here,
jax.random there) differ, and `init` takes JAX's. Its optimiser is
optax's chain written out on one flat buffer of the params: warmup (0 to
lr over max(iters // 20, 1) updates) then cosine decay to 0 at `iters`,
clip_by_global_norm(1.0), adam (eps 1e-8), and apply_if_finite(100),
all on the device with no host sync a step.
"""
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from autolabel_tpu_torch.bridge import (tree_from_numpy, tree_leaves,
                                        tree_to_numpy, tree_unflatten)
from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features import clip_text
from autolabel_tpu_torch.features.layers import (as_images, conv_nhwc,
                                                 full_precision,
                                                 same_padding)
from autolabel_tpu_torch.train.optim import adam_direction
from autolabel_tpu_torch.utils.images import read_png

FEATURE_DIM = 512
STRIDE = 2

_TEXT_CONFIG = dict(vocab_size=514, width=192, depth=3, heads=6,
                    context_length=32, embed_dim=FEATURE_DIM)

MAX_NORM = 1.0
MAX_CONSECUTIVE_ERRORS = 100
BATCH = 8


def _char_tokenizer():
    """Character-level tokenizer: no merge rules, so tokens are single
    bytes and any ASCII prompt is encodable. 514 ids: 256 bytes, their
    256 word-final forms, SOT and EOT."""
    return clip_text.SimpleTokenizer(merges=[])


# -- pixel tower --------------------------------------------------------------


def init_pixel_params(generator, hidden=64, device='cpu'):
    """He-normal HWIO kernels (demo_clip.init_pixel_params' scales)."""
    def conv(k, c_in, c_out):
        return (torch.randn((k, k, c_in, c_out), generator=generator)
                * (2.0 / (k * k * c_in)) ** 0.5)

    return tree_from_numpy({'conv1': conv(3, 3, hidden),
                            'conv2': conv(3, hidden, hidden),
                            'conv3': conv(3, hidden, hidden),
                            'proj': conv(1, hidden, FEATURE_DIM)}, device)


def _same_conv(x, w, stride=1, dilation=1):
    k = w.shape[0]
    pads = tuple(same_padding(x.shape[axis], k, stride, dilation)
                 for axis in (1, 2))
    return conv_nhwc(x, w, stride=stride, padding=pads, dilation=dilation)


def apply_pixel_tower(params, images):
    """images: (B, H, W, 3) in [0, 1] -> (B, ceil(H/2), ceil(W/2), 512)
    unit-norm features. XLA's 'SAME' padding: the stride-2 stem pads
    (0, 1) on an even axis and (1, 1) on an odd one."""
    x = images - 0.5
    x = torch.relu(_same_conv(x, params['conv1'], stride=STRIDE))
    x = torch.relu(_same_conv(x, params['conv2'], dilation=2))
    x = torch.relu(_same_conv(x, params['conv3'], dilation=4))
    x = _same_conv(x, params['proj'])
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


# -- prompt bank --------------------------------------------------------------

ROOM_PROMPT_BANK = {
    1: ['wall', 'the wall', 'a checkered wall', 'background',
        'the room walls', 'wall of the room'],
    2: ['red ball', 'a red ball', 'the red sphere', 'red round object',
        'a ball that is red', 'crimson ball'],
    3: ['green box', 'a green box', 'the green cube', 'green crate',
        'a box that is green', 'green block'],
    4: ['blue ball', 'a blue ball', 'the blue sphere', 'blue round object',
        'a ball that is blue', 'azure ball'],
    5: ['yellow pillar', 'a yellow pillar', 'the yellow column',
        'tall yellow box', 'a pillar that is yellow', 'yellow post'],
}

# (colours, nouns) of the room's attribute-bearing classes.
ROOM_ATTRIBUTES = {
    2: (['red', 'crimson', 'scarlet'],
        ['ball', 'sphere', 'orb', 'round object']),
    3: (['green', 'emerald'], ['box', 'cube', 'crate', 'block']),
    4: (['blue', 'azure'], ['ball', 'sphere', 'orb', 'round object']),
    5: (['yellow', 'golden'], ['pillar', 'column', 'post']),
}

_TEMPLATES = [
    '{c} {n}', 'a {c} {n}', 'the {c} {n}',
    '{n} colored {c}', 'a {n} colored {c}', 'the {n} colored {c}',
    '{c} colored {n}', 'a {n} that is {c}', 'the {n} in {c}',
    '{n} of {c} color',
]


def compositional_prompts(attributes):
    """(positives, negatives): every template over each class's own
    (colour, noun) pairs, and every template over the pairs no class owns
    ('red box'), sorted, which join the softmax as distractor columns."""
    positives = {}
    for cid, (colors, nouns) in attributes.items():
        positives[cid] = [t.format(c=c, n=n) for t in _TEMPLATES
                          for c in colors for n in nouns]
    negatives = []
    for _, (colors_a, _) in attributes.items():
        for _, (_, nouns_b) in attributes.items():
            for c in colors_a:
                for n in nouns_b:
                    owned = any(c in cs and n in ns
                                for cs, ns in attributes.values())
                    if owned:
                        continue
                    negatives.extend(t.format(c=c, n=n)
                                     for t in _TEMPLATES)
    return positives, sorted(set(negatives))


# -- the optimiser (optax's chain, written out) -------------------------------


def warmup_cosine_lr(count, peak, warmup, decay_steps):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps) at
    `count` (a tensor of applied updates): peak * count / warmup before
    `warmup`, then peak * (1 + cos(pi t / (decay_steps - warmup))) / 2 at
    t = min(count - warmup, decay_steps - warmup)."""
    if decay_steps <= warmup:
        raise ValueError(f'the cosine decay needs decay_steps '
                         f'({decay_steps}) > warmup ({warmup})')
    span = decay_steps - warmup
    rising = peak - peak * (1.0 - torch.clamp(count, 0, warmup) / warmup)
    t = torch.clamp(count - warmup, max=span)
    falling = peak * (0.5 * (1.0 + torch.cos(math.pi * t / span)))
    return torch.where(count < warmup, rising, falling)


class FlatAdam:
    """clip_by_global_norm(MAX_NORM) -> adam(schedule) under
    apply_if_finite(MAX_CONSECUTIVE_ERRORS) on one flat fp32 buffer: the
    update is applied when every gradient is finite, or after more than
    MAX_CONSECUTIVE_ERRORS non-finite ones in a row; a rejected update
    leaves the params, the moments and the count as they were."""

    def __init__(self, flat, schedule):
        self.flat = flat
        self.schedule = schedule
        self.mu = torch.zeros_like(flat)
        self.nu = torch.zeros_like(flat)
        self.count = torch.zeros((), device=flat.device)
        self.errors = torch.zeros((), device=flat.device)

    @torch.no_grad()
    def step(self, grad):
        finite = torch.isfinite(grad).all()
        self.errors = torch.where(finite, torch.zeros_like(self.errors),
                                  self.errors + 1)
        apply = finite | (self.errors > MAX_CONSECUTIVE_ERRORS)
        norm = torch.linalg.vector_norm(grad)
        grad = torch.where(norm < MAX_NORM, grad, grad / norm * MAX_NORM)
        mu, nu, direction = adam_direction(grad, self.mu, self.nu,
                                           self.count)
        update = direction * -self.schedule(self.count)
        self.flat.add_(torch.where(apply, update, 0.0))
        self.mu = torch.where(apply, mu, self.mu)
        self.nu = torch.where(apply, nu, self.nu)
        self.count = self.count + apply.float()


# -- training -----------------------------------------------------------------


def _read_scene(scene_dir, frames_stride):
    """Every frames_stride-th gt_semantic frame and its rgb: images
    (N, H, W, 3) float32 in [0, 1], labels (N, H, W) int32."""
    rgb_dir = os.path.join(scene_dir, 'rgb')
    sem_dir = os.path.join(scene_dir, 'gt_semantic')
    names = sorted(os.listdir(sem_dir),
                   key=lambda p: int(os.path.splitext(p)[0]))
    images, labels = [], []
    for name in names[::frames_stride]:
        labels.append(read_png(os.path.join(sem_dir, name)).astype(np.int32))
        rgb = read_png(os.path.join(rgb_dir,
                                    os.path.splitext(name)[0] + '.png'))
        images.append(rgb[..., :3].astype(np.float32) / 255.0)
    return np.stack(images), np.stack(labels)


def draw_batches(rng, iters, n, h, w, crop, n_syn, n_negatives,
                 n_available):
    """Every iteration's draws from `rng`, in the JAX loop's order: frame,
    crop row and column for each of BATCH crops, a synonym a class, the
    negatives. They depend on nothing the training computes, so they are
    drawn up front and moved to the device once."""
    fi = np.empty((iters, BATCH), np.int64)
    ys = np.empty((iters, BATCH), np.int64)
    xs = np.empty((iters, BATCH), np.int64)
    syn = np.empty((iters, len(n_syn)), np.int64)
    neg = np.zeros((iters, n_negatives), np.int64)
    for it in range(iters):
        fi[it] = rng.integers(0, n, BATCH)
        ys[it] = rng.integers(0, h - crop + 1, BATCH)
        xs[it] = rng.integers(0, w - crop + 1, BATCH)
        syn[it] = rng.integers(0, n_syn)
        if n_negatives:
            neg[it] = rng.integers(0, n_available, n_negatives)
    return fi, ys, xs, syn, neg


class DemoTeacherTrainer:
    """The contrastive training of train_demo_teacher, one step at a time.

    step() draws nothing on the host: the crops are gathered on the device
    from the frames and the batches drawn up front (draw_batches).
    init: a params tree (numpy or tensors, the JAX layout) to start from;
    else the towers are drawn from torch.Generator().manual_seed(seed).
    """

    def __init__(self, scene_dir, prompt_bank=None, iters=2500, crop=96,
                 lr=2e-3, seed=0, frames_stride=4, attributes=None,
                 n_negatives=8, device=None, init=None):
        self.device = resolve_device(device)
        dev = self.device
        if attributes is None:
            attributes = ROOM_ATTRIBUTES if prompt_bank is None else {}
        prompt_bank = prompt_bank or ROOM_PROMPT_BANK
        comp_pos, negatives = (compositional_prompts(attributes)
                               if attributes else ({}, []))
        self.prompt_bank = {cid: list(dict.fromkeys(
            list(syns) + comp_pos.get(cid, [])))
            for cid, syns in prompt_bank.items()}
        n_negatives = min(n_negatives, len(negatives))
        class_ids = sorted(self.prompt_bank)
        self.config = clip_text.CLIPTextConfig(**_TEXT_CONFIG)
        tokenizer = _char_tokenizer()

        images, labels = _read_scene(scene_dir, frames_stride)
        max_syn = max(len(v) for v in self.prompt_bank.values())
        tokens = np.zeros((len(class_ids), max_syn,
                           self.config.context_length), np.int32)
        n_syn = np.zeros(len(class_ids), np.int64)
        for ci, cid in enumerate(class_ids):
            toks = tokenizer.tokenize(self.prompt_bank[cid],
                                      self.config.context_length)
            tokens[ci, :len(toks)] = toks
            n_syn[ci] = len(toks)
        neg_tokens = (tokenizer.tokenize(negatives,
                                         self.config.context_length)
                      if n_negatives else
                      np.zeros((0, self.config.context_length), np.int32))
        remap = np.full(int(max(class_ids)) + 1, -1, np.int64)
        for ci, cid in enumerate(class_ids):
            remap[cid] = ci

        n, h, w = labels.shape
        crop = min(crop, (h // STRIDE) * STRIDE, (w // STRIDE) * STRIDE)
        self.n_classes = len(class_ids)
        draws = draw_batches(np.random.default_rng(seed), iters, n, h, w,
                             crop, n_syn, n_negatives, len(negatives))
        self._fi, self._ys, self._xs, self._syn, self._neg = (
            torch.as_tensor(d, device=dev) for d in draws)
        self._images = torch.as_tensor(images, device=dev)
        self._labels = torch.as_tensor(remap[labels], device=dev)
        self._tokens = torch.as_tensor(tokens, device=dev).long()
        self._neg_tokens = torch.as_tensor(neg_tokens, device=dev).long()
        self._span = torch.arange(crop, device=dev)
        self._cells = torch.arange(0, crop, STRIDE, device=dev)

        if init is None:
            gen = torch.Generator().manual_seed(seed)
            init = {'pixel': init_pixel_params(gen),
                    'text': clip_text.init_params(gen, self.config),
                    'logit_scale': torch.tensor(2.0)}
        leaves = [torch.tensor(np.asarray(leaf), dtype=torch.float32)
                  if not isinstance(leaf, torch.Tensor) else
                  leaf.detach().float().cpu() for leaf in tree_leaves(init)]
        self._skeleton = init
        self._shapes = [leaf.shape for leaf in leaves]
        self.flat = torch.cat([leaf.reshape(-1) for leaf in leaves]).to(dev)
        self.flat.requires_grad_(True)
        warmup = max(iters // 20, 1)
        self.optimizer = FlatAdam(self.flat.data, lambda c: warmup_cosine_lr(
            c, lr, warmup, iters))
        self.it = 0

    def params(self, flat=None):
        """The params tree as views of the flat buffer."""
        flat = self.flat if flat is None else flat
        views, offset = [], 0
        for shape in self._shapes:
            size = math.prod(shape)
            views.append(flat[offset:offset + size].view(shape))
            offset += size
        return tree_unflatten(self._skeleton, views)

    def batch(self, it):
        """Iteration it's crops (B, crop, crop, 3), their stride-cell
        labels in [-1, C), synonym choices and negative choices."""
        fi, ys, xs = self._fi[it], self._ys[it], self._xs[it]
        rows = (ys[:, None] + self._span)[:, :, None]
        cols = (xs[:, None] + self._span)[:, None, :]
        crops = self._images[fi[:, None, None], rows, cols]
        # each stride cell takes its top-left pixel's label
        lab = self._labels[fi[:, None, None],
                           (ys[:, None] + self._cells)[:, :, None],
                           (xs[:, None] + self._cells)[:, None, :]]
        return crops, lab, self._syn[it], self._neg[it]

    def loss(self, params, crops, labels, syn, neg):
        """Masked InfoNCE over the classes (and negative columns) of each
        labelled stride cell: ce.sum() / max(valid.sum(), 1)."""
        pix = apply_pixel_tower(params['pixel'], crops)
        c = self.n_classes
        chosen = self._tokens[torch.arange(c, device=self.device), syn]
        chosen = torch.cat([chosen, self._neg_tokens[neg]])
        txt = clip_text.encode_tokens(params['text'], chosen, self.config)
        txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
                     + 1e-6)
        # jnp.clip's tie rule: half the gradient at a bound
        scale = torch.exp(torch.minimum(torch.maximum(
            params['logit_scale'], torch.zeros_like(params['logit_scale'])),
            torch.full_like(params['logit_scale'], 4.6)))
        logits = scale * torch.einsum('bhwd,cd->bhwc', pix, txt)
        valid = labels >= 0
        targets = labels.clamp(0, c - 1)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1), reduction='none')
        ce = torch.where(valid.reshape(-1), ce, 0.0)
        return ce.sum() / torch.clamp(valid.sum(), min=1)

    def step(self):
        """One optimiser step on the next batch; returns its loss (a
        tensor on the device)."""
        batch = self.batch(self.it)
        self.flat.grad = None
        with full_precision():
            loss = self.loss(self.params(), *batch)
            loss.backward()
            self.optimizer.step(self.flat.grad)
        self.it += 1
        return loss.detach()

    def trained(self):
        """The params tree (numpy, the JAX layout)."""
        return tree_to_numpy(self.params(self.flat.detach()))


def train_demo_teacher(scene_dir, out_path, prompt_bank=None, iters=2500,
                       crop=96, lr=2e-3, seed=0, frames_stride=4,
                       log_every=200, attributes=None, n_negatives=8,
                       device=None, init=None):
    """Contrastive text <-> pixel training on a scene with dense gt
    labels (demo_clip.train_demo_teacher); saves the .npz checkpoint to
    out_path and returns the params tree (numpy). device: None (the
    card; raises without one) or a torch device."""
    trainer = DemoTeacherTrainer(scene_dir, prompt_bank, iters, crop, lr,
                                 seed, frames_stride, attributes,
                                 n_negatives, device, init)
    for it in range(iters):
        loss = trainer.step()
        if log_every and (it % log_every == 0 or it == iters - 1):
            print(f"demo-teacher iter {it}: loss {float(loss):.4f}",
                  flush=True)
    params = trainer.trained()
    save_checkpoint(out_path, params, trainer.prompt_bank)
    return params


def save_checkpoint(path, params, prompt_bank):
    """The JAX package's .npz: leaf_{i} in tree_flatten order, and meta."""
    leaves = [np.asarray(leaf, np.float32)
              for leaf in tree_leaves(tree_to_numpy(params))]
    np.savez_compressed(
        path,
        meta=json.dumps({
            'text_config': _TEXT_CONFIG,
            'prompt_bank': {str(k): v for k, v in prompt_bank.items()},
            'n_leaves': len(leaves),
        }),
        **{f'leaf_{i}': leaf for i, leaf in enumerate(leaves)})


def _skeleton(config, hidden=64):
    def zeros(*shape):
        return np.zeros(shape, np.float32)

    w = config.width
    norm = {'scale': zeros(w), 'bias': zeros(w)}
    block = {'ln1': norm, 'ln2': norm,
             'qkv': {'w': zeros(w, 3 * w), 'b': zeros(3 * w)},
             'proj': {'w': zeros(w, w), 'b': zeros(w)},
             'fc1': {'w': zeros(w, 4 * w), 'b': zeros(4 * w)},
             'fc2': {'w': zeros(4 * w, w), 'b': zeros(w)}}
    return {
        'pixel': {'conv1': zeros(3, 3, 3, hidden),
                  'conv2': zeros(3, 3, hidden, hidden),
                  'conv3': zeros(3, 3, hidden, hidden),
                  'proj': zeros(1, 1, hidden, FEATURE_DIM)},
        'text': {'token_embedding': zeros(config.vocab_size, w),
                 'pos_embed': zeros(config.context_length, w),
                 'ln_final': norm,
                 'text_projection': zeros(w, config.embed_dim),
                 'blocks': [block] * config.depth},
        'logit_scale': zeros(),
    }


def load_checkpoint(path):
    """(params tree of numpy arrays, text config, meta) from a .npz that
    either package wrote."""
    with np.load(path, allow_pickle=False) as archive:
        meta = json.loads(str(archive['meta']))
        leaves = [archive[f'leaf_{i}'] for i in range(meta['n_leaves'])]
    config = clip_text.CLIPTextConfig(**meta['text_config'])
    skeleton = _skeleton(config)
    want = [leaf.shape for leaf in tree_leaves(skeleton)]
    got = [leaf.shape for leaf in leaves]
    if want != got:
        raise ValueError(f'{path}: leaves {got} do not match the DemoCLIP '
                         f'tree {want}')
    return tree_unflatten(skeleton, leaves), config, meta


class DemoCLIPFE:
    """The feature-extractor contract (that of LSegFE) on trained towers
    from a DemoCLIP .npz. device: None (the card; raises without one) or
    a torch device."""

    out_dim = FEATURE_DIM

    def __init__(self, checkpoint=None, allow_fallback=False, device=None):
        del allow_fallback  # a missing checkpoint raises whatever it says
        checkpoint = checkpoint or os.environ.get('AUTOLABEL_DEMO_TEACHER')
        if not checkpoint or not os.path.exists(checkpoint):
            raise RuntimeError(
                "DemoCLIP needs a trained checkpoint: pass --checkpoint "
                "(compute_feature_maps) / --feature-checkpoint "
                "(language.evaluate) or set AUTOLABEL_DEMO_TEACHER. Train "
                "one with python -m autolabel_tpu_torch.train_demo_teacher.")
        self.device = resolve_device(device)
        params, self.config, self.meta = load_checkpoint(checkpoint)
        self.params = tree_from_numpy(params, self.device)
        self.tokenizer = _char_tokenizer()

    def shape(self, input_shape):
        return (input_shape[0] // STRIDE, input_shape[1] // STRIDE)

    def encode_text(self, prompts):
        """list of N strings -> unit-norm (N, 512) float32 numpy."""
        tokens = self.tokenizer.tokenize(list(prompts),
                                         self.config.context_length)
        with torch.no_grad(), full_precision():
            emb = clip_text.encode_tokens(self.params['text'], tokens,
                                          self.config).cpu().numpy()
        return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-6)

    def __call__(self, x):
        """x: (B, 3, H, W) in [0, 1] -> (B, H/2, W/2, 512) fp16 tensor on
        the extractor's device."""
        images = as_images(x, self.device).permute(0, 2, 3, 1)
        with torch.no_grad(), full_precision():
            return apply_pixel_tower(self.params['pixel'],
                                     images).to(torch.float16)
