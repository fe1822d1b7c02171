"""Conversion between the JAX package's param tree and the port's Field.

The JAX params (and every checkpoint's 'model'/'ema' entry) are a pytree of
numpy arrays: 'sigma_net', 'color_net', 'semantic_features',
'semantic_out' and optionally 'proposal' are lists of (in, out) matrices,
'encoder' is {'grid': (L, T, F)} or {}. The Field's state_dict uses the
same keys flattened ('sigma_net.0', 'encoder.grid', ...), shapes and
layouts, so the conversion is a renaming. The same conversion carries any
tree of that layout, the trainer's EMA copy of the params included. Joint
pose refinement's deltas, {'pose': {'rot': (N, 3), 't': (N, 3)}} in a
tree, are 'pose.rot' and 'pose.t' in the trainer's state; they are not
Field state, so params_from_numpy and load_params leave them out.
"""
import numpy as np
import torch

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.models.field import HEAD_KEYS

_LIST_KEYS = HEAD_KEYS + ('proposal',)
# Camera-refinement deltas that training stores beside the field's params;
# they are not Field state.
_NON_FIELD_KEYS = ('pose',)


def params_from_numpy(tree, device):
    """JAX params tree -> Field state dict (tensors on `device`)."""
    device = resolve_device(device)
    state = {}
    for key, value in tree.items():
        if key in _NON_FIELD_KEYS:
            continue
        if key in _LIST_KEYS:
            for i, w in enumerate(value):
                state[f'{key}.{i}'] = torch.tensor(np.asarray(w),
                                                      device=device)
        elif key == 'encoder':
            for name, w in value.items():
                state[f'encoder.{name}'] = torch.tensor(np.asarray(w),
                                                           device=device)
        else:
            raise ValueError(f'unknown param group {key!r}')
    return state


def state_to_numpy(state):
    """Field state dict (name -> tensor, e.g. the trainer's EMA copy) ->
    JAX params tree of numpy arrays."""
    tree = {}
    for name, p in state.items():
        group, _, index = name.partition('.')
        value = p.detach().cpu().numpy()
        if group in ('encoder',) + _NON_FIELD_KEYS:
            tree.setdefault(group, {})[index] = value
        else:
            tree.setdefault(group, []).append((int(index), value))
    tree.setdefault('encoder', {})
    for key in _LIST_KEYS:
        if key in tree:
            tree[key] = [v for _, v in sorted(tree[key])]
    return tree


def params_to_numpy(field):
    """Field -> JAX params tree of numpy arrays."""
    return state_to_numpy(field.state_dict())


def load_params(field, tree):
    """Load a JAX params tree into `field` in place (on its device)."""
    field.load_state_dict(params_from_numpy(tree, field.device))
    return field


# -- the teacher towers' trees ------------------------------------------------
#
# The towers (features/) keep the JAX package's parameter trees as they are
# (dicts, lists and None, with the same keys and layouts), so one pair of
# conversions carries each of them (CLIP text, the DemoCLIP pixel tower, the
# ViT, the ResNet with its FCN head, LSeg) across both ways.


def tree_from_numpy(tree, device, dtype=torch.float32):
    """A tree of numpy arrays (or tensors) -> the same tree of tensors on
    `device` in `dtype`."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device, dtype) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def tree_to_numpy(tree):
    """A tree of tensors (or numpy arrays) -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return None if tree is None else np.asarray(tree)


def tree_leaves(tree):
    """The leaves in jax.tree_util.tree_flatten's order: dict keys sorted,
    lists in order, None an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(skeleton, leaves):
    """`leaves` (tree_leaves' order) placed into a tree shaped like
    `skeleton`."""
    leaves = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return None if node is None else next(leaves)

    tree = build(skeleton)
    if next(leaves, None) is not None:
        raise ValueError('more leaves than the skeleton holds')
    return tree
