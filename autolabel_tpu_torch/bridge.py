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
