"""Checkpoint I/O under the reference's directory contract.

Counterpart of autolabel_tpu/train/checkpoints.py. Files live at
<scene>/nerf/<model-hash>/checkpoints/*.pth; the loader prefers best.pth,
else the lexicographically-last file. Payloads are plain pickles of numpy
pytrees {'model', 'ema', 'global_step', ['optimizer']}, so checkpoints
written by either package load in the other. Reference torch.save
archives are not read by the port yet.
"""
import glob
import os
import pickle
import zipfile

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def save_checkpoint(path, state, extra=None, include_optimizer=True):
    """state: dict with 'params', 'ema', 'step' and, when
    include_optimizer, 'opt_state' trees (tensors or numpy arrays)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        'model': _to_numpy(state['params']),
        'ema': _to_numpy(state['ema']),
        'global_step': int(state['step']),
    }
    if include_optimizer:
        payload['optimizer'] = _to_numpy(state['opt_state'])
    if extra:
        payload.update(extra)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


class _Opaque:
    """Stands in for a class of another framework in a pickled payload
    (the JAX package's optimizer state is optax namedtuples): it absorbs
    the pickled arguments, so reading a checkpoint imports nothing of
    that framework."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _PayloadUnpickler(pickle.Unpickler):
    """Numpy arrays and builtins load as themselves; any other class loads
    as an _Opaque placeholder."""

    def find_class(self, module, name):
        if module.split('.')[0] in ('numpy', 'builtins', 'collections',
                                    'copyreg', 'ml_dtypes'):
            return super().find_class(module, name)
        return type(name, (_Opaque,), {'__module__': module})


def load_checkpoint_file(path):
    """A pickled numpy payload written by either package."""
    if zipfile.is_zipfile(path):
        raise NotImplementedError(
            f'{path} is a torch.save archive (a reference checkpoint); the '
            'port does not import those yet')
    with open(path, 'rb') as f:
        payload = _PayloadUnpickler(f).load()
    if isinstance(payload, int):  # legacy torch.save magic number
        raise NotImplementedError(
            f'{path} is a legacy torch.save file; the port does not import '
            'those yet')
    return payload


def find_checkpoint(checkpoint_dir):
    """best.pth if present, else the lexicographically-last *.pth."""
    checkpoint_list = sorted(glob.glob(f'{checkpoint_dir}/*.pth'))
    if not checkpoint_list:
        return None
    best = [c for c in checkpoint_list if 'best.pth' in c]
    return best[0] if best else checkpoint_list[-1]


def load_checkpoint(checkpoint_dir):
    """Returns the checkpoint payload dict, or None if none exists."""
    path = find_checkpoint(checkpoint_dir)
    if path is None:
        return None
    return load_checkpoint_file(path)
