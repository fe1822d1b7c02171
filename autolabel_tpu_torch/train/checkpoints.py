"""Checkpoint I/O under the reference's directory contract.

Counterpart of autolabel_tpu/train/checkpoints.py. Files live at
<scene>/nerf/<model-hash>/checkpoints/*.pth; the loader prefers best.pth,
else the lexicographically-last file. Payloads are plain pickles of numpy
pytrees {'model', 'ema', 'global_step', ['optimizer']}, so checkpoints
written by either package load in the other. Reference (torch-ngp)
torch.save archives, zip or legacy, are read by torch.load with
weights_only=True, which refuses arbitrary globals as the JAX package's
torch-free reader (utils/torch_zip.py) does; their tensors come back as
numpy arrays (torch_import.py maps them onto the param tree).
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


def load_torch_file(path):
    """A torch.save archive (zip or legacy) with every tensor as a numpy
    array. weights_only admits tensors, containers, numbers and strings,
    and refuses any other global (an nn.Module, say) with an
    UnpicklingError. The globals the JAX package's reader admits beside
    the tensors' (OrderedDict, torch.Size) are on weights_only's own
    list, so no safe_globals are added."""
    return _tensors_to_numpy(torch.load(path, map_location='cpu',
                                        weights_only=True))


def _tensors_to_numpy(tree):
    """Tensors -> numpy arrays (bfloat16 widened to float32, which numpy
    lacks; exact), containers rebuilt, every other value kept."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            tree = tree.float()
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return type(tree)((k, _tensors_to_numpy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors_to_numpy(v) for v in tree)
    return tree


def load_checkpoint_file(path):
    """The payload of a checkpoint file: a pickled numpy payload written by
    either package, or a reference torch.save archive."""
    if zipfile.is_zipfile(path):
        return load_torch_file(path)
    with open(path, 'rb') as f:
        payload = _PayloadUnpickler(f).load()
    if isinstance(payload, int):  # legacy torch.save magic number
        return load_torch_file(path)
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
