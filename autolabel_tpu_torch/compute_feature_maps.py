"""Offline teacher-feature extraction -> <scene>/features.hdf.

    python -m autolabel_tpu_torch.compute_feature_maps <scene> --features
        {fcn50,dino,lseg,demo} [--checkpoint C] [--dim 64] [--autoencode]
        [--allow-fallback] [--vis] [--video out.mp4]

Counterpart of scripts/compute_feature_maps.py, with its flags: every rgb
frame, resized bilinearly (utils.images.resize_linear_cv2, cv2's taps) so
that its short side is 720 px (242 for lseg and demo), goes through the
teacher in batches of 2; the maps (their first --dim channels, or all of
them compressed to --dim by the bottleneck autoencoder with
--autoencode) are written as float16 lzf under features/<name>, with a
pickled PCA(3) of 50,000 rows drawn at numpy seed 0 and its min and range
in the dataset's attrs.

Extraction (extract_features) and compression (compress_features) return
tensors on the device. With --autoencode the full maps wait in host
memory, as the JAX CLI keeps them, and go to the card one 2,048-row batch
and one frame's encode at a time; the card holds only the codes. So host
memory bounds a scene: LSeg's fp32 maps at 121 x 161 x 512 take 39.9 MB a
frame (under 2,600 frames in 96 GiB), DINO's fp16 maps at 90 x 120 x 384
8.3 MB; the codes at --dim 64 take 2.5 and 1.4 MB a frame on the card.
Only the write needs h5py and the PCA sklearn
(--vis also matplotlib, --video cv2), and main raises naming whichever is
missing before it extracts anything. It runs on the card; tests call
main([...], device='cpu').
"""
import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

from autolabel_tpu_torch.device import resolve_device
from autolabel_tpu_torch.features.feature_utils import get_feature_extractor
from autolabel_tpu_torch.models.autoencoder import Autoencoder
from autolabel_tpu_torch.train.optim import adam_update
from autolabel_tpu_torch.utils import Scene, require
from autolabel_tpu_torch.utils.images import (image_size, read_image,
                                              resize_linear_cv2)

BATCH_SIZE = 2
PCA_ROWS = 50000


def read_args(argv=None):
    """scripts/compute_feature_maps.py's flags; argv defaults to
    sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('scene')
    parser.add_argument('--vis', action='store_true')
    parser.add_argument('--video',
                        type=str,
                        help="Create video of maps and write to this path.")
    parser.add_argument('--features',
                        type=str,
                        choices=['fcn50', 'dino', 'lseg', 'demo'])
    parser.add_argument('--checkpoint',
                        type=str,
                        help="Which model weights to use.")
    parser.add_argument('--dim', type=int, default=64)
    parser.add_argument('--autoencode', action='store_true')
    parser.add_argument('--allow-fallback', action='store_true',
                        help="Permit deterministic stand-in features "
                        "when real teacher weights are unavailable "
                        "(testing only).")
    return parser.parse_args(argv)


def compression_loss(coder, params, batch, keep=None, generator=None):
    """MSE of the reconstruction plus 0.01 times the code's mean |.|,
    the code dropped out by `keep` or a draw from `generator`."""
    reconstructed, code = coder.apply(params, batch, keep=keep,
                                      generator=generator)
    return (torch.mean((reconstructed - batch) ** 2)
            + 0.01 * torch.mean(torch.abs(code)))


def compress_features(features, dim, epochs=5, batch_size=2048, lr=1e-3,
                      seed=0, device=None):
    """Train the bottleneck autoencoder on `features` (N, H, W, C), a
    tensor on the host or on `device` (default: its own), and return the
    codes (N, H, W, dim) fp16 on `device`. Each batch of rows, and each
    frame to encode, is gathered where the features lie and moved to
    `device` as fp32. The rows' order comes from np.random.default_rng(0)
    as in the JAX CLI; the init and the dropout from torch generators
    seeded `seed` and seed + 1 (jax.random keys there)."""
    device = features.device if device is None else torch.device(device)
    n, h, w, c = features.shape
    data = features.reshape(n * h * w, c)
    coder = Autoencoder(c, dim)
    params = coder.init(torch.Generator().manual_seed(seed), device)
    weights = [wt for key in ('encoder', 'decoder') for wt in params[key]]
    for wt in weights:
        wt.requires_grad_(True)
    moments = [(torch.zeros_like(wt), torch.zeros_like(wt))
               for wt in weights]
    dropout = torch.Generator(device=device).manual_seed(seed + 1)
    rng = np.random.default_rng(0)
    n_batches = math.ceil(len(data) / batch_size)
    count = 0
    for _ in range(epochs):
        order = rng.permutation(len(data))
        pad = n_batches * batch_size - len(order)
        # the last batch is filled from the epoch's start (static shapes)
        order = torch.as_tensor(np.concatenate([order, order[:pad]]),
                                device=data.device)
        for b in range(n_batches):
            batch = data[order[b * batch_size:(b + 1) * batch_size]].to(
                device).float()
            loss = compression_loss(coder, params, batch,
                                    generator=dropout)
            grads = torch.autograd.grad(loss, weights)
            with torch.no_grad():
                for wt, g, (mu, nu) in zip(weights, grads, moments):
                    adam_update(wt, g, mu, nu, count, lr)
            count += 1
    with torch.no_grad():
        return torch.stack([
            coder.encode(params,
                         features[i].to(device).reshape(h * w, c).float())
            .to(torch.float16).reshape(h, w, dim) for i in range(n)])


def compute_size(image_path, feature):
    """(H, W) the frames are resized to: the short side 720 px, or 242
    for the half-resolution 512-d teachers (lseg, demo)."""
    W, H = image_size(image_path)
    short_side = min(H, W)
    target_size = 242 if feature in ('lseg', 'demo') else 720
    scale_factor = target_size / short_side
    return int(H * scale_factor), int(W * scale_factor)


def load_frame(path, size):
    """An rgb frame as (3, H, W) float32 in [0, 1] at size (H, W)."""
    image = read_image(path).astype(np.float32)[..., :3]
    image = resize_linear_cv2(image, (size[1], size[0])) / 255.0
    return image.transpose(2, 0, 1)


def extract_features(extractor, scene, flags, device, timings=None):
    """Every frame through the teacher, 2 at a time -> (N, h, w, dim)
    fp16 on `device`: the first --dim channels, or with --autoencode the
    codes compress_features makes from the full maps, which are kept in
    host memory. timings: a list that gets each batch's (frames, seconds)
    from read to map stored."""
    paths = scene.rgb_paths()
    size = compute_size(paths[0], flags.features)
    maps = None
    for start in range(0, len(paths), BATCH_SIZE):
        t0 = time.perf_counter()
        batch = paths[start:start + BATCH_SIZE]
        images = np.stack([load_frame(p, size) for p in batch])
        out = torch.as_tensor(extractor(images), device=device)
        if not flags.autoencode:
            out = out[..., :flags.dim].to(torch.float16)
        if maps is None:
            maps = torch.empty((len(paths), *out.shape[1:]), dtype=out.dtype,
                               device='cpu' if flags.autoencode else device)
        maps[start:start + len(batch)] = out
        if timings is not None:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            timings.append((len(batch), time.perf_counter() - t0))
    if flags.autoencode:
        return compress_features(maps, flags.dim, device=device)
    return maps


def pca_attrs(maps, decomposition):
    """The PCA(3) of PCA_ROWS rows drawn at numpy seed 0 (with
    replacement), its transformed rows' min and range: the features.hdf
    attrs."""
    n, h, w, c = maps.shape
    X = maps.reshape(n * h * w, c)
    indices = np.random.RandomState(0).randint(0, X.shape[0],
                                               size=PCA_ROWS)
    pca = decomposition.PCA(n_components=3)
    transformed = pca.fit_transform(X[indices])
    minimum = transformed.min(axis=0)
    maximum = transformed.max(axis=0)
    return pca, minimum, maximum - minimum


def write_features(path, name, maps, decomposition, h5py):
    """features/<name> (fp16, lzf) with its PCA attrs into `path`."""
    maps = maps.cpu().numpy()
    pca, minimum, span = pca_attrs(maps, decomposition)
    with h5py.File(path, 'w', libver='latest') as f:
        dataset = f.create_group('features').create_dataset(
            name, data=maps, dtype=np.float16, compression='lzf')
        dataset.attrs['pca'] = np.void(pickle.dumps(pca))
        dataset.attrs['min'] = minimum
        dataset.attrs['range'] = span


def _mapped(feature, pca, minimum, span):
    h, w, c = feature.shape
    mapped = pca.transform(feature.reshape(h * w, c)).reshape(h, w, 3)
    return np.clip((mapped - minimum) / span, 0, 1)


def visualize_features(features):
    pyplot = require('matplotlib.pyplot', '--vis')
    pca = pickle.loads(features.attrs['pca'].tobytes())
    for fm in features[::10]:
        pyplot.imshow(_mapped(fm, pca, features.attrs['min'],
                              features.attrs['range']))
        pyplot.show()


def write_video(features, out):
    cv2 = require('cv2', '--video')
    pca = pickle.loads(features.attrs['pca'].tobytes())
    _, H, W, _ = features.shape
    writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*'mp4v'), 5, (W, H))
    for feature in features:
        frame = (_mapped(feature, pca, features.attrs['min'],
                         features.attrs['range']) * 255.0).astype(np.uint8)
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def main(argv=None, device=None):
    """Extract, compress if asked, and write <scene>/features.hdf; returns
    its path. device: None (the card; raises without one) or a torch
    device ('cpu' in the tests)."""
    flags = read_args(argv)
    h5py = require('h5py', 'the features.hdf write')
    decomposition = require('sklearn.decomposition',
                            "the features' PCA attrs")
    device = resolve_device(device)
    scene = Scene(flags.scene)
    extractor = get_feature_extractor(flags.features, flags.checkpoint,
                                      allow_fallback=flags.allow_fallback,
                                      device=device)
    maps = extract_features(extractor, scene, flags, device)
    path = os.path.join(scene.path, 'features.hdf')
    write_features(path, flags.features, maps, decomposition, h5py)
    if flags.vis or flags.video:
        with h5py.File(path, 'r') as f:
            dataset = f[f'features/{flags.features}']
            if flags.vis:
                visualize_features(dataset)
            if flags.video:
                write_video(dataset, flags.video)
    return path


if __name__ == "__main__":
    main()
