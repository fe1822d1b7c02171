"""The port's data layer against the JAX package's, on the CPU.

utils.images (PNG reading and writing, cv2's and PIL's nearest-neighbour
resize rules) against cv2 and PIL themselves; Scene, IndexSampler and
SceneDataset against the JAX package's on a tests/synthetic.py scene
written by cv2, with semantics and a features.hdf, at factors 1, 2 and 1.5
(and the lazy loader's frames); and the port's scene fixtures against the cv2-written
originals. The same seeds on both sides (numpy's global state for the
class-balanced draws, the dataset's own Generator for the rest): pixels,
depth, semantics, origins and features bit-equal, directions and norms
within 2 float32 ulp.
"""
import os
import struct
import sys
import zlib

import cv2
import h5py
import numpy as np
import pytest
from PIL import Image

from autolabel_tpu.core.dataset import SceneDataset as JaxSceneDataset
from autolabel_tpu.core.sampler import IndexSampler as JaxIndexSampler
from autolabel_tpu.utils import Scene as JaxScene
from autolabel_tpu_torch.core.dataset import LenDataset, SceneDataset
from autolabel_tpu_torch.core.sampler import IndexSampler
from autolabel_tpu_torch.utils import Scene, fixtures, images
from tests.room import make_room_scene
from tests.synthetic import make_synthetic_scene

W, H = 48, 36
FEATURES = 'fcn50'


# -- PNG ---------------------------------------------------------------------

def _filtered_png(path, pixels, bpp, depth, colour):
    """A PNG whose rows cycle through the five filter types (0-4), so each
    reconstruction rule is exercised; pixels: (H, stride) uint8 bytes. A
    palette image (colour 3) gets the grey ramp as its palette."""
    height, stride = pixels.shape
    prior = np.zeros(stride, np.int64)
    lines = []
    for y in range(height):
        kind = y % 5
        row = pixels[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros(stride, np.int64)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        lines.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prior = row

    def chunk(kind, payload):
        return (struct.pack('>I', len(payload)) + kind + payload
                + struct.pack('>I', zlib.crc32(kind + payload)))

    width = stride // bpp
    with open(path, 'wb') as f:
        f.write(images.PNG_SIGNATURE)
        f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth,
                                           colour, 0, 0, 0)))
        if colour == 3:
            f.write(chunk(b'PLTE', np.arange(256, dtype=np.uint8).repeat(
                3).tobytes()))
        f.write(chunk(b'IDAT', zlib.compress(b''.join(lines))))
        f.write(chunk(b'IEND', b''))


def _image(kind, rng, h=29, w=37):
    """A test image of each supported kind: smooth ramps plus noise, so
    adaptive filters pick every type."""
    y, x = np.mgrid[:h, :w]
    ramp = (3 * x + 5 * y)[..., None] + rng.integers(0, 9, (h, w, 4))
    if kind == 'grey16':
        return (ramp[..., 0] * 613 + rng.integers(0, 4000, (h, w))).astype(
            np.uint16)
    channels = {'grey': 1, 'palette': 1, 'rgb': 3, 'rgba': 4}[kind]
    out = (ramp[..., :channels] % 256).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


KINDS = ['grey', 'rgb', 'rgba', 'palette', 'grey16']


def _write_with_library(path, kind, image, library):
    if kind == 'palette':
        im = Image.fromarray(image, 'P')
        im.putpalette(list(range(256)) * 3)
        im.save(path)
    elif library == 'cv2':
        cv2.imwrite(path, image if image.ndim == 2 else cv2.cvtColor(
            image, cv2.COLOR_RGB2BGR if kind == 'rgb' else
            cv2.COLOR_RGBA2BGRA))
    else:
        Image.fromarray(image).save(path)


def _cv2_read(path, kind):
    got = cv2.imread(path, -1)
    if kind == 'rgb':
        return cv2.cvtColor(got, cv2.COLOR_BGR2RGB)
    if kind == 'rgba':
        return cv2.cvtColor(got, cv2.COLOR_BGRA2RGBA)
    return got


@pytest.mark.parametrize('library', ['cv2', 'PIL'])
@pytest.mark.parametrize('kind', KINDS)
def test_read_png_matches_cv2_and_pil(tmp_path, kind, library):
    """Files written by cv2 or PIL read as PIL reads them (a palette
    image's indices) and as cv2.imread(path, -1) reads them (colour
    channels reordered from BGR; uint16 depth)."""
    image = _image(kind, np.random.default_rng(KINDS.index(kind)))
    path = str(tmp_path / f'{kind}.png')
    _write_with_library(path, kind, image, library)
    got = images.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, image)
    if kind != 'palette':  # cv2 expands a palette to colours
        assert np.array_equal(got, _cv2_read(path, kind))
    assert images.image_size(path) == (image.shape[1], image.shape[0])
    assert images.read_image(path).dtype == want.dtype


@pytest.mark.parametrize('kind,bpp,depth,colour', [
    ('grey', 1, 8, 0), ('rgb', 3, 8, 2), ('rgba', 4, 8, 6),
    ('palette', 1, 8, 3), ('grey16', 2, 16, 0)])
def test_read_png_undoes_every_row_filter(tmp_path, kind, bpp, depth,
                                          colour):
    """Rows filtered with each of the five types (None, Sub, Up, Average,
    Paeth) in turn decode to the image, as PIL and cv2 decode them."""
    image = _image(kind, np.random.default_rng(9), h=23)
    raw = (image.astype('>u2').view(np.uint8) if depth == 16
           else image).reshape(image.shape[0], -1)
    path = str(tmp_path / f'{kind}.png')
    _filtered_png(path, raw, bpp, depth, colour)
    got = images.read_png(path)
    assert np.array_equal(got, image)
    assert np.array_equal(got, np.asarray(Image.open(path)))
    if kind != 'palette':
        assert np.array_equal(got, _cv2_read(path, kind))


@pytest.mark.parametrize('kind', ['grey', 'rgb', 'rgba', 'grey16'])
def test_write_png_reads_back(tmp_path, kind):
    """write_png's files read back equal, here, in PIL and in cv2."""
    image = _image(kind, np.random.default_rng(4))
    path = str(tmp_path / f'{kind}.png')
    images.write_png(path, image)
    assert np.array_equal(images.read_png(path), image)
    assert np.array_equal(np.asarray(Image.open(path)), image)
    assert np.array_equal(_cv2_read(path, kind), image)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    """Interlaced files, other bit depths and types, a bad CRC, and
    unwritable arrays raise."""
    path = str(tmp_path / 'x.png')
    images.write_png(path, _image('rgb', np.random.default_rng(1)))
    data = bytearray(open(path, 'rb').read())
    interlaced = bytearray(data)
    interlaced[8 + 8 + 12] = 1
    interlaced[8 + 8 + 13:8 + 8 + 17] = struct.pack(
        '>I', zlib.crc32(bytes(interlaced[8 + 4:8 + 8 + 13])))
    with open(path, 'wb') as f:
        f.write(interlaced)
    with pytest.raises(ValueError, match='interlaced'):
        images.read_png(path)
    corrupt = bytearray(data)
    corrupt[40] ^= 0xFF
    with open(path, 'wb') as f:
        f.write(corrupt)
    with pytest.raises(ValueError, match='CRC'):
        images.read_png(path)
    for mode, array in (('1', np.eye(8, dtype=bool)),
                        ('LA', np.zeros((4, 4, 2), np.uint8))):
        Image.fromarray(array, None if mode == '1' else mode).save(path)
        with pytest.raises(ValueError, match='not supported'):
            images.read_png(path)
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match='not supported'):
        images.read_png(path)
    with pytest.raises(ValueError):
        images.write_png(path, np.zeros((4, 4), np.float32))


def test_other_files_go_through_pil_or_raise(tmp_path, monkeypatch):
    """A JPEG reads as PIL reads it; without PIL the reader names the file
    and what is missing, and never decodes it another way."""
    path = str(tmp_path / 'frame.jpg')
    image = _image('rgb', np.random.default_rng(2))
    Image.fromarray(image).save(path)
    assert np.array_equal(images.read_image(path),
                          np.asarray(Image.open(path)))
    assert images.image_size(path) == (image.shape[1], image.shape[0])
    monkeypatch.setitem(sys.modules, 'PIL', None)
    for fn in (images.read_image, images.image_size):
        with pytest.raises(RuntimeError, match='frame.jpg.*PIL'):
            fn(path)


# -- resize rules --------------------------------------------------------------

@pytest.mark.parametrize('scale', [2, 1.5, 4, 1 / 3])
@pytest.mark.parametrize('shape', [(36, 48), (37, 50), (120, 160)])
def test_resize_rules_match_cv2_and_pil(scale, shape):
    """Each rule picks its library's source pixels, at integer and
    non-integer factors, down and up: cv2 on float32 colour and uint16
    depth, PIL on uint8 labels."""
    h, w = shape
    size = (int(w / scale), int(h / scale))
    rng = np.random.default_rng(h)
    colour = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    depth = rng.integers(0, 65535, (h, w)).astype(np.uint16)
    labels = rng.integers(0, 255, (h, w)).astype(np.uint8)
    for image in (colour, depth):
        want = cv2.resize(image, size, interpolation=cv2.INTER_NEAREST)
        got = images.resize_nearest_cv2(image, size)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    want = np.asarray(Image.fromarray(labels).resize(size, Image.NEAREST))
    assert np.array_equal(images.resize_nearest_pil(labels, size), want)
    if scale > 1:  # downscaled, the two rules differ (hence two functions)
        assert not np.array_equal(images.resize_nearest_cv2(labels, size),
                                  want)


# -- scenes, sampler, dataset -------------------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """tests/synthetic.py's sphere written by cv2, labels every third
    frame, with a features.hdf of 12 x 9 teacher features."""
    path = str(tmp_path_factory.mktemp('scenes') / 'sphere')
    make_synthetic_scene(path, n_frames=12, width=W, height=H)
    rng = np.random.default_rng(3)
    with h5py.File(os.path.join(path, 'features.hdf'), 'w') as f:
        f.create_dataset(f'features/{FEATURES}',
                         data=rng.normal(size=(12, 9, 12, 8)).astype(
                             np.float32))
    return path


def test_scene_matches_jax(scene):
    ours, ref = Scene(scene), JaxScene(scene)
    for name in ('rgb_paths', 'depth_paths', 'semantic_paths',
                 'image_names', 'peak_image_size', 'depth_size', 'bbox'):
        assert np.array_equal(np.asarray(getattr(ours, name)()),
                              np.asarray(getattr(ref, name)())), name
    assert ours.pose_frames == ref.pose_frames
    assert np.array_equal(np.stack(ours.poses), np.stack(ref.poses))
    assert np.array_equal(ours.camera.camera_matrix, ref.camera.camera_matrix)
    assert ours.camera.size == ref.camera.size
    assert ours.n_classes == ref.n_classes == 2
    masks, ref_masks = ours.gt_masks((W, H)), ref.gt_masks((W, H))
    assert [i for i, _ in masks] == [i for i, _ in ref_masks] and masks
    for (_, a), (_, b) in zip(masks, ref_masks):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_index_sampler_matches_jax():
    """The same maps index the same pixels; numpy's global state (or an
    explicit RandomState of the same seed) gives the same draws."""
    rng = np.random.default_rng(5)
    maps = rng.integers(0, 4, (6, 200)).astype(np.uint8)
    maps[2] = 0
    ours, ref = IndexSampler(), JaxIndexSampler()
    ours.update(maps)
    ref.update(maps)
    assert np.array_equal(ours.classes, ref.classes)
    assert ours.semantic_indices() == ref.semantic_indices()

    def draws(sampler):
        out = []
        for _ in range(20):
            c = sampler.sample_class()
            out.append((c, *sampler.sample(c, 7)))
        return out

    np.random.seed(11)
    want = draws(ref)
    np.random.seed(11)
    got = draws(ours)
    explicit = IndexSampler(np.random.RandomState(11))
    explicit.update(maps)
    for sampler_draws in (got, draws(explicit)):
        for (c, i, p), (c2, i2, p2) in zip(sampler_draws, want):
            assert c == c2 and i == i2 and np.array_equal(p, p2)
    with pytest.raises(ValueError):
        ours.update(maps[0])


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key in ('rays_d', 'direction_norms'):
            np.testing.assert_array_max_ulp(a, b, maxulp=2)
        else:
            assert np.array_equal(a, b), key


@pytest.mark.parametrize('factor', [1.0, 2.0, 1.5])
def test_scene_dataset_batches_match_jax(scene, factor):
    """Train batches (class-balanced and uniform chunks, features) and
    test frames, bit-equal but for directions and norms."""
    kw = dict(factor=factor, batch_size=1024, features=FEATURES)
    ref = JaxSceneDataset('train', scene, **kw)
    ours = SceneDataset('train', scene, **kw)
    assert (ours.w, ours.h) == (ref.w, ref.h) == (int(W / factor),
                                                 int(H / factor))
    assert np.array_equal(ours.pixel_indices, ref.pixel_indices)
    assert np.array_equal(ours.semantics, ref.semantics)
    assert np.array_equal(ours.poses, ref.poses)
    assert np.array_equal(ours.intrinsics, ref.intrinsics)
    assert ours.index_sampler.has_semantics

    def batches(dataset):
        np.random.seed(21)
        dataset.rng = np.random.default_rng(8)
        return [dataset._next_train() for _ in range(3)]

    for got, want in zip(batches(ours), batches(ref)):
        _assert_batches_equal(got, want)
    assert (np.asarray(want['semantic']) >= 0).any()
    for i in (0, 5):
        _assert_batches_equal(ours._get_test(i), ref._get_test(i))
    assert len(list(LenDataset(ours, 4))) == 4


def test_lazy_image_loader_matches_jax(scene):
    """Colour (scaled to [0, 1]) and depth frames read on first access,
    resized by cv2's rule, as the JAX loader reads them with PIL and
    cv2."""
    from autolabel_tpu.core.dataset import LazyImageLoader as JaxLoader
    from autolabel_tpu_torch.core.dataset import LazyImageLoader
    paths = Scene(scene)
    for files in (paths.rgb_paths(), paths.depth_paths()):
        ours = LazyImageLoader(files, (32, 24))
        ref = JaxLoader(files, (32, 24), cv2.INTER_NEAREST)
        for i in (0, 7):
            got, want = ours[i], ref[i]
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert ours[i] is got  # cached


def test_test_split_matches_jax(scene):
    ref = JaxSceneDataset('test', scene, factor=1.5, batch_size=2048)
    ours = SceneDataset('test', scene, factor=1.5, batch_size=2048)
    frames = list(ours)
    assert len(frames) == len(list(ref)) == 12
    _assert_batches_equal(frames[3], ref._get_test(3))


def test_prefetch_iterator_keeps_order_and_raises_on_the_consumer_side():
    """Items in order through the worker thread, transformed, the length
    of the wrapped iterable; an error in the worker reaches the consumer
    after the items before it."""
    from autolabel_tpu_torch.train.loader import PrefetchIterator
    loader = PrefetchIterator(LenDataset(iter(range(100)), 7),
                              transform=lambda x: 2 * x, depth=2)
    assert len(loader) == 7 and list(loader) == [0, 2, 4, 6, 8, 10, 12]

    def failing():
        yield 1
        raise KeyError('broken batch')

    got = []
    with pytest.raises(KeyError, match='broken batch'):
        for item in PrefetchIterator(failing()):
            got.append(item)
    assert got == [1]


# -- fixtures ----------------------------------------------------------------------

def _assert_scenes_decode_equal(ours, ref):
    for sub in sorted(os.listdir(ref)):
        path = os.path.join(ref, sub)
        if sub == 'gt_masks':
            continue
        if not os.path.isdir(path):
            with open(path, 'rb') as a, open(os.path.join(ours, sub),
                                              'rb') as b:
                assert a.read() == b.read(), sub
            continue
        assert sorted(os.listdir(path)) == sorted(
            os.listdir(os.path.join(ours, sub))), sub
        for name in os.listdir(path):
            a, b = os.path.join(ours, sub, name), os.path.join(path, name)
            if name.endswith('.png'):
                want = cv2.imread(b, -1)
                if want.ndim == 3:
                    want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
                got = images.read_png(a)
                assert got.dtype == want.dtype and np.array_equal(got, want)
            else:
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), name
    assert not os.path.exists(os.path.join(ours, 'gt_masks'))


def test_fixture_scenes_decode_equal_to_the_cv2_written_ones(tmp_path):
    fixtures.make_synthetic_scene(str(tmp_path / 'sphere'), n_frames=6)
    make_synthetic_scene(str(tmp_path / 'sphere_cv2'), n_frames=6)
    _assert_scenes_decode_equal(str(tmp_path / 'sphere'),
                                str(tmp_path / 'sphere_cv2'))
    fixtures.make_room_scene(str(tmp_path / 'room'), n_frames=9, width=40,
                             height=30)
    make_room_scene(str(tmp_path / 'room_cv2'), n_frames=9, width=40,
                    height=30)
    _assert_scenes_decode_equal(str(tmp_path / 'room'),
                                str(tmp_path / 'room_cv2'))
