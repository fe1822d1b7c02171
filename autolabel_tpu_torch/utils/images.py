"""PNG reading and writing, and the two nearest-neighbour resize rules.

The dataset reads its frames with cv2 and PIL in the JAX package. Neither
is a dependency of the port, so PNG files are decoded and encoded here
with numpy and zlib. The types are those a scene directory holds: 8-bit
grey, RGB, RGBA and palette images (the palette's indices are returned,
as np.asarray(PIL.Image) returns them), and 16-bit grey (uint16, as
cv2.imread(path, -1) returns it). Interlaced files and every other type
raise.

Files that are not PNGs (JPEG frames) go through PIL, imported at the call;
without PIL they raise, naming the file and what is missing.

The JAX dataset resizes colour and depth with cv2.INTER_NEAREST and labels
with PIL's NEAREST. The two pick different source pixels (12 -> 6 pixels:
cv2 takes 0, 2, 4, ..., PIL 1, 3, 5, ...), and resize_nearest_cv2 and
resize_nearest_pil reproduce each rule bit for bit.
"""
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'

# colour type -> channels, for the types read here
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def is_png(path):
    with open(path, 'rb') as f:
        return f.read(8) == PNG_SIGNATURE


def _chunks(data, path):
    """(type, payload) of every chunk after the signature, CRC-checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f'{path}: truncated PNG chunk header')
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f'{path}: PNG chunk {kind!r} fails its CRC')
        yield kind, payload
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError(f'{path}: PNG without IEND')


def _header(ihdr, path):
    width, height, depth, colour, compression, filt, interlace = \
        struct.unpack('>IIBBBBB', ihdr)
    if interlace != 0:
        raise ValueError(f'{path}: interlaced PNGs are not supported')
    if compression != 0 or filt != 0:
        raise ValueError(f'{path}: unknown PNG compression or filter method')
    if not (colour in _CHANNELS and depth == 8
            or colour == 0 and depth == 16):
        raise ValueError(f'{path}: PNG colour type {colour} at bit depth '
                         f'{depth} is not supported (8-bit grey, RGB, RGBA '
                         'or palette, or 16-bit grey)')
    return width, height, depth, colour


def _paeth_row(row, prior, bpp):
    """Undo the Paeth filter of one row in place (a byte loop: each byte
    depends on the one reconstructed bpp before it)."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        row[i] = (row[i] + pred) & 0xFF


def _average_row(row, prior, bpp):
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw, height, stride, bpp, path):
    """The image bytes (height, stride) from the decompressed scanlines,
    each led by its filter type (PNG spec, section 9)."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f'{path}: PNG image data has {len(raw)} bytes, '
                         f'expected {height * (stride + 1)}')
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum, modulo 256, per byte lane
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prior
        elif kind in (3, 4):
            row = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f'{path}: unknown PNG filter type {kind} in '
                             f'row {y}')
        prior = out[y]
    return out


def read_png(path):
    """A PNG file as a numpy array: (H, W) for grey and palette images
    (uint8, or uint16 at 16 bits), (H, W, 3) for RGB, (H, W, 4) for RGBA."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f'{path}: not a PNG file')
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b'IHDR':
            header = _header(payload, path)
        elif kind == b'IDAT':
            idat.append(payload)
    if header is None:
        raise ValueError(f'{path}: PNG without IHDR')
    width, height, depth, colour = header
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = zlib.decompress(b''.join(idat))
    pixels = _unfilter(raw, height, width * bpp, bpp, path)
    if depth == 16:
        pixels = pixels.view('>u2').astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def write_png(path, image, level=6):
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4), or a uint16 (H, W)
    array as an unfiltered, non-interlaced PNG."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour = 16, 0
        pixels = image.astype('>u2').view(np.uint8).reshape(
            image.shape[0], -1)
    elif image.dtype == np.uint8 and (image.ndim == 2 or image.ndim == 3
                                      and image.shape[2] in (3, 4)):
        depth = 8
        colour = 0 if image.ndim == 2 else {3: 2, 4: 6}[image.shape[2]]
        pixels = image.reshape(image.shape[0], -1)
    else:
        raise ValueError(f'{path}: cannot write a {image.dtype} array of '
                         f'shape {image.shape} as PNG')
    height, width = image.shape[:2]
    scanlines = np.concatenate(
        [np.zeros((height, 1), np.uint8), pixels], axis=1).tobytes()

    def chunk(kind, payload):
        return (struct.pack('>I', len(payload)) + kind + payload
                + struct.pack('>I', zlib.crc32(kind + payload)))

    with open(path, 'wb') as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth,
                                           colour, 0, 0, 0)))
        f.write(chunk(b'IDAT', zlib.compress(scanlines, level)))
        f.write(chunk(b'IEND', b''))


def _pil(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f'{path} is not a PNG; reading it needs PIL (Pillow), which is '
            'not installed') from e
    return Image


def read_image(path):
    """An image file as an array: PNGs decoded here, anything else (JPEG)
    through PIL, as np.asarray(PIL.Image.open(path)) gives it."""
    if is_png(path):
        return read_png(path)
    image = _pil(path)
    with image.open(path) as im:
        return np.asarray(im)


def image_size(path):
    """(width, height) of an image file: a PNG's IHDR, else PIL's size."""
    if is_png(path):
        with open(path, 'rb') as f:
            head = f.read(24)
        if head[12:16] != b'IHDR':
            raise ValueError(f'{path}: PNG without a leading IHDR')
        return struct.unpack('>II', head[16:24])
    image = _pil(path)
    with image.open(path) as im:
        return im.size


def _cv2_indices(src, dst):
    """cv2.resize INTER_NEAREST's source index of each output index:
    floor(x / (dst / src)) in double, capped at src - 1 (resizeNN)."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def _pil_indices(src, dst):
    """PIL's NEAREST resize's source index of each output index: the
    position starts half a step in and adds src / dst once per pixel, in
    double, then truncates (Pillow's ImagingScaleAffine)."""
    step = src / dst
    pos = step * 0.5
    out = np.empty(dst, np.int64)
    for x in range(dst):
        out[x] = int(pos)
        pos += step
    if out.max() >= src:
        raise ValueError(f'PIL nearest rule left the source: {src} -> {dst}')
    return out


def resize_nearest_cv2(image, size):
    """cv2.resize(image, size, interpolation=cv2.INTER_NEAREST); size is
    (width, height)."""
    w, h = size
    return image[_cv2_indices(image.shape[0], h)[:, None],
                 _cv2_indices(image.shape[1], w)[None, :]]


def resize_nearest_pil(image, size):
    """np.asarray(PIL.Image.fromarray(image).resize(size, NEAREST)); size
    is (width, height)."""
    w, h = size
    return image[_pil_indices(image.shape[0], h)[:, None],
                 _pil_indices(image.shape[1], w)[None, :]]


def _linear_taps(src, dst):
    """cv2.resize INTER_LINEAR's two source indices and the second's
    weight for each output index: the sample at (x + 0.5) src / dst - 0.5,
    clamped to the edge pixels."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    top = lo >= src - 1
    frac[top] = 0.0
    lo[top] = src - 1
    return lo, np.minimum(lo + 1, src - 1), frac


def resize_linear_cv2(image, size):
    """cv2.resize(image, size) (INTER_LINEAR), size (width, height): the
    same taps and weights, blended in float64. An 8-bit image is rounded
    to the nearest integer, where cv2 blends in 11-bit fixed point, so
    every value lies within 1 of cv2's; a float image comes back float32,
    within float32 rounding of cv2's float blend."""
    w, h = size
    y0, y1, fy = _linear_taps(image.shape[0], h)
    x0, x1, fx = _linear_taps(image.shape[1], w)
    img = image.astype(np.float64)
    if img.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    rows = img[y0] * (1.0 - fy[:, None]) + img[y1] * fy[:, None]
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    if np.issubdtype(image.dtype, np.floating):
        return out.astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(image.dtype)

