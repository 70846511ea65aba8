"""PNG files and image resizing without imageio or OpenCV.

The card's machine has neither library, so the fitter CLIs read and write
their images through this module:

  * :func:`read_png` / :func:`write_png` — 8-bit PNG in pure ``zlib`` +
    ``struct`` + numpy: gray, gray+alpha, RGB, RGBA and palette images,
    non-interlaced; every filter type on read, filter 0 on write;
  * :func:`read_image` — PNG by itself, any other format through imageio,
    imported when such a file is read (an ``ImportError`` that names
    imageio where it is absent: no JPEG frames on the card);
  * :func:`resize` — ``cv2.resize`` with ``INTER_NEAREST`` (source index
    ⌊dst·in/out⌋, in float64 as cv2 computes it) and ``INTER_LINEAR``
    (half-pixel centres, no antialias, through
    ``torch.nn.functional.interpolate`` on the CPU).

Arrays are numpy in imageio's layout: (H, W) gray, (H, W, C) otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples a pixel (palette: one index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a non-interlaced image → (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:                               # None
            row = line.copy()
        elif kind == 1:                             # Sub: a running sum per byte lane
            lanes = line.astype(np.int64).reshape(-1, bpp)
            row = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:                             # Up
            row = line + prior                      # uint8 wraps mod 256
        elif kind in (3, 4):                        # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {kind} in row {y}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit non-interlaced PNG as uint8 (H, W) or (H, W, C); palette
    images come back as RGB (RGBA with a ``tRNS`` chunk)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNG is read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    channels = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    img = pixels.reshape(height, width, channels)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        idx = img[..., 0]
        img = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
    return img[..., 0] if img.shape[-1] == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) as
    an 8-bit PNG (every row filter 0, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4) images, got {img.shape}")
    height, width, channels = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(height, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """An image file as a numpy array: PNG by :func:`read_png`, any other
    format by imageio (which the card's machine lacks)."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"{path} is not a PNG; reading it needs imageio, which is not "
                          f"installed (convert the frames to PNG)") from e
    return np.asarray(imageio.imread(path))


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index ⌊x · (1 / (dst / src))⌋ in float64,
    clipped to the source (a float32 scale, as ``interpolate`` uses, rounds
    some x·scale just below an integer and picks the pixel before)."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def resize(img: np.ndarray, size, mode: str = "linear") -> np.ndarray:
    """``img`` (H, W) or (H, W, C) resized to ``size`` = (height, width), as
    ``cv2.resize(img, (width, height), interpolation=...)`` does with
    ``mode`` "nearest" (INTER_NEAREST, by index) or "linear" (INTER_LINEAR,
    cv2's default; float images, through ``interpolate``). Images keep their
    dtype."""
    arr = np.asarray(img)
    height, width = (int(s) for s in size)
    if mode == "nearest":
        return arr[_nearest_index(arr.shape[0], height)][:, _nearest_index(arr.shape[1], width)]
    if mode != "linear":
        raise ValueError(f"resize mode must be 'nearest' or 'linear', got {mode!r}")
    if not np.issubdtype(arr.dtype, np.floating):
        raise ValueError("linear resize takes float images")
    x = torch.from_numpy(np.ascontiguousarray(arr))
    x = x[None, None] if arr.ndim == 2 else x.permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(x, size=(height, width), mode="bilinear",
                                          align_corners=False, antialias=False)
    out = out[0, 0] if arr.ndim == 2 else out[0].permute(1, 2, 0)
    return out.contiguous().numpy()
