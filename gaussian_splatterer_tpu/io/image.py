"""Image load/save (reference uses stb, src/StbImpl.cpp + src/rtx/RtxHost.cpp:14-36).

Conventions:
  * Framework images are (H, W, 3) float32 in [0, 1]; row 0 is framebuffer
    row y=0 (GL-style, bottom-up) exactly as in the reference.  PNG export
    flips vertically, matching the reference screenshot path
    (src/ui/tools/UiPanelToolsView.cpp:237-239).
  * Textures load to (H, W, 4) float32 RGBA in [0, 1]; a missing texture is
    an 8x8 mid-gray (0x80) fully-opaque fallback (src/rtx/RtxHost.cpp:23-36).

8-bit PNGs (grey, grey+alpha, RGB, RGBA; palette too) are read and RGB
PNGs written by a small stdlib (zlib) codec, so the main path needs no
imaging library; other texture formats load through Pillow when it is
installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4)."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential in x, per pixel
            cur = line.copy()
            zero = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp : x] if x else zero
                b = prev[x : x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp : x] if x else zero
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x : x + bpp] = (cur[x : x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"corrupt PNG: filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png_u8(path: str) -> np.ndarray:
    """(H, W, C) uint8 of an 8-bit, non-interlaced PNG; C is 1-4 as stored
    (palette images expand to RGB or RGBA)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _png_chunks(data):
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
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced PNGs are supported "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    img = rows.reshape(height, width, ch)
    if ctype == 3:
        rgb = palette[img[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[img[..., 0]][..., None]], axis=-1)
    return img


def write_png_u8(path: str, arr: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 array as an 8-bit PNG."""
    arr = np.ascontiguousarray(arr, np.uint8)
    height, width, ch = arr.shape
    ctype = {3: 2, 4: 6}[ch]
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8), arr.reshape(height, width * ch)], axis=1
    ).tobytes()  # filter type 0 on every scanline

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    with open(path, "wb") as fh:
        fh.write(
            _PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b"")
        )


def _to_rgba_u8(img: np.ndarray) -> np.ndarray:
    ch = img.shape[-1]
    if ch == 1:
        img = np.repeat(img, 3, axis=-1)
    elif ch == 2:
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], -1)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:-1] + (1,), 255, np.uint8)], axis=-1
        )
    return img


def load_texture_rgba(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        is_png = fh.read(len(_PNG_SIG)) == _PNG_SIG
    if is_png:
        rgba = _to_rgba_u8(read_png_u8(path))
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path}: only PNG textures load without Pillow; convert the "
                "texture to PNG or install Pillow"
            ) from e
        rgba = np.asarray(Image.open(path).convert("RGBA"))
    return rgba.astype(np.float32) / 255.0


def blank_texture() -> np.ndarray:
    tex = np.full((8, 8, 4), 0x80 / 255.0, np.float32)
    tex[..., 3] = 1.0
    return tex


def float_image_to_u8(img: np.ndarray) -> np.ndarray:
    """Reference quantization: value*256, clamped to [0, 255] (src/Trainer.cu:25-27)."""
    return np.clip((np.asarray(img, np.float32) * 256.0).astype(np.int32), 0, 255).astype(
        np.uint8
    )


def save_png(img: np.ndarray, path: str, flip_vertical: bool = True) -> None:
    """img: (H, W, 3) float [0,1] or uint8."""
    arr = img if img.dtype == np.uint8 else float_image_to_u8(img)
    if flip_vertical:
        arr = arr[::-1]
    write_png_u8(path, arr)


def load_png(path: str, flip_vertical: bool = True) -> np.ndarray:
    arr = _to_rgba_u8(read_png_u8(path))[..., :3].astype(np.float32) / 255.0
    if flip_vertical:
        arr = arr[::-1]
    return arr
