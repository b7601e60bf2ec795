"""Canvas output and texture input: 16-bit PPM (P6), 48-bit PNG, and the
readers of both.

Host-side numpy with `zlib` and `struct`, as in the JAX package,
reproducing the reference's canvas code bit for bit
(src/libs/canvas/canvas.c):

* construct_ppm (canvas.c:150-301): two analysis passes compute
  per-channel `rgb_max` over the raw canvas and `srgb_max` over
  srgb(canvas/rgb_max); the encode pass then either L1-clamps each pixel
  to sqrt(3) (use_scaling) or clamps channels to [0,1], sRGB-encodes, and
  quantizes with floor(srgb * 65535/srgb_max), saturating to 65535 above
  srgb_max.
* write_png (canvas.c:374-529): clamp to [0,1], sRGB-encode,
  floor(srgb * 65535), big-endian 16-bit RGB.
* read_png / read_ppm mirror the loaders (canvas.c:329-366, 531-672):
  values normalized to [0,1]; `decode` pre-applies the canvas's color
  decode (texture canvases are read without super-sampling).

read_png decodes every PNG the format allows, without Pillow: grey at 1,
2, 4, 8 or 16 bits, palette at 1, 2, 4 or 8 (mapped through PLTE to RGB;
tRNS is ignored), grey+alpha, RGB and RGBA at 8 or 16, plain or
Adam7-interlaced, with all five scanline filters. Alpha is dropped and
grey repeats to RGB. The values are the JAX package's, whose reader goes
through Pillow for everything but 16-bit RGB: grey at 2 and 4 bits scales
to 8 bits first (x85, x17) and 16-bit grey+alpha and RGBA keep only their
high byte, divided by 255. The scanlines are reconstructed by the native
core (native/png_core.cpp), since the Average and Paeth filters are
sequential along a row. `read_image` reads the other formats through
Pillow, which only it imports.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from fast_ray_tracer_tpu_torch import native
from fast_ray_tracer_tpu_torch.colors import rgb_to_srgb
from fast_ray_tracer_tpu_torch.constants import SQRT3

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel and allowed bit depths of each PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# the Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PPM_WHITESPACE = b" \t\n\v\f\r"


def construct_ppm(canvas: np.ndarray, use_scaling: bool = True) -> bytes:
    """Encode an (H, W, 3) float canvas to 16-bit binary P6 bytes."""
    c = np.asarray(canvas, dtype=np.float64)
    h, w = c.shape[:2]
    header = f"P6\n{w} {h}\n65535\n".encode()

    rgb_max = c.reshape(-1, 3).max(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        normalized = c / rgb_max
    srgb_max = np.nanmax(rgb_to_srgb(normalized).reshape(-1, 3), axis=0)
    inverse = 65535.0 / srgb_max

    px = c.copy()
    if use_scaling:
        l1 = px.sum(axis=-1, keepdims=True)
        scale = np.where(l1 > SQRT3, SQRT3 / np.where(l1 == 0.0, 1.0, l1), 1.0)
        px = px * scale
    else:
        px = np.clip(px, 0.0, 1.0)
    srgb = rgb_to_srgb(px)

    scaled = np.floor(srgb * inverse)
    scaled = np.where(srgb > srgb_max, 65535.0, scaled)
    scaled = np.where(srgb < 0.0, 0.0, scaled)
    data = scaled.astype(np.uint16).astype(">u2").tobytes()
    return header + data + b"\n"


def write_ppm(canvas, path: str, use_scaling: bool = True) -> None:
    """Write `<path>.ppm` like the reference's write_ppm_file (canvas.c:303)."""
    with open(str(path) + ".ppm", "wb") as f:
        f.write(construct_ppm(np.asarray(canvas), use_scaling))


def png16(canvas) -> np.ndarray:
    """The (H, W, 3) uint16 samples write_png stores for a float canvas."""
    c = np.clip(np.asarray(canvas, dtype=np.float64), 0.0, 1.0)
    return np.minimum(np.floor(rgb_to_srgb(c) * 65535.0),
                      65535.0).astype(np.uint16)


def write_png(canvas, path: str) -> None:
    """Write `<path>.png` as 48-bit RGB, matching write_png (canvas.c:374)."""
    with open(str(path) + ".png", "wb") as f:
        f.write(encode_png(png16(canvas)))


def _filter_adaptive(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines of the (h, stride) bytes `raw`,
    each row under the filter whose bytes, read as signed, have the least
    absolute sum (libpng's heuristic; PNG spec section 12.8)."""
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    best = np.minimum(cand, 256 - cand).sum(-1).argmin(0)
    rows = cand[best, np.arange(x.shape[0])]
    return np.concatenate([best[:, None], rows], 1).astype(np.uint8)


def encode_png(samples: np.ndarray, adaptive: bool = False) -> bytes:
    """PNG bytes of (H, W) grey or (H, W, C) samples, C in {1, 2, 3, 4}
    (grey, grey+alpha, RGB, RGBA), uint8 or uint16, marked sRGB, zlib
    level 6. Every scanline takes filter 0 (write_png's bytes are the JAX
    package's), or with `adaptive` a filter chosen per row as libpng
    chooses it."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[a.dtype]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.frombuffer(a.astype(">u2" if depth == 16 else np.uint8)
                        .tobytes(), np.uint8).reshape(h, w * c * depth // 8)
    if adaptive:
        lines = _filter_adaptive(raw, c * depth // 8)
    else:
        lines = np.concatenate([np.zeros((h, 1), np.uint8), raw], 1)
    scanlines = lines.tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"sRGB", b"\x03")
            + chunk(b"IDAT", zlib.compress(scanlines, 6))
            + chunk(b"IEND", b""))


def _png_chunks(data: bytes, path: str):
    """(IHDR fields, PLTE bytes or None, the joined IDAT payload)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr, plte = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"PNG without an IHDR chunk: {path}")
    return hdr, plte, b"".join(idat)


def _png_samples(raw: bytes, w: int, h: int, ch: int, depth: int,
                 path: str):
    """One (sub)image's scanlines -> (h, w, ch) integer samples and the
    number of bytes they took."""
    bpp = max(1, ch * depth // 8)
    stride = -(-w * ch * depth // 8)
    size = h * (stride + 1)
    if len(raw) < size:
        raise ValueError(f"truncated PNG image data in {path}")
    try:
        rows = native.png_unfilter(raw[:size], h, stride, bpp)
    except ValueError as e:
        raise ValueError(f"{e} in {path}") from None
    if depth == 16:
        v = rows.reshape(h, w, ch, 2).astype(np.uint16)
        return v[..., 0] * 256 + v[..., 1], size
    if depth == 8:
        return rows.reshape(h, w, ch), size
    # 1, 2 or 4 bits: samples packed from the high bit of each byte
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth]
    bits = bits.reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, ch), size


def read_png(path: str, decode=None) -> np.ndarray:
    """Load a PNG to an (H, W, 3) float64 canvas in [0, 1]; `decode`
    pre-applies the canvas's color decode."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, ctype, _, _, interlace), plte, idat = _png_chunks(data,
                                                                    path)
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype] \
            or interlace not in (0, 1):
        kind = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
                6: "RGBA"}.get(ctype, f"colour type {ctype}")
        raise ValueError(f"unsupported PNG ({kind} at {depth} bits, "
                         f"interlace method {interlace}): {path}")
    ch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(idat)
    if interlace == 0:
        vals, _ = _png_samples(raw, w, h, ch, depth, path)
    else:
        vals = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, size = _png_samples(raw[off:], pw, ph, ch, depth, path)
            vals[y0::dy, x0::dx] = sub
            off += size
    if ctype == 3:
        if plte is None:
            raise ValueError(f"palette PNG without a PLTE chunk: {path}")
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        pal[:len(entries)] = entries
        c = pal[vals[..., 0]].astype(np.float64) / 255.0
    elif depth == 16 and ctype in (0, 2):
        c = vals.astype(np.float64) / 65535.0
    elif depth == 16:
        # 16-bit grey+alpha and RGBA: the high byte, as Pillow reads them
        c = (vals >> 8).astype(np.float64) / 255.0
    elif depth == 1:
        c = vals.astype(np.float64)
    else:
        scale = {2: 85, 4: 17, 8: 1}[depth]
        c = (vals * scale).astype(np.uint8).astype(np.float64) / 255.0
    c = np.repeat(c[..., :1], 3, -1) if ch <= 2 and ctype != 3 else c[..., :3]
    return decode(c) if decode is not None else c


def read_image(path: str, decode=None) -> np.ndarray:
    """An image in a format other than PPM and PNG (JPEG, GIF, TIFF, ...)
    as an (H, W, 3) float64 canvas, read through Pillow as the JAX
    package's texture path reads it (it converts the file to a PNG and
    reads that back through Pillow). Without Pillow it raises ValueError
    naming the file."""
    path = str(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"reading {path} needs Pillow (or convert it to a "
                         "PNG beside it)") from None
    img = Image.open(path)
    if img.mode in ("P", "PA"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        c = arr.astype(np.float64) / 255.0
    elif arr.dtype in (np.uint16, np.dtype(">u2")):
        c = arr.astype(np.float64) / 65535.0
    else:
        c = arr.astype(np.float64)
    if c.ndim == 2:
        c = np.stack([c] * 3, axis=-1)
    if c.shape[-1] in (2, 4):
        c = c[..., :3] if c.shape[-1] == 4 else np.repeat(c[..., :1], 3, -1)
    return decode(c) if decode is not None else c


def _ppm_header(data: bytes, path: str):
    """The four whitespace-separated header fields of a PPM (magic, width,
    height, maxval) and the offset of its pixel data, which starts after
    exactly one whitespace byte past maxval (netpbm's PPM format)."""
    fields, pos = [], 0
    for _ in range(4):
        while pos < len(data) and data[pos] in _PPM_WHITESPACE:
            pos += 1
        start = pos
        while pos < len(data) and data[pos] not in _PPM_WHITESPACE:
            pos += 1
        if pos == start:
            raise ValueError(f"truncated PPM header in {path}")
        fields.append(data[start:pos])
    return fields, pos + 1


def read_ppm(path: str, decode=None) -> np.ndarray:
    """Read the reference's ASCII-numbered 'P6' PPM variant
    (construct_canvas_from_ppm_file, canvas.c:329-366: fscanf %u over
    whitespace-separated values), and standard binary P6 (8 or 16 bits).
    Binary samples start one whitespace byte past maxval, so a first
    sample that is a whitespace byte is kept (the JAX reader drops it)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), start = _ppm_header(data, str(path))
    w, h, maxval = int(w), int(h), int(maxval)
    rest = data[start:]
    if magic not in (b"P6", b"P3"):
        raise ValueError(f"unsupported PPM magic {magic!r} in {path}")
    tokens = rest.split()
    if magic == b"P3" or (len(tokens) >= w * h * 3
                          and all(t.isdigit() for t in tokens[:12])):
        vals = np.array(tokens[: w * h * 3], dtype=np.float64)
    elif maxval > 255:
        vals = np.frombuffer(rest[: w * h * 6], dtype=">u2").astype(np.float64)
    else:
        vals = np.frombuffer(rest[: w * h * 3], dtype=np.uint8).astype(np.float64)
    c = (vals / float(maxval)).reshape(h, w, 3)
    return decode(c) if decode is not None else c
