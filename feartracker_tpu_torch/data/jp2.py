"""JPEG 2000 as OpenCV 5.0's ``cv2.imread`` reads it through OpenJPEG 2.5,
without cv2 or PIL.

The JP2 boxes are read here: the signature, ``ftyp`` (the second box),
``jp2h`` with its ``ihdr``, the first ``colr`` of method 1 or 2, ``pclr``,
``cmap`` and ``cdef``, then the first ``jp2c``; a file that starts ``FF 4F
FF 51`` is a raw codestream (colour space unknown). The codestream is
decoded by ``csrc/jp2.cpp`` to OpenJPEG's component samples. Then, as
OpenJPEG and OpenCV's ``Jpeg2KOpjDecoder`` do:

* a palette (``pclr`` + ``cmap``) maps its index component to new
  components, ``cdef`` moves colour channels to their association's place;
* cv2 refuses (``ValueError`` here, naming the cause) signed components,
  fewer than 1 or more than 4 components, a precision below 8 bits, a
  sub-sampled component, an image offset, the colour spaces it has no
  conversion for (CMYK, e-sYCC) and fewer than three channels outside a
  greyscale ``colr``;
* every sample is shifted right by (the largest precision - 8) and cast to
  8 bits (its low byte);
* greyscale: component 0 replicated; sYCC: cv2's ``COLOR_YUV2BGR`` on the
  first three components; sRGB and unknown spaces (a raw codestream, an
  ICC profile): the first three components as RGB (alpha dropped).
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from feartracker_tpu_torch.data import jpeg

SOURCE = jpeg.PACKAGE_DIR / "csrc" / "jp2.cpp"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
# colr enumerated colour spaces (T.800 Table I.10)
GREY, SYCC, EYCC, CMYK = 17, 18, 24, 12


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(jpeg.build(SOURCE)))
    lib.j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                               ctypes.c_int]
    lib.j2k_decode.restype = ctypes.c_int
    return lib


def is_jp2(data: bytes) -> bool:
    return data.startswith(JP2_SIGNATURE) or data.startswith(J2K_SIGNATURE)


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of each box in [pos, end)."""
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("JP2 box header is truncated")
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"JP2 box {kind!r} of a bad length")
        yield kind, pos + head, pos + size
        pos += size


def _siz(cs: bytes) -> dict:
    """The SIZ segment: image area and each component's (precision, signed,
    dx, dy)."""
    if len(cs) < 42 or cs[:4] != J2K_SIGNATURE:
        raise ValueError("JPEG 2000 codestream without SOC and SIZ")
    x1, y1, x0, y0 = struct.unpack(">IIII", cs[8:24])
    (n,) = struct.unpack(">H", cs[40:42])
    if len(cs) < 42 + 3 * n:
        raise ValueError("JPEG 2000 SIZ segment is truncated")
    comps = [((cs[42 + 3 * i] & 0x7F) + 1, cs[42 + 3 * i] >> 7, cs[43 + 3 * i], cs[44 + 3 * i]) for i in range(n)]
    if x1 <= x0 or y1 <= y0 or n == 0 or any(dx == 0 or dy == 0 for _, _, dx, dy in comps):
        raise ValueError("JPEG 2000 SIZ: empty image or a component sub-sampling of 0")
    return {"x0": x0, "y0": y0, "x1": x1, "y1": y1, "comps": comps}


def _colr(body: bytes):
    """The colour space of a colr box: its EnumCS, or 0 for an ICC profile."""
    if len(body) < 3:
        raise ValueError("JP2 colr box too short")
    if body[0] == 1:
        if len(body) < 7:
            raise ValueError("JP2 colr box too short")
        return struct.unpack(">I", body[3:7])[0]
    return 0


def _pclr(body: bytes):
    """(entries, each column's (bits, signed), values (entries, columns))."""
    if len(body) < 3:
        raise ValueError("JP2 pclr box too short")
    ne, npc = struct.unpack(">HB", body[:3])
    if ne == 0 or ne > 1024 or npc == 0 or len(body) < 3 + npc:
        raise ValueError("JP2 pclr box: bad number of entries or columns")
    cols = [((b & 0x7F) + 1, b >> 7) for b in body[3:3 + npc]]
    if any(bits > 32 for bits, _ in cols):
        raise ValueError("JP2 pclr box: a palette column deeper than 32 bits")
    vals = np.zeros((ne, npc), np.int64)
    at = 3 + npc
    for e in range(ne):
        for c, (bits, _) in enumerate(cols):
            k = (bits + 7) // 8
            if at + k > len(body):
                raise ValueError("JP2 pclr box is truncated")
            vals[e, c] = int.from_bytes(body[at:at + k], "big")
            at += k
    return cols, vals


def jp2_header(data: bytes) -> dict:
    """The codestream, its SIZ, the colour space (EnumCS; 0 where unknown)
    and the palette, component mapping and channel definitions of a JP2
    file or a raw codestream, with OpenJPEG's box-order checks."""
    if data.startswith(J2K_SIGNATURE):
        return {"codestream": data, "siz": _siz(data), "colour": 0, "pclr": None, "cmap": None, "cdef": None}
    colour, pclr, cmap, cdef, cs, ihdr = None, None, None, None, None, False
    for i, (kind, at, end) in enumerate(_boxes(data, 0, len(data))):
        if i == 1 and kind != b"ftyp":
            raise ValueError("JP2: the file type (ftyp) box must be the second box")
        if kind == b"jp2h":
            for sub, sat, send in _boxes(data, at, end):
                body = data[sat:send]
                if sub == b"ihdr":
                    ihdr = True
                elif sub == b"colr" and colour is None and body[:1] in (b"\x01", b"\x02"):
                    colour = _colr(body)  # the first colr box of method 1 or 2; others are ignored
                elif sub == b"pclr":
                    pclr = _pclr(body)
                elif sub == b"cmap":
                    if len(body) % 4:
                        raise ValueError("JP2 cmap box of a bad length")
                    cmap = [struct.unpack(">HBB", body[i:i + 4]) for i in range(0, len(body), 4)]
                elif sub == b"cdef":
                    (n,) = struct.unpack(">H", body[:2])
                    if len(body) < 2 + 6 * n:
                        raise ValueError("JP2 cdef box is truncated")
                    cdef = [struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i]) for i in range(n)]
            if not ihdr:
                raise ValueError("JP2 header (jp2h) box without an ihdr box")
        elif kind == b"jp2c":
            if not ihdr:
                raise ValueError("JP2 codestream (jp2c) box before the header (jp2h) box")
            cs = data[at:end]
            break
    if cs is None:
        raise ValueError("JP2 file without a codestream (jp2c) box")
    return {"codestream": cs, "siz": _siz(cs), "colour": colour or 0, "pclr": pclr, "cmap": cmap, "cdef": cdef}


def check(hd: dict) -> int:
    """What OpenJPEG and cv2's readHeader and readData refuse, from the
    headers alone, named; the number of components after the palette."""
    from feartracker_tpu_torch.data.imread import check_size

    siz = hd["siz"]
    comps = siz["comps"]
    if not 1 <= len(comps) <= 4:
        raise ValueError(f"JPEG 2000 with {len(comps)} components (cv2 reads 1 to 4)")
    for i, (prec, sgnd, dx, dy) in enumerate(comps):
        if sgnd:
            raise ValueError(f"JPEG 2000 component {i}/{len(comps)} is signed (cv2 reads unsigned components)")
    if max(c[0] for c in comps) < 8:
        raise ValueError("JPEG 2000 precision below 8 bits is not read by cv2")
    palette = hd["pclr"] is not None and hd["cmap"] is not None
    nchannels = len(hd["pclr"][0]) if palette else len(comps)
    if hd["cdef"]:
        _check_cdef(hd["cdef"], nchannels)
    if palette:
        _check_palette(hd, len(comps))
    for i, (prec, sgnd, dx, dy) in enumerate(comps):
        if dx != 1 or dy != 1:
            raise ValueError(f"JPEG 2000 component {i} is sub-sampled ({dx}x{dy}): cv2 reads no sub-sampled component")
    if siz["x0"] or siz["y0"]:
        raise ValueError(f"JPEG 2000 image offset ({siz['x0']}, {siz['y0']}): cv2 reads images at the origin only")
    check_size(siz["x1"], siz["y1"], "JPEG 2000")
    if hd["colour"] in (CMYK, EYCC):
        raise ValueError(f"JPEG 2000 colour space {hd['colour']} (CMYK or e-sYCC) has no conversion in cv2")
    if hd["colour"] != GREY and nchannels < 3:
        space = "YUV" if hd["colour"] == SYCC else "SRGB"
        raise ValueError(f"JPEG 2000: cv2 has no conversion from {nchannels} components to 3 for {space} images")
    return nchannels


def frame_size(data: bytes):
    """(W, H) of the frame ``cv2.imread`` would give, from the headers alone;
    ``ValueError`` where it reads nothing."""
    hd = jp2_header(data)
    check(hd)
    siz = hd["siz"]
    return siz["x1"] - siz["x0"], siz["y1"] - siz["y0"]


def decode_components(cs: bytes, siz: dict) -> list:
    """A codestream → each component's samples, int32 (h, w)."""
    shapes = [(-(-siz["y1"] // dy) - -(-siz["y0"] // dy), -(-siz["x1"] // dx) - -(-siz["x0"] // dx))
              for _, _, dx, dy in siz["comps"]]
    out = np.empty(sum(h * w for h, w in shapes), np.int32)
    err = ctypes.create_string_buffer(256)
    if load_library().j2k_decode(cs, len(cs), out.ctypes.data, out.size, err, len(err)):
        raise ValueError(f"JPEG 2000: {err.value.decode()}")
    planes, at = [], 0
    for h, w in shapes:
        planes.append(out[at:at + h * w].reshape(h, w))
        at += h * w
    return planes


def _check_palette(hd: dict, ncomps: int) -> list:
    """opj_jp2_check_color's palette checks; the cmap entries as OpenJPEG
    uses them (a one-component image whose mapping leaves a column unused is
    mapped column by column, as OpenJPEG corrects it)."""
    cols, _ = hd["pclr"]
    cmap = [list(m) for m in hd["cmap"]]
    n = len(cols)
    if len(cmap) < n:
        raise ValueError("JP2 cmap box has fewer channels than the palette")
    cmap = cmap[:n]
    used = [False] * n
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= ncomps:
            raise ValueError(f"JP2 cmap: invalid component index {cmp}")
        if mtyp not in (0, 1) or pcol >= n or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol != 0):
            raise ValueError(f"JP2 cmap: invalid mapping of channel {i}")
        if mtyp == 1 and pcol != i:
            raise ValueError(f"JP2 cmap: palette column {pcol} mapped to channel {i} (OpenJPEG maps column i to "
                             f"channel i only)")
        used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(n)):
        raise ValueError("JP2 cmap: a palette channel without a mapping")
    if ncomps == 1 and not all(used):
        cmap = [[c[0], 1, i] for i, c in enumerate(cmap)]
    return cmap


def _apply_palette(planes, hd):
    """opj_jp2_apply_pclr: each cmap channel is a component as it is (MTYP
    0) or a palette column indexed by one, the index clamped to the
    palette."""
    _, vals = hd["pclr"]
    out = []
    for cmp, mtyp, pcol in _check_palette(hd, len(planes)):
        if mtyp == 0:
            out.append(planes[cmp])
        else:
            out.append(vals[np.clip(planes[cmp], 0, len(vals) - 1), pcol].astype(np.int32))
    return out


def _apply_cdef(planes, cdef):
    """opj_jp2_apply_cdef: a colour channel (type 0) associated with colour
    asoc moves to component asoc - 1, the later definitions following the
    swap; alpha and unassociated channels stay."""
    planes = list(planes)
    cns = [cn for cn, _, _ in cdef]
    for i, (_, typ, asoc) in enumerate(cdef):
        cn = cns[i]
        if cn >= len(planes) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn < len(planes) and cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for j in range(i + 1, len(cdef)):
                if cns[j] == cn:
                    cns[j] = acn
                elif cns[j] == acn:
                    cns[j] = cn
    return planes


def _check_cdef(cdef, nchannels: int) -> None:
    """opj_jp2_check_color's channel-definition checks."""
    for cn, _, asoc in cdef:
        if cn >= nchannels or (asoc not in (0, 65535) and asoc - 1 >= nchannels):
            raise ValueError(f"JP2 cdef: invalid channel index (of {nchannels})")
    if any(c not in [d[0] for d in cdef] for c in range(nchannels)):
        raise ValueError("JP2 cdef: incomplete channel definitions")


def decode_jp2(data: bytes) -> np.ndarray:
    """JP2 or J2K bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    hd = jp2_header(data)
    check(hd)
    siz = hd["siz"]
    planes = decode_components(hd["codestream"], siz)
    if hd["pclr"] is not None and hd["cmap"] is not None:
        planes = _apply_palette(planes, hd)
    if hd["cdef"]:
        planes = _apply_cdef(planes, hd["cdef"])
    shift = max(c[0] for c in siz["comps"]) - 8
    planes = [(p >> shift).astype(np.uint8) for p in planes]  # OpenCV's static_cast: the low 8 bits
    if hd["colour"] == GREY:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if hd["colour"] == SYCC:
        return _yuv_to_rgb(planes)
    return np.stack(planes[:3], axis=-1)


def _yuv_to_rgb(planes) -> np.ndarray:
    """``cv2.cvtColor(..., COLOR_YUV2BGR)`` on 8-bit (Y, U, V): BT.601
    coefficients in 14-bit fixed point, rounded, saturated."""
    y, u, v = (p.astype(np.int64) for p in planes[:3])
    u, v = u - 128, v - 128
    r = y + ((v * 18678 + 8192) >> 14)
    g = y + ((u * -6472 + v * -9519 + 8192) >> 14)
    b = y + ((u * 33292 + 8192) >> 14)
    return np.stack([np.clip(c, 0, 255) for c in (r, g, b)], axis=-1).astype(np.uint8)
