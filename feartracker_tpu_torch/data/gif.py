"""GIF as OpenCV 5.0's own decoder (``grfmt_gif.cpp``, not giflib) gives
the first frame to ``cv2.imread``, without cv2.

``GIF87a`` / ``GIF89a``: the logical screen starts as the global colour
table's background colour (black where the file has no global table); the
first image is drawn at its offset with its local table, else the global
one; its transparent pixels (Graphic Control Extension) leave the screen as
it is; interlaced rows are put back in order. A palette index past the
table, an image outside the screen or broken LZW data raises
``ValueError``, where cv2 reads nothing. The LZW loop is
``csrc/imgcodecs.cpp:gif_lzw``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np


def is_gif(data: bytes) -> bool:
    return data[:6] in (b"GIF87a", b"GIF89a")


def _table(data: bytes, pos: int, flags: int):
    n = 1 << ((flags & 7) + 1)
    tab = np.frombuffer(data, np.uint8, 3 * n, pos) if pos + 3 * n <= len(data) else None
    if tab is None:
        raise ValueError("GIF ends inside a colour table")
    return tab.reshape(n, 3), pos + 3 * n


def gif_header(data: bytes) -> dict:
    """Screen size, global table and background index."""
    if len(data) < 13:
        raise ValueError("GIF header is truncated")
    W, H, flags, bg = struct.unpack("<HHBB", data[6:12])
    pos, table = 13, None
    if flags & 0x80:
        table, pos = _table(data, pos, flags)
        if bg >= len(table):
            raise ValueError(f"GIF background index {bg} past its {len(table)}-colour table")
    if W == 0 or H == 0:
        raise ValueError(f"GIF screen of {W}x{H}")
    return {"width": W, "height": H, "table": table, "background": bg, "pos": pos}


def first_image(data: bytes) -> dict:
    """The header and the first image's descriptor, checked as OpenCV's
    ``readData`` checks them: placement inside the screen, a colour table.
    → the header's keys plus ``left``, ``top``, ``w``, ``h``, ``flags``,
    ``table`` (the one it uses), ``global``, ``transparent`` and ``pos`` (of
    the LZW minimum code size)."""
    hd = gif_header(data)
    W, H, gtab, pos = hd["width"], hd["height"], hd["table"], hd["pos"]
    transparent = None
    while True:
        if pos >= len(data):
            raise ValueError("GIF without an image")
        block = data[pos]
        if block == 0x3B:
            raise ValueError("GIF without an image")
        if block == 0x21:  # extension: label, then sub-blocks
            if pos + 2 > len(data):
                raise ValueError("GIF ends inside an extension")
            label = data[pos + 1]
            pos += 2
            if label == 0xF9 and pos + 5 <= len(data) and data[pos] >= 4:
                transparent = data[pos + 4] if data[pos + 1] & 1 else None
            while pos < len(data) and data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if block != 0x2C:
            raise ValueError(f"GIF block {block:#x} where an image or extension should be")
        break
    if pos + 10 > len(data):
        raise ValueError("GIF ends inside an image descriptor")
    left, top, w, h, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    pos += 10
    if w == 0 or h == 0 or left + w > W or top + h > H:
        raise ValueError(f"GIF image {w}x{h} at ({left}, {top}) outside its {W}x{H} screen")
    if flags & 0x80:
        table, pos = _table(data, pos, flags)
    elif gtab is not None:
        table = gtab
    else:
        raise ValueError("GIF image without a colour table")
    if pos >= len(data):
        raise ValueError("GIF ends before its image data")
    return dict(hd, left=left, top=top, w=w, h=h, flags=flags, table=table, transparent=transparent, pos=pos,
                **{"global": gtab})


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → (H, W, 3) uint8 RGB of the first frame, as ``cv2.imread``
    gives it."""
    from feartracker_tpu_torch.data.imread import load_library

    im = first_image(data)
    W, H, gtab, table, pos = im["width"], im["height"], im["global"], im["table"], im["pos"]
    left, top, w, h, flags, transparent = im["left"], im["top"], im["w"], im["h"], im["flags"], im["transparent"]
    idx = np.empty(w * h, np.uint16)
    used = ctypes.c_size_t()
    err = ctypes.create_string_buffer(128)
    body = data[pos + 1:]
    if load_library().gif_lzw(body, len(body), data[pos], idx.ctypes.data, idx.size, ctypes.byref(used), err,
                              len(err)):
        raise ValueError(err.value.decode())
    idx = idx.reshape(h, w)
    if flags & 0x40:
        rows = np.concatenate([np.arange(s, h, d) for s, d in ((0, 8), (4, 8), (2, 4), (1, 2))])
        inter = np.empty_like(idx)
        inter[rows] = idx
        idx = inter
    if int(idx.max()) >= len(table):
        raise ValueError(f"GIF palette index {int(idx.max())} past its {len(table)}-colour table")
    screen = np.zeros((H, W, 3), np.uint8)
    if gtab is not None:
        screen[:] = gtab[im["background"]]
    region = screen[top:top + h, left:left + w]
    if transparent is None:
        region[:] = table[idx]
    else:
        keep = idx != transparent
        region[keep] = table[idx[keep]]
    return screen
