"""Evaluation harnesses and PNG files without PIL (port of
pixelsynth_tpu/eval/harness.py, and a PNG reader).

`eval_quality` mirrors evaluation/eval_quality.py (gen_paired_img over a
paired set, saving input/ tgt/ pred/ fs/ PNGs, 112-154) and
`eval_consistency` evaluation/eval_consistency.py (gen_two_imgs: the full
and the half rotation of each item's fixed direction, 101-149); the metric
battery (eval/calc_errors.py, eval/calc_errors_consistency.py) then reads
the folders.  Items go through the sampling population in batches, the
last batch padded by repeating its last item; the batch that starts at item
i is drawn from seed + i, so a run sharded by `start`/`limit` on batch
boundaries writes what one run writes.

The machines the port runs on need not have PIL.

`save_png` writes an 8-bit RGB PNG from zlib and struct alone, after the
JAX package's rule: an image with values below -0.01 is taken as [-1, 1]
and mapped to [0, 1], then np.clip(x * 255, 0, 255).astype(uint8)
(truncation).  `load_png` reads non-interlaced 8-bit RGB and RGBA PNGs
with any of the five row filters: the port's own files and those PIL
writes."""

from __future__ import annotations

import os
import struct
import zlib

from typing import Dict, List, Optional, Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}   # colour type (RGB, RGBA) -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an RGB PNG (every row filter 0)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {arr.shape}")
    H, W, _ = arr.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), arr.reshape(H, W * 3)], 1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> str:
    """img (H, W, 3) in [-1, 1] or [0, 1] -> an 8-bit RGB PNG at path."""
    arr = np.asarray(img)
    if arr.min() < -0.01:
        arr = arr * 0.5 + 0.5
    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) -> (H, stride) uint8."""
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: running sum over pixels, per sample
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), 0) % 256
                   ).astype(np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: left to right
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG -> (H, W, C) uint8, C = 3 or 4."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG of depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only non-interlaced 8-bit RGB/RGBA")
    C = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (W * C + 1):
        raise ValueError("PNG image data has the wrong length")
    return _unfilter(raw, H, W * C, C).reshape(H, W, C)


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _SIGNATURE


def load_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, C) uint8 (C as stored: 3 for RGB, 4 for RGBA)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _batches(dataset: Sequence[Dict], start: int, limit: Optional[int], batch_size: int):
    """(first index, the real indices, the padded batch's items)."""
    n = len(dataset) if limit is None else min(start + limit, len(dataset))
    for i0 in range(start, n, batch_size):
        idxs = list(range(i0, min(i0 + batch_size, n)))
        padded = idxs + [idxs[-1]] * (batch_size - len(idxs))
        yield i0, idxs, [dataset[j] for j in padded]


def _stack(items: List[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(it[k]) for it in items])
            for k in items[0] if k != "direction"}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def eval_quality(ps, dataset: Sequence[Dict], out_dir: str, *, num_samples: int = 1,
                 temperature: float = 0.5, limit: Optional[int] = None, start: int = 0,
                 batch_size: int = 1, seed: int = 0) -> None:
    """gen_paired_img over a paired dataset (items with input_img,
    output_img (W, W, 3) in [-1, 1]; K, Kinv, P_in, Pinv_in, P_out (4, 4)):
    writes input/ tgt/ pred/ fs/%04d.png under out_dir
    (eval_quality.py:112-154)."""
    from pixelsynth_tpu_torch.pipeline import CloudState
    from pixelsynth_tpu_torch.scene import SceneGenerator

    gen = SceneGenerator(ps, num_samples=num_samples, temperature=temperature,
                         cloud_capacity=ps.W * ps.W)
    for i0, idxs, items in _batches(dataset, start, limit, batch_size):
        b = _stack(items)
        cams = {k: b[k] for k in ("K", "Kinv", "P_in", "Pinv_in", "P_out")}
        cloud = CloudState.empty(batch_size, ps.W * ps.W, 3, ps.device)
        best, out = gen.generate_view(b["input_img"], cams, cloud, None, b["Pinv_in"],
                                      seed + i0)
        best, fs = _np(best), _np(out["gen_fs"])
        for j, i in enumerate(idxs):
            for sub, img in (("input", b["input_img"][j]), ("tgt", b["output_img"][j]),
                             ("pred", best[j]), ("fs", fs[j])):
                save_png(os.path.join(out_dir, sub, f"{i:04d}.png"), img)


def eval_consistency(ps, dataset: Sequence[Dict], out_dir: str, *, num_samples: int = 1,
                     temperature: float = 0.5, limit: Optional[int] = None,
                     start: int = 0, batch_size: int = 1, seed: int = 0) -> None:
    """gen_two_imgs per item (the items of `eval_quality` plus `direction`,
    an index into DIRECTION_ORDER): the full and the half rotation of the
    item's direction, written as %04d/output_image_<dir>_0002.png and
    _0001.png (eval_consistency.py:101-149)."""
    from pixelsynth_tpu_torch.geometry.paths import DIRECTION_ORDER
    from pixelsynth_tpu_torch.scene import TwoImageGenerator

    gen = TwoImageGenerator(ps, num_samples=num_samples, temperature=temperature,
                            cloud_capacity=2 * ps.W * ps.W)
    for i0, idxs, items in _batches(dataset, start, limit, batch_size):
        directions = [DIRECTION_ORDER[int(it["direction"])] for it in items]
        b = _stack(items)
        outputs = gen.generate_two_imgs(b["input_img"], b["K"], b["Kinv"], b["P_in"],
                                        b["Pinv_in"], directions, seed=seed + i0)
        for j, i in enumerate(idxs):
            folder = os.path.join(out_dir, f"{i:04d}")
            for num in (2, 1):
                save_png(os.path.join(folder, f"output_image_{directions[j]}_000{num}.png"),
                         outputs[f"PredImg_{num}"][j])
