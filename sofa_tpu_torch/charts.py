"""Charts without a plotting library: a page of axes drawn as vector
operations, written as a multi-page PDF (lines, rectangles and Helvetica
text) or rasterized to a PNG (the plots and axes; the PDF carries the
text).  ``export_static`` draws its pages with it, on hosts that have no
matplotlib as on those that do.

Coordinates are PDF points from the page's bottom-left corner.  Only the
standard library and numpy are used: the PDF is written object by object
with its cross-reference table, the PNG by zlib and crc32.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAGE_W, PAGE_H = 612.0, 396.0          # 8.5 x 5.5 inches
INK, INK2, GRID = "#0b0b0b", "#52514e", "#e5e4e0"
PAPER = "#fcfcfb"


def _rgb(color: str) -> Tuple[float, float, float]:
    c = color.lstrip("#")
    return tuple(int(c[i:i + 2], 16) / 255.0 for i in (0, 2, 4))


def nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """Round tick values (1, 2 or 5 times a power of ten) covering
    [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo] if math.isfinite(lo) else []
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step) * step
    out = []
    v = first
    while v <= hi + step * 1e-9:
        out.append(round(v, 12))
        v += step
    return out


class Canvas:
    """One page's drawing operations, in order."""

    def __init__(self) -> None:
        self.ops: List[tuple] = []

    def line(self, xs, ys, color: str, width: float = 1.0) -> None:
        xs = np.asarray(xs, dtype=float)
        ys = np.asarray(ys, dtype=float)
        ok = np.isfinite(xs) & np.isfinite(ys)
        if ok.sum() >= 2:
            self.ops.append(("line", xs[ok], ys[ok], color, width))

    def rect(self, x: float, y: float, w: float, h: float,
             color: str) -> None:
        self.ops.append(("rect", x, y, w, h, color))

    def text(self, x: float, y: float, s: str, size: float = 7.0,
             color: str = INK2, align: str = "left") -> None:
        self.ops.append(("text", x, y, str(s), size, color, align))


def text_width(s: str, size: float) -> float:
    """Helvetica's average advance, about half the size a character."""
    return 0.52 * size * len(s)


class Axes:
    """A plot area of a page: data limits, marks, then ``finish`` draws
    the frame, grid, ticks, labels, title and legend."""

    def __init__(self, canvas: Canvas, x0: float, y0: float, x1: float,
                 y1: float) -> None:
        self.c = canvas
        self.box = (x0, y0, x1, y1)
        self.xlim: Optional[Tuple[float, float]] = None
        self.ylim: Optional[Tuple[float, float]] = None
        self.legend: List[Tuple[str, str]] = []
        self.ycats: Optional[List[str]] = None
        self.xcats: Optional[List[str]] = None
        self._marks: List[tuple] = []

    def _grow(self, xs, ys) -> None:
        xs = np.asarray(xs, dtype=float)
        ys = np.asarray(ys, dtype=float)
        xs, ys = xs[np.isfinite(xs)], ys[np.isfinite(ys)]
        if len(xs):
            lo, hi = float(xs.min()), float(xs.max())
            self.xlim = (lo, hi) if self.xlim is None else (
                min(self.xlim[0], lo), max(self.xlim[1], hi))
        if len(ys):
            lo, hi = float(ys.min()), float(ys.max())
            self.ylim = (lo, hi) if self.ylim is None else (
                min(self.ylim[0], lo), max(self.ylim[1], hi))

    def plot(self, xs, ys, color: str, label: str = "") -> None:
        self._grow(xs, ys)
        self._marks.append(("line", xs, ys, color))
        if label:
            self.legend.append((label, color))

    def scatter(self, xs, ys, color: str) -> None:
        self._grow(xs, ys)
        self._marks.append(("dots", xs, ys, color))

    def barh(self, labels: Sequence[str], values, color: str) -> None:
        """Horizontal bars from 0, the first label at the bottom."""
        values = np.asarray(values, dtype=float)
        self._grow([0.0, float(values.max()) if len(values) else 1.0],
                   [-0.5, len(values) - 0.5])
        self.ycats = list(labels)
        self._marks.append(("bars", values, color))

    def heat(self, matrix, row_labels, col_labels, ramp) -> None:
        """A matrix of cells coloured by ``ramp(value / max)``, row 0 at
        the top."""
        m = np.asarray(matrix, dtype=float)
        self.xlim = (-0.5, m.shape[1] - 0.5)
        self.ylim = (-0.5, m.shape[0] - 0.5)
        self.ycats = [str(v) for v in row_labels][::-1]
        self.xcats = [str(v) for v in col_labels]
        self._marks.append(("heat", m, ramp))

    def _to_page(self, xs, ys):
        x0, y0, x1, y1 = self.box
        (a, b), (c, d) = self._limits()
        px = x0 + (np.asarray(xs, dtype=float) - a) / (b - a) * (x1 - x0)
        py = y0 + (np.asarray(ys, dtype=float) - c) / (d - c) * (y1 - y0)
        return px, py

    def _limits(self):
        def pad(lim, default):
            if lim is None:
                return default
            lo, hi = lim
            if hi <= lo:
                return (lo - 0.5, hi + 0.5) if lo == hi else default
            return lo, hi
        return pad(self.xlim, (0.0, 1.0)), pad(self.ylim, (0.0, 1.0))

    def finish(self, title: str, xlabel: str = "", ylabel: str = "",
               empty_note: str = "no data in this capture") -> None:
        x0, y0, x1, y1 = self.box
        c = self.c
        (xa, xb), (ya, yb) = self._limits()
        if self.ycats is None:
            for v in nice_ticks(ya, yb):
                py = y0 + (v - ya) / (yb - ya) * (y1 - y0)
                c.line([x0, x1], [py, py], GRID, 0.5)
                c.text(x0 - 3, py - 2, f"{v:g}", 6, INK2, "right")
        else:
            for i, lbl in enumerate(self.ycats):
                py = y0 + (i - ya) / (yb - ya) * (y1 - y0)
                c.text(x0 - 3, py - 2, lbl, 6, INK2, "right")
        if self.xcats is None:
            for v in nice_ticks(xa, xb):
                px = x0 + (v - xa) / (xb - xa) * (x1 - x0)
                c.line([px, px], [y0, y1], GRID, 0.5)
                c.text(px, y0 - 9, f"{v:g}", 6, INK2, "center")
        else:
            for i, lbl in enumerate(self.xcats):
                px = x0 + (i - xa) / (xb - xa) * (x1 - x0)
                c.text(px, y0 - 9, lbl, 6, INK2, "center")
        for mark in self._marks:
            kind = mark[0]
            if kind == "line":
                px, py = self._to_page(mark[1], mark[2])
                c.line(px, py, mark[3], 1.2)
            elif kind == "dots":
                px, py = self._to_page(mark[1], mark[2])
                for a, b in zip(px, py):
                    c.rect(a - 1.2, b - 1.2, 2.4, 2.4, mark[3])
            elif kind == "bars":
                vals = mark[1]
                for i, v in enumerate(vals):
                    (bx0, bx1), (by0, by1) = self._to_page(
                        [0.0, v], [i - 0.3, i + 0.3])
                    c.rect(bx0, by0, bx1 - bx0, by1 - by0, mark[2])
            elif kind == "heat":
                m, ramp = mark[1], mark[2]
                top = float(m.max()) if m.size and m.max() > 0 else 1.0
                rows = m.shape[0]
                for r in range(rows):
                    for col in range(m.shape[1]):
                        (cx0, cx1), (cy0, cy1) = self._to_page(
                            [col - 0.5, col + 0.5],
                            [rows - 1 - r - 0.5, rows - 1 - r + 0.5])
                        c.rect(cx0, cy0, cx1 - cx0, cy1 - cy0,
                               ramp(float(m[r, col]) / top))
        c.line([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], GRID, 0.6)
        if not self._marks:
            c.text((x0 + x1) / 2, (y0 + y1) / 2, empty_note, 8, INK2,
                   "center")
        c.text(x0, y1 + 5, title, 9, INK)
        if xlabel:
            c.text((x0 + x1) / 2, y0 - 19, xlabel, 7, INK2, "center")
        if ylabel:
            c.text(x0 - 30, y1 + 5, ylabel, 7, INK2, "right")
        lx = x1 - 4
        for i, (label, color) in enumerate(self.legend):
            ly = y1 - 10 - 9 * i
            c.rect(lx - text_width(label, 6) - 14, ly, 8, 3, color)
            c.text(lx, ly - 1, label, 6, INK2, "right")


def ramp(stops: Sequence[str]):
    """value in [0, 1] -> a hex colour interpolated between ``stops``."""
    rgb = np.array([_rgb(s) for s in stops])

    def at(v: float) -> str:
        v = min(max(v, 0.0), 1.0) * (len(rgb) - 1)
        i = min(int(v), len(rgb) - 2)
        f = v - i
        r, g, b = rgb[i] * (1 - f) + rgb[i + 1] * f
        return "#%02x%02x%02x" % (round(r * 255), round(g * 255),
                                  round(b * 255))
    return at


# --- PDF ---------------------------------------------------------------------

def _pdf_text(s: str) -> str:
    s = s.encode("latin-1", "replace").decode("latin-1")
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _content(canvas: Canvas) -> bytes:
    out = ["%.3f %.3f %.3f rg 0 0 %.1f %.1f re f" % (*_rgb(PAPER), PAGE_W,
                                                     PAGE_H)]
    for op in canvas.ops:
        if op[0] == "line":
            _, xs, ys, color, width = op
            pts = " ".join("%.2f %.2f l" % (x, y)
                           for x, y in zip(xs[1:], ys[1:]))
            out.append("%.3f %.3f %.3f RG %.2f w 1 j %.2f %.2f m %s S"
                       % (*_rgb(color), width, xs[0], ys[0], pts))
        elif op[0] == "rect":
            _, x, y, w, h, color = op
            out.append("%.3f %.3f %.3f rg %.2f %.2f %.2f %.2f re f"
                       % (*_rgb(color), x, y, w, h))
        else:
            _, x, y, s, size, color, align = op
            if align == "right":
                x -= text_width(s, size)
            elif align == "center":
                x -= text_width(s, size) / 2
            out.append("BT %.3f %.3f %.3f rg /F1 %.1f Tf %.2f %.2f Td "
                       "(%s) Tj ET" % (*_rgb(color), size, x, y,
                                       _pdf_text(s)))
    return "\n".join(out).encode("latin-1")


def write_pdf(pages: List[Canvas], path: str) -> None:
    """The pages as one PDF (objects: catalog, page tree, font, then a
    page and its content stream each)."""
    n = len(pages)
    kids = " ".join(f"{4 + 2 * i} 0 R" for i in range(n))
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            f"<< /Type /Pages /Kids [{kids}] /Count {n} >>".encode(),
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>"]
    for i, page in enumerate(pages):
        objs.append((f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
                     f"{PAGE_W:g} {PAGE_H:g}] /Resources << /Font << /F1 3 "
                     f"0 R >> >> /Contents {5 + 2 * i} 0 R >>").encode())
        body = zlib.compress(_content(page))
        objs.append(f"<< /Length {len(body)} /Filter /FlateDecode >>\n"
                    .encode() + b"stream\n" + body + b"\nendstream")
    buf = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(buf))
        buf += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(buf)
    buf += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    for off in offsets:
        buf += f"{off:010d} 00000 n \n".encode()
    buf += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\nstartxref\n"
            f"{xref}\n%%EOF\n").encode()
    with open(path, "wb") as f:
        f.write(bytes(buf))


# --- PNG ---------------------------------------------------------------------

def _stamp(img: np.ndarray, px, py, color, half: int) -> None:
    h, w, _ = img.shape
    px = np.clip(np.round(px).astype(int), 0, w - 1)
    py = np.clip(np.round(py).astype(int), 0, h - 1)
    rgb = np.array([round(v * 255) for v in _rgb(color)], dtype=np.uint8)
    for dx in range(-half, half + 1):
        for dy in range(-half, half + 1):
            img[np.clip(py + dy, 0, h - 1), np.clip(px + dx, 0, w - 1)] = rgb


def rasterize(canvas: Canvas, scale: float = 2.0) -> np.ndarray:
    """The page's lines and rectangles as an RGB image (text left out)."""
    w, h = int(PAGE_W * scale), int(PAGE_H * scale)
    img = np.empty((h, w, 3), dtype=np.uint8)
    img[:] = [round(v * 255) for v in _rgb(PAPER)]
    for op in canvas.ops:
        if op[0] == "rect":
            _, x, y, rw, rh, color = op
            c0, c1 = sorted((int(round(x * scale)),
                             int(round((x + rw) * scale))))
            r0, r1 = sorted((int(round(h - (y + rh) * scale)),
                             int(round(h - y * scale))))
            img[max(r0, 0):max(r1, r0 + 1), max(c0, 0):max(c1, c0 + 1)] = \
                [round(v * 255) for v in _rgb(color)]
        elif op[0] == "line":
            _, xs, ys, color, width = op
            x, y = xs * scale, h - ys * scale
            seg = np.hypot(np.diff(x), np.diff(y))
            k = np.maximum(np.ceil(seg).astype(int), 1)
            idx = np.repeat(np.arange(len(k)), k)
            # each segment sampled a pixel apart: t in [0, 1) along it
            t = (np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)) \
                / np.repeat(k, k)
            px = x[idx] + t * np.diff(x)[idx]
            py = y[idx] + t * np.diff(y)[idx]
            _stamp(img, np.append(px, x[-1]), np.append(py, y[-1]), color,
                   max(int(width * scale / 2), 0))
    return img


def write_png(canvas: Canvas, path: str, scale: float = 2.0) -> None:
    img = rasterize(canvas, scale)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
