"""Tiny built-in bitmap font + framebuffer text overlay.

The reference embeds a 6x12 bitmap font and draws text as textured quads
(hs-src/Font.hs:17-60); status text renders over every frame
(App.hs:106-129). Here a hand-authored 5x7 LED-style face (uppercase,
digits, punctuation) burns directly into the uint32 framebuffer — the
engine has no quad pipeline because it has no GPU window.

Glyphs are authored in-repo as visual rows ('#' = lit); nothing is copied
from the reference's font table.
"""

from __future__ import annotations

import numpy as np

_GLYPHS = {
    "A": ".###.|#...#|#...#|#####|#...#|#...#|#...#",
    "B": "####.|#...#|#...#|####.|#...#|#...#|####.",
    "C": ".###.|#...#|#....|#....|#....|#...#|.###.",
    "D": "####.|#...#|#...#|#...#|#...#|#...#|####.",
    "E": "#####|#....|#....|####.|#....|#....|#####",
    "F": "#####|#....|#....|####.|#....|#....|#....",
    "G": ".###.|#...#|#....|#.###|#...#|#...#|.###.",
    "H": "#...#|#...#|#...#|#####|#...#|#...#|#...#",
    "I": ".###.|..#..|..#..|..#..|..#..|..#..|.###.",
    "J": "..###|...#.|...#.|...#.|...#.|#..#.|.##..",
    "K": "#...#|#..#.|#.#..|##...|#.#..|#..#.|#...#",
    "L": "#....|#....|#....|#....|#....|#....|#####",
    "M": "#...#|##.##|#.#.#|#.#.#|#...#|#...#|#...#",
    "N": "#...#|##..#|#.#.#|#..##|#...#|#...#|#...#",
    "O": ".###.|#...#|#...#|#...#|#...#|#...#|.###.",
    "P": "####.|#...#|#...#|####.|#....|#....|#....",
    "Q": ".###.|#...#|#...#|#...#|#.#.#|#..#.|.##.#",
    "R": "####.|#...#|#...#|####.|#.#..|#..#.|#...#",
    "S": ".####|#....|#....|.###.|....#|....#|####.",
    "T": "#####|..#..|..#..|..#..|..#..|..#..|..#..",
    "U": "#...#|#...#|#...#|#...#|#...#|#...#|.###.",
    "V": "#...#|#...#|#...#|#...#|#...#|.#.#.|..#..",
    "W": "#...#|#...#|#...#|#.#.#|#.#.#|##.##|#...#",
    "X": "#...#|#...#|.#.#.|..#..|.#.#.|#...#|#...#",
    "Y": "#...#|#...#|.#.#.|..#..|..#..|..#..|..#..",
    "Z": "#####|....#|...#.|..#..|.#...|#....|#####",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": ".###.|#...#|....#|..##.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": ".###.|#....|#....|####.|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|..#..|..#..|..#..",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|....#|.###.",
    " ": ".....|.....|.....|.....|.....|.....|.....",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    ",": ".....|.....|.....|.....|.##..|..#..|.#...",
    ":": ".....|.##..|.##..|.....|.##..|.##..|.....",
    "|": "..#..|..#..|..#..|..#..|..#..|..#..|..#..",
    "/": "....#|....#|...#.|..#..|.#...|#....|#....",
    "-": ".....|.....|.....|#####|.....|.....|.....",
    "+": ".....|..#..|..#..|#####|..#..|..#..|.....",
    "(": "...#.|..#..|.#...|.#...|.#...|..#..|...#.",
    ")": ".#...|..#..|...#.|...#.|...#.|..#..|.#...",
    "[": ".###.|.#...|.#...|.#...|.#...|.#...|.###.",
    "]": ".###.|...#.|...#.|...#.|...#.|...#.|.###.",
    "%": "##..#|##..#|...#.|..#..|.#...|#..##|#..##",
    "#": ".#.#.|#####|.#.#.|.#.#.|.#.#.|#####|.#.#.",
    "=": ".....|.....|#####|.....|#####|.....|.....",
    "?": ".###.|#...#|....#|...#.|..#..|.....|..#..",
    "'": "..#..|..#..|.....|.....|.....|.....|.....",
    "_": ".....|.....|.....|.....|.....|.....|#####",
    "<": "...#.|..#..|.#...|#....|.#...|..#..|...#.",
    ">": ".#...|..#..|...#.|....#|...#.|..#..|.#...",
}

GLYPH_W, GLYPH_H = 6, 8  # 5x7 bitmap + 1px spacing


def _build_atlas():
    atlas = {}
    for ch, rows in _GLYPHS.items():
        bits = np.zeros((GLYPH_H, GLYPH_W), dtype=bool)
        for y, row in enumerate(rows.split("|")):
            for x, c in enumerate(row):
                bits[y, x] = c == "#"
        atlas[ch] = bits
    return atlas


_ATLAS = _build_atlas()


def text_mask(text: str) -> np.ndarray:
    """Render text to a bool mask [GLYPH_H, len*GLYPH_W] (top-left origin)."""
    text = text.upper()
    cols = []
    for ch in text:
        cols.append(_ATLAS.get(ch, _ATLAS["?"]))
    if not cols:
        return np.zeros((GLYPH_H, 0), dtype=bool)
    return np.concatenate(cols, axis=1)


def draw_text(fb_u32, text: str, x: int = 4, y: int = 4,
              color: int = 0x00FFFFFF, bg: int | None = 0x80000000):
    """Burn `text` into a uint32 ABGR framebuffer near the TOP-left.

    fb is bottom-left origin (core/framebuffer.py); `y` is the distance from
    the top edge, like the reference's overlay (App.hs:115-129). Returns a
    numpy array (callers present it next — PNG or ANSI — both host-side).

    Implementation note: this is PRESENTATION, so it runs on the HOST in
    numpy. The earlier eager-jnp version re-dispatched (and, because the
    text length changes the op shapes, re-COMPILED) per distinct status
    string. Pulling the frame once and blitting in numpy is microseconds.
    """
    fb = np.asarray(fb_u32).copy()
    h, w = fb.shape
    mask = text_mask(text)
    th, tw = mask.shape
    tw = min(tw, w - x)
    if tw <= 0 or th + y > h:
        return fb
    m = mask[::-1, :tw]  # flip rows to bottom-up
    row0 = h - y - th    # flip to bottom-left rows
    region = fb[row0 : row0 + th, x : x + tw]
    if bg is not None:
        # Dim the strip behind the text for readability (half intensity)
        region = (region >> 1) & np.uint32(0x7F7F7F7F)
    region = np.where(m, np.uint32(color), region)
    fb[row0 : row0 + th, x : x + tw] = region
    return fb
