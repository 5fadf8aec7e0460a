"""Minimal immediate-mode control overlay for the GL viewer.

Replaces the reference's imgui control panel (reference
visualization.py:324-332: pause/un-pause button, follow-cam checkbox,
point-size and confidence-threshold sliders) with a dependency-free overlay
drawn by the viewer's own flat-color pipeline: clickable button and slider
quads plus 5x7 bitmap-font labels, laid out in a left-edge panel. Works in
BOTH viewer backends — interactive glfw (mouse) and headless EGL (the
handlers are plain methods, so tests drive them directly and assert pixels).

Coordinates: widgets are laid out in pixels (top-left origin) and converted
to NDC at draw time, so the panel is resolution-independent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 5x7 bitmap font: per char, 7 rows of 5 bits (MSB = leftmost pixel).
_FONT = {
    "A": "0E 11 11 1F 11 11 11", "B": "1E 11 1E 11 11 11 1E",
    "C": "0E 11 10 10 10 11 0E", "D": "1E 11 11 11 11 11 1E",
    "E": "1F 10 1E 10 10 10 1F", "F": "1F 10 1E 10 10 10 10",
    "G": "0E 11 10 17 11 11 0E", "H": "11 11 1F 11 11 11 11",
    "I": "0E 04 04 04 04 04 0E", "L": "10 10 10 10 10 10 1F",
    "M": "11 1B 15 11 11 11 11", "N": "11 19 15 13 11 11 11",
    "O": "0E 11 11 11 11 11 0E", "P": "1E 11 11 1E 10 10 10",
    "R": "1E 11 11 1E 14 12 11", "S": "0F 10 10 0E 01 01 1E",
    "T": "1F 04 04 04 04 04 04", "U": "11 11 11 11 11 11 0E",
    "V": "11 11 11 11 11 0A 04", "W": "11 11 11 15 15 1B 11",
    "X": "11 11 0A 04 0A 11 11", "Y": "11 11 0A 04 04 04 04",
    "0": "0E 11 13 15 19 11 0E", "1": "04 0C 04 04 04 04 0E",
    "2": "0E 11 01 06 08 10 1F", "3": "0E 11 01 06 01 11 0E",
    "4": "02 06 0A 12 1F 02 02", "5": "1F 10 1E 01 01 11 0E",
    "6": "0E 10 1E 11 11 11 0E", "7": "1F 01 02 04 08 08 08",
    "8": "0E 11 11 0E 11 11 0E", "9": "0E 11 11 0F 01 01 0E",
    ".": "00 00 00 00 00 0C 0C", "+": "00 04 04 1F 04 04 00",
    "-": "00 00 00 1F 00 00 00", " ": "00 00 00 00 00 00 00",
    ":": "00 0C 0C 00 0C 0C 00", "[": "0E 08 08 08 08 08 0E",
    "]": "0E 02 02 02 02 02 0E",
}


def _text_quads(text, x, y, scale=2.0):
    """Lit-pixel quads for ``text`` at pixel (x, y); returns (M, 4, 2)."""
    quads = []
    cx = x
    for ch in text.upper():
        rows = _FONT.get(ch, _FONT[" "]).split()
        for ry, row in enumerate(rows):
            bits = int(row, 16)
            for rx in range(5):
                if bits & (0x10 >> rx):
                    px = cx + rx * scale
                    py = y + ry * scale
                    quads.append([[px, py], [px + scale, py],
                                  [px + scale, py + scale], [px, py + scale]])
        cx += 6 * scale
    return np.asarray(quads, np.float32).reshape(-1, 4, 2)


@dataclasses.dataclass
class Button:
    label: object                 # str or callable -> str (dynamic label)
    rect: tuple                   # (x, y, w, h) pixels
    on_click: object              # callable()

    def text(self):
        return self.label() if callable(self.label) else self.label


@dataclasses.dataclass
class Slider:
    label: str
    rect: tuple
    get: object                   # callable() -> float
    set: object                   # callable(float)
    lo: float
    hi: float

    def frac(self):
        v = (self.get() - self.lo) / (self.hi - self.lo + 1e-12)
        return float(np.clip(v, 0.0, 1.0))


class Overlay:
    """Widget panel + hit testing + triangle-list generation."""

    PANEL_BG = (0.12, 0.13, 0.18)
    BTN_BG = (0.25, 0.28, 0.38)
    SLIDER_BG = (0.20, 0.22, 0.30)
    SLIDER_FILL = (0.35, 0.55, 0.85)
    TEXT = (0.92, 0.93, 0.95)

    def __init__(self, widgets, panel_rect):
        self.widgets = list(widgets)
        self.panel_rect = panel_rect
        self._active_slider = None

    # -- input (pixel coords; return True when the event was consumed) ------

    @staticmethod
    def _inside(rect, x, y):
        rx, ry, rw, rh = rect
        return rx <= x <= rx + rw and ry <= y <= ry + rh

    def handle_press(self, x, y) -> bool:
        for wdg in self.widgets:
            if self._inside(wdg.rect, x, y):
                if isinstance(wdg, Button):
                    wdg.on_click()
                else:
                    self._active_slider = wdg
                    self._slide(wdg, x)
                return True
        return self._inside(self.panel_rect, x, y)

    def handle_drag(self, x, y) -> bool:
        if self._active_slider is not None:
            self._slide(self._active_slider, x)
            return True
        return False

    def handle_release(self):
        self._active_slider = None

    @staticmethod
    def _slide(wdg, x):
        rx, _, rw, _ = wdg.rect
        f = float(np.clip((x - rx) / max(rw, 1), 0.0, 1.0))
        wdg.set(wdg.lo + f * (wdg.hi - wdg.lo))

    # -- geometry ------------------------------------------------------------

    def triangles(self, width, height):
        """Overlay triangle list → (P (N, 3) NDC, C (N, 3)). Two triangles
        per quad; z=0 (the viewer disables depth test for the overlay)."""
        quads, colors = [], []

        def add(rect, color):
            x, y, w, h = rect
            quads.append([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
            colors.append(color)

        add(self.panel_rect, self.PANEL_BG)
        for wdg in self.widgets:
            if isinstance(wdg, Button):
                add(wdg.rect, self.BTN_BG)
            else:
                add(wdg.rect, self.SLIDER_BG)
                x, y, w, h = wdg.rect
                add((x, y, w * wdg.frac(), h), self.SLIDER_FILL)
        quads = np.asarray(quads, np.float32)
        colors = np.asarray(colors, np.float32)

        text_q, text_c = [], []
        for wdg in self.widgets:
            x, y, w, h = wdg.rect
            if isinstance(wdg, Button):
                t = wdg.text()
            else:
                t = f"{wdg.label}:{wdg.get():.2f}"
            tq = _text_quads(t, x + 6, y + (h - 14) // 2)
            if len(tq):
                text_q.append(tq)
                text_c.append(np.tile(np.asarray(self.TEXT, np.float32),
                                      (len(tq), 1)))
        if text_q:
            quads = np.concatenate([quads, *text_q]) if len(quads) else \
                np.concatenate(text_q)
            colors = np.concatenate([colors, *text_c])

        # quads (M, 4, 2) + per-quad colors (M, 3) → triangle list
        tri_idx = np.asarray([0, 1, 2, 0, 2, 3])
        P2 = quads[:, tri_idx, :].reshape(-1, 2)          # (M*6, 2) pixels
        C = np.repeat(colors, 6, axis=0)
        ndc = np.empty((len(P2), 3), np.float32)
        ndc[:, 0] = P2[:, 0] / width * 2.0 - 1.0
        ndc[:, 1] = 1.0 - P2[:, 1] / height * 2.0
        ndc[:, 2] = 0.0
        return ndc, C


def build_default_overlay(viewer):
    """The reference control panel: pause button, follow/mode toggles,
    confidence-threshold and surfel-radius sliders."""
    states = viewer.states

    def toggle_pause():
        with states.lock:
            states.paused = not states.paused

    def toggle(attr):
        def f():
            setattr(viewer, attr, not getattr(viewer, attr))
        return f

    def setter(attr):
        def f(v):
            setattr(viewer, attr, float(v))
        return f

    x, w, h, gap = 10, 180, 26, 8
    y = [10]

    def next_rect():
        r = (x, y[0], w, h)
        y[0] += h + gap
        return r

    widgets = [
        Button(lambda: ("RESUME" if states.paused else "PAUSE"),
               next_rect(), toggle_pause),
        Button(lambda: f"FOLLOW: {'ON' if viewer.follow else 'OFF'}",
               next_rect(), toggle("follow")),
        Button(lambda: ("MODE: SURFELS" if viewer.surfel_mode
                        else "MODE: POINTS"),
               next_rect(), toggle("surfel_mode")),
        Slider("CONF", next_rect(),
               lambda: viewer.conf_threshold, setter("conf_threshold"),
               0.0, 10.0),
        Slider("RADIUS", next_rect(),
               lambda: viewer.surfel_radius, setter("surfel_radius"),
               1e-4, 0.05),
    ]
    panel = (x - 6, 4, w + 12, y[0] + 2)
    return Overlay(widgets, panel)
