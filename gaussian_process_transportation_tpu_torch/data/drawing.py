"""2-D drawing recorder: the original project's mouse-drawing interface.

The port's own copy of ``gaussian_process_transportation_tpu/data/drawing.py``
(numpy and matplotlib only).  Matplotlib's key and motion events drive the
capture, so it works in any windowed matplotlib backend.

Keys: hold ``z`` to draw, ``d`` saves the current segment as the demo,
``w`` as the source surface, ``n`` as the target surface.  ``save(path)``
writes the npz the 2-D examples read (demo / floor / newfloor).

Headless use: :meth:`feed` appends points from code, so the class also
builds the npz of scripted datasets.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class DrawingRecorder:
    def __init__(self, fig=None, ax=None, interactive: bool = True, limits=(-50, 49)):
        self.x: list = []
        self.y: list = []
        self.idx = 0
        self.keep_drawing = False
        self.demo: Optional[np.ndarray] = None
        self.floor: Optional[np.ndarray] = None
        self.newfloor: Optional[np.ndarray] = None
        self.fig = self.ax = None
        if interactive:
            import matplotlib.pyplot as plt

            if fig is None or ax is None:
                fig, ax = plt.subplots()
            self.fig, self.ax = fig, ax
            ax.set_xlim(*limits)
            ax.set_ylim(*limits)
            (self.points,) = ax.plot([], [], "o", markersize=2)
            fig.canvas.mpl_connect("key_press_event", self._on_key)
            fig.canvas.mpl_connect("key_release_event", self._on_key_release)
            fig.canvas.mpl_connect("motion_notify_event", self._on_move)

    # ---- event handlers ---------------------------------------------------
    def _on_key(self, event):
        if event.key == "z":
            self.keep_drawing = True
        elif event.key == "d":
            self.demo = self._take_segment()
        elif event.key == "w":
            self.floor = self._take_segment()
        elif event.key == "n":
            self.newfloor = self._take_segment()

    def _on_key_release(self, event):
        if event.key == "z":
            self.keep_drawing = False

    def _on_move(self, event):
        if self.keep_drawing and event.xdata is not None:
            self.x.append(event.xdata)
            self.y.append(event.ydata)
            if self.ax is not None:
                self.points.set_data(self.x, self.y)
                self.fig.canvas.draw_idle()

    # ---- programmatic use -------------------------------------------------
    def feed(self, points: np.ndarray):
        pts = np.asarray(points)
        self.x.extend(pts[:, 0].tolist())
        self.y.extend(pts[:, 1].tolist())

    def _take_segment(self) -> np.ndarray:
        seg = np.array([self.x[self.idx :], self.y[self.idx :]]).T
        self.idx = len(self.x)
        self.keep_drawing = False
        return seg

    def mark_demo(self):
        self.demo = self._take_segment()

    def mark_floor(self):
        self.floor = self._take_segment()

    def mark_newfloor(self):
        self.newfloor = self._take_segment()

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        np.savez(path, demo=self.demo, floor=self.floor, newfloor=self.newfloor)
