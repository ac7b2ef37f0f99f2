"""Interactive Tk/matplotlib FGC SEI designer GUI (reference capability:
fgc-designer.py:326-922).

Edit grain parameters graphically and preview the result live:

* per-component plot of intensity intervals: drag interval edges
  horizontally, drag the scale bar vertically, drag the cutoff-frequency
  markers; double-click splits an interval at the cursor; right-click
  toggles an interval's enable state
* sliders for log2_scale_factor, global gain, and preview frame index
* preview pane showing the grained frame (toggle original with 'o'),
  re-rendered in-process through the port's pipeline on ``--device`` on
  every edit
* preview interactions (reference Preview, fgc-designer.py:326-485):
  scroll wheel or '+'/'-' zooms in integer steps (toward the cursor),
  left-drag pans (clamped to the image), '0' resets the view,
  double-click or 'f' toggles fullscreen, 'm' cycles the display mode
  RGB -> Y -> Cb -> Cr, 'l' loads a cfg (file dialog on Tk, else the
  --save-to path)

Port of the JAX package's designer/app.py; the only new argument is
``device`` (``--device cuda|cpu``, default ``cuda``, which raises without a
card).  Needs matplotlib, and Tk for the window.

Run:  python -m versatilefilmgrain_tpu_torch.designer <input.yuv>
          [--width W --height H --depth D --format 420|422|444]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from .model import FgcSeiDesign
from .preview import read_yuv_frame, yuv_to_rgb
from ..utils import yuv as yuvio

_COMP_NAMES = ("Y", "Cb", "Cr")


class DesignerApp:
    def __init__(self, path: str, width: int, height: int, depth: int,
                 fmt: int, seed: int = 0, save_path: str = "design.cfg",
                 device=None):
        import os

        import matplotlib
        # Agg override keeps the app drivable in headless tests/CI.
        matplotlib.use(os.environ.get("VFG_MPL_BACKEND", "TkAgg"))
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        self.plt = plt
        self.path = path
        self.width, self.height = width, height
        self.depth, self.fmt = depth, fmt
        self.seed = seed
        self.device = device
        self.save_path = save_path
        self.design = FgcSeiDesign()
        self.comp = 0
        self.frame = 0
        self.show_original = False
        self._drag = None  # (kind, c, k) kind in {lower, upper, scale, freq}
        # preview view state (reference Preview, fgc-designer.py:326-485)
        self.zoom = None           # None = fit; else native px per image px
        self.view_center = None    # (x, y) image coords; None = centered
        self.fullscreen = False
        self.mode = 3              # 0=Y 1=Cb 2=Cr 3=RGB
        self._pan = None           # (press_px, press_py, center_at_press)

        # Our key bindings shadow matplotlib's stock keymap ('f' fullscreen,
        # 'l' y-log-scale, 'o' zoom, 'r' home, ...): strip the colliding
        # defaults so a keypress runs exactly one handler.
        ours = set("123owrlm+=-0fq")
        for key, val in plt.rcParams.items():
            if key.startswith("keymap."):
                for ch in [c for c in list(val) if c in ours]:
                    val.remove(ch)

        self.fig = plt.figure("vfg-tpu grain designer", figsize=(13, 7))
        gs = self.fig.add_gridspec(2, 2, width_ratios=[1.0, 1.6],
                                   height_ratios=[1.0, 0.12])
        self.ax_edit = self.fig.add_subplot(gs[0, 0])
        self.ax_img = self.fig.add_subplot(gs[0, 1])
        self.ax_img.set_axis_off()

        sl = self.fig.add_subplot(gs[1, 0])
        sl.set_axis_off()
        self.s_scale = Slider(self.fig.add_axes([0.08, 0.06, 0.22, 0.03]),
                              "log2_scale", 2, 7,
                              valinit=self.design.log2_scale_factor,
                              valstep=1)
        self.s_gain = Slider(self.fig.add_axes([0.08, 0.02, 0.22, 0.03]),
                             "gain %", 0, 200, valinit=100, valstep=5)
        self.s_frame = Slider(self.fig.add_axes([0.55, 0.04, 0.3, 0.03]),
                              "frame", 0, max(0, self._count_frames() - 1),
                              valinit=0, valstep=1)
        self.s_scale.on_changed(self._on_scale)
        self.s_gain.on_changed(self._on_gain)
        self.s_frame.on_changed(self._on_frame)

        self.fig.canvas.mpl_connect("button_press_event", self._on_press)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_motion)
        self.fig.canvas.mpl_connect("button_release_event", self._on_release)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.fig.canvas.mpl_connect("scroll_event", self._on_scroll)

        self._load_frame()
        self.redraw(regrain=True)

    # -- data -----------------------------------------------------------

    def _count_frames(self) -> int:
        import os
        fb = yuvio.frame_bytes(self.width, self.height, self.depth, self.fmt)
        try:
            return max(1, os.path.getsize(self.path) // fb)
        except OSError:
            return 1

    def _load_frame(self):
        self.planes = read_yuv_frame(self.path, self.frame, self.width,
                                     self.height, self.depth, self.fmt)

    def regrain(self):
        out = self.design.apply_to_frame(
            self.planes, self.width, self.height, self.depth, self.fmt,
            seed=self.seed, frame_index=self.frame, device=self.device)
        self.grained = out

    # -- drawing --------------------------------------------------------

    def redraw(self, regrain: bool = False):
        if regrain:
            self.regrain()
        d, c = self.design, self.comp
        ax = self.ax_edit
        ax.clear()
        ax.set_xlim(0, 255)
        ax.set_ylim(0, 260)
        ax.set_xlabel("intensity")
        ax.set_ylabel("scale")
        ax.set_title(f"component {_COMP_NAMES[c]}  "
                     f"(1/2/3 comp, o orig, m mode, +/-/0 zoom, f full, "
                     f"w write, l load, r reset, q quit)")
        for k in range(d.num_intervals(c)):
            lo, hi = d.lower[c][k], d.upper[c][k]
            sc = d.values[c][k][0]
            color = "tab:green" if d.enable[c][k] else "tab:red"
            ax.fill_between([lo, hi + 1], 0, sc, alpha=0.3, color=color)
            ax.plot([lo, hi + 1], [sc, sc], color=color, lw=2)
            if d.model_id == 0 and len(d.values[c][k]) > 2:
                fh, fv = d.values[c][k][1], d.values[c][k][2]
                ax.plot([(lo + hi) / 2], [fh * 16], "b^", ms=6)
                ax.plot([(lo + hi) / 2], [fv * 16], "cv", ms=6)
        img = self.planes if self.show_original else self.grained
        self.ax_img.clear()
        self.ax_img.set_axis_off()
        if self.mode < 3:                        # single plane, gray
            p = img[self.mode]
            self.ax_img.imshow(p, cmap="gray", interpolation="nearest",
                               vmin=0, vmax=(1 << self.depth) - 1)
            self._imsize = (p.shape[1], p.shape[0])
        else:                                    # RGB composite
            rgb = yuv_to_rgb(*img, self.depth, self.fmt)
            self.ax_img.imshow(rgb, interpolation="nearest")
            self._imsize = (rgb.shape[1], rgb.shape[0])
        self._apply_view()
        self.fig.canvas.draw_idle()

    # -- preview view: zoom / pan / fullscreen / mode ---------------------
    # Capability parity with the reference's Preview window
    # (fgc-designer.py:326-485): zoom is anchored at NATIVE display pixels
    # -- zoom 1 shows one image pixel per display pixel, integer steps
    # above 1 and harmonic steps (1/2, 1/3, 1/4) below, exactly the
    # reference's on_scroll ladder (fgc-designer.py:409-425).  One
    # extension: the initial view (zoom None, key '0') fits the whole image
    # in the pane so a 4K frame is not a blind crop on open.

    def _view_px(self):
        """Preview pane size in display pixels."""
        bb = self.ax_img.get_window_extent()
        return max(bb.width, 1.0), max(bb.height, 1.0)

    def _apply_view(self):
        w, h = self._imsize
        if self.zoom is None:                    # fit the whole image
            ww, wh = w, h
        else:                                    # native-pixel anchored
            bw, bh = self._view_px()
            ww, wh = bw / self.zoom, bh / self.zoom
        cx, cy = self.view_center or (w / 2 - 0.5, h / 2 - 0.5)
        # clamp the view window to the image
        cx = min(max(cx, ww / 2 - 0.5), w - ww / 2 - 0.5)
        cy = min(max(cy, wh / 2 - 0.5), h - wh / 2 - 0.5)
        self.view_center = (cx, cy)
        self.ax_img.set_xlim(cx - ww / 2, cx + ww / 2)
        self.ax_img.set_ylim(cy + wh / 2, cy - wh / 2)   # image y-down
        title = "original" if self.show_original else "grained"
        title += f"  [{('Y', 'Cb', 'Cr', 'RGB')[self.mode]}"
        if self.zoom is not None:
            title += f", zoom {round(self.zoom * 100)} %"
        self.ax_img.set_title(title + "]")

    def _set_zoom(self, zoom: float | None, at=None):
        if zoom is not None:
            zoom = min(max(zoom, 0.25), 4.0)     # reference clip (1/4 .. 4)
        if zoom == self.zoom:
            return
        if at is not None and zoom is not None:
            self.view_center = at                # zoom toward the cursor
        self.zoom = zoom
        self._apply_view()
        self.fig.canvas.draw_idle()

    def _zoom_step(self, up: bool):
        """The reference's zoom ladder: ... 1/3, 1/2, 1, 2, 3, 4."""
        z = self.zoom
        if z is None:
            return 1.0 if up else None           # leave 'fit' at native 1:1
        if up:
            return z + 1 if z >= 1.0 else 1.0 / (1.0 / z - 1.0)
        return z - 1 if z > 1.0 else 1.0 / (1.0 / z + 1.0)

    def _on_scroll(self, ev):
        if ev.inaxes is not self.ax_img:
            return
        at = (ev.xdata, ev.ydata) if ev.xdata is not None else None
        z = self._zoom_step(ev.step > 0)
        if z is not None:
            self._set_zoom(z, at=at)

    def _toggle_fullscreen(self):
        self.fullscreen = not self.fullscreen
        try:
            self.fig.canvas.manager.full_screen_toggle()
        except Exception:
            pass                                 # headless: state tracked

    def _load_cfg_interactive(self):
        import os

        import matplotlib
        path = self.save_path
        if matplotlib.get_backend().lower().startswith("tk"):
            try:
                from tkinter import filedialog
                sel = filedialog.askopenfilename(
                    title="Load FGC SEI cfg",
                    filetypes=[("cfg files", "*.cfg"), ("all files", "*")])
                if sel:
                    path = sel
            except Exception:
                pass
        if os.path.exists(path):
            try:
                self.design.load(path)
            except Exception as e:   # malformed / AFGS1 cfg: report, keep UI
                print(f"[designer] load failed: {e}")
                return
            # Sync the sliders to the loaded design so the next slider touch
            # does not write a stale value back over it; suppress the slider
            # callback so the preview regrains once, not twice.
            self.s_scale.eventson = False
            try:
                self.s_scale.set_val(self.design.log2_scale_factor)
            finally:
                self.s_scale.eventson = True
            self.redraw(regrain=True)
            print(f"[designer] loaded {path}")
        else:
            print(f"[designer] no cfg at {path}")

    # -- interaction ----------------------------------------------------

    def _find_interval(self, x: float):
        d, c = self.design, self.comp
        for k in range(d.num_intervals(c)):
            if d.lower[c][k] <= x <= d.upper[c][k] + 1:
                return k
        return None

    def _on_press(self, ev):
        if ev.inaxes is self.ax_img:
            if ev.dblclick:                      # double-click: fullscreen
                self._toggle_fullscreen()
            elif ev.button == 1:                 # left-drag: pan
                self._pan = (ev.x, ev.y, self.view_center)
            return
        if ev.inaxes is not self.ax_edit or ev.xdata is None:
            return
        d, c = self.design, self.comp
        x, y = ev.xdata, ev.ydata
        k = self._find_interval(x)
        if k is None:
            return
        if ev.button == 3:                       # right-click: toggle
            d.toggle(c, k)
            self.redraw(regrain=True)
            return
        if ev.dblclick:                          # double-click: split
            if d.split(c, k, int(round(x))):
                self.redraw(regrain=True)
            return
        lo, hi, sc = d.lower[c][k], d.upper[c][k], d.values[c][k][0]
        if abs(x - lo) < 4:
            self._drag = ("lower", c, k)
        elif abs(x - (hi + 1)) < 4:
            self._drag = ("upper", c, k)
        elif d.model_id == 0 and abs(y - d.values[c][k][1] * 16) < 10:
            self._drag = ("freq_h", c, k)
        elif d.model_id == 0 and abs(y - d.values[c][k][2] * 16) < 10:
            self._drag = ("freq_v", c, k)
        else:
            self._drag = ("scale", c, k)

    def _on_motion(self, ev):
        if self._pan is not None:
            if ev.x is None or ev.y is None:
                return
            px, py, (cx, cy) = self._pan
            bw, bh = self._view_px()
            w, h = self._imsize
            if self.zoom is None:                # fit: image px per pane px
                sx, sy = w / bw, h / bh
            else:                                # native: 1/zoom px per px
                sx = sy = 1.0 / self.zoom
            # display y is up, image y is down: both deltas flip sign once
            self.view_center = (cx - (ev.x - px) * sx,
                                cy + (ev.y - py) * sy)
            self._apply_view()
            self.fig.canvas.draw_idle()
            return
        if self._drag is None or ev.inaxes is not self.ax_edit:
            return
        kind, c, k = self._drag
        d = self.design
        x = int(round(ev.xdata)) if ev.xdata is not None else 0
        y = int(round(ev.ydata)) if ev.ydata is not None else 0
        if kind == "lower":
            d.lower[c][k] = max(0, min(x, d.upper[c][k]))
        elif kind == "upper":
            d.upper[c][k] = min(255, max(x - 1, d.lower[c][k]))
        elif kind == "scale":
            d.values[c][k][0] = max(0, min(255, y))
        elif kind == "freq_h":
            d.values[c][k][1] = max(2, min(14, y // 16))
        elif kind == "freq_v":
            d.values[c][k][2] = max(2, min(14, y // 16))
        self.redraw(regrain=False)

    def _on_release(self, ev):
        if self._pan is not None:
            self._pan = None
            return
        if self._drag is None:
            return
        kind, c, k = self._drag
        d = self.design
        self._drag = None
        if kind in ("lower", "upper") and d.lower[c][k] > d.upper[c][k]:
            d.remove(c, k)                       # zero-length: remove
        self.redraw(regrain=True)

    def _on_key(self, ev):
        if ev.key in ("1", "2", "3"):
            self.comp = int(ev.key) - 1
            self.redraw()
        elif ev.key == "o":
            self.show_original = not self.show_original
            self.redraw()
        elif ev.key == "w":          # write the current design
            self.design.save(self.save_path)
            print(f"[designer] saved {self.save_path}")
        elif ev.key == "r":          # reset to the default design
            self.design.reset()
            self.redraw(regrain=True)
        elif ev.key == "l":          # load a cfg (dialog on Tk)
            self._load_cfg_interactive()
        elif ev.key == "m":          # cycle display mode RGB->Y->Cb->Cr
            self.mode = (self.mode + 1) % 4
            self.redraw()
        elif ev.key in ("+", "="):
            z = self._zoom_step(True)
            if z is not None:
                self._set_zoom(z)
        elif ev.key == "-":
            z = self._zoom_step(False)
            if z is not None:
                self._set_zoom(z)
        elif ev.key == "0":          # reset view (fit)
            self.zoom, self.view_center = None, None
            self._apply_view()
            self.fig.canvas.draw_idle()
        elif ev.key == "f":
            self._toggle_fullscreen()
        elif ev.key == "q":
            self.plt.close(self.fig)

    def _on_scale(self, val):
        self.design.log2_scale_factor = int(val)
        self.redraw(regrain=True)

    def _on_gain(self, val):
        self.design.gain = int(val)
        self.redraw(regrain=True)

    def _on_frame(self, val):
        self.frame = int(val)
        self._load_frame()
        self.redraw(regrain=True)

    def show(self):
        self.plt.show()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vfgs-torch-designer",
        description="Interactive FGC SEI film grain designer")
    ap.add_argument("input", help="clean input YUV file")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=10, choices=(8, 10))
    ap.add_argument("--format", default="420", choices=("420", "422", "444"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="Device: cuda (raises without a card) or cpu "
                         "(plain torch engines)")
    ap.add_argument("--cfg", help="initial cfg file to load")
    ap.add_argument("--save-to", default="design.cfg",
                    help="cfg path written by the 'w' key")
    args = ap.parse_args(argv)

    fmt = {"420": yuvio.YUV_420, "422": yuvio.YUV_422,
           "444": yuvio.YUV_444}[args.format]
    app = DesignerApp(args.input, args.width, args.height, args.depth, fmt,
                      seed=args.seed, save_path=args.save_to,
                      device=args.device)
    if args.cfg:
        app.design.load(args.cfg)
        app.redraw(regrain=True)
    app.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
