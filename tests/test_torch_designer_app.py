"""The torch port's designer GUI (versatilefilmgrain_tpu_torch/designer/
app.py) driven headless on the Agg backend, as tests/test_designer_app.py
drives the JAX one: presses, drags, splits, toggles and slider changes must
mutate the design and re-render without a display server, regrained on the
CPU (``device="cpu"``).  After the same drag, the port's app's grained
frame equals the JAX app's, byte for byte; with the default device and no
card, the app raises and names the CPU."""

import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("matplotlib")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


def _input(tmp_path_factory, frames=2):
    from gen_input import make_input_yuv
    path = str(tmp_path_factory.mktemp("yuv") / "in.yuv")
    make_input_yuv(path, 256, 192, 10, 0, frames)
    return path


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    os.environ["VFG_MPL_BACKEND"] = "Agg"
    from versatilefilmgrain_tpu_torch.designer.app import DesignerApp
    return DesignerApp(_input(tmp_path_factory), 256, 192, 10, 0,
                       device="cpu")


def _ev(ax, x, y, button=1, dblclick=False, px=0.0, py=0.0, step=0):
    return types.SimpleNamespace(inaxes=ax, xdata=x, ydata=y, button=button,
                                 dblclick=dblclick, key=None, x=px, y=py,
                                 step=step)


def test_initial_render(app):
    assert app.grained[0].shape == (192, 256)
    assert not np.array_equal(app.grained[0], app.planes[0])


def test_drag_scale(app):
    before = app.design.values[0][0][0]
    app._on_press(_ev(app.ax_edit, 20, 200))      # inside interval 0
    assert app._drag is not None and app._drag[0] == "scale"
    app._on_motion(_ev(app.ax_edit, 20, 222))
    app._on_release(_ev(app.ax_edit, 20, 222))
    assert app.design.values[0][0][0] == 222 != before


def test_double_click_split(app):
    n0 = app.design.num_intervals(0)
    app._on_press(_ev(app.ax_edit, 20, 100, dblclick=True))
    assert app.design.num_intervals(0) == n0 + 1


def test_right_click_toggle(app):
    app._on_press(_ev(app.ax_edit, 20, 100, button=3))
    assert app.design.enable[0][0] is False
    app._on_press(_ev(app.ax_edit, 20, 100, button=3))
    assert app.design.enable[0][0] is True


def test_key_switch_component(app):
    app._on_key(types.SimpleNamespace(key="2"))
    assert app.comp == 1
    app._on_key(types.SimpleNamespace(key="o"))
    assert app.show_original
    app._on_key(types.SimpleNamespace(key="o"))
    app._on_key(types.SimpleNamespace(key="1"))


def test_drag_upper_bound_at_255(app):
    """The last interval's upper edge (255) must be grabbable (uint8
    overflow regression: np.uint8(255)+1 wrapped to 0)."""
    c = app.comp = 0
    k = app.design.num_intervals(c) - 1
    assert app.design.upper[c][k] == 255
    app._on_press(_ev(app.ax_edit, 255.5, 50))
    assert app._drag == ("upper", c, k)
    app._on_release(_ev(app.ax_edit, 255.5, 50))


def test_slider_gain(app):
    app._on_gain(60)
    assert app.design.gain == 60
    # regrain happened with the new gain
    assert app.grained[0].shape == (192, 256)


def test_scroll_zoom_and_reset(app):
    """Scroll on the preview zooms toward the cursor at native display
    pixels (reference ladder: ... 1/3, 1/2, 1, 2, 3, 4); '0' resets to
    fit."""
    assert app.zoom is None                      # initial view fits
    x0, x1 = app.ax_img.get_xlim()
    assert abs((x1 - x0) - 256) < 1e-6
    app._on_scroll(_ev(app.ax_img, 40.0, 30.0, step=1))
    assert app.zoom == 1.0                       # fit -> native 1:1
    bw, _ = app._view_px()
    x0, x1 = app.ax_img.get_xlim()
    assert abs((x1 - x0) - bw) < 1e-6            # one image px per pane px
    app._on_scroll(_ev(app.ax_img, 40.0, 30.0, step=1))
    assert app.zoom == 2.0
    x0, x1 = app.ax_img.get_xlim()
    assert abs((x1 - x0) - bw / 2) < 1e-6
    app._on_scroll(_ev(app.ax_img, 40.0, 30.0, step=-1))
    app._on_scroll(_ev(app.ax_img, 40.0, 30.0, step=-1))
    assert app.zoom == 0.5                       # harmonic below 1
    app._on_scroll(_ev(app.ax_img, 40.0, 30.0, step=-1))
    assert abs(app.zoom - 1 / 3) < 1e-9
    app._on_key(types.SimpleNamespace(key="+"))
    app._on_key(types.SimpleNamespace(key="+"))
    assert app.zoom == 1.0
    app._on_key(types.SimpleNamespace(key="0"))
    assert app.zoom is None
    x0, x1 = app.ax_img.get_xlim()
    assert abs((x1 - x0) - 256) < 1e-6


def test_pan_clamped(app):
    """Left-drag on the preview pans; the view never leaves the image."""
    for _ in range(4):                           # zoom to 4 (view < image)
        app._on_key(types.SimpleNamespace(key="+"))
    assert app.zoom == 4.0
    assert app._view_px()[0] / 4 < 256           # window fits inside
    c0 = app.view_center
    app._on_press(_ev(app.ax_img, 10.0, 10.0, px=100.0, py=100.0))
    assert app._pan is not None
    app._on_motion(_ev(app.ax_img, None, None, px=90.0, py=100.0))
    assert app.view_center[0] > c0[0]            # dragged left -> view right
    app._on_release(_ev(app.ax_img, 0, 0))
    assert app._pan is None
    # pan far beyond the edge: clamped to the last valid window
    app._on_press(_ev(app.ax_img, 10.0, 10.0, px=0.0, py=0.0))
    app._on_motion(_ev(app.ax_img, None, None, px=-1e6, py=1e6))
    app._on_release(_ev(app.ax_img, 0, 0))
    x0, x1 = app.ax_img.get_xlim()
    assert x0 >= -0.5 - 1e-6 and x1 <= 255.5 + 1e-6
    app._on_key(types.SimpleNamespace(key="0"))


def test_fullscreen_toggle(app):
    app._on_press(_ev(app.ax_img, 5.0, 5.0, dblclick=True))
    assert app.fullscreen
    app._on_key(types.SimpleNamespace(key="f"))
    assert not app.fullscreen


def test_mode_cycle(app):
    """'m' cycles RGB -> Y -> Cb -> Cr; plane modes track plane size."""
    assert app.mode == 3 and app._imsize == (256, 192)
    app._on_key(types.SimpleNamespace(key="m"))
    assert app.mode == 0 and app._imsize == (256, 192)       # Y
    app._on_key(types.SimpleNamespace(key="m"))
    assert app.mode == 1 and app._imsize == (128, 96)        # Cb (4:2:0)
    app._on_key(types.SimpleNamespace(key="m"))
    assert app.mode == 2
    app._on_key(types.SimpleNamespace(key="m"))
    assert app.mode == 3


def test_load_key_roundtrip(app, tmp_path):
    """'w' then 'l' round-trips the design through the cfg file."""
    app.save_path = str(tmp_path / "design.cfg")
    app.design.values[0][0][0] = 77
    app._on_key(types.SimpleNamespace(key="w"))
    app.design.values[0][0][0] = 11
    app._on_key(types.SimpleNamespace(key="l"))
    assert app.design.values[0][0][0] == 77


def _drag_scale(a, y):
    a._on_press(_ev(a.ax_edit, 20, 200))
    a._on_motion(_ev(a.ax_edit, 20, y))
    a._on_release(_ev(a.ax_edit, 20, y))


def test_grained_equals_jax_app(tmp_path_factory):
    """Both apps on the same file, the same drag (luma interval 0's scale
    to 222) and the same frame: the port's grained frame equals the JAX
    app's, byte for byte."""
    import matplotlib.pyplot as plt
    os.environ["VFG_MPL_BACKEND"] = "Agg"
    from versatilefilmgrain_tpu.designer.app import DesignerApp as JaxApp
    from versatilefilmgrain_tpu_torch.designer.app import DesignerApp

    path = _input(tmp_path_factory, frames=3)
    apps = [JaxApp(path, 256, 192, 10, 0, seed=5),
            DesignerApp(path, 256, 192, 10, 0, seed=5, device="cpu")]
    try:
        for a in apps:
            _drag_scale(a, 222)
            a._on_frame(2)
            assert a.design.values[0][0][0] == 222
        for c, (want, got) in enumerate(zip(*(a.grained for a in apps))):
            assert got.dtype == want.dtype and np.array_equal(got, want), c
        assert not np.array_equal(apps[1].grained[0], apps[1].planes[0])
    finally:
        for a in apps:
            plt.close(a.fig)


def test_default_device_needs_a_card(tmp_path_factory, monkeypatch):
    """``vfgs-torch-designer`` with the default ``--device cuda`` raises
    without a card, naming the CPU; it never carries on there."""
    import matplotlib.pyplot as plt
    import torch
    os.environ["VFG_MPL_BACKEND"] = "Agg"
    from versatilefilmgrain_tpu_torch.designer.app import DesignerApp, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _input(tmp_path_factory, frames=1)
    try:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            main([path, "--width", "256", "--height", "192"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            DesignerApp(path, 256, 192, 10, 0)
    finally:
        plt.close("all")
