"""What the metric readers (``metrics/<name>.py``) share.  Each returns
None where the run's record holds nothing to read: a device metric with
no device operation in the trace (a run on the CPU) reads nothing."""

from __future__ import annotations

import numpy as np

from portbench import roofline


def window_rate(rec: dict):
    """Frames done inside the window per second of it (host clock)."""
    done = rec.get("done")
    if done is None:
        return None
    return sum(1 for t in done if t <= rec["seconds"]) / rec["seconds"]


def span_ms(rec: dict, name: str):
    """Mean milliseconds of the harness's span ``name`` in the window."""
    spans = (rec.get("spans") or {}).get(name)
    return 1e3 * float(np.mean(spans)) if spans else None


def runfile_ms(rec: dict, key: str):
    """``run_file``'s own timer ``key`` in milliseconds per frame."""
    rf = rec.get("runfile")
    if not rf or not rf["frames"]:
        return None
    return 1e3 * rf[key] / rf["frames"]


def _device_trace(rec: dict):
    """The record's trace, where the device ran something in it."""
    tr = rec.get("trace")
    return tr if tr and tr["busy_s"] > 0 else None


def idle_pct(rec: dict):
    """Share of the traced window in which no operation ran on the
    device."""
    tr = _device_trace(rec)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def copy_ms(rec: dict):
    """Device milliseconds of copies per frame in the traced window."""
    tr = _device_trace(rec)
    if tr is None or not rec.get("frames"):
        return None
    return 1e3 * tr["copy_s"] / rec["frames"]


GRAIN_KERNEL = "grain_plane"    # K1, csrc/grain_natural.cu


def prep_launches(rec: dict):
    """Device kernels per step other than the grain kernel's launches."""
    tr = _device_trace(rec)
    if tr is None or not rec.get("steps"):
        return None
    n = sum(c for name, (c, _) in tr["ops"].items()
            if GRAIN_KERNEL not in name and not name.startswith("Mem"))
    return n / rec["steps"]


def step_roofline(rec: dict):
    """The step's least time at the peak bandwidth over its device time:
    the time in the traced window in which a kernel ran, per step.  Copies
    (the bases' upload, the harness's sample copies) are left out."""
    tr = _device_trace(rec)
    if tr is None or not rec.get("steps") or not tr.get("kernel_busy_s"):
        return None
    bound = roofline.step_bound_s(*rec["geometry"], rec["batch"])
    return 100.0 * bound / (tr["kernel_busy_s"] / rec["steps"])
