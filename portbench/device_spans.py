"""What the readers of the device-resident loop (``run_device``, the
``device`` driver) share: the device ends' share of the loop's thread from
the program's spans, and K1's share of its byte roofline from the device
trace.  Each returns None where the record holds nothing to read: a
program from before ``run_device`` (no ``device_frames`` counter), another
run's record, or a trace with no K1 in it."""

from __future__ import annotations

from portbench import roofline
from portbench.program_spans import per_frame_ms
from portbench.readers import GRAIN_KERNEL

# The loop's spans around the ends' calls and the copies to and from them.
ENDS = ("read", "stage", "upload", "download", "wait", "put")


def ends_ms(rec: dict):
    """Milliseconds a frame of the loop's spans in ``ENDS``, where every
    frame came in on the device (the record's ``device_frames``, the
    program's counter of the traced window)."""
    if not rec.get("frames") or rec.get("device_frames") != rec["frames"]:
        return None
    parts = [per_frame_ms(rec, name) for name in ENDS]
    return None if None in parts else sum(parts)


def k1_roofline(rec: dict):
    """The least bytes of the window's steps (``roofline.step_bytes``:
    each padded plane read and written once, the tables once a step) at
    the card's peak bandwidth, over K1's device time (the trace's
    ``grain_plane`` kernels; copies and the lattice prep left out), in
    percent."""
    tr = rec.get("trace")
    steps, n = rec.get("steps"), rec.get("frames")
    if not tr or not steps or not n:
        return None
    k1_s = sum(s for name, (_, s) in tr["ops"].items()
               if GRAIN_KERNEL in name)
    if k1_s <= 0:
        return None
    least = (roofline.step_bytes(*rec["geometry"], n)
             + (steps - 1) * roofline.TABLE_BYTES)
    return 100.0 * least / roofline.HBM_BYTES_S / k1_s
