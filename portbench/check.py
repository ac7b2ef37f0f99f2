"""Whether the timed path's outputs are right: the frames kept from the
window against the frozen plain reference (``reference/``), exactly.

The configuration's guarantees are that every output is byte-identical to
the reference model and that exactly one frame comes out for each frame
in, in order.  So each kept frame ``n`` is compared with the reference's
grain of the same seeded input at frame ``n`` of the stream, sample for
sample, and frames offered that never came out count as missing.  The
reference works out its own register file, patterns, LUTs and per-frame
lattice bases, and regenerates the inputs from the seed; it takes nothing
the program made; it pops the configuration's cfg schedule at the POCs
the program is given.  It runs after the window, once the driver has read
the memory peak and freed the program's state, one frame at a time.

Numbers compared, each with its limit:

* ``mismatched_samples``: samples of the kept frames that differ from the
  reference, at most 0;
* ``frames_missing``: frames offered that never came out, at most 0;
* ``frames_checked``: frames compared, at least the driver's target (every
  position of a batch and the last frame; with the pipe driver also the
  frame at each kept switch's POC and the frame before it).

The verdict also lists the kept frames that differ (``wrong_frames``).
"""

from __future__ import annotations

import numpy as np

from portbench import frames


def verify(cell, record: dict, seed: int, device: str) -> dict:
    import torch

    from portbench.reference.model import Reference
    c = cell.config
    W, H, D, fmt = c["width"], c["height"], c["depth"], c["chroma_format"]
    ref = Reference(W, H, D, fmt, cell.schedule())
    dev = torch.device(device)
    cw, ch = frames.chroma_dims(W, H, fmt)
    crop = ((H, W), (ch, cw), (ch, cw))
    mismatched = checked = 0
    wrong = []
    for n, pool_index, planes in record["samples"]:
        inp = frames.padded_frame(W, H, D, fmt, seed, pool_index)
        want = ref.grain(*(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                           for p in inp), n)
        if record["crop"]:
            want = [w[:h, :x] for w, (h, x) in zip(want, crop)]
        diff = 0
        for got, w in zip(planes, want):
            if isinstance(got, np.ndarray):
                got = torch.from_numpy(np.array(got))
            got = got.to(dev)
            if tuple(got.shape) != tuple(w.shape):
                diff += w.numel()
            else:
                diff += int((got.to(torch.int32) != w.to(torch.int32)).sum())
        mismatched += diff
        if diff:
            wrong.append(n)
        checked += 1
    checks = {
        "mismatched_samples": dict(value=mismatched, rule="<=", limit=0),
        "frames_missing": dict(value=int(record["missing"]), rule="<=",
                               limit=0),
        "frames_checked": dict(value=checked, rule=">=",
                               limit=int(record["check_target"])),
    }
    correct = all(v["value"] <= v["limit"] if v["rule"] == "<="
                  else v["value"] >= v["limit"] for v in checks.values())
    return dict(correct=correct, checks=checks, wrong_frames=wrong,
                failed=int(record["missing"]) + len(wrong))
