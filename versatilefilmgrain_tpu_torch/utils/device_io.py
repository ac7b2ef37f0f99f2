"""Frame ends on the device, for :meth:`GrainPipeline.run_device`: frames
that a decoder wrote into device memory go in, grained frames go out to an
encoder or a display on the same device, and no frame byte crosses the
host.

A frame here is a 1-D uint8 tensor on the pipeline's device that holds one
frame as the CLI's files lay it out: planar Y, then U, then V, with 16-bit
little-endian samples above 8 bits (``yuv420p10le`` at 10 bits 4:2:0).

The frame loop takes any source and sink with these calls, the protocol
that ``run_file``'s file ends (``native_io.FrameReader`` and
``FrameWriter``) keep too, so a decoder's or an encoder's adapter can
implement them in place of the two ends below:

* ``src.next()``: the next frame, or None at the end of the stream; the
  frame stays the loop's until ``src.release(n)`` gives back the ``n``
  oldest frames lent, which the loop does once their copies on the device
  are done;
* ``dst.acquire()``: a frame to fill; ``dst.put(frame)`` hands a filled
  frame on, once the copy into it is done on the device, in the order the
  frames were acquired; ``dst.give_back(frames)`` returns those of
  ``frames`` that no put took.

The loop holds at most two batches of each end's frames at once.
"""

from __future__ import annotations

import collections

import torch

from . import tracing


class DeviceSource:
    """Lends the frames of the caller's iterable ``frames`` (device frames,
    as above) in order, each inside the span ``lend``.  The frames stay
    the caller's: :meth:`release` only counts those given back
    (``released``), after which the caller may write them again."""

    def __init__(self, frames):
        self._frames = iter(frames)
        self.lent = self.released = 0

    def next(self):
        with tracing.span("lend"):
            frame = next(self._frames, None)
        if frame is not None:
            self.lent += 1
        return frame

    def release(self, n: int) -> None:
        if not 0 <= n <= self.lent - self.released:
            raise ValueError(f"{n} frames to give back, "
                             f"{self.lent - self.released} held")
        self.released += n


class DeviceSink:
    """A ring of ``nbuf`` device frames of ``frame_bytes`` on ``device``
    (3 x the batch holds what the loop needs), lent in turn by
    :meth:`acquire`.  :meth:`put` passes the frame to ``hand(frame)``
    inside the span ``hand`` and takes it back into the ring when ``hand``
    returns, so ``hand`` copies out what it keeps or has its consumer read
    it before it returns."""

    def __init__(self, frame_bytes: int, nbuf: int, device, hand):
        self.frame_bytes, self.hand = frame_bytes, hand
        self._ring = torch.empty((nbuf, frame_bytes), dtype=torch.uint8,
                                 device=device)
        self._frames = list(self._ring)
        self._slot = {f.data_ptr(): i for i, f in enumerate(self._frames)}
        self._free = collections.deque(range(nbuf))
        self._held: set[int] = set()

    def acquire(self) -> torch.Tensor:
        if not self._free:
            raise RuntimeError(f"all {len(self._frames)} ring frames are "
                               "held: put or give back some first")
        i = self._free.popleft()
        self._held.add(i)
        return self._frames[i]

    def _held_slot(self, frame) -> int | None:
        """The held slot that ``frame`` is, or None."""
        i = self._slot.get(frame.data_ptr()) \
            if isinstance(frame, torch.Tensor) else None
        return i if i in self._held else None

    def _free_slot(self, i: int) -> None:
        self._held.remove(i)
        self._free.append(i)

    def put(self, frame: torch.Tensor) -> None:
        i = self._held_slot(frame)
        if i is None:
            raise ValueError("put takes a frame that acquire() lent and "
                             "that was not put")
        with tracing.span("hand"):
            self.hand(frame)
        self._free_slot(i)

    def give_back(self, frames) -> None:
        for frame in frames:
            i = self._held_slot(frame)
            if i is not None:
                self._free_slot(i)
