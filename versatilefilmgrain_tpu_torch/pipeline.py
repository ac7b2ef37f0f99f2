"""Outer layer: validation, chroma-format adjustment, gain, POC-scheduled
multi-config switching, and the frame loop (reference: src/vfgs_main.c).

One frame loop, ``GrainPipeline._loop``, serves ``run`` (open files),
``run_file`` (file paths, batches) and ``run_device`` (frames on the
device, batches); ``process_frame`` grains an in-memory frame with the
loop's staging and its padding carry at pad-leak widths.

The per-frame LFSR bases are derived in closed form from (frame - epoch) where
``epoch`` is the frame index of the last reseed (AFGS1 inits reseed,
vfgs_fw.c:672; SEI inits do not, so grain state carries across SEI config
switches exactly like the C statics, vfgs_main.c:771-781).
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from .models import config as cfgmod
from .models import fw
from .models.hw import HwRegs
from .ops import lfsr
from .ops.grain_natural import (add_grain_batch_natural,
                                add_grain_batch_plain, natural_tables)
from .ops.grain_pallas import add_grain_batch_pallas, pallas_tables
from .utils import native_io, parsers, tracing, yuv
from .utils.parsers import ConfigError, _check

MAX_CONFIGS = 64


class FatalConfigError(ConfigError):
    """Init-time register errors: the reference aborts here (assert,
    vfgs_hw.c:348); we terminate the run with an error instead of silently
    continuing on the previous config."""


def adjust_chroma_cfg(sei, fmt: int) -> None:
    """Chroma model-value conversion for 4:2:2/4:2:0 (vfgs_main.c:208-230).

    Mutates in place; applied on every config pop, so values re-read from a
    config file get adjusted once but inherited values get re-adjusted (this
    matches the reference, whose statics persist across pops)."""
    if sei.model_id == 0:
        for c in (1, 2):
            if sei.comp_model_present_flag[c]:
                for k in range(sei.num_intensity_intervals[c]):
                    v = sei.comp_model_value[c][k]
                    if fmt < yuv.YUV_444:
                        v[1] = max(2, min(14, int(v[1]) << 1))
                    if fmt < yuv.YUV_422:
                        v[2] = max(2, min(14, int(v[2]) << 1))
                    if fmt == yuv.YUV_420:
                        v[0] = int(v[0]) >> 1
                    elif fmt == yuv.YUV_422:
                        v[0] = (int(v[0]) * 181 + 128) >> 8


def check_cfg_sei(sei, fmt: int, depth: int) -> None:
    """vfgs_main.c:232-267, including the index typo in the vertical-cutoff
    check (the lower bound is tested on value[1], vfgs_main.c:254)."""
    _check(fmt == yuv.YUV_420 or (not sei.comp_model_present_flag[1]
                                  and not sei.comp_model_present_flag[2]),
           "color grain currently not supported on yuv422 and yuv444 formats")
    _check(sei.model_id == 0 or (not sei.comp_model_present_flag[1]
                                 and not sei.comp_model_present_flag[2]),
           "color grain currently not supported in SEI.AR mode")
    _check(sei.model_id <= 1, "SEIFGCModelId shall be 0 or 1")
    rng = 1 << depth
    for c in range(3):
        if sei.comp_model_present_flag[c]:
            _check(1 <= sei.num_model_values[c] <= 6,
                   f"SEIFGCNumModelValuesMinus1Comp{c} out of 0..5 range")
            for i in range(sei.num_intensity_intervals[c]):
                v = sei.comp_model_value[c][i]
                _check(sei.intensity_interval_lower_bound[c][i]
                       <= sei.intensity_interval_upper_bound[c][i],
                       f"inconsistent interval {i} for component {c}")
                _check(v[0] < rng,
                       f"scaling factor for component {c} and interval {i} is too large")
                if sei.model_id == 0:
                    _check(2 <= v[1] <= 14,
                           f"horizontal cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                    _check(v[1] >= 2 and v[2] <= 14,
                           f"vertical cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                else:
                    for mv in (1, 3, 5):
                        _check(-rng // 2 <= v[mv] < rng // 2,
                               f"AR coefficient for component {c} and interval "
                               f"{i} is out of range")


def check_cfg_afgs1(afgs1, fmt: int) -> None:
    """vfgs_main.c:269-298."""
    _check(fmt == yuv.YUV_420 or (not afgs1.num_cb_points
                                  and not afgs1.num_cr_points),
           "color grain currently not supported on yuv422 and yuv444 formats")
    for name, vals, n in (("y", afgs1.point_y_values, afgs1.num_y_points),
                          ("cb", afgs1.point_cb_values, afgs1.num_cb_points),
                          ("cr", afgs1.point_cr_values, afgs1.num_cr_points)):
        for i in range(1, n):
            _check(vals[i] > vals[i - 1],
                   f"afgs1.point_{name}_values shall be in increasing order")


def check_cfg(sei, afgs1, fmt: int, depth: int) -> None:
    if afgs1.num_y_points:
        check_cfg_afgs1(afgs1, fmt)
    else:
        check_cfg_sei(sei, fmt, depth)


def apply_gain(gain: int, sei, afgs1) -> None:
    """Global grain-strength rescale (vfgs_main.c:561-593). Mutates in place.

    ``gain`` is unsigned in the reference (so a negative CLI value wraps to a
    huge number and the halving loop still terminates), and the scale
    multiplications are unsigned 32-bit; both are replicated here."""
    gain = int(gain) & 0xFFFFFFFF
    if gain == 100:
        return

    def umul_div(v: int) -> int:
        # (int)v * (unsigned)gain / 100 in C: unsigned 32-bit wrap + udiv.
        return ((int(v) * gain) & 0xFFFFFFFF) // 100

    if afgs1.num_y_points:
        while gain > 100:
            afgs1.grain_scaling = (afgs1.grain_scaling - 1) & 0xFF
            gain //= 2
        while gain and gain < 50:
            afgs1.grain_scaling = (afgs1.grain_scaling + 1) & 0xFF
            gain *= 2
        for arr, n in ((afgs1.point_y_scaling, afgs1.num_y_points),
                       (afgs1.point_cb_scaling, afgs1.num_cb_points),
                       (afgs1.point_cr_scaling, afgs1.num_cr_points)):
            for i in range(n):
                arr[i] = np.uint8(umul_div(arr[i]) & 0xFF)
    else:
        while gain > 100:
            sei.log2_scale_factor = (sei.log2_scale_factor - 1) & 0xFF
            gain //= 2
        while gain and gain < 50:
            sei.log2_scale_factor = (sei.log2_scale_factor + 1) & 0xFF
            gain *= 2
        for c in range(3):
            if sei.comp_model_present_flag[c]:
                for i in range(sei.num_intensity_intervals[c]):
                    v = umul_div(sei.comp_model_value[c][i][0])
                    sei.comp_model_value[c][i][0] = np.int16(
                        ((v + 0x8000) & 0xFFFF) - 0x8000)


def parse_cfg_param(param: str):
    """Parse a ``[poc:]filename`` -c argument (vfgs_main.c:595-633)."""
    poc = 0
    filename = param
    idx = param.find(":")
    if idx >= 0:
        head = param[:idx]
        if head and all(parsers._isdig(ch) for ch in head):
            _check(len(head) < 16, "illegal configuration POC")
            poc = int(head)
            filename = param[idx + 1:]
    return poc, filename


def _open(path: str, mode: str):
    """``open``, failing with the reference's wording."""
    try:
        return open(path, mode)
    except OSError:
        what = "open" if "r" in mode else "create"
        raise OSError(f"Can not {what} file {path}")


class _FileSource:
    """The frame loop's source on an open binary file: frames read with
    ``readinto`` into the host ring ``ring`` in turn and lent as a
    :class:`native_io.FrameReader` lends them.  A frame is read over
    again ``len(ring)`` frames later, which the loop holds fewer than, so
    giving frames back has nothing to do."""

    def __init__(self, f, ring: torch.Tensor):
        self.f, self.frames, self.n = f, list(ring.numpy()), 0

    def next(self):
        frame = self.frames[self.n % len(self.frames)]
        if self.f.readinto(frame) != frame.size:
            return None
        self.n += 1
        return frame

    def release(self, n: int) -> None:
        pass


class _FileSink:
    """The frame loop's sink on an open binary file: lends the frames of
    the host ring ``ring`` in turn, as a :class:`native_io.FrameWriter`
    lends them, and writes each one put at once, so a frame not put is
    not written and giving it back has nothing to do."""

    def __init__(self, f, ring: torch.Tensor):
        self.f, self.frames, self.n = f, list(ring.numpy()), 0

    def acquire(self):
        self.n += 1
        return self.frames[(self.n - 1) % len(self.frames)]

    def put(self, frame) -> None:
        self.f.write(frame)

    def give_back(self, frames) -> None:
        pass


class GrainPipeline:
    """Holds persistent metadata/register state and processes frames."""

    def __init__(self, width: int, height: int, depth: int, fmt: int,
                 gain: int = 100, seed: int = 0, seek: int = 0,
                 configs=(), engine: str = "auto", grain_offset: int = 0,
                 initial_sei=None, initial_afgs1=None, device=None):
        """``initial_sei``/``initial_afgs1`` replace the built-in default
        config (vfgs_main.c:69-125).  The CLI always starts from the default
        like the reference (which therefore cannot run 4:2:2/4:4:4 at all --
        its chroma-bearing default fails validation); library users can pass
        a luma-only config here to process those formats.

        ``device``: where frames are grained; ``None`` means ``cuda``, and a
        CUDA device without a card raises (pass ``device="cpu"`` for the
        plain engines on the CPU).  ``engine``: ``natural`` is
        the CUDA kernel (ops/grain_natural.py) and needs a CUDA device;
        ``pallas`` is the tiled engine (ops/grain_pallas.py): its CUDA
        kernel on a CUDA device, its plain version on the CPU;
        ``ref`` and ``fast`` are the plain torch engine on ``device``;
        ``auto`` picks ``natural`` on CUDA and ``ref`` elsewhere."""
        if depth not in (8, 10):
            raise ConfigError("input depth must be 8 or 10")
        if width <= 128 or height < 128:
            # The reference hard-asserts width > 128 in the HW hot path
            # (vfgs_hw.c:167-170) and aborts at width == 128; we reject it as
            # a config error instead.
            raise ConfigError("width must be greater than 128 and height at "
                              "least 128")
        if grain_offset < 0:
            raise ConfigError("grain offset must be non-negative")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: GrainPipeline runs on the "
                               "card unless asked otherwise; pass "
                               "device=\"cpu\" (CLI: --device cpu) for the "
                               "plain engines on the CPU")
        if engine == "auto":
            engine = "natural" if self.device.type == "cuda" else "ref"
        if engine not in ("natural", "pallas", "fast", "ref"):
            raise ConfigError(f"unknown engine {engine!r}")
        if engine == "natural" and self.device.type != "cuda":
            raise RuntimeError("engine 'natural' is the CUDA kernel and needs "
                               f"a CUDA device, got {self.device}")
        self.engine = engine
        self.width, self.height = width, height
        self.depth, self.fmt = depth, fmt
        self.gain, self.seek = gain, seek
        self.sei = initial_sei if initial_sei is not None else cfgmod.default_sei()
        self.afgs1 = (initial_afgs1 if initial_afgs1 is not None
                      else cfgmod.default_afgs1())
        self.regs = HwRegs()
        self.configs = [parse_cfg_param(p) for p in configs]
        _check(len(self.configs) <= MAX_CONFIGS,
               f"too many configurations (maximum is {MAX_CONFIGS})")
        self.icfg = 0
        self.epoch = 0  # frame index of last reseed
        # Extension beyond the reference: offset the grain-state lattice so a
        # run over frames [grain_offset, ...) is bit-identical to those frames
        # of a full seek-0 run (the reference's -s restarts grain state from
        # the seed, which we replicate when grain_offset == 0).  This is what
        # makes disjoint frame shards concatenate exactly.
        self.grain_offset = grain_offset
        self._tables_cache = None  # ((engine, generation), device tables)
        self._cfg_generation = 0
        self._carry = None  # pad-leak widths: the last output (_upload)
        self._R = -(-height // 16)
        self._C = -(-width // 16)

        check_cfg(self.sei, self.afgs1, fmt, depth)
        self.regs.set_depth(depth)
        self.regs.set_chroma_subsampling(2 if fmt < yuv.YUV_444 else 1,
                                         2 if fmt < yuv.YUV_422 else 1)
        adjust_chroma_cfg(self.sei, fmt)
        apply_gain(gain, self.sei, self.afgs1)
        self._init_fw(frame=0)
        if seed:
            self.regs.set_seed(seed)

    # ------------------------------------------------------------------

    def _init_fw(self, frame: int) -> None:
        # The reference aborts on an out-of-range scale shift (assert,
        # vfgs_hw.c:348, e.g. --gain driving log2_scale_factor out of [2,8));
        # we fail with a config error instead.
        with tracing.span("fw_init"):
            try:
                if self.afgs1.num_y_points:
                    fw.init_afgs1(self.afgs1, self.regs)
                    self.epoch = frame  # init_afgs1 reseeds (vfgs_fw.c:672)
                else:
                    fw.init_sei(self.sei, self.regs)
            except ValueError as e:
                raise FatalConfigError(str(e))
            self._cfg_generation += 1

    def _tables(self) -> dict:
        """Device tables of the current config, uploaded once per config."""
        key = (self.engine, self._cfg_generation)
        if self._tables_cache is None or self._tables_cache[0] != key:
            make = pallas_tables if self.engine == "pallas" else natural_tables
            with tracing.span("tables"):
                self._tables_cache = (key, make(self.regs, self.device))
            tracing.count("table_uploads")
        return self._tables_cache[1]

    def _step(self, y, u, v, bases, bases_up, tables):
        """Grain a batch of padded device planes with the selected engine."""
        kw = dict(bs=self.regs.bs, csubx=self.regs.csubx,
                  csuby=self.regs.csuby)
        with tracing.span("step"):
            if self.engine in ("natural", "pallas"):
                step = (add_grain_batch_natural if self.engine == "natural"
                        else add_grain_batch_pallas)
                return step(y, u, v, bases, bases_up, tables,
                            height=self.height, width=self.width, **kw)
            return add_grain_batch_plain(y, u, v, bases, tables, **kw)

    def pop_cfg(self, frame: int) -> None:
        """Re-read/validate/adjust/re-init for the next scheduled config."""
        _check(self.icfg < len(self.configs), "No configuration to pop")
        with tracing.span("config_pop"):
            poc, filename = self.configs[self.icfg]
            with tracing.span("cfg_read"):
                parsers.read_cfg(filename, self.sei, self.afgs1)
                check_cfg(self.sei, self.afgs1, self.fmt, self.depth)
                adjust_chroma_cfg(self.sei, self.fmt)
                apply_gain(self.gain, self.sei, self.afgs1)
            self.icfg += 1
            if self.grain_offset:
                # Sharded mode: an AFGS1 reseed epoch is the config's global
                # POC (where the full seek-0 run would have popped it),
                # keeping shard output identical to the full run.
                self._init_fw(poc)
            else:
                self._init_fw(frame)
        tracing.count("config_pops")

    def maybe_switch_config(self, n: int) -> None:
        while (self.icfg < len(self.configs)
               and n + self.seek >= self.configs[self.icfg][0]):
            try:
                self.pop_cfg(n)
            except FatalConfigError:
                raise
            except (ConfigError, OSError, ValueError, IndexError,
                    UnicodeDecodeError) as e:
                # The reference keeps processing with the previous config on a
                # failed read/check pop (vfgs_main.c:773-776); malformed
                # inputs that would be undefined behaviour in C (e.g. the
                # dump parser's component counter running past 2) are
                # treated the same way.
                print(f"Error: {e}", file=sys.stderr)
                break

    # ------------------------------------------------------------------

    def _has_pad_leak(self) -> bool:
        """True when a deblock at the last interior block boundary reads one
        grain sample beyond the real width (component width == 1 mod block
        width).  The reference then depends on its persistent frame buffer's
        stride padding -- malloc-zeroed at start, accumulating grained values
        across frames (vfgs_hw.c:243-283 writes the full final block;
        yuv_read only overwrites `width` samples per row) -- so at those
        widths a step takes one frame, and its padding from the last
        step's output (:meth:`_upload`)."""
        if self._C < 2:
            return False
        for subx in (1, self.regs.csubx):
            if (self.width // subx) % (16 // subx) == 1:
                return True
        return False

    def frame_bases(self, n: int) -> tuple[int, int]:
        """LFSR lattice bases for frame n (see ops/lfsr.py)."""
        R, C = self._R, self._C
        with tracing.span("frame_bases"):
            e0 = lfsr.frame_base_exponent(n + self.grain_offset - self.epoch,
                                          R, C)
            base = lfsr.advance_int(self.regs.seed_state, e0)
            base_up = (lfsr.advance_int(self.regs.seed_state, e0 - C)
                       if e0 > 0 else base)
        return base, base_up

    # -- staging, shared by process_frame and the frame loop --------------

    def _padded_batch(self, frames: int) -> list:
        """Device (Y, U, V) planes of ``frames`` padded frames."""
        R, C = self._R, self._C
        bhc, bwc = 16 // self.regs.csuby, 16 // self.regs.csubx
        shapes = ((R * 16, C * 16), (R * bhc, C * bwc), (R * bhc, C * bwc))
        dtype = torch.uint8 if self.depth == 8 else torch.uint16
        return [torch.empty((frames, *s), dtype=dtype, device=self.device)
                for s in shapes]

    def _pad(self, planes, padded) -> list:
        """Write the device planes ``planes`` into the first frames of the
        padded device planes ``padded`` and fill what lies outside each
        frame: its edge (:func:`yuv.pad_batch`), or at a pad-leak width
        (one frame a step) the carry: the last step's output, zeros before
        the first frame, as the reference's persistent frame buffer holds
        them.  Each entry of ``planes`` is a (count, h, w) tensor (a batch
        of host frames in the raw bytes) or a list of ``count`` (h, w)
        tensors, one a device frame.  Returns the filled planes."""
        leak = self._has_pad_leak()
        if leak and self._carry is None:
            self._carry = [torch.zeros(d.shape[1:], dtype=d.dtype,
                                       device=self.device) for d in padded]
        out = []
        for k, (p, d) in enumerate(zip(planes, padded)):
            d = d[:len(p)]
            parts = [(d, p)] if torch.is_tensor(p) else [
                (d[i:i + 1], q[None]) for i, q in enumerate(p)]
            for dst, src in parts:
                h, w = src.shape[1:]
                if not leak:
                    yuv.pad_batch(dst, src)
                else:
                    dst[:, :h, :w] = src
                    dst[:, h:] = self._carry[k][h:]
                    dst[:, :h, w:] = self._carry[k][:h, w:]
            out.append(d)
        return out

    def _upload(self, frames, raw, padded) -> list:
        """Start the copy of the frames ``frames``, as a source lends them,
        to the device and pad them there into ``padded`` (:meth:`_pad`).
        Host frames (raw frame bytes) are copied into the first rows of
        the device bytes ``raw`` first; frames on the pipeline's device
        (:meth:`_device_planes`) are padded from their own plane views, so
        no copy of them is made beside (``raw`` may be None).  Returns the
        planes."""
        if torch.is_tensor(frames[0]):
            tracing.count("device_frames", len(frames))
            return self._pad(self._device_planes(frames), padded)
        for row, frame in zip(raw, frames):
            row.copy_(torch.from_numpy(frame), non_blocking=True)
        return self._pad([p[:len(frames)] for p in self._planes(raw)],
                         padded)

    def _device_planes(self, frames, depth: int = 0) -> list:
        """The (Y, U, V) plane views of device frames ``frames``, each a
        1-D uint8 tensor on the pipeline's device holding a frame of
        ``depth`` bits (the input's unless given) as the files lay it
        out: three lists of (h, w) views, one a frame, so that a frame
        may be any allocation of its own (a decoder's surface)."""
        nbytes = self._frame_bytes(depth)
        for f in frames:
            if (f.dtype != torch.uint8 or f.dim() != 1
                    or f.numel() != nbytes
                    or f.device.type != self.device.type
                    or self.device.index not in (None, f.device.index)):
                raise ValueError(
                    f"a device frame is a 1-D uint8 tensor of {nbytes} "
                    f"bytes on {self.device}, got {tuple(f.shape)} "
                    f"{f.dtype} on {f.device}")
        per = [self._planes(f[None], depth) for f in frames]
        return [[p[k][0] for p in per] for k in range(3)]

    def _grain(self, dev, bases, bases_up, tables):
        """One step; at a pad-leak width its output becomes the carry."""
        out = self._step(*dev, bases, bases_up, tables)
        if self._has_pad_leak():
            self._carry = [o[-1] for o in out]
        return out

    def process_frame(self, planes, n: int):
        """Add grain to one (Y, U, V) frame (numpy in/out, same dtype), with
        the frame loop's staging: padded on the device, grained, cropped
        on the device."""
        self.maybe_switch_config(n)
        dev = self._pad([torch.tensor(p)[None].to(self.device)
                         for p in planes], self._padded_batch(1))
        base, base_up = self.frame_bases(n)
        out = self._grain(dev, [base], [base_up], self._tables())
        # copied on the CPU too, where .cpu() returns the tensor itself: a
        # returned frame must not alias the carry
        return tuple(o[0, :p.shape[0], :p.shape[1]].to("cpu", copy=True)
                     .numpy() for o, p in zip(out, planes))

    # -- the frame loop ----------------------------------------------------

    def _planes(self, raw: torch.Tensor, depth: int = 0):
        """View frame bytes ``raw`` (uint8, frames one a row) as (Y, U, V)
        planes of ``depth`` bits (the input's unless given), each
        (frames, h, w)."""
        w, h = self.width, self.height
        cw, ch = yuv.chroma_dims(w, h, self.fmt)
        arr = raw if (depth or self.depth) == 8 else raw.view(torch.uint16)
        out, a = [], 0
        for s in ((h, w), (ch, cw), (ch, cw)):
            out.append(arr[:, a:a + s[0] * s[1]].unflatten(1, s))
            a += s[0] * s[1]
        return out

    def _frame_bytes(self, depth: int = 0) -> int:
        """Bytes of a frame at ``depth`` bits (the input's unless given)."""
        return yuv.frame_bytes(self.width, self.height, depth or self.depth,
                               self.fmt)

    def _ring_frames(self, batch: int, frames: int) -> int:
        """Host frames in each ring of the loop at ``batch``: the reader's
        holds the batch in flight to the device, the one before it until
        its copies are done, and the next as it is read; the writer's the
        batch coming back, the one before it until it is put, and one
        batch of slack for its thread.  Never more than the frames asked
        for."""
        n = 3 * (1 if self._has_pad_leak() else batch)
        return min(n, frames) if frames else n

    def _file_ends(self, fsrc, fdst, batch: int, frames: int, odepth: int):
        """The loop's frame source and sink on two open binary files, the
        ``seek`` frames skipped, each with a host ring of its own."""
        yuv.skip_frames(fsrc, self.seek, self.width, self.height,
                        self.depth, self.fmt)
        nbuf = self._ring_frames(batch, frames)
        pinned = self.device.type == "cuda"
        return (_FileSource(fsrc, native_io.host_ring(
                    nbuf, self._frame_bytes(), pinned)),
                _FileSink(fdst, native_io.host_ring(
                    nbuf, self._frame_bytes(odepth), pinned)))

    def run(self, fsrc, fdst, frames: int = 0, odepth: int = 0) -> int:
        """The frame loop (vfgs_main.c:762-796, :meth:`_loop`) over two
        open binary files, one frame a step.  Returns frames written."""
        return self._loop(
            lambda opened: self._file_ends(fsrc, fdst, 1, frames, odepth),
            frames, odepth, batch=1)

    def run_file(self, src: str, dst: str, frames: int = 0, odepth: int = 0,
                 batch: int = 4, profile_dir: str | None = None,
                 verbose: bool = False) -> int:
        """The frame loop (:meth:`_loop`) over file paths, ``batch`` frames
        a step, through the native prefetching reader and async writer
        (utils/native_io.py), whose rings the copies to and from the device
        use directly, or the files themselves where the native library
        cannot be built; the same bytes as :meth:`run`'s.
        ``profile_dir`` writes a torch.profiler trace (``trace.json``) of
        the loop with the host spans of ``utils/tracing.py`` on a track of
        their own; ``verbose`` prints the stages' wall-clock to stderr,
        then each span's count, total and self time and the counters."""
        if batch > 1 and self._has_pad_leak():
            print(f"[vfg-torch] note: at width {self.width} a deblock reads "
                  "one sample past the frame edge, where the reference "
                  "keeps the last frame's grained padding; frames go one "
                  "at a time to stay bit-exact", file=sys.stderr)

        def open_ends(opened):
            if not native_io.available():
                return self._file_ends(
                    opened.enter_context(_open(src, "rb")),
                    opened.enter_context(_open(dst, "wb")),
                    batch, frames, odepth)
            nbuf = self._ring_frames(batch, frames)
            pinned = self.device.type == "cuda"
            return [opened.enter_context(contextlib.closing(end)) for end in (
                native_io.FrameReader(src, self._frame_bytes(), nbuf=nbuf,
                                      seek_frames=self.seek, pinned=pinned),
                native_io.FrameWriter(dst, self._frame_bytes(odepth),
                                      nbuf=nbuf, pinned=pinned))]
        return self._loop(open_ends, frames, odepth, batch, profile_dir,
                          verbose)

    def run_device(self, src, dst, frames: int = 0, odepth: int = 0,
                   batch: int = 4, profile_dir: str | None = None,
                   verbose: bool = False) -> int:
        """The frame loop (:meth:`_loop`) over frames on the pipeline's
        device, ``batch`` a step: ``src`` lends them and ``dst`` takes the
        grained frames, as ``utils/device_io.py`` sets out (its
        ``DeviceSource`` and ``DeviceSink``, or a decoder's and an
        encoder's adapters).  Every copy stays on the device: frames are
        padded from the source's frames and cropped (10 -> 8 bits with
        ``odepth`` 8) into the sink's.  The first frame ``src`` lends is
        POC ``seek``, as the first frame ``run_file`` reads after the
        skipped ones; ``frames``, ``profile_dir`` and ``verbose`` as in
        :meth:`run_file`, whose bytes it gives.  The caller's ends stay
        open.  Returns frames written."""
        return self._loop(lambda opened: (src, dst), frames, odepth, batch,
                          profile_dir, verbose)

    def _loop(self, open_ends, frames: int, odepth: int, batch: int,
              profile_dir: str | None = None, verbose: bool = False) -> int:
        """The frame loop of :meth:`run`, :meth:`run_file` and
        :meth:`run_device`: raw frames from a source, grained ``batch`` at
        a step (one at a pad-leak width), to a sink with ``odepth`` bits;
        ``frames`` of them, or all if 0.  ``open_ends(opened)`` makes the
        source and the sink; the ExitStack ``opened`` closes what it
        enters as the loop ends.  Batches never
        straddle a config-switch POC.  The root span is ``run_file``
        whoever calls.  Returns frames written."""
        odepth = odepth or self.depth
        assert odepth in (8, 10) and odepth <= self.depth
        if self._has_pad_leak():
            batch = 1
        root = None
        with tracing.forced(verbose or bool(profile_dir)):
            prof = contextlib.nullcontext()
            if profile_dir:
                from torch.profiler import ProfilerActivity, profile
                os.makedirs(profile_dir, exist_ok=True)
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA]
                    if self.device.type == "cuda" else []))
            try:
                with prof, tracing.span("run_file") as root:
                    counted = tracing.counters()
                    with contextlib.ExitStack() as opened:
                        return self._steps(*open_ends(opened), frames,
                                           odepth, batch)
            finally:
                if root is not None and profile_dir:
                    trace = os.path.join(profile_dir, "trace.json")
                    prof.export_chrome_trace(trace)
                    tracing.add_to_chrome_trace(trace, root.spans)
                if root is not None and verbose:
                    self._report(root, counted)

    def _steps(self, src, dst, frames: int, odepth: int,
               batch: int) -> int:
        """The body of :meth:`_loop`.  Frames stay in the ends' host rings:
        ``src.next()`` lends the next input frame until ``src.release``
        gives it back, ``dst.acquire()`` a frame to fill, which
        ``dst.put`` writes (``dst.give_back`` returns one not put); the
        copies to and from the device use them
        directly, and this thread copies no frame bytes on the host.  On
        CUDA, batch N+1 is read and uploaded while batch N computes, and
        batch N's device-to-host copy is waited for only when it is put,
        one batch later.  The device buffers are made once a call and
        serve every batch (the copies and steps that use them queue in
        order on one stream): padded planes, and for host frames, made at
        the first one, the raw input frame bytes and the output frame
        bytes laid out as the output file.  Frames lent on the device
        (:meth:`run_device`) need neither: they are padded from their
        own plane views and cropped straight into the sink's frames."""
        cuda = self.device.type == "cuda"
        slots = min(batch, frames) if frames else batch
        padded = self._padded_batch(slots)
        tracing.count("staging_allocs", 3)
        made = {}

        def host_bytes(depth):
            """The device bytes of a batch of host frames of ``depth`` bits
            coming in (0: the input's) or going out (``odepth``), and
            their (Y, U, V) views, made at the first host frame."""
            key = "out" if depth else "in"
            if key not in made:
                rows = torch.empty((slots, self._frame_bytes(depth)),
                                   dtype=torch.uint8, device=self.device)
                made[key] = rows, self._planes(rows, depth)
                tracing.count("staging_allocs")
            return made[key]
        # the H2D copies from and the D2H copies to the ring frames of the
        # batches that last used each of two slots, and how many input
        # frames those batches hold
        uploaded = [torch.cuda.Event() for _ in range(2)] if cuda else None
        downloaded = [torch.cuda.Event() for _ in range(2)] if cuda else None
        held = [0, 0]
        eof = False

        def prepare(n0, slot):
            """Stage the batch starting at global frame ``n0``: pop any due
            config, take its frames from the source's ring, give back
            those of the batch two back, START their copy to the device
            and pad them there, and resolve the tables of the (possibly
            new) config.  Called for batch N+1 right after batch N's step
            is enqueued, so the host work overlaps the compute."""
            nonlocal eof
            if eof or (frames and n0 >= frames):
                return None
            tracing.set_batch(n0)
            self.maybe_switch_config(n0)
            # frames until the next config switch; the batch is cut there
            # unless the stream ends first
            limit, cut = batch, False
            if self.icfg < len(self.configs):
                due = max(1, self.configs[self.icfg][0] - (n0 + self.seek))
                limit, cut = min(limit, due), due < limit
            if frames and frames - n0 <= limit:
                limit, cut = frames - n0, False
            taken = []
            with tracing.span("read"):
                while len(taken) < limit:
                    frame = src.next()
                    if frame is None:
                        eof = True
                        break
                    taken.append(frame)
            count = len(taken)
            if not count:
                return None
            if cut and not eof:
                tracing.count("switch_cuts")
            with tracing.span("stage"):
                if cuda:
                    # the slot's last upload, two batches back, may still
                    # be reading its ring frames
                    uploaded[slot].synchronize()
                src.release(held[slot])
                held[slot] = count
            bases, bases_up = zip(*(self.frame_bases(n0 + i)
                                    for i in range(count)))
            with tracing.span("upload"):
                dev = self._upload(taken, None if torch.is_tensor(taken[0])
                                   else host_bytes(0)[0], padded)
                if cuda:
                    uploaded[slot].record()
            # resolve the tables NOW: a later prepare() may pop the next
            # config before this batch runs
            return dev, bases, bases_up, self._tables(), count

        def start_download(out, count, slot):
            """Crop a batch's output planes on the device, frame by frame
            as the output file holds them (10-bit planes written as 8 bits
            are rounded first, (x + 2) >> 2, yuv.c:216-258), into the
            frames the sink lends, waiting while its thread has none free:
            into device frames straight, or into the output frame bytes,
            each frame then copied into a host frame.  A device frame
            takes a copy a plane (:meth:`_device_planes`), the output
            bytes one a plane a batch.  Returns the sink's frames."""
            with tracing.span("download"):
                taken = [dst.acquire() for _ in range(count)]
                on_device = torch.is_tensor(taken[0])
                if on_device:
                    dests = self._device_planes(taken, odepth)
                else:
                    rows, planes = host_bytes(odepth)
                    dests = [p[:count] for p in planes]
                for o, d in zip(out, dests):
                    h, w = d[0].shape
                    q = o[:, :h, :w]
                    if odepth < self.depth:
                        q = ((q.to(torch.int32) + 2) >> 2).to(torch.uint8)
                    if on_device:
                        for frame_plane, plane in zip(d, q):
                            frame_plane.copy_(plane)
                    else:
                        d.copy_(q)
                if not on_device:
                    for row, frame in zip(rows, taken):
                        torch.from_numpy(frame).copy_(row, non_blocking=True)
                if cuda:
                    downloaded[slot].record()
            return taken

        def flush(p):
            taken, slot, n0 = p
            tracing.set_batch(n0)
            with tracing.span("wait"):
                if cuda:
                    downloaded[slot].synchronize()
            for i in range(len(taken)):
                with tracing.span("assemble"):
                    frame = taken[i]
                with tracing.span("put"):
                    dst.put(frame)
            # a frame that no put took goes back unwritten, so that the
            # sink's thread never waits on it
            dst.give_back(taken)

        n, slot = 0, 0
        pending = None  # (sink frames, slot, n0)
        cur = prepare(0, slot)
        while cur is not None:
            dev, bases, bases_up, tables, count = cur
            tracing.set_batch(n)
            out = self._grain(dev, bases, bases_up, tables)
            # Start this batch's copy back now; flush() waits for it one
            # batch later, after the next batch has been staged.
            done = start_download(out, count, slot)
            tracing.count("frames", count)
            tracing.count("batches")
            n0 = n
            n += count
            cur = prepare(n, 1 - slot)
            if pending is not None:
                flush(pending)
            pending = (done, slot, n0)
            slot = 1 - slot
        if pending is not None:
            flush(pending)
        return n

    def _report(self, root, counted: dict) -> None:
        """``_loop``'s verbose lines: the frame rate and the stages'
        wall-clock, then each span's count, total and self time, and the
        counters the run added."""
        tot = tracing.summary(root.spans, root.i)
        now = tracing.counters()
        n = now.get("frames", 0) - counted.get("frames", 0)

        def secs(*names):
            return sum(tot[k][1] for k in names if k in tot)

        total = secs("run_file")
        fps = n / total if total > 0 else 0.0
        lines = [f"{n} frames in {total:.3f}s ({fps:.1f} fps) on "
                 f"{self.device} ({self.engine}) | read+stage "
                 f"{secs('read', 'stage'):.3f}s step "
                 f"{secs('step', 'download'):.3f}s drain+write "
                 f"{secs('wait', 'assemble', 'put'):.3f}s",
                 f"{'span':<14}{'count':>8}{'total s':>11}{'self s':>11}"]
        lines += [f"{k:<14}{c:>8}{t:>11.3f}{own:>11.3f}"
                  for k, (c, t, own) in tot.items()]
        lines.append("counters: " + ", ".join(
            f"{k} {now.get(k, 0) - counted.get(k, 0)}"
            for k in tracing.COUNTERS))
        for line in lines:
            print(f"[vfg-torch] {line}", file=sys.stderr)
