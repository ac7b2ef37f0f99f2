"""vfgs-compatible command-line interface (reference: vfgs_main.c:646-738).

Flag-compatible with the reference binary, including its quirks: ``-h`` is
consumed by ``--height`` first (so help is ``--help`` only), unknown ``-x``
flags error out, and the two positional arguments are input/output YUV paths.
"""

from __future__ import annotations

import sys

from .pipeline import GrainPipeline
from .utils import yuv
from .utils.parsers import ConfigError

_DEFAULTS = dict(width=1920, height=1080, depth=10, frames=0, seek=0,
                 fmt=yuv.YUV_420)


def _format_str(fmt: int) -> str:
    return {yuv.YUV_420: "420", yuv.YUV_422: "422", yuv.YUV_444: "444"}.get(
        fmt, "???")


def _read_format(s: str) -> int:
    if s.lower() == "444":
        return yuv.YUV_444
    if s.lower() == "422":
        return yuv.YUV_422
    return yuv.YUV_420


def help_text(name: str) -> str:
    d = _DEFAULTS
    return (
        f"Usage: {name} [options] <input.yuv> <output.yuv>\n\n"
        f"   -w,--width    <value>           Picture width [{d['width']}]\n"
        f"   -h,--height   <value>           Picture height [{d['height']}]\n"
        f"   -b,--bitdepth <value>           Input bit depth [{d['depth']}]\n"
        "      --outdepth <value>           Output bit depth (<= input depth) [same as input]\n"
        f"   -f,--format   <value>           Chroma format (420/422/444) [{_format_str(d['fmt'])}]\n"
        f"   -n,--frames   <value>           Number of frames to process (0=all) [{d['frames']}]\n"
        f"   -s,--seek     <value>           Picture start index within input file [{d['seek']}]\n"
        "   -r,--seed     <value>           Random seed (non-zero 31-bits number)\n"
        "   -c,--cfg      [<x>:]<filename>  Read film grain configuration file, to be applied\n"
        "                                   from frame x (defaults to 0). Multiple -c are allowed.\n"
        "   -g,--gain     <value>           Apply a global scale (in percent) to grain strength\n"
        "   --help                          Display this page\n\n"
        "Extensions over the reference vfgs:\n"
        "   --batch        <value>          Frames per device dispatch [4]\n"
        "   --engine       <name>           Compute engine: natural (CUDA kernel), pallas\n"
        "                                   (tiled engine: CUDA kernel on a card, plain\n"
        "                                   torch elsewhere), ref or fast (plain torch)\n"
        "                                   [auto: natural on CUDA, ref elsewhere]\n"
        "   --device       <name>           Device: cuda (raises without a card) or cpu\n"
        "                                   (plain torch engines) [cuda]\n"
        "   --grain-offset <value>          Global grain-state frame offset (use with -s\n"
        "                                   for bit-exact frame sharding) [0]\n"
        "   --profile      <dir>            Write a torch.profiler trace to <dir>/trace.json,\n"
        "                                   with the host spans on a track of their own\n"
        "   -v,--verbose                    Per-stage wall-clock timings, then each span's\n"
        "                                   count, total and self time, and the counters\n"
    )


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    name = argv[0] if argv else "vfgs-torch"
    args = argv[1:]

    width, height = _DEFAULTS["width"], _DEFAULTS["height"]
    depth, odepth = _DEFAULTS["depth"], 0
    fmt = _DEFAULTS["fmt"]
    frames, seek = 0, 0
    seed, gain = 0, 100
    batch = 4
    engine = "auto"
    device = "cuda"
    profile_dir = None
    grain_offset = 0
    verbose = False
    configs: list[str] = []
    src = dst = None
    err = False

    def _atoi(s):
        from .utils.parsers import atoi
        return atoi(s)

    i = 0
    while i < len(args) and not err:
        p = args[i]
        pl = p.lower()

        def val():
            nonlocal i, err
            if i + 1 < len(args):
                i += 1
                return args[i]
            err = True
            return ""

        if pl in ("-w", "--width"):
            width = _atoi(val())
        elif pl in ("-h", "--height"):
            height = _atoi(val())
        elif pl in ("-b", "--bitdepth"):
            depth = _atoi(val())
        elif pl == "--outdepth":
            odepth = _atoi(val())
        elif pl in ("-f", "--format"):
            fmt = _read_format(val())
        elif pl in ("-n", "--frames"):
            frames = _atoi(val())
        elif pl in ("-s", "--seek"):
            seek = _atoi(val())
        elif pl in ("-r", "--seed"):
            seed = _atoi(val())
        elif pl in ("-c", "--cfg"):
            configs.append(val())
        elif pl in ("-g", "--gain"):
            gain = _atoi(val())
        elif pl == "--batch":  # extension: frames per device dispatch
            batch = max(1, _atoi(val()))
        elif pl == "--engine":  # extension: compute engine selection
            engine = val()
            if engine not in ("auto", "fast", "pallas", "natural", "ref"):
                print(f"Unknown engine {engine}")
                err = True
        elif pl == "--device":  # extension: where frames are grained
            device = val()
            if device not in ("cuda", "cpu"):
                print(f"Unknown device {device}")
                err = True
        elif pl == "--profile":  # extension: torch profiler trace directory
            profile_dir = val()
        elif pl == "--grain-offset":  # extension: global grain-state offset
            grain_offset = _atoi(val())  # (use with -s for exact sharding)
        elif pl in ("-v", "--verbose"):  # extension: per-stage timings
            verbose = True
        elif pl == "--help":
            print(help_text(name))
            return 1
        elif not p.startswith("-"):
            if src is None:
                src = p
            elif dst is None:
                dst = p
        else:
            print(f"Unknown parameter {p}")
            err = True
        i += 1

    if src is None or dst is None or err:
        print(help_text(name))
        return 1

    odepth = odepth or depth
    if depth not in (8, 10) or odepth not in (8, 10) or odepth > depth:
        print(help_text(name))
        return 1

    try:
        pipe = GrainPipeline(width, height, depth, fmt, gain=gain, seed=seed,
                             seek=seek, configs=configs, engine=engine,
                             grain_offset=grain_offset, device=device)
    except ConfigError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    try:
        # File open errors surface from run_file with the reference's
        # wording; FIFOs and /dev/stdin work like the reference's fopen().
        pipe.run_file(src, dst, frames=frames, odepth=odepth, batch=batch,
                      profile_dir=profile_dir, verbose=verbose)
    except ConfigError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(str(e) + "\n")
        print(help_text(name))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
