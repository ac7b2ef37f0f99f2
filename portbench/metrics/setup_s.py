"""setup_s (s, host clock): from the process's start to the window's
opening: imports, the CUDA context, the seeded pool, helper processes, the
program's set-up and one warm-up batch or stream (in a checkout's first
run also the kernel and library builds)."""


def read(rec):
    return rec["setup_s"]
