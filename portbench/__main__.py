"""``python -m portbench``: run one cell once (see run.py)."""

import time

T_START = time.monotonic()   # set-up is timed from here

# The program runs on all CPUs but those kept for the harness's feeder and
# sink (affinity.py); pinned before torch starts a thread.
from portbench import affinity  # noqa: E402

affinity.pin_program()

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
