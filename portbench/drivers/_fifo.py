"""Pipe size of a FIFO's open end (Linux ``F_SETPIPE_SZ``)."""

from __future__ import annotations

import fcntl


def set_pipe_size(fd: int, size: int) -> int:
    """Ask for a pipe of ``size`` bytes, halving the ask while the kernel
    refuses it; returns the size the pipe has."""
    while size >= 65536:
        try:
            return fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, size)
        except PermissionError:
            size //= 2
    return fcntl.fcntl(fd, fcntl.F_GETPIPE_SZ)
