"""The traffic mixes' drivers (``<driver>.py``, named by a mix's ``driver``)
and the pipe drivers' helper processes (``_feed``, ``_sink``)."""
