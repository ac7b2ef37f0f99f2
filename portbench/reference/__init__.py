"""Frozen plain reference of the benchmark: the C model's host path (config
parsers, built-in config, FW init with the plain-Python AR fill, LFSR
jump-ahead) and its plain torch grain engine, in numpy and plain torch.

Imports neither JAX nor either grain package; ``model.Reference`` is the
entry.
"""
