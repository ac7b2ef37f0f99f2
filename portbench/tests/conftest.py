"""The harness's CPU tests (``python -m pytest portbench/tests -q``):
registers the ``cuda`` marker of the card-only tests, which decide inside
the test whether a card is there; imports no JAX."""

from __future__ import annotations

import pytest

from cells import make_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A checkout copy with the small cells added."""
    return make_root(str(tmp_path_factory.mktemp("checkout")))
