"""Repository-wide pytest hooks: every `soak` test is also `slow`."""

import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Every `soak` test is also `slow`, so `-m 'not slow'` leaves the soak
    battery out as addopts' `-m 'not soak'` does; `-m soak` still runs it."""
    for item in items:
        if item.get_closest_marker("soak") is not None:
            item.add_marker(pytest.mark.slow)
