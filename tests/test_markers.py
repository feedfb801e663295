"""The soak battery's deselection: the root conftest marks every `soak` test
`slow`.

The tier-1 command selects with `-m 'not slow'`, which replaces addopts'
`-m 'not soak'`; the soak battery stays out of it only through that
marking, and `-m soak` must still collect all of it.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _collect(expr):
    """(selected, deselected) of `tests/test_soak.py` under `-m expr`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_soak.py", "-q",
         "--collect-only", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-m", expr],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    ).stdout
    selected = sum("::" in line for line in out.splitlines())
    m = re.search(r"(\d+) deselected", out)
    return selected, int(m.group(1)) if m else 0


@pytest.fixture(scope="module")
def n_soak():
    """The file's tests under no marker filter (`-m ''` lifts addopts')."""
    selected, _ = _collect("")
    assert selected > 0
    return selected


@pytest.mark.parametrize("expr, want", [
    ("not slow", lambda n: (0, n)),
    ("soak", lambda n: (n, 0)),
], ids=["not slow", "soak"])
def test_soak_selection(expr, want, n_soak):
    assert _collect(expr) == want(n_soak)
