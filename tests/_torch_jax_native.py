"""The JAX package's host library (``native/libatmonr_native.so``), built
whole and loaded before a port test compares against it.

The package builds the library on first use with ``make -C native``, which
links straight onto the final file, and falls back to numpy for the rest of
the process when that build or the load fails. Under the suite's parallel
workers, a worker that loads the file while another is still linking it
would build its rays with numpy, which are not bit-equal to the port's
host library. So, under a lock shared by the workers, ``build`` links the
library into a file of its own with the Makefile's compiler and flags and
renames it onto the final name, loads it in this process (after a fallback,
anew), and links again where the load fails. The fixture fails a test
module whose comparison would otherwise run against numpy.
"""

import fcntl
import os
import re
import shlex
import subprocess

import pytest

from atmonr_tpu import native as jnative

NATIVE = jnative._NATIVE_DIR
LIBRARY = jnative._LIB_PATH
ATTEMPTS = 3


def _make_variable(name: str) -> list[str]:
    """A variable of ``native/Makefile`` (``NAME ?= value``), the
    environment's where it sets one, as make takes it."""
    if name in os.environ:
        return shlex.split(os.environ[name])
    text = (NATIVE / "Makefile").read_text()
    return shlex.split(re.search(rf"^{name}\s*\?=\s*(.*)$", text, re.M).group(1))


def _link() -> None:
    """The Makefile's rule into a file of this process, renamed onto the
    library's name."""
    tmp = NATIVE / f".{LIBRARY.name}.{os.getpid()}.tmp"
    try:
        subprocess.run([*_make_variable("CXX"), *_make_variable("CXXFLAGS"), "-shared", "-o",
                        str(tmp), "atmonr_native.cpp"], cwd=NATIVE, check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, LIBRARY)
    finally:
        tmp.unlink(missing_ok=True)


def build() -> None:
    """Leave ``atmonr_tpu.native.available()`` true in this process, or
    fail with the reason."""
    if jnative._lib is not None:
        return
    with open(NATIVE / f".{LIBRARY.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(ATTEMPTS):
            if attempt or not LIBRARY.exists():
                _link()
            jnative._lib, jnative._lib_tried = None, False
            if jnative.available():
                return
    pytest.fail(f"the JAX package's host library {LIBRARY} does not load after "
                f"{ATTEMPTS} builds: its comparisons would run against numpy")


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's host library, loaded, for every test of the
    module."""
    build()
