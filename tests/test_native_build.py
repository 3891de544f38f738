"""The JAX package's two native libraries, built whole before the suite's
other test files load them (ROADMAP F9).

``t2igan.native`` compiles ``libt2igan_image.so`` and ``libt2igan_exec.so``
straight into place at first use, and ``tests/test_native_exec.py`` and
``tests/test_native_image.py`` first use them while pytest imports them.
Under xdist every worker imports every test file at once, so in a
checkout without the libraries (git ignores them) the workers compiled
together and some loaded a half-written file: a collection error, and a
run that counted no test.  This file is collected before those two (its
name sorts first), and at import it builds each stale library under a lock
shared by the workers, to a temporary name that is then renamed into
place, so every other worker finds the whole library, fresh, and builds
nothing.  The libraries are the JAX package's own build products; nothing
of the package changes.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile

from t2igan import native as jnative

# (library, its source, compiler arguments): t2igan/native/__init__.py's
# commands, OpenMP dropped for the image library only where g++ lacks it.
_LIBRARIES = [
    (jnative._SO, jnative._SRC, [["-fopenmp", jnative._SRC], [jnative._SRC]]),
    (jnative._EXEC_SO, jnative._EXEC_SRC,
     [["-std=c++17", jnative._EXEC_SRC, "-ljpeg", "-lpng", "-lpthread"]]),
]


def _stale(so: str, src: str) -> bool:
    return not os.path.isfile(so) or os.path.getmtime(so) < max(
        os.path.getmtime(src), os.path.getmtime(jnative._HDR))


def build_jax_native() -> None:
    """Build each stale JAX native library whole, under a lock shared by
    the processes of one test run; a fresh one is left as it is."""
    lock_path = os.path.join(tempfile.gettempdir(),
                             "t2igan-native-build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for so, src, variants in _LIBRARIES:
            if not _stale(so, src):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            for args in variants:
                proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                       *args, "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode == 0:
                    os.replace(tmp, so)
                    break


build_jax_native()


def test_jax_native_libraries_are_whole_and_fresh():
    for so, src, _ in _LIBRARIES:
        assert not _stale(so, src), so
        ctypes.CDLL(so)
    assert jnative.available() and jnative.exec_available()
