"""Build the native host library once, before any test runs.

native/libkeyhunt_host.so is not committed, and the JAX package loads it
unconditionally (filter/host_table.py). Building it here, under a file
lock that every xdist worker and the controller pass in turn, means no
test depends on which module happened to run first. Without make or a
C++ compiler this does nothing and the native tests skip as before.
"""

import fcntl
import os
import shutil
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    lib = os.path.join(NATIVE, "libkeyhunt_host.so")
    cxx = os.environ.get("CXX", "g++")
    if os.path.exists(lib) or not (shutil.which("make") and shutil.which(cxx)):
        return
    with open(os.path.join(NATIVE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            subprocess.run(["make", "-C", NATIVE], capture_output=True)
