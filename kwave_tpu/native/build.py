"""Build the native codec shared library (g++, no pybind11 — plain C ABI for ctypes)."""

from __future__ import annotations

import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "codec.cpp")
LIB = os.path.join(_DIR, "libkwcodec.so")


def build(force: bool = False) -> str:
    """Compile codec.cpp -> libkwcodec.so if missing or stale. Returns the lib path."""
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= os.path.getmtime(SRC)
    ):
        return LIB
    # -ffp-contract=off: the accumulate loops must round mul and add separately
    # (IEEE fp32, matching the NumPy oracle and the GPU's mul.rn/add.rn) — gcc would otherwise fuse
    # a*x+b into FMA and drift under cancellation.
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
        "-shared", "-fPIC", "-o", LIB, SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return LIB


if __name__ == "__main__":
    print(build(force=True))
