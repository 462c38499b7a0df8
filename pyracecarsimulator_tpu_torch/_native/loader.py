"""Build and load the native host library (``csrc/racecar_native.cpp``).

Counterpart of ``pyracecarsimulator_tpu/_native/loader.py``: the same
seven functions over the same five C-ABI entry points, loaded with ctypes.
The library is host C++ for map compile (the EDT, segment extraction, the
sector-cull membership) and the CPU oracle raycasters; its callers are
``maps/edt.edt``, ``maps/sectors._membership`` and
``oracle/raycast.scan_batch``.

At first use the source is compiled with the C++ compiler on ``PATH``
(``$CXX``, else ``g++``) into the package's ``_build/`` directory, beside
the CUDA kernels and named like them by a hash of the source and the flags
(``ops/_kernels.py``). There is no ``-march=native``: a library built on
one host of a shared file system must load on another; and
``-ffp-contract=off`` keeps the arithmetic the same on hosts whose
compilers would fuse a multiply and an add. Force a build with ``python -m
pyracecarsimulator_tpu_torch._native.loader --build``.

``_load`` alone decides which body runs:

- no C++ compiler on ``PATH``: ``available()`` is ``False``, every function
  here returns ``None`` and the callers run their NumPy bodies;
- a compiler is there and the build or the load fails: ``RuntimeError``
  with the compiler's output. A library that should have built is never
  replaced by the NumPy body in silence.

Every function counts the calls that the library served in
``<function>.calls`` (as ``ops/sweeps.py`` counts kernel launches), so
that a run can show which body did the work. ``numpy_only()`` switches the
library off for a ``with`` block, to time or test the NumPy bodies.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "racecar_native.cpp"
BUILD_DIR = _PKG / "_build"

CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_disabled = False
build_info = {}    # {"seconds", "log", "path"} of this process's build


def compiler() -> Optional[list]:
    """The C++ compiler's command (``$CXX``, else ``g++``) with its program
    resolved on ``PATH``, or ``None`` where there is none."""
    words = shlex.split(os.environ.get("CXX") or "g++")
    prog = shutil.which(words[0]) if words else None
    return [prog, *words[1:]] if prog else None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"racecar_native_{key[:16]}.so"


def build(verbose: bool = False) -> bool:
    """Compile the library for this source and these flags unless it
    exists. Returns ``False`` where there is no compiler; raises
    ``RuntimeError`` with the compiler's output when the compile fails."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "(cached)")
        build_info["path"] = str(out)
        return True
    cxx = compiler()
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).strip()
    if verbose:
        print(" ".join(cmd))
        if log:
            print(log)
    if proc.returncode != 0 or not tmp.exists():
        raise RuntimeError(
            f"the C++ compiler failed to build {SOURCE.name} "
            f"(exit code {proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)    # atomic: no process loads a half-written file
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _disabled:
        return None
    if _lib is not None:
        return _lib
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:
        raise RuntimeError(
            f"the native library {library_path()} was built but does not "
            f"load: {e}") from e

    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i, d = ctypes.c_int, ctypes.c_double

    lib.rc_edt.argtypes = [u8, i, i, f32]
    lib.rc_edt.restype = None
    lib.rc_trace_rays.argtypes = [f32, i, i, i, i, d, d, d,
                                  f64, f64, f64, f64, i, d, d, i, f64]
    lib.rc_trace_rays.restype = None
    lib.rc_raycast_segments.argtypes = [f64, i, f64, f64, f64, f64, i, d,
                                        f64]
    lib.rc_raycast_segments.restype = None
    lib.rc_extract_segments.argtypes = [u8, i, i, f64, i]
    lib.rc_extract_segments.restype = i
    lib.rc_sector_membership.argtypes = [f64, i, i, i, i, d, d, d, d, d, d,
                                         u8]
    lib.rc_sector_membership.restype = i
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library serves the calls (built and loaded now if it was
    not yet). Raises like ``build`` when a compiler is there and fails."""
    return _load() is not None


@contextlib.contextmanager
def numpy_only():
    """Within the block every function here returns ``None``, so the
    callers run their NumPy bodies."""
    global _disabled
    saved, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = saved


def _segments(segs) -> np.ndarray:
    s = np.ascontiguousarray(segs, np.float64)
    if s.ndim != 2 or s.shape[1] != 4:
        raise ValueError(f"segments must be (K, 4), got {s.shape}")
    return s


def _rays(xs, ys, cts, sts):
    xs = np.ascontiguousarray(xs, np.float64)
    if xs.ndim != 1:
        raise ValueError(f"rays must be flat (N,), got {xs.shape}")
    same = lambda a: np.ascontiguousarray(
        np.broadcast_to(np.asarray(a, np.float64), xs.shape))
    return xs, same(ys), same(cts), same(sts)


def edt(occupied: np.ndarray) -> Optional[np.ndarray]:
    """Exact EDT in cell units, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occupied, np.uint8)
    if occ.ndim != 2:
        raise ValueError(f"occupied must be (H, W), got {occ.shape}")
    h, w = occ.shape
    out = np.empty((h, w), np.float32)
    lib.rc_edt(occ, h, w, out)
    edt.calls += 1
    return out


def trace_rays(edf: np.ndarray, bounds_hw, resolution, origin_xy,
               xs, ys, cts, sts, max_range=10.0, eps=1e-4,
               max_iters=2000) -> Optional[np.ndarray]:
    """Batch CPU oracle DT march (reference semantics)."""
    lib = _load()
    if lib is None:
        return None
    e = np.ascontiguousarray(edf, np.float32)
    h, w = e.shape[-2:]
    bh, bw = bounds_hw
    if e.ndim != 2 or not (0 <= bh <= h and 0 <= bw <= w):
        raise ValueError(f"bounds_hw {tuple(bounds_hw)} must lie inside "
                         f"the (H, W) EDF, got {e.shape}")
    xs, ys, cts, sts = _rays(xs, ys, cts, sts)
    out = np.empty(len(xs), np.float64)
    lib.rc_trace_rays(e, h, w, bh, bw, float(resolution),
                      float(origin_xy[0]), float(origin_xy[1]),
                      xs, ys, cts, sts, len(xs),
                      float(max_range), float(eps), int(max_iters), out)
    trace_rays.calls += 1
    return out


def raycast_segments(segs: np.ndarray, xs, ys, cts, sts,
                     max_range=10.0) -> Optional[np.ndarray]:
    """Exact float64 first-hit ranges over (K, 4) segments
    (``maps/segments.raycast_segments_numpy``'s function)."""
    lib = _load()
    if lib is None:
        return None
    s = _segments(segs)
    xs, ys, cts, sts = _rays(xs, ys, cts, sts)
    out = np.empty(len(xs), np.float64)
    lib.rc_raycast_segments(s, len(s), xs, ys, cts, sts, len(xs),
                            float(max_range), out)
    raycast_segments.calls += 1
    return out


def sector_membership(segs: np.ndarray, nr: int, nc: int, ns: int,
                      tile_size: float, ox: float, oy: float, rt: float,
                      reach: float,
                      block_half: float) -> Optional[np.ndarray]:
    """(nr*nc*ns, K) bool cull membership (``maps/sectors._membership``'s
    function, in float64), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = _segments(segs)
    k = len(s)
    out = np.empty((nr * nc * ns, k), np.uint8)
    rc = lib.rc_sector_membership(s, k, nr, nc, ns, float(tile_size),
                                  float(ox), float(oy), float(rt),
                                  float(reach), float(block_half), out)
    if rc != 0:
        raise RuntimeError(f"rc_sector_membership returned {rc}")
    sector_membership.calls += 1
    return out.view(bool)


def extract_segments(occ: np.ndarray) -> Optional[np.ndarray]:
    """Boundary segments in grid units, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    o = np.ascontiguousarray(occ, np.uint8)
    if o.ndim != 2:
        raise ValueError(f"occ must be (H, W), got {o.shape}")
    h, w = o.shape
    cap = 16 + 4 * (h * w // 2 + h + w)
    out = np.empty((cap, 4), np.float64)
    n = lib.rc_extract_segments(o, h, w, out, cap)
    if n < 0:
        raise RuntimeError(
            f"rc_extract_segments needs more than {cap} segments")
    extract_segments.calls += 1
    return out[:n].copy()


ENTRY_POINTS = (edt, trace_rays, raycast_segments, sector_membership,
                extract_segments)
for _fn in ENTRY_POINTS:
    _fn.calls = 0


def call_counts() -> dict:
    """``{function name: calls the library served}``."""
    return {fn.__name__: fn.calls for fn in ENTRY_POINTS}


def reset_call_counts() -> None:
    for fn in ENTRY_POINTS:
        fn.calls = 0


if __name__ == "__main__":
    import sys
    if "--build" in sys.argv:
        ok = build(verbose=True)
        print("build:", f"ok ({library_path()})" if ok
              else "no C++ compiler on PATH ($CXX, else g++)")
        sys.exit(0 if ok else 1)
    print("available:", available())
