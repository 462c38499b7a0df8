"""Build and load the port's hand-written CUDA kernels.

Each source is a ``csrc/<name>.cu`` file with plain C entry points (one
per kernel, ``_SIGNATURES``). At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under the package's ``_build/`` directory (listed in
``.gitignore``), named by a hash of the source and the flags so that an
edited source is rebuilt, and loaded with ``ctypes``. Nothing is built or
loaded at import time: this module imports on machines without a CUDA
toolkit, where only the plain PyTorch versions run (CPU tensors).

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, as
in the plain PyTorch versions the kernels are held against bit for bit;
fast math is never enabled (it lets the compiler assume there is no NaN,
which the sweep's zero-direction reciprocals rely on, and approximate
divisions).

The launch layer of every wrapper lives here too: ``on_cuda`` (the plain
version on CPU tensors, the kernel on CUDA tensors), ``launch`` (a kernel on
the current stream, counted on its wrapper), the registry of wrappers
(``register``, ``wrappers``) whose ``.launches`` counters
``ops/sweeps.launch_counts`` reads, and ``DeviceCounts``, the work counts
that kernels add to on the device (``raymarch_xla.MARCH_COUNTS``,
``sweeps.SWEEP_COUNTS``, ``sweeps.DENSE_COUNTS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Mapping
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--resource-usage")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_MARCH_HEAD = ([_I, _P, _L, _L, _L, _L, _P, _P, _F, _F, _F, _I] + [_P] * 4
               + [_L] * 10)
# entry points: name -> (source csrc/<source>.cu, C symbol, argtypes);
# restype is int: a cudaError_t
_SIGNATURES = {
    "sector_sweep": ("sector_sweep", "sector_sweep_launch",
                     [_P] * 11 + [_I, _I, _I, _P, _I, _P]),
    "list_scan": ("sector_sweep", "list_scan_launch",
                  [_P] * 10 + [_I] * 5 + [_F] * 5 + [_P, _I, _P]),
    "dense_sweep": ("dense_sweep", "dense_sweep_launch",
                    [_P] * 10 + [_I, _I, _P, _I, _P]),
    "edf_march": ("edf_march", "edf_march_launch",
                  _MARCH_HEAD + [_F] * 3 + [_P] * 7),
    "edf_march_grad": ("edf_march", "edf_march_grad_launch",
                       _MARCH_HEAD + [_P] * 9),
    "implicit_pose_vjp": ("edf_march", "implicit_pose_vjp_launch",
                          [_P, _L, _L, _L, _L, _P, _P] + [_F] * 4
                          + [_P, _L, _L] + [_P] * 7 + [_L, _L]
                          + [_P] * 3),
    "general_sweep": ("general_sweep", "general_sweep_launch",
                      [_I, _P, _L, _L, _L] + [_P] * 5 + [_L] * 10
                      + [_P] * 4),
    "soft_edt": ("soft_edt", "soft_edt_launch",
                 [_P] * 4 + [_I] * 4 + [_F] * 2 + [_P]),
    "soft_edt_grad": ("soft_edt", "soft_edt_grad_launch",
                      [_P] * 4 + [_I] * 4 + [_F] * 2 + [_P]),
    # not a launch: the march's persistent grid (blocks of one wave)
    "edf_march_wave": ("edf_march", "edf_march_wave", [_I] * 2),
}

_loaded = {}       # entry point -> ctypes function (process-wide cache)
build_info = {}    # source name -> {"seconds", "log", "path"} of this process
_WRAPPERS = {}     # wrapper name -> wrapper (``register``)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the default toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built at "
        "first use on a machine with the CUDA toolkit")


def build_command(name: str, out: Path, nvcc: str = "nvcc") -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{key[:16]}.so"


def build(*names: str) -> list:
    """Compile ``csrc/<name>.cu`` for each name whose library for this
    source and these flags does not exist yet, one nvcc process per source,
    all started together. Returns the libraries' paths; records each
    compile's time and the compiler's resource report in
    ``build_info[name]``. Waits for every compiler it started before it
    raises on a failure."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)",
                                         "path": str(out)})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(build_command(name, tmp, nvcc_path()),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (out, tmp, time.perf_counter(), proc)
    failed = []
    for name, (out, tmp, t0, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)    # atomic: no process loads a half-written file
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": (stdout + stderr).strip(),
                            "path": str(out)}
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(name) for name in names]


def kernel(name: str):
    """The ctypes entry point ``name``, its source built and loaded on first
    use."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = _SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(build(source)[0])), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def on_cuda(name, ref) -> bool:
    """False for CPU tensors (take the plain version), True for CUDA
    tensors (launch the kernel); any other device raises."""
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    return True


def launch(name, entry, *args):
    """Launch entry point ``entry`` on the current stream of the first
    tensor's device: tensors pass as their data pointers, None as a null
    pointer, numbers as they are. ``name``, a registered wrapper, labels a
    failure and counts the launch on its ``.launches``."""
    device = next(a.device for a in args if torch.is_tensor(a))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(entry)(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
    _WRAPPERS[name].launches += 1


class DeviceCounts(Mapping):
    """Work counts by name (``columns``): the plain versions' counts on the
    host (``host``) plus one int64 counter per device that the kernels add
    to, replayed CUDA graphs included, read at each lookup (an exact read:
    a synchronisation on the card). A counter is ``(len(columns),)``, or
    ``(lanes, len(columns))`` where a kernel spreads its adds over
    ``lanes`` rows, summed on read."""

    def __init__(self, columns, lanes=None):
        self.columns = tuple(columns)
        self.lanes = lanes
        self.host = dict.fromkeys(self.columns, 0)
        self.device: dict = {}   # device -> its int64 counter

    def counter(self, device) -> torch.Tensor:
        """The kernels' counter on ``device``, made zero at its first use,
        which must come before any capture that launches them: a counter
        made inside a capture would be the graph's memory, and zeroed at
        each replay."""
        c = self.device.get(device)
        if c is None:
            if (torch.device(device).type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "a kernel's work counter is made at its first eager "
                    "launch; run it once before capturing a CUDA graph")
            n = len(self.columns)
            c = self.device[device] = torch.zeros(
                (n,) if self.lanes is None else (self.lanes, n),
                dtype=torch.int64, device=device)
        return c

    def __getitem__(self, key):
        col = self.columns.index(key)
        return self.host[key] + sum(int(c[..., col].sum())
                                    for c in self.device.values())

    def __iter__(self):
        return iter(self.host)

    def __len__(self):
        return len(self.host)


def register(wrapper, name=None):
    """Add ``wrapper`` to the wrappers that ``wrappers()`` lists, under
    ``name`` (default: the function's name), with a ``.launches`` counter
    at 0 that ``launch`` advances."""
    wrapper.launches = 0
    _WRAPPERS[name or wrapper.__name__] = wrapper
    return wrapper


def wrappers() -> dict:
    """Every registered wrapper by name: the sweeps' (``ops/sweeps.py``),
    the march's (``ops/raymarch_xla.py``), the implicit march's pose VJP
    (``ops/raymarch_diff.py``), the general sweep's
    (``ops/raycast_general.py``) and the chamfer stencil's
    (``ops/soft_edt.py``), once their modules are imported."""
    return dict(_WRAPPERS)
