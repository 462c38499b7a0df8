"""pyracecarsimulator_tpu_torch: the PyTorch / CUDA port of
pyracecarsimulator_tpu.

The closed-loop racecar step — input processing, single-track dynamics,
a 1080-beam lidar scan on the dense "segments" backend (the default) or
the sector backend, range noise and the TTC latch — on PyTorch tensors for
any agent batch, and BPTT training through it (``parallel.train``). The
scan's sweeps and the EDF march run in hand-written CUDA kernels for
Hopper (``csrc/sector_sweep.cu``, ``csrc/dense_sweep.cu``,
``csrc/edf_march.cu``) on CUDA tensors and in plain PyTorch on CPU
tensors; the sweeps' backward is closed form. Module layout
and public names follow the JAX package, which stays the reference the
port is tested against. This package imports neither JAX nor the JAX
package.
"""

from .config import CarParams, ScanParams, SimParams
from .state import CarState, zero_state, state_from_pose, state_from_numpy
from .simulator import (RacecarSimulator, build_sim, make_step_fn,
                        make_scan_fn, StepOutput)

__version__ = "0.1.0"
