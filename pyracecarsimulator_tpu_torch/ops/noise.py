"""Scan post-processing: Gaussian range noise (reference noise model,
``ranges[i] = total + N(0, scan_std_dev)``).

Counterpart of ``pyracecarsimulator_tpu/ops/noise.py``; the JAX key becomes
an explicit ``torch.Generator`` on the ranges' device, so rollouts stay
deterministic for a seed. The numbers differ from ``jax.random``'s.

Under a CUDA graph (``utils/graph.py``) the generator handed to the step
is registered with the graph (``CUDAGraph.register_generator_state``):
the captured ``torch.randn`` reads its Philox seed and offset from device
memory, each replay starts at the generator's current offset and advances
it by what the eager call would have consumed, so a graphed rollout draws
the eager rollout's numbers from the same seed and no replay repeats a
draw.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span


def add_scan_noise(ranges, generator, std_dev, max_range=None):
    """Add N(0, std) per beam, UNCLAMPED by default (the reference adds
    noise after the range clamp, so noisy returns may exceed max_range or
    dip below zero). Pass ``max_range`` to re-clamp to [0, max_range].

    ``std_dev == 0`` or ``generator is None`` returns the input unchanged
    (noiseless parity mode).
    """
    if (isinstance(std_dev, (int, float)) and std_dev == 0.0) \
            or generator is None:
        return ranges
    with span("step.noise"):
        noise = torch.randn(ranges.shape, generator=generator,
                            dtype=ranges.dtype, device=ranges.device)
        noisy = ranges + std_dev * noise
        if max_range is not None:
            noisy = torch.clamp(noisy, 0.0, max_range)
    return noisy
