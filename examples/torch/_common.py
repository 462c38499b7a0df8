"""What the PyTorch demos in this directory share: the ``--device``
argument, map loading by name or path, and open-space start poses."""

import numpy as np


def add_device_arg(ap):
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card (default: the card)")


def load_track(name, device):
    """A bundled map by name ('levine', 'berlin') or a ROS map YAML by
    path, on ``device`` (``None``: the card)."""
    from pyracecarsimulator_tpu_torch.maps import load_builtin, load_map_yaml
    if name.endswith((".yaml", ".yml")):
        return load_map_yaml(name, device=device)
    return load_builtin(name, device=device)


def most_open_pose(track, theta=0.0):
    """(x, y, theta) at the cell farthest from every obstacle."""
    edf = track.edf.cpu().numpy()[: track.height, : track.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    return (track.origin_x + (ix + 0.5) * track.resolution,
            track.origin_y + (iy + 0.5) * track.resolution, theta)


def sync_fn(device):
    """``torch.cuda.synchronize`` for a card, a no-op for the CPU."""
    import torch
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def launches_since(before):
    """The kernel launches since ``before`` (a ``sweeps.launch_counts()``),
    by wrapper, the wrappers that launched nothing left out."""
    from pyracecarsimulator_tpu_torch.ops import sweeps
    return {k: n - before[k] for k, n in sweeps.launch_counts().items()
            if n != before[k]}
