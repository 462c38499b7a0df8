"""``ScanParams.use_theta_table`` in the port, the counterpart of
tests/test_scan_modes.py: the bucket quantization against the JAX function
(tested here), and the checks the port's backend tests share
(``check_*``, called from tests/test_torch_segments.py,
test_torch_sectors.py and test_torch_contours.py with their backend): the
two theta-table checks of tests/test_scan_modes.py and the comparison with
the JAX scan of the same backend.

Every check builds the backend through ``build_sim`` and scans through
``make_scan_fn`` with ``ScanParams(use_theta_table=True,
theta_discretization=2000)``, the way a user turns the mode on.

Tolerances: handed the same summed angles, ``quantize_angles`` equals the
JAX function bit for bit. A free-running scan adds heading and beam offset
itself; the port's offsets differ from XLA's by an ulp on some beams
(ROADMAP.md fault 3.1), which can move a beam that sits on a bucket's edge
into the neighbouring bucket, so the scans are held to 1e-4 m on at least
99.5% of the beams, as every free-running scan is.
"""

import numpy as np
import torch

import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu.config import ScanParams as JScanParams
from pyracecarsimulator_tpu.maps.loader import sample_free_poses
from pyracecarsimulator_tpu.ops.common import quantize_angles as jax_quantize

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.ops.common import (beam_angles,
                                                     quantize_angles)
from pyracecarsimulator_tpu_torch.oracle import raycast as orc

DISC = 2000
BUCKET = 2 * np.pi / DISC


def port_track(track):
    return TrackMap.from_numpy(
        np.asarray(track.occupancy), np.asarray(track.edf),
        resolution=track.resolution, origin_x=track.origin_x,
        origin_y=track.origin_y, height=track.height, width=track.width,
        name=track.name, device="cpu")


def _port_scan(track, backend, num_beams):
    bundle = psim.build_sim(
        port_track(track), backend=backend, device="cpu",
        scan=P.ScanParams(num_beams=num_beams, use_theta_table=True,
                          theta_discretization=DISC))
    scan = psim.make_scan_fn(bundle)
    return lambda poses: scan(torch.as_tensor(
        np.asarray(poses, np.float32))).numpy()


def test_quantize_angles_equals_jax_bit_for_bit():
    """The same summed float32 angles through both ``quantize_angles``."""
    rng = np.random.RandomState(3)
    theta = rng.uniform(-4 * np.pi, 4 * np.pi, 64).astype(np.float32)
    offs = beam_angles(1080, 4.712388980384690, "cpu").numpy()
    ang = theta[:, None] + offs[None, :]
    got = quantize_angles(torch.from_numpy(ang), DISC)
    ref = jax_quantize(jnp.asarray(ang), DISC)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # off: the identity, on both sides
    np.testing.assert_array_equal(
        quantize_angles(torch.from_numpy(ang), 0).numpy(), ang)


def check_one_bucket(track, backend):
    """Headings within one bucket give identical scans, a whole bucket
    further on a different one (tests/test_scan_modes.py:20-37)."""
    scan = _port_scan(track, backend, 64)
    th0 = 0.37
    r1 = scan([0.0, -3.5, th0])
    r2 = scan([0.0, -3.5, th0 + 1e-4 * BUCKET])
    r3 = scan([0.0, -3.5, th0 + 1.0 * BUCKET])
    np.testing.assert_array_equal(r1, r2)
    assert not np.array_equal(r1, r3)


def check_oracle_buckets(track, backend):
    """The quantized directions are the oracle's bucket table: 90% of the
    beams within 2 cells of its march (tests/test_scan_modes.py:40-54)."""
    pose = (0.2, -3.4, 1.234)
    r = _port_scan(track, backend, 90)(pose)
    r_orc = orc.scan(np.asarray(track.edf), track.resolution,
                     (track.origin_x, track.origin_y), pose, num_beams=90,
                     theta_discretization=DISC,
                     bounds_hw=(track.height, track.width))
    assert np.quantile(np.abs(r - r_orc), 0.9) < 2 * track.resolution


def check_against_jax(track, backend, num_beams=270, agents=24):
    """The port's theta-table scan against the JAX scan of the same
    backend on the same poses."""
    poses = sample_free_poses(track, agents, 11, margin=0.2)
    jb = jsim.build_sim(track, backend=backend, scan=JScanParams(
        num_beams=num_beams, use_theta_table=True,
        theta_discretization=DISC))
    ref = np.asarray(jsim.make_scan_fn(jb)(jnp.asarray(poses)))
    got = _port_scan(track, backend, num_beams)(poses)
    assert got.shape == ref.shape == (agents, num_beams)
    d = np.abs(got - ref)
    assert np.mean(d <= 1e-4) >= 0.995, (np.mean(d <= 1e-4), d.max())
    # the mode is on: the exact-fan scan differs
    exact = psim.make_scan_fn(psim.build_sim(
        port_track(track), backend=backend, device="cpu",
        scan=P.ScanParams(num_beams=num_beams)))(
            torch.as_tensor(poses)).numpy()
    assert not np.array_equal(exact, got)
