"""PyTorch port of config, state, dynamics and TTC against the JAX package.

States and actions are made with numpy from a seed and handed to both
packages. Tolerance rtol=1e-5, atol=1e-6: the same float32 operations in
the same order, but the transcendental functions (cos, sin, tan, atan) of
torch and XLA differ by an ulp on some inputs. check_ttc flags are
compared exactly on identical inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu import config as jcfg
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.models import dynamics as jdyn
from pyracecarsimulator_tpu.models import ttc as jttc

from pyracecarsimulator_tpu_torch import config as pcfg
from pyracecarsimulator_tpu_torch import state as pstate
from pyracecarsimulator_tpu_torch.models import dynamics as pdyn
from pyracecarsimulator_tpu_torch.models import ttc as pttc
from pyracecarsimulator_tpu_torch.ops.common import beam_angles

TOL = dict(rtol=1e-5, atol=1e-6)
CAR_J, CAR_P = jcfg.CarParams(), pcfg.CarParams()
N = 256


def _random_state(rng, n=N):
    """Speeds straddle v_switch and zero, so both ST branches, the
    standstill guard and both accel clamps are exercised; a third of the
    cars are latched."""
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    d = dict(x=f(-5, 5), y=f(-5, 5), theta=f(-np.pi, np.pi),
             velocity=np.concatenate([f(-2, 7)[: n - 8],
                                      np.zeros(4, np.float32),
                                      np.full(4, 0.5e-3, np.float32)]),
             steer_angle=f(-0.4, 0.4), angular_velocity=f(-2, 2),
             slip_angle=f(-0.2, 0.2), st_dyn=rng.rand(n) < 0.5,
             collision=rng.rand(n) < 0.33)
    return d


def _pair(d):
    j = jstate.CarState(**{k: jnp.asarray(v) for k, v in d.items()})
    return j, pstate.state_from_numpy(d, device="cpu")


def _actions(rng, n=N):
    return (rng.uniform(-9, 9, n).astype(np.float32),
            rng.uniform(-0.6, 0.6, n).astype(np.float32))


def _close_states(p, j):
    for k, v in p.numpy().items():
        ref = np.asarray(getattr(j, k))
        if v.dtype == bool:
            np.testing.assert_array_equal(v, ref, err_msg=k)
        else:
            np.testing.assert_allclose(v, ref, err_msg=k, **TOL)


def test_params_match_jax():
    for jc, pc in ((jcfg.CarParams, pcfg.CarParams),
                   (jcfg.ScanParams, pcfg.ScanParams),
                   (jcfg.SimParams, pcfg.SimParams)):
        assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())
    assert pcfg.STATIC_SCAN_FIELDS == jcfg.STATIC_SCAN_FIELDS
    assert pcfg.STATIC_SIM_FIELDS == jcfg.STATIC_SIM_FIELDS
    assert pcfg.replace(CAR_P, mass=4.0).mass == 4.0
    with pytest.raises(ValueError, match="steer_mode"):
        pcfg.SimParams(steer_mode="smoth")


def test_state_helpers():
    z = pstate.zero_state((2, 3), device="cpu")
    assert z.batch_shape == (2, 3) and z.collision.dtype == torch.bool
    s = pstate.state_from_pose(torch.ones(4), 2.0, 0.5)
    assert s.pose.shape == (4, 3)
    np.testing.assert_array_equal(s.pose[:, 1].numpy(), np.full(4, 2.0))
    js = jstate.state_from_pose(jnp.ones(4), 2.0, 0.5)
    _close_states(s, js)
    s2 = pstate.set_field(s, velocity=torch.full((4,), 3.0))
    assert float(s2.velocity[0]) == 3.0 and float(s.velocity[0]) == 0.0


@pytest.mark.parametrize("mode", ["bang", "smooth"])
def test_process_input(rng, mode):
    d = _random_state(rng)
    js, ps = _pair(d)
    v, s = _actions(rng)
    ja, jsv = jdyn.process_input(jnp.asarray(v), jnp.asarray(s), js, CAR_J,
                                 steer_mode=mode)
    pa, psv = pdyn.process_input(torch.from_numpy(v), torch.from_numpy(s),
                                 ps, CAR_P, steer_mode=mode)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(psv.numpy(), np.asarray(jsv), **TOL)
    with pytest.raises(ValueError, match="steer_mode"):
        pdyn.compute_steer_vel(torch.from_numpy(s), ps.steer_angle, CAR_P,
                               mode="bangbang")


@pytest.mark.parametrize("model", ["st", "ks", "ackermann"])
@pytest.mark.parametrize("mode", ["bang", "smooth"])
def test_steps_match_jax(rng, model, mode):
    """process_input -> step -> apply_standstill, three steps in a row."""
    js, ps = _pair(_random_state(rng))
    for _ in range(3):
        v, s = _actions(rng)
        jv, jsd = jnp.asarray(v), jnp.asarray(s)
        pv, psd = torch.from_numpy(v), torch.from_numpy(s)
        if model == "ackermann":
            jn = jdyn.ackermann_step(js, jv, jsd, CAR_J, 0.01)
            pn = pdyn.ackermann_step(ps, pv, psd, CAR_P, 0.01)
        else:
            ja, jsv = jdyn.process_input(jv, jsd, js, CAR_J, steer_mode=mode)
            pa, psv = pdyn.process_input(pv, psd, ps, CAR_P, steer_mode=mode)
            jf = jdyn.st_step if model == "st" else jdyn.ks_step
            pf = pdyn.st_step if model == "st" else pdyn.ks_step
            jn, pn = jf(js, ja, jsv, CAR_J, 0.01), pf(ps, pa, psv, CAR_P,
                                                      0.01)
        js = jdyn.apply_standstill(js, jn)
        ps = pdyn.apply_standstill(ps, pn)
        _close_states(ps, js)
        # hand the reference state over so ulp drift does not compound
        ps = pstate.state_from_numpy(
            {k: np.asarray(getattr(js, k)) for k in pstate.FIELDS}, device="cpu")


def test_ttc_tables_match_jax():
    for nb in (1080, 64):
        jc, jd = jttc.ttc_tables(nb, 4.712388980384690, CAR_J)
        pc, pd = pttc.ttc_tables(nb, 4.712388980384690, CAR_P, device="cpu")
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    offs = beam_angles(1080, 4.712388980384690, device="cpu").numpy()
    assert offs.dtype == np.float32
    assert offs[0] == np.float32(-4.712388980384690 / 2)
    assert offs[-1] == np.float32(4.712388980384690 / 2)
    assert np.all(np.diff(offs) > 0)


def test_check_ttc_flags_identical(rng):
    """Identical ranges, speeds and tables give identical flags; ranges are
    drawn near the car so that a good share of the flags trip."""
    jc, jd = jttc.ttc_tables(1080, 4.712388980384690, CAR_J)
    cos, dist = np.array(jc), np.array(jd)
    ranges = (dist[None, :] + rng.uniform(-0.01, 0.2, (N, 1080))
              ).astype(np.float32)
    vel = rng.uniform(-1, 7, N).astype(np.float32)
    for thr in (0.01, 0.05):
        ref = np.asarray(jttc.check_ttc(jnp.asarray(ranges),
                                        jnp.asarray(vel), jc, jd, thr))
        got = pttc.check_ttc(torch.from_numpy(ranges),
                             torch.from_numpy(vel), torch.from_numpy(cos),
                             torch.from_numpy(dist), thr).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0 < ref.mean() < 1


def _jax_advance(js, v, s, model, mode):
    """The JAX step's input processing, update, standstill and lidar origin
    (``pyracecarsimulator_tpu/simulator.py`` ``_step``)."""
    ja, jsv = jdyn.process_input(v, s, js, CAR_J, steer_mode=mode)
    jf = jdyn.st_step if model == "st" else jdyn.ks_step
    jn = jdyn.apply_standstill(js, jf(js, ja, jsv, CAR_J, 0.01))
    d = CAR_J.scan_distance_to_base_link
    return jn, jn.x + d * jnp.cos(jn.theta), jn.y + d * jnp.sin(jn.theta)


@pytest.mark.parametrize("model", ["st", "ks"])
@pytest.mark.parametrize("mode", ["bang", "smooth"])
def test_car_step_plain_matches_jax(rng, model, mode):
    """``models/car_step.car_step_plain``, the car-step kernel's plain twin,
    against the JAX step's chain, three steps in a row; the lidar origin
    too."""
    from pyracecarsimulator_tpu_torch.models import car_step
    js, ps = _pair(_random_state(rng))
    sim = pcfg.SimParams(dynamics=model, steer_mode=mode)
    for _ in range(3):
        v, s = _actions(rng)
        jn, jx, jy = _jax_advance(js, jnp.asarray(v), jnp.asarray(s), model,
                                  mode)
        pn, px, py = car_step.car_step_plain(ps, torch.from_numpy(v),
                                             torch.from_numpy(s), CAR_P, sim)
        _close_states(pn, jn)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
        js = jn
        ps = pstate.state_from_numpy(
            {k: np.asarray(getattr(js, k)) for k in pstate.FIELDS}, device="cpu")
