"""The car step as one CUDA kernel (``models/car_step.py``,
``csrc/car_step.cu``): its route, its wrapper and, on the card, the kernel.

On the CPU: ``simulator.advance`` takes ``car_step.car_step`` only for a
step that ``fused_step`` admits, and on CPU tensors that wrapper runs the
plain twin ``car_step_plain``; gradients, float64, tensor parameters and
"ackermann" keep the plain composition ``compose`` and never reach the
wrapper. The CUDA route is checked through a recording stand-in for the
launch (arguments, strides of broadcast commands, the constants in the
order of the source's ``struct Consts``). ``counters()["car"]`` counts the
car-steps that took the wrapper: all of an eager rollout's; of a BPTT
call's, step 0's where the policy's t = 0 command takes no gradient, and
none where it does.

On the card (marker ``cuda``; they skip without one, decided in a
fixture):

    python -m pytest --noconftest -m cuda tests/test_torch_car_step.py -q

the kernel equals ``car_step_plain`` on the card bit for bit (a NaN where
the plain version has one) for the single-track and kinematic models under
"bang" and "smooth" steering: speeds below, at and above 1e-3 and either
side of and at ``v_switch``, steering errors inside, at and outside the
1e-4 dead zone, clamped and NaN commands, latched and free cars, and
scalar, broadcast and per-car commands; a graphed rollout equals the eager
plain one bit for bit and counts agents x steps on the device counter; a
captured BPTT train step runs its step 0 on the kernel, counted, with the
plain composition's losses and parameters.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.models import car_step
from pyracecarsimulator_tpu_torch.ops import _kernels
from pyracecarsimulator_tpu_torch.state import CarState
from pyracecarsimulator_tpu_torch.utils import profiling

N = 4096
FIELDS = car_step._FLOAT_FIELDS + ("st_dyn", "collision")
MODELS = [("st", "bang"), ("st", "smooth"), ("ks", "bang"),
          ("ks", "smooth")]


def _inputs(n, device="cpu", seed=0):
    """A state and per-car commands that reach every branch: speeds at and
    near 0, +-1e-3 and +-v_switch (0.8) among random ones, steering errors
    of 0, +-1e-4, 5e-5 and +-2e-4, commands beyond the clamps and NaN, a
    third of the cars latched."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    v = f(-3, 8)
    k = n // 16
    vsw = np.float32(0.8)
    v[:k] = rng.choice(np.float32([
        0, 1e-3, -1e-3, 5e-4, -5e-4, np.nextafter(np.float32(1e-3), 0),
        vsw, -vsw, np.nextafter(vsw, 1), np.nextafter(vsw, 0)]), k)
    st = f(-0.45, 0.45)
    vd, sd = f(-10, 10), f(-0.7, 0.7)
    m = n // 8
    sd[k:k + m] = st[k:k + m] + rng.choice(
        np.float32([0, 1e-4, -1e-4, 5e-5, 2e-4, -2e-4]), m)
    vd[k + m:k + 2 * m] = rng.choice(np.float32([np.nan, 7, -7, 20, -20, 0]),
                                     m)
    sd[k + 2 * m:k + 3 * m] = rng.choice(
        np.float32([np.nan, 0.4189, -0.4189, 1, -1]), m)
    d = dict(x=f(-5, 5), y=f(-5, 5), theta=f(-4, 4), velocity=v,
             steer_angle=st, angular_velocity=f(-3, 3),
             slip_angle=f(-0.3, 0.3), st_dyn=rng.rand(n) < 0.5,
             collision=rng.rand(n) < 0.3)
    t = lambda a: torch.from_numpy(a).to(device)
    return (CarState(**{key: t(a) for key, a in d.items()}), t(vd), t(sd))


def _commands(kind, vd, sd):
    """Per-car commands, one (1,) command broadcast to every car, a 0-dim
    one, or a 0-dim one expanded to the batch (``make_constant_policy``'s
    view, every stride 0)."""
    if kind == "per_car":
        return vd, sd
    if kind == "broadcast":
        return vd[:1], sd[:1]
    if kind == "scalar":
        return vd[0], sd[0]
    return vd[0].expand(vd.shape), sd[0].expand(sd.shape)


def _same(got, want):
    """Bit for bit, a NaN where the other has one."""
    for a, b in zip(got, want):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
            continue
        nan = a.isnan()
        assert torch.equal(nan, b.isnan())
        assert torch.equal(a[~nan].view(torch.int32),
                           b[~nan].view(torch.int32))


def _flat(out):
    new, sx, sy = out
    return [getattr(new, f) for f in FIELDS] + [sx, sy]


# -- the route, on the CPU -------------------------------------------------

def _refuse(*a, **kw):
    raise AssertionError("the car-step wrapper was reached")


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    """CPU tensors: ``advance`` takes the wrapper, which runs the plain twin
    (no launch), equal to ``compose`` and counted on the host."""
    monkeypatch.setattr(_kernels, "launch", _refuse)
    state, vd, sd = _inputs(64)
    for model, mode in MODELS:
        sim = P.SimParams(dynamics=model, steer_mode=mode)
        launches = car_step.car_step.launches
        before = car_step.CAR_COUNTS["steps"]
        got = psim.advance(state, (vd, sd), P.CarParams(), sim)
        assert car_step.CAR_COUNTS["steps"] - before == 64
        assert car_step.car_step.launches == launches
        _same(_flat(got), _flat(car_step.compose(state, vd, sd,
                                                 P.CarParams(), sim)))


def _plain_case(case):
    """(state, commands, car, sim) of a step the wrapper must not take."""
    state, vd, sd = _inputs(32)
    car, sim = P.CarParams(), P.SimParams()
    if case == "grad":
        vd = vd.clone().requires_grad_(True)
    elif case == "float64":
        state = CarState(**{f: (getattr(state, f).double()
                                if f in car_step._FLOAT_FIELDS
                                else getattr(state, f))
                            for f in FIELDS})
        vd, sd = vd.double(), sd.double()
    elif case == "tensor_param":
        car = P.CarParams(mass=torch.tensor(3.47))
    elif case == "tensor_gain":
        sim = P.SimParams(speed_kp=torch.tensor(2.0))
    elif case == "ackermann":
        sim = P.SimParams(dynamics="ackermann")
    return state, (vd, sd), car, sim


@pytest.mark.parametrize("case", ["grad", "float64", "tensor_param",
                                  "tensor_gain", "ackermann"])
def test_other_steps_keep_the_plain_composition(monkeypatch, case):
    """Gradients, float64, a tensor car parameter or gain and "ackermann"
    run ``compose`` itself: the wrapper is never reached, nothing is
    counted, and the values (and a gradient) are the composition's."""
    monkeypatch.setattr(car_step, "car_step", _refuse)
    state, action, car, sim = _plain_case(case)
    assert not car_step.fused_step(state, *action, car, sim)
    before = car_step.CAR_COUNTS["steps"]
    got = psim.advance(state, action, car, sim)
    assert car_step.CAR_COUNTS["steps"] == before
    want = car_step.compose(state, *action, car, sim)
    _same([t.detach() for t in _flat(got)],
          [t.detach() for t in _flat(want)])
    if case == "grad":
        vd = action[0]
        (g,) = torch.autograd.grad(got[0].velocity.sum(), vd)
        (h,) = torch.autograd.grad(want[0].velocity.sum(), vd)
        _same([g], [h])
        assert bool(g.abs().nansum() > 0)


def _variant(change):
    """(state, v_des, steer_des, car, sim) with one change from an admitted
    step."""
    state, vd, sd = _inputs(16)
    car, sim = P.CarParams(), P.SimParams()
    if change == "velocity requires grad":
        state = CarState(**{**{f: getattr(state, f) for f in FIELDS},
                            "velocity": state.velocity.clone()
                            .requires_grad_(True)})
    elif change == "float64 command":
        sd = sd.double()
    elif change == "float collision":
        state = CarState(**{**{f: getattr(state, f) for f in FIELDS},
                            "collision": state.collision.float()})
    elif change == "a field of another shape":
        state = CarState(**{**{f: getattr(state, f) for f in FIELDS},
                            "slip_angle": state.slip_angle[:1]})
    elif change == "a command wider than the state":
        vd = torch.zeros(2, 16)
    elif change == "a number command":
        vd = 1.0
    elif change == "a tensor v_switch":
        car = P.CarParams(v_switch=torch.tensor(0.8))
    elif change == "a tensor wheelbase (ks)":
        car = P.CarParams(wheelbase=torch.tensor(0.3302))
        sim = P.SimParams(dynamics="ks")
    elif change == "a tensor wheelbase (st, unread)":
        car = P.CarParams(wheelbase=torch.tensor(0.3302))
    elif change == "a tensor steer_kp (bang, unread)":
        sim = P.SimParams(steer_kp=torch.tensor(1.0))
    elif change == "a tensor steer_kp (smooth)":
        sim = P.SimParams(steer_kp=torch.tensor(1.0), steer_mode="smooth")
    elif change == "meta tensors":
        state = CarState(**{f: getattr(state, f).to("meta") for f in FIELDS})
        vd, sd = vd.to("meta"), sd.to("meta")
    return state, vd, sd, car, sim


@pytest.mark.parametrize("change, admitted", [
    ("none", True), ("velocity requires grad", False),
    ("float64 command", False), ("float collision", False),
    ("a field of another shape", False),
    ("a command wider than the state", False), ("a number command", False),
    ("a tensor v_switch", False), ("a tensor wheelbase (ks)", False),
    ("a tensor wheelbase (st, unread)", True),
    ("a tensor steer_kp (bang, unread)", True),
    ("a tensor steer_kp (smooth)", False), ("meta tensors", False)])
def test_fused_step_reads_only_the_input(change, admitted):
    """``fused_step`` decides from the input alone: dtypes, shapes, device,
    gradient, and the parameters the kernel reads being numbers."""
    assert car_step.fused_step(*_variant(change)) is admitted


def test_inputs_that_require_grad_take_the_wrapper_under_no_grad():
    state, vd, sd = _inputs(16)
    vd = vd.clone().requires_grad_(True)
    assert not car_step.fused_step(state, vd, sd, P.CarParams(),
                                   P.SimParams())
    with torch.no_grad():
        assert car_step.fused_step(state, vd, sd, P.CarParams(),
                                   P.SimParams())


def test_constants_follow_the_kernels_struct():
    """``constants`` gives one float32 a field of ``struct Consts`` in
    ``csrc/car_step.cu``, each the number the plain code hands PyTorch:
    products and quotients formed in double, then rounded once; 1 / lwb
    too (PyTorch's CUDA division of a tensor by a number multiplies by that
    reciprocal: for a wheelbase of 0.29 it differs from the float32
    quotient of 1 and float32(0.29))."""
    src = (Path(car_step.__file__).resolve().parent.parent / "csrc"
           / "car_step.cu").read_text()
    body = re.search(r"struct Consts \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", body))
    car = P.CarParams()
    st = dict(zip(names, car_step.constants(car, P.SimParams())))
    assert len(names) == 27 == len(st)
    f32 = lambda v: float(np.float32(v))
    lwb = car.l_f + car.l_r
    assert st["speed_kp"] == f32(2.0 * car.max_accel / car.max_speed)
    assert st["inv_lwb"] == f32(1.0 / lwb)
    assert st["yaw_gain"] == f32(car.friction_coeff * car.mass
                                 / (car.I_z * lwb))
    assert st["lf_lf_csf"] == f32(car.l_f * car.l_f * car.cs_f)
    assert st["g_lr"] == f32(9.81 * car.l_r) and st["steer_dead"] == f32(1e-4)
    assert st["v_guard"] == f32(1e-3) and st["scan_d"] == f32(0.275)
    assert st["steer_kp"] == 0.0          # "bang" reads none
    smooth = dict(zip(names, car_step.constants(
        car, P.SimParams(dynamics="ks", steer_mode="smooth", dt=0.05))))
    assert smooth["steer_kp"] == f32(2.0 * car.max_steer_vel
                                     / car.max_steer_angle)
    assert smooth["inv_lwb"] == f32(1.0 / car.wheelbase)
    ks = dict(zip(names, car_step.constants(P.CarParams(wheelbase=0.29),
                                            P.SimParams(dynamics="ks"))))
    assert ks["inv_lwb"] == f32(1.0 / 0.29) != float(np.float32(1.0)
                                                      / np.float32(0.29))
    assert smooth["dt"] == f32(0.05) and smooth["yaw_gain"] == 0.0


@pytest.mark.parametrize("kind, stride", [("per_car", 1), ("broadcast", 0),
                                          ("scalar", 0), ("expanded", 0)])
@pytest.mark.parametrize("model, mode", MODELS)
def test_cuda_route_through_a_recording_stand_in(monkeypatch, kind, stride,
                                                 model, mode):
    """On a CUDA tensor the wrapper launches ``car_step_launch`` once (the
    launch stood in for on the CPU): the model and steering flags, the
    state's eight read fields, the commands with stride 0 where one value
    serves every car (no copy) and 1 per car, eleven outputs of the
    state's shape, the car count, the 27 constants and the counter."""
    calls = []
    monkeypatch.setattr(_kernels, "on_cuda", lambda name, ref: True)
    monkeypatch.setattr(_kernels, "launch",
                        lambda *args: calls.append(args))
    state, vd, sd = _inputs(40)
    cmd = _commands(kind, vd, sd)
    car, sim = P.CarParams(), P.SimParams(dynamics=model, steer_mode=mode)
    new, sx, sy = car_step.car_step(state, *cmd, car, sim)
    (args,) = calls
    assert args[:4] == ("car_step", "car_step", int(model == "st"),
                        int(mode == "smooth"))
    fields = args[4:12]
    assert all(a.data_ptr() == getattr(state, f).data_ptr() for a, f in
               zip(fields, car_step._FLOAT_FIELDS + ("collision",)))
    assert args[12].data_ptr() == cmd[0].data_ptr()
    assert args[13].data_ptr() == cmd[1].data_ptr()
    assert args[14:16] == (stride, stride)
    outs = args[16:27]
    assert [o.data_ptr() for o in outs] == [
        t.data_ptr() for t in _flat((new, sx, sy))]
    assert all(o.shape == (40,) for o in outs)
    assert [o.dtype for o in outs[7:9]] == [torch.bool] * 2
    assert args[27] == 40 and args[29] == 27
    assert list(args[28]) == list(car_step.constants(car, sim))
    assert args[30] is car_step.CAR_COUNTS.counter(state.x.device)
    assert args[31] == 128


def test_a_wrapper_handed_what_the_kernel_does_not_take_raises():
    """Another device than the CPU or CUDA raises: no fallback. (The rest of
    ``fused_step`` is the caller's check: ``advance`` makes it once.)"""
    state, vd, sd = _variant("meta tensors")[:3]
    with pytest.raises(ValueError, match="car_step: no kernel for device"):
        car_step.car_step(state, vd, sd, P.CarParams(), P.SimParams())


def test_counters_read_the_car_steps():
    assert car_step.CAR_COUNTS.columns == ("steps",)
    got = profiling.counters()["car"]
    assert got == dict(car_step.CAR_COUNTS) and set(got) == {"steps"}
    c = car_step.CAR_COUNTS.counter(torch.device("cpu"))
    assert tuple(c.shape) == (128, 1)


@pytest.fixture(scope="module")
def levine():
    return P.build_sim("levine", scan=P.ScanParams(num_beams=90),
                       device="cpu")


def test_rollouts_count_every_car_step_and_bptt_none(levine):
    """An eager rollout's car-steps all take the wrapper (agents x steps);
    a BPTT call's, none, since this policy's every command carries a
    gradient, step 0's too (a policy whose step 0 does not: the next
    test)."""
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.parallel import (
        make_bptt_train_fn, make_gap_follower_policy, make_rollout_fn)
    from pyracecarsimulator_tpu_torch.state import state_from_pose
    poses = torch.as_tensor(sample_free_poses(levine.track, 6,
                                              np.random.RandomState(3)))
    state = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    step = psim.make_step_fn(levine, with_noise=False)
    run = make_rollout_fn(step, make_gap_follower_policy(90, 4.71238898),
                          4, 90)
    before = car_step.CAR_COUNTS["steps"]
    run(state)
    assert car_step.CAR_COUNTS["steps"] - before == 6 * 4

    def policy(params, st, ranges, t):
        return (torch.full(st.batch_shape, 2.0) * params["g"],
                torch.zeros(st.batch_shape))
    train, init = make_bptt_train_fn(
        step, policy, lambda out, t: -out.ranges.mean(), 3, 90)
    params = {"g": torch.ones(())}
    before = car_step.CAR_COUNTS["steps"]
    train(params, init(params), state)
    assert car_step.CAR_COUNTS["steps"] == before


def _first_step_free_policy(params, st, ranges, t):
    """``linear_steer``'s shape: no steering, and so no gradient, at t = 0;
    then one weight a beam."""
    steer = (torch.zeros(st.batch_shape, device=st.device) if t == 0
             else torch.tanh(((ranges - 5.0) / 10.0) @ params["w"]
                             + params["b"]))
    return torch.full(st.batch_shape, 2.0, device=st.device), steer


def _train_state(track, n, device):
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.state import state_from_pose
    poses = torch.as_tensor(sample_free_poses(track, n,
                                              np.random.RandomState(3)),
                            device=device)
    return state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])


def _bptt(step, beams, T, graph, device):
    from pyracecarsimulator_tpu_torch.parallel import make_bptt_train_fn
    train, init = make_bptt_train_fn(
        step, _first_step_free_policy,
        lambda out, t: -out.ranges.mean(), T, beams,
        optimizer=lambda ps: torch.optim.Adam(
            ps, lr=1e-2, capturable=torch.device(device).type == "cuda"),
        graph=graph)
    params = {"w": torch.zeros(beams, device=device),
              "b": torch.zeros((), device=device)}
    return train, params, init(params)


def test_a_bptt_call_whose_step_0_takes_no_gradient_counts_its_agents(
        levine, monkeypatch):
    """A BPTT call whose policy steers nothing at t = 0 (the benchmark's
    ``linear_steer``): step 0, on a state and commands that take no
    gradient, takes the wrapper (agents car-steps a call); the later steps,
    whose steering carries the parameters' gradient, keep ``compose``. The
    losses and parameters equal those of calls with every step on
    ``compose``."""
    smooth = levine._replace(sim=P.SimParams(steer_mode="smooth"))
    step = psim.make_step_fn(smooth, with_noise=False)
    state = _train_state(levine.track, 6, "cpu")
    train, params, opt = _bptt(step, 90, 3, False, "cpu")
    got = []
    for _ in range(2):
        before = car_step.CAR_COUNTS["steps"]
        params, opt, loss, final = train(params, opt, state)
        assert car_step.CAR_COUNTS["steps"] - before == 6
        got.append(loss)
    assert bool(params["w"].detach().abs().sum() > 0)
    monkeypatch.setattr(car_step, "fused_step", lambda *a: False)
    train, params_p, opt = _bptt(step, 90, 3, False, "cpu")
    before = car_step.CAR_COUNTS["steps"]
    want = [train(params_p, opt, state)[2] for _ in range(2)]
    assert car_step.CAR_COUNTS["steps"] == before
    _same(got, want)
    _same([params["w"].detach(), params["b"].detach()],
          [params_p["w"].detach(), params_p["b"].detach()])


# -- on the card -----------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["per_car", "broadcast", "scalar",
                                  "expanded"])
@pytest.mark.parametrize("model, mode", MODELS)
def test_kernel_matches_plain(cuda, model, mode, kind):
    """The kernel against ``car_step_plain`` on the card, bit for bit, one
    launch, the cars counted on the device; three chained steps."""
    state, vd, sd = _inputs(N + 37, cuda, seed=MODELS.index((model, mode)))
    cmd = _commands(kind, vd, sd)
    car, sim = P.CarParams(), P.SimParams(dynamics=model, steer_mode=mode)
    for _ in range(3):
        launches = car_step.car_step.launches
        before = car_step.CAR_COUNTS["steps"]
        got = car_step.car_step(state, *cmd, car, sim)
        torch.cuda.synchronize()
        assert car_step.car_step.launches == launches + 1
        assert car_step.CAR_COUNTS["steps"] - before == N + 37
        want = car_step.car_step_plain(state, *cmd, car, sim)
        _same(_flat(got), _flat(want))
        state = want[0]


@pytest.mark.cuda
def test_kernel_matches_plain_at_other_gains(cuda):
    """Gains given as numbers (``speed_kp``, ``steer_kp``), another dt and a
    kinematic wheelbase: the kernel still equals the plain twin."""
    state, vd, sd = _inputs(1000, cuda, seed=7)
    car = P.CarParams(wheelbase=0.29, v_switch=1.5, mass=4)
    for model in ("st", "ks"):
        sim = P.SimParams(dynamics=model, steer_mode="smooth", speed_kp=1.7,
                          steer_kp=3.3, dt=0.05)
        _same(_flat(car_step.car_step(state, vd, sd, car, sim)),
              _flat(car_step.car_step_plain(state, vd, sd, car, sim)))


@pytest.mark.cuda
def test_graphed_rollout_equals_the_eager_plain_one(cuda, monkeypatch):
    """levine at 512 cars x 1080 beams, T = 12: the graphed rollout, whose
    steps take the kernel, against the eager rollout with every step on the
    plain composition, bit for bit; a replayed call adds agents x T to
    ``counters()["car"]["steps"]`` and T launches."""
    from pyracecarsimulator_tpu_torch.maps import sample_free_poses
    from pyracecarsimulator_tpu_torch.parallel import (
        make_gap_follower_policy, make_rollout_fn)
    from pyracecarsimulator_tpu_torch.state import state_from_pose
    bundle = P.build_sim("levine", device=cuda)
    poses = torch.as_tensor(sample_free_poses(bundle.track, 512,
                                              np.random.RandomState(5)),
                            device=cuda)
    state = state_from_pose(poses[:, 0], poses[:, 1], poses[:, 2])
    step = psim.make_step_fn(bundle, with_noise=False)
    policy = make_gap_follower_policy(1080, 4.712388980384690)
    run = make_rollout_fn(step, policy, 12, 1080, keep_scans=True,
                          graph=True)
    run(state)
    before = profiling.counters()["car"]["steps"]
    launches = car_step.car_step.launches
    final, traj = run(state)
    torch.cuda.synchronize()
    assert profiling.counters()["car"]["steps"] - before == 512 * 12
    assert car_step.car_step.launches - launches == 12
    monkeypatch.setattr(car_step, "fused_step", lambda *a: False)
    before = profiling.counters()["car"]["steps"]
    final_e, traj_e = make_rollout_fn(step, policy, 12, 1080,
                                      keep_scans=True, graph=False)(state)
    assert profiling.counters()["car"]["steps"] == before
    _same([getattr(final, f) for f in FIELDS],
          [getattr(final_e, f) for f in FIELDS])
    for key in traj:
        _same([traj[key]], [traj_e[key]])


@pytest.mark.cuda
def test_a_captured_bptt_step_takes_the_kernel_at_step_0(cuda, monkeypatch):
    """levine at 512 cars x 1080 beams, T = 4, the train step replayed from
    one CUDA graph, the policy steering nothing at t = 0: one launch a
    call (the first call's two eager warm-ups of the capture besides), the
    counter, made at the first warm-up, 512 car-steps a launch, replays
    included; the losses and parameters equal those of eager calls with
    every step on the plain composition, bit for bit."""
    bundle = P.build_sim("levine", device=cuda,
                         sim=P.SimParams(steer_mode="smooth"))
    state = _train_state(bundle.track, 512, cuda)
    step = psim.make_step_fn(bundle, with_noise=False)
    train, params, opt = _bptt(step, 1080, 4, True, cuda)
    got = []
    for i in range(4):
        before = profiling.counters()["car"]["steps"]
        launches = car_step.car_step.launches
        params, opt, loss, _ = train(params, opt, state)
        torch.cuda.synchronize()
        launched = car_step.car_step.launches - launches
        assert launched == (3 if i == 0 else 1)
        assert profiling.counters()["car"]["steps"] - before == 512 * launched
        got.append(loss.clone())
    assert train.graphed.captures == 1 and train.graphed.replays == 4
    monkeypatch.setattr(car_step, "fused_step", lambda *a: False)
    train_p, params_p, opt_p = _bptt(step, 1080, 4, False, cuda)
    want = [train_p(params_p, opt_p, state)[2] for _ in range(4)]
    _same(got, want)
    _same([params["w"].detach(), params["b"].detach()],
          [params_p["w"].detach(), params_p["b"].detach()])
