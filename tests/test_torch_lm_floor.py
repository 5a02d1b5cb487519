"""ROADMAP fault 3.8's batched half: the port's batched LM stops where
the JAX package's batched LM (``ngmix_tpu.fitting.lm.run_lm_normal_batched``)
stops. A trial cost equal to the current one is a rejection there, and
lambda climbs until it passes lambda_max. The solvers' ``at_floor``
option (off by default) ends such a lane instead, as the reference's
residual-form run_lm does; only the host fitters' kernel routes set
it.

The case is a normal-equation function under which no step can lower
the cost: a constant cost, with a zero, a tiny and a large gradient on
four lanes with open, one-sided and two-sided bounds. It runs through
the JAX batched LM (whose final state is read from its epilogue), the
port's ``run_lm_normal_batched`` and K3's and K3-mb's plain versions
(on stamps of zero weight, whose cost is sum ve^2 with zero gradient).
nfev, lam, done and the ier flags are equal, exactly; float64 on the
CPU. On the fault's stamp the host Fitter is held to the JAX Fitter,
and the port's batched LM to the JAX batched LM's decisions on the JAX
run's own evaluations. A mocked card shows the host routes passing the
option to the kernels on and the batched measures passing it off.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu.fitting import lm as jlm

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import sims
from ngmix_tpu_torch.fitting import fitters, lm as tlm
from ngmix_tpu_torch.ops import _build, lm_solve

from test_torch_fitters import DIMS, _obs, _on_fake_card
from test_torch_lm_solve import _fake_cuda

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

STATE_KEYS = ("nfev", "lam", "done", "ier_small_step", "ier_small_cost")
INF = np.inf
# open, one-sided and two-sided dims; the guess is far from every bound
LO = np.array([-INF, -INF, -1.0, -1.0, 0.01, 1e-3])
HI = np.array([INF, INF, 1.0, 1.0, 50.0, 1e9])
GUESS = np.array([[0.1, -0.2, 0.05, -0.1, 1.2, 100.0]] * 4)
COST = 7.25
# the lanes' external gradient and JtJ scale: none, a curvature alone,
# a gradient the model predicts under ftol of the cost, a large one
JTR = np.array([0.0, 0.0, 1e-6, 1.0])
JTJ = np.array([0.0, 5.0, 1.0, 1.0])


def _jax_state(normal_fn, data, guess, lo, hi, conf, monkeypatch):
    """the JAX batched LM's final solver state, read from its epilogue"""
    seen = {}
    epilogue = jlm._normal_epilogue

    def read(out, *a, **k):
        seen.update(out)
        return epilogue(out, *a, **k)

    monkeypatch.setattr(jlm, "_normal_epilogue", read)
    jlm.run_lm_normal_batched(normal_fn, data, jnp.asarray(guess), jnp.asarray(lo),
                              jnp.asarray(hi), conf, nres=100)
    return {k: np.asarray(v) for k, v in seen.items()}


def _jax_flat(cost, jtr, jtj):
    """a JAX normal function of constant cost [B], gradient jtr [B] in
    every parameter and JtJ jtj [B] times the identity"""
    def normal_fn(x, d):
        n = x.shape[-1]
        return (jnp.asarray(cost) + 0.0 * x[:, 0], jnp.asarray(jtr)[:, None] * jnp.ones(n),
                jnp.asarray(jtj)[:, None, None] * jnp.eye(n))
    return normal_fn


def _port_flat(cost, jtr, jtj):
    def normal_fn(x, d):
        n = x.shape[-1]
        return (torch.as_tensor(cost) + 0.0 * x[:, 0],
                torch.as_tensor(jtr)[:, None] * torch.ones(n, dtype=x.dtype),
                torch.as_tensor(jtj)[:, None, None] * torch.eye(n, dtype=x.dtype))
    return normal_fn


def _assert_state(tstate, jstate):
    for k in STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(tstate[k]), jstate[k], err_msg=k)


def _zero_weight_stamps(B, P=50):
    """K3's inputs of B stamps whose weights are zero: the cost is sum
    ve^2 at every point, its gradient and JtJ zero"""
    rng = np.random.RandomState(38)
    t = dict(dtype=torch.float64)
    v = torch.as_tensor(rng.uniform(-3, 3, (B, P)), **t)
    u = torch.as_tensor(rng.uniform(-3, 3, (B, P)), **t)
    ve = torch.as_tensor(rng.normal(size=(B, P)), **t)
    psf = torch.tensor([[0.3, 0.0, 0.3]] * B, **t)
    return psf, v, u, torch.zeros_like(v), ve


def test_flat_cost_batched_lm_matches_jax(monkeypatch):
    """no step lowers the cost: every lane rejects 16 steps and stops
    at lambda_max (nfev 17, lam 1e13, done, no ier flag), as the JAX
    batched LM does; with at_floor the lanes whose model predicts under
    ftol of the cost stop at nfev 2"""
    jstate = _jax_state(_jax_flat(np.full(4, COST), JTR, JTJ), None, GUESS, LO, HI,
                        jlm.LMConf(), monkeypatch)
    np.testing.assert_array_equal(jstate["nfev"], [17] * 4)
    np.testing.assert_array_equal(jstate["lam"], [1e13] * 4)
    assert jstate["done"].all()
    assert not (jstate["ier_small_step"] | jstate["ier_small_cost"]).any()
    t = [torch.as_tensor(x, dtype=torch.float64) for x in (GUESS, LO, HI)]
    normal_fn = _port_flat(torch.full((4,), COST, dtype=torch.float64), torch.as_tensor(JTR),
                           torch.as_tensor(JTJ))
    state = tlm.run_lm_normal_state(normal_fn, None, *t, tlm.LMConf())
    _assert_state(state, jstate)
    # the batched epilogue of the same loop: the reference's nfev and ier
    res = tlm.run_lm_normal_batched(normal_fn, None, *t, tlm.LMConf(), nres=100)
    np.testing.assert_array_equal(res["nfev"].numpy(), jstate["nfev"])
    np.testing.assert_array_equal(res["ier"].numpy(), [5] * 4)
    floor = tlm.run_lm_normal_state(normal_fn, None, *t, tlm.LMConf(), at_floor=True)
    # the large gradient's step shrinks as lambda climbs, until its
    # predicted reduction falls under ftol of the cost
    np.testing.assert_array_equal(floor["nfev"].numpy(), [2, 2, 2, 11])
    assert floor["ier_small_cost"].all()
    assert floor["done"].all()


def test_flat_cost_k3_plain_matches_jax(monkeypatch):
    """K3's plain version (the option off, as the batched measures call
    it) on stamps of zero weight against the JAX batched LM on the
    same constant cost"""
    psf, v, u, ia, ve = _zero_weight_stamps(3)
    cost = (ve * ve).sum(-1).numpy()
    g = torch.as_tensor(GUESS[:3])
    lo, hi = torch.as_tensor(LO), torch.as_tensor(HI)
    jstate = _jax_flat(cost, np.zeros(3), np.zeros(3))
    jstate = _jax_state(jstate, None, GUESS[:3], LO, HI, jlm.LMConf(), monkeypatch)
    state = lm_solve.lm_solve(g, lo, hi, psf, v, u, ia, ve, tlm.LMConf(), "exp")
    _assert_state(state, jstate)
    np.testing.assert_array_equal(state["nfev"].numpy(), [17] * 3)
    on = lm_solve.lm_solve(g, lo, hi, psf, v, u, ia, ve, tlm.LMConf(), "exp", at_floor=True)
    np.testing.assert_array_equal(on["nfev"].numpy(), [2] * 3)
    # the options kernel's plain LM (varpro) keeps the reference's rule
    # whatever at_floor says
    vp = lm_solve.lm_solve(g, torch.cat([lo[:5], lo.new_full((1,), -INF)]),
                           torch.cat([hi[:5], hi.new_full((1,), INF)]), psf, v, u, ia, ve,
                           tlm.LMConf(), "exp", varpro=True, at_floor=True)
    assert vp["nfev"].tolist() == [17] * 3


def test_flat_cost_k3mb_plain_matches_jax(monkeypatch):
    """K3-mb's plain version on objects of two zero-weight epochs in two
    bands against the JAX batched LM"""
    psf, v, u, ia, ve = _zero_weight_stamps(6)
    shape = (3, 2, v.shape[-1])
    v, u, ia, ve = (x.reshape(shape) for x in (v, u, ia, ve))
    cost = (ve * ve).sum((-1, -2)).numpy()
    lo = np.concatenate([LO, LO[-1:]])
    hi = np.concatenate([HI, HI[-1:]])
    guess = np.concatenate([GUESS[:3], GUESS[:3, -1:]], 1)
    jstate = _jax_state(_jax_flat(cost, np.zeros(3), np.zeros(3)), None, guess, lo, hi,
                        jlm.LMConf(), monkeypatch)
    band = torch.tensor([0, 1], dtype=torch.int32)
    state = lm_solve.lm_solve_mb(torch.as_tensor(guess), torch.as_tensor(lo),
                                 torch.as_tensor(hi), psf.reshape(3, 2, 3), band, v, u, ia, ve,
                                 tlm.LMConf(), "exp")
    _assert_state(state, jstate)


@pytest.fixture(scope="module")
def fault_stamp():
    """ROADMAP fault 3.8's stamp with its LMBounds prior: the JAX
    package's prior, the port's, the two observations and the guess"""
    from ngmix_tpu import joint_prior as jjp, priors as jpr
    from ngmix_tpu_torch import convert

    rng = np.random.RandomState(3)
    jprior = jjp.PriorSimpleSep(jpr.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng),
                                jpr.GPriorBA(0.3, rng=rng), jpr.LMBounds(0.01, 50.0, rng=rng),
                                jpr.LMBounds(1e-3, 1e9, rng=rng))
    jobs, tobs, data = _obs(46, model="exp")
    return jprior, convert.prior_from_object(jprior), jobs, tobs, data["guess"]


def test_host_fit_keeps_the_reference_fitters_nfev(fault_stamp):
    """the host Fitter's K3 route (at_floor on) ends the fault's stamp
    where the JAX package's Fitter ends it"""
    from ngmix_tpu.fitting.fitters import Fitter as JFitter
    from test_torch_fitters import assert_fit_equal

    jprior, prior, jobs, tobs, guess = fault_stamp
    jres = JFitter("exp", prior=jprior).go(jobs, guess)
    res = nt.Fitter("exp", prior=prior).go(tobs, guess)
    assert res.route == "K3"
    assert res["nfev"] == jres["nfev"] and res["flags"] == jres["flags"] == 0
    assert_fit_equal(res, jres)


def test_fault_stamp_batched_lm_takes_the_reference_decisions(fault_stamp, monkeypatch):
    """the fault's stamp as a B = 1 batch through the JAX batched LM
    (AD normal equations of the stamp's residual rows, prior rows
    first). Fed the JAX run's own (cost, Jtr, JtJ) call by call, the
    port's batched LM (at_floor off) visits the same points and ends
    with the JAX run's nfev, lam, done and ier flags. On the port's own
    objective (K3's plain version) the lane reaches the same optimum;
    there its stop hangs on the last bit of a cost at the floor, where
    the two sums round apart (ROADMAP fault 3.8, open: nfev 24 against
    the JAX run's 8), so nfev is not compared"""
    import jax

    from ngmix_tpu.fitting.fit_model import make_fdiff_fn, pack_fit_data

    jprior, prior, jobs, tobs, guess = fault_stamp
    fdiff = make_fdiff_fn("exp", prior=jprior)
    fit_data = pack_fit_data(jobs)[0]
    calls = []

    def normal_fn(x, d):
        def one(p):
            r = fdiff(p, fit_data)
            J = jax.jacfwd(lambda q: fdiff(q, fit_data))(p)
            return jnp.sum(r * r), J.T @ r, J.T @ J
        out = jax.vmap(one)(x)
        jax.debug.callback(lambda *a: calls.append([np.array(v) for v in a]), x, *out,
                           ordered=True)
        return out

    lo = np.array([-INF] * 4 + [0.01, 1e-3])
    hi = np.array([INF] * 4 + [50.0, 1e9])
    jstate = _jax_state(normal_fn, None, np.asarray(guess)[None], lo, hi, jlm.LMConf(),
                        monkeypatch)
    assert len(calls) == jstate["nfev"][0]
    replayed = iter(calls)

    def replay(x, d):
        x_ref, cost, jtr, jtj = next(replayed)
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-9, atol=1e-15)
        return tuple(torch.as_tensor(v) for v in (cost, jtr, jtj))

    t = [torch.as_tensor(v, dtype=torch.float64) for v in (np.asarray(guess)[None], lo, hi)]
    _assert_state(tlm.run_lm_normal_state(replay, None, *t, tlm.LMConf()), jstate)

    fm = nt.fitting.FitModel(tobs, "exp", guess)
    px = fm.data.pixels
    planes = [x.contiguous() for x in (px.v, px.u, px.ierr * px.area, px.val * px.ierr)]
    state = lm_solve.lm_solve(t[0], *t[1:], fm.data.psf_gmix[:, 0, 3:6].contiguous(), *planes,
                              tlm.LMConf(), "exp", prior)
    assert state["done"].all() and not state["pinned"].any()
    np.testing.assert_allclose(tlm.i2e(state["y"], t[1], t[2]).numpy(),
                               np.asarray(jlm.i2e(jnp.asarray(jstate["y"]), lo, hi)), rtol=1e-5)
    np.testing.assert_allclose(state["cost"].numpy(), jstate["cost"], rtol=1e-10)


def _mock_kernels(monkeypatch):
    calls = []
    lib = types.SimpleNamespace(**{
        lm_solve.c_name(k, m, dt): (lambda *a, k=k: calls.append((k, a)) or 0)
        for k in ("lm_solve", "lm_solve_mb") for m in lm_solve.MODELS
        for dt in (torch.float32, torch.float64)})
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=4321))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(fitters, "_normal_epilogue", lambda state, *a: dict(
        pars=torch.zeros(1, 6), pars_err=torch.zeros(1, 6), pars_cov0=torch.zeros(1, 6, 6),
        pars_cov=torch.zeros(1, 6, 6), flags=torch.zeros(1, dtype=torch.int32),
        nfev=torch.ones(1, dtype=torch.int32), ier=torch.ones(1, dtype=torch.int32)))
    return calls


@pytest.mark.parametrize("route", ["K3", "K3-mb"])
def test_mocked_card_host_route_on_batched_off(monkeypatch, route):
    """the host fit's kernel launch carries at_floor 1 (the argument
    before the stream); K3 and K3-mb under the batched measures' LM
    configuration carry 0"""
    _, tobs, data = _obs(45)
    obs = tobs
    if route == "K3-mb":
        obs = nt.ObsList()
        obs.append(tobs)
        obs.append(tobs)
    with torch.no_grad():
        fm = _on_fake_card(nt.fitting.FitModel(obs, "gauss", data["guess"]))
    calls = _mock_kernels(monkeypatch)
    lo, hi = np.full(6, -INF), np.full(6, INF)
    fitters._kernel_solve(route, fm, data["guess"], lo, hi, tlm.LMConf(maxfev=77), None)
    ((kernel, c),) = calls
    assert kernel == ("lm_solve" if route == "K3" else "lm_solve_mb")
    assert c[-2:] == (1, 4321)
    P = DIMS[0] * DIMS[1]
    f64 = dict(dtype=torch.float64)
    g = _fake_cuda(torch.as_tensor(data["guess"])[None])
    box = [_fake_cuda(torch.as_tensor(x)) for x in (lo, hi)]
    planes = [_fake_cuda(torch.ones((1, P), **f64)) for _ in range(4)]
    if route == "K3":
        lm_solve.lm_solve(g, *box, _fake_cuda(torch.full((1, 3), 0.3, **f64)), *planes,
                          tlm.LMConf(), "gauss")
    else:
        lm_solve.lm_solve_mb(g, *box, _fake_cuda(torch.full((1, 2, 3), 0.3, **f64)),
                             _fake_cuda(torch.tensor([0, 0], dtype=torch.int32)),
                             *(_fake_cuda(torch.ones((1, 2, P), **f64)) for _ in range(4)),
                             tlm.LMConf(), "gauss")
    assert calls[-1][1][-2:] == (0, 4321)


def test_batched_measures_pass_at_floor_off(monkeypatch):
    """the exp-lm pipeline and the mb pipeline call K3 and K3-mb (here
    their plain versions, on the CPU) with at_floor off"""
    seen = []
    for name in ("lm_solve", "lm_solve_mb"):
        def recorded(*a, solve=getattr(lm_solve, name), name=name, **k):
            seen.append((name, k.get("at_floor", False)))
            return solve(*a, **k)
        monkeypatch.setattr(lm_solve, name, recorded)
    gen = torch.Generator().manual_seed(2)
    args = sims.make_sim_batch(gen, 2, torch.float64, "cpu")
    nt.make_metacal_pipeline_fn(sims.METACAL_EXP_LM_CONFIG, measure="exp-lm",
                                device="cpu")(*args)
    mb = sims.make_sim_batch_mb(gen, 2, torch.float64, device="cpu")
    nt.make_metacal_pipeline_mb_fn(sims.METACAL_MB_CONFIG, sims.MB_BAND, sims.MB_NBAND,
                                   measure="exp-lm", device="cpu")(*mb)
    assert {n for n, _ in seen} == {"lm_solve", "lm_solve_mb"}
    assert not any(on for _, on in seen)
