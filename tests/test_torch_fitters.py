"""The port's host LM fitters against ngmix_tpu's on the same inputs:
the residual-form LM (fitting.lm.run_lm) on the reference's residual
problems, Fitter on the K3 route (exp, gauss), PSFFluxFitter, the
noise-image covariance, the fit_pars errors and GMixRangeError on a bad
guess; the zero-psf model that a fit without a psf gives K3; and the
K3 and K3-mb launches at B = 1 on a mocked card. The K3 route for dev
(free and in fit_pars["bounds"]) and the K3-mb route are in
tests/test_torch_fitter_routes.py, the K3 route with a prior in
tests/test_torch_guessers.py (from a BDFGuesser), the run_lm route
and the runners in tests/test_torch_runners.py: each JAX Fitter
compiles once a model, prior and data shape, so the cases are spread
to keep each file's time under a minute.

The stamps are tests/_sims.get_model_obs at 25x25 from numpy seeds,
carried across by convert.observation_from_object(device="cpu"), so
the port runs the kernels' plain versions. Tolerances: run_lm pars,
pars_err and pars_cov to rtol 1e-8 + atol 1e-10 with flags and ier
equal and nfev within 2; a Fitter's pars, pars_err, g, T, flux and s2n
to rtol 1e-5 (+ atol 1e-12 for values at 0) with flags equal and nfev
within 2 (the LM tolerances of ROADMAP item 13b-1).
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu.fitting import lm as jlm

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert, flags
from ngmix_tpu_torch.fitting import fitters, lm as tlm
from ngmix_tpu_torch.gexceptions import GMixRangeError
from ngmix_tpu_torch.gmix import core as gcore
from ngmix_tpu_torch.ops import _build, lm_solve, normal_eqs

from _sims import get_model_obs

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

DIMS = (25, 25)
FIT_KEYS = ("pars", "pars_err", "g", "T", "flux", "s2n")


def _obs(seed, model="gauss", noise=0.1, **kw):
    """(JAX observation with its psf mixture set, the port's, the sim's
    data) of one noisy model stamp"""
    rng = np.random.RandomState(seed)
    data = get_model_obs(rng=rng, model=model, T=1.2, g1=0.1, g2=-0.05, flux=100.0,
                         noise=noise, dims=DIMS, **kw)
    obs = data["obs"]
    obs.psf.set_gmix(data["psf_gmix"])
    data["guess"] = data["pars"] * rng.uniform(low=0.9, high=1.1, size=6)
    return obs, convert.observation_from_object(obs, device="cpu"), data


def assert_fit_equal(tres, jres, keys=FIT_KEYS, rtol=1e-5, atol=1e-12):
    assert tres["flags"] == jres["flags"]
    assert abs(tres["nfev"] - jres["nfev"]) <= 2, (tres["nfev"], jres["nfev"])
    for k in keys:
        np.testing.assert_allclose(np.asarray(tres[k]), np.asarray(jres[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# ----------------------------------------------------------------------
# run_lm on the reference's residual problems (tests/test_fitting_lm.py)

def _j_lin(p, d):
    return (d[0] @ p - d[1]) * d[2]


def _t_lin(p, d):
    return (d[0] @ p - d[1]) * d[2]


def _j_rosen(p, d):
    return jnp.stack([10.0 * (p[1] - p[0] * p[0]), 1.0 - p[0]])


def _t_rosen(p, d):
    return torch.stack([10.0 * (p[1] - p[0] * p[0]), 1.0 - p[0]])


def _j_pin(p, d):
    # the third row is 0: it buys a nonzero dof
    return jnp.stack([10.0 * (p[1] - 5.0), p[0] + p[1] - 5.5, 0.0 * p[0]])


def _t_pin(p, d):
    return torch.stack([10.0 * (p[1] - 5.0), p[0] + p[1] - 5.5, 0.0 * p[0]])


def _linear(n_mask=0, singular=False):
    """(A, y, w) of a weighted linear problem over 30 rows, the last
    n_mask rows masked (w = 0), or with an unused third column"""
    rng = np.random.RandomState(9 if singular else 44)
    A = rng.normal(size=(30, 3))
    if singular:
        A[:, 2] = 0.0
        y, sigma = rng.normal(size=30), 1.0
    else:
        y, sigma = A @ np.array([1.0, -2.0, 0.5]) + rng.normal(size=30) * 0.01, 0.01
    w = np.where(np.arange(30) < 30 - n_mask, 1.0 / sigma, 0.0)
    inf = np.full(3, np.inf)
    return (_j_lin, _t_lin, (A, y, w), np.zeros(3), -inf, inf,
            dict(n_eff=30 - n_mask))


def _on_bound(one_sided):
    """the unconstrained optimum of x0 below the box: it ends on its
    bound (two-sided: the logistic map; one-sided: the sqrt form)"""
    rng = np.random.RandomState(47)
    A = rng.normal(size=(30, 2))
    y = A @ np.array([-0.4, 0.7]) + rng.normal(size=30) * 0.05
    lo = np.array([0.0, -np.inf if one_sided else -5.0])
    hi = np.array([np.inf if one_sided else 1.0, np.inf if one_sided else 5.0])
    return _j_lin, _t_lin, (A, y, np.full(30, 20.0)), np.array([0.5, 0.0]), lo, hi, {}


def _with_prior():
    """three prior rows (p - mu) / 0.3 at the head of the residual
    (n_prior_pars)"""
    rng = np.random.RandomState(7)
    A = rng.normal(size=(27, 3))
    y = A @ np.array([0.8, -0.4, 0.3]) + rng.normal(size=27) * 0.05
    mu = np.array([0.5, -0.5, 0.5])
    A = np.vstack([np.eye(3), A])
    y = np.concatenate([mu, y])
    w = np.concatenate([np.full(3, 1.0 / 0.3), np.full(27, 20.0)])
    return (_j_lin, _t_lin, (A, y, w), np.full(3, 0.1), np.array([-1.0, -1.0, -np.inf]),
            np.array([1.0, np.inf, 1.0]), dict(n_prior_pars=3))


_NONE = (np.zeros(1), np.zeros(1), np.zeros(1))
PROBLEMS = {
    "linear": _linear,
    "masked_rows": lambda: _linear(n_mask=12),
    "singular": lambda: _linear(singular=True),
    "rosenbrock_bounded": lambda: (_j_rosen, _t_rosen, _NONE, np.array([-1.0, 0.0]),
                                   np.array([-np.inf, -np.inf]), np.array([np.inf, 0.5]), {}),
    "on_bound_two_sided": lambda: _on_bound(False),
    "on_bound_one_sided": lambda: _on_bound(True),
    "pin_then_release": lambda: (_j_pin, _t_pin, _NONE, np.array([1.0 - 1.0e-6, 2.0]),
                                 np.array([-1.0, -np.inf]), np.array([1.0, np.inf]), {}),
    "prior_rows": _with_prior,
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_run_lm_matches_jax(name):
    """the reference's problems (tests/test_fitting_lm.py), in float64;
    the JAX side compiled once a residual function and shape"""
    jres, tres, data, guess, lo, hi, kw = PROBLEMS[name]()
    jout = jlm.run_lm_jit(jres, tuple(jnp.asarray(d) for d in data), jnp.asarray(guess),
                          jnp.asarray(lo), jnp.asarray(hi), jlm.LMConf(maxfev=500), **kw)
    tout = tlm.run_lm(tres, tuple(torch.as_tensor(d) for d in data), torch.as_tensor(guess),
                      torch.as_tensor(lo), torch.as_tensor(hi), tlm.LMConf(maxfev=500), **kw)
    assert int(tout["flags"]) == int(jout["flags"])
    assert int(tout["ier"]) == int(jout["ier"])
    assert abs(int(tout["nfev"]) - int(jout["nfev"])) <= 2
    for k in ("pars", "pars_err", "pars_cov"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-8,
                                   atol=1e-10, err_msg=k)
    np.testing.assert_allclose(float(tout["s_sq"]), float(jout["s_sq"]), rtol=1e-8)
    if name == "singular":
        assert int(tout["flags"]) & flags.LM_SINGULAR_MATRIX


def test_run_lm_batch_lane_by_lane():
    _, tres, (A, y, w), guess, lo, hi, _ = _on_bound(False)
    data = tuple(torch.as_tensor(np.stack([x, x[::-1].copy()])) for x in (A, y, w))
    conf = tlm.LMConf()
    out = tlm.run_lm_batch(tres, data, torch.as_tensor(np.stack([guess, guess])),
                           torch.as_tensor(lo), torch.as_tensor(hi), conf,
                           n_eff=torch.tensor([30, 30]))
    for i in range(2):
        one = tlm.run_lm(tres, tuple(x[i] for x in data), torch.as_tensor(guess),
                         torch.as_tensor(lo), torch.as_tensor(hi), conf, n_eff=30)
        for k, v in one.items():
            assert torch.equal(out[k][i], v), k
    # the k-space residuals (ROADMAP item 13b-2) halve the dof, n_eff //
    # 2 - npars, and change nothing else; run_lm_batch passes k_space on
    kout = tlm.run_lm_batch(tres, data, torch.as_tensor(np.stack([guess, guess])),
                            torch.as_tensor(lo), torch.as_tensor(hi), conf,
                            n_eff=torch.tensor([30, 30]), k_space=True)
    for k in ("pars", "flags", "nfev", "ier", "cost"):
        assert torch.equal(kout[k], out[k]), k
    np.testing.assert_allclose(kout["s_sq"].numpy(), out["s_sq"].numpy() * 28 / 13, rtol=1e-14)


# ----------------------------------------------------------------------
# Fitter on the K3 route against the JAX Fitter

BOUNDS = [(-2, 2), (-2, 2), (-0.99, 0.99), (-0.99, 0.99), (0.01, 50.0), (120.0, 1.0e9)]


def _k3_case(name):
    """(JAX result, the port's) of one K3-route case"""
    model, _, bounded = name.partition("_")
    jobs, tobs, data = _obs({"exp": 46, "gauss": 45, "dev": 48}[model], model=model)
    fit_pars = {"bounds": BOUNDS} if bounded else None
    return (jn.Fitter(model, fit_pars=fit_pars).go(jobs, data["guess"]),
            nt.Fitter(model, fit_pars=fit_pars).go(tobs, data["guess"]))


@pytest.mark.parametrize("name", ["exp", "gauss"])
def test_fitter_k3_route_matches_jax(name):
    jres, tres = _k3_case(name)
    assert tres.route == "K3"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    for k in ("chi2per", "dof", "lnprob", "npix"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-5, err_msg=k)
    gm = tres.get_gmix()
    np.testing.assert_allclose(gm.get_data(), jres.get_gmix().get_data(), rtol=1e-5,
                               atol=1e-12)
    if name == "gauss":
        np.testing.assert_allclose(tres.make_image(), jres.make_image(), rtol=1e-5,
                                   atol=1e-10)


def test_zero_psf_is_the_unconvolved_model_to_the_bit():
    """a fit without a psf mixture gives K3 a psf of zero covariance:
    the convolved gaussians (K3's plain evaluation) are the unconvolved
    ones bit for bit, so the route solves the reference's objective"""
    pars = torch.tensor([[0.01, -0.02, 0.1, -0.05, 1.3, 90.0]], dtype=torch.float64)
    for model in ("exp", "gauss", "dev"):
        rp, gm, _ = tbatch._exp_reparam(pars, tbatch._psf_gmix(torch.zeros(1, 3,
                                                                          dtype=torch.float64)),
                                        model)
        g0, _ = gcore.gmix_fill(model, pars)
        assert torch.equal(gm, g0), model
        assert torch.equal(rp, normal_eqs.gmix_reparam(g0)), model


def test_fitter_fit_pars_errors_and_bad_guess():
    jobs, tobs, data = _obs(52)
    nt.Fitter("gauss", fit_pars={"epsfcn": 1e-8})
    with pytest.raises(ValueError, match="unsupported fit_pars"):
        nt.Fitter("gauss", fit_pars={"factor": 100.0})
    with pytest.raises(ValueError, match="bounds has"):
        nt.Fitter("gauss", fit_pars={"bounds": BOUNDS[:3]}).go(tobs, data["guess"])
    with pytest.raises(GMixRangeError):
        nt.Fitter("gauss").go(tobs, [0.0, 0.0, 0.9, 0.9, 1.0, 1.0])
    with pytest.raises(ValueError, match="obs.noise"):
        nt.Fitter("gauss", use_noise_image=True).go(
            convert.observation_from_object(jn.Observation(
                jobs.image, weight=jobs.weight, jacobian=jobs.jacobian, psf=jobs.psf),
                device="cpu"), data["guess"])


def test_noise_image_covariance_matches_jax():
    """use_noise_image: the sandwich covariance of calc_noise_cov, its
    derivative images from torch.func.jacfwd"""
    jobs, _, data = _obs(45)
    noise = np.random.RandomState(21).normal(size=DIMS) * 0.1
    jobs = jn.Observation(jobs.image, weight=jobs.weight, jacobian=jobs.jacobian,
                          psf=jobs.psf, noise=noise)
    tobs = convert.observation_from_object(jobs, device="cpu")
    guess = data["guess"]
    jres = jn.Fitter("gauss", use_noise_image=True).go(jobs, guess)
    tres = nt.Fitter("gauss", use_noise_image=True).go(tobs, guess)
    assert tres.route == "K3"
    assert_fit_equal(tres, jres, keys=("pars", "pars_err", "pars_cov"))


def test_psf_flux_fitter_matches_jax():
    jobs, tobs, _ = _obs(51)
    for kw in ({}, {"normalize_psf": False}):
        jres = jn.PSFFluxFitter(**kw).go(jobs)
        tres = nt.PSFFluxFitter(**kw).go(tobs)
        assert tres["flags"] == jres["flags"] == 0
        for k in ("flux", "flux_err", "chi2per", "dof"):
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-10, err_msg=k)


# ----------------------------------------------------------------------
# the kernel routes on a mocked card

class _FakeCuda(torch.Tensor):
    """a CPU tensor that reports a CUDA device"""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, torch.as_tensor(x).contiguous())


def _mock_card(monkeypatch, ret):
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return ret

    lib = types.SimpleNamespace(**{lm_solve.c_name(k, m, dt): fake_kernel
                                   for k in ("lm_solve", "lm_solve_mb")
                                   for m in lm_solve.MODELS
                                   for dt in (torch.float32, torch.float64)})
    monkeypatch.setattr(_build, "load", lambda: lib)

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")

    monkeypatch.setattr(lm_solve, "lm_solve_plain", no_plain)
    monkeypatch.setattr(lm_solve, "lm_solve_mb_plain", no_plain)
    monkeypatch.setattr(fitters, "run_lm", no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=4321))

    @contextlib.contextmanager
    def current_device(dev):
        yield

    monkeypatch.setattr(torch.cuda, "device", current_device)
    monkeypatch.setattr(lm_solve, "launches", 0)
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    # the epilogue's inputs: the state and the live pixel count
    seen = {}

    def epilogue(state, lo, hi, conf, nres):
        seen.update(nres=int(nres), npars=state["y"].shape[1], B=state["y"].shape[0])
        one = torch.zeros(1, dtype=torch.int32)
        return dict(pars=torch.zeros(1, seen["npars"]), pars_err=torch.zeros(1, seen["npars"]),
                    pars_cov0=torch.zeros(1, seen["npars"], seen["npars"]),
                    pars_cov=torch.zeros(1, seen["npars"], seen["npars"]), flags=one + 1,
                    nfev=one, ier=one)

    monkeypatch.setattr(fitters, "_normal_epilogue", epilogue)
    return calls, seen


def _on_fake_card(fm):
    """the fit model with its data's tensors reporting a CUDA device"""
    d = fm.data
    fm.data = d._replace(pixels=type(d.pixels)(*(_fake_cuda(x) for x in d.pixels)),
                         psf_gmix=_fake_cuda(d.psf_gmix), band=_fake_cuda(d.band))
    return fm


@pytest.mark.parametrize("route", ["K3", "K3-mb"])
def test_kernel_route_launches_once_at_b1(monkeypatch, route):
    jobs, tobs, data = _obs(45)
    obs = tobs
    if route == "K3-mb":
        obs = nt.ObsList()
        obs.append(tobs)
        obs.append(tobs)
    with torch.no_grad():
        fm = _on_fake_card(nt.fitting.FitModel(obs, "gauss", data["guess"]))
    assert fitters.fit_route(fm, None) == route
    calls, seen = _mock_card(monkeypatch, 0)
    lo, hi = np.full(6, -np.inf), np.full(6, np.inf)
    fitters._kernel_solve(route, fm, data["guess"], lo, hi, tlm.LMConf(maxfev=77), None)
    (c,) = calls
    P = DIMS[0] * DIMS[1]
    if route == "K3":
        assert (lm_solve.launches, lm_solve.launches_mb) == (1, 0)
        # B = 1, P pixels, no prior rows, then the LM settings
        assert c[20:24] == (None, 1, P, 0) and c[24] == 77
    else:
        assert (lm_solve.launches, lm_solve.launches_mb) == (0, 1)
        # B = 1 object of E = 2 epochs, P pixels, one band
        assert c[21:27] == (None, 1, 2, P, 1, 0) and c[27] == 77
    # the epilogue counts the live pixels of every epoch
    assert seen == dict(nres=P * (2 if route == "K3-mb" else 1), npars=6, B=1)


def test_kernel_failure_raises_without_falling_back(monkeypatch):
    jobs, tobs, data = _obs(45)
    fm = _on_fake_card(nt.fitting.FitModel(tobs, "gauss", data["guess"]))
    _mock_card(monkeypatch, 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fitters._kernel_solve("K3", fm, data["guess"], np.full(6, -np.inf),
                              np.full(6, np.inf), tlm.LMConf(), None)
    assert lm_solve.launches == 0

    # Fitter.go lets the kernel's error through: no run_lm, no CPU
    def failing(*a, **k):
        raise RuntimeError("K3 lm_solve launch failed: CUDA error 700")

    monkeypatch.setattr(fitters, "_kernel_solve", failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        nt.Fitter("gauss").go(tobs, data["guess"])
