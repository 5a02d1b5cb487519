"""The LM priors of the PyTorch port (ngmix_tpu_torch/priors,
joint_prior.py, convert.prior_from_object) and the prior-regularized
LM fits against the JAX package on the same numpy inputs in float64.

Tolerances:
- each component's rows (get_lnprob_device, get_lnprob_device2d,
  get_fdiff_device) and their closed-form derivatives against the
  reference's values and its jax.jacfwd of the same functions, and the
  joint priors' fill_fdiff_device and Jacobian against
  jax.vmap(jax.jacfwd(fill_fdiff_device)): rtol 1e-10, with infinite
  rows (outside a flat or truncated range, LogNormal at val <= shift)
  and nan in the same places;
- the pipelines with lm_prior and lm_bounds (exp-lm with the reference
  test's prior and box, tests/test_batch_pipeline.py:377-397; bdf-lm
  with tests/_priors.py's PriorBDFSep; the mb pipeline with gauss-lm at
  nband 2, :193-218): flags, nfev and ier equal, pars, pars_err and
  pars_cov to rtol 1e-8 and atol 1e-10, as
  tests/test_batch_pipeline.py:822-828 holds two implementations of one
  objective. The flat exp-lm reference runs the JAX package's K1 route
  (the TPU kernel in interpret mode), as tests/test_torch_pipeline.py
  does; bdf-lm its AD route; the mb pipeline its "epoch" objective;
- the covariance scales by the pixels' chi^2 (cost_pix / dof), not by
  the cost with the prior rows (ROADMAP fault 3.3): at CenPrior sigma =
  0.1 the two differ by far more than rtol 1e-8, and the port matches
  the reference to 1e-8.

The kernels' prior rows run only on the card (chip_smoke.py, phase 23);
here the wrappers pass the prior's table to them on a mocked card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch, joint_prior as jjp, priors as jpr
from ngmix_tpu.priors import priors as jpr1d, shape as jshape

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert, joint_prior as tjp, priors as tpr
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.ops import lm_solve

from _priors import get_prior
from test_torch_lm_solve import _fake_cuda, _mock_card, _small_args
from test_torch_mb import JCONF as MB_JCONF
from test_torch_pipeline import DIMS, EXP_LM_CONF, PSF_DIMS, SCALE, _inputs

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

RNG = np.random.RandomState(0)
INF = np.inf


def _close(port, ref, what, rtol=1e-10):
    port, ref = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=what)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref), err_msg=what)
    np.testing.assert_array_equal(np.sign(port[np.isinf(port)]), np.sign(ref[np.isinf(ref)]),
                                  err_msg=what)
    ok = np.isfinite(ref)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=rtol, atol=0, err_msg=what)


# ----------------------------------------------------------------------
# (i) the components: each reference prior, its port, and points inside
# and outside its support. TwoSidedErf keeps to points where -2 ln p >
# 1e-6: inside its flat top p rounds to ~1 and ln p is rounding noise,
# which the two packages round differently.

def _pts(*xs):
    return np.array(xs, dtype=np.float64)


ONE_D = {
    "flat": (jpr1d.FlatPrior(0.01, 10.0, rng=RNG), _pts(-1.0, 0.0, 0.01, 0.5, 10.0, 11.0)),
    "erf": (jpr1d.TwoSidedErf(-1.0, 0.1, 1e3, 1.0, rng=RNG),
            _pts(-1.5, -1.2, -1.0, -0.9, 999.0, 1000.0, 1002.0)),
    "normal": (jpr1d.Normal(1.0, 0.5, rng=RNG), _pts(-1.0, 0.3, 1.0, 2.7)),
    "lognormal": (jpr1d.LogNormal(0.5, 0.1, rng=RNG), _pts(-0.1, 0.0, 1e-3, 0.3, 0.5, 0.9)),
    "lognormal-shift": (jpr1d.LogNormal(3.0, 1.0, rng=RNG, shift=-1.0),
                        _pts(-2.0, -1.0, 0.0, 1.5, 8.0)),
    "sinh": (jpr1d.Sinh(0.2, 0.5, rng=RNG), _pts(-1.0, 0.2, 0.7, 2.0)),
    "truncated": (jpr1d.TruncatedGaussian(0.5, 0.3, 0.0, 1.0, rng=RNG),
                  _pts(-0.5, 0.0, 0.2, 0.5, 1.0, 1.3)),
}

TWO_D = {
    "gba": (jshape.GPriorBA(0.3, rng=RNG),
            (_pts(0.0, 0.1, -0.4, 0.7, 0.9, 1.2), _pts(0.0, -0.2, 0.3, 0.7, 0.5, 0.0))),
    "zdisk": (jshape.ZDisk2D(0.8, rng=RNG), (_pts(0.0, 0.5, 0.7, 1.0), _pts(0.0, 0.5, 0.4, 0.2))),
}


def _jax_grad(fn, x):
    return np.asarray(jax.vmap(jax.grad(fn))(jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(ONE_D))
def test_one_dim_priors_match_jax(name):
    jp, x = ONE_D[name]
    tp = convert.prior_from_object(jp)
    tx = torch.as_tensor(x)
    lnp, dlnp = tp.get_lnprob_device_grad(tx)
    _close(lnp, jp.get_lnprob_device(jnp.asarray(x)), name + " lnp")
    _close(dlnp, _jax_grad(jp.get_lnprob_device, x), name + " d lnp")
    f, df = tp.get_fdiff_device_grad(tx)
    _close(f, jp.get_fdiff_device(jnp.asarray(x)), name + " fdiff")
    _close(df, _jax_grad(jp.get_fdiff_device, x), name + " d fdiff")
    _close(tp.get_lnprob_device(tx), lnp, name)
    _close(tp.get_fdiff_device(tx), f, name)


@pytest.mark.parametrize("name", sorted(TWO_D))
def test_two_dim_priors_match_jax(name):
    jp, (g1, g2) = TWO_D[name]
    tp = convert.prior_from_object(jp)
    t1, t2 = torch.as_tensor(g1), torch.as_tensor(g2)
    lnp, d1, d2 = tp.get_lnprob_device2d_grad(t1, t2)
    _close(lnp, jp.get_lnprob_device2d(jnp.asarray(g1), jnp.asarray(g2)), name + " lnp")
    jd1, jd2 = (np.asarray(x) for x in jax.vmap(jax.grad(jp.get_lnprob_device2d, (0, 1)))(
        jnp.asarray(g1), jnp.asarray(g2)))
    _close(d1, jd1, name + " d/dg1")
    _close(d2, jd2, name + " d/dg2")
    if name == "gba":
        f, f1, f2 = tp.get_fdiff_device_grad(t1, t2)
        _close(f, jp.get_fdiff_device(jnp.asarray(g1), jnp.asarray(g2)), name + " fdiff")
        jf1, jf2 = (np.asarray(x) for x in jax.vmap(jax.grad(jp.get_fdiff_device, (0, 1)))(
            jnp.asarray(g1), jnp.asarray(g2)))
        _close(f1, jf1, name + " d fdiff/dg1")
        _close(f2, jf2, name + " d fdiff/dg2")


def test_cen_prior_matches_jax():
    jp = jpr.CenPrior(0.1, -0.05, 0.263, 0.2, rng=RNG)
    tp = convert.prior_from_object(jp)
    x1, x2 = _pts(-0.3, 0.1, 0.0, 0.4), _pts(0.2, -0.05, 0.0, -0.5)
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
    for (v, d), jfn, i in zip(tp.get_fdiff_device_grad(t1, t2),
                              (lambda a, b: jp.get_fdiff_device(a, b)[0],
                               lambda a, b: jp.get_fdiff_device(a, b)[1]), (0, 1)):
        _close(v, jfn(j1, j2), "cen fdiff %d" % i)
        _close(d, np.asarray(jax.vmap(jax.grad(jfn, i))(j1, j2)), "cen d fdiff %d" % i)
    for (v, d), jfn, i in zip(tp.get_lnprob_device_sep_grad(t1, t2),
                              (lambda a, b: jp.get_lnprob_device_sep(a, b)[0],
                               lambda a, b: jp.get_lnprob_device_sep(a, b)[1]), (0, 1)):
        _close(v, jfn(j1, j2), "cen lnp %d" % i)
        _close(d, np.asarray(jax.vmap(jax.grad(jfn, i))(j1, j2)), "cen d lnp %d" % i)
    _close(tp.get_lnprob_device(t1, t2), jp.get_lnprob_device(j1, j2), "cen lnp")


def test_g_prior_without_device_form_raises():
    tp = convert.prior_from_object(jshape.GPriorGauss(0.3, rng=RNG))
    x = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="over-ride me"):
        tp.get_fdiff_device(x, x)
    joint = tjp.PriorSimpleSep(tpr.CenPrior(0, 0, 1, 1), tp, tpr.FlatPrior(0, 1),
                               tpr.FlatPrior(0, 1))
    with pytest.raises(RuntimeError, match="over-ride me"):
        joint.fill_fdiff_device(torch.zeros((2, 6), dtype=torch.float64))
    with pytest.raises(RuntimeError, match="over-ride me"):
        joint.table()


# ----------------------------------------------------------------------
# (ii) the joint priors, nband 1 and 2

def _joint(kind, nband):
    rng = np.random.RandomState(1)
    cen = jpr.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng)
    g = jpr.GPriorBA(0.2, rng=rng)
    if kind == "simple":
        F = jpr.FlatPrior(1e-4, 1e9, rng=rng)
        return jjp.PriorSimpleSep(cen, g, jpr.TwoSidedErf(-1.0, 0.1, 1e3, 1.0, rng=rng),
                                  F if nband == 1 else [F] * nband)
    if kind == "bdf":
        return get_prior(fit_model="bdf", rng=rng, nband=None if nband == 1 else nband)
    F = [jpr.Sinh(100.0, 50.0, rng=rng), jpr.TruncatedGaussian(100.0, 30.0, 0.0, 1e3, rng=rng)]
    return jjp.PriorBDSep(cen, g, jpr.Normal(1.0, 0.5, rng=rng), jpr.Sinh(0.0, 0.5, rng=rng),
                          jpr.TruncatedGaussian(0.5, 0.3, 0.0, 1.0, rng=rng),
                          F[0] if nband == 1 else F[:nband])


def _joint_pars(kind, nband, n=8):
    rng = np.random.RandomState(2)
    nshape = {"simple": 5, "bdf": 6, "bd": 7}[kind]
    x = rng.uniform(-0.3, 0.3, (n, nshape + nband))
    x[:, 4] = rng.uniform(-1.3, 2.0, n)
    if kind == "bd":
        x[:, 6] = rng.uniform(-0.2, 1.2, n)
    elif kind == "bdf":
        x[:, 5] = rng.uniform(-0.2, 1.0, n)
    x[:, nshape:] = rng.uniform(-5.0, 300.0, (n, nband))
    # a lane at the prior's centre (chi2 = 0 rows), one outside |g| < 1
    x[0, :4] = 0.0
    x[1, 2:4] = (0.9, 0.6)
    return x


@pytest.mark.parametrize("nband", [1, 2])
@pytest.mark.parametrize("kind", ["simple", "bdf", "bd"])
def test_joint_priors_match_jax(kind, nband):
    jp = _joint(kind, nband)
    tp = convert.prior_from_object(jp)
    assert type(tp).__name__ == type(jp).__name__
    assert (tp.nband, tp.n_prior_pars, tp.bounds) == (jp.nband, jp.n_prior_pars, jp.bounds)
    x = _joint_pars(kind, nband)
    rows, jac = tp.fill_fdiff_jacobian(torch.as_tensor(x))
    jx = jnp.asarray(x)
    _close(rows, jax.vmap(jp.fill_fdiff_device)(jx), kind + " rows")
    _close(jac, jax.vmap(jax.jacfwd(jp.fill_fdiff_device))(jx), kind + " jacobian")
    _close(tp.fill_fdiff_device(torch.as_tensor(x)), rows, kind)
    assert tuple(tp.table().shape) == (tp.n_prior_pars, tjp.TABLE_COLS)
    # the prior rows of the solver: an infinite row makes Jtr nan, as in
    # the reference's Jp * rows
    r, jp_ = rows, jac
    jtr = tlm._row_sum(jp_ * r[..., None])
    assert bool(torch.isnan(jtr[torch.isinf(r).any(-1)]).all())


# ----------------------------------------------------------------------
# (iii) the converter

def test_prior_from_object_converts_each_class():
    rng = np.random.RandomState(3)
    objs = [jpr.FlatPrior(1.0, 2.0, rng=rng), jpr.TwoSidedErf(-1.0, 0.1, 3.0, 0.2, rng=rng),
            jpr.Normal(1.0, 2.0, rng=rng, bounds=(0.0, 3.0)), jpr.LogNormal(2.0, 0.5, rng=rng),
            jpr.LogNormal(2.0, 0.5, rng=rng, shift=0.25), jpr.Sinh(1.0, 3.0, rng=rng),
            jpr.TruncatedGaussian(1.0, 2.0, -1.0, 4.0, rng=rng),
            jpr.GPriorBA(0.25, rng=rng, A=2.0), jpr.GPriorGauss(0.3, rng=rng),
            jpr.ZDisk2D(0.7, rng=rng), jpr.CenPrior(0.1, 0.2, 0.3, 0.4, rng=rng)]
    attrs = ("minval", "maxval", "width_at_min", "width_at_max", "mean", "sigma", "sinv",
             "s2inv", "bounds", "shift", "logmean", "logivar", "lnprob_max", "mode", "scale",
             "ivar", "A", "sig2inv", "radius_sq", "cen1", "cen2", "sinv1", "s2inv2")
    for o in objs:
        t = convert.prior_from_object(o)
        assert type(t).__name__ == type(o).__name__
        for a in attrs:
            if hasattr(o, a):
                want = getattr(o, a)
                got = getattr(t, a)
                if want is None:
                    assert got is None, (o, a)
                else:
                    np.testing.assert_allclose(np.asarray(got, dtype=float),
                                               np.asarray(want, dtype=float), rtol=1e-15,
                                               err_msg=(type(o).__name__, a))
    for kind, nband in (("simple", 2), ("bdf", 1), ("bd", 2)):
        t = convert.prior_from_object(_joint(kind, nband))
        assert isinstance(t, tjp.PRIORS) and t.nband == nband
    # LMBounds and the galsim joint prior convert since they were ported
    lmb = convert.prior_from_object(jpr.LMBounds(0.0, 1.0, rng=rng))
    assert type(lmb).__name__ == "LMBounds" and lmb.bounds == (0.0, 1.0)
    gal = convert.prior_from_object(jjp.PriorGalsimSimpleSep(objs[-1], objs[7], objs[0],
                                                             objs[0]))
    assert isinstance(gal, tjp.PriorGalsimSimpleSep) and gal.r50_prior is gal.T_prior
    for bad in (object(), jpr.Bounded1D(objs[0], (1.0, 2.0))):
        with pytest.raises(TypeError, match="PriorBDFSep.*PriorSimpleSep"):
            convert.prior_from_object(bad)


# ----------------------------------------------------------------------
# (iv) the pipelines against the JAX package, and (v) fault 3.3

# the reference test's prior and box (tests/test_batch_pipeline.py:389-397)
BOX = ([-1.0, -1.0, -0.99, -0.99, 0.01, 1e-4], [1.0, 1.0, 0.99, 0.99, 10.0, 1e9])
# the production bdf box (sims.BDF_LM_BOUNDS)
BDF_BOX = tuple(list(x) for x in nt.sims.BDF_LM_BOUNDS)
LM_KEYS = ("pars", "pars_err", "pars_cov", "e1", "e2", "T", "flux", "s2n")


def _simple_prior(sigma_cen=SCALE, F_max=1e9, nband=1):
    rng = np.random.RandomState(3)
    F = jpr.FlatPrior(1e-4, F_max, rng=rng)
    return jjp.PriorSimpleSep(cen_prior=jpr.CenPrior(0.0, 0.0, sigma_cen, sigma_cen, rng=rng),
                              g_prior=jpr.GPriorBA(0.3, rng=rng),
                              T_prior=jpr.FlatPrior(0.01, 10.0, rng=rng),
                              F_prior=F if nband == 1 else [F] * nband)


def _assert_lm_match(tres, jres, types=jbatch.GALSHEAR_TYPES, keys=LM_KEYS):
    for t in types:
        for k in ("flags", "nfev", "ier"):
            np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
        for k in keys:
            np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                       err_msg=(t, k))
        assert np.all(tres[t]["flags"] == 0)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _flat(inputs, measure, box, jprior, k1_route):
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **EXP_LM_CONF)
    with pytest.MonkeyPatch.context() as mp:
        if k1_route:
            mp.setattr(jbatch, "_exp_lm_measure", functools.partial(
                jbatch._exp_lm_measure, use_pallas=True, interpret=True))
        jres = jax.tree.map(np.asarray, jbatch.make_metacal_pipeline_fn(
            jconf, measure=measure, lm_prior=jprior,
            lm_bounds=tuple(map(jnp.asarray, box)))(*map(jnp.asarray, inputs)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_fn(
        convert.config_from_fields(jconf), measure=measure, lm_bounds=box,
        lm_prior=convert.prior_from_object(jprior), device="cpu")(*inputs))
    return tres, jres


FLAT_CASES = {
    "exp-lm": ("exp-lm", BOX, _simple_prior, True),
    "bdf-lm": ("bdf-lm", BDF_BOX,
               lambda: get_prior(fit_model="bdf", rng=np.random.RandomState(4)), False),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_prior_pipeline_matches_jax(inputs, case):
    measure, box, make_prior, k1_route = FLAT_CASES[case]
    tres, jres = _flat(inputs, measure, box, make_prior(), k1_route)
    _assert_lm_match(tres, jres)
    pars = tres["noshear"]["pars"]
    assert np.all((pars > np.asarray(box[0])) & (pars < np.asarray(box[1])))
    if measure == "bdf-lm":
        np.testing.assert_allclose(tres["noshear"]["fracdev"], jres["noshear"]["fracdev"],
                                   rtol=1e-8, atol=1e-10)


def test_covariance_scales_by_the_pixel_cost(inputs):
    """ROADMAP fault 3.3: with CenPrior sigma = 0.1 the prior rows are
    far from 0, and pars_cov, scaled by cost_pix / dof, matches the
    reference to rtol 1e-8, while the covariance scaled by cost / dof
    (cost with the prior rows) misses it by far more"""
    lo, hi = [-2, -2, -0.99, -0.99, 0.011, 1e-3], [2, 2, 0.99, 0.99, 9.9, 1e3]
    tres, jres = _flat(inputs, "exp-lm", (lo, hi), _simple_prior(0.1, 1e4), True)
    _assert_lm_match(tres, jres)
    t, j = tres["noshear"], jres["noshear"]
    dof = 19 * 19 - 6
    cost_pix = t["s_sq"] * dof
    assert np.all(t["cost"] / cost_pix - 1 > 1e-4)
    by_cost = t["pars_cov"] * (t["cost"] / cost_pix)[:, None, None]
    # the share of the tolerance each lane's worst entry takes
    share = np.abs(by_cost - j["pars_cov"]) / (1e-10 + 1e-8 * np.abs(j["pars_cov"]))
    assert np.all(share.max(axis=(-2, -1)) > 1)


def test_mb_prior_pipeline_matches_jax():
    """the mb pipeline with gauss-lm, a prior of two flux slots and the
    reference test's box (tests/test_batch_pipeline.py:193-218)"""
    eps = [_inputs(seed) for seed in (31, 32)]
    args = tuple(np.stack([ep[i][:4] for ep in eps], axis=1) for i in range(6))
    band = np.array([0, 1], np.int32)
    box = ([-1.0, -1.0, -0.99, -0.99, 0.001, 0.001, 0.001],
           [1.0, 1.0, 0.99, 0.99, 100.0, 1.0e5, 1.0e5])
    jprior = _simple_prior(F_max=1e5, nband=2)
    jres = jax.tree.map(np.asarray, jax.jit(lambda *a: jbatch.metacal_pipeline_mb(
        *a, jnp.asarray(band), 2, MB_JCONF, measure="gauss-lm", objective="epoch",
        lm_prior=jprior, lm_bounds=tuple(map(jnp.asarray, box))))(*map(jnp.asarray, args)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_mb_fn(
        convert.config_from_fields(MB_JCONF), band, 2, measure="gauss-lm", lm_prior=jprior,
        lm_bounds=box, device="cpu")(*args))
    _assert_lm_match(tres, jres, keys=LM_KEYS + ("s2n_flux",))
    assert tres["noshear"]["pars"].shape == (4, 7)


# ----------------------------------------------------------------------
# the solver and the kernels' wrappers

def test_no_prior_keeps_cost_pix_equal_to_cost():
    guess, lo, hi, psf, v, u, ia, ve = _small_args()
    state = lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, tlm.LMConf(maxfev=5))
    torch.testing.assert_close(state["cost_pix"], state["cost"], rtol=0, atol=0)


def test_cuda_tensors_pass_the_prior_table(monkeypatch):
    """a CUDA tensor launches K3 or K3-mb once with the prior's table
    and its rows, never the plain version; a prior whose slots do not
    match the fit raises ValueError on every device"""
    calls = _mock_card(monkeypatch, 0)
    lib = nt.ops._build.load()
    for dt in (torch.float32, torch.float64):
        setattr(lib, lm_solve.c_name("lm_solve_mb", "exp", dt),
                lambda *a: calls.append(("mb", a)) or 0)
    monkeypatch.setattr(lm_solve, "lm_solve_mb_plain", None)
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    monkeypatch.setattr(tjp.PriorSimpleSep, "table",
                        lambda self, f=tjp.PriorSimpleSep.table: _fake_cuda(f(self)))
    prior = convert.prior_from_object(_simple_prior())
    args = [_fake_cuda(x) for x in _small_args()]
    out = lm_solve.lm_solve(*args, tlm.LMConf(), "exp", prior)
    c = calls[-1]
    assert c[8:19] == tuple(x.data_ptr() for x in out.values())
    assert c[20] is not None and c[21:24] == (3, 50, 5)
    assert lm_solve.launches == 1
    lm_solve.lm_solve(*args, tlm.LMConf(), "exp")
    assert calls[-1][20] is None and calls[-1][23] == 0
    g = torch.cat([args[0], args[0][:, -1:]], 1)
    f64 = dict(dtype=torch.float64)
    mb = [_fake_cuda(x) for x in (g, torch.full((7,), -INF, **f64), torch.full((7,), INF, **f64),
                                  torch.full((3, 2, 3), 0.05, **f64))]
    planes = [_fake_cuda(torch.ones((3, 2, 50), dtype=torch.float64)) for _ in range(4)]
    band = _fake_cuda(torch.tensor([0, 1], dtype=torch.int32))
    prior2 = convert.prior_from_object(_simple_prior(nband=2))
    lm_solve.lm_solve_mb(*mb, band, *planes, tlm.LMConf(), "exp", prior2)
    _, c = calls[-1]
    assert c[21] is not None and c[22:27] == (3, 2, 50, 2, 6)
    assert lm_solve.launches_mb == 1
    for device_args in (args, _small_args()):
        with pytest.raises(ValueError, match="parameter slots"):
            lm_solve.lm_solve(*device_args, tlm.LMConf(), "exp", prior2)
    with pytest.raises(ValueError, match="parameter slots"):
        lm_solve.lm_solve_mb(*mb, band, *planes, tlm.LMConf(), "exp", prior)
    with pytest.raises(TypeError, match="joint priors"):
        lm_solve.lm_solve(*args, tlm.LMConf(), "exp", _simple_prior())
    assert lm_solve.launches == 2 and lm_solve.launches_mb == 1


def test_pipeline_checks_the_prior(inputs):
    conf = convert.config_from_fields(jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS,
                                                           **EXP_LM_CONF))
    with pytest.raises(ValueError, match="parameter slots"):
        nt.make_metacal_pipeline_fn(conf, measure="bdf-lm", device="cpu",
                                    lm_prior=_simple_prior())
    with pytest.raises(TypeError, match="ported priors"):
        tbatch._check_measure(conf, "exp-lm", None, object(), None)
    with pytest.raises(TypeError, match="joint priors"):
        tbatch._check_measure(conf, "exp-lm", None, jpr.FlatPrior(0, 1, rng=RNG), None)
    # the moments measures take no prior
    assert tbatch._check_measure(conf, "gaussmom", None, object(), None) is None
