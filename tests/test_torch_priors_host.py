"""The host API of the PyTorch port's priors (ngmix_tpu_torch/priors,
joint_prior.py) and LMBounds in the LM, against the JAX package on the
same numpy inputs.

Tolerances:
- host values, arrays and fdiffs (get_lnprob_*, get_prob_*,
  get_lnprob_array2d, get_fdiff, the joint priors' fill_fdiff and
  get_widths): rtol 1e-12, with LOWVAL, inf and nan in the same places
  and GMixRangeError where the reference raises;
- samples from a generator in the same state (sample, sample_brute,
  sample2d_brute, Bounded1D, the joint priors' sample, PriorCoellipSame's
  included): equal;
- LogNormal.fit, GPriorBA.fit and set_maxval1d: rtol 1e-8;
- the pipelines with an LMBounds joint prior (exp-lm flat on the JAX
  package's K1 route, gauss-lm mb on its "epoch" objective): flags,
  nfev and ier equal, every field to rtol 1e-8 and atol 1e-10 per lane,
  as tests/test_torch_priors.py holds the other priors.

K3's row of the new kind runs only on the card (chip_smoke.py, phase
29); here a mocked card checks that the wrapper passes the table with
that kind and launches once a call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch, joint_prior as jjp, priors as jpr
from ngmix_tpu.gexceptions import GMixRangeError as JRangeError

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, joint_prior as tjp, priors as tpr
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.gexceptions import GMixRangeError
from ngmix_tpu_torch.ops import lm_solve
from ngmix_tpu_torch.priors import priors as tpr1d

from test_torch_lm_solve import _fake_cuda, _mock_card, _small_args
from test_torch_mb import JCONF as MB_JCONF
from test_torch_pipeline import DIMS, EXP_LM_CONF, PSF_DIMS, _inputs

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

RTOL = 1e-12


def _close(port, ref, what, rtol=RTOL):
    port, ref = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=what)
    np.testing.assert_array_equal(port[np.isinf(ref)], ref[np.isinf(ref)], err_msg=what)
    ok = np.isfinite(ref)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=rtol, atol=0, err_msg=what)


def _both(make):
    """(JAX prior, the port's) from one constructor of the JAX package's
    priors module, each generator a RandomState(5)"""
    jp = make(jpr, np.random.RandomState(5))
    return jp, convert.prior_from_object(jp)


# the 1-d priors, points inside their support and (for the priors that
# raise) outside
ONE_D = {
    "flat": (lambda m, r: m.FlatPrior(-1.0, 3.0, rng=r), [-0.5, 0.0, 2.9], [3.5]),
    "erf": (lambda m, r: m.TwoSidedErf(0.0, 0.3, 5.0, 0.7, rng=r),
            [-0.4, 0.05, 2.0, 5.1, 6.0], []),
    "normal": (lambda m, r: m.Normal(1.0, 2.0, rng=r), [-3.0, 1.0, 4.5], []),
    "lognormal": (lambda m, r: m.LogNormal(1.5, 0.4, rng=r), [0.2, 1.0, 3.7], [-0.5]),
    "lognormal shift": (lambda m, r: m.LogNormal(1.5, 0.4, rng=r, shift=-0.3),
                        [-0.1, 1.0, 2.2], [-0.4]),
    "sinh": (lambda m, r: m.Sinh(1.0, 0.5, rng=r), [0.2, 1.0, 1.7], []),
    "trunc": (lambda m, r: m.TruncatedGaussian(0.1, 1.0, -2.0, 2.0, rng=r),
              [-1.5, 0.1, 1.9], [2.5]),
    "lmbounds": (lambda m, r: m.LMBounds(-1.0, 3.0, rng=r), [-0.5, 0.0, 2.5], []),
}
METHODS = ("get_lnprob_scalar", "get_prob_scalar", "get_fdiff", "get_lnprob",
           "get_prob")
ARRAY_METHODS = ("get_lnprob_array", "get_prob_array")


@pytest.mark.parametrize("name", sorted(ONE_D))
def test_one_dim_host_methods_match_jax(name):
    make, inside, outside = ONE_D[name]
    jp, tp = _both(make)
    meths = [m for m in METHODS if hasattr(jp, m)]
    assert len(meths) >= 2
    for meth in meths:
        for x in inside:
            _close(getattr(tp, meth)(x), getattr(jp, meth)(x), (name, meth, x))
        for x in outside:
            with pytest.raises(JRangeError):
                getattr(jp, meth)(x)
            with pytest.raises(GMixRangeError):
                getattr(tp, meth)(x)
    xs = np.array(inside)
    for meth in ARRAY_METHODS:
        if hasattr(jp, meth):
            _close(getattr(tp, meth)(xs), getattr(jp, meth)(xs), (name, meth))
    if name == "erf":
        _close(tp.get_fdiff(xs), jp.get_fdiff(xs), (name, "fdiff array"))
    if name == "trunc":
        xs = np.array(inside + outside)
        _close(tp.get_lnprob_array(xs), jp.get_lnprob_array(xs), (name, "outside"))


SAMPLED = {
    "flat": lambda m, r: m.FlatPrior(-1.0, 3.0, rng=r),
    "erf": lambda m, r: m.TwoSidedErf(0.0, 0.3, 5.0, 0.7, rng=r),
    "normal": lambda m, r: m.Normal(1.0, 2.0, rng=r),
    "lognormal": lambda m, r: m.LogNormal(1.5, 0.4, rng=r),
    "sinh": lambda m, r: m.Sinh(1.0, 0.5, rng=r),
    "trunc": lambda m, r: m.TruncatedGaussian(0.1, 1.0, -2.0, 2.0, rng=r),
    "lmbounds": lambda m, r: m.LMBounds(-1.0, 3.0, rng=r),
    "bounded1d": lambda m, r: m.Bounded1D(m.Normal(0.0, 1.0, rng=r), (-0.5, 1.5)),
    "limitpdf": lambda m, r: m.LimitPDF(m.LogNormal(1.0, 0.5, rng=r), [0.5, 1.2]),
}


@pytest.mark.parametrize("name", sorted(SAMPLED))
def test_samples_equal_jax(name):
    jp = SAMPLED[name](jpr, np.random.RandomState(17))
    tp = SAMPLED[name](tpr, np.random.RandomState(17))
    for n in (None, 1, 257):
        np.testing.assert_array_equal(tp.sample(n), jp.sample(n), err_msg=(name, n))
    if name == "lmbounds":
        assert tp.has_bounds() and tp.bounds == jp.bounds == (-1.0, 3.0)
        assert (tp.mean, tp.sigma) == (jp.mean, jp.sigma)
    if name in ("bounded1d", "limitpdf"):
        assert tp.bounds == tp.limits == jp.bounds
        with pytest.raises(ValueError):
            tpr.Bounded1D(tp.pdf, (1.0, 0.0))
        with pytest.raises(ValueError):
            tpr.Bounded1D(tp.pdf, 1.0)


def test_lognormal_sample_brute_and_fit_match_jax():
    for shift in (None, 2.0):
        jp = jpr.LogNormal(4.0, 1.0, rng=np.random.RandomState(5), shift=shift)
        tp = tpr.LogNormal(4.0, 1.0, rng=np.random.RandomState(5), shift=shift)
        np.testing.assert_array_equal(tp.sample_brute(2000), jp.sample_brute(2000))
        np.testing.assert_array_equal(tp.sample_brute(), jp.sample_brute())
    truth = jpr.LogNormal(3.0, 0.7, rng=np.random.RandomState(7))
    x = np.linspace(0.5, 8.0, 200)
    y = 5.0 * truth.get_prob_array(x)
    jres = jpr.LogNormal(1.0, 1.0, rng=np.random.RandomState(8)).fit(x, y)
    tres = tpr.LogNormal(1.0, 1.0, rng=np.random.RandomState(8)).fit(x, y)
    assert tres["flags"] == jres["flags"] == 0
    np.testing.assert_allclose(tres["pars"], jres["pars"], rtol=1e-8)
    np.testing.assert_allclose(tres["pars"][:2], [3.0, 0.7], rtol=1e-3)


def test_shape_priors_host_methods_match_jax():
    g1 = np.array([0.0, 0.3, -0.5, 0.7, 0.9])
    g2 = np.array([0.0, -0.2, 0.4, 0.7, 0.1])
    jp, tp = _both(lambda m, r: m.GPriorBA(0.3, rng=r, A=1.7))
    _close(tp.get_prob_array2d(g1, g2), jp.get_prob_array2d(g1, g2), "prob2d")
    _close(tp.get_lnprob_array2d(g1, g2), jp.get_lnprob_array2d(g1, g2), "lnprob2d")
    _close(tp.get_fdiff(g1, g2), jp.get_fdiff(g1, g2), "fdiff array")
    _close(tp.get_fdiff(0.3, -0.2), jp.get_fdiff(0.3, -0.2), "fdiff")
    with pytest.raises(GMixRangeError):
        tp.get_fdiff(0.9, 0.9)
    _close(tp.get_prob_array1d(np.abs(g1)), jp.get_prob_array1d(np.abs(g1)), "prob1d")
    jz, tz = _both(lambda m, r: m.ZDisk2D(0.8, rng=r))
    _close(tz.get_prob_array2d(g1, g2), jz.get_prob_array2d(g1, g2), "zdisk prob2d")
    for r in (0.1, 0.8, 0.9):
        assert tz.get_prob_scalar1d(r) == jz.get_prob_scalar1d(r)
    jc, tc = _both(lambda m, r: m.CenPrior(0.1, -0.1, 0.5, 0.7, rng=r))
    for meth in ("get_fdiff", "get_lnprob_scalar_sep", "get_prob_scalar", "get_prob_array",
                 "get_lnprob_array", "get_lnprob_scalar"):
        _close(getattr(tc, meth)(g1, g2), getattr(jc, meth)(g1, g2), meth)
        _close(getattr(tc, meth)(0.6, -0.1), getattr(jc, meth)(0.6, -0.1), meth)


def test_gprior_fit_sampling_and_max_match_jax():
    truth = jpr.GPriorBA(0.3, rng=np.random.RandomState(9), A=2.0)
    g = np.linspace(0.005, 0.985, 150)
    p = truth.get_prob_array1d(g)
    for guess, seed in (([1.5, 0.25], 10), (None, 11)):
        jf = jpr.GPriorBA(0.2, rng=np.random.RandomState(seed))
        tf = tpr.GPriorBA(0.2, rng=np.random.RandomState(seed))
        jres, tres = jf.fit(g, p, guess=guess), tf.fit(g, p, guess=guess)
        assert tres["flags"] == jres["flags"] == 0
        for k in ("pars", "pars_cov", "pars_err"):
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-8, err_msg=k)
        np.testing.assert_allclose(tf.pars, jf.pars, rtol=1e-8)
        np.testing.assert_allclose(tf.pars, [2.0, 0.3], rtol=1e-4)
    jp, tp = _both(lambda m, r: m.GPriorBA(0.3, rng=r, A=2.0))
    for a, b in zip(tp.sample2d_brute(500), jp.sample2d_brute(500)):
        np.testing.assert_array_equal(a, b)
    jp.set_maxval1d()
    tp.set_maxval1d()
    np.testing.assert_allclose([tp.maxval1d, tp.maxval1d_loc],
                               [jp.maxval1d, jp.maxval1d_loc], rtol=1e-8)


# ----------------------------------------------------------------------
# the joint priors' host API

def _cen_g(m, r):
    return m.CenPrior(0.0, 0.0, 0.263, 0.263, rng=r), m.GPriorBA(0.3, rng=r)


JOINT = {
    "simple lmbounds": (lambda m, r: m.joint.PriorSimpleSep(
        *_cen_g(m, r), m.LMBounds(0.01, 10.0, rng=r), m.LMBounds(1e-3, 1e4, rng=r)), 6),
    "simple 2 bands": (lambda m, r: m.joint.PriorSimpleSep(
        *_cen_g(m, r), m.TwoSidedErf(-1.0, 0.1, 100.0, 1.0, rng=r),
        [m.LMBounds(1e-3, 1e4, rng=r), m.TwoSidedErf(-1.0, 0.1, 1e5, 1.0, rng=r)]), 7),
    "bdf lmbounds": (lambda m, r: m.joint.PriorBDFSep(
        *_cen_g(m, r), m.TwoSidedErf(-1.0, 0.1, 100.0, 1.0, rng=r),
        m.LogNormal(0.5, 0.1, rng=r), m.LMBounds(1e-3, 1e4, rng=r)), 7),
    "bd": (lambda m, r: m.joint.PriorBDSep(
        *_cen_g(m, r), m.TwoSidedErf(-1.0, 0.1, 100.0, 1.0, rng=r),
        m.Normal(0.0, 0.3, rng=r), m.LogNormal(0.5, 0.1, rng=r),
        m.TwoSidedErf(-1.0, 0.1, 1e5, 1.0, rng=r)), 8),
    "galsim": (lambda m, r: m.joint.PriorGalsimSimpleSep(
        *_cen_g(m, r), m.FlatPrior(0.01, 5.0, rng=r), m.LMBounds(1e-3, 1e4, rng=r)), 6),
    "spergel": (lambda m, r: m.joint.PriorSpergelSep(
        *_cen_g(m, r), m.FlatPrior(0.01, 5.0, rng=r), m.FlatPrior(-0.8, 3.5, rng=r),
        m.TwoSidedErf(-1.0, 0.1, 1e5, 1.0, rng=r)), 7),
    "coellip": (lambda m, r: m.joint.PriorCoellipSame(
        3, *_cen_g(m, r), m.TwoSidedErf(-1.0, 0.1, 100.0, 1.0, rng=r),
        m.LMBounds(1e-3, 1e4, rng=r)), 10),
}


class _Mod:
    """a priors module and its package's joint priors under one name"""

    def __init__(self, priors, joint):
        self.__dict__.update(vars(priors))
        self.joint = joint


JMOD, TMOD = _Mod(jpr, jjp), _Mod(tpr, tjp)


def _joint_pars(npars, n=6):
    """parameter vectors inside every joint prior's support"""
    rng = np.random.RandomState(23)
    p = np.zeros((n, npars))
    p[:, :2] = rng.normal(scale=0.2, size=(n, 2))
    p[:, 2:4] = rng.uniform(-0.4, 0.4, size=(n, 2))
    p[:, 4:] = rng.uniform(0.3, 0.9, size=(n, npars - 4))
    return p


@pytest.mark.parametrize("name", sorted(JOINT))
def test_joint_priors_host_api_matches_jax(name):
    make, npars = JOINT[name]
    jp = make(JMOD, np.random.RandomState(31))
    tp = convert.prior_from_object(jp)
    assert type(tp).__name__ == type(jp).__name__
    assert isinstance(tp, getattr(tjp, type(jp).__name__).__mro__[1])
    assert tp.npars == npars and tp.n_prior_pars == jp.n_prior_pars
    assert tp.bounds == jp.bounds
    pars = _joint_pars(npars)
    _close(tp.get_lnprob_array(pars), jp.get_lnprob_array(pars), "lnprob array")
    _close(tp.get_prob_array(pars), jp.get_prob_array(pars), "prob array")
    for x in pars[:3]:
        _close(tp.get_lnprob_scalar(x), jp.get_lnprob_scalar(x), "lnprob")
        _close(tp.get_prob_scalar(x), jp.get_prob_scalar(x), "prob")
        jf, tf = np.zeros(20), np.zeros(20)
        assert tp.fill_fdiff(x, tf) == jp.fill_fdiff(x, jf) == jp.n_prior_pars
        _close(tf, jf, "fill_fdiff")
        _close(tp.get_lnprob_scalar_device(torch.as_tensor(x)),
               jp.get_lnprob_scalar_device(jnp.asarray(x)), "lnprob device")
    np.testing.assert_array_equal(tp.sample(), jp.sample())
    np.testing.assert_array_equal(tp.sample(33), jp.sample(33))
    np.testing.assert_array_equal(tp.get_widths(200), jp.get_widths(200))
    if name == "coellip":
        with pytest.raises(ValueError, match="pars size"):
            tp.get_lnprob_scalar(pars[0, :6])
        with pytest.raises(ValueError, match="one band"):
            tjp.PriorCoellipSame(2, tp.cen_prior, tp.g_prior, tp.T_prior,
                                 [tp.F_priors[0]] * 2)


def test_lmbounds_rows_and_table():
    """LMBounds gives a row of 0 with derivative 0 in both forms, its
    own kind in the kernels' table (never the flat kind), and the joint
    priors pass its bounds to the fit"""
    tp = convert.prior_from_object(JOINT["simple lmbounds"][0](JMOD, np.random.RandomState(3)))
    tab = tp.table()
    assert tab[3:, 0].tolist() == [tpr1d.LMBOUNDS] * 2 and tpr1d.LMBOUNDS != tpr1d.FLAT
    x = torch.as_tensor(_joint_pars(6))
    x[0, 4] = 50.0  # outside the box: still 0, where a flat prior is inf
    rows, jac = tp.fill_fdiff_jacobian(x)
    assert torch.all(rows[:, 3:] == 0) and torch.all(jac[:, 3:] == 0)
    assert tp.bounds[4:] == [(0.01, 10.0), (1e-3, 1e4)]
    bdf = convert.prior_from_object(JOINT["bdf lmbounds"][0](JMOD, np.random.RandomState(3)))
    rows, jac = bdf.fill_fdiff_jacobian(torch.as_tensor(_joint_pars(7)))
    assert torch.all(rows[:, 5] == 0) and torch.all(jac[:, 5] == 0)
    assert bdf.table()[5, :2].tolist() == [tpr1d.LMBOUNDS, tpr1d.FORM_FDIFF]


# ----------------------------------------------------------------------
# LMBounds through the plain K3 and K3-mb solves against the JAX
# package's batched lm_prior

BOX = ([-1.0, -1.0, -0.99, -0.99, 0.01, 1e-4], [1.0, 1.0, 0.99, 0.99, 10.0, 1e9])
LM_KEYS = ("pars", "pars_err", "pars_cov", "e1", "e2", "T", "flux", "s2n")


def _lmb_prior(nband=1):
    rng = np.random.RandomState(3)
    F = jpr.LMBounds(1e-4, 1e9, rng=rng)
    return jjp.PriorSimpleSep(cen_prior=jpr.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng),
                              g_prior=jpr.GPriorBA(0.3, rng=rng),
                              T_prior=jpr.LMBounds(0.01, 10.0, rng=rng),
                              F_prior=F if nband == 1 else [F] * nband)


def _assert_lm_match(tres, jres, keys=LM_KEYS):
    for t in jbatch.GALSHEAR_TYPES:
        for k in ("flags", "nfev", "ier"):
            np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
        for k in keys:
            np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                       err_msg=(t, k))
        assert np.all(tres[t]["flags"] == 0)


def test_lmbounds_flat_pipeline_matches_jax():
    inputs = _inputs()
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **EXP_LM_CONF)
    jprior = _lmb_prior()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatch, "_exp_lm_measure", functools.partial(
            jbatch._exp_lm_measure, use_pallas=True, interpret=True))
        jres = jax.tree.map(np.asarray, jbatch.make_metacal_pipeline_fn(
            jconf, measure="exp-lm", lm_prior=jprior,
            lm_bounds=tuple(map(jnp.asarray, BOX)))(*map(jnp.asarray, inputs)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_fn(
        convert.config_from_fields(jconf), measure="exp-lm", lm_bounds=BOX,
        lm_prior=convert.prior_from_object(jprior), device="cpu")(*inputs))
    _assert_lm_match(tres, jres)


def test_lmbounds_mb_pipeline_matches_jax():
    eps = [_inputs(seed) for seed in (31, 32)]
    args = tuple(np.stack([ep[i][:4] for ep in eps], axis=1) for i in range(6))
    band = np.array([0, 1], np.int32)
    box = ([-1.0, -1.0, -0.99, -0.99, 0.001, 0.001, 0.001],
           [1.0, 1.0, 0.99, 0.99, 100.0, 1.0e5, 1.0e5])
    jprior = _lmb_prior(nband=2)
    jres = jax.tree.map(np.asarray, jax.jit(lambda *a: jbatch.metacal_pipeline_mb(
        *a, jnp.asarray(band), 2, MB_JCONF, measure="gauss-lm", objective="epoch",
        lm_prior=jprior, lm_bounds=tuple(map(jnp.asarray, box))))(*map(jnp.asarray, args)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_mb_fn(
        convert.config_from_fields(MB_JCONF), band, 2, measure="gauss-lm", lm_prior=jprior,
        lm_bounds=box, device="cpu")(*args))
    _assert_lm_match(tres, jres, keys=LM_KEYS + ("s2n_flux",))


def test_cuda_tensors_launch_k3_once_with_the_lmbounds_kind(monkeypatch):
    """on a mocked card K3 and K3-mb launch once a call with the table of
    an LMBounds joint prior, whose rows carry the LMBounds kind"""
    calls = _mock_card(monkeypatch, 0)
    lib = nt.ops._build.load()
    for dt in (torch.float32, torch.float64):
        setattr(lib, lm_solve.c_name("lm_solve_mb", "exp", dt),
                lambda *a: calls.append(("mb", a)) or 0)
    monkeypatch.setattr(lm_solve, "lm_solve_mb_plain", None)
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    tables = []

    def table(self, f=tjp.PriorSimpleSep.table):
        tab = f(self)
        tables.append(tab)
        return _fake_cuda(tab)

    monkeypatch.setattr(tjp.PriorSimpleSep, "table", table)
    prior = convert.prior_from_object(_lmb_prior())
    args = [_fake_cuda(x) for x in _small_args()]
    lm_solve.lm_solve(*args, tlm.LMConf(), "exp", prior)
    assert lm_solve.launches == 1
    assert calls[-1][20] is not None and calls[-1][23] == 5
    assert tables[-1][3:, 0].tolist() == [tpr1d.LMBOUNDS] * 2
    f64 = dict(dtype=torch.float64)
    g = torch.cat([args[0], args[0][:, -1:]], 1)
    mb = [_fake_cuda(x) for x in (g, torch.full((7,), -np.inf, **f64),
                                  torch.full((7,), np.inf, **f64),
                                  torch.full((3, 2, 3), 0.05, **f64))]
    planes = [_fake_cuda(torch.ones((3, 2, 50), **f64)) for _ in range(4)]
    band = _fake_cuda(torch.tensor([0, 1], dtype=torch.int32))
    lm_solve.lm_solve_mb(*mb, band, *planes, tlm.LMConf(), "exp",
                         convert.prior_from_object(_lmb_prior(nband=2)))
    assert lm_solve.launches_mb == 1 and calls[-1][1][26] == 6
    assert tables[-1][3:, 0].tolist() == [tpr1d.LMBOUNDS] * 3
