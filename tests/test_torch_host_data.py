"""The host data model of the PyTorch port against ngmix_tpu, on the same
numpy inputs: the exceptions, print_pars, fexp, the shape and moment
conversions, Shape, Jacobian, the pixel structs, the mixture fills and
statistics, GMix and its models, the observation containers and their
traversal, and the converters of convert.py. The port runs with
device="cpu", where K2 is its plain version.

Tolerances: renders and mixture data rtol 1e-12 (the North star's
mixture tolerance, tests/test_misc_components.py:135) with an atol of
1e-12 of the largest value; the s/n and moment sums over an
observation rtol 1e-10 and atol 1e-12 (the gaussmom tolerance); the
elementwise conversions rtol 1e-12.

The JAX side of the pixel-grid evaluations runs the JAX package's
functions under jax.jit (one compile a case; eagerly each operation
compiles on its own): the functions that its GMix and Observation
methods call on the same arrays.
"""
import io

import jax
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import containers as jcontainers, moments as jmoments, shape as jshape
from ngmix_tpu import util as jutil
from ngmix_tpu.gmix import core as jcore

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import containers, convert, moments, shape, util
from ngmix_tpu_torch.gmix import core as tcore
from ngmix_tpu_torch.jacobian import diagonal_jac, jac_from_arrays
from ngmix_tpu_torch.ops import gmix_eval
from ngmix_tpu_torch.pixels import make_coords, make_pixels

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

SCALE = 0.263
DIMS = (25, 25)


def _close(got, ref, rtol=1e-12, atol_frac=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.max(np.abs(ref), initial=0.0, where=~np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale, equal_nan=True)


def _jacs(row=12.3, col=11.8):
    """the same sheared, rotated WCS in both packages"""
    kw = dict(row=row, col=col, dvdrow=0.26, dvdcol=0.013, dudrow=-0.009, dudcol=0.27)
    return jn.Jacobian(**kw), nt.Jacobian(**kw)


def _images(seed=1):
    """(image, weight) of an elliptical gaussian blob with noise and
    zero-weight pixels"""
    rng = np.random.RandomState(seed)
    r, c = np.mgrid[:DIMS[0], :DIMS[1]] - np.array([12.1, 12.4])[:, None, None]
    im = 20.0 * np.exp(-0.5 * (r * r / 9.0 + c * c / 5.0 - 0.2 * r * c))
    im = im + rng.normal(0, 0.01, DIMS)
    wt = np.full(DIMS, 1e4)
    wt[3:5, 6:9] = 0.0
    return im, wt


_jmake_pixels = jax.jit(jn.pixels.make_pixels)


@pytest.fixture(scope="module")
def obs_pair():
    """an observation with psf, gmix and bmask in both packages, and
    the JAX package's pixels of it (the JAX observations store none:
    their eager build compiles each operation)"""
    im, wt = _images()
    jjac, tjac = _jacs()
    rng = np.random.RandomState(2)
    jpsf = jn.Observation(rng.normal(size=(15, 15)),
                          jacobian=jn.DiagonalJacobian(row=7, col=7, scale=SCALE),
                          gmix=jn.GMixModel([0.0, 0.0, 0.0, 0.0, 0.3, 1.0], "gauss"),
                          store_pixels=False)
    jobs = jn.Observation(im, weight=wt, jacobian=jjac, psf=jpsf,
                          bmask=np.zeros(DIMS, dtype="i4"), meta={"id": 3},
                          store_pixels=False)
    tobs = convert.observation_from_object(jobs, device="cpu")
    assert tobs.store_pixels is False and tobs.pixels is None
    tobs.store_pixels = True
    return jobs, tobs, _jmake_pixels(im, wt, jjac.to_device())


# ----------------------------------------------------------------------
# exceptions, printing, fexp

EXCEPTIONS = ("NGmixBaseException", "GMixRangeError", "GMixFatalError", "GMixMaxIterEM",
              "PSFFluxFailure", "BootPSFFailure", "BootGalFailure", "FFTRangeError")


@pytest.mark.parametrize("name", EXCEPTIONS)
def test_exceptions_match(name):
    jcls, tcls = getattr(jn, name), getattr(nt, name)
    assert [c.__name__ for c in tcls.__mro__] == [c.__name__ for c in jcls.__mro__]
    assert str(tcls("bad value")) == str(jcls("bad value"))
    assert tcls("x").value == "x"


def test_print_pars_and_fexp_match():
    pars = np.array([0.1, -2.5e-3, 1234.5, 7.0])
    outs = []
    for mod in (jutil, util):
        s = io.StringIO()
        mod.print_pars(pars, front="pars:", stream=s)
        mod.print_pars(None, stream=s)
        outs.append(s.getvalue() + mod.format_pars(pars, fmt="%.6e"))
    assert outs[0] == outs[1]
    x = np.linspace(-30, 3, 17)
    _close(nt.fastexp.fexp(x), jn.fastexp.fexp(x))
    _close(nt.fastexp.apod_window(torch.as_tensor(x)), jn.fastexp.apod_window(x))


# ----------------------------------------------------------------------
# shape and moment conversions

def _shape_args(name, rng):
    g = rng.uniform(-0.7, 0.7, (2, 9))
    g[:, 0] = 0.0  # the |g| = 0 limit
    if name == "g_range_flag":
        g[:, 1] = (0.8, 0.7)  # |g| >= 1
    if name == "dgs_by_dgo_jacob":
        return (*g, 0.02, -0.01)
    if name == "rotate_shape":
        return (*g, 0.37)
    return tuple(g)


@pytest.mark.parametrize("name", ["g1g2_to_eta1eta2", "e1e2_to_eta1eta2", "eta1eta2_to_g1g2",
                                  "dgs_by_dgo_jacob", "get_round_factor", "rotate_shape",
                                  "g_range_flag"])
def test_shape_functions_match(name):
    args = _shape_args(name, np.random.RandomState(4))
    ref = getattr(jshape, name)(*args)
    got = getattr(shape, name)(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in args))
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, ref))):
        _close(a, b)


def test_shape_class_matches():
    for pkg in (jn, nt):
        with pytest.raises(pkg.GMixRangeError):
            pkg.Shape(0.8, 0.7)
    js, ts = jshape.Shape(0.2, -0.1), nt.Shape(0.2, -0.1)
    for a, b in ((js.get_sheared(0.01, 0.02), ts.get_sheared(0.01, 0.02)),
                 (js.get_sheared(jshape.Shape(0.01, 0.0)), ts.get_sheared(nt.Shape(0.01, 0.0))),
                 (js.get_rotated(0.4), ts.get_rotated(0.4)), (-js, -ts)):
        _close([b.g1, b.g2, b.g], [a.g1, a.g2, a.g])
    ts.rotate(0.4)
    assert (ts.g1, ts.g2) == (js.get_rotated(0.4).g1, js.get_rotated(0.4).g2)


@pytest.mark.parametrize("name", ["sigma_to_fwhm", "fwhm_to_sigma", "T_to_fwhm", "fwhm_to_T",
                                  "r50_to_sigma", "sigma_to_r50", "r50_to_T", "T_to_r50"])
def test_size_conversions_match(name):
    x = np.array([0.3, 1.0, 2.7])
    _close(getattr(moments, name)(x), getattr(jmoments, name)(x))
    _close(getattr(moments, name)(torch.as_tensor(x)), getattr(jmoments, name)(x))
    assert np.isclose(getattr(moments, name)(1.3), float(getattr(jmoments, name)(1.3)),
                      rtol=1e-15)


def test_moment_shear_and_regularization_match():
    rng = np.random.RandomState(6)
    M1, M2, T = rng.uniform(-0.2, 0.2, 5), rng.uniform(-0.2, 0.2, 5), rng.uniform(0.5, 2, 5)
    T[0] = -1.0  # NaN there
    for a, b in zip(moments.moms_to_e1e2(torch.as_tensor(M1), torch.as_tensor(M2), T),
                    jmoments.moms_to_e1e2(M1, M2, T)):
        _close(a, b)
    for a, b in zip(moments.get_sheared_M1M2T(M1[1:], M2[1:], T[1:], 0.01, -0.02),
                    jmoments.get_sheared_M1M2T(M1[1:], M2[1:], T[1:], 0.01, -0.02)):
        _close(a, b)
    sums = rng.uniform(0.1, 2.0, (3, 6))
    sums[0, :2] = np.nan  # the pre-psf measures' centroid moments
    A = rng.normal(size=(3, 6, 6))
    cov = A @ A.transpose(0, 2, 1) + 6 * np.eye(6)
    jres, jreg = jax.jit(lambda s, c: (
        lambda r: (r, jmoments.regularize_mom_shapes(r, 0.8)))(jmoments.make_mom_result(s, c))
    )(sums, cov)
    tres = moments.make_mom_result(torch.as_tensor(sums), torch.as_tensor(cov))
    treg = moments.regularize_mom_shapes(tres, 0.8)
    assert moments.regularize_mom_shapes(tres, 0.0) is tres
    assert set(treg) == set(jreg)
    for k in jreg:
        _close(treg[k], jreg[k])
    jh, th = jmoments.result_to_host(jreg, index=1), moments.result_to_host(treg, index=1)
    assert set(th) == set(jh) and th["flagstr"] == jh["flagstr"]
    for k in jh:
        if "flagstr" not in k:
            _close(th[k], jh[k])


# ----------------------------------------------------------------------
# jacobians and pixels

def test_jacobian_matches():
    jjac, tjac = _jacs()
    for a in ("row0", "col0", "dvdrow", "dvdcol", "dudrow", "dudcol", "det", "scale", "area"):
        assert getattr(tjac, a) == getattr(jjac, a), a
    assert tjac.get_cen() == jjac.get_cen() and tjac.cen == jjac.cen
    rows, cols = np.array([0.0, 3.5, 24.0]), np.array([1.0, -2.0, 12.0])
    for a, b in zip(tjac.get_vu(rows, cols), jjac.get_vu(rows, cols)):
        _close(a, b)
    for a, b in zip(tjac(rows, cols), jjac(rows, cols)):
        _close(a, b)
    for a, b in zip(tjac.get_rowcol(rows, cols), jjac.get_rowcol(rows, cols)):
        _close(a, b)
    # the device struct: the same map on tensors
    dev = tjac.to_device("cpu")
    jdev = jjac.to_device()
    for a, b in zip(dev.get_vu(torch.as_tensor(rows), torch.as_tensor(cols)),
                    jdev.get_vu(rows, cols)):
        _close(a, b)
    _close(dev.scale, jdev.scale)
    _close(dev.get_rowcol(*dev.get_vu(torch.as_tensor(rows), torch.as_tensor(cols)))[0], rows)
    # constructor modes, copy, equality, set_cen
    wcs = type("W", (), dict(dvdy=0.26, dvdx=0.013, dudy=-0.009, dudx=0.27))()
    for kw in (dict(x=11.8, y=12.3, wcs=wcs),
               dict(x=11.8, y=12.3, dvdy=0.26, dvdx=0.013, dudy=-0.009, dudx=0.27),
               dict(row=12.3, col=11.8, wcs=wcs)):
        assert nt.Jacobian(**kw) == tjac
        assert nt.Jacobian(**kw).asarray().tolist() == jn.Jacobian(**kw).asarray().tolist()
    c = tjac.copy()
    c.set_cen(x=1.0, y=2.0)
    assert c.get_cen() == (2.0, 1.0) and not (c == tjac)
    with pytest.raises(ValueError):
        nt.Jacobian(row=1.0, col=1.0, dvdrow=1.0)
    with pytest.raises(ValueError):
        tjac == 3
    d, jd = nt.DiagonalJacobian(row=3, col=4, scale=0.2), jn.DiagonalJacobian(row=3, col=4,
                                                                               scale=0.2)
    assert d.asarray().tolist() == jd.asarray().tolist()
    assert nt.UnitJacobian(x=4, y=3).asarray().tolist() == \
        jn.UnitJacobian(x=4, y=3).asarray().tolist()
    assert "ngmix_tpu_torch.Jacobian(row=12.3" in repr(tjac)
    # batched device structs
    bj = jac_from_arrays([1.0, 2.0], [3.0, 4.0], 0.2, 0.0, 0.0, 0.2, device="cpu")
    assert bj.row0.shape == (2,) and torch.equal(
        diagonal_jac([1.0, 2.0], 3.0, 0.2, device="cpu").area,
        torch.full((2,), 0.2 * 0.2, dtype=torch.float64))


def test_pixels_match(obs_pair):
    im, wt = _images()
    _, tjac = _jacs()
    jpix = obs_pair[2]
    tpix = make_pixels(im, wt, tjac.to_device("cpu"))
    for k in tpix._fields:
        _close(getattr(tpix, k), getattr(jpix, k))
    assert int(tpix.mask.sum()) == DIMS[0] * DIMS[1] - 6
    coords = make_coords(DIMS, tjac.to_device("cpu"))
    _close(coords.v, tpix.coords.v)


# ----------------------------------------------------------------------
# mixtures

MODELS = {
    "gauss": [0.2, -0.1, 0.1, -0.3, 1.2, 50.0],
    "exp": [0.1, -0.05, 0.2, -0.1, 1.5, 100.0],
    "dev": [0.0, 0.1, -0.1, 0.05, 2.0, 80.0],
    "turb": [0.0, 0.0, 0.05, 0.02, 0.7, 1.0],
    "bdf": [0.1, 0.0, 0.1, 0.1, 1.5, 0.3, 60.0],
    "bd": [0.1, 0.0, 0.1, 0.1, 1.5, 0.2, 0.4, 60.0],
    "coellip": [0.1, 0.2, 0.1, -0.2, 0.5, 2.0, 30.0, 70.0],
    "full": [20.0, 0.1, 0.2, 0.5, 0.1, 0.6, 30.0, -0.3, 0.0, 1.5, -0.2, 1.1],
}


def _gmix_pair(model):
    if model == "cm":
        return jn.GMixCM(0.3, 1.2, MODELS["exp"]), nt.GMixCM(0.3, 1.2, MODELS["exp"])
    pars = MODELS[model]
    return jn.gmix.make_gmix_model(pars, model), nt.make_gmix_model(pars, model)


# JAX's GMix.make_image: core.render over make_coords, both modes
_jrender = jax.jit(lambda gm, coords: (jcore.render(gm, coords, fast=False),
                                       jcore.render(gm, coords, fast=True)))


@pytest.fixture(scope="module")
def jax_images():
    """each model's JAX mixture and its exact and fast renders"""
    coords = jax.jit(jn.pixels.make_coords, static_argnums=0)(DIMS, _jacs()[0].to_device())
    out = {}
    for model in IMAGE_MODELS:
        jgm, _ = _gmix_pair(model)
        out[model] = (jgm, *(np.asarray(x).reshape(DIMS) for x in _jrender(jgm.to_device(),
                                                                           coords)))
    return out


IMAGE_MODELS = ("gauss", "exp", "dev", "bdf", "coellip", "full", "cm")


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("model", IMAGE_MODELS)
def test_fill_and_make_image_match(jax_images, model, fast):
    jgm, *images = jax_images[model]
    _, tgm = _gmix_pair(model)
    assert type(tgm).__name__ == type(jgm).__name__
    _close(tgm.get_data(), jgm.get_data())
    _, tjac = _jacs()
    _close(tgm.make_image(DIMS, jacobian=tjac, fast_exp=fast, device="cpu"), images[fast])
    # the default jacobian: unit scale at the stamp center
    assert np.array_equal(
        tgm.make_image((9, 8), fast_exp=fast, device="cpu"),
        tgm.make_image((9, 8), jacobian=nt.UnitJacobian(row=4.0, col=3.5), fast_exp=fast,
                       device="cpu"))


def test_make_image_goes_through_k2(monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(kw.get("fast"))
        return gmix_eval.eval_gmix_plain(*a, **kw)

    monkeypatch.setattr(gmix_eval, "eval_gmix", counted)
    nt.GMixModel(MODELS["exp"], "exp").make_image(DIMS, fast_exp=True, device="cpu")
    assert calls == [True]


@pytest.mark.parametrize("model", ["gauss", "exp", "bdf", "coellip"])
def test_gmix_range_error_at_unit_g(model):
    pars = list(MODELS[model])
    pars[2:4] = [0.8, 0.7]
    for pkg in (jn, nt):
        with pytest.raises(pkg.GMixRangeError):
            pkg.gmix.make_gmix_model(pars, model)
    gm = nt.make_gmix_model(MODELS[model], model)
    with pytest.raises(nt.GMixRangeError):
        gm.fill(pars)


def test_gmix_methods_match():
    jgm, tgm = _gmix_pair("exp")
    jpsf, tpsf = (pkg.GMixModel(MODELS["turb"], "turb") for pkg in (jn, nt))
    assert tgm.get_cen() == pytest.approx(jgm.get_cen(), rel=1e-14)
    for f in ("get_T", "get_sigma", "get_flux", "get_e1e2T", "get_g1g2T", "get_e1e2sigma",
              "get_g1g2sigma"):
        _close(getattr(tgm, f)(), getattr(jgm, f)())
    _close(tgm.get_gaussap_flux(fwhm=1.3), jgm.get_gaussap_flux(fwhm=1.3))
    _close(tgm.get_gaussap_flux(T=0.9), jgm.get_gaussap_flux(T=0.9))
    pairs = [(tgm.convolve(tpsf), jgm.convolve(jpsf)),
             (tgm.get_sheared(0.02, -0.01), jgm.get_sheared(0.02, -0.01)),
             (tgm.get_sheared(nt.Shape(0.02, 0.0)), jgm.get_sheared(jn.Shape(0.02, 0.0))),
             (tgm.make_round(), jgm.make_round()),
             (tgm.make_round(preserve_size=True), jgm.make_round(preserve_size=True)),
             (nt.gmix.gmix.gmix_concat([tgm, tpsf]), jn.gmix.gmix_concat([jgm, jpsf]))]
    for t, j in pairs:
        _close(t.get_data(), j.get_data())
    c = tgm.copy()
    assert c == tgm and type(c) is nt.GMixModel
    for gm in (jgm, tgm):
        gm.set_cen(0.3, -0.2)
        gm.set_flux(7.0)
        gm.scale_T(1.4)
    _close(tgm.get_data(), jgm.get_data())
    assert tgm._pars[:2].tolist() == jgm._pars[:2].tolist()
    assert not (c == tgm)
    with pytest.raises(ValueError):
        tgm == 1
    with pytest.raises(TypeError):
        tgm.convolve(3)
    with pytest.raises(ValueError):
        tgm.fill([1.0, 2.0])
    with pytest.raises(ValueError):
        tgm.scale_T(-1.0)
    with pytest.raises(ImportError):
        tgm.make_galsim_object()
    cm = nt.GMixCM(0.3, 1.2, MODELS["exp"])
    assert "fracdev: 0.3" in repr(cm) and cm.copy() == cm
    assert nt.GMixCoellip(MODELS["coellip"]).copy() == nt.GMixCoellip(MODELS["coellip"])
    with pytest.raises(ValueError):
        nt.GMixCoellip([0.0] * 7)


def test_gmix_lists_type_safety():
    gl = nt.GMixList()
    gl.append(nt.GMixModel(MODELS["gauss"], "gauss"))
    mb = nt.MultiBandGMixList()
    mb.append(gl)
    with pytest.raises(AssertionError):
        gl.append(3)
    with pytest.raises(AssertionError):
        mb.append(gl[0])
    with pytest.raises(AssertionError):
        mb[0] = [1]


_jsums = jax.jit(lambda gm, wt, pix, higher: (
    jcore.get_loglike(gm, pix), jcore.fill_fdiff(gm, pix), jcore.get_model_s2n_sum(gm, pix),
    jn.gmix.get_weighted_moments_stats(jcore.get_weighted_sums(wt, pix, 100 * np.sqrt(0.5),
                                                               higher_order=higher))),
    static_argnums=3)


@pytest.mark.parametrize("higher", [False, True], ids=["6", "17"])
def test_observation_sums_match(obs_pair, higher):
    _, tobs, jpix = obs_pair
    jgm, tgm = _gmix_pair("exp")
    wt = nt.GMixModel([0, 0, 0, 0, 1.0, 1.0], "gauss")
    (jll, jnum, jden, jnpix), jfdiff, js2n, jmom = _jsums(
        jgm.to_device(), jn.GMixModel([0, 0, 0, 0, 1.0, 1.0], "gauss").to_device(), jpix, higher)
    _close(tgm.get_loglike(tobs), jll, rtol=1e-10)
    tm = tgm.get_loglike(tobs, more=True)
    assert tm["npix"] == int(jnpix) == DIMS[0] * DIMS[1] - 6
    for k, ref in (("loglike", jll), ("s2n_numer", jnum), ("s2n_denom", jden)):
        _close(tm[k], ref, rtol=1e-10)
    _close(tgm.get_model_s2n(tobs), np.sqrt(js2n), rtol=1e-10)
    tf = np.zeros(tobs.image.size + 2)
    tgm.fill_fdiff(tobs, tf, start=2)
    _close(tf[2:], jfdiff, rtol=1e-10)
    tr = wt.get_weighted_moments(tobs, with_higher_order=higher)
    assert set(tr) == set(jmom) and tr["sums"].shape == (17 if higher else 6,)
    for k in jmom:
        _close(tr[k], jmom[k], rtol=1e-10)


# ----------------------------------------------------------------------
# observations and containers

def test_observation_views_and_pixels(obs_pair):
    jobs, tobs, jpix = obs_pair
    assert tobs.device == torch.device("cpu")
    for k in ("v", "u", "area", "val", "ierr"):
        _close(getattr(tobs.pixels, k), getattr(jpix, k))
    for arr in (tobs.image, tobs.weight, tobs.bmask):
        with pytest.raises(ValueError):
            arr[0, 0] = 1.0
    with tobs.writeable():
        tobs.image[0, 0] = 99.0
    assert float(tobs.pixels.val[0]) == 99.0
    with tobs:
        tobs.image[0, 0] = jobs.image[0, 0]
    assert float(tobs.pixels.val[0]) == jobs.image[0, 0]
    with pytest.raises(AssertionError):
        tobs.set_image(np.zeros((5, 5)))
    with pytest.raises(AssertionError):
        tobs.set_weight(np.zeros((5, 5)))
    with pytest.raises(AttributeError):
        tobs.noise
    assert tobs.has_bmask() and not tobs.has_noise() and tobs.has_psf_gmix()
    _close(tobs.get_psf_gmix().get_data(), jobs.get_psf_gmix().get_data())
    assert tobs.get_s2n() == pytest.approx(jobs.get_s2n(), rel=1e-14)
    tobs.store_pixels = False
    assert tobs.pixels is None
    tobs.store_pixels = True
    assert tobs.pixels is not None
    o = nt.Observation(np.ones((4, 4)), device="cpu")
    assert o.jacobian.get_cen() == (1.5, 1.5) and o.pixels.ierr.eq(1.0).all()


def test_observation_copy_eq_meta(obs_pair):
    _, tobs, _ = obs_pair
    obs2 = tobs.copy()
    assert obs2 == tobs and obs2.device == tobs.device and obs2.meta == {"id": 3}
    with obs2.writeable():
        obs2.image[1, 1] += 1
    assert not (obs2 == tobs)
    with pytest.raises(TypeError):
        obs2.set_meta([1, 2])
    obs2.update_meta_data({"a": 1})
    assert obs2.meta == {"id": 3, "a": 1} and tobs.meta == {"id": 3}
    with pytest.raises(ValueError):
        tobs == 3
    with pytest.raises(AssertionError):
        obs2.set_jacobian("not a jacobian")


def test_containers_and_traversal(obs_pair):
    jobs, tobs, _ = obs_pair
    ol = nt.ObsList()
    ol.append(tobs)
    ol.append(tobs.copy())
    mb = nt.MultiBandObsList(meta={"b": 1})
    mb.append(ol)
    jol = jn.ObsList()
    jol.append(jobs)
    jol.append(jobs.copy())
    jmb = jn.MultiBandObsList()
    jmb.append(jol)
    for t, j in ((ol, jol), (mb, jmb)):
        assert t.get_s2n_sums() == pytest.approx(j.get_s2n_sums(), rel=1e-14)
        assert t.get_s2n() == pytest.approx(j.get_s2n(), rel=1e-14)
    assert mb.copy() == mb
    with pytest.raises(AssertionError):
        ol.append("not an obs")
    with pytest.raises(AssertionError):
        mb.append(tobs)
    assert nt.get_mb_obs(tobs)[0][0] is tobs and nt.get_mb_obs(mb) is mb
    assert nt.get_mb_obs(ol)[0] is ol
    with pytest.raises(ValueError):
        nt.get_mb_obs(42)
    assert nt.observation.MetadataMixin is not None

    def size(o):
        return o.image.size

    assert containers.obs_map(mb, size) == jcontainers.obs_map(jmb, size) == [[625, 625]]
    assert containers.obs_zip_map(mb, mb, lambda a, b: a is b) == [[True, True]]
    kept = containers.obs_prune(mb, lambda o: o is tobs)
    assert len(kept[0]) == 1 and kept.meta == {"b": 1}
    assert containers.obs_prune(mb, lambda o: False) is None
    tr = containers.obs_map_transpose(mb, lambda o: {"a": o, "b": o})
    assert isinstance(tr["a"], nt.MultiBandObsList) and tr["b"][0][1] is ol[1]
    with pytest.raises(ValueError):
        containers.obs_map(3, size)


def test_converters(obs_pair):
    jobs, tobs, _ = obs_pair
    assert isinstance(tobs, nt.Observation) and tobs.meta == jobs.meta
    for k in ("image", "weight", "bmask"):
        assert np.array_equal(getattr(tobs, k), getattr(jobs, k))
    assert tobs.jacobian.asarray().tolist() == jobs.jacobian.asarray().tolist()
    assert np.array_equal(tobs.psf.image, jobs.psf.image)
    assert np.array_equal(tobs.psf.gmix.get_data(), jobs.psf.gmix.get_data())
    for model in ("exp", "coellip", "full", "cm"):
        jgm, _ = _gmix_pair(model)
        tgm = convert.gmix_from_object(jgm)
        assert type(tgm).__name__ == type(jgm).__name__
        assert np.array_equal(tgm.get_data(), jgm.get_data())
        assert tgm.copy() == tgm
    jmb = jn.get_mb_obs(jobs)
    tmb = convert.observation_from_object(jmb, device="cpu")
    assert isinstance(tmb, nt.MultiBandObsList) and tmb[0][0] == tobs
    with pytest.raises(TypeError):
        convert.observation_from_object(3)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    im = np.ones((5, 5))
    gm = nt.GMixModel(MODELS["gauss"], "gauss")
    for call in (lambda: nt.Observation(im),
                 lambda: gm.make_image((5, 5)),
                 lambda: gm.to_device(),
                 lambda: nt.UnitJacobian(row=2, col=2).to_device(),
                 lambda: diagonal_jac(1.0, 2.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tcore.render(gm.to_device("cpu"), make_coords(
        (5, 5), nt.UnitJacobian(row=2, col=2).to_device("cpu"))).shape == (25,)
