"""The support modules of the PyTorch port against the JAX package on
the same numpy inputs: GMixND (gmix_ndim.py), gaussap.py, the MEDS
readers (medsreaders.py, over the duck-typed FakeMEDS of
tests/test_medsreaders.py), profiling.py, KDE (priors/kde.py) and the
small names of the package surface (flags.get_flags_str_array,
admom.admom_single, em.em_single, the reference-name aliases,
defaults.copy_if_needed, parallel.distributed.replicated_to_host,
metacal.kops.fft_axis).

Tolerances: GMixND probabilities and aperture fluxes rtol 1e-12 with
flags equal; GMixND.fit rtol 1e-8; samples from a generator in the
same state equal; MEDS observations' images, weights, planes,
jacobians and metadata equal; admom_single and em_single equal to
their lane of the batched call. Every evaluation runs on the CPU
(device="cpu"); without it the entry points ask for the card and raise
where there is none.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import gaussap as jgap, gmix_ndim as jgnd, medsreaders as jmeds
from ngmix_tpu import admom as jadmom, em as jem, flags as jflags
from ngmix_tpu.pixels import Pixels as JPixels
from ngmix_tpu.metacal import kops as jkops
from ngmix_tpu.priors import KDE as JKDE

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import gaussap as tgap, medsreaders as tmeds, profiling
from ngmix_tpu_torch import admom as tadmom, defaults, em as tem, flags
from ngmix_tpu_torch.gmix_ndim import GMixND
from ngmix_tpu_torch.metacal import kops as tkops
from ngmix_tpu_torch.parallel import distributed
from ngmix_tpu_torch.pixels import Pixels
from ngmix_tpu_torch.priors import KDE

from test_medsreaders import FakeMEDS

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

NO_CARD = not torch.cuda.is_available()


def _mixture(ndim=3, ngauss=4, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.2, 1.0, ngauss)
    means = rng.normal(size=(ngauss, ndim))
    A = rng.normal(size=(ngauss, ndim, ndim)) * 0.4
    covars = A @ np.swapaxes(A, 1, 2) + 0.3 * np.eye(ndim)
    return w / w.sum(), means, covars


@pytest.mark.parametrize("ndim", [1, 3])
def test_gmixnd_evaluations_match_jax(ndim):
    w, means, covars = _mixture(ndim)
    jg = jgnd.GMixND(w, means, covars, rng=np.random.RandomState(2))
    tg = GMixND(w, means, covars, rng=np.random.RandomState(2), device="cpu")
    pts = np.random.RandomState(3).normal(size=(64, ndim)) * 1.5
    if ndim == 1:
        pts = pts[:, 0]
    np.testing.assert_allclose(tg.get_lnprob_array(pts), jg.get_lnprob_array(pts), rtol=1e-12)
    np.testing.assert_allclose(tg.get_prob_array(pts), jg.get_prob_array(pts), rtol=1e-12)
    for c in (None, 0, 2):
        np.testing.assert_allclose(tg.get_lnprob_array(pts, component=c),
                                   jg.get_lnprob_array(pts, component=c), rtol=1e-12)
        x = pts[5]
        np.testing.assert_allclose(tg.get_lnprob_scalar(x, component=c),
                                   jg.get_lnprob_scalar(x, component=c), rtol=1e-12)
        np.testing.assert_allclose(tg.get_prob_scalar(x, component=c),
                                   jg.get_prob_scalar(x, component=c), rtol=1e-12)
    for k in ("norms", "pnorms", "log_pnorms", "icovars"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    np.testing.assert_array_equal(tg.sample(), jg.sample())
    np.testing.assert_array_equal(tg.sample(200), jg.sample(200))


def test_gmixnd_fit_save_load_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    data = np.concatenate([rng.normal(-2, 0.5, size=(400, 2)), rng.normal(2, 0.7, size=(400, 2))])
    jg = jgnd.GMixND(rng=np.random.RandomState(4))
    tg = GMixND(rng=np.random.RandomState(4), device="cpu")
    jg.fit(data, ngauss=2, n_iter=200)
    tg.fit(data, ngauss=2, n_iter=200)
    assert tg.converged and tg.ngauss == jg.ngauss == 2
    for k in ("weights", "means", "covars"):
        np.testing.assert_allclose(getattr(tg, k), getattr(jg, k), rtol=1e-8, err_msg=k)
    fname = str(tmp_path / "mix")
    tg.save_mixture(fname)
    back = GMixND(file=fname, device="cpu")
    for k in ("weights", "means", "covars"):
        np.testing.assert_array_equal(getattr(back, k), getattr(tg, k))
    with pytest.raises(RuntimeError, match="all or none"):
        GMixND(weights=[1.0])


@pytest.mark.skipif(not NO_CARD, reason="checks the error of a host without a card")
def test_gmixnd_without_a_card_raises():
    w, means, covars = _mixture()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GMixND(w, means, covars).get_lnprob_array(np.zeros((2, 3)))


GAP_CASES = {
    "gauss": ("gauss", [[0.0, 0.0, 0.05, 0.0, 0.5, 100.0], [0.1, 0.0, 0.0, 0.1, 1.0, 50.0],
                        [0.0, 0.0, 0.99, 0.99, 1.0, 50.0]], {}),
    "exp 2 bands": ("exp", [[0.0, 0.0, 0.05, 0.0, 0.5, 100.0, 60.0],
                            [0.0, 0.1, -0.2, 0.1, -1.0, 30.0, 10.0]], {}),
    "bdf 3 bands": ("bdf", [[0.0, 0.0, 0.05, 0.0, 0.5, 0.3, 100.0, 60.0, 5.0],
                            [0.0, 0.1, 0.3, 0.1, 2.0, 0.9, 30.0, 10.0, 8.0]],
                    {"mask": [True, False]}),
    "cm": ("cm", [[0.0, 0.0, 0.05, 0.0, 0.5, 100.0], [0.0, 0.0, 0.1, -0.3, 1.5, 20.0]],
           {"fracdev": [0.3, 0.8], "TdByTe": [1.2, 0.7]}),
    "dev": ("dev", [[0.0, 0.0, 0.2, 0.1, 3.0, 10.0]], {}),
}


@pytest.mark.parametrize("name", sorted(GAP_CASES))
def test_gaussap_flux_matches_jax(name):
    model, pars, kw = GAP_CASES[name]
    for fwhm in (1.0, 3.0):
        jflux, jflg = jgap.get_gaussap_flux(np.array(pars), model, fwhm, **kw)
        tflux, tflg = tgap.get_gaussap_flux(np.array(pars), model, fwhm, device="cpu", **kw)
        np.testing.assert_array_equal(tflg, jflg)
        assert tflux.shape == jflux.shape and tflg.dtype == jflg.dtype
        np.testing.assert_array_equal(np.isnan(tflux), np.isnan(jflux))
        ok = np.isfinite(jflux)
        np.testing.assert_allclose(tflux[ok], jflux[ok], rtol=1e-12)
    if name == "gauss":
        assert jflg[2, 0] == flags.GMIX_RANGE_ERROR
    if "mask" in kw:
        assert np.all(tflg[1] == flags.NO_ATTEMPT) and np.all(np.isnan(tflux[1]))


def test_gaussap_single_matches_jax():
    gm = np.random.RandomState(5).uniform(0.1, 1.0, size=(7, 3, 6))
    gm[..., 4] *= 0.1
    gm[0, 1, 4] = 5.0  # det < 0
    for sigma in (0.5, 2.0):
        np.testing.assert_allclose(
            tgap.gaussap_flux_single(torch.as_tensor(gm), sigma).numpy(),
            np.asarray(jgap.gaussap_flux_single(jnp.asarray(gm), sigma)), rtol=1e-12)


class JFakeMEDS(jmeds.NGMixMEDSMixin, FakeMEDS):
    pass


class TFakeMEDS(tmeds.NGMixMEDSMixin, FakeMEDS):
    device = "cpu"


def _same_obs(t, j, what):
    for k in ("image", "weight"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=(what, k))
    for k in ("bmask", "ormask", "noise", "mfrac"):
        assert getattr(t, "has_" + k)() == getattr(j, "has_" + k)(), (what, k)
        if getattr(j, "has_" + k)():
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=(what, k))
    tj, jj = t.jacobian, j.jacobian
    np.testing.assert_array_equal(tj.get_cen(), jj.get_cen())
    for k in ("dvdrow", "dvdcol", "dudrow", "dudcol"):
        assert getattr(tj, k) == getattr(jj, k), (what, k)
    assert t.meta.keys() == j.meta.keys()
    for k in j.meta:
        assert t.meta[k] == j.meta[k], (what, k)


@pytest.fixture(scope="module")
def meds_pair():
    return (TFakeMEDS(np.random.RandomState(8), nobj=3), JFakeMEDS(np.random.RandomState(8),
                                                                   nobj=3))


@pytest.mark.parametrize("weight_type", ["weight", "uberseg", "cweight", "cseg",
                                         "cseg-canonical"])
def test_meds_observations_equal_jax(meds_pair, weight_type):
    tm, jm = meds_pair
    for iobj in range(tm.size):
        tl = tm.get_obslist(iobj, weight_type=weight_type)
        jl = jm.get_obslist(iobj, weight_type=weight_type)
        assert len(tl) == len(jl) == 1 + iobj and tl.meta == jl.meta
        for c, (t, j) in enumerate(zip(tl, jl)):
            _same_obs(t, j, (iobj, c))
            _same_obs(t.psf, j.psf, (iobj, c, "psf"))
            assert t.pixels.val.device.type == "cpu"
    with pytest.raises(ValueError, match="bad weight type"):
        tm.get_obs(0, 0, weight_type="nope")


def test_meds_multiband_and_guarded_import(meds_pair):
    tm, jm = meds_pair
    tmb = tmeds.MultiBandNGMixMEDS([tm, tm], device="cpu")
    jmb = jmeds.MultiBandNGMixMEDS([jm, jm])
    assert (tmb.nband, tmb.size) == (jmb.nband, jmb.size) == (2, 3)
    tlist, jlist = tmb.get_mbobs_list(), jmb.get_mbobs_list()
    assert len(tlist) == len(jlist) == 3
    for tmbobs, jmbobs in zip(tlist, jlist):
        assert len(tmbobs) == len(jmbobs) == 2
        for tl, jl in zip(tmbobs, jmbobs):
            for t, j in zip(tl, jl):
                _same_obs(t, j, "mb")
    assert tmeds.HAVE_MEDS == jmeds.HAVE_MEDS
    if not tmeds.HAVE_MEDS:
        with pytest.raises(ImportError, match="meds"):
            tmeds.NGMixMEDS("file.fits")
    no_psf = TFakeMEDS(np.random.RandomState(8), nobj=1, with_psf=False)
    assert not no_psf.get_obs(0, 0).has_psf()
    if NO_CARD:
        card = tmeds.MultiBandNGMixMEDS([JFakeMEDS.__new__(TFakeMEDS)])
        card.mlist[0].__dict__.update(vars(tm))
        card.mlist[0].device = None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            card.get_mbobs(0)


def test_profiling_timed_report_and_trace(tmp_path):
    profiling.report(reset=True)
    x = torch.ones(8)
    with profiling.timed("stage_a", sync={"x": [x, (x,)]}):
        x = x * 2
    with profiling.timed("stage_a"):
        pass
    with profiling.timed("stage_b", sync=x):
        pass
    rep = profiling.report()
    assert rep["stage_a"][1] == 2 and rep["stage_b"][1] == 1
    assert rep["stage_a"][2] == pytest.approx(rep["stage_a"][0] / 2)
    buf = io.StringIO()
    profiling.print_report(reset=True, stream=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].split() == ["stage", "total[s]", "calls", "per-call[s]"]
    assert len(lines) == 3 and profiling.report() == {}
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    traces = list((tmp_path / "tr").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_kde_samples_equal_jax():
    rng = np.random.RandomState(9)
    data1 = rng.normal(size=500)
    data2 = rng.normal(size=(500, 2)) * [1.0, 2.0]
    for data in (data1, data2):
        jk = JKDE(data, "scott", np.random.RandomState(10))
        tk = KDE(data, "scott", np.random.RandomState(10))
        np.testing.assert_array_equal(tk.sample(), jk.sample())
        np.testing.assert_array_equal(tk.sample(300), jk.sample(300))
        assert tk.sample(300).shape == ((300,) if data.ndim == 1 else (300, 2))


def test_small_names_match_jax():
    vals = np.array([[0, 2**2 | 2**6], [2**9, 2**20]])
    np.testing.assert_array_equal(flags.get_flags_str_array(vals),
                                  jflags.get_flags_str_array(vals))
    assert defaults.copy_if_needed() is None
    assert nt.admom.admom is tadmom and tadmom.admom_nb is tadmom
    assert tem.em is tem and tem.em_nb is tem
    assert nt.gmix.gmix_nb is nt.gmix.core and nt.gmix.render_nb is nt.gmix.core
    assert nt.fitting.fitters.LOGGER.name == "ngmix_tpu_torch.fitting.fitters"
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2), 1.5], "c": (torch.zeros(1),)}
    host = distributed.replicated_to_host(tree)
    np.testing.assert_array_equal(host["a"], [0.0, 1.0, 2.0])
    assert isinstance(host["b"], list) and isinstance(host["c"], tuple)
    assert isinstance(host["b"][0], np.ndarray) and host["b"][1] == 1.5
    A = np.random.RandomState(4).normal(size=(3, 8, 6)) + 0j
    for axis in (-1, 1):
        for inverse in (False, True):
            np.testing.assert_allclose(
                tkops.fft_axis(torch.as_tensor(A), axis=axis, inverse=inverse).numpy(),
                np.asarray(jkops.fft_axis(jnp.asarray(A), axis=axis, inverse=inverse)),
                rtol=1e-12, atol=1e-12)


def _stamp(seed, P=81):
    rng = np.random.RandomState(seed)
    r, c = np.mgrid[:9, :9].reshape(2, -1).astype(float) - 4.0
    img = 10.0 * np.exp(-0.5 * (r**2 + 0.8 * c**2 + 0.3 * r * c) / 2.0)
    img += rng.normal(scale=0.05, size=P)
    return (r * 0.263, c * 0.263, np.full(P, 0.263**2), img, np.full(P, 20.0))


def test_admom_single_equals_its_lane_and_jax():
    conf = tadmom.AdmomConf()
    lanes = [_stamp(s) for s in (1, 2)]
    wt0 = np.array([[1.0, 0.0, 0.0, 0.3, 0.0, 0.3], [1.0, 0.05, -0.05, 0.5, 0.05, 0.4]])
    batch = tadmom.admom_raw(Pixels(*(torch.as_tensor(np.stack(f)) for f in zip(*lanes))),
                             torch.as_tensor(wt0), conf)
    jconf = jadmom.AdmomConf()
    for i, lane in enumerate(lanes):
        one = tadmom.admom_single(Pixels(*map(torch.as_tensor, lane)), torch.as_tensor(wt0[i]),
                                  conf)
        ref = jax.jit(jadmom.admom_single, static_argnums=2)(
            JPixels(*map(jnp.asarray, lane)), jnp.asarray(wt0[i]), jconf)
        assert one.keys() == batch.keys()
        for k, v in one.items():
            np.testing.assert_array_equal(v.numpy(), batch[k][i].numpy(), err_msg=k)
            if k in ref:
                np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=1e-10,
                                           atol=1e-12, err_msg=k)


def test_em_single_equals_its_lane_and_jax():
    conf = tem.EMConf(maxiter=60)
    lanes = [_stamp(s) for s in (3, 4)]
    g0 = np.array([[[1.0, 0.0, 0.0, 0.4, 0.0, 0.4]], [[0.8, 0.1, 0.0, 0.3, 0.02, 0.5]]])
    psf = np.array([[[1.0, 0.0, 0.0, 0.1, 0.0, 0.1]]] * 2)
    batch = tem.em_raw(Pixels(*(torch.as_tensor(np.stack(f)) for f in zip(*lanes))),
                       torch.as_tensor(g0), torch.as_tensor(psf),
                       torch.full((2,), 0.2, dtype=torch.float64), conf)
    jconf = jem.EMConf(maxiter=60)
    for i, lane in enumerate(lanes):
        one = tem.em_single(Pixels(*map(torch.as_tensor, lane)), torch.as_tensor(g0[i]),
                            torch.as_tensor(psf[i]), 0.2, conf)
        ref = jax.jit(jem.em_single, static_argnums=4)(
            JPixels(*map(jnp.asarray, lane)), jnp.asarray(g0[i]), jnp.asarray(psf[i]),
            0.2, jconf)
        for k, v in one.items():
            np.testing.assert_array_equal(v.numpy(), batch[k][i].numpy(), err_msg=k)
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=1e-10, atol=1e-12,
                                       err_msg=k)
