"""The LM options of the PyTorch port (LMConf.flux_col, LMConf.varpro,
fitting.lm.run_gn_refine_batched and MetacalConfig.sheared_refine)
against the JAX package on the same numpy inputs, in float64 on the CPU.

The inputs are the reference tests' sims (tests/test_batch_pipeline.py:
_sim_batch, seeds 31 and 17 of :995-1075, seeds 71 and 73 of
tests/test_metacal.py:303-380), the first B = 8 objects, through the
port's metacal engine at the 19x19 window; both packages' LM measures
then run on the same stacked pixels (the engines are held against each
other in tests/test_torch_pipeline.py). The JAX flat LM computes its
normal equations by AD; the port's are in closed form (K1's plain
version).

Tolerance (ROADMAP's North star, tests/test_batch_pipeline.py:822-828):
flags equal, nfev within 2, pars and pars_err to rtol 1e-8 and atol
1e-10. flux_col changes nothing in the port, bit for bit; the
multi-band checks are in tests/test_torch_mb.py. On CUDA tensors each
mode is one launch of K3's options kernel (checked on a mocked card);
the kernel runs only on the card (chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.fitting import lm as jlm
from ngmix_tpu.pixels import Pixels as JPixels

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.ops import lm_solve

import _priors
from test_batch_pipeline import DIMS, PSF_DIMS, SCALE, _sim_batch
from test_torch_lm_solve import _fake_cuda, _mock_card, _small_args

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B = 8
CONF = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, jac=(SCALE, 0.0, 0.0, SCALE),
                        fixnoise=True, pad_factor=2, fit_dims=(19, 19))
TYPES = tbatch.GALSHEAR_TYPES
INF = float("inf")
# the reference tests' boxes: flux-bounded bdf (tests/test_batch_pipeline.py:
# 1007-1010), shape-bounded for varpro (:1059-1060, fracdev in [0, 1]
# for bdf) and the refine test's bdf box (tests/test_metacal.py:360-361)
FLUXCOL_BDF_BOX = ([-2.0, -2.0, -0.99, -0.99, 0.01, 0.0, 1e-3],
                   [2.0, 2.0, 0.99, 0.99, 100.0, 1.0, 1e9])
VARPRO_BOX = {"exp": ([-2.0, -2.0, -0.99, -0.99, 0.01, -INF], [2.0, 2.0, 0.99, 0.99, 100.0, INF]),
              "bdf": ([-2.0, -2.0, -0.99, -0.99, 0.01, 0.0, -INF],
                      [2.0, 2.0, 0.99, 0.99, 100.0, 1.0, INF])}
REFINE_BDF_BOX = ([-2.0, -2.0, -0.99, -0.99, 1e-3, 0.0, 1e-3], [2.0, 2.0, 0.99, 0.99, 20.0, 1.0, 1e9])


@functools.lru_cache(maxsize=None)
def _inputs(seed, n):
    """the first B of _sim_batch(RandomState(seed), n) as numpy arrays"""
    return tuple(np.asarray(a)[:B] for a in _sim_batch(np.random.RandomState(seed), n))


@functools.lru_cache(maxsize=None)
def _stacked(seed, n, conf=CONF):
    """the port's stacked pixels [5 B, P] and psf moments [5 B, 3] of
    the five types under conf, and JAX's copies of them"""
    args = [torch.as_tensor(a.copy()) for a in _inputs(seed, n)]
    pixels, sigma, psfdict = tbatch._stacked_pixels(*args, conf, with_psf_stamps=False)
    psf = tbatch._lm_psf_moms(conf, sigma, psfdict)
    jpix = JPixels(*(jnp.asarray(x.numpy()) for x in pixels))
    return pixels, psf, jpix, jnp.asarray(psf.numpy())


def _jbox(box):
    return None if box is None else tuple(np.asarray(x, dtype=np.float64) for x in box)


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _assert_match(out, ref, keys=("pars", "pars_err", "s2n", "flux")):
    out, ref = _np(out), _np(ref)
    assert set(out) == set(ref), set(out) ^ set(ref)
    np.testing.assert_array_equal(out["flags"], ref["flags"])
    assert np.all(np.abs(out["nfev"].astype(int) - ref["nfev"]) <= 2), (out["nfev"], ref["nfev"])
    for k in keys:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-8, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(out["e1"], out["pars"][:, 2])


def _jax_measure(jpix, jpsf, lm_conf, model, box, **kw):
    return jax.jit(lambda: jbatch._exp_lm_measure(jpix, jpsf, lm_conf, model=model,
                                                  bounds=_jbox(box), **kw))()


# ----------------------------------------------------------------------
# flux_col

@pytest.mark.parametrize("model", ["exp", "bdf"])
def test_flux_col_matches_jax(model):
    """the reference's analytic flux column against the port, whose
    normal equations are in closed form already: its flux_col result is
    its default result, bit for bit"""
    pixels, psf, jpix, jpsf = _stacked(31, 12)
    box = None if model == "exp" else FLUXCOL_BDF_BOX
    ref = _jax_measure(jpix, jpsf, jlm.LMConf(flux_col=True), model, box)
    out = tbatch._exp_lm_measure(pixels, psf, tlm.LMConf(flux_col=True), model=model, bounds=box)
    default = tbatch._exp_lm_measure(pixels, psf, tlm.LMConf(), model=model, bounds=box)
    for k, v in default.items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0, msg=k)
    _assert_match(out, ref)
    assert np.all(np.asarray(ref["flags"]) == 0)


# ----------------------------------------------------------------------
# varpro

@pytest.mark.parametrize("model", ["exp", "bdf"])
def test_varpro_matches_jax(model):
    """variable projection, exp unbounded and bdf inside a shape box
    (fracdev in [0, 1], the flux open), against the reference's; it
    converges to the standard solve's optimum"""
    pixels, psf, jpix, jpsf = _stacked(17, 16)
    box = None if model == "exp" else VARPRO_BOX["bdf"]
    ref = _jax_measure(jpix, jpsf, jlm.LMConf(varpro=True), model, box)
    out = tbatch._exp_lm_measure(pixels, psf, tlm.LMConf(varpro=True), model=model, bounds=box)
    _assert_match(out, ref)
    assert np.all(np.asarray(ref["flags"]) == 0)
    if model == "exp":
        # the reference test's check: the standard solve's optimum
        std = tbatch._exp_lm_measure(pixels, psf, tlm.LMConf())
        np.testing.assert_allclose(out["pars"].numpy(), std["pars"].numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_varpro_guards_raise():
    """the reference's ValueErrors: a prior, a bounded flux; the guards
    hold only where varpro runs (not for refine, not for the mb fit)"""
    pixels, psf, _, _ = _stacked(17, 16)
    vp = tlm.LMConf(varpro=True)
    prior = convert.prior_from_object(_priors.get_prior(fit_model="exp",
                                                         rng=np.random.RandomState(0)))
    lo, hi = (list(x) for x in VARPRO_BOX["exp"])
    lo[5], hi[5] = 1e-3, 1e9
    for kw in (dict(prior=prior), dict(bounds=(lo, hi))):
        with pytest.raises(ValueError, match="varpro"):
            tbatch._exp_lm_measure(pixels, psf, vp, **kw)
        with pytest.raises(ValueError, match="varpro"):
            jbatch._exp_lm_measure(JPixels(*(jnp.asarray(x.numpy()) for x in pixels)),
                                   jnp.asarray(psf.numpy()), jlm.LMConf(varpro=True),
                                   prior=None if "bounds" in kw else _priors.get_prior(
                                       fit_model="exp", rng=np.random.RandomState(0)),
                                   bounds=_jbox(kw.get("bounds")))
        pkw = dict(lm_prior=kw.get("prior"), lm_bounds=kw.get("bounds"))
        with pytest.raises(ValueError, match="varpro"):
            nt.make_metacal_pipeline_fn(CONF, measure="exp-lm", lm_conf=vp, device="cpu", **pkw)
        # the mb fit ignores varpro, as the reference's does
        nt.make_metacal_pipeline_mb_fn(CONF, np.zeros(1, np.int32), 1, lm_conf=vp, device="cpu",
                                       **pkw)
    with pytest.raises(ValueError, match="host-loop"):
        tbatch._exp_lm_measure(pixels, psf, vp, host_loop=True)
    with pytest.raises(ValueError, match="exactly"):
        lm_solve.lm_solve(*(torch.as_tensor(x) for x in _small_args()), vp, "exp", prior,
                          varpro=True)
    # refine takes precedence over varpro, and then the guards do not apply
    sl = slice(0, B)
    ref = tbatch._exp_lm_measure(tbatch.Pixels(*(x[sl] for x in pixels)), psf[sl], vp,
                                 prior=prior, refine=1)
    assert ref["nfev"].tolist() == [2] * B


# ----------------------------------------------------------------------
# run_gn_refine_batched

@pytest.mark.parametrize("niter", [0, 3])
def test_gn_refine_matches_jax(niter):
    """the damped Gauss-Newton refiner with a prior and a saturated bound:
    T's lower bound above every lane's optimum, so the refiner's pin
    holds T there while the other dims move"""
    pixels, psf, jpix, jpsf = _stacked(71, 16)
    sl = slice(0, B)
    pix = tbatch.Pixels(*(x[sl] for x in pixels))
    jp = JPixels(*(x[sl] for x in jpix))
    free = tbatch._exp_lm_measure(pix, psf[sl], tlm.LMConf())["pars"]
    lo = torch.tensor([-2.0, -2.0, -0.99, -0.99, float(free[:, 4].max()) * 1.2, 1e-3],
                      dtype=torch.float64)
    hi = torch.tensor([2.0, 2.0, 0.99, 0.99, 20.0, 1e9], dtype=torch.float64)
    guess = tbatch._clamp_guess_in_bounds(free * torch.tensor([1, 1, 1.01, 0.99, 1, 1.01],
                                                              dtype=torch.float64), lo, hi)
    jprior = _priors.get_prior(fit_model="exp", rng=np.random.RandomState(0))
    prior = convert.prior_from_object(jprior)
    nres = torch.sum(pix.ierr > 0, dim=-1)
    psf_gmix = tbatch._psf_gmix(psf[sl])
    out = tlm.run_gn_refine_batched(
        functools.partial(tbatch._normal_fn, model="exp"),
        (tbatch._lm_planes(pix), psf_gmix), guess, lo, hi, tlm.LMConf(), nres, niter=niter,
        prior_fn=prior.fill_fdiff_jacobian)
    from ngmix_tpu.gmix import core as jcore
    ref = jax.jit(lambda: jlm.run_gn_refine_batched(
        jbatch._make_ad_normal_fn(jcore.fill_exp), (jp, jnp.asarray(psf_gmix.numpy())),
        jnp.asarray(guess.numpy()), jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
        jlm.LMConf(), jnp.asarray(nres.numpy()), niter=niter,
        prior_fn=jprior.fill_fdiff_device))()
    ref = _np(ref)
    assert set(out) == set(ref)
    for k in ("flags", "nfev", "ier"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    for k in ("pars", "pars_err", "pars_cov", "cost", "s_sq"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-8, atol=1e-10, err_msg=k)
    assert out["nfev"].tolist() == [niter + 1] * B
    # T held on its bound, the other dims moved off the guess
    np.testing.assert_allclose(out["pars"][:, 4].numpy(), lo[4].item(), rtol=1e-6)
    if niter:
        assert bool((out["pars"][:, 2] != guess[:, 2]).all())
    state = tlm.run_gn_refine_state(functools.partial(tbatch._normal_fn, model="exp"),
                                    (tbatch._lm_planes(pix), psf_gmix), guess, lo, hi,
                                    tlm.LMConf(), niter=niter,
                                    prior_fn=prior.fill_fdiff_jacobian)
    assert bool(state["pinned"][:, 4].all()) == bool(niter)
    # k_space (the k-space fitters' complex residuals) halves the dof of
    # the covariance, nres // 2 - npars, and changes nothing else
    kout = tlm.run_gn_refine_batched(
        functools.partial(tbatch._normal_fn, model="exp"),
        (tbatch._lm_planes(pix), psf_gmix), guess, lo, hi, tlm.LMConf(), nres, niter=niter,
        k_space=True, prior_fn=prior.fill_fdiff_jacobian)
    for k in ("pars", "flags", "nfev", "ier", "cost"):
        assert torch.equal(kout[k], out[k]), k
    ratio = (nres - 6).double() / (nres // 2 - 6).double()
    np.testing.assert_allclose(kout["s_sq"].numpy(), (out["s_sq"] * ratio).numpy(), rtol=1e-14)
    np.testing.assert_allclose(kout["pars_err"].numpy(),
                               (out["pars_err"] * ratio[:, None].sqrt()).numpy(), rtol=1e-13)


# ----------------------------------------------------------------------
# sheared_refine

@pytest.mark.parametrize("model", ["exp", "bdf"])
def test_sheared_refine_matches_jax(model):
    """the noshear LM and the sheared types' refinement (exp-lm, and
    bounded bdf-lm on pure-exp truth with fracdev on its bound) against
    the reference's _lm_with_sheared_refine; the pipeline with
    conf.sheared_refine = 3 runs it on the same stamps"""
    # bdf on the reference's 25x25 window, where its fracdev pin holds
    # every lane within 5e-3 of the bound
    seed, box, conf = (71, None, CONF) if model == "exp" else (
        73, REFINE_BDF_BOX, CONF._replace(fit_dims=(25, 25)))
    pixels, psf, jpix, jpsf = _stacked(seed, 16, conf)
    out = tbatch._lm_with_sheared_refine(pixels, psf, tlm.LMConf(), TYPES, B, 3, model=model,
                                         bounds=box)
    # the noshear lanes are the standard LM (held against the JAX package
    # above); the reference refines the others from their pars, tiled
    guess = jnp.asarray(np.tile(out["pars"][:B].numpy(), (4, 1)))
    ref = _jax_measure(JPixels(*(x[B:] for x in jpix)), jpsf[B:], jlm.LMConf(), model, box,
                       guess=guess, refine=3)
    out = {k: v[B:] if isinstance(v, torch.Tensor) and v.dim() and len(v) == 5 * B else v
           for k, v in out.items()}
    _assert_match(out, ref)
    assert np.all(np.asarray(ref["flags"]) == 0)
    assert out["nfev"].tolist() == [4] * (4 * B)
    if model == "bdf":
        assert float(out["fracdev"].max()) < 5e-3
    res = nt.metacal_pipeline(*_inputs(seed, 16), conf._replace(sheared_refine=3),
                              measure=model + "-lm", lm_bounds=box, device="cpu")
    for i, t in enumerate(TYPES[1:]):
        for k in ("pars", "flags", "nfev", "s2n"):
            torch.testing.assert_close(res[t][k], out[k][i * B:(i + 1) * B], rtol=0, atol=0,
                                       msg=(t, k))


def test_sheared_refine_dispatch():
    """refinement needs "noshear" among more than one type, the psf-sheared
    types of dilate mode included; otherwise every lane takes the LM"""
    args = [a[:2] for a in _inputs(71, 16)]
    dil = CONF._replace(psf_mode="dilate", types=tbatch.GALSHEAR_TYPES + tbatch.PSFSHEAR_TYPES,
                        sheared_refine=2)
    res = nt.metacal_pipeline(*args, dil, measure="exp-lm", device="cpu")
    for t in dil.types:
        assert res[t]["nfev"].tolist() == ([3, 3] if t != "noshear" else res[t]["nfev"].tolist())
    assert res["noshear"]["nfev"].min() > 3
    for types in (("noshear",), ("1p", "1m")):
        conf = CONF._replace(types=types)
        ref = nt.metacal_pipeline(*args, conf, measure="exp-lm", device="cpu")
        out = nt.metacal_pipeline(*args, conf._replace(sheared_refine=2), measure="exp-lm",
                                  device="cpu")
        for t in types:
            torch.testing.assert_close(out[t]["pars"], ref[t]["pars"], rtol=0, atol=0)


# ----------------------------------------------------------------------
# the modes of K3 on a mocked card

@pytest.mark.parametrize("mode", ["refine", "varpro"])
def test_cuda_tensors_launch_the_options_kernel(monkeypatch, mode):
    """refine and varpro on CUDA tensors are one launch of the model's
    options kernel, never the plain version: the mode, niter and the
    Gauss-Newton damping after the LMConf; varpro starts the flux dim at
    0 and returns the reduced state with the full-width one"""
    calls = _mock_card(monkeypatch, 0)
    monkeypatch.setattr(lm_solve, "launches_refine", 0)
    monkeypatch.setattr(lm_solve, "launches_varpro", 0)
    args = [_fake_cuda(x) for x in _small_args()]
    conf = tlm.LMConf(maxfev=77)
    kw = dict(refine=3) if mode == "refine" else dict(varpro=True)
    out = lm_solve.lm_solve(*args, conf, "exp", None, **kw)
    assert (lm_solve.launches, lm_solve.launches_refine, lm_solve.launches_varpro) == (
        (0, 1, 0) if mode == "refine" else (0, 0, 1))
    (_, dev), c = calls
    assert c[1:8] == tuple(x.data_ptr() for x in args[1:])
    assert c[26:] == (3, 50, 0, 77, lm_solve.MODE_REFINE if mode == "refine"
                      else lm_solve.MODE_VARPRO, 3 if mode == "refine" else 0,
                      conf.ftol, conf.xtol, conf.lambda0, conf.lambda_up, conf.lambda_down,
                      conf.lambda_min, conf.lambda_max, lm_solve.GN_LAMBDA, 4321)
    if mode == "refine":
        assert c[0] == args[0].data_ptr() and set(out) == set(lm_solve._empty_state(args[0]))
    else:
        assert c[0] != args[0].data_ptr()
        assert out["y"].shape == (3, 5) and out["JtJ"].shape == (3, 5, 5)
        assert out["full"]["y"].shape == (3, 6) and out["full"]["nfev"].tolist() == [1] * 3


def test_options_kernel_units_in_the_library(monkeypatch):
    """K3's options kernel builds from units of its own, compiled beside
    the others into the one library, and load() binds its C functions"""
    import ctypes
    import types

    from ngmix_tpu_torch.ops import _build

    opt = {"lm_solve_opt.cu"} | {"lm_solve_opt_%s.cu" % m for m in _build.LM_MODELS[1:]}
    assert opt <= {s.name for s in _build.sources()}
    compiles, link = _build.nvcc_commands("out.so")
    assert opt <= {c[-1].rsplit("/", 1)[-1] for c in compiles}
    assert len(compiles) == len(_build.sources()) and len(link) == 4 + len(compiles)

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: "libfake.so")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    lib = _build.load()
    for m in _build.LM_MODELS:
        for dt in ("f32", "f64"):
            assert len(getattr(lib, "ngmix_lm_solve_opt_%s_%s" % (m, dt)).argtypes) == 41
            assert len(getattr(lib, "ngmix_lm_solve_opt_%s_%s_attrs" % (m, dt)).argtypes) == 2
