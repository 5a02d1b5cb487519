"""The port's bootstraps against ngmix_tpu's on the same inputs:
bootstrap / Bootstrapper (Fitter("gauss") psf fits, then Fitter("gauss")
from a TFluxGuesser or GaussMom on the object), remove_failed_psf_obs
(with BootPSFFailure), MetacalBootstrapper with Runner(GaussMom(1.2))
and with Runner(Fitter("exp"), guesser), type by type; the reference's
shear oracle (tests/test_metacal.py:204-249) on the port, |m| < 1e-3;
and the kernels' launches through a metacal bootstrap on a mocked card:
K3 once a fit of the K3 route, K2 once a GaussMom measurement.

The stamps are tests/_sims.get_model_obs at 25x25 (the oracle's 49x49
under a turb psf), carried across by
convert.observation_from_object(device="cpu"), so the port runs the
kernels' plain versions; both sides draw from numpy RandomStates of
one seed in the reference's order (the psf guesser, the fixnoise
field, the psf noise of the gaussian target, the object guesser).
Flags equal; moments to rtol 1e-10 (+ atol 1e-12), LM fields to rtol
1e-5 (+ atol 1e-12) with nfev within 2; every fit's route asserted.
"""
import contextlib
import functools
import types

import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import guessers as jguessers
from ngmix_tpu.bootstrap import remove_failed_psf_obs as jremove

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, guessers
from ngmix_tpu_torch.bootstrap import BOOT_WEIGHTS_LOW, remove_failed_psf_obs
from ngmix_tpu_torch.gexceptions import BootPSFFailure
from ngmix_tpu_torch.ops import _build, gmix_eval, lm_solve

from _sims import get_model_obs
from test_torch_fitters import _fake_cuda, assert_fit_equal

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

DIMS = (25, 25)
SCALE = 0.263
TYPES = ["noshear", "1p", "1m"]
MOM_KEYS = ("e", "e_err", "T", "T_err", "flux", "flux_err", "s2n")


def _pair(seed, model="gauss", noise=0.05):
    rng = np.random.RandomState(seed)
    data = get_model_obs(rng=rng, model=model, T=1.2, g1=0.1, g2=-0.05, flux=100.0,
                         noise=noise, dims=DIMS)
    return data["obs"], convert.observation_from_object(data["obs"], device="cpu")


def _assert_moments_equal(tres, jres):
    assert int(tres["flags"]) == int(jres["flags"])
    for k in MOM_KEYS:
        np.testing.assert_allclose(np.asarray(tres[k]), np.asarray(jres[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)


def _psf_runner(pkg, gmod, seed):
    return pkg.PSFRunner(fitter=pkg.Fitter(model="gauss"), ntry=3,
                         guesser=gmod.SimplePSFGuesser(rng=np.random.RandomState(seed),
                                                       guess_from_moms=True))


def _psf_routes(obs):
    """the route of each psf fit the psf runner stored"""
    leaves = [obs] if isinstance(obs, nt.Observation) else [o for ol in obs for o in (
        ol if isinstance(ol, nt.ObsList) else [ol])]
    return {o.psf.meta["result"].route for o in leaves}


def test_bootstrapper_matches_jax():
    """the canonical two stages: the psf fit (K3 without a psf), then
    Fitter("gauss") from TFluxGuesser's draws (K3 under the fitted one
    gaussian psf)"""
    jobs, tobs = _pair(33)
    boots = {}
    for pkg, gmod, obs in ((jn, jguessers, jobs), (nt, guessers, tobs)):
        runner = pkg.Runner(fitter=pkg.Fitter(model="gauss"), ntry=3,
                            guesser=gmod.TFluxGuesser(rng=np.random.RandomState(8), T=1.0,
                                                      flux=90.0))
        boots[pkg] = pkg.Bootstrapper(runner=runner, psf_runner=_psf_runner(pkg, gmod, 3))
        assert boots[pkg].fitter is runner.fitter
    jres = boots[jn].go(jobs)
    tres = boots[nt].go(tobs)
    assert tres.route == "K3" and _psf_routes(tobs) == {"K3"}
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    np.testing.assert_allclose(tobs.psf.gmix.get_data(), jobs.psf.gmix.get_data(), rtol=1e-5,
                               atol=1e-12)
    assert "result" in tobs.psf.meta


def test_bootstrap_gaussmom_matches_jax():
    """bootstrap with a moments measurer (no guesser), on an ObsList
    of two epochs"""
    jl, tl = jn.ObsList(), nt.ObsList()
    for seed in (34, 35):
        jobs, tobs = _pair(seed)
        jl.append(jobs)
        tl.append(tobs)
    jres = jn.bootstrap.bootstrap(jl, jn.Runner(jn.GaussMom(fwhm=1.2)),
                                  psf_runner=_psf_runner(jn, jguessers, 4))
    tres = nt.bootstrap.bootstrap(tl, nt.Runner(nt.GaussMom(fwhm=1.2)),
                                  psf_runner=_psf_runner(nt, guessers, 4))
    assert _psf_routes(tl) == {"K3"}
    _assert_moments_equal(tres, jres)


def test_remove_failed_psf_obs():
    """the epochs whose psf fit failed go, the container kept; none left,
    or a band emptied, raises BootPSFFailure; the flag bits"""
    jl, tl = jn.ObsList(), nt.ObsList()
    for i, seed in enumerate((36, 37)):
        jobs, tobs = _pair(seed)
        jobs.psf.meta["result"] = {"flags": i}
        tobs.psf.meta["result"] = {"flags": i}
        jl.append(jobs)
        tl.append(tobs)
    kept = remove_failed_psf_obs(tl)
    assert isinstance(kept, nt.ObsList) and len(kept) == len(jremove(jl)) == 1
    assert kept[0] is tl[0]
    mb = nt.MultiBandObsList()
    mb.append(tl)
    assert len(remove_failed_psf_obs(mb)[0]) == 1
    assert remove_failed_psf_obs(tl[0]) is tl[0]
    for obs in tl:
        obs.psf.meta["result"] = {"flags": 1}
    for bad in (tl, tl[1], mb):
        with pytest.raises(BootPSFFailure):
            remove_failed_psf_obs(bad)
    # ignore_failed_psf=False keeps the failed epochs for the object fit
    runner = nt.Runner(nt.GaussMom(fwhm=1.2))
    res = nt.bootstrap.bootstrap(tl, runner, ignore_failed_psf=False)
    assert int(res["flags"]) == 0
    assert BOOT_WEIGHTS_LOW == jn.bootstrap.BOOT_WEIGHTS_LOW == 2**5


def _metacal_boot(pkg, gmod, runner, seed, **kw):
    return pkg.MetacalBootstrapper(runner=runner, psf_runner=_psf_runner(pkg, gmod, seed),
                                   rng=np.random.RandomState(seed + 1), **kw)


def test_metacal_bootstrapper_gaussmom_matches_jax():
    """MetacalBootstrapper with Runner(GaussMom(1.2)) under psf='gauss':
    every type's moments and the metacal images type by type"""
    jobs, tobs = _pair(41, noise=0.01)
    jd, jod = _metacal_boot(jn, jguessers, jn.Runner(jn.GaussMom(fwhm=1.2)), 5,
                            psf="gauss", types=TYPES).go(jobs)
    tboot = _metacal_boot(nt, guessers, nt.Runner(nt.GaussMom(fwhm=1.2)), 5, psf="gauss",
                          types=TYPES)
    assert isinstance(tboot.fitter, nt.GaussMom)
    td, tod = tboot.go(tobs)
    assert list(td) == list(jd) == TYPES
    for key in TYPES:
        _assert_moments_equal(td[key], jd[key])
        np.testing.assert_allclose(tod[key].image, jod[key].image, rtol=1e-8,
                                   atol=1e-10 * np.abs(jod[key].image).max())
        assert tod[key].psf.meta["result"].route == "K3"


def test_metacal_bootstrapper_exp_fitter_matches_jax():
    """MetacalBootstrapper with Runner(Fitter("exp"), TFluxGuesser) under
    psf='fitgauss' (admom of the psf, then every type's psf fit and
    object fit on K3), the LM fields type by type"""
    jobs, tobs = _pair(42, model="exp", noise=0.01)
    kw = dict(psf="fitgauss", types=TYPES)
    res = {}
    for pkg, gmod, obs in ((jn, jguessers, jobs), (nt, guessers, tobs)):
        runner = pkg.Runner(fitter=pkg.Fitter(model="exp"), ntry=2,
                            guesser=gmod.TFluxGuesser(rng=np.random.RandomState(6), T=1.2,
                                                      flux=100.0))
        res[pkg] = _metacal_boot(pkg, gmod, runner, 7, **kw).go(obs)
    (jd, jod), (td, tod) = res[jn], res[nt]
    for key in TYPES:
        assert td[key].route == "K3" and tod[key].psf.meta["result"].route == "K3"
        assert td[key]["flags"] == 0
        assert_fit_equal(td[key], jd[key])


def test_shear_oracle_on_the_port():
    """the reference's shear oracle (tests/test_metacal.py:204-249) on
    the port: five 49x49 exp galaxies sheared by (0.02, 0) under a turb
    psf, psf fits by Fitter("gauss"), GaussMom(1.2) on noshear, 1p and
    1m: |m| < 1e-3"""
    rng = np.random.RandomState(314)
    psf_runner = nt.PSFRunner(fitter=nt.Fitter(model="gauss"), ntry=3,
                              guesser=guessers.SimplePSFGuesser(rng=rng, guess_from_moms=True))
    boot = nt.MetacalBootstrapper(runner=nt.Runner(fitter=nt.GaussMom(fwhm=1.2)),
                                  psf_runner=psf_runner, rng=rng, psf="gauss", types=TYPES)
    e1 = {k: [] for k in TYPES}
    for _ in range(5):
        gal = nt.GMixModel([0.0, 0.0, 0.0, 0.0, 0.5, 100.0], "exp").get_sheared(0.02, 0.0)
        psf = nt.GMixModel([0.0, 0.0, 0.025, -0.01, 0.27, 1.0], "turb")
        off = rng.uniform(low=-0.5, high=0.5, size=2)
        jac = nt.DiagonalJacobian(row=24 + off[0], col=24 + off[1], scale=SCALE)
        pjac = nt.DiagonalJacobian(row=12, col=12, scale=SCALE)
        img = gal.convolve(psf).make_image((49, 49), jacobian=jac, device="cpu")
        img = img + rng.normal(size=img.shape) * 1e-5
        pimg = psf.make_image((25, 25), jacobian=pjac, device="cpu")
        obs = nt.Observation(img, weight=np.full((49, 49), 1e10), jacobian=jac, device="cpu",
                             psf=nt.Observation(pimg, jacobian=pjac, device="cpu"))
        resdict, obsdict = boot.go(obs)
        for k in TYPES:
            assert int(resdict[k]["flags"]) == 0
            assert obsdict[k].psf.meta["result"].route == "K3"
            e1[k].append(float(resdict[k]["e1"]))
    R11 = (np.mean(e1["1p"]) - np.mean(e1["1m"])) / 0.02
    m = np.mean(e1["noshear"]) / R11 / 0.02 - 1
    assert abs(m) < 1.0e-3, m


def _mock_card(monkeypatch):
    """a card whose kernels are their plain versions: the K3 and K2
    wrappers get their inputs as fake CUDA tensors (CPU data reporting a
    CUDA device), so they take their launch path, and the fake library
    they launch computes the plain version into the outputs the wrapper
    made. lm_solve.launches and gmix_eval.launches count as on the card;
    a plain version called by a wrapper on a CUDA tensor fails."""
    pending = {}
    real_k3, real_k2 = lm_solve.lm_solve, gmix_eval.eval_gmix
    k3_plain, k2_plain = lm_solve.lm_solve_plain, gmix_eval.eval_gmix_plain

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")

    def capture(mod, name):
        real = getattr(mod, name)

        def made(*a):
            pending[name] = real(*a)
            return pending[name]
        monkeypatch.setattr(mod, name, made)

    capture(lm_solve, "_empty_state")
    capture(gmix_eval, "_empty_at")

    def k3_kernel(*ptrs):
        args, kw = pending.pop("k3")
        res = k3_plain(*args, **kw)
        for k, out in pending.pop("_empty_state").items():
            out.copy_(res[k])
        return 0

    def k2_kernel(*ptrs):
        pending.pop("_empty_at").copy_(k2_plain(*pending.pop("k2")))
        return 0

    def k2_attrs(fast, n, smem, out):
        out[0], out[1], out[2], out[3] = 40, 16, smem, 3
        return 0

    lib = types.SimpleNamespace(
        ngmix_gmix_eval_f64=k2_kernel, ngmix_gmix_eval_attrs_f64=k2_attrs,
        **{lm_solve.c_name("lm_solve", m, torch.float64): k3_kernel for m in lm_solve.MODELS})
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(gmix_eval, "_attrs", functools.lru_cache()(gmix_eval._attrs.__wrapped__))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=4321))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(lm_solve, "lm_solve_plain", no_plain)
    monkeypatch.setattr(gmix_eval, "eval_gmix_plain", no_plain)

    def plain_tensor(x):
        return x.as_subclass(torch.Tensor)

    def k3_on_card(guess, lo, hi, psf, v, u, ia, ve, conf, model="exp", prior=None):
        pending["k3"] = ((guess, lo, hi, psf, v, u, ia, ve, conf), dict(model=model, prior=prior))
        out = real_k3(*(_fake_cuda(x) for x in (guess, lo, hi, psf, v, u, ia, ve)), conf,
                      model=model, prior=prior)
        return {k: plain_tensor(x) for k, x in out.items()}

    def k2_on_card(gmix, v, u, area=1.0, fast=True):
        pending["k2"] = (gmix, v, u, area, fast)
        card_area = _fake_cuda(area) if torch.is_tensor(area) and area.dim() else area
        return plain_tensor(real_k2(_fake_cuda(gmix), _fake_cuda(v), _fake_cuda(u), card_area,
                                    fast=fast))

    monkeypatch.setattr(lm_solve, "lm_solve", k3_on_card)
    monkeypatch.setattr(gmix_eval, "eval_gmix", k2_on_card)
    monkeypatch.setattr(lm_solve, "launches", 0)
    monkeypatch.setattr(gmix_eval, "launches", 0)


def test_kernel_launches_through_the_metacal_bootstrap(monkeypatch):
    """K3 and K2 launches on a mocked card (_mock_card) through
    MetacalBootstrapper(Runner(GaussMom)) and
    MetacalBootstrapper(Runner(Fitter("exp"))): one K3 launch a Fitter
    fit (every psf fit and object fit takes K3), none for GaussMom; one
    K2 launch a GaussMom measurement, and a Fitter fit's K2 launches
    (its moments guess and s/n sums) as one fit alone makes them"""
    calls = {"fits": 0, "moms": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    _, tobs = _pair(43, model="exp", noise=0.01)
    _mock_card(monkeypatch)
    monkeypatch.setattr(nt.Fitter, "go", counted("fits", nt.Fitter.go))
    monkeypatch.setattr(nt.GaussMom, "go", counted("moms", nt.GaussMom.go))

    def launches():
        return lm_solve.launches, gmix_eval.launches

    def reset():
        monkeypatch.setattr(lm_solve, "launches", 0)
        monkeypatch.setattr(gmix_eval, "launches", 0)
        calls.update(fits=0, moms=0)

    # one psf fit (SimplePSFGuesser's moments guess and the fit) and one
    # object fit alone: their K2 launches
    one = tobs.copy()
    _psf_runner(nt, guessers, 1).go(one)
    assert one.psf.meta["result"]["flags"] == 0
    k3, k2_psf = launches()
    assert k3 == 1
    reset()
    res = nt.Fitter("exp").go(one, np.array([0.0, 0.0, 0.0, 0.0, 1.2, 100.0]))
    assert res.route == "K3" and res["flags"] == 0
    k3, k2_fit = launches()
    assert k3 == 1
    reset()
    assert nt.GaussMom(fwhm=1.2).go(tobs)["flags"] == 0
    assert launches() == (0, 1)

    for runner, object_fits in ((nt.Runner(nt.GaussMom(fwhm=1.2)), False),
                                (nt.Runner(nt.Fitter("exp"), guesser=guessers.TFluxGuesser(
                                    rng=np.random.RandomState(2), T=1.2, flux=100.0)), True)):
        reset()
        resdict, obsdict = _metacal_boot(nt, guessers, runner, 9, psf="gauss",
                                         types=TYPES).go(tobs)
        assert all(r["flags"] == 0 for r in resdict.values())
        assert all(o.psf.meta["result"].route == "K3" for o in obsdict.values())
        # a psf fit a type (first tries succeed on this seed), and an
        # object fit or a measurement a type
        n = len(TYPES)
        assert (calls["fits"], calls["moms"]) == ((2 * n, 0) if object_fits else (n, n))
        k3, k2 = launches()
        assert k3 == calls["fits"]
        assert k2 == n * k2_psf + (n * k2_fit if object_fits else n)
