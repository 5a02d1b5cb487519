"""The port's k-space half against ngmix_tpu's on the same inputs: the
k observations (KObservation, KObsList, KMultiBandObsList, make_kobs,
make_iilist, get_kmb_obs: the containers, the centres of even
dimensions, the errors, make_iilist's transforms equal to make_kobs's);
KSpaceFitter on gauss and exp against the JAX fitters (flags equal,
pars and pars_err to rtol 1e-5, nfev within 2; the Spergel and Moffat
fitters and their tables are in tests/test_torch_kspace_profiles.py
and KSpacePSFFluxFitter in tests/test_torch_metacal.py, since each JAX
fit compiles its own closure), from a real-space observation against
its make_kobs, and over two bands of one k observation against its
one-band fit; and run_lm, _normal_epilogue and run_gn_refine_batched with
k_space=True (the dof of complex residuals) at rtol 1e-8 + atol 1e-10
(run_lm_normal_batched's against its own k_space=False).

The stamps are 25x25 renders of the port on the CPU; both packages'
observations hold the same numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu.fitting import kspace_fitters as jk, lm as jlm

import ngmix_tpu_torch as nt
from ngmix_tpu_torch.fitting import kspace_fitters as tk, lm as tlm

from test_torch_fitters import PROBLEMS

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

SCALE = 0.263
DIMS = (25, 25)


def _pair(seed, T=0.9, g1=0.05, g2=-0.03, flux=100.0, noise=1e-3, model="gauss", psf_T=0.3,
          with_psf=True):
    """a JAX package observation and the port's of the same numpy
    stamps (rendered by the port on the CPU, which costs no JAX
    compile)"""
    rng = np.random.RandomState(seed)
    gal = nt.GMixModel([0.0, 0.0, g1, g2, T, flux], model)
    psf = nt.GMixModel([0.0, 0.0, 0.0, 0.0, psf_T, 1.0], "gauss")
    jac = dict(row=12.2, col=11.9, scale=SCALE)
    pjac = dict(row=12.0, col=12.0, scale=SCALE)
    img = (gal.convolve(psf) if with_psf else gal).make_image(
        DIMS, jacobian=nt.DiagonalJacobian(**jac), device="cpu")
    img = img + rng.normal(size=DIMS, scale=noise)
    weight = np.full(DIMS, 1.0 / noise**2)
    pairs = []
    for pkg, kw in ((jn, {}), (nt, dict(device="cpu"))):
        psf_obs = None
        if with_psf:
            pimg = psf.make_image(DIMS, jacobian=nt.DiagonalJacobian(**pjac), device="cpu")
            psf_obs = pkg.Observation(pimg, weight=np.full(DIMS, 1e6),
                                      jacobian=pkg.DiagonalJacobian(**pjac), **kw)
        pairs.append(pkg.Observation(img, weight=weight, jacobian=pkg.DiagonalJacobian(**jac),
                                     psf=psf_obs, **kw))
    return tuple(pairs)


def _assert_fit_equal(tres, jres):
    assert tres["flags"] == jres["flags"] == 0
    assert abs(tres["nfev"] - jres["nfev"]) <= 2
    for k in ("pars", "pars_err", "g", "flux", "flux_err", "s2n_r"):
        np.testing.assert_allclose(np.asarray(tres[k]), np.asarray(jres[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)


# ----------------------------------------------------------------------
# the k observations

def _kobs_pair(dim=33, scale=0.1):
    rng = np.random.RandomState(3)
    kim = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    pim = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    psf = nt.KObservation(pim, scale=scale, device="cpu")
    return nt.KObservation(kim, psf=psf, scale=scale, device="cpu"), psf


def test_kobservation_containers_and_errors():
    kobs, psf = _kobs_pair()
    assert kobs.has_psf() and kobs.psf is psf
    assert np.all(kobs.weight == 1.0)
    assert kobs.jacobian.get_cen() == (16.0, 16.0)
    assert np.isclose(kobs.jacobian.scale, 0.1)
    # an even dimension: k = 0 half a pixel past the middle
    even = nt.KObservation(np.zeros((32, 32), dtype=complex), scale=0.1, device="cpu")
    assert even.jacobian.get_cen() == (16.0, 16.0)
    with pytest.raises(ValueError, match="complex"):
        nt.KObservation(np.zeros((8, 8)), device="cpu")
    kim = np.zeros((8, 8), dtype=complex)
    with pytest.raises(ValueError, match="same shape"):
        nt.KObservation(kim, weight=np.ones((4, 4)), device="cpu")
    small = nt.KObservation(np.zeros((4, 4), dtype=complex), scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="psf kimage"):
        nt.KObservation(kim, psf=small, device="cpu")
    mb = nt.get_kmb_obs(kobs)
    assert isinstance(mb, nt.KMultiBandObsList) and mb[0][0] is kobs
    kl = nt.KObsList()
    kl.append(kobs)
    assert nt.get_kmb_obs(kl)[0] is kl
    assert nt.get_kmb_obs(mb) is mb
    with pytest.raises(ValueError):
        nt.get_kmb_obs(nt.Observation(np.zeros((4, 4)), device="cpu"))
    with pytest.raises(AssertionError):
        kl.append(nt.Observation(np.zeros((4, 4)), device="cpu"))
    with pytest.raises(AssertionError):
        mb.append(kobs)
    assert nt.observation.KObservation is nt.KObservation


def test_make_kobs_and_make_iilist_match_jax(monkeypatch):
    """make_kobs over two bands against the JAX package's (the k images
    at rtol 1e-10 with an atol of 1e-12 of the peak, the weights, dk),
    and make_iilist's dim, dk and transforms equal to make_kobs's, each
    transform computed on its observation's device"""
    jm, tm = jn.MultiBandObsList(), nt.MultiBandObsList()
    for seed in (5, 6):
        jobs, tobs = _pair(seed)
        jl, tl = jn.ObsList(), nt.ObsList()
        jl.append(jobs)
        tl.append(tobs)
        jm.append(jl)
        tm.append(tl)
    jk_mb = jn.make_kobs(jm, pad_factor=2)
    tk_mb = nt.make_kobs(tm, pad_factor=2)
    assert isinstance(tk_mb, nt.KMultiBandObsList) and len(tk_mb) == 2
    for jl, tl in zip(jk_mb, tk_mb):
        for j, t in zip(jl, tl):
            assert t.kimage.shape == j.kimage.shape and t.kimage.shape[0] % 2 == 1
            assert t.scale == pytest.approx(j.scale, rel=1e-15)
            assert t.device == torch.device("cpu")
            for a, b in ((t.kimage, j.kimage), (t.psf.kimage, j.psf.kimage)):
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12 * np.abs(b).max())
            np.testing.assert_array_equal(t.weight, j.weight)
            np.testing.assert_array_equal(t.psf.weight, j.psf.weight)
            assert t.meta == j.meta
    mb_ii, dim, dk = nt.make_iilist(tm, pad_factor=2)
    kobs = tk_mb[0][0]
    assert dim == kobs.kimage.shape[0] and np.isclose(dk, kobs.scale)
    entry = mb_ii[0][0]
    assert entry["scale"] == tm[0][0].jacobian.scale
    np.testing.assert_array_equal(entry["realspace_gsimage"], tm[0][0].image)
    assert entry["ii"].device == tm[0][0].device
    assert entry["psf_ii"].device == tm[0][0].psf.device
    used = []
    kimage_of_obs = nt.kobs._kimage_of_obs

    def recording(image, cen, dim, device):
        used.append(torch.device(device))
        return kimage_of_obs(image, cen, dim, device)

    monkeypatch.setattr(nt.kobs, "_kimage_of_obs", recording)
    np.testing.assert_allclose(entry["ii"].kimage(dim), kobs.kimage, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(entry["psf_ii"].kimage(dim), kobs.psf.kimage, rtol=1e-12,
                               atol=1e-14)
    assert used == [torch.device("cpu")] * 2
    assert entry["ii"].nyquist_scale == np.pi / tm[0][0].jacobian.scale


# ----------------------------------------------------------------------
# the fitters

FITS = {
    "gauss": (dict(), [0.0, 0.0, 0.0, 0.0, 0.6, 90.0]),
    "exp": (dict(model="exp", T=1.2), [0.0, 0.0, 0.0, 0.0, 0.6, 90.0]),
}


def check_fit_against_jax(jf, tf, kw, guess):
    """a JAX k-space fitter and the port's on the k observations, on a
    grid padded twice, of the same stamps (one grid shape for every
    case, so the JAX package's eager operations compile once)"""
    jobs, tobs = _pair(7, **kw)
    jobs, tobs = jn.make_kobs(jobs, pad_factor=2), nt.make_kobs(tobs, pad_factor=2)
    jres = jf.go(jobs, np.array(guess))
    tres = tf.go(tobs, np.array(guess))
    _assert_fit_equal(tres, jres)
    assert tres.npars == len(guess) and tres.fdiff_size == 2 * tres.totpix


@pytest.mark.parametrize("name", sorted(FITS))
def test_kspace_fitter_matches_jax(name):
    """KSpaceFitter of the gaussian profiles (the Spergel and Moffat
    fitters are in tests/test_torch_kspace_profiles.py)"""
    kw, guess = FITS[name]
    check_fit_against_jax(jk.KSpaceFitter(name), tk.KSpaceFitter(name), kw, guess)


def test_kspace_fitter_errors_and_two_bands():
    """the guess checks; a fit of the real-space observation (make_kobs
    inside the fit) equal to the fit of its make_kobs; and a fit over
    two bands of the same k observation: the shape and both fluxes
    those of the one-band fit (the doubled objective has the same
    optimum and the same steps)"""
    _, tobs = _pair(8)
    with pytest.raises(ValueError, match="expected 6"):
        tk.KSpaceFitter("gauss").go(tobs, np.zeros(7))
    with pytest.raises(nt.GMixRangeError):
        tk.KSpaceFitter("gauss").go(tobs, [0.0, 0.0, 0.8, 0.8, 0.6, 90.0])
    with pytest.raises(nt.GMixRangeError):
        tk.KSpaceFitter("gauss").go(tobs, [0.0, 0.0, 0.0, 0.0, 1e-5, 90.0])
    guess = np.array([0.0, 0.0, 0.0, 0.0, 0.6, 90.0])
    direct = tk.KSpaceFitter("gauss").go(tobs, guess)
    via = tk.KSpaceFitter("gauss").go(nt.make_kobs(tobs), guess)
    assert direct["flags"] == via["flags"] == 0 and direct["nfev"] == via["nfev"]
    for k in ("pars", "pars_err", "s2n_r"):
        np.testing.assert_array_equal(np.asarray(direct[k]), np.asarray(via[k]), err_msg=k)
    kobs = nt.make_kobs(tobs, pad_factor=2)
    two = nt.KMultiBandObsList()
    two.append(kobs[0])
    two.append(kobs[0])
    one = tk.KSpaceFitter("gauss").go(kobs, np.array([0.0, 0.0, 0.0, 0.0, 0.6, 90.0]))
    res = tk.KSpaceFitter("gauss").go(two, np.array([0.0, 0.0, 0.0, 0.0, 0.6, 90.0, 90.0]))
    assert res["flags"] == one["flags"] == 0 and res["nfev"] == one["nfev"]
    np.testing.assert_allclose(res["pars"][:5], one["pars"][:5], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res["flux"], [one["flux"]] * 2, rtol=1e-8)
    assert res["flux_cov"].shape == (2, 2)


# ----------------------------------------------------------------------
# the dof of complex residuals

@pytest.mark.parametrize("name", ["linear", "prior_rows"])
def test_run_lm_k_space_matches_jax(name):
    """run_lm with k_space=True: the dof is half the non-prior rows less
    npars"""
    jres, tres, data, guess, lo, hi, kw = PROBLEMS[name]()
    kw.pop("n_eff", None)
    jout = jlm.run_lm_jit(jres, tuple(jnp.asarray(d) for d in data), jnp.asarray(guess),
                          jnp.asarray(lo), jnp.asarray(hi), jlm.LMConf(maxfev=500), k_space=True,
                          **kw)
    tout = tlm.run_lm(tres, tuple(torch.as_tensor(d) for d in data), torch.as_tensor(guess),
                      torch.as_tensor(lo), torch.as_tensor(hi), tlm.LMConf(maxfev=500),
                      k_space=True, **kw)
    assert int(tout["flags"]) == int(jout["flags"]) == 0
    assert abs(int(tout["nfev"]) - int(jout["nfev"])) <= 2
    for k in ("pars", "pars_err", "pars_cov"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_allclose(float(tout["s_sq"]), float(jout["s_sq"]), rtol=1e-8)


def _state(seed, B=3, npars=4):
    """a finished solver state of B lanes"""
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(B, 12, npars))
    return {
        "y": rng.normal(size=(B, npars)) * 0.3,
        "cost": rng.uniform(10, 20, B),
        "cost_pix": rng.uniform(5, 10, B),
        "JtJ": np.einsum("bij,bik->bjk", A, A),
        "nfev": np.array([3, 7, 2], dtype=np.int32),
        "done": np.array([True, True, False]),
        "ier_small_step": np.array([True, False, False]),
        "ier_small_cost": np.array([False, True, False]),
    }


def test_normal_epilogue_k_space_matches_jax():
    """the epilogue's covariance scales by cost_pix / (nres // 2 -
    npars) with k_space; nres 9 makes the halving round down"""
    st = _state(3)
    lo = np.array([-1.0, -np.inf, 0.0, -np.inf])
    hi = np.array([1.0, np.inf, np.inf, np.inf])
    conf = tlm.LMConf(maxfev=7)
    for k_space in (False, True):
        jfn = jax.jit(lambda st, lo, hi, nres, k=k_space: jlm._normal_epilogue(
            st, lo, hi, jlm.LMConf(maxfev=7), nres, k))
        for nres in (np.array([30, 30, 9]), np.array([20, 20, 20])):
            jout = jfn({k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(lo),
                       jnp.asarray(hi), jnp.asarray(nres))
            tout = tlm._normal_epilogue({k: torch.as_tensor(v) for k, v in st.items()},
                                        torch.as_tensor(lo), torch.as_tensor(hi), conf,
                                        torch.as_tensor(nres), k_space)
            for k in ("flags", "nfev", "ier"):
                np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
            for k in ("pars", "pars_err", "pars_cov", "pars_cov0", "s_sq"):
                np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-8,
                                           atol=1e-10, err_msg=k)
    nres = np.array([30, 30, 9])
    half = tlm._normal_epilogue({k: torch.as_tensor(v) for k, v in st.items()},
                                torch.as_tensor(lo), torch.as_tensor(hi), conf,
                                torch.as_tensor(nres), True)
    np.testing.assert_allclose(half["s_sq"].numpy(),
                               st["cost_pix"] / np.maximum(nres // 2 - 4, 1), rtol=1e-15)
    assert int(half["flags"][2]) & nt.flags.ZERO_DOF


def _normal_lin(x, data, xp):
    """the normal equations of the weighted linear residuals (A x - y) w
    of every lane, in either package (xp: jnp or torch)"""
    A, y, w = data
    r = (xp.einsum("bij,bj->bi", A, x) - y) * w
    J = A * w[..., None]
    return (xp.sum(r * r, -1), xp.einsum("bij,bi->bj", J, r), xp.einsum("bij,bik->bjk", J, J))


def test_run_gn_refine_k_space_matches_jax():
    """run_gn_refine_batched with k_space=True against the JAX package's
    (and its dof halved against k_space=False)"""
    rng = np.random.RandomState(12)
    B, n, npars = 3, 20, 3
    A = rng.normal(size=(B, n, npars))
    y = np.einsum("bij,j->bi", A, [0.5, -1.0, 2.0]) + rng.normal(size=(B, n)) * 0.1
    w = np.full((B, n), 10.0)
    guess = np.tile([0.4, -0.9, 1.9], (B, 1))
    lo, hi = np.array([-1.0, -5.0, -np.inf]), np.array([1.0, 5.0, np.inf])
    nres = np.full(B, n)
    jout = jax.jit(lambda *a: jlm.run_gn_refine_batched(
        lambda x, d: _normal_lin(x, d, jnp), a[:3], *a[3:6], jlm.LMConf(), a[6], niter=2,
        k_space=True))(*(jnp.asarray(x) for x in (A, y, w, guess, lo, hi, nres)))
    outs = {}
    for k_space in (False, True):
        outs[k_space] = tlm.run_gn_refine_batched(
            lambda x, d: _normal_lin(x, d, torch),
            tuple(torch.as_tensor(x) for x in (A, y, w)), torch.as_tensor(guess),
            torch.as_tensor(lo), torch.as_tensor(hi), tlm.LMConf(), torch.as_tensor(nres),
            niter=2, k_space=k_space)
    tout = outs[True]
    for k in ("flags", "nfev", "ier"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    for k in ("pars", "pars_err", "pars_cov", "cost", "s_sq"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    assert torch.equal(outs[True]["pars"], outs[False]["pars"])
    np.testing.assert_allclose(outs[True]["s_sq"].numpy(),
                               outs[False]["s_sq"].numpy() * (n - npars) / (n // 2 - npars),
                               rtol=1e-14)
    # the batched LM's epilogue takes k_space the same way
    lm = {k: tlm.run_lm_normal_batched(
        lambda x, d: _normal_lin(x, d, torch), tuple(torch.as_tensor(x) for x in (A, y, w)),
        torch.as_tensor(guess), torch.as_tensor(lo), torch.as_tensor(hi), tlm.LMConf(),
        torch.as_tensor(nres), k_space=k) for k in (False, True)}
    assert torch.equal(lm[True]["pars"], lm[False]["pars"])
    np.testing.assert_allclose(lm[True]["s_sq"].numpy(),
                               lm[False]["s_sq"].numpy() * (n - npars) / (n // 2 - npars),
                               rtol=1e-14)
