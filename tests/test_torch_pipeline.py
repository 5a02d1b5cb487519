"""The gaussmom, admom and exp-LM metacal pipelines of the PyTorch port
against the JAX package, per lane and per type, in float64 at B = 8 on
inputs made once with numpy from a seed.

Tolerance: flags equal (and nfev for exp-LM, numiter and every field
for admom); pars, s2n and
shear_response's R and shear to rtol 1e-8 and atol 1e-10, as
tests/test_batch_pipeline.py holds two implementations of one objective
against each other. The exp-LM reference is the JAX package's K1 route:
the test patches ngmix_tpu.batch._exp_lm_measure, for the duration of
the fixture only, to use_pallas=True with the TPU kernel in interpret
mode (its default computes the same normal equations by AD). The port's sims
are held against bench.py's on the same draws to rtol 1e-12 in float64,
the tolerance tests/test_misc_components.py holds the Pallas mixture
kernel to.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.gmix import core as jcore

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert, sims

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B = 8
DIMS = (49, 49)
PSF_DIMS = (25, 25)
SCALE = 0.263

# bench.py's metacal_gaussmom configuration, and a sheared WCS on the
# fft2 grid (pad 1.3 -> N = 64) with full stamps
CONFS = {
    "bench": dict(jac=(SCALE, 0.0, 0.0, SCALE), fixnoise=True, pad_factor=2,
                  fit_dims=(19, 19)),
    "wcs": dict(jac=(0.26, 0.013, -0.009, 0.27), fixnoise=True,
                pad_factor=1.3, fit_dims=None),
}


def _inputs(seed=17):
    """exp galaxies of varied size, flux and shape convolved with varied
    turb psfs, sheared by (0.02, 0), with noise; all draws from numpy"""
    rng = np.random.RandomState(seed)
    T = rng.uniform(0.3, 1.1, B)
    flux = rng.uniform(60.0, 140.0, B)
    g = rng.uniform(-0.2, 0.2, (B, 2))
    z = np.zeros(B)
    gal, _ = jcore.fill_exp(jnp.asarray(np.stack([z, z, g[:, 0], g[:, 1], T, flux], -1)))
    gal = jcore.gmix_get_sheared(gal, 0.02, 0.0)
    pg = rng.uniform(-0.03, 0.03, (B, 2))
    pT = rng.uniform(0.24, 0.30, B)
    psf, _ = jcore.fill_turb(jnp.asarray(
        np.stack([z, z, pg[:, 0], pg[:, 1], pT, np.ones(B)], -1)
    ))
    conv = jcore.gmix_convolve(gal, psf)

    def grid(dims, cens):
        rr, cc = np.meshgrid(np.arange(dims[0]), np.arange(dims[1]), indexing="ij")
        return (
            (rr.reshape(-1)[None] - cens[:, :1]) * SCALE,
            (cc.reshape(-1)[None] - cens[:, 1:]) * SCALE,
        )

    cens = np.array([(DIMS[0] - 1) / 2, (DIMS[1] - 1) / 2]) + rng.uniform(-0.5, 0.5, (B, 2))
    v, u = grid(DIMS, cens)
    imgs = np.array(jcore.eval_gmix(conv, v, u, SCALE**2, fast=False)).reshape(B, *DIMS)
    imgs = imgs + rng.normal(0, 1e-4, imgs.shape)
    pcens = np.tile([(PSF_DIMS[0] - 1) / 2, (PSF_DIMS[1] - 1) / 2], (B, 1)).astype(float)
    pv, pu = grid(PSF_DIMS, pcens)
    pimgs = np.array(jcore.eval_gmix(psf, pv, pu, SCALE**2, fast=False)).reshape(B, *PSF_DIMS)
    weights = np.full((B,) + DIMS, 1e8)
    noise = rng.normal(0, 1e-4, (B,) + DIMS)
    return imgs, weights, cens, pimgs, pcens, noise


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=sorted(CONFS))
def runs(request, inputs):
    """(JAX config, JAX results, port results) for one configuration,
    computed once per module"""
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS[request.param])
    jres = jbatch.make_metacal_pipeline_fn(jconf, measure="gaussmom")(
        *map(jnp.asarray, inputs)
    )
    conf = convert.config_from_fields(jconf)
    tres = nt.make_metacal_pipeline_fn(conf, measure="gaussmom", device="cpu")(*inputs)
    return jconf, jax.tree.map(np.asarray, jres), convert.to_numpy(tres)


EXP_LM_CONF = dict(jac=(SCALE, 0.0, 0.0, SCALE), fixnoise=True, pad_factor=1.3,
                   fit_dims=(19, 19))


@pytest.fixture(scope="module")
def exp_lm_runs(inputs):
    """(JAX results through its K1 route, port results) of bench.py's
    headline exp-LM configuration, computed once per module"""
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **EXP_LM_CONF)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatch, "_exp_lm_measure", functools.partial(
            jbatch._exp_lm_measure, use_pallas=True, interpret=True))
        jres = jbatch.make_metacal_pipeline_fn(jconf, measure="exp-lm")(
            *map(jnp.asarray, inputs)
        )
    conf = convert.config_from_fields(jconf)
    tres = nt.make_metacal_pipeline_fn(conf, measure="exp-lm", device="cpu")(*inputs)
    return jax.tree.map(np.asarray, jres), convert.to_numpy(tres)


def test_exp_lm_pipeline_matches_jax_per_lane(exp_lm_runs):
    jres, tres = exp_lm_runs
    assert set(tres) == set(jres)
    for t in jbatch.GALSHEAR_TYPES:
        assert set(tres[t]) == set(jres[t])
        for k in ("flags", "nfev"):
            np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
        for k in ("pars", "s2n"):
            np.testing.assert_allclose(
                tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10, err_msg=(t, k)
            )
        np.testing.assert_array_equal(tres[t]["e1"], tres[t]["pars"][:, 2])
        assert np.all(tres[t]["flags"] == 0)
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}
    ))
    for k in ("R", "shear"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)


# the pre-psf measures (FWHM 2.0) under each psf mode, with and without
# the fit window, which they ignore: they measure the full stamps
PREPSF_CASES = {
    "pgauss-gauss-fit": ("pgauss", dict(CONFS["bench"])),
    "ksigma-gauss": ("ksigma", dict(CONFS["bench"], fit_dims=None)),
    "pgauss-dilate": ("pgauss", dict(CONFS["bench"], fit_dims=None, psf_mode="dilate")),
    "ksigma-dilate-fit": ("ksigma", dict(CONFS["bench"], psf_mode="dilate")),
    "ksigma-azgauss-fit": ("ksigma", dict(CONFS["bench"], psf_mode="azgauss")),
    "pgauss-fitgauss": ("pgauss", dict(CONFS["bench"], fit_dims=None, psf_mode="fitgauss")),
}


@pytest.mark.parametrize("case", sorted(PREPSF_CASES))
def test_prepsf_pipeline_matches_jax_per_lane(inputs, case):
    """every result field of every type (kernel_nrm and the flags
    included), psf_sigma and shear_response, against the JAX pipeline
    at rtol 1e-8 and atol 1e-10"""
    measure, fields = PREPSF_CASES[case]
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **fields)
    jres = jax.tree.map(np.asarray, jbatch.make_metacal_pipeline_fn(
        jconf, measure=measure, measure_fwhm=2.0)(*map(jnp.asarray, inputs)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_fn(
        convert.config_from_fields(jconf), measure=measure, measure_fwhm=2.0,
        device="cpu")(*inputs))
    assert set(tres) == set(jres)
    for t in jconf.types:
        assert set(tres[t]) == set(jres[t])
        for k, ref in jres[t].items():
            assert tres[t][k].shape == ref.shape, (t, k)
            if ref.dtype.kind in "iub":
                np.testing.assert_array_equal(tres[t][k], ref, err_msg=(t, k))
            else:
                np.testing.assert_allclose(tres[t][k], ref, rtol=1e-8, atol=1e-10,
                                           equal_nan=True, err_msg=(t, k))
        assert np.all(tres[t]["flags"] == 0)
    np.testing.assert_allclose(tres["psf_sigma"], jres["psf_sigma"], rtol=1e-8, atol=1e-10)
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}
    ))
    for k in ("R", "shear", "e_mean"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)


def test_prepsf_measures_take_the_full_stamps(inputs):
    """with a fit window the pre-psf measures still measure the full
    stamps: no crop in the k engine, and bitwise the results of the
    configuration without the window"""
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    assert tbatch._fit_crop(conf) == (15, 15, 19, 19)
    for measure in ("pgauss", "ksigma"):
        assert tbatch._fit_crop(conf, measure) is None
        win = nt.metacal_pipeline(*inputs, conf, measure=measure, device="cpu")
        full = nt.metacal_pipeline(*inputs, conf._replace(fit_dims=None), measure=measure,
                                   device="cpu")
        for t in conf.types:
            for k, x in full[t].items():
                torch.testing.assert_close(win[t][k], x, rtol=0, atol=0, equal_nan=True)


def test_prepsf_round_target_stamps_are_normalized():
    """the round target psf stamps (K2's plain version here) hold unit
    flux and are centred on the stamp"""
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    sigma = torch.tensor([0.3, 0.4, 0.5], dtype=torch.float64)
    st = tbatch.round_target_psf_stamps(sigma, conf).numpy()
    assert st.shape == (3,) + PSF_DIMS
    np.testing.assert_allclose(st.sum((-2, -1)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(st, st[:, ::-1, ::-1], rtol=1e-12)


@pytest.fixture(scope="module")
def admom_runs(inputs):
    """(JAX results, port results) of bench.py's metacal_admom
    configuration on the inputs with stamp 0 fully masked and every
    other column of stamp 1 masked, computed once per module"""
    args = list(inputs)
    w = args[1].copy()
    w[0] = 0.0
    w[1, :, ::2] = 0.0
    args[1] = w
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    jres = jbatch.make_metacal_pipeline_fn(jconf, measure="admom")(*map(jnp.asarray, args))
    tres = nt.make_metacal_pipeline_fn(convert.config_from_fields(jconf), measure="admom",
                                       device="cpu")(*args)
    return jax.tree.map(np.asarray, jres), convert.to_numpy(tres)


def test_admom_pipeline_matches_jax_per_lane(admom_runs):
    jres, tres = admom_runs
    assert set(tres) == set(jres)
    for t in jbatch.GALSHEAR_TYPES:
        assert set(tres[t]) == set(jres[t])
        for k, ref in jres[t].items():
            if k in ("flags", "numiter", "T_flags", "flux_flags", "rho4_flags"):
                np.testing.assert_array_equal(tres[t][k], ref, err_msg=(t, k))
            else:
                np.testing.assert_allclose(tres[t][k], ref, rtol=1e-8, atol=1e-10,
                                           equal_nan=True, err_msg=(t, k))
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}
    ))
    for k in ("R", "shear", "e_mean"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)


def test_admom_fully_masked_lane_is_flagged(admom_runs):
    """the stamp with zero weight everywhere comes out flagged and out
    of the calibration, which stays finite; the partly masked stamp
    measures"""
    _, tres = admom_runs
    flags = tres["noshear"]["flags"]
    assert flags[0] != 0 and np.all(flags[1:] == 0)
    calib = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}
    ))
    assert int(calib["n_used"]) == B - 1
    assert np.all(np.isfinite(calib["shear"])) and np.all(np.isfinite(calib["R"]))


def test_admom_config_is_the_main_path_config():
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    assert sims.METACAL_ADMOM_CONFIG == conf


def test_exp_lm_config_is_the_main_path_config():
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **EXP_LM_CONF)
    assert sims.METACAL_EXP_LM_CONFIG == conf


def test_lm_conf_from_jax_fields():
    from ngmix_tpu.fitting.lm import LMConf as JLMConf

    jconf = JLMConf(maxfev=77, ftol=1e-6)
    conf = convert.lm_conf_from_fields(jconf)
    assert tuple(conf) == tuple(jconf) and conf._fields == jconf._fields
    assert convert.lm_conf_from_fields(jconf._asdict()) == conf
    with pytest.raises(ValueError):
        convert.lm_conf_from_fields({**jconf._asdict(), "bogus": 1})


def test_config_from_jax_fields():
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    conf = convert.config_from_fields(jconf._asdict())
    assert tuple(conf) == tuple(jconf)
    assert conf._fields == jconf._fields
    assert convert.config_from_fields(jconf) == conf
    with pytest.raises(ValueError):
        convert.config_from_fields({**jconf._asdict(), "bogus": 1})


def test_pipeline_matches_jax_per_lane(runs):
    _, jres, tres = runs
    for t in jbatch.GALSHEAR_TYPES:
        np.testing.assert_array_equal(tres[t]["flags"], jres[t]["flags"], t)
        for k in ("pars", "s2n"):
            np.testing.assert_allclose(
                tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10, err_msg=(t, k)
            )
    np.testing.assert_allclose(
        tres["psf_sigma"], jres["psf_sigma"], rtol=1e-8, atol=1e-10
    )


def test_pipeline_result_keys_match_jax(runs):
    _, jres, tres = runs
    assert set(tres) == set(jres)
    for t in jbatch.GALSHEAR_TYPES:
        assert set(tres[t]) == set(jres[t])
        for k, ref in jres[t].items():
            assert tres[t][k].shape == ref.shape, (t, k)


def test_shear_response_matches_jax(runs):
    _, jres, tres = runs
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}
    ))
    for k in ("R", "shear", "e_mean"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)
    assert int(tsr["n_used"]) == int(jsr["n_used"]) == B


def test_chunked_matches_single_batch(inputs):
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    one = nt.make_metacal_pipeline_fn(conf, device="cpu", max_chunk=None)(*inputs)
    chunked = nt.make_metacal_pipeline_fn(conf, device="cpu", max_chunk=3)(*inputs)
    for t in tbatch.GALSHEAR_TYPES:
        for k in ("pars", "flags", "s2n"):
            np.testing.assert_allclose(
                chunked[t][k].numpy(), one[t][k].numpy(), rtol=1e-12, atol=1e-15
            )


def _prior_of(measure, nband):
    """a joint prior of the measure's model built for nband flux slots"""
    from ngmix_tpu_torch import joint_prior, priors

    F = priors.FlatPrior(0, 1e9)
    parts = dict(cen_prior=priors.CenPrior(0, 0, 1, 1), g_prior=priors.GPriorBA(0.3),
                 T_prior=priors.FlatPrior(0, 10), F_prior=F if nband == 1 else [F] * nband)
    if measure == "bdf-lm":
        return joint_prior.PriorBDFSep(fracdev_prior=priors.FlatPrior(0, 1), **parts)
    if measure == "bd-lm":
        return joint_prior.PriorBDSep(logTratio_prior=priors.FlatPrior(-1, 1),
                                      fracdev_prior=priors.FlatPrior(0, 1), **parts)
    return joint_prior.PriorSimpleSep(**parts)


def test_unported_options_raise(inputs):
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    for measure, npars in (("exp-lm", 6), ("gauss-lm", 6), ("dev-lm", 6), ("bdf-lm", 7),
                           ("bd-lm", 8)):
        # lm_prior is ported: a non-prior raises TypeError naming the
        # ported priors, a prior of two flux slots ValueError
        with pytest.raises(TypeError, match="PriorBDFSep.*PriorSimpleSep"):
            nt.make_metacal_pipeline_fn(conf, measure=measure, device="cpu",
                                        lm_prior=object(),
                                        lm_bounds=([0] * npars, [1] * npars))
        with pytest.raises(ValueError, match="parameter slots"):
            nt.make_metacal_pipeline_fn(conf, measure=measure, device="cpu",
                                        lm_prior=_prior_of(measure, 2),
                                        lm_bounds=([0] * npars, [1] * npars))
        # the LM options (item 10) are ported: varpro raises the
        # reference's ValueErrors for a prior and for a bounded flux
        for kw in (dict(lm_conf=nt.LMConf(varpro=True)), dict(lm_conf=nt.LMConf(flux_col=True)),
                   dict(lm_conf=nt.LMConf(flux_col=True), lm_prior=_prior_of(measure, 1))):
            nt.make_metacal_pipeline_fn(conf._replace(sheared_refine=2), measure=measure,
                                        device="cpu", **kw)
        for kw in (dict(lm_prior=_prior_of(measure, 1)),
                   dict(lm_bounds=([0] * npars, [1] * npars))):
            with pytest.raises(ValueError, match="varpro"):
                nt.make_metacal_pipeline_fn(conf, measure=measure, device="cpu",
                                            lm_conf=nt.LMConf(varpro=True), **kw)
    # the k-space residuals (item 13b-2): the refiner's epilogue halves
    # the dof, nres // 2 - npars, and changes nothing else
    A = torch.linspace(-1.0, 1.0, 40, dtype=torch.float64).reshape(1, 20, 2)
    y = A[..., 0] * 0.5 - A[..., 1] + 0.01 * torch.cos(torch.arange(20.0, dtype=torch.float64))

    def normal_fn(x, d):
        r = torch.einsum("bij,bj->bi", d[0], x) - d[1]
        return (torch.sum(r * r, -1), torch.einsum("bij,bi->bj", d[0], r),
                torch.einsum("bij,bik->bjk", d[0], d[0]))

    inf = torch.full((2,), torch.inf, dtype=torch.float64)
    out = {k: nt.fitting.lm.run_gn_refine_batched(
        normal_fn, (A, y), torch.zeros((1, 2), dtype=torch.float64), -inf, inf, nt.LMConf(),
        torch.tensor([20]), niter=2, k_space=k) for k in (False, True)}
    assert torch.equal(out[True]["pars"], out[False]["pars"])
    assert int(out[True]["flags"][0]) == int(out[False]["flags"][0]) == 0
    np.testing.assert_allclose(float(out[True]["s_sq"][0]),
                               float(out[False]["s_sq"][0]) * 18 / 8, rtol=1e-14)
    # as in the JAX package, the psf-sheared types need psf_mode='dilate'
    with pytest.raises(ValueError, match="psf_mode='dilate'"):
        nt.metacal_pipeline(*inputs, conf._replace(types=("noshear", "1p_psf")),
                            device="cpu")
    with pytest.raises(ValueError):
        nt.metacal_pipeline(*inputs, conf, measure="bogus", device="cpu")


def test_no_device_without_card_raises(monkeypatch, inputs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.make_metacal_pipeline_fn(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.metacal_pipeline(*inputs, conf)
    for maker in (nt.make_sim_batch, nt.make_sim_batch_hetero):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            maker(torch.Generator().manual_seed(1), 4)


@pytest.mark.parametrize("maker", [sims.make_sim_batch, sims.make_sim_batch_hetero])
def test_sims_generator_must_live_on_the_device(maker):
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="generator lives on cpu"):
        maker(gen, 4, device="meta")


def test_bench_config_is_the_main_path_config():
    bench_conf = nt.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **CONFS["bench"])
    assert sims.METACAL_GAUSSMOM_CONFIG == bench_conf


@pytest.mark.parametrize("maker", [sims.make_sim_batch, sims.make_sim_batch_hetero])
def test_sims_shapes_and_flux(maker):
    gen = torch.Generator().manual_seed(5)
    imgs, weights, cens, pimgs, pcens, noise = maker(gen, 6, torch.float64,
                                                     device="cpu")
    assert imgs.shape == weights.shape == noise.shape == (6,) + DIMS
    assert pimgs.shape == (6,) + PSF_DIMS and cens.shape == pcens.shape == (6, 2)
    assert all(torch.isfinite(x).all() for x in (imgs, pimgs, noise))
    # unit-flux psf stamps; galaxy flux within the drawn range (the
    # stamps hold all but the far wings of the profile)
    np.testing.assert_allclose(pimgs.sum((-2, -1)).numpy(), 1.0, rtol=1e-3)
    flux = imgs.sum((-2, -1)).numpy()
    assert np.all((flux > 55.0) & (flux < 141.0))
    assert np.all(np.abs(cens.numpy() - 24.0) <= 0.5)


def test_hetero_sims_pair_and_need_even_batch():
    gen = torch.Generator().manual_seed(6)
    imgs, _, _, pimgs, _, _ = sims.make_sim_batch_hetero(gen, 4, torch.float64,
                                                         device="cpu")
    torch.testing.assert_close(pimgs[:2], pimgs[2:])
    with pytest.raises(ValueError):
        sims.make_sim_batch_hetero(gen, 5, device="cpu")


def _load_bench():
    path = Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("_bench_for_torch_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["make_sim_batch", "make_sim_batch_hetero"])
def test_sims_match_bench_on_the_same_draws(monkeypatch, name):
    """the port's sims against bench.py's, every random draw fed from
    one numpy stream on each side in the same order, so a wrong centre,
    area, pixel grid, mixture or noise layout shows"""
    bench = _load_bench()
    Bs = 6

    def draws(seed=23):
        rng = np.random.RandomState(seed)
        uniform = lambda shape, lo, hi: rng.uniform(lo, hi, shape)  # noqa: E731
        normal = lambda shape: rng.normal(0.0, 1.0, shape)  # noqa: E731
        return uniform, normal

    ju, jn = draws()
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape, dtype, minval=0.0, maxval=1.0:
            jnp.asarray(ju(shape, minval, maxval), dtype),
    )
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype: jnp.asarray(jn(shape), dtype),
    )
    ref = getattr(bench, name)(jax.random.PRNGKey(0), Bs, jnp.float64)

    tu, tn = draws()
    monkeypatch.setattr(
        sims, "_uniform",
        lambda gen, shape, dtype, lo, hi: torch.as_tensor(tu(shape, lo, hi), dtype=dtype),
    )
    monkeypatch.setattr(
        sims, "_normal",
        lambda gen, shape, dtype: torch.as_tensor(tn(tuple(shape)), dtype=dtype),
    )
    out = getattr(sims, name)(torch.Generator(), Bs, torch.float64, device="cpu")

    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
