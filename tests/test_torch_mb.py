"""The multi-band, multi-epoch metacal pipeline of the PyTorch port
(metacal_pipeline_mb, make_metacal_pipeline_mb_fn) against the JAX
package's on the same numpy inputs, in float64 at B = 8 objects of E = 3
epochs from independent draws (as tests/test_batch_pipeline.py:61-86
stacks them) and bench.py's mb configuration (pad 2, the 19x19 window).

Tolerance: flags equal, nfev within 2, pars and s2n to rtol 1e-8 and
atol 1e-10: the reference's tolerance between its "fused" and "epoch"
objectives (tests/test_batch_pipeline.py:818-829), both of which the
port is held to. At E = 1 and one band the port's mb pipeline gives the
bits of its flat exp-LM pipeline (the analog of :108-142); over
duplicated epochs gaussmom and admom equal the flat port's to atol
1e-13 (:145-170). A zero-weight pad epoch changes an object's result by
no more than rtol 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert

from test_torch_pipeline import DIMS, PSF_DIMS, SCALE, _inputs, _prior_of

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

E, NBAND = 3, 2
BAND = np.array([0, 0, 1], np.int32)
BAND_BE = np.array([[0, 0, 1], [1, 0, 1]] * 4, np.int32)
JCONF = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, jac=(SCALE, 0.0, 0.0, SCALE),
                             fixnoise=True, pad_factor=2, fit_dims=(19, 19))
CONF = convert.config_from_fields(JCONF)


@pytest.fixture(scope="module")
def mb_inputs():
    """[B, E, ...] arrays: epoch e of every object from its own draw"""
    eps = [_inputs(seed) for seed in (17, 18, 19)]
    return tuple(np.stack([ep[i] for ep in eps], axis=1) for i in range(6))


def _jax_mb(args, band, nband, conf=JCONF, **kw):
    out = jax.jit(lambda *a: jbatch.metacal_pipeline_mb(*a, jnp.asarray(band), nband, conf,
                                                        **kw))(*map(jnp.asarray, args))
    return jax.tree.map(np.asarray, out)


def _port_mb(args, band, nband, conf=CONF, **kw):
    return convert.to_numpy(nt.metacal_pipeline_mb(*args, band, nband, conf, device="cpu",
                                                   **kw))


def _assert_lm_match(tres, jres, types=jbatch.GALSHEAR_TYPES):
    for t in types:
        assert set(tres[t]) == set(jres[t]), set(tres[t]) ^ set(jres[t])
        np.testing.assert_array_equal(tres[t]["flags"], jres[t]["flags"], err_msg=t)
        assert np.all(np.abs(tres[t]["nfev"].astype(int) - jres[t]["nfev"]) <= 2), t
        for k in ("pars", "s2n", "s2n_flux", "flux"):
            np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                       err_msg=(t, k))
        np.testing.assert_array_equal(tres[t]["e1"], tres[t]["pars"][:, 2])
        assert np.all(tres[t]["flags"] == 0)
    np.testing.assert_allclose(tres["psf_sigma"], jres["psf_sigma"], rtol=1e-12)


@pytest.fixture(scope="module")
def port_runs(mb_inputs):
    return {name: _port_mb(mb_inputs, band, NBAND)
            for name, band in (("shared", BAND), ("per-object", BAND_BE))}


@pytest.mark.parametrize("objective", ["fused", "epoch"])
@pytest.mark.parametrize("band_map", ["shared", "per-object"])
def test_exp_lm_mb_matches_jax(mb_inputs, port_runs, band_map, objective):
    band = BAND if band_map == "shared" else BAND_BE
    jres = _jax_mb(mb_inputs, band, NBAND, objective=objective)
    tres = port_runs[band_map]
    _assert_lm_match(tres, jres)
    assert tres["noshear"]["flux"].shape == (8, NBAND)
    assert tres["psf_sigma"].shape == (8, E)


def test_every_objective_is_the_same_solve(mb_inputs, port_runs):
    for objective in ("auto", "epoch-be", "epoch-t"):
        out = _port_mb(mb_inputs, BAND, NBAND, objective=objective)
        for k in ("pars", "flags", "nfev", "s2n"):
            np.testing.assert_array_equal(out["1p"][k], port_runs["shared"]["1p"][k])


@pytest.mark.parametrize("psf_mode", ["azgauss", "fitgauss", "dilate"])
def test_psf_modes_mb_match_jax(mb_inputs, psf_mode):
    jconf = JCONF._replace(psf_mode=psf_mode)
    jres = _jax_mb(mb_inputs, BAND_BE, NBAND, conf=jconf, objective="epoch")
    tres = _port_mb(mb_inputs, BAND_BE, NBAND, conf=convert.config_from_fields(jconf))
    _assert_lm_match(tres, jres)


@pytest.mark.parametrize("psf_mode", ["gauss", "dilate"])
def test_one_epoch_one_band_is_the_flat_pipeline_bitwise(mb_inputs, psf_mode):
    """the mb pipeline at E = 1 and one band gives the flat exp-LM
    pipeline's bits; the two bad-point conventions could differ only
    where the starting point is bad, which no lane's is"""
    conf = CONF._replace(psf_mode=psf_mode)
    flat_args = [a[:, 0] for a in mb_inputs]
    flat = nt.metacal_pipeline(*flat_args, conf, measure="exp-lm", device="cpu")
    start = nt.metacal_pipeline(*flat_args, conf, measure="exp-lm", device="cpu",
                                lm_conf=nt.LMConf(maxfev=1))
    mb = nt.metacal_pipeline_mb(*[a[:, :1] for a in mb_inputs], np.zeros(1, np.int32), 1,
                                conf, device="cpu")
    for t in conf.types:
        assert bool((start[t]["cost"] < 1e29).all()), t
        assert set(mb[t]) == set(flat[t])
        for k in flat[t]:
            torch.testing.assert_close(mb[t][k], flat[t][k], rtol=0, atol=0, msg=(t, k))
    torch.testing.assert_close(mb["psf_sigma"][:, 0], flat["psf_sigma"], rtol=0, atol=0)


@pytest.mark.parametrize("measure", ["gaussmom", "admom"])
def test_moments_pool_duplicated_epochs(mb_inputs, measure):
    """two copies of one epoch pool to the flat measurement; the port
    also matches JAX's mb pipeline on independent epochs"""
    flat_args = [a[:, 0] for a in mb_inputs]
    flat = nt.metacal_pipeline(*flat_args, CONF, measure=measure, device="cpu")
    dup = nt.metacal_pipeline_mb(*[np.stack([a, a], axis=1) for a in flat_args],
                                 np.zeros(2, np.int32), 1, CONF, measure=measure, device="cpu")
    for k in ("e1", "e2", "T"):
        np.testing.assert_allclose(dup["noshear"][k].numpy(), flat["noshear"][k].numpy(),
                                   rtol=0, atol=1e-13, err_msg=k)
    assert np.all(dup["noshear"]["flags"].numpy() == 0)

    jres = _jax_mb(mb_inputs, np.zeros(E, np.int32), 1, measure=measure)
    tres = _port_mb(mb_inputs, np.zeros(E, np.int32), 1, measure=measure)
    int_keys = {"flags", "numiter", "T_flags", "flux_flags"}
    for t in jbatch.GALSHEAR_TYPES:
        assert set(tres[t]) == set(jres[t])
        for k in tres[t]:
            if k in int_keys:
                np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
            else:
                np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                           err_msg=(t, k))


def test_pad_epoch_changes_nothing(mb_inputs):
    """an epoch with zero weight (a copied valid psf stamp) gives the
    object the result it has without that epoch"""
    args = [a.copy() for a in mb_inputs]
    args[1][:, 1] = 0.0
    padded = _port_mb(args, BAND, NBAND)
    dropped = _port_mb([a[:, [0, 2]] for a in mb_inputs], BAND[[0, 2]], NBAND)
    for t in jbatch.GALSHEAR_TYPES:
        np.testing.assert_array_equal(padded[t]["flags"], dropped[t]["flags"])
        np.testing.assert_array_equal(padded[t]["nfev"], dropped[t]["nfev"])
        for k in ("pars", "pars_err", "s2n", "s2n_flux"):
            np.testing.assert_allclose(padded[t][k], dropped[t][k], rtol=1e-8, err_msg=(t, k))


def test_chunked_matches_one_shot(mb_inputs, port_runs):
    fn = nt.make_metacal_pipeline_mb_fn(CONF, BAND_BE, NBAND, max_chunk=3, device="cpu")
    out = convert.to_numpy(fn(*mb_inputs))
    ref = port_runs["per-object"]
    for t in jbatch.GALSHEAR_TYPES:
        for k in ("pars", "flags", "nfev", "s2n", "flux"):
            np.testing.assert_array_equal(out[t][k], ref[t][k], err_msg=(t, k))
    np.testing.assert_array_equal(out["psf_sigma"], ref["psf_sigma"])


def test_inconsistent_measures_raise(mb_inputs):
    args = [a[:4, :1] for a in mb_inputs]
    one = np.zeros(1, np.int32)
    for measure in ("pgauss", "ksigma"):
        with pytest.raises(ValueError, match="per-epoch psf"):
            nt.metacal_pipeline_mb(*args, one, 1, CONF, measure=measure, device="cpu")
    for measure in ("admom", "gaussmom"):
        with pytest.raises(ValueError, match="ONE band"):
            nt.metacal_pipeline_mb(*args, one, 2, CONF, measure=measure, device="cpu")
    with pytest.raises(ValueError, match="bad measure"):
        nt.metacal_pipeline_mb(*args, one, 1, CONF, measure="bogus", device="cpu")
    with pytest.raises(ValueError, match="objective"):
        nt.make_metacal_pipeline_mb_fn(CONF, one, 1, objective="folded", device="cpu")


def test_unported_options_raise_mb():
    one = np.zeros(1, np.int32)
    for measure in ("gauss-lm", "dev-lm", "bdf-lm", "bd-lm"):
        # lm_prior is ported: a non-prior raises TypeError naming the
        # ported priors, a prior of two flux slots ValueError at nband 1
        with pytest.raises(TypeError, match="PriorBDFSep.*PriorSimpleSep"):
            nt.make_metacal_pipeline_mb_fn(CONF, one, 1, measure=measure, device="cpu",
                                           lm_prior=object())
        with pytest.raises(ValueError, match="parameter slots"):
            nt.make_metacal_pipeline_mb_fn(CONF, one, 1, measure=measure, device="cpu",
                                           lm_prior=_prior_of(measure, 2))
        # the LM options are accepted and change nothing in the mb fit,
        # as in the reference: varpro's guards do not apply
        nt.make_metacal_pipeline_mb_fn(CONF, one, 1, measure=measure, device="cpu",
                                       lm_conf=nt.LMConf(flux_col=True, varpro=True),
                                       lm_prior=_prior_of(measure, 1))
    for kw in (dict(lm_prior=object()), dict(lm_prior=object(), lm_bounds=([0] * 7, [1] * 7))):
        with pytest.raises(TypeError, match="PriorBDFSep.*PriorSimpleSep"):
            nt.make_metacal_pipeline_mb_fn(CONF, one, 2, device="cpu", **kw)
    # a prior of one flux slot at nband 2
    with pytest.raises(ValueError, match="parameter slots"):
        nt.make_metacal_pipeline_mb_fn(CONF, one, 2, device="cpu",
                                       lm_prior=_prior_of("exp-lm", 1))
    for kw in (dict(lm_conf=nt.LMConf(varpro=True), lm_bounds=([0] * 7, [1] * 7)),
               dict(lm_conf=nt.LMConf(flux_col=True))):
        nt.make_metacal_pipeline_mb_fn(CONF, one, 2, device="cpu", **kw)
    nt.make_metacal_pipeline_mb_fn(CONF._replace(sheared_refine=2), one, 1, device="cpu")


def test_lm_options_change_nothing_mb(mb_inputs, port_runs):
    """conf.sheared_refine, LMConf.flux_col and LMConf.varpro in the mb
    pipeline: the reference's mb path reads none of them, so its result is
    its result without them (held against the port's in
    test_exp_lm_mb_matches_jax), and the port's is its own without them,
    bit for bit"""
    out = _port_mb(mb_inputs, BAND, NBAND, conf=CONF._replace(sheared_refine=3),
                   lm_conf=nt.LMConf(flux_col=True, varpro=True))
    ref = port_runs["shared"]
    for t in jbatch.GALSHEAR_TYPES:
        assert set(out[t]) == set(ref[t])
        for k, v in ref[t].items():
            np.testing.assert_array_equal(out[t][k], v, err_msg=(t, k))


def test_mb_sims_tile_the_flat_sims():
    gen = torch.Generator().manual_seed(3)
    mb = nt.make_sim_batch_mb(gen, 4, torch.float64, device="cpu")
    flat = nt.make_sim_batch(torch.Generator().manual_seed(3), 4, torch.float64, device="cpu")
    assert len(nt.sims.MB_BAND) == 3 and nt.sims.MB_NBAND == 2
    for m, f in zip(mb, flat):
        assert m.shape == (4, 3) + f.shape[1:] and m.is_contiguous()
        for e in range(3):
            torch.testing.assert_close(m[:, e], f, rtol=0, atol=0)
    conf = nt.sims.METACAL_MB_CONFIG
    assert (conf.pad_factor, conf.fit_dims, conf.fixnoise) == (2, (19, 19), True)
