"""The gauss and dev LM models, lm_bounds and caller guesses of the
PyTorch port, its exp-LM past 1536 pixels a lane, and its two
selection estimators, against the JAX package on the same numpy inputs
in float64.

Tolerances:
- the pipelines (gauss-lm, dev-lm, exp-lm inside the reference's bounds
  box, the mb pipeline with gauss-lm and dev-lm, exp-lm on full 49x49
  stamps) and _exp_lm_measure with caller guesses: flags and nfev
  equal, pars, e1, e2, T, flux and s2n to rtol 1e-8 and atol 1e-10, as
  tests/test_batch_pipeline.py:822-828 holds two implementations of one
  objective. The flat references are the JAX package's K1 route
  (use_pallas=True, the TPU kernel in interpret mode), as in
  tests/test_torch_pipeline.py; its mb pipeline has no K1 route and
  runs its "epoch" objective (AD);
- the closed-form chain for gauss and dev against torch.func.jacfwd of
  the reparametrization: rtol 1e-12 with an atol of 1e-12 times the
  lane's largest |entry| (the criterion of tests/test_torch_lm_solve.py);
- the selection estimators: rtol 1e-10, every output.

The CUDA kernels run only on the card (chip_smoke.py, phase 21); here
the wrappers' dispatch to each model's kernel is checked on a mocked
card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.fitting import lm as jlm

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert, sims
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.ops import lm_solve

from test_torch_lm_solve import _chain_inputs, _fake_cuda, _mock_card, _small_args
from test_torch_mb import JCONF as MB_JCONF, _assert_lm_match
from test_torch_mb_solve import _small_mb
from test_torch_normal_eqs import _pixel_batch
from test_torch_pipeline import DIMS, EXP_LM_CONF, PSF_DIMS, _inputs

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

KEYS = ("pars", "e1", "e2", "T", "flux", "s2n")
# the reference's bounds box (tests/test_batch_pipeline.py:394-395)
BOX = ([-1.0, -1.0, -0.99, -0.99, 0.01, 1e-4], [1.0, 1.0, 0.99, 0.99, 10.0, 1e9])
PDEF = -9.999e9


def _k1_route(mp):
    """the JAX package's exp-LM measure through its K1 route"""
    mp.setattr(jbatch, "_exp_lm_measure", functools.partial(
        jbatch._exp_lm_measure, use_pallas=True, interpret=True))


def _assert_match(tres, jres, types=jbatch.GALSHEAR_TYPES):
    assert set(tres) == set(jres)
    for t in types:
        assert set(tres[t]) == set(jres[t]), set(tres[t]) ^ set(jres[t])
        for k in ("flags", "nfev"):
            np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
        for k in KEYS:
            np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                       err_msg=(t, k))
        np.testing.assert_array_equal(tres[t]["e1"], tres[t]["pars"][:, 2])
        assert np.all(tres[t]["flags"] == 0)


def _responses_match(tres, jres):
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(
        {t: {k: torch.as_tensor(v) for k, v in r.items()}
         for t, r in tres.items() if isinstance(r, dict)}))
    for k in ("R", "shear", "e_mean"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


FLAT_CASES = {
    "gauss-lm": ("gauss-lm", None),
    "dev-lm": ("dev-lm", None),
    "exp-lm-bounds": ("exp-lm", BOX),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_pipeline_matches_jax(inputs, case):
    measure, bounds = FLAT_CASES[case]
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS, **EXP_LM_CONF)
    jb = None if bounds is None else tuple(jnp.asarray(x) for x in bounds)
    with pytest.MonkeyPatch.context() as mp:
        _k1_route(mp)
        jres = jax.tree.map(np.asarray, jbatch.make_metacal_pipeline_fn(
            jconf, measure=measure, lm_bounds=jb)(*map(jnp.asarray, inputs)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_fn(
        convert.config_from_fields(jconf), measure=measure, lm_bounds=bounds,
        device="cpu")(*inputs))
    _assert_match(tres, jres)
    _responses_match(tres, jres)
    if bounds is not None:
        pars = tres["noshear"]["pars"]
        assert np.all((pars > np.asarray(bounds[0])) & (pars < np.asarray(bounds[1])))


def test_exp_lm_past_shared_memory_matches_jax():
    """exp-LM on full 49x49 stamps (P = 2401, more than K3 copies into
    shared memory) computes, and gives the reference's values: noshear
    flags [0, 0], g1 = 1.9989e-2 and 2.0031e-2"""
    args = [a.numpy() for a in sims.make_sim_batch(torch.Generator().manual_seed(1), 2,
                                                  torch.float64, "cpu")]
    conf = sims.METACAL_EXP_LM_CONFIG._replace(fit_dims=None)
    assert conf.dims[0] * conf.dims[1] > lm_solve.MAX_P
    jconf = jbatch.MetacalConfig(**conf._asdict())
    with pytest.MonkeyPatch.context() as mp:
        _k1_route(mp)
        jres = jax.tree.map(np.asarray, jbatch.metacal_pipeline(
            *map(jnp.asarray, args), jconf, measure="exp-lm"))
    tres = convert.to_numpy(nt.metacal_pipeline(*args, conf, measure="exp-lm",
                                                device="cpu"))
    _assert_match(tres, jres)
    np.testing.assert_array_equal(tres["noshear"]["flags"], [0, 0])
    np.testing.assert_allclose(tres["noshear"]["e1"], [1.9989e-2, 2.0031e-2], atol=5e-7)


def test_caller_guess_matches_jax():
    """a caller guess seeds each lane where it is sane; a lane holding
    the PDEF sentinel takes the default guess, inside bounds too"""
    jpix, tpix, sig, pars = _pixel_batch(nb=6, dims=(19, 19), seed=33)
    guess = pars.copy()
    guess[2] = PDEF
    guess[4, 5] = np.inf
    for bounds in (None, BOX):
        jb = None if bounds is None else tuple(jnp.asarray(x) for x in bounds)
        jres = jax.tree.map(np.asarray, jbatch._exp_lm_measure(
            jpix, sig, jlm.LMConf(), use_pallas=True, interpret=True, bounds=jb,
            guess=jnp.asarray(guess)))
        tres = convert.to_numpy(tbatch._exp_lm_measure(
            tpix, sig, tlm.LMConf(), bounds=bounds, guess=torch.as_tensor(guess)))
        _assert_match({"fit": tres}, {"fit": jres}, types=("fit",))
        # the sentinel lanes are the fit from the default guess
        default = convert.to_numpy(tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(),
                                                         bounds=bounds))
        for k in ("pars", "nfev"):
            np.testing.assert_array_equal(tres[k][[2, 4]], default[k][[2, 4]])
            assert not np.array_equal(tres[k][[0, 1, 3, 5]], default[k][[0, 1, 3, 5]])


def test_guess_is_clamped_inside_the_bounds():
    guess = torch.tensor([[0.0, 2.0, 0.5, -1.5, 20.0, 50.0]], dtype=torch.float64)
    lo, hi = (torch.tensor(x, dtype=torch.float64) for x in BOX)
    out = tbatch._clamp_guess_in_bounds(guess, lo, hi)
    ref = jbatch._clamp_guess_in_bounds(jnp.asarray(guess.numpy()), jnp.asarray(BOX[0]),
                                        jnp.asarray(BOX[1]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert bool(((out > lo) & (out < hi)).all())


@pytest.fixture(scope="module")
def mb_inputs():
    """[4, 2, ...] arrays: 4 objects of 2 epochs, each its own draw"""
    eps = [_inputs(seed) for seed in (21, 22)]
    return tuple(np.stack([ep[i][:4] for ep in eps], axis=1) for i in range(6))


@pytest.mark.parametrize("measure", ["gauss-lm", "dev-lm"])
def test_mb_pipeline_matches_jax(mb_inputs, measure):
    # every object sees both bands, in either order
    band = np.array([[0, 1], [1, 0]] * 2, np.int32)
    jres = jax.tree.map(np.asarray, jax.jit(lambda *a: jbatch.metacal_pipeline_mb(
        *a, jnp.asarray(band), 2, MB_JCONF, measure=measure, objective="epoch"))(
            *map(jnp.asarray, mb_inputs)))
    tres = convert.to_numpy(nt.metacal_pipeline_mb(
        *mb_inputs, band, 2, convert.config_from_fields(MB_JCONF), measure=measure,
        device="cpu"))
    _assert_lm_match(tres, jres)
    for t in jbatch.GALSHEAR_TYPES:
        np.testing.assert_array_equal(tres[t]["nfev"], jres[t]["nfev"], err_msg=t)
        np.testing.assert_allclose(tres[t]["flux"], jres[t]["flux"], rtol=1e-8,
                                   atol=1e-10, err_msg=t)
    assert tres["noshear"]["flux"].shape == (4, 2)


@pytest.mark.parametrize("model", ["gauss", "dev"])
def test_chain_matches_ad(model):
    pars, psf = _chain_inputs()
    pt, pg = torch.as_tensor(pars), torch.as_tensor(psf)
    ref = torch.func.vmap(torch.func.jacfwd(
        lambda p, g: tbatch._exp_reparam(p, g, model)[0]))(pt, pg).numpy()
    out = tbatch.exp_chain(pt, pg, model).numpy()
    n = {"gauss": 1, "dev": 10}[model]
    assert out.shape == ref.shape == (len(pars), n, 6, 6)
    scale = np.abs(ref).reshape(len(pars), -1).max(-1)[:, None, None, None]
    err = np.abs(out - ref)
    assert np.all(err <= 1e-12 * np.abs(ref) + 1e-12 * scale), float(
        np.max(err / (np.abs(ref) + scale)))


def test_unsupported_models_raise():
    pars, psf = _chain_inputs()
    with pytest.raises(KeyError):
        tbatch.exp_chain(torch.as_tensor(pars), torch.as_tensor(psf), "turb")
    args = _small_args()
    with pytest.raises(ValueError, match="hold the models"):
        lm_solve.lm_solve(*args, tlm.LMConf(), "coellip")
    mb = _small_mb()
    with pytest.raises(ValueError, match="hold the models"):
        lm_solve.lm_solve_mb(*mb, tlm.LMConf(), "turb")


@pytest.mark.parametrize("model", ["gauss", "dev"])
def test_cuda_tensors_launch_the_models_kernel(monkeypatch, model):
    """a CUDA tensor launches the model's K3 or K3-mb, never the plain
    version, at any pixel count: past MAX_P too"""
    calls = _mock_card(monkeypatch, 0)
    lib = nt.ops._build.load()  # the mocked library

    def named(name):
        def fn(*a):
            calls.append((name, a))
            return 0
        return fn

    for dt in (torch.float32, torch.float64):
        for kernel in ("lm_solve", "lm_solve_mb"):
            name = lm_solve.c_name(kernel, model, dt)
            setattr(lib, name, named(name))

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(lm_solve, "lm_solve_mb_plain", no_plain)
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    for P in (50, lm_solve.MAX_P + 1):
        args = [_fake_cuda(x) for x in _small_args(P=P, dtype=torch.float32)]
        lm_solve.lm_solve(*args, tlm.LMConf(), model)
        name, c = calls[-1]
        assert name == "ngmix_lm_solve_%s_f32" % model
        assert c[21:23] == (3, P)
    lm_solve.lm_solve_mb(*(_fake_cuda(x) for x in _small_mb()), tlm.LMConf(), model)
    assert calls[-1][0] == "ngmix_lm_solve_mb_%s_f64" % model
    assert lm_solve.launches == 2 and lm_solve.launches_mb == 1


@pytest.mark.parametrize("model", ["gauss", "dev"])
def test_measure_calls_k3_once_with_the_model(monkeypatch, model):
    _, tpix, sig, _ = _pixel_batch(nb=2, dims=(19, 19), seed=32)
    calls = []
    solve = lm_solve.lm_solve

    def spy(*a):
        calls.append(a[9:])
        return solve(*a)

    monkeypatch.setattr(lm_solve, "lm_solve", spy)
    k3 = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), model=model)
    host = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), host_loop=True, model=model)
    # the LMConf's successors: the model, and no prior
    assert calls == [(model, None)]
    for k in ("pars", "flags", "nfev", "s2n"):
        torch.testing.assert_close(k3[k], host[k], rtol=0, atol=0, msg=k)


# ----------------------------------------------------------------------
# the selection estimators

def _results(seed, B=8, all_flagged=False):
    """a numpy result dict of the five galshear types: e1, e2 near a
    sheared mean, s2n in [0, 20], a few flagged lanes (every lane
    with all_flagged)"""
    rng = np.random.RandomState(seed)
    out = {}
    for i, t in enumerate(jbatch.GALSHEAR_TYPES):
        g = 0.01 * np.array([0.0, 1.0, -1.0, 0.0, 0.0][i]), 0.01 * np.array(
            [0.0, 0.0, 0.0, 1.0, -1.0][i])
        flags = (rng.uniform(size=B) < 0.15).astype(np.int32)
        out[t] = {"flags": np.ones(B, np.int32) if all_flagged else flags,
                  "e1": 0.02 + g[0] + rng.normal(0, 0.2, B),
                  "e2": g[1] + rng.normal(0, 0.2, B),
                  "s2n": rng.uniform(0, 20, B)}
    return out


SELECT_CASES = {
    "binding": (dict(seed=3), 10.0),
    "never-binding": (dict(seed=4), -1.0),
    "all-flagged": (dict(seed=5, all_flagged=True), 5.0),
}


@pytest.mark.parametrize("estimator", ["shear_response_select",
                                       "shear_response_select_consistent"])
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_selection_estimators_match_jax(estimator, case):
    kw, cut = SELECT_CASES[case]
    res = _results(**kw)
    jout = getattr(jbatch, estimator)(jax.tree.map(jnp.asarray, res),
                                      lambda r: r["s2n"] > cut)
    tres = {t: {k: torch.as_tensor(v) for k, v in r.items()} for t, r in res.items()}
    tout = convert.to_numpy(getattr(nt, estimator)(tres, lambda r: r["s2n"] > cut))
    assert set(tout) == set(jout)
    for k, ref in jout.items():
        np.testing.assert_allclose(tout[k], np.asarray(ref), rtol=1e-10, atol=0,
                                   equal_nan=True, err_msg=k)
    if case == "all-flagged":
        assert int(tout["n_used"]) == 0
        assert np.all(np.isfinite(tout["e_mean"])) and np.all(np.isfinite(tout["R"]))
    else:
        assert int(tout["n_used"]) > 0 and np.all(np.isfinite(tout["shear"]))


def test_selection_that_never_binds_is_the_plain_response():
    """with no flags a cut that never binds gives shear_response's R and
    shear, and R_sel = 0"""
    res = _results(6)
    for r in res.values():
        r["flags"][:] = 0
    tres = {t: {k: torch.as_tensor(v) for k, v in r.items()} for t, r in res.items()}
    plain = nt.shear_response(tres)
    sel = nt.shear_response_select(tres, lambda r: r["s2n"] > -1.0)
    cons = nt.shear_response_select_consistent(tres, lambda r: r["s2n"] > -1.0)
    assert bool((sel["R_sel"] == 0).all())
    for out in (sel, cons):
        for k in ("R", "shear", "e_mean", "n_used"):
            torch.testing.assert_close(out[k], plain[k], rtol=0, atol=0, msg=k)


def test_kernel_model_tables_are_the_fills_tables():
    """the (p, f) tables compiled into K3 and K3-mb (csrc/lm_common.cuh)
    are gmix/tables.py's, value for value"""
    import re

    from ngmix_tpu_torch.gmix import tables
    from ngmix_tpu_torch.ops import _build

    src = (_build.CSRC / "lm_common.cuh").read_text()
    for model, name in (("exp", "Exp"), ("dev", "Dev")):
        for kind, ref in zip("PF", tables.MODEL_TABLES[model]):
            body = re.search(r"k%svals%s\[\d+\] = \{([^}]*)\}" % (kind, name), src).group(1)
            np.testing.assert_array_equal(np.array([float(x) for x in body.split(",")]), ref)
    gauss = re.search(r"struct GaussModel \{(.*?)\};", src, re.S).group(1)
    assert "kNG = 1;" in gauss and gauss.count("return 1.0;") == 2
    for vals in tables.MODEL_TABLES["gauss"]:
        assert tuple(vals) == (1.0,)
