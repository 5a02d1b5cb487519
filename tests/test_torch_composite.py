"""The bdf and bd bulge+disk models of the PyTorch port against the JAX
package on the same numpy inputs in float64.

Tolerances:
- the fills (fill_bdf, fill_bd, fill_cm, get_cm_Tfactor): rtol 1e-12,
  as tests/test_misc_components.py holds mixture evaluation;
- the closed-form chain for bdf and bd against torch.func.jacfwd of the
  reparametrization: rtol 1e-12 with an atol of 1e-12 times the lane's
  largest |entry| (the criterion of tests/test_torch_lm_solve.py);
- the normal equations at fixed pars against the JAX package's AD
  normal equations (_make_ad_normal_fn): cost to rtol 1e-10, Jtr and
  JtJ to rtol 1e-8 with an atol of 1e-8 times their largest |value|
  (tests/test_pallas_lm.py:65-73);
- the pipelines (bdf-lm and bd-lm flat, bd-lm under dilate, and the mb
  pipeline): flags and nfev equal, pars, e1, e2, T, flux, s2n, fracdev
  and logTdByTe to rtol 1e-8 and atol 1e-10, as
  tests/test_batch_pipeline.py:822-828 holds two implementations of one
  objective. The JAX package fits these models only by AD normal
  equations, so its flat pipeline runs that route and its mb pipeline
  its "epoch" objective. The bounds are the reference tests' boxes
  (tests/test_batch_pipeline.py:331-332, 366-367);
- the mb pipeline at E = 1 and one band against the flat one: bitwise,
  as the reference's own test (tests/test_batch_pipeline.py:343-354).

The CUDA kernels run only on the card (chip_smoke.py, phase 22); here
the wrappers' dispatch to each composite model's kernel is checked on a
mocked card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.gmix import core as jcore

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert, sims
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.gmix import core as tcore
from ngmix_tpu_torch.ops import lm_solve
from ngmix_tpu_torch.pixels import Pixels

from test_torch_lm_solve import _chain_inputs, _fake_cuda, _mock_card
from test_torch_mb import JCONF as MB_JCONF
from test_torch_normal_eqs import _pixel_batch, _psf_gmix
from test_torch_pipeline import DIMS, EXP_LM_CONF, PSF_DIMS, _inputs, _load_bench

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

# the reference tests' boxes (tests/test_batch_pipeline.py:331-332, 366-367)
BDF_BOX = ([-2.0, -2.0, -0.99, -0.99, 0.01, 0.0, 0.1], [2.0, 2.0, 0.99, 0.99, 10.0, 1.0, 1e6])
BD_BOX = ([-2.0, -2.0, -0.99, -0.99, 0.01, -1.0, 0.0, 0.1],
          [2.0, 2.0, 0.99, 0.99, 10.0, 1.0, 1.0, 1e6])
KEYS = ("pars", "e1", "e2", "T", "flux", "s2n", "fracdev")


def _composite_pars(pars, model, seed=5):
    """pars [n, 6] of a simple model with the composite model's extra
    columns inserted before the flux: fracdev in [0.05, 0.95], and bd's
    log10(Td/Te) in [-0.3, 0.3]"""
    rng = np.random.RandomState(seed)
    n = len(pars)
    extra = [rng.uniform(0.05, 0.95, n)]
    if model == "bd":
        extra = [rng.uniform(-0.3, 0.3, n)] + extra
    return np.concatenate([pars[:, :5], np.stack(extra, -1), pars[:, 5:]], -1)


# ----------------------------------------------------------------------
# the fills, the chain and the normal equations

def _fill_case(name):
    rng = np.random.RandomState(11)
    n = 8
    pars = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(-0.6, 0.6, n),
                     rng.uniform(-0.6, 0.6, n), rng.uniform(0.05, 3.0, n),
                     rng.uniform(1.0, 200.0, n)], -1)
    fracdev = rng.uniform(-0.2, 1.2, n)
    TdByTe = rng.uniform(0.3, 3.0, n)
    return {
        "fill_bdf": (_composite_pars(pars, "bdf"),),
        "fill_bd": (_composite_pars(pars, "bd"),),
        "fill_cm": (pars, fracdev, TdByTe),
        "get_cm_Tfactor": (fracdev, TdByTe),
    }[name]


@pytest.mark.parametrize("name", ["fill_bdf", "fill_bd", "fill_cm", "get_cm_Tfactor"])
def test_fills_match_jax(name):
    args = _fill_case(name)
    ref = getattr(jcore, name)(*map(jnp.asarray, args))
    out = getattr(tcore, name)(*map(torch.as_tensor, args))
    if name == "get_cm_Tfactor":
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12, atol=0)
    if name.startswith("fill"):
        assert out[0].shape[-2:] == (16, 6) and out[1].dtype == torch.int32


@pytest.mark.parametrize("model", ["bdf", "bd"])
def test_chain_matches_ad(model):
    pars, psf = _chain_inputs()
    pt = torch.as_tensor(_composite_pars(pars, model))
    pg = torch.as_tensor(psf)
    ref = torch.func.vmap(torch.func.jacfwd(
        lambda p, g: tbatch._exp_reparam(p, g, model)[0]))(pt, pg).numpy()
    out = tbatch.exp_chain(pt, pg, model).numpy()
    npars = {"bdf": 7, "bd": 8}[model]
    assert out.shape == ref.shape == (len(pars), 16, 6, npars)
    scale = np.abs(ref).reshape(len(pars), -1).max(-1)[:, None, None, None]
    err = np.abs(out - ref)
    assert np.all(err <= 1e-12 * np.abs(ref) + 1e-12 * scale), float(
        np.max(err / (np.abs(ref) + scale)))


@pytest.mark.parametrize("model", ["bdf", "bd"])
def test_normal_eqs_match_ad(model):
    jpix, tpix, sig, pars = _pixel_batch(nb=6, dims=(19, 19))
    p = _composite_pars(pars, model)
    psf = _psf_gmix(len(p), sig)
    fn = jax.jit(jbatch._make_ad_normal_fn(getattr(jcore, "fill_" + model)))
    ref = [np.asarray(x) for x in fn(jnp.asarray(p), (jpix, jnp.asarray(psf)))]
    out = [x.numpy() for x in tbatch._exp_normal_fn(
        torch.as_tensor(p), tbatch._lm_planes(tpix), torch.as_tensor(psf), plain=True,
        model=model)]
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-10, atol=0)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o, r, rtol=1e-8, atol=1e-8 * np.abs(r).max())
    assert out[2].shape == (len(p), len(p[0]), len(p[0]))


# ----------------------------------------------------------------------
# the pipelines

def _assert_match(tres, jres, keys, types=jbatch.GALSHEAR_TYPES):
    for t in types:
        assert set(tres[t]) == set(jres[t]), set(tres[t]) ^ set(jres[t])
        for k in ("flags", "nfev"):
            np.testing.assert_array_equal(tres[t][k], jres[t][k], err_msg=(t, k))
        for k in keys:
            np.testing.assert_allclose(tres[t][k], jres[t][k], rtol=1e-8, atol=1e-10,
                                       err_msg=(t, k))
        np.testing.assert_array_equal(tres[t]["e1"], tres[t]["pars"][:, 2])
        assert np.all(tres[t]["flags"] == 0)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


FLAT_CASES = {
    "bdf-lm": ("bdf-lm", BDF_BOX, "gauss"),
    "bd-lm": ("bd-lm", BD_BOX, "gauss"),
    "bd-lm-dilate": ("bd-lm", BD_BOX, "dilate"),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_pipeline_matches_jax(inputs, case):
    measure, box, mode = FLAT_CASES[case]
    jconf = jbatch.MetacalConfig(dims=DIMS, psf_dims=PSF_DIMS,
                                 **dict(EXP_LM_CONF, psf_mode=mode))
    jres = jax.tree.map(np.asarray, jbatch.make_metacal_pipeline_fn(
        jconf, measure=measure, lm_bounds=tuple(map(jnp.asarray, box)))(
            *map(jnp.asarray, inputs)))
    tres = convert.to_numpy(nt.make_metacal_pipeline_fn(
        convert.config_from_fields(jconf), measure=measure, lm_bounds=box,
        device="cpu")(*inputs))
    keys = KEYS + (("logTdByTe",) if measure == "bd-lm" else ())
    _assert_match(tres, jres, keys, types=jconf.types)
    pars = tres["noshear"]["pars"]
    assert pars.shape == (len(inputs[0]), len(box[0]))
    assert np.all((pars > np.asarray(box[0])) & (pars < np.asarray(box[1])))
    if mode == "gauss":
        # a pure exp galaxy is bdf with fracdev = 0, at its lower bound
        assert float(np.mean(tres["noshear"]["fracdev"])) < 0.05


@pytest.fixture(scope="module")
def mb_inputs():
    """[4, 2, ...] arrays: 4 objects of 2 epochs, each its own draw"""
    eps = [_inputs(seed) for seed in (21, 22)]
    return tuple(np.stack([ep[i][:4] for ep in eps], axis=1) for i in range(6))


# the production box of tools/validate_scale.py:436-442 (two bands), and
# the reference's bd box with its flux bound once a band
MB_BDF_BOX = ([-2.0, -2.0, -0.99, -0.99, 1e-3, 0.0, 1e-3, 1e-3],
              [2.0, 2.0, 0.99, 0.99, 20.0, 1.0, 1e9, 1e9])
MB_BD_BOX = tuple(list(x) + [x[-1]] for x in BD_BOX)


def _mb_matches_jax(mb_inputs, measure, box):
    # every object sees both bands, in either order
    band = np.array([[0, 1], [1, 0]] * 2, np.int32)
    jres = jax.tree.map(np.asarray, jax.jit(lambda *a: jbatch.metacal_pipeline_mb(
        *a, jnp.asarray(band), 2, MB_JCONF, measure=measure, objective="epoch",
        lm_bounds=tuple(map(jnp.asarray, box))))(*map(jnp.asarray, mb_inputs)))
    tres = convert.to_numpy(nt.metacal_pipeline_mb(
        *mb_inputs, band, 2, convert.config_from_fields(MB_JCONF), measure=measure,
        lm_bounds=box, device="cpu"))
    keys = KEYS + ("s2n_flux",) + (("logTdByTe",) if measure == "bd-lm" else ())
    _assert_match(tres, jres, keys)
    assert tres["noshear"]["flux"].shape == (4, 2)
    assert tres["noshear"]["pars"].shape == (4, len(box[0]))


def test_mb_pipeline_matches_jax(mb_inputs):
    _mb_matches_jax(mb_inputs, "bdf-lm", MB_BDF_BOX)


def test_mb_bd_pipeline_matches_jax(mb_inputs):
    """bd in the joint fit: 7 shape columns, then a flux a band"""
    _mb_matches_jax(mb_inputs, "bd-lm", MB_BD_BOX)


def test_mb_at_one_epoch_is_the_flat_fit(inputs):
    """at E = 1 and one band the joint bdf fit is the flat one, bit for
    bit (the reference's own check)"""
    conf = convert.config_from_fields(MB_JCONF)
    box = BDF_BOX
    flat = nt.metacal_pipeline(*inputs, conf, measure="bdf-lm", lm_bounds=box, device="cpu")
    mb = nt.metacal_pipeline_mb(*(x[:, None] for x in inputs), np.zeros(1, np.int32), 1, conf,
                                measure="bdf-lm", lm_bounds=box, device="cpu")
    for t in tbatch.GALSHEAR_TYPES:
        for k in ("pars", "flags", "nfev", "fracdev", "s2n"):
            torch.testing.assert_close(mb[t][k], flat[t][k], rtol=0, atol=0, msg=(t, k))


# ----------------------------------------------------------------------
# the sims, dispatch and the host-loop route

def test_bdf_sims_match_bench_on_the_same_draws(monkeypatch):
    """make_sim_batch_hetero(gal_model="bdf") against bench.py's, every
    draw fed from one numpy stream on each side in the same order (the
    fracdev draw after the shapes and before the psf, as in bench.py);
    rtol 1e-12 with an atol of 1e-12 times the largest |value|, since
    the 16-gaussian sums of the two renders round differently where a
    pixel's value is ~1e-12 of the peak"""
    bench = _load_bench()

    def draws(seed=29):
        rng = np.random.RandomState(seed)
        return (lambda shape, lo, hi: rng.uniform(lo, hi, shape),
                lambda shape: rng.normal(0.0, 1.0, shape))

    ju, jn = draws()
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype, minval=0.0, maxval=1.0:
                        jnp.asarray(ju(shape, minval, maxval), dtype))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(jn(shape), dtype))
    ref = bench.make_sim_batch_hetero(jax.random.PRNGKey(0), 6, jnp.float64, gal_model="bdf")
    tu, tn = draws()
    monkeypatch.setattr(sims, "_uniform", lambda gen, shape, dtype, lo, hi:
                        torch.as_tensor(tu(shape, lo, hi), dtype=dtype))
    monkeypatch.setattr(sims, "_normal", lambda gen, shape, dtype:
                        torch.as_tensor(tn(tuple(shape)), dtype=dtype))
    out = sims.make_sim_batch_hetero(torch.Generator(), 6, torch.float64, device="cpu",
                                     gal_model="bdf")
    for got, want in zip(out, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    mb = sims.make_sim_batch_mb(torch.Generator(), 2, torch.float64, device="cpu",
                                hetero=True, gal_model="bdf")
    assert mb[0].shape == (2, len(sims.MB_BAND)) + sims.DIMS
    with pytest.raises(ValueError, match="hetero=True"):
        sims.make_sim_batch_mb(torch.Generator(), 2, device="cpu", gal_model="bdf")


def _composite_solve_args(model, B=3, P=50):
    """K3's arguments for the composite model, float32"""
    rng = np.random.RandomState(3)
    npars = {"bdf": 7, "bd": 8}[model]
    guess = _composite_pars(rng.normal(size=(B, 6)), model)
    t = [torch.as_tensor(x, dtype=torch.float32).contiguous() for x in
         [guess, np.full(npars, -np.inf), np.full(npars, np.inf),
          np.tile([0.05, 0.0, 0.05], (B, 1))] + [rng.normal(size=(B, P)) for _ in range(4)]]
    return t


@pytest.mark.parametrize("model", ["bdf", "bd"])
def test_cuda_tensors_launch_the_composite_kernels(monkeypatch, model):
    """a CUDA tensor launches the composite model's K3 or K3-mb once a
    call, with its parameter count, never the plain version"""
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
    args = [_fake_cuda(x) for x in _composite_solve_args(model)]
    out = lm_solve.lm_solve(*args, tlm.LMConf(), model)
    name, c = calls[-1]
    assert name == "ngmix_lm_solve_%s_f32" % model and c[21:23] == (3, 50)
    npars = args[0].shape[1]
    assert out["JtJ"].shape == (3, npars, npars) and out["pinned"].shape == (3, npars)
    # K3-mb: 2 epochs, 2 bands after the model's shape columns
    g, lo, hi = args[0], args[1], args[2]
    mb_guess = torch.cat([g, g[:, -1:]], 1).contiguous()
    inf = torch.full((npars + 1,), np.inf)
    planes = [torch.as_tensor(np.random.RandomState(4).normal(size=(3, 2, 50)))
              .float().contiguous() for _ in range(4)]
    mb_args = [_fake_cuda(x) for x in [mb_guess, -inf, inf,
                                       torch.full((3, 2, 3), 0.05).contiguous()]]
    band = _fake_cuda(torch.tensor([0, 1], dtype=torch.int32))
    lm_solve.lm_solve_mb(*mb_args, band, *(_fake_cuda(x) for x in planes), tlm.LMConf(),
                         model)
    name, c = calls[-1]
    assert name == "ngmix_lm_solve_mb_%s_f32" % model
    assert c[22:26] == (3, 2, 50, 2)
    assert lm_solve.launches == 1 and lm_solve.launches_mb == 1
    with pytest.raises(ValueError, match="exp model.s 6-parameter"):
        lm_solve.lm_solve(*args, tlm.LMConf(), "exp")


def test_default_guess_inserts_the_extra_columns(monkeypatch):
    """the composite models start from exp's moments guess with fracdev
    at 0.5 and bd's log10(Td/Te) at 0 inserted before the flux (the
    reference's guess, ngmix_tpu/batch.py:1028-1041)"""
    _, tpix, sig, _ = _pixel_batch(nb=2, dims=(19, 19), seed=32)
    guesses = {}

    class Seen(Exception):
        pass

    def spy(guess, *args):
        guesses[len(guesses)] = guess
        raise Seen

    monkeypatch.setattr(lm_solve, "lm_solve", spy)
    for model in ("exp", "bdf", "bd"):
        with pytest.raises(Seen):
            tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), model=model)
    exp, bdf, bd = guesses.values()
    half, zero = torch.full((2,), 0.5, dtype=exp.dtype), torch.zeros(2, dtype=exp.dtype)
    torch.testing.assert_close(bdf, torch.cat([exp[:, :5], half[:, None], exp[:, 5:]], -1),
                               rtol=0, atol=0)
    torch.testing.assert_close(bd, torch.cat([exp[:, :5], zero[:, None], half[:, None],
                                              exp[:, 5:]], -1), rtol=0, atol=0)


@pytest.mark.parametrize("model", ["bdf", "bd"])
def test_host_loop_route_raises_for_composite_models(model):
    """the host-loop route runs K1, which fits 6 parameters as the TPU
    kernel does"""
    _, tpix, sig, _ = _pixel_batch(nb=2, dims=(19, 19), seed=32)
    for pix in (tpix, Pixels(*(x.to("meta") for x in tpix))):
        with pytest.raises(ValueError, match="host-loop route"):
            tbatch._exp_lm_measure(pix, sig, tlm.LMConf(), host_loop=True, model=model)


def test_every_model_and_type_has_its_c_functions():
    """the sources define each model's K3 and K3-mb C functions exactly
    once, float32 and float64, and the build compiles every unit"""
    import re

    from ngmix_tpu_torch.ops import _build

    defined = []
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        defined += re.findall(r"^NGMIX_LM_SOLVE(?:_MB)?\((ngmix_\w+),", text, re.M)
    want = [lm_solve.c_name(k, m, dt) for k in ("lm_solve", "lm_solve_mb")
            for m in lm_solve.MODELS for dt in (torch.float32, torch.float64)]
    assert sorted(defined) == sorted(want)
    compiles, _ = _build.nvcc_commands("out.so")
    assert len(compiles) == len(_build.sources())
