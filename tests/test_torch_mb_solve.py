"""The pieces of the port's multi-band fit against the JAX package on the
same numpy inputs in float64: fitting.fit_model's per-epoch parameter
rows, the joint normal equations (batch._mb_exp_normal_fn), the
compaction gather (batch._mb_gather) and K3-mb's wrapper
(ops.lm_solve.lm_solve_mb).

Tolerances:
- epoch_band_pars and get_band_pars_device: exact (a selection);
- the normal equations against the reference's
  _mb_epochwise_normal_fn_f (AD): cost to rtol 1e-10, Jtr and JtJ to
  rtol 1e-8 with an atol of 1e-8 times the largest |entry|
  (tests/test_pallas_lm.py:65-73); a lane with a bad epoch gets the
  reference's FDIFF_BAD values exactly up to the sum's rounding;
- compaction with the mb gather: bitwise equal to the uncompacted run
  (tests/test_pallas_lm.py:126-144).

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper's dispatch is checked with a mocked CUDA tensor and library.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.fitting import fit_model as jfit
from ngmix_tpu.pixels import Pixels as JPixels

from ngmix_tpu_torch import batch as tbatch
from ngmix_tpu_torch.fitting import fit_model, lm as tlm
from ngmix_tpu_torch.ops import _build, lm_solve
from ngmix_tpu_torch.pixels import Pixels

from test_torch_lm_solve import _fake_cuda, _mock_card
from test_torch_normal_eqs import _pixel_batch

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

NOBJ, E, NBAND = 4, 3, 2


@pytest.mark.parametrize("model,npars", [("exp", 7), ("gauss", 7), ("dev", 8), ("bdf", 8),
                                         ("bd", 9), ("coellip", 8)])
def test_epoch_band_pars_match_jax(model, npars):
    rng = np.random.RandomState(3)
    pars = rng.normal(size=(NOBJ, npars))
    simple = model in ("exp", "gauss", "dev")
    band = rng.randint(0, npars - 5 if simple else 2, size=(NOBJ, E)).astype(np.int32)
    ref = jax.vmap(lambda p, b: jfit.epoch_band_pars(model, p, b))(pars, band)
    out = fit_model.epoch_band_pars(model, torch.as_tensor(pars), torch.as_tensor(band))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    one = jax.vmap(lambda p, b: jfit.get_band_pars_device(model, p, b))(pars, band[:, 1])
    out1 = fit_model.get_band_pars_device(model, torch.as_tensor(pars),
                                          torch.as_tensor(band[:, 1]))
    np.testing.assert_array_equal(out1.numpy(), np.asarray(one))
    assert fit_model.FDIFF_BAD == jfit.FDIFF_BAD


def test_epoch_band_pars_out_of_range_band_selects_no_flux():
    pars = torch.arange(7, dtype=torch.float64)[None]
    out = fit_model.epoch_band_pars("exp", pars, torch.tensor([[0, 1, 2, -1]]))
    np.testing.assert_array_equal(out[0, :, 5].numpy(), [5.0, 6.0, 0.0, 0.0])


def _mb_case(nobj=NOBJ, seed=41):
    """nobj objects of E independent noisy 19x19 exp stamps (one with
    masked pixels), an elliptical psf gaussian per epoch, the per-object
    band map and trial pars [nobj, 5 + NBAND]; lane 1 has a trial point
    with |g| >= 1 and lane 2 an epoch whose psf makes a gaussian fail
    gmix_flags' rule (a bad epoch)"""
    _, tpix, sig, pars = _pixel_batch(nb=nobj * E, dims=(19, 19), seed=seed)
    rng = np.random.RandomState(seed)
    psf = np.stack([np.full(nobj * E, sig**2) * rng.uniform(0.9, 1.1, nobj * E),
                    rng.uniform(-0.003, 0.003, nobj * E),
                    np.full(nobj * E, sig**2) * rng.uniform(0.9, 1.1, nobj * E)], -1)
    band = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0]], np.int32)[:nobj]
    trial = np.concatenate([pars.reshape(nobj, E, 6)[:, 0, :5],
                            pars.reshape(nobj, E, 6)[:, :NBAND, 5]], -1)
    trial[1, 2:4] = [0.8, 0.7]
    psf[2 * E + 1] = [-0.5, 0.0, -0.5]
    return tpix, psf, band, trial


@pytest.fixture(scope="module")
def mb_case():
    return _mb_case()


def _port_normal(tpix, psf, band, trial):
    planes = tuple(x.contiguous() for x in tbatch._lm_planes(tpix))
    data = (planes, tbatch._psf_gmix(torch.as_tensor(psf)), torch.as_tensor(band))
    return [x.numpy() for x in tbatch._mb_exp_normal_fn(torch.as_tensor(trial), data,
                                                           plain=True)]


def test_mb_normal_fn_matches_jax(mb_case):
    tpix, psf, band, trial = mb_case
    cost, Jtr, JtJ = _port_normal(*mb_case)
    jpix = JPixels(*(jnp.asarray(x.numpy()) for x in tpix))
    psf_gmix = tbatch._psf_gmix(torch.as_tensor(psf)).numpy()
    data = jfit.FitData(pixels=jpix, psf_gmix=jnp.asarray(psf_gmix), band=jnp.asarray(band))
    rc, rj, rJ = (np.asarray(x) for x in jax.jit(
        jbatch._mb_epochwise_normal_fn_f("exp", NBAND))(jnp.asarray(trial), data))
    np.testing.assert_allclose(cost, rc, rtol=1e-10)
    for out, ref in ((Jtr, rj), (JtJ, rJ)):
        scale = np.abs(ref).reshape(len(ref), -1).max(-1).reshape((-1,) + (1,) * (ref.ndim - 1))
        assert np.all(np.abs(out - ref) <= 1e-8 * np.abs(ref) + 1e-8 * scale)
    # the two bad lanes: every row FDIFF_BAD, zero gradient and curvature
    P = tpix.val.shape[-1]
    for lane in (1, 2):
        np.testing.assert_allclose(cost[lane], E * P * jfit.FDIFF_BAD**2, rtol=1e-12)
        assert np.all(Jtr[lane] == 0) and np.all(JtJ[lane] == 0)
        assert np.all(rj[lane] == 0) and np.all(rJ[lane] == 0)
    # a good lane's flux block is diagonal and its JtJ symmetric
    assert JtJ[0, 5, 6] == 0 and JtJ[0, 5, 5] > 0
    np.testing.assert_array_equal(JtJ, np.swapaxes(JtJ, -1, -2))


def test_mb_normal_fn_one_epoch_is_the_flat_normal_fn(mb_case):
    """at E = 1 and one band the assembly adds nothing: the flat
    normal equations' bits on a good lane"""
    tpix, psf, _, trial = mb_case
    one = Pixels(*(x[::E] for x in tpix))
    pars = np.concatenate([trial[:, :5], trial[:, 5:6]], -1)
    cost, Jtr, JtJ = _port_normal(one, psf[::E], np.zeros((NOBJ, 1), np.int32), pars)
    planes = tuple(x.contiguous() for x in tbatch._lm_planes(one))
    flat = tbatch._exp_normal_fn(torch.as_tensor(pars), planes,
                                 tbatch._psf_gmix(torch.as_tensor(psf[::E])), plain=True)
    for out, ref in zip((cost, Jtr, JtJ), flat):
        np.testing.assert_array_equal(out[[0, 2, 3]], ref.numpy()[[0, 2, 3]])


def _solve_args(tpix, psf, band, trial):
    planes = [x.reshape(NOBJ, E, -1).contiguous() for x in tbatch._lm_planes(tpix)]
    inf = torch.full((5 + NBAND,), torch.inf, dtype=torch.float64)
    return ([torch.as_tensor(trial), -inf, inf,
             torch.as_tensor(psf).reshape(NOBJ, E, 3).contiguous(),
             torch.as_tensor(band)] + planes)


def test_compaction_with_the_mb_gather_is_bitwise_exact(mb_case):
    """the folded epoch rows gathered by _mb_gather at each compaction
    level give the bits of the uncompacted run (K3-mb's plain
    version)"""
    tpix, psf, band, trial = mb_case
    trial = trial.copy()
    trial[1, 2:4] = [0.1, -0.1]
    args = _solve_args(tpix, psf, band, trial)
    conf = tlm.LMConf()
    plain = lm_solve.lm_solve_mb(*args, conf)
    B, _, P = args[5].shape
    data = (tuple(x.reshape(B * E, P) for x in args[5:]),
            tbatch._psf_gmix(args[3].reshape(B * E, 3)), args[4])
    seen = []

    def gather(d, idx):
        seen.append(len(idx))
        return tbatch._mb_gather(E)(d, idx)

    cmp = tlm.run_lm_normal_state(
        functools.partial(tbatch._mb_exp_normal_fn, plain=True), data, args[0],
        args[1], args[2], conf, compact_capacity=(3, 2), gather_fn=gather,
    )
    assert seen == [3, 2]
    assert int(plain["nfev"].max()) > int(plain["nfev"].min())
    for k in plain:
        torch.testing.assert_close(cmp[k], plain[k], rtol=0, atol=0, msg=k)
    assert plain["JtJ"].shape == (NOBJ, 7, 7)


def test_measure_calls_lm_solve_mb_once(monkeypatch):
    tpix, psf, band, _ = _mb_case()
    calls = []
    solve = lm_solve.lm_solve_mb

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return solve(*a)

    monkeypatch.setattr(lm_solve, "lm_solve_mb", spy)
    psf[2 * E + 1] = psf[2 * E]
    out = tbatch._mb_exp_lm_measure(tpix, torch.as_tensor(psf), torch.as_tensor(band), NBAND,
                                    tlm.LMConf())
    assert calls == [(NOBJ, 5 + NBAND)]
    assert out["flux"].shape == (NOBJ, NBAND) and np.all(out["flags"].numpy() == 0)


# ----------------------------------------------------------------------
# the wrapper on a mocked card

def _small_mb(B=3, E_=2, P=50, nband=2, dtype=torch.float64):
    rng = np.random.RandomState(3)
    npars = 5 + nband
    out = [rng.normal(size=(B, npars)), np.full(npars, -np.inf), np.full(npars, np.inf),
           np.tile([0.05, 0.0, 0.05], (B, E_, 1))]
    planes = [rng.normal(size=(B, E_, P)) for _ in range(4)]
    t = [torch.as_tensor(x, dtype=dtype).contiguous() for x in out + planes]
    return t[:4] + [torch.tensor([0, 1], dtype=torch.int32)[:E_]] + t[4:]


def test_cuda_tensor_launches_k3_mb_never_plain(monkeypatch):
    calls = _mock_card(monkeypatch, 0)
    lib = _build.load()  # the mocked library
    lib.ngmix_lm_solve_mb_exp_f32 = lib.ngmix_lm_solve_mb_exp_f64 = lib.ngmix_lm_solve_exp_f64

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(lm_solve, "lm_solve_mb_plain", no_plain)
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    args = [_fake_cuda(x) for x in _small_mb()]
    conf = tlm.LMConf(maxfev=77, ftol=2e-5)
    out = lm_solve.lm_solve_mb(*args, conf)
    assert lm_solve.launches_mb == 1 and lm_solve.launches == 0
    (_, dev), c = calls
    assert dev == args[0].device
    assert c[:4] == tuple(x.data_ptr() for x in args[:4])
    assert c[5:9] == tuple(x.data_ptr() for x in args[5:])
    assert c[9:20] == tuple(x.data_ptr() for x in out.values())
    # no prior: a null table of 0 rows
    assert c[21:] == (None, 3, 2, 50, 2, 0, 77, 2e-5, conf.xtol, conf.lambda0,
                      conf.lambda_up, conf.lambda_down, conf.lambda_min, conf.lambda_max, 4321)
    assert [tuple(x.shape) for x in out.values()] == [
        (3, 7), (3,), (3,), (3, 7), (3, 7, 7), (3,), (3,), (3,), (3,), (3,), (3, 7)]


def test_cuda_launch_error_raises_mb(monkeypatch):
    _mock_card(monkeypatch, 700)
    lib = _build.load()
    lib.ngmix_lm_solve_mb_exp_f64 = lib.ngmix_lm_solve_exp_f64
    monkeypatch.setattr(lm_solve, "launches_mb", 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        lm_solve.lm_solve_mb(*(_fake_cuda(x) for x in _small_mb()), tlm.LMConf())
    assert lm_solve.launches_mb == 0


def test_bad_inputs_raise_mb():
    conf = tlm.LMConf()
    guess, lo, hi, psf, band, v, u, ia, ve = _small_mb()
    planes = (v, u, ia, ve)
    with pytest.raises(ValueError, match="1 to 6 bands"):
        big = _small_mb(nband=7)
        lm_solve.lm_solve_mb(*big[:4], big[4], *big[5:], conf)
    with pytest.raises(ValueError, match="1 to 6 bands"):
        lm_solve.lm_solve_mb(guess[:, :5], lo[:5], hi[:5], psf, band, *planes, conf)
    with pytest.raises(ValueError, match="lo and hi"):
        lm_solve.lm_solve_mb(guess, lo[:6], hi, psf, band, *planes, conf)
    with pytest.raises(ValueError, match=r"\[B, E, P\]"):
        lm_solve.lm_solve_mb(guess, lo, hi, psf, band, v[0], u, ia, ve, conf)
    with pytest.raises(ValueError, match="share one"):
        lm_solve.lm_solve_mb(guess, lo, hi, psf, band, v, u[:, :, :10], ia, ve, conf)
    with pytest.raises(ValueError, match="psf gaussian per epoch"):
        lm_solve.lm_solve_mb(guess, lo, hi, psf[:, 0], band, *planes, conf)
    for bad_band in (band.long(), band[:1], torch.zeros((3, 3), dtype=torch.int32)):
        with pytest.raises(ValueError, match="band must be"):
            lm_solve.lm_solve_mb(guess, lo, hi, psf, bad_band, *planes, conf)
    with pytest.raises(TypeError):
        lm_solve.lm_solve_mb(guess, lo, hi, psf, band, v.float(), u, ia, ve, conf)
    with pytest.raises(ValueError, match="contiguous"):
        lm_solve.lm_solve_mb(guess, lo, hi, psf, band, v.transpose(0, 1).contiguous()
                             .transpose(0, 1), u, ia, ve, conf)
    with pytest.raises(ValueError, match="maxfev"):
        lm_solve.lm_solve_mb(guess, lo, hi, psf, band, *planes, tlm.LMConf(maxfev=0))
    # a [B, E] band map and an [E] one give the same solve, and the
    # LMConf options change nothing in the mb fit, as in the reference
    a = lm_solve.lm_solve_mb(guess, lo, hi, psf, band, *planes, conf)
    c = lm_solve.lm_solve_mb(guess, lo, hi, psf, band, *planes,
                             conf._replace(varpro=True, flux_col=True))
    for k in a:
        torch.testing.assert_close(c[k], a[k], rtol=0, atol=0, msg=k)
    b = lm_solve.lm_solve_mb(guess, lo, hi, psf, band.expand(3, 2).contiguous(), *planes, conf)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_build_compiles_lm_solve_mb():
    """one translation unit a model, so the models build in parallel"""
    compiles, _ = _build.nvcc_commands("out.so")
    for model in lm_solve.MODELS:
        assert sum(c.endswith("lm_solve_mb_%s.cu" % model) for cmd in compiles
                   for c in cmd) == 1, model
    # the shared headers are part of the library's hash
    assert (_build.CSRC / "lm_common.cuh").exists()
    assert (_build.CSRC / "lm_solve_mb.cuh").exists()
