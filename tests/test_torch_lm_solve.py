"""K3 of the PyTorch port (ngmix_tpu_torch/ops/lm_solve.py), the whole
exp-model LM solve, and the closed-form chain it uses
(batch.exp_chain), against the JAX package on the same numpy inputs in
float64.

Tolerances:
- exp_chain against the forward-mode jacobian of the same map by
  torch.func, and against the reference's
  jax.vmap(jax.jacfwd(reparam_of)) (ngmix_tpu/batch.py:812-818): rtol
  1e-12, the mixture tolerance of tests/test_misc_components.py:135,
  with an atol of 1e-12 times the lane's largest |entry| for entries
  that cancel to ~0 (AD and the closed form round them differently);
- lm_solve_plain against the JAX K1 route (run_lm_normal_batched over
  _exp_normal_fn with the TPU kernel in interpret mode) per lane: flags
  equal, e1/e2/T/flux to rtol 1e-5 and atol 1e-7, nfev within 2
  (tests/test_pallas_lm.py:107-123);
- K3's plain version against the host loop with compaction: bitwise
  (tests/test_pallas_lm.py:126-144).

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper's dispatch is checked with a mocked CUDA tensor and library.
"""
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.fitting import lm as jlm
from ngmix_tpu.gmix import core as jcore
from ngmix_tpu.ops import pallas_lm

from ngmix_tpu_torch import batch as tbatch
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.ops import _build, lm_solve

from test_torch_normal_eqs import _pixel_batch

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

NB = 8
INF = np.inf
BOUNDS = {
    "unbounded": (np.full(6, -INF), np.full(6, INF)),
    # two-sided on the centre and g1 (tight enough that some lanes end
    # on a bound), one-sided on T
    "bounded": (np.array([-1.0, -1.0, -0.05, -INF, 0.0, -INF]),
                np.array([1.0, 1.0, 0.05, INF, INF, INF])),
}


# ----------------------------------------------------------------------
# the closed-form chain

def _chain_inputs():
    """pars [NB, 6] and psf [NB, 1, 6] over round, elliptical, near
    |g| = 1, clipped |g| > 1, small-T and negative-T (invalid
    gaussians) lanes, with round and non-round psfs"""
    pars = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.5, 100.0],
        [0.1, -0.2, 0.3, -0.2, 0.8, 60.0],
        [0.0, 0.1, 0.7, 0.7, 0.4, 10.0],     # |g| = 0.99
        [0.0, 0.0, -0.9999, 0.0, 0.3, 1.0],
        [0.0, 0.0, 0.8, 0.8, 0.3, 5.0],      # |g| > 1: clipped
        [0.3, 0.0, 0.05, 0.1, 1.0e-4, 50.0],  # small T
        [0.0, 0.0, 0.2, 0.1, -0.5, 20.0],     # some gaussians invalid
        [-0.2, 0.3, -0.4, 0.25, 2.0, 300.0],
    ])
    psf = np.zeros((NB, 1, 6))
    psf[:, 0, 0] = 1.0
    psf[:, 0, 3:] = [0.055, 0.0, 0.055]
    psf[1, 0, 3:] = [0.06, 0.01, 0.045]
    psf[5, 0, 3:] = [0.04, -0.012, 0.07]
    psf[7, 0, 3:] = [0.05, 0.02, 0.05]
    return pars, psf


def _jax_chain(pars, psf):
    def reparam_of(p, pg):
        g0, _ = jcore.fill_exp(p)
        return pallas_lm.gmix_reparam(jcore.gmix_convolve(g0, pg))

    return np.asarray(jax.jit(jax.vmap(jax.jacfwd(reparam_of)))(pars, psf))


def _torch_ad_chain(pars, psf):
    return torch.func.vmap(torch.func.jacfwd(
        lambda p, pg: tbatch._exp_reparam(p, pg)[0]
    ))(torch.as_tensor(pars), torch.as_tensor(psf)).numpy()


@pytest.mark.parametrize("oracle", ["torch_ad", "jax_jacfwd"])
def test_exp_chain_matches_ad(oracle):
    pars, psf = _chain_inputs()
    ref = (_torch_ad_chain if oracle == "torch_ad" else _jax_chain)(pars, psf)
    out = tbatch.exp_chain(torch.as_tensor(pars), torch.as_tensor(psf)).numpy()
    assert out.shape == ref.shape == (NB, 6, 6, 6)
    scale = np.abs(ref).reshape(NB, -1).max(-1)[:, None, None, None]
    err = np.abs(out - ref)
    assert np.all(err <= 1e-12 * np.abs(ref) + 1e-12 * scale), (
        np.unravel_index(np.argmax(err / (np.abs(ref) + scale)), err.shape),
        float(np.max(err / (np.abs(ref) + scale))))
    # the structure the kernel relies on: row and col pass through, flux
    # reaches N only
    np.testing.assert_array_equal(out[:, :, 1, 0], 1.0)
    np.testing.assert_array_equal(out[:, :, 2, 1], 1.0)
    assert np.all(out[:, :, 1:, 5] == 0) and np.all(out[:, :, 3:, :2] == 0)
    # the negative-T lane holds invalid gaussians, whose N and F are fixed
    rp = tbatch._exp_reparam(torch.as_tensor(pars), torch.as_tensor(psf))[0].numpy()
    invalid = rp[6, :, 0] == 0
    assert invalid.any() and not invalid.all()
    assert np.all(out[6, invalid][:, [0, 3, 4, 5]] == 0)


# ----------------------------------------------------------------------
# the solve

@pytest.fixture(scope="module")
def solve_inputs():
    """eight noisy 19x19 exp stamps (one with masked pixels), their K1
    planes, round psf moments [NB, 3] and guesses near the truth"""
    jpix, tpix, sig, pars = _pixel_batch(nb=NB, dims=(19, 19), seed=31)
    psf = np.tile([sig**2, 0.0, sig**2], (NB, 1))
    planes = tuple(x.contiguous() for x in tbatch._lm_planes(tpix))
    nres = torch.sum(tpix.ierr > 0, dim=-1)
    return jpix, planes, psf, pars, nres


@pytest.fixture(scope="module")
def jax_solve(solve_inputs):
    """the JAX K1 route's solve, compiled once for both bounds"""
    jpix, _, psf, pars, nres = solve_inputs
    psf_gmix = tbatch._psf_gmix(torch.as_tensor(psf)).numpy()

    def normal_fn(x, data):
        planes, pg = data
        return jbatch._exp_normal_fn(x, planes, pg, interpret=True)

    run = jax.jit(lambda lo, hi: jlm.run_lm_normal_batched(
        normal_fn, (jbatch._lm_planes(jpix), jnp.asarray(psf_gmix)),
        jnp.asarray(pars), lo, hi, jlm.LMConf(), nres=jnp.asarray(nres.numpy()),
    ))
    return functools.lru_cache(maxsize=None)(
        lambda case: jax.tree.map(np.asarray, run(*BOUNDS[case]))
    )


def _plain(solve_inputs, case, **kw):
    _, planes, psf, pars, nres = solve_inputs
    lo, hi = (torch.as_tensor(a) for a in BOUNDS[case])
    conf = tlm.LMConf(**kw)
    state = lm_solve.lm_solve(torch.as_tensor(pars), lo, hi, torch.as_tensor(psf),
                              *planes, conf)
    return state, tlm._normal_epilogue(state, lo, hi, conf, nres)


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_plain_matches_jax_k1_route(solve_inputs, jax_solve, case):
    state, out = _plain(solve_inputs, case)
    ref = jax_solve(case)
    np.testing.assert_array_equal(out["flags"].numpy(), ref["flags"])
    assert np.all(out["flags"].numpy() == 0)
    for k, col in (("e1", 2), ("e2", 3), ("T", 4), ("flux", 5)):
        np.testing.assert_allclose(out["pars"][:, col].numpy(), ref["pars"][:, col],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert np.all(np.abs(out["nfev"].numpy().astype(int) - ref["nfev"].astype(int)) <= 2)
    # the bounded case runs the pinned-dims path
    assert bool(state["pinned"].any()) == (case == "bounded")


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_plain_is_the_host_loop_bitwise(solve_inputs, case):
    """K3's plain version is the host loop without compaction over the
    exp normal equations: the compacted host loop gives the same bits"""
    _, planes, psf, pars, _ = solve_inputs
    state, _ = _plain(solve_inputs, case)
    lo, hi = (torch.as_tensor(a) for a in BOUNDS[case])
    host = tlm.run_lm_normal_state(
        tbatch._normal_fn, (planes, tbatch._psf_gmix(torch.as_tensor(psf))),
        torch.as_tensor(pars), lo, hi, tlm.LMConf(), compact_capacity=(6, 3),
    )
    assert set(host) == set(state)
    for k in state:
        torch.testing.assert_close(state[k], host[k], rtol=0, atol=0, msg=k)


def test_plain_maxfev_one_is_the_first_evaluation(solve_inputs):
    state, _ = _plain(solve_inputs, "unbounded", maxfev=1)
    _, planes, psf, pars, _ = solve_inputs
    cost, Jtr, JtJ = tbatch._exp_normal_fn(
        torch.as_tensor(pars), planes, tbatch._psf_gmix(torch.as_tensor(psf)))
    assert torch.all(state["nfev"] == 1) and not bool(state["done"].any())
    torch.testing.assert_close(state["y"], torch.as_tensor(pars), rtol=0, atol=0)
    for a, b in ((state["cost"], cost), (state["Jtr"], Jtr), (state["JtJ"], JtJ)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_measure_routes(solve_inputs, monkeypatch):
    """_exp_lm_measure calls K3 once by default, and never on the host
    loop"""
    _, tpix, sig, _ = _pixel_batch(nb=2, dims=(19, 19), seed=32)
    calls = []
    solve = lm_solve.lm_solve

    def spy(*a):
        calls.append(a[0].shape)
        return solve(*a)

    monkeypatch.setattr(lm_solve, "lm_solve", spy)
    k3 = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf())
    assert calls == [(2, 6)]
    host = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), host_loop=True)
    assert len(calls) == 1
    for k in ("pars", "flags", "nfev", "s2n"):
        torch.testing.assert_close(k3[k], host[k], rtol=0, atol=0, msg=k)


# ----------------------------------------------------------------------
# the wrapper on a mocked card

class _FakeCuda(torch.Tensor):
    """a CPU tensor that reports a CUDA device"""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, torch.as_tensor(x).contiguous())


def _mock_card(monkeypatch, ret):
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return ret

    lib = types.SimpleNamespace(**{lm_solve.c_name(k, m, dt): fake_kernel
                                   for k in ("lm_solve", "lm_solve_opt")
                                   for m in lm_solve.MODELS
                                   for dt in (torch.float32, torch.float64)})
    monkeypatch.setattr(_build, "load", lambda: lib)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(lm_solve, "lm_solve_plain", no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=4321))

    @contextlib.contextmanager
    def current_device(dev):
        calls.append(("device", dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", current_device)
    monkeypatch.setattr(lm_solve, "launches", 0)
    return calls


def _small_args(B=3, P=50, dtype=torch.float64):
    rng = np.random.RandomState(3)
    guess = rng.normal(size=(B, 6))
    lo, hi = BOUNDS["bounded"]
    psf = np.tile([0.05, 0.0, 0.05], (B, 1))
    planes = [rng.normal(size=(B, P)) for _ in range(4)]
    return [torch.as_tensor(x, dtype=dtype) for x in [guess, lo, hi, psf] + planes]


def test_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    calls = _mock_card(monkeypatch, 0)
    args = [_fake_cuda(x) for x in _small_args()]
    conf = tlm.LMConf(maxfev=77, ftol=2e-5)
    out = lm_solve.lm_solve(*args, conf)
    assert lm_solve.launches == 1
    (_, dev), c = calls
    assert dev == args[0].device
    assert c[:8] == tuple(x.data_ptr() for x in args)
    assert c[8:19] == tuple(x.data_ptr() for x in out.values())
    # no prior: a null table of 0 rows
    assert c[20:] == (None, 3, 50, 0, 77, 2e-5, conf.xtol, conf.lambda0, conf.lambda_up,
                      conf.lambda_down, conf.lambda_min, conf.lambda_max, 4321)
    assert list(out) == ["y", "cost", "cost_pix", "Jtr", "JtJ", "lam", "nfev", "done",
                         "ier_small_step", "ier_small_cost", "pinned"]
    assert [tuple(x.shape) for x in out.values()] == [
        (3, 6), (3,), (3,), (3, 6), (3, 6, 6), (3,), (3,), (3,), (3,), (3,), (3, 6)]
    assert out["nfev"].dtype == torch.int32 and out["pinned"].dtype == torch.bool


def test_cuda_launch_error_raises(monkeypatch):
    _mock_card(monkeypatch, 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        lm_solve.lm_solve(*(_fake_cuda(x) for x in _small_args()), tlm.LMConf())
    assert lm_solve.launches == 0


def test_bad_inputs_raise():
    guess, lo, hi, psf, v, u, ia, ve = _small_args()
    conf = tlm.LMConf()
    with pytest.raises(ValueError, match="6-parameter"):
        lm_solve.lm_solve(torch.cat([guess, guess[:, :1]], 1), lo, hi, psf,
                          v, u, ia, ve, conf)
    with pytest.raises(ValueError, match="one psf gaussian"):
        lm_solve.lm_solve(guess, lo, hi, tbatch._psf_gmix(psf), v, u, ia, ve, conf)
    with pytest.raises(ValueError, match="lo and hi"):
        lm_solve.lm_solve(guess, lo[:5], hi, psf, v, u, ia, ve, conf)
    with pytest.raises(ValueError, match="must be"):
        lm_solve.lm_solve(guess, lo, hi, psf, v, u[:, :10], ia, ve, conf)
    empty = torch.zeros((3, 0), dtype=guess.dtype)
    with pytest.raises(ValueError, match="pixels"):
        lm_solve.lm_solve(guess, lo, hi, psf, empty, empty, empty, empty, conf)
    with pytest.raises(ValueError, match="hold the models"):
        lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf, "turb")
    with pytest.raises(TypeError):
        lm_solve.lm_solve(guess, lo, hi, psf, v.float(), u, ia, ve, conf)
    with pytest.raises(TypeError, match="float32 or float64"):
        lm_solve.lm_solve(*(x.half() for x in (guess, lo, hi, psf, v, u, ia, ve)), conf)
    with pytest.raises(ValueError, match="contiguous"):
        lm_solve.lm_solve(guess, lo, hi, psf, *(x.t().contiguous().t()
                                                for x in (v, u, ia, ve)), conf)
    with pytest.raises(ValueError, match="maxfev"):
        lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, tlm.LMConf(maxfev=0))
    # the LMConf options do not change K3's solve; its modes are arguments
    a = lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, tlm.LMConf(varpro=True,
                                                                      flux_col=True))
    b = lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf)
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match="two modes"):
        lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf, refine=2, varpro=True)
    with pytest.raises(ValueError, match="refine"):
        lm_solve.lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf, refine=-1)
    with pytest.raises(ValueError, match="unbounded flux"):
        lm_solve.lm_solve(guess, lo, torch.cat([hi[:-1], hi.new_ones(1)]), psf, v, u, ia, ve,
                          conf, varpro=True)
    with pytest.raises(RuntimeError):
        lm_solve.lm_solve(*(x.to("meta") for x in (guess, lo, hi, psf, v, u, ia, ve)),
                          conf)


def test_build_compiles_lm_solve():
    assert "lm_solve.cu" in {s.name for s in _build.sources()}
    compiles, _ = _build.nvcc_commands("out.so")
    assert any(c.endswith("lm_solve.cu") for cmd in compiles for c in cmd)
