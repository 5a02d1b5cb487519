"""K1 of the PyTorch port (ngmix_tpu_torch/ops/normal_eqs.py) and the
exp model's normal equations (batch._exp_normal_fn) against the JAX
package, on the same numpy inputs.

Tolerances, from tests/test_pallas_lm.py:65-73: cost to rtol 1e-10, Jtr
and JtJ to rtol 1e-8 with an atol of 1e-8 times the largest |value|, in
float64. In float32 the port's plain version is held against the
float64 reference on the same (float32) inputs: cost to rtol 1e-5, Jtr
and JtJ to rtol 1e-5 with an atol of 1e-5 times their Cauchy-Schwarz
scale, sqrt(JtJ_kk cost) for Jtr_k and sqrt(JtJ_kk JtJ_mm) for JtJ_km,
which bounds the sum of the absolute terms that float32 rounds (the
signed sums cancel); chip_smoke.py holds the kernel to the same.

The TPU kernel in interpret mode is compiled once per n, on planes of
1152 pixels (1089 rounded up to a multiple of 128, as its own padding
does): the P = 361 and P = 1089 cases hand it the same planes with
ia = ve = 0 beyond the first P pixels, which contribute exactly
nothing. The CUDA kernel itself runs
only on the card (chip_smoke.py); here the wrapper's dispatch is
checked with a mocked CUDA tensor and library.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.ops import pallas_lm
from ngmix_tpu.pixels import Pixels as JPixels

from ngmix_tpu_torch import batch as tbatch
from ngmix_tpu_torch.gmix import core as tcore
from ngmix_tpu_torch.ops import _build, normal_eqs
from ngmix_tpu_torch.pixels import Pixels

B = 4
P_FULL = 1089
P_PAD = 1152
SCALE = 0.263


def _mixtures(n, seed):
    """[B, n, 6] mixtures with spread sizes and shapes; lane 1 holds a
    gaussian with det <= 0 and T <= 0"""
    rng = np.random.RandomState(seed)
    T = rng.uniform(0.05, 3.0, (B, n))
    e1 = rng.uniform(-0.4, 0.4, (B, n))
    e2 = rng.uniform(-0.4, 0.4, (B, n))
    gm = np.stack(
        [rng.uniform(0.1, 2.0, (B, n)), rng.uniform(-0.5, 0.5, (B, n)),
         rng.uniform(-0.5, 0.5, (B, n)), 0.5 * T * (1 - e1), 0.5 * T * e2,
         0.5 * T * (1 + e1)], axis=-1,
    )
    gm[1, 0, 3:] = (-0.5, 0.6, -0.5)
    return gm


def _case(n, seed=5):
    """rp, chain and the four planes at P_FULL pixels"""
    rng = np.random.RandomState(seed + n)
    rp = np.asarray(pallas_lm.gmix_reparam(jnp.asarray(_mixtures(n, seed + n))))
    chain = rng.normal(size=(B, n, 6, 6))
    v, u = (rng.uniform(-3.0, 3.0, (B, P_FULL)) for _ in range(2))
    ia = rng.uniform(50.0, 150.0, (B, P_FULL))
    ve = rng.normal(0.0, 20.0, (B, P_FULL))
    return rp, chain, v, u, ia, ve


@pytest.fixture(scope="module", params=[1, 6, 10], ids=lambda n: "n%d" % n)
def case(request):
    """(n, inputs at P_FULL, the TPU kernel's outputs for P in {361,
    1089}) on float64 inputs and on the same inputs rounded to float32"""
    n = request.param
    inputs = {"float64": _case(n)}
    inputs["float32"] = tuple(x.astype(np.float32).astype(np.float64)
                              for x in inputs["float64"])
    refs = {}
    for dt, (rp, chain, v, u, ia, ve) in inputs.items():
        for P in (361, P_FULL):
            v_p, u_p, ia_p, ve_p = (
                np.pad(x[:, :P], ((0, 0), (0, P_PAD - P))) for x in (v, u, ia, ve)
            )
            out = pallas_lm.gmix_normal_eqs_pallas(
                *map(jnp.asarray, (rp, chain, v_p, u_p, ia_p, ve_p)), interpret=True,
            )
            refs[dt, P] = [np.asarray(x) for x in out]
    return n, inputs, refs


def _check_normal(out, ref, float32=False):
    (cost, Jtr, JtJ), (rcost, rJtr, rJtJ) = out, ref
    for x in (cost, Jtr, JtJ):
        assert np.all(np.isfinite(x))
    if not float32:
        np.testing.assert_allclose(cost, rcost, rtol=1e-10)
        for a, b in ((Jtr, rJtr), (JtJ, rJtJ)):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.max(np.abs(b)))
        return
    np.testing.assert_allclose(cost, rcost, rtol=1e-5)
    d = np.clip(np.diagonal(rJtJ, axis1=-2, axis2=-1), 0.0, None)
    scales = (np.sqrt(d * rcost[:, None]), np.sqrt(d[:, :, None] * d[:, None, :]))
    for a, b, scale in ((Jtr, rJtr, scales[0]), (JtJ, rJtJ, scales[1])):
        assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-5 * scale)


@pytest.mark.parametrize("P", [361, P_FULL])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_tpu_kernel(case, P, dtype):
    n, inputs, refs = case
    rp, chain, v, u, ia, ve = (
        torch.tensor(x, dtype=getattr(torch, dtype)) for x in inputs[dtype]
    )
    out = normal_eqs.gmix_normal_eqs(
        rp, chain, *(x[:, :P].contiguous() for x in (v, u, ia, ve))
    )
    assert [tuple(x.shape) for x in out] == [(B,), (B, 6), (B, 6, 6)]
    assert all(x.dtype == rp.dtype for x in out)
    _check_normal([x.double().numpy() for x in out], refs[dtype, P],
                  float32=dtype == "float32")
    np.testing.assert_array_equal(out[2].numpy(), out[2].transpose(1, 2).numpy())


def test_reparam_matches_jax():
    gm = _mixtures(6, 3)
    gm[2, 3, 3:] = (0.2, 0.3, 0.2)  # det < 0 with T > 0
    gm[3, 1, 3:] = (0.0, 0.0, 0.0)  # det = 0 and T = 0
    ref = np.asarray(pallas_lm.gmix_reparam(jnp.asarray(gm)))
    out = normal_eqs.gmix_reparam(torch.as_tensor(gm)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    # the invalid gaussians: unit inverse covariance, zero amplitude
    for b, g in ((1, 0), (2, 3), (3, 1)):
        np.testing.assert_array_equal(out[b, g, [0, 3, 4, 5]], [0.0, 1.0, 0.0, 1.0])


# ----------------------------------------------------------------------
# the exp model's normal equations

def _psf_gmix(nb, sig):
    psf = np.zeros((nb, 1, 6))
    psf[:, 0, 0] = 1.0
    psf[:, 0, 3] = psf[:, 0, 5] = sig**2
    return psf


def _pixel_batch(nb=B, dims=(33, 33), noise=1e-3, seed=19):
    """exp galaxies convolved with a round gaussian psf of sigma sig on
    33x33 stamps (P = 1089), with noise, all drawn from numpy. Returns
    the JAX and the port's Pixels, sig and trial pars [nb, 6] near the
    truth"""
    rng = np.random.RandomState(seed)
    z = np.zeros(nb)
    truth = np.stack([z, z, rng.uniform(-0.2, 0.2, nb), rng.uniform(-0.2, 0.2, nb),
                      rng.uniform(0.3, 0.8, nb), rng.uniform(50, 150, nb)], -1)
    sig = 0.9 * SCALE
    psf = _psf_gmix(nb, sig)
    cen = (np.array(dims) - 1) / 2.0 + rng.uniform(-0.5, 0.5, (nb, 2))
    rr, cc = np.meshgrid(np.arange(dims[0]), np.arange(dims[1]), indexing="ij")
    v = (rr.reshape(-1)[None] - cen[:, :1]) * SCALE
    u = (cc.reshape(-1)[None] - cen[:, 1:]) * SCALE
    area = np.full(v.shape, SCALE**2)
    # rendered with the port's mixture algebra (held against the JAX
    # package's in test_torch_gmix_core.py), which is quick to start
    gal, _ = tcore.fill_exp(torch.as_tensor(truth))
    conv = tcore.gmix_convolve(gal, torch.as_tensor(psf))
    val = tcore.eval_gmix(conv, torch.as_tensor(v), torch.as_tensor(u), SCALE**2,
                          fast=False).numpy()
    val = val + rng.normal(0.0, noise, val.shape)
    ierr = np.full(v.shape, 1.0 / noise)
    ierr[0, :40] = 0.0  # masked pixels
    fields = (v, u, area, val, ierr)
    pars = truth + rng.normal(0.0, 1.0, truth.shape) * [0.05, 0.05, 0.05, 0.05, 0.05, 5.0]
    return JPixels(*map(jnp.asarray, fields)), Pixels(*map(torch.as_tensor, fields)), sig, pars


@pytest.fixture(scope="module")
def exp_case():
    jpix, tpix, sig, pars = _pixel_batch()
    psf = _psf_gmix(B, sig)

    def one(p, px, pg):
        r, jvp = jax.linearize(lambda q: jbatch._exp_lm_fdiff(q, (px, pg)), p)
        J = jax.vmap(jvp, in_axes=0, out_axes=1)(jnp.eye(6, dtype=p.dtype))
        return jnp.sum(r * r), J.T @ r, J.T @ J

    @jax.jit
    def both(p, px, pg):
        kernel = jbatch._exp_normal_fn(p, jbatch._lm_planes(px), pg, interpret=True)
        return kernel, jax.vmap(one)(p, px, pg)

    kernel, ad = both(jnp.asarray(pars), jpix, jnp.asarray(psf))
    port = tbatch._exp_normal_fn(
        torch.as_tensor(pars), tbatch._lm_planes(tpix), torch.as_tensor(psf)
    )
    return ([np.asarray(x) for x in kernel], [np.asarray(x) for x in ad],
            [x.numpy() for x in port])


def test_exp_normal_fn_matches_jax_kernel_route(exp_case):
    kernel, _, port = exp_case
    _check_normal(port, kernel)


def test_exp_normal_fn_matches_ad_reductions(exp_case):
    _, ad, port = exp_case
    _check_normal(port, ad)


def test_exp_normal_fn_bad_pars_sentinel():
    """|g| >= 1 gives the huge-cost sentinel with Jtr = 0 and JtJ = I,
    as fdiff = 1e10 does in the AD route"""
    _, tpix, sig, _ = _pixel_batch(nb=2)
    psf = _psf_gmix(2, sig)
    pars = torch.tensor([[0.0, 0.0, 0.99, 0.99, 0.5, 100.0],
                         [0.0, 0.0, 0.0, 0.0, 0.5, 100.0]], dtype=torch.float64)
    cost, Jtr, JtJ = tbatch._exp_normal_fn(pars, tbatch._lm_planes(tpix),
                                           torch.as_tensor(psf))
    assert float(cost[0]) >= 1e29
    assert torch.all(Jtr[0] == 0)
    torch.testing.assert_close(JtJ[0], torch.eye(6, dtype=torch.float64), rtol=0, atol=0)
    assert torch.isfinite(cost[1]) and float(cost[1]) < 1e29


def test_exp_chain_keeps_float32():
    """float32 pars give K1 a float32 chain (no float64 promotion in
    the forward-mode jacobian), equal to the float64 chain to float32
    rounding, and float32 reductions"""
    _, tpix, sig, pars = _pixel_batch(nb=2)
    psf = torch.as_tensor(_psf_gmix(2, sig))
    jac = torch.func.vmap(torch.func.jacfwd(tbatch._reparam_of, has_aux=True))
    chain64, _ = jac(torch.as_tensor(pars), psf)
    chain32, (rp32, _, _) = jac(torch.as_tensor(pars).float(), psf.float())
    assert chain32.dtype == rp32.dtype == torch.float32
    torch.testing.assert_close(chain32.double(), chain64, rtol=1e-5,
                               atol=1e-5 * float(chain64.abs().max()))
    planes = tuple(x.float() for x in tbatch._lm_planes(tpix))
    out = tbatch._exp_normal_fn(torch.as_tensor(pars).float(), planes, psf.float())
    assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all()) for x in out)


# ----------------------------------------------------------------------
# the wrapper on a mocked card

class _FakeCuda(torch.Tensor):
    """a CPU tensor that reports a CUDA device"""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, torch.as_tensor(x))


def _mock_card(monkeypatch, ret):
    """a fake kernel library that records its calls, and a plain
    version that must not be taken"""
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return ret

    lib = types.SimpleNamespace(
        ngmix_normal_eqs_f32=fake_kernel, ngmix_normal_eqs_f64=fake_kernel
    )
    monkeypatch.setattr(_build, "load", lambda: lib)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(normal_eqs, "gmix_normal_eqs_plain", no_plain)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda d=None: types.SimpleNamespace(cuda_stream=4321),
    )

    @contextlib.contextmanager
    def current_device(dev):
        calls.append(("device", dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", current_device)
    return calls


def _small(n=6, P=50):
    rp, chain, v, u, ia, ve = _case(n)
    return [_fake_cuda(np.ascontiguousarray(x[..., :P]) if x.ndim == 2 else x)
            for x in (rp, chain, v, u, ia, ve)]


def test_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    calls = _mock_card(monkeypatch, 0)
    rp, chain, v, u, ia, ve = _small()
    monkeypatch.setattr(normal_eqs, "launches", 0)
    cost, Jtr, JtJ = normal_eqs.gmix_normal_eqs(rp, chain, v, u, ia, ve)
    assert normal_eqs.launches == 1
    (_, dev), args = calls
    assert dev == rp.device
    ptrs, (Bk, n, P, stream) = args[:9], args[9:]
    assert ptrs == tuple(x.data_ptr() for x in (rp, chain, v, u, ia, ve, cost, Jtr, JtJ))
    assert (Bk, n, P, stream) == (B, 6, 50, 4321)
    assert [tuple(x.shape) for x in (cost, Jtr, JtJ)] == [(B,), (B, 6), (B, 6, 6)]


def test_cuda_launch_error_raises(monkeypatch):
    _mock_card(monkeypatch, 700)
    monkeypatch.setattr(normal_eqs, "launches", 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        normal_eqs.gmix_normal_eqs(*_small())
    assert normal_eqs.launches == 0


def test_bad_inputs_raise():
    rp, chain, v, u, ia, ve = (torch.as_tensor(x) for x in _case(6))
    with pytest.raises(ValueError, match="chain"):
        normal_eqs.gmix_normal_eqs(rp, chain[..., :5], v, u, ia, ve)
    with pytest.raises(ValueError, match="must be"):
        normal_eqs.gmix_normal_eqs(rp, chain, v, u[:, :10], ia, ve)
    with pytest.raises(TypeError):
        normal_eqs.gmix_normal_eqs(rp, chain, v.float(), u, ia, ve)
    with pytest.raises(ValueError, match="contiguous"):
        normal_eqs.gmix_normal_eqs(rp, chain, v[:, ::2], u[:, ::2], ia[:, ::2], ve[:, ::2])
    with pytest.raises(RuntimeError):
        normal_eqs.gmix_normal_eqs(*(x.to("meta") for x in (rp, chain, v, u, ia, ve)))
