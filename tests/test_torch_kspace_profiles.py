"""The port's Spergel and Moffat k-space profiles against ngmix_tpu's:
the Spergel c_nu and Moffat tables (built by the port at first use) at
rtol 1e-12, and KSpaceSpergelFitter and KSpaceMoffatFitter against the
JAX fitters on the same k observations (flags equal, pars and pars_err
to rtol 1e-5, nfev within 2). A file of their own: each JAX fit
compiles its own closure, which the gaussian fitters' file has no room
for.
"""
import numpy as np
import pytest
import torch

from ngmix_tpu.fitting import kspace_fitters as jk

from ngmix_tpu_torch.fitting import kspace_fitters as tk

from test_torch_kspace import check_fit_against_jax

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

FITS = {
    "spergel": (jk.KSpaceSpergelFitter, tk.KSpaceSpergelFitter, dict(g1=0.02, g2=0.0),
                [0.0, 0.0, 0.0, 0.0, 0.45, 0.8, 90.0]),
    "moffat": (jk.KSpaceMoffatFitter, tk.KSpaceMoffatFitter,
               dict(with_psf=False, model="turb", T=0.4), [0.0, 0.0, 0.0, 0.0, 0.4, 3.0, 90.0]),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_kspace_profile_fitter_matches_jax(name):
    jfitter, tfitter, kw, guess = FITS[name]
    check_fit_against_jax(jfitter(), tfitter(), kw, guess)


def test_tables_match_jax():
    """the Spergel c_nu and Moffat tables, built at first use, at rtol
    1e-12; the dev r50 factor"""
    np.testing.assert_array_equal(tk._SPERGEL_NUS, jk._SPERGEL_NUS)
    np.testing.assert_allclose(tk._SPERGEL_CS, jk._SPERGEL_CS, rtol=1e-12)
    np.testing.assert_array_equal(tk._MOFFAT_BETAS, jk._MOFFAT_BETAS)
    np.testing.assert_array_equal(tk._MOFFAT_LOGX, jk._MOFFAT_LOGX)
    np.testing.assert_allclose(tk._MOFFAT_TAB, jk._MOFFAT_TAB, rtol=1e-12, atol=0)
    assert tk._DEV_R50_FAC == jk._DEV_R50_FAC
    x = torch.tensor([0.0, 1e-5, 0.01, 0.1, 1.0, 10.0, 400.0], dtype=torch.float64)
    np.testing.assert_allclose(tk._moffat_kprofile(x, torch.tensor(3.3, dtype=torch.float64)),
                               np.asarray(jk._moffat_kprofile(x.numpy(), 3.3)), rtol=1e-12)
    with pytest.raises(AttributeError):
        tk._NO_SUCH_TABLE
