"""Rules of the PyTorch port's package: no JAX inside it or in
chip_smoke.py (every module of the package is scanned), the kernel
build command, the ignored build directory,
and constants and tables equal to the JAX package's."""
import ast
from pathlib import Path

import numpy as np
import pytest

from ngmix_tpu import defaults as jdefaults, flags as jflags
from ngmix_tpu.gmix import tables as jtables
from ngmix_tpu.metacal import defaults as jmdefaults

from ngmix_tpu_torch import defaults, flags
from ngmix_tpu_torch.gmix import tables
from ngmix_tpu_torch.metacal import defaults as mdefaults
from ngmix_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ngmix_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ngmix_tpu"), (path, mod)


def test_nvcc_command_targets_hopper_and_csrc_only():
    cmd = _build.nvcc_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    srcs = [Path(c) for c in cmd if c.endswith((".cu", ".cuh", ".cpp"))]
    # both kernels, K1 and K2, in the one call
    assert {s.name for s in srcs} >= {"gmix_eval.cu", "normal_eqs.cu"}, cmd
    for s in srcs:
        assert s.resolve().parent == PKG / "csrc", s
    # no PyTorch headers in the kernel sources
    for s in srcs:
        assert "torch" not in s.read_text()


def test_library_lands_in_ignored_build_dir():
    assert _build.library_path().parent == ROOT / "build" / "ngmix_tpu_torch"
    lines = (ROOT / ".gitignore").read_text().split()
    assert "build/" in lines


def test_constants_match_jax_package():
    for name in ("FASTEXP_MAX_CHI2", "FASTEXP_APOD_CHI2", "GMIX_LOW_DETVAL", "PDEF", "CDEF"):
        assert getattr(defaults, name) == getattr(jdefaults, name), name
    for name, val in vars(jflags).items():
        if name.isupper() and isinstance(val, int):
            assert getattr(flags, name) == val, name
    assert flags.NAME_MAP == jflags.NAME_MAP
    assert flags.get_flags_str(2**2 | 2**6) == jflags.get_flags_str(2**2 | 2**6)
    assert mdefaults.DEFAULT_STEP == jmdefaults.DEFAULT_STEP
    assert mdefaults.METACAL_TYPES == jmdefaults.METACAL_TYPES


def test_tables_match_jax_package():
    for name in ("PVALS_EXP", "FVALS_EXP", "PVALS_TURB", "FVALS_TURB"):
        np.testing.assert_array_equal(getattr(tables, name), getattr(jtables, name))
