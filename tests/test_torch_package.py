"""Rules of the PyTorch port's package: no JAX inside it or in
chip_smoke.py (every module of the package is scanned), the kernel
build command, the ignored build directory,
constants and tables equal to the JAX package's, and the package's
surface: every submodule the JAX package's __init__ imports that the
port has, and __version__."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import ngmix_tpu
from ngmix_tpu import defaults as jdefaults, flags as jflags
from ngmix_tpu.gmix import tables as jtables
from ngmix_tpu.metacal import defaults as jmdefaults

import ngmix_tpu_torch
from ngmix_tpu_torch import defaults, flags
from ngmix_tpu_torch.gmix import tables
from ngmix_tpu_torch.metacal import defaults as mdefaults
from ngmix_tpu_torch.ops import _build

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

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
    compiles, links = _build.nvcc_commands("out")
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and "-O3" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    srcs = [Path(c) for cmd in compiles for c in cmd if c.endswith((".cu", ".cuh", ".cpp"))]
    # one compile a source, every kernel's source among them, and one
    # link a source of its object into its own library in the directory
    assert len(srcs) == len(compiles) == len(links) == len(_build.sources())
    assert {s.name for s in srcs} >= {"gmix_eval.cu", "normal_eqs.cu"}, compiles
    for cmd, link, src in zip(compiles, links, srcs):
        assert "-shared" in link and link[link.index("-o") + 1] == "out/%s.so" % src.stem
        assert link[link.index("-o") + 2:] == [cmd[cmd.index("-o") + 1]]
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
    for name in ("FASTEXP_MAX_CHI2", "FASTEXP_APOD_CHI2", "GMIX_LOW_DETVAL", "PDEF", "CDEF",
                 "LOWVAL"):
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


def _init_submodules(path):
    """the submodules a package __init__ imports at its top level (the
    first name of each relative import)"""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            if node.module is None:
                names.update(a.name for a in node.names)
            else:
                names.add(node.module.split(".")[0])
    return names


def test_package_imports_the_reference_submodules_it_has():
    names = _init_submodules(ROOT / "ngmix_tpu" / "__init__.py")
    have = sorted(n for n in names if (PKG / (n + ".py")).exists()
                  or (PKG / n / "__init__.py").exists())
    assert {"checkpoint", "parallel", "ragged", "guessers", "runners", "fitting", "defaults",
            "flags"} <= set(have)
    missing = [n for n in have if not hasattr(ngmix_tpu_torch, n)]
    assert not missing, missing
    assert ngmix_tpu_torch.__version__ == ngmix_tpu.__version__


# the JAX package's public names with no counterpart in the port, each
# with its reason (names that start with "_", such as batch.py's AD,
# chunking and quarantine helpers, are private and not compared)
NO_COUNTERPART = {
    "run_lm_jit": "the JAX compile cache of run_lm; the port runs run_lm eagerly and "
                  "replays its steps as CUDA graphs on the card",
    "gaussmom_measure_jit": "a JAX compile cache",
    "get_gaussap_flux_jit": "a JAX compile cache",
    "set_fft_matmul": "a TPU speed toggle (DFT matmuls on the MXU); the port's FFTs are "
                      "torch.fft",
    "match_vma": "JAX's shard_map varying-axes types",
    "make_mesh": "a JAX device mesh; the port runs one process a GPU over "
                 "torch.distributed",
    "DEFAULT_DTYPE": "JAX's default float dtype; the port keeps each call's dtype",
    "pallas_gmix": "K2's Pallas module, ported as ops/gmix_eval.py (csrc/gmix_eval.cu)",
    "pallas_lm": "K1's Pallas module, ported as ops/normal_eqs.py (csrc/normal_eqs.cu)",
}
REF = ROOT / "ngmix_tpu"


def _public_names(path):
    """the public names a module defines at its top level (functions,
    classes, assignments) and, for an __init__, the names it imports
    from its package"""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and node.level >= 1):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")))
def test_every_reference_name_has_a_counterpart(rel):
    """each module of the JAX package has its counterpart in the port,
    with every public name it defines or its __init__ exports, except
    the names of NO_COUNTERPART"""
    import importlib

    path = Path(rel)
    if path.stem in NO_COUNTERPART:
        assert not (PKG / path).exists(), rel
        return
    parts = path.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mod = importlib.import_module(".".join(("ngmix_tpu_torch",) + parts))
    missing = sorted(n for n in _public_names(REF / path)
                     if n not in NO_COUNTERPART and not hasattr(mod, n))
    assert not missing, (rel, missing)
