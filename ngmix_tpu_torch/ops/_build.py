"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` is compiled for Hopper (sm_90a) by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface: no PyTorch headers and no
ninja, so the build takes as long as its slowest source. The library
is named by a hash of the sources, their headers and the flags, lives
in ``build/ngmix_tpu_torch/`` at the root of the checkout, and is
loaded with ctypes.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngmix_tpu_torch"
# the slowest sources, the float64 K3-mb units
# (csrc/lm_solve_mb_<model>_f64.cu, 6 instantiations each), take about
# a minute on an H100 host
BUILD_TIMEOUT_S = 300

# the models of K3 and K3-mb (ops/lm_solve.py), each with its own C
# functions
LM_MODELS = ("exp", "gauss", "dev", "bdf", "bd")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def find_nvcc():
    """nvcc from CUDA_HOME, else from PATH, else the default toolkit"""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_commands(out, nvcc="nvcc"):
    """the commands that build every source into ``out``: one compile a
    source into an object beside ``out`` (they run in parallel), and the
    link of the objects into the shared library"""
    objs = ["%s.%s.o" % (out, src.stem) for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources(), objs)]
    return compiles, [nvcc, "-shared", "-o", str(out), *objs]


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the sources and the headers they include
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("libngmix_tpu_torch_%s.so" % h.hexdigest()[:16])


def _run_all(cmds, deadline):
    """run the commands at once; raises with the first failure's output,
    or when the deadline (time.monotonic()) passes, stopping the rest"""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            try:
                out = proc.communicate(timeout=max(deadline - time.monotonic(), 0.0))[0]
            except subprocess.TimeoutExpired as exc:
                raise RuntimeError("nvcc did not finish in %d s: %s"
                                   % (BUILD_TIMEOUT_S, " ".join(cmd))) from exc
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed (%d): %s\n%s"
                                   % (proc.returncode, " ".join(cmd), out))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build():
    """compile the sources if their library is missing; returns its path.

    Writes to a temporary name and renames, so concurrent builders
    never load a half-written file. Raises with nvcc's output on
    failure or after BUILD_TIMEOUT_S seconds.
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp = os.path.join(tmpdir, path.name)
        compiles, link = nvcc_commands(tmp, nvcc=find_nvcc())
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        _run_all(compiles, deadline)
        _run_all([link], deadline)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return path


def load():
    """the loaded library, built first if needed, with every C
    function's argtypes and restype set"""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        ip = ctypes.POINTER(ctypes.c_int)
        for name in ("ngmix_gmix_eval_f32", "ngmix_gmix_eval_f64"):
            fn = getattr(lib, name)
            # gmix, v, u, area, area_scalar, out, B, n, P, fast, then the
            # launch plan: tile, head, ntiles, nfull, magic, shift, grid,
            # smem; stream
            fn.argtypes = [
                p, p, p, p, ctypes.c_double, p, i64, i64, i64,
                ctypes.c_int, *[i64] * 8, p,
            ]
            fn.restype = ctypes.c_int
        for name in ("ngmix_gmix_eval_attrs_f32", "ngmix_gmix_eval_attrs_f64"):
            fn = getattr(lib, name)
            # fast, n, smem, out[4]: registers, static and dynamic shared
            # memory, blocks an SM
            fn.argtypes = [ctypes.c_int, i64, i64, ip]
            fn.restype = ctypes.c_int
        lm_names = ["%s_%s" % (m, dt) for m in LM_MODELS for dt in ("f32", "f64")]
        for name in lm_names:
            fn = getattr(lib, "ngmix_lm_solve_%s_attrs" % name)
            # P, out[5]: K2's four values and local memory a thread
            fn.argtypes = [i64, ip]
            fn.restype = ctypes.c_int
        for name in ("ngmix_normal_eqs_f32", "ngmix_normal_eqs_f64"):
            fn = getattr(lib, name)
            # rp, chain, v, u, ia, ve, cost, jtr, jtj, B, n, P, stream
            fn.argtypes = [p] * 9 + [i64, i64, i64, p]
            fn.restype = ctypes.c_int
        for name in lm_names:
            fn = getattr(lib, "ngmix_lm_solve_" + name)
            # guess, lo, hi, psf, v, u, ia, ve, y, cost, cost_pix, jtr,
            # jtj, lam, nfev, done, ier_small_step, ier_small_cost, pinned,
            # counter, prior, B, P, nprior, maxfev, ftol, xtol, lambda0,
            # lambda_up, lambda_down, lambda_min, lambda_max, stream
            fn.argtypes = [p] * 21 + [i64] * 4 + [ctypes.c_double] * 7 + [p]
            fn.restype = ctypes.c_int
        for name in lm_names:
            fn = getattr(lib, "ngmix_lm_solve_mb_" + name)
            # guess, lo, hi, psf, band, v, u, ia, ve, y, cost, cost_pix,
            # jtr, jtj, lam, nfev, done, ier_small_step, ier_small_cost,
            # pinned, counter, prior, B, E, P, nband, nprior, maxfev, ftol,
            # xtol, lambda0, lambda_up, lambda_down, lambda_min,
            # lambda_max, stream
            fn.argtypes = [p] * 22 + [i64] * 6 + [ctypes.c_double] * 7 + [p]
            fn.restype = ctypes.c_int
        for name in lm_names:
            fn = getattr(lib, "ngmix_lm_solve_mb_%s_attrs" % name)
            # nband, E, P, out[5] as for K3
            fn.argtypes = [i64, i64, i64, ip]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
