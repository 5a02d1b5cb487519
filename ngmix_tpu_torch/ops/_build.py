"""Build the package's CUDA sources into one shared library, at first use.

One ``nvcc`` call compiles every ``csrc/*.cu`` for Hopper (sm_90a)
into a shared library with a plain C interface: no PyTorch headers and
no ninja, so the build takes seconds. The library is named by a hash
of the sources and the command, lives in ``build/ngmix_tpu_torch/`` at
the root of the checkout, and is loaded with ctypes.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngmix_tpu_torch"
BUILD_TIMEOUT_S = 120

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def nvcc_command(out, nvcc="nvcc"):
    """the nvcc command that builds every source into ``out``"""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("libngmix_tpu_torch_%s.so" % h.hexdigest()[:16])


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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = nvcc_command(tmp, nvcc=find_nvcc())
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
            )
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(
                "nvcc did not finish in %d s: %s\n%s"
                % (BUILD_TIMEOUT_S, " ".join(cmd), exc.stderr or "")
            ) from exc
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (%d): %s\n%s%s"
                % (proc.returncode, " ".join(cmd), proc.stdout, proc.stderr)
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
        for name in ("ngmix_lm_solve_attrs_f32", "ngmix_lm_solve_attrs_f64"):
            fn = getattr(lib, name)
            # P, out[4] as for K2
            fn.argtypes = [i64, ip]
            fn.restype = ctypes.c_int
        for name in ("ngmix_normal_eqs_f32", "ngmix_normal_eqs_f64"):
            fn = getattr(lib, name)
            # rp, chain, v, u, ia, ve, cost, jtr, jtj, B, n, P, stream
            fn.argtypes = [p] * 9 + [i64, i64, i64, p]
            fn.restype = ctypes.c_int
        for name in ("ngmix_lm_solve_f32", "ngmix_lm_solve_f64"):
            fn = getattr(lib, name)
            # guess, lo, hi, psf, v, u, ia, ve, y, cost, jtr, jtj, lam,
            # nfev, done, ier_small_step, ier_small_cost, pinned, counter,
            # B, P, maxfev, ftol, xtol, lambda0, lambda_up, lambda_down,
            # lambda_min, lambda_max, stream
            fn.argtypes = [p] * 19 + [i64] * 3 + [ctypes.c_double] * 7 + [p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
