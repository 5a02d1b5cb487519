"""Build the package's CUDA sources at first use, one shared library a
source, and load their C functions.

Every ``csrc/*.cu`` is compiled for Hopper (sm_90a) by its own ``nvcc``
process, one a core, and linked into a shared library of its own with a
plain C interface: no PyTorch headers and no ninja. The libraries of a
build live in ``build/ngmix_tpu_torch/<hash>/`` at the root of the
checkout (the hash covers the sources, their headers and the flags),
one ``<source>.so`` a source, and are loaded with ctypes.

``load()`` returns the library object the wrappers call: each C
function is looked up in its source's library when it is first used,
and waits for that source alone. ``start()`` begins a build in the
background (the sources in the order given, the others after them, the
costliest first by ``UNIT_CPU_SECONDS``), so that a caller can use the
first sources' kernels while nvcc compiles the rest; ``build()`` builds
every source and returns when all are done. A failed or late build
raises with nvcc's output.
"""
import atexit
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngmix_tpu_torch"
# the slowest sources take under 20 s of nvcc CPU on an H100 host; the
# limit leaves room for a loaded host
BUILD_TIMEOUT_S = 300

# the models of K3 and K3-mb (ops/lm_solve.py), each with its own C
# functions
LM_MODELS = ("exp", "gauss", "dev", "bdf", "bd")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# each unit's nvcc CPU seconds (user + system) on an H100 host
# (scripts/nvcc_stages.py, 254.9 s in all): the build starts the
# costliest first, one process a core, so that the longest units never
# wait behind short ones for a core. A unit not listed counts as the
# costliest.
UNIT_CPU_SECONDS = {
    "lm_solve.cu": 17.2, "lm_solve_mb_bd_f64.cu": 16.6, "lm_solve_mb_gauss_f64.cu": 15.6,
    "lm_solve_opt_bd.cu": 15.3, "lm_solve_mb_bdf_f64.cu": 15.2, "lm_solve_opt.cu": 15.1,
    "lm_solve_mb_exp_f64.cu": 14.9, "lm_solve_opt_dev.cu": 14.6, "lm_solve_mb_dev_f64.cu": 13.6,
    "lm_solve_mb_bd.cu": 13.6, "lm_solve_opt_bdf.cu": 12.7, "lm_solve_mb_exp.cu": 12.6,
    "lm_solve_mb_bdf.cu": 12.4, "lm_solve_mb_gauss.cu": 12.2, "lm_solve_opt_gauss.cu": 11.9,
    "lm_solve_mb_dev.cu": 11.1, "gmix_eval.cu": 10.0, "lm_solve_bd.cu": 9.0,
    "lm_solve_bdf.cu": 8.1, "normal_eqs.cu": 3.2,
}
# this process's build, where it made one: each unit's nvcc CPU seconds,
# set as each unit ends
UNIT_SECONDS = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def find_nvcc():
    """nvcc from CUDA_HOME, else from PATH, else the default toolkit"""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_commands(out, nvcc="nvcc"):
    """the commands that build every source into the directory ``out``:
    one compile a source into its object in ``out`` (they run in
    parallel), and one link a source of its object into
    ``out/<source>.so``, in the order of sources()"""
    out = Path(out)
    objs = [str(out / (src.stem + ".o")) for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources(), objs)]
    links = [[nvcc, "-shared", "-o", str(out / (src.stem + ".so")), obj]
             for src, obj in zip(sources(), objs)]
    return compiles, links


def library_path():
    """the directory of this checkout's libraries, named by a hash of the
    sources, the headers they include and the flags"""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("ngmix_tpu_torch_%s" % h.hexdigest()[:16])


_UNIT_OF = {}


def unit_of(name):
    """the source (its stem) whose library defines the C function name:
    the source that names it, or names it without its "_attrs" suffix
    (the macros that define the kernels' entry points add it)"""
    if not _UNIT_OF:
        for src in sources():
            for tok in re.findall(r"\bngmix_\w+", src.read_text()):
                _UNIT_OF.setdefault(tok, src.stem)
    for key in (name, name[:-len("_attrs")] if name.endswith("_attrs") else None):
        if key in _UNIT_OF:
            return _UNIT_OF[key]
    raise AttributeError("no source defines %s" % name)


def _slots():
    """the cores this process may run on"""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


class _Build(object):
    """one build of every source, in a thread: each source compiles in its
    own nvcc process, at most ``slots`` at a time in the given order of
    stems, and is linked into its library in a temporary directory as
    soon as its object exists; when all are done the directory becomes
    library_path(). ``open(stem)`` loads one source's library, waiting
    for it; ``wait()`` waits for all. Both raise the build's error"""

    def __init__(self, order, slots):
        self.path = library_path()
        self.order = list(order)
        self.slots = slots
        self.done = {stem: threading.Event() for stem in self.order}
        # set once the last source's nvcc has started: from then on cores
        # free up as sources end
        self.launched = threading.Event()
        self.finished = threading.Event()
        self.error = None
        self.seconds = None
        # each source's [start, end] seconds from the build's start
        self.span = {}
        self.procs = []
        self.lock = threading.Lock()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, name="ngmix-nvcc", daemon=True)
        self.thread.start()

    def _run(self):
        try:
            compiles, links = nvcc_commands(self.tmpdir, nvcc=find_nvcc())
            idx = {src.stem: i for i, src in enumerate(sources())}
            order = [idx[stem] for stem in self.order]
            deadline = time.monotonic() + BUILD_TIMEOUT_S

            def started(k):
                self.span[self.order[k]] = [time.perf_counter() - self.t0, None]

            def linked(k, cpu):
                i = order[k]
                UNIT_SECONDS[sources()[i].name] = cpu
                _run_all([links[i]], deadline)
                self.span[self.order[k]][1] = time.perf_counter() - self.t0
                self.done[self.order[k]].set()

            _run_all([compiles[i] for i in order], deadline, self.slots, linked, self.procs,
                     self.launched, started)
            with self.lock:
                if self.path.exists():
                    shutil.rmtree(self.tmpdir, ignore_errors=True)
                else:
                    os.replace(self.tmpdir, self.path)
                self.tmpdir = None
        except BaseException as exc:  # noqa: BLE001 - raised again in every waiter
            self.error = exc
            shutil.rmtree(self.tmpdir, ignore_errors=True)
        finally:
            self.seconds = time.perf_counter() - self.t0
            self.launched.set()
            self.finished.set()
            for ev in self.done.values():
                ev.set()

    def _check(self):
        if self.error is not None:
            raise RuntimeError("the kernels' build failed: %s" % self.error) from self.error

    def open(self, stem):
        """one source's library, loaded, once it is linked"""
        self.done[stem].wait()
        self._check()
        with self.lock:
            where = self.path if self.tmpdir is None else self.tmpdir
            return ctypes.CDLL(str(where / (stem + ".so")))

    def wait(self):
        """every source's library: the directory that holds them"""
        self.finished.wait()
        self._check()
        return self.path

    def stop(self):
        """kill the build's nvcc processes (at the interpreter's exit)"""
        for proc in list(self.procs):
            if proc.poll() is None:
                proc.kill()


def _run_all(cmds, deadline, slots=None, on_done=None, procs=None, launched=None,
             on_start=None):
    """run the commands in their order, at most ``slots`` at a time (all
    at once for None), each one's output to a temporary file, calling
    on_done(k, CPU seconds) as command k ends; raises with the first
    failure's output, or when the deadline (time.monotonic()) passes,
    stopping the rest. Returns each command's CPU seconds (its process's
    and its children's user + system time). ``procs`` (a list) holds
    the running processes; the event ``launched`` is set once the last
    command has started, and on_start(k) is called as command k starts"""
    pending = list(range(len(cmds)))
    running = {}
    cpu = [None] * len(cmds)
    procs = [] if procs is None else procs
    try:
        while pending or running:
            while pending and (slots is None or len(running) < slots):
                i = pending.pop(0)
                log = tempfile.TemporaryFile("w+")
                proc = subprocess.Popen(cmds[i], stdout=log, stderr=subprocess.STDOUT, text=True)
                running[i] = (proc, log)
                procs.append(proc)
                if on_start is not None:
                    on_start(i)
            if not pending and launched is not None:
                launched.set()
            for i, (proc, log) in list(running.items()):
                pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
                if pid == 0:
                    continue
                del running[i]
                procs.remove(proc)
                proc.returncode = os.waitstatus_to_exitcode(status)
                cpu[i] = usage.ru_utime + usage.ru_stime
                log.seek(0)
                out = log.read()
                log.close()
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed (%d): %s\n%s"
                                       % (proc.returncode, " ".join(cmds[i]), out))
                if on_done is not None:
                    on_done(i, cpu[i])
            if running and time.monotonic() > deadline:
                raise RuntimeError("nvcc did not finish in %d s: %s" % (
                    BUILD_TIMEOUT_S, " ".join(cmds[min(running)])))
            time.sleep(0.05)
    finally:
        for proc, log in running.values():
            proc.kill()
            proc.wait()
            log.close()
            if proc in procs:
                procs.remove(proc)
    return cpu


# this process's build, while it runs or once it ran
_BUILD = None
_lib = None


def _complete(path):
    return all((path / (src.stem + ".so")).exists() for src in sources())


def start(first=()):
    """begin building every source in the background, unless its
    libraries exist or a build runs: the stems of ``first`` in their
    order, then the other sources, the costliest first; one nvcc
    process a core at a time. Returns the build, or None where there is
    nothing to build"""
    global _BUILD
    if _BUILD is None and not _complete(library_path()):
        rest = sorted((s.stem for s in sources() if s.stem not in first),
                      key=lambda stem: -UNIT_CPU_SECONDS.get(stem + ".cu", 1e9))
        _BUILD = _Build(list(first) + rest, _slots())
        atexit.register(_BUILD.stop)
    return _BUILD


def build():
    """every source's library, built if missing; returns their
    directory. Raises with nvcc's output on failure or after
    BUILD_TIMEOUT_S seconds."""
    path = library_path()
    if _complete(path):
        return path
    return start().wait()


def _open(stem):
    """one source's library, loaded: from the running build (waiting for
    that source alone) or from the directory of build()"""
    if _BUILD is not None and not _BUILD.finished.is_set():
        return _BUILD.open(stem)
    return ctypes.CDLL(str(Path(build()) / (stem + ".so")))


def _signature(name):
    """(argtypes, restype) of a C function, by its name"""
    p, i64, dbl = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    if name.startswith("ngmix_gmix_eval_attrs_"):
        # fast, n, smem, out[4]: registers, static and dynamic shared
        # memory, blocks an SM
        args = [ctypes.c_int, i64, i64, ip]
    elif name.startswith("ngmix_gmix_eval_"):
        # gmix, v, u, area, area_scalar, out, B, n, P, fast, then the
        # launch plan: tile, head, ntiles, nfull, magic, shift, grid,
        # smem; stream
        args = [p, p, p, p, dbl, p, i64, i64, i64, ctypes.c_int, *[i64] * 8, p]
    elif name.startswith("ngmix_normal_eqs_"):
        # rp, chain, v, u, ia, ve, cost, jtr, jtj, B, n, P, stream
        args = [p] * 9 + [i64] * 3 + [p]
    elif name.startswith("ngmix_lm_solve_mb_"):
        # attrs: nband, E, P, out[5] as for K3. The solve: guess, lo, hi,
        # psf, band, v, u, ia, ve, y, cost, cost_pix, jtr, jtj, lam,
        # nfev, done, ier_small_step, ier_small_cost, pinned, counter,
        # prior, B, E, P, nband, nprior, maxfev, ftol, xtol, lambda0,
        # lambda_up, lambda_down, lambda_min, lambda_max, at_floor, stream
        args = ([i64, i64, i64, ip] if name.endswith("_attrs")
                else [p] * 22 + [i64] * 6 + [dbl] * 7 + [i64, p])
    elif name.startswith("ngmix_lm_solve_opt_"):
        # attrs: P, out[5]. The solve: K3's arguments through the table
        # pointer, the full-width outputs fy, fcost, fcost_pix, fjtr,
        # fjtj, B, P, nprior, maxfev, mode, niter, ftol, xtol, lambda0,
        # lambda_up, lambda_down, lambda_min, lambda_max, lam_gn, stream
        args = ([i64, ip] if name.endswith("_attrs")
                else [p] * 26 + [i64] * 6 + [dbl] * 8 + [p])
    elif name.startswith("ngmix_lm_solve_"):
        # attrs: P, out[5]: K2's four values and local memory a thread.
        # The solve: guess, lo, hi, psf, v, u, ia, ve, y, cost, cost_pix,
        # jtr, jtj, lam, nfev, done, ier_small_step, ier_small_cost,
        # pinned, counter, prior, B, P, nprior, maxfev, ftol, xtol,
        # lambda0, lambda_up, lambda_down, lambda_min, lambda_max,
        # at_floor, stream
        args = ([i64, ip] if name.endswith("_attrs")
                else [p] * 21 + [i64] * 4 + [dbl] * 7 + [i64, p])
    else:
        raise AttributeError("no C function %s" % name)
    return args, ctypes.c_int


class Library(object):
    """the C functions of every source's library: each is bound, with its
    argtypes and restype, when it is first used, loading its source's
    library and waiting for that source's build alone"""

    def __init__(self):
        self._dlls = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        args, res = _signature(name)
        stem = unit_of(name)
        if stem not in self._dlls:
            self._dlls[stem] = _open(stem)
        fn = getattr(self._dlls[stem], name)
        fn.argtypes, fn.restype = args, res
        setattr(self, name, fn)
        return fn


def load():
    """the library object whose attributes are the C functions (bound at
    first use, each waiting for its own source)"""
    global _lib
    if _lib is None:
        _lib = Library()
    return _lib
