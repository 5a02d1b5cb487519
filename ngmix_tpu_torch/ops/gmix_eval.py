"""K2: batched gaussian-mixture evaluation, a hand-written CUDA kernel.

    model[b, p] = area[b, p] * sum_i pnorm[b, i] * exp(-chi2[b, i, p] / 2) * w(chi2)

Replaces ``ngmix_tpu/ops/pallas_gmix.py: eval_gmix_pallas`` (the TPU
kernel, body ``_eval_kernel_body``). The kernel is
``ngmix_tpu_torch/csrc/gmix_eval.cu``, built by ``ops/_build.py`` and
bound with ctypes; ``eval_gmix_plain`` is its plain PyTorch version.

What bounds it on an H100: at the gaussmom weight and the exp-LM guess
(n = 1 over [5 B, 361], area [B, P]) it reads v, u and area and writes
the model, 16 bytes a pixel in float32 against a few dozen
instructions: bytes. At the exp-LM s/n sums (n = 6, fast, same shape)
the bytes and the ~25 instructions a (pixel, gaussian) take about as
long. At the sims' shape (n = 18 over [B, 2401]) the arithmetic, and
its exponentials, bound it.

The design (the source's header has it in full): the planes are flat
[B * P] streams cut into tiles whose slices start on 16-byte
boundaries; a persistent grid walks the tiles, copying the next
tile's slices into a two-stage shared-memory ring with TMA bulk copies
while it computes the current one; each thread takes 16 bytes of
pixels and finds their lane by a multiply-high. ``launch_plan``
computes the tiling and ``lane_magic`` the division on the host, so
both are tested without a card.

Area is a scalar or a [B, P] tensor. A scalar is handed to the kernel
as a value with a null area pointer (scalar mode), so it is never
broadcast into a tensor.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..defaults import FASTEXP_APOD_CHI2, FASTEXP_MAX_CHI2, GMIX_LOW_DETVAL
from . import _build

MAX_GAUSS = 64
_APOD_IWIDTH = 1.0 / (FASTEXP_MAX_CHI2 - FASTEXP_APOD_CHI2)

# values of one gaussian's set-up record (csrc/gmix_eval.cu: kSetup)
SETUP_VALUES = 8
# most bytes of one array's slice of a tile, and of a tile's set-ups
SLICE_BYTES = 16384
SETUP_BYTES = 16384
# the kernel's element indices are 32-bit
MAX_ELEMENTS = 2**31 - 1

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

_C_FUNCS = {
    torch.float32: "ngmix_gmix_eval_f32",
    torch.float64: "ngmix_gmix_eval_f64",
}
_C_ATTRS = {
    torch.float32: "ngmix_gmix_eval_attrs_f32",
    torch.float64: "ngmix_gmix_eval_attrs_f64",
}


def eval_gmix_plain(gmix, v, u, area=1.0, fast=True):
    """plain PyTorch version of K2: gmix [B, n, 6], v/u [B, P], area a
    scalar or [B, P]; returns [B, P]. Same validity rule and arithmetic
    as the kernel; materializes the [B, n, P] intermediate."""
    p, row, col, irr, irc, icc = gmix.unbind(-1)
    det = irr * icc - irc * irc
    T = irr + icc
    # the floor is compared in the element type: 0 in float32
    valid = (det > GMIX_LOW_DETVAL) & (T > 0)
    idet = 1.0 / torch.where(valid, det, 1.0)
    drr = torch.where(valid, irr * idet, 0.0)[..., None]
    drc = torch.where(valid, irc * idet, 0.0)[..., None]
    dcc = torch.where(valid, icc * idet, 0.0)[..., None]
    pnorm = torch.where(
        valid, p / (2 * np.pi * torch.sqrt(torch.where(valid, det, 1.0))), 0.0
    )[..., None]

    vd = v[..., None, :] - row[..., None]
    ud = u[..., None, :] - col[..., None]
    chi2 = dcc * vd * vd + drr * ud * ud - 2.0 * drc * vd * ud
    if fast:
        t = (FASTEXP_MAX_CHI2 - chi2) * _APOD_IWIDTH
        win = t * t * t * (10.0 + t * (-15.0 + 6.0 * t))
        win = torch.where(chi2 > FASTEXP_APOD_CHI2, win, 1.0)
        win = torch.where((chi2 < FASTEXP_MAX_CHI2) & (chi2 >= 0.0), win, 0.0)
        val = torch.exp(-0.5 * torch.clamp(chi2, 0.0, FASTEXP_MAX_CHI2)) * win
    else:
        val = torch.exp(-0.5 * chi2)
    return torch.sum(pnorm * val, dim=-2) * area


# ----------------------------------------------------------------------
# the launch plan


def lane_magic(P):
    """(magic, shift) such that the lane of flat element f,
    (umulhi(f, magic) + f) >> shift with the sum in 64 bits, is f // P
    for every 0 <= f < 2**32: the round-up method with a 33-bit
    multiplier whose top bit is the added f (Granlund and Montgomery)"""
    if P < 1:
        raise ValueError("P must be >= 1, got %d" % P)
    shift = (P - 1).bit_length()
    magic = (2**32 * (2**shift - P)) // P + 1
    return magic, shift


class Plan(NamedTuple):
    """K2's tiling of [B, P] planes (see launch_plan)"""

    lanes: int  # whole lanes a tile, or 0 when a tile is SLICE_BYTES of elements
    tile: int  # elements a tile
    head: int  # elements before the first tile, taken with plain loads
    ntiles: int  # tiles after the head; the last may be ragged
    nfull: int  # the first nfull tiles go through the ring (TMA)
    span: int  # most lanes a tile or the head touches
    magic: int
    shift: int
    stage_bytes: int  # one stage of the ring: every array's slice of a tile
    smem_bytes: int  # dynamic shared memory: two stages and the set-ups

    def tile_range(self, t, N):
        """flat elements [start, end) of tile t"""
        start = self.head + t * self.tile
        return start, min(N, start + self.tile)


def launch_plan(B, n, P, esize, narrays, offset=0):
    """the tiling of K2 over [B, P] planes of esize-byte elements for n
    gaussians, with narrays arrays read (2 with a scalar area, 3 with an
    area tensor). offset is the number of elements by which every
    input's base lies past a 16-byte boundary, or None when they
    disagree, which sends every tile through plain loads.

    A tile is the fewest whole lanes whose slice of an array fills
    16-byte vectors, times as many as fit in SLICE_BYTES; where one such
    group is larger than SLICE_BYTES, a tile is SLICE_BYTES of elements
    (the sims' 49x49 stamps in float32). The head of (16 - offset esize)
    / esize elements brings the first tile to a 16-byte boundary, so
    every tile's slices start on one. Set-ups are capped at SETUP_BYTES.
    """
    vec = 16 // esize
    N = B * P
    if N > MAX_ELEMENTS:
        raise ValueError("K2 takes at most %d elements a plane, got B x P = %d"
                         % (MAX_ELEMENTS, N))
    group = vec // math.gcd(P, vec)
    setup_lane = n * SETUP_VALUES * esize
    if group * P * esize <= SLICE_BYTES:
        lanes = group * max(1, SLICE_BYTES // (group * P * esize))
        # the set-ups of a tile's lanes, and of one more for a shifted
        # start, within SETUP_BYTES
        cap = (SETUP_BYTES // setup_lane - 1) // group * group
        lanes = max(group, min(lanes, cap))
        tile = lanes * P
    else:
        lanes = 0
        tile = SLICE_BYTES // esize
    head = 0 if not offset else min(N, vec - offset)
    ntiles = -(-(N - head) // tile)
    nfull = 0 if offset is None else (N - head) // tile
    span = (tile + P - 2) // P + 1
    magic, shift = lane_magic(P)
    stage_bytes = narrays * tile * esize
    smem_bytes = 2 * stage_bytes + span * setup_lane
    return Plan(lanes, tile, head, ntiles, nfull, span, magic, shift, stage_bytes,
                smem_bytes)


def grid_size(ntiles, sms, per_sm):
    """the persistent grid: a block for each tile, at most as many as the
    card holds at once; one block when there are only head elements"""
    return max(1, min(ntiles, sms * per_sm))


def input_offset(tensors):
    """the common offset, in elements, of the tensors' bases past a
    16-byte boundary, or None when they disagree"""
    offs = {t.data_ptr() % 16 // t.element_size() for t in tensors}
    return offs.pop() if len(offs) == 1 else None


def _empty_at(like, offset):
    """an empty tensor shaped like `like` whose base lies offset elements
    past a 16-byte boundary, so the kernel's 16-byte stores line up with
    the inputs' loads"""
    if not offset:
        return torch.empty_like(like)
    vec = 16 // like.element_size()
    buf = like.new_empty((like.numel() + vec,))
    shift = (offset - buf.data_ptr() % 16 // like.element_size()) % vec
    return buf[shift:shift + like.numel()].view(like.shape)


# ----------------------------------------------------------------------
# the wrapper


def _check(gmix, v, u, area):
    """raise on what the kernel does not take; returns the area tensor
    or None for scalar mode"""
    if gmix.dim() != 3 or gmix.shape[-1] != 6:
        raise ValueError("gmix must be [B, n, 6], got %s" % (tuple(gmix.shape),))
    B, n, _ = gmix.shape
    if not 1 <= n <= MAX_GAUSS:
        raise ValueError("need 1 <= n <= %d gaussians, got %d" % (MAX_GAUSS, n))
    if v.dim() != 2 or v.shape[0] != B or u.shape != v.shape:
        raise ValueError(
            "v and u must be [B, P] with B = %d, got %s and %s"
            % (B, tuple(v.shape), tuple(u.shape))
        )
    if gmix.dtype not in _C_FUNCS:
        raise TypeError("dtype must be float32 or float64, got %s" % gmix.dtype)
    area_t = None
    if isinstance(area, torch.Tensor) and area.dim() > 0:
        if area.shape != v.shape:
            raise ValueError(
                "area must be a scalar or [B, P], got %s" % (tuple(area.shape),)
            )
        area_t = area
    tensors = [gmix, v, u] + ([area_t] if area_t is not None else [])
    for t in tensors:
        if t.dtype != gmix.dtype or t.device != gmix.device:
            raise TypeError("gmix, v, u and area must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("gmix, v, u and area must be contiguous")
    return area_t


@functools.lru_cache(maxsize=None)
def _attrs(device, dtype, fast, n, smem):
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = getattr(_build.load(), _C_ATTRS[dtype])(int(fast), n, smem, out)
    if err != 0:
        raise RuntimeError("K2 gmix_eval attributes failed: CUDA error %d" % err)
    return dict(regs=out[0], static_smem=out[1], dynamic_smem=out[2], blocks_per_sm=out[3])


def kernel_attrs(device, dtype, fast, n, smem):
    """registers a thread, static and dynamic shared memory (bytes) and
    blocks an SM of the kernel that serves n gaussians at smem bytes of
    dynamic shared memory on a CUDA device; queried once per combination
    and cached"""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _attrs(device, dtype, bool(fast), int(n), int(smem))


def plan_for(gmix, v, u, area_t, fast):
    """the launch plan, grid and input offset (launch_plan) of K2 on
    these CUDA tensors, area_t the area tensor or None"""
    inputs = [v, u] + ([area_t] if area_t is not None else [])
    offset = input_offset(inputs)
    B, n, _ = gmix.shape
    plan = launch_plan(B, n, v.shape[1], v.element_size(), len(inputs), offset)
    per_sm = kernel_attrs(v.device, v.dtype, fast, n, plan.smem_bytes)["blocks_per_sm"]
    if per_sm < 1:
        raise RuntimeError("K2 does not fit an SM with %d bytes of shared memory"
                           % plan.smem_bytes)
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    return plan, grid_size(plan.ntiles, sms, per_sm), offset


def eval_gmix(gmix, v, u, area=1.0, fast=True):
    """K2: evaluate [B, n, 6] mixtures over [B, P] pixel coordinates.

    CPU tensors go to eval_gmix_plain; CUDA tensors launch the kernel.
    area is a scalar (number or 0-d tensor) or a [B, P] tensor.
    """
    global launches
    area_t = _check(gmix, v, u, area)
    if gmix.device.type == "cpu":
        return eval_gmix_plain(gmix, v, u, area, fast=fast)
    if gmix.device.type != "cuda":
        raise RuntimeError("K2 runs on CUDA or CPU tensors, not %s" % gmix.device)

    B, n, _ = gmix.shape
    P = v.shape[1]
    if B * P == 0:
        return torch.empty_like(v)
    fn = getattr(_build.load(), _C_FUNCS[gmix.dtype])
    area_scalar = 0.0 if area_t is not None else float(area)
    # the tensors' device is current only for the launch, so the caller's
    # current device is left as it was
    with torch.cuda.device(gmix.device):
        plan, grid, offset = plan_for(gmix, v, u, area_t, fast)
        out = _empty_at(v, offset)
        err = fn(
            gmix.data_ptr(), v.data_ptr(), u.data_ptr(),
            area_t.data_ptr() if area_t is not None else None,
            area_scalar, out.data_ptr(), B, n, P, int(bool(fast)),
            plan.tile, plan.head, plan.ntiles, plan.nfull, plan.magic, plan.shift,
            grid, plan.smem_bytes, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K2 gmix_eval launch failed: CUDA error %d" % err)
    launches += 1
    return out
