"""K2's launch plan (ngmix_tpu_torch/ops/gmix_eval.py: launch_plan,
lane_magic, grid_size), which the wrapper computes on the host and
passes to the CUDA kernel, checked here without a card: the head and
the tiles partition the flat [B * P] planes, every tile the ring copies
starts on a 16-byte boundary and is whole, the set-ups of every tile
fit the planned shared memory, and the multiply-high division gives
each element's lane exactly.

test_kernel_walk_writes_every_element_once follows the kernel's own
loop (csrc/gmix_eval.cu: gmix_eval_kernel) block by block on small
cases. Integers only: no JAX and no kernel runs here.
"""
import numpy as np
import pytest
import torch

from ngmix_tpu_torch.ops import gmix_eval
from ngmix_tpu_torch.ops.gmix_eval import grid_size, lane_magic, launch_plan

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

PS = (1, 2, 3, 361, 625, 1000, 2401)
BS = (1, 3, 5, 51200)
# the card's shared memory a block can use (227 KB), less the kernel's
# two mbarriers
SMEM_LIMIT = 232448 - 16


def _offsets(esize):
    """every common offset of the inputs past a 16-byte boundary, and
    None for inputs that disagree"""
    return list(range(16 // esize)) + [None]


def lane_of(f, magic, shift):
    """the kernel's lane of flat element f (csrc/gmix_eval.cu: lane_of),
    with Python integers as __umulhi and the 64-bit sum compute it"""
    return ((f * magic >> 32) + f) >> shift


def _lane_of_array(f, P):
    """lane_of over a uint64 array, as the kernel's __umulhi computes it"""
    magic, shift = lane_magic(P)
    f = f.astype(np.uint64)
    return ((f * np.uint64(magic) >> np.uint64(32)) + f) >> np.uint64(shift)


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("P", PS)
def test_tiles_cover_every_pixel_once(P, esize):
    for B in BS:
        N = B * P
        for offset in _offsets(esize):
            for narrays in (2, 3):
                plan = launch_plan(B, 6, P, esize, narrays, offset)
                assert plan.head == (0 if not offset else min(N, 16 // esize - offset))
                # head, then tiles end to end, to the last element
                end = plan.head
                for t in range(plan.ntiles):
                    start, stop = plan.tile_range(t, N)
                    assert start == end and start < stop
                    end = stop
                assert end == N
                if N <= 100_000:
                    # each (lane, pixel) in exactly one of the head and the tiles
                    count = np.zeros((B, P), dtype=np.int64)
                    flat = count.reshape(-1)
                    flat[: plan.head] += 1
                    for t in range(plan.ntiles):
                        start, stop = plan.tile_range(t, N)
                        flat[start:stop] += 1
                    assert np.all(count == 1)


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("P", PS)
def test_tile_slices_start_16_byte_aligned(P, esize):
    vec = 16 // esize
    for B in BS:
        N = B * P
        for offset in _offsets(esize):
            # a base that lies offset elements past a 16-byte boundary
            base = 1 << 20 if offset is None else (1 << 20) + offset * esize
            for narrays in (2, 3):
                for n in (1, 6, 18, 64):
                    plan = launch_plan(B, n, P, esize, narrays, offset)
                    assert plan.tile % vec == 0
                    assert plan.stage_bytes == narrays * plan.tile * esize
                    assert plan.stage_bytes % 16 == 0
                    assert plan.smem_bytes <= SMEM_LIMIT
                    if plan.lanes:
                        assert plan.tile == plan.lanes * P
                        assert plan.tile * esize <= gmix_eval.SLICE_BYTES
                    else:
                        assert plan.tile * esize == gmix_eval.SLICE_BYTES
                    if offset is None:
                        assert plan.nfull == 0
                    else:
                        assert plan.nfull == (N - plan.head) // plan.tile
                    starts = plan.head + plan.tile * np.arange(plan.nfull, dtype=np.int64)
                    assert np.all((base + starts * esize) % 16 == 0)
                    assert np.all(starts + plan.tile <= N)


@pytest.mark.parametrize("P", PS)
def test_tile_setups_fit_their_span(P):
    """every tile and the head touch at most span lanes, whose set-ups
    the plan's shared memory holds"""
    for esize in (4, 8):
        for B in (3, 5, 1000):
            N = B * P
            for offset in _offsets(esize):
                plan = launch_plan(B, 18, P, esize, 3, offset)
                ranges = [(0, plan.head)] if plan.head else []
                ranges += [plan.tile_range(t, N) for t in range(plan.ntiles)]
                for start, stop in ranges:
                    assert (stop - 1) // P - start // P + 1 <= plan.span
                setup = plan.span * 18 * gmix_eval.SETUP_VALUES * esize
                assert plan.smem_bytes == 2 * plan.stage_bytes + setup


def test_lane_magic_exhaustive_small():
    f = np.arange(0, 1 << 16, dtype=np.uint64)
    for P in range(1, 1025):
        magic, shift = lane_magic(P)
        assert 0 < magic < 2**32 and 0 <= shift <= 31
        assert np.array_equal(_lane_of_array(f, P), f // np.uint64(P)), P


def test_lane_magic_on_main_path_sample():
    """a sample over the exp-LM path's 51200 x 361 planes, the largest
    element and the vector ends"""
    P, N = 361, 51200 * 361
    rng = np.random.RandomState(7)
    f = np.concatenate([rng.randint(0, N, 1_000_000), np.arange(N - 4096, N),
                        np.arange(0, 4096)]).astype(np.uint64)
    assert np.array_equal(_lane_of_array(f, P), f // np.uint64(P))


@pytest.mark.parametrize("P", [1, 2, 3, 7, 361, 2401, 65537, 2**31 - 1, 2**31 + 5])
def test_lane_magic_to_2_32(P):
    """Python integers, as __umulhi and the 64-bit sum compute it, up to
    the largest 32-bit element index"""
    magic, shift = lane_magic(P)
    rng = np.random.RandomState(P % 1000)
    fs = [0, 1, P - 1, P, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    fs += [int(x) for x in rng.randint(0, 2**32, 2000, dtype=np.uint64)]
    for f in fs:
        assert lane_of(f, magic, shift) == f // P, (P, f)


def test_grid_size():
    # 6400 tiles of the main path's [51200, 361] planes, 132 SMs of 3 blocks
    assert grid_size(6400, 132, 3) == 396
    assert grid_size(5, 132, 3) == 5
    # a plan with only head elements still launches one block
    assert grid_size(0, 132, 3) == 1


def test_plan_refuses_planes_past_32_bit_indices():
    with pytest.raises(ValueError, match="elements"):
        launch_plan(2**20, 1, 2**11, 4, 2)


def test_main_path_plans():
    """the tiles at the three shapes that reach K2 on the main path"""
    gaussmom = launch_plan(51200, 1, 361, 4, 3)
    assert (gaussmom.lanes, gaussmom.tile, gaussmom.ntiles, gaussmom.nfull) == (8, 2888, 6400, 6400)
    s2n = launch_plan(51200, 6, 361, 4, 3)
    assert (s2n.lanes, s2n.span, s2n.smem_bytes) == (8, 9, 2 * 3 * 2888 * 4 + 9 * 6 * 32)
    sims = launch_plan(10240, 18, 2401, 4, 2)
    assert (sims.lanes, sims.tile, sims.ntiles, sims.nfull) == (0, 4096, 6003, 6002)


def _walk(plan, B, P, n, esize, grid, offset):
    """the kernel's loop, block by block: writes per element, with the
    set-up index of every element and the ring's copies checked"""
    N = B * P
    vec = 16 // esize
    base = 0 if offset is None else offset * esize
    writes = np.zeros(N, dtype=np.int64)
    magic, shift = plan.magic, plan.shift

    def setups_hold(start, stop):
        l0 = lane_of(start, magic, shift)
        assert (lane_of(stop - 1, magic, shift) - l0 + 1) <= plan.span
        return l0

    for block in range(grid):
        for t in range(block, plan.ntiles, grid):
            start, stop = plan.tile_range(t, N)
            l0 = setups_hold(start, stop)
            if t < plan.nfull:
                # the ring: whole, 16-byte aligned slices, vectors of one
                # or more lanes, each inside the tile's set-ups
                assert stop - start == plan.tile and (base + start * esize) % 16 == 0
                for f in range(start, stop, vec):
                    for k in range(vec):
                        assert 0 <= lane_of(f + k, magic, shift) - l0 < plan.span
                    writes[f:f + vec] += 1
            else:
                for f in range(start, stop):
                    assert 0 <= lane_of(f, magic, shift) - l0 < plan.span
                    writes[f] += 1
        if plan.head and block == grid - 1:
            setups_hold(0, plan.head)
            writes[: plan.head] += 1
    return writes


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("P,B", [(1, 37), (2, 19), (3, 21), (361, 9), (625, 5), (2401, 3)])
def test_kernel_walk_writes_every_element_once(P, B, esize):
    for offset in _offsets(esize):
        for n in (1, 6, 18):
            plan = launch_plan(B, n, P, esize, 3, offset)
            for grid in {grid_size(plan.ntiles, 2, 1), grid_size(plan.ntiles, 132, 3)}:
                writes = _walk(plan, B, P, n, esize, grid, offset)
                assert np.all(writes == 1), (offset, n, grid)


def test_out_matches_the_inputs_offset():
    """the wrapper's output lies at the inputs' offset, so the kernel's
    16-byte stores line up with its 16-byte loads"""
    for dtype in (torch.float32, torch.float64):
        esize = torch.finfo(dtype).bits // 8
        x = torch.zeros(3, 361, dtype=dtype)
        for offset in range(16 // esize):
            out = gmix_eval._empty_at(x, offset)
            assert out.shape == x.shape and out.is_contiguous()
            assert out.data_ptr() % 16 == offset * esize
            buf = torch.zeros(x.numel() + 1, dtype=dtype)
            assert buf.data_ptr() % 16 == 0
            views = [buf[k:k + x.numel()].view(x.shape) for k in (0, 1)]
            assert gmix_eval.input_offset([views[1], views[1]]) == 1
            assert gmix_eval.input_offset(views) is None
