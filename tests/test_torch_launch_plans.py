"""The launch plans of the two-hot kernel (kernel 7, `csrc/two_hot.cu`), of
the fused int8 trunk (kernel 6, `csrc/int8_trunk.cu`) and of symlog/symexp
(kernel 8, `csrc/symlog.cu`), and the int8 trunk's tensor-core products
emulated lane by lane, on the CPU.

Kernel 7 walks runs of whole rows (or chunks of one long row) through a
two-stage shared-memory ring, each unit staged as one bulk copy of its
16-byte-aligned body plus element loads of its head and tail: the plan
must cover every N and K with shared memory to spare at every alignment
of a row's start. Kernel 6 deals 8-column tiles (and splits of a long K)
to a cluster's warps and keeps the layers' int8 images in shared memory or
a device-memory scratch: the plan must hold every width the reference's
10 MiB guard admits. Its products are `mma.sync.m16n8k32.s32.s8.s8.s32` on
a permutation of K that A and B share; `int8_trunk.mma_emulate` follows
the fragments lane by lane and must give `x_q @ w_q.T` as int32 exactly,
the int32 wrap included. Kernel 8 reads a scalar head to 16-byte
alignment, a body of 16-byte vectors dealt to a persistent grid and a
scalar tail: the plan must give every element to exactly one of them at
every length and every alignment, with every vector access aligned. The
kernels themselves run on the card: tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import quant
from sheeprl_tpu_torch.ops.kernels import int8_trunk, symlog, two_hot

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may have on Hopper
GUARD = 10 * 1024 * 1024  # the reference's int8 trunk guard (pallas_kernels.py:630)

# ---------------------------------------------------------------------------
# kernel 7: two_hot_log_prob
# ---------------------------------------------------------------------------


def test_staging_splits_every_range_into_aligned_body_and_short_ends():
    for address in range(48):
        for nbytes in range(80):
            head, body, tail = two_hot.staging(address, nbytes)
            assert head + body + tail == nbytes and min(head, body, tail) >= 0
            assert head < 16 and tail < 16 and body % 16 == 0
            if body:
                assert (address + head) % 16 == 0


def _check_two_hot_plan(n, k, itemsize):
    plan = two_hot.launch_plan(n, k, itemsize)
    rows, cols, chunks, stage = plan["rows_per_run"], plan["chunk_cols"], plan["chunks"], plan["stage_bytes"]
    assert 1 <= rows <= 32 and stage % 16 == 0
    assert (chunks - 1) * cols < k <= chunks * cols, plan  # K covered, no chunk empty
    assert plan["runs"] == -(-n // rows) and 1 <= plan["blocks"] <= min(plan["runs"], 132 * 3)
    # units are contiguous byte ranges: whole runs, or one row's chunk and its bins
    if chunks == 1:
        assert cols == k and plan["bins_bytes"] >= 4 * k
        units = [rows * k * itemsize]
        if n % rows:
            units.append((n % rows) * k * itemsize)
    else:
        assert rows == 1 and k * itemsize + 32 > 49152 and plan["bins_bytes"] == 0
        units = [cols * itemsize + 4 * cols]
    # every start alignment of a unit (a multiple of the element size, mod
    # 16) leaves its image inside the stage: head, body and tail
    bins_at = -(-cols * itemsize // 16) * 16 + 16  # a long row's bins image, after its logits'
    for nbytes in units:
        for align in range(0, 16, itemsize):
            if chunks == 1:
                assert -(-(align + nbytes) // 16) * 16 <= stage, (n, k, itemsize, plan)
            else:  # the logits' and the bins' images, each at its own alignment
                assert align + cols * itemsize <= bins_at, (n, k, itemsize, plan)
                assert bins_at + -(-(12 + 4 * cols) // 16) * 16 <= stage, (n, k, itemsize, plan)
    assert plan["smem"] == 640 + 2 * stage + plan["bins_bytes"] <= SMEM_LIMIT
    return plan


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_two_hot_launch_plan_covers_every_shape(itemsize):
    """Every K from 1 to 8,192 at several N, every N from 1 to 8,192 at
    several K (the default 255 bins, the misaligned 257, 2,048 and 8,192),
    and rows too long for one stage (K past 12,284 in f32, 24,568 in bf16)
    up to 10^6: the plan covers K, its stages hold every unit at every
    alignment of its start, and its shared memory fits the card."""
    for k in range(1, 8193):
        for n in (1, 1023, 15360):
            _check_two_hot_plan(n, k, itemsize)
    for n in range(1, 8193):
        for k in (1, 255, 257, 2048, 8192):
            _check_two_hot_plan(n, k, itemsize)
    chunked = [k for k in (12281, 12285, 24561, 24570, 40000, 10 ** 6) if _check_two_hot_plan(7, k, itemsize)["chunks"] > 1]
    assert chunked == ([12285, 24561, 24570, 40000, 10 ** 6] if itemsize == 4 else [24570, 40000, 10 ** 6])
    # the training path's launches take whole-row runs of 32 rows
    for n in (1024, 15360):
        assert two_hot.launch_plan(n, 255, itemsize)["rows_per_run"] == 32


@pytest.mark.parametrize("n,k,itemsize,base", [(1023, 257, 4, 4), (1023, 257, 2, 6), (33, 255, 4, 0),
                                               (5, 20001, 4, 8), (3, 40000, 2, 2), (9, 1, 4, 12)])
def test_two_hot_units_stage_every_element_once(n, k, itemsize, base):
    """The kernel's walk, emulated: block b takes runs b, b + blocks, ...
    (each in `chunks` chunks); every element of the logits (and, for a long
    row, of its bins) is staged exactly once, at the stage offset its
    address gives, inside the stage."""
    plan = two_hot.launch_plan(n, k, itemsize)
    rows, cols, chunks, stage, blocks = (plan[key] for key in ("rows_per_run", "chunk_cols", "chunks",
                                                                "stage_bytes", "blocks"))
    seen = np.zeros(n * k, np.int64)
    bins_at = -(-cols * itemsize // 16) * 16 + 16
    for b in range(blocks):
        for j in range(-(-(plan["runs"] - b) // blocks) * chunks):
            run, chunk = b + (j // chunks) * blocks, j % chunks
            if chunks == 1:
                first, count = run * rows * k, min(rows, n - run * rows) * k
                address = base + first * itemsize
                head, body, tail = two_hot.staging(address, count * itemsize)
                assert address % 16 + count * itemsize <= stage
            else:
                c0 = chunk * cols
                first, count = run * k + c0, min(cols, k - c0)
                address = base + first * itemsize
                two_hot.staging(address, count * itemsize)
                assert address % 16 + count * itemsize <= bins_at
                assert bins_at + (4 * c0) % 16 + 4 * count <= stage
            seen[first:first + count] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# kernel 6: fused_int8_trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,kps", [(1, 3, 256, 1), (8, 256, 256, 4), (5, 300, 18, 2), (17, 17, 40, 1),
                                       (16, 64, 8, 1), (20, 1000, 33, 3)])
def test_mma_emulation_reproduces_the_int8_product(m, k, n, kps):
    gen = torch.Generator().manual_seed(m * k + n)
    x_q = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-128, 128, (n, k), generator=gen, dtype=torch.int8)
    want = (x_q.double() @ w_q.double().T).long().to(torch.int32)
    assert torch.equal(int8_trunk.mma_emulate(x_q, w_q, kps), want)


def test_mma_emulation_wraps_like_int32_across_the_chunk_boundary():
    """The case of test_int8_linear_accumulates_exactly_and_wraps_like_int32
    (127 * 127 * 140,000 overflows int32) through the kernel's fragments:
    split at the chunk boundary (2,048 k-blocks, 131,072 products) and as
    the plan splits it, the wrapped sum is the plain version's. One chain
    over all of K = 300,000 would leave int32 inside the MMA: the chunk
    exists for that."""
    k = 140_000
    x = torch.full((1, k), 127.0)
    w_q = torch.full((1, k), 127, dtype=torch.int8)
    x_q = quant.quantize(x, torch.ones(k))
    want = quant.int8_linear(x, torch.ones(k), w_q, torch.ones(1), None)
    wrapped = np.array([127 * 127 * k], np.int64).astype(np.int32)
    plan_kps = int8_trunk.launch_plan(1, k, 64, 64, 1)["layers"][0]["k_blocks_per_split"]
    for kps in (2048, plan_kps):
        got = int8_trunk.mma_emulate(x_q, w_q, kps)
        np.testing.assert_array_equal(got.numpy()[0], wrapped)
        np.testing.assert_array_equal(got.float().numpy(), want.numpy())
    long_k = 300_000
    x_q, w_q = torch.full((1, long_k), 127, dtype=torch.int8), torch.full((1, long_k), 127, dtype=torch.int8)
    with pytest.raises(OverflowError):
        int8_trunk.mma_emulate(x_q, w_q, -(-long_k // 64))
    plan = int8_trunk.launch_plan(1, long_k, 8, 8, 1)["layers"][0]
    assert plan["splits"] > 1 and plan["k_blocks_per_split"] <= 2048
    got = int8_trunk.mma_emulate(x_q, w_q, plan["k_blocks_per_split"])
    np.testing.assert_array_equal(got.numpy()[0], np.array([127 * 127 * long_k], np.int64).astype(np.int32))


def _guard_bytes(dims):
    """The trunk's quantized weights, scales and biases, as the guard counts
    them (in_scale, w_q, w_scale, bias per layer)."""
    return sum(n_in * n_out + 4 * (n_in + 2 * n_out) for n_in, n_out in zip(dims[:-1], dims[1:]))


WIDTHS = (1, 7, 8, 9, 63, 64, 65, 255, 256, 257, 1000, 1024, 3000, 3224, 12288, 20000)


def test_int8_trunk_cluster_plan_covers_every_guarded_width():
    """Every trunk of these widths under the 10 MiB guard, at the serving
    rungs and past the 16 rows of a tile: the cluster is eight blocks where
    the row tiles' clusters fit the card at once, else one, of 16 warps a
    block where a block has the layers to itself or they hold more than
    1,024 k-blocks, else 8; each layer's
    splits cover K with none empty and no product chain past 2,048 k-blocks;
    the images' rows are 64 bytes past a multiple of 128; the images sit in
    shared memory exactly when they fit beside the weight ring and the
    split partials, else in a scratch; and the shared memory fits the card
    at every width. The widest square trunk the guard admits is 3 -> 3,224
    -> 3,224 -> 1."""
    assert _guard_bytes((3, 3224, 3224, 1)) <= GUARD < _guard_bytes((3, 3225, 3225, 1))
    checked = scratch = split = 0
    for dx in (1, 3, 17, 376, 140_000):
        for h0 in WIDTHS:
            for h1 in WIDTHS:
                for a in (1, 6, 17):
                    dims = (dx, h0, h1, a)
                    if _guard_bytes(dims) > GUARD:
                        continue
                    for batch in (1, 8, 16, 17, 256, 257, 1024):
                        plan = int8_trunk.launch_plan(batch, *dims)
                        row_tiles = -(-batch // 16)
                        assert plan["row_tiles"] == row_tiles
                        assert plan["cluster"] == (8 if row_tiles * 8 <= 132 else 1)
                        blocks = sum(-(-n // 8) * -(-k // 64) for k, n in zip(dims[:-1], dims[1:]))
                        assert plan["warps"] == (16 if plan["cluster"] == 1 or blocks > 1024 else 8)
                        assert plan["grid"] == plan["cluster"] * row_tiles
                        partial = 0
                        for layer, (k, n) in zip(plan["layers"], zip(dims[:-1], dims[1:])):
                            kb, kps, splits = layer["k_blocks"], layer["k_blocks_per_split"], layer["splits"]
                            assert layer["tiles"] == -(-n // 8) and kb == -(-k // 64)
                            assert 1 <= kps <= 2048 and (splits - 1) * kps < kb <= splits * kps
                            assert layer["stride"] >= kb * 64 and layer["stride"] % 128 == 64
                            if splits > 1:
                                partial = max(partial, -(-layer["tiles"] // plan["cluster"]) * splits * 16 * 8 * 4)
                                split += 1
                        assert plan["partial_bytes"] == partial
                        images = 16 * sum(layer["stride"] for layer in plan["layers"])
                        fits = plan["ring_bytes"] + partial + images <= SMEM_LIMIT - 1024
                        assert plan["scratch_bytes"] == (0 if fits else row_tiles * images)
                        assert plan["smem"] == plan["ring_bytes"] + partial + (images if fits else 0)
                        assert plan["smem"] <= SMEM_LIMIT - 1024
                        checked += 1
                        scratch += not fits
    assert checked > 10_000 and scratch > 100 and split > 100, (checked, scratch, split)
    # the serving path: Pendulum at rung 8 on one cluster, images in shared memory
    pendulum = int8_trunk.launch_plan(8, 3, 256, 256, 1)
    assert pendulum["cluster"] == 8 and pendulum["grid"] == 8 and pendulum["scratch_bytes"] == 0


# ---------------------------------------------------------------------------
# kernel 8: symlog / symexp
# ---------------------------------------------------------------------------


def _symlog_cover(n, dtype, x_off, out_off, max_blocks):
    """Walk the kernel's loops as `symlog.plan` lays them out and count how
    often each element is written; check every vector access's alignment."""
    p = symlog.plan(n, x_off, dtype, out_off, max_blocks)
    item, vec, head, tail = p["item"], p["vec_elems"], p["head"], p["tail"]
    assert p["item"] == torch.empty((), dtype=dtype).element_size() and vec * item == 16
    assert head < vec and tail < vec and head + p["vectors"] * vec + tail == n
    assert 1 <= p["blocks"] <= max_blocks and p["blocks"] * p["threads"] >= max(head, tail)
    hits = np.zeros(n, np.int64)
    hits[:head] += 1  # threads 0..head-1 take the head
    hits[n - tail:] += 1 if tail else 0  # threads 0..tail-1 the tail
    assert 1 <= p["unroll"] <= symlog.UNROLL
    per_block = p["threads"] * p["unroll"]
    # every (block, iteration, unroll slot, thread) of the grid-stride loop
    b, k, u, t = np.meshgrid(np.arange(p["blocks"]), np.arange(p["iterations"]), np.arange(p["unroll"]),
                             np.arange(p["threads"]), indexing="ij")
    j = ((b + k * p["blocks"]) * per_block + u * p["threads"] + t).ravel()
    j = j[j < p["vectors"]]
    assert np.unique(j).size == j.size == p["vectors"]
    if p["vectors"]:
        starts = head + j * vec
        np.add.at(hits, (starts[:, None] + np.arange(vec)[None, :]).ravel(), 1)
        assert np.all((x_off + starts * item) % 16 == 0)  # 16-byte loads
        out_at = out_off + starts * item
        assert np.all(out_at % p["store_bytes"] == 0)  # stores at their width
        assert p["store_bytes"] == 16 or (out_off + head * item) % (2 * p["store_bytes"]) != 0  # the widest
    assert np.all(hits == 1), (n, dtype, x_off, out_off, np.flatnonzero(hits != 1)[:8])
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_symlog_plan_covers_every_element_once_at_every_alignment(dtype):
    """n = 1..300 and a few large n (up to [65,536, 1,024]), every start of
    `x` within 16 bytes that the dtype admits (an `x[k:]` view), `out` fresh
    (aligned) or not; a small grid limit too, so blocks walk many strides."""
    item = torch.empty((), dtype=dtype).element_size()
    sizes = list(range(1, 301)) + [1023, 4096, 1024 * 255 + 7, 2 * 256 * 132 * 8 * 16 // item + 5, 65536 * 1024]
    for n in sizes:
        for x_off in (range(0, 16, item) if n < 10**6 else (0, 16 - item)):
            outs = (0,) if n > 10**6 else range(0, 16, item)
            for out_off in outs:
                for max_blocks in ((symlog.DEFAULT_MAX_BLOCKS,) if n > 10**6 else (symlog.DEFAULT_MAX_BLOCKS, 3)):
                    _symlog_cover(n, dtype, x_off, out_off, max_blocks)


def test_symlog_plan_fills_the_card_at_large_sizes():
    """At [65,536, 1,024] the persistent grid is the occupancy limit, each
    block walking many strides; at the two-hot logits' shape the grid gives
    each thread one vector, so the call spreads over the SMs."""
    p = symlog.plan(65536 * 1024, 0, torch.float32)
    assert p["blocks"] == symlog.DEFAULT_MAX_BLOCKS and p["unroll"] == 4 and p["iterations"] == 16
    assert p["store_bytes"] == 16
    p = symlog.plan(1024 * 255, 0, torch.bfloat16)  # one vector a thread, over 128 blocks
    assert p["head"] == 0 and p["vectors"] == 32640 and p["unroll"] == 1 and p["blocks"] == 128
    assert p["iterations"] == 1
    p = symlog.plan(3 * symlog.DEFAULT_MAX_BLOCKS * 256 * 4, 0, torch.float32)  # three vectors a thread
    assert p["unroll"] == 3 and p["blocks"] == symlog.DEFAULT_MAX_BLOCKS and p["iterations"] == 1
    with pytest.raises(ValueError):
        symlog.plan(0, 0, torch.float32)
    with pytest.raises(ValueError):
        symlog.plan(8, 2, torch.float32)  # not a whole element past the boundary
