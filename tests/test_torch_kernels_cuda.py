"""PyTorch port: the CUDA kernels against their plain PyTorch versions on
the card.  Every test carries the ``cuda`` marker and skips without a GPU.
This file imports no JAX, so it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 3e-2 in bf16;
decode outputs and attention and router gradients are also held row by row
to a share of each row's size, and the scan's decay gradients (sums of P*N
products) to a share of their products' size, as in chip_smoke.py.  ``moe_router`` sums
its logits in another order than cuBLAS, so its ids are compared
tie-aware, as in chip_smoke.py: at every rank the kernel's expert must
have a plain probability within ROUTER_TIE_DELTA of the plain choice's,
and its gradient is held where the routing is pinned to the kernel's.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.moe_gating import moe_gating, moe_router, moe_router_bwd, moe_router_fwd
from repro_torch.kernels.ssd_scan import ssd_state_scan, ssd_state_scan_bwd

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DECODE_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # as chip_smoke.py
ROUTER_TIE_DELTA = 1e-4                                # as chip_smoke.py
GRAD_ROW_TOL = {"float32": 1e-3, "bfloat16": 2e-2}     # as chip_smoke.py


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _randn(seed, *shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=device).to(
        getattr(torch, dtype)) for s in shapes]


def _assert_close(out, want, dtype):
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


def _assert_rows_close(out, want, dtype):
    """Each (slot, query head) row within DECODE_REL_TOL of its own size: a
    decode row is a mean of ~n value rows, far below TOL at long lengths."""
    out, want = out.float().flatten(0, -2), want.float().flatten(0, -2)
    rel = (out - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= DECODE_REL_TOL[dtype], float(rel.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", [
    (1, 200, 200, 16, 8, 128, True),      # qwen3-1.7b heads, ragged prompt
    (2, 17, 130, 14, 2, 64, True),        # qwen2-0.5b heads, Sq != Sk
    (1, 65, 33, 16, 8, 128, False),
    (1, 300, 300, 32, 32, 80, True),      # zamba2's shared block, head dim 80
    (2, 17, 130, 32, 32, 80, True),
    (1, 150, 211, 32, 32, 80, True),      # head dim 80, ragged Sq and Sk tails
    (4, 300, 300, 32, 4, 128, True),      # qwen3-moe prefill, group 8
    # query counts around the 64-row tile; the causal diagonal on a tile
    # edge (Sk = Sq) and inside a key tile (Sk = Sq + 100)
    *((1, Sq, Sq + extra, 16, 8, hd, True) for Sq in (1, 63, 64, 65, 129)
      for extra in (0, 100) for hd in (64, 128)),
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, B, Sq, Sk, H, K, hd,
                                              causal):
    q, k, v = _randn(0, (B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), dtype=dtype,
                     device=cuda_device)
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    _assert_close(out, ref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [80, 128])
def test_flash_attention_kernel_reads_strided_views(cuda_device, dtype, hd):
    """q a view with padded heads (rows 16-byte aligned, not contiguous),
    k and v one layer of a stacked (2,B,S,K,hd) tensor."""
    B, S, H, K = 2, 140, 8, 4
    qp, kk, vv = _randn(5, (B, S, H, hd + 8), (2, B, S, K, hd), (2, B, S, K, hd), dtype=dtype,
                        device=cuda_device)
    q, k, v = qp[..., :hd], kk[1], vv[1]
    assert not q.is_contiguous()
    _assert_close(flash_attention(q, k, v), ref.attention_ref(q, k, v), dtype)


BWD_CASES = [  # (B, Sq, Sk, H, K, hd, causal), as chip_smoke.py's phase 2
    (4, 256, 256, 16, 8, 128, True),      # qwen3-1.7b heads (the training step's group 2)
    (1, 200, 200, 16, 8, 128, True),      # ragged: 200 = 3 tiles + 8 rows
    (1, 17, 200, 16, 8, 128, True),       # Sq < Sk: queries are the last 17
    (1, 150, 211, 32, 32, 80, True),      # head dim 80, group 1, ragged Sq and Sk tails
    (2, 300, 300, 32, 4, 128, True),      # group 8
    (2, 65, 130, 14, 2, 64, True),        # head dim 64, group 7
    (1, 65, 33, 16, 8, 128, False),
    *((1, Sq, Sq + extra, 16, 8, 64, True) for Sq in (1, 63, 64, 65, 129)
      for extra in (0, 100)),
    # the wgmma kernels' tile edges at hd 128 and 80: Sq = Sk around one and
    # two 64-row tiles, causal and not; Sq != Sk across a tile edge
    *((1, S, S, 4, 2, hd, causal) for S in (63, 64, 65, 127, 128, 129) for hd in (128, 80)
      for causal in (True, False)),
    *((1, Sq, Sk, 4, 2, hd, causal) for Sq, Sk in ((63, 129), (65, 128), (127, 129), (64, 65))
      for hd in (128, 80) for causal in (True, False)),
    *((1, Sq, Sk, 4, 2, hd, False) for Sq, Sk in ((129, 63), (128, 65)) for hd in (128, 80)),
    # Sq % 4 != 0 with Sk > Sq: LSE and D rows that start off a 16-byte line
    (2, 65, 129, 8, 4, 128, True),
    (1, 17, 131, 8, 2, 80, True),
    (1, 127, 300, 16, 8, 128, True),
    (4, 200, 200, 32, 4, 128, True),      # group 8 at B = 4
]


def _bwd_inputs(seed, B, Sq, Sk, H, K, hd, causal, dtype, device):
    q, k, v, do = _randn(seed, (B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd),
                         dtype=dtype, device=device)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    return q, k, v, o, lse, do


def grad_row_rel_err(out, want, tol):
    """As chip_smoke.py reads it: max over rows (a query's or a key's head vector) of |out - want| /
    max(|want|, 0.1 x the median row's |want|), Euclidean norms; None where
    the median row is below ``tol`` x sqrt(hd), the size of a row of
    elementwise-tolerance errors (every row a sum that cancels to about
    nothing, as dq where each query sees one key): the elementwise bound
    holds such a tensor alone."""
    out, want = out.float().flatten(0, -2), want.float().flatten(0, -2)
    norm = want.norm(dim=-1)
    median = float(norm.median())
    if median < tol * want.shape[-1] ** 0.5:
        return None
    return float(((out - want).norm(dim=-1) / norm.clamp(min=0.1 * median)).max())


def _assert_grad_rows_close(out, want, dtype):
    rel = grad_row_rel_err(out, want, TOL[dtype])
    assert rel is None or rel <= GRAD_ROW_TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, dtype, B, Sq, Sk, H, K, hd,
                                                  causal):
    q, k, v, o, lse, do = _bwd_inputs(7, B, Sq, Sk, H, K, hd, causal, dtype, cuda_device)
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, causal=causal),
                               atol=TOL[dtype], rtol=TOL[dtype])
    _assert_close(o, ref.attention_ref(q, k, v, causal=causal), dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_close(g, w, dtype)
        _assert_grad_rows_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [80, 128])
def test_flash_attention_bwd_kernel_reads_strided_views(cuda_device, dtype, hd):
    B, S, H, K = 2, 140, 8, 4
    qp, kk, vv, dop = _randn(5, (B, S, H, hd + 8), (2, B, S, K, hd), (2, B, S, K, hd),
                             (B, S, H, hd + 8), dtype=dtype, device=cuda_device)
    q, k, v, do = qp[..., :hd], kk[1], vv[1], dop[..., :hd]
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,causal", [(1, 129, 129, True), (2, 65, 130, True),
                                            (1, 100, 63, False)])
def test_flash_attention_bwd_kernel_reads_strided_views_at_tile_edges(cuda_device, dtype, B,
                                                                      Sq, Sk, causal):
    """q and dO views with padded heads at hd 80 (the tensor maps' strides),
    ragged query and key tiles."""
    H, K, hd = 8, 4, 80
    qp, kk, vv, dop = _randn(6, (B, Sq, H, hd + 8), (2, B, Sk, K, hd), (2, B, Sk, K, hd),
                             (B, Sq, H, hd + 8), dtype=dtype, device=cuda_device)
    q, k, v, do = qp[..., :hd], kk[1], vv[1], dop[..., :hd]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)
        _assert_grad_rows_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_gradient_goes_through_the_backward_kernel(cuda_device, dtype):
    """``ops.attention`` on CUDA tensors that require grad: one forward and
    one backward launch, the gradients those of the plain version; without
    grad (serving) one forward launch and no backward."""
    q, k, v, do = _randn(8, (2, 130, 16, 128), (2, 130, 8, 128), (2, 130, 8, 128),
                         (2, 130, 16, 128), dtype=dtype, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    o = ops.attention(*leaves)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
    o2, lse = flash_attention_fwd(q, k, v, with_lse=True)
    torch.testing.assert_close(o.detach(), o2, atol=0, rtol=0)
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o2, lse, do)):
        _assert_close(g, w, dtype)
    with torch.no_grad():
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        assert ops.attention(*leaves).grad_fn is None
        assert (flash_attention.launches, flash_attention_bwd.launches) == (fwd + 1, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,H,K,hd", [
    ("bfloat16", 2, 300, 16, 8, 128),
    ("float32", 2, 300, 16, 8, 128),
    ("float32", 4, 1024, 10, 5, 64),      # lidc-100m's training layer (phase 14)
])
def test_flash_attention_bwd_is_bit_repeatable(cuda_device, dtype, B, S, H, K, hd):
    inputs = _bwd_inputs(9, B, S, S, H, K, hd, True, dtype, cuda_device)
    first = flash_attention_bwd(*inputs)
    for g, h in zip(first, flash_attention_bwd(*inputs)):
        assert torch.equal(g, h)


# f32 only: the edges of the f32 forward's 128-row blocks (128 positions of
# one head at odd groups, the 64 positions of two heads at even groups) and
# lidc-100m's training layer, forward and backward (chip_smoke.py
# F32_EDGE_CASES)
F32_EDGE_CASES = [  # (B, Sq, Sk, H, K, hd, causal)
    *((1, S, S, 4, 4, hd, causal) for S in (127, 128, 129, 255, 256, 257)
      for hd in (64, 80, 128) for causal in (True, False)),
    *((1, S, S, 4, 2, 64, True) for S in (127, 128, 129, 255, 256, 257)),
    *((1, Sq, Sk, 4, 4, 64, causal) for Sq, Sk in ((127, 257), (129, 256), (255, 257),
                                                    (128, 129)) for causal in (True, False)),
    (1, 257, 129, 4, 4, 64, False),
    (2, 257, 257, 6, 2, 64, True),        # group 3: 128 positions of one head
    (4, 1024, 1024, 10, 5, 64, True),     # lidc-100m's layer, group 2
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", F32_EDGE_CASES)
def test_f32_attention_kernels_at_the_block_edges(cuda_device, B, Sq, Sk, H, K, hd, causal):
    q, k, v, o, lse, do = _bwd_inputs(17, B, Sq, Sk, H, K, hd, causal, "float32", cuda_device)
    _assert_close(o, ref.attention_ref(q, k, v, causal=causal), "float32")
    torch.testing.assert_close(lse, ref.attention_lse_ref(q, k, causal=causal),
                               atol=TOL["float32"], rtol=TOL["float32"])
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)):
        _assert_close(g, w, "float32")
        _assert_grad_rows_close(g, w, "float32")


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_inputs_that_require_grad(cuda_device):
    """A kernel whose output would carry no gradient raises instead of
    training nothing upstream of it; under no_grad it runs.  (moe_router
    and ssd_state_scan carry one since they have a backward: their own
    tests below.)"""
    q, ck, cv = _randn(10, (2, 1, 16, 128), (2, 64, 8, 128), (2, 64, 8, 128),
                       dtype="bfloat16", device=cuda_device)
    logits = torch.randn((4, 128), device=cuda_device)
    calls = {
        "flash_decode": lambda g: flash_decode(g(q), ck, cv, 8),
        "moe_gating": lambda g: moe_gating(g(logits), 8),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward yet; see ROADMAP"):
            call(lambda t: t.clone().requires_grad_())
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_())
        call(lambda t: t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [[1, 64, 299, 300], 300, [0, 5, 65, 1000]])
def test_flash_decode_kernel_matches_plain(cuda_device, dtype, length):
    """Per-slot and scalar lengths, a ragged cache of 300 positions read in
    place as one layer of a stacked cache; a length <= 0 or past Smax
    behaves as in the oracle."""
    q, ck, cv = _randn(1, (4, 1, 16, 128), (2, 4, 300, 8, 128), (2, 4, 300, 8, 128),
                       dtype=dtype, device=cuda_device)
    ck, cv = ck[1], cv[1]
    if isinstance(length, list):
        length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out = ops.decode_attention(q, ck, cv, length)
    assert flash_decode.launches == before + 1
    _assert_close(out, ref.decode_attention_ref(q, ck, cv, length), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [[1, 64, 299, 1000], 700])
def test_flash_decode_kernel_at_head_dim_80(cuda_device, dtype, length):
    """zamba2's shared block: 32 KV heads of width 80, group 1."""
    q, ck, cv = _randn(4, (4, 1, 32, 80), (4, 1024, 32, 80), (4, 1024, 32, 80),
                       dtype=dtype, device=cuda_device)
    if isinstance(length, list):
        length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    out = ops.decode_attention(q, ck, cv, length)
    _assert_close(out, ref.decode_attention_ref(q, ck, cv, length), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    # qwen3-moe decode, group 8: one tile, a tile edge, and the served length
    (4, 512, 32, 4, 128, [1, 64, 65, 308]),
    (4, 512, 32, 4, 128, 308),
    # groups 3 (phi4-mini), 6 (grok) and 7 at head dim 64 (qwen2): rows past
    # the group in the 8 query rows of the tensor-core tile
    (3, 700, 24, 8, 128, [1, 300, 700]),
    (2, 600, 48, 8, 128, [129, 600]),
    (3, 1000, 14, 2, 64, [64, 513, 1000]),
    # lengths at tile and span edges, 0 (uniform over Smax) and past Smax
    (11, 640, 16, 8, 128, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    (11, 640, 32, 32, 80, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    # the same with few enough KV heads that each slot is split over blocks
    (11, 640, 8, 2, 64, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    (11, 640, 4, 4, 80, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    # one slot over a full cluster of 4 blocks, 32 tiles each: the K/V ring
    # wraps many times
    (1, 8192, 16, 8, 128, [8192]),
    (1, 8192, 16, 8, 128, [5000]),
    # length-1 slots beside full-length ones
    (4, 2048, 16, 8, 128, [1, 2048, 1, 2048]),
    # more (slot, KV head) pairs than SMs: one block walks a whole slot and
    # writes the output itself
    (64, 1024, 16, 8, 128, [1024 - 13 * i for i in range(64)]),
])
def test_flash_decode_kernel_at_split_and_ring_edges(cuda_device, dtype, B, Smax, H, K, hd,
                                                     length):
    """Cases that move the bf16 kernel's spans and ring: one layer of a
    stacked cache, read in place."""
    q, ck, cv = _randn(7, (B, 1, H, hd), (2, B, Smax, K, hd), (2, B, Smax, K, hd),
                       dtype=dtype, device=cuda_device)
    ck, cv = ck[1], cv[1]
    if isinstance(length, list):
        length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out = ops.decode_attention(q, ck, cv, length)
    assert flash_decode.launches == before + 1
    want = ref.decode_attention_ref(q, ck, cv, length)
    _assert_close(out, want, dtype)
    _assert_rows_close(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    (4, 512, 32, 4, 128, 308),     # qwen3-moe: 4 blocks a pair
    (4, 1024, 32, 32, 80, 716),    # zamba2: one block a pair
    (8, 2048, 16, 8, 128, 1293),
])
def test_flash_decode_scalar_length_equals_per_slot_lengths(cuda_device, dtype, B, Smax, H,
                                                            K, hd, length):
    """One scalar length (stride 0) and a (B,) tensor of it launch the same
    grid and give the same bits."""
    q, ck, cv = _randn(8, (B, 1, H, hd), (B, Smax, K, hd), (B, Smax, K, hd), dtype=dtype,
                       device=cuda_device)
    scalar = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    per_slot = torch.full((B,), length, dtype=torch.int32, device=cuda_device)
    assert torch.equal(flash_decode(q, ck, cv, scalar), flash_decode(q, ck, cv, per_slot))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    # mistral-large-123b: 96 query heads over 8 KV heads of 128, group 12
    (4, 1024, 96, 8, 128, [1, 300, 1000, 1024]),
    (1, 4096, 96, 8, 128, [4096]),
    (8, 2048, 96, 8, 128, 777),
    # group 24: two row blocks of 16 (the second partial), each reading the cache
    (3, 700, 48, 2, 128, [5, 64, 700]),
    (2, 300, 24, 1, 64, 299),
    (4, 512, 96, 4, 80, [100, 200, 300, 512]),
])
def test_flash_decode_kernel_at_groups_above_8(cuda_device, dtype, B, Smax, H, K, hd, length):
    """A GQA group of 12 (one pass over the cache, all 16 rows of the MMA)
    and of 24 (two row blocks) against the plain version, element- and
    row-wise, one layer of a stacked cache read in place."""
    q, ck, cv = _randn(13, (B, 1, H, hd), (2, B, Smax, K, hd), (2, B, Smax, K, hd),
                       dtype=dtype, device=cuda_device)
    ck, cv = ck[1], cv[1]
    if isinstance(length, list):
        length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out = ops.decode_attention(q, ck, cv, length)
    assert flash_decode.launches == before + 1
    want = ref.decode_attention_ref(q, ck, cv, length)
    _assert_close(out, want, dtype)
    _assert_rows_close(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    (8, 1024, 16, 8, 128, [1, 48, 63, 64, 65, 700, 1000, 1024]),   # split over a cluster
    (64, 256, 16, 16, 64, 200),                                   # one block a pair
    (4, 1024, 96, 8, 128, [0, 300, 1000, 1024]),                   # group 12, one slot masked
    (3, 700, 48, 2, 80, [5, 64, 700]),                             # group 24
])
def test_flash_decode_lse_matches_plain(cuda_device, dtype, B, Smax, H, K, hd, length):
    """The log-sum-exps the kernel writes for the sharded decode's merge
    over position shards against ``decode_lse_ref``; the output of the same
    launch is the one without them, bit for bit."""
    q, ck, cv = _randn(17, (B, 1, H, hd), (B, Smax, K, hd), (B, Smax, K, hd),
                       dtype=dtype, device=cuda_device)
    if isinstance(length, list):
        length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out, lse = ops.decode_attention_lse(q, ck, cv, length)
    assert flash_decode.launches == before + 1
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    assert torch.equal(out, flash_decode(q, ck, cv, length))
    torch.testing.assert_close(lse, ref.decode_lse_ref(q, ck, length), atol=1e-3, rtol=1e-3)


# seamless-m4t-large-v2 (chip_smoke.py phase 13): head dim 64, group 1;
# B = 4 requests of 1024 frames, a decoder of up to 1024 tokens (training)
# or 64 (serving)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq, Sk, causal", [(1024, 1024, False), (1, 1024, False),
                                             (1024, 1024, True), (1, 1, True)])
def test_flash_attention_kernel_at_seamless_shapes(cuda_device, dtype, Sq, Sk, causal):
    """An encoder layer and a training cross-attention (Sq = Sk = 1024, no
    mask); a one-token prefill's cross-attention over 1024 frames; the
    decoder's causal self-attention in training (1024) and in a one-token
    prefill (1)."""
    q, k, v = _randn(11, (4, Sq, 16, 64), (4, Sk, 16, 64), (4, Sk, 16, 64), dtype=dtype,
                     device=cuda_device)
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    _assert_close(out, ref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_kernel_at_the_seamless_training_shape(cuda_device, dtype, causal):
    """The encoder's and the cross-attention's backward (no mask) and the
    decoder self-attention's (causal), 4 x 1024."""
    q, k, v, o, lse, do = _bwd_inputs(13, 4, 1024, 1024, 16, 16, 64, causal, dtype,
                                      cuda_device)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)
        _assert_grad_rows_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Smax, length", [(1024, 1024), (1024, [1, 33, 500, 1024]), (64, 33)])
def test_flash_decode_kernel_at_the_seamless_shape(cuda_device, dtype, Smax, length):
    """The cross-attention's decode against the 0-dim encoder length (as
    ``models/encdec.py`` passes it) and per-slot lengths over 1024 frames;
    the self-attention's decode against the 0-dim ``index + 1`` over a
    64-token cache."""
    q, ck, cv = _randn(12, (4, 1, 16, 64), (2, 4, Smax, 16, 64), (2, 4, Smax, 16, 64),
                       dtype=dtype, device=cuda_device)
    ck, cv = ck[1], cv[1]
    length = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out = ops.decode_attention(q, ck, cv, length)
    assert flash_decode.launches == before + 1
    want = ref.decode_attention_ref(q, ck, cv, length)
    _assert_close(out, want, dtype)
    _assert_rows_close(out, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block_is_one_kernel_launch(cuda_device, dtype):
    """``attention_block`` given the encoder's K/V: q alone is projected,
    one non-causal launch, the reference's result."""
    from repro_torch.models import layers as L
    dt = getattr(torch, dtype)
    p = L.Attention(256, 4, 4, 64, device=cuda_device, dtype=dt)
    L.init_weights_(p, 0, cuda_device)
    x, k, v = _randn(14, (2, 3, 256), (2, 9, 4, 64), (2, 9, 4, 64), dtype=dtype,
                     device=cuda_device)
    before = flash_attention.launches
    out = L.attention_block(p, x, n_heads=4, n_kv=4, head_dim=64, kv_override=(k, v))
    assert flash_attention.launches == before + 1 and out.dtype == dt
    q = (x @ p.wq).reshape(2, 3, 4, 64)
    want = ref.attention_ref(q, k, v, causal=False).reshape(2, 3, 256) @ p.wo
    _assert_close(out, want, dtype)


def _gating_logits(T, E, seed, tied, device):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    if tied:                      # many exact ties, and one constant row
        x = np.round(x, 1)
        x[0] = 0.5
    return torch.tensor(x, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,tied", [
    (4, 128, 8, False), (1200, 128, 8, False), (300, 64, 6, False), (17, 8, 2, False),
    (1200, 128, 8, True), (33, 256, 32, True),
])
def test_moe_gating_kernel_matches_plain(cuda_device, T, E, k, tied):
    x = _gating_logits(T, E, T + E, tied, cuda_device)
    before = moe_gating.launches
    w, ids = ops.moe_gating(x, k)
    assert moe_gating.launches == before + 1
    want_w, want_ids = ref.moe_gating_ref(x, k)
    assert torch.equal(ids, want_ids)
    _assert_close(w, want_w, "float32")


def _router_inputs(T, D, E, dtype, device, seed, dup=False):
    """x (T,D) in ``dtype`` and the router (D,E) f32 at the model's scale
    (logits of about unit size); ``dup`` repeats E//8 distinct columns 8
    times, so the logits hold exact ties that both paths see bitwise equal."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32, device=device)
    router = rng.standard_normal((D, E)) * D ** -0.5
    if dup:
        router = np.repeat(router[:, :E // 8], 8, axis=1)
    return x.to(getattr(torch, dtype)), torch.tensor(router, dtype=torch.float32,
                                                     device=device)


def _assert_router_close(got, want, E):
    """Weights and probabilities at 2e-5; ids distinct, in range, and equal
    to the plain ones up to ties within ROUTER_TIE_DELTA."""
    (w, ids, probs), (want_w, want_ids, want_probs) = got, want
    _assert_close(w, want_w, "float32")
    _assert_close(probs, want_probs, "float32")
    srt = ids.sort(dim=1).values
    assert bool((ids >= 0).all() and (ids < E).all() and (srt[:, 1:] > srt[:, :-1]).all())
    gap = (want_probs.gather(1, ids.long()) - want_probs.gather(1, want_ids.long())).abs()
    assert float(gap.max()) <= ROUTER_TIE_DELTA, float(gap.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(8, 2), (64, 6), (128, 8)])
@pytest.mark.parametrize("T", [1, 4, 17, 300, 1200])
def test_moe_router_kernel_matches_plain(cuda_device, T, E, k, dtype):
    x, router = _router_inputs(T, 2048, E, dtype, cuda_device, seed=T + E)
    before = moe_router.launches, moe_gating.launches
    got = ops.moe_router(x, router, k)
    assert (moe_router.launches, moe_gating.launches) == (before[0] + 1, before[1])
    _assert_router_close(got, ref.moe_router_ref(x, router, k), E)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,E,k", [(4, 2048, 128, 8), (1200, 2048, 128, 8),
                                     (300, 64, 64, 6), (17, 136, 256, 32)])
def test_moe_router_kernel_breaks_exact_ties_to_the_lowest_index(cuda_device, T, D, E, k):
    """Router columns repeated 8 times: both paths see bitwise-equal logits
    in a group, and the ids must then be exactly the plain ones."""
    x, router = _router_inputs(T, D, E, "bfloat16", cuda_device, seed=D, dup=True)
    w, ids, probs = moe_router(x, router, k)
    want_w, want_ids, want_probs = ref.moe_router_ref(x, router, k)
    assert torch.equal(ids, want_ids)
    _assert_close(w, want_w, "float32")
    _assert_close(probs, want_probs, "float32")


def _router_bwd_inputs(T, E, k, dup, device, seed):
    """The forward kernel's (w, ids, probs) on x (T,256) and a router at the
    model's scale (``dup``: columns repeated, exact ties), and random
    cotangents gw (T,k), gprobs (T,E)."""
    x, router = _router_inputs(T, 256, E if not dup else -(-E // 8), "float32", device, seed)
    if dup:
        router = router.repeat_interleave(8, dim=1)[:, :E].contiguous()
    w, ids, probs = moe_router_fwd(x, router, k)
    gen = torch.Generator(device=device).manual_seed(seed)
    gw = torch.randn((T, k), generator=gen, device=device)
    gprobs = torch.randn((T, E), generator=gen, device=device)
    return x, router, (gw, gprobs, w, ids, probs)


@pytest.mark.cuda
@pytest.mark.parametrize("with_gprobs", [True, False])
@pytest.mark.parametrize("T,E,k,dup", [
    *((T, E, k, False) for T in (1, 4, 9, 300) for E, k in ((8, 1), (8, 2), (60, 2),
                                                             (60, 8), (128, 1), (128, 8))),
    (4, 128, 8, True), (300, 128, 8, True), (9, 60, 8, True),
    (4096, 128, 8, False), (4096, 256, 8, False), (33, 256, 32, False), (4096, 256, 32, True),
])
def test_moe_router_bwd_kernel_matches_plain(cuda_device, T, E, k, dup, with_gprobs):
    """The backward kernel against its closed form on the forward kernel's
    own outputs, gprobs present and absent (a null pointer)."""
    _, _, (gw, gprobs, w, ids, probs) = _router_bwd_inputs(T, E, k, dup, cuda_device, T + E)
    gp = gprobs if with_gprobs else None
    before = moe_router_bwd.launches
    got = moe_router_bwd(gw, gp, w, ids, probs)
    assert moe_router_bwd.launches == before + 1
    _assert_close(got, ref.moe_router_bwd_ref(gw, gp, w, ids, probs), "float32")


def _pinned_router(x, router, ids):
    """The plain router's weights and probabilities with the routing taken
    from ``ids`` (the kernel's), differentiable in x and the router."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    s = probs.gather(1, ids.long())
    return s / s.sum(dim=1, keepdim=True), probs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [4, 1200])
def test_moe_router_gradient_goes_through_the_backward_kernel(cuda_device, dtype, T):
    """``moe_router`` on CUDA tensors that require grad: one forward and one
    backward launch, and dx (in x's dtype) and drouter (f32) those of
    autograd through the plain router with the kernel's routing (the two sum
    the logits in other orders, so a near tie may route differently); rows
    of dx also within GRAD_ROW_TOL of their size.  Without grad (serving)
    one forward launch and no graph."""
    x, router = _router_inputs(T, 2048, 128, dtype, cuda_device, seed=T)
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    gw = torch.randn((T, 8), generator=gen, device=cuda_device)
    gprobs = torch.randn((T, 128), generator=gen, device=cuda_device) / T
    leaves = [x.clone().requires_grad_(), router.clone().requires_grad_()]
    fwd, bwd = moe_router.launches, moe_router_bwd.launches
    w, ids, probs = ops.moe_router(*leaves, 8)
    assert w.grad_fn is not None and not ids.requires_grad
    got = torch.autograd.grad([w, probs], leaves, [gw, gprobs])
    assert (moe_router.launches, moe_router_bwd.launches) == (fwd + 1, bwd + 1)
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    plain = [x.clone().requires_grad_(), router.clone().requires_grad_()]
    want = torch.autograd.grad(_pinned_router(*plain, ids), plain, [gw, gprobs])
    for g, h in zip(got, want):
        _assert_close(g, h, dtype if g.dtype == x.dtype else "float32")
    _assert_grad_rows_close(got[0], want[0], dtype)
    # the weights' gradient alone: the probabilities' arrives as None
    w, _, _ = ops.moe_router(*leaves, 8)
    got_w = torch.autograd.grad(w, leaves, gw)
    want_w = torch.autograd.grad(_pinned_router(*plain, ids)[0], plain, gw)
    for g, h in zip(got_w, want_w):
        _assert_close(g, h, dtype if g.dtype == x.dtype else "float32")
    with torch.no_grad():
        fwd, bwd = moe_router.launches, moe_router_bwd.launches
        assert ops.moe_router(*leaves, 8)[0].grad_fn is None
        assert (moe_router.launches, moe_router_bwd.launches) == (fwd + 1, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,with_gprobs", [(4096, 128, 8, False), (4096, 126, 8, True),
                                               (33, 256, 32, True)])
def test_moe_router_bwd_repeats_bit_equal(cuda_device, T, E, k, with_gprobs):
    """Two calls give the same bits beyond the case below: phase 10's shape
    without gprobs, a ragged row and the widest rows."""
    _, _, (gw, gprobs, w, ids, probs) = _router_bwd_inputs(T, E, k, False, cuda_device, 11)
    gp = gprobs if with_gprobs else None
    assert torch.equal(moe_router_bwd(gw, gp, w, ids, probs),
                       moe_router_bwd(gw, gp, w, ids, probs))


@pytest.mark.cuda
def test_moe_router_backward_is_bit_repeatable(cuda_device):
    _, _, inputs = _router_bwd_inputs(4096, 128, 8, False, cuda_device, 5)
    assert torch.equal(moe_router_bwd(*inputs), moe_router_bwd(*inputs))
    x, router = _router_inputs(4096, 2048, 128, "bfloat16", cuda_device, seed=6)
    gw = torch.randn((4096, 8), device=cuda_device)

    def grads():
        leaves = [x.clone().requires_grad_(), router.clone().requires_grad_()]
        w, _, probs = moe_router(*leaves, 8)
        return torch.autograd.grad((w * gw).sum() + probs.mean(0).square().sum(), leaves)

    for g, h in zip(grads(), grads()):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_moe_router_op_under_checkpoint(cuda_device):
    """Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass (two forward launches, one backward) and routes the same
    tokens: the gradients equal the unrecomputed ones bit for bit."""
    from torch.utils.checkpoint import checkpoint
    x, router = _router_inputs(1200, 2048, 128, "bfloat16", cuda_device, seed=7)
    gw = torch.randn((1200, 8), device=cuda_device)

    def f(a, b):
        w, _, probs = moe_router(a, b, 8)
        return (w * gw).sum() + probs.mean(0).square().sum()

    leaves = [x.clone().requires_grad_(), router.clone().requires_grad_()]
    want = torch.autograd.grad(f(*leaves), leaves)
    fwd, bwd = moe_router.launches, moe_router_bwd.launches
    got = torch.autograd.grad(checkpoint(f, *leaves, use_reentrant=False), leaves)
    assert (moe_router.launches, moe_router_bwd.launches) == (fwd + 2, bwd + 1)
    for g, h in zip(got, want):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_moe_router_bwd_refuses_what_it_does_not_take(cuda_device):
    _, _, (gw, gprobs, w, ids, probs) = _router_bwd_inputs(8, 64, 4, False, cuda_device, 8)
    with pytest.raises(ValueError, match="CUDA"):
        moe_router_bwd(gw.cpu(), None, w.cpu(), ids.cpu(), probs.cpu())
    with pytest.raises(ValueError, match="ids must be"):
        moe_router_bwd(gw, gprobs, w, ids.long(), probs)
    with pytest.raises(ValueError, match="gprobs must be"):
        moe_router_bwd(gw, gprobs[:, :32], w, ids, probs)
    with pytest.raises(ValueError, match="gw must be"):
        moe_router_bwd(gw.t().contiguous().t(), gprobs, w, ids, probs)
    with pytest.raises(ValueError, match="E <= 256"):
        moe_router_bwd(gw, None, w, ids, torch.zeros((8, 300), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 64, 80, 64), (2, 5, 4, 16, 16), (1, 300, 2, 8, 8)])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_state_scan_kernel_matches_plain(cuda_device, shape, with_init):
    B, C, H, P, N = shape
    rng = np.random.default_rng(C)
    xs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda_device)
    a = torch.tensor(rng.uniform(0.3, 0.99, (B, C, H)), dtype=torch.float32,
                     device=cuda_device)
    s0 = torch.tensor(rng.standard_normal((B, H, P, N)), dtype=torch.float32,
                      device=cuda_device) if with_init else None
    before = ssd_state_scan.launches
    prefix, final = ops.ssd_state_scan(xs, a, s0)
    assert ssd_state_scan.launches == before + 1
    want_prefix, want_final = ref.ssd_state_scan_ref(xs, a, s0)
    _assert_close(prefix, want_prefix, "float32")
    _assert_close(final, want_final, "float32")


def _scan_bwd_inputs(shape, with_init, with_g_final, device, seed):
    B, C, H, P, N = shape
    rng = np.random.default_rng(seed)

    def t(*dims, lo=None):
        x = rng.uniform(lo, 0.99, dims) if lo is not None else rng.standard_normal(dims)
        return torch.tensor(x, dtype=torch.float32, device=device)

    xs, a = t(B, C, H, P, N), t(B, C, H, lo=0.3)
    s0 = t(B, H, P, N) if with_init else None
    g_prefix, g_final = t(B, C, H, P, N), (t(B, H, P, N) if with_g_final else None)
    return xs, a, s0, g_prefix, g_final


def _autograd_scan(leaves, g_prefix, g_final):
    """Autograd's gradients through the plain scan; zeros where no path
    leads to a leaf (one chunk, no initial state: a constant prefix)."""
    outs = ref.ssd_state_scan_ref(*leaves)
    dot = sum((o * g).sum() for o, g in zip(outs, (g_prefix, g_final)) if g is not None)
    grads = (torch.autograd.grad(dot, leaves, allow_unused=True) if dot.requires_grad
             else [None] * len(leaves))
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def _assert_scan_bwd_close(got, want, prefix):
    """d_states and d_init elementwise; each d_decays[b, c, h], a sum of P*N
    products G * prefix[c] taken in another order, also within TOL of the
    products' Euclidean norm (as chip_smoke.py holds it)."""
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert (g is None) == (w is None)
        if g is not None:
            _assert_close(g, w, "float32")
    tol = TOL["float32"]
    scale = (want[0] * prefix).flatten(3).norm(dim=-1)
    err = (got[1] - want[1]).abs()
    assert bool((err <= tol + tol * want[1].abs() + tol * scale).all()), float(err.max())


SCAN_BWD_SHAPES = [
    (4, 4, 64, 80, 64),     # a zamba2-2.7b block at 4 x 1024 training tokens
    (2, 5, 4, 16, 16),
    (1, 1, 2, 8, 8),        # one chunk
    (3, 3, 5, 7, 9),        # P * N = 63: the 4-byte path
    (1, 6, 2, 80, 65),      # P * N = 5200: a cluster of eight, its last run ragged
    (1, 70, 2, 16, 16),     # 70 chunks: three tiles of chunk sums
    (2, 3, 3, 36, 37),      # P * N = 1332, P * N / 4 odd: two blocks, the second shorter
    (1, 5, 1, 80, 64),      # B * H = 1: one cluster
    (1, 3, 2, 128, 96),     # P * N = 12288: eight blocks, each in two passes
    (1, 4, 3, 45, 31),      # P * N = 1395: the 4-byte path over two blocks
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
@pytest.mark.parametrize("with_init,with_g_final", [(False, False), (True, True),
                                                    (False, True), (True, False)])
def test_ssd_state_scan_bwd_kernel_matches_plain(cuda_device, shape, with_init, with_g_final):
    xs, a, s0, gp, gf = _scan_bwd_inputs(shape, with_init, with_g_final, cuda_device, 3)
    prefix, _ = ssd_state_scan(xs, a, s0)
    before = ssd_state_scan_bwd.launches
    got = ssd_state_scan_bwd(gp, gf, prefix, a, with_init)
    assert ssd_state_scan_bwd.launches == before + 1
    _assert_scan_bwd_close(got, ref.ssd_state_scan_bwd_ref(gp, gf, prefix, a, with_init),
                           prefix)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES[:3])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_state_scan_gradient_matches_autograd(cuda_device, shape, with_init):
    """Through ``ops.ssd_state_scan`` on inputs that require grad: one
    forward launch, then one backward launch for both outputs' gradients,
    against autograd through the plain scan; under no_grad no op."""
    xs, a, s0, gp, gf = _scan_bwd_inputs(shape, with_init, True, cuda_device, 4)
    leaves = [t.clone().requires_grad_() for t in (xs, a, s0) if t is not None]
    fwd, bwd = ssd_state_scan.launches, ssd_state_scan_bwd.launches
    prefix, final = ops.ssd_state_scan(*leaves)
    got = torch.autograd.grad([prefix, final], leaves, [gp, gf])
    assert (ssd_state_scan.launches, ssd_state_scan_bwd.launches) == (fwd + 1, bwd + 1)
    want = _autograd_scan([t.clone().requires_grad_() for t in (xs, a, s0) if t is not None],
                          gp, gf)
    _assert_scan_bwd_close((got[0], got[1], got[2] if with_init else None),
                           (want[0], want[1], want[2] if with_init else None),
                           prefix.detach())
    # an unread final: its gradient is None, and the kernel takes no g_final
    prefix, _ = ops.ssd_state_scan(*leaves)
    got = torch.autograd.grad(prefix, leaves[:2], gp)
    want = ref.ssd_state_scan_bwd_ref(gp, None, prefix.detach(), a, False)
    _assert_scan_bwd_close((got[0], got[1], None), want, prefix.detach())
    with torch.no_grad():
        fwd, bwd = ssd_state_scan.launches, ssd_state_scan_bwd.launches
        assert ops.ssd_state_scan(*leaves)[0].grad_fn is None
        assert (ssd_state_scan.launches, ssd_state_scan_bwd.launches) == (fwd + 1, bwd)


@pytest.mark.cuda
def test_ssd_state_scan_bwd_is_bit_repeatable(cuda_device):
    xs, a, s0, gp, gf = _scan_bwd_inputs((4, 4, 64, 80, 64), True, True, cuda_device, 5)
    prefix, _ = ssd_state_scan(xs, a, s0)
    first = ssd_state_scan_bwd(gp, gf, prefix, a, True)
    for g, h in zip(first, ssd_state_scan_bwd(gp, gf, prefix, a, True)):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,with_init,with_g_final", [
    ((4, 4, 64, 80, 64), False, False),     # phase 11's block as the model calls it
    ((1, 70, 2, 16, 16), True, True),
    ((1, 3, 2, 128, 96), True, True),
    ((1, 4, 3, 45, 31), True, True),
])
def test_ssd_state_scan_bwd_repeats_bit_equal(cuda_device, shape, with_init, with_g_final):
    """Two calls give the same bits on every path: the cluster's reduction,
    tiles of chunk sums, passes (d_decays read back) and the 4-byte path."""
    xs, a, s0, gp, gf = _scan_bwd_inputs(shape, with_init, with_g_final, cuda_device, 6)
    prefix, _ = ssd_state_scan(xs, a, s0)
    first = ssd_state_scan_bwd(gp, gf, prefix, a, with_init)
    for g, h in zip(first, ssd_state_scan_bwd(gp, gf, prefix, a, with_init)):
        assert (g is None and h is None) or torch.equal(g, h)


def _offset_copy(t, device):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary,
    so the reverse scan takes its 4-byte path whatever the shape."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 8, 80, 64), (1, 3, 2, 128, 96)])
def test_ssd_state_scan_bwd_takes_unaligned_inputs(cuda_device, shape):
    """P * N % 4 == 0 but every input 4 bytes off a 16-byte boundary: the
    4-byte path, against the closed form and the TMA path's result."""
    xs, a, s0, gp, gf = _scan_bwd_inputs(shape, True, True, cuda_device, 7)
    prefix, _ = ssd_state_scan(xs, a, s0)
    want = ref.ssd_state_scan_bwd_ref(gp, gf, prefix, a, True)
    aligned = ssd_state_scan_bwd(gp, gf, prefix, a, True)
    got = ssd_state_scan_bwd(*(_offset_copy(t, cuda_device) for t in (gp, gf, prefix)), a, True)
    _assert_scan_bwd_close(got, want, prefix)
    _assert_scan_bwd_close(aligned, want, prefix)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = _randn(2, (1, 8, 4, 96), (1, 8, 2, 96), (1, 8, 2, 96), dtype="bfloat16",
                     device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _randn(3, (1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64), dtype="bfloat16",
                     device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError, match="length must be"):
        flash_decode(q[:, :1], k, v, torch.tensor([8]))
    logits = torch.zeros((4, 257), device=cuda_device)
    with pytest.raises(ValueError, match="E <= 256"):
        moe_gating(logits, 8)
    with pytest.raises(ValueError, match="f32"):
        moe_gating(logits[:, :128].to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="k <="):
        moe_gating(logits[:, :8].contiguous(), 9)
    x, router = _router_inputs(4, 64, 64, "bfloat16", cuda_device, seed=0)
    with pytest.raises(ValueError, match="bf16 or f32"):
        moe_router(x.half(), router, 8)
    with pytest.raises(ValueError, match="router must be contiguous"):
        moe_router(x, router.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="equal D"):
        moe_router(x[:, :56].contiguous(), router, 8)
    with pytest.raises(ValueError, match="D % 8"):
        moe_router(x[:, :12].contiguous(), router[:12].contiguous(), 8)
    with pytest.raises(ValueError, match="D <= 8192"):
        moe_router(torch.zeros((4, 8200), device=cuda_device),
                   torch.zeros((8200, 64), device=cuda_device), 8)
    with pytest.raises(ValueError, match="E <= 256"):
        moe_router(x, torch.zeros((64, 257), device=cuda_device), 8)
    with pytest.raises(ValueError, match="k <="):
        moe_router(x, router, 33)
    with pytest.raises(ValueError, match="x must be contiguous"):
        moe_router(x.t().contiguous().t(), router, 8)
    with pytest.raises(ValueError, match="router must be contiguous"):
        moe_router(x, torch.zeros((64, 128), device=cuda_device)[:, ::2], 8)
    xs = torch.zeros((1, 3, 2, 8, 8), device=cuda_device)
    a = torch.ones((1, 3, 2), device=cuda_device)
    with pytest.raises(ValueError, match="f32 only"):
        ssd_state_scan(xs.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(xs.transpose(3, 4), a)
    with pytest.raises(ValueError, match="init_state"):
        ssd_state_scan(xs, a, torch.zeros((1, 2, 8, 4), device=cuda_device))
    with pytest.raises(ValueError, match="g_prefix"):
        ssd_state_scan_bwd(xs.transpose(3, 4), None, xs, a, False)
    with pytest.raises(ValueError, match="g_final"):
        ssd_state_scan_bwd(xs, torch.zeros((1, 2, 8, 4), device=cuda_device), xs, a, False)
    with pytest.raises(ValueError, match="chunk_decays"):
        ssd_state_scan_bwd(xs, None, xs, a[:, :2].contiguous(), False)
    with pytest.raises(ValueError, match="prefix must be a CUDA"):
        ssd_state_scan_bwd(xs.cpu(), None, xs.cpu(), a.cpu(), False)


# ---------------------------------------------------------------------------
# two ranks on the card: gloo processes on cuda:0 (NCCL takes one rank a
# device), each held against the one-rank path on the card
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    return float((got - want).detach().abs().max() / want.detach().abs().max())


def _ep_rank(rank, n):
    """qwen3-moe smoke's MoE block, f32, expert parallel over a 1 x 2
    ("data", "model") mesh, against the block on one rank: y, aux and the
    gradients of x, the router and this rank's experts; one router launch
    and one router backward launch on the sharded path."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import smoke_of
    from repro_torch.kernels.moe_gating import moe_router, moe_router_bwd
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh, use_rules
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(smoke_of("qwen3-moe-30b-a3b"), dtype="float32")
    full = moe.init_moe(cfg, 0, device=dev).requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev).requires_grad_(True)
    gy = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev)
    names = ("router", "w_gate", "w_up", "w_down")

    def run(p):
        y, aux = moe.moe_block(cfg, p, x)
        grads = torch.autograd.grad(torch.sum(y * gy) + 3.0 * aux,
                                    [x] + [getattr(p, k) for k in names])
        return y, aux, grads

    y1, aux1, g1 = run(full)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    with use_rules(rules_for(cfg, model_axis=2, force_tp=True)), use_mesh(mesh):
        p = moe.local_experts(cfg, full)
        moe_router.launches = moe_router_bwd.launches = 0
        y2, aux2, g2 = run(p)
    torch.cuda.synchronize()
    E_loc = cfg.n_experts // 2
    want = [g1[0], g1[1]] + [g[rank * E_loc:(rank + 1) * E_loc] for g in g1[2:]]
    return {"y": _rel_err(y2, y1), "aux": abs(aux2.item() - aux1.item()),
            "grads": [_rel_err(a, b) for a, b in zip(g2, want)],
            "launches": (moe_router.launches, moe_router_bwd.launches)}


@pytest.mark.cuda
def test_two_rank_expert_parallel_moe_block_matches_one_rank(cuda_device, tmp_path):
    from torch_ranks import spawn
    for got in spawn(_ep_rank, 2, tmp_path):
        assert got["y"] <= 1e-4 and got["aux"] <= 1e-6, got
        assert max(got["grads"]) <= 1e-4, got
        assert got["launches"] == (1, 1), got


def _pp_rank(rank, n):
    """lidc-demo smoke in f32, widened to d_model 128 (heads of 64, which the
    attention kernels take), as two GPipe stages of one layer, 2
    microbatches, against the sequential loss_fn on the card: the loss and
    this stage's gradients; one f32 attention launch and one backward
    launch a microbatch."""
    import dataclasses

    from repro_torch.configs.base import smoke_of
    from repro_torch.models import bundle_for
    from repro_torch.runtime.pipeline import make_pp_loss_fn, make_pp_mesh, stage_layers
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(smoke_of("lidc-demo"), dtype="float32", d_model=128)
    params = bundle_for(cfg).init(cfg, 0, device=dev).requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, 33), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mesh = make_pp_mesh(2)
    layers = stage_layers(cfg, mesh, 2)
    leaves = [p for name, p in params.named_parameters()
              if not name.startswith("blocks.") or int(name.split(".")[1]) in layers]
    seq = bundle_for(cfg).loss_fn(cfg, params, batch)
    want = torch.autograd.grad(seq, leaves)
    flash_attention.launches = flash_attention_bwd.launches = 0
    loss = make_pp_loss_fn(cfg, mesh, n_stages=2, n_micro=2)(params, batch)
    got = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return {"loss": abs(loss.item() - seq.item()) / seq.item(),
            "grads": [_rel_err(a, b) for a, b in zip(got, want)],
            "launches": (flash_attention.launches, flash_attention_bwd.launches)}


@pytest.mark.cuda
def test_two_rank_gpipe_matches_the_sequential_loss(cuda_device, tmp_path):
    from torch_ranks import spawn
    for got in spawn(_pp_rank, 2, tmp_path):
        assert got["loss"] <= 1e-5 and max(got["grads"]) <= 1e-4, got
        assert got["launches"] == (2, 2), got
