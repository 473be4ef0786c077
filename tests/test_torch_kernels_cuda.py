"""PyTorch port: the CUDA kernels against their plain PyTorch versions on
the card.  Every test carries the ``cuda`` marker and skips without a GPU.
This file imports no JAX, so it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 3e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", [
    (1, 200, 200, 16, 8, 128, True),      # qwen3-1.7b heads, ragged prompt
    (2, 17, 130, 14, 2, 64, True),        # qwen2-0.5b heads, Sq != Sk
    (1, 65, 33, 16, 8, 128, False),
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
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = _randn(2, (1, 8, 4, 80), (1, 8, 2, 80), (1, 8, 2, 80), dtype="bfloat16",
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
