"""The dense family: a decoder of identical blocks as Qwen3 and Mistral
publish it (pre-norm RMS norm, GQA with RoPE by half rotation, per-head q/k
RMS norm where the configuration has it, SwiGLU, tied or untied head),
served and trained by the port's ``models/transformer.py``.

Its shapes, its leaves as the port's ``Transformer`` names and lays them
out (``(d_in, d_out)`` matrices applied as ``x @ w``), its blocks in the
plain float32 reference, its counts, its part of the planted faults and
its size in the CPU tests.  ``train_flops`` is a copy of the port's
``models/model.py::model_flops`` for the dense decoder (6·N·D in training
plus the causal attention term), kept here so that a change to the
program cannot move the yardstick.  Only ``arch_config`` and ``planted``
import the program, when they are called.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import weights
from ..faults import patched
from ..reference import causal_attention, linear, rms, rope
from ..yardstick import attention_flops, decode_attention_bytes

__all__ = ["Spec", "spec_of", "arch_config", "groups", "leaves", "embed", "block",
           "final_logits", "param_count", "prefill_counts", "decode_step_counts",
           "train_flops", "attention_layers", "planted", "MOVED_TWICE", "small"]

Leaf = Tuple[str, Tuple[int, ...], object]
MOVED_TWICE = "blocks.0.attn.wq"


@dataclass(frozen=True)
class Spec:
    """The shapes of a dense decoder, read from a configuration file."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    theta: float
    qk_norm: bool
    tied: bool
    dtype: str

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float16": 2, "float32": 4}[self.dtype]


def spec_of(cfg: Dict) -> Spec:
    """A configuration file's published keys as a ``Spec``."""
    heads = int(cfg["num_attention_heads"])
    return Spec(layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
                heads=heads, kv_heads=int(cfg["num_key_value_heads"]),
                head_dim=int(cfg.get("head_dim") or cfg["hidden_size"] // heads),
                d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
                eps=float(cfg["rms_norm_eps"]), theta=float(cfg["rope_theta"]),
                qk_norm=bool(cfg.get("qk_norm", False)),
                tied=bool(cfg["tie_word_embeddings"]), dtype=str(cfg["torch_dtype"]))


def arch_config(cfg: Dict, s: Spec, name: str):
    """The port's configuration record for the file's model, every size
    and constant taken from the file."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(arch_id=name, family="dense", n_layers=s.layers, d_model=s.d_model,
                      n_heads=s.heads, n_kv_heads=s.kv_heads, d_ff=s.d_ff, vocab=s.vocab,
                      head_dim=s.head_dim, qk_norm=s.qk_norm,
                      qkv_bias=bool(cfg.get("attention_bias", False)), rope_theta=s.theta,
                      tie_embeddings=s.tied, dtype=s.dtype, norm_eps=s.eps,
                      source=cfg["source"])


# -- leaves ------------------------------------------------------------------

def layer_leaves(s: Spec) -> List[Leaf]:
    """One block's leaves, as ``blocks.<i>.`` names them."""
    D, H, K, hd, ff = s.d_model, s.heads, s.kv_heads, s.head_dim, s.d_ff
    proj = weights.fan_in
    leaves = [("norm1.w", (D,), weights.norm), ("attn.wq", (D, H * hd), proj),
              ("attn.wk", (D, K * hd), proj), ("attn.wv", (D, K * hd), proj),
              ("attn.wo", (H * hd, D), proj)]
    if s.qk_norm:
        leaves += [("attn.q_norm", (hd,), weights.norm), ("attn.k_norm", (hd,), weights.norm)]
    return leaves + [("norm2.w", (D,), weights.norm), ("mlp.w_gate", (D, ff), proj),
                     ("mlp.w_up", (D, ff), proj), ("mlp.w_down", (ff, D), proj)]


def top_leaves(s: Spec) -> List[Leaf]:
    """The leaves outside the blocks."""
    leaves = [("embed.table", (s.vocab, s.d_model), weights.embedding),
              ("final_norm.w", (s.d_model,), weights.norm)]
    if not s.tied:
        leaves.append(("lm_head.w", (s.d_model, s.vocab), weights.fan_in))
    return leaves


def groups(s: Spec) -> List[int]:
    """The leaves outside the blocks, then one group a layer."""
    return [weights.TOP] + list(range(s.layers))


def leaves(s: Spec, group: int) -> List[Leaf]:
    if group == weights.TOP:
        return top_leaves(s)
    return [(f"blocks.{group}.{n}", shape, init) for n, shape, init in layer_leaves(s)]


# -- the plain reference -----------------------------------------------------

Weights = Dict[str, torch.Tensor]


def embed(s: Spec, W: Weights, tokens: torch.Tensor) -> torch.Tensor:
    return W["embed.table"][tokens]


def block(s: Spec, W: Weights, i: int, h: torch.Tensor, quant: Optional[str] = None
          ) -> torch.Tensor:
    """Layer ``i`` on hidden states h (B, T, D)."""
    p = f"blocks.{i}."
    B, T, _ = h.shape
    x = rms(h, W[p + "norm1.w"], s.eps)
    q = linear(x, W[p + "attn.wq"], quant).view(B, T, s.heads, s.head_dim)
    k = linear(x, W[p + "attn.wk"], quant).view(B, T, s.kv_heads, s.head_dim)
    v = linear(x, W[p + "attn.wv"], quant).view(B, T, s.kv_heads, s.head_dim)
    if s.qk_norm:
        q = rms(q, W[p + "attn.q_norm"], s.eps)
        k = rms(k, W[p + "attn.k_norm"], s.eps)
    o = causal_attention(rope(q, s.theta), rope(k, s.theta), v)
    h = h + linear(o.reshape(B, T, -1), W[p + "attn.wo"], quant)
    x = rms(h, W[p + "norm2.w"], s.eps)
    g = F.silu(linear(x, W[p + "mlp.w_gate"], quant)) * linear(x, W[p + "mlp.w_up"], quant)
    return h + linear(g, W[p + "mlp.w_down"], quant)


def final_logits(s: Spec, W: Weights, h: torch.Tensor, quant: Optional[str] = None
                 ) -> torch.Tensor:
    head = W["embed.table"].T if s.tied else W["lm_head.w"]
    return linear(rms(h, W["final_norm.w"], s.eps), head, quant)


# -- counts ------------------------------------------------------------------

def layer_params(s: Spec) -> int:
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.d_model
    norms = 2 * s.d_model + (2 * s.head_dim if s.qk_norm else 0)
    return attn + 3 * s.d_model * s.d_ff + norms


def param_count(s: Spec) -> int:
    """Every parameter: the layers, the embedding, the final norm and an
    untied head."""
    head = 0 if s.tied else s.d_model * s.vocab
    return s.layers * layer_params(s) + s.vocab * s.d_model + s.d_model + head


def matmul_params(s: Spec) -> int:
    """Parameters that enter a matrix product for every token: the layers'
    projections and the output head (the tied table, or the untied head;
    an untied embedding is a lookup)."""
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.d_model
    return s.layers * (attn + 3 * s.d_model * s.d_ff) + s.vocab * s.d_model


def weight_bytes_read(s: Spec, rows: int) -> int:
    """Weight bytes one forward step over ``rows`` tokens must read: every
    parameter once, an untied embedding only its ``rows`` rows."""
    n = param_count(s)
    if not s.tied:
        n -= s.vocab * s.d_model - rows * s.d_model
    return n * s.dtype_bytes


def train_flops(s: Spec, batch: int, seq: int) -> float:
    """The port's ``model_flops`` for a training step of ``batch`` x ``seq``
    tokens: 6·N·D plus causal QK^T and PV, forward and backward."""
    n = param_count(s)
    return 6.0 * n * batch * seq + 12.0 * s.layers * batch * s.heads * s.head_dim * seq ** 2 / 2


def decode_step_counts(s: Spec, active: int, active_positions: int, rows: int,
                       all_positions: int) -> Dict[str, float]:
    """One decode step of ``rows`` slots, ``active`` of them serving a
    request: operations of the active rows (projections, head, attention
    over their ``active_positions``), bytes of the weights, the cache
    positions every slot attends (``all_positions``) and the new K/V."""
    flops = (2.0 * matmul_params(s) * active
             + 4.0 * s.layers * s.heads * s.head_dim * active_positions)
    kv_write = 2.0 * rows * s.layers * s.kv_heads * s.head_dim * s.dtype_bytes
    nbytes = (weight_bytes_read(s, rows) + kv_write
              + s.layers * decode_attention_bytes(s, all_positions, rows))
    return {"flops": flops, "bytes": nbytes}


def prefill_counts(s: Spec, seq: int) -> Dict[str, float]:
    """One prompt of ``seq`` tokens: its projections, the causal attention
    of every layer, the head at the last position; the weights read once
    and the K/V written once."""
    flops = (2.0 * (matmul_params(s) - s.vocab * s.d_model) * seq + 2.0 * s.vocab * s.d_model
             + s.layers * attention_flops(s, seq))
    kv_write = 2.0 * seq * s.layers * s.kv_heads * s.head_dim * s.dtype_bytes
    return {"flops": flops, "bytes": weight_bytes_read(s, seq) + kv_write}


def attention_layers(s: Spec) -> int:
    """Every layer runs attention."""
    return s.layers


# -- faults and the CPU tests' size ------------------------------------------

@contextmanager
def planted(fault: str) -> Iterator[None]:
    """The dense family's part of a serving fault: ``state_unchanged``
    writes no new K/V into the cache; ``half_batch`` computes a decode step
    for the first half of the slots alone (the rest get token 0)."""
    from repro_torch.models import layers, transformer
    if fault == "state_unchanged":
        with patched(layers, "_write_cache", lambda cache, new, index: None):
            yield
    elif fault == "half_batch":
        real = transformer.decode_step

        def decode_step(cfg, params, cache, tokens, **kw):
            h = tokens.shape[0] // 2
            part = {"k": cache["k"][:, :h], "v": cache["v"][:, :h], "index": cache["index"][:h]}
            logits, _ = real(cfg, params, part, tokens[:h], **kw)
            full = torch.zeros((tokens.shape[0],) + logits.shape[1:], dtype=logits.dtype,
                               device=logits.device)
            full[:h] = logits
            return full, {"k": cache["k"], "v": cache["v"], "index": cache["index"] + 1}
        with patched(transformer, "decode_step", decode_step):
            yield
    else:
        yield


def small(cfg: Dict) -> Dict:
    """The configuration at the CPU tests' size: every width cut, two
    layers, the rest as the file has it."""
    return dict(cfg, hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                intermediate_size=128, vocab_size=256, num_hidden_layers=2, eos_token_id=255)
