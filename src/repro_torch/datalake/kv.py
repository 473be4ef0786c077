"""KV-cache and prefix state as *named Data* in the lake.

The serving plane's LIDC-native twist: the transformer KV cache computed
for a token prefix is published under a name derived from the prefix's
content digest — so a prefix computed on *any* cluster is a Content-Store
cache hit for *every* cluster (location-independent prefix caching), and
a session's decode state survives the cluster it was running on.

Naming scheme (all under ``/lidc/data`` so the existing lake producer,
segment pipeline and Content Stores serve them unchanged):

* ``/lidc/data/kv/<model>/<digest>`` — the KV cache of one *block* of
  ``block_tokens`` prompt tokens.  ``digest`` is a rolling hash chained
  over every token from the start of the prompt (vLLM-style block
  hashing), so a block's name commits to its whole left context and two
  prompts sharing a prefix share exactly the leading block names.
* ``/lidc/data/serve/prompt/<digest>`` — prompt token payloads.  A
  session Interest carries only the digest (``p=<digest>``): the prompt
  travels as named Data, fetched by whichever cluster the session lands
  on (and cached en route for retransmissions/failover).
* ``/lidc/data/serve/sess/<sid>/chunk=<i>`` — streamed token chunks.
* ``/lidc/data/serve/sess/<sid>/ckpt`` — the session's resume record
  (tokens emitted so far + the name of its decode-state KV), republished
  at every chunk boundary so a mid-stream cluster kill loses at most the
  in-flight chunk.
* ``/lidc/data/serve/sess/<sid>/kv`` — the session's full decode-state
  KV checkpoint, fetched through the segment pipeline on resume.

KV payloads are small JSON stubs that *declare* their byte size
(``kv_bytes``); transfer and prefill durations are computed analytically
from the declared size on the virtual clock, so benchmarks model
multi-GB KV movement without allocating it.

The port's copy of ``repro/datalake/kv.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.names import DATA_PREFIX, Name

__all__ = [
    "KV_PREFIX", "SERVE_DATA_PREFIX", "DEFAULT_BLOCK_TOKENS",
    "prompt_digest", "prompt_name", "publish_prompt",
    "block_digests", "kv_block_name",
    "publish_prefix_blocks", "longest_cached_prefix",
    "session_name", "chunk_name", "session_ckpt_name", "session_kv_name",
    "publish_session_kv",
]

KV_PREFIX = DATA_PREFIX + "/kv"
SERVE_DATA_PREFIX = DATA_PREFIX + "/serve"

# tokens per hashed KV block (vLLM uses 16; we default larger because the
# virtual-clock benchmarks run short prompts)
DEFAULT_BLOCK_TOKENS = 32


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


# --------------------------------------------------------------- prompts
def prompt_digest(tokens: Sequence[int]) -> str:
    """Content digest of a prompt — the ``p=`` field of a session name."""
    return _digest(json.dumps(list(map(int, tokens))).encode())


def prompt_name(digest: str) -> Name:
    return Name.parse(SERVE_DATA_PREFIX).append("prompt", digest)


def publish_prompt(lake, tokens: Sequence[int]) -> str:
    """Publish prompt tokens as named Data; returns the digest (the name
    is :func:`prompt_name` of it).  Identical prompts dedupe onto one
    object — the put is skipped when the name already exists."""
    toks = list(map(int, tokens))
    digest = prompt_digest(toks)
    name = prompt_name(digest)
    if not lake.has(name):
        lake.put_json(name, {"tokens": toks})
    return digest


# -------------------------------------------------------------- kv blocks
def block_digests(model: str, tokens: Sequence[int],
                  block_tokens: int = DEFAULT_BLOCK_TOKENS) -> List[str]:
    """Chained content digests of each full ``block_tokens`` block.

    Digest i commits to the model and to tokens[0 : (i+1)*block_tokens]
    via the chain, so equal digests mean equal full left context — the
    property that makes cross-cluster prefix reuse sound.  The trailing
    partial block (if any) gets no digest: its KV is never shared.
    """
    toks = list(map(int, tokens))
    out: List[str] = []
    prev = f"model:{model}"
    for i in range(len(toks) // max(1, block_tokens)):
        block = toks[i * block_tokens:(i + 1) * block_tokens]
        prev = _digest(f"{prev}|{block}".encode())
        out.append(prev)
    return out


def kv_block_name(model: str, digest: str) -> Name:
    return Name.parse(KV_PREFIX).append(model, digest)


def publish_prefix_blocks(lake, model: str, tokens: Sequence[int], *,
                          block_tokens: int = DEFAULT_BLOCK_TOKENS,
                          kv_bytes_per_token: float = 0.0) -> int:
    """Publish the named KV stub of every full prompt block not already
    in the lake.  Returns how many new blocks were published."""
    new = 0
    digests = block_digests(model, tokens, block_tokens)
    for i, digest in enumerate(digests):
        name = kv_block_name(model, digest)
        if lake.has(name):
            continue
        lake.put_json(name, {
            "model": model,
            "tokens": (i + 1) * block_tokens,
            "kv_bytes": round((i + 1) * block_tokens * kv_bytes_per_token),
        })
        new += 1
    return new


def longest_cached_prefix(lake, model: str, tokens: Sequence[int], *,
                          block_tokens: int = DEFAULT_BLOCK_TOKENS
                          ) -> Tuple[int, int]:
    """Longest leading prompt span whose KV is already named in the lake.

    Returns ``(cached_tokens, cached_blocks)``.  Walks the block chain
    longest-first so one miss ends the walk (a later block's digest
    commits to every earlier token, so it cannot hit if an earlier block
    missed... but a partially-evicted lake could: longest-first finds the
    longest *contiguous-from-zero* cached span regardless).
    """
    digests = block_digests(model, tokens, block_tokens)
    for n in range(len(digests), 0, -1):
        if lake.has(kv_block_name(model, digests[n - 1])):
            return n * block_tokens, n
    return 0, 0


# --------------------------------------------------------------- sessions
def session_name(sid: str) -> Name:
    return Name.parse(SERVE_DATA_PREFIX).append("sess", str(sid))


def chunk_name(sid: str, idx: int) -> Name:
    """The i-th streamed token chunk of a session."""
    return session_name(sid).append(f"chunk={int(idx)}")


def session_ckpt_name(sid: str) -> Name:
    return session_name(sid).append("ckpt")


def session_kv_name(sid: str) -> Name:
    return session_name(sid).append("kv")


def publish_session_kv(lake, sid: str, *, model: str, tokens_done: int,
                       kv_bytes: float,
                       meta: Optional[Dict[str, Any]] = None) -> Name:
    """Publish a session's decode-state KV checkpoint stub (declared
    size, analytic transfer) under its well-known name."""
    name = session_kv_name(sid)
    lake.put_json(name, {"model": model, "tokens": int(tokens_done),
                         "kv_bytes": round(kv_bytes), **(meta or {})})
    return name
