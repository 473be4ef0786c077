"""Interest / Data packets with HMAC signatures and freshness.

The paper rides on NDN's packet model: a consumer expresses an *Interest*
for a name; the network returns at most one *Data* packet whose name
matches.  Data packets are signed (NDN gives data-centric authenticity —
paper §VII) and carry a freshness period that bounds Content-Store reuse.

We keep the wire format trivial (dict-of-primitives) because the transport
in this repo is an in-process deterministic plane; what matters for the
reproduction is the *semantics*: nonce-based loop suppression, lifetime
expiry, signature verification, freshness.

The port's copy of ``repro/core/packets.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
import hmac
import itertools
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

from .names import Name

__all__ = ["Interest", "Data", "sign_data", "verify_data",
           "trusted_key_for", "verify_trusted"]

_nonce_counter = itertools.count(1)


def _next_nonce() -> int:
    # Deterministic nonces keep tests reproducible; uniqueness is all NDN
    # needs (duplicate-nonce suppression in the PIT).
    return next(_nonce_counter)


@dataclass(frozen=True)
class Interest:
    """A request for named data / named computation."""

    name: Name
    nonce: int = field(default_factory=_next_nonce)
    lifetime: float = 4.0          # seconds (virtual clock)
    hop_limit: int = 32
    can_be_prefix: bool = False    # match CS entries by prefix
    must_be_fresh: bool = False    # only fresh CS entries may satisfy
    # Application parameters that are *not* part of the routed name
    # (e.g. job payloads too big to put in a component).
    app_params: Optional[Dict[str, Any]] = None
    # Skip this node's *own* producers and go straight to forwarding —
    # how a saturated gateway re-expresses a compute Interest upstream
    # (spill) without its own forwarder handing the work right back to
    # it.  First-hop-only by construction: forwarding clears the flag,
    # so remote producers still answer normally.
    skip_local: bool = False

    def decrement_hop(self) -> "Interest":
        # per-hop fast clone: dataclasses.replace() re-runs __init__ and
        # field validation (~20µs); a __dict__ copy of a frozen instance is
        # ~20x cheaper and this runs once per hop per Interest
        clone = object.__new__(Interest)
        clone.__dict__.update(self.__dict__)
        clone.__dict__["hop_limit"] = self.hop_limit - 1
        clone.__dict__["skip_local"] = False
        return clone

    def refresh(self) -> "Interest":
        """Retransmission: same name, new nonce (so PITs treat it as new)."""
        clone = object.__new__(Interest)
        clone.__dict__.update(self.__dict__)
        clone.__dict__["nonce"] = _next_nonce()
        return clone

    def __str__(self) -> str:
        return f"Interest({self.name}, nonce={self.nonce})"


@dataclass(frozen=True)
class Data:
    """A named, signed content object."""

    name: Name
    content: bytes
    freshness: float = 10.0        # seconds content may satisfy must_be_fresh
    signature: bytes = b""
    signer: str = ""
    created_at: float = 0.0        # stamped by the producing node's clock
    meta: Optional[Dict[str, Any]] = None

    # -- convenience codecs -------------------------------------------------
    @staticmethod
    def from_json(name: Name, obj: Any, **kw) -> "Data":
        return Data(name=name, content=json.dumps(obj, sort_keys=True).encode(), **kw)

    def json(self) -> Any:
        # content may be a zero-copy memoryview (segment pipeline)
        return json.loads(bytes(self.content).decode())

    def digest(self) -> str:
        return hashlib.sha256(self.content).hexdigest()[:16]

    def is_fresh(self, now: float) -> bool:
        return (now - self.created_at) <= self.freshness

    def __str__(self) -> str:
        return f"Data({self.name}, {len(self.content)}B)"


# ---------------------------------------------------------------------------
# Signatures. NDN signs data, not channels; HMAC-SHA256 with per-producer
# keys is the minimal faithful stand-in for the paper's "built-in data
# authentication and integrity".
# ---------------------------------------------------------------------------

def _mac(key: bytes, data: Data) -> bytes:
    h = hmac.new(key, digestmod=hashlib.sha256)
    h.update(str(data.name).encode())
    h.update(data.content)
    h.update(str(data.freshness).encode())
    return h.digest()


# signer name -> HMAC key, auto-populated by sign_data.  In-process trust
# anchor registry: the simulation signs and verifies inside one process,
# so "key distribution" is the act of signing — any node may then verify
# any signed Data it forwards (the Content-Store admission gate uses
# this to refuse poisoned cache entries).
_TRUSTED_KEYS: Dict[str, bytes] = {}


def sign_data(data: Data, key: bytes, signer: str) -> Data:
    unsigned = replace(data, signature=b"", signer=signer)
    if _TRUSTED_KEYS.get(signer) is not key:
        _TRUSTED_KEYS[signer] = key
    return replace(unsigned, signature=_mac(key, unsigned), signer=signer)


def verify_data(data: Data, key: bytes) -> bool:
    unsigned = replace(data, signature=b"")
    return hmac.compare_digest(_mac(key, unsigned), data.signature)


def trusted_key_for(signer: str) -> Optional[bytes]:
    """The registered key for ``signer``, or None if never seen."""
    return _TRUSTED_KEYS.get(signer)


def verify_trusted(data: Data) -> Optional[bool]:
    """Verify against the signer's registered key.

    Returns ``True``/``False`` for a verdict, or ``None`` when no verdict
    is possible (unsigned Data, or a signer this process never saw sign)
    — callers treat ``None`` as "cannot check", not as failure, so
    unsigned control payloads keep working.
    """
    if not data.signature or not data.signer:
        return None
    key = _TRUSTED_KEYS.get(data.signer)
    if key is None:
        return None
    return verify_data(data, key)
