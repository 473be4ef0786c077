"""LIDC inference serving in the port: the continuous-batching engine
(``serve.engine``, the port's ``ServeEngine`` on the card) and the named
serving plane (``serve.plane``: sessions as compute Interests, streamed
chunks and KV as named Data, failover from a named checkpoint), the
port's copy of ``repro/serve/plane.py``, which runs on the virtual clock
and computes nothing on the card."""

from .engine import (SUPPORTED_FAMILIES, Request, ServeEngine,
                     UnsupportedFamilyError)
from .plane import ServeModelSpec, ServingPlane, SessionClient, token_at

__all__ = ["Request", "ServeEngine", "UnsupportedFamilyError",
           "SUPPORTED_FAMILIES", "ServeModelSpec", "ServingPlane",
           "SessionClient", "token_at"]
