"""Completion-time intelligence — the paper's §VII future work, implemented.

From the paper: "we aim to enable the network to identify the most suitable
cluster for executing requests and optimize the system by leveraging machine
learning algorithms to predict completion times."

Their Table I is the training data shape: (job signature, resource config)
-> run time.  We implement a small, dependency-free online predictor:

* per (job-key, cluster/face) exponentially-weighted run-time estimate, and
* a cross-cluster *ridge regression* on log-runtime over simple job
  features (log tokens, log chips, moe flag, ...), used to cold-start
  predictions for never-seen (job, cluster) pairs.

Both are updated online whenever a Data packet carrying a completed job's
measured duration flows back through the strategy layer.

The port's copy of ``repro/core/scheduler.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = ["CompletionModel"]


def _job_key(fields: Mapping[str, Any]) -> Tuple:
    """What makes two jobs 'the same work' for prediction purposes.

    Workflow stages (repro.workflow) carry ``in=`` (input data-lake names)
    and ``part=``; without them every scatter instance of a stage would
    collapse onto one key and the model would average unrelated inputs.
    """
    from .jobs import INPUTS_FIELD
    return (fields.get("app"), fields.get("arch"), fields.get("shape"),
            str(fields.get("steps", "")), str(fields.get("chips", "")),
            str(fields.get("part", "")), str(fields.get(INPUTS_FIELD, "")))


def _features(fields: Mapping[str, Any]) -> np.ndarray:
    """Cheap numeric features for the cross-job regressor."""
    chips = float(fields.get("chips", 1) or 1)
    steps = float(fields.get("steps", 1) or 1)
    f = [
        1.0,
        math.log(max(chips, 1.0)),
        math.log(max(steps, 1.0)),
        1.0 if fields.get("app") == "train" else 0.0,
        1.0 if fields.get("app") == "serve" else 0.0,
        float(len(str(fields.get("arch", "")))) / 16.0,  # crude arch proxy
    ]
    return np.asarray(f, dtype=np.float64)


@dataclass
class _Ewma:
    value: float = 0.0
    n: int = 0

    def update(self, x: float, alpha: float = 0.35) -> None:
        self.value = x if self.n == 0 else (1 - alpha) * self.value + alpha * x
        self.n += 1


class CompletionModel:
    """Online completion-time predictor over (job, cluster) pairs.

    Besides run-time observations, the model ingests *transport telemetry*
    from the forwarding strategies (Data vs Nack outcomes per upstream
    face) and exposes it as a multiplicative penalty — a cluster behind a
    lossy or congested path is predicted slower even if its compute times
    are good, which is exactly the signal the paper's "intelligence in
    the network" needs to route around degradation.
    """

    def __init__(self, ridge: float = 1e-2, transport_loss_weight: float = 8.0):
        self._exact: Dict[Tuple, Dict[int, _Ewma]] = defaultdict(dict)
        self._ridge = ridge
        self._dim = len(_features({}))
        # running ridge-regression sufficient statistics, per face
        self._xtx: Dict[int, np.ndarray] = {}
        self._xty: Dict[int, np.ndarray] = {}
        # recent-history ring for debugging/telemetry; the compute plane
        # feeds one observation per completed job, so this must be
        # bounded — the learned state lives in the EWMAs and the ridge
        # sufficient statistics above, not here
        self.observations: deque = deque(maxlen=4096)
        # per-face transport health: EWMA rtt + EWMA loss from strategy feedback
        self._transport_rtt: Dict[int, _Ewma] = {}
        self._transport_loss: Dict[int, float] = {}
        self.transport_loss_weight = transport_loss_weight

    # -- learning ------------------------------------------------------------
    def observe(self, fields: Mapping[str, Any], face_id: int,
                duration: float) -> None:
        key = _job_key(fields)
        self._exact[key].setdefault(face_id, _Ewma()).update(duration)
        x = _features(fields)
        y = math.log(max(duration, 1e-9))
        if face_id not in self._xtx:
            self._xtx[face_id] = self._ridge * np.eye(self._dim)
            self._xty[face_id] = np.zeros(self._dim)
        self._xtx[face_id] += np.outer(x, x)
        self._xty[face_id] += x * y
        self.observations.append((key, face_id, duration))

    def observe_transport(self, face_id: int, ok: bool, rtt: float,
                          alpha: float = 0.3) -> None:
        """Ingest a Data/Nack outcome from the forwarding strategy layer."""
        loss = self._transport_loss.get(face_id, 0.0)
        if ok:
            self._transport_rtt.setdefault(face_id, _Ewma()).update(rtt)
            self._transport_loss[face_id] = (1 - alpha) * loss
        else:
            self._transport_loss[face_id] = (1 - alpha) * loss + alpha

    def transport_penalty(self, face_id: int) -> float:
        """Multiplier (>= 1) applied to completion predictions for a face."""
        return 1.0 + self.transport_loss_weight * self._transport_loss.get(face_id, 0.0)

    def transport_rtt(self, face_id: int) -> Optional[float]:
        ewma = self._transport_rtt.get(face_id)
        return ewma.value if ewma is not None and ewma.n > 0 else None

    # -- inference -----------------------------------------------------------
    def predict(self, fields: Mapping[str, Any], face_id: int
                ) -> Optional[float]:
        key = _job_key(fields)
        exact = self._exact.get(key, {}).get(face_id)
        if exact is not None and exact.n > 0:
            return exact.value
        # cold start: regression fit for this cluster, if it has history
        xtx = self._xtx.get(face_id)
        if xtx is None:
            return None
        try:
            w = np.linalg.solve(xtx, self._xty[face_id])
        except np.linalg.LinAlgError:
            return None
        return float(math.exp(float(_features(fields) @ w)))

    def best_face(self, fields: Mapping[str, Any], faces: List[int]
                  ) -> Optional[int]:
        scored = [(self.predict(fields, f), f) for f in faces]
        known = [(p, f) for p, f in scored if p is not None]
        if not known:
            return None
        return min(known)[1]
