"""Application-specific validations (paper §IV.B), pluggable per app.

"These validations are built into the system in a modular manner and can
be managed separately for each application." — we implement exactly that:
a registry of validators keyed by app name; each validator sees the parsed
job fields plus the cluster's capability view and either passes or raises
:class:`ValidationError` with a reason that travels back in the NACK.

The port's copy of ``repro/core/validation.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

__all__ = ["ValidationError", "ValidatorRegistry", "default_registry"]


class ValidationError(Exception):
    pass


Validator = Callable[[Mapping[str, Any], Mapping[str, Any]], None]


class ValidatorRegistry:
    def __init__(self) -> None:
        self._validators: Dict[str, Validator] = {}

    def register(self, app: str, validator: Validator) -> None:
        self._validators[app] = validator

    def validate(self, app: str, fields: Mapping[str, Any],
                 capabilities: Mapping[str, Any]) -> None:
        v = self._validators.get(app)
        if v is None:
            raise ValidationError(f"unknown application {app!r}")
        v(fields, capabilities)

    def apps(self):
        return sorted(self._validators)


# ---------------------------------------------------------------------------
# Built-in validators
# ---------------------------------------------------------------------------

_SRR_RE = re.compile(r"^[SED]RR\d{6,9}$")


def validate_blast(fields: Mapping[str, Any], caps: Mapping[str, Any]) -> None:
    """The paper's own example: Magic-BLAST requires a well-formed SRR_ID."""
    srr = fields.get("srr")
    if not srr or not _SRR_RE.match(str(srr)):
        raise ValidationError(f"BLAST requires a valid SRR_ID, got {srr!r}")
    db = fields.get("db", "human")
    known = caps.get("blast_dbs", ("human",))
    if db not in known:
        raise ValidationError(f"unknown reference database {db!r}")


def _validate_model_job(fields: Mapping[str, Any], caps: Mapping[str, Any],
                        *, kind: str) -> None:
    arch = fields.get("arch")
    if not arch:
        raise ValidationError(f"{kind} job requires arch=")
    if arch not in caps.get("archs", ()):
        raise ValidationError(f"cluster does not serve arch {arch!r}")
    shape = fields.get("shape")
    if shape is not None and shape not in caps.get("shapes", ()):
        raise ValidationError(f"cluster does not serve shape {shape!r}")
    chips = int(fields.get("chips", 1))
    if chips < 1:
        raise ValidationError("chips must be >= 1")
    if chips > int(caps.get("chips", 0)):
        raise ValidationError(
            f"requested {chips} chips > cluster capacity {caps.get('chips')}")
    if kind == "train":
        steps = int(fields.get("steps", 1))
        if not (1 <= steps <= 10_000_000):
            raise ValidationError(f"steps out of range: {steps}")
    # HBM admission: the matchmaker's memory model decides precisely; here we
    # only reject the obviously impossible (mirrors the paper's mem= check).
    hbm = fields.get("hbm_gb")
    if hbm is not None and float(hbm) > float(caps.get("hbm_gb_total", 1e9)):
        raise ValidationError(f"requested {hbm}GB HBM exceeds cluster total")


def validate_train(fields, caps) -> None:
    _validate_model_job(fields, caps, kind="train")


def validate_serve(fields, caps) -> None:
    _validate_model_job(fields, caps, kind="serve")
    # serving endpoints advertise the model families their engines decode;
    # an unsupported family is rejected here with a NACK reason instead of
    # dying inside the engine (UnsupportedFamilyError) after placement
    family = fields.get("family")
    known = caps.get("serve_families", ())
    if family is not None and known and family not in known:
        raise ValidationError(
            f"cluster serves families {tuple(known)}, not {family!r}")
    max_new = fields.get("max_new")
    if max_new is not None and int(max_new) < 0:
        raise ValidationError(f"max_new must be >= 0, got {max_new}")


def validate_compress(fields, caps) -> None:
    """A second non-ML app (paper: 'a file compression tool ... its own
    checks'), to show validators are modular per-application."""
    target = fields.get("dataset")
    if not target or not str(target).startswith("/lidc/data/"):
        raise ValidationError("compress requires dataset=/lidc/data/...")
    level = int(fields.get("level", 6))
    if not (1 <= level <= 9):
        raise ValidationError(f"compression level out of range: {level}")


def default_registry() -> ValidatorRegistry:
    reg = ValidatorRegistry()
    reg.register("blast", validate_blast)
    reg.register("train", validate_train)
    reg.register("serve", validate_serve)
    reg.register("compress", validate_compress)
    return reg
