"""Error types + name validation: the subset of pilosa_tpu/errors.py that
the ported slices raise or the HTTP edge maps, plus ``NotPortedError``
for the parts of the JAX package that later slices of the port bring over
(the HTTP edge answers it with 501).

Reference: pilosa.go (public Err* values :40-117, nameRegexp :119,
validateName :155).
"""

from __future__ import annotations

import re


class PilosaError(Exception):
    """Base class; .message matches the reference's error strings so HTTP
    responses can be byte-compatible."""

    message = "pilosa error"

    def __init__(self, message: str | None = None):
        super().__init__(message or self.message)


class IndexNotFoundError(PilosaError):
    message = "index not found"


class IndexExistsError(PilosaError):
    message = "index already exists"


class FieldNotFoundError(PilosaError):
    message = "field not found"


class FieldExistsError(PilosaError):
    message = "field already exists"


class BSIGroupNotFoundError(PilosaError):
    message = "bsigroup not found"


class BSIGroupValueTooLowError(PilosaError):
    message = "value too low for bsigroup"


class BSIGroupValueTooHighError(PilosaError):
    message = "value too high for bsigroup"


class InvalidBSIGroupRangeError(PilosaError):
    message = "invalid bsigroup range"


class InvalidCacheTypeError(PilosaError):
    message = "invalid cache type"


class InvalidFieldTypeError(PilosaError):
    message = "invalid field type"


class InvalidTimeQuantumError(PilosaError):
    message = "invalid time quantum"


class NameError_(PilosaError):
    message = "invalid name"


class QueryError(PilosaError):
    message = "invalid query"


class TranslateStoreReadOnlyError(PilosaError):
    message = "translate store could not find or create key, translate store read only"


class ApiMethodNotAllowedError(PilosaError):
    """Reference newAPIMethodNotAllowedError (api.go:124): the cluster's
    state refuses this operation right now (HTTP 405). A standalone node is
    always in the NORMAL state and never raises it; the HTTP edge maps it
    all the same."""

    message = "api method not allowed"


class FragmentNotFoundError(PilosaError):
    message = "fragment not found"


#: The later slice of the port, by its heading in ROADMAP.md Queue 1.
SLICE_CLUSTER = "cluster and operations"


class NotPortedError(PilosaError):
    """A feature of the JAX package that this slice of the port does not
    carry yet. The message names the ROADMAP.md slice that brings it."""

    message = "not ported"

    def __init__(self, what: str, slice_name: str):
        super().__init__(f"{what} is not ported to pilosa_tpu_torch yet "
                         f"(ROADMAP.md Queue 1: {slice_name})")


# Reference: pilosa.go:119 — lowercase start, [a-z0-9_-], max 64 chars.
_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    """Reference validateName (pilosa.go:155)."""
    if not _NAME_RE.match(name):
        raise NameError_(f"invalid index or field name: {name!r}")
