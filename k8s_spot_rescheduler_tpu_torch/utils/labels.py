"""Node-class label matching.

The reference supports two label schemas — a bare ``key`` ("old schema")
present-check and a ``key=value`` ("new schema") equality check — for both
the spot and on-demand node classes (reference nodes/nodes.go:167-209
``isSpotNode``/``isOnDemandNode``), and validates at startup that a label
has at most one ``=`` (reference rescheduler.go:407-417 ``validateArgs``).
"""

from __future__ import annotations

from typing import Mapping


class LabelFormatError(ValueError):
    """Raised for a label with more than one '='."""


def validate_label(label: str, what: str = "node label") -> None:
    """Reject labels that are not ``key`` or ``key=value``.

    Mirrors reference rescheduler.go:407-417: splitting on "=" must yield
    at most two parts.
    """
    if len(label.split("=")) > 2:
        raise LabelFormatError(
            f"the {what} is not correctly formatted: expected '<label_name>' "
            f"or '<label_name>=<label_value>', but got {label}"
        )


def matches_label(node_labels: Mapping[str, str], selector: str) -> bool:
    """True if ``node_labels`` satisfies ``selector``.

    ``selector`` is either a bare key (matches if the key is present with
    any value, reference nodes/nodes.go:173-176) or ``key=value`` (matches
    on exact value, nodes/nodes.go:177-184). SplitN(=, 2) semantics: only
    the first '=' separates key from value.
    """
    key, sep, value = selector.partition("=")
    if not sep:
        return key in node_labels
    return node_labels.get(key) == value
