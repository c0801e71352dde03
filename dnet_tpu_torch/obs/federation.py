"""Metrics federation: merge per-node Prometheus expositions into one.

Counterpart of dnet_tpu/obs/federation.py, the same merge.

Each process in a dnet cluster (the API node plus every shard) exposes its
own registry at `GET /metrics`; this module re-labels each node's samples
with `node="<id>"` and merges them into a single v0.0.4 exposition served
at `GET /v1/cluster/metrics` (api/http.py) — one scrape target for the
whole ring, so a dashboard can group `dnet_token_rpc_ms` by hop without
per-shard scrape configs.

The parser is deliberately minimal: it understands exactly what
`MetricsRegistry.expose()` emits (``# HELP`` / ``# TYPE`` comments and
``name{labels} value`` samples) and passes sample lines through verbatim
apart from the injected label, so federation cannot corrupt values it does
not understand — an unparseable line is dropped with a count rather than
re-emitted mangled.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import List, Sequence, Tuple

# sample line: metric name, optional {labels}, value (timestamps are not
# emitted by our registry and not preserved)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{.*\})?"
    r"\s+(?P<value>\S+)\s*$"
)
_HELP_RE = re.compile(r"^# HELP (?P<name>\S+) (?P<help>.*)$")
_TYPE_RE = re.compile(r"^# TYPE (?P<name>\S+) (?P<kind>\S+)$")

NODE_LABEL = "node"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def add_node_label(sample_line: str, node: str) -> str:
    """Inject ``node="<id>"`` as the first label of one sample line."""
    m = _SAMPLE_RE.match(sample_line)
    if m is None:
        raise ValueError(f"unparseable sample line: {sample_line!r}")
    labels = m.group("labels")
    inner = labels[1:-1] if labels else ""
    pair = f'{NODE_LABEL}="{_escape(node)}"'
    inner = f"{pair},{inner}" if inner else pair
    return f'{m.group("name")}{{{inner}}} {m.group("value")}'


def _family_of(sample_name: str) -> str:
    """Histogram samples (`_bucket`/`_sum`/`_count`) group under the base
    family name so HELP/TYPE emit once per family, not per sample kind."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def federate(sections: Sequence[Tuple[str, str]]) -> Tuple[str, List[str]]:
    """Merge `(node, exposition_text)` pairs into one exposition.

    Returns `(merged_text, skipped)` where `skipped` lists lines that did
    not parse (logged by the caller, never re-emitted).  Families keep
    first-seen order; HELP/TYPE come from the first node exposing them, and
    every sample gains the node label.
    """
    fams: "OrderedDict[str, dict]" = OrderedDict()
    skipped: List[str] = []
    for node, text in sections:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            hm = _HELP_RE.match(line)
            if hm is not None:
                fam = fams.setdefault(
                    hm.group("name"), {"help": None, "type": None, "samples": []}
                )
                if fam["help"] is None:
                    fam["help"] = hm.group("help")
                continue
            tm = _TYPE_RE.match(line)
            if tm is not None:
                fam = fams.setdefault(
                    tm.group("name"), {"help": None, "type": None, "samples": []}
                )
                if fam["type"] is None:
                    fam["type"] = tm.group("kind")
                continue
            if line.startswith("#"):
                continue  # other comments carry no samples
            sm = _SAMPLE_RE.match(line)
            if sm is None:
                skipped.append(f"{node}: {line}")
                continue
            fam = fams.setdefault(
                _family_of(sm.group("name")),
                {"help": None, "type": None, "samples": []},
            )
            fam["samples"].append(add_node_label(line, node))
    lines: List[str] = []
    for name, fam in fams.items():
        if fam["help"] is not None:
            lines.append(f"# HELP {name} {fam['help']}")
        if fam["type"] is not None:
            lines.append(f"# TYPE {name} {fam['type']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n", skipped
