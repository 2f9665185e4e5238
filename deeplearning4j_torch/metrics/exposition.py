"""Prometheus text exposition (format 0.0.4) over one or more
registries (the port's own copy of
``deeplearning4j_tpu/metrics/exposition.py``: the same text for the same
families).

``render_text(sources)`` takes ``[(inject_labels, registry), ...]`` and
merges same-named families across sources into a single ``# HELP`` /
``# TYPE`` block, so one ``GET /metrics`` page can show several servers'
registries (injected labels such as ``{model="m0"}`` tell them apart).

Histograms render the bucket/sum/count triple only; reservoir
quantiles live in the JSON snapshot (mixing summary-style quantile
samples into a histogram family is invalid exposition).
"""

from __future__ import annotations

import math

__all__ = ["render_text", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v):
    """Prometheus sample value: integral floats as bare ints."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s):
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (str(s).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _labelstr(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _le(upper):
    return "+Inf" if math.isinf(upper) else _fmt(upper)


def render_text(sources):
    """``sources``: iterable of ``(inject_labels, registry)``. Injected
    labels are prepended to every sample of that registry; collisions
    resolve in favor of the sample's own label. A source's second
    element may also be a pre-collected families list (the
    ``_snapshot_families()`` shape, possibly round-tripped through
    JSON), such as a remote host's last reported families."""
    merged = {}   # name -> {"help":, "kind":, "samples": [(labels, data)]}
    order = []
    for inject, reg in sources:
        inject = dict(inject or {})
        fams = (reg._snapshot_families()
                if hasattr(reg, "_snapshot_families") else reg)
        for fam in fams:
            slot = merged.get(fam["name"])
            if slot is None:
                slot = {"help": fam["help"], "kind": fam["kind"],
                        "samples": []}
                merged[fam["name"]] = slot
                order.append(fam["name"])
            elif slot["kind"] != fam["kind"]:
                # kind clash across sources: keep the first, drop the rest
                continue
            if not slot["help"] and fam["help"]:
                slot["help"] = fam["help"]
            for lbls, data in fam["samples"]:
                full = dict(inject)
                full.update(lbls)
                slot["samples"].append((full, data))

    lines = []
    for name in order:
        fam = merged[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for labels, data in fam["samples"]:
            if fam["kind"] == "histogram":
                for upper, cum in data["buckets"]:
                    blabels = dict(labels)
                    blabels["le"] = _le(upper)
                    lines.append(
                        f"{name}_bucket{_labelstr(blabels)} {_fmt(cum)}")
                lines.append(
                    f"{name}_sum{_labelstr(labels)} {_fmt(data['sum'])}")
                lines.append(
                    f"{name}_count{_labelstr(labels)} {_fmt(data['count'])}")
            else:
                lines.append(f"{name}{_labelstr(labels)} {_fmt(data)}")
    return "\n".join(lines) + "\n" if lines else ""
