"""OTLP/JSON export of flight-recorder spans (port of
`otlp_from_recorder` in ray_tpu/utils/tracing.py), which
`ray_tpu_torch.tracing.otlp_document` and `export_otlp_file` go through.

Analog of ray: python/ray/util/tracing/tracing_helper.py:1, which ships
OpenTelemetry spans through an exporter: here a pure transform of
recorder spans into the OTLP/HTTP JSON `resourceSpans` document, usable
by any collector's file receiver.  No opentelemetry-sdk dependency; the
JSON shape is the contract.

The document is the reference's with the port's names: the service,
scope and SDK names and the attribute keys say "ray_tpu_torch" where the
reference's say "ray_tpu".  Not ported: the reference's export of the
task-event timeline (`spans_from_events`, its `otlp_document` and
`export_otlp_file`), which no path of the port calls, and
`export_otlp_http` (a POST to a collector).
"""
from __future__ import annotations

from typing import Any

_OK, _ERROR = 1, 2          # OTLP span status codes


def _hex_id(s: str, width: int) -> str:
    """OTLP ids are fixed-width lowercase hex (32 trace / 16 span)."""
    s = (s or "").lower()
    s = "".join(c for c in s if c in "0123456789abcdef")
    return (s + "0" * width)[:width]


def otlp_from_recorder(spans_list: list[dict],
                       service_name: str = "ray_tpu_torch") -> dict:
    """OTLP/JSON export document built from flight-recorder spans
    (`ray_tpu_torch.tracing.harvest()` records) instead of task events — the
    same `resourceSpans` envelope, so both sources replay against one
    collector.  Recorder ids are already hex; `_hex_id` normalizes
    width (task ids are longer than recorder ids)."""
    otlp_spans = []
    for r in spans_list:
        attrs = [{"key": f"ray_tpu_torch.{k}", "value": _attr_value(v)}
                 for k, v in (r.get("attrs") or {}).items()]
        attrs.append({"key": "ray_tpu_torch.proc",
                      "value": {"stringValue":
                                str(r.get("proc", r.get("pid", "")))}})
        failed = bool((r.get("attrs") or {}).get("error"))
        otlp_spans.append({
            "traceId": _hex_id(r["tid"], 32),
            "spanId": _hex_id(r["sid"], 16),
            "parentSpanId": _hex_id(r["par"], 16) if r.get("par")
            else "",
            "name": r["name"],
            "kind": 1,
            "startTimeUnixNano": str(int(r["t0"] * 1e9)),
            "endTimeUnixNano": str(int(r["t1"] * 1e9)),
            "status": {"code": _ERROR if failed else _OK},
            "attributes": attrs,
        })
    return {
        "resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": service_name}},
                {"key": "telemetry.sdk.name",
                 "value": {"stringValue": "ray_tpu_torch.tracing"}},
            ]},
            "scopeSpans": [{
                "scope": {"name": "ray_tpu_torch.flight_recorder",
                          "version": "1"},
                "spans": otlp_spans,
            }],
        }],
    }


def _attr_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}
