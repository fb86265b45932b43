"""OpenTelemetry export of the framework's metric registry.

Reference analog: ``src/ray/observability/open_telemetry_metric_recorder.cc``
— the reference records its C++ stats through an OTel recorder that exports
to the per-node metrics agent. Here the (Python) registry in
``ray_tpu_torch.util.metrics`` gains an OTel bridge: observable instruments whose
callbacks read live registry snapshots, exported periodically by any
configured ``MetricExporter`` (OTLP, console, or in-memory for tests).

Import-guarded: ``opentelemetry`` is optional; everything raises a clear
ImportError naming the dependency when it is absent. Prometheus export
(``render_prometheus`` → dashboard ``/metrics``) is independent and remains
the default pipeline.
"""
from __future__ import annotations

from typing import Optional


def _require_otel():
    try:
        from opentelemetry.sdk.metrics import MeterProvider  # noqa: F401

        return True
    except ImportError as e:
        raise ImportError(
            "OTel metric export needs the 'opentelemetry-sdk' package "
            "(pip install opentelemetry-sdk); the Prometheus pipeline "
            "(dashboard /metrics) works without it."
        ) from e


class OtelMetricsBridge:
    """Bridges the process-local metric registry into an OTel
    MeterProvider via observable instruments.

    Counters → ObservableCounter (cumulative monotonic sums);
    Gauges → ObservableGauge; Histograms → per-series ``_sum``/``_count``
    observable counters plus cumulative ``_bucket`` counters (OTel has no
    observable histogram instrument — same flattening Prometheus uses).
    """

    def __init__(self, exporter=None, interval_ms: int = 5_000,
                 meter_name: str = "ray_tpu_torch"):
        _require_otel()
        from opentelemetry.sdk.metrics import MeterProvider
        from opentelemetry.sdk.metrics.export import (
            ConsoleMetricExporter,
            PeriodicExportingMetricReader,
        )

        self._exporter = exporter or ConsoleMetricExporter()
        self._reader = PeriodicExportingMetricReader(
            self._exporter, export_interval_millis=interval_ms
        )
        self._provider = MeterProvider(metric_readers=[self._reader])
        self._meter = self._provider.get_meter(meter_name)
        self._registered: set = set()
        self.refresh_instruments()

    # -- instrument management -------------------------------------------

    def refresh_instruments(self):
        """Register an observable instrument per known metric; callbacks
        read the registry live at each export tick. Call again after new
        metrics appear (cheap; already-seen names are skipped)."""
        from opentelemetry.metrics import CallbackOptions, Observation  # noqa: F401

        from ray_tpu_torch.util.metrics import registry

        for snap in registry().snapshot():
            name, mtype = snap["name"], snap["type"]
            if name in self._registered:
                continue
            self._registered.add(name)
            if mtype == "counter":
                self._meter.create_observable_counter(
                    name, callbacks=[self._value_callback(name)],
                    description=snap.get("help", ""),
                )
            elif mtype == "gauge":
                self._meter.create_observable_gauge(
                    name, callbacks=[self._value_callback(name)],
                    description=snap.get("help", ""),
                )
            elif mtype == "histogram":
                self._meter.create_observable_counter(
                    f"{name}_sum",
                    callbacks=[self._hist_callback(name, "sum")],
                )
                self._meter.create_observable_counter(
                    f"{name}_count",
                    callbacks=[self._hist_callback(name, "count")],
                )
                self._meter.create_observable_counter(
                    f"{name}_bucket",
                    callbacks=[self._hist_callback(name, "bucket")],
                )

    def _find(self, name: str) -> Optional[dict]:
        from ray_tpu_torch.util.metrics import registry

        for snap in registry().snapshot():
            if snap["name"] == name:
                return snap
        return None

    def _value_callback(self, name: str):
        from opentelemetry.metrics import Observation

        def cb(options):
            snap = self._find(name)
            if snap is None:
                return []
            return [
                Observation(s["value"], attributes=s.get("tags", {}))
                for s in snap["samples"]
            ]

        return cb

    def _hist_callback(self, name: str, kind: str):
        from opentelemetry.metrics import Observation

        def cb(options):
            snap = self._find(name)
            if snap is None:
                return []
            out = []
            for s in snap["samples"]:
                tags = s.get("tags", {})
                if kind == "bucket":
                    cum = 0
                    for b, n in zip(snap["boundaries"], s["buckets"]):
                        cum += n
                        out.append(Observation(
                            cum, attributes={**tags, "le": str(b)}
                        ))
                    cum += s["buckets"][-1]
                    out.append(Observation(
                        cum, attributes={**tags, "le": "+Inf"}
                    ))
                else:
                    out.append(Observation(s[kind], attributes=tags))
            return out

        return cb

    # -- lifecycle --------------------------------------------------------

    def force_flush(self):
        self._reader.collect()

    def shutdown(self):
        self._provider.shutdown()


_bridge: Optional[OtelMetricsBridge] = None


def start_otel_export(exporter=None, interval_ms: int = 5_000):
    """Start (or return) the process-wide OTel bridge. ``exporter``
    defaults to the console exporter; pass an OTLP exporter for real
    collection."""
    global _bridge
    if _bridge is None:
        _bridge = OtelMetricsBridge(exporter, interval_ms)
    return _bridge


def stop_otel_export():
    global _bridge
    if _bridge is not None:
        _bridge.shutdown()
        _bridge = None
