"""Serving (torch port of ``repro.serve``): the static engine
(``engine.ServeEngine``), continuous batching over a paged KV cache
(``scheduler.ContinuousEngine``, ``kvcache``), the Poisson load generator
(``loadgen``), and serving telemetry aggregated through the ``Aggregator``
facade (``engine.TelemetryChannel``)."""
