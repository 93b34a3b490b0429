"""Per-layer metrics: `<metric>.py` holds the metric's `UNIT` and
`read(ctx)`, which returns its value from a traced run's
`harness.Context`, or None when the window holds nothing to read."""
