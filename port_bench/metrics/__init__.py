"""Per-layer metric readers, one file a metric, named as the metric."""
