"""Per-metric readers, one module each, found by the metric's name."""
