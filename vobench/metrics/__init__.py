"""Per-layer metric readers: one module a metric, named as the metric in
BENCHMARK.json, each with `read(rec, cell) -> float | None` (None where the
run gave it nothing to read; the metric is then left out of the line)."""
