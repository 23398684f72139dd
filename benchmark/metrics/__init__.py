"""One reader per metric, found by the metric's name in BENCHMARK.json:
``read(run)`` takes the run's record (``harness.Run``) and returns the
metric's value, or None where the run holds nothing to read it from."""
