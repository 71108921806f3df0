"""One reader a metric: ``metrics/<name>.py`` defines ``read(run)``, which
returns the metric's value from the run's calls, spans, counters or trace,
or None where it finds nothing to read (the harness then leaves the metric
out of the result)."""
