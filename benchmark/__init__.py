"""The port's benchmark: BENCHMARK.json's harness (run.py), its traffic,
configurations, reference, counts and metric readers."""
