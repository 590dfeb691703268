"""The benchmark's harness: scenes, the timed window, the traced window,
the peaks and the checks. Cells, configurations, traffic mixes and
per-layer metrics are data and files of their own, found by name."""
