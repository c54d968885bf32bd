"""The harness: cells, windows, traces, results."""
