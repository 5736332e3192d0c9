"""Cross-cutting utilities: profiling and metric logging."""
