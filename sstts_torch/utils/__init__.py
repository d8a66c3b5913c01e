"""Cross-cutting utilities: metrics logging and plots."""
