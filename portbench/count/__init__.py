"""FLOP and byte counts of each configuration family, worked out from a
configuration file's sizes by the benchmark's own arithmetic."""
