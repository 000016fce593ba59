"""Logging, configuration and thread-safe counters."""
