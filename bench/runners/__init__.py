"""Runners: one module a kind of configuration, found by the name in its file."""
