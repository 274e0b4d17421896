"""Shared pieces of the harness: discovery, tracing, roofline, results."""
