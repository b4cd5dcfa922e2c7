"""Metrics, phase timers and correctness oracles of the port."""
