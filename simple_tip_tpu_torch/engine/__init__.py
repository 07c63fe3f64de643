"""Experiment engine of the port: the per-phase ``test_prio`` route."""
