"""Experiment engine of the port: the per-phase and fused ``test_prio`` routes."""
