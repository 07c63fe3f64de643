"""Seeded stand-in datasets of the port (numpy only)."""
