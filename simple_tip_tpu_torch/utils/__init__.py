"""Utilities of the port: the flax msgpack checkpoint codec."""
