"""Sharding of the problem batch over devices and multi-host start-up."""
