"""Geometry of the port: SE(3) helpers, camera ops, host pose containers."""
