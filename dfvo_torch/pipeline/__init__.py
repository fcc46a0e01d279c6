"""Pipeline stages of the port: the network frontend, the tracking step
and the per-frame step."""
