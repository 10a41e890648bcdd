"""Single-device runtime of the port (the serving engine step)."""
