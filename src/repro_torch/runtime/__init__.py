"""Single-device runtime of the port: the serving engine step, the
chunked training step and the profiler summary both launchers print."""
