"""Runtime of the port: the serving engine step, the chunked training
step, the pipeline (layer placement, per-stage action lists, the
executor, the stage body) and the profiler summary both launchers
print."""
