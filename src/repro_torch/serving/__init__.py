"""Serving layer of the port: device models, system builders, traces, the
online API (``ServeSpec``/``InferenceService``) and the real-compute
executor factories."""
