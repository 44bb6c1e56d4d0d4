"""Serving layer of the port: device models, system builders and the
real-compute executor factory."""
