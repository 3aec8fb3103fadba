"""Generators of the deployments, one module a generator named in a configuration."""
