"""Engines: plane staging and the sparse counting engine."""
