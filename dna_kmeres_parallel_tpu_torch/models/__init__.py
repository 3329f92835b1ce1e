"""Engines: plane staging and the dense distance engine, the sparse
counting engine, and the resumable distance-CSV writer."""
