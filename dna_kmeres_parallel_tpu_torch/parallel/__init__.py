"""Sharded programs: meshes (``mesh``), the bucket-sharded count
(``bucketed``) and its shards' host staging (``sharded_sparse``)."""
