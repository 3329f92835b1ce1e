"""Host-side helpers: the base codec, the configuration, FASTA parsing,
packed-triangle indexing, result writers and the checkpoint file."""
