"""Input pipelines of the port (numpy; the same batches as the reference)."""
