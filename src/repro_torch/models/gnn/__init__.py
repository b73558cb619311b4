"""Graph neural networks over padded ``GraphBatch``es (``common``)."""
