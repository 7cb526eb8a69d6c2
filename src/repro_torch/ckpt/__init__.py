"""Step-atomic checkpoints, in the reference's on-disk layout."""
