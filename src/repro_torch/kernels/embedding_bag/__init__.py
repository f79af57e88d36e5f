"""EmbeddingBag (sum): the sparse lookup of the recsys path."""
