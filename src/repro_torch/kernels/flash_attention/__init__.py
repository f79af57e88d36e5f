"""Flash attention: GQA online-softmax attention of the LM path."""
