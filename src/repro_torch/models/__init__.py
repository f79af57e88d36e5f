"""The dense-LM serving path: layers, attention, transformer, weights."""
