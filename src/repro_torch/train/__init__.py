"""Training substrate: optimizer, step factories, checkpoints, fault
tolerance (the port of ``repro.train``).

``pytree`` walks parameter trees in jax's leaf order with jax's key
paths, which the optimizer and the checkpoint format share with the
reference.
"""
