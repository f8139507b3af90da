"""Launchers: the LM substrate's train, forward and serve steps, the
training loop and the serve loop, and the SPMD engine's site meshes and
process launcher (``mesh``)."""
