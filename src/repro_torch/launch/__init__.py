"""Launchers of the LM substrate: the forward and serve steps and the
serve loop."""
