"""Launchers of the LM substrate: the train, forward and serve steps,
the training loop and the serve loop."""
