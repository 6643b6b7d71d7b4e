"""Training data: the `.pt` video / latent tensor dataset."""
