"""Training (state, WGAN-GP step, loop) and sampling."""
