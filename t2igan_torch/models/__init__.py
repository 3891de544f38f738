"""Models of the port: the CLIP text tower, the DM-GAN generator (eval
mode) and the bridge that loads the JAX package's weights into them."""
