"""Models of the port: CLIP (text and vision towers, region head), the
DM-GAN generator, the spectral-norm discriminators, their builders, and
the bridge that loads the JAX package's weights into them."""
