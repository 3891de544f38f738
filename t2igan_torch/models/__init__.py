"""Models of the port: CLIP (text and vision towers, region head), the
DM-GAN generators (``GNet``, ``GDCGan``), the spectral-norm
discriminators, the legacy RNN/CNN encoders, their builders, and the
bridge that loads the JAX package's weights into them."""
