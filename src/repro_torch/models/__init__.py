"""Models: parameter specs, layers and the dense decoder-only LM."""
