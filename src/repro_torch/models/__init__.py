"""Model configuration, layers and parameters for the dense family."""
