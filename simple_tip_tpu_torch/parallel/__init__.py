"""Training across models on one card: the ensemble of independent runs."""
