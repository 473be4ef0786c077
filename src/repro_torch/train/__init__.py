"""Serving and training steps over the model bundles, and the trainer."""
