"""Serving and (later) training steps over the model bundles."""
