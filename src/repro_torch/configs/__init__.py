"""Architecture configurations: one module per arch, see ``base``."""
